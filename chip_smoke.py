#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (wekws_tpu_torch).

Drives the flagship MDTC max-pooling wake word (40-mel fbank, global
CMVN, linear preprocessing, MDTC 4 stacks x 4 blocks, kernel 5, 64
channels, linear head + sigmoid), the hey_snips DS-TCN wake word
(linear preprocessing to 64, 4 DS blocks, kernel 8), the hi_xiaowen
DS-TCN (the same at 256 channels, two keywords), the hi_xiaowen
FSMN-CTC model (80-mel fbank, context +-2, skip 3, 4 layers 250/128,
2599 tokens), the speechcommand_v1 MDTC classifier (MFCC 80, global
head, 12 classes) and the hi_xiaowen GRU and full-conv TCN, each at
full width with random weights from a seed, on one CUDA device, in
phases; any failure exits non-zero:

1. card name and power limit (nvidia-smi); a GPU is required;
2. build every CUDA kernel from ``wekws_tpu_torch/csrc`` and print
   what ``ptxas`` says of registers and spills (the kernels of F1, F2,
   F3, B1, B2, B3 and B4 by name, at C = 32, 64, 128, the FSMN kernel
   by its template arguments, the fbank kernels of both plans and the
   serving kernel's instantiations: MDTC's and DS-TCN's);
3. the MDTC serving kernel against its plain PyTorch version on the
   card at the flagship's depth: whole utterances and one streaming
   chunk (a random cache; output and new cache) at T = 1, 7, 8, 198,
   1024 and 2048, B = 1, 4, 16, 64, C = 32, 64, 128, each with the plan
   the wrapper chose and launched twice (bitwise equal); streaming at
   B=16 in chunks of 8 over 200 frames (chained, against the one-shot
   forward and the plain chain); bound 1e-4 abs + 1e-4 rel (fp32,
   another summation order);
4. the serving slice end to end: 16 synthetic 2 s utterances ->
   fbank -> checkpoint saved and loaded through ``load_serving_model``
   -> (a) offline ``build_fused_forward`` -> score file -> DET, held
   against the module forward; (b) ``BatchMaxPoolSpotter(use_fused=
   True)`` fed 300 ms chunks, stepped and flushed, held against (a).
   Kernel launch counts are zeroed before each path and read after;
5. serving kernel and plain times (CUDA events around one call,
   warm-up, median of 30 calls; the kernel's device time alone from
   torch.profiler) beside the bound computed from this run's shapes;
6. the eight fused training passes (F1-F4, B1-B4) against their plain
   versions on identical inputs, at flagship width (C=64, K=5): the
   main path's B=512 x T=198 at dilations 1, 2, 4 and 8 (six to eight
   tiles per block of the persistent grid), B=64 x T=198 (one tile
   per block), a ragged B=5 x T=130 at dilations 1 and 8, B=7 x T=20
   (shorter than the halo of 32 frames; the tiles of F1, F2, F3, B2 and
   B3 over the flattened frames span several utterances; also at C=32
   and C=128), and C=32 and C=128 at B=64;
   each pass launched twice must agree bitwise (deterministic
   reductions).
   The whole fused block (forward, six batch statistics,
   twelve parameter gradients and dx) against the unfused module block
   by autograd on the card, with no element near either ReLU's kink
   (where rounding picks the side): bn1's bias shifted per channel so
   that its outputs leave a gap around zero, the upstream gradient zero
   within 1e-4 of the residual ReLU's kink;
7. the training slice end to end at B=512 x 2 s: device fbank +
   CMVN from the batch + ``init_model(FLAGSHIP + fused_train)`` +
   ``Trainer``: step 0 held against the unfused Trainer (loss) and,
   with the unfused Trainer, against the unfused model in float64 (the
   gradients of each block and of each other tensor, against their own
   scale; the group and tensor of the worst share named for each
   route), 5 steps without augmentation (loss finite and
   decreasing), 2 steps with the flagship dither + spec_aug; every
   pass launched 17 x steps times; step 0's fused gradients again with
   each pass in turn (then all eight) run by its plain version, the
   worst share of each (a bisection of the route's numerics by pass);
   cv step, two checkpoints saved,
   averaged and loaded, and the trained model served through
   ``build_fused_forward``, held against the module forward;
8. training times: each pass per call (CUDA events, median of 30) at
   B=512 x T=198, its device time per call in a profiled train step
   (its kernel and its own block reduction; failing where a pass's
   kernel is missing from the profile), the plain version's time and
   the bound; F2 + B1, F3 + B2 and B3 + B4 per block; the device time
   of the
   whole step and of the training kernels in it; the whole train step;
9. the three later kernels against their plain versions at full width:
   ``fused_ds_tcn`` (the MDTC kernel's body with the DS-TCN layer) at
   C = 64, 48, 256, 32 and 128, T = 1, 7, 8, 198, 1024 and 2048, B = 1,
   4, 16 and 64, and 8 layers of dilations 1-128 over 2048 frames, each
   with the plan the wrapper chose and launched twice (bitwise equal),
   and B=16 chained in chunks of 8 over 200 frames;
   ``fused_fsmn_layers`` at the hi_xiaowen width (4 x 250/128, orders
   10/2) at B=16 x T=66, B=4 x T=1024, B=1 x T = 1, 10 and 11 (below
   and at P = 11), and at the synthetic CTC recipe's (3 x 64/32, orders
   8/2, P = 9: path D) at B=256 x T=66 and B=1 x T = 1, 10 and 11; at
   each width B=1 chained in chunks of 10 over 200 frames (each
   chain against the one-shot call and the plain chain, final cache
   too; 1e-4 abs + 1e-4 rel); ``fused_fbank`` through both plans (the
   shared-memory FFT and the dense DFT, each launched twice, bitwise
   equal) at (512, 32000) M=40, (64, 32000) M=80, MFCC, magnitude/no-
   log, hamming, no preemphasis, no DC removal, an odd frame of 401 and
   ``round_to_power_of_two: false`` (the dense plan alone) against the
   three-matmul plain version; with dither on and one seed the FFT plan
   against the dense plan (the same noise); the in-kernel dither by the
   per-bin mean and standard deviation of the log-mel over 101,376
   frames against torch.randn, same seed bitwise equal, another seed
   different;
10. path A, as phase 4 for the DS-TCN recipe: offline fused forward ->
    score file -> DET and ``BatchMaxPoolSpotter(use_fused=True)``,
    through ``fused_ds_tcn``; then the hi_xiaowen DS-TCN (C=256, two
    keywords, its recipe's MFCC 80 of 80, which the port's streaming
    frontend computes: ROADMAP C.10);
11. path B: ``KeyWordSpotter`` with and without ``use_fused`` fed the
    same 2 s waves in 300 ms chunks (softmax posteriors and result
    dicts agree; one ``fused_fsmn_layers`` launch per chunk that carried
    frames), ``build_fused_forward(softmax=True)`` at B=16 against the
    module, and the detector firing on injected keyword posteriors;
12. path C: the phase-7 trainer with ``fused_frontend: True``: step-0
    features and loss against the unfused frontend, steps with the
    flagship's wave-mode dither + spec_aug, two steps with frame-mode
    (in-kernel) dither, a cv step; one ``fused_fbank`` launch per step;
13. times of the three kernels at their main shapes (DS-TCN at C = 64
    and 256; FSMN also at path D's; fbank's dense-DFT plan beside its FFT plan), the FSMN
    variants' (clusters of 8 or 16 blocks;
    ``wekws_tpu_torch/tools/time_fsmn.py``) and the grid of an FSMN
    launch from the profiler's trace (B x 8 blocks), of the path-C train step
    beside the unfused-frontend step, and of ``KeyWordSpotter.forward``
    per 300 ms chunk;
14. the flagship recipe through the CLIs (``examples/synthetic``) and
    the JAX DS-TCN fixture;
15. path D, CTC: (a) the hi_xiaowen FSMN-CTC (2599 tokens, CMVN from
    the batch) trained through ``Trainer(..., "ctc")`` on ``bench.py``
    bench_ctc's batch, B=256 x 2 s with U=6 labels: step 0 against the
    same model in float64 on the card (loss 1e-5 rel, each tensor's
    gradient 1e-3 of its largest |grad|) and the port's CTC loss against
    ``F.ctc_loss`` in float64 (1e-4 rel), 5 steps without augmentation
    (finite, decreasing), 2 with dither + spec_aug, a cv step with the
    decode accuracy, the step's time, device idle share and the CTC
    loss's launches and device time, then saved, reloaded and served by
    one ``fused_fsmn_layers`` launch for the logits and one for the
    posteriors; (b) ``examples/synthetic_ctc``:
    the corpus (``gen_data_torch.py``, seed 17), ``bin.train --dict`` 2
    epochs, average, ``bin.score_ctc`` (one ``fused_fsmn_layers`` launch
    per batch, posteriors against the module route, ``--device_decode``
    against the same search on the CPU), ``bin.compute_det_ctc``,
    ``bin.stream_score_ctc`` (one launch per chunk that carried frames),
    and ``KeyWordSpotter`` with and without ``use_fused`` over the test
    list (posteriors 1e-4 abs + 1e-4 rel, the same results); (c) the JAX fixture (``exp/fsmn_ctc/avg_5.ckpt``, its bfloat16
    config: the dtype dropped, logged) through the same CLIs,
    ``--device_decode`` against the host decoder, and read against its
    committed TPU ``score.txt``, ``stream_score.txt`` and
    ``stats.1_2_3.txt``.  No plain version of a hand kernel runs on a
    CUDA tensor.  The FSMN record splits its launches over the timed
    shapes and gives each the device time it loses to the bound;
16. path E, classification and the other backbones: (a)
    ``examples/speechcommand_v1/conf/mdtc.yaml`` (MFCC 80 of 80, MDTC
    4 x 4, C=64, global head, 12 classes) with ``fused_train`` and
    ``fused_frontend`` at B=100 x 1 s through ``Trainer(..., "ce")``:
    ``fused_fbank`` against its plain version at that shape, step 0
    (dropout off, the features shared) fused against unfused (loss 1e-5
    rel) and both against float64 (each block 2e-2 of its largest
    |grad|, the head 1e-3), 5 steps (finite, decreasing), 2 with wave
    dither + spec_aug, F1-F4/B1-B4 launched 17 times a step and
    ``fused_fbank`` once, the step's time and idle share, each path-E
    kernel's device time against its bound, then served with the
    global head by one ``fused_mdtc_kernel`` launch against the module
    forward; (b) ``examples/synthetic_commands`` through the CLIs: the
    corpus (``gen_data_torch.py``, seed 11), ``bin.train`` 2 epochs,
    ``bin.average_model --val_best``, ``bin.compute_accuracy`` on the
    card: ``conf_torch/mdtc_ce.yaml`` by the route ``fused`` (one launch
    a batch; logits against the module route, the same argmax),
    ``conf/gru_ce.yaml`` by the route ``module`` (no launch; the CPU's
    accuracy); (c) the JAX fixture ``exp/mdtc_ce/avg_5.ckpt`` (its
    bfloat16 dtype dropped, logged) through ``bin.compute_accuracy``,
    against the module route and the README's TPU count 248/256;
    (d) the hi_xiaowen GRU at B=256 x 2 s through ``Trainer(...,
    "max_pooling")`` (step 0 against float64: loss 1e-5 rel, each
    tensor's gradient 1e-3 of its largest), 3 steps, the step's time and
    idle share, streamed by ``BatchMaxPoolSpotter(use_fused=False)``
    against the offline posteriors; the hi_xiaowen full-conv TCN by the
    module route on the card against the CPU.  Path E's launches are
    added to the records of ``fused_mdtc_forward``, ``fused_fbank`` and
    the eight passes, and kept apart (``path_e_launches``, ``path_e``:
    shape, device time, bound);
17. path F, the serving daemon: (a) the device stream featurizer
    (``runtime/device_frontend.py``) through ``fused_fbank`` at 64
    streams x 8 frames for the flagship (fbank 40, windows (64, 1520)),
    the hi_xiaowen FSMN-CTC (fbank 80, context 2/2, skip 3, (64, 4400))
    and the hi_xiaowen DS-TCN (MFCC 80 of 80), every step against the
    same featurizer on the CPU (phase 9's limit) and the host
    ``StreamingFrontend``; (b) the engines at 64 streams x 8 frames:
    the flagship through ``BatchMaxPoolSpotter(use_fused=True)`` with
    the host and the device frontend against the module route
    (posteriors, events), the hi_xiaowen FSMN-CTC through
    ``BatchKeywordSpotter(use_fused=True)``, host and device decode,
    with and without the device frontend, with a keyword planted in
    every fourth stream's posteriors: posteriors against the module
    route, each device-decode step against the same search on the CPU,
    host and device decode the same detections; mean and p99 step,
    dispatch share, real-time factor, launches per step; (c) the JAX
    CTC fixture (host decode; device decode with the device frontend)
    and the JAX DS-TCN fixture served by ``bin.serve`` in a subprocess
    to 16 client threads (192 utterances each, 300 ms chunks; device
    decode the first 48), every daemon started before the in-process
    engines run and timed once all are up: events
    equal to the in-process engine's and, for CTC, ``KeyWordSpotter``'s,
    and bin.serve's own launch counts (logged when SIGTERM stops it) one
    a dispatch for each kernel of its route; an in-process
    ``KwsServer`` on the CTC fixture (device decode, device frontend)
    and on the flagship at 64 clients, every step on the engine thread's
    default stream, and the flagship's ``bin.serve`` to the same 64
    clients; (d) ``bin.batch_stream_kws`` (host and device decode) and
    ``bin.stream_kws_ctc`` on the CTC fixture; (e) each path-F kernel
    at every shape 17a-17d gave it, on that shape's first inputs as the
    engines passed them (``ShapeTap``): against its plain version on
    the same card tensors, then per call, device time, plain and bound.
    Path F's launches are added to the records of
    ``fused_mdtc_stream``, ``fused_fbank``, ``fused_ds_tcn`` and
    ``fused_fsmn_layers`` and kept apart by sub-path
    (``path_f_launches``, bin.serve's own counts among them;
    ``path_f``: shape, calls, error, times, bound); the serving figures
    are one JSON line (``path_f_figures``);
18. path G, device-resident epochs (``data/resident.py``): (a) 4,096
    train and 1,024 cv rows of 2 s made from a seed as int16 (phase
    7's signal) and staged with ``stage_arrays`` (bytes, seconds, GB/s,
    memory; rows read back equal); (b) the flagship with
    ``fused_train`` and ``fused_frontend`` (wave dither, spec_aug): one
    resident step at B=512 against ``Trainer.train_step`` on the same
    rows copied to the host and back, from the same state, seed and
    step (loss, accuracy, every parameter and BN statistic: equal), one
    resident cv step against ``Trainer.cv_step``; (c) 8 steps through
    ``Executor.train_resident`` (wall clock and CUDA events) and one
    ``cv_resident`` pass, the resident step beside the host-fed step
    (float32 waves and int16 rows) in turns, its device idle share, and
    every copy from the host in its trace (none over 64 KB; the
    host-fed step's wave copy as the witness that the trace shows them),
    both traced in a fresh process, where the profiler misses nothing
    (late in this one it loses records); (d) ``bin.train --device_resident`` on
    ``examples/synthetic`` (``conf_torch/mdtc_flagship.yaml``, 2
    epochs), averaged, scored through ``fused_mdtc_kernel`` and DET as
    phase 14, each epoch's audio-s/s beside phase 14's host-fed run;
    (g) ``examples/synthetic_noisy`` as its ``run_torch.sh`` with no
    config: the DS-TCN trained resident with the augmentation on the
    card (``conf/ds_tcn_aug.yaml``) and without
    (``conf/ds_tcn_clean.yaml``), 2 epochs each, both scored on test and
    test_noisy through the DS-TCN kernel, and
    ``local/report_torch.py``'s table of their FRR at 2 FA/h (a finding,
    no bound); (e)
    ``fused_fbank`` and the eight passes at every shape 18a-18d gave
    them (``ShapeTap``, ``PassTap``), against their plain versions on
    the same card tensors (fbank phase 9's limit; a dithered call
    against the dense plan with the same seed, without dither against
    the plain version, and its dither's shift of the features against
    the plain version's in distribution, ``DITHER_Z``; the passes as
    phase 6), timed (device
    times from the fresh process, on seeded inputs of each shape) and
    bounded.  Path G's launches are added to the records of
    ``fused_fbank`` and the passes (``path_g_launches``, ``path_g``);
    the step figures are one JSON line (``path_g_figures``);
19. path H, export and static int8 (``export/``): (a) the hi_xiaowen
    FSMN-CTC (phase 11's checkpoint), the flagship MDTC (phase 4's) and
    the JAX DS-TCN fixture through ``bin.export_model`` (its numpy and
    device gates; the fixture's files equal to its committed export/),
    each artifact through ``TorchGraphRuntime`` on the card against the
    same runtime on the CPU and against the fused serving kernels on the
    same weights (``fused_fsmn_kernel``, ``fused_mdtc_kernel``,
    ``fused_ds_tcn_kernel``: 16 x 2 s offline and 8-frame chunks;
    TOL); (b) the FSMN-CTC artifact calibrated on seeded waves through
    the port's ``StreamingFrontend`` and statically quantized, on the
    card against the numpy runtime (every int8 accumulator equal,
    outputs within 2e-5), chunks against one call, an int8 contraction
    of K = 1,032 exact and of 1,033 refused; (c) the committed JAX CTC
    fixtures (export/, export_int8/) served by ``BatchKeywordSpotter`` at
    64 streams x 8 frames with the device frontend (``fused_fbank``):
    the float artifact's posteriors against the fixture checkpoint
    through ``fused_fsmn_kernel`` (TOL, the same detections), the int8
    one with device decode; ``bin.serve --checkpoint <artifact dir>``
    to 16 client threads (the in-process engine's events); the int8
    decisions of ``bin.stream_score_ctc`` on the 192 test utterances
    beside the float artifact's; (d) ``bin.static_quantize
    --calib_data``, ``bin.export_torch`` -> ``bin.import_torch`` (the
    state back, 0 apart), ``run_torch.sh`` stage 4 on phase 14's
    averaged model; the hi_xiaowen FSMN-CTC at 64 streams x 8 frames,
    fused checkpoint, float and int8 artifact: host-clock step, real-time
    factor, and one traced step's device time and CUDA launches from a
    fresh process; (e) each kernel against its plain version at every
    shape path H gave it (``ShapeTap``).  Path H's launches are added to
    the kernel records (``path_h_launches``, ``path_h``); the figures are
    one JSON line (``path_h_figures``).

20. path I, data parallelism (``parallel/``): (a) two flagship steps
    (B=512 x 2 s, ``fused_train``, ``fused_frontend``, dither, spec_aug)
    in a one-rank NCCL group that the phase makes (every collective of
    the Trainer on NCCL, each a copy) against the same steps with no
    group, bit for bit; (b) two ranks spawned on the one card (gloo on
    CUDA tensors: NCCL refuses two ranks on one GPU), B=256 each of the
    same 512 rows, no dither or spec_aug, three steps against one
    process at B=512 (step 0's loss 1e-5 rel and its summed gradients
    1e-4 of their scale, later losses 1e-4 rel, parameters and BN
    statistics within tests/test_torch_training.py's bounds), the ranks
    bit for bit alike, the all-reduces a step and their host time, then
    F1-F4/B1-B4 and ``fused_fbank`` at a rank's shapes against their
    plain versions (as 18e); (c) ``bin.train --coordinator ...
    --num_processes 2 --process_id r`` as two processes, host-fed (the
    bucket schedule) and ``--device_resident`` side by side, one epoch of
    ``examples/synthetic`` each: the same cv line on both ranks, files
    from rank 0 only, ``bin.score`` of its checkpoint through
    ``fused_mdtc_kernel``; (d) ``BatchMaxPoolSpotter`` over two row
    blocks on the card against the one-device engine at 64 x 8
    (posteriors, events); (e) ``bin.serve --mesh_devices 1`` (started
    during (c)) to four clients.  Path I's launches are added to the kernel records
    (``path_i_launches``, ``path_i``); the figures are one JSON line
    (``path_i_figures``).

21. path J, the training knobs (ROADMAP A.15), in a fresh process:
    (a) the bf16-operand variants of F2, F3, B2 and B3 (``f2_bf16_kernel``
    .. ``b3_bf16_kernel``) against their bf16 plain versions
    (``compare_pass`` at bf16), launched twice (bitwise equal), at B=512 x
    T=198 x C=64, dilations 1, 2, 4, 8, and at C = 32 and 128 (B=64), each
    beside its control (the plain version with float32 operands, which must
    fail that check); at the main shape each one's time, device time, plain
    time, the float32 kernel's time and the bound; (b) the flagship B=512 x
    2 s at bench.py's default (``dtype: bfloat16``, ``bn_dtype: bfloat16``)
    by the module route and with ``fused_train``, beside the float32 fused
    step, three steps each from one seeded state (losses finite, parameters
    and gradients float32, no plain version on a CUDA tensor; the bf16 fused
    route launches the four variants and F1, F4, B1, B4 17 times a step and
    no float32 F2, F3, B2, B3; the module route nothing), step-0 gradients
    against float64 and the routes against each other (two planted faults
    must fail that check), each route's step time, thread CPU time, idle
    bounds and peak memory; (c) ``remat: true`` against ``remat:
    false`` on both routes (loss, gradients, running statistics,
    ``num_batches_tracked``; the fused forward passes twice; peak
    memory); (d) ``ghost_bn: 4`` (no F/B pass launched; the running
    statistics against the ghost-BN formula in float64); (e) the
    FSMN-CTC at bench.py's CTC width at bf16, B=256 x 2 s, three steps
    and the step figures beside float32, ``bin.train`` one epoch of
    ``examples/synthetic_ctc`` with its own bf16 ``conf/fsmn_ctc.yaml``
    and ``bin.score_ctc`` of that checkpoint through
    ``fused_fsmn_kernel``.  The four variants join the kernel record;
    path J's other launches are added to their kernels' records
    (``path_j_launches``); the figures are one JSON line
    (``path_j_figures``).

22. path K, the last entry points, in a fresh process: (a) the flagship
    (phase 4's checkpoint), the JAX CTC fixture and the JAX DS-TCN
    fixture through ``bin.export_model --format stablehlo --chunk_frames
    32`` on the card (``model.pt2``, a ``torch.export`` program of the
    module route's cached step: ROADMAP C.28); each program loaded in a
    fresh process and stepped over phase 4's waves through the model's
    frontend in 32-frame chunks from the initial cache, its outputs and
    final caches against the module route on the CPU and against the
    fused stream on the card (``fused_mdtc_kernel``,
    ``fused_fsmn_kernel``, ``fused_ds_tcn_kernel``; outputs and the
    packed cache's layers; TOL), a flat output failing; its aten op
    counts (nothing but aten operators); one step at B=1 x 32 of the
    program and of the fused stream: host clock, device time, launches;
    (b) ``examples/synthetic_scale``: ``run_torch.sh`` and
    ``run_ctc_torch.sh``, stages 0-5: stages 0-1 (the corpus and CMVN,
    the CPU alone) started before phase 2's build, beside it
    (``PathKHead``), stages 2-5 here side by side, with (a) in this
    process beside them (its timings after them), the corpora cut and 1
    epoch (each cut printed), every port CLI they start tapped (a
    sitecustomize on PYTHONPATH enters ``ShapeTap``, ``PassTap`` and
    ``PlainOnCuda`` for a ``python -m wekws_tpu_torch.bin.*`` process:
    ``recipe_tap``; and ``python -m wekws_tpu_torch.tools.
    bench_serving_slo``, the CTC recipe's stage 4, whose process path M
    reads): stages 0-4 of both
    ended, ``bin.train`` through ``fused_fbank``, F1/F4/B1/B4 and the
    bf16 variants of F2/F3/B2/B3, ``bin.score`` through
    ``fused_mdtc_kernel``, ``bin.score_ctc`` through
    ``fused_fsmn_kernel``, no plain version on a CUDA tensor, the
    recipe's ``model.pt2`` loaded back and held against the averaged
    model's step over eight of its test utterances; stage 5 (the DET
    plot): the PNG where the machine has matplotlib, else an ImportError
    naming the ``plot`` extra; (c) each kernel path K launched against its plain version at
    every shape path K gave it (22a's inputs; 22b's weights with seeded
    stand-ins for its larger tensors; the passes on seeded block inputs
    of their shapes), with times, device times and bounds.  Path K's
    launches are added to the kernel records (``path_k_launches``,
    ``path_k``); the figures are one JSON line (``path_k_figures``);
23. path L, the public recipes (ROADMAP A.20), in a fresh process, on
    miniature corpora written in the datasets' own layouts
    (``wekws_tpu_torch.tools.public_layouts``): (a) in examples/
    hi_xiaowen ``run_ctc_torch.sh --config conf_torch/ds_tcn_ctc.yaml
    --trainbase true`` (the DS-TCN CTC at C=256, B=256, fine-tuned from
    a base pretrained at B=200 on an ASR-layout corpus; then
    ``score_ctc``, ``stream_score_ctc``, DET, export and int8) and in
    examples/speechcommand_v1 ``run_torch.sh`` (the MDTC, MFCC 80 of 80,
    the global head, B=100; ``compute_accuracy``), 1 epoch a training
    stage: the layouts and stages 0-1 beside the kernel build
    (``PathLHead``), the rest in two rounds of jobs side by side
    (``PATH_L_ROUNDS``), every port CLI tapped as in 22b: every stage
    ended, the fine-tune's first epoch one past the base's last with its
    lr and best cv loss, 17 launches a ``bin.train`` step of each float32
    pass (no bf16 variant), ``fused_fbank`` at least once a step, one
    ``fused_ds_tcn_kernel`` launch a ``bin.score_ctc`` batch and one
    ``fused_mdtc_kernel`` a ``bin.compute_accuracy`` batch, no plain
    version on a CUDA tensor; (b) each kernel path L launched against
    its plain version at every shape path L gave it, with times, device
    times and bounds (``path_l_launches``, ``path_l``,
    ``path_l_figures``);
24. path M, the serving SLOs and the decode drift (ROADMAP A.14, A.21),
    in a fresh process: (a) the scale CTC recipe's stage 4 (run in 22b,
    its process tapped): its ``slo.json`` read back (JAX's keys in every
    line, step-bearing chunks at 1, 16 and 64 streams), one
    ``fused_fsmn_kernel`` launch an engine step and no plain version on
    a CUDA tensor; then ``wekws_tpu_torch.tools.bench_serving_slo`` in
    this process on the recipe's model at 64 streams with
    ``--device_decode --device_frontend --iters 50``: one
    ``fused_fsmn_kernel`` and one ``fused_fbank`` launch a step; the
    p50/p95/p99 and real-time factors printed, with no limit; (b) its
    detection mode on the JAX CTC fixture (keyword 123, 50 utterances in
    100 ms chunks), fused on the card and by the module route on the CPU
    in this process: the same misses and the same activation frame for
    every utterance; (c) ``wekws_tpu_torch.tools.drift_sweep`` on the
    fixture over the synthetic CTC corpus's first 64 test utterances at
    thresholds 0.1 and 0.5 on the card: no event-set divergence, the
    largest score gap within 2e-3 (C.4); (d) each kernel path M launched
    against its plain version at every shape path M gave it
    (``path_m_launches``, ``path_m``, ``path_m_figures``).

The last lines are the card, the per-kernel JSON record (17 kernels:
the 13 and the four bf16 variants) and ``{"ok": true, "device":
{...}}``.  Run from the repository root: ``python3 chip_smoke.py``;
``python3 chip_smoke.py --phase 20`` runs phases 1-2 and path I alone
(phase 4's checkpoint and phase 7's model config made from their
seeds), ``--phase 21`` phases 1-2 and path J alone, ``--phase 22``
phases 1-2, phase 4's checkpoint and path K alone, ``--phase 23``
phases 1-2 and path L alone, ``--phase 24`` phases 1-2, 22b's CTC recipe
alone (its stages 0-1 beside the build) and path M.

The run keeps inside its time limit by doing on the CPU's idle cores
what needs no card while the kernels build (the corpora that phases 15,
16, 17, 19 and 21 read: ``CORPORA``; paths K's and L's stages 0-1), by
starting each ``bin.serve`` before the untimed work that precedes its
timed session, and by the cut depths named where they are set; each
part of phases 15-23 prints its wall time (``[part] name (s)``).
"""

import copy
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np

SEED = 0
CHANNELS = 64
FLAGSHIP_MODEL_CONF = {
    "input_dim": 40,
    "output_dim": 1,
    "hidden_dim": CHANNELS,
    "preprocessing": {"type": "linear"},
    "backbone": {
        "type": "mdtc", "num_stack": 4, "stack_size": 4,
        "kernel_size": 5, "hidden_dim": CHANNELS, "causal": True,
    },
}
DATASET_CONF = {
    "feats_type": "fbank",
    "fbank_conf": {"num_mel_bins": 40, "frame_shift": 10,
                   "frame_length": 25, "dither": 0.0},
}
TOL = 1e-4  # abs and rel: fp32 with another summation order
# H100 SXM published peaks (NVIDIA data sheet): fp32 outside the
# tensor cores, and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12  # tensor cores, dense
PEAK_BYTES_PER_S = 3.35e12
TRAIN_B, TRAIN_SECONDS = 512, 2
TRAIN_DATASET_CONF = {  # __graft_entry__.DATASET_CONF, the flagship recipe
    "feats_type": "fbank",
    "fbank_conf": {"num_mel_bins": 40, "frame_shift": 10,
                   "frame_length": 25, "dither": 1.0,
                   "dither_mode": "wave", "precision": "default"},
    "spec_aug": True,
    "spec_aug_conf": {"num_t_mask": 1, "num_f_mask": 1,
                      "max_t": 20, "max_f": 10},
}
TRAIN_STEPS_PLAIN, TRAIN_STEPS_AUG = 5, 2
# step-0 gradients of each block against float64, relative to the
# block's largest |grad|.  Exact BN's E[x^2] - E[x]^2 cancels in fp32,
# and the unfused fp32 route itself is off float64 by up to 4.6e-3 of a
# block's largest |grad| here (1.1e-2 on the CPU at B=8); a wrong
# kernel is off by the order of the gradient itself
GRAD64_TOL = 2e-2
# a parameter's gradient whose reference reaches this share of its
# group's largest |grad| is settled (``group_share``'s cosine); the
# cancelling biases read 1e-3 of it or less, the least of the rest 0.09
SETTLED_SHARE = 1e-2
# |pre-activation| of the block's residual ReLU below which fp32 rounding
# may put an element on the kink's other side in the fused route than in
# the unfused one (phase 6: the upstream gradient is zero there)
KINK = 1e-4
TRAIN_PASSES = ("f1", "f2", "f3", "f4", "b1", "b2", "b3", "b4")
# the passes redesigned for the card (float4 elementwise steps; products
# in registers, on the tensor cores or none): phase 2 prints their
# registers and spills by name
REDESIGNED_KERNELS = ("f1_tile_kernel", "f2_kernel", "f3_kernel",
                      "b1_stream_kernel", "b2_kernel", "b3_kernel",
                      "b4_kernel", "f2_bf16_kernel", "f3_bf16_kernel",
                      "b2_bf16_kernel", "b3_bf16_kernel")
KEYWORD = "HI"
DS_TCN_MODEL_CONF = {  # examples/hey_snips/conf/ds_tcn.yaml
    "input_dim": 40, "output_dim": 1, "hidden_dim": CHANNELS,
    "preprocessing": {"type": "linear"},
    "backbone": {"type": "tcn", "ds": True, "num_layers": 4,
                 "kernel_size": 8, "dropout": 0.1},
}
DS_TCN_WIDE_MODEL_CONF = {  # examples/hi_xiaowen/conf/ds_tcn.yaml
    "input_dim": 80, "output_dim": 2, "hidden_dim": 256,
    "preprocessing": {"type": "linear"},
    "backbone": {"type": "tcn", "ds": True, "num_layers": 4,
                 "kernel_size": 8, "dropout": 0.1},
}
# its recipe's features: MFCC, 80 cepstra of 80 mel bins (the port's
# streaming frontend computes MFCC for such a config: ROADMAP C.10)
DS_TCN_WIDE_DATASET_CONF = {
    "feats_type": "mfcc",
    "mfcc_conf": {"num_ceps": 80, "num_mel_bins": 80, "frame_shift": 10,
                  "frame_length": 25, "dither": 0.0},
}
DS_TCN_WIDE_KEYWORDS = (KEYWORD, "NIHAO")
# phase 9's DS-TCN widths (the recipes' 64, 48 and 256, then 32 and 128)
# and shapes (B, T): the engine's step, offline scoring, one frame, a
# chunk shorter than the step, 64 utterances, long utterances; and 8
# layers of dilations 1-128 (pad_max 896: the halo does not fit the
# windows in shared memory)
DS_TCN_WIDTHS = (64, 48, 256, 32, 128)
DS_TCN_CASES = ((16, 8), (16, 198), (1, 1), (4, 7), (64, 198), (4, 1024),
                (1, 2048))
DS_TCN_LONG_DILATIONS = tuple(2 ** i for i in range(8))
FSMN_VOCAB = 2599
FSMN_MODEL_CONF = {  # examples/hi_xiaowen/conf/fsmn_ctc.yaml
    "input_dim": 400, "output_dim": FSMN_VOCAB, "hidden_dim": 128,
    "preprocessing": {"type": "none"},
    "backbone": {"type": "fsmn", "input_affine_dim": 140, "num_layers": 4,
                 "linear_dim": 250, "proj_dim": 128, "left_order": 10,
                 "right_order": 2, "left_stride": 1, "right_stride": 1,
                 "output_affine_dim": 140},
    "classifier": {"type": "identity", "dropout": 0.1},
    "activation": {"type": "identity"},
}
FSMN_DATASET_CONF = {
    "feats_type": "fbank",
    "fbank_conf": {"num_mel_bins": 80, "frame_shift": 10,
                   "frame_length": 25, "dither": 1.0},
    "context_expansion": True,
    "context_expansion_conf": {"left": 2, "right": 2},
    "frame_skip": 3,
}
CTC_KEYWORD, CTC_KEYWORD_TOKENS = "hixiaowen", (10, 20, 30)
# log-mel (magnitude ~1e1) and MFCC against the three-matmul plain
# version: fp32 sums over 400 and 257 terms in another order, then a log
FBANK_ATOL, FBANK_RTOL = 1e-3, 1e-4
# in-kernel dither against torch.randn, per mel bin over 101,376 frames
# of independent noise: the standard error of a bin's mean is about
# 0.003 and of its standard deviation about 0.3% (more in the low bins,
# whose few DFT bins give the log a heavy tail)
DITHER_MEAN_TOL, DITHER_STD_RTOL = 0.02, 0.03
# a dithered fbank call at a path's own shape against the plain
# version's torch.randn dither: per mel bin, the mean and the mean
# square of the dither's shift of the features agree within this many
# standard errors of their difference (frame by frame, over the call)
DITHER_Z = 6.0
N_UTTS, SECONDS, RATE = 16, 2, 16000
CHUNK_SAMPLES = RATE * 300 // 1000


def phase(name):
    class _Phase:
        def __enter__(self):
            self.t0 = time.perf_counter()
            print(f"[phase] {name} ...", flush=True)

        def __exit__(self, exc_type, exc, tb):
            status = "ok" if exc_type is None else "FAILED"
            print(f"[phase] {name} {status} "
                  f"({time.perf_counter() - self.t0:.1f} s)", flush=True)
            return False

    return _Phase()


# the parts of the later phases, each of which prints its own wall time
# ("[part] name (s)") where it returns: the readings by which a phase's
# depth is cut to keep the run inside its time limit
TIMED_PARTS = r"phase(1[4-9]|2[0-4])[a-g]\w*|path_[g-m]_\w*child" \
    r"|path_g_traces|phase19_times"


def timed_part(fn):
    import functools

    @functools.wraps(fn)
    def part(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            print(f"[part] {fn.__name__} ({time.perf_counter() - t0:.1f} s)",
                  flush=True)

    return part


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def seeded_model(base_conf, generator, cmvn=None):
    """KWSModel of ``base_conf`` with seeded weights and BN statistics
    nudged so that folding is not the identity."""
    import torch

    from wekws_tpu_torch.models import init_model

    conf = dict(base_conf)
    if cmvn is not None:
        conf["cmvn"] = {"mean": cmvn[0].tolist(), "istd": cmvn[1].tolist(),
                        "norm_var": True}
    model = init_model(conf, generator)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(0.1 * torch.randn(buf.shape, generator=generator))
            elif name.endswith("running_var"):
                buf.copy_(1.0 + 0.5 * torch.rand(buf.shape,
                                                 generator=generator))
    return model, conf


def cuda_time_ms(fn, reps=30, warmup=5):
    """Median of per-call CUDA-event times."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


def kernel_vs_plain_ms(kern, plain):
    """Per-call CUDA-event times (median of 30) of a kernel and its plain
    version, in the order plain, kernel, kernel, plain; the second of
    each."""
    cuda_time_ms(plain)
    cuda_time_ms(kern)
    ms = cuda_time_ms(kern)
    return ms, cuda_time_ms(plain)


def profiled_device_ms(fn, kernel_name, reps=20):
    """Mean device time of the CUDA kernel ``kernel_name`` per call,
    from torch.profiler, or None when the profiler records no device
    time.  Unlike the CUDA-event time of one call on an idle GPU, this
    leaves out the wrapper's host work before the launch."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):  # a trace now and then comes back without it
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)  # as in profiled_step
            torch.cuda.synchronize()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = count = 0
        for evt in prof.key_averages():  # every entry of that name
            if kernel_name in evt.key and evt.count:
                dev = getattr(evt, "device_time_total",
                              getattr(evt, "cuda_time_total", 0.0))
                if dev:
                    total += dev
                    count += evt.count
        if count:
            return total / count / 1e3
    return None


def mdtc_bound_ms(b, t, c, n_layers, k, n_stacks, pad_max, stream):
    """Least time on an H100 for one fused MDTC call: the larger of
    compulsory bytes over HBM bandwidth and fp32 operations over the
    fp32 peak.  Per frame and layer: 2KC (depthwise) + 4C^2 (two
    products) + 4C (three biases, residual); plus one add per stack
    output.  Bytes: x read, out written, folded weights read once, and
    the (L, B, pad_max, C) cache read and written when streaming."""
    frames = b * t
    flops = frames * (n_layers * (2 * k * c + 4 * c * c + 4 * c)
                      + n_stacks * c)
    nbytes = 4 * (2 * frames * c
                  + n_layers * (k * c + 2 * c * c + 3 * c))
    if stream:
        nbytes += 4 * 2 * n_layers * b * pad_max * c
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


# phase 3's MDTC shapes (B, T, C): the main path's (16 x 198 offline,
# 16 x 8 streaming), 64 utterances, one frame, chunks shorter and longer
# than a block's rows, long utterances (1024, 2048), C = 32 and 128
MDTC_CASES = ((16, 198, 64), (16, 8, 64), (64, 198, 64), (1, 1, 64),
              (16, 7, 64), (4, 1024, 64), (1, 2048, 64), (16, 198, 32),
              (1, 2048, 32), (16, 8, 32), (16, 198, 128), (4, 2048, 128),
              (16, 8, 128), (64, 7, 128))
# and with a halo longer than shared memory holds at C=128 (a dilation of
# 64 at K=5: pad_max 256, each tap's rows staged), five layers
LONG_HALO_DILATIONS = (1, 1, 2, 4, 64)
LONG_HALO_CASES = ((2, 300, 128), (16, 8, 128), (1, 1, 128), (2, 300, 64))


def ds_tcn_weights(c, n_layers, k, gen):
    """Seeded folded weight stacks of a DS-TCN backbone of width c."""
    import torch

    def randn(*shape, scale):
        return torch.randn(shape, generator=gen) * scale

    return (randn(n_layers, k, c, scale=0.3), randn(n_layers, c, scale=0.1),
            randn(n_layers, c, c, scale=c ** -0.5),
            randn(n_layers, c, scale=0.1))


def mdtc_weights(c, n_layers, k, gen):
    """Seeded folded weight stacks of an MDTC backbone of width c."""
    import torch

    def randn(*shape, scale):
        return torch.randn(shape, generator=gen) * scale

    return (randn(n_layers, k, c, scale=0.3), randn(n_layers, c, scale=0.1),
            randn(n_layers, c, c, scale=c ** -0.5),
            randn(n_layers, c, scale=0.1),
            randn(n_layers, c, c, scale=c ** -0.5),
            randn(n_layers, c, scale=0.1))


def mdtc_plan_text(b, t, c, k, pad_max, arch="mdtc"):
    """The plan the MDTC (or, ``arch`` "ds_tcn", DS-TCN) wrapper chose
    for these shapes on this card."""
    from wekws_tpu_torch.ops import fused_mdtc

    plan = next((v for key, v in fused_mdtc._plans.items()
                 if key[:6] == (arch, b, t, c, k, pad_max)), None)
    if plan is None:
        return "no plan yet"
    return (f"cluster {plan['cluster']}{' spread' if plan['spread'] else ''}"
            f", {plan['rows']} frames a block, tile {plan['tile']}"
            f"{', depth split' if plan['splits'] == 2 else ''}, "
            f"layer inputs: {plan['window']}, {plan['nbuf']} weight "
            f"buffer(s), {plan['smem']} B")


def check_close(name, got, want, quiet=False, atol=TOL, rtol=TOL):
    import torch

    err = float((got - want).abs().max())
    ok = torch.allclose(got, want, atol=atol, rtol=rtol)
    if not quiet or not ok:
        print(f"  {name}: max_abs_err {err:.3e} "
              f"(|ref| max {float(want.abs().max()):.3e}, bound {atol} abs "
              f"+ {rtol} rel) {'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: kernel disagrees with reference")
    return err


def dither_z(kern_d, kern_0, plain_d, plain_0):
    """The largest |z| over mel bins of the mean and of the mean square
    of the shift that dither gives the features, ``kern_d - kern_0``
    against ``plain_d - plain_0`` (each (B, T, M)), frame by frame: the
    two draws of a frame's noise are independent, so each frame's
    difference has mean 0 when the two dithers agree in distribution."""
    import torch

    m = kern_d.shape[-1]
    dk = (kern_d - kern_0).reshape(-1, m).double()
    dp = (plain_d - plain_0).reshape(-1, m).double()
    if not ((dk != 0).any(0).all() and (dp != 0).any(0).all()):
        raise AssertionError("dither moved no feature of a mel bin")

    def z(x):  # 0 where the two draws agree on every frame
        m, se = x.mean(0).abs(), (x.var(0) / x.shape[0]).sqrt()
        return float(torch.where(se > 0, m / se, m * math.inf).nan_to_num(
            0.0).max())

    return z(dk - dp), z(dk ** 2 - dp ** 2)


def synth_waves(rng):
    """8 keyword utterances (500 Hz tone in noise), then 8 of noise."""
    n = SECONDS * RATE
    t = np.arange(n) / RATE
    waves = rng.standard_normal((N_UTTS, n)) * 300.0
    waves[: N_UTTS // 2] += 4000.0 * np.sin(2 * np.pi * 500.0 * t)
    return np.clip(waves, -32768, 32767).astype(np.int16)


def serving_slice(tag, base_conf, gen, dev, work, waves, offline_kernel,
                  stream_kernel, launches, dataset_conf=None,
                  keywords=(KEYWORD,)):
    """A max-pooling wake-word model of ``base_conf`` (one output per
    name of ``keywords``, the first the one the DET scores) served end
    to end: 16 synthetic 2 s utterances -> fbank or MFCC as
    ``dataset_conf`` says (else ``DATASET_CONF``) -> checkpoint saved and loaded
    through ``load_serving_model`` -> (a) offline ``build_fused_forward``
    -> score file -> DET, held against the module forward; (b)
    ``BatchMaxPoolSpotter(use_fused=True)`` fed 300 ms chunks, stepped
    and flushed, held against (a).  The launch count of each path's
    kernel wrapper is zeroed before the path and read after it into
    ``launches[f"{tag}_offline"]`` / ``launches[f"{tag}_stream"]``.
    Returns the number of frames per utterance."""
    import torch
    import yaml

    from wekws_tpu_torch.eval import (
        compute_det,
        frr_at_fa_per_hour,
        load_label_and_score,
        write_score_file,
    )
    from wekws_tpu_torch.frontend import compute_fbank_np, compute_mfcc_np
    from wekws_tpu_torch.ops.serving import build_fused_forward
    from wekws_tpu_torch.runtime import BatchMaxPoolSpotter
    from wekws_tpu_torch.runtime.keyword_spotter import (
        load_serving_model,
        load_spotter_config,
    )

    configs = {"dataset_conf": dataset_conf or DATASET_CONF}
    _, cfg, _, _, _ = load_spotter_config(configs)
    features = (compute_mfcc_np if cfg.feature_type == "mfcc"
                else compute_fbank_np)
    feats = np.stack([features(w.astype(np.float32), cfg) for w in waves])
    n_frames = feats.shape[1]
    mean = feats.mean(axis=(0, 1))
    istd = 1.0 / (feats.std(axis=(0, 1)) + 1e-6)
    model, model_conf = seeded_model(base_conf, gen, (mean, istd))
    configs["model"] = model_conf
    ckpt = os.path.join(work, f"{tag}.pt")
    config_path = os.path.join(work, f"{tag}.yaml")
    torch.save(model.state_dict(), ckpt)
    with open(config_path, "w") as f:
        yaml.safe_dump(configs, f)
    served = load_serving_model(configs, ckpt, cfg.feat_dim, device=dev)
    n_params = sum(p.numel() for p in served.parameters())
    print(f"  {tag} model: {n_params} parameters, features "
          f"{feats.shape}", flush=True)

    # (a) offline scoring through the whole-utterance kernel
    keys = [f"utt{i:02d}" for i in range(N_UTTS)]
    lengths = np.full((N_UTTS,), n_frames, np.int64)
    batch = {"keys": keys, "feats": feats, "lengths": lengths}
    offline_kernel.launches = 0
    forward = build_fused_forward(served, device=dev)
    offline = {}

    def forward_fn(b):
        probs = forward(b["feats"], b["lengths"])
        offline["probs"] = probs
        return probs.cpu().numpy(), b["lengths"]

    score_file = os.path.join(work, f"{tag}_score.txt")
    label_file = os.path.join(work, f"{tag}_labels.jsonl")
    write_score_file(forward_fn, [batch], list(keywords), score_file)
    torch.cuda.synchronize()
    launches[f"{tag}_offline"] = offline_kernel.launches
    with open(label_file, "w") as f:
        for i, key in enumerate(keys):
            txt = KEYWORD if i < N_UTTS // 2 else "FILLER"
            f.write(json.dumps({"key": key, "txt": txt,
                                "duration": float(SECONDS)}) + "\n")
    kw_table, filler_table, filler_s = load_label_and_score(
        KEYWORD, label_file, score_file)
    det = compute_det(kw_table, filler_table, filler_s)
    probs_a = offline["probs"]
    if tuple(probs_a.shape) != (N_UTTS, n_frames, len(keywords)):
        raise AssertionError(f"offline posteriors {tuple(probs_a.shape)}")
    if len(kw_table) != N_UTTS // 2 or not det:
        raise AssertionError("score file / DET lost utterances")
    print(f"  (a) offline: posteriors {tuple(probs_a.shape)}, DET "
          f"{len(det)} thresholds, FRR at 1 FA/h "
          f"{frr_at_fa_per_hour(det, 1.0):.3f} (random weights), "
          f"{offline_kernel.__name__} launches "
          f"{launches[f'{tag}_offline']}", flush=True)
    with torch.inference_mode():
        module_probs, _ = served(
            torch.as_tensor(feats, device=dev),
            lengths=torch.as_tensor(lengths, device=dev))
    check_close("(a) fused forward vs module forward", probs_a,
                module_probs)

    # (b) batched streaming engine through the streaming kernel
    flat = probs_a.flatten().cpu().numpy()
    threshold = float(np.quantile(flat, 0.95))
    stream_kernel.launches = 0
    engine = BatchMaxPoolSpotter(
        ckpt, config_path, threshold, num_streams=N_UTTS,
        step_frames=8, keyword_names=list(keywords), use_fused=True,
        device=dev,
    )
    streamed = [[] for _ in range(N_UTTS)]
    step_fn = engine._step_fn

    def capture(feats_b, active, reset, cache):
        probs, new_cache = step_fn(feats_b, active, reset, cache)
        host = probs.cpu().numpy()
        for i in np.flatnonzero(active):
            streamed[i].append(host[i])
        return probs, new_cache

    engine._step_fn = capture
    events = []
    pcm = [w.astype("<i2").tobytes() for w in waves]
    for off in range(0, len(pcm[0]), 2 * CHUNK_SAMPLES):
        for i in range(N_UTTS):
            engine.accept_wave(i, pcm[i][off:off + 2 * CHUNK_SAMPLES])
        events += [r for r in engine.step().values() if r["state"]]
    events += [r for r in engine.flush().values() if r["state"]]
    torch.cuda.synchronize()
    launches[f"{tag}_stream"] = stream_kernel.launches
    got = torch.as_tensor(np.stack(
        [np.concatenate(s, axis=0)[:n_frames] for s in streamed]))
    check_close("(b) streamed vs offline posteriors", got,
                probs_a.cpu())
    stats = engine.stats
    print(f"  (b) streaming: {stats['dispatches']} steps of 8 frames x "
          f"{N_UTTS} streams, mean step {stats['dispatch_s'] * 1e3 / stats['dispatches']:.3f} ms "
          f"(host clock, first run), {len(events)} events at threshold "
          f"{threshold:.4f}, {stream_kernel.__name__} launches "
          f"{launches[f'{tag}_stream']}", flush=True)
    for path in ("offline", "stream"):
        if launches[f"{tag}_{path}"] < 1:
            raise AssertionError(f"{tag}: no kernel launch on its {path} "
                                 f"path")
    if not events:
        raise AssertionError("the streaming engine produced no events")
    return n_frames


def train_pass_bound_ms(name, b, t, c, k):
    """Least time on an H100 for one training pass: the larger of the
    compulsory bytes over HBM bandwidth (each (B, T, C) input read once,
    each output written once, weights once) and its operations over the
    peak of the unit the kernel uses (an FMA counts 2).  Per frame and
    channel: the depthwise conv 2K, each C x C product 2C, the
    elementwise BN, ReLU and exact-BN backward terms as counted below,
    all at the fp32 peak outside the tensor cores, except B3's four
    products: they run on the tensor cores in TF32, three passes each,
    so at a third of the TF32 peak (0.0201 ms at the main shape; as
    fp32 FMAs they would take 0.0496 ms).  F2's, F3's and B2's products
    are fp32 FMAs.  B3 reads dy, w, x, r and writes ds0; B4 reads dy, w, x,
    ds0, writes dx and has no product."""
    n = b * t
    act = 4 * n * c  # one (B, T, C) float32 tensor
    w = 4 * c * c
    per_frame = {  # fp32 operations per frame outside the tensor cores
        "f1": c * (2 * k + 3),
        "f2": c * (2 * k + 2) + 2 * c * c + 4 * c,
        "f3": c * (2 * k + 2) + 4 * c * c + 11 * c,
        "f4": 4 * c,
        "b1": 10 * c,
        "b2": 4 * c * c + 20 * c,
        "b3": c * (2 * k + 30),
        "b4": c * (6 * k + 30),
    }[name]
    tensor_per_frame = 8 * c * c if name == "b3" else 0
    nbytes = {
        "f1": act, "f2": act + w, "f3": 3 * act + 2 * w, "f4": 3 * act,
        "b1": 3 * act, "b2": 4 * act + 2 * w, "b3": 5 * act + 3 * w,
        "b4": 5 * act + 4 * (2 * k * c + c),
    }[name]
    t_ops = (n * per_frame / PEAK_FP32_FLOPS
             + n * tensor_per_frame / (PEAK_TF32_FLOPS / 3)) * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def kink_gap_shift(s, width=1e-3):
    """Per channel of ``s`` (B, T, C), the shift that moves zero to the
    middle of the widest gap between the channel's sorted values within
    ``width`` of zero, so that ``s + shift`` has no value near a ReLU's
    kink."""
    import torch

    shifts = []
    for col in s.reshape(-1, s.shape[-1]).t():
        z = torch.sort(col[col.abs() < width]).values
        z = torch.cat([z.new_tensor([-width]), z, z.new_tensor([width])])
        i = int((z[1:] - z[:-1]).argmax())
        shifts.append(-(z[i] + z[i + 1]) / 2)
    return torch.stack(shifts)

def phase6_train_kernels(dev, gen):
    """Every training pass against its plain version, plus the whole
    fused block against the unfused module block.  Returns the largest
    error of each pass, and the passes' inputs at the main shape and
    dilation 8 for phase 8's times."""
    import torch

    from wekws_tpu_torch.models.mdtc import TCNBlock
    from wekws_tpu_torch.ops.fused_mdtc_train import (
        PASSES,
        SUM_TOL,
        compare_pass,
        compare_sums,
        seeded_block_inputs,
        trace_pass_inputs,
    )

    errs = {name: 0.0 for name in TRAIN_PASSES}
    k = 5
    # the main path's shape at each of the flagship's dilations, where
    # each block of the persistent grid carries its sums across six to
    # eight tiles; one tile per block; a ragged batch; an utterance
    # shorter than the halo (K-1) d = 32, also at C=32 and C=128; C=32;
    # C=128
    cases = [(TRAIN_B, 198, 64, d) for d in (1, 2, 4, 8)] + [
        (64, 198, 64, 1), (64, 198, 64, 8), (5, 130, 64, 1),
        (5, 130, 64, 8), (7, 20, 64, 8), (7, 20, 32, 8), (7, 20, 128, 8),
        (64, 198, 32, 8), (64, 198, 128, 8)]
    main_calls = None
    for b, t, c, d in cases:
        p, x, dy = seeded_block_inputs(gen, b, t, c, k, dev)
        calls = trace_pass_inputs(x, p, dy, d)
        for name, args in calls.items():
            got = PASSES[name](*args)
            again = PASSES[name](*args)
            torch.cuda.synchronize()
            errs[name] = max(errs[name], compare_pass(
                f"{name} B={b} T={t} C={c} d={d}", got,
                PASSES[name].plain(*args)))
            got = got if isinstance(got, tuple) else (got,)
            again = again if isinstance(again, tuple) else (again,)
            if not all(torch.equal(u, v) for u, v in zip(got, again)):
                raise AssertionError(f"{name}: two launches differ")
        if (b, c, d) == (TRAIN_B, 64, 8):
            main_calls = calls
        print(f"  passes B={b} T={t} C={c} d={d}: "
              + ", ".join(f"{n} {errs[n]:.2e}" for n in TRAIN_PASSES)
              + " (running max abs err; bitwise reproducible)", flush=True)

    # the whole block: fused Function vs autograd of the unfused modules.
    # Where a ReLU's input lies within rounding of zero, the two fp32
    # routes may put it on opposite sides, and a flipped gate moves dx
    # and the sums by a whole term.  So no element sits near either kink:
    # the inner ReLU's (bn1's output) is moved per channel into the
    # widest gap between that channel's values near zero (a shift of the
    # bn1 bias), and the upstream gradient is zero within KINK of the
    # residual ReLU's (the unfused pre-activation bn2(w) + x)
    for b, t, d in ((64, 198, 1), (5, 130, 8)):
        blocks = [TCNBlock(64, 64, k, d, fused_train=fused).to(dev).train()
                  for fused in (True, False)]
        with torch.no_grad():
            for prm in blocks[0].parameters():
                prm.copy_(torch.randn(prm.shape, generator=gen).to(dev)
                          * 0.3)
        x = torch.randn((b, t, 64), generator=gen).to(dev)
        dy = torch.randn((b, t, 64), generator=gen).to(dev)
        pre = {}
        hooks = [blk.register_forward_hook(
            lambda mod, inp, out, key=key: pre.update({key: out.detach()}))
            for key, blk in (("bn1", blocks[1].bn1), ("bn2", blocks[1].bn2))]
        probe = copy.deepcopy(blocks[0])
        probe.fused_train = False
        probe.bn1.register_forward_hook(
            lambda mod, inp, out: pre.update(probe=out.detach()))
        with torch.no_grad():
            probe(x, None)
            blocks[0].bn1.bias.add_(kink_gap_shift(pre["probe"]))
        blocks[1].load_state_dict(blocks[0].state_dict())
        xs = [x.clone().requires_grad_() for _ in blocks]
        ys = [blk(xi, None)[0] for blk, xi in zip(blocks, xs)]
        for hook in hooks:
            hook.remove()
        clear = float(pre["bn1"].abs().min())
        kink = (pre["bn2"] + x).abs() < KINK
        dy = dy.masked_fill(kink, 0.0)
        for y in ys:
            (y * dy).sum().backward()
        (yf, yu), (dxf, dxu) = [y.detach() for y in ys], [xi.grad for xi in xs]
        bf, bu = blocks
        check_close(f"block B={b} T={t} d={d} y", yf, yu)
        check_close(f"block B={b} T={t} d={d} dx", dxf, dxu)
        for (name, bufa), bufb in zip(bf.named_buffers(), bu.buffers()):
            if "running" in name:  # the six batch statistics, folded in
                check_close(f"block {name}", bufa, bufb)
        worst = compare_sums("block grads",
                             [prm.grad for prm in bf.parameters()],
                             [prm.grad for prm in bu.parameters()])
        print(f"  fused block B={b} T={t} d={d} vs unfused autograd: y, "
              f"dx and running statistics within {TOL} abs + {TOL} rel; "
              f"12 parameter gradients max err {worst:.2e} (bound "
              f"{SUM_TOL} x the largest |grad|); no bn1 output within "
              f"{clear:.1e} of the inner ReLU's kink, dy zero at "
              f"{int(kink.sum())} elements within {KINK} of the residual "
              f"ReLU's", flush=True)
    return errs, main_calls


def float64_grads(conf, state_dict, feats, feat_lengths, batch):
    """Gradients of the unfused model in float64 on the same features
    and loss as a train step: the reference of both fp32 routes."""
    import torch

    from wekws_tpu_torch.losses import criterion
    from wekws_tpu_torch.models import init_model

    model = init_model(conf)
    model.load_state_dict(state_dict)
    model = model.to(feats.device, torch.float64).train()
    logits, _ = model(feats.to(torch.float64), lengths=feat_lengths)
    loss, _ = criterion(
        "max_pooling", logits,
        torch.as_tensor(batch["target"], device=feats.device),
        feat_lengths,
        torch.as_tensor(batch["target_lengths"], device=feats.device), 5)
    loss.backward()
    return model


def grad_groups(model):
    """{group: {parameter name: parameter}}: one group per TCNBlock,
    whose twelve gradients share one scale as a pass's sums do, and one
    group for each other parameter tensor."""
    from wekws_tpu_torch.models.mdtc import TCNBlock

    groups, grouped = {}, set()
    for name, mod in model.named_modules():
        if isinstance(mod, TCNBlock):
            groups[name] = dict(mod.named_parameters())
            grouped.update(id(p) for p in groups[name].values())
    for name, prm in model.named_parameters():
        if id(prm) not in grouped:
            groups[name] = {"": prm}
    return groups


def group_share(model, got, want, tol, what):
    """Gradient dicts ({parameter name of ``model``: tensor}): ``got``
    against ``want``, each group of ``grad_groups`` (a TCNBlock, or
    another tensor) within ``tol`` x the group's own largest |grad| (a
    small absolute floor for a group near zero), so that a wrong block
    cannot hide under the head's gradients.  Returns the worst (share of
    that scale, group, parameter), the mean of the groups' worst shares,
    which moves less with where rounding lands, and the least (cosine,
    group, parameter) of a settled parameter's gradient with its
    reference: one whose reference reaches SETTLED_SHARE of its group's
    scale (the biases that a BatchNorm follows are sums that cancel to
    rounding, and are left out).  A dropped or swapped gradient reads
    a cosine near 0."""
    from wekws_tpu_torch.ops.fused_mdtc_train import compare_sums

    names = {id(p): n for n, p in model.named_parameters()}
    worst, shares, cos = (0.0, "", ""), [], (1.0, "", "")
    for gname, members in grad_groups(model).items():
        keys = {local: names[id(p)] for local, p in members.items()}
        gots = [got[key].float() for key in keys.values()]
        wants = [want[key].float() for key in keys.values()]
        compare_sums(f"step-0 grads {what} {gname}", gots, wants,
                     floor=1e-6, tol=tol)
        scale = max([float(w.abs().max()) for w in wants] + [1e-6])
        shares.append(0.0)
        for local, g, w in zip(keys, gots, wants):
            share = float((g - w).abs().max()) / scale
            shares[-1] = max(shares[-1], share)
            if share > worst[0]:
                worst = (share, gname, local)
            if float(w.abs().max()) >= SETTLED_SHARE * scale:
                c = float((g * w).sum()) / max(
                    float(g.norm() * w.norm()), 1e-30)
                if c < cos[0]:
                    cos = (c, gname, local)
    return worst, sum(shares) / len(shares), cos


def worst_grad_share(model, ref, route):
    """``group_share`` of ``model``'s gradients against float64 (``ref``:
    the groups of ``float64_grads``) within GRAD64_TOL."""
    got = {n: p.grad for n, p in model.named_parameters()}
    want = {f"{g}.{local}" if local else g: p.grad
            for g, members in ref.items() for local, p in members.items()}
    return group_share(model, got, want, GRAD64_TOL, f"{route} vs float64")


def share_text(found):
    (share, group, param), mean, (cos, cgroup, cparam) = found
    return (f"{share:.2e} ({group}{'.' + param if param else ''}; mean "
            f"{mean:.2e}; least cosine {cos:.4f} at "
            f"{cgroup}{'.' + cparam if cparam else ''})")


def train_batch(rng):
    """TRAIN_B utterances of TRAIN_SECONDS: keyword rows carry a 500 Hz
    tone in noise, fillers noise (as __graft_entry__'s dry run)."""
    n = TRAIN_SECONDS * RATE
    t = np.arange(n) / RATE
    waves = (rng.standard_normal((TRAIN_B, n)) * 300).astype(np.float32)
    waves[::2] += (4000 * np.sin(2 * np.pi * 500 * t)).astype(np.float32)
    waves = np.clip(waves, -32768, 32767)
    return {"waves": waves,
            "wave_lengths": np.full((TRAIN_B,), n, np.int32),
            "target": (np.arange(TRAIN_B) % 2 - 1).astype(np.int32),
            "target_lengths": np.ones((TRAIN_B,), np.int32)}


def flagship_train_conf(dev):
    """The training slice's batch (B=512 x 2 s from SEED), its cv
    pipeline and features, and the flagship's model config with CMVN
    from those features and ``fused_train``: (conf, batch, cv pipeline,
    features, feature lengths)."""
    import torch

    from wekws_tpu_torch.data import DeviceFeaturePipeline

    cvp = DeviceFeaturePipeline.from_conf(TRAIN_DATASET_CONF, training=False)
    batch = train_batch(np.random.default_rng(SEED))
    waves = torch.as_tensor(batch["waves"], device=dev)
    lengths = torch.as_tensor(batch["wave_lengths"], device=dev)
    with torch.no_grad():
        feats, feat_lengths = cvp(waves, lengths)
    mean = feats.mean(dim=(0, 1)).cpu().numpy()
    istd = (1.0 / (feats.std(dim=(0, 1)) + 1e-6)).cpu().numpy()
    conf = dict(FLAGSHIP_MODEL_CONF,
                cmvn={"mean": mean.tolist(), "istd": istd.tolist(),
                      "norm_var": True})
    conf["backbone"] = dict(conf["backbone"], fused_train=True)
    return conf, batch, cvp, feats, feat_lengths


def phase7_train_slice(dev, work, launches):
    """Train -> checkpoint -> serve at B=512 x 2 s; returns what the
    later phases reuse (trainer, state, batch, model config)."""
    import torch

    from wekws_tpu_torch.data import DeviceFeaturePipeline
    from wekws_tpu_torch.models import init_model
    from wekws_tpu_torch.ops.fused_mdtc_train import (
        PASSES,
        plain_passes,
        reset_launches,
    )
    from wekws_tpu_torch.ops.serving import build_fused_forward
    from wekws_tpu_torch.train import (
        Trainer,
        average_checkpoints,
        load_checkpoint,
        save_checkpoint,
    )

    plain_conf = dict(TRAIN_DATASET_CONF, spec_aug=False)
    plain_conf["fbank_conf"] = dict(TRAIN_DATASET_CONF["fbank_conf"],
                                    dither=0.0)
    conf, batch, cvp, feats, feat_lengths = flagship_train_conf(dev)
    unfused_conf = dict(conf, backbone=dict(conf["backbone"],
                                            fused_train=False))

    def trainer_for(model_conf, dataset_conf, state_dict=None):
        model = init_model(model_conf, torch.Generator().manual_seed(SEED))
        if state_dict is not None:
            model.load_state_dict(state_dict)
        else:
            # the four stacks' ReLU outputs are summed (|y| up to ~50 at
            # init), so a head drawn at N(0, 1/64) saturates the sigmoid,
            # where the clamped max-pooling loss has no gradient: start
            # the head small
            with torch.no_grad():
                model.classifier.linear.weight.mul_(0.01)
        return Trainer(model, DeviceFeaturePipeline.from_conf(dataset_conf),
                       cvp, "max_pooling", grad_clip=5.0, min_duration=5,
                       device=dev)

    trainer = trainer_for(conf, plain_conf)
    state = trainer.init_state()
    twin = trainer_for(unfused_conf, plain_conf,
                       trainer.model.state_dict())
    twin_state = twin.init_state()
    n_params = sum(p.numel() for p in trainer.model.parameters())
    print(f"  flagship + fused_train: {n_params} parameters, batch "
          f"{TRAIN_B} x {TRAIN_SECONDS} s, features {tuple(feats.shape)}",
          flush=True)

    reset_launches()
    losses = []
    for step in range(TRAIN_STEPS_PLAIN):
        if step == 0:
            want_loss, _ = twin.loss_and_grads(twin_state, batch, SEED)
        state, metrics = trainer.train_step(state, batch, SEED, 1e-3)
        losses.append(float(metrics["loss"]))
        if step == 0:
            # p.grad still holds step 0's gradients after the update
            err = abs(losses[0] - float(want_loss))
            if err > 1e-5 * abs(float(want_loss)):
                raise AssertionError(f"step-0 loss {losses[0]} vs unfused "
                                     f"{float(want_loss)}")
            # both fp32 routes against float64
            with torch.no_grad():
                f0, l0 = twin.pipeline(
                    torch.as_tensor(batch["waves"], device=dev),
                    torch.as_tensor(batch["wave_lengths"], device=dev))
            ref = grad_groups(float64_grads(
                unfused_conf, twin.model.state_dict(), f0, l0, batch))
            share = {route: worst_grad_share(tr.model, ref, route)
                     for route, tr in (("fused", trainer),
                                       ("unfused", twin))}
            print(f"  step 0 vs the unfused Trainer: loss {losses[0]:.6f} "
                  f"(diff {err:.2e}); gradients vs float64, 17 blocks and "
                  f"4 other tensors each within {GRAD64_TOL} x its own "
                  f"largest |grad|: worst fused "
                  f"{share_text(share['fused'])}, unfused "
                  f"{share_text(share['unfused'])} of that", flush=True)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"loss not finite and decreasing: {losses}")
    # the flagship recipe's augmentation from here on
    trainer.pipeline = DeviceFeaturePipeline.from_conf(TRAIN_DATASET_CONF)
    aug_losses = []
    for _ in range(TRAIN_STEPS_AUG):
        state, metrics = trainer.train_step(state, batch, SEED, 1e-3)
        aug_losses.append(float(metrics["loss"]))
    torch.cuda.synchronize()
    steps = TRAIN_STEPS_PLAIN + TRAIN_STEPS_AUG
    n_blocks = 1 + 4 * 4
    for name in TRAIN_PASSES:
        launches[f"fused_train_{name}"] = PASSES[name].launches
        if PASSES[name].launches != n_blocks * steps:
            raise AssertionError(
                f"pass {name} launched {PASSES[name].launches} times, "
                f"expected {n_blocks} x {steps}")
    if not all(np.isfinite(aug_losses)):
        raise AssertionError(f"augmented steps: {aug_losses}")
    print(f"  losses, no augmentation: {[round(v, 5) for v in losses]}; "
          f"with dither + spec_aug: {[round(v, 5) for v in aug_losses]}; "
          f"each pass launched {n_blocks} x {steps} = {n_blocks * steps} "
          f"times", flush=True)

    # step 0's fused gradients again, from the same weights, with one
    # pass at a time run by its plain version (then all eight): a swap
    # that moves the worst share to the unfused route's names the pass
    # whose summation order is to blame
    probe = trainer_for(conf, plain_conf, twin.model.state_dict())
    probe_state = probe.init_state()
    found = {}
    for swap in (("none",) + TRAIN_PASSES + ("all",)):
        names = {"none": (), "all": TRAIN_PASSES}.get(swap, (swap,))
        with plain_passes(*names):
            probe.loss_and_grads(probe_state, batch, SEED)
        found[swap] = worst_grad_share(probe.model, ref, f"fused, {swap} "
                                       f"plain")
    print("  bisection, step-0 fused gradients vs float64 with one pass by "
          "its plain version: "
          + "; ".join(f"{k} {share_text(v)}" for k, v in found.items()),
          flush=True)

    cv = trainer.cv_step(state, batch)
    cv_loss = float(cv["loss_sum"]) / max(float(cv["count"]), 1.0)
    if not np.isfinite(cv_loss) or int(cv["count"]) != TRAIN_B:
        raise AssertionError(f"cv step: {cv}")
    for epoch in range(2):
        save_checkpoint(os.path.join(work, f"{epoch}.pt"),
                        state.model.state_dict(),
                        {"epoch": epoch, "lr": 1e-3,
                         "cv_loss": cv_loss + epoch})
        if epoch == 0:
            state, _ = trainer.train_step(state, batch, SEED, 1e-3)
    picked = average_checkpoints(work, os.path.join(work, "avg.pt"), 2)
    served = init_model(conf)
    served.load_state_dict(load_checkpoint(os.path.join(work, "avg.pt")))
    served = served.to(dev).eval()
    forward = build_fused_forward(served, device=dev)
    sub = slice(0, N_UTTS)
    probs = forward(feats[sub], feat_lengths[sub])
    with torch.inference_mode():
        module_probs, _ = served(feats[sub], lengths=feat_lengths[sub])
    check_close("trained + averaged model: fused serving vs module forward",
                probs, module_probs)
    print(f"  cv loss {cv_loss:.5f} over {int(cv['count'])} utterances; "
          f"averaged {len(picked)} checkpoints and served {N_UTTS} "
          f"utterances through build_fused_forward", flush=True)
    return trainer, state, batch, conf


def phase8_train_times(trainer, state, batch, card, launches, errs,
                       calls):
    """Per-pass and whole-step times at B=512 x T=198; ``calls`` holds
    each pass's inputs at that shape (dilation 8)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from wekws_tpu_torch.ops.fused_mdtc_train import (
        PASS_IDS,
        PASSES,
        kernel_name,
    )

    # the whole train step (host clock around synchronised steps)
    for _ in range(2):
        trainer.train_step(state, batch, SEED, 1e-3)
    torch.cuda.synchronize()
    reps = 10
    t0 = time.perf_counter()
    for _ in range(reps):
        trainer.train_step(state, batch, SEED, 1e-3)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / reps * 1e3
    audio = TRAIN_B * TRAIN_SECONDS
    print(f"  train step B={TRAIN_B} x {TRAIN_SECONDS} s (fused_train, "
          f"dither + spec_aug): {step_ms:.3f} ms, "
          f"{audio / step_ms * 1e3:.1f} audio-s/s [{card}]", flush=True)

    # device time of each pass inside a profiled train step, and that
    # step's own wall clock (the trace opens with a spin kernel, left out
    # of the readings, as profiled_step's); the untraced median beside it
    untraced_ms = timed_steps(
        lambda: trainer.train_step(state, batch, SEED, 1e-3))[0]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(state, batch, SEED, 1e-3)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    on_device = {}  # device entries (kernels, copies, fills): total us
    for evt in prof.key_averages():
        total = getattr(evt, "device_time_total",
                        getattr(evt, "cuda_time_total", 0.0))
        if "spin_kernel" in evt.key:
            continue
        if evt.count and total and str(getattr(evt, "device_type", "")) \
                .endswith("CUDA"):
            on_device[evt.key] = total
        kernels[evt.key] = (total, evt.count)
    busy = sum(on_device.values())

    def dev_ms(fragment):
        for key, (total, count) in kernels.items():
            if fragment in key and count:
                return total / count / 1e3
        return None

    if any("dx_kernel" in key for key in kernels):
        raise AssertionError("a dx_kernel ran in the profiled step: B4 is "
                             "one kernel and its reduction")
    pass_kernel = {name: kernel_name(name, 64) for name in TRAIN_PASSES}
    ours = list(pass_kernel.values()) + ["reduce_kernel"]
    kernel_total = sum(t for key, (t, _) in kernels.items()
                       if any(f in key for f in ours)) / 1e3
    print(f"  profiled step: {kernel_total:.3f} ms of device time in the "
          f"training kernels [{card}]", flush=True)
    idle_share("the profiled train step",
               {"busy_ms": busy / 1e3, "wall_ms": traced_ms,
                "entries": sum(c for key, (_, c) in kernels.items()
                               if key in on_device),
                "untraced_ms": untraced_ms}, card, where="in this process")
    rest = sorted(((t, key) for key, t in on_device.items()
                   if not any(f in key for f in ours)), reverse=True)
    print("  the rest of the device time, largest first: "
          + "; ".join(f"{key[:70]} {t / 1e3:.3f} ms" for t, key in rest[:6])
          + f" [{card}]", flush=True)

    record = []
    device_ms = {}
    b, t, c, k, d = TRAIN_B, 198, 64, 5, 8
    for name in TRAIN_PASSES:
        args = calls[name]
        kern = lambda: PASSES[name](*args)  # noqa: E731
        plain = lambda: PASSES[name].plain(*args)  # noqa: E731
        ms, plain_ms = kernel_vs_plain_ms(kern, plain)
        torch.cuda.synchronize()
        host = []
        for _ in range(30):  # the wrapper's host work: enqueue, no sync
            t0 = time.perf_counter()
            kern()
            host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        host_ms = float(np.median(host))
        bound, bound_by = train_pass_bound_ms(name, b, t, c, k)
        main = dev_ms(pass_kernel[name])
        reduce_ms = None
        if name != "f4":  # its own block reduction
            reduce_ms = dev_ms(f"reduce_kernel<{PASS_IDS[name]}>")
        if main is None or (name != "f4" and reduce_ms is None):
            raise AssertionError(
                f"pass {name}: no kernel {pass_kernel[name]} (or its "
                f"reduction) in the profiled train step")
        device_ms[name] = main + (reduce_ms or 0.0)
        dev_txt = f"{device_ms[name]:.4f} ms"
        if reduce_ms is not None:
            dev_txt += f", of it {reduce_ms:.4f} ms its reduction"
        print(f"  fused_train_{name} B={b} T={t} d={d}: kernel {ms:.4f} ms "
              f"per call (device time per call in the train step "
              f"{dev_txt}; host enqueue {host_ms:.4f} ms), plain "
              f"{plain_ms:.4f} ms, bound {bound:.5f} ms "
              f"({bound_by}), {launches[f'fused_train_{name}']} launches on "
              f"the main path (17 per step); library: none (no PyTorch "
              f"call computes "
              f"this pass) [{card}]", flush=True)
        record.append({
            "name": f"fused_train_{name}", "route": "cuda",
            "source": "wekws_tpu_torch/csrc/fused_mdtc_train.cu",
            "replaces": TRAIN_REPLACES[name],
            "launches": launches[f"fused_train_{name}"],
            "max_abs_err": errs[name],
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by,
            "library_ms": None,
        })
    print(f"  per block, with their reductions: F2 + B1 "
          f"{device_ms['f2'] + device_ms['b1']:.4f} ms, F3 + B2 "
          f"{device_ms['f3'] + device_ms['b2']:.4f} ms, B3 + B4 "
          f"{device_ms['b3'] + device_ms['b4']:.4f} ms of device time; all "
          f"eight passes {sum(device_ms.values()):.4f} ms [{card}]",
          flush=True)
    return record, step_ms


def tcn_bound_ms(b, t, c, n_layers, k, pad_max):
    """Least time on an H100 for one fused DS-TCN call.  Per frame and
    layer: 2KC (depthwise) + 2C^2 (the product) + 5C (two biases, two
    ReLUs, residual).  Bytes: x read, out written, folded weights once,
    the (L, B, pad_max, C) cache read and written."""
    flops = b * t * n_layers * (2 * k * c + 2 * c * c + 5 * c)
    nbytes = 4 * (2 * b * t * c + n_layers * (k * c + c * c + 2 * c)
                  + 2 * n_layers * b * pad_max * c)
    return roofline_ms(flops, nbytes)


def fsmn_bound_ms(b, t, ld, pd, n_layers, lorder, rorder, pad):
    """Least time on an H100 for one fused FSMN layer-chain call.  Per
    frame and layer: 4 LD PD (two products) + 2 (lorder + rorder) PD + PD
    (taps, identity) + 2 LD (bias, ReLU).  Bytes: x, out, the weights
    once, the (L, B, P, PD) cache read and written."""
    flops = b * t * n_layers * (4 * ld * pd + 2 * (lorder + rorder) * pd
                                + pd + 2 * ld)
    nbytes = 4 * (2 * b * t * ld
                  + n_layers * (2 * ld * pd + (lorder + max(rorder, 1)) * pd
                                + ld)
                  + 2 * n_layers * b * pad * pd)
    return roofline_ms(flops, nbytes)


def fbank_bound_ms(b, s, frame_length, frame_shift, n_fft, n_band, n_mel,
                   n_out, mfcc=None):
    """Least time on an H100 for one fused fbank call, counting the work
    the function needs by the FFT route: per frame the pre-chain 4 FL
    (the mean, the preemphasis's multiply-add, the window), a real FFT
    of n_fft points 2.5 n log2 n, the power 3 nbin, mel over the
    filters' nonzero bins 2 n_band (this bank's), the log M and for MFCC
    the DCT 2 M C.  Bytes: the wave read once, the features written
    once, the operators once (window, twiddles, packed mel weights,
    DCT).  The FFT plan's 16 low bins by the folded operator (4 FL 16
    flops a frame more) are its design's cost and stay out.  ``mfcc``
    (default: ``n_out != n_mel``) says whether the DCT runs."""
    rows = b * (1 + (s - frame_length) // frame_shift)
    nbin = n_fft // 2 + 1
    if mfcc is None:
        mfcc = n_out != n_mel
    dct = 2 * n_mel * n_out if mfcc else 0
    flops = rows * (4 * frame_length + 2.5 * n_fft * math.log2(n_fft)
                    + 3 * nbin + 2 * n_band + n_mel + dct)
    nbytes = 4 * (b * s + rows * n_out + frame_length + 2 * n_fft
                  + n_band + dct // 2)
    return roofline_ms(flops, nbytes)


def fbank_dense_bound_ms(b, s, frame_length, frame_shift, nbin, n_mel, n_out):
    """The same for the work the dense plan (and the TPU kernel) does:
    the two DFT products 2 x FL x 2 nbin a frame, power 3 nbin, mel over
    every bin 2 nbin M, log M, DCT 2 M C; bytes as above with the folded
    operator and the dense bank."""
    rows = b * (1 + (s - frame_length) // frame_shift)
    dct = 2 * n_mel * n_out if n_out != n_mel else 0
    flops = rows * (4 * frame_length * nbin + 3 * nbin + 2 * nbin * n_mel
                    + n_mel + dct)
    nbytes = 4 * (b * s + rows * n_out + 2 * frame_length * nbin
                  + nbin * n_mel + dct // 2)
    return roofline_ms(flops, nbytes)


def roofline_ms(flops, nbytes):
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


# phase 9's fbank cases: (name, FrontendConfig keywords, batch)
FBANK_CASES = (
    ("(512, 32000) fbank M=40", {"num_mel_bins": 40}, TRAIN_B),
    ("(64, 32000) fbank M=80", {"num_mel_bins": 80}, 64),
    ("(64, 32000) MFCC 13 of 40",
     {"feature_type": "mfcc", "num_mel_bins": 40, "num_ceps": 13}, 64),
    ("(64, 32000) magnitude, no log",
     {"num_mel_bins": 40, "use_power": False, "use_log_fbank": False}, 64),
    ("(64, 32000) hamming window", {"window_type": "hamming"}, 64),
    ("(64, 32000) no preemphasis", {"preemphasis": 0.0}, 64),
    ("(64, 32000) no DC removal", {"remove_dc_offset": False}, 64),
    ("(64, 32000) odd frame of 401", {"frame_length_ms": 25.0625}, 64),
    ("(64, 32000) round_to_power_of_two false",
     {"round_to_power_of_two": False}, 64),
)

def fbank_call(fe, waves, plan, seed=None):
    """``fused_fbank`` with ``fe``'s operands through ``plan``: "fft"
    with the FFT plan's operands (the plan ``fbank_plan`` then picks),
    "dense" with the folded operator alone; frame dither 1.0 from
    ``seed`` when given."""
    from wekws_tpu_torch.frontend.kaldi import EPSILON
    from wekws_tpu_torch.ops.fused_frontend import fused_fbank

    cfg = fe.cfg
    mats = fe._mats(waves.device)
    return fused_fbank(
        waves, mats["analysis"], mats["mel_t"], mats.get("dct"),
        frame_length=cfg.frame_length, frame_shift=cfg.frame_shift,
        dither=1.0 if seed is not None else 0.0, seed=seed,
        use_power=cfg.use_power, use_log=cfg.use_log_fbank, epsilon=EPSILON,
        **(fe.fft_operands(mats) if plan == "fft" else {}))


def chained(step, x, cache, chunk):
    """``step(x_chunk, cache) -> (y, cache)`` over time chunks."""
    import torch

    outs = []
    for s in range(0, x.shape[1], chunk):
        y, cache = step(x[:, s:s + chunk].contiguous(), cache)
        outs.append(y)
    return torch.cat(outs, dim=1), cache


def phase9_new_kernels(dev, gen, batch):
    """The three later kernels against their plain versions at full
    width.  Returns the largest error per kernel and what phase 13
    times: weights and the fbank extractors."""
    import torch

    from wekws_tpu_torch.frontend.features import FeatureExtractor
    from wekws_tpu_torch.frontend.kaldi import FrontendConfig
    from wekws_tpu_torch.ops.fused_frontend import fbank_plan
    from wekws_tpu_torch.ops.fused_fsmn import (
        extract_fsmn_weights,
        fused_fsmn_layers,
        fused_fsmn_layers_plain,
        init_fsmn_cache,
    )
    from wekws_tpu_torch.ops.fused_tcn import (
        extract_ds_tcn_weights,
        fused_ds_tcn,
        fused_ds_tcn_plain,
        init_tcn_cache,
    )

    errs = {"fused_ds_tcn": 0.0, "fused_fsmn_layers": 0.0,
            "fused_fbank": 0.0}

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(dev)

    def hold(kernel, name, pairs, quiet=False):
        for what, got, want in pairs:
            errs[kernel] = max(errs[kernel],
                               check_close(f"{name} {what}", got, want,
                                           quiet=quiet))

    # ---- fused_ds_tcn at every recipe width: the hey_snips model's
    # folded weights at 64, seeded weights at the others; each shape from
    # a random cache with the plan the wrapper chose, launched twice
    # (bitwise equal), output and new cache against the plain version
    tcn = seeded_model(DS_TCN_MODEL_CONF, gen)[0].backbone
    *stacks, dil = extract_ds_tcn_weights(tcn)
    k, n_layers = tcn.kernel_size, len(dil)
    pad_max = (k - 1) * max(dil)
    tcn_w = {c: (tuple(w.to(dev) for w in stacks) if c == tcn.channel
                 else tuple(w.to(dev) for w in ds_tcn_weights(
                     c, n_layers, k, gen)))
             for c in DS_TCN_WIDTHS}

    def hold_tcn(b, t, c, w, dl):
        pad = (k - 1) * max(dl)
        x, cache = randn(b, t, c), randn(len(dl), b, pad, c)
        got = fused_ds_tcn(x, cache, *w, dl, k)
        again = fused_ds_tcn(x, cache, *w, dl, k)
        torch.cuda.synchronize()
        want = fused_ds_tcn_plain(x, cache, *w, dl, k)
        what = f"B={b} T={t} C={c}"
        if pad != pad_max:
            what += f", {len(dl)} layers, pad_max={pad}"
        plan = mdtc_plan_text(b, t, c, k, pad, "ds_tcn")
        quiet = (b, t) not in ((N_UTTS, 8), (N_UTTS, 198)) and pad == pad_max
        hold("fused_ds_tcn", f"fused_ds_tcn {what} ({plan})",
             (("output", got[0], want[0]), ("new cache", got[1], want[1])),
             quiet)
        if not (torch.equal(got[0], again[0])
                and torch.equal(got[1], again[1])):
            raise AssertionError(f"fused_ds_tcn {what}: two launches differ")

    for c in DS_TCN_WIDTHS:
        for b, t in DS_TCN_CASES:
            hold_tcn(b, t, c, tcn_w[c], dil)
        long_w = tuple(w.to(dev) for w in ds_tcn_weights(
            c, len(DS_TCN_LONG_DILATIONS), k, gen))
        hold_tcn(1, 2048, c, long_w, DS_TCN_LONG_DILATIONS)
    print(f"  fused_ds_tcn: {len(DS_TCN_CASES)} shapes (T = 1 to 2048, B = 1 "
          f"to 64) at C = {', '.join(map(str, DS_TCN_WIDTHS))}, and 8 layers "
          f"over 2048 frames at each: bitwise equal from launch to launch",
          flush=True)
    tw = tcn_w[tcn.channel]
    c = tcn.channel
    x = randn(16, 200, c)
    zero = init_tcn_cache(n_layers, 16, pad_max, c, dev)
    got = chained(lambda xc, cc: fused_ds_tcn(xc, cc, *tw, dil, k), x, zero,
                  8)
    want = chained(lambda xc, cc: fused_ds_tcn_plain(xc, cc, *tw, dil, k), x,
                   zero, 8)
    once = fused_ds_tcn(x, zero, *tw, dil, k)
    torch.cuda.synchronize()
    hold("fused_ds_tcn", "fused_ds_tcn B=16, 25 chunks of 8",
         (("vs one-shot (kernel)", got[0], once[0]),
          ("final cache vs one-shot", got[1], once[1]),
          ("vs plain chain", got[0], want[0]),
          ("final cache vs plain", got[1], want[1])))

    # ---- fused_fsmn_layers at the hi_xiaowen width (paths B and D's
    # training) and at the synthetic CTC recipe's (path D's scoring and
    # streaming): the offline batches, long utterances, and one stream's
    # chunks: one frame, the engine's 10, and 11 (= P at hi_xiaowen: the
    # new cache all new frames); then one stream in chunks of 10
    fsmn_bench = {}
    for tag, conf, cases in (
            ("hi_xiaowen", FSMN_MODEL_CONF,
             ((16, 66), (4, 1024), (1, 1), (1, 10), (1, 11))),
            ("synthetic_ctc", ctc_recipe_model_conf(),
             ((256, 66), (1, 1), (1, 10), (1, 11)))):
        fsmn = seeded_model(conf, gen)[0].backbone
        fw = tuple(w.to(dev) for w in extract_fsmn_weights(fsmn)[4:9])
        orders = (fsmn.lorder, fsmn.rorder, fsmn.lstride, fsmn.rstride)
        ld, pd, pad = fsmn.linear_dim, fsmn.proj_dim, fsmn.layer_padding
        n_fsmn = fsmn.fsmn_layers
        width = f"{tag} {n_fsmn} x {ld}/{pd}, orders {fsmn.lorder}/" \
                f"{fsmn.rorder}, P={pad}"
        for b, t in cases:
            # the chain's input is a ReLU output: non-negative
            x, cache = randn(b, t, ld).relu(), randn(n_fsmn, b, pad, pd)
            got = fused_fsmn_layers(x, cache, *fw, *orders)
            torch.cuda.synchronize()
            want = fused_fsmn_layers_plain(x, cache, *fw, *orders)
            hold("fused_fsmn_layers", f"fused_fsmn_layers {width} B={b} "
                 f"T={t}", (("output", got[0], want[0]),
                            ("new cache", got[1], want[1])))
        x = randn(1, 200, ld).relu()
        zero = init_fsmn_cache(n_fsmn, 1, pad, pd, dev)
        got = chained(lambda xc, cc: fused_fsmn_layers(xc, cc, *fw, *orders),
                      x, zero, 10)
        want = chained(
            lambda xc, cc: fused_fsmn_layers_plain(xc, cc, *fw, *orders), x,
            zero, 10)
        once = fused_fsmn_layers(x, zero, *fw, *orders)
        torch.cuda.synchronize()
        hold("fused_fsmn_layers", f"fused_fsmn_layers {width} B=1, 20 "
             f"chunks of 10", (("vs one-shot (kernel)", got[0], once[0]),
                               ("final cache vs one-shot", got[1], once[1]),
                               ("vs plain chain", got[0], want[0]),
                               ("final cache vs plain", got[1], want[1])))
        fsmn_bench[tag] = (fw, orders, ld, pd, n_fsmn, pad)

    # ---- fused_fbank against the unfused three-matmul extractor, through
    # both plans: the FFT plan (what a power-of-two n_fft runs) and the
    # dense-DFT plan (what any other size runs), launched directly
    waves = torch.as_tensor(batch["waves"], device=dev)
    extractors = {}
    for name, kw, b in FBANK_CASES:
        cfg = FrontendConfig(dither=1.0, dither_mode="frame", **kw)
        fused = FeatureExtractor(cfg, use_fused=True)
        plain = FeatureExtractor(cfg)
        want, _ = plain(waves[:b])
        if cfg.use_log_fbank:
            atol, rtol = FBANK_ATOL, FBANK_RTOL
        else:  # energies up to ~1e6: relative to the largest
            atol, rtol = 1e-4 * float(want.abs().max()), 1e-4
        for plan in ("fft", "dense"):
            if plan == "fft" and fbank_plan(cfg.padded_window_size) != "fft":
                continue
            got = fbank_call(fused, waves[:b], plan)
            again = fbank_call(fused, waves[:b], plan)
            torch.cuda.synchronize()
            err = check_close(f"fused_fbank {name}, {plan} plan (n_fft "
                              f"{cfg.padded_window_size})", got, want,
                              atol=atol, rtol=rtol)
            if not torch.equal(got, again):
                raise AssertionError(f"fused_fbank {name} {plan}: two "
                                     f"launches differ")
            if cfg.use_log_fbank:
                errs["fused_fbank"] = max(errs["fused_fbank"], err)
        extractors[name] = (fused, plain)
    # one seed, the same noise in both plans (Philox by position): the
    # FFT plan against the dense one with dither on, at the main shape and
    # an odd frame (401 samples, quads across frames)
    for name in ("(512, 32000) fbank M=40", "(64, 32000) odd frame of 401"):
        fused = extractors[name][0]
        b = TRAIN_B if name.startswith("(512") else 64
        seed = torch.tensor([20261017], dtype=torch.int64, device=dev)
        got = fbank_call(fused, waves[:b], "fft", seed)
        want = fbank_call(fused, waves[:b], "dense", seed)
        again = fbank_call(fused, waves[:b], "fft", seed)
        torch.cuda.synchronize()
        check_close(f"fused_fbank {name} with dither 1.0, one seed: FFT plan "
                    f"vs dense plan", got, want, atol=FBANK_ATOL,
                    rtol=FBANK_RTOL)
        if not torch.equal(got, again):
            raise AssertionError(f"fused_fbank {name}: dithered launches "
                                 f"differ")

    # in-kernel dither against torch.randn: distributions, not bits
    fused, plain = extractors["(512, 32000) fbank M=40"]
    gd = torch.Generator(device=dev)
    for what, w in (("zero waves", torch.zeros_like(waves)),
                    ("synthetic waves", waves)):
        outs = []
        for seed in (1, 1, 2):
            gd.manual_seed(seed)
            outs.append(fused(w, generator=gd)[0])
        gd.manual_seed(1)
        ref = plain(w, generator=gd)[0]
        torch.cuda.synchronize()
        if not torch.equal(outs[0], outs[1]) or torch.equal(outs[0], outs[2]):
            raise AssertionError(f"dither on {what}: the same seed must give "
                                 f"the same bits, another seed others")
        if not torch.isfinite(outs[0]).all():
            raise AssertionError(f"dither on {what}: non-finite features")
        n = outs[0].shape[0] * outs[0].shape[1]
        dmean = float((outs[0].mean((0, 1)) - ref.mean((0, 1))).abs().max())
        dstd = float((outs[0].std((0, 1)) / ref.std((0, 1)) - 1).abs().max())
        print(f"  fused_fbank frame-mode dither 1.0 on {what}, {n} frames: "
              f"per-bin mean of the log-mel within {dmean:.4f} of the plain "
              f"version's (torch.randn; bound {DITHER_MEAN_TOL}), standard "
              f"deviation within {dstd:.2%} (bound {DITHER_STD_RTOL:.0%}; "
              f"about {float(ref.std((0, 1)).mean()):.3f}); same seed "
              f"bitwise equal, another seed differs", flush=True)
        if dmean > DITHER_MEAN_TOL or dstd > DITHER_STD_RTOL:
            raise AssertionError(f"dither on {what}: distribution differs")
    # the noise is keyed by the position in the call: two calls on the
    # halves of a batch repeat the first half's noise in the second
    gd.manual_seed(1)
    seed_half = fused(waves[:TRAIN_B // 2], generator=gd)[0]
    if not torch.equal(seed_half, outs[0][:TRAIN_B // 2]):
        raise AssertionError("dither: the first half of a batch must not "
                             "depend on the batch size")
    bench = {"tcn": ({c: tcn_w[c] for c in (tcn.channel, 256)}, dil, k,
                     n_layers, pad_max),
             "fsmn": fsmn_bench,
             "fbank": (fused, plain, waves)}
    return errs, bench


def stream_engine(spot, pcms, chunk_bytes):
    """Every utterance (int16 PCM bytes) through ``spot`` in chunks of
    ``chunk_bytes``, the state reset between utterances -> posteriors per
    utterance, results, chunks that carried frames, seconds inside
    forward()."""
    import torch

    probs, results, carried, spent = [], [], 0, 0.0
    orig = spot._apply_step

    def capture(feats, cache):
        out, c = orig(feats, cache)
        probs[-1].append(out)
        return out, c

    spot._apply_step = capture
    try:
        for pcm in pcms:
            spot.reset_all()
            probs.append([])
            for off in range(0, len(pcm), chunk_bytes):
                t0 = time.perf_counter()
                results.append(spot.forward(pcm[off:off + chunk_bytes]))
                spent += time.perf_counter() - t0
            carried += len(probs[-1])
    finally:
        spot._apply_step = orig
    return ([torch.cat(p, dim=1)[0] for p in probs], results, carried,
            spent)


def phase11_fsmn_ctc(dev, gen, work, waves, launches):
    """Path B: the hi_xiaowen FSMN-CTC model through the single-stream
    engine.  Returns the mean ``forward()`` time per 300 ms chunk of the
    fused engine."""
    import torch
    import yaml

    from wekws_tpu_torch.data import DeviceFeaturePipeline
    from wekws_tpu_torch.ops.fused_fsmn import fused_fsmn_layers
    from wekws_tpu_torch.ops.serving import build_fused_forward
    from wekws_tpu_torch.runtime import KeyWordSpotter

    model, model_conf = seeded_model(FSMN_MODEL_CONF, gen)
    configs = {"dataset_conf": FSMN_DATASET_CONF, "model": model_conf}
    ckpt = os.path.join(work, "fsmn_ctc.pt")
    config_path = os.path.join(work, "fsmn_ctc.yaml")
    token_path = os.path.join(work, "tokens.txt")
    lexicon_path = os.path.join(work, "lexicon.txt")
    torch.save(model.state_dict(), ckpt)
    with open(config_path, "w") as f:
        yaml.safe_dump(configs, f)
    with open(token_path, "w") as f:
        f.write("<blk> 0\n<filler> 1\n")
        f.writelines(f"t{i} {i}\n" for i in range(2, FSMN_VOCAB))
    with open(lexicon_path, "w") as f:
        f.write(CTC_KEYWORD + " "
                + " ".join(f"t{i}" for i in CTC_KEYWORD_TOKENS) + "\n")
    n_params = sum(p.numel() for p in model.parameters())

    def engine(use_fused):
        spot = KeyWordSpotter(ckpt, config_path, token_path, lexicon_path,
                              threshold=0.5, min_frames=1, use_fused=use_fused,
                              device=dev)
        spot.set_keywords(CTC_KEYWORD)
        if spot.keywords_token[CTC_KEYWORD]["token_id"] != CTC_KEYWORD_TOKENS:
            raise AssertionError(f"keyword tokens {spot.keywords_token}")
        return spot

    def stream(spot):
        return stream_engine(spot, [w.astype("<i2").tobytes() for w in waves],
                             2 * CHUNK_SAMPLES)

    fused, plain = engine(True), engine(False)
    stream(fused)  # warm-up: the library load and first launches
    fused_fsmn_layers.launches = 0
    got, got_results, carried, spent = stream(fused)
    torch.cuda.synchronize()
    launches["fused_fsmn_layers"] = fused_fsmn_layers.launches
    want, want_results, _, plain_spent = stream(plain)
    n_chunks = len(got_results)
    if launches["fused_fsmn_layers"] != carried or carried < 6 * len(waves):
        raise AssertionError(
            f"fused_fsmn_layers launched {launches['fused_fsmn_layers']} "
            f"times for {carried} chunks that carried frames")
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        # the streaming frontend may hold back the last frames
        if g.shape[1] != FSMN_VOCAB or not 60 <= g.shape[0] <= 66:
            raise AssertionError(f"utterance {i}: posteriors {tuple(g.shape)}")
        worst = max(worst, check_close(
            f"utterance {i} fused vs module posteriors", g, w, quiet=True))
    if got_results != want_results:
        raise AssertionError("fused and module engines' results differ")
    chunk_ms = spent / n_chunks * 1e3
    print(f"  FSMN-CTC: {n_params} parameters, {FSMN_VOCAB} tokens; "
          f"{len(waves)} utterances x {n_chunks // len(waves)} chunks of "
          f"300 ms: fused vs module softmax posteriors max_abs_err "
          f"{worst:.3e} (bound {TOL} abs + {TOL} rel), result dicts equal; "
          f"fused_fsmn_layers launches {carried} = chunks that carried "
          f"frames; mean forward() {chunk_ms:.3f} ms per chunk fused, "
          f"{plain_spent / n_chunks * 1e3:.3f} ms module (host clock, host "
          f"frontend and decoder included)", flush=True)

    # whole utterances through build_fused_forward(softmax=True)
    cvp = DeviceFeaturePipeline.from_conf(FSMN_DATASET_CONF, training=False)
    wav = torch.as_tensor(waves.astype(np.float32), device=dev)
    lens = torch.full((len(waves),), wav.shape[1], device=dev)
    with torch.no_grad():
        feats, feat_lengths = cvp(wav, lens)
    before = fused_fsmn_layers.launches
    probs = build_fused_forward(fused.model, softmax=True, device=dev)(
        feats, feat_lengths)
    with torch.inference_mode():
        module_probs, _ = fused.model(feats, lengths=feat_lengths,
                                      softmax=True)
    check_close(f"build_fused_forward(softmax=True) {tuple(probs.shape)} vs "
                f"module forward", probs, module_probs)
    if fused_fsmn_layers.launches != before + 1:
        raise AssertionError("the offline FSMN forward must launch once")
    launches["fused_fsmn_layers"] += 1
    launches["fsmn_offline"] = 1
    # streamed == offline (device features match the host frontend's)
    check_close("streamed utterance 0 vs offline posteriors", got[0],
                probs[0, :got[0].shape[0]], atol=1e-3, rtol=1e-3)

    # the detector fires on injected keyword posteriors (random weights
    # never do): tokens at pre-skip frames 30, 60 and 90
    if any(r.get("state") for r in got_results if r):
        raise AssertionError("random weights fired the detector")
    frames = dict(zip((30, 60, 90), CTC_KEYWORD_TOKENS))

    def inject(feats, cache):
        t = feats.shape[1]
        out = np.full((1, t, FSMN_VOCAB), 1e-5, np.float32)
        out[:, :, 0] = 0.9
        for i in range(t):
            tok = frames.get(int(fused._frame_indices[i]))
            if tok is not None:
                out[0, i, 0] = 0.05
                out[0, i, tok] = 0.9
        return out, cache

    fused.reset_all()
    fused._apply = inject
    pcm = waves[0].astype("<i2").tobytes()
    hits = []
    for off in range(0, len(pcm), 2 * CHUNK_SAMPLES):
        res = fused.forward(pcm[off:off + 2 * CHUNK_SAMPLES])
        if res and res.get("state") == 1:
            hits.append(res)
    if (len(hits) != 1 or hits[0]["keyword"] != CTC_KEYWORD
            or abs(hits[0]["start"] - 0.30) > 0.02
            or abs(hits[0]["end"] - 0.90) > 0.02):
        raise AssertionError(f"detector on injected posteriors: {hits}")
    print(f"  detector on injected keyword posteriors: {hits[0]}",
          flush=True)
    return chunk_ms


def phase12_fused_frontend(dev, trainer, conf, batch, launches):
    """Path C: the phase-7 trainer's configuration with ``fused_frontend:
    True``.  Returns the fused-frontend trainer and its state."""
    import torch

    from wekws_tpu_torch.data import DeviceFeaturePipeline
    from wekws_tpu_torch.models import init_model
    from wekws_tpu_torch.ops.fused_frontend import fused_fbank
    from wekws_tpu_torch.train import Trainer

    fused_conf = dict(TRAIN_DATASET_CONF, fused_frontend=True)
    plain_fused = dict(fused_conf, spec_aug=False)
    plain_fused["fbank_conf"] = dict(fused_conf["fbank_conf"], dither=0.0)
    frame_conf = dict(fused_conf)
    frame_conf["fbank_conf"] = dict(fused_conf["fbank_conf"],
                                    dither_mode="frame")
    plain_unfused = dict(plain_fused, fused_frontend=False)
    cv_fused = DeviceFeaturePipeline.from_conf(fused_conf, training=False)

    def trainer_for(dataset_conf, cvp):
        model = init_model(conf, torch.Generator().manual_seed(SEED))
        model.load_state_dict(trainer.model.state_dict())
        return Trainer(model, DeviceFeaturePipeline.from_conf(dataset_conf),
                       cvp, "max_pooling", grad_clip=5.0, min_duration=5,
                       device=dev)

    fused = trainer_for(plain_fused, cv_fused)
    twin = trainer_for(plain_unfused, trainer.cv_pipeline)
    state, twin_state = fused.init_state(), twin.init_state()
    waves = torch.as_tensor(batch["waves"], device=dev)
    lengths = torch.as_tensor(batch["wave_lengths"], device=dev)

    fused_fbank.launches = 0
    expected = 0
    with torch.no_grad():
        feats, feat_lengths = fused.pipeline(waves, lengths)
        want_feats, want_lengths = twin.pipeline(waves, lengths)
    expected += 1
    check_close("step-0 features, fused vs unfused frontend", feats,
                want_feats, atol=FBANK_ATOL, rtol=FBANK_RTOL)
    if not torch.equal(feat_lengths, want_lengths):
        raise AssertionError("feature lengths differ")
    loss, _ = fused.loss_and_grads(state, batch, SEED)
    want_loss, _ = twin.loss_and_grads(twin_state, batch, SEED)
    expected += 1
    err = abs(float(loss) - float(want_loss))
    if err > 1e-5 * abs(float(want_loss)):
        raise AssertionError(f"step-0 loss {float(loss)} vs unfused "
                             f"frontend {float(want_loss)}")
    losses = {}
    for name, dataset_conf in (("wave-mode dither + spec_aug", fused_conf),
                               ("frame-mode (in-kernel) dither + spec_aug",
                                frame_conf)):
        fused.pipeline = DeviceFeaturePipeline.from_conf(dataset_conf)
        losses[name] = []
        for _ in range(2):
            state, metrics = fused.train_step(state, batch, SEED, 1e-3)
            losses[name].append(float(metrics["loss"]))
            expected += 1
    cv = fused.cv_step(state, batch)
    expected += 1
    torch.cuda.synchronize()
    cv_loss = float(cv["loss_sum"]) / max(float(cv["count"]), 1.0)
    flat = [v for vs in losses.values() for v in vs] + [cv_loss]
    if not all(np.isfinite(flat)) or int(cv["count"]) != TRAIN_B:
        raise AssertionError(f"fused-frontend steps: {losses}, cv {cv}")
    launches["fused_fbank"] = fused_fbank.launches
    if fused_fbank.launches != expected:
        raise AssertionError(f"fused_fbank launched {fused_fbank.launches} "
                             f"times, expected {expected}")
    print(f"  step 0 vs the unfused frontend: loss {float(loss):.6f} (diff "
          f"{err:.2e}); losses "
          + "; ".join(f"{k}: {[round(v, 5) for v in vs]}"
                      for k, vs in losses.items())
          + f"; cv loss {cv_loss:.5f}; fused_fbank launches {expected} "
          f"(1 feature call, 1 loss, 4 train steps, 1 cv step)", flush=True)
    fused.pipeline = DeviceFeaturePipeline.from_conf(fused_conf)
    return fused, state


def fsmn_variants(fw, orders, gen, dev, card):
    """Device time of the FSMN kernel's variants at the main path's two
    shapes (``wekws_tpu_torch/tools/time_fsmn.py``: clusters of 8 or 16
    blocks; each held against the plain version first)."""
    from wekws_tpu_torch.tools.time_fsmn import time_variants

    for (name, (b, t)), ms in time_variants(fw, orders, gen, dev).items():
        txt = "not measured" if ms is None else f"{ms:.4f} ms"
        print(f"  fused_fsmn_layers variant {name} B={b} T={t}: device "
              f"{txt} per call (median of 3 rounds) [{card}]", flush=True)


def kernel_grids(fn, kernel_name, reps=5):
    """The launch arguments (grid, block and, where the trace records
    them, cluster dimensions) of the launches of ``kernel_name`` in a
    torch.profiler trace of ``reps`` calls of ``fn``."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    seen = set()
    for _ in range(3):  # a trace now and then comes back without kernels
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        out = []
        for evt in events:
            args = evt.get("args") or {}
            if kernel_name in str(evt.get("name", "")) and "grid" in args:
                out.append({k: v for k, v in args.items()
                            if k in ("grid", "block") or "luster" in k})
        if out:
            return out
        seen.update(str(evt.get("cat")) for evt in events)
    return [{"no launch of the kernel; event categories": sorted(seen)}]


# the shapes phase 13 times fused_fsmn_layers at, the first the record's
# main row: (width, B, T)
FSMN_TIMED_SHAPES = (("hi_xiaowen", 1, 10), ("hi_xiaowen", N_UTTS, 66),
                     ("synthetic_ctc", 1, 10), ("synthetic_ctc", 256, 66))


def fsmn_shape_name(key):
    tag, b, t = key
    return f"B={b} T={t}" + ("" if tag == "hi_xiaowen" else f" ({tag})")


def phase13_times(dev, bench, errs, launches, card, trainer, state,
                  fused_trainer, fused_state, batch, step_ms, chunk_ms):
    """Per-call times of the three later kernels at their main shapes
    (CUDA events, median of 30; device time from the profiler) beside
    the plain version and the bound; the path-C train step beside the
    unfused-frontend step.  Returns their records."""
    import torch

    from wekws_tpu_torch.ops.fused_fsmn import (
        CLUSTER,
        fused_fsmn_layers,
        fused_fsmn_layers_plain,
        pack_fsmn_weights,
    )
    from wekws_tpu_torch.ops.fused_tcn import fused_ds_tcn, fused_ds_tcn_plain

    gen = torch.Generator().manual_seed(SEED + 13)

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(dev)

    def timed(name, shape, kern, plain, kernel_name, bound):
        ms, plain_ms = kernel_vs_plain_ms(kern, plain)
        dev_ms = profiled_device_ms(kern, kernel_name)
        dev_txt = "not measured" if dev_ms is None else f"{dev_ms:.4f} ms"
        print(f"  {name} {shape}: kernel {ms:.4f} ms per call (device time "
              f"{dev_txt}), plain {plain_ms:.4f} ms, bound {bound[0]:.5f} ms "
              f"({bound[1]}); library: none (no single PyTorch call "
              f"computes it) [{card}]", flush=True)
        return {"shape": shape, "ms": ms, "device_ms": dev_ms,
                "plain_ms": plain_ms, "bound_ms": bound[0],
                "bound_by": bound[1]}

    def record(name, source, replaces, main, also):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": errs[name], "ms": main["ms"],
                "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
                "bound_by": main["bound_by"], "library_ms": None,
                "shape": main["shape"], "device_ms": main["device_ms"],
                "also": also}

    out = []
    tcn_w, dil, k, n_layers, pad_max = bench["tcn"]
    rows = []
    # the streaming step, then offline scoring (zero cache), at the
    # hey_snips width (the main path's) and the hi_xiaowen width
    for c, (b, t) in ((CHANNELS, (N_UTTS, 8)), (CHANNELS, (N_UTTS, 198)),
                      (256, (N_UTTS, 8)), (256, (N_UTTS, 198))):
        tw = tcn_w[c]
        x = randn(b, t, c)
        cache = (randn(n_layers, b, pad_max, c) if t == 8 else
                 torch.zeros((n_layers, b, pad_max, c), device=dev))
        rows.append(timed(
            "fused_ds_tcn", f"B={b} T={t} C={c}",
            lambda: fused_ds_tcn(x, cache, *tw, dil, k),
            lambda: fused_ds_tcn_plain(x, cache, *tw, dil, k),
            "fused_ds_tcn_kernel", tcn_bound_ms(b, t, c, n_layers, k,
                                                pad_max)))
        print(f"  fused_ds_tcn B={b} T={t} C={c}: "
              f"{mdtc_plan_text(b, t, c, k, pad_max, 'ds_tcn')}", flush=True)
    out.append(record("fused_ds_tcn", "wekws_tpu_torch/csrc/fused_mdtc.cu",
                      "wekws_tpu/ops/fused_tcn.py:29", rows[0], rows[1:]))

    # the engine's chunk and offline scoring at the hi_xiaowen width
    # (path B), then at the synthetic CTC recipe's (path D's streaming
    # and scoring batch); FSMN_TIMED_SHAPES names each row
    rows = []
    for key in FSMN_TIMED_SHAPES:
        tag, b, t = key
        fw, orders, ld, pd, n_fsmn, pad = bench["fsmn"][tag]
        packed = pack_fsmn_weights(fw[0], fw[3])  # as build_fused_forward
        x, cache = randn(b, t, ld).relu(), randn(n_fsmn, b, pad, pd)
        rows.append(timed(
            "fused_fsmn_layers", fsmn_shape_name(key),
            lambda: fused_fsmn_layers(x, cache, *fw, *orders, packed=packed),
            lambda: fused_fsmn_layers_plain(x, cache, *fw, *orders),
            "fused_fsmn_kernel",
            fsmn_bound_ms(b, t, ld, pd, n_fsmn, orders[0], orders[1], pad)))
    out.append(record("fused_fsmn_layers",
                      "wekws_tpu_torch/csrc/fused_fsmn.cu",
                      "wekws_tpu/ops/fused_fsmn.py:29", rows[0], rows[1:]))
    fw, orders, ld, pd, n_fsmn, pad = bench["fsmn"]["hi_xiaowen"]
    packed = pack_fsmn_weights(fw[0], fw[3])
    fsmn_variants(fw, orders, gen, dev, card)
    x, cache = randn(N_UTTS, 66, ld).relu(), randn(n_fsmn, N_UTTS, pad, pd)
    grids = kernel_grids(
        lambda: fused_fsmn_layers(x, cache, *fw, *orders, packed=packed),
        "fused_fsmn_kernel")
    print(f"  fused_fsmn_kernel launch B={N_UTTS} T=66 in the profiler's "
          f"trace: {grids}", flush=True)
    blocks = N_UTTS * CLUSTER
    if not grids or any(g.get("grid", [0])[0] != blocks for g in grids):
        raise AssertionError(f"fused_fsmn_kernel: expected a grid of B x "
                             f"{CLUSTER} = {blocks} blocks, the trace has "
                             f"{grids}")

    fused, plain, waves = bench["fbank"]
    cfg = fused.cfg
    n_fft = cfg.padded_window_size
    main = timed(
        "fused_fbank", f"waves {tuple(waves.shape)} M={cfg.num_mel_bins}",
        lambda: fused(waves), lambda: plain(waves), "fused_fbank_kernel",
        fbank_bound_ms(waves.shape[0], waves.shape[1], cfg.frame_length,
                       cfg.frame_shift, n_fft, fused.n_band,
                       cfg.num_mel_bins, cfg.feat_dim))
    # the dense-DFT plan on the same waves, beside: the TPU kernel's work
    dense = timed(
        "fused_fbank, dense-DFT plan",
        f"waves {tuple(waves.shape)} M={cfg.num_mel_bins}",
        lambda: fbank_call(fused, waves, "dense"), lambda: plain(waves),
        "fused_fbank_dense_kernel",
        fbank_dense_bound_ms(waves.shape[0], waves.shape[1],
                             cfg.frame_length, cfg.frame_shift,
                             n_fft // 2 + 1, cfg.num_mel_bins, cfg.feat_dim))
    out.append(record("fused_fbank", "wekws_tpu_torch/csrc/fused_frontend.cu",
                      "wekws_tpu/ops/fused_frontend.py:111", main, [dense]))

    # the path-C train step beside the unfused-frontend step: unfused
    # (phase 8), fused, fused, unfused
    def step_time(tr, st, reps=10):
        for _ in range(2):
            tr.train_step(st, batch, SEED, 1e-3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            tr.train_step(st, batch, SEED, 1e-3)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    step_time(fused_trainer, fused_state)
    fused_ms = step_time(fused_trainer, fused_state)
    unfused_ms = step_time(trainer, state)
    audio = TRAIN_B * TRAIN_SECONDS
    print(f"  train step B={TRAIN_B} x {TRAIN_SECONDS} s, fused_train, "
          f"dither + spec_aug: {fused_ms:.3f} ms with fused_frontend "
          f"({audio / fused_ms * 1e3:.1f} audio-s/s), {unfused_ms:.3f} ms "
          f"without ({audio / unfused_ms * 1e3:.1f} audio-s/s; phase 8 had "
          f"{step_ms:.3f} ms) [{card}]", flush=True)
    print(f"  KeyWordSpotter(use_fused=True).forward: {chunk_ms:.3f} ms per "
          f"300 ms chunk (FSMN-CTC, host clock, phase 11) [{card}]",
          flush=True)
    return out


# the instantiations phase 2 prints: 5 n_fft + the dense plan; MDTC's 3
# widths and DS-TCN's 5, each x (rows a thread 1 to 4 and the split
# depth), and DS-TCN's 6, 8 and 9 rows a thread at C=256
RECIPE = os.path.join("examples", "synthetic")
RECIPE_SPLITS = (("train", 480), ("dev", 96), ("test", 192))
RECIPE_EPOCHS, RECIPE_WORKERS = 2, 2
# the recipe phase's own limit: training starts two loader workers per
# data list, which must be torn down on every exit path
RECIPE_TIMEOUT_S = 480
# the JAX fixture's committed score.txt came from a TPU run, whose matmul
# noise moved posteriors by about 4e-3 (commit 3bf1a59)
FIXTURE_TOL = 1e-2
FIXTURE_STREAM_SHAPE = (16, 8)
DS_TCN_FIXTURE = os.path.join(RECIPE, "exp", "ds_tcn")
# the plain versions of the kernels that the recipe runs: a call on a
# CUDA tensor would mean that a kernel was passed over
PLAIN_VERSIONS = (
    ("wekws_tpu_torch.ops.fused_mdtc_train",
     tuple(f"_{p}_plain" for p in TRAIN_PASSES)),
    ("wekws_tpu_torch.ops.fused_frontend", ("fused_fbank_plain",)),
    ("wekws_tpu_torch.ops.fused_mdtc", ("fused_mdtc_forward_plain",
                                        "fused_mdtc_stream_plain")),
    ("wekws_tpu_torch.ops.fused_tcn", ("fused_ds_tcn_plain",)),
    ("wekws_tpu_torch.ops.fused_fsmn", ("fused_fsmn_layers_plain",)),
)


class PlainOnCuda:
    """Within the ``with``, counts the calls of each plain version in
    ``PLAIN_VERSIONS`` that were given a CUDA tensor."""

    def __enter__(self):
        import importlib

        import torch

        self.counts, self._saved = {}, []
        for modname, names in PLAIN_VERSIONS:
            mod = importlib.import_module(modname)
            for name in names:
                fn = getattr(mod, name)

                def counted(*args, _fn=fn, _key=name, **kwargs):
                    if any(isinstance(a, torch.Tensor) and a.is_cuda
                           for a in list(args) + list(kwargs.values())):
                        self.counts[_key] = self.counts.get(_key, 0) + 1
                    return _fn(*args, **kwargs)

                setattr(mod, name, counted)
                self._saved.append((mod, name, fn))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)
        return False

    def check(self, what):
        if self.counts:
            raise AssertionError(f"{what}: plain versions ran on CUDA "
                                 f"tensors: {self.counts}")


class TimeLimit:
    """SIGALRM after ``seconds``: the phase fails instead of hanging."""

    def __init__(self, seconds, what):
        self.seconds, self.what = seconds, what

    def __enter__(self):
        import signal

        def expired(signum, frame):
            raise TimeoutError(f"{self.what}: over {self.seconds} s")

        self._old = signal.signal(signal.SIGALRM, expired)
        signal.alarm(self.seconds)
        return self

    def __exit__(self, *exc):
        import signal

        signal.alarm(0)
        signal.signal(signal.SIGALRM, self._old)
        return False


def recipe_lists(tmp):
    """The three data lists from the committed wavs, as run_torch.sh's
    stage 0 writes them: key <split>_<i>, label "0" for even i and "-1"
    for odd (as local/gen_data.py made them), absolute paths, durations
    through the port's bin.make_list."""
    from wekws_tpu_torch.bin import make_list

    lists = {}
    for split, n in RECIPE_SPLITS:
        wav_dir = os.path.abspath(os.path.join(RECIPE, "data", split))
        scp, text = (os.path.join(tmp, f"{split}.{x}")
                     for x in ("wav.scp", "text"))
        with open(scp, "w") as f:
            f.writelines(f"{split}_{i} {wav_dir}/{split}_{i}.wav\n"
                         for i in range(n))
        with open(text, "w") as f:
            f.writelines(f"{split}_{i} {0 if i % 2 == 0 else -1}\n"
                         for i in range(n))
        lists[split] = os.path.join(tmp, f"{split}.list")
        make_list.main([scp, text, os.path.join(tmp, f"{split}.dur"),
                        lists[split]])
        with open(lists[split]) as f:
            lines = [json.loads(line) for line in f]
        if len(lines) != n or not all(
                float(x.get("duration", 0)) > 0 for x in lines):
            raise AssertionError(f"{split}.list: {len(lines)} lines, want "
                                 f"{n}, each with a duration")
    return lists


def recipe_config(tmp):
    """conf/mdtc.yaml's data and training settings + fused_frontend,
    with the flagship model + fused_train."""
    import yaml

    with open(os.path.join(RECIPE, "conf", "mdtc.yaml")) as f:
        configs = yaml.safe_load(f)
    configs["dataset_conf"]["fused_frontend"] = True
    model = copy.deepcopy(FLAGSHIP_MODEL_CONF)
    model["backbone"]["fused_train"] = True
    configs["model"] = model
    path = os.path.join(tmp, "mdtc_flagship.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(configs, f)
    return path, configs


def module_vs_fused(config, checkpoint, test_list, dev, tag, softmax=False,
                    tokenizer=None):
    """The checkpoint's posteriors on the test list through the fused
    serving kernel and through the module route, both on the card:
    every frame within TOL.  Returns (max error, the batches' feature
    shapes, the model)."""
    import torch

    from wekws_tpu_torch.bin.common import load_test_setup
    from wekws_tpu_torch.data import init_dataset
    from wekws_tpu_torch.ops.serving import build_fused_forward

    _, model, pipeline, test_conf = load_test_setup(config, checkpoint, 256,
                                                    dev)
    fused = build_fused_forward(model, softmax=softmax, device=dev)
    err, shapes = 0.0, []
    for batch in init_dataset(test_list, test_conf, tokenizer, split="test"):
        waves = torch.as_tensor(batch["waves"]).to(dev, torch.float32)
        lengths = torch.as_tensor(batch["wave_lengths"]).to(dev)
        with torch.inference_mode():
            feats, feat_lengths = pipeline(waves, lengths)
            got = fused(feats, feat_lengths)
            want, _ = model(feats, lengths=feat_lengths, softmax=softmax)
        shapes.append(tuple(feats.shape[:2]))
        err = max(err, check_close(f"{tag}: fused serving vs module route, "
                                   f"B x T = {shapes[-1]}", got, want))
    return err, shapes, model


def fixture_config(fixture, recipe, tmp, name):
    """A fixture's config.yaml with its CMVN file found in this checkout."""
    import yaml

    with open(os.path.join(fixture, "config.yaml")) as f:
        conf = yaml.safe_load(f)
    conf["model"]["cmvn"]["cmvn_file"] = os.path.abspath(
        os.path.join(recipe, "data", "global_cmvn"))
    path = os.path.join(tmp, name)
    with open(path, "w") as f:
        yaml.safe_dump(conf, f)
    return path, conf


def read_scores(path):
    with open(path) as f:
        return {line.split()[0]: np.array(line.split()[2:], np.float64)
                for line in f}


def average_score_det(exp, lists, dev, card, tag=""):
    """Stage 2 of run_torch.sh on a trained ``exp``: bin.average_model
    (RECIPE_EPOCHS, --val_best), bin.score through the fused MDTC
    serving kernel (no plain version on a CUDA tensor; held against the
    module route), bin.compute_det.  Returns (the averaged model, the
    scoring batches' (B, T))."""
    import torch

    from wekws_tpu_torch.bin import average_model, compute_det, score
    from wekws_tpu_torch.ops import fused_mdtc

    avg = os.path.join(exp, f"avg_{RECIPE_EPOCHS}.pt")
    average_model.main(["--dst_model", avg, "--src_path", exp, "--num",
                        str(RECIPE_EPOCHS), "--val_best", "--device",
                        dev.type])
    score_file = os.path.join(exp, "score.txt")
    fused_mdtc.fused_mdtc_forward.launches = 0
    t0 = time.perf_counter()
    with PlainOnCuda() as plain:
        n_scored = score.main([
            "--config", os.path.join(exp, "config.yaml"), "--test_data",
            lists["test"], "--checkpoint", avg, "--score_file",
            score_file, "--device", dev.type])
        torch.cuda.synchronize()
    score_s = time.perf_counter() - t0
    plain.check(f"bin.score{tag}")
    mdtc_launches = fused_mdtc.fused_mdtc_forward.launches
    n_test = dict(RECIPE_SPLITS)["test"]
    if n_scored != n_test or mdtc_launches < 1:
        raise AssertionError(f"bin.score{tag}: {n_scored} utterances, "
                             f"{mdtc_launches} fused_mdtc launches")
    err, shapes, model = module_vs_fused(
        os.path.join(exp, "config.yaml"), avg, lists["test"], dev,
        f"flagship averaged{tag}")
    stats = os.path.join(exp, "stats.0.txt")
    compute_det.main(["--keyword", "0", "--test_data", lists["test"],
                      "--score_file", score_file, "--stats_file", stats,
                      "--device", dev.type])
    with open(stats) as f:
        rows = [tuple(map(float, line.split())) for line in f]
    if len(rows) < 100 or any(len(r) != 3 for r in rows):
        raise AssertionError(f"stats file{tag}: {len(rows)} rows")
    print(f"  averaged {RECIPE_EPOCHS} checkpoints{tag}; bin.score: "
          f"{n_scored} utterances, {mdtc_launches} fused_mdtc launch(es) "
          f"at B x T = {shapes}, {score_s:.2f} s wall (config, weights, "
          f"features, kernel, score file) [{card}]; module route "
          f"within {err:.2e}; DET: {len(rows)} thresholds, FRR "
          f"{rows[50][2]:.4f} and FA/h {rows[50][1]:.2f} at 0.5",
          flush=True)
    return model, shapes


def phase14_recipe(dev, card, keep=None):
    """The flagship recipe end to end through the port's CLIs: lists,
    bin.train (2 epochs, fused passes and fused fbank), average, score
    (fused MDTC serving), DET; then the JAX DS-TCN fixture scored
    through the fused DS-TCN kernel at C=48.  The averaged checkpoint
    and its config.yaml are copied into ``keep`` (for run_torch.sh's
    stage 4 in phase 19d).  Returns bin.train's audio-s/s per epoch."""
    import logging
    import tempfile

    import torch
    import yaml

    from wekws_tpu_torch.bin import score, train
    from wekws_tpu_torch.data import DataLoader, init_dataset
    from wekws_tpu_torch.ops import fused_frontend, fused_mdtc, fused_tcn
    from wekws_tpu_torch.ops.fused_mdtc import extract_mdtc_weights
    from wekws_tpu_torch.ops.fused_mdtc_train import PASSES, reset_launches
    from wekws_tpu_torch.ops.fused_tcn import (
        extract_ds_tcn_weights,
        init_tcn_cache,
    )

    with tempfile.TemporaryDirectory() as tmp:
        lists = recipe_lists(tmp)
        config, configs = recipe_config(tmp)
        exp = os.path.join(tmp, "exp")
        print(f"  lists {', '.join(f'{s} {n}' for s, n in RECIPE_SPLITS)} "
              f"lines with durations; config: conf/mdtc.yaml's data + "
              f"fused_frontend, the flagship MDTC + fused_train", flush=True)

        # train, the launch counters zeroed just before
        epoch_done = []

        class EpochTimes(logging.Handler):
            def emit(self, record):
                if record.getMessage().startswith("Epoch") and \
                        " done: " in record.getMessage():
                    epoch_done.append(time.perf_counter())

        logging.basicConfig(level=logging.INFO,
                            format="%(asctime)s %(levelname)s %(message)s")
        root_logger = logging.getLogger()
        level = root_logger.level
        root_logger.setLevel(logging.INFO)
        handler = EpochTimes()
        root_logger.addHandler(handler)
        reset_launches()
        fused_frontend.fused_fbank.launches = 0
        t0 = time.perf_counter()
        try:
            with PlainOnCuda() as plain, TimeLimit(RECIPE_TIMEOUT_S,
                                                   "bin.train"):
                train.main([
                    "--config", config, "--train_data", lists["train"],
                    "--cv_data", lists["dev"], "--model_dir", exp,
                    "--min_duration", "20", "--seed", "666",
                    "--cmvn_file", os.path.join(RECIPE, "data",
                                                "global_cmvn"),
                    "--norm_var", "--num_epochs", str(RECIPE_EPOCHS),
                    "--num_workers", str(RECIPE_WORKERS),
                    "--device", dev.type])
                torch.cuda.synchronize()
        finally:
            root_logger.removeHandler(handler)
            root_logger.setLevel(level)
        plain.check("bin.train")
        train_s = time.perf_counter() - t0
        fbank_launches = fused_frontend.fused_fbank.launches
        want_files = ["config.yaml", "metrics.jsonl", "init.pt"] + [
            f"{e}.{x}" for e in range(RECIPE_EPOCHS) for x in ("pt", "yaml")]
        missing = [f for f in want_files
                   if not os.path.exists(os.path.join(exp, f))]
        events = os.listdir(os.path.join(exp, "tensorboard"))
        if missing or len(events) != 1:
            raise AssertionError(f"bin.train outputs: missing {missing}, "
                                 f"tensorboard {events}")
        with open(os.path.join(exp, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        cv_losses = []
        for e in range(RECIPE_EPOCHS):
            with open(os.path.join(exp, f"{e}.yaml")) as f:
                cv_losses.append(float(yaml.safe_load(f)["cv_loss"]))
        train_losses = [r["train_loss"] for r in records]
        if len(records) != RECIPE_EPOCHS or not all(
                np.isfinite(train_losses + cv_losses)):
            raise AssertionError(f"train losses {train_losses}, cv losses "
                                 f"{cv_losses}")
        steps = sum(r["batches"] for r in records)
        # each cv batch runs the fused fbank once: per worker shard, its
        # utterances in batches of batch_size
        batch_size = configs["dataset_conf"]["batch_conf"]["batch_size"]
        n_dev = dict(RECIPE_SPLITS)["dev"]
        cv_batches = RECIPE_EPOCHS * sum(
            math.ceil(len(range(w, n_dev, RECIPE_WORKERS)) / batch_size)
            for w in range(RECIPE_WORKERS))
        n_blocks = 1 + 4 * 4
        counts = {name: PASSES[name].launches for name in TRAIN_PASSES}
        if any(v != n_blocks * steps for v in counts.values()) or \
                fbank_launches != steps + cv_batches:
            raise AssertionError(
                f"{steps} train steps, {cv_batches} cv batches: pass "
                f"launches {counts} (want {n_blocks} x {steps}), "
                f"fused_fbank {fbank_launches} (want {steps + cv_batches})")
        epoch_s = np.diff([t0] + epoch_done[-RECIPE_EPOCHS:]).tolist()
        print(f"  bin.train: {RECIPE_EPOCHS} epochs, {steps} steps of "
              f"B={batch_size}; train losses {train_losses}, cv losses "
              f"{cv_losses}; each pass launched {n_blocks} x {steps} = "
              f"{n_blocks * steps} times, fused_fbank {fbank_launches} "
              f"(steps + {cv_batches} cv batches), no plain version on a "
              f"CUDA tensor", flush=True)
        # the host pipeline alone: the same train list through a fresh
        # DataLoader, no training (the first epoch starts the workers)
        loader = DataLoader(init_dataset(lists["train"],
                                         configs["dataset_conf"],
                                         split="train"),
                            num_workers=RECIPE_WORKERS)
        loader_s, loader_audio = [], 0.0
        try:
            with TimeLimit(RECIPE_TIMEOUT_S, "DataLoader alone"):
                for epoch in range(RECIPE_EPOCHS):
                    t1 = time.perf_counter()
                    loader.set_epoch(epoch)
                    loader_audio = sum(float(b["wave_lengths"].sum())
                                       for b in loader) / 16000.0
                    loader_s.append(time.perf_counter() - t1)
        finally:
            loader.close()
        print(f"  the DataLoader alone ({RECIPE_WORKERS} workers, no "
              f"training): epochs {', '.join(f'{x:.2f}' for x in loader_s)}"
              f" s ({loader_audio / loader_s[-1]:.1f} audio-s/s in the "
              f"last; the first starts the workers)", flush=True)
        rates = [r["audio_seconds_per_s"] for r in records]
        print(f"  bin.train wall time {train_s:.1f} s (workers' start "
              f"included); per epoch (train + cv + checkpoint) "
              f"{', '.join(f'{x:.2f}' for x in epoch_s)} s; train rate "
              f"{', '.join(f'{x:.1f}' for x in rates)} audio-s/s "
              f"[{card}]", flush=True)

        model, shapes = average_score_det(exp, lists, dev, card)
        n_test = dict(RECIPE_SPLITS)["test"]
        if keep is not None:
            import shutil

            os.makedirs(keep, exist_ok=True)
            for f in ("config.yaml", f"avg_{RECIPE_EPOCHS}.pt"):
                shutil.copy(os.path.join(exp, f), keep)

        # the JAX fixture (DS-TCN, C=48), its cmvn path pointed here
        fixture = DS_TCN_FIXTURE
        fconfig, _ = fixture_config(fixture, RECIPE, tmp, "ds_tcn.yaml")
        ckpt = os.path.join(fixture, "avg_5.ckpt")
        fscore = os.path.join(tmp, "ds_tcn_score.txt")
        fused_tcn.fused_ds_tcn.launches = 0
        with PlainOnCuda() as plain:
            n_fixture = score.main([
                "--config", fconfig, "--test_data", lists["test"],
                "--checkpoint", ckpt, "--score_file", fscore, "--device",
                dev.type])
        plain.check("bin.score, fixture")
        tcn_launches = fused_tcn.fused_ds_tcn.launches
        if n_fixture != n_test or tcn_launches < 1:
            raise AssertionError(f"fixture: {n_fixture} utterances, "
                                 f"{tcn_launches} fused_ds_tcn launches")
        ferr, fshapes, fmodel = module_vs_fused(fconfig, ckpt,
                                                lists["test"], dev,
                                                "JAX DS-TCN fixture")
        got, want = read_scores(fscore), read_scores(
            os.path.join(fixture, "score.txt"))
        if got.keys() != want.keys() or any(
                got[k].shape != want[k].shape for k in got):
            raise AssertionError("fixture: score keys or frame counts "
                                 "differ from the committed score.txt")
        tpu_err = max(float(np.abs(got[k] - want[k]).max()) for k in got)
        if not tpu_err <= FIXTURE_TOL:
            raise AssertionError(f"fixture vs committed score.txt: "
                                 f"{tpu_err} > {FIXTURE_TOL}")
        print(f"  JAX fixture avg_5.ckpt (DS-TCN, C=48): {n_fixture} "
              f"utterances through fused_ds_tcn ({tcn_launches} launch(es) at "
              f"B x T = {fshapes}), module route within {ferr:.2e}, the "
              f"committed TPU score.txt within {tpu_err:.2e} (bound "
              f"{FIXTURE_TOL})", flush=True)

    # fused_mdtc at bin.score's shape, the trained flagship's weights
    gen = torch.Generator().manual_seed(SEED + 14)
    *stacks, dilations = extract_mdtc_weights(model.backbone)
    weights = tuple(w.to(dev) for w in stacks)
    mdtc = model.backbone
    b, t = shapes[0]
    x = torch.randn((b, t, mdtc.res_channels), generator=gen).to(dev)
    dev_ms = profiled_device_ms(
        lambda: fused_mdtc.fused_mdtc_forward(
            x, *weights, dilations, mdtc.kernel_size, mdtc.stack_size),
        "fused_mdtc_kernel")
    bound, bound_by = mdtc_bound_ms(
        b, t, mdtc.res_channels, len(dilations), mdtc.kernel_size,
        mdtc.stack_num, (mdtc.kernel_size - 1) * max(dilations), False)
    dev_txt = "not measured" if dev_ms is None else f"{dev_ms:.4f} ms"
    print(f"  fused_mdtc (bin.score's call) B={b} T={t}: device time "
          f"{dev_txt} per call, bound {bound:.5f} ms ({bound_by}) [{card}]",
          flush=True)

    # fused_ds_tcn at C=48: the fixture's scoring shape and a streaming step
    *stacks, dilations = extract_ds_tcn_weights(fmodel.backbone)
    weights = tuple(w.to(dev) for w in stacks)
    k = fmodel.backbone.kernel_size
    pad = (k - 1) * max(dilations)
    c = fmodel.backbone.channel
    for b, t in (fshapes[0], FIXTURE_STREAM_SHAPE):
        x = torch.randn((b, t, c), generator=gen).to(dev)
        cache = init_tcn_cache(len(dilations), b, pad, c, dev)
        dev_ms = profiled_device_ms(
            lambda: fused_tcn.fused_ds_tcn(x, cache, *weights, dilations, k),
            "fused_ds_tcn_kernel")
        bound, bound_by = tcn_bound_ms(b, t, c, len(dilations), k, pad)
        dev_txt = "not measured" if dev_ms is None else f"{dev_ms:.4f} ms"
        print(f"  fused_ds_tcn C={c} B={b} T={t}: device time {dev_txt} per "
              f"call, bound {bound:.5f} ms ({bound_by}) [{card}]",
              flush=True)
    return rates


# path D, CTC (phase 15): the hi_xiaowen FSMN-CTC trained at full width
# on bench.py bench_ctc's batch, then the synthetic CTC recipe through
# the CLIs and the JAX-trained fixture scored through fused_fsmn_kernel
CTC_TRAIN_B, CTC_SECONDS, CTC_LABELS = 256, 2, 6
CTC_DATASET_CONF = {  # bench.py bench_ctc
    "feats_type": "fbank",
    "fbank_conf": {"num_mel_bins": 80, "frame_shift": 10,
                   "frame_length": 25, "dither": 1.0,
                   "dither_mode": "wave", "precision": "default"},
    "context_expansion": True,
    "context_expansion_conf": {"left": 2, "right": 2},
    "frame_skip": 3,
    "spec_aug": True,
    "spec_aug_conf": {"num_t_mask": 1, "num_f_mask": 1,
                      "max_t": 20, "max_f": 10},
}
# step 0 against float64: the loss (fp32 sums over 2599 tokens and 66
# frames) and each tensor's gradient against its own largest |grad|
# (FSMN has no BatchNorm whose E[x^2] - E[x]^2 cancels)
CTC_LOSS64_RTOL, CTC_GRAD64_TOL = 1e-5, 1e-3
# torch.nn.functional.ctc_loss in float64, an independent witness
CTC_WITNESS_RTOL = 1e-4
CTC_STEPS_PLAIN, CTC_STEPS_AUG = 5, 2
CTC_RECIPE = os.path.join("examples", "synthetic_ctc")
CTC_RECIPE_EPOCHS, CTC_RECIPE_KEYWORD = 2, "123"
CTC_FIXTURE = os.path.join(CTC_RECIPE, "exp", "fsmn_ctc")
# the port at float32 against the committed TPU files (a bfloat16 run):
# the limits tests/test_torch_ctc_recipe.py sets from its CPU reading
# (offline 0 flips, largest error 0.0; streamed 0 flips, 0.047)
CTC_FIXTURE_SCORE_TOL, CTC_FIXTURE_STREAM_TOL = 1e-3, 0.05
# a score file prints three decimals
CTC_SCORE_TOL = 2e-3
CTC_RECIPE_VOCAB = 6  # dict/dict.txt


def ctc_recipe_model_conf():
    """The synthetic CTC recipe's model (conf_torch/fsmn_ctc.yaml) at the
    widths bin.train gives it: 40 mel bins x 5 spliced frames in, the
    dictionary's tokens out."""
    import yaml

    with open(os.path.join(CTC_RECIPE, "conf_torch", "fsmn_ctc.yaml")) as f:
        conf = yaml.safe_load(f)
    data = conf["dataset_conf"]
    ctx = data["context_expansion_conf"]
    return dict(conf["model"], output_dim=CTC_RECIPE_VOCAB,
                input_dim=data["fbank_conf"]["num_mel_bins"]
                * (ctx["left"] + ctx["right"] + 1))


def ctc_train_batch(rng):
    """bench.py bench_ctc's batch: noise waves, U=6 labels from the
    seed, every row 2 s."""
    n = CTC_SECONDS * RATE
    return {"waves": (rng.standard_normal((CTC_TRAIN_B, n)) * 1000
                      ).astype(np.float32),
            "wave_lengths": np.full((CTC_TRAIN_B,), n, np.int32),
            "target": rng.integers(1, FSMN_VOCAB, (CTC_TRAIN_B, CTC_LABELS)
                                   ).astype(np.int32),
            "target_lengths": np.full((CTC_TRAIN_B,), CTC_LABELS, np.int32)}


def profiled_step(fn, names=()):
    """(device time of every CUDA entry in ms, CUDA launches, {fragment:
    mean device ms per call of the first entry whose name holds it, or
    None}) of one call of ``fn`` under torch.profiler.  A trace now and
    then comes back without its first kernel: so the trace opens with a
    short ``spin_kernel`` (``torch.cuda._sleep``), left out of the
    readings, before the call; and a call whose trace still lacks a
    named kernel is profiled again, up to three times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        busy = count = 0
        found = dict.fromkeys(names)
        for evt in prof.key_averages():
            total = getattr(evt, "device_time_total",
                            getattr(evt, "cuda_time_total", 0.0))
            if not (evt.count and total) or "spin_kernel" in evt.key:
                continue
            if str(getattr(evt, "device_type", "")).endswith("CUDA"):
                busy += total
                count += evt.count
            for name in names:
                if found[name] is None and name in evt.key:
                    found[name] = total / evt.count / 1e3
        if all(v is not None for v in found.values()):
            break
    return busy / 1e3, count, found


def timed_steps(step, reps=10):
    """Median, min and max host-clock ms of synchronised calls (two
    warm-up calls first)."""
    import torch

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), min(times), max(times)


def ctc_setup(dev):
    """15a's seeded batch, its cv pipeline, the batch's features and the
    hi_xiaowen FSMN-CTC config with global CMVN from those features, as
    the recipe's --cmvn_file gives it (the spliced 400 inputs: 80 bins x
    5)."""
    import torch

    from wekws_tpu_torch.data import DeviceFeaturePipeline

    batch = ctc_train_batch(np.random.default_rng(SEED))
    cvp = DeviceFeaturePipeline.from_conf(CTC_DATASET_CONF, training=False)
    with torch.no_grad():
        feats, feat_lengths = cvp(
            torch.as_tensor(batch["waves"], device=dev),
            torch.as_tensor(batch["wave_lengths"], device=dev))
    mel = feats.reshape(-1, 5, 80)[:, 2]
    conf = dict(FSMN_MODEL_CONF, cmvn={
        "mean": mel.mean(dim=0).tolist(),
        "istd": (1.0 / (mel.std(dim=0) + 1e-6)).tolist(), "norm_var": True})
    return batch, cvp, feats, feat_lengths, conf


def phase15a_ctc_training(dev, card, work):
    """The hi_xiaowen FSMN-CTC (2599 tokens) trained through
    ``Trainer(..., "ctc")`` at B=256 x 2 s: step 0 against float64 and
    against ``F.ctc_loss``, 5 plain steps, 2 with dither + spec_aug, a
    cv step with the decode accuracy, times, then saved, reloaded and
    served through ``build_fused_forward(softmax=True)``.  Returns the
    offline FSMN launch count."""
    import torch
    import torch.nn.functional as F

    from wekws_tpu_torch.data import DeviceFeaturePipeline
    from wekws_tpu_torch.losses import criterion, ctc_loss_compact
    from wekws_tpu_torch.losses.mask import padding_mask
    from wekws_tpu_torch.models import init_model
    from wekws_tpu_torch.ops.fused_fsmn import fused_fsmn_layers
    from wekws_tpu_torch.ops.serving import build_fused_forward
    from wekws_tpu_torch.train import (
        Executor,
        Trainer,
        load_checkpoint,
        save_checkpoint,
    )

    plain_conf = dict(CTC_DATASET_CONF, spec_aug=False)
    plain_conf["fbank_conf"] = dict(CTC_DATASET_CONF["fbank_conf"],
                                    dither=0.0)
    batch, cvp, feats, feat_lengths, conf = ctc_setup(dev)
    waves = torch.as_tensor(batch["waves"], device=dev)
    lengths = torch.as_tensor(batch["wave_lengths"], device=dev)
    target = torch.as_tensor(batch["target"], device=dev).long()
    target_lengths = torch.as_tensor(batch["target_lengths"],
                                     device=dev).long()
    model = init_model(conf, torch.Generator().manual_seed(SEED))
    trainer = Trainer(model, DeviceFeaturePipeline.from_conf(plain_conf),
                      cvp, "ctc", grad_clip=5.0, device=dev)
    state = trainer.init_state()
    n_params = sum(p.numel() for p in model.parameters())

    # step 0: the features once, shared by the fp32 and float64 routes
    # (the train pipeline without dither and spec_aug gives the cv one's)
    ref = init_model(conf)
    ref.load_state_dict(model.state_dict())
    ref = ref.to(dev, torch.float64).train()
    logits64, _ = ref(feats.double(), lengths=feat_lengths)
    loss64, _ = criterion("ctc", logits64, target, feat_lengths,
                          target_lengths)
    loss64.backward()
    model.train()
    logits, _ = model(feats, lengths=feat_lengths)
    loss, _ = criterion("ctc", logits, target, feat_lengths, target_lengths)
    model.zero_grad(set_to_none=True)
    loss.backward()
    got, want = float(loss.detach()), float(loss64.detach())
    rel = abs(got - want) / abs(want)
    if not rel <= CTC_LOSS64_RTOL:
        raise AssertionError(f"step-0 CTC loss {got} vs float64 {want}: "
                             f"{rel:.2e} rel")
    worst = (0.0, "")
    refs = dict(ref.named_parameters())
    for name, prm in model.named_parameters():
        grad64 = refs[name].grad
        share = float((prm.grad.double() - grad64).abs().max()) / max(
            float(grad64.abs().max()), 1e-12)
        if share > worst[0]:
            worst = (share, name)
    if not worst[0] <= CTC_GRAD64_TOL:
        raise AssertionError(f"step-0 gradient of {worst[1]} off float64 "
                             f"by {worst[0]:.2e} of its largest |grad|")
    # the independent witness: F.ctc_loss in float64 on the same logits
    t = logits.shape[1]
    logit_pad = padding_mask(feat_lengths, t).float()
    label_pad = padding_mask(target_lengths, CTC_LABELS).float()
    with torch.no_grad():
        port_b = ctc_loss_compact(logits, logit_pad, target, label_pad)
        witness = F.ctc_loss(
            torch.log_softmax(logits.double(), dim=-1).transpose(0, 1),
            target, feat_lengths, target_lengths, blank=0,
            reduction="none")
    feasible = feat_lengths >= 2 * target_lengths + 1
    wrel = float(((port_b.double() - witness).abs() / witness.abs())
                 [feasible].max())
    if not (int(feasible.sum()) == CTC_TRAIN_B
            and wrel <= CTC_WITNESS_RTOL):
        raise AssertionError(f"port CTC loss vs F.ctc_loss (float64): "
                             f"{wrel:.2e} rel over {int(feasible.sum())} "
                             f"feasible rows")
    print(f"  FSMN-CTC (hi_xiaowen, {FSMN_VOCAB} tokens): {n_params} "
          f"parameters, B={CTC_TRAIN_B} x {CTC_SECONDS} s, features "
          f"{tuple(feats.shape)}; step 0 vs float64 on the card: loss "
          f"{got:.6f} ({rel:.2e} rel, bound {CTC_LOSS64_RTOL}), "
          f"worst gradient {worst[0]:.2e} of its tensor's largest |grad| "
          f"({worst[1]}; bound {CTC_GRAD64_TOL}); the port's loss vs "
          f"F.ctc_loss in float64, {CTC_TRAIN_B} feasible rows: {wrel:.2e} "
          f"rel (bound {CTC_WITNESS_RTOL}) [{card}]", flush=True)

    # training steps: none of a hand kernel's plain versions may run
    losses, aug_losses = [], []
    with PlainOnCuda() as plain:
        for _ in range(CTC_STEPS_PLAIN):
            state, metrics = trainer.train_step(state, batch, SEED, 1e-3)
            losses.append(float(metrics["loss"]))
        trainer.pipeline = DeviceFeaturePipeline.from_conf(CTC_DATASET_CONF)
        for _ in range(CTC_STEPS_AUG):
            state, metrics = trainer.train_step(state, batch, SEED, 1e-3)
            aug_losses.append(float(metrics["loss"]))
        cv = Executor(trainer).cv(state, [batch], decode_acc=True)
        torch.cuda.synchronize()
    plain.check("CTC training")
    if not (np.isfinite(losses + aug_losses).all()
            and losses[-1] < losses[0]):
        raise AssertionError(f"CTC losses {losses}, with augmentation "
                             f"{aug_losses}")
    if not (np.isfinite(cv["cv_loss"]) and cv["utts"] == CTC_TRAIN_B
            and "cv_decode_acc" in cv):
        raise AssertionError(f"CTC cv step: {cv}")
    print(f"  losses, no augmentation: {[round(v, 4) for v in losses]}; "
          f"with dither + spec_aug: {[round(v, 4) for v in aug_losses]}; "
          f"cv loss {cv['cv_loss']:.4f}, greedy token accuracy "
          f"{cv['cv_acc']:.4f}, decode accuracy {cv['cv_decode_acc']:.2f}% "
          f"[{card}]", flush=True)

    # times: the step (host clock, synchronised), and the CTC loss's
    # launches and device time (forward and backward); the step's device
    # time and idle share are traced in a fresh process (16e)
    reps = 10
    step_ms, lo, hi = timed_steps(
        lambda: trainer.train_step(state, batch, SEED, 1e-3), reps)
    leaf = logits.detach().requires_grad_()

    def ctc_fwd_bwd():
        criterion("ctc", leaf, target, feat_lengths,
                  target_lengths)[0].backward()

    ctc_fwd_bwd()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        ctc_fwd_bwd()
    torch.cuda.synchronize()
    ctc_host_ms = (time.perf_counter() - t0) / reps * 1e3
    ctc_ms, ctc_launches, _ = profiled_step(ctc_fwd_bwd)
    audio = CTC_TRAIN_B * CTC_SECONDS
    print(f"  train step B={CTC_TRAIN_B} x {CTC_SECONDS} s (FSMN-CTC, "
          f"dither + spec_aug): median {step_ms:.3f} ms of {reps} "
          f"({audio / step_ms * 1e3:.1f} audio-s/s), min "
          f"{lo:.3f}, max {hi:.3f}; the CTC "
          f"loss (forward + backward, T={t}): "
          f"{ctc_launches} launches, {ctc_ms:.3f} ms of device time, "
          f"{ctc_host_ms:.3f} ms host clock [{card}]", flush=True)

    # saved, reloaded, served offline through the fused FSMN kernel
    path = os.path.join(work, "fsmn_ctc_trained.pt")
    save_checkpoint(path, state.model.state_dict())
    served = init_model(conf)
    served.load_state_dict(load_checkpoint(path))
    served = served.to(dev).eval()
    sub = slice(0, N_UTTS)
    with torch.no_grad():
        f16, l16 = cvp(waves[sub], lengths[sub])
    # the logits (a posterior over 2599 tokens is about 4e-4, below the
    # absolute bound), then the posteriors bin.score_ctc reads: one launch
    # each
    fused_fsmn_layers.launches = 0
    with PlainOnCuda() as plain:
        logits = build_fused_forward(served, device=dev)(f16, l16)
        probs = build_fused_forward(served, softmax=True, device=dev)(f16,
                                                                     l16)
    plain.check("FSMN-CTC served")
    offline = fused_fsmn_layers.launches
    with torch.inference_mode():
        module_logits, _ = served(f16, lengths=l16)
        module_probs, _ = served(f16, lengths=l16, softmax=True)
    err = max(check_close(f"trained FSMN-CTC: build_fused_forward "
                          f"{tuple(logits.shape)} logits vs module forward",
                          logits, module_logits),
              check_close(f"trained FSMN-CTC: build_fused_forward(softmax="
                          f"True) {tuple(probs.shape)} vs module forward",
                          probs, module_probs))
    if offline != 2:
        raise AssertionError(f"two offline FSMN forwards launched "
                             f"{offline} times, want 2")
    return {"offline": offline, "err": err, "step_ms": step_ms}


def run_cli(main, argv, what):
    """One of the port's CLIs under PlainOnCuda, synchronised."""
    import torch

    with PlainOnCuda() as plain:
        out = main(argv)
        torch.cuda.synchronize()
    plain.check(what)
    return out


class StreamChunks:
    """Within the ``with``, counts ``KeyWordSpotter`` model steps: one
    per chunk that carried frames."""

    def __enter__(self):
        from wekws_tpu_torch.runtime.keyword_spotter import KeyWordSpotter

        self.count, self._cls = 0, KeyWordSpotter
        self._orig = KeyWordSpotter._device_apply

        def counted(spot, feats, cache):
            self.count += 1
            return self._orig(spot, feats, cache)

        KeyWordSpotter._device_apply = counted
        return self

    def __exit__(self, *exc):
        self._cls._device_apply = self._orig
        return False


def engines_agree(dev, tag, config, ckpt, token_file, test_list):
    """``KeyWordSpotter`` on the card with and without ``use_fused``, as
    ``bin.stream_score_ctc`` builds it, over every utterance of the list
    in 300 ms chunks (every chunk, past detections): each chunk's
    posteriors within TOL, and the same result after each chunk (scores
    within TOL).  Returns (largest posterior error, chunks that carried
    frames, detections)."""
    from wekws_tpu_torch.data.audio import read_wav
    from wekws_tpu_torch.runtime import KeyWordSpotter

    pcms = []
    with open(test_list) as f:
        for line in f:
            wave, sr = read_wav(json.loads(line)["wav"])
            pcms.append((np.clip(wave, -1, 1) * 32767).astype("<i2")
                        .tobytes())
    runs = {}
    for use_fused in (True, False):
        spot = KeyWordSpotter(ckpt, config, token_file, None, 0.1,
                              use_fused=use_fused, device=dev)
        spot.set_keywords(CTC_RECIPE_KEYWORD)
        runs[use_fused] = stream_engine(spot, pcms,
                                        2 * int(sr * 300 / 1000))
    (got, got_results, carried, _), (want, want_results, _, _) = (
        runs[True], runs[False])
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        worst = max(worst, check_close(
            f"{tag}: streamed utterance {i}, fused vs module engine", g, w,
            quiet=True))
    for i, (g, w) in enumerate(zip(got_results, want_results)):
        same = g.keys() == w.keys() and all(
            g[k] == w[k] for k in g if k != "score")
        if not same or (g.get("score") is None) != (w.get("score") is None) \
                or (g.get("score") is not None and abs(g["score"] - w["score"])
                    > TOL + TOL * abs(w["score"])):
            raise AssertionError(f"{tag}: chunk {i}: the fused engine's "
                                 f"result {g} differs from the module "
                                 f"engine's {w}")
    return worst, carried, sum(bool(r.get("state")) for r in want_results)


def ctc_score_paths(dev, card, tag, config, ckpt, test_list, out_dir):
    """``bin.score_ctc`` (host decoder and ``--device_decode``),
    ``bin.compute_det_ctc`` and ``bin.stream_score_ctc`` on the card for
    one checkpoint, each kernel launch counted: one ``fused_fsmn_layers``
    launch per scoring batch and per streamed chunk that carried frames,
    posteriors against the module route.  Returns the files and
    counts."""
    from wekws_tpu_torch.bin import compute_det_ctc, score_ctc
    from wekws_tpu_torch.bin import stream_score_ctc
    from wekws_tpu_torch.bin.common import load_test_setup
    from wekws_tpu_torch.data import init_dataset
    from wekws_tpu_torch.eval import compare_ctc_score_files
    from wekws_tpu_torch.ops.fused_fsmn import fused_fsmn_layers
    from wekws_tpu_torch.text import CharTokenizer

    dict_dir = os.path.join(CTC_RECIPE, "dict")
    tokenizer = CharTokenizer(os.path.join(dict_dir, "dict.txt"),
                              unk="<filler>", split_with_space=True)
    out = {"score": os.path.join(out_dir, "score.txt"),
           "score_dd": os.path.join(out_dir, "score_dd.txt"),
           "stream": os.path.join(out_dir, "stream_score.txt")}
    _, _, _, test_conf = load_test_setup(config, ckpt, 256, dev)
    shapes = [tuple(b["waves"].shape) for b in init_dataset(
        test_list, test_conf, tokenizer, split="test")]
    args = ["--config", config, "--test_data", test_list, "--checkpoint",
            ckpt, "--dict", dict_dir, "--keywords", CTC_RECIPE_KEYWORD,
            "--device", dev.type]
    launches = {}
    for name, extra in (("score", []), ("score_dd", ["--device_decode"])):
        fused_fsmn_layers.launches = 0
        t0 = time.perf_counter()
        n = run_cli(score_ctc.main, args + ["--score_file", out[name]]
                        + extra, f"{tag}: bin.score_ctc {' '.join(extra)}")
        out[f"{name}_s"] = time.perf_counter() - t0
        launches[name] = fused_fsmn_layers.launches
        if launches[name] != len(shapes):
            raise AssertionError(f"{tag}: bin.score_ctc {extra} launched "
                                 f"fused_fsmn_layers {launches[name]} "
                                 f"times for {len(shapes)} batches")
    out["n"] = n
    out["stats"], = run_cli(compute_det_ctc.main, [
        "--test_data", test_list, "--keywords", CTC_RECIPE_KEYWORD,
        "--score_file", out["score"], "--stats_dir", out_dir, "--device",
        dev.type],
        f"{tag}: bin.compute_det_ctc")
    with open(out["stats"]) as f:
        rows = [tuple(map(float, line.split())) for line in f]
    if len(rows) < 1000 or any(len(r) != 3 for r in rows):
        raise AssertionError(f"{tag}: stats file {len(rows)} rows")
    fused_fsmn_layers.launches = 0
    t0 = time.perf_counter()
    with StreamChunks() as chunks:
        run_cli(stream_score_ctc.main, [
            "--config", config, "--checkpoint", ckpt, "--test_data",
            test_list, "--token_file", os.path.join(dict_dir, "dict.txt"),
            "--keywords", CTC_RECIPE_KEYWORD, "--score_file", out["stream"],
            "--threshold", "0.1", "--device", dev.type],
            f"{tag}: bin.stream_score_ctc")
    out["stream_s"] = time.perf_counter() - t0
    launches["stream"] = fused_fsmn_layers.launches
    if launches["stream"] != chunks.count or chunks.count < n:
        raise AssertionError(f"{tag}: bin.stream_score_ctc launched "
                             f"fused_fsmn_layers {launches['stream']} times "
                             f"for {chunks.count} chunks that carried "
                             f"frames")
    err, fshapes, _ = module_vs_fused(config, ckpt, test_list, dev,
                                      f"{tag} (softmax)", softmax=True,
                                      tokenizer=tokenizer)
    stream_err, n_chunks, fires = engines_agree(
        dev, tag, config, ckpt, os.path.join(dict_dir, "dict.txt"),
        test_list)
    flips, dd_err = compare_ctc_score_files(out["score_dd"], out["score"])
    out.update(launches=launches, err=err, shapes=fshapes, rows=rows,
               dd_flips=flips, dd_err=dd_err, stream_err=stream_err,
               stream_fires=fires)
    print(f"  {tag}: bin.score_ctc {n} utterances, fused_fsmn_layers "
          f"launched {launches['score']} times at B x T = {fshapes} (one per "
          f"batch), {out['score_s']:.2f} s wall; --device_decode "
          f"{out['score_dd_s']:.2f} s wall, {len(flips)} decision(s) off "
          f"the host decoder's, scores within {dd_err:.3f} where both "
          f"detect; module route within {err:.2e}; DET {len(rows)} "
          f"thresholds; bin.stream_score_ctc {launches['stream']} launches "
          f"= chunks that carried frames, {out['stream_s']:.2f} s wall; "
          f"streaming engine fused vs module over {n} utterances "
          f"({n_chunks} chunks that carried frames): posteriors within "
          f"{stream_err:.2e}, results agree ({fires} detections) [{card}]",
          flush=True)
    return out


def phase15b_ctc_recipe(dev, card, tmp):
    """examples/synthetic_ctc end to end through the port's CLIs: the
    corpus (gen_data_torch.py, seed 17), bin.train --dict 2 epochs,
    average, score_ctc (fused FSMN; --device_decode against the same
    batched search on the CPU), compute_det_ctc, stream_score_ctc.
    Returns the FSMN launches and the generated test list."""
    import torch

    from wekws_tpu_torch.bin import average_model, train
    from wekws_tpu_torch.bin.common import load_test_setup, make_forward_fn
    from wekws_tpu_torch.data import init_dataset
    from wekws_tpu_torch.eval import (
        build_keywords_token,
        compare_ctc_score_files,
        write_ctc_score_file,
    )
    from wekws_tpu_torch.text import CharTokenizer

    data = corpus("ctc")
    made = os.path.join(os.path.dirname(data), "dict", "dict.txt")
    with open(made) as f, open(os.path.join(CTC_RECIPE, "dict",
                                            "dict.txt")) as g:
        if f.read() != g.read():
            raise AssertionError("gen_data_torch.py's dict differs from the "
                                 "committed dict/dict.txt")
    lists = {s: os.path.join(data, f"{s}.list")
             for s in ("train", "dev", "test")}
    exp = os.path.join(tmp, "exp")
    t0 = time.perf_counter()
    with TimeLimit(RECIPE_TIMEOUT_S, "bin.train --dict"):
        run_cli(train.main, [
            "--config", os.path.join(CTC_RECIPE, "conf_torch",
                                     "fsmn_ctc.yaml"),
            "--train_data", lists["train"], "--cv_data", lists["dev"],
            "--model_dir", exp, "--dict", os.path.join(CTC_RECIPE, "dict"),
            "--seed", "888", "--cmvn_file",
            os.path.join(CTC_RECIPE, "data", "global_cmvn"), "--norm_var",
            "--num_epochs", str(CTC_RECIPE_EPOCHS), "--num_workers",
            str(RECIPE_WORKERS), "--device", dev.type], "bin.train --dict")
    train_s = time.perf_counter() - t0
    import yaml

    with open(os.path.join(exp, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    cv_losses = []
    for e in range(CTC_RECIPE_EPOCHS):
        with open(os.path.join(exp, f"{e}.yaml")) as f:
            cv_losses.append(float(yaml.safe_load(f)["cv_loss"]))
    train_losses = [r["train_loss"] for r in records]
    with open(os.path.join(exp, "config.yaml")) as f:
        vocab = yaml.safe_load(f)["model"]["output_dim"]
    if len(records) != CTC_RECIPE_EPOCHS or vocab != CTC_RECIPE_VOCAB or not np.isfinite(
            train_losses + cv_losses).all():
        raise AssertionError(f"bin.train --dict: train losses "
                             f"{train_losses}, cv losses {cv_losses}, "
                             f"output_dim {vocab}")
    rates = [r["audio_seconds_per_s"] for r in records]
    print(f"  corpus 480/96/192 (gen_data_torch.py, seed 17); bin.train "
          f"--dict {CTC_RECIPE_EPOCHS} epochs of "
          f"{', '.join(str(r['batches']) for r in records)} steps: train "
          f"losses {[round(v, 4) for v in train_losses]}, cv losses "
          f"{[round(v, 4) for v in cv_losses]}, {vocab} tokens; wall "
          f"{train_s:.1f} s, train rate "
          f"{', '.join(f'{x:.1f}' for x in rates)} audio-s/s [{card}]",
          flush=True)
    avg = os.path.join(exp, f"avg_{CTC_RECIPE_EPOCHS}.pt")
    average_model.main(["--dst_model", avg, "--src_path", exp, "--num",
                        str(CTC_RECIPE_EPOCHS), "--val_best", "--device",
                        dev.type])
    out = ctc_score_paths(dev, card, "synthetic CTC recipe, averaged",
                          os.path.join(exp, "config.yaml"), avg,
                          lists["test"], exp)
    # --device_decode on the card against the same batched search on the
    # CPU over the card's posteriors (on this 2-epoch model the batched
    # search parts from the host decoder, whose 1e-6 gates on pb and pnb
    # it lacks, in the JAX package as in the port)
    tokenizer = CharTokenizer(os.path.join(CTC_RECIPE, "dict", "dict.txt"),
                              unk="<filler>", split_with_space=True)
    kw_token, idxset = build_keywords_token([CTC_RECIPE_KEYWORD], tokenizer)
    _, model, pipeline, test_conf = load_test_setup(
        os.path.join(exp, "config.yaml"), avg, 256, dev)
    cpu_dd = os.path.join(exp, "score_dd_cpu.txt")
    write_ctc_score_file(
        make_forward_fn(model, pipeline, dev, softmax=True),
        init_dataset(lists["test"], test_conf, tokenizer, split="test"),
        kw_token, idxset, cpu_dd, device_decode=True,
        device=torch.device("cpu"))
    flips, err = compare_ctc_score_files(out["score_dd"], cpu_dd)
    if flips or not err <= CTC_SCORE_TOL:
        raise AssertionError(f"--device_decode on the card vs the CPU: "
                             f"flips {flips}, scores {err}")
    print(f"  --device_decode on the card vs the same search on the CPU: "
          f"0 flips, scores within {err:.3f} (bound {CTC_SCORE_TOL}) "
          f"[{card}]", flush=True)
    return out["launches"], lists["test"]


def phase15c_ctc_fixture(dev, card, tmp, test_list):
    """The JAX-trained fixture (avg_5.ckpt, its bfloat16 config, the
    dtype dropped and logged) scored, decoded, DET-evaluated and streamed
    on the card; read against the committed TPU files."""
    import logging

    from wekws_tpu_torch.eval import compare_ctc_score_files

    config, fconf = fixture_config(CTC_FIXTURE, CTC_RECIPE, tmp,
                                   "fsmn_ctc_fixture.yaml")
    out_dir = os.path.join(tmp, "fixture")
    os.makedirs(out_dir)
    dropped = []

    class Dropped(logging.Handler):
        def emit(self, record):
            if "dropped for inference" in record.getMessage():
                dropped.append(record.getMessage())

    handler = Dropped()
    logging.getLogger().addHandler(handler)
    try:
        out = ctc_score_paths(dev, card, "JAX fixture avg_5.ckpt "
                              f"(dtype {fconf['model']['dtype']})", config,
                              os.path.join(CTC_FIXTURE, "avg_5.ckpt"),
                              test_list, out_dir)
    finally:
        logging.getLogger().removeHandler(handler)
    if not dropped:
        raise AssertionError("the fixture's bfloat16 dtype was not dropped "
                             "with a log line")
    if not out["stream_fires"]:
        raise AssertionError("fixture: the streaming engine never fired")
    if out["dd_flips"] or not out["dd_err"] <= CTC_SCORE_TOL:
        raise AssertionError(f"fixture: --device_decode vs the host decoder:"
                             f" flips {out['dd_flips']}, scores "
                             f"{out['dd_err']}")
    readings = {}
    for name, committed, tol in (
            ("score", "score.txt", CTC_FIXTURE_SCORE_TOL),
            ("stream", "stream_score.txt", CTC_FIXTURE_STREAM_TOL)):
        flips, err = compare_ctc_score_files(out[name], os.path.join(
            CTC_FIXTURE, committed))
        readings[name] = (flips, err)
        if flips or not err <= tol:
            raise AssertionError(f"fixture {name} vs committed {committed}: "
                                 f"flips {flips}, largest score error {err} "
                                 f"(bound {tol})")
    want = np.loadtxt(os.path.join(CTC_FIXTURE, "stats.1_2_3.txt"))
    got = np.asarray(out["rows"])
    with open(out["stats"]) as f, open(os.path.join(
            CTC_FIXTURE, "stats.1_2_3.txt")) as g:
        same = f.read() == g.read()
    diff = np.abs(got - want).max(axis=0) if got.shape == want.shape else None
    # one utterance of 96 moved across a threshold: 1/96 of FRR, one false
    # alarm over the filler hours
    fa_unit = float(want[:, 1][want[:, 1] > 0.01].min())
    if diff is None or diff[0] > 1e-9 or diff[2] > 1 / 96 + 1e-6 or \
            diff[1] > fa_unit + 1e-6:
        raise AssertionError(f"fixture stats vs committed: shapes "
                             f"{got.shape} {want.shape}, largest differences "
                             f"{diff}")
    print(f"  JAX fixture against its committed TPU files (bfloat16): "
          f"score.txt {len(readings['score'][0])} flips, largest score "
          f"error {readings['score'][1]:.3f} (bound "
          f"{CTC_FIXTURE_SCORE_TOL}); stream_score.txt "
          f"{len(readings['stream'][0])} flips, {readings['stream'][1]:.3f} "
          f"(bound {CTC_FIXTURE_STREAM_TOL}); stats.1_2_3.txt "
          f"{'byte-identical' if same else 'differs'} (largest FRR "
          f"difference {diff[2]:.4f}, FA/h {diff[1]:.4f}); --device_decode "
          f"vs host decoder: 0 flips, scores within {out['dd_err']:.3f}; "
          f"dtype drop logged: {dropped[0]!r} [{card}]", flush=True)
    return out["launches"]


def phase15_ctc(dev, card, work):
    """Path D, CTC: 15a training at full width, 15b the recipe, 15c the
    JAX fixture.  Returns the fused_fsmn_layers launches of each path."""
    import tempfile

    launches = {}
    launches["train_offline"] = phase15a_ctc_training(dev, card,
                                                      work)["offline"]
    with tempfile.TemporaryDirectory() as tmp:
        recipe, test_list = phase15b_ctc_recipe(dev, card, tmp)
        fixture = phase15c_ctc_fixture(dev, card, tmp, test_list)
    for tag, counts in (("recipe", recipe), ("fixture", fixture)):
        for name, n in counts.items():
            launches[f"{tag}_{name}"] = n
    return launches


# ---------------------------------------------------------------------------
# phase 16, path E: classification and the other backbones
# ---------------------------------------------------------------------------

SC_CONF = os.path.join("examples", "speechcommand_v1", "conf", "mdtc.yaml")
SC_INPUT_DIM, SC_CLASSES = 80, 12  # MFCC 80; the 12 Speech Commands v1 classes
SC_TRAIN_B, SC_SECONDS = 100, 1  # the recipe's batch_size, 1 s clips
SC_STEPS_PLAIN, SC_STEPS_AUG = 5, 2
# step-0 gradients of the head (after the pooling, no BatchNorm behind
# it) against float64, relative to each tensor's largest |grad|; the
# blocks keep GRAD64_TOL
HEAD_GRAD64_TOL = 1e-3
COMMANDS_RECIPE = os.path.join("examples", "synthetic_commands")
COMMANDS_FIXTURE = os.path.join(COMMANDS_RECIPE, "exp", "mdtc_ce")
COMMANDS_CLASSES, COMMANDS_EPOCHS = 8, 2  # the recipe's 15 (MDTC), 30 (GRU)
# examples/synthetic_commands/README.md: the fixture's test accuracy on
# the TPU (bfloat16).  The port at float32 reads the same 248 on the CPU
# (tests/test_torch_accuracy.py, 0 flips against JAX at float32; the
# smallest top-two logit margin 0.032), so the card may differ by 0
COMMANDS_README_CORRECT, COMMANDS_TEST_UTTS = 248, 256
COMMANDS_FIXTURE_FLIPS = 0
GRU_CONF = os.path.join("examples", "hi_xiaowen", "conf", "gru.yaml")
TCN_CONF = os.path.join("examples", "hi_xiaowen", "conf", "tcn.yaml")
GRU_TRAIN_B, GRU_SECONDS, GRU_STEPS = 256, 2, 3
GRU_LOSS64_RTOL, GRU_GRAD64_TOL = 1e-5, 1e-3
KWS_KEYWORDS = 2  # hi_xiaowen: "hi xiaowen", "nihao wenwen"


# the generated corpora that several phases read (15b, 17c, 19c, 21e the
# CTC one; 16b the commands one), each made once, beside the kernel
# build: {name: (its generator, the generator's options)}
CORPORA = {
    "ctc": (os.path.join(CTC_RECIPE, "local", "gen_data_torch.py"), ()),
    "commands": (os.path.join(COMMANDS_RECIPE, "local", "gen_data_torch.py"),
                 ("--classes", str(COMMANDS_CLASSES))),
}
_corpus_jobs = {}


def corpus_root(name):
    from wekws_tpu_torch.ops import cuda_build

    return os.path.join(cuda_build.BUILD_DIR, "chip_smoke", "corpora", name)


def start_corpus(name):
    """CORPORA[name]'s generator into ``corpus_root(name)``/data, started
    (the CPU alone; its dict/ lands beside data/, as in a recipe)."""
    import shutil

    root = corpus_root(name)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    repo = os.path.abspath(os.path.dirname(__file__) or ".")
    gen, options = CORPORA[name]
    with open(os.path.join(root, "gen.log"), "w") as log:
        _corpus_jobs[name] = subprocess.Popen(
            [sys.executable, os.path.join(repo, gen), "data", *options],
            cwd=root, env=dict(os.environ, PYTHONPATH=repo), stdout=log,
            stderr=subprocess.STDOUT)


def stop_corpora():
    for proc in _corpus_jobs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    _corpus_jobs.clear()


def corpus(name):
    """The data directory of CORPORA[name]: its generator, started beside
    the build, waited for; or run now where none was started and none
    finished before (a fresh process finds the one that the first
    reader marked done)."""
    root = corpus_root(name)
    done = os.path.join(root, "done")
    if name not in _corpus_jobs and not os.path.exists(done):
        start_corpus(name)
    proc = _corpus_jobs.pop(name, None)
    if proc is not None:
        try:
            code = proc.wait(300)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if code != 0:
            with open(os.path.join(root, "gen.log")) as f:
                raise AssertionError(f"{CORPORA[name][0]} exited {code}:\n"
                                     f"{f.read()[-3000:]}")
        open(done, "w").close()
    return os.path.join(root, "data")


def recipe_yaml(path):
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


def class_batch(rng, b, seconds, classes):
    """``b`` utterances of ``seconds``: labels 0..classes-1 from the seed,
    each a class tone (300 + 100 k Hz) over noise."""
    n = seconds * RATE
    t = np.arange(n) / RATE
    target = rng.integers(0, classes, b).astype(np.int32)
    waves = rng.standard_normal((b, n)) * 300
    waves += 3000 * np.sin(2 * np.pi * (300 + 100 * target[:, None])
                           * t[None, :])
    return {"waves": np.clip(waves, -32768, 32767).astype(np.float32),
            "wave_lengths": np.full((b,), n, np.int32), "target": target,
            "target_lengths": np.ones((b,), np.int32)}


class NoDropout:
    """Within the ``with``, every ``nn.Dropout`` of the models drops
    nothing: the step-0 comparisons hold the routes' arithmetic, not two
    draws of the mask."""

    def __init__(self, *models):
        import torch

        self.mods = [m for model in models for m in model.modules()
                     if isinstance(m, torch.nn.Dropout)]

    def __enter__(self):
        self.saved = [m.p for m in self.mods]
        for m in self.mods:
            m.p = 0.0
        return self

    def __exit__(self, *exc):
        for m, p in zip(self.mods, self.saved):
            m.p = p
        return False


class Routes:
    """Within the ``with``, records the ``route`` of every forward that
    ``bin.common.make_forward_fn`` returns (the CLIs import it when
    called)."""

    def __enter__(self):
        from wekws_tpu_torch.bin import common

        self.routes, self._real = [], common.make_forward_fn

        def recorded(*args, **kwargs):
            forward = self._real(*args, **kwargs)
            self.routes.append(forward.route)
            return forward

        common.make_forward_fn = recorded
        return self

    def __exit__(self, *exc):
        from wekws_tpu_torch.bin import common

        common.make_forward_fn = self._real
        return False


def mdtc_kernel_times(backbone, b, t, dev):
    """The MDTC serving kernel with ``backbone``'s folded weights on
    random (b, t, C) inputs: (per-call ms, plain ms) as
    ``kernel_vs_plain_ms``, and the kernel's device ms."""
    import torch

    from wekws_tpu_torch.ops.fused_mdtc import (
        extract_mdtc_weights,
        fused_mdtc_forward,
        fused_mdtc_forward_plain,
    )

    *stacks, dil = extract_mdtc_weights(backbone)
    w = [x.to(dev) for x in stacks]
    x = torch.randn((b, t, backbone.res_channels),
                    generator=torch.Generator().manual_seed(SEED)).to(dev)
    k, size = backbone.kernel_size, backbone.stack_size

    def kern():
        return fused_mdtc_forward(x, *w, dil, k, size)

    ms, plain_ms = kernel_vs_plain_ms(
        kern, lambda: fused_mdtc_forward_plain(x, *w, dil, k, size))
    return ms, plain_ms, profiled_device_ms(kern, "fused_mdtc_kernel")


def sc_confs():
    """examples/speechcommand_v1/conf/mdtc.yaml and 16a's dataset
    configs: the fused frontend with wave dither; without dither and
    spec_aug; that unfused."""
    configs = recipe_yaml(SC_CONF)
    dconf = copy.deepcopy(configs["dataset_conf"])
    dconf["fused_frontend"] = True
    dconf["mfcc_conf"]["dither_mode"] = "wave"
    plain_dconf = dict(dconf, spec_aug=False,
                       mfcc_conf=dict(dconf["mfcc_conf"], dither=0.0))
    unfused_dconf = dict(plain_dconf, fused_frontend=False)
    return configs, dconf, plain_dconf, unfused_dconf


def sc_model_conf(configs, feats):
    """16a's model config: global CMVN from ``feats``, fused_train."""
    conf = dict(configs["model"], input_dim=SC_INPUT_DIM,
                output_dim=SC_CLASSES,
                cmvn={"mean": feats.mean(dim=(0, 1)).tolist(),
                      "istd": (1.0 / (feats.std(dim=(0, 1)) + 1e-6)
                               ).tolist(), "norm_var": True})
    conf["backbone"] = dict(conf["backbone"], fused_train=True)
    return conf


def phase16a_speech_commands(dev, card):
    """examples/speechcommand_v1/conf/mdtc.yaml at full width (MFCC 80
    of 80, MDTC 4 x 4, C=64, global head, 12 classes) with fused_train
    and fused_frontend, trained through ``Trainer(..., "ce")`` at B=100 x
    1 s, then served with the global head through ``fused_mdtc_kernel``.
    Returns path E's launches and kernel readings of this phase."""
    import torch

    from wekws_tpu_torch.data import DeviceFeaturePipeline
    from wekws_tpu_torch.losses import criterion
    from wekws_tpu_torch.models import init_model
    from wekws_tpu_torch.ops import fused_frontend
    from wekws_tpu_torch.ops.fused_mdtc import fused_mdtc_forward
    from wekws_tpu_torch.ops.fused_mdtc_train import (
        PASS_IDS,
        PASSES,
        kernel_name,
        reset_launches,
    )
    from wekws_tpu_torch.ops.serving import build_fused_forward
    from wekws_tpu_torch.train import Trainer

    configs, dconf, plain_dconf, unfused_dconf = sc_confs()
    batch = class_batch(np.random.default_rng(SEED + 16), SC_TRAIN_B,
                        SC_SECONDS, SC_CLASSES)
    waves = torch.as_tensor(batch["waves"], device=dev)
    lengths = torch.as_tensor(batch["wave_lengths"], device=dev)
    target = torch.as_tensor(batch["target"], device=dev).long()
    # step 0's features: once, by the unfused frontend, shared by every
    # route; the fused frontend against them at phase 9's limits
    cvp = DeviceFeaturePipeline.from_conf(unfused_dconf, training=False)
    fused_cvp = DeviceFeaturePipeline.from_conf(dconf, training=False)
    with torch.no_grad():
        feats, feat_lengths = cvp(waves, lengths)
        fused_feats = fbank_call(fused_cvp.extractor, waves, "fft")
    torch.cuda.synchronize()
    cfg = fused_cvp.extractor.cfg
    fbank_err = check_close(
        f"fused_fbank ({SC_TRAIN_B}, {SC_SECONDS * RATE}) MFCC "
        f"{cfg.num_ceps} of {cfg.num_mel_bins}, FFT plan, vs the "
        f"three-matmul plain version", fused_feats, feats, atol=FBANK_ATOL,
        rtol=FBANK_RTOL)
    conf = sc_model_conf(configs, feats)
    unfused_conf = dict(conf, backbone=dict(conf["backbone"],
                                            fused_train=False))
    model = init_model(conf, torch.Generator().manual_seed(SEED))
    twin = init_model(unfused_conf)
    twin.load_state_dict(model.state_dict())
    ref = init_model(unfused_conf)
    ref.load_state_dict(model.state_dict())
    model, twin = model.to(dev), twin.to(dev)
    ref = ref.to(dev, torch.float64)
    n_params = sum(p.numel() for p in model.parameters())

    # step 0: the fused and unfused fp32 routes and float64, dropout off
    losses0 = {}
    with NoDropout(model, twin, ref):
        for route, m, x in (("fused", model, feats), ("unfused", twin, feats),
                            ("float64", ref, feats.double())):
            m.train()
            logits, _ = m(x, lengths=feat_lengths)
            loss, _ = criterion("ce", logits, target, feat_lengths)
            m.zero_grad(set_to_none=True)
            loss.backward()
            losses0[route] = float(loss.detach())
    rel = abs(losses0["fused"] - losses0["unfused"]) / abs(losses0["unfused"])
    if not rel <= 1e-5:
        raise AssertionError(f"step-0 CE loss fused {losses0['fused']} vs "
                             f"unfused {losses0['unfused']}: {rel:.2e} rel")
    ref_groups = grad_groups(ref)
    share = {r: worst_grad_share(m, ref_groups, r)
             for r, m in (("fused", model), ("unfused", twin))}
    head = {}
    refs = dict(ref.named_parameters())
    for route, m in (("fused", model), ("unfused", twin)):
        worst = (0.0, "")
        for name, prm in m.named_parameters():
            if name.startswith("classifier."):
                g64 = refs[name].grad
                s = float((prm.grad.double() - g64).abs().max()) / max(
                    float(g64.abs().max()), 1e-12)
                worst = max(worst, (s, name))
        head[route] = worst
        if not worst[0] <= HEAD_GRAD64_TOL:
            raise AssertionError(f"step-0 head gradient {worst[1]} ({route}) "
                                 f"off float64 by {worst[0]:.2e} of its "
                                 f"largest |grad|")
    print(f"  speechcommand_v1 MDTC (MFCC {cfg.num_ceps}/{cfg.num_mel_bins},"
          f" 4 x 4, C=64, global head, {SC_CLASSES} classes, fused_train "
          f"+ fused_frontend): {n_params} parameters, B={SC_TRAIN_B} x "
          f"{SC_SECONDS} s, features {tuple(feats.shape)}; step 0 (dropout "
          f"off): CE loss fused {losses0['fused']:.6f} vs unfused "
          f"{losses0['unfused']:.6f} ({rel:.2e} rel, bound 1e-5), float64 "
          f"{losses0['float64']:.6f}; gradients vs float64, each block "
          f"within {GRAD64_TOL} of its own largest |grad|: worst fused "
          f"{share_text(share['fused'])}, unfused "
          f"{share_text(share['unfused'])}; head within {HEAD_GRAD64_TOL}: "
          f"fused {head['fused'][0]:.2e} ({head['fused'][1]}), unfused "
          f"{head['unfused'][0]:.2e} [{card}]", flush=True)

    # the main path: Trainer steps with the fused passes and fbank, the
    # counts zeroed just before; no plain version on a CUDA tensor
    model.zero_grad(set_to_none=True)
    trainer = Trainer(model, DeviceFeaturePipeline.from_conf(plain_dconf),
                      fused_cvp, "ce", grad_clip=5.0,
                      weight_decay=configs["optim_conf"]["weight_decay"],
                      device=dev)
    state = trainer.init_state()
    reset_launches()
    fused_frontend.fused_fbank.launches = 0
    losses, aug_losses = [], []
    with PlainOnCuda() as plain:
        for _ in range(SC_STEPS_PLAIN):
            state, metrics = trainer.train_step(state, batch, SEED, 1e-3)
            losses.append(float(metrics["loss"]))
        trainer.pipeline = DeviceFeaturePipeline.from_conf(dconf)
        for _ in range(SC_STEPS_AUG):
            state, metrics = trainer.train_step(state, batch, SEED, 1e-3)
            aug_losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
    plain.check("speechcommand_v1 training")
    steps = SC_STEPS_PLAIN + SC_STEPS_AUG
    n_blocks = 1 + 4 * 4
    counts = {f"fused_train_{n}": PASSES[n].launches for n in TRAIN_PASSES}
    counts["fused_fbank"] = fused_frontend.fused_fbank.launches
    want = {k: (steps if k == "fused_fbank" else n_blocks * steps)
            for k in counts}
    if counts != want:
        raise AssertionError(f"launches over {steps} steps: {counts}, want "
                             f"{want}")
    if not (np.isfinite(losses + aug_losses).all()
            and losses[-1] < losses[0]):
        raise AssertionError(f"CE losses {losses}, with augmentation "
                             f"{aug_losses}")
    print(f"  losses, no augmentation: {[round(v, 5) for v in losses]}; with "
          f"wave dither 1.0 + spec_aug: {[round(v, 5) for v in aug_losses]};"
          f" each pass launched {n_blocks} x {steps} times, fused_fbank "
          f"{steps}, no plain version on a CUDA tensor [{card}]", flush=True)

    # times: the step (host clock), its device time, each kernel's
    t = int(feat_lengths[0])
    names = [kernel_name(n, 64) for n in TRAIN_PASSES] + [
        f"reduce_kernel<{PASS_IDS[n]}>" for n in TRAIN_PASSES if n != "f4"]
    names.append("fused_fbank_kernel")

    def one_step():
        trainer.train_step(state, batch, SEED, 1e-3)

    step_ms, lo, hi = timed_steps(one_step)
    # each kernel's device time in the step; the step's idle share is
    # traced in a fresh process (16e)
    _, _, dev_ms = profiled_step(one_step, names)
    audio = SC_TRAIN_B * SC_SECONDS
    print(f"  train step B={SC_TRAIN_B} x {SC_SECONDS} s (fused_train + "
          f"fused_frontend, dither + spec_aug): median {step_ms:.3f} ms of "
          f"10 ({audio / step_ms * 1e3:.1f} audio-s/s), min {lo:.3f}, max "
          f"{hi:.3f} [{card}]", flush=True)
    readings = {}
    for n in TRAIN_PASSES:
        main = dev_ms[kernel_name(n, 64)]
        red = 0.0 if n == "f4" else dev_ms[f"reduce_kernel<{PASS_IDS[n]}>"]
        if main is None or red is None:
            raise AssertionError(f"pass {n}: its kernel or reduction is not "
                                 f"in the profiled step")
        bound, by = train_pass_bound_ms(n, SC_TRAIN_B, t, 64, 5)
        readings[f"fused_train_{n}"] = {
            "shape": f"B={SC_TRAIN_B} T={t} C=64", "device_ms": main + red,
            "bound_ms": bound, "bound_by": by}
    fb = fused_cvp.extractor
    bound, by = fbank_bound_ms(SC_TRAIN_B, SC_SECONDS * RATE,
                               cfg.frame_length, cfg.frame_shift,
                               cfg.padded_window_size, fb.n_band,
                               cfg.num_mel_bins, cfg.feat_dim, mfcc=True)
    ms, plain_ms = kernel_vs_plain_ms(lambda: fused_cvp.extractor(waves),
                                      lambda: cvp.extractor(waves))
    readings["fused_fbank"] = {
        "shape": f"waves ({SC_TRAIN_B}, {SC_SECONDS * RATE}) MFCC "
                 f"{cfg.num_ceps} of {cfg.num_mel_bins}",
        "device_ms": dev_ms["fused_fbank_kernel"], "bound_ms": bound,
        "bound_by": by, "max_abs_err": fbank_err, "ms": ms,
        "plain_ms": plain_ms}
    if readings["fused_fbank"]["device_ms"] is None:
        raise AssertionError("fused_fbank_kernel is not in the profiled step")
    print(f"  fused_fbank per call {ms:.4f} ms, the unfused extractor "
          f"{plain_ms:.4f} ms (CUDA events) [{card}]", flush=True)
    print("  path E kernels in the step (device ms per call, with its "
          "reduction; bound): " + "; ".join(
              f"{k} {v['device_ms']:.4f} ({v['bound_ms']:.5f}, "
              f"{v['bound_by']})" for k, v in readings.items())
          + f" [{card}]", flush=True)

    # served with the global head: one fused_mdtc_kernel launch
    served = init_model(conf)
    served.load_state_dict(state.model.state_dict())
    served = served.to(dev).eval()
    forward = build_fused_forward(served, device=dev)
    with torch.no_grad():
        sfeats, slengths = fused_cvp(waves, lengths)
    fused_mdtc_forward.launches = 0
    with PlainOnCuda() as plain:
        logits = forward(sfeats, slengths)
        torch.cuda.synchronize()
    plain.check("speechcommand_v1 served")
    served_launches = fused_mdtc_forward.launches
    with torch.inference_mode():
        module_logits, _ = served(sfeats, lengths=slengths)
    err = check_close(f"speechcommand_v1 served, global head: "
                      f"build_fused_forward {tuple(logits.shape)} logits vs "
                      f"module forward", logits, module_logits)
    if served_launches != 1 or tuple(logits.shape) != (SC_TRAIN_B,
                                                       SC_CLASSES):
        raise AssertionError(f"served: {served_launches} fused_mdtc_kernel "
                             f"launches (want 1), logits "
                             f"{tuple(logits.shape)}")
    mdtc = served.backbone
    pad_max = (mdtc.kernel_size - 1) * 8
    bound, by = mdtc_bound_ms(SC_TRAIN_B, t, 64, 17, mdtc.kernel_size, 4,
                              pad_max, False)
    ms, plain_ms, dev_ms = mdtc_kernel_times(mdtc, SC_TRAIN_B, t, dev)
    readings["fused_mdtc_forward"] = {
        "shape": f"B={SC_TRAIN_B} T={t} C=64", "device_ms": dev_ms,
        "bound_ms": bound, "bound_by": by, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms}
    acc = float((logits.argmax(-1) == target).float().mean())
    print(f"  served B={SC_TRAIN_B}: {served_launches} fused_mdtc_kernel "
          f"launch, device {dev_ms} ms "
          f"(bound {bound:.5f}, {by}), per call {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms; training-batch accuracy after {steps} steps "
          f"{acc:.2f} [{card}]", flush=True)
    launches = dict(counts, fused_mdtc_forward=served_launches)
    return {"launches": launches, "readings": readings, "step_ms": step_ms}


def classify_fused_vs_module(config, checkpoint, test_list, dev, tag):
    """The checkpoint's logits on the test list through the card's route
    (``make_forward_fn``, which must be ``fused``) and through the
    module route on the card: within TOL, the same argmax on every
    utterance.  Returns (error, utterances, model, the last batch's
    (B, T) of features)."""
    import torch

    from wekws_tpu_torch.bin.common import load_test_setup, make_forward_fn
    from wekws_tpu_torch.data import init_dataset

    _, model, pipeline, test_conf = load_test_setup(config, checkpoint, 256,
                                                    dev)
    forward = make_forward_fn(model, pipeline, dev)
    if forward.route != "fused":
        raise AssertionError(f"{tag}: route {forward.route}, want fused")
    err, n, last = 0.0, 0, None
    for batch in init_dataset(test_list, test_conf, split="test"):
        got, lens = forward(batch)
        waves = torch.as_tensor(batch["waves"]).to(dev, torch.float32)
        wl = torch.as_tensor(batch["wave_lengths"]).to(dev)
        with torch.inference_mode():
            feats, feat_lengths = pipeline(waves, wl)
            want, _ = model(feats, lengths=feat_lengths)
        last = tuple(feats.shape[:2])
        got = torch.as_tensor(got, device=dev)
        err = max(err, check_close(f"{tag}: fused route vs module route, "
                                   f"logits {tuple(got.shape)}", got, want))
        flips = int((got.argmax(-1) != want.argmax(-1)).sum())
        if flips:
            raise AssertionError(f"{tag}: {flips} argmax differ between the "
                                 f"routes")
        n += got.shape[0]
    return err, n, model, last


def run_accuracy(argv, what):
    """bin.compute_accuracy through ``run_cli``, its routes recorded:
    ((correct, total), routes, seconds)."""
    from wekws_tpu_torch.bin import compute_accuracy

    t0 = time.perf_counter()
    with Routes() as routes:
        out = run_cli(compute_accuracy.main, argv, what)
    return out, routes.routes, time.perf_counter() - t0


def phase16b_commands_recipe(dev, card, tmp):
    """examples/synthetic_commands through the port's CLIs: the corpus
    (gen_data_torch.py, seed 11), bin.train 2 epochs, average --val_best,
    bin.compute_accuracy on the card for conf_torch/mdtc_ce.yaml (route
    fused) and conf/gru_ce.yaml (route module, no kernel launch, the
    accuracy the CPU prints).  Returns the test list and the MDTC CLI's
    fused_mdtc_forward launches."""
    import torch

    from wekws_tpu_torch.bin import average_model, train
    from wekws_tpu_torch.ops import fused_frontend
    from wekws_tpu_torch.ops.fused_mdtc import fused_mdtc_forward
    from wekws_tpu_torch.ops.fused_mdtc_train import PASSES, reset_launches

    data = corpus("commands")
    lists = {s: os.path.join(data, f"{s}.list")
             for s in ("train", "dev", "test")}
    cmvn = os.path.join(COMMANDS_RECIPE, "data", "global_cmvn")
    mdtc_launches = None
    for tag, config, want_route in (
            ("mdtc", os.path.join(COMMANDS_RECIPE, "conf_torch",
                                  "mdtc_ce.yaml"), "fused"),
            ("gru", os.path.join(COMMANDS_RECIPE, "conf", "gru_ce.yaml"),
             "module")):
        exp = os.path.join(tmp, f"exp_{tag}")
        t0 = time.perf_counter()
        with TimeLimit(RECIPE_TIMEOUT_S, f"bin.train {tag}"):
            run_cli(train.main, [
                "--config", config, "--train_data", lists["train"],
                "--cv_data", lists["dev"], "--model_dir", exp,
                "--num_keywords", str(COMMANDS_CLASSES), "--seed", "777",
                "--cmvn_file", cmvn, "--norm_var", "--num_epochs",
                str(COMMANDS_EPOCHS), "--num_workers", "1", "--device",
                dev.type], f"bin.train {tag}")
        train_s = time.perf_counter() - t0
        with open(os.path.join(exp, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        train_losses = [r["train_loss"] for r in records]
        cv_losses = [float(recipe_yaml(os.path.join(exp, f"{e}.yaml"))
                           ["cv_loss"]) for e in range(COMMANDS_EPOCHS)]
        if len(records) != COMMANDS_EPOCHS or not np.isfinite(
                train_losses + cv_losses).all():
            raise AssertionError(f"{tag}: train losses {train_losses}, cv "
                                 f"losses {cv_losses}")
        avg = os.path.join(exp, "avg.pt")
        average_model.main(["--dst_model", avg, "--src_path", exp, "--num",
                            str(COMMANDS_EPOCHS), "--val_best", "--device",
                            dev.type])
        # the CLI on the card: every kernel count zeroed just before
        reset_launches()
        fused_frontend.fused_fbank.launches = 0
        fused_mdtc_forward.launches = 0
        argv = ["--config", os.path.join(exp, "config.yaml"), "--test_data",
                lists["test"], "--checkpoint", avg]
        with TimeLimit(RECIPE_TIMEOUT_S, f"compute_accuracy {tag}"):
            (correct, total), routes, acc_s = run_accuracy(
                argv + ["--device", dev.type], f"compute_accuracy {tag}")
        counts = {"fused_mdtc_forward": fused_mdtc_forward.launches,
                  "fused_fbank": fused_frontend.fused_fbank.launches,
                  **{n: PASSES[n].launches for n in TRAIN_PASSES}}
        if routes != [want_route] or total != COMMANDS_TEST_UTTS:
            raise AssertionError(f"compute_accuracy {tag}: routes {routes} "
                                 f"(want [{want_route}]), {total} "
                                 f"utterances")
        if tag == "mdtc":
            mdtc_launches = counts.pop("fused_mdtc_forward")
            err, n, _, _ = classify_fused_vs_module(
                os.path.join(exp, "config.yaml"), avg, lists["test"], dev,
                f"synthetic_commands MDTC ({COMMANDS_EPOCHS} epochs)")
            # one batch of 256: one launch
            if mdtc_launches != 1 or any(counts.values()):
                raise AssertionError(f"compute_accuracy mdtc: "
                                     f"fused_mdtc_forward {mdtc_launches} "
                                     f"(want 1), others {counts}")
            extra = (f"{mdtc_launches} fused_mdtc_kernel launch; logits vs "
                     f"the module route within {err:.2e}, the same argmax "
                     f"on all {n}")
        else:
            if any(counts.values()):
                raise AssertionError(f"compute_accuracy gru: kernel "
                                     f"launches {counts}, want none")
            with TimeLimit(RECIPE_TIMEOUT_S, "compute_accuracy gru, CPU"):
                (cpu_correct, cpu_total), cpu_routes, _ = run_accuracy(
                    argv + ["--device", "cpu"], "compute_accuracy gru cpu")
            if (cpu_correct, cpu_total) != (correct, total):
                raise AssertionError(f"compute_accuracy gru: card "
                                     f"{correct}/{total}, CPU "
                                     f"{cpu_correct}/{cpu_total}")
            extra = (f"no kernel launch; the CPU prints the same "
                     f"{cpu_correct}/{cpu_total}")
        print(f"  synthetic_commands {tag}: bin.train {COMMANDS_EPOCHS} "
              f"epochs in {train_s:.1f} s (train losses "
              f"{[round(v, 4) for v in train_losses]}, cv losses "
              f"{[round(v, 4) for v in cv_losses]}); compute_accuracy on the "
              f"card: Accuracy {correct / total:.6f} ({correct}/{total}) in "
              f"{acc_s:.2f} s, route {routes[0]}, {extra} [{card}]",
              flush=True)
    return lists["test"], mdtc_launches


def phase16c_commands_fixture(dev, card, tmp, test_list):
    """The JAX fixture examples/synthetic_commands/exp/mdtc_ce/avg_5.ckpt
    (its bfloat16 config: the dtype dropped, logged) through
    bin.compute_accuracy on the card, logits against the module route,
    the count against the README's TPU run.  Returns its launches and
    the kernel's reading at the fixture's shape (C=32)."""
    import logging

    import torch
    import yaml

    from wekws_tpu_torch.ops.fused_mdtc import fused_mdtc_forward

    fconf = recipe_yaml(os.path.join(COMMANDS_FIXTURE, "config.yaml"))
    fconf["model"]["cmvn"]["cmvn_file"] = os.path.abspath(
        os.path.join(COMMANDS_RECIPE, "data", "global_cmvn"))
    config = os.path.join(tmp, "mdtc_ce_fixture.yaml")
    with open(config, "w") as f:
        yaml.safe_dump(fconf, f)
    ckpt = os.path.join(COMMANDS_FIXTURE, "avg_5.ckpt")
    dropped = []

    class Dropped(logging.Handler):
        def emit(self, record):
            if "dropped for inference" in record.getMessage():
                dropped.append(record.getMessage())

    handler = Dropped()
    logging.getLogger().addHandler(handler)
    fused_mdtc_forward.launches = 0
    try:
        with TimeLimit(RECIPE_TIMEOUT_S, "compute_accuracy fixture"):
            (correct, total), routes, acc_s = run_accuracy(
                ["--config", config, "--test_data", test_list,
                 "--checkpoint", ckpt, "--device", dev.type],
                "compute_accuracy fixture")
        launches = fused_mdtc_forward.launches
    finally:
        logging.getLogger().removeHandler(handler)
    if not dropped or routes != ["fused"] or launches != 1:
        raise AssertionError(f"fixture: dtype drop logged {bool(dropped)}, "
                             f"routes {routes}, {launches} launches (want "
                             f"1)")
    err, n, model, (b, t) = classify_fused_vs_module(
        config, ckpt, test_list, dev, "JAX fixture mdtc_ce avg_5.ckpt")
    diff = abs(correct - COMMANDS_README_CORRECT)
    if total != COMMANDS_TEST_UTTS or diff > COMMANDS_FIXTURE_FLIPS:
        raise AssertionError(f"fixture accuracy {correct}/{total}, the "
                             f"README's TPU run {COMMANDS_README_CORRECT}/"
                             f"{COMMANDS_TEST_UTTS} (bound "
                             f"{COMMANDS_FIXTURE_FLIPS} apart)")
    mdtc = model.backbone
    c = mdtc.res_channels
    n_layers = 1 + mdtc.stack_num * mdtc.stack_size
    pad_max = (mdtc.kernel_size - 1) * 2 ** (mdtc.stack_size - 1)
    bound, by = mdtc_bound_ms(b, t, c, n_layers, mdtc.kernel_size,
                              mdtc.stack_num, pad_max, False)
    ms, plain_ms, dev_ms = mdtc_kernel_times(mdtc, b, t, dev)
    print(f"  JAX fixture mdtc_ce/avg_5.ckpt (dtype "
          f"{fconf['model']['dtype']} dropped, logged): compute_accuracy on "
          f"the card Accuracy {correct / total:.6f} ({correct}/{total}) in "
          f"{acc_s:.2f} s, beside the README's TPU run (bfloat16) "
          f"{COMMANDS_README_CORRECT}/{COMMANDS_TEST_UTTS}: {diff} apart "
          f"(bound {COMMANDS_FIXTURE_FLIPS}); route fused, {launches} "
          f"fused_mdtc_kernel launch at B={b} T={t} C={c}, device {dev_ms} "
          f"ms (bound {bound:.5f}, {by}), per call {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms; logits vs the module route within {err:.2e}, "
          f"the same argmax on all {n} [{card}]", flush=True)
    return launches, {"shape": f"B={b} T={t} C={c}", "device_ms": dev_ms,
                      "bound_ms": bound, "bound_by": by, "max_abs_err": err,
                      "ms": ms, "plain_ms": plain_ms}


def gru_setup(dev):
    """16d's dataset config (examples/hi_xiaowen/conf/gru.yaml), seeded
    batch (-1 filler, 0 and 1 keywords), cv pipeline, the batch's
    features and the GRU config with global CMVN from them."""
    import torch

    from wekws_tpu_torch.data import DeviceFeaturePipeline

    configs = recipe_yaml(GRU_CONF)
    dconf = configs["dataset_conf"]
    rng = np.random.default_rng(SEED + 17)
    batch = class_batch(rng, GRU_TRAIN_B, GRU_SECONDS, KWS_KEYWORDS + 1)
    batch["target"] = batch["target"] - 1
    cvp = DeviceFeaturePipeline.from_conf(dconf, training=False)
    with torch.no_grad():
        feats, feat_lengths = cvp(
            torch.as_tensor(batch["waves"], device=dev),
            torch.as_tensor(batch["wave_lengths"], device=dev))
    conf = dict(configs["model"], input_dim=40, output_dim=KWS_KEYWORDS,
                cmvn={"mean": feats.mean(dim=(0, 1)).tolist(),
                      "istd": (1.0 / (feats.std(dim=(0, 1)) + 1e-6)
                               ).tolist(), "norm_var": True})
    return dconf, batch, cvp, feats, feat_lengths, conf


def phase16d_other_backbones(dev, card, work, waves):
    """The hi_xiaowen GRU (fbank 40, H=128, 2 layers, max-pooling) at
    B=256 x 2 s through ``Trainer(..., "max_pooling")``: step 0 against
    float64 on the card, 3 steps, times, then streamed by
    ``BatchMaxPoolSpotter(use_fused=False)`` against the offline module
    forward; the hi_xiaowen full-conv TCN scored by the module route on
    the card against the CPU."""
    import torch
    import yaml

    from wekws_tpu_torch.bin.common import make_forward_fn
    from wekws_tpu_torch.data import DeviceFeaturePipeline
    from wekws_tpu_torch.frontend import compute_fbank_np
    from wekws_tpu_torch.losses import criterion
    from wekws_tpu_torch.models import GRU, init_model
    from wekws_tpu_torch.runtime import BatchMaxPoolSpotter
    from wekws_tpu_torch.runtime.keyword_spotter import (
        load_serving_model,
        load_spotter_config,
    )
    from wekws_tpu_torch.train import Trainer, save_checkpoint

    dconf, batch, cvp, feats, feat_lengths, conf = gru_setup(dev)
    target = torch.as_tensor(batch["target"], device=dev).long()
    model = init_model(conf, torch.Generator().manual_seed(SEED))
    ref = init_model(conf)
    ref.load_state_dict(model.state_dict())
    model, ref = model.to(dev), ref.to(dev, torch.float64)
    if not isinstance(model.backbone, GRU):
        raise AssertionError("gru.yaml did not build a GRU backbone")
    losses0 = {}
    for route, m, x in (("fp32", model, feats), ("float64", ref,
                                                 feats.double())):
        m.train()
        probs, _ = m(x, lengths=feat_lengths)
        loss, _ = criterion("max_pooling", probs, target, feat_lengths,
                            None, 50)
        m.zero_grad(set_to_none=True)
        loss.backward()
        losses0[route] = float(loss.detach())
    rel = abs(losses0["fp32"] - losses0["float64"]) / abs(losses0["float64"])
    worst = (0.0, "")
    refs = dict(ref.named_parameters())
    for name, prm in model.named_parameters():
        g64 = refs[name].grad
        worst = max(worst, (float((prm.grad.double() - g64).abs().max())
                            / max(float(g64.abs().max()), 1e-12), name))
    if not (rel <= GRU_LOSS64_RTOL and worst[0] <= GRU_GRAD64_TOL):
        raise AssertionError(f"GRU step 0 vs float64: loss {rel:.2e} rel, "
                             f"gradient {worst[1]} {worst[0]:.2e} of its "
                             f"largest")
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  hi_xiaowen GRU (fbank 40, H=128, 2 layers, max-pooling, "
          f"{KWS_KEYWORDS} keywords): {n_params} parameters, B={GRU_TRAIN_B} "
          f"x {GRU_SECONDS} s, features {tuple(feats.shape)}; step 0 vs "
          f"float64 on the card: loss {losses0['fp32']:.6f} ({rel:.2e} rel, "
          f"bound {GRU_LOSS64_RTOL}), worst gradient {worst[0]:.2e} of its "
          f"tensor's largest |grad| ({worst[1]}; bound {GRU_GRAD64_TOL}) "
          f"[{card}]", flush=True)
    model.zero_grad(set_to_none=True)
    trainer = Trainer(model, DeviceFeaturePipeline.from_conf(dconf), cvp,
                      "max_pooling", grad_clip=5.0, min_duration=50,
                      device=dev)
    state = trainer.init_state()
    losses = []
    with PlainOnCuda() as plain:
        for _ in range(GRU_STEPS):
            state, metrics = trainer.train_step(state, batch, SEED, 1e-3)
            losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
    plain.check("GRU training")
    if not np.isfinite(losses).all():
        raise AssertionError(f"GRU losses {losses}")

    def one_step():
        trainer.train_step(state, batch, SEED, 1e-3)

    step_ms, lo, hi = timed_steps(one_step, reps=5)
    audio = GRU_TRAIN_B * GRU_SECONDS
    print(f"  GRU losses {[round(v, 5) for v in losses]}; train step "
          f"B={GRU_TRAIN_B} x {GRU_SECONDS} s (dither 1.0; the recurrence "
          f"a float32 product and gates a frame, no cuDNN): median "
          f"{step_ms:.3f} ms of 5 ({audio / step_ms * 1e3:.1f} audio-s/s), "
          f"min {lo:.3f}, max {hi:.3f}; device time and idle share traced "
          f"in a fresh process (16e) [{card}]", flush=True)

    # streamed on the module engine against the offline module forward
    sconf = {"dataset_conf": dict(dconf), "model": conf}
    ckpt = os.path.join(work, "gru.pt")
    config_path = os.path.join(work, "gru.yaml")
    save_checkpoint(ckpt, state.model.state_dict())
    with open(config_path, "w") as f:
        yaml.safe_dump(sconf, f)
    _, cfg, _, _, _ = load_spotter_config(sconf)
    host = np.stack([compute_fbank_np(w.astype(np.float32), cfg)
                     for w in waves])
    served = load_serving_model(sconf, ckpt, cfg.feat_dim, device=dev)
    with torch.inference_mode():
        offline, _ = served(torch.as_tensor(host, device=dev))
    engine = BatchMaxPoolSpotter(ckpt, config_path, 0.5,
                                 num_streams=len(waves), step_frames=8,
                                 use_fused=False, device=dev)
    streamed = [[] for _ in waves]
    step_fn = engine._step_fn

    def capture(feats_b, active, reset, cache):
        probs, new_cache = step_fn(feats_b, active, reset, cache)
        out = probs.cpu().numpy()
        for i in np.flatnonzero(active):
            streamed[i].append(out[i])
        return probs, new_cache

    engine._step_fn = capture
    pcm = [w.astype("<i2").tobytes() for w in waves]
    with PlainOnCuda() as plain:
        for off in range(0, len(pcm[0]), 2 * CHUNK_SAMPLES):
            for i in range(len(pcm)):
                engine.accept_wave(i, pcm[i][off:off + 2 * CHUNK_SAMPLES])
            engine.step()
        engine.flush()
        torch.cuda.synchronize()
    plain.check("GRU streaming engine")
    n_frames = host.shape[1]
    got = torch.as_tensor(np.stack([np.concatenate(s)[:n_frames]
                                    for s in streamed]))
    err = check_close(f"GRU: BatchMaxPoolSpotter(use_fused=False), "
                      f"{len(waves)} streams in 8-frame steps, vs offline "
                      f"module posteriors", got, offline.cpu())
    stats = engine.stats
    print(f"  GRU streamed: {stats['dispatches']} steps of 8 frames x "
          f"{len(waves)} streams, mean step "
          f"{stats['dispatch_s'] * 1e3 / stats['dispatches']:.3f} ms (host "
          f"clock), cache {tuple(engine.cache.shape)}; within {err:.2e} of "
          f"offline [{card}]", flush=True)

    # the full-conv TCN: the module route on the card, held against the CPU
    tconf = recipe_yaml(TCN_CONF)
    tpipe = DeviceFeaturePipeline.from_conf(tconf["dataset_conf"],
                                            training=False)
    w16 = {"waves": waves.astype(np.float32),
           "wave_lengths": np.full((len(waves),), waves.shape[1], np.int32)}
    with torch.no_grad():
        tfeats, _ = tpipe(torch.as_tensor(w16["waves"]),
                          torch.as_tensor(w16["wave_lengths"]))
    gen = torch.Generator().manual_seed(SEED + 18)
    tcn, _ = seeded_model(
        dict(tconf["model"], input_dim=40, output_dim=KWS_KEYWORDS), gen,
        (tfeats.mean(dim=(0, 1)).numpy(),
         (1.0 / (tfeats.std(dim=(0, 1)) + 1e-6)).numpy()))
    cpu_fwd = make_forward_fn(copy.deepcopy(tcn).eval(), tpipe,
                              torch.device("cpu"))
    card_fwd = make_forward_fn(tcn.to(dev).eval(), tpipe, dev)
    with PlainOnCuda() as plain:
        got, got_l = card_fwd(w16)
        torch.cuda.synchronize()
    plain.check("full-conv TCN on the card")
    want, want_l = cpu_fwd(w16)
    if card_fwd.route != "module" or not np.array_equal(got_l, want_l):
        raise AssertionError(f"full-conv TCN: route {card_fwd.route}, want "
                             f"module")
    terr = check_close(f"hi_xiaowen full-conv TCN: make_forward_fn on the "
                       f"card (route {card_fwd.route}) vs the CPU, "
                       f"posteriors {got.shape}", torch.as_tensor(got),
                       torch.as_tensor(want))
    print(f"  hi_xiaowen full-conv TCN (4 layers, K=8, C=64): route "
          f"{card_fwd.route} on the card, within {terr:.2e} of the CPU "
          f"[{card}]", flush=True)
    return {"step_ms": step_ms}


def phase16_classification(dev, card, work, waves):
    """Path E: 16a the speechcommand_v1 MDTC trained at full width and
    served with the global head, 16b the synthetic commands recipe
    through the CLIs, 16c the JAX fixture, 16d the GRU and full-conv TCN,
    (16e, the idle shares of 15a's, 16a's and 16d's steps, come from
    path G's fresh process: ``idle_shares``).  Returns path E's launches
    per kernel record and the readings at its shapes."""
    import tempfile

    out = phase16a_speech_commands(dev, card)
    launches, readings = out["launches"], out["readings"]
    with tempfile.TemporaryDirectory() as tmp:
        test_list, recipe_launches = phase16b_commands_recipe(dev, card, tmp)
        fixture_launches, fixture_reading = phase16c_commands_fixture(
            dev, card, tmp, test_list)
    launches["fused_mdtc_forward"] += recipe_launches + fixture_launches
    readings["fused_mdtc_forward_c32"] = fixture_reading
    phase16d_other_backbones(dev, card, work, waves)
    return launches, readings


# ---------------------------------------------------------------------------
# phase 17, path F: the serving daemon
# ---------------------------------------------------------------------------

SERVE_STREAMS, SERVE_STEP = 64, 8  # path F's engines: 64 streams x 8 frames
# the featurizer on the card against the host frontend's float64 numpy:
# the three-matmul extractor itself is 4.7e-3 off float64 at M=80 (PERF.md
# section 6); against its plain chain it is held at phase 9's limit
FEATURIZER_HOST_TOL = 1e-2
# the FSMN-CTC rows whose posteriors carry a planted keyword (random
# weights never fire the detector): a row's steps 3, 4 and 5 each carry
# one keyword token at frame 2, every other frame of the row is blank
INJECT_ROWS = tuple(range(0, SERVE_STREAMS, 4))
INJECT_STEPS = dict(zip((3, 4, 5), CTC_KEYWORD_TOKENS))
DAEMON_CLIENTS = 16
DAEMON_TIMEOUT_S = 240
# the CTC daemons with device decode (17c, 19c) serve the first 48 test
# utterances (every host-decode daemon serves all 192): the decode's
# steps are the run's slowest, and 48 hold both keywords and fillers
DAEMON_UTTS = 48
SERVE_THRESHOLD_CTC = 0.1  # bin.stream_score_ctc's in phase 15


def serve_waves():
    """Path F's 64 streams: four sets of phase 4's synthetic 2 s waves."""
    return np.concatenate([synth_waves(np.random.default_rng(SEED + 17 + i))
                           for i in range(SERVE_STREAMS // N_UTTS)])


def pcm_of(path):
    from wekws_tpu_torch.data.audio import read_wav

    wave, _ = read_wav(path)
    return (np.clip(wave, -1, 1) * 32767).astype("<i2").tobytes()


FEATURIZER_CASES = (("flagship fbank 40", DATASET_CONF),
                    ("hi_xiaowen FSMN-CTC fbank 80, context 2/2, skip 3",
                     FSMN_DATASET_CONF),
                    ("hi_xiaowen DS-TCN MFCC 80 of 80",
                     DS_TCN_WIDE_DATASET_CONF))


def phase17a_featurizer(dev, card):
    """The device stream featurizer through ``fused_fbank`` at path F's
    shapes: 64 streams, 8 frames a step, for the flagship (fbank 40),
    the hi_xiaowen FSMN-CTC (fbank 80, context 2/2, skip 3) and the
    hi_xiaowen DS-TCN (MFCC 80 of 80).  Every step's windows on the card
    against the same featurizer on the CPU (the plain chain; phase 9's
    limit) and the valid frames against the host ``StreamingFrontend``.
    Returns the largest error against the plain chain."""
    import torch

    from wekws_tpu_torch.runtime.device_frontend import (
        WaveStreamBuffer,
        build_batch_featurizer,
    )
    from wekws_tpu_torch.runtime.keyword_spotter import load_spotter_config
    from wekws_tpu_torch.runtime.streaming_frontend import StreamingFrontend

    waves = serve_waves().astype(np.float32)
    worst = 0.0
    for tag, dconf in FEATURIZER_CASES:
        _, cfg, left, right, skip = load_spotter_config(
            {"dataset_conf": dconf})
        fused, window = build_batch_featurizer(cfg, left, right, skip,
                                               SERVE_STEP, dev)
        plain, _ = build_batch_featurizer(cfg, left, right, skip,
                                          SERVE_STEP, "cpu")
        bufs = [WaveStreamBuffer(cfg.frame_shift, cfg.frame_length, left,
                                 right, skip, SERVE_STEP) for _ in waves]
        host = [StreamingFrontend(cfg, left, right, skip).accept_waveform(w)
                for w in waves]
        for buf, w in zip(bufs, waves):
            buf.append(w)
        steps, err, host_err = 0, 0.0, 0.0
        with PlainOnCuda() as plain_on_cuda, Launches() as n:
            while bufs[0].available_outputs() >= SERVE_STEP:
                wins = [b.window() for b in bufs]
                w = np.stack([x[0] for x in wins])
                lo = np.array([x[1] for x in wins])
                got = fused(w, lo).cpu()
                err = max(err, check_close(
                    f"17a {tag}: featurizer step {steps}", got, plain(w, lo),
                    quiet=True, atol=FBANK_ATOL, rtol=FBANK_RTOL))
                for i, b in enumerate(bufs):
                    rows = b.consume(SERVE_STEP) // skip
                    host_err = max(host_err, check_close(
                        f"17a {tag}: stream {i} vs the host frontend",
                        got[i], torch.as_tensor(host[i][0][rows]),
                        quiet=True, atol=FEATURIZER_HOST_TOL, rtol=0.0))
                steps += 1
        plain_on_cuda.check(f"17a {tag}")
        if n.counts["fused_fbank"] != steps or steps < 8:
            raise AssertionError(f"17a {tag}: {n.counts} launches for "
                                 f"{steps} steps")
        worst = max(worst, err)
        print(f"  17a {tag}: {steps} steps of windows {w.shape} -> "
              f"{tuple(got.shape)}, one fused_fbank launch each; vs the "
              f"plain chain on the CPU max_abs_err {err:.3e} (bound "
              f"{FBANK_ATOL} abs + {FBANK_RTOL} rel), vs the host frontend "
              f"{host_err:.3e} (bound {FEATURIZER_HOST_TOL} abs)", flush=True)
    return worst


class EngineTap:
    """Wraps an engine's step function: keeps each step's posteriors
    (on the device; a split engine's row blocks joined) and the valid
    frames of each row, and, with ``inject``, plants the keyword in
    ``INJECT_ROWS`` (out of place, on the device)."""

    def __init__(self, engine, inject=False):
        import torch

        self.steps, self._torch = [], torch
        self._row_steps = np.zeros(engine.num_streams, np.int64)
        self._step_fn, self._consume = engine._step_fn, engine._consume
        self._inject = inject
        engine._step_fn, engine._consume = self.step_fn, self.consume

    def step_fn(self, feats, active, reset, cache):
        torch = self._torch
        probs, cache = self._step_fn(feats, active, reset, cache)
        if isinstance(probs, list):  # row blocks on several devices
            self.steps.append((torch.cat([p.to(probs[0].device)
                                          for p in probs]), {}))
        else:
            self.steps.append((probs.clone(), {}))
        if self._inject:
            on = np.asarray(torch.as_tensor(active).cpu(), bool)
            self._row_steps[on] += 1
            planted = torch.full_like(probs, 1e-5)
            planted[:, :, 0] = 0.9
            rows = torch.zeros(probs.shape[0], dtype=torch.bool)
            for r in INJECT_ROWS:
                if on[r]:
                    rows[r] = True
                    tok = INJECT_STEPS.get(int(self._row_steps[r]))
                    if tok is not None:
                        planted[r, 2, 0] = 0.05
                        planted[r, 2, tok] = 0.9
            probs = torch.where(rows.to(probs.device)[:, None, None],
                                planted, probs)
        return probs, cache

    def consume(self, i, k):
        self.steps[-1][1][i] = k
        return self._consume(i, k)


class ShadowDecode:
    """Within the ``with``, every ``stream_detect_step`` of the engines
    also runs on the CPU, on CPU copies of its inputs, from a CPU twin
    of the first state it saw: the same search on the CPU.  Each step's
    events must agree (decisions, keyword, start, end exactly, scores
    within TOL)."""

    def __enter__(self):
        import torch

        import wekws_tpu_torch.runtime.batch_spotter as bs

        self._bs, self._orig = bs, bs.stream_detect_step
        self.twin, self.calls, self.fires, self.score_err = None, 0, 0, 0.0

        def cpu(x):
            if isinstance(x, torch.Tensor):
                return x.cpu()
            if hasattr(x, "_fields"):  # a state NamedTuple
                return type(x)(*(cpu(y) for y in x))
            return tuple(cpu(y) for y in x)

        def shadow(state, *args, lengths=None, **fsm):
            if self.twin is None:
                self.twin = cpu(state)
            new, ev = self._orig(state, *args, lengths=lengths, **fsm)
            self.twin, want = self._orig(self.twin, *cpu(args),
                                         lengths=cpu(lengths), **fsm)
            got = {k: v.cpu() for k, v in ev.items()}
            on = want["fired"]
            if not torch.equal(got["fired"], on) or any(
                    not torch.equal(got[k][on], want[k][on])
                    for k in ("kw", "start", "end")):
                raise AssertionError(f"device decode step {self.calls}: the "
                                     f"card's events {got} differ from the "
                                     f"CPU's {want}")
            if on.any():
                self.score_err = max(self.score_err, check_close(
                    "device decode score, card vs CPU", got["score"][on],
                    want["score"][on], quiet=True))
            self.calls += 1
            self.fires += int(on.sum())
            return new, ev

        bs.stream_detect_step = shadow
        return self

    def __exit__(self, *exc):
        self._bs.stream_detect_step = self._orig
        return False


def run_engine(engine, pcms, chunk_bytes=2 * CHUNK_SAMPLES):
    """Every stream's PCM in chunks, round robin; after each round every
    full step, then ``flush()``.  Returns the results of each step (the
    flush's last), each step's host time (ms; each ends in its device to
    host copy), the wall time and the audio seconds."""
    results, step_ms = [], []
    t_start = time.perf_counter()
    for off in range(0, max(len(p) for p in pcms), chunk_bytes):
        for i, p in enumerate(pcms):
            if off < len(p):
                engine.accept_wave(i, p[off:off + chunk_bytes])
        while True:
            t0 = time.perf_counter()
            res = engine.step()
            if not res:
                break
            step_ms.append((time.perf_counter() - t0) * 1e3)
            results.append(res)
    results.append(engine.flush())
    wall = time.perf_counter() - t_start
    return {"results": results, "step_ms": step_ms, "wall_s": wall,
            "audio_s": sum(len(p) for p in pcms) / 2 / RATE,
            "dispatch_s": engine.stats["dispatch_s"],
            "steps": engine.stats["dispatches"]}


def same_posteriors(tag, got, want):
    """Two taps' steps: the same schedule and valid frames; every valid
    frame within TOL."""
    if [s[1] for s in got.steps] != [s[1] for s in want.steps]:
        raise AssertionError(f"{tag}: the two engines' step schedules "
                             f"differ")
    err = 0.0
    for (g, rows), (w, _) in zip(got.steps, want.steps):
        for i, k in rows.items():
            err = max(err, check_close(f"{tag}, row {i}", g[i, :k],
                                       w[i, :k], quiet=True))
    return err


def same_results(tag, got, want, score_tol=TOL):
    """Per step, the same rows and decisions, keyword and times; scores
    within ``score_tol``.  Returns the detections."""
    fires = 0
    for g, w in zip(got, want):
        if g.keys() != w.keys():
            raise AssertionError(f"{tag}: steps ran other rows")
        for i in g:
            a, b = g[i], w[i]
            if a.get("state") != b.get("state") or any(
                    a.get(k) != b.get(k) for k in ("keyword", "start", "end",
                                                    "frame")):
                raise AssertionError(f"{tag}: stream {i}: {a} vs {b}")
            if a.get("state") == 1:
                fires += 1
                if abs(a["score"] - b["score"]) > score_tol + score_tol * abs(
                        b["score"]):
                    raise AssertionError(f"{tag}: stream {i} score {a} vs "
                                         f"{b}")
    if len(got) != len(want):
        raise AssertionError(f"{tag}: {len(got)} steps vs {len(want)}")
    return fires


def engine_figures(tag, run, launches, card):
    """Mean and p99 step, dispatch share, real-time factor and launches
    per step of one engine run; printed with the card."""
    ms = np.asarray(run["step_ms"])
    fig = {"mean_step_ms": float(ms.mean()),
           "p99_step_ms": float(np.percentile(ms, 99)),
           "dispatch_share": run["dispatch_s"] / run["wall_s"],
           "rtf": run["audio_s"] / run["wall_s"], "steps": run["steps"],
           "launches_per_step": {k: v / run["steps"]
                                 for k, v in launches.items()}}
    print(f"  {tag}: {run['steps']} steps, mean step {fig['mean_step_ms']:.3f}"
          f" ms, p99 {fig['p99_step_ms']:.3f} ms (host clock, each step "
          f"ending in its copy to the host), dispatch share "
          f"{fig['dispatch_share']:.3f} of {run['wall_s'] * 1e3:.1f} ms wall, "
          f"{run['audio_s']:.0f} audio-s at {fig['rtf']:.1f}x real time, "
          f"launches per step {fig['launches_per_step']} [{card}]",
          flush=True)
    return fig


def kernel_counts():
    """The wrappers whose launches path F counts, by kernel record."""
    from wekws_tpu_torch.ops.fused_frontend import fused_fbank
    from wekws_tpu_torch.ops.fused_fsmn import fused_fsmn_layers
    from wekws_tpu_torch.ops.fused_mdtc import fused_mdtc_stream
    from wekws_tpu_torch.ops.fused_tcn import fused_ds_tcn

    return {"fused_mdtc_stream": fused_mdtc_stream, "fused_fbank": fused_fbank,
            "fused_ds_tcn": fused_ds_tcn,
            "fused_fsmn_layers": fused_fsmn_layers}


def zero_counts():
    for fn in kernel_counts().values():
        fn.launches = 0


def read_counts():
    return {k: fn.launches for k, fn in kernel_counts().items()}


class Launches:
    """Within the ``with``, the launches of each path-F kernel (the
    difference of the wrappers' counts)."""

    def __enter__(self):
        self._before = read_counts()
        return self

    def __exit__(self, *exc):
        after = read_counts()
        self.counts = {k: after[k] - self._before[k] for k in after}
        return False

    def nonzero(self):
        return {k: v for k, v in self.counts.items() if v}




def fresh_stats(engine):
    engine.stats = {k: type(v)() for k, v in engine.stats.items()}


def phase17b_engines(dev, card, work):
    """The batched engines at full width, 64 streams x 8 frames, on the
    card: the flagship MDTC through ``BatchMaxPoolSpotter(use_fused=
    True)`` (``fused_mdtc_stream``) with the host and the device
    frontend against the module route; the hi_xiaowen FSMN-CTC through
    ``BatchKeywordSpotter(use_fused=True)`` (``fused_fsmn_layers``),
    host decode and device decode, each with and without the device
    frontend: posteriors against the module route, device decode
    against the same search on the CPU and against the host decode's
    decisions.  Returns the serving figures of the fused engines."""
    import torch

    from wekws_tpu_torch.runtime import (
        BatchKeywordSpotter,
        BatchMaxPoolSpotter,
    )

    pcms = [w.astype("<i2").tobytes() for w in serve_waves()]
    figures = {}
    # the flagship: phase 4's checkpoint and config.  The module route
    # first (posteriors; its 95th percentile is the threshold, as phase
    # 4's), then the fused engine at that threshold, then the module
    # engine's events at it
    ckpt, config = (os.path.join(work, f"flagship.{x}")
                    for x in ("pt", "yaml"))
    for fe in (False, True):
        tag = f"flagship MDTC, {'device' if fe else 'host'} frontend"

        def engine(fused, threshold):
            return BatchMaxPoolSpotter(
                ckpt, config, threshold, num_streams=SERVE_STREAMS,
                step_frames=SERVE_STEP, use_fused=fused,
                device_frontend=fe, device=dev)

        module = engine(False, 2.0)
        module_tap = EngineTap(module)
        run_engine(module, pcms)
        flat = torch.cat([p.flatten() for p, _ in module_tap.steps])
        threshold = float(torch.quantile(flat.cpu(), 0.95))
        fused = engine(True, threshold)
        run_engine(fused, pcms)  # the first launches
        fused.reset_all()
        fresh_stats(fused)
        tap = EngineTap(fused)
        with PlainOnCuda() as plain, Launches() as n:
            run = run_engine(fused, pcms)
            torch.cuda.synchronize()
        plain.check(f"17b {tag}")
        err = same_posteriors(f"17b {tag}: fused vs module", tap,
                              module_tap)
        module = engine(False, threshold)
        fires = same_results(f"17b {tag}: events", run["results"],
                             run_engine(module, pcms)["results"])
        steps = run["steps"]
        if n.counts["fused_mdtc_stream"] != steps or fires < 1 or (
                n.counts["fused_fbank"] != (steps if fe else 0)):
            raise AssertionError(f"17b {tag}: launches {n.counts} for "
                                 f"{steps} steps, {fires} events")
        print(f"  17b {tag}: {SERVE_STREAMS} streams x {SERVE_STEP} frames, "
              f"fused_mdtc_stream vs module posteriors max_abs_err "
              f"{err:.3e} (bound {TOL} abs + {TOL} rel), the same {fires} "
              f"events at threshold {threshold:.4f}", flush=True)
        figures[tag] = engine_figures(f"17b {tag}", run, n.nonzero(), card)

    # the hi_xiaowen FSMN-CTC: phase 11's checkpoint, tables and lexicon
    ckpt, config, tokens, lexicon = (os.path.join(work, x) for x in (
        "fsmn_ctc.pt", "fsmn_ctc.yaml", "tokens.txt", "lexicon.txt"))

    def kws(fused, decode, fe):
        eng = BatchKeywordSpotter(
            ckpt, config, tokens, lexicon, 0.5, num_streams=SERVE_STREAMS,
            step_frames=SERVE_STEP, min_frames=1, use_fused=fused,
            device_decode=decode, device_frontend=fe, device=dev)
        eng.set_keywords(CTC_KEYWORD)
        return eng

    for fe in (False, True):
        front = f"{'device' if fe else 'host'} frontend"
        runs, taps = {}, {}
        for fused, decode in ((True, False), (False, False), (True, True)):
            eng = kws(fused, decode, fe)
            taps[fused, decode] = EngineTap(eng, inject=True)
            with PlainOnCuda() as plain, ShadowDecode() as shadow, \
                    Launches() as n:
                runs[fused, decode] = run_engine(eng, pcms)
                torch.cuda.synchronize()
            steps = runs[fused, decode]["steps"]
            plain.check(f"17b FSMN-CTC {front}")
            if decode and (shadow.calls != steps or not shadow.fires):
                raise AssertionError(f"17b FSMN-CTC: the CPU search "
                                     f"shadowed {shadow.calls} of {steps} "
                                     f"steps, {shadow.fires} fires")
            if n.counts["fused_fsmn_layers"] != (steps if fused else 0) or \
                    n.counts["fused_fbank"] != (steps if fe else 0):
                raise AssertionError(f"17b FSMN-CTC: launches {n.counts} "
                                     f"for {steps} steps")
            if decode:
                print(f"  17b FSMN-CTC, device decode, {front}: the same "
                      f"search on the CPU over the card's posteriors: "
                      f"{shadow.calls} steps, {shadow.fires} detections, "
                      f"equal, scores within {shadow.score_err:.2e}",
                      flush=True)
        err = same_posteriors(f"17b FSMN-CTC, {front}: fused vs module",
                              taps[True, False], taps[False, False])
        fires = same_results("17b FSMN-CTC fused vs module, host decode",
                             runs[True, False]["results"],
                             runs[False, False]["results"])
        dd = same_results("17b FSMN-CTC device vs host decode",
                          runs[True, True]["results"],
                          runs[True, False]["results"], CTC_SCORE_TOL)
        if fires != dd or fires < len(INJECT_ROWS):
            raise AssertionError(f"17b FSMN-CTC: {fires} host-decode and "
                                 f"{dd} device-decode detections for "
                                 f"{len(INJECT_ROWS)} planted keywords")
        print(f"  17b FSMN-CTC, {front}, {SERVE_STREAMS} streams x "
              f"{SERVE_STEP} frames: fused vs module posteriors max_abs_err "
              f"{err:.3e} (bound {TOL} abs + {TOL} rel), the same {fires} "
              f"detections (the planted keywords) by host and device decode",
              flush=True)
    # clean runs for the figures: no tap, no shadow, after a first run
    for key in ((True, False, False), (True, True, True)):
        eng = kws(*key)
        run_engine(eng, pcms)
        eng.reset_all()
        fresh_stats(eng)
        with Launches() as n:
            run = run_engine(eng, pcms)
            torch.cuda.synchronize()
        tag = (f"FSMN-CTC, {'device' if key[1] else 'host'} decode, "
               f"{'device' if key[2] else 'host'} frontend")
        figures[tag] = engine_figures(f"17b {tag}", run, n.nonzero(), card)
    return figures


class ServerThread:
    """``KwsServer`` on its own event-loop thread, port picked by the OS.
    Records the thread, CUDA device and stream of every ``engine.step``:
    all must be the engine thread's, on the engine's device's default
    stream."""

    def __init__(self, engine):
        import asyncio
        import threading

        import torch

        from wekws_tpu_torch.serving import KwsServer

        self.server = KwsServer(engine, "127.0.0.1", 0)
        self.seen = set()
        step = engine.step

        def recorded():
            self.seen.add((threading.current_thread().name,
                           torch.cuda.current_device(),
                           torch.cuda.current_stream().cuda_stream))
            return step()

        engine.step = recorded
        self._asyncio = asyncio
        self._started = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()
        if not self._started.wait(30):
            raise AssertionError("the in-process daemon did not start")

    def _run(self):
        asyncio = self._asyncio

        async def main():
            self._loop = asyncio.get_running_loop()
            await self.server.start()
            self._started.set()
            try:
                await self.server._server.serve_forever()
            except asyncio.CancelledError:
                pass

        asyncio.run(main())

    @property
    def port(self):
        return self.server.port

    def stop(self, dev):
        import torch

        self._asyncio.run_coroutine_threadsafe(
            self.server.stop(), self._loop).result(30)
        self.thread.join(30)
        want = {(dev.index or 0, torch.cuda.default_stream(dev).cuda_stream)}
        got = {(d, s) for _, d, s in self.seen}
        if self.thread.is_alive() or got != want or not all(
                name.startswith("kws-engine") for name, _, _ in self.seen):
            raise AssertionError(f"in-process daemon: steps ran on "
                                 f"{self.seen}, want the kws-engine thread "
                                 f"on (device, default stream) {want}")


class ServeProcess:
    """``python -m wekws_tpu_torch.bin.serve ... --port 0 --warmup`` in a
    subprocess; the port is read from its log by a watching thread, and
    ``start_s`` is the time from the start to the port.  ``start()`` may
    come early, so that the daemon loads and warms up while the caller
    does untimed work; ``with`` starts it where that has not happened
    and waits for the port.  Sent SIGTERM on exit; then ``served`` holds
    its last log line's stats: the engine's dispatches, the server's
    steps and each kernel's launches after the warm-up.  ``close()``
    stops a daemon that was started and never entered."""

    def __init__(self, args, log_path):
        self.args, self.log_path = args, log_path
        self.proc, self.port = None, None

    def start(self):
        import threading

        repo = os.path.abspath(os.path.dirname(__file__) or ".")
        self._log = open(self.log_path, "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "wekws_tpu_torch.bin.serve", *self.args,
             "--port", "0", "--warmup"], cwd=repo,
            env=dict(os.environ, PYTHONPATH=repo, PYTHONFAULTHANDLER="1"),
            stdout=self._log, stderr=subprocess.STDOUT)
        t0 = time.perf_counter()

        def watch():
            while time.perf_counter() - t0 < DAEMON_TIMEOUT_S:
                with open(self.log_path) as f:
                    m = re.search(r"kws server on 127\.0\.0\.1:(\d+)",
                                  f.read())
                if m:
                    self.start_s = time.perf_counter() - t0
                    self.port = int(m.group(1))
                    return
                if self.proc.poll() is not None:
                    return
                time.sleep(0.2)

        self._watch = threading.Thread(target=watch, daemon=True)
        self._watch.start()
        return self

    def ready(self):
        """Waits for the port; stops the daemon and fails without it."""
        self._watch.join()
        if self.port is None:
            self.__exit__()
            with open(self.log_path) as f:
                raise AssertionError(f"bin.serve did not open its port:\n"
                                     f"{f.read()[-3000:]}")

    def __enter__(self):
        if self.proc is None:
            self.start()
        self.ready()
        return self

    def close(self):
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(30)
        if self.proc is not None:
            self._log.close()

    def __exit__(self, *exc):
        import re

        alive = self.proc.poll() is None
        self.proc.terminate()  # SIGTERM: bin.serve stops and logs
        try:
            self.proc.wait(60)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(30)
        self._log.close()
        with open(self.log_path) as f:
            log = f.read()
        if exc and exc[0] is not None or not alive:
            print(f"  bin.serve ({'running' if alive else 'exited '
                  f'{self.proc.returncode}'}) log, last lines:\n"
                  f"{log[-4000:]}", flush=True)
            return False
        m = re.findall(r"served: (\{.*\})", log)
        if self.proc.returncode != 0 or not m:
            raise AssertionError(f"bin.serve exited {self.proc.returncode} "
                                 f"without its served line:\n{log[-3000:]}")
        self.served = json.loads(m[-1])
        return False


def serve_clients(port, utts, n_threads=DAEMON_CLIENTS):
    """``n_threads`` client threads, each serving its share of ``utts``
    ({key: PCM bytes}) one connection after another in 300 ms chunks,
    EOS drained.  Returns ({key: events}, wall seconds)."""
    import threading

    from wekws_tpu_torch.serving import KwsClient

    keys = sorted(utts)
    out, errors = {}, []

    def connect():
        # a slot is freed after its client has read BYE: a client that
        # reconnects at once may find it still taken, and waits
        for _ in range(500):
            try:
                return KwsClient("127.0.0.1", port, timeout=120)
            except ConnectionError as e:
                if "server full" not in str(e):
                    raise
                time.sleep(0.01)
        raise ConnectionError("the server stayed full for 5 s")

    def client(share):
        try:
            for key in share:
                pcm = utts[key]
                with connect() as c:
                    for off in range(0, len(pcm), 2 * CHUNK_SAMPLES):
                        c.send_audio(pcm[off:off + 2 * CHUNK_SAMPLES])
                    out[key] = c.finish()
        except Exception as e:  # reported below, with the others'
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(keys[i::n_threads],))
               for i in range(n_threads)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(max(t0 + DAEMON_TIMEOUT_S - time.perf_counter(), 0.0))
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads) or len(out) != len(keys):
        raise AssertionError(f"daemon clients: {len(out)} of {len(keys)} "
                             f"served, errors {errors[:3]}")
    return out, wall


def in_process_events(engine, utts, slot=0):
    """What the daemon does for each client, in process, one utterance
    after another on ``slot``: chunks accepted, every full step, EOS's
    drain, the slot reset.  Returns {key: events}."""
    out = {}
    for key in sorted(utts):
        pcm, events = utts[key], []
        for off in range(0, len(pcm), 2 * CHUNK_SAMPLES):
            engine.accept_wave(slot, pcm[off:off + 2 * CHUNK_SAMPLES])
            while True:
                res = engine.step()
                if not res:
                    break
                events += [r for r in res.values() if r.get("state") == 1]
        events += [r for r in engine.flush_stream(slot)
                   if r.get("state") == 1]
        engine.reset_stream(slot)
        out[key] = events
    return out


def spotter_events(spot, utts):
    """``KeyWordSpotter`` over each utterance in 300 ms chunks (state
    reset between them): {key: the results with state 1}."""
    out = {}
    for key in sorted(utts):
        spot.reset_all()
        pcm = utts[key]
        out[key] = [r for r in (spot.forward(pcm[off:off + 2 * CHUNK_SAMPLES])
                                for off in range(0, len(pcm),
                                                 2 * CHUNK_SAMPLES))
                    if r and r.get("state") == 1]
    return out


def same_events(tag, got, want, score_tol=TOL,
                keys=("keyword", "start", "end", "frame")):
    """{key: events} against {key: events}: the same detections, scores
    within ``score_tol``.  Returns their count."""
    n = 0
    for key in want:
        g, w = got[key], want[key]
        if len(g) != len(w) or any(
                a.get(k) != b.get(k) for a, b in zip(g, w) for k in keys) or \
                any(abs(a["score"] - b["score"]) > score_tol
                    + score_tol * abs(b["score"]) for a, b in zip(g, w)):
            raise AssertionError(f"{tag}: {key}: {g} vs {w}")
        n += len(w)
    return n


def serve_argv(config, ckpt, streams, ctc=True, extra=()):
    """A ``bin.serve`` argument list (a fixture's, or the flagship's)."""
    argv = ["--config", config, "--checkpoint", ckpt, "--streams",
            str(streams)]
    if ctc:
        argv += ["--threshold", str(SERVE_THRESHOLD_CTC), "--token_file",
                 os.path.join(CTC_RECIPE, "dict", "dict.txt"), "--keywords",
                 CTC_RECIPE_KEYWORD]
    else:
        argv += ["--maxpool", "--keywords", KEYWORD, "--threshold", "0.5"]
    return argv + list(extra)


def daemon_figures(tag, server, engine, wall, audio, n, card):
    stats = server.stats
    fig = {"rtf": audio / wall, "wall_s": wall,
           "rows_per_step": stats["participants"] / max(stats["steps"], 1),
           "mean_step_ms": stats["step_s"] / max(stats["steps"], 1) * 1e3,
           "step_share": stats["step_s"] / wall,
           "dispatch_ms": engine.stats["dispatch_s"]
           / engine.stats["dispatches"] * 1e3,
           "dispatch_share": engine.stats["dispatch_s"] / wall,
           "launches_per_step": {k: v / engine.stats["dispatches"]
                                 for k, v in n.nonzero().items()}}
    print(f"  17c {tag}: {audio:.0f} audio-s in {wall:.2f} s "
          f"({fig['rtf']:.1f}x real time), {stats['steps']} shared steps "
          f"(mean {fig['rows_per_step']:.1f} rows, {fig['mean_step_ms']:.3f}"
          f" ms from the loop's call to its result), step share "
          f"{fig['step_share']:.3f} of wall, {engine.stats['dispatches']} "
          f"dispatches of {fig['dispatch_ms']:.3f} ms each in the engine "
          f"(share {fig['dispatch_share']:.3f}), launches per dispatch "
          f"{fig['launches_per_step']}; every "
          f"step on the kws-engine thread and the default stream [{card}]",
          flush=True)
    return fig


def served_figures(tag, proc, kernels, wall, audio, card, sub="17c"):
    """bin.serve's own reading after SIGTERM: each kernel of the route
    launched once a dispatch, and no other; its real-time factor and
    the mean step on its engine thread (lines headed ``sub``)."""
    served, eng = proc.served, proc.served["engine"]
    got = {k: v for k, v in served["launches"].items() if v}
    if eng["dispatches"] < 1 or got != {k: eng["dispatches"]
                                        for k in kernels}:
        raise AssertionError(f"{sub} {tag}: bin.serve launched {got} for "
                             f"{eng['dispatches']} dispatches, want each of "
                             f"{kernels} once a dispatch")
    steps = served["server"]["steps"]
    fig = {"rtf": audio / wall, "wall_s": wall,
           "dispatches": eng["dispatches"],
           "dispatch_ms": eng["dispatch_s"] / eng["dispatches"] * 1e3,
           "dispatch_share": eng["dispatch_s"] / wall,
           "mean_step_ms": served["server"]["step_s"] / max(steps, 1) * 1e3,
           "rows_per_step": served["server"]["participants"] / max(steps, 1),
           "launches_per_step": {k: v / eng["dispatches"]
                                 for k, v in got.items()}}
    print(f"  {sub} {tag}: bin.serve in a subprocess (port open "
          f"{proc.start_s:.1f} s after start, warm-up included), "
          f"{audio:.0f} audio-s in {wall:.2f} s ({fig['rtf']:.1f}x real "
          f"time), {steps} shared steps (mean {fig['rows_per_step']:.1f} "
          f"rows, {fig['mean_step_ms']:.3f} ms from the loop's call to its "
          f"result), {eng['dispatches']} dispatches of {fig['dispatch_ms']:.3f}"
          f" ms each in the engine (share {fig['dispatch_share']:.3f} of "
          f"wall); its own counts: launches per dispatch "
          f"{fig['launches_per_step']} [{card}]", flush=True)
    return fig, got


def phase17c_daemons(dev, card, tmp, work):
    """The daemon on the card.  The JAX CTC fixture (FSMN 3 x 64/32, the
    corpus of gen_data_torch.py seed 17; host decode, and device decode
    with the device frontend) and the JAX DS-TCN fixture (C=48, the
    committed test wavs), each served by ``bin.serve`` in a subprocess
    to 16 client threads (192 utterances, 300 ms chunks; with device
    decode the first ``DAEMON_UTTS``): the events
    equal the in-process engine's (the same ``build_engine``) and, for
    CTC, ``KeyWordSpotter``'s, and bin.serve's own launch counts show
    each kernel of the route once a dispatch.  Then in process, a
    ``KwsServer`` on the CTC fixture with device decode and the device
    frontend, and the flagship MDTC (device frontend) to 64 clients, each
    step on the engine thread's default stream; then the flagship's
    ``bin.serve`` to the same clients (the same events).  Returns the
    figures, the CTC fixture's files and events, and bin.serve's
    launches."""
    ctc_config, _ = fixture_config(CTC_FIXTURE, CTC_RECIPE, tmp,
                                   "fsmn_ctc_fixture.yaml")
    ctc_ckpt = os.path.join(CTC_FIXTURE, "avg_5.ckpt")
    tcn_config, _ = fixture_config(DS_TCN_FIXTURE, RECIPE, tmp,
                                   "ds_tcn_fixture.yaml")
    device_ctc = ["--device_decode", "--device_frontend"]
    flagship_argv = serve_argv(os.path.join(work, "flagship.yaml"),
                               os.path.join(work, "flagship.pt"),
                               SERVE_STREAMS, ctc=False,
                               extra=["--device_frontend"])
    cases = (
        ("JAX CTC fixture (FSMN 3 x 64/32), host decode",
         ("fused_fsmn_layers",), "all",
         serve_argv(ctc_config, ctc_ckpt, DAEMON_CLIENTS)),
        ("JAX CTC fixture, device decode + device frontend",
         ("fused_fsmn_layers", "fused_fbank"), "head",
         serve_argv(ctc_config, ctc_ckpt, DAEMON_CLIENTS, extra=device_ctc)),
        ("JAX DS-TCN fixture (C=48), max-pooling", ("fused_ds_tcn",), "tcn",
         serve_argv(tcn_config, os.path.join(DS_TCN_FIXTURE, "avg_5.ckpt"),
                    DAEMON_CLIENTS, ctc=False)))
    # every daemon loads and warms up while this process makes the corpus
    # and runs the in-process engines (untimed); each is timed only once
    # all of them are up and idle
    daemons = [ServeProcess(argv + ["--device", dev.type],
                            os.path.join(tmp, f"serve_{i}.log"))
               for i, (*_, argv) in enumerate(cases)]
    daemons.append(ServeProcess(flagship_argv + ["--device", dev.type],
                                os.path.join(tmp, "serve_flagship.log")))
    try:
        for d in daemons:
            d.start()
        return daemons_17c(dev, card, tmp, cases, daemons, ctc_config,
                           ctc_ckpt, flagship_argv)
    finally:
        for d in daemons:
            d.close()


def daemons_17c(dev, card, tmp, cases, daemons, ctc_config, ctc_ckpt,
                flagship_argv):
    """17c's body, its daemons started (``phase17c_daemons``)."""
    import torch

    from wekws_tpu_torch.bin import serve
    from wekws_tpu_torch.runtime import KeyWordSpotter

    data = corpus("ctc")
    with open(os.path.join(data, "test.list")) as f:
        lines = [json.loads(line) for line in f]
    ctc_utts = {x["key"]: pcm_of(x["wav"]) for x in lines}
    tcn_dir = os.path.join(RECIPE, "data", "test")
    sets = {"all": ctc_utts,
            "head": {x["key"]: ctc_utts[x["key"]]
                     for x in lines[:DAEMON_UTTS]},
            "tcn": {f"test_{i}": pcm_of(os.path.join(tcn_dir,
                                                     f"test_{i}.wav"))
                    for i in range(RECIPE_SPLITS[2][1])}}
    ctc_head = sets["head"]
    figures, wants, served = {}, {}, {}

    def build(argv):
        return serve.build_engine(serve.get_args(argv + ["--device",
                                                         dev.type]))

    for tag, kernels, which, argv in cases:
        utts = sets[which]
        engine = build(argv)
        with PlainOnCuda() as plain, Launches() as n:
            wants[tag] = in_process_events(engine, utts)
            torch.cuda.synchronize()
        plain.check(f"17c {tag}: in-process engine")
        steps = engine.stats["dispatches"]
        if n.nonzero() != {k: steps for k in kernels} or steps < len(utts):
            raise AssertionError(f"17c {tag}: {n.counts} launches for "
                                 f"{steps} steps")
    for d in daemons:
        d.ready()
    for (tag, kernels, which, argv), daemon in zip(cases, daemons):
        utts = sets[which]
        with daemon as proc:
            got, wall = serve_clients(proc.port, utts)
        count = same_events(f"17c {tag}: daemon vs in-process engine", got,
                            wants[tag])
        if count < 1:
            raise AssertionError(f"17c {tag}: no detections")
        if tag.endswith("host decode"):
            spot = KeyWordSpotter(
                ctc_ckpt, ctc_config, os.path.join(CTC_RECIPE, "dict",
                                                   "dict.txt"), None,
                SERVE_THRESHOLD_CTC, use_fused=None, device=dev)
            spot.set_keywords(CTC_RECIPE_KEYWORD)
            same_events(f"17c {tag}: daemon vs KeyWordSpotter", got,
                        spotter_events(spot, utts))
        audio = sum(len(p) for p in utts.values()) / 2 / RATE
        fig, launched = served_figures(
            f"{tag}, {DAEMON_CLIENTS} client threads, {len(utts)} "
            f"utterances, {count} detections equal to the in-process "
            f"engine's{' and KeyWordSpotter' if 'host' in tag else ''}",
            proc, kernels, wall, audio, card)
        figures[f"bin.serve, {tag}"] = dict(fig, detections=count)
        for k, v in launched.items():
            served[k] = served.get(k, 0) + v

    # in process: the CTC fixture with device decode and device frontend
    tag, _, _, argv = cases[1]
    want = wants[tag]
    engine = build(argv)
    serve.warmup_engine(engine)
    with PlainOnCuda() as plain, Launches() as n:
        st = ServerThread(engine)
        try:
            got, wall = serve_clients(st.port, ctc_head)
        finally:
            st.stop(dev)
        torch.cuda.synchronize()
    plain.check("17c in-process daemon, CTC fixture")
    tag = "in-process KwsServer, CTC fixture, device decode + frontend"
    count = same_events(f"17c {tag} vs the in-process engine", got, want)
    steps = engine.stats["dispatches"]
    if n.counts["fused_fsmn_layers"] != steps or \
            n.counts["fused_fbank"] != steps or count < 1:
        raise AssertionError(f"17c {tag}: {n.counts} launches for {steps} "
                             f"steps, {count} detections")
    figures[tag] = daemon_figures(
        f"{tag}: {DAEMON_CLIENTS} clients, {count} detections equal to the "
        f"in-process engine's", st.server, engine, wall,
        sum(len(p) for p in ctc_head.values()) / 2 / RATE, n, card)

    # the flagship MDTC to 64 clients, device frontend
    engine = build(flagship_argv)
    serve.warmup_engine(engine)
    utts = {f"s{i:02d}": w.astype("<i2").tobytes()
            for i, w in enumerate(serve_waves())}
    with PlainOnCuda() as plain, Launches() as n:
        st = ServerThread(engine)
        try:
            want, wall = serve_clients(st.port, utts, SERVE_STREAMS)
        finally:
            st.stop(dev)
        torch.cuda.synchronize()
    plain.check("17c in-process daemon, flagship")
    steps = engine.stats["dispatches"]
    if n.counts["fused_mdtc_stream"] != steps or \
            n.counts["fused_fbank"] != steps:
        raise AssertionError(f"17c flagship daemon: {n.counts} for {steps} "
                             f"steps")
    tag = "in-process KwsServer, flagship MDTC, device frontend"
    audio = sum(len(p) for p in utts.values()) / 2 / RATE
    figures[tag] = daemon_figures(
        f"{tag}: {SERVE_STREAMS} clients x {SECONDS} s", st.server, engine,
        wall, audio, n, card)
    # the same daemon in its own process: the 64 client threads no
    # longer share its interpreter
    with daemons[-1] as proc:
        got, wall = serve_clients(proc.port, utts, SERVE_STREAMS)
    count = same_events("17c flagship: bin.serve vs the in-process daemon",
                        got, want)
    tag = "flagship MDTC, device frontend"
    fig, launched = served_figures(
        f"{tag}, {SERVE_STREAMS} clients, {count} events equal to the "
        f"in-process daemon's", proc, ("fused_mdtc_stream", "fused_fbank"),
        wall, audio, card)
    figures[f"bin.serve, {tag}, {SERVE_STREAMS} clients"] = dict(
        fig, detections=count)
    for k, v in launched.items():
        served[k] = served.get(k, 0) + v
    return figures, (ctc_config, ctc_ckpt, lines, wants[
        "JAX CTC fixture (FSMN 3 x 64/32), host decode"]), served


def phase17d_clis(dev, card, ctc):
    """``bin.batch_stream_kws`` (host and device decode) and
    ``bin.stream_kws_ctc`` on the CTC fixture: the in-process engine's
    detections (17c) for the same utterances."""
    from wekws_tpu_torch.bin import batch_stream_kws, stream_kws_ctc

    config, ckpt, lines, want = ctc
    lines = lines[:DAEMON_CLIENTS]
    base = ["--config", config, "--checkpoint", ckpt, "--token_file",
            os.path.join(CTC_RECIPE, "dict", "dict.txt"), "--keywords",
            CTC_RECIPE_KEYWORD, "--threshold", str(SERVE_THRESHOLD_CTC),
            "--device", dev.type]
    for extra in ([], ["--device_decode"]):
        with Launches() as n:
            out = run_cli(batch_stream_kws.main, base + [
                "--wav_paths", *[x["wav"] for x in lines]] + extra,
                f"bin.batch_stream_kws {extra}")
        got = {x["key"]: [] for x in lines}
        for i, r in out["detections"]:
            got[lines[i]["key"]].append(r)
        fires = same_events(f"17d bin.batch_stream_kws {extra}", got,
                            {k: want[k] for k in got},
                            CTC_SCORE_TOL if extra else TOL)
        steps = out["stats"]["dispatches"]
        if fires < 1 or n.counts["fused_fsmn_layers"] != steps:
            raise AssertionError(f"17d: {n.counts} launches for {steps} "
                                 f"steps, {fires} detections")
        print(f"  17d bin.batch_stream_kws {' '.join(extra)}: "
              f"{len(lines)} streams, {fires} detections equal to the "
              f"in-process engine's, {steps} steps, one fused_fsmn_layers "
              f"launch each, {out['audio_s'] / out['wall_s']:.1f}x real "
              f"time [{card}]", flush=True)
    for x in lines[:2]:
        got = run_cli(stream_kws_ctc.main, base + ["--wav_path", x["wav"]],
                      "bin.stream_kws_ctc")
        same_events(f"17d bin.stream_kws_ctc {x['key']}", {x["key"]: got},
                    {x["key"]: want[x["key"]]})
    print("  17d bin.stream_kws_ctc on 2 utterances: the in-process "
          "engine's detections", flush=True)


# path F's wrappers where the engines call them: (wrapper, the module
# whose name the engines call, the plain version's module, the kernel's
# name in a profile, the bound of a check against the plain version)
PATH_F_WRAPPERS = (
    ("fused_mdtc_stream", "wekws_tpu_torch.ops.serving",
     "wekws_tpu_torch.ops.fused_mdtc", "fused_mdtc_kernel", (TOL, TOL)),
    ("fused_ds_tcn", "wekws_tpu_torch.ops.serving",
     "wekws_tpu_torch.ops.fused_tcn", "fused_ds_tcn_kernel", (TOL, TOL)),
    ("fused_fsmn_layers", "wekws_tpu_torch.ops.serving",
     "wekws_tpu_torch.ops.fused_fsmn", "fused_fsmn_kernel", (TOL, TOL)),
    ("fused_fbank", "wekws_tpu_torch.frontend.features",
     "wekws_tpu_torch.ops.fused_frontend", "fused_fbank_kernel",
     (FBANK_ATOL, FBANK_RTOL)),
)


def _tree_map(fn, x):
    if isinstance(x, (list, tuple)):
        return type(x)(_tree_map(fn, y) for y in x)
    if isinstance(x, dict):
        return {k: _tree_map(fn, v) for k, v in x.items()}
    return fn(x)


def path_f_shape(name, args, kwargs):
    """A path-F call's shape, as the kernel records name it."""
    x, cache = args[0], args[1]
    if name == "fused_fbank":
        mel, dct = args[2], args[3]
        return (f"waves {tuple(x.shape)} M={mel.shape[-1]}"
                + ("" if dct is None else f" MFCC {dct.shape[-1]}"))
    if name == "fused_fsmn_layers":
        return (f"B={x.shape[0]} T={x.shape[1]} ({cache.shape[0]} x "
                f"{x.shape[2]}/{cache.shape[3]})")
    return f"B={x.shape[0]} T={x.shape[1]} C={x.shape[2]}"


def path_f_bound(name, args, kwargs):
    """The bound of a path-F call, from its own arguments."""
    x, cache = args[0], args[1]
    if name == "fused_fbank":
        mel, dct = args[2], args[3]
        return fbank_bound_ms(
            x.shape[0], x.shape[1], kwargs["frame_length"],
            kwargs["frame_shift"], kwargs["n_fft"], kwargs["n_band"],
            mel.shape[-1], mel.shape[-1] if dct is None else dct.shape[-1],
            mfcc=dct is not None)
    b, t, c = x.shape
    if name == "fused_fsmn_layers":
        n_layers, _, pad, pd = cache.shape
        return fsmn_bound_ms(b, t, c, pd, n_layers, args[7], args[8], pad)
    dil, k = args[-3:-1] if name == "fused_mdtc_stream" else args[-2:]
    if name == "fused_mdtc_stream":
        return mdtc_bound_ms(b, t, c, len(dil), k, len(dil) // args[-1],
                             cache.shape[2], True)
    return tcn_bound_ms(b, t, c, len(dil), k, cache.shape[2])


class ShapeTap:
    """Within the ``with``, every call of a wrapper of ``wrappers``
    (path F's by default) on a CUDA tensor, where the path makes it:
    per (kernel, shape) the number of calls and a copy of the first
    call's inputs, on which 17e (18e) holds the kernel against its plain
    version."""

    def __init__(self, wrappers=PATH_F_WRAPPERS):
        self.wrappers = wrappers

    def __enter__(self):
        import importlib

        import torch

        self.shapes, self._saved = {}, []
        for name, where, *_ in self.wrappers:
            mod = importlib.import_module(where)
            fn = getattr(mod, name)

            def tapped(*args, _fn=fn, _name=name, **kwargs):
                if args[0].is_cuda:
                    key = (_name, path_f_shape(_name, args, kwargs))
                    if key not in self.shapes:
                        self.shapes[key] = [0, *_tree_map(
                            lambda v: v.detach().clone()
                            if isinstance(v, torch.Tensor) else v,
                            (args, kwargs))]
                    self.shapes[key][0] += 1
                return _fn(*args, **kwargs)

            setattr(mod, name, tapped)
            self._saved.append((mod, name, fn))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)
        return False


def phase17e_kernel_checks(card, shapes, tag="17e", path="F",
                           device_ms=None, timed=None):
    """Each path-F kernel at every shape path F gave it (``ShapeTap``;
    path G's ``fused_fbank`` too, ``tag`` and ``path`` naming it in the
    lines), on that shape's first inputs: the kernel against its plain
    version on the same card tensors (TOL, or phase 9's fbank limit),
    then both timed (CUDA events, median of 30), the kernel's device time
    (profiler; from ``device_ms`` by (name, shape) where given) and its
    bound from the call's own arguments; where ``timed`` is given, only
    its (name, shape) keys are timed.  Returns {record name:
    [readings]}."""
    import importlib

    out = {}
    for (name, shape), (calls, args, kwargs) in sorted(shapes.items()):
        _, _, plain_mod, kernel_name, (atol, rtol) = next(
            w for w in PATH_F_WRAPPERS if w[0] == name)
        kern_fn = getattr(importlib.import_module(plain_mod), name)
        plain_fn = getattr(importlib.import_module(plain_mod),
                           f"{name}_plain")
        pkw = dict(kwargs)
        if name == "fused_fsmn_layers":
            pkw.pop("packed", None)
        if name == "fused_fbank":
            for key in ("n_fft", "window", "preemphasis", "remove_dc_offset",
                        "twiddles", "low", "bands", "n_band"):
                pkw.pop(key, None)

        def kern():
            return kern_fn(*args, **kwargs)

        def plain():
            return plain_fn(*args, **pkw)

        if name == "fused_fbank" and kwargs.get("dither", 0.0):
            # in-kernel (frame-mode) dither draws Philox noise, which the
            # plain version's torch.randn cannot repeat: the call against
            # the dense plan with the same seed (the same noise), and the
            # call without dither against the plain version
            quiet = dict(dither=0.0, seed=None)
            pairs = [(kern(), kern_fn(*args, **pkw)),
                     (kern_fn(*args, **dict(kwargs, **quiet)),
                      plain_fn(*args, **dict(pkw, **quiet)))]
            # the dither's shift of the features against the plain
            # version's (torch.randn), in distribution
            zm, zv = dither_z(pairs[0][0], pairs[1][0], plain(), pairs[1][1])
            print(f"  {tag} {name} {shape}: the in-kernel dither's shift of "
                  f"the features against the plain version's, per mel bin "
                  f"over {pairs[0][0].shape[0] * pairs[0][0].shape[1]} "
                  f"frames: means within {zm:.2f}, mean squares within "
                  f"{zv:.2f} standard errors (bound {DITHER_Z})", flush=True)
            if not (zm <= DITHER_Z and zv <= DITHER_Z):
                raise AssertionError(f"{tag} {name} {shape}: the in-kernel "
                                     f"dither differs in distribution")
        elif name == "fused_fbank":
            pairs = [(kern(), plain())]
        else:
            pairs = list(zip(kern(), plain()))
        err = max(check_close(f"{tag} {name} {shape}{' cache' if i else ''}",
                              g, w, quiet=True, atol=atol, rtol=rtol)
                  for i, (g, w) in enumerate(pairs))
        if timed is not None and (name, shape) not in timed:
            print(f"  {tag} {name} {shape}: {calls} calls on path {path}; "
                  f"vs plain on the first call's inputs max_abs_err "
                  f"{err:.3e} (bound {atol} abs + {rtol} rel) [{card}]",
                  flush=True)
            out.setdefault(name, []).append({
                "shape": shape, "calls": calls, "max_abs_err": err})
            continue
        ms, plain_ms = kernel_vs_plain_ms(kern, plain)
        dev_ms = (device_ms[(name, shape)] if device_ms is not None
                  and (name, shape) in device_ms
                  else profiled_device_ms(kern, kernel_name))
        bound = path_f_bound(name, args, kwargs)
        dev_txt = "not measured" if dev_ms is None else f"{dev_ms:.4f} ms"
        print(f"  {tag} {name} {shape}: {calls} calls on path {path}; vs "
              f"plain on the first call's inputs max_abs_err {err:.3e} "
              f"(bound {atol} abs + {rtol} rel); kernel {ms:.4f} ms per call "
              f"(device {dev_txt}), plain {plain_ms:.4f} ms, bound "
              f"{bound[0]:.5f} ms ({bound[1]}) [{card}]", flush=True)
        out.setdefault(name, []).append({
            "shape": shape, "calls": calls, "max_abs_err": err, "ms": ms,
            "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1]})
    return out


def merge_path_f(record, launches, readings, fbank_err):
    """Path F's launches (by sub-path) and readings into the kernel
    records; fails if a path-F kernel never launched."""
    rows = {r["name"]: r for r in record}
    totals = {}
    for sub, counts in launches.items():
        for name, n in counts.items():
            if n:
                totals[name] = totals.get(name, 0) + n
                rows[name].setdefault("path_f_launches", {})[sub] = n
    missing = [name for name in kernel_counts() if not totals.get(name)]
    if missing:
        raise AssertionError(f"path F launched no {missing}")
    for name, n in totals.items():
        rows[name]["launches"] += n
    for name, rs in readings.items():
        rows[name]["path_f"] = rs
        rows[name]["max_abs_err"] = max(
            [rows[name]["max_abs_err"]] + [r["max_abs_err"] for r in rs])
    rows["fused_fbank"]["max_abs_err"] = max(
        rows["fused_fbank"]["max_abs_err"], fbank_err)


def phase17_serving(dev, card, work):
    """Path F, the serving daemon: 17a the device featurizer, 17b the
    batched engines at full width, 17c the daemon (bin.serve in a
    subprocess and in process), 17d the serving CLIs, 17e each kernel
    against its plain version at every shape 17a-17d gave it.  Each
    sub-path's launches are counted from 0 and read after it; bin.serve's
    are its own counts.  Returns ({sub-path: {kernel record: launches}},
    {kernel record: [readings]}, the featurizer's largest error, the
    serving figures)."""
    import tempfile

    launches, figures = {}, {}

    def counted(name, fn, *args):
        zero_counts()
        out = fn(*args)
        launches[name] = read_counts()
        return out

    with ShapeTap() as tap:
        err = counted("17a featurizer", phase17a_featurizer, dev, card)
        figures.update(counted("17b engines", phase17b_engines, dev, card,
                               work))
        with tempfile.TemporaryDirectory() as tmp:
            daemon, ctc, served = counted("17c daemons", phase17c_daemons,
                                          dev, card, tmp, work)
            figures.update(daemon)
            counted("17d CLIs", phase17d_clis, dev, card, ctc)
    launches["17c bin.serve (its own counts)"] = served
    in_process = {}
    for sub, counts in launches.items():
        if sub != "17c bin.serve (its own counts)":
            for k, v in counts.items():
                in_process[k] = in_process.get(k, 0) + v
    tapped = {}
    for (name, _), (calls, *_) in tap.shapes.items():
        tapped[name] = tapped.get(name, 0) + calls
    if tapped != {k: v for k, v in in_process.items() if v}:
        raise AssertionError(f"path F: the calls seen by shape {tapped} "
                             f"are not the launches counted {in_process}")
    readings = phase17e_kernel_checks(card, tap.shapes)
    return launches, readings, err, figures


# path G (phase 18): device-resident epochs.  The flagship corpus at its
# training shape (bench.py's B=512 x 2 s), its depth cut to keep the run
# inside its time limit: 4,096 train rows, 8 steps of B=512 an epoch
# (0.26 GB of int16 on the card; bench.py's 16,384), and 1,024 cv rows
# (8,192 and 2,048 before path L was added; cut for its time)
RESIDENT_ROWS, RESIDENT_CV_ROWS = 4096, 1024
# the largest copy from the host a resident step may make: the step's
# scalars and ctypes arguments, never a wave (a B=512 x 2 s batch is
# 32.8 MB of int16)
H2D_LIMIT = 64 << 10
# the resident step against the host-fed step on the same rows, state,
# seed and step: the passes are bitwise reproducible (phase 6), so equal
RESIDENT_STEP_TOL = 0.0
# the timed steps' rounds in turns (18c, 18f), forward then back
STEP_ROUNDS = 2
PATH_G_CONF = dict(TRAIN_DATASET_CONF, fused_frontend=True)
# fused_fbank (18a-18f) and the DS-TCN serving kernel (18g's scoring)
PATH_G_WRAPPERS = tuple(w for w in PATH_F_WRAPPERS
                        if w[0] in ("fused_fbank", "fused_ds_tcn"))
# 18f: bench.py's augmentation banks (bench_epoch, BENCH_DEVICE_AUG):
# 50 noise clips x 8 crops at amplitude 300, SNR 0-15 dB; 20 RIRs of
# 4,000 samples; reverb_prob 0.5, noise_prob 0.8
AUG_NOISE_ROWS, AUG_NOISE_AMP, AUG_SNR_HI = 50 * 8, 300.0, 15.0
AUG_RIRS, AUG_RIR_LEN = 20, 4000
AUG_REVERB_PROB, AUG_NOISE_PROB = 0.5, 0.8
# the card's augmentation against the same module on the CPU, stage by
# stage on the same inputs and draws (tests/test_device_aug.py's bounds)
AUG_SPEED_ATOL, AUG_REVERB_ATOL = 2.0, 0.15
AUG_NOISE_RTOL, AUG_NOISE_ATOL = 1e-4, 0.05
# each stage against float64 numpy on AUG_F64_ROWS rows: relative L2
AUG_F64_RTOL, AUG_F64_ROWS = 1e-4, 4
NOISY_RECIPE = os.path.join("examples", "synthetic_noisy")
NOISY_EPOCHS = 2
# the argument of each pass that holds its depthwise kernel (K, C), and
# of each pass with a conv, its dilation
PASS_DW_ARG = {"f1": 1, "f2": 1, "f3": 1, "b3": 4, "b4": 4}
PASS_DILATION_ARG = {"f1": -1, "f2": -1, "f3": -1, "b3": -2, "b4": -2}


def resident_arrays(rows, seed):
    """``rows`` utterances of TRAIN_SECONDS in int16, ``train_batch``'s
    signal (even rows a 500 Hz keyword tone in noise, odd rows noise),
    made 1,024 rows at a time."""
    rng = np.random.default_rng(seed)
    n = TRAIN_SECONDS * RATE
    tone = (4000 * np.sin(2 * np.pi * 500 * np.arange(n) / RATE)).astype(
        np.float32)
    waves = np.empty((rows, n), np.int16)
    for lo in range(0, rows, 1024):
        w = rng.standard_normal((min(1024, rows - lo), n),
                                dtype=np.float32) * 300
        w[::2] += tone
        waves[lo:lo + len(w)] = np.clip(np.rint(w), -32768, 32767)
    return {"waves": waves, "wave_lengths": np.full((rows,), n, np.int32),
            "target": (np.arange(rows) % 2 - 1).astype(np.int32),
            "target_lengths": np.ones((rows,), np.int32)}


def h2d_copies(fn):
    """Bytes of each host-to-device copy in the profiler's trace of one
    call of ``fn`` (its chrome trace's "Memcpy HtoD" entries).  The
    trace opens with a short spin kernel, as ``profiled_step``'s: a
    trace now and then loses its first device entries."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return [int(e.get("args", {}).get("bytes", 0)) for e in events
            if str(e.get("name", "")).startswith("Memcpy HtoD")]


def host_cpu_ms(step, reps=10):
    """CPU time of this thread per call of ``step`` over ``reps`` calls
    back to back (the host's own work: enqueue, copies from pageable
    memory), which time taken by other processes on a shared host does
    not move; the synchronise after the last call is outside the
    reading (its wait may spin).  The thread clock ticks in whole
    milliseconds or coarser, so the calls are read together."""
    import torch

    torch.cuda.synchronize()
    t0 = time.thread_time()
    for _ in range(reps):
        step()
    used = time.thread_time() - t0
    torch.cuda.synchronize()
    return used / reps * 1e3


def path_g_specs(fbank_shapes, pass_shapes, saved_dir):
    """What the fresh process re-creates of each path-G shape: the
    pass, B, T, C, dilation and K of a pass (each pass at each B x T x C
    at its largest dilation only: the others read "not measured", cut
    for path L's time); B, S and whether the call dithered of an
    fbank call; a DS-TCN call's own inputs, saved under ``saved_dir``."""
    import torch

    specs, widest = [], {}
    for (record, shape), (_, name, args) in pass_shapes.items():
        b, t, c = args[0].shape
        d = args[PASS_DILATION_ARG[name]] if name in PASS_DILATION_ARG else 1
        k = args[PASS_DW_ARG[name]].shape[0] if name in PASS_DW_ARG else 5
        spec = {"record": record, "shape": shape, "pass": name,
                "b": b, "t": t, "c": c, "d": int(d), "k": k}
        key = (record, b, t, c)
        if key not in widest or widest[key]["d"] < spec["d"]:
            widest[key] = spec
    specs += widest.values()
    for (record, shape), (_, args, kwargs) in fbank_shapes.items():
        if record != "fused_fbank":
            path = os.path.join(saved_dir, f"{len(specs)}.pt")
            torch.save((args, kwargs), path)
            specs.append({"record": record, "shape": shape, "saved": path})
            continue
        b, n = args[0].shape
        specs.append({"record": record, "shape": shape, "b": b, "s": n,
                      "dither": bool(kwargs.get("dither", 0.0))})
    return specs


def path_g_child(model_conf, specs, device="cuda"):
    """In a fresh process (``path_g_traces``): (1) the copies from the
    host in the trace of one resident step at B=512 x 2 s, of one with
    18f's augmentation, and of one host-fed step (int16 rows) as the
    witness that the trace shows them, three traces of each (the
    resident steps' with the largest copy; the host-fed step's first
    that shows its waves); (2) ``traced_idle`` of the resident step, of
    the augmented resident step and of the augmentation alone; (3) the
    device time per call of each kernel at each path-G shape of
    ``specs``, on seeded inputs of that shape (a pass with its block
    reduction); (4) 16e's ``traced_idle`` of each of ``IDLE_STEPS``.
    Prints one line ``PATH_G {...}``.  ``device`` is the card (the CPU
    in a rehearsal)."""
    import torch

    from wekws_tpu_torch.data.resident import gather_rows, stage_arrays
    from wekws_tpu_torch.frontend.features import FeatureExtractor
    from wekws_tpu_torch.frontend.features import (
        frontend_config_from_dataset_conf as frontend_config,
    )
    from wekws_tpu_torch.ops.fused_mdtc_train import (
        PASS_IDS,
        PASSES,
        kernel_name,
        seeded_block_inputs,
        trace_pass_inputs,
    )
    from wekws_tpu_torch.ops.fused_tcn import fused_ds_tcn
    from wekws_tpu_torch.train.steps import step_generator

    dev = torch.device(device)
    host = resident_arrays(2 * TRAIN_B, SEED + 20)
    corpus = stage_arrays(host, device=dev)
    trainer = path_g_trainer(dev, model_conf)
    state = trainer.init_state()
    aug_trainer = path_g_trainer(dev, model_conf)
    aug_trainer.pipeline.wave_aug = flagship_aug(
        dev, corpus.arrays["waves"].shape[1], SEED + 22)[0]
    aug_state = aug_trainer.init_state()
    rows = corpus.epoch_index(0, TRAIN_B)[0]
    rows_dev = torch.from_numpy(rows).to(dev)
    int16_batch = {k: v[rows] for k, v in host.items()}

    def resident():
        trainer.train_step(state, gather_rows(corpus.arrays, rows_dev), SEED,
                           1e-3)

    def aug_resident():
        aug_trainer.train_step(aug_state, gather_rows(corpus.arrays,
                                                      rows_dev), SEED, 1e-3)

    def host_int16():
        trainer.train_step(state, int16_batch, SEED, 1e-3)

    for _ in range(2):
        resident()
        aug_resident()
        host_int16()

    def largest(fn):
        return max((h2d_copies(fn) for _ in range(3)),
                   key=lambda c: max(c, default=0))

    copies, aug_copies = largest(resident), largest(aug_resident)
    wave_bytes = TRAIN_B * TRAIN_SECONDS * RATE * 2
    for _ in range(3):
        witness = h2d_copies(host_int16)
        if sum(witness) >= wave_bytes:
            break
    step = traced_idle(resident)
    aug_step = traced_idle(aug_resident)
    # the augmentation alone, on the step's rows and generator
    batch = gather_rows(corpus.arrays, rows_dev)
    waves = batch["waves"].to(torch.float32)
    lengths = batch["wave_lengths"].to(torch.int64)
    aug = aug_trainer.pipeline.wave_aug
    aug_alone = traced_idle(lambda: aug(waves, lengths,
                                        step_generator(SEED, 0, dev)))

    gen = torch.Generator().manual_seed(SEED + 21)
    fe = FeatureExtractor(frontend_config(PATH_G_CONF), use_fused=True)
    device_ms, calls = {}, {}
    for spec in specs:
        if "pass" in spec:
            name, key = spec["pass"], tuple(
                spec[x] for x in ("b", "t", "c", "d", "k"))
            if key not in calls:
                p, x, dy = seeded_block_inputs(gen, *key[:3], key[4], dev)
                calls[key] = trace_pass_inputs(x, p, dy, key[3])
            args = calls[key][name]
            names = (kernel_name(name, key[2]),) if name == "f4" else (
                kernel_name(name, key[2]), f"reduce_kernel<{PASS_IDS[name]}>")
            _, _, found = profiled_step(lambda: PASSES[name](*args), names)
            ms = (None if any(v is None for v in found.values())
                  else sum(found.values()))
        elif "saved" in spec:  # the DS-TCN kernel on its call's inputs
            args, kwargs = torch.load(spec["saved"], map_location=dev)
            _, _, found = profiled_step(
                lambda: fused_ds_tcn(*args, **kwargs), ("fused_ds_tcn_kernel",))
            ms = found["fused_ds_tcn_kernel"]
        else:
            waves = (300 * torch.randn((spec["b"], spec["s"]),
                                       generator=gen)).to(dev)
            seed = torch.zeros((1,), dtype=torch.int64, device=dev)
            _, _, found = profiled_step(
                lambda: fbank_call(fe, waves, "fft",
                                   seed if spec["dither"] else None),
                ("fused_fbank_kernel",))
            ms = found["fused_fbank_kernel"]
        device_ms[f"{spec['record']}|{spec['shape']}"] = ms
    # 16e: the train steps of 15a, 16a and 16d, re-created from their seeds
    idle = {tag: traced_idle(idle_step(tag, dev)) for tag in IDLE_STEPS}
    print("PATH_G " + json.dumps({
        "resident_copies": copies, "host_copies": witness,
        "aug_copies": aug_copies, "resident": step, "aug_resident": aug_step,
        "aug_alone": aug_alone, "device_ms": device_ms, "idle": idle}),
        flush=True)


def run_child(call, args, tag, timeout_s=600):
    """``chip_smoke.<call>(*args)`` in a fresh process, its output passed
    on line by line; returns the JSON of its last line that starts with
    ``tag``.  Late in this process the profiler's trace loses records (a
    probe after each phase found some copies from the host missing after
    phase 13, all of them after phase 15, and kernels too), so the
    traces read after phase 13 are taken where nothing ran before."""
    import tempfile

    here = os.path.dirname(os.path.abspath(__file__))
    found = None
    # the child's stderr (its logging) goes to a file, so that no line of
    # it can land inside a stdout line
    with tempfile.TemporaryFile("w+") as err, TimeLimit(timeout_s, call):
        proc = subprocess.Popen(
            [sys.executable, "-c", "import json, sys, chip_smoke; "
             f"chip_smoke.{call}(*json.loads(sys.argv[1]))",
             json.dumps(args)], cwd=here, stdout=subprocess.PIPE,
            stderr=err, text=True)
        try:
            for line in proc.stdout:
                if line.startswith(f"{tag} "):
                    found = json.loads(line[len(tag) + 1:])
                else:
                    print(line, end="", flush=True)
            code = proc.wait()
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if code != 0 or found is None:
            err.seek(0)
            raise AssertionError(f"{call} failed in its process ({code}): "
                                 f"{err.read()[-3000:]}")
    return found


def traced_idle(step):
    """The untraced median of 10 calls of ``step`` (``timed_steps``,
    after two warm-up calls), then one call traced (``profiled_step``)
    with its own wall clock from its start to the end of its last device
    work: {busy_ms, wall_ms, entries, untraced_ms}."""
    import torch

    untraced_ms = timed_steps(step)[0]
    walls = []

    def traced():
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)

    busy, entries, _ = profiled_step(traced)
    return {"busy_ms": busy, "wall_ms": walls[-1], "entries": entries,
            "untraced_ms": untraced_ms}


def idle_share(tag, reading, card, where="in a fresh process"):
    """The two bounds of a ``traced_idle`` reading's idle share: the
    upper, 1 - busy / wall of that one traced call (tracing adds host
    time to the wall), and the lower, 1 - busy / the untraced median
    (the traced device time over a wall without the tracer's host
    time; below 0 where the untraced step is device-bound).  Fails
    where the device time is not in (0, traced wall]."""
    busy, wall = reading["busy_ms"], reading["wall_ms"]
    untraced = reading["untraced_ms"]
    if not 0 < busy <= wall:
        raise AssertionError(f"{tag}: the traced step's device time {busy} "
                             f"ms against its wall clock {wall} ms")
    upper, lower = 1 - busy / wall, 1 - busy / untraced
    print(f"  {tag}, traced {where}: device time {busy:.3f} ms in "
          f"{reading['entries']} device entries; idle between {lower:.1%} "
          f"of the untraced median of 10 ({untraced:.3f} ms) and "
          f"{upper:.1%} of the traced step's own {wall:.3f} ms wall clock "
          f"[{card}]", flush=True)
    return {"idle_untraced": lower, "idle_traced": upper}


IDLE_STEPS = ("15a FSMN-CTC", "16a speechcommand_v1 MDTC", "16d GRU")


def idle_step(tag, dev):
    """The train step of phase ``tag`` (``IDLE_STEPS``) re-created from
    its seeds: its config, batch and pipelines (dither and spec_aug on),
    the model at its seeded start."""
    import torch

    from wekws_tpu_torch.data import DeviceFeaturePipeline
    from wekws_tpu_torch.models import init_model
    from wekws_tpu_torch.train import Trainer

    gen = torch.Generator().manual_seed(SEED)
    if tag.startswith("15a"):
        batch, cvp, _, _, conf = ctc_setup(dev)
        trainer = Trainer(init_model(conf, gen),
                          DeviceFeaturePipeline.from_conf(CTC_DATASET_CONF),
                          cvp, "ctc", grad_clip=5.0, device=dev)
    elif tag.startswith("16a"):
        configs, dconf, _, unfused_dconf = sc_confs()
        batch = class_batch(np.random.default_rng(SEED + 16), SC_TRAIN_B,
                            SC_SECONDS, SC_CLASSES)
        cvp = DeviceFeaturePipeline.from_conf(unfused_dconf, training=False)
        with torch.no_grad():
            feats, _ = cvp(torch.as_tensor(batch["waves"], device=dev),
                           torch.as_tensor(batch["wave_lengths"],
                                           device=dev))
        trainer = Trainer(
            init_model(sc_model_conf(configs, feats), gen),
            DeviceFeaturePipeline.from_conf(dconf),
            DeviceFeaturePipeline.from_conf(dconf, training=False), "ce",
            grad_clip=5.0, weight_decay=configs["optim_conf"]["weight_decay"],
            device=dev)
    else:
        dconf, batch, cvp, _, _, conf = gru_setup(dev)
        trainer = Trainer(init_model(conf, gen),
                          DeviceFeaturePipeline.from_conf(dconf), cvp,
                          "max_pooling", grad_clip=5.0, min_duration=50,
                          device=dev)
    state = trainer.init_state()
    return lambda: trainer.train_step(state, batch, SEED, 1e-3)


def idle_shares(card, found):
    """16e: the idle shares of 15a's, 16a's and 16d's train steps, each
    from one step traced with its own wall clock (``traced_idle``) in
    path G's fresh process (``path_g_child``'s "idle")."""
    return {tag: idle_share(tag, found[tag], card) for tag in IDLE_STEPS}


def path_g_traces(model_conf, specs):
    """``path_g_child``'s readings, from a child process (``run_child``).
    Fails where the host-fed step's trace does not show its waves."""
    found = run_child("path_g_child", [model_conf, specs], "PATH_G")
    wave_bytes = TRAIN_B * TRAIN_SECONDS * RATE * 2
    if sum(found["host_copies"]) < wave_bytes:
        raise AssertionError(f"the host-fed step's trace shows no copy of "
                             f"its {wave_bytes}-byte waves: "
                             f"{found['host_copies']}")
    return found


def pass_shape(name, args):
    b, t, c = args[0].shape
    if isinstance(args[-1], str):  # a bf16 call's trailing precision
        args = args[:-1]
    d = args[PASS_DILATION_ARG[name]] if name in PASS_DILATION_ARG else 1
    return f"B={b} T={t} C={c} d={int(d)}"


class PassTap:
    """Within the ``with``, every training pass that the fused block
    (``FusedTCNBlockTrain``) runs on a CUDA tensor: per (pass record,
    shape) the number of calls and a copy of the first call's inputs,
    on which 18e holds the pass against its plain version."""

    def __enter__(self):
        import torch

        from wekws_tpu_torch.ops import fused_mdtc_train

        self.shapes = {}
        self._mod, self._saved = fused_mdtc_train, fused_mdtc_train._block_run

        def run(name, *args):
            if args[0].is_cuda:
                key = (f"fused_train_{name}", pass_shape(name, args))
                if key not in self.shapes:
                    self.shapes[key] = [0, name, _tree_map(
                        lambda v: v.detach().clone()
                        if isinstance(v, torch.Tensor) else v, args)]
                self.shapes[key][0] += 1
            return self._saved(name, *args)

        fused_mdtc_train._block_run = run
        return self

    def __exit__(self, *exc):
        self._mod._block_run = self._saved
        return False


def pass_rel_err(got, want):
    """A pass's largest error relative to the scale ``compare_pass``
    holds it to: each (B, T, C) output's largest |value|, and for the
    sums over frames the largest |value| of the group (at least 1).
    Path G's sums reach 1e8 (bn0's sum of squares over 101,376 frames
    of activations about 30 in size), so their abs error reads large."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    rel, sums = [], []
    for a, b in zip(got, want):
        err = float((a.float() - b.float()).abs().max())
        if b.dim() == 3:
            rel.append(err / max(float(b.abs().max()), 1e-30))
        else:
            sums.append((err, float(b.abs().max())))
    if sums:
        rel.append(max(e for e, _ in sums)
                   / max([m for _, m in sums] + [1.0]))
    return max(rel)


def phase18e_pass_checks(card, shapes, device_ms, tag="18e", path="G"):
    """Each training pass at every shape path G gave it (``PassTap``),
    on that shape's first inputs: against its plain version on the same
    card tensors (``compare_pass``: (B, T, C) outputs 1e-4 abs + 1e-4
    rel, the pass's sums 1e-3 of the largest of their group, as phase
    6), both timed (CUDA events, median of 30), the pass's device time
    (its kernel and its block reduction: ``device_ms`` by (record,
    shape), from ``path_g_traces``) and its bound from its own
    arguments (where traced: ``path_g_specs``).  Returns {record name:
    [readings]}."""
    from wekws_tpu_torch.ops.fused_mdtc_train import PASSES, compare_pass

    out = {}
    for (record, shape), (calls, name, args) in sorted(shapes.items()):
        b, t, c = args[0].shape

        def kern():
            return PASSES[name](*args)

        def plain():
            return PASSES[name].plain(*args)

        got, want = kern(), plain()
        err = compare_pass(f"{tag} {record} {shape}", got, want)
        rel = pass_rel_err(got, want)
        ms, plain_ms = kernel_vs_plain_ms(kern, plain)
        dev_ms = device_ms.get((record, shape))
        k = args[PASS_DW_ARG[name]].shape[0] if name in PASS_DW_ARG else 1
        bound, bound_by = train_pass_bound_ms(name, b, t, c, k)
        dev_txt = "not measured" if dev_ms is None else f"{dev_ms:.4f} ms"
        print(f"  {tag} {record} {shape}: {calls} calls on path {path}; vs "
              f"plain "
              f"on the first call's inputs max_abs_err {err:.3e} "
              f"({rel:.2e} of its scale); kernel "
              f"{ms:.4f} ms per call (device {dev_txt} with its "
              f"reduction), plain {plain_ms:.4f} ms, bound {bound:.5f} ms "
              f"({bound_by}) [{card}]", flush=True)
        out.setdefault(record, []).append({
            "shape": shape, "calls": calls, "max_abs_err": err,
            "max_rel_err": rel, "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by})
    return out


def path_g_counts():
    """The launch counts of path G's kernels, by kernel record."""
    from wekws_tpu_torch.ops.fused_frontend import fused_fbank
    from wekws_tpu_torch.ops.fused_mdtc_train import PASSES
    from wekws_tpu_torch.ops.fused_tcn import fused_ds_tcn

    counts = {f"fused_train_{name}": PASSES[name].launches
              for name in TRAIN_PASSES}
    counts["fused_fbank"] = fused_fbank.launches
    counts["fused_ds_tcn"] = fused_ds_tcn.launches
    return counts


def phase18a_staging(dev, card):
    """The flagship corpus made from a seed and staged with
    ``stage_arrays``; rows read back from the card.  Returns the train
    and cv corpora and the train arrays on the host."""
    import torch

    from wekws_tpu_torch.data.resident import stage_arrays

    t0 = time.perf_counter()
    host = resident_arrays(RESIDENT_ROWS, SEED + 18)
    cv_host = resident_arrays(RESIDENT_CV_ROWS, SEED + 19)
    made_s = time.perf_counter() - t0
    before = torch.cuda.memory_allocated(dev)
    corpus = stage_arrays(host, device=dev)
    cv_corpus = stage_arrays(cv_host, device=dev)
    for c, h in ((corpus, host), (cv_corpus, cv_host)):
        if c.arrays["waves"].dtype != torch.int16 or c.n != len(h["waves"]):
            raise AssertionError(f"staged waves {c.arrays['waves'].dtype}, "
                                 f"{c.n} rows")
        for key in ("wave_lengths", "target", "target_lengths"):
            if not np.array_equal(c.arrays[key].cpu().numpy(), h[key]):
                raise AssertionError(f"staged {key} differ from the host's")
        for row in (0, 1, c.n // 2 + 1, c.n - 1):
            if not np.array_equal(c.arrays["waves"][row].cpu().numpy(),
                                  h["waves"][row]):
                raise AssertionError(f"staged row {row} differs")
    up_s = corpus.wait_uploaded() + cv_corpus.wait_uploaded()
    nbytes = corpus.nbytes + cv_corpus.nbytes
    print(f"  {RESIDENT_ROWS} train + {RESIDENT_CV_ROWS} cv rows x "
          f"{TRAIN_SECONDS} s int16 (made in {made_s:.1f} s on the host): "
          f"{nbytes} bytes staged in {up_s:.4f} s, {nbytes / up_s / 1e9:.2f} "
          f"GB/s (pageable host memory, one copy an array); memory "
          f"allocated {before} -> {torch.cuda.memory_allocated(dev)} bytes; "
          f"rows 0, 1, n/2 + 1, n - 1 and every length and target read "
          f"back equal [{card}]", flush=True)
    return corpus, cv_corpus, host


def path_g_trainer(dev, model_conf, dataset_conf=PATH_G_CONF):
    """The flagship (``model_conf``: phase 7's, with ``fused_train``)
    with ``fused_frontend``, wave dither and spec_aug (``dataset_conf``),
    its head started small as phase 7's."""
    import torch

    from wekws_tpu_torch.data import DeviceFeaturePipeline
    from wekws_tpu_torch.models import init_model
    from wekws_tpu_torch.train import Trainer

    model = init_model(model_conf, torch.Generator().manual_seed(SEED))
    with torch.no_grad():
        model.classifier.linear.weight.mul_(0.01)
    return Trainer(model, DeviceFeaturePipeline.from_conf(dataset_conf),
                   DeviceFeaturePipeline.from_conf(dataset_conf,
                                                   training=False),
                   "max_pooling", grad_clip=5.0, min_duration=5, device=dev)


def phase18b_same_step(dev, trainer, corpus, cv_corpus):
    """One resident train step against ``Trainer.train_step`` on the
    same rows copied to the host and back, from the same state, seed and
    step; one resident cv step against ``Trainer.cv_step``.  Returns the
    trained state."""
    import torch

    from wekws_tpu_torch.data.resident import gather_rows

    state = trainer.init_state()
    twin = copy.deepcopy(state)
    epoch_idx = torch.from_numpy(corpus.epoch_index(0, TRAIN_B)).to(dev)
    state, got = trainer.train_step(
        state, gather_rows(corpus.arrays, epoch_idx[0]), SEED, 1e-3)
    rows = {k: v[epoch_idx[0]].cpu().numpy()
            for k, v in corpus.arrays.items()}
    twin, want = trainer.train_step(twin, rows, SEED, 1e-3)
    worst = max(float((got[k] - want[k]).abs()) for k in got)
    ref = twin.model.state_dict()
    for name, val in state.model.state_dict().items():
        worst = max(worst, float((val.double() - ref[name].double())
                                 .abs().max()))
    if not worst <= RESIDENT_STEP_TOL:
        raise AssertionError(f"resident step vs host-fed step: {worst} > "
                             f"{RESIDENT_STEP_TOL}")
    idx, ok = (torch.from_numpy(a).to(dev)
               for a in cv_corpus.cv_index(TRAIN_B))
    cv_got = trainer.cv_step(state, gather_rows(cv_corpus.arrays, idx[0],
                                                ok[0]))
    cv_rows = {k: v[idx[0]].cpu().numpy()
               for k, v in cv_corpus.arrays.items()}
    cv_want = trainer.cv_step(state, cv_rows)
    cv_worst = max(float((cv_got[k] - cv_want[k]).abs()) for k in cv_got)
    if not cv_worst <= RESIDENT_STEP_TOL or int(cv_got["count"]) != TRAIN_B:
        raise AssertionError(f"resident cv step vs Trainer.cv_step: "
                             f"{cv_got} vs {cv_want}")
    print(f"  resident step vs host-fed step (B={TRAIN_B} x {TRAIN_SECONDS} "
          f"s, the same rows, state, seed and step): loss "
          f"{float(got['loss']):.6f}, largest difference of loss, accuracy, "
          f"grad norm, every parameter and BN statistic {worst:.1e} "
          f"(limit {RESIDENT_STEP_TOL}); cv step: {int(cv_got['count'])} "
          f"utterances, largest difference {cv_worst:.1e}", flush=True)
    return state


def phase18c_epoch(dev, card, trainer, state, corpus, cv_corpus, host,
                   batch, host_ms):
    """An epoch through ``Executor.train_resident`` and one
    ``cv_resident`` pass, timed; the resident step beside the host-fed
    step (float32 waves, as phase 8's batch, and int16 rows), in turns
    over STEP_ROUNDS rounds, by wall clock and by the thread's CPU time.
    The step's device time and copies from the host are traced in a
    fresh process (``path_g_traces``)."""
    import torch

    from wekws_tpu_torch.data.resident import gather_rows
    from wekws_tpu_torch.train import Executor

    ex = Executor(trainer, log_interval=10 ** 9)
    steps = RESIDENT_ROWS // TRAIN_B
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    e0.record()
    state, summary = ex.train_resident(state, corpus, SEED, 1e-3, 1,
                                       TRAIN_B)
    e1.record()
    e1.synchronize()
    wall_ms = (time.perf_counter() - t0) / steps * 1e3
    event_ms = e0.elapsed_time(e1) / steps
    t0 = time.perf_counter()
    cv = ex.cv_resident(state, cv_corpus, TRAIN_B, 1)
    cv_s = time.perf_counter() - t0
    if summary["batches"] != steps or not np.isfinite(
            [summary["train_loss"], cv["cv_loss"]]).all() or \
            cv["utts"] != RESIDENT_CV_ROWS:
        raise AssertionError(f"resident epoch: {summary}, cv {cv}")
    print(f"  Executor.train_resident: {steps} steps of B={TRAIN_B} x "
          f"{TRAIN_SECONDS} s, {wall_ms:.3f} ms a step by wall clock, "
          f"{event_ms:.3f} ms by CUDA events, "
          f"{summary['audio_seconds_per_s']:.1f} audio-s/s, loss "
          f"{summary['train_loss']:.5f}; cv_resident {cv['utts']} "
          f"utterances in {cv_s:.3f} s, loss {cv['cv_loss']:.5f} [{card}]",
          flush=True)

    rows = corpus.epoch_index(2, TRAIN_B)[0]
    rows_dev = torch.from_numpy(rows).to(dev)

    def resident():
        trainer.train_step(state, gather_rows(corpus.arrays, rows_dev), SEED,
                           1e-3)

    int16_batch = {k: v[rows] for k, v in host.items()}

    def host_int16():
        trainer.train_step(state, int16_batch, SEED, 1e-3)

    def host_f32():
        trainer.train_step(state, batch, SEED, 1e-3)

    # the host's clock moves by 10-20 ms between rounds on this step
    # (the card's host is shared): rounds in turns, forward and back
    order = (("host-fed float32", host_f32), ("host-fed int16", host_int16),
             ("resident", resident))
    rounds = {label: [] for label, _ in order}
    cpu = {label: [] for label, _ in order}
    for r in range(STEP_ROUNDS):
        for label, fn in (order if r % 2 == 0 else order[::-1]):
            rounds[label].append(timed_steps(fn)[0])
            cpu[label].append(host_cpu_ms(fn))
    times = {label: float(np.median(ms)) for label, ms in rounds.items()}
    print(f"  train step by wall clock, the median of {STEP_ROUNDS} rounds' "
          f"medians of 10 (each round's) in turns: "
          + "; ".join(f"{label} {times[label]:.3f} ms ("
                      + ", ".join(f"{x:.1f}" for x in ms) + ")"
                      for label, ms in rounds.items())
          + f"; phase 8's host-fed step (unfused frontend) {host_ms:.3f} ms "
          f"[{card}]", flush=True)
    print("  the host's CPU time a step (this thread, over 10 steps a round): "
          + "; ".join(f"{label} {float(np.median(ms)):.3f} ms ("
                      + ", ".join(f"{x:.1f}" for x in ms) + ")"
                      for label, ms in cpu.items()) + f" [{card}]",
          flush=True)
    return {"resident_ms": rounds["resident"],
            "host_f32_ms": rounds["host-fed float32"],
            "host_int16_ms": rounds["host-fed int16"],
            "resident_cpu_ms": cpu["resident"],
            "host_f32_cpu_ms": cpu["host-fed float32"],
            "host_int16_cpu_ms": cpu["host-fed int16"],
            "resident_epoch_ms": wall_ms, "resident_event_ms": event_ms,
            "resident_median_ms": times["resident"],
            "audio_s_per_s": summary["audio_seconds_per_s"]}


def phase18d_cli(dev, card, recipe_rates):
    """``bin.train --device_resident`` on the committed corpus
    (``conf_torch/mdtc_flagship.yaml``) for RECIPE_EPOCHS epochs, then
    average, score and DET as phase 14.  Returns the epochs'
    audio-s/s."""
    import tempfile

    import torch
    import yaml

    from wekws_tpu_torch.bin import train

    config = os.path.join(RECIPE, "conf_torch", "mdtc_flagship.yaml")
    with open(config) as f:
        configs = yaml.safe_load(f)
    batch_size = configs["dataset_conf"]["batch_conf"]["batch_size"]
    with tempfile.TemporaryDirectory() as tmp:
        lists = recipe_lists(tmp)
        exp = os.path.join(tmp, "exp")
        argv = ["--train_data", lists["train"], "--cv_data", lists["dev"],
                "--min_duration", "20", "--seed", "666", "--cmvn_file",
                os.path.join(RECIPE, "data", "global_cmvn"), "--norm_var",
                "--num_epochs", str(RECIPE_EPOCHS), "--device_resident",
                "--device", dev.type]
        before = path_g_counts()
        t0 = time.perf_counter()
        with PlainOnCuda() as plain, TimeLimit(RECIPE_TIMEOUT_S,
                                               "bin.train --device_resident"):
            train.main(["--config", config, "--model_dir", exp] + argv)
            torch.cuda.synchronize()
        plain.check("bin.train --device_resident")
        train_s = time.perf_counter() - t0
        after = path_g_counts()
        with open(os.path.join(exp, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        cv_losses = []
        for e in range(RECIPE_EPOCHS):
            for name in (f"{e}.pt", f"{e}.yaml"):
                if not os.path.exists(os.path.join(exp, name)):
                    raise AssertionError(f"bin.train --device_resident "
                                         f"wrote no {name}")
            with open(os.path.join(exp, f"{e}.yaml")) as f:
                cv_losses.append(float(yaml.safe_load(f)["cv_loss"]))
        train_losses = [r["train_loss"] for r in records]
        steps = dict(RECIPE_SPLITS)["train"] // batch_size
        cv_batches = math.ceil(dict(RECIPE_SPLITS)["dev"] / batch_size)
        want = {f"fused_train_{p}": 17 * steps * RECIPE_EPOCHS
                for p in TRAIN_PASSES}
        want["fused_fbank"] = (steps + cv_batches) * RECIPE_EPOCHS
        want["fused_ds_tcn"] = 0
        got = {k: after[k] - before[k] for k in after}
        if len(records) != RECIPE_EPOCHS or not np.isfinite(
                train_losses + cv_losses).all() or got != want or any(
                r["batches"] != steps for r in records):
            raise AssertionError(f"bin.train --device_resident: records "
                                 f"{records}, cv losses {cv_losses}, "
                                 f"launches {got} (want {want})")
        rates = [r["audio_seconds_per_s"] for r in records]
        print(f"  bin.train --device_resident: {RECIPE_EPOCHS} epochs of "
              f"{steps} steps of B={batch_size} from the staged corpus, "
              f"{train_s:.1f} s wall; train losses {train_losses}, cv "
              f"losses {cv_losses}; launches {got}, no plain version on a "
              f"CUDA tensor; audio-s/s per epoch "
              f"{', '.join(f'{x:.1f}' for x in rates)} against phase 14's "
              f"host-fed {', '.join(f'{x:.1f}' for x in recipe_rates)} "
              f"[{card}]", flush=True)
        average_score_det(exp, lists, dev, card, " (resident)")
    return rates


def flagship_aug(dev, width, seed):
    """18f's ``DeviceWaveAug`` on ``dev`` for staged waves ``width``
    samples wide, from ``seed``: bench.py's banks (AUG_*) on the
    full-utterance DFT (35,556 + 4,000 - 1 samples: (a, b) = (320, 128),
    n = 40,960 at 2 s), speeds 0.9, 1.0 and 1.1 by row group.  Returns
    it and its RIRs (float64, L2-normalised)."""
    import torch

    from wekws_tpu_torch.data.device_aug import DeviceWaveAug, MatmulFFT

    rng = np.random.default_rng(seed)
    out_len = int(np.ceil(width / 0.9))
    rows = (rng.standard_normal((AUG_NOISE_ROWS, out_len))
            * AUG_NOISE_AMP).astype(np.float32)
    rirs = rng.standard_normal((AUG_RIRS, AUG_RIR_LEN))
    rirs /= np.sqrt((rirs ** 2).sum(1, keepdims=True))
    fft = MatmulFFT.for_length(out_len + AUG_RIR_LEN - 1, device=dev)
    spec = np.stack([fft.spectrum_mat_half(r).reshape(-1) for r in rirs])
    aug = DeviceWaveAug(
        speed_perturb=True, fft=fft,
        rir_re=torch.from_numpy(spec.real.copy()).to(dev),
        rir_im=torch.from_numpy(spec.imag.copy()).to(dev),
        reverb_prob=AUG_REVERB_PROB, noise_rows=torch.from_numpy(rows).to(dev),
        snr_lo=torch.zeros(AUG_NOISE_ROWS, device=dev),
        snr_hi=torch.full((AUG_NOISE_ROWS,), AUG_SNR_HI, device=dev),
        noise_prob=AUG_NOISE_PROB)
    return aug, rirs


def rel_l2(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def float64_chain(inputs, stages, rows, speed_of, draws, aug, rirs):
    """Each stage's output on ``rows`` against float64 numpy on that
    stage's input from the card: the host ``audio.speed_perturb``
    (float64 positions), ``np.convolve`` with the picked RIR, the
    reference's SNR mix.  ``inputs``: (waves, lengths); ``stages``: the
    speed stage's (waves, lengths), reverb's and noise's waves.
    Returns the worst relative L2 by stage."""
    from wekws_tpu_torch.data import audio

    def host(t):
        return t.cpu().numpy()

    w0, l0 = map(host, inputs)
    (w1, l1), w2, w3 = map(host, stages[0]), host(stages[1]), host(stages[2])
    d = {k: host(v) for k, v in draws.items()}
    noise = host(aug.noise_rows).astype(np.float64)
    lo, hi = host(aug.snr_lo), host(aug.snr_hi)
    worst = {"speed": 0.0, "reverb": 0.0, "noise": 0.0}
    for i in rows:
        n = int(l1[i])
        want = audio.speed_perturb(w0[i, :int(l0[i])], float(speed_of[i]))
        worst["speed"] = max(worst["speed"], rel_l2(w1[i, :n], want))
        want = np.convolve(w1[i, :n].astype(np.float64),
                           rirs[int(d["rir_pick"][i])])[:n]
        worst["reverb"] = max(worst["reverb"], rel_l2(w2[i, :n], want))
        x = w2[i, :n].astype(np.float64)
        k = int(d["noise_pick"][i])
        nz = noise[k, :n]
        snr = lo[k] + float(d["snr_u"][i]) * (hi[k] - lo[k])
        a_db = 10 * np.log10(np.mean((x * aug.power_scale) ** 2) + 1e-4)
        n_db = 10 * np.log10(np.mean((nz * aug.power_scale) ** 2) + 1e-4)
        want = x + np.sqrt(10 ** ((a_db - n_db - snr) / 10)) * nz
        worst["noise"] = max(worst["noise"], rel_l2(w3[i, :n], want))
    return worst


def phase18f_augmented(dev, card, model_conf, corpus):
    """The flagship resident step at B=512 x 2 s with ``flagship_aug``
    attached (speed, reverb, noise, then fused_fbank and the fused
    passes at T=220): equal, bit for bit, to the host-fed step with the
    same augmentation; the augmentation on the card stage by stage
    against the same module on the CPU (same inputs, same draws) and
    against float64 numpy on AUG_F64_ROWS rows; its CUDA-event time and
    memory; the augmented resident step beside the plain one, in turns.
    Returns the figures."""
    import torch

    from wekws_tpu_torch.data.device_aug import (
        mix_noise_batch,
        reverb_batch,
        speed_perturb_group,
    )
    from wekws_tpu_torch.data.resident import gather_rows
    from wekws_tpu_torch.train.steps import step_generator

    width = corpus.arrays["waves"].shape[1]
    aug, rirs = flagship_aug(dev, width, SEED + 22)
    trainer = path_g_trainer(dev, model_conf)
    plain_trainer = path_g_trainer(dev, model_conf)
    trainer.pipeline.wave_aug = aug
    rows_dev = torch.from_numpy(corpus.epoch_index(3, TRAIN_B)[0]).to(dev)
    batch = gather_rows(corpus.arrays, rows_dev)

    # the resident step against the host-fed step, the same aug
    state = trainer.init_state()
    twin = copy.deepcopy(state)
    state, got = trainer.train_step(state, batch, SEED, 1e-3)
    twin, want = trainer.train_step(
        twin, {k: v.cpu().numpy() for k, v in batch.items()}, SEED, 1e-3)
    worst = max(float((got[k] - want[k]).abs()) for k in got)
    ref = twin.model.state_dict()
    for name, val in state.model.state_dict().items():
        worst = max(worst, float((val.double() - ref[name].double())
                                 .abs().max()))
    if not worst <= RESIDENT_STEP_TOL:
        raise AssertionError(f"augmented resident step vs host-fed step: "
                             f"{worst} > {RESIDENT_STEP_TOL}")
    waves = batch["waves"].to(torch.float32)
    lengths = batch["wave_lengths"].to(torch.int64)
    gen = step_generator(SEED, 0, dev)
    feats, feat_lengths = trainer.pipeline(waves, lengths, gen)
    out_len = aug.noise_rows.shape[1]
    if feats.shape[1] != (out_len - 400) // 160 + 1:
        raise AssertionError(f"augmented features {tuple(feats.shape)} for "
                             f"{out_len} samples")
    print(f"  augmented resident step vs host-fed step (B={TRAIN_B} x "
          f"{TRAIN_SECONDS} s -> {out_len} samples, features "
          f"{tuple(feats.shape)}; {aug.n_noise_rows} noise rows, "
          f"{aug.n_rirs} RIRs of {AUG_RIR_LEN}, DFT {aug.fft.a} x "
          f"{aug.fft.b}): loss {float(got['loss']):.6f}, largest difference "
          f"of loss, accuracy, grad norm, every parameter and BN statistic "
          f"{worst:.1e} (limit {RESIDENT_STEP_TOL})", flush=True)

    # stage by stage: the card against the CPU on the same inputs, draws
    draws = aug.draws(TRAIN_B, step_generator(SEED, 1, dev))
    cpu = copy.deepcopy(aug).to("cpu")
    cdraws = {k: v.cpu() for k, v in draws.items()}
    s1 = speed_perturb_group(waves, lengths, aug.speeds, mats=aug.mats())
    s2 = reverb_batch(*s1, aug.fft, aug.rir_re, aug.rir_im,
                      draws["rir_pick"], draws["rir_apply_u"], aug.reverb_prob)
    s3 = mix_noise_batch(s2, s1[1], aug.noise_rows, aug.snr_lo, aug.snr_hi,
                         draws["noise_pick"], draws["snr_u"],
                         draws["noise_apply_u"], aug.noise_prob,
                         aug.power_scale)
    whole, whole_len = aug.apply(waves, lengths, draws)
    if not (torch.equal(whole, s3) and torch.equal(whole_len, s1[1])):
        raise AssertionError("DeviceWaveAug.apply differs from its stages")
    c1 = speed_perturb_group(waves.cpu(), lengths.cpu(), cpu.speeds,
                             mats=cpu.mats())
    c2 = reverb_batch(s1[0].cpu(), s1[1].cpu(), cpu.fft, cpu.rir_re,
                      cpu.rir_im, cdraws["rir_pick"], cdraws["rir_apply_u"],
                      cpu.reverb_prob)
    c3 = mix_noise_batch(s2.cpu(), s1[1].cpu(), cpu.noise_rows, cpu.snr_lo,
                         cpu.snr_hi, cdraws["noise_pick"], cdraws["snr_u"],
                         cdraws["noise_apply_u"], cpu.noise_prob,
                         cpu.power_scale)
    if not torch.equal(c1[1], s1[1].cpu()):
        raise AssertionError("speed-perturbed lengths differ card vs CPU")
    errs = {
        "speed": check_close("18f speed perturbation, card vs CPU",
                             s1[0].cpu(), c1[0], atol=AUG_SPEED_ATOL,
                             rtol=0.0),
        "reverb": check_close("18f reverb (full-utterance DFT), card vs "
                              "CPU", s2.cpu(), c2, atol=AUG_REVERB_ATOL,
                              rtol=0.0),
        "noise": check_close("18f noise, card vs CPU", s3.cpu(), c3,
                             atol=AUG_NOISE_ATOL, rtol=AUG_NOISE_RTOL)}
    ok = ((draws["rir_apply_u"] < aug.reverb_prob)
          & (draws["noise_apply_u"] < aug.noise_prob)).cpu().numpy()
    # speed_perturb_group's groups: the remainder rows go to the first
    k = len(aug.speeds)
    speed_of = np.repeat(aug.speeds, [TRAIN_B // k + (i < TRAIN_B % k)
                                      for i in range(k)])
    # rows at speeds 0.9 and 1.1 (half each where there are enough),
    # reverbed and noised
    picked = [i for sp in (0.9, 1.1)
              for i in np.flatnonzero(ok & (speed_of == sp))
              [:AUG_F64_ROWS // 2]]
    picked += [i for i in np.flatnonzero(ok & (speed_of != 1.0))
               if i not in picked][:AUG_F64_ROWS - len(picked)]
    picked = [int(i) for i in sorted(picked)]
    f64 = float64_chain((waves, lengths), (s1, s2, s3), picked, speed_of,
                        draws, aug, rirs)
    if len(picked) != AUG_F64_ROWS or max(f64.values()) > AUG_F64_RTOL:
        raise AssertionError(f"18f against float64 on rows {picked}: {f64} "
                             f"(bound {AUG_F64_RTOL})")
    print(f"  18f augmentation on the card vs the same module on the CPU, "
          f"the same inputs and draws: speed {errs['speed']:.3e} abs (bound "
          f"{AUG_SPEED_ATOL}), reverb {errs['reverb']:.3e} abs (bound "
          f"{AUG_REVERB_ATOL}), noise {errs['noise']:.3e} (bound "
          f"{AUG_NOISE_ATOL} abs + {AUG_NOISE_RTOL} rel); against float64 "
          f"numpy on rows {picked} (speeds 0.9 and 1.1, reverbed and "
          f"noised), relative L2: speed {f64['speed']:.2e}, reverb "
          f"{f64['reverb']:.2e}, noise {f64['noise']:.2e} (bound "
          f"{AUG_F64_RTOL}); apply() equals its stages", flush=True)

    # times: the augmentation alone, its memory, the steps in turns
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    aug(waves, lengths, gen)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - before
    aug_ms = cuda_time_ms(lambda: aug(waves, lengths, gen))
    plain_state = plain_trainer.init_state()
    order = (("plain resident", lambda: plain_trainer.train_step(
        plain_state, batch, SEED, 1e-3)), ("augmented resident",
        lambda: trainer.train_step(state, batch, SEED, 1e-3)))
    rounds = {label: [] for label, _ in order}
    for r in range(STEP_ROUNDS):
        for label, fn in (order if r % 2 == 0 else order[::-1]):
            rounds[label].append(timed_steps(fn)[0])
    times = {label: float(np.median(ms)) for label, ms in rounds.items()}
    audio_s = TRAIN_B * TRAIN_SECONDS
    print(f"  18f augmentation alone (B={TRAIN_B}): {aug_ms:.3f} ms by CUDA "
          f"events (median of 30), {peak / 1e6:.1f} MB of device memory "
          f"above what was allocated; train step by wall clock, the median "
          f"of {STEP_ROUNDS} rounds' medians of 10 in turns: "
          + "; ".join(f"{label} {times[label]:.3f} ms ("
                      + ", ".join(f"{x:.1f}" for x in ms) + f", "
                      f"{audio_s / times[label] * 1e3:.1f} audio-s/s)"
                      for label, ms in rounds.items()) + f" [{card}]",
          flush=True)
    return {"aug_ms": aug_ms, "aug_peak_bytes": peak, "card_vs_cpu": errs,
            "float64_rel_l2": f64, "aug_step_ms": rounds["augmented resident"],
            "plain_step_ms": rounds["plain resident"]}


def noisy_model(dev, tmp, data, cmvn, name):
    """One of 18g's two models: ``bin.train --device_resident`` with
    ``conf/<name>.yaml`` (its store paths made absolute) for NOISY_EPOCHS
    epochs, the augmentation counted where the config has one, average,
    ``bin.score`` of test and test_noisy through the DS-TCN kernel, DET
    of both, into ``tmp``/exp/``name``.  Returns (the epochs' records,
    the augmented waves' shapes, {split: fused_ds_tcn launches}, {split:
    DET rows}, train wall s)."""
    import torch
    import yaml

    from wekws_tpu_torch.bin import average_model, compute_det, score, train
    from wekws_tpu_torch.data import device_aug
    from wekws_tpu_torch.ops.fused_tcn import fused_ds_tcn

    configs = recipe_yaml(os.path.join(NOISY_RECIPE, "conf", f"{name}.yaml"))
    dconf = configs["dataset_conf"]
    for key in ("noise_source", "reverb_source"):
        if key in dconf:
            dconf[key] = os.path.join(tmp, dconf[key])
    config = os.path.join(tmp, f"{name}.yaml")
    with open(config, "w") as f:
        yaml.safe_dump(configs, f)
    exp = os.path.join(tmp, "exp", name)
    applied = []
    apply = device_aug.DeviceWaveAug.apply

    def counted(self, waves, lengths, draws):
        applied.append(tuple(waves.shape))
        return apply(self, waves, lengths, draws)

    device_aug.DeviceWaveAug.apply = counted
    t0 = time.perf_counter()
    try:
        with PlainOnCuda() as plain, TimeLimit(
                RECIPE_TIMEOUT_S, f"bin.train noisy recipe {name}"):
            train.main([
                "--config", config, "--train_data",
                os.path.join(data, "train.list"), "--cv_data",
                os.path.join(data, "dev.list"), "--model_dir", exp,
                "--num_keywords", "1", "--min_duration", "20",
                "--seed", "666", "--cmvn_file", cmvn, "--norm_var",
                "--device_resident", "--num_epochs", str(NOISY_EPOCHS),
                "--device", dev.type])
            torch.cuda.synchronize()
    finally:
        device_aug.DeviceWaveAug.apply = apply
    plain.check(f"bin.train noisy recipe {name}")
    train_s = time.perf_counter() - t0
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    steps = 480 // dconf["batch_conf"]["batch_size"]
    losses = [r["train_loss"] for r in records]
    want = steps * NOISY_EPOCHS if "noise_source" in dconf else 0
    if len(records) != NOISY_EPOCHS or not np.isfinite(losses).all() \
            or len(applied) != want:
        raise AssertionError(f"noisy recipe {name}: records {records}, "
                             f"augmentation applied {len(applied)} "
                             f"times (want {want})")
    avg = os.path.join(exp, f"avg_{NOISY_EPOCHS}.pt")
    average_model.main(["--dst_model", avg, "--src_path", exp, "--num",
                        str(NOISY_EPOCHS), "--val_best", "--device",
                        dev.type])
    launches, dets = {}, {}
    for split in ("test", "test_noisy"):
        lst = os.path.join(data, f"{split}.list")
        scores = os.path.join(exp, f"score_{split}.txt")
        before = fused_ds_tcn.launches
        with PlainOnCuda() as plain:
            n = score.main(["--config", os.path.join(exp, "config.yaml"),
                            "--test_data", lst, "--checkpoint", avg,
                            "--score_file", scores, "--device",
                            dev.type])
            torch.cuda.synchronize()
        plain.check(f"bin.score {name} {split}")
        launches[split] = fused_ds_tcn.launches - before
        stats = os.path.join(exp, f"stats_{split}.txt")
        compute_det.main(["--keyword", "0", "--test_data", lst,
                          "--score_file", scores, "--stats_file", stats,
                          "--device", dev.type])
        with open(stats) as f:
            rows = [tuple(map(float, line.split())) for line in f]
        if n != 192 or launches[split] < 1 or len(rows) < 100:
            raise AssertionError(f"noisy recipe {name} {split}: {n} scored, "
                                 f"{launches[split]} fused_ds_tcn "
                                 f"launches, {len(rows)} DET rows")
        dets[split] = rows
    return records, applied, launches, dets, train_s


def run_report(path, dirs):
    """The script at ``path`` (``local/report_torch.py``) run as
    ``__main__`` in this process on ``dirs``: what it printed."""
    import contextlib
    import io
    import runpy

    out, argv = io.StringIO(), sys.argv
    sys.argv = [path, *dirs]
    try:
        with contextlib.redirect_stdout(out):
            runpy.run_path(path, run_name="__main__")
    finally:
        sys.argv = argv
    return out.getvalue()


def phase18g_noisy_recipe(dev, card):
    """examples/synthetic_noisy through the port, as run_torch.sh's
    stages with no config (both of run.sh's), in a temporary directory:
    local/gen_data_torch.py (the corpus and the noise and RIR stores),
    CMVN, then for conf/ds_tcn_aug.yaml (speed perturbation, noise and
    reverb on the card, once a step) and conf/ds_tcn_clean.yaml in turn
    ``noisy_model``: NOISY_EPOCHS epochs, average, ``bin.score`` of test
    and test_noisy through the DS-TCN kernel (C=48), DET of both; then
    local/report_torch.py's aug-vs-clean table, and each model's FRR at
    2 FA/h on both splits (a finding: NOISY_EPOCHS epochs are not the
    recipe's, so no bound).  Returns the augmented model's epochs'
    audio-s/s, the DS-TCN launches by model and split, and the FRRs."""
    import itertools
    import tempfile

    from wekws_tpu_torch.eval import frr_at_fa_per_hour
    from wekws_tpu_torch.tools.cmvn_stats import (
        compute_cmvn_stats,
        wav_paths_from_data_list,
    )

    here = os.path.dirname(os.path.abspath(__file__))
    models = ("ds_tcn_aug", "ds_tcn_clean")
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        t0 = time.perf_counter()
        subprocess.run(
            [sys.executable, os.path.join(here, NOISY_RECIPE, "local",
                                          "gen_data_torch.py"), data],
            check=True, capture_output=True, timeout=300,
            env=dict(os.environ, PYTHONPATH=here))
        cmvn = os.path.join(data, "global_cmvn")
        compute_cmvn_stats(itertools.islice(wav_paths_from_data_list(
            os.path.join(data, "train.list")), 200), recipe_yaml(
                os.path.join(NOISY_RECIPE, "conf", "ds_tcn_aug.yaml"))[
                    "dataset_conf"], cmvn)
        made_s = time.perf_counter() - t0
        runs = {name: noisy_model(dev, tmp, data, cmvn, name)
                for name in models}
        report = run_report(os.path.join(here, NOISY_RECIPE, "local",
                                         "report_torch.py"),
                            [os.path.join(tmp, "exp", name)
                             for name in models])
    frr = {name: {split: frr_at_fa_per_hour(runs[name][3][split], 2.0)
                  for split in ("test", "test_noisy")} for name in models}
    table = report.splitlines()
    if len(table) != 3 or [line.split()[0] for line in table[1:]] != \
            list(models) or [float(x) for x in table[1].split()[1:]] != [
                round(frr[models[0]][s], 4) for s in ("test", "test_noisy")]:
        raise AssertionError(f"noisy recipe: report_torch.py printed "
                             f"{report!r}; FRR at 2 FA/h {frr}")
    for line in table:
        print(f"  18g {line}", flush=True)
    launches = {}
    for name in models:
        records, applied, split_launches, dets, train_s = runs[name]
        launches[name] = split_launches
        losses = [r["train_loss"] for r in records]
        rates = [r["audio_seconds_per_s"] for r in records]
        aug = (f"augmentation on the card in every step ({applied[0]} "
               f"waves)" if applied else "no augmentation")
        print(f"  18g {name}: bin.train --device_resident {NOISY_EPOCHS} "
              f"epochs, {train_s:.1f} s wall, {aug}, train losses "
              f"{[round(x, 4) for x in losses]}, audio-s/s per epoch "
              f"{', '.join(f'{x:.1f}' for x in rates)}; bin.score "
              f"fused_ds_tcn launches {split_launches}, no plain version on "
              f"a CUDA tensor; DET at 0.5 (FA/h, FRR): " + ", ".join(
                  f"{k} ({v[50][1]:.2f}, {v[50][2]:.4f})"
                  for k, v in dets.items()) + f" [{card}]", flush=True)
    print(f"  18g FRR at 2 FA/h on test_noisy after {NOISY_EPOCHS} epochs "
          f"(a finding, no bound; the README's TPU run, 18 epochs: 0.3333 "
          f"with augmentation, 0.7812 without): "
          f"{frr['ds_tcn_aug']['test_noisy']:.4f} with augmentation, "
          f"{frr['ds_tcn_clean']['test_noisy']:.4f} without; corpus and "
          f"stores made in {made_s:.1f} s [{card}]", flush=True)
    rates = [r["audio_seconds_per_s"] for r in runs["ds_tcn_aug"][0]]
    return rates, launches, frr


def phase18_resident(dev, card, model_conf, batch, host_ms, recipe_rates):
    """Path G, device-resident epochs: 18a staging, 18b the resident
    step against the host-fed step, 18c a timed resident epoch, 18f the
    augmented flagship step, 18d ``bin.train --device_resident``, 18g
    the noisy recipe; path G's launches counted from 0 before 18a and
    read after 18g, every call of ``fused_fbank``, of the eight passes
    and of the DS-TCN serving kernel tapped by shape (``ShapeTap``,
    ``PassTap``); 18e each kernel against its plain version at every
    shape path G gave it.  The resident steps' copies from the host,
    device times and idle shares, and each pass's and fbank shape's
    device time, come from a fresh process (``path_g_traces``).  Returns ({kernel record: launches}, {kernel
    record: [readings]}, the step figures, the CLI's epoch rates)."""
    import tempfile

    from wekws_tpu_torch.ops.fused_frontend import fused_fbank
    from wekws_tpu_torch.ops.fused_mdtc_train import reset_launches
    from wekws_tpu_torch.ops.fused_tcn import fused_ds_tcn

    reset_launches()
    fused_fbank.launches = 0
    fused_ds_tcn.launches = 0
    with ShapeTap(PATH_G_WRAPPERS) as ftap, PassTap() as ptap:
        corpus, cv_corpus, host = phase18a_staging(dev, card)
        trainer = path_g_trainer(dev, model_conf)
        state = phase18b_same_step(dev, trainer, corpus, cv_corpus)
        figures = phase18c_epoch(dev, card, trainer, state, corpus,
                                 cv_corpus, host, batch, host_ms)
        del trainer, state, cv_corpus, host
        print("18f: the augmented flagship step", flush=True)
        figures["aug"] = phase18f_augmented(dev, card, model_conf, corpus)
        del corpus
        print("18d: bin.train --device_resident", flush=True)
        rates = phase18d_cli(dev, card, recipe_rates)
        print("18g: the noisy recipe", flush=True)
        (figures["noisy_rates"], figures["noisy_ds_tcn_launches"],
         figures["noisy_frr_at_2_fa_h"]) = phase18g_noisy_recipe(dev, card)
    launches = path_g_counts()
    missing = [k for k, v in launches.items() if not v]
    tapped = {}
    for (name, _), (calls, *_) in list(ftap.shapes.items()) + list(
            ptap.shapes.items()):
        tapped[name] = tapped.get(name, 0) + calls
    if missing or tapped != launches:
        raise AssertionError(f"path G: the calls seen by shape {tapped} are "
                             f"not the launches counted {launches} (none of "
                             f"{missing})")
    with tempfile.TemporaryDirectory() as saved:
        traces = path_g_traces(model_conf, path_g_specs(
            ftap.shapes, ptap.shapes, saved))
    witness = traces["host_copies"]
    for tag, key in (("18c resident step", "resident_copies"),
                     ("18f augmented resident step", "aug_copies")):
        copies = traces[key]
        if copies and max(copies) > H2D_LIMIT:
            raise AssertionError(f"{tag} copied {max(copies)} bytes from "
                                 f"the host (limit {H2D_LIMIT})")
        figures[f"{key}_h2d"] = [len(copies), sum(copies)]
        print(f"  {tag}, traced in a fresh process: copies from the host "
              f"(of three traces, the one with the largest) {len(copies)}, "
              f"{sum(copies)} bytes, the largest {max(copies, default=0)} "
              f"(limit {H2D_LIMIT}); a host-fed int16 step's {len(witness)}, "
              f"{sum(witness)} bytes, the largest {max(witness)} [{card}]",
              flush=True)
    for tag, key in (("18c resident step", "resident"),
                     ("18f augmented resident step", "aug_resident"),
                     ("18f augmentation alone", "aug_alone")):
        figures[key] = dict(traces[key],
                            **idle_share(tag, traces[key], card))
    idle_shares(card, traces["idle"])
    device_ms = {tuple(k.split("|")): v
                 for k, v in traces["device_ms"].items()}
    readings = phase17e_kernel_checks(card, ftap.shapes, "18e", "G",
                                      device_ms)
    readings.update(phase18e_pass_checks(card, ptap.shapes, device_ms))
    return launches, readings, figures, rates


def merge_path_g(record, launches, readings):
    """Path G's launches and readings into the kernel records."""
    rows = {r["name"]: r for r in record}
    for name, n in launches.items():
        rows[name]["launches"] += n
        rows[name]["path_g_launches"] = n
    for name, rs in readings.items():
        rows[name]["path_g"] = rs
        rows[name]["max_abs_err"] = max(
            [rows[name]["max_abs_err"]] + [r["max_abs_err"] for r in rs])


# ---------------------------------------------------------------------------
# phase 19, path H: export and static int8 (A.12)
# ---------------------------------------------------------------------------

# the artifact's float output on the card against the same runtime on the
# CPU and against the fused serving kernels on the same weights (both fold
# BN in float64): TOL, the serving kernels' own limit.  The static-int8
# runtime on the card against the numpy runtime: every int8 accumulator
# equal and the outputs within 2e-5 (tests/test_jax_runtime.py:40-49's
# pins); chunks against one call within 1e-5 abs + 1e-5 rel (JAX pins 1e-6
# on one CPU backend; another row count may pick another cuBLAS kernel for
# the float products)
INT8_OUT_TOL, INT8_CHUNK_TOL = 2e-5, 1e-5
H_CALIB_UTTS = 8
CTC_EXPORT = os.path.join(CTC_FIXTURE, "export")
CTC_EXPORT_INT8 = os.path.join(CTC_FIXTURE, "export_int8")
ARTIFACT_FILES = ("model.txt", "weights.bin")


def path_h_wrappers():
    """The kernels path H launches: path F's and the offline MDTC
    forward (19a's witness)."""
    from wekws_tpu_torch.ops.fused_mdtc import fused_mdtc_forward

    return dict(kernel_counts(), fused_mdtc_forward=fused_mdtc_forward)


def same_artifact_files(got_dir, want_dir, what):
    """The model.txt and weights.bin of two artifact directories, byte
    for byte (model.json's meta names the config's own CMVN path)."""
    import filecmp

    differ = [f for f in ARTIFACT_FILES if not filecmp.cmp(
        os.path.join(got_dir, f), os.path.join(want_dir, f), shallow=False)]
    if differ:
        raise AssertionError(f"{what}: {differ} differ from {want_dir}")


def wide_int8_artifact(path, k):
    """A one-op static-int8 artifact: a dense of K=``k`` inputs to 3, the
    weights at the int8 range's end, zero point 0, scale 1."""
    os.makedirs(path, exist_ok=True)
    q = np.full((k, 3), -127, np.int8)
    q[:, 1] = 127
    q[::2, 2] = 113
    artifact = {
        "meta": {"format_version": 1, "output": 1, "output_dim": 3,
                 "cache_len": 0, "cache_dim": 0, "activation": "identity",
                 "dataset_conf": {}, "model_conf": {"input_dim": k},
                 "quantized": True, "static_quant": True},
        "ops": [{"op": "dense", "inputs": [0], "out": 1,
                 "attrs": {"act": "none", "in_scale": 1.0, "in_zp": 0},
                 "W": {"int8": {"offset": 0, "shape": [k, 3]},
                       "scale": {"offset": 0, "shape": [3]}}}],
        "caches": []}
    with open(os.path.join(path, "model.json"), "w") as f:
        json.dump(artifact, f)
    np.full(3, 0.5, "<f4").tofile(os.path.join(path, "weights.bin"))
    q.tofile(os.path.join(path, "weights_int8.bin"))
    return path


def phase19a_export(dev, card, work, tmp):
    """19a: the hi_xiaowen FSMN-CTC (phase 11's seeded checkpoint), the
    flagship MDTC (phase 4's, BN statistics perturbed) and the JAX DS-TCN
    fixture (C=48) through ``bin.export_model`` (its two gates; the
    fixture's files equal to its committed export/), then each artifact
    through ``TorchGraphRuntime`` on the card against the same runtime
    on the CPU, and against the fused serving route on the same weights
    (``build_fused_forward`` on 16 x 2 s, ``build_fused_stream`` in
    8-frame chunks), on the features of phase 4's 16 synthetic waves
    through the artifact's own frontend (``feats_from_waves``),
    standardized per dimension where the model has no CMVN of its own
    (phase 11's FSMN-CTC: the recipe's global CMVN; raw log-mels drive
    its random weights to logits of 1e2, whose fp32 noise alone is 1e-4);
    a flat output (a saturated sigmoid) would make the comparison
    vacuous and fails.  Returns {name: artifact dir}."""
    import torch
    import yaml

    from wekws_tpu_torch.bin import export_model as export_cli
    from wekws_tpu_torch.export import TorchGraphRuntime
    from wekws_tpu_torch.export.calibrate import feats_from_waves
    from wekws_tpu_torch.ops.serving import (
        build_fused_forward,
        build_fused_stream,
    )
    from wekws_tpu_torch.runtime.keyword_spotter import load_serving_model

    waves = [w.astype(np.float32)
             for w in synth_waves(np.random.default_rng(SEED))]
    tcn_config, _ = fixture_config(DS_TCN_FIXTURE, RECIPE, tmp,
                                   "ds_tcn_fixture_19.yaml")
    cases = (
        ("fsmn_ctc", "hi_xiaowen FSMN-CTC (400 -> 140, 4 x 250/128)",
         os.path.join(work, "fsmn_ctc.yaml"),
         os.path.join(work, "fsmn_ctc.pt"), ("fused_fsmn_layers",) * 2),
        ("flagship", "flagship MDTC (4 x 4 blocks, C=64)",
         os.path.join(work, "flagship.yaml"),
         os.path.join(work, "flagship.pt"),
         ("fused_mdtc_forward", "fused_mdtc_stream")),
        ("ds_tcn_fixture", "JAX DS-TCN fixture (C=48)", tcn_config,
         os.path.join(DS_TCN_FIXTURE, "avg_5.ckpt"),
         ("fused_ds_tcn",) * 2),
    )
    wrappers = path_h_wrappers()
    arts = {}
    for name, tag, config, ckpt, (off_kern, str_kern) in cases:
        art = os.path.join(tmp, f"{name}_export")
        t0 = time.perf_counter()
        err, dev_err = export_cli.main(["--config", config, "--checkpoint",
                                        ckpt, "--output_dir", art,
                                        "--device", dev.type])
        export_s = time.perf_counter() - t0
        if name == "ds_tcn_fixture":
            same_artifact_files(art, os.path.join(DS_TCN_FIXTURE, "export"),
                                "19a the DS-TCN fixture's export")
        with open(config) as f:
            configs = yaml.safe_load(f)
        in_dim = configs["model"]["input_dim"]
        model = load_serving_model(configs, ckpt, in_dim, dev)
        n_params = sum(p.numel() for p in model.parameters())
        rt, rt_cpu = TorchGraphRuntime(art, dev), TorchGraphRuntime(art, "cpu")
        feats = feats_from_waves(art, waves)
        t = min(len(f) for f in feats)
        x = np.stack([f[:t] for f in feats])
        if not any(e["op"] == "cmvn" for e in rt.ops):
            x = (x - x.mean(axis=(0, 1))) / (x.std(axis=(0, 1)) + 1e-6)
        x = torch.as_tensor(x, dtype=torch.float32)
        b, xd = len(feats), x.to(dev)
        got, _ = rt.forward(xd)
        want, _ = rt_cpu.forward(x)
        lo, hi = float(got.min()), float(got.max())
        if not hi - lo > 1e-3:
            raise AssertionError(f"19a {name}: the artifact's outputs span "
                                 f"only [{lo}, {hi}]: the checks would be "
                                 f"vacuous")
        e_cpu = check_close(f"19a {name}: artifact on the card vs on the CPU",
                            got.cpu(), want, quiet=True)
        before = {k: fn.launches for k, fn in wrappers.items()}
        with torch.inference_mode():
            ref = build_fused_forward(model, device=dev)(
                xd, torch.full((b,), t, device=dev))
        step, init = build_fused_stream(model, device=dev)
        cache, state, outs, refs = init(b), rt.init_state(b), [], []
        for s in range(0, t, SERVE_STEP):
            chunk = xd[:, s:s + SERVE_STEP].contiguous()
            y, state = rt.forward(chunk, state)
            outs.append(y)
            with torch.inference_mode():
                y, cache = step(chunk, cache)
            refs.append(y)
        torch.cuda.synchronize()
        n = {k: fn.launches - before[k] for k, fn in wrappers.items()}
        chunks = math.ceil(t / SERVE_STEP)
        want_n = {off_kern: 1 + (chunks if off_kern == str_kern else 0)}
        want_n[str_kern] = want_n.get(str_kern, 0) + (
            0 if off_kern == str_kern else chunks)
        if {k: v for k, v in n.items() if v} != want_n:
            raise AssertionError(f"19a {name}: witness launches {n}, want "
                                 f"{want_n}")
        e_off = check_close(f"19a {name}: artifact vs {off_kern} offline, "
                            f"B={b} T={t}", got, ref, quiet=True)
        e_str = check_close(f"19a {name}: artifact vs {str_kern}, {chunks} "
                            f"chunks of {SERVE_STEP}", torch.cat(outs, 1),
                            torch.cat(refs, 1), quiet=True)
        e_chunk = check_close(f"19a {name}: artifact chunks vs one call",
                              torch.cat(outs, 1), got, quiet=True)
        print(f"  19a {tag}: {n_params} parameters, bin.export_model "
              f"{export_s:.1f} s (numpy gate {err:.2e}, {dev.type} runtime "
              f"gate {dev_err:.2e}, bound 1e-3); TorchGraphRuntime B={b} "
              f"T={t} (outputs in [{lo:.3g}, {hi:.3g}]) on the card vs the "
              f"CPU {e_cpu:.2e}, vs {off_kern} "
              f"offline {e_off:.2e}, vs {str_kern} in 8-frame chunks "
              f"{e_str:.2e}, its chunks vs one call {e_chunk:.2e} (bound "
              f"{TOL} abs + {TOL} rel); witness launches {want_n} "
              f"[{card}]", flush=True)
        arts[name] = art
    return arts


def int8_vs_numpy(tag, rt, np_rt, x):
    """The device int8 runtime against the numpy runtime on ``x`` (B, T,
    D): every int8 accumulator of every row equal, outputs within
    INT8_OUT_TOL.  Returns (output error, int8 ops, accumulator
    elements)."""
    import torch

    got_acc, want_acc = {}, {}
    got, _ = rt.forward(torch.as_tensor(x, device=rt.device),
                        acc_observer=lambda i, k, a: got_acc.__setitem__(
                            (i, k), a))
    wants = []
    for b in range(len(x)):
        y, _ = np_rt.forward(x[b], acc_observer=lambda i, k, a, b=b:
                             want_acc.__setitem__((b, i, k), a))
        wants.append(y)
    n_el = 0
    for (b, i, k), acc in want_acc.items():
        mine = got_acc[i, k][b].cpu().numpy()
        if mine.dtype != np.int32 or not np.array_equal(mine, acc):
            raise AssertionError(f"{tag}: op {i} {k} row {b}: int8 "
                                 f"accumulators differ in "
                                 f"{int((mine != acc).sum())} of {acc.size}")
        n_el += acc.size
    err = check_close(f"{tag}: outputs", got.cpu(),
                      torch.as_tensor(np.stack(wants)), quiet=True,
                      atol=INT8_OUT_TOL, rtol=0.0)
    return err, len(got_acc), n_el


def phase19b_int8(dev, card, tmp, fsmn_art):
    """19b: 19a's hi_xiaowen FSMN-CTC artifact calibrated on features of
    seeded synthetic waves through the port's ``StreamingFrontend``
    (``feats_from_waves``) and statically quantized; on the card
    ``TorchGraphRuntime`` against the port's numpy runtime (every int8
    accumulator equal, outputs within INT8_OUT_TOL), chunks of 8 against
    one call, an int8 contraction at K = 1,032 (exact) and K = 1,033
    (raises).  Returns the int8 artifact's directory."""
    import torch

    from wekws_tpu_torch.export import (
        GraphRuntime,
        TorchGraphRuntime,
        quantize_artifact,
    )
    from wekws_tpu_torch.export.calibrate import feats_from_waves
    from wekws_tpu_torch.export.torch_runtime import EXACT_K

    waves = synth_waves(np.random.default_rng(SEED + 190))[:H_CALIB_UTTS]
    t0 = time.perf_counter()
    feats = feats_from_waves(fsmn_art, [w.astype(np.float32) for w in waves])
    qdir = os.path.join(tmp, "fsmn_ctc_int8")
    artifact = quantize_artifact(fsmn_art, qdir, calib_feats=feats)
    quant_s = time.perf_counter() - t0
    n_int8 = sum("in_scale" in e.get("attrs", {}) for e in artifact["ops"])
    t = min(len(f) for f in feats)
    x = np.stack([f[:t] for f in feats])
    rt, np_rt = TorchGraphRuntime(qdir, dev), GraphRuntime(qdir)
    err, n_ops, n_el = int8_vs_numpy("19b FSMN-CTC int8", rt, np_rt, x)
    full, _ = rt.forward(torch.as_tensor(x, device=dev))
    state, outs = rt.init_state(len(x)), []
    for s in range(0, t, SERVE_STEP):
        y, state = rt.forward(torch.as_tensor(x[:, s:s + SERVE_STEP],
                                              device=dev), state)
        outs.append(y)
    e_chunk = check_close("19b FSMN-CTC int8 chunks of 8 vs one call",
                          torch.cat(outs, 1), full, quiet=True,
                          atol=INT8_CHUNK_TOL, rtol=INT8_CHUNK_TOL)
    wide = wide_int8_artifact(os.path.join(tmp, "wide_k"), EXACT_K)
    xw = np.full((2, 4, EXACT_K), -300.0, np.float32)
    xw[1, :, ::3] = 127.0
    e_wide, _, _ = int8_vs_numpy(f"19b dense K={EXACT_K}",
                                 TorchGraphRuntime(wide, dev),
                                 GraphRuntime(wide), xw)
    try:
        TorchGraphRuntime(wide_int8_artifact(
            os.path.join(tmp, "wide_k1"), EXACT_K + 1), dev)
    except ValueError as e:
        raised = str(e)
    else:
        raise AssertionError(f"19b: an int8 dense of K={EXACT_K + 1} did "
                             f"not raise")
    print(f"  19b hi_xiaowen FSMN-CTC static int8: calibrated on "
          f"{len(feats)} seeded 2 s waves through the port's "
          f"StreamingFrontend, {n_int8} int8 ops, {quant_s:.1f} s; on the "
          f"card vs the numpy runtime (B={len(x)}, T={t}): {n_ops} int8 "
          f"accumulators ({n_el} elements) equal, outputs within "
          f"{err:.2e} (bound {INT8_OUT_TOL}); chunks of 8 vs one call "
          f"{e_chunk:.2e} (bound {INT8_CHUNK_TOL} abs + rel); K={EXACT_K} "
          f"at the int8 range's ends equal (outputs {e_wide:.1e}); "
          f"K={EXACT_K + 1} raises: {raised!r} [{card}]", flush=True)
    return qdir


def h_engine(ckpt, config, tokens, lexicon, keyword, dev, fe, decode,
             streams=SERVE_STREAMS, fused=None):
    from wekws_tpu_torch.runtime import BatchKeywordSpotter

    eng = BatchKeywordSpotter(
        ckpt, config, tokens, lexicon, SERVE_THRESHOLD_CTC,
        num_streams=streams, step_frames=SERVE_STEP, min_frames=1,
        use_fused=fused, device_decode=decode, device_frontend=fe,
        device=dev)
    eng.set_keywords(keyword)
    return eng


class ModelTap:
    """Wraps an engine's artifact model (``ArtifactModelAdapter``), each
    device's copy: keeps each call's features, input cache, ``softmax``
    flag, posteriors and new cache, cloned on the device (no copy to the
    host in the run)."""

    def __init__(self, engine):
        self.calls = []
        engine.models[:] = [_TappedModel(m, self.calls)
                            for m in engine.models]


class _TappedModel:
    """One model of a ``ModelTap``: its calls into the shared list."""

    def __init__(self, model, calls):
        self._model, self.calls = model, calls

    def __getattr__(self, name):
        return getattr(self._model, name)

    def __call__(self, feats, cache=None, softmax=False):
        out, new = self._model(feats, cache, softmax=softmax)
        self.calls.append((feats.clone(), tuple(c.clone() for c in cache),
                           softmax, out.clone(),
                           tuple(c.clone() for c in new)))
        return out, new


def same_as_numpy_runtime(tag, mtap, art):
    """Every call an engine made of artifact ``art`` (``ModelTap``), row by
    row through the numpy runtime (export/np_runtime.py, the C++
    runtime's executable specification) on the CPU, on the same features
    and input cache: posteriors and new caches within ``INT8_OUT_TOL``.
    Returns (max abs error, rows checked)."""
    import torch

    from wekws_tpu_torch.export import GraphRuntime

    rt = GraphRuntime(art)
    has_softmax = any(e["op"] == "softmax" for e in rt.ops)
    err, rows = 0.0, 0
    for feats, cache, softmax, out, new in mtap.calls:
        feats = feats.cpu().numpy()
        cache = [c.cpu().numpy() for c in cache]
        out, new = out.cpu().numpy(), [c.cpu().numpy() for c in new]
        for i in range(feats.shape[0]):
            want, state = rt.forward(feats[i], [c[i] for c in cache])
            if softmax and not has_softmax:
                want = torch.softmax(torch.from_numpy(want), -1).numpy()
            err = max([err, float(np.abs(out[i] - want).max())]
                      + [float(np.abs(n[i] - w).max())
                         for n, w in zip(new, state)])
            rows += 1
    if not rows:
        raise AssertionError(f"{tag}: the engine never called the model")
    if not err <= INT8_OUT_TOL:
        raise AssertionError(f"{tag}: max_abs_err {err:.3e} over {rows} "
                             f"rows > {INT8_OUT_TOL}")
    return err, rows


def phase19c_serving(dev, card, tmp):
    """19c: the committed JAX CTC fixtures, export/ (float) and
    export_int8/, served on the card.  The corpus (gen_data_torch.py,
    seed 17) first; its dev list feeds 19d.  (i) ``bin.export_model`` of
    the fixture's avg_5.ckpt equals the committed export/; (ii)
    ``BatchKeywordSpotter`` at 64 streams x 8 frames on the first 64
    test utterances with the device frontend (``fused_fbank``): the
    float artifact's posteriors against the fixture checkpoint served
    through ``fused_fsmn_kernel``, within TOL, the same detections; the
    int8 artifact with device decode, each of its model calls held row
    by row against the numpy runtime on the same features and cache
    (``INT8_OUT_TOL``); (iii) ``bin.serve --checkpoint export_int8``
    (device frontend and decode) to 16 client threads over the first
    ``DAEMON_UTTS`` test utterances: the events equal the in-process
    engine's;
    (iv) ``bin.stream_score_ctc`` on the 192 with each artifact: the
    int8 decisions beside the float ones.
    Returns (the dev list, the serving figures, bin.serve's launches)."""
    config, _ = fixture_config(CTC_FIXTURE, CTC_RECIPE, tmp,
                               "fsmn_ctc_fixture_19.yaml")
    argv = serve_argv(config, CTC_EXPORT_INT8, DAEMON_CLIENTS,
                      extra=["--device_decode", "--device_frontend"])
    # the daemon loads and warms up while the corpus is made and the
    # fixture exported; it is up before the engines are timed
    daemon = ServeProcess(argv + ["--device", dev.type],
                          os.path.join(tmp, "serve_19.log"))
    try:
        daemon.start()
        return serving_19c(dev, card, tmp, config, argv, daemon)
    finally:
        daemon.close()


def serving_19c(dev, card, tmp, config, argv, daemon):
    """19c's body, its daemon started (``phase19c_serving``)."""
    import torch

    from wekws_tpu_torch.bin import export_model as export_cli
    from wekws_tpu_torch.bin import serve, stream_score_ctc
    from wekws_tpu_torch.eval import compare_ctc_score_files

    data = corpus("ctc")
    with open(os.path.join(data, "test.list")) as f:
        lines = [json.loads(line) for line in f]
    utts = {x["key"]: pcm_of(x["wav"]) for x in lines}
    ckpt = os.path.join(CTC_FIXTURE, "avg_5.ckpt")
    tokens = os.path.join(CTC_RECIPE, "dict", "dict.txt")
    art = os.path.join(tmp, "fsmn_ctc_fixture_export")
    export_cli.main(["--config", config, "--checkpoint", ckpt,
                     "--output_dir", art, "--device", dev.type])
    same_artifact_files(art, CTC_EXPORT, "19c the CTC fixture's export")
    daemon.ready()
    pcms = [utts[x["key"]] for x in lines[:SERVE_STREAMS]]
    figures, runs = {}, {}
    for tag, src, fused, decode in (
            ("fixture checkpoint, fused_fsmn_layers", ckpt, True, False),
            ("float artifact", CTC_EXPORT, None, False),
            ("int8 artifact, device decode", CTC_EXPORT_INT8, None, True)):
        eng = h_engine(src, config, tokens, None, CTC_RECIPE_KEYWORD, dev,
                       True, decode, fused=fused)
        run_engine(eng, pcms)  # the first launches
        eng.reset_all()
        fresh_stats(eng)
        etap = EngineTap(eng)
        if src == CTC_EXPORT_INT8:
            mtap = ModelTap(eng)
        with PlainOnCuda() as plain, Launches() as n:
            run = run_engine(eng, pcms)
            torch.cuda.synchronize()
        plain.check(f"19c {tag}")
        steps = run["steps"]
        want_n = {"fused_fbank": steps}
        if fused:
            want_n["fused_fsmn_layers"] = steps
        if n.nonzero() != want_n:
            raise AssertionError(f"19c {tag}: launches {n.counts} for "
                                 f"{steps} steps")
        runs[tag] = (etap, run)
        figures[f"19c {tag}"] = engine_figures(
            f"19c CTC fixture, {tag}, {SERVE_STREAMS} streams x {SERVE_STEP}"
            f" frames, device frontend", run, n.nonzero(), card)
    fused_tap, fused_run = runs["fixture checkpoint, fused_fsmn_layers"]
    float_tap, float_run = runs["float artifact"]
    err = same_posteriors("19c float artifact vs the fixture checkpoint "
                          "through fused_fsmn_kernel", float_tap, fused_tap)
    fires = same_results("19c float artifact vs the fused checkpoint: "
                         "events", float_run["results"], fused_run["results"])
    int8_run = runs["int8 artifact, device decode"][1]
    int8_fires = sum(r.get("state") == 1 for res in int8_run["results"]
                     for r in res.values())
    if fires < 1:
        raise AssertionError("19c: the float artifact never fired")
    int8_err, int8_rows = same_as_numpy_runtime(
        "19c int8 artifact in the engine vs the numpy runtime", mtap,
        CTC_EXPORT_INT8)
    print(f"  19c float artifact vs the fixture checkpoint served through "
          f"fused_fsmn_kernel, {SERVE_STREAMS} streams x {SERVE_STEP} "
          f"frames: posteriors max_abs_err {err:.3e} (bound {TOL} abs + "
          f"{TOL} rel), the same {fires} detections; the int8 artifact "
          f"with device decode: {int8_fires} detections, its posteriors "
          f"and caches vs the numpy runtime on the same features "
          f"max_abs_err {int8_err:.3e} over {int8_rows} rows (bound "
          f"{INT8_OUT_TOL}) [{card}]", flush=True)
    figures["19c int8 artifact vs the numpy runtime"] = {
        "max_abs_err": int8_err, "rows": int8_rows}

    engine = serve.build_engine(serve.get_args(argv + ["--device",
                                                       dev.type]))
    # the daemon on a subset that fires; stream_score_ctc covers all 192
    utts = {x["key"]: utts[x["key"]] for x in lines[:DAEMON_UTTS]}
    with PlainOnCuda() as plain:
        want = in_process_events(engine, utts)
        torch.cuda.synchronize()
    plain.check("19c int8 artifact: in-process engine")
    with daemon as proc:
        got, wall = serve_clients(proc.port, utts)
    count = same_events("19c bin.serve --checkpoint export_int8 vs the "
                        "in-process engine", got, want)
    if count < 1:
        raise AssertionError("19c bin.serve export_int8: no detections")
    fig, served = served_figures(
        f"bin.serve --checkpoint export_int8 (device decode + frontend), "
        f"{DAEMON_CLIENTS} client threads, {len(utts)} utterances, {count} "
        f"detections equal to the in-process engine's", proc,
        ("fused_fbank",), wall, sum(len(p) for p in utts.values()) / 2
        / RATE, card, "19c")
    figures["19c bin.serve, int8 artifact"] = dict(fig, detections=count)

    test_list = os.path.join(data, "test.list")
    scores = {}
    for tag, src in (("float", CTC_EXPORT), ("int8", CTC_EXPORT_INT8)):
        scores[tag] = os.path.join(tmp, f"stream_score_{tag}.txt")
        t0 = time.perf_counter()
        n_utts = run_cli(stream_score_ctc.main, [
            "--config", config, "--checkpoint", src, "--test_data",
            test_list, "--token_file", tokens, "--keywords",
            CTC_RECIPE_KEYWORD, "--score_file", scores[tag], "--threshold",
            str(SERVE_THRESHOLD_CTC), "--device", dev.type],
            f"19c bin.stream_score_ctc {tag}")
        figures[f"19c stream_score_ctc {tag} s"] = time.perf_counter() - t0
        if n_utts != len(lines):
            raise AssertionError(f"19c stream_score_ctc {tag}: {n_utts} "
                                 f"utterances")
    flips, score_err = compare_ctc_score_files(scores["int8"],
                                               scores["float"])
    with open(scores["float"]) as f:
        detected = sum(" detected " in line for line in f)
    figures["19c int8 vs float decisions"] = {
        "utterances": len(lines), "float_detected": detected,
        "differ": flips, "score_err": score_err}
    print(f"  19c bin.stream_score_ctc on the {len(lines)} test utterances: "
          f"the int8 artifact's decisions against the float artifact's: "
          f"{len(lines) - len(flips)} equal, {len(flips)} differ "
          f"{flips}; {detected} detected by the float artifact; scores of "
          f"the utterances both detect within {score_err:.3f} "
          f"({figures['19c stream_score_ctc float s']:.1f} s and "
          f"{figures['19c stream_score_ctc int8 s']:.1f} s) [{card}]",
          flush=True)
    return os.path.join(data, "dev.list"), figures, served


def phase19d_clis(dev, card, tmp, dev_list, recipe_exp):
    """19d: ``bin.static_quantize --calib_data`` on the generated dev list;
    ``bin.export_torch`` then ``bin.import_torch`` on the CTC fixture's
    checkpoint (the port state back, 0 apart); ``run_torch.sh`` stage 4
    (``bin.export_model`` on the averaged checkpoint) on phase 14's
    averaged flagship recipe model, the shell script itself run in a
    copy of the recipe directory."""
    import shutil

    import torch

    from wekws_tpu_torch.bin import (
        export_torch,
        import_torch,
        static_quantize,
    )
    from wekws_tpu_torch.tools.export_torch import load_port_model

    qdir = os.path.join(tmp, "static_quantize_cli")
    with PlainOnCuda() as plain:
        dev_err = static_quantize.main([
            "--model_dir", CTC_EXPORT, "--output_dir", qdir, "--calib_data",
            dev_list, "--device", dev.type])
    plain.check("19d bin.static_quantize")
    config, conf = fixture_config(CTC_FIXTURE, CTC_RECIPE, tmp,
                                  "fsmn_ctc_fixture_19d.yaml")
    ckpt = os.path.join(CTC_FIXTURE, "avg_5.ckpt")
    ref_pt, back_pt = (os.path.join(tmp, x) for x in ("ref.pt", "back.pt"))
    export_torch.main(["--checkpoint", ckpt, "--config", config, "--output",
                       ref_pt, "--device", dev.type])
    import_torch.main(["--torch_checkpoint", ref_pt, "--config", config,
                       "--output_checkpoint", back_pt, "--device",
                       dev.type])
    want = load_port_model(ckpt, conf["model"], dev).state_dict()
    back = torch.load(back_pt)
    if back.keys() != want.keys() or any(
            not torch.equal(back[k], want[k].cpu()) for k in want):
        raise AssertionError("19d export_torch -> import_torch: the port "
                             "state did not come back")
    recipe = os.path.join(tmp, "recipe")
    exp = os.path.join(recipe, "exp", "torch_mdtc_flagship")
    os.makedirs(exp)
    for f in ("run_torch.sh", "path.sh"):
        shutil.copy(os.path.join(RECIPE, f), recipe)
    shutil.copy(os.path.join(recipe_exp, "config.yaml"), exp)
    shutil.copy(os.path.join(recipe_exp, f"avg_{RECIPE_EPOCHS}.pt"),
                os.path.join(exp, "avg_5.pt"))
    repo = os.path.abspath(os.path.dirname(__file__) or ".")
    t0 = time.perf_counter()
    proc = subprocess.run(
        ["bash", "run_torch.sh", "4", "4", "conf_torch/mdtc_flagship.yaml",
         dev.type], cwd=recipe, env=dict(os.environ, PYTHONPATH=repo),
        capture_output=True, text=True, timeout=300)
    stage_s = time.perf_counter() - t0
    out = os.path.join(exp, "export")
    if proc.returncode != 0 or not all(os.path.exists(os.path.join(out, f))
                                       for f in ("model.json",)
                                       + ARTIFACT_FILES):
        raise AssertionError(f"run_torch.sh stage 4 exited "
                             f"{proc.returncode}:\n{proc.stdout[-2000:]}\n"
                             f"{proc.stderr[-2000:]}")
    gate = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("graph artifact")]
    print(f"  19d bin.static_quantize --calib_data (the generated dev list) "
          f"on the CTC fixture's export: max posterior deviation "
          f"{dev_err:.4f} on the card; bin.export_torch -> bin.import_torch: "
          f"the port state back, {len(want)} tensors 0 apart; run_torch.sh "
          f"stage 4 on phase 14's averaged recipe model: {gate[-1:]} in "
          f"{stage_s:.1f} s [{card}]", flush=True)
    return {"static_quantize_deviation": dev_err, "stage4_s": stage_s}


def path_h_engines(work, fsmn_art, fsmn_q, dev):
    """The hi_xiaowen FSMN-CTC at 64 streams x 8 frames, device frontend
    and decode: phase 11's checkpoint through ``fused_fsmn_kernel``, its
    float artifact and its static-int8 artifact."""
    ckpt, config, tokens, lexicon = (os.path.join(work, x) for x in (
        "fsmn_ctc.pt", "fsmn_ctc.yaml", "tokens.txt", "lexicon.txt"))
    return {tag: h_engine(src, config, tokens, lexicon, CTC_KEYWORD, dev,
                          True, True, fused=fused)
            for tag, src, fused in (("fused checkpoint", ckpt, True),
                                    ("float artifact", fsmn_art, None),
                                    ("int8 artifact", fsmn_q, None))}


def path_h_child(work, fsmn_art, fsmn_q, device="cuda"):
    """In a fresh process: one traced step of each of ``path_h_engines``
    (64 streams of phase 17's waves queued), its device time and CUDA
    launches; and the model's step alone at 64 x 8 (seeded features):
    the fused stream's and each artifact's, traced, and its untraced
    median of 10 (``timed_steps``).  Prints one line ``PATH_H {...}``."""
    import torch
    import yaml

    from wekws_tpu_torch.export import TorchGraphRuntime
    from wekws_tpu_torch.ops.serving import build_fused_stream
    from wekws_tpu_torch.runtime.keyword_spotter import load_serving_model

    dev = torch.device(device)
    pcms = [w.astype("<i2").tobytes() for w in serve_waves()]
    out = {}
    for tag, eng in path_h_engines(work, fsmn_art, fsmn_q, dev).items():
        run_engine(eng, pcms)  # the first launches
        eng.reset_all()
        for i, p in enumerate(pcms):
            eng.accept_wave(i, p)
        eng.step()
        busy, entries, _ = profiled_step(eng.step)
        out[tag] = {"busy_ms": busy, "launches": entries}
    with open(os.path.join(work, "fsmn_ctc.yaml")) as f:
        configs = yaml.safe_load(f)
    d = configs["model"]["input_dim"]
    x = torch.randn((SERVE_STREAMS, SERVE_STEP, d),
                    generator=torch.Generator().manual_seed(SEED)).to(dev)
    step, init = build_fused_stream(load_serving_model(
        configs, os.path.join(work, "fsmn_ctc.pt"), d, dev), device=dev)
    steps = {"fused checkpoint": (step, init(SERVE_STREAMS))}
    for tag, art in (("float artifact", fsmn_art),
                     ("int8 artifact", fsmn_q)):
        rt = TorchGraphRuntime(art, dev)
        steps[tag] = (rt.forward, rt.init_state(SERVE_STREAMS))
    for tag, (fn, cache) in steps.items():
        def call(fn=fn, cache=cache):
            with torch.inference_mode():
                return fn(x, cache)

        median = timed_steps(call)[0]
        busy, entries, _ = profiled_step(call)
        out[tag].update(model_busy_ms=busy, model_launches=entries,
                        model_median_ms=median)
    print("PATH_H " + json.dumps(out), flush=True)


def phase19_times(dev, card, work, fsmn_art, fsmn_q):
    """The hi_xiaowen FSMN-CTC at 64 streams x 8 frames (device frontend
    and decode), the fused checkpoint, the float artifact and the int8
    artifact: mean and p99 step on the host clock and real-time factor
    here (``engine_figures``), each step's device time and CUDA launches
    from one traced step in a fresh process (``path_h_child``)."""
    import torch

    pcms = [w.astype("<i2").tobytes() for w in serve_waves()]
    traced = run_child("path_h_child", [work, fsmn_art, fsmn_q], "PATH_H")
    figures, counted = {}, {}
    for tag, eng in path_h_engines(work, fsmn_art, fsmn_q, dev).items():
        run_engine(eng, pcms)
        eng.reset_all()
        fresh_stats(eng)
        with PlainOnCuda() as plain, Launches() as n:
            run = run_engine(eng, pcms)
            torch.cuda.synchronize()
        plain.check(f"19 times {tag}")
        for k, v in n.counts.items():
            counted[k] = counted.get(k, 0) + v
        fig = engine_figures(f"19 hi_xiaowen FSMN-CTC, {tag}, "
                             f"{SERVE_STREAMS} streams x {SERVE_STEP} "
                             f"frames, device frontend + decode", run,
                             n.nonzero(), card)
        t = traced[tag]
        fig.update(device_ms=t["busy_ms"],
                   cuda_launches_per_step=t["launches"],
                   model_device_ms=t["model_busy_ms"],
                   model_launches=t["model_launches"],
                   model_median_ms=t["model_median_ms"])
        print(f"  19 {tag}: one engine step traced in a fresh process: "
              f"device time {t['busy_ms']:.3f} ms, {t['launches']} CUDA "
              f"launches (the featurizer and the decode included); the "
              f"model's step alone at {SERVE_STREAMS} x {SERVE_STEP}: "
              f"device time {t['model_busy_ms']:.3f} ms, "
              f"{t['model_launches']} CUDA launches, untraced median "
              f"{t['model_median_ms']:.3f} ms (host clock) [{card}]",
              flush=True)
        figures[f"19 times {tag}"] = fig
    return figures, counted


def phase19_artifacts(dev, card, work, recipe_exp):
    """Path H, export and static int8 (A.12): 19a export at full width,
    19b static int8, 19c serving the committed fixtures, 19d the CLIs,
    then the times; every call of a path-F wrapper tapped by shape
    (``ShapeTap``), the launches counted from 0 before each sub-path and
    read after it; 19e each kernel against its plain version at every
    shape path H gave it.  Returns ({sub-path: {kernel record:
    launches}}, {kernel record: [readings]}, the figures)."""
    import tempfile

    launches, figures = {}, {}
    wrappers = path_h_wrappers()

    def counted(name, fn, *args):
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        out = fn(*args)
        launches[name] = {k: w.launches for k, w in wrappers.items()}
        print(f"  {name}: {time.perf_counter() - t0:.1f} s", flush=True)
        return out

    with tempfile.TemporaryDirectory() as tmp, ShapeTap() as tap:
        with PlainOnCuda() as plain:
            arts = counted("19a export", phase19a_export, dev, card, work,
                           tmp)
            fsmn_q = counted("19b int8", phase19b_int8, dev, card, tmp,
                             arts["fsmn_ctc"])
        plain.check("19a-19b")
        dev_list, fig, served = counted("19c serving", phase19c_serving,
                                        dev, card, tmp)
        figures.update(fig)
        figures.update(counted("19d CLIs", phase19d_clis, dev, card, tmp,
                               dev_list, recipe_exp))
        times, _ = counted("19 times", phase19_times, dev, card, work,
                           arts["fsmn_ctc"], fsmn_q)
        figures.update(times)
    launches["19c bin.serve (its own counts)"] = served
    in_process = {}
    for sub, counts in launches.items():
        if not sub.startswith("19c bin.serve"):
            for k, v in counts.items():
                in_process[k] = in_process.get(k, 0) + v
    missing = [k for k, v in in_process.items() if not v]
    if missing:
        raise AssertionError(f"path H launched no {missing}: {launches}")
    tapped = {}
    for (name, _), (calls, *_) in tap.shapes.items():
        tapped[name] = tapped.get(name, 0) + calls
    untapped = dict(in_process)
    untapped.pop("fused_mdtc_forward")
    if tapped != untapped:
        raise AssertionError(f"path H: the calls seen by shape {tapped} are "
                             f"not the launches counted {in_process}")
    readings = phase17e_kernel_checks(card, tap.shapes, "19e", "H")
    return launches, readings, figures


def merge_path_h(record, launches, readings):
    """Path H's launches (by sub-path) and readings into the kernel
    records."""
    rows = {r["name"]: r for r in record}
    for sub, counts in launches.items():
        for name, n in counts.items():
            if n:
                rows[name]["launches"] += n
                rows[name].setdefault("path_h_launches", {})[sub] = n
    for name, rs in readings.items():
        rows[name]["path_h"] = rs
        rows[name]["max_abs_err"] = max(
            [rows[name]["max_abs_err"]] + [r["max_abs_err"] for r in rs])


# ---------------------------------------------------------------------------
# phase 20, path I: data parallelism (A.13)
# ---------------------------------------------------------------------------

# 20b: two ranks sharing the card (B=256 each of the same 512 rows)
# against one process at B=512: step 0's loss 1e-5 rel (the same
# function, fp32 sums in another order), later losses 1e-4 rel;
# parameters within 2 * lr * steps + 1e-5 and BN running statistics
# within 1e-4 after the first step, then the parameters' bound plus
# 1e-4 (tests/test_torch_training.py:168-194: Adam's first update is
# about lr * sign(g), and a gradient near zero can take either sign)
PATH_I_STEPS, PATH_I_LR, PATH_I_RANKS = 3, 1e-3, 2
PATH_I_LOSS0_RTOL, PATH_I_LOSS_RTOL, PATH_I_STATS_TOL = 1e-5, 1e-4, 1e-4
# ... and step 0's parameters wherever one process's |grad| exceeds the
# step-0 gradient bound (1e-4 of its tensor's max(1, max |grad|)), so
# the two agree on its sign: within 1e-5 (a wrong sign is 2 lr apart)
PATH_I_HELD_TOL = 1e-5
PATH_I_TIMEOUT_S = 300
# 20b's pipeline: the fused frontend without dither or spec_aug (each
# rank draws its own, so only a step without draws equals one process's)
PATH_I_CONF = dict(PATH_G_CONF, spec_aug=False, fbank_conf=dict(
    PATH_G_CONF["fbank_conf"], dither=0.0))
# 20c: the bucket schedule keeps host-fed ranks in lockstep
PATH_I_BUCKETS = [24000, 32000]
PATH_I_SERVE_UTTS, PATH_I_CLIENTS = 8, 4


class AllReduceTap:
    """Within the ``with``, the calls of ``torch.distributed.all_reduce``
    (the port's collectives go through it) and their host time;
    ``counts`` of them on host tensors (the fused passes' frame counts,
    over gloo) among ``calls``."""

    def __enter__(self):
        import torch.distributed as dist

        self.calls, self.counts, self.host_s = 0, 0, 0.0
        self._dist, self._fn = dist, dist.all_reduce

        def timed(tensor, *args, **kwargs):
            t0 = time.perf_counter()
            try:
                return self._fn(tensor, *args, **kwargs)
            finally:
                self.calls += 1
                self.counts += tensor.device.type == "cpu"
                self.host_s += time.perf_counter() - t0

        dist.all_reduce = timed
        return self

    def __exit__(self, *exc):
        self._dist.all_reduce = self._fn
        return False


def state_arrays(state):
    return {k: v.detach().cpu().numpy().copy()
            for k, v in state.model.state_dict().items()}


def path_i_steps(trainer, state, rows, steps, step0=None):
    """``steps`` train steps on ``rows``: (state, per step (loss, acc,
    grad norm, skipped), per step wall ms, the ``AllReduceTap``); step
    0's gradients and state into the dict ``step0`` where one is given
    (keys ``grads``, ``state``)."""
    import torch

    metrics, walls = [], []
    with AllReduceTap() as ar:
        for i in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = trainer.train_step(state, rows, SEED, PATH_I_LR)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            metrics.append(tuple(float(m[k]) for k in (
                "loss", "acc", "grad_norm", "skipped")))
            if i == 0 and step0 is not None:
                step0["grads"] = {n: p.grad.cpu().numpy().copy() for n, p
                                  in state.model.named_parameters()}
                step0["state"] = state_arrays(state)
    return state, metrics, walls, ar


def path_i_rank(rank, model_conf, seed, device_type):
    """20b, in each spawned rank (gloo on CUDA tensors: the ranks share
    the card): ``PATH_I_STEPS`` steps on this rank's half of the 512
    rows made from ``seed``; the launches of the training kernels."""
    import torch

    from wekws_tpu_torch.ops.fused_frontend import fused_fbank
    from wekws_tpu_torch.ops.fused_mdtc_train import reset_launches
    from wekws_tpu_torch.parallel.mesh import (
        collective_backend,
        process_count,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device_type)
    if dev.type == "cuda":  # the card distributed_init picked
        dev = torch.device("cuda", torch.cuda.current_device())
    rows = resident_arrays(TRAIN_B, seed)
    part = TRAIN_B // process_count()
    local = {k: v[rank * part:(rank + 1) * part] for k, v in rows.items()}
    trainer = path_g_trainer(dev, model_conf, PATH_I_CONF)
    state = trainer.init_state()
    reset_launches()
    fused_fbank.launches = 0
    step0 = {}
    with PlainOnCuda() as plain:
        state, metrics, walls, ar = path_i_steps(
            trainer, state, local, PATH_I_STEPS, step0)
    plain.check(f"20b rank {rank}")
    return {"metrics": metrics, "walls": walls, "all_reduces": ar.calls,
            "host_counts": ar.counts, "step0": step0,
            "all_reduce_ms": ar.host_s * 1e3, "state": state_arrays(state),
            "launches": path_g_counts(), "backend": collective_backend(),
            "device": str(dev)}


def phase20a_nccl(dev, card, model_conf, rows):
    """Two flagship steps (B=512 x 2 s, ``fused_train``,
    ``fused_frontend``, wave dither, spec_aug) in a one-rank group made
    by ``parallel.mesh.join_group`` (the gloo rendezvous, the layout
    exchange, an NCCL group for the collectives: every collective a
    copy), ``init_state``'s broadcast included, against the same steps
    with no group: losses, accuracies, grad norms, every parameter and
    BN buffer bit for bit.  Returns (the second step's wall ms,
    all-reduces a step, the launches)."""
    import torch

    from wekws_tpu_torch.ops.fused_frontend import fused_fbank
    from wekws_tpu_torch.ops.fused_mdtc_train import reset_launches
    from wekws_tpu_torch.ops.fused_tcn import fused_ds_tcn
    from wekws_tpu_torch.parallel.mesh import (
        collective_backend,
        distributed_close,
        free_port,
        join_group,
    )

    trainer = path_g_trainer(dev, model_conf)
    state, want, walls0, _ = path_i_steps(trainer, trainer.init_state(),
                                         rows, 2)
    want_state = state_arrays(state)
    del trainer, state
    join_group(f"127.0.0.1:{free_port()}", 1, 0,
               torch.device("cuda", dev.index or 0))
    try:
        backend = collective_backend()
        trainer = path_g_trainer(dev, model_conf)
        with AllReduceTap() as init_ar:
            state = trainer.init_state()
        reset_launches()
        fused_fbank.launches = fused_ds_tcn.launches = 0
        with PlainOnCuda() as plain:
            state, got, walls, ar = path_i_steps(trainer, state, rows, 2)
        launches = {k: v for k, v in path_g_counts().items() if v}
        plain.check("20a")
        torch.cuda.synchronize()
    finally:
        distributed_close()
    got_state = state_arrays(state)
    diff = [k for k in want_state
            if not np.array_equal(want_state[k], got_state[k])]
    if backend != "nccl" or got != want or diff:
        raise AssertionError(f"20a one-rank NCCL group ({backend}): metrics "
                             f"{got} vs {want}; differing tensors {diff[:5]}")
    print(f"  20a two flagship steps B={TRAIN_B} x {TRAIN_SECONDS} s in a "
          f"one-rank {backend} group vs no group: losses "
          f"{[m[0] for m in got]}, accuracies, grad norms and all "
          f"{len(want_state)} parameters and buffers bit for bit; "
          f"{ar.calls // 2} all-reduces a step ({ar.counts // 2} of them "
          f"frame counts on the host; {ar.host_s * 1e3 / 2:.2f} ms host), "
          f"{init_ar.calls} in init_state (broadcasts only); the second "
          f"step {walls[1]:.1f} ms wall (no group {walls0[1]:.1f} ms); "
          f"launches {launches} [{card}]", flush=True)
    return walls[1], ar.calls // 2, launches


def phase20b_two_ranks(dev, card, model_conf, wall_a):
    """Two ranks spawned on the one card (gloo on CUDA tensors: NCCL
    refuses two ranks on one GPU), B=256 each of the same 512 rows, no
    dither or spec_aug, ``PATH_I_STEPS`` steps against one process at
    B=512; both ranks bit for bit alike.  Then F1-F4/B1-B4 and
    ``fused_fbank`` at path I's shapes (a B=256 step tapped, as 18e)
    against their plain versions.  Returns (the ranks' launches summed,
    the readings)."""
    import collections

    from wekws_tpu_torch.parallel.launch import run_local

    seed = SEED + 20
    t0 = time.perf_counter()
    outs = run_local(path_i_rank, PATH_I_RANKS, (model_conf, seed, dev.type),
                     device=dev.type, timeout_s=PATH_I_TIMEOUT_S)
    spawn_s = time.perf_counter() - t0
    rows = resident_arrays(TRAIN_B, seed)
    trainer = path_g_trainer(dev, model_conf, PATH_I_CONF)
    want0 = {}
    state, want, walls, _ = path_i_steps(trainer, trainer.init_state(),
                                         rows, PATH_I_STEPS, want0)
    want_state = state_arrays(state)
    del trainer, state
    first = outs[0]
    for r, out in enumerate(outs[1:], 1):
        diff = [k for k in out["state"]
                if not np.array_equal(out["state"][k], first["state"][k])]
        if out["metrics"] != first["metrics"] or diff:
            raise AssertionError(f"20b rank {r} differs from rank 0: "
                                 f"{out['metrics']} vs {first['metrics']}; "
                                 f"{diff[:5]}")
    backends = [o["backend"] for o in outs]
    if set(backends) != {"gloo"}:
        raise AssertionError(f"20b: collectives on {backends}")
    # step 0's summed gradients against one process's: 1e-4 of each
    # tensor's max(1, max |grad|) (tests/test_torch_training.py's bound)
    # step 0's parameters where the sign of the gradient is settled
    # (one process's |grad| above that bound): Adam moves them by lr
    # times that sign, so they agree within PATH_I_HELD_TOL, where a
    # wrong sign is 2 lr apart
    grad_err, held, held_err = 0.0, 0, 0.0
    for name, ref in want0["grads"].items():
        scale = max(float(np.abs(ref).max()), 1.0)
        err = float(np.abs(first["step0"]["grads"][name] - ref).max()) / scale
        grad_err = max(grad_err, err)
        if err > 1e-4:
            raise AssertionError(f"20b step-0 gradient {name}: {err} of "
                                 f"its scale")
        mask = np.abs(ref) > 1e-4 * scale
        diff = np.abs(first["step0"]["state"][name].astype(np.float64)
                      - want0["state"][name])[mask]
        held += int(mask.sum())
        if diff.size:
            held_err = max(held_err, float(diff.max()))
    if held_err > PATH_I_HELD_TOL:
        raise AssertionError(f"20b step-0 parameters with a settled "
                             f"gradient sign: {held_err} > "
                             f"{PATH_I_HELD_TOL}")
    n_params = sum(v.size for v in want0["grads"].values())
    # the losses and the final state against one process; a miss is
    # reported after 20c-20e have run (it fails the phase then)
    worst, misses = {}, []
    for i, (got, ref) in enumerate(zip(first["metrics"], want)):
        rtol = PATH_I_LOSS0_RTOL if i == 0 else PATH_I_LOSS_RTOL
        rel = abs(got[0] - ref[0]) / abs(ref[0])
        print(f"  20b step {i}: loss {got[0]:.7f} vs one process "
              f"{ref[0]:.7f} ({rel:.2e} rel, bound {rtol}); grad norm "
              f"{got[2]:.5f} vs {ref[2]:.5f}", flush=True)
        if not rel <= rtol or got[3]:
            misses.append(f"step {i} loss {got} vs {ref} (rtol {rtol})")
    last = PATH_I_STEPS - 1
    for name, ref in want_state.items():
        if name.endswith("num_batches_tracked"):
            continue
        bound = 2 * PATH_I_LR * PATH_I_STEPS + 1e-5
        if "running" in name:
            bound += PATH_I_STATS_TOL if last else 0.0
        err = float(np.abs(first["state"][name].astype(np.float64)
                           - ref).max())
        worst[name] = err
        if err > bound:
            misses.append(f"{name} {err:.3e} > {bound:.3e} (|ref| max "
                          f"{float(np.abs(ref).max()):.3e})")
    for key in ("weight", "running_mean", "running_var"):
        name = max((k for k in worst if k.endswith(key)), key=worst.get)
        print(f"  20b the largest error of a {key}: {name} "
              f"{worst[name]:.3e} (|ref| max "
              f"{float(np.abs(want_state[name]).max()):.3e})", flush=True)
    launches = {}
    for out in outs:
        for k, v in out["launches"].items():
            launches[k] = launches.get(k, 0) + v
    want_launches = {f"fused_train_{p}": 17 * PATH_I_STEPS * PATH_I_RANKS
                     for p in TRAIN_PASSES}
    want_launches.update(fused_fbank=PATH_I_STEPS * PATH_I_RANKS,
                         fused_ds_tcn=0)
    if launches != want_launches:
        raise AssertionError(f"20b launches {launches}, want "
                             f"{want_launches}")
    per_step = first["all_reduces"] / PATH_I_STEPS
    param_errs = [v for k, v in worst.items() if "running" not in k]
    stat_errs = [v for k, v in worst.items() if "running" in k]
    print(f"  20b {PATH_I_RANKS} ranks on {first['device']} (collectives on "
          f"{first['backend']}, {spawn_s:.1f} s from spawn to join), "
          f"B={TRAIN_B // PATH_I_RANKS} each of the same {TRAIN_B} rows, "
          f"{PATH_I_STEPS} steps vs one process at B={TRAIN_B}: losses "
          f"{[m[0] for m in first['metrics']]} vs {[m[0] for m in want]}; "
          f"the largest parameter error {max(param_errs):.2e}, BN "
          f"statistic {max(stat_errs):.2e}; "
          f"step-0 gradients within {grad_err:.2e} of their scale; step "
          f"0's parameters at the {held} of {n_params} coordinates whose "
          f"|grad| is above 1e-4 of its tensor's max(1, max |grad|) within "
          f"{held_err:.2e} (bound {PATH_I_HELD_TOL}); both "
          f"ranks bit for bit alike; {per_step:.0f} all-reduces a step "
          f"({first['host_counts'] / PATH_I_STEPS:.0f} of them frame "
          f"counts on the host), "
          f"{first['all_reduce_ms'] / PATH_I_STEPS:.2f} ms of host time in "
          f"them a step; step wall {np.median(first['walls']):.1f} ms "
          f"(median of {PATH_I_STEPS}) beside 20a's one-rank NCCL step "
          f"{wall_a:.1f} ms and one process at B={TRAIN_B} "
          f"{np.median(walls):.1f} ms; launches {launches} [{card}]",
          flush=True)
    # the kernels at path I's shapes (a rank's B=256 step), as 18e
    trainer = path_g_trainer(dev, model_conf, PATH_I_CONF)
    half = {k: v[:TRAIN_B // PATH_I_RANKS] for k, v in rows.items()}
    with ShapeTap(PATH_G_WRAPPERS) as ftap, PassTap() as ptap:
        trainer.train_step(trainer.init_state(), half, SEED, PATH_I_LR)
    no_trace = collections.defaultdict(lambda: None)
    readings = phase17e_kernel_checks(card, ftap.shapes, "20b", "I",
                                      no_trace)
    readings.update(phase18e_pass_checks(card, ptap.shapes, no_trace, "20b",
                                         "I"))
    return {"20b ranks": launches}, readings, {
        "misses": misses, "all_reduces_per_step": per_step,
        "host_counts_per_step": first["host_counts"] / PATH_I_STEPS,
        "step0_held_coordinates": held, "step0_coordinates": n_params,
        "step0_held_max_abs_err": held_err,
        "all_reduce_host_ms_per_step": first["all_reduce_ms"] / PATH_I_STEPS,
        "rank_step_ms": first["walls"], "one_process_step_ms": walls,
        "one_rank_nccl_step_ms": wall_a}


def phase20c_cli(dev, card, tmp):
    """``bin.train --coordinator 127.0.0.1:P --num_processes 2
    --process_id r`` as two processes on the card, host-fed (the bucket
    schedule) and ``--device_resident`` side by side, one epoch of
    ``examples/synthetic`` each: both exit 0, finite losses, both log
    the same cv figures, only rank 0 writes; ``bin.score`` of rank 0's
    checkpoint through ``fused_mdtc_kernel``.  Returns the launches."""
    import re

    import torch
    import yaml

    from wekws_tpu_torch.bin import score
    from wekws_tpu_torch.ops import fused_mdtc
    from wekws_tpu_torch.parallel.mesh import free_port

    with open(os.path.join(RECIPE, "conf_torch", "mdtc_flagship.yaml")) as f:
        configs = yaml.safe_load(f)
    configs["dataset_conf"]["batch_conf"]["bucket_boundaries"] = \
        PATH_I_BUCKETS
    config = os.path.join(tmp, "mdtc_flagship_buckets.yaml")
    with open(config, "w") as f:
        yaml.safe_dump(configs, f)
    lists = recipe_lists(tmp)
    repo = os.path.abspath(os.path.dirname(__file__) or ".")
    launches = {}
    modes = (("host-fed", []), ("resident", ["--device_resident"]))
    # both modes' groups at once, side by side on the card
    procs, logs, ports = {}, [], set()
    t0 = time.perf_counter()
    for mode, extra in modes:
        port = free_port()
        while port in ports:
            port = free_port()
        ports.add(port)
        procs[mode] = []
        for rank in range(PATH_I_RANKS):
            log = open(os.path.join(tmp, f"train_{mode}_{rank}.log"), "w")
            procs[mode].append(subprocess.Popen(
                [sys.executable, "-m", "wekws_tpu_torch.bin.train",
                 "--config", config, "--train_data", lists["train"],
                 "--cv_data", lists["dev"], "--model_dir",
                 os.path.join(tmp, f"exp_{mode}_{rank}"), "--num_epochs",
                 "1", "--min_duration", "20", "--seed", "666",
                 "--cmvn_file", os.path.join(RECIPE, "data", "global_cmvn"),
                 "--norm_var", "--coordinator", f"127.0.0.1:{port}",
                 "--num_processes", str(PATH_I_RANKS), "--process_id",
                 str(rank), "--device", dev.type] + extra, cwd=repo,
                stdout=log,
                stderr=subprocess.STDOUT,
                env=dict(os.environ, PYTHONPATH=repo)))
            logs.append(log)
    walls = {}
    try:
        for mode, group in procs.items():
            for p in group:
                p.wait(max(t0 + RECIPE_TIMEOUT_S - time.perf_counter(), 1))
            walls[mode] = time.perf_counter() - t0
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in sum(procs.values(), []):
            if p.poll() is None:
                p.kill()
                p.wait(30)
        for log in logs:
            log.close()
    for mode, _ in modes:
        group, wall = procs[mode], walls.get(mode, float("nan"))
        texts = []
        for rank in range(PATH_I_RANKS):
            with open(os.path.join(tmp, f"train_{mode}_{rank}.log")) as f:
                texts.append(f.read())
        if any(p.returncode != 0 for p in group):
            raise AssertionError(f"20c bin.train {mode}: exit codes "
                                 f"{[p.returncode for p in group]}:\n"
                                 + "\n".join(t[-3000:] for t in texts))
        cv = [[ln.split(" INFO ")[-1] for ln in t.splitlines()
               if "CV loss" in ln] for t in texts]
        lead = os.path.join(tmp, f"exp_{mode}_0")
        with open(os.path.join(lead, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        written = sorted(os.listdir(lead))
        rest = [os.listdir(os.path.join(tmp, f"exp_{mode}_{r}"))
                for r in range(1, PATH_I_RANKS)]
        backends = [m.group(1) for t in texts for m in re.finditer(
            r"collectives on (\w+)", t)]
        if (len(cv[0]) != 1 or any(c != cv[0] for c in cv)
                or not {"config.yaml", "init.pt", "0.pt", "final.pt",
                        "metrics.jsonl"} <= set(written) or any(rest)
                or not np.isfinite(records[0]["train_loss"])):
            raise AssertionError(f"20c bin.train {mode}: cv lines {cv}, rank "
                                 f"0 wrote {written}, the others {rest}, "
                                 f"records {records}")
        fused_mdtc.fused_mdtc_forward.launches = 0
        with PlainOnCuda() as plain:
            n_scored = score.main([
                "--config", os.path.join(lead, "config.yaml"),
                "--test_data", lists["test"], "--checkpoint",
                os.path.join(lead, "0.pt"), "--score_file",
                os.path.join(lead, "score.txt"), "--device", dev.type])
            torch.cuda.synchronize()
        plain.check(f"20c bin.score ({mode})")
        n = fused_mdtc.fused_mdtc_forward.launches
        if n_scored != dict(RECIPE_SPLITS)["test"] or n < 1:
            raise AssertionError(f"20c bin.score ({mode}): {n_scored} "
                                 f"utterances, {n} fused_mdtc launches")
        launches[f"20c bin.score ({mode})"] = {"fused_mdtc_forward": n}
        print(f"  20c bin.train {mode}, {PATH_I_RANKS} processes on the card "
              f"(collectives on {sorted(set(backends))}), one epoch: "
              f"{wall:.1f} s wall (both modes side by side), train loss {records[0]['train_loss']:.4f}, "
              f"{records[0]['audio_seconds_per_s']:.1f} audio-s/s (global); "
              f"every rank logged '{cv[0][0]}'; rank 0 wrote {written}, the "
              f"others nothing; bin.score of rank 0's 0.pt: {n_scored} "
              f"utterances, {n} fused_mdtc_kernel launch(es) [{card}]",
              flush=True)
    return launches


def phase20d_split_engine(dev, card, work):
    """``BatchMaxPoolSpotter`` over ``[cuda:0, cuda:0]`` (two row blocks,
    each its weights and caches, on the one card) against the one-device
    engine at 64 streams x 8 frames on phase 4's flagship: every step's
    posteriors within TOL, the same events.  Returns the launches."""
    import torch

    from wekws_tpu_torch.runtime import BatchMaxPoolSpotter

    pcms = [w.astype("<i2").tobytes() for w in serve_waves()]
    ckpt, config = (os.path.join(work, f"flagship.{x}")
                    for x in ("pt", "yaml"))

    def engine(threshold, devices=None):
        return BatchMaxPoolSpotter(
            ckpt, config, threshold, num_streams=SERVE_STREAMS,
            step_frames=SERVE_STEP, use_fused=True, device=devices or dev)

    one = engine(2.0)
    tap = EngineTap(one)
    run_engine(one, pcms)
    flat = torch.cat([p.flatten() for p, _ in tap.steps])
    threshold = float(torch.quantile(flat.cpu(), 0.95))
    one = engine(threshold)
    one_tap = EngineTap(one)
    want = run_engine(one, pcms)
    split = engine(threshold, [dev, dev])
    split_tap = EngineTap(split)
    with PlainOnCuda() as plain, Launches() as n:
        got = run_engine(split, pcms)
        torch.cuda.synchronize()
    plain.check("20d")
    err = same_posteriors("20d split vs one device", split_tap, one_tap)
    fires = same_results("20d split vs one device", got["results"],
                         want["results"])
    steps = got["steps"]
    if fires < 1 or n.counts["fused_mdtc_stream"] != 2 * steps:
        raise AssertionError(f"20d: {fires} events, launches {n.counts} for "
                             f"{steps} steps of two blocks")
    print(f"  20d BatchMaxPoolSpotter over [{dev}, {dev}] ({SERVE_STREAMS} "
          f"streams x {SERVE_STEP} frames, two blocks of "
          f"{SERVE_STREAMS // 2}) vs one device: posteriors max_abs_err "
          f"{err:.3e} (bound {TOL} abs + {TOL} rel), the same {fires} events "
          f"at threshold {threshold:.4f}; {steps} steps, "
          f"{got['wall_s'] / steps * 1e3:.2f} ms a step (one device "
          f"{want['wall_s'] / want['steps'] * 1e3:.2f}), launches "
          f"{n.nonzero()} [{card}]", flush=True)
    return {"20d split engine": n.nonzero()}


def path_i_daemon(dev, tmp, work):
    """20e's ``bin.serve --mesh_devices 1`` of the flagship (max-pooling),
    not yet started."""
    return ServeProcess(
        serve_argv(os.path.join(work, "flagship.yaml"),
                   os.path.join(work, "flagship.pt"), PATH_I_CLIENTS,
                   ctc=False, extra=["--mesh_devices", "1", "--device",
                                     dev.type]),
        os.path.join(tmp, "serve_mesh.log"))


def phase20e_serve(dev, card, daemon, work):
    """``daemon`` (``path_i_daemon``, started during 20c) to
    ``PATH_I_CLIENTS`` client threads: the in-process engine's events,
    one ``fused_mdtc_stream`` launch a dispatch by bin.serve's own
    count.  Returns the launches."""
    from wekws_tpu_torch.runtime import BatchMaxPoolSpotter

    ckpt, config = (os.path.join(work, f"flagship.{x}")
                    for x in ("pt", "yaml"))
    waves = serve_waves()[:PATH_I_SERVE_UTTS]
    utts = {f"s{i:02d}": w.astype("<i2").tobytes()
            for i, w in enumerate(waves)}
    engine = BatchMaxPoolSpotter(ckpt, config, 0.5, num_streams=1,
                                 step_frames=8, keyword_names=[KEYWORD],
                                 use_fused=True, device=dev)
    want = in_process_events(engine, utts)
    with daemon as proc:
        got, wall = serve_clients(proc.port, utts, PATH_I_CLIENTS)
    count = same_events("20e bin.serve --mesh_devices 1 vs the in-process "
                        "engine", got, want)
    audio = sum(len(p) for p in utts.values()) / 2 / RATE
    _, served = served_figures("flagship, --mesh_devices 1", proc,
                               ["fused_mdtc_stream"], wall, audio, card,
                               sub="20e")
    print(f"  20e: {len(utts)} utterances to {PATH_I_CLIENTS} clients, "
          f"{count} events equal to the in-process engine's [{card}]",
          flush=True)
    return {"20e bin.serve (its own counts)": served}


def phase20_data_parallel(dev, card, work, model_conf):
    """Path I, data parallelism (A.13): 20a a one-rank NCCL group, 20b
    two ranks spawned on the one card, 20c ``bin.train`` over two
    processes, 20d an engine split over two row blocks, 20e
    ``bin.serve --mesh_devices 1``.  Returns ({sub-path: {kernel record:
    launches}}, {kernel record: [readings]}, the figures)."""
    import tempfile

    t0 = time.perf_counter()
    rows = resident_arrays(TRAIN_B, SEED + 21)
    wall_a, calls_a, launches_a = phase20a_nccl(dev, card, model_conf, rows)
    del rows
    launches = {"20a one-rank NCCL step": launches_a}
    b_launches, readings, figures = phase20b_two_ranks(dev, card, model_conf,
                                                       wall_a)
    launches.update(b_launches)
    figures["one_rank_nccl_all_reduces_per_step"] = calls_a
    with tempfile.TemporaryDirectory() as tmp:
        # 20e's daemon loads and warms up while 20c's processes train
        daemon = path_i_daemon(dev, tmp, work)
        try:
            daemon.start()
            launches.update(phase20c_cli(dev, card, tmp))
            launches.update(phase20d_split_engine(dev, card, work))
            launches.update(phase20e_serve(dev, card, daemon, work))
        finally:
            daemon.close()
    figures["phase_s"] = time.perf_counter() - t0
    if figures["misses"]:
        raise AssertionError(f"20b two ranks vs one process: "
                             f"{figures['misses']}")
    return launches, readings, figures


def path_i_alone(dev, card, kind):
    """``chip_smoke.py --phase 20``: phase 4's flagship checkpoint (its
    ``serving_slice``) and phase 7's model config
    (``flagship_train_conf``), then path I and the last lines."""
    import torch

    from wekws_tpu_torch.ops import cuda_build
    from wekws_tpu_torch.ops.fused_mdtc import (
        fused_mdtc_forward,
        fused_mdtc_stream,
    )

    work = os.path.join(cuda_build.BUILD_DIR, "chip_smoke")
    os.makedirs(work, exist_ok=True)
    with phase("4 (flagship checkpoint only)"):
        serving_slice("flagship", FLAGSHIP_MODEL_CONF,
                      torch.Generator().manual_seed(SEED), dev, work,
                      synth_waves(np.random.default_rng(SEED)),
                      fused_mdtc_forward, fused_mdtc_stream, {})
    conf = flagship_train_conf(dev)[0]
    torch.cuda.empty_cache()
    record = [{"name": n, "launches": 0, "max_abs_err": 0.0} for n in (
        [f"fused_train_{p}" for p in TRAIN_PASSES]
        + ["fused_fbank", "fused_mdtc_forward", "fused_mdtc_stream"])]
    phase20(dev, card, work, conf, record)
    return last_lines(card, record, kind)


def phase20(dev, card, work, model_conf, record):
    """Phase 20, its launches and readings merged into ``record``."""
    with phase("20 path I: data parallelism"):
        launches, readings, figures = phase20_data_parallel(
            dev, card, work, model_conf)
        merge_path_i(record, launches, readings)
        print(f"  launches on path I: {launches} [{card}]", flush=True)
        print(json.dumps({"path_i_figures": figures, "card": card}),
              flush=True)


def last_lines(card, record, kind) -> int:
    """The card's line, the kernels line and the ok line; exit code 0."""
    import torch

    print(card)
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


def merge_path_i(record, launches, readings):
    """Path I's launches (by sub-path) and readings into the kernel
    records; fails if a path-I kernel never launched."""
    rows = {r["name"]: r for r in record}
    totals = {}
    for sub, counts in launches.items():
        for name, n in counts.items():
            if n:
                totals[name] = totals.get(name, 0) + n
                rows[name].setdefault("path_i_launches", {})[sub] = n
    want = {f"fused_train_{p}" for p in TRAIN_PASSES} | {
        "fused_fbank", "fused_mdtc_forward", "fused_mdtc_stream"}
    missing = sorted(want - set(totals))
    if missing:
        raise AssertionError(f"path I launched no {missing}")
    for name, n in totals.items():
        rows[name]["launches"] += n
    for name, rs in readings.items():
        rows[name]["path_i"] = rs
        rows[name]["max_abs_err"] = max(
            [rows[name]["max_abs_err"]] + [r["max_abs_err"] for r in rs])


# ---------------------------------------------------------------------------
# phase 21, path J: the training knobs (ROADMAP A.15)
# ---------------------------------------------------------------------------

PEAK_BF16_FLOPS = 989e12  # tensor cores, dense
# 21a: the main path's shape at each of the flagship's dilations, and
# C = 32 and 128 at a smaller batch
PATH_J_CASES = ([(TRAIN_B, 198, 64, d) for d in (1, 2, 4, 8)]
                + [(64, 198, 32, 8), (64, 198, 128, 8)])
PATH_J_STEPS = 3
PATH_J_DATASET = dict(TRAIN_DATASET_CONF, spec_aug=False, fbank_conf=dict(
    TRAIN_DATASET_CONF["fbank_conf"], dither=0.0))
# Step-0 gradients of the flagship at bf16, each group's worst share of
# its own largest |grad| (``group_share``), the mean over the groups of
# that share, and the least cosine of a settled parameter's gradient
# with its reference: the two bf16 routes against each other, each
# against the float32 fused step and against float64.  A gradient that
# BN follows is a sum whose terms cancel, and rounding its terms to bf16
# leaves noise of the sum's own size (the depthwise kernels' worst).
# On the H100 at B=512 the sound routes read worst shares up to 0.41 and
# means up to 0.23, so the bounds are about twice that; the cosine bound
# sits at twice the sound routes' 1 - cosine (least 0.879).  A dropped
# or swapped gradient reads a cosine near 0 (21b plants both).
BF16_ROUTES_TOL = BF16_VS_F32_TOL = BF16_GRAD64_TOL = 0.8
BF16_MEAN_TOL = 0.45
BF16_COS_TOL = 0.75
# remat against no remat: the same operations recomputed, float32
# round-off at most (each group's share, the losses relative)
REMAT_TOL = 1e-5
GHOST_GROUPS = 4
# 21d: the ghost-BN running statistics against the formula in float64
# on the same BN inputs (the mean against the largest standard
# deviation, the variance against its largest)
GHOST_STAT_TOL = 1e-5


def bf16_pass_bound_ms(name, b, t, c, k):
    """Least time on an H100 for one bf16 variant (F2, F3, B2 or B3):
    ``train_pass_bound_ms``'s count with r moved as bf16 (F3 writes it,
    B2 and B3 read it: half the bytes) and the C x C products at the
    bf16 tensor-core peak, the elementwise work at the fp32 peak.  At
    the main shape all four are bound by bytes."""
    n = b * t
    act = 4 * n * c
    w = 4 * c * c
    elementwise = {"f2": c * (2 * k + 2) + 4 * c,
                   "f3": c * (2 * k + 2) + 11 * c,
                   "b2": 20 * c, "b3": c * (2 * k + 30)}[name]
    products = {"f2": 2, "f3": 4, "b2": 4, "b3": 8}[name] * c * c
    nbytes = {"f2": act + w, "f3": 2.5 * act + 2 * w,
              "b2": 3.5 * act + 2 * w, "b3": 4.5 * act + 3 * w}[name]
    t_ops = (n * elementwise / PEAK_FP32_FLOPS
             + n * products / PEAK_BF16_FLOPS) * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def bf16_readings(got, want):
    """(the sums' largest error over their group's largest |value|, at
    least 1, as ``compare_sums`` scales it; the largest ``off_share`` of
    a (B, T, C) output) of a pass's outputs against its plain
    version's."""
    from wekws_tpu_torch.ops.fused_mdtc_train import off_share

    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    sums = [(float((a.float() - b.float()).abs().max()), float(b.abs().max()))
            for a, b in zip(got, want) if b.dim() != 3]
    sum_share = (max(e for e, _ in sums) / max([m for _, m in sums] + [1.0])
                 if sums else 0.0)
    return sum_share, max([off_share(a, b) for a, b in zip(got, want)
                           if b.dim() == 3] + [0.0])


def phase21a_variants(dev, card, gen):
    """21a: the bf16 variants of F2, F3, B2 and B3 against their bf16
    plain versions on identical inputs (``compare_pass`` at bf16), each
    launched twice (bitwise equal), at PATH_J_CASES, with the control
    that shows the check can fail: the plain version with float32
    operands on the same inputs must fail ``compare_pass`` at bf16 (F2
    and B2 by their sums, F3 and B3 by their off share too).  At the main
    shape (dilation 8) each variant's time per call (CUDA events, median
    of 30), its device time with its reduction (profiler), the plain
    version's, the float32 kernel's on the float32 inputs of the same
    block, and the bound.  Returns {pass: reading}."""
    import torch

    from wekws_tpu_torch.ops.fused_mdtc_train import (
        BF16_PASSES,
        BF16_SUM_TOL,
        PASS_IDS,
        PASSES,
        compare_pass,
        kernel_name,
        seeded_block_inputs,
        trace_pass_inputs,
    )

    errs = dict.fromkeys(BF16_PASSES, 0.0)
    shares = dict.fromkeys(BF16_PASSES, 0.0)
    # the variants' largest (sum share, off share), the controls' least
    seen = {n: [0.0, 0.0] for n in BF16_PASSES}
    control = {n: [np.inf, np.inf] for n in BF16_PASSES}
    k, main = 5, None
    for b, t, c, d in PATH_J_CASES:
        p, x, dy = seeded_block_inputs(gen, b, t, c, k, dev)
        calls = trace_pass_inputs(x, p, dy, d, precision="bfloat16")
        for name in BF16_PASSES:
            args = calls[name]
            got = PASSES[name](*args)
            again = PASSES[name](*args)
            torch.cuda.synchronize()
            want = PASSES[name].plain(*args)
            tag = f"21a {name} bf16 B={b} T={t} C={c} d={d}"
            errs[name] = max(errs[name], compare_pass(
                tag, got, want, "bfloat16", BF16_SUM_TOL[name]))
            shares[name] = max(shares[name], pass_rel_err(got, want))
            seen[name] = [max(u, v) for u, v in
                          zip(seen[name], bf16_readings(got, want))]
            unrounded = PASSES[name].plain(*args[:-1], "float32")
            unrounded = tuple(
                u.to(w.dtype) for u, w in zip(
                    unrounded if isinstance(unrounded, tuple)
                    else (unrounded,),
                    want if isinstance(want, tuple) else (want,)))
            control[name] = [min(u, v) for u, v in zip(
                control[name], bf16_readings(unrounded, want))]
            try:
                compare_pass(f"{tag} control", unrounded, want, "bfloat16",
                             BF16_SUM_TOL[name])
            except AssertionError:
                pass
            else:
                raise AssertionError(f"{tag}: the plain version with float32 "
                                     f"operands passes the bf16 check")
            got = got if isinstance(got, tuple) else (got,)
            again = again if isinstance(again, tuple) else (again,)
            if not all(torch.equal(u, v) for u, v in zip(got, again)):
                raise AssertionError(f"21a {name} bf16: two launches differ")
        if (b, c, d) == (TRAIN_B, 64, 8):
            main = calls, trace_pass_inputs(x, p, dy, d)
        print(f"  bf16 variants B={b} T={t} C={c} d={d}: "
              + ", ".join(f"{n} {errs[n]:.2e} ({shares[n]:.1e} of its "
                          f"scale; sums {seen[n][0]:.1e}, off share "
                          f"{seen[n][1]:.1e})" for n in BF16_PASSES)
              + " (running max; bitwise reproducible); the float32-operand "
              "control, running min: "
              + ", ".join(f"{n} sums {control[n][0]:.1e}, off share "
                          f"{control[n][1]:.1e}" for n in BF16_PASSES)
              + " (each fails the check)", flush=True)

    calls, f32_calls = main
    b, t, c = TRAIN_B, 198, 64
    readings = {}
    for name in BF16_PASSES:
        def kern(args=calls[name], fn=PASSES[name]):
            return fn(*args)

        def plain(args=calls[name], fn=PASSES[name].plain):
            return fn(*args)

        ms, plain_ms = kernel_vs_plain_ms(kern, plain)
        f32_ms = cuda_time_ms(lambda a=f32_calls[name], fn=PASSES[name]:
                              fn(*a))
        kname = kernel_name(name, c, "bfloat16")
        red = f"reduce_kernel<{PASS_IDS[name]}>"
        _, _, found = profiled_step(lambda: [kern() for _ in range(20)],
                                    (kname, red))
        device_ms = (None if found[kname] is None or found[red] is None
                     else found[kname] + found[red])
        bound, bound_by = bf16_pass_bound_ms(name, b, t, c, k)
        dev_txt = ("not measured" if device_ms is None
                   else f"{device_ms:.4f} ms with its reduction")
        print(f"  fused_train_{name}_bf16 ({kname}) B={b} T={t} d=8: kernel "
              f"{ms:.4f} ms per call (device {dev_txt}), plain "
              f"{plain_ms:.4f} ms, the float32 kernel {f32_ms:.4f} ms on the "
              f"same block's float32 inputs, bound {bound:.5f} ms "
              f"({bound_by}); library: none [{card}]", flush=True)
        readings[name] = {"ms": ms, "plain_ms": plain_ms,
                          "device_ms": device_ms, "f32_ms": f32_ms,
                          "bound_ms": bound, "bound_by": bound_by,
                          "max_abs_err": errs[name],
                          "max_rel_err": shares[name],
                          "sum_share": seen[name][0],
                          "off_share": seen[name][1],
                          "control_sum_share": control[name][0],
                          "control_off_share": control[name][1]}
    return readings


def path_j_counts():
    """{record name: launches} of the training passes (float32 kernels
    and bf16 variants apart), ``fused_fbank`` and ``fused_fsmn_layers``."""
    from wekws_tpu_torch.ops.fused_frontend import fused_fbank
    from wekws_tpu_torch.ops.fused_fsmn import fused_fsmn_layers
    from wekws_tpu_torch.ops.fused_mdtc_train import BF16_PASSES, PASSES

    counts = {f"fused_train_{n}": PASSES[n].launches for n in TRAIN_PASSES}
    counts.update({f"fused_train_{n}_bf16": PASSES[n].bf16_launches
                   for n in BF16_PASSES})
    counts["fused_fbank"] = fused_fbank.launches
    counts["fused_fsmn_layers"] = fused_fsmn_layers.launches
    return counts


def zero_path_j_counts():
    from wekws_tpu_torch.ops.fused_frontend import fused_fbank
    from wekws_tpu_torch.ops.fused_fsmn import fused_fsmn_layers
    from wekws_tpu_torch.ops.fused_mdtc_train import reset_launches

    reset_launches()
    fused_fbank.launches = 0
    fused_fsmn_layers.launches = 0


def grads_of(model):
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def path_j_trainer(conf, state_dict, cvp, dev, dataset_conf=PATH_J_DATASET,
                   criterion="max_pooling"):
    """The port's Trainer for ``conf`` holding ``state_dict``."""
    from wekws_tpu_torch.data import DeviceFeaturePipeline
    from wekws_tpu_torch.models import init_model
    from wekws_tpu_torch.train import Trainer

    model = init_model(conf)
    model.load_state_dict(state_dict)
    return Trainer(model, DeviceFeaturePipeline.from_conf(dataset_conf), cvp,
                   criterion, grad_clip=5.0,
                   min_duration=5 if criterion == "max_pooling" else 0,
                   device=dev)


def step_figures(tag, trainer, state, batch, card, where):
    """A route's step: host-clock median of 10 (``timed_steps``), this
    thread's CPU time a step (``host_cpu_ms``), the two idle bounds of
    one traced step (``traced_idle``, ``idle_share``) and the peak of
    device memory over one step."""
    import torch

    def step():
        trainer.train_step(state, batch, SEED, 1e-3)

    reading = traced_idle(step)
    cpu_ms = host_cpu_ms(step)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    idle = idle_share(tag, reading, card, where)
    audio = batch["waves"].shape[0] * batch["waves"].shape[1] / RATE
    print(f"  {tag}: step {reading['untraced_ms']:.3f} ms (median of 10), "
          f"{audio / reading['untraced_ms'] * 1e3:.1f} audio-s/s, this "
          f"thread's CPU {cpu_ms:.3f} ms a step, peak device memory "
          f"{peak:.1f} MiB [{card}]", flush=True)
    return dict(reading, thread_cpu_ms=cpu_ms, peak_mib=peak, **idle)


def phase21b_flagship(dev, card, where):
    """21b: the flagship B=512 x 2 s at bench.py's JAX default (``dtype:
    bfloat16``, ``bn_dtype: bfloat16``) by the module route and with
    ``fused_train``, beside the float32 fused step, from one seeded
    state: three steps each (losses finite, parameters and gradients
    float32, no plain version on a CUDA tensor); the launches of the
    bf16 fused route's three steps (17 of each pass a step, the bf16
    variants for F2, F3, B2, B3 and none of their float32 kernels; the
    module route none); step-0 gradients against float64 and the routes
    against each other, and two planted faults that must fail that
    check; each route's step figures.  Returns (its
    launches, figures, what 21c and 21d reuse)."""
    import torch

    from wekws_tpu_torch.models import init_model
    from wekws_tpu_torch.ops.fused_mdtc_train import BF16_PASSES

    conf, batch, cvp, _, _ = flagship_train_conf(dev)
    f32_unfused = dict(conf, backbone=dict(conf["backbone"],
                                           fused_train=False))
    bf16 = dict(conf, dtype="bfloat16", backbone=dict(
        conf["backbone"], bn_dtype="bfloat16"))
    routes = {"float32 fused": conf,
              "bf16 module": dict(bf16, backbone=dict(bf16["backbone"],
                                                      fused_train=False)),
              "bf16 fused": bf16}
    model = init_model(conf, torch.Generator().manual_seed(SEED))
    with torch.no_grad():  # phase 7's start: a head off the sigmoid's tails
        model.classifier.linear.weight.mul_(0.01)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    n_blocks = 1 + 4 * 4
    trainers, states, grads0, losses, launches = {}, {}, {}, {}, {}
    for route, rconf in routes.items():
        trainer = path_j_trainer(rconf, start, cvp, dev)
        state = trainer.init_state()
        zero_path_j_counts()
        with PlainOnCuda() as plain:
            losses[route] = []
            for step in range(PATH_J_STEPS):
                state, metrics = trainer.train_step(state, batch, SEED, 1e-3)
                losses[route].append(float(metrics["loss"]))
                if step == 0:
                    grads0[route] = grads_of(state.model)
            torch.cuda.synchronize()
        plain.check(f"21b {route}")
        counts = path_j_counts()
        launches[route] = {k: v for k, v in counts.items() if v}
        want = {}
        if route != "bf16 module":
            bf = route == "bf16 fused"
            for name in TRAIN_PASSES:
                key = (f"fused_train_{name}_bf16" if bf and name in BF16_PASSES
                       else f"fused_train_{name}")
                want[key] = n_blocks * PATH_J_STEPS
        if launches[route] != want:
            raise AssertionError(f"21b {route}: launches {launches[route]}, "
                                 f"expected {want}")
        if not np.isfinite(losses[route]).all():
            raise AssertionError(f"21b {route}: losses {losses[route]}")
        if not all(p.dtype == torch.float32 and g.dtype == torch.float32
                   for p, g in zip(state.model.parameters(),
                                   grads0[route].values())):
            raise AssertionError(f"21b {route}: a parameter or gradient is "
                                 f"not float32")
        trainers[route], states[route] = trainer, state
    print(f"  flagship B={TRAIN_B} x {TRAIN_SECONDS} s, {PATH_J_STEPS} "
          f"steps each from one seeded state: losses "
          + "; ".join(f"{r} {[round(v, 5) for v in ls]}"
                      for r, ls in losses.items())
          + f"; launches of the bf16 fused route {launches['bf16 fused']}, "
          f"of the bf16 module route none; no plain version on a CUDA "
          f"tensor [{card}]", flush=True)

    # step 0 against float64 (the float32 unfused model on the same
    # features) and the routes against each other
    with torch.no_grad():
        f0, l0 = trainers["float32 fused"].pipeline(
            torch.as_tensor(batch["waves"], device=dev),
            torch.as_tensor(batch["wave_lengths"], device=dev))
    ref = float64_grads(f32_unfused, start, f0, l0, batch)
    ref64 = {n: p.grad for n, p in ref.named_parameters()}
    probe = trainers["bf16 fused"].model

    def held(key, got, want, tol):
        found = group_share(probe, got, want, tol, key)
        if "bf16" in key and not (found[1] <= BF16_MEAN_TOL
                                  and found[2][0] >= BF16_COS_TOL):
            raise AssertionError(
                f"21b step-0 gradients {key}: mean share {found[1]:.3f} "
                f"(bound {BF16_MEAN_TOL}), least cosine {found[2][0]:.4f} "
                f"at {found[2][1]}.{found[2][2]} (bound {BF16_COS_TOL})")
        return found

    shares = {}
    for route in routes:
        tol = GRAD64_TOL if route.startswith("float32") else BF16_GRAD64_TOL
        shares[f"{route} vs float64"] = held(
            f"{route} vs float64", grads0[route], ref64, tol)
    shares["bf16 module vs bf16 fused"] = held(
        "bf16 module vs bf16 fused", grads0["bf16 module"],
        grads0["bf16 fused"], BF16_ROUTES_TOL)
    for route in ("bf16 module", "bf16 fused"):
        shares[f"{route} vs float32 fused"] = held(
            f"{route} vs float32 fused", grads0[route],
            grads0["float32 fused"], BF16_VS_F32_TOL)
    print("  step-0 gradients, each group's worst share of its own largest "
          "|grad| (bounds: float32 vs float64 "
          f"{GRAD64_TOL}, bf16 vs float64 {BF16_GRAD64_TOL}, bf16 routes "
          f"{BF16_ROUTES_TOL}, bf16 vs float32 {BF16_VS_F32_TOL}; the bf16 "
          f"means {BF16_MEAN_TOL}, their least cosines {BF16_COS_TOL}): "
          + "; ".join(f"{k} {share_text(v)}" for k, v in shares.items())
          + f"; step-0 losses {[losses[r][0] for r in routes]} [{card}]",
          flush=True)
    # the check's control: the bf16 fused route's gradients with one
    # block's depthwise kernel gradient dropped, and with its two
    # pointwise weights' gradients swapped, must fail against float64
    block = [g for g, m in grad_groups(probe).items() if len(m) > 1][8]
    planted = {}
    for fault, (a, b) in (("dropped", ("conv1.conv.weight", None)),
                          ("swapped", ("conv1.pointwise.weight",
                                       "conv2.weight"))):
        bad = dict(grads0["bf16 fused"])
        a = f"{block}.{a}"
        if b is None:
            bad[a] = torch.zeros_like(bad[a])
        else:
            b = f"{block}.{b}"
            bad[a], bad[b] = bad[b], bad[a]
        try:
            held(f"bf16 fused vs float64, {fault} {a}", bad, ref64,
                 BF16_GRAD64_TOL)
        except AssertionError as err:
            planted[fault] = str(err)
        else:
            raise AssertionError(f"21b: the bf16 fused gradients with "
                                 f"{a} {fault} pass the check")
    print("  step-0 gradients, planted faults, each failing the check: "
          + "; ".join(f"{k}: {v}" for k, v in planted.items()) + f" [{card}]",
          flush=True)
    del ref, ref64
    figures = {"losses": losses, "launches": launches,
               "grad_shares": {k: v[0][0] for k, v in shares.items()},
               "grad_mean_shares": {k: v[1] for k, v in shares.items()},
               "grad_least_cosines": {k: v[2][0] for k, v in shares.items()},
               "planted_faults": planted}
    for route in routes:
        figures[route] = step_figures(f"21b {route} step", trainers[route],
                                      states[route], batch, card, where)
    del trainers, states
    torch.cuda.empty_cache()
    return launches["bf16 fused"], figures, (routes, start, batch, cvp)


def phase21c_remat(dev, card, routes, start, batch, cvp):
    """21c: ``remat: true`` against ``remat: false`` at the bf16 config
    by both routes, one step each from the same state: the loss and
    every gradient within REMAT_TOL (each group's share), the running
    statistics within REMAT_TOL of their scale and
    ``num_batches_tracked`` equal (1: no double update); under remat the
    fused route runs its forward passes twice (the recomputation), its
    backward passes once; the peak device memory of each."""
    import torch

    from wekws_tpu_torch.ops.fused_mdtc_train import BF16_PASSES

    out = {}
    for route in ("bf16 module", "bf16 fused"):
        models, peaks, losses, grads, counts = {}, {}, {}, {}, {}
        for remat in (False, True):
            rconf = routes[route]
            rconf = dict(rconf, backbone=dict(rconf["backbone"], remat=remat))
            trainer = path_j_trainer(rconf, start, cvp, dev)
            state = trainer.init_state()
            zero_path_j_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            state, metrics = trainer.train_step(state, batch, SEED, 1e-3)
            torch.cuda.synchronize()
            peaks[remat] = torch.cuda.max_memory_allocated() / 2 ** 20
            losses[remat] = float(metrics["loss"])
            grads[remat] = grads_of(state.model)
            counts[remat] = {k: v for k, v in path_j_counts().items() if v}
            models[remat] = state.model
        share = group_share(models[False], grads[True], grads[False],
                            REMAT_TOL, f"21c {route} remat vs not")
        bitwise = all(torch.equal(grads[True][n], grads[False][n])
                      for n in grads[False])
        if abs(losses[True] - losses[False]) > REMAT_TOL * abs(losses[False]):
            raise AssertionError(f"21c {route}: losses {losses}")
        for (name, a), b in zip(models[False].named_buffers(),
                                models[True].buffers()):
            if name.endswith("num_batches_tracked"):
                if int(a) != 1 or int(b) != 1:
                    raise AssertionError(f"21c {route} {name}: {int(a)}, "
                                         f"{int(b)}")
            elif float((a - b).abs().max()) > REMAT_TOL * max(
                    float(a.abs().max()), 1.0):
                raise AssertionError(f"21c {route} {name} differs")
        if route == "bf16 fused":
            twice = {f"fused_train_{n}{'_bf16' if n in BF16_PASSES else ''}":
                     17 * (2 if n.startswith("f") else 1)
                     for n in TRAIN_PASSES}
            if counts[True] != twice:
                raise AssertionError(f"21c remat launches {counts[True]}, "
                                     f"expected {twice}")
        elif counts[True] or counts[False]:
            raise AssertionError(f"21c {route} launched {counts}")
        print(f"  21c {route}: remat vs not, one step: losses "
              f"{losses[False]:.6f} and {losses[True]:.6f}, gradients worst "
              f"{share_text(share)} of a group's scale "
              f"({'bitwise equal' if bitwise else 'not bitwise'}), running "
              f"statistics equal within {REMAT_TOL}, num_batches_tracked 1; "
              f"peak device memory {peaks[False]:.1f} MiB without remat, "
              f"{peaks[True]:.1f} MiB with; launches under remat "
              f"{counts[True] or 'none'} [{card}]", flush=True)
        out[route] = {"peak_mib": peaks[False], "remat_peak_mib": peaks[True],
                      "grad_share": share[0][0], "bitwise": bitwise}
        del models, grads
        torch.cuda.empty_cache()
    return out


def phase21d_ghost(dev, card, routes, start, batch, cvp):
    """21d: ``ghost_bn: 4`` on the flagship at the bf16 config with
    ``fused_train`` (which ghost BN bypasses): one step, no F/B pass
    launched; every BatchNorm's running statistics against the ghost-BN
    formula in float64 on its own input in that step (groups of 128 rows:
    the group-averaged mean and two-pass variance, momentum 0.9), within
    GHOST_STAT_TOL."""
    import torch

    from wekws_tpu_torch.models.layers import GhostBatchNorm

    conf = routes["bf16 fused"]
    conf = dict(conf, backbone=dict(conf["backbone"], ghost_bn=GHOST_GROUPS))
    trainer = path_j_trainer(conf, start, cvp, dev)
    state = trainer.init_state()
    bns = [m for m in state.model.modules() if isinstance(m, GhostBatchNorm)]
    if len(bns) != 3 * 17:
        raise AssertionError(f"21d: {len(bns)} GhostBatchNorms")
    before = {id(m): (m.running_mean.clone(), m.running_var.clone())
              for m in bns}
    inputs = {}
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: inputs.setdefault(id(mod), args[0].detach()))
        for m in bns]
    zero_path_j_counts()
    state, metrics = trainer.train_step(state, batch, SEED, 1e-3)
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    counts = {k: v for k, v in path_j_counts().items() if v}
    if counts:
        raise AssertionError(f"21d ghost_bn launched {counts}")
    worst = 0.0
    for m in bns:
        x = inputs[id(m)]
        x = (x.to(m.out_dtype) if m.out_dtype is not None else x).double()
        xg = x.reshape(GHOST_GROUPS, -1, x.shape[-1])
        gm = xg.mean(dim=1)
        gv = ((xg - gm[:, None]) ** 2).mean(dim=1)
        mean0, var0 = before[id(m)]
        want_mean = 0.9 * mean0.double() + 0.1 * gm.mean(dim=0)
        want_var = 0.9 * var0.double() + 0.1 * gv.mean(dim=0)
        std = float(want_var.sqrt().max())
        err = max(float((m.running_mean.double() - want_mean).abs().max())
                  / std,
                  float((m.running_var.double() - want_var).abs().max())
                  / float(want_var.abs().max()))
        if not err <= GHOST_STAT_TOL:
            raise AssertionError(f"21d: running statistics {err:.2e} off "
                                 f"the ghost-BN formula")
        worst = max(worst, err)
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"21d loss {loss}")
    print(f"  21d ghost_bn {GHOST_GROUPS} (fused_train set, bypassed): one "
          f"step, loss {loss:.6f}, no F/B pass or other kernel launched; "
          f"{len(bns)} GhostBatchNorms' running statistics within "
          f"{worst:.1e} of the formula in float64 on their inputs (bound "
          f"{GHOST_STAT_TOL}) [{card}]", flush=True)
    return {"loss": loss, "stat_share": worst}


def phase21e_fsmn_ctc(dev, card, tmp, where):
    """21e: the FSMN-CTC at bench.py's CTC width (400 in, 140, 4 x
    250/128, 2599 tokens) at ``dtype: bfloat16``, B=256 x 2 s: three
    steps (finite, parameters and gradients float32), figures as 21b's
    beside the float32 step's; then ``bin.train`` one epoch of
    examples/synthetic_ctc with its own conf/fsmn_ctc.yaml (bf16), and
    ``bin.score_ctc`` of that checkpoint through ``fused_fsmn_kernel``
    (one launch a batch).  Returns (launches, figures)."""
    import torch

    from wekws_tpu_torch.bin import score_ctc, train
    from wekws_tpu_torch.bin.common import load_test_setup
    from wekws_tpu_torch.data import init_dataset
    from wekws_tpu_torch.models import init_model
    from wekws_tpu_torch.ops.fused_fsmn import fused_fsmn_layers
    from wekws_tpu_torch.text import CharTokenizer

    batch, cvp, _, _, conf = ctc_setup(dev)
    dconf = dict(CTC_DATASET_CONF, spec_aug=False, fbank_conf=dict(
        CTC_DATASET_CONF["fbank_conf"], dither=0.0))
    start = init_model(conf, torch.Generator().manual_seed(SEED)).state_dict()
    figures = {}
    for route, rconf in (("float32", conf),
                         ("bf16", dict(conf, dtype="bfloat16"))):
        trainer = path_j_trainer(rconf, start, cvp, dev, dconf, "ctc")
        state = trainer.init_state()
        losses = []
        with PlainOnCuda() as plain:
            for _ in range(PATH_J_STEPS):
                state, metrics = trainer.train_step(state, batch, SEED, 1e-3)
                losses.append(float(metrics["loss"]))
            torch.cuda.synchronize()
        plain.check(f"21e FSMN-CTC {route}")
        if not np.isfinite(losses).all() or not all(
                p.dtype == p.grad.dtype == torch.float32
                for p in state.model.parameters()):
            raise AssertionError(f"21e {route}: losses {losses}")
        print(f"  21e FSMN-CTC {route}, B={CTC_TRAIN_B} x {CTC_SECONDS} s: "
              f"losses {[round(v, 4) for v in losses]}, parameters and "
              f"gradients float32 [{card}]", flush=True)
        figures[route] = dict(step_figures(
            f"21e FSMN-CTC {route} step", trainer, state, batch, card,
            where), losses=losses)
        del trainer, state

    data = corpus("ctc")
    exp = os.path.join(tmp, "exp")
    config = os.path.join(CTC_RECIPE, "conf", "fsmn_ctc.yaml")
    t0 = time.perf_counter()
    with TimeLimit(RECIPE_TIMEOUT_S, "21e bin.train"):
        run_cli(train.main, [
            "--config", config, "--train_data",
            os.path.join(data, "train.list"), "--cv_data",
            os.path.join(data, "dev.list"), "--model_dir", exp, "--dict",
            os.path.join(CTC_RECIPE, "dict"), "--seed", "888",
            "--cmvn_file", os.path.join(CTC_RECIPE, "data", "global_cmvn"),
            "--norm_var", "--num_epochs", "1", "--num_workers",
            str(RECIPE_WORKERS), "--device", dev.type], "21e bin.train")
    train_s = time.perf_counter() - t0
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        record = json.loads(f.readline())
    import yaml

    with open(os.path.join(exp, "config.yaml")) as f:
        if yaml.safe_load(f)["model"].get("dtype") != "bfloat16":
            raise AssertionError("21e: bin.train did not train at bf16")
    if not np.isfinite(record["train_loss"]):
        raise AssertionError(f"21e bin.train: {record}")
    ckpt = os.path.join(exp, "0.pt")
    test_list = os.path.join(data, "test.list")
    dict_dir = os.path.join(CTC_RECIPE, "dict")
    tokenizer = CharTokenizer(os.path.join(dict_dir, "dict.txt"),
                              unk="<filler>", split_with_space=True)
    _, _, _, test_conf = load_test_setup(os.path.join(exp, "config.yaml"),
                                         ckpt, 256, dev)
    n_batches = len(list(init_dataset(test_list, test_conf, tokenizer,
                                      split="test")))
    fused_fsmn_layers.launches = 0
    n = run_cli(score_ctc.main, [
        "--config", os.path.join(exp, "config.yaml"), "--test_data",
        test_list, "--checkpoint", ckpt, "--dict", dict_dir, "--keywords",
        CTC_RECIPE_KEYWORD, "--device", dev.type, "--score_file",
        os.path.join(exp, "score.txt")], "21e bin.score_ctc")
    launches = fused_fsmn_layers.launches
    if launches != n_batches:
        raise AssertionError(f"21e bin.score_ctc launched fused_fsmn_layers "
                             f"{launches} times for {n_batches} batches")
    print(f"  21e examples/synthetic_ctc, conf/fsmn_ctc.yaml (bf16): "
          f"bin.train 1 epoch of {record['batches']} steps, train loss "
          f"{record['train_loss']:.4f}, {train_s:.1f} s wall, "
          f"{record['audio_seconds_per_s']:.1f} audio-s/s; bin.score_ctc "
          f"of 0.pt: {n} utterances, fused_fsmn_layers launched {launches} "
          f"times (one a batch) [{card}]", flush=True)
    figures["recipe"] = {"train_loss": record["train_loss"],
                         "train_s": train_s,
                         "audio_s_per_s": record["audio_seconds_per_s"],
                         "score_launches": launches}
    return {"fused_fsmn_layers": launches}, figures


def path_j(dev, card, where="in this process"):
    """Phase 21, path J: 21a-21e.  Returns the four variants' kernel
    records, the launches by sub-path and the figures."""
    import tempfile

    import torch

    from wekws_tpu_torch.ops.fused_mdtc_train import BF16_PASSES

    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED + 21)
    readings = phase21a_variants(dev, card, gen)
    torch.cuda.empty_cache()
    b_launches, figures, reuse = phase21b_flagship(dev, card, where)
    figures["remat"] = phase21c_remat(dev, card, *reuse)
    figures["ghost_bn"] = phase21d_ghost(dev, card, *reuse)
    del reuse
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        e_launches, figures["fsmn_ctc"] = phase21e_fsmn_ctc(dev, card, tmp,
                                                           where)
    figures["phase_s"] = time.perf_counter() - t0
    record = [dict({
        "name": f"fused_train_{n}_bf16", "route": "cuda",
        "source": "wekws_tpu_torch/csrc/fused_mdtc_train.cu",
        "replaces": TRAIN_REPLACES[n],
        "launches": b_launches[f"fused_train_{n}_bf16"],
        "library_ms": None}, **readings[n]) for n in BF16_PASSES]
    launches = {"21b flagship bf16 fused, 3 steps": b_launches,
                "21e bin.score_ctc": e_launches}
    return record, launches, figures


def path_j_child(device="cuda"):
    """``path_j`` in a fresh process (the full run's phase 21: late in
    the long process the profiler loses records); its progress lines,
    then one line ``PATH_J {...}``."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    record, launches, figures = path_j(dev, card_line(),
                                       "in a fresh process")
    print("PATH_J " + json.dumps({"record": record, "launches": launches,
                                  "figures": figures}), flush=True)


def merge_path_j(record, path_j_record, launches):
    """Path J's four variant records into the kernel records, and its
    launches of the other kernels (by sub-path) into theirs."""
    rows = {r["name"]: r for r in record}
    for sub, counts in launches.items():
        for name, n in counts.items():
            if n and name in rows:
                rows[name]["launches"] += n
                rows[name].setdefault("path_j_launches", {})[sub] = n
    record.extend(path_j_record)


def phase21(dev, card, record):
    """Phase 21 in a fresh process, merged into ``record``."""
    import torch

    with phase("21 path J: the training knobs (bf16, bn_dtype, remat, "
               "ghost BN)"):
        torch.cuda.empty_cache()
        found = run_child("path_j_child", [], "PATH_J", 900)
        merge_path_j(record, found["record"], found["launches"])
        print(f"  launches on path J: {found['launches']} [{card}]",
              flush=True)
        print(json.dumps({"path_j_figures": found["figures"], "card": card}),
              flush=True)


def path_j_alone(dev, card, kind):
    """``chip_smoke.py --phase 21``: path J in this process, then the
    last lines (the four variants' records, and the launches path J gave
    the float32 passes' and the FSMN kernel's)."""
    with phase("21 path J: the training knobs (bf16, bn_dtype, remat, "
               "ghost BN)"):
        path_j_record, launches, figures = path_j(dev, card)
        record = [{"name": n, "launches": 0, "max_abs_err": 0.0} for n in (
            [f"fused_train_{p}" for p in TRAIN_PASSES]
            + ["fused_fsmn_layers"])]
        merge_path_j(record, path_j_record, launches)
        print(f"  launches on path J: {launches} [{card}]", flush=True)
        print(json.dumps({"path_j_figures": figures, "card": card}),
              flush=True)
    return last_lines(card, record, kind)



# ---------------------------------------------------------------------------
# phase 22, path K: the last entry points (ROADMAP A.18's exported step,
# A.6's DET plots, examples/synthetic_scale through the port)
# ---------------------------------------------------------------------------

PATH_K_CHUNK = 32  # bin.export_model's --chunk_frames, the JAX CLI's default
SCALE_RECIPE = os.path.join("examples", "synthetic_scale")
# 22b's cuts of the scale corpora (6 s utterances; full: 20,000 train,
# 2,000 dev, 8,000 test): 512 train rows, one B=512 step an epoch, 64
# dev and 256 test (one bin.score batch); the CTC corpus (full: 20,000,
# 2,000, 33,000) 512 / 128 / 512, two B=256 steps an epoch and two
# bin.score_ctc batches; 1 epoch each (full: 30 and 80; 2 before path L
# was added, cut for its time)
SCALE_CUT = ("--train_kw", "128", "--train_filler", "384", "--dev_kw", "16",
             "--dev_filler", "48", "--test_kw", "64", "--test_filler", "192")
SCALE_CTC_CUT = ("--train", "512", "--dev", "128", "--test", "512")
SCALE_EPOCHS = 1
SCALE_TIMEOUT_S = 600
# 22b's two recipes: (script, config, generator cut, experiment, last
# stage before the plot).  The CTC recipe's stage 4 is the serving SLOs
# (bench_serving_slo at its defaults), which path M reads
SCALE_RUNS = (
    ("run_torch.sh", "conf_torch/mdtc_cut.yaml", SCALE_CUT,
     "exp/torch_mdtc_cut", 4),
    ("run_ctc_torch.sh", "conf/fsmn_ctc_cut.yaml", SCALE_CTC_CUT,
     "exp/torch_fsmn_ctc_cut", 4),
)
# stages 0-1 (the corpus and CMVN: the CPU alone) run beside the kernel
# build (``PathKHead``), the rest in path K
SCALE_HEAD_STAGES = 1


class RecipeHead:
    """Recipe stages started before the kernel build, so that they run on
    the cores nvcc leaves idle, each job with its tap (``start``);
    ``finish()`` waits for them and returns their state as JSON
    (``state()``, and under "runs" each job's cwd, tap, exit code and
    output); ``close()`` stops what still runs."""

    tag, timeout_s = "", SCALE_TIMEOUT_S

    def start(self, key, argv, cwd, tap):
        repo = os.path.abspath(os.path.dirname(__file__) or ".")
        out = open(os.path.join(tap, "head_stdout.txt"), "w+")
        err = open(os.path.join(tap, "head_stderr.txt"), "w+")
        env = dict(os.environ, PYTHONPATH=os.pathsep.join([tap, repo]),
                   PATH_K_TAP_DIR=tap)
        proc = subprocess.Popen(argv, cwd=cwd, env=env, stdout=out,
                                stderr=err, text=True,
                                start_new_session=True)
        self.jobs.append((key, cwd, tap, proc, out, err))

    def state(self):
        return {}

    def finish(self):
        state = dict(self.state(), runs={})
        for key, cwd, tap, proc, out, err in self.jobs:
            try:
                proc.wait(self.timeout_s)
            except subprocess.TimeoutExpired:
                raise TimeoutError(f"{self.tag} {key}'s first stages: over "
                                   f"{self.timeout_s} s")
            out.seek(0)
            err.seek(0)
            state["runs"][key] = {"cwd": cwd, "tap": tap,
                                  "code": proc.returncode,
                                  "stdout": out.read(), "stderr": err.read()}
        self.close()
        return state

    def close(self):
        import signal

        for *_, proc, out, err in self.jobs:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
            out.close()
            err.close()
        self.jobs = []


class PathKHead(RecipeHead):
    """22b's stages 0 to SCALE_HEAD_STAGES of the scale recipes ``runs``
    (both, or the CTC one alone for ``--phase 24``).  The recipe copy and
    the taps sit in ``work``/path_k, where paths K and M (fresh
    processes) find them."""

    tag = "22b"

    def __init__(self, work, runs=SCALE_RUNS):
        import shutil

        root = os.path.join(work, "path_k")
        shutil.rmtree(root, ignore_errors=True)
        os.makedirs(root)
        self.recipe, self.notes = scale_recipe_copy(root)
        self.jobs = []
        for script, conf, cut, _, _ in runs:
            self.start(script, ["bash", script, "0", str(SCALE_HEAD_STAGES),
                                conf, "cuda", *cut], self.recipe,
                       path_k_tap_dir(os.path.join(root, f"tap_{script}")))

    def state(self):
        return {"recipe": self.recipe, "notes": self.notes}


# the wrappers whose calls 22b's recipe processes record: path F's and
# the offline MDTC kernel that bin.score launches
PATH_K_WRAPPERS = PATH_F_WRAPPERS + (
    ("fused_mdtc_forward", "wekws_tpu_torch.ops.serving",
     "wekws_tpu_torch.ops.fused_mdtc", "fused_mdtc_kernel", (TOL, TOL)),)
# 22b's (and 23a's) sitecustomize.py, in a directory first on PYTHONPATH
# (the repo second), so that every port CLI a recipe runs (``python -m
# wekws_tpu_torch.bin.<cli>``, and the scale CTC recipe's stage 4,
# ``python -m wekws_tpu_torch.tools.bench_serving_slo``) is tapped.  The
# recipes' other Python processes are host tools (the layout and corpus
# generators, local/prepare_*.py, the ``python -c`` lists and CMVN on the
# numpy frontend) and start without the tap's imports of torch and the
# wrappers: a tapped start-up took some 10 s on an H100 machine's host
# (23a, NVIDIA H100 80GB HBM3, 700 W)
RECIPE_SITE = ("import os\nimport sys\n\n"
               "argv = sys.orig_argv\n"
               "if '-m' in argv[:-1] and argv[argv.index('-m') + 1].startswith(\n"
               "        ('wekws_tpu_torch.bin.',\n"
               "         'wekws_tpu_torch.tools.bench_serving_slo')):\n"
               "    import chip_smoke\n\n"
               "    chip_smoke.recipe_tap(os.environ['PATH_K_TAP_DIR'])\n")


def kept_leaf(v):
    """A tapped argument for ``torch.save``: a tensor on the host, or one
    over 1 MB as its shape, dtype, mean and standard deviation (drawn
    again by ``standin_args``)."""
    import torch

    if not isinstance(v, torch.Tensor):
        return v
    if v.numel() * v.element_size() > (1 << 20):
        f = v.detach().float()
        return {"standin": list(v.shape), "dtype": str(v.dtype),
                "mean": float(f.mean()), "std": float(f.std())}
    return v.detach().cpu()


def recipe_tap(path):
    """22b's and 23a's tap, entered by RECIPE_SITE for the whole of a
    port CLI's process: ShapeTap (PATH_K_WRAPPERS), PassTap, PlainOnCuda
    and EngineSteps.  At exit it writes ``path``/<pid>.json: the
    process's argv, its kernels' launches, its plain versions' calls on
    CUDA tensors, each training pass's calls by shape and precision, its
    CTC engines' model steps, and each wrapper's calls by shape with the
    first call's arguments saved beside it (``kept_leaf``)."""
    import atexit

    import torch

    from wekws_tpu_torch.ops.fused_mdtc import fused_mdtc_forward

    tap, ptap, plain, steps = (
        ShapeTap(PATH_K_WRAPPERS).__enter__(), PassTap().__enter__(),
        PlainOnCuda().__enter__(), EngineSteps().__enter__())

    def dump():
        calls = []
        for i, ((name, shape), (n, *args)) in enumerate(tap.shapes.items()):
            saved = os.path.join(path, f"{os.getpid()}_{i}.pt")
            torch.save(_tree_map(kept_leaf, args), saved)
            calls.append([name, shape, n, saved])
        passes = [[name, shape, n, args[-1] if isinstance(args[-1], str)
                   else "float32"]
                  for (_, shape), (n, name, args) in ptap.shapes.items()]
        launches = dict(path_j_counts(), **read_counts(),
                        fused_mdtc_forward=fused_mdtc_forward.launches)
        with open(os.path.join(path, f"{os.getpid()}.json"), "w") as f:
            json.dump({"argv": sys.argv, "launches": launches,
                       "plain_on_cuda": plain.counts, "calls": calls,
                       "passes": passes, "engine_steps": steps.counts}, f)

    atexit.register(dump)


def path_k_tap_dir(path):
    """A directory holding RECIPE_SITE as sitecustomize.py."""
    os.makedirs(path)
    with open(os.path.join(path, "sitecustomize.py"), "w") as f:
        f.write(RECIPE_SITE)
    return path


def tap_processes(path):
    """The per-process records that ``recipe_tap`` wrote into ``path``."""
    out = []
    for name in sorted(os.listdir(path)):
        if name.endswith(".json"):
            with open(os.path.join(path, name)) as f:
                out.append(json.load(f))
    return out


def standin_args(saved, gen, dev):
    """A tapped call's arguments on ``dev``: kept tensors moved there, a
    stand-in drawn from ``gen`` (normal, the original's mean and
    standard deviation) for each larger one."""
    import torch

    def back(v):
        if isinstance(v, dict) and "standin" in v:
            dtype = getattr(torch, v["dtype"].split(".")[-1])
            x = torch.randn(v["standin"], generator=gen) * v["std"] + v["mean"]
            return x.to(dtype).to(dev)
        if isinstance(v, torch.Tensor):
            return v.to(dev)
        if isinstance(v, (list, tuple)):
            return type(v)(back(x) for x in v)
        if isinstance(v, dict):
            return {k: back(x) for k, x in v.items()}
        return v

    return back(torch.load(saved, weights_only=False))


def process_name(record):
    """``bin.train``, ``bin.score``, ..., ``tools.bench_serving_slo`` or
    ``python -c`` for a tapped process."""
    argv0 = record["argv"][0] if record["argv"] else ""
    if argv0 in ("-c", ""):
        return "python -c"
    parts = os.path.normpath(argv0).split(os.sep)
    if parts[-2:-1] in (["bin"], ["tools"]):
        return f"{parts[-2]}.{os.path.splitext(parts[-1])[0]}"
    return os.path.basename(argv0)


def path_k_models(work, tmp):
    """22a's models: (name, what, config, checkpoint, fused wrapper)."""
    ctc_config, _ = fixture_config(CTC_FIXTURE, CTC_RECIPE, tmp,
                                   "fsmn_ctc_fixture_22.yaml")
    tcn_config, _ = fixture_config(DS_TCN_FIXTURE, RECIPE, tmp,
                                   "ds_tcn_fixture_22.yaml")
    return (
        ("flagship", "flagship MDTC (4 x 4 blocks, C=64)",
         os.path.join(work, "flagship.yaml"),
         os.path.join(work, "flagship.pt"), "fused_mdtc_stream"),
        ("fsmn_ctc_fixture", "JAX CTC fixture (FSMN 3 x 64/32, 6 tokens)",
         ctc_config, os.path.join(CTC_FIXTURE, "avg_5.ckpt"),
         "fused_fsmn_layers"),
        ("ds_tcn_fixture", "JAX DS-TCN fixture (C=48)", tcn_config,
         os.path.join(DS_TCN_FIXTURE, "avg_5.ckpt"), "fused_ds_tcn"),
    )


def path_k_feats(config, waves):
    """``waves`` through the model's own frontend (its config's fbank,
    context and frame skip, no dither), cut to whole PATH_K_CHUNK-frame
    chunks: (B, T, D) float32."""
    from wekws_tpu_torch.runtime.keyword_spotter import load_spotter_config
    from wekws_tpu_torch.runtime.streaming_frontend import StreamingFrontend

    _, cfg, left, right, skip = load_spotter_config(config)
    feats = []
    for w in waves:
        fe = StreamingFrontend(cfg, left_context=left, right_context=right,
                               frame_skip=skip)
        f, _ = fe.accept_waveform(np.asarray(w, np.float32))
        feats.append(f)
    t = min(len(f) for f in feats) // PATH_K_CHUNK * PATH_K_CHUNK
    return np.stack([f[:t] for f in feats]).astype(np.float32)


def path_k_load_child(cases, device="cuda"):
    """22a in a fresh process: each ``model.pt2`` of ``cases`` ([name,
    program, features .npy, config, checkpoint]) loaded by
    ``load_cached_step``, its aten op counts, and the program stepped
    over the features one utterance at a time in PATH_K_CHUNK-frame
    chunks from the initial cache (outputs and final caches into an .npz
    beside the program).  Prints one line ``PATH_K_LOAD {...}``."""
    import torch
    import yaml

    from wekws_tpu_torch.export.cached_step import (
        aten_op_counts,
        flat_tensors,
        load_cached_step,
    )
    from wekws_tpu_torch.runtime.keyword_spotter import load_serving_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    out = {}
    for name, path, feats_path, config, ckpt in cases:
        ops = aten_op_counts(torch.export.load(path))
        step = load_cached_step(path, dev)
        with open(config) as f:
            configs = yaml.safe_load(f)
        feats = np.load(feats_path)
        model = load_serving_model(configs, ckpt, feats.shape[2], dev)
        outs, caches = [], []
        with torch.no_grad():
            for row in feats:
                x = torch.from_numpy(row[None]).to(dev)
                cache, ys = model.init_cache(1, dev), []
                for s in range(0, x.shape[1], PATH_K_CHUNK):
                    y, cache = step(x[:, s:s + PATH_K_CHUNK], cache)
                    ys.append(y)
                outs.append(torch.cat(ys, 1)[0].cpu().numpy())
                caches.append([c[0].cpu().numpy()
                               for c in flat_tensors(cache)])
        npz = path + ".npz"
        np.savez(npz, out=np.stack(outs), **{
            f"cache{i}": np.stack([c[i] for c in caches])
            for i in range(len(caches[0]))})
        out[name] = {"ops": ops, "npz": npz}
    print("PATH_K_LOAD " + json.dumps(out), flush=True)


def phase22a_step_times(dev, card, cases, figures):
    """22a's timings, taken when nothing else runs on the card: one step
    at B=1 x 32 of each exported program (``load_cached_step``) and of
    its model's fused stream (``build_fused_stream``), the untraced
    median of 10 on the host clock (``timed_steps``) and one traced
    call's device time and CUDA launches (``profiled_step``); into each
    model's ``figures``."""
    import torch
    import yaml

    from wekws_tpu_torch.export.cached_step import load_cached_step
    from wekws_tpu_torch.ops.serving import build_fused_stream
    from wekws_tpu_torch.runtime.keyword_spotter import load_serving_model

    for name, path, feats_path, config, ckpt in cases:
        with open(config) as f:
            configs = yaml.safe_load(f)
        feats = np.load(feats_path)
        model = load_serving_model(configs, ckpt, feats.shape[2], dev)
        x = torch.from_numpy(feats[:1, :PATH_K_CHUNK]).to(dev)
        fstep, finit = build_fused_stream(model, device=dev)
        timing = {}
        for tag, fn, c0 in (("exported", load_cached_step(path, dev),
                             model.init_cache(1, dev)),
                            ("fused", fstep, finit(1))):
            def call(fn=fn, c0=c0):
                with torch.inference_mode():
                    return fn(x, c0)

            median = timed_steps(call)[0]
            busy, launches, _ = profiled_step(call)
            timing[tag] = {"median_ms": median, "device_ms": busy,
                           "cuda_launches": launches}
        ex, fu = timing["exported"], timing["fused"]
        print(f"  22a {name} one step at B=1 x {PATH_K_CHUNK}: exported "
              f"{ex['median_ms']:.3f} ms host clock (untraced median of 10), "
              f"device {ex['device_ms']:.3f} ms in {ex['cuda_launches']} "
              f"CUDA launches; fused stream {fu['median_ms']:.3f} ms, device "
              f"{fu['device_ms']:.3f} ms in {fu['cuda_launches']} launches "
              f"[{card}]", flush=True)
        figures[name]["step"] = timing


def packed_cache_rows(packed, caches):
    """The fused stream's packed (L, B, pad_max, C) cache as the module
    route's per-layer (B, pad_l, C_l) caches: each layer's last pad_l
    rows (its context, right-aligned)."""
    return [packed[i, :, packed.shape[2] - c.shape[1]:, :c.shape[2]]
            for i, c in enumerate(caches)]


def phase22a_exported_step(dev, card, work, tmp):
    """22a: the flagship (phase 4's checkpoint), the JAX CTC fixture and
    the JAX DS-TCN fixture through ``bin.export_model --format stablehlo
    --chunk_frames 32`` on the card; each ``model.pt2`` loaded in a fresh
    process (``path_k_load_child``) and stepped over phase 4's waves
    through the model's frontend; its outputs and final caches held
    against the module route's cached step on the CPU, and against the
    fused stream on the card (outputs, and the packed cache's layers),
    TOL abs + TOL rel; a flat output fails.  Returns ({model: {kernel
    record: launches}}, figures, the cases of ``path_k_load_child``)."""
    import torch
    import yaml

    from wekws_tpu_torch.bin import export_model as export_cli
    from wekws_tpu_torch.export.cached_step import flat_tensors
    from wekws_tpu_torch.ops.serving import build_fused_stream
    from wekws_tpu_torch.runtime.keyword_spotter import load_serving_model

    waves = synth_waves(np.random.default_rng(SEED))
    cases, export_s, gates = [], {}, {}
    models = path_k_models(work, tmp)
    for name, _, config, ckpt, _ in models:
        out_dir = os.path.join(tmp, f"{name}_step")
        t0 = time.perf_counter()
        gates[name] = export_cli.main([
            "--config", config, "--checkpoint", ckpt, "--output_dir",
            out_dir, "--format", "stablehlo", "--chunk_frames",
            str(PATH_K_CHUNK), "--device", dev.type])
        export_s[name] = time.perf_counter() - t0
        feats_path = os.path.join(tmp, f"{name}_feats.npy")
        np.save(feats_path, path_k_feats(config, waves))
        cases.append([name, os.path.join(out_dir, "model.pt2"), feats_path,
                      config, ckpt])
    loaded = run_child("path_k_load_child", [cases, dev.type], "PATH_K_LOAD")
    wrappers = kernel_counts()
    launches, figures = {}, {}
    for (name, what, config, ckpt, kern), case in zip(models, cases):
        found = loaded[name]
        data = np.load(found["npz"])
        got = torch.from_numpy(data["out"])
        got_caches = [torch.from_numpy(data[f"cache{i}"])
                      for i in range(len(data.files) - 1)]
        lo, hi = float(got.min()), float(got.max())
        if not hi - lo > 1e-3:
            raise AssertionError(f"22a {name}: the exported step's outputs "
                                 f"span only [{lo}, {hi}]: the checks "
                                 f"would be vacuous")
        feats = torch.from_numpy(np.load(case[2]))
        b, t, d = feats.shape
        with open(config) as f:
            configs = yaml.safe_load(f)
        cpu_model = load_serving_model(configs, ckpt, d, "cpu")
        card_model = load_serving_model(configs, ckpt, d, dev)
        step, init = build_fused_stream(card_model, device=dev)
        cache, packed, outs, fused = cpu_model.init_cache(b), init(b), [], []
        for w in wrappers.values():
            w.launches = 0
        with torch.inference_mode():
            for s in range(0, t, PATH_K_CHUNK):
                chunk = feats[:, s:s + PATH_K_CHUNK]
                y, cache = cpu_model(chunk, cache)
                outs.append(y)
                y, packed = step(chunk.to(dev).contiguous(), packed)
                fused.append(y)
        torch.cuda.synchronize()
        launches[name] = {k: w.launches for k, w in wrappers.items()
                          if w.launches}
        chunks = t // PATH_K_CHUNK
        if launches[name] != {kern: chunks}:
            raise AssertionError(f"22a {name}: the fused stream's launches "
                                 f"{launches[name]}, want {{{kern!r}: "
                                 f"{chunks}}}")
        want_caches = flat_tensors(cache)
        errs = [check_close(f"22a {name}: exported step vs the module route "
                            f"on the CPU", got, torch.cat(outs, 1),
                            quiet=True),
                check_close(f"22a {name}: exported step vs {kern}", got,
                            torch.cat(fused, 1).cpu(), quiet=True)]
        for i, (g, w, p) in enumerate(zip(got_caches, want_caches,
                                          packed_cache_rows(
                                              packed.cpu(), want_caches))):
            errs.append(check_close(f"22a {name}: cache {i} vs the module "
                                    f"route", g, w, quiet=True))
            errs.append(check_close(f"22a {name}: cache {i} vs {kern}'s "
                                    f"packed cache", g, p, quiet=True))
        if len(got_caches) != len(want_caches):
            raise AssertionError(f"22a {name}: {len(got_caches)} cache "
                                 f"tensors, the module route has "
                                 f"{len(want_caches)}")
        ops = found["ops"]
        top = sorted(ops.items(), key=lambda kv: -kv[1])[:6]
        print(f"  22a {what}: bin.export_model --format stablehlo "
              f"{export_s[name]:.1f} s beside 22b's recipes (its gate {gates[name]:.2e}); "
              f"model.pt2 loaded in a fresh process, {b} utterances x "
              f"{chunks} chunks of {PATH_K_CHUNK} (outputs in [{lo:.3g}, "
              f"{hi:.3g}]): vs the module route on the CPU and vs {kern} "
              f"(outputs and {len(got_caches)} cache tensors) max_abs_err "
              f"{max(errs):.2e} (bound {TOL} abs + {TOL} rel); "
              f"{sum(ops.values())} aten ops of {len(ops)} kinds, nothing "
              f"else ({', '.join(f'{k} {v}' for k, v in top)}, ...) "
              f"[{card}]", flush=True)
        figures[name] = {"aten_ops": sum(ops.values()),
                         "aten_op_kinds": len(ops), "gate": gates[name],
                         "max_abs_err": max(errs), "export_s": export_s[name]}
    return launches, figures, cases


def scale_recipe_copy(tmp):
    """examples/synthetic_scale, and the synthetic_ctc generator that its
    CTC recipe calls, copied into ``tmp`` without corpora or
    experiments; each recipe config copied with max_epoch SCALE_EPOCHS.
    Returns the recipe directory and a line for each cut."""
    import shutil

    import yaml

    root = os.path.join(tmp, "examples")
    skip = shutil.ignore_patterns("train", "dev", "test", "*.list", "exp",
                                  "__pycache__")
    recipe, notes = os.path.join(root, "synthetic_scale"), []
    shutil.copytree(SCALE_RECIPE, recipe, ignore=skip)
    shutil.copytree(os.path.join(CTC_RECIPE, "local"),
                    os.path.join(root, "synthetic_ctc", "local"), ignore=skip)
    for conf in ("conf_torch/mdtc.yaml", "conf/fsmn_ctc.yaml"):
        with open(os.path.join(recipe, conf)) as f:
            configs = yaml.safe_load(f)
        notes.append(f"  22b cut: {conf} max_epoch "
                     f"{configs['training_config']['max_epoch']} -> "
                     f"{SCALE_EPOCHS}")
        configs["training_config"]["max_epoch"] = SCALE_EPOCHS
        with open(os.path.join(recipe, conf.replace(".yaml", "_cut.yaml")),
                  "w") as f:
            yaml.safe_dump(configs, f)
    return recipe, notes


def run_recipes(recipe, jobs, meanwhile, timeout_s=SCALE_TIMEOUT_S,
                tag="22b"):
    """Each job's (argv, tap[, cwd]) ``bash argv`` in its cwd (else
    ``recipe``), all at once (one card and eight cores take them side by
    side), each with its tap first on PYTHONPATH and its output in files
    beside the tap; then ``meanwhile()`` in this process while they run.
    Stops every job still running when it fails or passes ``timeout_s``.
    Returns ([(the completed process, its seconds, the tapped processes'
    records)] in the jobs' order, ``meanwhile()``'s result)."""
    repo = os.path.abspath(os.path.dirname(__file__) or ".")
    started, results = [], []
    try:
        for argv, tap, *cwd in jobs:
            out = open(os.path.join(tap, "stdout.txt"), "w+")
            err = open(os.path.join(tap, "stderr.txt"), "w+")
            env = dict(os.environ, PYTHONPATH=os.pathsep.join([tap, repo]),
                       PATH_K_TAP_DIR=tap)
            started.append((subprocess.Popen(
                ["bash", *argv], cwd=cwd[0] if cwd else recipe, env=env,
                stdout=out, stderr=err, text=True), out, err,
                time.perf_counter()))
        side = meanwhile()
        ended = {}
        while len(ended) < len(started):
            for i, (proc, _, _, t0) in enumerate(started):
                if i not in ended and proc.poll() is not None:
                    ended[i] = time.perf_counter() - t0
                elif time.perf_counter() - t0 > timeout_s:
                    raise TimeoutError(f"{tag} {' '.join(jobs[i][0][:3])}: "
                                       f"over {timeout_s} s")
            time.sleep(0.2)
        for (argv, tap, *_), (proc, out, err, _), seconds in zip(
                jobs, started, (ended[i] for i in range(len(jobs)))):
            out.seek(0)
            err.seek(0)
            done = subprocess.CompletedProcess(argv, proc.returncode,
                                               out.read(), err.read())
            results.append((done, seconds, tap_processes(tap)))
    finally:
        for proc, out, err, _ in started:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            out.close()
            err.close()
    return results, side


def tapped_launches(records, what, tag="22b", name_of=process_name):
    """{process (``name_of``): {kernel record: launches}} of a recipe run;
    fails where a plain version ran on a CUDA tensor."""
    plain = {name_of(r): r["plain_on_cuda"] for r in records
             if r["plain_on_cuda"]}
    if plain:
        raise AssertionError(f"{tag} {what}: plain versions ran on CUDA "
                             f"tensors: {plain}")
    out = {}
    for r in records:
        counts = {k: v for k, v in r["launches"].items() if v}
        if counts:
            name = name_of(r)
            for k, v in counts.items():
                out.setdefault(name, {})[k] = out.get(name, {}).get(k, 0) + v
    return out


def plot_said(done, figure, what):
    """Stage 5 (the DET plot): the PNG where the machine has matplotlib,
    else an ImportError naming the ``plot`` extra."""
    import importlib.util

    if importlib.util.find_spec("matplotlib") is not None:
        if done.returncode != 0 or not os.path.getsize(figure) > 1000:
            raise AssertionError(f"22b {what}: exit {done.returncode}, no "
                                 f"figure at {figure}: "
                                 f"{done.stderr[-2000:]}")
        return f"matplotlib present: {os.path.getsize(figure)} bytes PNG"
    if done.returncode == 0 or "'plot' extra" not in done.stderr:
        raise AssertionError(f"22b {what} without matplotlib: exit "
                             f"{done.returncode}, {done.stderr[-2000:]}")
    return "no matplotlib here: ImportError naming the 'plot' extra"


def recipe_run(done, last, what):
    """Stages 0 to ``last`` of a recipe ran to their end (their
    ``stage N done`` lines): [each stage's wall time]."""
    stages = [line.split(" done in ")[1] for line in done.stdout.splitlines()
              if line.startswith("stage ")]
    if f"stage {last} done" not in done.stdout:
        raise AssertionError(f"22b {what} exited {done.returncode} before "
                             f"stage {last} ended:\n{done.stdout[-3000:]}\n"
                             f"{done.stderr[-3000:]}")
    return stages


def exported_vs_eager(program, model, feats, what):
    """``program`` (a loaded ``model.pt2``) and ``model``'s eager cached
    step over ``feats`` (B, T, D), one utterance at a time in
    PATH_K_CHUNK-frame chunks from the initial cache: outputs and caches
    within TOL abs + TOL rel; a flat output fails.  Returns the max abs
    error."""
    import torch

    from wekws_tpu_torch.export.cached_step import flat_tensors

    errs, lo, hi = [], float("inf"), -float("inf")
    with torch.no_grad():
        for row in feats:
            cache = want = model.init_cache(1, feats.device)
            for s in range(0, feats.shape[1], PATH_K_CHUNK):
                chunk = row[None, s:s + PATH_K_CHUNK]
                y, cache = program(chunk, cache)
                y_want, want = model(chunk, want, softmax=False)
                lo, hi = min(lo, float(y.min())), max(hi, float(y.max()))
                errs += [check_close(f"{what}, chunk {s // PATH_K_CHUNK}",
                                     g, w, quiet=True) for g, w in zip(
                    flat_tensors((y, cache)), flat_tensors((y_want, want)))]
    if not hi - lo > 1e-3:
        raise AssertionError(f"{what}: outputs span only [{lo}, {hi}]: the "
                             f"check would be vacuous")
    return max(errs), (lo, hi)


def phase22b_scale_recipes(dev, card, gen, meanwhile, head,
                           runs=SCALE_RUNS):
    """22b: examples/synthetic_scale's ``run_torch.sh`` and
    ``run_ctc_torch.sh`` (``runs``: both, or the CTC one for
    ``--phase 24``), stages 0-5, on the card: stages 0-1 beside the
    kernel build (``head``, ``PathKHead.finish()``'s state), 2-5 here,
    side by side and beside ``meanwhile()`` (22a) in this process, the
    corpora cut (SCALE_CUT,
    SCALE_CTC_CUT) and max_epoch SCALE_EPOCHS, every port CLI tapped
    (``recipe_tap``): stages 0-4 ended, no plain version on
    a CUDA tensor, bin.train through fused_fbank, F1/F4/B1/B4 and the
    bf16 variants of F2/F3/B2/B3 (17 a step each, none of the float32
    F2/F3/B2/B3), bin.score through fused_mdtc_kernel and bin.score_ctc
    through fused_fsmn_kernel (one launch a batch), ``model.pt2`` loaded
    back and stepped over eight of the recipe's test utterances against
    the averaged model; stage 5 (the plot) as ``plot_said``.  Returns
    ({sub-path: {kernel record: launches}}, {(kernel record, shape):
    [calls, args, kwargs]} of the wrappers, {(pass record, (b, t, c, d,
    precision)): calls}, figures, ``meanwhile()``'s result)."""
    import torch
    from scipy.io import wavfile

    from wekws_tpu_torch.export.cached_step import load_cached_step
    from wekws_tpu_torch.runtime.keyword_spotter import load_serving_model
    from wekws_tpu_torch.tools.cmvn_stats import wav_paths_from_data_list

    recipe = head["recipe"]
    for note in head["notes"]:
        print(note, flush=True)
    print(f"  22b cut: the corpus {' '.join(SCALE_CUT)} (full: 5,000 + "
          f"15,000 train, 500 + 1,500 dev, 2,000 + 6,000 test); the CTC "
          f"corpus {' '.join(SCALE_CTC_CUT)} (full: 20,000, 2,000, 33,000)",
          flush=True)
    launches, shapes, passes, figures = {}, {}, {}, {}
    runs = [(script, [script, str(SCALE_HEAD_STAGES + 1), "5", conf,
                      dev.type, *cut], exp, last)
            for script, conf, cut, exp, last in runs]
    jobs = [(argv, head["runs"][what]["tap"]) for what, argv, _, _ in runs]
    results, side = run_recipes(recipe, jobs, meanwhile)
    for (what, argv, exp, last), (done, seconds, records) in zip(runs,
                                                                  results):
        # the CTC recipe's stage 4 (the serving SLOs) is path M's
        records = [r for r in records if process_name(r) != SLO_TOOL]
        early = head["runs"][what]
        if early["code"] != 0 or f"stage {SCALE_HEAD_STAGES} done" not in \
                early["stdout"]:
            raise AssertionError(
                f"22b {what} 0 {SCALE_HEAD_STAGES} exited {early['code']}:\n"
                f"{early['stdout'][-3000:]}\n{early['stderr'][-3000:]}")
        done = subprocess.CompletedProcess(
            done.args, done.returncode, early["stdout"] + done.stdout,
            early["stderr"] + done.stderr)
        stages = recipe_run(done, last, " ".join(argv[:3]))
        counts = tapped_launches(records, what)
        with open(os.path.join(recipe, exp, "metrics.jsonl")) as f:
            epochs = [json.loads(line) for line in f]
        losses = [e["train_loss"] for e in epochs]
        if len(epochs) != SCALE_EPOCHS or not np.isfinite(losses).all():
            raise AssertionError(f"22b {what}: epochs {epochs}")
        batch = recipe_yaml(os.path.join(recipe, argv[3]))[
            "dataset_conf"]["batch_conf"]["batch_size"]
        steps = epochs[0]["batches"]
        train = counts.get("bin.train", {})
        if what == "run_torch.sh":
            want = {f"fused_train_{p}": 17 * steps * SCALE_EPOCHS
                    for p in ("f1", "f4", "b1", "b4")}
            want.update({f"fused_train_{p}_bf16": 17 * steps * SCALE_EPOCHS
                         for p in ("f2", "f3", "b2", "b3")})
            fbank = train.pop("fused_fbank", 0)
            n_test = int(SCALE_CUT[-3]) + int(SCALE_CUT[-1])
            # the test features through fused_fbank, the model through
            # fused_mdtc_kernel: one launch each a batch of 256
            score_want = dict.fromkeys(("fused_fbank", "fused_mdtc_forward"),
                                       math.ceil(n_test / 256))
            score = counts.get("bin.score", {})
            if train != want or fbank < steps * SCALE_EPOCHS:
                raise AssertionError(f"22b bin.train launched {train} and "
                                     f"fused_fbank {fbank}; want {want} and "
                                     f"fused_fbank >= {steps * SCALE_EPOCHS}")
            train["fused_fbank"] = fbank
            # the recipe's model.pt2 loaded back, over eight of its test
            # utterances (spread over the list: keywords and fillers)
            config = os.path.join(recipe, exp, "config.yaml")
            paths = list(wav_paths_from_data_list(
                os.path.join(recipe, "data", "test.list")))
            waves = [wavfile.read(os.path.join(recipe, p))[1]
                     for p in paths[::len(paths) // 8][:8]]
            feats = path_k_feats(config, waves)
            model = load_serving_model(recipe_yaml(config), os.path.join(
                recipe, exp, "avg_5.pt"), feats.shape[2], dev)
            program = load_cached_step(os.path.join(
                recipe, exp, "export", "model.pt2"), dev)
            err, span = exported_vs_eager(
                program, model, torch.from_numpy(feats).to(dev),
                "22b model.pt2 vs the averaged model's step")
            figures["model_pt2_err"] = err
            print(f"  22b {exp}/export/model.pt2 loaded back: 8 test "
                  f"utterances x {feats.shape[1] // PATH_K_CHUNK} chunks "
                  f"(outputs in [{span[0]:.3g}, {span[1]:.3g}]) vs the "
                  f"averaged model's eager step max_abs_err {err:.2e} "
                  f"(bound {TOL} abs + {TOL} rel)", flush=True)
        else:
            n_test = int(SCALE_CTC_CUT[-1])
            score_want = {"fused_fsmn_layers": math.ceil(n_test / 256)}
            score = counts.get("bin.score_ctc", {})
        if score != score_want:
            raise AssertionError(f"22b {what}: scoring launched {score}, "
                                 f"want {score_want}")
        for r in records:
            for name, shape, calls, prec in r["passes"]:
                b, t, c, d = (int(v.split("=")[1]) for v in shape.split())
                pkey = (name, (b, t, c, d, prec))
                passes[pkey] = passes.get(pkey, 0) + calls
            for name, shape, calls, saved in r["calls"]:
                if (name, shape) in shapes:
                    shapes[name, shape][0] += calls
                else:
                    shapes[name, shape] = [calls, *standin_args(saved, gen,
                                                                dev)]
        stats = os.path.join(recipe, exp, "stats.0.txt" if what ==
                             "run_torch.sh" else "stats.1_2_3.txt")
        if not os.path.getsize(stats):
            raise AssertionError(f"22b {what}: no {stats}")
        # bin.train logs each epoch's cv accuracy ("Epoch N done: ...")
        cv_acc = [float(line.split(" cv_acc ")[1].split()[0])
                  for line in done.stderr.splitlines() if " done: " in line]
        total = launches[f"22b {what}"] = {}
        for c in counts.values():
            for k, v in c.items():
                total[k] = total.get(k, 0) + v
        plot = plot_said(done, os.path.join(recipe, exp, "det.png"), what)
        print(f"  22b {what} {' '.join(argv[3:5])} (B={batch}, {steps} "
              f"step(s) an epoch): stages 0-{last} ended (0-"
              f"{SCALE_HEAD_STAGES} beside the kernel build, the rest here); "
              f"stages {', '.join(stages)}; wall of stages "
              f"{SCALE_HEAD_STAGES + 1}-5 {seconds:.1f} s (shared: both "
              f"recipes and 22a ran side by side on the card); bin.train "
              f"losses {losses}, cv_acc "
              f"{cv_acc}; launches by process {counts}; no plain version on "
              f"a CUDA tensor; stage 5 (the DET plot): {plot} [{card}]",
              flush=True)
        figures[what] = {"shared_card_wall_s": seconds,
                         "shared_card_stages": stages,
                         "train_losses": losses, "cv_acc": cv_acc,
                         "launches": counts, "plot": plot}
    return launches, shapes, passes, figures, side


def pass_checks(card, passes, gen, dev, tag="22c", path="K"):
    """Each training pass at every (B, T, C, dilation, precision) path K
    gave it, on seeded block inputs of that shape (``trace_pass_inputs``
    at its precision; dy zero within KINK of the residual ReLU's kink):
    against its plain version on the same card tensors
    (``compare_pass``; a bf16 variant at bf16 with its BF16_SUM_TOL, as
    21a); at each pass's largest dilation also its time per call (CUDA
    events), its device time with its block reduction (profiler), the
    plain version's time and the bound.  Returns {kernel record:
    [readings]}."""
    import torch

    from wekws_tpu_torch.ops.fused_mdtc_train import (
        BF16_PASSES,
        BF16_SUM_TOL,
        PASS_IDS,
        PASSES,
        compare_pass,
        kernel_name,
        seeded_block_inputs,
        trace_pass_inputs,
    )

    groups = {}
    for (name, shape), calls in passes.items():
        groups.setdefault(shape, []).append((name, calls))
    timed = {}
    for (name, (b, t, c, d, prec)) in passes:
        timed[name] = max(timed.get(name, (0,) * 5), (b, t, c, d, prec))
    out = {}
    for (b, t, c, d, prec), names in sorted(groups.items()):
        p, x, dy = seeded_block_inputs(gen, b, t, c, 5, dev)
        # B1-B4 gate dy by the residual ReLU, recomputed from w, x and
        # bn2's affine terms in each pass and in its plain version; where
        # that input lies within rounding of zero the two can take opposite
        # sides and move dx or a sum by a whole |dy| (a first run on the
        # card read 1.29 at B=512 x T=598).  So dy is zero within KINK of
        # the kink, as phase 6's block check does
        w, xx, v = trace_pass_inputs(x, p, dy, d,
                                     precision=prec)["f4"][:3]
        kink = (w * v["a2"] + v["c2"] + xx).abs() < KINK
        dy = torch.where(kink, torch.zeros_like(dy), dy)
        calls_of = trace_pass_inputs(x, p, dy, d, precision=prec)
        print(f"  {tag} B={b} T={t} C={c} d={d} {prec}: dy zero at "
              f"{int(kink.sum())} elements within {KINK} of the residual "
              f"ReLU's kink", flush=True)
        for name, calls in sorted(names):
            args = calls_of[name]
            bf16 = prec == "bfloat16" and name in BF16_PASSES
            record = f"fused_train_{name}" + ("_bf16" if bf16 else "")
            what = f"B={b} T={t} C={c} d={d}" + (" bf16" if bf16 else "")

            def kern(fn=PASSES[name], args=args):
                return fn(*args)

            def plain(fn=PASSES[name].plain, args=args):
                return fn(*args)

            got, want = kern(), plain()
            err = (compare_pass(f"{tag} {record} {what}", got, want,
                                "bfloat16", BF16_SUM_TOL[name]) if bf16
                   else compare_pass(f"{tag} {record} {what}", got, want))
            reading = {"shape": what, "calls": calls, "max_abs_err": err,
                       "max_rel_err": pass_rel_err(got, want)}
            if timed[name] == (b, t, c, d, prec):
                ms, plain_ms = kernel_vs_plain_ms(kern, plain)
                kname = kernel_name(name, c, prec)
                names_ = (kname,) if name == "f4" else (
                    kname, f"reduce_kernel<{PASS_IDS[name]}>")
                _, _, found = profiled_step(
                    lambda: [kern() for _ in range(20)], names_)
                device_ms = (None if any(found[n] is None for n in names_)
                             else sum(found[n] for n in names_))
                k = args[PASS_DW_ARG[name]].shape[0] \
                    if name in PASS_DW_ARG else 1
                bound, bound_by = (bf16_pass_bound_ms if bf16 else
                                   train_pass_bound_ms)(name, b, t, c, k)
                reading.update(ms=ms, plain_ms=plain_ms, device_ms=device_ms,
                               bound_ms=bound, bound_by=bound_by)
                dev_txt = ("not measured" if device_ms is None
                           else f"{device_ms:.4f} ms with its reduction")
                print(f"  {tag} {record} {what}: {calls} calls on path {path}; vs "
                      f"plain max_abs_err {err:.3e} "
                      f"({reading['max_rel_err']:.2e} of its scale); kernel "
                      f"{ms:.4f} ms per call (device {dev_txt}), plain "
                      f"{plain_ms:.4f} ms, bound {bound:.5f} ms ({bound_by}) "
                      f"[{card}]", flush=True)
            else:
                print(f"  {tag} {record} {what}: {calls} calls on path {path}; vs "
                      f"plain max_abs_err {err:.3e} "
                      f"({reading['max_rel_err']:.2e} of its scale) [{card}]",
                      flush=True)
            out.setdefault(record, []).append(reading)
    return out


def mdtc_forward_checks(card, entries, tag="22c", path="K"):
    """``fused_mdtc_forward`` at every shape path K gave it (bin.score),
    on the first call's weights and a seeded stand-in of its features:
    against its plain version (TOL), times, device time and bound.
    Returns [readings]."""
    from wekws_tpu_torch.ops.fused_mdtc import (
        fused_mdtc_forward,
        fused_mdtc_forward_plain,
    )

    out = []
    for calls, args, kwargs in entries:
        b, t, c = args[0].shape
        dil, k, stack = args[-3], args[-2], args[-1]

        def kern():
            return fused_mdtc_forward(*args, **kwargs)

        def plain():
            return fused_mdtc_forward_plain(*args, **kwargs)

        what = f"B={b} T={t} C={c}"
        err = check_close(f"{tag} fused_mdtc_forward {what}", kern(), plain(),
                          quiet=True)
        ms, plain_ms = kernel_vs_plain_ms(kern, plain)
        dev_ms = profiled_device_ms(kern, "fused_mdtc_kernel")
        bound, bound_by = mdtc_bound_ms(b, t, c, len(dil), k,
                                        len(dil) // stack,
                                        (k - 1) * max(dil), False)
        dev_txt = "not measured" if dev_ms is None else f"{dev_ms:.4f} ms"
        print(f"  {tag} fused_mdtc_forward {what}: {calls} calls on path {path}; "
              f"vs plain max_abs_err {err:.3e} (bound {TOL} abs + {TOL} "
              f"rel); kernel {ms:.4f} ms per call (device {dev_txt}), plain "
              f"{plain_ms:.4f} ms, bound {bound:.5f} ms ({bound_by}) "
              f"[{card}]", flush=True)
        out.append({"shape": what, "calls": calls, "max_abs_err": err,
                    "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                    "bound_ms": bound, "bound_by": bound_by})
    return out


PATH_K_KERNELS = (
    "fused_mdtc_stream", "fused_fsmn_layers", "fused_ds_tcn", "fused_fbank",
    "fused_mdtc_forward", "fused_train_f1", "fused_train_f4",
    "fused_train_b1", "fused_train_b4", "fused_train_f2_bf16",
    "fused_train_f3_bf16", "fused_train_b2_bf16", "fused_train_b3_bf16")


def path_k(dev, card, work, head):
    """Phase 22, path K: 22b the scale recipes, with 22a the exported
    step in this process while they run, then 22a's timings on the card
    alone; 22c each kernel path K launched against its plain version at
    every shape path K gave it.  Returns ({sub-path: {kernel record:
    launches}}, {kernel record: [readings]}, figures)."""
    import tempfile

    import torch

    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED + 22)
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        with ShapeTap() as tap:
            def phase22a():
                with PlainOnCuda() as plain:
                    found = phase22a_exported_step(dev, card, work, tmp)
                plain.check("22a the fused streams")
                return found

            b_launches, b_shapes, passes, b_figures, (
                a_launches, a_figures, cases) = phase22b_scale_recipes(
                    dev, card, gen, phase22a, head)
        t_recipes = time.perf_counter() - t0
        phase22a_step_times(dev, card, cases, a_figures)
    for name, counts in a_launches.items():
        launches[f"22a {name}'s fused stream"] = counts
    launches.update(b_launches)
    t_times = time.perf_counter() - t0 - t_recipes
    shapes, mdtc_entries = dict(tap.shapes), []
    for (name, shape), entry in sorted(b_shapes.items(), key=lambda kv: kv[0]):
        if name == "fused_mdtc_forward":
            mdtc_entries.append(entry)
        elif (name, shape) in shapes:
            shapes[name, shape][0] += entry[0]
        else:
            shapes[name, shape] = entry
    readings = phase17e_kernel_checks(card, shapes, "22c", "K")
    readings["fused_mdtc_forward"] = mdtc_forward_checks(card, mdtc_entries)
    readings.update(pass_checks(card, passes, gen, dev))
    seconds = {"22a and 22b side by side": t_recipes,
               "22a step times": t_times,
               "22c": time.perf_counter() - t0 - t_recipes - t_times}
    print(f"  path K's seconds: {seconds}", flush=True)
    figures = {"22a": a_figures, "22b": b_figures, "seconds": seconds,
               "phase_s": time.perf_counter() - t0}
    return launches, readings, figures


def merge_path_k(record, launches, readings):
    """Path K's launches (by sub-path) and readings into the kernel
    records; fails if a path-K kernel never launched."""
    rows = {r["name"]: r for r in record}
    totals = {}
    for sub, counts in launches.items():
        for name, n in counts.items():
            if n:
                totals[name] = totals.get(name, 0) + n
                rows[name].setdefault("path_k_launches", {})[sub] = n
    missing = [k for k in PATH_K_KERNELS if not totals.get(k)]
    if missing:
        raise AssertionError(f"path K launched no {missing}: {launches}")
    for name, n in totals.items():
        rows[name]["launches"] += n
    for name, rs in readings.items():
        rows[name]["path_k"] = rs
        rows[name]["max_abs_err"] = max(
            [rows[name]["max_abs_err"]] + [r["max_abs_err"] for r in rs])


def path_k_child(work, head, device="cuda"):
    """``path_k`` in a fresh process (the full run's phase 22: late in the
    long process the profiler loses records); its progress lines, then
    one line ``PATH_K {...}``."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    launches, readings, figures = path_k(torch.device(device), card_line(),
                                         work, head)
    print("PATH_K " + json.dumps({"launches": launches, "readings": readings,
                                  "figures": figures}), flush=True)


def phase22(card, work, record, head):
    """Phase 22 in a fresh process, merged into ``record``; ``head`` the
    ``PathKHead`` started before the build."""
    import torch

    with phase("22 path K: the exported step, the scale recipes, the DET "
               "plots"):
        torch.cuda.empty_cache()
        found = run_child("path_k_child", [work, head.finish()], "PATH_K",
                          900)
        merge_path_k(record, found["launches"], found["readings"])
        print(f"  launches on path K: {found['launches']} [{card}]",
              flush=True)
        print(json.dumps({"path_k_figures": found["figures"], "card": card}),
              flush=True)


def path_k_alone(dev, card, kind, head):
    """``chip_smoke.py --phase 22``: phase 4's flagship checkpoint (its
    ``serving_slice``), path K in this process, then the last lines
    (path K's kernels' records)."""
    import torch

    from wekws_tpu_torch.ops import cuda_build
    from wekws_tpu_torch.ops.fused_mdtc import (
        fused_mdtc_forward,
        fused_mdtc_stream,
    )

    work = os.path.join(cuda_build.BUILD_DIR, "chip_smoke")
    os.makedirs(work, exist_ok=True)
    with phase("4 (flagship checkpoint only)"):
        serving_slice("flagship", FLAGSHIP_MODEL_CONF,
                      torch.Generator().manual_seed(SEED), dev, work,
                      synth_waves(np.random.default_rng(SEED)),
                      fused_mdtc_forward, fused_mdtc_stream, {})
    record = [{"name": n, "launches": 0, "max_abs_err": 0.0}
              for n in PATH_K_KERNELS]
    with phase("22 path K: the exported step, the scale recipes, the DET "
               "plots"):
        launches, readings, figures = path_k(dev, card, work, head.finish())
        merge_path_k(record, launches, readings)
        print(f"  launches on path K: {launches} [{card}]", flush=True)
        print(json.dumps({"path_k_figures": figures, "card": card}),
              flush=True)
    return last_lines(card, record, kind)


# ---------------------------------------------------------------------------
# phase 23, path L: the public recipes through the port (examples/
# hi_xiaowen's run_ctc_torch.sh with its base pretraining and
# examples/speechcommand_v1's run_torch.sh) on miniature corpora written
# in the datasets' own layouts
# ---------------------------------------------------------------------------

PATH_L_EPOCHS = 1
PATH_L_TIMEOUT_S = 600
PATH_L_SEED = SEED + 23
# the corpora (wekws_tpu_torch.tools.public_layouts; the real Mobvoi
# hotword set has 144k train utterances, Speech Commands v1 about 2,400 a
# word): one full batch of each config an epoch, B=256 (ds_tcn_ctc.yaml)
# of 256 keyword-corpus utterances and B=200 (ds_tcn_ctc_base.yaml) of
# 200 ASR-base ones; 8 files a word of 13 words and 2 noise files for
# B=100 (mdtc.yaml), one scoring batch of each test split
PATH_L_RUNS = (
    # (recipe, script, layout, its options, the script's flags, the flags
    # of path L's part alone, its last stage, experiment, test utterances)
    ("hi_xiaowen", "run_ctc_torch.sh", "mobvoi",
     ("--train", "256", "--dev", "64", "--test", "64", "--ctc_data", "data",
      "--asr_base", "data/asr_base", "--base_train", "200", "--base_dev",
      "40"),
     ("--config", "conf_torch/ds_tcn_ctc.yaml"), ("--trainbase", "true"),
     5, "exp/torch_ds_tcn_ctc", 64),
    ("speechcommand_v1", "run_torch.sh", "speech_commands",
     ("--train", "8", "--dev", "2", "--test", "2"), (), (), 3,
     "exp/torch_mdtc", 26),
)
# 23a's rounds, the jobs of a round side by side: (recipe, first stage,
# last stage).  run_ctc_torch.sh's stages 4 (streaming score) and 5
# (export) each read stage 3's averaged model alone, so they run side by
# side; its stage 1 runs again in path L because 1b, the base
# pretraining, is a part of stage 1 (gated by --trainbase)
PATH_L_ROUNDS = ((("hi_xiaowen", 1, 3), ("speechcommand_v1", 2, 3)),
                 (("hi_xiaowen", 4, 4), ("hi_xiaowen", 5, 5)))
PATH_L_BASE_EXP = "exp/torch_ctc_base"  # run_ctc_torch.sh's trainbase_exp
PATH_L_KERNELS = ("fused_fbank", "fused_ds_tcn", "fused_mdtc_forward") + \
    tuple(f"fused_train_{p}" for p in TRAIN_PASSES)


class PathLHead(RecipeHead):
    """Path L's layouts and stages 0-1 (the dict or the lists, CMVN: the
    CPU alone), each recipe copied into ``work``/path_l with its tap.
    (run_ctc_torch.sh's base pretraining, 1b, is a part of its stage 1
    gated by --trainbase, so path L runs that script from stage 1 again
    with it.)"""

    tag, timeout_s = "23a", PATH_L_TIMEOUT_S

    def __init__(self, work):
        import shutil

        root = os.path.join(work, "path_l")
        shutil.rmtree(root, ignore_errors=True)
        os.makedirs(os.path.join(root, "tools"))
        repo = os.path.abspath(os.path.dirname(__file__) or ".")
        shutil.copy(os.path.join(repo, "tools", "parse_options.sh"),
                    os.path.join(root, "tools"))
        self.root, self.jobs = root, []
        skip = shutil.ignore_patterns("data", "exp", "dict", "__pycache__")
        for recipe, script, layout, opts, flags, *_ in PATH_L_RUNS:
            cwd = os.path.join(root, "examples", recipe)
            shutil.copytree(os.path.join(repo, "examples", recipe), cwd,
                            ignore=skip)
            line = " ".join([
                sys.executable, "-m", "wekws_tpu_torch.tools.public_layouts",
                layout, "data/local", "--seed", str(PATH_L_SEED), *opts,
                "&&", "bash", script, *flags, "0", "1", "cuda"])
            self.start(recipe, ["bash", "-c", line], cwd,
                       path_k_tap_dir(os.path.join(root, f"tap_{recipe}")))

    def state(self):
        return {"root": self.root}


def path_l_process(record):
    """A tapped process of path L by name, ``bin.train`` by its model
    directory (run_ctc_torch.sh trains twice)."""
    name = process_name(record)
    argv = record["argv"]
    if name == "bin.train" and "--model_dir" in argv:
        return f"bin.train {argv[argv.index('--model_dir') + 1]}"
    return name


def epochs_of(exp):
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        epochs = [json.loads(line) for line in f]
    losses = [e["train_loss"] for e in epochs]
    if not epochs or not np.isfinite(losses).all():
        raise AssertionError(f"23a {exp}: epochs {epochs}")
    return epochs


def ctc_recipe_checks(cwd, exp, done, counts, n_test):
    """run_ctc_torch.sh --trainbase true: the base pretraining's and the
    fine-tune's epochs, the fine-tune resumed one epoch past the base's
    last with its lr and best cv loss (its log line and its first
    checkpoint), bin.train through fused_fbank at least once a step,
    bin.score_ctc through fused_ds_tcn_kernel once a batch of 256, both
    DET stats of both scorings, the export and its int8 copy.  Returns
    figures."""
    import re

    from wekws_tpu_torch.train.checkpoint import load_checkpoint_info

    base = epochs_of(os.path.join(cwd, PATH_L_BASE_EXP))
    tune = epochs_of(os.path.join(cwd, exp))
    # the base's last checkpoint, the one final.pt links
    info = load_checkpoint_info(os.path.realpath(os.path.join(
        cwd, PATH_L_BASE_EXP, "final.pt")))
    start = int(info["epoch"]) + 1
    resumed = re.findall(r"resumed from (\S+) at epoch (\d+), lr (\S+), "
                         r"best cv loss (\S+)", done.stderr)
    want = [(f"{PATH_L_BASE_EXP}/final.pt", str(start),
             repr(float(info["lr"])), repr(float(info["cv_loss"])))]
    first = load_checkpoint_info(os.path.join(cwd, exp, f"{start}.pt"))
    if [e["epoch"] for e in base] != list(range(PATH_L_EPOCHS)) or \
            [e["epoch"] for e in tune] != list(
                range(start, start + PATH_L_EPOCHS)) or resumed != want \
            or first["lr"] != info["lr"]:
        raise AssertionError(f"23a run_ctc_torch.sh: base epochs {base}, "
                             f"fine-tune epochs {tune}, resumed {resumed} "
                             f"(want {want}), the fine-tune's first "
                             f"checkpoint {first}")
    for key, epochs in ((f"bin.train {PATH_L_BASE_EXP}", base),
                        (f"bin.train {exp}", tune)):
        steps = sum(e["batches"] for e in epochs)
        fbank = counts.get(key, {}).get("fused_fbank", 0)
        if steps < 1 or fbank < steps:
            raise AssertionError(f"23a {key}: {steps} steps, fused_fbank "
                                 f"launched {fbank} times: {counts}")
    score = counts.get("bin.score_ctc", {}).get("fused_ds_tcn")
    if score != math.ceil(n_test / 256):
        raise AssertionError(f"23a bin.score_ctc launched fused_ds_tcn "
                             f"{score} times for {n_test} utterances: "
                             f"{counts}")
    for sub in ("test_avg_30.pt", "stream_avg_30.pt"):
        for kw in ("嗨_小_问", "你_好_问_问"):
            with open(os.path.join(cwd, exp, sub, f"stats.{kw}.txt")) as f:
                if len(f.readlines()) < 100:
                    raise AssertionError(f"23a {sub} stats.{kw}.txt")
        with open(os.path.join(cwd, exp, sub, "score.txt")) as f:
            if len(f.readlines()) != n_test:
                raise AssertionError(f"23a {sub}/score.txt")
    for sub in ("export", "export_int8"):
        if not os.path.getsize(os.path.join(cwd, exp, sub, "weights.bin")):
            raise AssertionError(f"23a {exp}/{sub}")
    return {"base_epochs": base, "fine_tune_epochs": tune,
            "resumed_at": start, "lr": info["lr"],
            "best_cv_loss": info["cv_loss"]}


def commands_recipe_checks(cwd, exp, done, counts, n_test):
    """speechcommand_v1's run_torch.sh: bin.train's MDTC (4 x 4 blocks)
    through F1-F4/B1-B4 in float32, 17 launches a step each and no bf16
    variant, fused_fbank (MFCC 80 of 80) at least once a step;
    bin.compute_accuracy's line over every test utterance through
    fused_mdtc_kernel (the global head) once a batch of 256.  Returns
    figures."""
    import re

    epochs = epochs_of(os.path.join(cwd, exp))
    steps = sum(e["batches"] for e in epochs)
    train = dict(counts.get(f"bin.train {exp}", {}))
    fbank = train.pop("fused_fbank", 0)
    want = {f"fused_train_{p}": 17 * steps for p in TRAIN_PASSES}
    if steps < 1 or train != want or fbank < steps:
        raise AssertionError(f"23a bin.train {exp} ({steps} steps) launched "
                             f"{train} and fused_fbank {fbank}; want {want} "
                             f"and fused_fbank >= {steps}")
    acc = counts.get("bin.compute_accuracy", {}).get("fused_mdtc_forward")
    found = re.findall(r"^Accuracy: ([0-9.]+) \((\d+)/(\d+)\)$", done.stdout,
                       re.MULTILINE)
    if acc != math.ceil(n_test / 256) or len(found) != 1 or \
            int(found[0][2]) != n_test:
        raise AssertionError(f"23a bin.compute_accuracy: fused_mdtc_forward "
                             f"{acc} launches, {found} ({n_test} test "
                             f"utterances)")
    return {"epochs": epochs, "accuracy": float(found[0][0])}


def phase23a_public_recipes(dev, card, head):
    """23a: ``run_ctc_torch.sh --config conf_torch/ds_tcn_ctc.yaml
    --trainbase true`` in examples/hi_xiaowen (stages 1-5: the base CTC
    pretraining, the fine-tune from its final.pt, average, score_ctc and
    DET, stream_score_ctc and DET, export and int8) and examples/
    speechcommand_v1's ``run_torch.sh`` (stages 2-3: train, average,
    compute_accuracy) on the card in PATH_L_ROUNDS, after their stages
    0-1 beside the kernel build (``head``, ``PathLHead.finish()``'s
    state), PATH_L_EPOCHS epochs a training stage, every port CLI tapped
    (``recipe_tap``), each job with its own tap: every stage ended, the checks of
    ``ctc_recipe_checks`` and ``commands_recipe_checks``, no plain
    version on a CUDA tensor.  Returns ({sub-path: {kernel record:
    launches}}, {(kernel, shape): [calls, args, kwargs]},
    {(pass record, shape): calls}, figures)."""
    import torch

    for what, early in head["runs"].items():
        if early["code"] != 0 or "stage 1 done" not in early["stdout"]:
            raise AssertionError(f"23a {what} stages 0-1 exited "
                                 f"{early['code']}:\n{early['stdout'][-3000:]}"
                                 f"\n{early['stderr'][-3000:]}")
    print(f"  23a the corpora (wekws_tpu_torch.tools.public_layouts, seed "
          f"{PATH_L_SEED}): " + "; ".join(
              f"{recipe} {layout} {' '.join(opts)}"
              for recipe, _, layout, opts, *_ in PATH_L_RUNS), flush=True)
    runs = {r[0]: r for r in PATH_L_RUNS}
    ran = {}  # recipe: [(argv, the completed process, seconds, records)]
    for jobs_of_round in PATH_L_ROUNDS:
        jobs = []
        for recipe, first, last in jobs_of_round:
            _, script, _, _, flags, late, *_ = runs[recipe]
            tap = path_k_tap_dir(os.path.join(head["root"],
                                              f"tap_{recipe}_{first}"))
            jobs.append(([script, *flags, *late, str(first), str(last),
                          dev.type, str(PATH_L_EPOCHS)], tap,
                         head["runs"][recipe]["cwd"]))
        results, _ = run_recipes(None, jobs, lambda: None, PATH_L_TIMEOUT_S,
                                 "23a")
        for (recipe, *_), (argv, *_), (done, seconds, records) in zip(
                jobs_of_round, jobs, results):
            if done.returncode != 0:
                raise AssertionError(f"23a {recipe}: {' '.join(argv)} exited "
                                     f"{done.returncode}:\n"
                                     f"{done.stdout[-3000:]}\n"
                                     f"{done.stderr[-3000:]}")
            ran.setdefault(recipe, []).append((argv, done, seconds, records))
    launches, shapes, passes, figures = {}, {}, {}, {}
    gen = torch.Generator().manual_seed(PATH_L_SEED)
    for recipe, script, _, _, _, _, last, exp, n_test in PATH_L_RUNS:
        early = head["runs"][recipe]
        cwd = early["cwd"]
        records = [r for *_, rs in ran[recipe] for r in rs]
        done = subprocess.CompletedProcess(
            script, 0, early["stdout"] + "".join(
                d.stdout for _, d, _, _ in ran[recipe]),
            early["stderr"] + "".join(d.stderr for _, d, _, _ in ran[recipe]))
        what = f"{recipe}/{script}"
        recipe_run(done, last, what)
        stages = [line[6:].replace(" done in ", ": ")
                  for line in done.stdout.splitlines()
                  if line.startswith("stage ") and " done in " in line]
        counts = tapped_launches(records, what, "23a", path_l_process)
        check = (ctc_recipe_checks if recipe == "hi_xiaowen"
                 else commands_recipe_checks)
        found = check(cwd, exp, done, counts, n_test)
        walls = {" ".join(argv[-4:-2]): seconds
                 for argv, _, seconds, _ in ran[recipe]}
        figures[what] = dict(found, stages=stages,
                             shared_card_wall_s=walls, launches=counts)
        for r in records:
            for name, shape, calls, prec in r["passes"]:
                b, t, c, d = (int(v.split("=")[1]) for v in shape.split())
                key = (name, (b, t, c, d, prec))
                passes[key] = passes.get(key, 0) + calls
            for name, shape, calls, saved in r["calls"]:
                if (name, shape) in shapes:
                    shapes[name, shape][0] += calls
                else:
                    shapes[name, shape] = [calls, *standin_args(saved, gen,
                                                                dev)]
        total = launches[f"23a {recipe}"] = {}
        for c in counts.values():
            for k, v in c.items():
                total[k] = total.get(k, 0) + v
        if recipe == "hi_xiaowen":
            result = (
                f"base pretraining losses "
                f"{[e['train_loss'] for e in found['base_epochs']]}; the "
                f"fine-tune resumed from {PATH_L_BASE_EXP}/final.pt at epoch "
                f"{found['resumed_at']} with lr {found['lr']} and best cv "
                f"loss {found['best_cv_loss']:.4f}, losses "
                f"{[e['train_loss'] for e in found['fine_tune_epochs']]}")
        else:
            result = (f"losses {[e['train_loss'] for e in found['epochs']]}, "
                      f"accuracy {found['accuracy']} on {n_test} utterances")
        print(f"  23a {recipe}: " + "; ".join(
            " ".join(argv) for argv, *_ in ran[recipe])
            + f" (stages 0-1 beside the kernel build): stages "
            f"{', '.join(stages)}; wall of each run (stages: s) "
            f"{', '.join(f'{k}: {v:.1f}' for k, v in walls.items())} "
            f"(shared: the jobs of a round ran side by side on the card); "
            f"{result}; launches by process {counts}; no plain version on "
            f"a CUDA tensor [{card}]", flush=True)
    return launches, shapes, passes, figures


def path_l(dev, card, head):
    """Phase 23, path L: 23a the public recipes, then 23b each kernel
    path L launched against its plain version at every shape path L gave
    it (phases 6, 9 and 17e's bounds), timed.  Returns ({sub-path:
    {kernel record: launches}}, {kernel record: [readings]}, figures)."""
    import torch

    t0 = time.perf_counter()
    launches, shapes, passes, figures = phase23a_public_recipes(
        dev, card, head)
    t_recipes = time.perf_counter() - t0
    gen = torch.Generator().manual_seed(PATH_L_SEED + 1)
    mdtc = [entry for (name, _), entry in sorted(shapes.items(),
                                                 key=lambda kv: kv[0])
            if name == "fused_mdtc_forward"]
    others = {k: v for k, v in shapes.items() if k[0] != "fused_mdtc_forward"}
    # each kernel timed at the shape it was launched at most (the
    # streaming score's chunks give the DS-TCN kernel some 30 shapes)
    timed = {max((k for k in others if k[0] == name),
                 key=lambda k: others[k][0])
             for name in {k[0] for k in others}}
    readings = phase17e_kernel_checks(card, others, "23b", "L", timed=timed)
    readings["fused_mdtc_forward"] = mdtc_forward_checks(card, mdtc, "23b",
                                                         "L")
    readings.update(pass_checks(card, passes, gen, dev, "23b", "L"))
    seconds = {"23a": t_recipes, "23b": time.perf_counter() - t0 - t_recipes}
    print(f"  path L's seconds: {seconds}", flush=True)
    figures = {"23a": figures, "seconds": seconds}
    return launches, readings, figures


def merge_path_l(record, launches, readings):
    """Path L's launches (by sub-path) and readings into the kernel
    records; fails if a path-L kernel never launched."""
    rows = {r["name"]: r for r in record}
    totals = {}
    for sub, counts in launches.items():
        for name, n in counts.items():
            if n:
                totals[name] = totals.get(name, 0) + n
                rows[name].setdefault("path_l_launches", {})[sub] = n
    missing = [k for k in PATH_L_KERNELS if not totals.get(k)]
    if missing:
        raise AssertionError(f"path L launched no {missing}: {launches}")
    for name, n in totals.items():
        rows[name]["launches"] += n
    for name, rs in readings.items():
        rows[name]["path_l"] = rs
        rows[name]["max_abs_err"] = max(
            [rows[name]["max_abs_err"]] + [r["max_abs_err"] for r in rs])


def path_l_child(head, device="cuda"):
    """``path_l`` in a fresh process (late in the long process the
    profiler loses records); its progress lines, then one line
    ``PATH_L {...}``."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    launches, readings, figures = path_l(torch.device(device), card_line(),
                                         head)
    print("PATH_L " + json.dumps({"launches": launches, "readings": readings,
                                  "figures": figures}), flush=True)


def phase23(card, record, head):
    """Phase 23 in a fresh process, merged into ``record``; ``head`` the
    ``PathLHead`` started before the build."""
    import torch

    with phase("23 path L: the public recipes (hi_xiaowen CTC with base "
               "pretraining, speechcommand_v1)"):
        torch.cuda.empty_cache()
        found = run_child("path_l_child", [head.finish()], "PATH_L", 900)
        merge_path_l(record, found["launches"], found["readings"])
        print(f"  launches on path L: {found['launches']} [{card}]",
              flush=True)
        print(json.dumps({"path_l_figures": found["figures"], "card": card},
                         ensure_ascii=False), flush=True)


def path_l_alone(dev, card, kind, head):
    """``chip_smoke.py --phase 23``: path L in this process, then the last
    lines (path L's kernels' records)."""
    record = [{"name": n, "launches": 0, "max_abs_err": 0.0}
              for n in PATH_L_KERNELS]
    with phase("23 path L: the public recipes (hi_xiaowen CTC with base "
               "pretraining, speechcommand_v1)"):
        launches, readings, figures = path_l(dev, card, head.finish())
        merge_path_l(record, launches, readings)
        print(f"  launches on path L: {launches} [{card}]", flush=True)
        print(json.dumps({"path_l_figures": figures, "card": card},
                         ensure_ascii=False), flush=True)
    return last_lines(card, record, kind)


# ---------------------------------------------------------------------------
# phase 24, path M: the serving SLOs and the decode drift (the scale CTC
# recipe's stage 4, ROADMAP A.14; wekws_tpu_torch/tools/bench_serving_slo.py
# and drift_sweep.py, A.21)
# ---------------------------------------------------------------------------

PATH_M_KERNELS = ("fused_fsmn_layers", "fused_fbank")
# the process of the scale CTC recipe's stage 4: 22b runs it, tapped, and
# leaves its record and slo.json to path M
SLO_TOOL = "tools.bench_serving_slo"
SLO_STREAMS = [1, 16, 64]  # the tool's default --streams
# JAX's keys of a latency line that has step-bearing chunks
# (tools/bench_serving_slo.py:104-121; then buffer_p50_ms where a chunk
# only buffered), of a detection line, and of one that detected
SLO_LATENCY_KEYS = ["bench", "streams", "chunk_frames", "device_decode",
                    "device_frontend", "chunks", "step_chunks",
                    "realtime_factor", "step_p50_ms", "step_p95_ms",
                    "step_p99_ms"]
SLO_DETECTION_KEYS = ["bench", "keyword", "utts", "missed", "chunk_ms"]
SLO_DETECTED_KEYS = ["p50_ms", "p95_ms", "p99_ms", "min_ms", "max_ms",
                     "resolution_ms"]
# 24a's run in this process: 64 streams, the device decode and frontend
PATH_M_SLO_ARGS = ["--mode", "latency", "--streams", "64",
                   "--device_decode", "--device_frontend", "--iters", "50"]
PATH_M_UTTS = 50  # 24b: the tool's default --utts
# 24c: the synthetic CTC corpus's first 64 test utterances at two
# thresholds, against path F's limits (C.4): no utterance that only one
# decoder detects, scores within CTC_SCORE_TOL
PATH_M_DRIFT_ARGS = ["--limit", "64", "--thresholds", "0.1", "0.5"]
DRIFT_LINE = re.compile(r"thr (\S+): divergent (\d+)/(\d+) \((\S+)%\), "
                        r"both-detected (\d+), max score gap (\S+)$")


class EngineSteps:
    """Within the ``with``, the model steps of the CTC engines: each
    batched step of a ``BatchKeywordSpotter`` (``_run``: one model call
    for all its streams) and each model call of a ``KeyWordSpotter``
    built within it (``_device_apply``), as counts "batch" and
    "single"."""

    def __enter__(self):
        from wekws_tpu_torch.runtime.batch_spotter import BatchKeywordSpotter
        from wekws_tpu_torch.runtime.keyword_spotter import KeyWordSpotter

        self.counts, self._saved = {"batch": 0, "single": 0}, []
        for cls, name, key in ((BatchKeywordSpotter, "_run", "batch"),
                               (KeyWordSpotter, "_device_apply", "single")):
            fn = getattr(cls, name)

            def counted(*args, _fn=fn, _key=key, **kwargs):
                self.counts[_key] += 1
                return _fn(*args, **kwargs)

            self._saved.append((cls, name, cls.__dict__.get(name)))
            setattr(cls, name, counted)
        return self

    def __exit__(self, *exc):
        for cls, name, own in self._saved:
            if own is None:  # inherited: the base class's again
                delattr(cls, name)
            else:
                setattr(cls, name, own)
        return False


def tool_lines(main, argv):
    """A port tool's ``main(argv)`` in this process: its printed lines."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue().splitlines()


def slo_lines(lines, what, streams=SLO_STREAMS, detection=True):
    """``bench_serving_slo``'s JSON lines: a latency line for each stream
    count of ``streams``, with JAX's keys and step-bearing chunks, then
    (``detection``) one detection line with JAX's keys, and nothing else.
    Returns (the latency lines, the detection lines)."""
    rows = [json.loads(line) for line in lines]
    latency = [r for r in rows if r.get("bench") == "per_chunk_latency"]
    found = [r for r in rows if r.get("bench") == "detection_latency"]
    if ([r["streams"] for r in latency] != list(streams)
            or len(found) != int(detection)
            or len(rows) != len(latency) + len(found)):
        raise AssertionError(f"24 {what}: lines {rows}")
    for r in latency:
        keys = list(r)
        if (keys[:len(SLO_LATENCY_KEYS)] != SLO_LATENCY_KEYS
                or keys[len(SLO_LATENCY_KEYS):] not in ([], ["buffer_p50_ms"])
                or not r["step_chunks"] > 0):
            raise AssertionError(f"24 {what}: not JAX's latency line, or no "
                                 f"step-bearing chunk: {r}")
    for r in found:
        keys = list(r)
        want = SLO_DETECTION_KEYS + (
            [] if r["missed"] == r["utts"] else SLO_DETECTED_KEYS)
        if keys != want:
            raise AssertionError(f"24 {what}: not JAX's detection line: {r}")
    return latency, found


def phase24a_slo(dev, card, work, gen):
    """24a: the scale CTC recipe's stage 4 (22b ran it at the tool's
    defaults, its process tapped): its ``slo.json`` read back
    (``slo_lines``), one ``fused_fsmn_kernel`` launch an engine step and
    nothing else launched, no plain version on a CUDA tensor; then the
    tool in this process on the recipe's model at 64 streams with the
    device decode and frontend (``PATH_M_SLO_ARGS``): one
    ``fused_fsmn_kernel`` and one ``fused_fbank`` launch a step.  Returns
    ({sub-path: {kernel record: launches}}, the stage's wrapper calls
    {(kernel record, shape): [calls, args, kwargs]}, figures)."""
    from wekws_tpu_torch.tools import bench_serving_slo

    script, _, _, exp, _ = SCALE_RUNS[1]
    recipe = os.path.join(work, "path_k", "examples", "synthetic_scale")
    exp = os.path.join(recipe, exp)
    records = [r for r in tap_processes(os.path.join(
        work, "path_k", f"tap_{script}")) if process_name(r) == SLO_TOOL]
    if len(records) != 1:
        raise AssertionError(f"24a: {len(records)} tapped processes of the "
                             f"recipe's stage 4 ({SLO_TOOL}), want 1")
    rec = records[0]
    if rec["plain_on_cuda"]:
        raise AssertionError(f"24a the recipe's stage 4: plain versions ran "
                             f"on CUDA tensors: {rec['plain_on_cuda']}")
    with open(os.path.join(exp, "slo.json")) as f:
        stage = f.read().splitlines()
    latency, found = slo_lines(stage, "the recipe's stage 4 (slo.json)")
    steps = rec["engine_steps"]
    stage_counts = {k: v for k, v in rec["launches"].items() if v}
    if stage_counts != {"fused_fsmn_layers": sum(steps.values())}:
        raise AssertionError(f"24a the recipe's stage 4: launches "
                             f"{stage_counts} for the engines' steps {steps}; "
                             f"want one fused_fsmn_kernel launch a step and "
                             f"nothing else")
    for line in stage:
        print(f"  24a {os.path.relpath(exp, recipe)}/slo.json: {line} "
              f"[{card}]", flush=True)
    print(f"  24a the recipe's stage 4 ({SLO_TOOL} at its defaults, tapped): "
          f"{stage_counts['fused_fsmn_layers']} fused_fsmn_kernel launches "
          f"for as many engine steps ({steps['batch']} batched: "
          f"{sum(r['step_chunks'] for r in latency)} timed step-bearing "
          f"chunks and the warm-up's; {steps['single']} KeyWordSpotter "
          f"model calls); no plain version on a CUDA tensor", flush=True)
    shapes = {}
    for name, shape, calls, saved in rec["calls"]:
        shapes[name, shape] = [calls, *standin_args(saved, gen, dev)]

    argv = ["--config", os.path.join(exp, "config.yaml"), "--checkpoint",
            os.path.join(exp, "avg_5.pt"), "--tokens",
            os.path.join(recipe, "dict", "dict.txt"), "--keyword", "123",
            "--threshold", "0.1", *PATH_M_SLO_ARGS, "--device", dev.type]
    with EngineSteps() as counted:
        zero_counts()
        lines = tool_lines(bench_serving_slo.main, argv)
        here = {k: v for k, v in read_counts().items() if v}
    (line,), _ = slo_lines(lines, "64 streams, device decode and frontend",
                           streams=[64], detection=False)
    n = counted.counts["batch"]
    if here != {"fused_fsmn_layers": n, "fused_fbank": n}:
        raise AssertionError(f"24a 64 streams, device decode and frontend: "
                             f"launches {here} for {n} engine steps; want "
                             f"one fused_fsmn_kernel and one fused_fbank "
                             f"launch a step")
    print(f"  24a {' '.join(PATH_M_SLO_ARGS)} on the recipe's model: {line}; "
          f"{n} engine steps, one fused_fsmn_kernel and one fused_fbank "
          f"launch each [{card}]", flush=True)
    launches = {f"24a the recipe's stage 4 ({SLO_TOOL})": stage_counts,
                "24a 64 streams, device decode and frontend": here}
    figures = {"stage_4": [json.loads(x) for x in stage],
               "stage_4_engine_steps": steps, "device_decode_frontend": line,
               "device_decode_frontend_steps": n}
    return launches, shapes, figures


def phase24b_detection(dev, card, tmp):
    """24b: ``bench_serving_slo``'s detection mode on the JAX CTC fixture
    (keyword 123, PATH_M_UTTS utterances in 100 ms chunks, every
    utterance's tail line): fused on the card, then by the module route on
    the CPU in this process: the same misses and the same activation
    frame for every utterance; one ``fused_fsmn_kernel`` launch a model
    call on the card.  Returns ({sub-path: launches}, figures)."""
    from wekws_tpu_torch.tools import bench_serving_slo

    config, _ = fixture_config(CTC_FIXTURE, CTC_RECIPE, tmp,
                               "fsmn_ctc_fixture_24.yaml")
    argv = ["--config", config, "--checkpoint",
            os.path.join(CTC_FIXTURE, "avg_5.ckpt"), "--tokens",
            os.path.join(CTC_RECIPE, "dict", "dict.txt"), "--keyword",
            CTC_RECIPE_KEYWORD, "--mode", "detection", "--utts",
            str(PATH_M_UTTS), "--dump_tail", str(PATH_M_UTTS)]
    with EngineSteps() as counted:
        zero_counts()
        card_lines = tool_lines(bench_serving_slo.main,
                                argv + ["--device", dev.type])
        here = {k: v for k, v in read_counts().items() if v}
    cpu_lines = tool_lines(bench_serving_slo.main, argv + ["--device", "cpu"])
    (got,), (want,) = (slo_lines(lines[:1], f"24b on the {where}",
                                 streams=[])[1]
                       for lines, where in ((card_lines, "card"),
                                            (cpu_lines, "CPU")))
    tails = [[json.loads(x)["tail"] for x in lines[1:]]
             for lines in (card_lines, cpu_lines)]
    frames = [{t["utt"]: t["act_frame"] for t in ts} for ts in tails]
    if (got["missed"] != want["missed"] or frames[0] != frames[1]
            or len(frames[0]) != PATH_M_UTTS - got["missed"]):
        raise AssertionError(f"24b: the card's detections {got}, {frames[0]} "
                             f"differ from the CPU's {want}, {frames[1]}")
    if got["missed"] == PATH_M_UTTS:
        raise AssertionError("24b: no detection: the check is vacuous")
    n = counted.counts["single"]
    if here != {"fused_fsmn_layers": n}:
        raise AssertionError(f"24b: launches {here} for {n} model calls; "
                             f"want one fused_fsmn_kernel launch a call")
    gap = max(abs(a["hit_score"] - b["hit_score"])
              for a, b in zip(sorted(tails[0], key=lambda t: t["utt"]),
                              sorted(tails[1], key=lambda t: t["utt"])))
    print(f"  24b the JAX CTC fixture, {PATH_M_UTTS} utterances in 100 ms "
          f"chunks, fused on the card: {card_lines[0]} [{card}]", flush=True)
    for line in card_lines[1:4]:
        print(f"  24b tail (card): {line}", flush=True)
    print(f"  24b the module route on the CPU: the same {got['missed']} "
          f"misses and activation frames for all {len(frames[0])} "
          f"detections (largest printed hit-score gap {gap:.4f}); {n} model "
          f"calls, one fused_fsmn_kernel launch each", flush=True)
    return ({"24b the fixture's detections on the card": here},
            {"card": got, "cpu": want, "tails": tails[0][:3],
             "hit_score_gap": gap})


def phase24c_drift(dev, card, tmp):
    """24c: ``drift_sweep`` on the JAX CTC fixture over the synthetic CTC
    corpus's test list (``PATH_M_DRIFT_ARGS``) on the card: no event-set
    divergence and the largest score gap within CTC_SCORE_TOL at each
    threshold (C.4), a threshold with detections by both; one
    ``fused_fsmn_kernel`` launch an engine step.  Returns ({sub-path:
    launches}, figures)."""
    from wekws_tpu_torch.tools import drift_sweep

    config, _ = fixture_config(CTC_FIXTURE, CTC_RECIPE, tmp,
                               "fsmn_ctc_fixture_24.yaml")
    argv = ["--config", config, "--checkpoint",
            os.path.join(CTC_FIXTURE, "avg_5.ckpt"), "--token_file",
            os.path.join(CTC_RECIPE, "dict", "dict.txt"), "--keywords",
            CTC_RECIPE_KEYWORD, "--test_data",
            os.path.join(corpus("ctc"), "test.list"), *PATH_M_DRIFT_ARGS,
            "--device", dev.type]
    with EngineSteps() as counted:
        zero_counts()
        lines = tool_lines(drift_sweep.main, argv)
        here = {k: v for k, v in read_counts().items() if v}
    rows = [DRIFT_LINE.match(line) for line in lines[1:-1]]
    if (len(rows) != 2 or not all(rows)
            or not lines[-1].startswith("SUMMARY: ")):
        raise AssertionError(f"24c: {lines}")
    for line in lines:
        print(f"  24c {line} [{card}]", flush=True)
    if any(int(m[2]) or float(m[6]) > CTC_SCORE_TOL for m in rows) or \
            not any(int(m[5]) for m in rows):
        raise AssertionError(f"24c: divergence or a score gap over "
                             f"{CTC_SCORE_TOL}, or no utterance that both "
                             f"decoders detect: {lines}")
    n = counted.counts["batch"]
    if here != {"fused_fsmn_layers": n}:
        raise AssertionError(f"24c: launches {here} for {n} engine steps; "
                             f"want one fused_fsmn_kernel launch a step")
    print(f"  24c no divergence, score gaps within {CTC_SCORE_TOL} (C.4); "
          f"{n} engine steps, one fused_fsmn_kernel launch each", flush=True)
    return ({"24c the drift sweep": here},
            {"lines": lines, "engine_steps": n})


def path_m(dev, card, work):
    """Phase 24, path M: 24a the serving SLOs (the recipe's stage 4 from
    22b, then the tool here), 24b the fixture's detections card against
    CPU, 24c the drift sweep; 24d each kernel path M launched against its
    plain version at every shape path M gave it, timed at its
    most-launched shape.  Returns ({sub-path: {kernel record:
    launches}}, {kernel record: [readings]}, figures)."""
    import tempfile

    import torch

    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED + 24)
    launches, figures = {}, {}
    with tempfile.TemporaryDirectory() as tmp, ShapeTap() as tap, \
            PlainOnCuda() as plain:
        found, stage_shapes, figures["24a"] = phase24a_slo(dev, card, work,
                                                           gen)
        launches.update(found)
        found, figures["24b"] = phase24b_detection(dev, card, tmp)
        launches.update(found)
        found, figures["24c"] = phase24c_drift(dev, card, tmp)
        launches.update(found)
    plain.check("path M")
    t_runs = time.perf_counter() - t0
    shapes = dict(tap.shapes)
    for key, entry in stage_shapes.items():
        if key in shapes:
            shapes[key][0] += entry[0]
        else:
            shapes[key] = entry
    timed = {max((k for k in shapes if k[0] == name),
                 key=lambda k: shapes[k][0])
             for name in {k[0] for k in shapes}}
    readings = phase17e_kernel_checks(card, shapes, "24d", "M", timed=timed)
    seconds = {"24a-24c": t_runs, "24d": time.perf_counter() - t0 - t_runs}
    print(f"  path M's seconds: {seconds}", flush=True)
    figures["seconds"] = seconds
    return launches, readings, figures


def merge_path_m(record, launches, readings):
    """Path M's launches (by sub-path) and readings into the kernel
    records; fails if a path-M kernel never launched."""
    rows = {r["name"]: r for r in record}
    totals = {}
    for sub, counts in launches.items():
        for name, n in counts.items():
            if n:
                totals[name] = totals.get(name, 0) + n
                rows[name].setdefault("path_m_launches", {})[sub] = n
    missing = [k for k in PATH_M_KERNELS if not totals.get(k)]
    if missing:
        raise AssertionError(f"path M launched no {missing}: {launches}")
    for name, n in totals.items():
        rows[name]["launches"] += n
    for name, rs in readings.items():
        rows[name]["path_m"] = rs
        rows[name]["max_abs_err"] = max(
            [rows[name]["max_abs_err"]] + [r["max_abs_err"] for r in rs])


def path_m_child(work, device="cuda"):
    """``path_m`` in a fresh process (late in the long process the
    profiler loses records); its progress lines, then one line
    ``PATH_M {...}``."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    launches, readings, figures = path_m(torch.device(device), card_line(),
                                         work)
    print("PATH_M " + json.dumps({"launches": launches, "readings": readings,
                                  "figures": figures}), flush=True)


def phase24(card, work, record):
    """Phase 24 in a fresh process, after path K (whose CTC recipe ran
    the stage 4 that path M reads), merged into ``record``."""
    import torch

    with phase("24 path M: the serving SLOs, the fixture's detections, the "
               "decode drift"):
        torch.cuda.empty_cache()
        found = run_child("path_m_child", [work], "PATH_M", 600)
        merge_path_m(record, found["launches"], found["readings"])
        print(f"  launches on path M: {found['launches']} [{card}]",
              flush=True)
        print(json.dumps({"path_m_figures": found["figures"], "card": card}),
              flush=True)


def path_m_alone(dev, card, kind, head):
    """``chip_smoke.py --phase 24``: 22b's CTC recipe alone (stages 0-1
    beside the build in ``head``, 2-5 here, tapped), path M in this
    process, then the last lines (path M's kernels' records)."""
    import torch

    from wekws_tpu_torch.ops import cuda_build

    work = os.path.join(cuda_build.BUILD_DIR, "chip_smoke")
    with phase("22b the scale CTC recipe alone"):
        k_launches = phase22b_scale_recipes(
            dev, card, torch.Generator().manual_seed(SEED + 22),
            lambda: None, head.finish(), SCALE_RUNS[1:])[0]
        print(f"  launches on 22b's CTC recipe: {k_launches} [{card}]",
              flush=True)
    record = [{"name": n, "launches": 0, "max_abs_err": 0.0}
              for n in PATH_M_KERNELS]
    with phase("24 path M: the serving SLOs, the fixture's detections, the "
               "decode drift"):
        launches, readings, figures = path_m(dev, card, work)
        merge_path_m(record, launches, readings)
        print(f"  launches on path M: {launches} [{card}]", flush=True)
        print(json.dumps({"path_m_figures": figures, "card": card}),
              flush=True)
    return last_lines(card, record, kind)


SERVING_KERNELS = {"fused_frontend": 6, "fused_mdtc": 15 + 25 + 3}


def kernel_instance(entry):
    """``fused_fbank_kernel<9>``, ``fused_fbank_dense_kernel``,
    ``fused_mdtc_kernel<64, 2, 1>`` or ``fused_ds_tcn_kernel<48, 1, 2>``
    from a mangled entry name, else None."""
    for kern in ("fused_fbank_kernel", "fused_mdtc_kernel",
                 "fused_ds_tcn_kernel"):
        args = entry.partition(f"{kern}ILi")[2]
        if args:
            vals = [a.lstrip("Li") for a in args.split("EE")[0].split("E")]
            return f"{kern}<{', '.join(vals)}>"
    if "fused_fbank_dense_kernel" in entry:
        return "fused_fbank_dense_kernel"
    return None


TRAIN_REPLACES = {
    "f1": "wekws_tpu/ops/fused_mdtc_train.py:100",
    "f2": "wekws_tpu/ops/fused_mdtc_train.py:111",
    "f3": "wekws_tpu/ops/fused_mdtc_train.py:131",
    "f4": "wekws_tpu/ops/fused_mdtc_train.py:161",
    "b1": "wekws_tpu/ops/fused_mdtc_train.py:180",
    "b2": "wekws_tpu/ops/fused_mdtc_train.py:198",
    "b3": "wekws_tpu/ops/fused_mdtc_train.py:231",
    "b4": "wekws_tpu/ops/fused_mdtc_train.py:284",
}


def main(argv) -> int:
    import torch

    only = argv[1] if len(argv) == 2 and argv[0] == "--phase" else None
    if argv and only not in ("20", "21", "22", "23", "24"):
        print(f"chip_smoke: unknown arguments {argv}; run it with none, or "
              f"with --phase 20 for path I alone, --phase 21 for path J "
              f"alone, --phase 22 for path K alone, --phase 23 for path L "
              f"alone, --phase 24 for path M alone", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1

    from wekws_tpu_torch.ops import cuda_build

    head = head_l = None
    work = os.path.join(cuda_build.BUILD_DIR, "chip_smoke")
    if only in (None, "24"):
        # the shared corpora and paths K's and L's CPU stages on the cores
        # that the build leaves idle
        for name in CORPORA if only is None else ["ctc"]:
            start_corpus(name)
    try:
        if only in (None, "22"):
            head = PathKHead(work)
        if only == "24":  # path M reads the scale CTC recipe's stage 4
            head = PathKHead(work, SCALE_RUNS[1:])
        if only in (None, "23"):
            head_l = PathLHead(work)
        return smoke(only, head, head_l)
    finally:
        stop_corpora()
        for h in (head, head_l):
            if h is not None:
                h.close()


def smoke(only, head, head_l):
    """``main`` after its checks: the phases (``only``: 20, 21, 22, 23, 24
    or None for all), ``head`` path K's ``PathKHead`` (None but for 22,
    24 (the CTC recipe alone) and all), ``head_l`` path L's ``PathLHead``
    (None but for 23 and all)."""
    import torch

    from wekws_tpu_torch.ops import cuda_build
    from wekws_tpu_torch.ops.fused_mdtc import (
        extract_mdtc_weights,
        fused_mdtc_forward,
        fused_mdtc_forward_plain,
        fused_mdtc_stream,
        fused_mdtc_stream_plain,
        init_stream_cache,
    )
    from wekws_tpu_torch.ops.fused_tcn import fused_ds_tcn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    with phase("1 card"):
        card = card_line()
        print(card, flush=True)
        print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"{kind}, {torch.cuda.device_count()} device(s)", flush=True)

    with phase("2 build kernels"):
        t0 = time.perf_counter()
        paths = cuda_build.build()
        for name in cuda_build.KERNEL_SOURCES:
            for line in cuda_build.build_logs.get(name, "").splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {name}: {line.strip()}")
        # the redesigned passes by name: 128 registers or fewer leave
        # two blocks of 256 threads on an SM
        found = 0
        train_log = cuda_build.build_logs.get("fused_mdtc_train", "")
        for entry, regs, st, ld in cuda_build.parse_ptxas_log(train_log):
            for kern in REDESIGNED_KERNELS:
                width = entry.partition(f"{kern}ILi")[2].partition("E")[0]
                if width:
                    found += 1
                    print(f"  fused_mdtc_train {kern}<{width}>: {regs} "
                          f"registers, {st} bytes spill stores, {ld} bytes "
                          f"spill loads")
        if train_log and found != 3 * len(REDESIGNED_KERNELS):
            # (no log when the library was there)
            raise AssertionError(f"expected ptxas lines for "
                                 f"{', '.join(REDESIGNED_KERNELS)} at C = "
                                 f"32, 64, 128, found {found}")
        # the FSMN kernel by its template arguments: lanes over the owned
        # proj channels and affine columns, blocks an SM
        fsmn_log = cuda_build.build_logs.get("fused_fsmn", "")
        found = 0
        for entry, regs, st, ld in cuda_build.parse_ptxas_log(fsmn_log):
            args = entry.partition("fused_fsmn_kernelILi")[2]
            if args:
                found += 1
                lp, ll, mb = (a.lstrip("Li") for a in args.split("E")[0:3])
                print(f"  fused_fsmn fused_fsmn_kernel<{lp}, {ll}, {mb}>: "
                      f"{regs} registers, {st} bytes spill stores, {ld} "
                      f"bytes spill loads")
        if fsmn_log and found != 8:
            raise AssertionError(f"expected ptxas lines for 8 "
                                 f"fused_fsmn_kernel instantiations, found "
                                 f"{found}")
        # the fbank kernels (FFT plan by log2 n_fft and frames a block;
        # the dense plan) and the MDTC serving kernel (by C, rows a
        # thread, splits of the depth)
        for source, want in SERVING_KERNELS.items():
            log = cuda_build.build_logs.get(source, "")
            found = 0
            for entry, regs, st, ld in cuda_build.parse_ptxas_log(log):
                name = kernel_instance(entry)
                if name:
                    found += 1
                    print(f"  {source} {name}: {regs} registers, {st} bytes "
                          f"spill stores, {ld} bytes spill loads")
            if log and found != want:
                raise AssertionError(f"expected ptxas lines for {want} "
                                     f"kernels of {source}, found {found}")
        print(f"  built {len(paths)} librar(ies) in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    if only == "20":
        return path_i_alone(dev, card, kind)
    if only == "21":
        return path_j_alone(dev, card, kind)
    if only == "22":
        return path_k_alone(dev, card, kind, head)
    if only == "23":
        return path_l_alone(dev, card, kind, head_l)
    if only == "24":
        return path_m_alone(dev, card, kind, head)

    gen = torch.Generator().manual_seed(SEED)
    model, _ = seeded_model(FLAGSHIP_MODEL_CONF, gen)
    mdtc = model.backbone
    *stacks, dilations = extract_mdtc_weights(mdtc)
    weights = tuple(w.to(dev) for w in stacks)
    k, stack_size = mdtc.kernel_size, mdtc.stack_size
    n_layers = len(dilations)
    pad_max = (k - 1) * max(dilations)
    errs = {"fused_mdtc_forward": 0.0, "fused_mdtc_stream": 0.0}

    def feats_like(b, t):
        return torch.randn((b, t, CHANNELS), generator=gen).to(dev)

    with phase("3 kernels vs plain (flagship width)"):
        # the flagship's weights at C=64, seeded weights at the flagship's
        # depth for C=32 and C=128; whole utterances and one streaming
        # chunk (a random cache) at each shape, output and new cache
        # against the plain version, each launched twice (bitwise equal)
        wide = {64: weights}
        for c in (32, 128):
            wide[c] = tuple(w.to(dev) for w in mdtc_weights(
                c, n_layers, k, gen))

        def hold_mdtc(b, t, c, w, dil):
            pad = (k - 1) * max(dil)
            x = torch.randn((b, t, c), generator=gen).to(dev)
            c0 = torch.randn((len(dil), b, pad, c), generator=gen).to(dev)
            got = fused_mdtc_forward(x, *w, dil, k, stack_size)
            again = fused_mdtc_forward(x, *w, dil, k, stack_size)
            got_y, got_c = fused_mdtc_stream(x, c0, *w, dil, k, stack_size)
            again_y, again_c = fused_mdtc_stream(x, c0, *w, dil, k,
                                                 stack_size)
            torch.cuda.synchronize()
            want = fused_mdtc_forward_plain(x, *w, dil, k, stack_size)
            want_y, want_c = fused_mdtc_stream_plain(x, c0, *w, dil, k,
                                                     stack_size)
            what = f"B={b} T={t} C={c}"
            if pad != pad_max:
                what += f" pad_max={pad}"
            plan = mdtc_plan_text(b, t, c, k, pad)
            quiet = (b, t) != (N_UTTS, 198) or c != CHANNELS
            errs["fused_mdtc_forward"] = max(
                errs["fused_mdtc_forward"],
                check_close(f"fused_mdtc_forward {what} ({plan})", got,
                            want))
            errs["fused_mdtc_stream"] = max(
                errs["fused_mdtc_stream"],
                check_close(f"fused_mdtc_stream {what} output", got_y,
                            want_y, quiet=quiet),
                check_close(f"fused_mdtc_stream {what} new cache", got_c,
                            want_c, quiet=quiet))
            if not (torch.equal(got, again) and torch.equal(got_y, again_y)
                    and torch.equal(got_c, again_c)):
                raise AssertionError(f"fused_mdtc {what}: two launches "
                                     f"differ")

        for b, t, c in MDTC_CASES:
            hold_mdtc(b, t, c, wide[c], dilations)
        long_w = {c: tuple(w.to(dev) for w in mdtc_weights(
            c, len(LONG_HALO_DILATIONS), k, gen)) for c in (64, 128)}
        for b, t, c in LONG_HALO_CASES:
            hold_mdtc(b, t, c, long_w[c], LONG_HALO_DILATIONS)
        print(f"  {len(MDTC_CASES)} shapes (T = 1 to 2048, B = 1 to 64, "
              f"C = 32, 64, 128) and {len(LONG_HALO_CASES)} with pad_max "
              f"{(k - 1) * max(LONG_HALO_DILATIONS)}, offline and one "
              f"streaming chunk each: bitwise equal from launch to launch",
              flush=True)
        b, t, step = 16, 200, 8
        x = feats_like(b, t)
        cache = init_stream_cache(n_layers, b, pad_max, CHANNELS, dev)
        plain_cache = cache.clone()
        outs, plain_outs = [], []
        for s in range(0, t, step):
            chunk = x[:, s:s + step].contiguous()
            y, cache = fused_mdtc_stream(chunk, cache, *weights, dilations,
                                         k, stack_size)
            outs.append(y)
            y, plain_cache = fused_mdtc_stream_plain(
                chunk, plain_cache, *weights, dilations, k, stack_size)
            plain_outs.append(y)
        torch.cuda.synchronize()
        streamed = torch.cat(outs, dim=1)
        full = fused_mdtc_forward(x, *weights, dilations, k, stack_size)
        errs["fused_mdtc_stream"] = max(
            errs["fused_mdtc_stream"],
            check_close("fused_mdtc_stream 25 chunks of 8 vs one-shot "
                        "forward (kernel)", streamed, full),
            check_close("fused_mdtc_stream vs plain stream",
                        streamed, torch.cat(plain_outs, dim=1)),
            check_close("fused_mdtc_stream final cache vs plain",
                        cache, plain_cache),
        )

    launches = {}
    with phase("4 serving slice end to end"):
        work = os.path.join(cuda_build.BUILD_DIR, "chip_smoke")
        os.makedirs(work, exist_ok=True)
        waves = synth_waves(np.random.default_rng(SEED))
        n_frames = serving_slice(
            "flagship", FLAGSHIP_MODEL_CONF, gen, dev, work, waves,
            fused_mdtc_forward, fused_mdtc_stream, launches)

    record = []
    with phase("5 times"):
        shapes = {
            "fused_mdtc_forward": [(64, 198), (4, 1024), (N_UTTS, n_frames)],
            "fused_mdtc_stream": [(N_UTTS, 8)],
        }
        main_shape = {"fused_mdtc_forward": (N_UTTS, n_frames),
                      "fused_mdtc_stream": (N_UTTS, 8)}
        launch_key = {"fused_mdtc_forward": "flagship_offline",
                      "fused_mdtc_stream": "flagship_stream"}
        replaces = {"fused_mdtc_forward": "wekws_tpu/ops/fused_mdtc.py:37",
                    "fused_mdtc_stream": "wekws_tpu/ops/fused_mdtc.py:198"}
        for name, shape_list in shapes.items():
            stream = name == "fused_mdtc_stream"
            for b, t in shape_list:
                x = feats_like(b, t)
                if stream:
                    c0 = torch.randn((n_layers, b, pad_max, CHANNELS),
                                     generator=gen).to(dev)
                    kern = lambda: fused_mdtc_stream(  # noqa: E731
                        x, c0, *weights, dilations, k, stack_size)
                    plain = lambda: fused_mdtc_stream_plain(  # noqa: E731
                        x, c0, *weights, dilations, k, stack_size)
                else:
                    kern = lambda: fused_mdtc_forward(  # noqa: E731
                        x, *weights, dilations, k, stack_size)
                    plain = lambda: fused_mdtc_forward_plain(  # noqa: E731
                        x, *weights, dilations, k, stack_size)
                ms, plain_ms = kernel_vs_plain_ms(kern, plain)
                bound, bound_by = mdtc_bound_ms(
                    b, t, CHANNELS, n_layers, k, mdtc.stack_num, pad_max,
                    stream)
                dev_ms = profiled_device_ms(kern, "fused_mdtc_kernel")
                dev_txt = ("not measured" if dev_ms is None
                           else f"{dev_ms:.4f} ms")
                print(f"  {name} B={b} T={t}: kernel {ms:.4f} ms per call "
                      f"(device time {dev_txt}), plain {plain_ms:.4f} ms, "
                      f"bound {bound:.5f} ms ({bound_by}); "
                      f"{mdtc_plan_text(b, t, CHANNELS, k, pad_max)} "
                      f"[{card}]", flush=True)
                if (b, t) == main_shape[name]:
                    record.append({
                        "name": name, "route": "cuda",
                        "source": "wekws_tpu_torch/csrc/fused_mdtc.cu",
                        "replaces": replaces[name],
                        "launches": launches[launch_key[name]],
                        "max_abs_err": errs[name],
                        "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound, "bound_by": bound_by,
                        "library_ms": None,
                    })

    with phase("6 training kernels vs plain (flagship width)"):
        train_errs, main_calls = phase6_train_kernels(dev, gen)

    with phase("7 training slice end to end"):
        train_dir = os.path.join(work, "train")
        os.makedirs(train_dir, exist_ok=True)
        trainer, state, batch, train_conf = phase7_train_slice(
            dev, train_dir, launches)

    with phase("8 training times"):
        train_record, step_ms = phase8_train_times(
            trainer, state, batch, card, launches, train_errs, main_calls)
        record += train_record

    with phase("9 DS-TCN, FSMN and fbank kernels vs plain (full width)"):
        errs3, bench = phase9_new_kernels(dev, gen, batch)

    with phase("10 path A: DS-TCN served end to end"):
        serving_slice("ds_tcn", DS_TCN_MODEL_CONF, gen, dev, work, waves,
                      fused_ds_tcn, fused_ds_tcn, launches)
        launches["fused_ds_tcn"] = (launches["ds_tcn_offline"]
                                    + launches["ds_tcn_stream"])
        # the hi_xiaowen DS-TCN (C = 256: W streamed in slices)
        serving_slice("ds_tcn_256", DS_TCN_WIDE_MODEL_CONF, gen, dev, work,
                      waves, fused_ds_tcn, fused_ds_tcn, launches,
                      DS_TCN_WIDE_DATASET_CONF, DS_TCN_WIDE_KEYWORDS)

    with phase("11 path B: FSMN-CTC served by KeyWordSpotter"):
        chunk_ms = phase11_fsmn_ctc(dev, gen, work, waves, launches)

    with phase("12 path C: training with the fused frontend"):
        fused_trainer, fused_state = phase12_fused_frontend(
            dev, trainer, train_conf, batch, launches)

    with phase("13 times of the later kernels and paths"):
        record += phase13_times(dev, bench, errs3, launches, card, trainer,
                                state, fused_trainer, fused_state, batch,
                                step_ms, chunk_ms)

    with phase("14 recipe: bin.train, average, score, DET, JAX fixture"):
        recipe_exp = os.path.join(work, "recipe_exp")
        recipe_rates = phase14_recipe(dev, card, recipe_exp)

    with phase("15 path D, CTC: FSMN-CTC training, the CTC recipe, the "
               "JAX fixture"):
        ctc_launches = phase15_ctc(dev, card, work)
        fsmn = next(r for r in record if r["name"] == "fused_fsmn_layers")
        fsmn["launches"] += sum(ctc_launches.values())
        fsmn["path_d_launches"] = ctc_launches
        print(f"  fused_fsmn_layers launches on path D: {ctc_launches}; "
              f"{fsmn['launches']} with path B's", flush=True)
        # the launches of paths B and D that each timed shape stands for
        # (a streamed chunk timed at T=10), and the device time they lose
        # to the bound
        by_shape = {
            ("hi_xiaowen", 1, 10): (launches["fused_fsmn_layers"]
                                    - launches["fsmn_offline"]),
            ("hi_xiaowen", N_UTTS, 66): (launches["fsmn_offline"]
                                         + ctc_launches["train_offline"]),
            ("synthetic_ctc", 1, 10): (ctc_launches["recipe_stream"]
                                       + ctc_launches["fixture_stream"]),
            ("synthetic_ctc", 256, 66): sum(
                ctc_launches[f"{p}_{k}"] for p in ("recipe", "fixture")
                for k in ("score", "score_dd")),
        }
        if sum(by_shape.values()) != fsmn["launches"]:
            raise AssertionError(f"fused_fsmn_layers: {by_shape} do not add "
                                 f"up to {fsmn['launches']} launches")
        for key, row in zip(FSMN_TIMED_SHAPES, [fsmn] + fsmn["also"]):
            row["shape_launches"] = by_shape[key]
            ms = row["ms"] if row["device_ms"] is None else row["device_ms"]
            row["lost_ms"] = by_shape[key] * (ms - row["bound_ms"])
            print(f"  fused_fsmn_layers {fsmn_shape_name(key)}: "
                  f"{by_shape[key]} launches x ({ms:.4f} - "
                  f"{row['bound_ms']:.5f}) ms = {row['lost_ms']:.3f} ms lost "
                  f"to the bound [{card}]", flush=True)

    with phase("16 path E: classification and the other backbones"):
        e_launches, e_readings = phase16_classification(dev, card, work,
                                                        waves)
        rows = {r["name"]: r for r in record}
        for name, n in e_launches.items():
            rows[name]["launches"] += n
            rows[name]["path_e_launches"] = n
        for key, reading in e_readings.items():
            row = rows["fused_mdtc_forward" if key.startswith(
                "fused_mdtc_forward") else key]
            row.setdefault("path_e", []).append(reading)
            row["max_abs_err"] = max(row["max_abs_err"],
                                     reading.get("max_abs_err", 0.0))
        print(f"  launches on path E: {e_launches} [{card}]", flush=True)

    with phase("17 path F: the serving daemon"):
        f_launches, f_readings, f_err, figures = phase17_serving(
            dev, card, work)
        merge_path_f(record, f_launches, f_readings, f_err)
        print(f"  launches on path F: {f_launches} [{card}]", flush=True)
        print(json.dumps({"path_f_figures": figures, "card": card}),
              flush=True)

    with phase("18 path G: device-resident epochs"):
        g_launches, g_readings, g_figures, g_rates = phase18_resident(
            dev, card, train_conf, batch, step_ms, recipe_rates)
        merge_path_g(record, g_launches, g_readings)
        print(f"  launches on path G: {g_launches} [{card}]", flush=True)
        print(json.dumps({"path_g_figures": dict(
            g_figures, cli_audio_s_per_s=g_rates,
            host_fed_cli_audio_s_per_s=recipe_rates), "card": card}),
            flush=True)

    with phase("19 path H: export and static int8"):
        h_launches, h_readings, h_figures = phase19_artifacts(
            dev, card, work, recipe_exp)
        merge_path_h(record, h_launches, h_readings)
        print(f"  launches on path H: {h_launches} [{card}]", flush=True)
        print(json.dumps({"path_h_figures": h_figures, "card": card}),
              flush=True)

    phase20(dev, card, work, train_conf, record)
    phase21(dev, card, record)
    phase22(card, work, record, head)
    phase23(card, record, head_l)
    phase24(card, work, record)
    return last_lines(card, record, kind)


for _name in [n for n in globals() if re.fullmatch(TIMED_PARTS, n)]:
    globals()[_name] = timed_part(globals()[_name])

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
