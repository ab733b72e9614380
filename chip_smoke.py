#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``fmc_uia_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and turned into a
pass):

1. env — the card's name and power limit, and the kernels' build time
   (nvcc, from ``fmc_uia_tpu_torch/csrc``), ptxas' registers, spills and
   wgmma serialisation notes (C7512 / C7515), and the HGMMA / UTMALDG /
   HMMA counts of the SASS (``cuobjdump``) of the K4 kernels and of the K1
   and K2 functions that run a product (``PRODUCTS``): a bf16 one without
   HGMMA and UTMALDG fails, and so does any HMMA (a WMMA product) in the
   K1 and K2 libraries; K3's chunk kernel (``preprocess_fwd_vec``, bf16
   and f32) without 16-byte global loads and stores (LDG.E.128,
   STG.E.128) fails too (K3's static opcode counts are printed).
2. kernels — each hand-written forward kernel (K1f, K2f) against its
   plain PyTorch version on the card, in f32 (TF32 off) and bf16, at the
   swin_b 512² stage shapes of a batch of 8 (K1f: four stages, shifted
   and unshifted, a padded grid, a window-7 case and a head-dim-16 case;
   K2f: stages 0 and 1, swin_t's widths C = 96 and 192, C = 32, 64, 160
   and 224, so that every instance the library builds runs, and a ragged
   case of 147 tokens whose dp changes inside a 128-token tile), and at
   the submit preset's (phase 9: swin_b 224², window 7; K1f at the four
   stages, 56² x 128 to 7² x 1024, shifted by 3 where the grid exceeds
   the window; K2f at 56² x 128 and 28² x 256); max error
   against the stated tolerance (scaled to the branch, not to the
   residual); at the stage shapes CUDA-event medians of one call of the
   kernel, the plain version and the bound; in bf16 also ``ms_10``, per
   call of 10 back-to-back calls (device time without the host's launch
   gaps), the library chain (``k1_chain``: layer_norm, linear, SDPA with
   the bias and mask as attn_mask, linear, residual; ``k2_chain``:
   layer_norm, linear, gelu(tanh), linear, residual) as ``chain_ms`` and
   ``chain_ms_10``, for information only, and the host time of one call
   with the card idle (``host_ms``).
2b. backward kernels — K1b and K2b against their plain backward versions,
   f32 and bf16, at the stage shapes of the B=24 train step (K1b at all
   four stages, shifted and unshifted, a padded grid and a window-7 case;
   K2b at K2f's cases, the stages at B=24) and of the submit preset's
   B=64 train step (phase 2's submit cases): dx per element (one ulp of its
   own magnitude plus 1e-4 / 4 bf16 ulps of max|dx - dy|), every
   weight/bias grad within 1e-3 (f32) / 2e-2 (bf16) of its largest
   magnitude; at the stage shapes kernel, plain and bound ms (one call),
   and in bf16 ``ms_10``, ``host_ms`` and the chain's autograd backward as
   ``chain_ms`` and ``chain_ms_10``; for bf16 K2b also ``floor_ms``, the
   bytes its passes move (``k2b_pass_bytes``) at the HBM rate (printed
   and kept per case, not in the kernels line), and its workspace against
   ``mlp_bwd_plan``'s (the host's mirror of the carving, which sizes the
   buffer; a difference fails). bf16 K1b at stage 2 (shifted and not)
   and bf16 K2b at stage 0 run twice on the same inputs and every output
   must agree bitwise. On the same inputs K1f and K2f are held against
   their plain forward versions as in phase 2, since the train step runs
   them at these shapes.
2c. K3 — the fused photometric preprocessing kernel
   against its plain version, f32 and bf16, at B=24, 512², at the submit
   preset's fit step (B=64, 224²) and at the edge shapes (an odd P, [3,
   17, 23, 3]; C = 1 and C = 4; B = 1; a view at offset 1 into a larger
   buffer): sigma = 0 with alpha/beta that
   saturate both clips (bitwise); p = 1 for both ops with the generator's
   draws (f32 within 1e-5, bf16 within one bf16 ulp of the output: both
   sides draw the same Philox bits; at B=24 also the train path's draws);
   p = 0 against ``normalize_images`` (5e-7 in f32); the noise law on the
   kernel's own output on both kernels (sigma = 5 on a constant 128: mean
   and std within 0.05). ``preprocess_fwd`` chooses its kernel; every
   call must take the one its shape calls for (the odd P and the view:
   the edge kernel; the rest: the chunk kernel). Then bf16 at B=24 on
   three cases: (a) the train path's draws (p = 0.2 / 0.1 from a fixed
   generator seed; the images with sigma > 0 are counted), (b) p = 1, (c)
   p = 0: one call between CUDA events (``ms``, host time included), per
   call of 50 back-to-back calls (``ms_50``; at K3's size the wrapper's
   host time a call is about the kernel's), the kernel's own device time
   a launch (``device_ms``, ``torch.profiler``) and the bound, each
   instruction class the function needs (``k3_bound``: integer
   multiplies and ALU integer work at 64, f32 at 128, special functions
   and conversions at 16 a clock per SM, at ``clocks.max.sm`` × the SMs;
   noise counted for the noisy images only) against the bytes at 3.35
   TB/s, the binding class printed; on (a) the plain and unfused
   ``augment_and_normalize`` ms.
2d. K4 — the ViT global-attention kernels (K4f forward, K4b backward)
   against their plain versions at the DINOv3 ViT-B/8 512² shapes (12
   heads x 64, N = 4101) in f32 (TF32 off) and bf16: K4f at B=8 (serving)
   and B=24 (train), K4b at B=24, a tail case (B=2, N = 1029) and the
   bf16 kernels' tile edges (B=1, N = 128, 129, 257); each
   element within one ulp of its own magnitude plus 1e-4 (K4f) / 1e-3
   (K4b) of its (b, h) slice's largest magnitude in f32, 4 bf16 ulps of
   it in bf16; the lse within 1e-5. The dense plain versions run in chunks
   of 2 images. At B = 8 / 24 the bf16 kernels run twice on the same
   inputs and must agree bitwise. bf16 times (kernel and SDPA: per call
   of 10 back-to-back calls, so the host's launch gaps are not counted):
   kernel, plain, bound (the
   least work: tensor-core operations, exponentials at the special-
   function units' rate, bytes; the largest) and SDPA as the library
   yardstick (never on the port's path): its forward for K4f, its
   backward alone for K4b (forward + backward beside it).
3. model — the flagship 27-task swin_b 512² model (random weights from a
   seed) in bf16 through ``Predictor`` on batches of 8, one task of each
   type; held against the same weights in f32 on the card, and in f32 on
   the CPU for one image; the launch counters must rise by 24 and 4 per
   forward; the host cost of enqueueing one forward, and a
   ``torch.profiler`` table of one forward
   (``chiprun_out/profile_forward.txt``).
4. serving — ``StreamingPredictor(max_batch=8)`` after ``warmup()``
   serves a closed loop of 64 outstanding requests, round-robin over the
   4 task types, for at least 8 s, three times; every result is held
   against ``Predictor`` (at B=8, or where it differs there, at a padded
   size the run dispatched); per run img/s, p50/p99 and the dispatch stats,
   and their median and spread over the runs. The launch counters are
   zeroed just before the first request and read just after the last:
   this is the main path's count.
5. train — the flagship ``Trainer`` (bf16, B=24, random weights from a
   seed) on one batch per task type made as bench.py makes them: a warm-up
   step per type; a timed round-robin of at least 6 s (img/s, ms per step
   per type from CUDA events, peak memory), the launch counters zeroed just
   before it and required to rise by 24/24/4/4 (K1f/K1b/K2f/K2b) per step,
   every loss finite; the host ms of enqueueing one step per type with
   the card idle; one profiled step per type (device-time shares by
   kernel group, K1f, K2f, K2b and K1b apart by kernel name and pass tag,
   ``chiprun_out/profile_train_step.txt``); ten steps on one
   fixed batch per type (a bright square to segment, detect or locate; a
   bright or dark image to classify), whose last three losses must average
   below the first; one step's grads in f32 on the card against f32 on the
   CPU (B=1, 256², the same batches, augmentation and dropout off), every
   leaf within 1e-3 of its largest magnitude. Where the two runs put a
   value on different sides of a kink (a ReLU input of the other sign, a
   deformable sample in another bilinear cell), the CPU takes the card's
   side there (``KinkAlign``); the gap between the two sides' values
   must be rounding, within 1e-4 of their range, and the kinks taken are
   counted and printed. The same check ends phases 8, 9 and 10.
6. fit — the flagship trained from disk: a 27-task synthetic dataset of
   576x768 PNG frames (30 per task) written by the port's generator into a
   temporary directory; ``fit`` with ``data.fused_preprocess`` for 2
   epochs of 12 steps (validation and a checkpoint each epoch), then
   ``fit(resume=True)`` to epoch 3. The launch counters are zeroed just
   before the first ``fit`` and read just after the second: K3 once per
   train step, always its chunk kernel, K1b/K2b 24/4 per train step, K1f/K2f 24/4 per train step
   and evaluation batch. Prints the host ms of one frame's decode steps
   and resize, the host ms per batch (decode + resize + collate), the
   share of each epoch's loop spent waiting on the prefetch
   queue, img/s of the epoch loops beside phase 5's staged img/s, the
   losses, the validation rows and the resume facts. Fails on a
   non-finite loss, a wrong launch count, a resume that does not start at
   epoch 2 or a history without 3 epochs.

7. DINOv3 serving — the DINOv3 ViT-B/8 512² preset
   (``dino_patch8_config_dict``: RoPE, LayerScale, 4 storage tokens,
   'resize' adapter, the flagship's FPN/FiLM/27 heads; random weights from
   a seed) in bf16 through ``Predictor`` at B=8: K4f must launch 12 times
   a forward; held against f32 on the card at B=8 (10 %, decoded ids
   equal except at near ties) and f32 on the CPU for one 256² image (N =
   1029, 1e-3); then one closed loop of 64 outstanding requests through
   ``StreamingPredictor`` for >= 8 s, results held against
   ``Predictor``: img/s, p50/p99, K4f launches = 12 x dispatches.
8. DINOv3 training — phase 5 on the DINOv3 preset (``freeze_dino``: the
   backbone's grads are computed and clipped, not applied): warm-up, a
   timed round-robin of >= 6 s (img/s, ms per step per type, peak
   memory; K4f and K4b 12 each a step), a profiled step per type
   (``chiprun_out/profile_dino_train_step.txt``), the fixed-batch falling
   loss, and f32 grads card vs CPU at B=1 256² of the segmentation step
   (its loss reads every block; the heads are phase 5's) for every leaf,
   the backbone and ``rope_periods`` included.
9. submit — the ``configs/submit.yaml`` preset (``submit_config_dict``:
   swin_b at 224², window 7 (N = 49 tokens a window), the dense MoE of 8
   conv experts, top-2, at encoder stages 2 and 3, adaptive loss weights,
   27 tasks; random weights from a seed). (a) bf16 through ``Predictor``
   at B=8, one task of each type, against f32 on the card with phase 3's
   rules (an image whose MoE top-2 choice differs in bf16 and f32 is left
   out, and may differ only where the f32 2nd and 3rd gates are within
   ``BF16_ROUTE_MARGIN``, 0.011; at most 1 in 8 of the images may be
   left out; the count and the largest gate move are printed), one
   image f32 on the CPU against f32 on the card (1e-3), and the MoE
   blocks' top-2 choices on all 8 images f32 card vs CPU (equal except
   within 1e-4 of a tie); K1f 24 and K2f 4 launches a forward. (b) one
   closed loop of 64 outstanding requests through
   ``StreamingPredictor(max_batch=8)`` for >= 8 s, every result held
   against ``Predictor``, K1f/K2f 24/4 x dispatches: img/s, p50/p99.
   (c) phase 5 at B=64, 224²: warm-up, the timed round-robin (img/s, ms
   a step per type, peak memory, launches 24/24/4/4 a step, every loss
   and ``moe_aux`` finite, ``moe_importance`` summing to 1 and
   ``moe_load`` to 2 within 1e-5), the enqueue ms, one profiled step per
   type with the MoE blocks' device time (forward: the ``moe_block``
   ranges; backward: the autograd nodes with those ops' sequence numbers;
   ``chiprun_out/profile_submit_train_step.txt``), phase 5's ten steps on
   one fixed batch per type (the loss must fall), and f32 grads card vs
   CPU at B=1, 224² (weights from seed 3), every leaf within 1e-3 of its
   largest magnitude, the ``moe_stage*`` leaves included, except the
   router of a block the head does not read, whose exact grad is 0 (held
   within 1e-6 of the step's largest grad). (d) ``fit`` from 288x384 PNGs
   (27 tasks x 80, one unreadable; above 224 on both axes, so the host
   resizes) for 2 epochs of 6 steps with K3 (K3
   once a train step on its chunk kernel; K1f/K2f per step and eval
   batch, K1b/K2b per step), ``moe_stats.csv`` with rows for both epochs;
   then ``python -m fmc_uia_tpu_torch.predict`` in a subprocess on the
   experiment dir over the first PREDICT_PER_TASK (8) frames of each task
   of the same root (the unreadable one among them): 27 JSONs, one
   record per readable frame, every mask PNG at 288x384 and equal
   bitwise to an in-process
   ``Predictor``'s on the loaded ``best_model.pt``, class ids equal,
   boxes and points within 1e-4 of the frame size. Prints img/s of the
   epoch loops and the seconds of ``predict``.
10. spm — the DINOv3 ViT-L/16 SPM-interaction preset
   (``dinov3_spm_config_dict``: ``configs/vit_large_patch16_dinov3.yaml``
   as it stands; ViT-L at 224², N = 201 tokens, so the einsum attention
   path and no K4; the SPM pyramid, four interaction blocks with the
   deformable cross-attention's bilinear gather; ``freeze_dino``, 27
   tasks; random weights from a seed). (a) bf16 through ``Predictor`` at
   B=8 against f32 on the card (phase 3's rules) and one 224² image f32
   card vs CPU (1e-3); no kernel launches (K4f and K4b 0). (b) one closed
   loop of 64 outstanding requests through ``StreamingPredictor(
   max_batch=8)`` for >= 8 s, held against ``Predictor``: img/s,
   p50/p99. (c) phase 5 at B=64, 224²: img/s, ms a step per type, peak
   memory, enqueue ms, no kernel launches, one profiled step per type with
   the ``spm_adapter`` range's share of the device time (forward: the
   range; backward: the autograd nodes with its ops' sequence numbers;
   ``chiprun_out/profile_spm_train_step.txt``), the fixed-batch falling
   loss, and f32 grads card vs CPU at B=1 224² of the segmentation step
   (its loss reads every interaction block), every leaf within 1e-3 of
   its largest magnitude (the frozen backbone, ``offset_proj`` and
   ``vit_proj*`` included; phase 5's kink rule; should ``offset_proj``
   fail, the count of sample coordinates within 1e-6 of an integer pixel
   is printed first).
   (d) phase 9d's ``fit`` -> ``predict`` on this preset, on phase 9d's
   dataset, one epoch of 6 steps (its timings are smoke timings; a second
   epoch was cut to keep the script within its time limit); K3 once a
   train step on its chunk kernel, no other kernel. (e) ``python -m
   fmc_uia_tpu_torch.serve`` on the fit's experiment dir in a subprocess
   (``--port 0``): ``/healthz``, ``/v1/tasks``, one PNG frame per task
   type answered as ``Predictor`` answers it (masks decoded equal, class
   ids equal, boxes and points within 1e-4 of the frame), 32 concurrent
   requests counted by ``/v1/stats``; the server is killed at the end.

11. cache + pretrained — phase 6's data (the same files, written once
   a run). (a) phase 6's ``fit`` with ``data.device_cache``, 2 epochs of
   24 steps (epoch 2, the measured one, runs about 3 s: a smoke timing),
   validation: the staged MB, img/s, the
   loop's seconds and queue wait per epoch against phase 5's staged and
   phase 6's streaming img/s (limit 0.9 of staged, printed, not failed),
   launches as phase 6, and the first eval batch of every task
   and the first 4 train batches gathered from the cache against a
   streaming engine's, bitwise on the card. (b) a 400 MB budget: the
   tasks that stream are printed and the fit finishes. (c) one epoch of 6
   steps with ``data.use_adaptive_norm``, cached: f32 banks, K3 0. The
   img/s of (b) and (c) are smoke timings (6 steps, warm-up included),
   not throughputs. (d)
   the SPM preset's ``fit`` (3 steps, validation) from a seeded synthetic
   DINOv3 ViT-L/16 checkpoint: the backbone of ``best_model.pt`` bitwise
   the checkpoint's (``freeze_dino``), one segmentation answer f32 card
   vs CPU (1e-3); K3 once a step, no other kernel. (e) the flagship's
   ``fit`` (3 steps) from a swin_b window-12 checkpoint, its tables
   resampled to window 8: K1/K2/K3 counted. (f) ``python -m
   fmc_uia_tpu_torch.utils.convert --verify`` on both files, both at
   once. Each fit's
   counts are zeroed just before it and read just after.
12. ablations — ``ablation_a_config_dict`` and ``ablation_b_config_dict``
   (every option of ROADMAP queue 1 item 7 on the flagship, full width).
   For each: (a) ``Predictor`` at B = 8, one task of each type, launches
   24/4 a forward; every head output (the deep-supervision main and aux
   maps, the grid map) bf16 against f32 on the card (0.1 of the largest)
   and f32 on the card against the CPU at B = 1 (1e-3), decoded ids equal
   but at near ties, grid boxes from the same objectness cell equal
   within the maps' error (another cell only at a near tie). (b) the
   served model trained at B = 24: A four micro-steps a type (params
   bitwise unchanged after the odd ones, changed after the even ones), B
   two steps a type; finite losses, launches 24/24/4/4 a micro-step,
   synced ms a step, img/s and peak memory. (d) ``train_burst``: under
   A it raises, as in JAX; under B 4 steps against 4 ``train_batch``
   calls on a twin from the same state (the first loss bitwise, the
   others within 1e-3, the params within two Adam steps). (c) phase 5's
   f32 grad check, card vs CPU. Then (e) B's ``fit`` (1 epoch of 2 steps,
   validation, checkpoints, K3) on phase 6's data (the same files), and
   ``python -m fmc_uia_tpu_torch.predict`` (8 frames a task, as phase 9)
   held against ``Predictor``
   (grid boxes decoded). Counts are zeroed before each main-path run
   (a, b, d, e) and read after it.
13. encoders — the flagship (512², 27 tasks, bf16, TaskFiLM) with each
   encoder of ROADMAP queue 1 item 8 at full width
   (``flagship.ENCODER_PRESETS``): ResNet-50, ConvNeXt-B
   (``timm:convnext_base``), EfficientNet-B4, swin_b with the fused
   attention on stages 0-1 only (``fused_stages [0, 1]``) and swin_b with
   none (``fused_block: false``). For each: (a) ``Predictor`` at B = 8,
   one task of each type, every kernel's launches exact (the conv
   encoders none; fused01 K1f 4 and K2f 4 a forward; unfused K2f 4); the
   outputs bf16 against f32 on the card (0.1 of the largest) and f32 on
   the card against the CPU at B = 1, 256² (1e-3), decoded ids equal but
   at near ties. (b) the served model trained at B = 24 on staged
   batches: a warm-up round, then PHASE13_ROUNDS timed round-robin rounds
   (each step synced): ms a step per type, img/s, peak memory, finite
   losses, launches exact (fused01 K1f/K1b/K2f/K2b 4 each a step;
   unfused K2f/K2b 4), then phase 5's f32 grad check, card vs CPU (B = 1,
   256², ``KinkAlign``), on the segmentation step alone (its loss reads
   every encoder stage; the heads are phase 5's). The model is freed
   before the next. (c) a seeded torchvision-layout ResNet-50 checkpoint
   (``resnet50_manifest``), ``python -m fmc_uia_tpu_torch.utils.convert
   --verify`` on it in a subprocess on the card beside the resnet50
   preset's ``fit`` from it (1 epoch of 2
   steps, ``fused_preprocess``, validation) on phase 6's data (the same
   files): the BatchNorm warning raised once, K3 2 launches on its chunk
   kernel and no other kernel, the stem conv after the fit within 1e-3 of
   the file's. Counts are zeroed before each main-path run (a, b's timed
   rounds, c's fit) and read after it.
14. parallel modes (``fmc_uia_tpu_torch/parallel``) on the one card. (a)
   the flagship bf16, B = 24, K3 on, under ``parallel.mesh {data: -1}``
   on an NCCL group of one rank in this process, against the plain
   Trainer on the same batches and seed, both with deterministic
   algorithms on (without them the card's bf16 backward is not bitwise
   run to run): the first step's loss and grads, then 3 rounds of 4
   types, every loss within 1e-5 of the plain one's, every leaf of the
   first grads and of the params after the rounds within 1e-5 of its
   max (bitwise expected); launches exact (24/24/4/4 and K3 1 a step),
   img/s of both (smoke timings). Then one gloo group of 2 spawned ranks
   sharing the card (NCCL refuses two ranks on one GPU): (b) DP, f32
   (TF32 off) B = 4 at 512², one step a type, the summed grads against
   one process's, each leaf within 1e-3 of its max or twice the move of
   that leaf's grad in one process under a 1e-7 relative perturbation of
   every weight; bf16 B = 24 (12 a rank), 2 steps a type, finite losses,
   launches exact a rank. (c)
   ZeRO-1 against DP, 2 f32 AdamW steps on the same grads: params within
   1e-6 of each leaf's max (bitwise so far), ``zero_sharded_fraction``.
   (d) TP ``{data: 1, model: 2}``, f32 as (b): grads against (b)'s one
   process (the same rule), the sharded leaves and each rank's parameter
   bytes against ``make_param_specs``. (e) EP: the submit preset with
   ``model.moe.dispatch: ragged`` at zero-drop capacity on ``{model: 2}``,
   B = 64 (32 a rank): the forward against the dense dispatch (phase 9's
   0.1 rule), one step, its ``all_to_all`` count (2 a block forward, 2
   backward). (f) 3 gloo ranks: swin_b 512²'s stage 2 (9 pairs, C = 512,
   a 32² grid) split 3 pairs a rank, 8 microbatches of 3, f32: the
   forward against the sequential stage within 1e-5 of its max, one
   backward, K1f and K1b 48 a rank (6 blocks x 8 microbatches). Every
   part runs; a failed one fails the phase at its end. The multi-rank
   times share one card: smoke timings, not a parallel speed.
15. the fused Swin MLP above C = 256 (``FMC_FUSED_MLP_MAX_C``, set before
   each model is built). (a) K2f and K2b above C = 256 (Ch = 4C; C at
   run time: K2f's two products, K2b's ``mlp_dual_wide_sm90``) against
   their plain versions, f32 and bf16, dp on, phases 2 and 2b's rules:
   C = 512 at the flagship's stage 2 (32² x 512; K2f at B = 8, K2b at
   B = 24), 384 and 768 at swin_t 512²'s stages 2 and 3 (32² x 384, 16² x
   768), and untimed 147 tokens at 384, 768, 640, 960 and 288 (the last
   128-token tile holds 19, dp changes inside the first tile); K2f's
   workspace against ``mlp_fwd_plan``'s and K2b's against
   ``mlp_bwd_plan``'s; per case one call's ms, the plain version's, the
   library chain's (``k2_chain``; its autograd backward alone for K2b;
   information only) and the bound (16 T C² operations forward, 40 T C²
   backward, or the bytes); in bf16 also each kernel's device ms a call
   by name (``kernel_split``, a profiler trace of 3 calls). The build
   step fails on any ptxas spill in K2f's products or
   ``mlp_dual_wide_sm90`` (``check_k2_spills``). (b) the flagship under
   the knob at 512, K3
   on: phase 13a's ``Predictor`` checks (B = 8, one task of each type,
   launches exact: K1f 24, K2f 22 a forward; bf16 against f32 on the
   card within 0.1 of the largest, decoded ids equal but at near ties;
   f32 card against CPU at B = 1, 256², within 1e-3); the same weights
   under 256 and 1024: each stage's flags (the kernel on stages 0-2 at
   512; on 0-1 at 256; at 1024 stage 3 on the JAX XLA branch's math),
   the raw outputs against 512's within 0.1; staged training at B = 24,
   a warm-up round then P15_ROUNDS timed round-robin rounds (synced),
   under 512 and then under 256 from the same seed: finite losses,
   launches exact (K1f/K1b 24, K2f/K2b 22 and 4, K3 1 a step), img/s and
   peak GiB (smoke timings), and 512's img/s over 256's. (c) under
   1024: one counted ``Predictor``
   forward and a warm-up and a timed round of steps, launches as 512's.
   (d) phase 5's f32 grad check of the segmentation
   step, card vs CPU at B = 1, 256², under 512 (the f32 wide kernels on
   the card), ``KinkAlign``; the card's launches those of one step.
   Launches over (b)'s forwards and rounds and (c)'s forward and round
   are the phase's main-path count.

The line before the card's name is ``{"kernels": [...]}`` (K1f/K2f
launches from phase 4, K1b/K2b from phase 5, K3 from phase 6, K4f from
phase 7, K4b from phase 8; phase 9 checks its own counts and leaves the
line as it was; ``launches_spm``: each kernel's launches over phase 10's
serving run, timed training and fit; ``launches_phase11``: over phase
11's fits; ``launches_phase12``: over phase 12's main-path runs;
``launches_phase13``: over phase 13's; ``launches_phase14``: {"a": phase
14a's mesh run, "b_rank": each rank's bf16 DP steps, "f_rank": each
pipeline rank}; ``launches_phase15``: over phase 15's main-path runs);
the last line is ``{"ok": true, "device": {...}}``. Per-case numbers
(phase 15a's per width) also go to ``chiprun_out/chip_smoke.json``.

    python3 chip_smoke.py --staged-train

runs phase 5's staged flagship training alone (warm-up, the timed
round-robin, the enqueue ms and one profiled round; no checks beyond the
launch counts and finite losses) and prints one JSON line.

    python3 chip_smoke.py --k3

builds K3 alone and times phase 2c's three cases (no checks), one JSON
line. Copied into the root of another tree of the port, either mode
times that tree the same way, so that two trees compare within one call
on one card.

    python3 chip_smoke.py --kinks

runs the SPM preset's grad check (phase 10c) with the CPU taking from
the card no kink, the ReLU signs, the bilinear cells, or both, and
prints each way's worst leaf per type (no checks), one JSON line.

    python3 chip_smoke.py --phase11

builds the kernels and runs phase 11 alone (without phases 5 and 6 its
throughput stands alone), one JSON line.

    python3 chip_smoke.py --phase12

builds the kernels and runs phase 12 alone, one JSON line.

    python3 chip_smoke.py --phase13

builds the kernels and runs phase 13 alone, one JSON line.

    python3 chip_smoke.py --phase14

builds the kernels and runs phase 14 alone, one JSON line.

    python3 chip_smoke.py --phase15

builds the kernels (printing the K2 libraries' ptxas lines and checking
the SASS and K2's spills as phase 1 does) and runs phase 15 alone, one
JSON line.

    python3 chip_smoke.py --k2-wide

builds the K2 libraries and runs phase 15a's timed cases alone, one
JSON line of their bf16 times and per-kernel splits; copied into the
root of another tree of the port it times that tree's K2 the same way.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16 = 989e12   # H100 SXM dense bf16 tensor-core FLOP/s
PEAK_F32 = 67e12     # H100 SXM f32 FLOP/s outside the tensor cores
HBM_BPS = 3.35e12    # H100 SXM HBM3 bytes/s
BATCH = 8            # the serving path's largest micro-batch
IMAGE = 512
SERVE_RUNS = 3       # serving runs, each of at least SERVE_S seconds
SERVE_S = 8.0
OUTSTANDING = 64     # requests kept in flight by the closed loop


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3, calls: int = 1) -> float:
    """Median of ``reps`` CUDA-event timings of ``calls`` back-to-back
    ``fn()`` calls, per call. With ``calls`` > 1 the card has the next
    launch queued while it runs one, so a slow host's launch gaps do not
    count as device time."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    times.sort()
    return times[len(times) // 2]


def host_call_ms(fn, reps: int = 20) -> float:
    """Median host time of one ``fn()`` call with the card idle, from the
    call to its return: the wrapper's checks and the launches' enqueue."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    times.sort()
    return times[len(times) // 2]


def bf16_ulp(v: float) -> float:
    """One bf16 ulp at magnitude v (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(max(v, 1e-30))) - 7)


def check_branch(out, ref, x, dtype, what):
    """Hold a kernel's ``x + dp*y`` against its plain version's.

    Wherever y differs at all, the final rounding of the sum may fall one
    ulp of the output apart, so each element may differ by one ulp of its
    own magnitude plus a tolerance scaled to the branch (max |ref - x|,
    the largest dp*y), not to the residual x: f32 1e-4 of it (f32 sums of
    up to 4C products in another order); bf16 4 bf16 ulps of it (y and
    dp*y are each rounded once, at most an ulp apart, and the f32 sums
    behind them differ by far less). Returns a record of the check."""
    import torch

    out, ref, x = out.float(), ref.float(), x.float()
    branch = float((ref - x).abs().max())
    bits = 7 if dtype == torch.bfloat16 else 23
    mag = torch.maximum(out.abs(), ref.abs()).clamp_min(1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - bits)
    diff = (out - ref).abs()
    excess = float((diff - ulp).max())
    tol = (4 * bf16_ulp(branch) if dtype == torch.bfloat16
           else 1e-4 * branch)
    if not excess <= tol:
        fail(f"{what} {dtype}: error beyond one output ulp {excess:.3e} > "
             f"tol {tol:.3e} (branch max {branch:.3e})")
    return dict(max_abs_err=float(diff.max()), branch_max=branch,
                excess_err=excess, tol=tol)


# the bf16 K1 and K2 functions that run a product: each must use wgmma and
# TMA, and their libraries hold no WMMA / mma.sync product
K1_PRODUCTS = {"swin_attn_fwd": ("qkv_window_attn", "gemm_sm90"),
               "swin_attn_bwd": ("attn_core_bwd_sm90", "gemm_sm90")}
K2_PRODUCTS = {"swin_mlp_fwd": ("mlp_fwd_sm90", "gemm_sm90"),
               "swin_mlp_bwd": ("mlp_dual_sm90", "mlp_dual_wide_sm90",
                                "gemm_sm90")}
PRODUCTS = {**K1_PRODUCTS, **K2_PRODUCTS}


def check_sass(build):
    """The bf16 K4 kernels, and every bf16 K1 and K2 function that runs a
    product (``PRODUCTS``), as built must run their products on wgmma
    (HGMMA) and their loads by TMA (UTMALDG), and the K1 and K2 libraries
    must hold no WMMA / mma.sync product (HMMA): counts per kernel from
    ``cuobjdump -sass`` of the built libraries."""
    tool = os.path.join(os.path.dirname(os.path.dirname(build._nvcc())),
                        "bin", "cuobjdump")
    counts = {}
    for k in ("vit_flash_fwd", "vit_flash_bwd", *PRODUCTS):
        out = subprocess.run([tool, "-sass", str(build.lib_path(k))],
                             capture_output=True, text=True, timeout=120)
        if out.returncode != 0:
            fail(f"cuobjdump {k}: {out.stderr.strip()}")
        fn = None
        mine = {}
        for line in out.stdout.splitlines():
            if "Function :" in line:
                fn = line.split("Function :")[1].strip()
                mine[fn] = {"HGMMA": 0, "UTMALDG": 0, "HMMA": 0}
            elif fn:
                for op in mine[fn]:
                    mine[fn][op] += op in line
        for fn, c in mine.items():
            counts[f"{k}:{fn}"] = c
            if k in PRODUCTS:
                product = any(p in fn for p in PRODUCTS[k])
                if product or c["HGMMA"] or c["HMMA"]:
                    log(f"  sass {k} {fn}: {c}")
                if c["HMMA"]:
                    fail(f"{k} {fn}: HMMA (a WMMA / mma.sync product) in "
                         "its SASS")
                if product and not (c["HGMMA"] and c["UTMALDG"]):
                    fail(f"{k} {fn}: no HGMMA or UTMALDG in its SASS")
            else:
                log(f"  sass {fn}: {c}")
                if "bf16" in fn and not (c["HGMMA"] and c["UTMALDG"]):
                    fail(f"{fn}: no HGMMA or UTMALDG in its SASS")
        for p in PRODUCTS.get(k, ()):
            if not any(p in fn for fn in mine):
                fail(f"{k}: no {p} kernel in its SASS")
    counts.update(check_k3_sass(build, tool))
    return counts


def check_k2_spills(build):
    """ptxas (-v) of the K2 functions above C = 256, K2f's two products
    and K2b's dxn (gemm_sm90, with K2b's other products) and
    mlp_dual_wide_sm90: a spill store or load in any of them fails, and
    so does finding none."""
    seen = 0
    for k in ("swin_mlp_fwd", "swin_mlp_bwd"):
        fn = None
        for line in build.ptxas_report(k).splitlines():
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                fn = m.group(1)
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if not (m and fn and ("mlp_dual_wide_sm90" in fn
                                  or "gemm_sm90" in fn)):
                continue
            seen += 1
            if int(m.group(1)) or int(m.group(2)):
                fail(f"ptxas {k} {fn}: {line.strip()}")
    if not seen:
        fail("ptxas: no report of K2f's products or mlp_dual_wide_sm90")
    log(f"  ptxas: no spills in the {seen} K2 functions above C = 256")


def check_k3_sass(build, tool):
    """K3's chunk kernel (``preprocess_fwd_vec``, bf16 and f32) must load
    and store its chunks 16 bytes at a time (LDG.E.128, STG.E.128): the
    global load / store mnemonics of each function of the library."""
    out = subprocess.run([tool, "-sass", str(build.lib_path(
        "preprocess_fwd"))], capture_output=True, text=True, timeout=120)
    if out.returncode != 0:
        fail(f"cuobjdump preprocess_fwd: {out.stderr.strip()}")
    fn, mine, kinds = None, {}, {}
    for line in out.stdout.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            mine[fn], kinds[fn] = {}, {}
        elif fn:
            m = re.search(r"\b((?:LDG|STG)\.[A-Z0-9_.]+)", line)
            if m:
                mine[fn][m.group(1)] = mine[fn].get(m.group(1), 0) + 1
            # the static count of each opcode (integer multiplies with
            # their modifiers: IMAD.WIDE, IMAD.HI, IMAD.MOV), and of all
            m = re.search(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)"
                          r"((?:\.[A-Z0-9_]+)*)", line)
            if m and m.group(1) != "NOP":
                op = m.group(1) + (m.group(2) if m.group(1) == "IMAD"
                                   else "")
                kinds[fn][op] = kinds[fn].get(op, 0) + 1
                kinds[fn]["all"] = kinds[fn].get("all", 0) + 1
    vec = [f for f in mine if "preprocess_fwd_vec" in f]
    if len(vec) != 2:
        fail(f"preprocess_fwd: {len(vec)} preprocess_fwd_vec functions in "
             f"its SASS, not 2 (bf16, f32): {list(mine)}")
    for f, ops in mine.items():
        top = dict(sorted(kinds[f].items(), key=lambda kv: -kv[1])[:16])
        log(f"  sass preprocess_fwd {f}: {ops}; static opcodes {top}")
    for f in vec:
        for kind in ("LDG.E", "STG.E"):
            if not any(op.startswith(kind) and ".128" in op
                       for op in mine[f]):
                fail(f"{f}: no {kind}.128 in its SASS: {mine[f]}")
    return {f"preprocess_fwd:{f}": dict(ops, opcodes=kinds[f])
            for f, ops in mine.items()}


def k1_chain(x, w, mask, dp, H, ws):
    """K1f as a chain of PyTorch library calls, for information only (it
    is never on the port's path): F.layer_norm -> F.linear -> SDPA with
    the rel-pos bias + shift mask as ``attn_mask`` -> F.linear -> x +
    dp * y, in x's dtype with the weights cast beforehand. Returns
    (fn, params): fn(x, *params)."""
    import torch
    import torch.nn.functional as F

    from fmc_uia_tpu_torch.ops.swin_block import _unwindows, _windows

    B, Hp, Wp, C = x.shape
    N, nW, dh, dt = ws * ws, (Hp // ws) * (Wp // ws), C // H, x.dtype
    am = w["bias_hnn"][None] if mask is None else (
        w["bias_hnn"][None] + mask[:, None])
    am = am.to(dt)[None].expand(B, nW, H, N, N).reshape(B * nW, H, N, N)
    params = [w[k].to(dt) for k in ("ln_scale", "ln_bias", "wqkv", "bqkv",
                                    "wproj", "bproj")]
    dpv = dp.to(dt).view(B, 1, 1, 1)

    def fn(x, ls, lb, wq, bq, wp, bp):
        xn = F.layer_norm(_windows(x, ws), (C,), ls, lb, eps=1e-6)
        qkv = F.linear(xn, wq, bq).reshape(B * nW, N, 3, H, dh)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        o = F.scaled_dot_product_attention(q, k, v, attn_mask=am)
        y = F.linear(o.permute(0, 2, 1, 3).reshape(B, nW, N, C), wp, bp)
        return x + dpv * _unwindows(y, ws, Hp, Wp)

    return fn, params


# ---------------------------------------------------------------------------
# phase 2: kernels
# ---------------------------------------------------------------------------
BURST_CALLS = 10     # back-to-back calls of ``ms_10`` / ``chain_ms_10``


def attn_cases():
    """(label, B, grid, C, heads, ws, shift) — the four swin_b 512² stage
    shapes, unshifted and shifted (stage 3's 16² grid > 8 shifts too),
    a padded grid (12 -> 16) and a window-7 case."""
    cases = []
    for s, (g, c, h) in enumerate(((128, 128, 4), (64, 256, 8),
                                   (32, 512, 16), (16, 1024, 32))):
        for shift in (0, 4):
            cases.append((f"stage{s}{'_shift' if shift else ''}", BATCH, g,
                          c, h, 8, shift))
    cases.append(("pad12_shift", 2, 12, 128, 4, 8, 4))
    cases.append(("ws7_shift", 2, 56, 96, 3, 7, 3))
    cases.append(("dh16_shift", 2, 32, 128, 8, 8, 4))
    return cases


def submit_attn_cases(batch):
    """(label, B, grid, C, heads, ws, shift) of K1 on the submit preset's
    path (phase 9; swin_b 224², window 7, N = 49): stages 0-2 unshifted
    and shifted by 3, and stage 3, whose 7² grid is one window and takes
    no shift."""
    cases = []
    for s, (g, c, h) in enumerate(((56, 128, 4), (28, 256, 8),
                                   (14, 512, 16), (7, 1024, 32))):
        for shift in ((0, 3) if g > 7 else (0,)):
            cases.append((f"submit_s{s}{'_shift' if shift else ''}", batch,
                          g, c, h, 7, shift))
    return cases


def attn_inputs(B, grid, C, H, ws, shift, dtype, gen, dev):
    import numpy as np
    import torch

    from fmc_uia_tpu_torch.models.encoders.swin import (
        _relative_position_index,
        block_attn_mask,
    )

    hp = -(-grid // ws) * ws
    N = ws * ws

    def rnd(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen) * std).to(dev)

    x = rnd(B, hp, hp, C).to(dtype)
    table = rnd((2 * ws - 1) ** 2, H, std=0.02)
    idx = torch.as_tensor(_relative_position_index(ws).reshape(-1))
    bias = table[idx.to(dev)].reshape(N, N, H).permute(2, 0, 1).contiguous()
    m = block_attn_mask(grid, grid, ws, shift)
    mask = None if m is None else torch.as_tensor(m, device=dev)
    dp = torch.ones(B, device=dev)
    dp[0] = 0.5  # one sample with a drop-path scale != 1
    w = dict(ln_scale=1 + rnd(C, std=0.1), ln_bias=rnd(C, std=0.1),
             wqkv=rnd(3 * C, C, std=C ** -0.5), bqkv=rnd(3 * C, std=0.02),
             wproj=rnd(C, C, std=C ** -0.5), bproj=rnd(C, std=0.02),
             bias_hnn=bias)
    return x, w, mask, dp, np.prod((B, hp, hp)), hp


def mlp_inputs(B, grid, C, dtype, gen, dev):
    import torch

    def rnd(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen) * std).to(dev)

    x = rnd(B, grid, grid, C).to(dtype)
    dp = torch.ones(B, device=dev)
    dp[0] = 0.5
    w = dict(ln_scale=1 + rnd(C, std=0.1), ln_bias=rnd(C, std=0.1),
             w1=rnd(4 * C, C, std=C ** -0.5), b1=rnd(4 * C, std=0.02),
             w2=rnd(C, 4 * C, std=(4 * C) ** -0.5), b2=rnd(C, std=0.02))
    return x, w, dp


def mlp_cases(batch):
    """(label, B, grid, C) of K2f/K2b: the flagship's two fused stages at
    ``batch`` (swin_b 512²: 128² x 128, 64² x 256), swin_t's widths (224²:
    56² x 96, 28² x 192), the other widths the bf16 kernels take (C % 32
    up to 256: 32 and 64, one 64-wide k-chunk; 160 and 224), and a ragged
    case: 147 tokens (the last 128-token tile holds 19), dp changing
    inside the first tile (samples of 49)."""
    return [("stage0", batch, 128, 128), ("stage1", batch, 64, 256),
            ("swin_t_s0", 2, 56, 96), ("swin_t_s1", 2, 28, 192),
            ("c32", 2, 16, 32), ("c64", 2, 16, 64), ("c160", 2, 14, 160),
            ("c224", 1, 14, 224), ("ragged", 3, 7, 128)]


def submit_mlp_cases(batch):
    """(label, B, grid, C) of K2 on the submit preset's path (phase 9;
    swin_b 224²): its two fused stages, 56² x 128 and 28² x 256."""
    return [("submit_s0", batch, 56, 128), ("submit_s1", batch, 28, 256)]


def k2_chain(x, w, dp):
    """K2f as a chain of PyTorch library calls, for information only (never
    on the port's path): F.layer_norm -> F.linear -> F.gelu(tanh) ->
    F.linear -> x + dp * y, in x's dtype with the weights cast beforehand.
    Returns (fn, params): fn(x, *params)."""
    import torch.nn.functional as F

    B, C, dt = x.shape[0], x.shape[-1], x.dtype
    params = [w[k].to(dt) for k in ("ln_scale", "ln_bias", "w1", "b1", "w2",
                                    "b2")]
    dpv = dp.to(dt).view(B, 1, 1, 1)

    def fn(x, ls, lb, w1, b1, w2, b2):
        xn = F.layer_norm(x, (C,), ls, lb, eps=1e-6)
        h = F.gelu(F.linear(xn, w1, b1), approximate="tanh")
        return x + dpv * F.linear(h, w2, b2)

    return fn, params


def chain_bwd_ms(fn, params, x, dy):
    """ms of a chain's autograd backward alone (one retained forward): one
    call, and per call of BURST_CALLS back-to-back calls."""
    import torch

    leaves = [t.detach().requires_grad_() for t in (x, *params)]
    out = fn(*leaves)

    def bwd():
        return torch.autograd.grad(out, leaves, dy, retain_graph=True)

    ms = (cuda_ms(bwd, reps=10, warmup=2),
          cuda_ms(bwd, reps=10, warmup=0, calls=BURST_CALLS))
    del out, leaves
    return ms


def burst_times(rec) -> str:
    """K1's and K2's times: one call and per call of BURST_CALLS
    back-to-back calls."""
    out = (f"  {rec['ms']:.3f} ms, {rec['ms_10']:.3f} ms of {BURST_CALLS} "
           f"(plain {rec['plain_ms']:.3f}, bound {rec['bound_ms']:.4f}")
    if "chain_ms" in rec:
        out += (f", chain {rec['chain_ms']:.3f}, {rec['chain_ms_10']:.3f} "
                f"of {BURST_CALLS}; host {rec['host_ms']:.3f} a call")
    return out + ")"


def err_text(chk) -> str:
    return (f"err {chk['max_abs_err']:.3e} (beyond 1 ulp "
            f"{chk['excess_err']:.3e} <= tol {chk['tol']:.3e}; branch max "
            f"{chk['branch_max']:.3f})")


def check_kernels(dev, records):
    import torch

    from fmc_uia_tpu_torch.ops import swin_block as sb

    gen = torch.Generator().manual_seed(0)
    summary = {"attention_branch": [], "mlp_branch": []}
    for label, B, grid, C, H, ws, shift in (attn_cases()
                                            + submit_attn_cases(BATCH)):
        for dtype in (torch.float32, torch.bfloat16):
            x, w, mask, dp, T, hp = attn_inputs(B, grid, C, H, ws, shift,
                                                dtype, gen, dev)
            args = (w["ln_scale"], w["ln_bias"], w["wqkv"], w["bqkv"],
                    w["wproj"], w["bproj"], w["bias_hnn"], mask, H)
            out = sb.attention_branch(x, *args, dp=dp)
            ref = sb.attention_branch_reference(x, *args, dp=dp)
            chk = check_branch(out, ref, x, dtype, f"attention_branch {label}")
            N = ws * ws
            esz = x.element_size()
            flops = 2 * T * C * 3 * C + 2 * T * C * C + 4 * T * N * C
            nbytes = (2 * T * C * esz + 4 * (4 * C * C + 6 * C)
                      + 4 * H * N * N
                      + (0 if mask is None else 4 * mask.numel()))
            rec = dict(kernel="attention_branch", case=label,
                       dtype=str(dtype).split(".")[-1],
                       shape=[B, hp, hp, C], heads=H, ws=ws,
                       mask=mask is not None, **chk)
            if dtype == torch.bfloat16 or label.startswith("stage"):
                peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32
                rec["ms"] = cuda_ms(lambda: sb.attention_branch(x, *args,
                                                                dp=dp))
                # per call of back-to-back calls: device time, not the
                # host's launch gaps (K1f's kernels are short)
                rec["ms_10"] = cuda_ms(
                    lambda: sb.attention_branch(x, *args, dp=dp),
                    warmup=0, calls=BURST_CALLS)
                rec["plain_ms"] = cuda_ms(
                    lambda: sb.attention_branch_reference(x, *args, dp=dp),
                    reps=20, warmup=1)
                rec["bound_ms"] = 1e3 * max(flops / peak, nbytes / HBM_BPS)
                rec["bound_by"] = ("operations" if flops / peak
                                   >= nbytes / HBM_BPS else "bytes")
            if dtype == torch.bfloat16 and label.startswith("stage"):
                fn, params = k1_chain(x, w, mask, dp, H, ws)
                rec["chain_ms"] = cuda_ms(lambda: fn(x, *params))
                rec["chain_ms_10"] = cuda_ms(lambda: fn(x, *params),
                                             warmup=0, calls=BURST_CALLS)
                rec["host_ms"] = host_call_ms(
                    lambda: sb.attention_branch(x, *args, dp=dp))
                del fn, params
            records.append(rec)
            log(f"  K1f {label:12s} {rec['dtype']:8s} {rec['shape']} "
                + err_text(chk) + (burst_times(rec) if "ms" in rec else ""))
            if dtype == torch.bfloat16 and label.startswith("stage"):
                summary["attention_branch"].append(rec)
    for label, B, grid, C in mlp_cases(BATCH) + submit_mlp_cases(BATCH):
        for dtype in (torch.float32, torch.bfloat16):
            x, w, dp = mlp_inputs(B, grid, C, dtype, gen, dev)
            args = (w["ln_scale"], w["ln_bias"], w["w1"], w["b1"], w["w2"],
                    w["b2"])
            out = sb.mlp_branch(x, *args, dp=dp)
            ref = sb.mlp_branch_reference(x, *args, dp=dp)
            chk = check_branch(out, ref, x, dtype, f"mlp_branch {label}")
            rec = dict(kernel="mlp_branch", case=label,
                       dtype=str(dtype).split(".")[-1],
                       shape=[B, grid, grid, C], **chk)
            if label.startswith("stage"):
                T = B * grid * grid
                esz = x.element_size()
                flops = 16 * T * C * C
                nbytes = 2 * T * C * esz + 4 * (8 * C * C + 7 * C)
                peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32
                rec["ms"] = cuda_ms(lambda: sb.mlp_branch(x, *args, dp=dp))
                rec["plain_ms"] = cuda_ms(
                    lambda: sb.mlp_branch_reference(x, *args, dp=dp),
                    reps=20, warmup=1)
                rec["bound_ms"] = 1e3 * max(flops / peak, nbytes / HBM_BPS)
                rec["bound_by"] = ("operations" if flops / peak
                                   >= nbytes / HBM_BPS else "bytes")
            if dtype == torch.bfloat16 and label.startswith("stage"):
                rec["ms_10"] = cuda_ms(
                    lambda: sb.mlp_branch(x, *args, dp=dp), warmup=0,
                    calls=BURST_CALLS)
                fn, params = k2_chain(x, w, dp)
                rec["chain_ms"] = cuda_ms(lambda: fn(x, *params))
                rec["chain_ms_10"] = cuda_ms(lambda: fn(x, *params),
                                             warmup=0, calls=BURST_CALLS)
                rec["host_ms"] = host_call_ms(
                    lambda: sb.mlp_branch(x, *args, dp=dp))
                del fn, params
            records.append(rec)
            times = ""
            if "ms_10" in rec:
                times = burst_times(rec)
            elif "ms" in rec:
                times = (f"  {rec['ms']:.3f} ms (plain {rec['plain_ms']:.3f},"
                         f" bound {rec['bound_ms']:.4f})")
            log(f"  K2f {label:12s} {rec['dtype']:8s} {rec['shape']} "
                + err_text(chk) + times)
            if dtype == torch.bfloat16 and label.startswith("stage"):
                summary["mlp_branch"].append(rec)
            del x, w, args, out, ref
    return summary


# ---------------------------------------------------------------------------
# phase 2b: backward kernels
# ---------------------------------------------------------------------------
TRAIN_BATCH = 24     # the flagship train step's batch


def bwd_attn_cases():
    """(label, B, grid, C, heads, ws, shift) of K1b: the four swin_b 512²
    stage shapes of the B=24 train step, unshifted and shifted, a padded
    grid, a window-7 case, and the submit preset's B=64 train step."""
    cases = [(label, TRAIN_BATCH, g, c, h, ws, shift)
             for label, _, g, c, h, ws, shift in attn_cases()[:8]]
    cases.append(("pad12_shift", 2, 12, 128, 4, 8, 4))
    cases.append(("ws7_shift", 2, 56, 96, 3, 7, 3))
    cases.append(("dh16_shift", 2, 32, 128, 8, 8, 4))
    return cases + submit_attn_cases(SUBMIT_BATCH)


def check_grads(names, got, ref, dtype, what):
    """Each weight/bias grad within 1e-3 (f32: sums over up to 393,216
    tokens in another order) or 2e-2 (bf16: an intermediate rounded to a
    neighbouring bf16 value here and there) of its largest magnitude.
    Returns {name: [err, tol]}."""
    import torch

    rel = 2e-2 if dtype == torch.bfloat16 else 1e-3
    out = {}
    for name, g, r in zip(names, got, ref):
        err = float((g.float() - r.float()).abs().max())
        tol = rel * float(r.float().abs().max())
        if not err <= tol:
            fail(f"{what} {name} {dtype}: err {err:.3e} > tol {tol:.3e}")
        out[name] = [err, tol]
    return out


def k2b_pass_bytes(T, C, Ch, plan):
    """Bytes K2b's bf16 passes move, each buffer read or written once a
    pass (csrc/swin_mlp_bwd.cu): the weight casts; LN rows and dy * dp;
    the dual product (xn, dyc in; gc, dh1c and db1's slots out); dW2, dW1
    (their operands in, slot partials out) and dxn; the LN pullback (x,
    dy, dxn in; dx out); db2's column sums; the slot reductions."""
    act, hid = T * C, T * Ch
    weights = 2 * Ch * C * (4 + 2) + 2 * Ch * C * 2  # casts; dual, dxn
    parts_w = (plan["slots_w1"] + plan["slots_w2"]) * Ch * C * 4
    parts_b1 = plan["tiles"] * Ch * 4
    return (weights
            + 2 * act * 2 + 8 * T               # ln rows: x -> xn, mu, rstd
            + 2 * act * 2                       # dyc
            + 2 * act * 2 + 2 * hid * 2 + parts_b1   # dual product
            + (act + hid) * 2 * 2 + parts_w     # dW2, dW1
            + hid * 2 + act * 4                 # dxn
            + 3 * act * 2 + act * 4 + 8 * T     # LN pullback
            + act * 2                           # db2
            + parts_w + parts_b1 + (2 * Ch * C + Ch) * 4)  # reductions


ATTN_GRADS = ("dln_scale", "dln_bias", "dwqkv", "dbqkv", "dwproj", "dbproj",
              "dbias")
MLP_GRADS = ("dln_scale", "dln_bias", "dw1", "db1", "dw2", "db2")


def check_bwd_kernels(dev, records):
    """K1b and K2b against their plain backward versions on the card, and
    K1f and K2f against their plain forward versions on the same inputs
    (the train step runs the forward kernels at these shapes too)."""
    import torch

    from fmc_uia_tpu_torch.ops import build
    from fmc_uia_tpu_torch.ops import swin_block as sb

    gen = torch.Generator().manual_seed(1)
    summary = {"attention_branch_backward": [], "mlp_branch_backward": [],
               "attention_branch_train": [], "mlp_branch_train": []}

    def run_fwd(kname, label, dtype, x, fn, ref_fn, shape):
        chk = check_branch(fn(), ref_fn(), x, dtype, f"{kname} train {label}")
        rec = dict(kernel=kname, case=f"train_{label}",
                   dtype=str(dtype).split(".")[-1], shape=shape, **chk)
        records.append(rec)
        if label.startswith("stage") and dtype == torch.bfloat16:
            summary[f"{kname}_train"].append(rec)
        log(f"  {'K1f' if kname.startswith('att') else 'K2f'} {label:12s} "
            f"{rec['dtype']:8s} {shape} " + err_text(chk))

    def run(kname, label, dtype, x, dy, fn, ref_fn, names, flops, nbytes,
            timed, shape, chain=None):
        got = fn()
        ref = ref_fn()
        torch.cuda.synchronize()
        # bf16 K1b at stage 2 and K2b at stage 0: the same inputs again
        repeat = dtype == torch.bfloat16 and (
            (kname == "attention_branch_backward"
             and label.startswith("stage2"))
            or (kname == "mlp_branch_backward" and label == "stage0"))
        if repeat:  # the same inputs again: every output bitwise equal
            again = fn()
            bad = [n for n, u, v in zip(("dx",) + names, got, again)
                   if not torch.equal(u, v)]
            if bad:
                fail(f"{kname} {label} bf16: two runs differ in {bad}")
            del again
        # dx = round(dxf) + dy: held like a branch output, dy its residual
        chk = check_branch(got[0], ref[0], dy, dtype, f"{kname} {label} dx")
        err, excess, tol = chk["max_abs_err"], chk["excess_err"], chk["tol"]
        grads = check_grads(names, got[1:], ref[1:], dtype,
                            f"{kname} {label}")
        del got, ref
        rec = dict(kernel=kname, case=label, dtype=str(dtype).split(".")[-1],
                   shape=shape, max_abs_err=err, excess_err=excess, tol=tol,
                   grads=grads)
        if repeat:
            rec["bitwise_repeat"] = True
        if timed:
            peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32
            rec["ms"] = cuda_ms(fn, reps=10, warmup=2)
            if chain is not None:  # K1b and K2b, as K1f and K2f
                rec["ms_10"] = cuda_ms(fn, reps=10, warmup=0,
                                       calls=BURST_CALLS)
            rec["plain_ms"] = cuda_ms(ref_fn, reps=3, warmup=1)
            rec["bound_ms"] = 1e3 * max(flops / peak, nbytes / HBM_BPS)
            rec["bound_by"] = ("operations" if flops / peak
                               >= nbytes / HBM_BPS else "bytes")
            if chain is not None and dtype == torch.bfloat16:
                rec["chain_ms"], rec["chain_ms_10"] = chain()
                rec["host_ms"] = host_call_ms(fn, reps=10)
            torch.cuda.empty_cache()
        records.append(rec)
        worst = max(v[0] / max(v[1], 1e-30) for v in grads.values())
        if not timed:
            times = ""
        elif "ms_10" in rec:
            times = burst_times(rec)
        else:
            times = (f"  {rec['ms']:.3f} ms (plain {rec['plain_ms']:.3f}, "
                     f"bound {rec['bound_ms']:.4f})")
        log(f"  {'K1b' if kname.startswith('att') else 'K2b'} {label:12s} "
            f"{rec['dtype']:8s} {shape} dx err {err:.3e} (beyond 1 ulp "
            f"{excess:.3e} <= tol {tol:.3e}); grads worst err/tol "
            f"{worst:.3f}" + (" (two runs bitwise equal)" if repeat else "")
            + times)
        return rec

    for label, B, grid, C, H, ws, shift in bwd_attn_cases():
        for dtype in (torch.float32, torch.bfloat16):
            x, w, mask, dp, T, hp = attn_inputs(B, grid, C, H, ws, shift,
                                                dtype, gen, dev)
            dy = torch.randn(x.shape, generator=gen).to(dev, dtype)
            args = (w["ln_scale"], w["ln_bias"], w["wqkv"], w["bqkv"],
                    w["wproj"], w["bproj"], w["bias_hnn"], mask, H)
            run_fwd("attention_branch", label, dtype, x,
                    lambda: sb.attention_branch(x, *args, dp=dp),
                    lambda: sb.attention_branch_reference(x, *args, dp=dp),
                    [B, hp, hp, C])
            N = ws * ws
            esz = x.element_size()
            # the pullback with its recompute: 22 C^2 + 12 N C per token
            flops = T * (22 * C * C + 12 * N * C)
            nbytes = (3 * T * C * esz + 2 * 4 * (4 * C * C + 6 * C)
                      + 2 * 4 * H * N * N
                      + (0 if mask is None else 4 * mask.numel()))
            rec = run("attention_branch_backward", label, dtype, x, dy,
                      lambda: sb.attention_branch_backward(x, *args, dy,
                                                           dp=dp),
                      lambda: sb.attention_branch_backward_reference(
                          x, *args, dy, dp=dp),
                      ATTN_GRADS, flops, nbytes, label.startswith("stage"),
                      [B, hp, hp, C],
                      chain=lambda: chain_bwd_ms(
                          *k1_chain(x, w, mask, dp, H, ws), x, dy))
            if label.startswith("stage") and dtype == torch.bfloat16:
                summary["attention_branch_backward"].append(rec)
            del x, dy, w, args
    for label, B, grid, C in (mlp_cases(TRAIN_BATCH)
                              + submit_mlp_cases(SUBMIT_BATCH)):
        for dtype in (torch.float32, torch.bfloat16):
            x, w, dp = mlp_inputs(B, grid, C, dtype, gen, dev)
            dy = torch.randn(x.shape, generator=gen).to(dev, dtype)
            args = (w["ln_scale"], w["ln_bias"], w["w1"], w["b1"], w["w2"],
                    w["b2"])
            run_fwd("mlp_branch", label, dtype, x,
                    lambda: sb.mlp_branch(x, *args, dp=dp),
                    lambda: sb.mlp_branch_reference(x, *args, dp=dp),
                    [B, grid, grid, C])
            T = B * grid * grid
            Ch = 4 * C
            esz = x.element_size()
            flops = 40 * T * C * C  # fc1 recompute + 4 products of 8 C^2
            nbytes = 3 * T * C * esz + 2 * 4 * (8 * C * C + 7 * C)
            plan = sb.mlp_bwd_plan(T, C, Ch)
            if dtype == torch.bfloat16:  # the Python mirror of the carving
                got_ws = build.load("swin_mlp_bwd", "swin_mlp_bwd_workspace")(
                    T, C, Ch, 1, plan["kchunk_w1"], plan["kchunk_w2"])
                if got_ws != plan["workspace"]:
                    fail(f"K2b {label}: workspace {got_ws} bytes != the "
                         f"plan's {plan['workspace']}")
            rec = run("mlp_branch_backward", label, dtype, x, dy,
                      lambda: sb.mlp_branch_backward(x, *args, dy, dp=dp),
                      lambda: sb.mlp_branch_backward_reference(
                          x, *args, dy, dp=dp),
                      MLP_GRADS, flops, nbytes, label.startswith("stage"),
                      [B, grid, grid, C],
                      chain=lambda: chain_bwd_ms(*k2_chain(x, w, dp), x,
                                                 dy))
            if dtype == torch.bfloat16:
                # the design's bytes, each buffer once a pass (PERF.md's
                # K2b row; a yardstick of this design, not the bound)
                rec["floor_ms"] = 1e3 * k2b_pass_bytes(T, C, Ch,
                                                       plan) / HBM_BPS
                rec["workspace"] = plan["workspace"]
                log(f"    K2b {label} bf16: its passes' bytes at the HBM "
                    f"rate {rec['floor_ms']:.4f} ms; workspace "
                    f"{plan['workspace']} bytes")
                if label.startswith("stage"):
                    summary["mlp_branch_backward"].append(rec)
            del x, dy, w, args
    return summary


# ---------------------------------------------------------------------------
# phase 2c: K3
# ---------------------------------------------------------------------------
# sm_90 results a clock per SM (CUDA C++ Programming Guide, arithmetic
# instructions, compute capability 9.0), by the pipe that issues them
# (Nsight Compute's pipelines): integer multiplies (IMAD, IMAD.HI) on the
# FMA pipe, 64; integer logic, add, shift and byte permute (LOP3, IADD3,
# SHF, PRMT) on the ALU pipe, 64; f32 add, multiply, min and max 128;
# special functions (lg2, sqrt, cos) 16; int <-> f32 conversions 16
K3_RATES = {"imad": 64, "alu": 64, "f32": 128, "special": 16,
            "conversion": 16}
# the instructions that csrc/preprocess_fwd.cu's function needs, by
# class: a special function or conversion once, however many instructions
# it expands to. Every element: a byte permute into a float's mantissa
# (alu) and its exact subtraction, multiply, add, two clips, subtract,
# multiply (f32 7); bf16 output adds one packing conversion a pair.
K3_PER_ELEMENT = {"alu": 1, "f32": 7}
# an element of an image with sigma != 0: two shifts, two int -> f32
# conversions, ten f32 operations (two scales, max, -2 x, 2 pi x, the
# product, sigma n, the add, the clip), logf, sqrtf and cosf
K3_PER_NOISE_ELEMENT = {"alu": 2, "f32": 10, "special": 3,
                        "conversion": 2}
# a Philox pair: a 32 x 32 -> 64-bit product is two multiply instructions
# (high and low word); a round's two three-input XORs are one LOP3 each.
# Round 0 (c1 = c2 = c3 = 0, key (seed, 0)) needs c0's product alone and
# no XOR; round 1's c0 is the seed, whose product is the image's own, so
# it needs c2's product and two XORs; rounds 2-9 two products and two
# XORs. The key schedule's 9 adds are the image's own too.
K3_PER_NOISE_PAIR = {"imad": 2 + 2 + 8 * 4, "alu": 2 + 8 * 2}
K3_PER_NOISE_IMAGE = {"alu": 9}
K3_DRAW_SEED = 8    # the generator of case (a), the train path's draws


def bf16_ulps(a, b):
    """|a - b| in bf16 ulps of max(|a|, |b|), per element."""
    import torch

    mag = torch.maximum(a.abs(), b.abs()).clamp_min(1e-30)
    return (a - b).abs() / torch.exp2(torch.floor(torch.log2(mag)) - 7)


def sm_clock_hz() -> float:
    """The card's largest SM clock (nvidia-smi clocks.max.sm)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi clocks.max.sm failed: {out.stderr.strip()}")
    return 1e6 * float(out.stdout.strip().splitlines()[0])


def k3_bound(B, P, C, noisy, out_bytes, clock_hz, sms):
    """K3's least time on these inputs: the larger of its bytes at the HBM
    rate and each instruction class at its sm_90 rate; the noise's work is
    counted for the ``noisy`` images (sigma > 0) only."""
    pairs = noisy * ((P + 1) // 2)
    ops = {c: (B * P * K3_PER_ELEMENT.get(c, 0)
               + noisy * P * K3_PER_NOISE_ELEMENT.get(c, 0)
               + pairs * K3_PER_NOISE_PAIR.get(c, 0)
               + noisy * K3_PER_NOISE_IMAGE.get(c, 0)) for c in K3_RATES}
    if out_bytes == 2:
        ops["conversion"] += B * P / 2
    nbytes = B * P * (1 + out_bytes) + B * 16 + 2 * C * 4
    ms = {c: 1e3 * ops[c] / (K3_RATES[c] * sms * clock_hz) for c in ops}
    ms["bytes"] = 1e3 * nbytes / HBM_BPS
    by = max(ms, key=ms.get)
    return dict(bound_ms=ms[by], bound_class=by,
                bound_by="bytes" if by == "bytes" else "operations",
                class_ms=ms, operations=ops, bytes=nbytes, noisy=noisy)


def k3_device_ms(fn, calls=20):
    """The K3 kernel's own device ms a launch (one a call), from
    torch.profiler over ``calls`` calls of ``fn`` after a warm-up: at
    K3's size the wrapper's host time a call is about the kernel's, so
    events over back-to-back calls (``ms_50``) time the host as much as
    the card. The mean is over the launches the trace recorded; fewer
    than ``calls`` - 2 fails."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us, n = 0.0, 0
    for e in prof.key_averages():
        dev_us = float(getattr(e, "self_device_time_total", 0.0)
                       or getattr(e, "self_cuda_time_total", 0.0))
        if "preprocess_fwd" in e.key and dev_us > 0:
            us, n = us + dev_us, n + e.count
    if not calls - 2 <= n <= calls:
        fail(f"profile: {n} K3 launches recorded of {calls} calls")
    return us / 1e3 / n


def k3_inputs(dev):
    """The images and the parameters of the timed cases at the train
    step's shapes: (a) the train path's draws (p = 0.2 / 0.1), (b) both
    ops on every image (p = 1), (c) no change (p = 0)."""
    import torch

    from fmc_uia_tpu_torch.ops import preprocess as pp

    B, S = TRAIN_BATCH, IMAGE
    gen = torch.Generator(device=dev).manual_seed(7)
    img = torch.randint(0, 256, (B, S, S, 3), dtype=torch.uint8, device=dev,
                        generator=gen)
    cases = {
        "draws": pp.draw_params(B, dev, torch.Generator(
            device=dev).manual_seed(K3_DRAW_SEED)),
        "p1": pp.draw_params(B, dev, gen, 1.0, 1.0),
        "none": pp.draw_params(B, dev, gen, 0.0, 0.0),
    }
    return img, gen, cases


def k3_timing(img, cases, mean, std, clock_hz, sms):
    """K3 in bf16 on each timed case: ``ms``, one call between CUDA
    events (the host's time to enqueue it included), ``ms_50``, per call
    of 50 back-to-back calls, ``device_ms``, the kernel's own time a
    launch (profiler), and the bound."""
    import torch

    from fmc_uia_tpu_torch.ops import preprocess as pp

    B, P = img.shape[0], img[0].numel()
    out = {}
    for case, (sc, sd) in cases.items():
        def call():
            return pp.augment_normalize(img, sc, sd, mean, std,
                                        torch.bfloat16)
        noisy = int((sc[:, 2] > 0).sum())
        out[case] = dict(ms=cuda_ms(call, reps=50, warmup=5),
                         ms_50=cuda_ms(call, calls=50),
                         device_ms=k3_device_ms(call),
                         **k3_bound(B, P, img.shape[-1], noisy, 2, clock_hz,
                                    sms))
    return out


def k3_yardsticks(img):
    """For information, the same bytes moved by PyTorch: ``cast_ms``, a
    uint8 -> bf16 copy of the images (what K3 reads and writes), and
    ``copy_ms``, a device copy that moves as many bytes (per call of 50)."""
    import torch

    o16 = torch.empty(img.shape, dtype=torch.bfloat16, device=img.device)
    src = torch.empty(img.numel() * 3 // 2, dtype=torch.uint8,
                      device=img.device)
    dst = torch.empty_like(src)
    return dict(cast_ms=cuda_ms(lambda: o16.copy_(img), calls=50),
                copy_ms=cuda_ms(lambda: dst.copy_(src), calls=50))


def k3_log(case, t):
    ops = t["operations"]
    log(f"  K3 bf16 {case:5s} ({t['noisy']:2d} images with noise): "
        f"device {t['device_ms']:.4f} ms, {t['ms_50']:.4f} a call of 50, "
        f"one call {t['ms']:.4f}; bound "
        f"{t['bound_ms']:.4f} by {t['bound_class']}; ms by class "
        + ", ".join(f"{c} {v:.4f}" for c, v in t["class_ms"].items())
        + f"; {t['bytes'] / 1e6:.1f} MB, imad {ops['imad'] / 1e9:.3f} G, "
        f"alu {ops['alu'] / 1e9:.3f} G")


def k3_edge_cases(dev, gen, mean, std):
    """The shapes beside the train step's: (name, images, mean, std).
    The odd P and the view at offset 1 take the edge kernel; ``submit``
    is the submit preset's fit step (phase 9d: B=64, 224²)."""
    import torch

    def rnd(shape, offset=0):
        n = math.prod(shape)
        buf = torch.randint(0, 256, (n + offset,), dtype=torch.uint8,
                            device=dev, generator=gen)
        return buf[offset:].view(shape)

    def stats(C):
        return (list(mean) + [0.4])[:C], (list(std) + [0.22])[:C]

    return [("odd_P", rnd((3, 17, 23, 3)), *stats(3)),
            ("C1", rnd((4, 64, 64, 1)), *stats(1)),
            ("C4", rnd((4, 64, 64, 4)), *stats(4)),
            ("B1", rnd((1, IMAGE, IMAGE, 3)), *stats(3)),
            ("misaligned", rnd((2, 64, 64, 3), offset=1), *stats(3)),
            ("submit", rnd((SUBMIT_BATCH, SUBMIT_IMAGE, SUBMIT_IMAGE, 3)),
             *stats(3))]


def k3_call(pp, path, what, *args):
    """One K3 call that must take the ``path`` kernel ("vector" or
    "edge"): ``preprocess_fwd`` chooses, its counts say which ran."""
    counts = pp.augment_normalize.launches_by_kernel
    n = counts[path]
    out = pp.augment_normalize(*args)
    if counts[path] != n + 1:
        fail(f"K3 {what}: preprocess_fwd did not take the {path} kernel "
             f"({counts})")
    return out


def check_k3(dev, records, mean, std):
    """K3 against its plain version on the card at the train step's
    shapes and at the edge shapes; times the three cases; returns the
    kernels-line summary (bf16, case (a))."""
    import torch

    from fmc_uia_tpu_torch.ops import preprocess as pp
    from fmc_uia_tpu_torch.ops.image import (
        augment_and_normalize,
        normalize_images,
    )

    img, gen, cases = k3_inputs(dev)
    B = img.shape[0]
    seeds = torch.randint(0, 2 ** 31 - 1, (B,), dtype=torch.int32,
                          device=dev, generator=gen)
    # (alpha, beta) that push both ends past the clips: 1.5 x - 100 < 0
    # below 67 and > 255 above 236, and so on
    sat4 = torch.tensor([[1.5, -100.0, 0.0], [1.2, 60.0, 0.0],
                         [2.0, -200.0, 0.0], [0.8, -40.0, 0.0]],
                        device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    worst = 0.0
    shapes = [("main", img, mean, std)] + k3_edge_cases(dev, gen, mean,
                                                        std)
    for name, x, m, s in shapes:
        Bx = x.shape[0]
        sat = sat4.repeat(-(-Bx // 4), 1)[:Bx].contiguous()
        if Bx > seeds.shape[0]:  # the submit fit step's B=64
            seeds = torch.cat([seeds, torch.randint(
                0, 2 ** 31 - 1, (Bx - seeds.shape[0],), dtype=torch.int32,
                device=dev, generator=gen)])
        sd = seeds[:Bx].contiguous()
        p1 = (cases["p1"] if name == "main"
              else pp.draw_params(Bx, dev, gen, 1.0, 1.0))
        runs = [("sigma0_saturated", sat, sd), ("p1_draws", *p1)]
        if name == "main":
            runs.append(("draws", *cases["draws"]))
        # the kernel preprocess_fwd must choose: the chunk kernel needs
        # P % 16 == 0, C <= 16 and 16-byte aligned images (the output is
        # a fresh, aligned allocation)
        path = ("vector" if x[0].numel() % 16 == 0 and x.shape[-1] <= 16
                and x.data_ptr() % 16 == 0 else "edge")
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            for case, sc, sdd in runs:
                got = k3_call(pp, path, f"{name} {case}", x, sc, sdd, m, s,
                              dtype).float()
                ref = pp.augment_normalize_reference(x, sc, sdd, m, s,
                                                     dtype).float()
                torch.cuda.synchronize()
                err = float((got - ref).abs().max())
                ulps = None
                if case == "sigma0_saturated":
                    tol, ok = 0.0, err == 0.0
                elif dtype == torch.float32:
                    tol, ok = 1e-5, err <= 1e-5
                else:
                    ulps = float(bf16_ulps(got, ref).max())
                    tol, ok = 1.0, ulps <= 1.0
                if not ok:
                    fail(f"K3 {name} {case} {dname}: err {err:.3e} > tol "
                         f"{tol}" + (f" ({ulps:.2f} bf16 ulps)" if ulps
                                     is not None else ""))
                worst = max(worst, err)
                rec = dict(kernel="augment_normalize", shape_case=name,
                           case=case, dtype=dname, shape=list(x.shape),
                           path=path, max_abs_err=err, tol=tol)
                if ulps is not None:
                    rec["max_bf16_ulps"] = ulps
                records.append(rec)
                log(f"  K3 {name:10s} {path:6s} {case:17s} {dname:8s} "
                    f"{list(x.shape)} err {err:.3e} (tol {tol}"
                    + (f"; {ulps:.2f} bf16 ulps" if ulps is not None
                       else "") + ")")
                del got, ref
        zero = pp.draw_params(Bx, dev, gen, 0.0, 0.0)
        got = k3_call(pp, path, f"{name} p0", x, *zero, m, s, torch.float32)
        err = float((got - normalize_images(x, m, s)).abs().max())
        if not err <= 5e-7:
            fail(f"K3 {name} p=0 vs normalize_images: err {err:.3e} > 5e-7")
        records.append(dict(kernel="augment_normalize", shape_case=name,
                            case="p0_vs_normalize", dtype="float32",
                            path=path, max_abs_err=err, tol=5e-7))
        log(f"  K3 {name:10s} {path:6s} p0_vs_normalize   float32  err "
            f"{err:.3e} (tol 5e-7)")
    # the noise law on the kernel's own output, on each path: a constant
    # 128 at sigma 5, 2 x 256² x 3 samples (vector), and an odd P in a
    # view at offset 1 (edge)
    S = 256
    for name, shape, off, path in (
            ("noise_law", (2, S, S, 3), 0, "vector"),
            ("noise_law_edge", (2, S + 1, S - 1, 3), 1, "edge")):
        buf = torch.full((math.prod(shape) + off,), 128, dtype=torch.uint8,
                         device=dev)
        const = buf[off:].view(shape)
        noise = k3_call(
            pp, path, name, const,
            torch.tensor([[1.0, 0.0, 5.0]] * 2, device=dev),
            torch.tensor([11, 12], dtype=torch.int32, device=dev),
            [0.0] * 3, [1 / 255.0] * 3, torch.float32).double()
        mu, sdv = float(noise.mean()), float(noise.std())
        if not (abs(mu - 128.0) < 0.05 and abs(sdv - 5.0) < 0.05):
            fail(f"K3 {name}: mean {mu:.4f} (128), std {sdv:.4f} (5)")
        records.append(dict(kernel="augment_normalize", case=name,
                            shape=list(shape), mean=mu, std=sdv,
                            samples=noise.numel()))
        log(f"  K3 {name}, sigma 5 on 128, {list(shape)} at offset {off} "
            f"({noise.numel()} samples): mean {mu:.4f}, std {sdv:.4f}")
        del noise

    timing = k3_timing(img, cases, mean, std, sm_clock_hz(), sms)
    sc, sd = cases["draws"]
    bf = torch.bfloat16
    plain_ms = cuda_ms(lambda: pp.augment_normalize_reference(
        img, sc, sd, mean, std, bf), reps=5, warmup=1)
    unfused_ms = cuda_ms(lambda: augment_and_normalize(
        img, mean, std, 0.2, 0.1, train=True, dtype=bf, generator=gen),
        reps=20, warmup=2)
    for case, t in timing.items():
        records.append(dict(kernel="augment_normalize", case=f"time_{case}",
                            dtype="bfloat16", shape=list(img.shape), **t))
        k3_log(case, t)
    a, p1 = timing["draws"], timing["p1"]
    yard = k3_yardsticks(img)
    log(f"  K3 bf16 draws: plain {plain_ms:.3f} ms, unfused "
        f"augment_and_normalize {unfused_ms:.3f} ms; the same bytes: "
        f"uint8 -> bf16 copy_ {yard['cast_ms']:.4f} ms, device copy "
        f"{yard['copy_ms']:.4f} ms")
    return dict(ms=a["ms"], ms_50=a["ms_50"], device_ms=a["device_ms"],
                plain_ms=plain_ms,
                unfused_ms=unfused_ms, **yard, bound_ms=a["bound_ms"],
                bound_by=a["bound_by"], max_abs_err=worst, ms_p1=p1["ms"],
                ms_50_p1=p1["ms_50"], device_ms_p1=p1["device_ms"],
                bound_p1_ms=p1["bound_ms"])


def k3_main() -> int:
    """``--k3``: phase 2c's timed cases alone, for this script's tree; one
    JSON line of their numbers."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from fmc_uia_tpu_torch.flagship import flagship_config_dict
    from fmc_uia_tpu_torch.ops import build

    build.build(["preprocess_fwd"])
    dev = torch.device("cuda")
    norm = flagship_config_dict()["data"]["augmentation"]["normalize"]
    img, _, cases = k3_inputs(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock = sm_clock_hz()
    timing = k3_timing(img, cases, norm["mean"], norm["std"], clock, sms)
    for case, t in timing.items():
        k3_log(case, t)
    print(json.dumps({"tree": HERE, "card": nvidia_smi_line(),
                      "clock_max_sm_hz": clock, "sms": sms,
                      "k3": timing, **k3_yardsticks(img)}))
    return 0


# ---------------------------------------------------------------------------
# phase 2d: K4
# ---------------------------------------------------------------------------
K4_HEADS, K4_DH = 12, 64
K4_N = 4101          # DINOv3 ViT-B/8 at 512²: 64 x 64 patches + 1 cls + 4
PEAK_SFU = 3.9e12    # H100 special-function exponentials/s (FA3 paper)
PLAIN_CHUNK = 2      # images per call of the dense plain versions
K4_CALLS = 10        # back-to-back calls per timing of K4 and of SDPA


def k4_cases():
    """(label, B, N, backward?) of K4: the serving batch, the train batch
    (forward and backward), a tail case (256² + prefix, N = 1029) and the
    bf16 kernels' tile edges at B = 1: one full 128-row tile, then a
    one-row and a one-key tail (N = 128, 129, 257)."""
    return [("serve_b8", BATCH, K4_N, False),
            ("train_b24", TRAIN_BATCH, K4_N, True),
            ("tail_n1029", 2, 1029, True),
            ("edge_n128", 1, 128, True),
            ("edge_n129", 1, 129, True),
            ("edge_n257", 1, 257, True)]


def k4_bound(mm, exps, nbytes):
    """The least time for ``mm`` tensor-core operations, ``exps``
    exponentials on the special-function units and ``nbytes`` moved, and
    which of the three bounds it."""
    t = {"operations": mm / PEAK_BF16, "exponentials": exps / PEAK_SFU,
         "bytes": nbytes / HBM_BPS}
    by = max(t, key=t.get)
    return 1e3 * t[by], ("bytes" if by == "bytes" else "operations")


def chunked(fn, *ts):
    """``fn`` over chunks of PLAIN_CHUNK images, outputs concatenated
    (a dense [B, 12, 4101, 4101] f32 score tensor at B = 24 is 19 GB)."""
    import torch

    outs = [fn(*(t[i:i + PLAIN_CHUNK] for t in ts))
            for i in range(0, ts[0].shape[0], PLAIN_CHUNK)]
    return tuple(torch.cat(o) for o in zip(*outs))


def check_k4_tensor(got, ref, dtype, rel_f32, what):
    """Each element within one ulp of its own magnitude plus a tolerance
    scaled to its (b, h) slice's largest magnitude: f32 ``rel_f32`` of it
    (sums over up to 4,101 terms in another order, exp2 against exp);
    bf16 4 bf16 ulps of it (each side rounds p or ds once, the output
    once). Returns [max err, worst excess / tol]."""
    import torch

    got, ref = got.float(), ref.float()
    bits = 7 if dtype == torch.bfloat16 else 23
    mag = torch.maximum(got.abs(), ref.abs()).clamp_min(1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - bits)
    smax = ref.abs().amax((-2, -1), keepdim=True).clamp_min(1e-30)
    if dtype == torch.bfloat16:
        tol = 4 * torch.exp2(torch.floor(torch.log2(smax)) - 7)
    else:
        tol = rel_f32 * smax
    diff = (got - ref).abs()
    worst = float(((diff - ulp) / tol).max())
    if not worst <= 1.0:
        fail(f"{what} {dtype}: error beyond one ulp is {worst:.3f} x tol")
    return [float(diff.max()), worst]


def check_k4(dev, records):
    """K4f and K4b against their plain versions on the card, f32 (TF32
    off) and bf16, at the DINOv3 patch-8 shapes and the tile edges; times
    in bf16: kernel, plain, bound, and SDPA (forward; backward alone, and
    forward + backward) as the library yardstick; bf16 repeats bitwise
    equal. Returns the kernels-line summary."""
    import torch
    import torch.nn.functional as F

    from fmc_uia_tpu_torch.ops import vit_attention as va

    gen = torch.Generator().manual_seed(4)
    scale = K4_DH ** -0.5
    summ = {"global_attention": {"errs": []},
            "global_attention_backward": {"errs": []}}
    for label, B, N, bwd in k4_cases():
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            shape = (B, K4_HEADS, N, K4_DH)
            q, k, v, do = (torch.randn(shape, generator=gen).to(dev, dtype)
                           for _ in range(4))
            o, lse = va.global_attention_forward(q, k, v, scale)
            ro, rl = chunked(lambda a, b, c: va.global_attention_reference(
                a, b, c, scale), q, k, v)
            torch.cuda.synchronize()
            err_o = check_k4_tensor(o, ro, dtype, 1e-4, f"K4f {label} o")
            err_l = float((lse - rl).abs().max())
            if not err_l <= 1e-5 * max(1.0, float(rl.abs().max())):
                fail(f"K4f {label} {dname}: lse err {err_l:.3e}")
            del ro, rl
            rec = dict(kernel="global_attention", case=label, dtype=dname,
                       shape=list(shape), max_abs_err=err_o[0],
                       worst_over_tol=err_o[1], lse_err=err_l)
            records.append(rec)
            summ["global_attention"]["errs"].append(err_o[0])
            log(f"  K4f {label:11s} {dname:8s} {list(shape)} err "
                f"{err_o[0]:.3e} (beyond 1 ulp {err_o[1]:.3f} x tol); lse "
                f"err {err_l:.2e}")
            if bwd:
                got = va.global_attention_backward(q, k, v, o, lse, do,
                                                   scale)
                ref = chunked(
                    lambda *a: va.global_attention_backward_reference(
                        *a, scale), q, k, v, o, lse, do)
                torch.cuda.synchronize()
                errs = {n: check_k4_tensor(g, r, dtype, 1e-3,
                                           f"K4b {label} {n}")
                        for n, g, r in zip(("dq", "dk", "dv"), got, ref)}
                del got, ref
                rec = dict(kernel="global_attention_backward", case=label,
                           dtype=dname, shape=list(shape), errs=errs,
                           max_abs_err=max(e[0] for e in errs.values()))
                records.append(rec)
                summ["global_attention_backward"]["errs"].append(
                    rec["max_abs_err"])
                log(f"  K4b {label:11s} {dname:8s} {list(shape)} "
                    + ", ".join(f"{n} err {e[0]:.3e} ({e[1]:.3f} x tol)"
                                for n, e in errs.items()))
            del q, k, v, do, o, lse
            torch.cuda.empty_cache()

    # times, bf16, at the main path's shapes; K4f and K4b run twice on the
    # same inputs and must give bitwise-equal outputs (no atomics)
    bf = torch.bfloat16
    for label, B, N, bwd in k4_cases()[:2]:
        shape = (B, K4_HEADS, N, K4_DH)
        q, k, v, do = (torch.randn(shape, generator=gen).to(dev, bf)
                       for _ in range(4))
        o, lse = va.global_attention_forward(q, k, v, scale)
        o2, lse2 = va.global_attention_forward(q, k, v, scale)
        if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
            fail(f"K4f {label} bf16: two runs differ")
        del o2, lse2
        elems = B * K4_HEADS * N * K4_DH
        # least work: q k^T and p v; one exponential per score
        mm = 4 * B * K4_HEADS * N * N * K4_DH
        exps = B * K4_HEADS * N * N
        nbytes = 4 * elems * 2 + 4 * B * K4_HEADS * N
        bound_ms, bound_by = k4_bound(mm, exps, nbytes)
        t = dict(ms=cuda_ms(lambda: va.global_attention_forward(
                     q, k, v, scale), reps=10, warmup=2, calls=K4_CALLS),
                 library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                     q, k, v, scale=scale), reps=10, warmup=2,
                     calls=K4_CALLS),
                 bound_ms=bound_ms, bound_by=bound_by,
                 exp_ms=1e3 * exps / PEAK_SFU, operations=mm, bytes=nbytes,
                 exponentials=exps, bitwise_repeat=True)
        t["plain_ms"] = cuda_ms(lambda: chunked(
            lambda a, b, c: va.global_attention_reference(a, b, c, scale),
            q, k, v), reps=2, warmup=1)
        summ["global_attention"][label] = t
        records.append(dict(kernel="global_attention", case=f"time_{label}",
                            dtype="bfloat16", shape=list(shape), **t))
        log(f"  K4f {label} bf16: {t['ms']:.3f} ms (SDPA {t['library_ms']:.3f}"
            f", plain {t['plain_ms']:.3f} in chunks of {PLAIN_CHUNK}, bound "
            f"{t['bound_ms']:.4f} by {t['bound_by']}; "
            f"{exps / 1e9:.2f} G exponentials = {t['exp_ms']:.3f} ms at "
            f"{PEAK_SFU / 1e12:.1f} T/s); two runs bitwise equal")
        if bwd:
            g1 = va.global_attention_backward(q, k, v, o, lse, do, scale)
            g2 = va.global_attention_backward(q, k, v, o, lse, do, scale)
            if not all(torch.equal(a, b) for a, b in zip(g1, g2)):
                fail(f"K4b {label} bf16: two runs differ")
            del g1, g2
            # least work: the five products S, dP, dV, dK, dQ and one
            # exponential per score; the kernels' two-pass split does seven
            # (S and dP in both passes) and two
            mm = 10 * B * K4_HEADS * N * N * K4_DH
            exps = B * K4_HEADS * N * N
            nbytes = 8 * elems * 2 + 4 * B * K4_HEADS * N
            bound_ms, bound_by = k4_bound(mm, exps, nbytes)
            ql, kl, vl = (t_.detach().requires_grad_() for t_ in (q, k, v))
            out = F.scaled_dot_product_attention(ql, kl, vl, scale=scale)

            def sdpa_fwd_bwd():
                o_ = F.scaled_dot_product_attention(ql, kl, vl, scale=scale)
                return torch.autograd.grad(o_, (ql, kl, vl), do)

            tb = dict(ms=cuda_ms(lambda: va.global_attention_backward(
                          q, k, v, o, lse, do, scale), reps=10, warmup=2,
                          calls=K4_CALLS),
                      # the same function: SDPA's backward alone
                      library_ms=cuda_ms(lambda: torch.autograd.grad(
                          out, (ql, kl, vl), do, retain_graph=True),
                          reps=10, warmup=2, calls=K4_CALLS),
                      library_fwd_bwd_ms=cuda_ms(sdpa_fwd_bwd, reps=10,
                                                 warmup=2, calls=K4_CALLS),
                      bound_ms=bound_ms, bound_by=bound_by,
                      exp_ms=1e3 * exps / PEAK_SFU, operations=mm,
                      bytes=nbytes, exponentials=exps,
                      design_operations=14 * B * K4_HEADS * N * N * K4_DH,
                      design_exponentials=2 * exps, bitwise_repeat=True)
            tb["plain_ms"] = cuda_ms(lambda: chunked(
                lambda *a: va.global_attention_backward_reference(*a, scale),
                q, k, v, o, lse, do), reps=2, warmup=1)
            summ["global_attention_backward"][label] = tb
            records.append(dict(kernel="global_attention_backward",
                                case=f"time_{label}", dtype="bfloat16",
                                shape=list(shape), **tb))
            log(f"  K4b {label} bf16: {tb['ms']:.3f} ms (SDPA bwd "
                f"{tb['library_ms']:.3f}, SDPA fwd+bwd "
                f"{tb['library_fwd_bwd_ms']:.3f}, plain {tb['plain_ms']:.3f}"
                f" in chunks, bound {tb['bound_ms']:.4f} by {tb['bound_by']}"
                f"; {exps / 1e9:.2f} G exponentials = {tb['exp_ms']:.3f} ms)"
                "; two runs bitwise equal")
            del ql, kl, vl, out
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    return summ


# ---------------------------------------------------------------------------
# phase 3/4: model and serving
# ---------------------------------------------------------------------------
def near_tie_ok(pred, ref_logits, err, ncls):
    """Decoded ids may differ from the reference's argmax only where the
    reference's top-2 margin is within 2*err (the largest logit error):
    returns (n_disagree, n_near_tie)."""
    import torch

    lg = ref_logits[..., :ncls].float()
    top2 = torch.topk(lg, 2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    ref_ids = lg.argmax(-1)
    bad = (pred.to(ref_ids.device) != ref_ids)
    near = margin <= 2 * err
    if bool((bad & ~near).any()):
        fail(f"{int((bad & ~near).sum())} decoded ids differ away from a "
             f"near tie (2*err = {2 * err:.3e})")
    return int(bad.sum()), int(near.sum())


def compare_models(pred_model, ref_model, x_pre, spec, rel_tol, what):
    """Raw outputs of two models on the same input, within rel_tol of the
    reference's largest magnitude; returns (ref raw output, max err)."""
    import torch

    with torch.inference_mode():
        a = pred_model(x_pre.to(next(pred_model.parameters()).device),
                       spec.task_name, spec.global_index)
        b = ref_model(x_pre.to(next(ref_model.parameters()).device),
                      spec.task_name, spec.global_index)
    if isinstance(b, dict):
        errs = {}
        for k in b:
            d = float((a[k].float().cpu() - b[k].float().cpu()).abs().max())
            top = float(b[k].float().abs().max())
            errs[k] = d
            if not d <= rel_tol * max(top, 1e-3):
                fail(f"{what} {spec.task_id} {k}: err {d:.3e} > "
                     f"{rel_tol} x {top:.3e}")
        return {k: v.float().cpu() for k, v in b.items()}, errs
    d = float((a.float().cpu() - b.float().cpu()).abs().max())
    top = float(b.float().abs().max())
    if not d <= rel_tol * max(top, 1e-3):
        fail(f"{what} {spec.task_id}: err {d:.3e} > {rel_tol} x {top:.3e}")
    return b.float().cpu(), d


def serve_closed_loop(svc, pool, tids):
    """Keep OUTSTANDING requests in flight (request k sends pool image
    k % len(pool)), submitting one as each completes, for SERVE_S
    seconds; then drain. Returns (completed, wall s, [(task id, latency
    ms)], [(pool index, result)])."""
    from concurrent.futures import FIRST_COMPLETED, wait

    lat, results, pending = [], [], {}
    k = 0

    def submit():
        nonlocal k
        j = k % len(pool)
        k += 1
        ts = time.perf_counter()
        f = svc.submit(pool[j], tids[j])
        # the completer thread fulfils the future; time it there
        f.add_done_callback(lambda _f, ts=ts, tid=tids[j]: lat.append(
            (tid, 1e3 * (time.perf_counter() - ts))))
        pending[f] = j

    t0 = time.perf_counter()
    while len(pending) < OUTSTANDING:
        submit()
    while pending:
        done, _ = wait(list(pending), return_when=FIRST_COMPLETED)
        for f in done:
            results.append((pending.pop(f), f.result()))
            if time.perf_counter() - t0 < SERVE_S:
                submit()
    wall = time.perf_counter() - t0
    while len(lat) < len(results):  # the last callbacks may still run
        time.sleep(1e-3)
    return len(results), wall, lat, results


def check_served(results, pred, pool, tids, refs, sizes):
    """Every served result against ``pred``'s (the Predictor's) on the
    same image: ``refs`` holds each pool image's result in batches of
    BATCH. In bf16 a forward's roundings, and so a random model's decoded
    answer at a near tie, change with the batch size (with the size they
    do not depend on the other images), so a result that differs from
    its ref is also held against the image repeated to each padded size
    the run's dispatches used (``sizes``, from the batcher's stats), and
    its best agreement counts. Ids equal except a few seg pixels,
    boxes/points within 2e-2. Returns how many results differ from the
    Predictor's at B=8 (for information)."""
    import numpy as np

    registry = pred.registry
    at_size = {}

    def agree(kind, got, ref):
        if kind == "segmentation":
            return float((got == ref).mean())
        if kind == "classification":
            return float(np.array_equal(got, ref))
        return float(np.allclose(got, ref, atol=2e-2))

    seg_agree, seg_n, other = 0.0, 0, 0
    for j, got in results:
        kind = registry[tids[j]].task_name
        best = agree(kind, got, refs[j])
        if best < 1.0:
            other += 1
            for size in sorted(set(sizes) - {BATCH}):
                if (j, size) not in at_size:
                    at_size[(j, size)] = pred.predict_images(
                        np.repeat(pool[j:j + 1], size, axis=0), tids[j])[0]
                best = max(best, agree(kind, got, at_size[(j, size)]))
        if kind == "segmentation":
            seg_agree += best
            seg_n += 1
        elif best < 1.0:
            fail(f"serving {tids[j]}: {kind} answer differs from Predictor "
                 f"at every padded size {sorted(sizes)} (at B={BATCH} by "
                 f"{np.abs(np.asarray(got, float) - refs[j]).max()})")
    if seg_n and seg_agree / seg_n < 0.999:
        fail(f"serving: seg masks agree on {seg_agree / seg_n:.5f} < 0.999")
    return {"differ_from_batch_8": other}


def profile_forward(pred, imgs, tid, out_dir, report, key="profile") -> None:
    """Host cost of enqueueing one forward with the GPU idle, and the
    host-side op table of one synced forward (torch.profiler), with the
    device time of the forward; into ``report[key]`` and
    ``chiprun_out/<key>_forward.txt`` (``profile_forward.txt``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    enq = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dev = pred.predict_device(imgs, tid)
        enq.append(1e3 * (time.perf_counter() - t0))
        dev.cpu()
    enq.sort()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pred.predict_images(imgs, tid)
    avg = prof.key_averages()
    table = avg.table(sort_by="self_cpu_time_total", row_limit=40)
    with open(os.path.join(out_dir, f"{key}_forward.txt"), "w") as f:
        f.write(table)
    watch = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "aten::item",
             "aten::_local_scalar_dense", "cudaHostAlloc", "cudaMalloc",
             "cudaFuncSetAttribute", "cudaLaunchKernel", "cudaMemcpyAsync")
    counts = {e.key: [e.count, round(e.self_cpu_time_total / 1e3, 3)]
              for e in avg if e.key in watch}
    n_ops = sum(e.count for e in avg if e.key.startswith("aten::"))
    dev_ms = sum(float(getattr(e, "self_device_time_total", 0.0)
                       or getattr(e, "self_cuda_time_total", 0.0))
                 for e in avg if str(getattr(e, "device_type", "")
                                     ).endswith("CUDA")) / 1e3
    report[key] = {"enqueue_ms_idle_gpu": enq, "calls": counts,
                   "aten_ops": n_ops, "device_ms": dev_ms}
    log(f"[{key}] enqueue of one B={BATCH} forward with the GPU idle: "
        f"median {enq[2]:.2f} ms; device time of one forward {dev_ms:.2f} "
        f"ms; {n_ops} aten ops; [count, self ms]: {counts}")
    for line in table.splitlines()[:16]:
        log("  " + line)


# ---------------------------------------------------------------------------
# phase 5: training
# ---------------------------------------------------------------------------
TRAIN_S = 6.0        # the timed round-robin, at least this long
FIXED_STEPS = 10     # steps on one fixed batch per type (the loss falls)
GRAD_IMAGE = 256     # the card-vs-CPU gradient check: B=1 at this size
# the grad check's kinks: the largest gap between the card's and the CPU's
# values over their largest magnitude, a few times the sound runs' largest
KINK_GAP = {"relu": 1e-4, "coords": 1e-4}
KERNEL_GROUPS = (    # kernel-name fragments of the profile's shares
    ("K4f", ("vitfa::fwd_",)),
    ("K4b", ("vitfa::dkv_", "vitfa::dq_", "vitfa::rowdot")),
    ("K1f", ("qkv_window_attn", "EpiResidual", "<swin::K1f",
             "attn_window_head", "attn_proj_residual")),
    ("K2f", ("mlp_fwd", "<swin::K2f")),
    # K2b's casts, row passes, GEMMs and reductions carry its tag
    ("K2b", ("mlp_dual", "swin::K2b")),
    ("K1b", ("swin::gemm_", "sm90::gemm_sm90", "attn_core_bwd",
             "swin::ln_rows", "swin::ln_bwd", "scale_rows", "colsum",
             "reduce_slots", "cast_weights")),
    ("library gemm/conv", ("nvjet", "gemm", "conv", "cudnn", "cutlass",
                           "xmma", "wgrad", "dgrad", "fprop", "sm90_")),
)


def train_batches(registry, B, S, seed):
    """One batch per task type, as bench.py:144-163 makes them."""
    import numpy as np

    rng = np.random.RandomState(seed)
    out = {}
    for ttype, tid in (("segmentation", "T2A_fetal_abdomen"),
                       ("classification", "T3A_breast_tumor"),
                       ("detection", "T4A_fetal_brain"),
                       ("Regression", "T5_fetal_femur")):
        image = rng.randint(0, 255, (B, S, S, 3)).astype(np.uint8)
        if ttype == "segmentation":
            label = rng.randint(0, 2, (B, S, S)).astype(np.int32)
        elif ttype == "classification":
            label = rng.randint(0, 2, (B,)).astype(np.int32)
        elif ttype == "detection":
            x1 = rng.uniform(0.1, 0.5, (B, 1))
            y1 = rng.uniform(0.1, 0.5, (B, 1))
            label = np.concatenate([x1, y1, x1 + 0.3, y1 + 0.3],
                                   axis=1).astype(np.float32)
        else:
            label = rng.rand(B, 8).astype(np.float32)
        out[ttype] = {"image": image, "label": label, "task_id": tid,
                      "task_index": registry[tid].global_index,
                      "task_type": ttype}
    return out


def learnable_batches(registry, B, S, seed):
    """One batch per task type with something to fit in ten steps: a
    bright square on a dark noisy ground; the label is the square's mask
    (seg), its box (det) and its corners (reg); for cls the class is
    whether the whole image is bright. bench.py's random labels leave a
    Dice loss at 0.5 and the CE of 24 random labels to the noise of
    dropout, whatever the model does."""
    import numpy as np

    rng = np.random.RandomState(seed)
    out = {}
    for ttype, tid in (("segmentation", "T2A_fetal_abdomen"),
                       ("classification", "T3A_breast_tumor"),
                       ("detection", "T4A_fetal_brain"),
                       ("Regression", "T5_fetal_femur")):
        image = rng.randint(20, 80, (B, S, S, 3)).astype(np.uint8)
        mask = np.zeros((B, S, S), np.int32)
        box = np.zeros((B, 4), np.float32)
        present = np.arange(B) % 2
        for i in range(B):
            side = rng.randint(S // 4, S // 2)
            y, x = rng.randint(0, S - side, 2)
            box[i] = np.array([x, y, x + side, y + side]) / S
            if ttype == "classification":  # apart under any augmentation
                image[i] = image[i] // 2 + np.uint8(215 * present[i])
            else:
                image[i, y:y + side, x:x + side] += 140
                mask[i, y:y + side, x:x + side] = 1
        x1, y1, x2, y2 = box.T
        label = {"segmentation": mask,
                 "classification": present.astype(np.int32),
                 "detection": box,
                 "Regression": np.stack([x1, y1, x2, y1, x2, y2, x1, y2],
                                        axis=1)}[ttype]
        out[ttype] = {"image": image, "label": label, "task_id": tid,
                      "task_index": registry[tid].global_index,
                      "task_type": ttype}
    return out


def range_device_us(events, range_name):
    """Device us under the ``record_function`` ranges named
    ``range_name`` in a profile: the forward's kernels under the ranges,
    and the backward's, the autograd nodes ("autograd::engine::
    evaluate_function: ...") whose sequence number is one of those forward
    ops' (the engine tags each node with its forward op's)."""

    def dev_us(e):
        t = getattr(e, "device_time_total", None)
        return float(getattr(e, "cuda_time_total", 0.0) if t is None else t)

    def is_cpu(e):
        return str(getattr(e, "device_type", "")).endswith("CPU")

    ranges = [e for e in events if e.name == range_name and is_cpu(e)]
    seqs, stack = set(), list(ranges)
    while stack:
        e = stack.pop()
        if getattr(e, "sequence_nr", -1) >= 0:
            seqs.add(e.sequence_nr)
        stack.extend(e.cpu_children)
    bwd = [e for e in events if is_cpu(e)
           and e.name.startswith("autograd::engine::evaluate_function")
           and getattr(e, "sequence_nr", -1) in seqs]
    return {"ranges": len(ranges), "fwd_us": sum(dev_us(e) for e in ranges),
            "bwd_nodes": len(bwd), "bwd_us": sum(dev_us(e) for e in bwd)}


def profile_train_round(trainer, batches, out_dir, report, key):
    """torch.profiler over one step of each type: the device time by kernel
    group, and the op table (chiprun_out/profile_<key>_step.txt)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for b in batches.values():
            trainer.train_batch(b, 0)
        torch.cuda.synchronize()
    avg = prof.key_averages()
    with open(os.path.join(out_dir, f"profile_{key}_step.txt"), "w") as f:
        f.write(avg.table(sort_by="self_device_time_total", row_limit=60))

    def dev_us(e):
        return float(getattr(e, "self_device_time_total", 0.0)
                     or getattr(e, "self_cuda_time_total", 0.0))

    kern = [e for e in avg
            if str(getattr(e, "device_type", "")).endswith("CUDA")
            and dev_us(e) > 0]
    total = sum(dev_us(e) for e in kern)
    shares = {g: 0.0 for g, _ in KERNEL_GROUPS}
    shares["elementwise/other"] = 0.0
    for e in kern:
        for g, frags in KERNEL_GROUPS:
            if any(f in e.key for f in frags):
                shares[g] += dev_us(e)
                break
        else:
            shares["elementwise/other"] += dev_us(e)
    report[key]["profile"] = {
        "device_ms_per_round": total / 1e3, "kernels": len(kern),
        "share": {g: v / max(total, 1e-9) for g, v in shares.items()}}
    log(f"[{key}] profile of one step per type: {total / 1e3:.1f} ms of "
        f"device time; share " + ", ".join(
            f"{g} {v / max(total, 1e-9):.3f}" for g, v in shares.items()))
    from fmc_uia_tpu_torch.models.conditioning import MOE_RANGE
    from fmc_uia_tpu_torch.models.encoders.adapters import SPM_RANGE

    events = prof.events()
    for rkey, rname, what, also in (
            ("moe", MOE_RANGE, "MoE blocks", "the MoE's convolutions"),
            ("spm_adapter", SPM_RANGE, "SPM-interaction adapter",
             "its convolutions")):
        rd = range_device_us(events, rname)
        if not rd["ranges"]:
            continue
        share = {k: rd[k] / max(total, 1e-9) for k in ("fwd_us", "bwd_us")}
        report[key]["profile"][rkey] = dict(
            rd, share_fwd=share["fwd_us"], share_bwd=share["bwd_us"])
        log(f"[{key}] {what} ({rd['ranges']} profiler ranges "
            f"'{rname}'): forward {rd['fwd_us'] / 1e3:.2f} ms = share "
            f"{share['fwd_us']:.3f}, backward {rd['bwd_us'] / 1e3:.2f} ms "
            f"= share {share['bwd_us']:.3f} ({rd['bwd_nodes']} autograd "
            f"nodes linked by sequence number) of the round's device time; "
            f"both {share['fwd_us'] + share['bwd_us']:.3f} ({also} also "
            f"count in 'library gemm/conv' above)")


def swin_preset():
    """The flagship preset of phase 5: its config dict, the kernels a
    train step launches and how often (K1f/K1b 24, K2f/K2b 4)."""
    from fmc_uia_tpu_torch.flagship import flagship_config_dict
    from fmc_uia_tpu_torch.ops import swin_block as sb

    per_step = ((sb.attention_branch, 24), (sb.attention_branch_backward, 24),
                (sb.mlp_branch, 4), (sb.mlp_branch_backward, 4))
    return dict(key="train", what="flagship swin_b",
                config=flagship_config_dict, per_step=per_step)


def dino_preset():
    """The DINOv3 ViT-B/8 preset of phase 8: K4f and K4b once per block
    (12) a step."""
    from fmc_uia_tpu_torch.flagship import dino_patch8_config_dict
    from fmc_uia_tpu_torch.ops import vit_attention as va

    per_step = ((va.global_attention, 12), (va.global_attention_backward, 12))
    return dict(key="dino_train", what="DINOv3 ViT-B/8",
                config=dino_patch8_config_dict, per_step=per_step,
                grad_types=("segmentation",))


def step_enqueue_ms(trainer, batches, reps=5):
    """Median host ms of one ``train_batch`` call per type with the card
    idle: the step's host work (its launches, and any wait it makes on
    the card), beside the device ms the profile gives."""
    import numpy as np
    import torch

    out = {}
    for t, b in batches.items():
        vals = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.train_batch(b, 0)
            vals.append(1e3 * (time.perf_counter() - t0))
        out[t] = float(np.median(vals))
    torch.cuda.synchronize()
    return out


def check_moe_logs(logs, top_k, key):
    """Every step's ``moe_aux`` finite; ``moe_importance`` (per expert,
    the mean over the blocks) sums to 1 and ``moe_load`` to top_k within
    1e-5. Returns the worst deviations and the mean importance/load."""
    import torch

    aux = torch.stack([g["moe_aux"] for g in logs]).float().cpu()
    imp = torch.stack([g["moe_importance"] for g in logs]).float().cpu()
    load = torch.stack([g["moe_load"] for g in logs]).float().cpu()
    if not bool(torch.isfinite(aux).all()):
        fail(f"{key}: non-finite moe_aux {aux.tolist()}")
    imp_dev = float((imp.sum(1) - 1.0).abs().max())
    load_dev = float((load.sum(1) - top_k).abs().max())
    if not (imp_dev <= 1e-5 and load_dev <= 1e-5):
        fail(f"{key}: moe_importance sums off 1 by {imp_dev:.2e}, moe_load "
             f"sums off {top_k} by {load_dev:.2e}")
    rep = {"steps": len(logs), "aux_min": float(aux.min()),
           "aux_max": float(aux.max()), "importance_sum_dev": imp_dev,
           "load_sum_dev": load_dev, "importance_mean": imp.mean(0).tolist(),
           "load_mean": load.mean(0).tolist()}
    log(f"[{key}] MoE over {len(logs)} steps: moe_aux "
        f"{rep['aux_min']:.4f}..{rep['aux_max']:.4f} (finite); importance "
        f"sums to 1 within {imp_dev:.1e}, load to {top_k} within "
        f"{load_dev:.1e}; mean load per expert "
        f"{[round(v, 3) for v in rep['load_mean']]}")
    return rep


def train_phase(name, smi, report, out_dir, preset, full=True):
    """A preset's Trainer in bf16 at its batch and image size (default B=24
    at 512²): a warm-up step per type, a timed round-robin, the launch
    counts, the host ms of enqueueing a step, one profiled round, and
    (``full``) a falling loss on a fixed batch and f32 grads on the card
    against the CPU's. With MoE blocks the
    timed run's ``moe_aux`` must be finite, ``moe_importance`` sum to 1
    and ``moe_load`` to top_k within 1e-5. Returns the timed run's launch
    counts."""
    import numpy as np
    import torch

    from fmc_uia_tpu_torch.config import Config
    from fmc_uia_tpu_torch.models import build_model
    from fmc_uia_tpu_torch.tasks import TaskRegistry
    from fmc_uia_tpu_torch.train import Trainer

    key, tag = preset["key"], f"[{preset['key']}]"
    counters = [c for c, _ in preset["per_step"]]
    cfg = Config(config_dict=preset["config"]())
    registry = TaskRegistry.from_config(cfg)
    model = build_model(cfg, registry, dtype=torch.bfloat16, device="cuda",
                        generator=torch.Generator().manual_seed(0))
    trainer = Trainer(cfg, model, registry, device="cuda", seed=0)
    B, S = preset.get("batch", TRAIN_BATCH), preset.get("image", IMAGE)
    top_k = (int(cfg.get("model.moe.top_k", 1))
             if cfg.get("model.moe.enabled", False) else None)
    batches = {t: trainer.put_batch(b) for t, b in train_batches(
        registry, B, S, seed=0).items()}
    report[key] = {"batch": B, "image": S, "model": preset["what"]}

    first = {}
    for t, b in batches.items():  # warm-up: allocator, cuDNN heuristics
        t0 = time.perf_counter()
        float(trainer.train_batch(b, 0)["total_loss"])
        first[t] = time.perf_counter() - t0
    log(f"{tag} first step per type (s, host clock, synced): "
        f"{ {k: round(v, 2) for k, v in first.items()} }")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    timed, losses, moe_logs = [], [], []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < TRAIN_S:
        for t, b in batches.items():
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            logs = trainer.train_batch(b, 0)
            ev[1].record()
            losses.append(logs["total_loss"])
            if top_k is not None:
                moe_logs.append(logs)
            timed.append((t, ev))
    float(losses[-1])  # a data read: the device has finished every step
    wall = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    steps = len(timed)
    want = {c.__name__: n * steps for c, n in preset["per_step"]}
    if launches != want:
        fail(f"{key} launches {launches} != {want} ({steps} steps)")
    stacked = torch.stack(losses).float()
    if not bool(torch.isfinite(stacked).all()):
        fail(f"non-finite train losses: {stacked.tolist()}")
    if top_k is not None:
        report[key]["moe"] = check_moe_logs(moe_logs, top_k, key)
    ms = {t: float(np.median([ev[0].elapsed_time(ev[1])
                              for u, ev in timed if u == t]))
          for t in batches}
    peak = torch.cuda.max_memory_allocated()
    img_s = steps * B / wall
    report[key].update(
        steps=steps, wall_s=wall, img_s=img_s, ms_per_step_by_type=ms,
        peak_bytes=peak, launches=launches, first_step_s=first)
    log(f"{tag} {preset['what']}: {steps} steps (round-robin over 4 types)"
        f" x B={B} at {S}² in {wall:.2f} s: {img_s:.2f} img/s; ms per step by "
        f"type (CUDA events) { {k: round(v, 1) for k, v in ms.items()} }; "
        f"peak memory {peak / 2**30:.2f} GiB; launches {launches}; losses "
        f"finite | {name} | {smi}")

    enq = step_enqueue_ms(trainer, batches)
    report[key]["enqueue_ms_idle_gpu"] = enq
    log(f"{tag} host ms to enqueue one step per type, card idle (median "
        f"of 5): { {k: round(v, 2) for k, v in enq.items()} }; wall ms a "
        f"step in the timed run {1e3 * wall / steps:.2f}")

    profile_train_round(trainer, batches, out_dir, report, key)
    if not full:
        return launches

    falls = {}
    fixed = learnable_batches(registry, B, S, seed=2)
    for t, b in fixed.items():  # the loss falls on a fixed batch
        b = trainer.put_batch(b)
        vals = [float(trainer.train_batch(b, 0)["total_loss"])
                for _ in range(FIXED_STEPS)]
        if not np.mean(vals[-3:]) < vals[0]:
            fail(f"{t}: loss did not fall over {FIXED_STEPS} steps on "
                 f"one batch: {vals}")
        falls[t] = vals
    report[key]["fixed_batch_losses"] = falls
    log(f"{tag} {FIXED_STEPS} steps on one batch per type, first -> "
        f"mean of last 3: " + ", ".join(
            f"{t} {v[0]:.4f} -> {np.mean(v[-3:]):.4f}"
            for t, v in falls.items()))
    del trainer, model, batches
    torch.cuda.empty_cache()
    check_train_grads(report, preset)
    return launches


def grad_pair(preset):
    """The grad check's pair: the preset's model in f32 on the card
    (weights from ``grad_seed``) and a copy on the CPU, their Trainers,
    and one ``learnable_batches`` batch per type at B=1, 256² (or the
    preset's ``grad_image``), augmentation, dropout and drop path off."""
    import torch

    from fmc_uia_tpu_torch.config import Config
    from fmc_uia_tpu_torch.models import build_model
    from fmc_uia_tpu_torch.tasks import TaskRegistry
    from fmc_uia_tpu_torch.train import Trainer

    d = preset["config"]()
    grad_image = preset.get("grad_image", GRAD_IMAGE)
    d["data"]["image_size"] = grad_image
    d["data"]["augmentation"]["train"].update(
        random_brightness_contrast=0.0, gauss_noise=0.0)
    name = d["model"]["encoder"]["name"]
    if name.startswith("swin") or "convnext" in name:
        d["model"]["encoder"]["drop_path_rate"] = 0.0
    d["model"]["decoder"]["dropout"] = 0.0
    for h in ("classification", "regression"):
        d["model"]["heads"][h]["dropout"] = 0.0
    cfg = Config(config_dict=d)
    registry = TaskRegistry.from_config(cfg)
    gen = torch.Generator().manual_seed(preset.get("grad_seed", 1))
    card = build_model(cfg, registry, dtype=torch.float32, device="cuda",
                       generator=gen)
    cpu = build_model(cfg, registry, dtype=torch.float32, device="cpu")
    cpu.load_state_dict(card.state_dict())
    # the learnable batches: with bench.py's random seg labels a seg grad
    # summed over every pixel nearly cancels, and its f32 rounding in
    # another order came to 8.7e-4 of its leaf's largest magnitude
    return (card, cpu, Trainer(cfg, card, registry, device="cuda"),
            Trainer(cfg, cpu, registry, device="cpu"),
            learnable_batches(registry, 1, grad_image, seed=1))


def cpu_f32_relu_gap(model, b, mean, std):
    """The CPU's own f32 rounding at the ReLU inputs of ``model``'s
    forward on batch ``b``: the largest gap, over the range of each call's
    input, between ``model``'s f32 forward and an f64 forward of a copy
    (every module's compute dtype, and every ``.float()`` of the port's
    f32 statistics, taken to f64). A deep stack of GroupNorms computed as
    E[x²] - E[x]² (the JAX package's fast variance) moves a deep ReLU input
    by 2-3e-4 of its range in f32 alone (ResNet-50's cls step at 256²)."""
    import copy

    import torch
    import torch.nn.functional as F

    from fmc_uia_tpu_torch.ops.image import normalize_images

    x = normalize_images(torch.from_numpy(b["image"]), mean, std)
    m64 = copy.deepcopy(model).double()
    for mod in m64.modules():
        if isinstance(mod.__dict__.get("dtype"), torch.dtype):
            mod.dtype = torch.float64
    relu, to_float = F.relu, torch.Tensor.float
    runs = []
    try:
        for m, xx in ((model, x), (m64, x.double())):
            rec = []
            F.relu = lambda t, inplace=False, rec=rec: (
                rec.append(t.detach().double()), relu(t, inplace))[1]
            if m is m64:
                torch.Tensor.float = lambda self, *a, **k: (
                    self if self.dtype == torch.float64
                    else to_float(self, *a, **k))
            with torch.no_grad():
                m(xx, b["task_type"], b["task_index"])
            runs.append(rec)
    finally:
        F.relu, torch.Tensor.float = relu, to_float
    return max((float((p - q).abs().max()) / max(float(q.abs().max()), 1e-30)
                for p, q in zip(*runs)), default=0.0)


def check_train_grads(report, preset):
    """One step's grads in f32 on the card against f32 on the CPU, B=1 at
    256² (or the preset's ``grad_image``), the same weights and batch
    (``learnable_batches``), augmentation, dropout and drop path off:
    every leaf within 1e-3 of its largest magnitude (kernel sums in another
    order, cuDNN against CPU convolutions, TF32 off). The CPU takes the
    card's side at each kink the two runs put on different sides
    (``KinkAlign``: a ReLU input of the other sign, a deformable sample in
    another bilinear cell), and the gaps between the two sides' values
    there must be rounding: within KINK_GAP of their range, or, for the
    ReLU inputs, within 3 x the CPU's own f32 rounding there
    (``cpu_f32_relu_gap``: each device's error within about that of the
    exact value), which is measured only where KINK_GAP is exceeded. One
    exception, MoE only: the router leaves of a block whose output the
    step's head does not read (stage 2 for cls and reg, which read the
    last stage alone) have an exact grad of zero (at B=1 each block's
    balance loss is the constant E: the one sample's renormalised gates
    sum to 1), so both sides must be within 1e-6 of the step's largest
    grad magnitude of it."""
    card, cpu, tc, tp, batches = grad_pair(preset)
    if "grad_types" in preset:
        batches = {t: b for t, b in batches.items()
                   if t in preset["grad_types"]}
    worst = {}
    last = len(card.encoder.out_channels) - 1
    for t, b in batches.items():
        with KinkAlign(card) as at_c:
            lc = tc.compute_grads(b)
        with KinkAlign(cpu, at=at_c) as at_p:
            lp = tp.compute_grads(b)
        kinks = at_p.compare()
        f32_gap = None
        for kind, (gap, _, _, site) in kinks.items():
            bound = KINK_GAP[kind]
            if kind == "relu" and not gap <= bound:
                norm = tp.config.get("data.augmentation.normalize")
                f32_gap = cpu_f32_relu_gap(cpu, b, norm["mean"], norm["std"])
                bound = max(bound, 3 * f32_gap)
                log(f"[{preset['key']}] {t}: ReLU inputs card vs CPU "
                    f"{gap:.2e} of their range at {site}; the CPU's own f32 "
                    f"rounding (f32 vs f64) {f32_gap:.2e}: bound {bound:.2e}")
            if not gap <= bound:
                fail(f"{t}: {kind} card vs CPU differ by {gap:.2e} of their "
                     f"range at {site} (> {bound:.2e})")
        rel, leaf = 0.0, None
        unread = () if card._needs_fpn(t) else tuple(
            f"moe_stage{i}." for i in card.moe_stages if i != last)
        gmax = max(float(p.grad.abs().max()) for p in cpu.parameters())
        zero = 0.0
        for (n, pc), (_, pp) in zip(card.named_parameters(),
                                    cpu.named_parameters()):
            if n.startswith(unread) and ("router_fc" in n
                                         or "task_embed" in n):
                v = max(float(pc.grad.abs().max()), float(pp.grad.abs().max()))
                if not v <= 1e-6 * gmax:
                    fail(f"{t} grad {n}: {v:.3e} where the exact grad is "
                         f"0 (> 1e-6 x {gmax:.3e})")
                zero = max(zero, v / gmax)
                continue
            err = float((pc.grad.cpu() - pp.grad).abs().max())
            top = float(pp.grad.abs().max())
            if not err <= 1e-3 * top:
                if "offset_proj" in n:
                    log(f"[{preset['key']}] sample positions within 1e-6 of"
                        f" an integer pixel (near / all), CPU: "
                        f"{at_p.near_integer()}")
                log(f"[{preset['key']}] {t} kinks taken from the card: "
                    f"{kinks}; ReLU sign changes by site: "
                    f"{at_p.relu_flips()}")
                fail(f"{t} grad {n}: card vs CPU err {err:.3e} > 1e-3 x "
                     f"{top:.3e}")
            if top > 0 and err / top > rel:
                rel, leaf = err / top, n
        worst[t] = {"worst_err_over_max": rel, "worst_leaf": leaf,
                    "cpu_f32_relu_gap": f32_gap,
                    "loss_card": float(lc["total_loss"]),
                    "loss_cpu": float(lp["total_loss"]),
                    "kinks": kinks, "relu_flips": at_p.relu_flips()}
        if unread:
            worst[t]["zero_leaves_max_over_grad_max"] = zero
        if "moe_aux" in lc:
            worst[t]["moe_aux_card_cpu"] = [float(lc["moe_aux"]),
                                            float(lp["moe_aux"])]
    report[preset["key"]]["grads_card_vs_cpu"] = worst
    log(f"[{preset['key']}] f32 grads card vs CPU, B=1 "
        f"{preset.get('grad_image', GRAD_IMAGE)}²: worst "
        f"leaf err / leaf max by type " + ", ".join(
            f"{t} {v['worst_err_over_max']:.2e} ({v['worst_leaf']})"
            for t, v in worst.items()))
    log(f"[{preset['key']}] kinks the CPU took from the card (gap / range, "
        f"on the other side / all): " + "; ".join(
            f"{t} " + ", ".join(f"{k} {g:.2e} {n}/{m}"
                                for k, (g, n, m, _) in v["kinks"].items())
            for t, v in worst.items()))


# ---------------------------------------------------------------------------
# phase 6: fit from disk
# ---------------------------------------------------------------------------
FIT_FRAME = (576, 768)   # frames above 512 on both axes: the host resizes
# 30 frames per task leave 24 in the train split (val_split 0.2), so every
# train batch holds 24 images: with fewer train rows than a batch the
# sampler's wraparound yields short batches (12 rows: 24 then 12)
FIT_PER_TASK = 30
FIT_STEPS = 12           # steps per epoch


def host_frame_ms(path):
    """Median ms of each host step on one frame, on one thread: PNG chunks
    with their CRCs, inflate (zlib), unfilter (the host helper), the
    whole decode, and the bilinear resize to the train size."""
    import zlib

    import numpy as np

    from fmc_uia_tpu_torch.data import image_io

    with open(path, "rb") as f:
        data = f.read()
    idat = b"".join(b for k, b in image_io._chunks(data) if k == b"IDAT")
    raw = zlib.decompress(idat)
    img = image_io.decode_png(data, False)
    h, w = img.shape[:2]
    rows = np.empty((h, w * 3), np.uint8)
    lib = image_io._lib()
    steps = {
        "chunks_crc": lambda: list(image_io._chunks(data)),
        "inflate": lambda: zlib.decompress(idat),
        "unfilter": lambda: lib.png_unfilter(raw, image_io._u8p(rows), h,
                                             w * 3, 3),
        "decode": lambda: image_io.decode_png(data, False),
        "resize": lambda: image_io.resize_bilinear(img, IMAGE, IMAGE),
    }
    out = {}
    for k, fn in steps.items():
        ts = []
        for _ in range(11):
            t0 = time.perf_counter()
            fn()
            ts.append(1e3 * (time.perf_counter() - t0))
        out[k] = float(np.median(ts))
    return out


_FRAMES = {}  # the tasks (JSON) -> (root, MB): frames written this run


def write_flagship_frames(tasks, tag):
    """Phase 6's data: the flagship's tasks x FIT_PER_TASK 576x768 PNGs,
    one task per call (seeded by its index) on 8 threads (zlib and numpy
    release the GIL), written once a run into a directory of its own
    (removed at exit): phases 11, 12e and 13c read the same files.
    Returns (root, seconds spent writing here, MB)."""
    import atexit
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from fmc_uia_tpu_torch.data.synthetic import generate_synthetic_dataset

    key = json.dumps(tasks, sort_keys=True)
    if key in _FRAMES:
        root, data_mb = _FRAMES[key]
        log(f"{tag} reads the {len(tasks)} tasks x {FIT_PER_TASK} frames "
            "written before")
        return root, 0.0, data_mb
    tmp = tempfile.mkdtemp(prefix="chip_smoke_frames_")
    atexit.register(shutil.rmtree, tmp, True)
    root = os.path.join(tmp, "data")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as ex:
        list(ex.map(lambda it: generate_synthetic_dataset(
            root, tasks=[it[1]], samples_per_task=FIT_PER_TASK,
            image_hw=FIT_FRAME, seed=it[0]), enumerate(tasks)))
    gen_s = time.perf_counter() - t0
    data_mb = sum(os.path.getsize(os.path.join(r, f))
                  for r, _, fs in os.walk(root) for f in fs) / 1e6
    log(f"{tag} wrote {len(tasks)} tasks x {FIT_PER_TASK} frames "
        f"{FIT_FRAME[0]}x{FIT_FRAME[1]} (PNG, {data_mb:.0f} MB) in "
        f"{gen_s:.1f} s")
    _FRAMES[key] = (root, data_mb)
    return root, gen_s, data_mb


def fit_phase(name, smi, report, staged_img_s):
    """The flagship trained from PNG files through ``fit`` and resumed;
    returns the launch counts of both runs."""
    import copy
    import shutil
    import tempfile

    import numpy as np
    import torch

    from fmc_uia_tpu_torch.config import Config
    from fmc_uia_tpu_torch.fit import fit
    from fmc_uia_tpu_torch.flagship import flagship_config_dict
    from fmc_uia_tpu_torch.ops import preprocess as pp
    from fmc_uia_tpu_torch.ops import swin_block as sb

    counters = (sb.attention_branch, sb.attention_branch_backward,
                sb.mlp_branch, sb.mlp_branch_backward, pp.augment_normalize)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fit_")
    try:
        d = flagship_config_dict()
        root, gen_s, data_mb = write_flagship_frames(d["tasks"], "[fit]")
        frame_ms = host_frame_ms(os.path.join(
            root, "images", f"{d['tasks'][0]['task_id']}_0000.png"))
        log(f"[fit] host ms per frame, one thread (median of 11): "
            + ", ".join(f"{k} {v:.2f}" for k, v in frame_ms.items()))
        d["data"].update(root_path=root, fused_preprocess=True)
        d["experiment"].update(output_dir=os.path.join(tmp, "out"),
                               checkpoint_freq=1)
        d["training"].update(num_epochs=2, steps_per_epoch=FIT_STEPS)
        d["validation"].update(enabled=True, freq=1)
        torch.cuda.synchronize()
        for c in counters:
            c.launches = 0
        by_kernel = pp.augment_normalize.launches_by_kernel
        by_kernel.update(vector=0, edge=0)
        t0 = time.perf_counter()
        r1 = fit(config=Config(config_dict=copy.deepcopy(d)), device="cuda")
        fit1_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        d["training"]["num_epochs"] = 3
        t0 = time.perf_counter()
        r2 = fit(config=Config(config_dict=d), resume=True, device="cuda")
        torch.cuda.synchronize()
        fit2_s = time.perf_counter() - t0
        launches = {c.__name__: c.launches for c in counters}
        k3_kernels = dict(by_kernel)
        exp = r2["experiment_dir"]
        with open(os.path.join(exp, "training_history.json")) as f:
            hist = json.load(f)
        ckpts = sorted(f for f in os.listdir(exp) if f.endswith(".pt"))
        out_mb = sum(os.path.getsize(os.path.join(exp, f))
                     for f in os.listdir(exp)) / 1e6
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    epochs = r1["epoch_stats"] + r2["epoch_stats"]
    steps = sum(e["steps"] for e in epochs)
    evals = r1["eval_batches"] + r2["eval_batches"]
    want = {"attention_branch": 24 * (steps + evals),
            "attention_branch_backward": 24 * steps,
            "mlp_branch": 4 * (steps + evals),
            "mlp_branch_backward": 4 * steps, "augment_normalize": steps}
    if launches != want:
        fail(f"fit launches {launches} != {want} ({steps} train steps, "
             f"{evals} eval batches)")
    # the train batch is a fresh [24, 512, 512, 3] tensor: every K3 launch
    # must take the 16-byte chunk kernel
    if k3_kernels != {"vector": steps, "edge": 0}:
        fail(f"fit: K3 kernels {k3_kernels}, not {steps} of the chunk "
             "kernel")
    if [e["epoch"] for e in r2["epoch_stats"]] != [3]:
        fail(f"the resumed run ran epochs "
             f"{[e['epoch'] for e in r2['epoch_stats']]}, not [3]")
    if exp != r1["experiment_dir"]:
        fail(f"resume opened {exp}, not {r1['experiment_dir']}")
    if [e["epoch"] for e in hist] != [1, 2, 3]:
        fail(f"history epochs {[e['epoch'] for e in hist]} != [1, 2, 3]")
    losses = {e["epoch"]: {t: v["mean"] for t, v in e["train_losses"].items()}
              for e in hist}
    if not all(np.isfinite(v) for e in losses.values() for v in e.values()):
        fail(f"non-finite train losses: {losses}")
    B = TRAIN_BATCH
    if any(e["images"] != B * e["batches"] for e in epochs):
        fail(f"train batches of fewer than {B} images: {epochs}")
    batches = sum(e["batches"] for e in epochs)
    host_ms = 1e3 * sum(e["host_load_s"] for e in epochs) / batches
    per_epoch = [{"epoch": e["epoch"], "steps": e["steps"],
                  "loop_s": e["loop_s"],
                  "img_s": e["images"] / e["loop_s"],
                  "queue_wait_share": e["queue_wait_s"] / e["loop_s"],
                  "host_ms_per_batch": 1e3 * e["host_load_s"] / e["batches"],
                  "put_ms_per_batch": 1e3 * e["host_put_s"] / e["batches"]}
                 for e in epochs]
    steady = [e for e in per_epoch if e["epoch"] > 1]
    rep = dict(frames=FIT_FRAME, per_task=FIT_PER_TASK, data_mb=data_mb,
               gen_s=gen_s, host_frame_ms=frame_ms, fit1_s=fit1_s, fit2_s=fit2_s, epochs=per_epoch,
               host_ms_per_batch=host_ms, launches=launches,
               k3_kernels=k3_kernels, train_steps=steps, eval_batches=evals,
               mean_losses={k: float(np.mean(list(v.values())))
                            for k, v in losses.items()},
               val=hist[-1].get("val_metrics", []),
               best_score=r2["best_score"], best_epoch=r2["best_epoch"],
               best_eval_on_train=r2["best_eval_on_train"],
               checkpoints=ckpts, experiment_mb=out_mb,
               staged_img_s=staged_img_s)
    report["fit"] = rep
    log(f"[fit] fit: 2 epochs x {FIT_STEPS} steps at B={B} + validation and "
        f"a checkpoint each, {fit1_s:.1f} s; resume to epoch 3: "
        f"{fit2_s:.1f} s; {steps} train steps, {evals} eval batches")
    log(f"[fit] host decode + resize + collate: {host_ms:.1f} ms per batch "
        f"of {B} at 4 workers; put (pin + copy enqueue) "
        + ", ".join(f"{e['put_ms_per_batch']:.1f}" for e in per_epoch)
        + " ms per batch by epoch")
    for e in per_epoch:
        log(f"[fit] epoch {e['epoch']}: {e['steps']} steps in "
            f"{e['loop_s']:.2f} s = {e['img_s']:.2f} img/s from disk; queue "
            f"wait {100 * e['queue_wait_share']:.2f} % of the loop; host "
            f"{e['host_ms_per_batch']:.1f} ms per batch")
    log(f"[fit] steady img/s from disk (epochs 2-3) "
        + ", ".join(f"{e['img_s']:.2f}" for e in steady)
        + f" vs phase 5 staged {staged_img_s:.2f} | {name} | {smi}")
    log(f"[fit] mean train loss by epoch "
        + ", ".join(f"{k}: {v:.4f}" for k, v in rep["mean_losses"].items()))
    for row in rep["val"]:
        log("  val " + ", ".join(f"{k} {v:.4f}" if isinstance(v, float)
                                 else f"{k} {v}" for k, v in row.items()))
    log(f"[fit] best score {r2['best_score']:.4f} (epoch "
        f"{r2['best_epoch']}); best model on the train split "
        f"{r2['best_eval_on_train']}")
    log(f"[fit] resume: latest checkpoint epoch 2 -> ran epoch 3 in the same "
        f"experiment dir; history epochs {[e['epoch'] for e in hist]}; files "
        f"{ckpts} ({out_mb:.0f} MB); launches {launches}; K3 by kernel "
        f"{k3_kernels}")
    return launches


def serve_once(pred, rng, per_dispatch, what):
    """One closed loop of OUTSTANDING requests for >= SERVE_S through a
    ``StreamingPredictor(max_batch=8)`` over ``pred``'s model, after its
    warm-up: a pool of 64 images, image j with task j % 4, every result
    held against ``pred`` (batches of 8 per task). The launch counters of
    ``per_dispatch`` ((kernel, launches a forward), ...) are zeroed just
    before the first request and must read that many a dispatch just after
    the last. Returns img/s, p50/p99 ms, dispatches and launches."""
    import numpy as np
    import torch

    from fmc_uia_tpu_torch.flagship import SERVING_TASKS
    from fmc_uia_tpu_torch.serving import StreamingPredictor

    S, registry = pred.image_size, pred.registry
    svc = StreamingPredictor(pred.model, registry,
                             pred.mean.tolist(), pred.std.tolist(), S,
                             max_batch=BATCH, max_delay_ms=5.0,
                             device="cuda")
    svc.warmup(task_ids=list(SERVING_TASKS))
    pool = rng.randint(0, 256, (OUTSTANDING, S, S, 3)).astype(np.uint8)
    tids = [SERVING_TASKS[j % 4] for j in range(OUTSTANDING)]
    refs = [None] * OUTSTANDING
    for tid in SERVING_TASKS:
        idx = [j for j in range(OUTSTANDING) if tids[j] == tid]
        for k in range(0, len(idx), BATCH):
            for j, res in zip(idx[k:k + BATCH],
                              pred.predict_images(pool[idx[k:k + BATCH]],
                                                  tid)):
                refs[j] = res
    torch.cuda.synchronize()
    before = dict(svc.stats, by_size=dict(svc.stats["by_size"]))
    for c, _ in per_dispatch:
        c.launches = 0
    n_done, wall, lat, results = serve_closed_loop(svc, pool, tids)
    launches = {c.__name__: c.launches for c, _ in per_dispatch}
    dispatches = svc.stats["dispatches"] - before["dispatches"]
    used = [k for k, v in svc.stats["by_size"].items()
            if v > before["by_size"].get(k, 0)]
    svc.close()
    sizes = check_served(results, pred, pool, tids, refs, used)
    want = {c.__name__: n * dispatches for c, n in per_dispatch}
    if launches != want or dispatches == 0:
        fail(f"{what} serving launches {launches} != {want} ({dispatches} "
             "dispatches)")
    ms = [v for _, v in lat]
    return dict(requests=n_done, wall_s=wall, img_s=n_done / wall,
                p50_ms=float(np.percentile(ms, 50)),
                p99_ms=float(np.percentile(ms, 99)), dispatches=dispatches,
                launches=launches, **sizes)


# ---------------------------------------------------------------------------
# phase 7: DINOv3 serving (and phase 10a-b, the SPM preset's)
# ---------------------------------------------------------------------------
def dino_serving_preset():
    """Phase 7: the DINOv3 ViT-B/8 512² preset, N = 4,101 tokens: K4f
    12 launches a forward; card vs CPU on one 256² crop (N = 1029, the K4
    path still)."""
    from fmc_uia_tpu_torch.flagship import dino_patch8_config_dict
    from fmc_uia_tpu_torch.ops import vit_attention as va

    return dict(key="dino_serving", tag="[dino]",
                config=dino_patch8_config_dict,
                what=f"DINOv3 ViT-B/8 {IMAGE}² (N = {K4_N})", image=IMAGE,
                per_forward=((va.global_attention, 12),
                             (va.global_attention_backward, 0)),
                cpu_image=GRAD_IMAGE, seed=3)


def vit_serving_phase(name, smi, report, preset, out_dir):
    """A ViT preset (random weights from a seed) in bf16 through
    ``Predictor`` at B=8: each kernel of ``per_forward`` ((kernel,
    launches a forward), ...) must launch that many times a forward; held
    against f32 on the card at B=8 and f32 on the CPU for one image
    cropped to ``cpu_image``; then one closed loop of 64 outstanding
    requests through ``StreamingPredictor`` for >= 8 s, every result held
    against ``Predictor``, the same launches a dispatch. Returns the
    serving run's launches by kernel."""
    import numpy as np
    import torch

    from fmc_uia_tpu_torch.config import Config
    from fmc_uia_tpu_torch.export import Predictor
    from fmc_uia_tpu_torch.flagship import SERVING_TASKS
    from fmc_uia_tpu_torch.models import build_model
    from fmc_uia_tpu_torch.ops.image import normalize_images
    from fmc_uia_tpu_torch.tasks import TaskRegistry

    key, tag, S = preset["key"], preset["tag"], preset["image"]
    per_forward = preset["per_forward"]
    cfg = Config(config_dict=preset["config"]())
    registry = TaskRegistry.from_config(cfg)
    mean = cfg.get("data.augmentation.normalize.mean")
    std = cfg.get("data.augmentation.normalize.std")
    model = build_model(cfg, registry, dtype=torch.bfloat16, device="cuda",
                        generator=torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    pred = Predictor(model, registry, mean, std, S, device="cuda")
    rng = np.random.RandomState(preset["seed"])
    imgs = rng.randint(0, 256, (BATCH, S, S, 3)).astype(np.uint8)
    for tid in SERVING_TASKS:  # first use: allocator, cuDNN heuristics
        pred.predict_images(imgs, tid)
    torch.cuda.synchronize()
    for c, _ in per_forward:
        c.launches = 0
    outs = {}
    t0 = time.perf_counter()
    for tid in SERVING_TASKS:
        outs[tid] = pred.predict_images(imgs, tid)
    fwd_s = (time.perf_counter() - t0) / len(SERVING_TASKS)
    n = len(SERVING_TASKS)
    got = {c.__name__: c.launches for c, _ in per_forward}
    want = {c.__name__: k * n for c, k in per_forward}
    if got != want:
        fail(f"{key}: launches {got} != {want} over {n} forwards")
    rep = {"params_M": n_params / 1e6, "fwd_ms_b8": 1e3 * fwd_s,
           "launches_per_forward": {k: v / n for k, v in got.items()}}
    log(f"{tag} {preset['what']}, {n_params / 1e6:.1f} M params: {n} "
        f"Predictor forwards at B={BATCH}, launches {got}; "
        f"{1e3 * fwd_s:.1f} ms per forward (host clock, synced)")
    model32 = build_model(cfg, registry, dtype=torch.float32, device="cuda")
    model32.load_state_dict(model.state_dict())
    model_cpu = build_model(cfg, registry, dtype=torch.float32,
                            device="cpu")
    model_cpu.load_state_dict(model.state_dict())
    x_pre = normalize_images(torch.from_numpy(imgs), mean, std)
    c = preset["cpu_image"]
    small = x_pre[:1, :c, :c].contiguous()
    cmp = {}
    for tid in SERVING_TASKS:
        spec = registry[tid]
        # tolerances as phase 3: bf16 vs f32 10 % of the largest output,
        # decoded ids equal except at near ties; f32 card vs CPU 1e-3
        ref, err = compare_models(model, model32, x_pre, spec, 0.1,
                                  f"{key} bf16 vs f32")
        _, err1 = compare_models(model32, model_cpu, small, spec, 1e-3,
                                 f"{key} f32 card vs f32 cpu, {c}²")
        p = torch.from_numpy(outs[tid])
        top = (max(float(v.abs().max()) for v in ref.values())
               if isinstance(ref, dict) else float(ref.abs().max()))
        entry = {"bf16_vs_f32_err": err, "ref_max": top,
                 f"f32_card_vs_cpu_err_{c}": err1}
        if spec.task_name in ("segmentation", "classification"):
            entry["disagree"], entry["near_ties"] = near_tie_ok(
                p, ref, err, spec.num_classes)
        elif spec.task_name == "Regression":
            entry["decoded_err"] = float((p - ref).abs().max())
        cmp[tid] = entry
        log(f"  {tid:20s} {entry}")
    rep["compare"] = cmp
    del model32, model_cpu
    torch.cuda.empty_cache()
    if preset.get("profile"):
        profile_forward(pred, imgs, SERVING_TASKS[0], out_dir, report,
                        f"{key}_profile")

    sv = serve_once(pred, rng, per_forward, key)
    rep.update(sv)
    report[key] = rep
    log(f"{tag} serving: {rep['requests']} requests in {rep['wall_s']:.2f}"
        f" s: {rep['img_s']:.2f} img/s, e2e p50 {rep['p50_ms']:.1f} ms, p99 "
        f"{rep['p99_ms']:.1f} ms, {rep['dispatches']} dispatches, launches "
        f"{sv['launches']}; results equal to Predictor's at a padded size "
        f"the run used ({sv['differ_from_batch_8']} answered otherwise at "
        f"B={BATCH}) | {name} | {smi}")
    del pred, model
    torch.cuda.empty_cache()
    return sv["launches"]


# ---------------------------------------------------------------------------
# phase 9: the submission preset, fit -> predict
# ---------------------------------------------------------------------------
SUBMIT_IMAGE = 224       # configs/submit.yaml data.image_size
SUBMIT_BATCH = 64        # configs/submit.yaml data.batch_size
ROUTE_MARGIN = 1e-4      # card vs CPU top-2 choices may differ only here
# bf16 vs f32 top-2 choices may differ only where the f32 k-th and (k+1)-th
# gates are this close: bf16 moved a gate by at most 0.0055 at these
# weights (NVIDIA H100 80GB HBM3), so a flip needs a gap of at most twice
# that. At most BF16_FLIP_SHARE of phase 9a's images may flip.
BF16_ROUTE_MARGIN = 0.011
BF16_FLIP_SHARE = 1 / 8
# 80 frames a task leave 64 in the train split (val_split 0.2): every train
# batch of 64 is whole (the sampler's wraparound shortens a batch when a
# task has fewer train rows than a batch)
SUBMIT_PER_TASK = 80
# above 224 on both axes, so the host still resizes each frame for the
# 224² presets; a quarter of FIT_FRAME's pixels to decode
SUBMIT_FRAME = (288, 384)
SUBMIT_STEPS = 6         # steps per epoch of the fit
SUBMIT_BAD_FRAME = "T1_fetal_planes_0005.png"  # made unreadable


def submit_preset():
    """Phase 9c: the submit preset's Trainer at B=64, 224², its launch
    counts a step as the flagship's (swin_b: 24 attention, 4 MLP blocks at
    C <= 256), f32 grads at B=1, 224²."""
    from fmc_uia_tpu_torch.flagship import submit_config_dict
    from fmc_uia_tpu_torch.ops import swin_block as sb

    per_step = ((sb.attention_branch, 24), (sb.attention_branch_backward, 24),
                (sb.mlp_branch, 4), (sb.mlp_branch_backward, 4))
    # the grad check's weights: at seed 1 the CPU reference's own seg grads
    # moved by 7.8e-3 of the stage-3 expert_mid leaf's max under a 1e-7
    # relative perturbation of the weights (a ReLU or routing edge within
    # f32 rounding; the card's host CPU); at seed 3 every type's moved by
    # < 6e-5 of a leaf's max (measured on another x86 CPU)
    return dict(key="submit_train", what="submit swin_b + MoE",
                config=submit_config_dict, per_step=per_step,
                batch=SUBMIT_BATCH, image=SUBMIT_IMAGE,
                grad_image=SUBMIT_IMAGE, grad_seed=3)


def moe_gate_probs(model, x, task_index):
    """{stage: the router's softmax [B, E]} of each MoE block on x."""
    import torch

    with torch.inference_mode():
        feats = model.encoder(x.to(model.dtype))
        return {i: getattr(model, f"moe_stage{i}").gate_probs(
            feats[i], torch.tensor(task_index, device=x.device)).float().cpu()
            for i in model.moe_stages}


def route_flips(lo, hi, top_k, what, margin):
    """Per image, whether any MoE block's top-k choice differs between two
    evaluations of its gates (``lo``, ``hi``: {stage: [B, E]}). A choice
    may differ only where ``hi``'s k-th and (k+1)-th probabilities are
    within ``margin``; elsewhere a difference fails. Returns the bool mask
    and the largest |lo - hi| of a gate."""
    import torch

    from fmc_uia_tpu_torch.models.conditioning import top_k_dispatch

    flips = torch.zeros(next(iter(hi.values())).shape[0], dtype=torch.bool)
    move = 0.0
    for i in hi:
        diff = (top_k_dispatch(lo[i], top_k)
                != top_k_dispatch(hi[i], top_k)).any(1)
        srt = torch.sort(hi[i], dim=1, descending=True).values
        gap = srt[:, top_k - 1] - srt[:, top_k]
        move = max(move, float((lo[i] - hi[i]).abs().max()))
        if bool((diff & (gap > margin)).any()):
            fail(f"{what} stage {i}: top-{top_k} choices differ away from a "
                 f"near tie (gaps {gap[diff].tolist()} > {margin:.2e})")
        flips |= diff
    return flips, move


def submit_model_phase(name, smi, report):
    """Phase 9a-b: the submit preset (random weights from a seed) through
    ``Predictor`` at B=8 in bf16 against f32 on the card, one image in f32
    on the CPU, the MoE blocks' top-2 choices card vs CPU, K1f/K2f 24/4
    launches a forward; then one closed loop of 64 outstanding requests
    through ``StreamingPredictor(max_batch=8)`` for >= 8 s."""
    import numpy as np
    import torch

    from fmc_uia_tpu_torch.config import Config
    from fmc_uia_tpu_torch.export import Predictor
    from fmc_uia_tpu_torch.flagship import SERVING_TASKS, submit_config_dict
    from fmc_uia_tpu_torch.models import build_model
    from fmc_uia_tpu_torch.ops import swin_block as sb
    from fmc_uia_tpu_torch.ops.image import normalize_images
    from fmc_uia_tpu_torch.tasks import TaskRegistry

    S = SUBMIT_IMAGE
    cfg = Config(config_dict=submit_config_dict())
    registry = TaskRegistry.from_config(cfg)
    mean = cfg.get("data.augmentation.normalize.mean")
    std = cfg.get("data.augmentation.normalize.std")
    top_k = int(cfg.get("model.moe.top_k"))
    model = build_model(cfg, registry, dtype=torch.bfloat16, device="cuda",
                        generator=torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    n_moe = sum(p.numel() for n, p in model.named_parameters()
                if n.startswith("moe_stage"))
    pred = Predictor(model, registry, mean, std, S, device="cuda")
    rng = np.random.RandomState(9)
    imgs = rng.randint(0, 256, (BATCH, S, S, 3)).astype(np.uint8)
    for tid in SERVING_TASKS:  # first use: allocator, cuDNN heuristics
        pred.predict_images(imgs, tid)
    torch.cuda.synchronize()
    sb.attention_branch.launches = 0
    sb.mlp_branch.launches = 0
    outs = {}
    t0 = time.perf_counter()
    for tid in SERVING_TASKS:
        outs[tid] = pred.predict_images(imgs, tid)
    fwd_s = (time.perf_counter() - t0) / len(SERVING_TASKS)
    n = len(SERVING_TASKS)
    got = (sb.attention_branch.launches, sb.mlp_branch.launches)
    if got != (24 * n, 4 * n):
        fail(f"submit launch counters {got} != {(24 * n, 4 * n)}")
    rep = {"params_M": n_params / 1e6, "moe_params_M": n_moe / 1e6,
           "fwd_ms_b8": 1e3 * fwd_s, "launches": got,
           "moe_stages": model.moe_stages}
    log(f"[submit] submit preset: swin_b {S}² window 7 + MoE (8 experts, "
        f"top-{top_k}) at stages {model.moe_stages}, 27 tasks, "
        f"{n_params / 1e6:.1f} M params ({n_moe / 1e6:.1f} M in the MoE); "
        f"{n} Predictor forwards at B={BATCH}: launches attention_branch "
        f"{got[0]}, mlp_branch {got[1]} (N = 49 tokens a window); "
        f"{1e3 * fwd_s:.1f} ms per forward (host clock, synced)")
    model32 = build_model(cfg, registry, dtype=torch.float32, device="cuda")
    model32.load_state_dict(model.state_dict())
    model_cpu = build_model(cfg, registry, dtype=torch.float32,
                            device="cpu")
    model_cpu.load_state_dict(model.state_dict())
    x_pre = normalize_images(torch.from_numpy(imgs), mean, std)
    cmp, near, flips, move = {}, 0, 0, 0.0
    for tid in SERVING_TASKS:
        spec = registry[tid]
        # an image whose MoE top-2 choice differs in bf16 and f32 (at a
        # near tie) runs other experts: it is left out of the bf16-vs-f32
        # comparison
        flip, mv = route_flips(
            moe_gate_probs(model, x_pre.cuda(), spec.global_index),
            moe_gate_probs(model32, x_pre.cuda(), spec.global_index),
            top_k, f"submit {tid} bf16 vs f32", BF16_ROUTE_MARGIN)
        keep = ~flip
        flips += int(flip.sum())
        move = max(move, mv)
        # phase 3's rules: bf16 vs f32 10 % of the largest output, decoded
        # ids equal except at near ties; f32 card vs CPU 1e-3, one image
        ref, err = compare_models(model, model32, x_pre[keep], spec, 0.1,
                                  "submit bf16 vs f32")
        _, err1 = compare_models(model32, model_cpu, x_pre[:1], spec, 1e-3,
                                 "submit f32 card vs f32 cpu")
        p = torch.from_numpy(outs[tid])[keep]
        entry = {"bf16_vs_f32_err": err, "f32_card_vs_cpu_err": err1,
                 "route_flips_bf16_f32": int((~keep).sum())}
        if spec.task_name in ("segmentation", "classification"):
            entry["disagree"], entry["near_ties"] = near_tie_ok(
                p, ref, err, spec.num_classes)
        elif spec.task_name == "Regression":
            entry["decoded_err"] = float((p - ref).abs().max())
        # the MoE blocks' choices, all 8 images: f32 card vs f32 CPU
        near += int(route_flips(
            moe_gate_probs(model32, x_pre.cuda(), spec.global_index),
            moe_gate_probs(model_cpu, x_pre, spec.global_index), top_k,
            f"submit {tid} card vs CPU", ROUTE_MARGIN)[0].sum())
        cmp[tid] = entry
        log(f"  {tid:20s} {entry}")
    if flips > BF16_FLIP_SHARE * n * BATCH:
        fail(f"submit bf16 vs f32: {flips} of {n * BATCH} images chose "
             f"other experts (at most {BF16_FLIP_SHARE:.3f} of them may)")
    rep.update(compare=cmp, card_cpu_route_flips=near,
               bf16_route_flips=flips, bf16_gate_move=move)
    log(f"[submit] MoE top-{top_k} choices of {n * BATCH} images x "
        f"{len(model.moe_stages)} blocks, f32 card vs f32 CPU: {near} images"
        f" differ (each within {ROUTE_MARGIN} of a tie). bf16 vs f32: "
        f"gates moved by <= {move:.2e}; {flips} images chose other experts,"
        f" each within {BF16_ROUTE_MARGIN} of a tie, and were left out of "
        f"the comparison (at most {BF16_FLIP_SHARE:.3f} of them may)")
    del model32, model_cpu
    torch.cuda.empty_cache()

    rep["serving"] = serve_once(
        pred, rng, ((sb.attention_branch, 24), (sb.mlp_branch, 4)),
        "submit")
    report["submit"] = rep
    sv = rep["serving"]
    log(f"[submit] serving: {sv['requests']} requests in {sv['wall_s']:.2f}"
        f" s: {sv['img_s']:.2f} img/s, e2e p50 {sv['p50_ms']:.1f} ms, p99 "
        f"{sv['p99_ms']:.1f} ms, {sv['dispatches']} dispatches, launches "
        f"{sv['launches']}; results equal to Predictor's | {name} | {smi}")
    del pred, model
    torch.cuda.empty_cache()


def read_resized(paths, size):
    """``export._load_frame`` of each path on 8 threads: [(original (h, w),
    resized uint8 [size, size, 3]) or None for an unreadable frame]."""
    from concurrent.futures import ThreadPoolExecutor

    from fmc_uia_tpu_torch.export import _load_frame

    with ThreadPoolExecutor(8) as ex:
        return list(ex.map(lambda p: _load_frame(p, size), paths))


def check_predictions(out_dir, root, model, registry, mean, std, size,
                      n_tasks=27, device="cuda"):
    """``predict``'s files against an in-process ``Predictor`` on the same
    frames, batches of 16 in index order as the CLI makes them: 27 JSONs,
    one record per readable frame, every mask PNG at its frame's size and
    equal to the Predictor's mask resized back (bitwise), class ids equal,
    boxes and points within 1e-4 of the frame's size."""
    import csv
    import glob

    import numpy as np

    from fmc_uia_tpu_torch.data.image_io import read_mask, resize_nearest
    from fmc_uia_tpu_torch.export import Predictor

    pred = Predictor(model, registry, mean, std, size, device=device)
    rows = {}
    for path in sorted(glob.glob(os.path.join(root, "csv_files", "*.csv"))):
        with open(path, newline="") as f:
            for r in csv.DictReader(f):
                rows.setdefault(r["task_id"], []).append(r["image_path"])
    jsons = sorted(f for f in os.listdir(out_dir) if f.endswith(".json"))
    if jsons != sorted(f"{t}.json" for t in rows) or len(jsons) != n_tasks:
        fail(f"predict wrote {len(jsons)} JSON files, not the {n_tasks} "
             "tasks'")
    n_rec = n_masks = 0
    worst = 0.0
    for tid, paths in sorted(rows.items()):
        spec = registry[tid]
        frames = read_resized([os.path.normpath(os.path.join(
            root, "csv_files", p)) for p in paths], size)
        with open(os.path.join(out_dir, f"{tid}.json")) as f:
            recs = json.load(f)
        names = [os.path.basename(p) for p, fr in zip(paths, frames)
                 if fr is not None]
        if [r["image"] for r in recs] != names:
            fail(f"predict {tid}: {len(recs)} records, not one per readable "
                 f"frame ({len(names)})")
        done = 0
        for s in range(0, len(paths), 16):  # the CLI's chunks of 16 rows
            chunk = [(os.path.basename(p), fr) for p, fr in zip(
                paths[s:s + 16], frames[s:s + 16]) if fr is not None]
            out = pred.predict_images(np.stack([fr[1] for _, fr in chunk]),
                                      tid)
            batch_recs = recs[done:done + len(chunk)]
            done += len(chunk)
            for (img_name, ((h, w), _)), r, o in zip(chunk, batch_recs,
                                                     out):
                if spec.task_name == "segmentation":
                    mask = read_mask(os.path.join(out_dir, "masks",
                                                  r["mask"]))
                    want = resize_nearest(o.astype(np.uint8), h, w)
                    if mask is None or mask.shape != (h, w) or not (
                            np.array_equal(mask, want)):
                        fail(f"predict {tid} {r['mask']}: not the "
                             f"Predictor's mask at {h}x{w}")
                    n_masks += 1
                elif spec.task_name == "classification":
                    if r["class"] != int(o):
                        fail(f"predict {tid} {img_name}: class {r['class']}"
                             f" != {int(o)}")
                else:
                    if spec.task_name == "detection":
                        got = [r["x_min"], r["y_min"], r["x_max"],
                               r["y_max"]]
                        ref = o[:4]
                    else:
                        got = [v for pt in r["points"] for v in pt]
                        ref = o[:2 * spec.num_classes]
                    for k, (g, v) in enumerate(zip(got, ref)):
                        dim = w if k % 2 == 0 else h
                        e = abs(g - float(v) * dim) / dim
                        worst = max(worst, e)
                        if not e <= 1e-4:
                            fail(f"predict {tid} {img_name}: value {k} "
                                 f"{g} vs {float(v) * dim} (> 1e-4 x "
                                 f"{dim})")
            n_rec += len(chunk)
    return {"jsons": len(jsons), "records": n_rec, "masks": n_masks,
            "worst_box_point_err_over_size": worst}


def submit_fit_preset():
    """Phase 9d: the submit preset's fit, K1f/K2f per step and eval
    batch, K1b/K2b per step, K3 per step, ``moe_stats.csv``."""
    from fmc_uia_tpu_torch.flagship import submit_config_dict
    from fmc_uia_tpu_torch.ops import preprocess as pp
    from fmc_uia_tpu_torch.ops import swin_block as sb

    def want(steps, evals):
        return {sb.attention_branch: 24 * (steps + evals),
                sb.attention_branch_backward: 24 * steps,
                sb.mlp_branch: 4 * (steps + evals),
                sb.mlp_branch_backward: 4 * steps,
                pp.augment_normalize: steps}

    # two epochs: moe_stats.csv must hold each epoch's rows
    return dict(key="submit_fit", tag="[submit-fit]",
                config=submit_config_dict, want=want, moe=True, after=None,
                epochs=2)


def write_fit_dataset(tmp, tasks):
    """The from-disk data of phases 9d and 10d under ``tmp``/data: 288x384
    PNGs, 80 frames a task (the port's generator, 8 threads), one made
    unreadable. Returns (root, seconds)."""
    from concurrent.futures import ThreadPoolExecutor

    from fmc_uia_tpu_torch.data.synthetic import generate_synthetic_dataset

    root = os.path.join(tmp, "data")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as ex:
        list(ex.map(lambda it: generate_synthetic_dataset(
            root, tasks=[it[1]], samples_per_task=SUBMIT_PER_TASK,
            image_hw=SUBMIT_FRAME, seed=100 + it[0]), enumerate(tasks)))
    with open(os.path.join(root, "images", SUBMIT_BAD_FRAME), "wb") as f:
        f.write(b"not a png")
    gen_s = time.perf_counter() - t0
    log(f"[fit-data] wrote {len(tasks)} tasks x {SUBMIT_PER_TASK} frames "
        f"{SUBMIT_FRAME[0]}x{SUBMIT_FRAME[1]} ({SUBMIT_BAD_FRAME} unreadable) in "
        f"{gen_s:.1f} s")
    return root, gen_s


PREDICT_PER_TASK = 8  # frames a task ``predict`` runs on (index 5 among them)


def predict_root(root, dest):
    """A data root under ``dest``: the first PREDICT_PER_TASK rows of each
    task CSV of ``root``, its ``images`` a link to ``root``'s. ``predict``
    and its check run on it (a cut of the frames, the unreadable one of
    ``write_fit_dataset`` kept)."""
    sub = os.path.join(dest, "predict_data")
    os.makedirs(os.path.join(sub, "csv_files"))
    os.symlink(os.path.abspath(os.path.join(root, "images")),
               os.path.join(sub, "images"))
    for name in sorted(os.listdir(os.path.join(root, "csv_files"))):
        with open(os.path.join(root, "csv_files", name)) as f:
            lines = f.read().splitlines()
        with open(os.path.join(sub, "csv_files", name), "w") as f:
            f.write("\n".join(lines[:1 + PREDICT_PER_TASK]) + "\n")
    return sub


def fit_predict_phase(name, smi, report, preset, root):
    """``fit`` of a 224² B=64 preset from ``root`` (``write_fit_dataset``:
    288x384 PNGs, 27 tasks x 80, one unreadable) for ``preset['epochs']``
    epochs of 6 steps with K3, the launch counts of
    ``preset['want'](steps, eval batches)``, then ``python -m
    fmc_uia_tpu_torch.predict`` in a subprocess on the experiment dir over
    ``predict_root`` of the same root, its files held against an
    in-process ``Predictor`` on
    the loaded ``best_model.pt``; ``preset['after']``, if any, runs on the
    experiment dir before the temp dir goes."""
    import copy
    import shutil
    import tempfile

    import numpy as np
    import torch

    from fmc_uia_tpu_torch import checkpoint as ckpt_lib
    from fmc_uia_tpu_torch.config import Config
    from fmc_uia_tpu_torch.fit import fit
    from fmc_uia_tpu_torch.models import build_model
    from fmc_uia_tpu_torch.ops import preprocess as pp
    from fmc_uia_tpu_torch.tasks import TaskRegistry

    key, tag = preset["key"], preset["tag"]
    counters = list(preset["want"](0, 0))
    tmp = tempfile.mkdtemp(prefix=f"chip_smoke_{key}_")
    try:
        d = preset["config"]()
        d["data"].update(root_path=root, fused_preprocess=True)
        d["experiment"].update(output_dir=os.path.join(tmp, "out"))
        d["training"].update(num_epochs=preset["epochs"],
                             steps_per_epoch=SUBMIT_STEPS)
        torch.cuda.synchronize()
        for c in counters:
            c.launches = 0
        by_kernel = pp.augment_normalize.launches_by_kernel
        by_kernel.update(vector=0, edge=0)
        t0 = time.perf_counter()
        r = fit(config=Config(config_dict=copy.deepcopy(d)), device="cuda")
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = {c.__name__: c.launches for c in counters}
        k3_kernels = dict(by_kernel)
        exp = r["experiment_dir"]
        torch.cuda.empty_cache()

        steps = sum(e["steps"] for e in r["epoch_stats"])
        evals = r["eval_batches"]
        want = {c.__name__: n for c, n in preset["want"](steps,
                                                          evals).items()}
        if launches != want:
            fail(f"{key} launches {launches} != {want}")
        if k3_kernels != {"vector": steps, "edge": 0}:
            fail(f"{key}: K3 kernels {k3_kernels}, not {steps} of the "
                 "chunk kernel")
        if any(e["images"] != SUBMIT_BATCH * e["batches"]
               for e in r["epoch_stats"]):
            fail(f"{key}: train batches of fewer than {SUBMIT_BATCH} "
                 f"images: {r['epoch_stats']}")
        with open(os.path.join(exp, "training_history.json")) as f:
            hist = json.load(f)
        if not all(np.isfinite(v["mean"]) for e in hist
                   for v in e["train_losses"].values()):
            fail(f"{key}: non-finite train losses")
        moe_rows = None
        if preset["moe"]:
            with open(os.path.join(exp, "moe_stats.csv")) as f:
                moe_rows = f.read().splitlines()
            epochs = sorted({ln.split(",")[0] for ln in moe_rows[1:]})
            if (moe_rows[0] != "epoch,scope,key,task_name,expert,"
                               "importance,load" or epochs != ["1", "2"]):
                fail(f"moe_stats.csv: header {moe_rows[0]!r}, epochs "
                     f"{epochs}")

        out = os.path.join(tmp, "preds")
        sub = predict_root(root, tmp)
        env = dict(os.environ, PYTHONPATH=HERE)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "fmc_uia_tpu_torch.predict",
             "--checkpoint", exp, "--data", sub, "--out", out],
            cwd=HERE, env=env, capture_output=True, text=True, timeout=600)
        predict_s = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"predict exited {proc.returncode}: {proc.stderr[-3000:]}")

        with open(os.path.join(exp, "config.yaml")) as f:
            cfg = Config(config_dict=json.load(f))
        registry = TaskRegistry.from_config(cfg)
        model = build_model(cfg, registry, device="cuda", init=False)
        model.load_state_dict(ckpt_lib.load_best_params(exp, "cuda"))
        mean = cfg.get("data.augmentation.normalize.mean")
        std = cfg.get("data.augmentation.normalize.std")
        t0 = time.perf_counter()
        chk = check_predictions(out, sub, model, registry, mean, std,
                                SUBMIT_IMAGE)
        check_s = time.perf_counter() - t0
        after = (preset["after"](name, smi, report, exp, root, model,
                                 registry, mean, std)
                 if preset["after"] else None)
        del model
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    per_epoch = [{"epoch": e["epoch"], "steps": e["steps"],
                  "loop_s": e["loop_s"], "img_s": e["images"] / e["loop_s"],
                  "queue_wait_share": e["queue_wait_s"] / e["loop_s"]}
                 for e in r["epoch_stats"]]
    rep = dict(frames=SUBMIT_FRAME, per_task=SUBMIT_PER_TASK, fit_s=fit_s, epochs=per_epoch, train_steps=steps,
               eval_batches=evals, launches=launches, k3_kernels=k3_kernels,
               predict_s=predict_s, check_s=check_s, predictions=chk,
               best_score=r["best_score"], best_epoch=r["best_epoch"])
    if moe_rows is not None:
        rep["moe_stats_rows"] = len(moe_rows) - 1
    if after is not None:
        rep["http"] = after
    report[key] = rep
    for e in per_epoch:
        log(f"{tag} epoch {e['epoch']}: {e['steps']} steps of "
            f"B={SUBMIT_BATCH} at {SUBMIT_IMAGE}² in {e['loop_s']:.2f} s = "
            f"{e['img_s']:.2f} img/s from disk; queue wait "
            f"{100 * e['queue_wait_share']:.2f} % of the loop")
    log(f"{tag} fit {fit_s:.1f} s ({steps} train steps, {evals} eval "
        f"batches; launches {launches}; K3 by kernel {k3_kernels})"
        + (f"; moe_stats.csv {len(moe_rows) - 1} rows over epochs 1-2"
           if moe_rows is not None else ""))
    log(f"{tag} predict (subprocess, B=16): {predict_s:.1f} s for "
        f"{chk['records']} frames -> {chk['jsons']} JSONs, {chk['masks']} "
        f"masks at {SUBMIT_FRAME[0]}x{SUBMIT_FRAME[1]}; every value equal to the "
        f"in-process Predictor's (masks bitwise; boxes/points worst "
        f"{chk['worst_box_point_err_over_size']:.1e} of the frame size) "
        f"| {name} | {smi}")


# ---------------------------------------------------------------------------
# phase 10: the DINOv3 ViT-L/16 SPM-interaction preset
# ---------------------------------------------------------------------------
HTTP_CONCURRENT = 32     # concurrent requests to the HTTP front
SERVE_START_S = 600      # the HTTP front must print its address by then


def all_kernels():
    """Every hand-written kernel's wrapper (K4f, K4b, K1f, K1b, K2f, K2b,
    K3): none but K3 runs on the SPM preset's path."""
    from fmc_uia_tpu_torch.ops import preprocess as pp
    from fmc_uia_tpu_torch.ops import swin_block as sb
    from fmc_uia_tpu_torch.ops import vit_attention as va

    return (va.global_attention, va.global_attention_backward,
            sb.attention_branch, sb.attention_branch_backward,
            sb.mlp_branch, sb.mlp_branch_backward, pp.augment_normalize)


def spm_serving_preset():
    """Phase 10a-b: ViT-L/16 at 224², 201 tokens, below FLASH_MIN_TOKENS:
    no kernel launches a forward; card vs CPU on the whole 224² image."""
    from fmc_uia_tpu_torch.flagship import dinov3_spm_config_dict

    return dict(key="spm", tag="[spm]", config=dinov3_spm_config_dict,
                what=f"DINOv3 ViT-L/16 {SUBMIT_IMAGE}² SPM-interaction "
                     "(N = 201)", image=SUBMIT_IMAGE,
                per_forward=tuple((c, 0) for c in all_kernels()),
                cpu_image=SUBMIT_IMAGE, seed=10, profile=True)


def spm_preset():
    """Phase 10c: the SPM preset's Trainer at B=64, 224² (``freeze_dino``:
    the backbone's grads are computed and clipped, not applied); no kernel
    launches a step; f32 grads at B=1, 224²."""
    from fmc_uia_tpu_torch.flagship import dinov3_spm_config_dict

    return dict(key="spm_train", what="DINOv3 ViT-L/16 SPM",
                config=dinov3_spm_config_dict,
                per_step=tuple((c, 0) for c in all_kernels()),
                batch=SUBMIT_BATCH, image=SUBMIT_IMAGE,
                grad_image=SUBMIT_IMAGE, grad_types=("segmentation",))


def spm_fit_preset():
    """Phase 10d-e: the SPM preset's fit with K3 (once a train step, the
    only kernel launched), then the HTTP front on its experiment dir."""
    from fmc_uia_tpu_torch.flagship import dinov3_spm_config_dict
    from fmc_uia_tpu_torch.ops import preprocess as pp

    def want(steps, evals):
        return {c: steps if c is pp.augment_normalize else 0
                for c in all_kernels()}

    return dict(key="spm_fit", tag="[spm-fit]", config=dinov3_spm_config_dict,
                want=want, moe=False, after=http_front_check, epochs=1)


class KinkAlign:
    """While active, records the kinks of ``model``'s step: each
    ``F.relu``'s input, in call order (its derivative jumps at 0), and
    each deformable cross-attention's f32 sampling coordinates [B, H, W,
    nH, nP, (x, y)], with its key map's size (a bilinear weight's
    derivative jumps where a position crosses an integer pixel). Given
    ``at``, the record of the same step on the card, the CPU takes the
    card's side at each kink the two runs put on different sides and
    keeps its own values everywhere else: a ReLU input of the other sign
    takes the card's mask, a sample in another bilinear cell the card's
    coordinates (its gradient still flows through the CPU's own offsets).

    The two devices sum in other orders (cuDNN or PyTorch's CUDA
    convolutions against oneDNN), so a value that sits within that
    rounding of a kink may land on the other side on each device, and a
    grad through it then differs by the jump, not by rounding. In the
    DINOv3 SPM preset at 224² (an H100 against the CPU, weights from seed
    1), 10 of the detection step's 2,370,816 ReLU inputs (in the det FPN
    and the CenterNet head) took the other side and moved a det FPN
    GroupNorm leaf by 2.1e-3 of its max, and 2 of the segmentation step's
    266,560 samples sat in another cell and moved interaction0's
    ``offset_proj`` by 2.3e-3. ``compare`` counts the kinks the two runs
    split and the largest gap between the two sides' values, which only
    rounding may explain; ``take`` names the kinds the CPU takes from the
    card (``--kinks`` drops each in turn)."""

    def __init__(self, model, at=None, take=("relu", "coords")):
        self.model, self.at, self.take = model, at, take
        self.relu_in, self.relu_sites = [], []
        self.coords, self.kv_hw, self.mods, self.hooks = {}, {}, [], []
        self.split = {"relu": [], "coords": []}

    def __enter__(self):
        import torch.nn.functional as F

        from fmc_uia_tpu_torch.models.encoders.adapters import (
            DeformableCrossAttention2D,
        )

        self._relu = F.relu
        F.relu = self._relu_at
        for name, m in self.model.named_modules():
            if isinstance(m, DeformableCrossAttention2D):
                m.sample_coords = (lambda q, name=name, own=m.sample_coords:
                                   self._sample(name, own(q)))
                self.mods.append(m)
                self.hooks.append(m.register_forward_pre_hook(
                    lambda mod, args, name=name: self.kv_hw.__setitem__(
                        name, tuple(args[1].shape[1:3]))))
        return self

    def __exit__(self, *exc):
        import torch.nn.functional as F

        F.relu = self._relu
        for m in self.mods:
            del m.sample_coords  # the class's method again
        for h in self.hooks:
            h.remove()

    def _relu_at(self, x, inplace=False):
        import torch

        i = len(self.relu_in)
        self.relu_in.append(x.detach().cpu())
        self.relu_sites.append(_caller_site())
        if self.at is None:
            return self._relu(x, inplace)
        if i >= len(self.at.relu_in) or \
                self.at.relu_in[i].shape != x.shape:
            fail(f"ReLU call {i} at {self.relu_sites[-1]}: the card's step "
                 f"made no such call")
        card = self.at.relu_in[i].to(x.device) > 0
        self.split["relu"].append(int((card != (x.detach() > 0)).sum()))
        if "relu" not in self.take:
            return self._relu(x, inplace)
        return torch.where(card, x, torch.zeros_like(x))

    def _sample(self, name, own):
        import torch

        self.coords[name] = own.detach().cpu()
        if self.at is None:
            return own
        hw = self.kv_hw[name]
        theirs = self.at.coords[name].to(own.device)
        other = (_cells(theirs, hw) != _cells(own.detach(), hw)).any(-1)
        self.split["coords"].append(int(other.sum()))
        if "coords" not in self.take:
            return own
        return torch.where(other[..., None], theirs + (own - own.detach()),
                           own)

    def compare(self):
        """{kind: (largest gap between the card's values and the CPU's over
        the largest magnitude, kinks the two runs split, all, site of the
        largest gap)} for the ReLU inputs and the sample coordinates."""
        if len(self.relu_in) != len(self.at.relu_in):
            fail(f"{len(self.relu_in)} ReLU calls on the CPU, "
                 f"{len(self.at.relu_in)} on the card")
        out = {}
        for kind, mine, theirs, sites in (
                ("relu", self.relu_in, self.at.relu_in, self.relu_sites),
                ("coords", list(self.coords.values()),
                 [self.at.coords[n] for n in self.coords],
                 list(self.coords))):
            gap, where = 0.0, None
            for m, t, s in zip(mine, theirs, sites):
                g = float((m - t).abs().max()) / max(
                    float(m.abs().max()), 1e-30)
                if g >= gap:
                    gap, where = g, s
            out[kind] = (gap, sum(self.split[kind]),
                         sum(m.numel() for m in mine), where)
        return out

    def relu_flips(self):
        """{call site: ReLU inputs of the other sign than the card's}, the
        sites with any."""
        out = {}
        for s, n in zip(self.relu_sites, self.split["relu"]):
            if n:
                out[s] = out.get(s, 0) + n
        return out

    def near_integer(self, tol=1e-6):
        """{module: (positions within ``tol`` of an integer pixel, all)}."""
        out = {}
        for name, c in self.coords.items():
            p = _pixels(c.double(), self.kv_hw[name])
            near = ((p - p.round()).abs() <= tol).any(-1)
            out[name] = (int(near.sum()), near.numel())
        return out


# a deformable sample's pixel position and bilinear cell, in
# grid_sample_bilinear's f32 arithmetic: pixel = ((c + 1) * size - 1) / 2
def _pixels(c, hw):
    import torch

    hk, wk = hw
    return torch.stack([((c[..., 0] + 1.0) * wk - 1.0) / 2.0,
                        ((c[..., 1] + 1.0) * hk - 1.0) / 2.0], -1)


def _cells(c, hw):
    return _pixels(c, hw).floor()


def _caller_site():
    """'file:line' of the model code that called F.relu."""
    import inspect

    f = inspect.currentframe().f_back.f_back
    return f"{os.path.basename(f.f_code.co_filename)}:{f.f_lineno}"


def http_get(url):
    import urllib.request

    with urllib.request.urlopen(url, timeout=120) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def http_post(url, body):
    import urllib.request

    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def http_front_check(name, smi, report, exp, root, model, registry, mean,
                     std):
    """Phase 10e: ``python -m fmc_uia_tpu_torch.serve --checkpoint <exp>``
    in a subprocess on a free port (``--port 0``; it prints the address it
    bound). ``/healthz``, ``/v1/tasks`` and ``/v1/stats``; one PNG frame
    of the dataset (288x384, as on disk) per task type, each answer equal
    to the in-process ``Predictor``'s on the loaded model (the mask
    decoded and equal to its mask resized back, class ids equal, boxes
    and points within 1e-4 of the frame); then 32 concurrent requests,
    all answered, which the stats must count. The server is killed at the
    end, whatever the outcome."""
    import csv
    import glob
    import queue
    import threading
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from fmc_uia_tpu_torch.data.dataset import _resize_image
    from fmc_uia_tpu_torch.data.image_io import (
        decode_png,
        read_image,
        resize_nearest,
    )
    from fmc_uia_tpu_torch.export import Predictor
    from fmc_uia_tpu_torch.flagship import SERVING_TASKS

    frames = {}
    for path in sorted(glob.glob(os.path.join(root, "csv_files", "*.csv"))):
        with open(path, newline="") as f:
            for r in csv.DictReader(f):
                tid, rel = r["task_id"], r["image_path"]
                if (tid in SERVING_TASKS and tid not in frames
                        and os.path.basename(rel) != SUBMIT_BAD_FRAME):
                    frames[tid] = os.path.normpath(
                        os.path.join(root, "csv_files", rel))
    if sorted(frames) != sorted(SERVING_TASKS):
        fail(f"http: no frame for {sorted(set(SERVING_TASKS) - set(frames))}")
    env = dict(os.environ, PYTHONPATH=HERE)
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "fmc_uia_tpu_torch.serve", "--checkpoint",
         exp, "--host", "127.0.0.1", "--port", "0"], cwd=HERE, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines: "queue.Queue" = queue.Queue()

    def pump():
        for line in proc.stdout:
            lines.put(line)
        lines.put(None)

    threading.Thread(target=pump, daemon=True).start()
    try:
        url, said = None, []
        while url is None:
            left = SERVE_START_S - (time.perf_counter() - t0)
            try:
                line = lines.get(timeout=max(left, 0.1))
            except queue.Empty:
                fail(f"serve printed no address within {SERVE_START_S} s: "
                     f"{''.join(said)[-3000:]}")
            if line is None:
                fail(f"serve exited {proc.wait()} before serving: "
                     f"{''.join(said)[-3000:]}")
            said.append(line)
            if line.startswith("serving "):
                url = line.split()[-1]
        start_s = time.perf_counter() - t0
        health = json.loads(http_get(url + "/healthz")[2])
        if (health.get("ok") is not True or health.get("backend") != "cuda"
                or health.get("tasks") != len(registry)
                or health.get("image_size") != SUBMIT_IMAGE):
            fail(f"http /healthz: {health}")
        rows = json.loads(http_get(url + "/v1/tasks")[2])
        if rows != [{"task_id": t, "task_type": registry[t].task_name,
                     "num_classes": int(registry[t].num_classes)}
                    for t in registry.task_ids]:
            fail(f"http /v1/tasks: {rows[:3]} ...")

        pred = Predictor(model, registry, mean, std, SUBMIT_IMAGE,
                         device="cuda")
        worst, answers = 0.0, {}
        for tid in SERVING_TASKS:
            with open(frames[tid], "rb") as f:
                status, ctype, body = http_post(
                    url + f"/v1/predict/{tid}", f.read())
            img = read_image(frames[tid])
            h, w = img.shape[:2]
            ref = pred.predict_images(
                _resize_image(img, SUBMIT_IMAGE)[None], tid)[0]
            kind = registry[tid].task_name
            if status != 200:
                fail(f"http {tid}: status {status}")
            if kind == "segmentation":
                mask = decode_png(body, gray=True)
                if ctype != "image/png" or not np.array_equal(
                        mask, resize_nearest(ref.astype(np.uint8), h, w)):
                    fail(f"http {tid}: not the Predictor's mask at {h}x{w}")
                answers[tid] = f"mask {mask.shape}"
                continue
            got = json.loads(body)
            answers[tid] = got
            if kind == "classification":
                if got != {"class": int(ref)}:
                    fail(f"http {tid}: {got} != class {int(ref)}")
                continue
            if kind == "detection":
                vals = [got["x_min"], got["y_min"], got["x_max"],
                        got["y_max"]]
                want = ref[:4]
            else:
                vals = [v for pt in got["points"] for v in pt]
                want = ref[:2 * registry[tid].num_classes]
            if len(vals) != len(want):
                fail(f"http {tid}: {len(vals)} values, not {len(want)}")
            for k, (g, v) in enumerate(zip(vals, want)):
                dim = w if k % 2 == 0 else h
                e = abs(g - float(v) * dim) / dim
                worst = max(worst, e)
                if not e <= 1e-4:
                    fail(f"http {tid}: value {k} {g} vs {float(v) * dim}")

        before = json.loads(http_get(url + "/v1/stats")[2])
        bodies = []
        for j in range(HTTP_CONCURRENT):
            tid = SERVING_TASKS[j % len(SERVING_TASKS)]
            with open(frames[tid], "rb") as f:
                bodies.append((tid, f.read()))
        t1 = time.perf_counter()
        with ThreadPoolExecutor(HTTP_CONCURRENT) as ex:
            res = list(ex.map(lambda tb: http_post(
                url + f"/v1/predict/{tb[0]}", tb[1]), bodies))
        conc_s = time.perf_counter() - t1
        if any(r[0] != 200 for r in res):
            fail(f"http concurrent: statuses {[r[0] for r in res]}")
        stats = json.loads(http_get(url + "/v1/stats")[2])

        def served(st):
            ok = sum(v for k, v in st["requests"].items()
                     if k.startswith("ok_"))
            imgs = sum(int(k) * v for k, v in st["by_batch_size"].items())
            return ok, imgs - st["pad_images"]

        (ok0, n0), (ok1, n1) = served(before), served(stats)
        if not (ok1 - ok0 == n1 - n0 == HTTP_CONCURRENT):
            fail(f"http stats count {ok1 - ok0} answered and {n1 - n0} "
                 f"images dispatched, not {HTTP_CONCURRENT}")
        disp = stats["dispatches"] - before["dispatches"]
    finally:
        proc.kill()
        proc.wait(timeout=60)
    rep = {"start_s": start_s, "health": health, "answers": answers,
           "worst_box_point_err_over_size": worst,
           "concurrent": HTTP_CONCURRENT, "concurrent_s": conc_s,
           "concurrent_dispatches": disp, "stats": stats}
    log(f"[spm-http] serve started in {start_s:.1f} s (subprocess, warm-up "
        f"included); /healthz {health}; /v1/tasks {len(rows)} rows; one "
        f"frame per type equal to Predictor's (boxes/points worst "
        f"{worst:.1e} of the frame): {answers}; {HTTP_CONCURRENT} "
        f"concurrent requests in {conc_s:.2f} s, {disp} dispatches, counted"
        f" by /v1/stats | {name} | {smi}")
    return rep


def run_phases_9_10(name, smi, report, out_dir, fit_root):
    """Phase 9 (the submission preset) and phase 10 (the DINOv3 ViT-L/16
    SPM preset and the HTTP front), their fits from ``fit_root``. Leaves
    phase 10's launches by kernel in ``report['spm_launches']``."""
    import torch

    torch.cuda.empty_cache()
    t9 = time.perf_counter()
    submit_model_phase(name, smi, report)
    train_phase(name, smi, report, out_dir, submit_preset())
    torch.cuda.empty_cache()
    fit_predict_phase(name, smi, report, submit_fit_preset(), fit_root)
    report["submit_s"] = time.perf_counter() - t9
    log(f"[submit] phase 9: {report['submit_s']:.1f} s")

    torch.cuda.empty_cache()
    t10 = time.perf_counter()
    launches = vit_serving_phase(name, smi, report, spm_serving_preset(),
                                 out_dir)
    trained = train_phase(name, smi, report, out_dir, spm_preset())
    torch.cuda.empty_cache()
    fit_predict_phase(name, smi, report, spm_fit_preset(), fit_root)
    for k, v in list(trained.items()) + list(
            report["spm_fit"]["launches"].items()):
        launches[k] += v
    report["spm_launches"] = launches
    report["spm_s"] = time.perf_counter() - t10
    log(f"[spm] phase 10: {report['spm_s']:.1f} s; launches over its "
        f"serving run, timed training and fit: {launches}")


# ---------------------------------------------------------------------------
# phase 11: the device-resident dataset cache, adaptive normalisation and
# pretrained encoders from a local checkpoint
# ---------------------------------------------------------------------------
CACHE_PARTIAL_MB = 400    # phase 11b's budget: about half the tasks stream
CACHE_FIT_STEPS = 24      # steps per epoch of phase 11a (epoch 2 ~3 s)
CACHE_SHORT_STEPS = 6     # steps of phases 11b and 11c
PRETRAINED_STEPS = 3      # steps of phases 11d and 11e
CACHE_BITWISE_TRAIN = 4   # train batches held bitwise in phase 11a


def flagship_fit_want(steps, evals):
    """The flagship fit's launches by kernel: K1f/K2f per step and eval
    batch, K1b/K2b per step, K3 per step (0 under adaptive normalisation
    is asked by the caller), K4 none."""
    from fmc_uia_tpu_torch.ops import preprocess as pp
    from fmc_uia_tpu_torch.ops import swin_block as sb

    want = {c.__name__: 0 for c in all_kernels()}
    want.update({sb.attention_branch.__name__: 24 * (steps + evals),
                 sb.attention_branch_backward.__name__: 24 * steps,
                 sb.mlp_branch.__name__: 4 * (steps + evals),
                 sb.mlp_branch_backward.__name__: 4 * steps,
                 pp.augment_normalize.__name__: steps})
    return want


def counted_fit(tag, d, totals):
    """``fit`` of config dict ``d`` on the card with every kernel's count
    zeroed just before it and read just after (added to ``totals``); the
    engines ``fit`` builds are kept. Returns (result, seconds, launches,
    (train engine, val engine), K3 by kernel)."""
    import copy

    import torch

    import fmc_uia_tpu_torch.fit as fit_mod
    from fmc_uia_tpu_torch.config import Config
    from fmc_uia_tpu_torch.ops import preprocess as pp

    built = {}
    orig = fit_mod.build_data_engines

    def keep(*a, **k):
        built["engines"] = orig(*a, **k)
        return built["engines"]

    fit_mod.build_data_engines = keep
    try:
        torch.cuda.synchronize()
        for c in all_kernels():
            c.launches = 0
        by_kernel = pp.augment_normalize.launches_by_kernel
        by_kernel.update(vector=0, edge=0)
        t0 = time.perf_counter()
        r = fit_mod.fit(config=Config(config_dict=copy.deepcopy(d)),
                        device="cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {c.__name__: c.launches for c in all_kernels()}
        k3 = dict(by_kernel)
    finally:
        fit_mod.build_data_engines = orig
    for k, v in launches.items():
        totals[k] += v
    torch.cuda.empty_cache()
    with open(os.path.join(r["experiment_dir"],
                           "training_history.json")) as f:
        hist = json.load(f)
    if not all(math.isfinite(v["mean"]) for e in hist
               for v in e["train_losses"].values()):
        fail(f"{tag}: non-finite train losses")
    log(f"{tag} fit {secs:.1f} s; launches {launches}; K3 by kernel {k3}")
    return r, secs, launches, built["engines"][:2], k3


def check_fit_launches(tag, r, launches, k3, adaptive=False):
    steps = sum(e["steps"] for e in r["epoch_stats"])
    want = flagship_fit_want(steps, r["eval_batches"])
    if adaptive:
        want["augment_normalize"] = 0
    if launches != want:
        fail(f"{tag} launches {launches} != {want}")
    if k3 != {"vector": want["augment_normalize"], "edge": 0}:
        fail(f"{tag}: K3 kernels {k3}, not {want['augment_normalize']} of "
             "the chunk kernel")
    return steps


def epoch_rows(r):
    return [{"epoch": e["epoch"], "steps": e["steps"],
             "loop_s": e["loop_s"], "img_s": e["images"] / e["loop_s"],
             "queue_wait_share": e["queue_wait_s"] / e["loop_s"],
             "host_ms_per_batch": 1e3 * e["host_load_s"] / e["batches"],
             "put_ms_per_batch": 1e3 * e["host_put_s"] / e["batches"]}
            for e in r["epoch_stats"]]


def same_on_card(tag, got, host):
    """A cached batch against the host path's batch of the same rows, the
    host's put on the card as ``Trainer.put_batch`` puts it: bitwise."""
    import numpy as np
    import torch

    img = torch.from_numpy(host["image"]).cuda()
    lab = torch.from_numpy(np.ascontiguousarray(host["label"])).cuda()
    if not lab.is_floating_point():
        lab = lab.long()
    ok = (got["image"].is_cuda and got["image"].dtype == img.dtype
          and torch.equal(got["image"], img) and got["label"].dtype ==
          lab.dtype and torch.equal(got["label"], lab)
          and np.array_equal(got["valid"], host["valid"])
          and got["task_id"] == host["task_id"])
    if not ok:
        fail(f"{tag}: a cached batch of {host['task_id']} differs from the "
             "streamed one")


def cached_batches_check(tag, d, cache):
    """Phase 11a: the first eval batch of every task and the first
    CACHE_BITWISE_TRAIN train batches, gathered from ``cache`` and
    streamed by a fresh engine without it: bitwise on the card."""
    import copy

    from fmc_uia_tpu_torch.config import Config
    from fmc_uia_tpu_torch.data.pipeline import build_data_engines

    plain = copy.deepcopy(d)
    plain["data"]["device_cache"] = False
    train, val, _ = build_data_engines(Config(config_dict=plain))
    try:
        seen = set()
        for rows in val._eval_batches():
            tid = val.dataset.rows[rows[0]]["task_id"]
            if tid in seen:
                continue
            seen.add(tid)
            host = val._load_batch(rows)
            val.device_cache = cache
            same_on_card(tag, val._load_batch(rows), host)
            val.device_cache = None
        n_train = 0
        for rows in train._train_batches():
            same_on_card(tag, cache.get_batch(rows), train._load_batch(rows))
            n_train += 1
            if n_train == CACHE_BITWISE_TRAIN:
                break
    finally:
        train.close()
        val.close()
    log(f"{tag} cached vs streamed, bitwise on the card: the first eval "
        f"batch of each of {len(seen)} tasks and {n_train} train batches")
    return len(seen), n_train


def synth_checkpoint(manifest, seed, path):
    """A checkpoint file of random f32 tensors (seeded) with a manifest's
    keys and shapes: N(0, 0.02^2), the relative-position index a long
    buffer of zeros, the RoPE periods uniform in [1, 100). Returns its
    MB."""
    import torch

    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, shape in manifest.items():
        if k.endswith("relative_position_index"):
            sd[k] = torch.zeros(shape, dtype=torch.long)
        elif k.endswith("rope_embed.periods"):
            sd[k] = 1.0 + 99.0 * torch.rand(shape, generator=g)
        else:
            sd[k] = 0.02 * torch.randn(shape, generator=g)
    torch.save(sd, path)
    return os.path.getsize(path) / 1e6


def spm_pretrained_check(tag, d, r, ckpt_path, smi):
    """Phase 11d after the fit: the backbone of ``best_model.pt`` bitwise
    the checkpoint's (``freeze_dino``), and one segmentation answer of the
    loaded model f32 on the card against f32 on the CPU (1e-3 of the
    largest output)."""
    import numpy as np
    import torch

    from fmc_uia_tpu_torch import checkpoint as ckpt_lib
    from fmc_uia_tpu_torch.config import Config
    from fmc_uia_tpu_torch.models import build_model
    from fmc_uia_tpu_torch.ops.image import normalize_images
    from fmc_uia_tpu_torch.tasks import TaskRegistry
    from fmc_uia_tpu_torch.utils import convert

    exp = r["experiment_dir"]
    best = ckpt_lib.load_best_params(exp, "cpu")
    want = convert.jax_leaves_to_port({"encoder": {"backbone":
        convert.convert_dinov3(convert.load_torch_state_dict(ckpt_path))}})
    bad = [k for k, a in want.items()
           if not torch.equal(best[k], torch.from_numpy(a))]
    if bad or len(want) < 24 * 12:
        fail(f"{tag}: {len(bad)} of {len(want)} backbone leaves differ from "
             f"the checkpoint after the fit: {bad[:6]}")
    with open(os.path.join(exp, "config.yaml")) as f:
        cfg = Config(config_dict=json.load(f))
    reg = TaskRegistry.from_config(cfg)
    card = build_model(cfg, reg, dtype=torch.float32, device="cuda",
                       init=False)
    card.load_state_dict(best)
    cpu = build_model(cfg, reg, dtype=torch.float32, device="cpu",
                      init=False)
    cpu.load_state_dict(best)
    spec = next(reg[t] for t in reg.task_ids
                if reg[t].task_name == "segmentation")
    img = np.random.RandomState(11).randint(
        0, 256, (1, SUBMIT_IMAGE, SUBMIT_IMAGE, 3)).astype(np.uint8)
    norm = cfg.get("data.augmentation.normalize")
    x = normalize_images(torch.from_numpy(img), norm["mean"], norm["std"])
    _, err = compare_models(card, cpu, x, spec, 1e-3,
                            f"{tag} f32 card vs cpu")
    del card, cpu
    torch.cuda.empty_cache()
    log(f"{tag} backbone after the fit bitwise the checkpoint's: "
        f"{len(want)} leaves; {spec.task_id} f32 card vs CPU err "
        f"{err:.3e} (tol 1e-3 of the largest output) | {smi}")
    return {"backbone_leaves": len(want), "card_vs_cpu_err": err}


def start_verify(path):
    """``python -m fmc_uia_tpu_torch.utils.convert --verify`` on the card,
    started in a subprocess; ``finish_verify`` waits for it."""
    return path, time.perf_counter(), subprocess.Popen(
        [sys.executable, "-m", "fmc_uia_tpu_torch.utils.convert", "--verify",
         path], cwd=HERE, env=dict(os.environ, PYTHONPATH=HERE),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def stop_verify(started):
    """Kill a ``start_verify`` still running (a phase that failed)."""
    if started is not None and started[2].poll() is None:
        started[2].kill()
        started[2].communicate()


def finish_verify(tag, started):
    """Wait for a ``start_verify``: exit 0 and PASS. Returns its seconds."""
    path, t0, proc = started
    try:
        out, err = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        fail(f"{tag} --verify {os.path.basename(path)}: no answer in 600 s")
    secs = time.perf_counter() - t0
    for line in out.splitlines():
        if line.startswith("[verify]"):
            log(f"{tag}   {line}")
    if proc.returncode != 0 or "RESULT: PASS" not in out:
        fail(f"{tag} --verify {os.path.basename(path)}: exit "
             f"{proc.returncode}\n{out[-2000:]}\n{err[-2000:]}")
    log(f"{tag} --verify {os.path.basename(path)}: PASS in {secs:.1f} s")
    return secs


def phase11(name, smi, report):
    """The device-resident dataset cache, adaptive normalisation and
    pretrained encoders from a local checkpoint (module docstring, phase
    11). Returns each kernel's launches over the phase's fits."""
    import copy
    import shutil
    import tempfile

    import torch

    from fmc_uia_tpu_torch.flagship import (
        dinov3_spm_config_dict,
        flagship_config_dict,
    )
    from fmc_uia_tpu_torch.utils import timm_manifests as M

    t11 = time.perf_counter()
    totals = {c.__name__: 0 for c in all_kernels()}
    rep = {}
    seconds = {}
    staged = report.get("train", {}).get("img_s")
    streamed = [e["img_s"] for e in report.get("fit", {}).get("epochs", [])
                if e["epoch"] > 1]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_phase11_")
    try:
        base = flagship_config_dict()
        root, gen_s, data_mb = write_flagship_frames(base["tasks"],
                                                     "[cache]")
        base["data"].update(root_path=root, fused_preprocess=True,
                            device_cache=True)
        base["experiment"].update(save_checkpoints=False)
        base["validation"].update(enabled=True, freq=1)

        # (a) phase 6's fit with the cache on
        t0 = time.perf_counter()
        tag = "[cache]"
        d = copy.deepcopy(base)
        d["experiment"]["output_dir"] = os.path.join(tmp, "out_a")
        d["training"].update(num_epochs=2, steps_per_epoch=CACHE_FIT_STEPS)
        r, fit_s, launches, (train, val), k3 = counted_fit(tag, d, totals)
        cache = train.device_cache
        if (cache is None or val.device_cache is not cache
                or cache.skipped_tasks
                or not cache.covers(train.indices + val.indices)):
            fail(f"{tag} the cache does not cover every row")
        steps = check_fit_launches(tag, r, launches, k3)
        n_val, n_train = cached_batches_check(tag, d, cache)
        epochs = epoch_rows(r)
        last = epochs[-1]
        rep["a"] = dict(staged_mb=cache.nbytes / 1e6, fit_s=fit_s,
                        epochs=epochs, launches=launches, train_steps=steps,
                        eval_batches=r["eval_batches"],
                        bitwise_tasks=n_val, bitwise_train=n_train,
                        staged_img_s=staged, streamed_img_s=streamed)
        for e in epochs:
            log(f"{tag} epoch {e['epoch']}: {e['steps']} steps in "
                f"{e['loop_s']:.2f} s, {e['img_s']:.2f} img/s from the "
                f"cache; queue wait "
                f"{100 * e['queue_wait_share']:.2f} % of the loop; host "
                f"{e['host_ms_per_batch']:.2f} ms (gather enqueue) + "
                f"{e['put_ms_per_batch']:.2f} ms (put) per batch")
        vs = (f"{last['img_s'] / staged:.3f} of phase 5 staged "
              f"{staged:.2f}" if staged else "phase 5 not run")
        log(f"{tag} staged {cache.nbytes / 1e6:.0f} MB of {data_mb:.0f} MB "
            f"PNG; epoch 2 ({last['loop_s']:.2f} s) {last['img_s']:.2f} "
            f"img/s = {vs}; phase 6 "
            f"streaming {', '.join(f'{v:.2f}' for v in streamed) or 'not run'}"
            f"; limit 0.9 of staged | {name} | {smi}")
        seconds["a"] = time.perf_counter() - t0

        # (b) a budget that forces partial staging
        t0 = time.perf_counter()
        tag = "[cache-partial]"
        d = copy.deepcopy(base)
        d["data"]["device_cache_budget_mb"] = CACHE_PARTIAL_MB
        d["experiment"]["output_dir"] = os.path.join(tmp, "out_b")
        d["training"].update(num_epochs=1, steps_per_epoch=CACHE_SHORT_STEPS)
        r, fit_s, launches, (train, _), k3 = counted_fit(tag, d, totals)
        cache = train.device_cache
        if cache is None or not cache.skipped_tasks or not cache.position:
            fail(f"{tag} a {CACHE_PARTIAL_MB} MB budget staged "
                 f"{'nothing' if cache is None else 'every task'}")
        check_fit_launches(tag, r, launches, k3)
        rep["b"] = dict(budget_mb=CACHE_PARTIAL_MB,
                        staged_mb=cache.nbytes / 1e6,
                        streamed_tasks=list(cache.skipped_tasks),
                        staged_tasks=len(cache._images), fit_s=fit_s,
                        epochs=epoch_rows(r), launches=launches)
        log(f"{tag} budget {CACHE_PARTIAL_MB} MB: {len(cache._images)} "
            f"tasks staged ({cache.nbytes / 1e6:.0f} MB), "
            f"{len(cache.skipped_tasks)} stream: {cache.skipped_tasks}; "
            f"the fit finished; smoke timing (6 steps, warm-up included, "
            f"not a throughput) {rep['b']['epochs'][-1]['img_s']:.2f} img/s")
        seconds["b"] = time.perf_counter() - t0

        # (c) adaptive normalisation, cached (f32 banks), K3 0
        t0 = time.perf_counter()
        tag = "[cache-adaptive]"
        d = copy.deepcopy(base)
        d["data"]["use_adaptive_norm"] = True
        d["data"]["augmentation"]["normalize"] = {"mean": [0, 0, 0],
                                                  "std": [1, 1, 1]}
        d["validation"]["enabled"] = False
        d["experiment"]["output_dir"] = os.path.join(tmp, "out_c")
        d["training"].update(num_epochs=1, steps_per_epoch=CACHE_SHORT_STEPS)
        r, fit_s, launches, (train, _), k3 = counted_fit(tag, d, totals)
        cache = train.device_cache
        if cache is None or any(b.dtype != torch.float32
                                for b in cache._images.values()):
            fail(f"{tag} the banks are not f32")
        check_fit_launches(tag, r, launches, k3, adaptive=True)
        rep["c"] = dict(staged_mb=cache.nbytes / 1e6, fit_s=fit_s,
                        epochs=epoch_rows(r), launches=launches)
        log(f"{tag} f32 banks {cache.nbytes / 1e6:.0f} MB; smoke timing "
            f"(6 steps, warm-up included, not a throughput) "
            f"{rep['c']['epochs'][-1]['img_s']:.2f} img/s; K3 0 launches")
        del cache, train
        torch.cuda.empty_cache()
        seconds["c"] = time.perf_counter() - t0

        # (d) the SPM preset from a DINOv3 ViT-L/16 checkpoint
        t0 = time.perf_counter()
        tag = "[pretrained-spm]"
        dino_path = os.path.join(tmp, "dinov3_vitl16.pth")
        mb = synth_checkpoint(M.dinov3_manifest(1024, 24, 16, 16, 4), 21,
                              dino_path)
        log(f"{tag} wrote a seeded DINOv3 ViT-L/16 checkpoint ({mb:.0f} MB)")
        d = dinov3_spm_config_dict()
        d["model"]["encoder"]["pretrained"] = dino_path
        d["data"].update(root_path=root, fused_preprocess=True)
        d["experiment"].update(output_dir=os.path.join(tmp, "out_d"),
                               save_checkpoints=False)
        d["validation"].update(enabled=True, freq=1)
        d["training"].update(num_epochs=1, steps_per_epoch=PRETRAINED_STEPS)
        r, fit_s, launches, _, k3 = counted_fit(tag, d, totals)
        steps = sum(e["steps"] for e in r["epoch_stats"])
        want = {c.__name__: 0 for c in all_kernels()}
        want["augment_normalize"] = steps
        if launches != want:
            fail(f"{tag} launches {launches} != {want}")
        rep["d"] = dict(checkpoint_mb=mb, fit_s=fit_s, launches=launches,
                        **spm_pretrained_check(tag, d, r, dino_path, smi))
        seconds["d"] = time.perf_counter() - t0

        # (e) the flagship from a swin_b window-12 checkpoint (window 8)
        t0 = time.perf_counter()
        tag = "[pretrained-swin]"
        swin_path = os.path.join(tmp, "swin_base_patch4_window12.pth")
        mb = synth_checkpoint(M.swin_manifest(128, (2, 2, 18, 2),
                                              (4, 8, 16, 32), 12), 22,
                              swin_path)
        d = copy.deepcopy(base)
        d["data"]["device_cache"] = False
        d["model"]["encoder"]["pretrained"] = swin_path
        d["validation"]["enabled"] = False
        d["experiment"]["output_dir"] = os.path.join(tmp, "out_e")
        d["training"].update(num_epochs=1, steps_per_epoch=PRETRAINED_STEPS)
        r, fit_s, launches, _, k3 = counted_fit(tag, d, totals)
        check_fit_launches(tag, r, launches, k3)
        rep["e"] = dict(checkpoint_mb=mb, fit_s=fit_s, launches=launches)
        log(f"{tag} swin_b window 12 ({mb:.0f} MB): its relative-position "
            f"tables resampled 23² -> 15² on load; {PRETRAINED_STEPS} steps")
        seconds["e"] = time.perf_counter() - t0

        # (f) the --verify CLI on both files, both at once
        t0 = time.perf_counter()
        started = [start_verify(p) for p in (dino_path, swin_path)]
        try:
            rep["f"] = {os.path.basename(v[0]): finish_verify("[verify]", v)
                        for v in started}
        finally:
            for v in started:
                stop_verify(v)
        seconds["f"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rep.update(seconds=seconds, launches=totals,
               total_s=time.perf_counter() - t11)
    report["phase11"] = rep
    log(f"[phase11] {rep['total_s']:.1f} s (gen {gen_s:.1f}; "
        + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items())
        + f"); launches over its fits: {totals}")
    return totals


def phase11_main() -> int:
    """``--phase11``: the kernels' build and phase 11 alone."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from fmc_uia_tpu_torch.ops import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build()
    report = {}
    smi = nvidia_smi_line()
    totals = phase11(torch.cuda.get_device_name(0), smi, report)
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke_phase11.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({"phase11_s": report["phase11"]["total_s"],
                      "launches": totals, "card": smi}))
    return 0


# ---------------------------------------------------------------------------
# phase 12: the ablation presets (queue 1 item 7: off-main-path heads,
# conditioning and step options) on the flagship
# ---------------------------------------------------------------------------
ABLATION_MICRO = {"a": 4, "b": 2}  # staged micro-steps a type (phase 12b)
ABLATION_BURST = 4                 # train_burst steps (phase 12d)
ABLATION_FIT_STEPS = 2             # phase 12e: 1 epoch of this many steps


def ablation_preset(which):
    from fmc_uia_tpu_torch import flagship

    return dict(key=f"ablation_{which}",
                config=getattr(flagship, f"ablation_{which}_config_dict"))


def flat_outputs(out):
    """A head's output as {name: tensor}: a deep-supervision tuple as
    ``main`` and ``aux{i}``, a CenterNet dict as it is, else ``out``."""
    if isinstance(out, tuple):
        return {"main": out[0],
                **{f"aux{i}": a for i, a in enumerate(out[1])}}
    return out if isinstance(out, dict) else {"out": out}


def compare_flat(a, b, rel_tol, what):
    """Each output of ``a`` within ``rel_tol`` of the largest magnitude of
    ``b``'s; returns {name: max abs err}."""
    errs = {}
    for k, ref in b.items():
        d = float((a[k].float().cpu() - ref.float().cpu()).abs().max())
        top = float(ref.float().abs().max())
        if not d <= rel_tol * max(top, 1e-3):
            fail(f"{what} {k}: err {d:.3e} > {rel_tol} x {top:.3e}")
        errs[k] = d
    return errs


def check_grid_boxes(boxes, got_map, ref_map, err, what):
    """Grid boxes decoded from ``got_map`` (``boxes``, [B, 4]) against the
    decode of ``ref_map`` ([B, h, w, 5]): where both pick the same
    objectness cell, the boxes within ``err`` (the maps' largest
    difference); where they pick other cells, the reference's objectness
    at the two within 2 * err (a near tie). Returns (same cells, near
    ties taken)."""
    import torch

    from fmc_uia_tpu_torch.ops.centernet import decode_grid_detection

    B = ref_map.shape[0]
    og = got_map[..., 4].reshape(B, -1).float().cpu()
    orf = ref_map[..., 4].reshape(B, -1).float().cpu()
    cg, cr = og.argmax(1), orf.argmax(1)
    same = cg == cr
    gap = (orf.gather(1, cr[:, None]) - orf.gather(1, cg[:, None]))[:, 0]
    if bool(((~same) & (gap > 2 * err)).any()):
        fail(f"{what}: a grid argmax moved away from a near tie (gap "
             f"{float(gap.max()):.3e} > 2 x {err:.3e})")
    ref_boxes = decode_grid_detection(ref_map.float().cpu())
    d = (torch.as_tensor(boxes).float().cpu() - ref_boxes).abs().max(1).values
    if bool((same & (d > err)).any()):
        fail(f"{what}: grid boxes differ by {float(d[same].max()):.3e} at "
             f"the same cell (> {err:.3e})")
    return int(same.sum()), int((~same).sum())


def preset_serving(tag, cfg, registry, totals, per_fwd=None,
                   cpu_image=IMAGE):
    """Phases 12a and 13a: Predictor forwards at B = 8, one task of each
    type, every kernel's launches exactly ``per_fwd`` a forward (default
    K1f 24 and K2f 4), then the raw outputs (every deep-supervision
    output, the grid map) bf16 against f32 on the card at B = 8 (0.1 of
    the largest) and f32 on the card against f32 on the CPU at B = 1 and
    ``cpu_image``² (1e-3), phase 3's rules; decoded seg / cls ids equal
    but at near ties, grid boxes as ``check_grid_boxes``. Returns (the
    bf16 model, report)."""
    import numpy as np
    import torch

    from fmc_uia_tpu_torch.export import Predictor
    from fmc_uia_tpu_torch.flagship import SERVING_TASKS
    from fmc_uia_tpu_torch.models import build_model
    from fmc_uia_tpu_torch.ops import swin_block as sb
    from fmc_uia_tpu_torch.ops.centernet import decode_grid_detection
    from fmc_uia_tpu_torch.ops.image import normalize_images

    mean = cfg.get("data.augmentation.normalize.mean")
    std = cfg.get("data.augmentation.normalize.std")
    model = build_model(cfg, registry, dtype=torch.bfloat16, device="cuda",
                        generator=torch.Generator().manual_seed(0))
    pred = Predictor(model, registry, mean, std, IMAGE, device="cuda")
    imgs = np.random.RandomState(12).randint(
        0, 256, (BATCH, IMAGE, IMAGE, 3)).astype(np.uint8)
    for tid in SERVING_TASKS:  # first use
        pred.predict_images(imgs, tid)
    torch.cuda.synchronize()
    for c in all_kernels():
        c.launches = 0
    t0 = time.perf_counter()
    outs = {tid: pred.predict_images(imgs, tid) for tid in SERVING_TASKS}
    fwd_ms = 1e3 * (time.perf_counter() - t0) / len(SERVING_TASKS)
    launches = {c.__name__: c.launches for c in all_kernels()}
    n = len(SERVING_TASKS)
    per_fwd = ({sb.attention_branch.__name__: 24, sb.mlp_branch.__name__: 4}
               if per_fwd is None else per_fwd)
    want = {k: n * per_fwd.get(k, 0) for k in launches}
    if launches != want:
        fail(f"{tag} launches {launches} != {want}")
    for k, v in launches.items():
        totals[k] += v
    got = (launches["attention_branch"], launches["mlp_branch"])
    model32 = build_model(cfg, registry, dtype=torch.float32, device="cuda",
                          init=False)
    model32.load_state_dict(model.state_dict())
    cpu = build_model(cfg, registry, dtype=torch.float32, device="cpu",
                      init=False)
    cpu.load_state_dict(model.state_dict())
    x = normalize_images(torch.from_numpy(imgs), mean, std)
    xc = x.cuda()
    x1 = x[:1] if cpu_image == IMAGE else normalize_images(
        torch.from_numpy(np.random.RandomState(13).randint(
            0, 256, (1, cpu_image, cpu_image, 3)).astype(np.uint8)),
        mean, std)
    rep = {}
    for tid in SERVING_TASKS:
        spec = registry[tid]
        args = (spec.task_name, spec.global_index)
        with torch.inference_mode():
            a = flat_outputs(model(xc, *args))
            b = flat_outputs(model32(xc, *args))
            b1 = flat_outputs(model32(x1.cuda(), *args))
            c1 = flat_outputs(cpu(x1, *args))
        e16 = compare_flat(a, b, 0.1, f"{tag} {tid} bf16 vs f32")
        e32 = compare_flat(b1, c1, 1e-3, f"{tag} {tid} f32 card vs cpu")
        entry = {"outputs": sorted(b), "bf16_vs_f32_err": e16,
                 "f32_card_vs_cpu_err": e32}
        key = "main" if "main" in b else "out"
        p = torch.from_numpy(outs[tid])
        if spec.task_name in ("segmentation", "classification"):
            entry["disagree"], entry["near_ties"] = near_tie_ok(
                p, b[key].float().cpu(), e16[key], spec.num_classes)
        elif spec.task_name == "detection":
            if "out" in b:  # a grid head (CenterNet's maps: compared)
                entry["grid_same_cells"], entry["grid_near_ties"] = (
                    check_grid_boxes(p, a["out"], b["out"], e16["out"],
                                     f"{tag} {tid} bf16 vs f32"))
                check_grid_boxes(
                    decode_grid_detection(b1["out"].float().cpu()),
                    b1["out"], c1["out"], e32["out"],
                    f"{tag} {tid} f32 card vs cpu")
        else:
            entry["decoded_err"] = float((p - b[key].float().cpu()).abs()
                                         .max())
        rep[tid] = entry
        log(f"{tag}   {tid:20s} {entry}")
    del model32, cpu
    torch.cuda.empty_cache()
    return model, {"fwd_ms_b8": fwd_ms, "launches": got, "compare": rep}


def ablation_staged(tag, which, cfg, registry, model, totals):
    """Phase 12b: the Trainer at B = 24 on ``train_batches``,
    ABLATION_MICRO[which] micro-steps a type in turn; under accumulation
    the params bitwise unchanged after each odd micro-step and changed
    after each even one, else changed after every step; finite losses;
    launches 24/24/4/4 (K1f/K1b/K2f/K2b) a micro-step. Each step is
    synced: ms a step, img/s and the peak memory."""
    import numpy as np
    import torch

    from fmc_uia_tpu_torch.ops import swin_block as sb
    from fmc_uia_tpu_torch.train import Trainer

    trainer = Trainer(cfg, model, registry, device="cuda")
    batches = train_batches(registry, TRAIN_BATCH, IMAGE, seed=12)
    params = list(model.parameters())
    snap = [p.detach().clone() for p in params]
    counters = (sb.attention_branch, sb.attention_branch_backward,
                sb.mlp_branch, sb.mlp_branch_backward)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    k, ms, losses = 0, {}, {}
    for t, b in batches.items():
        for _ in range(ABLATION_MICRO[which]):
            t0 = time.perf_counter()
            logs = trainer.train_batch(b, 0)
            torch.cuda.synchronize()
            ms.setdefault(t, []).append(1e3 * (time.perf_counter() - t0))
            losses.setdefault(t, []).append(float(logs["total_loss"]))
            k += 1
            changed = any(not torch.equal(p, q) for p, q in zip(params,
                                                                 snap))
            want = trainer.accum_steps <= 1 or k % trainer.accum_steps == 0
            if changed != want:
                fail(f"{tag} micro-step {k} ({t}): params "
                     f"{'changed' if changed else 'unchanged'}")
            if changed:
                snap = [p.detach().clone() for p in params]
    launches = {c.__name__: c.launches for c in counters}
    want = {"attention_branch": 24 * k, "attention_branch_backward": 24 * k,
            "mlp_branch": 4 * k, "mlp_branch_backward": 4 * k}
    if launches != want:
        fail(f"{tag} launches {launches} != {want}")
    for kname, v in launches.items():
        totals[kname] += v
    if not all(math.isfinite(v) for vs in losses.values() for v in vs):
        fail(f"{tag} non-finite losses {losses}")
    del snap
    # the first micro-step of a type is its first use (allocator, cuDNN
    # heuristics): ms a step is the median of the others
    warm = [v for vs in ms.values() for v in vs[1:]]
    med = float(np.median(warm))
    rep = {"micro_steps": k, "accumulation_steps": trainer.accum_steps,
           "updates": trainer.optimizer.count, "ms_by_type": ms,
           "losses": losses, "median_ms_warm": med,
           "img_s": TRAIN_BATCH / (med / 1e3),
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "launches": launches}
    return trainer, batches, rep


def ablation_burst(tag, which, cfg, registry, model, trainer, batches,
                   totals):
    """Phase 12d: ``train_burst`` of ABLATION_BURST steps on the seg batch
    against as many ``train_batch`` calls on a copy of the model, its
    optimizer state and generator: the first loss bitwise, the others
    within 1e-3 relative and the params within two Adam steps of each
    other (the backward's sums may run in another order); under
    accumulation it must raise, as in JAX."""
    import torch

    from fmc_uia_tpu_torch.models import build_model
    from fmc_uia_tpu_torch.ops import swin_block as sb
    from fmc_uia_tpu_torch.train import Trainer

    b = batches["segmentation"]
    if trainer.accum_steps > 1:
        try:
            trainer.train_burst(b, ABLATION_BURST)
        except NotImplementedError as e:
            log(f"{tag} train_burst under accumulation raises: {e}")
            return {"raises": str(e)}
        fail(f"{tag} train_burst ran under accumulation")
    twin = build_model(cfg, registry, dtype=model.dtype, device="cuda",
                       init=False)
    twin.load_state_dict(model.state_dict())
    t2 = Trainer(cfg, twin, registry, device="cuda")
    t2.optimizer.load_state_dict(trainer.optimizer.state_dict())
    t2.generator.set_state(trainer.generator.get_state())
    counters = (sb.attention_branch, sb.attention_branch_backward,
                sb.mlp_branch, sb.mlp_branch_backward)
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    burst = trainer.train_burst(b, ABLATION_BURST)["losses"]
    torch.cuda.synchronize()
    burst_ms = 1e3 * (time.perf_counter() - t0)
    steps = torch.stack([t2.train_batch(b, 0)["total_loss"]
                         for _ in range(ABLATION_BURST)])
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    n = 2 * ABLATION_BURST
    if launches != {"attention_branch": 24 * n,
                    "attention_branch_backward": 24 * n,
                    "mlp_branch": 4 * n, "mlp_branch_backward": 4 * n}:
        fail(f"{tag} burst launches {launches}")
    for kname, v in launches.items():
        totals[kname] += v
    burst, steps = burst.float().cpu(), steps.float().cpu()
    rel = float(((burst - steps).abs() / steps.abs()).max())
    # an Adam step moves an element by about lr x its group's multiplier
    # whatever its grad's size, so a grad summed in another order may move
    # it the other way: the params within two such steps a step
    step = trainer.scheduler.current_lr() * max(
        m for m, _ in trainer.optimizer.groups)
    with torch.no_grad():
        p_gap = max(float((p - q).abs().max())
                    for p, q in zip(model.parameters(), twin.parameters()))
    if (not bool(torch.isfinite(burst).all()) or burst[0] != steps[0]
            or rel > 1e-3 or p_gap > 2 * ABLATION_BURST * step):
        fail(f"{tag} burst {burst.tolist()} vs steps {steps.tolist()} "
             f"(worst loss rel {rel:.2e}, params {p_gap:.2e} apart, "
             f"bound {2 * ABLATION_BURST * step:.2e})")
    del twin, t2
    torch.cuda.empty_cache()
    return {"losses": burst.tolist(), "train_batch_losses": steps.tolist(),
            "worst_loss_rel": rel, "param_gap": p_gap,
            "param_gap_bound": 2 * ABLATION_BURST * step,
            "burst_ms": burst_ms, "launches": launches}


def ablation_fit(tag, which, totals, smi):
    """Phase 12e: the preset's ``fit`` (K3, 1 epoch of ABLATION_FIT_STEPS
    steps, validation, checkpoints) on phase 6's data (the same files), its
    launches as the flagship's formula, then ``python -m
    fmc_uia_tpu_torch.predict`` in a subprocess held against an in-process
    ``Predictor`` (``check_predictions``: the grid boxes decoded)."""
    import shutil
    import tempfile

    import torch

    from fmc_uia_tpu_torch import checkpoint as ckpt_lib
    from fmc_uia_tpu_torch.config import Config
    from fmc_uia_tpu_torch.models import build_model
    from fmc_uia_tpu_torch.tasks import TaskRegistry

    tmp = tempfile.mkdtemp(prefix="chip_smoke_phase12_")
    try:
        d = ablation_preset(which)["config"]()
        root, gen_s, _ = write_flagship_frames(d["tasks"], tag)
        d["data"].update(root_path=root, fused_preprocess=True)
        d["experiment"]["output_dir"] = os.path.join(tmp, "out")
        d["validation"].update(enabled=True, freq=1)
        d["training"].update(num_epochs=1,
                             steps_per_epoch=ABLATION_FIT_STEPS)
        r, fit_s, launches, _, k3 = counted_fit(tag, d, totals)
        steps = check_fit_launches(tag, r, launches, k3)
        exp = r["experiment_dir"]
        if not os.path.exists(os.path.join(exp, "best_model.pt")):
            fail(f"{tag} no best_model.pt")
        out = os.path.join(tmp, "preds")
        sub = predict_root(root, tmp)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "fmc_uia_tpu_torch.predict",
             "--checkpoint", exp, "--data", sub, "--out", out],
            cwd=HERE, env=dict(os.environ, PYTHONPATH=HERE),
            capture_output=True, text=True, timeout=600)
        predict_s = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"{tag} predict exited {proc.returncode}: "
                 f"{proc.stderr[-3000:]}")
        with open(os.path.join(exp, "config.yaml")) as f:
            cfg = Config(config_dict=json.load(f))
        registry = TaskRegistry.from_config(cfg)
        model = build_model(cfg, registry, device="cuda", init=False)
        model.load_state_dict(ckpt_lib.load_best_params(exp, "cuda"))
        chk = check_predictions(
            out, sub, model, registry,
            cfg.get("data.augmentation.normalize.mean"),
            cfg.get("data.augmentation.normalize.std"), IMAGE)
        del model
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    e = epoch_rows(r)[0]
    log(f"{tag} fit {fit_s:.1f} s ({steps} steps of B={TRAIN_BATCH}, "
        f"{r['eval_batches']} eval batches; smoke timing {e['img_s']:.2f} "
        f"img/s, warm-up included); predict (subprocess) {predict_s:.1f} s"
        f" for {chk['records']} frames, every value the in-process "
        f"Predictor's (boxes worst "
        f"{chk['worst_box_point_err_over_size']:.1e} of the frame) | {smi}")
    return {"gen_s": gen_s, "fit_s": fit_s, "steps": steps,
            "eval_batches": r["eval_batches"], "epoch": e,
            "launches": launches, "k3_kernels": k3, "predict_s": predict_s,
            "predictions": chk}


def phase12(name, smi, report):
    """The two ablation presets at full width (module docstring, phase
    12). Returns each kernel's launches over the phase's main-path runs:
    12a's Predictor forwards, 12b's staged steps, 12d's burst and steps
    and 12e's fit (not the comparisons, the grad check or the predict
    check)."""
    import torch

    from fmc_uia_tpu_torch.config import Config
    from fmc_uia_tpu_torch.tasks import TaskRegistry

    t12 = time.perf_counter()
    totals = {c.__name__: 0 for c in all_kernels()}
    rep, seconds = {}, {}
    for which in ("a", "b"):
        preset = ablation_preset(which)
        key, tag = preset["key"], f"[{preset['key']}]"
        cfg = Config(config_dict=preset["config"]())
        registry = TaskRegistry.from_config(cfg)
        r = rep[which] = report[key] = {}
        t0 = time.perf_counter()
        # the served model trains next (its cached masks were made under
        # inference mode)
        model, r["serving"] = preset_serving(f"{tag} (a)", cfg, registry,
                                             totals)
        log(f"{tag} (a) Predictor B={BATCH}: {r['serving']['fwd_ms_b8']:.1f}"
            f" ms a forward (synced), launches {r['serving']['launches']}")
        seconds[f"{which}a"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        trainer, batches, r["staged"] = ablation_staged(
            f"{tag} (b)", which, cfg, registry, model, totals)
        st = r["staged"]
        log(f"{tag} (b) staged B={TRAIN_BATCH}: {st['micro_steps']} "
            f"micro-steps, {st['updates']} updates (accumulation "
            f"{st['accumulation_steps']}); {st['median_ms_warm']:.1f} ms a "
            f"step (median, synced, first of each type left out) = "
            f"{st['img_s']:.2f} img/s; peak {st['peak_gib']:.2f} GiB; "
            f"losses {st['losses']} | {name} | {smi}")
        seconds[f"{which}b"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        r["burst"] = ablation_burst(f"{tag} (d)", which, cfg, registry,
                                    model, trainer, batches, totals)
        log(f"{tag} (d) burst: {r['burst']}")
        seconds[f"{which}d"] = time.perf_counter() - t0
        del model, trainer, batches
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        check_train_grads(report, dict(preset, key=key))
        seconds[f"{which}c"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rep["b"]["fit"] = report["ablation_b"]["fit"] = ablation_fit(
        "[ablation_b] (e)", "b", totals, smi)
    seconds["be"] = time.perf_counter() - t0
    report["phase12"] = {"seconds": seconds, "launches": totals,
                         "total_s": time.perf_counter() - t12}
    log(f"[phase12] {report['phase12']['total_s']:.1f} s ("
        + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items())
        + f"); launches over its main-path runs: {totals}")
    return totals


def phase12_main() -> int:
    """``--phase12``: the kernels' build and phase 12 alone."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from fmc_uia_tpu_torch.ops import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build()
    report = {}
    smi = nvidia_smi_line()
    totals = phase12(torch.cuda.get_device_name(0), smi, report)
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke_phase12.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({"phase12_s": report["phase12"]["total_s"],
                      "launches": totals, "card": smi}))
    return 0


# ---------------------------------------------------------------------------
# phase 13: the other encoders and the unfused Swin attention (queue 1 item 8)
# ---------------------------------------------------------------------------
PHASE13_ROUNDS = 2        # timed round-robin rounds of phase 13b
PHASE13_FIT_STEPS = 2     # phase 13c: 1 epoch of this many steps
# preset -> (launches a Predictor forward, launches a train step), by
# kernel; every kernel not named launches 0 times
PHASE13_LAUNCHES = {
    "resnet50": ({}, {}),
    "convnext_base": ({}, {}),
    "efficientnet_b4": ({}, {}),
    "swin_b_fused01": ({"attention_branch": 4, "mlp_branch": 4},
                       {"attention_branch": 4, "attention_branch_backward": 4,
                        "mlp_branch": 4, "mlp_branch_backward": 4}),
    "swin_b_unfused": ({"mlp_branch": 4},
                       {"mlp_branch": 4, "mlp_branch_backward": 4}),
}


def encoder_preset(name):
    """Phase 13's preset ``name``: the flagship with
    ``ENCODER_PRESETS[name]``; its grad check on the segmentation step
    alone (the step whose loss reads every encoder stage through the FPN;
    the heads are the flagship's, checked for every type in phase 5)."""
    from fmc_uia_tpu_torch import flagship

    return dict(key=f"enc_{name}", config=lambda: (
        flagship.flagship_with_encoder(flagship.ENCODER_PRESETS[name])),
        grad_types=("segmentation",))


def staged_rounds(tag, cfg, registry, model, per_step, totals,
                  rounds=PHASE13_ROUNDS):
    """Phases 13b and 15b: the Trainer at B = TRAIN_BATCH on staged
    batches (``train_batches``): a warm-up round (one step a type:
    allocator, cuDNN heuristics), then ``rounds`` timed round-robin
    rounds, each step synced; finite losses; every kernel's launches
    exactly ``per_step`` a step over the timed rounds."""
    import numpy as np
    import torch

    from fmc_uia_tpu_torch.train import Trainer

    trainer = Trainer(cfg, model, registry, device="cuda")
    batches = {t: trainer.put_batch(b) for t, b in train_batches(
        registry, TRAIN_BATCH, IMAGE, seed=13).items()}
    t0 = time.perf_counter()
    for b in batches.values():
        trainer.train_batch(b, 0)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    for c in all_kernels():
        c.launches = 0
    ms, losses = {}, {}
    for _ in range(rounds):
        for t, b in batches.items():
            t0 = time.perf_counter()
            logs = trainer.train_batch(b, 0)
            torch.cuda.synchronize()
            ms.setdefault(t, []).append(1e3 * (time.perf_counter() - t0))
            losses.setdefault(t, []).append(float(logs["total_loss"]))
    steps = rounds * len(batches)
    launches = {c.__name__: c.launches for c in all_kernels()}
    want = {k: steps * per_step.get(k, 0) for k in launches}
    if launches != want:
        fail(f"{tag} launches {launches} != {want}")
    for k, v in launches.items():
        totals[k] += v
    if not all(math.isfinite(v) for vs in losses.values() for v in vs):
        fail(f"{tag} non-finite losses {losses}")
    total_ms = sum(sum(v) for v in ms.values())
    rep = {"batch": TRAIN_BATCH, "rounds": rounds, "steps": steps,
           "warmup_round_s": warm_s,
           "ms_by_type": {t: float(np.median(v)) for t, v in ms.items()},
           "ms_all": ms, "img_s": steps * TRAIN_BATCH / (total_ms / 1e3),
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "losses": losses, "launches": launches}
    del trainer, batches
    return rep


def phase13_pretrained_fit(tag, totals, smi):
    """Phase 13c: a seeded torchvision-layout ResNet-50 checkpoint,
    ``--verify`` on it on the card, then the resnet50 preset's ``fit``
    from it (module docstring, phase 13)."""
    import shutil
    import tempfile
    import warnings

    import torch

    from fmc_uia_tpu_torch import checkpoint as ckpt_lib
    from fmc_uia_tpu_torch.ops import preprocess as pp
    from fmc_uia_tpu_torch.utils import timm_manifests

    tmp = tempfile.mkdtemp(prefix="chip_smoke_phase13_")
    verify = None
    try:
        ckpt = os.path.join(tmp, "resnet50_torchvision.pth")
        mb = synth_checkpoint(timm_manifests.resnet50_manifest(), 13, ckpt)
        verify = start_verify(ckpt)  # runs beside the fit
        d = encoder_preset("resnet50")["config"]()
        d["model"]["encoder"]["pretrained"] = ckpt
        root, gen_s, _ = write_flagship_frames(d["tasks"], tag)
        d["data"].update(root_path=root, fused_preprocess=True)
        d["experiment"]["output_dir"] = os.path.join(tmp, "out")
        d["validation"].update(enabled=True, freq=1)
        d["training"].update(num_epochs=1, steps_per_epoch=PHASE13_FIT_STEPS)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            r, fit_s, launches, _, k3 = counted_fit(tag, d, totals)
        said = [str(w.message) for w in caught
                if "BatchNorm running statistics" in str(w.message)]
        if len(said) != 1:
            fail(f"{tag}: the BatchNorm warning was raised {len(said)} "
                 "times, not once")
        steps = sum(e["steps"] for e in r["epoch_stats"])
        want = {c.__name__: 0 for c in all_kernels()}
        want[pp.augment_normalize.__name__] = steps
        if steps != PHASE13_FIT_STEPS or launches != want:
            fail(f"{tag} launches {launches} != {want} ({steps} steps)")
        if k3 != {"vector": steps, "edge": 0}:
            fail(f"{tag}: K3 kernels {k3}, not {steps} of the chunk kernel")
        best = ckpt_lib.load_best_params(r["experiment_dir"], "cpu")
        conv1 = torch.load(ckpt, weights_only=True)["conv1.weight"]
        moved = float((best["encoder.stem_conv.kernel"] - conv1).abs().max())
        if not moved <= 1e-3:
            fail(f"{tag}: the stem conv after the fit is {moved:.3e} from "
                 "the checkpoint's (> 1e-3): the file was not loaded")
        verify_s = finish_verify(tag, verify)
    finally:
        stop_verify(verify)
        shutil.rmtree(tmp, ignore_errors=True)
    e = epoch_rows(r)[0]
    log(f"{tag} checkpoint {mb:.1f} MB; --verify {verify_s:.1f} s; fit "
        f"{fit_s:.1f} s ({steps} steps of B={TRAIN_BATCH}, "
        f"{r['eval_batches']} eval batches; smoke timing {e['img_s']:.2f} "
        f"img/s, warm-up included); warned once: {said[0][:60]}...; stem "
        f"conv {moved:.2e} from the file's after the fit; K3 {k3} | {smi}")
    return {"checkpoint_mb": mb, "verify_s": verify_s, "gen_s": gen_s,
            "fit_s": fit_s, "steps": steps, "eval_batches": r["eval_batches"],
            "epoch": e, "launches": launches, "k3_kernels": k3,
            "stem_conv_moved": moved, "warning": said[0]}


def phase13(name, smi, report):
    """The item-8 encoders at full width (module docstring, phase 13).
    Returns each kernel's launches over the phase's main-path runs: 13a's
    Predictor forwards, 13b's timed rounds and 13c's fit (not the
    warm-up, the comparisons, the grad checks or ``--verify``)."""
    import torch

    from fmc_uia_tpu_torch.config import Config
    from fmc_uia_tpu_torch.flagship import ENCODER_PRESETS
    from fmc_uia_tpu_torch.tasks import TaskRegistry

    t13 = time.perf_counter()
    totals = {c.__name__: 0 for c in all_kernels()}
    seconds = {}
    for pname in ENCODER_PRESETS:
        preset = encoder_preset(pname)
        key, tag = preset["key"], f"[{preset['key']}]"
        per_fwd, per_step = PHASE13_LAUNCHES[pname]
        cfg = Config(config_dict=preset["config"]())
        registry = TaskRegistry.from_config(cfg)
        r = report[key] = {}
        t0 = time.perf_counter()
        model, r["serving"] = preset_serving(
            f"{tag} (a)", cfg, registry, totals, per_fwd=per_fwd,
            cpu_image=GRAD_IMAGE)
        r["params_M"] = sum(p.numel() for p in model.parameters()) / 1e6
        log(f"{tag} (a) {cfg.get('model.encoder.name')} "
            f"{r['params_M']:.1f} M params; Predictor B={BATCH}: "
            f"{r['serving']['fwd_ms_b8']:.1f} ms a forward (synced), "
            f"launches {r['serving']['launches']}")
        seconds[f"{pname} a"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        r["staged"] = st = staged_rounds(f"{tag} (b)", cfg, registry, model,
                                         per_step, totals)
        del model
        torch.cuda.empty_cache()
        log(f"{tag} (b) staged B={TRAIN_BATCH}: {st['steps']} steps after a "
            f"warm-up round ({st['warmup_round_s']:.1f} s); ms a step by "
            f"type (median, synced) "
            f"{ {k: round(v, 1) for k, v in st['ms_by_type'].items()} } = "
            f"{st['img_s']:.2f} img/s; peak {st['peak_gib']:.2f} GiB; "
            f"launches {st['launches']} | {name} | {smi}")
        check_train_grads(report, preset)
        torch.cuda.empty_cache()
        seconds[f"{pname} b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    report["phase13_pretrained"] = phase13_pretrained_fit(
        "[enc_resnet50] (c)", totals, smi)
    seconds["resnet50 c"] = time.perf_counter() - t0
    report["phase13"] = {"seconds": seconds, "launches": totals,
                         "total_s": time.perf_counter() - t13}
    log(f"[phase13] {report['phase13']['total_s']:.1f} s ("
        + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items())
        + f"); launches over its main-path runs: {totals}")
    return totals


def phase13_main() -> int:
    """``--phase13``: the kernels' build and phase 13 alone."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from fmc_uia_tpu_torch.ops import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build()
    report = {}
    smi = nvidia_smi_line()
    totals = phase13(torch.cuda.get_device_name(0), smi, report)
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke_phase13.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({"phase13_s": report["phase13"]["total_s"],
                      "launches": totals, "card": smi}))
    return 0


# ---------------------------------------------------------------------------
# phase 14: the parallel modes (queue 1 item 9) on the one card
# ---------------------------------------------------------------------------
P14_B32 = 4          # (b)-(d): the f32 global batch (2 a rank under DP)
P14_PIPE_B = 24      # (f): the pipelined stage's batch, M microbatches
P14_PIPE_M = 8
P14_TIMEOUT_S = 600  # each spawned group's deadline


def zero_launches():
    for c in all_kernels():
        c.launches = 0


def read_launches():
    return {c.__name__: c.launches for c in all_kernels()}


def p14_model(dtype, preset="flagship", moe=None, seed=0, k3=False):
    """(config, registry, model) of the flagship (or the submit preset),
    weights from ``seed``, on the card; ``k3``: the train step's
    augmentation through K3 (``data.fused_preprocess``, as ``fit``)."""
    import torch

    from fmc_uia_tpu_torch.config import Config
    from fmc_uia_tpu_torch.flagship import (
        flagship_config_dict,
        submit_config_dict,
    )
    from fmc_uia_tpu_torch.models import build_model
    from fmc_uia_tpu_torch.tasks import TaskRegistry

    d = (flagship_config_dict() if preset == "flagship"
         else submit_config_dict())
    if moe:
        d["model"]["moe"].update(moe)
    d["data"]["fused_preprocess"] = k3
    cfg = Config(config_dict=d)
    registry = TaskRegistry.from_config(cfg)
    model = build_model(cfg, registry, dtype=dtype, device="cuda",
                        generator=torch.Generator().manual_seed(seed))
    return cfg, registry, model


def leaf_gaps(got, ref):
    """{leaf: max |got - ref| / max |ref|} over {name: tensor} pairs (a
    leaf whose ``ref`` is all zero left out)."""
    out = {}
    for n, r in ref.items():
        top = float(r.float().abs().max())
        if top != 0.0:
            out[n] = float((got[n].float() - r.float()).abs().max()) / top
    return out


def worst_gap(gaps):
    """(the largest gap of a ``leaf_gaps`` map, its leaf)."""
    return max(((g, n) for n, g in gaps.items()), default=(0.0, None))


def over_own_noise(gaps, noise, floor):
    """The leaves of ``gaps`` past max(``floor``, twice the same leaf's
    gap in ``noise``): {leaf: (gap, bound)}."""
    bad = {}
    for n, g in gaps.items():
        bound = max(floor, 2 * noise.get(n, 0.0))
        if not g <= bound:
            bad[n] = (g, bound)
    return bad


@contextlib.contextmanager
def deterministic_algorithms():
    """cuDNN's and PyTorch's deterministic algorithms inside (warnings
    only: an op without one would warn, not raise), the previous settings
    restored on exit. The flagship's bf16 backward is then bitwise run to
    run on the card; without them its segmentation and detection steps
    are not (phase 14a before: first-step grads 1.57e-2 of a
    relative-position table's max apart between two plain runs)."""
    import torch

    cudnn = torch.backends.cudnn
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            cudnn.deterministic, cudnn.benchmark)
    fill = getattr(torch.utils, "deterministic", None)
    prev_fill = fill.fill_uninitialized_memory if fill else None
    torch.use_deterministic_algorithms(True, warn_only=True)
    cudnn.deterministic, cudnn.benchmark = True, False
    if fill:
        fill.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
        cudnn.deterministic, cudnn.benchmark = prev[2], prev[3]
        if fill:
            fill.fill_uninitialized_memory = prev_fill


def p14_nccl_one(report, smi):
    """(a): the flagship under ``parallel.mesh {data: -1}`` on an NCCL
    group of one rank, in this process, against the plain Trainer on the
    same batches, draws and seed, both under ``deterministic_algorithms``:
    the first step's loss and grads, then 3 rounds of 4 types through
    ``train_batch`` (timed, launches counted): every loss within 1e-5 of
    the plain one's and every leaf of the first grads and of the params
    after the rounds within 1e-5 of its max (bitwise expected: at one
    rank the mesh path runs the plain arithmetic; the log names the
    leaf that differs most)."""
    import tempfile

    import torch
    import torch.distributed as dist

    from fmc_uia_tpu_torch.parallel import make_mesh
    from fmc_uia_tpu_torch.train import Trainer

    store = tempfile.mktemp(prefix="chip_smoke_p14_store_")
    dist.init_process_group("nccl", store=dist.FileStore(store, 1), rank=0,
                            world_size=1)
    try:
        mesh = make_mesh(axes=("data",), shape=(1,), device_type="cuda")
        runs = {}
        for kind in ("plain", "mesh"):
            cfg, registry, model = p14_model(torch.bfloat16, k3=True)
            batches = train_batches(registry, TRAIN_BATCH, IMAGE, seed=7)
            with deterministic_algorithms():
                t = Trainer(cfg, model, registry, device="cuda", seed=0,
                            mesh=mesh if kind == "mesh" else None)
                logs0 = t.compute_grads(next(iter(batches.values())), 0)
                grads0 = {n: p.grad.detach().clone()
                          for n, p in model.named_parameters()}
                losses = []
                zero_launches()
                torch.cuda.synchronize()
                times = []
                for rnd in range(3):
                    t0 = time.perf_counter()
                    for b in batches.values():
                        losses.append(t.train_batch(b, 0)["total_loss"])
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
                launches = read_launches()
            runs[kind] = dict(
                loss0=float(logs0["total_loss"]), grads0=grads0,
                losses=[float(v) for v in losses],
                img_s=2 * len(batches) * TRAIN_BATCH / sum(times[1:]),
                launches=launches,
                params={n: p.detach().clone() for n, p in
                        t.model_state().items()})
            del t, model
            torch.cuda.empty_cache()
        steps = 3 * 4
        want = {"attention_branch": 24 * steps,
                "attention_branch_backward": 24 * steps,
                "mlp_branch": 4 * steps, "mlp_branch_backward": 4 * steps,
                "augment_normalize": steps}
        got = runs["mesh"]["launches"]
        if any(got[k] != v for k, v in want.items()):
            fail(f"[p14-a] launches {got} != {want}")
        P, M = runs["plain"], runs["mesh"]
        rel = [abs(x - y) / abs(y) for x, y in
               zip([M["loss0"]] + M["losses"], [P["loss0"]] + P["losses"])]
        g_gap = worst_gap(leaf_gaps(M["grads0"], P["grads0"]))
        p_gap = worst_gap(leaf_gaps(M["params"], P["params"]))
        out = dict(
            losses_bitwise=rel == [0.0] * len(rel), loss_gap=max(rel),
            grads0_bitwise=all(torch.equal(M["grads0"][n], v)
                               for n, v in P["grads0"].items()),
            grads0_gap=g_gap,
            params_bitwise=all(torch.equal(M["params"][n], v)
                               for n, v in P["params"].items()),
            params_gap=p_gap, launches=got,
            img_s={k: v["img_s"] for k, v in runs.items()})
        log(f"[p14-a] NCCL, 1 rank, flagship bf16 B={TRAIN_BATCH}, "
            f"deterministic algorithms, mesh vs plain: the first step and "
            f"3 rounds of 4 types: losses bitwise {out['losses_bitwise']} "
            f"(worst rel {out['loss_gap']:.2e}), first grads bitwise "
            f"{out['grads0_bitwise']} (worst {g_gap[0]:.2e} of the leaf "
            f"max, {g_gap[1]}), params after the rounds bitwise "
            f"{out['params_bitwise']} (worst {p_gap[0]:.2e}, {p_gap[1]}); "
            f"launches {got}; img/s (rounds 2-3, smoke timing) mesh "
            f"{out['img_s']['mesh']:.2f}, plain {out['img_s']['plain']:.2f}"
            f" (phase 5: {report.get('train', {}).get('img_s')}) | {smi}")
        if not (out["loss_gap"] <= 1e-5 and g_gap[0] <= 1e-5
                and p_gap[0] <= 1e-5):
            fail(f"[p14-a] mesh vs plain past 1e-5: losses "
                 f"{out['loss_gap']:.2e}, grads {g_gap}, params {p_gap}")
        return out
    finally:
        dist.destroy_process_group()
        if os.path.exists(store):
            os.remove(store)


def p14_group(rank, world):
    """(b)-(e) on one gloo group of 2 ranks sharing the card (a spawned
    process; the returned dict goes to the parent)."""
    import torch
    import torch.distributed as dist

    from fmc_uia_tpu_torch.parallel import comm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # a part that fails is recorded and the next one runs (every rank
    # fails at the same point: the checks follow the part's collectives)
    out, secs = {"errors": []}, {}
    state = {}
    for part, fn in (("b", p14_dp), ("c", p14_zero), ("d", p14_tp),
                     ("e", p14_ep)):
        t0 = time.perf_counter()
        try:
            fn(rank, out, state)
        except (Exception, SystemExit) as e:
            out["errors"].append(f"({part}) rank {rank}: {e}")
            log(f"[p14-{part}] rank {rank} FAILED: {e}")
        torch.cuda.empty_cache()
        secs[part] = time.perf_counter() - t0
        dist.barrier()
    out["seconds"] = secs
    out["gloo_host_ops"] = sorted(comm._NOTED)
    return out


def p14_dp(rank, out, state):
    """(b) DP f32: one step a type at B=4, the summed grads against one
    process's (kept in ``state`` for (d)); then bf16 at B=24 (12 a
    rank), 2 steps a type, launches counted."""
    import torch
    import torch.distributed as dist

    from fmc_uia_tpu_torch.parallel import make_mesh
    from fmc_uia_tpu_torch.train import Trainer

    dp = make_mesh(axes=("data",), shape=(2,))
    cfg, registry, model = p14_model(torch.float32)
    b4 = state["b4"] = train_batches(registry, P14_B32, IMAGE, seed=5)
    t = Trainer(cfg, model, registry, device="cuda", seed=0, mesh=dp)
    dp_grads = {}
    for ty, b in b4.items():
        t.compute_grads(b)
        g = t.whole_grads()
        if rank == 0:
            dp_grads[ty] = {n: v.detach().clone() for n, v in g.items()}
    if rank == 0:
        # one process, twice: the reference, and again with every weight
        # moved by 1e-7 of itself (seeded), which measures how far f32
        # rounding moves each leaf's grad; each leaf's bound is 1e-3 of
        # its max or twice its own move (a relative-position table's grad
        # cancels over windows and moves most)
        refs = []
        for rep_ in range(2):
            _, _, m1 = p14_model(torch.float32)
            if rep_:
                g = torch.Generator(device="cuda").manual_seed(11)
                with torch.no_grad():
                    for p in m1.parameters():
                        p.mul_(1 + 1e-7 * torch.randn(
                            p.shape, generator=g, device="cuda"))
            t1 = Trainer(cfg, m1, registry, device="cuda", seed=0)
            refs.append({})
            for ty, b in b4.items():
                t1.compute_grads(b)
                refs[-1][ty] = {n: p.grad.detach().clone()
                                for n, p in m1.named_parameters()}
            del t1, m1
        ref = state["ref"] = refs[0]
        noise = state["noise"] = {ty: leaf_gaps(refs[1][ty], ref[ty])
                                  for ty in ref}
        out["single_vs_single"] = {ty: worst_gap(v)
                                   for ty, v in noise.items()}
        gaps = {ty: leaf_gaps(dp_grads[ty], ref[ty]) for ty in ref}
        out["dp_f32_worst"] = {ty: worst_gap(v) for ty, v in gaps.items()}
        out["dp_f32_over"] = {ty: over_own_noise(v, noise[ty], 1e-3)
                              for ty, v in gaps.items()}
        del refs, dp_grads
    del t, model
    torch.cuda.empty_cache()
    dist.barrier()
    # bf16 at B=24 (12 a rank), 2 steps a type: launches counted
    cfg, registry, model = p14_model(torch.bfloat16, k3=True)
    b24 = train_batches(registry, TRAIN_BATCH, IMAGE, seed=6)
    t = Trainer(cfg, model, registry, device="cuda", seed=0, mesh=dp)
    zero_launches()
    torch.cuda.synchronize()
    t1_ = time.perf_counter()
    losses = []
    for _ in range(2):
        for b in b24.values():
            losses.append(float(t.train_batch(b, 0)["total_loss"]))
    torch.cuda.synchronize()
    out["dp_bf16"] = dict(losses=losses, launches=read_launches(),
                          s=time.perf_counter() - t1_)
    if not all(math.isfinite(v) for v in losses):
        fail(f"[p14-b] DP bf16 losses {losses}")
    bad = {ty: v for ty, v in out.get("dp_f32_over", {}).items() if v}
    if bad:
        fail(f"[p14-b] DP f32 leaves past their bound (gap, bound): {bad}")


def p14_zero(rank, out, state):
    """(c) ZeRO-1 against DP, 2 f32 AdamW steps on the same grads: each
    step's local grads come from the DP Trainer's backward and are copied
    into the ZeRO Trainer's, then each reduces (all-reduce; reduce-scatter
    of the sharded leaves), clips and updates (ZeRO: its slices, then an
    all-gather). The same grads on both sides, since the card's backward
    is not bitwise run to run (cuDNN, scatter-adds) and Adam turns a
    near-zero grad's noise into an O(lr) move."""
    import torch

    from fmc_uia_tpu_torch.parallel import make_mesh, zero_sharded_fraction
    from fmc_uia_tpu_torch.train import Trainer

    dp = make_mesh(axes=("data",), shape=(2,))
    tr = {}
    for kind in ("dp", "zero"):
        c, r_, m = p14_model(torch.float32)
        c.config.setdefault("parallel", {})["zero_optimizer"] = (
            kind == "zero")
        tr[kind] = Trainer(c, m, r_, device="cuda", seed=0, mesh=dp)
    b4 = state["b4"]
    for ty in ("segmentation", "classification"):
        tr["dp"]._backward(b4[ty])
        with torch.no_grad():
            for (_, pz), (_, pd) in zip(tr["zero"]._named, tr["dp"]._named):
                pz.grad.copy_(pd.grad)
        for t in tr.values():
            t._reduce_and_clip()
            t._optimizer_step()
    states = {k: t.model_state() for k, t in tr.items()}
    out["zero_sharded_fraction"] = zero_sharded_fraction(
        tr["zero"].optimizer)
    out["zero_leaves"] = len(tr["zero"].zero_dims)
    gap, leaf = worst_gap(leaf_gaps(states["zero"], states["dp"]))
    out["zero_bitwise"] = all(torch.equal(states["zero"][n], v)
                              for n, v in states["dp"].items())
    out["zero_vs_dp"] = (gap, leaf)
    del tr, states
    if not gap <= 1e-6:
        fail(f"[p14-c] ZeRO vs DP params: {leaf} {gap:.2e} > 1e-6")


def p14_tp(rank, out, state):
    """(d) TP {data: 1, model: 2} f32: grads against (b)'s one process;
    the sharded leaves and each rank's parameter bytes against
    ``make_param_specs``."""
    import torch

    from fmc_uia_tpu_torch.parallel import make_mesh, make_param_specs
    from fmc_uia_tpu_torch.train import Trainer

    b4, ref = state["b4"], state.get("ref", {})
    tp = make_mesh(axes=("data", "model"), shape=(1, 2))
    cfg, registry, model = p14_model(torch.float32)
    specs = make_param_specs(model, min_shard_dim=int(
        cfg.get("parallel.tp_min_dim", 256)))
    want_tp = {n: [d for d, a in enumerate(s) if a == "model"][0]
               for n, s in specs.items() if s}
    params = dict(model.named_parameters())
    want_tp = {n: d for n, d in want_tp.items()
               if params[n].shape[d] % 2 == 0}
    whole = sum(p.numel() * p.element_size() for p in params.values())
    held = whole - sum(params[n].numel() * params[n].element_size() // 2
                       for n in want_tp)
    t = Trainer(cfg, model, registry, device="cuda", seed=0, mesh=tp)
    if t.tp_dims != want_tp:
        fail(f"[p14-d] sharded leaves {len(t.tp_dims)} != make_param_specs'"
             f" {len(want_tp)}")
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    if nbytes != held:
        fail(f"[p14-d] rank {rank} holds {nbytes} parameter bytes, "
             f"{held} expected")
    worst, bad = {}, {}
    for ty, b in b4.items():
        t.compute_grads(b)
        g = t.whole_grads()
        if rank == 0:
            gaps = leaf_gaps(g, ref[ty])
            worst[ty] = worst_gap(gaps)
            bad[ty] = over_own_noise(gaps, state["noise"][ty], 1e-3)
    out["tp"] = dict(sharded_leaves=len(t.tp_dims), param_bytes=nbytes,
                     whole_bytes=whole, worst=worst)
    bad = {ty: v for ty, v in bad.items() if v}
    if bad:
        fail(f"[p14-d] TP leaves past their bound (gap, bound): {bad}")


def p14_ep(rank, out, state):
    """(e) EP: the submit preset with the ragged dispatch over {model: 2}
    at zero-drop capacity: the forward against the dense dispatch (phase
    9's bf16 rule), then one step and its all_to_all count."""
    import torch

    from fmc_uia_tpu_torch.parallel import activation_mesh_scope, comm
    from fmc_uia_tpu_torch.parallel import make_mesh
    from fmc_uia_tpu_torch.train import Trainer

    ep = make_mesh(axes=("model",), shape=(2,))
    moe = {"dispatch": "ragged", "capacity_factor": 4.0}
    cfg, registry, rag = p14_model(torch.bfloat16, "submit", moe)
    cfg.config["parallel"] = {"tensor_parallel": False}
    _, _, dense = p14_model(torch.bfloat16, "submit")
    rng = __import__("numpy").random.RandomState(3)
    from fmc_uia_tpu_torch.ops.image import normalize_images

    x = normalize_images(torch.from_numpy(rng.randint(
        0, 256, (SUBMIT_BATCH, SUBMIT_IMAGE, SUBMIT_IMAGE, 3)).astype(
            "uint8")), cfg.get("data.augmentation.normalize.mean"),
        cfg.get("data.augmentation.normalize.std"))
    errs = {}
    E = int(cfg.get("model.moe.num_experts"))
    for tid in ("T2A_fetal_abdomen", "T3A_breast_tumor", "T4A_fetal_brain",
                "T5_fetal_femur"):
        spec = registry[tid]
        with activation_mesh_scope(ep):
            _, errs[tid] = compare_models(rag, dense, x, spec, 0.1,
                                          f"[p14-e] ragged vs dense {tid}")
    del dense
    comm.all_to_all_dim0.calls = 0
    be = train_batches(registry, SUBMIT_BATCH, SUBMIT_IMAGE, seed=8)
    t = Trainer(cfg, rag, registry, device="cuda", seed=0, mesh=ep)
    logs = t.train_batch(be["segmentation"], 0)
    torch.cuda.synchronize()
    calls = comm.all_to_all_dim0.calls
    blocks = len(rag.moe_stages)
    if calls != 4 * blocks or not math.isfinite(float(logs["total_loss"])):
        fail(f"[p14-e] all_to_all calls {calls} != 4 x {blocks} blocks "
             f"(2 forward, 2 backward), loss {float(logs['total_loss'])}")
    out["ep"] = dict(experts=E, fwd_errs=errs, all_to_all_calls=calls,
                     loss=float(logs["total_loss"]))


def p14_pipe(rank, world):
    """(f): swin_b 512² stage 2 (9 pairs, C = 512, 32² grid) split 3 pairs
    a rank over 3 gloo ranks, M = 8 microbatches of 3, f32."""
    import numpy as np
    import torch

    from fmc_uia_tpu_torch.parallel import make_mesh, pipeline_swin_stage

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    mesh = make_mesh(axes=("pipe",), shape=(world,))
    _, _, model = p14_model(torch.float32)
    enc = model.encoder
    rng = np.random.RandomState(4)
    C = enc.embed_dim * 4
    G = IMAGE // 16
    x = torch.from_numpy(rng.standard_normal(
        (P14_PIPE_B, G, G, C)).astype(np.float32)).cuda().requires_grad_()
    cot = torch.from_numpy(rng.standard_normal(
        (P14_PIPE_B, G, G, C)).astype(np.float32)).cuda()
    zero_launches()
    y = pipeline_swin_stage(enc, 2, x, mesh, microbatches=P14_PIPE_M)
    torch.cuda.synchronize()
    fwd = read_launches()
    (y * cot).sum().backward()
    torch.cuda.synchronize()
    both = read_launches()
    out = {"launches_fwd": fwd, "launches": both,
           "dx_finite": bool(torch.isfinite(x.grad).all())}
    if rank == 0:
        with torch.no_grad():
            ref = x.detach()
            for b in range(enc.depths[2]):
                ref = getattr(enc, f"stage2_block{b}")(ref, False)
        top = float(ref.abs().max())
        err = float((y.detach() - ref).abs().max())
        out["fwd_err"], out["fwd_max"] = err, top
        if not err <= 1e-5 * top:
            fail(f"[p14-f] pipelined stage vs sequential: {err:.2e} > 1e-5 "
                 f"x {top:.2e}")
    if not out["dx_finite"]:
        fail("[p14-f] the pipeline's input grad is not finite")
    out["s"] = time.perf_counter() - t0
    return out


def phase14(name, smi, report):
    """The parallel modes (module docstring, phase 14). Returns the
    kernels' launches of its main-path runs: (a)'s mesh run, each rank's
    bf16 DP steps of (b), and each rank's pipelined stage of (f)."""
    import torch

    from fmc_uia_tpu_torch.parallel import comm, run_local

    t14 = time.perf_counter()
    rep = report["phase14"] = {}
    secs = {}
    errors = []  # every part runs; any failure fails the phase at its end
    t0 = time.perf_counter()
    try:
        rep["a"] = p14_nccl_one(report, smi)
    except (Exception, SystemExit) as e:
        errors.append(f"(a) {e}")
        log(f"[p14-a] FAILED {e}")
        rep["a"] = {"launches": read_launches()}
    secs["a"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    g = run_local(p14_group, 2, backend="gloo", device="cuda", threads=4,
                  timeout_s=P14_TIMEOUT_S)
    secs["b-e"] = time.perf_counter() - t0
    r0 = g[0]
    rep["group"] = {k: v for k, v in r0.items()}
    rep["group"]["dp_bf16_rank1"] = g[1].get("dp_bf16")
    for r in g:
        for e in r["errors"]:
            errors.append(e)
            log(f"[p14] FAILED {e}")

    def report_part(part, fn):
        """Log a part's numbers; a part that failed has none to log (its
        error is already in ``errors``)."""
        try:
            fn()
        except (KeyError, TypeError) as e:
            errors.append(f"({part}) no numbers to report: {e!r}")

    steps = 2 * 4
    per = {"attention_branch": 24 * steps,
           "attention_branch_backward": 24 * steps, "mlp_branch": 4 * steps,
           "mlp_branch_backward": 4 * steps, "augment_normalize": steps}

    def log_b():
        for rank, r in enumerate(g):
            got = r["dp_bf16"]["launches"]
            if any(got[k] != v for k, v in per.items()):
                errors.append(f"(b) rank {rank} bf16 launches {got} != "
                              f"{per}")
        log(f"[p14-b] DP, 2 gloo ranks on the card: f32 B={P14_B32} (2 a "
            f"rank) summed grads vs one process, worst leaf gap / max by "
            f"type { {k: (round(v[0], 8), v[1]) for k, v in r0['dp_f32_worst'].items()} }"
            f" (one process vs itself with its weights moved by 1e-7: "
            f"{ {k: (round(v[0], 8), v[1]) for k, v in r0['single_vs_single'].items()} })"
            f"; bf16 B={TRAIN_BATCH} (12 a rank) 2 steps a type: losses "
            f"{[round(v, 4) for v in r0['dp_bf16']['losses']]}, launches "
            f"per rank {[r['dp_bf16']['launches'] for r in g]} ({steps} "
            f"steps; {r0['dp_bf16']['s']:.1f} s, smoke timing) | {smi}")

    def log_c():
        log(f"[p14-c] ZeRO-1: params after 2 f32 steps on the same grads vs"
            f" DP: bitwise {r0['zero_bitwise']}, worst "
            f"{r0['zero_vs_dp'][0]:.2e} of the leaf max "
            f"({r0['zero_vs_dp'][1]}); {r0['zero_leaves']} leaves sharded, "
            f"zero_sharded_fraction {r0['zero_sharded_fraction']:.4f}")

    def log_d():
        log(f"[p14-d] TP {{data: 1, model: 2}} f32: "
            f"{r0['tp']['sharded_leaves']} sharded leaves "
            f"(make_param_specs'), parameter bytes per rank "
            f"{[r['tp']['param_bytes'] for r in g]} of "
            f"{r0['tp']['whole_bytes']}; grads vs one process, worst by type"
            f" { {k: (round(v[0], 8), v[1]) for k, v in r0['tp']['worst'].items()} }")

    def log_e():
        log(f"[p14-e] EP, submit preset (E = {r0['ep']['experts']}, top-2, "
            f"ragged, zero-drop capacity) on {{model: 2}}, B={SUBMIT_BATCH} "
            f"(32 a rank): forward vs dense, err by task "
            f"{r0['ep']['fwd_errs']}; one step: loss {r0['ep']['loss']:.4f},"
            f" all_to_all calls {r0['ep']['all_to_all_calls']} a rank; gloo"
            f" host copies {r0['gloo_host_ops']}; seconds {r0['seconds']}")

    for part, fn in (("b", log_b), ("c", log_c), ("d", log_d),
                     ("e", log_e)):
        report_part(part, fn)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    p = run_local(p14_pipe, 3, backend="gloo", device="cuda", threads=2,
                  timeout_s=P14_TIMEOUT_S)
    secs["f"] = time.perf_counter() - t0
    rep["pipe"] = p
    log(f"[p14-f] pipeline, 3 gloo ranks: swin_b stage 2 (18 blocks, 6 a "
        f"rank), B={P14_PIPE_B} as {P14_PIPE_M} microbatches: forward vs "
        f"sequential {p[0]['fwd_err']:.2e} of {p[0]['fwd_max']:.2e}; "
        f"launches per rank (forward; forward + backward) "
        f"{[(r['launches_fwd']['attention_branch'], r['launches']['attention_branch_backward']) for r in p]}"
        f"; {p[0]['s']:.1f} s | {smi}")
    for rank, r in enumerate(p):
        want = 6 * P14_PIPE_M
        if (r["launches"]["attention_branch"] != want
                or r["launches"]["attention_branch_backward"] != want):
            errors.append(f"(f) rank {rank} launches {r['launches']} != "
                          f"{want} K1f and K1b")
    rep["seconds"] = secs
    rep["total_s"] = time.perf_counter() - t14
    if errors:
        fail("; ".join(errors))
    launches = {c.__name__: {"a": rep["a"]["launches"][c.__name__],
                             "b_rank": [r["dp_bf16"]["launches"][
                                 c.__name__] for r in g],
                             "f_rank": [r["launches"][c.__name__]
                                        for r in p]}
                for c in all_kernels()}
    log(f"[phase14] {rep['total_s']:.1f} s ("
        + ", ".join(f"{k} {v:.1f}" for k, v in secs.items())
        + f"); the multi-rank times share one card: smoke timings, not a "
          f"parallel speed")
    del comm
    return launches


def phase14_main() -> int:
    """``--phase14``: the kernels' build and phase 14 alone."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from fmc_uia_tpu_torch.ops import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build()
    report = {}
    smi = nvidia_smi_line()
    launches = phase14(torch.cuda.get_device_name(0), smi, report)
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke_phase14.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)
    print(json.dumps({"phase14_s": report["phase14"]["total_s"],
                      "launches": launches, "card": smi}))
    return 0


# ---------------------------------------------------------------------------
# phase 15: the fused Swin MLP above C = 256 (FMC_FUSED_MLP_MAX_C)
# ---------------------------------------------------------------------------
P15_KNOB = "FMC_FUSED_MLP_MAX_C"
# (label, C, grid, K2f's B, K2b's B) of 15a: at 512², swin_b's stage 2
# (the flagship's) and swin_t's stages 2 and 3, timed; then untimed,
# 147 tokens (the last 128-token tile holds 19; dp changes inside the
# first tile) at both other widths and at 640, 960 and 288, widths no
# Swin variant has that the run-time-C kernels take (288: the last
# 64-deep k-chunk half zeros)
P15_CASES = (("c512_swin_b_s2", 512, 32, BATCH, TRAIN_BATCH),
             ("c384_swin_t_s2", 384, 32, BATCH, TRAIN_BATCH),
             ("c768_swin_t_s3", 768, 16, BATCH, TRAIN_BATCH),
             ("c384_ragged", 384, 7, 3, 3), ("c768_ragged", 768, 7, 3, 3),
             ("c640_ragged", 640, 7, 3, 3), ("c960_ragged", 960, 7, 3, 3),
             ("c288_ragged", 288, 7, 3, 3))
P15_ROUNDS = 2       # timed round-robin rounds of 15b, each knob


@contextlib.contextmanager
def fused_mlp_knob(value):
    """``FMC_FUSED_MLP_MAX_C`` = ``value`` inside (``build_swin`` reads it
    when a model is built), the previous value restored on exit."""
    old = os.environ.get(P15_KNOB)
    os.environ[P15_KNOB] = str(value)
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(P15_KNOB, None)
        else:
            os.environ[P15_KNOB] = old


def p15_per_step(knob, train=True):
    """Every kernel's launches a flagship forward (``train`` False) or a
    train step with K3 on under the knob: K1f 24 (K1b 24), K2f (K2b) 4
    at 256, 22 at 512 and above (stages 0-2; stage 3, C = 1024, runs the
    JAX XLA branch's math under 1024)."""
    from fmc_uia_tpu_torch.ops import preprocess as pp
    from fmc_uia_tpu_torch.ops import swin_block as sb

    k2 = 4 if knob < 512 else 22
    out = {sb.attention_branch.__name__: 24, sb.mlp_branch.__name__: k2}
    if train:
        out.update({sb.attention_branch_backward.__name__: 24,
                    sb.mlp_branch_backward.__name__: k2,
                    pp.augment_normalize.__name__: 1})
    return out


def kernel_key(name: str) -> str:
    """A profiler kernel name, demangled ("void ns::fn<args>(params)") or
    mangled ("_ZN2ns2fnI...E..."), without namespaces, parameters and
    template arguments; gemm_sm90 keeps its epilogue, which tells K2f's
    two products and K2b's dxn from the split-K weight products."""
    if name.startswith("_Z"):
        i, parts = (3 if name.startswith("_ZN") else 2), []
        while i < len(name) and name[i].isdigit():
            j = i
            while name[j].isdigit():
                j += 1
            n = int(name[i:j])
            parts.append(name[j:j + n])
            i = j + n
        key = parts[-1] if parts else name
        m = re.search(r"(\d+)Epi", name[i:])
        if key == "gemm_sm90" and m:
            start = i + m.start() + len(m.group(1))
            key += f"[{name[start:start + int(m.group(1))]}]"
        return key
    base = name.split("(")[0]
    if base.startswith("void "):
        base = base[5:]
    head, _, targs = base.partition("<")
    key = head.split("::")[-1].strip()
    if key == "gemm_sm90":
        args = [t.strip() for t in targs.rstrip(">").split(",")]
        if len(args) > 2:
            key += f"[{args[2].split('::')[-1]}]"
    return key


def kernel_split(fn, calls: int = 3):
    """The device ms a call of each kernel that ``fn`` launches, by
    ``kernel_key``, from a torch.profiler trace of ``calls`` calls after a
    warm-up: {key: {"ms": ms a call, "n": launches a call}}, largest
    first. A trace that holds no kernel's device time is taken again (a
    short one came back empty, once in a whole run after phase 14's
    process groups and once alone); after three such traces the split
    is not measured: {} (it is information, not a check)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            # kernels only (as profile_train_round): not the ops around
            # them, whose self device time counts their kernels again
            us = float(getattr(e, "self_device_time_total", 0.0)
                       or getattr(e, "self_cuda_time_total", 0.0))
            if us <= 0 or not str(getattr(e, "device_type", "")).endswith(
                    "CUDA"):
                continue
            d = out.setdefault(kernel_key(e.key), {"ms": 0.0, "n": 0.0})
            d["ms"] += us / 1e3 / calls
            d["n"] += e.count / calls
        if out:
            return dict(sorted(out.items(), key=lambda kv: -kv[1]["ms"]))
    return {}


def split_text(split) -> str:
    if not split:
        return "; kernels: not measured (three traces held no kernel)"
    total = sum(v["ms"] for v in split.values())
    return (f"; kernels {total:.3f} ms: " + ", ".join(
        f"{k} {v['ms']:.4f}" + (f" ({v['n']:g}x)" if v["n"] != 1 else "")
        for k, v in split.items()))


def p15_kernels(smi, cases=P15_CASES):
    """15a: K2f and K2b at the wide widths against their plain versions,
    f32 and bf16, dp on (phases 2 and 2b's rules), and their times, with
    each bf16 kernel's device time a call by name (``kernel_split``).
    A width this tree's kernels refuse is skipped with a line: here the
    f32 forward beyond its shared memory (C = 960; ``MLP_F32_MAX_C``),
    and in another tree, with ``--k2-wide`` copied into it, whatever it
    refuses (the CPU tests hold every bf16 case's width to this tree's
    ``mlp_kernel_dims``). ``cases``: a subset of P15_CASES."""
    import torch

    from fmc_uia_tpu_torch.ops import build
    from fmc_uia_tpu_torch.ops import swin_block as sb

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(15)
    fwd_plan = getattr(sb, "mlp_fwd_plan", None)  # K2f's mirror
    recs = []

    def timed(rec, fn, ref_fn, chain, flops, nbytes, dtype, reps):
        if "ragged" in rec["case"]:  # checked only
            return ""
        peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32
        rec["ms"] = cuda_ms(fn, reps=reps, warmup=2)
        rec["plain_ms"] = cuda_ms(ref_fn, reps=3, warmup=1)
        rec["chain_ms"] = chain()
        rec["bound_ms"] = 1e3 * max(flops / peak, nbytes / HBM_BPS)
        rec["bound_by"] = ("operations" if flops / peak >= nbytes / HBM_BPS
                           else "bytes")
        out = (f"  {rec['ms']:.3f} ms (plain {rec['plain_ms']:.3f}, chain "
               f"{rec['chain_ms']:.3f}, bound {rec['bound_ms']:.4f} "
               f"{rec['bound_by']})")
        if dtype == torch.bfloat16:
            # per call of BURST_CALLS back-to-back calls (the host's launch
            # gaps hidden where the card is the slower), and each kernel's
            # own device time a call
            rec["ms_10"] = cuda_ms(fn, reps=5, warmup=1, calls=BURST_CALLS)
            rec["split"] = kernel_split(fn)
            if rec["split"]:
                rec["device_ms"] = sum(v["ms"]
                                       for v in rec["split"].values())
            out += (f", {rec['ms_10']:.3f} ms of {BURST_CALLS}"
                    + split_text(rec["split"]))
        return out

    for label, C, grid, bf, bb in cases:
        Ch = 4 * C
        for dtype in (torch.float32, torch.bfloat16):
            dt = str(dtype).split(".")[-1]
            try:
                sb.mlp_kernel_dims(C, Ch, dtype)
            except ValueError as e:
                log(f"[p15-a] {label} {dt}: skipped, this tree's kernels "
                    f"refuse it ({e})")
                continue
            x, w, dp = mlp_inputs(bf, grid, C, dtype, gen, dev)
            args = tuple(w[k] for k in ("ln_scale", "ln_bias", "w1", "b1",
                                        "w2", "b2"))
            chk = check_branch(sb.mlp_branch(x, *args, dp=dp),
                               sb.mlp_branch_reference(x, *args, dp=dp), x,
                               dtype, f"[p15-a] K2f {label}")
            T, esz = x.numel() // C, x.element_size()
            rec = dict(kernel="mlp_branch", case=label, dtype=dt,
                       shape=[bf, grid, grid, C], **chk)
            if dtype == torch.bfloat16 and fwd_plan is not None:
                got_ws = build.load("swin_mlp_fwd", "swin_mlp_fwd_workspace")(
                    T, C, Ch, 1)
                if got_ws != fwd_plan(T, C, Ch)["workspace"]:
                    fail(f"[p15-a] K2f {label}: workspace {got_ws} bytes != "
                         f"the plan's {fwd_plan(T, C, Ch)['workspace']}")
                rec["workspace"] = got_ws
            fn, params = k2_chain(x, w, dp)
            times = timed(rec, lambda: sb.mlp_branch(x, *args, dp=dp),
                          lambda: sb.mlp_branch_reference(x, *args, dp=dp),
                          lambda: cuda_ms(lambda: fn(x, *params)),
                          16 * T * C * C,
                          2 * T * C * esz + 4 * (8 * C * C + 7 * C), dtype,
                          20)
            recs.append(rec)
            log(f"[p15-a] K2f {label:15s} {dt:8s} {rec['shape']} "
                + err_text(chk) + times)
            del x, w, dp, args, fn, params
            x, w, dp = mlp_inputs(bb, grid, C, dtype, gen, dev)
            dy = torch.randn(x.shape, generator=gen).to(dev, dtype)
            args = tuple(w[k] for k in ("ln_scale", "ln_bias", "w1", "b1",
                                        "w2", "b2"))
            T = x.numel() // C
            got = sb.mlp_branch_backward(x, *args, dy, dp=dp)
            ref = sb.mlp_branch_backward_reference(x, *args, dy, dp=dp)
            chk = check_branch(got[0], ref[0], dy, dtype,
                               f"[p15-a] K2b {label} dx")
            grads = check_grads(MLP_GRADS, got[1:], ref[1:], dtype,
                                f"[p15-a] K2b {label}")
            del got, ref
            rec = dict(kernel="mlp_branch_backward", case=label, dtype=dt,
                       shape=[bb, grid, grid, C], grads=grads,
                       **chk)
            if dtype == torch.bfloat16:
                plan = sb.mlp_bwd_plan(T, C, Ch)
                got_ws = build.load("swin_mlp_bwd", "swin_mlp_bwd_workspace")(
                    T, C, Ch, 1, plan["kchunk_w1"], plan["kchunk_w2"])
                if got_ws != plan["workspace"]:
                    fail(f"[p15-a] K2b {label}: workspace {got_ws} bytes != "
                         f"the plan's {plan['workspace']}")
                rec["workspace"] = got_ws
                rec["floor_ms"] = 1e3 * k2b_pass_bytes(T, C, Ch,
                                                       plan) / HBM_BPS
            times = timed(
                rec, lambda: sb.mlp_branch_backward(x, *args, dy, dp=dp),
                lambda: sb.mlp_branch_backward_reference(x, *args, dy,
                                                         dp=dp),
                lambda: chain_bwd_ms(*k2_chain(x, w, dp), x, dy)[0],
                40 * T * C * C,
                3 * T * C * esz + 2 * 4 * (8 * C * C + 7 * C), dtype, 10)
            worst = max(v[0] / max(v[1], 1e-30) for v in grads.values())
            recs.append(rec)
            log(f"[p15-a] K2b {label:15s} {dt:8s} {rec['shape']} dx "
                + err_text(chk) + f"; grads worst err/tol {worst:.3f}"
                + times)
            del x, w, dp, dy, args
            torch.cuda.empty_cache()
    log(f"[p15-a] {len(recs)} cases | {smi}")
    return recs


def p15_knobs(tag, cfg, registry, totals):
    """15b's serving and 15c's forward: the flagship under the knob at
    512 through ``preset_serving`` (phase 13a's checks), then the same
    weights under 256 and 1024: each stage's (kernel, XLA-branch math)
    flags, the raw outputs against 512's within 0.1 of the largest, and
    one counted ``Predictor`` forward under 1024. Returns (the model
    under 1024, report)."""
    import numpy as np
    import torch

    from fmc_uia_tpu_torch.export import Predictor
    from fmc_uia_tpu_torch.flagship import SERVING_TASKS
    from fmc_uia_tpu_torch.models import build_model
    from fmc_uia_tpu_torch.ops.image import normalize_images

    per = p15_per_step(512, train=False)
    with fused_mlp_knob(512):
        model, rep = preset_serving(f"{tag} (b)", cfg, registry, totals,
                                    per_fwd=per, cpu_image=GRAD_IMAGE)
    models = {512: model}
    for knob in (256, 1024):
        with fused_mlp_knob(knob):
            models[knob] = build_model(cfg, registry, dtype=torch.bfloat16,
                                       device="cuda", init=False)
        models[knob].load_state_dict(model.state_dict())
    flags = {k: [(b.fused_mlp, b.mlp_math) for b in (
        getattr(m.encoder, f"stage{s}_block0") for s in range(4))]
             for k, m in models.items()}
    want = {512: [(True, False)] * 3 + [(False, False)],
            256: [(True, False)] * 2 + [(False, False)] * 2,
            1024: [(True, False)] * 3 + [(False, True)]}
    if flags != want:
        fail(f"{tag} stage flags (kernel, XLA-branch math) {flags} != "
             f"{want}")
    mean = cfg.get("data.augmentation.normalize.mean")
    std = cfg.get("data.augmentation.normalize.std")
    imgs = np.random.RandomState(15).randint(
        0, 256, (BATCH, IMAGE, IMAGE, 3)).astype(np.uint8)
    x_pre = normalize_images(torch.from_numpy(imgs), mean, std)
    for tid in SERVING_TASKS:
        spec = registry[tid]
        e = rep["compare"][tid]
        _, e["knob256_err"] = compare_models(model, models[256], x_pre, spec,
                                             0.1, f"{tag} knob 512 vs 256")
        _, e["knob1024_err"] = compare_models(
            models[1024], model, x_pre, spec, 0.1, f"{tag} knob 1024 vs 512")
        log(f"{tag} (b)   {tid:20s} knob 512 vs 256 {e['knob256_err']}, "
            f"1024 vs 512 {e['knob1024_err']}")
    pred = Predictor(models[1024], registry, mean, std, IMAGE,
                     device="cuda")
    tid = SERVING_TASKS[0]
    pred.predict_images(imgs, tid)  # first use
    torch.cuda.synchronize()
    zero_launches()
    pred.predict_images(imgs, tid)
    launches = read_launches()
    if launches != {k: per.get(k, 0) for k in launches}:
        fail(f"{tag} (c) Predictor launches {launches} != {per}")
    for k, v in launches.items():
        totals[k] += v
    rep["flags"] = {str(k): v for k, v in flags.items()}
    rep["knob1024_launches"] = launches
    model1024 = models.pop(1024)
    del pred, model, models
    torch.cuda.empty_cache()
    return model1024, rep


def p15_staged_log(tag, knob, st, smi):
    log(f"{tag} knob {knob} staged B={TRAIN_BATCH}: {st['steps']} steps "
        f"after a warm-up round ({st['warmup_round_s']:.1f} s); ms a step "
        f"by type (median, synced) "
        f"{ {k: round(v, 1) for k, v in st['ms_by_type'].items()} } = "
        f"{st['img_s']:.2f} img/s; peak {st['peak_gib']:.2f} GiB; launches "
        f"{st['launches']} | {smi}")


def phase15(name, smi, report):
    """The fused MLP above C = 256 (module docstring, phase 15). Returns
    each kernel's launches over the phase's main-path runs: 15b's
    Predictor forwards and timed rounds (both knobs) and 15c's forward
    and round (not 15a's kernel checks, 15b's warm-up rounds and
    comparisons, or 15d's grad check)."""
    import torch

    from fmc_uia_tpu_torch.config import Config
    from fmc_uia_tpu_torch.flagship import flagship_config_dict
    from fmc_uia_tpu_torch.models import build_model
    from fmc_uia_tpu_torch.tasks import TaskRegistry

    t15 = time.perf_counter()
    totals = {c.__name__: 0 for c in all_kernels()}
    seconds, r = {}, {}
    t0 = time.perf_counter()
    r["kernels"] = p15_kernels(smi)
    seconds["a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    d = flagship_config_dict()
    d["data"]["fused_preprocess"] = True  # K3 in the train step
    cfg = Config(config_dict=d)
    registry = TaskRegistry.from_config(cfg)
    model, r["serving"] = p15_knobs("[p15-b]", cfg, registry, totals)
    r["knob1024_round"] = st = staged_rounds(
        "[p15-c]", cfg, registry, model, p15_per_step(1024), totals,
        rounds=1)
    p15_staged_log("[p15-c]", 1024, st, smi)
    del model
    torch.cuda.empty_cache()
    r["staged"] = {}
    for knob in (512, 256):
        with fused_mlp_knob(knob):
            model = build_model(cfg, registry, dtype=torch.bfloat16,
                                device="cuda",
                                generator=torch.Generator().manual_seed(15))
        r["staged"][knob] = st = staged_rounds(
            "[p15-b]", cfg, registry, model, p15_per_step(knob), totals,
            rounds=P15_ROUNDS)
        p15_staged_log("[p15-b]", knob, st, smi)
        del model
        torch.cuda.empty_cache()
    seconds["b_c"] = time.perf_counter() - t0
    # 15d: the f32 grad check of the seg step, card vs CPU, under 512
    t0 = time.perf_counter()
    preset = dict(key="p15_grads", config=flagship_config_dict,
                  grad_types=("segmentation",))
    report["p15_grads"] = {}
    zero_launches()
    with fused_mlp_knob(512):
        check_train_grads(report, preset)
    got = read_launches()
    per = {k: v for k, v in p15_per_step(512).items()
           if "augment" not in k}
    if got != {k: per.get(k, 0) for k in got}:
        fail(f"[p15-d] card launches {got} != one step's {per}")
    r["grads"] = report.pop("p15_grads")["grads_card_vs_cpu"]
    seconds["d"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    st = r["staged"]
    r["staged_ratio"] = st[512]["img_s"] / st[256]["img_s"]
    log(f"[p15-b] staged img/s under 512 over 256 (this run): "
        f"{st[512]['img_s']:.2f} / {st[256]['img_s']:.2f} = "
        f"{r['staged_ratio']:.3f}x; peak {st[512]['peak_gib']:.2f} / "
        f"{st[256]['peak_gib']:.2f} GiB | {smi}")
    r.update(seconds=seconds, launches=totals,
             total_s=time.perf_counter() - t15)
    report["phase15"] = r
    log(f"[phase15] {r['total_s']:.1f} s ("
        + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items())
        + f"); staged img/s knob 512 {st[512]['img_s']:.2f} (peak "
        f"{st[512]['peak_gib']:.2f} GiB), knob 256 {st[256]['img_s']:.2f} "
        f"(peak {st[256]['peak_gib']:.2f} GiB), smoke timings; launches over"
        f" its main-path runs: {totals} | {name} | {smi}")
    return totals


def phase15_main() -> int:
    """``--phase15``: the kernels' build and phase 15 alone."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from fmc_uia_tpu_torch.ops import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    spent = build.build()
    log(f"[build] {time.perf_counter() - t0:.1f} s wall; per library "
        f"{ {k: round(v, 1) for k, v in spent.items()} }")
    for k in ("swin_mlp_fwd", "swin_mlp_bwd"):
        for line in build.ptxas_report(k).splitlines():
            if any(w in line for w in ("registers", "spill", "C7512",
                                       "C7515", "Compiling entry")):
                log(f"  ptxas {k}: {line.strip()}")
    check_k2_spills(build)
    report = {"sass": check_sass(build)}
    smi = nvidia_smi_line()
    launches = phase15(torch.cuda.get_device_name(0), smi, report)
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke_phase15.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)
    print(json.dumps({"phase15_s": report["phase15"]["total_s"],
                      "launches": launches, "card": smi}))
    return 0


def k2_wide_main() -> int:
    """``--k2-wide``: the K2 libraries' build and phase 15a's timed cases
    alone (checked, then timed; the ragged ones are phase 15's), one JSON
    line of their bf16 times and splits. Copied into the root of another
    tree of the port it checks and times that tree's K2 the same way, so
    two trees compare within one call."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from fmc_uia_tpu_torch.ops import build

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    spent = build.build(["swin_mlp_fwd", "swin_mlp_bwd"])
    log(f"[build] {time.perf_counter() - t0:.1f} s wall; per library "
        f"{ {k: round(v, 1) for k, v in spent.items()} }")
    smi = nvidia_smi_line()
    recs = p15_kernels(smi, [c for c in P15_CASES if "ragged" not in c[0]])
    keys = ("kernel", "case", "ms", "ms_10", "device_ms", "plain_ms",
            "chain_ms", "bound_ms", "floor_ms", "split")
    print(json.dumps({"k2_wide": [{k: r[k] for k in keys if k in r}
                                  for r in recs if r["dtype"] == "bfloat16"
                                  and "ms" in r],
                      "card": smi}))
    return 0


def kinks_main() -> int:
    """``--kinks``: what each kind of kink explains in the SPM preset's
    grad check (phase 10c): the check's pair and batches, the card's step
    once a type, and the CPU's step four ways, taking from the card no
    kink, the ReLU signs, the bilinear cells, or both; logs each way's
    worst leaf err / leaf max and prints one JSON line of them."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card, cpu, tc, tp, batches = grad_pair(spm_preset())
    out = {}
    for t, b in batches.items():
        with KinkAlign(card) as at_c:
            tc.compute_grads(b)
        for take in ((), ("relu",), ("coords",), ("relu", "coords")):
            with KinkAlign(cpu, at=at_c, take=take) as at_p:
                tp.compute_grads(b)
            rel, leaf = max(
                (float((pc.grad.cpu() - pp.grad).abs().max())
                 / float(pp.grad.abs().max()), n)
                for (n, pc), (_, pp) in zip(card.named_parameters(),
                                            cpu.named_parameters())
                if float(pp.grad.abs().max()) > 0)
            split = {k: v[1] for k, v in at_p.compare().items()}
            out.setdefault(t, {})["+".join(take) or "none"] = dict(
                worst_err_over_max=rel, worst_leaf=leaf, split=split,
                relu_split_by_site=at_p.relu_flips())
            log(f"[kinks] {t}, taking {take or 'none'} from the card: worst "
                f"{rel:.2e} ({leaf}); split {split}")
    print(json.dumps({"card": nvidia_smi_line(), "kinks": out}))
    return 0


def staged_train_main() -> int:
    """``--staged-train``: phase 5's timed part on the flagship alone,
    for this script's tree; one JSON line of its numbers."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from fmc_uia_tpu_torch.ops import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build()
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    report = {}
    smi = nvidia_smi_line()
    train_phase(torch.cuda.get_device_name(0), smi, report, out_dir,
                swin_preset(), full=False)
    r = report["train"]
    print(json.dumps({"tree": HERE, "img_s": r["img_s"], "steps": r["steps"],
                      "wall_ms_per_step": 1e3 * r["wall_s"] / r["steps"],
                      "ms_per_step_by_type": r["ms_per_step_by_type"],
                      "enqueue_ms_idle_gpu": r["enqueue_ms_idle_gpu"],
                      "device_ms_per_round":
                          r["profile"]["device_ms_per_round"],
                      "share": r["profile"]["share"],
                      "peak_bytes": r["peak_bytes"], "card": smi}))
    return 0


def main() -> int:
    import numpy as np
    import torch

    if sys.argv[1:] == ["--staged-train"]:
        return staged_train_main()
    if sys.argv[1:] == ["--k3"]:
        return k3_main()
    if sys.argv[1:] == ["--kinks"]:
        return kinks_main()
    if sys.argv[1:] == ["--phase11"]:
        return phase11_main()
    if sys.argv[1:] == ["--phase12"]:
        return phase12_main()
    if sys.argv[1:] == ["--phase13"]:
        return phase13_main()
    if sys.argv[1:] == ["--phase14"]:
        return phase14_main()
    if sys.argv[1:] == ["--phase15"]:
        return phase15_main()
    if sys.argv[1:] == ["--k2-wide"]:
        return k2_wide_main()
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA GPU; nothing to drive",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "fmc_uia_tpu_torch")):
        print("chip_smoke: fmc_uia_tpu_torch/ not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from fmc_uia_tpu_torch.config import Config
    from fmc_uia_tpu_torch.export import Predictor
    from fmc_uia_tpu_torch.flagship import SERVING_TASKS, flagship_config_dict
    from fmc_uia_tpu_torch.models import build_model
    from fmc_uia_tpu_torch.ops import build
    from fmc_uia_tpu_torch.ops import swin_block as sb
    from fmc_uia_tpu_torch.ops.image import normalize_images
    from fmc_uia_tpu_torch.serving import StreamingPredictor
    from fmc_uia_tpu_torch.tasks import TaskRegistry

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    report = {"device": name, "nvidia_smi": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda}

    # -- 1. env + build ------------------------------------------------------
    log(f"[env] {name} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    spent = build.build()
    report["build_s"] = time.perf_counter() - t0
    log(f"[build] {report['build_s']:.1f} s wall; per library "
        f"{ {k: round(v, 1) for k, v in spent.items()} }")
    for k in build.KERNELS:
        for line in build.ptxas_report(k).splitlines():
            # K1's reports name their kernels: which one a count belongs to
            if any(w in line for w in ("registers", "spill", "C7512",
                                       "C7515")) or (
                    (k in PRODUCTS or k == "preprocess_fwd")
                    and "Compiling entry" in line):
                log(f"  ptxas {k}: {line.strip()}")
    check_k2_spills(build)
    report["sass"] = check_sass(build)

    # -- 2. kernels ------------------------------------------------------------
    records = []
    log("[kernels] kernel vs plain version on the card")
    summary = check_kernels(dev, records)
    log(f"[kernels-bwd] backward kernel vs plain version on the card, "
        f"train shapes B={TRAIN_BATCH}")
    summary.update(check_bwd_kernels(dev, records))
    log(f"[kernels-pre] K3 vs plain version on the card, B={TRAIN_BATCH} "
        f"{IMAGE}²")
    fcfg = flagship_config_dict()["data"]["augmentation"]["normalize"]
    k3 = check_k3(dev, records, fcfg["mean"], fcfg["std"])
    log(f"[kernels-k4] K4f/K4b vs plain versions on the card, {K4_HEADS} "
        f"heads x {K4_DH}, N = {K4_N}")
    k4 = check_k4(dev, records)
    report["kernel_cases"] = records

    # -- 3. model --------------------------------------------------------------
    cfg = Config(config_dict=flagship_config_dict())
    registry = TaskRegistry.from_config(cfg)
    mean = cfg.get("data.augmentation.normalize.mean")
    std = cfg.get("data.augmentation.normalize.std")
    t0 = time.perf_counter()
    model = build_model(cfg, registry, dtype=torch.bfloat16, device="cuda",
                        generator=torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[model] flagship swin_b {IMAGE}² 27 tasks, {n_params / 1e6:.1f} M "
        f"params, built in {time.perf_counter() - t0:.1f} s")
    pred = Predictor(model, registry, mean, std, IMAGE, device="cuda")
    rng = np.random.RandomState(0)
    imgs = rng.randint(0, 256, (BATCH, IMAGE, IMAGE, 3)).astype(np.uint8)
    for tid in SERVING_TASKS:  # first use: allocator, cuDNN heuristics
        pred.predict_images(imgs, tid)
    torch.cuda.synchronize()
    sb.attention_branch.launches = 0
    sb.mlp_branch.launches = 0
    outs = {}
    t0 = time.perf_counter()
    for tid in SERVING_TASKS:
        outs[tid] = pred.predict_images(imgs, tid)
    fwd_s = (time.perf_counter() - t0) / len(SERVING_TASKS)
    n = len(SERVING_TASKS)
    got = (sb.attention_branch.launches, sb.mlp_branch.launches)
    log(f"[model] {n} Predictor forwards at B={BATCH}: launches "
        f"attention_branch {got[0]}, mlp_branch {got[1]}; "
        f"{1e3 * fwd_s:.1f} ms per forward (host clock, synced)")
    if got != (24 * n, 4 * n):
        fail(f"launch counters {got} != {(24 * n, 4 * n)}")
    report["model"] = {"params_M": n_params / 1e6, "fwd_ms_b8":
                       1e3 * fwd_s, "launches": got}
    # same weights in f32 on the card, and in f32 on the CPU for one image
    model32 = build_model(cfg, registry, dtype=torch.float32, device="cuda")
    model32.load_state_dict(model.state_dict())
    x_pre = normalize_images(torch.from_numpy(imgs), mean, std)
    model_cpu = build_model(cfg, registry, dtype=torch.float32,
                            device="cpu")
    model_cpu.load_state_dict(model.state_dict())
    cmp = {}
    for tid in SERVING_TASKS:
        spec = registry[tid]
        ncls = spec.num_classes
        # bf16 vs f32 on the card, B = 8: the raw outputs within 10% of the
        # largest magnitude (bf16 keeps 8 bits through ~30 layers), the
        # decoded outputs equal except at near ties of the f32 reference
        ref, err = compare_models(model, model32, x_pre, spec, 0.1,
                                  "bf16 vs f32")
        # f32 on the card vs f32 on the CPU, B = 1: within 1e-3 of the
        # largest magnitude (kernel sums in another order, cuDNN vs CPU
        # convolutions, TF32 off)
        ref1, err1 = compare_models(model32, model_cpu, x_pre[:1], spec,
                                    1e-3, "f32 card vs f32 cpu")
        p = torch.from_numpy(outs[tid])
        if spec.task_name in ("segmentation", "classification"):
            bad, near = near_tie_ok(p, ref, err, ncls)
            entry = {"bf16_vs_f32_err": err, "disagree": bad,
                     "near_ties": near}
        elif spec.task_name == "detection":
            entry = {"bf16_vs_f32_err": err}
        else:
            d = float((p - ref).abs().max())
            entry = {"bf16_vs_f32_err": err, "decoded_err": d}
        entry["f32_card_vs_cpu_err"] = err1
        cmp[tid] = entry
        log(f"  {tid:20s} {entry}")
    report["model"]["compare"] = cmp
    del model32, model_cpu
    torch.cuda.empty_cache()
    profile_forward(pred, imgs, SERVING_TASKS[0], out_dir, report)
    # -- 4. serving ------------------------------------------------------------
    svc = StreamingPredictor(model, registry, mean, std, IMAGE,
                             max_batch=BATCH, max_delay_ms=5.0,
                             device="cuda")
    t0 = time.perf_counter()
    svc.warmup(task_ids=list(SERVING_TASKS))
    log(f"[serving] warmup of chain {svc._chain} x 4 types: "
        f"{time.perf_counter() - t0:.1f} s")
    # a pool of 64 request images; image j always goes with task j % 4, so
    # every result has one Predictor reference (batches of 8 per task)
    pool = rng.randint(0, 256, (OUTSTANDING, IMAGE, IMAGE, 3)).astype(
        np.uint8)
    tids = [SERVING_TASKS[j % 4] for j in range(OUTSTANDING)]
    refs = [None] * OUTSTANDING
    for tid in SERVING_TASKS:
        idx = [j for j in range(OUTSTANDING) if tids[j] == tid]
        for k in range(0, len(idx), BATCH):
            out = pred.predict_images(pool[idx[k:k + BATCH]], tid)
            for j, res in zip(idx[k:k + BATCH], out):
                refs[j] = res
    torch.cuda.synchronize()
    sb.attention_branch.launches = 0
    sb.mlp_branch.launches = 0
    runs, dispatches, served = [], 0, []
    for r in range(SERVE_RUNS):
        before = dict(svc.stats, by_size=dict(svc.stats["by_size"]))
        n_done, wall, lat, results = serve_closed_loop(svc, pool, tids)
        stats = {k: svc.stats[k] - before[k]
                 for k in ("dispatches", "pad_images")}
        stats["by_size"] = {k: v - before["by_size"].get(k, 0)
                            for k, v in svc.stats["by_size"].items()}
        dispatches += stats["dispatches"]
        served.append(results)
        ms = [v for _, v in lat]
        by_task = {tid: [round(float(np.percentile(
            [v for t, v in lat if t == tid], q)), 1) for q in (50, 99)]
            for tid in SERVING_TASKS}
        run = {"requests": n_done, "wall_s": wall, "img_s": n_done / wall,
               "p50_ms": float(np.percentile(ms, 50)),
               "p99_ms": float(np.percentile(ms, 99)),
               "p50_p99_ms_by_task": by_task, "stats": stats}
        runs.append(run)
        log(f"[serving] run {r}: {n_done} requests in {wall:.2f} s: "
            f"{run['img_s']:.2f} img/s, e2e p50 {run['p50_ms']:.1f} ms, "
            f"p99 {run['p99_ms']:.1f} ms, [p50, p99] ms by task {by_task},"
            f" stats {stats}")
    launches = {"attention_branch": sb.attention_branch.launches,
                "mlp_branch": sb.mlp_branch.launches}
    svc.close()
    for run, results in zip(runs, served):  # after the count: the check
        run["stats"].update(check_served(
            results, pred, pool, tids, refs,
            [k for k, v in run["stats"]["by_size"].items() if v]))
    if (launches != {"attention_branch": 24 * dispatches,
                     "mlp_branch": 4 * dispatches} or dispatches == 0):
        fail(f"serving launches {launches} != 24/4 x {dispatches} "
             "dispatches")
    summ = {k: {"median": float(np.median([u[k] for u in runs])),
                "min": min(u[k] for u in runs),
                "max": max(u[k] for u in runs)}
            for k in ("img_s", "p50_ms", "p99_ms")}
    log(f"[serving] {SERVE_RUNS} runs of >= {SERVE_S:.0f} s, {OUTSTANDING} "
        f"outstanding: img/s median {summ['img_s']['median']:.2f}"
        f" (min {summ['img_s']['min']:.2f}, max {summ['img_s']['max']:.2f});"
        f" p50 ms median {summ['p50_ms']['median']:.1f}; p99 ms median "
        f"{summ['p99_ms']['median']:.1f} (min {summ['p99_ms']['min']:.1f}, "
        f"max {summ['p99_ms']['max']:.1f}); launches {launches} over "
        f"{dispatches} dispatches | {name} | {smi}")
    report["serving"] = {"runs": runs, "summary": summ,
                         "outstanding": OUTSTANDING, "launches": launches,
                         "max_batch": BATCH}
    # -- 5. training -----------------------------------------------------------
    train_launches = train_phase(name, smi, report, out_dir, swin_preset())
    # -- 6. fit from disk ------------------------------------------------------
    torch.cuda.empty_cache()
    fit_launches = fit_phase(name, smi, report, report["train"]["img_s"])
    # -- 7. DINOv3 serving -----------------------------------------------------
    torch.cuda.empty_cache()
    dino_serve_launches = vit_serving_phase(
        name, smi, report, dino_serving_preset(), out_dir)["global_attention"]
    # -- 8. DINOv3 training ----------------------------------------------------
    dino_launches = train_phase(name, smi, report, out_dir, dino_preset())
    # -- 9. the submission preset: model, serving, training, fit -> predict ---
    # (phases 9d and 10d read one dataset, deleted at the end)
    import shutil
    import tempfile

    data_tmp = tempfile.mkdtemp(prefix="chip_smoke_fit_data_")
    try:
        fit_root, report["fit_data_s"] = write_fit_dataset(
            data_tmp, flagship_config_dict()["tasks"])
        run_phases_9_10(name, smi, report, out_dir, fit_root)
    finally:
        shutil.rmtree(data_tmp, ignore_errors=True)
    spm_launches = report.pop("spm_launches")
    # -- 11. the device cache, adaptive normalisation, pretrained encoders ---
    torch.cuda.empty_cache()
    phase11_launches = phase11(name, smi, report)
    # -- 12. the ablation presets: off-main-path heads and step options ------
    torch.cuda.empty_cache()
    phase12_launches = phase12(name, smi, report)
    # -- 13. the other encoders and the unfused Swin attention ---------------
    torch.cuda.empty_cache()
    phase13_launches = phase13(name, smi, report)
    # -- 14. the parallel modes ---------------------------------------------
    torch.cuda.empty_cache()
    phase14_launches = phase14(name, smi, report)
    # -- 15. the fused MLP above C = 256 -------------------------------------
    torch.cuda.empty_cache()
    phase15_launches = phase15(name, smi, report)

    # -- kernels line ----------------------------------------------------------
    def entry(kname, source, replaces, count):
        recs = summary[kname]
        # per flagship forward at B=8 (K1f, K2f) or per train step at B=24
        # (K1b, K2b): stage shapes weighted by the blocks that run them
        # (attention: 2/2/18/2 blocks, half shifted; MLP: stages 0 and 1,
        # 2 blocks each)
        if kname.startswith("attention_branch"):
            weights = {"stage0": 1, "stage0_shift": 1, "stage1": 1,
                       "stage1_shift": 1, "stage2": 9, "stage2_shift": 9,
                       "stage3": 1, "stage3_shift": 1}
        else:
            weights = {"stage0": 2, "stage1": 2}
        keys = ["ms", "plain_ms", "bound_ms"]
        if all("chain_ms" in r for r in recs):  # K1, K2: information only
            keys += ["ms_10", "chain_ms", "chain_ms_10", "host_ms"]
        tot = {k: sum(weights[r["case"]] * r[k] for r in recs) for k in keys}
        by = {r["bound_by"] for r in recs}
        # the forward kernels' error covers their B=24 train shapes too
        checked = recs + summary.get(f"{kname}_train", [])
        return {"name": kname, "route": "cuda", "source": source,
                "replaces": replaces, "launches": count,
                "max_abs_err": max(r["max_abs_err"] for r in checked),
                "ms": tot["ms"], "plain_ms": tot["plain_ms"],
                "bound_ms": tot["bound_ms"],
                "bound_by": "operations" if "operations" in by else "bytes",
                "library_ms": None,
                **{k: tot[k] for k in ("ms_10", "chain_ms", "chain_ms_10",
                                       "host_ms") if k in tot}}

    # launches: K1f/K2f from the serving run (phase 4), K1b/K2b from the
    # timed train run (phase 5), each zeroed just before its run
    kernels = [
        entry("attention_branch", "fmc_uia_tpu_torch/csrc/swin_attn_fwd.cu",
              "fmc_uia_tpu/ops/swin_block_pallas.py:480",
              launches["attention_branch"]),
        entry("mlp_branch", "fmc_uia_tpu_torch/csrc/swin_mlp_fwd.cu",
              "fmc_uia_tpu/ops/swin_block_pallas.py:761",
              launches["mlp_branch"]),
        entry("attention_branch_backward",
              "fmc_uia_tpu_torch/csrc/swin_attn_bwd.cu",
              "fmc_uia_tpu/ops/swin_block_pallas.py:412",
              train_launches["attention_branch_backward"]),
        entry("mlp_branch_backward", "fmc_uia_tpu_torch/csrc/swin_mlp_bwd.cu",
              "fmc_uia_tpu/ops/swin_block_pallas.py:716",
              train_launches["mlp_branch_backward"]),
        # per flagship train step (B=24, 512², bf16); launches from phase 6
        {"name": "augment_normalize", "route": "cuda",
         "source": "fmc_uia_tpu_torch/csrc/preprocess_fwd.cu",
         "replaces": "fmc_uia_tpu/ops/preprocess_pallas.py:93",
         "launches": fit_launches["augment_normalize"],
         "max_abs_err": k3["max_abs_err"], "ms": k3["ms"],
         "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
         "bound_by": k3["bound_by"], "library_ms": None,
         "ms_50": k3["ms_50"], "device_ms": k3["device_ms"],
         "ms_p1": k3["ms_p1"], "ms_50_p1": k3["ms_50_p1"],
         "device_ms_p1": k3["device_ms_p1"],
         "bound_p1_ms": k3["bound_p1_ms"]},
    ]

    def k4_entry(kname, case, source, count):
        t = k4[kname][case]
        return {"name": kname, "route": "cuda", "source": source,
                "replaces": "fmc_uia_tpu/ops/vit_attention.py:82",
                "launches": count,
                "max_abs_err": max(k4[kname]["errs"]), "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"]}

    # per launch (one block): K4f at the serving batch (B=8) with launches
    # from phase 7's serving run, K4b at the train batch (B=24) with
    # launches from phase 8's timed run; library: SDPA's forward, and its
    # backward alone
    kernels += [
        k4_entry("global_attention", "serve_b8",
                 "fmc_uia_tpu_torch/csrc/vit_flash_fwd.cu",
                 dino_serve_launches),
        k4_entry("global_attention_backward", "train_b24",
                 "fmc_uia_tpu_torch/csrc/vit_flash_bwd.cu",
                 dino_launches["global_attention_backward"]),
    ]
    # phase 10's path (its serving run, timed training and fit): K3 once a
    # fit step, no other kernel
    # phase 11's fits (the cache, partial staging, adaptive normalisation,
    # the two pretrained fits): K3 once a step but under adaptive
    # normalisation, the Swin kernels on the flagship fits, no K4
    for e in kernels:
        e["launches_spm"] = spm_launches[e["name"]]
        e["launches_phase11"] = phase11_launches[e["name"]]
        e["launches_phase12"] = phase12_launches[e["name"]]
        e["launches_phase13"] = phase13_launches[e["name"]]
        e["launches_phase14"] = phase14_launches[e["name"]]
        e["launches_phase15"] = phase15_launches[e["name"]]
    report["kernels"] = kernels
    report["total_s"] = time.perf_counter() - t_start
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)
    log(f"[done] {report['total_s']:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
