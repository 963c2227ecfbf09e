#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths once on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --stage1-training    # phases 1, 2, 12 and 13 only
    python3 chip_smoke.py --attention-backward # phases 1, 2 and 16 only
    python3 chip_smoke.py --run-dir-tools      # phases 1, 2, 12, 13, 17 and 23-25
    python3 chip_smoke.py --reference-checkpoints  # phases 1, 2, 12, 13, 17 and 26
    python3 chip_smoke.py --mixed-precision    # phases 1, 2, 12, 13, 17 and 27
    python3 chip_smoke.py --multi-gpu          # phases 1, 2, 12, 13, 17 and 28
    python3 chip_smoke.py --model-axis         # phases 1, 2, 12, 13, 17 and 29
    python3 chip_smoke.py --pipeline           # phases 1, 2, 12, 13 and 30
    python3 chip_smoke.py --spatial            # phases 1, 2, 12, 13 and 31
    python3 chip_smoke.py --last-modules       # phases 1, 2, 12, 13 and 32
    python3 chip_smoke.py --model-axis-nccl    # phases 1, 2, 29 (a) and 30 on two cards

Runs nfdpm_tpu_torch (never JAX, never nfdpm_tpu) with seeded random
weights at the width of the repo's models: the Glow of configs/nf_base.yaml
and configs/nf_diffusion.yaml (L3/K4, coupling width 512, 32x32x3, batch
64, 5 bits) and, for stage 2, that flow with the diffusion prior of
configs/nf_diffusion.yaml (IdentityFormater: three UNets of dim 64,
dim_mults [1, 2], 8 groups, over the latent parts (16,16,6), (8,8,12),
(4,4,48); cosine schedule, T = 1000, DDIM-100 with eta 1). Phases, one JSON
line each:

  1. environment: card name and power limit, torch and CUDA versions; both
     TF32 switches must be off;
  2. build: nvcc compiles every csrc/*.cu for sm_90a, all at once;
  3. kernels: each CUDA kernel against its plain PyTorch version at every
     shape the paths give it, plus a ragged case. Times per call: "ms" from
     CUDA events around back-to-back calls as the path makes them (Python
     wrapper included), "device_ms" from replays of a CUDA graph of the
     calls (host taken out); the same for the plain version and, where one
     PyTorch call computes the function, for that call; and the bound.
     Each line also names the kernel's design version and, for channel_mix,
     the attention forward and coupling_tail, the wrapper's plan; the
     attention's lines add its bound on its 3xTF32 tensor-core route.
     coupling_tail and coupling_tail_inverse run in both modes: the step
     mode (the Glow step's whole tail, forward or inverse, the Glow paths')
     at the three level shapes and ragged ones (C/2 = 5 and 7), the same
     bits on a second call, and the plain-operand mode. Then the
     host steps of the planned wrappers (channel_mix and the two modes of
     the coupling tails at the level shapes, the attention forward and
     backward): host-clock us a call of each step they take and of the
     whole wrapper, beside the library call. Then "tail_route": the Glow
     step's kernel routes at the level shapes, their CUDA activities in
     order, their count and device us (forward, forward with backward, and
     inverse); the forward must end with the zeroconv's convolution and one
     step-tail launch, the step launch one tail kernel each way, and the
     inverse end with the zeroconv's convolution, one inverse-tail launch
     and the channel mix;
  Glow path (launch counters zeroed before 4, read after 6):
  4. scoring: bits/dim through inference.make_eval_step, kernel route
     against the plain route (use_kernels=False), within 1e-4;
  5. round trip: inverse(forward(x)) == x within 2e-3;
  6. serving: nfdpm_tpu_torch.serve on 127.0.0.1 answers /health and three
     /generate requests; the launch counters rise by 12 channel_mix and 12
     coupling_tail_inverse launches per 64-image chunk;
  stage-2 path (launch counters zeroed before 7, read after 9):
  7. stage-2 scoring: variational-bound bits/dim of a seeded batch of
     VLB_BATCH at full T through inference.make_vlb_eval_step, kernel route
     against plain route, within 1e-3;
  8. stage-2 sampling: one 64-image DDIM chunk through
     inference.make_diffusion_sample_fn, kernel route against plain route
     from the same generator seed: latent gap and share of differing pixels;
  9. stage-2 serving: the diffusion kind of nfdpm_tpu_torch.serve answers
     /health and three /generate requests; per 64-image chunk the counters
     rise by 1200 fused_linear_attention, 12 channel_mix and 12
     coupling_tail_inverse launches;
 10. profile: a stage-2 sampling chunk and a VLB batch, each cut to 30 UNet
     calls at the full chains' shapes, on each route: after a warm-up of
     each, 3 synchronised calls of each route taken in turns, wall ms
     median and spread, and whether the kernel route's median exceeds the
     plain route's by more than the spread ("profile_routes"); then
     torch.profiler over one call of each: device ms, busy share, device ms
     by kernel group and by kernel (nfdpm_tpu_torch.profiling); and the
     attention wrapper's host us and device us at the VLB's shapes
     ("host_steps");
  training path (launch counters zeroed before 12, read after it):
 11. kernels, backward: coupling_tail_bwd against its plain version in
     both modes (the step mode's d_zb and d_zlogs the same bits on a second
     call), and the gradients of the channel_mix, coupling_tail and
     coupling_step_tail autograd Functions against autograd through their
     plain versions, at the three level shapes and ragged cases; times as
     in 3, the dx call of channel_mix beside torch.matmul for the same
     product;
 12. training: nfdpm_tpu_torch.training.nf_trainer.train, the function the
     entry point calls, at the full width of configs/nf_base.yaml (L3/K4,
     width 512, 32x32x3, 5 bits, batch 64, Adam 1e-3, fp32) on TRAIN_STEPS
     batches of the port's synthetic data: ddinit, one epoch, a checkpoint
     with a sample grid, final bits/dim. Bits/dim finite and falling, the
     exact launch counts of the run, frozen leaves bit-identical;
 13. training steps: TIMED_STEPS more steps driven one by one: per step
     exactly 23 channel_mix (12 forward and 11 backward: the first step's
     input is the data, whose gradient nobody needs), 12 coupling_tail and
     12 coupling_tail_bwd launches; wall ms per step (median and spread of the
     last 16), images/s, peak memory, and a torch.profiler breakdown of one
     step;
 14. training, kernel route against plain route from one ddinit'ed state
     with the same injected noise: bits/dim and gradients of step 1 leaf by
     leaf, no missing or all-zero gradient, bits/dim of steps 1-8;
 15. resume: the checkpoint restored into a fresh state scores the test set
     exactly as training logged; the same through restore_params (the
     phase=eval path); and, where PyYAML is installed, the command line
     `python -m nfdpm_tpu_torch.run_baseline` trains a few steps at full
     width and `phase=eval` reproduces its final bits/dim.
 16. attention backward (run right after 11): the gradient of
     fused_linear_attention, kernel route (the autograd Function over the forward and backward
     kernels) against fused_linear_attention_bwd_plain at the 12 calls of a
     stage-2 train step (B = 64) and a ragged case: each of the five
     gradients within its tolerance, the same bits on a second call; times
     of the whole gradient as in 3, and its bound; then its two parts: the
     backward kernels alone (events and graph replays of
     `_backward_kernel`, and the profiler's sum over the fla_bwd_ kernels)
     with their own bound (fp32 and 3xTF32), and the library products
     behind them (`_library_products`); the plan of each call;
  stage-2 training path (launch counters zeroed before 17, read after it):
 17. stage-2 training: nfdpm_tpu_torch.run_diffusion_prior's main (the
     function `python -m nfdpm_tpu_torch.run_diffusion_prior` runs), in this
     process, at the full width of configs/nf_diffusion.yaml (three UNets
     of dim 64, cosine schedule, T = 1000, l1, Adam 1e-3, batch 64) from the
     stage-1 run of 12, frozen, one epoch of 24 steps on synthetic data, a
     sample grid and the checkpoint's, the VLB of one test batch: the exact
     launch count of the run (per step 12 fused_linear_attention, 12 of its
     backward, 12 channel_mix, 12 coupling_tail, no coupling_tail_bwd), a
     finite and falling loss, the checkpoint and diffusion_architecture.json;
     `phase=eval` through the command line reproduces the VLB; then 8 steps
     timed one by one (median and spread, images/s, peak memory) and a
     torch.profiler breakdown of one;
 18. stage-2 routes: the kernel route against use_kernels=False from that
     checkpoint with the same injected draws: the step-1 loss within 1e-5
     relative and every step-1 gradient within 1e-4 of its leaf's largest
     entry (l2 loss), the l1 losses of steps 1-8 within 1e-4 relative;
  stage-2 co-training path (launch counters zeroed before 19, read after it):
 19. stage-2 co-training: run_diffusion_prior's main again, in this process,
     with model.normalizing_flow.freeze=false and
     model.normalizing_flow.lr=1e-4 and T = 100 (STAGE2_COTRAIN_T), one
     epoch of 4 steps: the exact launch
     count of the run (per step 23 channel_mix, 11 of them dx, and 12
     coupling_tail_bwd besides the attention's 12 and 12), the l1_plus_bpd
     loss, flow leaves of its checkpoint moved from the stage-1 run, p_mat
     and sign not; `phase=eval` of that run, in-process, reads the trained
     flow back and prints the same VLB.

  whole-step megakernel (run right after 6; launch counters zeroed before
  21, read after the chained forward):
 20. megakernel: step_megakernel_forward against its plain version at the
     three level shapes (batch 64, width 512), the JAX package's test case
     (5x16x16x12, width 64), a ragged case and blocks of four whole images
     (16x2x2x48), y within 1e-5 and the logdet within rtol 1e-5 / atol
     1e-3, the same bits on a second call; the kernel's plan and halo
     waste; times as in 3 (the kernel alone,
     its weight packing, the whole wrapper), beside the plain version, the
     step the Glow path runs (bijectors.step_forward_kernels: channel_mix,
     cuDNN coupling CNN, coupling_tail) and bijectors.step_forward_megakernel;
     the bound by operations, and on the kernel's 3xTF32 tensor-core route;
 21. megakernel_glow: the Glow of phase 4 scores phase 4's batch and draw
     with its 12 steps chained through bijectors.step_forward_megakernel
     (glow.forward's level walk over squeeze_forward and split_forward):
     bits/dim and every latent part within 1e-4 of make_eval_step's kernel
     route, exactly 12 megakernel launches and no other, a refused
     gradient; device ms (CUDA graph) and wall ms of the chained forward,
     of glow.forward's kernel route and of its plain route.

  sample-quality evaluation (launch counters zeroed before 22c and before
  22d, read after each):
 22. sample_metrics: (a) the FID Inception-v3 and CLIP ViT-B/32 feature nets
     (seeded random weights), TF1 bilinear resize and SSIM/PSNR on the card
     against the same on the CPU (rtol 1e-3 / atol 2e-3; atol 2e-4; rtol
     2e-5); (b) `python -m nfdpm_tpu_torch.metrics.precompute_stats` as a
     subprocess over 512 synthetic 32x32 images (both resize modes,
     inception_v3) and over a CelebA-format directory of 256 training
     images written by tools/make_synthetic_celeba.py (clip_vit_b_32,
     clean, 224), into build/chip_smoke/metrics/stats, all three commands
     started beside phase 2's build (StatsCommands); (c) run_baseline.main
     phase=eval on phase 12's run with FID and KID in both modes and
     SSIM/PSNR over 512 generated images: every metric present and finite,
     the flow kernels' exact launches for 512 samples (256 a call) and the
     bits/dim; (d) run_diffusion_prior.main phase=eval on phase 17's run
     with FID (legacy_tensorflow) over 128 generated images and no VLB
     batch (phase 17's phase=eval scores the run's): present,
     finite, exact launches; both with the host seconds of their parts
     (sampler, resize by mode, feature net, FID and KID math); (e) the Glow
     sampler's images/s, resize host ms a image by mode, the feature nets'
     ms a batch of 32, 64 and 256 (CUDA events) and images/s beside
     Inception's fp32 bound, peak memory, and a projection (arithmetic from
     these rates) of a full=True CIFAR-10 evaluation of 50,000 images.
     Each line carries the card's name and power limit.

  run-directory tooling (launch counters zeroed before 23 and before 24,
  read after each):
 23. mid_epoch_resume: in a subprocess with CUBLAS_WORKSPACE_CONFIG=:4096:8,
     torch.use_deterministic_algorithms(True) and cudnn.deterministic, each
     trainer at full width (nf_trainer.train, 8 steps of batch 64;
     diffusion_trainer.train over phase 12's flow, frozen, EMA every second
     step) runs one epoch twice uninterrupted, then once interrupted by a
     loader proxy before batch 4 and resumed there (resume_batch=4):
     parameters, Adam moments (and EMA) and step bitwise equal to the
     uninterrupted run, the marker {"prefix", "epoch": 1, "batch_in_epoch":
     4} and its removal; where PyTorch names an operation without a
     deterministic CUDA implementation, that trainer runs in the default
     mode instead, the op printed, and the resumed run's largest gap must
     stay within twice the gap of the two uninterrupted runs. Then in this
     process, the default mode: two uninterrupted stage-1 runs (run to run:
     the largest parameter gap and the bits/dim gap of each mode's pair, the
     wall ms of a synchronised step of each mode); profile_epoch=1 with
     profile_steps=3 writes a trace that holds a channel_mix kernel (taken
     again up to three times); `python -m nfdpm_tpu_torch.run_baseline
     load.load_exp_dir=... load.load_epoch=1 load.load_batch=4` resumes an
     interrupted run. Every run trains under the watchdog (30 s), which
     never fires; each run's launches are exact;
 24. run_dir_serving: nfdpm_tpu_torch.serve --run-dir on phase 12's stage-1
     run and phase 17's stage-2 run, against --weights holding the same
     parameters: the same bytes for {"n": 128, "seed": 7}, 12 channel_mix
     and 12 coupling_tail_inverse launches a 64-image chunk (and 1200
     fused_linear_attention for stage 2), /health with run_dir, kind and
     epoch; request wall s and samples/s; then --no-ema against the EMA
     (DDIM-10) on phase 23's stage-2 run, which kept one: other samples;
 25. cli: python -m nfdpm_tpu_torch.generate_samples (n 128, batch 64, seed
     7) and python -m nfdpm_tpu_torch.interpolate (steps 8) as subprocesses
     on both run directories: the samples are the server's of phase 24, the
     strip (10, 32, 32, 3) uint8, the Glow's lambda 0 and 1 columns within
     one 5-bit level of the endpoints' codes; each command's JSON line.

  checkpoint interchange with the original PyTorch repository (launch
  counters zeroed before 26, read after it):
 26. reference_checkpoints: python -m nfdpm_tpu_torch.export_reference_checkpoint
     on phase 12's run, twice (the same bytes; keys {flow, prior_dist,
     optimizer, current_iter}; every flow tensor in the reference's layout:
     conv OIHW, actnorm [C, 1, 1], logs [1, C, 1, 1], invconv2d.weight
     [C, C, 1, 1]), then python -m nfdpm_tpu_torch.convert_reference_checkpoint
     of that .pt into a new run directory, both in this process: one seeded
     batch of 64 scored on both runs (bits/dim within 1e-4, 12 channel_mix
     and 12 coupling_tail launches a forward); a 64-image chunk of each
     through runload.load_run and sample_fn_of, serve --run-dir's route,
     from one seed (within one 5-bit level on at most 1e-3 of values, 12 +
     12 inverse launches); run_baseline.main resumes the imported run for 8
     steps (finite bits/dim, stage1_run_launches exactly, Adam count 8 in
     its checkpoint); phase 17's three UNets written under the reference's
     names (an inverse name table kept in this script), read back through
     utils/unet_import.import_unet_state_dict and load_state_dict(strict=
     True): a DDIM-100 chunk of 64 from one generator seed bitwise equal to
     the run's own UNets', 1200 fused_linear_attention launches.

  bf16 mixed precision (launch counters zeroed before 27, read after it):
 27. mixed_precision: GlowConfig.coupling_dtype="bfloat16" and bf16 UNets
     beside fp32. (a) Glow scoring of phase 4's weights, batch and draw:
     bf16 bits/dim of the kernel route within 1e-3 of the plain route's and
     within 1% (relative) of fp32's, exactly 12
     channel_mix and 12 coupling_tail launches a forward and 12 + 12 an
     inverse, the convolutions counted by dtype (a TorchDispatchMode on
     aten.convolution): 24 bf16 (conv1 and conv2 of 12 steps) and 14 fp32
     (the 12 zeroconvs and 2 split priors) a forward, 24 and 12 an
     inverse; one step's round trip within 2e-3 and the whole flow's within
     1e-2 (see MP_RT_TOL); device ms (CUDA graph), wall ms, cuDNN device ms
     by dtype and the operators with the most host time, of each dtype. (b) run_baseline.main with
     model.architecture.coupling_dtype=bfloat16 and again with float32, 8
     steps of batch 64 each on the same batches and noise: bits/dim finite
     and falling, each step's within 1% of fp32's, exact launches; the
     gradients of a first step from the bf16 run's state finite, fp32 and
     nonzero on every trained leaf (the fixed prior is not trained); 8
     synchronised bf16 steps (median and spread, exact launches a step),
     peak memory, a profile of one step and the operators with the most
     host time in each dtype, beside phase 13's fp32 figures. (c) run_diffusion_prior.main with
     model.diffusion.unet_dtype=bfloat16 and
     model.normalizing_flow.coupling_dtype=bfloat16 from phase 12's run,
     frozen, T = 100 (MP_STAGE2_T), one epoch of 11 steps: exact launches,
     the l1 loss finite and
     falling, "dtype": "bfloat16" in diffusion_architecture.json and no
     coupling dtype in its flow entry, phase=eval in-process prints the
     same VLB; runload rebuilds bf16 UNets; one UNet's bf16 output within
     5% of its largest entry from fp32's on the same weights; then on the
     trained weights in each dtype: a DDIM-100 chunk of 64 (exactly 1200
     attention launches), a VLB batch at phase 10's T = 40 (30 UNet calls;
     the full T = 1000 takes 15 s a dtype), 8 synchronised train steps and a
     profile of one (device ms by kernel group, cuDNN by dtype, busy share,
     peak memory), beside phases 7, 8 and 17's fp32 figures. (d) serve
     --run-dir on (c)'s run answers {"n": 64, "seed": 7} with the same
     bytes as --arch/--weights of the same parameters, exact launches.

  the children of phases 28-32 (launch_children), started after 27 in
  three launch groups, each child in deterministic mode (phase 23's
  settings) and each part of a child counting its launches from 0: a
  two-rank child (gloo ranks sharing this card, one process group) that
  runs 28's data axis, 29's (data 1, model 2), 30's two stages and 31's
  two spatial ranks in turn; a world-1 child with every reference of 28-31
  and 32 (c)'s deterministic epochs; the four ranks of 29 (b). A "launch"
  line each: the seconds from Popen to each child's first line and each
  child's own work. Phases 28-32 then gate their parts of the records:

  data parallelism (launch counters zeroed before 28's (e) and read after
  it, its children's own counters added):
 28. multi_gpu: the children join process groups through the port's own
     parallel.distributed.initialize. (a) A world of one over NCCL:
     run_baseline.main, MG_STEPS steps at full width, without a launch and
     then as rank 0 of the world of one with parallel.fsdp false and true:
     the checkpoints' parameters bitwise equal, each run's launches exact;
     the step loop under that mesh bitwise the one without a group (the
     reference of (b)). (b) Two ranks sharing this card over gloo (named
     by NFDPM_DIST_BACKEND), batch 64 global, fsdp false and true: bits/dim
     within MG_BPD_TOL of world 1's at every step, parameters within rtol
     MG_RTOL / atol MG_ATOL after MG_STEPS, the ranks' parameters bitwise
     equal, each rank's launches exactly 23 + 12 + 12 a step, under fsdp
     (the parameters, moments partitioned, each Glow step gathered on use)
     each rank's parameter and Adam-moment bytes between steps equal to
     what _add_fsdp predicts, and each process's peak of allocated memory
     over the steps beside world 1's. (c)
     Stage 2 on the two ranks: three UNets over phase 12's frozen flow,
     MG_STAGE2_STEPS steps: step 1's loss within MG_LOSS_RTOL (relative)
     of world 1's, every step's within MG_LOSS_RTOL of world 1's steps over
     two row blocks (mg_block_step: the two ranks' arithmetic in one
     process; the full-batch trajectory is recorded, not gated: Adam's
     first update moves near-zero gradients by about lr, and on some
     flows and draws the loss of two one-process routes parts by 5e-4 in
     four steps, PERF.md), 12 + 12 attention launches a step a rank.
     (d) Part-parallel on this card: three groups in turn against the joint
     trainer on MG_PART_BATCHES batches, losses, parameters and EMA bitwise;
     run_diffusion_prior.main with parallel.part_parallel=true, whose
     merged checkpoint serve --run-dir serves. (e) serve --data-parallel
     and precompute_stats --data-parallel: the bytes and statistics of the
     runs without the flag, "devices": 1. (f) Step wall ms at world 1 and
     2, the gradient all-reduce's ms, with the card's name and power limit
     (gloo on one card moves the gradients through the host). Budget
     MG_BUDGET_S.

  the model axis (launch counters zeroed before 29's phase=eval and read
  after it, its children's own counters added):
 29. model_axis: the ranks share this card over gloo (named by
     NFDPM_DIST_BACKEND: NCCL cannot put two ranks on one GPU); the world-1
     child makes the references. (a) Two
     ranks at (data 1, model 2): run_baseline.main with parallel.n_model=2
     at full width, MT_STEPS steps: step 1's bits/dim within MG_BPD_TOL
     of world 1's, every step within TRAIN_TRAJ_TOL, the parameters within
     MG_FINAL_ATOL after the last; each rank's launches exactly 23 + 12 +
     12 a step and the run's as world 1's; each rank's flow parameter and
     Adam-moment bytes equal to the placements' prediction; the run's
     checkpoint (whole tensors) scored by phase=eval in this process, a
     world of one, within MG_BPD_TOL of the run's final bits/dim. (b) Four
     ranks at (data 2, model 2) with parallel.fsdp=true, MT_MESH4_STEPS
     steps: step 1 within MG_BPD_TOL, the ranks' coordinates and groups
     (also over two slices), the flow parameter and moment bytes a rank as
     the placements predict (data slabs of the model slabs), the peak of
     allocated memory beside world 1's, exact launches. (c) Two ranks at
     (1, 2): stage 2 over phase 12's frozen flow
     (three UNets), MG_STAGE2_STEPS steps, every step's loss within
     MG_LOSS_RTOL of world 1's step from the same state (the model-2 run
     writes its whole state before each step after the first, and the
     world-1 child runs one step from each with that step's batch and
     draws, mt_same_state; world 1's own trajectory is recorded: the model
     axis changes the UNet's sums, see phase 28 (c)), 12 + 12 attention
     launches a step a rank and a same-state step; a DDIM chunk of
     MT_DDIM_STEPS steps and MT_DDIM_N images on the seeded UNets, its
     latents within LATENT_TOL of world 1's. (d) The record: step wall ms at world 1 and
     model 2, the model group's all-reduce and all-gather bytes a step and
     their ms, the bytes a rank, the card's name and power limit. Budget
     MT_BUDGET_S. Its world-1 child also makes phase 31's (b) references.

  the pipeline (launch counters zeroed before 30's phase=eval and read
  after it, its children's own counters added):
 30. pipeline: the two-rank child's gloo ranks sharing this card, against
     the world-1 child's run of 29 (a): run_baseline.main with
     parallel.n_model=2
     parallel.pipeline=true, PP_MICROBATCHES microbatches, at full width,
     MT_STEPS steps. Step 1's bits/dim within MG_BPD_TOL of world 1's,
     every step within TRAIN_TRAJ_TOL, the parameters within MG_FINAL_ATOL
     after the last; each stage's launches a step exactly those of the
     steps it holds (pp_step_launches: stage 0's first step of level 1
     launches no dx) and the run's; each stage's flow parameter and moment
     bytes as the placements predict; the run's checkpoint scored by
     phase=eval in this process, a world of one, within MG_BPD_TOL. The
     record: step wall ms at world 1 and at two stages, the hop and flush
     bytes a step and their ms on the timed step, the peak of allocated
     memory, the card's name and power limit. Budget PP_BUDGET_S.

  spatial partitioning (launch counters zeroed after 31's kernel checks and
  read at its end, the spatial ranks' own counters added; the world-1
  reference runs' launches apart, as "spatial_world1_reference"):
 31. spatial: first channel_mix (forward and dx), coupling_step_tail and
     coupling_step_tail_bwd at the shapes a rank's row block gives them,
     each level's (b, h/2, w, c) at batch 64 and SP_STAGE2_BATCH, against
     their plain versions at phases 10's and 11's tolerances
     (sp_row_kernels). Then the two-rank child's gloo ranks at (data 1,
     model 2) sharing this card. (a) run_baseline.main with
     parallel.n_model=2 parallel.spatial=true at full width, MT_STEPS
     steps, against the world-1 child's run of 29 (a): step 1's bits/dim
     within MG_BPD_TOL, every step within
     TRAIN_TRAJ_TOL, the parameters within MG_FINAL_ATOL; each rank's
     launches exactly 23 + 12 + 12 a step and the run's as world 1's; each
     rank's flow parameter and moment bytes world 1's (no slabs); the halo
     sent each way a step a rank exactly sp_halo_bytes() (15,024,128 B in
     26 exchanges at batch 64); the checkpoint scored by phase=eval in this
     process, a world of one, within MG_BPD_TOL. (b) run_diffusion_prior.main
     with parallel.spatial=true over phase 12's frozen flow, UNets of the
     config's width with SP_GROUPS group (every Block_0 norm one group split
     over both ranks), T = SP_STAGE2_T, batch SP_STAGE2_BATCH: MG_STAGE2_STEPS
     steps and one co-trained step, the first step's loss of each within
     MG_LOSS_RTOL of the same runs at world 1 (made by the world-1 child;
     the later steps recorded: an entry-point run cannot be restarted from
     the spatial run's states, see sp_check_b), the launches a step exactly
     stage2_per_step's (12 + 12 attention). (c) The record: step wall ms
     at world 1 and spatial, the halo, gradient-sum and latent-gather
     bytes and calls a step and their ms on the timed step, the peak of
     allocated memory a rank beside world 1's, the card's name and power
     limit. Budget SP_BUDGET_S.

  the JAX package's last modules (launch counters zeroed before 32 and
  read after it, the world-1 child's epochs added):
 32. last_modules: at the width of configs/nf_diffusion.yaml over phase
     12's frozen flow. (a) LM_STEPS stage-2 train steps (batch 64) of the
     default UNet, of Unet(remat=True) and of Unet(stacked_mid_attn=True),
     each from the same seeded state and batches with the steps' own
     draws: every loss within LM_LOSS_RTOL (relative) of the default's,
     step 1's gradients within STAGE2_GRAD_TOL of each leaf's largest
     entry, exactly 12 + 12 attention launches a step; each variant's peak
     of allocated memory and step wall ms. (b)
     DiffusionPrior.evaluate_neg_log_likelihood and
     neg_log_likelihood_nats on one batch of VLB_BATCH at T = 1000 with the
     same injected draws: the per-part values weighted by their processed
     dims squared plus the formater's sum(log std) within LM_VLB_RTOL of
     the total; exact attention launches a pass. (c) The batch assembly:
     the native library (it must be the path taken) bitwise equal to the
     numpy path on a batch of 64x32x32x3 with flips, the host ms a batch
     of each; the stage-1 step's wall ms fed through the producer thread
     and through the synchronous path; the world-1 child's epochs of
     nf_trainer.train (TRAIN_STEPS steps, deterministic mode) through both
     paths bitwise equal. Budget LM_BUDGET_S.

Then come the phase_seconds line (every top-level phase's wall seconds and
the total), the kernel summary line (seven kernels), the nvidia-smi line and, last,
{"ok": true, "device": {...}}. With --run-dir-tools the script runs the
environment, the build, phases 12, 13 and 17 (whose run directories the
tooling reads) and 23-25, and prints neither; --reference-checkpoints the same
with phase 26 in place of 23-25, --mixed-precision with phase 27, --multi-gpu
with phase 28, --model-axis with phase 29, --pipeline with phases 12, 13
and 30 (no phase 17), --spatial with phases 12, 13 and 31 and
--last-modules with phases 12, 13 and 32; each of the last five starts
only the children its phases need. With
--stage1-training the script runs only the environment, the build and
phases 12 and 13 and prints neither: copied
into another checkout, it times that checkout's stage-1 training with the
same measuring code; --attention-backward the same for phase 16 alone
(in a checkout whose wrapper has no `bwd_plan`, the lines carry no plan).
Any failed check raises and exits non-zero
before that line. All records are also written to chiprun_out/chip_smoke.json,
those of a failed run too.
"""

from __future__ import annotations

import contextlib
import dataclasses
import http.client
import io
import itertools
import json
import logging
import math
import os
import re
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
LEVELS, STEPS, WIDTH, IMG, BATCH, N_BITS = 3, 4, 512, 32, 64, 5
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_FLOPS_PER_S = 67e12   # H100 SXM, fp32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12  # H100 SXM, TF32 on the tensor cores, dense
# Operations per element of the two tail kernels, counted from their source:
# forward: add, exp, add, reciprocal, add, mul, add, log, add = 9;
# inverse: add, exp, add, reciprocal, add, div, sub = 7.
TAIL_OPS, TAIL_INV_OPS = 9, 7
# the tail's backward: sigmoid 4, 1 - s, s ds, x_b + bias, two products with
# g_y, s + eps, the quotient, its product with g_ldj, the sum, g_y s = 15
TAIL_BWD_OPS = 15
# the step mode, per value of the transformed half: the zeroconv epilogue on
# the log-scale and the bias (an add and a mul each) = 4 more; its backward
# also scales both cotangents by exp(3 zlogs) and adds them, and the
# products with h, into the d_zb and d_zlogs sums = 8 more. Per channel, the
# 2C exponentials of the epilogue besides.
STEP_TAIL_OPS, STEP_TAIL_BWD_OPS = TAIL_OPS + 4, TAIL_BWD_OPS + 4 + 8
# the inverse's step mode: the same epilogue on top of the inverse's 7
STEP_TAIL_INV_OPS = TAIL_INV_OPS + 4
RECORDS = []
PROCESSES = []  # processes started on threads, stopped at exit if still running
# Design version of each kernel, beside its times in the "kernel" lines
# (1: the first design; channel_mix 2: square kernels with rows in registers
# and a dx mode; fused_linear_attention 2: a fused pass of one batch row a
# block and split token-tiled passes, with 3xTF32 tensor-core products;
# fused_linear_attention_bwd 2: the same plans for the gradient;
# coupling_tail and coupling_tail_bwd 2: a unit of VW values a thread, a
# grid that fills the card, fixed-order sums across blocks, and the step
# mode that takes in the zeroconv epilogue, the half copies, the
# concatenation and the logdet add; coupling_tail_inverse 2: the same units
# and a step mode for the inverse step; step_megakernel 2: every product on
# the tensor cores in 3xTF32, a block a run of consecutive pixels, the
# zeroconv in scatter form with no halo, a gather-and-tail kernel).
KERNEL_VERSIONS = {"channel_mix": 2, "fused_linear_attention": 2,
                   "fused_linear_attention_bwd": 2, "coupling_tail": 2,
                   "coupling_tail_bwd": 2, "coupling_tail_inverse": 2,
                   "step_megakernel": 2}

# Stage 2, configs/nf_diffusion.yaml; the keys of a stage-2 run's
# diffusion_architecture.json (nfdpm_tpu/training/runload.py)
FORMATER = "IdentityFormater"
UNET_KWARGS = {"dim": 64, "dim_mults": [1, 2], "resnet_block_groups": 8,
               "learned_sinusoidal_cond": False, "random_fourier_features": False,
               "learned_sinusoidal_dim": 16}
DIFFUSION_KWARGS = {"timesteps": 1000, "sampling_timesteps": 100, "loss_type": "l1",
                    "beta_schedule": "cosine", "ddim_sampling_eta": 1.0, "scan_unroll": 1,
                    "sampling_method": "auto", "vlb_time_chunk": 4}
VLB_BATCH = 8      # images per stage-2 scoring batch: 4 * 8 = 32 rows per UNet call
FLA_TOL = 1e-4     # kernel vs plain, rtol and atol (tests/test_torch_kernels_cuda.py)
VLB_TOL = 1e-3     # bits/dim, kernel route vs plain route (ROADMAP's gate)
# Stage-2 sampling, kernel route vs plain route, same draws: 100 DDIM steps
# carry the kernels' rounding (sum order) through the chain and the flow's
# inverse. Measured on an H100 (PERF.md, Findings): latents 3.6e-4 apart,
# 9.2e-5 of the uint8 pixels differ; the bounds leave about 10x for spread.
LATENT_TOL = 5e-3
PIXEL_SHARE_TOL = 1e-3

# Training, configs/nf_base.yaml: Adam 1e-3, 5 bits, batch 64
TRAIN_STEPS = 24   # one epoch of the training phase: synthetic_n = 64 * 24
TIMED_STEPS = 20   # steps driven one by one after it; the last 16 are timed
TRAIN_SEED = 42
TRAIN_BPD_TOL = 1e-4     # step 1, kernel route vs plain route (fp32, sum order)
TRAIN_TRAJ_TOL = 1e-3    # steps 1-8, the repository's gate for trajectories
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6  # step-1 gradients, leaf by leaf


START = time.perf_counter()
# the top-level phase running now and when it started (timed), and each
# finished one's wall seconds, in order: the "phase_seconds" line
PHASE = {"name": None, "t0": START}
PHASE_SECONDS = {}


def emit(record: dict) -> None:
    """Print one JSON line and keep it for the records file written at exit;
    stamped with the seconds since the script started and since its
    top-level phase started (a phase's last line carries its wall seconds)."""
    now = time.perf_counter()
    record.update(elapsed_s=now - START, phase_wall_s=now - PHASE["t0"])
    RECORDS.append(record)
    print(json.dumps(record), flush=True)


def timed(name: str, fn, *args, **kwargs):
    """fn(*args, **kwargs) as the top-level phase `name`: its wall seconds
    go into PHASE_SECONDS."""
    PHASE.update(name=name, t0=time.perf_counter())
    try:
        return fn(*args, **kwargs)
    finally:
        PHASE_SECONDS[name] = time.perf_counter() - PHASE["t0"]


def restart_clock() -> None:
    global START
    START = PHASE["t0"] = time.perf_counter()


def emit_phase_seconds() -> None:
    """The "phase_seconds" line: every top-level phase's wall seconds and
    the script's."""
    emit({"phase": "phase_seconds", "seconds": dict(PHASE_SECONDS),
          "phases_s": sum(PHASE_SECONDS.values()), "total_s": time.perf_counter() - START})


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean device time of one call, from CUDA events around `iters` calls."""
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


def graph_ms(fn, calls: int = 50, replays: int = 20) -> float:
    """Mean device time of one call with the host taken out: `calls` calls
    captured in one CUDA graph, replayed `replays` times between events.
    The capture runs on the stream that the warm-up calls ran on, where a
    wrapper that keeps state per stream (the step-tail backward's ticket)
    has made it."""
    import torch

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def bound_ms(nbytes: float, ops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def host_ms(torch, fn, iters: int = 10) -> float:
    """Wall ms of one call (host clock around synchronised calls)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def level_shapes():
    """(H, W, C) the Glow steps of each level see: [(16,16,12), (8,8,24), (4,4,48)]."""
    shapes, c, s = [], 3, IMG
    for _ in range(LEVELS):
        c, s = c * 4, s // 2
        shapes.append((s, s, c))
        c //= 2
    return shapes


def phase_environment(torch, port):
    smi = nvidia_smi()
    print(smi, flush=True)
    port.disable_tf32()
    check(torch.backends.cudnn.allow_tf32 is False, "cuDNN TF32 is on")
    check(torch.backends.cuda.matmul.allow_tf32 is False, "cuBLAS TF32 is on")
    emit({"phase": "environment", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "cudnn_allow_tf32": False,
          "matmul_allow_tf32": False})
    return smi


def phase_build(build):
    seconds = build.build()
    libraries = {}
    for name in build.SOURCES:
        log = build.build_log(name)
        text = log.read_text() if log.exists() else ""
        libraries[name] = {
            "library": str(build.library_path(name).relative_to(ROOT)),
            "ptxas": [ln.strip() for ln in text.splitlines()
                      if "registers" in ln or "spill" in ln]}
    emit({"phase": "build", "seconds": seconds, "libraries": libraries})


def step_tail_bytes_ops(b: int, n: int, c: int, backward: bool = False):
    """Bytes and operations of one step-mode tail over n pixels of C
    channels: the forward reads y and r and writes out (3 n C values), zb,
    zlogs, ldj and ldj'; the backward reads y's transformed half, r and
    g_out and writes d_y and d_r (4.5 n C: d_y's first half is g_out's, so
    y's first half is never read), zb, zlogs, g_ldj, d_zb and d_zlogs."""
    if backward:
        return 4 * (9 * n * c // 2 + 4 * c + b), STEP_TAIL_BWD_OPS * n * c // 2 + 2 * c
    return 4 * (3 * n * c + 2 * c + 2 * b), STEP_TAIL_OPS * n * c // 2 + 2 * c


def phase_kernels(torch, cm, ct):
    """Each kernel against its plain version; returns per-kernel summaries
    of one pass (4 launches at each of the 3 level shapes). The Glow path
    runs coupling_tail in its step mode, so those rows make its summary;
    the plain-operand mode's rows are checked and timed beside them."""
    gen = torch.Generator(device="cuda").manual_seed(1234)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    cases = [(BATCH, h, w, c, STEPS, True) for (h, w, c) in level_shapes()]
    cases.append((37, 3, 5, 14, 0, False))  # ragged: N = 555, D = 105
    cases.append((5, 3, 5, 10, 0, False))   # ragged step tail: C/2 = 5, 4-byte accesses
    timed = ("ms", "plain_ms", "library_ms", "device_ms", "plain_device_ms",
             "library_device_ms")
    totals = {k: dict({t: 0.0 for t in timed}, bytes=0.0, ops=0.0, max_abs_err=0.0)
              for k in ("channel_mix", "coupling_tail", "coupling_tail_inverse")}
    for b, h, w, c, per_pass, on_path in cases:
        o = c if on_path else c + 6  # the ragged case also has O != C
        x, wt, bias = randn(b, h, w, c), randn(o, c, scale=c ** -0.5), randn(o)
        half = (b, h, w, c // 2)
        ls, tb, xb = randn(*half, scale=0.5), randn(*half), randn(*half)
        n, d = b * h * w, h * w * (c // 2)
        x2d = x.view(-1, c)

        # (name, max |kernel - plain|, bytes, ops, kernel, plain, library call,
        # extra keys of the line; a "plain operands" mode is on no path)
        rows = []
        y_k, y_p = cm.channel_mix(x, wt, bias), cm.channel_mix_plain(x, wt, bias)
        torch.cuda.synchronize()
        err = float((y_k - y_p).abs().max())
        check(torch.allclose(y_k, y_p, rtol=1e-5, atol=1e-5),
              f"channel_mix differs from its plain version at {tuple(x.shape)}: {err}")
        rows.append(("channel_mix", err, 4 * (n * c + n * o + o * c + o), 2 * n * c * o,
                     lambda: cm.channel_mix(x, wt, bias),
                     lambda: cm.channel_mix_plain(x, wt, bias),
                     lambda: torch.addmm(bias, x2d, wt.T),
                     {"plan": cm.plan(n, c, o)._asdict()}))

        # the step mode, as the Glow step launches it: the channel mix's
        # output, the zeroconv's raw convolution, its bias and log-scale,
        # the running logdet
        r, zb, zlogs, ldj0 = randn(b, h, w, c, scale=0.5), randn(c, scale=0.2), \
            randn(c, scale=0.2), randn(b, scale=10.0)
        (sk, slk), (sp, slp) = (ct.coupling_step_tail(x, r, zb, zlogs, ldj0),
                                ct.coupling_step_tail_plain(x, r, zb, zlogs, ldj0))
        again = ct.coupling_step_tail(x, r, zb, zlogs, ldj0)
        torch.cuda.synchronize()
        err = max(float((sk - sp).abs().max()), float((slk - slp).abs().max()))
        check(torch.allclose(sk, sp, rtol=1e-5, atol=1e-5)
              and torch.allclose(slk, slp, rtol=1e-5, atol=1e-4),
              f"coupling_tail's step mode differs from its plain version at "
              f"{(b, h, w, c)}: {err}")
        check(torch.equal(sk, again[0]) and torch.equal(slk, again[1]),
              f"coupling_tail's step mode gave other bits on a second call at {(b, h, w, c)}")
        nbytes, ops = step_tail_bytes_ops(b, n, c)
        plan = ct.forward_plan(b, h * w, c // 2,
                               ct.vector_width(c // 2, x.data_ptr(), r.data_ptr()))
        rows.append(("coupling_tail", err, nbytes, ops,
                     lambda: ct.coupling_step_tail(x, r, zb, zlogs, ldj0),
                     lambda: ct.coupling_step_tail_plain(x, r, zb, zlogs, ldj0), None,
                     {"mode": "step", "plan": plan._asdict()}))

        # the plain-operand mode, the JAX function's counterpart (on no path)
        (yk, lk), (yp, lp) = ct.coupling_tail(ls, tb, xb), ct.coupling_tail_plain(ls, tb, xb)
        torch.cuda.synchronize()
        err = max(float((yk - yp).abs().max()), float((lk - lp).abs().max()))
        check(torch.allclose(yk, yp, rtol=1e-5, atol=1e-5)
              and torch.allclose(lk, lp, rtol=1e-5, atol=1e-4)
              and torch.equal(lk, ct.coupling_tail(ls, tb, xb)[1]),
              f"coupling_tail differs from its plain version (or from itself) at {half}: {err}")
        rows.append(("coupling_tail", err, 4 * (4 * b * d + b), TAIL_OPS * b * d,
                     lambda: ct.coupling_tail(ls, tb, xb),
                     lambda: ct.coupling_tail_plain(ls, tb, xb), None,
                     {"mode": "plain operands"}))

        # the inverse's step mode, as the inverse Glow step launches it: the
        # step's output (the forward step tail's) and the same convolution
        xk = ct.coupling_step_tail_inverse(sk, r, zb, zlogs)
        xp = ct.coupling_step_tail_inverse_plain(sk, r, zb, zlogs)
        again = ct.coupling_step_tail_inverse(sk, r, zb, zlogs)
        torch.cuda.synchronize()
        err = float((xk - xp).abs().max())
        check(torch.allclose(xk, xp, rtol=1e-5, atol=1e-5),
              f"coupling_tail_inverse's step mode differs from its plain version at "
              f"{(b, h, w, c)}: {err}")
        check(torch.equal(xk, again),
              f"coupling_tail_inverse's step mode gave other bits on a second call at "
              f"{(b, h, w, c)}")
        plan = ct.inverse_plan(b, h * w, c // 2,
                               ct.vector_width(c // 2, sk.data_ptr(), r.data_ptr()))
        rows.append(("coupling_tail_inverse", err, 4 * (3 * n * c + 2 * c),
                     STEP_TAIL_INV_OPS * n * c // 2 + 2 * c,
                     lambda: ct.coupling_step_tail_inverse(sk, r, zb, zlogs),
                     lambda: ct.coupling_step_tail_inverse_plain(sk, r, zb, zlogs), None,
                     {"mode": "step", "plan": plan._asdict()}))

        # its plain-operand mode, the JAX function's counterpart (on no path)
        xk, xp = ct.coupling_tail_inverse(ls, tb, yk), ct.coupling_tail_inverse_plain(ls, tb, yk)
        torch.cuda.synchronize()
        err = float((xk - xp).abs().max())
        check(torch.allclose(xk, xp, rtol=1e-5, atol=1e-5),
              f"coupling_tail_inverse differs from its plain version at {half}: {err}")
        rows.append(("coupling_tail_inverse", err, 4 * 4 * b * d, TAIL_INV_OPS * b * d,
                     lambda: ct.coupling_tail_inverse(ls, tb, yk),
                     lambda: ct.coupling_tail_inverse_plain(ls, tb, yk), None,
                     {"mode": "plain operands"}))

        for name, err, nbytes, ops, kernel, plain, library, extra in rows:
            times = {"ms": cuda_ms(kernel), "plain_ms": cuda_ms(plain),
                     "library_ms": cuda_ms(library) if library else None,
                     "device_ms": graph_ms(kernel), "plain_device_ms": graph_ms(plain),
                     "library_device_ms": graph_ms(library) if library else None}
            b_ms, b_by = bound_ms(nbytes, ops)
            path = extra.get("mode") != "plain operands"
            emit({"phase": "kernel", "name": name, "version": KERNEL_VERSIONS.get(name, 1),
                  "x": [b, h, w, c], "on_path": on_path and path,
                  "launches_per_pass": per_pass if path else 0, "max_abs_err": err, **times,
                  "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "ops": ops, **extra})
            if not path:
                continue
            tot = totals[name]
            tot["max_abs_err"] = max(tot["max_abs_err"], err)
            if on_path:
                tot["bytes"] += per_pass * nbytes
                tot["ops"] += per_pass * ops
                for key in timed:
                    tot[key] += per_pass * (times[key] or 0.0)
    for name, tot in totals.items():
        tot["bound_ms"], tot["bound_by"] = bound_ms(tot["bytes"], tot["ops"])
        if name != "channel_mix":
            tot["library_ms"] = tot["library_device_ms"] = None
    return totals


def attention_shapes(torch, dp, device):
    """(part, block, H, W, C) of every linear-attention call of one UNet
    evaluation of each part, in call order, read by forward hooks from one
    batch-1 evaluation."""
    from nfdpm_tpu_torch.models.unet import LinearAttention

    shapes = []
    for part, (h, w, c) in enumerate(dp.formater.input_shapes):
        unet = dp.place(dp.build_unet(part), device)
        seen = []
        hooks = [m.register_forward_hook(lambda _m, args, _out: seen.append(args[0].shape))
                 for m in unet.modules() if isinstance(m, LinearAttention)]
        with torch.inference_mode():
            unet(torch.zeros((1, h, w, c), device=device),
                 torch.zeros((1,), dtype=torch.int64, device=device), use_kernels=False)
        for hook in hooks:
            hook.remove()
        shapes += [(part, block, s[1], s[2], s[3]) for block, s in enumerate(seen)]
    return shapes


def fla_bytes_ops(b: int, n: int, c: int):
    """Bytes each input read once and the output written once, and the
    multiply-adds of the block's five contractions (2 flops each):
    qkv projection, per-head k^T v and q ctx, out-projection."""
    hidden, dh = 128, 32
    nbytes = 4 * (2 * b * n * c + 3 * hidden * c + hidden * c + 2 * c)
    ops = 2 * b * n * (3 * c * hidden + 2 * hidden * dh + hidden * c)
    return nbytes, ops


def fla_tensor_core_bound_ms(b: int, n: int, c: int) -> float:
    """The least time of the call on the kernel's own route: every product
    (the projections, k^T v and q ctx) as three TF32 products (3xTF32) at
    the tensor cores' 495 TFLOP/s, or the bytes of fla_bytes_ops at
    3.35 TB/s, the larger."""
    nbytes, ops = fla_bytes_ops(b, n, c)
    return max(3 * ops / TF32_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3


def fla_bwd_bytes_ops(b: int, n: int, c: int):
    """Bytes and operations of the whole gradient at x [b, n, c]: every
    input (x, the four weights, the saved contexts and softmax statistics,
    the cotangent) read once, the five gradients written once; the
    multiply-adds (2 operations each) of the recomputed forward (q
    projection, q ctx, out-projection, k and v projections) and of the
    backward (do, dq, dctx, dk, dv, dx, dW_qkv, dW_out)."""
    hidden, dh = 128, 32
    weights = 3 * hidden * c + hidden * c + 2 * c
    nbytes = 4 * (3 * b * n * c + 2 * weights + b * 4 * dh * (dh + 2))
    macs = b * n * (12 * hidden * c + 5 * hidden * dh)
    return nbytes, 2 * macs


def fla_bwd_kernel_bytes_ops(b: int, n: int, c: int):
    """Bytes and operations of the backward kernels alone (without the
    library products behind them): x, the cotangent, the weights, the
    saved contexts and statistics read once, o, dy and dqkv written once;
    the multiply-adds (2 operations each) of the q, k and v projections,
    the out-projection and do = dy W_out^T (5 128 C a token), and of the
    per-head products q ctx, dq, dctx, dk and dv (5 4096 a token)."""
    hidden, dh = 128, 32
    weights = 3 * hidden * c + hidden * c + 2 * c
    nbytes = 4 * (b * n * (2 * c + hidden + c + 3 * hidden) + weights
                  + b * 4 * dh * (dh + 2))
    macs = b * n * (5 * hidden * c + 5 * 4 * dh * dh)
    return nbytes, 2 * macs


def fla_bwd_tensor_core_bound_ms(b: int, n: int, c: int) -> float:
    """The backward kernels' least time on their own route: every product
    as three TF32 products at 495 TFLOP/s, or their bytes, the larger."""
    nbytes, ops = fla_bwd_kernel_bytes_ops(b, n, c)
    return max(3 * ops / TF32_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3


def phase_attention_kernel(torch, fla, sampling_shapes):
    """fused_linear_attention against its plain version at the 12 shapes of
    one sampling step (B = 64), at the VLB shapes (B = 4 * VLB_BATCH) and at
    a ragged case; returns the summary over one sampling step."""
    gen = torch.Generator(device="cuda").manual_seed(4321)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    rows_vlb = 4 * VLB_BATCH
    cases = [("sampling", f"part {p} block {k}", BATCH, h, w, c)
             for p, k, h, w, c in sampling_shapes]
    cases += [("vlb", f"part {p} block {k}", rows_vlb, h, w, c)
              for p, k, h, w, c in sampling_shapes]
    cases.append(("ragged", "C 20, N 3x5, B 5", 5, 3, 5, 20))
    timed = ("ms", "plain_ms", "device_ms", "plain_device_ms")
    tot = dict({t: 0.0 for t in timed}, bytes=0.0, ops=0.0, max_abs_err=0.0)
    step_tc_ms = 0.0
    for use, label, b, h, w, c in cases:
        x = randn(b, h, w, c)
        w_qkv, w_out = randn(c, 384, scale=c ** -0.5), randn(128, c, scale=128 ** -0.5)
        b_out, g = randn(c, scale=0.1), 1.0 + randn(c, scale=0.1)
        args = (x, w_qkv, w_out, b_out, g)
        y_k, y_p = fla.fused_linear_attention(*args), fla.fused_linear_attention_plain(*args)
        torch.cuda.synchronize()
        err = float((y_k - y_p).abs().max())
        check(torch.allclose(y_k, y_p, rtol=FLA_TOL, atol=FLA_TOL),
              f"fused_linear_attention differs from its plain version at "
              f"{tuple(x.shape)}: {err}")
        check(torch.equal(y_k, fla.fused_linear_attention(*args)),
              f"fused_linear_attention gave other bits on a second call at {tuple(x.shape)}")
        times = {"ms": cuda_ms(lambda: fla.fused_linear_attention(*args)),
                 "plain_ms": cuda_ms(lambda: fla.fused_linear_attention_plain(*args)),
                 "device_ms": graph_ms(lambda: fla.fused_linear_attention(*args)),
                 "plain_device_ms": graph_ms(lambda: fla.fused_linear_attention_plain(*args))}
        nbytes, ops = fla_bytes_ops(b, h * w, c)
        b_ms, b_by = bound_ms(nbytes, ops)
        tc_ms = fla_tensor_core_bound_ms(b, h * w, c)
        emit({"phase": "kernel", "name": "fused_linear_attention",
              "version": KERNEL_VERSIONS["fused_linear_attention"], "use": use,
              "call": label, "x": [b, h, w, c], "max_abs_err": err, "tolerance": FLA_TOL,
              "same_bits_twice": True, **times, "library_ms": None, "bound_ms": b_ms,
              "bound_by": b_by, "tensor_core_bound_ms": tc_ms, "bytes": nbytes, "ops": ops,
              "plan": attention_plan(fla, h * w, c)})
        tot["max_abs_err"] = max(tot["max_abs_err"], err)
        if use == "sampling":
            tot["bytes"] += nbytes
            tot["ops"] += ops
            step_tc_ms += tc_ms
            for key in timed:
                tot[key] += times[key]
    tot["bound_ms"], tot["bound_by"] = bound_ms(tot["bytes"], tot["ops"])
    tot["library_ms"] = tot["library_device_ms"] = None
    emit({"phase": "attention_step_bounds", "per": "one sampling step: 12 calls at batch 64",
          "bound_ms": tot["bound_ms"], "bound_by": tot["bound_by"],
          "tensor_core_bound_ms": step_tc_ms})
    return tot


def attention_plan(fla, n: int, c: int) -> dict:
    p = fla.plan(n, c)
    return dict(p._asdict(), smem_bytes=fla.smem_bytes(p.fused, p.m_tiles, c))


def host_us(fn, iters: int = 2000) -> float:
    """Host-clock us of one call, no synchronisation (launches queue up)."""
    for _ in range(50):
        fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e6


def tail_host_steps(torch, ct, build, gen, dev):
    """Host us a call of each step the step-tail wrapper takes, and of the
    whole forward and backward wrappers of both modes, at the three level
    shapes."""
    fn = build.function("flow_kernels", "coupling_tail_step_f32")
    for h, w, c in level_shapes():
        def randn(*shape, scale=1.0):
            return torch.randn(shape, generator=gen, device=dev) * scale

        y, r, g = randn(BATCH, h, w, c), randn(BATCH, h, w, c, scale=0.5), randn(BATCH, h, w, c)
        zb, zlogs, ldj = randn(c, scale=0.2), randn(c, scale=0.2), randn(BATCH)
        half = (BATCH, h, w, c // 2)
        ls, bias, xb = randn(*half, scale=0.5), randn(*half), randn(*half)
        out, ldj_out = torch.empty_like(y), torch.empty_like(ldj)
        vw = ct.vector_width(c // 2, y.data_ptr(), r.data_ptr(), out.data_ptr())
        p = ct.forward_plan(BATCH, h * w, c // 2, vw)
        steps = {
            "check_cuda_f32": lambda: build.check_cuda_f32("coupling_step_tail", y, r, zb,
                                                           zlogs, ldj),
            "_check_step": lambda: ct._check_step("coupling_step_tail", y, r, zb, zlogs, ldj),
            "torch.empty_like (out, ldj)": lambda: (torch.empty_like(y), torch.empty_like(ldj)),
            "vector_width": lambda: ct.vector_width(c // 2, y.data_ptr(), r.data_ptr(),
                                                    out.data_ptr()),
            "forward_plan": lambda: ct.forward_plan(BATCH, h * w, c // 2, vw),
            "build.launch": lambda: build.launch(
                "coupling_tail", fn, dev, y.data_ptr(), r.data_ptr(), zb.data_ptr(),
                zlogs.data_ptr(), ldj.data_ptr(), out.data_ptr(), ldj_out.data_ptr(),
                BATCH, h * w, c, p.vw, p.threads, p.blocks),
            "step tail wrapper": lambda: ct.coupling_step_tail(y, r, zb, zlogs, ldj),
            "inverse step tail wrapper": lambda: ct.coupling_step_tail_inverse(y, r, zb, zlogs),
            "step tail backward wrapper": lambda: ct.coupling_step_tail_bwd(y, r, zb, zlogs,
                                                                            g, ldj),
            "plain-operand wrapper": lambda: ct.coupling_tail(ls, bias, xb),
            "plain-operand backward wrapper": lambda: ct.coupling_tail_bwd(
                ls, bias, xb, g[..., : c // 2].contiguous(), ldj)}
        host = {}
        for name, step in steps.items():
            host[name] = host_us(step, 500)
            torch.cuda.synchronize()
        emit({"phase": "host_steps", "name": "coupling_tail", "x": [BATCH, h, w, c],
              "plan": p._asdict(), "host_us": host})


def phase_wrapper_host_steps(torch, cm, ct, fla, build):
    """Host us a call of each step the channel_mix wrapper and the step-tail
    wrapper take, at the three level shapes, and of the attention wrappers'
    (forward and backward), at N 64 C 64, beside the library call and the
    stream lookup the launch helper avoids."""
    gen = torch.Generator(device="cuda").manual_seed(99)
    dev = torch.device("cuda", torch.cuda.current_device())
    tail_host_steps(torch, ct, build, gen, dev)
    mix = build.function("flow_kernels", "channel_mix_f32")
    for h, w, c in level_shapes():
        x = torch.randn((BATCH, h, w, c), generator=gen, device=dev)
        wt = torch.randn((c, c), generator=gen, device=dev) * c ** -0.5
        bias = torch.randn((c,), generator=gen, device=dev)
        x2d, n = x.view(-1, c), x.numel() // c
        y = torch.empty_like(x)
        p = cm.plan(n, c, c)
        steps = {
            "check_cuda_f32": lambda: build.check_cuda_f32("channel_mix", x, wt, bias),
            "torch.empty_like": lambda: torch.empty_like(x),
            "plan": lambda: cm.plan(n, c, c, True),
            "torch.cuda.current_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
            "torch._C._cuda_getCurrentRawStream":
                lambda: torch._C._cuda_getCurrentRawStream(dev.index),
            "build.launch": lambda: build.launch(
                "channel_mix", mix, dev, x.data_ptr(), wt.data_ptr(), bias.data_ptr(),
                y.data_ptr(), n, c, c, 0, p.variant, p.rows_per_block),
            "channel_mix wrapper": lambda: cm.channel_mix(x, wt, bias),
            "torch.addmm": lambda: torch.addmm(bias, x2d, wt.T)}
        emit({"phase": "host_steps", "name": "channel_mix", "x": [BATCH, h, w, c],
              "host_us": {name: host_us(fn) for name, fn in steps.items()}})
        torch.cuda.synchronize()
    x = torch.randn((BATCH, 8, 8, 64), generator=gen, device=dev)
    args = (x, torch.randn((64, 384), generator=gen, device=dev) * 0.125,
            torch.randn((128, 64), generator=gen, device=dev) * 128 ** -0.5,
            torch.randn((64,), generator=gen, device=dev) * 0.1,
            1.0 + torch.randn((64,), generator=gen, device=dev) * 0.1)
    steps = {"checks": lambda: fla._check("fused_linear_attention", *args, 4, 32),
             "plan": lambda: fla.plan(64, 64),
             "attention wrapper": lambda: fla.fused_linear_attention(*args)}
    emit({"phase": "host_steps", "name": "fused_linear_attention", "x": [BATCH, 8, 8, 64],
          "host_us": {name: host_us(fn, 500) for name, fn in steps.items()}})
    torch.cuda.synchronize()
    # the backward's wrapper at the same shape; each step runs 110 times, so
    # that its kernels (six a whole gradient) stay within the launch queue
    dout = torch.randn_like(x)
    _, ctx, stats = fla._forward_kernel(*args)
    outs = fla._backward_kernel(*args, ctx, stats, dout)
    p = fla.bwd_plan(64, 64)
    tiles = 1 if p.fused else -(-64 // (16 * p.m_tiles))
    dctx_part = torch.empty((0 if p.fused else BATCH * tiles * 4 * 32 * 32,), device=dev)
    size = sum(t.numel() for t in outs) + dctx_part.numel()
    ptrs = [t.data_ptr() for t in (*args, ctx, stats, dout, *outs, dctx_part)]
    bwd = build.function("attention_kernels", "fused_linear_attention_bwd_f32")
    steps = {"checks": lambda: fla._check("fused_linear_attention_bwd", *args, 4, 32),
             "bwd_plan": lambda: fla.bwd_plan(64, 64),
             "allocation": lambda: torch.empty((size,), device=dev),
             "build.launch": lambda: build.launch(
                 "fused_linear_attention_bwd", bwd, dev, *ptrs, BATCH, 64, 64,
                 int(p.fused), p.m_tiles, 1),
             "_backward_kernel": lambda: fla._backward_kernel(*args, ctx, stats, dout),
             "library products": lambda: fla._library_products(x, args[1], *outs),
             "backward wrapper": lambda: fla.fused_linear_attention_bwd(*args, ctx, stats, dout)}
    host = {}
    for name, fn in steps.items():
        host[name] = host_us(fn, 60)
        torch.cuda.synchronize()
    emit({"phase": "host_steps", "name": "fused_linear_attention_bwd",
          "x": [BATCH, 8, 8, 64], "plan": p._asdict(), "host_us": host})


ZERO_INIT = ("actnorm", "an1", "an2", "zconv", "conv", "prior")
ZERO_INIT_SCALES = {"scale": 0.05, "bias": 0.1, "w": 0.02, "b": 0.05, "logs": 0.05}


def randomize_zero_leaves(torch, params, seed: int):
    """Give the leaves that init leaves at zero (the step and coupling-CNN
    actnorms, zeroconvs, split priors, final prior) small seeded values, so
    no kernel sees a trivial input. The 1x1 convs and the coupling CNN's
    first two convs keep their init."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def walk(node, inside):
        if isinstance(node, list):
            for v in node:
                walk(v, inside)
        elif isinstance(node, dict):
            for k, v in node.items():
                if not isinstance(v, torch.Tensor):
                    walk(v, inside or k in ZERO_INIT)
                elif inside:
                    v.add_(torch.randn(v.shape, generator=gen, device="cuda")
                           * ZERO_INIT_SCALES[k])

    walk(params, False)


def randomize_unet_vectors(torch, unets, seed: int):
    """Move the UNets' biases and norm gains (init: zeros and ones) by small
    seeded amounts, so the attention kernel's b_out and g are not trivial."""
    gen = torch.Generator(device=next(unets[0].parameters()).device).manual_seed(seed)
    with torch.no_grad():
        for unet in unets:
            for p in unet.parameters():
                if p.dim() == 1:
                    p.add_(torch.randn(p.shape, generator=gen, device=p.device) * 0.05)


def counts(counters) -> dict:
    return {fn.__name__: fn.launches for fn in counters}


def http_request(port_no, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port_no, timeout=600)
    try:
        conn.request(method, path, body=None if body is None else json.dumps(body))
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def serve_and_check(serve, argv, counters, per_chunk: dict, kind: str):
    """Start the server of `argv` on 127.0.0.1, check /health and three
    /generate requests (64 with seed 7, the same again, 100 with seed 3):
    uint8 samples of the right shape, launches of exactly `per_chunk` per
    64-image chunk, the same bytes for the same seed, other samples for
    another seed. Returns (warm-up seconds, per-request records)."""
    import numpy as np

    with serving(serve, argv) as (port_no, health):
        check(health["status"] == "ok" and health["kind"] == kind, f"/health failed: {health}")
        got = [generate(port_no, req, counters, per_chunk)
               for req in ({"n": 64, "seed": 7}, {"n": 64, "seed": 7}, {"n": 100, "seed": 3})]
    check(np.array_equal(got[0][0], got[1][0]), "the same seed gave different samples")
    check(not np.array_equal(got[0][0][:64], got[2][0][:64]),
          "different seeds gave the same samples")
    return health["warmup_seconds"], [rec for _, rec in got]


def glow_path(torch, np, params, counters):
    """Phases 4-6; returns the launches of the path."""
    from nfdpm_tpu_torch import convert, inference, serve
    from nfdpm_tpu_torch.models import glow as glow_m

    device = torch.device("cuda")
    cfg = glow_m.GlowConfig(levels=LEVELS, steps=STEPS, coupling_width=WIDTH)
    plain_cfg = glow_m.GlowConfig(levels=LEVELS, steps=STEPS, coupling_width=WIDTH,
                                  use_kernels=False)
    imgs = np.random.default_rng(2).integers(0, 256, (BATCH, IMG, IMG, 3), dtype=np.uint8)
    batch = torch.from_numpy(imgs.astype(np.float32) / 255.0).to(device)
    noise = torch.rand(batch.shape, generator=torch.Generator(device="cuda").manual_seed(3),
                       device=device)

    for fn in counters:
        fn.launches = 0

    # 4. scoring
    eval_k = inference.make_eval_step(cfg, N_BITS, device=device)
    eval_p = inference.make_eval_step(plain_cfg, N_BITS, device=device)
    bpd_k, bpd_p = eval_k(params, batch, noise=noise), eval_p(params, batch, noise=noise)
    check(bool(torch.isfinite(bpd_k).all()) and tuple(bpd_k.shape) == (BATCH,),
          "bits/dim not finite or of the wrong shape")
    gap = float((bpd_k - bpd_p).abs().max())
    check(gap <= 1e-4, f"kernel and plain bits/dim differ by {gap}")
    launches_fwd = counts(counters)
    check(launches_fwd == {"channel_mix": 3 * STEPS, "coupling_tail": 3 * STEPS,
                           "coupling_tail_bwd": 0, "coupling_tail_inverse": 0,
                           "fused_linear_attention": 0, "fused_linear_attention_bwd": 0,
                           "step_megakernel_forward": 0},
          f"one forward launched {launches_fwd}")
    ms_k = host_ms(torch, lambda: eval_k(params, batch, noise=noise))
    ms_p = host_ms(torch, lambda: eval_p(params, batch, noise=noise))
    emit({"phase": "scoring", "bpd_mean": float(bpd_k.mean()), "max_bpd_gap": gap,
          "tolerance": 1e-4, "ms_per_batch": ms_k, "plain_ms_per_batch": ms_p,
          "batch": BATCH, "launches_one_forward": launches_fwd})

    # 5. round trip
    with torch.inference_mode():
        x = torch.rand((BATCH, IMG, IMG, 3), generator=torch.Generator(device="cuda")
                       .manual_seed(4), device=device) - 0.5
        latents, _, _ = glow_m.forward(params["flow"], cfg, x)
        back = glow_m.inverse(params["flow"], cfg, latents)
        rt = float((back - x).abs().max())
    check(rt <= 2e-3, f"inverse(forward(x)) is off by {rt}")
    emit({"phase": "round_trip", "max_abs_err": rt, "tolerance": 2e-3})

    # 6. serving
    weights = ROOT / "build" / "chip_smoke" / "glow.npz"
    weights.parent.mkdir(parents=True, exist_ok=True)
    convert.save_npz(weights, convert.to_jax_params(params))
    warmup, results = serve_and_check(
        serve, ["--weights", str(weights), "--levels", str(LEVELS), "--steps", str(STEPS),
                "--width", str(WIDTH), "--img-size", str(IMG), "--n-bits", str(N_BITS)],
        counters, {"channel_mix": 12, "coupling_tail": 0, "coupling_tail_bwd": 0,
                   "coupling_tail_inverse": 12, "fused_linear_attention": 0,
                   "fused_linear_attention_bwd": 0, "step_megakernel_forward": 0}, "gaussian")
    launches = counts(counters)
    emit({"phase": "serving", "warmup_s": warmup, "requests": results,
          "main_path_launches": launches})
    for name in ("channel_mix", "coupling_tail", "coupling_tail_inverse"):
        check(launches[name] > 0, f"{name} was never launched on the Glow path")
    return launches


def kernel_events(torch, fn):
    """The CUDA activities (kernels, copies, fills) of one call of `fn`, in
    the order they ran on the card: [(name, device us)], from
    torch.profiler, after one call that is not recorded; a trace with no
    device event is taken again, up to three times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # the profiler now and then hands back a trace without a single device
    # event; the call itself launched its work all the same, so trace it again
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA and e.device_time > 0]
        if events:
            break
    events.sort(key=lambda e: e.time_range.start)
    return [(e.name, e.device_time) for e in events]


def short_names(events, width: int = 60):
    return [name[:width] for name, _ in events]


def phase_tail_route(torch):
    """The Glow step's kernel routes (bijectors.step_forward_kernels and
    bijectors.step_inverse_kernels) at the three level shapes, batch 64,
    width 512: the CUDA activities of one forward, of one forward and
    backward, and of one inverse, in order, their count and device us (the
    profiler's sum). The forward must end with the zeroconv's convolution
    and one step-tail launch, nothing between them or after; the forward
    and backward must launch one tail kernel each way; the inverse must end
    with the zeroconv's convolution, one inverse-tail launch and the channel
    mix, nothing between them or after. (Phases 3 and 11 time the tail
    kernels at these shapes; tools/profile_coupling_tails.py times the
    routes in any checkout of the port.)"""
    from nfdpm_tpu_torch.convert import is_frozen_path, named_leaves
    from nfdpm_tpu_torch.ops import bijectors as bj
    from nfdpm_tpu_torch.ops.zeroconv import conv2d_nhwc

    gen = torch.Generator(device="cuda").manual_seed(77)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    for h, w, c in level_shapes():
        params = random_step(torch, bj, c, WIDTH, seed=c)
        x, ldj0 = randn(BATCH, h, w, c), randn(BATCH, scale=10.0)
        with torch.no_grad():
            seq = kernel_events(torch, lambda: bj.step_forward_kernels(params, x, ldj0))
            seq_inv = kernel_events(torch, lambda: bj.step_inverse_kernels(params, x))
            zc = params["coupling"]["net"]["zconv"]
            h2 = randn(BATCH, h, w, WIDTH)
            conv_names = {n for n, _ in kernel_events(
                torch, lambda: conv2d_nhwc(h2, zc["w"], padding=1))}
        leaves = [leaf.requires_grad_(True) for path, leaf in named_leaves(params)
                  if not is_frozen_path(path)]
        xg = x.clone().requires_grad_(True)
        gy, gl = randn(BATCH, h, w, c), randn(BATCH)

        def fwd_bwd():
            y, ldj = bj.step_forward_kernels(params, xg, ldj0)
            return torch.autograd.grad((y, ldj), leaves + [xg], (gy, gl))

        seq_fb = kernel_events(torch, fwd_bwd)
        tails = [n for n, _ in seq if "coupling_tail" in n]
        tails_fb = [n for n, _ in seq_fb if "coupling_tail" in n]
        tails_inv = [n for n, _ in seq_inv if "coupling_tail" in n]
        check(len(tails) == 1 and "coupling_tail" in seq[-1][0] and len(seq) > 1
              and seq[-2][0] in conv_names,
              f"the step's forward at {(h, w, c)} does not end with the zeroconv's "
              f"convolution and one tail launch: {short_names(seq[-4:])}")
        check(len(tails_fb) == 2,
              f"the step's forward and backward launched {tails_fb} at {(h, w, c)}")
        check(len(tails_inv) == 1 and len(seq_inv) > 2
              and "coupling_tail_inverse" in seq_inv[-2][0]
              and "channel_mix" in seq_inv[-1][0] and seq_inv[-3][0] in conv_names,
              f"the step's inverse at {(h, w, c)} does not end with the zeroconv's "
              f"convolution, one inverse-tail launch and the channel mix: "
              f"{short_names(seq_inv[-4:])}")
        emit({"phase": "tail_route", "x": [BATCH, h, w, c], "width": WIDTH,
              "step_fwd_launches": len(seq),
              "step_fwd_profiler_device_us": sum(us for _, us in seq),
              "step_fwd_bwd_launches": len(seq_fb),
              "step_fwd_bwd_profiler_device_us": sum(us for _, us in seq_fb),
              "step_inv_launches": len(seq_inv),
              "step_inv_profiler_device_us": sum(us for _, us in seq_inv),
              "step_fwd_kernels": short_names(seq), "step_fwd_bwd_kernels": short_names(seq_fb),
              "step_inv_kernels": short_names(seq_inv)})
        for leaf in leaves:
            leaf.requires_grad_(False)


MEGA_Y_TOL, MEGA_LDJ_ATOL = 1e-5, 1e-3  # the JAX package's test of the TPU kernel


def megakernel_bytes_ops(b: int, h: int, w: int, c: int, d: int):
    """Bytes and fp32 operations of one whole-step call: x read and y written
    once, every weight once, ldj; per pixel the mix (C x C), the first conv
    (9 x C/2 x D), the 1x1 conv (D x D) and the zeroconv (9 x D x C), an FMA
    counted as two operations (the tail's few per channel left out)."""
    n, half = b * h * w, c // 2
    weights = c * c + c + 9 * half * d + 2 * d + d * d + 2 * d + 9 * d * c + 2 * c
    return 4 * (2 * n * c + weights + b), 2 * n * (c * c + 9 * half * d + d * d + 9 * d * c)


def random_step(torch, bj, c: int, width: int, seed: int):
    """One Glow step of the port's init at C channels and hidden width
    `width`, its zero-initialised leaves given small seeded values."""
    from nfdpm_tpu_torch.convert import tree_to_device

    params = tree_to_device(bj.init_step(seed, c, width), torch.device("cuda"))
    randomize_zero_leaves(torch, params, seed)
    return params


def phase_megakernel(torch, sm, bj):
    """The whole-step megakernel against its plain version and against the
    step the Glow path runs (bijectors.step_forward_kernels: channel_mix,
    cuDNN coupling CNN, coupling_tail) at the three level shapes, the JAX
    package's test case and a ragged one; returns its per-pass summary."""
    gen = torch.Generator(device="cuda").manual_seed(4321)
    cases = [(BATCH, h, w, c, WIDTH, True) for (h, w, c) in level_shapes()]
    cases += [(5, 16, 16, 12, 64, False),  # tests/test_pallas_kernels.py's case
              (7, 5, 9, 14, 44, False),   # odd B, H and W; C and width not multiples of 8
              (16, 2, 2, 48, 512, False)]  # blocks of four whole images
    timed = ("ms", "device_ms", "pack_device_ms", "plain_ms", "plain_device_ms",
             "route_ms", "route_device_ms", "step_ms", "step_device_ms")
    tot = dict({k: 0.0 for k in timed}, bytes=0.0, ops=0.0, max_abs_err=0.0)
    for b, h, w, c, d, on_path in cases:
        params = random_step(torch, bj, c, d, seed=b + c)
        wf, bf, _ = bj.fold_actnorm_invconv(params["actnorm"], params["invconv"])
        net = params["coupling"]["net"]
        x = torch.randn((b, h, w, c), generator=gen, device="cuda")
        ldj0 = torch.zeros((b,), device="cuda")
        with torch.no_grad():
            y_k, l_k = sm.step_megakernel_forward(x, wf, bf, net)
            y_p, l_p = sm.step_megakernel_forward_plain(x, wf, bf, net)
            y_2, l_2 = sm.step_megakernel_forward(x, wf, bf, net)
        torch.cuda.synchronize()
        y_err, l_err = float((y_k - y_p).abs().max()), float((l_k - l_p).abs().max())
        check(torch.allclose(y_k, y_p, rtol=MEGA_Y_TOL, atol=MEGA_Y_TOL)
              and torch.allclose(l_k, l_p, rtol=1e-5, atol=MEGA_LDJ_ATOL),
              f"step_megakernel differs from its plain version at {(b, h, w, c, d)}: "
              f"y {y_err}, ldj {l_err}")
        check(torch.equal(y_k, y_2) and torch.equal(l_k, l_2),
              f"two step_megakernel calls differ at {(b, h, w, c, d)}")
        plan = sm.plan(b, h, w, c, d)
        record = {"phase": "kernel", "name": "step_megakernel",
                  "version": KERNEL_VERSIONS["step_megakernel"], "x": [b, h, w, c],
                  "width": d, "on_path": on_path, "launches_per_pass": STEPS if on_path else 0,
                  "y_max_abs_err": y_err, "ldj_max_abs_err": l_err,
                  "max_abs_err": max(y_err, l_err), "plan": plan._asdict(),
                  "halo_waste": sm.halo_waste(plan, b, h, w)}
        if on_path:
            packed = sm.pack(wf, bf, net, c)
            with torch.no_grad():
                fns = {"": lambda: sm.step_megakernel_forward(x, wf, bf, net),
                       "plain_": lambda: sm.step_megakernel_forward_plain(x, wf, bf, net),
                       "route_": lambda: bj.step_forward_kernels(params, x, ldj0),
                       "step_": lambda: bj.step_forward_megakernel(params, x, ldj0)}
                times = {}
                for key, fn in fns.items():
                    times[f"{key}ms"] = cuda_ms(fn, iters=50, warmup=5)
                    times[f"{key}device_ms"] = graph_ms(fn, calls=10, replays=10)
                # the kernel alone, its weights packed once, and the packing
                times["device_ms"] = graph_ms(lambda: sm.launch(x, packed, d), calls=10,
                                              replays=10)
                times["pack_device_ms"] = graph_ms(lambda: sm.pack(wf, bf, net, c), calls=10,
                                                   replays=10)
            nbytes, ops = megakernel_bytes_ops(b, h, w, c, d)
            b_ms, b_by = bound_ms(nbytes, ops)
            record.update(times, bound_ms=b_ms, bound_by=b_by, bytes=nbytes, ops=ops,
                          tensor_core_bound_ms=3 * ops / TF32_FLOPS_PER_S * 1e3)
            tot["bytes"] += STEPS * nbytes
            tot["ops"] += STEPS * ops
            for key in timed:
                tot[key] += STEPS * times[key]
        tot["max_abs_err"] = max(tot["max_abs_err"], y_err, l_err)
        emit(record)
    tot["bound_ms"], tot["bound_by"] = bound_ms(tot["bytes"], tot["ops"])
    # its route: every product in 3xTF32 on the tensor cores
    tot["tensor_core_bound_ms"] = 3 * tot["ops"] / TF32_FLOPS_PER_S * 1e3
    tot["library_ms"] = tot["library_device_ms"] = None  # no one PyTorch call is a Glow step
    return tot


def megakernel_glow_forward(bj, flow, x):
    """glow.forward's level walk (models/glow.py) with every step through
    bijectors.step_forward_megakernel: (latent parts, ldj, logp)."""
    import torch

    ldj = torch.zeros((x.shape[0],), dtype=torch.float32, device=x.device)
    logp = torch.zeros_like(ldj)
    latents, y = [], x
    for block in flow["blocks"]:
        y = bj.squeeze_forward(y)
        for sp in block["steps"]:
            y, ldj = bj.step_forward_megakernel(sp, y, ldj)
        y, ldj, z, logp = bj.split_forward(block["split"], y, ldj, logp)
        latents.append(z)
    y = bj.squeeze_forward(y)
    for sp in flow["final_steps"]:
        y, ldj = bj.step_forward_megakernel(sp, y, ldj)
    latents.append(y)
    return latents, ldj, logp


def phase_megakernel_glow(torch, np, params, counters):
    """The full-width Glow scoring forward with its 12 steps chained through
    the megakernel, against inference.make_eval_step's kernel route on the
    same batch and dequantization draw; returns the launches of the path."""
    from nfdpm_tpu_torch import inference
    from nfdpm_tpu_torch.models import glow as glow_m
    from nfdpm_tpu_torch.models import prior as prior_m
    from nfdpm_tpu_torch.ops import bijectors as bj
    from nfdpm_tpu_torch.ops import quantize as q

    device = torch.device("cuda")
    cfg = glow_m.GlowConfig(levels=LEVELS, steps=STEPS, coupling_width=WIDTH)
    plain_cfg = glow_m.GlowConfig(levels=LEVELS, steps=STEPS, coupling_width=WIDTH,
                                  use_kernels=False)
    # the batch and the draw of phase 4
    imgs = np.random.default_rng(2).integers(0, 256, (BATCH, IMG, IMG, 3), dtype=np.uint8)
    batch = torch.from_numpy(imgs.astype(np.float32) / 255.0).to(device)
    noise = torch.rand(batch.shape, generator=torch.Generator(device="cuda").manual_seed(3),
                       device=device)
    flow = params["flow"]
    x = q.dequantize(None, q.preprocess(batch, N_BITS), N_BITS, noise)
    bpd_ref = inference.make_eval_step(cfg, N_BITS, device=device)(params, batch, noise=noise)
    with torch.inference_mode():
        lat_ref, _, _ = glow_m.forward(flow, cfg, x)

    for fn in counters:
        fn.launches = 0
    with torch.inference_mode():
        lat, ldj, logp = megakernel_glow_forward(bj, flow, x)
        ll = ldj + logp + prior_m.gaussian_prior_logp(params["prior"], lat[-1])
    torch.cuda.synchronize()
    launches = counts(counters)
    check(launches == {"channel_mix": 0, "coupling_tail": 0, "coupling_tail_bwd": 0,
                       "coupling_tail_inverse": 0, "fused_linear_attention": 0,
                       "fused_linear_attention_bwd": 0,
                       "step_megakernel_forward": LEVELS * STEPS},
          f"the chained forward launched {launches}")
    n_pixel = prior_m.n_pixels(IMG, 3)
    bpd = (np.log(2.0 ** N_BITS) * n_pixel - ll) * (np.log2(np.e) / n_pixel)
    check(bool(torch.isfinite(bpd).all()) and tuple(bpd.shape) == (BATCH,),
          "chained bits/dim not finite or of the wrong shape")
    gap = float((bpd - bpd_ref).abs().max())
    check(gap <= 1e-4, f"chained and kernel-route bits/dim differ by {gap}")
    latent_gaps = [float((a - b).abs().max()) for a, b in zip(lat, lat_ref)]
    check(len(lat) == len(lat_ref) and max(latent_gaps) <= 1e-4,
          f"chained and kernel-route latents differ by {latent_gaps}")
    refused = False
    try:
        with torch.enable_grad():
            bj.step_forward_megakernel(flow["blocks"][0]["steps"][0],
                                       bj.squeeze_forward(x).requires_grad_(True),
                                       torch.zeros((BATCH,), device=device))
    except RuntimeError as err:
        refused = "no gradient" in str(err)
    check(refused, "step_forward_megakernel did not refuse a gradient")
    check(launches == counts(counters), "the refused call launched a kernel")

    def chained():
        with torch.inference_mode():
            return megakernel_glow_forward(bj, flow, x)

    def route(c):
        def run():
            with torch.inference_mode():
                return glow_m.forward(flow, c, x)
        return run

    times = {}
    for key, fn in (("megakernel", chained), ("kernel_route", route(cfg)),
                    ("plain_route", route(plain_cfg))):
        times[f"{key}_device_ms"] = graph_ms(fn, calls=3, replays=5)
        times[f"{key}_wall_ms"] = host_ms(torch, fn)
    emit({"phase": "megakernel_glow", "batch": BATCH, "bpd_mean": float(bpd.mean()),
          "max_bpd_gap": gap, "max_latent_gap_per_part": latent_gaps, "tolerance": 1e-4,
          "launches_one_forward": launches, "refuses_gradient": refused, **times})
    return launches


def stage2_prior(use_kernels: bool = True, unet_overrides=None, **diffusion_overrides):
    from nfdpm_tpu_torch.models import formaters
    from nfdpm_tpu_torch.models.diffusion_prior import DiffusionPrior

    formater = formaters.get_formater(FORMATER)(L=LEVELS, in_channels=3, size=IMG)
    ukw = dict(UNET_KWARGS, dim_mults=tuple(UNET_KWARGS["dim_mults"]), **(unet_overrides or {}))
    return DiffusionPrior(formater, ukw, dict(DIFFUSION_KWARGS, **diffusion_overrides),
                          use_kernels=use_kernels)


def stage2_model(torch, flow):
    """(backbone, prior, plain backbone, plain prior, params): the stage-2
    model over `flow`, its UNets seeded, both routes sharing the weights."""
    from nfdpm_tpu_torch.models import glow as glow_m
    from nfdpm_tpu_torch.models.nf_backbone import NFBackbone

    routes = []
    for use_kernels in (True, False):
        cfg = glow_m.GlowConfig(levels=LEVELS, steps=STEPS, coupling_width=WIDTH,
                                use_kernels=use_kernels)
        routes += [NFBackbone(cfg=cfg, img_size=IMG), stage2_prior(use_kernels)]
    diffusion = routes[1].init_params(seed=5, device="cuda")
    randomize_unet_vectors(torch, diffusion["parts"], seed=6)
    return (*routes, {"flow": flow, "prior": {}, "diffusion": diffusion})


def stage2_path(torch, np, flow, counters):
    """Phases 7-9; returns (the launches of the path, the stage-2 model)."""
    from nfdpm_tpu_torch import convert, inference, serve

    device = torch.device("cuda")
    backbone, dp, backbone_p, dp_p, params = stage2_model(torch, flow)
    blocks = 2 * len(UNET_KWARGS["dim_mults"])  # linear-attention blocks per UNet
    parts, steps = dp.num_parts, DIFFUSION_KWARGS["sampling_timesteps"]
    chunk = DIFFUSION_KWARGS["vlb_time_chunk"]
    vlb_calls = -(-DIFFUSION_KWARGS["timesteps"] // chunk)
    imgs = np.random.default_rng(8).integers(0, 256, (VLB_BATCH, IMG, IMG, 3), dtype=np.uint8)
    batch = torch.from_numpy(imgs.astype(np.float32) / 255.0).to(device)

    for fn in counters:
        fn.launches = 0

    # 7. stage-2 scoring
    vlb_k = inference.make_vlb_eval_step(backbone, dp, N_BITS, device=device)
    vlb_p = inference.make_vlb_eval_step(backbone_p, dp_p, N_BITS, device=device)
    out = {}
    for route, step in (("kernels", vlb_k), ("plain", vlb_p)):
        before = counts(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bpd = step(params, batch, generator=torch.Generator(device="cuda").manual_seed(9))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        after = counts(counters)
        out[route] = (bpd, ms, {k: after[k] - before[k] for k in before})
    (bpd_k, ms_k, launches_k), (bpd_p, ms_p, launches_p) = out["kernels"], out["plain"]
    check(bool(torch.isfinite(bpd_k).all()) and tuple(bpd_k.shape) == (VLB_BATCH,),
          "stage-2 bits/dim not finite or of the wrong shape")
    gap = float((bpd_k - bpd_p).abs().max())
    check(gap <= VLB_TOL, f"kernel and plain stage-2 bits/dim differ by {gap}")
    check(launches_k == {"channel_mix": 3 * STEPS, "coupling_tail": 3 * STEPS,
                         "coupling_tail_bwd": 0, "coupling_tail_inverse": 0,
                         "fused_linear_attention": parts * vlb_calls * blocks,
                         "fused_linear_attention_bwd": 0, "step_megakernel_forward": 0},
          f"one VLB batch launched {launches_k}")
    check(not any(launches_p.values()), f"the plain route launched {launches_p}")
    emit({"phase": "stage2_scoring", "batch": VLB_BATCH, "timesteps":
          DIFFUSION_KWARGS["timesteps"], "vlb_time_chunk": chunk,
          "bpd": bpd_k.tolist(), "bpd_plain": bpd_p.tolist(), "max_bpd_gap": gap,
          "tolerance": VLB_TOL, "ms_per_batch": ms_k, "plain_ms_per_batch": ms_p,
          "launches_per_batch": launches_k})

    # 8. stage-2 sampling
    sample_k = inference.make_diffusion_sample_fn(backbone, dp, N_BITS, device)
    sample_p = inference.make_diffusion_sample_fn(backbone_p, dp_p, N_BITS, device)
    out = {}
    for route, sample in (("kernels", sample_k), ("plain", sample_p)):
        before = counts(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        images, latents = sample(params, BATCH, return_latents=True,
                                 generator=torch.Generator(device="cuda").manual_seed(10))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        after = counts(counters)
        out[route] = (images, latents, ms, {k: after[k] - before[k] for k in before})
    (img_k, lat_k, ms_k, launches_k), (img_p, lat_p, ms_p, _) = out["kernels"], out["plain"]
    check(img_k.dtype == torch.uint8 and tuple(img_k.shape) == (BATCH, IMG, IMG, 3),
          f"stage-2 samples are {img_k.dtype} {tuple(img_k.shape)}")
    check([tuple(z.shape[1:]) for z in lat_k] == list(dp.formater.input_shapes)
          and all(bool(torch.isfinite(z).all()) for z in lat_k),
          "stage-2 latents not finite or of the wrong shapes")
    per_chunk = {"channel_mix": 3 * STEPS, "coupling_tail": 0, "coupling_tail_bwd": 0,
                 "coupling_tail_inverse": 3 * STEPS,
                 "fused_linear_attention": parts * steps * blocks,
                 "fused_linear_attention_bwd": 0, "step_megakernel_forward": 0}
    check(launches_k == per_chunk, f"one 64-image chunk launched {launches_k}")
    latent_gap = max(float((a - b).abs().max()) for a, b in zip(lat_k, lat_p))
    pixels = img_k.to(torch.int16) - img_p.to(torch.int16)
    pixel_share = float((pixels != 0).float().mean())
    check(latent_gap <= LATENT_TOL, f"kernel and plain latents differ by {latent_gap}")
    check(pixel_share <= PIXEL_SHARE_TOL,
          f"{pixel_share} of the kernel and plain pixels differ")
    emit({"phase": "stage2_sampling", "batch": BATCH, "sampler": "ddim",
          "sampling_timesteps": steps, "max_latent_gap": latent_gap,
          "latent_tolerance": LATENT_TOL, "differing_pixel_share": pixel_share,
          "max_pixel_diff": int(pixels.abs().max()), "pixel_share_tolerance": PIXEL_SHARE_TOL,
          "latent_abs_max": [float(z.abs().max()) for z in lat_k],
          "ms_per_chunk": ms_k, "plain_ms_per_chunk": ms_p,
          "images_per_s": BATCH / ms_k * 1e3, "plain_images_per_s": BATCH / ms_p * 1e3,
          "launches_per_chunk": launches_k})

    # 9. stage-2 serving
    weights = ROOT / "build" / "chip_smoke" / "diffusion.npz"
    arch = weights.with_name("diffusion_architecture.json")
    weights.parent.mkdir(parents=True, exist_ok=True)
    convert.save_npz(weights, convert.diffusion_to_jax_params(params))
    arch.write_text(json.dumps(stage2_architecture(), indent=1))
    warmup, results = serve_and_check(serve, ["--weights", str(weights), "--arch", str(arch)],
                                      counters, per_chunk, "diffusion")
    launches = counts(counters)
    emit({"phase": "stage2_serving", "warmup_s": warmup, "requests": results,
          "main_path_launches": launches})
    check(launches["fused_linear_attention"] > 0,
          "fused_linear_attention was never launched on the stage-2 path")
    return launches, (backbone, dp, backbone_p, dp_p, params, batch)


PROFILE_SAMPLING_STEPS = 10  # DDIM-10 chunk: 30 UNet calls at batch 64
PROFILE_TIMESTEPS = 40       # VLB at T = 40: 30 UNet calls at 4 * VLB_BATCH rows
PROFILE_ROUNDS = 3           # timed calls of each route, taken in turns (a depth cut
# that keeps the run within 800 s; PERF.md §7)


def phase_profile(torch, model, fla, unet_shapes):
    """Where the time goes in stage-2 sampling and scoring, on each route.
    The chains are cut to 30 UNet calls each (PROFILE_*), every call at the
    shapes of the full chains, so that the profiler's event list stays
    small; per UNet call the work is that of the full chains. Each route is
    called once to warm it, then PROFILE_ROUNDS times each in turns (kernel,
    plain, plain, kernel, ...), each call synchronised: wall ms median and
    spread; then one profiled call each (device ms, busy share, kernels).
    Last, the attention wrapper's host us at the VLB's shapes."""
    from nfdpm_tpu_torch import inference
    from nfdpm_tpu_torch.profiling import profile_call

    backbone, _, backbone_p, _, params, batch = model
    device = torch.device("cuda")
    work = {}
    for route, bb in (("kernels", backbone), ("plain", backbone_p)):
        use_kernels = route == "kernels"
        sample = inference.make_diffusion_sample_fn(
            bb, stage2_prior(use_kernels, sampling_timesteps=PROFILE_SAMPLING_STEPS),
            N_BITS, device)
        vlb = inference.make_vlb_eval_step(
            bb, stage2_prior(use_kernels, timesteps=PROFILE_TIMESTEPS,
                             sampling_timesteps=PROFILE_TIMESTEPS), N_BITS, device=device)
        gen = torch.Generator(device="cuda").manual_seed(11)
        work[route] = {"sample": lambda s=sample, g=gen: s(params, BATCH, generator=g),
                       "score": lambda v=vlb, g=gen: v(params, batch, generator=g)}
    chunk = DIFFUSION_KWARGS["vlb_time_chunk"]
    what = {"sample": (BATCH, f"DDIM-{PROFILE_SAMPLING_STEPS} chunk",
                       LEVELS * PROFILE_SAMPLING_STEPS),
            "score": (VLB_BATCH, f"VLB batch at T = {PROFILE_TIMESTEPS}",
                      LEVELS * -(-PROFILE_TIMESTEPS // chunk))}
    for path, (n, label, unet_calls) in what.items():
        walls = {"kernels": [], "plain": []}
        for route in walls:
            work[route][path]()
        for i in range(PROFILE_ROUNDS):
            for route in (("kernels", "plain") if i % 2 == 0 else ("plain", "kernels")):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                work[route][path]()
                torch.cuda.synchronize()
                walls[route].append((time.perf_counter() - t0) * 1e3)
        stats = {route: {"wall_ms_calls": w, "wall_ms_median": median_of(w),
                         "wall_ms_spread": max(w) - min(w)} for route, w in walls.items()}
        for route in walls:
            rec = profile_call(work[route][path], iters=1, warmup=0)
            emit({"phase": "profile", "path": path, "route": route, "batch": n,
                  "what": label, "unet_calls": unet_calls, **rec, **stats[route]})
        gap = stats["kernels"]["wall_ms_median"] - stats["plain"]["wall_ms_median"]
        spread = max(stats[r]["wall_ms_spread"] for r in stats)
        emit({"phase": "profile_routes", "path": path, "rounds": PROFILE_ROUNDS,
              "kernels_median_ms": stats["kernels"]["wall_ms_median"],
              "plain_median_ms": stats["plain"]["wall_ms_median"],
              "kernels_minus_plain_ms": gap, "largest_spread_ms": spread,
              "kernel_route_slower_beyond_spread": gap > spread})

    # the attention wrapper's host us at the VLB's shapes (4 x VLB_BATCH rows)
    gen = torch.Generator(device="cuda").manual_seed(12)
    calls = []
    for part, block, h, w, c in unet_shapes:
        x = torch.randn((4 * VLB_BATCH, h, w, c), generator=gen, device=device)
        args = (x, torch.randn((c, 384), generator=gen, device=device) * c ** -0.5,
                torch.randn((128, c), generator=gen, device=device) * 128 ** -0.5,
                torch.randn((c,), generator=gen, device=device) * 0.1,
                1.0 + torch.randn((c,), generator=gen, device=device) * 0.1)
        with torch.inference_mode():
            calls.append({"part": part, "block": block, "x": [4 * VLB_BATCH, h, w, c],
                          "wrapper_host_us": host_us(lambda: fla.fused_linear_attention(*args),
                                                     500),
                          "device_us": cuda_ms(lambda: fla.fused_linear_attention(*args),
                                               100, 10) * 1e3})
        torch.cuda.synchronize()
    emit({"phase": "host_steps", "name": "fused_linear_attention at the VLB shapes",
          "calls": calls})


def time_rows(rows, timed):
    """{key: time} of one case: `rows` maps a prefix ("", "plain_", "library_")
    to a callable or None; each is timed by CUDA events and by graph replay."""
    out = {}
    for prefix, fn in rows.items():
        out[f"{prefix}ms"] = cuda_ms(fn) if fn else None
        out[f"{prefix}device_ms"] = graph_ms(fn) if fn else None
    return {k: out[k] for k in timed}


def phase_backward_kernels(torch, cm, ct, totals):
    """coupling_tail_bwd against its plain version in both modes, the dx
    call of channel_mix timed beside torch.matmul, and the gradients of the
    three autograd Functions against autograd through the plain versions.
    Adds the coupling_tail_bwd summary of one backward pass (its step mode,
    4 launches at each of the 3 level shapes) and channel_mix's dx times to
    `totals`."""
    gen = torch.Generator(device="cuda").manual_seed(2345)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    cases = [(BATCH, h, w, c, STEPS, True) for (h, w, c) in level_shapes()]
    cases.append((37, 3, 5, 14, 0, False))  # ragged: N = 555, D = 105
    cases.append((5, 3, 5, 10, 0, False))   # ragged step tail: C/2 = 5
    timed = ("ms", "plain_ms", "library_ms", "device_ms", "plain_device_ms",
             "library_device_ms")
    tot = dict({t: 0.0 for t in timed}, bytes=0.0, ops=0.0, max_abs_err=0.0)
    dx = {f"dx_{t}": 0.0 for t in timed}
    tot_dx_err = [0.0]
    grad_gap = 0.0
    for b, h, w, c, per_pass, on_path in cases:
        o = c if on_path else c + 6
        half = (b, h, w, c // 2)
        d = h * w * (c // 2)
        ls, tb, xb = randn(*half, scale=0.5), randn(*half), randn(*half)
        g_y, g_ldj = randn(*half), randn(b)

        # the VJP kernel's step mode, as a train step launches it, against
        # its plain version: d_y and d_r elementwise, d_zb and d_zlogs sums
        # over up to 16384 pixels in another order (1e-4, as dW and db); the
        # same bits on a second call
        ys, rs = randn(b, h, w, c), randn(b, h, w, c, scale=0.5)
        zb, zlogs, g_out = randn(c, scale=0.2), randn(c, scale=0.2), randn(b, h, w, c)
        got = ct.coupling_step_tail_bwd(ys, rs, zb, zlogs, g_out, g_ldj)
        want = ct.coupling_step_tail_bwd_plain(ys, rs, zb, zlogs, g_out, g_ldj)
        again = ct.coupling_step_tail_bwd(ys, rs, zb, zlogs, g_out, g_ldj)
        torch.cuda.synchronize()
        gaps = {name: float((a - e).abs().max())
                for name, a, e in zip(("d_y", "d_r", "d_zb", "d_zlogs"), got, want)}
        check(all(torch.allclose(a, e, rtol=tol, atol=tol)
                  for a, e, tol in zip(got, want, (1e-5, 1e-5, 1e-4, 1e-4))),
              f"coupling_tail_bwd's step mode differs from its plain version at "
              f"{(b, h, w, c)}: {gaps}")
        check(all(torch.equal(a, e) for a, e in zip(got, again)),
              f"coupling_tail_bwd's step mode gave other bits on a second call at "
              f"{(b, h, w, c)}")
        err = max(gaps.values())
        times = time_rows(
            {"": lambda: ct.coupling_step_tail_bwd(ys, rs, zb, zlogs, g_out, g_ldj),
             "plain_": lambda: ct.coupling_step_tail_bwd_plain(ys, rs, zb, zlogs, g_out, g_ldj),
             "library_": None}, timed)
        nbytes, ops = step_tail_bytes_ops(b, b * h * w, c, backward=True)
        b_ms, b_by = bound_ms(nbytes, ops)
        emit({"phase": "kernel", "name": "coupling_tail_bwd", "mode": "step",
              "version": KERNEL_VERSIONS["coupling_tail_bwd"], "x": [b, h, w, c],
              "on_path": on_path, "launches_per_pass": per_pass, "max_abs_err": err,
              "max_abs_err_by_output": gaps, **times, "bound_ms": b_ms, "bound_by": b_by,
              "bytes": nbytes, "ops": ops,
              "plan": ct.backward_plan(b, h * w, c // 2, ct.vector_width(
                  c // 2, ys.data_ptr(), rs.data_ptr(), g_out.data_ptr()))._asdict()})
        tot["max_abs_err"] = max(tot["max_abs_err"], err)
        if on_path:
            tot["bytes"] += per_pass * nbytes
            tot["ops"] += per_pass * ops
            for key in timed:
                tot[key] += per_pass * (times[key] or 0.0)

        # the plain-operand mode against its plain version (on no path)
        k_ls, k_xb = ct.coupling_tail_bwd(ls, tb, xb, g_y, g_ldj)
        p_ls, p_xb = ct.coupling_tail_bwd_plain(ls, tb, xb, g_y, g_ldj)
        torch.cuda.synchronize()
        err = max(float((k_ls - p_ls).abs().max()), float((k_xb - p_xb).abs().max()))
        check(torch.allclose(k_ls, p_ls, rtol=1e-5, atol=1e-5)
              and torch.allclose(k_xb, p_xb, rtol=1e-5, atol=1e-5),
              f"coupling_tail_bwd differs from its plain version at {half}: {err}")
        times = time_rows({"": lambda: ct.coupling_tail_bwd(ls, tb, xb, g_y, g_ldj),
                           "plain_": lambda: ct.coupling_tail_bwd_plain(ls, tb, xb, g_y, g_ldj),
                           "library_": None}, timed)
        nbytes, ops = 4 * (6 * b * d + b), TAIL_BWD_OPS * b * d
        b_ms, b_by = bound_ms(nbytes, ops)
        emit({"phase": "kernel", "name": "coupling_tail_bwd", "mode": "plain operands",
              "version": KERNEL_VERSIONS["coupling_tail_bwd"], "x": list(half),
              "on_path": False, "launches_per_pass": 0, "max_abs_err": err,
              **times, "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "ops": ops})
        tot["max_abs_err"] = max(tot["max_abs_err"], err)

        # the dx call of channel_mix's backward: the kernel's dx mode (W read
        # untransposed, no bias); torch.matmul computes the same product in
        # one call
        g, wt = randn(b, h, w, o), randn(o, c, scale=c ** -0.5)
        g2d = g.view(-1, o)
        dx_k, dx_p = cm.channel_mix_dx(g, wt), cm.channel_mix_dx_plain(g, wt)
        torch.cuda.synchronize()
        err = float((dx_k - dx_p).abs().max())
        check(torch.allclose(dx_k, dx_p, rtol=1e-5, atol=1e-5),
              f"channel_mix's dx mode differs from its plain version at {(b, h, w, o)}: {err}")
        times = time_rows({"": lambda: cm.channel_mix_dx(g, wt),
                           "plain_": lambda: cm.channel_mix_dx_plain(g, wt),
                           "library_": lambda: torch.matmul(g2d, wt)}, timed)
        n = b * h * w
        nbytes, ops = 4 * (n * o + n * c + o * c), 2 * n * c * o
        b_ms, b_by = bound_ms(nbytes, ops)
        emit({"phase": "kernel", "name": "channel_mix", "version": KERNEL_VERSIONS["channel_mix"],
              "use": "backward dx", "x": [b, h, w, o], "on_path": on_path,
              "launches_per_pass": per_pass, "max_abs_err": err, **times,
              "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "ops": ops,
              "plan": cm.plan(n, o, c)._asdict()})
        tot_dx_err[0] = max(tot_dx_err[0], err)
        if on_path:
            for key in timed:
                dx[f"dx_{key}"] += per_pass * (times[key] or 0.0)

        # gradients of the two Functions against autograd through the plain
        # versions, both cotangents of the tail non-zero
        x = randn(b, h, w, c).requires_grad_(True)
        wl, bl = wt.clone().requires_grad_(True), randn(o).requires_grad_(True)
        before = (cm.channel_mix.launches, cm.channel_mix.backward_launches)
        y = cm.channel_mix(x, wl, bl)
        check(y.grad_fn is not None, "channel_mix returned a result without a grad_fn")
        got = torch.autograd.grad(y, (x, wl, bl), g)
        want = torch.autograd.grad(cm.channel_mix_plain(x, wl, bl), (x, wl, bl), g)
        check((cm.channel_mix.launches - before[0],
               cm.channel_mix.backward_launches - before[1]) == (2, 1),
              "channel_mix forward + backward did not launch the kernel twice")
        leaves = [t.clone().requires_grad_(True) for t in (ls, tb, xb)]
        before = ct.coupling_tail_bwd.launches
        y_b, ldj = ct.coupling_tail(*leaves)
        check(y_b.grad_fn is not None and ldj.grad_fn is not None,
              "coupling_tail returned a result without a grad_fn")
        got += torch.autograd.grad((y_b, ldj), leaves, (g_y, g_ldj))
        want += torch.autograd.grad(ct.coupling_tail_plain(*leaves), leaves, (g_y, g_ldj))
        check(ct.coupling_tail_bwd.launches == before + 1,
              "coupling_tail's backward did not launch coupling_tail_bwd once")
        # and the step mode's Function: one forward and one backward launch
        leaves = [t.clone().requires_grad_(True) for t in (ys, rs, zb, zlogs, g_ldj)]
        before = (ct.coupling_tail.launches, ct.coupling_tail_bwd.launches)
        out, ldj_out = ct.coupling_step_tail(*leaves)
        check(out.grad_fn is not None and ldj_out.grad_fn is not None,
              "coupling_step_tail returned a result without a grad_fn")
        got += torch.autograd.grad((out, ldj_out), leaves, (g_out, g_ldj))
        want += torch.autograd.grad(ct.coupling_step_tail_plain(*leaves), leaves,
                                    (g_out, g_ldj))
        check((ct.coupling_tail.launches, ct.coupling_tail_bwd.launches)
              == (before[0] + 1, before[1] + 1),
              "coupling_step_tail forward + backward did not launch each kernel once")
        torch.cuda.synchronize()
        # dW and db, d_zb and d_zlogs sum over up to 16384 rows in another order: 1e-4
        names = ("dx", "dW", "db", "d_ls", "d_bias", "d_xb",
                 "step d_y", "step d_r", "step d_zb", "step d_zlogs", "step d_ldj")
        tols = (1e-5, 1e-4, 1e-4, 1e-5, 1e-5, 1e-5, 1e-5, 1e-5, 1e-4, 1e-4, 1e-5)
        gaps = {}
        for name, tol, a, e in zip(names, tols, got, want):
            gaps[name] = float((a - e).abs().max())
            check(torch.allclose(a, e, rtol=tol, atol=tol),
                  f"{name} differs from autograd through the plain version at "
                  f"{(b, h, w, c)}: {gaps[name]}")
        grad_gap = max(grad_gap, *gaps.values())
        emit({"phase": "kernel_gradients", "x": [b, h, w, c], "o": o, "max_abs_gap": gaps,
              "tolerance": dict(zip(names, tols))})
    tot["bound_ms"], tot["bound_by"] = bound_ms(tot["bytes"], tot["ops"])
    tot["library_ms"] = tot["library_device_ms"] = None
    tot["max_gradient_gap"] = grad_gap
    totals["coupling_tail_bwd"] = tot
    totals["channel_mix"].update(dx, dx_max_abs_err=tot_dx_err[0])


def train_configs(use_kernels: bool = True, epochs: int = 1):
    """(GlowConfig, NFTrainConfig) of configs/nf_base.yaml."""
    from nfdpm_tpu_torch.models import glow as glow_m
    from nfdpm_tpu_torch.training import nf_trainer as nft

    cfg = glow_m.GlowConfig(levels=LEVELS, steps=STEPS, coupling_width=WIDTH,
                            use_kernels=use_kernels)
    tcfg = nft.NFTrainConfig(epochs=epochs, lr=1e-3, optimizer="adam", n_bits=N_BITS,
                             print_freq=1, save_checkpoint_freq=1)
    return cfg, tcfg


def train_loaders(steps: int = TRAIN_STEPS):
    from nfdpm_tpu_torch.data.pipeline import read_dataset

    return read_dataset("synthetic", "", batch_size=BATCH, img_size=IMG, seed=TRAIN_SEED,
                        synthetic_n=BATCH * steps)


def frozen_leaves(params):
    """{path: tensor} of what training must leave bit-identical under the
    fixed prior: p_mat, sign and the final prior's leaves."""
    from nfdpm_tpu_torch.convert import is_frozen_path, named_leaves

    return {path: leaf.detach().clone() for path, leaf in named_leaves(params)
            if is_frozen_path(path) or path.startswith("prior/")}


def phase_training(torch, counters):
    """Phases 12 and 13; returns (the launches of train(), the run
    directory, train()'s output, the loaders)."""
    from nfdpm_tpu_torch.models import glow as glow_m
    from nfdpm_tpu_torch.models import prior as prior_m
    from nfdpm_tpu_torch.profiling import profile_call
    from nfdpm_tpu_torch.training import nf_trainer as nft

    device = torch.device("cuda")
    cfg, tcfg = train_configs()
    loaders = train_loaders()
    run_dir = ROOT / "build" / "chip_smoke" / "train_run"
    shutil.rmtree(run_dir, ignore_errors=True)
    run_dir.mkdir(parents=True)
    logger = logging.getLogger("chip_smoke.train")
    logger.setLevel(logging.INFO)
    logger.addHandler(logging.FileHandler(run_dir / "train.log"))
    logger.propagate = False
    # what init gives the frozen leaves, before any training
    init = {"flow": glow_m.init_glow(TRAIN_SEED, cfg, device),
            "prior": prior_m.init_gaussian_prior(glow_m.final_channels(cfg), True, device)}
    frozen_before = frozen_leaves(init)
    del init

    # 12. the training loop, counters zeroed just before and read just after
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters:
        fn.launches = 0
    backward_before = counters[0].backward_launches
    t0 = time.perf_counter()
    out = nft.train(cfg=cfg, tcfg=tcfg, loaders=loaders, run_dir=str(run_dir), logger=logger,
                    seed=TRAIN_SEED, img_size=IMG, device=device)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = counts(counters)
    backward = counters[0].backward_launches - backward_before
    peak = torch.cuda.max_memory_allocated()

    records = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    bpds = [r["value"] for r in records
            if r["name"] == "bpd" and r["context"] == {"subset": "train"}]
    check(len(bpds) == TRAIN_STEPS and all(map(math.isfinite, bpds)),
          f"training logged {len(bpds)} bits/dim values, or a value that is not finite: {bpds}")
    first, last = sum(bpds[:4]) / 4, sum(bpds[-4:]) / 4
    check(last < first, f"bits/dim did not fall: first 4 steps {first}, last 4 {last}")
    results = out["results"]
    check(all(math.isfinite(v) for v in results.values()), f"final bits/dim {results}")
    evals = len(loaders.test) + len(loaders.eval)  # forward passes of the final scoring
    per_pass = LEVELS * STEPS
    # the flow's first channel mix takes the data, which needs no gradient:
    # its backward computes dW and db and launches no dx
    bwd_mix = per_pass - 1
    expected = {"channel_mix": TRAIN_STEPS * (per_pass + bwd_mix) + per_pass + evals * per_pass,
                "coupling_tail": TRAIN_STEPS * per_pass + evals * per_pass,
                "coupling_tail_bwd": TRAIN_STEPS * per_pass,
                "coupling_tail_inverse": per_pass,  # the checkpoint's sample grid
                "fused_linear_attention": 0, "fused_linear_attention_bwd": 0,
                "step_megakernel_forward": 0}
    check(launches == expected and backward == TRAIN_STEPS * bwd_mix,
          f"train() launched {launches} ({backward} backward), expected {expected}")
    frozen_after = frozen_leaves(out["state"]["params"])
    check(frozen_before.keys() == frozen_after.keys()
          and all(torch.equal(frozen_before[k], frozen_after[k]) for k in frozen_before),
          "training changed p_mat, sign or the fixed prior")
    check((run_dir / "checkpoints" / "model_gaussian_001.pt").exists()
          and (run_dir / "architecture.json").exists()
          and list((run_dir / "results").glob("checkpoint_samples_e1_*.png")),
          "train() did not write its checkpoint, architecture file and sample grid")
    emit({"phase": "training", "steps": TRAIN_STEPS, "batch": BATCH, "seconds": seconds,
          "bpd_per_step": bpds, "bpd_first4": first, "bpd_last4": last,
          "final": results, "launches": launches, "backward_channel_mix_launches": backward,
          "frozen_leaves_checked": len(frozen_before),
          "max_memory_allocated_bytes": peak})

    # 13. steps driven one by one: counts and wall time of each
    train_step = nft.make_train_step(cfg, tcfg, nft.optimizer_of(tcfg), device=device)
    state = out["state"]
    batches = [torch.from_numpy(imgs).to(device) for imgs, _ in loaders.train.iter_epoch(1)]
    per_step = {"channel_mix": per_pass + bwd_mix, "coupling_tail": per_pass,
                "coupling_tail_bwd": per_pass, "coupling_tail_inverse": 0,
                "fused_linear_attention": 0, "fused_linear_attention_bwd": 0,
                "step_megakernel_forward": 0}
    walls, step_bpds = [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(TIMED_STEPS):
        before, back = counts(counters), counters[0].backward_launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = train_step(state, batches[i % len(batches)], TRAIN_SEED)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        after = counts(counters)
        delta = {k: after[k] - before[k] for k in before}
        check(delta == per_step and counters[0].backward_launches - back == bwd_mix,
              f"train step {i} launched {delta}")
        step_bpds.append(float(metrics["bpd"]))
    check(all(map(math.isfinite, step_bpds)), f"bits/dim not finite: {step_bpds}")
    step_peak = torch.cuda.max_memory_allocated()
    last16 = sorted(walls[-16:])
    median = (last16[7] + last16[8]) / 2
    prof = profile_call(lambda: train_step(state, batches[0], TRAIN_SEED), iters=1,
                        warmup=1, top=25)

    # the parts of a step on the host's clock, a synchronisation after each:
    # forward (loss), backward, clips and Adam update
    from nfdpm_tpu_torch.convert import named_leaves
    from nfdpm_tpu_torch.training.optim import grads_of

    loss_fn, tx = nft.make_loss_fn(cfg, tcfg), nft.optimizer_of(tcfg)
    gen = torch.Generator(device="cuda").manual_seed(5)
    parts = {"forward_ms": [], "backward_ms": [], "optimizer_ms": []}
    opt_state = state["opt_state"]
    for i in range(8):
        for _, leaf in named_leaves(state["params"]):
            leaf.grad = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bpd, _ = loss_fn(state["params"], batches[i], gen)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        bpd.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        opt_state = tx.apply(state["params"], grads_of(state["params"]), opt_state)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for key, ms in zip(parts, (t1 - t0, t2 - t1, t3 - t2)):
            parts[key].append(ms * 1e3)
    parts = {key: sorted(v)[len(v) // 2] for key, v in parts.items()}
    emit({"phase": "training_steps", "steps": TIMED_STEPS, "batch": BATCH,
          "launches_per_step": per_step, "backward_channel_mix_launches_per_step": bwd_mix,
          "step_wall_ms": walls, "step_wall_ms_median_last16": median,
          "step_wall_ms_min_last16": last16[0], "step_wall_ms_max_last16": last16[-1],
          "step_wall_ms_quartiles_last16": [last16[3], last16[11]],
          "images_per_s": BATCH / median * 1e3, "bpd_per_step": step_bpds,
          "max_memory_allocated_bytes": step_peak, "step_parts_wall_ms_median_of_8": parts,
          "profile_one_step": prof})
    return launches, run_dir, out, loaders


def phase_training_routes(torch, loaders, counters):
    """Phase 14: the kernel route against the plain route, from one
    ddinit'ed state, on the same batches with the same injected noise."""
    from nfdpm_tpu_torch.convert import named_leaves, trainable
    from nfdpm_tpu_torch.training import nf_trainer as nft

    device = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(77)
    batches = [torch.from_numpy(imgs).to(device)
               for imgs, _ in list(loaders.train.iter_epoch(0))[:8]]
    noises = [torch.rand(b.shape, generator=gen, device=device) for b in batches]
    (cfg_k, tcfg), (cfg_p, _) = train_configs(True), train_configs(False)
    tx = nft.optimizer_of(tcfg)
    state_k = nft.ddinit_train_state(nft.init_train_state(TRAIN_SEED, cfg_k, tcfg, tx, device),
                                     cfg_k, tcfg, tx, batches[0], noise=noises[0])

    def clone(tree):
        if isinstance(tree, dict):
            return {k: clone(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [clone(v) for v in tree]
        return tree.detach().clone() if isinstance(tree, torch.Tensor) else tree

    state_p = clone(state_k)
    state_p["params"] = trainable(state_p["params"])
    step_k = nft.make_train_step(cfg_k, tcfg, tx, inject_noise=True, device=device)
    step_p = nft.make_train_step(cfg_p, tcfg, tx, inject_noise=True, device=device)

    bpds_k, bpds_p, grad_report, zero_report = [], [], {}, {}
    for i, (batch, noise) in enumerate(zip(batches, noises)):
        before = counts(counters)
        state_p, m_p = step_p(state_p, batch, noise)
        check(counts(counters) == before, "the plain route launched a kernel")
        state_k, m_k = step_k(state_k, batch, noise)
        bpds_k.append(float(m_k["bpd"]))
        bpds_p.append(float(m_p["bpd"]))
        if i > 1:
            continue
        # the gradients both routes have just applied are still in .grad
        worst = (0.0, "", 0.0)
        all_zero, missing = [], []
        leaves_p = dict(named_leaves(state_p["params"]))
        for path, leaf in named_leaves(state_k["params"]):
            if not leaf.requires_grad:
                continue
            if leaf.grad is None or leaves_p[path].grad is None:
                missing.append(path)
                continue
            if not bool(leaf.grad.any()):
                all_zero.append(path)
            gap = (leaf.grad - leaves_p[path].grad).abs()
            excess = float((gap - GRAD_RTOL * leaves_p[path].grad.abs()).max())
            if excess > worst[0] or not worst[1]:
                worst = (excess, path, float(gap.max()))
        check(not missing, f"step {i + 1}: no gradient for {missing}")
        if i == 0:
            # a zero-initialised zeroconv gives no gradient to its own
            # log-scale nor to what feeds it (the coupling CNN's first two
            # convs and actnorms) until its weight has moved; the fixed
            # prior's log-scale never gets one (its bias stays zero)
            upstream = ("/net/conv1/", "/net/an1/", "/net/conv2/", "/net/an2/")
            unexpected = [p for p in all_zero if not p.endswith("/logs")
                          and not any(u in p for u in upstream)]
            check(not unexpected, f"step 1: all-zero gradient for {unexpected}")
            check(worst[0] <= GRAD_ATOL,
                  f"step-1 gradients differ between the routes: {worst[1]} is "
                  f"{worst[0]} beyond rtol {GRAD_RTOL} (max gap {worst[2]})")
            grad_report = {"largest_gap_beyond_rtol": worst[0], "leaf": worst[1],
                           "max_abs_gap_of_that_leaf": worst[2]}
        else:
            unexpected = [p for p in all_zero if p != "prior/logs"]
            check(not unexpected, f"step 2: all-zero gradient for {unexpected}")
        zero_report[f"step_{i + 1}"] = {"count": len(all_zero), "examples": all_zero[:3]}
    gaps = [abs(a - b) for a, b in zip(bpds_k, bpds_p)]
    check(gaps[0] <= TRAIN_BPD_TOL, f"step-1 bits/dim differ by {gaps[0]}")
    check(max(gaps) <= TRAIN_TRAJ_TOL, f"bits/dim of steps 1-8 differ by {gaps}")
    emit({"phase": "training_routes", "steps": len(batches), "bpd_kernels": bpds_k,
          "bpd_plain": bpds_p, "bpd_gap_per_step": gaps, "step1_tolerance": TRAIN_BPD_TOL,
          "trajectory_tolerance": TRAIN_TRAJ_TOL, "step1_gradients": grad_report,
          "gradient_rtol": GRAD_RTOL, "gradient_atol": GRAD_ATOL,
          "all_zero_gradients": zero_report})


def phase_resume(torch, run_dir, out, loaders):
    """Phase 15: the checkpoint read back, by both restore functions and,
    where PyYAML is installed, through the command line."""
    from nfdpm_tpu_torch.training import checkpoint as ckpt
    from nfdpm_tpu_torch.training import nf_trainer as nft

    device = torch.device("cuda")
    cfg, tcfg = train_configs()
    eval_step = nft.make_eval_step(cfg, tcfg, device)
    state = ckpt.restore_state(str(run_dir), "gaussian", 1, device)
    check(state["step"] == TRAIN_STEPS and state["opt_state"]["count"] == TRAIN_STEPS,
          f"the restored state is at step {state['step']}")
    # loaders as a new process makes them: the shuffled eval loader draws
    # another order each time it is walked
    loaders = train_loaders()
    again = nft.final_bpd(eval_step, state["params"], loaders, TRAIN_SEED)
    check(again == out["results"],
          f"the restored state scores {again}, training logged {out['results']}")
    params = ckpt.restore_params(str(run_dir), "gaussian", 1, device)
    eval_phase = nft.final_bpd(eval_step, params, train_loaders(), TRAIN_SEED)
    check(eval_phase == out["results"], f"restore_params scores {eval_phase}")
    record = {"phase": "resume", "restored_step": state["step"], "bpd": again,
              "logged": out["results"], "equal": True}

    try:
        import yaml  # noqa: F401  (only to know whether the entry point can run)
    except ImportError:
        record["command_line"] = "not run: PyYAML is not installed"
        emit(record)
        return
    cwd = ROOT / "build" / "chip_smoke" / "cli"
    shutil.rmtree(cwd, ignore_errors=True)
    cwd.mkdir(parents=True)
    common = ["data.name=synthetic", f"data.batch_size={BATCH}", f"data.img_size={IMG}",
              f"data.synthetic_n={BATCH * 4}", f"model.architecture.L={LEVELS}",
              f"model.architecture.K={STEPS}", f"model.architecture.coupling_width={WIDTH}",
              "model.training.epochs=1", "model.training.print_freq=1",
              "model.training.save_checkpoint_freq=1"]
    env = dict(os.environ, PYTHONPATH=str(ROOT), NFDPM_NO_TENSORBOARD="1")

    def cli(*extra):
        done = subprocess.run([sys.executable, "-m", "nfdpm_tpu_torch.run_baseline", *common,
                               *extra], cwd=cwd, env=env, capture_output=True, text=True,
                              timeout=600)
        check(done.returncode == 0, f"run_baseline {extra} failed:\n{done.stdout[-1500:]}"
              f"\n{done.stderr[-1500:]}")
        return done.stdout

    t0 = time.perf_counter()
    trained_out = cli("experiment_name=smoke")
    (run,) = (cwd / "outputs").iterdir()
    eval_out = cli("phase=eval", f"load.load_exp_dir={run.name}", "load.load_epoch=1")
    final = dict(re.findall(r"final (test|train) bpd: ([0-9.]+)", trained_out))
    evaluated = dict(re.findall(r"\] (test|train) bpd: ([0-9.]+)", eval_out))
    check(len(final) == 2 and final == evaluated,
          f"phase=eval gave {evaluated}, training logged {final}")
    check("NVIDIA" in trained_out or "Device: cuda" in trained_out,
          "the command line did not report a CUDA device")
    record["command_line"] = {"ran": True, "steps": 4, "seconds": time.perf_counter() - t0,
                              "final_bpd": final, "eval_bpd": evaluated}
    emit(record)


# The backward's parts measured in phase 16, which the summary line carries
# (its bounds, which are computed, stay in the phase's own lines).
BWD_MEASURED = ("kernel_ms", "kernel_device_ms", "kernel_profiler_ms", "products_device_ms")


def phase_attention_backward(torch, fla, train_shapes, totals):
    """fused_linear_attention's gradient, kernel route (the autograd Function
    over both kernels) against fused_linear_attention_bwd_plain, at the 12
    calls of one stage-2 train step (B = 64) and a ragged case. Times of the
    whole gradient (the backward kernels and the plain products behind
    them) as in phase 3, bound from fla_bwd_bytes_ops; then the two parts:
    the kernels alone (`_backward_kernel`: events, graph replays, and the
    profiler's sum over the fla_bwd_ kernels of whole-gradient calls) and
    the library products (`_library_products`), with the kernels' own
    bound (fla_bwd_kernel_bytes_ops, fp32 and 3xTF32). Adds the summary of
    one train step (12 launches) to `totals` and prints it as the
    attention_backward_step line, bounds included."""
    from nfdpm_tpu_torch import profiling

    gen = torch.Generator(device="cuda").manual_seed(5432)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    cases = [("training", f"part {p} block {k}", BATCH, h, w, c)
             for p, k, h, w, c in train_shapes]
    cases.append(("ragged", "C 20, N 3x5, B 5", 5, 3, 5, 20))
    names = ("dx", "dW_qkv", "dW_out", "db_out", "dg")
    timed = ("ms", "plain_ms", "device_ms", "plain_device_ms")
    parts = BWD_MEASURED + ("kernel_bound_ms", "kernel_tensor_core_bound_ms")
    tot = dict({t: 0.0 for t in timed + parts}, bytes=0.0, ops=0.0, max_abs_err=0.0)
    gaps_all = {n: 0.0 for n in names}
    bwd_plan = getattr(fla, "bwd_plan", None)  # absent from the two-pass design
    for use, label, b, h, w, c in cases:
        x = randn(b, h, w, c)
        w_qkv, w_out = randn(c, 384, scale=c ** -0.5), randn(128, c, scale=128 ** -0.5)
        b_out, g = randn(c, scale=0.1), 1.0 + randn(c, scale=0.1)
        dout = randn(b, h, w, c)
        args = (x, w_qkv, w_out, b_out, g)
        leaves = [t.clone().requires_grad_(True) for t in args]
        y = fla.fused_linear_attention(*leaves)
        check(y.grad_fn is not None, "fused_linear_attention returned no grad_fn under grad")
        before = fla.fused_linear_attention_bwd.launches
        got = torch.autograd.grad(y, leaves, dout)
        check(fla.fused_linear_attention_bwd.launches == before + 1,
              "the Function's backward did not launch the backward kernel once")
        want = fla.fused_linear_attention_bwd_plain(*args, dout)
        again = torch.autograd.grad(fla.fused_linear_attention(*leaves), leaves, dout)
        torch.cuda.synchronize()
        check(all(torch.equal(a, e) for a, e in zip(got, again)),
              f"the backward kernel did not repeat bit for bit at {(b, h, w, c)}")
        gaps, scaled = {}, {}
        for name, a, e in zip(names, got, want):
            gaps[name] = float((a - e).abs().max())
            tol = FLA_BWD_DX_TOL * (1.0 + float(e.abs().max())) if name == "dx" else (
                FLA_BWD_SCALED_TOL * float(e.abs().max()))
            scaled[name] = tol
            check(gaps[name] <= tol, f"{name} of fused_linear_attention differs from the "
                                     f"plain version at {(b, h, w, c)}: {gaps[name]} > {tol}")
            gaps_all[name] = max(gaps_all[name], gaps[name])
        _, ctx, stats = fla._forward_kernel(*args)
        whole = lambda: fla.fused_linear_attention_bwd(*args, ctx, stats, dout)  # noqa: E731
        times = time_rows({"": whole,
                           "plain_": lambda: fla.fused_linear_attention_bwd_plain(*args, dout)},
                          timed)
        kernel = lambda: fla._backward_kernel(*args, ctx, stats, dout)  # noqa: E731
        outs = kernel()
        prof = profiling.profile_call(whole, iters=20)
        by_group = prof.get("by_group_ms") or {}
        times.update({
            "kernel_ms": cuda_ms(kernel), "kernel_device_ms": graph_ms(kernel),
            "kernel_profiler_ms": by_group.get("fused_linear_attention backward",
                                               "not measured"),
            "products_device_ms": graph_ms(lambda: fla._library_products(x, w_qkv, *outs))})
        nbytes, ops = fla_bwd_bytes_ops(b, h * w, c)
        b_ms, b_by = bound_ms(nbytes, ops)
        k_bytes, k_ops = fla_bwd_kernel_bytes_ops(b, h * w, c)
        k_ms, k_by = bound_ms(k_bytes, k_ops)
        times["kernel_bound_ms"] = k_ms
        times["kernel_tensor_core_bound_ms"] = fla_bwd_tensor_core_bound_ms(b, h * w, c)
        record = {"phase": "kernel", "name": "fused_linear_attention_bwd",
                  "version": KERNEL_VERSIONS["fused_linear_attention_bwd"], "use": use,
                  "call": label, "x": [b, h, w, c], "max_abs_gap": gaps, "tolerance": scaled,
                  **times, "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
                  "bytes": nbytes, "ops": ops, "kernel_bound_by": k_by,
                  "kernel_bytes": k_bytes, "kernel_ops": k_ops}
        if bwd_plan is not None:
            record["plan"] = bwd_plan(h * w, c)._asdict()
        emit(record)
        tot["max_abs_err"] = max(tot["max_abs_err"], *gaps.values())
        if use == "training":
            tot["bytes"] += nbytes
            tot["ops"] += ops
            for key in timed + parts:
                # a sum over the step's shapes only where every shape measured it
                if isinstance(tot[key], float):
                    tot[key] = (tot[key] + times[key] if isinstance(times[key], float)
                                else "not measured")
    tot["bound_ms"], tot["bound_by"] = bound_ms(tot["bytes"], tot["ops"])
    tot["library_ms"] = tot["library_device_ms"] = None
    tot["max_abs_gap_by_gradient"] = gaps_all
    totals["fused_linear_attention_bwd"] = tot
    emit({"phase": "attention_backward_step", **tot})


STAGE2_STEPS = 24        # one epoch of the stage-2 run: synthetic_n = 64 * 24
STAGE2_TIMED = 8         # steps timed one by one after it (a depth cut; PERF.md §7)
STAGE2_GRIDS = 24        # log_gen_images_per_iter: a sample grid every 24 steps (a
# depth cut; PERF.md §7)
STAGE2_ROUTE_STEPS = 8
STAGE2_COTRAIN_STEPS = 4
# the co-trained run's diffusion T, cut from the config's 1000 so that its VLB
# batch and its phase=eval's (250 UNet calls a part at T = 1000, about 13 s
# each on an H100) fit the proof run's 800 s; phase 17 keeps T = 1000
STAGE2_COTRAIN_T = 100
STAGE2_LOSS_TOL = 1e-5   # step 1, kernel route vs plain route, relative
STAGE2_TRAJ_TOL = 1e-4   # steps 1-8, relative
# step-1 gradients, kernel route vs plain route, leaf by leaf: within this
# share of the leaf's largest entry (sums over up to 16384 rows in another order)
STAGE2_GRAD_TOL = 1e-4
FLA_BWD_DX_TOL = 1e-4    # tests/test_torch_kernels_cuda.py
FLA_BWD_SCALED_TOL = 1e-5


def stage2_overrides(run_name: str, steps: int = STAGE2_STEPS):
    """configs/nf_diffusion.yaml at full width (its UNets, schedule, T and
    loss as they stand) on the port's synthetic data, one epoch of `steps`
    steps, from the stage-1 run of phase 12, frozen."""
    return ["data.name=synthetic", f"data.batch_size={BATCH}", f"data.img_size={IMG}",
            f"data.synthetic_n={BATCH * steps}",
            f"model.normalizing_flow.init_nf.pretrain.dir={run_name}",
            "model.normalizing_flow.init_nf.pretrain.epoch=1",
            "model.training.epochs=1", "model.training.print_freq=1",
            "model.training.save_checkpoint_freq=1",
            f"model.logging.log_gen_images_per_iter={STAGE2_GRIDS}",
            "model.evaluation.vlb_batches=1"]


def stage2_per_step(frozen: bool) -> dict:
    per_pass = LEVELS * STEPS
    blocks = 2 * len(UNET_KWARGS["dim_mults"]) * LEVELS  # linear-attention calls
    return {"channel_mix": per_pass if frozen else 2 * per_pass - 1,
            "coupling_tail": per_pass, "coupling_tail_bwd": 0 if frozen else per_pass,
            "coupling_tail_inverse": 0, "fused_linear_attention": blocks,
            "fused_linear_attention_bwd": blocks, "step_megakernel_forward": 0}


def stage2_run_launches(per_step: dict, steps: int, timesteps: int = 0) -> dict:
    """The launches of one run_diffusion_prior.main train phase of `steps`
    steps: the steps, the sample grids (one every STAGE2_GRIDS steps and the
    checkpoint's) and one VLB batch at T = `timesteps` (0: the config's)."""
    timesteps = timesteps or DIFFUSION_KWARGS["timesteps"]
    parts, blocks = LEVELS, 2 * len(UNET_KWARGS["dim_mults"])
    grids = steps // STAGE2_GRIDS + 1
    grid = {"channel_mix": 3 * STEPS, "coupling_tail_inverse": 3 * STEPS,
            "fused_linear_attention": parts * DIFFUSION_KWARGS["sampling_timesteps"] * blocks}
    vlb = dict(vlb_pass_launches(timesteps), channel_mix=3 * STEPS, coupling_tail=3 * STEPS)
    return {k: steps * v + grids * grid.get(k, 0) + vlb.get(k, 0) for k, v in per_step.items()}


def phase_stage2_training(torch, counters, stage1_dir):
    """Phase 17: python -m nfdpm_tpu_torch.run_diffusion_prior's main, in
    this process so that its launches are counted, then phase=eval through
    the command line, then STAGE2_TIMED steps timed one by one with a
    profile of one. Returns (launches, the run directory, the stage-1 run
    directory the flow came from)."""
    from nfdpm_tpu_torch import run_diffusion_prior
    from nfdpm_tpu_torch.models.nf_backbone import load_pretrained_flow
    from nfdpm_tpu_torch.profiling import profile_call
    from nfdpm_tpu_torch.training import diffusion_trainer as dt

    cwd = ROOT / "build" / "chip_smoke" / "stage2"
    shutil.rmtree(cwd, ignore_errors=True)
    (cwd / "outputs").mkdir(parents=True)
    (cwd / "outputs" / "stage1").symlink_to(stage1_dir)
    overrides = stage2_overrides("stage1")
    here = os.getcwd()
    os.environ["NFDPM_NO_TENSORBOARD"] = "1"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    try:
        os.chdir(cwd)
        result = run_diffusion_prior.main(overrides + ["experiment_name=stage2"])
    finally:
        os.chdir(here)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = counts(counters)
    peak = torch.cuda.max_memory_allocated()
    run_dir = cwd / result["run_dir"]

    per_step = stage2_per_step(frozen=True)
    expected = stage2_run_launches(per_step, STAGE2_STEPS)
    check(launches == expected, f"run_diffusion_prior launched {launches}, expected {expected}")

    records = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    losses = [r["value"] for r in records
              if r["name"] == "l1" and r["context"] == {"subset": "train"}]
    check(len(losses) == STAGE2_STEPS and all(map(math.isfinite, losses)),
          f"stage 2 logged {len(losses)} losses, or one that is not finite: {losses}")
    first, last = sum(losses[:4]) / 4, sum(losses[-4:]) / 4
    check(last < first, f"the stage-2 loss did not fall: first 4 steps {first}, last 4 {last}")
    arch = json.loads((run_dir / "diffusion_architecture.json").read_text())
    check((run_dir / "checkpoints" / "model_diffusion_001.pt").exists()
          and arch["kind"] == "diffusion_prior" and arch["frozen"] is True
          and arch["unet_kwargs"]["dim"] == UNET_KWARGS["dim"],
          "run_diffusion_prior did not write its checkpoint and architecture file")
    vlb_line = f"VLB test bpd (diffusion prior): {result['vlb_bpd']:.4f}"
    check(vlb_line in (run_dir / "train.log").read_text() and math.isfinite(result["vlb_bpd"]),
          "the final VLB line is missing")

    # phase=eval through the command line reproduces the VLB
    env = dict(os.environ, PYTHONPATH=str(ROOT), NFDPM_NO_TENSORBOARD="1")
    t1 = time.perf_counter()
    done = subprocess.run([sys.executable, "-m", "nfdpm_tpu_torch.run_diffusion_prior",
                           *overrides, "experiment_name=stage2_eval", "phase=eval",
                           f"load.load_exp_dir={run_dir.name}", "load.load_epoch=1"],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=600)
    check(done.returncode == 0, f"phase=eval failed:\n{done.stdout[-1500:]}\n"
                                f"{done.stderr[-1500:]}")
    check(vlb_line in done.stdout, f"phase=eval did not reproduce {vlb_line!r}:\n"
                                   f"{done.stdout[-800:]}")
    eval_seconds = time.perf_counter() - t1

    # steps timed one by one, from the checkpoint
    device = torch.device("cuda")
    backbone, flow = load_pretrained_flow(str(stage1_dir), 1, True, device)
    dp = stage2_prior()
    tcfg = dt.DiffusionTrainConfig(lr_diffusion=1e-3, n_bits=N_BITS)
    tx = dt.make_two_group_optimizer(tcfg, True)
    state = dt.restore_train_state(str(run_dir), 1, backbone, dp, False, device)
    step = dt.make_train_step(backbone, dp, tcfg, tx, device=device)
    batches = [torch.from_numpy(imgs).to(device) for imgs, _ in
               list(train_loaders(STAGE2_STEPS).train.iter_epoch(1))[:4]]
    walls = []
    torch.cuda.reset_peak_memory_stats()
    for i in range(STAGE2_TIMED + 2):
        before = counts(counters)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        state, metrics = step(state, batches[i % len(batches)], TRAIN_SEED)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t2) * 1e3)
        after = counts(counters)
        delta = {k: after[k] - before[k] for k in before}
        check(delta == per_step, f"stage-2 train step {i} launched {delta}")
        check(math.isfinite(float(metrics["loss"])), "stage-2 loss not finite")
    step_peak = torch.cuda.max_memory_allocated()
    timed = sorted(walls[-STAGE2_TIMED:])
    median = median_of(timed)
    prof = profile_call(lambda: step(state, batches[0], TRAIN_SEED), iters=1, warmup=1, top=25)
    emit({"phase": "stage2_training", "steps": STAGE2_STEPS, "batch": BATCH,
          "seconds": seconds, "loss_per_step": losses, "loss_first4": first,
          "loss_last4": last, "vlb_bpd": result["vlb_bpd"], "vlb_images": result["vlb_n"],
          "vlb_stderr": result["vlb_stderr"], "eval_reproduced": True,
          "eval_seconds": eval_seconds, "launches": launches, "expected_launches": expected,
          "launches_per_step": per_step, "max_memory_allocated_bytes": peak,
          "step_wall_ms": walls, "step_wall_ms_median_timed": median,
          "step_wall_ms_min_timed": timed[0], "step_wall_ms_max_timed": timed[-1],
          "step_wall_ms_quartiles_timed": quartiles(timed), "timed_steps": STAGE2_TIMED,
          "images_per_s": BATCH / median * 1e3, "step_max_memory_allocated_bytes": step_peak,
          "profile_one_step": prof})
    return launches, run_dir, stage1_dir


def stage2_draws(torch, gen, dp):
    """Injected draws of one stage-2 step at batch 64 (make_loss_fn's `draws`)."""
    return {"dequant": torch.rand((BATCH, IMG, IMG, 3), generator=gen, device="cuda"),
            "parts": [{"t": torch.randint(0, DIFFUSION_KWARGS["timesteps"], (BATCH,),
                                          generator=gen, device="cuda"),
                       "noise": torch.randn((BATCH, h, w, c), generator=gen, device="cuda")}
                      for h, w, c in dp.formater.input_shapes]}


def phase_stage2_routes(torch, counters, run_dir, stage1_dir):
    """Phase 18: the kernel route against use_kernels=False, each from the
    checkpoint of phase 17 with the same injected draws: the loss and every
    gradient of step 1 under the l2 loss (l1's gradient is a sign, which a
    residual on zero flips), and the l1 losses of steps 1-8."""
    from nfdpm_tpu_torch.convert import named_leaves
    from nfdpm_tpu_torch.models.nf_backbone import load_pretrained_flow
    from nfdpm_tpu_torch.training import diffusion_trainer as dt

    device = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(99)
    batches = [torch.from_numpy(imgs).to(device) for imgs, _ in
               list(train_loaders(STAGE2_STEPS).train.iter_epoch(0))[:STAGE2_ROUTE_STEPS]]
    dp0 = stage2_prior()
    draws = [stage2_draws(torch, gen, dp0) for _ in batches]
    tcfg = dt.DiffusionTrainConfig(lr_diffusion=1e-3, n_bits=N_BITS)
    tx = dt.make_two_group_optimizer(tcfg, True)

    def route(use_kernels, loss_type, n):
        backbone, _ = load_pretrained_flow(str(stage1_dir), 1, True, device, use_kernels)
        dp = stage2_prior(use_kernels, loss_type=loss_type)
        state = dt.restore_train_state(str(run_dir), 1, backbone, dp, False, device)
        step = dt.make_train_step(backbone, dp, tcfg, tx, inject_noise=True, device=device)
        losses = []
        for i in range(n):
            before = counts(counters)
            state, metrics = step(state, batches[i], draws[i])
            if not use_kernels:
                check(counts(counters) == before, "the plain route launched a kernel")
            losses.append(float(metrics["loss"]))
        return state, losses

    state_k, loss_k = route(True, "l2", 1)
    state_p, loss_p = route(False, "l2", 1)
    gap = abs(loss_k[0] - loss_p[0]) / abs(loss_p[0])
    check(gap <= STAGE2_LOSS_TOL, f"step-1 losses differ by {gap} (relative)")
    leaves_p = dict(named_leaves(state_p["params"]))
    worst, missing, attention = (0.0, ""), [], 0
    for path, leaf in named_leaves(state_k["params"]):
        if not path.startswith("diffusion/"):
            continue
        other = leaves_p[path].grad
        if leaf.grad is None or other is None:
            missing.append(path)
            continue
        ratio = float((leaf.grad - other).abs().max()) / max(float(other.abs().max()), 1e-30)
        attention += any(k in path for k in (".fn.w_qkv", ".fn.w_out", ".fn.b_out", ".fn.g"))
        if ratio > worst[0]:
            worst = (ratio, path)
    check(not missing, f"step 1: no gradient for {missing}")
    check(attention == LEVELS * 2 * len(UNET_KWARGS["dim_mults"]) * 4 + LEVELS * 3,
          f"compared {attention} attention leaves")
    check(worst[0] <= STAGE2_GRAD_TOL,
          f"step-1 gradients differ between the routes: {worst[1]} by {worst[0]} of its "
          "largest entry")
    del state_k, state_p
    _, traj_k = route(True, "l1", STAGE2_ROUTE_STEPS)
    _, traj_p = route(False, "l1", STAGE2_ROUTE_STEPS)
    gaps = [abs(a - b) / abs(b) for a, b in zip(traj_k, traj_p)]
    check(max(gaps) <= STAGE2_TRAJ_TOL, f"l1 losses of steps 1-8 differ by {gaps}")
    emit({"phase": "stage2_training_routes", "step1_l2_loss": [loss_k[0], loss_p[0]],
          "step1_relative_gap": gap, "step1_tolerance": STAGE2_LOSS_TOL,
          "step1_worst_gradient": {"leaf": worst[1], "gap_over_leaf_max": worst[0]},
          "gradient_tolerance": STAGE2_GRAD_TOL, "attention_leaves_compared": attention,
          "l1_kernels": traj_k, "l1_plain": traj_p, "l1_relative_gaps": gaps,
          "trajectory_tolerance": STAGE2_TRAJ_TOL})


def phase_stage2_cotraining(torch, counters, stage1_dir):
    """Phase 19: run_diffusion_prior.main with the flow co-trained
    (model.normalizing_flow.freeze=false, model.normalizing_flow.lr=1e-4)
    for one epoch of STAGE2_COTRAIN_STEPS steps, in this process: exact
    launches, the l1_plus_bpd loss logged, flow leaves of its checkpoint
    moved from the stage-1 run, p_mat and sign not, no stage-1 prior in the
    state; then phase=eval, in-process, reads the trained flow back from the
    stage-2 checkpoint and prints the same VLB."""
    from nfdpm_tpu_torch import run_diffusion_prior
    from nfdpm_tpu_torch.convert import is_frozen_path, named_leaves
    from nfdpm_tpu_torch.training.checkpoint import restore_params

    cwd = ROOT / "build" / "chip_smoke" / "stage2_cotrain"
    shutil.rmtree(cwd, ignore_errors=True)
    (cwd / "outputs").mkdir(parents=True)
    (cwd / "outputs" / "stage1").symlink_to(stage1_dir)
    overrides = stage2_overrides("stage1", STAGE2_COTRAIN_STEPS) + [
        "model.normalizing_flow.freeze=false", "model.normalizing_flow.lr=1e-4",
        f"model.diffusion.timesteps={STAGE2_COTRAIN_T}"]
    here = os.getcwd()
    torch.cuda.synchronize()
    for fn in counters:
        fn.launches = 0
    counters[0].backward_launches = 0
    t0 = time.perf_counter()
    try:
        os.chdir(cwd)
        result = run_diffusion_prior.main(overrides + ["experiment_name=cotrain"])
    finally:
        os.chdir(here)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, dx = counts(counters), counters[0].backward_launches
    per_step = stage2_per_step(frozen=False)
    expected = stage2_run_launches(per_step, STAGE2_COTRAIN_STEPS, STAGE2_COTRAIN_T)
    check(launches == expected and dx == STAGE2_COTRAIN_STEPS * (LEVELS * STEPS - 1),
          f"co-trained run_diffusion_prior launched {launches} ({dx} dx), expected {expected}")
    run_dir = cwd / result["run_dir"]

    records = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    losses = [r["value"] for r in records
              if r["name"] == "l1_plus_bpd" and r["context"] == {"subset": "train"}]
    check(len(losses) == STAGE2_COTRAIN_STEPS and all(map(math.isfinite, losses)),
          f"co-training logged {len(losses)} l1_plus_bpd losses, or one not finite: {losses}")
    arch = json.loads((run_dir / "diffusion_architecture.json").read_text())
    check(arch["frozen"] is False, "diffusion_architecture.json does not say the flow co-trained")
    trained = restore_params(str(run_dir), "diffusion", 1, "cuda")
    start = dict(named_leaves(restore_params(str(stage1_dir), "gaussian", 1, "cuda")["flow"]))
    moved, fixed = 0, 0
    for path, leaf in named_leaves(trained["flow"]):
        same = torch.equal(leaf, start[path])
        if is_frozen_path(path):
            check(same, f"co-training changed {path}")
            fixed += 1
        else:
            moved += not same
    check(moved > 0 and "prior" not in trained,
          "the co-trained flow did not move, or the stage-1 prior joined the state")

    t1 = time.perf_counter()
    try:
        os.chdir(cwd)
        again = run_diffusion_prior.main(overrides + [
            "experiment_name=cotrain_eval", "phase=eval",
            f"load.load_exp_dir={run_dir.name}", "load.load_epoch=1"])
    finally:
        os.chdir(here)
    eval_seconds = time.perf_counter() - t1
    check(f"{again['vlb_bpd']:.4f}" == f"{result['vlb_bpd']:.4f}",
          f"phase=eval of the co-trained run gave {again['vlb_bpd']}, training "
          f"{result['vlb_bpd']}")
    emit({"phase": "stage2_cotraining", "steps": STAGE2_COTRAIN_STEPS, "lr_nf": 1e-4,
          "timesteps": STAGE2_COTRAIN_T,
          "seconds": seconds, "launches": launches, "expected_launches": expected,
          "channel_mix_dx": dx, "launches_per_step": per_step, "loss_per_step": losses,
          "flow_leaves_moved": moved, "p_mat_and_sign_unchanged": fixed,
          "vlb_bpd": result["vlb_bpd"], "eval_vlb_bpd": again["vlb_bpd"],
          "eval_seconds": eval_seconds})
    return launches


# Sample-quality evaluation (phase 22): the counts of configs/nf_base.yaml's
# FID/KID at a size that fits the run, and the CIFAR-10 train count that a
# full=True evaluation generates (nfdpm_tpu_torch/data/datasets.py)
METRIC_IMAGES = 512           # stats images and generated images of stage 1
STAGE2_METRIC_IMAGES = 128    # generated images of stage 2 (both depth cuts; PERF.md §7)
CELEBA_TRAIN, CELEBA_TEST = 256, 32
FULL_EVAL_IMAGES = 50_000
METRIC_DEV_RTOL, METRIC_DEV_ATOL = 1e-3, 2e-3   # feature nets, card against CPU
RESIZE_DEV_ATOL = 2e-4                           # TF1 bilinear, [0, 255] values
SSIM_DEV_RTOL = 2e-5
FEATURE_BATCHES = (32, 64, 256)  # 32: what make_nf_evaluate_fn runs


def conv_macs_per_image(torch, model, res: int) -> int:
    """Multiply-adds of one image through every nn.Conv2d of `model`,
    counted from the convolutions' output shapes."""
    total, hooks = [0], []

    def hook(mod, _inp, out):
        total[0] += out[0].numel() * (mod.in_channels // mod.groups) * math.prod(
            mod.kernel_size)

    for m in model.modules():
        if isinstance(m, torch.nn.Conv2d):
            hooks.append(m.register_forward_hook(hook))
    try:
        with torch.inference_mode():
            model(torch.zeros(1, 3, res, res, device=next(model.parameters()).device))
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def within(torch, a, b, rtol: float, atol: float):
    """(max |a - b|, whether |a - b| <= atol + rtol |b| everywhere)."""
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    gap = (a - b).abs()
    return float(gap.max()), bool((gap <= atol + rtol * b.abs()).all())


class EvalTimers:
    """Host seconds of an evaluation's parts, each synchronised: the
    sampler, resizing, the feature net, FID's and KID's score math. Wraps
    the module attributes that nfdpm_tpu_torch.metrics.compute calls
    through, and the cached feature function, until `restore`."""

    def __init__(self, torch, compute, fid_m, model_name: str):
        self.torch, self.compute, self.fid_m = torch, compute, fid_m
        self.seconds = {k: 0.0 for k in ("sampler", "resize_legacy_tensorflow",
                                         "resize_clean", "feature_net", "fid_math",
                                         "kid_math")}
        self.images = {"sampler": 0, "resize_legacy_tensorflow": 0, "resize_clean": 0,
                       "feature_net": 0}
        self.saved = {"make_cached_sampler": compute.make_cached_sampler,
                      "resize_batch": fid_m.resize_batch,
                      "frechet_distance": fid_m.frechet_distance,
                      "kid_score": fid_m.kid_score}
        self.model_name = model_name
        self.feature_fn = compute._EXTRACTOR_CACHE[model_name]
        saved = self.saved

        def timed(key, fn, count=None):
            def wrapper(*args, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*args, **kw)
                torch.cuda.synchronize()
                self.seconds[key] += time.perf_counter() - t0
                if count is not None:
                    self.images[key] += count(args, out)
                return out
            return wrapper

        def resize_batch(images, size, mode, device=None):
            key = f"resize_{mode}"
            return timed(key, saved["resize_batch"], lambda a, o: len(a[0]))(
                images, size, mode, device)

        def make_cached_sampler(sample_images):
            return saved["make_cached_sampler"](
                timed("sampler", sample_images, lambda a, o: len(o)))

        compute.make_cached_sampler = make_cached_sampler
        fid_m.resize_batch = resize_batch
        fid_m.frechet_distance = timed("fid_math", saved["frechet_distance"])
        fid_m.kid_score = timed("kid_math", saved["kid_score"])
        compute._EXTRACTOR_CACHE[model_name] = timed("feature_net", self.feature_fn,
                                                     lambda a, o: len(a[0]))

    def restore(self):
        self.compute.make_cached_sampler = self.saved["make_cached_sampler"]
        for name in ("resize_batch", "frechet_distance", "kid_score"):
            setattr(self.fid_m, name, self.saved[name])
        self.compute._EXTRACTOR_CACHE[self.model_name] = self.feature_fn


def metric_config(metrics, modes, quick: int):
    """Overrides configuring `metrics` (FID, KID) in each of `modes` through
    inception_v3, `quick` generated images, 256 a sampler call."""
    out = []
    for m in metrics:
        out += [f"model.evaluation.metrics.{m}.mode=[{','.join(modes)}]",
                f"model.evaluation.metrics.{m}.model_name=[{','.join(['inception_v3'] * len(modes))}]"]
    return out + [f"model.evaluation.quick_num_gen={quick}",
                  "model.evaluation.gen_batch_size=256"]


def run_in(cwd: Path, main, argv):
    here = os.getcwd()
    try:
        os.chdir(cwd)
        return main(argv)
    finally:
        os.chdir(here)


class StatsCommands:
    """Phase 22 (b)'s commands in their own processes, in turn, on a thread:
    the stats command line over synthetic images (both modes,
    inception_v3), tools/make_synthetic_celeba.py, and the stats command
    line over that CelebA-format directory (clip_vit_b_32, clean, 224).
    main() starts them while nvcc builds the kernels, when the card is idle
    (their seconds are taken beside the build); `result()` waits for them
    and raises what failed. The directory build/chip_smoke/metrics is
    theirs and phase 22's."""

    def __init__(self):
        self.base = ROOT / "build" / "chip_smoke" / "metrics"
        shutil.rmtree(self.base, ignore_errors=True)
        self.base.mkdir(parents=True)
        self.stats_dir, self.weights_dir = self.base / "stats", self.base / "weights"
        self.env = dict(os.environ, PYTHONPATH=str(ROOT), NFDPM_TPU_STATS_DIR=str(self.stats_dir),
                        NFDPM_TPU_WEIGHTS_DIR=str(self.weights_dir))
        self.out, self.error = {}, None
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _command(self, *argv, timeout=600):
        t0 = time.perf_counter()
        proc = subprocess.Popen([sys.executable, *argv], cwd=self.base, env=self.env,
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        PROCESSES.append(proc)
        try:
            out, err = proc.communicate(timeout=timeout)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        check(proc.returncode == 0, f"{argv[:2]} failed:\n{out[-1500:]}\n{err[-1500:]}")
        return time.perf_counter() - t0, err

    def _run(self):
        try:
            stats_cli = ["-m", "nfdpm_tpu_torch.metrics.precompute_stats", "--action",
                         "precompute"]
            self.out["synthetic"] = self._command(*stats_cli, "--datasets", "synthetic",
                                                  "--models", "inception_v3", "--limit",
                                                  str(METRIC_IMAGES))
            self.out["celeba_write"] = self._command(
                str(ROOT / "tools" / "make_synthetic_celeba.py"), "--root",
                str(self.base / "celeba"), "--n-train", str(CELEBA_TRAIN), "--n-val", "8",
                "--n-test", str(CELEBA_TEST))
            self.out["celeba"] = self._command(*stats_cli, "--datasets", "celeba", "--models",
                                               "clip_vit_b_32", "--modes", "clean",
                                               "--data_root", str(self.base / "celeba"))
        except BaseException as e:  # noqa: B036 -- raised again by result()
            self.error = e

    def result(self) -> dict:
        self.thread.join()
        if self.error is not None:
            raise self.error
        return self.out


def phase_sample_metrics(torch, np, counters, smi, stage1_dir, stage2_run,
                         stats_commands: StatsCommands = None):
    """Phase 22: sample-quality evaluation on the card. (a) the feature
    nets, TF1 resize and SSIM/PSNR on the card against the CPU; (b) the
    stats command line as a subprocess over synthetic images (both modes,
    inception_v3) and over a CelebA-format directory (clip_vit_b_32, clean,
    224); (c) run_baseline.main phase=eval of phase 12's run with FID and
    KID in both modes and SSIM/PSNR, the flow kernels' exact launches;
    (d) run_diffusion_prior.main phase=eval of phase 17's run with FID;
    (e) rates: the Glow sampler, resizing, the feature nets at batches of
    32, 64 and 256 (CUDA events) beside Inception's bound, peak memory, and
    a projection of a full CIFAR-10 evaluation. (b) runs in
    `stats_commands`, started by main() beside the build (else here).
    Returns the launches of (c) and of (d)."""
    import copy

    from nfdpm_tpu_torch import run_baseline, run_diffusion_prior
    from nfdpm_tpu_torch.data.datasets import synthetic
    from nfdpm_tpu_torch.metrics import clip_features, compute
    from nfdpm_tpu_torch.metrics import fid as fid_m
    from nfdpm_tpu_torch.metrics import inception
    from nfdpm_tpu_torch.metrics.image_quality import psnr, ssim
    from nfdpm_tpu_torch.training import nf_trainer as nft
    from nfdpm_tpu_torch.training.checkpoint import restore_params

    if stats_commands is None:
        stats_commands = StatsCommands()
    base = stats_commands.base
    stats_dir, weights_dir = stats_commands.stats_dir, stats_commands.weights_dir
    os.environ["NFDPM_TPU_STATS_DIR"] = str(stats_dir)
    os.environ["NFDPM_TPU_WEIGHTS_DIR"] = str(weights_dir)
    weights = {name: (weights_dir / net.WEIGHTS_FILE).exists()
               for name, net in (("inception_v3", inception), ("clip_vit_b_32", clip_features))}
    device = torch.device("cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # (a) the card against the CPU, same seeded weights and inputs
    small = torch.from_numpy(synthetic(8, IMG, 3, seed=3).images)
    resized_cpu = fid_m.tf1_bilinear_resize(small, 299)
    resized_dev = fid_m.tf1_bilinear_resize(small.to(device), 299)
    gap, ok = within(torch, resized_dev, resized_cpu, 0.0, RESIZE_DEV_ATOL)
    check(ok, f"tf1_bilinear_resize: the card is {gap} from the CPU")
    devices = {"tf1_bilinear_resize_max_abs_gap": gap}
    for name, net, res in (("inception_v3", inception, 299), ("clip_vit_b_32", clip_features,
                                                                224)):
        model = net.random_init(0)
        x = fid_m.tf1_bilinear_resize(small, res)
        on_cpu = net.make_feature_fn(copy.deepcopy(model), "cpu")(x)
        on_dev = net.make_feature_fn(model, device)(x.to(device))
        gap, ok = within(torch, on_dev, on_cpu, METRIC_DEV_RTOL, METRIC_DEV_ATOL)
        check(ok and on_dev.shape == (8, net.FEATURE_DIM),
              f"{name}: features on the card are {gap} from the CPU's")
        devices[f"{name}_max_abs_gap"] = gap
        devices[f"{name}_mean_abs_feature"] = float(on_cpu.abs().mean())
    noisy = (small.float() + 12 * torch.randn(small.shape, generator=torch.Generator()
                                              .manual_seed(4))).clamp(0, 255)
    for name, fn in (("ssim", ssim), ("psnr", psnr)):
        cpu_v, dev_v = fn(noisy, small.float()), fn(noisy.to(device), small.float().to(device))
        gap, ok = within(torch, dev_v, cpu_v, SSIM_DEV_RTOL, 0.0)
        check(ok, f"{name}: the card gives {float(dev_v)}, the CPU {float(cpu_v)}")
        devices[f"{name}_card_cpu"] = [float(dev_v), float(cpu_v)]
    emit({"phase": "sample_metrics_devices", "nvidia_smi": smi, "images": 8,
          "feature_tolerance": [METRIC_DEV_RTOL, METRIC_DEV_ATOL],
          "resize_tolerance": RESIZE_DEV_ATOL, "ssim_psnr_rtol": SSIM_DEV_RTOL, **devices})

    # (b) the stats command line, in its own process, on the card
    done = stats_commands.result()
    (synth_s, synth_log), (write_s, _), (celeba_s, celeba_log) = (
        done["synthetic"], done["celeba_write"], done["celeba"])
    files = {}
    for key, n, dim in ((("synthetic", "legacy_tensorflow", "inception_v3", "train", IMG),
                         METRIC_IMAGES, 2048),
                        (("synthetic", "clean", "inception_v3", "train", IMG), METRIC_IMAGES,
                         2048),
                        (("celeba", "clean", "clip_vit_b_32", "train", 224), CELEBA_TRAIN, 512),
                        (("celeba", "clean", "clip_vit_b_32", "test", 224), CELEBA_TEST, 512)):
        stats = fid_m.load_stats(*key)
        check(stats is not None and stats["feats"].shape == (n, dim)
              and np.isfinite(stats["sigma"]).all(),
              f"the stats command line did not write {fid_m.stat_filename(*key)}")
        files[fid_m.stat_filename(*key)] = list(stats["feats"].shape)
    for name, net, log in (("inception_v3", inception, synth_log),
                           ("clip_vit_b_32", clip_features, celeba_log)):
        check(weights[name] or f"{weights_dir / net.WEIGHTS_FILE} not found" in log,
              f"the stats command line did not name the missing {name} weights file")
    emit({"phase": "sample_metrics_stats", "nvidia_smi": smi, "files": files,
          "synthetic_seconds": synth_s, "celeba_write_seconds": write_s,
          "celeba_clip_seconds": celeba_s, "weights_files_present": weights,
          "note": "the commands ran beside the kernels' build (nvcc on the host)"})

    # (c) stage-1 evaluation: phase=eval of phase 12's full-width run
    cwd = base / "stage1"
    (cwd / "outputs").mkdir(parents=True)
    (cwd / "outputs" / "stage1").symlink_to(stage1_dir)
    compute.get_feature_extractor("inception_v3", device)  # built outside the timers
    n_eval = BATCH * 4
    argv = ["data.name=synthetic", f"data.batch_size={BATCH}", f"data.img_size={IMG}",
            f"data.synthetic_n={n_eval}", "experiment_name=metrics_stage1", "phase=eval",
            "load.load_exp_dir=stage1", "load.load_epoch=1",
            "model.evaluation.metrics.SSIM_and_PSNR.data_range=255",
            *metric_config(("FID", "KID"), ("legacy_tensorflow", "clean"), METRIC_IMAGES)]
    torch.cuda.synchronize()
    for fn in counters:
        fn.launches = 0
    timers = EvalTimers(torch, compute, fid_m, "inception_v3")
    t0 = time.perf_counter()
    try:
        result = run_in(cwd, run_baseline.main, argv)
    finally:
        torch.cuda.synchronize()
        timers.restore()
    stage1_s = time.perf_counter() - t0
    stage1_parts = timers.seconds
    launches1 = counts(counters)
    metrics1 = result["results"]["metrics"]
    keys = {"FID_inception", "FID_clean_inception", "KID_inception", "KID_clean_inception",
            "SSIM", "PSNR"}
    check(set(metrics1) == keys and all(map(math.isfinite, metrics1.values())),
          f"stage-1 evaluation gave {metrics1}")
    per_pass = LEVELS * STEPS
    evals = 1 + n_eval // BATCH  # bits/dim: the test loader's batch and the eval loader's
    calls = METRIC_IMAGES // 256  # sampler calls of 256 images
    expected1 = {"channel_mix": (evals + calls) * per_pass, "coupling_tail": evals * per_pass,
                 "coupling_tail_bwd": 0, "coupling_tail_inverse": calls * per_pass,
                 "fused_linear_attention": 0, "fused_linear_attention_bwd": 0,
                 "step_megakernel_forward": 0}
    check(launches1 == expected1, f"stage-1 evaluation launched {launches1}, expected "
                                  f"{expected1}")
    check(timers.images["sampler"] == METRIC_IMAGES
          and timers.images["feature_net"] == 4 * METRIC_IMAGES,
          f"stage-1 evaluation sampled or featurised {timers.images}")
    emit({"phase": "sample_metrics_stage1", "nvidia_smi": smi, "generated": METRIC_IMAGES,
          "stats_images": METRIC_IMAGES, "metrics": metrics1,
          "random_feature_weights": not weights["inception_v3"],
          "bpd": {k: v for k, v in result["results"].items() if k != "metrics"},
          "seconds": stage1_s, "host_seconds_by_part": timers.seconds,
          "images_by_part": timers.images, "launches": launches1})

    # (d) stage-2 evaluation: phase=eval of phase 17's run, FID legacy_tensorflow;
    # no VLB batch, which phase 17's phase=eval scores on the same run (a
    # depth cut; PERF.md §7)
    argv = stage2_overrides("stage1") + ["model.evaluation.vlb_batches=0",
        "experiment_name=metrics_stage2", "phase=eval", f"load.load_exp_dir={stage2_run.name}",
        "load.load_epoch=1",
        *metric_config(("FID",), ("legacy_tensorflow",), STAGE2_METRIC_IMAGES)]
    torch.cuda.synchronize()
    for fn in counters:
        fn.launches = 0
    timers = EvalTimers(torch, compute, fid_m, "inception_v3")
    t0 = time.perf_counter()
    try:
        result2 = run_in(stage2_run.parent.parent, run_diffusion_prior.main, argv)
    finally:
        torch.cuda.synchronize()
        timers.restore()
    stage2_s = time.perf_counter() - t0
    launches2 = counts(counters)
    fid2 = result2["metrics"].get("FID_inception")
    check(set(result2["metrics"]) == {"FID_inception"} and fid2 is not None
          and math.isfinite(fid2), f"stage-2 evaluation gave {result2['metrics']}")
    blocks = 2 * len(UNET_KWARGS["dim_mults"])
    expected2 = {"channel_mix": per_pass, "coupling_tail": 0,
                 "coupling_tail_bwd": 0, "coupling_tail_inverse": per_pass,
                 "fused_linear_attention": LEVELS * blocks
                 * DIFFUSION_KWARGS["sampling_timesteps"],
                 "fused_linear_attention_bwd": 0, "step_megakernel_forward": 0}
    check(launches2 == expected2, f"stage-2 evaluation launched {launches2}, expected "
                                  f"{expected2}")
    emit({"phase": "sample_metrics_stage2", "nvidia_smi": smi,
          "generated": STAGE2_METRIC_IMAGES, "metrics": result2["metrics"],
          "random_feature_weights": not weights["inception_v3"], "vlb_bpd": result2["vlb_bpd"],
          "seconds": stage2_s, "host_seconds_by_part": timers.seconds,
          "images_by_part": timers.images, "launches": launches2})
    stage2_sampler_img_s = STAGE2_METRIC_IMAGES / timers.seconds["sampler"]

    # (e) rates
    cfg, tcfg = train_configs()
    params = restore_params(str(stage1_dir), "gaussian", 1, device)
    sample_fn = nft.make_sample_fn(cfg, tcfg, IMG, TRAIN_SEED, device)
    sampler_s = host_ms(torch, lambda: sample_fn(params, 256, 1.0, 7), iters=4) / 1e3
    host = synthetic(256, IMG, 3, seed=5).images
    resize_ms = {}
    for mode in ("legacy_tensorflow", "clean"):
        ms = host_ms(torch, lambda: fid_m.resize_batch(host, 299, mode, device), iters=2)
        resize_ms[mode] = ms / len(host)
    rates = {}
    for name, net, res in (("inception_v3", inception, 299), ("clip_vit_b_32", clip_features,
                                                                224)):
        fn = (timers.feature_fn if name == "inception_v3"
              else net.make_feature_fn(net.random_init(0), device))
        for b in FEATURE_BATCHES:
            x = torch.rand((b, res, res, 3), generator=torch.Generator(device="cuda")
                           .manual_seed(b), device=device) * 255
            ms = cuda_ms(lambda: fn(x), iters=5, warmup=2)
            rates[f"{name}_b{b}"] = {"ms_per_batch": ms, "images_per_s": b / ms * 1e3}
            if name == "inception_v3":
                # fp32 outside the tensor cores (TF32 is off): 2 operations a multiply-add
                macs = conv_macs_per_image(torch, fn.model, res)
                rates[f"{name}_b{b}"].update(
                    conv_macs_per_image=macs, bound_by="operations",
                    bound_ms=2 * macs * b / FP32_FLOPS_PER_S * 1e3)
    peak = torch.cuda.max_memory_allocated()
    del params
    inc_ms = rates["inception_v3_b32"]["ms_per_batch"] / 32
    configs = 4  # FID and KID, each mode: every configuration extracts its own features
    # arithmetic, not a measurement: this run's rates times a full=True
    # CIFAR-10 evaluation's counts (the score math does not grow with the
    # count: 2048-d covariances, KID subsets of at most 1000)
    projection = {
        "images": FULL_EVAL_IMAGES, "configurations": configs,
        "sampler_s": FULL_EVAL_IMAGES * sampler_s / 256,
        "resize_s": FULL_EVAL_IMAGES * 2 * sum(resize_ms.values()) / 1e3,
        "inception_s": FULL_EVAL_IMAGES * configs * inc_ms / 1e3,
        "score_math_s": stage1_parts["fid_math"] + stage1_parts["kid_math"]}
    projection["total_s"] = sum(v for k, v in projection.items() if k.endswith("_s"))
    emit({"phase": "sample_metrics_rates", "nvidia_smi": smi,
          "glow_sampler_images_per_s": 256 / sampler_s,
          "stage2_sampler_images_per_s": stage2_sampler_img_s,
          "resize_host_ms_per_image": resize_ms, "feature_nets": rates,
          "max_memory_allocated_bytes": peak, "projection_arithmetic": projection})
    return launches1, launches2


# -- run-directory tooling: mid-epoch resume, run-dir serving, the CLIs --------

RESUME_STEPS = 8   # one epoch of the mid-epoch phase at batch 64
RESUME_AT = 4      # the loader proxy interrupts before this batch
WATCHDOG_S = 30.0  # every run of the phase trains under the watchdog
# what the deterministic runs set; CUBLAS_WORKSPACE_CONFIG is read when the
# CUDA context is made, so those runs go to a subprocess with it set
DETERMINISTIC_ENV = {"CUBLAS_WORKSPACE_CONFIG": ":4096:8"}


class InterruptAfter:
    """Loader proxy raising KeyboardInterrupt before yielding batch n of an
    epoch (Ctrl-C in the middle of one)."""

    def __init__(self, loader, n):
        self._loader, self._n = loader, n

    def __getattr__(self, name):
        return getattr(self._loader, name)

    def __len__(self):
        return len(self._loader)

    def iter_epoch(self, epoch, start_batch=0):
        for i, item in enumerate(self._loader.iter_epoch(epoch, start_batch=start_batch)):
            if start_batch + i >= self._n:
                raise KeyboardInterrupt
            yield item


def set_deterministic(torch, on: bool) -> None:
    torch.use_deterministic_algorithms(on)
    torch.backends.cudnn.deterministic = on
    torch.backends.cudnn.benchmark = False


def state_gap(torch, a, b, keys=("params", "opt_state")):
    """(largest |a - b| over the tensors of `keys`, whether they and the step
    are bitwise equal) of two train states."""
    from nfdpm_tpu_torch.convert import named_leaves

    gap, equal = 0.0, a["step"] == b["step"]
    for key in keys:
        la, lb = dict(named_leaves(a[key])), dict(named_leaves(b[key]))
        check(la.keys() == lb.keys(), f"the states' {key} differ in their leaves")
        for name, x in la.items():
            if not isinstance(x, torch.Tensor):
                equal = equal and x == lb[name]
                continue
            x, y = x.detach(), lb[name].detach()
            equal = equal and torch.equal(x, y)
            if x.numel():
                gap = max(gap, float((x - y).abs().max()))
    return gap, bool(equal)


def stage1_run_launches(steps: int, evals: int) -> dict:
    """Launches of nf_trainer.train over `steps` steps and `evals` scoring
    forwards, with no sample grid."""
    per_pass = LEVELS * STEPS
    return {"channel_mix": steps * (2 * per_pass - 1) + evals * per_pass,
            "coupling_tail": (steps + evals) * per_pass, "coupling_tail_bwd": steps * per_pass,
            "coupling_tail_inverse": 0, "fused_linear_attention": 0,
            "fused_linear_attention_bwd": 0, "step_megakernel_forward": 0}


def resume_trainer_run(torch, counters, kind, run_dir, interrupt=None, resume_batch=None,
                       **options):
    """One epoch of RESUME_STEPS steps of `kind` ("stage1": nf_trainer.train
    at configs/nf_base.yaml's width; "stage2": diffusion_trainer.train at
    configs/nf_diffusion.yaml's over phase 12's flow, frozen, EMA every second
    step) under the watchdog, no sample grid. `interrupt=n`: the loader
    raises before batch n and the run must stop there; `resume_batch=k`:
    resume run_dir's epoch-1 checkpoint at batch k. Checks the run's exact
    launches; returns train()'s output (None when interrupted)."""
    from nfdpm_tpu_torch.training import diffusion_trainer as dt
    from nfdpm_tpu_torch.training import nf_trainer as nft

    run_dir = Path(run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)
    loaders = train_loaders(RESUME_STEPS)
    if interrupt is not None:
        loaders = type(loaders)(train=InterruptAfter(loaders.train, interrupt),
                                val=loaders.val, test=loaders.test, eval=loaders.eval)
    logger = logging.getLogger(f"chip_smoke.resume.{run_dir.name}")
    logger.setLevel(logging.INFO)
    logger.propagate = False
    common = dict(epochs=1, n_bits=N_BITS, print_freq=1, save_checkpoint_freq=50,
                  watchdog_timeout_s=WATCHDOG_S, **options)
    resume = dict(resume_dir=str(run_dir), resume_epoch=1, resume_batch=resume_batch) \
        if resume_batch is not None else {}
    steps = (interrupt if interrupt is not None else RESUME_STEPS) - (resume_batch or 0)
    # a completed stage-1 run also scores the test and eval loaders
    evals = 0 if interrupt is not None else len(loaders.test) + len(loaders.eval)
    expected = (stage1_run_launches(steps, evals) if kind == "stage1" else
                {k: steps * v for k, v in stage2_per_step(frozen=True).items()})
    before = counts(counters)
    try:
        if kind == "stage1":
            cfg, _ = train_configs()
            out = nft.train(cfg=cfg, tcfg=nft.NFTrainConfig(lr=1e-3, **common), loaders=loaders,
                            run_dir=str(run_dir), logger=logger, seed=TRAIN_SEED,
                            img_size=IMG, device="cuda", **resume)
        else:
            from nfdpm_tpu_torch.models.nf_backbone import load_pretrained_flow

            backbone, flow = load_pretrained_flow(str(stage1_train_dir()), 1, True, "cuda")
            tcfg = dt.DiffusionTrainConfig(lr_diffusion=1e-3, ema_decay=0.999,
                                           ema_update_every=2,
                                           log_gen_images_per_iter=10 ** 6, **common)
            (run_dir / "diffusion_architecture.json").write_text(
                json.dumps(stage2_architecture(), indent=1))
            out = dt.train(backbone=backbone, flow_params=flow, dp=stage2_prior(), tcfg=tcfg,
                           loaders=loaders, run_dir=str(run_dir), logger=logger,
                           seed=TRAIN_SEED, device="cuda", **resume)
    except KeyboardInterrupt:
        check(interrupt is not None, f"{run_dir.name}: an interrupt nobody asked for")
        out = None
    else:
        check(interrupt is None, f"{run_dir.name}: the interrupted run did not stop")
    torch.cuda.synchronize()
    after = counts(counters)
    delta = {k: after[k] - before[k] for k in before}
    check(delta == expected, f"{run_dir.name} launched {delta}, expected {expected}")
    check(not (run_dir / "watchdog_stall.txt").exists(), f"the watchdog fired in {run_dir}")
    return out


def stage1_train_dir() -> Path:
    return ROOT / "build" / "chip_smoke" / "train_run"


def step_wall_ms(torch, steps: int = 8) -> list:
    """Wall ms of `steps` stage-1 train steps at batch 64, each synchronised
    (the trainers' StepTimer, asked to wait for the card at each step's
    end), from a ddinit'ed state, under the current determinism flags."""
    from nfdpm_tpu_torch.training import nf_trainer as nft
    from nfdpm_tpu_torch.utils.profiling import StepTimer

    cfg, tcfg = train_configs()
    tx = nft.optimizer_of(tcfg)
    batches = [torch.from_numpy(imgs).to("cuda")
               for imgs, _ in train_loaders(RESUME_STEPS).train.iter_epoch(0)]
    state = nft.ddinit_train_state(nft.init_train_state(TRAIN_SEED, cfg, tcfg, tx, "cuda"),
                                   cfg, tcfg, tx, batches[0],
                                   torch.Generator(device="cuda").manual_seed(1))
    step = nft.make_train_step(cfg, tcfg, tx, device="cuda")
    timer = StepTimer(synchronize="cuda")
    torch.cuda.synchronize()
    for i in range(steps + 1):  # the first is a warm-up
        with timer.step():
            state, _ = step(state, batches[i % len(batches)], TRAIN_SEED)
    return [d * 1e3 for d in timer.durations[1:]]


def median_of(values):
    v = sorted(values)
    return (v[(len(v) - 1) // 2] + v[len(v) // 2]) / 2


def resume_checks(torch, counters, kind, root: Path, gate: str) -> dict:
    """An uninterrupted run, and a second for the run-to-run gap where it is
    read (stage 1, and the tolerance gate); then one interrupted before
    batch RESUME_AT and resumed there: the marker's content, its removal,
    and the resumed state's gap to the first run. `gate`: "bitwise"
    (deterministic mode) or "twice the run-to-run gap"."""
    from nfdpm_tpu_torch.training import checkpoint as ckpt

    prefix = "gaussian" if kind == "stage1" else "diffusion"
    keys = ("params", "opt_state") + (("ema",) if kind == "stage2" else ())
    a = resume_trainer_run(torch, counters, kind, root / f"{kind}_a")
    run_gap = run_equal = b = None
    if kind == "stage1" or gate != "bitwise":
        b = resume_trainer_run(torch, counters, kind, root / f"{kind}_b")
        run_gap, run_equal = state_gap(torch, a["state"], b["state"], keys)
    cut = root / f"{kind}_cut"
    resume_trainer_run(torch, counters, kind, cut, interrupt=RESUME_AT)
    marker = ckpt.load_mid_epoch_marker(str(cut))
    check(marker == {"prefix": prefix, "epoch": 1, "batch_in_epoch": RESUME_AT},
          f"{kind}: the marker is {marker}")
    resumed = resume_trainer_run(torch, counters, kind, cut, resume_batch=RESUME_AT)
    check(ckpt.load_mid_epoch_marker(str(cut)) is None, f"{kind}: the marker outlived the run")
    resume_gap, resume_equal = state_gap(torch, a["state"], resumed["state"], keys)
    if gate == "bitwise":
        check(resume_equal, f"{kind}: the resumed run is {resume_gap} from the uninterrupted "
                            "one in deterministic mode")
    else:
        check(resume_gap <= 2 * run_gap, f"{kind}: the resumed run is {resume_gap} from the "
                                         f"uninterrupted one, twice the run-to-run gap "
                                         f"{run_gap} allows less")
    rec = {"kind": kind, "gate": gate, "uninterrupted_run": str(root / f"{kind}_a"),
           "marker": marker, "steps": RESUME_STEPS,
           "interrupted_before_batch": RESUME_AT, "resume_max_gap": resume_gap,
           "resume_bitwise_equal": resume_equal, "run_to_run_max_gap": run_gap,
           "run_to_run_bitwise_equal": run_equal, "state_leaves": list(keys)}
    if kind == "stage1":
        rec["run_to_run_bpd_gap"] = abs(a["results"]["bpd_test"] - b["results"]["bpd_test"])
        rec["resume_bpd_gap"] = abs(a["results"]["bpd_test"] - resumed["results"]["bpd_test"])
        rec["bpd_test"] = a["results"]["bpd_test"]
    return rec


def deterministic_resume(torch, counters, root: Path) -> None:
    """The subprocess of phase 23: both trainers' mid-epoch resume in
    deterministic mode (bitwise), falling back to the default mode with the
    tolerance gate for a trainer in which PyTorch names an operation that
    has no deterministic CUDA implementation; run to run; step wall ms.
    Prints its records and its launches."""
    for fn in counters:
        fn.launches = 0
    out = {"phase": "mid_epoch_resume_deterministic",
           "cublas_workspace_config": os.environ.get("CUBLAS_WORKSPACE_CONFIG")}
    for kind in ("stage1", "stage2"):
        set_deterministic(torch, True)
        try:
            out[kind] = resume_checks(torch, counters, kind, root / "deterministic", "bitwise")
        except RuntimeError as e:
            if "deterministic" not in str(e):
                raise
            # the op PyTorch names; then the default mode, said so, and the
            # tolerance gate
            op = str(e).strip().splitlines()[0]
            set_deterministic(torch, False)
            out[kind] = resume_checks(torch, counters, kind, root / "fallback",
                                      "twice the run-to-run gap")
            out[kind]["deterministic_mode_refused_by"] = op
            out[kind]["mode"] = "default (deterministic refused)"
        else:
            out[kind]["mode"] = "deterministic"
    set_deterministic(torch, True)
    try:
        walls = step_wall_ms(torch)
        out["step_wall_ms"] = walls
        out["step_wall_ms_median"] = median_of(walls)
    except RuntimeError as e:
        out["step_wall_ms"] = f"not measured: {str(e).splitlines()[0]}"
    out["launches"] = counts(counters)
    emit(out)


def phase_mid_epoch_resume(torch, counters, smi):
    """Phase 23: mid-epoch resume of both trainers, bitwise in deterministic
    mode (a subprocess with CUBLAS_WORKSPACE_CONFIG set); run to run in
    both modes; the watchdog on in every run, never firing; the profiler
    hook's trace; load.load_batch through the command line. Returns (the
    launches of the path, the stage-2 run directory that kept an EMA)."""
    root = ROOT / "build" / "chip_smoke" / "mid_epoch"
    shutil.rmtree(root, ignore_errors=True)
    (root / "outputs").mkdir(parents=True)
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT), NFDPM_NO_TENSORBOARD="1",
               **DETERMINISTIC_ENV)
    done = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                           "--deterministic-resume", str(root)],
                          env=env, capture_output=True, text=True, timeout=900)
    child = [json.loads(line) for line in done.stdout.splitlines() if line.startswith("{")]
    check(done.returncode == 0, f"the deterministic resume failed:\n{done.stdout[-2000:]}\n"
                                f"{done.stderr[-3000:]}")
    (det,) = [r for r in child if r.get("phase") == "mid_epoch_resume_deterministic"]
    emit(det)
    det_seconds = time.perf_counter() - t0

    # the default mode in this process: run to run, the step's wall ms
    set_deterministic(torch, False)
    a = resume_trainer_run(torch, counters, "stage1", root / "default_a")
    b = resume_trainer_run(torch, counters, "stage1", root / "default_b")
    default_gap, default_equal = state_gap(torch, a["state"], b["state"])
    walls = step_wall_ms(torch)

    # load.load_batch through the command line, from an interrupted run; the
    # command runs while this process takes the profiler's trace
    resume_trainer_run(torch, counters, "stage1", root / "outputs" / "cut",
                       interrupt=RESUME_AT)
    cli_env = dict(os.environ, PYTHONPATH=str(ROOT), NFDPM_NO_TENSORBOARD="1")
    t1 = time.perf_counter()
    cli = subprocess.Popen(
        [sys.executable, "-m", "nfdpm_tpu_torch.run_baseline", "data.name=synthetic",
         f"data.batch_size={BATCH}", f"data.img_size={IMG}",
         f"data.synthetic_n={BATCH * RESUME_STEPS}", f"model.architecture.L={LEVELS}",
         f"model.architecture.K={STEPS}", f"model.architecture.coupling_width={WIDTH}",
         "model.training.epochs=1", "model.training.print_freq=1",
         "model.training.save_checkpoint_freq=50",
         f"model.training.watchdog_timeout_s={WATCHDOG_S}", "experiment_name=resumed",
         "load.load_exp_dir=cut", "load.load_epoch=1", f"load.load_batch={RESUME_AT}"],
        cwd=root, env=cli_env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        # the profiler hook: profile_epoch 1, 3 steps; a trace without a device
        # event is taken again, up to three times (kernel_events)
        for attempt in range(1, 4):
            prof_dir = root / f"profiled_{attempt}"
            resume_trainer_run(torch, counters, "stage1", prof_dir, profile_epoch=1,
                               profile_steps=3)
            trace = prof_dir / "tb" / "profile" / "epoch_001.pt.trace.json"
            check(trace.exists(), f"profile_epoch wrote no trace at {trace}")
            events = json.loads(trace.read_text())["traceEvents"]
            kernels = sorted({e["name"] for e in events if e.get("cat") == "kernel"})
            mixes = [k for k in kernels if "channel_mix_" in k]
            if mixes:
                break
        check(bool(mixes), f"three profiled runs gave no channel_mix kernel in the trace: "
                           f"{kernels[:10]}")

        cli_out, cli_err = cli.communicate(timeout=600)
    finally:
        if cli.poll() is None:
            cli.kill()
            cli.wait()
    cli_seconds = time.perf_counter() - t1
    check(cli.returncode == 0, f"run_baseline load.load_batch failed:\n{cli_out[-1500:]}"
                               f"\n{cli_err[-1500:]}")
    check(f"Resumed from outputs/cut @ epoch 1 batch {RESUME_AT}" in cli_out,
          "the command line did not resume in the middle of the epoch")
    final = dict(re.findall(r"final (test|train) bpd: ([0-9.]+)", cli_out))
    iters = [int(i) for i in re.findall(r"epoch 1 iter (\d+):", cli_out)]
    check(len(final) == 2 and iters == list(range(RESUME_AT + 1, RESUME_STEPS + 1)),
          f"the resumed command line logged steps {iters} and final {final}")
    stalls = sorted(str(p.relative_to(root)) for p in root.rglob("watchdog_stall.txt"))
    check(not stalls, f"the watchdog fired: {stalls}")

    launches = counts(counters)
    for name, n in det["launches"].items():
        launches[name] += n
    emit({"phase": "mid_epoch_resume", "nvidia_smi": smi,
          "deterministic": {k: det[k] for k in ("stage1", "stage2")},
          "cublas_workspace_config": det["cublas_workspace_config"],
          "deterministic_seconds": det_seconds,
          "run_to_run": {
              # stage 2 runs one uninterrupted run where deterministic mode
              # holds: its pair would only show bitwise equality again
              "deterministic": {k: {"max_param_gap": det[k]["run_to_run_max_gap"],
                                    "bitwise_equal": det[k]["run_to_run_bitwise_equal"],
                                    "bpd_gap": det[k].get("run_to_run_bpd_gap"),
                                    "mode": det[k]["mode"]}
                                for k in ("stage1", "stage2")
                                if det[k]["run_to_run_max_gap"] is not None},
              "default": {"stage1": {
                  "max_param_gap": default_gap, "bitwise_equal": default_equal,
                  "bpd_gap": abs(a["results"]["bpd_test"] - b["results"]["bpd_test"])}}},
          "step_wall_ms_median": {"deterministic": det.get("step_wall_ms_median"),
                                  "default": median_of(walls)},
          "step_wall_ms": {"deterministic": det.get("step_wall_ms"), "default": walls},
          "watchdog_timeout_s": WATCHDOG_S, "watchdog_fired": False,
          "profiler": {"trace": str(trace.relative_to(ROOT)), "attempts": attempt,
                       "kernels": len(kernels), "channel_mix_kernels": mixes},
          "command_line": {"load_batch": RESUME_AT, "seconds": cli_seconds,
                           "final_bpd": final, "steps_logged": iters},
          "seconds": time.perf_counter() - t0, "launches": launches})
    return launches, Path(det["stage2"]["uninterrupted_run"])


def stage2_architecture() -> dict:
    """The diffusion_architecture.json of the stage-2 model of the paths."""
    return {"kind": "diffusion_prior",
            "flow": {"L": LEVELS, "K": STEPS, "in_channels": 3, "coupling_width": WIDTH,
                     "learn_prior": True, "invconv_param": "plu", "img_size": IMG},
            "formater": FORMATER, "formater_stats": None, "unet_kwargs": UNET_KWARGS,
            "diffusion_kwargs": DIFFUSION_KWARGS, "frozen": True, "n_bits": N_BITS,
            "temperature": 1.0}


@contextlib.contextmanager
def serving(serve, argv):
    """The server of `argv` on 127.0.0.1, answering on a thread: (its port,
    its /health)."""
    server = serve.make_server(argv + ["--batch", str(BATCH), "--port", "0"])
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        port_no = server.server_address[1]
        status, _, body = http_request(port_no, "GET", "/health")
        check(status == 200, f"/health of {argv} answered {status}")
        yield port_no, json.loads(body)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)


def generate(port_no, req, counters, per_chunk):
    """One /generate request: (uint8 samples, record); checks the samples'
    type and shape and the launches, exactly `per_chunk` per 64-image chunk."""
    import numpy as np

    before = counts(counters)
    t0 = time.perf_counter()
    status, headers, body = http_request(port_no, "POST", "/generate", req)
    wall = time.perf_counter() - t0
    check(status == 200, f"/generate {req} answered {status}")
    with np.load(io.BytesIO(body)) as data:
        samples = data["samples"]
    check(samples.dtype == np.uint8 and samples.shape == (req["n"], IMG, IMG, 3),
          f"/generate {req} gave {samples.dtype} {samples.shape}")
    chunks = -(-req["n"] // BATCH)
    after = counts(counters)
    delta = {k: after[k] - before[k] for k in before}
    check(delta == {k: v * chunks for k, v in per_chunk.items()},
          f"/generate {req}: launch counts {delta} for {chunks} chunk(s)")
    return samples, {"request": req, "wall_s": wall,
                     "generation_s": float(headers["X-Generation-Seconds"]),
                     "samples_per_s": req["n"] / float(headers["X-Generation-Seconds"]),
                     "launches": delta}


def sampling_chunk(sampling_timesteps: int = 0) -> dict:
    """Launches of one 64-image sampling chunk: the Glow's inverse, and with
    `sampling_timesteps` the stage-2 chains before it."""
    return {"channel_mix": 3 * STEPS, "coupling_tail": 0, "coupling_tail_bwd": 0,
            "coupling_tail_inverse": 3 * STEPS,
            "fused_linear_attention": LEVELS * sampling_timesteps
            * 2 * len(UNET_KWARGS["dim_mults"]),
            "fused_linear_attention_bwd": 0, "step_megakernel_forward": 0}


RUN_DIR_REQUEST = {"n": 128, "seed": 7}
EMA_DDIM = 10  # the EMA check's chains: DDIM-10, one chunk


def phase_run_dir_serving(torch, np, counters, smi, stage1_dir, stage2_dir, ema_dir):
    """Phase 24: nfdpm_tpu_torch.serve --run-dir on phase 12's stage-1 run
    and phase 17's stage-2 run, against --weights holding the same
    parameters: the same bytes for RUN_DIR_REQUEST, exact launches; /health
    reports run_dir, kind and epoch; then --no-ema against the EMA on the
    stage-2 run of phase 23 that kept one. Returns (the launches of the
    path, {kind: the samples})."""
    from nfdpm_tpu_torch import convert, serve
    from nfdpm_tpu_torch.convert import named_leaves
    from nfdpm_tpu_torch.training import runload

    out = ROOT / "build" / "chip_smoke" / "run_dir_serving"
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    for fn in counters:
        fn.launches = 0
    glow = runload.load_glow_run(str(stage1_dir), device="cuda")
    convert.save_npz(out / "glow.npz", convert.to_jax_params(glow.params))
    stage2 = runload.load_diffusion_run(str(stage2_dir), device="cuda")
    convert.save_npz(out / "diffusion.npz", convert.diffusion_to_jax_params(stage2.params))
    live = runload.load_diffusion_run(str(stage2_dir), use_ema=False, device="cuda")
    live_leaves = dict(named_leaves(live.params))
    check(all(torch.equal(x, live_leaves[k]) for k, x in named_leaves(stage2.params)),
          "phase 17's run kept no EMA, yet --no-ema reads other weights")
    del glow, stage2, live, live_leaves
    sources = {
        "gaussian": (stage1_dir, ["--weights", str(out / "glow.npz"), "--levels", str(LEVELS),
                                  "--steps", str(STEPS), "--width", str(WIDTH),
                                  "--img-size", str(IMG), "--n-bits", str(N_BITS)],
                     sampling_chunk()),
        "diffusion": (stage2_dir, ["--weights", str(out / "diffusion.npz"), "--arch",
                                   str(Path(stage2_dir) / "diffusion_architecture.json")],
                      sampling_chunk(DIFFUSION_KWARGS["sampling_timesteps"]))}
    served, record = {}, {"phase": "run_dir_serving", "nvidia_smi": smi,
                          "request": RUN_DIR_REQUEST}
    for kind, (run_dir, weights_argv, per_chunk) in sources.items():
        got = {}
        for source, argv in (("run_dir", ["--run-dir", str(run_dir)]), ("weights", weights_argv)):
            with serving(serve, argv) as (port_no, health):
                samples, rec = generate(port_no, RUN_DIR_REQUEST, counters, per_chunk)
            got[source] = (samples, rec, health)
        health = got["run_dir"][2]
        check(health["kind"] == kind and health["run_dir"] == str(run_dir)
              and health["epoch"] == 1, f"/health of --run-dir: {health}")
        check(np.array_equal(got["run_dir"][0], got["weights"][0]),
              f"{kind}: --run-dir and --weights gave different samples")
        served[kind] = got["run_dir"][0]
        record[kind] = {"run_dir": str(Path(run_dir).relative_to(ROOT)), "health": health,
                        "same_bytes_as_weights": True,
                        **{source: got[source][1] for source in got}}

    # --no-ema against the EMA, on a run that kept one (DDIM-10, one chunk)
    ema = {}
    for flag in ([], ["--no-ema"]):
        with serving(serve, ["--run-dir", str(ema_dir), "--ddim", str(EMA_DDIM), *flag]) as (
                port_no, health):
            ema[bool(flag)] = generate(port_no, {"n": BATCH, "seed": 7}, counters,
                                       sampling_chunk(EMA_DDIM))
            check(health["ema"] is not bool(flag), f"/health says ema {health['ema']}")
    check(not np.array_equal(ema[False][0], ema[True][0]),
          "--no-ema and the EMA weights gave the same samples")
    record["no_ema"] = {"run_dir": str(Path(ema_dir).relative_to(ROOT)), "ddim": EMA_DDIM,
                        "differs_from_ema": True, "ema": ema[False][1], "live": ema[True][1]}
    launches = counts(counters)
    record["launches"] = launches
    record["seconds"] = time.perf_counter() - t0
    emit(record)
    return launches, served


def stage1_config_yaml(run_dir: Path) -> None:
    """The config.yaml the entry point would have written for phase 12's run,
    which nf_trainer.train made directly (the interpolation reads its data
    config for the endpoints)."""
    from nfdpm_tpu_torch.run_baseline import CONFIG
    from nfdpm_tpu_torch.utils.config import load_config

    cfg = load_config(CONFIG, [
        "data.name=synthetic", f"data.batch_size={BATCH}", f"data.img_size={IMG}",
        f"data.synthetic_n={BATCH * TRAIN_STEPS}", f"seed={TRAIN_SEED}",
        f"model.architecture.L={LEVELS}", f"model.architecture.K={STEPS}",
        f"model.architecture.coupling_width={WIDTH}", "model.training.epochs=1"])
    (run_dir / "config.yaml").write_text(cfg.to_yaml())


INTERP_STEPS = 8
INTERP_T = 100  # the stage-2 strip's chain on the card: t = 100 of T = 1000


def phase_cli(np, smi, stage1_dir, stage2_dir, served):
    """Phase 25: python -m nfdpm_tpu_torch.generate_samples (n 128, batch 64,
    seed 7) and python -m nfdpm_tpu_torch.interpolate (steps 8; the stage-2
    strip at --t INTERP_T, a 100-step chain in place of the whole 1000: the
    whole chain is held against JAX on the CPU, test_torch_run_dir_tools.py)
    as four subprocesses on both run directories, started together: the
    generated samples are the server's of phase 24; the strip is
    (steps + 2, H, W, C) uint8, and for the Glow its lambda 0 and 1 columns
    are the endpoints' 5-bit codes within one 5-bit level (the round trip's
    error). The commands overlap: the phase's seconds are all four's."""
    out = ROOT / "build" / "chip_smoke" / "cli_tools"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    if not (Path(stage1_dir) / "config.yaml").exists():
        stage1_config_yaml(Path(stage1_dir))
    env = dict(os.environ, PYTHONPATH=str(ROOT), NFDPM_NO_TENSORBOARD="1")
    t0 = time.perf_counter()
    procs = {}
    for kind, run_dir in (("gaussian", stage1_dir), ("diffusion", stage2_dir)):
        commands = {
            "generate_samples": ["--n", str(RUN_DIR_REQUEST["n"]), "--batch", str(BATCH),
                                 "--seed", str(RUN_DIR_REQUEST["seed"])],
            "interpolate": ["--steps", str(INTERP_STEPS)]
            + (["--t", str(INTERP_T)] if kind == "diffusion" else [])}
        for tool, args in commands.items():
            argv = [sys.executable, "-m", f"nfdpm_tpu_torch.{tool}", "--run-dir", str(run_dir),
                    *args, "--out", str(out / kind)]
            procs[(kind, tool)] = subprocess.Popen(argv, cwd=out, env=env, text=True,
                                                   stdout=subprocess.PIPE,
                                                   stderr=subprocess.PIPE)
    done = {}
    try:
        for (kind, tool), proc in procs.items():
            stdout, stderr = proc.communicate(timeout=600)
            check(proc.returncode == 0, f"{tool} on the {kind} run failed:\n{stdout[-1500:]}"
                                        f"\n{stderr[-1500:]}")
            line = stdout.strip().splitlines()[-1]
            print(line, flush=True)
            done[(kind, tool)] = json.loads(line)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    record = {"phase": "cli", "nvidia_smi": smi, "interpolation_t": {"diffusion": INTERP_T},
              "concurrent": True}
    for kind in ("gaussian", "diffusion"):
        gen, interp = done[(kind, "generate_samples")], done[(kind, "interpolate")]
        with np.load(gen["npz"]) as data:
            samples = data["samples"]
        check(np.array_equal(samples, served[kind]),
              f"{kind}: generate_samples and the server gave different samples")
        with np.load(interp["npz"]) as data:
            strip = data["strip"]
        check(strip.dtype == np.uint8 and strip.shape == (INTERP_STEPS + 2, IMG, IMG, 3),
              f"{kind}: the strip is {strip.dtype} {strip.shape}")
        rec = {"generate_samples": gen, "samples_equal_server": True, "interpolate": interp}
        if kind == "gaussian":
            codes = (strip[[0, -1]] // 8 * 8).astype(int)
            ends = np.abs(strip[[1, -2]].astype(int) - codes)
            check(int(ends.max()) <= 8, f"lambda 0 and 1 are {int(ends.max())} levels from "
                                        "the endpoints' 5-bit codes")
            rec["endpoint_max_diff"] = int(ends.max())
            rec["endpoint_differing_share"] = float((ends > 0).mean())
        record[kind] = rec
    record["seconds"] = time.perf_counter() - t0
    emit(record)


# The port Unet's parameters under the original PyTorch repository's names
# (its lucidrains-style Unet): the inverse of the table of
# nfdpm_tpu_torch/utils/unet_import.py, kept here as test code.
_UNET_TOP = {"init_conv": "init_conv", "time_pos": "time_mlp.0", "time_dense0": "time_mlp.1",
             "time_dense1": "time_mlp.3", "final_conv": "final_conv"}
_UNET_BLOCKS = {"res1": "0", "res2": "1", "mid_res1": "mid_block1", "mid_res2": "mid_block2",
                "final_res": "final_res_block"}
_UNET_BLOCK_PARTS = {"time_dense": "mlp.1", "block0.conv": "block1.proj",
                     "block0.norm": "block1.norm", "block1.conv": "block2.proj",
                     "block1.norm": "block2.norm", "res_conv": "res_conv"}


def reference_unet_state_dict(unet) -> dict:
    """A port Unet's parameters as the reference's Unet.state_dict(): host
    tensors, conv weights OIHW as they are, w_qkv [C, 3h] as to_qkv
    [3h, C, 1, 1], w_out [h, C] as to_out [C, h, 1, 1], the norms' gains
    [C] as [1, C, 1, 1]."""
    out = {}
    for name, p in unet.named_parameters():
        a = p.detach().cpu().contiguous()
        prefix, leaf = name.rsplit(".", 1)
        parts = prefix.split(".")
        level = ".".join(parts[:2]) if parts[0] in ("downs", "ups") else None
        head, rest = (parts[2], parts[3:]) if level else (parts[0], parts[1:])
        if head in _UNET_BLOCKS:
            block = f"{level}.{_UNET_BLOCKS[head]}" if level else _UNET_BLOCKS[head]
            out[f"{block}.{_UNET_BLOCK_PARTS['.'.join(rest)]}.{leaf}"] = a
        elif head in ("attn", "mid_attn"):
            base = f"{level}.2" if level else "mid_attn"
            to_out = "to_out.0" if level else "to_out"  # the mid attention's is a plain conv
            if rest == ["norm"]:
                out[f"{base}.fn.norm.g"] = a.reshape(1, -1, 1, 1)
            elif leaf == "w_qkv":
                out[f"{base}.fn.fn.to_qkv.weight"] = a.t().contiguous()[:, :, None, None]
            elif leaf == "w_out":
                out[f"{base}.fn.fn.{to_out}.weight"] = a.t().contiguous()[:, :, None, None]
            elif leaf == "b_out":
                out[f"{base}.fn.fn.{to_out}.bias"] = a
            else:  # the linear attention's output LayerNorm
                out[f"{base}.fn.fn.to_out.1.g"] = a.reshape(1, -1, 1, 1)
        elif head in ("down", "up"):  # Downsample / Upsample, the last level a plain conv
            out[f"{level}.3{'.1' if rest else ''}.{leaf}"] = a
        else:
            out[f"{_UNET_TOP[head]}.{leaf}"] = a
    return out


def reference_layout_errors(flow_sd: dict) -> list:
    """Keys of an exported Glow state dict whose shape or dtype is not the
    reference's: conv weights OIHW (3x3 in the coupling CNN's first conv,
    the zeroconvs and the split priors, 1x1 in its second), actnorm
    [C, 1, 1], ZeroConv2d logs [1, C, 1, 1], invconv2d.weight [C, C, 1, 1],
    is_initialized uint8 1; the Glow L3/K4/w512 of 32x32x3."""
    import torch

    channels = {f"blocks.{b}": 3 * 4 * 2 ** b for b in range(LEVELS - 1)}
    channels["final_flows"] = 3 * 4 * 2 ** (LEVELS - 1)
    bad = []
    for key, v in flow_sd.items():
        c = next(n for prefix, n in channels.items() if key.startswith(prefix))
        if key.endswith("is_initialized"):
            ok = v.dtype == torch.uint8 and v.dim() == 0 and int(v) == 1
        elif key.endswith("invconv2d.weight"):
            ok = tuple(v.shape) == (c, c, 1, 1)
        elif key.endswith(("scale", "bias")) and "actnorm" in key:
            ok = tuple(v.shape) == ((WIDTH if "__actnorm" in key else c), 1, 1)
        elif key.endswith(".logs"):
            ok = tuple(v.shape) == (1, c, 1, 1)
        elif key.endswith("net.0._Conv2dActNorm__conv.weight"):
            ok = tuple(v.shape) == (WIDTH, c // 2, 3, 3)
        elif key.endswith("net.2._Conv2dActNorm__conv.weight"):
            ok = tuple(v.shape) == (WIDTH, WIDTH, 1, 1)
        elif key.endswith("net.4.weight"):
            ok = tuple(v.shape) == (c, WIDTH, 3, 3)
        elif key.endswith("split.conv.weight"):
            ok = tuple(v.shape) == (c, c // 2, 3, 3)
        else:  # the zeroconvs' biases
            ok = tuple(v.shape) == (c,)
        if not ok or (v.dtype != torch.float32 and not key.endswith("is_initialized")):
            bad.append(f"{key} {tuple(v.shape)} {v.dtype}")
    return bad


def phase_reference_checkpoints(torch, np, counters, smi, stage1_dir, stage2_dir):
    """Phase 26: checkpoints of the original PyTorch repository into and out
    of the port, on the card. (1) export phase 12's run twice (the same
    bytes), the reference's keys and layout; (2) import that .pt into a new
    run directory; (3) score one seeded batch on both runs; (4) sample a
    chunk on both through the route of serve --run-dir; (5) resume the
    imported run for RESUME_STEPS steps through run_baseline.main; (6) phase
    17's UNets through the reference's names and import_unet_state_dict, a
    DDIM-100 chunk bitwise equal to the run's own. Every launch is counted
    and held to its exact number. Returns the launches of the phase."""
    from nfdpm_tpu_torch import (convert_reference_checkpoint, export_reference_checkpoint,
                                 inference, run_baseline)
    from nfdpm_tpu_torch.ops.bijectors import invconv_weight
    from nfdpm_tpu_torch.training import runload
    from nfdpm_tpu_torch.utils.unet_import import import_unet_state_dict

    root = ROOT / "build" / "chip_smoke" / "reference"
    shutil.rmtree(root, ignore_errors=True)
    (root / "outputs").mkdir(parents=True)
    device = torch.device("cuda")
    per_pass = LEVELS * STEPS
    none = {name: 0 for name in counts(counters)}
    t0 = time.perf_counter()
    for fn in counters:
        fn.launches = 0
    record = {"phase": "reference_checkpoints", "nvidia_smi": smi}

    def delta_of(fn):
        before = counts(counters)
        out = fn()
        torch.cuda.synchronize()
        after = counts(counters)
        return out, {k: after[k] - before[k] for k in before}

    # 1. export, twice
    exports = [run_in(root, export_reference_checkpoint.main,
                      ["--run-dir", str(stage1_dir), "--out", str(root / name)])
               for name in ("export_a", "export_b")]
    pt = Path(exports[0]["written"][0])
    check(pt.read_bytes() == (root / "export_b" / pt.name).read_bytes(),
          "two exports of one run gave different bytes")
    ref = torch.load(pt, map_location="cpu", weights_only=True)
    check(set(ref) == {"flow", "prior_dist", "optimizer", "current_iter"}
          and ref["current_iter"] == 0, f"the export holds {sorted(ref)}")
    bad = reference_layout_errors(ref["flow"])
    check(not bad, f"exported tensors out of the reference's layout: {bad[:8]}")
    check((root / "export_a" / "model_001.pt").exists(), "no resume alias model_001.pt")
    record["export"] = {"keys": len(ref["flow"]), "flow_elements": exports[0]["flow_elements"],
                        "same_bytes_twice": True, "reference_layout": True}

    # 2. import into a new run directory
    imported = root / "outputs" / "imported"
    run_in(root, convert_reference_checkpoint.main, [
        "--checkpoint", str(pt), "--L", str(LEVELS), "--K", str(STEPS), "--in_channels", "3",
        "--img_size", str(IMG), "--coupling_width", str(WIDTH), "--n_bits", str(N_BITS),
        "--out", str(imported), "--epoch", "1"])

    # 3. score one seeded batch on both runs
    runs = {"trained": runload.load_glow_run(str(stage1_dir), device=device),
            "imported": runload.load_glow_run(str(imported), device=device)}
    imgs = np.random.default_rng(26).integers(0, 256, (BATCH, IMG, IMG, 3), dtype=np.uint8)
    batch = torch.from_numpy(imgs.astype(np.float32) / 255.0).to(device)
    noise = torch.rand(batch.shape, generator=torch.Generator(device="cuda").manual_seed(27),
                       device=device)
    forward = dict(none, channel_mix=per_pass, coupling_tail=per_pass)
    bpd = {}
    for name, run in runs.items():
        step = inference.make_eval_step(run.gcfg, N_BITS, device=device)
        bpd[name], launched = delta_of(lambda: step(run.params, batch, noise=noise))
        check(launched == forward, f"scoring the {name} run launched {launched}")
    gap = float((bpd["trained"] - bpd["imported"]).abs().max())
    check(bool(torch.isfinite(bpd["imported"]).all()) and gap <= 1e-4,
          f"the imported run scores {gap} bits/dim from the trained one")
    # what the W -> PLU -> W round trip did to the 1x1 convolutions
    def invconvs(flow):
        for block in flow["blocks"]:
            yield from (s["invconv"] for s in block["steps"])
        yield from (s["invconv"] for s in flow["final_steps"])

    pairs = list(zip(invconvs(runs["trained"].params["flow"]),
                     invconvs(runs["imported"].params["flow"])))
    record["score"] = {
        "bpd_mean": float(bpd["imported"].mean()), "max_bpd_gap": gap, "tolerance": 1e-4,
        "launches_per_forward": forward,
        "max_invconv_weight_gap": max(float((invconv_weight(a) - invconv_weight(b)).abs().max())
                                      for a, b in pairs),
        "permutations_changed": sum(not torch.equal(a["p_mat"], b["p_mat"]) for a, b in pairs)}

    # 4. a chunk on both runs, through serve --run-dir's route, one seed
    temperature = runs["trained"].temperature
    chunk = dict(none, channel_mix=per_pass, coupling_tail_inverse=per_pass)
    samples = {}
    for name, run_dir in (("trained", stage1_dir), ("imported", imported)):
        kind, run = runload.load_run(str(run_dir), device=device)
        fn = runload.sample_fn_of(kind, run, device)
        samples[name], launched = delta_of(
            lambda: inference.generate_batched(fn, run.params, BATCH, BATCH, temperature, 7))
        check(kind == "gaussian" and launched == chunk,
              f"a chunk of the {name} run launched {launched}")
    diff = np.abs(samples["trained"].astype(int) - samples["imported"].astype(int))
    share = float((diff > 0).mean())
    check(int(diff.max()) <= 8 and share <= 1e-3,
          f"the imported run's samples are {int(diff.max())} levels apart on {share} of values")
    record["sample"] = {"max_level_gap": int(diff.max()), "differing_share": share,
                        "temperature": temperature, "launches_per_chunk": chunk}
    del runs

    # 5. resume the imported run through the entry point
    os.environ["NFDPM_NO_TENSORBOARD"] = "1"
    evals = len(train_loaders(RESUME_STEPS).test) + len(train_loaders(RESUME_STEPS).eval)
    expected = stage1_run_launches(RESUME_STEPS, evals)
    t1 = time.perf_counter()
    result, launched = delta_of(lambda: run_in(root, run_baseline.main, [
        "data.name=synthetic", f"data.batch_size={BATCH}", f"data.img_size={IMG}",
        f"data.synthetic_n={BATCH * RESUME_STEPS}", f"seed={TRAIN_SEED}",
        f"model.architecture.L={LEVELS}", f"model.architecture.K={STEPS}",
        f"model.architecture.coupling_width={WIDTH}", "model.training.epochs=1",
        "model.training.print_freq=1", "model.training.save_checkpoint_freq=50",
        "experiment_name=resumed", "load.load_exp_dir=imported", "load.load_epoch=1"]))
    resume_seconds = time.perf_counter() - t1
    check(launched == expected, f"resuming the imported run launched {launched}, "
                                f"expected {expected}")
    final = result["results"]
    check(all(math.isfinite(v) for v in final.values()), f"the resumed run ended at {final}")
    state = torch.load(root / result["run_dir"] / "checkpoints" / "model_gaussian_002.pt",
                       map_location="cpu", weights_only=True)
    check(state["opt_state"]["count"] == RESUME_STEPS and state["step"] == RESUME_STEPS,
          f"the resumed run's checkpoint has Adam count {state['opt_state']['count']}, "
          f"step {state['step']}")
    record["resume"] = {"steps": RESUME_STEPS, "final_bpd": final, "adam_count": RESUME_STEPS,
                        "seconds": resume_seconds, "launches": launched}
    del state

    # 6. phase 17's UNets through the reference's names
    run = runload.load_diffusion_run(str(stage2_dir), device=device)
    dp = run.dp
    unets = []
    for i, unet in enumerate(run.params["diffusion"]["parts"]):
        path = root / f"unet_{i}.pt"
        torch.save(reference_unet_state_dict(unet), path)
        rebuilt = dp.build_unet(i)
        rebuilt.load_state_dict(import_unet_state_dict(
            torch.load(path, map_location="cpu", weights_only=True),
            len(UNET_KWARGS["dim_mults"])), strict=True)
        unets.append(dp.place(rebuilt, device))
    latents = {}
    for name, parts in (("run", run.params["diffusion"]["parts"]), ("imported", unets)):
        gen = torch.Generator(device="cuda").manual_seed(2026)
        with torch.no_grad():
            latents[name], launched = delta_of(
                lambda: dp.sample_latents({"parts": parts}, BATCH, generator=gen))
        ddim = dict(none, fused_linear_attention=LEVELS * DIFFUSION_KWARGS["sampling_timesteps"]
                    * 2 * len(UNET_KWARGS["dim_mults"]))
        check(launched == ddim, f"the {name} UNets' DDIM chunk launched {launched}")
    equal = all(torch.equal(a, b) for a, b in zip(latents["run"], latents["imported"]))
    check(equal, "the imported UNets' latents differ from the run's own")
    record["unet_import"] = {"parts": len(unets), "ddim_steps":
                             DIFFUSION_KWARGS["sampling_timesteps"], "batch": BATCH,
                             "latents_bitwise_equal": True, "launches_per_chunk": ddim}

    launches = counts(counters)
    record["launches"] = launches
    record["seconds"] = time.perf_counter() - t0
    emit(record)
    return launches


# -- bf16 mixed precision ------------------------------------------------------

MP_TRAIN_STEPS = 8     # (b): one epoch of run_baseline.main a dtype, batch 64
MP_STAGE2_STEPS = 11   # (c): one epoch of run_diffusion_prior.main, batch 64; under
# STAGE2_GRIDS, so that the run's one sample grid is its checkpoint's
MP_TIMED = 8           # synchronised steps timed after two more (a depth cut; PERF.md §7)
MP_STAGE2_T = 100      # (c): the run's diffusion T, cut from the config's 1000 so that
# its VLB batch and its phase=eval's fit the proof run's 800 s
MP_SERVE_REQUEST = {"n": BATCH, "seed": 7}  # (d): one chunk (phase 24 serves two)
MP_ROUTE_TOL = 1e-3    # bf16 bits/dim, kernel route against plain route
MP_BPD_REL_TOL = 1e-2  # bf16 against fp32 on the same weights: scoring, each train step
MP_UNET_TOL = 5e-2     # a UNet's bf16 output against fp32, of its largest entry
MP_STEP_RT_TOL = 2e-3  # one step's inverse(forward(y)) - y in bf16: the inverse's CNN
# sees the forward's input bit for bit, so both directions evaluate one function
MP_RT_TOL = 1e-2       # the whole flow's: down the chain, a step's inverse gets its
# forward's input only to fp32 roundoff, and the bf16 cast can turn that into
# one bf16 ulp (2^-8 relative) of a CNN input; measured 2.96e-3 on an H100 (PERF.md §6)


def conv_dtype_counter(torch):
    """A TorchDispatchMode that counts convolutions by the dtype of their
    input: what runs in bf16 and what in fp32. Under inference_mode the
    mode sees aten.conv2d, which is not yet decomposed into
    aten.convolution there."""
    import collections

    from torch.utils._python_dispatch import TorchDispatchMode

    class ConvDtypes(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.counts = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.overloadpacket.__name__ in ("conv2d", "convolution"):
                self.counts[str(args[0].dtype).replace("torch.", "")] += 1
            return func(*args, **(kwargs or {}))

    return ConvDtypes()


def conv_device_ms(events) -> dict:
    """Device ms of one call's cuDNN kernels (profiling.group_of's two
    convolution groups) by dtype, from kernel_events, and their names: a
    kernel whose name says bf16 is bf16, any other fp32."""
    from nfdpm_tpu_torch.profiling import group_of

    out = {"bfloat16_ms": 0.0, "float32_ms": 0.0, "kernels": {}}
    for name, us in events:
        if "convolution" not in group_of(name):
            continue
        dtype = "bfloat16" if re.search("bf16|bfloat16", name, re.I) else "float32"
        out[f"{dtype}_ms"] += us / 1e3
        short = name[:110]
        out["kernels"][short] = out["kernels"].get(short, 0.0) + us / 1e3
    return out


def host_ops(torch, fn, top: int = 10) -> list:
    """[op, calls, host ms] of the aten operators with the most host (self
    CPU) time in one call of `fn`, from torch.profiler over the CPU alone
    (recording slows the host, so read the shares, not the sum)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:top]
    return [[e.key, e.count, e.self_cpu_time_total / 1e3] for e in rows]


def record_of(phase: str):
    return next((r for r in RECORDS if r.get("phase") == phase), None)


def step_walls(torch, step, n: int, counters, per_step: dict, what: str) -> list:
    """Wall ms of n synchronised calls of `step()` (which returns the new
    state's holder), each call's launches checked to be `per_step`."""
    walls = []
    for i in range(n):
        before = counts(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        after = counts(counters)
        delta = {k: after[k] - before[k] for k in before}
        check(delta == per_step, f"{what} {i} launched {delta}, expected {per_step}")
    return walls


def quartiles(timed: list) -> list:
    """The first and third quartiles of sorted values (the 4th and 12th of 16)."""
    return [timed[len(timed) // 4 - 1], timed[3 * len(timed) // 4 - 1]]


def spread(walls: list) -> dict:
    timed = sorted(walls[-MP_TIMED:])
    return {"median_ms": median_of(timed), "min_ms": timed[0], "max_ms": timed[-1],
            "quartiles_ms": quartiles(timed), "steps": MP_TIMED}


def mp_glow(torch, np, counters, none):
    """(a) Glow scoring in bf16 beside fp32 on one set of weights."""
    from nfdpm_tpu_torch import inference
    from nfdpm_tpu_torch.models import glow as glow_m
    from nfdpm_tpu_torch.models import prior as prior_m
    from nfdpm_tpu_torch.ops import bijectors as bj
    from nfdpm_tpu_torch.ops import quantize as q

    device = torch.device("cuda")
    cfg32 = glow_m.GlowConfig(levels=LEVELS, steps=STEPS, coupling_width=WIDTH)
    cfg16 = dataclasses.replace(cfg32, coupling_dtype="bfloat16")
    params = {"flow": glow_m.init_glow(0, cfg32, device),
              "prior": prior_m.init_gaussian_prior(glow_m.final_channels(cfg32), True, device)}
    randomize_zero_leaves(torch, params, seed=1)
    imgs = np.random.default_rng(2).integers(0, 256, (BATCH, IMG, IMG, 3), dtype=np.uint8)
    batch = torch.from_numpy(imgs.astype(np.float32) / 255.0).to(device)
    noise = torch.rand(batch.shape, generator=torch.Generator(device="cuda").manual_seed(3),
                       device=device)
    per_pass = LEVELS * STEPS
    evals = {name: inference.make_eval_step(c, N_BITS, device=device) for name, c in (
        ("bf16", cfg16), ("bf16_plain", dataclasses.replace(cfg16, use_kernels=False)),
        ("fp32", cfg32))}

    before = counts(counters)
    counter = conv_dtype_counter(torch)
    with counter:
        bpd16 = evals["bf16"](params, batch, noise=noise)
    torch.cuda.synchronize()
    after = counts(counters)
    fwd = {k: after[k] - before[k] for k in before}
    check(fwd == dict(none, channel_mix=per_pass, coupling_tail=per_pass),
          f"one bf16 forward launched {fwd}")
    splits = LEVELS - 1
    fwd_convs = dict(counter.counts)
    check(fwd_convs == {"bfloat16": 2 * per_pass, "float32": per_pass + splits},
          f"one bf16 forward ran convolutions {fwd_convs}")
    bpd_plain = evals["bf16_plain"](params, batch, noise=noise)
    bpd32 = evals["fp32"](params, batch, noise=noise)
    check(bool(torch.isfinite(bpd16).all()) and tuple(bpd16.shape) == (BATCH,),
          "bf16 bits/dim not finite or of the wrong shape")
    route_gap = float((bpd16 - bpd_plain).abs().max())
    check(route_gap <= MP_ROUTE_TOL, f"bf16 kernel and plain bits/dim differ by {route_gap}")
    rel = float(((bpd16 - bpd32).abs() / bpd32.abs()).max())
    check(rel <= MP_BPD_REL_TOL, f"bf16 bits/dim {rel} (relative) from fp32's")
    check(not torch.equal(bpd16, bpd32), "bf16 gave fp32's bits/dim: bf16 did not run")

    x = q.dequantize(None, q.preprocess(batch, N_BITS), N_BITS, noise)
    with torch.inference_mode():
        latents, _, _ = glow_m.forward(params["flow"], cfg16, x)
        before = counts(counters)
        counter = conv_dtype_counter(torch)
        with counter:
            back = glow_m.inverse(params["flow"], cfg16, latents)
        torch.cuda.synchronize()
        after = counts(counters)
    inv = {k: after[k] - before[k] for k in before}
    check(inv == dict(none, channel_mix=per_pass, coupling_tail_inverse=per_pass),
          f"one bf16 inverse launched {inv}")
    inv_convs = dict(counter.counts)
    check(inv_convs == {"bfloat16": 2 * per_pass, "float32": per_pass},
          f"one bf16 inverse ran convolutions {inv_convs}")
    rt = float((back - x).abs().max())
    check(rt <= MP_RT_TOL, f"bf16 inverse(forward(x)) is off by {rt}")
    step = params["flow"]["blocks"][0]["steps"][0]
    with torch.inference_mode():
        y0 = bj.squeeze_forward(x)
        y1, _ = bj.step_forward(step, y0, torch.zeros((BATCH,), device=device), True,
                                torch.bfloat16)
        step_rt = float((bj.step_inverse(step, y1, True, torch.bfloat16) - y0).abs().max())
    check(step_rt <= MP_STEP_RT_TOL, f"one bf16 step's inverse(forward(y)) is off by {step_rt}")

    times = {}
    for name, c in (("bf16", cfg16), ("fp32", cfg32)):
        def fwd_only(c=c):
            with torch.inference_mode():
                return glow_m.forward(params["flow"], c, x)
        times[name] = {"device_ms": graph_ms(fwd_only, calls=3, replays=5),
                       "wall_ms": host_ms(torch, lambda: evals[name](params, batch,
                                                                     noise=noise)),
                       "cudnn": conv_device_ms(kernel_events(torch, fwd_only)),
                       "activities": len(kernel_events(torch, fwd_only)),
                       "host_ops": host_ops(torch, fwd_only)}
    return {"bpd_mean": float(bpd16.mean()), "fp32_bpd_mean": float(bpd32.mean()),
            "max_rel_bpd_gap_to_fp32": rel, "rel_tolerance": MP_BPD_REL_TOL,
            "max_route_bpd_gap": route_gap, "route_tolerance": MP_ROUTE_TOL,
            "round_trip_max_abs_err": rt, "round_trip_tolerance": MP_RT_TOL,
            "step_round_trip_max_abs_err": step_rt, "step_round_trip_tolerance": MP_STEP_RT_TOL,
            "launches_one_forward": fwd, "launches_one_inverse": inv,
            "convolutions_one_forward": fwd_convs, "convolutions_one_inverse": inv_convs,
            "timing": times}


def mp_stage1(torch, counters, none):
    """(b) Stage-1 training through run_baseline.main, bf16 and fp32 on the
    same batches and noise; then bf16 steps one by one."""
    from nfdpm_tpu_torch import run_baseline
    from nfdpm_tpu_torch.convert import named_leaves
    from nfdpm_tpu_torch.profiling import profile_call
    from nfdpm_tpu_torch.training import nf_trainer as nft
    from nfdpm_tpu_torch.training.checkpoint import restore_state

    root = ROOT / "build" / "chip_smoke" / "mixed_precision"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    os.environ["NFDPM_NO_TENSORBOARD"] = "1"
    per_pass = LEVELS * STEPS
    loaders = train_loaders(MP_TRAIN_STEPS)
    expected = stage1_run_launches(MP_TRAIN_STEPS, len(loaders.test) + len(loaders.eval))
    runs = {}
    for name, dtype in (("bf16", "bfloat16"), ("fp32", "float32")):
        before = counts(counters)
        t0 = time.perf_counter()
        result = run_in(root, run_baseline.main, [
            "data.name=synthetic", f"data.batch_size={BATCH}", f"data.img_size={IMG}",
            f"data.synthetic_n={BATCH * MP_TRAIN_STEPS}", f"seed={TRAIN_SEED}",
            f"model.architecture.L={LEVELS}", f"model.architecture.K={STEPS}",
            f"model.architecture.coupling_width={WIDTH}",
            f"model.architecture.coupling_dtype={dtype}", "model.training.epochs=1",
            "model.training.print_freq=1", "model.training.save_checkpoint_freq=50",
            f"experiment_name=stage1_{name}"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        after = counts(counters)
        launched = {k: after[k] - before[k] for k in before}
        check(launched == expected, f"the {name} stage-1 run launched {launched}, "
                                    f"expected {expected}")
        run_dir = root / result["run_dir"]
        records = [json.loads(line) for line in
                   (run_dir / "metrics.jsonl").read_text().splitlines()]
        bpds = [r["value"] for r in records
                if r["name"] == "bpd" and r["context"] == {"subset": "train"}]
        check(len(bpds) == MP_TRAIN_STEPS and all(map(math.isfinite, bpds)),
              f"the {name} run logged bits/dim {bpds}")
        runs[name] = {"run_dir": run_dir, "bpd_per_step": bpds, "seconds": seconds,
                      "final": result["results"]}
    b16, b32 = runs["bf16"]["bpd_per_step"], runs["fp32"]["bpd_per_step"]
    check(sum(b16[-4:]) < sum(b16[:4]), f"bf16 bits/dim did not fall: {b16}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(b16, b32))
    check(rel <= MP_BPD_REL_TOL, f"bf16 training bits/dim {rel} (relative) from fp32's")
    check(b16 != b32, "the bf16 run gave the fp32 run's bits/dim")

    # the gradients of the first step from the bf16 run's state (its
    # zeroconvs have moved from zero, so every trained leaf gets one; the
    # fixed prior's leaves are not trained), then steps one by one
    device = torch.device("cuda")
    cfg, tcfg = train_configs()
    cfg = dataclasses.replace(cfg, coupling_dtype="bfloat16")
    tx = nft.optimizer_of(tcfg)
    state = restore_state(str(runs["bf16"]["run_dir"]), "gaussian", 1, device)
    batches = [torch.from_numpy(imgs).to(device) for imgs, _ in loaders.train.iter_epoch(1)]
    noise = torch.rand(batches[0].shape, generator=torch.Generator(device="cuda").manual_seed(5),
                       device=device)
    bpd, _ = nft.make_loss_fn(cfg, tcfg)(state["params"], batches[0], noise=noise)
    bpd.backward()
    leaves = [(k, p) for k, p in named_leaves(state["params"])
              if p.requires_grad and not k.startswith("prior/")]
    bad = [k for k, p in leaves if p.grad is None or p.grad.dtype != torch.float32
           or not bool(torch.isfinite(p.grad).all()) or float(p.grad.abs().max()) == 0.0]
    check(not bad and len(leaves) > 100, f"bf16 gradients missing, not fp32, not finite "
                                         f"or zero: {bad}")
    for _, leaf in named_leaves(state["params"]):
        leaf.grad = None
    step = nft.make_train_step(cfg, tcfg, tx, device=device)
    per_step = dict(none, channel_mix=2 * per_pass - 1, coupling_tail=per_pass,
                    coupling_tail_bwd=per_pass)
    cycle = itertools.cycle(batches)

    def one():
        nonlocal state
        state, _ = step(state, next(cycle), TRAIN_SEED)

    torch.cuda.reset_peak_memory_stats()
    walls = step_walls(torch, one, MP_TIMED + 2, counters, per_step, "bf16 stage-1 step")
    peak = torch.cuda.max_memory_allocated()
    prof = profile_call(one, iters=1, warmup=1, top=12)
    events = kernel_events(torch, one)
    ops = {"bf16": host_ops(torch, one)}
    step32 = nft.make_train_step(dataclasses.replace(cfg, coupling_dtype="float32"), tcfg, tx,
                                 device=device)

    def one32():
        nonlocal state
        state, _ = step32(state, batches[0], TRAIN_SEED)

    ops["fp32"] = host_ops(torch, one32)
    fp32 = record_of("training_steps")
    return {"steps": MP_TRAIN_STEPS, "bpd_per_step": b16, "fp32_bpd_per_step": b32,
            "max_rel_bpd_gap_to_fp32": rel, "rel_tolerance": MP_BPD_REL_TOL,
            "run_seconds": {k: v["seconds"] for k, v in runs.items()},
            "final": {k: v["final"] for k, v in runs.items()}, "run_launches": expected,
            "gradient_leaves_checked": len(leaves), "launches_per_step": per_step,
            "step_wall_ms": walls, "step_wall": spread(walls),
            "images_per_s": BATCH / spread(walls)["median_ms"] * 1e3,
            "max_memory_allocated_bytes": peak, "profile_one_step": prof,
            "cudnn_one_step": conv_device_ms(events), "activities_one_step": len(events),
            "host_ops_one_step": ops,
            "fp32_phase13": None if fp32 is None else {
                "step_wall_ms_median_last16": fp32["step_wall_ms_median_last16"],
                "step_wall_ms_min_last16": fp32["step_wall_ms_min_last16"],
                "step_wall_ms_max_last16": fp32["step_wall_ms_max_last16"],
                "max_memory_allocated_bytes": fp32["max_memory_allocated_bytes"],
                "device_ms": fp32["profile_one_step"].get("device_ms"),
                "device_busy_share": fp32["profile_one_step"].get("device_busy_share")}}


def mp_stage2(torch, counters, none, stage1_dir):
    """(c) Stage 2 through run_diffusion_prior.main with bf16 UNets and a
    bf16 frozen flow; its phase=eval; then bf16 beside fp32 on the trained
    weights: one UNet, a DDIM-100 chunk, a VLB batch, train steps."""
    import numpy as np

    from nfdpm_tpu_torch import inference, run_diffusion_prior
    from nfdpm_tpu_torch.profiling import profile_call
    from nfdpm_tpu_torch.training import diffusion_trainer as dt
    from nfdpm_tpu_torch.training import runload

    root = ROOT / "build" / "chip_smoke" / "mixed_precision"
    (root / "outputs").mkdir(parents=True, exist_ok=True)
    link = root / "outputs" / "stage1"
    if not link.exists():
        link.symlink_to(stage1_dir)
    overrides = stage2_overrides("stage1", MP_STAGE2_STEPS) + [
        "model.diffusion.unet_dtype=bfloat16",
        "model.normalizing_flow.coupling_dtype=bfloat16",
        f"model.diffusion.timesteps={MP_STAGE2_T}"]
    per_step = stage2_per_step(frozen=True)
    expected = stage2_run_launches(per_step, MP_STAGE2_STEPS, MP_STAGE2_T)
    before = counts(counters)
    t0 = time.perf_counter()
    result = run_in(root, run_diffusion_prior.main, overrides + ["experiment_name=stage2_bf16"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    after = counts(counters)
    launched = {k: after[k] - before[k] for k in before}
    check(launched == expected, f"the bf16 stage-2 run launched {launched}, "
                                f"expected {expected}")
    run_dir = root / result["run_dir"]
    records = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    losses = [r["value"] for r in records
              if r["name"] == "l1" and r["context"] == {"subset": "train"}]
    check(len(losses) == MP_STAGE2_STEPS and all(map(math.isfinite, losses)),
          f"the bf16 stage-2 run logged losses {losses}")
    check(sum(losses[-4:]) < sum(losses[:4]), f"the bf16 stage-2 loss did not fall: {losses}")
    arch = json.loads((run_dir / "diffusion_architecture.json").read_text())
    check(arch["unet_kwargs"]["dtype"] == "bfloat16" and "coupling_dtype" not in arch["flow"],
          f"diffusion_architecture.json: {arch['unet_kwargs']}, {arch['flow']}")
    vlb_line = f"{result['vlb_bpd']:.4f}"
    evaluated = run_in(root, run_diffusion_prior.main, overrides + [
        "experiment_name=stage2_bf16_eval", "phase=eval", f"load.load_exp_dir={run_dir.name}",
        "load.load_epoch=1"])
    check(f"{evaluated['vlb_bpd']:.4f}" == vlb_line,
          f"phase=eval gave VLB {evaluated['vlb_bpd']}, training logged {vlb_line}")

    # bf16 beside fp32 on the trained weights
    device = torch.device("cuda")
    run = runload.load_diffusion_run(str(run_dir), use_ema=False, device=device)
    backbone16 = dataclasses.replace(run.backbone, cfg=dataclasses.replace(
        run.backbone.cfg, coupling_dtype="bfloat16"))
    dp16, dp32 = run.dp, stage2_prior(timesteps=MP_STAGE2_T)
    unets32 = []
    for i, unet in enumerate(run.params["diffusion"]["parts"]):
        check(unet.dtype == torch.bfloat16, f"runload rebuilt a {unet.dtype} UNet")
        u32 = dp32.build_unet(i)
        u32.load_state_dict(unet.state_dict())
        unets32.append(dp32.place(u32, device))
    models = {"bf16": (backbone16, dp16, run.params),
              "fp32": (run.backbone, dp32, dict(run.params, diffusion={"parts": unets32}))}
    h, w, c = dp16.formater.input_shapes[0]
    gen = torch.Generator(device="cuda").manual_seed(12)
    xu = torch.randn((BATCH, h, w, c), generator=gen, device=device)
    tu = torch.randint(0, MP_STAGE2_T, (BATCH,), generator=gen, device=device)
    with torch.no_grad():
        out16 = run.params["diffusion"]["parts"][0](xu, tu)
        out32 = unets32[0](xu, tu)
    unet_gap = float((out16 - out32).abs().max()) / float(out32.abs().max())
    check(out16.dtype == torch.float32 and unet_gap <= MP_UNET_TOL and unet_gap > 0,
          f"a bf16 UNet's output is {unet_gap} of the largest entry from fp32's")

    imgs = np.random.default_rng(8).integers(0, 256, (VLB_BATCH, IMG, IMG, 3), dtype=np.uint8)
    vlb_batch = torch.from_numpy(imgs.astype(np.float32) / 255.0).to(device)
    blocks = 2 * len(UNET_KWARGS["dim_mults"])
    chunk = sampling_chunk(DIFFUSION_KWARGS["sampling_timesteps"])
    # the VLB batch at phase 10's cut T (30 UNet calls, not the full 750,
    # which take 15 s a dtype): the prior of T = 40 over the same UNets
    vlb_prior = stage2_prior(timesteps=PROFILE_TIMESTEPS, sampling_timesteps=PROFILE_TIMESTEPS)
    vlb_launches = dict(none, channel_mix=3 * STEPS, coupling_tail=3 * STEPS,
                        fused_linear_attention=LEVELS * blocks * -(
                            -PROFILE_TIMESTEPS // DIFFUSION_KWARGS["vlb_time_chunk"]))
    train_batches = [torch.from_numpy(i).to(device) for i, _ in
                     list(train_loaders(MP_STAGE2_STEPS).train.iter_epoch(1))[:4]]
    compared = {}
    for name, (backbone, dp, params) in models.items():
        sample = inference.make_diffusion_sample_fn(backbone, dp, N_BITS, device)
        vlb = inference.make_vlb_eval_step(backbone, vlb_prior, N_BITS, device=device)
        ms = {}
        for key, fn, want in (
                ("chunk", lambda: sample(params, BATCH, generator=torch.Generator(
                    device="cuda").manual_seed(10)), chunk),
                ("vlb", lambda: vlb(params, vlb_batch, generator=torch.Generator(
                    device="cuda").manual_seed(9)), vlb_launches)):
            walls = step_walls(torch, fn, 1, counters, want, f"the {name} {key}")
            ms[f"{key}_ms"] = walls[0]
        ms["vlb_timesteps"] = PROFILE_TIMESTEPS
        # the checkpoint's state, its UNets built by this prior in its dtype
        state = dt.restore_train_state(str(run_dir), 1, backbone, dp, False, device)
        tcfg = dt.DiffusionTrainConfig(lr_diffusion=1e-3, n_bits=N_BITS)
        tx = dt.make_two_group_optimizer(tcfg, True)
        step = dt.make_train_step(backbone, dp, tcfg, tx, device=device)
        cycle = itertools.cycle(train_batches)

        def one():
            nonlocal state
            state, _ = step(state, next(cycle), TRAIN_SEED)

        torch.cuda.reset_peak_memory_stats()
        walls = step_walls(torch, one, MP_TIMED + 2, counters, per_step,
                           f"the {name} stage-2 step")
        peak = torch.cuda.max_memory_allocated()
        prof = profile_call(one, iters=1, warmup=1, top=12)
        events = kernel_events(torch, one)
        compared[name] = {**ms, "step_wall_ms": walls, "step_wall": spread(walls),
                          "images_per_s": BATCH / spread(walls)["median_ms"] * 1e3,
                          "max_memory_allocated_bytes": peak, "profile_one_step": prof,
                          "cudnn_one_step": conv_device_ms(events),
                          "activities_one_step": len(events)}
        del state, step
    scored = next((r for r in RECORDS if r.get("phase") == "profile_routes"
                   and r.get("path") == "score"), None)
    earlier = {key: (None if (r := record_of(phase)) is None else r.get(field)) for
               key, phase, field in (("vlb_ms_phase7_full_t", "stage2_scoring", "ms_per_batch"),
                                     ("chunk_ms_phase8", "stage2_sampling", "ms_per_chunk"),
                                     ("step_wall_ms_median_phase17", "stage2_training",
                                      "step_wall_ms_median_timed"))}
    earlier["vlb_ms_phase10_t40"] = None if scored is None else scored["kernels_median_ms"]
    return {"steps": MP_STAGE2_STEPS, "timesteps": MP_STAGE2_T, "seconds": seconds,
            "loss_per_step": losses,
            "vlb_bpd": result["vlb_bpd"], "eval_vlb_bpd": evaluated["vlb_bpd"],
            "eval_reproduced": True, "run_launches": expected,
            "unet_rel_gap_to_fp32": unet_gap, "unet_tolerance": MP_UNET_TOL,
            "compared": compared, "fp32_earlier_phases": earlier}, run_dir


def mp_serving(torch, np, counters, run_dir):
    """(d) serve --run-dir on (c)'s run against --arch/--weights of the same
    parameters: the same bytes for MP_SERVE_REQUEST."""
    from nfdpm_tpu_torch import convert, serve
    from nfdpm_tpu_torch.training import runload

    run = runload.load_diffusion_run(str(run_dir), device="cuda")
    weights = Path(run_dir) / "diffusion.npz"
    convert.save_npz(weights, convert.diffusion_to_jax_params(run.params))
    del run
    per_chunk = sampling_chunk(DIFFUSION_KWARGS["sampling_timesteps"])
    got = {}
    for source, argv in (("run_dir", ["--run-dir", str(run_dir)]),
                         ("weights", ["--weights", str(weights), "--arch",
                                      str(Path(run_dir) / "diffusion_architecture.json")])):
        with serving(serve, argv) as (port_no, health):
            got[source] = generate(port_no, MP_SERVE_REQUEST, counters, per_chunk)
    check(np.array_equal(got["run_dir"][0], got["weights"][0]),
          "bf16 stage 2: --run-dir and --weights gave different samples")
    return {"request": MP_SERVE_REQUEST, "same_bytes_as_weights": True,
            **{source: rec for source, (_, rec) in got.items()}}


def phase_mixed_precision(torch, np, counters, smi, stage1_dir):
    """Phase 27: bf16 mixed precision (GlowConfig.coupling_dtype and the
    UNets' dtype) on the card beside fp32: (a) Glow scoring, (b) stage-1
    training, (c) stage-2 training, evaluation and sampling, (d) serving.
    Returns the launches of the path."""
    none = {fn.__name__: 0 for fn in counters}
    t0 = time.perf_counter()
    for fn in counters:
        fn.launches = 0
    record = {"phase": "mixed_precision", "nvidia_smi": smi}
    record["glow_scoring"] = mp_glow(torch, np, counters, none)
    record["stage1_training"] = mp_stage1(torch, counters, none)
    torch.cuda.empty_cache()
    record["stage2"], run_dir = mp_stage2(torch, counters, none, stage1_dir)
    torch.cuda.empty_cache()
    record["serving"] = mp_serving(torch, np, counters, run_dir)
    launches = counts(counters)
    record["launches"] = launches
    record["seconds"] = time.perf_counter() - t0
    emit(record)
    return launches


# ---------------------------------------------------------------------------
# Phase 28: data parallelism
# ---------------------------------------------------------------------------

MG_STEPS = 8            # (a), (b): stage-1 steps of batch 64
MG_STAGE2_STEPS = 4     # (c): stage-2 steps of batch 64
MG_PART_BATCHES = 6     # (d): batches of the part-parallel comparison
MG_PART_T = 100         # (d): the entry point's diffusion T, cut from 1000 (its VLB
# batch; PERF.md §7)
MG_BUDGET_S = 120       # the phase's budget (PERF.md §2)
# (b), world 2 against world 1. Step 1: bits/dim within MG_BPD_TOL and the
# mean gradient (fsdp off) within GRAD_RTOL / GRAD_ATOL leaf by leaf, phase
# 14's bound for a sum-order difference; steps 1-MG_STEPS: bits/dim within
# TRAIN_TRAJ_TOL, the repository's trajectory gate; after MG_STEPS every
# parameter within MG_FINAL_ATOL, two Adam updates of lr 1e-3. The share of
# parameters within tests/test_parallel.py's bound (rtol MG_RTOL / atol
# MG_ATOL) is recorded after steps 1 and MG_STEPS: Adam's update
# lr g / (|g| + eps) turns the sum-order difference of a gradient near eps
# into a different update (3 of 5.5M values past that bound after step 1,
# 7175 after 8, at most 9.3e-4 apart), and configs/nf_base.yaml's first
# steps swing (bits/dim 4.3 -> 18.3 -> 3.9), where 1e-5 relative is 1.9e-4
# (my chip runs, PR 14, calls 3 and 4).
MG_BPD_TOL = 1e-5
MG_RTOL, MG_ATOL = 3e-4, 1e-5
MG_FINAL_ATOL = 2e-3
MG_LOSS_RTOL = 1e-4     # the stage-2 loss, relative: step 1 against world 1's (phases
                        # 28-31), each step over two row blocks (phase 28 (c))
MG_STATS_LIMIT = 256    # (e): images of the stats precompute
# the card; tools/rehearse_multi_gpu.py sets "cpu", gloo, device=cpu and
# --device cpu to rehearse the phase on the CPU
MG_DEVICE, MG_BACKEND, MG_ENTRY_ARGS, MG_TOOL_ARGS = "cuda", "nccl", [], []
# the command a child of phase 28 runs (its role and directory appended)
MG_CHILD = [sys.executable, str(ROOT / "chip_smoke.py"), "--multi-gpu-child"]
MG_STEP_LAUNCHES = {"channel_mix": 2 * LEVELS * STEPS - 1, "coupling_tail": LEVELS * STEPS,
                    "coupling_tail_bwd": LEVELS * STEPS, "coupling_tail_inverse": 0,
                    "fused_linear_attention": 0, "fused_linear_attention_bwd": 0,
                    "step_megakernel_forward": 0}


def kernel_counters():
    from nfdpm_tpu_torch.ops.kernels import channel_mix as cm
    from nfdpm_tpu_torch.ops.kernels import coupling_tail as ct
    from nfdpm_tpu_torch.ops.kernels import fused_linear_attention as fla
    from nfdpm_tpu_torch.ops.kernels import step_megakernel as sm

    return (cm.channel_mix, ct.coupling_tail, ct.coupling_tail_bwd, ct.coupling_tail_inverse,
            fla.fused_linear_attention, fla.fused_linear_attention_bwd,
            sm.step_megakernel_forward)


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def host_tree(tree) -> dict:
    """{path: numpy copy} of a tree's tensors."""
    from nfdpm_tpu_torch.convert import named_leaves

    return {k: v.detach().cpu().numpy().copy() for k, v in named_leaves(tree)}


def allreduce_ms(torch, mesh, numel: int, reps: int = 5) -> float:
    """Median wall ms of one all-reduce of a flat fp32 buffer of `numel` on
    the card over the mesh's group: the gradient mean of a step."""
    import torch.distributed as dist

    buf = torch.ones(numel, device=MG_DEVICE)
    times = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.all_reduce(buf, group=mesh.group)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return median_of(times[1:])


def mg_stage1_steps(torch, counters, mesh, fsdp: bool, batches) -> dict:
    """MG_STEPS stage-1 steps at configs/nf_base.yaml's width from one
    ddinit'ed state (ddinit on the whole first global batch), each rank its
    rows, the step's own draws: bits/dim of each step, each step's launches,
    synchronised wall ms, the final parameters (gathered whole under fsdp),
    the parameter and moment bytes the rank holds between steps beside the
    placements' prediction, and the process's peak of allocated device
    memory over the steps."""
    from nfdpm_tpu_torch.convert import named_leaves
    from nfdpm_tpu_torch.parallel import mesh as mesh_m
    from nfdpm_tpu_torch.parallel import sharding_rules as rules
    from nfdpm_tpu_torch.training import nf_trainer as nft
    from nfdpm_tpu_torch.utils.profiling import StepTimer

    cfg, tcfg = train_configs()
    tx = nft.optimizer_of(tcfg)
    state = nft.init_train_state(TRAIN_SEED, cfg, tcfg, tx, MG_DEVICE)
    state = nft.ddinit_train_state(state, cfg, tcfg, tx, batches[0],
                                   torch.Generator(device=MG_DEVICE).manual_seed(1))
    state = nft.shard_nf_state(mesh, tx, state, fsdp)
    step = nft.make_train_step(cfg, tcfg, tx, device=MG_DEVICE, mesh=mesh)
    timer = StepTimer(synchronize=MG_DEVICE)
    torch.cuda.reset_peak_memory_stats()
    bpds, launches, params_step1 = [], [], None
    for batch in batches[:MG_STEPS]:
        rows = batch if mesh is None else mesh_m.shard_batch(mesh, batch)
        before = counts(counters)
        with timer.step():
            state, metrics = step(state, rows, TRAIN_SEED)
        after = counts(counters)
        launches.append({k: after[k] - before[k] for k in before})
        bpds.append(float(metrics["bpd"]))
        if params_step1 is None:
            params_step1 = host_tree(nft.eval_params(state))
            if not fsdp:  # the mean gradient the update read (fsdp keeps only its slab)
                params_step1.update({f"grad/{k}": v for k, v in host_tree(
                    {k: p.grad for k, p in named_leaves(state["params"])
                     if p.grad is not None and tx.updates(k)}).items()})
    peak = torch.cuda.max_memory_allocated()
    placements = state["layout"].placements if "layout" in state else {}
    whole = nft.eval_params(state)
    rank = 0 if mesh is None else mesh.data_rank
    return {"bpd": bpds, "launches": launches, "step_wall_ms": [d * 1e3 for d in timer.durations],
            "params": host_tree(whole), "params_step1": params_step1,
            "param_bytes": rules.param_bytes(state["params"]),
            "predicted_param_bytes": rules.predicted_param_bytes(whole, placements, rank),
            "moment_bytes": rules.moment_bytes(state["opt_state"]),
            "predicted_moment_bytes": rules.predicted_moment_bytes(whole, placements, rank),
            "max_memory_allocated": peak,
            "sharded_leaves": len(placements),
            "grad_numel": sum(p.numel() for _, p in named_leaves(state["params"])
                              if p.requires_grad)}


def mg_block_step(torch, backbone, dp, tcfg, tx, blocks: int):
    """step(state, batch, seed) -> (state, {"loss"}): the arithmetic of a
    data-parallel stage-2 step over `blocks` data ranks, in one process
    without a process group: each row block's loss on its rows of the
    step's global draw and its backward, the gradients and the losses
    summed over the blocks and divided by their number (the all-reduce's
    mean), then the update of diffusion_trainer.make_train_step."""
    from nfdpm_tpu_torch import inference
    from nfdpm_tpu_torch.convert import map_tree, named_leaves
    from nfdpm_tpu_torch.ops.draws import RowGenerator
    from nfdpm_tpu_torch.training import diffusion_trainer as dt

    loss_fn = dt.make_loss_fn(backbone, dp, tcfg)
    generator = torch.Generator(device=MG_DEVICE)

    def step(state, batch, seed):
        params = state["params"]
        leaves = [p for _, p in named_leaves(params) if p.requires_grad]
        n = batch.shape[0] // blocks
        total = None
        for i in range(blocks):
            for p in leaves:
                p.grad = None
            draws = RowGenerator(inference.reseed(generator, dt._STEP, seed, state["step"]),
                                 i * n, (i + 1) * n, batch.shape[0])
            loss, _ = loss_fn(params, batch[i * n:(i + 1) * n], draws)
            loss.backward()
            got = [p.grad for p in leaves] + [loss.detach()]
            total = got if total is None else [a + b for a, b in zip(total, got)]
        for p, g in zip(leaves, total):
            p.grad = g / blocks
        grads = map_tree(params, lambda p: p.grad if p.grad is not None or not p.requires_grad
                         else torch.zeros_like(p))
        opt_state = tx.apply(params, grads, state["opt_state"])
        return ({"params": params, "opt_state": opt_state, "step": state["step"] + 1},
                {"loss": total[-1] / blocks})

    return step


def mg_stage2_steps(torch, counters, mesh, fsdp: bool, stage1_dir: Path, batches,
                    blocks: int = 1) -> dict:
    """MG_STAGE2_STEPS stage-2 steps (configs/nf_diffusion.yaml's three UNets
    over phase 12's frozen flow, batch 64, each rank its rows, the step's
    own draws): each step's loss and launches. `blocks` > 1 (no mesh): the
    steps of that many data ranks in this process (mg_block_step)."""
    from nfdpm_tpu_torch.models.nf_backbone import load_pretrained_flow
    from nfdpm_tpu_torch.parallel import mesh as mesh_m
    from nfdpm_tpu_torch.training import diffusion_trainer as dt

    backbone, flow = load_pretrained_flow(str(stage1_dir), 1, True, MG_DEVICE, True)
    dp = stage2_prior()
    tcfg = dt.DiffusionTrainConfig(lr_diffusion=1e-3)
    tx = dt.make_two_group_optimizer(tcfg, True)
    state = dt.init_train_state(TRAIN_SEED, backbone, flow, dp, tx, device=MG_DEVICE)
    state = dt.shard_diffusion_state(mesh, tx, state, fsdp)
    step = (dt.make_train_step(backbone, dp, tcfg, tx, device=MG_DEVICE, mesh=mesh)
            if blocks == 1 else mg_block_step(torch, backbone, dp, tcfg, tx, blocks))
    losses, launches = [], []
    for batch in batches[:MG_STAGE2_STEPS]:
        rows = batch if mesh is None else mesh_m.shard_batch(mesh, batch)
        before = counts(counters)
        state, metrics = step(state, rows, TRAIN_SEED)
        losses.append(float(metrics["loss"]))
        after = counts(counters)
        launches.append({k: after[k] - before[k] for k in before})
    return {"loss": losses, "launches": launches}


def mg_batches(torch, steps: int):
    return [torch.from_numpy(imgs).to(MG_DEVICE)
            for imgs, _ in train_loaders(steps).train.iter_epoch(0)]


def mg_part_parallel(torch, counters, stage1_dir: Path, root: Path, mesh) -> dict:
    """(d) The part-parallel plan on this one card (three groups run in
    turn) against the joint trainer on the same MG_PART_BATCHES batches and
    draws, bitwise; then run_diffusion_prior.main with
    parallel.part_parallel=true, whose merged view the parent serves."""
    from nfdpm_tpu_torch import run_diffusion_prior
    from nfdpm_tpu_torch.models.nf_backbone import load_pretrained_flow
    from nfdpm_tpu_torch.parallel import part_parallel as pp
    from nfdpm_tpu_torch.training import diffusion_trainer as dt

    backbone, flow = load_pretrained_flow(str(stage1_dir), 1, True, MG_DEVICE, True)
    dp = stage2_prior()
    tcfg = dt.DiffusionTrainConfig(lr_diffusion=1e-3, ema_decay=0.9, ema_update_every=1)
    tx = dt.make_two_group_optimizer(tcfg, True)
    joint = dt.init_train_state(TRAIN_SEED, backbone, flow, dp, tx, ema=True,
                                device=MG_DEVICE)
    jstep = dt.make_train_step(backbone, dp, tcfg, tx, device=MG_DEVICE)
    plan = pp.PartParallelPlan.build(TRAIN_SEED, backbone, flow, dp, tcfg, mesh)
    check([g.ranks for g in plan.groups] == [(0,)] * dp.num_parts,
          f"part groups on one card: {[g.ranks for g in plan.groups]}")
    losses_equal = True
    for batch in mg_batches(torch, MG_PART_BATCHES):
        joint, metrics = jstep(joint, batch, TRAIN_SEED)
        part = plan.step_all([batch] * dp.num_parts, TRAIN_SEED)
        losses_equal = losses_equal and torch.equal(metrics["part_losses"], torch.stack(part))
    check(losses_equal, "(d) the part-parallel losses are not the joint trainer's bitwise")
    params_equal = True
    for prefer_ema, tree in ((False, joint["params"]), (True, joint["ema"])):
        merged = plan.joint_params(prefer_ema)
        for a, b in zip(merged["diffusion"]["parts"], tree["diffusion"]["parts"]):
            params_equal = params_equal and all(
                torch.equal(pa, pb) for pa, pb in zip(a.parameters(), b.parameters()))
    check(params_equal, "(d) the part-parallel parameters are not the joint trainer's bitwise")
    del joint, plan
    torch.cuda.empty_cache()
    # the entry point, three groups in turn, MG_PART_BATCHES batches
    (root / "outputs").mkdir(exist_ok=True)
    link = root / "outputs" / "stage1"
    if not link.exists():
        link.symlink_to(stage1_dir)
    t0 = time.perf_counter()
    result = run_in(root, run_diffusion_prior.main, stage2_overrides("stage1", MG_PART_BATCHES)
                    + ["experiment_name=part_parallel", "parallel.part_parallel=true",
                       f"model.logging.log_gen_images_per_iter={10 ** 6}",
                       # the VLB's terms 25 timesteps a UNet call, the same terms,
                       # at T = MG_PART_T
                       "model.diffusion.vlb_time_chunk=25",
                       f"model.diffusion.timesteps={MG_PART_T}"] + MG_ENTRY_ARGS)
    run_dir = root / result["run_dir"]
    for name in ("model_diffusion_parts_001.pt", "model_diffusion_001.pt"):
        check((run_dir / "checkpoints" / name).exists(), f"(d) no checkpoints/{name}")
    return {"losses_bitwise_equal": True, "params_and_ema_bitwise_equal": True,
            "batches": MG_PART_BATCHES, "entry_point_s": time.perf_counter() - t0,
            "vlb_bpd": result["vlb_bpd"], "run_dir": str(run_dir)}


def w1_multi_gpu(torch, counters, root: Path, stage1_dir: Path) -> dict:
    """Phase 28's part of the world-1 child (deterministic mode; last in it,
    as it leaves a process group up): the references of (b) and (c) without
    a process group; (a) run_baseline.main without a launch, then as rank 0
    of a world of one over NCCL with fsdp off and on, bitwise; the step loop
    under that mesh, bitwise too; (d); its record."""
    import numpy as np
    import torch.distributed as dist

    from nfdpm_tpu_torch import run_baseline
    from nfdpm_tpu_torch.parallel import mesh as mesh_m
    from nfdpm_tpu_torch.training.checkpoint import restore_params

    out = {"phase": "multi_gpu_world1", "cublas_workspace_config":
           os.environ.get("CUBLAS_WORKSPACE_CONFIG")}
    batches = mg_batches(torch, MG_STEPS)
    seconds, start = {}, time.perf_counter()
    ref = mg_stage1_steps(torch, counters, None, False, batches)
    np.savez(root / "ref_stage1.npz", **ref.pop("params"))
    np.savez(root / "ref_stage1_step1.npz", **ref.pop("params_step1"))
    ref2 = mg_stage2_steps(torch, counters, None, False, stage1_dir, batches)
    blocks2 = mg_stage2_steps(torch, counters, None, False, stage1_dir, batches, blocks=2)
    out["reference"] = {"stage1": ref, "stage2": ref2, "stage2_blocks": blocks2}
    seconds["references"] = time.perf_counter() - start
    (root / "reference.json").write_text(json.dumps(out["reference"]))

    # (a) run_baseline.main: no launch, then a world of one over NCCL
    loaders = train_loaders(MG_STEPS)
    expected = stage1_run_launches(MG_STEPS, len(loaders.test) + len(loaders.eval))
    argv = ["data.name=synthetic", f"data.batch_size={BATCH}", f"data.img_size={IMG}",
            f"data.synthetic_n={BATCH * MG_STEPS}", f"seed={TRAIN_SEED}",
            f"model.architecture.L={LEVELS}", f"model.architecture.K={STEPS}",
            f"model.architecture.coupling_width={WIDTH}", "model.training.epochs=1",
            "model.training.print_freq=1", "model.training.save_checkpoint_freq=50"]
    runs = {}
    for name, extra in (("no_launch", []), ("nccl_fsdp_false", ["parallel.fsdp=false"]),
                        ("nccl_fsdp_true", ["parallel.fsdp=true"])):
        if name == "nccl_fsdp_false":  # rank 0 of a world of one, as torchrun starts it
            os.environ.update(RANK="0", LOCAL_RANK="0", WORLD_SIZE="1",
                              MASTER_ADDR="localhost", MASTER_PORT=os.environ["MG_PORT"])
        before = counts(counters)
        t0 = time.perf_counter()
        result = run_in(root, run_baseline.main,
                        argv + extra + [f"experiment_name={name}"] + MG_ENTRY_ARGS)
        torch.cuda.synchronize()
        launched = {k: v - before[k] for k, v in counts(counters).items()}
        check(launched == expected, f"(a) {name} launched {launched}, expected {expected}")
        params = restore_params(str(root / result["run_dir"]), "gaussian", 1, MG_DEVICE)
        runs[name] = {"params": params, "results": result["results"],
                      "seconds": time.perf_counter() - t0}
    check(dist.is_initialized() and dist.get_backend() == MG_BACKEND
          and dist.get_world_size() == 1, f"(a) no {MG_BACKEND} world of one")
    for name in ("nccl_fsdp_false", "nccl_fsdp_true"):
        gap, equal = state_gap(torch, {"params": runs[name]["params"], "step": 0},
                               {"params": runs["no_launch"]["params"], "step": 0},
                               keys=("params",))
        check(equal, f"(a) {name} is {gap} from the run without a launch, not bitwise")
        check(runs[name]["results"] == runs["no_launch"]["results"],
              f"(a) {name}'s final bits/dim differ")
    out["a"] = {name: {"final": r["results"], "seconds": r["seconds"]}
                for name, r in runs.items()}
    out["a"]["bitwise_equal"] = True
    seconds["a"] = time.perf_counter() - start - sum(seconds.values())
    del runs

    # the step loop under the world-of-one mesh: the reference's bits
    mesh = mesh_m.make_mesh(device=MG_DEVICE)
    nccl = mg_stage1_steps(torch, counters, mesh, True, batches)
    nccl.pop("params_step1")
    saved = np.load(root / "ref_stage1.npz")
    check(nccl["bpd"] == ref["bpd"] and all(np.array_equal(saved[k], v)
                                            for k, v in nccl["params"].items()),
          "(a) the NCCL world of one's step loop is not the reference bitwise")
    out["a"]["step_loop_bitwise_equal"] = True
    out["f_world1"] = {"step_wall_ms": nccl["step_wall_ms"],
                       "step_wall_ms_median": median_of(nccl["step_wall_ms"][1:]),
                       "reference_step_wall_ms_median": median_of(ref["step_wall_ms"][1:]),
                       "allreduce_ms": allreduce_ms(torch, mesh, nccl["grad_numel"]),
                       "grad_numel": nccl["grad_numel"]}
    del nccl
    torch.cuda.empty_cache()
    seconds["step_loop"] = time.perf_counter() - start - sum(seconds.values())
    out["d"] = mg_part_parallel(torch, counters, stage1_dir, root, mesh)
    seconds["d"] = time.perf_counter() - start - sum(seconds.values())
    out["seconds"] = seconds
    return out


def r2_multi_gpu(torch, counters, root: Path, stage1_dir: Path) -> dict:
    """Phase 28's part of a rank of the two-rank child (a data axis of two):
    (b) the stage-1 steps with fsdp off and on, (c) the stage-2 steps;
    writes its parameters; its record (the parent compares)."""
    import numpy as np
    import torch.distributed as dist

    from nfdpm_tpu_torch.parallel import mesh as mesh_m

    mesh = mesh_m.make_mesh(device=MG_DEVICE)
    out = {"phase": "multi_gpu_world2", "rank": mesh.rank, "world": mesh.world,
           "backend": dist.get_backend()}
    batches = mg_batches(torch, MG_STEPS)
    t0 = time.perf_counter()
    for fsdp in (False, True):
        res = mg_stage1_steps(torch, counters, mesh, fsdp, batches)
        np.savez(root / f"world2_fsdp{int(fsdp)}_rank{mesh.rank}.npz", **res.pop("params"))
        np.savez(root / f"world2_fsdp{int(fsdp)}_rank{mesh.rank}_step1.npz",
                 **res.pop("params_step1"))
        out[f"b_fsdp_{str(fsdp).lower()}"] = res
    out["allreduce_ms"] = allreduce_ms(torch, mesh, res["grad_numel"])
    t1 = time.perf_counter()
    out["c"] = mg_stage2_steps(torch, counters, mesh, False, stage1_dir, batches)
    out["seconds"] = {"b": t1 - t0, "c": time.perf_counter() - t1}
    return out


def mg_children(cmd_role: str, root: Path, stage1_dir: Path, env: dict, ranks: int,
                phases, timeout: float = 600):
    """Start `ranks` children of `cmd_role` together, wait for all (killing
    every one if one fails or the time runs out); each child's records of
    `phases`, {phase: record}, one of each."""
    procs, popen_at = [], time.time()
    for rank in range(ranks):
        rank_env = dict(env, RANK=str(rank)) if ranks > 1 else env
        if env.get("NFDPM_DIST_BACKEND") == "nccl":  # one card a rank
            rank_env["LOCAL_RANK"] = str(rank)
        procs.append(subprocess.Popen(MG_CHILD + [cmd_role, str(root), str(stage1_dir)],
                                      env=rank_env, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    outs, deadline = [], time.monotonic() + timeout
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic())))
    except subprocess.TimeoutExpired:
        outs.append(("", "timed out"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (stdout, stderr) in zip(procs, outs + [("", "")] * (len(procs) - len(outs))):
        check(p.returncode == 0, f"the {cmd_role} child failed ({p.returncode}):\n"
                                 f"{stdout[-2000:]}\n{stderr[-4000:]}")
    records, ready = [], []
    for stdout, _ in outs:
        lines = [json.loads(line) for line in stdout.splitlines() if line.startswith("{")]
        mine = {}
        for rec in lines:
            if rec.get("phase") in phases:
                check(rec["phase"] not in mine, f"a {cmd_role} child printed two "
                                                f"{rec['phase']} records")
                mine[rec["phase"]] = rec
            elif rec.get("phase") == "child_ready":
                ready.append(rec["unix_time"])
        check(set(mine) == set(phases), f"a {cmd_role} child printed {sorted(mine)}, "
                                        f"not {sorted(phases)}")
        records.append(mine)
    # the launch's cost: Popen to each child's first record (Python, torch
    # and the port imported), and each child's own work after it
    emit({"phase": "launch", "role": cmd_role, "ranks": ranks, "phases": sorted(phases),
          "wall_s": time.time() - popen_at, "start_s_by_rank": [t - popen_at for t in ready],
          "work_s_by_rank": [max(r["elapsed_s"] for r in mine.values()) for mine in records]})
    return records


def phase_multi_gpu(torch, np, counters, smi, stage1_dir: Path, children: dict) -> dict:
    """Phase 28 (see the module docstring): the gates on its part of the
    children's records (launch_children), then (e) in this process; returns
    the launches of its path: this process's (e) and its children's part,
    summed."""
    from nfdpm_tpu_torch import serve
    from nfdpm_tpu_torch.metrics import precompute_stats

    root = multi_dir(28)
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    w1 = children["world1"]["multi_gpu_world1"]
    w2 = [r["multi_gpu_world2"] for r in children["ranks2"]]
    ref = w1["reference"]
    record = {"phase": "multi_gpu", "card": smi, "a": w1["a"], "d": w1["d"]}

    # (b): each rank against world 1, the ranks against each other
    refp = np.load(root / "ref_stage1.npz")
    ref1 = np.load(root / "ref_stage1_step1.npz")

    def param_gaps(got, want, prefix=""):
        """(largest gap, values past the data-parallel bound, their count) of
        two parameter (or, with prefix "grad/", gradient) sets."""
        gap, beyond, total = 0.0, 0, 0
        for k in want.files:
            if not k.startswith(prefix) or (not prefix and k.startswith("grad/")):
                continue
            if not want[k].size:
                continue
            diff = np.abs(got[k] - want[k])
            gap = max(gap, float(diff.max()))
            beyond += int((diff > MG_ATOL + MG_RTOL * np.abs(want[k])).sum())
            total += want[k].size
        return gap, beyond, total

    def grads_close(got, want) -> bool:
        """Each gradient leaf within GRAD_RTOL of its largest entry plus
        GRAD_ATOL, as phase 14 holds two routes' gradients."""
        return all(float(np.abs(got[k] - want[k]).max())
                   <= GRAD_RTOL * float(np.abs(want[k]).max()) + GRAD_ATOL
                   for k in want.files if k.startswith("grad/") and want[k].size)

    b = {}
    for fsdp in ("false", "true"):
        ranks = [r[f"b_fsdp_{fsdp}"] for r in w2]
        tag = f"world2_fsdp{int(fsdp == 'true')}"
        params = [np.load(root / f"{tag}_rank{r}.npz") for r in range(2)]
        step1 = np.load(root / f"{tag}_rank0_step1.npz")
        bpd_gaps = [max(abs(r["bpd"][i] - ref["stage1"]["bpd"][i]) for r in ranks)
                    for i in range(len(ranks[0]["bpd"]))]
        gap1, beyond1, total = param_gaps(step1, ref1)
        gap, beyond, _ = param_gaps(params[0], refp)
        m = {
            "bpd_rank0": ranks[0]["bpd"], "bpd_world1": ref["stage1"]["bpd"],
            "bpd_gap_by_step": bpd_gaps, "max_bpd_gap": max(bpd_gaps),
            "step1_max_param_gap": gap1, "step1_param_values_beyond_dp_bound": beyond1,
            "max_param_gap": gap, "param_values_beyond_dp_bound": beyond,
            "param_values": total,
            "ranks_bitwise_equal": all(np.array_equal(params[0][k], params[1][k])
                                       for k in refp.files),
            "param_bytes_by_rank": [r["param_bytes"] for r in ranks],
            "predicted_param_bytes_by_rank": [r["predicted_param_bytes"] for r in ranks],
            "world1_param_bytes": ref["stage1"]["param_bytes"],
            "moment_bytes_by_rank": [r["moment_bytes"] for r in ranks],
            "predicted_moment_bytes_by_rank": [r["predicted_moment_bytes"] for r in ranks],
            "world1_moment_bytes": ref["stage1"]["moment_bytes"],
            "max_memory_allocated_by_rank": [r["max_memory_allocated"] for r in ranks],
            "world1_max_memory_allocated": ref["stage1"]["max_memory_allocated"],
            "partitioned_leaves": ranks[0]["sharded_leaves"],
            "launches_by_step": [r["launches"] for r in ranks],
            "step_wall_ms_median_by_rank": [median_of(r["step_wall_ms"][1:]) for r in ranks]}
        if fsdp == "false":
            m["step1_max_grad_gap"], m["step1_grad_values_beyond_dp_bound"], _ = param_gaps(
                step1, ref1, "grad/")
            m["step1_grads_within_route_bound"] = grads_close(step1, ref1)
        b[f"fsdp_{fsdp}"] = m
    record["b"] = b
    emit({"phase": "multi_gpu_b", **b})
    for fsdp, m in b.items():
        check(m["ranks_bitwise_equal"], f"(b) {fsdp}: the ranks' parameters differ")
        check(m["bpd_gap_by_step"][0] <= MG_BPD_TOL,
              f"(b) {fsdp}: step 1's bits/dim {m['bpd_gap_by_step'][0]} from world 1's")
        check(m.get("step1_grads_within_route_bound", True),
              f"(b) {fsdp}: step 1's mean gradient {m.get('step1_max_grad_gap')} from "
              f"world 1's, past rtol {GRAD_RTOL} of a leaf's largest entry")
        check(m["max_bpd_gap"] <= TRAIN_TRAJ_TOL,
              f"(b) {fsdp}: bits/dim {m['bpd_gap_by_step']} from world 1's by step")
        check(m["max_param_gap"] <= MG_FINAL_ATOL,
              f"(b) {fsdp}: parameters {m['max_param_gap']} from world 1's after {MG_STEPS}")
        check(all(step == MG_STEP_LAUNCHES for r in m["launches_by_step"] for step in r),
              f"(b) {fsdp}: the ranks' step launches {m['launches_by_step']}")
        check(m["moment_bytes_by_rank"] == m["predicted_moment_bytes_by_rank"]
              and m["param_bytes_by_rank"] == m["predicted_param_bytes_by_rank"],
              f"(b) {fsdp}: parameters {m['param_bytes_by_rank']} B and moments "
              f"{m['moment_bytes_by_rank']} B, _add_fsdp predicts "
              f"{m['predicted_param_bytes_by_rank']} B and "
              f"{m['predicted_moment_bytes_by_rank']} B")
        check((m["partitioned_leaves"] > 0) == (fsdp == "fsdp_true"),
              f"(b) {fsdp}: {m['partitioned_leaves']} partitioned leaves")

    # (c): the stage-2 loss of each step, each rank, and the attention launches
    per_step2 = stage2_per_step(True)

    def rel_gaps(want):
        return [max(abs(r["c"]["loss"][i] - c) / abs(c) for r in w2) for i, c in enumerate(want)]

    loss_gaps, block_gaps = rel_gaps(ref["stage2"]["loss"]), rel_gaps(
        ref["stage2_blocks"]["loss"])
    record["c"] = {"loss_rank0": w2[0]["c"]["loss"], "loss_world1": ref["stage2"]["loss"],
                   "loss_world1_blocks": ref["stage2_blocks"]["loss"],
                   "rel_gap_by_step": loss_gaps, "max_rel_gap": max(loss_gaps),
                   "blocks_rel_gap_by_step": block_gaps,
                   "blocks_bitwise": all(r["c"]["loss"] == ref["stage2_blocks"]["loss"]
                                         for r in w2),
                   "launches_per_step": per_step2}
    emit({"phase": "multi_gpu_c", **record["c"]})
    check(loss_gaps[0] <= MG_LOSS_RTOL,
          f"(c) step 1's stage-2 loss {loss_gaps[0]} (relative) from world 1's")
    check(max(block_gaps) <= MG_LOSS_RTOL,
          f"(c) the stage-2 loss {block_gaps} (relative, by step) from world 1's steps "
          "over two row blocks")
    for r in w2:
        check(all(l == per_step2 for l in r["c"]["launches"]),
              f"(c) a rank's stage-2 step launches {r['c']['launches']}, expected {per_step2}")

    # (e) and the part-parallel run's merged view, in this process
    e_t0 = time.perf_counter()
    for fn in counters:
        fn.launches = 0
    got = {}
    for flag in ([], ["--data-parallel"]):
        with serving(serve, ["--run-dir", str(stage1_dir)] + flag + MG_TOOL_ARGS) as (
                port_no, health):
            samples, rec = generate(port_no, RUN_DIR_REQUEST, counters, sampling_chunk())
            got[bool(flag)] = (samples, health, rec)
    check(np.array_equal(got[False][0], got[True][0]),
          "(e) serve --data-parallel gave other bytes than without the flag")
    check(got[True][1]["devices"] == 1 == got[False][1]["devices"],
          f"(e) /health devices {got[True][1]['devices']}")
    stats = {}
    for flag in ([], ["--data-parallel"]):
        out_dir = root / f"stats{'_dp' if flag else ''}"
        precompute_stats.main(["--action", "precompute", "--datasets", "synthetic", "--models",
                               "inception_v3", "--modes", "legacy_tensorflow", "--limit",
                               str(MG_STATS_LIMIT), "--stats_dir", str(out_dir)]
                              + flag + MG_TOOL_ARGS)
        (f,) = out_dir.iterdir()
        with np.load(f) as data:
            stats[bool(flag)] = {k: data[k] for k in ("mu", "sigma", "feats")}
    check(all(np.array_equal(stats[False][k], stats[True][k]) for k in stats[False]),
          "(e) precompute_stats --data-parallel gave other statistics")
    pp_run = Path(w1["d"]["run_dir"])
    with serving(serve, ["--run-dir", str(pp_run)] + MG_TOOL_ARGS) as (port_no, health):
        check(health["kind"] == "diffusion" and health["epoch"] == 1,
              f"(d) serve --run-dir on the part-parallel run: {health}")
        pp_samples, pp_rec = generate(
            port_no, {"n": BATCH, "seed": 3}, counters,
            sampling_chunk(DIFFUSION_KWARGS["sampling_timesteps"]))
    record["e"] = {"serve_bytes_equal": True, "devices": got[True][1]["devices"],
                   "serve_wall_s": {"single": got[False][2]["wall_s"],
                                    "data_parallel": got[True][2]["wall_s"]},
                   "precompute_stats_equal": True, "seconds": time.perf_counter() - e_t0}
    record["d"]["served_merged_view"] = {"kind": health["kind"], "request": pp_rec["request"],
                                         "wall_s": pp_rec["wall_s"]}
    here = counts(counters)

    # (f) timing
    record["f"] = {"card": smi,
                   "step_wall_ms_world1_nccl": w1["f_world1"]["step_wall_ms_median"],
                   "step_wall_ms_world1_no_group": w1["f_world1"][
                       "reference_step_wall_ms_median"],
                   "step_wall_ms_world2_gloo": b["fsdp_false"]["step_wall_ms_median_by_rank"],
                   "step_wall_ms_world2_gloo_fsdp": b["fsdp_true"]["step_wall_ms_median_by_rank"],
                   "allreduce_ms_world1_nccl": w1["f_world1"]["allreduce_ms"],
                   "allreduce_ms_world2_gloo": [r["allreduce_ms"] for r in w2],
                   "allreduce_numel": w1["f_world1"]["grad_numel"],
                   "note": "gloo on one card moves the gradients through the host"}
    seconds = time.perf_counter() - t0
    record.update({"seconds": seconds, "children_work_s": {
        "world1": w1["seconds"], "world2_ranks": [r["seconds"] for r in w2]},
        "budget_s": MG_BUDGET_S, "within_budget": seconds <= MG_BUDGET_S})
    launches = {k: here[k] + w1["launches"][k] + sum(r["launches"][k] for r in w2)
                for k in here}
    record["launches"] = {"this_process": here, "world1_child": w1["launches"],
                          "world2_ranks": [r["launches"] for r in w2], "total": launches}
    emit(record)
    return launches

# -- phase 29: the model axis --------------------------------------------------

MT_STEPS = 4            # (a): stage-1 steps of batch 64 through run_baseline.main
MT_MESH4_STEPS = 2      # (b): the same at (data 2, model 2)
MT_BUDGET_S = 120       # the phase's budget (PERF.md §2)
MT_DDIM_N = 16          # (c): images of the DDIM chunk
MT_DDIM_STEPS = 10      # (c): its steps, DDIM-100 cut to fit the budget (PERF.md §7):
# a model-2
# chain step waits on about 90 collectives through the host (26.5 s for
# DDIM-100 at model 2 against 4.3 s at world 1 on an NVIDIA H100 80GB HBM3,
# 700 W; PERF.md §6)
# (c): the DDIM chunk's latents against world 1's. The sum-order difference
# of the row-parallel convolutions goes through the chain as the kernel
# route's does against the plain route, so the gate is LATENT_TOL; the count
# past the sampler's CPU bound (tests/test_torch_diffusion.py CHAIN_TOL, atol
# 1e-4 / rtol 1e-5) is recorded beside it: the x0 prediction divides the
# noise estimate's rounding by sqrt(alpha_bar), and the CPU rehearsal at
# T = 8 already puts latents 4.4e-4 apart.
MT_CHAIN_ATOL, MT_CHAIN_RTOL = 1e-4, 1e-5


COLLECTIVE_KINDS = ("all_reduce", "all_gather", "hop", "flush", "halo", "halo_back",
                    "grad_sum", "row_gather")


class ModelAxisSpy:
    """Instruments a child of phases 29, 30 and 31: each train step's
    launches and synchronised wall ms (nf_trainer's and diffusion_trainer's
    make_train_step wrapped), the model group's all-reduce and all-gather
    bytes and calls a step (parallel/tensor_parallel.py's two collectives
    counted), the pipeline's hop bytes sent and flush bytes broadcast
    (parallel/pipeline.py's _p2p and _bcast), spatial partitioning's halo
    bytes sent forward and back, the gradients' sum over the model group
    and the latents' row gather (parallel/spatial.py's halo,
    halo_backward, all_reduce_sum_ and _gather) and, on a step marked `timed`, their
    synchronised wall ms (all, and by kind); the state and the mesh
    nf_trainer.train ran with."""

    def __init__(self, torch, counters):
        from nfdpm_tpu_torch.parallel import pipeline as pl
        from nfdpm_tpu_torch.parallel import spatial as sp
        from nfdpm_tpu_torch.parallel import tensor_parallel as tp
        from nfdpm_tpu_torch.training import diffusion_trainer as dt
        from nfdpm_tpu_torch.training import nf_trainer as nft

        self.torch, self.counters = torch, counters
        self.steps, self.collective = [], None
        self.timed_step, self.trained = None, {}
        self.originals = [(tp, "_all_reduce", tp._all_reduce),
                          (tp, "all_gather_dim", tp.all_gather_dim),
                          (pl, "_p2p", pl._p2p), (pl, "_bcast", pl._bcast),
                          (sp, "halo", sp.halo), (sp, "halo_backward", sp.halo_backward),
                          (sp, "all_reduce_sum_", sp.all_reduce_sum_),
                          (sp, "_gather", sp._gather),
                          (nft, "make_train_step", nft.make_train_step),
                          (dt, "make_train_step", dt.make_train_step),
                          (nft, "train", nft.train)]
        reduce, gather, p2p, bcast = tp._all_reduce, tp.all_gather_dim, pl._p2p, pl._bcast
        halo, halo_back = sp.halo, sp.halo_backward
        grad_sum, row_gather = sp.all_reduce_sum_, sp._gather

        def nbytes(t):
            return t.numel() * t.element_size()

        tp._all_reduce = lambda axis, t: self._collective("all_reduce", nbytes(t), reduce,
                                                          axis, t)
        tp.all_gather_dim = lambda axis, t, dim, timeout_s=None: self._collective(
            "all_gather", nbytes(t), gather, axis, t, dim, timeout_s)
        pl._p2p = lambda axis, sends, recvs: self._collective(
            "hop", sum(nbytes(t) for t, _ in sends), p2p, axis, sends, recvs)
        pl._bcast = lambda axis, buf, stage: self._collective("flush", nbytes(buf), bcast,
                                                              axis, buf, stage)
        def halo_bytes(t, axis, p):  # p rows to each neighbour
            b, _, w, c = t.shape
            neighbours = (axis.index > 0) + (axis.index < axis.n - 1)
            return neighbours * b * p * w * c * t.element_size()

        sp.halo = lambda x, axis, p: self._collective("halo", halo_bytes(x, axis, p), halo,
                                                      x, axis, p)
        sp.halo_backward = lambda g, axis, p: self._collective(
            "halo_back", halo_bytes(g, axis, p), halo_back, g, axis, p)
        sp.all_reduce_sum_ = lambda axis, ts: grad_sum(axis, ts) if axis is None else (
            self._collective("grad_sum", sum(nbytes(t) for t in ts), grad_sum, axis, ts))
        sp._gather = lambda axis, t: self._collective("row_gather", nbytes(t), row_gather,
                                                      axis, t)
        for module in (nft, dt):
            module.make_train_step = self._wrap_maker(module.make_train_step)
        train = nft.train

        def spy_train(**kwargs):
            out = train(**kwargs)
            self.trained = {"state": out["state"], "mesh": kwargs.get("mesh")}
            return out

        nft.train = spy_train

    def restore(self):
        for module, name, fn in self.originals:
            setattr(module, name, fn)

    def _collective(self, kind, nbytes, fn, *args):
        c = self.collective
        if c is None:
            return fn(*args)
        timed = len(self.steps) == self.timed_step
        if timed:
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
        out = fn(*args)
        if timed:
            self.torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            c["ms"] += ms
            c[f"{kind}_ms"] = c.get(f"{kind}_ms", 0.0) + ms
        c[f"{kind}_bytes"] += nbytes
        c[f"{kind}_calls"] += 1
        return out

    def _wrap_maker(self, make):
        def maker(*args, **kwargs):
            step = make(*args, **kwargs)

            def spied(state, batch, seed):
                torch = self.torch
                torch.cuda.synchronize()
                before = counts(self.counters)
                self.collective = {f"{kind}_{what}": 0 for kind in COLLECTIVE_KINDS
                                   for what in ("bytes", "calls")}
                self.collective["ms"] = 0.0
                t0 = time.perf_counter()
                out = step(state, batch, seed)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
                after = counts(self.counters)
                rec = {"wall_ms": wall, "launches": {k: after[k] - before[k] for k in before},
                       **self.collective}
                if len(self.steps) != self.timed_step:
                    rec = {k: v for k, v in rec.items() if not k.endswith("ms") or k == "wall_ms"}
                self.steps.append(rec)
                self.collective = None
                return out

            return spied

        return maker


def mt_argv(steps: int):
    """run_baseline.main's overrides: configs/nf_base.yaml at full width, one
    epoch of `steps` steps of batch 64, each step's bits/dim logged."""
    return ["data.name=synthetic", f"data.batch_size={BATCH}", f"data.img_size={IMG}",
            f"data.synthetic_n={BATCH * steps}", f"seed={TRAIN_SEED}",
            f"model.architecture.L={LEVELS}", f"model.architecture.K={STEPS}",
            f"model.architecture.coupling_width={WIDTH}", "model.training.epochs=1",
            "model.training.print_freq=1", "model.training.save_checkpoint_freq=50",
            ] + MG_ENTRY_ARGS


def mt_step_bpds(run_dir: Path) -> list:
    """Each train step's bits/dim, from the run's metrics.jsonl."""
    rows = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    train = [r for r in rows if r["name"] == "bpd" and r["step"] is not None
             and (r.get("context") or {}).get("subset") == "train"]
    return [r["value"] for r in sorted(train, key=lambda r: r["step"])]


def mt_stage1(torch, spy, root: Path, name: str, steps: int, extra=()) -> dict:
    """run_baseline.main at full width for `steps` steps (with `extra`
    overrides), instrumented: each step's bits/dim (rank 0's log), launches,
    wall ms and collectives, the final bits/dim, the run's launches, the
    rank's parameter and moment bytes beside the placements' prediction (its
    model slabs cut by the data placements of fsdp, or the whole flow by the
    pipeline's stages), the process's peak of allocated device memory."""
    from nfdpm_tpu_torch import run_baseline
    from nfdpm_tpu_torch.parallel import mesh as mesh_m
    from nfdpm_tpu_torch.parallel import sharding_rules as rules
    from nfdpm_tpu_torch.parallel import tensor_parallel as tp
    from nfdpm_tpu_torch.training.checkpoint import restore_params

    spy.steps, spy.timed_step = [], steps - 1
    before = counts(spy.counters)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result = run_in(root, run_baseline.main, mt_argv(steps) + list(extra)
                    + [f"experiment_name={name}"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launched = {k: v - before[k] for k, v in counts(spy.counters).items()}
    run_dir = root / result["run_dir"]
    state, mesh = spy.trained["state"], spy.trained["mesh"]
    mesh_m.barrier(mesh)  # rank 0's checkpoint is on disk
    whole = restore_params(str(run_dir), "gaussian", 1, "cpu")
    model_pl = rules.model_placements(mesh, whole)  # none of the flow's under spatial
    layout = state.get("layout")
    if layout is not None and layout.axis == "model":  # the pipeline's stages
        before, placements, index = whole, layout.placements, mesh.model_rank
    else:  # the model slabs, cut by fsdp's data placements
        before = tp.shard_tree(mesh_m.model_of(mesh), whole, model_pl)
        placements = {} if layout is None else layout.placements
        index = 0 if mesh is None else mesh.data_rank
    out = {"run_dir": result["run_dir"], "results": result["results"], "seconds": seconds,
           "steps": spy.steps, "launches": launched,
           "flow_param_bytes": rules.param_bytes({"flow": state["params"]["flow"]}),
           "predicted_flow_param_bytes": rules.predicted_param_bytes(
               {"flow": before["flow"]}, placements, index),
           "moment_bytes": rules.moment_bytes(state["opt_state"]),
           "predicted_moment_bytes": rules.predicted_moment_bytes(before, placements, index),
           "max_memory_allocated": peak, "layout": None if layout is None else layout.axis,
           "zero_leaves": len(placements) if layout is not None and layout.axis == "data"
           else 0, "model_leaves": len(model_pl)}
    if mesh is None or mesh.rank == 0:
        out["bpd_by_step"] = mt_step_bpds(run_dir)
    if mesh is not None:
        out["coords"] = [mesh.data_rank, mesh.model_rank, mesh.n_data, mesh.n_model]
    del state, whole
    spy.trained = {}
    torch.cuda.empty_cache()
    return out


def mt_stage2(torch, spy, mesh, stage1_dir: Path, root: Path, states: Path = None) -> dict:
    """MG_STAGE2_STEPS stage-2 steps over phase 12's frozen flow (three
    UNets, batch 64, the step's own draws) on `mesh` (None: one rank), then
    one DDIM chunk (MT_DDIM_STEPS steps) of MT_DDIM_N images on the seeded
    UNets, its latents written to <root>/ddim_<tag>.npz. `states`: the
    whole state before each step but the first is written there as the
    checkpoint of that step's number, which mt_same_state reads."""
    import numpy as np

    from nfdpm_tpu_torch import convert, inference
    from nfdpm_tpu_torch.models.nf_backbone import load_pretrained_flow
    from nfdpm_tpu_torch.parallel import mesh as mesh_m
    from nfdpm_tpu_torch.training import checkpoint as ckpt
    from nfdpm_tpu_torch.training import diffusion_trainer as dt

    backbone, flow = load_pretrained_flow(str(stage1_dir), 1, True, MG_DEVICE, True)
    dp = stage2_prior()
    tcfg = dt.DiffusionTrainConfig(lr_diffusion=1e-3)
    tx = dt.make_two_group_optimizer(tcfg, True)
    state = dt.init_train_state(TRAIN_SEED, backbone, flow, dp, tx, device=MG_DEVICE)
    state = dt.shard_diffusion_state(mesh, tx, state, False)
    spy.steps, spy.timed_step = [], MG_STAGE2_STEPS - 1
    step = dt.make_train_step(backbone, dp, tcfg, tx, device=MG_DEVICE, mesh=mesh)
    losses = []
    for i, batch in enumerate(mg_batches(torch, MG_STAGE2_STEPS)):
        if states is not None and i > 0:  # a collective; rank 0 writes
            ckpt.save_state(str(states), "diffusion", i + 1, dt.whole_diffusion_state(mesh, state),
                            mesh)
        rows = batch if mesh is None else mesh_m.shard_batch(mesh, batch)
        state, metrics = step(state, rows, TRAIN_SEED)
        losses.append(float(metrics["loss"]))
    out = {"loss": losses, "steps": spy.steps}
    del state
    torch.cuda.empty_cache()
    params = convert.params_for_rank({"flow": flow, "diffusion": dp.init_params(5, MG_DEVICE)},
                                     mesh)
    chain = stage2_prior(sampling_timesteps=min(MT_DDIM_STEPS,
                                                DIFFUSION_KWARGS["sampling_timesteps"]))
    sample = inference.make_diffusion_sample_fn(dt.on_mesh(mesh, backbone), chain, N_BITS,
                                                MG_DEVICE)
    t0 = time.perf_counter()
    _, latents = sample(params, MT_DDIM_N, generator=inference.reseed(
        torch.Generator(device=MG_DEVICE), 9, 1), return_latents=True)
    torch.cuda.synchronize()
    out["ddim_s"] = time.perf_counter() - t0
    tag = "world1" if mesh is None else f"rank{mesh.rank}"
    np.savez(root / f"ddim_{tag}.npz", **{f"z{i}": z.cpu().numpy() for i, z in enumerate(latents)})
    return out


def mt_same_state(torch, counters, root: Path, stage1_dir: Path) -> dict:
    """(c)'s same-state reference, in a world of one: from each state the
    model-2 run wrote before its steps 2-MG_STAGE2_STEPS (<root>/c_states,
    whole), one step with that step's batch and draws (the seed and the
    state's step number): the losses and each step's launches."""
    from nfdpm_tpu_torch.models.nf_backbone import load_pretrained_flow
    from nfdpm_tpu_torch.training import diffusion_trainer as dt

    backbone, _ = load_pretrained_flow(str(stage1_dir), 1, True, MG_DEVICE, True)
    dp = stage2_prior()
    tcfg = dt.DiffusionTrainConfig(lr_diffusion=1e-3)
    tx = dt.make_two_group_optimizer(tcfg, True)
    step = dt.make_train_step(backbone, dp, tcfg, tx, device=MG_DEVICE)
    batches = mg_batches(torch, MG_STAGE2_STEPS)
    losses, launches = [], []
    for i in range(1, MG_STAGE2_STEPS):
        state = dt.restore_train_state(str(root / "c_states"), i + 1, backbone, dp, False,
                                       MG_DEVICE)
        check(state["step"] == i, f"(c) the state before step {i + 1} is at step {state['step']}")
        before = counts(counters)
        state, metrics = step(state, batches[i], TRAIN_SEED)
        losses.append(float(metrics["loss"]))
        launches.append({k: v - before[k] for k, v in counts(counters).items()})
        del state
    torch.cuda.empty_cache()
    return {"steps": list(range(2, MG_STAGE2_STEPS + 1)), "loss": losses, "launches": launches}


def w1_model_axis(torch, counters, root: Path, stage1_dir: Path, parts) -> dict:
    """The model axis's part of the world-1 child (no process group): the
    stage-1 run that phases 29 (a), 30 and 31 (a) compare with; with "29"
    in `parts` the references of 29 (b) and (c) and (c)'s same-state steps
    (after the two-rank child wrote its states); with "31" phase 31 (b)'s
    stage-2 runs (`sp_b`, their launches apart). Its record."""
    spy = ModelAxisSpy(torch, counters)
    d29 = multi_dir(29, root)
    t0 = time.perf_counter()
    try:
        out = {"phase": "model_axis_world1",
               "a": mt_stage1(torch, spy, d29, "world1_a", MT_STEPS)}
        if "29" in parts:
            out["b"] = mt_stage1(torch, spy, d29, "world1_b", MT_MESH4_STEPS)
            out["c"] = mt_stage2(torch, spy, None, stage1_dir, d29)
            out["c_same_state"] = mt_same_state(torch, counters, d29, stage1_dir)
        out["seconds"] = time.perf_counter() - t0
        out["launches"] = counts(counters)
        if "31" in parts:  # phase 31's world-1 stage-2 runs
            for fn in counters:
                fn.launches = 0
            out["sp_b"] = sp_stage2(torch, spy, d29)
            out["sp_b_launches"] = counts(counters)
    finally:
        spy.restore()
    return out


def r2_model_axis(torch, spy, root: Path, stage1_dir: Path, parts) -> dict:
    """Phase 29's part of a rank of the two-rank child: (a)
    run_baseline.main with parallel.n_model=2 and, with "29" in `parts`,
    (c) the stage-2 steps at (1, 2), the state before each step after the
    first written for the same-state reference, and the DDIM chunk."""
    import torch.distributed as dist

    from nfdpm_tpu_torch.parallel import mesh as mesh_m

    d29 = multi_dir(29, root)
    t0 = time.perf_counter()
    out = {"phase": "model_axis_model2", "rank": dist.get_rank(),
           "backend": dist.get_backend(),
           "a": mt_stage1(torch, spy, d29, "model2_a", MT_STEPS, ["parallel.n_model=2"])}
    if "29" in parts:
        mesh = mesh_m.make_mesh(n_model=2, device=MG_DEVICE)
        out["c"] = mt_stage2(torch, spy, mesh, stage1_dir, d29, states=d29 / "c_states")
    out["seconds"] = time.perf_counter() - t0
    return out


def mt_mesh4(torch, root: Path, stage1_dir: Path) -> None:
    """A rank of phase 29's (data 2, model 2) children: (b)
    run_baseline.main with parallel.n_model=2 and parallel.fsdp=true, then
    the coordinates of the mesh over 2 slices."""
    import torch.distributed as dist

    from nfdpm_tpu_torch.parallel import distributed
    from nfdpm_tpu_torch.parallel import mesh as mesh_m

    counters = kernel_counters()
    set_deterministic(torch, True)
    spy = ModelAxisSpy(torch, counters)
    os.environ["NFDPM_NO_TENSORBOARD"] = "1"
    t0 = time.perf_counter()
    b = mt_stage1(torch, spy, multi_dir(29, root), "mesh4_b", MT_MESH4_STEPS,
                  ["parallel.n_model=2", "parallel.fsdp=true"])
    sliced = mesh_m.make_mesh(n_model=2, n_slices=2, device=MG_DEVICE)
    out = {"phase": "model_axis_mesh4", "rank": dist.get_rank(), "b": b,
           "coords_two_slices": [sliced.data_rank, sliced.model_rank, sliced.n_data,
                                 sliced.n_model],
           "groups_two_slices": [dist.get_process_group_ranks(sliced.model_group),
                                 dist.get_process_group_ranks(sliced.data_group)],
           "seconds": time.perf_counter() - t0}
    out["launches"] = counts(counters)
    spy.restore()
    emit(out)
    distributed.shutdown()


def mt_check_a(counters, root: Path, w1: dict, m2: list):
    """(a)'s gates: the model-2 run against world 1's, the launches, the
    bytes, and its checkpoint scored by phase=eval in this process (a world
    of one); returns (its record, this process's launches)."""
    from nfdpm_tpu_torch import run_baseline
    from nfdpm_tpu_torch.convert import named_leaves
    from nfdpm_tpu_torch.training.checkpoint import restore_params

    ref = w1["a"]
    ranks = [r["a"] for r in m2]
    bpd_gaps = [abs(g - w) for g, w in zip(ranks[0]["bpd_by_step"], ref["bpd_by_step"])]
    got = dict(named_leaves(restore_params(str(root / ranks[0]["run_dir"]), "gaussian", 1,
                                           "cpu")))
    want = dict(named_leaves(restore_params(str(root / ref["run_dir"]), "gaussian", 1, "cpu")))
    check(got.keys() == want.keys(), "(a) the model-2 checkpoint's leaves differ from world 1's")
    param_gap = max(float((got[k] - want[k]).abs().max()) for k in want if want[k].numel())
    expected = stage1_run_launches(MT_STEPS, len(train_loaders(MT_STEPS).test)
                                   + len(train_loaders(MT_STEPS).eval))
    a = {"bpd_model2": ranks[0]["bpd_by_step"], "bpd_world1": ref["bpd_by_step"],
         "bpd_gap_by_step": bpd_gaps, "final_param_gap": param_gap,
         "final_bpd_model2": ranks[0]["results"], "final_bpd_world1": ref["results"],
         "launches_by_step": [[s["launches"] for s in r["steps"]] for r in ranks],
         "run_launches": [r["launches"] for r in ranks], "expected_run_launches": expected,
         "flow_param_bytes_by_rank": [r["flow_param_bytes"] for r in ranks],
         "predicted_flow_param_bytes_by_rank": [r["predicted_flow_param_bytes"] for r in ranks],
         "world1_flow_param_bytes": ref["flow_param_bytes"],
         "moment_bytes_by_rank": [r["moment_bytes"] for r in ranks],
         "predicted_moment_bytes_by_rank": [r["predicted_moment_bytes"] for r in ranks],
         "world1_moment_bytes": ref["moment_bytes"], "model_leaves": ranks[0]["model_leaves"]}
    # the checkpoint in a world of one: phase=eval in this process
    before = counts(counters)
    evaluated = run_in(root, run_baseline.main, mt_argv(MT_STEPS) + [
        "experiment_name=model2_eval", "phase=eval",
        f"load.load_exp_dir={Path(ranks[0]['run_dir']).name}", "load.load_epoch=1"])
    here = {k: v - before[k] for k, v in counts(counters).items()}
    a["eval_world1"] = evaluated["results"]
    a["eval_gap"] = max(abs(evaluated["results"][k] - ranks[0]["results"][k])
                        for k in ("bpd_test", "bpd_train"))
    a["bytes"] = {k: a[k] for k in ("flow_param_bytes_by_rank", "moment_bytes_by_rank")}
    emit({"phase": "model_axis_a", **a})
    check(len(bpd_gaps) == MT_STEPS and bpd_gaps[0] <= MG_BPD_TOL,
          f"(a) step 1's bits/dim {bpd_gaps[:1]} from world 1's")
    check(max(bpd_gaps) <= TRAIN_TRAJ_TOL, f"(a) bits/dim {bpd_gaps} from world 1's by step")
    check(param_gap <= MG_FINAL_ATOL, f"(a) parameters {param_gap} from world 1's after "
                                      f"{MT_STEPS} steps")
    check(all(step == MG_STEP_LAUNCHES for r in a["launches_by_step"] for step in r)
          and all(len(r) == MT_STEPS for r in a["launches_by_step"]),
          f"(a) the ranks' step launches {a['launches_by_step']}")
    check(all(r == expected for r in a["run_launches"]),
          f"(a) the ranks' run launches {a['run_launches']}, expected {expected}")
    check(a["flow_param_bytes_by_rank"] == a["predicted_flow_param_bytes_by_rank"]
          and a["moment_bytes_by_rank"] == a["predicted_moment_bytes_by_rank"],
          f"(a) bytes {a['flow_param_bytes_by_rank']}, {a['moment_bytes_by_rank']} against "
          f"the placements' {a['predicted_flow_param_bytes_by_rank']}, "
          f"{a['predicted_moment_bytes_by_rank']}")
    check(a["eval_gap"] <= MG_BPD_TOL, f"(a) phase=eval in a world of one {a['eval_gap']} "
                                       "from the model-2 run's final bits/dim")
    return a, here


def mt_check_b(w1: dict, m4: list) -> dict:
    """(b)'s gates: the (2, 2) run with fsdp against world 1's."""
    ranks4 = [r["b"] for r in m4]
    coords = [r["coords"] for r in ranks4]
    b_gap = abs(ranks4[0]["bpd_by_step"][0] - w1["b"]["bpd_by_step"][0])
    b = {"coords_by_rank": coords, "coords_two_slices": [r["coords_two_slices"] for r in m4],
         "groups_two_slices": [r["groups_two_slices"] for r in m4],
         "bpd_mesh4": ranks4[0]["bpd_by_step"], "bpd_world1": w1["b"]["bpd_by_step"],
         "step1_bpd_gap": b_gap, "zero_leaves": ranks4[0]["zero_leaves"],
         "moment_bytes_by_rank": [r["moment_bytes"] for r in ranks4],
         "predicted_moment_bytes_by_rank": [r["predicted_moment_bytes"] for r in ranks4],
         "flow_param_bytes_by_rank": [r["flow_param_bytes"] for r in ranks4],
         "predicted_flow_param_bytes_by_rank": [r["predicted_flow_param_bytes"]
                                                for r in ranks4],
         "world1_flow_param_bytes": w1["b"]["flow_param_bytes"],
         "max_memory_allocated_by_rank": [r["max_memory_allocated"] for r in ranks4],
         "world1_max_memory_allocated": w1["b"]["max_memory_allocated"],
         "launches_by_step": [[s["launches"] for s in r["steps"]] for r in ranks4],
         "step_wall_ms_by_rank": [[s["wall_ms"] for s in r["steps"]] for r in ranks4]}
    emit({"phase": "model_axis_b", **b})
    want_coords = [[r // 2, r % 2, 2, 2] for r in range(4)]
    check(coords == want_coords and b["coords_two_slices"] == want_coords,
          f"(b) coordinates {coords}, over two slices {b['coords_two_slices']}")
    check(all(g == [[2 * (r // 2), 2 * (r // 2) + 1], [r % 2, r % 2 + 2]]
              for r, g in enumerate(b["groups_two_slices"])),
          f"(b) the groups over two slices {b['groups_two_slices']}")
    check(b_gap <= MG_BPD_TOL, f"(b) step 1's bits/dim {b_gap} from world 1's")
    check(b["zero_leaves"] > 0 and b["moment_bytes_by_rank"]
          == b["predicted_moment_bytes_by_rank"]
          and b["flow_param_bytes_by_rank"] == b["predicted_flow_param_bytes_by_rank"],
          f"(b) fsdp's flow parameters {b['flow_param_bytes_by_rank']} and moments "
          f"{b['moment_bytes_by_rank']} against {b['predicted_flow_param_bytes_by_rank']} and "
          f"{b['predicted_moment_bytes_by_rank']} ({b['zero_leaves']} leaves)")
    check(all(step == MG_STEP_LAUNCHES for r in b["launches_by_step"] for step in r),
          f"(b) the ranks' step launches {b['launches_by_step']}")
    return b


def mt_check_c(np, root: Path, w1: dict, m2: list) -> dict:
    """(c)'s gates: stage 2 at (1, 2) against world 1, step 1 from the same
    initial state, every later step against world 1's step from the state
    the model-2 run had before it (mt_same_state); the DDIM chunk."""
    per_step2 = stage2_per_step(True)
    loss_gaps = [max(abs(r["c"]["loss"][i] - w) / abs(w) for r in m2)
                 for i, w in enumerate(w1["c"]["loss"])]
    same = w1["c_same_state"]
    same_gaps = [loss_gaps[0]] + [max(abs(r["c"]["loss"][i + 1] - w) / abs(w) for r in m2)
                                  for i, w in enumerate(same["loss"])]
    with np.load(root / "ddim_world1.npz") as data:
        want_z = dict(data)
    z_gaps, z_beyond = [], 0
    for r in m2:
        with np.load(root / f"ddim_rank{r['rank']}.npz") as z:
            for k, want in want_z.items():
                diff = np.abs(z[k] - want)
                z_gaps.append(float(diff.max()))
                z_beyond += int((diff > MT_CHAIN_ATOL + MT_CHAIN_RTOL * np.abs(want)).sum())
    c = {"loss_model2": m2[0]["c"]["loss"], "loss_world1": w1["c"]["loss"],
         "rel_gap_by_step": loss_gaps, "loss_world1_same_state": same["loss"],
         "same_state_rel_gap_by_step": same_gaps, "launches_per_step": per_step2,
         "launches_by_step": [[s["launches"] for s in r["c"]["steps"]] for r in m2],
         "ddim_images": MT_DDIM_N, "ddim_steps": MT_DDIM_STEPS,
         "ddim_max_latent_gap": max(z_gaps),
         "ddim_latent_gate": LATENT_TOL, "ddim_latents_beyond_cpu_bound": z_beyond,
         "ddim_s": {"world1": w1["c"]["ddim_s"], "model2": [r["c"]["ddim_s"] for r in m2]}}
    emit({"phase": "model_axis_c", **c})
    # every step from the state the model-2 run had before it: Adam's first
    # update, about lr sign(g), turns the model axis's other sums into moves
    # of up to 2 lr wherever the l1 loss's kink flips a sign (PERF.md §6), so
    # world 1's own trajectory (rel_gap_by_step) parts from step 2 on and is
    # recorded, not gated
    check(len(same_gaps) == MG_STAGE2_STEPS and max(same_gaps) <= MG_LOSS_RTOL,
          f"(c) the stage-2 loss {same_gaps} (relative, by step) from world 1's step from "
          "the same state")
    check(all(step == per_step2 for r in c["launches_by_step"] for step in r)
          and all(step == per_step2 for step in same["launches"]),
          f"(c) the ranks' stage-2 step launches {c['launches_by_step']}, the same-state "
          f"steps' {same['launches']}, expected {per_step2}")
    check(max(z_gaps) <= LATENT_TOL, f"(c) the DDIM latents {max(z_gaps)} from world 1's "
                                     f"({z_beyond} past the CPU bound)")
    return c


def mt_timed(steps: list) -> dict:
    """The step whose collectives were timed (ModelAxisSpy.timed_step)."""
    return next(s for s in steps if "ms" in s)


def mt_stage1_timing(smi, ref: dict, ranks: list) -> dict:
    """(d)'s stage-1 part: step wall ms at world 1 and on each model rank
    (the median of the steps between the first and the timed last), the
    model group's collective bytes and calls a step and, on the timed step,
    their ms."""
    return {
        "card": smi,
        "stage1_step_wall_ms_world1": median_of([s["wall_ms"] for s in ref["steps"][1:-1]]),
        "stage1_step_wall_ms_model2_by_rank": [
            median_of([s["wall_ms"] for s in r["steps"][1:-1]]) for r in ranks],
        "stage1_model_group_bytes_per_step": {
            k: ranks[0]["steps"][1][k] for k in ("all_reduce_bytes", "all_reduce_calls",
                                                 "all_gather_bytes", "all_gather_calls")},
        "stage1_collective_ms_timed_step_by_rank": [mt_timed(r["steps"])["ms"] for r in ranks],
        "stage1_timed_step_wall_ms_by_rank": [mt_timed(r["steps"])["wall_ms"] for r in ranks]}


def mt_env() -> dict:
    """The children's environment: this one without a launch's variables,
    deterministic mode."""
    base = {k: v for k, v in os.environ.items()
            if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    base.update(PYTHONPATH=str(ROOT), NFDPM_NO_TENSORBOARD="1", **DETERMINISTIC_ENV)
    return base


def mt_launch(base: dict, n: int, backend: str) -> dict:
    return dict(base, WORLD_SIZE=str(n), LOCAL_RANK="0", MASTER_ADDR="localhost",
                MASTER_PORT=str(free_port()), NFDPM_DIST_BACKEND=backend)


def phase_model_axis_nccl(torch, np, counters, smi) -> dict:
    """Phase 29's (a) and phase 30 over NCCL, their two ranks on two cards
    (--model-axis-nccl, a call with several cards): the same children (the
    two-rank one over NCCL, the world-1 one), gates and records."""
    check(torch.cuda.device_count() >= 2,
          f"--model-axis-nccl needs two cards, {torch.cuda.device_count()} visible")
    root = ROOT / "build" / "chip_smoke" / "model_axis_nccl"
    t0 = time.perf_counter()
    children = launch_children(None, root, {"29a", "30"}, backend="nccl")
    w1 = children["world1"]["model_axis_world1"]
    m2 = [r["model_axis_model2"] for r in children["ranks2"]]
    check(all(r["backend"] == "nccl" for r in m2), "the two-card children are not on NCCL")
    a, here = mt_check_a(counters, multi_dir(29, root), w1, m2)
    record = {"phase": "model_axis_nccl", "card": smi, "cards": torch.cuda.device_count(),
              "a": a, "d": {**mt_stage1_timing(smi, w1["a"], [r["a"] for r in m2]),
                            **a["bytes"]},
              "seconds": time.perf_counter() - t0}
    emit(record)
    pipelined = phase_pipeline(torch, np, counters, smi, children, root, backend="nccl")
    return {k: here[k] + pipelined[k] for k in here}


def phase_model_axis(torch, np, counters, smi, children: dict):
    """Phase 29 (see the module docstring): the gates on its part of the
    children's records (launch_children), (a)'s checkpoint scored in this
    process; returns the launches of its path (its children's part and this
    process's phase=eval, summed)."""
    root = multi_dir(29)
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    w1 = children["world1"]["model_axis_world1"]
    m2 = [r["model_axis_model2"] for r in children["ranks2"]]
    m4 = children["mesh4"]
    record = {"phase": "model_axis", "card": smi}
    record["a"], here = mt_check_a(counters, root, w1, m2)
    ranks, ref = [r["a"] for r in m2], w1["a"]
    record["b"] = mt_check_b(w1, m4)
    record["c"] = mt_check_c(np, root, w1, m2)

    # (d) the record
    record["d"] = {
        **mt_stage1_timing(smi, ref, ranks), **record["a"]["bytes"],
        "stage2_step_wall_ms_world1": median_of([s["wall_ms"] for s in w1["c"]["steps"][1:]]),
        "stage2_step_wall_ms_model2_by_rank": [
            median_of([s["wall_ms"] for s in r["c"]["steps"][1:]]) for r in m2],
        "stage2_model_group_bytes_per_step": {
            k: m2[0]["c"]["steps"][1][k] for k in ("all_reduce_bytes", "all_reduce_calls",
                                                   "all_gather_bytes", "all_gather_calls")},
        "stage2_collective_ms_timed_step_by_rank": [mt_timed(r["c"]["steps"])["ms"]
                                                    for r in m2],
        "note": "gloo on one card moves every all-reduce through the host: no time here is "
                "a scaling figure"}
    emit({"phase": "model_axis_d", **record["d"]})
    seconds = time.perf_counter() - t0
    record.update({"seconds": seconds, "children_work_s": {
        "world1": w1["seconds"], "model2_ranks": [r["seconds"] for r in m2],
        "mesh4_ranks": [r["seconds"] for r in m4]},
        "budget_s": MT_BUDGET_S, "within_budget": seconds <= MT_BUDGET_S})
    launches = {k: here[k] + w1["launches"][k] + sum(r["launches"][k] for r in m2 + m4)
                for k in here}  # the world-1 child's phase-31 runs are phase 31's
    record["launches"] = {"this_process": here, "world1_child": w1["launches"],
                          "model2_ranks": [r["launches"] for r in m2],
                          "mesh4_ranks": [r["launches"] for r in m4], "total": launches}
    emit(record)
    return launches


# -- phase 30: the pipeline ----------------------------------------------------------

PP_MICROBATCHES = 2     # M of the two stages: the JAX entry point's default, n_model
PP_BUDGET_S = 120       # the phase's budget (PERF.md §2)
PP_ARGS = ["parallel.n_model=2", "parallel.pipeline=true",
           f"parallel.pipeline_microbatches={PP_MICROBATCHES}"]


def pp_step_launches(stage: int, n_stages: int = 2) -> dict:
    """A stage's launches a train step: its LEVELS * STEPS / n_stages steps
    on each of the PP_MICROBATCHES microbatches, forward and backward; on
    stage 0 the first step of level 1 takes the images, which need no
    gradient, so it launches no channel_mix dx (world 1's 23 = 2 * 12 - 1)."""
    held = PP_MICROBATCHES * LEVELS * STEPS // n_stages
    dx = held - (PP_MICROBATCHES if stage == 0 else 0)
    return {"channel_mix": held + dx, "coupling_tail": held, "coupling_tail_bwd": held,
            "coupling_tail_inverse": 0, "fused_linear_attention": 0,
            "fused_linear_attention_bwd": 0, "step_megakernel_forward": 0}


def r2_pipeline(torch, spy, root: Path) -> dict:
    """Phase 30's part of a rank of the two-rank child (a pipeline stage):
    run_baseline.main with the pipeline at full width, MT_STEPS steps,
    instrumented."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    a = mt_stage1(torch, spy, multi_dir(30, root), "pipeline", MT_STEPS, PP_ARGS)
    return {"phase": "pipeline_stage", "rank": dist.get_rank(),
            "backend": dist.get_backend(), "a": a, "seconds": time.perf_counter() - t0}


def pp_check(counters, w1_root: Path, root: Path, w1: dict, stages: list):
    """Phase 30's gates: the pipelined run against world 1's, each stage's
    launches and bytes, the checkpoint scored by phase=eval in this process
    (a world of one); returns (its record, this process's launches)."""
    from nfdpm_tpu_torch import run_baseline
    from nfdpm_tpu_torch.convert import named_leaves
    from nfdpm_tpu_torch.training.checkpoint import restore_params

    ref = w1["a"]
    ranks = [r["a"] for r in stages]
    bpd_gaps = [abs(g - w) for g, w in zip(ranks[0]["bpd_by_step"], ref["bpd_by_step"])]
    got = dict(named_leaves(restore_params(str(root / ranks[0]["run_dir"]), "gaussian", 1,
                                           "cpu")))
    want = dict(named_leaves(restore_params(str(w1_root / ref["run_dir"]), "gaussian", 1,
                                            "cpu")))
    check(got.keys() == want.keys(), "the pipeline's checkpoint leaves differ from world 1's")
    param_gap = max(float((got[k] - want[k]).abs().max()) for k in want if want[k].numel())
    evals = len(train_loaders(MT_STEPS).test) + len(train_loaders(MT_STEPS).eval)
    per_step = [pp_step_launches(r["coords"][1]) for r in ranks]
    eval_part = stage1_run_launches(0, evals)
    expected = [{k: MT_STEPS * p[k] + eval_part[k] for k in p} for p in per_step]
    timed = [mt_timed(r["steps"]) for r in ranks]
    rec = {"bpd_pipeline": ranks[0]["bpd_by_step"], "bpd_world1": ref["bpd_by_step"],
           "bpd_gap_by_step": bpd_gaps, "final_param_gap": param_gap,
           "final_bpd_pipeline": ranks[0]["results"], "final_bpd_world1": ref["results"],
           "stage_by_rank": [r["coords"][1] for r in ranks],
           "launches_by_step": [[s["launches"] for s in r["steps"]] for r in ranks],
           "expected_step_launches": per_step,
           "run_launches": [r["launches"] for r in ranks], "expected_run_launches": expected,
           "flow_param_bytes_by_rank": [r["flow_param_bytes"] for r in ranks],
           "predicted_flow_param_bytes_by_rank": [r["predicted_flow_param_bytes"] for r in ranks],
           "world1_flow_param_bytes": ref["flow_param_bytes"],
           "moment_bytes_by_rank": [r["moment_bytes"] for r in ranks],
           "predicted_moment_bytes_by_rank": [r["predicted_moment_bytes"] for r in ranks],
           "world1_moment_bytes": ref["moment_bytes"],
           "max_memory_allocated_by_rank": [r["max_memory_allocated"] for r in ranks],
           "world1_max_memory_allocated": ref["max_memory_allocated"],
           "step_wall_ms_world1": median_of([s["wall_ms"] for s in ref["steps"][1:-1]]),
           "step_wall_ms_pipeline_by_rank": [median_of([s["wall_ms"] for s in r["steps"][1:-1]])
                                             for r in ranks],
           "hop_flush_per_step_by_rank": [{k: r["steps"][1][k] for k in (
               "hop_bytes", "hop_calls", "flush_bytes", "flush_calls")} for r in ranks],
           "hop_flush_ms_timed_step_by_rank": [t["ms"] for t in timed],
           "timed_step_wall_ms_by_rank": [t["wall_ms"] for t in timed],
           "note": "the timed step's ms are the hops' and flushes' synchronised wall time, "
                   "forward and backward"}
    before = counts(counters)
    evaluated = run_in(root, run_baseline.main, mt_argv(MT_STEPS) + [
        "experiment_name=pipeline_eval", "phase=eval",
        f"load.load_exp_dir={Path(ranks[0]['run_dir']).name}", "load.load_epoch=1"])
    here = {k: v - before[k] for k, v in counts(counters).items()}
    rec["eval_world1"] = evaluated["results"]
    rec["eval_gap"] = max(abs(evaluated["results"][k] - ranks[0]["results"][k])
                          for k in ("bpd_test", "bpd_train"))
    check(len(bpd_gaps) == MT_STEPS and bpd_gaps[0] <= MG_BPD_TOL,
          f"(pipeline) step 1's bits/dim {bpd_gaps[:1]} from world 1's")
    check(max(bpd_gaps) <= TRAIN_TRAJ_TOL,
          f"(pipeline) bits/dim {bpd_gaps} from world 1's by step")
    check(param_gap <= MG_FINAL_ATOL,
          f"(pipeline) parameters {param_gap} from world 1's after {MT_STEPS} steps")
    check(sorted(rec["stage_by_rank"]) == [0, 1], f"(pipeline) stages {rec['stage_by_rank']}")
    check(all(len(steps) == MT_STEPS and all(s == want for s in steps)
              for steps, want in zip(rec["launches_by_step"], per_step)),
          f"(pipeline) the stages' step launches {rec['launches_by_step']}, expected {per_step}")
    check(rec["run_launches"] == expected,
          f"(pipeline) the stages' run launches {rec['run_launches']}, expected {expected}")
    check(rec["flow_param_bytes_by_rank"] == rec["predicted_flow_param_bytes_by_rank"]
          and rec["moment_bytes_by_rank"] == rec["predicted_moment_bytes_by_rank"],
          f"(pipeline) bytes {rec['flow_param_bytes_by_rank']}, {rec['moment_bytes_by_rank']} "
          f"against the placements' {rec['predicted_flow_param_bytes_by_rank']}, "
          f"{rec['predicted_moment_bytes_by_rank']}")
    check(rec["eval_gap"] <= MG_BPD_TOL, f"(pipeline) phase=eval in a world of one "
                                         f"{rec['eval_gap']} from the run's final bits/dim")
    return rec, here


def phase_pipeline(torch, np, counters, smi, children: dict, root: Path = None,
                   backend: str = "gloo") -> dict:
    """Phase 30 (see the module docstring): two pipeline stages over
    `backend` ("gloo": sharing this card; "nccl": on two cards), the
    two-rank child's, against the world-1 child's run (launch_children, its
    files under `root`); returns the launches of its path: the stages' and
    this process's phase=eval, summed."""
    root = MULTI_ROOT if root is None else root
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    w1, w1_root = children["world1"]["model_axis_world1"], multi_dir(29, root)
    stages = [r["pipeline_stage"] for r in children["ranks2"]]
    root = multi_dir(30, root)
    check(all(r["backend"] == backend for r in stages),
          f"the stages ran on {[r['backend'] for r in stages]}, not {backend}")
    rec, here = pp_check(counters, w1_root, root, w1, stages)
    seconds = time.perf_counter() - t0
    record = {"phase": "pipeline", "card": smi, "backend": backend,
              "cards": torch.cuda.device_count(), "microbatches": PP_MICROBATCHES,
              "stages": 2, "steps": MT_STEPS, **rec, "seconds": seconds,
              "children_work_s": [r["seconds"] for r in stages],
              "budget_s": PP_BUDGET_S, "within_budget": seconds <= PP_BUDGET_S}
    launches = {k: here[k] + sum(r["launches"][k] for r in stages) for k in here}
    record["launches"] = {"this_process": here, "stages": [r["launches"] for r in stages],
                          "total": launches}
    emit(record)
    return launches


# -- phase 31: spatial partitioning ---------------------------------------------------

SP_BUDGET_S = 120       # the phase's budget (PERF.md §2)
SP_ARGS = ["parallel.n_model=2", "parallel.spatial=true"]
SP_GROUPS = 1           # (b): resnet_block_groups; one group a norm, split over both ranks
SP_STAGE2_BATCH = 16    # (b): images a stage-2 step and in the run's VLB batch, and
SP_STAGE2_T = 10        # the diffusion's T, cut from the config's 1000 (PERF.md §7): the
# VLB batch
# evaluates each UNet T times, and at model 2 every evaluation waits on about 100
# all-reduces through the host (gloo): at T = 1000 one VLB batch of 16 took 85 s a run,
# and at T = 100 the phase took 123.3 s on a slower host, on an NVIDIA H100 80GB HBM3,
# 700 W (PERF.md §6)
SP_COTRAINED = ["model.normalizing_flow.freeze=false", "model.normalizing_flow.lr=1e-4"]


def sp_halo_bytes():
    """(bytes, exchanges) one rank of two sends in a stage-1 forward at
    (1, 2): one fp32 row of each 3x3 convolution's input to its one
    neighbour, per Glow step conv1's (C/2 channels) and the zeroconv's
    (WIDTH), per split prior the kept half's (C/2). At configs/nf_base.yaml,
    batch 64: 15,024,128 B in 26 exchanges."""
    total = calls = 0
    c, size = 3, IMG
    for level in range(LEVELS):
        c, size = c * 4, size // 2
        total += STEPS * BATCH * size * 4 * (c // 2 + WIDTH)
        calls += 2 * STEPS
        if level < LEVELS - 1:
            c //= 2
            total += BATCH * size * 4 * c
            calls += 1
    return total, calls


def sp_row_kernels(torch) -> dict:
    """The kernels of a spatial step against their plain versions at the
    shapes a rank's row block gives them at (1, 2): each level's
    (b, h/2, w, c) at (a)'s batch and at (b)'s (the deepest level 8
    pixels an image at 32x32 where the whole image has 16). channel_mix
    and its dx mode, coupling_step_tail and coupling_step_tail_bwd, at the
    tolerances of phases 10 and 11, the same bits on a second call; the
    tails' plans at these pixel counts. Its launches are comparisons, made
    before phase 31 sets the counts to 0. Fails the phase on a miss."""
    from nfdpm_tpu_torch.ops.kernels import channel_mix as cm
    from nfdpm_tpu_torch.ops.kernels import coupling_tail as ct

    dev = torch.device(MG_DEVICE)
    gen = torch.Generator(device=dev).manual_seed(3456)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def gap(a, e):
        return float((a - e).abs().max())

    cases = []
    for b in sorted({BATCH, SP_STAGE2_BATCH}, reverse=True):
        for h, w, c in level_shapes():
            h //= 2  # model 2: the rank's rows
            x, wt, bias, g = randn(b, h, w, c), randn(c, c, scale=c ** -0.5), randn(c), \
                randn(b, h, w, c)
            r, zb, zlogs, ldj0 = randn(b, h, w, c, scale=0.5), randn(c, scale=0.2), \
                randn(c, scale=0.2), randn(b, scale=10.0)
            g_ldj = randn(b)
            n = b * h * w
            # (name, kernel outputs, plain outputs, a second call, (rtol, atol) an output)
            rows = [
                ("channel_mix", [cm.channel_mix(x, wt, bias)],
                 [cm.channel_mix_plain(x, wt, bias)], [cm.channel_mix(x, wt, bias)],
                 [(1e-5, 1e-5)]),
                ("channel_mix_dx", [cm.channel_mix_dx(g, wt)], [cm.channel_mix_dx_plain(g, wt)],
                 [cm.channel_mix_dx(g, wt)], [(1e-5, 1e-5)]),
                ("coupling_tail", list(ct.coupling_step_tail(x, r, zb, zlogs, ldj0)),
                 list(ct.coupling_step_tail_plain(x, r, zb, zlogs, ldj0)),
                 list(ct.coupling_step_tail(x, r, zb, zlogs, ldj0)),
                 [(1e-5, 1e-5), (1e-5, 1e-4)]),
                ("coupling_tail_bwd", list(ct.coupling_step_tail_bwd(x, r, zb, zlogs, g, g_ldj)),
                 list(ct.coupling_step_tail_bwd_plain(x, r, zb, zlogs, g, g_ldj)),
                 list(ct.coupling_step_tail_bwd(x, r, zb, zlogs, g, g_ldj)),
                 [(1e-5, 1e-5), (1e-5, 1e-5), (1e-4, 1e-4), (1e-4, 1e-4)])]
            if dev.type == "cuda":
                torch.cuda.synchronize()
            vw = ct.vector_width(c // 2, x.data_ptr(), r.data_ptr())
            vw_bwd = ct.vector_width(c // 2, x.data_ptr(), r.data_ptr(), g.data_ptr())
            case = {"x": [b, h, w, c], "pixels_per_image": h * w,
                    "plans": {"channel_mix": cm.plan(n, c, c)._asdict(),
                              "coupling_tail": ct.forward_plan(b, h * w, c // 2, vw)._asdict(),
                              "coupling_tail_bwd": ct.backward_plan(
                                  b, h * w, c // 2, vw_bwd)._asdict()},
                    "max_abs_err": {}}
            for name, got, want, again, tols in rows:
                case["max_abs_err"][name] = max(gap(a, e) for a, e in zip(got, want))
                check(len(got) == len(tols) and all(
                    torch.allclose(a, e, rtol=rtol, atol=atol)
                    for a, e, (rtol, atol) in zip(got, want, tols)),
                      f"phase 31: {name} differs from its plain version at a rank's rows "
                      f"{(b, h, w, c)}: {case['max_abs_err'][name]}")
                check(all(torch.equal(a, e) for a, e in zip(got, again)),
                      f"phase 31: {name} gave other bits on a second call at {(b, h, w, c)}")
            cases.append(case)
    record = {"phase": "spatial_row_kernels", "cases": cases}
    emit(record)
    return record


def sp_step_losses(run_dir: Path) -> list:
    """Each stage-2 train step's loss (l1, or l1_plus_bpd co-trained), from
    the run's metrics.jsonl."""
    rows = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    train = [r for r in rows if r["name"].startswith("l1") and r["step"] is not None
             and (r.get("context") or {}).get("subset") == "train"]
    return [r["value"] for r in sorted(train, key=lambda r: r["step"])]


def sp_stage2(torch, spy, root: Path, extra=()) -> dict:
    """(b): run_diffusion_prior.main over phase 12's frozen flow (linked as
    <root>/outputs/stage1) at the config's UNet width with SP_GROUPS groups
    and T = SP_STAGE2_T, MG_STAGE2_STEPS steps of SP_STAGE2_BATCH, then one
    co-trained step, each
    with `extra` overrides, instrumented: the losses (rank 0's log), each
    step's launches, wall ms and collectives, the peak of allocated memory."""
    import torch.distributed as dist

    from nfdpm_tpu_torch import run_diffusion_prior

    out = {}
    for name, steps, more in (("frozen", MG_STAGE2_STEPS, []),
                              ("cotrained", 1, SP_COTRAINED)):
        spy.steps, spy.timed_step = [], steps - 1
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        result = run_in(root, run_diffusion_prior.main, stage2_overrides("stage1", steps) + [
            f"data.batch_size={SP_STAGE2_BATCH}", f"data.synthetic_n={SP_STAGE2_BATCH * steps}",
            f"model.unet.resnet_block_groups={SP_GROUPS}",
            f"model.diffusion.timesteps={SP_STAGE2_T}",
            f"model.diffusion.sampling_timesteps={SP_STAGE2_T}",  # at most T; no run samples
            "model.logging.log_gen_images_per_iter=1000", "model.training.save_checkpoint_freq=50",
            f"experiment_name=s2_{name}", *more, *extra] + MG_ENTRY_ARGS)
        torch.cuda.synchronize()
        rec = {"run_dir": result["run_dir"], "vlb_bpd": result["vlb_bpd"],
               "seconds": time.perf_counter() - t0, "steps": spy.steps,
               "max_memory_allocated": torch.cuda.max_memory_allocated()}
        if not dist.is_initialized() or dist.get_rank() == 0:
            rec["loss_by_step"] = sp_step_losses(root / result["run_dir"])
        out[name] = rec
    return out


def r2_spatial(torch, spy, root: Path) -> dict:
    """Phase 31's part of a rank of the two-rank child, at (data 1, model
    2): (a) run_baseline.main and (b) run_diffusion_prior.main with
    parallel.spatial=true."""
    import torch.distributed as dist

    d31 = multi_dir(31, root)
    t0 = time.perf_counter()
    a = mt_stage1(torch, spy, d31, "spatial_a", MT_STEPS, SP_ARGS)
    return {"phase": "spatial_model2", "rank": dist.get_rank(), "backend": dist.get_backend(),
            "a": a, "b": sp_stage2(torch, spy, d31, SP_ARGS),
            "seconds": time.perf_counter() - t0}


def sp_check_a(counters, w1_root: Path, root: Path, w1: dict, m2: list):
    """(a)'s gates: the spatial run against world 1's, the launches, the
    bytes held and exchanged, its checkpoint scored by phase=eval in this
    process (a world of one); returns (its record, this process's
    launches)."""
    from nfdpm_tpu_torch import run_baseline
    from nfdpm_tpu_torch.convert import named_leaves
    from nfdpm_tpu_torch.training.checkpoint import restore_params

    ref, ranks = w1["a"], [r["a"] for r in m2]
    bpd_gaps = [abs(g - w) for g, w in zip(ranks[0]["bpd_by_step"], ref["bpd_by_step"])]
    got = dict(named_leaves(restore_params(str(root / ranks[0]["run_dir"]), "gaussian", 1,
                                           "cpu")))
    want = dict(named_leaves(restore_params(str(w1_root / ref["run_dir"]), "gaussian", 1,
                                            "cpu")))
    check(got.keys() == want.keys(), "(a) the spatial checkpoint's leaves differ from world 1's")
    param_gap = max(float((got[k] - want[k]).abs().max()) for k in want if want[k].numel())
    expected = stage1_run_launches(MT_STEPS, len(train_loaders(MT_STEPS).test)
                                   + len(train_loaders(MT_STEPS).eval))
    halo, exchanges = sp_halo_bytes()
    a = {"bpd_spatial": ranks[0]["bpd_by_step"], "bpd_world1": ref["bpd_by_step"],
         "bpd_gap_by_step": bpd_gaps, "final_param_gap": param_gap,
         "final_bpd_spatial": ranks[0]["results"], "final_bpd_world1": ref["results"],
         "launches_by_step": [[s["launches"] for s in r["steps"]] for r in ranks],
         "run_launches": [r["launches"] for r in ranks], "expected_run_launches": expected,
         "flow_param_bytes_by_rank": [r["flow_param_bytes"] for r in ranks],
         "world1_flow_param_bytes": ref["flow_param_bytes"],
         "moment_bytes_by_rank": [r["moment_bytes"] for r in ranks],
         "world1_moment_bytes": ref["moment_bytes"],
         "halo_by_step": [[{k: s[k] for k in ("halo_bytes", "halo_calls", "halo_back_bytes",
                                               "halo_back_calls")} for s in r["steps"]]
                          for r in ranks],
         "predicted_halo_bytes": halo, "predicted_halo_calls": exchanges,
         "max_memory_allocated_by_rank": [r["max_memory_allocated"] for r in ranks],
         "world1_max_memory_allocated": ref["max_memory_allocated"]}
    before = counts(counters)
    evaluated = run_in(root, run_baseline.main, mt_argv(MT_STEPS) + [
        "experiment_name=spatial_eval", "phase=eval",
        f"load.load_exp_dir={Path(ranks[0]['run_dir']).name}", "load.load_epoch=1"])
    here = {k: v - before[k] for k, v in counts(counters).items()}
    a["eval_world1"] = evaluated["results"]
    a["eval_gap"] = max(abs(evaluated["results"][k] - ranks[0]["results"][k])
                        for k in ("bpd_test", "bpd_train"))
    emit({"phase": "spatial_a", **a})
    check(len(bpd_gaps) == MT_STEPS and bpd_gaps[0] <= MG_BPD_TOL,
          f"(a) step 1's bits/dim {bpd_gaps[:1]} from world 1's")
    check(max(bpd_gaps) <= TRAIN_TRAJ_TOL, f"(a) bits/dim {bpd_gaps} from world 1's by step")
    check(param_gap <= MG_FINAL_ATOL, f"(a) parameters {param_gap} from world 1's after "
                                      f"{MT_STEPS} steps")
    check(all(step == MG_STEP_LAUNCHES for r in a["launches_by_step"] for step in r)
          and all(len(r) == MT_STEPS for r in a["launches_by_step"]),
          f"(a) the ranks' step launches {a['launches_by_step']}")
    check(all(r == expected for r in a["run_launches"]),
          f"(a) the ranks' run launches {a['run_launches']}, expected {expected}")
    check(all(b == ref["flow_param_bytes"] for b in a["flow_param_bytes_by_rank"])
          and all(b == ref["moment_bytes"] for b in a["moment_bytes_by_rank"]),
          f"(a) bytes {a['flow_param_bytes_by_rank']}, {a['moment_bytes_by_rank']} against world "
          f"1's {ref['flow_param_bytes']}, {ref['moment_bytes']} (no slabs of the flow)")
    check(all(s == {"halo_bytes": halo, "halo_calls": exchanges, "halo_back_bytes": halo,
                    "halo_back_calls": exchanges} for r in a["halo_by_step"] for s in r),
          f"(a) the halo a step {a['halo_by_step']}, predicted {halo} B in {exchanges} "
          "exchanges each way")
    check(a["eval_gap"] <= MG_BPD_TOL, f"(a) phase=eval in a world of one {a['eval_gap']} "
                                       "from the spatial run's final bits/dim")
    return a, here


def sp_check_b(ref: dict, m2: list) -> dict:
    """(b)'s gates: the spatial stage-2 runs, frozen and co-trained, against
    world 1's of the same group count (`ref`, sp_stage2's record): the loss
    of each step, the launches."""
    b = {"groups": SP_GROUPS, "batch": SP_STAGE2_BATCH, "timesteps": SP_STAGE2_T}
    for name, frozen in (("frozen", True), ("cotrained", False)):
        want, got = ref[name], m2[0]["b"][name]
        per_step = stage2_per_step(frozen)
        gaps = [abs(g - w) / abs(w) for g, w in zip(got["loss_by_step"], want["loss_by_step"])]
        b[name] = {"loss_spatial": got["loss_by_step"], "loss_world1": want["loss_by_step"],
                   "rel_gap_by_step": gaps, "launches_per_step": per_step,
                   "launches_by_step": [[s["launches"] for s in r["b"][name]["steps"]]
                                        for r in m2],
                   "vlb_spatial": got["vlb_bpd"], "vlb_world1": want["vlb_bpd"],
                   "seconds_by_rank": [r["b"][name]["seconds"] for r in m2],
                   "world1_seconds": want["seconds"]}
        steps = MG_STAGE2_STEPS if frozen else 1
        # step 1 only, the later steps recorded: these are entry-point runs
        # (run_diffusion_prior.main, which owns its train state and writes
        # only the final checkpoint), so no state before a later step reaches
        # a world-1 reference, as phase 29 (c)'s step loop lets it
        # (mt_same_state); from step 2 on Adam's first update turns the
        # spatial sums' rounding into moves of up to 2 lr (PERF.md §6)
        check(len(gaps) == steps and gaps[0] <= MG_LOSS_RTOL,
              f"(b) {name}: step 1's stage-2 loss {gaps[0]} (relative) from world 1's")
        check(all(len(r) == steps and all(s == per_step for s in r)
                  for r in b[name]["launches_by_step"]),
              f"(b) {name}: the ranks' step launches {b[name]['launches_by_step']}, expected "
              f"{per_step}")
    emit({"phase": "spatial_b", **b})
    return b


def phase_spatial(torch, np, counters, smi, children: dict) -> dict:
    """Phase 31 (see the module docstring): first the kernels at the rank's
    row-block shapes against their plain versions (sp_row_kernels), then
    the gates on the two-rank child's spatial runs against the world-1
    child's, which also made (b)'s references (launch_children). Returns
    the launches of the spatial path (the two spatial ranks' and this
    process's phase=eval, summed) and those of the world-1 child's (b)
    runs it compares with, apart."""
    t0 = time.perf_counter()
    row_kernels = sp_row_kernels(torch)
    for fn in counters:
        fn.launches = 0
    w1, w1_root = children["world1"]["model_axis_world1"], multi_dir(29)
    w1_launches = w1["sp_b_launches"]
    m2 = [r["spatial_model2"] for r in children["ranks2"]]
    root = multi_dir(31)
    check(all(r["backend"] == "gloo" for r in m2), "the spatial children are not on gloo")
    record = {"phase": "spatial", "card": smi, "row_kernels_s": time.perf_counter() - t0,
              "row_kernels": row_kernels["cases"]}
    record["a"], here = sp_check_a(counters, w1_root, root, w1, m2)
    record["b"] = sp_check_b(w1["sp_b"], m2)
    ranks, ref = [r["a"] for r in m2], w1["a"]
    timed = [mt_timed(r["steps"]) for r in ranks]
    frozen = [r["b"]["frozen"] for r in m2]
    record["c"] = {
        "card": smi,
        "stage1_step_wall_ms_world1": median_of([s["wall_ms"] for s in ref["steps"][1:-1]]),
        "stage1_step_wall_ms_spatial_by_rank": [
            median_of([s["wall_ms"] for s in r["steps"][1:-1]]) for r in ranks],
        "stage1_per_step": {k: ranks[0]["steps"][1][k] for k in (
            "halo_bytes", "halo_calls", "halo_back_bytes", "halo_back_calls", "grad_sum_bytes",
            "grad_sum_calls", "all_reduce_bytes", "all_reduce_calls")},
        "stage1_timed_step_ms_by_rank": [{k: t.get(k, 0.0) for k in (
            "wall_ms", "ms", "halo_ms", "halo_back_ms", "grad_sum_ms", "all_reduce_ms")}
            for t in timed],
        "stage2_step_wall_ms_world1": median_of([s["wall_ms"]
                                                 for s in w1["sp_b"]["frozen"]["steps"][1:]]),
        "stage2_step_wall_ms_spatial_by_rank": [median_of([s["wall_ms"] for s in f["steps"][1:]])
                                                for f in frozen],
        "stage2_per_step": {k: frozen[0]["steps"][1][k] for k in (
            "row_gather_bytes", "row_gather_calls", "halo_bytes", "halo_calls",
            "all_reduce_bytes", "all_reduce_calls", "all_gather_bytes", "all_gather_calls")},
        "stage2_timed_step_ms_by_rank": [{k: t.get(k, 0.0) for k in (
            "wall_ms", "ms", "row_gather_ms", "halo_ms", "all_reduce_ms", "all_gather_ms")}
            for t in (mt_timed(f["steps"]) for f in frozen)],
        "max_memory_allocated": {
            "stage1_world1": ref["max_memory_allocated"],
            "stage1_spatial_by_rank": [r["max_memory_allocated"] for r in ranks],
            "stage2_world1": w1["sp_b"]["frozen"]["max_memory_allocated"],
            "stage2_spatial_by_rank": [f["max_memory_allocated"] for f in frozen]},
        "note": "gloo on one card moves every exchange and all-reduce through the host: no "
                "time here is a scaling figure"}
    emit({"phase": "spatial_c", **record["c"]})
    seconds = time.perf_counter() - t0
    record.update({"seconds": seconds, "children_work_s": [r["seconds"] for r in m2],
                   "budget_s": SP_BUDGET_S, "within_budget": seconds <= SP_BUDGET_S})
    launches = {k: here[k] + sum(r["launches"][k] for r in m2) for k in here}
    record["launches"] = {"this_process": here, "spatial_ranks": [r["launches"] for r in m2],
                          "total": launches, "world1_reference": w1_launches}
    emit(record)
    return launches, w1_launches


# -- phase 32: the last modules of the JAX package ----------------------------------

LM_STEPS = 4            # (a): stage-2 train steps of each UNet variant, batch 64
LM_OPTIONS = {"default": {}, "remat": {"remat": True}, "stacked": {"stacked_mid_attn": True}}
LM_LOSS_RTOL = 1e-5     # (a): a variant's loss each step against the default UNet's
LM_VLB_RTOL = 1e-5      # (b): the per-part values, weighted, against the total nats
LM_HOST_REPEATS = 50    # (c): batch assemblies timed on each path
LM_LOADER_ROUNDS = 3    # (c): epochs of the stage-1 step fed by each path, in turns
LM_BUDGET_S = 60        # the phase's budget (PERF.md §2)


def vlb_pass_launches(timesteps: int) -> dict:
    """The launches of one VLB pass of the three UNets over latents at T =
    `timesteps`: the linear attention's, vlb_time_chunk timesteps a call."""
    calls = -(-timesteps // DIFFUSION_KWARGS["vlb_time_chunk"])
    return {"channel_mix": 0, "coupling_tail": 0, "coupling_tail_bwd": 0,
            "coupling_tail_inverse": 0,
            "fused_linear_attention": LEVELS * 2 * len(UNET_KWARGS["dim_mults"]) * calls,
            "fused_linear_attention_bwd": 0, "step_megakernel_forward": 0}


def lm_unet_options(torch, counters, backbone, flow) -> dict:
    """(a) LM_STEPS stage-2 steps (configs/nf_diffusion.yaml's three UNets
    over phase 12's frozen flow, batch 64, the steps' own draws) of the
    default UNet, then with remat=True and with stacked_mid_attn=True, each
    from the same seeded state on the same batches: the losses, each
    step's launches and wall ms, step 1's gradients, the peak of allocated
    memory over the steps."""
    from nfdpm_tpu_torch.training import diffusion_trainer as dt

    batches = mg_batches(torch, LM_STEPS)
    out, grads = {}, {}
    for name, unet_kwargs in LM_OPTIONS.items():
        dp = stage2_prior(unet_overrides=unet_kwargs)
        tcfg = dt.DiffusionTrainConfig(lr_diffusion=1e-3)
        tx = dt.make_two_group_optimizer(tcfg, True)
        state = dt.init_train_state(TRAIN_SEED, backbone, flow, dp, tx, device=MG_DEVICE)
        step = dt.make_train_step(backbone, dp, tcfg, tx, device=MG_DEVICE)
        torch.cuda.synchronize()
        allocated = torch.cuda.memory_allocated() if MG_DEVICE == "cuda" else 0
        torch.cuda.reset_peak_memory_stats()
        losses, launches, walls = [], [], []
        for i, batch in enumerate(batches):
            before = counts(counters)
            t0 = time.perf_counter()
            state, metrics = step(state, batch, TRAIN_SEED)
            losses.append(float(metrics["loss"]))  # waits for the step
            walls.append((time.perf_counter() - t0) * 1e3)
            launches.append({k: v - before[k] for k, v in counts(counters).items()})
            if i == 0:
                grads[name] = [{n: q.grad.detach().clone() for n, q in u.named_parameters()}
                               for u in state["params"]["diffusion"]["parts"]]
        out[name] = {"unet_kwargs": unet_kwargs, "loss": losses, "launches_by_step": launches,
                     "step_wall_ms": walls, "allocated_before_steps": allocated,
                     "max_memory_allocated": torch.cuda.max_memory_allocated()}
        del state, step
        torch.cuda.empty_cache()
    want = out["default"]["max_memory_allocated"] - out["default"]["allocated_before_steps"]
    for name in ("remat", "stacked"):
        rec = out[name]
        rec["rel_gap_by_step"] = [abs(a - b) / abs(b) for a, b in
                                  zip(rec["loss"], out["default"]["loss"])]
        gaps = [max(float((a[n] - b[n]).abs().max()) / (float(b[n].abs().max()) or 1.0)
                    for n in b) for a, b in zip(grads[name], grads["default"])]
        rec["step1_max_grad_gap_share_by_part"] = gaps
        rec["peak_over_state_vs_default"] = (
            (rec["max_memory_allocated"] - rec["allocated_before_steps"]) / want
            if want else None)
    emit({"phase": "last_modules_unet_options", **out})
    per_step = stage2_per_step(True)
    for name, rec in out.items():
        check(all(step == per_step for step in rec["launches_by_step"]),
              f"(a) {name}: launches a step {rec['launches_by_step']}, expected {per_step}")
    for name in ("remat", "stacked"):
        rec = out[name]
        check(max(rec["rel_gap_by_step"]) <= LM_LOSS_RTOL,
              f"(a) {name}: the loss {rec['rel_gap_by_step']} (relative, by step) from the "
              "default UNet's")
        check(max(rec["step1_max_grad_gap_share_by_part"]) <= STAGE2_GRAD_TOL,
              f"(a) {name}: step 1's gradients {rec['step1_max_grad_gap_share_by_part']} of "
              f"a leaf's largest entry from the default UNet's")
    return out


def lm_per_part_vlb(torch, counters, backbone, flow) -> dict:
    """(b) DiffusionPrior.evaluate_neg_log_likelihood and
    neg_log_likelihood_nats on one seeded batch of VLB_BATCH images at the
    config's T (phase 7's), the seeded UNets of phase 7, with the same
    injected draws: each part's value weighted by its processed dims
    squared (the value is the part's VLB, a sum of per-dim terms, over its
    dims), plus the formater's sum(log std), against the total; the
    attention's exact launches."""
    import numpy as np

    from nfdpm_tpu_torch.ops import quantize as q

    dp = stage2_prior()
    diffusion = dp.init_params(seed=5, device=MG_DEVICE)
    randomize_unet_vectors(torch, diffusion["parts"], seed=6)
    gen = torch.Generator(device=MG_DEVICE).manual_seed(32)
    imgs = np.random.default_rng(32).integers(0, 256, (VLB_BATCH, IMG, IMG, 3), dtype=np.uint8)
    timesteps = DIFFUSION_KWARGS["timesteps"]
    with torch.inference_mode():
        x = torch.from_numpy(imgs).to(MG_DEVICE).float() / 255.0
        x = q.dequantize(gen, q.preprocess(x, N_BITS), N_BITS)
        latents, _ = backbone.transform(flow, x)
        noise = [[torch.randn((VLB_BATCH, h, w, c), generator=gen, device=MG_DEVICE)
                  for _ in range(timesteps)] for (h, w, c) in dp.formater.input_shapes]
        seconds, launches = {}, {}
        for name, fn in (("per_part", dp.evaluate_neg_log_likelihood),
                         ("nats", dp.neg_log_likelihood_nats)):
            before = counts(counters)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = fn(diffusion, latents, noise=noise)
            torch.cuda.synchronize()
            seconds[name] = time.perf_counter() - t0
            launches[name] = {k: v - before[k] for k, v in counts(counters).items()}
            if name == "per_part":
                per_part = got
            else:
                nats = got
    dims = [float(np.prod(s)) for s in dp.formater.input_shapes]
    total = sum(v * d * d for v, d in zip(per_part, dims)) + dp.formater.stats_log_sigma_total()
    gap = float(((total - nats).abs() / nats.abs()).max())
    want = vlb_pass_launches(timesteps)
    rec = {"batch": VLB_BATCH, "timesteps": timesteps, "dims": dims,
           "per_part_mean": [float(v.mean()) for v in per_part],
           "nats_mean": float(nats.mean()), "weighted_rel_gap": gap, "tolerance": LM_VLB_RTOL,
           "seconds": seconds, "launches": launches, "expected_launches_a_pass": want}
    emit({"phase": "last_modules_vlb", **rec})
    check(len(per_part) == dp.num_parts and all(bool(torch.isfinite(v).all()) for v in per_part),
          "(b) evaluate_neg_log_likelihood gave other parts or a value not finite")
    check(gap <= LM_VLB_RTOL, f"(b) the per-part values weighted are {gap} (relative) from "
                              "neg_log_likelihood_nats")
    check(launches["per_part"] == want == launches["nats"],
          f"(b) launches {launches}, expected {want} a pass")
    return rec


def synchronous_batches(iterator, device):
    """The loader's batches moved to `device` on the main thread, one at a
    time: the path without the producer thread."""
    import numpy as np
    import torch

    for item in iterator:
        yield (torch.from_numpy(np.ascontiguousarray(item[0])).to(device),) + tuple(item[1:])


@contextlib.contextmanager
def synchronous_loader():
    """nf_trainer.train and the loaders on the path without the producer
    thread: batches assembled by the numpy path and moved on the main
    thread."""
    import functools

    from nfdpm_tpu_torch.data import native
    from nfdpm_tpu_torch.training import nf_trainer as nft

    saved = nft.prefetch_to_device, native.batch_gather_normalize
    nft.prefetch_to_device = synchronous_batches
    native.batch_gather_normalize = functools.partial(saved[1], native=False)
    try:
        yield
    finally:
        nft.prefetch_to_device, native.batch_gather_normalize = saved


def w1_loader_epochs(torch, counters, root: Path) -> dict:
    """Phase 32 (c)'s deterministic part, in the world-1 child (deterministic
    mode): nf_trainer.train at configs/nf_base.yaml's width, one epoch of
    TRAIN_STEPS steps through the producer thread (native assembly), then
    through the synchronous path, from the same seed: each step's bits/dim,
    the final states' gap. Its record."""
    from nfdpm_tpu_torch.data import native
    from nfdpm_tpu_torch.training import nf_trainer as nft

    cfg, tcfg = train_configs()
    out = {"phase": "last_modules_loader", "native": native.available()}
    states = {}
    for path in ("producer", "synchronous"):
        run_dir = root / f"loader_{path}"
        run_dir.mkdir(parents=True)
        with synchronous_loader() if path == "synchronous" else contextlib.nullcontext():
            t0 = time.perf_counter()
            res = nft.train(cfg=cfg, tcfg=tcfg, loaders=train_loaders(), run_dir=str(run_dir),
                            logger=logging.getLogger(f"chip_smoke.loader_{path}"),
                            seed=TRAIN_SEED, img_size=IMG, device=MG_DEVICE)
            torch.cuda.synchronize()
        states[path] = res["state"]
        out[path] = {"bpd_by_step": mt_step_bpds(run_dir), "results": res["results"],
                     "seconds": time.perf_counter() - t0}
    gap, equal = state_gap(torch, states["producer"], states["synchronous"])
    out.update(state_max_gap=gap, state_bitwise_equal=equal)
    return out


def lm_loader(torch, counters, children: dict) -> dict:
    """(c) The batch assembly on the card host: the native library (it must
    be the path taken) against the numpy path bitwise on a CIFAR-shaped
    batch of 64 with flips, and each one's host ms; step wall ms of
    TRAIN_STEPS stage-1 steps fed through the synchronous path and through
    the producer thread, in turns, LM_LOADER_ROUNDS times (default mode,
    synchronised at the end of each epoch); the
    world-1 child's deterministic epochs on both paths, bitwise."""
    import numpy as np

    from nfdpm_tpu_torch.data import native
    from nfdpm_tpu_torch.data.pipeline import prefetch_to_device
    from nfdpm_tpu_torch.training import nf_trainer as nft

    check(native.available(), f"the card host took the numpy batch assembly: {native.failure()}")
    rng = np.random.default_rng(32)
    images = rng.integers(0, 256, (1024, IMG, IMG, 3), dtype=np.uint8)
    idx = rng.choice(len(images), BATCH, replace=False)
    flips = (rng.random(BATCH) < 0.5).astype(np.uint8)
    host_ms = {}  # the loader's thread count, every hardware thread, numpy
    for path, use, threads in (("native", True, None), ("native_every_hardware_thread", True, 0),
                               ("numpy", False, None)):
        walls = []
        for _ in range(LM_HOST_REPEATS):
            t0 = time.perf_counter()
            native.batch_gather_normalize(images, idx, flips, threads, native=use)
            walls.append((time.perf_counter() - t0) * 1e3)
        host_ms[path] = median_of(walls)
    host_ms["native_threads"] = native.default_threads(BATCH * IMG * IMG * 3 * 4)
    bitwise = np.array_equal(native.batch_gather_normalize(images, idx, flips, native=True),
                             native.batch_gather_normalize(images, idx, flips, native=False))

    # the step's wall ms fed by each path, from one ddinit'ed state
    cfg, tcfg = train_configs()
    tx = nft.optimizer_of(tcfg)
    loaders = train_loaders()
    state = nft.init_train_state(TRAIN_SEED, cfg, tcfg, tx, MG_DEVICE)
    state = nft.ddinit_train_state(state, cfg, tcfg, tx, mg_batches(torch, 1)[0],
                                   torch.Generator(device=MG_DEVICE).manual_seed(1))
    step = nft.make_train_step(cfg, tcfg, tx, device=MG_DEVICE)
    step_ms = {"synchronous": [], "producer": []}
    for _ in range(LM_LOADER_ROUNDS):  # the two paths in turns
        for path in step_ms:
            sync = path == "synchronous"
            with synchronous_loader() if sync else contextlib.nullcontext():
                batches = (synchronous_batches if sync else prefetch_to_device)(
                    loaders.train.iter_epoch(1), torch.device(MG_DEVICE))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for batch, _ in batches:
                    state, _ = step(state, batch, TRAIN_SEED)
                torch.cuda.synchronize()
            step_ms[path].append((time.perf_counter() - t0) * 1e3 / len(loaders.train))
    step_ms["median"] = {path: median_of(walls) for path, walls in step_ms.items()}
    det = children["world1"]["last_modules_loader"]
    rec = {"batch": [BATCH, IMG, IMG, 3], "host_ms_a_batch": host_ms,
           "native_equals_numpy_bitwise": bitwise, "step_wall_ms": step_ms,
           "steps": len(loaders.train), "deterministic_epochs": det}
    emit({"phase": "last_modules_loader_check", **rec})
    check(bitwise, "(c) the native batch assembly is not the numpy path's bitwise")
    check(det["native"], "(c) the world-1 child took the numpy batch assembly")
    check(len(det["producer"]["bpd_by_step"]) == TRAIN_STEPS
          and det["producer"]["bpd_by_step"] == det["synchronous"]["bpd_by_step"]
          and det["state_bitwise_equal"],
          f"(c) the producer thread's epoch is not the synchronous path's bitwise: state gap "
          f"{det['state_max_gap']}")
    return rec


def phase_last_modules(torch, np, counters, smi, stage1_dir: Path, children: dict) -> dict:
    """Phase 32 (see the module docstring); returns the launches of its
    path: (a)'s steps, (b)'s VLB passes, (c)'s timed steps and the world-1
    child's epochs."""
    from nfdpm_tpu_torch.models.nf_backbone import load_pretrained_flow

    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    backbone, flow = load_pretrained_flow(str(stage1_dir), 1, True, MG_DEVICE, True)
    record = {"phase": "last_modules", "card": smi,
              "a": lm_unet_options(torch, counters, backbone, flow),
              "b": lm_per_part_vlb(torch, counters, backbone, flow)}
    record["c"] = lm_loader(torch, counters, children)
    here = counts(counters)
    child = children["world1"]["last_modules_loader"]["launches"]
    launches = {k: here[k] + child[k] for k in here}
    seconds = time.perf_counter() - t0
    record.update({"seconds": seconds, "budget_s": LM_BUDGET_S,
                   "within_budget": seconds <= LM_BUDGET_S,
                   "launches": {"this_process": here, "world1_child": child,
                                "total": launches}})
    emit(record)
    return launches


# -- the children of phases 28-31 ----------------------------------------------------

MULTI_ROOT = ROOT / "build" / "chip_smoke" / "multi"
MULTI_DIRS = {28: "multi_gpu", 29: "model_axis", 30: "pipeline", 31: "spatial"}


def multi_dir(phase: int, root: Path = None) -> Path:
    """Phase `phase`'s directory of the children's files under `root`."""
    return (MULTI_ROOT if root is None else root) / MULTI_DIRS[phase]


def multi_parts() -> set:
    """The parts a child runs (MULTI_PARTS: "28", "29", "29a" (29 (a)
    alone), "30", "31", "32" (phase 32 (c)'s deterministic epochs),
    comma-separated)."""
    return set(os.environ.get("MULTI_PARTS", "28,29,30,31,32").split(","))


def child_part(torch, counters, fn, *args) -> None:
    """One part of a child of phases 28-31: its launch counts from 0 and
    read at its end (unless the part keeps its own), the device memory
    still allocated as it starts beside its record, which is printed."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    for f in counters:
        f.launches = 0
    allocated = torch.cuda.memory_allocated() if MG_DEVICE == "cuda" else 0
    record = fn(*args)
    record.setdefault("launches", counts(counters))
    record["allocated_at_start"] = allocated
    emit(record)


def child_world1(torch, root: Path, stage1_dir: Path) -> None:
    """The world-1 child of phases 28-31 (no launch, deterministic mode):
    the model axis's references first, phase 32 (c)'s deterministic epochs,
    then phase 28's part, whose world of one over NCCL stays up to the
    end."""
    counters = kernel_counters()
    set_deterministic(torch, True)
    os.environ["NFDPM_NO_TENSORBOARD"] = "1"
    parts = multi_parts()
    if parts & {"29", "29a", "30", "31"}:
        child_part(torch, counters, w1_model_axis, torch, counters, root, stage1_dir, parts)
    if "32" in parts:
        child_part(torch, counters, w1_loader_epochs, torch, counters, root / "last_modules")
    if "28" in parts:
        child_part(torch, counters, w1_multi_gpu, torch, counters, multi_dir(28, root),
                   stage1_dir)


def child_ranks2(torch, root: Path, stage1_dir: Path) -> None:
    """A rank of the two-rank child of phases 28-31 (gloo ranks sharing this
    card, or NCCL ranks on two cards; deterministic mode): one process group
    for its parts in turn, phase 28's data axis, then the model axis's
    (phases 29, 30, 31) under one ModelAxisSpy; each part makes its own mesh
    (run_baseline.main and run_diffusion_prior.main theirs) and counts its
    own launches."""
    from nfdpm_tpu_torch.parallel import distributed

    counters = kernel_counters()
    set_deterministic(torch, True)
    os.environ["NFDPM_NO_TENSORBOARD"] = "1"
    check(distributed.initialize(device=MG_DEVICE), "the two-rank child found no launch")
    parts = multi_parts()
    try:
        if "28" in parts:
            child_part(torch, counters, r2_multi_gpu, torch, counters, multi_dir(28, root),
                       stage1_dir)
        if parts & {"29", "29a", "30", "31"}:
            spy = ModelAxisSpy(torch, counters)
            try:
                if parts & {"29", "29a"}:
                    child_part(torch, counters, r2_model_axis, torch, spy, root, stage1_dir,
                               parts)
                if "30" in parts:
                    child_part(torch, counters, r2_pipeline, torch, spy, root)
                if "31" in parts:
                    child_part(torch, counters, r2_spatial, torch, spy, root)
            finally:
                spy.restore()
    finally:
        distributed.shutdown()


# the children of phases 28-31, by role (--multi-gpu-child <role> ...)
CHILD_ROLES = {"world1": child_world1, "ranks2": child_ranks2, "mt_mesh4": mt_mesh4}


def launch_children(stage1_dir: Path = None, root: Path = None,
                    parts=frozenset({"28", "29", "30", "31", "32"}),
                    backend: str = "gloo") -> dict:
    """The children of phases 28-32 (`parts`, multi_parts' names), their
    files under `root`, in at most three launch groups, in turn: the
    two-rank child over `backend` (its model-2 stage-2 run writes the
    states the world-1 child's same-state steps read), the world-1 child
    (also phase 32 (c)'s deterministic epochs), and with phase 29 the four
    gloo ranks of its (b). `stage1_dir` (phase 12's run, linked as
    outputs/stage1 in each phase's directory) may be None where no part
    reads it (29 (a) and 30). Their records:
    {"ranks2": [{phase: record} a rank], "world1": {phase: record},
    "mesh4": [record a rank]}."""
    root = MULTI_ROOT if root is None else root
    shutil.rmtree(root, ignore_errors=True)
    for phase in MULTI_DIRS:
        (multi_dir(phase, root) / "outputs").mkdir(parents=True)
        if stage1_dir is not None:
            (multi_dir(phase, root) / "outputs" / "stage1").symlink_to(stage1_dir)
    stage1_dir = root if stage1_dir is None else stage1_dir  # the children's argument
    base = dict(mt_env(), MULTI_PARTS=",".join(sorted(parts)))
    phases2 = [name for part, name in (("28", "multi_gpu_world2"), ("29", "model_axis_model2"),
                                       ("30", "pipeline_stage"), ("31", "spatial_model2"))
               if part in parts or (part == "29" and "29a" in parts)]
    phases1 = (["model_axis_world1"] if parts & {"29", "29a", "30", "31"} else []) + (
        ["last_modules_loader"] if "32" in parts else []) + (
        ["multi_gpu_world1"] if "28" in parts else [])
    ranks2 = (mg_children("ranks2", root, stage1_dir, mt_launch(base, 2, backend), 2, phases2)
              if phases2 else [])
    (world1,) = mg_children("world1", root, stage1_dir, dict(base, MG_PORT=str(free_port())), 1,
                            phases1)
    mesh4 = ([r["model_axis_mesh4"] for r in mg_children(
        "mt_mesh4", root, stage1_dir, mt_launch(base, 4, "gloo"), 4, ["model_axis_mesh4"])]
        if "29" in parts else [])
    for child in ranks2 + [world1]:
        RECORDS.extend(child.values())
    RECORDS.extend(mesh4)
    return {"ranks2": ranks2, "world1": world1, "mesh4": mesh4}


def run_child(torch, role: str, root: Path, stage1_dir: Path) -> None:
    """A child of phases 28-31: its first record says when it was ready to
    work (mg_children reads it), then its role runs."""
    print(json.dumps({"phase": "child_ready", "role": role, "unix_time": time.time()}),
          flush=True)
    restart_clock()  # a record's elapsed_s: the child's work so far
    CHILD_ROLES[role](torch, root, stage1_dir)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs "
              "one CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import nfdpm_tpu_torch as port
    from nfdpm_tpu_torch.models import glow as glow_m
    from nfdpm_tpu_torch.models import prior as prior_m
    from nfdpm_tpu_torch.ops.kernels import _build as build
    from nfdpm_tpu_torch.ops.kernels import channel_mix as cm
    from nfdpm_tpu_torch.ops.kernels import coupling_tail as ct
    from nfdpm_tpu_torch.ops.kernels import fused_linear_attention as fla
    from nfdpm_tpu_torch.ops.kernels import step_megakernel as sm
    from nfdpm_tpu_torch.ops import bijectors as bj

    import numpy as np

    counters = (cm.channel_mix, ct.coupling_tail, ct.coupling_tail_bwd,
                ct.coupling_tail_inverse, fla.fused_linear_attention,
                fla.fused_linear_attention_bwd, sm.step_megakernel_forward)
    if sys.argv[1:2] == ["--multi-gpu-child"] and len(sys.argv) == 5:
        # a child of phase 28, started by this script with its environment
        port.disable_tf32()
        run_child(torch, sys.argv[2], Path(sys.argv[3]), Path(sys.argv[4]))
        return 0
    if sys.argv[1:2] == ["--deterministic-resume"] and len(sys.argv) == 3:
        # phase 23's subprocess, started by this script with its environment
        port.disable_tf32()
        deterministic_resume(torch, counters, Path(sys.argv[2]))
        return 0
    smi = timed("environment", phase_environment, torch, port)
    # phase 22 (b)'s commands use the card while nvcc runs on the host
    stats_commands = StatsCommands() if not sys.argv[1:] else None
    timed("build", phase_build, build)
    if sys.argv[1:] == ["--stage1-training"]:
        timed("training", phase_training, torch, counters)
        emit_phase_seconds()
        return 0
    if sys.argv[1:] == ["--run-dir-tools"]:
        _, stage1_run, _, _ = timed("training", phase_training, torch, counters)
        _, stage2_run, _ = timed("stage2_training", phase_stage2_training, torch, counters,
                                 stage1_run)
        torch.cuda.empty_cache()
        _, ema_run = timed("mid_epoch_resume", phase_mid_epoch_resume, torch, counters, smi)
        _, served = timed("run_dir_serving", phase_run_dir_serving, torch, np, counters, smi,
                          stage1_run, stage2_run, ema_run)
        timed("cli", phase_cli, np, smi, stage1_run, stage2_run, served)
        emit_phase_seconds()
        return 0
    if sys.argv[1:] == ["--reference-checkpoints"]:
        _, stage1_run, _, _ = timed("training", phase_training, torch, counters)
        _, stage2_run, _ = timed("stage2_training", phase_stage2_training, torch, counters,
                                 stage1_run)
        torch.cuda.empty_cache()
        timed("reference_checkpoints", phase_reference_checkpoints, torch, np, counters, smi,
              stage1_run, stage2_run)
        emit_phase_seconds()
        return 0
    if sys.argv[1:] == ["--mixed-precision"]:
        _, stage1_run, _, _ = timed("training", phase_training, torch, counters)
        timed("stage2_training", phase_stage2_training, torch, counters, stage1_run)
        torch.cuda.empty_cache()
        timed("mixed_precision", phase_mixed_precision, torch, np, counters, smi, stage1_run)
        emit_phase_seconds()
        return 0
    flags = {"--multi-gpu": ({"28"}, True), "--model-axis": ({"29"}, True),
             "--pipeline": ({"30"}, False), "--spatial": ({"31"}, False)}
    if sys.argv[1:2] and sys.argv[1] in flags and len(sys.argv) == 2:
        parts, stage2 = flags[sys.argv[1]]
        _, stage1_run, _, _ = timed("training", phase_training, torch, counters)
        if stage2:
            timed("stage2_training", phase_stage2_training, torch, counters, stage1_run)
        torch.cuda.empty_cache()
        children = timed("multi_children", launch_children, stage1_run, parts=parts)
        if "28" in parts:
            timed("multi_gpu", phase_multi_gpu, torch, np, counters, smi, stage1_run, children)
        if "29" in parts:
            timed("model_axis", phase_model_axis, torch, np, counters, smi, children)
        if "30" in parts:
            timed("pipeline", phase_pipeline, torch, np, counters, smi, children)
        if "31" in parts:
            timed("spatial", phase_spatial, torch, np, counters, smi, children)
        emit_phase_seconds()
        return 0
    if sys.argv[1:] == ["--last-modules"]:
        _, stage1_run, _, _ = timed("training", phase_training, torch, counters)
        torch.cuda.empty_cache()
        children = timed("multi_children", launch_children, stage1_run, parts={"32"})
        timed("last_modules", phase_last_modules, torch, np, counters, smi, stage1_run,
              children)
        emit_phase_seconds()
        return 0
    if sys.argv[1:] == ["--model-axis-nccl"]:
        timed("model_axis_nccl", phase_model_axis_nccl, torch, np, counters, smi)
        emit_phase_seconds()
        return 0
    if sys.argv[1:] == ["--attention-backward"]:
        totals = {}
        timed("attention_backward", phase_attention_backward, torch, fla,
              attention_shapes(torch, stage2_prior(), torch.device("cuda")), totals)
        emit_phase_seconds()
        return 0
    if sys.argv[1:]:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]}", file=sys.stderr)
        return 2
    totals = timed("kernels", phase_kernels, torch, cm, ct)

    device = torch.device("cuda")
    cfg = glow_m.GlowConfig(levels=LEVELS, steps=STEPS, coupling_width=WIDTH)
    params = {"flow": glow_m.init_glow(0, cfg, device),
              "prior": prior_m.init_gaussian_prior(glow_m.final_channels(cfg), True, device)}
    randomize_zero_leaves(torch, params, seed=1)
    unet_shapes = attention_shapes(torch, stage2_prior(), device)
    totals["fused_linear_attention"] = timed("attention_kernel", phase_attention_kernel,
                                             torch, fla, unet_shapes)
    timed("host_steps", phase_wrapper_host_steps, torch, cm, ct, fla, build)
    timed("tail_route", phase_tail_route, torch)

    launches = {"glow": timed("glow", glow_path, torch, np, params, counters)}
    totals["step_megakernel"] = timed("megakernel", phase_megakernel, torch, sm, bj)
    launches["megakernel_glow"] = timed("megakernel_glow", phase_megakernel_glow, torch, np,
                                        params, counters)
    launches["stage2"], model = timed("stage2", stage2_path, torch, np, params["flow"],
                                      counters)
    timed("profile", phase_profile, torch, model, fla, unet_shapes)
    del model, params
    torch.cuda.empty_cache()

    timed("backward_kernels", phase_backward_kernels, torch, cm, ct, totals)
    timed("attention_backward", phase_attention_backward, torch, fla, unet_shapes, totals)
    launches["training"], run_dir, out, loaders = timed("training", phase_training, torch,
                                                        counters)
    timed("training_routes", phase_training_routes, torch, loaders, counters)
    timed("resume", phase_resume, torch, run_dir, out, loaders)
    del out, loaders
    torch.cuda.empty_cache()

    launches["stage2_training"], stage2_run, stage1_run = timed(
        "stage2_training", phase_stage2_training, torch, counters, run_dir)
    timed("stage2_routes", phase_stage2_routes, torch, counters, stage2_run, stage1_run)
    launches["stage2_cotraining"] = timed("stage2_cotraining", phase_stage2_cotraining, torch,
                                          counters, stage1_run)
    torch.cuda.empty_cache()
    launches["sample_metrics_stage1"], launches["sample_metrics_stage2"] = timed(
        "sample_metrics", phase_sample_metrics, torch, np, counters, smi, stage1_run,
        stage2_run, stats_commands)
    torch.cuda.empty_cache()
    launches["mid_epoch_resume"], ema_run = timed("mid_epoch_resume", phase_mid_epoch_resume,
                                                  torch, counters, smi)
    launches["run_dir_serving"], served = timed(
        "run_dir_serving", phase_run_dir_serving, torch, np, counters, smi, stage1_run,
        stage2_run, ema_run)
    timed("cli", phase_cli, np, smi, stage1_run, stage2_run, served)
    launches["reference_checkpoints"] = timed(
        "reference_checkpoints", phase_reference_checkpoints, torch, np, counters, smi,
        stage1_run, stage2_run)
    torch.cuda.empty_cache()
    launches["mixed_precision"] = timed("mixed_precision", phase_mixed_precision, torch, np,
                                        counters, smi, stage1_run)
    torch.cuda.empty_cache()
    # phases 28-31: their children in three launch groups, then each phase's gates
    children = timed("multi_children", launch_children, stage1_run)
    launches["multi_gpu"] = timed("multi_gpu", phase_multi_gpu, torch, np, counters, smi,
                                  stage1_run, children)
    torch.cuda.empty_cache()
    launches["model_axis"] = timed("model_axis", phase_model_axis, torch, np, counters, smi,
                                   children)
    launches["pipeline"] = timed("pipeline", phase_pipeline, torch, np, counters, smi, children)
    launches["spatial"], launches["spatial_world1_reference"] = timed(
        "spatial", phase_spatial, torch, np, counters, smi, children)
    torch.cuda.empty_cache()
    launches["last_modules"] = timed("last_modules", phase_last_modules, torch, np, counters,
                                     smi, stage1_run, children)
    del children
    torch.cuda.empty_cache()

    per = {"fused_linear_attention": "one UNet evaluation of each of the three parts at "
                                     "batch 64 (one DDIM step or one stage-2 train "
                                     "step): 12 launches",
           "fused_linear_attention_bwd": "the backward of one stage-2 train step at batch "
                                         "64: 12 launches"}
    sources = {"channel_mix": ("flow_kernels.cu", "nfdpm_tpu/ops/pallas/channel_mix.py:70"),
               "coupling_tail": ("flow_kernels.cu", "nfdpm_tpu/ops/pallas/coupling_tail.py:75"),
               "coupling_tail_inverse": ("flow_kernels.cu",
                                         "nfdpm_tpu/ops/pallas/coupling_tail.py:127"),
               # the VJP of coupling_tail, which the JAX package leaves to XLA
               "coupling_tail_bwd": ("flow_kernels.cu",
                                     "nfdpm_tpu/ops/pallas/coupling_tail.py:148"),
               "fused_linear_attention": (
                   "linear_attention.cu", "nfdpm_tpu/ops/pallas/fused_linear_attention.py:164"),
               # the custom VJP's backward, which the JAX package leaves to XLA
               "fused_linear_attention_bwd": (
                   "linear_attention.cu", "nfdpm_tpu/ops/pallas/fused_linear_attention.py:192"),
               "step_megakernel": ("step_megakernel.cu",
                                   "nfdpm_tpu/ops/pallas/step_megakernel.py:135")}
    counter_of = {"step_megakernel": "step_megakernel_forward"}
    kernels = []
    for name, tot in totals.items():
        by_path = {path: n[counter_of.get(name, name)] for path, n in launches.items()}
        source, replaces = sources[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"nfdpm_tpu_torch/ops/kernels/csrc/{source}", "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": tot["max_abs_err"], "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"], "bound_by": tot["bound_by"],
            "library_ms": tot["library_ms"], "device_ms": tot["device_ms"],
            "plain_device_ms": tot["plain_device_ms"],
            "library_device_ms": tot["library_device_ms"],
            "per": per.get(name, "one pass: 4 launches at each of the 3 level shapes"),
            **{k: v for k, v in tot.items()
               if k.startswith(("dx_", "route_", "step_", "pack_"))
               or k in ("max_gradient_gap", "max_abs_gap_by_gradient", "tensor_core_bound_ms",
                        *BWD_MEASURED)}})
    order = ["channel_mix", "coupling_tail", "coupling_tail_bwd", "coupling_tail_inverse",
             "fused_linear_attention", "fused_linear_attention_bwd", "step_megakernel"]
    kernels.sort(key=lambda k: order.index(k["name"]))
    summary = {"kernels": kernels}
    emit_phase_seconds()
    RECORDS.append(summary)
    print(json.dumps(summary), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    finally:  # what the phases recorded, also when one of them failed
        for proc in PROCESSES:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if RECORDS:
            out = ROOT / "chiprun_out" / "chip_smoke.json"
            out.parent.mkdir(exist_ok=True)
            out.write_text(json.dumps(RECORDS, indent=1))
