#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (vision_ft_tpu_torch) on one GPU.

    python3 chip_smoke.py [--profile] [--kernel-d] [--kernel-i] [--trace-kernels]
                          [--ln-probe-costs] [--lumina-trainer] [--auraflow]
                          [--auraflow-trainer] [--serve] [--flux] [--cogview4] [--wan]
                          [--sdxl-adapters] [--remainder] [--fractal] [--wait-for-go]

With --profile, phases 6 and 8 also trace two train steps with
torch.profiler (device activity only) and print the device time of a step
by kind of kernel and the share of an untraced step in which the card is
idle, phase 8 the host's cost of one Linear call, dense and on each NF4
route, phase 4 the same breakdown of the warm SDXL request (c) (kernel B's
device ms on its own line), phase 12 of one Lumina2 denoise step and phase
14 of one Lumina2 train step (kernel G's and E's device ms on their own
lines), phase 16 of the 1024 px request with the short-K kernels (kernel
H's device ms on its own line). With --kernel-d, only phases 0, 7 and the
build of kernel D's library run (no ok line); with --kernel-i, only phases
0, 15 (with the --trace-kernels process) and the build of kernels H's and
I's library (no ok line). With --trace-kernels, only phase 0 and the
traces of phases 3, 15 and 18 run: 10 calls each of kernels H, J and K, of
I at SHORTK_SHAPES, of A at LN_SHAPES, of L's three timed cases and of
each one's library call (SDPA's backward alone beside I) under
torch.profiler, printed as one JSON line (no ok line); phase 3 runs it so,
in a process of its own, and phases 3, 15 and 18 print it.
With --ln-probe-costs, only phase 0 runs and then, for kernel A at
LN_SHAPES and kernel L's three timed cases and each one's library call,
one call, a call over 10 back to back, the host's microseconds a call and
the traced card time a call, printed as one JSON line (no ok line): the
same measurement for any checkout whose wrappers take these calls, so a
copy of this script in an older checkout times that checkout's kernels.
With --lumina-trainer, only phases 0 and 19 and the build of kernels E's,
F's and G's libraries run, printing the phase's launch counts and numbers
as one JSON line (no ok line); phase 19 runs it so, in a process of its own.
With --auraflow, only phases 0, 20 and 21 and the build of kernels B's and
F's libraries run, printing their launch counts, kernel records and numbers
as one JSON line (no ok line); the main run runs it so, in a process of its
own, after phase 19 (with --profile, phase 21 also traces one denoise step).
With --auraflow-trainer, only phases 0 and 22-24 and the build of kernels
B's, C's and F's libraries run, printing the Trainer runs' launch counts,
kernel C's records and the numbers as one JSON line (no ok line); the main
run runs it so, in a process of its own, after phases 20-21. With --serve,
only phases 0 and 25-27 and the build of kernels A's, B's, D's, E's and F's
libraries run, printing the served paths' launch counts, the kernels'
records at the pool's shapes and the numbers as one JSON line (no ok line);
the main run runs it so, in a process of its own, after phases 22-24. With
--flux, only phases 0 and 28-30 and the build of kernels A's and B's
libraries run, printing the Flux paths' launch counts, kernel B's records at
Flux's shapes and the numbers as one JSON line (no ok line); the main run
runs it so, in a process of its own, after phases 25-27 (with --profile,
phase 29 also traces one CFG denoise step). With --cogview4, only phases 0
and 31-33 and the build of kernels B's, C's and D's libraries run, printing
the CogView4 paths' launch counts, kernels B's and C's records at
CogView4's shapes and the numbers as one JSON line (no ok line); the main
run runs it so, in a process of its own, after phases 28-30 (with
--profile, phase 32 also traces one CFG denoise step). With --wan, only
phases 0 and 34-36 and the build of kernels A's, B's and D's libraries run,
printing the Wan paths' launch counts, kernels B's, A's and D's records at
Wan's shapes and the numbers as one JSON line (no ok line); the main run
runs it so, in a process of its own, after phases 31-33 (with --profile,
phase 35 also traces one CFG denoise step and one VAE decode). With
--remainder, only phases 0 and 43-45 run, on a seeded SDXL file of their
own, after the build of kernels A's, B's, C's and D's libraries (one JSON
line, no ok line); the main run runs it so, in a process of its own, after
phases 37-42. With --fractal, only phases 0 and 46 and the build of kernels
A's and E's libraries run (one JSON line, no ok line); the main run runs it
so, in a process of its own, after phases 43-45. The main run starts each
of these processes (and phase 3's tracing one) ahead of its turn with
--wait-for-go: it imports while the phases before it run, then waits for
a line on its stdin before it touches the card. Each phase's header gives
the seconds since its process started, or since its turn came.

Phases, each printing its own lines; any failure exits non-zero:

0. device: needs torch.cuda; prints the card's name and power limit and
   sets fp32 matmuls and convolutions to full fp32 (no TF32).
1. build: compiles the CUDA kernels with nvcc (sm_90a, one nvcc per source,
   started together), from the sources in this checkout.
2. kernel B, BSHD flash attention forward, against its plain PyTorch
   version in bf16 at the SDXL self-attention shapes of the requests
   (aligned and ragged, batch 2) and of the train step (batch 4); reruns
   bit-identical; TFLOP/s, share of the bound, the time a call over 10
   calls back to back and the ratio to SDPA beside each time.
3. kernel A, fused LayerNorm, the same way at LN_SHAPES and at the edge
   shapes (C = 8192, C = 136, one row); beside each time the host's
   microseconds a call (the card held busy, so the calls only queue) and
   the traced card time a call (the --trace-kernels process), each also
   for F.layer_norm.
4. SDXL generate() at full width (default DenoiserConfig, SDXL CLIP and
   VAE configs, bf16, seeded random weights made on the card, a small
   synthetic CLIP vocab): three requests, then checks of the outputs and
   of the kernels' launch counts against the module tree.
5. kernel C, the BSHD flash attention backward (a dk/dv kernel and a dq
   kernel), against the plain backward at the train step's shapes; the
   forward's lse, which the backward reads, against the plain one too.
6. SDXL LoRA train steps at full width on the same model: rank-16 LoRA on
   the attention and feed-forward layers, gradient checkpointing, AdamW
   with global-norm clipping, batch 4 at 1024 px with cached latents and
   text. Checks the metrics, the adapters, the frozen base, the launch
   counts of both checkpointing modes, a second seeded run, and one step
   against the same step with the kernels' plain versions swapped in.

7. kernel D, the packed 4-bit (NF4 / FP4) matmul: its forward and its dx
   kernel against their plain versions at the SDXL layers' shapes, in the
   split and the bnb byte layout, with real codes of seeded weights; each
   reruns bit-identical; TFLOP/s and the ratio to cuBLAS on a dequantized
   bf16 weight beside each time, and the time a call over 10 calls back to
   back (the host's launch cost hidden) beside cuBLAS's.
8. SDXL NF4 QLoRA: the same denoiser, its 700 attention and feed-forward
   Linears quantized to NF4 on the card, then LoRA train steps as in phase
   6 on the "fused" route (the kernels), with the checks of phase 6 and
   the quantized leaves bit-identical afterwards; then the same steps on
   the "stream" and "dequant" routes, timed.
9. one 1024 px CFG request through generate() with the NF4 denoiser.

10. kernel E, the key-masked flash attention forward over (B, H, S, D),
    against its plain version (out and lse) at the Lumina2 shapes: 24 heads
    over 8 kv heads, head dim 96, joint length 4352 with the caption hole
    masked, the refiners' 4096 (all-ones mask) and 256, no mask, causal,
    ragged lengths, head dims 64 and 128; reruns bit-identical, TFLOP/s,
    share of the bound, the time a call over 10 back to back beside SDPA's;
    a batch entry that keeps no key (the mean of v) beside one whose key
    tiles masked whole the kernel skips.
11. kernel F, the fused gated MLP, and its two kernels alone, F-up (the
    up-projections with the gate in the epilogue) and F-down (the
    down-projection, split over inner at few rows) on F-up's own output,
    each against its plain version, reruns bit-identical, beside two
    F.linear + gate, one F.linear and three F.linear + gate, at the
    NextDiT's (rows, 2304, 9216) SwiGLU shapes, a ragged row count, biases
    with both gelus, C = 4096 at 64 rows, and SDXL's GeGLU (16384, 640,
    2560).
12. Lumina2 generate() at full width, 8 of the NextDiT's 26 main layers
    (LUMINA_CUT_DEPTH; full depth before phases 43-46 joined the run; Gemma-2-2B,
    the 16-channel VAE; bf16, seeded random weights made on the card, a
    synthetic SentencePiece vocab): a 1024 px CFG request cold and warm
    (bit-identical), two prompts of different lengths at 832x1216, a request
    with CFG truncation, one with DeepCache, the warm request again with
    the fused feed-forward switched off (set_fused_ff("off")); launch
    counts of kernels E and F against the module tree; a depth-reduced
    request with the kernels against the same request on their plain
    versions.
13. kernel G, the key-masked flash attention backward (a dk/dv kernel that
    sums over the query heads of each kv head, and a dq kernel), against the
    plain backward at the Lumina2 train step's shapes (batch 4: the main
    stack's 4352 with the caption hole, the noise refiner's 4096, the
    context refiner's 256, the low-res main stack's 512), causal, head dims
    64 and 128, Sq != Sk; reruns bit-identical; each kernel's TFLOP/s and
    share of its bound, and the whole backward against SDPA's backward.
14. Lumina2 LoRA train steps at full width on the same model (8 of the 26
    main layers, full depth before phases 43-46 joined the run): rank-16
    LoRA on qkv, out, w1, w2, w3, gradient checkpointing, AdamW with
    clipping, batch 4 of 1024 px images and four captions of different
    lengths through the whole loss_fn (Gemma-2 and VAE encode every step,
    uniform timesteps, the low-res loss). Checks the losses, the launch
    counts in both checkpointing modes, the adapters, the frozen base, a
    second seeded run, gradients bit-identical across remat modes and
    groups, and a depth-reduced step against the plain versions; first, one
    step with LoRA on the attention only, where kernel F runs forward, with
    its launch counts, then the same step warm with the fused feed-forward
    "auto" and "off".

15. kernels H and I, the short-K attention forward and its backward (SDXL's
    cross-attention, the whole 77- to 192-key context on chip), against
    their plain versions at the requests', the ragged buckets' and the
    train step's shapes (77 and 152 keys), at 192 keys, head dim 128 and
    with a batch entry of zero q rows; reruns bit-identical; SDPA's forward
    and backward beside them, H's and SDPA's time a call over 10 calls back
    to back, H's TFLOP/s and GB/s and its share of the bound; I's one call,
    a call over 10 back to back, the host's microseconds a call and the
    traced card time a call, each beside SDPA's backward alone, and their
    shares of I's bound.
16. SDXL requests with the switches on, the SDXL model made again on the
    card: the 1024 px request with set_flash_shortk(True) (kernel H in
    every cross-attention) and with set_fused_ff("on") (kernel F in every
    feed-forward), each against the default route's latents, with launch
    counts.
17. the Trainer path at full SDXL width: a seeded bf16 checkpoint written
    with the port's state_dict() to safetensors, 8 seeded images in two
    buckets, configs/sdxl/text_to_image_lora.yml with 75-token prompts,
    batch 2, one epoch, a 1-prompt preview, through the train script's
    registrations with the short-K kernels on (cached latents and text,
    schedule-free RAdam, LoRA on attn1/attn2/ff). Checks the losses, the
    frozen base against the file, the adapters, the saved LoRA file's keys,
    the preview image, the launch counts of a step in both checkpointing
    modes, and one step's loss against the same step with the kernels off.
18. kernels J, K and L, which no model path calls (as in the JAX package),
    through their own entry points: J, the fused GroupNorm(+SiLU), and K,
    the 3x3 conv, against their plain versions at the SDXL UNet's widths
    (1024 px, batch 2 and 4, the up-block concat; K also at the 832x1216
    bucket's ragged widths, on its split path at the 32 x 32 stages, and at
    C = 16 and 48) and the VAE decoder's (1024 px), with F.group_norm
    (+ F.silu) and cuDNN beside them; their gradients
    through the autograd.Functions against autograd of the plain forward and
    of F.conv2d; one SDXL resnet body (GN + SiLU -> conv -> GN + SiLU -> conv
    + residual, forward and backward) through the ops, with the launch
    counts of that path and of the probe's cases, against the same path on
    the plain versions and against nn.core's modules; J's launches a call
    (one); 10 calls each of H, J and K and of SDPA and F.group_norm +
    F.silu traced by torch.profiler in a process of its own (the card's
    time a call by kernel; each kernel must show one launch a call); then
    L, the
    ragged-tile probe, as a user runs it (its own process, `partial_blocks:
    true`, with its TMA case: the 128-byte swizzled tensor maps kernel F
    reads and writes through), and its three kernels timed against
    Tensor.copy_ and torch.add as kernel A is in phase 3. Every model path
    above launches J, K and L 0 times.
19. the Lumina2 Trainer path at full width, in a process of its own
    (--lumina-trainer): a seeded full-width Lumina2 with 8 of the NextDiT's
    26 layers (LUMINA_CUT_DEPTH; full depth, a 10.6 GB file, before the Wan
    phases joined the run) written by state_dict() to a safetensors file, 8 seeded images
    (1024x1024 and 832x1216, which config #4's buckets crop to 768x1152)
    with captions of different lengths, configs/lumina2/text_to_image.yml
    cut to one epoch of 4 steps at batch 2, with EMA (decay 0.999), state
    checkpoints every 2 steps and a profiler window over steps 2-3, and a
    1024 px 8-step CFG preview, all through the train script's
    build_trainer. Checks the losses (high-res and low-res), the launch
    counts of kernels E and G a step against the module tree and the
    dispatch gate in both checkpointing modes, the frozen base against the
    file, the adapters, the saved LoRA file (the EMA in bf16 under ComfyUI
    keys), the EMA against the live weights, step_2 and step_4, a second
    Trainer's resume (trainable, optimizer state, EMA bit-identical), the
    profiler trace's kernels and a depth-reduced step against the plain
    versions; prints ms/step, peak GiB, the checkpoint's and the state
    checkpoint's bytes and seconds and the preview's seconds.
20. kernel B at head dim 256 (two passes over O's columns) and kernel F at
    C = 3072, AuraFlow's shapes, in a process of its own (--auraflow): B at
    the 1024 px request's joint sequence (4360 tokens, with and without CFG),
    an aligned 4096 and a ragged Sq 1000 / Sk 1300, out and lse against the
    plain version, reruns bit-identical, one call and a call over 10 back to
    back beside SDPA's, TFLOP/s and the bound; each instantiation's tiles,
    stages, passes and shared memory; F, F-up and F-down at the single
    layers' 8720 rows and the double layers' 8192 and 528, as in phase 11.
21. AuraFlow generate() at full width in the same process (the default
    MMDiT cut to 4 double + 8 of its 32 single layers (AURA_CUT_DEPTH; full
    depth before phases 43-46), 3072 wide, 12 heads of 256;
    the default UMT5; the SDXL VAE; bf16, seeded random weights made on the
    card, the zero-init leaves drawn anew; the synthetic SentencePiece vocab
    with the T5 template): three 1024 px CFG requests of 8 steps (the third
    the first again, bit-identical), one with deep_cache_interval=2, one with
    set_fused_ff("off"); launch counts of kernels B and F against the module
    tree; one denoise step against the same step on the plain versions;
    the single-file checkpoint at full width and reduced depth written by
    state_dict() and read by from_original_checkpoint, bit-identical.
22. kernel C at head dim 256 (the consumer warpgroups split D's output
    columns), in a process of its own (--auraflow-trainer): ptxas's
    registers and spills of both D = 256 kernels; at the config-#3 step's
    joint sequence (4360 tokens, batch 1), the shortcut step's batch 2, the
    832x1216 bucket's 4216, ragged Sq 300 / Sk 520, 129 rows, one q row and
    strided q, k and v views: dq, dk and dv against the plain backward, one
    launch of each kernel a call, reruns bit-identical; each kernel's one
    call and a call over 10 back to back, TFLOP/s and bound, the whole
    backward beside SDPA's backward alone.
23. the AuraFlow Trainer in the same process: phase 21's model (4 + 8
    layers; 32 + 4 and a 16.5 GB file before phases 43-46), seeded (zero-init
    leaves drawn anew), written by state_dict() to a single-file
    checkpoint; configs/auraflow/text_to_image_lora.yml
    (config #3: batch 1, LoRA rank 8 on attn., .mlp., modC., modX.,
    schedule-free RAdam, gradient checkpointing, buckets from 1024 at step
    128) cut to one epoch over 4 seeded images (three 1024x1024, one
    832x1216), the 1024 px 20-step CFG preview of configs/auraflow/
    preview.yml, all through the train script's build_trainer. Checks the
    losses, kernel B's and C's launches a step and the preview's against
    the layer count, the frozen base against the file, the adapters, the
    saved LoRA file's ComfyUI keys, a step with remat saves "none", and a
    depth-reduced step (1 double + 2 single layers, full width) against the
    plain versions; prints ms/step (warm), peak GiB, the checkpoint's bytes,
    write and load seconds and the preview's seconds.
24. from the same file: the shortcut workload on configs/auraflow/
    shortcut.yml (batch 2, AdamW, the shortcut embedder trainable under
    LoRA; two target forwards without gradients a step) for 2 steps, and the
    RoPE migration workload on text_to_image_lora.yml with use_rope and the
    workload's fields for 3 steps; launch counts a step, the embedder and
    the migration scale moved off zero, the base unchanged; ms a step, peak
    GiB.
25. serving SDXL, in a process of its own (--serve): kernels B and A
    against their plain versions at a 4-slot pool's batch-8 UNet shapes;
    a seeded full-width SDXL written to a single-file checkpoint, served by
    the port's T2IModel from a YAML that names it, on 127.0.0.1 at an
    ephemeral port, driven through the port's client. Window scheduler: 4
    concurrent compatible 1024 px requests make one generate() of batch 4,
    an 832x1216 one its own; a 6-request staggered trace (4 and 6 steps,
    seeds, guidance, one cfg_rescale); a 1536 px request through the tiled
    VAE decode. Continuous scheduler (4 slots at 1024 px): the same trace,
    each result's latents against the same request through batch-1
    generate() (POOL_REQUEST_TOL), kernels B and A launched 70 and 210
    times a tick, the card's ms a tick. DeepCache at interval 2 against 1
    (kernel B 280 against 560 launches). The CLI on the checkpoint with
    --quant-type bnb_nf4: kernel D's forward launches against the UNet's
    Linears it takes. Each reply a webp of the asked size.
26. serving Lumina2 (config #4) in the same process: kernels E and F
    against plain at the pool's batch 8; a seeded checkpoint at full width
    with 8 of the NextDiT's 26 layers (LUMINA_CUT_DEPTH); a continuous
    pool of 4 slots at 1024 px, 4 concurrent 8-step requests (one truncated
    at 0.5, renorm 0 and 2.0 beside 1.0), each against batch-1 generate();
    E and F 12 launches a tick (30 at full depth).
27. serving AuraFlow (config #3) in the same process: kernels B at head
    dim 256 and F against plain at the pool's batch 8; a seeded checkpoint
    at full width with the 4 double and 8 of the 32 single layers
    (AURA_CUT_DEPTH); a continuous pool of 4 slots at 1024 px, 3
    concurrent 8-step requests (one at cfg_scale 1), each against batch-1
    generate(); B 12 and F 16 launches a tick (36 and 40 at full depth).
28. kernel B at head dim 128, Flux's shapes, in a process of its own
    (--flux): the 1024 px request's joint sequence (512 T5 tokens + 4096
    patches = 4608), under CFG (batch 2), a pool of 4 slots (batch 8),
    768 px (2816), the ragged 832x1216 bucket (4464) and 300 keys (past the
    256-key gate); out and lse against the plain version, reruns
    bit-identical, one call and a call over 10 back to back beside SDPA's,
    TFLOP/s and the bound; forward_config(128).
29. FluxModel.generate() on flux1-dev at full width in the same process
    (4 of the 19 double and 8 of the 38 single blocks, FLUX_CUT_DEPTH; full
    depth before phases 43-46; hidden 3072, 24 heads of 128,
    use_flash_attention: true; T5-XXL, CLIP-L and the 16-channel VAE; bf16
    seeded random weights made on the card; the synthetic SentencePiece
    vocab with the T5 template and a CLIP BPE vocab): 1024 px requests of
    8 steps at distilled guidance 3.5 (cold, another prompt, the first
    again bit-identical, CFG 2 with a negative prompt, deep_cache_interval
    2), one with every block's attention on the plain formula (the
    use_flash_attention: false route) held to the kernel route's latents
    (FLUX_ROUTE_TOL); kernel B's launches (12 a step, fewer on a cached
    step) and A's (CLIP-L's 25 LayerNorms a prompt encoding) against the
    module tree; one CFG denoise step against the plain version; seconds a
    request and peak GiB; flux1-schnell and flex1-alpha at full width, 1
    double + 2 single blocks, 4 steps against the plain versions.
30. in the same process: the single-file checkpoint at full width and
    reduced depth (1 double + 2 single blocks, 2 T5 layers) written by
    state_dict() in the original and in ComfyUI keys and read by
    from_checkpoint, bit-identical; the server on a YAML naming it (the
    model built at the file's depth; the CLIP tokenizer from the vocab
    dir's clip/ subfolder): the window scheduler (2 compatible requests, one
    generate() of batch 2) and a continuous pool of 4 slots at 1024 px (4
    staggered requests of 4 and 8 steps, distilled guidance 0, 2.5 and 3.5,
    one with CFG 2), each result against batch-1 generate()
    (POOL_REQUEST_TOL), kernel B 3 launches a tick; the CLI on --family
    flux; the AuraFlow VAE-encode migration through the port's Trainer for
    3 steps on seeded 1024 px images (both VAEs at full width): finite
    losses, only migration_scale moved, the saved ComfyUI keys.
31. kernels B and C at head dim 128, CogView4's shapes, in a process of
    its own (--cogview4): B at the 1024 px joint sequence (16 caption
    tokens + 4096 patches = 4112, not a multiple of 64) under CFG (batch
    2), a pool of 4 slots (batch 8), 768 px (2320) and a 48-token caption
    (4144), as in phase 28; C at the Trainer step's (2, 4112) and at batch
    1 and on strided views, as in phase 22 (each kernel one launch, reruns
    bit-identical, one call and 10 back to back, TFLOP/s, the bounds, the
    whole backward with the plain delta beside SDPA's backward alone), and
    ptxas's registers and spill bytes of C's D 128 instance.
32. CogView4Model.generate() at full width in the same process (8 of the
    DiT's 28 blocks, COGVIEW4_CUT_DEPTH, full depth before phases 43-46
    joined the run; 4096 wide,
    32 heads of 128; GLM-4 whole, 40 layers; the
    16-channel VAE; bf16 seeded random weights made on the card; the
    synthetic SentencePiece vocab with GLM's template): 1024 px requests of
    8 steps at CFG 3.5 (cold, another prompt, the first again
    bit-identical, deep_cache_interval 2); two plain and three offloaded
    requests (the first parks the parts; offloaded_requests), their seconds
    and peaks, latents bit-identical; kernel B's launches (8 a step, 2 on a
    cached step) against the module tree; one CFG denoise step
    against the plain version; seconds a request and peak GiB; a pool of 4
    slots through the server's continuous scheduler (4 staggered requests
    of 4 and 8 steps, CFG 3.5, 5 and 1), each result against batch-1
    generate() (POOL_REQUEST_TOL), kernel B 8 launches a tick.
33. in the same process, at full width and reduced depth (2 blocks, 2 GLM
    layers): the single-file checkpoint written by state_dict() and read by
    from_checkpoint, bit-identical; the server on a YAML naming it (window
    and continuous schedulers); the CLI with --quant-type bnb_nf4 (kernel
    D's launches on every denoiser Linear it takes); the quant-compare tool
    with GLM's and the DiT's groups in NF4 (D's launches). Then the Trainer
    on configs/cogview4/text_to_image.yml at full width, 8 DiT blocks, from
    seeded weights: one epoch of 8 seeded 1024 px images at batch 2 (LoRA
    rank 8 on attn / ff, AdamW, checkpointing), launches of B and of C's
    two kernels a step (8 each), a 4-step preview, warm steps, the saved
    LoRA's keys, bytes and write / load seconds, and a depth-reduced step
    against the plain versions.
34. kernels B, A and D at Wan 2.2's shapes, in a process of its own
    (--wan): B at 24 heads of 128 over the video tokens of a 704 px,
    49-frame request (12 x 22 x 22 = 5808, past a multiple of 128) under CFG
    and at the window's batch 4, self-attention and cross-attention to the
    512 text positions, and at the published 720p setting's 26,400 tokens
    (its plain version 2 heads at a time); A without beta at UMT5's C 4096
    over the prompt encoding's rows and over 2 x 512; D at the DiT's Linears
    (each one launch, reruns bit-identical, one call and 10 back to back
    beside SDPA's forward, F.layer_norm or cuBLAS, TFLOP/s, the bounds).
35. Wan22.generate() at full width in the same process (8 of the DiT's 30
    blocks, WAN_CUT_LAYERS, full depth before phases 43-46 joined the run;
    3072 wide; UMT5 with 24
    layers, dim 4096, vocab 256384; the
    causal 3-D VAE at its default config in fp32; bf16 seeded random
    weights made on the card; the synthetic SentencePiece vocab with T5's
    template): 704 x 704, 49 frames, 8 steps, CFG 5 (cold, another prompt,
    the first again: its latents bit-identical, its frames within
    WAN_FRAME_TOL levels, deep_cache_interval 2); kernel B's
    launches (16 a step, 4 on a cached step) and A's (49 a prompt encoding)
    against the module tree; one CFG denoise step against the plain
    version; seconds a request, the VAE decode's, peak GiB. The requests
    of phases 35-36 run with cuDNN's TF32 on, PyTorch's default (the VAE's
    fp32 convolutions); phase 0's setting holds for every comparison.
36. in the same process, at full width and reduced depth (2 blocks, 2 UMT5
    layers): the three files written by the state dicts and read by
    from_checkpoint, bit-identical (the VAE fp32 from its bf16 file); the
    server on a YAML naming them: the window scheduler's 2 compatible
    requests with frames in one generate() of batch 2, mp4 replies read back
    by OpenCV, each row against batch-1 generate() (POOL_REQUEST_TOL); the
    CLI on --family wan writing an mp4, in bf16 and with --quant-type
    bnb_nf4 (kernel D's launches on every DiT Linear it takes).
37-39. (a process of its own, --sdxl-adapters) kernels E and G at the
    RoPE student's shapes and B at SigLIP-384's; the SDXL train step in the
    three remat modes; flow match, RoPE distillation and the IP-Adapter
    through the Trainer from their YAMLs, each with a generate().
40-42. in the same process, on the same seeded SDXL file: prompt-free
    generation (reference and self modes), the style tokenizer (a CLIP-size
    vocabulary, SigLIP-512, kernel B at its shape) and DRaFT+ (LoRA,
    DRAFT_STEPS sampling steps, 25 before phases 43-46, a full-width PickScore on
    seeded weights) through the
    Trainer from their YAMLs, the injected encoder the port's SigLIP;
    each with its launches under a path of its own, its saved file read
    back, a generate() and a depth-reduced step (one transformer layer in
    each SpatialTransformer) against the plain versions: DRaFT+'s at 3
    sampling steps and 2 PickScore layers a tower, its decoded image too.
43. (a process of its own, --remainder, on a seeded 6.9 GB SDXL file it
    writes) the SDXL Trainer on configs/sdxl/text_to_image_lora.yml at full width and depth
    under each of REST_OPTIMIZERS (the 8-bit AdamW, optax.adamw, Adafactor,
    the schedule-free SGD), one epoch of 4 seeded 1024 px images at batch 2,
    each run with a Discord preview posted to a local HTTP server (the
    multipart form parsed, its webp read back), the Hub saving callback
    with a recording api (one upload_file of the saved file) and the
    tensorboard tracker (its train/loss scalars and event file); launches a
    step; the 8-bit run's state checkpoint resumed against the unbroken
    run (the next step's loss and the parameters after it bit-identical);
    ms a step, peak GiB and the optimizer state's bytes of each.
44. the checkpoint tools: quantize_model on the card (NF4 on attn1, attn2,
    .ff.), NF4_TOOL_PROBES' tensors byte for byte against a CPU run; the
    written file through SDXLModel.from_checkpoint into one QLoRA step
    (kernel D's forward and dx launches against the quantized layers);
    convert_dtype bf16 -> fp32 -> bf16 and to_safetensors of a pickled
    state_dict on the VAE's tensors, each back to the same tensors.
45. SDXL from the file, 1024 px requests with and without do_offloading
    (offloaded_requests: two plain, the first offloaded, two from the
    host; the peak reset before each; latents bit-identical).
46. (a process of its own, --fractal) FractalGen's masked transformer at
    full width (FRACTAL: 64 px in 4 px patches, hidden 1024, 16 heads of 64,
    32 blocks; seeded bf16 weights): a forward on kernels A (one launch a
    LayerNorm) and E (one a block), and at FRACTAL_REDUCED blocks (full
    width) against the plain versions (FRACTAL_TOL), ms a forward; kernel E
    alone at its 257-token shape, the ragged last tile's row held apart
    (MASKED_ATTN_TOL), beside SDPA and the bound.

Every kernel's record carries its time, its plain version's, the bound
(the larger of bytes / 3.35 TB/s and operations / 989 TFLOP/s bf16, or
67 TFLOP/s for the fp32 LayerNorm, GroupNorm and probe arithmetic, from
this run's shapes) and the time of the one PyTorch call that computes the
same function, where there is one (never used by the port). The line
before the last is the kernels' JSON record; the last line is {"ok": true,
"device": {...}}.
There is no CPU path.
"""

import argparse
import concurrent.futures
import contextlib
import functools
import gc
import io
import json
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

# max |kernel - plain| / max |plain|, bf16 outputs at O(1) scale: both
# versions round to bf16 at other places (online rescaling, the output
# cast), a few bf16 ulps (2**-8 relative each)
ATTN_TOL = 2e-2
LN_TOL = 2e-2
# the backward kernels and the plain backward round P and dS to bf16 at the
# same points and accumulate in fp32; they differ in the exp (exp2 with
# log2 e folded in), in summation order and in each output's bf16 rounding
ATTN_BWD_TOL = 2e-2
# one whole train step, kernels against their plain versions, bf16, random
# weights: every one of 70 attentions and 210 LayerNorms differs by a few
# bf16 ulps, and the UNet in between carries those differences on, the
# gradients more than the loss (measured on an H100: 1e-5 relative on the
# loss, 2e-3 on the gradient norm)
STEP_LOSS_TOL = 1e-2
STEP_GRAD_NORM_TOL = 5e-2

ATTN_SHAPES = [  # (B, S, H*D, H): SDXL 1024x1024 and the ragged 832x1216 bucket at the
    # requests' CFG batch 2, then 1024x1024 at the train step's batch 4
    (2, 4096, 640, 10), (2, 1024, 1280, 20), (2, 3952, 640, 10), (2, 988, 1280, 20),
    (4, 4096, 640, 10), (4, 1024, 1280, 20),
]
ATTN_BWD_SHAPES = [  # the train step's batch 4 at 1024 px; the ragged bucket at batch 2
    (4, 4096, 640, 10), (4, 1024, 1280, 20), (2, 3952, 640, 10), (2, 988, 1280, 20),
]
LN_SHAPES = [  # (rows, C, beta): UNet 640/1280 at batch 2, CLIP-L 768 and bigG 1280 at
    # B*77, then the UNet's at the train step's batch 4
    (8192, 640, True), (2048, 1280, True), (154, 768, True), (154, 1280, False),
    (16384, 640, True), (4096, 1280, True),
]
# kernel A's edges: the widest C (4 warps a row), a C that is not a multiple of 8 x 32
# (lanes idle), one row
LN_EDGE_SHAPES = [(64, 8192, True), (77, 136, False), (1, 1280, True)]
# the 4-bit matmul kernels and their plain versions dequantize to the same
# bf16 weight and accumulate in fp32: they differ in the order of the fp32
# sums and so in the output's one bf16 rounding; relative to the output's
# largest value, the JAX package's own tolerances for the kernels replaced
NF4_FWD_TOL = 2e-2
NF4_DX_TOL = 3e-2
NF4_SHAPES = [  # (M, N, K) of the quantized Linears: the train step's batch 4 at 1024 px
    # (1280-wide stage, 640-wide stage, text keys 4 x 227), then the request's CFG batch 2
    (4096, 1280, 1280), (4096, 10240, 1280), (4096, 1280, 5120), (908, 1280, 2048),
    (16384, 640, 640), (16384, 5120, 640), (16384, 640, 2560), (908, 640, 2048),
    (2048, 1280, 1280), (154, 1280, 2048),
]
NF4_WARMUP, NF4_TIMED, NF4_ROUTE_STEPS = 1, 2, 2  # 3, 3 before phases 43-46
# NF4 rounds a weight to one of 16 levels of its block's absmax: the widest
# gap (0.723 to 1.0) bounds the error by 0.139 absmax
NF4_MAX_ERR = 0.17
# kernel E and its plain version take fp32 scores from the same bf16
# products and round the weights to bf16 before P V (the kernel before the
# normalization, the plain version after); kernel F and its plain version
# sum the same bf16 products in fp32 in another order and round the gated
# product and the output to bf16: a few bf16 ulps of the output's largest
# value; lse is fp32 on both sides
MASKED_ATTN_TOL = 2e-2
MASKED_LSE_TOL = 1e-4
FUSED_MLP_TOL = 2e-2
# a depth-reduced Lumina2 request (2 + 2 refiner blocks and 4 main blocks, 4
# steps, CFG 4), kernels against plain versions, bf16, random weights: every
# block's few-ulp differences are carried on, and guidance multiplies the
# difference of two forwards by 4; relative to the latents' largest value.
# The full request with the fused feed-forward kernel against the same
# request with it off is held to the same limit.
LUMINA_REQUEST_TOL = 3e-2
# kernel G and the plain backward round P and dS to bf16 at the same points
# and accumulate in fp32; they differ in the exp (exp2 with log2 e folded
# in), in summation order (dk and dv also sum the 3 query heads of a kv
# head) and in each output's bf16 rounding: kernel C's limit, relative to
# the output's largest value
MASKED_BWD_TOL = 2e-2
MASKED_BWD_SHAPES = [  # (B, H, Hkv, Sq, Sk, D, mask, causal); the first is the main stack's
    (4, 24, 8, 4352, 4352, 96, "hole", False),  # the train step at 1024 px: [caption 256 | image 4096]
    (4, 24, 8, 4096, 4096, 96, "ones", False),  # noise refiner
    (4, 24, 8, 256, 256, 96, "hole", False),    # context refiner
    (4, 24, 8, 512, 512, 96, "hole", False),    # low-res main stack: [caption 256 | image 256]
    (2, 24, 8, 4352, 4352, 96, "hole", True),   # causal + hole
    (2, 10, 10, 1000, 1000, 64, None, False),   # D 64, H = Hkv
    (1, 8, 4, 1024, 1024, 128, "hole", False),  # D 128
    (1, 24, 8, 300, 1000, 96, "hole", False),   # ragged, Sq != Sk
]
LUMINA_LORA_TARGETS = ["qkv", ".out", "w1", "w2", "w3"]
LUMINA_TRAIN_WARMUP, LUMINA_TRAIN_TIMED = 2, 3  # 5 timed before phases 43-46
MASKED_ATTN_SHAPES = [  # (B, H, Hkv, Sq, Sk, D, mask, causal); the first is the main stack's
    (2, 24, 8, 4352, 4352, 96, "hole", False),  # 1024 px, CFG: [caption 256 | image 4096]
    (2, 24, 8, 4096, 4096, 96, "ones", False),  # noise refiner
    (2, 24, 8, 256, 256, 96, "hole", False),    # context refiner
    (4, 24, 8, 4208, 4208, 96, "hole", False),  # two prompts at 832x1216, CFG: ragged tiles
    (4, 24, 8, 3952, 3952, 96, "ones", False),
    (2, 24, 8, 4352, 4352, 96, None, False),
    (2, 24, 8, 4352, 4352, 96, "hole", True),
    (1, 24, 8, 300, 1000, 96, "hole", False),   # ragged, sq != sk
    (2, 10, 10, 1000, 1000, 64, None, False),
    (1, 8, 4, 1024, 1024, 128, "hole", False),
]
FUSED_MLP_SHAPES = [  # (M, C, inner, act, biases); the first is the main stack's
    (8704, 2304, 9216, "silu", False),   # 2 x 4352 joint tokens
    (8192, 2304, 9216, "silu", False),   # noise refiner
    (512, 2304, 9216, "silu", False),    # context refiner
    (16832, 2304, 9216, "silu", False),  # two prompts at 832x1216, CFG
    (1001, 2304, 9216, "gelu", True),    # ragged rows, biases
    (1001, 1280, 5120, "gelu_tanh", True),
    (64, 4096, 8192, "silu", True),      # wider than the 3712 the first design took; F-down split
]
GEGLU_SHAPE = (16384, 640, 2560)  # SDXL's first stage at 1024 px, batch 4
SHORTK_KERNELS = ("flash_attention_shortk", "flash_attention_shortk_bwd")
# kernels H and I against their plain versions: the forward rounds P to
# bf16 before P V and normalizes after, as kernel E; the backward rounds P
# and dS to bf16 where the plain backward does and sums dk and dv over q in
# another order (per block, then in split order): relative to the output's
# largest value, kernel E's limit and 3e-2 for the gradients
SHORTK_TOL, SHORTK_BWD_TOL = 2e-2, 3e-2
SHORTK_SHAPES = [  # (B, H, Sq, Sk, D, zero_batch): the request's two stages at 1024 px
    (2, 10, 4096, 77, 64, False), (2, 20, 1024, 77, 64, False),
    (2, 10, 3952, 77, 64, False), (2, 20, 988, 77, 64, False),    # ragged: 832x1216
    (4, 10, 4096, 77, 64, False), (4, 20, 1024, 77, 64, False),   # the batch-4 train step
    (4, 10, 4096, 152, 64, False), (4, 20, 1024, 152, 64, False),  # 150-token prompts
    (2, 10, 1024, 192, 64, False), (2, 8, 1024, 77, 128, False),  # SHORTK_MAX keys, D 128
    (2, 10, 1024, 77, 64, True),                                  # a batch entry of zero q rows
]
SHORTK_TRAIN_SHAPE = 4  # the index of the train step's shape, kernel I's record
# the 1024 px request with the short-K kernels (or the fused feed-forward)
# against the default route: every one of 70 attentions (feed-forwards)
# differs by a few bf16 ulps and 8 steps with guidance 5 carry them on;
# relative to the latents' largest value, the limit of the Lumina2 requests
ROUTE_REQUEST_TOL = 3e-2
TRAINER_IMAGES = [(1024, 1024)] * 4 + [(832, 1216)] * 4  # (width, height)
LUMINA_KERNELS = ("flash_attention_masked", "gated_mlp", "flash_attention_masked_dkv",
                  "flash_attention_masked_dq")
# kernels J, K and L: no model path calls them (as in the JAX package); phase 18
# drives them through their own entry points
OPS_KERNELS = ("group_norm", "conv3x3", "partial_block_copy", "partial_block_lastaxis",
               "partial_block_tma")
# (shape, eps) at 32 groups: the SDXL UNet's GroupNorms at 1024 px for the CFG
# request (batch 2, with the up-block concat's 2560) and the train step
# (batch 4), the VAE decoder's at 1024 px (batch 1, eps 1e-6), and a rank-3 case
GN_SHAPES = [((2, 128, 128, 320), 1e-5), ((2, 64, 64, 640), 1e-5), ((2, 32, 32, 1280), 1e-5),
             ((2, 32, 32, 2560), 1e-5), ((4, 128, 128, 320), 1e-5),
             ((1, 128, 128, 512), 1e-6), ((1, 256, 256, 512), 1e-6),
             ((1, 512, 512, 256), 1e-6), ((1, 1024, 1024, 128), 1e-6), ((2, 4096, 640), 1e-5)]
# (x shape, CO): the same UNet and VAE stages' 3x3 convs, the UNet's at the 832x1216
# bucket (ragged pixel boxes), the 16-channel VAE's conv_in (C = 16), a C = 48 case and
# a 640-channel conv at 32 x 32 (64 tiles: kernel K's split path)
CONV_SHAPES = [((2, 128, 128, 320), 320), ((2, 64, 64, 640), 640), ((2, 32, 32, 1280), 1280),
               ((2, 32, 32, 2560), 1280), ((4, 128, 128, 320), 320),
               ((1, 128, 128, 512), 512), ((1, 256, 256, 512), 512),
               ((1, 512, 512, 256), 256), ((1, 1024, 1024, 128), 128),
               ((2, 104, 152, 320), 320), ((2, 52, 76, 640), 640), ((2, 26, 38, 1280), 1280),
               ((1, 128, 128, 16), 512), ((2, 96, 96, 48), 96), ((2, 32, 32, 640), 640)]
RESNET_SHAPE = (2, 64, 64, 640)  # one SDXL resnet body at the request's second stage
# kernel L's timed cases, the probe's own: a copy of (S, C) bf16 in blocks of 512 rows,
# the TMA case's (S, C) bf16, x * 2 + 1 over (R, S) fp32 in blocks of 512 columns
PROBE_COPY, PROBE_TMA, PROBE_LASTAXIS = (4360, 256, 512), (4360, 256), (8, 4352, 512)
# kernels J and K against their plain versions: the same fp32 arithmetic
# summed in another order, the output rounded once to bf16 on both sides:
# a bf16 ulp or two of the output's largest value, under the JAX conv
# test's 2e-2; their gradients (plain formulas on both sides) the same
GN_TOL = CONV_TOL = GN_GRAD_TOL = CONV_GRAD_TOL = 2e-2
# the resnet body through the ops against nn.core's GroupNorm + F.silu +
# Conv2d: GroupNorm's statistics by another formula (E[x^2] - mean^2
# against PyTorch's), two bf16 convs and a residual carry a few bf16 ulps
# on; relative to the largest value, the limits of a whole step
RESNET_TOL, RESNET_GRAD_TOL = 3e-2, 5e-2
STEPS = 8
TRAIN_BATCH, TRAIN_RES, TRAIN_WARMUP, TRAIN_TIMED = 4, 1024, 2, 2  # 3 timed before phases 43-46
LORA_TARGETS = ["attn1", "attn2", ".ff."]

# NVIDIA H100 SXM data sheet, dense rates
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
# torch.cuda._sleep's cycles before host_us issues its calls: 50 ms at 2 GHz, far more
# than 200 calls take to issue
SLEEP_CYCLES = 100_000_000


# the further times of kernels A and L's records in the kernels line
COST_KEYS = ("burst_ms", "host_us", "traced_ms", "library_burst_ms", "library_host_us",
             "library_traced_ms")


_START = time.perf_counter()


def phase(name: str) -> None:
    """A phase's header, with the seconds since this process started."""
    print(f"== {name} (t = {time.perf_counter() - _START:.1f} s)", flush=True)


def cuda_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    """Median milliseconds of ``fn()`` on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def burst_ms(fn, calls: int = 10, iters: int = 10) -> float:
    """Median milliseconds a call of ``fn()`` over ``calls`` calls issued
    back to back between two CUDA events: the card's rate once the host's
    launch cost overlaps the previous call."""
    fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def host_us(fn, calls: int = 200, repeats: int = 3) -> float:
    """Median host microseconds ``fn()`` takes to issue, measured with the
    card held busy by a torch.cuda._sleep queued first, so that the calls
    only queue behind it: the perf_counter span over ``calls`` calls. A
    span in which the card finished the sleep before the last call was
    issued (a stall of the shared host) is measured again behind a sleep
    twice as long; the run fails if that happens behind 8x the sleep."""
    fn()
    times = []
    for _ in range(repeats):
        cycles = SLEEP_CYCLES
        while True:
            torch.cuda.synchronize()
            torch.cuda._sleep(cycles)
            asleep = torch.cuda.Event()
            asleep.record()
            start = time.perf_counter()
            for _ in range(calls):
                fn()
            span = (time.perf_counter() - start) / calls * 1e6
            if not asleep.query():
                times.append(span)
                break
            if cycles >= 8 * SLEEP_CYCLES:
                raise AssertionError("host_us: the card woke before the calls were issued")
            cycles *= 2
    torch.cuda.synchronize()
    return statistics.median(times)


def call_costs(fn, host_calls: int = 200) -> dict:
    """One call by CUDA events, a call over 10 back to back, and the host's
    microseconds a call of ``fn`` (over ``host_calls`` calls: fewer for a
    call whose host cost would outlast the card's sleep)."""
    return dict(ms=cuda_ms(fn, iters=50), burst_ms=burst_ms(fn), host_us=host_us(fn, host_calls))


def bound(nbytes: float, flops: float, peak_flops: float = PEAK_BF16_FLOPS):
    """(least milliseconds the card could take, what binds it)."""
    by_bytes, by_flops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / peak_flops * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_flops else (by_flops, "operations")


def compare(name, kernel, plain, tol):
    """Errors of ``kernel()`` against ``plain()``, in fp32; fails past tol."""
    out, ref = kernel().float(), plain().float()
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        raise AssertionError(f"{name}: kernel output not finite")
    abs_err = (out - ref).abs().max().item()
    rel_err = abs_err / ref.abs().max().item()
    if rel_err > tol:
        raise AssertionError(f"{name}: max abs err {abs_err:.3e}, rel {rel_err:.3e} > {tol}")
    return abs_err, rel_err


def assert_reruns(name, fn):
    """Fails unless two calls of ``fn`` give the same bits (a tensor or a tuple of them)."""
    first, second = fn(), fn()
    pairs = zip(first, second) if isinstance(first, tuple) else [(first, second)]
    if not all(torch.equal(x, y) for x, y in pairs):
        raise AssertionError(f"{name}: a rerun differs")


def sdpa_heads(t, h):
    """(B, S, H*D) -> (B, H, S, D) view, the layout of PyTorch's own attention."""
    return t.unflatten(-1, (h, t.shape[-1] // h)).transpose(1, 2)


def write_vocab(path: Path) -> None:
    """A small CLIP BPE vocab: the 26 letters and the comma (with and
    without the end-of-word mark), a few merges, and bos/eos at CLIP's own ids, so
    that the towers' pooled token (id vocab_size - 1) is the real eos."""
    vocab = {}
    for ch in "abcdefghijklmnopqrstuvwxyz":
        vocab[ch] = len(vocab)
        vocab[ch + "</w>"] = len(vocab)
    for token in ("th", "the</w>", "ca", "cat</w>", "on</w>", "of</w>", ",", ",</w>"):
        vocab[token] = len(vocab)
    vocab["<|startoftext|>"] = 49406
    vocab["<|endoftext|>"] = 49407
    merges = ["#version: 0.2", "t h", "th e</w>", "c a", "ca t</w>", "o n</w>", "o f</w>"]
    (path / "vocab.json").write_text(json.dumps(vocab))
    (path / "merges.txt").write_text("\n".join(merges) + "\n")


def lumina_vocab() -> bytes:
    """A small unigram SentencePiece vocab (a ``tokenizer.model``): specials,
    the byte pieces, a few words and the letters; Gemma's template prepends
    <bos>."""
    from vision_ft_tpu_torch.models.text_encoders.sentencepiece import serialize_model

    words = ("a photo of cat sitting on the sofa red car road house in mountains blurry").split()
    pieces = [("<pad>", 0.0, 3), ("<eos>", 0.0, 3), ("<bos>", 0.0, 3), ("<unk>", 0.0, 2)]
    pieces += [(f"<0x{i:02X}>", 0.0, 6) for i in range(256)]
    pieces += [("▁" + w, -1.0 - 0.1 * i, 1) for i, w in enumerate(dict.fromkeys(words))]
    pieces += [(ch, -5.0, 1) for ch in "abcdefghijklmnopqrstuvwxyz▁"]
    return serialize_model(pieces, unk_id=3, bos_id=2, eos_id=1, pad_id=0)


MLP_ACTIVATIONS = {"silu": F.silu, "gelu": F.gelu,
                   "gelu_tanh": lambda t: F.gelu(t, approximate="tanh")}


def mlp_case(what, kernel, plain, library, flops, nbytes, library_name):
    """Errors, reruns and times of one kernel F call (or part) against its
    plain version, with the one library call that computes the same."""
    abs_err, rel_err = compare(what, kernel, plain, FUSED_MLP_TOL)
    if not torch.equal(kernel(), kernel()):
        raise AssertionError(f"{what}: two launches differ")
    ms = cuda_ms(kernel, warmup=2, iters=10)
    plain_ms = cuda_ms(plain, warmup=1, iters=3)
    library_ms = cuda_ms(library, iters=10)
    bound_ms, bound_by = bound(nbytes, flops)
    print(f"{what}: max abs err {abs_err:.3e} rel {rel_err:.3e} (tol {FUSED_MLP_TOL}), reruns "
          f"bit-identical; kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain "
          f"{plain_ms:.3f} ms, {library_name} {library_ms:.4f} ms (kernel / library "
          f"{ms / library_ms:.2f}), bound {bound_ms:.4f} ms ({bound_by})")
    return abs_err, dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                         library_ms=library_ms, tflops=flops / ms / 1e9)


def mlp_parts(label, x, wa, wg, wd, ba, bg, bd, act, whole):
    """F-up, F-down on F-up's own output, then the whole call: (errors, rows)."""
    from vision_ft_tpu_torch.ops.fused_mlp import (
        gated_down, gated_down_reference, gated_mlp_reference, gated_up, gated_up_reference,
    )

    m, c, inner = x.shape[0], x.shape[1], wd.shape[1]
    act_fn = MLP_ACTIVATIONS[act]
    nb = lambda *ts: sum(0 if t is None else 2 * t.numel() for t in ts)  # noqa: E731
    a = gated_up(x, wa, wg, ba, bg, act)
    up = mlp_case(
        f"F-up {label}", lambda: gated_up(x, wa, wg, ba, bg, act),
        lambda: gated_up_reference(x, wa, wg, ba, bg, act),
        lambda: act_fn(F.linear(x, wa, ba)) * F.linear(x, wg, bg), 4 * m * c * inner,
        2 * (m * c + 2 * c * inner + m * inner) + nb(ba, bg), "two F.linear + gate")
    down = mlp_case(
        f"F-down {label}", lambda: gated_down(a, wd, bd),
        lambda: gated_down_reference(a, wd, bd), lambda: F.linear(a, wd, bd),
        2 * m * c * inner, 2 * (m * inner + c * inner + m * c) + nb(bd), "one F.linear")
    full = mlp_case(
        f"kernel F {label}", whole,
        lambda: gated_mlp_reference(x, wa, wg, wd, ba, bg, bd, act),
        lambda: F.linear(act_fn(F.linear(x, wa, ba)) * F.linear(x, wg, bg), wd, bd),
        6 * m * c * inner, 2 * (2 * m * c + 3 * c * inner) + nb(ba, bg, bd),
        "three F.linear + gate")
    return up, down, full


def mlp_tensors(m, c, inner, with_biases, device, gen, fused=False):
    x = torch.randn(m, c, device=device, generator=gen).bfloat16()
    up = torch.randn((2 if fused else 1) * inner, c, device=device, generator=gen)
    wa = (up * c**-0.5).bfloat16()
    wg = wa if fused else (torch.randn(inner, c, device=device, generator=gen) * c**-0.5).bfloat16()
    wd = (torch.randn(c, inner, device=device, generator=gen) * inner**-0.5).bfloat16()
    biases = [(0.1 * torch.randn(n, device=device, generator=gen)).bfloat16() if with_biases
              else None for n in (wa.shape[0], inner, c)]
    return x, wa, wg, wd, biases


@contextlib.contextmanager
def plain_versions():
    """Inside, the kernel wrappers' CUDA paths are their plain PyTorch
    versions: a swap made in this process only, for the comparison of a
    whole train step. The package has no such switch."""
    import vision_ft_tpu_torch.ops.flash_attention as flash
    import vision_ft_tpu_torch.ops.fused_mlp as mlp
    import vision_ft_tpu_torch.ops.layer_norm as ln
    import vision_ft_tpu_torch.ops.nf4_matmul as nf4
    import vision_ft_tpu_torch.ops.conv3x3 as conv
    import vision_ft_tpu_torch.ops.group_norm as gn
    from vision_ft_tpu_torch.tools import partial_block_probe as probe

    def forward(q, k, v, num_heads, scale, return_lse):
        if return_lse:
            return flash.flash_attention_bshd_reference(q, k, v, num_heads, scale, return_lse=True)
        return flash.flash_attention_bshd_reference(q, k, v, num_heads, scale), None

    def backward(q, k, v, out, lse, dout, num_heads, scale=None):
        return flash.flash_attention_bshd_backward_reference(
            q, k, v, out, lse, dout, num_heads, scale
        )

    def mlp_forward(x2, w_act, b_act, w_gate, b_gate, w_down, b_down, act):
        return mlp.gated_mlp_reference(x2, w_act, w_gate, w_down, b_act, b_gate, b_down, act)

    saved = (flash._forward, flash.flash_attention_bshd_backward, ln._forward)
    saved_nf4 = (nf4.nf4_matmul_forward, nf4.nf4_matmul_dx)
    def shortk_forward(q, k, v, scale, return_lse):
        if return_lse:
            return flash.flash_attention_shortk_reference(q, k, v, scale, return_lse=True)
        return flash.flash_attention_shortk_reference(q, k, v, scale), None

    def shortk_backward(q, k, v, out, lse, dout, scale=None):
        return flash.flash_attention_shortk_backward_reference(q, k, v, out, lse, dout, scale)

    saved_lumina = (flash._masked_forward, mlp._forward, flash.flash_attention_masked_backward)
    saved_shortk = (flash._shortk_forward, flash.flash_attention_shortk_backward)
    saved_ops = (gn._forward, conv._forward, probe.partial_block_copy, probe.partial_block_lastaxis,
                 probe.partial_block_tma)
    gn._forward, conv._forward = gn.group_norm_reference, conv.conv3x3_reference
    probe.partial_block_copy = probe.partial_block_copy_reference
    probe.partial_block_lastaxis = probe.partial_block_lastaxis_reference
    probe.partial_block_tma = probe.partial_block_tma_reference
    flash._shortk_forward, flash.flash_attention_shortk_backward = shortk_forward, shortk_backward
    flash._forward, flash.flash_attention_bshd_backward = forward, backward
    flash._masked_forward, mlp._forward = flash.flash_attention_reference, mlp_forward
    flash.flash_attention_masked_backward = flash.flash_attention_masked_backward_reference
    ln._forward = ln.layer_norm_reference
    nf4.nf4_matmul_forward, nf4.nf4_matmul_dx = nf4.nf4_matmul_reference, nf4.nf4_matmul_dx_reference
    try:
        yield
    finally:
        flash._forward, flash.flash_attention_bshd_backward, ln._forward = saved
        nf4.nf4_matmul_forward, nf4.nf4_matmul_dx = saved_nf4
        flash._masked_forward, mlp._forward, flash.flash_attention_masked_backward = saved_lumina
        flash._shortk_forward, flash.flash_attention_shortk_backward = saved_shortk
        (gn._forward, conv._forward, probe.partial_block_copy, probe.partial_block_lastaxis,
         probe.partial_block_tma) = saved_ops


# kernel-name fragments -> kind, first match wins (torch.profiler's names)
KERNEL_KINDS = [
    ("gn_fused_kernel", "kernel J"),
    ("conv3x3_split_sum", "kernel K split sum"), ("conv3x3_kernel", "kernel K"),
    ("partial_block_copy", "kernel L copy"),
    ("partial_block_lastaxis", "kernel L last axis"), ("partial_block_tma", "kernel L TMA"),
    ("flash_bwd_dkv_masked", "kernel G dk/dv"), ("flash_bwd_dq_masked", "kernel G dq"),
    ("flash_fwd_masked", "kernel E"), ("gated_up_kernel", "kernel F up"),
    ("gated_down_kernel", "kernel F down"), ("gated_down_split_sum", "kernel F split sum"),
    ("shortk_fwd", "kernel H"), ("shortk_bwd", "kernel I"),
    ("flash_bwd_dkv_bshd", "kernel C dk/dv"), ("flash_bwd_dq_bshd", "kernel C dq"),
    ("flash_fwd_bshd", "kernel B"), ("layer_norm_fwd", "kernel A"),
    ("nf4_matmul_kernel<true", "kernel D dx"), ("nf4_matmul_kernelILb1", "kernel D dx"),
    ("nf4_matmul_kernel<false", "kernel D forward"), ("nf4_matmul_kernelILb0", "kernel D forward"),
    ("nf4_split_sum", "kernel D split sum"),
    ("multi_tensor", "optimizer / clipping (foreach)"),
    ("nvjet", "matmul (cuBLAS)"), ("gemm", "matmul (cuBLAS)"), ("gemv", "matmul (cuBLAS)"),
    ("cutlass", "matmul (cuBLAS)"), ("xmma", "matmul (cuBLAS)"), ("splitK", "matmul (cuBLAS)"),
    ("sdpa", "attention (SDPA)"), ("pytorch_flash", "attention (SDPA)"),
    ("fmha", "attention (SDPA)"),
    ("conv", "conv (cuDNN)"), ("cudnn", "conv (cuDNN)"), ("nchw", "conv (cuDNN)"),
    ("nhwc", "conv (cuDNN)"), ("dgrad", "conv (cuDNN)"), ("wgrad", "conv (cuDNN)"),
    ("group_norm", "group_norm"), ("GroupNorm", "group_norm"), ("RowwiseMoments", "group_norm"),
    ("softmax", "softmax"),
    ("reduce", "reduction (PyTorch)"),
    ("elementwise", "elementwise / copy (PyTorch)"), ("Memcpy", "elementwise / copy (PyTorch)"),
    ("Memset", "elementwise / copy (PyTorch)"), ("copy", "elementwise / copy (PyTorch)"),
    ("CatArray", "elementwise / copy (PyTorch)"), ("upsample", "elementwise / copy (PyTorch)"),
]


def profile_window(run_step):
    """Trace one train step (device activity only): ms by kind, kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run_step()
        torch.cuda.synchronize()
    kinds, kernels = {}, []
    for event in prof.key_averages():
        device_us = getattr(event, "self_device_time_total", None)
        if device_us is None:  # the attribute's name in older PyTorch
            device_us = event.self_cuda_time_total
        if device_us <= 0:
            continue
        kind = next((k for frag, k in KERNEL_KINDS if frag in event.key), "other")
        kernels.append((device_us / 1e3, event.count, kind, event.key))
        total, count = kinds.get(kind, (0.0, 0))
        kinds[kind] = (total + device_us / 1e3, count + event.count)
    return kinds, kernels


def profile_steps(run_step, unprofiled_ms: float, what: str = "train step") -> dict:
    """Trace two steps, one window each, and print the second's device
    time by kind of kernel and the card's idle share of a step of
    ``unprofiled_ms``; returns that step's {kind: (ms, launches)}. The
    profiler can lose events under load: the two windows must agree, or
    the run fails."""
    (first, _), (kinds, kernels) = profile_window(run_step), profile_window(run_step)
    busy_first = sum(t for t, _ in first.values())
    busy_ms = sum(t for t, _ in kinds.values())
    launches = sum(n for _, n in kinds.values())
    print(f"profile of a {what}: {busy_ms:.1f} ms of kernel time in {launches} launches "
          f"({busy_first:.1f} ms in {sum(n for _, n in first.values())} the step before); "
          f"an unprofiled step takes {unprofiled_ms:.1f} ms: the card is idle "
          f"{100 * (1 - busy_ms / unprofiled_ms):.1f}% of it")
    if busy_ms <= 0 or abs(busy_ms - busy_first) > 0.05 * busy_ms:
        raise AssertionError("torch.profiler lost events: two traced steps disagree")
    for kind, (ms, count) in sorted(kinds.items(), key=lambda kv: -kv[1][0]):
        print(f"  {kind:32s} {ms:8.2f} ms/step {100 * ms / busy_ms:5.1f}% {count:8d} launches/step")
    print("the 12 kernels with the most device time:")
    for ms, count, kind, name in sorted(kernels, reverse=True)[:12]:
        print(f"  {ms:8.2f} ms/step {count:6d} launches/step [{kind}] {name[:100]}")
    return kinds


def print_kernel_ms(kinds: dict, names, what: str) -> None:
    """One line per kind of kernel in ``names``: its device ms in a traced ``what``."""
    for name in names:
        ms, count = kinds.get(name, (0.0, 0))
        print(f"{name} in the traced {what}: {ms:.2f} ms in {count} launches")


def linear_host_cost(device) -> None:
    """Host microseconds per call of one 1280 x 1280 Linear at 128 rows,
    where the card is never the limit: dense bf16, and NF4 on each route;
    forward alone and forward + backward to the input."""
    import vision_ft_tpu_torch.nn as tnn
    from vision_ft_tpu_torch.modules import quant

    g = torch.Generator(device=device).manual_seed(0)
    layers = torch.nn.ModuleDict({name: tnn.Linear(1280, 1280) for name in ("dense", "nf4")})
    tnn.init_parameters_(layers.to_empty(device=device).to(torch.bfloat16), g)
    quant.quantize_params(layers, "bnb_nf4", ["nf4"])
    x = torch.randn(128, 1280, device=device, generator=g).bfloat16()
    x_grad = x.clone().requires_grad_()

    def per_call(fn, calls=1000):
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(calls):
            fn()
        host = time.perf_counter() - start
        torch.cuda.synchronize()
        return host / calls * 1e6

    print("host cost of one Linear call (1280 x 1280, 128 rows; forward, forward + backward):")
    for name, route in (("dense", None), ("nf4", "fused"), ("nf4", "stream"), ("nf4", "dequant")):
        layer = layers[name]
        tnn.set_nf4_route(route or "fused")
        try:
            with torch.no_grad():
                forward_us = per_call(lambda: layer(x))
            both_us = per_call(lambda: torch.autograd.grad(layer(x_grad).sum(), x_grad))
        finally:
            tnn.set_nf4_route("fused")
        print(f"  {name + (' ' + route if route else ''):12s} {forward_us:7.1f} us, {both_us:7.1f} us")


def ln_inputs(n_rows, c, beta, device, gen):
    """Kernel A's seeded inputs: x (n_rows, C) bf16 of scale 2 around 0.3,
    gamma near 1, beta near 0 or None."""
    x = (torch.randn(n_rows, c, device=device, generator=gen) * 2 + 0.3).bfloat16()
    w = (1 + 0.2 * torch.randn(c, device=device, generator=gen)).bfloat16()
    bias = (0.2 * torch.randn(c, device=device, generator=gen)).bfloat16() if beta else None
    return x, w, bias


def probe_cases(device, gen) -> dict:
    """Kernel L's three timed cases on seeded inputs, each output a
    sentinel-filled buffer longer than the result: {name: (x, out, wrapper,
    kernel call, plain call, library name, library call)}, name "copy",
    "TMA" or "last axis" (its profiler kind is "kernel L <name>"). The
    library calls write into views made here, outside the timed call."""
    from vision_ft_tpu_torch.tools import partial_block_probe as probe

    s, c, block = PROBE_COPY
    copy_x = torch.randn(s, c, device=device, generator=gen).bfloat16()
    copy_out = torch.full((s + block, c), probe.SENTINEL, device=device, dtype=torch.bfloat16)
    s, c = PROBE_TMA
    tma_x = torch.randn(s, c, device=device, generator=gen).bfloat16()
    tma_out = torch.full((s + probe.TMA_BOX[0], c), probe.SENTINEL, device=device,
                         dtype=torch.bfloat16)
    r, s, last_block = PROBE_LASTAXIS
    last_x = torch.randn(r, s, device=device, generator=gen)
    last_out = torch.full((r * s + last_block,), probe.SENTINEL, device=device)
    one = torch.ones((), device=device)
    return {
        "copy": (copy_x, copy_out, probe.partial_block_copy,
                 functools.partial(probe.partial_block_copy, copy_x, block, copy_out),
                 functools.partial(probe.partial_block_copy_reference, copy_x, block, copy_out),
                 "Tensor.copy_", functools.partial(copy_out[: copy_x.shape[0]].copy_, copy_x)),
        "TMA": (tma_x, tma_out, probe.partial_block_tma,
                functools.partial(probe.partial_block_tma, tma_x, tma_out),
                functools.partial(probe.partial_block_tma_reference, tma_x, tma_out),
                "Tensor.copy_", functools.partial(tma_out[: tma_x.shape[0]].copy_, tma_x)),
        "last axis": (last_x, last_out, probe.partial_block_lastaxis,
                      functools.partial(probe.partial_block_lastaxis, last_x, last_block, last_out),
                      functools.partial(probe.partial_block_lastaxis_reference, last_x, last_block,
                                        last_out),
                      "torch.add(1, x, alpha=2)",
                      functools.partial(torch.add, one, last_x, alpha=2,
                                        out=last_out[: last_x.numel()].view(last_x.shape))),
    }


def a_and_l_cases(device, gen) -> list:
    """(label, wrapper, profiler kind, call) of kernel A at LN_SHAPES and of
    kernel L's three timed cases, each followed by its library call's
    (label, None, None, call): what the traces and --ln-probe-costs time."""
    from vision_ft_tpu_torch.ops.layer_norm import layer_norm

    cases = []
    for shape in LN_SHAPES:
        x, w, bias = ln_inputs(*shape, device, gen)
        cases += [(f"kernel A {shape}", layer_norm, "kernel A",
                   functools.partial(layer_norm, x, w, bias)),
                  (f"F.layer_norm {shape}", None, None,
                   functools.partial(F.layer_norm, x, x.shape[-1:], w, bias))]
    for name, (_, _, wrapper, call, _, library, library_call) in probe_cases(device, gen).items():
        cases += [(f"kernel L {name}", wrapper, f"kernel L {name}", call),
                  (f"{library} beside kernel L {name}", None, None, library_call)]
    return cases


def window_ms(kinds: dict) -> float:
    """The card's ms a call in a traced window of 10 calls, all its kernels:
    over the calls the window saw, the launches of its most launched kind
    (the profiler may miss a window's first launch)."""
    return sum(ms for ms, _ in kinds.values()) / max(n for _, n in kinds.values())


def traced_ms(traces: dict, label: str) -> float:
    """The card's ms a call of a --trace-kernels label (``window_ms``)."""
    return window_ms(traces[label]["kinds"])


def ln_probe_costs(device, gen) -> dict:
    """--ln-probe-costs: {label: one call, a call over 10 back to back, host
    us a call, and the card's ms a call and launches in 10 calls traced by
    torch.profiler in this process} for every case of a_and_l_cases."""
    costs = {}
    for label, _, _, call in a_and_l_cases(device, gen):
        costs[label] = call_costs(call)
        kinds, _ = profile_window(lambda: [call() for _ in range(10)])
        costs[label]["traced_ms"] = window_ms(kinds)
        costs[label]["traced_launches"] = sum(n for _, n in kinds.values())
    return costs


def trace_kernels(device, gen) -> dict:
    """10 calls each of kernel H at its record's shape, of I at every
    SHORTK_SHAPES shape, of J (+ SiLU) and K at theirs, of A at LN_SHAPES
    and of L's three timed cases, and of SDPA's forward, SDPA's backward
    alone (I's shapes), F.group_norm + F.silu and A's and L's library calls
    on the same inputs, each traced by torch.profiler: {label: {"kinds":
    {kind: [ms, launches]}, "kernel": the kind that must show one launch a
    call, or None, "counted": the wrapper's launch count over the 10
    calls}}."""
    from vision_ft_tpu_torch.ops.conv3x3 import conv3x3
    from vision_ft_tpu_torch.ops.flash_attention import (
        flash_attention_masked_delta, flash_attention_shortk, flash_attention_shortk_bwd,
    )
    from vision_ft_tpu_torch.ops.group_norm import group_norm

    b, h, sq, sk, d, _ = SHORTK_SHAPES[0]
    q, k, v = (torch.randn(b, s_, h * d, device=device, generator=gen).bfloat16()
               .view(b, s_, h, d).transpose(1, 2) for s_ in (sq, sk, sk))
    x = torch.randn(GN_SHAPES[0][0], device=device, generator=gen).bfloat16()
    affine = torch.ones(x.shape[-1], device=device, dtype=torch.bfloat16)
    shape, co = CONV_SHAPES[1]
    x2 = torch.randn(shape, device=device, generator=gen).bfloat16()
    w = (torch.randn(co, shape[-1], 3, 3, device=device, generator=gen)
         / (3 * shape[-1] ** 0.5)).bfloat16()
    cases = [
        (f"kernel H {(b, h, sq, sk, d)}", flash_attention_shortk,
         lambda: flash_attention_shortk(q, k, v, return_lse=True), "kernel H"),
        (f"SDPA {(b, h, sq, sk, d)}", None,
         lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v), None),
        (f"group_norm + SiLU {tuple(x.shape)}", group_norm,
         lambda: group_norm(x, affine, affine, 32, 1e-5, "silu"), "kernel J"),
        (f"F.group_norm + F.silu {tuple(x.shape)}", None,
         lambda: F.silu(F.group_norm(x.movedim(-1, 1), 32, affine, affine, 1e-5)), None),
        (f"conv3x3 {shape} -> {co} (with the weight repack)", conv3x3,
         lambda: conv3x3(x2, w), "kernel K"),
    ]
    cases += [(label, wrapper, call, kind) for label, wrapper, kind, call in a_and_l_cases(device, gen)]
    for b, h, sq, sk, d, zero_batch in SHORTK_SHAPES:
        q, k, v, dout = shortk_inputs(b, h, sq, sk, d, zero_batch, device, gen)
        out, lse = flash_attention_shortk(q, k, v, return_lse=True)
        delta = flash_attention_masked_delta(out, dout)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        sdpa_out = torch.nn.functional.scaled_dot_product_attention(*leaves)
        shape = (b, h, sq, sk, d)
        cases += [
            (f"kernel I {shape}", flash_attention_shortk_bwd,
             functools.partial(flash_attention_shortk_bwd, q, k, v, dout, lse, delta), "kernel I"),
            (f"SDPA backward {shape}", None,
             functools.partial(torch.autograd.grad, sdpa_out, leaves, dout, retain_graph=True),
             None),
        ]
    traces = {}
    for label, wrapper, call, kernel in cases:
        call()
        # the profiler has returned an empty window now and then, and once a window
        # with one of a kernel's 10 launches (the wrapper counted 10): up to three
        # tries; run_trace_kernels checks the window kept
        for _ in range(3):
            before = wrapper.launches if wrapper else 0
            kinds, _ = profile_window(lambda: [call() for _ in range(10)])
            if kinds and (kernel is None or 9 <= kinds.get(kernel, (0, 0))[1] <= 10):
                break
        traces[label] = dict(kinds=kinds, kernel=kernel,
                             counted=wrapper.launches - before if wrapper else None)
    return traces


def kernel_d_phase(device, gen) -> dict:
    """Phase 7: kernel D's forward and dx against their plain versions at
    NF4_SHAPES in both byte layouts and, at (908, 640, 2048), with the FP4
    codebook; every case reruns bit-identical. The split layout (the one
    the quantized model holds) is timed: kernel, plain version, bound and
    the cuBLAS call on a bf16 weight dequantized beforehand. Returns the
    two kernels' records (the first shape's times)."""
    from vision_ft_tpu_torch.modules import quant
    from vision_ft_tpu_torch.modules.quant.nf4 import quantize_4bit
    from vision_ft_tpu_torch.ops.nf4_matmul import (
        nf4_matmul_dx, nf4_matmul_dx_reference, nf4_matmul_forward, nf4_matmul_reference,
        to_split_layout,
    )

    def nf4_case(m, n, k, quant_type, split, timed):
        """Both kernels against their plain versions on one quantized
        weight, and each run twice for the same bits; with ``timed`` also
        the times and bounds, as a record row per kernel."""
        w = torch.randn(n, k, device=device, generator=gen) * 0.02
        packed, state = quantize_4bit(w, quant_type)
        code, absmax = state["quant_map"], state["absmax"]
        packed = to_split_layout(packed, (n, k)) if split else packed.reshape(n, k // 2)
        x = torch.randn(m, k, device=device, generator=gen).bfloat16()
        dy = torch.randn(m, n, device=device, generator=gen).bfloat16()
        args = (packed, code, absmax, (n, k), 64, split)
        what = f"{quant_type} {'split' if split else 'bnb'} (M={m}, N={n}, K={k})"
        fwd_err = compare(f"4-bit matmul forward {what}", lambda: nf4_matmul_forward(x, *args),
                          lambda: nf4_matmul_reference(x, *args), NF4_FWD_TOL)
        dx_err = compare(f"4-bit matmul dx {what}", lambda: nf4_matmul_dx(dy, *args),
                         lambda: nf4_matmul_dx_reference(dy, *args), NF4_DX_TOL)
        assert_reruns(f"4-bit matmul forward {what}", lambda: nf4_matmul_forward(x, *args))
        assert_reruns(f"4-bit matmul dx {what}", lambda: nf4_matmul_dx(dy, *args))
        line = (f"{what}: forward max abs err {fwd_err[0]:.3e} rel {fwd_err[1]:.3e} "
                f"(tol {NF4_FWD_TOL}), dx {dx_err[0]:.3e} rel {dx_err[1]:.3e} (tol {NF4_DX_TOL}); "
                f"both rerun bit-identical")
        if not timed:
            print(line)
            return fwd_err[0], dx_err[0], None, None
        fwd_ms = cuda_ms(lambda: nf4_matmul_forward(x, *args))
        dx_ms = cuda_ms(lambda: nf4_matmul_dx(dy, *args))
        fwd_plain = cuda_ms(lambda: nf4_matmul_reference(x, *args), warmup=1, iters=5)
        dx_plain = cuda_ms(lambda: nf4_matmul_dx_reference(dy, *args), warmup=1, iters=5)
        # yardstick only: one cuBLAS call on a bf16 weight dequantized
        # beforehand; it does less work (no dequantization)
        dense = quant.nf4.dequantize_4bit(packed, code, absmax, (n, k), 64, torch.bfloat16, split)
        fwd_lib = cuda_ms(lambda: torch.nn.functional.linear(x, dense))
        dx_lib = cuda_ms(lambda: torch.matmul(dy, dense))
        burst = (burst_ms(lambda: nf4_matmul_forward(x, *args)),
                 burst_ms(lambda: torch.nn.functional.linear(x, dense)),
                 burst_ms(lambda: nf4_matmul_dx(dy, *args)),
                 burst_ms(lambda: torch.matmul(dy, dense)))
        same = (torch.equal(nf4_matmul_forward(x, *args), torch.nn.functional.linear(x, dense)),
                torch.equal(nf4_matmul_dx(dy, *args), torch.matmul(dy, dense)))
        weight_bytes = packed.numel() + absmax.numel() * 4 + code.numel() * 4
        flops = 2 * m * n * k
        fwd_bound = bound(x.numel() * 2 + weight_bytes + m * n * 2, flops)
        dx_bound = bound(dy.numel() * 2 + weight_bytes + m * k * 2, flops)
        print(line + f"; forward kernel {fwd_ms:.4f} ms ({flops / fwd_ms / 1e9:.1f} TFLOP/s, "
              f"{fwd_ms / fwd_lib:.2f}x cuBLAS), plain {fwd_plain:.3f} ms, F.linear on a bf16 "
              f"weight {fwd_lib:.4f} ms ({flops / fwd_lib / 1e9:.1f} TFLOP/s), bound "
              f"{fwd_bound[0]:.4f} ms ({fwd_bound[1]}); dx kernel {dx_ms:.4f} ms "
              f"({flops / dx_ms / 1e9:.1f} TFLOP/s, {dx_ms / dx_lib:.2f}x cuBLAS), plain "
              f"{dx_plain:.3f} ms, matmul on a bf16 weight {dx_lib:.4f} ms "
              f"({flops / dx_lib / 1e9:.1f} TFLOP/s), bound {dx_bound[0]:.4f} ms ({dx_bound[1]}); "
              f"10 calls back to back, ms a call: forward {burst[0]:.4f} "
              f"({flops / burst[0] / 1e9:.1f} TFLOP/s) vs F.linear {burst[1]:.4f}, "
              f"dx {burst[2]:.4f} "
              f"({flops / burst[2] / 1e9:.1f} TFLOP/s) vs matmul {burst[3]:.4f}; "
              f"bit-identical to those cuBLAS calls: forward {same[0]}, dx {same[1]}")
        return (fwd_err[0], dx_err[0],
                dict(ms=fwd_ms, plain_ms=fwd_plain, bound_ms=fwd_bound[0], bound_by=fwd_bound[1],
                     library_ms=fwd_lib),
                dict(ms=dx_ms, plain_ms=dx_plain, bound_ms=dx_bound[0], bound_by=dx_bound[1],
                     library_ms=dx_lib))

    fwd_errs, dx_errs, fwd_rows, dx_rows = [], [], [], []
    for m, n, k in NF4_SHAPES:
        # the split layout is the one the quantized model holds: it is timed
        for split in (True, False):
            fwd_err, dx_err, fwd_row, dx_row = nf4_case(m, n, k, "nf4", split, timed=split)
            fwd_errs.append(fwd_err)
            dx_errs.append(dx_err)
            if split:
                fwd_rows.append(fwd_row)
                dx_rows.append(dx_row)
    for split in (True, False):  # the other codebook, through the same kernels
        fwd_err, dx_err, _, _ = nf4_case(908, 640, 2048, "fp4", split, timed=False)
        fwd_errs.append(fwd_err)
        dx_errs.append(dx_err)
    return {
        "nf4_matmul_forward": dict(
            route="cuda", source="vision_ft_tpu_torch/csrc/nf4_matmul.cu",
            replaces="vision_ft_tpu/ops/pallas/nf4_matmul.py:189",
            max_abs_err=max(fwd_errs), **fwd_rows[0],
        ),
        "nf4_matmul_dx": dict(
            route="cuda", source="vision_ft_tpu_torch/csrc/nf4_matmul.cu",
            replaces="vision_ft_tpu/ops/pallas/nf4_matmul.py:214",
            max_abs_err=max(dx_errs), **dx_rows[0],
        ),
    }


def kernels_h_i_phase(device, gen, traces) -> dict:
    """Phase 15: kernels H and I against their plain versions at
    SHORTK_SHAPES, reruns bit-identical; H timed by one call and back to
    back beside SDPA's forward, I by one call, back to back, its host us a
    call and its traced card time (``traces``, the --trace-kernels
    process) beside SDPA's backward alone. Returns the two kernels' records
    (H at the request's first shape, I at the train step's)."""
    from vision_ft_tpu_torch.ops.flash_attention import (
        _masked_backward_reference, flash_attention_masked_delta as shortk_delta,
        flash_attention_shortk, flash_attention_shortk_backward_reference,
        flash_attention_shortk_bwd, flash_attention_shortk_reference,
    )

    h_errs, i_errs, h_rows, i_rows = [], [], [], []
    for b, h, sq, sk, d, zero_batch in SHORTK_SHAPES:
        q, k, v, dout = shortk_inputs(b, h, sq, sk, d, zero_batch, device, gen)
        out, lse = flash_attention_shortk(q, k, v, return_lse=True)
        fwd_err = compare(f"short-K forward {(b, h, sq, sk, d)}", lambda: out,
                          lambda: flash_attention_shortk_reference(q, k, v), SHORTK_TOL)
        delta = shortk_delta(out, dout)
        grads = flash_attention_shortk_bwd(q, k, v, dout, lse, delta)
        again = (flash_attention_shortk(q, k, v), *flash_attention_shortk_bwd(q, k, v, dout, lse, delta))
        if not all(torch.equal(a, b_) for a, b_ in zip((out, *grads), again)):
            raise AssertionError(f"short-K {(b, h, sq, sk, d)}: a rerun differs")
        want = flash_attention_shortk_backward_reference(q, k, v, out, lse, dout)
        bwd_err = {n: compare(f"short-K backward {(b, h, sq, sk, d)} {n}", lambda: g_,
                              lambda: w_, SHORTK_BWD_TOL)
                   for n, g_, w_ in zip(("dq", "dk", "dv"), grads, want)}
        del want
        fwd_ms = cuda_ms(lambda: flash_attention_shortk(q, k, v, return_lse=True))
        kernel_i = call_costs(lambda: flash_attention_shortk_bwd(q, k, v, dout, lse, delta))
        plain_fwd_ms = cuda_ms(lambda: flash_attention_shortk_reference(q, k, v, return_lse=True),
                               iters=5)
        plain_bwd_ms = cuda_ms(
            lambda: _masked_backward_reference(q, k, v, None, lse, delta, dout, None, False), iters=5)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        sdpa_fwd_ms = cuda_ms(lambda: sdpa(q, k, v))
        fwd_burst_ms = burst_ms(lambda: flash_attention_shortk(q, k, v, return_lse=True))
        sdpa_burst_ms = burst_ms(lambda: sdpa(q, k, v))
        sdpa_out = sdpa(*leaves)
        sdpa_bwd = call_costs(lambda: torch.autograd.grad(sdpa_out, leaves, dout, retain_graph=True),
                              host_calls=50)
        shape = (b, h, sq, sk, d)
        traced = (traced_ms(traces, f"kernel I {shape}"), traced_ms(traces, f"SDPA backward {shape}"))
        q_bytes, k_bytes, row_bytes = b * h * sq * d * 2, b * h * sk * d * 2, b * h * sq * 4
        fwd_bytes, fwd_flops = 2 * q_bytes + 2 * k_bytes + row_bytes, 4 * b * h * sq * sk * d
        fwd_bound = bound(fwd_bytes, fwd_flops)
        # S, dP, dV, dK, dQ: 5 products; q, dO, dq, k, v, dk, dv, lse, delta
        bwd_bound = bound(3 * q_bytes + 4 * k_bytes + 2 * row_bytes, 10 * b * h * sq * sk * d)
        print(f"B={b} H={h} Sq={sq} Sk={sk} D={d}{' zero q batch' if zero_batch else ''}: forward "
              f"max abs err {fwd_err[0]:.3e} rel {fwd_err[1]:.3e} (tol {SHORTK_TOL}), "
              + ", ".join(f"{n} {a:.3e} rel {r:.3e}" for n, (a, r) in bwd_err.items())
              + f" (tol {SHORTK_BWD_TOL}), reruns bit-identical; kernel H {fwd_ms:.4f} ms "
              f"({fwd_flops / fwd_ms / 1e9:.1f} TFLOP/s, {fwd_bytes / fwd_ms / 1e6:.0f} GB/s, "
              f"{100 * fwd_bound[0] / fwd_ms:.1f}% of the bound; {fwd_burst_ms:.4f} ms a call over "
              f"10 back to back, {100 * fwd_bound[0] / fwd_burst_ms:.1f}%) (plain "
              f"{plain_fwd_ms:.3f}, bound {fwd_bound[0]:.4f} {fwd_bound[1]}, SDPA {sdpa_fwd_ms:.4f}, "
              f"{sdpa_burst_ms:.4f} back to back)")
        print(f"  kernel I {kernel_i['ms']:.4f} ms one call ({100 * bwd_bound[0] / kernel_i['ms']:.1f}% "
              f"of the bound; {kernel_i['ms'] / sdpa_bwd['ms']:.2f}x SDPA's backward), "
              f"{kernel_i['burst_ms']:.4f} a call over 10 back to back "
              f"({kernel_i['burst_ms'] / sdpa_bwd['burst_ms']:.2f}x), {traced[0]:.5f} traced on the "
              f"card ({100 * bwd_bound[0] / traced[0]:.1f}% of the bound, "
              f"{traced[0] / traced[1]:.2f}x), host {kernel_i['host_us']:.1f} us a call; plain "
              f"{plain_bwd_ms:.3f}; SDPA's backward {sdpa_bwd['ms']:.4f} one call, "
              f"{sdpa_bwd['burst_ms']:.4f} back to back, {traced[1]:.5f} traced, host "
              f"{sdpa_bwd['host_us']:.1f} us; bound {bwd_bound[0]:.4f} ms ({bwd_bound[1]})")
        h_errs.append(fwd_err[0])
        i_errs.append(max(a for a, _ in bwd_err.values()))
        h_rows.append(dict(ms=fwd_ms, plain_ms=plain_fwd_ms, bound_ms=fwd_bound[0],
                           bound_by=fwd_bound[1], library_ms=sdpa_fwd_ms))
        i_rows.append(dict(ms=kernel_i["ms"], plain_ms=plain_bwd_ms, bound_ms=bwd_bound[0],
                           bound_by=bwd_bound[1], library_ms=sdpa_bwd["ms"],
                           burst_ms=kernel_i["burst_ms"], host_us=kernel_i["host_us"],
                           traced_ms=traced[0], library_burst_ms=sdpa_bwd["burst_ms"],
                           library_host_us=sdpa_bwd["host_us"], library_traced_ms=traced[1]))
        del q, k, v, dout, out, lse, delta, grads, again, leaves, sdpa_out
    # kernel H's record at the request's first shape, kernel I's at the train step's
    return {
        "flash_attention_shortk": dict(
            route="cuda", source="vision_ft_tpu_torch/csrc/flash_attention_shortk.cu",
            replaces="vision_ft_tpu/ops/pallas/flash_attention.py:1226",
            max_abs_err=max(h_errs), **h_rows[0]),
        "flash_attention_shortk_bwd": dict(
            route="cuda", source="vision_ft_tpu_torch/csrc/flash_attention_shortk.cu",
            replaces="vision_ft_tpu/ops/pallas/flash_attention.py:1256",
            max_abs_err=max(i_errs), **i_rows[SHORTK_TRAIN_SHAPE]),
    }


def shortk_inputs(b, h, sq, sk, d, zero_batch, device, gen):
    """Seeded q, k, v, dO in SDXL's layout: (B, H, S, D) views of (B, S,
    H*D) projections; with ``zero_batch`` the last batch entry's q rows are
    zeros."""
    heads = lambda t: t.view(b, t.shape[1], h, d).transpose(1, 2)  # noqa: E731
    q = torch.randn(b, sq, h * d, device=device, generator=gen).bfloat16()
    if zero_batch:
        q[-1] = 0
    k, v = (torch.randn(b, sk, h * d, device=device, generator=gen).bfloat16() for _ in "kv")
    dout = torch.randn(b, sq, h * d, device=device, generator=gen).bfloat16()
    return tuple(heads(t) for t in (q, k, v, dout))


class Child:
    """``chip_smoke.py <flag>`` in a process of its own (a fresh card),
    started ahead of its turn: it imports while the phases before it run,
    then waits for a line on its stdin before it touches the card. A child
    whose stdin closes first (this process ended) exits."""

    def __init__(self, checkout: Path, flag: str, *extra: str, timeout: float = 900):
        self.flag, self.timeout = flag, timeout
        self.proc = subprocess.Popen(
            [sys.executable, str(checkout / "chip_smoke.py"), flag, *extra, "--wait-for-go"],
            cwd=checkout, stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)

    def result(self, key: str, echo: bool = True):
        """Let the child run to its end; print its lines but the last (all
        of them if it failed) and return ``key`` of its last line, one JSON
        object."""
        try:
            out, err = self.proc.communicate("go\n", timeout=self.timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.communicate()
            raise
        lines = out.strip().splitlines()
        if echo:
            print("\n".join(lines[:-1] if self.proc.returncode == 0 else lines))
        if self.proc.returncode != 0 or not lines:
            raise AssertionError(f"chip_smoke.py {self.flag} failed (exit {self.proc.returncode}): "
                                 f"{err[-4000:]}")
        return json.loads(lines[-1])[key]


# the main run's children in their order: (phases, flag, key of their JSON line, what they
# run, seconds they may take)
CHILDREN = (
    ("19", "--lumina-trainer", "lumina_trainer",
     "the Lumina2 Trainer at full width, 8 of the NextDiT's 26 layers: checkpoint, EMA, state "
     "checkpoints, profiler window, preview", 900),
    ("20-21", "--auraflow", "auraflow",
     "kernels B at head dim 256 and F at AuraFlow's widths; AuraFlow generate() at full width, "
     "4 + 8 layers", 900),
    ("22-24", "--auraflow-trainer", "auraflow_trainer",
     "kernel C at head dim 256; the AuraFlow Trainer on config #3, the shortcut and RoPE "
     "migration workloads at full width, 4 + 8 layers", 900),
    ("25-27", "--serve", "serve",
     "serving: the port's HTTP server (window and continuous schedulers), client and CLI on "
     "SDXL, Lumina2 and AuraFlow at full width", 900),
    ("28-30", "--flux", "flux",
     "kernel B at head dim 128; Flux generate() at full width, 4 + 8 blocks, its checkpoint, "
     "server and CLI; the AuraFlow VAE-encode migration", 900),
    ("31-33", "--cogview4", "cogview4",
     "kernels B and C at head dim 128, CogView4's shapes; CogView4 generate() at full width, 8 "
     "DiT blocks, with offloading, its pool, checkpoint, server, CLI, quant-compare tool and "
     "Trainer", 900),
    ("34-36", "--wan", "wan",
     "kernels B, A and D at Wan's shapes; Wan 2.2 generate() at full width, 8 DiT blocks, its "
     "three-file checkpoint, server and CLI", 900),
    ("37-42", "--sdxl-adapters", "sdxl_adapters",
     "kernels E and G at the RoPE student's shapes, B at SigLIP-384's and SigLIP-512's; the "
     "SDXL train step in the three remat modes; the flow-match, RoPE-distillation, IP-Adapter, "
     "prompt-free, style-tokenizer and DRaFT+ workloads through the Trainer with generate()", 600),
    ("43-45", "--remainder", "remainder",
     "the rest of the Trainer (the 8-bit AdamW with a resumed state checkpoint, optax.adamw, "
     "Adafactor, the schedule-free SGD; the Discord, Hub and tensorboard callbacks), the "
     "checkpoint tools (quantize_model, its file through kernel D), SDXL requests with and "
     "without do_offloading", 600),
    ("46", "--fractal", "fractal",
     "FractalGen's masked transformer at full width on kernels A and E", 600),
)
# the children that take --profile
PROFILED_CHILDREN = ("--auraflow", "--flux", "--cogview4", "--wan")


def start_child(checkout: Path, spec: tuple, profile: bool) -> Child:
    _, flag, _, _, timeout = spec
    extra = ["--profile"] if profile and flag in PROFILED_CHILDREN else []
    return Child(checkout, flag, *extra, timeout=timeout)


def run_trace_kernels(child: Child) -> dict:
    """The ``--trace-kernels`` child's traces (a process of its own: late in
    a long run the profiler has shown nothing at all), each kernel checked
    for one launch a call."""
    traces = child.result("traces", echo=False)
    for label, trace in traces.items():
        kinds, only = trace["kinds"], trace["kernel"]
        if only and (not 9 <= kinds.get(only, (0, 0))[1] <= 10 or trace["counted"] != 10):
            # the profiler may miss the first launch of a window, never more
            raise AssertionError(f"{label}: {kinds} in 10 calls ({trace['counted']} counted), "
                                 f"not one launch of {only} a call")
    return traces


LUMINA_TRAINER_EMA = 0.999
# captions of different lengths for the Lumina2 Trainer's 8 images (the synthetic vocab's
# words and letters)
LUMINA_TRAINER_CAPTIONS = [
    "a photo of a cat", "a red car on the road", "a house in the mountains",
    "a cat sitting on the sofa in a photo of a house in the mountains", "the sofa",
    "a blurry photo of a red car on the road in the mountains", "a cat", "a house",
]


def lumina_trainer_phase(device, wrappers: dict, checkout: Path) -> dict:
    """Phase 19, run in a process of its own (``--lumina-trainer``): the
    Lumina2 Trainer path at full width and reduced depth from a seeded single-file
    checkpoint, with EMA, state checkpoints and their resume, the profiler
    window and a preview. Returns the run's launch counts and numbers."""
    import yaml
    from safetensors import safe_open

    from vision_ft_tpu_torch.config import TrainConfig
    from vision_ft_tpu_torch.models.lumina2.config import DenoiserConfig as LuminaDenoiserConfig
    from vision_ft_tpu_torch.models.lumina2.config import Lumina2Config
    from vision_ft_tpu_torch.models.lumina2.pipeline import Lumina2
    from vision_ft_tpu_torch.models.lumina2.util import convert_to_comfy_key
    from vision_ft_tpu_torch.nn import remat_saves, set_remat_saves
    from vision_ft_tpu_torch.train.lumina2.text_to_image import build_trainer
    from vision_ft_tpu_torch.training.optimizer import global_norm
    from vision_ft_tpu_torch.training.state_checkpoint import restore_train_state
    from vision_ft_tpu_torch.utils import safetensors as st

    def reset_launches():
        for wrapper in wrappers.values():
            wrapper.launches = 0

    def read_launches():
        return {name: wrapper.launches for name, wrapper in wrappers.items()}

    def free(model):
        for part in model._parts().values():
            part.to("meta")
        gc.collect()
        torch.cuda.empty_cache()

    numbers = {}
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_lumina_trainer_"))
    try:
        (work / "tokenizer.model").write_bytes(lumina_vocab())
        images_dir = work / "images"
        images_dir.mkdir()
        img_rng = np.random.default_rng(0)
        for i, (w, h) in enumerate(TRAINER_IMAGES):
            smooth = img_rng.integers(0, 255, (h // 32, w // 32, 3), dtype=np.uint8)
            Image.fromarray(smooth).resize((w, h), Image.BILINEAR).save(images_dir / f"{i}.png")
            (images_dir / f"{i}.txt").write_text(LUMINA_TRAINER_CAPTIONS[i])

        # the checkpoint: the full-width Lumina2 of phase 12 at reduced depth, seeded, written
        # by state_dict()
        seeded = Lumina2(Lumina2Config(checkpoint_path="", dtype="bfloat16",
                                       denoiser=LuminaDenoiserConfig(**LUMINA_CUT_DEPTH)))
        seeded.init_params(torch.Generator(device=device).manual_seed(19))
        ckpt = work / "lumina2.safetensors"
        torch.cuda.synchronize()
        start = time.perf_counter()
        st.save_file(seeded.state_dict(), ckpt)
        numbers["checkpoint_write_s"] = time.perf_counter() - start
        numbers["checkpoint_bytes"] = ckpt.stat().st_size
        free(seeded)
        del seeded

        (work / "preview.yml").write_text(yaml.safe_dump([dict(
            prompt="a photo of a cat sitting on the sofa", negative_prompt=None, height=1024,
            width=1024, cfg_scale=4.0, num_steps=STEPS, seed=0)]))
        raw = yaml.safe_load((checkout / "configs/lumina2/text_to_image.yml").read_text())
        raw["model"].update(checkpoint_path=str(ckpt), tokenizer_path=str(work),
                            denoiser=dict(LUMINA_CUT_DEPTH))
        raw["dataset"].update(folder=str(images_dir))
        raw["num_train_epochs"] = 1
        raw["saving"]["callbacks"][0]["save_dir"] = str(work / "lora")
        raw["preview"] = {"strategy": {"per_epochs": 1, "per_steps": None},
                          "callbacks": [{"type": "local", "save_dir": str(work / "preview")}],
                          "data": {"path": str(work / "preview.yml")}}
        raw["trainer"].update(
            ema_decay=LUMINA_TRAINER_EMA, state_checkpoint_dir=str(work / "state"),
            state_checkpoint_every_steps=2, profile=True, profile_dir=str(work / "profile"),
            profile_start_step=2, profile_stop_step=3)
        config = TrainConfig.model_validate(raw, strict=True)
        print(f"checkpoint {numbers['checkpoint_bytes']} bytes written by state_dict() in "
              f"{numbers['checkpoint_write_s']:.2f} s; config #4 cut to one epoch: "
              f"{config.optimizer.name} {config.optimizer.args}, LoRA rank {config.peft.config.rank} "
              f"on {config.peft.include_keys}, batch {config.dataset['batch_size']}, buckets from "
              f"{config.dataset['bucket_base_size']} step {config.dataset['step']}; "
              f"{config.trainer.model_dump(include={'ema_decay', 'state_checkpoint_every_steps', 'profile_start_step', 'profile_stop_step', 'gradient_checkpointing'})}")

        trainer = build_trainer(config)
        logs, step_log, load_s, preview_s, save_s = [], [], [], [], []
        trainer.log_dict = lambda values, step=None: logs.append(dict(values))

        def timed(fn, into):
            def run(*args, **kwargs):
                torch.cuda.synchronize()
                start = time.perf_counter()
                out = fn(*args, **kwargs)
                torch.cuda.synchronize()
                into.append(time.perf_counter() - start)
                return out
            return run

        trainer.model.setup_model = timed(trainer.model.setup_model, load_s)
        trainer.model.preview_step = timed(trainer.model.preview_step, preview_s)
        trainer.save_state_checkpoint = timed(trainer.save_state_checkpoint, save_s)
        prepare_optimizer = trainer.prepare_optimizer

        def prepare_and_time():
            prepare_optimizer()
            inner = trainer._step

            def timed_step(state, batch, generator):
                torch.cuda.synchronize()
                before = read_launches()
                start = time.perf_counter()
                state, metrics = inner(state, batch, generator)
                loss = metrics["train/loss"].item()
                torch.cuda.synchronize()
                after = read_launches()
                step_log.append((time.perf_counter() - start, loss,
                                 {k: after[k] - before[k] for k in after}, batch))
                return state, metrics

            trainer._step = timed_step

        trainer.prepare_optimizer = prepare_and_time
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        start = time.perf_counter()
        trainer.train()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - start
        run_launches = read_launches()
        numbers.update(
            peak_gib=torch.cuda.max_memory_allocated() / 2**30, train_s=run_s,
            checkpoint_load_s=load_s[0], preview_s=preview_s[0],
            run_step_ms=[t * 1e3 for t, *_ in step_log])
        losses = [loss for _, loss, _, _ in step_log]
        step_logs = [v for v in logs if "train/loss" in v]
        shapes = [tuple(b["pixel_values"].shape) for *_, b in step_log]
        print(f"trainer.train(): {run_s:.1f} s with the checkpoint load {load_s[0]:.2f} s and the "
              f"preview {preview_s[0]:.2f} s; {len(step_log)} steps over batches {shapes}; losses "
              f"{losses}; ms a step {[round(t, 1) for t in numbers['run_step_ms']]} (host clock, "
              f"synchronized; step 1 cold, steps 2-3 under the profiler), peak "
              f"{numbers['peak_gib']:.2f} GiB")
        for i, v in enumerate(step_logs):
            print(f"  step {i + 1}: " + ", ".join(f"{k} {v[k]:.6f}" for k in sorted(v)))
        if len(step_log) != len(TRAINER_IMAGES) // 2 or len(step_logs) != len(step_log) or not all(
                np.isfinite(v[k]) for v in step_logs
                for k in ("train/loss", "train/highres_loss", "train/lowres_loss", "train/grad_norm")):
            raise AssertionError(f"Lumina2 trainer steps: {step_logs}")

        model = trainer.model.model
        den = model.denoiser
        depth, noise_ref, context_ref = len(den.layers), len(den.noise_refiner), len(den.context_refiner)

        def want_step(shape, saves="kernel"):
            """Kernel E and G launches of one step at a (B, H, W, 3) batch, from the
            module tree and the dispatch gate (sk >= 256): the high-res and the low-res
            pass each run every main block (256 caption + image keys) and the context
            refiner (256 caption keys), and the noise refiner where its image keys
            reach 256; with remat saves "none" the backward runs E again."""
            _, h, w, _ = shape
            blocks = 0
            for stride in (8, 32):  # the latents and the 4x-pooled latents, in pixels
                tokens = (h // stride // den.patch_size) * (w // stride // den.patch_size)
                blocks += depth + context_ref + (noise_ref if tokens >= 256 else 0)
            want = {name: 0 for name in wrappers}
            want.update({"flash_attention_masked": blocks * (2 if saves == "none" else 1),
                         "flash_attention_masked_dkv": blocks, "flash_attention_masked_dq": blocks})
            return want

        for i, (_, _, launches, batch) in enumerate(step_log):
            want = want_step(tuple(batch["pixel_values"].shape))
            if launches != want:
                raise AssertionError(f"Lumina2 trainer step {i + 1}: launches {launches} != {want}")
        preview_blocks = STEPS * (depth + noise_ref) + context_ref  # captions cached after step 1
        want_run = {name: sum(launches[name] for _, _, launches, _ in step_log) for name in wrappers}
        want_run["flash_attention_masked"] += preview_blocks
        print(f"launches a step {[launches for _, _, launches, _ in step_log]} as the module tree "
              f"gives them ({depth} + {noise_ref} + {context_ref} blocks; the low-res noise refiner "
              f"of a 768x1152 batch has 216 keys and takes the plain formula); the whole run "
              f"{run_launches}, expected {want_run} (the preview's {preview_blocks} of kernel E)")
        if run_launches != want_run:
            raise AssertionError(f"Lumina2 trainer run launches {run_launches} != {want_run}")

        # the frozen base against the file, tensor for tensor
        live = model.state_dict()
        with safe_open(str(ckpt), framework="pt", device="cpu") as f:
            keys = list(f.keys())
            changed = [k for k in keys if not torch.equal(live[k].cpu(), f.get_tensor(k))]
        if changed or len(keys) != len([k for k in live if "lora_" not in k and not k.endswith(".alpha")]):
            raise AssertionError(f"frozen tensors changed: {changed[:3]} ({len(keys)} in the file)")
        print(f"{len(keys)} base tensors bit-identical to the checkpoint file")
        del live

        # state checkpoints, the EMA and the saved LoRA file
        steps_saved = sorted(int(p.name.split("_")[1]) for p in (work / "state").glob("step_*"))
        state_bytes = sum(p.stat().st_size for p in (work / "state").rglob("state.pt")) // len(steps_saved)
        numbers.update(state_checkpoint_bytes=state_bytes, state_checkpoint_save_s=max(save_s))
        step4, live4, _, ema4 = restore_train_state(str(work / "state"), "cpu", with_ema=True)
        ema = trainer.ema
        moved = [k for k, v in live4.items() if "lora_up" in k and bool(v.float().abs().max() > 0)]
        ema_vs_live = max((e.cpu() - live4[k].float()).abs().max().item() for k, e in ema.items())
        print(f"state checkpoints {['step_%d' % s for s in steps_saved]}: {state_bytes} bytes each, "
              f"saved in {', '.join(f'{t:.3f}' for t in save_s)} s; at step {step4} "
              f"{len(moved)} of {sum('lora_up' in k for k in live4)} lora_up moved off zero; the EMA "
              f"(decay {LUMINA_TRAINER_EMA}) is fp32 and differs from the live weights by up to "
              f"{ema_vs_live:.3e}")
        if steps_saved != [2, 4] or step4 != 4 or not moved or ema_vs_live == 0 or any(
                e.dtype != torch.float32 or not torch.equal(e.cpu(), ema4[k]) for k, e in ema.items()):
            raise AssertionError("the state checkpoints, the adapters or the EMA are off")

        saved = sorted((work / "lora").glob("*.safetensors"))
        lora_state = st.load_file(saved[-1]) if saved else {}
        params = trainer.model.get_params()
        alphas = {k: v for k, v in params.named_buffers() if k.endswith(".alpha")}
        want_keys = {convert_to_comfy_key(k) for k in (*trainer.trainable, *alphas)}
        not_ema = [k for k, e in ema.items()
                   if not torch.equal(lora_state.get(convert_to_comfy_key(k)), e.to(torch.bfloat16).cpu())]
        if (len(saved) != 1 or set(lora_state) != want_keys
                or not all(k.startswith("diffusion_model.") for k in lora_state) or not_ema):
            raise AssertionError(f"saved LoRA files {saved}: {len(lora_state)} keys, expected "
                                 f"{len(want_keys)}; not the EMA: {not_ema[:3]}")
        print(f"saved {saved[-1].name}: {len(lora_state)} keys (lora_down, lora_up, alpha of "
              f"{len(alphas)} Linears, ComfyUI names), the adapters' values the EMA cast to bf16, "
              f"bit for bit")

        previews = sorted((work / "preview").glob("*"))
        if len(previews) != 1 or Image.open(previews[0]).size != (1024, 1024):
            raise AssertionError(f"preview images {previews}")
        print(f"preview {previews[0].name}: {Image.open(previews[0]).size}, {STEPS} steps, CFG 4 "
              f"with the empty negative prompt, {preview_s[0]:.2f} s")

        # the profiler window: a Chrome trace of steps 2-3 that names kernels E and G
        trace = json.loads(Path(trainer.profile_trace).read_text())
        kernel_names = [e.get("name", "") for e in trace["traceEvents"] if e.get("cat") == "kernel"]
        in_trace = {frag: sum(frag in n for n in kernel_names) for frag in (
            "flash_fwd_masked", "flash_bwd_dkv_masked", "flash_bwd_dq_masked")}
        window = {k: sum(step_log[i][2][k] for i in (1, 2)) for k in LUMINA_KERNELS}
        print(f"profiler trace {Path(trainer.profile_trace).name} ({Path(trainer.profile_trace).stat().st_size} "
              f"bytes): {len(kernel_names)} kernel events; {in_trace} (steps 2-3 launched {window})")
        if min(in_trace.values()) == 0:
            raise AssertionError(f"the profiler trace does not name kernels E and G: {in_trace}")
        del trace, kernel_names

        # what the resume must find, on the host
        opt1 = trainer.state.opt_state.state_dict()
        opt1 = {"param_groups": opt1["param_groups"], "state": {
            i: {k: v.to("cpu", copy=True) if isinstance(v, torch.Tensor) else v
                for k, v in entry.items()}
            for i, entry in opt1["state"].items()}}
        updates1 = trainer.state.step
        ema1 = {k: v.to("cpu", copy=True) for k, v in ema.items()}

        # one more step of the last batch with nothing kept by the checkpoints
        *_, last_batch = step_log[-1]
        trainer_saves = remat_saves()
        set_remat_saves("none")
        try:
            trainer.state, _ = trainer._step(
                trainer.state, last_batch, torch.Generator(device=device).manual_seed(5))
        finally:
            set_remat_saves(trainer_saves)
        none_launches = step_log[-1][2]
        want_none = want_step(tuple(last_batch["pixel_values"].shape), "none")
        print(f"a step with remat saves none: launches {none_launches}, expected {want_none}")
        if none_launches != want_none:
            raise AssertionError(f"trainer step (none): launches {none_launches} != {want_none}")

        # warm steps outside the profiler window, one a bucket, twice each
        warm = {}
        for i in (0, 1, 0, 1):
            batch = step_log[i][3]
            trainer.state, _ = trainer._step(
                trainer.state, batch, torch.Generator(device=device).manual_seed(6))
            bucket = "x".join(str(n) for n in batch["pixel_values"].shape[1:3])
            warm.setdefault(bucket, []).append(step_log[-1][0] * 1e3)
        numbers["warm_step_ms"] = warm
        print(f"warm steps (remat saves kernel, unprofiled), ms by bucket (H x W): {warm}, batch 2")

        # a depth-reduced step (the first 4 main blocks and both refiners), kernels
        # against their plain versions, swapped in by this script's hook
        full_layers = den.layers
        den.layers = torch.nn.ModuleDict({str(i): full_layers[str(i)] for i in range(4)})
        params = [p for k, p in trainer.trainable.items()
                  if not k.startswith("denoiser.layers.") or int(k.split(".")[2]) < 4]

        def loss_and_grads():
            loss, _ = trainer.model.loss_fn(last_batch, torch.Generator(device=device).manual_seed(7))
            return loss.item(), torch.autograd.grad(loss, params)

        try:
            reset_launches()
            kernel_loss, kernel_grads = loss_and_grads()
            used = read_launches()
            with plain_versions():
                plain_loss, plain_grads = loss_and_grads()
        finally:
            den.layers = full_layers
        kernel_norm, plain_norm = global_norm(kernel_grads).item(), global_norm(plain_grads).item()
        loss_rel = abs(kernel_loss - plain_loss) / abs(plain_loss)
        norm_rel = abs(kernel_norm - plain_norm) / abs(plain_norm)
        print(f"depth-reduced step (4 main blocks, the last batch), kernels vs plain versions: loss "
              f"{kernel_loss:.6f} vs {plain_loss:.6f} (rel {loss_rel:.3e}, tol {STEP_LOSS_TOL}); "
              f"grad_norm {kernel_norm:.6f} vs {plain_norm:.6f} (rel {norm_rel:.3e}, tol "
              f"{STEP_GRAD_NORM_TOL}); kernel launches {used}")
        if read_launches() != used or min(used[n] for n in LUMINA_KERNELS if n != "gated_mlp") == 0:
            raise AssertionError(f"the plain step launched a kernel, or the kernel step none: {used}")
        if not (loss_rel <= STEP_LOSS_TOL and norm_rel <= STEP_GRAD_NORM_TOL):
            raise AssertionError("the Lumina2 trainer's kernel step and the plain step disagree")
        del kernel_grads, plain_grads, params, last_batch, step_log
        free(model)
        del model, den, trainer, ema
        gc.collect()
        torch.cuda.empty_cache()

        # a second Trainer on the same config and file resumes from step_4
        second = build_trainer(config)
        second.model.setup_model = timed(second.model.setup_model, load_s)
        second.before_train()
        resumed = second.restore_state_checkpoint()
        opt2 = second.state.opt_state.state_dict()
        same_opt = opt2["param_groups"] == opt1["param_groups"] and opt2["state"].keys() == opt1[
            "state"].keys() and all(
            torch.equal(opt2["state"][i][k].cpu(), v) if isinstance(v, torch.Tensor)
            else opt2["state"][i][k] == v
            for i, entry in opt1["state"].items() for k, v in entry.items())
        same_trainable = all(torch.equal(p.detach().cpu(), live4[k]) for k, p in second.trainable.items())
        same_ema = all(torch.equal(e.cpu(), ema1[k]) for k, e in second.ema.items())
        print(f"a second Trainer (checkpoint load {load_s[-1]:.2f} s) resumed at step {resumed}, "
              f"update {second.state.step}: trainable {same_trainable}, optimizer state {same_opt}, "
              f"EMA {same_ema} bit-identical to step_4")
        if resumed != 4 or second.state.step != updates1 or not (same_trainable and same_opt and same_ema):
            raise AssertionError("the resumed Trainer's state differs from what was saved")
        free(second.model.model)
        del second
    finally:
        shutil.rmtree(work, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": run_launches, "numbers": numbers}


# AuraFlow (tracked config #3): the joint sequence at 1024 px is 8 register + 256 text +
# 4096 image tokens. Kernel B's (B, Sq, Sk, H*D, H): the CFG request's (both halves in
# one call), a request's without CFG, an aligned one, and a ragged one with Sq != Sk
AURA_ATTN_SHAPES = [(2, 4360, 4360, 3072, 12), (1, 4360, 4360, 3072, 12),
                    (2, 4096, 4096, 3072, 12), (2, 1000, 1300, 3072, 12)]
# kernel F's (M, C, inner, act, biases) at 1024 px with CFG: the single layers' 2 x 4360
# joint tokens, the double layers' latent MLP (2 x 4096) and context MLP (2 x 264)
AURA_MLP_SHAPES = [(8720, 3072, 8192, "silu", False), (8192, 3072, 8192, "silu", False),
                   (528, 3072, 8192, "silu", False)]
AURA_STEPS = 8  # 20 before the CogView4 phases joined the run
# one full-depth AuraFlow CFG denoise step (4 double + 32 single layers), kernels B and F
# against their plain versions, bf16, random weights: every layer's few-ulp differences
# are carried on through both residual streams; relative to the largest value of the
# guided velocity (and, for the step's latents, to theirs)
AURA_STEP_TOL = 5e-2
# the single-file checkpoint's depth: full width, 1 double + 2 single layers, 2 UMT5
# layers, so that the file stays small
AURA_CKPT_DEPTH = dict(num_double_layers=1, num_single_layers=2)
AURA_CKPT_TEXT_LAYERS = 2


def aura_fill_zero_init(model, device, seed) -> int:
    """Seeded N(0, 0.02) where the init put zeros (the adaLN projections,
    final_linear, cond_seq_linear), so that every layer does work."""
    g = torch.Generator(device=device).manual_seed(seed)
    filled = 0
    with torch.no_grad():
        for p in model.denoiser.parameters():
            if not p.any():
                p.normal_(0.0, 0.02, generator=g)
                filled += 1
    return filled


# kernel B's plain version runs PLAIN_HEADS heads at a time where the fp32 scores of all heads
# at once (B x H x Sq x Sk x 4 bytes) pass PLAIN_SCORE_BYTES: CogView4's pool (8, 4112, H32),
# 17.3 GB of scores, runs whole on the 80 GB card; Wan's 720p (1, 26400, H24), 66.9 GB, cannot
PLAIN_HEADS = 2
PLAIN_SCORE_BYTES = 20e9


def bshd_reference_by_heads(q, k, v, h, group, return_lse=False):
    """Kernel B's plain version computed ``group`` heads at a time (column
    slices of the heads-packed tensors), for shapes whose scores for all
    heads at once would not fit on the card."""
    from vision_ft_tpu_torch.ops.flash_attention import flash_attention_bshd_reference

    d = q.shape[-1] // h
    outs, lses = [], []
    for first in range(0, h, group):
        cols = slice(first * d, (first + group) * d)
        out = flash_attention_bshd_reference(q[..., cols], k[..., cols], v[..., cols], group,
                                             return_lse=return_lse)
        if return_lse:
            out, lse = out
            lses.append(lse)
        outs.append(out)
    out = torch.cat(outs, dim=-1)
    return (out, torch.cat(lses, dim=1)) if return_lse else out


def bshd_forward_record(device, gen, b, sq, sk, inner, h) -> dict:
    """Kernel B on seeded (B, Sq, H*D) q and (B, Sk, H*D) k, v: one launch,
    out and lse against the plain version (PLAIN_HEADS heads at a time where
    all heads' fp32 scores pass PLAIN_SCORE_BYTES), a rerun bit-identical,
    one call and a call over 10 back to back beside SDPA's, TFLOP/s and the
    bound. Prints its line and returns its record."""
    from vision_ft_tpu_torch.ops.flash_attention import flash_attention_bshd

    plain_heads = PLAIN_HEADS if b * h * sq * sk * 4 > PLAIN_SCORE_BYTES else None
    if plain_heads:
        def flash_attention_bshd_reference(q, k, v, h, return_lse=False):
            return bshd_reference_by_heads(q, k, v, h, plain_heads, return_lse)
    else:
        from vision_ft_tpu_torch.ops.flash_attention import flash_attention_bshd_reference

    q = torch.randn(b, sq, inner, device=device, generator=gen).bfloat16()
    k, v = (torch.randn(b, sk, inner, device=device, generator=gen).bfloat16() for _ in "kv")
    what = f"attention B={b} Sq={sq} Sk={sk} H={h} D={inner // h}" + (
        f" (plain version {plain_heads} heads at a time)" if plain_heads else "")
    before = flash_attention_bshd.launches
    out, lse = flash_attention_bshd(q, k, v, h, return_lse=True)
    if flash_attention_bshd.launches != before + 1:
        raise AssertionError(f"{what}: kernel B launched {flash_attention_bshd.launches - before} times")
    ref, ref_lse = flash_attention_bshd_reference(q, k, v, h, return_lse=True)
    abs_err, rel_err = compare(what, lambda: out, lambda: ref, ATTN_TOL)
    lse_abs, lse_rel = compare(f"{what} lse", lambda: lse, lambda: ref_lse, ATTN_TOL)
    assert_reruns(what, lambda: flash_attention_bshd(q, k, v, h, return_lse=True))
    del out, lse, ref, ref_lse
    ms = cuda_ms(lambda: flash_attention_bshd(q, k, v, h))
    back_to_back_ms = burst_ms(lambda: flash_attention_bshd(q, k, v, h))
    plain_ms = cuda_ms(lambda: flash_attention_bshd_reference(q, k, v, h), warmup=1, iters=3)
    heads = [sdpa_heads(t, h) for t in (q, k, v)]
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(*heads))
    library_burst_ms = burst_ms(lambda: F.scaled_dot_product_attention(*heads))
    flops = 4 * b * sq * sk * inner
    bound_ms, bound_by = bound(2 * (2 * b * sq * inner + 2 * b * sk * inner), flops)
    print(f"{what}: out max abs err {abs_err:.3e} rel {rel_err:.3e}, lse max abs err "
          f"{lse_abs:.3e} rel {lse_rel:.3e} (tol {ATTN_TOL}), one launch, reruns bit-identical; "
          f"kernel {ms:.4f} ms one call ({flops / ms / 1e9:.1f} TFLOP/s, {100 * bound_ms / ms:.1f}% "
          f"of the bound), {back_to_back_ms:.4f} ms a call over 10 back to back "
          f"({flops / back_to_back_ms / 1e9:.1f} TFLOP/s); plain {plain_ms:.3f} ms; SDPA "
          f"{library_ms:.4f} ms one call (kernel {ms / library_ms:.2f}x), {library_burst_ms:.4f} "
          f"back to back; bound {bound_ms:.4f} ms ({bound_by})")
    del q, k, v, heads
    gc.collect()
    torch.cuda.empty_cache()
    return dict(shape=[b, sq, sk, inner, h], max_abs_err=abs_err, lse_max_abs_err=lse_abs, ms=ms,
                burst_ms=back_to_back_ms, tflops=flops / ms / 1e9, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                library_burst_ms=library_burst_ms)


def auraflow_phase(device, wrappers: dict, profile: bool) -> dict:
    """Phases 20 and 21, run in a process of its own (``--auraflow``):
    kernel B at head dim 256 and kernel F at AuraFlow's widths against their
    plain versions, then AuraFlow generate() at full width and depth, its
    launch counts, one denoise step against the plain versions and the
    single-file checkpoint. Returns the launch counts of the requests, the
    kernels' records at these shapes and the numbers."""
    from vision_ft_tpu_torch.models.auraflow.config import AuraFlowConig, DenoiserConfig
    from vision_ft_tpu_torch.models.auraflow.pipeline import AuraFlowModel
    from vision_ft_tpu_torch.models.text_encoders.sentencepiece import (
        SentencePieceModel, SentencePieceTokenizer,
    )
    from vision_ft_tpu_torch.models.text_encoders.umt5 import UMT5Config
    from vision_ft_tpu_torch.ops.flash_attention import forward_config
    from vision_ft_tpu_torch.ops.fused_mlp import gated_mlp, set_fused_ff
    from vision_ft_tpu_torch.utils import safetensors as st

    def reset_launches():
        for wrapper in wrappers.values():
            wrapper.launches = 0

    def read_launches():
        return {name: wrapper.launches for name, wrapper in wrappers.items()}

    def free(model):
        for part in model._parts().values():
            part.to("meta")
        gc.collect()
        torch.cuda.empty_cache()

    gen = torch.Generator(device=device).manual_seed(20)
    numbers, records = {}, {"flash_attention_bshd": [], "gated_mlp": []}

    phase("20 kernel B at head dim 256 and kernel F at C = 3072, AuraFlow's shapes, vs plain (bf16)")
    for d in (64, 128, 256):
        config = forward_config(d)
        print(f"kernel B at D = {d}: {config['keys']}-key tiles, {config['stages']} stages, "
              f"{config['passes']} pass(es) over O's columns, Smem::kBytes = {config['smem_bytes']} "
              "(a block may have 232448)")
    numbers["kernel_b_d256"] = forward_config(256)
    # what ptxas made of each instantiation (nvcc -Xptxas -v with the build's flags), on the
    # host while the card works
    from vision_ft_tpu_torch.tools.ptxas_report import ptxas_report

    ptxas_job = concurrent.futures.ThreadPoolExecutor(1).submit(ptxas_report, "flash_attention_bshd")
    for shape in AURA_ATTN_SHAPES:
        records["flash_attention_bshd"].append(bshd_forward_record(device, gen, *shape))
    for m, c, inner, act, with_biases in AURA_MLP_SHAPES:
        x, wa, wg, wd, (ba, bg, bd) = mlp_tensors(m, c, inner, with_biases, device, gen)
        up, down, full = mlp_parts(
            f"M={m} C={c} inner={inner} {act}", x, wa, wg, wd, ba, bg, bd, act,
            lambda: gated_mlp(x, wa, wg, wd, ba, bg, bd, act=act))
        records["gated_mlp"].append(dict(
            shape=[m, c, inner], max_abs_err=full[0], **full[1], up_ms=up[1]["ms"],
            up_max_abs_err=up[0], up_library_ms=up[1]["library_ms"], down_ms=down[1]["ms"],
            down_max_abs_err=down[0], down_library_ms=down[1]["library_ms"]))
        del x, wa, wg, wd
    gc.collect()
    torch.cuda.empty_cache()
    numbers["kernel_b_ptxas"] = {}
    for kernel, info in sorted(ptxas_job.result(timeout=600).items()):
        found = re.search(r"flash_fwd_bshd_kernelILi(\d+)E", kernel)
        if found:
            numbers["kernel_b_ptxas"][found.group(1)] = info
            print(f"kernel B at D = {found.group(1)}, ptxas: {info.get('registers')} registers a "
                  f"thread, {info.get('spill_stores')} bytes of spill stores, "
                  f"{info.get('spill_loads')} of spill loads, notes {info.get('notes')}")
    if set(numbers["kernel_b_ptxas"]) != {"64", "128", "256"}:
        raise AssertionError(f"ptxas reported no kernel B at some head dim: {numbers['kernel_b_ptxas']}")

    phase("21 AuraFlow generate() at full width, 4 double and 8 single of its 4 + 32 layers, bf16, "
          "seeded random weights")
    tokenizer = SentencePieceTokenizer(SentencePieceModel.from_bytes(lumina_vocab()), template="eos")

    class Model(AuraFlowModel):
        """Keeps the last latents generate() decoded, for the checks."""

        def decode_image(self, latents):
            self.last_latents = latents.clone()
            return super().decode_image(latents)

    def fill_zero_init(model, seed) -> int:
        return aura_fill_zero_init(model, device, seed)

    torch.cuda.reset_peak_memory_stats()
    model = Model(AuraFlowConig(checkpoint_path="", dtype="bfloat16",
                                denoiser=DenoiserConfig(**AURA_CUT_DEPTH)), tokenizer=tokenizer)
    start = time.perf_counter()
    model.init_params(torch.Generator(device=device).manual_seed(0))
    filled = fill_zero_init(model, 1)
    torch.cuda.synchronize()
    den = model.denoiser
    counts = [sum(p.numel() for p in part.parameters())
              for part in (den, model.text_encoder, model.vae)]
    n_double, n_single = len(den.double_layers), len(den.single_layers)
    inner_mlp = den.single_layers["0"]["mlp"]["c_proj"].in_features
    print(f"init on the card: {time.perf_counter() - start:.1f} s ({filled} zero-init tensors drawn "
          f"anew); MMDiT {counts[0] / 1e9:.3f} B, UMT5 {counts[1] / 1e9:.3f} B, VAE "
          f"{counts[2] / 1e6:.1f} M parameters; {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
          f"allocated. MMDiT: {n_double} double + {n_single} single layers, width {den.inner_dim}, "
          f"{den.config.num_attention_heads} heads of {den.config.attention_head_dim}, MLP inner "
          f"{inner_mlp}")

    def expected(steps, interval=None, cache_depth=None, fused=True):
        """(kernel B, kernel F) launches of one request, from the module tree
        and generate()'s DeepCache rule: every layer runs one attention
        (both CFG halves in one call), a double layer two MLPs, a single one."""
        shallow = cache_depth if cache_depth is not None else max(1, n_single // 4)
        attention = mlp = 0
        have_delta = False
        for i in range(steps):
            singles = shallow if interval and i % interval != 0 and have_delta else n_single
            have_delta = have_delta or bool(interval)
            attention += n_double + singles
            mlp += 2 * n_double + singles
        return attention, mlp if fused else 0

    launches_total = {name: 0 for name in wrappers}

    def request(name, want, **kwargs):
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        torch.cuda.synchronize()
        start = time.perf_counter()
        images = model.generate(**kwargs)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated() / 2**30
        latents, arrays = model.last_latents, [np.asarray(im) for im in images]
        print(f"request {name}: {len(images)} image(s) {images[0].size}, "
              f"{kwargs['num_inference_steps']} steps, CFG {kwargs['cfg_scale']}, {seconds:.3f} s, "
              f"peak {peak:.2f} GiB; launches kernel B {launches['flash_attention_bshd']}, kernel F "
              f"{launches['gated_mlp']} (each one F-up and one F-down launch), expected {want}")
        if not torch.isfinite(latents).all() or any(a.std() == 0 for a in arrays):
            raise AssertionError(f"request {name}: latents not finite, or a constant image")
        if images[0].size != (kwargs["width"], kwargs["height"]) or latents.shape[1:] != (
                kwargs["height"] // 8, kwargs["width"] // 8, 4):
            raise AssertionError(f"request {name}: wrong size {images[0].size}, {latents.shape}")
        counts = {name: 0 for name in wrappers}
        counts.update(flash_attention_bshd=want[0], gated_mlp=want[1])
        if launches != counts:
            raise AssertionError(f"request {name}: launch counts {launches} != {counts}")
        for kernel, n in launches.items():
            launches_total[kernel] += n
        return seconds, latents, arrays, peak

    base = dict(prompt="a photo of a cat sitting on the sofa", negative_prompt="blurry",
                width=1024, height=1024, cfg_scale=3.5, seed=1234, num_inference_steps=AURA_STEPS)
    runs = {}
    for name, kwargs in (("1 (cold)", base),
                         ("2", dict(base, prompt="a red car on the road in the mountains", seed=99)),
                         ("3 (= 1, warm)", base)):
        runs[name] = request(name, expected(AURA_STEPS), **kwargs)
    if not (torch.equal(runs["1 (cold)"][1], runs["3 (= 1, warm)"][1])
            and all(np.array_equal(x, y) for x, y in zip(runs["1 (cold)"][2], runs["3 (= 1, warm)"][2]))):
        raise AssertionError("request 3 (request 1 repeated, same seed) differs from it")
    seconds = [run[0] for run in runs.values()]
    numbers.update(first_request_s=seconds[0], warm_request_s=seconds[1:],
                   peak_gib=max(run[3] for run in runs.values()))
    print(f"s/request: {seconds[0]:.3f} cold (the first), {seconds[1]:.3f} and {seconds[2]:.3f} warm; "
          f"peak {numbers['peak_gib']:.2f} GiB; request 3 == request 1, bit for bit")
    cached = request("4 (deep_cache_interval 2)", expected(AURA_STEPS, interval=2),
                     **dict(base, deep_cache_interval=2))
    if torch.equal(cached[1], runs["1 (cold)"][1]):
        raise AssertionError("the DeepCache request equals request 1: the option did nothing")
    numbers["deep_cache_request_s"] = cached[0]
    set_fused_ff("off")
    try:
        off = request('5 (= 1, set_fused_ff("off"))', expected(AURA_STEPS, fused=False), **base)
    finally:
        set_fused_ff("auto")
    numbers["fused_ff_off_request_s"] = off[0]
    scale = runs["1 (cold)"][1].float().abs().max().item()
    drift = (off[1].float() - runs["1 (cold)"][1].float()).abs().max().item() / scale
    print(f"DeepCache request {cached[0]:.3f} s; with the fused feed-forward off {off[0]:.3f} s, its "
          f"latents {drift:.3e} of their largest value from request 1's (tol {ROUTE_REQUEST_TOL})")
    if drift > ROUTE_REQUEST_TOL:
        raise AssertionError('the "auto" request and the "off" request disagree')

    # one CFG denoise step at 1024 px, the kernels against their plain versions
    g21 = torch.Generator(device=device).manual_seed(21)
    step_latents = torch.randn(1, 128, 128, 4, device=device, generator=g21).bfloat16()
    _, sigmas = model.scheduler.schedule_tables(AURA_STEPS)

    def encode(m):
        with torch.inference_mode():
            out = m.text_encoder.encode_prompts("a photo of a cat", "blurry", use_negative_prompts=True)
            return torch.cat([out.positive_embeddings, out.negative_embeddings]).to(m.dtype)

    def denoise_step(m, embeddings):
        with torch.inference_mode():
            return m._denoise_step(step_latents, sigmas[3], sigmas[4], embeddings, 3.5, do_cfg=True)

    def velocity(m, embeddings):
        timestep = torch.full((2,), float(np.float32(sigmas[3])), device=device).bfloat16()
        with torch.inference_mode():
            v = m.denoiser(torch.cat([step_latents, step_latents]), embeddings, timestep).float()
        positive, negative = v.chunk(2)
        return negative + 3.5 * (positive - negative)

    embeddings = encode(model)
    step_ms = cuda_ms(lambda: denoise_step(model, embeddings), warmup=1, iters=5)
    reset_launches()
    kernel_step, kernel_velocity = denoise_step(model, embeddings), velocity(model, embeddings)
    step_launches = read_launches()
    with plain_versions():
        plain_step, plain_velocity = denoise_step(model, embeddings), velocity(model, embeddings)
    errors = {}
    for what, got, want in (("velocity", kernel_velocity, plain_velocity),
                            ("latents", kernel_step, plain_step)):
        errors[what] = (got.float() - want.float()).abs().max().item() / want.float().abs().max().item()
    numbers.update(step_ms=step_ms, step_velocity_err=errors["velocity"],
                   step_latents_err=errors["latents"])
    print(f"one CFG denoise step at 1024 px (batch 2, 4360 joint tokens): {step_ms:.1f} ms; "
          f"launches (step + velocity) kernel B {step_launches['flash_attention_bshd']}, kernel F "
          f"{step_launches['gated_mlp']}; against the plain versions of B and F: guided velocity "
          f"{errors['velocity']:.3e}, the step's latents {errors['latents']:.3e} of their largest "
          f"value (tol {AURA_STEP_TOL})")
    if step_launches["flash_attention_bshd"] != 2 * (n_double + n_single) or (
            step_launches["gated_mlp"] != 2 * (2 * n_double + n_single)):
        raise AssertionError(f"the denoise step's launches {step_launches}")
    if max(errors.values()) > AURA_STEP_TOL:
        raise AssertionError("the kernels' denoise step and the plain one disagree")
    del kernel_step, kernel_velocity, plain_step, plain_velocity
    if profile:
        kinds = profile_steps(lambda: denoise_step(model, embeddings), step_ms, "AuraFlow denoise step")
        print_kernel_ms(kinds, ("kernel B", "kernel F up", "kernel F down"), "AuraFlow denoise step")
        numbers["traced_step"] = {kind: [round(ms, 4), n] for kind, (ms, n) in kinds.items()}
    free(model)
    del model, embeddings

    # the single-file checkpoint at full width, reduced depth
    text_config = UMT5Config(num_layers=AURA_CKPT_TEXT_LAYERS)
    small = Model(AuraFlowConig(checkpoint_path="", dtype="bfloat16",
                                denoiser=DenoiserConfig(**AURA_CKPT_DEPTH)),
                  tokenizer=tokenizer, text_encoder_config=text_config)
    small.init_params(torch.Generator(device=device).manual_seed(2))
    fill_zero_init(small, 3)
    embeddings = encode(small)
    before = denoise_step(small, embeddings)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_auraflow_"))
    try:
        path = work / "auraflow.safetensors"
        torch.cuda.synchronize()
        start = time.perf_counter()
        st.save_file(small.state_dict(), path)
        numbers["checkpoint_write_s"] = time.perf_counter() - start
        numbers["checkpoint_bytes"] = path.stat().st_size
        start = time.perf_counter()
        loaded = Model.from_original_checkpoint(
            AuraFlowConig(checkpoint_path=str(path), dtype="bfloat16",
                          denoiser=DenoiserConfig(**AURA_CKPT_DEPTH)),
            tokenizer=tokenizer, text_encoder_config=text_config)
        torch.cuda.synchronize()
        numbers["checkpoint_load_s"] = time.perf_counter() - start
    finally:
        shutil.rmtree(work, ignore_errors=True)
    written, read = small.state_dict(), loaded.state_dict()
    if set(written) != set(read) or not all(torch.equal(written[k], read[k]) for k in written):
        raise AssertionError("the checkpoint loaded back differs from the model written")
    after = denoise_step(loaded, encode(loaded))
    if not torch.equal(before, after):
        raise AssertionError("the loaded checkpoint's denoise step differs from the written model's")
    print(f"single-file checkpoint (full width; {AURA_CKPT_DEPTH['num_double_layers']} double + "
          f"{AURA_CKPT_DEPTH['num_single_layers']} single layers, {AURA_CKPT_TEXT_LAYERS} UMT5 "
          f"layers): {numbers['checkpoint_bytes']} bytes, written by state_dict() in "
          f"{numbers['checkpoint_write_s']:.2f} s, loaded by from_original_checkpoint in "
          f"{numbers['checkpoint_load_s']:.2f} s; every tensor and the denoise step bit-identical")
    free(small)
    free(loaded)
    return {"launches": launches_total, "records": records, "numbers": numbers}


# Kernel C at AuraFlow's head dim 256 (phase 22), (B, Sq, Sk, H*D, H): the config-#3 step
# at batch 1 and 1024 px (8 register + 256 text + 4096 image tokens), the shortcut step's
# batch 2, the 832x1216 bucket (264 + 52 * 76), ragged Sq != Sk, one row and one key past
# a 64-row tile, a single q row; then the first again on strided q, k and v views
AURA_BWD_SHAPES = [(1, 4360, 4360, 3072, 12, False), (2, 4360, 4360, 3072, 12, False),
                   (1, 4216, 4216, 3072, 12, False), (1, 300, 520, 512, 2, False),
                   (1, 129, 129, 512, 2, False), (1, 1, 256, 512, 2, False),
                   (1, 4360, 4360, 3072, 12, True)]
# phase 23's images (width, height): batch 1, so one epoch is 4 steps; three in config #3's
# 1024x1024 bucket and one its buckets crop to another shape
AURA_TRAINER_IMAGES = [(1024, 1024)] * 3 + [(832, 1216)]
AURA_TRAINER_CAPTIONS = [
    "a photo of a cat, sofa, indoors",
    "a red car on the road, mountains, evening light, wide shot",
    "portrait of a woman, blue eyes",
    "a lighthouse on a cliff above the sea at dawn, waves, clouds, seagulls, film photo",
]
# phase 23's depth-reduced step against the plain versions: full width, 1 double + 2
# single layers of the trained model
AURA_REDUCED = dict(double_layers=1, single_layers=2)


def sdpa_backward_ms(q, k, v, dout, h):
    """PyTorch's own attention backward alone (dq, dk, dv in one call), the
    yardstick beside kernel C; None where it refuses the shape."""
    leaves = [sdpa_heads(t, h).detach().requires_grad_() for t in (q, k, v)]
    dout_heads = sdpa_heads(dout, h)
    try:
        out = F.scaled_dot_product_attention(*leaves)
        return cuda_ms(lambda: torch.autograd.grad(out, leaves, dout_heads, retain_graph=True))
    except RuntimeError as exc:
        print(f"SDPA's backward refused (B, H, S, D) {tuple(leaves[0].shape)}: {exc}")
        return None


def bshd_backward_records(device, gen, b, sq, sk, inner, h, strided) -> list:
    """Kernel C on seeded inputs (q, k and v column slices of one (B, S,
    3 H*D) tensor where ``strided``): one launch of each kernel, dq, dk
    and dv against the plain backward, reruns bit-identical, each kernel's
    time, TFLOP/s and bound, the whole backward with the plain delta
    beside SDPA's backward alone. Prints its line and returns the (dk/dv,
    dq) records."""
    from vision_ft_tpu_torch.ops.flash_attention import (
        flash_attention_bshd, flash_attention_bshd_backward,
        flash_attention_bshd_backward_reference, flash_attention_bshd_delta,
        flash_attention_bshd_dkv, flash_attention_bshd_dq,
    )

    dkv, dq = flash_attention_bshd_dkv, flash_attention_bshd_dq
    if strided:  # column slices of one (B, S, 3 H*D) tensor: rows 3 H*D apart
        q, k, v = torch.randn(b, sq, 3 * inner, device=device, generator=gen).bfloat16().split(
            inner, dim=-1)
    else:
        q = torch.randn(b, sq, inner, device=device, generator=gen).bfloat16()
        k, v = (torch.randn(b, sk, inner, device=device, generator=gen).bfloat16() for _ in "kv")
    dout = torch.randn(b, sq, inner, device=device, generator=gen).bfloat16()
    what = f"backward B={b} Sq={sq} Sk={sk} H={h} D={inner // h}{' strided' if strided else ''}"
    out, lse = flash_attention_bshd(q, k, v, h, return_lse=True)
    delta = flash_attention_bshd_delta(out, dout, h)
    before = (dkv.launches, dq.launches)
    got = flash_attention_bshd_backward(q, k, v, out, lse, dout, h)
    torch.cuda.synchronize()
    if (dkv.launches - before[0], dq.launches - before[1]) != (1, 1):
        raise AssertionError(f"{what}: {dkv.launches - before[0]} dk/dv and "
                             f"{dq.launches - before[1]} dq launches, not one each")
    want = flash_attention_bshd_backward_reference(q, k, v, out, lse, dout, h)
    err = {name: compare(f"{what} {name}", lambda: x, lambda: y, ATTN_BWD_TOL)
           for name, x, y in zip(("dq", "dk", "dv"), got, want)}
    del got, want
    assert_reruns(f"{what} dk/dv", lambda: dkv(q, k, v, dout, lse, delta, h))
    assert_reruns(f"{what} dq", lambda: dq(q, k, v, dout, lse, delta, h))
    times = {
        "dkv": (cuda_ms(lambda: dkv(q, k, v, dout, lse, delta, h)),
                burst_ms(lambda: dkv(q, k, v, dout, lse, delta, h))),
        "dq": (cuda_ms(lambda: dq(q, k, v, dout, lse, delta, h)),
               burst_ms(lambda: dq(q, k, v, dout, lse, delta, h))),
    }
    whole_ms = cuda_ms(lambda: flash_attention_bshd_backward(q, k, v, out, lse, dout, h))
    plain_ms = cuda_ms(lambda: flash_attention_bshd_backward_reference(q, k, v, out, lse, dout, h),
                       warmup=1, iters=3)
    library_ms = sdpa_backward_ms(q, k, v, dout, h)
    q_bytes, k_bytes, stat_bytes = b * sq * inner * 2, b * sk * inner * 2, 2 * b * h * sq * 4
    # dk/dv: S^T, dP^T, dV, dK (8 B Sq Sk H D); dq: S, dP, dQ (6 B Sq Sk H D). Bytes:
    # q, k, v, dO, lse and delta read once, the kernel's gradients written once
    bounds = {"dkv": bound(2 * q_bytes + 4 * k_bytes + stat_bytes, 8 * b * sq * sk * inner),
              "dq": bound(3 * q_bytes + 2 * k_bytes + stat_bytes, 6 * b * sq * sk * inner)}
    flops = {"dkv": 8 * b * sq * sk * inner, "dq": 6 * b * sq * sk * inner}
    print(f"{what}: " + ", ".join(f"{n} max abs err {a:.3e} rel {r:.3e}" for n, (a, r) in err.items())
          + f" (tol {ATTN_BWD_TOL}), one launch each, reruns bit-identical; "
          + "; ".join(f"{n} kernel {ms:.4f} ms one call ({flops[n] / ms / 1e9:.1f} TFLOP/s, "
                      f"{100 * bounds[n][0] / ms:.1f}% of its bound {bounds[n][0]:.4f} ms, "
                      f"{bounds[n][1]}), {burst:.4f} ms a call over 10 back to back"
                      for n, (ms, burst) in times.items())
          + f"; whole backward with the plain delta {whole_ms:.4f} ms"
          + (f" ({whole_ms / library_ms:.2f}x SDPA's backward alone, {library_ms:.4f} ms)"
             if library_ms else "")
          + f"; plain {plain_ms:.3f} ms")
    out_records = []
    for n in ("dkv", "dq"):
        errors = [err["dq"]] if n == "dq" else [err["dk"], err["dv"]]
        out_records.append(dict(
            shape=[b, sq, sk, inner, h], strided=strided,
            max_abs_err=max(a for a, _ in errors), rel_err=max(r for _, r in errors),
            ms=times[n][0], burst_ms=times[n][1], tflops=flops[n] / times[n][0] / 1e9,
            plain_ms=plain_ms, bound_ms=bounds[n][0], bound_by=bounds[n][1],
            library_ms=library_ms, whole_ms=whole_ms))
    del q, k, v, dout, out, lse, delta
    return out_records


def aura_backward_phase(device, wrappers: dict) -> tuple[dict, dict]:
    """Phase 22: kernel C at head dim 256 against its plain backward.
    Returns (records by kernel, numbers)."""
    from vision_ft_tpu_torch.tools.ptxas_report import ptxas_report

    phase("22 kernel C at head dim 256 (column halves), AuraFlow's shapes, vs the plain backward")
    numbers, records = {}, {"flash_attention_bshd_dkv": [], "flash_attention_bshd_dq": []}
    # ptxas's view of kernel C runs on the host while the card works
    ptxas_job = concurrent.futures.ThreadPoolExecutor(1).submit(
        ptxas_report, "flash_attention_bshd_bwd")
    gen = torch.Generator(device=device).manual_seed(22)
    for shape in AURA_BWD_SHAPES:
        dkv_record, dq_record = bshd_backward_records(device, gen, *shape)
        records["flash_attention_bshd_dkv"].append(dkv_record)
        records["flash_attention_bshd_dq"].append(dq_record)
    gc.collect()
    torch.cuda.empty_cache()
    ptxas = {}
    for kernel, info in sorted(ptxas_job.result(timeout=600).items()):
        if "flash_bwd_dkv_bshd_d256_kernel" in kernel:
            ptxas["dkv"] = info
        elif "flash_bwd_dq_bshd_kernelILi256E" in kernel:
            ptxas["dq"] = info
    for which, info in sorted(ptxas.items()):
        print(f"kernel C {which} at D = 256, ptxas: {info.get('registers')} registers a thread, "
              f"{info.get('spill_stores')} bytes of spill stores, {info.get('spill_loads')} of "
              f"spill loads, notes {info.get('notes')}")
    if set(ptxas) != {"dkv", "dq"}:
        raise AssertionError(f"ptxas reported no D = 256 kernel C: {sorted(ptxas)}")
    numbers["kernel_c_d256_ptxas"] = ptxas
    return records, numbers


def auraflow_trainer_phase(device, wrappers: dict, checkout: Path) -> dict:
    """Phases 22-24, run in a process of its own (``--auraflow-trainer``):
    kernel C at head dim 256 against its plain backward, then the AuraFlow
    Trainer on config #3 from a seeded single-file checkpoint at full width
    and depth, then the shortcut and RoPE migration workloads from the same
    file. Returns the Trainer runs' launch counts, kernel C's records at
    these shapes and the numbers."""
    import yaml
    from safetensors import safe_open

    from vision_ft_tpu_torch.config import TrainConfig
    from vision_ft_tpu_torch.models.auraflow.config import AuraFlowConig, DenoiserConfig
    from vision_ft_tpu_torch.models.auraflow.pipeline import AuraFlowModel
    from vision_ft_tpu_torch.models.auraflow.util import convert_to_comfy_key
    from vision_ft_tpu_torch.models.text_encoders.sentencepiece import (
        SentencePieceModel, SentencePieceTokenizer,
    )
    from vision_ft_tpu_torch.nn import remat_saves, set_remat_saves
    from vision_ft_tpu_torch.train.auraflow import rope_migration, shortcut, text_to_image
    from vision_ft_tpu_torch.training.optimizer import global_norm
    from vision_ft_tpu_torch.utils import safetensors as st

    def reset_launches():
        for wrapper in wrappers.values():
            wrapper.launches = 0

    def read_launches():
        return {name: wrapper.launches for name, wrapper in wrappers.items()}

    def free(model):
        for part in model._parts().values():
            part.to("meta")
        gc.collect()
        torch.cuda.empty_cache()

    def want(b=0, dkv_dq=0, f=0):
        counts = {name: 0 for name in wrappers}
        counts.update(flash_attention_bshd=b, flash_attention_bshd_dkv=dkv_dq,
                      flash_attention_bshd_dq=dkv_dq, gated_mlp=f)
        return counts

    def fused_mlps(den):
        """The gated MLPs kernel F takes ("auto": inner 8192): those with no
        adapter on any of their three Linears (the JAX package's gate).
        config #3's ".mlp." reaches the single layers' MLPs, not the double
        layers' mlpC and mlpX."""
        return sum(1 for m in den.modules() if type(m).__name__ == "AuraMLP"
                   and not any("lora_down" in layer._modules for layer in m.values()))

    def timed(fn, into):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            start = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            into.append(time.perf_counter() - start)
            return out
        return run

    def run_trainer(name, trainer):
        """trainer.train() with each step's host ms, loss, launches and
        batch, the checkpoint load's and the previews' seconds, the run's
        launches and peak memory."""
        log = dict(steps=[], load_s=[], preview_s=[], preview_launches=[], sanity_launches=[])
        trainer.model.setup_model = timed(trainer.model.setup_model, log["load_s"])

        def counted(fn, into):
            def run(*args, **kwargs):
                before = read_launches()
                out = fn(*args, **kwargs)
                after = read_launches()
                into.append({k: after[k] - before[k] for k in after})
                return out
            return run

        trainer.model.preview_step = counted(timed(trainer.model.preview_step, log["preview_s"]),
                                             log["preview_launches"])
        trainer.model.sanity_check = counted(trainer.model.sanity_check, log["sanity_launches"])
        prepare_optimizer = trainer.prepare_optimizer

        def prepare_and_time():
            prepare_optimizer()
            inner = trainer._step

            def timed_step(state, batch, generator):
                torch.cuda.synchronize()
                before = read_launches()
                start = time.perf_counter()
                state, metrics = inner(state, batch, generator)
                loss = metrics["train/loss"].item()
                torch.cuda.synchronize()
                after = read_launches()
                log["steps"].append((time.perf_counter() - start, loss,
                                     {k: after[k] - before[k] for k in after}, batch))
                return state, metrics

            trainer._step = timed_step

        trainer.prepare_optimizer = prepare_and_time
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        start = time.perf_counter()
        trainer.train()
        torch.cuda.synchronize()
        log.update(train_s=time.perf_counter() - start, launches=read_launches(),
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        losses = [loss for _, loss, _, _ in log["steps"]]
        print(f"{name}: trainer.train() {log['train_s']:.1f} s with the checkpoint load "
              f"{log['load_s'][0]:.2f} s{' and the preview %.2f s' % log['preview_s'][0] if log['preview_s'] else ''}; "
              f"{len(losses)} steps over batches {[tuple(b['pixel_values'].shape) for *_, b in log['steps']]}; "
              f"losses {losses}; ms a step {[round(t * 1e3, 1) for t, *_ in log['steps']]} (host "
              f"clock, synchronized, step 1 cold); peak {log['peak_gib']:.2f} GiB")
        if not losses or not all(np.isfinite(losses)):
            raise AssertionError(f"{name}: losses {losses}")
        return log

    def check_steps(name, log, per_step):
        for i, (_, _, launches, _) in enumerate(log["steps"]):
            if launches != per_step:
                raise AssertionError(f"{name} step {i + 1}: launches {launches} != {per_step}")

    def base_unchanged(name, model, ckpt, skip=()):
        live = model.state_dict()
        with safe_open(str(ckpt), framework="pt", device="cpu") as f:
            keys = [k for k in f.keys() if not k.startswith(skip)]
            changed = [k for k in keys if not torch.equal(live[k].cpu(), f.get_tensor(k))]
        if changed:
            raise AssertionError(f"{name}: frozen tensors changed: {changed[:3]}")
        return len(keys)

    records, numbers = aura_backward_phase(device, wrappers)
    tokenizer = SentencePieceTokenizer(SentencePieceModel.from_bytes(lumina_vocab()), template="eos")
    run_launches = {name: 0 for name in wrappers}
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_auraflow_trainer_"))
    try:
        phase("23 the AuraFlow Trainer on config #3 at full width, 4 double and 8 single of its "
              "4 + 32 layers: checkpoint, LoRA, saving, preview")
        img_rng = np.random.default_rng(0)
        folders = {name: work / name for name in ("images", "square", "rope")}
        for folder in folders.values():
            folder.mkdir()
        for i, (w, h) in enumerate(AURA_TRAINER_IMAGES + [(1024, 1024)]):
            smooth = img_rng.integers(0, 255, (h // 32, w // 32, 3), dtype=np.uint8)
            image = Image.fromarray(smooth).resize((w, h), Image.BILINEAR)
            caption = AURA_TRAINER_CAPTIONS[i % len(AURA_TRAINER_CAPTIONS)]
            targets = ([folders["images"]] if i < len(AURA_TRAINER_IMAGES) else []) + (
                [folders["square"]] if (w, h) == (1024, 1024) else []) + (
                [folders["rope"]] if i < 3 else [])
            for folder in targets:
                image.save(folder / f"{i}.png")
                (folder / f"{i}.txt").write_text(caption)

        # the checkpoint: phase 21's AuraFlow, seeded, written by state_dict()
        seeded = AuraFlowModel(AuraFlowConig(checkpoint_path="", dtype="bfloat16",
                                             denoiser=DenoiserConfig(**AURA_CUT_DEPTH)),
                               tokenizer=tokenizer)
        seeded.init_params(torch.Generator(device=device).manual_seed(23))
        aura_fill_zero_init(seeded, device, 24)
        ckpt = work / "auraflow.safetensors"
        torch.cuda.synchronize()
        start = time.perf_counter()
        st.save_file(seeded.state_dict(), ckpt)
        numbers["checkpoint_write_s"] = time.perf_counter() - start
        numbers["checkpoint_bytes"] = ckpt.stat().st_size
        free(seeded)
        del seeded

        raw = yaml.safe_load((checkout / "configs/auraflow/text_to_image_lora.yml").read_text())
        raw["model"].update(checkpoint_path=str(ckpt), denoiser=dict(AURA_CUT_DEPTH))
        raw["dataset"].update(folder=str(folders["images"]))
        raw["num_train_epochs"] = 1
        raw["saving"]["callbacks"][0]["save_dir"] = str(work / "lora")
        raw["preview"]["callbacks"][0]["save_dir"] = str(work / "preview")
        raw["preview"]["data"]["path"] = str(checkout / "configs/auraflow/preview.yml")
        config = TrainConfig.model_validate(raw, strict=True)
        print(f"checkpoint {numbers['checkpoint_bytes']} bytes (MMDiT, UMT5, VAE) written by "
              f"state_dict() in {numbers['checkpoint_write_s']:.2f} s; config #3 cut to one epoch of "
              f"{len(AURA_TRAINER_IMAGES)} images: {config.optimizer.name} {config.optimizer.args}, "
              f"LoRA rank {config.peft.config.rank} on {config.peft.include_keys}, batch "
              f"{config.dataset['batch_size']}, buckets from {config.dataset['bucket_base_size']} "
              f"step {config.dataset['step']}, gradient checkpointing "
              f"{config.trainer.gradient_checkpointing}; preview configs/auraflow/preview.yml")
        trainer = text_to_image.build_trainer(config, tokenizer=tokenizer)
        log = run_trainer("config #3", trainer)
        model = trainer.model.model
        den = model.denoiser
        layers = len(den.double_layers) + len(den.single_layers)
        mlps = fused_mlps(den)
        numbers.update(checkpoint_load_s=log["load_s"][0], preview_s=log["preview_s"][0],
                       peak_gib=log["peak_gib"], run_step_ms=[t * 1e3 for t, *_ in log["steps"]])
        if len(log["steps"]) != len(AURA_TRAINER_IMAGES):
            raise AssertionError(f"config #3: {len(log['steps'])} steps")
        # the Trainer's remat saves ("activations", the default): the recompute takes
        # the forward's (out, lse) back, so a step launches B once and C's two kernels
        # once per attention; F's output is kept too, so it runs in the forward only
        # (with "kernel" it runs again in the recompute; its backward is the plain formula)
        recompute_f = 0 if remat_saves() == "activations" else 1
        check_steps("config #3", log, want(layers, layers, (1 + recompute_f) * mlps))
        preview_steps = yaml.safe_load(Path(raw["preview"]["data"]["path"]).read_text())[0]["num_steps"]
        # CFG: both halves in one call per layer
        preview_want = want(preview_steps * layers, 0, preview_steps * mlps)
        if log["preview_launches"] != [preview_want]:
            raise AssertionError(f"preview launches {log['preview_launches']} != {preview_want}")
        # the sanity check's 8x8 latent: 30 joint tokens take the plain attention (Sk < 256)
        sanity_want = want(0, 0, mlps)
        if log["sanity_launches"] != [sanity_want]:
            raise AssertionError(f"sanity check launches {log['sanity_launches']} != {sanity_want}")
        step_sum = {k: sum(l[k] for _, _, l, _ in log["steps"]) for k in wrappers}
        if log["launches"] != {k: step_sum[k] + preview_want[k] + sanity_want[k] for k in wrappers}:
            raise AssertionError(f"config #3 run launches {log['launches']}")
        for k in wrappers:
            run_launches[k] += log["launches"][k]
        print(f"launches a step {log['steps'][0][2]} ({layers} attentions; kernel F on the "
              f"{mlps} MLPs without an adapter, forward and recompute), the preview's "
              f"{log['preview_launches'][0]}, the sanity check's {log['sanity_launches'][0]}; the "
              f"run {log['launches']}")
        n_base = base_unchanged("config #3", model, ckpt)
        moved = [k for k, v in trainer.trainable.items() if "lora_up" in k and bool(v.abs().max() > 0)]
        n_up = sum("lora_up" in k for k in trainer.trainable)
        saved = sorted((work / "lora").glob("*.safetensors"))
        lora_state = st.load_file(saved[-1]) if saved else {}
        alphas = {k for k, _ in trainer.model.get_params().named_buffers() if k.endswith(".alpha")}
        want_keys = {convert_to_comfy_key(k) for k in (*trainer.trainable, *alphas)}
        if len(saved) != 1 or set(lora_state) != want_keys or not all(
                k.startswith("diffusion_model.") for k in lora_state) or len(moved) != n_up:
            raise AssertionError(f"saved LoRA {saved}: {len(lora_state)} keys, expected "
                                 f"{len(want_keys)}; lora_up moved {len(moved)} of {n_up}")
        previews = sorted((work / "preview").glob("*"))
        if len(previews) != 1 or Image.open(previews[0]).size != (1024, 1024) or np.asarray(
                Image.open(previews[0])).std() == 0:
            raise AssertionError(f"preview images {previews}")
        print(f"{n_base} base tensors bit-identical to the checkpoint file; {len(moved)} of {n_up} "
              f"lora_up moved off zero; saved {saved[-1].name}: {len(lora_state)} keys in ComfyUI "
              f"names (diffusion_model.*); preview {previews[0].name} "
              f"{Image.open(previews[0]).size}, {log['preview_s'][0]:.2f} s")

        # warm steps on the 1024x1024 batch, then one with nothing kept by the checkpoints
        square = next(b for *_, b in log["steps"] if tuple(b["pixel_values"].shape[1:3]) == (1024, 1024))
        warm = []
        for seed in (5, 6, 7):
            trainer.state, _ = trainer._step(trainer.state, square,
                                             torch.Generator(device=device).manual_seed(seed))
            warm.append(log["steps"][-1][0] * 1e3)
        numbers["warm_step_ms"] = warm
        trainer_saves = remat_saves()
        set_remat_saves("none")
        try:
            trainer.state, _ = trainer._step(trainer.state, square,
                                             torch.Generator(device=device).manual_seed(8))
        finally:
            set_remat_saves(trainer_saves)
        if log["steps"][-1][2] != want(2 * layers, layers, 2 * mlps):
            raise AssertionError(f"a step with remat saves none: {log['steps'][-1][2]}")
        print(f"warm steps at 1024x1024, batch 1: {[round(t, 1) for t in warm]} ms; a step with "
              f"remat saves none launches {log['steps'][-1][2]['flash_attention_bshd']} of kernel B "
              f"(forward and recompute) and {layers} of each of C's")

        # a depth-reduced step (full width) of the trained model, kernels vs plain versions
        full = den.double_layers, den.single_layers
        den.double_layers = torch.nn.ModuleDict(
            {str(i): full[0][str(i)] for i in range(AURA_REDUCED["double_layers"])})
        den.single_layers = torch.nn.ModuleDict(
            {str(i): full[1][str(i)] for i in range(AURA_REDUCED["single_layers"])})

        def kept(key):
            parts = key.split(".")
            return parts[1] not in AURA_REDUCED or int(parts[2]) < AURA_REDUCED[parts[1]]

        params = [p for k, p in trainer.trainable.items() if kept(k)]

        def loss_and_grads():
            loss, _ = trainer.model.loss_fn(square, torch.Generator(device=device).manual_seed(9))
            return loss.item(), torch.autograd.grad(loss, params)

        try:
            reset_launches()
            kernel_loss, kernel_grads = loss_and_grads()
            used = read_launches()
            with plain_versions():
                plain_loss, plain_grads = loss_and_grads()
        finally:
            den.double_layers, den.single_layers = full
        kernel_norm, plain_norm = global_norm(kernel_grads).item(), global_norm(plain_grads).item()
        loss_rel = abs(kernel_loss - plain_loss) / abs(plain_loss)
        norm_rel = abs(kernel_norm - plain_norm) / abs(plain_norm)
        reduced = sum(AURA_REDUCED.values())
        den.double_layers, den.single_layers = (torch.nn.ModuleDict(
            {str(i): full[j][str(i)] for i in range(AURA_REDUCED[name])})
            for j, name in enumerate(("double_layers", "single_layers")))
        reduced_mlps = fused_mlps(den)
        den.double_layers, den.single_layers = full
        print(f"depth-reduced step ({AURA_REDUCED}, full width), kernels vs plain versions: loss "
              f"{kernel_loss:.6f} vs {plain_loss:.6f} (rel {loss_rel:.3e}, tol {STEP_LOSS_TOL}); "
              f"grad_norm {kernel_norm:.6f} vs {plain_norm:.6f} (rel {norm_rel:.3e}, tol "
              f"{STEP_GRAD_NORM_TOL}); kernel launches B {used['flash_attention_bshd']}, C "
              f"{used['flash_attention_bshd_dkv']} + {used['flash_attention_bshd_dq']}, F "
              f"{used['gated_mlp']}")
        if read_launches() != used or used != want(reduced, reduced,
                                                   (1 + recompute_f) * reduced_mlps):
            raise AssertionError(f"the reduced step's launches: {used}, then {read_launches()}")
        if not (loss_rel <= STEP_LOSS_TOL and norm_rel <= STEP_GRAD_NORM_TOL):
            raise AssertionError("the AuraFlow trainer's kernel step and the plain step disagree")
        del kernel_grads, plain_grads, params, square, log
        free(model)
        del model, den, trainer
        gc.collect()
        torch.cuda.empty_cache()

        phase("24 the shortcut and RoPE migration workloads from the same file, full width, 4 + 8 "
              "layers")
        raw = yaml.safe_load((checkout / "configs/auraflow/shortcut.yml").read_text())
        raw["model"].update(checkpoint_path=str(ckpt), denoiser=dict(AURA_CUT_DEPTH))
        raw["dataset"].update(folder=str(folders["square"]))
        raw["num_train_epochs"] = 1
        raw["saving"]["callbacks"][0]["save_dir"] = str(work / "shortcut")
        config = TrainConfig.model_validate(raw, strict=True)
        trainer = shortcut.build_trainer(config, tokenizer=tokenizer)
        log = run_trainer(f"shortcut (configs/auraflow/shortcut.yml: batch "
                          f"{config.dataset['batch_size']}, {config.optimizer.name})", trainer)
        den = trainer.model.model.denoiser
        layers = len(den.double_layers) + len(den.single_layers)
        # two forwards for the self-consistency targets (no gradient), one trained;
        # shortcut.yml's "mlp" puts adapters on every MLP, so F runs on none
        mlps = fused_mlps(den)
        check_steps("shortcut", log, want(3 * layers, layers, (3 + recompute_f) * mlps))
        embedder = {k: v for k, v in trainer.trainable.items() if ".shortcut_embedder." in k}
        moved = [k for k, v in embedder.items() if bool(v.abs().max() > 0)]
        if not embedder or not moved:
            raise AssertionError(f"the shortcut embedder did not train: {sorted(embedder)}")
        base_unchanged("shortcut", trainer.model.model, ckpt)
        for k in wrappers:
            run_launches[k] += log["launches"][k]
        numbers["shortcut"] = dict(step_ms=[t * 1e3 for t, *_ in log["steps"]],
                                   peak_gib=log["peak_gib"], load_s=log["load_s"][0])
        print(f"shortcut: launches a step {log['steps'][0][2]['flash_attention_bshd']} of kernel B "
              f"(two target forwards and the trained one) and {layers} of each of C's; the shortcut "
              f"embedder trainable ({len(embedder)} tensors), moved off zero: {moved}")
        free(trainer.model.model)
        del trainer, den, log
        gc.collect()
        torch.cuda.empty_cache()

        raw = yaml.safe_load((checkout / "configs/auraflow/text_to_image_lora.yml").read_text())
        raw["model"].update(checkpoint_path=str(ckpt), denoiser={"use_rope": True, **AURA_CUT_DEPTH},
                            migration_loss=True, noise_prediction_loss=True)
        raw["dataset"].update(folder=str(folders["rope"]))
        raw["num_train_epochs"] = 1
        raw["saving"]["callbacks"][0]["save_dir"] = str(work / "rope")
        raw.pop("preview")
        config = TrainConfig.model_validate(raw, strict=True)
        trainer = rope_migration.build_trainer(config, tokenizer=tokenizer)
        log = run_trainer("RoPE migration (configs/auraflow/text_to_image_lora.yml with "
                          "denoiser.use_rope and the workload's fields)", trainer)
        den = trainer.model.model.denoiser
        layers = len(den.double_layers) + len(den.single_layers)
        check_steps("RoPE migration", log, want(layers, layers, (1 + recompute_f) * fused_mlps(den)))
        scale = den.migration_scale.scale.detach().float().cpu()
        if "denoiser.migration_scale.scale" not in trainer.trainable or not bool(scale.abs().max() > 0):
            raise AssertionError(f"the migration scale did not train: {scale}")
        base_unchanged("RoPE migration", trainer.model.model, ckpt)
        for k in wrappers:
            run_launches[k] += log["launches"][k]
        numbers["rope_migration"] = dict(step_ms=[t * 1e3 for t, *_ in log["steps"]],
                                         peak_gib=log["peak_gib"], load_s=log["load_s"][0],
                                         scale=scale.tolist())
        print(f"RoPE migration: launches a step {log['steps'][0][2]['flash_attention_bshd']} of "
              f"kernel B and of each of C's; the migration scale moved off zero to "
              f"{scale.tolist()}")
        free(trainer.model.model)
        del trainer, den, log
    finally:
        shutil.rmtree(work, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": run_launches, "records": records, "numbers": numbers}


def write_yaml(path, model_config):
    """A TrainConfig YAML whose model section is ``model_config``."""
    import yaml

    path.write_text(yaml.safe_dump({
        "model": model_config, "dataset": {},
        "optimizer": {"name": "torch.optim.AdamW", "args": {"lr": 1.0e-4}},
        "seed": 0, "num_train_epochs": 1}))


def serving(batcher):
    """The port's HTTP handler on 127.0.0.1 at an ephemeral port: (server, url)."""
    import threading
    from http.server import ThreadingHTTPServer

    from vision_ft_tpu_torch.tools import inference_server as srv

    server = ThreadingHTTPServer(("127.0.0.1", 0), srv.make_handler(batcher))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, f"http://127.0.0.1:{server.server_address[1]}/predict"


def post_all(url, bodies, delays=None, gate=None):
    """Each body from its own thread (after its delay, or once ``gate(i)``
    holds); returns (replies, seconds from the first post to the last
    reply). A reply is (webp bytes, seconds)."""
    import threading

    from vision_ft_tpu_torch.tools.inference_client import predict

    replies, errors = [None] * len(bodies), []

    def run(i):
        try:
            if delays:
                time.sleep(delays[i])
            if gate is not None:
                while not gate(i):
                    time.sleep(0.005)
            replies[i] = predict(url, bodies[i], timeout=600)
        except Exception as exc:  # reported below
            errors.append(f"request {i}: {exc!r}")

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(bodies))]
    start = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=900)
    seconds = time.perf_counter() - start
    if errors or any(r is None for r in replies):
        raise AssertionError(f"unanswered requests: {errors}")
    return replies, seconds


def webp_size(data):
    """A reply's (width, height); fails unless it is a webp of some contrast."""
    image = Image.open(io.BytesIO(data))
    if image.format != "WEBP":
        raise AssertionError(f"a reply is {image.format}, not webp")
    array = np.asarray(image.convert("RGB"))
    if array.std() == 0:
        raise AssertionError("a reply is a constant image")
    return image.size


def tap_pool(sched, wrappers: dict):
    """Each finished request's latents by its seed, and each tick's
    launches and card time (CUDA events around the slot step)."""
    def read_launches():
        return {name: wrapper.launches for name, wrapper in wrappers.items()}

    engine = sched._engine
    kept, ticks = {}, []
    decode, step = engine.adapter.decode, engine.adapter.slot_step

    def tapped_decode(row):
        j = row.storage_offset() // row.numel()
        kept[engine._pending_by_slot[j].request.seed] = row.float().clone()
        return decode(row)

    def tapped_step(*args):
        before = read_launches()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = step(*args)
        end.record()
        after = read_launches()
        ticks.append(dict(active=int(engine._active.sum()), events=(start, end),
                          launches={k: after[k] - before[k] for k in after
                                    if after[k] != before[k]}))
        return out

    engine.adapter.decode, engine.adapter.slot_step = tapped_decode, tapped_step
    return kept, ticks


def tick_report(label, ticks, want):
    """Fails unless every tick launched ``want``; the card's ms a tick."""
    torch.cuda.synchronize()
    ms = [s.elapsed_time(e) for s, e in (t["events"] for t in ticks)]
    bad = [t["launches"] for t in ticks if t["launches"] != want]
    by_active = {}
    for t, m in zip(ticks, ms):
        by_active.setdefault(t["active"], []).append(m)
    summary = {k: statistics.median(v) for k, v in sorted(by_active.items())}
    print(f"{label}: {len(ticks)} ticks, each launching {want} (the module tree's count); "
          f"card ms a tick by active slots (median): "
          + ", ".join(f"{k} active {v:.1f} ms" for k, v in summary.items()))
    if bad:
        raise AssertionError(f"{label}: ticks launched {bad[:3]}, expected {want} each")
    return dict(ticks=len(ticks), tick_ms_by_active=summary, tick_ms_median=statistics.median(ms))


def generate_latents(model, **kwargs):
    """The final latents of batch-1 generate() (as the pool's: fp32 copies)."""
    kept = {}
    decode = model.decode_image
    model.decode_image = lambda z, *a, **kw: kept.setdefault("z", z.float().clone()) is None or \
        decode(z, *a, **kw)
    try:
        model.generate(**kwargs)
    finally:
        del model.decode_image
    return kept["z"][0]


def hold_pool(label, kept, model, requests):
    """Each pool result against the same request through batch-1 generate()."""
    errs = []
    for kwargs in requests:
        want = generate_latents(model, **kwargs)
        got = kept[kwargs["seed"]]
        if not torch.isfinite(got).all():
            raise AssertionError(f"{label} seed {kwargs['seed']}: pool latents not finite")
        err = (got - want).abs().max().item() / want.abs().max().item()
        errs.append(err)
        print(f"{label}, seed {kwargs['seed']} ({kwargs['num_inference_steps']} steps): pool vs "
              f"batch-1 generate() max abs err / max |latents| {err:.3e} "
              f"(tol {POOL_REQUEST_TOL})")
    if max(errs) > POOL_REQUEST_TOL:
        raise AssertionError(f"{label}: pool vs batch-1 {max(errs):.3e} > {POOL_REQUEST_TOL}")
    return errs


# the serving phases (25-27, ``--serve``): a pool of 4 CFG slots is batch 8 on a denoiser
SERVE_SLOTS = 4
# a pool's request against the same request through batch-1 generate(), both bf16
# on the card: the same kernels and arithmetic at batch 8 against batch 2, where
# cuBLAS and cuDNN may pick other algorithms and sum in another order; every step
# carries those bf16 ulps on, the ancestral steps through random-weight denoisers
# (measured as each run prints it); relative to the latents' largest value
POOL_REQUEST_TOL = 5e-2
# the 6-request staggered SDXL trace: (arrival s, steps, seed, cfg, cfg_rescale); 8 and 12
# steps before phases 43-46
SDXL_TRACE = [(0.0, 4, 101, 5.0, 0.0), (0.3, 6, 102, 4.0, 0.0), (0.6, 4, 103, 6.0, 0.7),
              (0.9, 6, 104, 5.0, 0.0), (1.2, 4, 105, 3.0, 0.0), (1.5, 6, 106, 5.0, 0.0)]
SERVE_ATTN_SHAPES = [(8, 4096, 640, 10), (8, 1024, 1280, 20)]  # the UNet's stages, pool of 4
SERVE_LN_SHAPES = [(8 * 4096, 640, True), (8 * 1024, 1280, True)]
SERVE_MASKED_SHAPE = (8, 24, 8, 4352, 96)  # the NextDiT's main stack, pool of 4
SERVE_LUMINA_MLP = [(8 * 4352, 2304, 9216)]
SERVE_AURA_ATTN = (8, 4360, 3072, 12)  # the MMDiT's joint sequence, pool of 4
SERVE_AURA_MLP = [(8 * 4360, 3072, 8192), (8 * 4096, 3072, 8192), (8 * 264, 3072, 8192)]
# the Lumina2 Trainer's and server's denoisers (phases 19 and 26) and the AuraFlow server's
# (phase 27) at full width and reduced depth (full depth before the Wan phases joined the
# run; phases 14 and 23-24 train at full depth): the NextDiT's 8 of 26 layers with both
# refiners; the MMDiT's 4 double layers and 8 of its 32 single ones
LUMINA_CUT_DEPTH = dict(depth=8)
AURA_CUT_DEPTH = dict(num_double_layers=4, num_single_layers=8)


def serve_phase(device, wrappers: dict) -> dict:
    """Phases 25-27, run in a process of its own (``--serve``): the port's
    HTTP server, scheduler and CLI at full width on seeded single-file
    checkpoints of SDXL, Lumina2 (config #4) and AuraFlow (config #3):
    kernels B, A, E and F against their plain versions at the pool's batch-8
    shapes, the window and continuous schedulers through the client, each
    pool result against the same request through batch-1 generate(), launch
    counts a tick, SDXL DeepCache, a tiled 1536 px decode and the CLI on an
    NF4 base. Returns the served paths' launch counts, the kernels' records
    at these shapes and the numbers."""
    from vision_ft_tpu_torch.models.auraflow.config import AuraFlowConig
    from vision_ft_tpu_torch.models.auraflow.config import DenoiserConfig as AuraDenoiserConfig
    from vision_ft_tpu_torch.models.auraflow.pipeline import AuraFlowModel
    from vision_ft_tpu_torch.models.lumina2.config import Lumina2Config
    from vision_ft_tpu_torch.models.lumina2.config import DenoiserConfig as LuminaDenoiserConfig
    from vision_ft_tpu_torch.models.lumina2.pipeline import Lumina2
    from vision_ft_tpu_torch.models.sdxl.config import DenoiserConfig as SDXLDenoiserConfig
    from vision_ft_tpu_torch.models.sdxl.config import SDXLConfig
    from vision_ft_tpu_torch.models.sdxl.denoiser import Denoiser as SDXLDenoiser
    from vision_ft_tpu_torch.models.sdxl.pipeline import SDXLModel
    from vision_ft_tpu_torch.nn import Linear
    from vision_ft_tpu_torch.ops import nf4_matmul as nf4_ops
    from vision_ft_tpu_torch.ops.flash_attention import (
        flash_attention_bshd, flash_attention_bshd_reference, flash_attention_masked,
        flash_attention_reference,
    )
    from vision_ft_tpu_torch.ops.fused_mlp import gated_mlp
    from vision_ft_tpu_torch.ops.layer_norm import layer_norm, layer_norm_reference
    from vision_ft_tpu_torch.tools import inference_cli
    from vision_ft_tpu_torch.tools import inference_server as srv
    from vision_ft_tpu_torch.utils import safetensors as st

    gen = torch.Generator(device=device).manual_seed(25)
    numbers = {}
    records = {"flash_attention_bshd": [], "layer_norm": [], "flash_attention_masked": [],
               "gated_mlp": []}
    path_launches = {name: 0 for name in wrappers}

    def read_launches():
        return {name: wrapper.launches for name, wrapper in wrappers.items()}

    @contextlib.contextmanager
    def on_path(into=None):
        """A served path's launches: added to the process's path counts (and
        to ``into``); launches to compare kernels with plain run outside."""
        before = read_launches()
        yield
        for name, count in read_launches().items():
            path_launches[name] += count - before[name]
            if into is not None:
                into[name] = into.get(name, 0) + count - before[name]

    def free(model):
        for part in model._parts().values():
            part.to("meta")
        gc.collect()
        torch.cuda.empty_cache()

    def peak_gib():
        return torch.cuda.max_memory_allocated() / 2**30

    def checkpoint(model, path, into):
        torch.cuda.synchronize()
        start = time.perf_counter()
        st.save_file(model.state_dict(), path)
        numbers[f"{into}_checkpoint_write_s"] = time.perf_counter() - start
        numbers[f"{into}_checkpoint_bytes"] = path.stat().st_size
        free(model)

    def attention_record(b, s, inner, h):
        q, k, v = (torch.randn(b, s, inner, device=device, generator=gen).bfloat16() for _ in "qkv")
        what = f"kernel B at the pool's (B={b}, S={s}, H={h}, D={inner // h})"
        abs_err, rel_err = compare(what, lambda: flash_attention_bshd(q, k, v, h),
                                   lambda: flash_attention_bshd_reference(q, k, v, h), ATTN_TOL)
        assert_reruns(what, lambda: flash_attention_bshd(q, k, v, h))
        ms = cuda_ms(lambda: flash_attention_bshd(q, k, v, h))
        plain_ms = cuda_ms(lambda: flash_attention_bshd_reference(q, k, v, h), warmup=1, iters=3)
        heads = [sdpa_heads(t, h) for t in (q, k, v)]
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(*heads))
        flops = 4 * b * s * s * inner
        bound_ms, bound_by = bound(2 * 4 * b * s * inner, flops)
        print(f"{what}: max abs err {abs_err:.3e} rel {rel_err:.3e} (tol {ATTN_TOL}), reruns "
              f"bit-identical; kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain "
              f"{plain_ms:.3f} ms, SDPA {library_ms:.4f} ms (kernel {ms / library_ms:.2f}x), bound "
              f"{bound_ms:.4f} ms ({bound_by})")
        records["flash_attention_bshd"].append(dict(
            shape=[b, s, s, inner, h], max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms))

    def mlp_record(m, c, inner):
        x, wa, wg, wd, (ba, bg, bd) = mlp_tensors(m, c, inner, False, device, gen)
        _, _, full = mlp_parts(f"at the pool's M={m} C={c} inner={inner} silu", x, wa, wg, wd,
                               ba, bg, bd, "silu",
                               lambda: gated_mlp(x, wa, wg, wd, ba, bg, bd, act="silu"))
        records["gated_mlp"].append(dict(shape=[m, c, inner], max_abs_err=full[0], **full[1]))

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_serve_"))
    try:
        # -- 25: SDXL --------------------------------------------------------------------
        phase("25 SDXL served at full width: the window and continuous schedulers through the "
              "client, DeepCache, a tiled 1536 px decode, the CLI on an NF4 base")
        for b, s, inner, h in SERVE_ATTN_SHAPES:
            attention_record(b, s, inner, h)
        for n_rows, c, beta in SERVE_LN_SHAPES:
            x, w, bias = ln_inputs(n_rows, c, beta, device, gen)
            what = f"kernel A at the pool's rows={n_rows} C={c}"
            abs_err, rel_err = compare(what, lambda: layer_norm(x, w, bias),
                                       lambda: layer_norm_reference(x, w, bias), LN_TOL)
            assert_reruns(what, lambda: layer_norm(x, w, bias))
            ms = cuda_ms(lambda: layer_norm(x, w, bias))
            plain_ms = cuda_ms(lambda: layer_norm_reference(x, w, bias))
            library_ms = cuda_ms(lambda: F.layer_norm(x, (c,), w, bias))
            bound_ms, bound_by = bound(2 * x.numel() * 2 + 2 * c * 2, 8 * x.numel(),
                                       PEAK_FP32_FLOPS)
            print(f"{what}: max abs err {abs_err:.3e} rel {rel_err:.3e} (tol {LN_TOL}), reruns "
                  f"bit-identical; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, F.layer_norm "
                  f"{library_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by})")
            records["layer_norm"].append(dict(shape=[n_rows, c], max_abs_err=abs_err, ms=ms,
                                              plain_ms=plain_ms, bound_ms=bound_ms,
                                              bound_by=bound_by, library_ms=library_ms))
            del x, w, bias

        write_vocab(work)
        seeded = SDXLModel(SDXLConfig(checkpoint_path="", dtype="bfloat16"))
        seeded.init_params(torch.Generator(device=device).manual_seed(25))
        unet_attn = sum(type(m).__name__ == "SelfAttention" for m in seeded.denoiser.modules())
        unet_ln = sum(type(m).__name__ == "LayerNorm" for m in seeded.denoiser.modules())
        checkpoint(seeded, work / "sdxl.safetensors", "sdxl")
        del seeded
        write_yaml(work / "sdxl.yml", {"checkpoint_path": str(work / "sdxl.safetensors"),
                                       "dtype": "bfloat16"})
        start = time.perf_counter()
        served = srv.T2IModel(str(work / "sdxl.yml"), None, str(work), family="sdxl")
        srv.prepare_kernels("sdxl", device)
        numbers["sdxl_load_s"] = time.perf_counter() - start
        model = served.model
        print(f"checkpoint {numbers['sdxl_checkpoint_bytes']} bytes written in "
              f"{numbers['sdxl_checkpoint_write_s']:.2f} s; T2IModel from the YAML (load + kernel "
              f"libraries) {numbers['sdxl_load_s']:.2f} s; {unet_attn} self-attentions and "
              f"{unet_ln} LayerNorms a UNet forward")
        per_forward = {"flash_attention_bshd": unet_attn, "layer_norm": unet_ln}
        with on_path():  # a 1-step warm-up: the process's first convolutions and GEMMs
            model.generate("a photo of the cat", negative_prompt="blurry", width=1024,
                           height=1024, num_inference_steps=1, cfg_scale=5.0, seed=0)

        # the window scheduler: 4 concurrent compatible requests, then an incompatible one
        calls = []
        generate = model.generate
        model.generate = lambda **kw: calls.append(
            (len(kw["prompt"]), kw["width"], kw["height"])) or generate(**kw)
        batcher = srv.MicroBatcher(served, max_batch=4, window_ms=2000)
        server, url = serving(batcher)
        compatible = [dict(prompt=f"a photo of the cat {x}", negative_prompt="blurry", width=1024,
                           height=1024, inference_steps=STEPS, cfg_scale=5.0) for x in "abcd"]
        odd = dict(prompt="a red car on the road", negative_prompt="blurry", width=832,
                   height=1216, inference_steps=STEPS, cfg_scale=5.0, seed=7)
        window = {}
        torch.cuda.reset_peak_memory_stats()
        with on_path(window):
            replies, seconds = post_all(url, compatible + [odd],
                                        gate=lambda i: i < 4 or len(calls) >= 1)
        sizes = [webp_size(data) for data, _ in replies]
        if calls != [(4, 1024, 1024), (1, 832, 1216)] or sizes != [(1024, 1024)] * 4 + [(832, 1216)]:
            raise AssertionError(f"window scheduler: generate() calls {calls}, replies {sizes}")
        numbers["window_group_s"] = seconds
        print(f"window scheduler: 4 concurrent compatible 1024x1024 requests made one generate() "
              f"of batch 4 and the 832x1216 one its own (calls {calls}); {seconds:.3f} s for the "
              f"five, replies {[round(s, 3) for _, s in replies]} s, webp of the asked sizes; peak "
              f"{peak_gib():.2f} GiB; launches {window}")

        # the 6-request staggered trace under the window scheduler (seeded: each alone)
        trace = [dict(prompt=f"a photo of the cat {'abcdef'[i]}", negative_prompt="blurry",
                      width=1024, height=1024, inference_steps=steps, cfg_scale=cfg,
                      cfg_rescale=rescale, seed=seed)
                 for i, (_, steps, seed, cfg, rescale) in enumerate(SDXL_TRACE)]
        delays = [t[0] for t in SDXL_TRACE]
        calls.clear()
        with on_path():
            replies, seconds = post_all(url, trace, delays=delays)
        numbers["trace_window_s"] = seconds
        print(f"6-request staggered trace (arrivals {delays} s, steps "
              f"{sorted({t[1] for t in SDXL_TRACE})}, one cfg_rescale), "
              f"window scheduler: {seconds:.3f} s wall, {len(calls)} generate() calls of batch 1 "
              f"(seeded requests run alone), replies {[round(s, 3) for _, s in replies]} s")

        # a 1536 px request: the tiled VAE decode
        tiled = []
        tiled_decode = model.vae.tiled_decode
        model.vae.tiled_decode = lambda z, *a, **kw: tiled.append(tuple(z.shape)) or \
            tiled_decode(z, *a, **kw)
        torch.cuda.reset_peak_memory_stats()
        with on_path():
            (reply,), seconds = post_all(url, [dict(
                prompt="a house in the mountains", negative_prompt="blurry", width=1536,
                height=1536, inference_steps=STEPS, cfg_scale=5.0, seed=8)])
        numbers["tiled_1536_s"], numbers["tiled_1536_peak_gib"] = seconds, peak_gib()
        if webp_size(reply[0]) != (1536, 1536) or tiled != [(1, 192, 192, 4)]:
            raise AssertionError(f"1536 px request: {webp_size(reply[0])}, tiled decodes {tiled}")
        print(f"1536x1536 request: {seconds:.3f} s, one tiled decode of {tiled[0]} (16 tiles of 64 "
              f"latents), peak {numbers['tiled_1536_peak_gib']:.2f} GiB")
        del model.vae.tiled_decode, model.generate
        server.shutdown()
        server.server_close()

        # the continuous scheduler: the same trace through a pool of 4 slots
        sched = srv.ContinuousScheduler(served, height=1024, width=1024, num_slots=SERVE_SLOTS)
        kept, ticks = tap_pool(sched, wrappers)
        server, url = serving(sched)
        torch.cuda.reset_peak_memory_stats()
        with on_path():
            replies, seconds = post_all(url, trace, delays=delays)
        numbers["trace_continuous_s"] = seconds
        numbers["trace_continuous_peak_gib"] = peak_gib()
        if [webp_size(data) for data, _ in replies] != [(1024, 1024)] * 6:
            raise AssertionError("continuous scheduler: a reply of another size")
        print(f"6-request staggered trace, continuous scheduler ({SERVE_SLOTS} slots): {seconds:.3f} s "
              f"wall (window: {numbers['trace_window_s']:.3f} s), replies "
              f"{[round(s, 3) for _, s in replies]} s, peak {numbers['trace_continuous_peak_gib']:.2f} "
              f"GiB")
        numbers["sdxl_pool"] = tick_report("SDXL pool", ticks, per_forward)
        server.shutdown()
        server.server_close()
        sched.close()
        numbers["sdxl_pool_errors"] = hold_pool("SDXL pool", kept, model, [dict(
            prompt=t["prompt"], negative_prompt=t["negative_prompt"], width=1024, height=1024,
            num_inference_steps=t["inference_steps"], cfg_scale=t["cfg_scale"],
            cfg_rescale=t["cfg_rescale"], seed=t["seed"]) for t in trace])

        # DeepCache: a full pass every 2 steps against every step
        deep = {}
        for interval in (1, 2, 1, 2):
            counts = {}
            torch.cuda.synchronize()
            start = time.perf_counter()
            with on_path(counts):
                model.generate("a photo of the cat", negative_prompt="blurry", width=1024,
                               height=1024, num_inference_steps=STEPS, cfg_scale=5.0, seed=9,
                               deep_cache_interval=interval)
            torch.cuda.synchronize()
            deep[interval] = (time.perf_counter() - start, counts)
        want_b = {1: unet_attn * STEPS, 2: unet_attn * len(range(0, STEPS, 2))}
        numbers["deepcache_s"] = {k: v[0] for k, v in deep.items()}
        print(f"DeepCache at {STEPS} steps, 1024 px, warm: interval 1 {deep[1][0]:.3f} s, kernel B "
              f"{deep[1][1]['flash_attention_bshd']} launches; interval 2 {deep[2][0]:.3f} s "
              f"({deep[2][0] / deep[1][0]:.2f}x), kernel B {deep[2][1]['flash_attention_bshd']}, "
              f"kernel A {deep[2][1]['layer_norm']} (expected B {want_b})")
        if any(deep[k][1]["flash_attention_bshd"] != want_b[k] for k in (1, 2)):
            raise AssertionError(f"DeepCache launches of kernel B: {deep}, expected {want_b}")
        free(model)
        del served, model

        # the CLI on the same checkpoint, the denoiser's Linears in NF4
        with torch.device("meta"):
            unet = SDXLDenoiser(SDXLDenoiserConfig())
        n_q = sum(1 for m in unet.modules() if isinstance(m, Linear)
                  and nf4_ops.supports(1, m.in_features, m.out_features, 64))
        del unet
        cli = {}
        torch.cuda.reset_peak_memory_stats()
        start = time.perf_counter()
        with on_path(cli):
            saved = inference_cli.main([
                "--family", "sdxl", "--checkpoint-path", str(work / "sdxl.safetensors"),
                "--tokenizer-path", str(work), "--prompt", "a photo of the cat",
                "--negative-prompt", "blurry", "--width", "1024", "--height", "1024",
                "--num-inference-steps", str(STEPS), "--cfg-scale", "5.0", "--quant-type",
                "bnb_nf4", "--save-path", str(work / "cli.webp")])
        numbers["cli_s"], numbers["cli_peak_gib"] = time.perf_counter() - start, peak_gib()
        gc.collect()
        torch.cuda.empty_cache()
        if saved != [str(work / "cli.webp")] or Image.open(saved[0]).size != (1024, 1024):
            raise AssertionError(f"the CLI saved {saved}")
        want_d = n_q * STEPS
        print(f"CLI --quant-type bnb_nf4 (load, quantize, 1024 px, {STEPS} steps, webp): "
              f"{numbers['cli_s']:.2f} s, peak {numbers['cli_peak_gib']:.2f} GiB; kernel D forward "
              f"{cli.get('nf4_matmul_forward', 0)} launches ({n_q} quantized Linears the kernel "
              f"takes x {STEPS} UNet forwards = {want_d}), kernel B {cli.get('flash_attention_bshd')}")
        if cli.get("nf4_matmul_forward") != want_d:
            raise AssertionError(f"the CLI launched kernel D {cli.get('nf4_matmul_forward')} times, "
                                 f"expected {want_d}")
        (work / "sdxl.safetensors").unlink()

        # -- 26: Lumina2 ----------------------------------------------------------------
        phase("26 Lumina2 (config #4) served at full width, 8 of its 26 layers: a continuous "
              "pool of 4 slots through the client")
        b, h, hk, s, d = SERVE_MASKED_SHAPE
        q = torch.randn(b, s, h, d, device=device, generator=gen).bfloat16().transpose(1, 2)
        k, v = (torch.randn(b, s, hk, d, device=device, generator=gen).bfloat16().transpose(1, 2)
                for _ in "kv")
        mask = torch.ones(b, s, dtype=torch.bool, device=device)
        for i in range(b):
            mask[i, 9 + 31 * i:256] = False  # each caption right-padded to its own length
        what = f"kernel E at the pool's (B={b}, H={h}/{hk}, S={s}, D={d}, captions padded)"
        abs_err, rel_err = compare(what, lambda: flash_attention_masked(q, k, v, mask),
                                   lambda: flash_attention_reference(q, k, v, mask),
                                   MASKED_ATTN_TOL)
        assert_reruns(what, lambda: flash_attention_masked(q, k, v, mask))
        ms = cuda_ms(lambda: flash_attention_masked(q, k, v, mask))
        plain_ms = cuda_ms(lambda: flash_attention_reference(q, k, v, mask), warmup=1, iters=3)
        kr, vr = (t.repeat_interleave(h // hk, dim=1) for t in (k, v))
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, kr, vr, attn_mask=mask[:, None, None, :]))
        flops = 4 * h * d * float(mask.sum().item()) * s
        bound_ms, bound_by = bound(2 * (2 * b * h * s * d + 2 * b * hk * s * d) + b * s, flops)
        print(f"{what}: max abs err {abs_err:.3e} rel {rel_err:.3e} (tol {MASKED_ATTN_TOL}), reruns "
              f"bit-identical; kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain "
              f"{plain_ms:.3f} ms, SDPA {library_ms:.4f} ms (kernel {ms / library_ms:.2f}x), bound "
              f"{bound_ms:.4f} ms ({bound_by})")
        records["flash_attention_masked"].append(dict(
            shape=[b, h, hk, s, s, d], max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms))
        del q, k, v, kr, vr
        for m, c, inner in SERVE_LUMINA_MLP:
            mlp_record(m, c, inner)
        gc.collect()
        torch.cuda.empty_cache()

        (work / "tokenizer.model").write_bytes(lumina_vocab())
        lumina_config = Lumina2Config(checkpoint_path="", dtype="bfloat16",
                                      denoiser=LuminaDenoiserConfig(**LUMINA_CUT_DEPTH))
        seeded = Lumina2(lumina_config)
        seeded.init_params(torch.Generator(device=device).manual_seed(26))
        den = seeded.denoiser
        blocks = len(den.layers) + len(den.noise_refiner) + len(den.context_refiner)
        checkpoint(seeded, work / "lumina2.safetensors", "lumina2")
        del seeded, den
        write_yaml(work / "lumina2.yml", {"checkpoint_path": str(work / "lumina2.safetensors"),
                                          "dtype": "bfloat16",
                                          "denoiser": lumina_config.denoiser.model_dump()})
        start = time.perf_counter()
        served = srv.T2IModel(str(work / "lumina2.yml"), None, str(work), family="lumina2")
        srv.prepare_kernels("lumina2", device)
        numbers["lumina2_load_s"] = time.perf_counter() - start
        sched = srv.ContinuousScheduler(served, height=1024, width=1024, num_slots=SERVE_SLOTS)
        kept, ticks = tap_pool(sched, wrappers)
        server, url = serving(sched)
        lumina = [dict(prompt="a photo of a cat sitting on the sofa", negative_prompt="blurry",
                       seed=261),
                  dict(prompt="a red car on the road", negative_prompt="blurry", seed=262,
                       cfg_trunc_ratio=0.5),
                  dict(prompt="a house in the mountains", negative_prompt="", seed=263,
                       renorm_cfg=0.0),
                  dict(prompt="a cat in the house", negative_prompt="blurry", seed=264,
                       renorm_cfg=2.0)]
        lumina = [dict(body, width=1024, height=1024, inference_steps=STEPS, cfg_scale=4.0)
                  for body in lumina]
        torch.cuda.reset_peak_memory_stats()
        with on_path():
            replies, seconds = post_all(url, lumina)
        numbers["lumina2_pool_s"], numbers["lumina2_pool_peak_gib"] = seconds, peak_gib()
        if [webp_size(data) for data, _ in replies] != [(1024, 1024)] * 4:
            raise AssertionError("Lumina2 pool: a reply of another size")
        print(f"Lumina2: checkpoint {numbers['lumina2_checkpoint_bytes']} bytes written in "
              f"{numbers['lumina2_checkpoint_write_s']:.2f} s, T2IModel "
              f"{numbers['lumina2_load_s']:.2f} s; 4 concurrent {STEPS}-step requests (one "
              f"truncated at 0.5, renorm 0 and 2.0 beside 1.0) in {seconds:.3f} s, peak "
              f"{numbers['lumina2_pool_peak_gib']:.2f} GiB")
        numbers["lumina2_pool"] = tick_report(
            "Lumina2 pool", ticks, {"flash_attention_masked": blocks, "gated_mlp": blocks})
        server.shutdown()
        server.server_close()
        sched.close()
        numbers["lumina2_pool_errors"] = hold_pool("Lumina2 pool", kept, served.model, [dict(
            prompt=r["prompt"], negative_prompt=r["negative_prompt"] or None, width=1024,
            height=1024, num_inference_steps=STEPS, cfg_scale=4.0, seed=r["seed"],
            renorm_cfg_scale=r.get("renorm_cfg", 1.0),
            cfg_truncation_ratio=r.get("cfg_trunc_ratio", 0.0)) for r in lumina])
        free(served.model)
        del served
        (work / "lumina2.safetensors").unlink()

        # -- 27: AuraFlow ----------------------------------------------------------------
        phase("27 AuraFlow (config #3) served at full width, 4 double and 8 single layers: a "
              "continuous pool of 4 slots through the client, one request at cfg_scale 1")
        attention_record(*SERVE_AURA_ATTN)
        for m, c, inner in SERVE_AURA_MLP:
            mlp_record(m, c, inner)
        gc.collect()
        torch.cuda.empty_cache()
        aura_config = AuraFlowConig(checkpoint_path="", dtype="bfloat16",
                                    denoiser=AuraDenoiserConfig(**AURA_CUT_DEPTH))
        seeded = AuraFlowModel(aura_config)
        seeded.init_params(torch.Generator(device=device).manual_seed(27))
        aura_fill_zero_init(seeded, device, 28)
        den = seeded.denoiser
        n_layers = len(den.double_layers) + len(den.single_layers)
        n_mlps = 2 * len(den.double_layers) + len(den.single_layers)
        checkpoint(seeded, work / "auraflow.safetensors", "auraflow")
        del seeded, den
        write_yaml(work / "auraflow.yml", {"checkpoint_path": str(work / "auraflow.safetensors"),
                                           "dtype": "bfloat16",
                                           "denoiser": aura_config.denoiser.model_dump()})
        start = time.perf_counter()
        served = srv.T2IModel(str(work / "auraflow.yml"), None, str(work), family="auraflow")
        srv.prepare_kernels("auraflow", device)
        numbers["auraflow_load_s"] = time.perf_counter() - start
        sched = srv.ContinuousScheduler(served, height=1024, width=1024, num_slots=SERVE_SLOTS)
        kept, ticks = tap_pool(sched, wrappers)
        server, url = serving(sched)
        aura = [dict(prompt="a photo of a cat sitting on the sofa", negative_prompt="blurry",
                     seed=271, cfg_scale=3.5),
                dict(prompt="a red car on the road", negative_prompt="", seed=272, cfg_scale=1.0),
                dict(prompt="a house in the mountains", negative_prompt="blurry", seed=273,
                     cfg_scale=5.0)]
        aura = [dict(body, width=1024, height=1024, inference_steps=STEPS) for body in aura]
        torch.cuda.reset_peak_memory_stats()
        with on_path():
            replies, seconds = post_all(url, aura)
        numbers["auraflow_pool_s"], numbers["auraflow_pool_peak_gib"] = seconds, peak_gib()
        if [webp_size(data) for data, _ in replies] != [(1024, 1024)] * 3:
            raise AssertionError("AuraFlow pool: a reply of another size")
        print(f"AuraFlow: checkpoint {numbers['auraflow_checkpoint_bytes']} bytes written in "
              f"{numbers['auraflow_checkpoint_write_s']:.2f} s, T2IModel "
              f"{numbers['auraflow_load_s']:.2f} s; 3 concurrent {STEPS}-step requests (CFG 3.5, "
              f"1.0, 5.0) in a pool of {SERVE_SLOTS} in {seconds:.3f} s, peak "
              f"{numbers['auraflow_pool_peak_gib']:.2f} GiB")
        numbers["auraflow_pool"] = tick_report(
            "AuraFlow pool", ticks, {"flash_attention_bshd": n_layers, "gated_mlp": n_mlps})
        server.shutdown()
        server.server_close()
        sched.close()
        numbers["auraflow_pool_errors"] = hold_pool("AuraFlow pool", kept, served.model, [dict(
            prompt=r["prompt"], negative_prompt=r["negative_prompt"] or None, width=1024,
            height=1024, num_inference_steps=STEPS, cfg_scale=r["cfg_scale"], seed=r["seed"])
            for r in aura])
        free(served.model)
        del served
    finally:
        shutil.rmtree(work, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": path_launches, "records": records, "numbers": numbers}


# the Flux phases (28-30, ``--flux``): kernel B at head dim 128, Flux's shapes (B, Sq, Sk,
# H*D, H): 512 T5 tokens before the image's 2x2 patches
FLUX_ATTN_SHAPES = [
    (1, 4608, 4608, 3072, 24),  # a 1024 px request: 512 + 64 * 64
    (2, 4608, 4608, 3072, 24),  # the same under CFG
    (8, 4608, 4608, 3072, 24),  # a pool of 4 slots (both CFG halves of each)
    (1, 2816, 2816, 3072, 24),  # 768 px: 512 + 48 * 48
    (1, 4464, 4464, 3072, 24),  # the 832x1216 bucket: 512 + 52 * 76, ragged tiles
    (1, 300, 300, 3072, 24),    # just past the 256-key gate
]
FLUX_STEPS = 8  # 20 before the CogView4 phases joined the run
FLUX_GUIDANCE = 3.5
# one full-depth flux1-dev step (19 double + 38 single blocks) and whole requests, kernel B
# against its plain version, bf16, random weights: each block's few-ulp differences carried
# on through both streams; relative to the largest value of the velocity or the latents
FLUX_STEP_TOL = 5e-2
# the use_flash_attention: false request (the plain formula in every block) against the
# kernel route's, 20 steps: as above, compounded over the steps
FLUX_ROUTE_TOL = 5e-2
FLUX_REDUCED = dict(depth=1, depth_single_blocks=2)  # full width, for checkpoints and pools
FLUX_CUT_DEPTH = dict(depth=4, depth_single_blocks=8)  # phase 29's (of 19 + 38; full before phases 43-46)
FLUX_REDUCED_T5_LAYERS = 2
FLUX_POOL_STEPS = (4, 8)
MIGRATION_STEPS = 3


def flux_phase(device, wrappers: dict, profile: bool) -> dict:
    """Phases 28-30, run in a process of its own (``--flux``): kernel B at
    head dim 128 at Flux's shapes against its plain version; FluxModel
    generate() on flux1-dev at full width and depth (launch counts, the
    plain attention route, DeepCache, one denoise step against the plain
    versions), flux1-schnell and flex1-alpha at reduced depth against the
    plain versions; the single-file checkpoint in both key layouts, the
    server's two schedulers, the CLI and the AuraFlow VAE-encode migration
    Trainer. Returns the Flux paths' launch counts, kernel B's records at
    these shapes and the numbers."""
    import dataclasses

    from vision_ft_tpu_torch.config import TrainConfig
    from vision_ft_tpu_torch.models.flux import config as flux_config
    from vision_ft_tpu_torch.models.flux.pipeline import FluxModel
    from vision_ft_tpu_torch.models.flux.text_encoder import FLUX_T5_CONFIG
    from vision_ft_tpu_torch.models.text_encoders.sentencepiece import (
        SentencePieceModel, SentencePieceTokenizer,
    )
    from vision_ft_tpu_torch.models.text_encoders.tokenizer import CLIPTokenizer
    from vision_ft_tpu_torch.nn import LayerNorm
    from vision_ft_tpu_torch.ops.flash_attention import forward_config
    from vision_ft_tpu_torch.tools import inference_cli
    from vision_ft_tpu_torch.tools import inference_server as srv
    from vision_ft_tpu_torch.train.auraflow import vae_encode_migration
    from vision_ft_tpu_torch.utils import safetensors as st

    gen = torch.Generator(device=device).manual_seed(28)
    numbers, records = {}, {"flash_attention_bshd": []}
    path_launches = {name: 0 for name in wrappers}

    def read_launches():
        return {name: wrapper.launches for name, wrapper in wrappers.items()}

    @contextlib.contextmanager
    def on_path():
        """A Flux path's launches, added to the process's path counts;
        launches made to compare kernels with plain run outside."""
        before = read_launches()
        yield
        for name, count in read_launches().items():
            path_launches[name] += count - before[name]

    def free(model):
        for part in model._parts().values():
            part.to("meta")
        gc.collect()
        torch.cuda.empty_cache()

    def peak_gib():
        return torch.cuda.max_memory_allocated() / 2**30

    # -- 28: kernel B at head dim 128 -------------------------------------------------------
    phase("28 kernel B at head dim 128 (Flux's 24 heads of 128) vs plain (bf16)")
    config_128 = forward_config(128)
    numbers["kernel_b_d128"] = config_128
    print(f"kernel B at D = 128: {config_128['keys']}-key tiles, {config_128['stages']} stages, "
          f"{config_128['passes']} pass(es) over O's columns, Smem::kBytes = "
          f"{config_128['smem_bytes']} (a block may have 232448)")
    for shape in FLUX_ATTN_SHAPES:
        records["flash_attention_bshd"].append(bshd_forward_record(device, gen, *shape))

    # -- 29: flux1-dev generate() at full width and depth ----------------------------------
    phase("29 Flux generate() at full width (flux1-dev), 4 double and 8 single of its 19 + 38 "
          "blocks, bf16, seeded random weights")
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_flux_"))
    (work / "tokenizer.model").write_bytes(lumina_vocab())
    (work / "clip").mkdir()
    write_vocab(work / "clip")
    t5_tokenizer = SentencePieceTokenizer(SentencePieceModel.from_bytes(lumina_vocab()),
                                          template="eos")
    clip_tokenizer = CLIPTokenizer.from_pretrained_dir(str(work / "clip"))
    tokenizers = dict(clip_tokenizer=clip_tokenizer, t5_tokenizer=t5_tokenizer)

    class Model(FluxModel):
        """Keeps the last latents generate() decoded, for the checks."""

        def decode_image(self, latents):
            self.last_latents = latents.clone()
            return super().decode_image(latents)

    def set_backend(model, backend):
        """Every block's attention backend, as ``use_flash_attention`` sets
        it at construction ("flash" or "xla")."""
        for block in (*model.denoiser.double_blocks.values(),
                      *model.denoiser.single_blocks.values()):
            block.backend = backend

    def clip_layer_norms(model):
        """CLIP-L's LayerNorms that take kernel A (affine, C % 128 == 0)."""
        return sum(isinstance(m, LayerNorm) and m.weight is not None and m.dim % 128 == 0
                   for m in model.text_encoder.clip.modules())

    def dev_config(**fields):
        return flux_config.FluxConfig(checkpoint_path="", dtype="bfloat16",
                                      denoiser=flux_config.Flux1DevDenoiserConfig(
                                          use_flash_attention=True, **fields))

    torch.cuda.reset_peak_memory_stats()
    model = Model(dev_config(**FLUX_CUT_DEPTH), **tokenizers)
    start = time.perf_counter()
    model.init_params(torch.Generator(device=device).manual_seed(0))
    torch.cuda.synchronize()
    den = model.denoiser
    counts = [sum(p.numel() for p in part.parameters()) for part in model._parts().values()]
    weight_gb = sum(p.numel() * p.element_size() for part in model._parts().values()
                    for p in part.parameters()) / 1e9
    n_double, n_single = len(den.double_blocks), len(den.single_blocks)
    n_ln = clip_layer_norms(model)
    numbers.update(init_s=time.perf_counter() - start, weight_gb=weight_gb,
                   denoiser_params=counts[0], vae_params=counts[1], text_encoder_params=counts[2])
    print(f"init on the card: {numbers['init_s']:.1f} s; denoiser {counts[0] / 1e9:.3f} B, VAE "
          f"{counts[1] / 1e6:.1f} M, CLIP-L + T5-XXL {counts[2] / 1e9:.3f} B parameters, "
          f"{weight_gb:.1f} GB of bf16 weights; denoiser: {n_double} double + {n_single} single "
          f"blocks, hidden {den.hidden_size}, {den.num_heads} heads of "
          f"{den.hidden_size // den.num_heads}, MLP {den.single_blocks['0'].mlp_hidden_dim}; "
          f"T5: {model.text_encoder.t5.config.num_layers} layers, d_model "
          f"{model.text_encoder.t5.config.d_model}; CLIP-L LayerNorms on kernel A: {n_ln}")

    def expected(steps, interval=None, cache_depth=None, flash=True):
        """(kernel B, kernel A) launches of one request from the module tree
        and generate()'s DeepCache rule: each block one attention call (both
        CFG halves in one batch), the prompts one CLIP-L pass."""
        shallow = cache_depth if cache_depth is not None else max(1, n_single // 4)
        attention, have_delta = 0, False
        for i in range(steps):
            singles = shallow if interval and i % interval != 0 and have_delta else n_single
            have_delta = have_delta or bool(interval)
            attention += n_double + singles
        return attention if flash else 0, n_ln

    def request(name, want, **kwargs):
        torch.cuda.reset_peak_memory_stats()
        before = read_launches()
        torch.cuda.synchronize()
        start = time.perf_counter()
        with on_path():
            images = model.generate(**kwargs)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        launches = {k: v - before[k] for k, v in read_launches().items() if v != before[k]}
        peak = peak_gib()
        latents, arrays = model.last_latents, [np.asarray(im) for im in images]
        print(f"request {name}: {len(images)} image(s) {images[0].size}, "
              f"{kwargs['num_inference_steps']} steps, CFG {kwargs.get('cfg_scale', 1.0)}, distilled "
              f"guidance {kwargs.get('distilled_guidance_scale')}, {seconds:.3f} s, peak "
              f"{peak:.2f} GiB; launches {launches}, expected kernel B {want[0]}, kernel A {want[1]}")
        if not torch.isfinite(latents).all() or any(a.std() == 0 for a in arrays):
            raise AssertionError(f"request {name}: latents not finite, or a constant image")
        if images[0].size != (kwargs["width"], kwargs["height"]) or latents.shape[1:] != (
                kwargs["height"] // 8, kwargs["width"] // 8, 16):
            raise AssertionError(f"request {name}: wrong size {images[0].size}, {latents.shape}")
        counts = {k: n for k, n in (("flash_attention_bshd", want[0]), ("layer_norm", want[1])) if n}
        if launches != counts:
            raise AssertionError(f"request {name}: launch counts {launches} != {counts}")
        return seconds, latents, arrays, peak

    base = dict(prompt="a photo of a cat sitting on the sofa", width=1024, height=1024,
                num_inference_steps=FLUX_STEPS, cfg_scale=1.0,
                distilled_guidance_scale=FLUX_GUIDANCE, seed=1234)
    runs = {}
    for name, kwargs in (("1 (cold)", base),
                         ("2", dict(base, prompt="a red car on the road in the mountains", seed=99)),
                         ("3 (= 1, warm)", base)):
        runs[name] = request(name, expected(FLUX_STEPS), **kwargs)
    first, again = runs["1 (cold)"], runs["3 (= 1, warm)"]
    if not (torch.equal(first[1], again[1])
            and all(np.array_equal(x, y) for x, y in zip(first[2], again[2]))):
        raise AssertionError("request 3 (request 1 repeated, same seed) differs from it")
    seconds = [run[0] for run in runs.values()]
    numbers.update(first_request_s=seconds[0], warm_request_s=seconds[1:],
                   peak_gib=max(run[3] for run in runs.values()))
    print(f"s/request: {seconds[0]:.3f} cold (the first), {seconds[1]:.3f} and {seconds[2]:.3f} "
          f"warm; peak {numbers['peak_gib']:.2f} GiB; request 3 == request 1, bit for bit")
    cfg = request("4 (CFG 2, negative prompt)", expected(FLUX_STEPS),
                  **dict(base, cfg_scale=2.0, negative_prompt="blurry"))
    cached = request("5 (deep_cache_interval 2)", expected(FLUX_STEPS, interval=2),
                     **dict(base, deep_cache_interval=2))
    if torch.equal(cached[1], first[1]) or torch.equal(cfg[1], first[1]):
        raise AssertionError("the CFG or the DeepCache request equals request 1: an option did nothing")
    set_backend(model, "xla")
    try:
        plain = request("6 (= 1, use_flash_attention: false)", expected(FLUX_STEPS, flash=False),
                        **base)
    finally:
        set_backend(model, "flash")
    scale = first[1].float().abs().max().item()
    drift = (plain[1].float() - first[1].float()).abs().max().item() / scale
    numbers.update(cfg_request_s=cfg[0], cfg_peak_gib=cfg[3], deep_cache_request_s=cached[0],
                   plain_attention_request_s=plain[0], plain_attention_drift=drift)
    print(f"CFG request {cfg[0]:.3f} s (peak {cfg[3]:.2f} GiB), DeepCache request {cached[0]:.3f} s; "
          f"the plain attention route {plain[0]:.3f} s, its latents {drift:.3e} of their largest "
          f"value from request 1's (tol {FLUX_ROUTE_TOL})")
    if drift > FLUX_ROUTE_TOL:
        raise AssertionError("the kernel route and the use_flash_attention: false route disagree")

    # one CFG denoise step at 1024 px, kernel B against its plain version
    g29 = torch.Generator(device=device).manual_seed(29)
    step_latents = torch.randn(1, 128, 128, 16, device=device, generator=g29).bfloat16()

    def encode(m):
        with torch.inference_mode():
            out = m.text_encoder.encode_prompts("a photo of a cat", "blurry", use_negative_prompts=True)
            return (torch.cat([out.t5.positive_embeddings, out.t5.negative_embeddings]).to(m.dtype),
                    torch.cat([out.clip.positive_embeddings, out.clip.negative_embeddings]).to(m.dtype))

    def denoise_step(m, emb, latents=step_latents):
        with torch.inference_mode():
            return m._denoise_step(latents, 0.8, 1.0 / FLUX_STEPS, *emb, FLUX_GUIDANCE, 2.0,
                                   do_cfg=True)

    emb = encode(model)
    step_ms = cuda_ms(lambda: denoise_step(model, emb), warmup=1, iters=5)
    before = read_launches()["flash_attention_bshd"]
    kernel_step = denoise_step(model, emb)
    step_launches = read_launches()["flash_attention_bshd"] - before
    with plain_versions():
        plain_step = denoise_step(model, emb)
    step_err = (kernel_step.float() - plain_step.float()).abs().max().item() / \
        plain_step.float().abs().max().item()
    numbers.update(step_ms=step_ms, step_latents_err=step_err)
    print(f"one CFG denoise step at 1024 px (batch 2, 4608 joint tokens): {step_ms:.1f} ms; kernel "
          f"B launches {step_launches} (the module tree: {n_double + n_single}); against the plain "
          f"version of B: the step's latents {step_err:.3e} of their largest value "
          f"(tol {FLUX_STEP_TOL})")
    if step_launches != n_double + n_single:
        raise AssertionError(f"the denoise step launched kernel B {step_launches} times")
    if step_err > FLUX_STEP_TOL:
        raise AssertionError("the kernel's denoise step and the plain one disagree")
    if profile:
        kinds = profile_steps(lambda: denoise_step(model, emb), step_ms, "Flux CFG denoise step")
        print_kernel_ms(kinds, ("kernel B",), "Flux CFG denoise step")
        numbers["traced_step"] = {kind: [round(ms, 4), n] for kind, (ms, n) in kinds.items()}
    free(model)
    del model, emb, kernel_step, plain_step

    # flux1-schnell and flex1-alpha at full width, reduced depth, against the plain version
    t5_reduced = dataclasses.replace(FLUX_T5_CONFIG, num_layers=FLUX_REDUCED_T5_LAYERS)
    for kind, cls in (("flux1-schnell", flux_config.Flux1SchnellDenoiserConfig),
                      ("flex1-alpha", flux_config.Flex1AlphaDenoiserConfig)):
        small = Model(flux_config.FluxConfig(
            checkpoint_path="", dtype="bfloat16",
            denoiser=cls(use_flash_attention=True, **FLUX_REDUCED)), t5_config=t5_reduced,
            **tokenizers)
        small.init_params(torch.Generator(device=device).manual_seed(30))
        req = dict(prompt="a photo of a cat", width=1024, height=1024, num_inference_steps=4,
                   cfg_scale=1.0, distilled_guidance_scale=FLUX_GUIDANCE, seed=7)
        before = read_launches()
        with on_path():
            small.generate(**req)
        got = small.last_latents.float()
        launched = read_launches()["flash_attention_bshd"] - before["flash_attention_bshd"]
        with plain_versions():
            small.generate(**req)
        want = small.last_latents.float()
        err = (got - want).abs().max().item() / want.abs().max().item()
        numbers[f"{kind}_reduced_err"] = err
        print(f"{kind} (guidance_in: {small.denoiser.guidance_in is not None}; 1 double + 2 single "
              f"blocks at full width, 4 steps at 1024 px): kernel B launches {launched} (expected "
              f"{4 * 3}), latents against the plain version {err:.3e} of their largest value "
              f"(tol {FLUX_STEP_TOL})")
        if launched != 12 or err > FLUX_STEP_TOL or not torch.isfinite(got).all():
            raise AssertionError(f"{kind} at reduced depth: {launched} launches, error {err:.3e}")
        free(small)
        del small

    # -- 30: checkpoint, serving, CLI, the VAE-encode migration ------------------------------
    phase("30 the Flux single-file checkpoint, server, CLI; the AuraFlow VAE-encode migration")
    try:
        reduced = dev_config(**FLUX_REDUCED)
        small = Model(reduced, t5_config=t5_reduced, **tokenizers)
        small.init_params(torch.Generator(device=device).manual_seed(31))
        emb = encode(small)
        step_before = denoise_step(small, emb)
        written = small.state_dict()
        paths = {"original": work / "flux.safetensors", "comfy": work / "flux_comfy.safetensors"}
        layouts = {"original": written, "comfy": {
            k.replace("model.diffusion_model.", "diffusion_model.", 1): v for k, v in written.items()}}
        for layout, path in paths.items():
            torch.cuda.synchronize()
            start = time.perf_counter()
            st.save_file(layouts[layout], path)
            numbers[f"checkpoint_{layout}_write_s"] = time.perf_counter() - start
            numbers[f"checkpoint_{layout}_bytes"] = path.stat().st_size
            start = time.perf_counter()
            loaded = Model.from_checkpoint(reduced.model_copy(update={"checkpoint_path": str(path)}),
                                           t5_config=t5_reduced, **tokenizers)
            torch.cuda.synchronize()
            numbers[f"checkpoint_{layout}_load_s"] = time.perf_counter() - start
            read = loaded.state_dict()
            if set(read) != set(written) or not all(torch.equal(written[k], read[k]) for k in read):
                raise AssertionError(f"the {layout} checkpoint loaded back differs from the model")
            if not torch.equal(step_before, denoise_step(loaded, encode(loaded))):
                raise AssertionError(f"the {layout} checkpoint's denoise step differs")
            print(f"single-file checkpoint, {layout} keys (full width; 1 double + 2 single blocks, "
                  f"{FLUX_REDUCED_T5_LAYERS} T5 layers): {numbers[f'checkpoint_{layout}_bytes']} "
                  f"bytes, written in {numbers[f'checkpoint_{layout}_write_s']:.2f} s, loaded by "
                  f"from_checkpoint in {numbers[f'checkpoint_{layout}_load_s']:.2f} s; every "
                  f"tensor and the denoise step bit-identical")
            free(loaded)
            del loaded
        free(small)
        del small, written, layouts
        paths["comfy"].unlink()

        # the server's model and the CLI's are built at the file's depth (a YAML names the
        # denoiser's; neither names T5's, and the CLI names only the file)
        build = FluxModel.__init__

        def at_file_depth(self, config, clip_tokenizer=None, t5_tokenizer=None):
            build(self, config.model_copy(update={"denoiser": reduced.denoiser}),
                  clip_tokenizer=clip_tokenizer, t5_tokenizer=t5_tokenizer, t5_config=t5_reduced)

        FluxModel.__init__ = at_file_depth
        try:
            write_yaml(work / "flux.yml", {"checkpoint_path": str(paths["original"]),
                                           "dtype": "bfloat16",
                                           "denoiser": reduced.denoiser.model_dump()})
            start = time.perf_counter()
            served = srv.T2IModel(str(work / "flux.yml"), None, str(work), family="flux")
            srv.prepare_kernels("flux", device)
            numbers["serve_load_s"] = time.perf_counter() - start
            if served.model.text_encoder.clip_tokenizer is None:
                raise AssertionError("the server found no CLIP tokenizer in the clip/ subfolder")
            n_blocks = len(served.model.denoiser.double_blocks) + len(served.model.denoiser.single_blocks)

            batcher = srv.MicroBatcher(served, max_batch=4, window_ms=2000)
            server, url = serving(batcher)
            window = [dict(prompt=p, negative_prompt="", width=1024, height=1024,
                           inference_steps=FLUX_POOL_STEPS[0], cfg_scale=1.0,
                           distilled_guidance=FLUX_GUIDANCE)
                      for p in ("a photo of a cat", "a red car on the road")]
            before = read_launches()
            with on_path():
                replies, seconds = post_all(url, window)
            launched = read_launches()["flash_attention_bshd"] - before["flash_attention_bshd"]
            server.shutdown()
            server.server_close()
            numbers["window_s"] = seconds
            if [webp_size(data) for data, _ in replies] != [(1024, 1024)] * 2 or \
                    launched != FLUX_POOL_STEPS[0] * n_blocks:
                raise AssertionError(f"window scheduler: replies {len(replies)}, B launched {launched}")
            print(f"window scheduler: 2 concurrent compatible requests in one generate() of batch 2 "
                  f"in {seconds:.3f} s, kernel B {launched} launches "
                  f"({FLUX_POOL_STEPS[0]} steps x {n_blocks} blocks)")

            sched = srv.ContinuousScheduler(served, height=1024, width=1024, num_slots=SERVE_SLOTS,
                                            max_steps=max(FLUX_POOL_STEPS))
            kept, ticks = tap_pool(sched, wrappers)
            server, url = serving(sched)
            pool = [dict(prompt="a photo of a cat sitting on the sofa", negative_prompt="", seed=301,
                         inference_steps=FLUX_POOL_STEPS[0], cfg_scale=1.0, distilled_guidance=0.0),
                    dict(prompt="a red car on the road", negative_prompt="", seed=302,
                         inference_steps=FLUX_POOL_STEPS[1], cfg_scale=1.0, distilled_guidance=2.5),
                    dict(prompt="a house in the mountains", negative_prompt="blurry", seed=303,
                         inference_steps=FLUX_POOL_STEPS[0], cfg_scale=2.0,
                         distilled_guidance=FLUX_GUIDANCE),
                    dict(prompt="a cat in the house", negative_prompt="", seed=304,
                         inference_steps=FLUX_POOL_STEPS[1], cfg_scale=1.0,
                         distilled_guidance=FLUX_GUIDANCE)]
            pool = [dict(body, width=1024, height=1024) for body in pool]
            torch.cuda.reset_peak_memory_stats()
            with on_path():
                replies, seconds = post_all(url, pool, delays=[0.0, 0.3, 0.6, 0.9])
            numbers["pool_s"], numbers["pool_peak_gib"] = seconds, peak_gib()
            if [webp_size(data) for data, _ in replies] != [(1024, 1024)] * 4:
                raise AssertionError("Flux pool: a reply of another size")
            print(f"continuous scheduler: 4 staggered requests ({FLUX_POOL_STEPS} steps, distilled "
                  f"guidance 0, 2.5, 3.5, one with CFG 2) in a pool of {SERVE_SLOTS} in "
                  f"{seconds:.3f} s, peak {numbers['pool_peak_gib']:.2f} GiB")
            numbers["pool"] = tick_report("Flux pool", ticks, {"flash_attention_bshd": n_blocks})
            server.shutdown()
            server.server_close()
            sched.close()
            numbers["pool_errors"] = hold_pool("Flux pool", kept, served.model, [dict(
                prompt=r["prompt"], negative_prompt=r["negative_prompt"] or None, width=1024,
                height=1024, num_inference_steps=r["inference_steps"], cfg_scale=r["cfg_scale"],
                distilled_guidance_scale=r["distilled_guidance"], seed=r["seed"]) for r in pool])
            free(served.model)
            del served

            cli = {}
            torch.cuda.reset_peak_memory_stats()
            start = time.perf_counter()
            with on_path():
                before = read_launches()
                saved = inference_cli.main([
                    "--family", "flux", "--checkpoint-path", str(paths["original"]),
                    "--tokenizer-path", str(work), "--width", "1024", "--height", "1024",
                    "--num-inference-steps", str(FLUX_POOL_STEPS[0]), "--cfg-scale", "1.0",
                    "--save-path", str(work / "cli.webp")])
                cli = {k: v - before[k] for k, v in read_launches().items() if v != before[k]}
            numbers["cli_s"], numbers["cli_peak_gib"] = time.perf_counter() - start, peak_gib()
        finally:
            FluxModel.__init__ = build
        gc.collect()
        torch.cuda.empty_cache()
        if saved != [str(work / "cli.webp")] or Image.open(saved[0]).size != (1024, 1024):
            raise AssertionError(f"the CLI saved {saved}")
        want_b = FLUX_POOL_STEPS[0] * n_blocks
        print(f"CLI --family flux (load, 1024 px, {FLUX_POOL_STEPS[0]} steps, CFG 1, webp): "
              f"{numbers['cli_s']:.2f} s, peak "
              f"{numbers['cli_peak_gib']:.2f} GiB; launches {cli} (kernel B expected {want_b})")
        if cli.get("flash_attention_bshd") != want_b:
            raise AssertionError(f"the CLI launched kernel B {cli.get('flash_attention_bshd')} times")
        paths["original"].unlink()

        # the AuraFlow VAE-encode migration through the port's Trainer
        folder = work / "images"
        folder.mkdir()
        g30 = np.random.default_rng(30)
        for i in range(MIGRATION_STEPS):
            Image.fromarray(g30.integers(0, 255, (1024, 1024, 3), dtype=np.uint8)).save(
                folder / f"{i}.png")
            (folder / f"{i}.txt").write_text("a photo of a cat")
        config = TrainConfig.model_validate({
            "model": {"checkpoint_path": str(work / "absent.safetensors"), "dtype": "bfloat16"},
            "dataset": {"folder": str(folder), "batch_size": 1, "bucket_base_size": 1024,
                        "step": 128, "min_size": 512, "num_repeats": 1, "num_workers": 0},
            "optimizer": {"name": "torch.optim.AdamW", "args": {"lr": 1e-3}},
            "saving": {"strategy": {"per_epochs": 1, "per_steps": None},
                       "callbacks": [{"type": "safetensors", "name": "migration",
                                      "save_dir": str(work / "migration")}]},
            "seed": 0, "num_train_epochs": 1,
        })
        trainer = vae_encode_migration.build_trainer(config)
        losses = []
        log_dict = trainer.log_dict
        trainer.log_dict = lambda values, step=None: (
            losses.append(values["train/loss"]) if "train/loss" in values else None,
            log_dict(values, step))
        torch.cuda.reset_peak_memory_stats()
        start = time.perf_counter()
        with on_path():
            trainer.train()
        torch.cuda.synchronize()
        numbers.update(migration_s=time.perf_counter() - start, migration_peak_gib=peak_gib(),
                       migration_losses=losses)
        fresh = vae_encode_migration.build_trainer(config).model
        fresh.setup_model()
        after, start_values = trainer.model.get_params().state_dict(), fresh.get_params().state_dict()
        moved = sorted(k for k in after if not torch.equal(after[k], start_values[k]))
        saved_keys = sorted(st.load_file(next((work / "migration").glob("*.safetensors"))))
        print(f"VAE-encode migration (both VAEs at full width, fp32, 1024 px images, batch 1): "
              f"{len(losses)} steps in {numbers['migration_s']:.2f} s, peak "
              f"{numbers['migration_peak_gib']:.2f} GiB, losses {[round(v, 5) for v in losses]}; "
              f"moved {moved}; saved keys {saved_keys}")
        if len(losses) != MIGRATION_STEPS or not all(np.isfinite(losses)):
            raise AssertionError(f"the migration Trainer's losses {losses}")
        if moved != ["migration_scale.scale"] or saved_keys != [
                "diffusion_model.init_x_linear.bias", "diffusion_model.init_x_linear.weight",
                "migration_scale.scale"]:
            raise AssertionError(f"the migration moved {moved} and saved {saved_keys}")
        del trainer, fresh, after, start_values
    finally:
        shutil.rmtree(work, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": path_launches, "records": records, "numbers": numbers}


# the CogView4 phases (31-33, ``--cogview4``): kernel B at head dim 128 with 32 heads and
# kernel C at head dim 128, CogView4's shapes (B, Sq, Sk, H*D, H): the caption, padded to a
# multiple of 16 (16 tokens for a short prompt), before the image's 2x2 patches
COGVIEW4_ATTN_SHAPES = [
    (2, 4112, 4112, 4096, 32),  # a 1024 px request under CFG: 16 + 64 * 64, not a multiple of 64
    (8, 4112, 4112, 4096, 32),  # a pool of 4 slots (both CFG halves of each)
    (2, 2320, 2320, 4096, 32),  # 768 px under CFG: 16 + 48 * 48
    (1, 4144, 4144, 4096, 32),  # a 48-token caption at 1024 px
]
COGVIEW4_BWD_SHAPES = [  # (B, Sq, Sk, H*D, H, strided): the config's step (batch 2), batch 1,
    (2, 4112, 4112, 4096, 32, False),  # then the step's shape on column slices of one
    (1, 4112, 4112, 4096, 32, False),  # (B, S, 3 H*D) tensor (rows 3 H*D apart)
    (2, 4112, 4112, 4096, 32, True),
]
# kernel D's forward at the quant-compare tool's Linears (M, N, K): GLM's at two 16-token
# prompts, the DiT's at 1024 px under CFG: the attention projections on the joint stream
# (2 x 4112 rows), the feed-forward on the image (2 x 4096) and the text (2 x 16) streams
COGVIEW4_NF4_SHAPES = [
    (32, 4096, 4096),     # GLM q_proj, o_proj
    (32, 256, 4096),      # GLM k_proj, v_proj: 2 kv heads of 128
    (32, 27392, 4096),    # GLM gate_up_proj
    (32, 4096, 13696),    # GLM down_proj
    (8224, 4096, 4096),   # the DiT's to_q / to_k / to_v / to_out.0
    (8192, 16384, 4096),  # ff.net.0.proj, image stream
    (8192, 4096, 16384),  # ff.net.2, image stream
    (32, 16384, 4096),    # ff.net.0.proj, text stream
    (32, 4096, 16384),    # ff.net.2, text stream
]
COGVIEW4_STEPS = 8  # the requests' steps (the pipeline's default is 20)
COGVIEW4_CFG = 3.5
# one full-depth CFG denoise step (28 blocks) and whole requests, kernel B against its plain
# version, bf16, random weights: each block's few-ulp differences carried on through both
# streams; relative to the largest value of the latents (FLUX_STEP_TOL)
COGVIEW4_STEP_TOL = 5e-2
COGVIEW4_REDUCED = dict(num_layers=2)  # full width, for the checkpoint, server, CLI and tool
COGVIEW4_CUT_DEPTH = dict(num_layers=8)  # phases 32-33's DiT (of 28; full before phases 43-46), GLM whole
COGVIEW4_REDUCED_GLM_LAYERS = 2
COGVIEW4_POOL_STEPS = (4, 8)
COGVIEW4_TRAINER_IMAGES = 8  # 1024x1024, batch 2: one epoch is 4 steps
COGVIEW4_TRAINER_CAPTIONS = [
    "a photo of a cat sitting on the sofa",
    "a red car on the road in the mountains",
    "a house in the mountains",
    "a cat on the road",
]
COGVIEW4_PREVIEW_STEPS = 4


def nf4_forward_record(device, gen, m, n, k) -> dict:
    """Kernel D's forward on the split layout a quantized Linear holds on
    the card, (M, K) bf16 rows by a seeded (N, K) NF4 weight: one launch,
    against its plain version, a rerun bit-identical, timed beside cuBLAS on
    the dequantized bf16 weight, TFLOP/s and the bound. Prints its line and
    returns its record."""
    from vision_ft_tpu_torch.modules.quant.nf4 import dequantize_4bit, quantize_4bit
    from vision_ft_tpu_torch.ops.nf4_matmul import (
        nf4_matmul_forward, nf4_matmul_reference, to_split_layout,
    )

    w = torch.randn(n, k, device=device, generator=gen) * 0.02
    packed, state = quantize_4bit(w, "nf4")
    code, absmax = state["quant_map"], state["absmax"]
    args = (to_split_layout(packed, (n, k)), code, absmax, (n, k), 64, True)
    x = torch.randn(m, k, device=device, generator=gen).bfloat16()
    what = f"4-bit matmul forward nf4 split (M={m}, N={n}, K={k})"
    before = nf4_matmul_forward.launches
    y = nf4_matmul_forward(x, *args)
    if nf4_matmul_forward.launches != before + 1:
        raise AssertionError(f"{what}: {nf4_matmul_forward.launches - before} launches")
    abs_err, rel_err = compare(what, lambda: y, lambda: nf4_matmul_reference(x, *args),
                               NF4_FWD_TOL)
    assert_reruns(what, lambda: nf4_matmul_forward(x, *args))
    ms = cuda_ms(lambda: nf4_matmul_forward(x, *args))
    plain_ms = cuda_ms(lambda: nf4_matmul_reference(x, *args), warmup=1, iters=5)
    dense = dequantize_4bit(args[0], code, absmax, (n, k), 64, torch.bfloat16, True)
    library_ms = cuda_ms(lambda: F.linear(x, dense))
    flops = 2 * m * n * k
    weight_bytes = args[0].numel() + absmax.numel() * 4 + code.numel() * 4
    bound_ms, bound_by = bound(x.numel() * 2 + weight_bytes + m * n * 2, flops)
    print(f"{what}: max abs err {abs_err:.3e} rel {rel_err:.3e} (tol {NF4_FWD_TOL}), one launch, "
          f"reruns bit-identical; kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s, "
          f"{ms / library_ms:.2f}x cuBLAS), plain {plain_ms:.3f} ms, F.linear on a bf16 weight "
          f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    return dict(shape=[m, n, k], max_abs_err=abs_err, rel_err=rel_err, ms=ms,
                tflops=flops / ms / 1e9, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms)


def cogview4_phase(device, wrappers: dict, profile: bool, checkout: Path) -> dict:
    """Phases 31-33, run in a process of its own (``--cogview4``): kernels
    B and C at head dim 128 at CogView4's shapes against their plain
    versions (C's registers and spills as ptxas reports them, its times
    beside SDPA's backward); CogView4Model generate() at full width and
    depth (launch counts, DeepCache, one CFG denoise step against the plain
    versions, a pool of 4 slots against batch-1 generate()); at full width
    and reduced depth the single-file checkpoint, the server's two
    schedulers, the CLI with an NF4 denoiser and the quant-compare tool
    with both groups in NF4 (kernel D); the Trainer on
    configs/cogview4/text_to_image.yml. Returns the CogView4 paths' launch
    counts, the kernels' records at these shapes and the numbers."""
    import dataclasses

    import yaml

    from vision_ft_tpu_torch.config import TrainConfig
    from vision_ft_tpu_torch.models.cogview4 import config as cv_config
    from vision_ft_tpu_torch.models.cogview4.pipeline import (
        CogView4Model, convert_from_original_key,
    )
    from vision_ft_tpu_torch.models.text_encoders.glm import COGVIEW4_GLM_CONFIG
    from vision_ft_tpu_torch.models.text_encoders.sentencepiece import (
        SentencePieceModel, SentencePieceTokenizer,
    )
    from vision_ft_tpu_torch.modules.peft import load_peft_weight
    from vision_ft_tpu_torch.tools import cogview4_quant_compare, inference_cli
    from vision_ft_tpu_torch.tools import inference_server as srv
    from vision_ft_tpu_torch.tools.ptxas_report import ptxas_report
    from vision_ft_tpu_torch.train.cogview4 import text_to_image
    from vision_ft_tpu_torch.training.optimizer import global_norm
    from vision_ft_tpu_torch.utils import safetensors as st

    # ptxas's view of kernel C runs on the host while the card works
    ptxas_job = concurrent.futures.ThreadPoolExecutor(1).submit(
        ptxas_report, "flash_attention_bshd_bwd")
    gen = torch.Generator(device=device).manual_seed(31)
    numbers = {}
    records = {"flash_attention_bshd": [], "flash_attention_bshd_dkv": [],
               "flash_attention_bshd_dq": [], "nf4_matmul_forward": []}
    path_launches = {name: 0 for name in wrappers}

    def read_launches():
        return {name: wrapper.launches for name, wrapper in wrappers.items()}

    @contextlib.contextmanager
    def on_path():
        """A CogView4 path's launches, added to the process's path counts;
        launches made to compare kernels with plain run outside."""
        before = read_launches()
        yield
        for name, count in read_launches().items():
            path_launches[name] += count - before[name]

    def free(model):
        for part in model._parts().values():
            part.to("meta")
        gc.collect()
        torch.cuda.empty_cache()

    def peak_gib():
        return torch.cuda.max_memory_allocated() / 2**30

    # -- 31: kernels B and C at head dim 128 ---------------------------------------------
    phase("31 kernels B and C at head dim 128 (CogView4's 32 heads of 128) and kernel D at GLM's "
          "and the DiT's widths vs plain (bf16)")
    for shape in COGVIEW4_ATTN_SHAPES:
        records["flash_attention_bshd"].append(bshd_forward_record(device, gen, *shape))
    for shape in COGVIEW4_BWD_SHAPES:
        dkv_record, dq_record = bshd_backward_records(device, gen, *shape)
        records["flash_attention_bshd_dkv"].append(dkv_record)
        records["flash_attention_bshd_dq"].append(dq_record)
    gc.collect()
    torch.cuda.empty_cache()

    for m, n, k in COGVIEW4_NF4_SHAPES:
        records["nf4_matmul_forward"].append(nf4_forward_record(device, gen, m, n, k))
    gc.collect()
    torch.cuda.empty_cache()

    ptxas = {}
    for kernel, info in sorted(ptxas_job.result(timeout=600).items()):
        if "flash_bwd_dkv_bshd_kernelILi128E" in kernel:
            ptxas["dkv"] = info
        elif "flash_bwd_dq_bshd_kernelILi128E" in kernel:
            ptxas["dq"] = info
    for which, info in sorted(ptxas.items()):
        print(f"kernel C {which} at D = 128, ptxas: {info.get('registers')} registers a thread, "
              f"{info.get('stack')} bytes of stack, {info.get('spill_stores')} bytes of spill "
              f"stores, {info.get('spill_loads')} of spill loads, notes {info.get('notes')}")
    if set(ptxas) != {"dkv", "dq"}:
        raise AssertionError(f"ptxas reported no D = 128 kernel C: {sorted(ptxas)}")
    numbers["kernel_c_d128_ptxas"] = ptxas

    # -- 32: generate() at full width -----------------------------------------------------
    phase("32 CogView4 generate() at full width, 8 of the DiT's 28 blocks and GLM-4 whole, bf16, "
          "seeded random weights; requests with do_offloading")
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_cogview4_"))
    try:
        (work / "tokenizer.model").write_bytes(lumina_vocab())
        tokenizer = SentencePieceTokenizer(SentencePieceModel.from_bytes(lumina_vocab()),
                                           template="none")

        class Model(CogView4Model):
            """Keeps the last latents generate() decoded, for the checks."""

            def decode_image(self, latents):
                self.last_latents = latents.clone()
                return super().decode_image(latents)

        torch.cuda.reset_peak_memory_stats()
        model = Model(cv_config.CogView4Config(
            checkpoint_path="", dtype="bfloat16",
            denoiser=cv_config.DenoiserConfig(**COGVIEW4_CUT_DEPTH)), tokenizer=tokenizer)
        start = time.perf_counter()
        model.init_params(torch.Generator(device=device).manual_seed(0))
        torch.cuda.synchronize()
        den = model.denoiser
        counts = [sum(p.numel() for p in part.parameters()) for part in model._parts().values()]
        weight_gb = sum(p.numel() * p.element_size() for part in model._parts().values()
                        for p in part.parameters()) / 1e9
        n_blocks = len(den.transformer_blocks)
        glm = model.text_encoder.model.config
        numbers.update(init_s=time.perf_counter() - start, weight_gb=weight_gb,
                       denoiser_params=counts[0], vae_params=counts[1],
                       text_encoder_params=counts[2])
        print(f"init on the card: {numbers['init_s']:.1f} s; DiT {counts[0] / 1e9:.3f} B, VAE "
              f"{counts[1] / 1e6:.1f} M, GLM-4 {counts[2] / 1e9:.3f} B parameters, {weight_gb:.1f} GB "
              f"of bf16 weights; DiT: {n_blocks} blocks, {den.inner_dim} wide, "
              f"{den.config.num_attention_heads} heads of {den.config.attention_head_dim}; GLM: "
              f"{glm.num_hidden_layers} layers, hidden {glm.hidden_size}, "
              f"{glm.num_attention_heads} heads over {glm.num_key_value_heads} kv heads")

        def expected(steps, interval=None, cache_depth=None):
            """Kernel B's launches of one request from the module tree and
            generate()'s DeepCache rule: each block one attention call
            (both CFG halves in one batch); GLM's attention is the plain
            formula."""
            shallow = cache_depth if cache_depth is not None else max(1, n_blocks // 4)
            launches, have_delta = 0, False
            for i in range(steps):
                launches += shallow if interval and i % interval != 0 and have_delta else n_blocks
                have_delta = have_delta or bool(interval)
            return launches

        def request(name, want, **kwargs):
            torch.cuda.reset_peak_memory_stats()
            before = read_launches()
            torch.cuda.synchronize()
            start = time.perf_counter()
            with on_path():
                images = model.generate(**kwargs)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - start
            launches = {k: v - before[k] for k, v in read_launches().items() if v != before[k]}
            peak = peak_gib()
            latents, arrays = model.last_latents, [np.asarray(im) for im in images]
            print(f"request {name}: {len(images)} image(s) {images[0].size}, "
                  f"{kwargs['num_inference_steps']} steps, CFG {kwargs['cfg_scale']}, "
                  f"{seconds:.3f} s, peak {peak:.2f} GiB; launches {launches}, expected kernel B "
                  f"{want}")
            if not torch.isfinite(latents).all() or any(a.std() == 0 for a in arrays):
                raise AssertionError(f"request {name}: latents not finite, or a constant image")
            if images[0].size != (kwargs["width"], kwargs["height"]) or latents.shape[1:] != (
                    kwargs["height"] // 8, kwargs["width"] // 8, 16):
                raise AssertionError(f"request {name}: wrong size {images[0].size}, {latents.shape}")
            if launches != {"flash_attention_bshd": want}:
                raise AssertionError(f"request {name}: launch counts {launches} != B {want}")
            return seconds, latents, arrays, peak

        base = dict(prompt="a photo of a cat sitting on the sofa", negative_prompt="blurry",
                    width=1024, height=1024, num_inference_steps=COGVIEW4_STEPS,
                    cfg_scale=COGVIEW4_CFG, seed=1234)
        runs = {}
        for name, kwargs in (("1 (cold)", base),
                             ("2", dict(base, prompt="a red car on the road in the mountains",
                                        seed=99)),
                             ("3 (= 1, warm)", base)):
            runs[name] = request(name, expected(COGVIEW4_STEPS), **kwargs)
        first, again = runs["1 (cold)"], runs["3 (= 1, warm)"]
        if not (torch.equal(first[1], again[1])
                and all(np.array_equal(x, y) for x, y in zip(first[2], again[2]))):
            raise AssertionError("request 3 (request 1 repeated, same seed) differs from it")
        seconds = [run[0] for run in runs.values()]
        numbers.update(first_request_s=seconds[0], warm_request_s=seconds[1:],
                       peak_gib=max(run[3] for run in runs.values()),
                       request_launches=expected(COGVIEW4_STEPS))
        print(f"s/request at 1024x1024, {COGVIEW4_STEPS} steps, CFG {COGVIEW4_CFG}: {seconds[0]:.3f} "
              f"cold (the first), {seconds[1]:.3f} and {seconds[2]:.3f} warm; peak "
              f"{numbers['peak_gib']:.2f} GiB; kernel B {expected(COGVIEW4_STEPS)} launches a request; "
              f"request 3 == request 1, bit for bit")
        cached = request("4 (deep_cache_interval 2)", expected(COGVIEW4_STEPS, interval=2),
                         **dict(base, deep_cache_interval=2))
        if torch.equal(cached[1], first[1]):
            raise AssertionError("the DeepCache request equals request 1: the option did nothing")
        numbers["offloading"] = offloaded_requests(
            "CogView4", model, lambda name, **kw: (lambda r: (r[0], r[1], r[3]))(
                request(name, expected(COGVIEW4_STEPS), **kw)), base, first[1])
        numbers.update(deep_cache_request_s=cached[0],
                       deep_cache_launches=expected(COGVIEW4_STEPS, interval=2))
        print(f"DeepCache request {cached[0]:.3f} s, kernel B {numbers['deep_cache_launches']} launches")

        # one CFG denoise step at 1024 px, kernel B against its plain version
        g32 = torch.Generator(device=device).manual_seed(32)
        step_latents = torch.randn(1, 128, 128, 16, device=device, generator=g32).bfloat16()
        sizes = [torch.full((2, 2), 1024.0, device=device)] * 2 + [torch.zeros(2, 2, device=device)]

        def encode(m):
            with torch.inference_mode():
                out = m.text_encoder.encode_prompts("a photo of a cat", "blurry",
                                                    use_negative_prompts=True)
                return torch.cat([out.positive_embeddings, out.negative_embeddings]).to(m.dtype)

        def denoise_step(m, emb, latents=step_latents):
            with torch.inference_mode():
                return m._denoise_step(latents, 800.0, 0.8, 0.75, emb, *sizes, COGVIEW4_CFG,
                                       do_cfg=True)

        def velocity(m, emb):
            # the step's guided velocity, as _denoise_step takes it
            t = torch.full((2,), float(np.float32(800.0)), device=device).bfloat16()
            with torch.inference_mode():
                v = m.denoiser(torch.cat([step_latents, step_latents]), emb, t, *sizes)
            positive, negative = v.chunk(2)
            return negative.float() + COGVIEW4_CFG * (positive - negative).float()

        emb = encode(model)
        step_ms = cuda_ms(lambda: denoise_step(model, emb), warmup=1, iters=5)
        before = read_launches()["flash_attention_bshd"]
        kernel_step = denoise_step(model, emb)
        step_launches = read_launches()["flash_attention_bshd"] - before
        kernel_velocity = velocity(model, emb)
        with plain_versions():
            plain_step, plain_velocity = denoise_step(model, emb), velocity(model, emb)
        errors = {}
        for what, got, want in (("velocity", kernel_velocity, plain_velocity),
                                ("latents", kernel_step, plain_step)):
            errors[what] = (got.float() - want.float()).abs().max().item() / \
                want.float().abs().max().item()
        numbers.update(step_ms=step_ms, step_velocity_err=errors["velocity"],
                       step_latents_err=errors["latents"], text_tokens=emb.shape[1])
        print(f"one CFG denoise step at 1024 px (batch 2, {emb.shape[1]} + 4096 joint tokens): "
              f"{step_ms:.1f} ms; kernel B launches {step_launches} (the module tree: {n_blocks}); "
              f"against the plain version of B: guided velocity {errors['velocity']:.3e}, the "
              f"step's latents {errors['latents']:.3e} of their largest value "
              f"(tol {COGVIEW4_STEP_TOL})")
        if step_launches != n_blocks:
            raise AssertionError(f"the denoise step launched kernel B {step_launches} times")
        if max(errors.values()) > COGVIEW4_STEP_TOL:
            raise AssertionError("the kernel's denoise step and the plain one disagree")
        if profile:
            kinds = profile_steps(lambda: denoise_step(model, emb), step_ms,
                                  "CogView4 CFG denoise step")
            print_kernel_ms(kinds, ("kernel B",), "CogView4 CFG denoise step")
            numbers["traced_step"] = {kind: [round(ms, 4), n] for kind, (ms, n) in kinds.items()}
        del emb, kernel_step, plain_step, kernel_velocity, plain_velocity

        # a pool of 4 slots at full depth through the server's continuous scheduler
        served = type("Served", (), {"model": model, "_family": "cogview4"})()
        sched = srv.ContinuousScheduler(served, height=1024, width=1024, num_slots=SERVE_SLOTS,
                                        max_steps=max(COGVIEW4_POOL_STEPS))
        kept, ticks = tap_pool(sched, wrappers)
        server, url = serving(sched)
        pool = [dict(prompt="a photo of a cat sitting on the sofa", negative_prompt="", seed=301,
                     inference_steps=COGVIEW4_POOL_STEPS[0], cfg_scale=COGVIEW4_CFG),
                dict(prompt="a red car on the road", negative_prompt="blurry", seed=302,
                     inference_steps=COGVIEW4_POOL_STEPS[1], cfg_scale=5.0),
                dict(prompt="a house in the mountains", negative_prompt="", seed=303,
                     inference_steps=COGVIEW4_POOL_STEPS[0], cfg_scale=1.0),
                dict(prompt="a cat in the house", negative_prompt="blurry", seed=304,
                     inference_steps=COGVIEW4_POOL_STEPS[1], cfg_scale=COGVIEW4_CFG)]
        pool = [dict(body, width=1024, height=1024) for body in pool]
        torch.cuda.reset_peak_memory_stats()
        try:
            with on_path():
                replies, seconds = post_all(url, pool, delays=[0.0, 0.3, 0.6, 0.9])
        finally:
            server.shutdown()
            server.server_close()
            sched.close()
        numbers["pool_s"], numbers["pool_peak_gib"] = seconds, peak_gib()
        if [webp_size(data) for data, _ in replies] != [(1024, 1024)] * 4:
            raise AssertionError("CogView4 pool: a reply of another size")
        print(f"continuous scheduler at full depth: 4 staggered requests ({COGVIEW4_POOL_STEPS} "
              f"steps, CFG 3.5, 5, 1, 3.5) in a pool of {SERVE_SLOTS} in {seconds:.3f} s, peak "
              f"{numbers['pool_peak_gib']:.2f} GiB")
        numbers["pool"] = tick_report("CogView4 pool", ticks, {"flash_attention_bshd": n_blocks})
        with on_path():
            numbers["pool_errors"] = hold_pool("CogView4 pool", kept, model, [dict(
                prompt=r["prompt"], negative_prompt=r["negative_prompt"], width=1024, height=1024,
                num_inference_steps=r["inference_steps"], cfg_scale=r["cfg_scale"],
                seed=r["seed"]) for r in pool])
        free(model)
        del model, den, served, sched, kept, ticks

        # -- 33: checkpoint, server, CLI and quant tool at reduced depth; the Trainer ----------
        phase("33 the CogView4 single-file checkpoint, server, CLI (NF4) and quant-compare tool "
              "at full width and reduced depth; the Trainer on configs/cogview4/text_to_image.yml")
        glm_reduced = dataclasses.replace(COGVIEW4_GLM_CONFIG,
                                          num_hidden_layers=COGVIEW4_REDUCED_GLM_LAYERS)
        reduced = cv_config.CogView4Config(checkpoint_path="", dtype="bfloat16",
                                           denoiser=cv_config.DenoiserConfig(**COGVIEW4_REDUCED))
        small = Model(reduced, tokenizer=tokenizer, text_encoder_config=glm_reduced)
        small.init_params(torch.Generator(device=device).manual_seed(33))
        step_before = denoise_step(small, encode(small))
        written = small.state_dict()
        path = work / "cogview4.safetensors"
        torch.cuda.synchronize()
        start = time.perf_counter()
        st.save_file(written, path)
        numbers["checkpoint_write_s"] = time.perf_counter() - start
        numbers["checkpoint_bytes"] = path.stat().st_size
        start = time.perf_counter()
        loaded = Model.from_checkpoint(reduced.model_copy(update={"checkpoint_path": str(path)}),
                                       tokenizer=tokenizer, text_encoder_config=glm_reduced)
        torch.cuda.synchronize()
        numbers["checkpoint_load_s"] = time.perf_counter() - start
        read = loaded.state_dict()
        if set(read) != set(written) or not all(torch.equal(written[k], read[k]) for k in read):
            raise AssertionError("the checkpoint loaded back differs from the model")
        if not torch.equal(step_before, denoise_step(loaded, encode(loaded))):
            raise AssertionError("the checkpoint's denoise step differs")
        print(f"single-file checkpoint (full width; {COGVIEW4_REDUCED['num_layers']} blocks, "
              f"{COGVIEW4_REDUCED_GLM_LAYERS} GLM layers): {numbers['checkpoint_bytes']} bytes in "
              f"the original keys (diffusion_model., text_encoder., vae.), written in "
              f"{numbers['checkpoint_write_s']:.2f} s, loaded by from_checkpoint in "
              f"{numbers['checkpoint_load_s']:.2f} s; every tensor and the denoise step bit-identical")
        free(loaded)
        free(small)
        del loaded, small, written, read, step_before

        # the server's, the CLI's and the tool's model at the file's depth (a YAML names the
        # DiT's; none names GLM's, and the CLI and the tool name only the file)
        build = CogView4Model.__init__

        def at_file_depth(self, config, tokenizer=None, **kwargs):
            build(self, config.model_copy(update={"denoiser": reduced.denoiser}),
                  tokenizer=tokenizer, text_encoder_config=glm_reduced)

        CogView4Model.__init__ = at_file_depth
        try:
            write_yaml(work / "cogview4.yml", {"checkpoint_path": str(path), "dtype": "bfloat16",
                                               "denoiser": reduced.denoiser.model_dump()})
            start = time.perf_counter()
            served = srv.T2IModel(str(work / "cogview4.yml"), None, str(work), family="cogview4")
            srv.prepare_kernels("cogview4", device)
            numbers["serve_load_s"] = time.perf_counter() - start
            blocks = COGVIEW4_REDUCED["num_layers"]
            batcher = srv.MicroBatcher(served, max_batch=4, window_ms=2000)
            server, url = serving(batcher)
            window = [dict(prompt=p, negative_prompt="", width=1024, height=1024,
                           inference_steps=COGVIEW4_POOL_STEPS[0], cfg_scale=COGVIEW4_CFG)
                      for p in ("a photo of a cat", "a red car on the road")]
            before = read_launches()
            try:
                with on_path():
                    replies, seconds = post_all(url, window)
            finally:
                server.shutdown()
                server.server_close()
            launched = read_launches()["flash_attention_bshd"] - before["flash_attention_bshd"]
            numbers["window_s"] = seconds
            if [webp_size(data) for data, _ in replies] != [(1024, 1024)] * 2 or \
                    launched != COGVIEW4_POOL_STEPS[0] * blocks:
                raise AssertionError(f"window scheduler: replies {len(replies)}, B launched {launched}")
            print(f"server from {path.name} via a YAML (load {numbers['serve_load_s']:.2f} s): window "
                  f"scheduler, 2 concurrent compatible requests in one generate() of batch 2 in "
                  f"{seconds:.3f} s, kernel B {launched} launches ({COGVIEW4_POOL_STEPS[0]} steps x "
                  f"{blocks} blocks)")
            sched = srv.ContinuousScheduler(served, height=1024, width=1024, num_slots=2,
                                            max_steps=max(COGVIEW4_POOL_STEPS))
            server, url = serving(sched)
            try:
                with on_path():
                    replies, seconds = post_all(url, [dict(body, inference_steps=n) for body, n in
                                                      zip(window, COGVIEW4_POOL_STEPS)],
                                                delays=[0.0, 0.3])
            finally:
                server.shutdown()
                server.server_close()
                sched.close()
            if [webp_size(data) for data, _ in replies] != [(1024, 1024)] * 2:
                raise AssertionError("the continuous scheduler's replies")
            numbers["continuous_s"] = seconds
            print(f"continuous scheduler (2 slots): 2 staggered requests of "
                  f"{COGVIEW4_POOL_STEPS} steps in {seconds:.3f} s")
            free(served.model)
            del served, sched

            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            start = time.perf_counter()
            with on_path():
                before = read_launches()
                saved = inference_cli.main([
                    "--family", "cogview4", "--checkpoint-path", str(path), "--tokenizer-path",
                    str(work), "--width", "1024", "--height", "1024", "--num-inference-steps",
                    str(COGVIEW4_POOL_STEPS[0]), "--cfg-scale", str(COGVIEW4_CFG), "--quant-type",
                    "bnb_nf4", "--save-path", str(work / "cli.webp")])
                cli = {k: v - before[k] for k, v in read_launches().items() if v != before[k]}
            numbers["cli_s"], numbers["cli_peak_gib"] = time.perf_counter() - start, peak_gib()
            if saved != [str(work / "cli.webp")] or Image.open(saved[0]).size != (1024, 1024):
                raise AssertionError(f"the CLI saved {saved}")
            # the denoiser's Linears kernel D takes, a forward: text_proj, the time and size
            # embedders' 4, a block's adaLN, 4 attention projections and 2 FF Linears on
            # both streams, the final adaLN; patch_embed.proj (K = 64) and proj_out (N = 64)
            # are left unquantized by the CLI (kernel D does not take them)
            d_per_forward = 1 + 4 + 9 * blocks + 1
            want_cli = {"flash_attention_bshd": COGVIEW4_POOL_STEPS[0] * blocks,
                        "nf4_matmul_forward": COGVIEW4_POOL_STEPS[0] * d_per_forward}
            print(f"CLI --family cogview4 --quant-type bnb_nf4 (load, quantize, 1024 px, "
                  f"{COGVIEW4_POOL_STEPS[0]} steps, CFG {COGVIEW4_CFG}, webp): {numbers['cli_s']:.2f} s, "
                  f"peak {numbers['cli_peak_gib']:.2f} GiB; launches {cli} (expected {want_cli})")
            if cli != want_cli:
                raise AssertionError(f"the CLI launched {cli}, expected {want_cli}")

            torch.cuda.reset_peak_memory_stats()
            with on_path():
                before = read_launches()
                report = cogview4_quant_compare.main([
                    "--model_path", str(path), "--tokenizer_path", str(work), "--text_encoder",
                    "bnb_nf4", "--denoiser", "bnb_nf4", "--height", "1024", "--width", "1024",
                    "--num_inference_steps", str(COGVIEW4_POOL_STEPS[0]), "--output_dir",
                    str(work / "quant")])
                tool = {k: v - before[k] for k, v in read_launches().items() if v != before[k]}
            # GLM: one encode of the prompt and the negative, 6 Linears a layer; the DiT: a
            # block's 4 projections and its 2 FF Linears on both streams, one CFG forward a step
            want_tool = {"flash_attention_bshd": COGVIEW4_POOL_STEPS[0] * blocks,
                         "nf4_matmul_forward": 6 * COGVIEW4_REDUCED_GLM_LAYERS
                         + COGVIEW4_POOL_STEPS[0] * 8 * blocks}
            numbers["quant_compare"] = report
            print(f"quant-compare tool (GLM and DiT groups in NF4): {report}; launches {tool} "
                  f"(expected {want_tool})")
            if tool != want_tool or report["nf4_launches"] != want_tool["nf4_matmul_forward"]:
                raise AssertionError(f"the quant-compare tool launched {tool}, expected {want_tool}")
            if not (work / "quant" / f"{report['run']}.webp").exists():
                raise AssertionError("the quant-compare tool wrote no image")
        finally:
            CogView4Model.__init__ = build
        gc.collect()
        torch.cuda.empty_cache()
        path.unlink()

        # the Trainer on configs/cogview4/text_to_image.yml at full width, 8 of the DiT's blocks
        folder = work / "images"
        folder.mkdir()
        img_rng = np.random.default_rng(33)
        for i in range(COGVIEW4_TRAINER_IMAGES):
            smooth = img_rng.integers(0, 255, (32, 32, 3), dtype=np.uint8)
            Image.fromarray(smooth).resize((1024, 1024), Image.BILINEAR).save(folder / f"{i}.png")
            (folder / f"{i}.txt").write_text(COGVIEW4_TRAINER_CAPTIONS[i % len(COGVIEW4_TRAINER_CAPTIONS)])
        (work / "preview.yml").write_text(yaml.safe_dump([dict(
            prompt="a photo of a cat", negative_prompt="blurry", height=1024, width=1024,
            cfg_scale=COGVIEW4_CFG, num_steps=COGVIEW4_PREVIEW_STEPS, seed=0)]))
        raw = yaml.safe_load((checkout / "configs/cogview4/text_to_image.yml").read_text())
        raw["model"].update(checkpoint_path=str(work / "absent.safetensors"),
                            denoiser=dict(COGVIEW4_CUT_DEPTH))
        raw["dataset"].update(folder=str(folder), num_workers=0)
        raw["num_train_epochs"] = 1
        raw["saving"]["callbacks"][0]["save_dir"] = str(work / "lora")
        raw["preview"] = {"strategy": {"per_epochs": 1, "per_steps": None},
                          "callbacks": [{"type": "local", "save_dir": str(work / "preview")}],
                          "data": {"path": str(work / "preview.yml")}}
        config = TrainConfig.model_validate(raw, strict=True)
        trainer = text_to_image.build_trainer(config, tokenizer=tokenizer)
        steps, preview_launches = [], []
        preview_step = trainer.model.preview_step

        def counted_preview(*args, **kwargs):
            before = read_launches()
            out = preview_step(*args, **kwargs)
            preview_launches.append({k: v - before[k] for k, v in read_launches().items()
                                     if v != before[k]})
            return out

        trainer.model.preview_step = counted_preview
        prepare_optimizer = trainer.prepare_optimizer

        def prepare_and_time():
            prepare_optimizer()
            inner = trainer._step

            def timed_step(state, batch, generator):
                torch.cuda.synchronize()
                before = read_launches()
                start = time.perf_counter()
                state, metrics = inner(state, batch, generator)
                loss = metrics["train/loss"].item()
                torch.cuda.synchronize()
                steps.append((time.perf_counter() - start, loss,
                              {k: v - before[k] for k, v in read_launches().items()
                               if v != before[k]}, batch))
                return state, metrics

            trainer._step = timed_step

        trainer.prepare_optimizer = prepare_and_time
        torch.cuda.reset_peak_memory_stats()
        start = time.perf_counter()
        with on_path():
            trainer.train()
        torch.cuda.synchronize()
        numbers.update(train_s=time.perf_counter() - start, train_peak_gib=peak_gib(),
                       losses=[loss for _, loss, _, _ in steps],
                       run_step_ms=[t * 1e3 for t, *_ in steps])
        n_blocks = len(trainer.model.model.denoiser.transformer_blocks)
        per_step = {"flash_attention_bshd": n_blocks, "flash_attention_bshd_dkv": n_blocks,
                    "flash_attention_bshd_dq": n_blocks}
        print(f"Trainer on configs/cogview4/text_to_image.yml ({config.optimizer.name} "
              f"{config.optimizer.args}, LoRA rank {config.peft.config.rank} on "
              f"{config.peft.include_keys}, batch {config.dataset['batch_size']}, gradient "
              f"checkpointing {config.trainer.gradient_checkpointing}; seeded weights, one epoch "
              f"of {COGVIEW4_TRAINER_IMAGES} 1024x1024 images): {numbers['train_s']:.1f} s; "
              f"{len(steps)} steps over batches {[tuple(b['pixel_values'].shape) for *_, b in steps]}, "
              f"text lengths {[b['input_ids'].shape[1] for *_, b in steps]}; losses "
              f"{numbers['losses']}; ms a step {[round(t * 1e3, 1) for t, *_ in steps]} (host clock, "
              f"synchronized, step 1 cold); peak {numbers['train_peak_gib']:.2f} GiB; launches a "
              f"step {steps[0][2]} (expected {per_step}); the preview's {preview_launches}")
        if len(steps) != COGVIEW4_TRAINER_IMAGES // 2 or not all(np.isfinite(numbers["losses"])):
            raise AssertionError(f"the Trainer took {len(steps)} steps, losses {numbers['losses']}")
        bad = [launches for _, _, launches, _ in steps if launches != per_step]
        if bad:
            raise AssertionError(f"Trainer steps launched {bad[:2]}, expected {per_step} each")
        if preview_launches != [{"flash_attention_bshd": COGVIEW4_PREVIEW_STEPS * n_blocks}]:
            raise AssertionError(f"the preview launched {preview_launches}")
        previews = sorted((work / "preview").glob("*"))
        if len(previews) != 1 or Image.open(previews[0]).size != (1024, 1024):
            raise AssertionError(f"preview images {previews}")

        # warm steps on one batch (traced under --profile)
        batch = steps[-1][3]
        warm = []
        for seed in (5, 6, 7):
            trainer.state, _ = trainer._step(trainer.state, batch,
                                             torch.Generator(device=device).manual_seed(seed))
            warm.append(steps[-1][0] * 1e3)
        numbers["warm_step_ms"] = warm
        if profile:
            def train_step():
                trainer.state, _ = trainer._step(trainer.state, batch,
                                                 torch.Generator(device=device).manual_seed(8))

            kinds = profile_steps(train_step, statistics.median(warm), "CogView4 Trainer step")
            print_kernel_ms(kinds, ("kernel B", "kernel C dk/dv", "kernel C dq"),
                            "CogView4 Trainer step")
            numbers["traced_train_step"] = {kind: [round(ms, 4), n] for kind, (ms, n) in kinds.items()}

        # a depth-reduced step (full width) of the trained model, kernels vs plain versions
        den = trainer.model.model.denoiser
        full = den.transformer_blocks
        den.transformer_blocks = torch.nn.ModuleDict(
            {str(i): full[str(i)] for i in range(COGVIEW4_REDUCED["num_layers"])})
        params = [p for k, p in trainer.trainable.items()
                  if int(k.split(".")[2]) < COGVIEW4_REDUCED["num_layers"]]

        def loss_and_grads():
            loss, _ = trainer.model.loss_fn(batch, torch.Generator(device=device).manual_seed(9))
            return loss.item(), torch.autograd.grad(loss, params)

        try:
            before = read_launches()
            kernel_loss, kernel_grads = loss_and_grads()
            used = {k: v - before[k] for k, v in read_launches().items() if v != before[k]}
            with plain_versions():
                plain_loss, plain_grads = loss_and_grads()
        finally:
            den.transformer_blocks = full
        kernel_norm, plain_norm = global_norm(kernel_grads).item(), global_norm(plain_grads).item()
        loss_rel = abs(kernel_loss - plain_loss) / abs(plain_loss)
        norm_rel = abs(kernel_norm - plain_norm) / abs(plain_norm)
        blocks = COGVIEW4_REDUCED["num_layers"]
        print(f"depth-reduced step ({blocks} blocks, full width), kernels vs plain versions: loss "
              f"{kernel_loss:.6f} vs {plain_loss:.6f} (rel {loss_rel:.3e}, tol {STEP_LOSS_TOL}); "
              f"grad_norm {kernel_norm:.6f} vs {plain_norm:.6f} (rel {norm_rel:.3e}, tol "
              f"{STEP_GRAD_NORM_TOL}); launches {used}")
        if used != {k: blocks for k in per_step}:
            raise AssertionError(f"the reduced step's launches: {used}")
        if not (loss_rel <= STEP_LOSS_TOL and norm_rel <= STEP_GRAD_NORM_TOL):
            raise AssertionError("the CogView4 trainer's kernel step and the plain step disagree")
        numbers.update(reduced_loss_rel=loss_rel, reduced_grad_norm_rel=norm_rel)
        saved = sorted((work / "lora").glob("*.safetensors"))
        lora_state = st.load_file(saved[-1]) if saved else {}
        # the saved LoRA (last: loading it replaces the adapters the Trainer's state holds)
        adapters = trainer.model.get_state_dict_to_save()
        if len(saved) != 1 or set(lora_state) != set(adapters) or not all(
                k.startswith("diffusion_model.") for k in lora_state):
            raise AssertionError(f"saved LoRA {saved}: {len(lora_state)} keys")
        lora_path = work / "lora_again.safetensors"
        torch.cuda.synchronize()
        start = time.perf_counter()
        st.save_file(adapters, lora_path)
        numbers["lora_write_s"] = time.perf_counter() - start
        numbers["lora_bytes"] = lora_path.stat().st_size
        start = time.perf_counter()
        load_peft_weight(trainer.model.get_params(), {
            convert_from_original_key(k): v for k, v in st.load_file(lora_path).items()})
        torch.cuda.synchronize()
        numbers["lora_load_s"] = time.perf_counter() - start
        back = trainer.model.get_state_dict_to_save()
        if set(back) != set(adapters) or not all(torch.equal(back[k], adapters[k]) for k in back):
            raise AssertionError("the LoRA file loaded back differs from the adapters saved")
        print(f"warm steps {[round(t, 1) for t in warm]} ms at batch 2, 1024 px; the Trainer saved "
              f"{saved[-1].name}: {len(lora_state)} keys in ComfyUI names; the adapters again: "
              f"{numbers['lora_bytes']} bytes written in {numbers['lora_write_s']:.3f} s, loaded "
              f"into the model in {numbers['lora_load_s']:.3f} s, bit-identical")

        free(trainer.model.model)
        del trainer, den, full, params, kernel_grads, plain_grads, batch, steps
    finally:
        shutil.rmtree(work, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": path_launches, "records": records, "numbers": numbers}


# the Wan phases (34-36, ``--wan``): kernel B at head dim 128 with 24 heads, Wan's shapes
# (B, Sq, Sk, H*D, H): self-attention over the video tokens and cross-attention from them to
# the 512 text positions; 49 frames at 704 x 704 are 12 latent frames of 22 x 22 patches
WAN_ATTN_SHAPES = [
    (2, 5808, 5808, 3072, 24),    # a 704 px, 49-frame request under CFG: 12 * 22 * 22 tokens
    (2, 5808, 512, 3072, 24),     # its cross-attention: Sq past a multiple of 128, 512 keys
    (4, 5808, 5808, 3072, 24),    # the window scheduler's batch of 2 requests under CFG
    (4, 5808, 512, 3072, 24),
    (1, 26400, 26400, 3072, 24),  # the published 720p setting, 121 frames: 30 * 22 * 40
]
# kernel D's forward at the DiT's Linears (M, N, K) in the CLI's --quant-type run at the
# request's size: q / k / v / o and the feed-forward on the video tokens under CFG (2 x 5808
# rows), cross k / v and the text embedding on 2 x 512, the time MLP on 2 rows
WAN_NF4_SHAPES = [
    (11616, 3072, 3072),   # self_attn / cross_attn q, o; self_attn k, v
    (11616, 14336, 3072),  # ffn.0
    (11616, 3072, 14336),  # ffn.2
    (1024, 3072, 3072),    # cross_attn k, v; text_embedding.2
    (1024, 3072, 4096),    # text_embedding.0
    (2, 18432, 3072),      # time_projection.1
    (2, 3072, 256),        # time_embedding.0
]
WAN_STEPS = 8  # the requests' steps (the pipeline's default is 25)
WAN_CFG = 5.0
WAN_FRAMES, WAN_SIZE = 49, 704
# one full-depth CFG denoise step (30 blocks), kernel B against its plain version, bf16,
# random weights: each block's few-ulp differences carried on; relative to the largest value
# of the velocity or the latents (FLUX_STEP_TOL)
WAN_STEP_TOL = 5e-2
# request 3 (request 1 again) against request 1: the latents bit for bit (no convolution on
# their path); the decoded frames within this many of 255 levels, since cuDNN picks its 3-D
# convolution algorithms by the memory free beside it and another algorithm sums in another
# order (fp32 accumulation; rounding to uint8 can move a value by a level)
WAN_FRAME_TOL = 2
WAN_REDUCED_LAYERS = 2  # DiT blocks and UMT5 layers, full width, for the files, server, CLI
WAN_CUT_LAYERS = 8  # phase 35's DiT blocks (of 30; full before phases 43-46), UMT5 whole
WAN_SERVE = dict(frames=17, size=512, steps=4)  # 4 latent frames of 16 x 16 patches
WAN_WINDOW_SEED = 4242  # the seed the window's unseeded batch is given, to hold it to batch 1


def mp4_frames(data: bytes, work: Path) -> tuple[float, list]:
    """An mp4's frame rate and frames (OpenCV), from its bytes."""
    import cv2

    path = work / "reply.mp4"
    path.write_bytes(data)
    capture = cv2.VideoCapture(str(path))
    fps, frames = capture.get(cv2.CAP_PROP_FPS), []
    while True:
        ok, frame = capture.read()
        if not ok:
            break
        frames.append(frame)
    capture.release()
    path.unlink()
    return fps, frames


def wan_phase(device, wrappers: dict, profile: bool) -> dict:
    """Phases 34-36, run in a process of its own (``--wan``): kernel B at
    Wan's self- and cross-attention shapes and kernel A without beta at
    UMT5's C 4096 against their plain versions, kernel D at the DiT's
    widths; Wan22 generate() at full width and depth with cuDNN's TF32 on,
    as PyTorch has it by default (704 x 704, 49 frames:
    launch counts, a repeat bit-identical, DeepCache, one CFG denoise step
    against the plain versions); at full width and reduced depth the
    three-file checkpoint, the server's window scheduler (mp4 replies, each
    row against batch-1 generate()) and the CLI with and without NF4.
    Returns the Wan paths' launch counts, the kernels' records at these
    shapes and the numbers."""
    import cv2

    from vision_ft_tpu_torch.models.text_encoders.sentencepiece import (
        SentencePieceModel, SentencePieceTokenizer,
    )
    from vision_ft_tpu_torch.models.wan import Wan22, WanConfig
    from vision_ft_tpu_torch.models.wan.config import Wan22TI2V5BDenoiserConfig
    from vision_ft_tpu_torch.models.wan.text_encoder import TextEncoderConfig
    from vision_ft_tpu_torch.ops.layer_norm import layer_norm, layer_norm_reference
    from vision_ft_tpu_torch.tools import inference_cli
    from vision_ft_tpu_torch.tools import inference_server as srv
    from vision_ft_tpu_torch.utils import safetensors as st

    gen = torch.Generator(device=device).manual_seed(34)
    numbers = {"cv2": cv2.__version__}
    records = {"flash_attention_bshd": [], "layer_norm": [], "nf4_matmul_forward": []}
    path_launches = {name: 0 for name in wrappers}

    def read_launches():
        return {name: wrapper.launches for name, wrapper in wrappers.items()}

    def launched_since(before):
        return {k: v - before[k] for k, v in read_launches().items() if v != before[k]}

    @contextlib.contextmanager
    def on_path():
        """A Wan path's launches, added to the process's path counts;
        launches made to compare kernels with plain run outside."""
        before = read_launches()
        yield
        for name, count in read_launches().items():
            path_launches[name] += count - before[name]

    def free(model):
        for part in (model.denoiser, model.text_encoder, model.vae):
            part.to("meta")
        gc.collect()
        torch.cuda.empty_cache()

    def peak_gib():
        return torch.cuda.max_memory_allocated() / 2**30

    tokenizer = SentencePieceTokenizer(SentencePieceModel.from_bytes(lumina_vocab()),
                                       template="eos")
    prompt, negative = "a photo of a cat sitting on the sofa", "blurry"
    text_len = max(len(tokenizer.encode(t)) for t in (prompt, negative))

    # -- 34: kernels B, A and D at Wan's shapes ---------------------------------------------
    phase("34 kernel B at Wan's self- and cross-attention shapes, kernel A without beta at "
          "UMT5's C 4096 and kernel D at the DiT's widths vs plain (bf16)")
    for b, sq, sk, inner, h in WAN_ATTN_SHAPES:
        records["flash_attention_bshd"].append(bshd_forward_record(device, gen, b, sq, sk, inner, h))
    # UMT5's LayerNorms: the prompt and the negative (padded to the longer) as one batch, and
    # two prompts of the full 512 tokens
    for n_rows in (2 * text_len, 2 * 512):
        x, w, _ = ln_inputs(n_rows, 4096, False, device, gen)
        what = f"kernel A without beta at rows={n_rows} C=4096"
        before = layer_norm.launches
        layer_norm(x, w, None)
        if layer_norm.launches != before + 1:
            raise AssertionError(f"{what}: {layer_norm.launches - before} launches")
        abs_err, rel_err = compare(what, lambda: layer_norm(x, w, None),
                                   lambda: layer_norm_reference(x, w, None), LN_TOL)
        assert_reruns(what, lambda: layer_norm(x, w, None))
        kernel = call_costs(lambda: layer_norm(x, w, None))
        library = call_costs(lambda: F.layer_norm(x, (4096,), w, None))
        plain_ms = cuda_ms(lambda: layer_norm_reference(x, w, None))
        bound_ms, bound_by = bound(2 * x.numel() * 2 + 4096 * 2, 8 * x.numel(), PEAK_FP32_FLOPS)
        print(f"{what}: max abs err {abs_err:.3e} rel {rel_err:.3e} (tol {LN_TOL}), one launch, "
              f"reruns bit-identical; kernel {kernel['ms']:.4f} ms one call, "
              f"{kernel['burst_ms']:.4f} a call over 10 back to back, host {kernel['host_us']:.1f} "
              f"us; plain {plain_ms:.4f} ms; F.layer_norm {library['ms']:.4f} ms one call, "
              f"{library['burst_ms']:.4f} back to back, host {library['host_us']:.1f} us; bound "
              f"{bound_ms:.5f} ms ({bound_by})")
        records["layer_norm"].append(dict(
            shape=[n_rows, 4096], max_abs_err=abs_err, rel_err=rel_err, ms=kernel["ms"],
            burst_ms=kernel["burst_ms"], host_us=kernel["host_us"], plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=library["ms"],
            library_burst_ms=library["burst_ms"], library_host_us=library["host_us"]))
        del x, w
    for m, n, k in WAN_NF4_SHAPES:
        records["nf4_matmul_forward"].append(nf4_forward_record(device, gen, m, n, k))
    gc.collect()
    torch.cuda.empty_cache()

    # -- 35: generate() at full width ---------------------------------------------------
    phase(f"35 Wan 2.2 TI2V-5B generate() at full width, {WAN_CUT_LAYERS} of the DiT's 30 blocks "
          f"and UMT5 whole, {WAN_SIZE} x {WAN_SIZE}, {WAN_FRAMES} frames, "
          f"bf16, seeded random weights")
    # the requests run as a user's process runs them: PyTorch's default cuDNN setting, TF32 on
    # (the VAE's fp32 convolutions); phase 0's full fp32 stays for matmuls
    torch.backends.cudnn.allow_tf32 = True
    print(f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} (PyTorch's default) for the "
          f"requests; matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_wan_"))
    try:
        (work / "tokenizer.model").write_bytes(lumina_vocab())

        class Model(Wan22):
            """Keeps the last latents generate() decoded and times the decode."""

            def decode_videos(self, latents):
                self.last_latents = latents.clone()
                torch.cuda.synchronize()
                start = time.perf_counter()
                videos = super().decode_videos(latents)
                self.decode_s = time.perf_counter() - start
                return videos

        paths = dict(denoiser_path=str(work / "denoiser.safetensors"),
                     text_encoder_path=str(work / "text_encoder.safetensors"),
                     vae_path=str(work / "vae.safetensors"))
        torch.cuda.reset_peak_memory_stats()
        model = Model(WanConfig(**paths, dtype="bfloat16",
                                denoiser=Wan22TI2V5BDenoiserConfig(num_layers=WAN_CUT_LAYERS)),
                      tokenizer=tokenizer)
        start = time.perf_counter()
        model.init_params(torch.Generator(device=device).manual_seed(0))
        model.vae.init_random(torch.Generator(device=device).manual_seed(1))
        torch.cuda.synchronize()
        den, t5 = model.denoiser, model.text_encoder.model
        counts = [sum(p.numel() for p in part.parameters())
                  for part in (den, model.text_encoder, model.vae)]
        weight_gb = sum(p.numel() * p.element_size() for part in (den, model.text_encoder, model.vae)
                        for p in part.parameters()) / 1e9
        n_blocks, n_layers = len(den.blocks), len(t5.blocks)
        per_encoding = 2 * n_layers + 1  # norm1, norm2 a layer and the final norm
        numbers.update(init_s=time.perf_counter() - start, weight_gb=weight_gb,
                       denoiser_params=counts[0], text_encoder_params=counts[1],
                       vae_params=counts[2])
        print(f"init on the card: {numbers['init_s']:.1f} s; DiT {counts[0] / 1e9:.3f} B, UMT5 "
              f"{counts[1] / 1e9:.3f} B, VAE {counts[2] / 1e6:.1f} M parameters (VAE fp32), "
              f"{weight_gb:.1f} GB of weights; DiT: {n_blocks} blocks, {den.dim} wide, "
              f"{den.num_heads} heads of {den.dim // den.num_heads}, text_len {den.text_len}; "
              f"UMT5: {n_layers} layers, dim {t5.config.dim}, {t5.config.num_heads} heads, vocab "
              f"{t5.config.vocab_size}; kernel A {per_encoding} launches a prompt encoding")

        def expected(steps, interval=None, cache_depth=None):
            """Kernel B's launches of one request from the module tree and
            generate()'s DeepCache rule: each block a self- and a
            cross-attention call (both CFG halves in one batch)."""
            shallow = cache_depth if cache_depth is not None else max(1, n_blocks // 4)
            launches, have_delta = 0, False
            for i in range(steps):
                blocks = shallow if interval and i % interval != 0 and have_delta else n_blocks
                launches += 2 * blocks
                have_delta = have_delta or bool(interval)
            return launches

        latent_shape = (1, (WAN_FRAMES // 4 * 4 - 1) // 4 + 1, WAN_SIZE // 16, WAN_SIZE // 16, 48)

        def request(name, want_b, **kwargs):
            torch.cuda.reset_peak_memory_stats()
            before = read_launches()
            torch.cuda.synchronize()
            start = time.perf_counter()
            with on_path():
                videos = model.generate(**kwargs)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - start
            launches, peak = launched_since(before), peak_gib()
            latents = model.last_latents
            frames = np.stack([np.asarray(im) for im in videos[0]])
            want = {"flash_attention_bshd": want_b, "layer_norm": per_encoding}
            print(f"request {name}: {len(videos[0])} frames {videos[0][0].size}, "
                  f"{kwargs['num_inference_steps']} steps, CFG {kwargs['cfg_scale']}, "
                  f"{seconds:.3f} s (the VAE decode {model.decode_s:.3f} s), peak {peak:.2f} GiB; "
                  f"launches {launches}, expected {want}")
            if not torch.isfinite(latents).all() or frames.std() == 0:
                raise AssertionError(f"request {name}: latents not finite, or a constant video")
            if tuple(latents.shape) != latent_shape or frames.shape != (
                    4 * (latent_shape[1] - 1) + 1, WAN_SIZE, WAN_SIZE, 3):
                raise AssertionError(f"request {name}: latents {tuple(latents.shape)}, frames "
                                     f"{frames.shape}")
            if launches != want:
                raise AssertionError(f"request {name}: launch counts {launches} != {want}")
            return seconds, latents, frames, peak, model.decode_s

        base = dict(prompt=prompt, negative_prompt=negative, frames=WAN_FRAMES, width=WAN_SIZE,
                    height=WAN_SIZE, num_inference_steps=WAN_STEPS, cfg_scale=WAN_CFG, seed=1234)
        runs = {}
        for name, kwargs in (("1 (cold)", base),
                             ("2", dict(base, prompt="a red car on the road in the mountains",
                                        seed=99)),
                             ("3 (= 1, warm)", base)):
            runs[name] = request(name, expected(WAN_STEPS), **kwargs)
        first, again = runs["1 (cold)"], runs["3 (= 1, warm)"]
        latents_equal = torch.equal(first[1], again[1])
        frame_diff = np.abs(first[2].astype(np.int16) - again[2].astype(np.int16))
        frames_note = ("frames bit-identical" if not frame_diff.any() else
                       f"frames within {frame_diff.max()} of {WAN_FRAME_TOL} levels "
                       f"({np.count_nonzero(frame_diff)} values differ)")
        if not latents_equal or frame_diff.max() > WAN_FRAME_TOL:
            raise AssertionError(f"request 3 (request 1 repeated, same seed) differs from it: "
                                 f"latents bit-identical {latents_equal}; {frames_note}")
        seconds = [run[0] for run in runs.values()]
        numbers.update(first_request_s=seconds[0], warm_request_s=seconds[1:],
                       decode_s=[run[4] for run in runs.values()],
                       peak_gib=max(run[3] for run in runs.values()),
                       request_launches=expected(WAN_STEPS), video_tokens=int(np.prod(
                           latent_shape[1:4])) // 4)
        print(f"s/request at {WAN_SIZE} x {WAN_SIZE}, {WAN_FRAMES} frames ({latent_shape[1]} latent "
              f"frames, {numbers['video_tokens']} tokens), {WAN_STEPS} steps, CFG {WAN_CFG}: "
              f"{seconds[0]:.3f} cold (the first), {seconds[1]:.3f} and {seconds[2]:.3f} warm; peak "
              f"{numbers['peak_gib']:.2f} GiB; kernel B {expected(WAN_STEPS)} and kernel A "
              f"{per_encoding} launches a request; request 3's latents == request 1's, bit for "
              f"bit, {frames_note}")
        cached = request("4 (deep_cache_interval 2)", expected(WAN_STEPS, interval=2),
                         **dict(base, deep_cache_interval=2))
        if torch.equal(cached[1], first[1]):
            raise AssertionError("the DeepCache request equals request 1: the option did nothing")
        numbers.update(deep_cache_request_s=cached[0],
                       deep_cache_launches=expected(WAN_STEPS, interval=2))
        print(f"DeepCache request {cached[0]:.3f} s, kernel B {numbers['deep_cache_launches']} "
              f"launches ({2 * max(1, n_blocks // 4)} on a cached step)")
        del runs, first, again, cached

        # one CFG denoise step at the request's size, kernel B against its plain version
        g35 = torch.Generator(device=device).manual_seed(35)
        step_latents = torch.randn(*latent_shape, device=device, generator=g35).bfloat16()

        def encode(m):
            with torch.inference_mode():
                out = m.text_encoder.encode_prompts(prompt, negative, use_negative_prompts=True)
                emb = torch.cat([out.positive_embeddings, out.negative_embeddings])
                mask = torch.cat([out.positive_attention_mask, out.negative_attention_mask])
                return (emb * mask[:, :, None].to(emb.dtype)).to(m.dtype)

        def denoise_step(m, ctx, latents=step_latents):
            with torch.inference_mode():
                return m._denoise_step(latents, 800.0, 0.8, 0.75, ctx, WAN_CFG, do_cfg=True)

        def velocity(m, ctx):
            t = torch.full((2,), 800.0, device=device)
            with torch.inference_mode():
                v = m.denoiser(torch.cat([step_latents, step_latents]), t, ctx)
            positive, negative_v = v.float().chunk(2)
            return negative_v + (positive - negative_v) * WAN_CFG

        before = read_launches()
        ctx = encode(model)
        encode_launches = launched_since(before)
        encode_ms = cuda_ms(lambda: encode(model), warmup=1, iters=5)
        step_ms = cuda_ms(lambda: denoise_step(model, ctx), warmup=1, iters=3)
        before = read_launches()
        kernel_step = denoise_step(model, ctx)
        step_launches = launched_since(before)
        kernel_velocity = velocity(model, ctx)
        with plain_versions():
            plain_step, plain_velocity = denoise_step(model, ctx), velocity(model, ctx)
        errors = {}
        for what, got, want in (("velocity", kernel_velocity, plain_velocity),
                                ("latents", kernel_step, plain_step)):
            errors[what] = (got.float() - want.float()).abs().max().item() / \
                want.float().abs().max().item()
        numbers.update(step_ms=step_ms, encode_ms=encode_ms, step_velocity_err=errors["velocity"],
                       step_latents_err=errors["latents"], text_tokens=ctx.shape[1])
        print(f"one prompt encoding (UMT5, prompt and negative, {ctx.shape[1]} tokens): "
              f"{encode_ms:.2f} ms, launches {encode_launches}; one CFG denoise step (batch 2, "
              f"{numbers['video_tokens']} video tokens, 512 text keys): {step_ms:.1f} ms, launches "
              f"{step_launches} (the module tree: B {2 * n_blocks}); against the plain version of "
              f"B: guided velocity {errors['velocity']:.3e}, the step's latents "
              f"{errors['latents']:.3e} of their largest value (tol {WAN_STEP_TOL})")
        if encode_launches != {"layer_norm": per_encoding}:
            raise AssertionError(f"the prompt encoding launched {encode_launches}")
        if step_launches != {"flash_attention_bshd": 2 * n_blocks}:
            raise AssertionError(f"the denoise step launched {step_launches}")
        if max(errors.values()) > WAN_STEP_TOL:
            raise AssertionError("the kernel's denoise step and the plain one disagree")
        if profile:
            kinds = profile_steps(lambda: denoise_step(model, ctx), step_ms, "Wan CFG denoise step")
            print_kernel_ms(kinds, ("kernel B",), "Wan CFG denoise step")
            numbers["traced_step"] = {kind: [round(ms, 4), n] for kind, (ms, n) in kinds.items()}
            latents = torch.randn(*latent_shape, device=device, generator=g35)
            kinds = profile_steps(lambda: model.vae.decode(latents), numbers["decode_s"][-1] * 1e3,
                                  "Wan VAE decode")
            numbers["traced_decode"] = {kind: [round(ms, 4), n] for kind, (ms, n) in kinds.items()}
            del latents
        del ctx, kernel_step, plain_step, kernel_velocity, plain_velocity
        free(model)
        del model, den, t5

        # -- 36: the three files, the server and the CLI at reduced depth ---------------------
        phase(f"36 the Wan three-file checkpoint, the server (window scheduler) and the CLI (bf16 "
              f"and NF4) at full width, {WAN_REDUCED_LAYERS} blocks and {WAN_REDUCED_LAYERS} UMT5 "
              f"layers")
        reduced_den = Wan22TI2V5BDenoiserConfig(num_layers=WAN_REDUCED_LAYERS)
        reduced_t5 = TextEncoderConfig(num_layers=WAN_REDUCED_LAYERS)
        reduced = WanConfig(**paths, dtype="bfloat16", denoiser=reduced_den)
        small = Model(reduced, tokenizer=tokenizer, text_encoder_config=reduced_t5)
        small.init_params(torch.Generator(device=device).manual_seed(36))
        small.vae.init_random(torch.Generator(device=device).manual_seed(37))
        with torch.no_grad():  # the published VAE file is bf16
            for p in small.vae.parameters():
                p.copy_(p.bfloat16())
        serve = WAN_SERVE
        serve_latents = torch.randn(1, (serve["frames"] // 4 * 4 - 1) // 4 + 1, serve["size"] // 16,
                                    serve["size"] // 16, 48, device=device, generator=g35).bfloat16()
        step_before = denoise_step(small, encode(small), serve_latents)
        torch.cuda.synchronize()
        start = time.perf_counter()
        st.save_file(small.denoiser_state_dict(), paths["denoiser_path"])
        st.save_file(small.text_encoder_state_dict(), paths["text_encoder_path"])
        st.save_file({k: v.bfloat16() for k, v in small.vae.state_dict().items()}, paths["vae_path"])
        numbers["checkpoint_write_s"] = time.perf_counter() - start
        numbers["checkpoint_bytes"] = {k: Path(p).stat().st_size for k, p in paths.items()}
        start = time.perf_counter()
        loaded = Model.from_checkpoint(reduced, tokenizer=tokenizer, text_encoder_config=reduced_t5)
        torch.cuda.synchronize()
        numbers["checkpoint_load_s"] = time.perf_counter() - start
        for part in ("denoiser", "text_encoder", "vae"):
            written, read = getattr(small, part).state_dict(), getattr(loaded, part).state_dict()
            if set(read) != set(written) or not all(torch.equal(written[k], read[k]) for k in read):
                raise AssertionError(f"the {part} loaded back differs from the model")
        if loaded.vae.decoder.conv_in.weight.dtype != torch.float32:
            raise AssertionError("the VAE read from its bf16 file is not fp32")
        if not torch.equal(step_before, denoise_step(loaded, encode(loaded), serve_latents)):
            raise AssertionError("the checkpoint's denoise step differs")
        if not all(k.startswith("model.") for k in st.read_keys(paths["denoiser_path"])):
            raise AssertionError("the denoiser file's keys are not under model.")
        print(f"three-file checkpoint (full width; {WAN_REDUCED_LAYERS} blocks, "
              f"{WAN_REDUCED_LAYERS} UMT5 layers; the VAE at its default config): "
              f"{numbers['checkpoint_bytes']} bytes, written in {numbers['checkpoint_write_s']:.2f} "
              f"s, loaded by from_checkpoint in {numbers['checkpoint_load_s']:.2f} s; every tensor "
              f"of the three parts and the denoise step bit-identical, the VAE fp32 from a bf16 file")
        free(loaded)
        free(small)
        del loaded, small, step_before

        # the server's and the CLI's model at the files' depth (the YAML names the DiT's; none
        # names UMT5's, and the CLI names only the denoiser's file)
        build = Wan22.__init__

        def at_file_depth(self, config, tokenizer=None, **kwargs):
            build(self, config.model_copy(update={"denoiser": reduced_den}), tokenizer=tokenizer,
                  text_encoder_config=reduced_t5)

        Wan22.__init__ = at_file_depth
        try:
            write_yaml(work / "wan.yml", {**paths, "dtype": "bfloat16",
                                          "denoiser": reduced_den.model_dump()})
            start = time.perf_counter()
            served = srv.T2IModel(str(work / "wan.yml"), None, str(work), family="wan")
            srv.prepare_kernels("wan", device)
            numbers["serve_load_s"] = time.perf_counter() - start
            model = served.model
            kept, prompts, prepare, generate = [], [], model.prepare_latents, model.generate

            def seeded_prepare(*args, seed=None):
                return prepare(*args, seed=WAN_WINDOW_SEED if seed is None else seed)

            def keep_latents(latents):
                kept.append(latents.float().clone())
                return Wan22.decode_videos(model, latents)

            def keep_prompts(prompt, **kwargs):  # the batch's rows in the order it took them
                prompts.append(list(prompt) if isinstance(prompt, (list, tuple)) else [prompt])
                return generate(prompt, **kwargs)

            model.prepare_latents, model.decode_videos = seeded_prepare, keep_latents
            model.generate = keep_prompts
            batcher = srv.MicroBatcher(served, max_batch=4, window_ms=2000)
            server, url = serving(batcher)
            window = [dict(prompt=p, negative_prompt="", width=serve["size"], height=serve["size"],
                           frames=serve["frames"], fps=8, inference_steps=serve["steps"],
                           cfg_scale=WAN_CFG)
                      for p in ("a photo of a cat", "a red car on the road")]
            before = read_launches()
            try:
                with on_path():
                    replies, seconds = post_all(url, window)
            finally:
                server.shutdown()
                server.server_close()
            launched = launched_since(before)
            numbers["window_s"] = seconds
            want_window = {"flash_attention_bshd": serve["steps"] * 2 * WAN_REDUCED_LAYERS,
                           "layer_norm": 2 * WAN_REDUCED_LAYERS + 1}
            out_frames = 4 * ((serve["frames"] // 4 * 4 - 1) // 4) + 1
            for data, _ in replies:
                fps, frames = mp4_frames(data, work)
                if fps != 8 or len(frames) != out_frames or frames[0].shape != (
                        serve["size"], serve["size"], 3) or np.std(frames) == 0:
                    raise AssertionError(f"a window reply: {fps} fps, {len(frames)} frames")
            if len(kept) != 1 or kept[0].shape[0] != 2 or launched != want_window or sorted(
                    prompts[0]) != sorted(body["prompt"] for body in window):
                raise AssertionError(f"window scheduler: {len(kept)} generate() calls, launched "
                                     f"{launched} (expected {want_window})")
            print(f"server from the three files via a YAML (load {numbers['serve_load_s']:.2f} s): "
                  f"window scheduler, 2 concurrent compatible requests ({serve['size']} px, "
                  f"{serve['frames']} frames, {serve['steps']} steps, fps 8) in one generate() of "
                  f"batch 2 in {seconds:.3f} s; launches {launched}; each reply an mp4 of "
                  f"{out_frames} frames read back by OpenCV {cv2.__version__}")
            errs = []
            for row, row_prompt in enumerate(prompts[0]):
                with on_path():
                    model.generate(row_prompt, negative_prompt=[""], frames=serve["frames"],
                                   width=serve["size"], height=serve["size"],
                                   num_inference_steps=serve["steps"], cfg_scale=WAN_CFG,
                                   seed=WAN_WINDOW_SEED + row)
                want = kept[-1][0]
                errs.append((kept[0][row] - want).abs().max().item() / want.abs().max().item())
            numbers["window_errors"] = errs
            print(f"the window's rows against batch-1 generate() (row i from seed "
                  f"{WAN_WINDOW_SEED} + i): max abs err / max |latents| {errs} "
                  f"(tol {POOL_REQUEST_TOL})")
            if max(errs) > POOL_REQUEST_TOL:
                raise AssertionError("the window's batch and batch-1 generate() disagree")
            free(model)
            del served, model, kept

            cli = {}
            for quant in (None, "bnb_nf4"):
                gc.collect()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                out = work / f"cli_{quant or 'bf16'}.mp4"
                start = time.perf_counter()
                with on_path():
                    before = read_launches()
                    saved = inference_cli.main([
                        "--family", "wan", "--checkpoint-path", paths["denoiser_path"],
                        "--tokenizer-path", str(work), "--width", str(serve["size"]), "--height",
                        str(serve["size"]), "--num-inference-steps", str(serve["steps"]),
                        "--frames", str(serve["frames"]), "--fps", "8", "--cfg-scale",
                        str(WAN_CFG), "--save-path", str(out),
                        *(["--quant-type", quant] if quant else [])])
                    launched = launched_since(before)
                seconds = time.perf_counter() - start
                fps, frames = mp4_frames(out.read_bytes(), work)
                # kernel D a forward: the text MLP's 2 Linears, the time MLP's 2 and its
                # projection, and a block's 4 + 4 attention projections and 2 FF Linears; the
                # 192-wide head is left unquantized (D does not take it)
                want_cli = dict(want_window)
                if quant:
                    want_cli["nf4_matmul_forward"] = serve["steps"] * (5 + 10 * WAN_REDUCED_LAYERS)
                cli[quant or "bf16"] = dict(s=seconds, peak_gib=peak_gib(), launches=launched)
                print(f"CLI --family wan{' --quant-type ' + quant if quant else ''} (load"
                      f"{', quantize' if quant else ''}, {serve['size']} px, {serve['frames']} "
                      f"frames, {serve['steps']} steps, CFG {WAN_CFG}, mp4): {seconds:.2f} s, peak "
                      f"{peak_gib():.2f} GiB; {len(frames)} frames at {fps} fps; launches "
                      f"{launched} (expected {want_cli})")
                if saved != [str(out)] or len(frames) != out_frames or fps != 8:
                    raise AssertionError(f"the CLI saved {saved}: {len(frames)} frames")
                if launched != want_cli:
                    raise AssertionError(f"the CLI launched {launched}, expected {want_cli}")
            numbers["cli"] = cli
        finally:
            Wan22.__init__ = build
    finally:
        shutil.rmtree(work, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": path_launches, "records": records, "numbers": numbers}


# the SDXL adapter phases (37-42, ``--sdxl-adapters``): the RoPE student's rotated
# self-attention takes kernels E and G, unmasked at head dim 64 with H == Hkv, at
# SDXL's two attention widths at 1024 px (CFG batch 2); SigLIP-384's blocks take
# kernel B at 12 heads of 64 over 576 tokens (a reference image and CFG's negative)
ADAPTER_ATTN_SHAPES = [(2, 10, 4096, 64), (2, 20, 1024, 64)]  # (B, H, S, D)
SIGLIP_B_SHAPE = (2, 576, 768, 12)  # (B, S, H*D, H)
ADAPTER_IMAGES = 4  # seeded 1024 px images: an epoch of two steps at batch 2
REMAT_MODES = ("activations", "kernel", "none")
REMAT_TIMED = 1  # 2 before phases 43-46
# cuBLAS's (nvjet_*, *gemm*, cutlass) and cuDNN's GEMM and convolution kernels (the port's
# own kernels are named flash_*, layer_norm_*, nf4_*, gated_*, gn_*, conv3x3_* and partial_block_*)
LIBRARY_GEMM = re.compile(r"nvjet|gemm|xmma|cutlass|cudnn|conv|fprop|dgrad|wgrad", re.IGNORECASE)


def rope_attention_records(device, gen, b, h, s, d) -> tuple:
    """Kernels E and G as the RoPE student calls them: q and k (B, H, S, D)
    contiguous (the rotation's output), v and dout views of (B, S, H*D) (the
    projection's layout), no mask, H == Hkv. E's output and lse against
    the plain version, G's dq, dk and dv against the plain backward, reruns
    bit-identical, one call each beside SDPA's forward and backward, the
    bounds. Returns the (E, G dk/dv, G dq) records."""
    from vision_ft_tpu_torch.ops.flash_attention import (
        flash_attention_masked, flash_attention_masked_backward,
        flash_attention_masked_backward_reference, flash_attention_masked_delta,
        flash_attention_masked_dkv, flash_attention_masked_dq, flash_attention_reference,
    )

    q, k = (torch.randn(b, h, s, d, device=device, generator=gen).bfloat16() for _ in "qk")
    v, dout = (torch.randn(b, s, h * d, device=device, generator=gen).bfloat16()
               .unflatten(-1, (h, d)).transpose(1, 2) for _ in "vo")
    what = f"attention B={b} H={h} S={s} D={d}, unmasked (the RoPE student's)"
    before = flash_attention_masked.launches
    out, lse = flash_attention_masked(q, k, v, return_lse=True)
    if flash_attention_masked.launches != before + 1:
        raise AssertionError(f"{what}: kernel E launched {flash_attention_masked.launches - before} times")
    ref, ref_lse = flash_attention_reference(q, k, v, return_lse=True)
    abs_err, rel_err = compare(what + " out", lambda: out, lambda: ref, MASKED_ATTN_TOL)
    lse_err = compare(what + " lse", lambda: lse, lambda: ref_lse, MASKED_LSE_TOL)
    del ref, ref_lse
    assert_reruns(what, lambda: flash_attention_masked(q, k, v, return_lse=True))
    sdpa = F.scaled_dot_product_attention
    ms = cuda_ms(lambda: flash_attention_masked(q, k, v))
    back_to_back_ms = burst_ms(lambda: flash_attention_masked(q, k, v))
    plain_ms = cuda_ms(lambda: flash_attention_reference(q, k, v), warmup=1, iters=3)
    library_ms = cuda_ms(lambda: sdpa(q, k, v))
    pairs = float(b * s * s)
    flops = 4 * h * d * pairs
    bound_ms, bound_by = bound(2 * 4 * b * h * s * d, flops)
    print(f"{what}: kernel E max abs err {abs_err:.3e} rel {rel_err:.3e} (tol {MASKED_ATTN_TOL}), "
          f"lse rel {lse_err[1]:.3e} (tol {MASKED_LSE_TOL}), one launch, reruns bit-identical; "
          f"{ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s, {100 * bound_ms / ms:.1f}% of the bound; "
          f"{back_to_back_ms:.4f} ms a call over 10 back to back), plain {plain_ms:.3f} ms, SDPA "
          f"{library_ms:.4f} ms (kernel {ms / library_ms:.2f}x), bound {bound_ms:.4f} ms ({bound_by})")
    forward = dict(shape=[b, h, s, d], max_abs_err=abs_err, lse_max_abs_err=lse_err[0], ms=ms,
                   burst_ms=back_to_back_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                   bound_by=bound_by, library_ms=library_ms)

    delta = flash_attention_masked_delta(out, dout)
    dk, dv = flash_attention_masked_dkv(q, k, v, None, dout, lse, delta)
    dq = flash_attention_masked_dq(q, k, v, None, dout, lse, delta)
    rerun = flash_attention_masked_backward(q, k, v, None, out, lse, dout)
    if not all(torch.equal(x, y) for x, y in zip((dq, dk, dv), rerun)):
        raise AssertionError(f"{what}: two backward launches differ")
    refs = flash_attention_masked_backward_reference(q, k, v, None, out, lse, dout)
    err = {name: compare(f"{what} {name}", lambda: got, lambda: want, MASKED_BWD_TOL)
           for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), refs)}
    del refs, rerun, dq, dk, dv
    dkv_ms = cuda_ms(lambda: flash_attention_masked_dkv(q, k, v, None, dout, lse, delta))
    dq_ms = cuda_ms(lambda: flash_attention_masked_dq(q, k, v, None, dout, lse, delta))
    plain_bwd_ms = cuda_ms(
        lambda: flash_attention_masked_backward_reference(q, k, v, None, out, lse, dout),
        warmup=1, iters=3)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    sdpa_out = sdpa(*leaves)
    library_bwd_ms = cuda_ms(lambda: torch.autograd.grad(sdpa_out, leaves, dout, retain_graph=True))
    del sdpa_out, leaves
    side = 2 * b * h * s * d  # bytes of one bf16 (B, H, S, D) tensor
    read = 2 * side + 2 * side + 2 * 4 * b * h * s
    dkv_bound = bound(read + 2 * side, 8 * h * d * pairs)
    dq_bound = bound(read + side, 6 * h * d * pairs)
    print(f"{what} backward: " + ", ".join(f"{n} max abs err {a:.3e} rel {r:.3e}"
                                           for n, (a, r) in err.items())
          + f" (tol {MASKED_BWD_TOL}), reruns bit-identical; kernel G dk/dv {dkv_ms:.4f} ms "
          f"({100 * dkv_bound[0] / dkv_ms:.1f}% of its bound), dq {dq_ms:.4f} ms "
          f"({100 * dq_bound[0] / dq_ms:.1f}% of its bound); plain backward {plain_bwd_ms:.3f} ms, "
          f"SDPA's backward {library_bwd_ms:.4f} ms; bounds dk/dv {dkv_bound[0]:.4f} ms "
          f"({dkv_bound[1]}), dq {dq_bound[0]:.4f} ms ({dq_bound[1]})")
    dkv = dict(shape=[b, h, s, d], max_abs_err=max(err["dk"][0], err["dv"][0]), ms=dkv_ms,
               plain_ms=plain_bwd_ms, bound_ms=dkv_bound[0], bound_by=dkv_bound[1],
               library_ms=library_bwd_ms)
    dq = dict(shape=[b, h, s, d], max_abs_err=err["dq"][0], ms=dq_ms, plain_ms=plain_bwd_ms,
              bound_ms=dq_bound[0], bound_by=dq_bound[1], library_ms=library_bwd_ms)
    del q, k, v, dout, out, lse, delta
    gc.collect()
    torch.cuda.empty_cache()
    return forward, dkv, dq


def library_gemm_launches(make_loss, params) -> int:
    """cuBLAS / cuDNN GEMM and convolution launches of the backward of
    ``make_loss()`` (its forward untraced) traced by torch.profiler (device
    activity); two forwards, two traced backwards, the counts must agree.
    The trace's raw device events are counted: ``key_averages()`` would
    build an event object for each of its ~12,000 events first, seconds a
    trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    counts = []
    for _ in range(2):
        value = make_loss()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.autograd.grad(value, params)
            torch.cuda.synchronize()
        del value
        counts.append(sum(1 for e in prof.profiler.kineto_results.events()
                          if e.device_type() == DeviceType.CUDA and LIBRARY_GEMM.search(e.name())
                          and "conv3x3" not in e.name()))
    if counts[0] != counts[1] or counts[0] == 0:
        raise AssertionError(f"torch.profiler: GEMM launch counts {counts} (lost events?)")
    return counts[0]


def sdxl_remat_phase(device, model, numbers: dict) -> None:
    """The SDXL LoRA train step (rank 16 on attn1 / attn2 / ff, batch
    REMAT_BATCH... at 1024 px, cached latents and text) under each remat mode:
    the gradients bit-identical, ms/step, peak GiB; and, traced at batch 1,
    the library GEMMs of the backward less those of a step without
    checkpointing: the forward GEMMs the recomputation runs."""
    from vision_ft_tpu_torch.models.sdxl import train_text_to_image as t2i
    from vision_ft_tpu_torch.modules import peft
    from vision_ft_tpu_torch.nn import remat_saves, set_remat_saves

    gen = torch.Generator(device=device).manual_seed(38)
    peft.replace_to_peft_layer(model.denoiser, LORA_TARGETS, [],
                               peft.LoRAConfig(rank=16, alpha=8.0, dtype="bfloat16"), gen)
    trainable, _ = peft.split_peft_params(model.denoiser)
    with torch.no_grad():
        for key, p in trainable.items():
            if key.endswith("lora_up.weight"):
                p.normal_(0.0, 1e-3, generator=gen)
    params = list(trainable.values())

    def batch(b):
        g = torch.Generator(device=device).manual_seed(39)
        return {
            "cached_latents": torch.randn(b, 128, 128, 4, device=device, generator=g).bfloat16(),
            "cached_context": torch.randn(b, 77, 2048, device=device, generator=g).bfloat16(),
            "cached_pooled": torch.randn(b, 1280, device=device, generator=g).bfloat16(),
            "original_size": torch.full((b, 2), 1024.0, device=device),
            "target_size": torch.full((b, 2), 1024.0, device=device),
            "crop_coords_top_left": torch.zeros(b, 2, device=device),
            "timesteps": torch.randint(0, 1000, (b,), device=device, generator=g),
            "noise": torch.randn(b, 128, 128, 4, device=device, generator=g),
        }

    def loss(bt):
        return t2i.loss_with_draws(model, bt, bt["timesteps"], bt["noise"])

    model.denoiser.set_gradient_checkpointing(True)
    big, small = batch(TRAIN_BATCH), batch(1)
    previous = remat_saves()
    runs = {}
    try:
        for mode in REMAT_MODES:
            set_remat_saves(mode)
            torch.autograd.grad(loss(big), params)  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times = []
            for _ in range(REMAT_TIMED):
                torch.cuda.synchronize()
                start = time.perf_counter()
                grads = torch.autograd.grad(loss(big), params)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - start) * 1e3)
            peak = torch.cuda.max_memory_allocated() / 2**30
            gemms = library_gemm_launches(lambda: loss(small), params)
            runs[mode] = dict(step_ms=times, peak_gib=peak, backward_gemms=gemms, grads=grads)
        model.denoiser.set_gradient_checkpointing(False)
        plain_gemms = library_gemm_launches(lambda: loss(small), params)
    finally:
        set_remat_saves(previous)
        model.denoiser.set_gradient_checkpointing(True)
    want = runs["none"]["grads"]
    for mode in ("activations", "kernel"):
        if not all(torch.equal(g, w) for g, w in zip(runs[mode]["grads"], want)):
            raise AssertionError(f"the gradients with remat saves {mode} differ from none's")
    if not any(bool(g.abs().max() > 0) for g in want):
        raise AssertionError("every LoRA gradient is zero")
    remat = {}
    for mode, run in runs.items():
        recomputed = run["backward_gemms"] - plain_gemms
        remat[mode] = dict(step_ms=run["step_ms"], peak_gib=run["peak_gib"],
                           recomputed_gemms=recomputed)
        print(f"remat saves {mode}: {min(run['step_ms']):.1f} ms/step (batch {TRAIN_BATCH}, 1024 px, "
              f"LoRA rank 16, fwd + bwd, min of {run['step_ms']}), peak {run['peak_gib']:.2f} GiB; "
              f"backward at batch 1: {run['backward_gemms']} cuBLAS / cuDNN launches, "
              f"{recomputed} of them the recomputation's forward GEMMs and convolutions")
    print(f"a step without checkpointing: {plain_gemms} library GEMM launches in its backward; the "
          f"gradients of the three modes bit-identical")
    if not remat["activations"]["recomputed_gemms"] < remat["kernel"]["recomputed_gemms"]:
        raise AssertionError(f"remat saves activations recompute no fewer GEMMs: {remat}")
    numbers["remat"] = remat
    del runs, want, params, trainable, big, small
    gc.collect()
    torch.cuda.empty_cache()


# phases 40-42 (in the ``--sdxl-adapters`` process): prompt-free generation, the style
# tokenizer and DRaFT+, each workload group a path of its own in launches_by_path
CONTEXT_ADAPTER_PATHS = ("sdxl_prompt_free", "sdxl_style_tokenizer", "sdxl_draft_plus")
SIGLIP512_B_SHAPE = (2, 1024, 768, 12)  # (B, S, H*D, H): SigLIP at 512 px, the style tokenizer's
DRAFT_STEPS = 10  # DRaFT+'s sampling steps through the Trainer (the YAML's 25 before phases 43-46)
DRAFT_REDUCED_STEPS = 3  # sampling steps of the depth-reduced DRaFT+ comparison
# PickScore's layers a tower in that comparison (24 and 32 at full depth, where on seeded
# bf16 weights kernel A's and the plain LayerNorm's roundings move its score on one image)
PICKSCORE_REDUCED_LAYERS = 2
# that comparison's limits: its loss is -100 x the cosine of PickScore's text and image
# embeddings, nearly orthogonal on seeded weights, so the bf16 roundings of the UNet's steps,
# the decode and PickScore move it relatively more than the other workloads' losses (twice
# STEP_LOSS_TOL); the decoded image carries its CFG steps' bf16 differences as a pool's latents
# do (POOL_REQUEST_TOL), relative to its largest value
DRAFT_LOSS_TOL = 2e-2
DRAFT_IMAGE_TOL = 5e-2


class NCHWSigLIP:
    """The workloads' encoder contract (a normalized NCHW batch -> features
    on the card) on the port's SigLIP, which takes NHWC in [-1, 1]: the
    configs' 0.5 / 0.5 normalization already gives that range. Seeded
    weights, bf16, the pooled output (the mlp projectors take one vector
    a sample)."""

    def __init__(self, image_size: int, device, seed: int):
        from vision_ft_tpu_torch.models.vision_encoders.siglip import ImageEncoder, SigLIPVisionConfig

        self.encoder = ImageEncoder(SigLIPVisionConfig(image_size=image_size),
                                    feature_type="pooler_output", dtype=torch.bfloat16,
                                    device=device, seed=seed)
        self.device = device

    def __call__(self, pixels):
        pixels = torch.as_tensor(pixels).to(self.device)
        return self.encoder(pixels.permute(0, 2, 3, 1).contiguous())


@contextlib.contextmanager
def one_transformer_layer_each(unet):
    """Inside, each of the UNet's SpatialTransformers runs only its first
    transformer layer (11 of 70 at SDXL's depth): the depth-reduced step."""
    from torch import nn

    from vision_ft_tpu_torch.models.sdxl.denoiser import SpatialTransformer

    saved = [(m, m["transformer_blocks"]) for m in unet.modules() if isinstance(m, SpatialTransformer)]
    for m, full in saved:
        m["transformer_blocks"] = nn.ModuleDict({"0": full["0"]})
    try:
        yield len(saved)
    finally:
        for m, full in saved:
            m["transformer_blocks"] = full


@contextlib.contextmanager
def first_layers_each(reward, n: int):
    """Inside, PickScore's text and vision towers run their first ``n``
    encoder layers (the depth-reduced DRaFT+ step)."""
    from torch import nn

    towers = [reward.text_model["encoder"], reward.vision_model.encoder]
    saved = [tower.layers for tower in towers]
    for tower, full in zip(towers, saved):
        tower.layers = nn.ModuleDict({str(i): full[str(i)] for i in range(n)})
    try:
        yield
    finally:
        for tower, full in zip(towers, saved):
            tower.layers = full


def reduced_step_against_plain(label, unet, trainable, loss_fn, read_launches,
                               loss_tol=STEP_LOSS_TOL) -> dict:
    """One step's loss and the gradient of the trainable tensors the
    depth-reduced UNet uses, with the kernels and on their plain versions
    (swapped in by ``plain_versions``); the loss's relative error against
    ``loss_tol`` and the gradient norm's against STEP_GRAD_NORM_TOL."""
    from vision_ft_tpu_torch.training.optimizer import global_norm

    params = [p for k, p in trainable.items()
              if ".transformer_blocks." not in k or ".transformer_blocks.0." in k]

    def loss_and_grads():
        loss = loss_fn()
        return loss.item(), torch.autograd.grad(loss, params)

    with one_transformer_layer_each(unet) as layers:
        before = read_launches()
        kernel_loss, kernel_grads = loss_and_grads()
        after = read_launches()
        with plain_versions():
            plain_loss, plain_grads = loss_and_grads()
        if read_launches() != after:
            raise AssertionError(f"{label}: the plain step launched a kernel")
    used = {k: v - before[k] for k, v in after.items() if v != before[k]}
    kernel_norm, plain_norm = global_norm(kernel_grads).item(), global_norm(plain_grads).item()
    loss_rel = abs(kernel_loss - plain_loss) / abs(plain_loss)
    norm_rel = abs(kernel_norm - plain_norm) / abs(plain_norm)
    print(f"{label}, depth-reduced step ({layers} transformer layers, full width), kernels vs plain "
          f"versions: loss {kernel_loss:.6f} vs {plain_loss:.6f} (rel {loss_rel:.3e}, tol "
          f"{loss_tol}); grad_norm {kernel_norm:.6f} vs {plain_norm:.6f} (rel {norm_rel:.3e}, "
          f"tol {STEP_GRAD_NORM_TOL}); kernel launches {used}")
    if not all(used.get(k, 0) > 0 for k in ("flash_attention_bshd", "flash_attention_bshd_dkv",
                                            "flash_attention_bshd_dq", "layer_norm")):
        raise AssertionError(f"{label}: the kernel step launched {used}")
    if not (loss_rel <= loss_tol and norm_rel <= STEP_GRAD_NORM_TOL and plain_norm > 0):
        raise AssertionError(f"{label}: the kernel step and the plain step disagree")
    return dict(reduced_loss_rel=loss_rel, reduced_grad_norm_rel=norm_rel)


def check_step_launches(label, log, unet_attn, unet_ln, forwards=1):
    """Every step ran kernel B on each UNet self-attention of its
    ``forwards`` forwards, both of C's kernels on (nearly) every one in the
    backward, A, and no other kernel."""
    ours = ("flash_attention_bshd", "flash_attention_bshd_dkv", "flash_attention_bshd_dq",
            "layer_norm")
    for i, (_, _, launches) in enumerate(log["steps"]):
        c = launches["flash_attention_bshd_dkv"]
        if (launches["flash_attention_bshd"] < forwards * unet_attn
                or c != launches["flash_attention_bshd_dq"] or c < unet_attn - 1
                or launches["layer_norm"] < forwards * unet_ln
                or any(v for k, v in launches.items() if k not in ours)):
            raise AssertionError(f"{label} step {i + 1}: launches {launches}")
    return {k: v for k, v in log["steps"][-1][2].items() if v}


def free_pipeline(model) -> None:
    for part in model.as_module().values():
        part.to("meta")
    gc.collect()
    torch.cuda.empty_cache()


def sdxl_adapters_phase(device, wrappers: dict, checkout: Path) -> dict:
    """Phases 37-42, run in a process of its own (``--sdxl-adapters``)."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    import yaml

    from vision_ft_tpu_torch.config import TrainConfig
    from vision_ft_tpu_torch.models.sdxl import train_draft_plus
    from vision_ft_tpu_torch.models.sdxl.config import SDXLConfig
    from vision_ft_tpu_torch.models.sdxl.text_encoder import CHUNK_LENGTH
    from vision_ft_tpu_torch.modules.long_prompt import tokenize_long_prompt
    from vision_ft_tpu_torch.modules.reward import PickScoreRewardModel
    from vision_ft_tpu_torch.models.sdxl.pipeline import SDXLModel
    from vision_ft_tpu_torch.models.text_encoders.tokenizer import CLIPTokenizer
    from vision_ft_tpu_torch.models.vision_encoders.siglip import _Block as SigLIPBlock
    from vision_ft_tpu_torch.nn import LayerNorm
    from vision_ft_tpu_torch.ops.flash_attention import flash_attention_bshd
    from vision_ft_tpu_torch.train.sdxl import draft_plus as draft_cli
    from vision_ft_tpu_torch.train.sdxl import flow_match as fm_cli
    from vision_ft_tpu_torch.train.sdxl import ip_adapter_self, prompt_free_ref, prompt_free_self
    from vision_ft_tpu_torch.train.sdxl import rope_distill as rd_cli
    from vision_ft_tpu_torch.train.sdxl import style_tokenizer as style_cli
    from vision_ft_tpu_torch.utils import safetensors as st

    def reset_launches():
        for wrapper in wrappers.values():
            wrapper.launches = 0

    def read_launches():
        return {name: wrapper.launches for name, wrapper in wrappers.items()}

    numbers = {}
    records = {name: [] for name in ("flash_attention_masked", "flash_attention_masked_dkv",
                                     "flash_attention_masked_dq", "flash_attention_bshd")}
    run_launches = {name: 0 for name in wrappers}
    # phases 40-42: each workload group's launches, a path of its own
    groups = {path: {name: 0 for name in wrappers} for path in CONTEXT_ADAPTER_PATHS}
    gen = torch.Generator(device=device).manual_seed(37)

    phase("37 kernels E and G at the RoPE student's shapes (D 64, unmasked, H == Hkv); kernel B "
          "at SigLIP-384's (12 heads of 64 over 576 tokens)")
    for b, h, s, d in ADAPTER_ATTN_SHAPES:
        for name, record in zip(("flash_attention_masked", "flash_attention_masked_dkv",
                                 "flash_attention_masked_dq"),
                                rope_attention_records(device, gen, b, h, s, d)):
            records[name].append(record)
    b, s, inner, h = SIGLIP_B_SHAPE
    records["flash_attention_bshd"].append(bshd_forward_record(device, gen, b, s, s, inner, h))

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_adapters_"))
    try:
        write_vocab(work)
        tokenizer = CLIPTokenizer.from_pretrained_dir(str(work))
        images_dir = work / "images"
        images_dir.mkdir()
        img_rng = np.random.default_rng(3)
        for i in range(ADAPTER_IMAGES):
            smooth = img_rng.integers(0, 255, (32, 32, 3), dtype=np.uint8)
            Image.fromarray(smooth).resize((1024, 1024), Image.BILINEAR).save(images_dir / f"{i}.png")
            (images_dir / f"{i}.txt").write_text(f"a photo of the cat, {'abcd'[i] * 3}, on the sofa")

        phase("38 the SDXL LoRA train step in the three remat modes at full width and depth "
              f"(batch {TRAIN_BATCH}, 1024 px)")
        start = time.perf_counter()
        model = SDXLModel(SDXLConfig(checkpoint_path="", dtype="bfloat16"), tokenizer=tokenizer)
        model.init_params(torch.Generator(device=device).manual_seed(0))
        unet = model.denoiser
        unet_attn = sum(type(m).__name__ == "SelfAttention" for m in unet.modules())
        unet_ln = sum(isinstance(m, LayerNorm) for m in unet.modules())
        ckpt = work / "sdxl.safetensors"
        st.save_file(model.state_dict(), ckpt)
        numbers["checkpoint_write_s"] = time.perf_counter() - start
        print(f"seeded SDXL (bf16) made on the card and written to {ckpt.stat().st_size / 1e9:.3f} GB "
              f"in {numbers['checkpoint_write_s']:.1f} s; the UNet's {unet_attn} self-attentions and "
              f"{unet_ln} LayerNorms")
        # one text encoding's kernel A launches (the workloads below encode every step)
        ids, _ = tokenize_long_prompt(tokenizer, ["a photo of the cat"] * 2, max_length=75,
                                      chunk_length=CHUNK_LENGTH)
        ids = torch.from_numpy(np.asarray(ids)).to(device)
        reset_launches()
        with torch.no_grad():
            model.text_encoder.encode_tokens(ids, ids, 2)
        encode_ln = read_launches()["layer_norm"]
        print(f"one text encoding (both CLIP towers): {encode_ln} launches of kernel A")
        sdxl_remat_phase(device, model, numbers)
        for part in model._parts().values():
            part.to("meta")
        del model, unet
        gc.collect()
        torch.cuda.empty_cache()

        def run_trainer(label, trainer, into=None):
            """trainer.train() with each step's launches (and the batch
            preprocessing's, where the image encoder runs), host ms, loss,
            and its other metrics; the launches are added to ``into`` (the
            phases' own count by default); the last batch is kept."""
            into = run_launches if into is None else into
            log = dict(steps=[], preprocess=[], metrics=[])
            preprocess = trainer.model.preprocess_batch

            def counted_preprocess(batch):
                before = read_launches()
                out = preprocess(batch)
                after = read_launches()
                log["preprocess"].append({k: after[k] - before[k] for k in after})
                log["batch"] = out
                return out

            trainer.model.preprocess_batch = counted_preprocess
            prepare_optimizer = trainer.prepare_optimizer

            def prepare_and_time():
                prepare_optimizer()
                inner = trainer._step

                def timed(state, batch, generator):
                    torch.cuda.synchronize()
                    before = read_launches()
                    start = time.perf_counter()
                    state, metrics = inner(state, batch, generator)
                    loss = metrics["train/loss"].item()
                    torch.cuda.synchronize()
                    after = read_launches()
                    log["steps"].append((time.perf_counter() - start, loss,
                                         {k: after[k] - before[k] for k in after}))
                    log["metrics"].append({k: float(v) for k, v in metrics.items()
                                           if k in ("reward", "kl")})
                    return state, metrics

                trainer._step = timed

            trainer.prepare_optimizer = prepare_and_time
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            start = time.perf_counter()
            trainer.train()
            torch.cuda.synchronize()
            log["run_s"] = time.perf_counter() - start
            log["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            for k, v in read_launches().items():
                into[k] += v
            losses = [loss for _, loss, _ in log["steps"]]
            print(f"{label}: trainer.train() {log['run_s']:.1f} s (checkpoint load included); "
                  f"{len(losses)} steps, losses {[round(x, 6) for x in losses]}, "
                  f"{[round(t * 1e3, 1) for t, _, _ in log['steps']]} ms, peak {log['peak_gib']:.2f} GiB")
            if len(losses) != ADAPTER_IMAGES // 2 or not all(np.isfinite(losses)):
                raise AssertionError(f"{label}: steps {losses}")
            return log

        def want(**counts):
            out = {name: 0 for name in wrappers}
            out.update(counts)
            return out

        def check_request(label, model, expected, into=None, **kwargs):
            into = run_launches if into is None else into
            reset_launches()
            torch.cuda.synchronize()
            start = time.perf_counter()
            images = model.generate(**kwargs)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - start
            launches = read_launches()
            for k, v in launches.items():
                into[k] += v
            arrays = [np.asarray(im) for im in images]
            print(f"{label}: {len(images)} image(s) {images[0].size}, {kwargs['num_inference_steps']} "
                  f"steps, {seconds:.2f} s; launches {({k: v for k, v in launches.items() if v})}")
            if images[0].size != (kwargs["width"], kwargs["height"]) or any(a.std() == 0 for a in arrays):
                raise AssertionError(f"{label}: wrong size or a constant image")
            for name, count in expected.items():
                if launches[name] != count:
                    raise AssertionError(f"{label}: {launches[name]} launches of {name}, expected {count}")
            return seconds

        def yaml_config(name, save_dir, edit=None, folder=None, batch_size=2):
            raw = yaml.safe_load((checkout / "configs/sdxl" / name).read_text())
            raw["model"].update(checkpoint_path=str(ckpt), tokenizer_path=str(work),
                                max_token_length=75)
            if edit is not None:
                edit(raw)
            raw["dataset"].update(folder=str(folder or images_dir), num_repeats=1,
                                  batch_size=batch_size, num_workers=0)
            raw["num_train_epochs"] = 1
            raw["saving"]["callbacks"][0]["save_dir"] = str(work / save_dir)
            raw.pop("preview", None)
            raw["trainer"]["mesh"] = {"data": 1, "fsdp": 1, "tensor": 1}
            return TrainConfig.model_validate(raw, strict=True)

        request = dict(prompt="a photo of the cat on the sofa", negative_prompt="blurry",
                       width=1024, height=1024, num_inference_steps=STEPS, seed=0)

        phase("39 the adapter workloads through the Trainer from their YAMLs at full width and "
              "depth: flow match, RoPE distillation, the IP-Adapter in self-reference mode")
        trainer = fm_cli.build_trainer(yaml_config("flow_match.yml", "fm"), tokenizer=tokenizer)
        log = run_trainer("flow match (configs/sdxl/flow_match.yml)", trainer)
        step_want = want(flash_attention_bshd=unet_attn, flash_attention_bshd_dkv=unet_attn,
                         flash_attention_bshd_dq=unet_attn, layer_norm=2 * unet_ln + encode_ln)
        for i, (_, _, launches) in enumerate(log["steps"]):
            if launches != step_want:
                raise AssertionError(f"flow match step {i + 1}: launches {launches} != {step_want}")
        numbers["flow_match"] = dict(step_ms=[t * 1e3 for t, _, _ in log["steps"]],
                                     peak_gib=log["peak_gib"], run_s=log["run_s"])
        numbers["flow_match"]["generate_s"] = check_request(
            "flow-match generate() (velocity, Euler, CFG 3.5)", trainer.model.model,
            {"flash_attention_bshd": STEPS * unet_attn, "flash_attention_masked": 0}, cfg_scale=3.5,
            **request)
        print(f"flow match: launches a step {step_want} (kernel B once, C's two kernels once per "
              f"self-attention; A in the forward and the recomputation and in the text encoding)")
        for part in trainer.model.model._parts().values():
            part.to("meta")
        del trainer, log
        gc.collect()
        torch.cuda.empty_cache()

        trainer = rd_cli.build_trainer(yaml_config("rope_distill.yml", "rope"), tokenizer=tokenizer)
        log = run_trainer("RoPE distillation (configs/sdxl/rope_distill.yml)", trainer)
        # the teacher (RoPE and PEFT off, no gradient) at 1024 and 512 px: kernel B; the
        # student at both sizes: kernel E forward (4096 / 1024 and 1024 / 256 tokens, all
        # >= 256 keys) and kernel G backward; A in each forward, the students' twice
        step_want = want(flash_attention_bshd=2 * unet_attn, flash_attention_masked=2 * unet_attn,
                         flash_attention_masked_dkv=2 * unet_attn,
                         flash_attention_masked_dq=2 * unet_attn,
                         layer_norm=2 * unet_ln + 2 * 2 * unet_ln + encode_ln)
        for i, (_, _, launches) in enumerate(log["steps"]):
            if launches != step_want:
                raise AssertionError(f"RoPE distill step {i + 1}: launches {launches} != {step_want}")
        print(f"RoPE distillation: launches a step {step_want}: kernel E and G on the rotated "
              f"self-attention at head dim 64")
        numbers["rope_distill"] = dict(step_ms=[t * 1e3 for t, _, _ in log["steps"]],
                                       peak_gib=log["peak_gib"], run_s=log["run_s"],
                                       launches_per_step=step_want)
        for part in trainer.model.model._parts().values():
            part.to("meta")
        del trainer, log
        gc.collect()
        torch.cuda.empty_cache()

        # the YAML's mlp projector takes one pooled vector a sample: SigLIP's pooled
        # output (its "hidden_state" default is a token sequence, ROADMAP section 3)
        def self_mode(raw):
            raw["model"]["adapter"]["image_encoder"]["feature_type"] = "pooler_output"
            raw["dataset"].pop("metadata_parquet")

        config = yaml_config("ip_adapter.yml", "ip", self_mode)
        trainer = ip_adapter_self.build_trainer(config, tokenizer=tokenizer)
        log = run_trainer("IP-Adapter, self-reference mode (configs/sdxl/ip_adapter.yml)", trainer)
        ip_model = trainer.model.model
        siglip = ip_model.encoder.model
        siglip_attn = sum(isinstance(m, SigLIPBlock) for m in siglip.modules())
        siglip_ln = sum(isinstance(m, LayerNorm) and m.weight is not None and m.dim % 128 == 0
                        for m in siglip.modules())
        encode_want = want(flash_attention_bshd=siglip_attn, layer_norm=siglip_ln)
        for i, launches in enumerate(log["preprocess"]):
            if launches != encode_want:
                raise AssertionError(f"IP-Adapter batch {i + 1}: the image encoder's launches "
                                     f"{launches} != {encode_want}")
        print(f"SigLIP-384 (seeded, bf16, {siglip_attn} blocks over "
              f"{siglip.config.num_patches} tokens): launches a batch {encode_want}")
        for i, (_, _, launches) in enumerate(log["steps"]):
            c = launches["flash_attention_bshd_dkv"]
            if (launches["flash_attention_bshd"] < unet_attn or c != launches["flash_attention_bshd_dq"]
                    or c < unet_attn - 1 or launches["layer_norm"] < unet_ln
                    or any(launches[k] for k in launches if k not in (
                        "flash_attention_bshd", "flash_attention_bshd_dkv",
                        "flash_attention_bshd_dq", "layer_norm"))):
                raise AssertionError(f"IP-Adapter step {i + 1}: launches {launches}")
        moved = [k for k, v in trainer.trainable.items() if "_ip." in k or k.startswith("image_proj.")]
        if not moved or len(moved) != len(trainer.trainable):
            raise AssertionError(f"IP-Adapter trainable tensors: {sorted(trainer.trainable)[:4]}")
        saved = sorted((work / "ip").glob("*.safetensors"))
        adapter_keys = set(st.load_file(saved[-1])) if saved else set()
        if len(saved) != 1 or not any(k.startswith("ip_adapter.1.") for k in adapter_keys) or not any(
                k.startswith("image_proj.") for k in adapter_keys):
            raise AssertionError(f"IP-Adapter saved files {saved}: {sorted(adapter_keys)[:4]}")
        print(f"IP-Adapter: {len(trainer.trainable)} trainable tensors (the attn2 ip projections "
              f"and the projector); launches a step {[l for _, _, l in log['steps']]}; saved "
              f"{saved[-1].name} with {len(adapter_keys)} keys")
        reference = Image.fromarray(np.random.default_rng(5).integers(0, 255, (300, 420, 3), np.uint8))
        numbers["ip_adapter"] = dict(step_ms=[t * 1e3 for t, _, _ in log["steps"]],
                                     peak_gib=log["peak_gib"], run_s=log["run_s"],
                                     encoder_launches=encode_want)
        numbers["ip_adapter"]["generate_s"] = check_request(
            "IP-Adapter generate() with a reference image (CFG 5)", ip_model,
            {"flash_attention_bshd": siglip_attn + STEPS * unet_attn}, reference_image=reference,
            cfg_scale=5.0, **request)
        del trainer, log, ip_model, siglip
        gc.collect()
        torch.cuda.empty_cache()

        # reference pairs: webp images named by id and a metadata parquet
        ref_dir = work / "ref_images"
        ref_dir.mkdir()
        ids = [f"r{i}" for i in range(ADAPTER_IMAGES)]
        for id_ in ids:
            smooth = img_rng.integers(0, 255, (32, 32, 3), dtype=np.uint8)
            Image.fromarray(smooth).resize((1024, 1024), Image.BILINEAR).save(ref_dir / f"{id_}.webp")
        pq.write_table(pa.table({
            "id": ids, "another_id": [[j for j in ids if j != i] for i in ids],
            "copyright": [["sofa"]] * len(ids), "character": [["cat"]] * len(ids),
            "general": [["photo", "red"]] * len(ids), "meta": [["the"]] * len(ids),
            "people": [["girl"]] * len(ids),
        }), str(work / "pairs.parquet"))
        reference = Image.fromarray(np.random.default_rng(40).integers(0, 255, (300, 420, 3), np.uint8))

        def referenced(raw, prefix=None):
            raw["dataset"]["metadata_parquet"] = str(work / "pairs.parquet")
            if prefix is not None:
                raw["dataset"]["caption_processors"] = [{"type": "prefix", "prefix": prefix}]

        def encoder_launches(encoder):
            model = encoder.encoder.model
            n_blocks = sum(isinstance(m, SigLIPBlock) for m in model.modules())
            n_ln = sum(isinstance(m, LayerNorm) and m.weight is not None and m.dim % 128 == 0
                       for m in model.modules())
            out = {name: 0 for name in read_launches()}
            out.update(flash_attention_bshd=n_blocks, layer_norm=n_ln)
            return out

        def check_saved(label, save_dir, state_now):
            saved = sorted((work / save_dir).glob("*.safetensors"))
            if len(saved) != 1:
                raise AssertionError(f"{label}: saved files {saved}")
            state = st.load_file(saved[0])
            if set(state) != set(state_now) or not all(
                    torch.equal(state[k].to(device), v.to(device)) for k, v in state_now.items()):
                raise AssertionError(f"{label}: the saved file {sorted(state)[:4]} does not reload to "
                                     f"the trained tensors {sorted(state_now)[:4]}")
            print(f"{label}: saved {saved[0].name}, {len(state)} tensors, reloads bit-identical")
            return saved[0]

        # -- 40 ------------------------------------------------------------------------------
        phase("40 prompt-free generation (PFG) through the Trainer from configs/sdxl/prompt_free.ref.yml "
              "and prompt_free.self.yml at full width and depth (the injected SigLIP-384); generate() "
              "with a reference image")
        path = groups["sdxl_prompt_free"]
        for mode, cli, yaml_name, edit, folder in (
                ("ref", prompt_free_ref, "prompt_free.ref.yml", referenced, ref_dir),
                ("self", prompt_free_self, "prompt_free.self.yml", None, images_dir)):
            label = f"PFG, {mode} mode (configs/sdxl/{yaml_name})"
            encoder = NCHWSigLIP(384, device, seed=40)
            config = yaml_config(yaml_name, f"pfg_{mode}", edit, folder=folder)
            trainer = cli.build_trainer(config, tokenizer=tokenizer, image_encoder=encoder)
            log = run_trainer(label, trainer, into=path)
            model = trainer.model.model
            if any(launches != encoder_launches(encoder) for launches in log["preprocess"]):
                raise AssertionError(f"{label}: the encoder's launches {log['preprocess']}")
            per_step = check_step_launches(label, log, unet_attn, unet_ln)
            if not trainer.trainable or not all(k.startswith("projector.") for k in trainer.trainable):
                raise AssertionError(f"{label}: trainable {sorted(trainer.trainable)[:4]}")
            check_saved(label, f"pfg_{mode}", model.adapter_state_dict())
            result = dict(step_ms=[t * 1e3 for t, _, _ in log["steps"]], peak_gib=log["peak_gib"],
                          run_s=log["run_s"], launches_per_step=per_step,
                          encoder_launches={k: v for k, v in encoder_launches(encoder).items() if v})
            batch = log["batch"]
            result.update(reduced_step_against_plain(
                label, model.denoiser, trainer.trainable,
                lambda: trainer.model.loss_fn(batch, torch.Generator(device=device).manual_seed(9))[0],
                read_launches))
            print(f"{label}: launches a step {per_step}, the encoder's a batch {result['encoder_launches']}")
            if mode == "ref":
                tokens = model.encode_reference_image(model.preprocess_reference_image(reference))
                if tokens.shape != (1, 4, 2048) or tokens.dtype != torch.float32:
                    raise AssertionError(f"PFG image tokens {tuple(tokens.shape)} {tokens.dtype}")
                result["generate_s"] = check_request(
                    "PFG generate() with a reference image (CFG 5, max_token_length 225: 231 + 4 "
                    "context keys)", model,
                    {"flash_attention_bshd": encoder_launches(encoder)["flash_attention_bshd"]
                     + STEPS * unet_attn}, into=path, reference_image=reference, cfg_scale=5.0,
                    **{**request, "max_token_length": 225})
            numbers[f"pfg_{mode}"] = result
            free_pipeline(model)
            del trainer, log, model, batch, encoder
            gc.collect()
            torch.cuda.empty_cache()

        # -- 41 ------------------------------------------------------------------------------
        phase("41 the style tokenizer through the Trainer from configs/sdxl/style_tokenizer.yml at full "
              "width and depth (the injected SigLIP-512, a CLIP-size vocabulary); kernel B at "
              "SigLIP-512's shape; generate() with a reference image")
        b, s_len, inner, h = SIGLIP512_B_SHAPE
        records["flash_attention_bshd"].append(bshd_forward_record(device, torch.Generator(
            device=device).manual_seed(41), b, s_len, s_len, inner, h))
        # the written vocabulary filled to CLIP's 49408 entries: <|style|> takes id 49408
        style_vocab = work / "style_vocab"
        style_vocab.mkdir()
        write_vocab(style_vocab)
        vocab = json.loads((style_vocab / "vocab.json").read_text())
        used = set(vocab.values())
        vocab.update({f"<filler{i}>": i for i in range(49406) if i not in used})
        if len(vocab) != 49408:
            raise AssertionError(f"the filled vocabulary has {len(vocab)} entries")
        (style_vocab / "vocab.json").write_text(json.dumps(vocab))
        style_tokenizer = CLIPTokenizer.from_pretrained_dir(str(style_vocab))
        path = groups["sdxl_style_tokenizer"]
        label = "style tokenizer (configs/sdxl/style_tokenizer.yml)"
        encoder = NCHWSigLIP(512, device, seed=41)
        config = yaml_config("style_tokenizer.yml", "style",
                             functools.partial(referenced, prefix="<|style|>, "), folder=ref_dir)
        trainer = style_cli.build_trainer(config, tokenizer=style_tokenizer, image_encoder=encoder)
        log = run_trainer(label, trainer, into=path)
        model = trainer.model.model
        te = model.text_encoder
        rows = [t.text_model["embeddings"]["token_embedding"].weight.shape[0]
                for t in (te.text_encoder_1, te.text_encoder_2)]
        if (te.style_token_id != 49408 or rows != [49409, 49409]
                or te.text_encoder_2.config.vocab_size != 49408):
            raise AssertionError(f"{label}: style id {te.style_token_id}, embedding rows {rows}")
        if any(launches != encoder_launches(encoder) for launches in log["preprocess"]):
            raise AssertionError(f"{label}: the encoder's launches {log['preprocess']}")
        if encoder.encoder.model.pos_embed.shape[1] != s_len:
            raise AssertionError(f"{label}: SigLIP-512 has {encoder.encoder.model.pos_embed.shape[1]} tokens")
        per_step = check_step_launches(label, log, unet_attn, unet_ln)
        if not trainer.trainable or not all(k.startswith(("projector_1.", "projector_2."))
                                            for k in trainer.trainable):
            raise AssertionError(f"{label}: trainable {sorted(trainer.trainable)[:4]}")
        check_saved(label, "style", model.adapter_state_dict())
        result = dict(step_ms=[t * 1e3 for t, _, _ in log["steps"]], peak_gib=log["peak_gib"],
                      run_s=log["run_s"], launches_per_step=per_step,
                      encoder_launches={k: v for k, v in encoder_launches(encoder).items() if v})
        batch = log["batch"]
        result.update(reduced_step_against_plain(
            label, model.denoiser, trainer.trainable,
            lambda: trainer.model.loss_fn(batch, torch.Generator(device=device).manual_seed(9))[0],
            read_launches))
        print(f"{label}: <|style|> id 49408, both token embeddings grown to 49409 rows; launches a step "
              f"{per_step}, the encoder's a batch {result['encoder_launches']}")
        result["generate_s"] = check_request(
            "style generate() with a reference image (CFG 5)", model,
            {"flash_attention_bshd": encoder_launches(encoder)["flash_attention_bshd"]
             + STEPS * unet_attn}, into=path, reference_image=reference, cfg_scale=5.0,
            **{**request, "prompt": "a <|style|> photo of the cat on the sofa"})
        numbers["style_tokenizer"] = result
        free_pipeline(model)
        del trainer, log, model, batch, encoder, te
        gc.collect()
        torch.cuda.empty_cache()

        # -- 42 ------------------------------------------------------------------------------
        phase(f"42 DRaFT+ through the Trainer from configs/sdxl/draft_plus.yml at full width and "
              f"depth: LoRA rank 8 on attn1 / attn2, PickScore's CLIP-H at full width (seeded, "
              f"bf16), {DRAFT_STEPS} sampling steps with the last one's "
              f"gradient, batch 1 at 1024 px")
        path = groups["sdxl_draft_plus"]
        label = "DRaFT+ (configs/sdxl/draft_plus.yml)"
        start = time.perf_counter()
        reward = PickScoreRewardModel(tokenizer=tokenizer).init_params(
            torch.Generator(device=device).manual_seed(42), dtype=torch.bfloat16)
        reward_ln = sum(isinstance(m, LayerNorm) and m.dim % 128 == 0 for m in reward.modules())
        print(f"seeded PickScore (CLIP-H, bf16, {sum(p.numel() for p in reward.parameters()) / 1e9:.3f} "
              f"B parameters, {reward_ln} LayerNorms) in {time.perf_counter() - start:.1f} s")
        draft_dir = work / "draft_images"
        draft_dir.mkdir()
        for i in range(2):
            shutil.copy(images_dir / f"{i}.png", draft_dir / f"{i}.png")
            shutil.copy(images_dir / f"{i}.txt", draft_dir / f"{i}.txt")
        config = yaml_config("draft_plus.yml", "draft", folder=draft_dir, batch_size=1,
                             edit=lambda raw: raw["model"].update(total_steps=DRAFT_STEPS))
        trainer = draft_cli.build_trainer(config, tokenizer=tokenizer, reward_models=[reward])
        log = run_trainer(label, trainer, into=path)
        model = trainer.model.model
        total = trainer.model.model_config.total_steps
        per_step = check_step_launches(label, log, unet_attn, unet_ln, forwards=total + 1)
        if log["steps"][-1][2]["layer_norm"] < (total + 1) * unet_ln + reward_ln:
            raise AssertionError(f"{label}: PickScore's LayerNorms missing from {per_step}")
        if not trainer.trainable or not all("lora_" in k for k in trainer.trainable):
            raise AssertionError(f"{label}: trainable {sorted(trainer.trainable)[:4]}")
        saved = sorted((work / "draft").glob("*.safetensors"))
        if len(saved) != 1 or set(st.load_file(saved[0])) != set(trainer.model.get_state_dict_to_save()):
            raise AssertionError(f"{label}: saved {saved}")
        rewards = [m["reward"] for m in log["metrics"]]
        kls = [m["kl"] for m in log["metrics"]]
        if not (np.isfinite(rewards).all() and np.isfinite(kls).all() and kls[-1] > 0):
            raise AssertionError(f"{label}: reward {rewards}, KL {kls}")
        print(f"{label}: reward {rewards}, KL {kls}; launches a step {per_step} ({total} CFG steps and "
              f"the adapter-off reference through kernel B, C on the truncated step's backward, A in "
              f"the UNet, both CLIP towers and PickScore's); saved {saved[0].name}")
        result = dict(step_ms=[t * 1e3 for t, _, _ in log["steps"]], peak_gib=log["peak_gib"],
                      run_s=log["run_s"], launches_per_step=per_step, reward=rewards, kl=kls)
        batch = log["batch"]
        short = trainer.model.model_config.model_copy(update={"total_steps": DRAFT_REDUCED_STEPS})
        noises = [torch.randn(batch["initial_noise"].shape, device=device,
                              generator=torch.Generator(device=device).manual_seed(i))
                  for i in range(DRAFT_REDUCED_STEPS)]
        # each path's decoded image, kept for a comparison of the output itself
        decoded, decode = [], model.vae.decode

        def kept_decode(latents):
            image = decode(latents)
            decoded.append(image.detach().float())
            return image

        model.vae.decode = kept_decode
        try:
            with first_layers_each(reward, PICKSCORE_REDUCED_LAYERS):
                result.update(reduced_step_against_plain(
                    f"{label}, {DRAFT_REDUCED_STEPS} sampling steps, PickScore's towers at "
                    f"{PICKSCORE_REDUCED_LAYERS} layers each", model.denoiser, trainer.trainable,
                    lambda: train_draft_plus.loss_with_draws(model, short, [reward], batch, noises)[0],
                    read_launches, loss_tol=DRAFT_LOSS_TOL))
        finally:
            model.vae.decode = decode
        kernel_image, plain_image = decoded
        image_rel = ((kernel_image - plain_image).abs().max() / plain_image.abs().max()).item()
        print(f"{label}: the decoded {tuple(plain_image.shape)} image, kernels vs plain versions: "
              f"max abs err / max |image| {image_rel:.3e} (tol {DRAFT_IMAGE_TOL})")
        if not (torch.isfinite(kernel_image).all() and image_rel <= DRAFT_IMAGE_TOL):
            raise AssertionError(f"{label}: the kernel step's image and the plain step's disagree")
        result["reduced_image_rel"] = image_rel
        result["generate_s"] = check_request(
            "DRaFT+ generate() with the trained LoRA (CFG 5)", model,
            {"flash_attention_bshd": STEPS * unet_attn}, into=path, cfg_scale=5.0, **request)
        numbers["draft_plus"] = result
        free_pipeline(model)
        reward.to("meta")
        del trainer, log, model, batch, reward
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return dict(launches=run_launches, records=records, numbers=numbers, groups=groups)


# -- the single-device remainder: the rest of the Trainer, the checkpoint tools, offloading
# and FractalGen (phases 43-46)

REST_OPTIMIZERS = ("bitsandbytes.optim.AdamW8bit", "optax.adamw", "torch.optim.Adafactor",
                   "schedulefree.SGDScheduleFree")
REST_IMAGES = 4  # seeded 1024 px images: an epoch of two steps at batch 2
REST_PREVIEW = dict(width=512, height=512, steps=4)  # the Discord preview's request
NF4_TOOL_PROBES = ("input_blocks.4.1.transformer_blocks.0.attn1.to_q.weight",
                   "middle_block.1.transformer_blocks.5.attn2.to_k.weight",
                   "output_blocks.2.1.transformer_blocks.9.ff.net.2.weight")
OFFLOAD_PARTS = ("text_encoder", "denoiser", "vae")
# phases 43, 44 and 45's paths in launches_by_path
REMAINDER_PATHS = ("trainer_optimizers", "nf4_tool", "sdxl_offload")
# FractalGen's first level at full width (FractalMAR, Li et al. 2025, arXiv 2502.17437): a 64 px
# image in 4 px patches (256), hidden 1024, 16 heads of 64, 32 blocks, mlp_ratio 4, one class
# token as the condition: 257 tokens, a ragged last 64-key tile. The guiding pixel is off: the
# JAX forward runs that branch only at hidden width = channels (ROADMAP §3)
FRACTAL = dict(patch_size=4, condition_embedding_dim=1024, hidden_dim=1024, num_blocks=32,
               num_heads=16, in_channels=3, out_channels=3, attention_backend="flash",
               mlp_ratio=4.0)
FRACTAL_BATCH = 16
FRACTAL_IMAGE = 64
FRACTAL_TOL = 3e-2  # the forward's outputs vs the plain versions, of their largest value
FRACTAL_REDUCED = 4  # blocks of the generator in that comparison


class Webhook:
    """A local HTTP server (127.0.0.1) that records each POST's content
    type and body and replies 204."""

    def __init__(self):
        import http.server
        import threading

        posts = self.posts = []

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                body = self.rfile.read(int(self.headers["Content-Length"]))
                posts.append((self.headers["Content-Type"], body))
                self.send_response(204)
                self.end_headers()

            def log_message(self, *args):
                pass

        self.server = http.server.HTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.server.server_port}/webhook"
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join()


def parse_multipart(content_type: str, body: bytes) -> dict:
    """{field: value} of a multipart/form-data body; a file's value is
    (file name, content type, bytes)."""
    import email.parser

    message = email.parser.BytesParser().parsebytes(
        f"Content-Type: {content_type}\r\n\r\n".encode() + body)
    out = {}
    for part in message.get_payload():
        name = part.get_param("name", header="content-disposition")
        data = part.get_payload(decode=True)
        out[name] = ((part.get_filename(), part.get_content_type(), data) if part.get_filename()
                     else data.decode())
    return out


class Recorder:
    """Records its method calls: the Hub's ``api``."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return lambda *args, **kwargs: self.calls.append((name, args, kwargs))


def state_bytes(opt_state) -> int:
    return sum(v.numel() * v.element_size() for s in opt_state.state.values()
               for v in s.values() if isinstance(v, torch.Tensor))


def trainer_remainder_phase(device, wrappers: dict, ckpt: Path, vocab_dir: Path,
                            checkout: Path) -> tuple[dict, dict]:
    """Phase 43: the SDXL Trainer on configs/sdxl/text_to_image_lora.yml from
    the seeded file under each of ``REST_OPTIMIZERS`` at full width and
    depth, with a Discord preview posted to a local server, the Hub saving
    callback with a recording ``api`` and the tensorboard tracker; the
    8-bit run's state checkpoint resumed against the unbroken run. Returns
    the runs' launches and the numbers."""
    import os

    import yaml

    from vision_ft_tpu_torch.config import TrainConfig
    from vision_ft_tpu_torch.saving import HFHubSavingCallbackConfig, get_saving_callback
    from vision_ft_tpu_torch.train.sdxl.text_to_image import build_trainer
    from vision_ft_tpu_torch.utils.logging import Trackers

    def read_launches():
        return {name: wrapper.launches for name, wrapper in wrappers.items()}

    launches_total = {name: 0 for name in wrappers}
    numbers = {}
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_optimizers_"))
    hook = Webhook()
    here = os.getcwd()
    try:
        images = work / "images"
        images.mkdir()
        rng = np.random.default_rng(43)
        for i in range(REST_IMAGES):
            smooth = rng.integers(0, 255, (32, 32, 3), dtype=np.uint8)
            Image.fromarray(smooth).resize((1024, 1024), Image.BILINEAR).save(images / f"{i}.png")
            (images / f"{i}.txt").write_text(f"a photo of the cat, {'abcd'[i] * 3}, on the sofa")
        (work / "preview.yml").write_text(yaml.safe_dump([dict(
            prompt="a photo of the cat on the sofa", negative_prompt="blurry",
            height=REST_PREVIEW["height"], width=REST_PREVIEW["width"], cfg_scale=5.0,
            num_steps=REST_PREVIEW["steps"], seed=0)]))
        base = yaml.safe_load((checkout / "configs/sdxl/text_to_image_lora.yml").read_text())
        unet_attn = unet_ln = None
        for name in REST_OPTIMIZERS:
            tag = name.rsplit(".", 1)[-1].lower()
            raw = json.loads(json.dumps(base))
            raw["model"].update(checkpoint_path=str(ckpt), max_token_length=75,
                                tokenizer_path=str(vocab_dir))
            raw["dataset"].update(folder=str(images), num_repeats=1, batch_size=2)
            raw["num_train_epochs"] = 1
            raw["optimizer"] = {"name": name, "args": {"lr": 1e-3}}
            raw["saving"]["callbacks"] = [
                {"type": "safetensors", "name": tag, "save_dir": str(work / tag / "lora")},
                {"type": "hf_hub", "name": tag, "save_dir": str(work / tag / "hub"),
                 "hub_id": "local/sdxl-lora", "dir_in_repo": tag}]
            raw["preview"]["callbacks"] = [{"type": "discord", "url": hook.url,
                                            "username": "chip_smoke"}]
            raw["preview"]["data"]["path"] = str(work / "preview.yml")
            raw["tracker"] = {"project_name": tag, "loggers": ["tensorboard"]}
            raw["trainer"]["mesh"] = {"data": 1, "fsdp": 1, "tensor": 1}
            if tag == "adamw8bit":
                raw["trainer"].update(state_checkpoint_dir=str(work / "state"),
                                      state_checkpoint_every_steps=1)
            config = TrainConfig.model_validate(raw, strict=True)
            # the tensorboard writer's runs/<project> is relative: the run's directory
            # is this phase's (every other path in the config is absolute)
            os.chdir(work)
            trainer = build_trainer(config)
            (kind, writer), = trainer.trackers._backends
            if kind != "tensorboard":
                raise AssertionError(f"tracker {kind}")
            scalars = []
            add_scalar = writer.add_scalar
            writer.add_scalar = lambda key, value, **kw: (scalars.append((key, value)),
                                                          add_scalar(key, value, **kw))[1]
            api = Recorder()
            trainer.get_saving_callbacks = lambda: [
                get_saving_callback(cb, api=api) if isinstance(cb, HFHubSavingCallbackConfig)
                else get_saving_callback(cb) for cb in trainer.config.saving.callbacks]
            steps = []
            prepare_optimizer = trainer.prepare_optimizer

            def prepare_and_time():
                prepare_optimizer()
                inner = trainer._step

                def timed(state, batch, generator):
                    torch.cuda.synchronize()
                    before = read_launches()
                    start = time.perf_counter()
                    state, metrics = inner(state, batch, generator)
                    loss = metrics["train/loss"].item()
                    torch.cuda.synchronize()
                    after = read_launches()
                    steps.append((time.perf_counter() - start, loss,
                                  {k: after[k] - before[k] for k in after}, batch))
                    return state, metrics

                trainer._step = timed

            trainer.prepare_optimizer = prepare_and_time
            posts_before = len(hook.posts)
            torch.cuda.reset_peak_memory_stats()
            before = read_launches()
            start = time.perf_counter()
            trainer.train()
            torch.cuda.synchronize()
            run_s = time.perf_counter() - start
            after = read_launches()
            for k in after:
                launches_total[k] += after[k] - before[k]
            peak = torch.cuda.max_memory_allocated() / 2**30
            losses = [loss for _, loss, _, _ in steps]
            if len(steps) != REST_IMAGES // 2 or not all(np.isfinite(losses)):
                raise AssertionError(f"{name}: steps {losses}")
            unet = trainer.model.model.denoiser
            unet_attn = sum(type(m).__name__ == "SelfAttention" for m in unet.modules())
            unet_ln = sum(type(m).__name__ == "LayerNorm" for m in unet.modules())
            want_step = {k: 0 for k in wrappers}
            want_step.update({"flash_attention_bshd": unet_attn, "flash_attention_bshd_dkv": unet_attn,
                              "flash_attention_bshd_dq": unet_attn, "layer_norm": 2 * unet_ln})
            for i, (_, _, got, _) in enumerate(steps):
                if got != want_step:
                    raise AssertionError(f"{name} step {i + 1}: launches {got} != {want_step}")
            opt_state = trainer.state.opt_state
            record = dict(step_ms=[round(t * 1e3, 1) for t, *_ in steps], losses=losses,
                          peak_gib=peak, state_bytes=state_bytes(opt_state), run_s=run_s,
                          optimizer=type(opt_state).__name__)
            # the Hub: the saved file, then one upload_file of it
            (call, _, kwargs), = api.calls
            hub_files = sorted((work / tag / "hub").glob("*.safetensors"))
            if (call != "upload_file" or len(hub_files) != 1
                    or kwargs != {"path_or_fileobj": hub_files[0],
                                  "path_in_repo": f"{tag}/{hub_files[0].name}",
                                  "repo_id": "local/sdxl-lora", "repo_type": "model"}):
                raise AssertionError(f"{name}: Hub calls {api.calls}, files {hub_files}")
            # Discord: one multipart POST, its webp read back
            posts = hook.posts[posts_before:]
            if len(posts) != 1:
                raise AssertionError(f"{name}: {len(posts)} webhook posts")
            form = parse_multipart(*posts[0])
            file_name, content_type, data = form["file0"]
            preview = Image.open(io.BytesIO(data))
            if (file_name != "preview_0.webp" or content_type != "image/webp"
                    or preview.format != "WEBP"
                    or preview.size != (REST_PREVIEW["width"], REST_PREVIEW["height"])
                    or "- Epoch: `" not in form["content"] or form["username"] != "chip_smoke"
                    or np.asarray(preview).std() == 0):
                raise AssertionError(f"{name}: the webhook's form {sorted(form)} / {preview.size}")
            # tensorboard: the losses logged, the event file on disk
            logged = [v for k, v in scalars if k == "train/loss"]
            events = list((work / "runs" / tag).glob("events.out.tfevents.*"))
            if len(logged) != len(steps) or not events or events[0].stat().st_size == 0:
                raise AssertionError(f"{name}: tensorboard scalars {scalars}, files {events}")
            print(f"{name} ({record['optimizer']}): steps {record['step_ms']} ms (host clock, "
                  f"synchronized; the first cold), losses {[round(x, 6) for x in losses]}, peak "
                  f"{peak:.2f} GiB, optimizer state {record['state_bytes']} bytes; launches a step "
                  f"as expected; the Hub: {hub_files[0].name} uploaded to {kwargs['path_in_repo']}; "
                  f"Discord: one POST, {file_name} {preview.size} webp and the message; tensorboard: "
                  f"{len(logged)} train/loss scalars in {events[0].name}")
            if tag == "adamw8bit":
                taken = len(steps)
                state = opt_state.state[next(iter(trainer.trainable.values()))]
                if state["mu_q"].dtype != torch.int8 or state["mu_scale"].dtype != torch.float32:
                    raise AssertionError(f"8-bit state dtypes {state['mu_q'].dtype}")
                # the state checkpoint of the last step, resumed: the next step's loss and
                # parameters against the unbroken run, bit for bit
                *_, batch = steps[-1]
                trainer.state, metrics = trainer._step(
                    trainer.state, batch, torch.Generator(device=device).manual_seed(7))
                unbroken_loss = metrics["train/loss"].item()
                unbroken = {k: v.detach().clone() for k, v in trainer.trainable.items()}
                resumed_step = trainer.restore_state_checkpoint()
                trainer.state, metrics = trainer._step(
                    trainer.state, batch, torch.Generator(device=device).manual_seed(7))
                resumed_loss = metrics["train/loss"].item()
                same = all(torch.equal(unbroken[k], v) for k, v in trainer.trainable.items())
                print(f"{name}: state checkpoint of step {resumed_step} resumed; the next step's "
                      f"loss {resumed_loss:.6f} vs {unbroken_loss:.6f} unbroken, parameters after "
                      f"it bit-identical: {same}")
                if resumed_step != taken or resumed_loss != unbroken_loss or not same:
                    raise AssertionError("the resumed 8-bit run differs from the unbroken one")
                record.update(resumed_step=resumed_step, resumed_loss=resumed_loss)
            numbers[tag] = record
            os.chdir(here)
            # every reference to this run's model, so that the next run's peak is its own
            del trainer, unet, opt_state, prepare_optimizer, prepare_and_time, writer, add_scalar
            del steps, api
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        os.chdir(here)
        hook.close()
        shutil.rmtree(work, ignore_errors=True)
    return launches_total, numbers


def tools_phase(device, wrappers: dict, ckpt: Path, vocab_dir: Path) -> tuple[dict, dict]:
    """Phase 44: ``tools.quantize_model`` on the seeded SDXL file on the card
    (its NF4 tensors of ``NF4_TOOL_PROBES`` against a CPU run, byte for
    byte), the written file loaded into the NF4 QLoRA path for one train
    step (kernel D), and round trips through ``tools.checkpoint.convert_dtype``
    and ``to_safetensors``. Returns the step's launches and the numbers."""
    from safetensors import safe_open

    from vision_ft_tpu_torch.models.sdxl import train_text_to_image
    from vision_ft_tpu_torch.models.sdxl.config import SDXLConfig
    from vision_ft_tpu_torch.models.sdxl.pipeline import SDXLModel
    from vision_ft_tpu_torch.models.text_encoders import CLIPTokenizer
    from vision_ft_tpu_torch.modules import peft
    from vision_ft_tpu_torch.modules.quant import quantize_state_dict
    from vision_ft_tpu_torch.nn import Linear, set_remat_saves
    from vision_ft_tpu_torch.tools import quantize_model
    from vision_ft_tpu_torch.tools.checkpoint import convert_dtype, to_safetensors
    from vision_ft_tpu_torch.training import (
        get_optimizer, get_schedule, init_train_state, make_train_step,
    )
    from vision_ft_tpu_torch.utils import safetensors as st

    def read_launches():
        return {name: wrapper.launches for name, wrapper in wrappers.items()}

    numbers = {}
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_tools_"))
    try:
        nf4_path = work / "sdxl.nf4.safetensors"
        torch.cuda.synchronize()
        start = time.perf_counter()
        quantized = quantize_model.main([
            "--model-path", str(ckpt), "--save-path", str(nf4_path), "--quant-type", "bnb_nf4",
            *(a for t in LORA_TARGETS for a in ("--include-keys", t))])
        torch.cuda.synchronize()
        numbers.update(quantize_s=time.perf_counter() - start, nf4_bytes=nf4_path.stat().st_size,
                       source_bytes=ckpt.stat().st_size)
        packed = [k for k, v in quantized.items() if v.dtype == torch.uint8 and k.endswith("weight")]
        on_card = all(v.is_cuda for v in quantized.values())
        print(f"quantize_model on the card: {len(packed)} weights to NF4 in "
              f"{numbers['quantize_s']:.2f} s with the load and the write; "
              f"{numbers['source_bytes']} -> {numbers['nf4_bytes']} bytes; every tensor on the "
              f"card: {on_card}")
        if not on_card or not packed:
            raise AssertionError("the tool's output is not on the card, or quantized nothing")
        with safe_open(str(ckpt), framework="pt") as f:
            for probe in NF4_TOOL_PROBES:
                key = "model.diffusion_model." + probe
                cpu = quantize_state_dict({key: f.get_tensor(key)}, "bnb_nf4", [key])
                leaves = sorted(k for k in quantized if k == key or k.startswith(key + "."))
                if sorted(cpu) != leaves or not all(
                        torch.equal(cpu[k], quantized[k].cpu()) for k in leaves):
                    raise AssertionError(f"{key}: the card's NF4 tensors differ from the CPU's")
                print(f"  {key}: {len(leaves)} tensors ({', '.join(k[len(key):] or 'codes' for k in leaves)}) "
                      f"equal to a CPU run's, byte for byte")
        del quantized
        gc.collect()
        torch.cuda.empty_cache()

        start = time.perf_counter()
        model = SDXLModel.from_checkpoint(
            SDXLConfig(checkpoint_path=str(nf4_path), dtype="bfloat16"),
            tokenizer=CLIPTokenizer.from_pretrained_dir(str(vocab_dir)))
        torch.cuda.synchronize()
        numbers["nf4_load_s"] = time.perf_counter() - start
        layers = dict(model.denoiser.named_modules())
        nf4 = [n for n, m in layers.items() if isinstance(m, Linear) and m.is_quantized]
        first_block = nf4[0].rsplit(".attn1.", 1)[0]
        no_dx = [n for n in nf4 if n.endswith(("attn2.to_k", "attn2.to_v"))
                 or (n.startswith(first_block + ".attn1.") and n.endswith(("to_q", "to_k", "to_v")))]
        model.denoiser.set_gradient_checkpointing(True)
        peft.replace_to_peft_layer(model.denoiser, LORA_TARGETS, [],
                                   peft.LoRAConfig(rank=16, alpha=8.0, dtype="bfloat16"),
                                   torch.Generator(device=device).manual_seed(1))
        trainable, _ = peft.split_peft_params(model.denoiser)
        optimizer = get_optimizer("torch.optim.AdamW", get_schedule("constant", 1e-4, 1000),
                                  max_grad_norm=1.0)
        step = make_train_step(functools.partial(train_text_to_image.loss_fn, model), optimizer)
        g = torch.Generator(device=device).manual_seed(44)
        side = TRAIN_RES // 8
        batch = {
            "cached_latents": torch.randn(1, side, side, 4, device=device, generator=g).bfloat16(),
            "cached_context": torch.randn(1, 227, 2048, device=device, generator=g).bfloat16(),
            "cached_pooled": torch.randn(1, 1280, device=device, generator=g).bfloat16(),
            "original_size": torch.full((1, 2), float(TRAIN_RES), device=device),
            "target_size": torch.full((1, 2), float(TRAIN_RES), device=device),
            "crop_coords_top_left": torch.zeros(1, 2, device=device),
        }
        set_remat_saves("kernel")
        try:
            before = read_launches()
            torch.cuda.synchronize()
            start = time.perf_counter()
            _, metrics = step(init_train_state(optimizer, trainable), batch, g)
            loss = metrics["train/loss"].item()
            torch.cuda.synchronize()
            step_s = time.perf_counter() - start
        finally:
            set_remat_saves("activations")
        step_launches = {k: v - before[k] for k, v in read_launches().items()}
        want = {"fwd": 2 * len(nf4), "dx": len(nf4) - len(no_dx)}
        got = {"fwd": step_launches["nf4_matmul_forward"], "dx": step_launches["nf4_matmul_dx"]}
        print(f"the tool's file through SDXLModel.from_checkpoint ({numbers['nf4_load_s']:.1f} s): "
              f"{len(nf4)} NF4 Linears; one QLoRA step at batch 1, {TRAIN_RES} px: loss {loss:.6f}, "
              f"{step_s * 1e3:.1f} ms (cold); kernel D launches {got}, expected {want}")
        if not np.isfinite(loss) or got != want:
            raise AssertionError("the QLoRA step on the tool's file: loss or kernel D launches off")
        numbers.update(nf4_layers=len(nf4), qlora_loss=loss, qlora_step_ms=step_s * 1e3)
        for part in model._parts().values():
            part.to("meta")
        del model, trainable, step, optimizer
        gc.collect()
        torch.cuda.empty_cache()

        # round trips on the VAE's tensors (a few hundred MB)
        with safe_open(str(ckpt), framework="pt") as f:
            vae = {k: f.get_tensor(k) for k in f.keys() if k.startswith("first_stage_model.")}
        st.save_file(vae, work / "vae.safetensors")
        start = time.perf_counter()
        convert_dtype.main(["--input-path", str(work / "vae.safetensors"), "--output-path",
                            str(work / "vae.fp32.safetensors"), "--dtype", "float32"])
        convert_dtype.main(["--input-path", str(work / "vae.fp32.safetensors"), "--output-path",
                            str(work / "vae.bf16.safetensors"), "--dtype", "bf16"])
        wide, back = (st.load_file(work / n) for n in ("vae.fp32.safetensors", "vae.bf16.safetensors"))
        if not (all(v.dtype == torch.float32 for v in wide.values())
                and sorted(back) == sorted(vae) and all(torch.equal(back[k], vae[k]) for k in vae)):
            raise AssertionError("convert_dtype: bf16 -> fp32 -> bf16 is not the file it started from")
        torch.save({"state_dict": vae, "epoch": 1}, work / "vae.ckpt")
        to_safetensors.main([str(work / "vae.ckpt"), str(work / "vae.from_ckpt.safetensors")])
        again = st.load_file(work / "vae.from_ckpt.safetensors")
        if sorted(again) != sorted(vae) or not all(
                again[k].dtype == vae[k].dtype and torch.equal(again[k], vae[k]) for k in vae):
            raise AssertionError("to_safetensors: the pickle's tensors did not come back")
        numbers["round_trip_s"] = time.perf_counter() - start
        print(f"convert_dtype bf16 -> fp32 -> bf16 and to_safetensors of a pickled state_dict on "
              f"the VAE's {len(vae)} tensors: the same tensors back ({numbers['round_trip_s']:.1f} s)")
        return step_launches, numbers
    finally:
        shutil.rmtree(work, ignore_errors=True)


def offloaded_requests(label, model, request, kwargs, plain) -> dict:
    """Two warm requests without offloading, then the first offloaded one
    (every part on the card: it parks them) and two warm ones from the
    host, each through ``request(name, **kwargs) -> (seconds, latents,
    peak GiB)`` with the peak reset before it; each request's latents equal
    ``plain``'s bit for bit. Puts the parts back on the card after."""
    from vision_ft_tpu_torch.modules.offload import move_params

    runs = {}
    for name, offload in (("plain 1", False), ("plain 2", False), ("offloaded, first", True),
                          ("offloaded 1", True), ("offloaded 2", True)):
        seconds, latents, peak = request(f"{label} {name}", **dict(kwargs, do_offloading=offload))
        if not torch.equal(latents, plain):
            raise AssertionError(f"{label} {name}: the latents differ from the plain request's")
        runs[name] = (seconds, peak)
        if offload:
            where = {part: next(getattr(model, part).parameters()).device.type
                     for part in OFFLOAD_PARTS if hasattr(model, part)}
            if set(where.values()) != {"cpu"}:
                raise AssertionError(f"{label} {name}: parts left on {where}")
    for part in OFFLOAD_PARTS:
        move_params(getattr(model, part), "cuda")
    out = {"plain_s": [runs[n][0] for n in ("plain 1", "plain 2")],
           "offloaded_s": [runs[n][0] for n in ("offloaded 1", "offloaded 2")],
           "first_offloaded_s": runs["offloaded, first"][0],
           "plain_peak_gib": max(runs[n][1] for n in ("plain 1", "plain 2")),
           "offloaded_peak_gib": max(runs[n][1] for n in ("offloaded 1", "offloaded 2")),
           "first_offloaded_peak_gib": runs["offloaded, first"][1]}
    print(f"{label} offloading: s/request plain {out['plain_s']}, offloaded from the host "
          f"{out['offloaded_s']} (the first offloaded, from the card, {out['first_offloaded_s']:.3f}); "
          f"peak GiB plain {out['plain_peak_gib']:.2f}, offloaded {out['offloaded_peak_gib']:.2f} "
          f"(first {out['first_offloaded_peak_gib']:.2f}); latents bit-identical to the plain "
          f"request's in all five")
    if not out["offloaded_peak_gib"] < out["plain_peak_gib"]:
        raise AssertionError(f"{label}: offloading did not lower the peak")
    return out


def sdxl_offload_phase(device, wrappers: dict, ckpt: Path, vocab_dir: Path) -> tuple[dict, dict]:
    """Phase 45: SDXL from the seeded file, 1024 px requests with and without
    ``do_offloading`` (``offloaded_requests``). Returns their launches and
    the numbers."""
    from vision_ft_tpu_torch.models.sdxl.config import SDXLConfig
    from vision_ft_tpu_torch.models.sdxl.pipeline import SDXLModel
    from vision_ft_tpu_torch.models.text_encoders import CLIPTokenizer

    class Model(SDXLModel):
        def decode_image(self, latents, use_tiling=False):
            self.last_latents = latents.clone()
            return super().decode_image(latents, use_tiling)

    def read_launches():
        return {name: wrapper.launches for name, wrapper in wrappers.items()}

    model = Model.from_checkpoint(SDXLConfig(checkpoint_path=str(ckpt), dtype="bfloat16"),
                                  tokenizer=CLIPTokenizer.from_pretrained_dir(str(vocab_dir)))
    before = read_launches()

    def request(name, **kwargs):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = time.perf_counter()
        images = model.generate(**kwargs)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        if np.asarray(images[0]).std() == 0 or not torch.isfinite(model.last_latents).all():
            raise AssertionError(f"request {name}: a constant image or latents not finite")
        return seconds, model.last_latents, torch.cuda.max_memory_allocated() / 2**30

    kwargs = dict(prompt="a photo of the cat", negative_prompt="blurry", width=1024, height=1024,
                  num_inference_steps=STEPS, cfg_scale=5.0, seed=45)
    _, plain, _ = request("warm-up", **kwargs)
    numbers = offloaded_requests("SDXL", model, request, kwargs, plain)
    launches = {k: v - before[k] for k, v in read_launches().items()}
    for part in model._parts().values():
        part.to("meta")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return launches, numbers


def fractal_phase(device, wrappers: dict) -> dict:
    """Phase 46, in a process of its own (``--fractal``): FractalGen's masked
    transformer at full width (``FRACTAL``), seeded bf16 weights, a forward
    on kernels A and E against the plain versions,
    E alone at its ragged shape, ms per forward. Returns the launches, E's
    record at this shape and the numbers."""
    from vision_ft_tpu_torch.models import fractal
    from vision_ft_tpu_torch.nn import init_parameters_
    from vision_ft_tpu_torch.ops.flash_attention import flash_attention_masked, flash_attention_reference

    phase("46 FractalGen's masked transformer at full width (64 px, patch 4, hidden 1024, 16 heads "
          "of 64, 32 blocks), bf16, seeded random weights: kernels A and E")
    gen = torch.Generator(device=device).manual_seed(46)
    with torch.device("meta"):
        model = fractal.FractalMaskedTransformer(**FRACTAL)
    model.to(dtype=torch.bfloat16).to_empty(device=device)
    init_parameters_(model, gen)
    model.eval()
    params = sum(p.numel() for p in model.parameters())
    b, side = FRACTAL_BATCH, FRACTAL_IMAGE
    image = torch.rand(b, side, side, 3, device=device, generator=gen).bfloat16()
    condition = torch.randn(b, 1, FRACTAL["hidden_dim"], device=device, generator=gen).bfloat16()
    seq = (side // FRACTAL["patch_size"]) ** 2
    orders = fractal.sample_order(gen, b, seq)
    mask = fractal.TruncatedNormalMaskGenerator(0.25)(gen, None, orders)
    tokens = seq + 1  # patches, the class token

    def forward():
        with torch.no_grad():
            return model(image, condition, mask)

    for wrapper in wrappers.values():
        wrapper.launches = 0
    out = forward()
    launches = {name: wrapper.launches for name, wrapper in wrappers.items()}
    lns = sum(type(m).__name__ == "LayerNorm" for m in model.modules())
    want = {name: 0 for name in wrappers}
    want.update(layer_norm=lns, flash_attention_masked=FRACTAL["num_blocks"])
    if not all(torch.isfinite(t).all() for t in out):
        raise AssertionError("FractalGen's forward is not finite")
    # against the plain versions at reduced depth (the first FRACTAL_REDUCED blocks, full
    # width), as the other families' steps are: 32 random bf16 blocks amplify a rounding
    # difference past any fixed limit
    blocks = model.blocks
    model.blocks = torch.nn.ModuleList(list(blocks)[:FRACTAL_REDUCED])
    try:
        kernel_out = forward()
        with plain_versions():
            ref = forward()
    finally:
        model.blocks = blocks
    errors = {}
    for name in ("mask_prediction", "surrounding_patches"):
        got, plain = getattr(kernel_out, name), getattr(ref, name)
        errors[name] = compare(f"FractalGen {name} ({FRACTAL_REDUCED} blocks)", lambda: got,
                               lambda: plain, FRACTAL_TOL)
    ms = cuda_ms(forward, warmup=2, iters=10)
    plain_ms = None
    with plain_versions():
        plain_ms = cuda_ms(forward, warmup=1, iters=3)
    print(f"FractalGen level 0: {params / 1e6:.1f} M parameters, batch {b}, {tokens} tokens "
          f"({seq} patches + the class token); a forward {ms:.3f} ms (plain "
          f"versions {plain_ms:.3f} ms); launches {launches}, expected {want}; at "
          f"{FRACTAL_REDUCED} blocks vs the plain versions: " + ", ".join(f"{k} max abs err {a:.3e} rel {r:.3e}"
                                     for k, (a, r) in errors.items())
          + f" (tol {FRACTAL_TOL})")
    if launches != want or out.mask_prediction.shape != (b, seq, FRACTAL["hidden_dim"]):
        raise AssertionError(f"FractalGen launches {launches} != {want}, or a wrong shape")

    # kernel E alone at the blocks' shape: 257 rows and keys, a ragged last 64-row tile
    h, d = FRACTAL["num_heads"], FRACTAL["hidden_dim"] // FRACTAL["num_heads"]
    q, k, v = (torch.randn(b, tokens, h * d, device=device, generator=gen).bfloat16()
               .unflatten(-1, (h, d)).transpose(1, 2) for _ in "qkv")
    before = flash_attention_masked.launches
    got = flash_attention_masked(q, k, v)
    if flash_attention_masked.launches != before + 1:
        raise AssertionError("kernel E did not launch once at FractalGen's shape")
    want_e = flash_attention_reference(q, k, v)
    what = f"attention B={b} H={h} S={tokens} D={d}, unmasked (FractalGen's)"
    abs_err, rel_err = compare(what, lambda: got, lambda: want_e, MASKED_ATTN_TOL)
    tail = tokens - tokens // 64 * 64
    tail_err = compare(what + f", the last {tail} rows (the ragged tile)",
                       lambda: got[:, :, -tail:], lambda: want_e[:, :, -tail:], MASKED_ATTN_TOL)
    assert_reruns(what, lambda: flash_attention_masked(q, k, v))
    e_ms = cuda_ms(lambda: flash_attention_masked(q, k, v))
    e_plain = cuda_ms(lambda: flash_attention_reference(q, k, v), warmup=1, iters=5)
    e_library = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v))
    e_bound = bound(2 * 4 * b * h * tokens * d, 4 * h * d * float(b * tokens * tokens))
    print(f"{what}: kernel E max abs err {abs_err:.3e} rel {rel_err:.3e}, the ragged tile's rows "
          f"{tail_err[0]:.3e} rel {tail_err[1]:.3e} (tol {MASKED_ATTN_TOL}), reruns bit-identical; "
          f"{e_ms:.4f} ms, plain {e_plain:.4f}, SDPA {e_library:.4f}, bound {e_bound[0]:.5f} ms "
          f"({e_bound[1]})")
    record = dict(shape=[b, h, tokens, d], max_abs_err=abs_err, ragged_tile_max_abs_err=tail_err[0],
                  ms=e_ms, plain_ms=e_plain, bound_ms=e_bound[0], bound_by=e_bound[1],
                  library_ms=e_library)
    numbers = dict(params=params, batch=b, tokens=tokens, forward_ms=ms, plain_forward_ms=plain_ms,
                   errors={k: a for k, (a, _) in errors.items()})
    return {"launches": launches, "records": {"flash_attention_masked": [record]},
            "numbers": numbers}


def remainder_phases(device, wrappers: dict, checkout: Path) -> dict:
    """Phases 43-45, in a process of their own (``--remainder``), on a
    seeded 6.9 GB SDXL file they write: the launches of each of
    ``REMAINDER_PATHS`` and the numbers."""
    from vision_ft_tpu_torch.models.sdxl.config import SDXLConfig
    from vision_ft_tpu_torch.models.sdxl.pipeline import SDXLModel
    from vision_ft_tpu_torch.models.text_encoders import CLIPTokenizer
    from vision_ft_tpu_torch.utils import safetensors as st

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_remainder_"))
    try:
        write_vocab(work)
        seeded = SDXLModel(SDXLConfig(checkpoint_path="", dtype="bfloat16"),
                           tokenizer=CLIPTokenizer.from_pretrained_dir(str(work)))
        seeded.init_params(torch.Generator(device=device).manual_seed(17))
        ckpt = work / "sdxl.safetensors"
        start = time.perf_counter()
        st.save_file(seeded.state_dict(), ckpt)
        print(f"seeded SDXL (bf16) made on the card and written to "
              f"{ckpt.stat().st_size / 1e9:.3f} GB in {time.perf_counter() - start:.1f} s")
        for part in seeded._parts().values():
            part.to("meta")
        del seeded
        gc.collect()
        torch.cuda.empty_cache()
        launches, numbers = {}, {}
        phase("43 the rest of the Trainer at full SDXL width: the 8-bit AdamW (with a resumed "
              "state checkpoint), optax.adamw, Adafactor and the schedule-free SGD, with the "
              "Discord, Hub and tensorboard callbacks")
        launches["trainer_optimizers"], numbers["optimizers"] = trainer_remainder_phase(
            device, wrappers, ckpt, work, checkout)
        phase("44 the checkpoint tools: quantize_model on the card, its file through the NF4 "
              "QLoRA step (kernel D), convert_dtype and to_safetensors round trips")
        launches["nf4_tool"], numbers["tools"] = tools_phase(device, wrappers, ckpt, work)
        phase("45 SDXL requests with and without do_offloading, 1024 px")
        launches["sdxl_offload"], numbers["sdxl_offloading"] = sdxl_offload_phase(
            device, wrappers, ckpt, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {"launches": launches, "numbers": numbers}


def main() -> None:
    global _START
    args = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    args.add_argument("--profile", action="store_true",
                      help="also trace two train steps and print device time by kind of kernel")
    args.add_argument("--kernel-d", action="store_true",
                      help="run phase 7 alone (kernel D vs plain, timed) after building its "
                           "library; prints its records, not the ok line")
    args.add_argument("--kernel-i", action="store_true",
                      help="run phase 15 alone (kernels H and I vs plain, timed, with the "
                           "--trace-kernels process) after building their library; prints their "
                           "records, not the ok line")
    args.add_argument("--trace-kernels", action="store_true",
                      help="trace 10 calls each of kernels H, I, J, K, A and L and of their "
                           "library calls in this process alone; prints one JSON line, not the "
                           "ok line")
    args.add_argument("--lumina-trainer", action="store_true",
                      help="run phase 19 alone (the Lumina2 Trainer path) after building its "
                           "libraries; prints its launch counts and numbers as one JSON line, not "
                           "the ok line")
    args.add_argument("--auraflow", action="store_true",
                      help="run phases 20 and 21 alone (kernels B at D 256 and F at AuraFlow's "
                           "widths, then AuraFlow generate()) after building their libraries; "
                           "prints their launch counts, records and numbers as one JSON line, not "
                           "the ok line")
    args.add_argument("--auraflow-trainer", action="store_true",
                      help="run phases 22-24 alone (kernel C at D 256, then the AuraFlow Trainer "
                           "on config #3 and the shortcut and RoPE migration workloads) after "
                           "building their libraries; prints their launch counts, records and "
                           "numbers as one JSON line, not the ok line")
    args.add_argument("--serve", action="store_true",
                      help="run phases 25-27 alone (the port's server, schedulers and CLI on "
                           "SDXL, Lumina2 and AuraFlow) after building their libraries; prints "
                           "their launch counts, records and numbers as one JSON line, not the ok "
                           "line")
    args.add_argument("--flux", action="store_true",
                      help="run phases 28-30 alone (kernel B at D 128, Flux generate() at full "
                           "width, the Flux checkpoint, server and CLI, the AuraFlow VAE-encode "
                           "migration) after building their libraries; prints their launch "
                           "counts, records and numbers as one JSON line, not the ok line")
    args.add_argument("--cogview4", action="store_true",
                      help="run phases 31-33 alone (kernels B and C at D 128 at CogView4's shapes, "
                           "CogView4 generate() at full width, its checkpoint, server, CLI, "
                           "quant-compare tool and Trainer) after building their libraries; "
                           "prints their launch counts, records and numbers as one JSON line, not "
                           "the ok line")
    args.add_argument("--wan", action="store_true",
                      help="run phases 34-36 alone (kernels B, A and D at Wan's shapes, Wan 2.2 "
                           "generate() at full width and depth, its three-file checkpoint, server "
                           "and CLI) after building their libraries; prints their launch counts, "
                           "records and numbers as one JSON line, not the ok line")
    args.add_argument("--sdxl-adapters", action="store_true",
                      help="run phases 37-42 alone (kernels E and G at the RoPE student's shapes, "
                           "B at SigLIP-384's and SigLIP-512's, the SDXL train step in the three "
                           "remat modes, the flow-match, RoPE-distillation, IP-Adapter, "
                           "prompt-free, style-tokenizer and DRaFT+ workloads through the Trainer "
                           "with generate()) after building their libraries; prints their launch "
                           "counts, records and numbers as one JSON line, not the ok line")
    args.add_argument("--remainder", action="store_true",
                      help="run phases 43-45 alone (the rest of the Trainer, the checkpoint tools, "
                           "SDXL offloading) on a seeded SDXL file it writes, after building their "
                           "libraries; prints their launch counts and numbers as one JSON line, not "
                           "the ok line")
    args.add_argument("--fractal", action="store_true",
                      help="run phase 46 alone (FractalGen's masked transformer at full width on "
                           "kernels A and E) after building their libraries; prints its launch "
                           "counts, records and numbers as one JSON line, not the ok line")
    args.add_argument("--ln-probe-costs", action="store_true",
                      help="time kernels A and L and their library calls (one call, back to "
                           "back, host us, traced) in this process alone; prints one JSON line, "
                           "not the ok line")
    args.add_argument("--wait-for-go", action="store_true",
                      help="after the imports, wait for a line on stdin before touching the card "
                           "(the main run starts each child so, ahead of its turn)")
    options = args.parse_args()
    if options.wait_for_go:
        if sys.stdin.readline().strip() != "go":
            raise SystemExit("chip_smoke: the parent process ended before this child's turn")
        _START = time.perf_counter()

    phase("0 device")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda is not available; this script needs a GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    device = torch.device("cuda")

    # the port, and so the kernel sources, must be this checkout's
    import vision_ft_tpu_torch
    checkout = Path(__file__).resolve().parent
    if Path(vision_ft_tpu_torch.__file__).resolve().parent.parent != checkout:
        raise SystemExit(f"chip_smoke: vision_ft_tpu_torch comes from "
                         f"{vision_ft_tpu_torch.__file__}, not from {checkout}")
    if options.ln_probe_costs:  # wrappers only: an older checkout's take the same calls
        costs = ln_probe_costs(device, torch.Generator(device=device).manual_seed(0))
        print(json.dumps({"card": card, "ln_probe_costs": costs}))
        return
    from vision_ft_tpu_torch.ops import _build
    from vision_ft_tpu_torch.ops.flash_attention import (
        flash_attention_bshd, flash_attention_bshd_backward,
        flash_attention_bshd_backward_reference, flash_attention_bshd_delta,
        flash_attention_bshd_dkv, flash_attention_bshd_dq, flash_attention_bshd_reference,
        flash_attention_masked, flash_attention_masked_backward,
        flash_attention_masked_backward_reference, flash_attention_masked_delta,
        flash_attention_masked_dkv, flash_attention_masked_dq, flash_attention_reference,
        flash_attention_shortk, flash_attention_shortk_bwd, set_flash_shortk,
    )
    from vision_ft_tpu_torch.ops.fused_mlp import (
        gated_down, gated_down_reference, gated_mlp, gated_mlp_reference, gated_up,
        gated_up_reference, geglu_mlp, set_fused_ff,
    )
    from vision_ft_tpu_torch.ops.conv3x3 import (
        conv3x3, conv3x3_forward, conv3x3_reference, conv_plan, repack_weight,
    )
    from vision_ft_tpu_torch.ops.group_norm import gn_plan, group_norm, group_norm_reference
    from vision_ft_tpu_torch.ops.layer_norm import layer_norm, layer_norm_reference
    from vision_ft_tpu_torch.ops.nf4_matmul import nf4_matmul_dx, nf4_matmul_forward
    from vision_ft_tpu_torch.tools import partial_block_probe as probe

    wrappers = {
        "nf4_matmul_forward": nf4_matmul_forward,
        "nf4_matmul_dx": nf4_matmul_dx,
        "flash_attention_bshd": flash_attention_bshd,
        "flash_attention_bshd_dkv": flash_attention_bshd_dkv,
        "flash_attention_bshd_dq": flash_attention_bshd_dq,
        "layer_norm": layer_norm,
        "flash_attention_masked": flash_attention_masked,
        "gated_mlp": gated_mlp,
        "flash_attention_masked_dkv": flash_attention_masked_dkv,
        "flash_attention_masked_dq": flash_attention_masked_dq,
        "flash_attention_shortk": flash_attention_shortk,
        "flash_attention_shortk_bwd": flash_attention_shortk_bwd,
        "group_norm": group_norm,
        "conv3x3": conv3x3,
        "partial_block_copy": probe.partial_block_copy,
        "partial_block_lastaxis": probe.partial_block_lastaxis,
        "partial_block_tma": probe.partial_block_tma,
    }
    # the SDXL paths of phases 4-9 launch none of them (the short-K kernels
    # are off there, as by default; kernels J, K and L have no model caller)
    no_lumina = {name: 0 for name in (*LUMINA_KERNELS, *SHORTK_KERNELS, *OPS_KERNELS)}

    def reset_launches():
        for wrapper in wrappers.values():
            wrapper.launches = 0

    def read_launches():
        return {name: wrapper.launches for name, wrapper in wrappers.items()}

    if options.trace_kernels:
        _build.build_cuda_libraries(["flash_attention_shortk", "group_norm", "conv3x3",
                                     "layer_norm", "partial_block_probe"])
        print(json.dumps({"traces": trace_kernels(device, torch.Generator(device=device).manual_seed(0))}))
        return

    if options.lumina_trainer:
        phase("1 build (kernels E's, F's and G's libraries only)")
        _build.build_cuda_libraries(["flash_attention_masked", "fused_mlp",
                                     "flash_attention_masked_bwd"])
        phase("19 the Lumina2 Trainer at full width, 8 of the NextDiT's 26 layers: checkpoint, "
              "EMA, state checkpoints, profiler window, preview")
        result = lumina_trainer_phase(device, wrappers, checkout)
        print(json.dumps({"lumina_trainer": result}))
        return

    if options.auraflow:
        phase("1 build (kernels B's and F's libraries only)")
        _build.build_cuda_libraries(["flash_attention_bshd", "fused_mlp"])
        result = auraflow_phase(device, wrappers, options.profile)
        print(json.dumps({"auraflow": result}))
        return

    if options.auraflow_trainer:
        phase("1 build (kernels B's, C's and F's libraries only)")
        _build.build_cuda_libraries(["flash_attention_bshd", "flash_attention_bshd_bwd", "fused_mlp"])
        result = auraflow_trainer_phase(device, wrappers, checkout)
        print(json.dumps({"auraflow_trainer": result}))
        return

    if options.serve:
        phase("1 build (kernels A's, B's, D's, E's and F's libraries only)")
        _build.build_cuda_libraries(["flash_attention_bshd", "layer_norm", "nf4_matmul",
                                     "flash_attention_masked", "fused_mlp"])
        result = serve_phase(device, wrappers)
        print(json.dumps({"serve": result}))
        return

    if options.flux:
        phase("1 build (kernels A's and B's libraries only)")
        _build.build_cuda_libraries(["flash_attention_bshd", "layer_norm"])
        result = flux_phase(device, wrappers, options.profile)
        print(json.dumps({"flux": result}))
        return

    if options.cogview4:
        phase("1 build (kernels B's, C's and D's libraries only)")
        _build.build_cuda_libraries(["flash_attention_bshd", "flash_attention_bshd_bwd",
                                     "nf4_matmul"])
        result = cogview4_phase(device, wrappers, options.profile, checkout)
        print(json.dumps({"cogview4": result}))
        return

    if options.sdxl_adapters:
        phase("1 build (kernels A's, B's, C's, E's and G's libraries only)")
        _build.build_cuda_libraries(["flash_attention_bshd", "flash_attention_bshd_bwd", "layer_norm",
                                     "flash_attention_masked", "flash_attention_masked_bwd"])
        result = sdxl_adapters_phase(device, wrappers, checkout)
        print(json.dumps({"sdxl_adapters": result}))
        return

    if options.remainder:
        phase("1 build (kernels A's, B's, C's and D's libraries only)")
        _build.build_cuda_libraries(["flash_attention_bshd", "flash_attention_bshd_bwd",
                                     "layer_norm", "nf4_matmul"])
        result = remainder_phases(device, wrappers, checkout)
        print(json.dumps({"remainder": result}))
        return

    if options.fractal:
        phase("1 build (kernels A's and E's libraries only)")
        _build.build_cuda_libraries(["layer_norm", "flash_attention_masked"])
        result = fractal_phase(device, wrappers)
        print(json.dumps({"fractal": result}))
        return

    if options.wan:
        phase("1 build (kernels A's, B's and D's libraries only)")
        _build.build_cuda_libraries(["flash_attention_bshd", "layer_norm", "nf4_matmul"])
        result = wan_phase(device, wrappers, options.profile)
        print(json.dumps({"wan": result}))
        return

    if options.kernel_d:
        phase("1 build (kernel D's library only)")
        _build.build_cuda_libraries(["nf4_matmul"])
        phase("7 kernel D: packed 4-bit matmul, forward and dx kernels vs plain (bf16)")
        records = kernel_d_phase(device, torch.Generator(device=device).manual_seed(0))
        print(json.dumps({"kernel_d": records}))
        return

    if options.kernel_i:
        phase("1 build (kernels H's and I's library only)")
        _build.build_cuda_libraries(["flash_attention_shortk"])
        phase("15 kernels H and I: short-K attention forward and backward vs plain (bf16)")
        records = kernels_h_i_phase(device, torch.Generator(device=device).manual_seed(0),
                                    run_trace_kernels(Child(checkout, "--trace-kernels",
                                                            timeout=600)))
        print(json.dumps({"kernels_h_i": records}))
        return

    # phase 3's tracing process imports while this one builds
    trace_child = Child(checkout, "--trace-kernels", timeout=600)
    phase("1 build")
    start = time.perf_counter()
    cuda_sources = ["flash_attention_bshd", "flash_attention_bshd_bwd", "nf4_matmul",
                    "flash_attention_masked", "fused_mlp", "flash_attention_masked_bwd",
                    "flash_attention_shortk", "group_norm", "conv3x3", "partial_block_probe",
                    "layer_norm"]
    _build.build_cuda_libraries(cuda_sources)
    nvcc_s = time.perf_counter() - start
    print(f"nvcc {', '.join(n + '.cu' for n in cuda_sources)} (in parallel): {nvcc_s:.2f} s")

    records = {}
    gen = torch.Generator(device=device).manual_seed(0)

    phase("2 kernel B: BSHD flash attention forward vs plain (bf16)")
    errs, rows = [], []
    for b, s, inner, h in ATTN_SHAPES:
        q, k, v = (torch.randn(b, s, inner, device=device, generator=gen).bfloat16() for _ in "qkv")
        abs_err, rel_err = compare(
            f"attention {(b, s, inner, h)}",
            lambda: flash_attention_bshd(q, k, v, h),
            lambda: flash_attention_bshd_reference(q, k, v, h), ATTN_TOL,
        )
        ms = cuda_ms(lambda: flash_attention_bshd(q, k, v, h))
        back_to_back_ms = burst_ms(lambda: flash_attention_bshd(q, k, v, h))
        plain_ms = cuda_ms(lambda: flash_attention_bshd_reference(q, k, v, h), iters=5)
        heads = [sdpa_heads(t, h) for t in (q, k, v)]
        library_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(*heads))
        library_burst_ms = burst_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(*heads))
        flops = 4 * b * s * s * inner
        bound_ms, bound_by = bound(4 * b * s * inner * 2, flops)
        assert_reruns(f"attention {(b, s, inner, h)}",
                      lambda: flash_attention_bshd(q, k, v, h, return_lse=True))
        print(f"B={b} S={s} H={h} D={inner // h}: max abs err {abs_err:.3e} rel {rel_err:.3e} "
              f"(tol {ATTN_TOL}), reruns bit-identical; kernel {ms:.4f} ms "
              f"({flops / ms / 1e9:.1f} TFLOP/s, {100 * bound_ms / ms:.1f}% of the bound; "
              f"{back_to_back_ms:.4f} ms a call over 10 back to back), "
              f"plain {plain_ms:.3f} ms, SDPA {library_ms:.4f} ms (kernel {ms / library_ms:.2f}x; "
              f"{library_burst_ms:.4f} ms back to back), "
              f"bound {bound_ms:.4f} ms ({bound_by})")
        errs.append(abs_err)
        rows.append(dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                         library_ms=library_ms))
    records["flash_attention_bshd"] = dict(
        route="cuda", source="vision_ft_tpu_torch/csrc/flash_attention_bshd.cu",
        replaces="vision_ft_tpu/ops/pallas/flash_attention.py:663",
        max_abs_err=max(errs), **rows[0],
    )
    del q, k, v, heads

    phase("3 kernel A: fused LayerNorm vs plain (bf16)")
    # the card's time a call of A, L, H, J, K and their library calls, traced over 10
    # calls in a process of its own; printed here for A and in phase 18 for the others
    traces = run_trace_kernels(trace_child)
    errs, rows = [], []
    for shape in LN_SHAPES + LN_EDGE_SHAPES:
        n_rows, c, beta = shape
        x, w, bias = ln_inputs(n_rows, c, beta, device, gen)
        abs_err, rel_err = compare(
            f"layer_norm {shape}",
            lambda: layer_norm(x, w, bias), lambda: layer_norm_reference(x, w, bias), LN_TOL,
        )
        assert_reruns(f"layer_norm {shape}", lambda: layer_norm(x, w, bias))
        kernel = call_costs(lambda: layer_norm(x, w, bias))
        library = call_costs(lambda: torch.nn.functional.layer_norm(x, (c,), w, bias))
        plain_ms = cuda_ms(lambda: layer_norm_reference(x, w, bias), iters=50)
        nbytes = 2 * x.numel() * 2 + (2 if beta else 1) * c * 2
        # mean, variance, normalize, affine: about 8 fp32 operations an element
        bound_ms, bound_by = bound(nbytes, 8 * x.numel(), PEAK_FP32_FLOPS)
        traced = ((traced_ms(traces, f"kernel A {shape}"), traced_ms(traces, f"F.layer_norm {shape}"))
                  if shape in LN_SHAPES else (None, None))
        print(f"rows={n_rows} C={c} beta={beta}: max abs err {abs_err:.3e} rel {rel_err:.3e} "
              f"(tol {LN_TOL}), reruns bit-identical; kernel {kernel['ms']:.4f} ms one call "
              f"({nbytes / kernel['ms'] / 1e6:.0f} GB/s, {100 * bound_ms / kernel['ms']:.1f}% of the "
              f"bound), {kernel['burst_ms']:.4f} a call over 10 back to back "
              f"({100 * bound_ms / kernel['burst_ms']:.1f}%)"
              + (f", {traced[0]:.5f} traced on the card ({100 * bound_ms / traced[0]:.1f}%)"
                 if traced[0] else "")
              + f", host {kernel['host_us']:.1f} us a call; plain {plain_ms:.4f} ms; F.layer_norm "
              f"{library['ms']:.4f} ms one call (kernel {kernel['ms'] / library['ms']:.2f}x), "
              f"{library['burst_ms']:.4f} back to back"
              + (f", {traced[1]:.5f} traced" if traced[1] else "")
              + f", host {library['host_us']:.1f} us; bound {bound_ms:.5f} ms ({bound_by})")
        errs.append(abs_err)
        rows.append(dict(ms=kernel["ms"], plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                         library_ms=library["ms"], burst_ms=kernel["burst_ms"],
                         host_us=kernel["host_us"], traced_ms=traced[0],
                         library_burst_ms=library["burst_ms"], library_host_us=library["host_us"],
                         library_traced_ms=traced[1]))
    records["layer_norm"] = dict(
        route="cuda", source="vision_ft_tpu_torch/csrc/layer_norm.cu",
        replaces="vision_ft_tpu/ops/pallas/layer_norm.py:22",
        max_abs_err=max(errs), **rows[0],
    )
    del x, w, bias

    phase("4 SDXL generate() at full width, bf16, seeded random weights")
    from vision_ft_tpu_torch.models.sdxl.config import SDXLConfig
    from vision_ft_tpu_torch.models.sdxl.denoiser import SelfAttention
    from vision_ft_tpu_torch.models.sdxl.pipeline import SDXLModel
    from vision_ft_tpu_torch.models.text_encoders import CLIPTokenizer
    from vision_ft_tpu_torch.nn import LayerNorm

    class Model(SDXLModel):
        """Keeps the last latents generate() decoded, for the checks."""

        def decode_image(self, latents, use_tiling=False):
            self.last_latents = latents.clone()
            return super().decode_image(latents, use_tiling)

    with tempfile.TemporaryDirectory() as vocab_dir:
        write_vocab(Path(vocab_dir))
        tokenizer = CLIPTokenizer.from_pretrained_dir(vocab_dir)
    model = Model(SDXLConfig(checkpoint_path="", dtype="bfloat16"), tokenizer=tokenizer)
    start = time.perf_counter()
    model.init_params(torch.Generator(device=device).manual_seed(0))
    torch.cuda.synchronize()
    n_unet = sum(p.numel() for p in model.denoiser.parameters())
    n_te = sum(p.numel() for p in model.text_encoder.parameters())
    print(f"init on the card: {time.perf_counter() - start:.1f} s; UNet {n_unet / 1e9:.3f} B, "
          f"text encoders {n_te / 1e9:.3f} B, VAE "
          f"{sum(p.numel() for p in model.vae.parameters()) / 1e6:.1f} M parameters")

    unet_ln = sum(isinstance(m, LayerNorm) for m in model.denoiser.modules())
    clip_ln = sum(isinstance(m, LayerNorm) for m in model.text_encoder.modules())
    unet_attn = sum(isinstance(m, SelfAttention) for m in model.denoiser.modules())
    requests = [
        ("a", dict(prompt="a photo of a cat sitting on the sofa", negative_prompt="blurry",
                   width=1024, height=1024, cfg_scale=5.0, seed=1234)),
        ("b", dict(prompt=["a red car on the road", "a house in the mountains"],
                   width=832, height=1216, cfg_scale=5.0, seed=99)),
    ]
    requests.append(("c", requests[0][1]))  # (a) again, same seed

    reset_launches()
    results = {}
    unet_forwards = 0
    for name, kwargs in requests:
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        start = time.perf_counter()
        images = model.generate(num_inference_steps=STEPS, **kwargs)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        steps = len(model.scheduler.get_timesteps(STEPS))
        unet_forwards += steps
        latents = model.last_latents
        arrays = [np.asarray(im) for im in images]
        print(f"request {name}: {len(images)} image(s) {images[0].size}, {steps} steps, "
              f"{seconds:.3f} s, {seconds / steps:.3f} s per step (whole request), "
              f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if not torch.isfinite(latents).all():
            raise AssertionError(f"request {name}: latents not finite")
        if any(a.std() == 0 for a in arrays):
            raise AssertionError(f"request {name}: constant image")
        results[name] = (latents, arrays)
    bf16_request = (seconds, torch.cuda.max_memory_allocated() / 2**30)  # (c): (a), warm
    generate_launches = read_launches()

    same = torch.equal(results["a"][0], results["c"][0]) and all(
        np.array_equal(x, y) for x, y in zip(results["a"][1], results["c"][1]))
    if not same:
        raise AssertionError("request c (a repeated, same seed) differs from a")
    print("request c == request a, bit for bit")
    want = {"flash_attention_bshd": unet_attn * unet_forwards,
            "flash_attention_bshd_dkv": 0, "flash_attention_bshd_dq": 0,
            "layer_norm": unet_ln * unet_forwards + clip_ln * len(requests),
            "nf4_matmul_forward": 0, "nf4_matmul_dx": 0, **no_lumina}
    print(f"module tree: {unet_attn} UNet self-attentions, {unet_ln} UNet LayerNorms, "
          f"{clip_ln} CLIP LayerNorms; {unet_forwards} UNet forwards; "
          f"launches {generate_launches}, expected {want}")
    if generate_launches != want:
        raise AssertionError(f"launch counts {generate_launches} != {want}")
    del results

    # the UNet step alone: one CFG forward (batch 2) at 1024x1024
    b = 2
    args = (
        torch.randn(b, 128, 128, 4, device=device, generator=gen).bfloat16(),
        torch.full((b,), 500.0, device=device),
        torch.randn(b, 77, 2048, device=device, generator=gen).bfloat16(),
        torch.randn(b, 1280, device=device, generator=gen).bfloat16(),
        *(torch.full((b, 2), v, device=device) for v in (1024.0, 1024.0, 0.0)),
    )
    with torch.inference_mode():
        unet_ms = cuda_ms(lambda: model.denoiser(*args), warmup=2, iters=5)
    print(f"UNet CFG forward at 1024x1024 (batch {b}): {unet_ms:.1f} ms")
    if options.profile:
        kinds = profile_steps(lambda: model.generate(num_inference_steps=STEPS, **requests[0][1]),
                              bf16_request[0] * 1e3, "SDXL request (c)")
        print_kernel_ms(kinds, ["kernel B"], "SDXL request (c)")

    phase("5 kernel C: BSHD flash attention backward (dk/dv kernel, dq kernel) vs plain (bf16)")
    errs, rows = {"dkv": [], "dq": []}, {"dkv": [], "dq": []}
    for b, s, inner, h in ATTN_BWD_SHAPES:
        q, k, v, dout = (
            torch.randn(b, s, inner, device=device, generator=gen).bfloat16() for _ in range(4)
        )
        out, lse = flash_attention_bshd(q, k, v, h, return_lse=True)
        ref_out, ref_lse = flash_attention_bshd_reference(q, k, v, h, return_lse=True)
        compare(f"attention forward {(b, s, inner, h)} out", lambda: out, lambda: ref_out, ATTN_TOL)
        lse_err = compare(f"attention forward {(b, s, inner, h)} lse",
                          lambda: lse, lambda: ref_lse, ATTN_TOL)
        del ref_out, ref_lse
        delta = flash_attention_bshd_delta(out, dout, h)
        ref_dq, ref_dk, ref_dv = flash_attention_bshd_backward_reference(q, k, v, out, lse, dout, h)
        dk, dv = flash_attention_bshd_dkv(q, k, v, dout, lse, delta, h)
        dq = flash_attention_bshd_dq(q, k, v, dout, lse, delta, h)
        err = {}
        for name, got, ref in (("dq", dq, ref_dq), ("dk", dk, ref_dk), ("dv", dv, ref_dv)):
            err[name] = compare(f"attention backward {(b, s, inner, h)} {name}",
                                lambda: got, lambda: ref, ATTN_BWD_TOL)
        del ref_dq, ref_dk, ref_dv, dq, dk, dv
        assert_reruns(f"dk/dv kernel {(b, s, inner, h)}",
                      lambda: flash_attention_bshd_dkv(q, k, v, dout, lse, delta, h))
        assert_reruns(f"dq kernel {(b, s, inner, h)}",
                      lambda: flash_attention_bshd_dq(q, k, v, dout, lse, delta, h))
        dkv_ms = cuda_ms(lambda: flash_attention_bshd_dkv(q, k, v, dout, lse, delta, h))
        dq_ms = cuda_ms(lambda: flash_attention_bshd_dq(q, k, v, dout, lse, delta, h))
        whole_ms = cuda_ms(lambda: flash_attention_bshd_backward(q, k, v, out, lse, dout, h))
        plain_ms = cuda_ms(
            lambda: flash_attention_bshd_backward_reference(q, k, v, out, lse, dout, h),
            warmup=1, iters=3,
        )
        # yardstick only: PyTorch's own attention, forward, backward alone
        # (the one PyTorch call that computes dq, dk and dv) and both
        leaves = [sdpa_heads(t, h).detach().requires_grad_() for t in (q, k, v)]
        dout_heads = sdpa_heads(dout, h)

        def sdpa_both():
            o = torch.nn.functional.scaled_dot_product_attention(*leaves)
            return torch.autograd.grad(o, leaves, dout_heads)

        sdpa_fwd_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(*leaves))
        sdpa_both_ms = cuda_ms(sdpa_both)
        sdpa_out = torch.nn.functional.scaled_dot_product_attention(*leaves)
        sdpa_bwd_ms = cuda_ms(
            lambda: torch.autograd.grad(sdpa_out, leaves, dout_heads, retain_graph=True)
        )
        tensor_bytes, stat_bytes = b * s * inner * 2, b * h * s * 4
        # dk/dv need S^T, dP^T, dV, dK: 4 products; dq needs S, dP, dQ: 3
        dkv_bound = bound(6 * tensor_bytes + 2 * stat_bytes, 8 * b * s * s * inner)
        dq_bound = bound(5 * tensor_bytes + 2 * stat_bytes, 6 * b * s * s * inner)
        print(f"B={b} S={s} H={h} D={inner // h}: "
              + ", ".join(f"{n} max abs err {a:.3e} rel {r:.3e}" for n, (a, r) in err.items())
              + f" (tol {ATTN_BWD_TOL}), forward lse max abs err {lse_err[0]:.3e}"
              f", reruns bit-identical; dk/dv kernel {dkv_ms:.4f} ms "
              f"({8 * b * s * s * inner / dkv_ms / 1e9:.1f} TFLOP/s of 8*B*S^2*H*D), dq kernel "
              f"{dq_ms:.4f} ms ({6 * b * s * s * inner / dq_ms / 1e9:.1f} TFLOP/s of 6*B*S^2*H*D), "
              f"whole backward {whole_ms:.4f} ms "
              f"({14 * b * s * s * inner / whole_ms / 1e9:.1f} TFLOP/s of 14*B*S^2*H*D, "
              f"{whole_ms / sdpa_bwd_ms:.2f}x SDPA's backward), "
              f"plain {plain_ms:.3f} ms; SDPA forward {sdpa_fwd_ms:.4f} ms, "
              f"backward {sdpa_bwd_ms:.4f} ms, forward + backward {sdpa_both_ms:.4f} ms; bounds dk/dv "
              f"{dkv_bound[0]:.4f} ms ({dkv_bound[1]}), dq {dq_bound[0]:.4f} ms ({dq_bound[1]})")
        errs["dkv"].append(max(err["dk"][0], err["dv"][0]))
        errs["dq"].append(err["dq"][0])
        # the plain backward and PyTorch's own attention backward compute
        # dq, dk and dv in one pass: their times stand beside both kernels
        rows["dkv"].append(dict(ms=dkv_ms, plain_ms=plain_ms, bound_ms=dkv_bound[0],
                                bound_by=dkv_bound[1], library_ms=sdpa_bwd_ms))
        rows["dq"].append(dict(ms=dq_ms, plain_ms=plain_ms, bound_ms=dq_bound[0],
                               bound_by=dq_bound[1], library_ms=sdpa_bwd_ms))
        del q, k, v, dout, out, lse, delta, leaves, dout_heads, sdpa_out
    for which, line in (("dkv", 826), ("dq", 937)):
        records[f"flash_attention_bshd_{which}"] = dict(
            route="cuda", source="vision_ft_tpu_torch/csrc/flash_attention_bshd_bwd.cu",
            replaces=f"vision_ft_tpu/ops/pallas/flash_attention.py:{line}",
            max_abs_err=max(errs[which]), **rows[which][0],
        )

    phase(f"6 SDXL LoRA train steps at full width, bf16, batch {TRAIN_BATCH} at {TRAIN_RES} px")
    from vision_ft_tpu_torch.models.sdxl import train_text_to_image
    from vision_ft_tpu_torch.modules import peft
    from vision_ft_tpu_torch.nn import set_remat_saves
    from vision_ft_tpu_torch.training import (
        get_optimizer, get_schedule, init_train_state, make_train_step,
    )
    from vision_ft_tpu_torch.training.optimizer import global_norm

    lora = peft.LoRAConfig(rank=16, alpha=8.0, dtype="bfloat16")
    model.denoiser.set_gradient_checkpointing(True)
    optimizer = get_optimizer(
        "torch.optim.AdamW", get_schedule("constant", 1e-4, 1000), max_grad_norm=1.0
    )
    loss_fn = functools.partial(train_text_to_image.loss_fn, model)
    step = make_train_step(loss_fn, optimizer)

    def make_batch(batch_size, seed):
        g = torch.Generator(device=device).manual_seed(seed)
        side = TRAIN_RES // 8
        return {
            "cached_latents": torch.randn(batch_size, side, side, 4, device=device, generator=g).bfloat16(),
            "cached_context": torch.randn(batch_size, 225 + 2, 2048, device=device, generator=g).bfloat16(),
            "cached_pooled": torch.randn(batch_size, 1280, device=device, generator=g).bfloat16(),
            "original_size": torch.full((batch_size, 2), float(TRAIN_RES), device=device),
            "target_size": torch.full((batch_size, 2), float(TRAIN_RES), device=device),
            "crop_coords_top_left": torch.zeros(batch_size, 2, device=device),
        }

    def fresh_state():
        """Adapters re-made from their seed (zero delta), a new optimizer."""
        peft.replace_to_peft_layer(
            model.denoiser, LORA_TARGETS, [], lora, torch.Generator(device=device).manual_seed(1)
        )
        trainable, frozen = peft.split_peft_params(model.denoiser)
        return init_train_state(optimizer, trainable), frozen

    def run_steps(state, count, seed):
        g = torch.Generator(device=device).manual_seed(seed)
        out = []
        for _ in range(count):
            torch.cuda.synchronize()
            start = time.perf_counter()
            state, metrics = step(state, batch, g)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - start, metrics["train/loss"].item(),
                        metrics["train/grad_norm"].item()))
        return state, out

    batch = make_batch(TRAIN_BATCH, seed=7)
    state, frozen = fresh_state()
    n_lora = sum(p.numel() for p in state.trainable.values())
    # kept on the host, so that the peak below is the train step's own
    base_before = {k: v.detach().cpu() for k, v in frozen.items()}
    print(f"LoRA rank {lora.rank} alpha {lora.alpha} on {LORA_TARGETS}: {n_lora / 1e6:.1f} M "
          f"trainable parameters in {len(state.trainable)} tensors; base frozen, "
          f"{sum(v.numel() for v in frozen.values()) / 1e9:.3f} B")

    total = TRAIN_WARMUP + TRAIN_TIMED
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    state, first_run = run_steps(state, total, seed=11)
    train_launches = read_launches()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    for i, (seconds, loss, norm) in enumerate(first_run):
        print(f"step {i + 1}: loss {loss:.6f} grad_norm {norm:.6f} {seconds * 1e3:.1f} ms"
              + (" (warm-up)" if i < TRAIN_WARMUP else ""))
        if not (np.isfinite(loss) and np.isfinite(norm) and norm > 0):
            raise AssertionError(f"train step {i + 1}: loss {loss}, grad_norm {norm}")
    step_ms = statistics.median(t for t, _, _ in first_run[TRAIN_WARMUP:]) * 1e3
    print(f"train step (remat saves: kernel): {step_ms:.1f} ms/step, "
          f"{TRAIN_BATCH / step_ms * 1e3:.3f} images/s, peak {peak_gib:.2f} GiB")
    ups = [p for k, p in state.trainable.items() if k.endswith("lora_up.weight")]
    if not all(p.any() for p in ups):
        raise AssertionError("a lora_up is still zero after the train steps")
    # every layer list that holds a transformer is recomputed once in the
    # backward: the LayerNorm kernel runs twice a step; the flash forward
    # once, since the checkpoint keeps its (out, lse)
    want = {"flash_attention_bshd": unet_attn * total,
            "flash_attention_bshd_dkv": unet_attn * total,
            "flash_attention_bshd_dq": unet_attn * total,
            "layer_norm": 2 * unet_ln * total,
            "nf4_matmul_forward": 0, "nf4_matmul_dx": 0, **no_lumina}
    print(f"launches over {total} steps {train_launches}, expected {want}")
    if train_launches != want:
        raise AssertionError(f"train launch counts {train_launches} != {want}")

    if options.profile:
        profile_steps(lambda: run_steps(state, 1, seed=14), step_ms)

    # the other checkpointing mode: nothing kept, so the forward kernel runs
    # again in the recomputation
    set_remat_saves("none")
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    state, none_run = run_steps(state, 2, seed=12)
    set_remat_saves("kernel")
    none_launches = read_launches()
    want_none = {**{k: v // total * 2 for k, v in want.items()},
                 "flash_attention_bshd": 2 * unet_attn * 2}
    print(f"train step (remat saves: none): {none_run[-1][0] * 1e3:.1f} ms/step, "
          f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"launches over 2 steps {none_launches}, expected {want_none}")
    if none_launches != want_none:
        raise AssertionError(f"train launch counts (none) {none_launches} != {want_none}")

    changed = [k for k, v in frozen.items() if not torch.equal(v.cpu(), base_before[k])]
    with_grad = [k for k, v in frozen.items() if v.grad is not None or v.requires_grad]
    others = [p for part in (model.text_encoder, model.vae) for p in part.parameters()]
    if changed or with_grad or any(p.grad is not None for p in others):
        raise AssertionError(f"frozen tensors changed {changed[:3]} or got a gradient {with_grad[:3]}")
    print(f"{len(frozen)} base tensors bit-identical to before, none with a gradient")
    del base_before

    # a second seeded run from the same start
    state, _ = fresh_state()
    state, second_run = run_steps(state, total, seed=11)
    diffs = [abs(a[1] - b[1]) for a, b in zip(first_run, second_run)]
    identical = all(a[1:] == b[1:] for a, b in zip(first_run, second_run))
    print(f"second seeded run: losses and gradient norms "
          f"{'bit-identical' if identical else 'differ'}, max |loss difference| {max(diffs):.3e}")
    if not identical:  # no atomics in any kernel of the path: runs must repeat exactly
        raise AssertionError("two seeded runs of the train steps differ")

    # one step at batch 1: kernels against their plain versions, same
    # adapters (as trained above), same batch, same draws
    small = make_batch(1, seed=8)
    params = list(state.trainable.values())

    def loss_and_norm():
        loss, _ = loss_fn(small, torch.Generator(device=device).manual_seed(13))
        norm = global_norm(torch.autograd.grad(loss, params))
        return loss.item(), norm.item()

    reset_launches()
    kernel_loss, kernel_norm = loss_and_norm()
    used = read_launches()
    with plain_versions():
        plain_loss, plain_norm = loss_and_norm()
    on_path = [n for name, n in used.items()  # a dense base, an SDXL step
               if not name.startswith("nf4_")
               and name not in (*LUMINA_KERNELS, *SHORTK_KERNELS, *OPS_KERNELS)]
    if read_launches() != used or min(on_path) == 0:
        raise AssertionError(f"the plain step launched a kernel, or the kernel step none: {used}")
    loss_rel = abs(kernel_loss - plain_loss) / abs(plain_loss)
    norm_rel = abs(kernel_norm - plain_norm) / abs(plain_norm)
    print(f"batch-1 step, kernels vs plain versions: loss {kernel_loss:.6f} vs {plain_loss:.6f} "
          f"(rel {loss_rel:.3e}, tol {STEP_LOSS_TOL}); grad_norm {kernel_norm:.6f} vs "
          f"{plain_norm:.6f} (rel {norm_rel:.3e}, tol {STEP_GRAD_NORM_TOL})")
    if not (loss_rel <= STEP_LOSS_TOL and norm_rel <= STEP_GRAD_NORM_TOL):
        raise AssertionError("the kernel step and the plain step disagree")

    phase("7 kernel D: packed 4-bit matmul, forward and dx kernels vs plain (bf16)")
    from vision_ft_tpu_torch.modules import quant

    records.update(kernel_d_phase(device, gen))

    phase(f"8 SDXL NF4 QLoRA train steps at full width, batch {TRAIN_BATCH} at {TRAIN_RES} px")
    from vision_ft_tpu_torch.nn import Linear, set_nf4_route

    del state, frozen, params
    layers = dict(model.denoiser.named_modules())
    targeted = [n for n, m in layers.items() if isinstance(m, Linear)
                and any(t in n for t in LORA_TARGETS)]
    dense_bytes = sum(layers[n].weight.numel() * 2 for n in targeted)
    probes = {n: layers[n].weight.detach().float().clone()
              for n in (targeted[0], targeted[len(targeted) // 2], targeted[-1])}
    torch.cuda.synchronize()
    before_gib = torch.cuda.memory_allocated() / 2**30
    start = time.perf_counter()
    quant.quantize_params(model.denoiser, "bnb_nf4", LORA_TARGETS)
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - start
    quantized = [n for n in targeted if layers[n].is_quantized]
    leaves = {f"{n}.weight.{leaf}": t for n in quantized
              for leaf, t in layers[n].weight.named_buffers()}
    packed_bytes = sum(t.numel() * t.element_size() for t in leaves.values())
    ratio = packed_bytes / dense_bytes
    print(f"quantized {len(quantized)} of {len(targeted)} targeted Linears to NF4 on the card in "
          f"{quantize_s:.2f} s: {dense_bytes / 1e9:.3f} GB of bf16 weights -> {packed_bytes / 1e9:.3f} "
          f"GB of leaves (ratio {ratio:.4f}); allocated {before_gib:.2f} -> "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    if len(quantized) != len(targeted) or not 0.28 <= ratio <= 0.30:
        raise AssertionError("not every targeted layer was quantized, or not to 4 bits + absmax")
    for name, dense in probes.items():
        layer = layers[name]
        back = quant.dequantize_weight(layer.weight, torch.float32,
                                       (layer.out_features, layer.in_features))
        err = (back - dense).abs()
        worst, mean = (err.max() / dense.abs().max()).item(), (err.mean() / dense.abs().mean()).item()
        print(f"  {name}: dequantized vs bf16 weight, max err {worst:.3f} of the largest weight, "
              f"mean err {mean:.3f} of the mean")
        if not (worst <= NF4_MAX_ERR and mean <= NF4_MAX_ERR):
            raise AssertionError(f"{name}: dequantized weight is beyond NF4 noise")
    del probes
    # a layer's dx kernel runs where its input needs a gradient: not for
    # the text keys and values (their input is the cached context), and not
    # for q, k, v of the first transformer block (no adapter upstream)
    first_block = quantized[0].rsplit(".attn1.", 1)[0]
    no_dx = [n for n in quantized if n.endswith(("attn2.to_k", "attn2.to_v"))
             or (n.startswith(first_block + ".attn1.") and n.endswith(("to_q", "to_k", "to_v")))]
    n_q, n_dx = len(quantized), len(quantized) - len(no_dx)
    leaves_before = {k: v.detach().cpu() for k, v in leaves.items()}

    def nf4_want(steps, flash_forwards=1):
        """The quantized layers launch their forward kernel in the forward
        and again in the recomputation, whatever the checkpoint keeps."""
        return {"flash_attention_bshd": flash_forwards * unet_attn * steps,
                "flash_attention_bshd_dkv": unet_attn * steps,
                "flash_attention_bshd_dq": unet_attn * steps,
                "layer_norm": 2 * unet_ln * steps,
                "nf4_matmul_forward": 2 * n_q * steps, "nf4_matmul_dx": n_dx * steps, **no_lumina}

    def check_run(name, run):
        for i, (seconds, loss, norm) in enumerate(run):
            print(f"{name} step {i + 1}: loss {loss:.6f} grad_norm {norm:.6f} {seconds * 1e3:.1f} ms"
                  + (" (warm-up)" if i < NF4_WARMUP else ""))
            if not (np.isfinite(loss) and np.isfinite(norm) and norm > 0):
                raise AssertionError(f"{name} train step {i + 1}: loss {loss}, grad_norm {norm}")
        return statistics.median(t for t, _, _ in run[NF4_WARMUP:]) * 1e3

    total = NF4_WARMUP + NF4_TIMED
    state, frozen = fresh_state()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    state, fused_run = run_steps(state, total, seed=21)
    nf4_train_launches = read_launches()
    fused_gib = torch.cuda.max_memory_allocated() / 2**30
    fused_ms = check_run("fused", fused_run)
    print(f"NF4 train step (route fused): {fused_ms:.1f} ms/step, "
          f"{TRAIN_BATCH / fused_ms * 1e3:.3f} images/s, peak {fused_gib:.2f} GiB")
    if not all(p.any() for k, p in state.trainable.items() if k.endswith("lora_up.weight")):
        raise AssertionError("a lora_up is still zero after the NF4 train steps")
    print(f"{n_q} quantized layers, {n_dx} with an input that needs a gradient; launches over "
          f"{total} steps {nf4_train_launches}, expected {nf4_want(total)}")
    if nf4_train_launches != nf4_want(total):
        raise AssertionError(f"NF4 train launch counts {nf4_train_launches} != {nf4_want(total)}")

    if options.profile:
        kinds = profile_steps(lambda: run_steps(state, 1, seed=24), fused_ms)
        kernel_d = {kind: kinds.get(kind, (0.0, 0)) for kind in
                    ("kernel D forward", "kernel D dx", "kernel D split sum")}
        print("kernel D in the traced NF4 step: "
              + ", ".join(f"{kind[9:]} {ms:.2f} ms in {n} launches" for kind, (ms, n) in kernel_d.items())
              + f"; {sum(ms for ms, _ in kernel_d.values()):.2f} ms in all")
        linear_host_cost(device)

    set_remat_saves("none")
    reset_launches()
    state, _ = run_steps(state, 1, seed=22)
    set_remat_saves("kernel")
    if read_launches() != nf4_want(1, flash_forwards=2):
        raise AssertionError(f"NF4 launch counts (remat saves: none) {read_launches()} != "
                             f"{nf4_want(1, flash_forwards=2)}")
    print(f"remat saves none: launches over 1 step {read_launches()}, as expected")

    state, _ = fresh_state()
    state, second_run = run_steps(state, total, seed=21)
    if not all(a[1:] == b[1:] for a, b in zip(fused_run, second_run)):
        raise AssertionError("two seeded runs of the NF4 train steps differ")
    print("second seeded run: losses and gradient norms bit-identical")

    # the other two routes: the same steps from the same start, timed
    route_rows = {"fused": (fused_ms, fused_gib)}
    for route in ("stream", "dequant"):
        set_nf4_route(route)
        try:
            state, _ = fresh_state()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            state, run = run_steps(state, NF4_ROUTE_STEPS, seed=21)
            launches = read_launches()
        finally:
            set_nf4_route("fused")
        route_rows[route] = (check_run(route, run), torch.cuda.max_memory_allocated() / 2**30)
        worst = max(abs(a[1] - b[1]) / abs(b[1]) for a, b in zip(run, fused_run))
        # "stream" keeps the dx kernel in its backward; "dequant" runs no kernel of these
        want_route = {**nf4_want(NF4_ROUTE_STEPS), "nf4_matmul_forward": 0,
                      "nf4_matmul_dx": n_dx * NF4_ROUTE_STEPS if route == "stream" else 0}
        print(f"NF4 train step (route {route}): {route_rows[route][0]:.1f} ms/step, peak "
              f"{route_rows[route][1]:.2f} GiB; losses within {worst:.3e} of the fused route's "
              f"(tol {STEP_LOSS_TOL}); launches {launches}")
        if worst > STEP_LOSS_TOL or launches != want_route:
            raise AssertionError(f"route {route}: losses off by {worst}, or launches != {want_route}")
    print("routes (ms/step, peak GiB): "
          + ", ".join(f"{r} {ms:.1f} / {gib:.2f}" for r, (ms, gib) in route_rows.items()))

    changed = [k for k, v in leaves.items() if not torch.equal(v.cpu(), leaves_before[k])]
    with_grad = [k for k, v in frozen.items() if v.grad is not None or v.requires_grad]
    if changed or with_grad:
        raise AssertionError(f"quantized leaves changed {changed[:3]} or frozen tensors got a "
                             f"gradient {with_grad[:3]}")
    print(f"{len(leaves)} quantized leaves bit-identical to before, none of {len(frozen)} frozen "
          f"tensors with a gradient")
    del leaves_before

    params = list(state.trainable.values())
    reset_launches()
    kernel_loss, kernel_norm = loss_and_norm()
    used = read_launches()
    with plain_versions():
        plain_loss, plain_norm = loss_and_norm()
    if read_launches() != used or min(n for name, n in used.items()
                                      if name not in (*LUMINA_KERNELS, *SHORTK_KERNELS,
                                                      *OPS_KERNELS)) == 0:
        raise AssertionError(f"the plain step launched a kernel, or the kernel step none: {used}")
    loss_rel = abs(kernel_loss - plain_loss) / abs(plain_loss)
    norm_rel = abs(kernel_norm - plain_norm) / abs(plain_norm)
    print(f"batch-1 NF4 step, kernels vs plain versions: loss {kernel_loss:.6f} vs {plain_loss:.6f} "
          f"(rel {loss_rel:.3e}, tol {STEP_LOSS_TOL}); grad_norm {kernel_norm:.6f} vs "
          f"{plain_norm:.6f} (rel {norm_rel:.3e}, tol {STEP_GRAD_NORM_TOL})")
    if not (loss_rel <= STEP_LOSS_TOL and norm_rel <= STEP_GRAD_NORM_TOL):
        raise AssertionError("the NF4 kernel step and the plain step disagree")

    phase("9 SDXL generate() with the NF4 denoiser")
    del state, params
    kwargs = requests[0][1]
    nf4_request = []
    with peft.while_peft_disabled():  # the quantized base alone, as the bf16 requests ran
        for attempt in ("cold", "warm"):
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            torch.cuda.synchronize()
            start = time.perf_counter()
            images = model.generate(num_inference_steps=STEPS, **kwargs)
            torch.cuda.synchronize()
            nf4_request.append(time.perf_counter() - start)
            nf4_generate_launches = read_launches()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    steps = len(model.scheduler.get_timesteps(STEPS))
    array = np.asarray(images[0])
    print(f"NF4 request: {images[0].size}, {steps} steps, {nf4_request[0]:.3f} s cold, "
          f"{nf4_request[1]:.3f} s warm, peak {peak_gib:.2f} GiB (bf16 base: "
          f"{bf16_request[0]:.3f} s warm, peak {bf16_request[1]:.2f} GiB)")
    if not torch.isfinite(model.last_latents).all() or array.std() == 0:
        raise AssertionError("NF4 request: latents not finite, or a constant image")
    want = {"flash_attention_bshd": unet_attn * steps, "flash_attention_bshd_dkv": 0,
            "flash_attention_bshd_dq": 0, "layer_norm": unet_ln * steps + clip_ln,
            "nf4_matmul_forward": n_q * steps, "nf4_matmul_dx": 0, **no_lumina}
    print(f"launches of the warm request {nf4_generate_launches}, expected {want}")
    if nf4_generate_launches != want:
        raise AssertionError(f"NF4 request launch counts {nf4_generate_launches} != {want}")


    # the SDXL model leaves the card before the Lumina2 phases
    for part in model._parts().values():
        part.to("meta")
    del images, batch, small, frozen, leaves, others, ups, args
    gc.collect()
    torch.cuda.empty_cache()
    print(f"SDXL model released: {torch.cuda.memory_allocated() / 2**30:.2f} GiB still allocated "
          f"(counted in the peaks below)")

    phase("10 kernel E: key-masked flash attention forward over (B, H, S, D) vs plain (bf16)")

    def attention_mask(kind, b, sk):
        """hole: [caption 256, right padded to another length per sample | image]."""
        if kind is None:
            return None
        mask = torch.ones(b, sk, dtype=torch.bool, device=device)
        if kind == "hole":
            for i in range(b):
                mask[i, 9 + 31 * i:min(256, sk // 2)] = False
        return mask

    def sdpa_call(q, k, v, mask, causal):
        """PyTorch's own attention on the same tensors: grouped heads by
        ``enable_gqa`` where this PyTorch has it, else on k and v repeated
        beforehand (outside the timed call)."""
        attn_mask = None if mask is None else mask[:, None, None, :]
        if causal and attn_mask is not None:
            attn_mask = attn_mask & torch.ones(
                q.shape[2], k.shape[2], dtype=torch.bool, device=device).tril()
            causal = False
        sdpa = torch.nn.functional.scaled_dot_product_attention
        try:
            sdpa(q[:, :, :8], k[:, :, :8], v[:, :, :8], enable_gqa=True)
            return lambda: sdpa(q, k, v, attn_mask=attn_mask, is_causal=causal, enable_gqa=True)
        except TypeError:
            rep = q.shape[1] // k.shape[1]
            kr, vr = k.repeat_interleave(rep, dim=1), v.repeat_interleave(rep, dim=1)
            return lambda: sdpa(q, kr, vr, attn_mask=attn_mask, is_causal=causal)

    errs, rows = [], []
    for b, h, hk, sq, sk, d, kind, causal in MASKED_ATTN_SHAPES:
        # (B, S, heads, D) memory seen as (B, H, S, D), as the NextDiT hands it over
        q = torch.randn(b, sq, h, d, device=device, generator=gen).bfloat16().transpose(1, 2)
        k, v = (torch.randn(b, sk, hk, d, device=device, generator=gen).bfloat16().transpose(1, 2)
                for _ in "kv")
        mask = attention_mask(kind, b, sk)
        what = f"attention B={b} H={h}/{hk} Sq={sq} Sk={sk} D={d} mask={kind} causal={causal}"
        out, lse = flash_attention_masked(q, k, v, mask, None, causal, return_lse=True)
        ref, ref_lse = flash_attention_reference(q, k, v, mask, None, causal, return_lse=True)
        abs_err, rel_err = compare(what + " out", lambda: out, lambda: ref, MASKED_ATTN_TOL)
        lse_err = compare(what + " lse", lambda: lse, lambda: ref_lse, MASKED_LSE_TOL)
        if out.stride() != q.stride():
            raise AssertionError(f"{what}: the output does not keep q's memory layout")
        del ref, ref_lse
        assert_reruns(what, lambda: flash_attention_masked(q, k, v, mask, None, causal,
                                                           return_lse=True))
        ms = cuda_ms(lambda: flash_attention_masked(q, k, v, mask, None, causal))
        back_to_back_ms = burst_ms(lambda: flash_attention_masked(q, k, v, mask, None, causal))
        plain_ms = cuda_ms(lambda: flash_attention_reference(q, k, v, mask, None, causal),
                           warmup=1, iters=3)
        library_ms = cuda_ms(sdpa_call(q, k, v, mask, causal))
        library_burst_ms = burst_ms(sdpa_call(q, k, v, mask, causal))
        # the work these inputs need: the score pairs the masks leave
        keys = float(b * sk if mask is None else mask.sum().item())
        pairs = keys * sq * (0.5 + 0.5 / sq if causal else 1.0)
        flops = 4 * h * d * pairs
        nbytes = 2 * (2 * b * h * sq * d + 2 * b * hk * sk * d) + (0 if mask is None else b * sk)
        bound_ms, bound_by = bound(nbytes, flops)
        print(f"{what}: max abs err {abs_err:.3e} rel {rel_err:.3e} (tol {MASKED_ATTN_TOL}), lse rel "
              f"{lse_err[1]:.3e} (tol {MASKED_LSE_TOL}), reruns bit-identical; kernel {ms:.4f} ms "
              f"({flops / ms / 1e9:.1f} TFLOP/s, {100 * bound_ms / ms:.1f}% of the bound; "
              f"{back_to_back_ms:.4f} ms a call over 10 back to back), plain {plain_ms:.3f} ms, "
              f"SDPA {library_ms:.4f} ms (kernel {ms / library_ms:.2f}x; {library_burst_ms:.4f} ms "
              f"back to back), bound {bound_ms:.4f} ms ({bound_by})")
        errs.append(abs_err)
        rows.append(dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                         library_ms=library_ms))
        del q, k, v, out, lse
    # a query row with every key masked: the kernel's rule, the mean of v; beside it a batch
    # entry that keeps some keys, whose key tiles masked whole the kernel skips
    q, k, v = (torch.randn(2, 24, 4352, 96, device=device, generator=gen).bfloat16()
               for _ in "qkv")
    k, v = k[:, :8], v[:, :8]
    some = torch.zeros(2, 4352, dtype=torch.bool, device=device)
    some[0, :40] = True
    some[0, 2304:] = True
    out = flash_attention_masked(q, k, v, some)
    compare("attention, batch entry 1 with every key masked", lambda: out[1],
            lambda: v[1].float().mean(dim=1, keepdim=True).repeat_interleave(3, dim=0)
            .expand_as(out[1]), MASKED_ATTN_TOL)
    compare("attention, batch entry 0 with key tiles masked whole", lambda: out[0],
            lambda: flash_attention_reference(q[:1], k[:1], v[:1], some[:1])[0], MASKED_ATTN_TOL)
    assert_reruns("attention, one batch entry keeps no key",
                  lambda: flash_attention_masked(q, k, v, some))
    print("B=2 H=24/8 S=4352 D=96, entry 1 with every key masked: the mean of v, as in the "
          "kernel replaced; entry 0 keeping keys [0, 40) and [2304, 4352): the plain version's "
          "result; reruns bit-identical")
    records["flash_attention_masked"] = dict(
        route="cuda", source="vision_ft_tpu_torch/csrc/flash_attention_masked.cu",
        replaces="vision_ft_tpu/ops/pallas/flash_attention.py:83",
        max_abs_err=max(errs), **rows[0],
    )
    del q, k, v, out

    phase("11 kernel F: fused gated MLP, its parts F-up and F-down, vs plain (bf16)")
    results = []
    for m, c, inner, act, with_biases in FUSED_MLP_SHAPES:
        x, wa, wg, wd, (ba, bg, bd) = mlp_tensors(m, c, inner, with_biases, device, gen)
        results.append(mlp_parts(
            f"M={m} C={c} inner={inner} {act} biases={with_biases}", x, wa, wg, wd, ba, bg, bd,
            act, lambda: gated_mlp(x, wa, wg, wd, ba, bg, bd, act=act)))
    m, c, inner = GEGLU_SHAPE
    x, w1, _, w2, (b1, _, b2) = mlp_tensors(m, c, inner, True, device, gen, fused=True)
    results.append(mlp_parts(
        f"GeGLU M={m} C={c} inner={inner} (one fused up-projection, read by halves)", x,
        w1[inner:], w1[:inner], w2, b1[inner:], b1[:inner], b2, "gelu_tanh",
        lambda: geglu_mlp(x, w1, b1, w2, b2)))
    main_up, main_down, main_full = results[0]
    print(f"the main stack: kernel F {main_full[1]['ms']:.4f} ms ({main_full[1]['tflops']:.1f} "
          f"TFLOP/s) = F-up {main_up[1]['ms']:.4f} + F-down {main_down[1]['ms']:.4f}; three "
          f"F.linear + gate {main_full[1]['library_ms']:.4f} ms: the kernel takes "
          f"{main_full[1]['ms'] / main_full[1]['library_ms']:.3f}x the library's time")
    records["gated_mlp"] = dict(
        route="cuda", source="vision_ft_tpu_torch/csrc/fused_mlp.cu",
        replaces="vision_ft_tpu/ops/pallas/fused_mlp.py:63",
        max_abs_err=max(full[0] for _, _, full in results), **main_full[1],
        parts={name: dict(kernel=kernel, max_abs_err=max(r[i][0] for r in results), **row[1])
               for i, (name, kernel, row) in enumerate((
                   ("up", "gated_up_kernel", main_up), ("down", "gated_down_kernel", main_down)))},
    )
    del x, wa, wg, wd, w1, w2, b1, b2, ba, bg, bd

    phase(f"12 Lumina2 generate() at full width, {LUMINA_CUT_DEPTH['depth']} of the NextDiT's 26 "
          f"main layers, bf16, seeded random weights")
    from vision_ft_tpu_torch.models.lumina2.config import DenoiserConfig as LuminaDenoiserConfig
    from vision_ft_tpu_torch.models.lumina2.config import Lumina2Config
    from vision_ft_tpu_torch.models.lumina2.pipeline import Lumina2
    from vision_ft_tpu_torch.models.text_encoders.sentencepiece import (
        SentencePieceModel, SentencePieceTokenizer,
    )

    class LuminaModel(Lumina2):
        """Keeps the last latents generate() decoded, for the checks."""

        def decode_image(self, latents):
            self.last_latents = latents.clone()
            return super().decode_image(latents)

    tokenizer = SentencePieceTokenizer(SentencePieceModel.from_bytes(lumina_vocab()), template="bos")

    torch.cuda.reset_peak_memory_stats()
    lumina = LuminaModel(Lumina2Config(checkpoint_path="", dtype="bfloat16",
                                       denoiser=LuminaDenoiserConfig(**LUMINA_CUT_DEPTH)),
                         tokenizer=tokenizer)
    start = time.perf_counter()
    lumina.init_params(torch.Generator(device=device).manual_seed(0))
    torch.cuda.synchronize()
    counts = [sum(p.numel() for p in part.parameters()) for part in
              (lumina.denoiser, lumina.text_encoder, lumina.vae)]
    print(f"init on the card: {time.perf_counter() - start:.1f} s; NextDiT {counts[0] / 1e9:.3f} B, "
          f"Gemma-2 {counts[1] / 1e9:.3f} B, VAE {counts[2] / 1e6:.1f} M parameters; "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    config = lumina.denoiser.config
    head_dim = config.hidden_dim // config.num_heads
    print(f"NextDiT: hidden {config.hidden_dim}, {config.depth} + {config.refiner_depth} + "
          f"{config.refiner_depth} blocks, {config.num_heads} heads over {config.num_kv_heads} kv "
          f"heads, head dim {head_dim}, SwiGLU inner "
          f"{lumina.denoiser.layers['0']['feed_forward']['w2'].in_features}")

    def want_blocks(steps, trunc=0.0, interval=None, cache_depth=None, cfg=True):
        """Transformer blocks one request runs, from the module tree and
        generate()'s caching rules: each launches kernel E and kernel F once."""
        depth, refiner = len(lumina.denoiser.layers), len(lumina.denoiser.noise_refiner)
        shallow = cache_depth if cache_depth is not None else max(1, depth // 4)
        blocks, was_cfg, have_captions, have_delta = 0, None, False, False
        for i in range(steps):
            cfg_step = cfg and (i + 1) / steps > trunc
            if was_cfg is not None and was_cfg != cfg_step:
                have_captions = have_delta = False
            blocks += refiner + (0 if have_captions else len(lumina.denoiser.context_refiner))
            if interval and i % interval != 0 and have_delta:
                blocks += shallow
            else:
                blocks += depth
                have_delta = bool(interval)
            was_cfg, have_captions = cfg_step, True
        return blocks

    def lumina_request(name, expected_blocks, **kwargs):
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        torch.cuda.synchronize()
        start = time.perf_counter()
        images = lumina.generate(**kwargs)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        launches = read_launches()
        latents, arrays = lumina.last_latents, [np.asarray(im) for im in images]
        print(f"request {name}: {len(images)} image(s) {images[0].size}, "
              f"{kwargs['num_inference_steps']} steps, {seconds:.3f} s, peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches kernel E "
              f"{launches['flash_attention_masked']}, kernel F {launches['gated_mlp']}, expected "
              f"{expected_blocks} of each")
        if not torch.isfinite(latents).all() or any(a.std() == 0 for a in arrays):
            raise AssertionError(f"request {name}: latents not finite, or a constant image")
        if images[0].size != (kwargs["width"], kwargs["height"]) or latents.shape[1:] != (
                kwargs["height"] // 8, kwargs["width"] // 8, 16):
            raise AssertionError(f"request {name}: wrong size {images[0].size}, {latents.shape}")
        want = {name: 0 for name in wrappers}
        want.update({"flash_attention_masked": expected_blocks[0], "gated_mlp": expected_blocks[1]})
        if launches != want:
            raise AssertionError(f"request {name}: launch counts {launches} != {want}")
        return seconds, latents, arrays, launches

    base = dict(prompt="a photo of a cat sitting on the sofa", negative_prompt="blurry",
                width=1024, height=1024, cfg_scale=4.0, seed=1234, num_inference_steps=STEPS)
    both = lambda n: (n, n)  # noqa: E731
    lumina_launches = {name: 0 for name in wrappers}
    runs = {}
    for name, expected_blocks, kwargs in (
        ("a (cold)", both(want_blocks(STEPS)), base),
        ("a (warm)", both(want_blocks(STEPS)), base),
        ("b (two prompts, 832x1216)", both(want_blocks(STEPS)),
         dict(base, prompt=["a red car on the road", "a house in the mountains in a photo of a cat"],
              negative_prompt=None, width=832, height=1216, seed=99)),
        ("c (cfg_truncation_ratio 0.5)", both(want_blocks(STEPS, trunc=0.5)),
         dict(base, cfg_truncation_ratio=0.5)),
        ("d (deep_cache_interval 2)", both(want_blocks(STEPS, interval=2)),
         dict(base, deep_cache_interval=2)),
    ):
        runs[name] = lumina_request(name, expected_blocks, **kwargs)
        for kernel, n in runs[name][3].items():
            lumina_launches[kernel] += n
    same = torch.equal(runs["a (cold)"][1], runs["a (warm)"][1]) and all(
        np.array_equal(x, y) for x, y in zip(runs["a (cold)"][2], runs["a (warm)"][2]))
    if not same:
        raise AssertionError("the warm request (the cold one repeated, same seed) differs from it")
    print("request a warm == request a cold, bit for bit")
    for name in ("c (cfg_truncation_ratio 0.5)", "d (deep_cache_interval 2)"):
        if torch.equal(runs[name][1], runs["a (warm)"][1]):
            raise AssertionError(f"request {name} equals request a: the option did nothing")
    depth, refiner = len(lumina.denoiser.layers), len(lumina.denoiser.noise_refiner)
    print(f"module tree: {depth} main blocks, {refiner} noise refiner and "
          f"{len(lumina.denoiser.context_refiner)} context refiner blocks, one kernel E and one "
          f"kernel F launch each: {depth + refiner} a step, {len(lumina.denoiser.context_refiner)} "
          f"more when the caption cache is empty")

    # the same warm request with the fused feed-forward off: three cuBLAS
    # calls and the gate in its place, kernel E as before
    set_fused_ff("off")
    try:
        off = lumina_request('a (warm, set_fused_ff("off"))', (want_blocks(STEPS), 0), **base)
    finally:
        set_fused_ff("auto")
    scale = runs["a (warm)"][1].float().abs().max().item()
    drift = (off[1].float() - runs["a (warm)"][1].float()).abs().max().item() / scale
    print(f'request a warm: {runs["a (warm)"][0]:.3f} s with the fused feed-forward kernel ("auto"), '
          f'{off[0]:.3f} s with it off; the latents differ by {drift:.3e} of their largest value '
          f"(kernel F keeps h and g in fp32 where three bf16 Linears round them; "
          f"tol {LUMINA_REQUEST_TOL})")
    if drift > LUMINA_REQUEST_TOL:
        raise AssertionError('the "auto" request and the "off" request disagree')

    # one denoise step alone: CFG forward (batch 2) at 1024 px, captions cached
    g12 = torch.Generator(device=device).manual_seed(5)
    step_latents = torch.randn(1, 128, 128, 16, device=device, generator=g12).bfloat16()
    captions = torch.randn(2, 256, config.caption_dim, device=device, generator=g12).bfloat16()
    caption_mask = torch.zeros(2, 256, dtype=torch.int32, device=device)
    caption_mask[0, :11], caption_mask[1, :2] = 1, 1

    def denoise_step(cached=None):
        with torch.inference_mode():
            return lumina._denoise_step(
                step_latents, 0.5, 0.7, 0.6, captions, caption_mask, cached, 4.0, 1.0,
                do_cfg=True, use_cache=cached is not None)

    refined = denoise_step()[1]
    step_ms = {}
    for mode in ("auto", "off"):
        set_fused_ff(mode)
        try:
            step_ms[mode] = cuda_ms(lambda: denoise_step(refined), warmup=1, iters=3)
        finally:
            set_fused_ff("auto")
    print(f"one CFG denoise step at 1024 px (batch 2, 4352 joint tokens, captions cached): "
          f"{step_ms['auto']:.1f} ms; {step_ms['off']:.1f} ms with the fused feed-forward off")
    if options.profile:
        profile_steps(lambda: denoise_step(refined), step_ms["auto"], "Lumina2 denoise step")

    # a depth-reduced request, the kernels against their plain versions
    # (swapped in by this script's hook, not by a fallback): the first 4 main
    # blocks and both refiners, 4 steps
    full_layers = lumina.denoiser.layers
    lumina.denoiser.layers = torch.nn.ModuleDict({str(i): full_layers[str(i)] for i in range(4)})
    try:
        reduced = dict(base, num_inference_steps=4)
        kernel_run = lumina_request("reduced (4 main blocks, kernels)", both(want_blocks(4)), **reduced)
        with plain_versions():
            plain_run = lumina_request("reduced (4 main blocks, plain versions)", (0, 0), **reduced)
    finally:
        lumina.denoiser.layers = full_layers
    scale = plain_run[1].float().abs().max().item()
    request_err = (kernel_run[1].float() - plain_run[1].float()).abs().max().item() / scale
    print(f"reduced request, kernels vs plain versions: latents differ by {request_err:.3e} of "
          f"their largest value (tol {LUMINA_REQUEST_TOL})")
    if request_err > LUMINA_REQUEST_TOL:
        raise AssertionError("the kernel request and the plain request disagree")

    phase("13 kernel G: key-masked flash attention backward (dk/dv kernel, dq kernel) vs plain (bf16)")
    errs, rows = {"dkv": [], "dq": []}, {"dkv": [], "dq": []}
    for b, h, hk, sq, sk, d, kind, causal in MASKED_BWD_SHAPES:
        # (B, S, heads, D) memory seen as (B, H, S, D), v a slice of a wider buffer, as
        # the NextDiT's fused qkv projection hands them over
        q = torch.randn(b, sq, h, d, device=device, generator=gen).bfloat16().transpose(1, 2)
        k = torch.randn(b, sk, hk, d, device=device, generator=gen).bfloat16().transpose(1, 2)
        wide = torch.randn(b, sk, 2 * hk * d, device=device, generator=gen).bfloat16()
        v = wide[..., hk * d:].unflatten(-1, (hk, d)).transpose(1, 2)
        dout = torch.randn(b, sq, h, d, device=device, generator=gen).bfloat16().transpose(1, 2)
        mask = attention_mask(kind, b, sk)
        what = f"attention backward B={b} H={h}/{hk} Sq={sq} Sk={sk} D={d} mask={kind} causal={causal}"
        out, lse = flash_attention_masked(q, k, v, mask, None, causal, return_lse=True)
        delta = flash_attention_masked_delta(out, dout)
        dk, dv = flash_attention_masked_dkv(q, k, v, mask, dout, lse, delta, None, causal)
        dq = flash_attention_masked_dq(q, k, v, mask, dout, lse, delta, None, causal)
        rerun = flash_attention_masked_backward(q, k, v, mask, out, lse, dout, None, causal)
        if not all(torch.equal(x, y) for x, y in zip((dq, dk, dv), rerun)):
            raise AssertionError(f"{what}: two launches differ")
        refs = flash_attention_masked_backward_reference(q, k, v, mask, out, lse, dout, None, causal)
        err = {name: compare(f"{what} {name}", lambda: got, lambda: ref, MASKED_BWD_TOL)
               for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), refs)}
        del refs, rerun, dq, dk, dv
        dkv_ms = cuda_ms(lambda: flash_attention_masked_dkv(q, k, v, mask, dout, lse, delta, None, causal))
        dq_ms = cuda_ms(lambda: flash_attention_masked_dq(q, k, v, mask, dout, lse, delta, None, causal))
        whole_ms = cuda_ms(
            lambda: flash_attention_masked_backward(q, k, v, mask, out, lse, dout, None, causal))
        plain_ms = cuda_ms(
            lambda: flash_attention_masked_backward_reference(q, k, v, mask, out, lse, dout, None, causal),
            warmup=1, iters=3)
        # yardstick only: PyTorch's own attention with the mask and grouped heads,
        # its backward alone (dq, dk and dv in one call)
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        sdpa_out = sdpa_call(*leaves, mask, causal)()
        library_ms = cuda_ms(lambda: torch.autograd.grad(sdpa_out, leaves, dout, retain_graph=True))
        del sdpa_out, leaves
        keys = float(b * sk if mask is None else mask.sum().item())
        pairs = keys * sq * (0.5 + 0.5 / sq if causal else 1.0)
        qo_bytes, kv_bytes = 2 * b * h * sq * d, 2 * b * hk * sk * d
        read = 2 * qo_bytes + 2 * kv_bytes + 2 * 4 * b * h * sq + (0 if mask is None else b * sk)
        # dk/dv: S^T, dP^T, dV, dK; dq: S, dP, dQ (2 operations a multiply-add)
        dkv_bound = bound(read + 2 * kv_bytes, 8 * h * d * pairs)
        dq_bound = bound(read + qo_bytes, 6 * h * d * pairs)
        print(f"{what}: " + ", ".join(f"{n} max abs err {a:.3e} rel {r:.3e}" for n, (a, r) in err.items())
              + f" (tol {MASKED_BWD_TOL}), reruns bit-identical; dk/dv kernel {dkv_ms:.4f} ms "
              f"({8 * h * d * pairs / dkv_ms / 1e9:.1f} TFLOP/s, "
              f"{100 * dkv_bound[0] / dkv_ms:.1f}% of its bound), dq kernel {dq_ms:.4f} ms "
              f"({6 * h * d * pairs / dq_ms / 1e9:.1f} TFLOP/s, {100 * dq_bound[0] / dq_ms:.1f}% of "
              f"its bound), both {dkv_ms + dq_ms:.4f} ms "
              f"({100 * (dkv_bound[0] + dq_bound[0]) / (dkv_ms + dq_ms):.1f}% of the bounds' sum), "
              f"whole backward {whole_ms:.4f} ms ({whole_ms / library_ms:.2f}x SDPA's backward), "
              f"plain {plain_ms:.3f} ms, SDPA backward {library_ms:.4f} ms; bounds dk/dv "
              f"{dkv_bound[0]:.4f} ms ({dkv_bound[1]}), dq {dq_bound[0]:.4f} ms ({dq_bound[1]})")
        errs["dkv"].append(max(err["dk"][0], err["dv"][0]))
        errs["dq"].append(err["dq"][0])
        # the plain backward and SDPA's backward compute dq, dk and dv in one
        # pass: their times stand beside both kernels
        rows["dkv"].append(dict(ms=dkv_ms, plain_ms=plain_ms, bound_ms=dkv_bound[0],
                                bound_by=dkv_bound[1], library_ms=library_ms))
        rows["dq"].append(dict(ms=dq_ms, plain_ms=plain_ms, bound_ms=dq_bound[0],
                               bound_by=dq_bound[1], library_ms=library_ms))
        del q, k, v, wide, dout, out, lse, delta
    for which, line in (("dkv", 262), ("dq", 215)):
        records[f"flash_attention_masked_{which}"] = dict(
            route="cuda", source="vision_ft_tpu_torch/csrc/flash_attention_masked_bwd.cu",
            replaces=f"vision_ft_tpu/ops/pallas/flash_attention.py:{line}",
            max_abs_err=max(errs[which]), **rows[which][0],
        )
    gc.collect()
    torch.cuda.empty_cache()

    phase(f"14 Lumina2 LoRA train steps at full width, {LUMINA_CUT_DEPTH['depth']} of the NextDiT's "
          f"26 main layers, bf16, batch {TRAIN_BATCH} at {TRAIN_RES} px")
    from vision_ft_tpu_torch.models.lumina2 import train_text_to_image as lumina_train
    from vision_ft_tpu_torch.nn import set_remat_group

    lumina_lora = peft.LoRAConfig(rank=16, alpha=8.0, dtype="bfloat16")
    lumina.denoiser.set_gradient_checkpointing(True)
    lumina_optimizer = get_optimizer(
        "torch.optim.AdamW", get_schedule("constant", 1e-4, 1000), max_grad_norm=1.0
    )
    lumina_loss_fn = functools.partial(lumina_train.loss_fn, lumina)
    lumina_step = make_train_step(lumina_loss_fn, lumina_optimizer)
    captions = ["a cat", "a photo of a red car on the road",
                "a house in the mountains in a photo of a cat sitting on the sofa",
                "blurry photo of the sofa"]

    def lumina_batch(batch_size, seed):
        g = torch.Generator(device=device).manual_seed(seed)
        ids, mask = lumina.text_encoder.tokenize(captions[:batch_size], 256)
        return {
            "pixel_values": torch.rand(batch_size, TRAIN_RES, TRAIN_RES, 3, device=device,
                                       generator=g) * 2 - 1,
            "input_ids": torch.from_numpy(ids).to(device),
            "attention_mask": torch.from_numpy(mask).to(device),
        }

    def lumina_state():
        """Adapters re-made from their seed (zero delta), a new optimizer."""
        peft.replace_to_peft_layer(lumina.denoiser, LUMINA_LORA_TARGETS, [], lumina_lora,
                                   torch.Generator(device=device).manual_seed(1))
        trainable, frozen = peft.split_peft_params(lumina.denoiser)
        return init_train_state(lumina_optimizer, trainable), frozen

    def lumina_steps(state, count, seed, batch):
        g = torch.Generator(device=device).manual_seed(seed)
        out = []
        for _ in range(count):
            torch.cuda.synchronize()
            start = time.perf_counter()
            state, metrics = lumina_step(state, batch, g)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - start, metrics["train/loss"].item(),
                        metrics["train/grad_norm"].item(), metrics["train/lowres_loss"].item()))
        return state, out

    train_batch = lumina_batch(TRAIN_BATCH, seed=31)
    print(f"captions of {train_batch['attention_mask'].sum(dim=1).tolist()} tokens of 256")
    attentions = len(lumina.denoiser.layers) + 2 * len(lumina.denoiser.noise_refiner)

    # LoRA on the attention only: the feed-forwards keep kernel F (forward, in
    # the first pass and again in the recomputation; its backward is plain)
    peft.replace_to_peft_layer(lumina.denoiser, ["attention"], [], lumina_lora,
                               torch.Generator(device=device).manual_seed(2))
    state = init_train_state(lumina_optimizer, peft.split_peft_params(lumina.denoiser)[0])
    reset_launches()
    state, attention_only = lumina_steps(state, 1, 40, train_batch)
    launches = read_launches()
    want = {name: 0 for name in wrappers}
    want.update({"flash_attention_masked": 2 * attentions, "flash_attention_masked_dkv": 2 * attentions,
                 "flash_attention_masked_dq": 2 * attentions, "gated_mlp": 4 * attentions})
    print(f"one step with LoRA on the attention only ({len(state.trainable) // 2} layers): loss "
          f"{attention_only[0][1]:.6f}, {attention_only[0][0] * 1e3:.1f} ms (cold); launches "
          f"{launches}, expected {want}")
    if not np.isfinite(attention_only[0][1]) or launches != want:
        raise AssertionError("the attention-only LoRA step: loss not finite or launches off")
    # the same step warm, with kernel F ("auto") and with three cuBLAS calls in
    # its place ("off"): three pairs, the modes alternating so that neither
    # gets the host's better moments, the same statistics for both
    step_s = {"auto": [], "off": []}
    for mode in ("auto", "off", "off", "auto", "auto", "off"):
        set_fused_ff(mode)
        try:
            state, timed = lumina_steps(state, 1, 41, train_batch)
        finally:
            set_fused_ff("auto")
        step_s[mode].append(timed[0][0] * 1e3)
    print("the attention-only LoRA step warm, ms: " + "; ".join(
        f"{label} median {statistics.median(ms):.1f} (min {min(ms):.1f}, max {max(ms):.1f}, "
        f"runs {', '.join(f'{t:.1f}' for t in ms)})"
        for label, ms in (('"auto" (kernel F)', step_s["auto"]), ('"off"', step_s["off"]))))

    state, frozen = lumina_state()
    n_lora = sum(p.numel() for p in state.trainable.values())
    adapted = len(state.trainable) // 2
    base_before = {k: v.detach().cpu() for k, v in frozen.items()}  # on the host: not in the peak
    print(f"LoRA rank {lumina_lora.rank} alpha {lumina_lora.alpha} on {LUMINA_LORA_TARGETS}: "
          f"{adapted} layers, {n_lora / 1e6:.1f} M trainable parameters; base frozen, "
          f"{sum(v.numel() for v in frozen.values()) / 1e9:.3f} B")
    if adapted != 5 * attentions:
        raise AssertionError(f"LoRA found {adapted} layers, not 5 in each of {attentions} blocks")

    total = LUMINA_TRAIN_WARMUP + LUMINA_TRAIN_TIMED
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    state, lumina_run = lumina_steps(state, total, 41, train_batch)
    lumina_train_launches = read_launches()
    lumina_peak = torch.cuda.max_memory_allocated() / 2**30
    for i, (seconds, loss, norm, low) in enumerate(lumina_run):
        print(f"step {i + 1}: loss {loss:.6f} (low-res {low:.6f}) grad_norm {norm:.6f} "
              f"{seconds * 1e3:.1f} ms" + (" (warm-up)" if i < LUMINA_TRAIN_WARMUP else ""))
        if not (np.isfinite(loss) and np.isfinite(norm) and norm > 0):
            raise AssertionError(f"Lumina2 train step {i + 1}: loss {loss}, grad_norm {norm}")
    lumina_step_ms = statistics.median(t for t, *_ in lumina_run[LUMINA_TRAIN_WARMUP:]) * 1e3
    print(f"Lumina2 train step (remat saves: kernel): {lumina_step_ms:.1f} ms/step, "
          f"{TRAIN_BATCH / lumina_step_ms * 1e3:.3f} images/s, peak {lumina_peak:.2f} GiB")
    if not all(p.any() for k, p in state.trainable.items() if k.endswith("lora_up.weight")):
        raise AssertionError("a lora_up is still zero after the Lumina2 train steps")
    # every attention of the high-res and the low-res pass passes the sk >= 256
    # gate and wants gradients; the checkpoint keeps (out, lse), so kernel E runs
    # once; kernel F stays off (LoRA on w1, w2, w3)
    want = {name: 0 for name in wrappers}
    want.update({"flash_attention_masked": 2 * attentions * total,
                 "flash_attention_masked_dkv": 2 * attentions * total,
                 "flash_attention_masked_dq": 2 * attentions * total})
    print(f"launches over {total} steps {lumina_train_launches}, expected {want}")
    if lumina_train_launches != want:
        raise AssertionError(f"Lumina2 train launch counts {lumina_train_launches} != {want}")
    if options.profile:
        kinds = profile_steps(lambda: lumina_steps(state, 1, 44, train_batch), lumina_step_ms,
                              "Lumina2 train step")
        print_kernel_ms(kinds, ["kernel G dk/dv", "kernel G dq", "kernel E"], "Lumina2 train step")

    set_remat_saves("none")
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    try:
        state, none_run = lumina_steps(state, 1, 42, train_batch)
    finally:
        set_remat_saves("kernel")
    none_launches = read_launches()
    want_none = {**{k: v // total for k, v in want.items()},
                 "flash_attention_masked": 4 * attentions}
    print(f"Lumina2 train step (remat saves: none): {none_run[0][0] * 1e3:.1f} ms, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {none_launches}, "
          f"expected {want_none}")
    if none_launches != want_none:
        raise AssertionError(f"Lumina2 launch counts (none) {none_launches} != {want_none}")

    changed = [k for k, v in frozen.items() if not torch.equal(v.cpu(), base_before[k])]
    with_grad = [k for k, v in frozen.items() if v.grad is not None or v.requires_grad]
    others = [p for part in (lumina.text_encoder, lumina.vae) for p in part.parameters()]
    if changed or with_grad or any(p.grad is not None for p in others):
        raise AssertionError(f"frozen tensors changed {changed[:3]} or got a gradient {with_grad[:3]}")
    print(f"{len(frozen)} base tensors bit-identical to before, none with a gradient; Gemma-2 and "
          f"the VAE without gradients")
    del base_before

    state, second = lumina_state()
    state, second_run = lumina_steps(state, 2, 41, train_batch)
    if not all(a[1:] == b[1:] for a, b in zip(lumina_run, second_run)):
        raise AssertionError("two seeded runs of the Lumina2 train steps differ")
    print("second seeded run: losses and gradient norms of the first 2 steps bit-identical")

    # the gradients of one loss, in both remat modes and in groups of 1 and 2
    params = list(state.trainable.values())

    def lumina_grads(batch, seed=43):
        loss, _ = lumina_loss_fn(batch, torch.Generator(device=device).manual_seed(seed))
        return loss.item(), torch.autograd.grad(loss, params)

    _, want_grads = lumina_grads(train_batch)
    for group, mode in ((1, "none"), (2, "kernel")):
        set_remat_group(group)
        set_remat_saves(mode)
        torch.cuda.reset_peak_memory_stats()
        try:
            _, got = lumina_grads(train_batch)
        finally:
            set_remat_group(1)
            set_remat_saves("kernel")
        if not all(torch.equal(a, b) for a, b in zip(got, want_grads)):
            raise AssertionError(f"gradients with remat group {group}, saves {mode} differ")
        print(f"gradients with remat group {group}, saves {mode}: bit-identical to group 1, saves "
              f"kernel (peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB)")
    del got, want_grads

    # a depth-reduced step (the first 4 main blocks and both refiners) with the
    # kernels against the same step on their plain versions, swapped in by this
    # script's hook: same adapters, batch, draws
    small = lumina_batch(2, seed=32)
    full_layers = lumina.denoiser.layers
    lumina.denoiser.layers = torch.nn.ModuleDict({str(i): full_layers[str(i)] for i in range(4)})
    params = [p for k, p in state.trainable.items()
              if not k.startswith("layers.") or int(k.split(".")[1]) < 4]
    try:
        reset_launches()
        kernel_loss, kernel_grads = lumina_grads(small)
        used = read_launches()
        with plain_versions():
            plain_loss, plain_grads = lumina_grads(small)
    finally:
        lumina.denoiser.layers = full_layers
    kernel_norm, plain_norm = global_norm(kernel_grads).item(), global_norm(plain_grads).item()
    if read_launches() != used or min(used[n] for n in LUMINA_KERNELS if n != "gated_mlp") == 0:
        raise AssertionError(f"the plain step launched a kernel, or the kernel step none: {used}")
    loss_rel = abs(kernel_loss - plain_loss) / abs(plain_loss)
    norm_rel = abs(kernel_norm - plain_norm) / abs(plain_norm)
    print(f"depth-reduced step (4 main blocks, batch 2), kernels vs plain versions: loss "
          f"{kernel_loss:.6f} vs {plain_loss:.6f} (rel {loss_rel:.3e}, tol {STEP_LOSS_TOL}); "
          f"grad_norm {kernel_norm:.6f} vs {plain_norm:.6f} (rel {norm_rel:.3e}, tol "
          f"{STEP_GRAD_NORM_TOL})")
    if not (loss_rel <= STEP_LOSS_TOL and norm_rel <= STEP_GRAD_NORM_TOL):
        raise AssertionError("the Lumina2 kernel step and the plain step disagree")
    del kernel_grads, plain_grads, params, state, frozen, second

    # the Lumina2 model leaves the card before the SDXL phases 15-17
    for part in (lumina.denoiser, lumina.text_encoder, lumina.vae):
        part.to("meta")
    del small, train_batch
    gc.collect()
    torch.cuda.empty_cache()

    phase("15 kernels H and I: short-K attention forward and backward vs plain (bf16)")
    records.update(kernels_h_i_phase(device, gen, traces))

    phase("16 SDXL requests with the short-K kernels and the fused feed-forward on")
    from vision_ft_tpu_torch.models.sdxl.denoiser import CrossAttention, FeedForward

    with tempfile.TemporaryDirectory() as vocab_dir:
        write_vocab(Path(vocab_dir))
        tokenizer = CLIPTokenizer.from_pretrained_dir(vocab_dir)
        model = Model(SDXLConfig(checkpoint_path="", dtype="bfloat16"), tokenizer=tokenizer)
    model.init_params(torch.Generator(device=device).manual_seed(0))
    cross = sum(isinstance(m, CrossAttention) and not isinstance(m, SelfAttention)
                for m in model.denoiser.modules())
    ffs = sum(isinstance(m, FeedForward) for m in model.denoiser.modules())
    kwargs = requests[0][1]
    steps = len(model.scheduler.get_timesteps(STEPS))

    def routed_request(label):
        reset_launches()
        torch.cuda.synchronize()
        start = time.perf_counter()
        model.generate(num_inference_steps=STEPS, **kwargs)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        return model.last_latents.float(), read_launches(), seconds

    routed_request("warm-up")  # the model was just made: a first request allocates
    base_latents, base_launches, base_s = routed_request("default")
    route_launches = {}
    for label, switch_on, switch_off, kernel in (
        ("short-K", lambda: set_flash_shortk(True), lambda: set_flash_shortk(False),
         "flash_attention_shortk"),
        ("fused feed-forward", lambda: set_fused_ff("on"), lambda: set_fused_ff("auto"),
         "gated_mlp"),
    ):
        switch_on()
        try:
            latents, launches, seconds = routed_request(label)
        finally:
            switch_off()
        route_launches[kernel] = launches
        err = (latents - base_latents).abs().max().item() / base_latents.abs().max().item()
        want = {**base_launches, kernel: (cross if kernel == "flash_attention_shortk" else ffs) * steps}
        print(f"1024 px request, {label} on: {seconds:.3f} s (default route {base_s:.3f} s); "
              f"latents vs the default route rel {err:.3e} (tol {ROUTE_REQUEST_TOL}); "
              f"{kernel} launches {launches[kernel]} ({cross if kernel.endswith('shortk') else ffs} a "
              f"CFG forward x {steps} steps), kernel I {launches['flash_attention_shortk_bwd']}")
        if not torch.isfinite(latents).all() or err > ROUTE_REQUEST_TOL:
            raise AssertionError(f"request with {label} on: latents off by {err:.3e}")
        if launches != want:
            raise AssertionError(f"request with {label} on: launch counts {launches} != {want}")
        if options.profile and kernel == "flash_attention_shortk":
            set_flash_shortk(True)
            try:
                kinds = profile_steps(lambda: model.generate(num_inference_steps=STEPS, **kwargs),
                                      seconds * 1e3, "1024 px request with the short-K kernels")
            finally:
                set_flash_shortk(False)
            print_kernel_ms(kinds, ["kernel H"], "1024 px request with the short-K kernels")
    del base_latents, latents

    phase("17 the Trainer at full SDXL width: checkpoint, datasets, LoRA, saving, preview")
    import yaml

    from vision_ft_tpu_torch.config import TrainConfig
    from vision_ft_tpu_torch.models.sdxl.util import convert_to_comfy_key
    from vision_ft_tpu_torch.train.sdxl.text_to_image import build_trainer
    from vision_ft_tpu_torch.utils import safetensors as st

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_trainer_"))
    try:
        write_vocab(work)
        images_dir = work / "images"
        images_dir.mkdir()
        img_rng = np.random.default_rng(0)
        for i, (w, h) in enumerate(TRAINER_IMAGES):
            smooth = img_rng.integers(0, 255, (h // 32, w // 32, 3), dtype=np.uint8)
            Image.fromarray(smooth).resize((w, h), Image.BILINEAR).save(images_dir / f"{i}.png")
            (images_dir / f"{i}.txt").write_text(  # the synthetic vocab's letters and commas
                f"a photo of the cat, {'abcdefgh'[i] * 3}, on the sofa")
        ckpt = work / "sdxl.safetensors"
        start = time.perf_counter()
        st.save_file(model.state_dict(), ckpt)
        write_s = time.perf_counter() - start
        for part in model._parts().values():  # the Trainer loads its own model from the file
            part.to("meta")
        gc.collect()
        torch.cuda.empty_cache()
        (work / "preview.yml").write_text(yaml.safe_dump([dict(
            prompt="a photo of the cat on the sofa", negative_prompt="blurry", height=1024,
            width=1024, cfg_scale=5.0, num_steps=STEPS, seed=0)]))
        raw = yaml.safe_load(Path("configs/sdxl/text_to_image_lora.yml").read_text())
        raw["model"].update(checkpoint_path=str(ckpt), max_token_length=75,
                            tokenizer_path=str(work))
        raw["dataset"].update(folder=str(images_dir), num_repeats=1, batch_size=2)
        raw["num_train_epochs"] = 1
        raw["saving"]["callbacks"][0]["save_dir"] = str(work / "lora")
        raw["preview"]["callbacks"][0]["save_dir"] = str(work / "preview")
        raw["preview"]["data"]["path"] = str(work / "preview.yml")
        raw["trainer"]["mesh"] = {"data": 1, "fsdp": 1, "tensor": 1}
        config = TrainConfig.model_validate(raw, strict=True)
        print(f"checkpoint {ckpt.stat().st_size / 1e9:.3f} GB written in {write_s:.1f} s; config "
              f"{config.optimizer.name} {config.optimizer.args}, LoRA {config.peft.config.rank} on "
              f"{config.peft.include_keys}, batch {config.dataset['batch_size']}, "
              f"{config.model.get('max_token_length')} tokens, cached latents and text")

        set_flash_shortk(True)
        trainer = build_trainer(config)
        step_log = []  # (seconds, loss, launches) per step, read around the step alone
        load_s = []
        setup_model = trainer.model.setup_model

        def timed_setup():
            start = time.perf_counter()
            setup_model()
            torch.cuda.synchronize()
            load_s.append(time.perf_counter() - start)

        trainer.model.setup_model = timed_setup
        prepare_optimizer = trainer.prepare_optimizer

        def prepare_and_time():
            prepare_optimizer()
            inner = trainer._step

            def timed(state, batch, generator):
                torch.cuda.synchronize()
                before = read_launches()
                start = time.perf_counter()
                state, metrics = inner(state, batch, generator)
                loss = metrics["train/loss"].item()
                torch.cuda.synchronize()
                after = read_launches()
                step_log.append((time.perf_counter() - start, loss,
                                 {k: after[k] - before[k] for k in after}, batch))
                return state, metrics

            trainer._step = timed

        trainer.prepare_optimizer = prepare_and_time
        torch.cuda.reset_peak_memory_stats()
        start = time.perf_counter()
        reset_launches()
        trainer.train()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - start
        trainer_launches = read_launches()  # the whole run, with its preview, for the record
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        losses = [loss for _, loss, _, _ in step_log]
        step_ms = statistics.median(t for t, _, _, _ in step_log[1:]) * 1e3
        print(f"trainer.train(): {run_s:.1f} s with the checkpoint load {load_s[0]:.1f} s; "
              f"{len(step_log)} steps, losses {[round(x, 6) for x in losses]}; "
              f"{step_ms:.1f} ms/step (median after the first, host clock, synchronized), "
              f"{config.dataset['batch_size'] / step_ms * 1e3:.3f} images/s, peak {peak_gib:.2f} GiB")
        if len(step_log) != len(TRAINER_IMAGES) // 2 or not all(np.isfinite(losses)):
            raise AssertionError(f"trainer steps: {losses}")

        sdxl = trainer.model.model
        unet = trainer.model.model.denoiser
        unet_ln = sum(isinstance(m, LayerNorm) for m in unet.modules())
        want_step = {name: 0 for name in wrappers}
        want_step.update({
            "flash_attention_shortk": cross, "flash_attention_shortk_bwd": cross,
            "flash_attention_bshd": unet_attn, "flash_attention_bshd_dkv": unet_attn,
            "flash_attention_bshd_dq": unet_attn, "layer_norm": 2 * unet_ln})
        for i, (_, _, launches, _) in enumerate(step_log):
            if launches != want_step:
                raise AssertionError(f"trainer step {i + 1}: launches {launches} != {want_step}")
        print(f"launches every step {want_step}, as expected")

        # the frozen base against the file, tensor for tensor
        live = sdxl.state_dict()
        from_file = st.load_file(ckpt)
        changed = [k for k, v in from_file.items()
                   if not torch.equal(live[k].cpu(), v.to(live[k].dtype))]
        if changed:
            raise AssertionError(f"frozen tensors changed: {changed[:3]}")
        print(f"{len(from_file)} base tensors bit-identical to the checkpoint file")
        del from_file, live

        saved = sorted((work / "lora").glob("*.safetensors"))
        lora_state = st.load_file(saved[-1]) if saved else {}
        adapters = {k for k, _ in trainer.model.get_params().named_parameters()
                    if "lora_" in k} | {k for k, _ in trainer.model.get_params().named_buffers()
                                        if k.endswith(".alpha")}
        want_keys = {convert_to_comfy_key(k) for k in adapters}
        if len(saved) != 1 or set(lora_state) != want_keys or len(want_keys) != 3 * 10 * unet_attn:
            raise AssertionError(f"saved LoRA files {saved}: {len(lora_state)} keys, expected "
                                 f"{len(want_keys)}")
        ups = [v for k, v in lora_state.items() if k.endswith("lora_up.weight")]
        if not any(bool(u.float().abs().max() > 0) for u in ups):
            raise AssertionError("the saved lora_up weights are all zero: nothing trained")
        print(f"saved {saved[-1].name}: {len(lora_state)} keys (lora_down, lora_up, alpha of "
              f"{len(lora_state) // 3} Linears, ComfyUI names), lora_up moved off zero")

        previews = sorted((work / "preview").glob("*"))
        if len(previews) != 1 or Image.open(previews[0]).size != (1024, 1024):
            raise AssertionError(f"preview images {previews}")
        print(f"preview {previews[0].name}: {Image.open(previews[0]).size}")

        # one more step of the last batch with nothing kept by the checkpoints
        *_, last_batch = step_log[-1]
        set_remat_saves("none")
        try:
            trainer.state, _ = trainer._step(
                trainer.state, last_batch, torch.Generator(device=device).manual_seed(5))
        finally:
            set_remat_saves("kernel")
        none_launches = step_log[-1][2]
        want_none = {**want_step, "flash_attention_shortk": 2 * cross,
                     "flash_attention_bshd": 2 * unet_attn}
        print(f"a step with remat saves none: launches {none_launches}, expected {want_none}")
        if none_launches != want_none:
            raise AssertionError(f"trainer step (none): launches {none_launches} != {want_none}")

        # the same step's loss with the short-K kernels off (the plain formula)
        def step_loss():
            with torch.no_grad():
                loss, _ = trainer.model.loss_fn(last_batch, torch.Generator(device=device).manual_seed(6))
            return loss.item()

        on_loss = step_loss()
        set_flash_shortk(False)
        off_loss = step_loss()
        rel = abs(on_loss - off_loss) / abs(off_loss)
        print(f"one step's loss, short-K kernels on vs off: {on_loss:.6f} vs {off_loss:.6f} "
              f"(rel {rel:.3e}, tol {STEP_LOSS_TOL})")
        if rel > STEP_LOSS_TOL:
            raise AssertionError("the trainer's loss with the short-K kernels disagrees")
    finally:
        set_flash_shortk(False)
        shutil.rmtree(work, ignore_errors=True)
    del trainer, sdxl, unet
    gc.collect()
    torch.cuda.empty_cache()

    # the first child imports while phase 18 runs
    waiting = start_child(checkout, CHILDREN[0], options.profile)
    phase("18 kernels J, K, L: GroupNorm(+SiLU), 3x3 conv and the ragged-tile probe vs plain (bf16)")
    from vision_ft_tpu_torch.nn import Conv2d, GroupNorm

    def nchw(t):
        """(B, ..., C) -> (B, C, ...): the view PyTorch's NCHW ops take."""
        return t.movedim(-1, 1)

    errs, rows = [], []
    for shape, eps in GN_SHAPES:
        c = shape[-1]
        x = (torch.randn(shape, device=device, generator=gen) * 2 + 0.3).bfloat16()
        gamma = (1 + 0.2 * torch.randn(c, device=device, generator=gen)).bfloat16()
        beta = (0.2 * torch.randn(c, device=device, generator=gen)).bfloat16()
        for act in (None, "silu"):
            kernel = functools.partial(group_norm, x, gamma, beta, 32, eps, act)
            plain = functools.partial(group_norm_reference, x, gamma, beta, 32, eps, act)

            def library(act=act):
                y = F.group_norm(nchw(x), 32, gamma, beta, eps)
                return F.silu(y) if act else y

            before = group_norm.launches
            abs_err, rel_err = compare(f"group_norm {shape} {act}", kernel, plain, GN_TOL)
            if group_norm.launches != before + 1:
                raise AssertionError(f"group_norm {shape}: {group_norm.launches - before} "
                                     f"launches a call, not one")
            assert_reruns(f"group_norm {shape} {act}", kernel)
            ms = cuda_ms(kernel, iters=50)
            back_to_back_ms = burst_ms(kernel)
            plain_ms = cuda_ms(plain, iters=5)
            library_ms = cuda_ms(library, iters=50)
            library_burst_ms = burst_ms(library)
            nbytes = 2 * x.numel() * 2 + 2 * c * 2
            # sum and square (3), normalize and affine (4), SiLU (4): fp32
            bound_ms, bound_by = bound(nbytes, (11 if act else 7) * x.numel(), PEAK_FP32_FLOPS)
            plan = gn_plan(shape[0], x.numel() // (shape[0] * c), c, 32, 2,
                           torch.cuda.get_device_properties(device).multi_processor_count)
            print(f"{shape} eps {eps} {act or 'no act'} ({plan.blocks} blocks of "
                  f"{plan.rows} rows): max abs err {abs_err:.3e} rel {rel_err:.3e} (tol "
                  f"{GN_TOL}), one launch a call, reruns bit-identical; kernel J {ms:.4f} ms "
                  f"({nbytes / ms / 1e6:.0f} GB/s, {100 * bound_ms / ms:.1f}% of the bound; "
                  f"{back_to_back_ms:.4f} ms a call over 10 back to back, "
                  f"{100 * bound_ms / back_to_back_ms:.1f}%), plain {plain_ms:.4f} ms, "
                  f"F.group_norm{' + F.silu' if act else ''} {library_ms:.4f} ms "
                  f"({library_burst_ms:.4f} back to back), bound {bound_ms:.5f} ms ({bound_by})")
            errs.append(abs_err)
            rows.append(dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                             library_ms=library_ms))
    del x
    # the record: the UNet's GroupNorm + SiLU at the request's first stage
    records["group_norm"] = dict(
        route="cuda", source="vision_ft_tpu_torch/csrc/group_norm.cu",
        replaces="vision_ft_tpu/ops/pallas/group_norm.py:33", max_abs_err=max(errs), **rows[1])

    # dx, dgamma, dbeta through the autograd.Function against autograd of the plain forward
    x = (torch.randn(RESNET_SHAPE, device=device, generator=gen) * 2 + 0.3).bfloat16()
    dy = torch.randn(RESNET_SHAPE, device=device, generator=gen).bfloat16()
    gamma = (1 + 0.2 * torch.randn(x.shape[-1], device=device, generator=gen)).bfloat16()
    beta = (0.2 * torch.randn(x.shape[-1], device=device, generator=gen)).bfloat16()

    def gn_grads(fn):
        leaves = [t.detach().requires_grad_() for t in (x, gamma, beta)]
        return torch.autograd.grad(fn(*leaves, 32, 1e-5, "silu"), leaves, dy)

    want = gn_grads(group_norm_reference)
    got = gn_grads(group_norm)
    gn_grad_err = {n: compare(f"group_norm gradient {n}", lambda: g_, lambda: w_, GN_GRAD_TOL)
                   for n, g_, w_ in zip(("dx", "dgamma", "dbeta"), got, want)}
    print(f"{RESNET_SHAPE} silu, through the autograd.Function vs autograd of the plain forward: "
          + ", ".join(f"{n} {a:.3e} rel {r:.3e}" for n, (a, r) in gn_grad_err.items())
          + f" (tol {GN_GRAD_TOL})")

    errs, rows = [], []
    for shape, co in CONV_SHAPES:
        c = shape[-1]
        x = torch.randn(shape, device=device, generator=gen).bfloat16()
        w = (torch.randn(co, c, 3, 3, device=device, generator=gen) / (3 * c**0.5)).bfloat16()
        packed = repack_weight(w, torch.bfloat16)
        x_cl, w_cl = nchw(x), w.contiguous(memory_format=torch.channels_last)
        abs_err, rel_err = compare(f"conv3x3 {shape} -> {co}", lambda: conv3x3(x, w),
                                   lambda: conv3x3_reference(x, w), CONV_TOL)
        assert_reruns(f"conv3x3 {shape} -> {co}", lambda: conv3x3(x, w))
        ms = cuda_ms(lambda: conv3x3_forward(x, packed))
        back_to_back_ms = burst_ms(lambda: conv3x3_forward(x, packed))
        repack_ms = cuda_ms(lambda: repack_weight(w, torch.bfloat16))
        plain_ms = cuda_ms(lambda: conv3x3_reference(x, w), iters=5)
        library_ms = cuda_ms(lambda: F.conv2d(x_cl, w_cl, padding=1))
        library_burst_ms = burst_ms(lambda: F.conv2d(x_cl, w_cl, padding=1))
        flops = 2 * x.numel() // c * co * 9 * c
        nbytes = (x.numel() + w.numel() + x.numel() // c * co) * 2
        bound_ms, bound_by = bound(nbytes, flops)
        box_w, tile_n, splits = conv_plan(
            shape, co, torch.cuda.get_device_properties(device).multi_processor_count)
        print(f"{shape} -> {co} ({box_w} x {128 // box_w} pixel boxes, {tile_n}-channel tiles, "
              f"K in {splits} part{'s' if splits > 1 else ''}): max abs err {abs_err:.3e} rel "
              f"{rel_err:.3e} (tol {CONV_TOL}), reruns bit-identical; kernel K {ms:.4f} ms "
              f"({flops / ms / 1e9:.1f} TFLOP/s, {100 * bound_ms / ms:.1f}% of the bound; "
              f"{back_to_back_ms:.4f} ms a call over 10 back to back) + weight repack "
              f"{repack_ms:.4f} ms, plain {plain_ms:.4f} ms, cuDNN (channels-last bf16) "
              f"{library_ms:.4f} ms ({flops / library_ms / 1e9:.1f} TFLOP/s; kernel "
              f"{ms / library_ms:.2f}x; {library_burst_ms:.4f} ms back to back), bound "
              f"{bound_ms:.4f} ms ({bound_by}, {flops / 1e9:.1f} GFLOP)")
        errs.append(abs_err)
        rows.append(dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                         library_ms=library_ms))
    del x, w, packed, x_cl, w_cl
    records["conv3x3"] = dict(
        route="cuda", source="vision_ft_tpu_torch/csrc/conv3x3.cu",
        replaces="vision_ft_tpu/ops/pallas/conv3x3.py:31", max_abs_err=max(errs), **rows[1])

    # dx and dw through the autograd.Function against autograd of F.conv2d
    c = RESNET_SHAPE[-1]
    x = torch.randn(RESNET_SHAPE, device=device, generator=gen).bfloat16()
    w = (torch.randn(c, c, 3, 3, device=device, generator=gen) / (3 * c**0.5)).bfloat16()

    def conv_grads(fn):
        leaves = [t.detach().requires_grad_() for t in (x, w)]
        return torch.autograd.grad(fn(*leaves), leaves, dy)

    got = conv_grads(conv3x3)
    want = conv_grads(lambda x_, w_: F.conv2d(nchw(x_), w_, padding=1).movedim(1, -1))
    conv_grad_err = {n: compare(f"conv3x3 gradient {n}", lambda: g_, lambda: w_, CONV_GRAD_TOL)
                     for n, g_, w_ in zip(("dx", "dw"), got, want)}
    print(f"{RESNET_SHAPE} -> {c}, through the autograd.Function vs autograd of F.conv2d: "
          + ", ".join(f"{n} {a:.3e} rel {r:.3e}" for n, (a, r) in conv_grad_err.items())
          + f" (tol {CONV_GRAD_TOL})")
    del got, want

    # one SDXL resnet body, GN + SiLU -> conv -> GN + SiLU -> conv + residual, forward and
    # backward, through the ops and through nn.core's modules with the same weights
    core = torch.nn.ModuleList([GroupNorm(32, c), Conv2d(c, c, 3, padding=1, bias=False),
                                GroupNorm(32, c), Conv2d(c, c, 3, padding=1, bias=False)])
    core = core.to(device=device, dtype=torch.bfloat16)
    with torch.no_grad():
        for i, module in enumerate(core):
            if isinstance(module, GroupNorm):
                module.weight.copy_(1 + 0.2 * torch.randn(c, device=device, generator=gen))
                module.bias.copy_(0.2 * torch.randn(c, device=device, generator=gen))
            else:
                module.weight.copy_(torch.randn(c, c, 3, 3, device=device, generator=gen)
                                    / (3 * c**0.5))
    gn1, conv1, gn2, conv2 = core
    x_leaf = x.detach().requires_grad_()

    def ops_body():
        h = group_norm(x_leaf, gn1.weight, gn1.bias, 32, gn1.eps, "silu")
        h = group_norm(conv3x3(h, conv1.weight), gn2.weight, gn2.bias, 32, gn2.eps, "silu")
        return x_leaf + conv3x3(h, conv2.weight)

    def core_body():
        return x_leaf + conv2(F.silu(gn2(conv1(F.silu(gn1(x_leaf))))))

    leaves = [x_leaf, *core.parameters()]

    def fwd_bwd(body):
        out = body()
        return (out.detach(), *torch.autograd.grad(out, leaves, dy))

    # the phase's path, counted: the body through the ops, forward and backward, then the
    # probe's cases in this process
    reset_launches()
    ops_out = fwd_bwd(ops_body)
    in_process = probe.run("cuda")
    torch.cuda.synchronize()
    ops_launches = read_launches()
    want = {name: 0 for name in wrappers}
    want.update({"group_norm": 2, "conv3x3": 2, "partial_block_copy": 3,
                 "partial_block_lastaxis": 1, "partial_block_tma": 1})
    print(f"the ops' path: launches {ops_launches}, expected {want}")
    if ops_launches != want or not in_process["partial_blocks"]:
        raise AssertionError(f"the ops' path: launches {ops_launches} != {want}, "
                             f"or the probe failed in process: {in_process}")
    names = ("out", "dx", "gn1.weight", "gn1.bias", "conv1.weight", "gn2.weight", "gn2.bias",
             "conv2.weight")

    def body_errors(label, got, want):
        return [compare(f"resnet body {label} {n}", lambda: a, lambda: b_,
                        RESNET_TOL if n == "out" else RESNET_GRAD_TOL)
                for n, a, b_ in zip(names, got, want)]

    # the same path on the kernels' plain versions: no launch, the same values
    with plain_versions():
        plain_out = fwd_bwd(ops_body)
        plain_probe = probe.run("cuda")
    torch.cuda.synchronize()
    if read_launches() != ops_launches or not plain_probe["partial_blocks"]:
        raise AssertionError(f"the plain path launched a kernel, or its probe failed: {plain_probe}")
    plain_err = body_errors("kernels vs plain", ops_out, plain_out)
    print(f"the same path on the plain versions: no launch, the probe's cases pass; resnet body "
          f"output rel {plain_err[0][1]:.3e} (tol {RESNET_TOL}), gradients rel up to "
          f"{max(r for _, r in plain_err[1:]):.3e} (tol {RESNET_GRAD_TOL})")
    core_out = fwd_bwd(core_body)
    body_err = body_errors("ops vs nn.core", ops_out, core_out)
    del ops_out, core_out, plain_out
    with torch.no_grad():
        ops_fwd_ms, core_fwd_ms = cuda_ms(ops_body), cuda_ms(core_body)
    ops_ms, core_ms = (cuda_ms(lambda: fwd_bwd(b), iters=10) for b in (ops_body, core_body))
    print(f"resnet body {RESNET_SHAPE}, ops vs nn.core (GroupNorm + F.silu + Conv2d): output rel "
          f"{body_err[0][1]:.3e} (tol {RESNET_TOL}), gradients rel up to "
          f"{max(r for _, r in body_err[1:]):.3e} (tol {RESNET_GRAD_TOL}); forward "
          f"{ops_fwd_ms:.3f} vs {core_fwd_ms:.3f} ms, forward + backward {ops_ms:.3f} vs "
          f"{core_ms:.3f} ms (measured only: nothing is wired in)")
    del core, leaves, x_leaf, x, w, dy

    # kernels H, J and K traced over 10 calls in phase 3's process of their own (each
    # checked there for one launch a call): the card's time a call by kernel beside the
    # CUDA-event times above, which count the host's launches too
    for label, trace in traces.items():
        if (label.startswith(("kernel A", "F.layer_norm", "kernel L", "kernel I", "SDPA backward"))
                or " beside kernel L" in label):
            continue  # printed with their kernels' times
        kinds, only = trace["kinds"], trace["kernel"]
        print(f"{label}, 10 calls traced in a fresh process, device time by kind "
              f"(torch.profiler): "
              + ", ".join(f"{kind} {ms / n:.4f} ms a launch in {n}"
                          for kind, (ms, n) in sorted(kinds.items()))
              + f"; {sum(ms for ms, _ in kinds.values()) / 10:.4f} ms a call in all"
              + (f"; counted launches {trace['counted']}" if only else ""))

    # kernel L: the probe tool as a user runs it, in its own process
    proc = subprocess.run([sys.executable, "-m", "vision_ft_tpu_torch.tools.partial_block_probe"],
                          cwd=checkout, capture_output=True, text=True, timeout=600)
    print(f"python -m vision_ft_tpu_torch.tools.partial_block_probe (exit {proc.returncode}): "
          f"{proc.stdout.strip()}")
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines or not json.loads(lines[-1])["partial_blocks"]:
        raise AssertionError(f"the probe did not pass: {proc.stderr[-2000:]}")

    # kernel L's three timed cases: exact, nothing past S, reruns bit-identical, then timed
    # as kernel A is in phase 3
    for name, (x, out, _, call, plain_call, library, library_call) in probe_cases(device, gen).items():
        assert_reruns(f"kernel L {name}", call)
        want = x * 2 + 1 if name == "last axis" else x
        got = out.view(-1)[: x.numel()].view(x.shape)
        err = (got.float() - want.float()).abs().max().item()
        if err > (1e-6 if name == "last axis" else 0) or not (
                out.view(-1)[x.numel():] == probe.SENTINEL).all():
            raise AssertionError(f"kernel L {name}: max abs err {err}, or a write past S")
        kernel = call_costs(call)
        library_costs = call_costs(library_call)
        if name == "last axis" and not torch.equal(got, x * 2 + 1):
            raise AssertionError("torch.add(1, x, alpha=2) does not give x * 2 + 1")
        plain_ms = cuda_ms(plain_call, iters=20)
        if name == "last axis":
            bound_ms, bound_by = bound(2 * x.numel() * 4, 2 * x.numel(), PEAK_FP32_FLOPS)
        else:
            bound_ms, bound_by = bound(2 * x.numel() * 2, 0)
        traced = (traced_ms(traces, f"kernel L {name}"),
                  traced_ms(traces, f"{library} beside kernel L {name}"))
        print(f"kernel L {name} {tuple(x.shape)} {str(x.dtype)[6:]}: max abs err {err:.3e}, nothing "
              f"past S, reruns bit-identical; kernel {kernel['ms']:.4f} ms one call, "
              f"{kernel['burst_ms']:.4f} a call over 10 back to back, {traced[0]:.5f} traced on the "
              f"card ({100 * bound_ms / traced[0]:.1f}% of the bound), host {kernel['host_us']:.1f} "
              f"us a call; plain {plain_ms:.4f} ms; {library} {library_costs['ms']:.4f} ms one call "
              f"(kernel {kernel['ms'] / library_costs['ms']:.2f}x), {library_costs['burst_ms']:.4f} "
              f"back to back, {traced[1]:.5f} traced, host {library_costs['host_us']:.1f} us; bound "
              f"{bound_ms:.6f} ms ({bound_by})")
        records[{"copy": "partial_block_copy", "TMA": "partial_block_tma",
                 "last axis": "partial_block_lastaxis"}[name]] = dict(
            route="cuda", source="vision_ft_tpu_torch/csrc/partial_block_probe.cu",
            replaces=f"tools/bench/partial_block_probe.py:{31 if name == 'last axis' else 25}",
            max_abs_err=err, ms=kernel["ms"], plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, library_ms=library_costs["ms"], burst_ms=kernel["burst_ms"],
            host_us=kernel["host_us"], traced_ms=traced[0],
            library_burst_ms=library_costs["burst_ms"], library_host_us=library_costs["host_us"],
            library_traced_ms=traced[1])
    del x, out, got, want

    # the children share the card with this process: it keeps only what is still referenced
    gc.collect()
    torch.cuda.empty_cache()
    print(f"this process holds {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
          f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved while its children run")

    # each child in its turn, the next one importing while it runs
    results = {}
    for turn, (phases, flag, key, what, _) in enumerate(CHILDREN):
        phase(f"{phases} {what} (a process of its own)")
        child = waiting
        if turn + 1 < len(CHILDREN):
            waiting = start_child(checkout, CHILDREN[turn + 1], options.profile)
        results[key] = child.result(key)
        card_numbers = ", ".join(f"{k} {v}" for k, v in results[key]["numbers"].items())
        print(f"phase{'s' if '-' in phases else ''} {phases} on {card}: {card_numbers}")
    (lumina_trainer, auraflow, auraflow_trainer, serve, flux, cogview4, wan, adapters, remainder,
     fractal) = (results[key] for _, _, key, _, _ in CHILDREN)

    kernels = []
    for name, record in records.items():
        launches = {"generate": generate_launches[name], "train": train_launches[name],
                    "nf4_train": nf4_train_launches[name], "nf4_generate": nf4_generate_launches[name],
                    "lumina2_generate": lumina_launches[name],
                    "lumina2_train": lumina_train_launches[name],
                    "sdxl_shortk_generate": route_launches["flash_attention_shortk"][name],
                    "sdxl_fused_ff_generate": route_launches["gated_mlp"][name],
                    "trainer": trainer_launches[name],
                    "lumina2_trainer": lumina_trainer["launches"][name],
                    "ops_resnet_body_and_probe": ops_launches[name],
                    "auraflow_generate": auraflow["launches"][name],
                    "auraflow_trainer": auraflow_trainer["launches"][name],
                    "serve": serve["launches"][name],
                    "flux": flux["launches"][name],
                    "cogview4": cogview4["launches"][name],
                    "wan": wan["launches"][name],
                    "sdxl_adapters": adapters["launches"][name],
                    **{path: adapters["groups"][path][name] for path in CONTEXT_ADAPTER_PATHS},
                    **{path: remainder["launches"][path][name] for path in REMAINDER_PATHS},
                    "fractal": fractal["launches"][name]}
        kernels.append({
            "name": name,
            **{k: record[k] for k in ("route", "source", "replaces")},
            "launches": sum(launches.values()), "launches_by_path": launches,
            **{k: record[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                      "library_ms")},
            **{k: record[k] for k in ("parts", *COST_KEYS) if k in record},
            **({"auraflow_shapes": auraflow["records"][name]} if name in auraflow["records"] else {}),
            **({"auraflow_train_shapes": auraflow_trainer["records"][name]}
               if name in auraflow_trainer["records"] else {}),
            **({"serve_shapes": serve["records"][name]} if name in serve["records"] else {}),
            **({"flux_shapes": flux["records"][name]} if name in flux["records"] else {}),
            **({"cogview4_shapes": cogview4["records"][name]} if name in cogview4["records"]
               else {}),
            **({"wan_shapes": wan["records"][name]} if name in wan["records"] else {}),
            **({"sdxl_adapters_shapes": adapters["records"][name]} if name in adapters["records"]
               else {}),
            **({"fractal_shapes": fractal["records"][name]} if name in fractal["records"] else {}),
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
