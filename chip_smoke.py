#!/usr/bin/env python3
"""Drives the PyTorch port (``src/repro_torch``) on one CUDA card and checks it.

    python3 chip_smoke.py

Phases, each on its own lines; any failure exits non-zero and prints no
result line:

1. device: the card's name and power limit (``nvidia-smi``), its torch name
   and the device count;
2. build: every CUDA kernel of the serving and training paths, from
   ``src/repro_torch/csrc`` (one ``nvcc`` per source, all started together),
   with ptxas's registers, shared memory, spills and wgmma serialisation
   warnings for each kernel; the warp-specialised wgmma kernels (attention
   forward, the attention backward's dk/dv and dq, the grouped matmul and
   its backward's dx and dw) must report the 168 registers their setmaxnreg
   split (240 x 256 + 24 x 128) is sized for (the forward's lse store
   included; the attention backward's at head dim 256 too, whose consumers
   split D and keep the same split, and head dim 80's own forward and dk/dv
   kernels, which compute at the true width of 80; the latter's producer
   keeps 56 registers for the writers of dQ and its consumers 224), and the
   skinny grouped matmul, the
   Mamba scan, every attention backward kernel (at head dims 64, 80, 128 and
   256 on both tilings and 32 on fma, and the sums of the head dim 256
   partials), the fma forward at every head dim, the
   grouped matmul's backward (4 wgmma kernels, 6 fma ones), the Mamba scan's
   backward (12 kernels, 3 dtypes x 4 lane counts, and 3 sums of partials),
   the RG-LRU scan's backward (a chunk and a fix-up pass for each of 3
   dtypes, and the carry pass), the embedding bag's 12 forward kernels and
   its backward (the small tiling's 6 kernels, the sorted tiling's 12 and
   the keys kernel's 4) must not spill;
3. kernels vs their plain PyTorch versions at the serving shapes, with times
   beside the bound and beside one PyTorch library call where one computes
   the same function (SDPA for attention, a window shorter than the keys as
   a boolean mask), each case printing the tiling that served it (wgmma
   for bf16/fp16, fma for fp32, skinny for C <= 16), and the bf16 serving
   shapes also timed on the fma tiling: flash attention at granite-8b's and
   qwen3-moe-30b-a3b's attention (B=4, H=32, KV=8 or 4, D=128; S=1000 and
   2048) and at recurrentgemma-9b's (B=4, H=16, KV=1, S=2048, D=256, window
   2048), in bf16, fp16 and fp32, at hubert-xlarge's (B=4, H=KV=16, S=1000,
   D=80, both ways; its own wgmma kernel at the true width, its time's ratio
   to SDPA's printed) and at llama-3.2-vision-11b's
   cross-attention (H=32, KV=8, Sq=1000, Sk=1601, D=128, unmasked), and at
   ragged edges of the 128-row q and 64-row k tiles (Sq = Sk = 127, 129;
   Sq != Sk; D = 128 and 80), and with rows that see no key (Sq 256, Sk 200,
   window 16) on both tilings; the grouped matmul at
   qwen3-moe-30b-a3b's expert products (E=128; C=312 at prefill in bf16,
   fp16 and fp32, C=1 at decode with every expert filled, C=1280 at
   training in bf16, beside ``torch.bmm``) and around its
   128 x 256 tiles (C = 129; D = 72, F = 136), and on a decode step's own
   buffers (``layers.moe`` at 4 requests: most experts' rows zero), timed
   against a bound that counts only the live experts' weights, with the
   live experts printed; the grouped matmul's backward (dx and dw in one
   call) against its plain version at qwen3-moe-30b-a3b's training products
   (E=128, C=1280: gate/up D=2048 F=768 and down D=768 F=2048) in bf16,
   fp16 and fp32 (the fma tiling), ragged (C=129, D=72, F=136) and at C=1,
   two launches equal to the bit, each case printing its tiling and its
   time (dx and dw apart too) beside the bound, the plain version and
   ``torch.bmm`` for the same dx and dw; the Mamba selective scan at
   falcon-mamba-7b's prefill (B=4, L=1000, DI=8192, ST=16) and the RG-LRU
   scan at recurrentgemma-9b's (B=4, L=2048, D=4096), each also at a ragged
   shape; the Mamba scan's training path at falcon-mamba-7b's training
   shape (B=4, L=4096, DI=8192, ST=16, b and c strided) in bf16 and fp32,
   ragged (L=1001, DI=200), at ST=64 and 128 and with a gradient for the
   final state: the forward with checkpoints (its y and h bitwise the
   serving call's, its checkpoints within 1e-4 of the plain forward's), then
   the backward on them against its plain version, two launches equal to
   the bit, each output within 1e-4 of its max|.| (bf16 outputs plus one
   rounding on each side), its time beside the bound and the plain
   version's, and at the training shapes the forward's time without and
   with checkpoints and a remat step's two forwards and one backward; the
   RG-LRU scan's backward against its plain version at recurrentgemma-9b's
   training shape (B=1, L=4096, D=4096, fp32 as the layer passes it), with
   a gradient for the final state, with bf16 a, and ragged (B=3, L=1000,
   D=200): two launches equal to the bit, da and db within 1e-4 of their
   max|.| (bf16 plus one rounding), its time beside the bound and the plain
   version's, and the forward at B=1 and a remat step's two forwards and
   one backward; and the embedding bag on the paper DLRM's tables (T=8, R=1e7,
   E=128, fp32: 40.96 GB) at its serving lookup (B=128, one id a bag), at
   B=4096 (int32 and int64 ids), at a multi-hot shape (B=4096, 32 ids a
   bag), at B=4095 over 7 tables (a last unit of one bag), with bf16 tables
   (serving, B=4096, multi-hot), ids near the end of every table (offsets
   past 2^31) and ids past it (clamped and wrapped), and on ragged tables
   (E=13, int64 ids), each case bitwise the sum in j's order and printing
   its tiling and its share of the bound, with each case's device time and
   ``F.embedding_bag``'s from ``torch.profiler`` beside their CUDA-event
   times; the embedding bag's backward against its plain version
   on the DLRM training run's tables (T=2, R=1e7, E=128, fp32: 10.24 GB of
   gradient) at the training batch (B=128, one id a bag), at B=4096, at
   B=4096 with 32 ids a bag drawn from 4096 hot rows a table (long runs),
   in bf16, with ids near the end of table 1 (offsets past 2^31), with ids
   past the table and negative ids (their gradient dropped), and ragged
   (E=13, int64 ids), each on the tiling the wrapper picks (``small`` up to
   N_SMALL entries, ``sorted`` above): two launches equal to the bit, and
   where the small tiling serves the sorted one equal to it too; the
   kernel's and the wrapper's path's profiler device time without the zero
   fill (with the path's launches a call, and the other tiling's where both
   take the case) beside the bound, the wrapper's whole time, the fill
   apart, the plain version and ``index_add_`` (CUDA events and the
   profiler); one model rank's share on the production mesh's model axis of
   16 (``jit_train_step``'s split compute; TP16_ATTN_CASES, E_TP16, DI_TP16,
   D_RG_TP16), each kernel forward and backward against its plain version
   and timed beside its bound and its full-width row: qwen3-moe-30b-a3b's
   attention (B=4, 2 query heads over 1 KV head, S=4096, D=128, causal) and
   its grouped matmul at 8 of 128 experts (C=1280, gate/up and down),
   falcon-mamba-7b's scan at 512 of 8192 channels (B=4, L=4096), and
   recurrentgemma-9b's RG-LRU scan at 256 of 4096 channels (B=1, L=4096) and
   its attention (1 query head, 1 KV head, D=256, window 2048); then
   narrow fp32 granite, MoE, Mamba, Griffin and DLRM models on the card
   against the same models on the CPU, and a narrow fp32 VLM (head dim 128,
   two super-blocks, cross gates opened) and encoder (4 heads of 80); the
   narrow DLRM's train step (ids past the table among them: both bag
   kernels) against the CPU's, loss and every gradient within 1e-5 of each
   leaf's max and the parameters after one AdamW step within 1e-4; the
   attention backward and the forward's lse against autograd of the plain
   version (fp32) at minicpm-2b's training shape (B=4, H=KV=36, S=4096,
   D=64, causal, bf16), granite-8b's (H=32, KV=8, S=2048, D=128), in fp32
   on the fma forward and at a ragged non-causal shape, recurrentgemma-9b's
   (B=1, H=16, KV=1, S=4096, D=256, window 2048) and an fp32 one at D=256
   (S=600, window 256), hubert-xlarge's (B=4, H=KV=16, S=4096, D=80,
   unmasked), D=80 at ragged shapes (causal GQA at S=1000; Sq=1000 against
   Sk=777) and in fp32 on the fma tiling, and llama-3.2-vision-11b's cross
   layer (B=4, H=32, KV=8, 4096 text tokens against 1601 image tokens,
   D=128, unmasked), bf16 inputs on both backward tilings (wgmma and
   fma), two launches equal to the bit, timed beside SDPA's backward (with
   a window, the window as a boolean mask; the backend that served it
   printed) and the bound, and at the three unmasked or causal training
   shapes of phases 5, 5f and 5g the plain forward and SDPA's forward
   beside the forward kernel; and a narrow fp32 train step (head dim 64, 2
   layers, MHA and GQA) on the card against the CPU: loss, every gradient,
   AdamW's arithmetic and the parameters after one SGD step; and a narrow
   fp32 qwen3-moe train step (its smoke widths at head dim 64, 2 layers; C
   above 16) at its dropless capacity and at capacity 1.0 (entries drop),
   card against CPU: the grouped matmul's forward and backward kernels and
   the attention kernels, the loss and every gradient (the router's
   included) within 1e-5 of each leaf's max, the parameters after one AdamW
   step within 1e-4; and a narrow fp32 Mamba train step (falcon-mamba-7b's
   smoke widths at d_model 256, ssm_state 16, 2 layers, 2 x 77 tokens)
   card against CPU: both scan kernels (2 forward and 1 backward launch a
   layer), the loss and every gradient (a_log and d_skip included) within
   1e-4 of each leaf's max, the parameters after one AdamW step within 1e-4
   where the gradient settles the update; and a narrow fp32 hybrid train step
   (recurrentgemma-9b's smoke widths at d_model 256, 5 layers, 2 heads of
   256 over one kv head, window 32, 2 x 77 tokens) card against CPU: 8
   forward and 4 backward RG-LRU launches, 2 forward and 1 backward fma
   attention launches, the loss and every gradient within 1e-4, and the
   parameters after one SGD step within 1e-4; and narrow fp32 train steps
   of the VLM (head dim 128, 10 layers of which 2 cross layers over 100
   image tokens, the gates at 0.5: 18 forward and 10 backward fma attention
   launches) and the encoder (4 heads of 80, 2 layers) held the same way;
   then (``3 dims``) attention at head dims no served model has (16, 24,
   32, 48, 96, 112, 192, 200), computed at a wider width (wgmma at 64, 128
   or 256 with TMA's zeros past D; fma on its ragged instances): forward,
   lse and backward of the wgmma and fma tilings on bf16 inputs and of fma
   on fp32 ones, against the plain version at ragged Sq and Sk (two
   launches equal to the bit), and each D timed at B=4, H=32, KV=8,
   S=2048, causal, bf16, on both tilings beside its bound and SDPA's
   forward and backward;
4. serve granite-8b at full width and depth in bf16 through
   ``repro_torch.launch.serve.generate`` (4 requests, prompt 1000, 16 decode
   steps), counting kernel launches (every prefill attention on the wgmma
   tiling), and hold its prefill against prefill-then-decode, which attends
   in plain PyTorch;
4b. serve qwen3-moe-30b-a3b the same way at full width and depth (30.5 B
   parameters in bf16), counting both kernels' launches in the prefill and
   in the decode loop (prefill attention and grouped matmuls on the wgmma
   tiling, decode grouped matmuls on the skinny one), then hold its first
   MoE layer on the card in bf16
   against the same layer on the CPU in fp32;
4c. serve falcon-mamba-7b the same way (64 Mamba layers, a selective-scan
   launch in each at prefill, plain steps at decode), and hold its prefill
   against prefill(S-1) plus a decode step;
4d. serve recurrentgemma-9b the same way at a 2048-token prompt, its
   attention window (26 RG-LRU scans and 12 flash-attention launches per
   prefill), and hold prefill(2049) against prefill(2048) plus a decode
   step on the ring-buffer cache;
4e. score the paper's DLRM (``models.dlrm.paper_config(8)``: 8 tables of
   1e7 x 128 fp32, a bottom MLP of 8 x 2048, a top MLP of 16 x 4096) at
   batches 128 and 4096, one embedding-bag launch per forward, and hold its
   logits against a forward whose lookup is the plain version (bitwise) and
   against 16 samples recomputed on the CPU;
4f. serve llama-3.2-vision-11b the same way (1601 image tokens drawn with
   numpy; its 8 cross gates set to 1 first, since tanh(0) = 0 at init
   throws the cross-attention away): 32 self and 8 cross flash-attention
   launches per prefill, all wgmma, none in decode, and prefill(1001)
   against prefill(1000) plus a decode step whose cross-attention is plain;
4g. encode 4 clips of 1000 frames with hubert-xlarge (48 flash-attention
   launches at D = 80 per forward, all wgmma), timing the forward, and hold
   its first layer (bf16, card) against the same layer in fp32 on the CPU;
4h. serve deepseek-coder-33b the same way at full width and depth (62
   layers, about 66.7 GB of bf16 weights drawn on the card a layer at a
   time; 62 wgmma attention launches a prefill), and hold prefill(1001)
   against prefill(1000) plus a decode step;
5. train: a narrow fp32 run through ``train.loop.train`` that fails at step
   4 and resumes from its checkpoint, against an uninterrupted one; then
   minicpm-2b at full width and depth (bf16, fp32 AdamW state, WSD, remat
   "full", loss chunk 1024) for 8 steps of ``batch_for_step`` at 4 x 4096,
   each with 80 forward and 40 backward attention launches, all on the
   wgmma tilings, and no other kernel, with its step time, tokens/s, model
   FLOPs share and peak memory, then 6 steps on one fixed batch, whose loss
   must fall;
5b. train the paper's DLRM (``models.dlrm.paper_config(2)``: 2 of its 64
   tables of 1e7 x 128, fp32, the paper's MLPs) through
   ``launch.dlrm_testbed.train_dlrm`` at batch 128, AdamW at 3e-3: 2
   warm-up and 8 timed steps (median, range, samples/s, peak memory), one
   forward and one backward bag launch a step and no other kernel, finite
   losses, every backward launch on the small tiling; then 10 steps on one
   fixed batch, whose loss must fall, and one
   step's device time under ``torch.profiler`` split into the tables'
   AdamW, the gradient's zero fill, the MLP GEMMs, the two bag kernels, the
   bag backward's bookkeeping (keys and sort; none on the small tiling the
   training batch takes) and the rest, with the idle share;
5c. train qwen3-moe-30b-a3b at full width, cut to 4 layers (bf16, fp32
   AdamW state, remat "full", loss chunk 1024) at 4 x 4096: 3 steps through
   ``train.loop.train``, each with the launches below; then, through
   ``train.steps.make_train_step``, 2 warm-up and 8
   timed steps (median, range, tokens/s, model FLOPs share, peak memory),
   each with 24 forward grouped-matmul launches and 12 backward calls, 8
   forward and 4 backward attention launches, all on the wgmma tilings, and
   no other kernel; then 6 steps on one fixed batch, whose loss must fall,
   and one step under ``torch.profiler`` split into the grouped matmul's
   forward and backward, attention forward and backward, cuBLAS GEMMs, the
   MoE's dispatch and combine (index, gather and scatter kernels), AdamW
   (traced apart) and the rest, with the idle share;
5d. train falcon-mamba-7b at full width, cut to 16 of its 64 layers (bf16,
   fp32 AdamW state, remat "full", the full CE as the reference takes it)
   at 4 x 4096 through ``train.steps.make_train_step``: 2 warm-up and 8
   timed steps (median, range, tokens/s, model FLOPs share, peak memory),
   each with 32 forward and 16 backward selective-scan launches and no
   other kernel; then 6 steps on one fixed batch, whose loss must fall, and
   one step under ``torch.profiler`` split into the scan's forward and
   backward, cuBLAS GEMMs, the loss head (the kernels of the operators that
   read a tensor of the logits' size or multiply by the head, in the same
   traced step), AdamW (traced apart) and the rest, with the idle share,
   and the phase's wall time;
5e. train recurrentgemma-9b at full width, cut to 5 of its 38 layers (one
   (rec, rec, attn) block and the (rec, rec) tail; bf16, fp32 AdamW state,
   cosine, remat "full", the full CE as the reference takes it) at 1 x 4096
   (past its 2048-token window) through ``train.steps.make_train_step``: 2
   warm-up and 8 timed steps (median, range, tokens/s, model FLOPs share,
   peak memory), each with 8 forward and 4 backward RG-LRU launches and 2
   forward and 1 backward attention launches on the wgmma tilings and no
   other kernel; then 6 steps on one fixed batch, whose loss must fall, and
   one step under ``torch.profiler`` split into the RG-LRU forward and
   backward, attention forward and backward, cuBLAS GEMMs, the loss head,
   AdamW (traced apart) and the rest, with the idle share; then the twin of
   ``examples/serve_decode.py`` on the card in a process of its own
   (``--arch falcon-mamba-7b``, the smoke config: no attention), which must
   exit 0 and print its tokens/s line;
5f. train llama-3.2-vision-11b at full width, cut to 10 of its 40 layers
   (two groups of 4 self layers and a cross layer; bf16, fp32 AdamW state,
   cosine, remat "full", loss chunk 1024) at 4 x 4096 with 1601-token
   images: 2 warm-up and 8 timed steps (median, range, tokens/s, the model
   FLOPs share with the cross layers' k and v over the image, peak memory),
   each with 18 forward attention launches (2 a self layer, 1 a cross
   layer, which is not rematerialized) and 10 backward, all on the wgmma
   tilings, 2 and 2 of them at the cross shape, and no other kernel; the
   cross gates start at 0, and the first cross layer's gate and wk must
   move; then 6 steps on one fixed batch, whose loss must fall, and one
   step under ``torch.profiler`` split into attention forward and backward,
   cuBLAS GEMMs, the loss head, AdamW (traced apart) and the rest;
5g. train hubert-xlarge whole (48 layers, bf16, fp32 AdamW state, cosine,
   remat "full", its CE over 504 classes) at 4 x 4096 frames the same way,
   each step with 96 forward and 48 backward attention launches at head dim
   80, all wgmma and unmasked, the first loss within 0.5 of ln 504;
6. plan: the planner (``repro_torch.core``) on the card at the paper's
   128-server scale (degree 4, 100 Gbps links), each result held against
   the same call on the CPU or against the NumPy oracles: (6a) pricing 256
   pool demands of the paper's jobs with ``TorchPlanEvaluator`` (within
   1e-9 of the NumPy evaluator, two calls bitwise equal; its device busy
   time, wall time and idle share, beside one ``index_put_(accumulate=True)``
   over the same stream, the design it is held against); (6b) the flat and
   grid chain programs at the fused admission's shape (V of 4 candidates x
   4 tenants x 64 strategies x 416 links, the ladder 0.05-0.4, 16 chains,
   200 iterations) index for index against ``run_chains_reference`` /
   ``run_grid_reference`` on their first 4 chains, energies at rtol 1e-12,
   two runs bitwise equal; (6c) ``alternating_optimize`` of DLRM through
   its defaults, which plan on the card (2 rounds, 200 iterations, 32
   chains, pool 64), with the plan of the same
   call on the CPU (strategy ``hybrid``, topology, ``iter_time`` to the
   bit), and CANDLE staying ``dp``; (6d) the fused four-tenant admission
   ``co_optimize_jobset`` over 4 placements (16 chains, the default ladder,
   2 rounds) with the CPU's plan.  It prints wall times beside the NumPy
   backend's, and the chain programs' device time, launches and idle share
   (``torch.profiler``); then the online planner (``repro_torch.core.online``),
   its policies at their defaults, which plan on the card: (6e) the admission
   an arriving job waits for, ``JobSetController.admit`` of VGG16 on 32
   servers beside DLRM (weight 2), BERT (32 servers each) and CANDLE (16)
   on the 128-server fabric, through 4 placement candidates and the fused
   co-search (the ladder, 16 chains, 2 rounds x 40 iterations): admitted on
   free servers, no plan violation, the plan's NumPy re-price equal to its
   ``iter_time``; its wall time split into the optimizer, the fluid probes
   (``SimEngine.run``), placement and the rest, and the optimizer call run
   again for the grid programs' device time, launches and idle share; (6f)
   replays, each on the card and then as the same call with
   ``device="cpu"``, equal to the bit (totals, iteration times, replans,
   failures, fibers moved, records, final placements, strategies and
   topology): ``run_online_jobset`` on the JAX package's churn trace
   (``benchmarks/bench_multitenant.py``) at 32 servers, static and reactive
   (the arrival through the fused admission), ``run_online`` of DLRM at 16
   on ``benchmarks/bench_online.py``'s FAILURES trace, reactive, and a
   seeded ``FaultModel`` storm (flapping fibers and server 1's domain) at
   16, reactive with a one-iteration hysteresis;
7a. the fma attention at head dim 32 in fp32 (the model of
   ``examples/train_lm_topoopt.py``), forward and backward against the
   plain version, at the twin's training shape (B=2, H=8, KV=4, S=128,
   causal), at S=2048 (B=4) and ragged (S=127; Sq=129 against Sk=100,
   unmasked): two launches equal to the bit, phase 3's bars, each time
   beside the bound and SDPA's;
7b. the twin of ``examples/train_lm_topoopt.py`` at world size 1 on the
   card: ``python -m repro_torch.launch.train_lm_topoopt --steps 60
   --ckpt-dir DIR`` in a process of its own, then ``--steps 80``, which
   resumes from step 50 (exit 0, finite losses, the last below the first,
   its ms a step printed); then its ``main`` here for 3 steps, counting 2
   forward and 1 backward fma attention launches a layer a step;
7c. the §6 trainer at full width: hubert-xlarge whole at 4 x 4096 (phase
   5g's shape), two steps of ``make_train_step`` and then two of
   ``make_shardmap_dp_train_step`` at world size 1 from the same seed and
   batches, once on the ring schedule and once with the int8
   ``Compressor``: losses and every parameter equal to the bit, each step's
   time beside phase 5g's;
7d. the GSPMD/FSDP trainer at full width: hubert-xlarge whole at 4 x 4096,
   ``jit_train_step`` under ``ShardingPlan(fsdp=True)`` on a (1, 1)
   ("data", "model") mesh over a one-rank NCCL group, the model drawn block
   by block into its layouts: two steps on 7c's batches, losses and every
   parameter equal to 7c's ``make_train_step`` run to the bit, 2 forward and
   1 backward wgmma attention launches a layer a step, each step's time
   beside 7c's; then a plain model beside it, the two steps timed in
   alternating turns, and one step of each under ``torch.profiler``: idle
   share, NCCL launches, and the host time of DTensor's autograd functions
   and of the collectives' operators; then ``python -m repro_torch.launch.train --arch
   hubert-xlarge --mesh cpu --seq-len 4096 --global-batch 4 --steps 3`` in a
   process of its own, exit 0;
7e. the GSPMD trainer on the MoE at 5c's depth and batch: qwen3-moe-30b-a3b
   at 4 layers, 4 x 4096, two steps of 5c's plain step and then two of
   ``jit_train_step`` under ``ShardingPlan(fsdp=True)`` on a (1, 1) mesh,
   from seed 0 on 5c's first batches under deterministic algorithms:
   losses and every parameter equal to the bit, 5c's launches each step,
   each step's time and each run's peak memory beside 5c's median;
7f. serving under a mesh at full width and depth, run inside phases 4
   and 4b on the models they served (no second copy: each weight is freed
   as its shard replaces it): granite-8b and qwen3-moe-30b-a3b placed on a
   (1, 1) ("data", "model") mesh over a one-rank NCCL group under
   ``ShardingPlan(fsdp=True)``, prefill padded to PROMPT + DECODE_STEPS and
   the greedy decode loop through ``train.steps.jit_serve_step``: logits,
   ids and launches equal to the phase's plain serve to the bit (the caches
   DTensors in the decode cell's layouts), prefill ms and decode ms/token
   beside the plain serve's;
8. the dry run (``launch.dryrun``), in processes of their own, since its
   ``"fake"`` process group cannot share a process with 7e's NCCL group:
   (a) ``dryrun_cell`` at a (1, 1) mesh on 7e's config, shape and plan, on
   ``meta`` tensors that stand for the card: its launches by kernel equal to
   7e's a step, its predicted peak within 10% of 7e's measured
   ``max_memory_allocated``, and its roofline step time (an estimate from
   the card's published peaks) beside 7e's measured step; (b) the CLI on
   qwen3-moe-30b-a3b train_4k and granite-8b decode_32k on the single pod,
   256 ranks, one summary line each;
9. the JAX package's smoke configs (``ArchConfig.smoke()``: head dim 16,
   bf16) on the card through the command lines a user runs, with no
   ``--device``: ``launch.serve --smoke`` for granite-8b, qwen3-moe-30b-a3b,
   recurrentgemma-9b and llama-3.2-vision-11b (prefill and 16 greedy
   tokens), hubert-xlarge's smoke forward (``models.lm.forward`` on
   frames: ``serve`` exits for an encoder) and ``launch.train --smoke
   --steps 20`` for minicpm-2b, qwen3-moe-30b-a3b and hubert-xlarge, the
   weights drawn on the CPU from the seed for both sides: each step's
   logits (the CPU fed the card's tokens) within 3e-2 of max|ref| of the
   CPU's plain path (the MoE's prefill layer by layer on the CPU's stream,
   as the repo holds bf16 MoE checks, on the tokens whose top-2 experts
   agree: the others must be near ties), the encoder's output likewise;
   each training step's loss finite and within 5e-3 of the CPU run's
   (relative), and the first step's gradient of every parameter within
   6e-2 of its largest (the CPU routing the MoE's tokens as the card
   did), with controls (attention's dq, and the MoE's dw, off by 20% on
   the card) that must fail that bar; every kernel launch
   of every run, the MoE's decode steps' skinny grouped matmuls among
   them, held to the plain version on its own inputs (TOL); the launches
   of every kernel each run makes, attention on wgmma at width 64;
10. the script's wall time, one JSON line of per-kernel numbers, the
   ``nvidia-smi`` line, and the result line ``{"ok": true, "device": {...}}``
   last.

Each serving phase, and each training run, sets every kernel's launch count
to 0 just before its run and reads the counts just after.  Times come from CUDA events (kernels)
or the host clock after a synchronise (serving).  Bounds use the H100 SXM's
published peaks at 700 W: 989 TFLOP/s bf16/fp16 dense, 67 TFLOP/s fp32
without tensor cores, 3.35 TB/s; exps run on the special-function units,
16 a clock on each SM beside the 128 fp32 lanes, so at 1/8 of 67e12 / 2.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import copy
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

T_START = time.perf_counter()

from repro_torch.launch.roofline import HBM_BW as PEAK_BYTES_PER_S  # noqa: E402
from repro_torch.launch.roofline import PEAK_FLOPS  # noqa: E402

SFU_EXP_PER_S = PEAK_FLOPS[torch.float32] / 2 / 128 * 16  # 4.19e12 exps/s
# bf16/fp16: tests/test_kernels.py's fp16 bar.  fp32: sums of up to 2048
# terms run in another order on the card than in the plain version.
TOL = {torch.bfloat16: 2e-2, torch.float16: 2e-2, torch.float32: 1e-4}
B, H, KV, D = 4, 32, 8, 128  # granite-8b's attention at the serving batch
PROMPT, DECODE_STEPS = 1000, 16
E_MOE, D_MOE, F_MOE = 128, 2048, 768  # qwen3-moe-30b-a3b's experts
C_PREFILL = int(1.25 * B * PROMPT * 8 / E_MOE)  # 312: capacity at the serving prefill
DI_MAMBA, ST_MAMBA, R_MAMBA = 8192, 16, 256  # falcon-mamba-7b's scan
PROMPT_RG, D_RG = 2048, 4096  # recurrentgemma-9b: prompt = attention window; LRU width
IMG_TOKENS = 1601  # llama-3.2-vision-11b's image: 1 CLS + 40 x 40 patches
H_AU, D_AU = 16, 80  # hubert-xlarge's heads (KV = H) and head dim
# Attention cases (Sq, Sk, D, dtype, causal, window, KV, H) of the new paths:
# hubert-xlarge's encoder at 1000 frames in bf16, fp16 and fp32, and
# llama-3.2-vision-11b's cross-attention from the prompt to the image.
HUBERT_CASES = tuple((PROMPT, PROMPT, D_AU, dt, False, 0, H_AU, H_AU)
                     for dt in (torch.bfloat16, torch.float16, torch.float32))
CROSS_CASE = (PROMPT, IMG_TOKENS, D, torch.bfloat16, False, 0, KV, H)
KERNEL_COUNTERS = ("attention_launches", "attention_bwd_launches", "grouped_matmul_launches",
                   "grouped_matmul_bwd_launches", "selective_scan_launches",
                   "selective_scan_bwd_launches", "lru_scan_launches", "lru_scan_bwd_launches",
                   "bag_lookup_launches", "bag_lookup_bwd_launches")
# The same launches again, by the tiling that served them.
TILING_COUNTERS = ("attention_wgmma_launches", "attention_fma_launches",
                   "attention_bwd_wgmma_launches", "attention_bwd_fma_launches",
                   "grouped_matmul_wgmma_launches", "grouped_matmul_fma_launches",
                   "grouped_matmul_skinny_launches", "grouped_matmul_bwd_wgmma_launches",
                   "grouped_matmul_bwd_fma_launches", "bag_lookup_bwd_small_launches",
                   "bag_lookup_bwd_sorted_launches")
COUNTERS = KERNEL_COUNTERS + TILING_COUNTERS
T_DLRM, R_DLRM, E_DLRM = 8, 10_000_000, 128  # the paper DLRM's tables, one host's 8 of 64
DLRM_BATCHES = (128, 4096)  # workloads.DLRM.batch_per_gpu, and a large scoring batch
DLRM_PATH = "dlrm-paper-8t"
# Training the paper's DLRM (phase 5b): 2 of its 64 tables (20.48 GB of fp32
# training state a table), the training batch (workloads.DLRM.batch_per_gpu)
# and the example's learning rate.
T_TRAIN_DLRM, DLRM_TRAIN_B, DLRM_TRAIN_LR = 2, 128, 3e-3
DLRM_TRAIN_PATH = "dlrm-paper-2t-train"
DLRM_WARMUP, DLRM_TIMED, DLRM_FIXED = 2, 8, 10
# Training (phase 5): minicpm-2b at full width and depth, TRAIN_4K's sequence
# and its global batch of 256 cut to 4 for one card; the chunked loss.
TRAIN_ARCH, TRAIN_B, TRAIN_S, LOSS_CHUNK = "minicpm-2b", 4, 4096, 1024
TRAIN_STEPS, FIXED_STEPS, TRAIN_LR = 8, 6, 3e-4
# Training the MoE (phase 5c): qwen3-moe-30b-a3b at full width, its 48 layers
# cut to 4 (49.8 GB of training state) and TRAIN_4K's global batch of 256 to
# 4; the capacity of its expert products at that batch.
MOE_TRAIN_ARCH, MOE_TRAIN_LAYERS, MOE_WARMUP = "qwen3-moe-30b-a3b", 4, 2
C_TRAIN = int(1.25 * TRAIN_B * TRAIN_S * 8 / E_MOE)  # 1280
# Training the ssm family (phase 5d): falcon-mamba-7b at full width, its 64
# layers cut to 16 (27 GB of training state, about 57 GB at the peak) and
# TRAIN_4K's global batch of 256 to 4.
SSM_TRAIN_ARCH, SSM_TRAIN_LAYERS, SSM_WARMUP = "falcon-mamba-7b", 16, 2
# Training the hybrid (phase 5e): recurrentgemma-9b at full width, its 38
# layers cut to 5 (one (rec, rec, attn) block and the (rec, rec) tail, the
# fewest that hold an attention layer: about 52 GB of training state) and
# TRAIN_4K's global batch of 256 to 1 (its full CE over 256,000 classes at
# 4 x 4096 would take about 75 GB); the 4096-token sequence stays past the
# 2048-token window.
HYB_TRAIN_ARCH, HYB_TRAIN_LAYERS, HYB_TRAIN_B, HYB_WARMUP = "recurrentgemma-9b", 5, 1, 2
# Training the vlm family (phase 5f): llama-3.2-vision-11b at full width, its
# 40 layers cut to 10 (two groups of 4 self layers and a cross layer: about
# 52 GB of training state, 17 GB of it the embedding and the head), and
# TRAIN_4K's global batch of 256 to 4 with its 1601-token images.  The audio
# family (phase 5g): hubert-xlarge whole (48 layers, about 15 GB of state).
VLM_TRAIN_ARCH, VLM_TRAIN_LAYERS, AU_TRAIN_ARCH = "llama-3.2-vision-11b", 10, "hubert-xlarge"
# The backward kernel's cases (B, H, KV, S, D, dtype, causal): minicpm-2b's
# and granite-8b's training attention (the first is the main path's), one
# fp32 case on the fma forward, and a ragged non-causal one.
BWD_CASES = (
    (TRAIN_B, 36, 36, TRAIN_S, 64, torch.bfloat16, True),
    (TRAIN_B, 32, 8, 2048, 128, torch.bfloat16, True),
    (TRAIN_B, 36, 36, 1024, 64, torch.float32, True),
    (TRAIN_B, 36, 36, 1000, 64, torch.bfloat16, False),
    # recurrentgemma-9b's training attention (B, H, KV, S, D, dtype, causal,
    # window): head dim 256, GQA 16:1, its window of 2048, bf16 (the main
    # path's); and fp32 on the fma tiling at a smaller shape, S past the window.
    (HYB_TRAIN_B, 16, 1, TRAIN_S, 256, torch.bfloat16, True, PROMPT_RG),
    (2, 8, 1, 600, 256, torch.float32, True, 256),
    # hubert-xlarge's training attention (bidirectional MHA at head dim 80,
    # bf16: phase 5g's), D = 80 at ragged edges (causal GQA at S = 1000;
    # Sq = 1000 against Sk = 777, the case's last entry), fp32 at D = 80 on
    # the fma tiling, and llama-3.2-vision-11b's training cross-attention
    # (4096 text tokens against its 1601 image tokens, unmasked: phase 5f's).
    (TRAIN_B, H_AU, H_AU, TRAIN_S, D_AU, torch.bfloat16, False),
    (2, H_AU, 4, 1000, D_AU, torch.bfloat16, True),
    (2, H_AU, H_AU, 1000, D_AU, torch.bfloat16, False, 0, 777),
    (2, H_AU, H_AU, 1000, D_AU, torch.float32, False),
    (TRAIN_B, H, KV, TRAIN_S, D, torch.bfloat16, False, 0, IMG_TOKENS),
)
# One model rank's share on the production mesh's model axis of 16
# (parallel.sharding.model_reads, the split compute of jit_train_step), each
# at its training phase's batch and length: qwen3-moe-30b-a3b's attention (2
# query heads over its 1 KV head) and 8 of its 128 experts (5c); falcon-
# mamba-7b's 512 of 8192 channels (5d); recurrentgemma-9b's 256 of 4096
# RG-LRU channels and its attention (1 query head, 1 KV head, window 2048;
# 5e).  Attention cases as BWD_CASES.
TP_PROD = 16
TP16_ATTN_CASES = (
    (TRAIN_B, 32 // TP_PROD, 1, TRAIN_S, D, torch.bfloat16, True),
    (HYB_TRAIN_B, 16 // TP_PROD, 1, TRAIN_S, 256, torch.bfloat16, True, PROMPT_RG),
)
E_TP16, DI_TP16, D_RG_TP16 = E_MOE // TP_PROD, DI_MAMBA // TP_PROD, D_RG // TP_PROD
# The training shapes whose forward also gets row 1's yardsticks (the plain
# forward and SDPA's): minicpm-2b's, hubert-xlarge's and the VLM's cross layer.
TRAIN_FWD_CASES = (BWD_CASES[0], BWD_CASES[6], BWD_CASES[10])
# Phase 7a: head dim 32 in fp32 on the fma tilings, both ways (the model of
# examples/train_lm_topoopt.py: 8 heads over 4 kv heads), as BWD_CASES: the
# twin's training shape (B=2, S=128, causal; the main path's), a larger one
# (B=4, S=2048), and ragged ones (S=127; Sq=129 against Sk=100, unmasked).
D32_CASES = (
    (2, 8, 4, 128, 32, torch.float32, True),
    (4, 8, 4, 2048, 32, torch.float32, True),
    (2, 8, 4, 127, 32, torch.float32, True),
    (2, 8, 4, 129, 32, torch.float32, False, 0, 100),
)
# Phase 3 dims: head dims no served model has, each computed at a wider
# width (flash_attention.compute_width); timed at granite-8b's training GQA
# (B, H, KV, S; causal, bf16) and held to the plain version there and at
# ragged shapes (B, H, KV, Sq, Sk, causal, window): Sq off the tiles, Sq !=
# Sk both ways, and a window.
NEW_HEAD_DIMS = (16, 24, 32, 48, 96, 112, 192, 200)
DIMS_TIMED = (TRAIN_B, H, KV, 2048)
DIMS_RAGGED = ((2, 8, 2, 333, 333, True, 0), (2, 8, 2, 200, 333, False, 0),
               (1, 8, 1, 300, 300, True, 64))
# Phase 9: the JAX package's smoke configs through the command lines.
SMOKE_SERVE_ARCHS = ("granite-8b", "qwen3-moe-30b-a3b", "recurrentgemma-9b",
                     "llama-3.2-vision-11b")
SMOKE_ENCODE_ARCH, SMOKE_FRAMES = "hubert-xlarge", 64
SMOKE_TRAIN_ARCHS = ("minicpm-2b", "qwen3-moe-30b-a3b", "hubert-xlarge")
SMOKE_STEPS = 20
# Phase 9's training bars, from the card's readings on the H100 (PERF.md):
# each step's loss (relative) and each parameter's first-step gradient
# (max|err| / max|ref|), card against CPU; a control scales one backward
# kernel output by CONTROL_SCALE.
SMOKE_LOSS_BAR, SMOKE_GRAD_BAR, CONTROL_SCALE = 5e-3, 6e-2, 0.8
SMOKE_PATH = "smoke configs through launch.serve and launch.train (phase 9)"
TWIN_STEPS = (60, 80)  # phase 7b: a run past the step-50 checkpoint, then one resumed from it
TWIN_PATH = "train_lm_topoopt twin (world size 1), 3 steps"  # phase 7b's counted run
DP_PATH = "hubert-xlarge DP step (ring, then compressed), 2 steps each"  # phase 7c
GSPMD_PATH = "hubert-xlarge GSPMD step (fsdp, world size 1), 2 steps"  # phase 7d
GSPMD_MOE_PATH = "qwen3-moe-30b-a3b GSPMD step (4 layers, world size 1), 2 steps"  # phase 7e
MESH_SERVE_PATH = "jit_serve_step (world size 1), prefill and decode loop"  # phase 7f


def require(ok, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def nvidia_smi_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return proc.stdout.strip().splitlines()[0]


def ptxas_report(log: str) -> dict:
    """Per kernel in an ``nvcc -Xptxas -v`` log: registers, static shared
    memory, spill bytes and whether ptxas serialised its wgmma instructions
    (warning C7512, or any other "Potential Performance Loss: wgmma" one,
    such as C7514).  Kernels are named by their unmangled base and template
    arguments as they appear in the mangled name."""
    import re

    def short(mangled):
        m = re.search(r"([a-z_]+(?:80_[a-z_]+)?_kernel)(I.*?E)E?v", mangled)
        return m.group(1) + m.group(2) if m else mangled

    out: dict = {}
    fn = None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\w+)", line)
        if m:
            fn = short(m.group(1))
            out.setdefault(fn, dict(registers=None, smem=0, spill_stores=0, spill_loads=0,
                                    serialised=False))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and fn:
            out[fn]["spill_stores"], out[fn]["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and fn:
            out[fn]["registers"] = int(m.group(1))
            out[fn]["smem"] = int(m.group(2) or 0)
        m = re.search(r"(?:C7512|Potential Performance Loss: wgmma).*function '(\w+)'", line)
        if m:
            out.setdefault(short(m.group(1)), dict(registers=None, smem=0, spill_stores=0,
                                                   spill_loads=0, serialised=False))
            out[short(m.group(1))]["serialised"] = True
    return out


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound(q, k, causal: bool, window: int) -> tuple[float, str]:
    """Least time for the card: the larger of operations over the dtype's peak
    and bytes (q, k, v read once, the output written once) over 3.35 TB/s.
    Operations count the (query, key) pairs the mask keeps on these shapes."""
    from repro_torch.kernels.ref import attention_mask

    Bq, Hq, Sq, Dq = q.shape
    pairs = int(attention_mask(Sq, k.shape[2], causal, window, q.device).sum())
    flops = 4.0 * Bq * Hq * Dq * pairs  # q.k and p.v: 2 flops per multiply-add each
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    t_ops, t_bytes = flops / PEAK_FLOPS[q.dtype], nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def gmm_bound(x, w) -> tuple[float, str, int]:
    """Least time for the card: x read once, the weights of each expert that
    holds a non-zero row of x read once, and the (E, C, F) output written
    once, against 2*D*F operations for each non-zero row, over the dtype's
    peak.  An expert whose rows are all zero needs no weight (0 * w = 0 for
    finite w): the work depends on the data.  Also the live experts."""
    E, C, Dx = x.shape
    F = w.shape[2]
    nonzero_rows = x.ne(0).any(dim=-1)  # (E, C)
    live = int(nonzero_rows.any(dim=-1).sum())
    flops = 2.0 * int(nonzero_rows.sum()) * Dx * F
    nbytes = (x.numel() + live * Dx * F + E * C * F) * x.element_size()
    t_ops, t_bytes = flops / PEAK_FLOPS[x.dtype], nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes", live


def gmm_bwd_bound(x, w, dy) -> tuple[float, str]:
    """Least time for the card to compute dx = dy w^T and dw = x^T dy: x, w,
    dy read once and dx, dw written once, against 2*D*F operations for each
    row of dy that is not zero (dx) and each row where neither x nor dy is
    (dw), over the dtype's peak.  A zero row adds nothing: the work depends
    on the data."""
    E, C, Dx = x.shape
    F = w.shape[2]
    live_dy = dy.ne(0).any(dim=-1)  # (E, C)
    live_both = live_dy & x.ne(0).any(dim=-1)
    flops = 2.0 * Dx * F * (int(live_dy.sum()) + int(live_both.sum()))
    nbytes = 2 * (x.numel() + w.numel()) * x.element_size() + dy.numel() * dy.element_size()
    t_ops, t_bytes = flops / PEAK_FLOPS[x.dtype], nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def mamba_bound(xc, dt, a, b, c, d_skip) -> tuple[float, str, float, float]:
    """Least time for the card: the larger of the bytes (each input read once,
    b and c only where the scan reads them, y and h written once) over
    3.35 TB/s and the B*L*DI*ST exps over the SFU rate.  Also both times."""
    Bm, L, DI = xc.shape
    ST = a.shape[1]
    nbytes = (xc.numel() * xc.element_size() + (dt.numel() + a.numel() + d_skip.numel()) * 4
              + (b.numel() + c.numel()) * b.element_size() + (Bm * L * DI + Bm * DI * ST) * 4)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, Bm * L * DI * ST / SFU_EXP_PER_S
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes",
            t_bytes * 1e3, t_ops * 1e3)


def lru_bound(a, b) -> tuple[float, str]:
    """Least time for the card: a and b read once and h_all and h_final (fp32)
    written once, against 2 flops a step and lane over the fp32 peak."""
    Bm, L, Dl = a.shape
    nbytes = (a.numel() + b.numel()) * a.element_size() + (Bm * L * Dl + Bm * Dl) * 4
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, 2.0 * Bm * L * Dl / PEAK_FLOPS[torch.float32]
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def lru_bwd_bound(a, dh_final) -> tuple[float, str]:
    """Least time for the card to compute da and db: a, h_all and dh_all
    (fp32) read once, dh_final if given, and da and db (in a's dtype)
    written once, against 3 flops a step and lane over the fp32 peak."""
    n = a.numel()
    nbytes = 3 * n * a.element_size() + 2 * n * 4 + (dh_final.numel() * 4 if dh_final is not None
                                                      else 0)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, 3.0 * n / PEAK_FLOPS[torch.float32]
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def bag_bound(tables, ids, out) -> tuple[float, str, int]:
    """Least time for the card: the distinct rows the ids select (after the
    clamp and wrap) read once, the ids read once and the output written once
    over 3.35 TB/s, against one fp32 add per value summed.  Also the rows."""
    T, R, E = tables.shape
    rows = ids.long()
    rows = torch.where(rows < 0, rows + R, rows).clamp_(0, R - 1)
    rows = rows + torch.arange(T, device=ids.device)[None, :, None] * R
    n_rows = int(torch.unique(rows).numel())
    nbytes = (n_rows * E * tables.element_size() + ids.numel() * ids.element_size()
              + out.numel() * out.element_size())
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ids.numel() * E / PEAK_FLOPS[torch.float32]
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes", n_rows


def mamba_inputs(gen, Bm, L, DI, ST, dtype, R=None):
    """Inputs as the Mamba layer makes them: dt in softplus's range near
    0.01, A = -(1..ST) per channel as ``a_log`` starts; with ``R``, b and c
    are the strided slices of one (B, L, R + 2 ST) projection."""
    dev = gen.device
    xc = torch.randn(Bm, L, DI, generator=gen, device=dev).to(dtype)
    dt = torch.rand(Bm, L, DI, generator=gen, device=dev) * 0.099 + 0.001
    a = -torch.arange(1, ST + 1, dtype=torch.float32, device=dev).repeat(DI, 1)
    if R is None:
        b = torch.randn(Bm, L, ST, generator=gen, device=dev).to(dtype)
        c = torch.randn(Bm, L, ST, generator=gen, device=dev).to(dtype)
    else:
        xdbc = torch.randn(Bm, L, R + 2 * ST, generator=gen, device=dev).to(dtype)
        b, c = xdbc[..., R:R + ST], xdbc[..., R + ST:]
    return xc, dt, a, b, c, torch.randn(DI, generator=gen, device=dev)


def narrow_config(get_config, arch):
    """An arch's smoke config widened to d_model 256 and head dim 64 (the
    attention kernel's smallest; the VLM 128, the encoder 80 at d_model
    320), in fp32."""
    over = dict(d_model=256, param_dtype="float32", activation_dtype="float32")
    if arch == "granite-8b":
        over.update(n_heads=4, n_kv_heads=2, head_dim=64, d_ff=512)
    elif arch == "qwen3-moe-30b-a3b":  # 8 experts at capacity 1.0: prefill drops entries
        over.update(n_heads=4, n_kv_heads=2, head_dim=64, d_ff=128, n_experts=8, top_k=2,
                    capacity_factor=1.0)
    elif arch == "falcon-mamba-7b":
        over.update(ssm_state=16, dt_rank=16)
    elif arch == "llama-3.2-vision-11b":  # two super-blocks of 4 self + 1 cross layer
        over.update(n_heads=4, n_kv_heads=2, head_dim=128, d_ff=512, n_layers=10,
                    cross_attn_every=5, img_tokens=100)
    elif arch == "hubert-xlarge":
        over.update(d_model=320, n_heads=4, n_kv_heads=4, head_dim=D_AU, d_ff=640, n_layers=2)
    else:  # recurrentgemma-9b: a 32-token window, which the 77-token prompts pass
        over.update(n_heads=4, n_kv_heads=1, head_dim=64, d_ff=512, lru_width=256,
                    attn_window=32)
    return dataclasses.replace(get_config(arch).smoke(), **over)


def served(lm, ops, generate, model, tokens, image_embeds=None):
    """``generate`` with every launch count set to 0 just before it and read
    just after, and again after the prefill; each step's logits are kept and
    checked after the run, so the loop never waits on the card.  The peak
    memory statistic is reset just before it too: the peak it leaves is the
    request's, not the random init's (whose fp32 draws are transients that
    loaded bf16 weights do not have).  Returns (ids, timings, prefill counts,
    decode-loop counts, logits)."""
    seen: dict = {"logits": []}
    real_prefill, real_decode = lm.prefill, lm.decode_step

    def counted_prefill(*args, **kwargs):
        logits, cache = real_prefill(*args, **kwargs)
        seen["prefill"] = {n: getattr(ops, n) for n in COUNTERS}
        seen["logits"].append(logits)
        return logits, cache

    def kept_decode(*args, **kwargs):
        logits, cache = real_decode(*args, **kwargs)
        seen["logits"].append(logits)
        return logits, cache

    lm.prefill, lm.decode_step = counted_prefill, kept_decode
    try:
        for n in COUNTERS:
            setattr(ops, n, 0)
        torch.cuda.reset_peak_memory_stats()
        timings: dict = {}
        ids = generate(model, tokens, DECODE_STEPS, timings, image_embeds)
        total = {n: getattr(ops, n) for n in COUNTERS}
    finally:
        lm.prefill, lm.decode_step = real_prefill, real_decode
    decode = {n: total[n] - seen["prefill"][n] for n in COUNTERS}
    return ids, timings, seen["prefill"], decode, seen["logits"]


def check_served(cfg, ids, logits) -> None:
    require(len(logits) == DECODE_STEPS, "one logits tensor per generated token")
    require(all(bool(torch.isfinite(t).all()) for t in logits), f"finite {cfg.name} logits")
    require(tuple(ids.shape) == (B, DECODE_STEPS), f"generated ids shape {tuple(ids.shape)}")
    require(bool(((ids >= 0) & (ids < cfg.vocab)).all()), "generated ids in the vocabulary")


def open_gates(model, value: float = 1.0) -> list:
    """Sets every cross block's gate to ``value`` and returns the gates: at
    init they are 0, and tanh(0) = 0 throws the cross-attention away, so no
    check could see it."""
    gates = [p for n, p in model.named_parameters() if n.endswith(".attn.gate")]
    for g in gates:
        g.fill_(value)
    return gates


def check_narrow_model(lm, cfg, dev, batch, label) -> dict:
    """A narrow fp32 model on the card against the same weights on the CPU:
    forward, prefill (logits and every cache entry) and, but for an encoder,
    two decode steps.  A VLM's cross gates are opened first."""
    m_cpu = lm.init(0, cfg, device="cpu")
    open_gates(m_cpu)
    m_gpu = lm.init(0, cfg, device=dev)
    m_gpu.load_state_dict(m_cpu.state_dict())
    gpu_batch = {k: v.to(dev) for k, v in batch.items()}
    fc, _ = lm.forward(m_cpu, batch, cfg)
    fg, _ = lm.forward(m_gpu, gpu_batch, cfg)
    S = next(iter(batch.values())).shape[1]
    lc, cc = lm.prefill(m_cpu, batch, cfg, pad_to=S + 2)
    lg, cg = lm.prefill(m_gpu, gpu_batch, cfg, pad_to=S + 2)
    errs = {"forward": float((fg.cpu() - fc).abs().max()),
            "prefill": float((lg.cpu() - lc).abs().max())}
    errs.update({f"cache {n}": float((cg[n].cpu() - cc[n]).abs().max()) for n in cc})
    for pos in () if cfg.is_encoder else (S, S + 1):
        tok = lc.argmax(-1)
        lc, cc = lm.decode_step(m_cpu, {"token": tok, "pos": pos, "cache": cc}, cfg)
        lg, cg = lm.decode_step(m_gpu, {"token": tok.to(dev), "pos": pos, "cache": cg}, cfg)
        errs[f"decode@{pos}"] = float((lg.cpu() - lc).abs().max())
    require(max(errs.values()) <= 1e-4, f"narrow {label}, card vs CPU: {errs}")
    return errs


def dispatch_like(x, gen):
    """Zeroes the rows of an (E, C, D) buffer past each expert's count, as
    the MoE layer's dispatch leaves them: counts from 4000 tokens' top-8 of
    128 random scores, capped at C."""
    E, C, _ = x.shape
    top = torch.rand(B * PROMPT, E, generator=gen, device=x.device).topk(8, dim=-1).indices
    counts = torch.zeros(E, dtype=torch.int64, device=x.device)
    counts.scatter_add_(0, top.reshape(-1), torch.ones_like(top.reshape(-1)))
    rows = torch.arange(C, device=x.device)[None, :] < counts.clamp(max=C)[:, None]
    return x * rows[..., None].to(x.dtype)


def moe_decode_buffers(layers, ops, cfg, dev, gen):
    """What ``layers.moe`` passes to the grouped matmul at one decode step of
    the B served requests (one token each) on a full-width MoE layer of
    ``cfg`` with random weights (seed 0): [("gate", x (E, 1, D), wg),
    ("down", h (E, 1, F), wd)].  Experts that no token picked hold zero rows."""
    moe = layers.MoE(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    tokens = torch.randn(B, 1, cfg.d_model, generator=gen, device=dev).to(moe.wg.dtype)
    x = layers.rms_norm(tokens, moe.norm)
    seen = []
    real = ops.grouped_matmul

    def capture(xb, w):
        seen.append((xb, w))
        return real(xb, w)

    ops.grouped_matmul = capture
    try:
        layers.moe(moe, x, cfg)
    finally:
        ops.grouped_matmul = real
    (xg, wg), _, (hd, wd) = seen
    return [("gate", xg, wg), ("down", hd, wd)]


# The grouped matmul's backward (name, E, C, D, F, dtype): qwen3-moe-30b-a3b's
# training products (C = C_TRAIN), gate/up (the main path's first) and down,
# in bf16, fp16 and fp32; around the 128 x 256 tiles (C, D, F ragged); and a
# decode-sized batch (C = 1).
GMM_BWD_CASES = (
    ("gate_up", E_MOE, C_TRAIN, D_MOE, F_MOE, torch.bfloat16),
    ("down", E_MOE, C_TRAIN, F_MOE, D_MOE, torch.bfloat16),
    ("gate_up_fp16", E_MOE, C_TRAIN, D_MOE, F_MOE, torch.float16),
    ("down_fp16", E_MOE, C_TRAIN, F_MOE, D_MOE, torch.float16),
    ("gate_up_fp32", E_MOE, C_TRAIN, D_MOE, F_MOE, torch.float32),
    ("down_fp32", E_MOE, C_TRAIN, F_MOE, D_MOE, torch.float32),
    ("ragged", 4, 129, 72, 136, torch.bfloat16),
    ("ragged_fp16", 4, 129, 72, 136, torch.float16),
    ("decode", E_MOE, 1, D_MOE, F_MOE, torch.bfloat16),
    ("tp16_gate_up", E_TP16, C_TRAIN, D_MOE, F_MOE, torch.bfloat16),
    ("tp16_down", E_TP16, C_TRAIN, F_MOE, D_MOE, torch.bfloat16),
)


def check_gmm_bwd(moe_gmm_bwd, ref_moe_gmm_bwd, gmm_bwd_tiling, gen, dev, smi) -> dict:
    """The grouped matmul's backward against its plain version on each of
    GMM_BWD_CASES, dx and dw within the forward's bar in that dtype (TOL) and
    two launches equal to the bit; times by CUDA events: the call (dx and
    dw), dx and dw apart, the plain version and torch.bmm for the same dx
    and dw (a yardstick, never on the port's path), beside the bound.
    Returns each case's numbers, by name."""
    out = {}
    for name, E, C, Dx, F, dtype in GMM_BWD_CASES:
        x = torch.randn(E, C, Dx, generator=gen, device=dev).to(dtype)
        w = (torch.randn(E, Dx, F, generator=gen, device=dev) / Dx**0.5).to(dtype)
        dy = torch.randn(E, C, F, generator=gen, device=dev).to(dtype)
        dx, dw = moe_gmm_bwd(x, w, dy)
        torch.cuda.synchronize()
        rx, rw = ref_moe_gmm_bwd(x, w, dy)
        tiling = gmm_bwd_tiling(dtype, C, Dx, F)
        tol = TOL[dtype]
        label = f"{name} E={E} C={C} D={Dx} F={F} {str(dtype)[6:]} tiling={tiling}"
        errs = {"dx": float((dx.float() - rx.float()).abs().max()),
                "dw": float((dw.float() - rw.float()).abs().max())}
        require(bool(torch.isfinite(dx).all() and torch.isfinite(dw).all()),
                f"finite backward output, {label}")
        require(torch.allclose(dx.float(), rx.float(), rtol=tol, atol=tol)
                and torch.allclose(dw.float(), rw.float(), rtol=tol, atol=tol),
                f"backward vs plain at {tol}, {label}: max|err| {errs}")
        dx2, dw2 = moe_gmm_bwd(x, w, dy)
        require(torch.equal(dx, dx2) and torch.equal(dw, dw2),
                f"two backward launches equal to the bit, {label}")
        del dx, dw, rx, rw, dx2, dw2
        iters = 20 if dtype != torch.float32 else 3
        kernel_ms = time_ms(lambda: moe_gmm_bwd(x, w, dy), iters)
        dx_ms = time_ms(lambda: moe_gmm_bwd(x, w, dy, True, False), iters)
        dw_ms = time_ms(lambda: moe_gmm_bwd(x, w, dy, False, True), iters)
        plain_ms = time_ms(lambda: ref_moe_gmm_bwd(x, w, dy), 3, warmup=1)
        library_ms = time_ms(lambda: (torch.bmm(dy, w.transpose(1, 2)),
                                      torch.bmm(x.transpose(1, 2), dy)), iters)
        bound_ms, bound_by = gmm_bwd_bound(x, w, dy)
        print(f"phase 3 kernel: moe_gmm_bwd {label}: max|err| {errs} (tol {tol}), two launches "
              f"bitwise equal; kernel_ms {kernel_ms} (dx {dx_ms}, dw {dw_ms}) plain_ms {plain_ms} "
              f"library_ms {library_ms} (torch.bmm, dx and dw) bound_ms {bound_ms} ({bound_by}) "
              f"share of bound {bound_ms / kernel_ms} on {smi}")
        out[name] = dict(tiling=tiling, max_abs_err=max(errs.values()), max_abs_err_dx=errs["dx"],
                         max_abs_err_dw=errs["dw"], kernel_ms=kernel_ms, dx_ms=dx_ms, dw_ms=dw_ms,
                         plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                         bound_by=bound_by)
        del x, w, dy
        torch.cuda.empty_cache()
    return out


def mamba_bwd_bound(xc, dt, a, b, c, d_skip, dy, dh) -> tuple[float, str, float, float]:
    """Least time for the card to compute the scan's six gradients: the
    forward's inputs, dy and dh read once (b and c only where the scan reads
    them) and dxc, ddt, da, db, dc, dd written once over 3.35 TB/s, against
    one decay a (element, state), B*L*DI*ST exps, over the SFU rate.  Also
    both times."""
    Bm, L, DI = xc.shape
    ST = a.shape[1]
    xb, bb = xc.element_size(), b.element_size()
    nbytes = (2 * xc.numel() * xb + (dt.numel() + dy.numel()) * 4 + Bm * L * DI * 4
              + 2 * (a.numel() + d_skip.numel()) * 4 + 2 * (b.numel() + c.numel()) * bb
              + (dh.numel() * 4 if dh is not None else 0))
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, Bm * L * DI * ST / SFU_EXP_PER_S
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes",
            t_bytes * 1e3, t_ops * 1e3)


# The scan backward's cases (name, B, L, DI, ST, R, dtype, with dh): falcon-
# mamba-7b's training shape (b and c strided as the layer makes them) in bf16
# (the main path's) and fp32; ragged (L and DI off the 8-step chunk and the
# 128-channel block); 64 and 128 states (4 and 8 lanes a channel); a seeded
# gradient for the final state.
MAMBA_BWD_CASES = (
    ("training", TRAIN_B, TRAIN_S, DI_MAMBA, ST_MAMBA, R_MAMBA, torch.bfloat16, False),
    ("training_fp32", TRAIN_B, TRAIN_S, DI_MAMBA, ST_MAMBA, R_MAMBA, torch.float32, False),
    ("ragged", 2, 1001, 200, ST_MAMBA, None, torch.bfloat16, False),
    ("st64", 2, 333, 520, 64, None, torch.float32, False),
    ("st128", 2, 100, 100, 128, 8, torch.bfloat16, False),
    ("dh", 2, 500, 300, ST_MAMBA, 8, torch.float32, True),
    ("tp16", TRAIN_B, TRAIN_S, DI_TP16, ST_MAMBA, R_MAMBA, torch.bfloat16, False),
)


def check_mamba_bwd(mamba_scan, mamba_scan_bwd, ref_mamba_scan, ref_mamba_scan_bwd, gen, dev,
                    smi) -> dict:
    """The scan's training path against its plain versions on each of
    MAMBA_BWD_CASES.  The forward with checkpoints (``mamba_scan(...,
    checkpoints=True)``, as ``SelectiveScanFn`` runs it): y and h bitwise
    equal to the serving call's, the checkpoints within 1e-4 of their max|.|
    of the plain forward's.  The backward on those checkpoints: two launches
    equal to the bit; each fp32 output within 1e-4 of its max|.| (the
    forward's bar; the sums run over up to DI = 8192 channels for db and dc
    and B*L = 16384 steps for da and dd, in another order than the plain
    version's), and each output in bf16 (dxc, db, dc) within that plus one
    rounding on each side, bf16's eps (2^-7) times the value; the time per
    call (both launches) beside the bound and the plain version's time.  At
    the training shapes also the forward's time without and with checkpoints
    and a layer's scans as a remat step runs them (two forwards with
    checkpoints, then the backward: ``pair_ms``).  No PyTorch call computes
    the function, so there is no library time.  Returns each case's numbers,
    by name."""
    names = ("dxc", "ddt", "da", "db", "dc", "dd")
    out = {}
    for name, Bm, L, DI, ST, R, dtype, with_dh in MAMBA_BWD_CASES:
        args = mamba_inputs(gen, Bm, L, DI, ST, dtype, R)
        label = (f"{name} B={Bm} L={L} DI={DI} ST={ST} {str(dtype)[6:]}"
                 + (" b,c strided" if R else "") + (" dh" if with_dh else ""))
        y, h = mamba_scan(*args)
        y_ck, h_ck, ckpt = mamba_scan(*args, checkpoints=True)
        torch.cuda.synchronize()
        require(torch.equal(y, y_ck) and torch.equal(h, h_ck),
                f"the scan with checkpoints gives the serving call's y and h bits, {label}")
        want_ckpt = ref_mamba_scan(*args, checkpoints=True)[2]
        ckpt_err = float((ckpt - want_ckpt).abs().max()) if ckpt.numel() else 0.0
        ckpt_bar = 1e-4 * float(want_ckpt.abs().max()) if ckpt.numel() else 0.0
        require(ckpt.shape == want_ckpt.shape and ckpt_err <= ckpt_bar,
                f"scan checkpoints vs plain, {label}: max|err| {ckpt_err}, bar {ckpt_bar}")
        del y, h, y_ck, h_ck, want_ckpt
        dy = torch.randn(Bm, L, DI, generator=gen, device=dev)
        dh = torch.randn(Bm, DI, ST, generator=gen, device=dev) if with_dh else None
        got = mamba_scan_bwd(*args, dy, dh, ckpt)
        torch.cuda.synchronize()
        again = mamba_scan_bwd(*args, dy, dh, ckpt)
        require(all(torch.equal(g, a) for g, a in zip(got, again)),
                f"two scan backward launches equal to the bit, {name}")
        del again
        want = ref_mamba_scan_bwd(*args, dy, dh)
        errs, bars = {}, {}
        for n, g, w in zip(names, got, want):
            require(g.dtype == w.dtype and g.shape == w.shape and bool(torch.isfinite(g).all()),
                    f"scan backward {n}: {g.dtype} {tuple(g.shape)} finite, {label}")
            g, w = g.float(), w.float()
            scale = float(w.abs().max())
            diff = (g - w).abs()
            over = diff - 1e-4 * scale
            if n in ("dxc", "db", "dc") and dtype != torch.float32:
                over = over - torch.finfo(dtype).eps * w.abs()
            errs[n], bars[n] = float(diff.max()), 1e-4 * scale
            require(float(over.max()) <= 0.0,
                    f"scan backward {n} vs plain, {label}: max|err| {errs[n]}, max|want| {scale}")
        del got, want
        kernel_ms = time_ms(lambda: mamba_scan_bwd(*args, dy, dh, ckpt), 10, warmup=2)
        plain_ms = time_ms(lambda: ref_mamba_scan_bwd(*args, dy, dh), 1, warmup=0)
        bound_ms, bound_by, bytes_ms, exp_ms = mamba_bwd_bound(*args, dy, dh)
        times = {}
        if name.startswith("training"):
            def pair():  # a layer's scans in a remat step: the forward twice, then the backward
                mamba_scan(*args, checkpoints=True)
                mamba_scan(*args, checkpoints=True)
                mamba_scan_bwd(*args, dy, dh, ckpt)

            times = dict(fwd_ms=time_ms(lambda: mamba_scan(*args), 10),
                         fwd_ckpt_ms=time_ms(lambda: mamba_scan(*args, checkpoints=True), 10),
                         pair_ms=time_ms(pair, 5, warmup=1))
        print(f"phase 3 kernel: mamba_scan_bwd {label}: checkpoints max|err| {ckpt_err} (bar "
              f"{ckpt_bar}), y and h bitwise equal to the serving call's; max|err| {errs} (bars "
              f"1e-4 max|.| {bars}, bf16 outputs plus 2^-7 |value|), two launches bitwise equal; "
              f"kernel_ms {kernel_ms} plain_ms {plain_ms} library_ms None bound_ms {bound_ms} "
              f"({bound_by}; bytes {bytes_ms} ms, exps {exp_ms} ms) share of bound "
              f"{bound_ms / kernel_ms} {json.dumps(times)} on {smi}")
        out[name] = dict(max_abs_err=max(errs.values()), max_abs_err_by_grad=errs,
                         ckpt_max_abs_err=ckpt_err, kernel_ms=kernel_ms, plain_ms=plain_ms,
                         library_ms=None, bound_ms=bound_ms, bound_by=bound_by, **times)
        del args, dy, dh, ckpt
        gc.collect()
        torch.cuda.empty_cache()
    return out


def attention_bwd_bound(q, k, causal: bool, window: int = 0) -> tuple[float, str]:
    """Least time for the card: 5 products of 2*D flops a kept (query, key)
    pair (half the pairs under a causal mask, fewer under a window) over the
    dtype's peak, against q, k, v, o, do and lse read once and dq, dk, dv
    written once over 3.35 TB/s."""
    from repro_torch.kernels.ref import attention_mask

    Bq, Hq, Sq, Dq = q.shape
    pairs = int(attention_mask(Sq, k.shape[2], causal, window, q.device).sum())
    flops = 10.0 * Bq * Hq * Dq * pairs
    nbytes = 4 * (q.numel() + k.numel()) * q.element_size() + Bq * Hq * Sq * 4
    t_ops, t_bytes = flops / PEAK_FLOPS[q.dtype], nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def plain_attention_grads(ref_flash_attention, q, k, v, do, causal: bool, window: int = 0):
    """Autograd of the plain version in fp32, one batch row at a time: the
    fp32 scores of a row of minicpm-2b's shape (36 x 4096 x 4096) take 2.4 GB
    and autograd keeps several such tensors."""
    grads = []
    for b in range(q.shape[0]):
        qf, kf, vf = (t[b:b + 1].float().requires_grad_(True) for t in (q, k, v))
        out = ref_flash_attention(qf, kf, vf, causal=causal, window=window)
        grads.append(torch.autograd.grad(out, (qf, kf, vf), do[b:b + 1].float()))
    return [torch.cat(g) for g in zip(*grads)]


def sdpa_backend(q, k, v, **kwargs) -> str:
    """The backend PyTorch's dispatcher picks for ``scaled_dot_product_attention``
    on these inputs and keywords (``torch._fused_sdp_choice``, as the call
    itself asks; its backward runs on the same one).  Asked rather than read
    from a profiler trace: profiling these SDPA calls made the embedding
    bag's later profiler sessions drop kernel events."""
    from torch.nn.attention import SDPBackend

    names = {int(getattr(SDPBackend, n)): n.lower() for n in dir(SDPBackend) if n.isupper()}
    choice = int(torch._fused_sdp_choice(q, k, v, **kwargs))
    return names.get(choice, str(choice))


def check_attention_fwd(case, gen, dev, smi, batch: int = B, phase: str = "3") -> dict:
    """Phases 3 and 7a: flash attention against its plain version on one
    ``case`` (Sq, Sk, D, dtype, causal, window, KV, H) at ``batch``: finite,
    two launches equal to the bit, within TOL; its time beside the plain
    version's, SDPA's (with a window, the window as a mask) and the bound,
    and bf16/fp16 serving shapes on the fma tiling too.  Returns the numbers."""
    from repro_torch.kernels.flash_attention import attention_tiling, flash_attention
    from repro_torch.kernels.ref import attention_mask, ref_flash_attention

    Sq, Sk, dh, dtype, causal, window, kv, h = case
    q = torch.randn(batch, h, Sq, dh, generator=gen, device=dev).to(dtype)
    k, v = (torch.randn(batch, kv, Sk, dh, generator=gen, device=dev).to(dtype) for _ in "kv")
    out = flash_attention(q, k, v, causal=causal, window=window)
    again = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    ref = ref_flash_attention(q, k, v, causal=causal, window=window)
    err = float((out.float() - ref.float()).abs().max())
    tol = TOL[dtype]
    tiling = attention_tiling(dtype, dh)
    label = ((f"B={batch} " if batch != B else "")
             + f"H={h} KV={kv} Sq={Sq} Sk={Sk} D={dh} {str(dtype)[6:]} causal={causal} "
             f"window={window} tiling={tiling}")
    require(bool(torch.isfinite(out).all()), f"finite kernel output, {label}")
    require(torch.equal(out, again), f"two launches bitwise equal, {label}")
    del again
    require(torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol),
            f"kernel vs plain at {tol}, {label}: max|err| {err}")
    kernel_ms = time_ms(lambda: flash_attention(q, k, v, causal=causal, window=window), 20)
    plain_ms = time_ms(lambda: ref_flash_attention(q, k, v, causal=causal, window=window), 5)
    fma_ms = None
    # SDPA, a yardstick only, never on the port's path.  It has no window
    # argument: a window shorter than the keys goes in as a boolean mask.
    mask = (dict(attn_mask=attention_mask(Sq, Sk, causal, window, dev))
            if 0 < window < max(Sq, Sk) else dict(is_causal=causal))
    library_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, enable_gqa=True, **mask), 20)
    if tiling == "wgmma" and Sq >= PROMPT:  # the earlier tiling, on the same inputs
        fma_ms = time_ms(lambda: flash_attention(q, k, v, causal=causal, window=window,
                                                 tiling="fma"), 20)
    bound_ms, bound_by = attention_bound(q, k, causal, window)
    # Head dim 80 on wgmma runs its own kernel (true-width products,
    # softmax overlapped): its time against SDPA's.
    ratio = (f" kernel/SDPA {kernel_ms / library_ms}"
             if dh == 80 and tiling == "wgmma" and library_ms else "")
    print(f"phase {phase} kernel: flash_attention {label}: max|err| {err} (tol {tol}) "
          f"kernel_ms {kernel_ms} plain_ms {plain_ms} library_ms {library_ms} "
          f"bound_ms {bound_ms} ({bound_by}) fma_ms {fma_ms}{ratio}; two launches bitwise "
          f"equal; on {smi}")
    return dict(tiling=tiling, max_abs_err=err, kernel_ms=kernel_ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by, fma_ms=fma_ms)


def check_attention_bwd(case, gen, dev, smi, phase: str = "3") -> dict:
    """Phase 3: the forward's lse against the plain one and the backward
    kernel against autograd of the plain version (fp32) on the same inputs,
    on the tiling that serves the dtype and, for bf16/fp16 inputs, on the fma
    tiling too, with times: each tiling, the forward with and without lse,
    plain, SDPA's backward (a yardstick only; with a window, the window as a
    boolean mask, and the backend that served it) and the bound.  ``case``
    is (B, H, KV, S, D, dtype, causal[, window]).  At the main path's shape
    (``train_shape``) also the plain forward and SDPA's forward, row 1's
    yardsticks at the training shape.  ``case`` may end in Sk after the
    window (Sq = S); without one, Sk = S.  Two launches of the case's tiling
    must give the same bits."""
    from repro_torch.kernels.flash_attention import (
        attention_bwd_tiling, attention_tiling, compute_width, flash_attention,
        flash_attention_bwd,
    )
    from repro_torch.kernels.ref import (
        attention_mask, ref_flash_attention, ref_flash_attention_bwd, ref_flash_attention_lse,
    )

    Bc, Hc, KVc, S, Dc, dtype, causal, *rest = case
    window = rest[0] if rest else 0
    Sk = rest[1] if len(rest) > 1 else S
    q = torch.randn(Bc, Hc, S, Dc, generator=gen, device=dev).to(dtype)
    k, v = (torch.randn(Bc, KVc, Sk, Dc, generator=gen, device=dev).to(dtype) for _ in "kv")
    do = torch.randn(Bc, Hc, S, Dc, generator=gen, device=dev).to(dtype)
    lse = torch.empty(Bc, Hc, S, dtype=torch.float32, device=dev)
    o = flash_attention(q, k, v, causal=causal, window=window, lse=lse)
    tiling = attention_bwd_tiling(dtype, Dc)
    width = compute_width(tiling, Dc)
    tilings = (tiling, "fma") if tiling != "fma" else (tiling,)
    grads = {t: flash_attention_bwd(q, k, v, o, lse, do, causal, window, tiling=t)
             for t in tilings}
    again = flash_attention_bwd(q, k, v, o, lse, do, causal, window, tiling=tiling)
    torch.cuda.synchronize()
    label = (f"B={Bc} H={Hc} KV={KVc} S={S}" + (f" Sk={Sk}" if Sk != S else "")
             + f" D={Dc} {str(dtype)[6:]} causal={causal} window={window} forward "
             f"tiling={attention_tiling(dtype, Dc)}")
    require(all(torch.equal(a, b) for a, b in zip(again, grads[tiling])),
            f"flash_attention_bwd, {label}, tiling {tiling}: two launches differ")
    del again
    ref_lse = torch.cat([ref_flash_attention_lse(q[b:b + 1], k[b:b + 1], v[b:b + 1], causal,
                                                 window) for b in range(Bc)])
    lse_err = float((lse - ref_lse).abs().max())
    lse_tol = 1e-4 * max(1.0, float(ref_lse.abs().max()))
    require(lse_err <= lse_tol, f"forward lse vs plain, {label}: max|err| {lse_err} > {lse_tol}")
    want = plain_attention_grads(ref_flash_attention, q, k, v, do, causal, window)
    errs, bars = {t: {} for t in tilings}, {}
    for t in tilings:
        for name, got, ref in zip(("dq", "dk", "dv"), grads[t], want):
            require(bool(torch.isfinite(got).all()), f"finite {name}, {label}, tiling {t}")
            errs[t][name] = float((got.float() - ref).abs().max())
            bars[name] = TOL[dtype] * float(ref.abs().max())
            require(errs[t][name] <= bars[name],
                    f"flash_attention_bwd {name} vs autograd of plain, {label}, tiling {t}: "
                    f"max|err| {errs[t][name]} > {bars[name]} ({TOL[dtype]} max|ref|)")
    plain_errs = {}
    if Dc == 256:  # also the backward's own plain version, on the forward's o and lse
        plain = [torch.cat(g) for g in zip(*(ref_flash_attention_bwd(
            *(x[b:b + 1].float() for x in (q, k, v, o)), lse[b:b + 1], do[b:b + 1].float(),
            causal, window) for b in range(Bc)))]
        for name, got, ref in zip(("dq", "dk", "dv"), grads[tiling], plain):
            plain_errs[name] = float((got.float() - ref).abs().max())
            require(plain_errs[name] <= TOL[dtype] * float(ref.abs().max()),
                    f"flash_attention_bwd {name} vs ref_flash_attention_bwd, {label}: max|err| "
                    f"{plain_errs[name]} > {TOL[dtype]} max|ref|")
        del plain
    del want, grads
    kernel_ms = {t: time_ms(lambda: flash_attention_bwd(q, k, v, o, lse, do, causal, window,
                                                        tiling=t), 10) for t in tilings}
    fwd_ms = time_ms(lambda: flash_attention(q, k, v, causal=causal, window=window), 10)
    fwd_lse_ms = time_ms(lambda: flash_attention(q, k, v, causal=causal, window=window, lse=lse),
                         10)
    plain_ms = time_ms(lambda: plain_attention_grads(ref_flash_attention, q, k, v, do, causal,
                                                     window), 2, warmup=1)
    qr, kr, vr = (t.detach().requires_grad_(True) for t in (q, k, v))
    # SDPA has no window argument: a window shorter than S goes in as a mask.
    mask = (dict(attn_mask=attention_mask(S, Sk, causal, window, dev))
            if 0 < window < S else dict(is_causal=causal))
    out = torch.nn.functional.scaled_dot_product_attention(qr, kr, vr, enable_gqa=True, **mask)
    library_ms = time_ms(
        lambda: torch.autograd.grad(out, (qr, kr, vr), do, retain_graph=True), 10)
    backend = sdpa_backend(qr, kr, vr, enable_gqa=True, **mask)
    del out, qr, kr, vr
    bound_ms, bound_by = attention_bwd_bound(q, k, causal, window)
    extra = {}
    if tiling != "fma":
        extra = dict(fma_kernel_ms=kernel_ms["fma"], fma_max_abs_err=max(errs["fma"].values()))
    if Dc == 256 and tiling == "wgmma":
        # The dk/dv launch with one block a key tile and kv head, all the
        # group's query heads in it (no partials): what the split is for.
        from repro_torch.kernels import flash_attention as fa

        real = fa.sm_count
        fa.sm_count = lambda index: 1
        try:
            extra["unsplit_kernel_ms"] = time_ms(
                lambda: flash_attention_bwd(q, k, v, o, lse, do, causal, window, tiling=tiling), 10)
        finally:
            fa.sm_count = real
    fwd_yardsticks = ""
    if case in TRAIN_FWD_CASES:  # the training forward: plain (a batch row at a time) and SDPA
        extra["fwd_plain_ms"] = time_ms(lambda: [ref_flash_attention(
            q[b:b + 1], k[b:b + 1], v[b:b + 1], causal=causal) for b in range(Bc)], 2, warmup=1)
        extra["fwd_library_ms"] = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True), 10)
        fwd_yardsticks = (f", plain forward {extra['fwd_plain_ms']} ms (a batch row at a time), "
                          f"SDPA's forward {extra['fwd_library_ms']} ms")
    print(f"phase {phase} kernel: flash_attention_bwd {label}: lse max|err| {lse_err} (tol {lse_tol}); "
          f"max|err| by tiling {errs} (bars {bars})"
          + (f", vs ref_flash_attention_bwd {plain_errs}" if plain_errs else "")
          + f" kernel_ms by tiling {kernel_ms}"
          + (f" (wgmma with one dk/dv block a key tile, no head split: "
             f"{extra['unsplit_kernel_ms']})" if "unsplit_kernel_ms" in extra else "")
          + f" plain_ms {plain_ms} (autograd of the plain version, fp32, a batch row at a time) library_ms "
          f"{library_ms} (SDPA's backward, {backend} backend) bound_ms {bound_ms} ({bound_by}; "
          + ("5 products as the bound counts, at the true width of 80 (S and dP once, dQ "
             "summed in fp32 in a fixed order of turns)" if Dc == 80 and tiling == "wgmma"
             else f"{11 if width == 256 and tiling == 'wgmma' else 7} products where the bound "
                  "counts 5" + (f", at a width of {width}" if width != Dc else ""))
          + (f"; kernel/SDPA backward {kernel_ms[tiling] / library_ms}"
             + (f", forward kernel/SDPA {fwd_ms / extra['fwd_library_ms']}"
                if "fwd_library_ms" in extra else "")
             if Dc == 80 and tiling == "wgmma" else "")
          + f"); two launches bitwise equal; forward {fwd_ms} ms, with lse {fwd_lse_ms} ms"
          f"{fwd_yardsticks}; on {smi}")
    return dict(tiling=tiling, max_abs_err=max(errs[tiling].values()),
                max_abs_err_by_grad=errs[tiling], lse_max_abs_err=lse_err,
                kernel_ms=kernel_ms[tiling], plain_ms=plain_ms, library_ms=library_ms,
                library_backend=backend, bound_ms=bound_ms, bound_by=bound_by, fwd_ms=fwd_ms,
                fwd_lse_ms=fwd_lse_ms, fwd_bound_ms=attention_bound(q, k, causal, window)[0],
                **extra)


# The RG-LRU backward's cases (name, B, L, D, dtype, with dh_final):
# recurrentgemma-9b's training shape (fp32 a and b, as the layer passes
# them; the main path's first), with a gradient for h_final, with bf16 a;
# and ragged (L off the 128-step rounds, D off the 32-channel tiles; D = 33
# rows TMA cannot stride).
LRU_BWD_CASES = (
    ("training", HYB_TRAIN_B, TRAIN_S, D_RG, torch.float32, False),
    ("training_dh", HYB_TRAIN_B, TRAIN_S, D_RG, torch.float32, True),
    ("training_bf16", HYB_TRAIN_B, TRAIN_S, D_RG, torch.bfloat16, False),
    ("ragged", 3, 1000, 200, torch.float32, True),
    ("ragged_plain_loads", 2, 1000, 33, torch.float32, True),
    ("tp16", HYB_TRAIN_B, TRAIN_S, D_RG_TP16, torch.float32, False),
)


def check_lru_bwd(rglru_scan, rglru_scan_bwd, ref_rglru_scan_bwd, gen, dev, smi) -> dict:
    """The RG-LRU scan's backward against its plain version on each of
    LRU_BWD_CASES, on the h_all of the forward kernel: two launches equal to
    the bit; da and db within 1e-4 of each one's max|.| (the chunks' carries
    are products in another order than the plain walk's), plus one rounding
    (eps times the value) where a is bf16 and the gradients come back in
    it; the time per call (one launch, and the casts to a's dtype where it
    is 16-bit) beside the bound and the plain version's.  At the training
    shape also the forward at B = 1 and a layer's scans as a remat step runs
    them (two forwards, then the backward: ``pair_ms``).  No PyTorch call
    computes the function, so there is no library time.  Returns each case's
    numbers, by name."""
    out = {}
    for name, Bl, L, Dl, dtype, with_dh in LRU_BWD_CASES:
        a = (torch.rand(Bl, L, Dl, generator=gen, device=dev) * 0.89 + 0.1).to(dtype)
        b = torch.randn(Bl, L, Dl, generator=gen, device=dev).to(dtype)
        h_all = rglru_scan(a, b)[0]
        dh = torch.randn(Bl, L, Dl, generator=gen, device=dev)
        dhf = torch.randn(Bl, Dl, generator=gen, device=dev) if with_dh else None
        label = f"{name} B={Bl} L={L} D={Dl} {str(dtype)[6:]}" + (" dh_final" if with_dh else "")
        got = rglru_scan_bwd(a, h_all, dh, dhf)
        torch.cuda.synchronize()
        again = rglru_scan_bwd(a, h_all, dh, dhf)
        require(all(torch.equal(g, x) for g, x in zip(got, again)),
                f"two RG-LRU backward launches equal to the bit, {label}")
        errs = {}
        for n, g, w in zip(("da", "db"), got, ref_rglru_scan_bwd(a, h_all, dh, dhf)):
            require(g.dtype == w.dtype == dtype and g.shape == w.shape
                    and bool(torch.isfinite(g).all()), f"RG-LRU backward {n}: {g.dtype} "
                    f"{tuple(g.shape)} finite, {label}")
            g, w = g.float(), w.float()
            over = (g - w).abs() - 1e-4 * float(w.abs().max())
            if dtype != torch.float32:
                over = over - torch.finfo(dtype).eps * w.abs()
            errs[n] = float((g - w).abs().max())
            require(float(over.max()) <= 0.0, f"RG-LRU backward {n} vs plain, {label}: max|err| "
                                              f"{errs[n]}, max|want| {float(w.abs().max())}")
        del got, again
        kernel_ms = time_ms(lambda: rglru_scan_bwd(a, h_all, dh, dhf), 20)
        plain_ms = time_ms(lambda: ref_rglru_scan_bwd(a, h_all, dh, dhf), 1, warmup=0)
        bound_ms, bound_by = lru_bwd_bound(a, dhf)
        times = {}
        if name == "training":
            def pair():  # a layer's scans in a remat step: the forward twice, then the backward
                rglru_scan(a, b)
                rglru_scan(a, b)
                rglru_scan_bwd(a, h_all, dh, dhf)

            times = dict(fwd_ms=time_ms(lambda: rglru_scan(a, b), 20),
                         fwd_bound_ms=lru_bound(a, b)[0], pair_ms=time_ms(pair, 10))
        print(f"phase 3 kernel: rglru_scan_bwd {label}: max|err| {errs} (bars 1e-4 max|.|"
              f"{', bf16 outputs plus 2^-7 |value|' if dtype != torch.float32 else ''}), two "
              f"launches bitwise equal; kernel_ms {kernel_ms} plain_ms {plain_ms} library_ms None "
              f"bound_ms {bound_ms} ({bound_by}) share of bound {bound_ms / kernel_ms} "
              f"{json.dumps(times)} on {smi}")
        out[name] = dict(max_abs_err=max(errs.values()), max_abs_err_by_grad=errs,
                         kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=None,
                         bound_ms=bound_ms, bound_by=bound_by, **times)
        del a, b, h_all, dh, dhf
    torch.cuda.empty_cache()
    return out


def tp16_summary(attn, gmm_fwd, gmm_fwd_down, gmm_bwd, mamba_fwd, mamba_bwd, lru_fwd,
                 lru_bwd) -> dict:
    """Phase 3's numbers at one model rank's shapes on the production mesh
    (TP16_ATTN_CASES, E_TP16, DI_TP16, D_RG_TP16), by kernel: kernel, bound,
    plain and library ms and the largest error, and where phase 3 times the
    same kernel at full width and the same batch and length, ``x16_over_full``:
    TP_PROD times the rank's time over the full width's (1.0 where a rank
    takes its share of the time; more where its smaller grid leaves the card
    idle)."""
    keys = ("kernel_ms", "bound_ms", "bound_by", "plain_ms", "library_ms", "max_abs_err")

    def row(numbers, full=None):
        out = {k: numbers.get(k) for k in keys}
        if full is not None:
            out["full_kernel_ms"] = full["kernel_ms"]
            out["x16_over_full"] = TP_PROD * numbers["kernel_ms"] / full["kernel_ms"]
        return out

    return {
        "flash_attention qwen3 H=2 KV=1 D=128 causal 4x4096": row(attn[0]["fwd"]),
        "flash_attention_bwd qwen3 H=2 KV=1 D=128 causal 4x4096": row(attn[0]["bwd"]),
        "flash_attention recurrentgemma H=1 KV=1 D=256 window 2048 1x4096": row(attn[1]["fwd"]),
        "flash_attention_bwd recurrentgemma H=1 KV=1 D=256 window 2048 1x4096":
            row(attn[1]["bwd"]),
        f"moe_gmm gate/up E={E_TP16} C={C_TRAIN}": row(gmm_fwd),
        f"moe_gmm down E={E_TP16} C={C_TRAIN}": row(gmm_fwd_down),
        f"moe_gmm_bwd gate/up E={E_TP16} C={C_TRAIN}": row(gmm_bwd["tp16_gate_up"],
                                                            gmm_bwd["gate_up"]),
        f"moe_gmm_bwd down E={E_TP16} C={C_TRAIN}": row(gmm_bwd["tp16_down"], gmm_bwd["down"]),
        f"mamba_scan DI={DI_TP16} 4x4096": row(mamba_fwd,
                                               {"kernel_ms": mamba_bwd["training"]["fwd_ms"]}),
        f"mamba_scan_bwd DI={DI_TP16} 4x4096": row(mamba_bwd["tp16"], mamba_bwd["training"]),
        f"rglru_scan D={D_RG_TP16} 1x4096": row(lru_fwd["tp16"], lru_fwd["training"]),
        f"rglru_scan_bwd D={D_RG_TP16} 1x4096": row(lru_bwd["tp16"], lru_bwd["training"]),
    }


def hybrid_train_config(get_config):
    """recurrentgemma-9b's smoke config at d_model 256, 5 layers (a (rec, rec,
    attn) block and the (rec, rec) tail), 2 heads of 256 (the training
    attention's head dim) over one kv head, LRU width 256 and a 32-token
    window, which the 77-token sequences pass; in fp32."""
    return dataclasses.replace(
        get_config(HYB_TRAIN_ARCH).smoke(), d_model=256, n_heads=2, n_kv_heads=1,
        head_dim=256, d_ff=512, lru_width=256, attn_window=32, n_layers=HYB_TRAIN_LAYERS,
        param_dtype="float32", activation_dtype="float32")


def train_config(get_config, kv: int):
    """minicpm-2b's smoke config (tied embeddings, vocab 256) at d_model 256,
    2 layers of 4 heads of 64 (MHA at kv = 4, GQA at kv = 2), in fp32."""
    return dataclasses.replace(
        get_config(TRAIN_ARCH).smoke(), d_model=256, n_heads=4, n_kv_heads=kv, head_dim=64,
        d_ff=512, n_layers=2, param_dtype="float32", activation_dtype="float32")


def max_rel_err(got: dict, want: dict) -> float:
    """max over the names of max|got - want| / max|want|."""
    return max(float((got[n].detach().cpu() - w).abs().max()) / max(float(w.abs().max()), 1e-30)
               for n, w in want.items())


def narrow_train_batch(cfg) -> dict:
    """Two 77-token sequences of a narrow config's inputs on the CPU: tokens
    (and a VLM's image embeddings), or the encoder's frames and labels."""
    gen = torch.Generator().manual_seed(2)
    if cfg.family == "audio":
        return {"frames": torch.randn(2, 77, cfg.d_model, generator=gen),
                "labels": torch.randint(0, cfg.vocab, (2, 77), generator=gen)}
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 77), generator=gen)}
    if cfg.family == "vlm":
        batch["image_embeds"] = torch.randn(2, cfg.img_tokens, cfg.d_model, generator=gen)
    return batch


def grads_rel_err(got: dict, want: dict) -> tuple[float, dict]:
    """max_rel_err over the gradients, but a scalar leaf (a VLM cross gate)
    is held against the largest gradient of its block: its gradient is one
    sum over every position and width of tanh'(gate) att dh, which cancels
    far below its terms, so two fp32 orders of the sum may differ by more
    than 1e-4 of it (check_train_step prints how far the CPU's own fp32 sum
    lies from an fp64 one).  Returns the bar's max and each scalar leaf's
    error relative to itself, to print."""
    scalars = {n for n, w in want.items() if w.numel() == 1}
    worst = max_rel_err(got, {n: w for n, w in want.items() if n not in scalars})
    own = {}
    for n in scalars:
        err = float((got[n].detach().cpu() - want[n]).abs().max())
        block = n.rsplit(".", 2)[0] + "."  # blocks.i.
        scale = max(float(w.abs().max()) for m, w in want.items() if m.startswith(block))
        worst = max(worst, err / scale)
        own[n] = err / max(float(want[n].abs().max()), 1e-30)
    return worst, own


def check_train_step(lm, make_train_step, optim, ops, cfg, dev, want=None) -> dict:
    """Phase 3 model: the loss and every gradient of a narrow fp32 model on
    the card (the attention kernels, forward and backward, and the scans'
    where the model has them) against the same model on the CPU (plain
    versions), then one ``make_train_step`` on each, on
    ``narrow_train_batch``; a VLM's cross gates are opened to 0.5 first (at
    0 no gradient reaches its cross-attention).  ``want``: the
    launches of the card's loss and gradients, by default the dense
    model's (attention on the fma tilings, its forward twice under remat).
    The step uses SGD with momentum, whose update is linear in the gradient,
    so the parameters' bar follows from the gradients'; AdamW's update,
    about lr * sign(g) at step 0, turns a gradient entry within rounding of
    0 into a 2 lr difference, so AdamW is held on the card to the CPU's
    arithmetic on the same gradients instead."""
    m_cpu = lm.init(0, cfg, device="cpu")
    open_gates(m_cpu, 0.5)
    m_gpu = lm.init(0, cfg, device=dev)
    m_gpu.load_state_dict(m_cpu.state_dict())
    batch = narrow_train_batch(cfg)
    gpu_batch = {k: v.to(dev) for k, v in batch.items()}
    for m in (m_cpu, m_gpu):
        m.requires_grad_(True)
    def grads_of(loss, model) -> dict:  # a parameter the loss does not read gets 0, as in
        # make_train_step (a VLM cross block keeps the self norm it never reads)
        params = dict(model.named_parameters())
        got = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        return {n: torch.zeros_like(p) if g is None else g
                for (n, p), g in zip(params.items(), got)}

    lc, _ = lm.loss_fn(m_cpu, batch, cfg, loss_chunk=32)
    grads_cpu = grads_of(lc, m_cpu)
    for n in COUNTERS:
        setattr(ops, n, 0)
    lg, _ = lm.loss_fn(m_gpu, gpu_batch, cfg, loss_chunk=32)
    grads_gpu = grads_of(lg, m_gpu)
    torch.cuda.synchronize()
    counts = {n: getattr(ops, n) for n in COUNTERS}
    if want is None:
        want = dict(attention_launches=2 * cfg.n_layers, attention_fma_launches=2 * cfg.n_layers,
                    attention_bwd_launches=cfg.n_layers,  # remat "full": forward twice
                    attention_bwd_fma_launches=cfg.n_layers)  # fp32: exact products
    want = {n: want.get(n, 0) for n in COUNTERS}
    require(counts == want, f"narrow train step launches {counts}, want {want}")
    grads_err, own = grads_rel_err(grads_gpu, grads_cpu)
    if own:  # the scalar leaves' fp64 gradients on the CPU, to print beside their errors
        cfg64 = dataclasses.replace(cfg, param_dtype="float64", activation_dtype="float64")
        m64 = lm.init(0, cfg64, device="cpu")
        m64.load_state_dict(m_cpu.state_dict())
        m64.requires_grad_(True)
        l64, _ = lm.loss_fn(m64, {k: v.double() if v.is_floating_point() else v
                                  for k, v in batch.items()}, cfg64, loss_chunk=32)
        exact = grads_of(l64, m64)
        off = {n: {"card": abs(float(grads_gpu[n]) - float(exact[n])) / abs(float(exact[n])),
                   "CPU fp32": abs(float(grads_cpu[n]) - float(exact[n])) / abs(float(exact[n])),
                   "fp64 value": float(exact[n])} for n in own}
        del m64, l64, exact
    errs = {"loss": abs(float(lg.detach()) - float(lc.detach())) / abs(float(lc.detach())),
            "grads": grads_err}
    # AdamW's arithmetic on the card, on the CPU's gradients.
    opt = optim.adamw(optim.wsd(1e-3, 10))
    params_cpu = {n: p.detach().clone() for n, p in m_cpu.named_parameters()}
    params_gpu = {n: p.to(dev) for n, p in params_cpu.items()}
    state_cpu, state_gpu = opt.init(params_cpu), opt.init(params_gpu)
    for step in range(2):
        opt.update(grads_cpu, state_cpu, params_cpu, step)
        opt.update({n: g.to(dev) for n, g in grads_cpu.items()}, state_gpu, params_gpu, step)
    errs["adamw update, same grads"] = max_rel_err(params_gpu, params_cpu)
    # One train step each, SGD with momentum.
    sgd = optim.sgd_momentum(optim.constant(0.1))
    step_fn = make_train_step(cfg, sgd, loss_chunk=32)
    _, _, mc = step_fn(m_cpu, sgd.init(dict(m_cpu.named_parameters())), batch, 0)
    _, _, mg = step_fn(m_gpu, sgd.init(dict(m_gpu.named_parameters())), gpu_batch, 0)
    errs["step loss"] = abs(float(mg["loss"]) - float(mc["loss"])) / abs(float(mc["loss"]))
    errs["step grad_norm"] = (abs(float(mg["grad_norm"]) - float(mc["grad_norm"]))
                              / float(mc["grad_norm"]))
    errs["step params"] = max_rel_err(dict(m_gpu.named_parameters()),
                                      {n: p.detach() for n, p in m_cpu.named_parameters()})
    require(max(errs.values()) <= 1e-4, f"narrow train step, card vs CPU: {errs} (tol 1e-4)")
    if own:  # printed, not held: see grads_rel_err
        print(f"phase 3 model: the scalar leaves' gradients against their own size, card vs CPU: "
              f"{own}; each against the CPU's fp64 gradient: {off}")
    return errs


def check_dlrm_train_step(dlrm, dlrm_testbed, optim, ops, cfg, batch, dev) -> dict:
    """Phase 3 model: the loss and every gradient of a narrow fp32 DLRM on the
    card (the embedding bag's forward and backward kernels) against the same
    model on the CPU (plain versions), then one ``dlrm_testbed.make_step``
    (AdamW) on each.  Gradients within 1e-5 of each leaf's max; parameters
    within 1e-4, AdamW's g / (|g| + eps) moving a gradient entry within
    rounding of 0 by up to 2 lr."""
    from repro_torch.kernels.embedding_bag import bag_bwd_tiling

    m_cpu = dlrm.init(0, cfg, device="cpu")
    m_gpu = dlrm.init(0, cfg, device=dev)
    m_gpu.load_state_dict(m_cpu.state_dict())
    gpu_batch = {k: v.to(dev) for k, v in batch.items()}
    losses, grads = {}, {}
    for name, m, b in (("cpu", m_cpu, batch), ("card", m_gpu, gpu_batch)):
        m.requires_grad_(True)
        params = dict(m.named_parameters())
        for n in COUNTERS:
            setattr(ops, n, 0)
        loss, _ = dlrm.loss_fn(m, b, cfg)
        grads[name] = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        losses[name] = float(loss.detach())
    torch.cuda.synchronize()
    counts = {n: getattr(ops, n) for n in COUNTERS}
    tiling = f"bag_lookup_bwd_{bag_bwd_tiling(batch['sparse'].numel())}_launches"
    want = {n: int(n in ("bag_lookup_launches", "bag_lookup_bwd_launches", tiling))
            for n in COUNTERS}
    require(counts == want, f"narrow DLRM train step launches {counts}, want {want}")
    errs = {"loss": abs(losses["card"] - losses["cpu"]) / abs(losses["cpu"]),
            "grads": max_rel_err(grads["card"], grads["cpu"])}
    require(max(errs.values()) <= 1e-5, f"narrow DLRM loss and gradients, card vs CPU: {errs}")
    for m, b in ((m_cpu, batch), (m_gpu, gpu_batch)):
        opt = optim.adamw(optim.constant(DLRM_TRAIN_LR), weight_decay=0.0)
        dlrm_testbed.make_step(cfg, opt)(m, opt.init(dict(m.named_parameters())), b, 0)
    errs["adamw step params"] = max_rel_err(
        dict(m_gpu.named_parameters()), {n: p.detach() for n, p in m_cpu.named_parameters()})
    require(errs["adamw step params"] <= 1e-4, f"narrow DLRM AdamW step, card vs CPU: {errs}")
    return errs


def moe_train_config(get_config, capacity_factor: float):
    """qwen3-moe's smoke config (d_model 64, 4 experts of d_ff 32, top 2,
    vocab 256) at head dim 64 (the attention kernels' smallest), 2 layers,
    in fp32, at ``capacity_factor``."""
    return dataclasses.replace(
        get_config(MOE_TRAIN_ARCH).smoke(), head_dim=64, n_layers=2,
        capacity_factor=capacity_factor, param_dtype="float32", activation_dtype="float32")


def adamw_step_errs(got: dict, want: dict, grads: dict, lr: float, eps: float = 1e-8) -> dict:
    """Parameters after one AdamW step without weight decay, ``got`` (card)
    against ``want`` (CPU).  Its step-0 update is lr * g / (|g| + eps): where
    the CPU's gradient entry lies within the gradients' bar of 0 (1e-5 of its
    leaf's max) or near eps (below 100 eps), rounding alone moves that
    update by up to 2 lr, however the gradient was computed; there only that
    bound holds (``free``, in units of lr).  Elsewhere the update is settled
    by the gradients' agreement: ``settled`` is max|got - want| / max|want|
    over each leaf's other entries."""
    settled, free, n_free = 0.0, 0.0, 0
    for n, w in want.items():
        g = grads[n].abs()
        loose = (g <= 1e-5 * g.max()) | (g <= 100 * eps)
        diff = (got[n].detach().cpu() - w).abs()
        scale = max(float(w.abs().max()), 1e-30)
        settled = max(settled, float(torch.where(loose, 0.0, diff).max()) / scale)
        free = max(free, float(torch.where(loose, diff, 0.0).max()) / lr)
        n_free += int(loose.sum())
    return {"adamw step params": settled, "adamw step, entries with g within rounding of 0 "
            "(in lr)": free, "those entries": n_free}


def check_moe_train_step(lm, make_train_step, optim, ops, cfg, dev) -> dict:
    """Phase 3 model: the loss and every gradient of a narrow fp32 MoE on the
    card (the grouped matmul's forward and backward kernels, the attention
    kernels) against the same model on the CPU (plain versions), then one
    ``make_train_step`` (AdamW, lr 1e-3) on each.  Gradients within 1e-5 of
    each leaf's max; parameters within 1e-4 where the gradient settles
    AdamW's first update, and within its 2 lr bound on the entries whose
    gradient is within rounding of 0 (``adamw_step_errs``).  Two sequences
    of 77 tokens make C = capacity * 154 * 2 / 4 > 16 rows an expert, so
    every product runs a tiled kernel, not the skinny one."""
    m_cpu = lm.init(0, cfg, device="cpu")
    m_gpu = lm.init(0, cfg, device=dev)
    m_gpu.load_state_dict(m_cpu.state_dict())
    toks = torch.randint(0, cfg.vocab, (2, 77), generator=torch.Generator().manual_seed(5))
    batches = {"cpu": {"tokens": toks}, "card": {"tokens": toks.to(dev)}}
    require(int(cfg.capacity_factor * 2 * 77 * cfg.top_k / cfg.n_experts) > 16,
            "the narrow MoE step's capacity takes the tiled kernels")
    # The (token, expert) entries the capacity drops: the rows of each layer's
    # dispatch buffer (its gate and up products' input) that hold a token.
    kept, real = [], ops.grouped_matmul

    def capture(xb, w):
        if xb.shape[-1] == cfg.d_model:
            kept.append(int(xb.ne(0).any(dim=-1).sum()))
        return real(xb, w)

    ops.grouped_matmul = capture
    try:
        lm.forward(m_cpu, batches["cpu"], cfg)
    finally:
        ops.grouped_matmul = real
    dropped = toks.numel() * cfg.top_k * cfg.n_layers - sum(kept) // 2
    require((dropped > 0) == (cfg.capacity_factor <= 1.0),
            f"the narrow MoE step drops {dropped} entries at capacity {cfg.capacity_factor}")
    losses, grads = {}, {}
    for name, m in (("cpu", m_cpu), ("card", m_gpu)):
        m.requires_grad_(True)
        params = dict(m.named_parameters())
        for n in COUNTERS:
            setattr(ops, n, 0)
        loss, _ = lm.loss_fn(m, batches[name], cfg, loss_chunk=32)
        grads[name] = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        losses[name] = float(loss.detach())
    torch.cuda.synchronize()
    counts = {n: getattr(ops, n) for n in COUNTERS}
    L_ = cfg.n_layers
    want = {n: 0 for n in COUNTERS}  # fp32: the fma tilings; remat "full": forwards twice
    want.update(attention_launches=2 * L_, attention_fma_launches=2 * L_,
                attention_bwd_launches=L_, attention_bwd_fma_launches=L_,
                grouped_matmul_launches=6 * L_, grouped_matmul_fma_launches=6 * L_,
                grouped_matmul_bwd_launches=3 * L_, grouped_matmul_bwd_fma_launches=3 * L_)
    require(counts == want, f"narrow MoE train step launches {counts}, want {want}")
    errs = {"loss": abs(losses["card"] - losses["cpu"]) / abs(losses["cpu"]),
            "grads": max_rel_err(grads["card"], grads["cpu"]),
            "router grads": max_rel_err({n: g for n, g in grads["card"].items() if "router" in n},
                                        {n: g for n, g in grads["cpu"].items() if "router" in n})}
    require(max(errs.values()) <= 1e-5, f"narrow MoE loss and gradients, card vs CPU: {errs}")
    lr = 1e-3
    for m, b in ((m_cpu, batches["cpu"]), (m_gpu, batches["card"])):
        opt = optim.adamw(optim.constant(lr), weight_decay=0.0)
        make_train_step(cfg, opt, loss_chunk=32)(m, opt.init(dict(m.named_parameters())), b, 0)
    errs.update(adamw_step_errs(dict(m_gpu.named_parameters()),
                                {n: p.detach() for n, p in m_cpu.named_parameters()},
                                grads["cpu"], lr))
    require(errs["adamw step params"] <= 1e-4
            and errs["adamw step, entries with g within rounding of 0 (in lr)"] <= 2.0 + 1e-3,
            f"narrow MoE AdamW step, card vs CPU: {errs}")
    errs["dropped entries"] = dropped
    return errs


MAMBA_STEP_S = 77  # the narrow Mamba step's tokens a sequence: ragged, across the 8-step chunks


def check_mamba_train_step(lm, make_train_step, optim, ops, cfg, dev) -> dict:
    """Phase 3 model: the loss and every gradient (``a_log`` and ``d_skip``
    included) of a narrow fp32 Mamba on the card (the scan's forward and
    backward kernels) against the same model on the CPU (plain versions),
    then one ``make_train_step`` (AdamW, lr 1e-3) on each.  Gradients within
    1e-4 of each leaf's max; parameters within 1e-4 where the gradient
    settles AdamW's first update, and within its 2 lr bound on the entries
    whose gradient is within rounding of 0 (``adamw_step_errs``).  Remat
    "full": two forward launches a layer, one backward."""
    m_cpu = lm.init(0, cfg, device="cpu")
    m_gpu = lm.init(0, cfg, device=dev)
    m_gpu.load_state_dict(m_cpu.state_dict())
    toks = torch.randint(0, cfg.vocab, (2, MAMBA_STEP_S),
                         generator=torch.Generator().manual_seed(7))
    batches = {"cpu": {"tokens": toks}, "card": {"tokens": toks.to(dev)}}
    losses, grads = {}, {}
    for name, m in (("cpu", m_cpu), ("card", m_gpu)):
        m.requires_grad_(True)
        params = dict(m.named_parameters())
        for n in COUNTERS:
            setattr(ops, n, 0)
        loss, _ = lm.loss_fn(m, batches[name], cfg)
        grads[name] = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        losses[name] = float(loss.detach())
    torch.cuda.synchronize()
    counts = {n: getattr(ops, n) for n in COUNTERS}
    want = {n: 0 for n in COUNTERS}
    want.update(selective_scan_launches=2 * cfg.n_layers, selective_scan_bwd_launches=cfg.n_layers)
    require(counts == want, f"narrow Mamba train step launches {counts}, want {want}")
    require(any(n.endswith("a_log") for n in grads["cpu"])
            and any(n.endswith("d_skip") for n in grads["cpu"]),
            f"the narrow Mamba's leaves hold a_log and d_skip: {sorted(grads['cpu'])}")
    errs = {"loss": abs(losses["card"] - losses["cpu"]) / abs(losses["cpu"]),
            "grads": max_rel_err(grads["card"], grads["cpu"]),
            "a_log, d_skip grads": max_rel_err(
                {n: g for n, g in grads["card"].items() if n.endswith(("a_log", "d_skip"))},
                {n: g for n, g in grads["cpu"].items() if n.endswith(("a_log", "d_skip"))})}
    require(max(errs.values()) <= 1e-4, f"narrow Mamba loss and gradients, card vs CPU: {errs}")
    lr = 1e-3
    for m, b in ((m_cpu, batches["cpu"]), (m_gpu, batches["card"])):
        opt = optim.adamw(optim.constant(lr), weight_decay=0.0)
        make_train_step(cfg, opt)(m, opt.init(dict(m.named_parameters())), b, 0)
    errs.update(adamw_step_errs(dict(m_gpu.named_parameters()),
                                {n: p.detach() for n, p in m_cpu.named_parameters()},
                                grads["cpu"], lr))
    require(errs["adamw step params"] <= 1e-4
            and errs["adamw step, entries with g within rounding of 0 (in lr)"] <= 2.0 + 1e-3,
            f"narrow Mamba AdamW step, card vs CPU: {errs}")
    errs["launches"] = {n: c for n, c in counts.items() if c}
    return errs


def resume_check(train_loop, optim, cfg, dev) -> dict:
    """Phase 5 resume: ``train.loop.train`` on the card with a checkpoint
    every 2 steps and an injected failure at step 4, resumed to step 8,
    against an uninterrupted run; the checkpoints go to a temporary
    directory under ``build/`` and are removed."""
    import tempfile

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.parallel.sharding import ShardingPlan

    shape = ShapeSpec("resume", 64, 4, "train")
    opt = optim.adamw(optim.wsd(1e-3, 8))
    quiet = dict(plan=ShardingPlan(fsdp=False, loss_chunk=32), log_every=100,
                 logger=lambda *a: None, device=dev)
    whole = train_loop.train(cfg, shape, opt, total_steps=8, **quiet)
    root = Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=root) as ckpt_dir:
        try:
            train_loop.train(cfg, shape, opt, total_steps=8, ckpt_dir=ckpt_dir, ckpt_every=2,
                             fail_at=4, **quiet)
            raise RuntimeError("chip_smoke: the injected failure did not happen")
        except train_loop.InjectedFailure:
            pass
        resumed = train_loop.train(cfg, shape, opt, total_steps=8, ckpt_dir=ckpt_dir,
                                   ckpt_every=2, **quiet)
    require(resumed.final_step == 8 and len(resumed.losses) == 4,
            f"resumed from step 4: final {resumed.final_step}, {len(resumed.losses)} losses")
    errs = [abs(a - b) / abs(b) for a, b in zip(resumed.losses, whole.losses[4:])]
    require(max(errs) <= 1e-5, f"resumed losses {resumed.losses} vs {whole.losses[4:]}: {errs}")
    return dict(whole=whole.losses, resumed=resumed.losses, max_rel_err=max(errs))


def release(run: dict) -> dict:
    """``run`` without the model, optimizer state and batch that train_full
    hands on, with their memory given back to the card."""
    for key in ("model", "state", "opt", "step_fn", "batch"):
        run.pop(key)
    gc.collect()
    torch.cuda.empty_cache()
    return run


def model_flops(cfg, params: dict, B: int, S: int) -> tuple[float, float]:
    """The model FLOPs of one training step at B x S, and the parameters they
    count: 6 a token for each parameter that the token's products read, plus
    attention's 12 * B * heads * head dim for each (query, key) pair an
    attention layer keeps.  A token reads every parameter but the experts it
    is not routed to and, where the head is untied, the input embedding (a
    lookup, no product; the audio encoder has none): every non-expert
    parameter, and top_k / n_experts of the expert weights.  A VLM's cross
    layers project the image's ``img_tokens`` a sequence through wk and wv,
    not its S tokens, and keep S x img_tokens pairs.  Self-attention keeps
    the causal pairs (the hybrid: one attention layer a block, its window),
    the encoder's all S x S."""
    total = sum(p.numel() for p in params.values())
    experts = sum(p.numel() for n, p in params.items() if ".moe.w" in n)  # wg, wu, wd
    lookup = params["embed"].numel() if "embed" in params and not cfg.tie_embeddings else 0
    active = total - experts - lookup + (experts * cfg.top_k / cfg.n_experts if experts else 0)
    n_attn, w, n_cross, image_kv = cfg.n_layers, S, 0, 0
    if cfg.family == "hybrid":
        n_attn, w = cfg.n_layers // len(cfg.block_pattern), min(cfg.attn_window, S)
    if cfg.family == "vlm":
        cross = [i for i in range(cfg.n_layers) if i % cfg.cross_attn_every ==
                 cfg.cross_attn_every - 1]
        image_kv = sum(params[f"blocks.{i}.attn.{n}"].numel() for i in cross for n in ("wk", "wv"))
        n_attn, n_cross = cfg.n_layers - len(cross), len(cross)
    if cfg.family == "audio":
        pairs = S * S
    else:
        pairs = w * (w + 1) // 2 + (S - w) * w  # row q keeps min(q + 1, w) keys
    pairs = n_attn * pairs + n_cross * S * cfg.img_tokens
    tokens = 6.0 * B * ((active - image_kv) * S + image_kv * cfg.img_tokens)
    return tokens + 12.0 * B * cfg.n_heads * cfg.hd * pairs, active


def train_full(lm, ops, optim, make_train_step, data, cfg, dev, smi, phase: str, want: dict,
               probes, warmup: int = 0, loss0_tol: float = 0.5, batch: int = TRAIN_B,
               schedule: str = "wsd") -> dict:
    """Phases 5 and 5c-5g: trains ``cfg`` on the card (bf16, fp32 AdamW
    state, WSD or, with ``schedule="cosine"``, cosine with a one-step warm-up)
    for ``warmup`` + TRAIN_STEPS steps of ``batch_for_step`` at ``batch`` x
    TRAIN_S, then FIXED_STEPS steps on one fixed batch, with remat
    "full" and LOSS_CHUNK passed to lm.loss_fn.  Every count is set to 0 just before the first step
    and read just after the last of those runs; every one of those steps
    must launch ``want``, the ``probes`` parameters must change, and the first
    loss must lie within ``loss0_tol`` of ln V.  Returns
    the numbers of the run, with the model, its optimizer state and the
    fixed batch for a traced step."""
    gc.collect()
    torch.cuda.empty_cache()
    from repro_torch.configs.base import ShapeSpec

    t0 = time.perf_counter()
    model = lm.init(0, cfg, device=dev)
    total_steps = warmup + TRAIN_STEPS + FIXED_STEPS
    sched = (optim.wsd(TRAIN_LR, total_steps) if schedule == "wsd"
             else optim.cosine(TRAIN_LR, total_steps, warmup=1))
    opt = optim.adamw(sched)
    params = dict(model.named_parameters())
    state = opt.init(params)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.values())
    state_gb = sum(t.numel() * t.element_size() for group in state.values()
                   for t in group.values() if t.data_ptr() not in
                   {p.data_ptr() for p in params.values()}) / 1e9
    print(f"phase {phase} train: {cfg.name} ({cfg.n_layers} layers) init on the card: "
          f"{n_params} parameters ({cfg.param_dtype}, {n_params * 2 / 1e9} GB), AdamW state m, "
          f"v, fp32 master {state_gb} GB, in {time.perf_counter() - t0:.2f} s; batch {batch} x "
          f"{TRAIN_S}, remat full, loss_chunk {LOSS_CHUNK}, lr {TRAIN_LR} "
          f"({schedule})")
    step_fn = make_train_step(cfg, opt, remat="full", loss_chunk=LOSS_CHUNK)
    steps = warmup + TRAIN_STEPS
    spec = data.DataSpec(cfg=cfg, shape=ShapeSpec(f"train_4k_b{batch}", TRAIN_S, batch, "train"))
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in data.batch_for_step(spec, i).items()}
               for i in range(steps + 1)]
    probe = {n: params[n].detach().clone() for n in probes}
    torch.cuda.synchronize()

    for n in COUNTERS:
        setattr(ops, n, 0)
    torch.cuda.reset_peak_memory_stats()
    losses, norms, times, per_step = [], [], [], []
    for step in range(steps):
        before = {n: getattr(ops, n) for n in COUNTERS}
        t0 = time.perf_counter()
        _, _, metrics = step_fn(model, state, batches[step], step)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        per_step.append({n: getattr(ops, n) - before[n] for n in COUNTERS})
        print(f"phase {phase} train: step {step}{' (warm-up)' if step < warmup else ''} loss "
              f"{losses[-1]} grad_norm {norms[-1]} {times[-1] * 1e3} ms")
    counts = {n: getattr(ops, n) for n in COUNTERS}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    require(all(c == want for c in per_step), f"launches per step {per_step}, want {want}")
    require(all(math.isfinite(x) for x in losses + norms), f"finite losses {losses}, norms {norms}")
    ln_v = math.log(cfg.vocab)
    require(abs(losses[0] - ln_v) <= loss0_tol,
            f"step 0 loss {losses[0]} not within {loss0_tol} of ln V {ln_v}")
    changed = {n: float((params[n].detach() - t).abs().max()) for n, t in probe.items()}
    require(all(c > 0 for c in changed.values()), f"parameters changed: {changed}")

    timed = times[warmup:]
    step_ms = float(np.median(timed)) * 1e3
    tokens = batch * TRAIN_S
    flops, active = model_flops(cfg, params, batch, TRAIN_S)
    mfu = flops / (step_ms / 1e3) / PEAK_FLOPS[torch.bfloat16]
    print(f"phase {phase} train: {TRAIN_STEPS} steps after {warmup} warm-up, median {step_ms} ms "
          f"a step (min {min(timed) * 1e3}, max {max(timed) * 1e3}), {tokens / step_ms * 1e3} "
          f"tokens/s, model FLOPs {flops / 1e12} TFLOP a step (6 x {active} parameters a token "
          f"read x {tokens} tokens + attention"
          + (", the cross layers' wk and wv over the image's tokens" if cfg.family == "vlm" else "")
          + f"), {mfu} of 989 TFLOP/s, peak memory {peak_gb} GB, "
          f"launches per step {per_step[0]} (total {counts}), on {smi}")

    fixed = []
    for i in range(FIXED_STEPS):
        _, _, metrics = step_fn(model, state, batches[steps], steps + i)
        fixed.append(float(metrics["loss"]))
        if "aux" in metrics:  # the encoder's loss has none, as the reference's
            require(math.isfinite(float(metrics["aux"])), f"finite aux loss {metrics['aux']}")
    require(all(math.isfinite(x) for x in fixed) and fixed[-1] < fixed[0],
            f"{FIXED_STEPS} steps on one fixed batch lower its loss: {fixed}")
    print(f"phase {phase} train: {FIXED_STEPS} steps on one fixed batch, losses {fixed}")
    del params, probe
    return dict(losses=losses, grad_norms=norms, step_ms=step_ms,
                step_ms_all=[t * 1e3 for t in timed], tokens_per_s=tokens / step_ms * 1e3,
                mfu=mfu, model_tflop=flops / 1e12, active_params=active, peak_gb=peak_gb,
                launches_per_step=per_step[0], counts=counts, fixed_losses=fixed,
                n_params=n_params, model=model, state=state, opt=opt, step_fn=step_fn,
                batch=batches[steps], next_step=steps + FIXED_STEPS)


# Kernel-name patterns of the MoE training step's device-time split (phase
# 5c), tried in order before trace_train's groups: the grouped matmul's
# forward tilings, its backward, and the MoE's dispatch and combine (the
# gathers and the segment sum of layers.moe and their backward, the
# routing's scatters; the embedding's lookup shares their kernels; the
# routing's and the combine's integer sorts stay in the rest).
MOE_SPLIT = (
    ("grouped matmul forward", ("gmm_wgmma_kernel", "gmm_tiled_kernel", "gmm_skinny_kernel")),
    ("grouped matmul backward", ("gmm_bwd_",)),
    ("dispatch and combine", ("index", "Index", "gather", "scatter", "Scatter", "segment")),
)


def trace_train_step(lm, run: dict, cfg, group_of, phase: str, smi, rules=MOE_SPLIT,
                     groups=("attention forward", "attention backward", "cuBLAS GEMMs"),
                     want=None, head=None) -> dict:
    """One more step of ``run`` (train_full's) on its fixed batch under
    ``torch.profiler``: device time by part (``rules``' kernel-name patterns
    first, then trace_train's ``groups``; the rest apart), the idle share, and
    AdamW's update traced apart (its elementwise kernels are the same as the
    rest's) on the next step's gradients.  ``head``, if given, is (predicate,
    GEMM bound ms): the kernels launched in the same traced step by the
    operators for which ``predicate(name, input_shapes)`` holds form the loss
    head's part, its GEMMs and the rest apart, and come out of the GEMMs' and
    the rest's shares; a session whose head GEMMs took less than the bound
    (events dropped) is traced again."""
    model, state, opt, batch = run["model"], run["state"], run["opt"], run["batch"]
    step = run["next_step"]
    if want is None:
        want = (tuple(pats for _, pats in MOE_SPLIT[:2])
                + (("flash_attention_wgmma_kernel",), ("dkdv_wgmma_kernel",)))
    by_op: dict = {}
    head_kernels: dict = {}

    def head_gemm_ms(marked: dict) -> float:
        return sum(t for k, t in marked.items() if group_of(k) == "GEMM")

    mark = None if head is None else (head[0], lambda m: head_gemm_ms(m) >= head[1], head_kernels)
    traced_ms, kernels = profiled(lambda i: run["step_fn"](model, state, batch, step + i), want,
                                  ops=by_op, mark=mark)
    params = dict(model.named_parameters())
    with torch.enable_grad():
        total, _ = lm.loss_fn(model, batch, cfg, remat="full", loss_chunk=LOSS_CHUNK)
        got = torch.autograd.grad(total, list(params.values()), allow_unused=True)
        grads = {n: torch.zeros_like(p) if g is None else g  # a VLM cross block's self norm
                 for (n, p), g in zip(params.items(), got)}
    del total
    _, adamw_kernels = profiled(lambda i: opt.update(grads, state, params, step + 3 + i))
    adamw = sum(adamw_kernels.values())
    del grads
    busy = sum(kernels.values())
    split = {name: 0.0 for name, _ in rules} | {g: 0.0 for g in groups}
    if head is not None:
        split["loss head"] = sum(head_kernels.values())
    other = {}
    for k, t in kernels.items():
        t -= head_kernels.get(k, 0.0)  # the head's launches of this kernel, counted above
        part = next((name for name, pats in rules if any(p in k for p in pats)), None)
        group = group_of(k)
        if part is None and group != "other":
            part = "cuBLAS GEMMs" if group == "GEMM" else group
        if part in split:
            split[part] += t
        else:
            other[k] = t
    split["AdamW (traced apart)"] = adamw
    split["rest"] = sum(other.values()) - adamw
    idle = 1.0 - busy / traced_ms
    head_gemm = head_gemm_ms(head_kernels)
    print(f"phase {phase} trace: one step {traced_ms} ms traced wall, {busy} ms device busy, idle "
          f"{idle:.4f}; " + ", ".join(f"{k} {v} ms ({v / busy:.2%})" for k, v in split.items())
          + (f" (the loss head: GEMMs {head_gemm} ms against their {head[1]} ms bound, the rest "
             f"{split['loss head'] - head_gemm} ms)" if head is not None else "")
          + f"; on {smi}")
    top = sorted(other.items(), key=lambda kv: -kv[1])[:10]
    print(f"phase {phase} trace: the kernels of AdamW and the rest that took the most device "
          "time: " + "; ".join(f"{short_name(k)} {t} ms" for k, t in top))
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:12]
    print(f"phase {phase} trace: the step's device time by the operator that launched it, the "
          "most first: " + "; ".join(f"{k} {t} ms" for k, t in top))
    return dict(traced_ms=traced_ms, busy_ms=busy, idle_share=idle, split_ms=split,
                head_gemm_ms=head_gemm if head is not None else None)


# The host operators a GSPMD step adds (torch.profiler's CPU event names):
# DTensor's autograd functions (Redistribute, to_local's _ToTorchTensor,
# from_local's _FromTorchTensor, and their backward nodes) and the
# collectives' operators (c10d, functional collectives, NCCL's records).
DTENSOR_HOST = ("Redistribute", "TorchTensor")
COLLECTIVE_HOST = ("c10d", "nccl", "record_param_comms")


def trace_host_split(fn, want=(), tries: int = 3) -> dict:
    """``fn(i)`` (i the attempt) under ``torch.profiler``, retried up to
    ``tries`` times while the session saw no kernel named like one of each
    tuple of ``want`` (the profiler drops events now and then) -> the traced
    host wall ms, the device busy ms and idle share, the NCCL kernels'
    launches and device ms, and, by operator name, the calls and inclusive
    host ms of DTENSOR_HOST's and COLLECTIVE_HOST's operators (the backward
    nodes themselves, not the engine's ``evaluate_function`` frames around
    them, so nothing is counted twice), with their sums (without
    ``NestedRedistribute``, which runs inside ``RedistributeBackward``), and
    the 12 operators of most self host time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for i in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn(i)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = prof.key_averages()
        kernels = {e.key: (e.count, e.self_device_time_total / 1e3) for e in events
                   if e.device_type == DeviceType.CUDA}
        if kernels and all(any(p in k for k in kernels for p in alts) for alts in want):
            break
    else:
        require(False, f"the profiler saw kernels named like each of {want} in {tries} "
                       f"sessions: {sorted(kernels)}")
    cpu = [e for e in events if e.device_type == DeviceType.CPU]

    def host(patterns) -> dict:
        return {e.key: (e.count, e.cpu_time_total / 1e3) for e in cpu
                if any(p in e.key for p in patterns)
                and not e.key.startswith("autograd::engine::evaluate_function")}

    busy = sum(t for _, t in kernels.values())
    nccl = [(c, t) for k, (c, t) in kernels.items() if "nccl" in k.lower()]
    dtensor, collectives = host(DTENSOR_HOST), host(COLLECTIVE_HOST)
    top = sorted(cpu, key=lambda e: -e.self_cpu_time_total)[:12]
    return dict(traced_ms=wall_ms, busy_ms=busy, idle_share=1.0 - busy / wall_ms,
                nccl_launches=sum(c for c, _ in nccl), nccl_ms=sum(t for _, t in nccl),
                dtensor_host=dtensor,
                dtensor_host_ms=sum(t for k, (_, t) in dtensor.items() if not k.startswith("Nested")),
                dtensor_calls=sum(c for k, (c, _) in dtensor.items() if not k.startswith("Nested")),
                collectives_host=collectives,
                collectives_host_ms=sum(t for _, t in collectives.values()),
                top_self_host=[(e.key, e.count, e.self_cpu_time_total / 1e3) for e in top])


def loss_head_ops(cfg, batch: int = TRAIN_B, chunk: int = TRAIN_S):
    """(predicate, GEMM bound ms) of the loss head of a ``batch`` x TRAIN_S
    step of ``cfg`` with the CE over ``chunk`` positions at a time (TRAIN_S:
    the full CE), for trace_train_step: its operators are those that read a
    tensor of a chunk's logits' size (the logits, their fp32 copy, their
    gradients; the two backward products read one) and the product with an
    operand shaped as the head (the logits' forward, and its recomputation
    under the chunked CE); the bound is the three products of the whole
    sequence at the bf16 peak.  A tensor shaped as the head or the embedding
    counts only in a product: the VLM's chunk of 4 x 1024 logits has the
    size of its (4096, 128256) head, which AdamW and the grad norm read too."""
    logits = batch * chunk * cfg.vocab
    weights = ([cfg.d_model, cfg.vocab], [cfg.vocab, cfg.d_model])

    def numel(shape) -> int:  # 0 for a scalar or a list of tensors
        return math.prod(shape) if shape and all(isinstance(d, int) for d in shape) else 0

    def predicate(name: str, shapes) -> bool:
        return (any(numel(s) == logits and s not in weights for s in shapes)
                or (name == "aten::mm" and [cfg.d_model, cfg.vocab] in shapes))

    flops = 3 * 2.0 * batch * TRAIN_S * cfg.vocab * cfg.d_model
    return predicate, flops / PEAK_FLOPS[torch.bfloat16] * 1e3


def train_ssm(lm, ops, optim, make_train_step, data, group_of, cfg, dev, smi) -> dict:
    """Phase 5d: trains ``cfg`` (falcon-mamba-7b at full width and a cut
    depth; the training state of all 64 layers, about 116 GB, does not fit
    one card) through train_full, each step with two forward scan launches a
    layer (remat "full" runs each layer's forward twice) and one backward,
    then traces one step; the model is freed before it returns.  The untied
    head lifts the first loss, as qwen3-moe's does: a bar of 1 rather than
    0.5.  Returns the numbers of the run."""
    t0 = time.perf_counter()
    L_ = cfg.n_layers
    want = {n: 0 for n in COUNTERS}
    want.update(selective_scan_launches=2 * L_, selective_scan_bwd_launches=L_)
    run = train_full(lm, ops, optim, make_train_step, data, cfg, dev, smi, "5d", want,
                     ("embed", "lm_head", "blocks.0.w_in", "blocks.0.a_log", "blocks.0.d_skip",
                      f"blocks.{L_ - 1}.w_out", "final_norm"),
                     warmup=SSM_WARMUP, loss0_tol=1.0)
    trace = trace_train_step(lm, run, cfg, group_of, "5d", smi, rules=(),
                             groups=("selective scan forward", "selective scan backward",
                                     "cuBLAS GEMMs"),
                             want=(("mamba_scan_kernel",), ("mamba_bwd_kernel",)),
                             head=loss_head_ops(cfg))
    trained = release(run)
    summary = {k: trained[k] for k in ("n_params", "active_params", "step_ms", "tokens_per_s",
                                        "model_tflop", "mfu", "peak_gb")}
    summary.update(trace)
    wall_s = time.perf_counter() - t0
    print(f"phase 5d summary: {json.dumps(summary)} in {wall_s:.2f} s, on {smi}")
    return dict(trained, trace=trace, wall_s=wall_s)


def train_hybrid(lm, ops, optim, make_train_step, data, group_of, cfg, dev, smi) -> dict:
    """Phase 5e: trains ``cfg`` (recurrentgemma-9b at full width and a cut
    depth; the training state of all 38 layers, about 167 GB, does not fit
    one card) at HYB_TRAIN_B x TRAIN_S through train_full, each step with two
    forward RG-LRU launches a recurrent layer (remat "full" runs each
    layer's forward twice) and one backward, two forward attention launches
    an attention layer and one backward, all on the wgmma tilings; the
    reference's cosine schedule and full CE.  Then traces one step; the
    model is freed before it returns.  The untied head lifts the first loss,
    as falcon-mamba's does: a bar of 1.  Returns the numbers of the run."""
    t0 = time.perf_counter()
    n_attn = cfg.n_layers // len(cfg.block_pattern)
    n_rec = cfg.n_layers - n_attn
    want = {n: 0 for n in COUNTERS}
    want.update(lru_scan_launches=2 * n_rec, lru_scan_bwd_launches=n_rec,
                attention_launches=2 * n_attn, attention_wgmma_launches=2 * n_attn,
                attention_bwd_launches=n_attn, attention_bwd_wgmma_launches=n_attn)
    run = train_full(lm, ops, optim, make_train_step, data, cfg, dev, smi, "5e", want,
                     ("embed", "lm_head", "layers.0.rec.w_x", "layers.0.rec.lambda_p",
                      "layers.2.attn.wq", f"layers.{cfg.n_layers - 1}.mlp.wd", "final_norm"),
                     warmup=HYB_WARMUP, loss0_tol=1.0, batch=HYB_TRAIN_B, schedule="cosine")
    trace = trace_train_step(lm, run, cfg, group_of, "5e", smi, rules=(),
                             groups=("RG-LRU forward", "RG-LRU backward", "attention forward",
                                     "attention backward", "cuBLAS GEMMs"),
                             want=(("lru_fwd_kernel",), ("lru_bwd_kernel",),
                                   ("flash_attention_wgmma_kernel",), ("dkdv_wgmma_kernel",)),
                             head=loss_head_ops(cfg, HYB_TRAIN_B))
    trained = release(run)
    summary = {k: trained[k] for k in ("n_params", "active_params", "step_ms", "tokens_per_s",
                                        "model_tflop", "mfu", "peak_gb")}
    summary.update(trace)
    wall_s = time.perf_counter() - t0
    print(f"phase 5e summary: {json.dumps(summary)} in {wall_s:.2f} s, reduced: layers 38 -> "
          f"{cfg.n_layers}, global batch 256 -> {HYB_TRAIN_B} (sequence {TRAIN_S} kept), on {smi}")
    return dict(trained, trace=trace, wall_s=wall_s)


def train_vlm_or_encoder(lm, ops, optim, make_train_step, data, group_of, cfg, dev, smi,
                         phase: str, reduced: str) -> dict:
    """Phases 5f and 5g: trains ``cfg`` (llama-3.2-vision-11b at full width
    and a cut depth, or hubert-xlarge whole) at TRAIN_B x TRAIN_S through
    train_full with the config's cosine schedule, remat "full" and
    LOSS_CHUNK (the encoder's CE over its 504 classes is never chunked, as
    in the reference).  Every step launches two forward attention kernels a
    self layer (remat "full" runs it twice), one a VLM cross layer (not
    rematerialized, as in the reference) and one backward a layer, all on
    the wgmma tilings.  The VLM's cross gates start at 0, so no gradient
    reaches a cross layer's wk before the gate has moved: its gate and wk
    are among the probes that must change.  The untied head lifts the
    first loss (logits of variance near 0.8 at init: about 0.4 above ln V);
    the VLM's probes of the chunked loss include the head, and its bar is 1,
    as for the other untied heads; the encoder's is 0.5.  Then traces one
    step, the loss head apart; the model is freed before it returns.
    ``reduced`` names the cuts.  Returns the numbers of the run."""
    t0 = time.perf_counter()
    L_ = cfg.n_layers
    n_cross = L_ // cfg.cross_attn_every if cfg.family == "vlm" else 0
    fwd = 2 * (L_ - n_cross) + n_cross
    want = {n: 0 for n in COUNTERS}
    want.update(attention_launches=fwd, attention_wgmma_launches=fwd,
                attention_bwd_launches=L_, attention_bwd_wgmma_launches=L_)
    if cfg.family == "vlm":
        x0 = cfg.cross_attn_every - 1  # the first cross layer
        probes = ("embed", "lm_head", "blocks.0.attn.wq", f"blocks.{x0}.attn.wk",
                  f"blocks.{x0}.attn.gate", f"blocks.{L_ - 1}.attn.wv", "final_norm")
        loss0_tol, head = 1.0, loss_head_ops(cfg, chunk=LOSS_CHUNK)
    else:
        probes = ("lm_head", "blocks.0.attn.wq", "blocks.0.mlp.w1", f"blocks.{L_ - 1}.mlp.w2",
                  "final_norm")
        loss0_tol, head = 0.5, loss_head_ops(cfg)
    run = train_full(lm, ops, optim, make_train_step, data, cfg, dev, smi, phase, want, probes,
                     warmup=2, loss0_tol=loss0_tol, schedule=cfg.schedule)
    trace = trace_train_step(lm, run, cfg, group_of, phase, smi, rules=(),
                             groups=("attention forward", "attention backward", "cuBLAS GEMMs"),
                             want=(("flash_attention_wgmma_kernel",
                                    "flash_attention_d80_wgmma_kernel"),
                                   ("dkdv_wgmma_kernel", "dkdv_d80_wgmma_kernel")),
                             head=head)
    trained = release(run)
    summary = {k: trained[k] for k in ("n_params", "active_params", "step_ms", "tokens_per_s",
                                        "model_tflop", "mfu", "peak_gb")}
    summary.update(trace)
    wall_s = time.perf_counter() - t0
    print(f"phase {phase} summary: {json.dumps(summary)} in {wall_s:.2f} s, reduced: {reduced}, "
          f"on {smi}")
    return dict(trained, trace=trace, wall_s=wall_s)


def serve_decode_twin(arch: str, smi) -> str:
    """Runs ``python -m repro_torch.launch.serve_decode --arch ARCH`` (the twin
    of ``examples/serve_decode.py``, on the card by default) in a process of
    its own; it must exit 0 and print the example's tokens/s line last.
    Returns that line."""
    root = Path(__file__).resolve().parent
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_decode", "--arch", arch],
        capture_output=True, text=True, timeout=300, cwd=root,
        env={**os.environ, "PYTHONPATH": str(root / "src")},
    )
    lines = proc.stdout.strip().splitlines()
    require(proc.returncode == 0 and lines and lines[-1].startswith(f"{arch} (smoke): ")
            and lines[-1].endswith(")") and "tok/s" in lines[-1],
            f"serve_decode --arch {arch}: exit {proc.returncode}, stdout {proc.stdout[-2000:]!r}, "
            f"stderr {proc.stderr[-2000:]!r}")
    print(f"phase 5e serve_decode: python -m repro_torch.launch.serve_decode --arch {arch}: exit "
          f"0, {lines[-1]!r}, on {smi}")
    return lines[-1]


def topoopt_twin(ops, train_lm_topoopt, smi) -> dict:
    """Phase 7b: the twin of ``examples/train_lm_topoopt.py`` at world size 1
    on the card (no ``torch.distributed.run`` environment).  ``python -m
    repro_torch.launch.train_lm_topoopt --steps 60 --ckpt-dir DIR`` in a
    process of its own, then the same with ``--steps 80``, which resumes from
    the step-50 checkpoint: both exit 0 with finite losses, and the last loss
    lies below the first.  Then its ``main`` in this process for 3 steps,
    every count set to 0 just before and read just after: each step launches
    2 forward (remat "full") and 1 backward attention kernel a layer, all on
    the fma tilings at head dim 32, and no other kernel.  The checkpoints go
    to a temporary directory under ``build/`` and are removed."""
    import io
    import re
    import tempfile

    root = Path(__file__).resolve().parent
    (root / "build").mkdir(exist_ok=True)
    env = {k: v for k, v in os.environ.items() if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env["PYTHONPATH"] = str(root / "src")
    runs = []
    with tempfile.TemporaryDirectory(dir=root / "build") as ckpt_dir:
        for steps in TWIN_STEPS:
            cmd = [sys.executable, "-m", "repro_torch.launch.train_lm_topoopt", "--steps",
                   str(steps), "--ckpt-dir", ckpt_dir]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600, cwd=root,
                                  env=env)
            wall_s = time.perf_counter() - t0
            require(proc.returncode == 0, f"train_lm_topoopt --steps {steps}: exit "
                    f"{proc.returncode}, stdout {proc.stdout[-2000:]!r}, stderr "
                    f"{proc.stderr[-2000:]!r}")
            logged = [(int(m[1]), float(m[2]), float(m[3])) for m in
                      re.finditer(r"step +(\d+) loss (\S+) \((\d+) ms/step\)", proc.stdout)]
            final = re.search(r"final loss: (\S+)", proc.stdout)
            resumed = re.search(r"resumed from step (\d+)", proc.stdout)
            require(logged and final, f"train_lm_topoopt --steps {steps} printed {proc.stdout!r}")
            runs.append(dict(steps=steps, wall_s=wall_s, logged=logged, final=float(final[1]),
                             resumed=int(resumed[1]) if resumed else None))
            print(f"phase 7b twin: python -m repro_torch.launch.train_lm_topoopt --steps {steps} "
                  f"--ckpt-dir <tmp>: exit 0 in {wall_s:.2f} s (its process's start and the "
                  f"libraries' load included): {proc.stdout.strip().splitlines()!r}, on {smi}")
    losses = [x[1] for r in runs for x in r["logged"]] + [r["final"] for r in runs]
    require(runs[0]["resumed"] is None and runs[1]["resumed"] == 50,
            f"the second run resumes from step 50: {runs}")
    require(all(math.isfinite(x) for x in losses), f"finite twin losses {losses}")
    first, last = runs[0]["logged"][0][1], runs[1]["final"]
    require(last < first, f"the twin's last loss {last} lies below its first {first}")

    out = io.StringIO()
    for n in COUNTERS:
        setattr(ops, n, 0)
    with contextlib.redirect_stdout(out):
        train_lm_topoopt.main(["--steps", "3"])
    torch.cuda.synchronize()
    counts = {n: getattr(ops, n) for n in COUNTERS}
    layers_ = 8  # the example's --n-layers default
    want = {n: 0 for n in COUNTERS}
    want.update(attention_launches=3 * 2 * layers_, attention_fma_launches=3 * 2 * layers_,
                attention_bwd_launches=3 * layers_, attention_bwd_fma_launches=3 * layers_)
    require(counts == want, f"the twin's 3 steps launched {counts}, want {want}")
    ms_step = runs[0]["logged"][-1][2]
    print(f"phase 7b twin: losses {runs[0]['logged'][0][1]} (step 0) -> {runs[0]['final']} "
          f"(step 59) -> {last} (step 79, resumed from 50); {ms_step} ms a step (the twin's "
          f"mean over steps 0-{runs[0]['logged'][-1][0]}, its first step included); its main() "
          f"here, 3 steps: launches {counts}; on {smi}")
    return dict(first_loss=first, last_loss=last, ms_per_step=ms_step,
                wall_s=[r["wall_s"] for r in runs], counts=counts)


def dp_step_check(lm, ops, optim, data, train_steps, compression, device_order, cfg, dev, smi,
                  au_step_ms: float) -> dict:
    """Phase 7c: the §6 trainer at world size 1 and full width: ``cfg``
    (hubert-xlarge whole) at TRAIN_B x TRAIN_S, phase 5g's shape.  Two steps
    of ``make_train_step`` (remat "full"), then two of
    ``make_shardmap_dp_train_step`` on a one-rank mesh from the same seed
    and batches, once with the ring schedule and once with the int8
    ``Compressor``: the losses and every parameter equal the plain step's to
    the bit (a sync over one rank is the identity, and /1 is exact).  Only
    one model lives on the card at a time: the plain run's parameters wait
    on the host.  Every count is set to 0 just before each DP run and read
    just after; each step launches 2 forward and 1 backward attention kernel
    a layer, all wgmma.  Each step's time is printed beside phase 5g's
    median."""
    from repro_torch.configs.base import ShapeSpec

    spec = data.DataSpec(cfg=cfg, shape=ShapeSpec("dp", TRAIN_S, TRAIN_B, "train"))
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in data.batch_for_step(spec, i).items()}
               for i in range(2)]
    mesh = device_order.topoopt_mesh((1,), ("data",))
    L_ = cfg.n_layers
    want = {n: 0 for n in COUNTERS}
    want.update(attention_launches=2 * L_, attention_wgmma_launches=2 * L_,
                attention_bwd_launches=L_, attention_bwd_wgmma_launches=L_)

    def run(kind):
        gc.collect()
        torch.cuda.empty_cache()
        model = lm.init(0, cfg, device=dev)
        opt = optim.adamw(optim.cosine(TRAIN_LR, 2, warmup=1))
        state = opt.init(dict(model.named_parameters()))
        comp = compression.Compressor() if kind == "compressed" else None
        if kind == "plain":
            step = train_steps.make_train_step(cfg, opt, remat="full")
        else:
            step = train_steps.make_shardmap_dp_train_step(cfg, opt, mesh, ring_strides=(1,),
                                                           compressor=comp, schedule="ring")
        residual = train_steps.init_compressor_residual(comp, model) if comp else None
        torch.cuda.synchronize()
        for n in COUNTERS:
            setattr(ops, n, 0)
        losses, times, per_step = [], [], []
        for i, batch in enumerate(batches):
            before = {n: getattr(ops, n) for n in COUNTERS}
            t0 = time.perf_counter()
            if kind == "plain":
                loss = step(model, state, batch, i)[2]["loss"]
            else:
                _, _, loss, residual = step(model, state, batch, i, residual)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss.detach().cpu())
            per_step.append({n: getattr(ops, n) - before[n] for n in COUNTERS})
        counts = {n: getattr(ops, n) for n in COUNTERS}
        params = {n: p.detach().cpu() for n, p in model.named_parameters()}
        del model, state, residual, step
        return dict(losses=losses, params=params, step_ms=times, per_step=per_step,
                    counts=counts)

    plain = run("plain")
    out = {"plain_step_ms": plain["step_ms"], "phase_5g_step_ms": au_step_ms}
    total = {n: 0 for n in COUNTERS}
    for kind in ("ring", "compressed"):
        got = run(kind)
        require(all(c == want for c in got["per_step"]),
                f"DP step ({kind}) launches per step {got['per_step']}, want {want}")
        same_loss = all(torch.equal(a, b) for a, b in zip(got["losses"], plain["losses"]))
        differ = [n for n, p in plain["params"].items() if not torch.equal(got["params"][n], p)]
        require(same_loss and not differ,
                f"DP step ({kind}) vs make_train_step: losses {got['losses']} vs "
                f"{plain['losses']}, parameters that differ {differ[:5]} of {len(differ)}")
        print(f"phase 7c dp: {cfg.name} whole at {TRAIN_B} x {TRAIN_S}, "
              f"make_shardmap_dp_train_step ({kind}, world size 1) vs make_train_step, 2 steps "
              f"from seed 0: losses {[float(x) for x in got['losses']]} equal to the bit, all "
              f"{len(plain['params'])} parameters equal to the bit; step ms {got['step_ms']} "
              f"(make_train_step {plain['step_ms']}, phase 5g's median {au_step_ms}); launches "
              f"per step {got['per_step'][0]}; on {smi}")
        out[f"{kind}_step_ms"] = got["step_ms"]
        total = {n: total[n] + got["counts"][n] for n in COUNTERS}
        del got
    gc.collect()
    torch.cuda.empty_cache()
    return dict(out, counts=total, plain=plain, batches=batches, want=want)


def gspmd_step_check(lm, ops, optim, train_steps, sharding, device_order, cfg, dev, smi,
                     dp: dict) -> dict:
    """Phase 7d: the GSPMD/FSDP trainer at world size 1 and full width:
    ``jit_train_step`` under ``ShardingPlan(fsdp=True)`` on a (1, 1)
    ("data", "model") mesh over a one-rank NCCL group, ``cfg`` (hubert-xlarge
    whole) drawn block by block into its layouts from seed 0, two steps on
    phase 7c's batches: the losses and every parameter equal phase 7c's
    ``make_train_step`` run to the bit (every gather, reduce-scatter and mean
    is over one rank).  Every count is set to 0 just before the run and read
    just after; each step launches 2 forward and 1 backward wgmma attention
    kernels a layer.  Each step's time is printed beside phase 7c's.  Then
    a plain model from the same seed joins it on the card, and the two
    steps (``make_train_step`` and the GSPMD one, on phase 7c's first batch)
    are timed in GSPMD_TURNS alternating turns, so both see the same host,
    and one step of each is traced (trace_host_split): where the GSPMD
    step's extra time goes, idle device or device work, DTensor's host
    operators or collectives.  Then ``python -m repro_torch.launch.train
    --arch hubert-xlarge --mesh cpu --seq-len 4096 --global-batch 4 --steps
    3`` in a process of its own must exit 0."""
    import torch.distributed as dist

    plain = dp["plain"]
    gc.collect()
    torch.cuda.empty_cache()
    opt = optim.adamw(optim.cosine(TRAIN_LR, 2, warmup=1))  # phase 7c's
    mesh = device_order.Mesh(np.zeros((1, 1), dtype=np.int64), ("data", "model"))
    try:
        step, (_, _, p_layouts, o_layouts, _) = train_steps.jit_train_step(
            cfg, opt, sharding.ShardingPlan(fsdp=True), mesh, device=dev)
        model = lm.init(0, cfg, device=dev, place=sharding.placer(p_layouts))
        state = train_steps.init_opt_state(opt, model, o_layouts)
        torch.cuda.synchronize()
        for n in COUNTERS:
            setattr(ops, n, 0)
        losses, times, per_step = [], [], []
        for i, batch in enumerate(dp["batches"]):
            before = {n: getattr(ops, n) for n in COUNTERS}
            t0 = time.perf_counter()
            loss = step(model, state, batch, i)[2]["loss"]
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss.detach().cpu())
            per_step.append({n: getattr(ops, n) - before[n] for n in COUNTERS})
        counts = {n: getattr(ops, n) for n in COUNTERS}
        params = {n: p.detach().full_tensor().cpu()
                  for n, p in sharding.parameters(model).items()}
        split = gspmd_turns(lm, train_steps, opt, cfg, dev, (model, state, step),
                            dp["batches"][0], smi)
        del model, state, step
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    require(all(c == dp["want"] for c in per_step),
            f"GSPMD step launches per step {per_step}, want {dp['want']}")
    same_loss = all(torch.equal(a, b) for a, b in zip(losses, plain["losses"]))
    differ = [n for n, p in plain["params"].items() if not torch.equal(params[n], p)]
    require(same_loss and not differ and sorted(params) == sorted(plain["params"]),
            f"GSPMD step vs make_train_step: losses {losses} vs {plain['losses']}, "
            f"parameters that differ {differ[:5]} of {len(differ)}")
    print(f"phase 7d gspmd: {cfg.name} whole at {TRAIN_B} x {TRAIN_S}, jit_train_step "
          f"(ShardingPlan(fsdp=True), (1, 1) data x model mesh, one-rank NCCL group) vs "
          f"make_train_step, 2 steps from seed 0: losses {[float(x) for x in losses]} equal to "
          f"the bit, all {len(params)} parameters equal to the bit; step ms {times} "
          f"(phase 7c: make_train_step {plain['step_ms']}, ring {dp['ring_step_ms']}); "
          f"launches per step {per_step[0]}; on {smi}")
    del params
    gc.collect()
    torch.cuda.empty_cache()

    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", cfg.name, "--mesh", "cpu",
           "--seq-len", str(TRAIN_S), "--global-batch", str(TRAIN_B), "--steps", "3"]
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=600)
    wall_s = time.perf_counter() - t0
    done = [ln for ln in proc.stdout.splitlines() if ln.startswith("done: step=3")]
    require(proc.returncode == 0 and len(done) == 1,
            f"{' '.join(cmd[1:])}: exit {proc.returncode}\n{proc.stdout[-2000:]}"
            f"\n{proc.stderr[-3000:]}")
    print(f"phase 7d cli: python {' '.join(cmd[1:])}: exit 0 in {wall_s:.2f} s (its process's "
          f"start, the model's init and 3 steps): {done[0]}")
    return dict(step_ms=times, counts=counts, cli_wall_s=wall_s, **split)


def gspmd_moe_check(lm, ops, optim, data, train_steps, sharding, device_order, cfg, dev, smi,
                    want: dict, moe_step_ms: float) -> dict:
    """Phase 7e: the GSPMD trainer on the MoE at 5c's depth and batch:
    ``cfg`` (qwen3-moe-30b-a3b at 4 layers) at TRAIN_B x TRAIN_S, two steps
    of 5c's plain step (``make_train_step``, remat "full", LOSS_CHUNK, 5c's
    AdamW and WSD schedule) on 5c's first two batches, then two of
    ``jit_train_step`` under ``ShardingPlan(fsdp=True)`` on a (1, 1)
    ("data", "model") mesh over a one-rank NCCL group, the model drawn block
    by block into its layouts from the same seed: losses and every parameter
    equal to the bit, under deterministic algorithms so that the embedding's
    gradient is summed in one order in both runs.  One model lives on the
    card at a time (the plain run's parameters wait on the host).  Every
    count is set to 0 just before the GSPMD run and read just after; each
    step launches ``want`` (5c's).  Each step's time and each run's peak
    memory are printed beside 5c's median."""
    import torch.distributed as dist
    from repro_torch.configs.base import ShapeSpec

    spec = data.DataSpec(cfg=cfg, shape=ShapeSpec(f"train_4k_b{TRAIN_B}", TRAIN_S, TRAIN_B,
                                                  "train"))
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in data.batch_for_step(spec, i).items()}
               for i in range(2)]
    total_steps = MOE_WARMUP + TRAIN_STEPS + FIXED_STEPS  # 5c's schedule

    def run(kind):
        gc.collect()
        torch.cuda.empty_cache()
        opt = optim.adamw(optim.wsd(TRAIN_LR, total_steps))
        if kind == "plain":
            model = lm.init(0, cfg, device=dev)
            state = opt.init(dict(model.named_parameters()))
            step = train_steps.make_train_step(cfg, opt, remat="full", loss_chunk=LOSS_CHUNK)
        else:
            mesh = device_order.Mesh(np.zeros((1, 1), dtype=np.int64), ("data", "model"))
            plan = sharding.ShardingPlan(fsdp=True, remat="full", loss_chunk=LOSS_CHUNK)
            step, (_, _, p_layouts, o_layouts, _) = train_steps.jit_train_step(
                cfg, opt, plan, mesh, device=dev)
            model = lm.init(0, cfg, device=dev, place=sharding.placer(p_layouts))
            state = train_steps.init_opt_state(opt, model, o_layouts)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for n in COUNTERS:
            setattr(ops, n, 0)
        losses, times, per_step = [], [], []
        for i, batch in enumerate(batches):
            before = {n: getattr(ops, n) for n in COUNTERS}
            t0 = time.perf_counter()
            loss = step(model, state, batch, i)[2]["loss"]
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss.detach().cpu())
            per_step.append({n: getattr(ops, n) - before[n] for n in COUNTERS})
        counts = {n: getattr(ops, n) for n in COUNTERS}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        params = {n: p.detach().full_tensor().cpu() if kind == "gspmd" else p.detach().cpu()
                  for n, p in sharding.parameters(model).items()}
        del model, state, step
        return dict(losses=losses, params=params, step_ms=times, per_step=per_step,
                    counts=counts, peak_gb=peak_gb)

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        plain = run("plain")
        got = run("gspmd")
    finally:
        torch.use_deterministic_algorithms(False)
        if dist.is_initialized():
            dist.destroy_process_group()
    for kind, r in (("plain", plain), ("GSPMD", got)):
        require(all(c == want for c in r["per_step"]),
                f"{kind} step launches per step {r['per_step']}, want {want}")
    same_loss = all(torch.equal(a, b) for a, b in zip(got["losses"], plain["losses"]))
    differ = [n for n, p in plain["params"].items() if not torch.equal(got["params"][n], p)]
    require(same_loss and not differ and sorted(got["params"]) == sorted(plain["params"]),
            f"GSPMD MoE step vs make_train_step: losses {got['losses']} vs {plain['losses']}, "
            f"parameters that differ {differ[:5]} of {len(differ)}")
    print(f"phase 7e gspmd: {cfg.name} ({cfg.n_layers} layers) at {TRAIN_B} x {TRAIN_S}, "
          f"jit_train_step (ShardingPlan(fsdp=True), (1, 1) data x model mesh, one-rank NCCL "
          f"group) vs 5c's make_train_step, 2 steps from seed 0 under deterministic algorithms: "
          f"losses {[float(x) for x in got['losses']]} equal to the bit, all "
          f"{len(plain['params'])} parameters equal to the bit; step ms {got['step_ms']} (plain "
          f"{plain['step_ms']}; phase 5c's median {moe_step_ms}), peak memory {got['peak_gb']} "
          f"GB (plain {plain['peak_gb']} GB); launches per step {got['per_step'][0]}; on {smi}")
    return dict(step_ms=got["step_ms"], plain_step_ms=plain["step_ms"],
                phase_5c_step_ms=moe_step_ms, peak_gb=got["peak_gb"],
                plain_peak_gb=plain["peak_gb"], counts=got["counts"],
                losses=[float(x) for x in got["losses"]])


GSPMD_TURNS = 4  # phase 7d's alternating turns of the plain and the GSPMD step
DRYRUN_CELLS = (("qwen3-moe-30b-a3b", "train_4k"), ("granite-8b", "decode_32k"))  # phase 8b
# Phase 8a: dryrun_cell on 7e's cell, in a process of its own; prints the record.
_DRYRUN_7E = """
import dataclasses, json, sys
import numpy as np
from repro_torch.configs.base import ShapeSpec, get_config
from repro_torch.core.device_order import Mesh
from repro_torch.launch.dryrun import dryrun_cell
from repro_torch.launch.mesh import fake_world
from repro_torch.parallel.sharding import ShardingPlan
arch, layers, batch, seq, chunk = sys.argv[1:6]
fake_world(1)
cfg = dataclasses.replace(get_config(arch), n_layers=int(layers))
rec = dryrun_cell(cfg, ShapeSpec("train_4k_b" + batch, int(seq), int(batch), "train"),
                  Mesh(np.zeros((1, 1), dtype=np.int64), ("data", "model")),
                  ShardingPlan(fsdp=True, remat="full", loss_chunk=int(chunk)))
print(json.dumps(rec))
"""


def dryrun_check(want: dict, gspmd_moe: dict, smi: str) -> dict:
    """Phase 8: the dry run, each run in a process of its own (its fake
    process group cannot share a process with an NCCL group).  (a)
    ``dryrun_cell`` on 7e's cell: qwen3-moe-30b-a3b at 4 layers, TRAIN_B x
    TRAIN_S, ``ShardingPlan(fsdp=True, remat="full", loss_chunk=LOSS_CHUNK)``
    on a (1, 1) mesh: its launches by kernel equal to ``want`` (7e's a
    step), its predicted peak within 10% of 7e's measured peak, its
    roofline step time printed beside 7e's step ms.  (b) ``python -m
    repro_torch.launch.dryrun`` on each of DRYRUN_CELLS on the single pod:
    exit 0 and one OK line each.  The three processes run at once."""
    root = Path(__file__).resolve().parent
    env = {k: v for k, v in os.environ.items() if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env["PYTHONPATH"] = str(root / "src")
    t0 = time.perf_counter()
    cmds = [[sys.executable, "-c", _DRYRUN_7E, MOE_TRAIN_ARCH, str(MOE_TRAIN_LAYERS),
             str(TRAIN_B), str(TRAIN_S), str(LOSS_CHUNK)]]
    cmds += [[sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
              "--mesh", "single", "--out", str(root / "build" / "dryrun")]
             for arch, shape in DRYRUN_CELLS]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              cwd=root, env=env) for cmd in cmds]
    outs = []
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=600)
            outs.append((proc.returncode, out, err))
    finally:
        for proc in procs:  # stop every process this phase started
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall = time.perf_counter() - t0
    rc, out, err = outs[0]
    require(rc == 0, f"phase 8a dry run exited {rc}: {err[-3000:]}")
    rec = json.loads(out.splitlines()[-1])
    launches = {n: rec["launches"].get(n, 0) for n in want}
    require(launches == want, f"phase 8a dry-run launches {launches}, 7e's a step {want}")
    peak_gb = rec["memory"]["peak_size_in_bytes"] / 1e9
    peak_err = abs(peak_gb - gspmd_moe["peak_gb"]) / gspmd_moe["peak_gb"]
    require(peak_err <= 0.10, f"phase 8a predicted peak {peak_gb} GB vs 7e's measured "
                              f"{gspmd_moe['peak_gb']} GB: {peak_err:.1%} off, more than 10%")
    r = rec["roofline"]
    print(f"phase 8a dry run: dryrun_cell on 7e's cell ({MOE_TRAIN_ARCH}, {MOE_TRAIN_LAYERS} "
          f"layers, {TRAIN_B} x {TRAIN_S}, fsdp, (1, 1) mesh) on meta tensors (phase 8's three "
          f"processes in {wall:.2f} s): launches equal to 7e's a step; "
          f"predicted peak {peak_gb} GB (held {rec['memory']['argument_size_in_bytes'] / 1e9} "
          f"GB + the step's own {rec['memory']['temp_size_in_bytes'] / 1e9} GB) vs 7e's "
          f"measured {gspmd_moe['peak_gb']} GB, {peak_err:.2%} off; roofline step "
          f"{r['step_time_s'] * 1e3} ms ({r['dominant']}: compute {r['compute_s'] * 1e3} ms, "
          f"memory {r['memory_s'] * 1e3} ms; estimates from the card's published peaks) vs "
          f"7e's measured step ms {gspmd_moe['step_ms']}; product FLOPs "
          f"{rec['hlo']['flops_per_dev']}, bytes {rec['hlo']['bytes_per_dev']}, useful "
          f"{r['useful_fraction']}; on {smi}")
    cli = []
    for (arch, shape), (rc, out, err) in zip(DRYRUN_CELLS, outs[1:]):
        ok = [line for line in out.splitlines() if line.startswith("OK ")]
        require(rc == 0 and len(ok) == 1, f"phase 8b dry run of {arch} {shape} exited {rc}: "
                                          f"{out[-2000:]}{err[-3000:]}")
        cli.append(ok[0])
        print(f"phase 8b dry run CLI: {ok[0]} (256 fake ranks; roofline terms are estimates "
              f"from the card's published peaks); on {smi}")
    return dict(peak_gb=peak_gb, measured_peak_gb=gspmd_moe["peak_gb"], peak_err=peak_err,
                roofline_step_ms=r["step_time_s"] * 1e3, measured_step_ms=gspmd_moe["step_ms"],
                cli=cli)


def mesh_serve_check(train_steps, sharding, device_order, ops, model, tokens, plain: dict,
                     dev, smi, label: str) -> dict:
    """Phase 7f: ``model``, already on the card and just served by ``label``'s
    phase (4 or 4b), placed on a (1, 1) ("data", "model") mesh over a
    one-rank NCCL group under ``ShardingPlan(fsdp=True)`` (no second copy:
    each weight is freed as its shard replaces it) and served through
    ``train_steps.jit_serve_step``: prefill padded to PROMPT + DECODE_STEPS,
    then DECODE_STEPS - 1 greedy decode steps, after one short warm-up.
    Every count is set to 0 just before the prefill and read just after it
    and after the loop.  The logits, the ids and the launches must equal
    ``plain``'s (the phase's ``served`` run: ``ids``, ``logits``, ``pre``,
    ``dec``, ``timings``) to the bit.  Returns the times beside the plain
    run's, the peak memory and the counts.  Leaves no process group."""
    import torch.distributed as dist
    from repro_torch.configs.base import ShapeSpec

    cfg = model.cfg
    mesh = device_order.Mesh(np.zeros((1, 1), dtype=np.int64), ("data", "model"))
    plan = sharding.ShardingPlan(fsdp=True)
    T = PROMPT + DECODE_STEPS
    try:
        prefill, (_, p_layouts, _) = train_steps.jit_serve_step(
            cfg, ShapeSpec("prefill", PROMPT, B, "prefill"), plan, mesh, device=dev, pad_to=T)
        decode, _ = train_steps.jit_serve_step(cfg, ShapeSpec("decode", T, B, "decode"), plan,
                                               mesh, device=dev)
        sharding.place(model, p_layouts)
        warm, cache = prefill(model, {"tokens": tokens[:, :64]})  # NCCL, DTensor's caches
        decode(model, {"token": warm.argmax(-1), "pos": 64, "cache": cache})
        del warm, cache
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for n in COUNTERS:
            setattr(ops, n, 0)
        t0 = time.perf_counter()
        logits, cache = prefill(model, {"tokens": tokens})
        tok = logits.argmax(dim=-1)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        pre = {n: getattr(ops, n) for n in COUNTERS}
        seen, ids = [logits], [tok]
        t0 = time.perf_counter()
        for i in range(DECODE_STEPS - 1):
            logits, cache = decode(model, {"token": tok, "pos": PROMPT + i, "cache": cache})
            tok = logits.argmax(dim=-1)
            seen.append(logits)
            ids.append(tok)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        counts = {n: getattr(ops, n) for n in COUNTERS}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        placements = sorted({str(t.placements) for t in cache.values()})
        del cache
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    dec = {n: counts[n] - pre[n] for n in COUNTERS}
    differ = [i for i, (a, b) in enumerate(zip(seen, plain["logits"])) if not torch.equal(a, b)]
    require(len(seen) == len(plain["logits"]) and not differ,
            f"{cfg.name} jit_serve_step vs the plain serve: logits of steps {differ} differ")
    require(torch.equal(torch.stack(ids, dim=1), plain["ids"]),
            f"{cfg.name} jit_serve_step's generated ids differ from the plain serve's")
    require(pre == plain["pre"] and dec == plain["dec"],
            f"{cfg.name} jit_serve_step launches {pre} + {dec}, plain {plain['pre']} + "
            f"{plain['dec']}")
    out = {
        "prefill_ms": prefill_s * 1e3,
        "decode_ms_per_token": decode_s / (DECODE_STEPS - 1) * 1e3,
        "plain_prefill_ms": plain["timings"]["prefill_s"] * 1e3,
        "plain_decode_ms_per_token": plain["timings"]["decode_s"] / (DECODE_STEPS - 1) * 1e3,
        "peak_gb": peak_gb, "counts": counts,
    }
    print(f"phase 7f mesh serve: {cfg.name} ({label}'s model, placed) through jit_serve_step on "
          f"a (1, 1) mesh: {B}x{PROMPT} prefill {out['prefill_ms']} ms (plain "
          f"{out['plain_prefill_ms']} ms), decode {out['decode_ms_per_token']} ms/token over "
          f"{DECODE_STEPS - 1} steps (plain {out['plain_decode_ms_per_token']} ms/token), peak "
          f"memory {peak_gb} GB; logits of {len(seen)} steps and ids equal to {label}'s to the "
          f"bit; launches: prefill {pre}, decode loop {dec}; cache placements {placements}; on "
          f"{smi}")
    return out


def gspmd_turns(lm, train_steps, opt, cfg, dev, gspmd: tuple, batch: dict, smi) -> dict:
    """Phase 7d's comparison within one run: a plain model from seed 0 (its
    own state, ``make_train_step``, remat "full") beside ``gspmd`` (model,
    state, step), each step timed in GSPMD_TURNS turns of plain then GSPMD
    on ``batch``, then one step of each traced (trace_host_split).  The
    plain model is freed before it returns."""
    model, state, step = gspmd
    plain_model = lm.init(0, cfg, device=dev)
    plain_state = opt.init(dict(plain_model.named_parameters()))
    plain_step = train_steps.make_train_step(cfg, opt, remat="full")
    runs = {"plain": lambda i: plain_step(plain_model, plain_state, batch, 2 + i),
            "gspmd": lambda i: step(model, state, batch, 2 + i)}
    turns = {k: [] for k in runs}
    for t in range(GSPMD_TURNS):
        for kind, fn in runs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(t)
            torch.cuda.synchronize()
            turns[kind].append((time.perf_counter() - t0) * 1e3)
    want = (("flash_attention_wgmma_kernel", "flash_attention_d80_wgmma_kernel"),
            ("dkdv_wgmma_kernel", "dkdv_d80_wgmma_kernel"))
    traces = {kind: trace_host_split(lambda i, fn=fn: fn(GSPMD_TURNS + i), want)
              for kind, fn in runs.items()}
    del plain_model, plain_state, plain_step, runs
    gc.collect()
    torch.cuda.empty_cache()
    med = {k: float(np.median(v)) for k, v in turns.items()}
    print(f"phase 7d turns: {cfg.name} at {TRAIN_B} x {TRAIN_S}, {GSPMD_TURNS} turns of "
          f"make_train_step then jit_train_step (world size 1) on one batch: plain ms "
          f"{turns['plain']}, GSPMD ms {turns['gspmd']}; medians {med['plain']} and "
          f"{med['gspmd']} ({med['gspmd'] / med['plain'] - 1:+.2%}); on {smi}")
    for kind, tr in traces.items():
        print(f"phase 7d trace ({kind}): one step {tr['traced_ms']} ms traced wall, "
              f"{tr['busy_ms']} ms device busy, idle {tr['idle_share']:.4f}; NCCL "
              f"{tr['nccl_launches']} launches, {tr['nccl_ms']} ms; DTensor's host operators "
              f"{tr['dtensor_calls']} calls, {tr['dtensor_host_ms']} ms inclusive "
              f"({tr['dtensor_host_ms'] / tr['traced_ms']:.2%} of the wall): "
              + "; ".join(f"{k} {c} calls {t} ms" for k, (c, t) in tr["dtensor_host"].items())
              + f"; collectives' host operators {tr['collectives_host_ms']} ms: "
              + "; ".join(f"{k} {c} calls {t} ms"
                          for k, (c, t) in tr["collectives_host"].items())
              + f"; on {smi}")
        print(f"phase 7d trace ({kind}): the operators of most self host time: "
              + "; ".join(f"{k} {c} calls {t} ms" for k, c, t in tr["top_self_host"]))
    return dict(turns_ms=turns, turn_medians_ms=med,
                traces={k: {f: v for f, v in tr.items() if f not in ("dtensor_host",
                                                                     "collectives_host",
                                                                     "top_self_host")}
                        for k, tr in traces.items()})


def train_dlrm_paper(dlrm, dlrm_testbed, optim, ops, group_of, dev, smi) -> dict:
    """Phase 5b: trains the paper's DLRM (``paper_config(T_TRAIN_DLRM)``) on the
    freed card through ``dlrm_testbed.train_dlrm`` for DLRM_WARMUP +
    DLRM_TIMED steps, with every count set to 0 just before and read just
    after; then DLRM_FIXED steps of a fresh AdamW on one fixed batch, whose
    loss must fall, and one step under ``torch.profiler``, whose split names
    the bag backward's bookkeeping (``BAG_BWD_BOOKKEEPING``: the sorted
    tiling's keys and sort, none on the small tiling) apart.  Returns the
    numbers of the run."""
    from repro_torch.kernels.embedding_bag import bag_bwd_tiling

    gc.collect()
    torch.cuda.empty_cache()
    cfg = dlrm.paper_config(T_TRAIN_DLRM)
    steps = DLRM_WARMUP + DLRM_TIMED
    for n in COUNTERS:
        setattr(ops, n, 0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run = dlrm_testbed.train_dlrm(cfg, steps, DLRM_TRAIN_B, DLRM_TRAIN_LR, seed=0, device=dev)
    wall_s = time.perf_counter() - t0
    counts = {n: getattr(ops, n) for n in COUNTERS}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = {n: 0 for n in COUNTERS}
    bwd_tiling = f"bag_lookup_bwd_{bag_bwd_tiling(DLRM_TRAIN_B * T_TRAIN_DLRM)}_launches"
    want.update({"bag_lookup_launches": steps, "bag_lookup_bwd_launches": steps,
                 bwd_tiling: steps})
    require(counts == want, f"{DLRM_TRAIN_PATH} launches {counts}, want {want}")
    require(all(math.isfinite(x) for x in run.losses), f"finite losses {run.losses}")
    model = run.model
    n_params = sum(p.numel() for p in model.parameters())
    times = run.step_s[DLRM_WARMUP:]
    step_ms = float(np.median(times)) * 1e3
    print(f"phase 5b train: {DLRM_TRAIN_PATH}: tables {tuple(model.tables.shape)} fp32, "
          f"{n_params} parameters, batch {DLRM_TRAIN_B}, AdamW lr {DLRM_TRAIN_LR}; {steps} "
          f"steps in {wall_s:.2f} s with the init; losses {run.losses}")
    print(f"phase 5b train: {DLRM_TIMED} steps after {DLRM_WARMUP} warm-up, median {step_ms} ms "
          f"a step (min {min(times) * 1e3}, max {max(times) * 1e3}), "
          f"{DLRM_TRAIN_B / step_ms * 1e3} samples/s, peak memory {peak_gb} GB, launches a "
          f"step: bag_lookup {counts['bag_lookup_launches'] / steps}, bag_lookup_bwd "
          f"{counts['bag_lookup_bwd_launches'] / steps} ({bwd_tiling} {counts[bwd_tiling]}; "
          f"total {counts}), on {smi}")
    del run

    opt = optim.adamw(optim.constant(DLRM_TRAIN_LR), weight_decay=0.0)
    params = dict(model.named_parameters())
    state = opt.init(params)
    step = dlrm_testbed.make_step(cfg, opt)
    batch = dlrm_testbed.draw_batch(np.random.default_rng(1), cfg, DLRM_TRAIN_B, dev)
    fixed, per_step = [], []
    for i in range(DLRM_FIXED):
        before = {n: getattr(ops, n) for n in COUNTERS}
        fixed.append(float(step(model, state, batch, i)))
        per_step.append({n: getattr(ops, n) - before[n] for n in COUNTERS
                         if getattr(ops, n) != before[n]})
    one_each = {"bag_lookup_launches": 1, "bag_lookup_bwd_launches": 1, bwd_tiling: 1}
    require(all(c == one_each for c in per_step), f"launches per fixed step {per_step}")
    require(all(math.isfinite(x) for x in fixed) and fixed[-1] < fixed[0],
            f"{DLRM_FIXED} steps on one fixed batch lower its loss: {fixed}")
    print(f"phase 5b train: {DLRM_FIXED} steps on one fixed batch, losses {fixed}")

    # One step's device time by part.  The tables' AdamW runs the same
    # elementwise kernels as the MLPs', so it is traced apart: its update
    # alone on the next step's gradient.
    traced_ms, kernels = profiled(lambda i: step(model, state, batch, DLRM_FIXED + i),
                                  (("embedding_bag_kernel",), BAG_BWD_KERNELS, FILL_KERNELS))
    with torch.enable_grad():
        loss, _ = dlrm.loss_fn(model, batch, cfg)
        (g,) = torch.autograd.grad(loss, [params["tables"]])
    del loss
    _, adamw_kernels = profiled(lambda i: opt.update(
        {"tables": g}, state, {"tables": params["tables"]}, DLRM_FIXED + 3 + i))
    tables_adamw = sum(adamw_kernels.values())
    del g
    busy = sum(kernels.values())
    split = {"tables' AdamW (traced apart)": tables_adamw,
             "zero fill": named_ms(kernels, *FILL_KERNELS),
             "MLP GEMMs": sum(t for k, t in kernels.items() if group_of(k) == "GEMM"),
             "embedding_bag": named_ms(kernels, "embedding_bag_kernel"),
             "embedding_bag_bwd": named_ms(kernels, *BAG_BWD_KERNELS),
             "embedding_bag_bwd bookkeeping": bag_bwd_bookkeeping_ms(kernels)}
    split["rest"] = busy - sum(split.values())
    idle = 1.0 - busy / traced_ms
    print(f"phase 5b trace: one step {traced_ms} ms traced wall, {busy} ms device busy, idle "
          f"{idle:.4f}; " + ", ".join(f"{k} {v} ms ({v / busy:.2%})" for k, v in split.items())
          + f"; on {smi}")
    del model, params, state, batch, step
    gc.collect()
    torch.cuda.empty_cache()
    return dict(n_params=n_params, step_ms=step_ms, step_ms_all=[t * 1e3 for t in times],
                samples_per_s=DLRM_TRAIN_B / step_ms * 1e3, peak_gb=peak_gb, counts=counts,
                steps=steps, fixed_losses=fixed, traced_ms=traced_ms, busy_ms=busy,
                idle_share=idle, split_ms=split)


def check_attention_dims(gen, dev, smi) -> dict:
    """Phase 3 dims: each of NEW_HEAD_DIMS, which the kernels compute at a
    wider width, against the plain version on DIMS_RAGGED (the forward, its
    lse and the backward of wgmma and fma on bf16 inputs and of fma on fp32
    ones; two launches of each the same bits), then timed at DIMS_TIMED on
    both tilings beside the bound and SDPA (``check_attention_fwd`` and
    ``check_attention_bwd``, which hold it to the plain version there too).
    Returns the numbers by head dim."""
    from repro_torch.kernels.flash_attention import (
        compute_width, flash_attention, flash_attention_bwd,
    )
    from repro_torch.kernels.ref import ref_flash_attention, ref_flash_attention_lse

    out = {}
    for dh in NEW_HEAD_DIMS:
        errs = {}
        for Bc, h, kv, Sq, Sk, causal, window in DIMS_RAGGED:
            for tiling, dtype in (("wgmma", torch.bfloat16), ("fma", torch.bfloat16),
                                  ("fma", torch.float32)):
                q = torch.randn(Bc, h, Sq, dh, generator=gen, device=dev).to(dtype)
                k, v = (torch.randn(Bc, kv, Sk, dh, generator=gen, device=dev).to(dtype)
                        for _ in "kv")
                do = torch.randn(Bc, h, Sq, dh, generator=gen, device=dev).to(dtype)
                lse = torch.empty(Bc, h, Sq, dtype=torch.float32, device=dev)
                o = flash_attention(q, k, v, causal=causal, window=window, tiling=tiling, lse=lse)
                grads = flash_attention_bwd(q, k, v, o, lse, do, causal, window, tiling=tiling)
                again = (flash_attention(q, k, v, causal=causal, window=window, tiling=tiling),
                         *flash_attention_bwd(q, k, v, o, lse, do, causal, window, tiling=tiling))
                torch.cuda.synchronize()
                label = (f"D={dh} width={compute_width(tiling, dh)} tiling={tiling} "
                         f"{str(dtype)[6:]} B={Bc} H={h} KV={kv} Sq={Sq} Sk={Sk} causal={causal} "
                         f"window={window}")
                require(all(torch.equal(a, b) for a, b in zip(again, (o, *grads))),
                        f"two launches bitwise equal, {label}")
                ref = ref_flash_attention(q, k, v, causal=causal, window=window)
                want = plain_attention_grads(ref_flash_attention, q, k, v, do, causal, window)
                tol = TOL[dtype]
                err = {"o": float((o.float() - ref.float()).abs().max()),
                       "lse": float((lse - ref_flash_attention_lse(q, k, v, causal, window))
                                    .abs().max())}
                require(bool(torch.isfinite(o).all()) and err["o"] <= tol * max(
                    1.0, float(ref.float().abs().max())), f"forward vs plain, {label}: {err}")
                require(err["lse"] <= 1e-4 * max(1.0, float(lse.abs().max())),
                        f"lse vs plain, {label}: {err}")
                for name, got, w in zip(("dq", "dk", "dv"), grads, want):
                    err[name] = float((got.float() - w).abs().max())
                    require(bool(torch.isfinite(got).all())
                            and err[name] <= tol * max(1.0, float(w.abs().max())),
                            f"{name} vs autograd of plain, {label}: {err}")
                errs[label] = err
                del q, k, v, do, lse, o, grads, again, ref, want
        Bc, h, kv, S = DIMS_TIMED
        fwd = check_attention_fwd((S, S, dh, torch.bfloat16, True, 0, kv, h), gen, dev, smi,
                                  batch=Bc, phase="3 dims")
        bwd = check_attention_bwd((Bc, h, kv, S, dh, torch.bfloat16, True), gen, dev, smi,
                                  phase="3 dims")
        worst = max(max(e.values()) for e in errs.values())
        print(f"phase 3 dims: head dim {dh} (wgmma width {compute_width('wgmma', dh)}, fma "
              f"width {compute_width('fma', dh)}): {len(errs)} ragged cases on both tilings "
              f"within the bars (largest max|err| {worst}); at B={Bc} H={h} KV={kv} S={S} "
              f"causal bf16: forward {fwd['kernel_ms']} ms (fma {fwd['fma_ms']}, SDPA "
              f"{fwd['library_ms']}, bound {fwd['bound_ms']}), backward {bwd['kernel_ms']} ms "
              f"(fma {bwd['fma_kernel_ms']}, SDPA {bwd['library_ms']}, bound {bwd['bound_ms']}) "
              f"on {smi}")
        out[dh] = dict(ragged_max_abs_err=worst, fwd=fwd, bwd=bwd)
        torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def cpu_drawn_weights(lm):
    """Within the block, ``lm.init`` draws a model's weights on the CPU from
    its seed and copies them in before each block is placed, on any device:
    a card draws another stream from a seed than the CPU, and phase 9 holds
    the card's run to the CPU's on the same weights."""
    real = lm.init

    def init(seed, cfg, device=None, place=None):
        state = real(seed, cfg, "cpu").state_dict()

        def copy_then_place(module, prefix):
            with torch.no_grad():
                for name, p in module.named_parameters():
                    if prefix + name in state and not hasattr(p, "placements"):
                        p.copy_(state[prefix + name])
            return module if place is None else place(module, prefix)

        return real(seed, cfg, device, copy_then_place)

    lm.init = init
    try:
        yield
    finally:
        lm.init = real


def zero_counts(ops) -> None:
    for n in COUNTERS:
        setattr(ops, n, 0)


def rel_err(got, want) -> float:
    """max|got - want| / max|want| in fp32 (phase 3's measure without its
    floor of 1: the smoke models' gradients are far below 1)."""
    want = want.float()
    return float((got.float() - want).abs().max()) / max(float(want.abs().max()), 1e-30)


def hold_attention(a, out) -> dict:
    from repro_torch.kernels.ref import ref_flash_attention, ref_flash_attention_lse

    q, k, v, causal, window = a["q"], a["k"], a["v"], a["causal"], a["window"]
    errs = {"o": (rel_err(out, ref_flash_attention(q, k, v, causal=causal, window=window)),
                  TOL[q.dtype])}
    if a["lse"] is not None:
        errs["lse"] = (rel_err(a["lse"], ref_flash_attention_lse(q, k, v, causal, window)), 1e-4)
    return errs


def hold_attention_bwd(a, out) -> dict:
    from repro_torch.kernels.ref import ref_flash_attention

    with torch.enable_grad():  # called from within the backward
        want = plain_attention_grads(ref_flash_attention, a["q"], a["k"], a["v"], a["do"],
                                     a["causal"], a["window"])
    return {n: (rel_err(g, w), TOL[a["q"].dtype]) for n, g, w in zip(("dq", "dk", "dv"), out, want)}


def hold_gmm(a, out) -> dict:
    from repro_torch.kernels.ref import ref_moe_gmm

    return {"out": (rel_err(out, ref_moe_gmm(a["x"], a["w"])), TOL[a["x"].dtype])}


def hold_gmm_bwd(a, out) -> dict:
    from repro_torch.kernels.ref import ref_moe_gmm_bwd

    want = ref_moe_gmm_bwd(a["x"], a["w"], a["dy"])
    return {n: (rel_err(g, w), TOL[a["x"].dtype])
            for n, g, w in zip(("dx", "dw"), out, want) if g is not None}


def hold_lru(a, out) -> dict:
    from repro_torch.kernels.ref import ref_rglru_scan

    # fp32 arithmetic from the same inputs in both: phase 3's bar.
    return {n: (rel_err(g, w), 1e-5)
            for n, g, w in zip(("h_all", "h_final"), out, ref_rglru_scan(a["a"], a["b"]))}


# The kernel wrappers whose every call phase 9 holds, each under the modules
# that call it (ops on inference, the kernel's autograd Function in its own
# module), and the check that holds a call to the plain version.
HELD = (
    ("flash_attention", ("ops", "flash_attention"), "flash_attention", hold_attention),
    ("flash_attention_bwd", ("flash_attention",), "flash_attention_bwd", hold_attention_bwd),
    ("moe_gmm", ("ops", "moe_gmm"), "moe_gmm", hold_gmm),
    ("moe_gmm_bwd", ("moe_gmm",), "moe_gmm_bwd", hold_gmm_bwd),
    ("rglru_scan", ("ops",), "rglru_scan", hold_lru),
)


@contextlib.contextmanager
def held_calls(held: dict, what: str, tamper=None):
    """Within the block, each wrapper of HELD holds every call, as it
    returns and before its caller sees the outputs, to the plain version on
    the same inputs: each output's max|err| / max|ref| within its bar (TOL
    of the inputs' dtype; lse 1e-4, the RG-LRU scan 1e-5), else it raises.
    ``held[wrapper]`` counts the calls and keeps the largest error.  The
    launches are the run's own, counted once, by the wrapper; the plain
    versions launch no kernel of the port.  ``tamper`` ({wrapper:
    fn(outputs) -> outputs}) alters what a wrapper returns to its caller,
    after the check: phase 9's controls."""
    import importlib
    import inspect

    tamper = tamper or {}
    saved = []
    for label, modules, attr, check in HELD:
        for m in modules:
            mod = importlib.import_module(f"repro_torch.kernels.{m}")
            real = getattr(mod, attr)

            def keep(*args, _real=real, _sig=inspect.signature(real), _label=label,
                     _check=check, **kw):
                out = _real(*args, **kw)
                bound = _sig.bind(*args, **kw)
                bound.apply_defaults()
                a = bound.arguments
                with torch.no_grad():
                    errs = _check(a, out)
                rec = held.setdefault(_label, {"calls": 0, "max_err": 0.0})
                rec["calls"] += 1
                for name, (err, bar) in errs.items():
                    require(math.isfinite(err) and err <= bar,
                            f"{what}: {_label} {name} vs plain {err} > {bar} at "
                            + str({n: tuple(t.shape) for n, t in a.items()
                                   if isinstance(t, torch.Tensor)}))
                    rec["max_err"] = max(rec["max_err"], err)
                return tamper[_label](out) if _label in tamper else out

            saved.append((mod, attr, real))
            setattr(mod, attr, keep)
    try:
        yield held
    finally:
        for mod, attr, real in reversed(saved):
            setattr(mod, attr, real)


@contextlib.contextmanager
def first_grads(into: dict):
    """Within the block, the train step's first ``loss_and_grads`` call
    leaves every parameter's gradient, fp32 on the CPU, in ``into``."""
    from repro_torch.train import steps

    real = steps.loss_and_grads

    def keep(*args, **kw):
        total, metrics, params, grads = real(*args, **kw)
        if not into:
            into.update({n: (g.to_local() if hasattr(g, "to_local") else g).detach().float().cpu()
                         for n, g in grads.items()})
        return total, metrics, params, grads

    steps.loss_and_grads = keep
    try:
        yield into
    finally:
        steps.loss_and_grads = real


@contextlib.contextmanager
def routed_as(choices: list, replay: bool):
    """Within the block, the MoE's top-k choices (``torch.topk``, which only
    ``layers.moe`` calls) are appended to ``choices`` in call order, or,
    with ``replay``, taken from it in that order (the values gathered from
    the router's own probabilities, so the gradient flows as through
    topk): the CPU's run then routes each token to the experts the card's
    run chose, and a near tie that rounds the other way on the card is not
    counted as an arithmetic error."""
    real = torch.topk
    taken = list(choices) if replay else []

    def topk(probs, k, dim=-1, **kw):
        if not replay:
            vals, idx = real(probs, k, dim=dim, **kw)
            choices.append(idx.cpu())
            return vals, idx
        require(bool(taken), f"a replayed run routes as often as the recorded one ({len(choices)})")
        idx = taken.pop(0).to(probs.device)
        return probs.gather(dim, idx), idx

    torch.topk = topk
    try:
        yield choices
    finally:
        torch.topk = real
    require(not taken, f"a replayed run routes as often as the recorded one: {len(taken)} of "
            f"{len(choices)} choices left")


def leaf_errs(got: dict, want: dict) -> dict:
    """max|got - want| / max|want| of each parameter's gradient."""
    require(got.keys() == want.keys(), f"the same parameters: {sorted(got)} vs {sorted(want)}")
    return {n: rel_err(got[n], w) for n, w in want.items()}


def moe_layers_rel_err(card, cpu, tokens, cfg) -> tuple[list, int]:
    """A bf16 MoE's prefill, each block on the card from the CPU's residual
    stream against the CPU's block, then the head on the CPU's last
    position: max|err| / max|ref| of each.  The card's attention rounds P to
    bf16 where the plain version does not, and an ulp of the stream flips a
    near-tied top-k choice (another routing, not an arithmetic error), so a
    block's router logits are held to the bar on every token and its output
    on the tokens whose experts agree (a flip then needs a gap within twice
    the logits' difference: a near tie).  Returns (the errors, the
    token-layers whose experts differ)."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    dev = next(card.parameters()).device
    pos = torch.arange(tokens.shape[1])[None, :]
    K, E = cfg.top_k, cfg.n_experts

    def router_logits(blk, x, p):
        att = L.attention(blk.attn, L.rms_norm(x, blk.attn.norm), cfg, causal=True,
                          window=cfg.attn_window, positions=p, use_rope=True)[0]
        h = L.rms_norm(x + att, blk.moe.norm)
        return (h.float() @ blk.moe.router).reshape(-1, E).cpu()

    x = T._embed(cpu, cfg, tokens)
    errs, flipped = [], 0
    for blk_cpu, blk_card in zip(cpu.blocks, card.blocks):
        lc = router_logits(blk_cpu, x, pos)
        lg = router_logits(blk_card, x.to(dev), pos.to(dev))
        same = (lc.topk(K).indices.sort().values == lg.topk(K).indices.sort().values).all(-1)
        flipped += int((~same).sum())
        ref = T._self_block_apply(blk_cpu, x, cfg, pos)[0]
        got = T._self_block_apply(blk_card, x.to(dev), cfg, pos.to(dev))[0].float().cpu()
        rows = same.reshape(ref.shape[:2])
        errs.append(max(float((lg - lc).abs().max()) / float(lc.abs().max()),
                        float((got - ref.float())[rows].abs().max())
                        / float(ref.float()[rows].abs().max())))
        x = ref
    ref = L.rms_norm(x[:, -1], cpu.final_norm) @ cpu.head()
    got = L.rms_norm(x[:, -1].to(dev), card.final_norm) @ card.head()
    errs.append(float((got.float().cpu() - ref.float()).abs().max())
                / float(ref.float().abs().max()))
    return errs, flipped


def smoke_serve(arch, lm, ops, serve_cli, get_config, smi) -> dict:
    """Phase 9: ``python -m repro_torch.launch.serve --arch ARCH --smoke`` as
    its ``main``, on the card, the launch counts set to 0 just before and
    read just after; the prefill's and each decode step's logits kept.  Then
    the CPU's plain path on the same weights and batch, fed the card's
    tokens: every step's logits within 3e-2 of max|ref|; the MoE's prefill
    layer by layer on the CPU's stream (``moe_layers_rel_err``), its decode
    steps finite (their routing flips as the prefill's may).  Every kernel
    launch of the run, the MoE's decode steps' too, is held to the plain
    version on its own inputs as it returns (``held_calls``)."""
    cfg = get_config(arch).smoke()
    seen: dict = {"logits": []}
    held: dict = {}
    real_prefill, real_decode = lm.prefill, lm.decode_step

    def kept_prefill(model, batch, cfg_, **kw):
        seen.update(model=model, batch={n: t.cpu() for n, t in batch.items()},
                    pad_to=kw.get("pad_to"))
        logits, cache = real_prefill(model, batch, cfg_, **kw)
        seen["logits"].append(logits.float().cpu())
        return logits, cache

    def kept_decode(model, batch, cfg_):
        logits, cache = real_decode(model, batch, cfg_)
        seen["logits"].append(logits.float().cpu())
        return logits, cache

    lm.prefill, lm.decode_step = kept_prefill, kept_decode
    try:
        with cpu_drawn_weights(lm), held_calls(held, f"{arch} smoke serve"):
            zero_counts(ops)
            t0 = time.perf_counter()
            serve_cli.main(["--arch", arch, "--smoke"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = {n: getattr(ops, n) for n in COUNTERS}
    finally:
        lm.prefill, lm.decode_step = real_prefill, real_decode
    logits = seen["logits"]
    require(len(logits) == DECODE_STEPS and all(bool(torch.isfinite(t).all()) for t in logits),
            f"{arch} smoke: {DECODE_STEPS} finite logits, got {len(logits)}")
    model = lm.init(0, cfg, "cpu")  # the weights the card's run drew on the CPU
    batch = seen["batch"]
    S = batch["tokens"].shape[1]
    if cfg.family == "moe":
        errs, flipped = moe_layers_rel_err(seen["model"], model, batch["tokens"], cfg)
        what = (f"each layer's prefill output on the CPU's stream ({flipped} token-layers with "
                "other experts by a near tie left out), then the head")
    else:
        lc, cache = lm.prefill(model, batch, cfg, pad_to=seen["pad_to"])
        errs = []
        for t, got in enumerate(logits):
            if t:
                tok = logits[t - 1].argmax(dim=-1)
                lc, cache = lm.decode_step(model, {"token": tok, "pos": S + t - 1,
                                                   "cache": cache}, cfg)
            ref = lc.float()
            errs.append(float((got - ref).abs().max()) / float(ref.abs().max()))
        what = "logits, each step"
    del seen["model"]
    require(max(errs) <= 3e-2, f"{arch} smoke, card vs CPU ({what}): {errs} of max|ref| > 3e-2")
    require(counts["attention_launches"] > 0
            and counts["attention_wgmma_launches"] == counts["attention_launches"],
            f"{arch} smoke: attention on wgmma at head dim {cfg.hd}: {counts}")
    print(f"phase 9 serve: python -m repro_torch.launch.serve --arch {arch} --smoke (head dim "
          f"{cfg.hd}, {cfg.activation_dtype}) on the card in {wall} s: card vs CPU, {what}, "
          f"max|err| / max|ref| {max(errs)} (bar 3e-2); each launch vs plain on its inputs "
          f"{held}; launches { {n: c for n, c in counts.items() if c} } on {smi}")
    return dict(wall_s=wall, max_rel_err=max(errs), held=held, counts=counts)


def smoke_encode(lm, ops, get_config, dev, smi) -> dict:
    """Phase 9: hubert-xlarge's smoke forward (``serve`` exits for an
    encoder) on the card and on the CPU, the same weights and frames: the
    output within 3e-2 of max|ref|, and each launch held to the plain
    version on its own inputs."""
    cfg = get_config(SMOKE_ENCODE_ARCH).smoke()
    with cpu_drawn_weights(lm):
        model = lm.init(0, cfg, dev)
    frames = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (B, SMOKE_FRAMES, cfg.d_model), dtype=np.float32)).to(getattr(torch, cfg.activation_dtype))
    held: dict = {}
    with held_calls(held, f"{SMOKE_ENCODE_ARCH} smoke forward"):
        zero_counts(ops)
        got, _ = lm.forward(model, {"frames": frames.to(dev)}, cfg)
        torch.cuda.synchronize()
        counts = {n: getattr(ops, n) for n in COUNTERS}
    ref, _ = lm.forward(lm.init(0, cfg, "cpu"), {"frames": frames}, cfg)
    err = float((got.float().cpu() - ref.float()).abs().max()) / float(ref.float().abs().max())
    require(bool(torch.isfinite(got).all()) and err <= 3e-2,
            f"{SMOKE_ENCODE_ARCH} smoke forward, card vs CPU: {err} of max|ref| > 3e-2")
    require(counts["attention_launches"] == cfg.n_layers
            and counts["attention_wgmma_launches"] == cfg.n_layers,
            f"{SMOKE_ENCODE_ARCH} smoke forward: a wgmma attention launch a layer: {counts}")
    print(f"phase 9 encode: {SMOKE_ENCODE_ARCH} smoke forward ({B} x {SMOKE_FRAMES} frames, head "
          f"dim {cfg.hd}) card vs CPU max|err| / max|ref| {err} (bar 3e-2); each launch vs "
          f"plain on its inputs {held}; launches { {n: c for n, c in counts.items() if c} } "
          f"on {smi}")
    del model
    return dict(max_rel_err=err, held=held, counts=counts)


def smoke_controls(arch: str) -> dict:
    """Phase 9's controls: backward outputs off by CONTROL_SCALE, which the
    gradient bar must catch: attention's dq, and the MoE's expert weights'
    dw."""
    c = CONTROL_SCALE
    out = {f"attention dq x {c}": {"flash_attention_bwd": lambda g: (g[0] * c, *g[1:])}}
    if arch == "qwen3-moe-30b-a3b":
        out[f"grouped matmul dw x {c}"] = {
            "moe_gmm_bwd": lambda g: (g[0], None if g[1] is None else g[1] * c)}
    return out


def smoke_train(arch, lm, ops, train_cli, smi) -> dict:
    """Phase 9: ``python -m repro_torch.launch.train --arch ARCH --smoke
    --steps 20`` as its ``main`` on the card (launch counts set to 0 just
    before, read just after), then with ``--device cpu``, from the same
    weights and batches, the MoE routed as the card routed (``routed_as``).
    Held to the CPU's plain path: the first step's gradient of every
    parameter within SMOKE_GRAD_BAR of its largest (``leaf_errs``), and
    each step's loss within SMOKE_LOSS_BAR (relative; the smoke batches are
    uniform random tokens, so the losses stay near ln(vocab) rather than
    fall).  Every kernel launch of the card's run is held to the plain
    version on its own inputs as it returns (``held_calls``).  Then
    the controls: a one-step card run with a backward kernel's output
    scaled (``smoke_controls``) must fail the gradient bar."""
    argv = ["--arch", arch, "--smoke", "--steps", str(SMOKE_STEPS)]
    held, card_g, cpu_g, choices = {}, {}, {}, []
    what = f"{arch} smoke training"
    with cpu_drawn_weights(lm):
        with held_calls(held, what), first_grads(card_g), routed_as(choices, replay=False):
            zero_counts(ops)
            t0 = time.perf_counter()
            card = train_cli.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = {n: getattr(ops, n) for n in COUNTERS}
        with first_grads(cpu_g), routed_as(choices, replay=True):
            cpu = train_cli.main(argv + ["--device", "cpu"])
        controls = {}
        for label, tamper in smoke_controls(arch).items():
            got: dict = {}
            with held_calls({}, f"{what} control", tamper), first_grads(got):
                train_cli.main(["--arch", arch, "--smoke", "--steps", "1"])
            controls[label] = max(leaf_errs(got, cpu_g).values())
    require(len(card.losses) == len(cpu.losses) == SMOKE_STEPS
            and all(math.isfinite(x) for x in card.losses),
            f"{arch} smoke training: {SMOKE_STEPS} finite losses: {card.losses}")
    errs = [abs(a - b) / abs(b) for a, b in zip(card.losses, cpu.losses)]
    require(max(errs) <= SMOKE_LOSS_BAR,
            f"{arch} smoke training, card vs CPU losses: {errs} > {SMOKE_LOSS_BAR}")
    grads = leaf_errs(card_g, cpu_g)
    worst = max(grads, key=grads.get)
    require(grads[worst] <= SMOKE_GRAD_BAR,
            f"{arch} smoke training, card vs CPU first-step gradients: {grads} > {SMOKE_GRAD_BAR}")
    for label, err in controls.items():
        require(err > SMOKE_GRAD_BAR, f"{arch} smoke training control ({label}): the largest "
                f"gradient error {err} passes the bar {SMOKE_GRAD_BAR}")
    require(counts["attention_bwd_launches"] > 0
            and counts["attention_bwd_wgmma_launches"] == counts["attention_bwd_launches"]
            and counts["attention_wgmma_launches"] == counts["attention_launches"],
            f"{arch} smoke training: attention both ways on wgmma: {counts}")
    print(f"phase 9 train: python -m repro_torch.launch.train --arch {arch} --smoke --steps "
          f"{SMOKE_STEPS} on the card in {wall} s: losses {card.losses[0]} -> "
          f"{card.losses[-1]}, card vs CPU each step max relative {max(errs)} (bar "
          f"{SMOKE_LOSS_BAR}); first-step gradients of {len(grads)} parameters, largest "
          f"max|err| / max|ref| {grads[worst]} ({worst}; bar {SMOKE_GRAD_BAR}); controls "
          f"{controls} (each must pass the bar); each launch vs plain on its inputs {held}; "
          f"launches { {n: c for n, c in counts.items() if c} } on {smi}")
    return dict(wall_s=wall, losses=card.losses, max_rel_err=max(errs),
                grad_max_rel_err=grads[worst], grad_worst_leaf=worst, grad_errs=grads,
                controls=controls, held=held, counts=counts)


def smoke_phase(lm, ops, serve_cli, train_cli, get_config, dev, smi) -> dict:
    """Phase 9: the JAX package's smoke configs through the command lines on
    the card (``smoke_serve``, ``smoke_encode``, ``smoke_train``); returns
    each run's numbers and the launches summed over the phase."""
    t0 = time.perf_counter()
    runs = {f"serve {a}": smoke_serve(a, lm, ops, serve_cli, get_config, smi)
            for a in SMOKE_SERVE_ARCHS}
    runs[f"encode {SMOKE_ENCODE_ARCH}"] = smoke_encode(lm, ops, get_config, dev, smi)
    runs.update({f"train {a}": smoke_train(a, lm, ops, train_cli, smi)
                 for a in SMOKE_TRAIN_ARCHS})
    counts = {n: sum(r["counts"][n] for r in runs.values()) for n in COUNTERS}
    print(f"phase 9 summary: {len(runs)} runs in {time.perf_counter() - t0} s, launches "
          f"{ {n: c for n, c in counts.items() if c} } on {smi}")
    return dict(runs=runs, counts=counts)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.embedding_bag import embedding_bag, embedding_bag_bwd
    from repro_torch.kernels.flash_attention import first_masked_row, flash_attention
    from repro_torch.kernels.mamba_scan import mamba_scan, mamba_scan_bwd
    from repro_torch.kernels.moe_gmm import gmm_bwd_tiling, gmm_tiling, moe_gmm, moe_gmm_bwd
    from repro_torch.kernels.ref import (
        ref_embedding_bag, ref_embedding_bag_bwd, ref_flash_attention, ref_mamba_scan,
        ref_mamba_scan_bwd, ref_moe_gmm, ref_moe_gmm_bwd, ref_rglru_scan, ref_rglru_scan_bwd,
    )
    from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_bwd
    from repro_torch import optim
    from repro_torch.data import pipeline as data
    from repro_torch.launch import dlrm_testbed
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.serve import generate
    from repro_torch.launch.trace_train import group_of
    from repro_torch.models import dlrm, layers, lm
    from repro_torch.core import device_order
    from repro_torch.launch import train_lm_topoopt
    from repro_torch.parallel import compression, sharding
    from repro_torch.train import loop as train_loop
    from repro_torch.train import steps as train_steps
    from repro_torch.train.steps import make_train_step

    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    print(f"phase 1 device: nvidia-smi: {smi}")
    print(f"phase 1 device: torch: {kind}, count {count}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}")

    kernels = ["flash_attention", "flash_attention_bwd", "moe_gmm", "moe_gmm_bwd", "mamba_scan",
               "mamba_scan_bwd", "rglru_scan", "rglru_scan_bwd", "embedding_bag",
               "embedding_bag_bwd"]
    t0 = time.perf_counter()
    _build.load_all(kernels)
    print(f"phase 2 build: {', '.join(k + '.cu' for k in kernels)} in "
          f"{time.perf_counter() - t0:.2f} s")
    for name in kernels:
        for fn, info in ptxas_report(_build.build_logs.get(name, "")).items():
            print(f"phase 2 build: ptxas {name}: {fn}: {info['registers']} registers, "
                  f"{info['smem']} bytes static smem, spill stores {info['spill_stores']} "
                  f"loads {info['spill_loads']} bytes, wgmma serialised: {info['serialised']}")
            if "wgmma_kernel" in fn:  # attention, its backward (dkdv_, dq_), the grouped
                # matmul and its backward (gmm_bwd_)
                # setmaxnreg moves registers within the block's launch-time
                # allotment: consumers at 240 and the producer at 24 (the grouped
                # matmul's backward: 232 and 40) need 168.
                require(info["registers"] == 168,
                        f"{fn} uses {info['registers']} registers, want the 168 that its "
                        "setmaxnreg split (2 x 128 x 240 + 128 x 24, or 232 and 40) is sized "
                        "for")
                require(info["spill_stores"] == info["spill_loads"] == 0
                        and not info["serialised"], f"{fn} spills or serialises: {info}")
            if ("skinny_kernel" in fn or "mamba_scan_kernel" in fn  # the streams and the scan
                    or name in ("flash_attention_bwd", "moe_gmm_bwd", "mamba_scan_bwd",
                                "rglru_scan", "rglru_scan_bwd", "embedding_bag",
                                "embedding_bag_bwd")):
                require(info["spill_stores"] == info["spill_loads"] == 0 and not info["serialised"],
                        f"{fn} spills: {info}")
    bwd_report = ptxas_report(_build.build_logs.get("flash_attention_bwd", ""))
    if bwd_report:  # built in this run: the checks above saw both tilings' kernels, at each
        # head dim (the wgmma ones at D = 256 at the same 168 registers, its consumers splitting
        # D rather than rows; at D = 80 the dk/dv items that also sum dQ in turns, at 168, and
        # the cast of dQ's sums), and the sum of the D = 256 dk/dv partials in bf16 and fp16
        for base, dims, tail in (("dkdv_wgmma_kernel", (64, 128, 256), "E"),
                                 ("dq_wgmma_kernel", (64, 128, 256), "E"),
                                 ("dkdv_kernel", (32, 64, 80, 128, 256), "ELb0E"),
                                 ("dq_kernel", (32, 64, 80, 128, 256), "ELb0E")):
            for d in dims:
                require(any(fn.startswith(base) and f"Li{d}{tail}" in fn for fn in bwd_report),
                        f"ptxas reports no {base} at D = {d}")
        # the fma backward's ragged instances (any other head dim) at each of its widths,
        # checked for spills above with every backward kernel
        for base in ("dkdv_kernel", "dq_kernel"):
            for w in (32, 64, 128, 256):
                require(sum(fn.startswith(base) and f"Li{w}ELb1E" in fn for fn in bwd_report) == 3,
                        f"ptxas reports no ragged {base} at width {w} in each of 3 dtypes")
        for base, want in (("dkdv_sum_kernel", 2), ("dkdv_d80_wgmma_kernel", 2),
                           ("dq_d80_cast_kernel", 4)):  # the cast at D 80 and 72
            got = sum(fn.startswith(base) for fn in bwd_report)
            require(got == want, f"ptxas reports {want} {base}s (bf16, fp16), not {got}")
    fwd_report = ptxas_report(_build.build_logs.get("flash_attention", ""))
    if fwd_report:  # built in this run: the wgmma forward at D = 64, 128 and 256, and at
        # D = 80 its own kernel (true-width products, softmax overlapped), each checked above
        for d in (64, 128, 256):
            require(any(fn.startswith("flash_attention_wgmma_kernel") and f"Li{d}E" in fn
                        for fn in fwd_report), f"ptxas reports no wgmma forward at D = {d}")
        got = sum(fn.startswith("flash_attention_d80_wgmma_kernel") for fn in fwd_report)
        require(got == 2, f"ptxas reports 2 flash_attention_d80_wgmma_kernels, not {got}")
        # the fma forward at every head dim, 32 (examples/train_lm_topoopt.py's model) among them
        for d in (32, 64, 80, 128, 256):
            require(any(fn.startswith("flash_attention_fwd_kernel") and f"Li{d}E" in fn
                        for fn in fwd_report), f"ptxas reports no fma forward at D = {d}")
        # and its ragged kernel (any other head dim) at each of its widths in each dtype, none
        # spilling
        ragged = {fn: info for fn, info in fwd_report.items()
                  if fn.startswith("flash_attention_fwd_ragged_kernel")}
        require(len(ragged) == 12 and all(any(f"Li{w}E" in fn for fn in ragged) for w in
                                          (32, 64, 128, 256)),
                f"ptxas reports {sorted(ragged)}, not the ragged fma forward at widths 32, 64, "
                "128 and 256 in 3 dtypes")
        require(all(i["spill_stores"] == i["spill_loads"] == 0 for i in ragged.values()),
                f"a ragged fma forward spills: {ragged}")
    for name, base in (("rglru_scan", "lru_fwd_kernel"), ("rglru_scan_bwd", "lru_bwd_kernel")):
        lru_report = ptxas_report(_build.build_logs.get(name, ""))
        if lru_report:  # built in this run, every kernel checked for spills above: one kernel
            # a dtype of a (TMA or plain staging is an argument), and nothing else
            got = sum(base in fn for fn in lru_report)
            require(got == 3 == len(lru_report), f"ptxas reports 3 {base}s and nothing else, not "
                                                 f"{sorted(lru_report)}")
    gmm_bwd_report = ptxas_report(_build.build_logs.get("moe_gmm_bwd", ""))
    if gmm_bwd_report:  # built in this run, every kernel checked above: dx and dw on wgmma in
        # bf16 and fp16 (the persistent kernel, launched alone or in pairs), and on fma in each
        # of the three dtypes
        for base, want in (("gmm_bwd_wgmma_kernel", 4), ("gmm_bwd_fma_kernel", 6)):
            got = sum(fn.startswith(base) for fn in gmm_bwd_report)
            require(got == want, f"ptxas reports {want} {base}s, not {got}: "
                                 f"{sorted(gmm_bwd_report)}")
    scan_bwd_report = ptxas_report(_build.build_logs.get("mamba_scan_bwd", ""))
    if scan_bwd_report:  # built in this run, every kernel checked for spills above: 3 dtypes
        # x 4 lane counts (ST up to 16, 32, 64, 128) of the backward, and its sum of partials
        # for each dtype
        for base, want in (("mamba_bwd_kernel", 12), ("mamba_bwd_reduce_kernel", 3)):
            got = sum(fn.startswith(base) for fn in scan_bwd_report)
            require(got == want, f"ptxas reports {want} {base}s, not {got}: "
                                 f"{sorted(scan_bwd_report)}")
    bag_bwd_report = ptxas_report(_build.build_logs.get("embedding_bag_bwd", ""))
    if bag_bwd_report:  # built in this run, every kernel checked for spills above: 3 dtypes
        # x (16-byte, scalar) small kernels, the same x (int32, int64 keys) sorted ones, and
        # the keys kernel for 2 id types x 2 key types
        for base, want in zip((*BAG_BWD_KERNELS, "embedding_bag_keys_kernel"), (6, 12, 4)):
            got = sum(fn.startswith(base) for fn in bag_bwd_report)
            require(got == want, f"ptxas reports {want} {base}s, not {got}: "
                                 f"{sorted(bag_bwd_report)}")
    bag_report = ptxas_report(_build.build_logs.get("embedding_bag", ""))
    if bag_report:  # built in this run: 3 dtypes x 2 id types x (16-byte, scalar) kernels
        got = sum(fn.startswith("embedding_bag_kernel") for fn in bag_report)
        require(got == 12, f"ptxas reports 12 embedding_bag_kernels, not {got}: "
                           f"{sorted(bag_report)}")

    # Phase 3: the kernel against its plain version at the serving shapes.
    gen = torch.Generator(device=dev).manual_seed(0)

    cases = [  # (Sq, Sk, D, dtype, causal, window, KV, H)
        (PROMPT, PROMPT, D, torch.bfloat16, True, 0, KV, H),  # granite-8b's prefill
        (PROMPT, PROMPT, D, torch.float16, True, 0, KV, H),
        (PROMPT, PROMPT, D, torch.float32, True, 0, KV, H),
        (2048, 2048, D, torch.bfloat16, True, 0, KV, H),
        (2048, 2048, D, torch.float32, True, 0, KV, H),
        (PROMPT, PROMPT, 64, torch.bfloat16, True, 128, KV, H),
        (PROMPT, PROMPT, D, torch.bfloat16, False, 0, KV, H),
        (PROMPT, PROMPT, D, torch.bfloat16, True, 0, 4, H),  # qwen3-moe-30b-a3b's prefill
        (PROMPT_RG, PROMPT_RG, 256, torch.bfloat16, True, PROMPT_RG, 1, 16),  # recurrentgemma-9b's
        (PROMPT_RG, PROMPT_RG, 256, torch.float16, True, PROMPT_RG, 1, 16),
        (PROMPT_RG, PROMPT_RG, 256, torch.float32, True, PROMPT_RG, 1, 16),
        # Ragged edges of the 128-row q tiles and 64-row k tiles.
        (127, 127, D, torch.bfloat16, True, 0, KV, H),
        (129, 129, D, torch.bfloat16, True, 0, KV, H),
        (129, 129, 256, torch.float16, True, 64, 1, 16),
        (100, 300, D, torch.bfloat16, False, 0, KV, H),
        (300, 100, 64, torch.bfloat16, True, 0, KV, H),
        *HUBERT_CASES, CROSS_CASE,
        # Head dim 80 at the ragged edges, Sq != Sk among them.
        (127, 127, D_AU, torch.bfloat16, True, 0, H_AU, H_AU),
        (129, 129, D_AU, torch.bfloat16, True, 0, H_AU, H_AU),
        (127, 129, D_AU, torch.bfloat16, False, 0, H_AU, H_AU),
        (129, 127, D_AU, torch.float32, False, 0, H_AU, H_AU),
    ]
    attn = {case: check_attention_fwd(case, gen, dev, smi) for case in cases}
    # Rows that see no key (Sq 256, Sk 200, causal, window 16: rows 215 on)
    # take the mean of v over all Sk keys, as in the plain version, on both
    # tilings; the rows that see a key are held to the same bar.
    masked_rows = {}
    for dtype, tiling in ((torch.bfloat16, "wgmma"), (torch.bfloat16, "fma"),
                          (torch.float32, "fma")):
        q = torch.randn(B, H, 256, D, generator=gen, device=dev).to(dtype)
        k, v = (torch.randn(B, KV, 200, D, generator=gen, device=dev).to(dtype) for _ in "kv")
        out = flash_attention(q, k, v, causal=True, window=16, tiling=tiling)
        torch.cuda.synchronize()
        ref = ref_flash_attention(q, k, v, causal=True, window=16)
        first = first_masked_row(256, 200, True, 16)
        err = float((out.float() - ref.float()).abs().max())
        masked_err = float((out[:, :, first:].float() - ref[:, :, first:].float()).abs().max())
        tol = TOL[dtype]
        label = f"Sq=256 Sk=200 D={D} {str(dtype)[6:]} causal window=16 tiling={tiling}"
        require(torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol),
                f"kernel vs plain at {tol}, {label}: max|err| {err}")
        print(f"phase 3 kernel: flash_attention fully masked rows {first}..255, {label}: "
              f"max|err| {err}, on the masked rows {masked_err} (tol {tol})")
        masked_rows[f"{str(dtype)[6:]} {tiling}"] = err
        del q, k, v, out, ref
    torch.cuda.empty_cache()
    # The backward kernel, and the forward's lse, at the training shapes.
    bwd = [check_attention_bwd(case, gen, dev, smi) for case in BWD_CASES]
    torch.cuda.empty_cache()
    # One model rank's attention on the production mesh (TP16_ATTN_CASES),
    # forward and backward.
    tp16_attn = [dict(fwd=check_attention_fwd((S, S, Dc, dt, causal, rest[0] if rest else 0, kv, h),
                                              gen, dev, smi, batch=Bc, phase="3 tp16"),
                      bwd=check_attention_bwd((Bc, h, kv, S, Dc, dt, causal, *rest), gen, dev,
                                              smi, phase="3 tp16"))
                 for Bc, h, kv, S, Dc, dt, causal, *rest in TP16_ATTN_CASES]
    torch.cuda.empty_cache()
    # Head dims no served model has, on both tilings, both ways.
    dims = check_attention_dims(gen, dev, smi)
    main_case, rg_case = attn[cases[0]], attn[cases[8]]
    main_fp32, rg_fp32 = attn[cases[2]], attn[cases[10]]
    au_case, au_fp16, au_fp32 = (attn[c] for c in HUBERT_CASES)
    cross_case = attn[CROSS_CASE]

    # The grouped matmul against its plain version at qwen3-moe-30b-a3b's
    # expert products: gate/up (D, F) = (2048, 768) and down (768, 2048).
    gmm_cases = [  # (E, C, D, F, dtype, dispatch-like buffer)
        (E_MOE, C_PREFILL, D_MOE, F_MOE, torch.bfloat16, False),
        (E_MOE, C_PREFILL, F_MOE, D_MOE, torch.bfloat16, False),
        (E_MOE, C_PREFILL, D_MOE, F_MOE, torch.float16, False),
        (E_MOE, C_PREFILL, D_MOE, F_MOE, torch.float32, False),
        (E_MOE, C_PREFILL, F_MOE, D_MOE, torch.float32, False),
        (E_MOE, C_PREFILL, D_MOE, F_MOE, torch.bfloat16, True),
        (E_MOE, 1, D_MOE, F_MOE, torch.bfloat16, False),
        (E_MOE, 1, F_MOE, D_MOE, torch.bfloat16, False),
        (3, 77, 200, 136, torch.bfloat16, False),
        # Around the 128 x 256 tiles: one row past a tile; D and F ragged.
        (8, 129, D_MOE, F_MOE, torch.bfloat16, False),
        (4, 129, 72, 136, torch.bfloat16, False),
        (4, 129, 72, 136, torch.float16, False),
        # qwen3-moe-30b-a3b's training forward (C = C_TRAIN): gate/up and down.
        (E_MOE, C_TRAIN, D_MOE, F_MOE, torch.bfloat16, False),
        (E_MOE, C_TRAIN, F_MOE, D_MOE, torch.bfloat16, False),
        # One model rank's 8 experts of them on the production mesh.
        (E_TP16, C_TRAIN, D_MOE, F_MOE, torch.bfloat16, False),
        (E_TP16, C_TRAIN, F_MOE, D_MOE, torch.bfloat16, False),
    ]
    gmm = {}
    for E, C, Dx, F, dtype, realistic in gmm_cases:
        x = torch.randn(E, C, Dx, generator=gen, device=dev).to(dtype)
        w = (torch.randn(E, Dx, F, generator=gen, device=dev) / Dx**0.5).to(dtype)
        if realistic:
            x = dispatch_like(x, gen)
        out = moe_gmm(x, w)
        torch.cuda.synchronize()
        ref = ref_moe_gmm(x, w)
        err = float((out.float() - ref.float()).abs().max())
        tol = TOL[dtype]
        tiling = gmm_tiling(dtype, C, Dx, F)
        label = (f"E={E} C={C} D={Dx} F={F} {str(dtype)[6:]} tiling={tiling}"
                 + (" rows past each count zero" if realistic else ""))
        require(bool(torch.isfinite(out).all()), f"finite kernel output, {label}")
        require(torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol),
                f"kernel vs plain at {tol}, {label}: max|err| {err}")
        kernel_ms = time_ms(lambda: moe_gmm(x, w), 20)
        plain_ms = time_ms(lambda: ref_moe_gmm(x, w), 5)
        # torch.bmm: a yardstick only, never on the port's path.
        library_ms = time_ms(lambda: torch.bmm(x, w), 20)
        fma_ms = None
        if tiling == "wgmma" and E == E_MOE:  # the earlier tiling, on the same inputs
            fma_ms = time_ms(lambda: moe_gmm(x, w, tiling="fma"), 20)
        bound_ms, bound_by, _ = gmm_bound(x, w)
        print(f"phase 3 kernel: moe_gmm {label}: max|err| {err} (tol {tol}) "
              f"kernel_ms {kernel_ms} plain_ms {plain_ms} library_ms {library_ms} "
              f"bound_ms {bound_ms} ({bound_by}) fma_ms {fma_ms} on {smi}")
        gmm[(E, C, Dx, F, dtype, realistic)] = dict(
            tiling=tiling, max_abs_err=err, kernel_ms=kernel_ms, plain_ms=plain_ms,
            library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by, fma_ms=fma_ms)
        del x, w, out, ref
    torch.cuda.empty_cache()
    gmm_main, gmm_down, gmm_fp32 = gmm[gmm_cases[0]], gmm[gmm_cases[1]], gmm[gmm_cases[3]]
    gmm_decode, gmm_decode_down = gmm[gmm_cases[6]], gmm[gmm_cases[7]]
    gmm_train, gmm_train_down = gmm[gmm_cases[-4]], gmm[gmm_cases[-3]]
    gmm_tp16, gmm_tp16_down = gmm[gmm_cases[-2]], gmm[gmm_cases[-1]]

    # A decode step's own buffers: what layers.moe passes to the grouped
    # matmul for the 4 served requests on a full-width layer.  Experts that
    # no token picked hold zero rows, which the skinny tiling skips, and the
    # bound counts only the live experts' weights.
    decode_like = {}
    for name, x, w in moe_decode_buffers(layers, ops, get_config("qwen3-moe-30b-a3b"), dev, gen):
        out = moe_gmm(x, w)
        torch.cuda.synchronize()
        ref = ref_moe_gmm(x, w)
        err = float((out.float() - ref.float()).abs().max())
        tol = TOL[x.dtype]
        E, C, Dx = x.shape
        F = w.shape[2]
        tiling = gmm_tiling(x.dtype, C, Dx, F)
        require(tiling == "skinny", f"decode-like {name} on the skinny tiling, not {tiling}")
        require(bool(torch.isfinite(out).all())
                and torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol),
                f"kernel vs plain at {tol}, decode-like {name}: max|err| {err}")
        kernel_ms = time_ms(lambda: moe_gmm(x, w), 20)
        plain_ms = time_ms(lambda: ref_moe_gmm(x, w), 5)
        library_ms = time_ms(lambda: torch.bmm(x, w), 20)
        bound_ms, bound_by, live = gmm_bound(x, w)
        print(f"phase 3 kernel: moe_gmm decode-like {name} E={E} C={C} D={Dx} F={F} "
              f"{str(x.dtype)[6:]} tiling={tiling}: live experts {live} of {E}, max|err| {err} "
              f"(tol {tol}) kernel_ms {kernel_ms} plain_ms {plain_ms} library_ms {library_ms} "
              f"bound_ms {bound_ms} ({bound_by}; the live experts' weights) "
              f"share of bound {bound_ms / kernel_ms} on {smi}")
        decode_like[name] = dict(kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                                 bound_ms=bound_ms, bound_by=bound_by, live=live,
                                 max_abs_err=err)
        del x, w, out, ref
    torch.cuda.empty_cache()

    # The grouped matmul's backward at qwen3-moe-30b-a3b's training products.
    gmm_bwd = check_gmm_bwd(moe_gmm_bwd, ref_moe_gmm_bwd, gmm_bwd_tiling, gen, dev, smi)

    # The selective scan at falcon-mamba-7b's prefill (b and c strided, as the
    # layer passes them) and at a ragged shape (L not a multiple of 16 or 32,
    # DI not of the 64-channel block), with bf16 inputs and in fp32.  The bar
    # is 1e-4 of max|y| in fp32 and 2e-2 with bf16 inputs.  No PyTorch call
    # computes a linear recurrence, so there is no library time.
    mamba_cases = [  # (B, L, DI, ST, R, dtype)
        (B, PROMPT, DI_MAMBA, ST_MAMBA, R_MAMBA, torch.bfloat16),
        (B, PROMPT, DI_MAMBA, ST_MAMBA, R_MAMBA, torch.float32),
        (2, 37, 200, ST_MAMBA, None, torch.bfloat16),
        (2, 37, 200, ST_MAMBA, None, torch.float32),
        # One model rank's 512 channels on the production mesh, at 5d's shape.
        (TRAIN_B, TRAIN_S, DI_TP16, ST_MAMBA, R_MAMBA, torch.bfloat16),
    ]
    mamba_main = mamba_tp16 = {}
    for Bm, L, DI, ST, R, dtype in mamba_cases:
        args = mamba_inputs(gen, Bm, L, DI, ST, dtype, R)
        y, h = mamba_scan(*args)
        torch.cuda.synchronize()
        ey, eh = ref_mamba_scan(*args)
        err, herr = float((y - ey).abs().max()), float((h - eh).abs().max())
        tol = 1e-4 * float(ey.abs().max()) if dtype == torch.float32 else TOL[dtype]
        htol = max(tol, 1e-4 * float(eh.abs().max()))
        label = f"B={Bm} L={L} DI={DI} ST={ST} {str(dtype)[6:]}" + (" b,c strided" if R else "")
        require(bool(torch.isfinite(y).all() and torch.isfinite(h).all()),
                f"finite kernel output, {label}")
        require(err <= tol and herr <= htol,
                f"kernel vs plain, {label}: max|err| y {err} (tol {tol}), h {herr} (tol {htol})")
        kernel_ms = time_ms(lambda: mamba_scan(*args), 20)
        plain_ms = time_ms(lambda: ref_mamba_scan(*args), 3, warmup=1)
        bound_ms, bound_by, bytes_ms, exp_ms = mamba_bound(*args)
        print(f"phase 3 kernel: mamba_scan {label}: max|err| y {err} (tol {tol}) h {herr} "
              f"(tol {htol}) kernel_ms {kernel_ms} plain_ms {plain_ms} library_ms None "
              f"bound_ms {bound_ms} ({bound_by}; bytes {bytes_ms} ms, exps {exp_ms} ms) on {smi}")
        numbers = dict(max_abs_err=err, kernel_ms=kernel_ms, plain_ms=plain_ms,
                       library_ms=None, bound_ms=bound_ms, bound_by=bound_by)
        if (Bm, L, DI, ST, R, dtype) == mamba_cases[0]:
            mamba_main = numbers
        if (Bm, L, DI, ST, R, dtype) == mamba_cases[-1]:
            mamba_tp16 = numbers
        del args, y, h, ey, eh

    # The selective scan's backward at falcon-mamba-7b's training shape and
    # the other MAMBA_BWD_CASES.
    mamba_bwd = check_mamba_bwd(mamba_scan, mamba_scan_bwd, ref_mamba_scan,
                                ref_mamba_scan_bwd, gen, dev, smi)

    # The RG-LRU scan at recurrentgemma-9b's prefill and its training shape
    # (fp32, as the layer passes it), at the prefill with bf16 inputs, and
    # ragged: L off the rounds and D off the channel tiles, TMA staging at D =
    # 200 and plain loads at D = 33 (rows TMA cannot stride).
    lru_cases = {  # name: (B, L, D, dtype)
        "prefill": (B, PROMPT_RG, D_RG, torch.float32),
        "training": (HYB_TRAIN_B, TRAIN_S, D_RG, torch.float32),
        "prefill_bf16": (B, PROMPT_RG, D_RG, torch.bfloat16),
        "ragged": (3, 1000, 200, torch.float32),
        "ragged_bf16": (3, 1000, 200, torch.bfloat16),
        "ragged_plain_loads": (2, 1000, 33, torch.float32),
        "tp16": (HYB_TRAIN_B, TRAIN_S, D_RG_TP16, torch.float32),  # a model rank's 256 channels
    }
    lru_fwd = {}
    for name, (Bm, L, Dl, dtype) in lru_cases.items():
        a = (torch.rand(Bm, L, Dl, generator=gen, device=dev) * 0.89 + 0.1).to(dtype)
        bb = torch.randn(Bm, L, Dl, generator=gen, device=dev).to(dtype)
        h_all, h_fin = rglru_scan(a, bb)
        torch.cuda.synchronize()
        again = rglru_scan(a, bb)
        label = f"{name} B={Bm} L={L} D={Dl} {str(dtype)[6:]}"
        require(torch.equal(h_all, again[0]) and torch.equal(h_fin, again[1]),
                f"two RG-LRU forward launches equal to the bit, {label}")
        del again
        e_all, e_fin = ref_rglru_scan(a, bb)
        err = max(float((h_all - e_all).abs().max()), float((h_fin - e_fin).abs().max()))
        tol = 1e-5  # fp32 arithmetic from the same inputs in both
        require(bool(torch.isfinite(h_all).all()), f"finite kernel output, {label}")
        require(torch.allclose(h_all, e_all, rtol=tol, atol=tol)
                and torch.allclose(h_fin, e_fin, rtol=tol, atol=tol),
                f"kernel vs plain at {tol}, {label}: max|err| {err}")
        kernel_ms = time_ms(lambda: rglru_scan(a, bb), 20)
        plain_ms = time_ms(lambda: ref_rglru_scan(a, bb), 3, warmup=1)
        bound_ms, bound_by = lru_bound(a, bb)
        print(f"phase 3 kernel: rglru_scan {label}: max|err| {err} (tol {tol}), two launches "
              f"bitwise equal; kernel_ms {kernel_ms} plain_ms {plain_ms} library_ms None "
              f"bound_ms {bound_ms} ({bound_by}) share of bound {bound_ms / kernel_ms} on {smi}")
        lru_fwd[name] = dict(max_abs_err=err, kernel_ms=kernel_ms, plain_ms=plain_ms,
                             library_ms=None, bound_ms=bound_ms, bound_by=bound_by)
        del a, bb, h_all, h_fin, e_all, e_fin
    torch.cuda.empty_cache()
    # The RG-LRU scan's backward at recurrentgemma-9b's training shape and the
    # other LRU_BWD_CASES.
    lru_bwd = check_lru_bwd(rglru_scan, rglru_scan_bwd, ref_rglru_scan_bwd, gen, dev, smi)
    tp16 = tp16_summary(tp16_attn, gmm_tp16, gmm_tp16_down, gmm_bwd, mamba_tp16, mamba_bwd,
                        lru_fwd, lru_bwd)
    print(f"phase 3 tp16 summary: one model rank's kernels on the production mesh (model = "
          f"{TP_PROD}), each beside its full-width training row: {json.dumps(tp16)} on {smi}")

    t_bag = time.perf_counter()
    bag = check_bag(embedding_bag, ref_embedding_bag, gen, dev, smi)
    torch.cuda.empty_cache()
    bag_bwd = check_bag_bwd(embedding_bag_bwd, ref_embedding_bag_bwd, gen, dev, smi)
    torch.cuda.empty_cache()
    print(f"phase 3 kernel: the embedding bag's checks, forward and backward, took "
          f"{time.perf_counter() - t_bag:.2f} s")

    # A narrow granite in fp32 (head dim 64): kernel prefill on the card vs the
    # plain model on the CPU, same weights and prompts.
    small = narrow_config(get_config, "granite-8b")
    m_cpu = lm.init(0, small, device="cpu")
    m_gpu = lm.init(0, small, device=dev)
    m_gpu.load_state_dict(m_cpu.state_dict())
    toks = torch.randint(0, small.vocab, (2, 77), generator=torch.Generator().manual_seed(0))
    lc, _ = lm.prefill(m_cpu, {"tokens": toks}, small)
    lg, _ = lm.prefill(m_gpu, {"tokens": toks.to(dev)}, small)
    err = float((lg.cpu() - lc).abs().max())
    require(torch.allclose(lg.cpu(), lc, rtol=1e-4, atol=1e-4),
            f"narrow fp32 model, card vs CPU: max|err| {err}")
    print(f"phase 3 model: narrow fp32 granite prefill, card vs CPU plain: max|err| {err} "
          "(tol 1e-4)")
    del m_cpu, m_gpu

    # A narrow qwen3-moe in fp32 (head dim 64, 8 experts, top 2) at capacity
    # 1.0, so prefill drops entries: both kernels on the card vs the CPU.
    small_moe = narrow_config(get_config, "qwen3-moe-30b-a3b")
    m_cpu = lm.init(0, small_moe, device="cpu")
    m_gpu = lm.init(0, small_moe, device=dev)
    m_gpu.load_state_dict(m_cpu.state_dict())
    fc, ac = lm.forward(m_cpu, {"tokens": toks}, small_moe)
    fg, ag = lm.forward(m_gpu, {"tokens": toks.to(dev)}, small_moe)
    lc, cc = lm.prefill(m_cpu, {"tokens": toks}, small_moe, pad_to=80)
    lg, cg = lm.prefill(m_gpu, {"tokens": toks.to(dev)}, small_moe, pad_to=80)
    errs = {"forward": float((fg.cpu() - fc).abs().max()), "aux": abs(float(ag) - float(ac)),
            "prefill": float((lg.cpu() - lc).abs().max())}
    require(torch.allclose(fg.cpu(), fc, rtol=1e-4, atol=1e-4), f"narrow MoE forward: {errs}")
    require(abs(float(ag) - float(ac)) <= 1e-4 * (1 + abs(float(ac))), f"narrow MoE aux: {errs}")
    require(torch.allclose(lg.cpu(), lc, rtol=1e-4, atol=1e-4), f"narrow MoE prefill: {errs}")
    for pos in (77, 78):
        tok = lc.argmax(-1)
        lc, cc = lm.decode_step(m_cpu, {"token": tok, "pos": pos, "cache": cc}, small_moe)
        lg, cg = lm.decode_step(m_gpu, {"token": tok.to(dev), "pos": pos, "cache": cg}, small_moe)
        errs[f"decode@{pos}"] = float((lg.cpu() - lc).abs().max())
        require(torch.allclose(lg.cpu(), lc, rtol=1e-4, atol=1e-4), f"narrow MoE decode: {errs}")
    print(f"phase 3 model: narrow fp32 MoE (capacity 1.0), card vs CPU plain: max|err| {errs} "
          "(tol 1e-4)")
    del m_cpu, m_gpu, cg

    # Narrow fp32 falcon-mamba and Griffin: the scans (and Griffin's windowed
    # attention at head dim 64) on the card vs the plain models on the CPU.
    # Then a narrow VLM (self and cross attention at head dim 128, gates
    # opened) and a narrow encoder (head dim 80, both ways).
    cpu_gen = torch.Generator().manual_seed(1)
    for arch in ("falcon-mamba-7b", "recurrentgemma-9b", "llama-3.2-vision-11b",
                 "hubert-xlarge"):
        small = narrow_config(get_config, arch)
        batch = {"tokens": toks}
        if small.family == "vlm":
            batch["image_embeds"] = torch.randn(2, small.img_tokens, small.d_model,
                                                generator=cpu_gen)
        elif small.family == "audio":
            batch = {"frames": torch.randn(2, 77, small.d_model, generator=cpu_gen)}
        errs = check_narrow_model(lm, small, dev, batch, arch)
        print(f"phase 3 model: narrow fp32 {arch} (head dim {small.hd}), card vs CPU plain: "
              f"max|err| {errs} (tol 1e-4)")

    # A narrow fp32 DLRM: the embedding bag on the card vs the plain lookup
    # on the CPU, same weights and batch (forward and loss).
    small_dlrm = dlrm.DLRMConfig(n_tables=4, rows_per_table=1000, embed_dim=16,
                                 bottom_mlp=(32, 32), top_mlp=(32, 32, 1))
    m_cpu = dlrm.init(0, small_dlrm, device="cpu")
    m_gpu = dlrm.init(0, small_dlrm, device=dev)
    m_gpu.load_state_dict(m_cpu.state_dict())
    batch = dlrm_batch(np.random.default_rng(0), small_dlrm, 64, "cpu")
    fc = dlrm.forward(m_cpu, batch["dense"], batch["sparse"], small_dlrm)
    lc, _ = dlrm.loss_fn(m_cpu, batch, small_dlrm)
    gb = {k: v.to(dev) for k, v in batch.items()}
    fg = dlrm.forward(m_gpu, gb["dense"], gb["sparse"], small_dlrm)
    lg, _ = dlrm.loss_fn(m_gpu, gb, small_dlrm)
    errs = {"forward": float((fg.cpu() - fc).abs().max()), "loss": abs(float(lg) - float(lc))}
    require(torch.allclose(fg.cpu(), fc, rtol=1e-4, atol=1e-4)
            and torch.allclose(lg.cpu(), lc, rtol=1e-4, atol=1e-4),
            f"narrow DLRM, card vs CPU: {errs}")
    print(f"phase 3 model: narrow fp32 DLRM (T=4, R=1000, E=16, MLPs of 32), card vs CPU "
          f"plain: max|err| {errs} (tol 1e-4)")
    del m_cpu, m_gpu, gb
    # Its train step: both bag kernels on the card against the plain versions
    # on the CPU, with ids past the table and negative ids in the batch.
    step_batch = dict(batch, sparse=batch["sparse"].clone())
    step_batch["sparse"][:4] = torch.tensor([1000, -1, 1003, -1007], dtype=torch.int32)
    errs = check_dlrm_train_step(dlrm, dlrm_testbed, optim, ops, small_dlrm, step_batch, dev)
    print(f"phase 3 model: narrow fp32 DLRM train step (ids 1000, -1, 1003, -1007 among them), "
          f"card vs CPU plain: max relative err {errs} (loss, gradients tol 1e-5; AdamW step "
          f"params tol 1e-4)")

    # A narrow fp32 dense train step (head dim 64, 2 layers, d_model 256),
    # MHA and GQA: the attention kernels, forward and backward, on the card
    # against the plain versions on the CPU.
    for kv in (4, 2):
        small = train_config(get_config, kv)
        errs = check_train_step(lm, make_train_step, optim, ops, small, dev)
        print(f"phase 3 model: narrow fp32 train step ({TRAIN_ARCH} smoke, d_model 256, 2 layers, "
              f"H=4 KV={kv} D=64), card vs CPU plain: max relative err {errs} (tol 1e-4)")

    # A narrow fp32 MoE train step: the grouped matmul's forward and backward
    # kernels (and attention's) on the card against the plain versions on the
    # CPU, dropless and at capacity 1.0, where entries drop.
    moe_steps = {}
    for cf in (get_config(MOE_TRAIN_ARCH).smoke().capacity_factor, 1.0):
        small = moe_train_config(get_config, cf)
        moe_steps[cf] = check_moe_train_step(lm, make_train_step, optim, ops, small, dev)
        print(f"phase 3 model: narrow fp32 MoE train step ({MOE_TRAIN_ARCH} smoke, d_model "
              f"{small.d_model}, {small.n_experts} experts of {small.d_ff}, top {small.top_k}, "
              f"head dim 64, 2 layers, capacity {cf}: C = "
              f"{int(cf * 154 * small.top_k / small.n_experts)}), card vs CPU plain: max relative "
              f"err {moe_steps[cf]} (loss, gradients tol 1e-5; AdamW step params tol 1e-4, on "
              f"entries with g within rounding of 0 2 lr)")

    # A narrow fp32 Mamba train step: the scan's forward and backward kernels
    # on the card against the plain versions on the CPU.
    small = dataclasses.replace(narrow_config(get_config, "falcon-mamba-7b"), n_layers=2)
    mamba_step = check_mamba_train_step(lm, make_train_step, optim, ops, small, dev)
    print(f"phase 3 model: narrow fp32 Mamba train step (falcon-mamba-7b smoke, d_model "
          f"{small.d_model}, ssm_state {small.ssm_state}, 2 layers, 2 x {MAMBA_STEP_S} tokens), "
          f"card vs CPU plain: max relative err {mamba_step} (loss, gradients tol 1e-4; AdamW "
          f"step params tol 1e-4, on entries with g within rounding of 0 2 lr)")

    # A narrow fp32 hybrid train step: the RG-LRU scan's forward and backward
    # kernels and the attention kernels at head dim 256 with a window (the fma
    # tilings in fp32) on the card against the plain versions on the CPU.
    small = hybrid_train_config(get_config)
    n_attn = small.n_layers // len(small.block_pattern)
    n_rec = small.n_layers - n_attn
    hybrid_step = check_train_step(
        lm, make_train_step, optim, ops, small, dev,
        want=dict(lru_scan_launches=2 * n_rec, lru_scan_bwd_launches=n_rec,
                  attention_launches=2 * n_attn, attention_fma_launches=2 * n_attn,
                  attention_bwd_launches=n_attn, attention_bwd_fma_launches=n_attn))
    print(f"phase 3 model: narrow fp32 hybrid train step ({HYB_TRAIN_ARCH} smoke, d_model "
          f"{small.d_model}, {small.n_layers} layers, H={small.n_heads} KV={small.n_kv_heads} "
          f"D={small.hd}, window {small.attn_window}, 2 x 77 tokens), card vs CPU plain: max "
          f"relative err {hybrid_step} (tol 1e-4)")

    # Narrow fp32 train steps of the VLM (head dim 128, 10 layers of which
    # 2 cross layers over 100 image tokens, the gates at 0.5) and of the
    # encoder (head dim 80, unmasked): the attention kernels, forward and
    # backward (the fma tilings in fp32; the cross layers run their forward
    # once, not rematerialized), on the card against the plain versions on
    # the CPU.
    family_steps = {}
    for arch in ("llama-3.2-vision-11b", "hubert-xlarge"):
        small = narrow_config(get_config, arch)
        n_cross = small.n_layers // small.cross_attn_every if small.family == "vlm" else 0
        fwd = 2 * (small.n_layers - n_cross) + n_cross
        family_steps[arch] = check_train_step(
            lm, make_train_step, optim, ops, small, dev,
            want=dict(attention_launches=fwd, attention_fma_launches=fwd,
                      attention_bwd_launches=small.n_layers,
                      attention_bwd_fma_launches=small.n_layers))
        cross = (f" ({n_cross} cross over {small.img_tokens} image tokens, gates 0.5)"
                 if n_cross else "")
        print(f"phase 3 model: narrow fp32 {small.family} train step ({arch} smoke, d_model "
              f"{small.d_model}, {small.n_layers} layers{cross}, H={small.n_heads} "
              f"KV={small.n_kv_heads} D={small.hd}, 2 x 77 positions), card vs CPU plain: max "
              f"relative err {family_steps[arch]} (tol 1e-4)")

    # Phase 4: serve granite-8b at full width and depth.
    cfg = get_config("granite-8b")
    t0 = time.perf_counter()
    model = lm.init(0, cfg, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"phase 4 serve: {cfg.name} init on the card: {n_params} parameters "
          f"({cfg.param_dtype}) in {time.perf_counter() - t0:.2f} s")
    tokens = torch.randint(0, cfg.vocab, (B, PROMPT), generator=gen, device=dev)
    generate(model, tokens[:, :64], 2)  # warm-up: cuBLAS handles and heuristics

    ids, timings, pre, dec, logits = served(lm, ops, generate, model, tokens)
    check_served(cfg, ids, logits)
    launches = pre["attention_launches"] + dec["attention_launches"]
    require(launches == cfg.n_layers and pre["attention_launches"] == cfg.n_layers,
            f"flash_attention launches: {pre} in the prefill, {dec} in the decode loop, "
            f"want {cfg.n_layers} in the prefill and none after")
    require(pre["attention_wgmma_launches"] == cfg.n_layers,
            f"every prefill attention on the wgmma tiling: {pre}")
    require(sum(pre[n] + dec[n] for n in KERNEL_COUNTERS) == launches
            and sum(pre[n] + dec[n] for n in TILING_COUNTERS) == launches,
            f"granite-8b runs no other kernel: {pre}, {dec}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    decode_ms = timings["decode_s"] / (DECODE_STEPS - 1) * 1e3
    print(f"phase 4 serve: {B}x{PROMPT} prefill {timings['prefill_s'] * 1e3} ms, decode "
          f"{decode_ms} ms/token over {DECODE_STEPS - 1} steps, peak memory {peak_gb} GB, "
          f"flash_attention launches {launches} ({pre['attention_wgmma_launches']} on wgmma), "
          f"on {smi}")
    print(f"phase 4 serve: generated ids (first request): {ids[0].tolist()}")

    full, _ = lm.prefill(model, {"tokens": tokens}, cfg)
    part, cache = lm.prefill(model, {"tokens": tokens[:, :-1]}, cfg, pad_to=PROMPT)
    step, _ = lm.decode_step(
        model, {"token": tokens[:, -1], "pos": PROMPT - 1, "cache": cache}, cfg
    )
    for name, t in (("prefill", full), ("prefill S-1", part), ("decode", step)):
        require(bool(torch.isfinite(t).all()), f"finite {name} logits")
    diff = float((step.float() - full.float()).abs().max())
    bar = 5e-2 * float(full.float().abs().max())
    require(diff <= bar, f"prefill vs prefill+decode: max|diff| {diff} > {bar}")
    agree = int((full.argmax(-1) == step.argmax(-1)).sum())
    print(f"phase 4 consistency: last-token logits, kernel prefill vs prefill(S-1)+plain "
          f"decode: max|diff| {diff} <= {bar} (5e-2 max|logits|); argmax agrees {agree}/{B}")
    granite_attention_launches = launches
    # Phase 7f (granite-8b): the same model and prompts through jit_serve_step.
    del full, part, step, cache
    mesh_served = {cfg.name: mesh_serve_check(
        train_steps, sharding, device_order, ops, model, tokens,
        dict(ids=ids, logits=logits, pre=pre, dec=dec, timings=timings), dev, smi, "phase 4")}

    # Phase 4b: serve qwen3-moe-30b-a3b at full width and depth.  Its 61 GB
    # of weights need the room granite's model and caches hold.
    del model, tokens, ids, logits
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("qwen3-moe-30b-a3b")
    t0 = time.perf_counter()
    model = lm.init(0, cfg, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"phase 4b serve: {cfg.name} init on the card: {n_params} parameters "
          f"({cfg.param_dtype}; routers fp32) in {time.perf_counter() - t0:.2f} s")
    tokens = torch.randint(0, cfg.vocab, (B, PROMPT), generator=gen, device=dev)
    generate(model, tokens[:, :64], 2)  # warm-up

    ids, timings, pre, dec, logits = served(lm, ops, generate, model, tokens)
    check_served(cfg, ids, logits)
    att_prefill, gmm_prefill = pre["attention_launches"], pre["grouped_matmul_launches"]
    att_total = att_prefill + dec["attention_launches"]
    gmm_decode_loop = dec["grouped_matmul_launches"]
    gmm_total = gmm_prefill + gmm_decode_loop
    per_layer = 3 * cfg.n_layers  # gate, up and down products in every layer
    require(att_prefill == cfg.n_layers and att_total == cfg.n_layers,
            f"flash_attention launches: {att_prefill} in the prefill, {att_total} in all, "
            f"want {cfg.n_layers} and {cfg.n_layers}")
    require(gmm_prefill == per_layer, f"{gmm_prefill} moe_gmm launches in the prefill, "
            f"want {per_layer}")
    require(gmm_decode_loop == per_layer * (DECODE_STEPS - 1),
            f"{gmm_decode_loop} moe_gmm launches in {DECODE_STEPS - 1} decode steps, "
            f"want {per_layer * (DECODE_STEPS - 1)}")
    require(pre["selective_scan_launches"] + pre["lru_scan_launches"]
            + dec["selective_scan_launches"] + dec["lru_scan_launches"] == 0,
            "qwen3-moe-30b-a3b runs no scan")
    require(pre["attention_wgmma_launches"] == att_prefill
            and pre["grouped_matmul_wgmma_launches"] == gmm_prefill,
            f"every prefill attention and grouped matmul on the wgmma tiling: {pre}")
    require(dec["grouped_matmul_skinny_launches"] == gmm_decode_loop,
            f"every decode grouped matmul on the skinny tiling: {dec}")
    require(pre["attention_fma_launches"] + dec["attention_fma_launches"]
            + pre["grouped_matmul_fma_launches"] + dec["grouped_matmul_fma_launches"] == 0,
            f"no bf16 launch on an fma tiling: {pre}, {dec}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    decode_ms = timings["decode_s"] / (DECODE_STEPS - 1) * 1e3
    print(f"phase 4b serve: {B}x{PROMPT} prefill {timings['prefill_s'] * 1e3} ms, decode "
          f"{decode_ms} ms/token over {DECODE_STEPS - 1} steps, peak memory {peak_gb} GB, "
          f"flash_attention launches {att_prefill} (prefill, wgmma), moe_gmm launches "
          f"{gmm_prefill} (prefill, wgmma) + {gmm_decode_loop} ({DECODE_STEPS - 1} decode "
          f"steps, skinny), on {smi}")
    print(f"phase 4b serve: generated ids (first request): {ids[0].tolist()}")
    qwen_served = dict(ids=ids, logits=logits, pre=pre, dec=dec, timings=timings)
    del logits

    # The served model's first MoE layer, bf16 on the card, against an fp32
    # copy on the CPU, on 64 tokens (N = 64, C = 5): dispatch, the kernel and
    # the combine at full width against the plain path.
    moe0 = model.blocks[0].moe
    moe_cpu = SimpleNamespace(**{n: t.float().cpu() for n, t in moe0.named_parameters()})
    x_in = layers.rms_norm(model.embed[tokens[:1, :64]], moe0.norm)  # (1, 64, 2048) bf16
    ops.grouped_matmul_launches = 0
    y_gpu, aux_gpu = layers.moe(moe0, x_in, cfg)
    require(ops.grouped_matmul_launches == 3, "the layer ran three moe_gmm launches")
    y_cpu, aux_cpu = layers.moe(moe_cpu, x_in.float().cpu(), cfg)
    err = float((y_gpu.float().cpu() - y_cpu).abs().max())
    require(torch.allclose(y_gpu.float().cpu(), y_cpu, rtol=2e-2, atol=2e-2),
            f"full-width MoE layer, bf16 card vs fp32 CPU: max|err| {err}")
    print(f"phase 4b layer: full-width MoE layer 0, 64 tokens (C = "
          f"{max(1, int(cfg.capacity_factor * 64 * cfg.top_k / cfg.n_experts))}), bf16 card "
          f"vs fp32 CPU: max|err| {err} (tol 2e-2), max|out| {float(y_cpu.abs().max())}, "
          f"aux {float(aux_gpu)} vs {float(aux_cpu)}")
    qwen_name = cfg.name
    del moe0, moe_cpu, x_in, y_gpu, y_cpu
    # Phase 7f (qwen3-moe-30b-a3b): the same model and prompts through
    # jit_serve_step.
    mesh_served[qwen_name] = mesh_serve_check(train_steps, sharding, device_order, ops, model,
                                              tokens, qwen_served, dev, smi, "phase 4b")
    del model, tokens, ids, qwen_served

    # Phases 4c and 4d: the recurrent families, each after the previous model
    # is freed.  Each layer's scan runs the kernel at prefill and a plain step
    # at decode.  Then DLRM (4e), the VLM (4f) and the audio encoder (4g).
    falcon = serve_checked(lm, ops, generate, get_config("falcon-mamba-7b"), PROMPT, gen,
                           dev, smi, "4c")
    griffin = serve_checked(lm, ops, generate, get_config("recurrentgemma-9b"), PROMPT_RG,
                            gen, dev, smi, "4d")
    bag_launches = score_dlrm(dlrm, ops, ref_embedding_bag, dev, smi)
    vlm = serve_checked(lm, ops, generate, get_config("llama-3.2-vision-11b"), PROMPT, gen,
                        dev, smi, "4f")
    hubert = encode_audio(lm, ops, get_config("hubert-xlarge"), dev, smi)
    # Phase 4h: deepseek-coder-33b at full depth (62 layers, about 66.7 GB of
    # bf16 weights, drawn on the card a layer at a time).
    deepseek = serve_checked(lm, ops, generate, get_config("deepseek-coder-33b"), PROMPT, gen,
                             dev, smi, "4h")

    # Phase 5: training.  The narrow config's resume first, then minicpm-2b
    # at full width and depth.
    resume = resume_check(train_loop, optim, train_config(get_config, 4), dev)
    print(f"phase 5 resume: narrow fp32 {TRAIN_ARCH}, checkpoint every 2 steps, failure at step "
          f"4, resumed to 8: last four losses {resume['resumed']} vs uninterrupted "
          f"{resume['whole'][4:]}, max relative err {resume['max_rel_err']} (tol 1e-5)")
    L_ = get_config(TRAIN_ARCH).n_layers
    want = {n: 0 for n in COUNTERS}
    want.update(attention_launches=2 * L_, attention_wgmma_launches=2 * L_,
                attention_bwd_launches=L_, attention_bwd_wgmma_launches=L_)
    trained = release(train_full(lm, ops, optim, make_train_step, data, get_config(TRAIN_ARCH),
                                 dev, smi, "5", want, ("embed", "blocks.0.attn.wq", "final_norm")))
    train_fwd = trained["counts"]["attention_launches"]
    train_bwd = trained["counts"]["attention_bwd_launches"]
    summary = {k: trained[k] for k in ("n_params", "step_ms", "tokens_per_s", "mfu", "peak_gb")}
    print(f"phase 5 summary: {json.dumps(summary)} on {smi}")
    dlrm_trained = train_dlrm_paper(dlrm, dlrm_testbed, optim, ops, group_of, dev, smi)
    summary = {k: dlrm_trained[k] for k in ("n_params", "step_ms", "samples_per_s", "peak_gb",
                                             "idle_share", "split_ms")}
    print(f"phase 5b summary: {json.dumps(summary)} on {smi}")
    train_bag_fwd = dlrm_trained["counts"]["bag_lookup_launches"]
    train_bag_bwd = dlrm_trained["counts"]["bag_lookup_bwd_launches"]

    # Phase 5c: qwen3-moe-30b-a3b trained at full width, 4 of its 48 layers
    # (the training state of all 48, about 490 GB, does not fit one card).
    # Remat "full" runs each layer's forward twice: 6 grouped matmuls and 2
    # attention launches a layer, then 3 backward calls and 1 launch.
    t_moe = time.perf_counter()
    moe_cfg = dataclasses.replace(get_config(MOE_TRAIN_ARCH), n_layers=MOE_TRAIN_LAYERS)
    L_ = moe_cfg.n_layers
    want = {n: 0 for n in COUNTERS}
    want.update(attention_launches=2 * L_, attention_wgmma_launches=2 * L_,
                attention_bwd_launches=L_, attention_bwd_wgmma_launches=L_,
                grouped_matmul_launches=6 * L_, grouped_matmul_wgmma_launches=6 * L_,
                grouped_matmul_bwd_launches=3 * L_, grouped_matmul_bwd_wgmma_launches=3 * L_)
    want_moe = dict(want)
    # First through the training loop a user calls (train.loop.train: its own
    # model, optimizer state and data stream), 3 steps, every count set to 0
    # just before and read just after; then the timed run below.
    from repro_torch.configs.base import ShapeSpec

    for n in COUNTERS:
        setattr(ops, n, 0)
    t0 = time.perf_counter()
    looped = train_loop.train(moe_cfg, ShapeSpec("train_4k_b4", TRAIN_S, TRAIN_B, "train"),
                              optim.adamw(optim.wsd(TRAIN_LR, 3)),
                              sharding.ShardingPlan(fsdp=False, remat="full",
                                                    loss_chunk=LOSS_CHUNK),
                              total_steps=3, logger=lambda *a: None, device=dev)
    torch.cuda.synchronize()
    loop_counts = {n: getattr(ops, n) for n in COUNTERS}
    require(looped.final_step == 3 and all(math.isfinite(x) for x in looped.losses),
            f"train.loop.train of {moe_cfg.name}: {looped}")
    require(loop_counts == {n: 3 * c for n, c in want.items()},
            f"train.loop.train launches {loop_counts}, want 3 x {want}")
    print(f"phase 5c loop: train.loop.train of {moe_cfg.name} ({L_} layers), 3 steps at "
          f"{TRAIN_B} x {TRAIN_S} in {time.perf_counter() - t0:.2f} s with its init: losses "
          f"{looped.losses}, launches {loop_counts}")
    del looped
    gc.collect()
    torch.cuda.empty_cache()
    # Its untied head's logits have a variance near 0.8 at init, which lifts
    # the first loss about 0.4 above ln V: a bar of 1 rather than 0.5.
    moe_run = train_full(lm, ops, optim, make_train_step, data, moe_cfg, dev, smi, "5c", want,
                         ("embed", "lm_head", "blocks.0.attn.wq", "blocks.0.moe.router",
                          "blocks.0.moe.wg", f"blocks.{L_ - 1}.moe.wd", "final_norm"),
                         warmup=MOE_WARMUP, loss0_tol=1.0)
    moe_trace = trace_train_step(lm, moe_run, moe_cfg, group_of, "5c", smi)
    moe_trained = release(moe_run)
    summary = {k: moe_trained[k] for k in ("n_params", "active_params", "step_ms",
                                            "tokens_per_s", "model_tflop", "mfu", "peak_gb")}
    summary.update(moe_trace)
    print(f"phase 5c summary: {json.dumps(summary)} in {time.perf_counter() - t_moe:.2f} s, on "
          f"{smi}")

    moe_counts = moe_trained["counts"]
    moe_path = (f"{MOE_TRAIN_ARCH} train ({MOE_TRAIN_LAYERS} layers), "
                f"{MOE_WARMUP + TRAIN_STEPS} steps")

    # Phase 5d: falcon-mamba-7b trained at full width, 16 of its 64 layers.
    ssm_trained = train_ssm(lm, ops, optim, make_train_step, data, group_of,
                            dataclasses.replace(get_config(SSM_TRAIN_ARCH),
                                                n_layers=SSM_TRAIN_LAYERS), dev, smi)
    ssm_counts = ssm_trained["counts"]
    ssm_path = (f"{SSM_TRAIN_ARCH} train ({SSM_TRAIN_LAYERS} layers), "
                f"{SSM_WARMUP + TRAIN_STEPS} steps")

    # Phase 5e: recurrentgemma-9b trained at full width, 5 of its 38 layers, at
    # 1 x 4096; then the serve_decode twin on the card.
    hyb_trained = train_hybrid(lm, ops, optim, make_train_step, data, group_of,
                               dataclasses.replace(get_config(HYB_TRAIN_ARCH),
                                                   n_layers=HYB_TRAIN_LAYERS), dev, smi)
    hyb_counts = hyb_trained["counts"]
    hyb_path = (f"{HYB_TRAIN_ARCH} train ({HYB_TRAIN_LAYERS} layers), "
                f"{HYB_WARMUP + TRAIN_STEPS} steps")
    decode_line = serve_decode_twin("falcon-mamba-7b", smi)

    # Phase 5f: llama-3.2-vision-11b trained at full width, 10 of its 40
    # layers (two groups of 4 self layers and a cross layer, so that the
    # first cross layer's dk and dv feed later layers).  Phase 5g:
    # hubert-xlarge trained whole.
    vlm_cfg = dataclasses.replace(get_config(VLM_TRAIN_ARCH), n_layers=VLM_TRAIN_LAYERS)
    vlm_trained = train_vlm_or_encoder(
        lm, ops, optim, make_train_step, data, group_of, vlm_cfg, dev, smi, "5f",
        f"layers 40 -> {VLM_TRAIN_LAYERS}, global batch 256 -> {TRAIN_B} (sequence {TRAIN_S} "
        f"and {IMG_TOKENS} image tokens kept)")
    au_trained = train_vlm_or_encoder(
        lm, ops, optim, make_train_step, data, group_of, get_config(AU_TRAIN_ARCH), dev, smi,
        "5g", f"global batch 256 -> {TRAIN_B} (sequence {TRAIN_S} kept; every layer)")
    vlm_counts, au_counts = vlm_trained["counts"], au_trained["counts"]
    vlm_path = (f"{VLM_TRAIN_ARCH} train ({VLM_TRAIN_LAYERS} layers), "
                f"{2 + TRAIN_STEPS} steps")
    au_path = f"{AU_TRAIN_ARCH} train, {2 + TRAIN_STEPS} steps"

    # Phase 6: the planner on the card.
    planned = plan_phase(dev, smi)
    print(f"phase 6 summary: {json.dumps(planned)} on {smi}")
    replanned = online_phase(dev, smi)
    print(f"phase 6e-6f summary: {json.dumps(replanned)} on {smi}")

    # Phase 7: the §6 data-parallel trainer.  7a: the fma attention at head
    # dim 32, both ways; 7b: the twin of examples/train_lm_topoopt.py at world
    # size 1; 7c: the DP step at full width against make_train_step.
    d32 = [dict(fwd=check_attention_fwd((S, rest[1] if len(rest) > 1 else S, Dc, dt, causal, 0,
                                         kv, h), gen, dev, smi, batch=Bc, phase="7a"),
                bwd=check_attention_bwd((Bc, h, kv, S, Dc, dt, causal, *rest), gen, dev, smi,
                                        phase="7a"))
           for Bc, h, kv, S, Dc, dt, causal, *rest in D32_CASES]
    require(all(c["fwd"]["tiling"] == c["bwd"]["tiling"] == "fma" for c in d32),
            "head dim 32 runs on the fma tilings")
    torch.cuda.empty_cache()
    twin = topoopt_twin(ops, train_lm_topoopt, smi)
    dp = dp_step_check(lm, ops, optim, data, train_steps, compression, device_order,
                       get_config(AU_TRAIN_ARCH), dev, smi, au_trained["step_ms"])
    # Phase 7d: the GSPMD/FSDP trainer at world size 1 against 7c's plain run.
    gspmd = gspmd_step_check(lm, ops, optim, train_steps, sharding, device_order,
                             get_config(AU_TRAIN_ARCH), dev, smi, dp)
    del dp["plain"], dp["batches"]
    # Phase 7e: the GSPMD trainer on the MoE at 5c's depth and batch against
    # 5c's plain step.
    gspmd_moe = gspmd_moe_check(lm, ops, optim, data, train_steps, sharding, device_order,
                                moe_cfg, dev, smi, want_moe, moe_trained["step_ms"])
    print(f"phase 7e summary: {json.dumps(gspmd_moe)} on {smi}")
    # Phase 8: the dry run of 7e's cell against what 7e measured, and the CLI.
    dryrun = dryrun_check(want_moe, gspmd_moe, smi)
    print(f"phase 8 summary: {json.dumps(dryrun)} on {smi}")
    # Phase 9: the JAX package's smoke configs through the command lines.
    require(not torch.distributed.is_initialized(), "phase 9 starts with no process group")
    smoke = smoke_phase(lm, ops, serve_cli, train_cli, get_config, dev, smi)
    smoke_counts = smoke["counts"]

    print(f"chip_smoke: wall time {time.perf_counter() - T_START} s, the kernels' build "
          "included")

    print(json.dumps({"kernels": [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:84",
        "tpu_ref": "kernels/flash_attention.py:84",
        "tiling": main_case["tiling"],
        "launches": (granite_attention_launches + att_total + griffin["attention_launches"]
                     + vlm["attention_launches"] + hubert["attention_launches"]
                     + deepseek["attention_launches"] + train_fwd
                     + moe_counts["attention_launches"] + hyb_counts["attention_launches"]
                     + vlm_counts["attention_launches"] + au_counts["attention_launches"]
                     + twin["counts"]["attention_launches"] + dp["counts"]["attention_launches"]
                     + gspmd["counts"]["attention_launches"]
                     + gspmd_moe["counts"]["attention_launches"]
                     + sum(m["counts"]["attention_launches"] for m in mesh_served.values())
                     + smoke_counts["attention_launches"]),
        "launches_by_path": {"granite-8b": granite_attention_launches, qwen_name: att_total,
                             "recurrentgemma-9b": griffin["attention_launches"],
                             "llama-3.2-vision-11b": vlm["attention_launches"],
                             "hubert-xlarge": hubert["attention_launches"],
                             "deepseek-coder-33b": deepseek["attention_launches"],
                             f"{TRAIN_ARCH} train, {TRAIN_STEPS} steps": train_fwd,
                             moe_path: moe_counts["attention_launches"],
                             hyb_path: hyb_counts["attention_launches"],
                             vlm_path: vlm_counts["attention_launches"],
                             au_path: au_counts["attention_launches"],
                             TWIN_PATH: twin["counts"]["attention_launches"],
                             DP_PATH: dp["counts"]["attention_launches"],
                             GSPMD_PATH: gspmd["counts"]["attention_launches"],
                             GSPMD_MOE_PATH: gspmd_moe["counts"]["attention_launches"],
                             **{f"{n} {MESH_SERVE_PATH}": m["counts"]["attention_launches"]
                                for n, m in mesh_served.items()},
                             SMOKE_PATH: smoke_counts["attention_launches"]},
        "launches_d32": twin["counts"]["attention_fma_launches"],
        "launches_d16": smoke_counts["attention_wgmma_launches"],
        "max_abs_err": main_case["max_abs_err"],
        "max_err_bf16": main_case["max_abs_err"],
        "ms": main_case["kernel_ms"],
        "kernel_ms": main_case["kernel_ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
        "bf16_fma_ms": main_case["fma_ms"],
        "fp32_tiling": main_fp32["tiling"],
        "fp32_fma_ms": main_fp32["kernel_ms"],
        "d256_kernel_ms": rg_case["kernel_ms"],
        "d256_plain_ms": rg_case["plain_ms"],
        "d256_bound_ms": rg_case["bound_ms"],
        "d256_library_ms": rg_case["library_ms"],
        "d256_max_abs_err": rg_case["max_abs_err"],
        "d256_bf16_fma_ms": rg_case["fma_ms"],
        "d256_fp32_fma_ms": rg_fp32["kernel_ms"],
        "masked_rows_max_abs_err": masked_rows,
        "d80_tiling": au_case["tiling"],
        "d80_kernel_ms": au_case["kernel_ms"],
        "d80_plain_ms": au_case["plain_ms"],
        "d80_bound_ms": au_case["bound_ms"],
        "d80_bound_by": au_case["bound_by"],
        "d80_library_ms": au_case["library_ms"],
        "d80_max_abs_err": au_case["max_abs_err"],
        "d80_bf16_fma_ms": au_case["fma_ms"],
        "d80_fp16_kernel_ms": au_fp16["kernel_ms"],
        "d80_fp32_fma_ms": au_fp32["kernel_ms"],
        "d80_kernel_over_library": au_case["kernel_ms"] / au_case["library_ms"],
        "train_d80_kernel_over_library": bwd[6]["fwd_ms"] / bwd[6]["fwd_library_ms"],
        "cross_kernel_ms": cross_case["kernel_ms"],
        "cross_plain_ms": cross_case["plain_ms"],
        "cross_bound_ms": cross_case["bound_ms"],
        "cross_bound_by": cross_case["bound_by"],
        "cross_library_ms": cross_case["library_ms"],
        "cross_max_abs_err": cross_case["max_abs_err"],
        "cross_bf16_fma_ms": cross_case["fma_ms"],
        "train_fwd_ms": bwd[0]["fwd_ms"],
        "train_fwd_lse_ms": bwd[0]["fwd_lse_ms"],
        "train_fwd_plain_ms": bwd[0]["fwd_plain_ms"],
        "train_fwd_library_ms": bwd[0]["fwd_library_ms"],
        "train_lse_max_abs_err": bwd[0]["lse_max_abs_err"],
        **{f"train_{name}_{k}": bwd[i][k] for name, i in (("d80", 6), ("cross", 10))
           for k in ("fwd_ms", "fwd_lse_ms", "fwd_plain_ms", "fwd_library_ms", "fwd_bound_ms",
                     "lse_max_abs_err")},
        **{f"{name}_{k}": d32[i]["fwd"][k]
           for name, i in (("d32", 0), ("d32_s2048", 1), ("d32_ragged", 2), ("d32_sq_ne_sk", 3))
           for k in ("tiling", "max_abs_err", "kernel_ms", "plain_ms", "library_ms", "bound_ms",
                     "bound_by")},
        **{f"dims_d{dh}_{k}": numbers["fwd"][k] for dh, numbers in dims.items()
           for k in ("tiling", "max_abs_err", "kernel_ms", "fma_ms", "plain_ms", "library_ms",
                     "bound_ms", "bound_by")},
        **{f"dims_d{dh}_ragged_max_abs_err": numbers["ragged_max_abs_err"]
           for dh, numbers in dims.items()},
    }, {
        "name": "flash_attention_bwd",
        "route": "cuda",
        "tiling": bwd[0]["tiling"],
        "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
        "replaces": None,  # the TPU side has no backward kernel (jax.grad of XLA code)
        "launches": (train_bwd + moe_counts["attention_bwd_launches"]
                     + hyb_counts["attention_bwd_launches"] + vlm_counts["attention_bwd_launches"]
                     + au_counts["attention_bwd_launches"]
                     + twin["counts"]["attention_bwd_launches"]
                     + dp["counts"]["attention_bwd_launches"]
                     + gspmd["counts"]["attention_bwd_launches"]
                     + gspmd_moe["counts"]["attention_bwd_launches"]
                     + smoke_counts["attention_bwd_launches"]),
        "launches_by_path": {f"{TRAIN_ARCH} train, {TRAIN_STEPS} steps": train_bwd,
                             moe_path: moe_counts["attention_bwd_launches"],
                             hyb_path: hyb_counts["attention_bwd_launches"],
                             vlm_path: vlm_counts["attention_bwd_launches"],
                             au_path: au_counts["attention_bwd_launches"],
                             TWIN_PATH: twin["counts"]["attention_bwd_launches"],
                             DP_PATH: dp["counts"]["attention_bwd_launches"],
                             GSPMD_PATH: gspmd["counts"]["attention_bwd_launches"],
                             GSPMD_MOE_PATH: gspmd_moe["counts"]["attention_bwd_launches"],
                             SMOKE_PATH: smoke_counts["attention_bwd_launches"]},
        "launches_d32": twin["counts"]["attention_bwd_fma_launches"],
        "launches_d16": smoke_counts["attention_bwd_wgmma_launches"],
        "launches_per_step": trained["launches_per_step"]["attention_bwd_launches"],
        "launches_per_step_d256": hyb_trained["launches_per_step"]["attention_bwd_launches"],
        "launches_per_step_vlm": vlm_trained["launches_per_step"]["attention_bwd_launches"],
        "launches_per_step_d80": au_trained["launches_per_step"]["attention_bwd_launches"],
        "launches_wgmma": (trained["counts"]["attention_bwd_wgmma_launches"]
                           + moe_counts["attention_bwd_wgmma_launches"]
                           + hyb_counts["attention_bwd_wgmma_launches"]
                           + vlm_counts["attention_bwd_wgmma_launches"]
                           + au_counts["attention_bwd_wgmma_launches"]),
        "ms": bwd[0]["kernel_ms"],
        **{k: bwd[0][k] for k in ("max_abs_err", "max_abs_err_by_grad", "kernel_ms", "plain_ms",
                                  "library_ms", "bound_ms", "bound_by", "fma_kernel_ms",
                                  "fma_max_abs_err")},
        **{f"gqa_d128_{k}": bwd[1][k] for k in ("tiling", "max_abs_err", "kernel_ms", "plain_ms",
                                                 "library_ms", "bound_ms", "fma_kernel_ms")},
        **{f"fp32_{k}": bwd[2][k] for k in ("tiling", "max_abs_err", "kernel_ms", "library_ms",
                                             "bound_ms")},
        **{f"d256_{k}": bwd[4][k] for k in ("tiling", "max_abs_err", "kernel_ms", "plain_ms",
                                             "library_ms", "library_backend", "bound_ms",
                                             "bound_by", "fma_kernel_ms", "unsplit_kernel_ms",
                                             "fwd_ms", "fwd_bound_ms")},
        **{f"d256_fp32_{k}": bwd[5][k] for k in ("tiling", "max_abs_err", "kernel_ms",
                                                  "plain_ms", "library_ms", "bound_ms")},
        **{f"{name}_{k}": bwd[i][k]
           for name, i in (("d80", 6), ("d80_ragged", 7), ("d80_sq_ne_sk", 8), ("d80_fp32", 9),
                           ("cross", 10))
           for k in ("tiling", "max_abs_err", "kernel_ms", "plain_ms", "library_ms",
                     "library_backend", "bound_ms", "bound_by", "fwd_ms", "fwd_bound_ms")},
        **{f"{name}_fma_kernel_ms": bwd[i]["fma_kernel_ms"]
           for name, i in (("d80", 6), ("d80_ragged", 7), ("d80_sq_ne_sk", 8), ("cross", 10))},
        **{f"{name}_{k}": d32[i]["bwd"][k]
           for name, i in (("d32", 0), ("d32_s2048", 1), ("d32_ragged", 2), ("d32_sq_ne_sk", 3))
           for k in ("tiling", "max_abs_err", "kernel_ms", "plain_ms", "library_ms",
                     "library_backend", "bound_ms", "bound_by", "fwd_ms", "fwd_bound_ms")},
        "d80_kernel_over_library": bwd[6]["kernel_ms"] / bwd[6]["library_ms"],
        **{f"tp16_{name}_{k}": tp16_attn[i]["bwd"][k]
           for name, i in (("qwen3", 0), ("recurrentgemma", 1))
           for k in ("max_abs_err", "kernel_ms", "plain_ms", "library_ms", "bound_ms",
                     "bound_by")},
        **{f"dims_d{dh}_{k}": numbers["bwd"][k] for dh, numbers in dims.items()
           for k in ("tiling", "max_abs_err", "kernel_ms", "fma_kernel_ms", "plain_ms",
                     "library_ms", "bound_ms", "bound_by")},
    }, {
        "name": "moe_gmm",
        "route": "cuda",
        "source": "src/repro_torch/csrc/moe_gmm.cu",
        "replaces": "src/repro/kernels/moe_gmm.py:40",
        "tpu_ref": "kernels/moe_gmm.py:40",
        "tiling": gmm_main["tiling"],
        "decode_tiling": gmm_decode["tiling"],
        "launches": (gmm_total + moe_counts["grouped_matmul_launches"]
                     + gspmd_moe["counts"]["grouped_matmul_launches"]
                     + mesh_served[qwen_name]["counts"]["grouped_matmul_launches"]
                     + smoke_counts["grouped_matmul_launches"]),
        "launches_by_path": {qwen_name: gmm_total,
                             moe_path: moe_counts["grouped_matmul_launches"],
                             GSPMD_MOE_PATH: gspmd_moe["counts"]["grouped_matmul_launches"],
                             f"{qwen_name} {MESH_SERVE_PATH}":
                                 mesh_served[qwen_name]["counts"]["grouped_matmul_launches"],
                             SMOKE_PATH: smoke_counts["grouped_matmul_launches"]},
        "launches_per_train_step": moe_trained["launches_per_step"]["grouped_matmul_launches"],
        "launches_prefill": gmm_prefill,
        "launches_per_decode_step": gmm_decode_loop // (DECODE_STEPS - 1),
        "max_abs_err": gmm_main["max_abs_err"],
        "max_err_bf16": gmm_main["max_abs_err"],
        "ms": gmm_main["kernel_ms"],
        "kernel_ms": gmm_main["kernel_ms"],
        "plain_ms": gmm_main["plain_ms"],
        "bound_ms": gmm_main["bound_ms"],
        "bound_by": gmm_main["bound_by"],
        "library_ms": gmm_main["library_ms"],
        "bf16_fma_ms": gmm_main["fma_ms"],
        "fp32_tiling": gmm_fp32["tiling"],
        "fp32_fma_ms": gmm_fp32["kernel_ms"],
        "down_kernel_ms": gmm_down["kernel_ms"],
        "down_bound_ms": gmm_down["bound_ms"],
        "down_library_ms": gmm_down["library_ms"],
        "decode_kernel_ms": gmm_decode["kernel_ms"],
        "decode_bound_ms": gmm_decode["bound_ms"],
        "decode_library_ms": gmm_decode["library_ms"],
        "decode_down_kernel_ms": gmm_decode_down["kernel_ms"],
        "decode_down_bound_ms": gmm_decode_down["bound_ms"],
        "decode_down_library_ms": gmm_decode_down["library_ms"],
        "train_kernel_ms": gmm_train["kernel_ms"],
        "train_bound_ms": gmm_train["bound_ms"],
        "train_library_ms": gmm_train["library_ms"],
        "train_down_kernel_ms": gmm_train_down["kernel_ms"],
        "train_down_bound_ms": gmm_train_down["bound_ms"],
        "train_down_library_ms": gmm_train_down["library_ms"],
        **{f"tp16_{name}_{k}": numbers[k] for name, numbers in (("gate_up", gmm_tp16),
                                                                ("down", gmm_tp16_down))
           for k in ("tiling", "max_abs_err", "kernel_ms", "plain_ms", "library_ms",
                     "bound_ms", "bound_by")},
        "skinny_decode_like_kernel_ms": decode_like["gate"]["kernel_ms"],
        "skinny_decode_like_bound_ms": decode_like["gate"]["bound_ms"],
        "skinny_decode_like_library_ms": decode_like["gate"]["library_ms"],
        "skinny_decode_like_max_abs_err": decode_like["gate"]["max_abs_err"],
        "skinny_live_experts": decode_like["gate"]["live"],
        "skinny_decode_like_down_kernel_ms": decode_like["down"]["kernel_ms"],
        "skinny_decode_like_down_bound_ms": decode_like["down"]["bound_ms"],
        "skinny_decode_like_down_library_ms": decode_like["down"]["library_ms"],
        "skinny_live_experts_down": decode_like["down"]["live"],
    }, {
        "name": "moe_gmm_bwd",
        "route": "cuda",
        "tiling": gmm_bwd["gate_up"]["tiling"],
        "source": "src/repro_torch/csrc/moe_gmm_bwd.cu",
        # The TPU side has no backward kernel (jax.grad of the XLA einsums).
        "replaces": "none: jax.grad of the XLA einsums at src/repro/models/layers.py:346-348",
        "library": "torch.bmm (dx and dw)",
        "launches": (moe_counts["grouped_matmul_bwd_launches"]
                     + gspmd_moe["counts"]["grouped_matmul_bwd_launches"]
                     + smoke_counts["grouped_matmul_bwd_launches"]),
        "launches_by_path": {moe_path: moe_counts["grouped_matmul_bwd_launches"],
                             GSPMD_MOE_PATH: gspmd_moe["counts"]["grouped_matmul_bwd_launches"],
                             SMOKE_PATH: smoke_counts["grouped_matmul_bwd_launches"]},
        "launches_per_step": moe_trained["launches_per_step"]["grouped_matmul_bwd_launches"],
        "launches_wgmma": moe_counts["grouped_matmul_bwd_wgmma_launches"],
        "ms": gmm_bwd["gate_up"]["kernel_ms"],
        **gmm_bwd["gate_up"],
        **{f"{name}_{k}": v for name, numbers in gmm_bwd.items() if name != "gate_up"
           for k, v in numbers.items()},
    }, {
        "name": "mamba_scan",
        "route": "cuda",
        "tiling": "sequential",
        "source": "src/repro_torch/csrc/mamba_scan.cu",
        "replaces": "src/repro/kernels/mamba_scan.py:57",
        "tpu_ref": "kernels/mamba_scan.py:57",
        "launches": falcon["selective_scan_launches"] + ssm_counts["selective_scan_launches"],
        "launches_by_path": {"falcon-mamba-7b": falcon["selective_scan_launches"],
                             ssm_path: ssm_counts["selective_scan_launches"]},
        "launches_per_train_step": ssm_trained["launches_per_step"]["selective_scan_launches"],
        "ms": mamba_main["kernel_ms"],
        **mamba_main,
        "training_ms": mamba_bwd["training"]["fwd_ms"],
        "training_ckpt_ms": mamba_bwd["training"]["fwd_ckpt_ms"],
        **{f"tp16_{k}": v for k, v in mamba_tp16.items()},
    }, {
        "name": "mamba_scan_bwd",
        "route": "cuda",
        "tiling": "the forward's checkpoints, 8-step chunks forward then back",
        "source": "src/repro_torch/csrc/mamba_scan_bwd.cu",
        # The TPU side has no backward kernel (jax.grad of the XLA scan).
        "replaces": "none: jax.grad of chunked_linear_scan at src/repro/models/layers.py:364",
        "library": None,
        "launches": ssm_counts["selective_scan_bwd_launches"],
        "launches_by_path": {ssm_path: ssm_counts["selective_scan_bwd_launches"]},
        "launches_per_step": ssm_trained["launches_per_step"]["selective_scan_bwd_launches"],
        "ms": mamba_bwd["training"]["kernel_ms"],
        **mamba_bwd["training"],
        **{f"{name}_{k}": v for name, numbers in mamba_bwd.items() if name != "training"
           for k, v in numbers.items()},
    }, {
        "name": "rglru_scan",
        "route": "cuda",
        "tiling": "redesigned: a block a 32-channel tile walking time in 128-step rounds "
                  "staged by TMA, 16-step chunks a warp, the carries composed in order",
        "source": "src/repro_torch/csrc/rglru_scan.cu",
        "replaces": "src/repro/kernels/rglru_scan.py:42",
        "tpu_ref": "kernels/rglru_scan.py:42",
        "launches": (griffin["lru_scan_launches"] + hyb_counts["lru_scan_launches"]
                     + smoke_counts["lru_scan_launches"]),
        "launches_by_path": {"recurrentgemma-9b": griffin["lru_scan_launches"],
                             hyb_path: hyb_counts["lru_scan_launches"],
                             SMOKE_PATH: smoke_counts["lru_scan_launches"]},
        "launches_per_train_step": hyb_trained["launches_per_step"]["lru_scan_launches"],
        "ms": lru_fwd["prefill"]["kernel_ms"],
        **lru_fwd["prefill"],
        **{f"{name}_{k}": v for name, numbers in lru_fwd.items() if name != "prefill"
           for k, v in numbers.items()},
    }, {
        "name": "rglru_scan_bwd",
        "route": "cuda",
        "tiling": "redesigned: one launch, the forward's rounds mirrored in reverse time "
                  "(a, dh and h staged by TMA), the carries composed in order",
        "source": "src/repro_torch/csrc/rglru_scan_bwd.cu",
        # The TPU side has no backward kernel (jax.grad of the XLA scan).
        "replaces": "none: jax.grad of chunked_linear_scan at src/repro/models/layers.py:364",
        "library": None,
        "launches": hyb_counts["lru_scan_bwd_launches"],
        "launches_by_path": {hyb_path: hyb_counts["lru_scan_bwd_launches"]},
        "launches_per_step": hyb_trained["launches_per_step"]["lru_scan_bwd_launches"],
        "ms": lru_bwd["training"]["kernel_ms"],
        **lru_bwd["training"],
        **{f"{name}_{k}": v for name, numbers in lru_bwd.items() if name != "training"
           for k, v in numbers.items()},
    }, {
        "name": "embedding_bag",
        "route": "cuda",
        "source": "src/repro_torch/csrc/embedding_bag.cu",
        "replaces": "src/repro/kernels/embedding_bag.py:33",
        "tpu_ref": "kernels/embedding_bag.py:33",
        "launches": sum(bag_launches.values()) + train_bag_fwd,
        "launches_by_path": {DLRM_PATH: sum(bag_launches.values()),
                             f"{DLRM_TRAIN_PATH}, {dlrm_trained['steps']} steps": train_bag_fwd},
        "launches_per_forward": bag_launches,
        "ms": bag["serving"]["kernel_ms"],
        **bag["serving"],
        **{f"multihot_{k}": v for k, v in bag["multi"].items()},
        **{f"scoring_b4096_{k}": v for k, v in bag["scoring"].items()},
        **{f"{name}_{k}": v for name, numbers in bag.items()
           if name not in ("serving", "multi", "scoring") for k, v in numbers.items()},
    }, {
        "name": "embedding_bag_bwd",
        "route": "cuda",
        "tiling": bag_bwd["training"]["tiling"],
        "launches_small": dlrm_trained["counts"]["bag_lookup_bwd_small_launches"],
        "launches_sorted": dlrm_trained["counts"]["bag_lookup_bwd_sorted_launches"],
        "source": "src/repro_torch/csrc/embedding_bag_bwd.cu",
        # The TPU side has no backward kernel (jax.grad of the gather).
        "replaces": "none: jax.grad of the gather at src/repro/models/dlrm.py:78",
        "library": "index_add_ (no fill)",
        "launches": train_bag_bwd,
        "launches_by_path": {f"{DLRM_TRAIN_PATH}, {dlrm_trained['steps']} steps": train_bag_bwd},
        "launches_per_step": train_bag_bwd / dlrm_trained["steps"],
        "ms": bag_bwd["training"]["kernel_ms"],
        **bag_bwd["training"],
        **{f"{name}_{k}": v for name, numbers in bag_bwd.items() if name != "training"
           for k, v in numbers.items()},
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


def check_bag(embedding_bag, ref_embedding_bag, gen, dev, smi) -> dict:
    """The embedding bag against its plain version on the paper DLRM's
    tables; returns each case's numbers, by name.  One id a bag sums one
    row, so those cases must be bitwise equal; otherwise test_kernels.py's
    bars (fp32: rtol 1e-6 and NNZ ulps of the largest term; bf16: 2e-2), and
    every case bitwise equal to the sum in j's order
    (``ref_embedding_bag_in_order``), the kernel's own order.  Each case
    prints its tiling and its device time as a share of its bound."""
    from repro_torch.kernels.embedding_bag import bag_fwd_split
    from repro_torch.kernels.ref import ref_embedding_bag_in_order

    T, R, E = T_DLRM, R_DLRM, E_DLRM

    def ids(Bb, nnz, low=0, high=R, dtype=torch.int32, nT=T):
        return torch.randint(low, high, (Bb, nT, nnz), generator=gen, device=dev).to(dtype)

    def case(label, tab, idx, exact=False) -> dict:
        out = embedding_bag(tab, idx)
        torch.cuda.synchronize()
        ref = ref_embedding_bag(tab, idx)
        err = float((out.float() - ref.float()).abs().max())
        if exact:
            ok, tol = torch.equal(out, ref), 0.0
        elif tab.dtype == torch.float32:
            lo, hi = tab.aminmax()  # no (T, R, E) temporary, as abs() would make
            tol = idx.shape[2] * torch.finfo(torch.float32).eps * max(-float(lo), float(hi))
            ok = torch.allclose(out, ref, rtol=1e-6, atol=tol)
        else:
            tol = 2e-2
            ok = torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol)
        del ref
        require(bool(torch.isfinite(out).all()), f"finite kernel output, {label}")
        require(ok, f"embedding_bag vs plain, {label}: max|err| {err} (tol {tol})")
        require(torch.equal(out, ref_embedding_bag_in_order(tab, idx)),
                f"embedding_bag {label}: not bitwise the sum in j's order")
        split = bag_fwd_split(tab, idx)
        numbers = bag_times(embedding_bag, ref_embedding_bag, tab, idx, out)
        numbers["max_abs_err"] = err
        numbers["bound_share"] = numbers["bound_ms"] / numbers["device_ms"]
        numbers["bound_share_cold"] = numbers["bound_ms"] / numbers["device_cold_ms"]
        numbers["tiling"] = (f"gather G={split['unit']} L={split['lanes']} VEC={split['vec']} "
                             f"Q={split['rows']}")
        print(f"phase 3 kernel: embedding_bag {label}: max|err| {err} (tol {tol}"
              f"{', bitwise' if exact else ''}; bitwise the sum in j's order) kernel_ms "
              f"{numbers['kernel_ms']} plain_ms {numbers['plain_ms']} library_ms "
              f"{numbers['library_ms']} (max|err| {numbers['library_err']}; CUDA events) "
              f"device_ms {numbers['device_ms']} library_device_ms "
              f"{numbers['library_device_ms']} (torch.profiler, back to back) device_cold_ms "
              f"{numbers['device_cold_ms']} library_device_cold_ms "
              f"{numbers['library_device_cold_ms']} (each call after a read of "
              f"{L2_FLUSH_BYTES >> 20} MB) bound_ms {numbers['bound_ms']} ({numbers['bound_by']}; "
              f"{numbers['rows_read']} distinct rows; {numbers['bound_share']:.1%} of it back to "
              f"back, {numbers['bound_share_cold']:.1%} cold) tiling {numbers['tiling']} (G bags "
              f"a unit, L lanes a row, VEC values a load, Q rows in flight a lane) on {smi}")
        return {k: numbers[k] for k in BAG_KEYS}

    cases = {}
    tables = torch.randn(T, R, E, generator=gen, device=dev)  # 40.96 GB
    # The serving lookup's CUDA-event time is of back-to-back launches that
    # the host paces; its device_ms (the profiler) is the kernel's alone.
    cases["serving"] = case("serving B=128 NNZ=1 fp32 int32", tables, ids(128, 1), exact=True)
    cases["scoring"] = case("B=4096 NNZ=1 fp32 int32", tables, ids(4096, 1), exact=True)
    cases["scoring_int64"] = case("B=4096 NNZ=1 fp32 int64", tables,
                                  ids(4096, 1, dtype=torch.int64), exact=True)
    cases["multi"] = case("multi-hot B=4096 NNZ=32 fp32 int32", tables, ids(4096, 32))
    cases["near_end"] = case("ids near R-1 B=128 NNZ=4 fp32 int32", tables,
                             ids(128, 4, R - 1000))
    # Ids past the table read the rows the reference's gather clamps and wraps to.
    rows = {R: R - 1, R + 5: R - 1, -1: R - 1, -R: 0, -R - 3: 0, 2**31 - 1: R - 1,
            -(2**31): 0, 0: 0}
    past = torch.tensor(list(rows), device=dev).repeat(16)
    want = torch.tensor([rows[int(i)] for i in past.tolist()], device=dev)
    past = past[:, None, None].expand(-1, T, 1).to(torch.int32)
    require(torch.equal(embedding_bag(tables, past),
                        tables[torch.arange(T, device=dev)[None, :], want[:, None]]),
            "ids R, -1 and beyond read the clamped and wrapped rows")
    cases["past"] = case("ids past the table B=128 NNZ=1 fp32 int32", tables, past, exact=True)
    # B * T = 28665 bags: one past a whole number of units (and of warps).
    cases["ragged_b"] = case("ragged B=4095 T=7 NNZ=1 fp32 int32", tables[:7],
                             ids(4095, 1, nT=7), exact=True)
    del tables
    torch.cuda.empty_cache()

    tables = torch.randn(T, R, E, generator=gen, device=dev, dtype=torch.bfloat16)
    cases["serving_bf16"] = case("serving B=128 NNZ=1 bf16 int32", tables, ids(128, 1),
                                 exact=True)
    cases["scoring_bf16"] = case("B=4096 NNZ=1 bf16 int32", tables, ids(4096, 1), exact=True)
    cases["multi_bf16"] = case("multi-hot B=4096 NNZ=32 bf16 int32", tables, ids(4096, 32))
    del tables
    torch.cuda.empty_cache()
    # Rows of 52 bytes (E = 13: one value a lane), with int64 ids.
    tables = torch.randn(T, R, 13, generator=gen, device=dev)
    cases["ragged_e13"] = case("ragged E=13 B=128 NNZ=7 fp32 int64", tables,
                               ids(128, 7, dtype=torch.int64))
    del tables
    return cases


def kernel_device_ms(fn, iters: int, launches: dict | None = None) -> dict:
    """Device time (ms per call of ``fn``) of each kernel ``fn`` launches, by
    name, from ``torch.profiler`` over ``iters`` calls after one warm-up;
    ``launches``, if given, gets each kernel's launches per call.  A session
    that records no device event at all (the profiler drops a session's
    events now and then) is run again, up to twice."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        if events:
            break
    if launches is not None:
        launches.update({e.key: e.count / iters for e in events})
    return {e.key: e.self_device_time_total / 1e3 / iters for e in events}


def launch_ms(fn, iters: int, pattern: str, flush=None) -> float:
    """The device ms per call of the one kernel named like ``pattern`` that
    ``fn`` launches once a call, by ``torch.profiler`` over ``iters`` calls
    (each after ``flush()``, where given, whose kernels are not counted); a
    session that saw fewer launches than calls (the profiler drops events
    now and then) is run again, up to twice, then the check fails."""
    for _ in range(3):
        launches: dict = {}
        times = kernel_device_ms(fn if flush is None else (lambda: (flush(), fn())), iters,
                                 launches)
        hits = [k for k in times if pattern in k]
        if hits and sum(launches[k] for k in hits) == 1:
            return sum(times[k] for k in hits)
    require(False, f"the profiler saw one {pattern} a call: {launches}")


def profiled(fn, want=(), tries: int = 3, ops: dict | None = None,
             mark=None) -> tuple[float, dict]:
    """``fn(i)`` (i the attempt) under ``torch.profiler`` -> (host wall ms
    after a synchronise, {kernel: device ms}); ``ops``, if given, gets the
    device ms of the kernels each operator launched itself, by operator.
    ``mark``, if given, is (predicate, enough, out): the session records input
    shapes, and ``out`` gets the device ms, by kernel, of the kernels launched
    by the operators for which ``predicate(name, input_shapes)`` holds.  A
    session that recorded no device event, no kernel named like one of each
    tuple of patterns in ``want``, or marked kernels for which ``enough``
    fails (the profiler drops events now and then), is run again, up to
    ``tries`` times; then the check fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for i in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=mark is not None) as prof:
            t0 = time.perf_counter()
            fn(i)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = {e.key: e.self_device_time_total / 1e3 for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA}
        marked: dict = {}
        if mark is not None:
            predicate, enough, _ = mark
            for e in prof.events():
                if e.device_type == DeviceType.CPU and e.kernels and predicate(e.name,
                                                                               e.input_shapes):
                    for k in e.kernels:
                        marked[k.name] = marked.get(k.name, 0.0) + k.duration / 1e3
            if not enough(marked):
                continue
        if kernels and all(any(p in k for k in kernels for p in alts) for alts in want):
            if mark is not None:
                mark[2].update(marked)
            if ops is not None:
                ops.update({e.key: e.self_device_time_total / 1e3 for e in prof.key_averages()
                            if e.device_type == DeviceType.CPU and e.self_device_time_total > 0})
            return wall_ms, kernels
    require(False, f"the profiler saw kernels named like each of {want}"
                   + (" and enough marked kernels" if mark is not None else "")
                   + f" in {tries} sessions: {sorted(kernels)}")


def named_ms(times: dict, *patterns: str) -> float:
    """The summed ms of the kernels whose names hold one of ``patterns``;
    fails when the profiler saw none."""
    hits = [t for k, t in times.items() if any(p in k for p in patterns)]
    require(hits, f"the profiler saw a kernel named like {patterns}: {sorted(times)}")
    return sum(hits)


FILL_KERNELS = ("FillFunctor", "Memset")  # torch.zeros' fill, by the profiler's names
# The backward's kernels by tiling, by the names ptxas and the profiler give them,
# and what the sorted tiling launches before its kernel: the keys and torch.sort's
# radix passes.
BAG_BWD_KERNELS = ("embedding_bag_bwd_small_kernel", "embedding_bag_bwd_sorted_kernel")
BAG_BWD_BOOKKEEPING = ("embedding_bag_keys_kernel", "DeviceRadixSort", "fill_reverse_indices")


def bag_bwd_bookkeeping_ms(kernels: dict) -> float:
    """The device ms of the sorted tiling's keys and sort among ``kernels``;
    0 where no keys kernel ran (the small tiling launches none).  The sort's
    kernels share their names with other sorts (the DLRM interaction's
    index backward sorts too), so they count only beside the keys kernel."""
    if not any("embedding_bag_keys_kernel" in k for k in kernels):
        return 0.0
    return sum(t for k, t in kernels.items() if any(b in k for b in BAG_BWD_BOOKKEEPING))


def short_name(kernel: str) -> str:
    """A profiler kernel name without its namespaces, template and arguments."""
    name = kernel.replace("(anonymous namespace)", "anonymous")
    return name.split("(")[0].split("<")[0].split("::")[-1].strip()


def rows_of(a):
    """``a`` as (rows, E) slices of at most 2**22 rows (2 GB in fp32), so a
    comparison of two 10 GB gradients makes no full-size temporary."""
    flat = a.view(-1, a.shape[-1])
    return [flat[i:i + (1 << 22)] for i in range(0, flat.shape[0], 1 << 22)]


def check_bag_bwd(embedding_bag_bwd, ref_embedding_bag_bwd, gen, dev, smi):
    """The embedding bag's backward against its plain version on the DLRM
    training run's tables (T_TRAIN_DLRM x 1e7 x 128); returns each case's
    numbers, by label.  fp32: rtol 1e-6 and an atol of (the longest run)
    ulps of max|dout|, the plain version's index_add_ adding in no fixed
    order on the card; bf16: 2e-2.  Each case runs on the tiling the
    wrapper picks; two launches must give the same bits, and where the
    small tiling serves (n <= N_SMALL) the sorted tiling must give them
    too.  Times: the kernel's and the wrapper's whole path's device time
    without the fill (``torch.profiler``), with the path's launches a call,
    the other tiling's where both take the case, and ``index_add_`` on the
    same clock beside its CUDA-event time."""
    from repro_torch.kernels.embedding_bag import N_SMALL, bag_bwd_tiling

    T, R, E = T_TRAIN_DLRM, R_DLRM, E_DLRM

    def ids(Bb, nnz, low=0, high=R, dtype=torch.int32):
        return torch.randint(low, high, (Bb, T, nnz), generator=gen, device=dev).to(dtype)

    def hot_ids(Bb, nnz, hot=4096):
        rows = torch.randint(0, R, (T, hot), generator=gen, device=dev)
        pick = torch.randint(0, hot, (Bb, T, nnz), generator=gen, device=dev)
        return rows[torch.arange(T, device=dev)[None, :, None], pick].to(torch.int32)

    def equal(a, b) -> bool:
        return all(torch.equal(x, y) for x, y in zip(rows_of(a), rows_of(b)))

    def path(dout, idx, dtype, tiling) -> dict:
        """One tiling's device times (profiler, 10 calls): its kernel, every
        kernel the wrapper launches but the fill, and their launches."""
        launches: dict = {}
        prof = kernel_device_ms(lambda: embedding_bag_bwd(dout, idx, R, dtype, tiling), 10,
                                launches)
        fill = [k for k in prof if any(f in k for f in FILL_KERNELS)]
        rest = {k: t for k, t in prof.items() if k not in fill}
        kernel = [k for k in rest if f"embedding_bag_bwd_{tiling}_kernel" in k]
        require(kernel, f"the profiler saw embedding_bag_bwd_{tiling}_kernel: {sorted(prof)}")
        return dict(kernel_ms=sum(rest[k] for k in kernel), path_ms=sum(rest.values()),
                    path_launches=sum(launches[k] for k in rest),
                    fill_device_ms=sum(prof[k] for k in fill),
                    bookkeeping=sorted({short_name(k) for k in rest if k not in kernel}))

    def case(label, dout, idx) -> dict:
        dtype, width = dout.dtype, dout.shape[-1]
        tiling = bag_bwd_tiling(idx.numel())
        out = embedding_bag_bwd(dout, idx, R, dtype)
        torch.cuda.synchronize()
        again = embedding_bag_bwd(dout, idx, R, dtype)
        require(equal(out, again), f"embedding_bag_bwd {label}: two launches differ")
        del again
        both = idx.numel() <= N_SMALL
        if both:  # the sorted tiling takes the case too, and must give the same bits
            other = embedding_bag_bwd(dout, idx, R, dtype, "sorted")
            require(equal(out, other), f"embedding_bag_bwd {label}: small and sorted differ")
            del other
        # The in-range entries: their keys, dout rows, the rows they write.
        wrapped = idx.long()
        wrapped = torch.where(wrapped < 0, wrapped + R, wrapped)
        keep = (wrapped >= 0) & (wrapped < R)
        keys = (wrapped + torch.arange(T, device=dev)[None, :, None] * R)[keep]
        rows = dout[:, :, None, :].expand(*idx.shape, width)[keep]
        written, counts = torch.unique(keys, return_counts=True)
        longest = int(counts.max())
        ref = ref_embedding_bag_bwd(dout, idx, R, dtype)
        err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(rows_of(out), rows_of(ref)))
        if dtype == torch.float32:
            tol = longest * torch.finfo(torch.float32).eps * float(dout.abs().max())
            ok = all(torch.allclose(a, b, rtol=1e-6, atol=tol)
                     for a, b in zip(rows_of(out), rows_of(ref)))
        else:
            tol = 2e-2
            ok = all(torch.allclose(a.float(), b.float(), rtol=tol, atol=tol)
                     for a, b in zip(rows_of(out), rows_of(ref)))
        nonzero = sum(int(a.ne(0).any(dim=1).sum()) for a in rows_of(out))
        require(ok and nonzero <= written.numel(),
                f"embedding_bag_bwd vs plain, {label}: max|err| {err} (tol {tol}), "
                f"{nonzero} rows non-zero of {written.numel()} written")
        del ref
        wrapper_ms = time_ms(lambda: embedding_bag_bwd(dout, idx, R, dtype), 10)
        own = path(dout, idx, dtype, tiling)
        sorted_path = path(dout, idx, dtype, "sorted") if both else None
        fill_ms = time_ms(lambda: torch.zeros((T, R, width), dtype=dtype, device=dev), 10)
        plain_ms = time_ms(lambda: ref_embedding_bag_bwd(dout, idx, R, dtype), 3)
        del out
        # One PyTorch call for the same sums, without the fill: a yardstick
        # only, never on the port's path; by CUDA events and by the profiler.
        buf = torch.zeros((T * R, width), dtype=dtype, device=dev)
        library_ms = time_ms(lambda: buf.index_add_(0, keys, rows), 20)
        library_device_ms = sum(kernel_device_ms(lambda: buf.index_add_(0, keys, rows),
                                                 20).values())
        # The same after a zero fill of buf, as the kernel runs after the
        # wrapper's: its inputs no longer in L2.
        cold = kernel_device_ms(lambda: (buf.zero_(), buf.index_add_(0, keys, rows)), 10)
        library_after_fill_ms = sum(t for k, t in cold.items()
                                    if not any(f in k for f in FILL_KERNELS))
        del buf
        nbytes = ((dout.numel() + written.numel() * width) * dout.element_size()
                  + idx.numel() * idx.element_size())
        t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, keys.numel() * width / PEAK_FLOPS[
            torch.float32]
        bound_ms = max(t_bytes, t_ops) * 1e3
        bound_by = "operations" if t_ops >= t_bytes else "bytes"
        print(f"phase 3 kernel: embedding_bag_bwd {label}: tiling {tiling}, max|err| {err} "
              f"(tol {tol}; longest run {longest}), two launches bitwise equal"
              f"{', the sorted tiling bitwise equal' if both else ''}, {written.numel()} rows "
              f"written of {T * R}; kernel_ms {own['kernel_ms']} path_ms {own['path_ms']} "
              f"({own['path_launches']} launches a call without the fill: the kernel and "
              f"{own['bookkeeping']}; torch.profiler) wrapper_ms {wrapper_ms} (CUDA events) "
              f"fill_ms {fill_ms} (device {own['fill_device_ms']}) plain_ms {plain_ms} "
              f"library_ms {library_ms} library_device_ms {library_device_ms} "
              f"library_after_fill_ms {library_after_fill_ms} (index_add_, no fill; after one) "
              f"bound_ms {bound_ms} ({bound_by}) on {smi}")
        numbers = dict(tiling=tiling, max_abs_err=err, kernel_ms=own["kernel_ms"],
                       path_ms=own["path_ms"], path_launches=own["path_launches"],
                       wrapper_ms=wrapper_ms, fill_ms=fill_ms, plain_ms=plain_ms,
                       library_ms=library_ms, library_device_ms=library_device_ms,
                       library_after_fill_ms=library_after_fill_ms, bound_ms=bound_ms,
                       bound_by=bound_by, longest_run=longest)
        if sorted_path:
            print(f"phase 3 kernel: embedding_bag_bwd {label} forced to sorted: kernel_ms "
                  f"{sorted_path['kernel_ms']} path_ms {sorted_path['path_ms']} "
                  f"({sorted_path['path_launches']} launches a call without the fill; "
                  f"torch.profiler) on {smi}")
            numbers.update({f"sorted_{k}": sorted_path[k]
                            for k in ("kernel_ms", "path_ms", "path_launches")})
        return numbers

    def dout(Bb, width=E, dtype=torch.float32):
        return torch.randn(Bb, T, width, generator=gen, device=dev).to(dtype)

    cases = {}
    cases["training"] = case("training B=128 NNZ=1 fp32 int32", dout(128), ids(128, 1))
    cases["B=4096"] = case("B=4096 NNZ=1 fp32 int32", dout(4096), ids(4096, 1))
    cases["hot"] = case("B=4096 NNZ=32 from 4096 hot rows a table fp32 int32", dout(4096),
                        hot_ids(4096, 32))
    cases["bf16"] = case("B=4096 NNZ=32 from 4096 hot rows a table bf16 int32",
                         dout(4096, dtype=torch.bfloat16), hot_ids(4096, 32))
    cases["end"] = case("ids near R-1 (table 1 past 2^31) B=128 NNZ=4 fp32 int32", dout(128),
                        ids(128, 4, R - 1000))
    # Ids past the table and wrapping to below 0 get no gradient; -1 and -R
    # wrap to rows R-1 and 0.
    raw = torch.tensor([R, R + 5, -1, -R, -R - 3, 2**31 - 1, -(2**31), 0], device=dev).repeat(16)
    past = raw[:, None, None].expand(-1, T, 1).to(torch.int32)
    d = dout(past.shape[0])
    got = embedding_bag_bwd(d, past, R, torch.float32)
    lands = {R - 1: raw == -1, 0: (raw == -R) | (raw == 0)}
    atol = past.shape[0] * torch.finfo(torch.float32).eps * float(d.abs().max())
    for row, sel in lands.items():
        require(torch.allclose(got[:, row], d[sel].sum(dim=0), rtol=1e-6, atol=atol),
                f"ids landing on row {row} sum there")
    require(sum(int(a.ne(0).any(dim=1).sum()) for a in rows_of(got)) == 2 * T,
            "only rows 0 and R-1 of each table get a gradient")
    del got
    cases["outside"] = case("ids past the table and negative B=128 NNZ=1 fp32 int32", d, past)
    cases["ragged"] = case("ragged E=13 B=128 NNZ=7 fp32 int64", dout(128, 13),
                           ids(128, 7, dtype=torch.int64))
    return cases


BAG_KEYS = ("max_abs_err", "kernel_ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "device_ms", "library_device_ms", "device_cold_ms", "library_device_cold_ms",
            "bound_share", "bound_share_cold", "tiling")


L2_FLUSH_BYTES = 128 << 20  # more than twice the H100's 50 MB of L2


def bag_times(embedding_bag, ref_embedding_bag, tables, ids, out) -> dict:
    """Kernel, plain and library times (CUDA events), the kernel's and the
    library call's device times on one clock (``torch.profiler``), warm
    (calls back to back: at B=4096, one id a bag, the 33.6 MB of rows and
    output stay in L2) and cold (each call after a read of L2_FLUSH_BYTES,
    so its rows come from device memory, as a new batch's do), and the
    bound.  The library call is ``F.embedding_bag`` over the tables seen as
    one (T*R, E) table, with ids in range offset by t*R: a yardstick only,
    never on the port's path."""
    T, R, E = tables.shape
    B, _, nnz = ids.shape
    iters = 20 if B * nnz > 4096 else 200
    flush = torch.zeros(L2_FLUSH_BYTES // 4, device=ids.device)
    flush_kernels = set(kernel_device_ms(flush.sum, 1))

    def cold_ms(fn) -> float:
        times = kernel_device_ms(lambda: (flush.sum(), fn()), iters)
        return sum(t for k, t in times.items() if k not in flush_kernels)

    kernel_ms = time_ms(lambda: embedding_bag(tables, ids), iters)
    device_ms = launch_ms(lambda: embedding_bag(tables, ids), iters, "embedding_bag_kernel")
    device_cold_ms = launch_ms(lambda: embedding_bag(tables, ids), iters, "embedding_bag_kernel",
                               flush.sum)
    plain_ms = time_ms(lambda: ref_embedding_bag(tables, ids), 5)
    library_ms = library_device_ms = library_device_cold_ms = library_err = None
    if bool(((ids >= 0) & (ids < R)).all()):
        flat = (ids.long() + torch.arange(T, device=ids.device)[None, :, None] * R)
        flat = flat.view(B * T, nnz)
        table2d = tables.view(T * R, E)
        lib = torch.nn.functional.embedding_bag(flat, table2d, mode="sum").view(B, T, E)
        library_err = float((lib.float() - out.float()).abs().max())
        library_ms = time_ms(
            lambda: torch.nn.functional.embedding_bag(flat, table2d, mode="sum"), iters)
        library_device_ms = sum(kernel_device_ms(
            lambda: torch.nn.functional.embedding_bag(flat, table2d, mode="sum"),
            iters).values())
        library_device_cold_ms = cold_ms(
            lambda: torch.nn.functional.embedding_bag(flat, table2d, mode="sum"))
    bound_ms, bound_by, n_rows = bag_bound(tables, ids, out)
    return dict(kernel_ms=kernel_ms, device_ms=device_ms, device_cold_ms=device_cold_ms,
                plain_ms=plain_ms, library_ms=library_ms, library_device_ms=library_device_ms,
                library_device_cold_ms=library_device_cold_ms, library_err=library_err,
                bound_ms=bound_ms, bound_by=bound_by, rows_read=n_rows)


def dlrm_batch(rng, cfg, batch, device):
    """Dense features and ids drawn with numpy from ``rng``; labels are
    ``sparse[:, 0] % 2``, as ``examples/dlrm_testbed.py`` makes them."""
    sparse = rng.integers(0, cfg.rows_per_table, (batch, cfg.n_tables)).astype(np.int32)
    dense = rng.standard_normal((batch, cfg.dense_features)).astype(np.float32)
    return {"dense": torch.from_numpy(dense).to(device),
            "sparse": torch.from_numpy(sparse).to(device),
            "label": torch.from_numpy((sparse[:, 0] % 2).astype(np.float32)).to(device)}


def score_dlrm(dlrm, ops, ref_embedding_bag, dev, smi) -> dict:
    """Phase 4e: scores the paper's DLRM (8 tables) at full width on the
    freed card, at each batch of ``DLRM_BATCHES``; returns the embedding-bag
    launches of each batch's request."""
    gc.collect()
    torch.cuda.empty_cache()
    cfg = dlrm.paper_config(T_DLRM)
    before_gb = torch.cuda.memory_allocated() / 1e9  # what earlier phases left allocated
    t0 = time.perf_counter()
    model = dlrm.init(0, cfg, device=dev)
    torch.cuda.synchronize()
    n_mlp = sum(p.numel() for n, p in model.named_parameters() if n != "tables")
    print(f"phase 4e score: {DLRM_PATH} init on the card: tables {tuple(model.tables.shape)} "
          f"fp32 ({model.tables.numel() * 4 / 1e9} GB), MLPs {n_mlp} parameters "
          f"({n_mlp * 4 / 1e9} GB) in {time.perf_counter() - t0:.2f} s; allocated before "
          f"the init {before_gb} GB, after it {torch.cuda.memory_allocated() / 1e9} GB")
    rng = np.random.default_rng(0)
    launches = {}
    for batch_size in DLRM_BATCHES:
        batch = dlrm_batch(rng, cfg, batch_size, dev)
        dense, sparse = batch["dense"], batch["sparse"]
        for _ in range(3):  # warm-up: cuBLAS handles and heuristics
            dlrm.forward(model, dense, sparse, cfg)
        torch.cuda.synchronize()
        # The request, with every count set to 0 just before it.
        for n in COUNTERS:
            setattr(ops, n, 0)
        torch.cuda.reset_peak_memory_stats()
        start_gb = torch.cuda.memory_allocated() / 1e9
        logits = dlrm.forward(model, dense, sparse, cfg)
        torch.cuda.synchronize()
        counts = {n: getattr(ops, n) for n in COUNTERS}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        want = {n: int(n == "bag_lookup_launches") for n in COUNTERS}
        require(counts == want, f"{DLRM_PATH} B={batch_size} launches {counts}, want {want}")
        launches[f"B={batch_size}"] = counts["bag_lookup_launches"]
        loss, _ = dlrm.loss_fn(model, batch, cfg)
        require(tuple(logits.shape) == (batch_size,) and bool(torch.isfinite(logits).all())
                and bool(torch.isfinite(loss)), f"finite {DLRM_PATH} logits and loss")
        times = []
        for _ in range(20):
            t0 = time.perf_counter()
            dlrm.forward(model, dense, sparse, cfg)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        fwd_ms = float(np.median(times)) * 1e3
        print(f"phase 4e score: B={batch_size} forward {fwd_ms} ms (median of 20, min "
              f"{min(times) * 1e3}, max {max(times) * 1e3}), {batch_size / fwd_ms * 1e3} "
              f"samples/s, bag_lookup launches {counts['bag_lookup_launches']} per forward, "
              f"loss {float(loss)}, max|logit| {float(logits.abs().max())}, peak memory "
              f"{peak_gb} GB ({start_gb} GB allocated at the request's start), on {smi}")

        # (a) The same forward with the plain lookup on the card: bitwise.
        real = ops.bag_lookup
        ops.bag_lookup = ref_embedding_bag
        try:
            plain_logits = dlrm.forward(model, dense, sparse, cfg)
        finally:
            ops.bag_lookup = real
        diff = float((plain_logits - logits).abs().max())
        require(torch.equal(plain_logits, logits),
                f"{DLRM_PATH} B={batch_size} kernel vs plain lookup: max|diff| {diff}")
        # (b) 16 samples recomputed on the CPU from the rows they gather.
        n = 16
        rows = model.tables[torch.arange(T_DLRM, device=dev)[None, :], sparse[:n].long()]
        cpu = SimpleNamespace(
            tables=rows.transpose(0, 1).contiguous().cpu(),  # (T, 16, E): row i is sample i's
            bottom=[SimpleNamespace(w=m.w.cpu(), b=m.b.cpu()) for m in model.bottom],
            top=[SimpleNamespace(w=m.w.cpu(), b=m.b.cpu()) for m in model.top])
        cfg_cpu = dataclasses.replace(cfg, rows_per_table=n)
        sub = {"dense": dense[:n].cpu(), "label": batch["label"][:n].cpu(),
               "sparse": torch.arange(n)[:, None].expand(n, T_DLRM)}
        logits_cpu = dlrm.forward(cpu, sub["dense"], sub["sparse"], cfg_cpu)
        loss_cpu, _ = dlrm.loss_fn(cpu, sub, cfg_cpu)
        loss_card, _ = dlrm.loss_fn(model, {"dense": dense[:n], "sparse": sparse[:n],
                                            "label": batch["label"][:n]}, cfg)
        bar = 1e-4 * float(logits_cpu.abs().max())
        # The loss sits near log 2, where one fp32 ulp (6e-8) can exceed the
        # logits' bar: its 16 terms are summed in another order on the card.
        loss_bar = bar + 8 * torch.finfo(torch.float32).eps * abs(float(loss_cpu))
        err = float((logits[:n].cpu() - logits_cpu).abs().max())
        loss_err = abs(float(loss_card) - float(loss_cpu))
        require(err <= bar and loss_err <= loss_bar,
                f"{DLRM_PATH} B={batch_size} card vs CPU on {n} samples: logits {err} "
                f"(bar {bar}), loss {loss_err} (bar {loss_bar})")
        print(f"phase 4e consistency: B={batch_size} kernel vs plain lookup on the card: "
              f"bitwise (max|diff| {diff}); {n} samples recomputed on the CPU in fp32: logits "
              f"max|err| {err} <= {bar} (1e-4 max|logit|), loss {float(loss_card)} vs "
              f"{float(loss_cpu)}, |err| {loss_err} <= {loss_bar}")
        del batch, dense, sparse, logits, plain_logits, rows, cpu
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def serve_checked(lm, ops, generate, cfg, prompt, gen, dev, smi, phase) -> dict:
    """Serves a recurrent model, a dense one or the VLM at full width and depth after
    freeing the card, checks its launch counts and outputs, holds
    prefill(S + 1) against prefill(S) plus a decode step, and returns the
    prefill's launch counts.  The VLM's cross gates are set to 1 first, and
    its image (``launch.serve.image_draw``, numpy seed 0) goes into every
    prefill."""
    from repro_torch.launch.serve import image_draw

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = lm.init(0, cfg, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    fp32 = "; scan parameters fp32" if cfg.family in ("ssm", "hybrid") else ""
    print(f"phase {phase} serve: {cfg.name} init on the card: {n_params} parameters "
          f"({cfg.param_dtype}{fp32}) in {time.perf_counter() - t0:.2f} s")
    extra = {}
    if cfg.family == "vlm":
        gates = open_gates(model)
        extra["image_embeds"] = image_draw(np.random.default_rng(0), cfg, B).to(dev)
        print(f"phase {phase} serve: cross gates {[float(g) for g in gates]} (tanh "
              f"{math.tanh(1.0)}; 0 at init, where tanh(0) = 0 throws the cross-attention "
              f"away), image {tuple(extra['image_embeds'].shape)} drawn with numpy")
    image = extra.get("image_embeds")
    tokens = torch.randint(0, cfg.vocab, (B, prompt + 1), generator=gen, device=dev)
    generate(model, tokens[:, :64], 2, image_embeds=image)  # warm-up

    ids, timings, pre, dec, logits = served(lm, ops, generate, model, tokens[:, :prompt], image)
    check_served(cfg, ids, logits)
    if cfg.family == "ssm":
        want = {"selective_scan_launches": cfg.n_layers}
    elif cfg.family in ("vlm", "dense"):  # the VLM: 32 self and 8 cross layers
        want = {"attention_launches": cfg.n_layers, "attention_wgmma_launches": cfg.n_layers}
    else:
        n_blocks = cfg.n_layers // len(cfg.block_pattern)  # each: rec, rec, attn
        want = {"lru_scan_launches": 2 * n_blocks + len(cfg.tail_pattern),
                "attention_launches": n_blocks, "attention_wgmma_launches": n_blocks}
    want = {n: want.get(n, 0) for n in COUNTERS}
    require(pre == want, f"{cfg.name} prefill launches {pre}, want {want}")
    require(not any(dec.values()), f"{cfg.name} decode loop launched {dec}, want none")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    decode_ms = timings["decode_s"] / (DECODE_STEPS - 1) * 1e3
    print(f"phase {phase} serve: {B}x{prompt} prefill {timings['prefill_s'] * 1e3} ms, decode "
          f"{decode_ms} ms/token over {DECODE_STEPS - 1} steps, peak memory {peak_gb} GB, "
          f"launches: prefill {pre}, decode loop {dec}, on {smi}")
    print(f"phase {phase} serve: generated ids (first request): {ids[0].tolist()}")
    del logits

    # prefill(S) is exact for the next step at S: falcon's states at any S,
    # Griffin's ring-buffer cache at S = its window, the VLM's KV cache with
    # room for one more key (its step attends to the image in plain PyTorch).
    full, _ = lm.prefill(model, {"tokens": tokens, **extra}, cfg)
    part, cache = lm.prefill(model, {"tokens": tokens[:, :prompt], **extra}, cfg,
                             pad_to=prompt + 1)
    step, _ = lm.decode_step(
        model, {"token": tokens[:, prompt], "pos": prompt, "cache": cache}, cfg
    )
    for name, t in (("prefill S+1", full), ("prefill", part), ("decode", step)):
        require(bool(torch.isfinite(t).all()), f"finite {name} logits")
    diff = float((step.float() - full.float()).abs().max())
    bar = 5e-2 * float(full.float().abs().max())
    require(diff <= bar, f"{cfg.name} prefill vs prefill+decode: max|diff| {diff} > {bar}")
    agree = int((full.argmax(-1) == step.argmax(-1)).sum())
    print(f"phase {phase} consistency: last-token logits, kernel prefill(S+1) vs prefill(S)"
          f"+plain decode: max|diff| {diff} <= {bar} (5e-2 max|logits|); argmax agrees "
          f"{agree}/{B}")
    return pre


def encode_audio(lm, ops, cfg, dev, smi) -> dict:
    """Phase 4g: encodes B clips of PROMPT frames (20 s each at HuBERT's
    20 ms frame rate; standard normal from numpy seed 0) with the encoder
    at full width and depth on the freed card: one flash-attention launch a
    layer, all wgmma at D = 80, logits finite of shape (B, PROMPT, vocab),
    the forward timed (host clock after a synchronise, median of 10 after a
    warm-up), and layer 0 in bf16 on the card held against the same layer
    in fp32 on the CPU.  Returns the forward's launch counts."""
    from repro_torch.models import transformer

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = lm.init(0, cfg, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"phase 4g encode: {cfg.name} init on the card: {n_params} parameters "
          f"({cfg.param_dtype}) in {time.perf_counter() - t0:.2f} s")
    draw = np.random.default_rng(0).standard_normal((B, PROMPT, cfg.d_model))
    frames = torch.from_numpy(draw).to(torch.bfloat16).to(dev)
    lm.forward(model, {"frames": frames[:, :64]}, cfg)  # warm-up
    torch.cuda.synchronize()

    for n in COUNTERS:
        setattr(ops, n, 0)
    torch.cuda.reset_peak_memory_stats()
    logits, _ = lm.forward(model, {"frames": frames}, cfg)
    torch.cuda.synchronize()
    counts = {n: getattr(ops, n) for n in COUNTERS}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = {n: 0 for n in COUNTERS}
    want.update(attention_launches=cfg.n_layers, attention_wgmma_launches=cfg.n_layers)
    require(counts == want, f"{cfg.name} forward launches {counts}, want {want}")
    require(tuple(logits.shape) == (B, PROMPT, cfg.vocab) and bool(torch.isfinite(logits).all()),
            f"finite {cfg.name} logits of shape {(B, PROMPT, cfg.vocab)}: {tuple(logits.shape)}")
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        lm.forward(model, {"frames": frames}, cfg)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    fwd_ms = float(np.median(times)) * 1e3
    print(f"phase 4g encode: {B}x{PROMPT} frames forward {fwd_ms} ms (median of 10, min "
          f"{min(times) * 1e3}, max {max(times) * 1e3}), peak memory {peak_gb} GB, "
          f"flash_attention launches {counts['attention_launches']} "
          f"({counts['attention_wgmma_launches']} on wgmma at D = {cfg.hd}), logits "
          f"{tuple(logits.shape)}, on {smi}")

    # Layer 0 at full width on one clip: the kernel's bf16 encoder attention
    # against the plain layer in fp32 on the CPU.
    blk = model.blocks[0]
    x = frames[:1]
    positions = torch.arange(PROMPT, device=dev)[None, :]
    ops.attention_launches = 0
    y_gpu, _, _, _ = transformer._self_block_apply(blk, x, cfg, positions)
    require(ops.attention_launches == 1, "layer 0 ran one flash_attention launch")
    blk_cpu = copy.deepcopy(blk).float().cpu()
    y_cpu, _, _, _ = transformer._self_block_apply(blk_cpu, x.float().cpu(), cfg,
                                                   positions.cpu())
    err = float((y_gpu.float().cpu() - y_cpu).abs().max())
    bar = 2e-2 * float(y_cpu.abs().max())
    require(err <= bar, f"{cfg.name} layer 0, bf16 card vs fp32 CPU: max|err| {err} > {bar}")
    print(f"phase 4g layer: {cfg.name} layer 0 at full width, 1x{PROMPT} frames, bf16 card vs "
          f"fp32 CPU: max|err| {err} <= {bar} (2e-2 max|ref|)")
    del model, blk, blk_cpu, frames, logits, y_gpu
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# Phase 6 (the planner): the paper's 128-server simulations (§5) at degree 4
# and 100 Gbps links; the fused admission's four tenants (32 servers each)
# over four placements shifted by 8 servers.
PLAN_N, PLAN_DEGREE, PLAN_LINK_BW = 128, 4, 12.5e9
PLAN_DEMANDS = 256
PLAN_ROUNDS, PLAN_ITERS, PLAN_CHAINS, PLAN_POOL = 2, 200, 32, 64
ADMIT_CHAINS, ADMIT_SEED, ADMIT_SHIFTS = 16, 3, (0, 8, 16, 24)
ORACLE_CHAINS = 4  # the NumPy oracles replay the first 4 chains


def admission_candidates(wl, n: int = PLAN_N) -> list:
    """DLRM (weight 2), BERT, CANDLE and VGG16 on 32 servers each, under
    each placement shift."""
    specs = ((wl.DLRM, 2.0), (wl.BERT, 1.0), (wl.CANDLE, 1.0), (wl.VGG16, 1.0))
    return [
        wl.JobSet(n=n, tenants=[
            wl.TenantJob(spec=spec, weight=w, name=spec.name,
                         servers=tuple((32 * i + j + off) % n for j in range(32)))
            for i, (spec, w) in enumerate(specs)
        ])
        for off in ADMIT_SHIFTS
    ]


def device_trace(fn) -> dict:
    """Runs ``fn`` once under ``torch.profiler``; returns its result, the
    traced host wall time, the summed device time of its kernels, the
    kernel launches and the copies (memcpy and memset) it made."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    copies = [e for e in events if e.key.startswith(("Memcpy", "Memset"))]
    return dict(out=out, traced_wall_s=wall,
                busy_ms=sum(e.self_device_time_total for e in events) / 1e3,
                launches=sum(e.count for e in events) - sum(e.count for e in copies),
                copies=sum(e.count for e in copies))


@contextlib.contextmanager
def timed_parts(parts: dict):
    """Wraps each of ``parts`` (label -> (owner, name)) to sum its calls'
    host wall time between synchronises; yields label -> [seconds, calls,
    (args, kwargs, result) of the last call].  Nested parts each count
    their own time."""
    spent = {label: [0.0, 0, None] for label in parts}
    real = {label: getattr(owner, name) for label, (owner, name) in parts.items()}

    def wrap(label, fn):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(*args, **kwargs)
            torch.cuda.synchronize()
            spent[label][0] += time.perf_counter() - t0
            spent[label][1] += 1
            spent[label][2] = (args, kwargs, res)
            return res
        return timed

    try:
        for label, (owner, name) in parts.items():
            setattr(owner, name, wrap(label, real[label]))
        yield spent
    finally:
        for label, (owner, name) in parts.items():
            setattr(owner, name, real[label])


def program_stats(call, parts: dict) -> dict:
    """Runs ``call`` three times: cold, then steady with each of ``parts``
    (label -> (owner, method name)) wrapped to sum its calls' host wall
    time between synchronises, then under ``torch.profiler``.  The first
    part is the device program: its idle share is 1 - its traced device
    time / its steady wall time.  Returns the steady run's result and the
    numbers."""
    t0 = time.perf_counter()
    call()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    with timed_parts(parts) as spent:
        t0 = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    tr = device_trace(call)
    program = next(iter(parts))
    program_ms = spent[program][0] * 1e3
    return dict(out=out, first_s=first_s, wall_s=wall,
                parts_ms={label: t * 1e3 for label, (t, _, _) in spent.items()},
                programs=spent[program][1], program_wall_ms=program_ms,
                busy_ms=tr["busy_ms"], launches=tr["launches"], copies=tr["copies"],
                idle_share=1.0 - tr["busy_ms"] / program_ms,
                traced_wall_s=tr["traced_wall_s"])


def plan_phase(dev, smi) -> dict:
    """Phase 6: the planner at the paper's 128-server scale on the card
    (see the module docstring); returns its numbers."""
    from repro_torch.core import alternating as alt
    from repro_torch.core import planeval_torch as pt
    from repro_torch.core import workloads as wl
    from repro_torch.core.netsim import HardwareSpec
    from repro_torch.core.planeval import plan_evaluator
    from repro_torch.core.strategy_search import default_strategy
    from repro_torch.core.topology_finder import topology_finder

    hw = HardwareSpec(link_bandwidth=PLAN_LINK_BW, degree=PLAN_DEGREE)
    n = PLAN_N
    out: dict = {}

    # 6a: pricing.
    topo = topology_finder(default_strategy(wl.DLRM).demand(wl.DLRM, n), hw.degree)
    jobs = list(wl.PAPER_JOBS.values())
    per_job = -(-PLAN_DEMANDS // len(jobs))
    demands = [s.demand(job, n) for j, job in enumerate(jobs)
               for s in pt.strategy_pool(job, n, per_job, seed=j)][:PLAN_DEMANDS]
    ev = plan_evaluator(topo, hw)
    t0 = time.perf_counter()
    want = np.array([ev.comm_time(d) for d in demands])
    numpy_s = time.perf_counter() - t0
    tev = pt.TorchPlanEvaluator(topo, hw, dev)
    t0 = time.perf_counter()
    got = tev.comm_times(demands)
    card_s = time.perf_counter() - t0
    again = tev.comm_times(demands)
    rel = float((np.abs(got - want) / np.maximum(np.abs(want), 1e-30)).max())
    require(rel <= pt.TORCH_EQUIV_RTOL, f"pricing vs NumPy: max rel err {rel}")
    require(np.array_equal(got, again), "two pricing calls differ")
    pk = tev.pack(demands)
    occ = int(pk.seg.numel())
    # The event span of back-to-back calls is the host's launch rate for
    # this loop of small launches; the profiler's busy time is the device's.
    wall_ms = time_ms(lambda: tev.bottlenecks(pk), iters=20)
    tr = device_trace(lambda: tev.bottlenecks(pk))
    bound_ms = (occ * 16 + pk.n_links * 8 + len(demands) * 8) / PEAK_BYTES_PER_S * 1e3
    seg_len = np.bincount(pk.seg.cpu().numpy())
    # The design the rank loop is held against: one index_put_(accumulate=
    # True) over the whole stream (CUDA's sort-based accumulate, no float
    # atomics).  Measured here, used nowhere in the port.
    caps_t = torch.from_numpy(np.ascontiguousarray(tev.ev.caps)).to(dev)

    def put_pricing():
        acc = torch.zeros(pk.rows * pk.n_links * 2, dtype=torch.float64, device=dev)
        acc.index_put_((pk.seg,), pk.share, accumulate=True)
        acc = acc.view(pk.rows, pk.n_links, 2)
        return ((acc[:, :, 0] + acc[:, :, 1]) / caps_t).amax(dim=1)

    put = put_pricing().cpu().numpy()
    put_again = put_pricing().cpu().numpy()
    put_rel = float((np.abs(put - want) / np.maximum(np.abs(want), 1e-30)).max())
    put_ms = time_ms(put_pricing, iters=20)
    put_tr = device_trace(put_pricing)
    out["pricing"] = dict(demands=len(demands), links=pk.n_links, occurrences=occ,
                          ranks=len(pk.bounds) - 1, max_rel_err=rel,
                          bitwise_numpy=bool(np.array_equal(got, want)),
                          device_ms=tr["busy_ms"], wall_ms=wall_ms,
                          idle_share=1.0 - tr["busy_ms"] / wall_ms,
                          launches=tr["launches"], copies=tr["copies"],
                          bound_ms=bound_ms, bound_by="bytes", call_s=card_s,
                          numpy_s=numpy_s, segments_32_or_more=int((seg_len >= 32).sum()),
                          index_put=dict(bitwise_numpy=bool(np.array_equal(put, want)),
                                         repeatable=bool(np.array_equal(put, put_again)),
                                         max_rel_err=put_rel, device_ms=put_tr["busy_ms"],
                                         wall_ms=put_ms, launches=put_tr["launches"]))
    print(f"phase 6a pricing: {len(demands)} demands of {len(jobs)} paper jobs on {n} "
          f"servers ({pk.n_links} links, {occ} occurrences in {len(pk.bounds) - 1} ranks, "
          f"{out['pricing']['segments_32_or_more']} segments of 32 or more): max rel err vs "
          f"NumPy {rel} (bar {pt.TORCH_EQUIV_RTOL}; bitwise {out['pricing']['bitwise_numpy']}), "
          f"two calls bitwise equal; device {tr['busy_ms']} ms busy ({tr['launches']} "
          f"launches, torch.profiler) in {wall_ms} ms wall a batch (CUDA events over 20 "
          f"calls), idle {out['pricing']['idle_share']:.2%}; bound {bound_ms} ms (bytes); "
          f"call {card_s} s with the host pack, NumPy {numpy_s} s; one index_put_ "
          f"(accumulate) instead: bitwise vs NumPy {out['pricing']['index_put']['bitwise_numpy']}"
          f", max rel err {put_rel}, repeatable {out['pricing']['index_put']['repeatable']}, "
          f"{put_tr['busy_ms']} ms busy ({put_tr['launches']} launches) in {put_ms} ms wall, "
          f"on {smi}")

    # 6b: the chain programs at the fused admission's shape.
    cands = admission_candidates(wl, n)
    init = {t.label: default_strategy(t.spec) for t in cands[0].tenants}
    pools = [pt.strategy_pool(t.spec, t.k, PLAN_POOL, ADMIT_SEED + pt._POOL_SEED_OFFSET + i,
                              init=init[t.label])
             for i, t in enumerate(cands[0].tenants)]
    topos = [topology_finder(js.union_for(init), hw.degree, pack="per_node") for js in cands]
    V, caps, comps, weights, _, _ = pt.pack_jobset_grid(cands, topos, hw, pools)
    C, T, S, L = V.shape
    require((C, T, S) == (len(ADMIT_SHIFTS), 4, PLAN_POOL), f"grid shape {V.shape}")
    ladder = np.array(pt.DEFAULT_TEMPER_LADDER)
    M, K, iters, k = len(ladder), ADMIT_CHAINS, PLAN_ITERS, ORACLE_CHAINS
    t_idx, s_idx, u = pt.draw_grid_streams(ADMIT_SEED, C, K, M, iters, T, S)
    su = pt.draw_swap_streams(ADMIT_SEED, C, K, M, iters)
    init_a = np.zeros((C, T), dtype=np.int64)
    grid = pt.TorchChainKernel(V, caps, comps, weights, device=dev)
    g_args = (init_a, ladder, t_idx, s_idx, u, su)
    g1, g2 = grid.run_grid(*g_args), grid.run_grid(*g_args)
    require(all(np.array_equal(a, b) for a, b in zip(g1, g2)), "two grid runs differ")
    t0 = time.perf_counter()
    gref = pt.run_grid_reference(V, caps, comps, weights, 0.0, "union", init_a, ladder,
                                 t_idx[:, :k], s_idx[:, :k], u[:, :k], su[:, :k])
    oracle_s = time.perf_counter() - t0
    require(np.array_equal(g1[0][:, :k], gref[0]), "grid chains vs run_grid_reference")
    g_err = float(np.abs(g1[1][:, :k] / gref[1] - 1).max())
    h_err = float(np.abs(g1[2][:, :k] / gref[2] - 1).max())
    require(g_err <= 1e-12 and h_err <= 1e-12, f"grid energies rel err {g_err}, {h_err}")
    flat = pt.TorchChainKernel(V[0], caps[0], comps, weights, device=dev)
    f_t, f_s, f_u = pt.draw_proposal_streams(ADMIT_SEED, K, iters, T, S)
    f_args = (np.zeros(T, dtype=np.int64), np.full(K, 0.1), f_t, f_s, f_u)
    f1, f2 = flat.run(*f_args), flat.run(*f_args)
    require(all(np.array_equal(a, b) for a, b in zip(f1, f2)), "two flat runs differ")
    fref = pt.run_chains_reference(V[0], caps[0], comps, weights, 0.0, "union",
                                   f_args[0], f_args[1][:k], f_t[:k], f_s[:k], f_u[:k])
    require(np.array_equal(f1[0][:k], fref[0]), "flat chains vs run_chains_reference")
    f_err = float(max(np.abs(f1[1][:k] / fref[1] - 1).max(),
                      np.abs(f1[2][:k] / fref[2] - 1).max()))
    require(f_err <= 1e-12, f"flat energies rel err {f_err}")
    for name, kern, fn, rows in (
        ("grid", grid, lambda: grid.run_grid(*g_args), C * K * M * T),
        ("flat", flat, lambda: flat.run(*f_args), K * T),
    ):
        t0 = time.perf_counter()
        fn()
        wall_ms = (time.perf_counter() - t0) * 1e3
        tr = device_trace(fn)
        gathered = rows * L * 8 * (iters + 1)  # bytes of V gathered, all steps
        stats = dict(shape=[C, T, S, L] if name == "grid" else [T, S, L], chains=K,
                     rungs=M if name == "grid" else 1, iters=iters, wall_ms=wall_ms,
                     device_ms=tr["busy_ms"], launches=tr["launches"], copies=tr["copies"],
                     idle_share=1.0 - tr["busy_ms"] / wall_ms,
                     bound_ms=gathered / PEAK_BYTES_PER_S * 1e3, bound_by="bytes")
        out[f"chains_{name}"] = stats
        print(f"phase 6b chains: {name} program, V {tuple(stats['shape'])}, {K} chains x "
              f"{stats['rungs']} rungs, {iters} iterations: {wall_ms} ms wall (host clock), "
              f"{tr['busy_ms']} ms device ({tr['launches']} launches, {tr['copies']} copies, "
              f"{tr['launches'] / iters} launches an iteration), idle {stats['idle_share']:.2%}; "
              f"bound {stats['bound_ms']} ms (bytes of V gathered: {gathered})")
    print(f"phase 6b chains: first {k} chains index for index against the NumPy oracles "
          f"(grid energies rel err {g_err}, history {h_err}; flat {f_err}; bar 1e-12), two "
          f"runs of each bitwise equal; the grid oracle took {oracle_s} s on the host")

    # 6c: alternating optimization of one job.
    kw = dict(rounds=PLAN_ROUNDS, mcmc_iters=PLAN_ITERS, seed=0, chains=PLAN_CHAINS,
              pool_size=PLAN_POOL)
    card = program_stats(  # the defaults: backend="torch" on the card
        lambda: alt.alternating_optimize(wl.DLRM, n, hw, **kw),
        {"chain programs": (pt.TorchChainKernel, "run"), "pools": (pt, "strategy_pool"),
         "topology_finder": (alt, "topology_finder"), "evaluate": (alt, "evaluate")})
    plan = card.pop("out")
    t0 = time.perf_counter()
    on_cpu = alt.alternating_optimize(wl.DLRM, n, hw, backend="torch", device="cpu", **kw)
    cpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    numpy_plan = alt.alternating_optimize(wl.DLRM, n, hw, rounds=PLAN_ROUNDS,
                                          mcmc_iters=PLAN_ITERS, seed=0, backend="numpy")
    numpy_s = time.perf_counter() - t0
    require(plan.strategy == on_cpu.strategy and plan.iter_time == on_cpu.iter_time
            and sorted(plan.topology.graph.edges()) == sorted(on_cpu.topology.graph.edges()),
            f"DLRM plan on the card {plan.strategy} {plan.iter_time} vs the CPU's "
            f"{on_cpu.strategy} {on_cpu.iter_time}")
    require(plan.strategy.mode == "hybrid", f"DLRM plan {plan.strategy}")
    candle = alt.alternating_optimize(wl.CANDLE, n, hw, **kw)
    require(candle.strategy.mode == "dp", f"CANDLE plan {candle.strategy}")
    out["alternating"] = dict(
        dlrm_mode=plan.strategy.mode, dlrm_iter_time=plan.iter_time, rounds=plan.rounds,
        candle_mode=candle.strategy.mode, candle_iter_time=candle.iter_time,
        cpu_s=cpu_s, numpy_s=numpy_s, numpy_iter_time=numpy_plan.iter_time, **card)
    print(f"phase 6c alternating: DLRM on {n} servers, {PLAN_ROUNDS} rounds x {PLAN_ITERS} "
          f"iterations, {PLAN_CHAINS} chains, pool {PLAN_POOL}: {plan.strategy.mode} "
          f"({len(plan.strategy.table_hosts)} table hosts), iter_time {plan.iter_time!r} "
          f"(rounds {plan.rounds}), the CPU's plan to the bit; CANDLE {candle.strategy.mode} "
          f"{candle.iter_time!r}; wall {card['wall_s']} s on the card, {cpu_s} s torch on "
          f"the CPU, NumPy backend {numpy_s} s (its plan {numpy_plan.strategy.mode} "
          f"{numpy_plan.iter_time!r}); first call on the card {card['first_s']} s; steady "
          f"host wall by part (ms) {card['parts_ms']}, the rest (pricing the pools, the "
          f"NumPy re-price) {card['wall_s'] * 1e3 - sum(card['parts_ms'].values())} ms; chain "
          f"programs: {card['programs']} runs, {card['busy_ms']} ms device, "
          f"{card['launches']} launches, {card['copies']} copies, idle "
          f"{card['idle_share']:.2%}, on {smi}")

    # 6d: the fused four-tenant admission.
    def admit(device=None):
        cs = admission_candidates(wl, n)
        return alt.co_optimize_jobset(
            cs[0], hw, rounds=PLAN_ROUNDS, mcmc_iters=PLAN_ITERS, seed=ADMIT_SEED,
            placement_candidates=cs, chains=ADMIT_CHAINS,
            temperatures=pt.DEFAULT_TEMPER_LADDER, device=device)

    steady = program_stats(admit, {
        "grid programs": (pt.TorchChainKernel, "run_grid"),
        "pool pricing": (pt, "pack_jobset_grid"),
        "topology_finder": (alt, "topology_finder"),
        "pools": (pt, "strategy_pool"),
    })
    fused = steady.pop("out")
    t0 = time.perf_counter()
    on_cpu = admit("cpu")
    cpu_s = time.perf_counter() - t0
    same = lambda a, b: (a.candidate_index == b.candidate_index  # noqa: E731
                         and a.strategies == b.strategies and a.iter_time == b.iter_time
                         and sorted(a.topology.graph.edges())
                         == sorted(b.topology.graph.edges()))
    require(same(fused, on_cpu),
            f"admission plans differ: card {fused.iter_time}, CPU {on_cpu.iter_time}")
    modes = {k: v.mode for k, v in fused.strategies.items()}
    out["admission"] = dict(candidate=fused.candidate_index, iter_time=fused.iter_time,
                            modes=modes, grid=[C, T, S, L], cpu_s=cpu_s, **steady)
    print(f"phase 6d admission: 4 tenants x {len(ADMIT_SHIFTS)} placements, ladder "
          f"{pt.DEFAULT_TEMPER_LADDER}, {ADMIT_CHAINS} chains, {PLAN_ROUNDS} rounds x "
          f"{PLAN_ITERS} iterations: candidate {fused.candidate_index}, {modes}, iter_time "
          f"{fused.iter_time!r}, the CPU's plan; wall {steady['first_s']} s first call, "
          f"{steady['wall_s']} s steady, {cpu_s} s torch on the CPU; steady host wall by "
          f"part (ms) {steady['parts_ms']}, the rest "
          f"{steady['wall_s'] * 1e3 - sum(steady['parts_ms'].values())} ms; grid programs: "
          f"{steady['programs']} runs, {steady['busy_ms']} ms device, {steady['launches']} "
          f"launches, {steady['copies']} copies, idle {steady['idle_share']:.2%}, on {smi}")
    return out



# Phases 6e and 6f (the online planner): the admission at the paper's scale,
# then replays on the card against the same calls on the CPU.  6e: DLRM
# (weight 2) and BERT resident on 32 servers each and CANDLE on 16, VGG16
# arriving on 32 of the 48 free servers through 4 placement candidates (with
# 32 free, every candidate would be the same 32 and nothing would be
# co-searched).  6f: the churn trace of the JAX
# package's bench_multitenant.py at 32 servers, bench_online.py's FAILURES
# trace with DLRM at 16, and a seeded fault storm (bench_faults.py's shape) at
# 16; the traces end at iteration 4, so 5 iterations replay them whole.
ADMIT_RESIDENTS = (("DLRM", 2.0, range(0, 32)), ("BERT", 1.0, range(32, 64)),
                   ("CANDLE", 1.0, range(64, 80)))
ADMIT_ARRIVAL, ADMIT_K, ADMIT_CANDIDATES = "VGG16", 32, 4
CHURN_N, FAILURES_N, ONLINE_ITERS = 32, 16, 5
STORM_ITERS, STORM_SCALE, STORM_SEED = 3, 16.0, 0


def replay_view(r) -> dict:
    """Everything a replay reports, every float exact (the records by repr)."""
    strategies = getattr(r.final_plan, "strategies", None) or {"": r.final_plan.strategy}
    view = dict(total_time=r.total_time, iter_times=r.iter_times, n_replans=r.n_replans,
                n_failures=r.n_failures, edges_moved=r.edges_moved, log=repr(r.log),
                strategies={k: repr(v) for k, v in strategies.items()},
                edges=sorted(r.final_plan.topology.graph.edges()),
                iter_time=r.final_plan.iter_time)
    if hasattr(r, "final_jobset"):
        view.update(job_times=r.job_times, migrations=repr(r.migrations), refused=r.refused,
                    placements={t.label: t.servers for t in r.final_jobset.tenants})
    return view


def online_phase(dev, smi) -> dict:
    """Phases 6e and 6f (see the module docstring); returns their numbers."""
    from repro_torch.core import alternating as alt
    from repro_torch.core import online
    from repro_torch.core import planeval_torch as pt
    from repro_torch.core import workloads as wl
    from repro_torch.core.faults import FaultModel, server_domain
    from repro_torch.core.netsim import HardwareSpec
    from repro_torch.core.simengine import SimEngine
    from repro_torch.core.strategy_search import evaluate_jobset

    hw = HardwareSpec(link_bandwidth=PLAN_LINK_BW, degree=PLAN_DEGREE)
    ladder = pt.DEFAULT_TEMPER_LADDER
    out: dict = {}

    # 6e: the admission an arriving job waits for, at 128 servers.
    residents = wl.JobSet(n=PLAN_N, tenants=[
        wl.TenantJob(spec=getattr(wl, name), weight=w, name=name, servers=tuple(servers))
        for name, w, servers in ADMIT_RESIDENTS])
    t0 = time.perf_counter()
    plan = alt.co_optimize_jobset(residents, hw, rounds=PLAN_ROUNDS, mcmc_iters=PLAN_ITERS,
                                  seed=ADMIT_SEED, chains=ADMIT_CHAINS, temperatures=ladder)
    setup_s = time.perf_counter() - t0
    policy = online.ReoptPolicy.reactive(replan_latency=0.0, candidates=ADMIT_CANDIDATES,
                                         chains=ADMIT_CHAINS, temperatures=ladder)
    ctrl = online.JobSetController(residents, hw=hw, policy=policy, seed=ADMIT_SEED, plan=plan)
    free = ctrl.jobset.free_servers()
    parts = {"optimizer": (online, "co_optimize_jobset"), "fluid probes": (SimEngine, "run"),
             "place_arrival": (online, "place_arrival"),
             "place_candidates": (online, "place_candidates"),
             "fused": (alt, "_co_optimize_fused"),
             "grid programs": (pt.TorchChainKernel, "run_grid")}
    with timed_parts(parts) as spent:
        t0 = time.perf_counter()
        admitted = ctrl.admit(getattr(wl, ADMIT_ARRIVAL), ADMIT_K, name=ADMIT_ARRIVAL, now=0.0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    require(admitted is not None, "the arrival was refused")
    servers, _ = admitted
    require(len(servers) == ADMIT_K and set(servers) <= free,
            f"admitted on {servers}, free were {sorted(free)}")
    fused_args = spent["fused"][2]
    require(spent["fused"][1] == 1 and fused_args[1]["device"] is None
            and len(fused_args[0][1]) == ADMIT_CANDIDATES and spent["grid programs"][1] >= 1,
            "the admission did not run the fused co-search on the card: calls "
            f"{ {label: n for label, (_, n, _) in spent.items()} }")
    require(ADMIT_ARRIVAL in ctrl.plan.strategies, f"the admission kept the old plan: {ctrl.log}")
    bad = ctrl.plan_violations(ctrl.topology)
    require(not bad, f"plan violations: {bad}")
    repriced = evaluate_jobset(ctrl.plan.strategies, ctrl.jobset, ctrl.plan.topology, hw)[0]
    require(repriced == ctrl.plan.iter_time,
            f"NumPy re-price {repriced!r} vs the plan's {ctrl.plan.iter_time!r}")
    split = {label: spent[label][0] * 1e3 for label in
             ("optimizer", "fluid probes", "place_arrival", "place_candidates")}
    split["rest"] = wall * 1e3 - sum(split.values())
    # The chain programs' device time: the admission's optimizer call again.
    args, kwargs, result = spent["optimizer"][2]
    steady = program_stats(lambda: alt.co_optimize_jobset(*args, **kwargs), {
        "grid programs": (pt.TorchChainKernel, "run_grid"),
        "pool pricing": (pt, "pack_jobset_grid"),
        "topology_finder": (alt, "topology_finder"),
        "pools": (pt, "strategy_pool"),
    })
    again = steady.pop("out")
    require(again.candidate_index == result.candidate_index
            and again.strategies == result.strategies and again.iter_time == result.iter_time
            and sorted(again.topology.graph.edges()) == sorted(result.topology.graph.edges()),
            "the admission's optimizer call does not repeat to the bit")
    out["admission"] = dict(n=PLAN_N, setup_s=setup_s, wall_s=wall, parts_ms=split,
                            probes=spent["fluid probes"][1], candidate=ctrl.plan.candidate_index,
                            iter_time=ctrl.plan.iter_time, servers=[min(servers), max(servers)],
                            optimizer=steady)
    sizes = ", ".join(f"{t.label} on {t.k}" for t in residents.tenants)
    print(f"phase 6e admission: {sizes} of {PLAN_N} servers (their plan {setup_s} s on the "
          f"card, {PLAN_ROUNDS} rounds x {PLAN_ITERS} iterations, ladder {ladder}, "
          f"{ADMIT_CHAINS} chains); "
          f"JobSetController.admit({ADMIT_ARRIVAL}, {ADMIT_K}) over {ADMIT_CANDIDATES} "
          f"candidates, fused, {policy.rounds} rounds x {policy.mcmc_iters} iterations: servers "
          f"{min(servers)}..{max(servers)}, candidate {ctrl.plan.candidate_index}, iter_time "
          f"{ctrl.plan.iter_time!r} (NumPy re-price to the bit), no plan violation; wall "
          f"{wall} s, by part (ms) {split}, {spent['fluid probes'][1]} fluid probes; the "
          f"optimizer call again: {steady['wall_s']} s steady, by part (ms) "
          f"{steady['parts_ms']}; grid programs {steady['programs']} runs, {steady['busy_ms']} "
          f"ms device, {steady['launches']} launches, {steady['copies']} copies, idle "
          f"{steady['idle_share']:.2%}, on {smi}")

    # 6f: replays, each on the card and then as the same call on the CPU.
    def replay(run, policy, **kw) -> dict:
        with timed_parts({"replans": (online.ReoptController, "replan")}) as spent:
            t0 = time.perf_counter()
            card = run(policy=policy, **kw)
            card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        on_cpu = run(policy=dataclasses.replace(policy, device="cpu"), **kw)
        cpu_s = time.perf_counter() - t0
        require(replay_view(card) == replay_view(on_cpu),
                f"replay on the card differs from the CPU's: {replay_view(card)} vs "
                f"{replay_view(on_cpu)}")
        return dict(card_s=card_s, cpu_s=cpu_s, replan_ms=spent["replans"][0] * 1e3,
                    replan_calls=spent["replans"][1],
                    total_time=card.total_time, n_replans=card.n_replans,
                    n_failures=card.n_failures, edges_moved=card.edges_moved)

    third = CHURN_N // 3
    shared = wl.JobSet(n=CHURN_N, tenants=[
        wl.TenantJob(spec=wl.DLRM, servers=tuple(range(0, third)), name="dlrm"),
        wl.TenantJob(spec=wl.BERT, servers=tuple(range(third, 2 * third)), name="bert")])
    churn = (
        online.TraceEvent(iteration=1, kind="arrive", job=wl.MOE_16E,
                          k=max(2, CHURN_N - 2 * third), name="moe"),
        online.TraceEvent(iteration=2, kind="fail", link=(0, 3)),
        online.TraceEvent(iteration=3, kind="depart", name="bert"),
        online.TraceEvent(iteration=4, kind="fail", link=(1, third), frac=0.5),
    )
    shared_plan = alt.co_optimize_jobset(shared, hw, rounds=2, mcmc_iters=60, seed=1)
    run_shared = lambda policy: online.run_online_jobset(  # noqa: E731
        shared, hw, policy=policy, trace=churn, n_iters=ONLINE_ITERS, seed=0, plan=shared_plan)
    static = replay(run_shared, online.ReoptPolicy.never())
    reactive = replay(run_shared, policy)
    require(reactive["n_replans"] >= 1, "the reactive churn replay never replanned")
    failures = (
        online.TraceEvent(iteration=1, kind="fail", link=(0, 1)),
        online.TraceEvent(iteration=2, kind="fail", link=(3, 7), frac=0.4),
        online.TraceEvent(iteration=4, kind="fail", link=(2, 6)),
    )
    dlrm_plan = alt.alternating_optimize(wl.DLRM, FAILURES_N, hw, rounds=3, mcmc_iters=80,
                                         seed=1)
    run_dlrm = lambda policy, trace, n_iters: online.run_online(  # noqa: E731
        wl.DLRM, FAILURES_N, hw, policy=policy, trace=trace, n_iters=n_iters, seed=0,
        plan=dlrm_plan)
    dlrm = replay(run_dlrm, online.ReoptPolicy.reactive(), trace=failures,
                  n_iters=ONLINE_ITERS)
    require(dlrm["n_replans"] >= 1, "the reactive FAILURES replay never replanned")
    iter_s = run_dlrm(online.ReoptPolicy.never(), (), 1).total_time
    pairs = sorted({(min(a, b), max(a, b)) for a, b in dlrm_plan.topology.graph.edges()})
    horizon = STORM_ITERS * iter_s
    storm = FaultModel.for_topology(
        dlrm_plan.topology, link_mtbf=STORM_SCALE * horizon, link_mttr=0.1 * horizon,
        domains=[server_domain(1, pairs, mtbf=horizon, mttr=0.05 * horizon)],
        seed=STORM_SEED).events(STORM_ITERS, iter_s)
    stormed = replay(run_dlrm, online.ReoptPolicy.reactive(min_interval=iter_s), trace=storm,
                     n_iters=STORM_ITERS)
    require(stormed["n_failures"] >= 1 and stormed["n_replans"] >= 1,
            f"the storm replay saw no failure or no replan: {stormed}")
    out["replays"] = dict(churn_static=static, churn_reactive=reactive, failures=dlrm,
                          storm=dict(events=len(storm), **stormed))
    def said(r: dict) -> str:
        return (f"total {r['total_time']!r} s, {r['n_failures']} failures, {r['n_replans']} "
                f"replans ({r['replan_calls']} replan calls, {r['replan_ms']} ms), "
                f"{r['edges_moved']} fibers moved; {r['card_s']} s on the card, {r['cpu_s']} "
                "s on the CPU")

    print(f"phase 6f replay: run_online_jobset, churn at {CHURN_N} servers, {ONLINE_ITERS} "
          f"iterations: static {said(static)}; reactive {said(reactive)}; static/reactive "
          f"{static['total_time'] / reactive['total_time']}")
    print(f"phase 6f replay: run_online, DLRM at {FAILURES_N} on FAILURES, {ONLINE_ITERS} "
          f"iterations, reactive: {said(dlrm)}")
    print(f"phase 6f replay: run_online, fault storm (seed {STORM_SEED}, server 1's domain "
          f"and {len(pairs)} flapping pairs: {len(storm)} events) over {STORM_ITERS} "
          f"iterations, reactive with a {iter_s} s hysteresis: {said(stormed)}")
    print(f"phase 6f replay: every replay on the card equal to the CPU's to the bit, on {smi}")
    return out

if __name__ == "__main__":
    sys.exit(main())
