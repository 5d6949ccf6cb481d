#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (src/repro_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line) on any
error; none catches its own failure:

1. require a CUDA card and print `nvidia-smi`'s name and power limit;
2. build the CUDA kernels from src/repro_torch/csrc (one nvcc per source),
   printing the build time and the -Xptxas -v register / shared-memory lines;
3. [check] hold each kernel against its plain PyTorch version on the card,
   in fp32 and bf16, at small edge-case shapes and at full width (qwen3-8b:
   c=256, r=16, Dh=128, H=32, Hkv=8): the blockwise forward at S=1024 and
   decode at B=4, M=256; the residual-emitting forward and the backward at
   the train step's shapes (B=2, S=4096), plus a backward with per-row
   start blocks; the prefix form (both forms) and its quantized sibling at
   the chunked serve's shapes (B=4, P=512, M=288, start blocks 0, 3, 7, 14)
   and quantized decode at B=4, M=288, int8 and fp8 pages; both decode
   kernels also at their edges (DEC_EDGE_SHAPES: a B=1 step whose key
   splits see no visible key, c + M not a multiple of the 64-key tile, a
   fully masked row, misaligned views, G=3 and G=6, Dh 16/32/64/128), each
   launched twice with bit-identical results; the prefix form (both forms)
   and its int8/fp8 sibling also at their edges (PREFIX_EDGE_SHAPES: the
   bf16 tensor-core kernel's 64-row query tile spanning blocks at c = 16,
   32, 48, G = 1, 3, 6, Dh 16/32/64, M = 0, a cut clamped at M, a start
   block at M/r - 1, misaligned views), launched twice, bit-identical;
   the training form's kernels 1, 1r and 2 also at their edges
   (TRAIN_EDGE_SHAPES: c = 16, 32, 48 with tiles spanning blocks, G = 1,
   3, 6, Dh 16/32/64/128, a ragged S, start blocks, a slot tile whose
   first row split holds no row, misaligned views), every training-form
   case launched twice, bit-identical, the route probes naming the tensor
   cores in bf16 and the SIMT kernels in fp32; kernel 2 at the train step's
   shapes replayed from a CUDA graph equals its eager launch;
4. [time] time each kernel at full width in bf16 by CUDA-graph replay
   (time_graph_ms; inputs rotated through more than the 50 MB L2 cache),
   its eager loop logged beside, next to its plain version, one masked
   `scaled_dot_product_attention` call computing the same function (over
   the dequantised operands for the quantized kernels; graph-timed too),
   and the least time the card could take (bytes over 3.35 TB/s or flops
   over 989 TFLOP/s); the training kernels at the train step's shapes
   (B=2, S=4096; kernel 1 there too, the train step's remat'd forward),
   the quantized ones with int8 pages; decode also at a B=1
   prompt-remainder step (logged); the tensor-core forward's and
   backward's registers and spills from -Xptxas -v beside their times;
5. [serve] serve 8 requests through full-width qwen3-8b cut to
   SERVE_LAYERS = 4 of its 36 layers (random
   bf16 weights from a seeded generator, bf16 cache, max_seq 4096,
   max_batch 4, decode_chunk 16), prompts of k·256+j tokens, with the
   kernels' launch counters reset just before and read just after; then a
   torch.profiler breakdown of one prefill and one decode chunk;
6. [serve-chunked] the same serve with chunked admission
   (prefill_chunk=512), counters reset and read around it: token agreement
   with [serve], then the profile of one chunk forward of a 4-row pool;
7. [serve-paged] the same chunked serve into the paged pool with int8
   pages: clean page accounting, cache bytes against the dense pool, then
   the profiles of one paged decode chunk and of one (4, 512) paged chunk
   forward, with the device time of its page gathers (`paged_gather`);
8. [parity] at full width with 2 layers in fp32: the kernels (backend
   "auto") against the plain reference: dense prefill logits within the
   stated tolerance and the first 16 greedy tokens of 2 requests
   identical; chunked admission through the kernels token-identical to
   monolithic; paged int8 and fp8 pools (chunked admission) with identical
   tokens, and their chunk forward a layer at a time on shared inputs and
   codes (paged_layer_parity): the same codes written, each block's output
   and the logits within the tolerance;
9. [train] 4 steps of the Trainer on full-width qwen3-8b cut to 8 layers
   (bf16, remat "full", seq 4096, global batch 2, synthetic corpus seed
   0), launch counters reset just before and read just after: each step's
   loss, grad norm, ms and tokens/s, peak memory, the route probes (tensor
   cores); then one more step timed alone and under torch.profiler;
10. [train-parity] at full width with 2 layers in fp32 (B=1, S=1024), one
   train step with the kernels (the SIMT route) and one with the plain
   reference from the same parameters and batch: loss, every gradient leaf
   and the parameters after AdamW within the stated tolerances;
   [train-parity-bf16] the same model and batch, the loss and every
   gradient leaf through the kernels in bf16 (kernels 1r and 2 on the
   tensor cores), through the plain reference in bf16 and in fp32: the
   kernel route no further from fp32 than BF16_PARITY_FACTOR times the
   plain bf16 route, plus BF16_PARITY_ABS (the loss over BF16_LOSS_DRAWS
   draws of parameters and batch);
11. [train-mlm] 8 Trainer steps of the paper's encoder, linformer-paper
   CONFIG at full width and full depth (12 layers, d=768, H=12, K=128,
   ~162 M parameters, bf16, remat "full", seq 512, global batch 32,
   synthetic corpus seed 0, MLM), launch counters reset just before and
   read just after: each step's loss, grad norm, ms and tokens/s, peak
   memory; then one forward alone under torch.no_grad (the inference the
   paper's Table 3 times) and one train step under torch.profiler, each
   profile's launches of kernels 5 and 6 equal to their counters';
12. [train-mlm-parity] the encoder at full width with 2 layers in fp32
   (B=2, S=512, an MLM batch): one train step through the kernels against
   one through the plain reference, held as in [train-parity];
13. [train-mlm-parity-bf16] the same encoder and batch, the loss and every
   gradient leaf through the kernels in bf16 (kernels 5 and 6 on the
   tensor cores), through the plain reference in bf16 and in fp32: the
   kernel route no further from fp32 than BF16_PARITY_FACTOR times the
   plain bf16 route, plus BF16_PARITY_ABS;
14. [serve-standard], [serve-standard-chunked] (right after [serve-paged],
   on its weights; the Linformer E/F ride along unused) the paper's softmax
   baseline: qwen3-8b with kind "standard", the same 8 requests into the
   full KV cache, monolithic and then chunked admission (prefill_chunk=512):
   no kernel of the port and no remainder step may run; tok/s, wall by
   activity, peak memory, cache bytes per request against the compressed
   pool, chunked tokens against monolithic; the profiles of one prefill
   and one 16-step decode chunk of a full 4-row pool;
15. [serve-slo] (right after [serve-standard], on [serve]'s weights) the
   SLO trace at full width, SERVE_LAYERS, bf16, paged int8 pool, chunked
   admission (prefill_chunk=512), max_batch 4, decode_chunk 16: 8
   requests of 256·{1,2,3,4,1,2,3,4} tokens and 24 new, priorities
   2,2,1,1,0,0,0,1, arrivals 0,0,0,0,1,1,2,2, a deadline on priority 0,
   a snapshot of every row every chunk, an arena of 10 usable pages, one
   fault of each kind (SLO_FAULTS); launch counters reset just before and
   read just after (kernels 8 and 7 must launch): priority and page
   preemptions, a checksum-caught snapshot, one quarantine per fault,
   every request complete or shed with a reason, every page free after;
   the snapshot capture and restore costs (host ms and MB a row, paged,
   then a dense bf16 row at max_seq 4096); tokens against a fault-free
   FCFS serve;
   [sample] temperature 0.8 on the same weights with a CUDA generator: one
   seed twice gives the same tokens, temperature 0 [serve]'s greedy
   tokens, a CPU generator is refused, 2·10^4 Gumbel-max draws from one
   logits row within 0.02 total variation of softmax(logits / T) over 10
   equal-mass bins;
   [serve-slo-parity] the SLO trace, faults and preemptions included, at
   full width with 2 layers in fp32 on the dense pool, monolithic (kernels
   1, 3) and chunked (4, 3): decisions and tokens equal to the plain
   reference route's on the same trace, and every completed request
   token-identical to a fault-free FCFS serve;
16. [serve-standard-parity] (after [parity]) 2 layers at full width in
   fp32, kind "standard": chunked admission token-identical to monolithic,
   the prefill logits at every position within LOGITS_TOL of decoding the
   prompt step by step over the full cache;
17. [train-mlm-standard] 8 Trainer steps of linformer-paper CONFIG with
   kind "standard" as [train-mlm] (Figure 3's baseline, Table 3's n = 512
   from the trainer's side): no kernel of the port may launch; then the
   forward alone;
18. [figure1] core/low_rank.py on the card, on that model: P per layer and
   head at n = 512 (the first sequence of an MLM batch), the cumulative
   singular-value mass at rank 128, the JL and Theorem-2 errors at k = 128;
19. [train-mlm-nonuniform] 8 Trainer steps of linformer-paper CONFIG
   unrolled (scan_layers=False, no remat, as in JAX) with headwise E/F and
   k_decay 0.5 (NONUNIFORM: K = 128 down to 64 by effective_k), launch
   counters reset just before and read just after: exactly one launch of
   kernel 5 and two of kernel 6 per layer per step, profiles equal to the
   counters; then the forward alone, logged beside [train-mlm] and
   [train-mlm-standard];
20. [table3] paper Table 3: the forward alone of linformer-paper CONFIG at
   max_seq_len = n for the standard baseline and Linformer at k = 128, 256
   (TABLE3: n = 512 to 16384 at 16 k tokens a batch, Linformer also at
   32768 and 65536, B = 1), the launch counters reset just before and read
   just after every forward (12 launches of kernel 5 and 24 of kernel 6 a
   Linformer forward, none a standard one): median ms, tokens/s, peak
   memory above the weights, time saved and memory saved (standard ÷
   Linformer); one layer's attention alone by CUDA-graph replay
   (standard_attention, kernels 6, 6 and 5, and one SDPA call as a
   yardstick);
21. [per-token] (right after [sample], on [serve]'s weights) 4 prompts of
   1024 tokens, 32 new: generate_batch's device-resident decode chunks
   against the per-token loop (one host round trip a token), each after a
   warm-up, launch counters reset around each: equal tokens; prefill and
   decode walls, tok/s, the per-token ÷ scan decode wall;
22. [serve-dense] (after [serve-standard-parity]) qwen3-14b,
   nemotron-4-15b and qwen1.5-110b at full width cut to
   SERVE_DENSE_LAYERS (bf16, random weights, seed 0; max_seq 4096,
   max_batch 4, decode_chunk 16): 8 requests of 256·{1,2,3,4,1,2,3,4}
   prompt tokens (whole blocks: no remainder step may run) and 16 new,
   monolithic into the dense pool (kernels 1, 3) and chunked (P = 512)
   into the paged int8 pool (kernels 8, 7), counters reset around each:
   tok/s, peak memory, cache bytes a request, decode chunks, launches;
   [serve-dense-parity] each config in fp32 as [parity], the paged legs
   at 1 layer (both routes then write the same codes; past it they drift
   by quantization flips, which scripts/paged_parity_spread.py counts);
23. [train-dense] (after [train-parity-bf16]) two Trainer steps of each
   dense config at full width cut to TRAIN_DENSE_LAYERS (bf16, remat full,
   seq 4096, batch 1; kernels 1, 1r, 2 on the tensor cores at G = 5, 6,
   8): step ms, peak; [train-dense-parity] the 2-layer fp32 cut's loss and
   every gradient leaf through the kernels against the plain reference at
   seq 1024 (within TRAIN_LOSS_RTOL and TRAIN_GRAD_RTOL; the reference's
   gradients wait in host memory, and the AdamW update is not compared:
   fp32 weights, two gradient copies and moments do not fit at once);
24. [frontends] internvl2-2b (256 patch embeddings prepended) and
   musicgen-large (frame embeddings in place of tokens) whole in bf16: a
   forward building the cache over 2 × 1024 positions and 16 decode steps
   (kernels 1, 3), then two train steps at 2 × 4096 through
   make_train_step (1, 1r, 2; G = 2 at Dh = 128 and G = 1 at Dh = 64);
   [frontends-parity] the 2-layer fp32 cut against the plain reference:
   the forward's and 8 decode steps' logits within LOGITS_TOL, one train
   step as [train-parity];
25. [serve-ckpt] two Trainer steps of qwen3-8b SMOKE in bf16 saved to a
   temporary directory, served by `launch/serve.py --ckpt-dir`: the
   tokens of an engine over the trainer's in-memory params.

26. [serve-hybrid], [serve-ssm] (after [train-moe-parity]) zamba2-1.2b
   (38 layers: a Mamba2 trunk and one shared attention + MLP block,
   blockwise-causal Linformer, after every 6 trunk layers) and rwkv6-1.6b
   (24 attention-free RWKV6 layers) at full width cut to SERVE_SSM_LAYERS
   in bf16 (random weights, seed 0; max_seq 4096, max_batch 4, decode_chunk 16): 8 requests of
   SERVE_SSM_LENS prompt tokens and 128 new through serve(), which takes
   the static bucketed path (the caches keep one scalar position); the
   counters reset around the serve must read kernel 1 once per shared
   block invocation of each forward and kernel 3 once per invocation of
   each decode step for zamba2 (2 each at 13 layers), no kernel for rwkv6; tok/s, peak
   memory, cache bytes a request, a profiled 4-step decode chunk of a
   4-row batch; [serve-hybrid-parity] zamba2 cut to 7 layers in fp32, the
   kernels against the plain reference: forward logits within LOGITS_TOL,
   the same 16 tokens at 600-token prompts (remainder steps) and 200
   (every prompt token a decode step); [serve-ssm-parity] rwkv6 cut to 2
   layers in fp32 at S = 512 and 600: forward's logits against a loop of
   decode_step over the same tokens within SSM_STEPWISE_TOL, all finite;
27. [train-hybrid], [train-ssm] 4 Trainer steps of each config whole
   (bf16, remat full on the trunk, 2 × 4096): step ms, tokens/s, peak
   memory, loss; zamba2 launches kernels 1r and 2 six times a step each
   (on the tensor cores), rwkv6 none; rwkv6's four steps again from the
   same draw in fp32 ([train-ssm float32]); each with a parity leg at the
   cut depth of its serve parity (fp32, 1 × 1024): zamba2's as
   [train-parity], rwkv6's (which has no kernel: its routes run the same
   code) the fp32 loss and every gradient leaf against the same port code
   in fp64 (rwkv_model.float64_reference) within SSM_F64_GRAD_TOL of a
   leaf's largest entry and non-zero, the error of the time mix in fp32
   (the route before it ran in fp64) logged beside.
28. [telemetry] (after [per-token]) the port's telemetry on a full-width
   overload serve: qwen3-8b at SERVE_LAYERS in bf16, the paged int8 pool
   with chunked admission (kernels 8 and 7), the JAX package's overload
   trace shape (TEL_* constants: a priority-2 backlog oversubscribing the
   pool, a bounded queue shedding part of it as queue_full, priority-0
   arrivals with deadlines preempting their way in with a snapshot and a
   restore, two priority-1 requests with infeasible deadlines shed as
   deadline_infeasible, a snapshot of every row every TEL_SNAPSHOT_CHUNKS
   chunks; no request may end on EOS). Served with telemetry off (a
   warm-up), on, and off again: the same outputs, ShedResults, scheduler
   counters and launches of each kernel; the walls on and off; the share
   of the `serve` span in each scheduler span; TTFT and TPOT by priority;
   the Perfetto trace and the metrics JSONL exported to a temporary
   directory must pass `scripts/check_trace.py` with no dropped event.
   [train] runs its Trainer with a `Telemetry`: one `train_step` span and
   record a step, its step_ms and loss equal to `Trainer.history`'s.
29. (after [train-parity-bf16]) [chunked-ref] one qwen3-8b attention
   layer (B=1, H=32, Hkv=8, Dh=128, c=256, r=16): kernel 1 against the
   chunked reference form (and the plain one) at S = 16384, against the
   chunked form alone at S = 65536 (M = 4096), fp32 within FP32_TOL, bf16
   within BF16_PARITY_FACTOR of the bf16 reference's error against the
   fp32 reference of the same inputs; the peak memory of each; one fp32
   gradient at S = 16384 through the plain backward route (the chunked
   form) against kernels 1r and 2 within GRAD_TOL. [prefix-grad] the
   prefix form's VJP (kernel 4r forward, kernel 2 with start blocks
   backward) at B=4, P=512, M=288, start blocks 0, 3, 7, 14, fp32 and
   bf16: against autograd through the plain prefix form and against the
   plain twins, exact zeros on the slots no row sees, both kernels
   launched (bf16 against the twins: at most one bf16 step of the twin's
   value apart plus GRAD_TOL·max(1, max|twin|), check_grad_steps;
   `scripts/prefix_grad_spread.py` measures it over 16 draws); the offset
   backward timed by CUDA-graph replay beside the masked SDPA backward.
   [train-leftovers] [train]'s shape (8 layers, 2 ×
   4096, bf16) fed by document packing (FileCorpus over seeded .txt
   files), one warm-up and two timed steps under remat none, dots and
   full: the same first loss (REMAT_LOSS_RTOL) and grad norm
   (REMAT_GNORM_RTOL), peak memory none > dots > full. [tune] the smoke
   sweep of `repro_torch.tune.autotune` on the card (every trial logged,
   the table valid), then under that table two serves of [serve]'s
   requests on qwen3-8b at TUNE_SERVE_LAYERS layers, decode_chunk None
   (tuned) and 32: token-identical, and table hits counted in the serve's
   telemetry.

30. (after [table3]) [mesh] and [mesh-moe]: MESH_WORLD = 4 ranks spawned
   after the build, sharing the card under a gloo group (NCCL refuses two
   ranks on one device; gloo takes the CUDA tensors), each rank loading
   the built kernels. Every route of the attention plan on qwen3-8b's
   attention at full width (H=32, Hkv=8, Dh=128, c=256, r=16), on
   data2 × tp2, data2 × sp2 and sp2 × tp2 (MESH_LAYOUTS) against the
   world-size-1 kernel route, each leg in fp32 and in bf16: the causal
   form at B=2, S=4096, forward alone (kernel 1 a shard under tp, 4
   under sp) and with its backward (1r and 2 under tp, 4r and 2's offset
   form under sp); chunk prefill at B=4, P=512, M=288, dense and int8
   (4, 8); decode, dense and int8 (3, 7); the exact form at the paper's
   shapes on sp2 × tp2 (kernels 6 and 5 a shard, the k̄/v̄ psum), forward
   and gradients. fp32: tp legs within MESH_TP_TOL, sp legs and the exact
   form within GRAD_TOL (both of max(1, max|ref|)). bf16: an output's max
   abs error and a gradient's relative norm error against world size 1
   in fp32 on the rounded operands at most BF16_PARITY_FACTOR times world
   size 1's in bf16, plus BF16_PARITY_ABS, and the tensor-core route
   probed after each causal and prefix leg; one
   model-level train step of qwen3-8b at full width and 2 layers (fp32,
   B=1, S=1024, remat full) on sp2 × tp2 in the training layout (each
   rank its shard of every parameter; tensor-parallel: each matmul on its
   column or row shard, the vocabulary-parallel head and cross-entropy):
   the loss within TRAIN_LOSS_RTOL and every gradient leaf, gathered,
   within GRAD_TOL of world size 1, each rank's GB of parameters at
   rest, its peak GB and the step's comm bytes by op and mesh dim.
   [mesh-moe]: qwen3-moe-30b-a3b at full width,
   1 layer, fp32: the model's forward with the MoE layer expert-parallel
   on data2 × tp2 (against world size 1 on each data shard's rows) and on
   tp4, and weight-stationary decode of the layer (8 tokens, fsdp "data")
   against world size 1 with the flag off. Each rank holds its own
   results; rank 0 logs the legs, the comm helpers' bytes by op, the
   per-shard launches summed over the ranks (each kernel of the per-shard
   table at least once) and each phase's wall (time-sliced: no scaling
   number). In the same spawn, the training layout (each rank its rows of
   the batch and its shard of every parameter and moment, tensor-parallel
   over the model dim) and serving on
   a tp mesh, qwen3-8b at full width: [mesh-train] 2 layers on data2 ×
   tp2, fsdp "data", 2 AdamW steps (eps 1e-3, TRAIN_OPT) in fp32 (losses
   within TRAIN_LOSS_RTOL, every parameter gathered within GRAD_TOL of
   max(1, max|p|) of world size 1) and in bf16 (close_bf16's rules), each
   rank's GB at rest against world size 1's, its peak, comm bytes by op
   and by (op, mesh dim), and the head's bytes (its lm_head shard and the
   logits a step, against the whole vocabulary's); then zamba2-1.2b at 7
   layers and rwkv6-1.6b at 2 (MESH_SSM, full width, fp32, every Mamba2
   and RWKV6 block on this rank's heads), 2 steps against world size 1
   by the same gates and the logits of 3 decode steps after a prefill
   within MESH_SSM_LOGITS_TOL, the model-dim gathers of both held to
   ssm_model_gathers to the byte (the weight route's ssm/w_in and cm_w_r
   in training, only activations in decode), zamba2's shared block
   launching kernels 1r and 2 in training and 1 and 3 in the prefill and
   decode on its head shards;
   [mesh-train-compressed] pod2 × data2, bf16 at 1 layer (2 did not fit),
   3 steps of the int8 cross-pod step against the same rule at world size
   1 (COMPRESSED_LOSS_TOL), the exact step's gap logged; [mesh-elastic] a
   world-size-1 Trainer checkpoint at 1 layer, fp32, resumed on data2 ×
   tp2 and continued, against the world-size-1 continuation;
   [mesh-serve] 4 layers on data 1 × tp 2, ranks 0 and 1 (Hkv over tp,
   rows whole), 8 requests in an 8-row pool through the dense pool with
   P=512 chunked admission and the paged int8 pool, fp32 token for token
   against world size 1 (served meanwhile on ranks 2 and 3) and across the
   two ranks, the dense pool's bf16 agreement logged.
   Then a world-size-1 NCCL group resolves a plan (tp = sp = 1, no region)
   and one train step's loss and gradients under its ctx equal those
   without a ctx, bit for bit; and
   [launch], started beside the spawn, runs `torchrun --standalone
   --nproc-per-node 2 -m repro_torch.launch.train --smoke --mesh local
   --dist-backend gloo` (2 ranks on the card, a free port of their own),
   exit code 0.

31. (after [table3]) [audit] the trace audit (analysis/trace_audit.py) on
   the card: its decode (dense pool, then the paged int8 pool), chunk
   prefill and train (loss and backward) entries on qwen3-8b at full width
   cut to AUDIT_LAYERS = 2, bf16, the kernel routes (kernels 3, 7, 4, 1r
   and 2 must launch), each under torch.cuda.set_sync_debug_mode("error")
   and the TX rules: any finding fails the run.
32. [dryrun] the dry run (launch/dryrun.py) of [train]'s step (8 layers,
   bf16, remat full, 2 x 4096, its optimizer config) at world size 1 on
   FakeTensors, then the real step: argument bytes (parameters, moments,
   batch), each kernel's launches (the dry run's cost sink against the
   real step's counters, which the fake launches must leave at 0) and the
   aten FLOPs (FlopCounterMode over the real step) must be equal; the
   predicted peak
   beside torch.cuda.max_memory_allocated() must lie within the band of
   DRYRUN_ROUND_BYTES and DRYRUN_BLAS_BYTES.
33. (after [serve-ckpt]) [examples] the four examples of examples_torch/
   through their `main` on the card (their default device): quickstart,
   serve_batched, long_context_decode at 8192 tokens, and train_mlm at
   the paper's width (EXAMPLES_MLM: 12 layers, d 768, 12 heads, seq 512,
   k 128) for 20 steps and then into the same checkpoint directory with
   --steps 40, resuming at step 20. Each runs under KernelCalls: the
   launches of the kernels it reaches (quickstart 1r and 2 in training,
   3 in serving; serve_batched 1, 3, 4; long_context_decode 1, 3;
   train_mlm 5, 6), summed by wrapper equal to the wrapper's calls and
   exact where the path fixes them, what each `main` returns (finite
   losses, the asserts of serve_batched, the cache bytes, the resumed
   steps), then the first call at every shape held to the wrapper's plain
   twin on CPU copies of the same inputs (FP32_TOL, GRAD_TOL).

[check] also holds kernels 1, 1r, 2, 3, 4, 7 and 8 at the GQA groups of
these configs: G = 2, 5 and 8 at c = 256, Dh = 128 and G = 1 at Dh = 64
(the g*_c256 entries of TRAIN_EDGE_SHAPES, PREFIX_EDGE_SHAPES and
DEC_EDGE_SHAPES; the last covers kernel 7 in int8 and fp8 too).

Every torch.profiler breakdown is of the second of two runs, the first a
discarded warm-up step (profile_kernels), and lists the port's kernels by
function (the decode kernels' split and combine passes on their own).

[check] and [time] cover the encoder's two kernels too: the exact
Linformer attention (kernel 5) and the sequence projection (kernel 6), in
fp32 (SIMT) and bf16 (tensor cores), at edge shapes (K = 1, K = 130,
K = 512, a ragged S, GQA G = 2, Dh 16/32/64/128, E[:S] of a longer E, a
long S, q, x or E one element into its buffer), at the paper's full
width (B=32, H=12, S=512, K=128, Dh=64) and there at each K of the
nonuniform path (128, 123, ..., 70, 64), and at every shape [table3]
runs them at (H=12, Dh=64, K = 128 and 256, n = 512 to 65536 with
B = max(1, 16384 / n)), timed by CUDA-graph replay
beside one unmasked SDPA call and one torch.matmul of Eᵀ with x.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""
import collections
import dataclasses
import gc
import json
import math
import os
import signal
import subprocess
import sys
import time

# Kernel vs plain version. fp32: 1e-4 absolute (summation order). bf16:
# |kernel - plain| <= 2^-8·max|v| + 2^-7·|plain| elementwise: the plain
# version rounds each probability to bf16 (relative 2^-9) before the value
# product, where the kernel keeps it in fp32 (kernel 5 in bf16 rounds the
# unnormalised exp(s - m) instead: again at most 2^-9·max|v| an output),
# and each output is rounded once to bf16 (relative 2^-8).
FP32_TOL = 1e-4
# The residuals (m, denom) and the backward's outputs: kernel and plain
# version compute in fp32 from the same inputs, summing up to G·S terms in
# another order: 1e-4 of the tensor's largest entry; dq in bf16 adds
# 2^-7·|plain| (the two fp32 values round to bf16 at most one step apart).
GRAD_TOL = 1e-4
LOGITS_TOL = 2e-3      # 2-layer fp32 prefill logits, kernels vs reference
# [train-parity], kernels vs reference, fp32: loss relative; gradient leaf
# relative norm error; parameters after one AdamW step: the norm of the
# update difference over the update's. Adam's first step moves an entry by
# about lr·sign(g), so the update differs only where the two routes round a
# near-zero gradient entry to opposite signs (8.2e-5 measured on the H100).
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_RTOL = 1e-3
TRAIN_UPDATE_RTOL = 1e-3
# [train-mlm-parity-bf16]: the loss and each gradient leaf through the
# kernels in bf16 may be at most this many times as far from the fp32
# reference as the plain reference route in bf16 is, plus an absolute
# slack (loss: absolute error; gradient leaf: relative norm error)
BF16_PARITY_FACTOR = 2.0
BF16_PARITY_ABS = 1e-6
# the chunked and paged serves: chunk width (the JAX ServeConfig default)
# and page storage
SERVE_PREFILL_CHUNK = 512
SERVE_PAGE_DTYPE = "int8"


def log(msg):
    print(msg, flush=True)


def host_gb():
    """GB of host memory in use by the machine's processes and files, as
    its memory limit counts them (the cgroup's, v2 or v1), else the
    host's (MemTotal - MemAvailable); None when none can be read."""
    for path in ("/sys/fs/cgroup/memory.current",
                 "/sys/fs/cgroup/memory/memory.usage_in_bytes"):
        try:
            with open(path) as fh:
                return int(fh.read()) / 1e9
        except (OSError, ValueError):
            continue
    try:
        with open("/proc/meminfo") as fh:
            kb = {ln.split(":")[0]: int(ln.split()[1]) for ln in fh}
        return (kb["MemTotal"] - kb["MemAvailable"]) / 1e6
    except (OSError, KeyError, ValueError):
        return None


def time_ms(fn, n_sets, iters=30, warmup=3):
    """Mean device time of fn(i) over `iters` calls, cycling through
    `n_sets` input sets, by CUDA events around the whole run."""
    import torch
    for i in range(warmup):
        fn(i % n_sets)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i % n_sets)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_graph_ms(fn, n_sets, iters=60, stream=None):
    """Mean device time of fn(i) over `iters` calls, cycling through
    `n_sets` input sets: the calls are captured once into a CUDA graph,
    which is replayed between two CUDA events. Unlike time_ms this leaves
    out the host's time to enqueue each call, which at ~0.03 ms a call is
    as long as the call itself. `stream`: the capture stream (an autograd
    backward runs on its forward's stream, so a backward is captured on the
    stream its forward ran on)."""
    import torch
    for i in range(n_sets):                      # warm-up, outside capture
        fn(i)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for i in range(iters):
            fn(i % n_sets)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / iters
    del graph
    return ms


# host idle inside the recorded window on either side of the recorded step
# (scripts/profile_window.py measures why it is needed)
PROFILE_GAP_S = 0.05


def profile_kernels(fn, ranges=(), gap=PROFILE_GAP_S, trace=None):
    """Run fn twice under torch.profiler: a warm-up step whose trace is
    discarded, then the recorded step, with `gap` seconds of host idle on
    either side of it inside the recorded window. (A trace begun without a
    warm-up step missed the first kernels of its run. With the warm-up but
    no gap, a kernel's device timestamp can read milliseconds before its
    own launch call, so the first kernels of the step fall before the
    window's start and the profiler drops them: scripts/profile_window.py
    counts the dropped launches and the skew with and without the gap,
    and PERF.md keeps its runs.) Return
    [(kernel name, launches, device seconds)] of the recorded step sorted
    by device time, the launch counters' increments over that step, and
    {range: (calls, device seconds of the kernels launched inside it)} of
    the record_function `ranges` fn opens (their own GPU-side spans are not
    kernels and stay out of the list). `trace`: a path the Chrome trace is
    written to."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        time.sleep(gap)
        before = read_launches()
        fn()
        torch.cuda.synchronize()
        counted = {k: v - before[k] for k, v in read_launches().items()}
        time.sleep(gap)
        prof.step()
    if trace:
        prof.export_chrome_trace(trace)
    # the step's own annotation (ProfilerStep#) is not a kernel
    events = prof.key_averages()
    out = [(e.key, e.count, e.self_device_time_total * 1e-6)
           for e in events
           if e.device_type == DeviceType.CUDA
           and not e.key.startswith("ProfilerStep") and e.key not in ranges]
    spans = {e.key: (e.count, e.device_time_total * 1e-6) for e in events
             if e.device_type == DeviceType.CPU and e.key in ranges}
    return sorted(out, key=lambda x: -x[2]), counted, spans


# the device kernels of kernels 5 and 6 (bf16 tensor-core design, fp32
# SIMT design), as the profiler names them
DEVICE_KERNELS = {"linformer_attn": ("exact_fwd_mma_kernel",
                                     "exact_fwd_kernel"),
                  "seq_projection": ("seq_projection_mma_kernel",
                                     "seq_projection_kernel")}


def profiled_launches(kernels):
    """{kernel 5 or 6: its launches in a profile's kernel list}."""
    return {name: sum(n for k, n, _ in kernels
                      if any(f"::{f}<" in k for f in frags))
            for name, frags in DEVICE_KERNELS.items()}


def require_profiled(what, kernels, counted):
    """Each of kernels 5 and 6 launched in a profiled run shows in the
    profile exactly as often as its launch counter counted."""
    for name, seen in profiled_launches(kernels).items():
        log(f"  {what}: {name} {seen} launches profiled, "
            f"{counted[name]} counted")
        if seen != counted[name]:
            raise AssertionError(f"{what}: the profiler saw {seen} launches "
                                 f"of {name}, its counter {counted[name]}")


def log_profile(name, wall, kernels, top=8):
    """One profile's line: wall, device busy, launches, device time by
    group (the port's kernels, GEMMs, everything else); the port's kernels
    by function (all template instances together: the decode kernels' split
    and combine passes each on a line); the top kernels."""
    import re
    busy = sum(t for _, _, t in kernels)
    groups = {"port kernels": 0.0, "GEMMs": 0.0, "other": 0.0}
    port = {}
    for kname, n, t in kernels:
        if "repro_torch" in kname:
            groups["port kernels"] += t
            fn = re.search(r"::(\w+)(?:<|\()", kname.split("repro_torch", 1)[1])
            rec = port.setdefault(fn.group(1) if fn else kname, [0, 0.0])
            rec[0] += n
            rec[1] += t
        elif any(w in kname for w in ("nvjet", "gemm", "cutlass", "xmma")):
            groups["GEMMs"] += t
        else:
            groups["other"] += t
    log(f"[profile] {name}: wall {1e3 * wall:.2f} ms, device busy "
        f"{1e3 * busy:.2f} ms ({100 * busy / wall:.1f}%), "
        f"{sum(n for _, n, _ in kernels)} kernel launches; "
        + ", ".join(f"{g} {1e3 * t:.2f} ms" for g, t in groups.items()))
    if port:
        log("    port kernels: " + ", ".join(
            f"{fn} {1e3 * t:.3f} ms in {n}x"
            for fn, (n, t) in sorted(port.items(), key=lambda x: -x[1][1])))
    for kname, n, t in kernels[:top]:
        log(f"    {1e3 * t:9.3f} ms {n:6d}x  {kname[:90]}")


def bca_inputs(B, H, Hkv, S, c, r, Dh, dtype, dev, seed):
    import torch
    from repro_torch.core.causal import compress_blocks
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, S, H, Dh, generator=g, device=dev).to(dtype)
    k = torch.randn(B, S, Hkv, Dh, generator=g, device=dev).to(dtype)
    v = torch.randn(B, S, Hkv, Dh, generator=g, device=dev).to(dtype)
    E = (torch.randn(c, r, generator=g, device=dev) * r ** -0.5).to(dtype)
    nb = S // c
    kbar = compress_blocks(k.reshape(B, nb, c, Hkv, Dh), E)
    vbar = compress_blocks(v.reshape(B, nb, c, Hkv, Dh), E)
    tk = lambda x: x.movedim(2, 1)  # noqa: E731  model -> kernel layout
    return (tk(q), tk(k), tk(v), tk(kbar.reshape(B, nb * r, Hkv, Dh)),
            tk(vbar.reshape(B, nb * r, Hkv, Dh)))


def decode_inputs(B, Hkv, G, c, M, r, Dh, dtype, dev, seed, t,
                  edge=None):
    """Decode operands for rows at positions t (list): pos = t % c, blk =
    t // c select the visible ring entries and slots. `edge` (see
    DEC_EDGE_SHAPES): "shifted" moves the ring and the slots one element
    into their buffers, "masked_row" masks every key of row 1."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, Hkv, G, Dh, generator=g, device=dev).to(dtype)
    kv = [torch.randn(B, n, Hkv, Dh, generator=g, device=dev).to(dtype)
          for n in (c, c, M, M)]
    if edge == "shifted":
        kv = [shifted(x) for x in kv]
    return (q, *(x.movedim(2, 1) for x in kv),
            *decode_biases(B, c, M, r, t, dev, edge))


def prefix_inputs(shape, start, M, dtype, dev, seed):
    """Prefix-form operands in kernel layout: a query chunk, its own k/v in
    `dtype`, an fp32 slot buffer of M slots (cast or quantized by the
    caller), per-row start blocks (B,) int32."""
    import torch
    B, H, Hkv, P, c, r, Dh = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, H, P, Dh, generator=g, device=dev).to(dtype)
    k, v = (torch.randn(B, Hkv, P, Dh, generator=g, device=dev).to(dtype)
            for _ in range(2))
    ck, cv = (torch.randn(B, Hkv, M, Dh, generator=g, device=dev) * 2
              for _ in range(2))
    return q, k, v, ck, cv, torch.tensor(start, dtype=torch.int32,
                                         device=dev)


def quantized(x, page_dtype):
    """Kernel-layout (B, Hkv, N, Dh) fp32 -> codes and (B, Hkv, N) scales,
    as the paged cache stores them."""
    from repro_torch.core.cache import quantize_blockwise, resolve_page_dtype
    pdt, qmax = resolve_page_dtype(page_dtype)
    return quantize_blockwise(x, (3,), dtype=pdt, qmax=qmax)


def decode_biases(B, c, M, r, t, dev, edge=None):
    """(B, c) and (B, M) additive biases of rows at positions t; edge
    "masked_row" masks every key of row 1."""
    import torch
    from repro_torch.core.causal import NEG_INF
    t = torch.tensor(t, device=dev)
    bl = torch.where(torch.arange(c, device=dev)[None] <= (t % c)[:, None],
                     0.0, NEG_INF).float()
    bg = torch.where(torch.arange(M, device=dev)[None]
                     < (t // c * r)[:, None], 0.0, NEG_INF).float()
    if edge == "masked_row":
        bl[1], bg[1] = NEG_INF, NEG_INF
    return bl, bg


def decode_q_inputs(B, Hkv, G, c, M, r, Dh, dtype, page_dtype, dev, seed,
                    t, edge=None):
    """Quantized decode operands: q, ring and slot codes, their scales, the
    biases of rows at positions t; `edge` as in decode_inputs (the codes
    moved one byte into their buffers)."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, Hkv, G, Dh, generator=g, device=dev).to(dtype)
    ops = [quantized(torch.randn(B, Hkv, n, Dh, generator=g, device=dev),
                     page_dtype) for n in (c, c, M, M)]
    if edge == "shifted":
        ops = [(shifted(x), sc) for x, sc in ops]
    return (q, *(x for x, _ in ops), *(s for _, s in ops),
            *decode_biases(B, c, M, r, t, dev, edge))


def offset_residuals(q, k, kbar, start, kw):
    """(m, denom) of the offset form (visibility cut at n + start[b]),
    from the joint scores."""
    import torch
    from repro_torch.kernels import blockwise_causal_attn as bca
    nb = q.shape[2] // kw["block_size"]
    cut = torch.arange(nb, device=q.device)[None] + start.long()[:, None]
    s_loc, s_glob = bca.joint_scores(q, k, kbar, cut, **kw)
    m = torch.maximum(s_loc.amax(-1, keepdim=True),
                      s_glob.amax(-1, keepdim=True))
    d = (torch.exp(s_loc - m).sum(-1, keepdim=True)
         + torch.exp(s_glob - m).sum(-1, keepdim=True))
    return (m.reshape(q.shape[:3]).contiguous(),
            d.reshape(q.shape[:3]).contiguous())


def check(name, out, ref, dtype, values):
    """Hold a kernel's output against its plain version (see FP32_TOL);
    `values` are the value operands, whose magnitude scales the bf16
    bound. Returns the max absolute error."""
    import torch
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    if dtype == torch.float32:
        bound = torch.full_like(diff, FP32_TOL)
    else:
        vmax = max(v.float().abs().max().item() for v in values
                   if v.numel())          # an empty slot buffer (M = 0)
        bound = 2 ** -8 * vmax + 2 ** -7 * ref.float().abs()
    worst = (diff / bound).max().item()
    log(f"  {name} {str(dtype)[6:]}: max |kernel - plain| = {err:.3e}, "
        f"{worst:.2f} of its bound")
    if not worst <= 1.0:
        raise AssertionError(f"{name} {dtype}: error {err} beyond its bound")
    return err


def check_grad(name, out, ref):
    """Hold a residual or a gradient against its plain version (see
    GRAD_TOL). Returns the max absolute error."""
    import torch
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    bound = GRAD_TOL * max(1.0, ref.float().abs().max().item())
    if out.dtype == torch.bfloat16:
        bound = bound + 2 ** -7 * ref.float().abs()
    worst = (diff / bound).max().item()
    log(f"  {name}: max |kernel - plain| = {err:.3e}, {worst:.2f} of its "
        "bound")
    if not worst <= 1.0:
        raise AssertionError(f"{name}: error {err} beyond its bound")
    return err


def ptxas_registers(fragment):
    """[(slot storage, (Dh, further int template arguments), registers,
    spill bytes)] of every compiled entry whose name holds `fragment`, from
    the build's -Xptxas -v log."""
    import re
    from repro_torch.kernels import build
    lines = build.library().log.splitlines()
    out = []
    for i, line in enumerate(lines):
        if "Compiling entry" not in line or fragment not in line:
            continue
        name = line.split(fragment, 1)[1]
        slot = ("fp8" if "fp8" in name else "bf16" if "bfloat16" in name
                else "int8" if name.startswith("IaL") else "fp32")
        ints = tuple(map(int, re.findall(r"Li(\d+)E", name)))
        tail = " ".join(lines[i + 1:i + 4])
        regs = int(re.search(r"Used (\d+) registers", tail).group(1))
        spill = int(re.search(r"(\d+) bytes spill stores", tail).group(1))
        out.append((slot, ints, regs, spill))
    return sorted(out)


# [serve-slo]: one trace that turns every scheduler knob on at full width.
# Prompts of whole blocks (no remainder steps); priority 0 arrives after
# the pool is full of classes 2 and 1 and preempts; the arena holds 10
# pages for 4 rows whose prompts and budgets need up to 5 pages each, so
# prefills stall and decode chunks preempt; a snapshot of every row every
# chunk; one fault of each kind, on a row decoding at that chunk in the
# paged run and in both dense parity legs (rehearsed on the CPU at c = 256:
# the decisions depend on lengths, ticks and pages, not on widths). The
# snapshot_corrupt victim (request 6, priority 0) restarts from its prompt
# and meets its deadline of 8 ticks at tick 8 exactly.
SLO_BLOCKS = (1, 2, 3, 4, 1, 2, 3, 4)       # prompt lengths, in blocks
SLO_PRIORITIES = [2, 2, 1, 1, 0, 0, 0, 1]
SLO_ARRIVALS = [0, 0, 0, 0, 1, 1, 2, 2]
SLO_DEADLINE = 8                            # ticks, on the priority-0 ones
SLO_BUDGET = 24
SLO_ARENA_PAGES = 11                        # 10 usable + TRASH
SLO_FAULTS = (("slot_step", 1, 0), ("nan_logits", 2, 2),
              ("snapshot_corrupt", 4, 0))   # (kind, chunk, row)


def slo_prompts(cfg):
    import numpy as np
    c = cfg.attention.linformer.block_size
    rng = np.random.default_rng(2)
    return [list(map(int, rng.integers(4, cfg.vocab_size, n * c)))
            for n in SLO_BLOCKS]


def slo_serve(eng, prompts, faults=True):
    """Serve the SLO trace on `eng` (max_batch 4); with `faults`, through a
    FaultInjector firing SLO_FAULTS. Returns (outputs, scheduler,
    injector)."""
    from repro_torch.serving import Fault, FaultInjector
    inj = FaultInjector([Fault(*f) for f in SLO_FAULTS]) if faults else None
    outs, sched = eng.serve(
        prompts, SLO_BUDGET, max_batch=4, priorities=SLO_PRIORITIES,
        arrival_chunks=SLO_ARRIVALS,
        deadlines=[SLO_DEADLINE if p == 0 else None for p in SLO_PRIORITIES],
        snapshot_chunks=1, fault_injector=inj, return_scheduler=True)
    return outs, sched, inj


def check_slo(tag, outs, sched, inj):
    """Every request completes or is shed with a reason; every fired fault
    was quarantined (all three kinds are detectable) and none skipped."""
    from repro_torch.data.pipeline import EOS
    from repro_torch.serving import ShedResult
    st = sched.stats
    log(f"  {tag}: {st.counters_line()}; chunks {st.chunks}, idle ticks "
        f"{st.idle_ticks}, snapshots {st.snapshots}, completion ticks "
        f"{[sched.completed_at.get(i) for i in range(len(outs))]}")
    for i, o in enumerate(outs):
        if isinstance(o, ShedResult):
            log(f"    req{i} SHED at tick {o.tick}: {o.reason} (priority "
                f"{o.priority})")
        elif not isinstance(o, list) or not 0 < len(o) <= SLO_BUDGET \
                or EOS in o:
            raise AssertionError(f"{tag}: output {o!r}")
    fired = [(f.kind, f.chunk, f.row) for f in inj.fired]
    if inj.skipped or len(fired) != len(SLO_FAULTS):
        raise AssertionError(f"{tag}: fired {fired}, skipped {inj.skipped}")
    if st.quarantines != len(fired):
        raise AssertionError(f"{tag}: {st.quarantines} quarantines for "
                             f"{len(fired)} detectable faults")


def time_snapshots():
    """Shadow SlotPool.snapshot_rows and SlotPool.restore with wrappers that
    synchronise around each call and add its host wall and bytes to
    {"capture" | "restore": [rows, seconds, bytes]}. Returns (acc, undo)."""
    import torch
    from repro_torch.serving.scheduler import SlotPool
    acc = {"capture": [0, 0.0, 0], "restore": [0, 0.0, 0]}
    orig = {n: getattr(SlotPool, n) for n in ("snapshot_rows", "restore")}

    def timed(name, fn, nrows, nbytes):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        rec = acc[name]
        rec[0] += nrows
        rec[1] += time.perf_counter() - t0
        rec[2] += nbytes(out)
        return out

    def snapshot_rows(self, rows, tick):
        return timed("capture",
                     lambda: orig["snapshot_rows"](self, rows, tick),
                     len(rows), lambda out: sum(s.nbytes for s in out))

    def restore(self, row, request, snap):
        return timed("restore", lambda: orig["restore"](self, row, request,
                                                        snap),
                     1, lambda _: snap.nbytes)

    SlotPool.snapshot_rows, SlotPool.restore = snapshot_rows, restore

    def undo():
        SlotPool.snapshot_rows = orig["snapshot_rows"]
        SlotPool.restore = orig["restore"]
    return acc, undo


def log_snapshot_costs(acc):
    for name, (rows, secs, nbytes) in acc.items():
        if rows:
            log(f"  snapshot {name}: {rows} rows, {1e3 * secs / rows:.2f} "
                f"host ms a row, {nbytes / rows / 1e6:.2f} MB a row")


def serve_slo_phase(dev, cfg, params):
    """[serve-slo]: the SLO trace through the paged int8 pool under chunked
    admission (kernels 8 and 7) at full width, SERVE_LAYERS, bf16: launch
    counters reset just before and read just after; priority and page
    preemptions, a checksum-caught snapshot, one quarantine per fault;
    pages all free afterwards; the snapshot capture and restore costs;
    tokens against a fault-free FCFS serve of the same prompts. Then a
    dense bf16 pool's row captured and restored alone."""
    import torch
    t_phase = time.perf_counter()
    prompts = slo_prompts(cfg)
    eng = serve_engine(dev, cfg, params, prefill_chunk=SERVE_PREFILL_CHUNK,
                       cache_format="paged", page_dtype=SERVE_PAGE_DTYPE,
                       arena_pages=SLO_ARENA_PAGES)
    acc, undo = time_snapshots()
    try:
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        outs, sched, inj = slo_serve(eng, prompts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
    finally:
        undo()
    st = sched.stats
    n_tok = sum(len(o) for o in outs if isinstance(o, list))
    log(f"[serve-slo] {len(prompts)} requests (prompts "
        f"{[len(p) for p in prompts]}, priorities {SLO_PRIORITIES}, "
        f"arrivals {SLO_ARRIVALS}, deadline {SLO_DEADLINE} on priority 0), "
        f"paged {SERVE_PAGE_DTYPE}, {SLO_ARENA_PAGES} arena pages, faults "
        f"{list(SLO_FAULTS)}: {n_tok} tokens in {wall:.2f} s; launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    check_slo("serve-slo", outs, sched, inj)
    require_launches(launches, ("blockwise_causal_prefix_attn_q",
                                "decode_attn_q"), "serve-slo")
    for name, least in (("preemptions", 1), ("page_preemptions", 1),
                        ("snapshot_corruptions", 1)):
        if getattr(st, name) < least:
            raise AssertionError(f"serve-slo: {name} = {getattr(st, name)}")
    alloc = sched.pool.alloc
    alloc.check()
    if alloc.free_pages != alloc.usable_pages:
        leaked = alloc.usable_pages - alloc.free_pages
        raise AssertionError(f"serve-slo: {leaked} pages leaked")
    log_snapshot_costs(acc)
    t0 = time.perf_counter()
    fcfs = eng.serve(prompts, SLO_BUDGET, max_batch=4)
    same = sum(a == b for a, b in zip(outs, fcfs))
    log(f"  against a fault-free FCFS serve of the same prompts "
        f"({time.perf_counter() - t0:.2f} s): {same} of {len(outs)} "
        "requests token-identical (bf16: a retry from scratch or a resumed "
        "prefill rides in other chunk forwards)")
    del eng, sched
    # a dense bf16 row at full context: what a monolithic pool's preemption
    # moves to the host and back
    from repro_torch.serving.scheduler import Request, SlotPool, _Slot
    pool = SlotPool(serve_engine(dev, cfg, params), 4)
    pool.cache["lengths"][:] = 4096
    req = Request(rid=0, tokens=(5,), max_new_tokens=1)
    pool.slots[0] = _Slot(request=req, emitted=[])
    acc, undo = time_snapshots()
    try:
        for _ in range(3):
            pool.restore(1, req, pool.snapshot_rows([0], 0)[0])
    finally:
        undo()
    log("  dense bf16 pool, one row at max_seq 4096, 3 times:")
    log_snapshot_costs(acc)
    del pool
    log(f"  [serve-slo] {time.perf_counter() - t_phase:.1f} s")
    return launches


def serve_slo_parity_phase(dev, cfg):
    """[serve-slo-parity]: 2 layers at full width in fp32, the SLO trace
    with its faults and preemptions on the dense pool, monolithic
    (kernels 1, 3) and chunked (kernels 4, 3) admission: the same decisions
    and tokens as the plain reference route on the same trace, and every
    completed request token-identical to a fault-free FCFS serve."""
    import torch
    from repro_torch.models import model as tmodel
    from repro_torch.serving import ServingEngine
    t_phase = time.perf_counter()
    cfg2 = dataclasses.replace(cfg, num_layers=2, dtype="float32")
    params2 = tmodel.init_params(cfg2, seed=3, device=dev)
    prompts = slo_prompts(cfg)
    total = collections.Counter()
    for mode, kw, kernels in (
            ("monolithic", {}, ("blockwise_causal_attn", "decode_attn")),
            ("chunked", dict(prefill_chunk=SERVE_PREFILL_CHUNK),
             ("blockwise_causal_prefix_attn", "decode_attn"))):
        def engine(backend):
            return ServingEngine(params2, cfg2, max_seq=4096, device=dev,
                                 cache_dtype=torch.float32, decode_chunk=16,
                                 attention_backend=backend, **kw)
        eng = engine("auto")
        reset_launches()
        outs, sched, inj = slo_serve(eng, prompts)
        launches = read_launches()
        total.update(launches)
        tag = f"serve-slo-parity {mode}"
        check_slo(tag, outs, sched, inj)
        require_launches(launches, kernels, tag)
        if sched.stats.preemptions < 1:
            raise AssertionError(f"{tag}: no preemption")
        ref_outs, ref_sched, _ = slo_serve(engine("reference"), prompts)
        clean = eng.serve(prompts, SLO_BUDGET, max_batch=4)
        same_ref = outs == ref_outs and \
            sched.stats.counter_records() == \
            ref_sched.stats.counter_records()
        same_clean = all(not isinstance(o, list) or o == c
                         for o, c in zip(outs, clean))
        log(f"[serve-slo-parity] 2-layer fp32, {mode}: launches "
            f"{ {k: v for k, v in launches.items() if v} }; decisions and "
            f"tokens equal to the reference route's: {same_ref}; completed "
            f"requests token-identical to a fault-free FCFS serve: "
            f"{same_clean}")
        if not (same_ref and same_clean):
            raise AssertionError(f"{tag}: kernels {outs} reference "
                                 f"{ref_outs} fault-free {clean}")
    log(f"  [serve-slo-parity] {time.perf_counter() - t_phase:.1f} s")
    return dict(total)


SAMPLE_T = 0.8
SAMPLE_DRAWS = 20000


def sample_phase(dev, cfg, params, prompts, mono_outs):
    """[sample]: temperature sampling at full width on the card: a CUDA
    generator seeded twice gives the same tokens; temperature 0 gives
    [serve]'s greedy tokens; a CPU generator is refused; 2·10^4 Gumbel-max
    draws from one logits row within 0.02 total variation of
    softmax(logits / T) over 10 bins of equal probability mass."""
    import numpy as np
    import torch
    from repro_torch.models import model as tmodel
    t_phase = time.perf_counter()
    eng = serve_engine(dev, cfg, params, temperature=SAMPLE_T)

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    two, budget = prompts[:2], 16
    runs = [eng.serve(two, budget, max_batch=4, generator=gen(0))
            for _ in range(2)]
    greedy = serve_engine(dev, cfg, params).serve(two, budget, max_batch=4)
    want = [o[:budget] for o in mono_outs[:2]]
    try:
        eng.serve(two, budget, max_batch=4, generator=torch.Generator())
        refused = False
    except ValueError:
        refused = True
    _, logits = eng.prefill(np.asarray([prompts[0]]))
    probs = torch.softmax(logits[0].double() / SAMPLE_T, -1).cpu()
    order = torch.argsort(probs, descending=True)
    mid = torch.cumsum(probs[order], 0) - probs[order] / 2
    bin_of = torch.empty_like(order)
    bin_of[order] = torch.clamp(mid * 10, max=9).long()
    counts = torch.zeros(10, dtype=torch.double)
    g = gen(1)
    for _ in range(SAMPLE_DRAWS // 1000):
        draws = tmodel.sample(logits.expand(1000, -1), SAMPLE_T, g)
        counts += torch.bincount(bin_of[draws.cpu()], minlength=10)
    want_mass = torch.zeros(10, dtype=torch.double).index_add_(0, bin_of,
                                                               probs)
    tv = 0.5 * (counts / SAMPLE_DRAWS - want_mass).abs().sum().item()
    step = logits.expand(4, -1).contiguous()
    ms = time_ms(lambda i: tmodel.sample(step, SAMPLE_T, g), 1, iters=50)
    ms_argmax = time_ms(lambda i: tmodel.sample(step), 1, iters=50)
    log(f"[sample] T={SAMPLE_T}, CUDA generator: same seed twice same "
        f"tokens: {runs[0] == runs[1]}; T=0 equal to [serve]'s greedy "
        f"tokens: {greedy == want}; sampled vs greedy tokens differ: "
        f"{runs[0] != greedy}; CPU generator refused: {refused}; "
        f"{SAMPLE_DRAWS} draws from one logits row (vocab "
        f"{logits.shape[-1]}): total variation {tv:.4f} over 10 equal-mass "
        f"bins (tol 0.02), top token p = {probs.max().item():.2e}; one "
        f"decode step's sampling of 4 rows {ms:.4f} ms, argmax "
        f"{ms_argmax:.4f} ms; {time.perf_counter() - t_phase:.1f} s")
    if not (runs[0] == runs[1] and greedy == want and refused
            and tv <= 0.02):
        raise AssertionError(f"[sample]: runs {runs}, greedy {greedy} vs "
                             f"{want}, refused {refused}, tv {tv}")


# [telemetry]: the JAX package's overload trace
# (benchmarks/serving_throughput.py `_overload_trace`, quick mode: a 4-row
# pool, 4-token decode chunks, 12 priority-2 requests of 16 tokens,
# priority-0 arrivals at ticks 2, 4, 6, 8 with 4 tokens due 4 ticks later,
# two priority-1 requests due at tick 2 that need 4 chunks, a queue of
# 8 + 2) at c = 256: backlog prompts of 1, 2 + 8/c and 3 blocks (the 8
# tokens past 2 blocks run the remainder steps), urgent prompts of 8 tokens
TEL_POOL = 4
TEL_DCHUNK = 4
TEL_LOW = 12
TEL_LOW_BUDGET = 16
TEL_HI_ARRIVALS = (2, 4, 6, 8)
TEL_HI_BUDGET = 4
TEL_HI_MARGIN = 4
TEL_INFEASIBLE = 2
TEL_MAX_QUEUE = 8 + TEL_INFEASIBLE
TEL_SNAPSHOT_CHUNKS = 2
TEL_MAX_SEQ = 1024
TEL_SPANS = ("decode_chunk", "prefill_chunk_forward",
             "prefill_remainder_forward", "snapshot_capture")


def overload_trace(cfg):
    """(prompts, budgets, serve() keywords) of the [telemetry] trace."""
    import numpy as np
    c = cfg.attention.linformer.block_size
    rng = np.random.default_rng(0)

    def prompt(n):
        return list(map(int, rng.integers(4, cfg.vocab_size, n)))

    prompts, budgets, arrivals, prios, deadlines = [], [], [], [], []
    for _ in range(TEL_LOW):
        prompts.append(prompt(int(rng.choice([c, 2 * c + 8, 3 * c]))))
        budgets.append(TEL_LOW_BUDGET)
        arrivals.append(0)
        prios.append(2)
        deadlines.append(None)
    for a in TEL_HI_ARRIVALS:
        prompts.append(prompt(8))
        budgets.append(TEL_HI_BUDGET)
        arrivals.append(a)
        prios.append(0)
        deadlines.append(a + TEL_HI_MARGIN)
    for _ in range(TEL_INFEASIBLE):
        prompts.append(prompt(8))
        budgets.append(TEL_LOW_BUDGET)
        arrivals.append(1)
        prios.append(1)
        deadlines.append(2)
    return prompts, budgets, dict(
        max_batch=TEL_POOL, arrival_chunks=arrivals, priorities=prios,
        deadlines=deadlines, max_queue=TEL_MAX_QUEUE,
        snapshot_chunks=TEL_SNAPSHOT_CHUNKS)


def telemetry_serve(eng, prompts, budgets, kw, tel=None):
    """One counted serve of the overload trace: (outputs, scheduler,
    launches, wall seconds)."""
    import torch
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    outs, sched = eng.serve(prompts, budgets, return_scheduler=True,
                            telemetry=tel, **kw)
    torch.cuda.synchronize()
    return outs, sched, read_launches(), time.perf_counter() - t0


def span_shares(tel):
    """{span name: (count, ms)} of the scheduler spans inside the one
    `serve` span, the rest under "rest", and the serve span's ms."""
    events = [e for e in tel.tracer.chrome_events() if e["ph"] == "X"]
    serve = [e for e in events if e["name"] == "serve"]
    if len(serve) != 1:
        raise AssertionError(f"[telemetry] {len(serve)} serve spans")
    out = {name: [0, 0.0] for name in TEL_SPANS}
    for e in events:
        if e["name"] in out:
            out[e["name"]][0] += 1
            out[e["name"]][1] += e["dur"] / 1e3
    total = serve[0]["dur"] / 1e3
    out["rest"] = [0, total - sum(ms for _, ms in out.values())]
    return out, total


def slo_percentiles(tel):
    """{(metric, priority): (count, p50, p99)} of the run's TTFT (ms and
    ticks) and TPOT (ms) histograms."""
    out = {}
    for r in tel.metrics_records():
        if r.get("metric") in ("serving_ttft_ms", "serving_ttft_ticks",
                               "serving_tpot_ms") and r["count"]:
            out[(r["metric"], r["labels"]["priority"])] = (
                r["count"], r["p50"], r["p99"])
    return out


def sync_spans(eng, prompts, budgets, kw):
    """{span name: (spans, spans holding a synchronizing call)}: one more
    traced serve under torch.cuda.set_sync_debug_mode("warn"), which warns
    at each call that waits for the device; each span counts the warnings
    raised between its entry and its exit. A span without one times the
    host's dispatch only."""
    import warnings
    import torch
    from repro_torch.telemetry import Telemetry
    from repro_torch.telemetry import trace as ttrace
    caught, stack, out = [], [], {}
    enter, leave = ttrace._Span.__enter__, ttrace._Span.__exit__
    root = os.path.dirname(os.path.abspath(__file__))

    def span_enter(span):
        stack.append(len(caught))
        return enter(span)

    def span_exit(span, *exc):
        n = out.setdefault(span._name, [0, 0, collections.Counter()])
        start = stack.pop()
        n[0] += 1
        n[1] += len(caught) > start
        for w in caught[start:]:
            n[2][f"{os.path.relpath(w.filename, root)}:{w.lineno}"] += 1
        return leave(span, *exc)

    ttrace._Span.__enter__, ttrace._Span.__exit__ = span_enter, span_exit
    try:
        with warnings.catch_warnings(record=True) as caught_list:
            warnings.simplefilter("always")
            caught = caught_list
            torch.cuda.set_sync_debug_mode("warn")
            try:
                eng.serve(prompts, budgets, telemetry=Telemetry(), **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
    finally:
        ttrace._Span.__enter__, ttrace._Span.__exit__ = enter, leave
    return {k: (n, w, dict(where)) for k, (n, w, where) in out.items()}


def instrumentation_us():
    """Host microseconds of one span (entry and exit, two args) and of one
    timeline stamp (two fields, its instant event included) on a fresh
    `Telemetry`, over 20000 of each: the instrumentation's own cost, which
    a serve's wall is too noisy to show."""
    from repro_torch.telemetry import Telemetry
    n = 20000
    tel = Telemetry(trace_capacity=4 * n)
    tl = tel.new_timelines("probe")
    t0 = time.perf_counter()
    for i in range(n):
        with tel.span("probe", cat="scheduler", rows=4, tick=i):
            pass
    t1 = time.perf_counter()
    for i in range(n):
        tl.stamp(i, "prefill_chunk", i, filled=i, total=n)
    t2 = time.perf_counter()
    return (t1 - t0) / n * 1e6, (t2 - t1) / n * 1e6


def telemetry_phase(dev, cfg, params):
    """[telemetry]: see the module docstring, item 28."""
    import tempfile
    import torch
    from repro_torch.serving import ServingEngine, ShedResult
    from repro_torch.telemetry import Telemetry
    t_phase = time.perf_counter()
    prompts, budgets, kw = overload_trace(cfg)
    eng = ServingEngine(params, cfg, max_seq=TEL_MAX_SEQ, device=dev,
                        cache_dtype=torch.bfloat16, decode_chunk=TEL_DCHUNK,
                        prefill_chunk=SERVE_PREFILL_CHUNK,
                        cache_format="paged", page_dtype=SERVE_PAGE_DTYPE)
    warm = telemetry_serve(eng, prompts, budgets, kw)
    # on and off in turns (on, off, off, on, on, off) after the warm-up;
    # the first traced run is the one exported
    tel = Telemetry()
    on = telemetry_serve(eng, prompts, budgets, kw, tel)
    off = telemetry_serve(eng, prompts, budgets, kw)
    walls = {"on": [on[3]], "off": [off[3]]}
    for turn in ("off", "on", "on", "off"):
        walls[turn].append(telemetry_serve(
            eng, prompts, budgets, kw,
            Telemetry() if turn == "on" else None)[3])
    outs, sched, launches, _ = on
    st = sched.stats
    log(f"[telemetry] {card_line()}; {cfg.name} at {cfg.num_layers} "
        f"layers, paged {SERVE_PAGE_DTYPE}, prefill_chunk "
        f"{SERVE_PREFILL_CHUNK}, {len(prompts)} requests (prompt lengths "
        f"{sorted(set(len(p) for p in prompts))}), pool {TEL_POOL}, "
        f"decode_chunk {TEL_DCHUNK}, max_queue {TEL_MAX_QUEUE}, snapshots "
        f"every {TEL_SNAPSHOT_CHUNKS} chunks: {st.counters_line()}; chunks "
        f"{st.chunks}, idle ticks {st.idle_ticks}, snapshots "
        f"{st.snapshots}; launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    log(f"  serve wall (in turns on, off, off, on, on, off): telemetry off "
        f"{', '.join(f'{w:.3f}' for w in walls['off'])} s, on "
        f"{', '.join(f'{w:.3f}' for w in walls['on'])} s; on / off "
        f"{sum(walls['on']) / sum(walls['off']):.4f}; warm-up, off, "
        f"{warm[3]:.3f} s")
    per_span, per_stamp = instrumentation_us()
    n_spans = sum(e["ph"] == "X" for e in tel.tracer.chrome_events())
    n_stamps = len(tel.tracer.events()) - n_spans
    log(f"  the instrumentation alone: {per_span:.2f} us a span, "
        f"{per_stamp:.2f} us a stamp on this host; this serve's {n_spans} "
        f"spans and {n_stamps} stamps: "
        f"{(n_spans * per_span + n_stamps * per_stamp) / 1e3:.3f} ms")

    # telemetry changes nothing the serve decides or launches
    for tag, (o, s, n, _) in (("warm-up", warm), ("off", off)):
        if o != outs or s.stats.counter_records() != st.counter_records() \
                or n != launches or s.completed_at != sched.completed_at:
            raise AssertionError(f"[telemetry] telemetry on and {tag} "
                                 f"differ: {o} / {outs}, launches {n} / "
                                 f"{launches}")
    require_launches(launches, ("blockwise_causal_prefix_attn_q",
                                "decode_attn_q"), "telemetry")
    # every leg of the trace happened, and no request ended on EOS
    sheds = [o.reason for o in outs if isinstance(o, ShedResult)]
    hi = range(TEL_LOW, TEL_LOW + len(TEL_HI_ARRIVALS))
    for o, b in zip(outs, budgets):
        if not isinstance(o, ShedResult) and len(o) != b:
            raise AssertionError(f"[telemetry] a request ended early: {o}")
    if sheds.count("deadline_infeasible") != TEL_INFEASIBLE \
            or "queue_full" not in sheds or st.preemptions < 1 \
            or any(isinstance(outs[i], ShedResult) for i in hi) \
            or any(sched.completed_at[i] > kw["deadlines"][i] for i in hi):
        raise AssertionError(f"[telemetry] a leg is missing: sheds "
                             f"{sheds}, preemptions {st.preemptions}, "
                             f"completion ticks {sched.completed_at}")

    shares, total = span_shares(tel)
    rest = shares.pop("rest")[1]
    log(f"  serve span {total:.1f} ms: " + ", ".join(
        f"{name} {n}x {ms:.1f} ms ({100 * ms / total:.1f}%)"
        for name, (n, ms) in shares.items())
        + f", the rest {rest:.1f} ms ({100 * rest / total:.1f}%)")
    waited = sync_spans(eng, prompts, budgets, kw)
    log("  spans that wait for the device (a synchronizing call inside, "
        "torch.cuda.set_sync_debug_mode):")
    for name, (n, w, where) in sorted(waited.items()):
        log(f"    {name}: {w} of {n}" + ("" if name == "serve" else
                                         f"; calls {where}"))
    for (metric, pri), (n, p50, p99) in sorted(slo_percentiles(tel).items()):
        log(f"  {metric} priority {pri}: {n} requests, p50 {p50:.2f}, p99 "
            f"{p99:.2f}")
    with tempfile.TemporaryDirectory() as d:
        trace = tel.export_trace(os.path.join(d, "trace.json"),
                                 metadata={"arch": cfg.name})
        metrics = tel.export_metrics_jsonl(os.path.join(d, "metrics.jsonl"))
        res = subprocess.run(
            [sys.executable, os.path.join(os.path.dirname(os.path.abspath(
                __file__)), "scripts", "check_trace.py"), trace, metrics],
            capture_output=True, text=True, timeout=120)
        with open(trace) as fh:
            dropped = json.load(fh)["metadata"]["dropped_events"]
        sizes = (os.path.getsize(trace), os.path.getsize(metrics))
    log(f"  scripts/check_trace.py: rc {res.returncode}: "
        f"{res.stdout.strip()} {res.stderr.strip()}; dropped events "
        f"{dropped}; trace {sizes[0]} B, metrics {sizes[1]} B, "
        f"{len(tel.tracer.events())} events")
    if res.returncode != 0 or dropped != 0 or tel.tracer.dropped != 0:
        raise AssertionError("[telemetry] the export failed its check")
    del eng, sched, warm, on, off
    log(f"  [telemetry] {time.perf_counter() - t_phase:.1f} s")


def bf16_step(x):
    """The spacing of bf16 at each |x| (one step of its 8-bit mantissa),
    0 at x = 0: never more than 2^-7·|x|."""
    import torch
    x = x.float()
    step = torch.ldexp(torch.ones_like(x), torch.frexp(x).exponent - 8)
    return torch.where(x == 0, torch.zeros_like(x), step)


def check_grad_steps(name, out, ref):
    """A bf16 gradient against its plain twin, both fp32 sums rounded once
    to bf16: at most one bf16 step of the twin's value apart, plus
    GRAD_TOL·max(1, max|twin|) for the fp32 sums' order (check_grad's
    bound with the exact step in place of its 2^-7·|twin| upper bound).
    Logs the largest distance in steps where a step exceeds that slack.
    Returns the max absolute error."""
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    slack = GRAD_TOL * max(1.0, ref.float().abs().max().item())
    step = bf16_step(ref)
    worst = (diff / (step + slack)).max().item()
    big = step > slack
    steps = int((diff[big] / step[big]).round().max().item()) \
        if bool(big.any()) else 0
    log(f"  {name}: max |kernel - plain| = {err:.3e}, {worst:.2f} of its "
        f"bound, {steps} bf16 step(s) apart at most where a step exceeds "
        f"{slack:.2e}")
    if not worst <= 1.0:
        raise AssertionError(f"{name}: error {err} beyond one bf16 step")
    return err


def card_line():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


# -- phases -----------------------------------------------------------------


def build_phase():
    from repro_torch.kernels import build
    kl = build.library()
    log(f"[build] {kl.path.name}: {kl.build_seconds:.1f} s "
        f"({len(build.sources())} nvcc processes in parallel)")
    for line in kl.log.splitlines():
        if "registers" in line or "Compiling entry" in line \
                or "spill" in line or line.startswith("=="):
            log(f"  {line.strip()}")


BCA_SHAPES = {"small": (2, 4, 2, 64, 16, 4, 16),
              "full": (1, 32, 8, 1024, 256, 16, 128)}
DEC_SHAPES = {"small": ((4, 2, 2, 16, 24, 4, 16), [0, 15, 16 + 7, 95]),
              "full": ((4, 8, 4, 256, 256, 16, 128),
                       [0, 255, 256 * 5 + 100, 256 * 15 + 255])}
# training kernels: (B, H, Hkv, S, c, r, Dh), per-row start blocks
TRAIN_SHAPES = {"small": ((2, 4, 2, 32, 16, 4, 16), None),
                "small-offset": ((2, 4, 2, 32, 16, 4, 16), [1, 3]),
                "full": ((2, 32, 8, 4096, 256, 16, 128), None)}
TRAIN_TIME_SHAPE = TRAIN_SHAPES["full"][0]      # the train step's shapes
# the training form's edges, kernels 1 and 1r (without start blocks) and
# kernel 2: (B, H, Hkv, S, c, r, Dh), per-row start blocks, edge. The
# tensor-core kernels' 64-row query tiles and 64-key tiles span 4 blocks at
# c = 16 (a ragged S of 96), 2 at c = 32, and blocks that do not divide them
# at c = 48 (a ragged S of 144); G = 1, 3, 6; Dh 16, 32, 64, 128.
# split_empty_dh128: S = 1024 cuts each slot tile's rows into two 512-row
# splits, and slot tiles 2 and 3 are first seen at rows 576 and 832, so
# their first split holds no row; shifted: q, k, v, the slots and dO one
# element into their buffers (no 16-byte loads)
TRAIN_EDGE_SHAPES = {
    "c16_dh16_g1": ((2, 2, 2, 96, 16, 4, 16), None, None),
    "c32_dh32_g3": ((2, 6, 2, 128, 32, 8, 32), None, None),
    "c48_dh64": ((2, 4, 2, 144, 48, 4, 64), None, None),
    "c64_dh64_g6": ((1, 12, 2, 192, 64, 8, 64), None, None),
    "split_empty_dh128": ((1, 4, 2, 1024, 64, 16, 128), None, None),
    "offset_c16_ragged": ((2, 4, 2, 96, 16, 4, 32), [0, 5], None),
    "offset_g6": ((1, 12, 2, 192, 64, 8, 64), [2], None),
    "shifted": ((2, 4, 2, 64, 16, 4, 64), None, "shifted"),
    "shifted_offset": ((2, 4, 2, 64, 16, 4, 64), [1, 2], "shifted"),
    # the dense configs' GQA groups at their c = 256, Dh = 128: G = 2
    # (internvl2-2b), 5 (qwen3-14b: one head a block, two stages), 8
    # (qwen1.5-110b); musicgen-large's G = 1 at Dh = 64; G = 5 also with a
    # start block
    "g2_c256_dh128": ((1, 4, 2, 1024, 256, 16, 128), None, None),
    "g5_c256_dh128": ((1, 10, 2, 1024, 256, 16, 128), None, None),
    "g8_c256_dh128": ((1, 16, 2, 1024, 256, 16, 128), None, None),
    "g1_c256_dh64": ((2, 4, 4, 1024, 256, 16, 64), None, None),
    "g5_c256_offset": ((1, 10, 2, 1024, 256, 16, 128), [3], None),
}
# prefix form: (B, H, Hkv, P, c, r, Dh), per-row start blocks, slot buffer
# M; full = the chunked serve's chunk forward (P = 512, M = (4096 + 512) /
# 256 · 16); small's last row is clamped at M ((9 + 2)·4 = 44 > 40)
PREFIX_SHAPES = {"small": ((3, 4, 2, 32, 16, 4, 16), [0, 5, 9], 40),
                 "full": ((4, 32, 8, 512, 256, 16, 128), [0, 3, 7, 14],
                          288)}
# the prefix form's edges, kernels 4 (both forms) and 8: (B, H, Hkv, P, c,
# r, Dh), start blocks, M, edge. The tensor-core kernel's 64-row query tile
# spans 4 blocks at c = 16 (a ragged last tile: 96 rows), 2 at c = 32, and
# blocks that do not divide it at c = 48; c = 64 is one block a tile.
# c16_dh16_g1: row 1's cut clamps at M ((9 + 5)·4 = 56 > 48); c32_dh32_g3:
# G = 3; c64_dh64_g6: G = 6, a partial slot tile; m0: no slots at all;
# last_start: a start block at M/r - 1; shifted: every operand (q, k, v,
# slots, scales) one element into its buffer (no 16-byte loads)
PREFIX_EDGE_SHAPES = {
    "c16_dh16_g1": ((2, 2, 2, 96, 16, 4, 16), [0, 9], 48, None),
    "c32_dh32_g3": ((2, 6, 2, 128, 32, 8, 32), [2, 7], 120, None),
    "c48_dh64": ((2, 4, 2, 144, 48, 4, 64), [1, 6], 64, None),
    "c64_dh64_g6": ((1, 12, 2, 192, 64, 8, 64), [4], 200, None),
    "m0": ((2, 4, 2, 64, 16, 4, 32), [0, 3], 0, None),
    "last_start": ((2, 4, 2, 64, 32, 8, 64), [7, 0], 64, None),
    "shifted": ((2, 4, 2, 64, 16, 4, 64), [1, 2], 24, "shifted"),
    # the dense configs' G = 2, 5 (one head a block), 8 at the chunked
    # serve's c = 256, Dh = 128, P = 512, M = 288; g5's row 1 ends at slot
    # (16 + 2)·16 = 288 = M
    "g2_c256_dh128": ((2, 4, 2, 512, 256, 16, 128), [0, 5], 288, None),
    "g5_c256_dh128": ((2, 10, 2, 512, 256, 16, 128), [3, 16], 288, None),
    "g8_c256_dh128": ((2, 16, 2, 512, 256, 16, 128), [1, 9], 288, None),
}
# quantized decode: (B, Hkv, G, c, M, r, Dh), rows' positions
DEC_Q_SHAPES = {"small": ((4, 2, 2, 16, 24, 4, 16), [0, 15, 23, 95]),
                "full": ((4, 8, 4, 256, 288, 16, 128),
                         [300, 1000, 2300, 4000])}
# the decode kernels' edges, dense and quantized: (B, Hkv, G, c, M, r, Dh),
# rows' positions, edge. b1_split_empty: a B = 1 remainder step at t = 10,
# so 7 of the 8 key splits see no visible key and their tiles are skipped;
# ragged_dh64: c + M = 300 (4 whole tiles and 44 keys); masked_row_dh16:
# row 1 masks every key (the plain version's uniform average); shifted:
# ring and slots one element into their buffers (no 16-byte loads), G = 3;
# g6: G = 6, two blocks of query rows a kv head
DEC_EDGE_SHAPES = {
    "b1_split_empty": ((1, 8, 4, 256, 256, 16, 128), [10], None),
    "ragged_dh64": ((2, 2, 4, 100, 200, 4, 64), [150, 2410], None),
    "masked_row_dh16": ((4, 2, 2, 16, 24, 4, 16), [0, 15, 23, 95],
                        "masked_row"),
    "shifted": ((2, 2, 3, 64, 70, 8, 64), [70, 300], "shifted"),
    "g6": ((1, 2, 6, 64, 64, 8, 32), [100], None),
    # the dense configs at c = 256, M = 256: G = 2 (a half-filled block of
    # four query rows), G = 5 (a block of four and a block of one), G = 8
    # at Dh = 128; musicgen-large's G = 1 at Dh = 64
    "g2_c256_dh128": ((2, 2, 2, 256, 256, 16, 128), [300, 3000], None),
    "g5_c256_dh128": ((2, 2, 5, 256, 256, 16, 128), [700, 4000], None),
    "g8_c256_dh128": ((2, 2, 8, 256, 256, 16, 128), [255, 2048], None),
    "g1_c256_dh64": ((2, 4, 1, 256, 256, 16, 64), [10, 3900], None),
}
# [train]: depth cut, seq, global batch, steps; [train-parity]: seq
TRAIN_RUN = dict(layers=8, seq=4096, batch=2, steps=4)
TRAIN_PARITY_SEQ = 1024
# the exact form. Kernel 5: (B, H, Hkv, S, K, Dh); K = 1, K = 512 at
# Dh = 128 (the most shared memory), a ragged S with GQA G = 2, the
# paper's full width, K = 130 (2 slots past one 128-slot tile of the bf16
# kernel), Dh = 32 at K = 128, q one element into its buffer (SHIFTED).
# Kernel 6: (B, H, S, K, Dh, rows of the stored E), E[:S] passed; K = 1, a
# sliced E with K past one slot tile, K = 512, the full width and its
# E[:S] at S < max_seq, K = 130, K = 512 at Dh = 128, x or E one element
# into its buffer, a long S = 1100 (18 chunks, the last ragged).
EXACT_SHAPES = {"k1": (1, 2, 2, 40, 1, 16),
                "k512_dh128": (1, 4, 4, 100, 512, 128),
                "ragged_gqa2": (2, 4, 2, 77, 40, 64),
                "full": (32, 12, 12, 512, 128, 64),
                "k130": (2, 4, 2, 100, 130, 64),
                "dh32_k128": (2, 4, 4, 128, 128, 32),
                "misaligned_q": (2, 4, 2, 77, 128, 64)}
SP_SHAPES = {"k1": (2, 4, 40, 1, 16, 40),
             "sliced_k70": (2, 2, 77, 70, 128, 100),
             "k512": (1, 2, 64, 512, 64, 64),
             "full": (32, 12, 512, 128, 64, 512),
             "full_sliced": (32, 12, 384, 128, 64, 512),
             "k130": (2, 4, 100, 130, 64, 128),
             "k512_dh128": (1, 2, 130, 512, 128, 160),
             "misaligned_x": (2, 4, 77, 128, 64, 100),
             "misaligned_E": (2, 4, 77, 128, 64, 100),
             "s1100": (2, 4, 1100, 130, 64, 1200)}
# the operand a shape moves one element into a larger buffer (its base is
# then not 16-byte aligned)
SHIFTED = {"misaligned_q": "q", "misaligned_x": "x", "misaligned_E": "E"}
# [train-mlm]: linformer-paper at full width and depth; [train-mlm-parity]:
# its 2-layer fp32 cut
MLM_RUN = dict(seq=512, batch=32, steps=8)
MLM_PARITY = dict(layers=2, seq=512, batch=2)
# [train-mlm-nonuniform]: linformer-paper unrolled (scan_layers=False) with
# per-layer E and F (headwise) and k_decay 0.5: layer i projects to
# effective_k(128, 0.5, i, 12) slots, 128 down to 64; [check] holds kernels
# 5 and 6 at each of those K at the paper's full width (B=32, H=12, S=512,
# Dh=64)
NONUNIFORM = dict(sharing="headwise", k_decay=0.5)


def check_phase(dev):
    import torch
    from repro_torch.kernels import blockwise_causal_attn as bca
    log("[check] kernels vs plain versions")
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for size, (B, H, Hkv, S, c, r, Dh) in BCA_SHAPES.items():
            args = bca_inputs(B, H, Hkv, S, c, r, Dh, dtype, dev, seed=1)
            kw = dict(block_size=c, block_slots=r, scale=Dh ** -0.5)
            out = bca.blockwise_causal_attn(*args, **kw)
            torch.cuda.synchronize()
            errs["bca", size, dtype] = check(
                f"blockwise_causal_attn {size}", out,
                bca.blockwise_causal_attn_plain(*args, **kw), dtype,
                (args[2], args[4]))
            if not torch.equal(bca.blockwise_causal_attn(*args, **kw), out):
                raise AssertionError(f"blockwise_causal_attn {size}: two "
                                     "launches differ")
        errs.update(check_decode_kernels(dtype, dev))
        for size, (shape, start) in TRAIN_SHAPES.items():
            errs.update(check_training_kernels(size, shape, start, dtype,
                                               dev))
        for size, (shape, start, edge) in TRAIN_EDGE_SHAPES.items():
            errs.update(check_training_kernels(size, shape, start, dtype,
                                               dev, edge))
        for size, (shape, start, M) in PREFIX_SHAPES.items():
            errs.update(check_prefix_kernels(size, shape, start, M, dtype,
                                             dev))
        for size, (shape, start, M, edge) in PREFIX_EDGE_SHAPES.items():
            errs.update(check_prefix_kernels(size, shape, start, M, dtype,
                                             dev, edge))
        errs.update(check_exact_kernels(dtype, dev))
    check_backward_graph(dev)
    return errs


def check_decode_kernels(dtype, dev):
    """Kernel 3 (dense cache) and kernel 7 (int8 and fp8 codes) against
    their plain twins at DEC_SHAPES / DEC_Q_SHAPES and every edge of
    DEC_EDGE_SHAPES (a second launch must agree bit for bit: the key splits
    are merged in a fixed order, without atomics)."""
    import torch
    from repro_torch.core.cache import dequantize_blockwise
    from repro_torch.kernels import linformer_attn as la
    errs = {}
    cases = [("dec", size, shape, t, None)
             for size, (shape, t) in DEC_SHAPES.items()]
    cases += [("dec", size, shape, t, edge)
              for size, (shape, t, edge) in DEC_EDGE_SHAPES.items()]
    for pd in ("int8", "fp8"):
        cases += [(("dec_q", pd), size, shape, t, None)
                  for size, (shape, t) in DEC_Q_SHAPES.items()]
        cases += [(("dec_q", pd), size, shape, t, edge)
                  for size, (shape, t, edge) in DEC_EDGE_SHAPES.items()]
    for kind, size, (B, Hkv, G, c, M, r, Dh), t, edge in cases:
        sc = Dh ** -0.5
        if kind == "dec":
            args = decode_inputs(B, Hkv, G, c, M, r, Dh, dtype, dev, 2, t,
                                 edge)
            fn, plain, name = la.decode_attn, la.decode_attn_plain, \
                f"decode_attn {size}"
            values = (args[2], args[4])
            key = ("dec", size, dtype)
        else:
            pd = kind[1]
            args = decode_q_inputs(B, Hkv, G, c, M, r, Dh, dtype, pd, dev, 8,
                                   t, edge)
            fn, plain, name = la.decode_attn_q, la.decode_attn_q_plain, \
                f"decode_attn_q {pd} {size}"
            values = [dequantize_blockwise(args[i], args[i + 4])
                      for i in (2, 4)]
            key = ("dec_q", size, pd, dtype)
        out = fn(*args, scale=sc)
        torch.cuda.synchronize()
        errs[key] = check(name, out, plain(*args, scale=sc), dtype, values)
        if not torch.equal(fn(*args, scale=sc), out):
            raise AssertionError(f"{name}: two launches differ")
    return errs


def shifted(t):
    """t's values in a contiguous view starting one element into a larger
    buffer."""
    import torch
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def exact_inputs(B, H, Hkv, S, K, Dh, dtype, dev, seed, shift=None):
    """Kernel 5's operands as the model passes them: kernel-layout views of
    q (B, S, H, Dh) and k̄, v̄ (B, K, Hkv, Dh); shift "q" moves q."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, S, H, Dh, generator=g, device=dev).to(dtype)
    kb, vb = (torch.randn(B, K, Hkv, Dh, generator=g, device=dev).to(dtype)
              for _ in range(2))
    if shift == "q":
        q = shifted(q)
    return q.movedim(2, 1), kb.movedim(2, 1), vb.movedim(2, 1)


def sp_inputs(B, H, S, K, Dh, rows, dtype, dev, seed, shift=None):
    """Kernel 6's operands: a kernel-layout view of x (B, S, H, Dh) and the
    leading-row view E[:S] of a (rows, K) E; shift "x" or "E" moves it."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(B, S, H, Dh, generator=g, device=dev).to(dtype)
    E = (torch.randn(rows, K, generator=g, device=dev) * K ** -0.5).to(dtype)
    if shift == "x":
        x = shifted(x)
    if shift == "E":
        E = shifted(E)
    return x.movedim(2, 1), E[:S]


def check_exact_kernels(dtype, dev):
    """Kernel 5 (the attention bounds of `check`) and kernel 6 (fp32 sums of
    the same inputs, one rounding to the output dtype: the bounds of
    `check_grad`) against their plain twins; kernel 6 run twice must agree
    bit for bit (no atomics)."""
    import torch
    from repro_torch.kernels import linformer_attn as la
    from repro_torch.kernels import seq_projection as sp
    errs = {}
    for size, (B, H, Hkv, S, K, Dh) in EXACT_SHAPES.items():
        args = exact_inputs(B, H, Hkv, S, K, Dh, dtype, dev, seed=70,
                            shift=SHIFTED.get(size))
        out = la.linformer_attn(*args, scale=Dh ** -0.5)
        torch.cuda.synchronize()
        errs["exact", size, dtype] = check(
            f"linformer_attn {size}", out,
            la.linformer_attn_plain(*args, scale=Dh ** -0.5), dtype,
            (args[2],))
    for size, shape in SP_SHAPES.items():
        x, E = sp_inputs(*shape, dtype, dev, seed=71,
                         shift=SHIFTED.get(size))
        out = sp.seq_projection(x, E)
        torch.cuda.synchronize()
        errs["sp", size, dtype] = check_grad(
            f"seq_projection {size} {str(dtype)[6:]}", out,
            sp.seq_projection_plain(x, E))
        if not torch.equal(sp.seq_projection(x, E), out):
            raise AssertionError("seq_projection is not deterministic")
    B, H, _, S, K0, Dh = EXACT_SHAPES["full"]
    for K in nonuniform_ks(K0, 12):
        args = exact_inputs(B, H, H, S, K, Dh, dtype, dev, seed=72 + K)
        out = la.linformer_attn(*args, scale=Dh ** -0.5)
        torch.cuda.synchronize()
        errs["exact", f"nonuniform_k{K}", dtype] = check(
            f"linformer_attn nonuniform K={K}", out,
            la.linformer_attn_plain(*args, scale=Dh ** -0.5), dtype,
            (args[2],))
        x, E = sp_inputs(B, H, S, K, Dh, S, dtype, dev, seed=73 + K)
        out = sp.seq_projection(x, E)
        torch.cuda.synchronize()
        errs["sp", f"nonuniform_k{K}", dtype] = check_grad(
            f"seq_projection nonuniform K={K} {str(dtype)[6:]}", out,
            sp.seq_projection_plain(x, E))
    # [table3]'s shapes: every n of its grid at each k, B = 16384 / n
    for n in TABLE3["ns"] + TABLE3["long_ns"]:
        B = max(1, TABLE3["tokens"] // n)
        for K in TABLE3["ks"]:
            args = exact_inputs(B, H, H, n, K, Dh, dtype, dev, seed=n + K)
            out = la.linformer_attn(*args, scale=Dh ** -0.5)
            torch.cuda.synchronize()
            errs["exact", f"table3_n{n}_k{K}", dtype] = check(
                f"linformer_attn table3 B={B} n={n} K={K}", out,
                la.linformer_attn_plain(*args, scale=Dh ** -0.5), dtype,
                (args[2],))
            del args, out
            x, E = sp_inputs(B, H, n, K, Dh, n, dtype, dev, seed=n + K + 1)
            out = sp.seq_projection(x, E)
            torch.cuda.synchronize()
            errs["sp", f"table3_n{n}_k{K}", dtype] = check_grad(
                f"seq_projection table3 B={B} n={n} K={K} "
                f"{str(dtype)[6:]}", out, sp.seq_projection_plain(x, E))
            del x, E, out
            torch.cuda.empty_cache()
    return errs


def nonuniform_ks(k, layers):
    """The per-layer K of the nonuniform path (core/projections
    effective_k at NONUNIFORM's k_decay)."""
    from repro_torch.core.projections import effective_k
    return [effective_k(k, NONUNIFORM["k_decay"], i, layers)
            for i in range(layers)]


def check_prefix_kernels(size, shape, start, M, dtype, dev, edge=None):
    """Kernel 4 in both forms (out; out, m, denom) against the prefix form
    of the forward's plain twin, and kernel 8 over int8 and fp8 slots
    against its plain twin on the same codes and scales; each launched
    twice, bit-identical. `edge` "shifted" moves every operand one element
    into its buffer (see PREFIX_EDGE_SHAPES)."""
    import torch
    from repro_torch.core.cache import dequantize_blockwise
    from repro_torch.kernels import blockwise_causal_attn as bca
    B, H, Hkv, P, c, r, Dh = shape
    q, k, v, ck, cv, sb = prefix_inputs(shape, start, M, dtype, dev, seed=6)
    move = shifted if edge == "shifted" else (lambda x: x)
    q, k, v = move(q), move(k), move(v)
    kw = dict(block_size=c, block_slots=r, scale=Dh ** -0.5)
    tag = f"{size} {str(dtype)[6:]}"
    errs = {}
    ckd, cvd = move(ck.to(dtype)), move(cv.to(dtype))
    out = bca.blockwise_causal_prefix_attn(q, k, v, ckd, cvd, sb, **kw)
    out_r, m, d = bca.blockwise_causal_prefix_attn(
        q, k, v, ckd, cvd, sb, return_residuals=True, **kw)
    torch.cuda.synchronize()
    ro, rm, rd = bca.blockwise_causal_attn_plain(
        q, k, v, ckd, cvd, start_blocks=sb, return_residuals=True, **kw)
    errs["pre", size, dtype] = check(
        f"blockwise_causal_prefix_attn {size}", out, ro, dtype, (v, cvd))
    errs["pre_res", size, dtype] = check(
        f"blockwise_causal_prefix_attn(residuals) {size}", out_r, ro, dtype,
        (v, cvd))
    check_grad(f"  m {tag}", m, rm)
    check_grad(f"  denom {tag}", d, rd)
    if not torch.equal(out, out_r):
        raise AssertionError("the prefix form's plain and residual forms "
                             "differ")
    again = bca.blockwise_causal_prefix_attn(
        q, k, v, ckd, cvd, sb, return_residuals=True, **kw)
    if not all(torch.equal(a, b) for a, b in zip(again, (out_r, m, d))):
        raise AssertionError(f"blockwise_causal_prefix_attn {tag}: two "
                             "launches differ")
    for pd in ("int8", "fp8"):
        (ckq, cks), (cvq, cvs) = quantized(ck, pd), quantized(cv, pd)
        args = (q, k, v, move(ckq), move(cvq), move(cks), move(cvs), sb)
        out = bca.blockwise_causal_prefix_attn_q(*args, **kw)
        torch.cuda.synchronize()
        errs["pre_q", size, pd, dtype] = check(
            f"blockwise_causal_prefix_attn_q {pd} {size}", out,
            bca.blockwise_causal_prefix_attn_q_plain(*args, **kw), dtype,
            (v, dequantize_blockwise(cvq, cvs)))
        if not torch.equal(bca.blockwise_causal_prefix_attn_q(*args, **kw),
                           out):
            raise AssertionError(f"blockwise_causal_prefix_attn_q {pd} "
                                 f"{tag}: two launches differ")
    return errs


def check_training_kernels(size, shape, start, dtype, dev, edge=None):
    """Kernels 1 and 1r (out; out, m, denom; without start blocks) and
    kernel 2 (dq, dk_loc, dv_loc, dk̄, dv̄) against their plain twins, each
    launched twice and bit-identical; dk̄/dv̄ of slots no row sees must be
    exact zeros; the route probes must name the tensor cores in bf16 and
    the SIMT kernels in fp32. `edge` "shifted" moves q, k, v, the slots
    and dO one element into their buffers (see TRAIN_EDGE_SHAPES)."""
    import torch
    from repro_torch.kernels import blockwise_causal_attn as bca
    B, H, Hkv, S, c, r, Dh = shape
    q, k, v, kb, vb = bca_inputs(B, H, Hkv, S, c, r, Dh, dtype, dev, seed=3)
    move = shifted if edge == "shifted" else (lambda x: x)
    kw = dict(block_size=c, block_slots=r, scale=Dh ** -0.5)
    errs, sb = {}, None
    tag = f"{size} {str(dtype)[6:]}"
    route = "tensor cores" if dtype == torch.bfloat16 else "simt"
    if start is None:
        q, k, v, kb, vb = map(move, (q, k, v, kb, vb))
        out_r, m, d = bca.blockwise_causal_attn(q, k, v, kb, vb,
                                                return_residuals=True, **kw)
        out = bca.blockwise_causal_attn(q, k, v, kb, vb, **kw)
        torch.cuda.synchronize()
        ro, rm, rd = bca.blockwise_causal_attn_plain(
            q, k, v, kb, vb, return_residuals=True, **kw)
        errs["res", size, dtype] = check(
            f"blockwise_causal_attn(residuals) {size}", out_r, ro, dtype,
            (v, vb))
        errs["bca_train", size, dtype] = check(
            f"blockwise_causal_attn {size}", out, ro, dtype, (v, vb))
        check_grad(f"  m {tag}", m, rm)
        check_grad(f"  denom {tag}", d, rd)
        if not torch.equal(out, out_r):
            raise AssertionError("the plain and residual forms differ")
        again = bca.blockwise_causal_attn(q, k, v, kb, vb,
                                          return_residuals=True, **kw)
        if not all(torch.equal(a, b) for a, b in zip(again, (out_r, m, d))):
            raise AssertionError(f"blockwise_causal_attn {tag}: two "
                                 "launches differ")
        if bca.last_forward_route() != route:
            raise AssertionError(f"blockwise_causal_attn {tag} ran the "
                                 f"{bca.last_forward_route()} route")
        m, d = rm, rd
        nb0 = torch.zeros(B, device=dev)
    else:
        # a full slot buffer: slots of earlier chunks, then this chunk's
        sb = torch.tensor(start, dtype=torch.int32, device=dev)
        g = torch.Generator(device=dev).manual_seed(4)
        kb, vb = (torch.cat([torch.randn(B, Hkv, max(start) * r, Dh,
                                         generator=g, device=dev).to(dtype),
                             x], 2) for x in (kb, vb))
        m, d = offset_residuals(q, k, kb, sb, kw)
        q, k, v, kb, vb = map(move, (q, k, v, kb, vb))
        nb0 = sb
    g = torch.Generator(device=dev).manual_seed(5)
    do = move(torch.randn(q.shape, generator=g, device=dev).to(dtype))
    got = bca.blockwise_causal_attn_bwd(q, k, v, kb, vb, m, d, do,
                                        start_blocks=sb, **kw)
    torch.cuda.synchronize()
    want = bca.blockwise_causal_attn_bwd_plain(q, k, v, kb, vb, m, d, do,
                                               start_blocks=sb, **kw)
    errs["bwd", size, dtype] = max(
        check_grad(f"blockwise_causal_attn_bwd {name} {tag}", g_, w)
        for name, g_, w in zip(("dq", "dk_loc", "dv_loc", "dkbar", "dvbar"),
                               got, want))
    again = bca.blockwise_causal_attn_bwd(q, k, v, kb, vb, m, d, do,
                                          start_blocks=sb, **kw)
    if not all(torch.equal(a, b) for a, b in zip(again, got)):
        raise AssertionError(f"blockwise_causal_attn_bwd {tag}: two "
                             "launches differ")
    if bca.last_backward_route() != route:
        raise AssertionError(f"blockwise_causal_attn_bwd {tag} ran the "
                             f"{bca.last_backward_route()} route")
    slot_blk = torch.arange(kb.shape[2], device=dev) // r
    invisible = slot_blk[None] >= (nb0[:, None] + S // c - 1)
    zeros = all(bool(torch.all(g_.movedim(1, 2)[invisible] == 0))
                for g_ in got[3:])
    log(f"  blockwise_causal_attn_bwd {tag}: {int(invisible.sum())} "
        f"invisible slot rows, exact zeros in dkbar/dvbar: {zeros}; two "
        f"launches bit-identical; route {route}")
    if not zeros:
        raise AssertionError("nonzero gradient on a slot no row sees")
    return errs


def check_backward_graph(dev):
    """Kernel 2 in bf16 at the train step's shapes captured into a CUDA
    graph (no host sync; its outputs and scratch from the caching
    allocator) and replayed equals the eager launch."""
    import torch
    from repro_torch.kernels import blockwise_causal_attn as bca
    B, H, Hkv, S, c, r, Dh = TRAIN_TIME_SHAPE
    args = bca_inputs(B, H, Hkv, S, c, r, Dh, torch.bfloat16, dev, seed=7)
    kw = dict(block_size=c, block_slots=r, scale=Dh ** -0.5)
    _, m, d = bca.blockwise_causal_attn(*args, return_residuals=True, **kw)
    g = torch.Generator(device=dev).manual_seed(8)
    do = torch.randn(args[0].shape, generator=g, device=dev).to(
        torch.bfloat16)
    eager = bca.blockwise_causal_attn_bwd(*args, m, d, do, **kw)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = bca.blockwise_causal_attn_bwd(*args, m, d, do, **kw)
    graph.replay()
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(out, eager))
    log(f"  blockwise_causal_attn_bwd B={B} S={S} bf16: CUDA-graph replay "
        f"equals the eager launch: {same}")
    if not same:
        raise AssertionError("kernel 2 replayed from a CUDA graph differs "
                             "from its eager launch")
    del graph, out, eager


def time_phase(dev, errs):
    import torch
    import torch.nn.functional as Fn
    from repro_torch.kernels import blockwise_causal_attn as bca
    log("[time] full width, bf16, L2-cold inputs; kernels and library calls "
        "by CUDA-graph replay, the kernels' eager loop beside")
    bf16 = torch.bfloat16
    records = []
    B, H, Hkv, S, c, r, Dh = BCA_SHAPES["full"]
    n_sets = 4                                    # 4 x ~22 MB > 50 MB L2
    sets = [bca_inputs(B, H, Hkv, S, c, r, Dh, bf16, dev, seed=10 + i)
            for i in range(n_sets)]
    kw = dict(block_size=c, block_slots=r, scale=Dh ** -0.5)
    run = lambda i: bca.blockwise_causal_attn(*sets[i], **kw)  # noqa: E731
    ms, eager_ms = time_graph_ms(run, n_sets), time_ms(run, n_sets)
    plain_ms = time_ms(
        lambda i: bca.blockwise_causal_attn_plain(*sets[i], **kw), n_sets)
    mask = joint_mask(S, c, r, dev)
    G = H // Hkv
    lib_sets = [(q, torch.cat([k, kb], 2).repeat_interleave(G, 1),
                 torch.cat([v, vb], 2).repeat_interleave(G, 1))
                for q, k, v, kb, vb in sets]
    lib_ms = time_graph_ms(lambda i: Fn.scaled_dot_product_attention(
        *lib_sets[i], attn_mask=mask, scale=Dh ** -0.5), n_sets)
    lib_err = (Fn.scaled_dot_product_attention(
        *lib_sets[0], attn_mask=mask, scale=Dh ** -0.5).float()
        - bca.blockwise_causal_attn(*sets[0], **kw).float()).abs().max()
    flops, nbytes = bca.blockwise_causal_attn_cost(
        B, H, Hkv, S, Dh, block_size=c, block_slots=r)
    records.append(dict(
        name="blockwise_causal_attn", route="cuda",
        source="src/repro_torch/csrc/blockwise_causal_attn.cu",
        replaces="src/repro/kernels/blockwise_causal_attn.py:301",
        ms=ms, eager_ms=eager_ms, plain_ms=plain_ms, library_ms=lib_ms,
        bytes=nbytes, flops=flops,
        max_abs_err=errs["bca", "full", bf16]))
    log(f"  blockwise_causal_attn B={B} H={H} Hkv={Hkv} S={S} c={c} r={r} "
        f"Dh={Dh}: kernel {ms:.4f} ms (eager loop {eager_ms:.4f}), plain "
        f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms (sdpa vs kernel "
        f"{lib_err.item():.2e})")
    del sets, lib_sets
    # kernel 3 at the monolithic serve's decode step (B = 4, rows of mixed
    # position and block), then at a B = 1 prompt-remainder step (logged)
    rec = time_decode(dev, errs, DEC_SHAPES["full"][0][0],
                      [300, 1000, 2300, 4000])
    records.append(rec)
    time_decode(dev, errs, 1, [1040])
    train_fwd, recs = time_training_kernels(dev, errs)
    records[0].update(train_fwd)      # kernel 1 at the train step's shapes
    records += recs
    records += time_prefix_kernels(dev, errs)
    records += time_decode_q(dev, errs)
    records += time_exact_kernels(dev, errs)
    for rec in records:
        set_bound(rec)
    return records


def bound_ms(flops, nbytes):
    """(ms, "bytes" or "operations"): the least time the card could take
    for `flops` bf16 operations moving `nbytes` bytes, at its datasheet
    rates (launch/mesh.H100_*)."""
    from repro_torch.launch.mesh import H100_FLOPS_BF16, H100_HBM_BYTES_PER_S
    t_bytes = nbytes / H100_HBM_BYTES_PER_S
    t_flops = flops / H100_FLOPS_BF16
    return (1e3 * max(t_bytes, t_flops),
            "bytes" if t_bytes >= t_flops else "operations")


def set_bound(rec):
    """Replace a bf16 record's `bytes` and `flops` by its bound: the larger
    of the bytes over the card's memory rate and the operations over its
    bf16 peak."""
    rec["bound_ms"], rec["bound_by"] = bound_ms(rec.pop("flops"),
                                                rec.pop("bytes"))
    log(f"  {rec['name']}: bound {rec['bound_ms']:.4f} ms "
        f"({rec['bound_by']}), kernel at "
        f"{100 * rec['bound_ms'] / rec['ms']:.1f}% of it")


def time_decode(dev, errs, B, t_rows):
    """Kernel 3 at the full width's Hkv, G, c, M, Dh and B rows at
    positions t_rows, bf16, beside one masked SDPA call over [ring | slots]
    (the kv heads repeated G times), both by CUDA-graph replay; the
    kernel's eager loop logged beside. Returns the kernel's record."""
    import torch
    import torch.nn.functional as Fn
    from repro_torch.kernels import common
    from repro_torch.kernels import linformer_attn as la
    bf16 = torch.bfloat16
    (_, Hkv, G, c, M, r, Dh), _ = DEC_SHAPES["full"]
    n_sets = 16 * 4 // B                          # > 50 MB of L2 at B = 1 too
    sets = [decode_inputs(B, Hkv, G, c, M, r, Dh, bf16, dev, 20 + i, t_rows)
            for i in range(n_sets)]
    run = lambda i: la.decode_attn(*sets[i], scale=Dh ** -0.5)  # noqa: E731
    ms = time_graph_ms(run, n_sets, iters=100)
    eager_ms = time_ms(run, n_sets, iters=100)
    plain_ms = time_ms(
        lambda i: la.decode_attn_plain(*sets[i], scale=Dh ** -0.5), n_sets,
        iters=100)
    lib_sets = []
    for q, rk, rv, ck, cv, bl, bg in sets:
        keys = torch.cat([rk, ck], 2).repeat_interleave(G, 1)
        vals = torch.cat([rv, cv], 2).repeat_interleave(G, 1)
        ok = (torch.cat([bl, bg], 1) == 0)[:, None, None, :]
        lib_sets.append((q.reshape(B, Hkv * G, 1, Dh), keys, vals, ok))
    lib_ms = time_graph_ms(lambda i: Fn.scaled_dot_product_attention(
        *lib_sets[i][:3], attn_mask=lib_sets[i][3], scale=Dh ** -0.5),
        n_sets, iters=100)
    flops, nbytes = la.decode_attn_cost(B, Hkv, G, Dh, c, M, block_slots=r,
                                        positions=t_rows)
    bound = bound_ms(flops, nbytes)[0]
    log(f"  decode_attn B={B} Hkv={Hkv} G={G} c={c} M={M} Dh={Dh} "
        f"t={t_rows}, {common.decode_splits(B * Hkv, G, c + M)[0]} key "
        f"splits: kernel {ms:.4f} ms (eager loop {eager_ms:.4f}), plain "
        f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms; bound {bound:.4f} ms")
    del sets, lib_sets
    return dict(name="decode_attn", route="cuda",
                source="src/repro_torch/csrc/decode_attn.cu",
                replaces="src/repro/kernels/linformer_attn.py:143",
                ms=ms, eager_ms=eager_ms, plain_ms=plain_ms,
                library_ms=lib_ms, bytes=nbytes, flops=flops,
                max_abs_err=errs["dec", "full", bf16])


def joint_mask(S, c, r, dev):
    """(S, S + M) boolean mask over [keys | slots]: own block causally,
    slots of earlier blocks."""
    import torch
    M = (S // c) * r
    rows = torch.arange(S)
    mask = torch.zeros(S, S + M, dtype=torch.bool)
    mask[:, :S] = ((rows[:, None] // c == rows[None, :] // c)
                   & (rows[None, :] <= rows[:, None]))
    mask[:, S:] = torch.arange(M)[None, :] // r < (rows // c)[:, None]
    return mask.to(dev)


def prefix_mask(P, c, r, M, start):
    """(B, 1, P, P + M) boolean mask over [chunk keys | slot buffer] of the
    prefix form: own block causally, slots of absolute blocks < start + n,
    clamped at M."""
    import torch
    rows = torch.arange(P, device=start.device)
    loc = ((rows[:, None] // c == rows[None, :] // c)
           & (rows[None, :] <= rows[:, None]))
    cut = (start.long()[:, None] + rows[None, :] // c) * r        # (B, P)
    glob = torch.arange(M, device=start.device)[None, None] < cut[..., None]
    return torch.cat([loc.expand(len(start), P, P), glob], -1)[:, None]


def time_prefix_kernels(dev, errs):
    """Kernels 4, 4r and 8 (int8 slots) at the chunked serve's chunk
    forward (B=4, P=512, M=288, start blocks 0, 3, 7, 14), bf16, beside
    one masked SDPA call (over the dequantised slots for kernel 8)."""
    import torch
    from repro_torch.core.cache import dequantize_blockwise
    import torch.nn.functional as Fn
    from repro_torch.kernels import blockwise_causal_attn as bca
    bf16 = torch.bfloat16
    shape, start, M = PREFIX_SHAPES["full"]
    B, H, Hkv, P, c, r, Dh = shape
    G = H // Hkv
    kw = dict(block_size=c, block_slots=r, scale=Dh ** -0.5)
    n_sets = 4                                    # 4 x ~30 MB > 50 MB L2
    sets, qsets = [], []
    for i in range(n_sets):
        q, k, v, ck, cv, sb = prefix_inputs(shape, start, M, bf16, dev,
                                            seed=50 + i)
        sets.append((q, k, v, ck.to(bf16), cv.to(bf16), sb))
        (ckq, cks), (cvq, cvs) = (quantized(x, SERVE_PAGE_DTYPE)
                                  for x in (ck, cv))
        qsets.append((q, k, v, ckq, cvq, cks, cvs, sb))
    mask = prefix_mask(P, c, r, M, sets[0][5])
    lib = [(q, torch.cat([k, ck], 2).repeat_interleave(G, 1),
            torch.cat([v, cv], 2).repeat_interleave(G, 1))
           for q, k, v, ck, cv, _ in sets]
    qlib = [(q, torch.cat([k, dequantize_blockwise(ckq, cks).to(bf16)],
                          2).repeat_interleave(G, 1),
             torch.cat([v, dequantize_blockwise(cvq, cvs).to(bf16)],
                       2).repeat_interleave(G, 1))
            for q, k, v, ckq, cvq, cks, cvs, _ in qsets]
    sdpa = lambda xs: Fn.scaled_dot_product_attention(  # noqa: E731
        *xs, attn_mask=mask, scale=Dh ** -0.5)
    t = {}
    for res in (False, True):
        run = lambda i: bca.blockwise_causal_prefix_attn(  # noqa: E731
            *sets[i], return_residuals=res, **kw)
        t["pre", res], t["pre_eager", res] = (time_graph_ms(run, n_sets),
                                              time_ms(run, n_sets))
        t["pre_plain", res] = time_ms(lambda i: bca.blockwise_causal_attn_plain(
            *sets[i][:5], start_blocks=sets[i][5], return_residuals=res,
            **kw), n_sets, iters=10)
    run = lambda i: bca.blockwise_causal_prefix_attn_q(  # noqa: E731
        *qsets[i], **kw)
    t["q"], t["q_eager"] = time_graph_ms(run, n_sets), time_ms(run, n_sets)
    t["q_plain"] = time_ms(lambda i: bca.blockwise_causal_prefix_attn_q_plain(
        *qsets[i], **kw), n_sets, iters=10)
    t["lib"] = time_graph_ms(lambda i: sdpa(lib[i]), n_sets)
    t["qlib"] = time_graph_ms(lambda i: sdpa(qlib[i]), n_sets)
    lib_err = (sdpa(lib[0]).float() - bca.blockwise_causal_prefix_attn(
        *sets[0], **kw).float()).abs().max().item()
    pkw = dict(block_size=c, block_slots=r, start_blocks=start)
    flops, pre_bytes = bca.blockwise_causal_prefix_attn_cost(
        B, H, Hkv, P, Dh, M, **pkw)
    res_bytes = bca.blockwise_causal_prefix_attn_cost(
        B, H, Hkv, P, Dh, M, return_residuals=True, **pkw)[1]
    q_bytes = bca.blockwise_causal_prefix_attn_cost(
        B, H, Hkv, P, Dh, M, slot_bytes=Dh * 1 + 4, **pkw)[1]
    log(f"  blockwise_causal_prefix_attn B={B} H={H} Hkv={Hkv} P={P} M={M} "
        f"start={start}: kernel {t['pre', False]:.4f} ms (eager loop "
        f"{t['pre_eager', False]:.4f}), residual form {t['pre', True]:.4f} "
        f"ms (eager loop {t['pre_eager', True]:.4f}), plain "
        f"{t['pre_plain', False]:.4f} / {t['pre_plain', True]:.4f} ms, sdpa "
        f"{t['lib']:.4f} ms (sdpa vs kernel {lib_err:.2e})")
    log(f"  blockwise_causal_prefix_attn_q {SERVE_PAGE_DTYPE}: kernel "
        f"{t['q']:.4f} ms (eager loop {t['q_eager']:.4f}), plain "
        f"{t['q_plain']:.4f} ms, sdpa over the dequantised slots "
        f"{t['qlib']:.4f} ms")
    log("  bca_prefix_mma_kernel<slots, Dh, heads a block> (-Xptxas -v): "
        + ", ".join(f"{slot} {dh} {heads} {regs} registers, {spill} B spilled"
                    for slot, (dh, heads), regs, spill
                    in ptxas_registers("bca_prefix_mma_kernel")))
    src = "src/repro_torch/csrc/blockwise_causal_attn.cu"
    del sets, qsets, lib, qlib
    return [
        dict(name="blockwise_causal_prefix_attn", route="cuda", source=src,
             replaces="src/repro/kernels/blockwise_causal_attn.py:216",
             ms=t["pre", False], eager_ms=t["pre_eager", False],
             plain_ms=t["pre_plain", False],
             library_ms=t["lib"], bytes=pre_bytes, flops=flops,
             max_abs_err=errs["pre", "full", bf16]),
        dict(name="blockwise_causal_prefix_attn(return_residuals)",
             route="cuda", source=src,
             replaces="src/repro/kernels/blockwise_causal_attn.py:125",
             ms=t["pre", True], eager_ms=t["pre_eager", True],
             plain_ms=t["pre_plain", True],
             library_ms=t["lib"], bytes=res_bytes, flops=flops,
             max_abs_err=errs["pre_res", "full", bf16]),
        dict(name="blockwise_causal_prefix_attn_q", route="cuda",
             source=src,
             replaces="src/repro/kernels/blockwise_causal_attn.py:157",
             ms=t["q"], eager_ms=t["q_eager"], plain_ms=t["q_plain"],
             library_ms=t["qlib"], bytes=q_bytes, flops=flops,
             max_abs_err=errs["pre_q", "full", SERVE_PAGE_DTYPE, bf16]),
    ]


def time_decode_q(dev, errs):
    """Kernel 7 (int8 ring and slots) at B=4, M=288, rows at t = 300, 1000,
    2300, 4000, bf16 q, beside one masked SDPA call over the dequantised
    bf16 cache."""
    import torch
    from repro_torch.core.cache import dequantize_blockwise
    import torch.nn.functional as Fn
    from repro_torch.kernels import linformer_attn as la
    bf16 = torch.bfloat16
    (B, Hkv, G, c, M, r, Dh), t_rows = DEC_Q_SHAPES["full"]
    n_sets = 24                                    # 24 x 2.5 MB > 50 MB L2
    sets = [decode_q_inputs(B, Hkv, G, c, M, r, Dh, bf16, SERVE_PAGE_DTYPE,
                            dev, 60 + i, t_rows) for i in range(n_sets)]
    run = lambda i: la.decode_attn_q(*sets[i], scale=Dh ** -0.5)  # noqa: E731
    ms = time_graph_ms(run, n_sets, iters=100)
    eager_ms = time_ms(run, n_sets, iters=100)
    plain_ms = time_ms(lambda i: la.decode_attn_q_plain(
        *sets[i], scale=Dh ** -0.5), n_sets, iters=100)
    lib_sets = []
    for q, rk, rv, ck, cv, rks, rvs, cks, cvs, bl, bg in sets:
        deq = lambda x, s_: dequantize_blockwise(x, s_).to(bf16)  # noqa: E731
        keys = torch.cat([deq(rk, rks), deq(ck, cks)], 2)
        vals = torch.cat([deq(rv, rvs), deq(cv, cvs)], 2)
        ok = (torch.cat([bl, bg], 1) == 0)[:, None, None, :]
        lib_sets.append((q.reshape(B, Hkv * G, 1, Dh),
                         keys.repeat_interleave(G, 1),
                         vals.repeat_interleave(G, 1), ok))
    lib_ms = time_graph_ms(lambda i: Fn.scaled_dot_product_attention(
        *lib_sets[i][:3], attn_mask=lib_sets[i][3], scale=Dh ** -0.5),
        n_sets, iters=100)
    flops, nbytes = la.decode_attn_cost(B, Hkv, G, Dh, c, M, block_slots=r,
                                        positions=t_rows,
                                        cache_row_bytes=Dh * 1 + 4)
    log(f"  decode_attn_q {SERVE_PAGE_DTYPE} B={B} Hkv={Hkv} G={G} c={c} "
        f"M={M} t={t_rows}: kernel {ms:.4f} ms (eager loop "
        f"{eager_ms:.4f}), plain {plain_ms:.4f} ms, sdpa over the "
        f"dequantised cache {lib_ms:.4f} ms")
    del sets, lib_sets
    return [dict(name="decode_attn_q", route="cuda",
                 source="src/repro_torch/csrc/decode_attn.cu",
                 replaces="src/repro/kernels/linformer_attn.py:180",
                 ms=ms, eager_ms=eager_ms, plain_ms=plain_ms,
                 library_ms=lib_ms, bytes=nbytes, flops=flops,
                 max_abs_err=errs["dec_q", "full", SERVE_PAGE_DTYPE, bf16])]


def time_training_kernels(dev, errs):
    """Kernels 1, 1r and 2 at the train step's shapes, bf16: the forward in
    both forms beside the SDPA forward, the backward beside one SDPA
    backward (torch.autograd.grad on a saved graph, the forward untimed).
    Returns the records of 1r and 2 and kernel 1's numbers at this shape
    (the remat'd forward of the train step) for its record."""
    import torch
    import torch.nn.functional as Fn
    from repro_torch.kernels import blockwise_causal_attn as bca
    bf16 = torch.bfloat16
    B, H, Hkv, S, c, r, Dh = TRAIN_TIME_SHAPE
    G, M = H // Hkv, (S // c) * r
    n_sets = 2                                     # 2 x ~100 MB > 50 MB L2
    sets = [bca_inputs(B, H, Hkv, S, c, r, Dh, bf16, dev, seed=30 + i)
            for i in range(n_sets)]
    g = torch.Generator(device=dev).manual_seed(40)
    dos = [torch.randn(s[0].shape, generator=g, device=dev).to(bf16)
           for s in sets]
    kw = dict(block_size=c, block_slots=r, scale=Dh ** -0.5)
    run = lambda i: bca.blockwise_causal_attn(  # noqa: E731
        *sets[i], return_residuals=True, **kw)
    res_ms = time_graph_ms(run, n_sets, iters=20)
    res_eager_ms = time_ms(run, n_sets)
    res_plain_ms = time_ms(lambda i: bca.blockwise_causal_attn_plain(
        *sets[i], return_residuals=True, **kw), n_sets, iters=5)
    run = lambda i: bca.blockwise_causal_attn(*sets[i], **kw)  # noqa: E731
    fwd_ms, fwd_eager_ms = time_graph_ms(run, n_sets, iters=20), \
        time_ms(run, n_sets)
    fwd_plain_ms = time_ms(lambda i: bca.blockwise_causal_attn_plain(
        *sets[i], **kw), n_sets, iters=5)
    resid = [bca.blockwise_causal_attn(*s, return_residuals=True, **kw)[1:]
             for s in sets]
    run = lambda i: bca.blockwise_causal_attn_bwd(  # noqa: E731
        *sets[i], *resid[i], dos[i], **kw)
    bwd_ms = time_graph_ms(run, n_sets, iters=10)
    bwd_eager_ms = time_ms(run, n_sets, iters=10)
    bwd_plain_ms = time_ms(lambda i: bca.blockwise_causal_attn_bwd_plain(
        *sets[i], *resid[i], dos[i], **kw), n_sets, iters=5)
    mask = joint_mask(S, c, r, dev)
    # the SDPA forwards whose backward is timed run on the stream the
    # backward is then captured on
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    lib = []
    with torch.cuda.stream(side):
        for q, k, v, kb, vb in sets:
            xs = [x.contiguous().requires_grad_() for x in (
                q, torch.cat([k, kb], 2).repeat_interleave(G, 1),
                torch.cat([v, vb], 2).repeat_interleave(G, 1))]
            out = Fn.scaled_dot_product_attention(*xs, attn_mask=mask,
                                                  scale=Dh ** -0.5)
            lib.append((xs, out))
    torch.cuda.synchronize()
    lib_fwd_ms = time_graph_ms(lambda i: Fn.scaled_dot_product_attention(
        *[x.detach() for x in lib[i][0]], attn_mask=mask, scale=Dh ** -0.5),
        n_sets, iters=20)
    dos_c = [do.contiguous() for do in dos]
    lib_bwd_ms = time_graph_ms(lambda i: torch.autograd.grad(
        lib[i][1], lib[i][0], dos_c[i], retain_graph=True),
        n_sets, iters=10, stream=side)
    tkw = dict(block_size=c, block_slots=r)
    fwd_cost = bca.blockwise_causal_attn_cost(B, H, Hkv, S, Dh, **tkw)
    res_cost = bca.blockwise_causal_attn_cost(B, H, Hkv, S, Dh,
                                              return_residuals=True, **tkw)
    bwd_cost = bca.blockwise_causal_attn_bwd_cost(B, H, Hkv, S, Dh, M, **tkw)
    fwd_bound = bound_ms(*fwd_cost)[0]
    log(f"  blockwise_causal_attn B={B} H={H} Hkv={Hkv} S={S}: kernel "
        f"{fwd_ms:.4f} ms (eager loop {fwd_eager_ms:.4f}), plain "
        f"{fwd_plain_ms:.4f} ms, sdpa {lib_fwd_ms:.4f} ms; bound "
        f"{fwd_bound:.4f} ms")
    log(f"  blockwise_causal_attn(residuals) B={B} H={H} Hkv={Hkv} S={S}: "
        f"kernel {res_ms:.4f} ms (eager loop {res_eager_ms:.4f}), plain "
        f"{res_plain_ms:.4f} ms, sdpa {lib_fwd_ms:.4f} ms")
    log(f"  blockwise_causal_attn_bwd B={B} H={H} Hkv={Hkv} S={S}: kernel "
        f"{bwd_ms:.4f} ms (eager loop {bwd_eager_ms:.4f}), plain "
        f"{bwd_plain_ms:.4f} ms, sdpa backward {lib_bwd_ms:.4f} ms")
    for frag in ("bca_bwd_dq_mma_kernel", "bca_bwd_dkdv_mma_kernel"):
        log(f"  {frag}<Dh> (-Xptxas -v): " + ", ".join(
            f"{dh[0]} {regs} registers, {spill} B spilled"
            for _, dh, regs, spill in ptxas_registers(frag)))
    del sets, lib, resid, dos, dos_c
    train_fwd = dict(train_ms=fwd_ms, train_eager_ms=fwd_eager_ms,
                     train_plain_ms=fwd_plain_ms,
                     train_library_ms=lib_fwd_ms, train_bound_ms=fwd_bound)
    return train_fwd, [
        dict(name="blockwise_causal_attn(return_residuals)", route="cuda",
             source="src/repro_torch/csrc/blockwise_causal_attn.cu",
             replaces="src/repro/kernels/blockwise_causal_attn.py:96",
             ms=res_ms, eager_ms=res_eager_ms, plain_ms=res_plain_ms,
             library_ms=lib_fwd_ms, flops=res_cost[0], bytes=res_cost[1],
             max_abs_err=errs["res", "full", bf16]),
        dict(name="blockwise_causal_attn_bwd", route="cuda",
             source="src/repro_torch/csrc/blockwise_causal_attn_bwd.cu",
             replaces="src/repro/kernels/blockwise_causal_attn.py:469",
             ms=bwd_ms, eager_ms=bwd_eager_ms, plain_ms=bwd_plain_ms,
             library_ms=lib_bwd_ms, flops=bwd_cost[0], bytes=bwd_cost[1],
             max_abs_err=errs["bwd", "full", bf16]),
    ]


def time_exact_kernels(dev, errs):
    """Kernels 5 and 6 at the paper's full width (B=32, H=12, S=512, K=128,
    Dh=64), bf16, beside their plain versions, one unmasked SDPA call over
    (q, k̄, v̄) and one torch.matmul of Eᵀ with x, each by CUDA-graph replay
    (time_graph_ms: at ~0.01-0.03 ms a call, time_ms's eager loop times the
    host's enqueue); the kernels' eager time is logged beside it."""
    import torch
    import torch.nn.functional as Fn
    from repro_torch.kernels import linformer_attn as la
    from repro_torch.kernels import seq_projection as sp
    bf16 = torch.bfloat16
    B, H, Hkv, S, K, Dh = EXACT_SHAPES["full"]
    sc = Dh ** -0.5
    n_sets = 4                                    # 4 x ~31 MB > 50 MB L2
    sets = [exact_inputs(B, H, Hkv, S, K, Dh, bf16, dev, seed=80 + i)
            for i in range(n_sets)]
    t = {"exact": time_graph_ms(
             lambda i: la.linformer_attn(*sets[i], scale=sc), n_sets),
         "exact_eager": time_ms(
             lambda i: la.linformer_attn(*sets[i], scale=sc), n_sets),
         "exact_plain": time_graph_ms(lambda i: la.linformer_attn_plain(
             *sets[i], scale=sc), n_sets, iters=12)}
    lib = [tuple(x.contiguous() for x in xs) for xs in sets]
    t["exact_lib"] = time_graph_ms(lambda i: Fn.scaled_dot_product_attention(
        *lib[i], scale=sc), n_sets)
    lib_err = (Fn.scaled_dot_product_attention(*lib[0], scale=sc).float()
               - la.linformer_attn(*sets[0], scale=sc).float()).abs().max()
    log(f"  linformer_attn B={B} H={H} Hkv={Hkv} S={S} K={K} Dh={Dh}: "
        f"kernel {t['exact']:.4f} ms (eager loop {t['exact_eager']:.4f}), "
        f"plain {t['exact_plain']:.4f} ms, sdpa {t['exact_lib']:.4f} ms "
        f"(sdpa vs kernel {lib_err.item():.2e})")
    del sets, lib
    Bp, Hp, Sp, Kp, Dp, rows = SP_SHAPES["full"]
    n_sets = 6                                    # 6 x ~16 MB > 50 MB L2
    psets = [sp_inputs(Bp, Hp, Sp, Kp, Dp, rows, bf16, dev, seed=90 + i)
             for i in range(n_sets)]
    t["sp"] = time_graph_ms(lambda i: sp.seq_projection(*psets[i]), n_sets)
    t["sp_eager"] = time_ms(lambda i: sp.seq_projection(*psets[i]), n_sets)
    t["sp_plain"] = time_graph_ms(
        lambda i: sp.seq_projection_plain(*psets[i]), n_sets, iters=12)
    plib = [(E.T, x.contiguous()) for x, E in psets]
    t["sp_lib"] = time_graph_ms(lambda i: torch.matmul(*plib[i]), n_sets)
    lib_err = (torch.matmul(*plib[0]).float()
               - sp.seq_projection(*psets[0]).float()).abs().max()
    log(f"  seq_projection B={Bp} H={Hp} S={Sp} K={Kp} Dh={Dp}: kernel "
        f"{t['sp']:.4f} ms (eager loop {t['sp_eager']:.4f}), plain "
        f"{t['sp_plain']:.4f} ms, matmul {t['sp_lib']:.4f} ms (matmul vs "
        f"kernel {lib_err.item():.2e})")
    del psets, plib
    exact_cost = la.linformer_attn_cost(B, H, Hkv, S, K, Dh)
    sp_cost = sp.seq_projection_cost(Bp, Hp, Sp, Kp, Dp)
    return [
        dict(name="linformer_attn", route="cuda",
             source="src/repro_torch/csrc/linformer_attn.cu",
             replaces="src/repro/kernels/linformer_attn.py:58",
             ms=t["exact"], eager_ms=t["exact_eager"],
             plain_ms=t["exact_plain"],
             library_ms=t["exact_lib"], flops=exact_cost[0],
             bytes=exact_cost[1],
             max_abs_err=errs["exact", "full", bf16]),
        dict(name="seq_projection", route="cuda",
             source="src/repro_torch/csrc/seq_projection.cu",
             replaces="src/repro/kernels/seq_projection.py:39",
             ms=t["sp"], eager_ms=t["sp_eager"], plain_ms=t["sp_plain"],
             library_ms=t["sp_lib"], flops=sp_cost[0], bytes=sp_cost[1],
             max_abs_err=errs["sp", "full", bf16]),
    ]


LAUNCH_COUNTERS = (  # (record name, wrapper module, wrapper, counter)
    ("blockwise_causal_attn", "bca", "blockwise_causal_attn", "launches"),
    ("blockwise_causal_attn(return_residuals)", "bca",
     "blockwise_causal_attn", "residual_launches"),
    ("blockwise_causal_attn_bwd", "bca", "blockwise_causal_attn_bwd",
     "launches"),
    ("blockwise_causal_attn_bwd(start_blocks)", "bca",
     "blockwise_causal_attn_bwd", "offset_launches"),
    ("decode_attn", "la", "decode_attn", "launches"),
    ("blockwise_causal_prefix_attn", "bca", "blockwise_causal_prefix_attn",
     "launches"),
    ("blockwise_causal_prefix_attn(return_residuals)", "bca",
     "blockwise_causal_prefix_attn", "residual_launches"),
    ("blockwise_causal_prefix_attn_q", "bca",
     "blockwise_causal_prefix_attn_q", "launches"),
    ("decode_attn_q", "la", "decode_attn_q", "launches"),
    ("linformer_attn", "la", "linformer_attn", "launches"),
    ("seq_projection", "sp", "seq_projection", "launches"),
)


def _counters():
    from repro_torch.kernels import blockwise_causal_attn as bca
    from repro_torch.kernels import linformer_attn as la
    from repro_torch.kernels import seq_projection as sp
    mods = {"bca": bca, "la": la, "sp": sp}
    return [(name, getattr(mods[m], fn), attr)
            for name, m, fn, attr in LAUNCH_COUNTERS]


def reset_launches():
    for _, fn, attr in _counters():
        setattr(fn, attr, 0)


def read_launches():
    return {name: getattr(fn, attr) for name, fn, attr in _counters()}


def sink_launches(kernels):
    """A dry run's launches by kernel (the cost sink's count of fake
    launches, `step_cost.measure`'s "kernels") read as the counters read:
    the backward's `launches` counts its offset form's launches too."""
    got = {name: 0 for name, _, _, _ in LAUNCH_COUNTERS}
    for name, k in kernels.items():
        got[name] += k["launches"]
    got["blockwise_causal_attn_bwd"] += \
        got["blockwise_causal_attn_bwd(start_blocks)"]
    return got


def require_routes(path, route):
    """The route probes name `route` for the last forward and backward
    launches of kernels 1, 1r and 2 (all of them, on `path`)."""
    from repro_torch.kernels import blockwise_causal_attn as bca
    got = (bca.last_forward_route(), bca.last_backward_route())
    log(f"  {path}: forward and backward routes {got}")
    if got != (route, route):
        raise AssertionError(f"{path}: routes {got}, expected {route}")


def require_launches(launches, names, path):
    for name in names:
        if launches[name] <= 0:
            raise AssertionError(f"{name} never launched on the {path} path")


# the depth of [serve]'s model (qwen3-8b has 36 layers), shared by every
# phase on its weights ([serve*], [sample], [per-token]): those phases are
# host-bound (a decode step's launches grow with the layers) and took 644 s
# of a slow host's run at 36 layers, so the script's run is cut by depth
# [serve] and the phases on its weights: 4 of qwen3-8b's 36 layers. The
# port launches ~4100 kernels a layer in an admission prefill, so these
# phases' wall is the host's and scales with the depth; at 12 layers the
# whole run took 792-1032 s on the card and passed the 1200 s limit once
SERVE_LAYERS = 4
SERVE_LENS = (3, 256 + 17, 230, 512 + 5, 768 + 30, 1, 256 + 9, 512 + 32)
SERVE_BUDGETS = [32, 40, 40, 36, 48, 44, 32, 48]


def serve_setup(dev, cfg):
    """Full-width random bf16 params (seed 0) and the 8 prompts: c + j
    tokens, j in SERVE_LENS; 486 + 40 crosses the block boundary at 512
    while decoding, so the decode-time fold runs."""
    import numpy as np
    import torch
    from repro_torch.models import model as tmodel
    from repro_torch.models.transformer import param_bytes
    log(f"[serve] {cfg.name}: {cfg.num_layers} layers, d={cfg.d_model}, "
        f"H={cfg.attention.num_heads}/{cfg.attention.num_kv_heads}, "
        f"vocab {cfg.padded_vocab_size}, {cfg.dtype}")
    t0 = time.perf_counter()
    params = tmodel.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    log(f"  params: {param_bytes(params) / 1e9:.2f} GB in "
        f"{time.perf_counter() - t0:.1f} s")
    c = cfg.attention.linformer.block_size
    rng = np.random.default_rng(0)
    prompts = [list(map(int, rng.integers(4, cfg.vocab_size, c + j)))
               for j in SERVE_LENS]
    return params, prompts


def serve_engine(dev, cfg, params, **kw):
    import torch
    from repro_torch.serving import ServingEngine
    return ServingEngine(params, cfg, max_seq=4096, device=dev,
                         cache_dtype=torch.bfloat16, decode_chunk=16, **kw)


# engine calls the scheduler makes, timed one by one in a counted serve
SERVE_ACTIVITIES = ("prefill_request", "pool_prefill_chunk",
                    "pool_prefill_remainder", "decode_chunk_fn")


def time_activities(eng):
    """Shadow the engine's SERVE_ACTIVITIES with wrappers that synchronise
    before and after each call and add its host wall to {name: [calls,
    seconds]}: where a serve's wall goes, at the cost of one extra sync
    per call."""
    import torch
    acc = {}
    for name in SERVE_ACTIVITIES:
        def timed(*args, _fn=getattr(eng, name), _name=name, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(*args, **kw)
            torch.cuda.synchronize()
            rec = acc.setdefault(_name, [0, 0.0])
            rec[0] += 1
            rec[1] += time.perf_counter() - t0
            return out
        setattr(eng, name, timed)
    return acc


# run_serve's result: the outputs, the scheduler, the launch counters of
# the serve, and {engine activity: [calls, host seconds]}
ServeRun = collections.namedtuple("ServeRun", "outs sched launches walls")


def run_serve(tag, eng, prompts, kernels, budgets=SERVE_BUDGETS):
    """One counted serve of the requests (max_batch 4, new-token
    `budgets`): launch counters reset just before and read just after;
    each of `kernels` must have launched; host wall by engine activity.
    Returns a ServeRun."""
    import torch
    from repro_torch.data.pipeline import EOS
    acc = time_activities(eng)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    outs, sched = eng.serve(prompts, budgets, max_batch=4,
                            return_scheduler=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    n_tok = sum(len(o) for o in outs)
    peak = torch.cuda.max_memory_allocated()
    st = sched.stats
    log(f"[{tag}] {len(prompts)} requests (prompts "
        f"{[len(p) for p in prompts]}), {n_tok} tokens in {wall:.2f} s: "
        f"{n_tok / wall:.1f} tok/s; peak memory {peak / 1e9:.2f} GB; "
        f"{st.chunks} decode chunks, {st.idle_ticks} idle ticks, mean "
        f"occupancy {st.mean_occupancy:.2f}; {st.prefill_forwards} prefill "
        f"forwards for {st.prefill_tokens} prompt tokens; launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    rest = wall - sum(t for _, t in acc.values())
    log("  wall by activity: " + ", ".join(
        f"{name} {n}x {t:.2f} s" for name, (n, t) in acc.items())
        + f", scheduler and the rest {rest:.2f} s")
    for name in SERVE_ACTIVITIES:
        delattr(eng, name)                       # the engine's own again
    require_launches(launches, kernels, tag)
    if st.quarantines:
        raise AssertionError(f"{st.quarantines} rows quarantined for "
                             "non-finite logits")
    for o, b in zip(outs, budgets):
        if not isinstance(o, list) or not (0 < len(o) <= b) or EOS in o:
            raise AssertionError(f"output {o!r} for budget {b}")
        if len(o) < b:
            log(f"  a request ended at EOS after {len(o)} of {b} tokens")
    return ServeRun(outs, sched, launches, acc)


def timed_profile(name, fn, top=8, ranges=()):
    """fn once as a warm-up, once timed alone, once under torch.profiler;
    the device time of each record_function range in `ranges` is logged
    beside the profile."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    kernels, _, spans = profile_kernels(fn, ranges)
    log_profile(name, wall, kernels, top=top)
    busy = sum(t for _, _, t in kernels)
    for rng in ranges:
        n, t = spans.get(rng, (0, 0.0))
        log(f"    range {rng}: {n} calls, {1e3 * t:.3f} ms of device time "
            f"({100 * t / busy:.1f}% of busy)")


def serve_phase(dev, cfg, params, prompts):
    """Monolithic admission into the dense pool, then where the time goes:
    one admission prefill and one 16-step decode chunk of a full 4-row
    pool."""
    import torch
    eng = serve_engine(dev, cfg, params)
    run = run_serve("serve", eng, prompts,
                    ("blockwise_causal_attn", "decode_attn"))
    outs, launches = run.outs, run.launches
    pool = eng.init_pool_cache(4)
    firsts = []
    for row, p in enumerate(prompts[:4]):
        slot_cache, first = eng.prefill_request(p)
        eng.write_pool_slot(pool, slot_cache, row)
        firsts.append(first)
    cur = torch.tensor(firsts, device=dev)
    fin = torch.zeros(4, dtype=torch.bool, device=dev)
    timed_profile("prefill", lambda: eng.prefill_request(prompts[4]))
    timed_profile("decode_chunk",
                  lambda: eng.decode_chunk_fn(cur, fin, pool, 16))
    del eng, pool
    return outs, launches


def chunk_rows(prompts, P, c):
    """The first chunk of each prompt: (tokens (g, P), n_valid (g,))."""
    import numpy as np
    toks = np.zeros((len(prompts), P), np.int64)
    n_valid = np.zeros(len(prompts), np.int64)
    for j, p in enumerate(prompts):
        n = min(P, (len(p) // c) * c)
        toks[j, :n] = p[:n]
        n_valid[j] = n
    return toks, n_valid


def serve_chunked_phase(dev, cfg, params, prompts, mono_outs):
    """Chunked admission (prefill_chunk=512) into the dense pool: token
    agreement with the monolithic run, then one chunk forward of a 4-row
    pool under the profiler."""
    eng = serve_engine(dev, cfg, params, prefill_chunk=SERVE_PREFILL_CHUNK)
    run = run_serve("serve-chunked", eng, prompts,
                    ("blockwise_causal_prefix_attn", "decode_attn"))
    outs, launches = run.outs, run.launches
    same = [a == b for a, b in zip(outs, mono_outs)]
    agree = sum(sum(x == y for x, y in zip(a, b)) for a, b in
                zip(outs, mono_outs))
    log(f"  chunked vs monolithic: {sum(same)} of {len(same)} requests "
        f"token-identical, {agree} of {sum(map(len, mono_outs))} tokens "
        "equal position by position (bf16: GEMMs of other shapes round "
        "differently)")
    pool = eng.init_pool_cache(4)
    toks, n_valid = chunk_rows(prompts[:4], SERVE_PREFILL_CHUNK,
                               cfg.attention.linformer.block_size)

    def chunk_forward():
        pool["lengths"].zero_()
        eng.pool_prefill_chunk(pool, [0, 1, 2, 3], toks, n_valid, pad_to=4)

    timed_profile(f"chunk forward (4, {SERVE_PREFILL_CHUNK}), n_valid "
                  f"{n_valid.tolist()}", chunk_forward)
    del eng, pool
    return launches


def serve_paged_phase(dev, cfg, params, prompts):
    """Chunked admission into the paged pool with int8 pages: clean page
    accounting, cache bytes against the dense pool, then one paged decode
    chunk and one paged chunk forward of a 4-row pool under the
    profiler."""
    import torch
    eng = serve_engine(dev, cfg, params, prefill_chunk=SERVE_PREFILL_CHUNK,
                       cache_format="paged", page_dtype=SERVE_PAGE_DTYPE)
    run = run_serve("serve-paged", eng, prompts,
                    ("blockwise_causal_prefix_attn_q", "decode_attn_q"))
    sched, launches = run.sched, run.launches
    for name in ("blockwise_causal_prefix_attn", "decode_attn"):
        if launches[name]:
            raise AssertionError(f"{name} launched on the paged path")
    alloc = sched.pool.alloc
    alloc.check()
    if alloc.free_pages != alloc.usable_pages:
        raise AssertionError(f"{alloc.usable_pages - alloc.free_pages} "
                             "pages leaked")
    dense = serve_engine(dev, cfg, params).cache_bytes(4)
    log(f"  pages: {sched.pool.pages_allocated} allocated, "
        f"{sched.pool.pages_freed} freed, all {alloc.usable_pages} free "
        f"after serve; cache bytes of a 4-row pool: {eng.cache_bytes(4)} "
        f"paged {SERVE_PAGE_DTYPE} against {dense} dense bf16 "
        f"({eng.cache_bytes(4) / dense:.3f}x)")
    # one 16-step decode chunk of a full paged pool, each row owning a full
    # page table and sitting at its prompt's whole blocks
    pool = eng.init_pool_cache(4)
    c, maxp = cfg.attention.linformer.block_size, eng.max_pages_per_row()
    for row, p in enumerate(prompts[:4]):
        eng.write_table_row(pool, row, range(row * maxp, (row + 1) * maxp))
        pool["lengths"][row] = (len(p) // c) * c
    cur = torch.full((4,), 5, device=dev)
    fin = torch.zeros(4, dtype=torch.bool, device=dev)
    lengths = pool["lengths"].clone()

    def decode_chunk():
        pool["lengths"].copy_(lengths)
        eng.decode_chunk_fn(cur, fin, pool, 16)

    timed_profile("paged decode_chunk", decode_chunk)
    del pool
    paged_chunk_profile(eng, cfg, prompts)
    del eng
    return launches


def paged_chunk_profile(eng, cfg, prompts):
    """One (4, 512) chunk forward into the paged int8 pool under the
    profiler, beside the dense one of [serve-chunked]: kernel 8's device
    time, and that of `paged_gather` (core/cache.py), which copies every
    row's pages into a dense slot buffer for kernel 8 in each layer, timed
    as a record_function range around it: the price of a page-table fold
    into the kernel."""
    import torch
    from repro_torch.core import cache as tcache
    pool = eng.init_pool_cache(4)
    maxp = eng.max_pages_per_row()
    for row in range(4):
        eng.write_table_row(pool, row, range(row * maxp, (row + 1) * maxp))
    toks, n_valid = chunk_rows(prompts[:4], SERVE_PREFILL_CHUNK,
                               cfg.attention.linformer.block_size)

    def chunk_forward():
        pool["lengths"].zero_()
        eng.pool_prefill_chunk(pool, [0, 1, 2, 3], toks, n_valid, pad_to=4)

    gather = tcache.paged_gather

    def annotated(*args, **kw):
        with torch.profiler.record_function("paged_gather"):
            return gather(*args, **kw)

    tcache.paged_gather = annotated
    try:
        timed_profile(f"paged chunk forward (4, {SERVE_PREFILL_CHUNK}), "
                      f"{SERVE_PAGE_DTYPE} pages, n_valid "
                      f"{n_valid.tolist()}", chunk_forward,
                      ranges=("paged_gather",))
    finally:
        tcache.paged_gather = gather
    del pool


def serve_parity_phase(dev, cfg, tag="parity", paged_layers=2):
    """2-layer full-width fp32: the kernels against the plain reference on
    the dense pool (prefill logits, tokens), chunked against monolithic
    admission through the kernels (tokens; with experts, chunked admission
    through both routes instead), and the paged int8 and fp8
    pools under chunked admission (chunk-forward logits, tokens) at
    `paged_layers` layers, held a layer at a time on shared inputs and
    codes (`paged_layer_parity`): two independent forwards past the first
    layer are chaotic, a layer's K/V differ by the routes' rounding, a few
    values cross a quantization boundary and take another int8/fp8 code,
    and the logits move by up to ~6e-3 (`scripts/paged_parity_spread.py`);
    on shared inputs both routes write the same codes and the gate reads
    the attention routes alone. The paged serves' greedy tokens are held
    equal as before."""
    import numpy as np
    import torch
    from repro_torch.models import model as tmodel
    from repro_torch.models.transformer import param_bytes
    from repro_torch.serving import ServingEngine
    cfg2 = dataclasses.replace(cfg, num_layers=2, dtype="float32")
    torch.cuda.reset_peak_memory_stats()
    params2 = tmodel.init_params(cfg2, seed=1, device=dev)
    log(f"[{tag}] params {param_bytes(params2) / 1e9:.2f} GB (2 layers, "
        "fp32)")
    c = cfg.attention.linformer.block_size
    rng = np.random.default_rng(1)
    prompts2 = [list(map(int, rng.integers(4, cfg.vocab_size, n)))
                for n in (c + 5, 2 * c + 9)]

    def engine(backend, **kw):
        return ServingEngine(params2, cfg2, max_seq=4096, device=dev,
                             cache_dtype=torch.float32, decode_chunk=16,
                             attention_backend=backend, **kw)

    def assert_parity(what, logits, outs, layers=2):
        dl = (logits["auto"] - logits["reference"]).abs().max().item()
        same = outs["auto"] == outs["reference"]
        log(f"[{tag}] {layers}-layer fp32, {what}: logits max |auto - "
            f"reference| "
            f"= {dl:.3e} (tol {LOGITS_TOL:g}); first 16 greedy tokens "
            f"identical: {same}")
        if not dl <= LOGITS_TOL:
            raise AssertionError(f"{what}: logits differ by {dl}")
        if not same:
            raise AssertionError(f"{what}: greedy tokens differ: {outs}")
        if not all(torch.isfinite(v).all() for v in logits.values()):
            raise AssertionError(f"{what}: non-finite logits")

    logits, outs = {}, {}
    for backend in ("auto", "reference"):
        eng = engine(backend)
        _, lg = eng.prefill(np.asarray([prompts2[1]]))
        logits[backend], outs[backend] = lg.float(), eng.serve(
            prompts2, 16, max_batch=2)
    assert_parity("dense pool, prefill", logits, outs)
    chunked = engine("auto", prefill_chunk=SERVE_PREFILL_CHUNK).serve(
        prompts2, 16, max_batch=2)
    log(f"[{tag}] 2-layer fp32: chunked admission through the kernels "
        f"token-identical to monolithic: {chunked == outs['auto']}")
    if cfg.moe.num_experts:
        # capacity couples the rows routed together, and chunked admission
        # routes the two prompts' chunks in one batch where monolithic
        # admission routes each alone: the tokens may differ by design, so
        # the chunked serve is held to the reference route's chunked serve
        ref = engine("reference", prefill_chunk=SERVE_PREFILL_CHUNK).serve(
            prompts2, 16, max_batch=2)
        log(f"[{tag}] 2-layer fp32: chunked admission, kernels vs "
            f"reference route token-identical: {chunked == ref}")
        if chunked != ref:
            raise AssertionError(f"chunked {chunked} vs reference {ref}")
    elif chunked != outs["auto"]:
        raise AssertionError(f"chunked {chunked} vs monolithic "
                             f"{outs['auto']}")
    toks, n_valid = chunk_rows(prompts2, SERVE_PREFILL_CHUNK, c)
    if paged_layers != 2:
        cfg2 = dataclasses.replace(cfg2, num_layers=paged_layers)
        params2 = tmodel.init_params(cfg2, seed=1, device=dev)
    for pd in ("int8", "fp8"):
        engines = {b: engine(b, prefill_chunk=SERVE_PREFILL_CHUNK,
                             cache_format="paged", page_dtype=pd)
                   for b in ("auto", "reference")}
        rep = paged_layer_parity(engines, params2, cfg2, toks, n_valid)
        log(f"[{tag}] {paged_layers}-layer fp32, paged {pd} pool, chunk "
            f"forward a layer at a time on shared inputs and codes: codes "
            f"the routes write differently by layer {rep['flips']}; block "
            f"output max |auto - reference| by layer "
            f"{[f'{e:.3e}' for e in rep['errs']]}; logits {rep['logits']:.3e}"
            f" (tol {LOGITS_TOL:g})")
        if any(rep["flips"]):
            raise AssertionError(f"paged {pd}: codes differ {rep['flips']}")
        if not (rep["logits"] <= LOGITS_TOL and all(
                e <= LOGITS_TOL for e in rep["errs"])):
            raise AssertionError(f"paged {pd}: {rep}")
        outs = {b: eng.serve(prompts2, 16, max_batch=2)
                for b, eng in engines.items()}
        log(f"[{tag}] {paged_layers}-layer fp32, paged {pd} pool: first 16 "
            f"greedy tokens identical: {outs['auto'] == outs['reference']}")
        if outs["auto"] != outs["reference"]:
            raise AssertionError(f"paged {pd}: greedy tokens differ: {outs}")
    log(f"[{tag}] peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f}"
        " GB")


# the int8/fp8 codes a paged pool's chunk forward writes
PAGED_CODES = ("page_k", "page_v", "raw_k_q", "raw_v_q")


def paged_layer_parity(engines, params, cfg, toks, n_valid):
    """A chunk forward of rows 0 and 1 into a fresh paged pool of
    engines["auto"], a layer at a time: each layer's block runs through
    both routes' plans on the same input stream and on the same pool
    state (the reference route on a copy of the layer's leaves as they
    stood before the block), so both quantize the same k and v. Returns
    the codes the two routes wrote differently, by layer, each layer's
    block output max |auto - reference| (relative to max(1, max|ref|)),
    and the logits at each row's last valid token from the last layer's
    two outputs. The stream goes on with the kernel route's output: past
    the first layer, two independent forwards would quantize K/V that
    differ by the routes' rounding, and a value on a rounding boundary
    takes another code (scripts/paged_parity_spread.py)."""
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    eng = engines["auto"]
    pool = eng.init_pool_cache(2)
    maxp = eng.max_pages_per_row()
    for row in range(2):
        eng.write_table_row(pool, row, range(row * maxp, (row + 1) * maxp))
    dev = pool["lengths"].device
    sub = eng._gather_rows(pool, torch.as_tensor([0, 1], device=dev))
    tokens = torch.as_tensor(toks, dtype=torch.long, device=dev)
    t0 = sub["lengths"]
    positions = t0[:, None] + torch.arange(tokens.shape[1], device=dev)
    shared_lin = params.get("shared", {}).get("lin")
    last = torch.as_tensor(n_valid, device=dev).long() - 1
    flips, errs = [], []
    with torch.no_grad():
        x = L.embed_tokens(params["embed"]["tok"], tokens)
        for i in range(cfg.num_layers):
            lc = T._layer_caches(sub, i)
            pre = {k: v.clone() for k, v in lc.items()}
            y = {b: T.apply_block_prefill_chunk(
                     T.layer_params(params, i), x, cache, t0, cfg,
                     positions=positions, shared_lin=shared_lin,
                     plan=engines[b].plan)
                 for b, cache in (("auto", lc), ("reference", pre))}
            flips.append(sum(int((lc[k] != pre[k]).sum())
                             for k in PAGED_CODES if k in lc))
            ref = y["reference"].float()
            errs.append((y["auto"].float() - ref).abs().max().item()
                        / max(1.0, ref.abs().max().item()))
            x = y["auto"]
        rows = torch.arange(2, device=dev)
        lg = {b: T.logits_from_hidden(params, cfg, v[rows, last][:, None])
              for b, v in y.items()}
    return {"flips": flips, "errs": errs,
            "logits": (lg["auto"] - lg["reference"]).abs().max().item()}


def counted_train(path, dev, cfg, tcfg, telemetry=None):
    """The Trainer's run of `tcfg` on `cfg` (with `telemetry`, a
    `Telemetry` or None), launch counters reset just before and read just
    after: each step's loss, grad norm, ms and tokens/s, the peak memory;
    every loss finite; kernels 1, 1r and 2 launched at least once a layer
    a step, on the tensor cores. Returns (trainer, launches)."""
    import torch
    from repro_torch.models.transformer import flatten
    from repro_torch.train import Trainer
    trainer = Trainer(cfg, tcfg, device=dev, log_fn=log, telemetry=telemetry)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    trainer.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for p in flatten(trainer._params).values())
    for h in trainer.history:
        log(f"  step {h['step']}: loss {h['loss']:.4f}, grad norm "
            f"{h['grad_norm']:.4f}, {h['ms']:.1f} ms, "
            f"{h['tokens_per_s']:.1f} tokens/s")
    log(f"  {n_params / 1e9:.3f} B params; run {wall:.1f} s (parameter "
        f"init included); peak memory {peak / 1e9:.2f} GB; launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    if len(trainer.history) != tcfg.steps or not all(
            math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
            for h in trainer.history):
        raise AssertionError(f"non-finite or missing losses: "
                             f"{trainer.history}")
    need = cfg.num_layers * tcfg.steps
    for name in ("blockwise_causal_attn",
                 "blockwise_causal_attn(return_residuals)",
                 "blockwise_causal_attn_bwd"):
        if launches[name] < need:
            raise AssertionError(f"{name}: {launches[name]} launches on the "
                                 f"{path} path, expected at least {need}")
    require_routes(path, "tensor cores")
    return trainer, launches


def train_phase(dev, cfg):
    import torch
    from repro_torch.configs.base import OptimizerConfig, TrainConfig
    from repro_torch.data.pipeline import DataState, batches
    from repro_torch.optim import adamw_init
    from repro_torch.telemetry import Telemetry
    cfg8 = dataclasses.replace(cfg, num_layers=TRAIN_RUN["layers"])
    tcfg = TrainConfig(seq_len=TRAIN_RUN["seq"],
                       global_batch=TRAIN_RUN["batch"],
                       steps=TRAIN_RUN["steps"], log_every=1,
                       checkpoint_every=0, seed=0,
                       optimizer=OptimizerConfig(lr=3e-4, warmup_steps=1,
                                                 total_steps=4))
    log(f"[train] {cfg8.name} cut to {cfg8.num_layers} layers, d="
        f"{cfg8.d_model}, vocab {cfg8.padded_vocab_size}, {cfg8.dtype}, "
        f"remat {cfg8.remat}, seq {tcfg.seq_len}, global batch "
        f"{tcfg.global_batch}, {tcfg.steps} steps")
    tel = Telemetry()
    trainer, launches = counted_train("train", dev, cfg8, tcfg, tel)
    # the Trainer's telemetry: one span and one record a step, equal to
    # its history (the record rounds the step's ms to 3 decimals, as JAX's)
    recs = [r for r in tel.records if r["kind"] == "train_step"]
    spans = [e for e in tel.tracer.chrome_events()
             if e["ph"] == "X" and e["name"] == "train_step"]
    span_ms = ", ".join(f"{e['dur'] / 1e3:.1f}" for e in spans)
    log(f"  telemetry: {len(recs)} train_step records, {len(spans)} spans "
        f"({span_ms} ms), train_steps_total "
        f"{tel.metrics.counter('train_steps_total').value:g}, "
        f"train_tokens_total "
        f"{tel.metrics.counter('train_tokens_total').value:g}")
    if len(recs) != tcfg.steps or len(spans) != tcfg.steps or any(
            r["step_ms"] != round(h["ms"], 3) or r["loss"] != h["loss"]
            for r, h in zip(recs, trainer.history)):
        raise AssertionError(f"[train] telemetry records {recs} against "
                             f"the history {trainer.history}")

    # where the time goes: one more step (fresh optimizer state, the next
    # batch) under torch.profiler, after the counted run
    params = trainer._params
    state = adamw_init(params, tcfg.optimizer)
    stream = batches(trainer.corpus, DataState(tcfg.seed, tcfg.steps),
                     batch=tcfg.global_batch, seq=tcfg.seq_len)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in next(stream)[0].items()}
    step = trainer.train_step
    t0 = time.perf_counter()
    step(params, state, batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    log_profile("train step", wall,
                profile_kernels(lambda: step(params, state, batch))[0],
                top=16)
    del trainer, params, state
    return launches


def train_parity_phase(dev, cfg2, batch, tag):
    """One train step of the fp32 config `cfg2` on `batch` (numpy) through
    the kernels (backend "auto") and through the plain reference, from the
    same parameters: loss, every gradient leaf and the AdamW update within
    the TRAIN_* tolerances."""
    import numpy as np
    import torch
    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.models import model as tmodel
    from repro_torch.models.transformer import flatten
    from repro_torch.optim import adamw_init
    from repro_torch.train import make_train_step
    opt = OptimizerConfig(lr=1e-4, warmup_steps=1, total_steps=10)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    B, S = batch["labels"].shape
    S += cfg2.frontend_embed_len
    res = {}
    for backend in ("auto", "reference"):
        c = cfg2.with_attention_backend(backend)
        params = tmodel.init_params(c, seed=1, device=dev)
        leaves = flatten(params)
        for p in leaves.values():
            p.requires_grad_(True)
        p0 = {k: p.detach().clone() for k, p in leaves.items()}
        reset_launches()
        loss, _ = tmodel.loss_fn(params, c, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        launches = read_launches()
        # step counter 1: the schedule's learning rate at step 0 is 0
        state = adamw_init(params, opt)
        state["step"] = torch.ones((), dtype=torch.int32)
        params, state, _ = make_train_step(c, opt)(params, state, batch)
        res[backend] = (loss.item(), dict(zip(leaves, grads)),
                        {k: p.detach() - p0[k]
                         for k, p in flatten(params).items()})
        log(f"  [{tag}] {backend}: loss {loss.item():.6f}, launches "
            f"{ {k: v for k, v in launches.items() if v} }")
        del params, state, p0, leaves
        torch.cuda.empty_cache()
    loss_a, ga, ua = res["auto"]
    loss_r, gr, ur = res["reference"]
    loss_err = abs(loss_a - loss_r) / abs(loss_r)
    grad_err = {k: ((ga[k] - gr[k]).norm() / gr[k].norm()).item()
                for k in gr}
    worst = max(grad_err, key=grad_err.get)
    upd_rel = math.sqrt(sum(((ua[k] - ur[k]) ** 2).sum().item() for k in ur)
                        / sum((ur[k] ** 2).sum().item() for k in ur))
    log(f"[{tag}] {cfg2.num_layers}-layer fp32, B={B}, S={S}: loss rel "
        f"err {loss_err:.2e} (tol {TRAIN_LOSS_RTOL:g}); worst gradient leaf "
        f"{worst} rel norm err {grad_err[worst]:.2e} (tol "
        f"{TRAIN_GRAD_RTOL:g}); after one AdamW step, update rel norm err "
        f"{upd_rel:.2e} (tol {TRAIN_UPDATE_RTOL:g})")
    if not np.isfinite(loss_a) or not loss_err <= TRAIN_LOSS_RTOL:
        raise AssertionError(f"losses differ: {loss_a} vs {loss_r}")
    if not grad_err[worst] <= TRAIN_GRAD_RTOL:
        raise AssertionError(f"gradient {worst} differs: {grad_err[worst]}")
    if not upd_rel <= TRAIN_UPDATE_RTOL:
        raise AssertionError("parameters after AdamW differ")


# the loss term of the bf16 gates is taken over this many draws, draw k
# the parameters of seed 1 + k on batch k (the gradients' draw first): one
# draw's ratio swings (scripts/bf16_loss_spread.py: 0.08-15.6 around a
# median of ~1), and over batches alone one parameter draw still read 2.10
# (measured on the card, scripts/bf16_loss_spread.py): the draws vary both
BF16_LOSS_DRAWS = 8
BF16_ROUTES = (("kernels bf16", "auto", "bfloat16"),
               ("plain bf16", "reference", "bfloat16"),
               ("plain fp32", "reference", "float32"))


def loss_draws(cfg, batch, n=BF16_LOSS_DRAWS):
    """`batch` (numpy) and n - 1 more batches of its shape and objective,
    from corpus seeds 1 .. n - 1."""
    from repro_torch.data.pipeline import (DataState, SyntheticCorpus,
                                           make_causal_batch, make_mlm_batch)
    B, S = batch["tokens"].shape
    make = make_mlm_batch if cfg.objective == "mlm" else make_causal_batch
    return [batch] + [make(SyntheticCorpus(cfg.vocab_size, seed=s),
                           DataState(s, 0), batch=B, seq=S)
                      for s in range(1, n)]


def route_losses(cfg32, base, batch):
    """{route: loss} of the flat fp32 parameters `base` (cast per route) on
    `batch` (tensors), each BF16_ROUTES route, no gradients."""
    import torch
    from repro_torch.models import model as tmodel
    from repro_torch.models.transformer import nest
    out = {}
    for route, backend, dtype in BF16_ROUTES:
        c = dataclasses.replace(cfg32, dtype=dtype).with_attention_backend(
            backend)
        with torch.no_grad():
            leaves = nest({k: v.to(getattr(torch, dtype))
                           for k, v in base.items()})
            out[route] = tmodel.loss_fn(leaves, c, batch)[0].float().item()
    return out


def bf16_loss_errors(losses):
    """{route: [loss of each draw]} -> the kernel and the plain bf16
    routes' summed |loss - fp32 loss| over the draws."""
    ref = losses["plain fp32"]
    return {r: sum(abs(a - b) for a, b in zip(losses[r], ref))
            for r in ("kernels bf16", "plain bf16")}


def train_parity_bf16_phase(dev, cfg32, batch, tag):
    """The loss and every gradient leaf of the fp32 config `cfg32` on
    `batch` (numpy) through three routes from the same parameters (drawn in
    fp32, cast to bf16 for the bf16 routes): the kernels in bf16 (backend
    "auto": kernels 5 and 6 of the encoder, or kernels 1r and 2 of
    qwen3-8b, on the tensor cores), the plain reference in bf16 and the
    plain reference in fp32. Each gradient leaf's error against fp32, and
    the loss error summed over BF16_LOSS_DRAWS draws (the gradients' first,
    then the parameters of seed 1 + k on batch k of `loss_draws`), of the
    kernel route may be at most BF16_PARITY_FACTOR times the plain bf16
    route's, plus BF16_PARITY_ABS."""
    import numpy as np
    import torch
    from repro_torch.models import model as tmodel
    from repro_torch.models.transformer import flatten, nest
    draws = [{k: torch.from_numpy(v).to(dev) for k, v in b.items()}
             for b in loss_draws(cfg32, batch)]
    batch = draws[0]
    B, S = batch["tokens"].shape
    base = flatten(tmodel.init_params(cfg32, seed=1, device=dev))
    res, losses = {}, {}
    for route, backend, dtype in BF16_ROUTES:
        c = dataclasses.replace(cfg32, dtype=dtype).with_attention_backend(
            backend)
        leaves = {k: v.detach().to(getattr(torch, dtype)).requires_grad_(True)
                  for k, v in base.items()}
        reset_launches()
        loss, _ = tmodel.loss_fn(nest(leaves), c, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        launches = read_launches()
        used = {k: v for k, v in launches.items() if v}
        if bool(used) != (backend == "auto"):
            raise AssertionError(f"[{tag}] {route}: launches {used}")
        res[route] = {k: g.float() for k, g in zip(leaves, grads)}
        losses[route] = [loss.float().item()]
        log(f"  [{tag}] {route}: loss {loss.float().item():.6f}, launches "
            f"{used}")
        del leaves, grads, loss
    del base
    for k, b in enumerate(draws[1:], start=1):
        draw = route_losses(cfg32, flatten(tmodel.init_params(
            cfg32, seed=1 + k, device=dev)), b)
        for route, loss in draw.items():
            losses[route].append(loss)
    g32 = res["plain fp32"]
    lerr = bf16_loss_errors(losses)
    errs = {}
    for route in ("kernels bf16", "plain bf16"):
        g = res[route]
        errs[route] = {"loss": lerr[route]}
        errs[route].update({k: ((g[k] - g32[k]).norm()
                                / g32[k].norm().clamp_min(1e-30)).item()
                            for k in g32})
    ek, ep = errs["kernels bf16"], errs["plain bf16"]
    ratio = {k: ek[k] / (BF16_PARITY_FACTOR * ep[k] + BF16_PARITY_ABS)
             for k in ek}
    worst = max((k for k in ratio if k != "loss"), key=ratio.get)
    one = [abs(a - b) for a, b in zip(
        (losses[r][0] for r in ("kernels bf16", "plain bf16")),
        (losses["plain fp32"][0],) * 2)]
    log(f"[{tag}] {cfg32.num_layers}-layer, B={B}, S={S}, against fp32: "
        f"loss err summed over {len(draws)} draws kernels bf16 "
        f"{ek['loss']:.3e}, plain bf16 {ep['loss']:.3e} (ratio "
        f"{ek['loss'] / max(ep['loss'], 1e-30):.3f}; the gradients' draw "
        f"alone {one[0]:.3e} / {one[1]:.3e}); worst gradient leaf {worst}: "
        f"rel norm err kernels bf16 {ek[worst]:.3e}, plain bf16 "
        f"{ep[worst]:.3e}; median leaf ratio kernels / plain "
        f"{np.median([ek[k] / max(ep[k], 1e-30) for k in ek if k != 'loss']):.3f} "
        f"(tol {BF16_PARITY_FACTOR:g}x + {BF16_PARITY_ABS:g})")
    bad = [k for k, r in ratio.items() if not r <= 1.0]
    if bad:
        raise AssertionError(f"[{tag}] kernel route in bf16 beyond "
                             f"{BF16_PARITY_FACTOR}x the plain bf16 route: "
                             f"{ {k: (ek[k], ep[k]) for k in bad} }")


def train_mlm_phase(dev, tag="train-mlm", cfg=None, keep_params=False):
    """8 Trainer steps of an encoder config (default linformer-paper CONFIG
    at full width and depth; MLM, bf16, remat "full"), counted; then one
    forward alone under torch.no_grad and, where the config runs kernels 5
    and 6, one forward and one train step under torch.profiler, each
    profile's launches of kernels 5 and 6 equal to their counters'. The
    standard baseline launches no kernel of the port. Returns {launches,
    step_ms (median after the first step), fwd_ms, peak_gb, and with
    keep_params the params and the next MLM batch}."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import OptimizerConfig, TrainConfig
    from repro_torch.data.pipeline import DataState, batches
    from repro_torch.models import model as tmodel
    from repro_torch.models.transformer import flatten
    from repro_torch.optim import adamw_init
    from repro_torch.train import Trainer
    cfg = cfg or get_config("linformer-paper")
    steps = MLM_RUN["steps"]
    tcfg = TrainConfig(seq_len=MLM_RUN["seq"], global_batch=MLM_RUN["batch"],
                       steps=steps, log_every=1, checkpoint_every=0, seed=0,
                       optimizer=OptimizerConfig(lr=3e-4, warmup_steps=1,
                                                 total_steps=steps))
    a = cfg.attention
    exact = a.kind == "linformer"
    lin = a.linformer
    proj = (f"K={lin.k} ({lin.sharing} E"
            + (f", k_decay {lin.k_decay}: K per layer "
               f"{nonuniform_ks(lin.k, cfg.num_layers)}" if
               lin.k_decay < 1 and not cfg.scan_layers else "") + ")"
            if exact else "full softmax attention")
    log(f"[{tag}] {cfg.name}: {cfg.num_layers} layers "
        f"({'scanned' if cfg.scan_layers else 'unrolled, no remat'}), "
        f"d={cfg.d_model}, H={a.num_heads}, Dh={a.head_dim}, {a.kind}: "
        f"{proj}, vocab {cfg.padded_vocab_size}, {cfg.dtype}, remat "
        f"{cfg.remat if cfg.scan_layers else 'none'}, seq {tcfg.seq_len}, "
        f"global batch "
        f"{tcfg.global_batch}, {cfg.objective}, {steps} steps")
    t_phase = time.perf_counter()
    trainer = Trainer(cfg, tcfg, device=dev, log_fn=log)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    trainer.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    params = trainer._params
    n_params = sum(p.numel() for p in flatten(params).values())
    tokens = tcfg.global_batch * tcfg.seq_len
    for h in trainer.history:
        log(f"  step {h['step']}: loss {h['loss']:.4f}, grad norm "
            f"{h['grad_norm']:.4f}, {h['ms']:.1f} ms, "
            f"{1e3 * tokens / h['ms']:.1f} tokens/s "
            f"({h['tokens_per_s']:.1f} masked tokens/s)")
    log(f"  {n_params / 1e6:.2f} M params; run {wall:.1f} s (parameter init "
        f"included); peak memory {peak / 1e9:.2f} GB; launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    if len(trainer.history) != steps or not all(
            math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
            for h in trainer.history):
        raise AssertionError(f"non-finite or missing losses: "
                             f"{trainer.history}")
    if exact:
        # each layer launches kernel 5 once and kernel 6 twice (k and v) a
        # forward; remat "full" runs each block's forward again in the
        # backward, so a scanned run launches at least that many per step
        # and an unrolled one (no remat) exactly that many
        for name, per_layer in (("linformer_attn", 1), ("seq_projection", 2)):
            need = per_layer * cfg.num_layers * steps
            if launches[name] < need or (not cfg.scan_layers
                                         and launches[name] != need):
                raise AssertionError(
                    f"{name}: {launches[name]} launches on the {tag} path, "
                    f"expected {'' if not cfg.scan_layers else 'at least '}"
                    f"{need}")
        stray = [k for k, v in launches.items() if v and k not in
                 ("linformer_attn", "seq_projection")]
    else:
        stray = [k for k, v in launches.items() if v]
    if stray:
        raise AssertionError(f"{stray} launched on the {tag} path")

    stream = batches(trainer.corpus, DataState(tcfg.seed, steps),
                     batch=tcfg.global_batch, seq=tcfg.seq_len,
                     objective=cfg.objective)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in next(stream)[0].items()}

    def infer():
        with torch.no_grad():
            return tmodel.forward(params, cfg, batch)[0]

    logits = infer()
    if logits.shape != (*batch["tokens"].shape, cfg.padded_vocab_size) \
            or not torch.isfinite(logits).all():
        raise AssertionError(f"forward logits {tuple(logits.shape)} not "
                             "finite or misshapen")
    del logits
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        infer()
    torch.cuda.synchronize()
    fwd_ms = 1e3 * (time.perf_counter() - t0) / 3
    log(f"  forward alone (torch.no_grad, B={tcfg.global_batch}, "
        f"S={tcfg.seq_len}): {fwd_ms:.2f} ms, {1e3 * tokens / fwd_ms:.1f} "
        "tokens/s (mean of 3)")
    if exact:
        kernels, counted, _ = profile_kernels(infer)
        log_profile("forward", fwd_ms * 1e-3, kernels, top=8)
        require_profiled("forward", kernels, counted)
        state = adamw_init(params, tcfg.optimizer)
        step = trainer.train_step
        t0 = time.perf_counter()
        step(params, state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        kernels, counted, _ = profile_kernels(
            lambda: step(params, state, batch))
        log_profile(f"{tag} step", wall, kernels, top=16)
        require_profiled(f"{tag} step", kernels, counted)
        del state
    step_ms = sorted(h["ms"] for h in trainer.history[1:])
    res = dict(launches=launches, step_ms=step_ms[len(step_ms) // 2],
               fwd_ms=fwd_ms, peak_gb=peak / 1e9)
    if keep_params:
        res.update(params=params, batch=batch)
    del trainer, params
    log(f"  [{tag}] {time.perf_counter() - t_phase:.1f} s")
    return res


def serve_standard_phases(dev, cfg, params, prompts, mono_outs):
    """The paper's softmax baseline served: qwen3-8b at full width with
    kind "standard" (the same weights as [serve]; the Linformer E/F leaves
    ride along unused, as in examples/serve_batched.py) into the full KV
    cache, monolithic and then chunked admission (prefill_chunk=512):
    no kernel of the port launches, no remainder step runs; cache bytes
    per request against the compressed pool; one 16-step decode chunk of a
    full 4-row pool under the profiler."""
    import torch
    t_phase = time.perf_counter()
    cfg_std = cfg.with_attention_kind("standard")
    lin_bytes = serve_engine(dev, cfg, params).cache_bytes(4) // 4
    res = {}
    for tag, kw in (("serve-standard", {}),
                    ("serve-standard-chunked",
                     dict(prefill_chunk=SERVE_PREFILL_CHUNK))):
        eng = serve_engine(dev, cfg_std, params, **kw)
        run = run_serve(tag, eng, prompts, ())
        outs = run.outs
        ran = {k: v for k, v in run.launches.items() if v}
        if ran:
            raise AssertionError(f"{tag}: the port's kernels {ran} launched "
                                 "on the standard path")
        if "pool_prefill_remainder" in run.walls or eng._block() != 1:
            raise AssertionError(
                f"{tag}: remainder steps ran "
                f"({run.walls.get('pool_prefill_remainder')})")
        per_req = eng.cache_bytes(4) // 4
        log(f"  cache bytes per request (max_seq 4096, bf16): full "
            f"{per_req} ({per_req / 1e6:.1f} MB) against the compressed "
            f"pool's {lin_bytes} ({lin_bytes / 1e6:.1f} MB): "
            f"{per_req / lin_bytes:.2f}x")
        res[tag] = outs
        if kw:
            same = sum(a == b for a, b in zip(outs, res["serve-standard"]))
            log(f"  chunked vs monolithic (standard): {same} of "
                f"{len(outs)} requests token-identical")
        else:
            same = sum(a == b for a, b in zip(outs, mono_outs))
            log(f"  standard vs linformer_causal monolithic: {same} of "
                f"{len(outs)} requests token-identical (other attention, "
                "other tokens expected)")
            pool = eng.init_pool_cache(4)
            firsts = []
            for row, p in enumerate(prompts[:4]):
                slot_cache, first = eng.prefill_request(p)
                eng.write_pool_slot(pool, slot_cache, row)
                firsts.append(first)
            cur = torch.tensor(firsts, device=dev)
            fin = torch.zeros(4, dtype=torch.bool, device=dev)
            lengths = pool["lengths"].clone()

            def decode_chunk():
                pool["lengths"].copy_(lengths)
                eng.decode_chunk_fn(cur, fin, pool, 16)

            timed_profile("standard prefill", lambda: eng.prefill_request(
                prompts[4]))
            timed_profile("standard decode_chunk", decode_chunk)
            del pool
        del eng
    log(f"  [serve-standard] both serves {time.perf_counter() - t_phase:.1f}"
        " s")


def serve_standard_parity_phase(dev, cfg):
    """2-layer full-width fp32 qwen3-8b, kind "standard": chunked against
    monolithic admission (tokens), and the prefill forward's logits at
    every position against the plain decode-by-decode run over the full
    cache (LOGITS_TOL)."""
    import numpy as np
    import torch
    from repro_torch.models import model as tmodel
    from repro_torch.serving import ServingEngine
    t_phase = time.perf_counter()
    cfg2 = dataclasses.replace(cfg, num_layers=2, dtype="float32") \
        .with_attention_kind("standard")
    params2 = tmodel.init_params(cfg2, seed=1, device=dev)
    rng = np.random.default_rng(1)
    prompts2 = [list(map(int, rng.integers(4, cfg.vocab_size, n)))
                for n in (261, 521)]

    def engine(**kw):
        return ServingEngine(params2, cfg2, max_seq=4096, device=dev,
                             cache_dtype=torch.float32, decode_chunk=16,
                             **kw)

    mono = engine().serve(prompts2, 16, max_batch=2)
    chunked = engine(prefill_chunk=SERVE_PREFILL_CHUNK).serve(
        prompts2, 16, max_batch=2)
    log(f"[serve-standard-parity] 2-layer fp32: chunked admission "
        f"token-identical to monolithic: {chunked == mono}")
    if chunked != mono:
        raise AssertionError(f"chunked {chunked} vs monolithic {mono}")
    toks = torch.tensor([prompts2[0]], device=dev)
    with torch.no_grad():
        logits, _, _ = tmodel.forward(params2, cfg2, {"tokens": toks})
        cache = tmodel.init_cache(cfg2, batch=1, max_seq=4096,
                                  dtype=torch.float32, device=dev)
        steps = []
        for t in range(toks.shape[1]):
            lg, cache = tmodel.decode_step(params2, cfg2, toks[:, t:t + 1],
                                           cache)
            steps.append(lg[:, 0])
    dl = (logits[0] - torch.stack(steps, dim=1)[0]).abs().max().item()
    log(f"  prefill logits at all {toks.shape[1]} positions against "
        f"decode step by step: max |diff| = {dl:.3e} (tol {LOGITS_TOL:g}); "
        f"{time.perf_counter() - t_phase:.1f} s")
    if not dl <= LOGITS_TOL or not torch.isfinite(logits).all():
        raise AssertionError(f"standard prefill vs decode: {dl}")


def figure1_phase(dev, cfg, params, batch):
    """Paper Figure 1 on the card (core/low_rank.py): P = softmax(QKᵀ/√d)
    per layer and head of the [train-mlm-standard] model at n = 512 for
    the first sequence of an MLM batch, the cumulative singular-value mass
    at rank 128 (mean over heads, per layer), and the JL (Theorem 1) and
    Theorem-2 errors at k = 128 for the first head of the first and last
    layers."""
    import torch
    from repro_torch.core import low_rank
    from repro_torch.models import attention as attn_lib
    from repro_torch.models import layers as L
    from repro_torch.models import transformer
    from repro_torch.parallel import plan as plan_lib
    t_phase = time.perf_counter()
    plan = plan_lib.resolve_attention_plan(cfg.attention)
    gen = torch.Generator(device=dev).manual_seed(0)
    energy, ranks, errs = [], [], {}
    with torch.no_grad():
        x = transformer.embed_inputs(params, cfg,
                                     {"tokens": batch["tokens"][:1]})
        S = x.shape[1]
        k = min(128, S)                 # the paper's 128 of n = 512
        for i in range(cfg.num_layers):
            lp = transformer.layer_params(params, i)
            q, kk, v = attn_lib.project_qkv(
                lp["attn"], L.rms_norm(lp["ln1"], x), cfg.attention, None)
            qh, kh, vh = (t[0].transpose(0, 1).float() for t in (q, kk, v))
            P = low_rank.context_mapping(qh, kh)              # (H, S, S)
            energy.append(low_rank.energy_at_rank(P, k).mean().item())
            ranks.append(low_rank.rank_for_energy(P, 0.9).float().mean()
                         .item())
            if i in (0, cfg.num_layers - 1):
                w = torch.randn(S, generator=gen, device=dev)
                a_row = (qh[0] @ kh[0].T)[0] * cfg.attention.head_dim ** -0.5
                e2, ref = low_rank.theorem2_error(gen, a_row, vh[0], k)
                errs[i] = (low_rank.jl_projection_error(gen, P[0], w,
                                                        k).item(),
                           (e2 / ref).item())
            x, _ = transformer.apply_block(lp, x, cfg, shared_lin=None,
                                           plan=plan)
    torch.cuda.synchronize()
    log(f"[figure1] {cfg.name} standard, n={S}: cumulative singular-value "
        f"mass at rank {k} per layer (mean of {cfg.attention.num_heads} "
        f"heads): {[round(e, 4) for e in energy]}; mean rank for 90% of "
        f"the mass per layer: {[round(r, 1) for r in ranks]}")
    for i, (jl, t2) in errs.items():
        log(f"  layer {i}, head 0, k={k}: JL error ||P RᵀR w - P w|| / "
            f"||P w|| = {jl:.4f}; Theorem-2 relative error {t2:.4f}")
    log(f"  these describe the [train-mlm-standard] model after "
        f"{MLM_RUN['steps']} steps from a random init, near its init: not "
        f"the paper's pretrained RoBERTa; {time.perf_counter() - t_phase:.1f}"
        " s")
    if not all(math.isfinite(e) and 0 < e <= 1 + 1e-6 for e in energy) \
            or not all(math.isfinite(a) for v in errs.values() for a in v):
        raise AssertionError(f"figure1: energies {energy}, errors {errs}")


# [table3]: paper Table 3, linformer-paper CONFIG at max_seq_len = n, the
# forward alone; 16 k tokens a batch (B = 16384 / n), Linformer alone at
# n >= 32768 (B = 1): standard's fp32 scores would need B·12·n²·4 bytes
TABLE3 = dict(ns=(512, 1024, 2048, 4096, 8192, 16384),
              long_ns=(32768, 65536), ks=(128, 256), tokens=16384, reps=5)


def table3_cfg(n, kind, k=128):
    """linformer-paper CONFIG at max_seq_len n with the attention kind and
    k replaced (benchmarks/figure3_pretrain.py `_cfg`, full width)."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("linformer-paper"), max_seq_len=n)
    att = dataclasses.replace(cfg.attention, kind=kind,
                              linformer=dataclasses.replace(
                                  cfg.attention.linformer, k=k))
    return dataclasses.replace(cfg, attention=att)


def table3_forward(dev, cfg, B, n):
    """(median ms of TABLE3["reps"] forwards under torch.no_grad by CUDA
    events after a warm-up, their peak bytes above the weights and inputs,
    the peak of one forward of the encoder stack alone, return_hidden: the
    (B, n, 50432) bf16 logits of the LM head, 1.65 GB at 16 k tokens,
    are the same for both kinds and hide the attention's memory at small
    n). The launch counters are reset just before every forward and read
    just after it: a Linformer forward launches kernel 5 once and kernel 6
    twice a layer, a standard one no kernel of the port."""
    import torch
    from repro_torch.models import model as tmodel
    params = tmodel.init_params(cfg, seed=0, device=dev)
    g = torch.Generator(device=dev).manual_seed(n)
    toks = torch.randint(4, cfg.vocab_size, (B, n), generator=g, device=dev)
    kind = cfg.attention.kind
    want = {"linformer_attn": cfg.num_layers,
            "seq_projection": 2 * cfg.num_layers} if kind == "linformer" \
        else {}

    def fwd(**kw):
        with torch.no_grad():
            return tmodel.forward(params, cfg, {"tokens": toks}, **kw)[0]

    def require_counts(what):
        ran = {k: v for k, v in read_launches().items() if v}
        if ran != want:
            raise AssertionError(f"[table3] {kind} n={n} {what}: launches "
                                 f"{ran}, expected {want}")

    reset_launches()
    out = fwd()
    require_counts("first forward")
    if out.shape != (B, n, cfg.padded_vocab_size) \
            or not torch.isfinite(out).all():
        raise AssertionError(f"[table3] {cfg.attention.kind} n={n}: logits "
                             f"{tuple(out.shape)} not finite or misshapen")
    del out
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(TABLE3["reps"]):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        reset_launches()
        e0.record()
        out = fwd()
        e1.record()
        require_counts(f"timed forward {i}")
        del out
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    peak = torch.cuda.max_memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    out = fwd(return_hidden=True)
    require_counts("stack forward")
    torch.cuda.synchronize()
    del out
    stack = torch.cuda.max_memory_allocated() - base
    del params, toks
    torch.cuda.empty_cache()
    return sorted(times)[len(times) // 2], peak, stack


def table3_attention(dev, B, n, ks, with_standard):
    """One layer's attention alone at (B, n, H=12, Dh=64) in bf16 by
    CUDA-graph replay: the port's standard_attention (materialises the
    scores, as the paper's baseline), the Linformer kernel route (kernel 6
    for k, kernel 6 for v, kernel 5) per k, and one
    F.scaled_dot_product_attention call (a yardstick only, never on the
    port's path)."""
    import torch
    import torch.nn.functional as Fn
    from repro_torch.models import attention as attn_lib
    from repro_torch.parallel import plan as plan_lib
    H, Dh = 12, 64
    plan = plan_lib.resolve_attention_plan(table3_cfg(n, "linformer")
                                           .attention)
    g = torch.Generator(device=dev).manual_seed(n + 1)
    sets = [[torch.randn(B, n, H, Dh, generator=g, device=dev)
             .to(torch.bfloat16) for _ in range(3)] for _ in range(2)]
    iters = 60 if n <= 2048 else 12
    out = {}
    with torch.no_grad():
        if with_standard:
            out["standard"] = time_graph_ms(
                lambda i: attn_lib.standard_attention(*sets[i],
                                                      causal=False),
                2, iters=max(3, iters // 4))
            torch.cuda.empty_cache()
        out["sdpa"] = time_graph_ms(
            lambda i: Fn.scaled_dot_product_attention(
                *(t.transpose(1, 2) for t in sets[i])), 2, iters=iters)
        for k in ks:
            E = (torch.randn(n, k, generator=g, device=dev) * k ** -0.5) \
                .to(torch.bfloat16)
            out[k] = time_graph_ms(
                lambda i: plan.exact_attention(
                    *sets[i], E, E, projection="linear", scale=Dh ** -0.5),
                2, iters=iters)
    del sets
    torch.cuda.empty_cache()
    return out


def table3_phase(dev):
    """Paper Table 3 on the card: the forward alone of linformer-paper at
    full width and depth for the standard baseline and Linformer at k in
    TABLE3["ks"] over n, 16 k tokens a batch; ms, tokens/s, peak memory
    above the weights, time saved and memory saved (standard ÷ Linformer),
    and one layer's attention alone (standard, the kernel route, SDPA)."""
    import torch
    t_phase = time.perf_counter()
    log(f"[table3] linformer-paper CONFIG at max_seq_len = n (12 layers, "
        f"d=768, H=12, Dh=64, layerwise E, learned positions), bf16, "
        f"forward alone under torch.no_grad, median of {TABLE3['reps']} "
        f"after a warm-up; B = {TABLE3['tokens']} / n; every forward's "
        "launch counters read: 12 of kernel 5 and 24 of kernel 6 a "
        "Linformer forward, none a standard one")
    rows = []
    for n in TABLE3["ns"] + TABLE3["long_ns"]:
        B = max(1, TABLE3["tokens"] // n)
        tok = B * n
        with_std = n in TABLE3["ns"]
        cell = {"n": n, "B": B}
        if with_std:
            cell["standard"] = table3_forward(
                dev, table3_cfg(n, "standard"), B, n)
        else:
            log(f"  n={n}: standard not run; its fp32 scores alone would "
                f"need B·12·n²·4 = {B * 12 * n * n * 4 / 1e9:.1f} GB per "
                "tensor")
        for k in TABLE3["ks"]:
            cell[k] = table3_forward(dev, table3_cfg(n, "linformer", k),
                                     B, n)
        att = table3_attention(dev, B, n, TABLE3["ks"], with_std)
        parts = []
        if with_std:
            ms, peak, stack = cell["standard"]
            parts.append(f"standard {ms:.2f} ms, {1e3 * tok / ms:.0f} tok/s,"
                         f" peak {peak / 1e9:.3f} GB (stack alone "
                         f"{stack / 1e9:.3f})")
        for k in TABLE3["ks"]:
            ms, peak, stack = cell[k]
            ratio = ""
            if with_std:
                sms, speak, sstack = cell["standard"]
                ratio = (f", time saved {sms / ms:.2f}x, memory saved "
                         f"{speak / peak:.2f}x (stack alone "
                         f"{sstack / stack:.2f}x)")
            parts.append(f"k={k} {ms:.2f} ms, {1e3 * tok / ms:.0f} tok/s, "
                         f"peak {peak / 1e9:.3f} GB (stack alone "
                         f"{stack / 1e9:.3f}){ratio}")
        log(f"  n={n} B={B}: " + "; ".join(parts))
        line = (f"    one layer's attention (graph replay): sdpa "
                f"{att['sdpa']:.4f} ms")
        if with_std:
            line += f", standard_attention {att['standard']:.4f} ms"
        for k in TABLE3["ks"]:
            line += (f"; kernels 6+6+5 at k={k} {att[k]:.4f} ms ("
                     + (f"standard/this {att['standard'] / att[k]:.2f}x, "
                        if with_std else "")
                     + f"sdpa/this {att['sdpa'] / att[k]:.2f}x)")
        log(line)
        cell["attention"] = att
        rows.append(cell)
    labels = {"standard": "standard", **{k: f"k{k}" for k in TABLE3["ks"]}}
    log("[table3] summary " + json.dumps([
        {"n": c["n"], "B": c["B"],
         **{f"{label}_{what}": c[kind][i]
            for kind, label in labels.items() if kind in c
            for i, what in enumerate(("ms", "peak_bytes",
                                      "stack_peak_bytes"))},
         "attention_ms": {labels.get(a, a): t
                          for a, t in c["attention"].items()}}
        for c in rows]))
    log(f"  [table3] {time.perf_counter() - t_phase:.1f} s")


# -- the other dense configs, the frontends, the per-token baseline and
# checkpoint-restored serving ------------------------------------------------

DENSE_ARCHS = ("qwen3-14b", "nemotron-4-15b", "qwen1.5-110b")
FRONTEND_ARCHS = ("internvl2-2b", "musicgen-large")
# [serve-dense]: the depth each config is served at, cut for the run's time
# limit (qwen3-14b has 40 layers, nemotron-4-15b 32, qwen1.5-110b 80 at
# 2.72 GB a layer in bf16, of which 22 fit the card beside the pools)
SERVE_DENSE_LAYERS = {"qwen3-14b": 8, "nemotron-4-15b": 8,
                      "qwen1.5-110b": 8}
SERVE_DENSE_BLOCKS = (1, 2, 3, 4, 1, 2, 3, 4)   # prompt lengths, in blocks
SERVE_DENSE_NEW = 16
# [train-dense]: the depth at which bf16 params and gradients, fp32 AdamW
# moments (12 bytes a parameter), the clip's second gradient copy and the
# update's fp32 temporaries of the largest leaf fit on the card beside the
# activations of one 4096-token row
TRAIN_DENSE_LAYERS = {"qwen3-14b": 8, "nemotron-4-15b": 2,
                      "qwen1.5-110b": 1}
TRAIN_DENSE_RUN = dict(seq=4096, batch=1, steps=2)
# [frontends]: the forward and cache build over S tokens (internvl2-2b: its
# 256 patch embeddings and S - 256 text tokens; musicgen-large: S frames),
# decode steps, and the train steps' batch
FRONTEND_RUN = dict(batch=2, seq=1024, decode=16, train_batch=2,
                    train_seq=4096, steps=2)
# [per-token]: [serve]'s model and prompts of whole blocks
PER_TOKEN_RUN = dict(batch=4, prompt=1024, new=32)


def serve_dense_phase(dev, arch):
    """[serve-dense]: the config at full width (cut in depth as
    SERVE_DENSE_LAYERS says), random bf16 weights (seed 0), 8 requests of
    256·SERVE_DENSE_BLOCKS prompt tokens (whole blocks: no remainder step)
    and SERVE_DENSE_NEW new tokens, served twice: monolithic into the
    dense pool (kernels 1 and 3), then chunked (P = 512) into the paged
    int8 pool (kernels 8 and 7). Returns {path: launches}."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as tmodel
    from repro_torch.models.transformer import param_bytes
    full = get_config(arch)
    cfg = full if SERVE_DENSE_LAYERS[arch] is None else dataclasses.replace(
        full, num_layers=SERVE_DENSE_LAYERS[arch])
    a = cfg.attention
    log(f"[serve-dense] {arch}: {cfg.num_layers} of {full.num_layers} "
        f"layers, d={cfg.d_model}, H={a.num_heads}/{a.num_kv_heads} (G="
        f"{a.q_per_kv}), Dh={a.head_dim}, d_ff={cfg.mlp.d_ff} "
        f"{cfg.mlp.activation}, qk_norm {a.qk_norm}, qkv_bias {a.qkv_bias}, "
        f"vocab {cfg.padded_vocab_size}, {cfg.dtype}")
    t0 = time.perf_counter()
    params = tmodel.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    log(f"  params: {param_bytes(params) / 1e9:.2f} GB in "
        f"{time.perf_counter() - t0:.1f} s")
    c = a.linformer.block_size
    rng = np.random.default_rng(0)
    prompts = [list(map(int, rng.integers(4, cfg.vocab_size, n * c)))
               for n in SERVE_DENSE_BLOCKS]
    launches, outs = serve_modes(dev, cfg, arch, "serve-dense", params,
                                 prompts, ("dense", "paged"))
    agree = sum(sum(x == y for x, y in zip(p, q))
                for p, q in zip(outs["dense"], outs["paged"]))
    log(f"  paged int8 chunked vs dense monolithic: {agree} of "
        f"{sum(map(len, outs['dense']))} tokens equal position by position "
        "(int8 slots and other GEMM shapes round differently)")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def require_pages_free(tag, sched):
    """Clean page accounting after a paged serve: every page back in the
    free list. (A helper, so that no caller keeps the allocator, which
    holds its engine and so the weights, alive.)"""
    alloc = sched.pool.alloc
    alloc.check()
    if alloc.free_pages != alloc.usable_pages:
        raise AssertionError(f"{tag}: "
                             f"{alloc.usable_pages - alloc.free_pages} pages "
                             "leaked")


def train_dense_phase(dev, arch):
    """[train-dense]: TRAIN_DENSE_RUN["steps"] Trainer steps of the config
    at full width cut to TRAIN_DENSE_LAYERS (bf16, remat "full", seq 4096,
    batch 1), launch counters reset just before and read just after:
    kernels 1, 1r and 2 on the tensor cores, once a layer a step each."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import OptimizerConfig, TrainConfig
    full = get_config(arch)
    cfg = dataclasses.replace(full, num_layers=TRAIN_DENSE_LAYERS[arch])
    run = TRAIN_DENSE_RUN
    tcfg = TrainConfig(seq_len=run["seq"], global_batch=run["batch"],
                       steps=run["steps"], log_every=1, checkpoint_every=0,
                       seed=0, optimizer=OptimizerConfig(
                           lr=3e-4, warmup_steps=1,
                           total_steps=run["steps"]))
    log(f"[train-dense] {arch} cut to {cfg.num_layers} of "
        f"{full.num_layers} layers, G={cfg.attention.q_per_kv}, "
        f"vocab {cfg.padded_vocab_size}, {cfg.dtype}, remat {cfg.remat}, "
        f"seq {tcfg.seq_len}, batch {tcfg.global_batch}, {tcfg.steps} "
        "steps")
    trainer, launches = counted_train(f"train-dense {arch}", dev, cfg, tcfg)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def grad_parity_phase(dev, cfg2, batch, tag):
    """The loss and every gradient leaf of the fp32 config `cfg2` on
    `batch` (numpy) through the plain reference and then through the
    kernels, from the same parameters, within TRAIN_LOSS_RTOL and
    TRAIN_GRAD_RTOL (relative norm error), as [train-parity]. For models
    whose fp32 parameters, two gradient copies and AdamW moments do not fit
    on the card at once: the reference's gradients wait in host memory and
    are compared leaf by leaf, and the AdamW update is not compared."""
    import torch
    from repro_torch.models import model as tmodel
    from repro_torch.models.transformer import flatten, param_bytes
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    B, S = batch["labels"].shape
    ref, errs = None, {}
    torch.cuda.reset_peak_memory_stats()
    for backend in ("reference", "auto"):
        c = cfg2.with_attention_backend(backend)
        params = tmodel.init_params(c, seed=1, device=dev)
        leaves = flatten(params)
        for p in leaves.values():
            p.requires_grad_(True)
        if ref is None:
            log(f"  [{tag}] params {param_bytes(params) / 1e9:.2f} GB")
        reset_launches()
        loss, _ = tmodel.loss_fn(params, c, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        launches = read_launches()
        log(f"  [{tag}] {backend}: loss {loss.item():.6f}, launches "
            f"{ {k: v for k, v in launches.items() if v} }")
        if ref is None:
            ref = (loss.item(), {k: g.cpu() for k, g in zip(leaves, grads)})
        else:
            for k, g in zip(leaves, grads):
                want = ref[1][k].to(dev)
                errs[k] = ((g - want).norm() / want.norm()).item()
            loss_a = loss.item()
        del params, leaves, grads, loss
        torch.cuda.empty_cache()
    loss_err = abs(loss_a - ref[0]) / abs(ref[0])
    worst = max(errs, key=errs.get)
    log(f"[{tag}] {cfg2.num_layers}-layer fp32, B={B}, S={S}: loss rel err "
        f"{loss_err:.2e} (tol {TRAIN_LOSS_RTOL:g}); worst gradient leaf "
        f"{worst} of {len(errs)} rel norm err {errs[worst]:.2e} (tol "
        f"{TRAIN_GRAD_RTOL:g}); peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    if not math.isfinite(loss_a) or not loss_err <= TRAIN_LOSS_RTOL:
        raise AssertionError(f"losses differ: {loss_a} vs {ref[0]}")
    if not errs[worst] <= TRAIN_GRAD_RTOL:
        raise AssertionError(f"gradient {worst} differs: {errs[worst]}")


def frontend_batch(cfg, B, S, seed):
    """A numpy batch of S positions for a frontend config: frame
    embeddings (audio) or patch embeddings and S - P text tokens (vlm),
    labels and a loss mask over the text positions."""
    import numpy as np
    rng = np.random.default_rng(seed)
    D = cfg.d_model
    if cfg.embedding_inputs:
        text = S
        b = {"embeds": rng.standard_normal((B, S, D), np.float32)}
    else:
        text = S - cfg.frontend_embed_len
        b = {"tokens": rng.integers(4, cfg.vocab_size, (B, text)),
             "frontend_embeds": rng.standard_normal(
                 (B, cfg.frontend_embed_len, D), np.float32)}
    b["labels"] = rng.integers(4, cfg.vocab_size, (B, text))
    b["loss_mask"] = np.ones((B, text), np.int32)
    return b


def frontend_decode(params, cfg, cache, B, n, seed, dev):
    """n decode steps from a prefilled cache, fed seeded random inputs:
    tokens for a token config, (B, 1, D) frame embeddings for an
    embedding-input one. Returns (the steps' logits (B, n, V), cache)."""
    import torch
    from repro_torch.models import model as tmodel
    g = torch.Generator(device=dev).manual_seed(seed)
    out = []
    for _ in range(n):
        if cfg.embedding_inputs:
            e = torch.randn(B, 1, cfg.d_model, generator=g, device=dev)
            lg, cache = tmodel.decode_step(params, cfg, None, cache,
                                           embeds=e)
        else:
            tok = torch.randint(4, cfg.vocab_size, (B, 1), generator=g,
                                device=dev)
            lg, cache = tmodel.decode_step(params, cfg, tok, cache)
        out.append(lg[:, 0])
    return torch.stack(out, 1), cache


def frontend_phase(dev, arch):
    """[frontends]: the config whole in bf16 (random weights, seed 0): a
    forward that builds the cache over FRONTEND_RUN["seq"] positions,
    decode steps (seeded random tokens, or frame embeddings), then train
    steps through
    make_train_step (the Trainer's corpus holds tokens only) at batch 2 ×
    4096, launch counters reset around each; then the 2-layer fp32 cut
    against the plain reference route: the forward's and the decode
    steps' logits within LOGITS_TOL, and one train step as
    [train-parity]. Returns {path: launches}."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.models import model as tmodel
    from repro_torch.models.transformer import flatten, param_bytes
    from repro_torch.optim import adamw_init
    from repro_torch.train import make_train_step
    cfg = get_config(arch)
    a, run = cfg.attention, FRONTEND_RUN
    log(f"[frontends] {arch} ({cfg.family}): {cfg.num_layers} layers, d="
        f"{cfg.d_model}, H={a.num_heads}/{a.num_kv_heads} (G={a.q_per_kv}), "
        f"Dh={a.head_dim}, {cfg.mlp.activation}, vocab "
        f"{cfg.padded_vocab_size}, frontend_embed_len "
        f"{cfg.frontend_embed_len}, embedding_inputs {cfg.embedding_inputs}")
    params = tmodel.init_params(cfg, seed=0, device=dev)
    log(f"  params: {param_bytes(params) / 1e9:.2f} GB")
    to_dev = lambda b: {k: torch.from_numpy(v).to(dev)  # noqa: E731
                        for k, v in b.items()}
    B, S = run["batch"], run["seq"]
    inputs = {k: v for k, v in to_dev(frontend_batch(cfg, B, S, 0)).items()
              if k in ("tokens", "embeds", "frontend_embeds")}
    launches = {}
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, _, cache = tmodel.forward(params, cfg, inputs,
                                          return_cache=True,
                                          cache_max_seq=4096)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        steps, cache = frontend_decode(params, cfg, cache, B,
                                       run["decode"], 1, dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches[f"frontends-infer {arch}"] = n = read_launches()
    log(f"  forward + cache over {B}×{S} ({cfg.frontend_embed_len} frontend "
        f"positions a row): {1e3 * (t1 - t0):.1f} ms; {run['decode']} decode "
        f"steps on {'embeddings' if cfg.embedding_inputs else 'tokens'}: "
        f"{1e3 * (t2 - t1) / run['decode']:.2f} ms a step; peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches "
        f"{ {k: v for k, v in n.items() if v} }")
    if logits.shape != (B, S, cfg.padded_vocab_size) \
            or not torch.isfinite(logits).all() \
            or not torch.isfinite(steps).all():
        raise AssertionError(f"{arch}: logits {tuple(logits.shape)} or "
                             "non-finite values")
    if cache["lengths"].tolist() != [S + run["decode"]] * B:
        raise AssertionError(f"cache lengths {cache['lengths'].tolist()}")
    if n["blockwise_causal_attn"] < cfg.num_layers \
            or n["decode_attn"] < cfg.num_layers * run["decode"]:
        raise AssertionError(f"{arch}: kernels 1 and 3 launched {n}")
    del logits, cache, steps

    # train steps, batch 2 × 4096
    for p in flatten(params).values():
        p.requires_grad_(True)
    opt = OptimizerConfig(lr=3e-4, warmup_steps=1, total_steps=run["steps"])
    state = adamw_init(params, opt)
    step = make_train_step(cfg, opt)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    ms = []
    for i in range(run["steps"]):
        batch = to_dev(frontend_batch(cfg, run["train_batch"],
                                      run["train_seq"], 10 + i))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, met = step(params, state, batch)
        loss = float(met["loss"])
        ms.append(1e3 * (time.perf_counter() - t0))
        log(f"  train step {i + 1}: loss {loss:.4f}, grad norm "
            f"{float(met['grad_norm']):.4f}, {ms[-1]:.1f} ms")
        if not math.isfinite(loss):
            raise AssertionError(f"{arch}: non-finite loss")
    launches[f"frontends-train {arch}"] = n = read_launches()
    log(f"  train batch {run['train_batch']}×{run['train_seq']}: peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches "
        f"{ {k: v for k, v in n.items() if v} }")
    need = cfg.num_layers * run["steps"]
    for name in ("blockwise_causal_attn",
                 "blockwise_causal_attn(return_residuals)",
                 "blockwise_causal_attn_bwd"):
        if n[name] < need:
            raise AssertionError(f"{arch}: {name} launched {n[name]} times, "
                                 f"expected {need}")
    require_routes(f"frontends {arch}", "tensor cores")
    del params, state
    gc.collect()
    torch.cuda.empty_cache()

    # 2-layer fp32: kernels against the plain reference
    cfg2 = dataclasses.replace(cfg, num_layers=2, dtype="float32")
    got = {}
    for backend in ("auto", "reference"):
        c2 = cfg2.with_attention_backend(backend)
        p2 = tmodel.init_params(c2, seed=1, device=dev)
        with torch.no_grad():
            lg, _, cache = tmodel.forward(p2, c2, inputs, return_cache=True,
                                          cache_max_seq=4096,
                                          cache_dtype=torch.float32)
            steps, _ = frontend_decode(p2, c2, cache, B, 8, 1, dev)
        got[backend] = (lg, steps)
        del p2, cache
    dl = max((x - y).abs().max().item()
             for x, y in zip(got["auto"], got["reference"]))
    log(f"[frontends-parity] {arch} 2-layer fp32: forward and 8 decode "
        f"steps' logits max |auto - reference| = {dl:.3e} (tol "
        f"{LOGITS_TOL:g})")
    if not dl <= LOGITS_TOL:
        raise AssertionError(f"{arch}: logits differ by {dl}")
    del got
    torch.cuda.empty_cache()
    train_parity_phase(dev, cfg2, frontend_batch(cfg2, 1, TRAIN_PARITY_SEQ,
                                                 20),
                       f"frontends-parity {arch}")
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def per_token_phase(dev, cfg, params):
    """[per-token]: [serve]'s model, PER_TOKEN_RUN["batch"] prompts of
    1024 tokens, 32 new: the per-token loop (one host round trip a token)
    against the device-resident chunks of generate_batch (decode_chunk
    16): equal tokens; prefill and decode walls, tok/s and launches of
    each, after one warm-up call of each."""
    import numpy as np
    import torch
    run = PER_TOKEN_RUN
    eng = serve_engine(dev, cfg, params)
    toks = np.random.default_rng(5).integers(
        4, cfg.vocab_size, (run["batch"], run["prompt"]))
    res = {}
    for name, decode in (("scan", eng.decode_tokens),
                         ("per-token", eng.decode_tokens_per_token)):
        cache, logits = eng.prefill(toks)
        decode(cache, logits, 4)                           # warm-up
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        cache, logits = eng.prefill(toks)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = decode(cache, logits, run["new"])
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        n = read_launches()
        res[name] = (out, t2 - t1)
        log(f"[per-token] {name}: prefill {run['batch']}×{run['prompt']} "
            f"{1e3 * (t1 - t0):.1f} ms, decode {run['new']} tokens "
            f"{1e3 * (t2 - t1):.1f} ms: "
            f"{run['batch'] * run['new'] / (t2 - t1):.1f} tok/s; launches "
            f"{ {k: v for k, v in n.items() if v} }")
        require_launches(n, ("blockwise_causal_attn", "decode_attn"),
                         f"per-token {name}")
        del cache, logits
    same = np.array_equal(res["scan"][0], res["per-token"][0])
    log(f"  per-token decode wall / scan decode wall "
        f"{res['per-token'][1] / res['scan'][1]:.3f}; tokens equal: {same}")
    if not same:
        raise AssertionError("per-token and scan tokens differ")
    del eng


def serve_ckpt_phase(dev):
    """[serve-ckpt]: the Trainer takes two steps of qwen3-8b SMOKE in bf16
    on the card and saves; the serve launcher with --ckpt-dir serves the
    latest step (its SMOKE config in fp32) and must give the tokens of an
    engine built the same way over the trainer's in-memory params."""
    import tempfile
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import OptimizerConfig, TrainConfig
    from repro_torch.launch import serve as serve_launch
    from repro_torch.models.transformer import flatten, nest
    from repro_torch.serving import ServingEngine
    from repro_torch.train import Trainer
    cfg = get_smoke_config("qwen3-8b")
    requests, new = 8, 16
    with tempfile.TemporaryDirectory() as d:
        tcfg = TrainConfig(seq_len=64, global_batch=8, steps=2,
                           checkpoint_every=1, checkpoint_dir=d, log_every=1,
                           optimizer=OptimizerConfig(lr=1e-2, warmup_steps=1,
                                                     total_steps=2))
        trainer = Trainer(cfg, tcfg, device=dev, log_fn=log)
        trainer.run()
        reset_launches()
        outs = serve_launch.main([
            "--arch", "qwen3-8b", "--smoke", "--device", dev.type,
            "--ckpt-dir", d, "--requests", str(requests),
            "--max-new-tokens", str(new)])
        launches = read_launches()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = nest({k: v.detach().float()
                     for k, v in flatten(trainer._params).items()})
    c = cfg.attention.linformer.block_size
    eng = ServingEngine(params32, cfg32, max_seq=16 * c, device=dev,
                        cache_dtype=torch.float32, decode_chunk=32)
    want = eng.serve(serve_launch.synthetic_prompts(cfg.vocab_size,
                                                    eng._block(), requests),
                     new, max_batch=4)
    log(f"[serve-ckpt] {cfg.name} bf16, 2 Trainer steps saved and served "
        f"through --ckpt-dir: {sum(map(len, outs))} tokens, equal to the "
        f"in-memory params' engine: {outs == want}; launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    require_launches(launches, ("blockwise_causal_attn", "decode_attn"),
                     "serve-ckpt")
    if outs != want:
        raise AssertionError(f"--ckpt-dir tokens {outs} vs {want}")


# -- the examples ---------------------------------------------------------------

# [examples]: examples_torch/ on the card, each on its default device.
# train_mlm at the paper's width, EXAMPLES_MLM_STEPS[0] steps and then into
# the same --ckpt-dir with --steps EXAMPLES_MLM_STEPS[1], which resumes at
# the first run's last step (a rerun at the same --steps has nothing left
# to train, and the JAX example then fails reading its empty metrics)
EXAMPLES_MLM = ["--layers", "12", "--d-model", "768", "--heads", "12",
                "--seq", "512", "--k", "128"]
EXAMPLES_MLM_STEPS = (20, 40)
# the cache bytes quickstart and serve_batched print, which depend on their
# configs alone (tests/test_torch_examples.py holds them to the JAX
# package's): quickstart's 2-row pool at max_seq 128; serve_batched's
# compressed and full-KV 4-row pools at max_seq 256
EXAMPLES_CACHE_BYTES = {"quickstart": 49160,
                        "serve_batched": (163856, 524304)}


def kernel_wrappers():
    """{(module, wrapper name): counter attributes} of every wrapper in
    LAUNCH_COUNTERS."""
    out = collections.defaultdict(list)
    for _, mod, fn, attr in LAUNCH_COUNTERS:
        out[mod, fn].append(attr)
    return dict(out)


def _signature(x):
    import torch
    if isinstance(x, torch.Tensor):
        return ("tensor", tuple(x.shape), str(x.dtype))
    if isinstance(x, dict):
        return tuple(sorted((k, _signature(v)) for k, v in x.items()))
    if isinstance(x, (list, tuple)):
        return tuple(_signature(v) for v in x)
    return x


def _map_tensors(x, fn):
    import torch
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, dict):
        return {k: _map_tensors(v, fn) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_map_tensors(v, fn) for v in x)
    return x


class KernelCalls:
    """Within `with KernelCalls() as calls:` every kernel wrapper is
    replaced by one that keeps a copy of the inputs of its first call at
    each signature (shapes, dtypes, the other arguments) in `calls.first`,
    counts its calls by wrapper in `calls.count`, and calls the wrapper. A
    wrapper's body counts its launches on its module's name, so the
    counters read inside (read_launches) are the replacements', from 0."""

    def __init__(self):
        self.first, self.count, self._saved = {}, collections.Counter(), []

    def __enter__(self):
        from repro_torch.kernels import blockwise_causal_attn as bca
        from repro_torch.kernels import linformer_attn as la
        from repro_torch.kernels import seq_projection as sp
        mods = {"bca": bca, "la": la, "sp": sp}
        for (m, fn), attrs in kernel_wrappers().items():
            mod, orig = mods[m], getattr(mods[m], fn)

            def wrapper(*args, _orig=orig, _fn=fn, **kw):
                key = (_fn, _signature(args), _signature(kw))
                if key not in self.first:
                    self.first[key] = (_orig, *_map_tensors(
                        (args, kw), lambda t: t.detach().clone()))
                self.count[_fn] += 1
                return _orig(*args, **kw)

            for attr in attrs:
                setattr(wrapper, attr, 0)
            setattr(mod, fn, wrapper)
            self._saved.append((mod, fn, orig))
        return self

    def __exit__(self, *exc):
        for mod, fn, orig in self._saved:
            setattr(mod, fn, orig)
        self._saved.clear()
        return False

    def check(self, tag):
        """Each kept call again on the card and through the wrapper on CPU
        copies of its inputs (its plain twin): the forward's output within
        FP32_TOL (check), the residuals and gradients within GRAD_TOL
        (check_grad). Returns the number of shapes held."""
        for (fn, sig, _), (orig, args, kw) in self.first.items():
            out = orig(*args, **kw)
            ref = orig(*_map_tensors(args, lambda t: t.cpu()),
                       **_map_tensors(kw, lambda t: t.cpu()))
            outs = out if isinstance(out, tuple) else (out,)
            refs = ref if isinstance(ref, tuple) else (ref,)
            shape = "x".join(str(d) for d in args[0].shape)
            for i, (o, r) in enumerate(zip(outs, refs)):
                if o is None:
                    continue
                name = f"[{tag}] {fn} q {shape} output {i}"
                if i == 0 and not fn.endswith("_bwd"):
                    check(name, o, r.to(o.device), o.dtype, [])
                else:
                    check_grad(name, o, r.to(o.device))
        return len(self.first)


def examples_phase(dev):
    """[examples]: the four examples of examples_torch/ through their
    `main`, each on its default device (the card), each under KernelCalls:
    what each returns (quickstart's 60 finite losses, its checkpoints and
    cache bytes; serve_batched's own asserts, its chunked completion order
    and cache bytes; long_context_decode's 32 tokens and compression;
    train_mlm's finite losses and the second run resuming), the launches
    of the kernels each reaches (quickstart 1r and 2 in training, 3
    serving; serve_batched 1, 3, 4; long_context_decode 1, 3; train_mlm 5,
    6), their sum by wrapper equal to its calls, and exact where the path
    fixes them; then every kernel shape they launched held
    against its plain twin on the same inputs."""
    import tempfile
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from examples_torch import (long_context_decode, quickstart,
                                serve_batched, train_mlm)
    from repro_torch.configs import get_smoke_config
    qcfg = get_smoke_config("qwen3-8b")
    L = qcfg.num_layers
    got = {}

    def run(name, fn, argv, want, exact=None):
        with KernelCalls() as calls:
            reset_launches()
            t0 = time.perf_counter()
            res = fn(argv)
            wall = time.perf_counter() - t0
            launches = {k: v for k, v in read_launches().items() if v}
        log(f"[examples] {name} {' '.join(argv)}: {wall:.1f} s; launches "
            f"{launches}")
        require_launches(collections.defaultdict(int, launches), want, name)
        for k, n in (exact or {}).items():
            if launches.get(k, 0) != n:
                raise AssertionError(f"{name}: {k} launched "
                                     f"{launches.get(k, 0)} times, not {n}")
        # a wrapper's counters but the offset form's (a subset of the
        # backward's) sum to its launches: one a call on the card
        per_wrapper = collections.Counter()
        for k, _, wrapper, attr in LAUNCH_COUNTERS:
            if attr != "offset_launches":
                per_wrapper[wrapper] += launches.get(k, 0)
        if +per_wrapper != +calls.count:
            raise AssertionError(f"{name}: launches by wrapper "
                                 f"{dict(per_wrapper)}, calls "
                                 f"{dict(calls.count)}")
        n_shapes = calls.check(f"examples {name}")
        got[name] = res
        return res, launches, n_shapes

    # quickstart's 4-token prompts are shorter than one block (c = 16):
    # the engine feeds them through decode steps, so its serve launches
    # kernel 3 alone
    q, _, nq = run("quickstart", quickstart.main, [], (
        "blockwise_causal_attn(return_residuals)",
        "blockwise_causal_attn_bwd", "decode_attn"), {"blockwise_causal_attn(return_residuals)": 60 * L,
                         "blockwise_causal_attn_bwd": 60 * L})
    if len(q["losses"]) != 60 or not all(map(math.isfinite, q["losses"])) \
            or q["checkpoints"] != [30, 60] or q["cache_bytes"] != \
            EXAMPLES_CACHE_BYTES["quickstart"] or \
            [len(o) for o in q["outputs"]] != [12, 12]:
        raise AssertionError(f"quickstart returned {q}")
    s, _, ns = run("serve_batched", serve_batched.main, [], (
        "blockwise_causal_attn", "decode_attn",
        "blockwise_causal_prefix_attn"))
    if s["chunked_order"][-1] != 0 or (s["cache_bytes"],
                                       s["cache_bytes_standard"]) != \
            EXAMPLES_CACHE_BYTES["serve_batched"]:
        raise AssertionError(f"serve_batched returned {s}")
    new = 32
    lc, _, nl = run("long_context_decode", long_context_decode.main,
                    ["--new-tokens", str(new)],
                    ("blockwise_causal_attn", "decode_attn"),
                    {"blockwise_causal_attn": L, "decode_attn": new * L})
    if lc["context"] != 8192 or len(lc["tokens"]) != new or \
            not lc["ratio"] > 1:
        raise AssertionError(f"long_context_decode returned {lc}")
    layers = int(EXAMPLES_MLM[1])
    mlm = []
    with tempfile.TemporaryDirectory() as d:
        done = 0
        for steps in EXAMPLES_MLM_STEPS:
            n = (steps - done) * layers
            res, _, nm = run(
                f"train_mlm run {len(mlm) + 1}", train_mlm.main,
                EXAMPLES_MLM + ["--steps", str(steps), "--ckpt-dir", d],
                ("linformer_attn", "seq_projection"),
                {"linformer_attn": n, "seq_projection": 2 * n})
            if res["steps"] != list(range(done + 1, steps + 1)) or not all(
                    map(math.isfinite, res["losses"])):
                raise AssertionError(f"train_mlm --steps {steps}: steps "
                                     f"{res['steps']}, losses "
                                     f"{res['losses']}")
            mlm.append(res)
            done = steps
    log(f"[examples] quickstart final loss {q['loss']:.3f}, cache "
        f"{q['cache_bytes']} B; serve_batched compression "
        f"{s['compression']:.1f}x, chunked order {s['chunked_order']}; "
        f"long_context_decode prefill {lc['prefill_s']:.2f} s, "
        f"{1e3 * lc['decode_s'] / new:.2f} ms a token, cache "
        f"{lc['cache_bytes']} B vs {lc['full_bytes']} B full "
        f"({lc['ratio']:.1f}x); train_mlm ~{mlm[0]['n_params'] / 1e6:.1f}M "
        f"params, loss {mlm[0]['loss']:.4f} at step "
        f"{EXAMPLES_MLM_STEPS[0]}, resumed, {mlm[1]['loss']:.4f} at "
        f"{EXAMPLES_MLM_STEPS[1]}; kernel shapes held to their plain twins: "
        f"{nq + ns + nl + nm}")
    return got


# -- the MoE family ------------------------------------------------------------

MOE_ARCHS = ("qwen3-moe-30b-a3b", "kimi-k2-1t-a32b")
# [serve-moe]: the depth each config is served at. qwen3-moe-30b-a3b takes
# 1.246 GB a layer in bf16 (61.1 GB whole with its 1.24 GB of embedding and
# LM head): all 48 layers fit beside the pools, and 12 are served, for the
# run's time limit. kimi-k2-1t-a32b takes 33.9 GB a layer (384 experts of
# d 7168 × 2048) and 4.7 GB of embedding and LM head: one layer fits, two
# do not
SERVE_MOE_LAYERS = {"qwen3-moe-30b-a3b": 12, "kimi-k2-1t-a32b": 1}
# [serve-moe]'s two serves of qwen3-moe (kimi-k2 serves the dense pool only)
SERVE_MOE_MODES = {"qwen3-moe-30b-a3b": ("dense", "paged"),
                   "kimi-k2-1t-a32b": ("dense",)}
# the decode chunk [serve-moe] profiles: 4 steps of the 4-row pool. At 48
# layers a step launches ~9100 kernels, and the profiler took longer to
# digest a 16-step chunk's than the rest of the phase took to run; the
# share of each operation is that of any step
SERVE_MOE_PROFILE_STEPS = 4
# [train-moe]: bf16 params and gradients and fp32 AdamW moments, ~14 bytes
# a parameter with the update's temporaries: ~43 GB at 4 layers of
# qwen3-moe (3.1 B parameters); 6 layers do not fit beside the activations
# of one 4096-token row
TRAIN_MOE_LAYERS = 4
TRAIN_MOE_RUN = dict(seq=4096, batch=1, steps=2)


def serve_modes(dev, cfg, arch, tag, params, prompts, modes):
    """Serve `prompts` (SERVE_DENSE_NEW new tokens each, max_batch 4) once
    per mode: "dense", monolithic admission into the dense pool (kernels
    1 and 3), "paged", chunked admission (P = 512) into the paged int8
    pool (kernels 8 and 7), which must end with every page free. Returns
    ({path: launches}, {mode: outputs})."""
    budgets = [SERVE_DENSE_NEW] * len(prompts)
    kinds = {"dense": ({}, ("blockwise_causal_attn", "decode_attn")),
             "paged": (dict(prefill_chunk=SERVE_PREFILL_CHUNK,
                            cache_format="paged",
                            page_dtype=SERVE_PAGE_DTYPE),
                       ("blockwise_causal_prefix_attn_q", "decode_attn_q"))}
    launches, outs = {}, {}
    for mode in modes:
        kw, kernels = kinds[mode]
        eng = serve_engine(dev, cfg, params, **kw)
        run = run_serve(f"{tag} {arch} {mode}", eng, prompts, kernels,
                        budgets)
        if "pool_prefill_remainder" in run.walls:
            raise AssertionError(f"{tag} {arch} {mode}: a remainder step "
                                 "ran on prompts of whole blocks")
        log(f"  cache bytes a request: {eng.cache_bytes(4) // 4} "
            f"({'paged ' + SERVE_PAGE_DTYPE if eng.paged else 'dense bf16'}"
            f", max_seq {eng.max_seq})")
        if eng.paged:
            require_pages_free(f"{tag} {arch} {mode}", run.sched)
        launches[f"{tag}-{mode} {arch}"] = run.launches
        outs[mode] = run.outs
        del eng, run
    return launches, outs


def moe_drops(fn):
    """fn() with the port's MoE routing observed: (fn's result, the
    share of (token, expert) choices that capacity dropped, the routing
    calls, their token counts)."""
    from repro_torch.models import moe as tmoe
    route, seen = tmoe.route, []

    def counting(router, x, cfg):
        r = route(router, x, cfg)
        seen.append((x.shape[0], r["keep"].numel(),
                     int((~r["keep"]).sum())))
        return r

    tmoe.route = counting
    try:
        out = fn()
    finally:
        tmoe.route = route
    choices = sum(n for _, n, _ in seen)
    return out, sum(d for _, _, d in seen) / max(choices, 1), len(seen), \
        sorted({t for t, _, _ in seen})


def serve_moe_phase(dev, arch):
    """[serve-moe]: the config at full width, cut in depth as
    SERVE_MOE_LAYERS says, random bf16 weights (seed 0), [serve-dense]'s
    8 requests (256·SERVE_DENSE_BLOCKS prompt tokens, SERVE_DENSE_NEW new
    tokens, max_batch 4, max_seq 4096), served as SERVE_MOE_MODES says;
    then a 4-row pool's decode chunk of SERVE_MOE_PROFILE_STEPS steps
    profiled, and the share of routing
    choices that capacity dropped in one admission prefill and in one
    decode step of that pool. Returns {path: launches}."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as tmodel
    from repro_torch.models.transformer import param_bytes
    full = get_config(arch)
    cfg = dataclasses.replace(full, num_layers=SERVE_MOE_LAYERS[arch])
    a, m = cfg.attention, cfg.moe
    log(f"[serve-moe] {arch}: {cfg.num_layers} of {full.num_layers} "
        f"layers, d={cfg.d_model}, H={a.num_heads}/{a.num_kv_heads} (G="
        f"{a.q_per_kv}), Dh={a.head_dim}, qk_norm {a.qk_norm}, "
        f"{m.num_experts} experts top {m.top_k}, expert d_ff "
        f"{m.expert_d_ff} {cfg.mlp.activation}, capacity factor "
        f"{m.capacity_factor}, vocab {cfg.padded_vocab_size}, {cfg.dtype}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = tmodel.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    log(f"  params: {param_bytes(params) / 1e9:.2f} GB in "
        f"{time.perf_counter() - t0:.1f} s")
    c = a.linformer.block_size
    rng = np.random.default_rng(0)
    prompts = [list(map(int, rng.integers(4, cfg.vocab_size, n * c)))
               for n in SERVE_DENSE_BLOCKS]
    launches, outs = serve_modes(dev, cfg, arch, "serve-moe", params,
                                 prompts, SERVE_MOE_MODES[arch])
    if "paged" in outs:
        agree = sum(sum(x == y for x, y in zip(p, q))
                    for p, q in zip(outs["dense"], outs["paged"]))
        log(f"  paged int8 chunked vs dense monolithic: {agree} of "
            f"{sum(map(len, outs['dense']))} tokens equal position by "
            "position (int8 slots and other GEMM shapes round differently,"
            " and capacity couples the rows of a batch)")
    eng = serve_engine(dev, cfg, params)
    pool = eng.init_pool_cache(4)
    firsts = []
    for row, p in enumerate(prompts[:4]):
        slot_cache, first = eng.prefill_request(p)
        eng.write_pool_slot(pool, slot_cache, row)
        firsts.append(first)
    cur = torch.tensor(firsts, device=dev)
    fin = torch.zeros(4, dtype=torch.bool, device=dev)
    for what, fn in (
            (f"one admission prefill ({len(prompts[3])} tokens)",
             lambda: eng.prefill_request(prompts[3])),
            ("one decode step of the 4-row pool",
             lambda: eng.decode_chunk_fn(cur, fin, pool, 1))):
        _, share, calls, tokens = moe_drops(fn)
        log(f"  [serve-moe] {arch}, {what}: {100 * share:.2f}% of the "
            f"(token, expert) choices dropped by capacity over {calls} "
            f"routing calls of {tokens} tokens (capacity factor "
            f"{m.capacity_factor}, floor 1)")
    timed_profile(f"serve-moe {arch} decode_chunk ({SERVE_MOE_PROFILE_STEPS}"
                  " steps, 4 rows)", lambda: eng.decode_chunk_fn(
                      cur, fin, pool, SERVE_MOE_PROFILE_STEPS), top=10)
    torch.cuda.synchronize()
    log(f"  [serve-moe] {arch}: peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del eng, pool, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def train_moe_phase(dev, arch="qwen3-moe-30b-a3b"):
    """[train-moe]: TRAIN_MOE_RUN["steps"] Trainer steps of the config at
    full width cut to TRAIN_MOE_LAYERS (bf16, remat "full", seq 4096,
    batch 1), launch counters reset just before and read just after:
    kernels 1, 1r and 2 on the tensor cores, once a layer a step each;
    each step's loss and aux loss logged."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import OptimizerConfig, TrainConfig
    from repro_torch.models.transformer import param_bytes
    full = get_config(arch)
    cfg = dataclasses.replace(full, num_layers=TRAIN_MOE_LAYERS)
    run = TRAIN_MOE_RUN
    tcfg = TrainConfig(seq_len=run["seq"], global_batch=run["batch"],
                       steps=run["steps"], log_every=1, checkpoint_every=0,
                       seed=0, optimizer=OptimizerConfig(
                           lr=3e-4, warmup_steps=1,
                           total_steps=run["steps"]))
    log(f"[train-moe] {arch} cut to {cfg.num_layers} of {full.num_layers} "
        f"layers, {cfg.moe.num_experts} experts top {cfg.moe.top_k}, "
        f"aux_loss_weight {cfg.moe.aux_loss_weight}, {cfg.dtype}, remat "
        f"{cfg.remat}, seq {tcfg.seq_len}, batch {tcfg.global_batch}, "
        f"{tcfg.steps} steps")
    trainer, launches = counted_train(f"train-moe {arch}", dev, cfg, tcfg)
    log(f"  params {param_bytes(trainer._params) / 1e9:.2f} GB")
    for h in trainer.history:
        log(f"  step {h['step']}: aux loss {h['aux_loss']:.4f}")
        if not (math.isfinite(h["aux_loss"]) and h["aux_loss"] > 0):
            raise AssertionError(f"aux loss {h['aux_loss']}")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# -- the ssm and hybrid families ---------------------------------------------

HYBRID_ARCH, SSM_ARCH = "zamba2-1.2b", "rwkv6-1.6b"
# [serve-hybrid] and [serve-ssm]: 8 requests of these prompt lengths, in
# turn, SERVE_SSM_NEW new tokens each, max_batch 4, max_seq 4096. serve()
# takes the static bucketed path (one bucket per length). zamba2's shared
# block folds 256-token blocks: 512 and 768 prefill whole, 600 prefills
# 512 and decodes its 88 remainder tokens step by step; rwkv6 prefills
# every prompt whole (512: whole chunks; 600: whole chunks and a tail)
SERVE_SSM_LENS = {HYBRID_ARCH: (512, 768, 600), SSM_ARCH: (512, 600)}
SERVE_SSM_NEW = 128
SERVE_SSM_REQUESTS = 8
SERVE_SSM_PROFILE_STEPS = 4
# [serve-hybrid] and [serve-ssm]: the depth at full width, cut for the
# run's time limit: zamba2 to two shared-block invocations and a trailing
# trunk layer (of 38 layers), rwkv6 to 8 of 24
SERVE_SSM_LAYERS = {HYBRID_ARCH: 13, SSM_ARCH: 8}
# [serve-hybrid-parity] and [train-hybrid]'s parity leg: zamba2 at full
# width cut to 7 layers (one attention invocation and a trailing trunk
# layer); rwkv6's legs at 2 layers
SSM_PARITY_LAYERS = {HYBRID_ARCH: 7, SSM_ARCH: 2}
# [serve-ssm-parity]: forward's logits against the decode_step loop over
# the same tokens, fp32 on the card (chunked against stepwise summation
# over up to 600 steps)
SSM_STEPWISE_TOL = 2e-3
TRAIN_SSM_RUN = dict(seq=4096, batch=2, steps=4)
# [train-ssm-parity]: rwkv6 launches no kernel, so its kernel and reference
# routes run the same code; its leg holds the fp32 loss gradients to the
# same port code in fp64 (rwkv_model.float64_reference) at full width cut
# to SSM_PARITY_LAYERS, B = 1, S = TRAIN_PARITY_SEQ: every leaf's max
# |fp32 - fp64| at most this share of the fp64 leaf's largest entry (the
# bound of tests/test_torch_rwkv_precision.py, MAX_ERR, fixed before the
# first card run), the losses within TRAIN_LOSS_RTOL
SSM_F64_GRAD_TOL = 5e-5


def ssm_prompts(cfg, lens, n, seed=0):
    import numpy as np
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(4, cfg.vocab_size, lens[i % len(
        lens)]))) for i in range(n)]


def count_model_calls(fn):
    """fn() with the model's forward and decode_step counted (the engine's
    prefill and decode_scan call them through the module): (fn's result,
    forwards, decode steps)."""
    from repro_torch.models import model as tmodel
    fwd, step, calls = tmodel.forward, tmodel.decode_step, [0, 0]

    def forward(*a, **kw):
        calls[0] += 1
        return fwd(*a, **kw)

    def decode_step(*a, **kw):
        calls[1] += 1
        return step(*a, **kw)

    tmodel.forward, tmodel.decode_step = forward, decode_step
    try:
        out = fn()
    finally:
        tmodel.forward, tmodel.decode_step = fwd, step
    return out, calls[0], calls[1]


def require_ssm_launches(tag, cfg, launches, forwards, steps):
    """zamba2: kernel 1 once per shared-block invocation of each forward,
    kernel 3 once per invocation of each decode step, nothing else;
    rwkv6: no kernel of the port."""
    from repro_torch.models import zamba
    n_inv = zamba.n_attn_invocations(cfg) if cfg.family == "hybrid" else 0
    want = {name: 0 for name in launches}
    want["blockwise_causal_attn"] = n_inv * forwards
    want["decode_attn"] = n_inv * steps
    log(f"  [{tag}] {forwards} forwards, {steps} decode steps; launches "
        f"{ {k: v for k, v in launches.items() if v} } (expected "
        f"{ {k: v for k, v in want.items() if v} })")
    if launches != want:
        raise AssertionError(f"{tag}: launches {launches}, expected {want}")


def serve_ssm_phase(dev, arch, tag):
    """[serve-hybrid] / [serve-ssm]: the config at full width cut to
    SERVE_SSM_LAYERS (bf16, random weights from seed 0), SERVE_SSM_REQUESTS requests through serve(), which must
    take the static bucketed path (no scheduler), counters reset just
    before and read just after and held to the per-forward and per-step
    counts; tok/s, peak memory, cache bytes a request; then a 4-row pool's
    decode chunk of SERVE_SSM_PROFILE_STEPS steps profiled, and the launch
    counts of one counted prefill and one counted decode step. Returns
    {path: launches}."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import EOS
    from repro_torch.models import model as tmodel
    from repro_torch.models.transformer import param_bytes
    full = get_config(arch)
    cfg = dataclasses.replace(full, num_layers=SERVE_SSM_LAYERS[arch])
    log(f"[{tag}] {arch}: {cfg.num_layers} of {full.num_layers} layers "
        f"(family {cfg.family}), "
        f"d={cfg.d_model}, vocab {cfg.padded_vocab_size}, {cfg.dtype}"
        + (f", shared block every {cfg.hybrid_attn_every} layers, "
           f"H={cfg.attention.num_heads}, Dh={cfg.attention.head_dim}, "
           f"c={cfg.attention.linformer.block_size}, "
           f"r={cfg.attention.linformer.block_slots}, SSM N="
           f"{cfg.ssm.state_dim}, P={cfg.ssm.head_dim}, chunk "
           f"{cfg.ssm.chunk_size}" if cfg.family == "hybrid" else
           f", RWKV head dim {cfg.rwkv.head_dim}, chunk "
           f"{cfg.rwkv.chunk_size}"))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = tmodel.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    log(f"  params: {param_bytes(params) / 1e9:.2f} GB in "
        f"{time.perf_counter() - t0:.1f} s")
    prompts = ssm_prompts(cfg, SERVE_SSM_LENS[arch], SERVE_SSM_REQUESTS)
    eng = serve_engine(dev, cfg, params)
    if eng.supports_continuous_batching:
        raise AssertionError(f"{arch}: continuous batching claimed")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    outs, forwards, steps = count_model_calls(
        lambda: eng.serve(prompts, SERVE_SSM_NEW, max_batch=4))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    n_tok = sum(len(o) for o in outs)
    log(f"[{tag}] static fallback: {len(prompts)} requests (prompts "
        f"{[len(p) for p in prompts]}), {n_tok} tokens in {wall:.2f} s: "
        f"{n_tok / wall:.1f} tok/s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; cache "
        f"{eng.cache_bytes(4) / 4e6:.2f} MB a request (dense "
        f"{eng.cache_dtype}, max_seq {eng.max_seq})")
    require_ssm_launches(tag, cfg, launches, forwards, steps)
    for o in outs:
        if not isinstance(o, list) or not 0 < len(o) <= SERVE_SSM_NEW \
                or EOS in o:
            raise AssertionError(f"output {o!r}")
        if len(o) < SERVE_SSM_NEW:
            log(f"  a request ended at EOS after {len(o)} tokens")
    toks = np.asarray(prompts[:1] * 4)
    reset_launches()
    (cache, logits), fw, st = count_model_calls(lambda: eng.prefill(toks))
    require_ssm_launches(f"{tag} one prefill of 4 × {toks.shape[1]}", cfg,
                         read_launches(), fw, st)
    cur = torch.argmax(logits, dim=-1)
    fin = torch.zeros(4, dtype=torch.bool, device=dev)
    reset_launches()
    _, fw, st = count_model_calls(
        lambda: eng.decode_chunk_fn(cur, fin, cache, 1))
    require_ssm_launches(f"{tag} one decode step of 4 rows", cfg,
                         read_launches(), fw, st)
    timed_profile(f"{tag} decode_chunk ({SERVE_SSM_PROFILE_STEPS} steps, "
                  "4 rows)", lambda: eng.decode_chunk_fn(
                      cur, fin, cache, SERVE_SSM_PROFILE_STEPS), top=10)
    torch.cuda.synchronize()
    log(f"  [{tag}] peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del eng, cache, params
    gc.collect()
    torch.cuda.empty_cache()
    return {tag: launches}


def serve_hybrid_parity_phase(dev):
    """[serve-hybrid-parity]: zamba2 at full width cut to
    SSM_PARITY_LAYERS layers in fp32, the kernel route (backend "auto":
    kernels 1 and 3) against the plain reference route from the same
    weights: the forward's logits over 2 × 512 tokens within LOGITS_TOL,
    and 16 greedy tokens identical for two prompts of 600 tokens (a whole
    block prefill and 88 remainder steps) and two of 200 (shorter than a
    block: every prompt token a decode step)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as tmodel
    from repro_torch.serving import ServingEngine
    cfg = dataclasses.replace(get_config(HYBRID_ARCH),
                              num_layers=SSM_PARITY_LAYERS[HYBRID_ARCH],
                              dtype="float32")
    params = tmodel.init_params(cfg, seed=1, device=dev)
    toks = np.random.default_rng(1).integers(4, cfg.vocab_size, (2, 512))
    prompts = {n: ssm_prompts(cfg, (n,), 2, seed=n) for n in (600, 200)}
    logits, outs, launches = {}, {}, {}
    for backend in ("auto", "reference"):
        c = cfg.with_attention_backend(backend)
        reset_launches()
        with torch.no_grad():
            logits[backend] = tmodel.forward(
                params, c, {"tokens": torch.from_numpy(toks).to(dev)})[0]
        eng = ServingEngine(params, c, max_seq=4096, device=dev,
                            cache_dtype=torch.float32, decode_chunk=16)
        outs[backend] = {n: eng.serve(p, 16, max_batch=2)
                         for n, p in prompts.items()}
        launches[backend] = read_launches()
        log(f"  [serve-hybrid-parity] {backend}: launches "
            f"{ {k: v for k, v in launches[backend].items() if v} }")
    dl = (logits["auto"] - logits["reference"]).abs().max().item()
    log(f"[serve-hybrid-parity] {cfg.num_layers}-layer fp32: forward logits"
        f" max |auto - reference| = {dl:.3e} (tol {LOGITS_TOL:g}); 16 "
        f"greedy tokens identical at 600 tokens: "
        f"{outs['auto'][600] == outs['reference'][600]}, at 200 (all "
        f"decode): {outs['auto'][200] == outs['reference'][200]}")
    if not all(torch.isfinite(v).all() for v in logits.values()):
        raise AssertionError("non-finite logits")
    if not dl <= LOGITS_TOL:
        raise AssertionError(f"logits differ by {dl}")
    if outs["auto"] != outs["reference"]:
        raise AssertionError(f"tokens differ: {outs}")
    require_launches(launches["auto"], ("blockwise_causal_attn",
                                        "decode_attn"), "serve-hybrid-parity")
    if any(launches["reference"].values()):
        raise AssertionError("the reference route launched a kernel")
    del params
    torch.cuda.empty_cache()


def serve_ssm_parity_phase(dev):
    """[serve-ssm-parity]: rwkv6 at full width cut to 2 layers in fp32,
    S = 512 (whole chunks) and 600 (whole chunks and a tail): forward's
    logits at every position against a loop of decode_step over the same
    tokens from the zero state, within SSM_STEPWISE_TOL; all finite."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as tmodel
    cfg = dataclasses.replace(get_config(SSM_ARCH),
                              num_layers=SSM_PARITY_LAYERS[SSM_ARCH],
                              dtype="float32")
    params = tmodel.init_params(cfg, seed=1, device=dev)
    for S in (512, 600):
        toks = torch.from_numpy(np.random.default_rng(S).integers(
            4, cfg.vocab_size, (2, S))).to(dev)
        with torch.no_grad():
            full = tmodel.forward(params, cfg, {"tokens": toks})[0]
            cache = tmodel.init_cache(cfg, batch=2, max_seq=S,
                                      dtype=torch.float32, device=dev)
            steps = []
            for t in range(S):
                lg, cache = tmodel.decode_step(params, cfg,
                                               toks[:, t:t + 1], cache)
                steps.append(lg[:, 0])
        steps = torch.stack(steps, dim=1)
        err = (full - steps).abs().max().item()
        finite = bool(torch.isfinite(full).all() and
                      torch.isfinite(steps).all())
        log(f"[serve-ssm-parity] {cfg.num_layers}-layer fp32, 2 × {S}: "
            f"forward vs decode_step loop, logits max |diff| {err:.3e} "
            f"(tol {SSM_STEPWISE_TOL:g}); finite {finite}")
        if not finite or not err <= SSM_STEPWISE_TOL:
            raise AssertionError(f"S={S}: chunked vs stepwise {err}")
    del params
    torch.cuda.empty_cache()


def train_ssm_phase(dev, arch, tag, dtype=None):
    """[train-hybrid] / [train-ssm]: TRAIN_SSM_RUN["steps"] Trainer steps
    (make_train_step) of the config at full width and depth (bf16, or
    `dtype`; remat "full" on the trunk, seq 4096, batch 2), launch counters
    reset just before and read just after: zamba2 launches kernels 1r and
    2 once per shared-block invocation a step (the shared block has no
    remat, so kernel 1 does not run), rwkv6 no kernel. Returns {path:
    launches}."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import OptimizerConfig, TrainConfig
    from repro_torch.models import zamba
    from repro_torch.train import Trainer
    cfg = get_config(arch)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
        tag = f"{tag} {dtype}"
    run = TRAIN_SSM_RUN
    tcfg = TrainConfig(seq_len=run["seq"], global_batch=run["batch"],
                       steps=run["steps"], log_every=1, checkpoint_every=0,
                       seed=0, optimizer=OptimizerConfig(
                           lr=3e-4, warmup_steps=1,
                           total_steps=run["steps"]))
    log(f"[{tag}] {arch}: {cfg.num_layers} layers (family {cfg.family}), "
        f"{cfg.dtype}, remat {cfg.remat}, seq {tcfg.seq_len}, batch "
        f"{tcfg.global_batch}, {tcfg.steps} steps")
    trainer = Trainer(cfg, tcfg, device=dev, log_fn=log)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    trainer.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    for h in trainer.history:
        log(f"  step {h['step']}: loss {h['loss']:.4f}, grad norm "
            f"{h['grad_norm']:.4f}, {h['ms']:.1f} ms, "
            f"{h['tokens_per_s']:.1f} tokens/s")
    log(f"  run {wall:.1f} s (parameter init included); peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    if len(trainer.history) != tcfg.steps or not all(
            math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
            for h in trainer.history):
        raise AssertionError(f"non-finite or missing losses: "
                             f"{trainer.history}")
    n = zamba.n_attn_invocations(cfg) * tcfg.steps \
        if cfg.family == "hybrid" else 0
    want = {name: 0 for name in launches}
    want["blockwise_causal_attn(return_residuals)"] = n
    want["blockwise_causal_attn_bwd"] = n
    if launches != want:
        raise AssertionError(f"{tag}: launches {launches}, expected {want}")
    if n:
        require_routes(tag, "tensor cores")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return {tag: launches}


def ssm_f64_parity_phase(dev, cfg32, batch, tag):
    """[train-ssm-parity] for rwkv6: the fp32 loss and every gradient leaf
    of `cfg32` on `batch` (numpy) against the same port code in fp64
    (rwkv_model.float64_reference, the weights widened) from the same
    parameters: each leaf's max |fp32 - fp64| within SSM_F64_GRAD_TOL of
    the fp64 leaf's largest entry, and non-zero (the two runs round
    differently), the losses within TRAIN_LOSS_RTOL, no kernel launched.
    The fp32 run with the time mix in fp32 (rwkv6.WKV_DTYPE[float32], the
    route before it ran in fp64) is logged beside, not gated."""
    import torch
    from repro_torch.models import model as tmodel
    from repro_torch.models import rwkv6
    from repro_torch.models.rwkv_model import float64_reference
    from repro_torch.models.transformer import flatten, nest
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    B, S = batch["labels"].shape
    base = {k: p.detach() for k, p in
            flatten(tmodel.init_params(cfg32, seed=1, device=dev)).items()}

    def loss_grads(dtype):
        leaves = {k: p.clone().to(dtype).requires_grad_(True)
                  for k, p in base.items()}
        loss, _ = tmodel.loss_fn(nest(leaves), cfg32, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.item(), dict(zip(leaves, (g.detach() for g in grads)))

    def errors(grads, ref):
        err = {k: ((grads[k].double() - ref[k]).abs().max()
                   / ref[k].abs().max()).item() for k in ref
               if ref[k].abs().max() > 0}
        worst = max(err, key=err.get)
        return worst, err[worst]

    with float64_reference():
        loss64, g64 = loss_grads(torch.float64)
    reset_launches()
    loss32, g32 = loss_grads(torch.float32)
    launches = {k: v for k, v in read_launches().items() if v}
    worst, err = errors(g32, g64)
    del g32
    wkv = rwkv6.WKV_DTYPE[torch.float32]
    rwkv6.WKV_DTYPE[torch.float32] = torch.float32
    try:
        loss_old, g_old = loss_grads(torch.float32)
    finally:
        rwkv6.WKV_DTYPE[torch.float32] = wkv
    worst_old, err_old = errors(g_old, g64)
    del g_old, g64
    loss_err = abs(loss32 - loss64) / abs(loss64)
    log(f"[{tag}] {cfg32.num_layers}-layer fp32 at full width (d "
        f"{cfg32.d_model}, head dim {cfg32.rwkv.head_dim}), B={B}, S={S}, "
        f"against the same code in fp64: loss {loss32:.6f} vs "
        f"{loss64:.6f} (rel err {loss_err:.2e}, tol {TRAIN_LOSS_RTOL:g}); "
        f"worst gradient leaf {worst}: max |fp32 - fp64| {err:.3e} of its "
        f"largest entry (tol {SSM_F64_GRAD_TOL:g}); with the mix in fp32: "
        f"loss {loss_old:.6f}, worst leaf {worst_old} {err_old:.3e}; "
        f"launches {launches}")
    if launches:
        raise AssertionError(f"{tag}: launched {launches}")
    if not math.isfinite(loss32) or not loss_err <= TRAIN_LOSS_RTOL:
        raise AssertionError(f"{tag}: losses {loss32} vs {loss64}")
    if not 0 < err <= SSM_F64_GRAD_TOL:
        raise AssertionError(f"{tag}: gradient {worst} error {err}")
    del base
    torch.cuda.empty_cache()


# -- the training leftovers and the tuning table -------------------------------

# [chunked-ref]: one qwen3-8b attention layer, (B, H, Hkv, c, r, Dh), at
# S = 16384 (nb = 64, c + M = 1280: one plain fp32 score tensor is
# 32·16384·1280·4 B = 2.68 GB) and S = 65536 (M = 4096 = MAX_PINNED_SLOTS,
# c + M = 4352: a plain fp32 score tensor would be 36.5 GB and its softmax
# as much again, so only the chunked form runs there); one fp32 gradient at
# CHUNKED_REF_GRAD_SEQ through the plain backward route (chunked from the
# tuned threshold on) against kernel 2's
CHUNKED_REF_SHAPE = (1, 32, 8, 256, 16, 128)
CHUNKED_REF_SEQS = (16384, 65536)
CHUNKED_REF_GRAD_SEQ = 16384
# [train-leftovers]: [train]'s shape, a FileCorpus batch; the depths tried
# in turn until remat "none" fits on the card
TRAIN_LEFTOVERS_RUN = dict(seq=4096, batch=2, steps=3)
TRAIN_LEFTOVERS_DEPTHS = (8, 6, 4)
REMAT_POLICIES = ("none", "dots", "full")
REMAT_LOSS_RTOL = 1e-5
REMAT_GNORM_RTOL = 1e-3
# [tune]: the depth of the two qwen3-8b serves under the smoke table
TUNE_SERVE_LAYERS = 2


def causal_inputs(B, H, Hkv, S, c, r, Dh, dtype, dev, seed):
    """Model-layout q (B, S, H, Dh), k and v (B, S, Hkv, Dh), E and F
    (c, r), from a seeded generator on the card."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, S, H, Dh, generator=g, device=dev).to(dtype)
    k, v = (torch.randn(B, S, Hkv, Dh, generator=g, device=dev).to(dtype)
            for _ in range(2))
    E, F = ((torch.randn(c, r, generator=g, device=dev) * r ** -0.5).to(dtype)
            for _ in range(2))
    return q, k, v, E, F


def peak_above(fn):
    """(fn(), the peak memory in GB above what was allocated before the
    call, the call's wall in ms ending in a sync)."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    return out, (torch.cuda.max_memory_allocated() - base) / 1e9, ms


def check_bf16_route(name, out, ref32, ref16):
    """A bf16 result against the fp32 reference on the same (upcast)
    inputs: its max error at most BF16_PARITY_FACTOR times the plain bf16
    reference's, plus BF16_PARITY_ABS. Returns the max error."""
    e_k = (out.float() - ref32.float()).abs().max().item()
    e_r = (ref16.float() - ref32.float()).abs().max().item()
    log(f"  {name} bf16: max |kernel - fp32 reference| = {e_k:.3e}, the "
        f"bf16 reference's {e_r:.3e} ({e_k / max(e_r, 1e-30):.2f}x)")
    if not e_k <= BF16_PARITY_FACTOR * e_r + BF16_PARITY_ABS:
        raise AssertionError(f"{name} bf16: error {e_k} beyond "
                             f"{BF16_PARITY_FACTOR} x {e_r}")
    return e_k


def chunked_ref_phase(dev):
    """Kernel 1 against the chunked reference form (and the plain one where
    its scores fit) at one qwen3-8b layer, fp32 and bf16, with the peak
    memory of each; then one fp32 gradient through the plain backward
    route, now chunked, against kernels 1r and 2."""
    import torch
    from repro_torch.core import causal
    from repro_torch.kernels import ops
    from repro_torch.tune import table as tuning
    B, H, Hkv, c, r, Dh = CHUNKED_REF_SHAPE
    key = tuning.platform_key(dev)
    threshold = causal.chunked_attention_min_seq(key)
    log(f"[chunked-ref] one {B}-row qwen3-8b attention layer: H={H} "
        f"Hkv={Hkv} c={c} r={r} Dh={Dh}; chunked_min_seq {threshold} on "
        f"{key!r}")
    kw = dict(block_size=c, scale=Dh ** -0.5)
    f32 = torch.float32
    for S in CHUNKED_REF_SEQS:
        qcb = tuning.q_chunk_blocks_for(seq=S, platform=key)
        with_plain = S <= CHUNKED_REF_GRAD_SEQ
        for dtype in (f32, torch.bfloat16):
            q, k, v, E, F = causal_inputs(B, H, Hkv, S, c, r, Dh, dtype, dev,
                                          seed=60)
            with torch.no_grad():
                out, pk, tk = peak_above(
                    lambda: ops.fused_blockwise_causal_attention(
                        q, k, v, E, F, block_size=c, block_slots=r,
                        scale=Dh ** -0.5))
                chunk, pc, tc = peak_above(
                    lambda: causal.blockwise_causal_attention_chunked(
                        q, k, v, E, F, **kw))
                plain = pp = tp = None
                if with_plain:
                    plain, pp, tp = peak_above(
                        lambda: causal.blockwise_causal_attention(
                            q, k, v, E, F, **kw))
            tag = f"blockwise_causal_attn S={S}"
            if dtype == f32:
                check(f"{tag} vs the chunked reference", out, chunk, dtype,
                      (v,))
                if with_plain:
                    check(f"{tag} vs the plain reference", out, plain, dtype,
                          (v,))
            else:
                with torch.no_grad():
                    ref32 = causal.blockwise_causal_attention_chunked(
                        *(x.float() for x in (q, k, v, E, F)), **kw)
                check_bf16_route(f"{tag} vs the chunked reference", out,
                                 ref32, chunk)
                if with_plain:
                    check_bf16_route(f"{tag} vs the plain reference", out,
                                     ref32, plain)
                del ref32
            same = "not run" if plain is None else \
                f"{(chunk.float() - plain.float()).abs().max().item():.3e}"
            log(f"  S={S} {str(dtype)[6:]}: peak above the inputs: kernel "
                f"{pk:.3f} GB ({tk:.1f} ms), chunked reference "
                f"(q_chunk_blocks {qcb}) {pc:.3f} GB ({tc:.1f} ms), plain "
                f"reference " + ("not run (its scores would not fit)"
                                 if plain is None else
                                 f"{pp:.3f} GB ({tp:.1f} ms)")
                + f"; max |chunked - plain| {same}")
            del q, k, v, E, F, out, chunk, plain
            gc.collect()
            torch.cuda.empty_cache()
    S = CHUNKED_REF_GRAD_SEQ
    if S < threshold:
        raise AssertionError(f"S={S} is under the chunked threshold "
                             f"{threshold}: the plain backward would not "
                             "run the chunked form")
    xs = causal_inputs(B, H, Hkv, S, c, r, Dh, f32, dev, seed=61)
    g = torch.Generator(device=dev).manual_seed(62)
    do = torch.randn(xs[0].shape, generator=g, device=dev)
    grads = {}
    for impl in ("reference", "fused"):
        leaves = [x.detach().requires_grad_() for x in xs]
        reset_launches()
        gs, pk, ms = peak_above(lambda: torch.autograd.grad(
            ops.fused_blockwise_causal_attention(
                *leaves, block_size=c, block_slots=r, scale=Dh ** -0.5,
                backward_impl=impl), leaves, do))
        launches = {k_: n for k_, n in read_launches().items() if n}
        log(f"  gradient S={S} fp32, backward_impl {impl!r}: peak above "
            f"the inputs {pk:.3f} GB, {ms:.1f} ms; launches {launches}")
        if bool(launches) != (impl == "fused"):
            raise AssertionError(f"backward_impl {impl!r}: launches "
                                 f"{launches}")
        grads[impl] = gs
        del leaves
    for name, got, want in zip(("dq", "dk", "dv", "dE", "dF"),
                               grads["fused"], grads["reference"]):
        check_grad(f"blockwise_causal_attn_bwd S={S} {name} vs the chunked "
                   "plain backward", got, want)
    del xs, do, grads
    gc.collect()
    torch.cuda.empty_cache()


def prefix_grad_phase(dev):
    """The prefix form's VJP (kernel 4r forward, kernel 2 with start
    blocks backward) at the chunked serve's chunk shape, fp32 and bf16,
    against autograd through the plain prefix form and against the plain
    twins; exact zeros on slots no row sees; then the offset backward
    timed. Returns (its kernels' record, the path's launches)."""
    import torch
    import torch.nn.functional as Fn
    from repro_torch.core import causal
    from repro_torch.kernels import blockwise_causal_attn as bca
    from repro_torch.kernels import ops
    shape, start, M = PREFIX_SHAPES["full"]
    B, H, Hkv, P, c, r, Dh = shape
    G = H // Hkv
    kw = dict(block_size=c, block_slots=r, scale=Dh ** -0.5)
    log(f"[prefix-grad] fused_chunk_prefill_attention's VJP: B={B} H={H} "
        f"Hkv={Hkv} P={P} M={M} c={c} r={r} Dh={Dh}, start blocks {start}")
    names = ("dq", "dk", "dv", "dcomp_k", "dcomp_v")
    launches, err_bf16 = None, None
    for dtype in (torch.float32, torch.bfloat16):
        qk, kk, vk, ck, cv, sb = prefix_inputs(shape, start, M, dtype, dev,
                                               seed=70)
        ck, cv = ck.to(dtype), cv.to(dtype)
        model = [x.movedim(1, 2).contiguous() for x in (qk, kk, vk, ck, cv)]
        g = torch.Generator(device=dev).manual_seed(71)
        do = torch.randn(model[0].shape, generator=g, device=dev).to(dtype)
        leaves = [x.detach().requires_grad_() for x in model]
        reset_launches()
        got = torch.autograd.grad(ops.fused_chunk_prefill_attention(
            *leaves, sb, **kw), leaves, do)
        torch.cuda.synchronize()
        run = read_launches()
        launches = run if launches is None else {
            k_: launches[k_] + n for k_, n in run.items()}
        ref_leaves = [x.detach().requires_grad_() for x in model]
        want = torch.autograd.grad(causal.blockwise_causal_prefix_attention(
            *ref_leaves, sb, **kw), ref_leaves, do)
        _, m, d = bca.blockwise_causal_attn_plain(
            qk, kk, vk, ck, cv, start_blocks=sb, return_residuals=True, **kw)
        twin = [t.movedim(1, 2) for t in bca.blockwise_causal_attn_bwd_plain(
            qk, kk, vk, ck, cv, m, d, do.movedim(1, 2), start_blocks=sb,
            **kw)]
        tag = f"prefix VJP {str(dtype)[6:]}"
        check_twin = check_grad if dtype == torch.float32 \
            else check_grad_steps
        errs = [check_twin(f"{tag} {n} vs the plain twins", a, b)
                for n, a, b in zip(names, got, twin)]
        if dtype == torch.float32:
            for n, a, b in zip(names, got, want):
                check_grad(f"{tag} {n} vs autograd through the prefix "
                           "reference", a, b)
        else:
            err_bf16 = max(errs)
            leaves32 = [x.detach().float().requires_grad_() for x in model]
            ref32 = torch.autograd.grad(
                causal.blockwise_causal_prefix_attention(*leaves32, sb, **kw),
                leaves32, do.float())
            for n, a, b, w in zip(names, got, want, ref32):
                check_bf16_route(f"{tag} {n} vs autograd through the prefix "
                                 "reference", a, w, b)
            del leaves32, ref32
        slot_blk = torch.arange(M, device=dev) // r
        unseen = slot_blk[None] >= (sb.long()[:, None] + P // c - 1)
        zeros = all(bool(torch.all(g_[unseen] == 0)) for g_ in got[3:])
        log(f"  {tag}: {int(unseen.sum())} slot rows no query sees, exact "
            f"zeros in dcomp_k/dcomp_v: {zeros}; launches "
            f"{ {k_: n for k_, n in run.items() if n} }")
        if not zeros:
            raise AssertionError("nonzero gradient on a slot no row sees")
        del leaves, ref_leaves, got, want, twin, model
    require_launches(launches, ("blockwise_causal_prefix_attn(return_residuals)",
                                "blockwise_causal_attn_bwd(start_blocks)"),
                     "prefix-grad")
    # the offset backward at this shape, bf16, L2-cold inputs
    bf16 = torch.bfloat16
    n_sets = 4
    sets, res, dos = [], [], []
    for i in range(n_sets):
        q, k, v, ck, cv, sb = prefix_inputs(shape, start, M, bf16, dev,
                                            seed=72 + i)
        sets.append((q, k, v, ck.to(bf16), cv.to(bf16), sb))
        res.append(bca.blockwise_causal_prefix_attn(
            *sets[-1], return_residuals=True, **kw)[1:])
        g = torch.Generator(device=dev).manual_seed(80 + i)
        dos.append(torch.randn(q.shape, generator=g, device=dev).to(bf16))
    run = lambda i: bca.blockwise_causal_attn_bwd(  # noqa: E731
        *sets[i][:5], *res[i], dos[i], start_blocks=sets[i][5], **kw)
    ms = time_graph_ms(run, n_sets, iters=20)
    eager_ms = time_ms(run, n_sets, iters=10)
    plain_ms = time_ms(lambda i: bca.blockwise_causal_attn_bwd_plain(
        *sets[i][:5], *res[i], dos[i], start_blocks=sets[i][5], **kw),
        n_sets, iters=5)
    mask = prefix_mask(P, c, r, M, sets[0][5])
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    lib = []
    with torch.cuda.stream(side):
        for q, k, v, ck, cv, _ in sets:
            xs = [x.contiguous().requires_grad_() for x in (
                q, torch.cat([k, ck], 2).repeat_interleave(G, 1),
                torch.cat([v, cv], 2).repeat_interleave(G, 1))]
            lib.append((xs, Fn.scaled_dot_product_attention(
                *xs, attn_mask=mask, scale=Dh ** -0.5)))
    torch.cuda.synchronize()
    dos_c = [do.contiguous() for do in dos]
    lib_ms = time_graph_ms(lambda i: torch.autograd.grad(
        lib[i][1], lib[i][0], dos_c[i], retain_graph=True), n_sets,
        iters=10, stream=side)
    flops, nbytes = bca.blockwise_causal_attn_bwd_cost(
        B, H, Hkv, P, Dh, M, block_size=c, block_slots=r, start_blocks=start,
        offset=True)
    log(f"  blockwise_causal_attn_bwd(start_blocks) B={B} H={H} P={P} M={M}: "
        f"kernel {ms:.4f} ms (eager loop {eager_ms:.4f}), plain "
        f"{plain_ms:.4f} ms, masked sdpa backward {lib_ms:.4f} ms")
    rec = dict(name="blockwise_causal_attn_bwd(start_blocks)", route="cuda",
               source="src/repro_torch/csrc/blockwise_causal_attn_bwd.cu",
               replaces="src/repro/kernels/blockwise_causal_attn.py:469",
               ms=ms, eager_ms=eager_ms, plain_ms=plain_ms,
               library_ms=lib_ms, bytes=nbytes, flops=flops,
               max_abs_err=err_bf16)
    set_bound(rec)
    del sets, res, dos, lib, dos_c
    return rec, launches


def write_corpus(d, n_docs, seed):
    """`n_docs` .txt files of seeded random words under `d`."""
    import numpy as np
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)
    for i in range(n_docs):
        words = [bytes(rng.choice(letters, int(rng.integers(1, 10)))).decode()
                 for _ in range(int(rng.integers(100, 250)))]
        with open(os.path.join(d, f"doc{i:03d}.txt"), "w") as fh:
            fh.write(" ".join(words) + ".\n")


def remat_run(dev, cfg, batches):
    """One warm-up step and the timed steps of make_train_step on `cfg`
    from seeded params and fresh AdamW state: (losses, grad norms, ms of
    the timed steps, peak GB)."""
    import torch
    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.models import model as tmodel
    from repro_torch.models.transformer import flatten
    from repro_torch.optim import adamw_init
    from repro_torch.train.trainer import make_train_step
    params = tmodel.init_params(cfg, seed=0, device=dev)
    for p in flatten(params).values():
        p.requires_grad_(True)
    opt = OptimizerConfig(lr=3e-4, warmup_steps=1, total_steps=4)
    state = adamw_init(params, opt)
    step = make_train_step(cfg, opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, gnorms, ms = [], [], []
    try:
        for b in batches:
            t0 = time.perf_counter()
            params, state, met = step(params, state, b)
            losses.append(float(met["loss"]))
            gnorms.append(float(met["grad_norm"]))
            ms.append(1e3 * (time.perf_counter() - t0))
        peak = torch.cuda.max_memory_allocated() / 1e9
    finally:
        del params, state
        gc.collect()
        torch.cuda.empty_cache()
    return losses, gnorms, ms[1:], peak


def train_leftovers_phase(dev, cfg):
    """[train]'s shape fed by document packing (FileCorpus over seeded
    .txt files) under remat none, dots and full: the same first loss and
    grad norm, peak memory none > dots > full. Returns the launches."""
    import tempfile
    import torch
    from repro_torch.data import FileCorpus, packing_efficiency
    seq, bsz, steps = (TRAIN_LEFTOVERS_RUN[k] for k in
                       ("seq", "batch", "steps"))
    with tempfile.TemporaryDirectory() as d:
        write_corpus(d, 64, seed=0)
        corpus = FileCorpus(d, seq, seed=0)
        stream = corpus.batches(bsz)
        host = [next(stream) for _ in range(steps)]
    masked = sum(int((b["loss_mask"] == 0).sum()) for b in host)
    log(f"[train-leftovers] {cfg.name} at {seq} tokens x {bsz} rows from "
        f"FileCorpus (64 seeded .txt files, byte tokens): packing "
        f"efficiency {packing_efficiency(host[0]):.4f}, {masked} of "
        f"{steps * bsz * seq} labels masked across documents or padding")
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in b.items()}
               for b in host]
    res = None
    for depth in TRAIN_LEFTOVERS_DEPTHS:
        try:
            reset_launches()
            res = {pol: remat_run(dev, dataclasses.replace(
                cfg, num_layers=depth, remat=pol), batches)
                for pol in REMAT_POLICIES}
            launches = read_launches()
            break
        except torch.cuda.OutOfMemoryError:
            gc.collect()
            torch.cuda.empty_cache()
            log(f"  remat 'none' does not fit at {depth} layers")
    if res is None:
        raise AssertionError("remat 'none' fits at none of the depths "
                             f"{TRAIN_LEFTOVERS_DEPTHS}")
    for pol, (losses, gnorms, ms, peak) in res.items():
        log(f"  {depth} layers, remat {pol!r}: losses "
            f"{', '.join(f'{x:.6f}' for x in losses)}; grad norms "
            f"{', '.join(f'{x:.4f}' for x in gnorms)}; timed steps "
            f"{', '.join(f'{x:.1f}' for x in ms)} ms; peak {peak:.2f} GB")
    base = res["none"]
    for pol in ("dots", "full"):
        dl = abs(res[pol][0][0] - base[0][0]) / abs(base[0][0])
        dg = abs(res[pol][1][0] - base[1][0]) / abs(base[1][0])
        log(f"  remat {pol!r} against 'none': first loss {dl:.2e}, grad "
            f"norm {dg:.2e} relative")
        if not (dl <= REMAT_LOSS_RTOL and dg <= REMAT_GNORM_RTOL):
            raise AssertionError(f"remat {pol!r}: loss {dl}, grad norm {dg}")
    peaks = [res[pol][3] for pol in REMAT_POLICIES]
    if not peaks[0] > peaks[1] > peaks[2]:
        raise AssertionError(f"peaks none/dots/full {peaks} not in order")
    require_launches(launches, ("blockwise_causal_attn(return_residuals)",
                                "blockwise_causal_attn_bwd"),
                     "train-leftovers")
    return launches


def tune_phase(dev, cfg, prompts):
    """build_table("smoke") on the card, every trial logged; the table
    valid; then, under it, two serves of qwen3-8b at full width and
    TUNE_SERVE_LAYERS layers of [serve]'s requests, decode_chunk=None
    (the tuned value) and 32: token-identical, and the serve's telemetry
    counts table hits. Returns the launches of the sweep and the tuned
    serve."""
    import logging
    import torch
    from repro_torch.models import model as tmodel
    from repro_torch.serving import ServingEngine
    from repro_torch.telemetry import Telemetry
    from repro_torch.tune import autotune
    from repro_torch.tune import table as tuning

    class _Log(logging.Handler):
        def emit(self, record):
            log(f"  {record.getMessage()}")

    key = tuning.platform_key(dev)
    log(f"[tune] the smoke sweep on {key!r}")
    handler = _Log()
    autotune.log.addHandler(handler)
    autotune.log.setLevel(logging.INFO)
    try:
        reset_launches()
        t0 = time.perf_counter()
        table = autotune.build_table("smoke", platform=key, device=dev)
        torch.cuda.synchronize()
        sweep_s = time.perf_counter() - t0
        launches = read_launches()
    finally:
        autotune.log.removeHandler(handler)
    errs = tuning.validate_doc(table.to_doc())
    for e in table.entries:
        log(f"  entry {e['form']} {e['bucket']}: {e['params']} "
            f"({e['trial_us']} us, default {e['default_us']} us)")
    log(f"  sweep {sweep_s:.1f} s; validate_doc: {errs or 'valid'}")
    if errs:
        raise AssertionError(f"the smoke table is invalid: {errs}")
    scfg = dataclasses.replace(cfg, num_layers=TUNE_SERVE_LAYERS)
    params = tmodel.init_params(scfg, seed=0, device=dev)
    outs, walls = {}, {}
    with tuning.override(table):
        tuned = table.scalar("decode_chunk", 32, platform=key)
        tuning.consume_stats()
        tel = Telemetry()
        for name, dc, t in (("tuned", None, tel), ("32", 32, None)):
            eng = ServingEngine(params, scfg, max_seq=4096, device=dev,
                                cache_dtype=torch.bfloat16, decode_chunk=dc,
                                telemetry=t)
            if name == "tuned" and eng.decode_chunk != tuned:
                raise AssertionError(f"decode_chunk=None resolved to "
                                     f"{eng.decode_chunk}, the table says "
                                     f"{tuned}")
            if name == "tuned":
                reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs[name] = eng.serve(prompts, SERVE_BUDGETS, max_batch=4)
            torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t0
            if name == "tuned":
                launches = {k_: launches[k_] + n
                            for k_, n in read_launches().items()}
            del eng
    hits = tel.metrics.counter("tuning_table_hit_total").value
    misses = tel.metrics.counter("tuning_table_miss_total").value
    same = outs["tuned"] == outs["32"]
    log(f"  {scfg.name} at {scfg.num_layers} layers, bf16, 8 requests: "
        f"decode_chunk {tuned} (tuned) {walls['tuned']:.2f} s, 32 "
        f"{walls['32']:.2f} s; token-identical: {same}; table hits {hits:g}, "
        f"misses {misses:g}")
    if not same:
        raise AssertionError("the tuned decode chunk changed the tokens")
    if hits < 1:
        raise AssertionError("the tuned serve counted no table hit")
    require_launches(launches, ("blockwise_causal_attn", "decode_attn"),
                     "tune")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# -- the analysis layer: the trace audit and the dry run on the card -------

# [audit]: qwen3-8b at full width cut to this many layers, bf16
AUDIT_LAYERS = 2
# [dryrun]: the dry run's peak (its live storage) against the real step's
# (max_memory_allocated less what was resident before the step and is not
# its argument). The caching allocator rounds every block up to
# DRYRUN_ROUND_BYTES, so each storage live at the peak may differ by that
# much, either way should the allocator's peak fall an op before or after
# the tracker's; cuBLAS and cuBLASLt take a workspace each per (handle,
# stream) through the caching allocator on first use (32 MiB on Hopper by
# torch's defaults), which the real step may add (DRYRUN_BLAS_BYTES, above
# only). The kernels' scratch is allocated by their fake path as well.
# Fixed before the phase's first card run.
DRYRUN_ROUND_BYTES = 512
DRYRUN_BLAS_BYTES = 2 * 32 * 2 ** 20


def audit_phase(dev):
    """[audit]: see the module docstring, item 31."""
    from repro_torch.analysis import trace_audit as ta
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("qwen3-8b"), num_layers=AUDIT_LAYERS)
    log(f"[audit] {cfg.name} at full width, {cfg.num_layers} layers, "
        f"{cfg.dtype}, backend {cfg.attention.backend}, under "
        "torch.cuda.set_sync_debug_mode('error')")
    entries = (
        ("decode_scan (dense)", lambda: ta.audit_decode(cfg=cfg, device=dev)),
        ("decode_scan (paged int8)", lambda: ta.audit_decode(
            cfg=cfg, device=dev, page_dtype="int8")),
        ("prefill_chunk", lambda: ta.audit_prefill(cfg=cfg, device=dev)),
        ("train_step", lambda: ta.audit_train(cfg=cfg, device=dev)))
    findings = []
    reset_launches()
    for name, fn in entries:
        t0 = time.perf_counter()
        found, stats = fn()
        log(f"  {name}: {stats}, {len(found)} findings "
            f"({time.perf_counter() - t0:.1f} s)")
        for f in found:
            log(f"    {f.rule} {f.path}: {f.msg}")
        findings += found
        free(dev)
    launches = read_launches()
    log(f"  launches {({k: v for k, v in launches.items() if v})}")
    require_launches(launches, (
        "decode_attn", "decode_attn_q", "blockwise_causal_prefix_attn",
        "blockwise_causal_attn(return_residuals)",
        "blockwise_causal_attn_bwd"), "audit")
    if findings:
        raise AssertionError(f"[audit] {len(findings)} findings")


def dryrun_phase(dev):
    """[dryrun]: see the module docstring, item 32."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import get_config
    from repro_torch.configs.base import OptimizerConfig, ShapeConfig
    from repro_torch.data.pipeline import (DataState, SyntheticCorpus,
                                           make_causal_batch)
    from repro_torch.launch import dryrun
    from repro_torch.launch.step_cost import storage_bytes
    from repro_torch.models import model as tmodel
    from repro_torch.models.transformer import flatten
    from repro_torch.optim import adamw_init
    from repro_torch.train.trainer import make_train_step
    cfg = dataclasses.replace(get_config("qwen3-8b"),
                              num_layers=TRAIN_RUN["layers"])
    shape = ShapeConfig("train", TRAIN_RUN["seq"], TRAIN_RUN["batch"],
                        "train")
    ocfg = OptimizerConfig(lr=3e-4, warmup_steps=1, total_steps=4)
    log(f"[dryrun] [train]'s step ({cfg.name}, {cfg.num_layers} layers, "
        f"{cfg.dtype}, remat {cfg.remat}, {shape.global_batch} x "
        f"{shape.seq_len}) at world size 1: FakeTensors on the card's "
        "device type, then the real step")
    reset_launches()
    t0 = time.perf_counter()
    dry = dryrun.dry_run(cfg, shape, None, device=dev.type, ocfg=ocfg)
    dry_wall = time.perf_counter() - t0
    if any(read_launches().values()):
        raise AssertionError("[dryrun] a fake launch moved a kernel counter")
    dry_launches = sink_launches(dry["kernels"])

    params = tmodel.init_params(cfg, seed=0, device=dev)
    for p in flatten(params).values():
        p.requires_grad_(True)
    opt = adamw_init(params, ocfg)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in make_causal_batch(
        SyntheticCorpus(cfg.vocab_size, seed=0), DataState(0, 0),
        batch=shape.global_batch, seq=shape.seq_len).items()}
    parts = {"params": storage_bytes(params, dev.type),
             "moments": storage_bytes((opt["mu"], opt["nu"]), dev.type),
             "batch": storage_bytes(batch, dev.type)}
    step = make_train_step(cfg, ocfg)
    torch.cuda.synchronize()
    other = torch.cuda.memory_allocated() - sum(parts.values())
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as fc:
        _, _, metrics = step(params, opt, batch)
    torch.cuda.synchronize()
    real_wall = time.perf_counter() - t0
    real_launches = read_launches()
    real_peak = torch.cuda.max_memory_allocated() - other
    pred = dry["peak_bytes"]
    slack = DRYRUN_ROUND_BYTES * dry["peak_storages"]
    lo, hi = pred - slack, pred + slack + DRYRUN_BLAS_BYTES
    log(f"  dry run {dry_wall:.1f} s, real step {real_wall:.1f} s (loss "
        f"{float(metrics['loss']):.4f})")
    log(f"  argument bytes: dry run {dry['argument_bytes_by_part']}, real "
        f"{parts}")
    log(f"  launches: dry run "
        f"{({k: v for k, v in dry_launches.items() if v})}, real "
        f"{({k: v for k, v in real_launches.items() if v})}")
    log(f"  aten FLOPs: dry run {dry['aten_flops']}, real "
        f"{fc.get_total_flops()}; kernel FLOPs (dry run) "
        f"{dry['kernel_flops']}")
    log(f"  peak: predicted {pred} B ({pred / 1e9:.3f} GB, "
        f"{dry['peak_storages']} storages live), real {real_peak} B "
        f"({real_peak / 1e9:.3f} GB; {other} B resident besides), real / "
        f"predicted {real_peak / pred:.6f}; band [{lo}, {hi}] B")
    log(f"  bytes lower / upper bound {dry['bytes_lower']} / "
        f"{dry['bytes_upper']}")
    if dry["argument_bytes_by_part"] != parts:
        raise AssertionError("[dryrun] argument bytes differ")
    if dry_launches != real_launches:
        raise AssertionError("[dryrun] kernel launches differ")
    if dry["aten_flops"] != fc.get_total_flops():
        raise AssertionError("[dryrun] aten FLOPs differ")
    if not lo <= real_peak <= hi:
        raise AssertionError(f"[dryrun] real peak {real_peak} B outside the "
                             f"band [{lo}, {hi}]")
    del params, opt, batch, step
    free(dev)


# -- multi-GPU: the plan's tp/sp routes and expert parallelism on gloo ranks --

# Ranks of the [mesh] and [mesh-moe] phases. They share the one card
# (cuda:0) under a gloo process group (NCCL refuses two ranks on one
# device), so their walls say nothing about scaling.
MESH_WORLD = 4
MESH_LAYOUTS = {"data2xtp2": (2, 1), "data2xsp2": (1, 2), "sp2xtp2": (2, 2)}
# qwen3-8b's attention at full width; the forms at the shapes of [check]:
# the train step's causal attention, the chunked serve's prefix form and
# decode; the paper's encoder for the exact form; the model-level legs
# (2-layer qwen3-8b train step, 1-layer qwen3-moe-30b-a3b forward) in fp32.
MESH_SHAPES = {
    "attn": dict(H=32, Hkv=8, Dh=128, c=256, r=16),
    "causal": dict(B=2, S=4096),
    "prefix": dict(B=4, P=512, M=288, start=(0, 3, 7, 14)),
    "decode": dict(B=4, M=288, t=(3, 300, 2000, 4600)),
    "exact": dict(B=32, S=512, K=128, H=12, Dh=64),
    "train": dict(layers=2, batch=1, seq=1024),
    "moe": dict(layers=1, batch=2, seq=1024, decode_batch=8),
}
# fp32 tp legs: the per-head math of a shard is the whole tensor's, so
# fp32 agrees to rounding; fp32 sp legs (another kernel, another summation
# order) keep the existing gates (GRAD_TOL, scaled as in check_grad). bf16
# legs keep check_bf16_route's gate (MeshRank.close_bf16).
MESH_TP_TOL = 1e-5
MESH_GRADS = ("dq", "dk", "dv", "dE", "dF")
# the kernels each shard must launch on the [mesh] routes (Part C's table)
MESH_KERNELS = tuple(name for name, *_ in LAUNCH_COUNTERS)


class MeshRank:
    """One rank's bookkeeping: the launches of the mesh legs (reset before
    each leg, read after it: the world-size-1 references are not
    counted); rank 0 logs each leg's error against its bound."""

    def __init__(self, rank, dev):
        self.rank, self.dev = rank, dev
        self.launches = collections.Counter()
        self.by_leg = collections.defaultdict(collections.Counter)

    def say(self, msg):
        if self.rank == 0:
            log(msg)

    def sync(self):
        import torch
        if self.dev.type == "cuda":
            torch.cuda.synchronize()

    def counted(self, fn, leg=None):
        reset_launches()
        out = fn()
        self.sync()
        launches = read_launches()
        self.launches.update(launches)
        if leg is not None:
            self.by_leg[leg].update(launches)
        return out

    def close(self, name, got, ref, tol):
        """max |got - ref| within tol · max(1, max |ref|)."""
        err = (got.float() - ref.float()).abs().max().item()
        bound = tol * max(1.0, ref.float().abs().max().item())
        self.say(f"  {name}: max |mesh - one| = {err:.3e}, "
                 f"{err / bound:.2f} of its bound")
        if not err <= bound:
            raise AssertionError(f"rank {self.rank} {name}: {err} > {bound}")

    def close_bf16(self, name, got, ref32, ref16, grad):
        """A bf16 result of the mesh against world size 1 in fp32 on the
        same (upcast) operands, by the gate the kernels' bf16 route meets
        at world size 1: an output's max abs error (check_bf16_route), a
        gradient's relative norm error (train_parity_bf16_phase: a
        gradient summed over shards rounds each shard's part to bf16 first)
        at most BF16_PARITY_FACTOR times world size 1's in bf16, plus
        BF16_PARITY_ABS."""
        e_m, e_o = self.bf16_errs(got, ref32, ref16, grad)
        what = "rel norm" if grad else "max abs"
        self.say(f"  {name} bf16: {what} err against fp32 {e_m:.3e}, world "
                 f"size 1's {e_o:.3e} ({e_m / max(e_o, 1e-30):.2f}x)")
        if not e_m <= BF16_PARITY_FACTOR * e_o + BF16_PARITY_ABS:
            raise AssertionError(f"rank {self.rank} {name} bf16: {e_m} "
                                 f"beyond {BF16_PARITY_FACTOR} x {e_o}")

    @staticmethod
    def bf16_errs(got, ref32, ref16, grad):
        """(mesh error, world size 1 bf16 error) against `ref32`: max abs,
        or for a gradient the relative norm."""
        import torch

        def err(x):
            d = x.float() - ref32.float()
            if not grad:
                return d.abs().max().item()
            return (torch.linalg.vector_norm(d) / torch.linalg.vector_norm(
                ref32.float()).clamp_min(1e-30)).item()

        return err(got), err(ref16)

    def hold(self, leg, fn, plans, tol, probe=None):
        """`fn(plan, prep)` -> {name: tensor}, its float operands passed
        through `prep`. Each mesh plan's fp32 results against world size 1
        within tol[mesh]; its bf16 results by close_bf16, against world
        size 1 in bf16 and in fp32 on the bf16-rounded operands. `probe`
        names the tensor-core routes each bf16 run of a shard must take
        (kernels/blockwise_causal_attn's last_*_route probes)."""
        import torch
        from repro_torch.kernels import blockwise_causal_attn as bca
        from repro_torch.parallel.plan import AttentionPlan
        one = AttentionPlan()

        def b16(x):
            return x.to(torch.bfloat16)

        def r16(x):
            return x.to(torch.bfloat16).float()

        ref = fn(one, lambda x: x)
        ref16, ref32 = fn(one, b16), fn(one, r16)
        for n, plan in plans.items():
            got = self.counted(lambda: fn(plan, lambda x: x))
            for name, x in got.items():
                self.close(f"{leg} {name} {n}", x, ref[name], tol[n])
            got = self.counted(lambda: fn(plan, b16))
            for name, x in got.items():
                self.close_bf16(f"{leg} {name} {n}", x, ref32[name],
                                ref16[name], grad=name in MESH_GRADS)
            routes = {"forward": bca.last_forward_route,
                      "backward": bca.last_backward_route}
            ran = {k: routes[k]() for k in probe or ()}
            if ran:
                self.say(f"  {leg} {n} bf16 routes: {ran}")
            if any(r != "tensor cores" for r in ran.values()):
                raise AssertionError(f"{leg} {n} bf16 ran the routes {ran}")


def mesh_attention_legs(rk, meshes):
    """Each route of the plan on each mesh against world size 1 on the
    kernels, in fp32 (the SIMT kernel bodies) and bf16 (the tensor-core
    bodies), MeshRank.hold: the causal form's forward alone and with its
    backward, chunk prefill (dense, int8) and decode (dense, int8)."""
    import torch
    from repro_torch.configs.base import AttentionConfig, LinformerConfig
    from repro_torch.core.cache import quantize_blockwise, resolve_page_dtype
    from repro_torch.parallel.plan import resolve_attention_plan
    from repro_torch.parallel.sharding import ParallelCtx
    dev = rk.dev
    a = MESH_SHAPES["attn"]
    H, Hkv, Dh, c, r = a["H"], a["Hkv"], a["Dh"], a["c"], a["r"]
    acfg = AttentionConfig(num_heads=H, num_kv_heads=Hkv, head_dim=Dh,
                           linformer=LinformerConfig(block_size=c,
                                                     block_slots=r))
    kw = dict(block_size=c, block_slots=r, scale=Dh ** -0.5)
    g = torch.Generator(device=dev).manual_seed(31)

    def rnd(*s, scale=1.0):
        return torch.randn(*s, generator=g, device=dev) * scale

    plans = {n: resolve_attention_plan(acfg, ParallelCtx(mesh=m))
             for n, m in meshes.items() if n in MESH_LAYOUTS}
    tol = {n: MESH_TP_TOL if p.sp == 1 else GRAD_TOL
           for n, p in plans.items()}

    B, S = MESH_SHAPES["causal"]["B"], MESH_SHAPES["causal"]["S"]
    qkv = (rnd(B, S, H, Dh), rnd(B, S, Hkv, Dh), rnd(B, S, Hkv, Dh),
           rnd(c, r, scale=r ** -0.5), rnd(c, r, scale=r ** -0.5))
    cot = rnd(B, S, H, Dh)

    def forward(plan, prep):
        with torch.no_grad():
            return {"forward": plan.causal_attention(
                *(prep(x) for x in qkv), **kw)}

    def grads(plan, prep):
        leaves = [prep(x).detach().requires_grad_(True) for x in qkv]
        out = plan.causal_attention(*leaves, **kw)
        got = torch.autograd.grad((out * prep(cot)).sum(), leaves)
        return dict(zip(MESH_GRADS, got))

    rk.hold("causal", forward, plans, tol, probe=("forward",))
    rk.hold("causal", grads, plans, tol, probe=("forward", "backward"))
    del qkv, cot

    p = MESH_SHAPES["prefix"]
    B, P, M = p["B"], p["P"], p["M"]
    pdt, qmax = resolve_page_dtype("int8")
    ops = (rnd(B, P, H, Dh), rnd(B, P, Hkv, Dh), rnd(B, P, Hkv, Dh),
           rnd(B, M, Hkv, Dh, scale=2.0), rnd(B, M, Hkv, Dh, scale=2.0))
    start = torch.tensor(p["start"], dtype=torch.int32, device=dev)
    (ckq, cks), (cvq, cvs) = (quantize_blockwise(x, (3,), dtype=pdt,
                                                 qmax=qmax) for x in ops[3:])

    B, M = MESH_SHAPES["decode"]["B"], MESH_SHAPES["decode"]["M"]
    t = torch.tensor(MESH_SHAPES["decode"]["t"], device=dev)
    dops = (rnd(B, 1, H, Dh), rnd(B, c, Hkv, Dh), rnd(B, c, Hkv, Dh),
            rnd(B, M, Hkv, Dh), rnd(B, M, Hkv, Dh))
    loc_ok = torch.arange(c, device=dev)[None] <= (t % c)[:, None]
    glob_ok = torch.arange(M, device=dev)[None] < (t // c * r)[:, None]
    dq = [quantize_blockwise(x, (3,), dtype=pdt, qmax=qmax)
          for x in dops[1:]]

    def pool(pl, x):
        # a cache operand as a pool laid out per the plan's cache_pspecs
        # holds it (place_cache): this rank's KV heads under tp
        return pl.head_shard(x, 2).contiguous()

    legs = {
        "chunk prefill": (lambda pl, prep: pl.chunk_prefill_attention(
            prep(ops[0]), *(pl.head_shard(prep(x), 2) for x in ops[1:3]),
            *(pool(pl, prep(x)) for x in ops[3:]), start, **kw),
            ("forward",)),
        "chunk prefill int8": (lambda pl, prep: pl.chunk_prefill_attention_q(
            prep(ops[0]), *(pl.head_shard(prep(x), 2) for x in ops[1:3]),
            *(pool(pl, x) for x in (ckq, cvq, cks, cvs)), start, **kw),
            ("forward",)),
        "decode": (lambda pl, prep: pl.decode_attention(
            prep(dops[0]), *(pool(pl, prep(x)) for x in dops[1:]),
            loc_ok, glob_ok, scale=kw["scale"]), ()),
        "decode int8": (lambda pl, prep: pl.decode_attention_q(
            prep(dops[0]), *(pool(pl, x) for x in (
                dq[0][0], dq[1][0], dq[0][1], dq[1][1], dq[2][0], dq[3][0],
                dq[2][1], dq[3][1])), loc_ok, glob_ok, scale=kw["scale"]),
            ())}
    with torch.no_grad():
        for leg, (fn, probe) in legs.items():
            rk.hold(leg, lambda pl, prep: {"out": fn(pl, prep)}, plans, tol,
                    probe=probe)


def mesh_exact_leg(rk, meshes):
    """The exact form at the paper's shapes on sp2 × tp2, forward and
    gradients, against world size 1 (kernels 6 and 5 a shard), in fp32
    within GRAD_TOL and in bf16 (MeshRank.hold)."""
    import torch
    from repro_torch.configs.base import AttentionConfig, LinformerConfig
    from repro_torch.parallel.plan import resolve_attention_plan
    from repro_torch.parallel.sharding import ParallelCtx
    e = MESH_SHAPES["exact"]
    B, S, K, H, Dh = e["B"], e["S"], e["K"], e["H"], e["Dh"]
    acfg = AttentionConfig(kind="linformer", num_heads=H, num_kv_heads=H,
                           head_dim=Dh, causal=False, use_rope=False,
                           linformer=LinformerConfig(k=K,
                                                     sharing="layerwise"))
    plan = resolve_attention_plan(acfg, ParallelCtx(mesh=meshes["sp2xtp2"]))
    if not plan.manual or plan.sp != 2 or plan.tp != 2:
        raise AssertionError(f"exact form plan: {plan}")
    g = torch.Generator(device=rk.dev).manual_seed(32)
    ops = [torch.randn(B, S, H, Dh, generator=g, device=rk.dev)
           for _ in range(3)]
    ops += [torch.randn(S, K, generator=g, device=rk.dev) * S ** -0.5
            for _ in range(2)]
    cot = torch.randn(B, S, H, Dh, generator=g, device=rk.dev)
    kw = dict(projection="linear", scale=Dh ** -0.5)

    def run(pl, prep):
        leaves = [prep(x).detach().requires_grad_(True) for x in ops]
        out = pl.exact_attention(*leaves, **kw)
        got = torch.autograd.grad((out * prep(cot)).sum(), leaves)
        return dict(zip(("out",) + MESH_GRADS, (out.detach(), *got)))

    rk.hold("exact", run, {"sp2xtp2": plan}, {"sp2xtp2": GRAD_TOL})


def mesh_train_leg(rk, meshes):
    """One model-level train step's loss and every gradient leaf of
    qwen3-8b at full width and 2 layers (fp32, remat full) on sp2 × tp2
    against world size 1; rank 0 computes the reference first and keeps
    its gradients on the host."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import (DataState, SyntheticCorpus,
                                           make_causal_batch)
    from repro_torch.models import model as tmodel
    from repro_torch.models.transformer import flatten
    from repro_torch.parallel import comm
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.plan import local_batch
    from repro_torch.parallel.sharding import ParallelCtx
    from repro_torch.train.trainer import training_ctx
    tr = MESH_SHAPES["train"]
    cfg = dataclasses.replace(get_config("qwen3-8b"), num_layers=tr["layers"],
                              dtype="float32")
    batch = make_causal_batch(SyntheticCorpus(cfg.vocab_size, seed=0),
                              DataState(0, 0), batch=tr["batch"],
                              seq=tr["seq"])
    batch = {k: torch.from_numpy(v).to(rk.dev) for k, v in batch.items()}
    params = tmodel.init_params(cfg, seed=1, device=rk.dev)
    leaves = flatten(params)
    for p in leaves.values():
        p.requires_grad_(True)

    def step(params, leaves, batch, ctx):
        loss, _ = tmodel.loss_fn(params, cfg, batch, ctx=ctx)
        return loss.detach(), torch.autograd.grad(loss, list(leaves.values()))

    ref = None
    if rk.rank == 0:
        loss, gr = step(params, leaves, batch, None)
        ref = (loss.item(), [x.cpu() for x in gr])
        del loss, gr
        gc.collect()
        if rk.dev.type == "cuda":
            torch.cuda.empty_cache()
    dist.barrier()
    tctx = training_ctx(ParallelCtx(mesh=meshes["sp2xtp2"], fsdp="data"))
    shards = shd.shard_tree(params, tctx)
    whole_bytes = sum(v.numel() * v.element_size() for v in leaves.values())
    del params, leaves
    free(rk.dev)
    local = flatten(shards)
    for p in local.values():
        p.requires_grad_(True)
    rest = sum(v.numel() * v.element_size() for v in local.values())
    if rk.dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    before = collections.Counter(comm.OP_DIM_BYTES)
    t0 = time.perf_counter()
    loss, gr = rk.counted(lambda: step(shards, local,
                                       local_batch(batch, tctx), tctx))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9 \
        if rk.dev.type == "cuda" else 0.0
    op_dim = {f"{op}/{d}": n for (op, d), n in
              (collections.Counter(comm.OP_DIM_BYTES) - before).items()}
    rk.say(f"  train step sp2xtp2, tensor-parallel: rank 0 holds "
           f"{rest / 1e9:.3f} GB of parameters (world size 1: "
           f"{whole_bytes / 1e9:.3f}), peak {peak:.2f} GB; comm bytes by "
           f"(op/mesh dim) {op_dim}")
    # the gradients whole, for the comparison (every rank gathers): not
    # the step's traffic, so comm's counters are put back after
    counters = (comm.BYTES, comm.CALLS, comm.DIM_BYTES, comm.DIM_CALLS,
                comm.OP_DIM_BYTES)
    saved = [collections.Counter(c) for c in counters]
    with torch.no_grad():
        gr = [shd.unshard_leaf(g, shd.leaf_spec(k, g.ndim, tctx), tctx)
              for k, g in zip(local, gr)]
    for c, kept in zip(counters, saved):
        c.clear()
        c.update(kept)
    leaves = local
    losses = [None] * dist.get_world_size()
    dist.all_gather_object(losses, loss.item())
    if max(abs(x - losses[0]) for x in losses) > 1e-6 * abs(losses[0]):
        raise AssertionError(f"ranks' losses differ: {losses}")
    if ref is not None:
        err = abs(loss.item() - ref[0]) / abs(ref[0])
        rk.say(f"  train step sp2xtp2 ({cfg.num_layers} layers, fp32, "
               f"B={tr['batch']}, S={tr['seq']}): loss {loss.item():.6f}, "
               f"rel err {err:.2e} (tol {TRAIN_LOSS_RTOL:g}), {wall:.1f} s")
        if not err <= TRAIN_LOSS_RTOL:
            raise AssertionError(f"mesh loss {loss.item()} vs {ref[0]}")
        worst = (0.0, "")
        for (name, _), x, y in zip(leaves.items(), gr, ref[1]):
            y = y.to(rk.dev)
            bound = GRAD_TOL * max(1.0, y.abs().max().item())
            ratio = (x - y).abs().max().item() / bound
            worst = max(worst, (ratio, name))
        rk.say(f"  train step gradients: worst leaf {worst[1]} at "
               f"{worst[0]:.2f} of GRAD_TOL·max(1, max|g|)")
        if not worst[0] <= 1.0:
            raise AssertionError(f"mesh gradient {worst[1]}: {worst[0]}")
    return peak


def mesh_moe_legs(rk, meshes):
    """qwen3-moe-30b-a3b at full width, 1 layer, fp32: the model's forward
    with the MoE layer expert-parallel on data2 × tp2 (against world size
    1 on each data shard's rows: capacity follows the shard's tokens) and
    on tp4 (against the whole batch); weight-stationary decode of the
    layer on data2 × tp2 with fsdp "data" against world size 1 with the
    flag off."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import (DataState, SyntheticCorpus,
                                           make_causal_batch)
    from repro_torch.models import model as tmodel
    from repro_torch.models import moe as tmoe
    from repro_torch.models.transformer import layer_params
    from repro_torch.parallel.sharding import ParallelCtx
    m = MESH_SHAPES["moe"]
    cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b"),
                              num_layers=m["layers"], dtype="float32")
    toks = make_causal_batch(SyntheticCorpus(cfg.vocab_size, seed=0),
                             DataState(0, 0), batch=m["batch"],
                             seq=m["seq"])["tokens"]
    toks = torch.from_numpy(toks).to(rk.dev)
    params = tmodel.init_params(cfg, seed=2, device=rk.dev)
    with torch.no_grad():
        for n, shards in (("data2xtp2", 2), ("tp4", 1)):
            ctx = ParallelCtx(mesh=meshes[n])
            logits, aux, _ = rk.counted(lambda: tmodel.forward(
                params, cfg, {"tokens": toks}, ctx=ctx))
            rows = toks.shape[0] // shards
            refs = [tmodel.forward(params, cfg,
                                   {"tokens": toks[i * rows:(i + 1) * rows]})
                    for i in range(shards)]
            rk.close(f"moe forward logits {n}", logits,
                     torch.cat([x[0] for x in refs]), GRAD_TOL)
            ref_aux = sum(x[1] for x in refs) / shards
            err = abs(aux.item() - ref_aux.item()) / abs(ref_aux.item())
            rk.say(f"  moe forward aux {n}: {aux.item():.6f}, rel err "
                   f"{err:.2e} (tol {TRAIN_LOSS_RTOL:g})")
            if not err <= TRAIN_LOSS_RTOL:
                raise AssertionError(f"moe aux {n}: {aux} vs {ref_aux}")
            del logits, refs
        lp = layer_params(params, 0)["moe"]
        g = torch.Generator(device=rk.dev).manual_seed(33)
        x = torch.randn(m["decode_batch"], 1, cfg.d_model, generator=g,
                        device=rk.dev)
        ws = dataclasses.replace(cfg.moe, weight_stationary_decode=True)
        out, aux = rk.counted(lambda: tmoe.apply_moe(
            lp, x, ws, cfg.mlp, ParallelCtx(mesh=meshes["data2xtp2"],
                                            fsdp="data")))
        ref, ref_aux = tmoe.apply_moe(
            lp, x, dataclasses.replace(ws, weight_stationary_decode=False),
            cfg.mlp)
        rk.close("moe weight-stationary decode data2xtp2", out, ref,
                 GRAD_TOL)
        rk.close("moe weight-stationary aux", aux, ref_aux, GRAD_TOL)


# Sharded training and tp serving ([mesh-train], [mesh-train-compressed],
# [mesh-elastic], [mesh-serve]): qwen3-8b at full width in the same spawn.
MESH_ARCH = "qwen3-8b"
# the first AdamW step runs at lr 0 (the schedule's warmup factor is 0 at
# step 0, as in JAX), so 2 steps make one update
MESH_TRAIN = dict(layers=2, batch=2, seq=1024, steps=2)
# bf16 with bf16 moments: four ranks' fp32 state of the full-width vocab
# (2 x 622M parameters) would not fit the card's 80 GB beside the
# transients of a step; 2 layers ran out of memory on the card (four ranks
# at ~19 GB each), so 1, the largest depth that fits
MESH_COMPRESSED = dict(layers=1, batch=4, seq=512, steps=3)
COMPRESSED_LOSS_TOL = 5e-3      # JAX's rule
# The gate holds the mesh's compressed step to the same algorithm at world
# size 1 (compressed_pod_reduce over each pod's gradient of the whole
# model: the port's copy of JAX's stacked rule), each loss within JAX's
# 5e-3, and logs both against the exact step. JAX's own rule (within 5e-3
# of the exact step) is a SMOKE-size one: at full width one scale a leaf
# (max over 311M embedding entries / 127) quantizes most entries to 0, and
# the exact step's AdamW moves every element by ~lr while the compressed
# one leaves those still, so the two loss curves part by ~0.1 after one
# update (measured on the card: 14.75 against 14.86 at lr 1e-4; 14.57
# against 14.61 at lr 1e-3, eps 1e-3), the world-size-1 algorithm's too.
COMPRESSED_OPT = dict(lr=1e-4, warmup_steps=0)
MESH_ELASTIC = dict(layers=1, batch=2, seq=512, steps=(2, 3))
# one pool row a request: the 8 requests decode in one wave
MESH_SERVE = dict(layers=4, lens=(3, 256 + 17, 230, 512 + 5, 768 + 30, 1,
                                  256 + 9, 512 + 32), new=8, pool=8)
# [mesh-serve]'s legs (dtype, pool), served on the tp pair of ranks 0 and 1,
# and the rank that serves each at world size 1 meanwhile; bf16 agreement
# is logged on the dense pool (fp32 holds both pools)
MESH_SERVE_LEGS = (("float32", "dense chunked"), ("float32", "paged int8"),
                   ("bfloat16", "dense chunked"))
MESH_SERVE_REFS = {MESH_SERVE_LEGS[0]: 2, MESH_SERVE_LEGS[1]: 3,
                   MESH_SERVE_LEGS[2]: 2}
# eps 1e-3 keeps every element's AdamW update in the linear regime
# (lr·g/eps for the clipped gradients here, all below 1e-3), so the
# parameters after the steps compare to rounding and the sharded global
# norm, the clip and the moments all show in them; at the default 1e-8 an
# element whose clipped gradient is near eps moves by up to lr on a 1e-7
# difference of the gradient (measured on the card: embed/tok 2.6e-4
# apart after 2 steps from gradients within 1.6e-6 of world size 1's)
TRAIN_OPT = dict(lr=1e-3, warmup_steps=0, eps=1e-3)


def mesh_cfg(layers, dtype):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(MESH_ARCH), num_layers=layers,
                               dtype=dtype)


def mesh_batch(cfg, B, S, seed):
    import torch
    from repro_torch.data.pipeline import (DataState, SyntheticCorpus,
                                           make_causal_batch)
    b = make_causal_batch(SyntheticCorpus(cfg.vocab_size, seed=seed),
                          DataState(seed, 0), batch=B, seq=S)
    return {k: torch.from_numpy(v) for k, v in b.items()}


def free(dev):
    """Release what the process no longer uses: unreferenced objects, the
    card's cached blocks and the cached pinned host blocks (gloo stages
    each collective of CUDA tensors through pinned host buffers, which
    the caching host allocator keeps until asked: under tensor
    parallelism four ranks' caches, ~8 GB each, ran a one-H100 host with
    96 GiB out of memory)."""
    import torch
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        if hasattr(torch._C, "_host_emptyCache"):
            torch._C._host_emptyCache()


def pinned_gb():
    """GB of pinned host memory the caching host allocator holds in this
    process, by torch's host_memory_stats (None where it reports none)."""
    import torch
    try:
        stats = torch.cuda.host_memory_stats()
    except (AttributeError, RuntimeError):
        return None
    held = [v for k, v in stats.items()
            if k.startswith("reserved_bytes") and k.endswith("current")]
    return held[0] / 1e9 if held else None


def rss_gb():
    """GB of this process's resident set (VmRSS), None if unreadable."""
    try:
        with open("/proc/self/status") as fh:
            for ln in fh:
                if ln.startswith("VmRSS:"):
                    return int(ln.split()[1]) / 1e6
    except (OSError, ValueError):
        pass
    return None


def ranks_memory(rk):
    """Each rank's (resident GB, cached pinned host GB), gathered to every
    rank (a collective: all ranks call it)."""
    import torch.distributed as dist
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, (rss_gb(), pinned_gb()))
    return every


def train_steps(cfg, ocfg, batches, dev, ctx=None, params=None, step=None):
    """make_train_step over `batches` from the seeded weights (this rank's
    shards under a mesh ctx): (losses, params, opt_state)."""
    import torch
    from repro_torch.models import model as tmodel
    from repro_torch.models.transformer import flatten
    from repro_torch.optim import adamw_init
    from repro_torch.parallel import sharding as shd
    from repro_torch.train.trainer import make_train_step, training_ctx
    tctx = training_ctx(ctx)
    if params is None:
        params = tmodel.init_params(cfg, seed=1, device=dev)
        if tctx is not None:
            params = shd.shard_tree(params, tctx)
            free(dev)
    for p in flatten(params).values():
        p.requires_grad_(True)
    opt = adamw_init(params, ocfg)
    step = step or make_train_step(cfg, ocfg, ctx=ctx)
    losses = []
    for b in batches:
        params, opt, m = step(params, opt, {k: v.to(dev)
                                            for k, v in b.items()})
        losses.append(float(m["loss"]))
    return losses, params, opt


def gathered(tree, ctx):
    """Each leaf of a tree of shards, whole, one at a time (a generator;
    every rank runs it)."""
    import torch
    from repro_torch.models.transformer import flatten
    from repro_torch.parallel import sharding as shd
    with torch.no_grad():
        for k, v in flatten(tree).items():
            yield k, shd.unshard_leaf(v, shd.leaf_spec(k, v.ndim, ctx), ctx)


def ws1_rest(fp32_bytes, dtype):
    """GB of parameters in `dtype` plus both fp32 moments, at world size 1,
    of a model whose fp32 parameters take `fp32_bytes`."""
    return fp32_bytes * ((1.0 if dtype == "float32" else 0.5) + 2.0) / 1e9


def tree_bytes(tree):
    from repro_torch.models.transformer import flatten
    return sum(v.numel() * v.element_size() for v in flatten(tree).values())


def mesh_train_legs(rk, meshes):
    """[mesh-train]: qwen3-8b at full width and MESH_TRAIN layers on
    data2 × tp2 with fsdp "data", the training layout (each rank its rows
    and its shard of every parameter and moment), MESH_TRAIN steps of
    AdamW; in fp32 the losses and every parameter leaf afterwards, gathered,
    against world size 1 (TRAIN_LOSS_RTOL, GRAD_TOL of max(1, max|p|)); in
    bf16 by close_bf16's rules against world size 1 in bf16 and in fp32
    from the bf16-rounded weights. Rank 0 runs the references first and
    keeps their parameters on the host. Returns the bytes and peak."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.models import model as tmodel
    from repro_torch.models.transformer import flatten, nest
    from repro_torch.parallel import comm
    from repro_torch.parallel.sharding import ParallelCtx
    from repro_torch.train.trainer import training_ctx
    tr = MESH_TRAIN
    ocfg = OptimizerConfig(**TRAIN_OPT)
    batches = [mesh_batch(mesh_cfg(1, "float32"), tr["batch"], tr["seq"], s)
               for s in range(tr["steps"])]
    steps = {"float32": batches, "bfloat16": batches}
    ctx = ParallelCtx(mesh=meshes["data2xtp2"], fsdp="data")
    tctx = training_ctx(ctx)
    refs = {}
    t0 = time.perf_counter()
    if rk.rank == 0:
        for name, dtype, rounded in (("fp32", "float32", False),
                                     ("bf16", "bfloat16", False),
                                     ("fp32 from bf16", "float32", True)):
            cfg = mesh_cfg(tr["layers"], dtype)
            params = None
            if rounded:
                params = nest({k: v.float() for k, v in flatten(
                    tmodel.init_params(mesh_cfg(tr["layers"], "bfloat16"),
                                       seed=1, device=rk.dev)).items()})
            losses, p, _ = train_steps(cfg, ocfg, steps[dtype], rk.dev,
                                       params=params)
            refs[name] = (losses, {k: v.detach().cpu()
                                   for k, v in flatten(p).items()})
            if name == "fp32":
                whole_bytes = tree_bytes(p)
            del p
            free(rk.dev)
        rk.say(f"  [mesh-train] world size 1 references "
               f"({time.perf_counter() - t0:.1f} s): losses "
               f"{ {k: v[0] for k, v in refs.items()} }")
    dist.barrier()
    out = {}
    for name, dtype in (("fp32", "float32"), ("bf16", "bfloat16")):
        cfg = mesh_cfg(tr["layers"], dtype)
        if rk.dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        comm.reset_counters()
        t0 = time.perf_counter()
        losses, params, opt = rk.counted(
            lambda: train_steps(cfg, ocfg, steps[dtype], rk.dev, ctx=ctx),
            leg="mesh-train")
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 1e9 \
            if rk.dev.type == "cuda" else 0.0
        rest = tree_bytes(params) + tree_bytes(opt["mu"]) + \
            tree_bytes(opt["nu"])
        # the head: this rank's lm_head shard at rest, gathered over fsdp
        # where used (D, V_loc), and the fp32 logits of its rows a step,
        # beside the whole head's (D, V) and the whole vocabulary's logits
        head = params["lm_head"]
        rows = tr["batch"] // 2 * tr["seq"]
        V, D = cfg.padded_vocab_size, cfg.d_model
        out[name] = {"bytes": dict(comm.BYTES), "peak_gb": peak,
                     "rest_gb": rest / 1e9, "wall": wall,
                     "op_dim": {f"{op}/{d}": n for (op, d), n in
                                comm.OP_DIM_BYTES.items()},
                     "head": {"lm_head": head.numel() * head.element_size(),
                              "lm_head_used": D * head.shape[1]
                              * head.element_size(),
                              "lm_head_whole": D * V * head.element_size(),
                              "logits": rows * head.shape[1] * 4,
                              "logits_whole": rows * V * 4}}
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, losses)
        if any(x != every[0] for x in every):
            raise AssertionError(f"[mesh-train] ranks' losses differ: {every}")
        if rk.rank == 0:
            rk.say(f"  [mesh-train] {name} data2xtp2 fsdp data "
                   f"({tr['layers']} layers, B={tr['batch']}, "
                   f"S={tr['seq']}, {len(steps[dtype])} AdamW steps): losses "
                   f"{losses}, {wall:.1f} s; rank 0 holds "
                   f"{rest / 1e9:.3f} GB of parameters and moments at rest "
                   f"(world size 1: {ws1_rest(whole_bytes, dtype):.3f} GB), "
                   f"peak {peak:.2f} GB")
        worst = (0.0, "")
        for k, x in gathered(params, tctx):
            if rk.rank != 0:
                continue
            if name == "fp32":
                y = refs["fp32"][1][k].to(rk.dev)
                bound = GRAD_TOL * max(1.0, y.abs().max().item())
                worst = max(worst, ((x - y).abs().max().item() / bound, k))
            else:
                e_m, e_o = rk.bf16_errs(
                    x, refs["fp32 from bf16"][1][k].to(rk.dev),
                    refs["bf16"][1][k].to(rk.dev), grad=True)
                ratio = e_m / (BF16_PARITY_FACTOR * e_o + BF16_PARITY_ABS)
                worst = max(worst, (ratio, k))
        if rk.rank == 0:
            if name == "fp32":
                errs = [abs(a - b) / abs(b)
                        for a, b in zip(losses, refs["fp32"][0])]
                rk.say(f"  [mesh-train] fp32 against world size 1: loss rel "
                       f"err {max(errs):.2e} (tol {TRAIN_LOSS_RTOL:g}); "
                       f"worst parameter {worst[1]} at {worst[0]:.2f} of "
                       f"GRAD_TOL·max(1, max|p|)")
                if not (max(errs) <= TRAIN_LOSS_RTOL and worst[0] <= 1.0):
                    raise AssertionError(f"[mesh-train] fp32: {errs} {worst}")
            else:
                rk.close_bf16("mesh-train losses",
                              torch.tensor(losses),
                              torch.tensor(refs["fp32 from bf16"][0]),
                              torch.tensor(refs["bf16"][0]), grad=False)
                rk.say(f"  [mesh-train] bf16 parameters: worst leaf "
                       f"{worst[1]} at {worst[0]:.2f} of close_bf16's bound "
                       f"(rel norm err against fp32 from the bf16 weights, "
                       f"{BF16_PARITY_FACTOR:g}x world size 1's in bf16 + "
                       f"{BF16_PARITY_ABS:g})")
                if not worst[0] <= 1.0:
                    raise AssertionError(f"[mesh-train] bf16: {worst}")
        del params, opt
        free(rk.dev)
    return out


# [mesh-train]'s ssm and hybrid legs: zamba2-1.2b and rwkv6-1.6b at full
# width, cut by depth, on data2 × tp2 (fsdp "data") in fp32: 7 layers of
# zamba2 are one shared-block invocation (hybrid_attn_every 6) and a
# trailing trunk layer, 2 of rwkv6 two blocks. Each data rank's rows of a
# step are 2048 tokens, at least d_model: sharding.column_matmul's weight
# route (ssm/w_in and rwkv/cm_w_r gathered), which training takes at full
# size; the decode steps (one row a data rank) take the activation route
MESH_SSM = dict(layers={HYBRID_ARCH: 7, SSM_ARCH: 2}, batch=2, seq=2048,
                steps=2, prompt=512, decode=3)
# fp32 decode logits of the mesh against world size 1: the shards change
# only the order of the sums (the reduce of the row-parallel outputs)
MESH_SSM_LOGITS_TOL = 1e-4


def ssm_model_gathers(cfg, phase, rows, steps):
    """The bytes one rank gathers over the model dim (comm's "gather" and
    "all_gather" ops) in `steps` steps of an ssm or hybrid config on its
    heads, in the config's dtype: a train step of at least d_model tokens
    a rank (the weight route) gathers ssm/w_in once a forward (twice
    under remat: the backward reruns the block) and sums its gradient,
    and gathers rwkv/cm_w_r once a forward; a decode step of `rows` rows
    (the activation route) gathers no parameter: each layer's w_in or
    cm_w_r output, Mamba2's new conv input of x, and the logits."""
    import torch
    from repro_torch.models import mamba2
    from repro_torch.models.transformer import torch_dtype
    f = torch.empty((), dtype=torch_dtype(cfg.dtype)).element_size()
    D, L = cfg.d_model, cfg.num_layers
    forwards = 1 if cfg.remat == "none" else 2
    if cfg.family == "hybrid":
        d_inner, H, _ = mamba2.dims(D, cfg.ssm)
        W = 2 * d_inner + 2 * cfg.ssm.state_dim + H
        per = {"train": (forwards + 1) * D * W,
               "decode": rows * (W + d_inner)}[phase]
    else:
        per = {"train": forwards * D * D, "decode": rows * D}[phase]
    logits = rows * cfg.padded_vocab_size if phase == "decode" else 0
    return steps * (L * per + logits) * f


def model_gathers(op_dim):
    return op_dim.get(("gather", "model"), 0) + \
        op_dim.get(("all_gather", "model"), 0)


def mesh_ssm_decode(cfg, params, prompt, feed, dev, ctx=None):
    """The prefill of `prompt` (forward with return_cache) and a decode
    step a column of `feed`: the decode steps' logits (rows gathered over
    the data dims under a mesh ctx) and the decode steps' bytes by (op,
    mesh dim)."""
    import torch
    from repro_torch.models import model as tmodel
    from repro_torch.parallel import comm
    from repro_torch.parallel.plan import local_batch
    from repro_torch.train.trainer import training_ctx
    tctx = training_ctx(ctx)
    data = [] if tctx is None else [tctx.axis(a) for a in tctx.data_axes]
    toks = {"tokens": prompt, "feed": feed}
    if tctx is not None:
        toks = local_batch(toks, tctx)
    toks = {k: v.to(dev) for k, v in toks.items()}
    with torch.no_grad():
        _, _, cache = tmodel.forward(params, cfg, {"tokens": toks["tokens"]},
                                     ctx=tctx, return_cache=True,
                                     cache_max_seq=prompt.shape[1] + 8,
                                     cache_dtype=torch.float32)
        comm.reset_counters()
        out = []
        for i in range(feed.shape[1]):
            lt, cache = tmodel.decode_step(params, cfg,
                                           toks["feed"][:, i:i + 1], cache,
                                           ctx=tctx)
            out.append(comm.gather(lt, 0, data))
    return out, dict(comm.OP_DIM_BYTES)


def mesh_ssm_legs(rk, meshes):
    """[mesh-train]'s zamba2-1.2b and rwkv6-1.6b legs (MESH_SSM) on
    data2 × tp2, fsdp "data": MESH_SSM steps of AdamW in fp32, every
    Mamba2 and RWKV6 block on this rank's heads, the losses and every
    parameter afterwards against world size 1 (TRAIN_LOSS_RTOL, GRAD_TOL
    of max(1, max|p|)); then the prefill of a prompt and MESH_SSM
    decode steps from the seeded weights, the logits against world size
    1's (MESH_SSM_LOGITS_TOL). The model-dim gathers of the train step and
    of the decode steps must be ssm_model_gathers' exactly; zamba2's
    shared block launches kernels 1r and 2 in training, 1 in the prefill
    and 3 in decode on its head shards (counted by leg). Rank 0 runs the
    references first and keeps their parameters on the host."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.models import model as tmodel
    from repro_torch.models.transformer import flatten
    from repro_torch.parallel import comm
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.sharding import ParallelCtx
    from repro_torch.train.trainer import training_ctx
    run = MESH_SSM
    ocfg = OptimizerConfig(**TRAIN_OPT)
    ctx = ParallelCtx(mesh=meshes["data2xtp2"], fsdp="data")
    tctx = training_ctx(ctx)
    out = {}
    for arch, layers in run["layers"].items():
        cfg = dataclasses.replace(get_config(arch), num_layers=layers,
                                  dtype="float32")
        batches = [mesh_batch(cfg, run["batch"], run["seq"], s)
                   for s in range(run["steps"])]
        gen = torch.Generator().manual_seed(7)
        prompt = torch.randint(0, cfg.vocab_size,
                               (run["batch"], run["prompt"]), generator=gen)
        feed = torch.randint(0, cfg.vocab_size, (run["batch"], run["decode"]),
                             generator=gen)
        ref = None
        t0 = time.perf_counter()
        if rk.rank == 0:
            losses, p, _ = train_steps(cfg, ocfg, batches, rk.dev)
            ref = (losses, {k: v.detach().cpu()
                            for k, v in flatten(p).items()})
            del p
            free(rk.dev)
            whole = tmodel.init_params(cfg, seed=1, device=rk.dev)
            ref_logits = [x.cpu() for x in mesh_ssm_decode(
                cfg, whole, prompt, feed, rk.dev)[0]]
            del whole
            free(rk.dev)
            rk.say(f"  [mesh-train] {arch} world size 1 references "
                   f"({time.perf_counter() - t0:.1f} s): losses {losses}")
        dist.barrier()
        if rk.dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        comm.reset_counters()
        t0 = time.perf_counter()
        losses, params, opt = rk.counted(
            lambda: train_steps(cfg, ocfg, batches, rk.dev, ctx=ctx),
            leg=f"mesh-train {arch} train")
        wall = time.perf_counter() - t0
        train_op_dim = dict(comm.OP_DIM_BYTES)
        peak = torch.cuda.max_memory_allocated() / 1e9 \
            if rk.dev.type == "cuda" else 0.0
        rest = tree_bytes(params) + tree_bytes(opt["mu"]) + \
            tree_bytes(opt["nu"])
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, losses)
        if any(x != every[0] for x in every):
            raise AssertionError(f"[mesh-train] {arch} ranks' losses "
                                 f"differ: {every}")
        worst = (0.0, "")
        for k, x in gathered(params, tctx):
            if rk.rank == 0:
                y = ref[1][k].to(rk.dev)
                bound = GRAD_TOL * max(1.0, y.abs().max().item())
                worst = max(worst, ((x - y).abs().max().item() / bound, k))
        del params, opt
        free(rk.dev)
        mem = ranks_memory(rk)
        params = shd.shard_tree(tmodel.init_params(cfg, seed=1,
                                                   device=rk.dev), tctx)
        free(rk.dev)
        logits, dec_op_dim = rk.counted(
            lambda: mesh_ssm_decode(cfg, params, prompt, feed, rk.dev, ctx),
            leg=f"mesh-train {arch} prefill and decode")
        del params
        free(rk.dev)
        want = {"train": ssm_model_gathers(cfg, "train", 0, run["steps"]),
                "decode": ssm_model_gathers(cfg, "decode", run["batch"] // 2,
                                            run["decode"])}
        got = {"train": model_gathers(train_op_dim),
               "decode": model_gathers(dec_op_dim)}
        out[arch] = {"bytes": {f"{op}/{d}": n for (op, d), n in
                               train_op_dim.items()},
                     "peak_gb": peak, "rest_gb": rest / 1e9, "wall": wall,
                     "decode_op_dim": {f"{op}/{d}": n for (op, d), n in
                                       dec_op_dim.items()},
                     "model_gathers": got}
        if rk.rank == 0:
            errs = [abs(a - b) / abs(b) for a, b in zip(losses, ref[0])]
            rk.say(f"  [mesh-train] {arch} data2xtp2 fsdp data fp32 "
                   f"({layers} layers, B={run['batch']}, S={run['seq']}, "
                   f"{run['steps']} AdamW steps, remat {cfg.remat}): losses "
                   f"{losses}, {wall:.1f} s, loss rel err {max(errs):.2e} "
                   f"(tol {TRAIN_LOSS_RTOL:g}); worst parameter {worst[1]} "
                   f"at {worst[0]:.2f} of GRAD_TOL·max(1, max|p|); rank 0 "
                   f"holds {rest / 1e9:.3f} GB of parameters and moments "
                   f"at rest, peak {peak:.2f} GB; each rank's (resident "
                   f"GB, cached pinned GB) {mem}")
            rk.say(f"  [mesh-train] {arch} model-dim gather bytes (gather "
                   f"+ all_gather) {got}, expected {want} (the weight "
                   f"route's ssm/w_in and rwkv/cm_w_r in training, the "
                   f"activation route's outputs in decode); rank 0's bytes "
                   f"by (op/mesh dim): train {out[arch]['bytes']}, "
                   f"{run['decode']} decode steps "
                   f"{out[arch]['decode_op_dim']}")
            if not (max(errs) <= TRAIN_LOSS_RTOL and worst[0] <= 1.0):
                raise AssertionError(f"[mesh-train] {arch}: {errs} {worst}")
            for i, (a, b) in enumerate(zip(logits, ref_logits)):
                rk.close(f"[mesh-train] {arch} decode step {i} logits", a,
                         b.to(rk.dev), MESH_SSM_LOGITS_TOL)
        if got != want:
            raise AssertionError(f"[mesh-train] {arch} rank {rk.rank} "
                                 f"model-dim gathers {got}, expected {want}")
        if rk.dev.type == "cuda" and cfg.family == "hybrid":
            by = rk.by_leg
            require_launches(by[f"mesh-train {arch} train"],
                             ("blockwise_causal_attn(return_residuals)",
                              "blockwise_causal_attn_bwd"), f"{arch} train")
            require_launches(by[f"mesh-train {arch} prefill and decode"],
                             ("blockwise_causal_attn", "decode_attn"),
                             f"{arch} prefill and decode")
    return out


def stacked_compressed_steps(cfg, ocfg, batches, dev, n_pods=2):
    """The compressed cross-pod step at world size 1: each pod's gradient of
    the whole model on its rows, compressed_pod_reduce on the stacked
    gradients, clip, AdamW. Returns the losses (the pods' mean)."""
    import torch
    from repro_torch.models import model as tmodel
    from repro_torch.models.transformer import flatten, nest
    from repro_torch.optim import (adamw_init, adamw_update,
                                   clip_by_global_norm, make_schedule)
    from repro_torch.train import compressed_dp as cdp
    params = tmodel.init_params(cfg, seed=1, device=dev)
    leaves = flatten(params)
    for p in leaves.values():
        p.requires_grad_(True)
    opt = adamw_init(params, ocfg)
    sched = make_schedule(ocfg)
    res = cdp.init_residual(params, n_pods)
    losses = []
    for b in batches:
        rows = b["tokens"].shape[0] // n_pods
        per, pod_loss = [], []
        for i in range(n_pods):
            hb = {k: v[i * rows:(i + 1) * rows].to(dev) for k, v in b.items()}
            loss, met = tmodel.loss_fn(params, cfg, hb)
            per.append(torch.autograd.grad(loss, list(leaves.values())))
            pod_loss.append(met["loss"].detach().item())
        gp = nest({k: torch.stack([g[j] for g in per])
                   for j, k in enumerate(leaves)})
        del per
        red, res = cdp.compressed_pod_reduce(gp, res, n_pods)
        del gp
        red, _ = clip_by_global_norm(red, ocfg.grad_clip)
        params, opt = adamw_update(red, opt, params, ocfg, sched(opt["step"]))
        losses.append(sum(pod_loss) / n_pods)
    return losses


def mesh_compressed_leg(rk):
    """[mesh-train-compressed]: pod2 × data2 (fsdp "data", the parameters
    replicated over the pods), MESH_COMPRESSED, bf16 with bf16 moments:
    MESH_COMPRESSED steps of the int8 cross-pod step against the same
    algorithm at world size 1, each loss within COMPRESSED_LOSS_TOL; the
    gap of both to the exact step is logged (see COMPRESSED_LOSS_TOL)."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as tmodel
    from repro_torch.parallel import comm
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.sharding import ParallelCtx
    from repro_torch.train import compressed_dp as cdp
    m = MESH_COMPRESSED
    cfg = mesh_cfg(m["layers"], "bfloat16")
    ocfg = OptimizerConfig(**COMPRESSED_OPT, moment_dtype="bfloat16")
    batches = [mesh_batch(cfg, m["batch"], m["seq"], 10 + s)
               for s in range(m["steps"])]
    exact = stacked = None
    if rk.rank == 0:
        exact, p, o = train_steps(cfg, ocfg, batches, rk.dev)
        del p, o
        free(rk.dev)
        stacked = stacked_compressed_steps(cfg, ocfg, batches, rk.dev)
        free(rk.dev)
    dist.barrier()
    mesh = make_mesh((2, 2, 1), ("pod", "data", "model"),
                     device_type=rk.dev.type)
    ctx = ParallelCtx(mesh=mesh, fsdp="data")
    if rk.dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    comm.reset_counters()
    t0 = time.perf_counter()
    inner = cdp.inner_ctx(ctx)
    params = shd.shard_tree(tmodel.init_params(cfg, seed=1, device=rk.dev),
                            inner)
    free(rk.dev)
    step = cdp.make_compressed_train_step(cfg, ocfg, ctx)
    res = [cdp.init_local_residual(params)]

    def compressed(params_, opt, b):
        params_, opt, res[0], met = step(params_, opt, res[0], b)
        return params_, opt, met

    losses, params, opt = rk.counted(lambda: train_steps(
        cfg, ocfg, batches, rk.dev, params=params, step=compressed),
        leg="mesh-train-compressed")
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9 \
        if rk.dev.type == "cuda" else 0.0
    rest = sum(tree_bytes(t) for t in (params, opt["mu"], opt["nu"], res[0]))
    out = {"bytes": dict(comm.BYTES), "peak_gb": peak, "rest_gb": rest / 1e9,
           "wall": wall}
    if rk.rank == 0:
        errs = [abs(a - b) for a, b in zip(losses, stacked)]
        gap = [abs(a - b) for a, b in zip(losses, exact)]
        gap1 = [abs(a - b) for a, b in zip(stacked, exact)]
        rk.say(f"  [mesh-train-compressed] pod2xdata2 fsdp data, bf16, "
               f"{m['layers']} layer(s), B={m['batch']}, S={m['seq']}: losses "
               f"{losses}; world size 1, the same algorithm {stacked}: "
               f"|diff| max {max(errs):.2e} (tol {COMPRESSED_LOSS_TOL:g}); "
               f"against the exact step {exact}: mesh {max(gap):.2e}, world "
               f"size 1 {max(gap1):.2e}; bytes by op {dict(comm.BYTES)} "
               f"(the int8 codes cross the pods as 'stack'); rank 0 holds "
               f"{rest / 1e9:.3f} GB at rest (parameters, moments, residual), "
               f"peak {peak:.2f} GB, {wall:.1f} s")
        if not max(errs) < COMPRESSED_LOSS_TOL:
            raise AssertionError(f"[mesh-train-compressed] {losses} vs "
                                 f"{stacked}")
    del params, opt, res
    free(rk.dev)
    return out


def mesh_elastic_leg(rk, meshes, tmp):
    """[mesh-elastic]: a world-size-1 Trainer checkpoint (MESH_ELASTIC, fp32,
    full width at reduced depth) resumed on data2 × tp2 (fsdp "data"), each
    rank reading the whole leaves and keeping its shards, then continued;
    the parameters, gathered, equal the world-size-1 continuation within
    GRAD_TOL of max(1, max|p|)."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import OptimizerConfig, TrainConfig
    from repro_torch.data.pipeline import batches
    from repro_torch.models.transformer import flatten
    from repro_torch.parallel.sharding import ParallelCtx
    from repro_torch.train import Trainer
    e = MESH_ELASTIC
    cfg = mesh_cfg(e["layers"], "float32")
    d = os.path.join(tmp, "elastic")
    tcfg = TrainConfig(seq_len=e["seq"], global_batch=e["batch"],
                       steps=e["steps"][0], log_every=99,
                       checkpoint_every=e["steps"][0], checkpoint_dir=d,
                       optimizer=OptimizerConfig(**{**TRAIN_OPT,
                                                    "warmup_steps": 1}))
    later = dataclasses.replace(tcfg, steps=e["steps"][1])

    def resume(ctx):
        """Restore the latest checkpoint and run to later.steps, saving
        nothing; returns (start, params, the Trainer's ctx)."""
        tr = Trainer(cfg, later, device=rk.dev, ctx=ctx,
                     log_fn=lambda s: None)
        params, opt, dstate, start = tr.restore_or_init()
        stream = batches(tr.corpus, dstate, batch=later.global_batch,
                         seq=later.seq_len, objective=cfg.objective)
        for _ in range(start, later.steps):
            b, dstate = next(stream)
            params, opt, _ = tr.train_step(
                params, opt, {k: torch.from_numpy(v).to(rk.dev)
                              for k, v in b.items()})
        return start, params, tr.ctx

    ref = None
    t0 = time.perf_counter()
    if rk.rank == 0:
        # world size 1: the steps up to the checkpoint, the checkpoint, and
        # the continuation from the same state in memory (a restore of it
        # gives back the same tensors)
        tr = Trainer(cfg, later, device=rk.dev, log_fn=lambda s: None)
        p, opt, dstate, _ = tr.restore_or_init()
        stream = batches(tr.corpus, dstate, batch=later.global_batch,
                         seq=later.seq_len, objective=cfg.objective)
        for s in range(later.steps):
            b, dstate = next(stream)
            p, opt, _ = tr.train_step(p, opt, {
                k: torch.from_numpy(v).to(rk.dev) for k, v in b.items()})
            if s + 1 == tcfg.steps:
                tr.save(s + 1, p, opt, dstate)
                t_save = time.perf_counter() - t0
        gb = sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in
                 os.walk(d) for f in fs) / 1e9
        ref = {k: v.detach().cpu() for k, v in flatten(p).items()}
        del p, opt, tr
        free(rk.dev)
        rk.say(f"  [mesh-elastic] world size 1: {e['steps'][0]} steps and "
               f"a {gb:.2f} GB checkpoint ({t_save:.1f} s), continued to "
               f"{e['steps'][1]}; host memory in use {host_gb()} GB")
    dist.barrier()
    t1 = time.perf_counter()
    start, params, tctx = rk.counted(lambda: resume(ParallelCtx(
        mesh=meshes["data2xtp2"], fsdp="data")), leg="mesh-elastic")
    wall = time.perf_counter() - t1
    rk.say(f"  [mesh-elastic] resumed on 4 ranks: host memory in use "
           f"{host_gb()} GB; each rank's (resident GB, cached pinned GB) "
           f"{ranks_memory(rk)}")
    if start != e["steps"][0]:
        raise AssertionError(f"[mesh-elastic] resumed at {start}")
    worst = (0.0, "")
    for k, x in gathered(params, tctx):
        if rk.rank == 0:
            y = ref[k].to(rk.dev)
            bound = GRAD_TOL * max(1.0, y.abs().max().item())
            worst = max(worst, ((x - y).abs().max().item() / bound, k))
    rk.say(f"  [mesh-elastic] 1 rank -> {dist.get_world_size()} ranks: "
           f"resumed at step {start}, continued to {e['steps'][1]} in "
           f"{wall:.1f} s; worst parameter {worst[1]} at {worst[0]:.2f} of "
           f"GRAD_TOL·max(1, max|p|)")
    if not worst[0] <= 1.0:
        raise AssertionError(f"[mesh-elastic] {worst}")
    del params
    free(rk.dev)
    return time.perf_counter() - t0


def mesh_serve_leg(rk, meshes):
    """[mesh-serve]: qwen3-8b at full width and MESH_SERVE layers on data 1
    × tp 2: ranks 0 and 1 serve on their row of data2xtp2 (its "model"
    sub-mesh; the pools' KV heads over tp, rows whole on both) while ranks
    2 and 3 serve the same requests at world size 1 for the references
    (MESH_SERVE_REFS). MESH_SERVE's 8 requests go through the dense pool
    with chunked admission (P = SERVE_PREFILL_CHUNK) and through the paged
    int8 pool; in fp32 both tp ranks' tokens equal world size 1's token for
    token (and each other's); in bf16 the dense pool's agreement is
    logged. Returns each leg's wall."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.models import model as tmodel
    from repro_torch.parallel import comm
    from repro_torch.parallel.sharding import ParallelCtx
    from repro_torch.serving import ServingEngine
    s = MESH_SERVE
    ctx = ParallelCtx(mesh=meshes["data2xtp2"]["model"])
    rng = np.random.default_rng(5)
    cfg0 = mesh_cfg(s["layers"], "float32")
    prompts = [list(map(int, rng.integers(4, cfg0.vocab_size, n)))
               for n in s["lens"]]
    P = SERVE_PREFILL_CHUNK
    pools = {"dense chunked": dict(prefill_chunk=P),
             "paged int8": dict(prefill_chunk=P, cache_format="paged")}
    mine = {}
    for leg in MESH_SERVE_LEGS:
        dtype, name = leg
        if rk.rank >= 2 and MESH_SERVE_REFS[leg] != rk.rank:
            continue
        cfg = mesh_cfg(s["layers"], dtype)
        if mine.get("dtype") != dtype:
            mine.pop("params", None)
            free(rk.dev)
            mine["params"] = tmodel.init_params(cfg, seed=1, device=rk.dev)
            mine["dtype"] = dtype
        eng = ServingEngine(mine["params"], cfg, max_seq=2048, device=rk.dev,
                            cache_dtype=getattr(torch, dtype),
                            decode_chunk=16, ctx=ctx if rk.rank < 2 else None,
                            **pools[name])
        if rk.rank >= 2:
            mine[leg] = eng.serve(prompts, s["new"], max_batch=s["pool"])
            continue
        comm.reset_counters()
        t0 = time.perf_counter()
        got = rk.counted(lambda: eng.serve(prompts, s["new"],
                                           max_batch=s["pool"]),
                         leg="mesh-serve")
        mine[leg] = (got, time.perf_counter() - t0, dict(comm.BYTES))
    mine.pop("params", None)
    free(rk.dev)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    out = {}
    for leg in MESH_SERVE_LEGS:
        dtype, name = leg
        (got, wall, nbytes), (got1, _, _) = every[0][leg], every[1][leg]
        one = every[MESH_SERVE_REFS[leg]][leg]
        if got != got1:
            raise AssertionError(f"[mesh-serve] {dtype} {name}: the tp "
                                 "ranks' tokens differ")
        same = sum(a == b for a, b in zip(got, one))
        rk.say(f"  [mesh-serve] {dtype} {name} data1xtp2 (ranks 0, 1): "
               f"{same}/{len(one)} requests token-identical to world size 1 "
               f"(rank {MESH_SERVE_REFS[leg]}), both tp ranks' tokens equal; "
               f"comm bytes by op {nbytes}, {wall:.1f} s")
        if dtype == "float32" and same != len(one):
            raise AssertionError(f"[mesh-serve] {name}: {got} vs {one}")
        out[f"{dtype} {name}"] = wall
    return out


def launcher_start(dev):
    """The launcher under torchrun: 2 ranks sharing the card over gloo,
    --mesh local, the SMOKE config, started without waiting (it runs
    beside the [mesh] spawn, whose walls measure nothing). Returns the
    state launcher_finish reads."""
    import tempfile
    tmp = tempfile.TemporaryDirectory()
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "src"),
        OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run",
           "--standalone", "--nproc-per-node", "2",
           "-m", "repro_torch.launch.train",
           "--arch", "qwen3-8b", "--smoke", "--steps", "4", "--mesh",
           "local", "--dist-backend", "gloo", "--device", dev.type,
           "--ckpt-dir", tmp.name]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env,
                            start_new_session=True)
    return proc, tmp, time.perf_counter()


def launcher_stop(state):
    """Kill the launcher's process group (a phase beside it failed)."""
    proc, tmp, _ = state
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
    tmp.cleanup()


def launcher_finish(state, timeout=600):
    """Wait for the launcher; exit code 0 required."""
    proc, tmp, t0 = state
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        launcher_stop(state)
        raise AssertionError(f"torchrun launch still running after "
                             f"{timeout} s")
    tmp.cleanup()
    tail = out.strip().splitlines()[-3:]
    log(f"[launch] torchrun --standalone --nproc-per-node 2 -m "
        f"repro_torch.launch.train --smoke --mesh local --dist-backend "
        f"gloo (beside the [mesh] spawn): exit {proc.returncode}, "
        f"{time.perf_counter() - t0:.1f} s from its start to the end of "
        f"the wait; last lines {tail}")
    if proc.returncode != 0:
        raise AssertionError(f"torchrun launch failed:\n{out}")


def mesh_rank(rank, world, tmp, dev_type):
    """One rank of the [mesh] and [mesh-moe] phases (torch.multiprocessing
    spawns it: the kernels are built already, and the rank loads them).
    Rank 0 logs; every rank holds its own results to its own world-size-1
    references, and any failure fails the spawn."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "src"))
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_ranks, make_local_mesh
    from repro_torch.parallel import comm
    torch.set_num_threads(2)
    dev = torch.device(dev_type)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    init_ranks("gloo", "file://" + os.path.join(tmp, "rendezvous"), rank,
               world)
    try:
        rk = MeshRank(rank, dev)
        t0 = time.perf_counter()
        meshes = {n: make_local_mesh(ms, ss, device_type=dev.type)
                  for n, (ms, ss) in MESH_LAYOUTS.items()}
        meshes["tp4"] = make_local_mesh(4, device_type=dev.type)
        rk.say(f"[mesh] {world} gloo ranks on {dev}: meshes "
               f"{ {n: tuple(m.mesh.shape) for n, m in meshes.items()} } "
               f"after {time.perf_counter() - t0:.1f} s; the comm helpers "
               f"hand {dev.type} tensors to gloo directly")
        walls = {}
        comm.reset_counters()
        mesh_attention_legs(rk, meshes)
        mesh_exact_leg(rk, meshes)
        free(dev)
        peak = mesh_train_leg(rk, meshes)
        walls["mesh"] = time.perf_counter() - t0
        mesh_bytes = dict(comm.BYTES)
        before = ranks_memory(rk)
        free(dev)
        rk.say(f"  [mesh] done: host memory in use {host_gb()} GB; each "
               f"rank's (resident GB, cached pinned GB) before and after "
               f"freeing {before} {ranks_memory(rk)}")
        t1 = time.perf_counter()
        comm.reset_counters()
        mesh_moe_legs(rk, meshes)
        walls["mesh-moe"] = time.perf_counter() - t1
        moe_bytes = dict(comm.BYTES)
        free(dev)
        new = {}
        for leg, fn in (("mesh-train", lambda: {
                            **mesh_train_legs(rk, meshes),
                            **mesh_ssm_legs(rk, meshes)}),
                        ("mesh-train-compressed",
                         lambda: mesh_compressed_leg(rk)),
                        ("mesh-elastic",
                         lambda: mesh_elastic_leg(rk, meshes, tmp)),
                        ("mesh-serve", lambda: mesh_serve_leg(rk, meshes))):
            t1 = time.perf_counter()
            new[leg] = fn()
            walls[leg] = time.perf_counter() - t1
            before = ranks_memory(rk)
            free(dev)
            rk.say(f"  [{leg}] done: host memory in use {host_gb()} GB; "
                   f"each rank's (resident GB, cached pinned GB) before "
                   f"and after freeing {before} {ranks_memory(rk)}")
        mine = {"launches": dict(rk.launches), "peak_gb": peak,
                "bytes": {"mesh": mesh_bytes, "mesh-moe": moe_bytes},
                "new": new, "by_leg": {k: dict(v)
                                       for k, v in rk.by_leg.items()}}
        every = [None] * world
        dist.all_gather_object(every, mine)
        if rank == 0:
            with open(os.path.join(tmp, "result.json"), "w") as fh:
                json.dump({"ranks": every, "walls": walls}, fh)
    finally:
        dist.destroy_process_group()


def mesh_phases(dev):
    """[mesh] and [mesh-moe]: MESH_WORLD gloo ranks sharing the card run
    every route of the plan on its shards against world size 1. Returns
    the launches of the mesh legs summed over the ranks."""
    import tempfile
    import torch
    import torch.multiprocessing as mp
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    log(f"[mesh] before the spawn: host memory in use {host_gb()} GB; this "
        f"process resident {rss_gb()} GB, cached pinned {pinned_gb()} GB")
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(mesh_rank, args=(MESH_WORLD, tmp, dev.type),
                 nprocs=MESH_WORLD, join=True)
        with open(os.path.join(tmp, "result.json")) as fh:
            res = json.load(fh)
    ranks = res["ranks"]
    launches = collections.Counter()
    for r in ranks:
        launches.update(r["launches"])
    for phase in ("mesh", "mesh-moe"):
        total = collections.Counter()
        for r in ranks:
            total.update(r["bytes"][phase])
        log(f"[{phase}] comm bytes a rank, summed over the {len(ranks)} "
            f"ranks, by op: {dict(total)}; rank 0: "
            f"{ranks[0]['bytes'][phase]}")
    log(f"[mesh] peak GB of each rank in the train step (rank 0 holds "
        f"the world-size-1 reference's gradients on the host): "
        f"{[round(r['peak_gb'], 2) for r in ranks]}")
    for leg in ("mesh-train", "mesh-train-compressed"):
        runs = ranks[0]["new"][leg]
        runs = runs if leg == "mesh-train" else {"bf16": runs}
        for name in runs:
            got = [r["new"][leg] if leg != "mesh-train" else
                   r["new"][leg][name] for r in ranks]
            total = collections.Counter()
            for g in got:
                total.update(g["bytes"])
            log(f"[{leg}] {name}: GB at rest per rank (parameters and "
                f"moments{', residual' if leg != 'mesh-train' else ''}) "
                f"{[round(g['rest_gb'], 3) for g in got]}, peak GB "
                f"{[round(g['peak_gb'], 2) for g in got]}; comm bytes by op "
                f"summed over the ranks {dict(total)}, rank 0 "
                f"{got[0]['bytes']}")
            if "head" in got[0]:
                log(f"[{leg}] {name}: rank 0's comm bytes by (op/mesh dim) "
                    f"over the steps {got[0]['op_dim']}; the head's bytes "
                    f"(rank 0: lm_head shard and fp32 logits of its rows a "
                    f"step, beside the whole vocabulary's) {got[0]['head']}")
    legs = ("mesh-train", "mesh-train-compressed", "mesh-elastic",
            "mesh-serve")
    # and mesh_ssm_legs' own ("mesh-train <arch> train", ...)
    legs += tuple(sorted({k for r in ranks for k in r["by_leg"]}
                         - set(legs)))
    for leg in legs:
        total = collections.Counter()
        for r in ranks:
            total.update(r["by_leg"].get(leg, {}))
        log(f"[{leg}] per-shard launches summed over the ranks: "
            f"{ {k: v for k, v in total.items() if v} }")
    log(f"[mesh] per-shard launches summed over the ranks: "
        f"{ {k: v for k, v in launches.items() if v} }")
    for phase, wall in res["walls"].items():
        log(f"[wall] {phase} (rank 0; the ranks time-slice one card: this "
            f"measures nothing about scaling): {wall:.1f} s")
    log(f"[mesh] spawn to join: {time.perf_counter() - t0:.1f} s")
    if dev.type == "cuda":
        require_launches(launches, MESH_KERNELS, "mesh")
    return dict(launches)


def mesh_and_launch_phases(dev, lap):
    """[launch] started, the [mesh] spawn and the world-size-1 NCCL leg
    beside it, then [launch] waited for; `lap(name)` logs each wall.
    Returns mesh_phases' launches."""
    launch = launcher_start(dev)
    try:
        launches = mesh_phases(dev)
        lap("mesh, mesh-moe (spawn to join; [launch] beside it)")
        mesh_nccl_phase(dev)
        lap("mesh NCCL world size 1")
    except BaseException:
        launcher_stop(launch)
        raise
    launcher_finish(launch)
    lap("launch (torchrun, 2 gloo ranks), after the spawn")
    return launches


def mesh_nccl_phase(dev):
    """A world-size-1 NCCL group: the plan resolves with tp = sp = 1 (no
    region) and one train step's loss and gradients of the 2-layer fp32
    qwen3-8b under that ctx equal those without a ctx, bit for bit: the
    NCCL path starts."""
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import (DataState, SyntheticCorpus,
                                           make_causal_batch)
    from repro_torch.launch.mesh import init_ranks, make_local_mesh
    from repro_torch.models import model as tmodel
    from repro_torch.models.transformer import flatten
    from repro_torch.parallel.plan import resolve_attention_plan
    from repro_torch.parallel.sharding import ParallelCtx
    tr = MESH_SHAPES["train"]
    cfg = dataclasses.replace(get_config("qwen3-8b"), num_layers=tr["layers"],
                              dtype="float32")
    with tempfile.TemporaryDirectory() as tmp:
        init_ranks("nccl", "file://" + os.path.join(tmp, "rendezvous"), 0, 1)
        try:
            ctx = ParallelCtx(mesh=make_local_mesh(device_type="cuda"),
                              fsdp="data")
            plan = resolve_attention_plan(cfg.attention, ctx)
            if (plan.tp, plan.sp, plan.manual) != (1, 1, False):
                raise AssertionError(f"world size 1 plan: {plan}")
            batch = make_causal_batch(
                SyntheticCorpus(cfg.vocab_size, seed=0), DataState(0, 0),
                batch=tr["batch"], seq=tr["seq"])
            batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
            params = tmodel.init_params(cfg, seed=1, device=dev)
            leaves = flatten(params)
            for p in leaves.values():
                p.requires_grad_(True)
            res = []
            for c in (ctx, None):
                loss, _ = tmodel.loss_fn(params, cfg, batch, ctx=c)
                res.append((loss.item(), torch.autograd.grad(
                    loss, list(leaves.values()))))
            same = res[0][0] == res[1][0] and all(
                torch.equal(a, b) for a, b in zip(res[0][1], res[1][1]))
            log(f"[mesh] NCCL world size 1 ({dist.get_backend()}): plan tp "
                f"{plan.tp}, sp {plan.sp}, manual {plan.manual}; one train "
                f"step of {cfg.num_layers}-layer fp32 qwen3-8b, loss "
                f"{res[0][0]:.6f}, loss and gradients equal to no ctx: "
                f"{same}")
            if not same:
                raise AssertionError("NCCL world size 1 step differs")
        finally:
            dist.destroy_process_group()


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test "
              "needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "src"))
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import (DataState, SyntheticCorpus,
                                           make_causal_batch, make_mlm_batch)

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(card_line())
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    t_lap = [t_start]

    def lap(name):
        """Log the wall of the phases since the last lap, and the run's."""
        now = time.perf_counter()
        log(f"[wall] {name}: {now - t_lap[0]:.1f} s ({now - t_start:.1f} s "
            f"into the run; host memory in use {host_gb()} GB)")
        t_lap[0] = now

    build_phase()
    lap("build")
    errs = check_phase(dev)
    lap("check")
    records = time_phase(dev, errs)
    lap("time")
    cfg = get_config("qwen3-8b")
    scfg = dataclasses.replace(cfg, num_layers=SERVE_LAYERS)
    params, prompts = serve_setup(dev, scfg)
    mono_outs, serve_launches = serve_phase(dev, scfg, params, prompts)
    lap("serve")
    chunked_launches = serve_chunked_phase(dev, scfg, params, prompts,
                                           mono_outs)
    lap("serve-chunked")
    paged_launches = serve_paged_phase(dev, scfg, params, prompts)
    lap("serve-paged")
    serve_standard_phases(dev, scfg, params, prompts, mono_outs)
    lap("serve-standard, serve-standard-chunked")
    slo_launches = serve_slo_phase(dev, scfg, params)
    lap("serve-slo")
    sample_phase(dev, scfg, params, prompts, mono_outs)
    lap("sample")
    per_token_phase(dev, scfg, params)
    lap("per-token")
    telemetry_phase(dev, scfg, params)
    lap("telemetry")
    slo_parity_launches = serve_slo_parity_phase(dev, cfg)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    lap("serve-slo-parity")
    serve_parity_phase(dev, cfg)
    serve_standard_parity_phase(dev, cfg)
    gc.collect()
    torch.cuda.empty_cache()
    lap("parity, serve-standard-parity")
    new_paths = {}
    for arch in DENSE_ARCHS:
        new_paths.update(serve_dense_phase(dev, arch))
        serve_parity_phase(dev, get_config(arch),
                           f"serve-dense-parity {arch}", paged_layers=1)
        gc.collect()
        torch.cuda.empty_cache()
        lap(f"serve-dense and its parity, {arch}")
    train_launches = train_phase(dev, cfg)
    gc.collect()
    torch.cuda.empty_cache()
    cfg2 = dataclasses.replace(cfg, num_layers=2, dtype="float32")
    parity_batch = make_causal_batch(
        SyntheticCorpus(cfg2.vocab_size, seed=0), DataState(0, 0), batch=1,
        seq=TRAIN_PARITY_SEQ)
    lap("train")
    train_parity_phase(dev, cfg2, parity_batch, "train-parity")
    require_routes("train-parity (fp32)", "simt")
    gc.collect()
    torch.cuda.empty_cache()
    train_parity_bf16_phase(dev, cfg2, parity_batch, "train-parity-bf16")
    require_routes("train-parity-bf16", "tensor cores")
    gc.collect()
    torch.cuda.empty_cache()
    lap("train-parity, train-parity-bf16")
    chunked_ref_phase(dev)
    lap("chunked-ref")
    prefix_rec, prefix_launches = prefix_grad_phase(dev)
    records.append(prefix_rec)
    gc.collect()
    torch.cuda.empty_cache()
    lap("prefix-grad")
    leftover_launches = train_leftovers_phase(dev, cfg)
    lap("train-leftovers")
    tune_launches = tune_phase(dev, cfg, prompts)
    lap("tune")
    for arch in DENSE_ARCHS:
        new_paths[f"train-dense {arch}"] = train_dense_phase(dev, arch)
        dense2 = dataclasses.replace(get_config(arch), num_layers=2,
                                     dtype="float32")
        grad_parity_phase(dev, dense2, make_causal_batch(
            SyntheticCorpus(dense2.vocab_size, seed=0), DataState(0, 0),
            batch=1, seq=TRAIN_PARITY_SEQ), f"train-dense-parity {arch}")
        gc.collect()
        torch.cuda.empty_cache()
        lap(f"train-dense and its parity, {arch}")
    for arch in FRONTEND_ARCHS:
        new_paths.update(frontend_phase(dev, arch))
        lap(f"frontends, {arch}")
    for arch in MOE_ARCHS:
        new_paths.update(serve_moe_phase(dev, arch))
        lap(f"serve-moe, {arch}")
    moe = get_config(MOE_ARCHS[0])
    serve_parity_phase(dev, moe, f"serve-moe-parity {moe.name}",
                       paged_layers=1)
    gc.collect()
    torch.cuda.empty_cache()
    lap("serve-moe-parity")
    new_paths[f"train-moe {moe.name}"] = train_moe_phase(dev, moe.name)
    moe2 = dataclasses.replace(moe, num_layers=2, dtype="float32")
    grad_parity_phase(dev, moe2, make_causal_batch(
        SyntheticCorpus(moe2.vocab_size, seed=0), DataState(0, 0), batch=1,
        seq=TRAIN_PARITY_SEQ), f"train-moe-parity {moe.name}")
    gc.collect()
    torch.cuda.empty_cache()
    lap("train-moe and train-moe-parity")
    for arch, tag in ((HYBRID_ARCH, "serve-hybrid"), (SSM_ARCH, "serve-ssm")):
        new_paths.update(serve_ssm_phase(dev, arch, tag))
        lap(tag)
    serve_hybrid_parity_phase(dev)
    serve_ssm_parity_phase(dev)
    lap("serve-hybrid-parity, serve-ssm-parity")
    for arch, tag in ((HYBRID_ARCH, "train-hybrid"), (SSM_ARCH, "train-ssm")):
        new_paths.update(train_ssm_phase(dev, arch, tag))
        cut = dataclasses.replace(get_config(arch),
                                  num_layers=SSM_PARITY_LAYERS[arch],
                                  dtype="float32")
        cut_batch = make_causal_batch(
            SyntheticCorpus(cut.vocab_size, seed=0), DataState(0, 0),
            batch=1, seq=TRAIN_PARITY_SEQ)
        if arch == SSM_ARCH:
            # the same four steps from the same draw in fp32
            train_ssm_phase(dev, arch, tag, dtype="float32")
            ssm_f64_parity_phase(dev, cut, cut_batch, f"{tag}-parity")
        else:
            train_parity_phase(dev, cut, cut_batch, f"{tag}-parity")
        gc.collect()
        torch.cuda.empty_cache()
        lap(f"{tag} and {tag}-parity")
    serve_ckpt_phase(dev)
    gc.collect()
    torch.cuda.empty_cache()
    lap("serve-ckpt")
    examples_phase(dev)
    gc.collect()
    torch.cuda.empty_cache()
    lap("examples")
    mlm = train_mlm_phase(dev)
    mlm_launches = mlm["launches"]
    gc.collect()
    torch.cuda.empty_cache()
    lap("train-mlm")
    enc2 = dataclasses.replace(get_config("linformer-paper"),
                               num_layers=MLM_PARITY["layers"],
                               dtype="float32")
    mlm_batch = make_mlm_batch(
        SyntheticCorpus(enc2.vocab_size, seed=0), DataState(0, 0),
        batch=MLM_PARITY["batch"], seq=MLM_PARITY["seq"])
    train_parity_phase(dev, enc2, mlm_batch, "train-mlm-parity")
    gc.collect()
    torch.cuda.empty_cache()
    train_parity_bf16_phase(dev, enc2, mlm_batch, "train-mlm-parity-bf16")
    gc.collect()
    torch.cuda.empty_cache()
    lap("train-mlm-parity, train-mlm-parity-bf16")
    enc = get_config("linformer-paper")
    std = train_mlm_phase(dev, "train-mlm-standard",
                          enc.with_attention_kind("standard"),
                          keep_params=True)
    figure1_phase(dev, enc.with_attention_kind("standard"), std.pop("params"),
                  std.pop("batch"))
    gc.collect()
    torch.cuda.empty_cache()
    lap("train-mlm-standard, figure1")
    lin = enc.attention.linformer
    nonuni = train_mlm_phase(dev, "train-mlm-nonuniform", dataclasses.replace(
        enc, scan_layers=False, attention=dataclasses.replace(
            enc.attention, linformer=dataclasses.replace(lin, **NONUNIFORM))))
    log(f"[train-mlm-nonuniform] against [train-mlm] (uniform K={lin.k}, "
        f"scanned, remat {enc.remat}) and [train-mlm-standard]: step "
        f"{nonuni['step_ms']:.1f} / {mlm['step_ms']:.1f} / "
        f"{std['step_ms']:.1f} ms; forward alone {nonuni['fwd_ms']:.2f} / "
        f"{mlm['fwd_ms']:.2f} / {std['fwd_ms']:.2f} ms; peak "
        f"{nonuni['peak_gb']:.2f} / {mlm['peak_gb']:.2f} / "
        f"{std['peak_gb']:.2f} GB (the unrolled layout runs without remat, "
        "as in JAX: its peak is not comparable)")
    gc.collect()
    torch.cuda.empty_cache()
    lap("train-mlm-nonuniform")
    table3_phase(dev)
    lap("table3")
    audit_phase(dev)
    lap("audit")
    dryrun_phase(dev)
    lap("dryrun")
    mesh_launches = mesh_and_launch_phases(dev, lap)

    # launches: each kernel's count on its own main path, every path beside;
    # the prefix form's residual variant and the backward's offset form run
    # on the prefix form's VJP ([prefix-grad])
    paths = {"serve": serve_launches, "serve-chunked": chunked_launches,
             "serve-paged": paged_launches, "serve-slo": slo_launches,
             "serve-slo-parity": slo_parity_launches,
             "train": train_launches,
             "train-mlm": mlm_launches,
             "train-mlm-nonuniform": nonuni["launches"],
             "prefix-grad": prefix_launches,
             "train-leftovers": leftover_launches, "tune": tune_launches,
             "mesh": mesh_launches, **new_paths}
    main_path = {"blockwise_causal_attn": "serve",
                 "decode_attn": "serve",
                 "blockwise_causal_attn(return_residuals)": "train",
                 "blockwise_causal_attn_bwd": "train",
                 "blockwise_causal_prefix_attn(return_residuals)":
                     "prefix-grad",
                 "blockwise_causal_attn_bwd(start_blocks)": "prefix-grad",
                 "blockwise_causal_prefix_attn": "serve-chunked",
                 "blockwise_causal_prefix_attn_q": "serve-paged",
                 "decode_attn_q": "serve-paged",
                 "linformer_attn": "train-mlm",
                 "seq_projection": "train-mlm"}
    for rec in records:
        rec["launches_by_path"] = {p: n[rec["name"]] for p, n in paths.items()}
        path = main_path.get(rec["name"])
        rec["main_path"] = path
        rec["launches"] = paths[path][rec["name"]] if path else 0
    log(f"[done] {time.perf_counter() - t_start:.1f} s on {card_line()}")
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
