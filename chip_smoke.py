#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port on one NVIDIA GPU and check it.

Phases (each raises on failure; the exit code is then non-zero):

1. Device: print the card's name and power limit; build every CUDA kernel
   of the serving paths from ``src/repro_torch/kernels/csrc`` with ``nvcc``
   for ``sm_90a`` (one ``nvcc`` per source, all started together):
   ``mcd_lstm_seq``, ``mcd_gru_seq``, ``mcd_lstm_step``, ``mcd_gru_step``,
   ``masked_activation``, ``mcd_matmul``, ``decode_attn``, ``ssd_chunk``.
2. Kernels: hold each recurrent kernel against its plain PyTorch version on
   the card at the shapes the serving paths give it -- B = 64 sessions x 30
   chains = 1920 rows; the classifier's layers (I, H) = (1, 8), (8, 8) and
   the autoencoder's (1, 16), (16, 8), (8, 16), (16, 16); the sequence
   kernels at T = 140 (and the LSTM also at T = 20) -- and one wide layer (B
   = 256, T = 64, I = H = 128), with ragged lengths, non-zero h0/c0, student
   rows, p = 0.125 and p = 0: every output bit-equal to the plain version
   (on the warp path or the block path, as each case records, the step
   kernels with their ``step_plan``), and each kernel's mask bits equal to
   the plain stream's. Times the
   kernel, its plain version and, where one PyTorch call computes the same
   function (p = 0, no student rows, full lengths: cuDNN through
   ``torch.nn.LSTM`` / ``GRU`` / ``LSTMCell`` / ``GRUCell``), that call. A
   float64 witness shows why the wide layer's weights shrink with fan-in: at
   the unshrunk scale the GRU's fp32 evaluations part over T, and the kernel
   must stay as close to float64 as the plain version.
   Then, after phases 6 and 8, the wide cases (WIDE_CASES, "2 wide" in
   the phase seconds): each
   recurrent kernel on the layers the warp and block paths refuse -- the
   served wide classifier's (I, H) = (1, 2048) and (2048, 2048), (64, 1100)
   with a ragged last slice of units, (512, 8192), and the inputs (20000,
   8) and (60000, 24) -- at B = 64 and 33, T = 8 for the sequence kernels,
   fp32, bf16, int8 and int4, p = 0.125 and 0: on the sequence kernels'
   cluster path and the step kernels' split path (their warp path at H =
   8), each case's plan recorded, every output bit-equal to the plain
   version and the mask bits the plain stream's; the kernel's ms (CUDA
   events), the plain version's, the bound and, at fp32, the cuDNN call
   at p = 0.
3. Serving, the classifier (LSTM, ``cuda_seq``): ``StreamingEngine`` serves
   the ECG classifier at full width (I = 1, H = 8, NL = 3, YNY, p = 0.125,
   S = 30) for 64 sessions over whole 140-step beats in ragged chunks of up
   to 20 steps: one kernel launch per layer per tick, chunked == unchunked
   (carried state bit for bit), summaries within 1e-5 of the port's
   "reference" backend.
4. Serving, the anomaly autoencoder (I = 1, H = 16, NL = 2, YNYN,
   p = 0.125, S = 30, heteroscedastic), LSTM and then GRU, the same load:
   2 encoder + 2 decoder launches per tick, chunked == unchunked bit for bit
   on the carried encoder state and on the reconstruction (the regression
   summary of the last chunk), summaries within 1e-5 of the "reference"
   backend, and a profile of a few ticks.
5. Serving, the GRU classifier and the step backend: a few ticks of the
   GRU classifier on ``cuda_seq``, then the same streams on ``cuda_step``
   for the GRU and the LSTM classifier: bit-equal to ``cuda_seq`` (both
   run the cell body of ``mcd_cells.cuh``), and the step kernel launched
   once per layer per time step.
5b. Serving precisions: ``StreamingEngine(..., precision=p)`` for the
   classifier LSTM at int8 and at bf16 and the autoencoder GRU at int4
   (64 sessions x S = 30, every beat in 12 ragged chunks) on ``cuda_seq``
   and on ``cuda_step``: the two backends' carries (h bf16, the LSTM's c
   fp32) and summaries bit-equal, chunked == unchunked bit for bit (and
   the classifier's logits bf16), with the fp32 cell on the same plans
   beside each for the tick times.
5c. The compiled tick: on GRAPH_CELLS (the classifier LSTM and the
   autoencoder GRU on ``cuda_seq``, the classifier LSTM and GRU on
   ``cuda_step``, the classifier LSTM at int8 and the autoencoder GRU at
   int4; ``chunk_capacity`` fixed at 20 or ``"auto"`` over (8, 16, 20)),
   the engine replaying one captured CUDA graph a tick against the same
   engine served eagerly (``graphs=False``), GRAPH_RUNS runs a side in
   turns, each 64 sessions x S = 30 over whole beats in 12 ragged chunks;
   each graph run prewarmed (capacities and seconds recorded): carries and
   every tick's summaries bit-equal to eager, chunked == unchunked, no
   capture after prewarm, the launches of every tick as eager's; tick p50
   / p95, chain-steps/s, each run's first tick, the host time of each part
   of a tick and the device's idle share a side.
5d. Durable and early-exiting streams: kill -> snapshot -> restore on
   DURABLE_CELLS (the classifier LSTM at fp32 on ``cuda_seq``, the
   classifier GRU at bf16 on ``cuda_step``, the autoencoder GRU at int4 on
   ``cuda_seq``; capacity 20), each 64 sessions x S = 30 over whole beats
   in 12 ragged chunks: ticks 0-4, a wait-list (two fresh tickets, one at
   S / 2, drained by two closes; the first closed session queued back as
   a re-attach), ``snapshot``, and a fresh prewarmed engine that restores
   it and serves to the end (the re-attach goes live at tick 8).  The
   first cell restores in a child process of this script, then again into
   a ``chunk_capacity="auto"`` engine.  Every tick's summaries and the
   final carries bit-equal to the engine run uninterrupted, the same
   launches a tick, no capture after the restore; snapshot and restore ms,
   bytes and files on disk, the first tick after the restore.  Then early
   exit on the classifier LSTM (``cuda_seq``, graphs): 32 flat and 32 ECG
   sessions at EE_THRESHOLD / EE_FLOOR against the engine with it off:
   rows reclaimed, flat sessions at EE_FLOOR chains, every summary served
   at all S chains and every never-retired carry bit-equal, each S
   restored from a snapshot; tick p50 on and off.
5e. Distilled students on STUDENT_CELLS (the classifier LSTM on
   ``cuda_seq``, the autoencoder GRU on ``cuda_step``; fp32, S = 30,
   capacity 20): ``distill_classifier`` / ``distill_autoencoder`` on 64
   synthetic ECG5000 beats (the teacher one 1920-row launch a layer,
   teacher targets and features within TEACHER_TOL of the ``reference``
   backend, DISTILL_STEPS head steps, the loss falls); then 32 students
   and 32 MC sessions co-batched over whole beats in 12 ragged chunks:
   the launches of an all-MC tick, every MC summary and carry bit-equal
   to an all-MC engine on the same rows, chunked == unchunked, each
   student's carry its solo deterministic pass and its summary within
   STUDENT_TOL of the heads on it; a threshold some students cross, every
   escalated session bit-equal to an attached MC twin; kill -> snapshot
   -> restore with students live and a student ticket queued, bit-equal;
   ``distill_v1`` restored with heads serves a tick (refused without).
   Records distill seconds, tick p50 / p95 against the all-MC engine,
   ``student_rows``, escalations, ``parts_s["student"]`` and the device
   rows a tick.
5f. The multi-tenant fleet (FLEET_TENANTS): ward (the classifier LSTM,
   fp32, ``cuda_seq``, S = 30, weight 3, 32 rows), ward_lite (the same
   params object at S = 10, weight 1, 16 rows: one launch group with
   ward, ceiling 30), anom (the autoencoder GRU, int4, ``cuda_seq``,
   weight 2, 24 rows) and night (the classifier GRU, bf16, ``cuda_step``,
   weight 1, 16 rows), capacity 20; each submits 1.5x its rows in
   streams of one whole beat in 12 ragged chunks, FLEET_ADMIT = 16
   admissions a tick, every group engine prewarmed.  Three groups, each
   group tick launching what a solo tick launches; no capture after
   prewarm; every tenant's summaries and carries bit-equal to a
   prewarmed engine of its own on the same rows, ticked in turns with
   the fleet; chunked == unchunked; the first drain split by the weights;
   kill -> snapshot -> restore mid-stream (a queued fresh ticket and a
   queued re-attach) bit-equal to the uninterrupted fleet;
   ``reconfigure_tenant("ward", ServingConfig(n_samples=8))`` once the
   queue is empty: the other tenants bit-unmoved, ward's kept chains its
   first 8 rows, the first tick after the swap recorded; ``fleet_v1``
   restored and served.  Records the fleet tick p50 / p95, the group
   ticks inside it and the fleet layer's own ms, the sum of the solo
   engines' tick p50s, per-tenant p95 / queue wait / drops, snapshot and
   restore ms.
5g. The co-design loop (the classifier LSTM, fp32, ``cuda_seq``, S = 30,
   capacity "auto" over (8, 16, 20)): (a) the GPU roofline
   (``dse.gpu_model``) calibrated by ``dse.calibrate.fit_roofline`` on
   prewarmed engines at CAL_SESSIONS = 8, 16, 32 and 64 sessions, ragged
   chunks in blocks of bounds 8, 16 and 20 so every (sessions, rung) pair
   recurs: the pooled fit, the fit of each engine and without each
   engine's first tick, each shape's raw roofline beside its observed p50;
   (b) an attached ``CoDesignController`` over 64 sessions and
   CTRL_QUEUED queued tickets, its SLO CTRL_SLO x the p95 of a warm-up
   window of this process, floor CTRL_FLOOR, knobs S and fp32 / bf16:
   an applied slo-breach downshift to 8 <= S < 30, no capture after the
   swap, the queue and its order kept, no row drawn twice, every
   post-swap summary and the final carries bit-equal to a prewarmed
   engine at the winner's config fed the converted pre-swap sessions, the
   JSONL trail one line a decision; the swap's ms (build, convert,
   prewarm), the prediction against the observed p50 / p95 over the
   cooldown; (c) a ``FleetController`` over the classifier LSTM (an SLO
   from its own warm-up) and the classifier GRU at bf16 on ``cuda_step``
   (none): only the first reconfigured, its new engine prewarmed (no
   capture after the swap), the second's engine kept and bit-equal to an
   engine of its own ticked in turns; (d)
   ``core.bayesian.predict`` on 64 beats: fold (one 1920-row launch a
   layer) and scan (30 launches of 64 rows a layer) bit-equal, each
   within TOL of the ``reference`` backend, with launches and device ms.
   Every serving phase (3, 4, 5, 5b, 5c, 5d, 5e, 5f, 5g, 7, 9) serves
   through the graphs, as the engines do by default on a fixed shape; 5c's
   eager runs and the LM phases' eager turns are the comparison.
6. LM kernels: ``masked_activation``, ``mcd_matmul`` and
   ``decode_attention`` against their plain versions on the card at the
   shapes qwen3-1.7b's decode serving gives them (64 chain rows, d_model
   2048, 2 x d_ff = 12288, 16 query / 8 KV heads of 128, a 160-position
   cache; prefill 64 x 128 rows): the mask (also at mamba2-370m's
   [64, 1024] and [64 x 512, 1024], at F = 2047 and on a view 4 bytes past
   a 16-byte boundary) bit-equal to the plain version and to the plain
   stream (a row with bit 31 set included), each case with its
   ``mask_plan`` and its p = 0 copy time, ``mcd_matmul`` within MM_TOL
   (also at M = 65, K = 2050, N = 12290, off its 16-byte path; whether
   each case is bit-equal to cuBLAS, and two calls bitwise equal).  ``decode_attention``
   at ATTN_CASES (the serving shape at pos 0, 127 and 159; one prompt's 8
   rows; a 4096-position cache at pos 2047 and 4095; llama3-8b's 32 q / 8
   KV heads; olmoe-1b-7b's 16 q / 16 KV heads at pos 127 and 159): within
   ATTN_TOL, no further from a float64 evaluation than
   twice the plain version, two calls, a tensor pos against the int, and
   NaN in the cache past pos each bitwise equal, and at the serving shape
   one CUDA graph of a call with a tensor pos replayed at GRAPH_POSITIONS
   bitwise equal to eager calls; each case records ``decode_plan`` and the
   blocks an SM.  Times the kernel, its plain version and the library call
   (cuBLAS on the masked x; scaled dot-product attention over the live
   positions); a case whose caches fit in L2 is timed over copies of its
   inputs in turn, so that no timed call finds its caches in L2 (in a
   decode step each layer reads its own).  Then the three kernels at bf16
   (their own bf16 kernels) at the serving shapes: the mask at qwen3's
   and mamba2's decode and prefill shapes bitwise equal to its plain
   version, ``mcd_matmul``'s fp32 out at decode and prefill within MM_TOL
   on the tensor cores and at M = 65 and 8192, K = 2050, N = 12290 on the
   CUDA cores' narrow and wide tiles (each record's ``path``, the plan the
   wrapper launched; two calls bitwise equal), and at deepseek-v2-lite's
   products (K = 2048, N = 21888 for layer 0's dense FFN and 5632 for the
   shared experts, M = 64 and 8192) on the tensor cores,
   ``decode_attention`` at pos 0, 127 and 159
   within ATTN_TOL plus one bf16 ulp (two calls and a tensor pos bitwise
   equal); each record's ``dtype`` is "bf16", its bound at bf16 bytes (a
   product's operations at the bf16 tensor-core rate), its library call
   the bf16 one (cuBLAS ``torch.matmul``, SDPA).  Then the four kernels at
   the bf16 shapes phases 15 and 16 give them (ZOO_*, each record naming
   its ``model``): the mask at [64, 8192] and [8192, 8192];
   ``mcd_matmul`` at K = 8192, N = 49152 (jamba's ``mamba.mlp``) and K =
   4096, N = 28672 (llama3-8b) at M = 64 and 8192 on the tensor cores;
   ``decode_attention`` at 64 q heads to 8 KV heads (jamba: the kernel's
   largest group) and 32 to 8 (llama3-8b) at pos 0 and 159; the SSD scan
   at jamba's prefill (B = 64, L = 128, H = 256, P = 64, N = 128, Q =
   128) on the tensor cores.  Then the mask and ``mcd_matmul`` at bf16 at
   the rows phase 18's prefill gives them (64 x 1500 in the encoder, 64 x
   272 in the VLM; d_model 2048, gate/up N = 12288; the model's name on
   each record).
7. LM serving: ``BayesianEngine.generate`` on qwen3-1.7b at full width
   (28 layers, random fp32 weights from seed 0), 8 prompts of 128 tokens x
   8 chains (p = 0.1, placement Y), 32 new tokens: the launch counts of the
   three kernels, the same tokens again when fed its own tokens, the
   "reference" backend teacher-forced on those tokens within LOGIT_TOL /
   UNC_TOL, prefill and per-token times, profiles of the prefill and of 5
   decode steps, and the peak device memory.  Then the decode step as the
   replay of the engine's captured graph against the same engine decoding
   eagerly, LM_GRAPH_RUNS ``generate`` runs a side in turns: tokens
   equal, logits, entropy and MI bit-equal, the same launch counts; decode
   ms a token p50 / p95 a side, and a profile of 5 replayed decode steps.
8. The SSD kernel: ``ssd_chunk_scan`` against ``ssd_chunk_scan_plain`` on
   the card at mamba2-370m's serving shape (B = 64, L = 512, H = 32,
   P = 64, N = 128, Q = 256), at a length Q does not divide (L = 320: Q
   shrinks to 160) and at a small odd shape, within SSD_TOL with no NaN or
   inf, and a float64 witness: the kernel no further from a float64
   evaluation of the plain version than (twice) the fp32 plain version;
   each case records whether it is bit-equal to the plain version, the
   device times of the launch's cumsum and C . B pre-pass kernels, and the
   head kernel's resident blocks an SM.
   Times the kernel and its plain version; no PyTorch call computes the
   scan (no library time).  Then the scan at bf16 (x, B and C bf16) at
   the serving shape on both bf16 paths (SSD_BF16_CASES): the tensor-core
   kernel and, with x 8 bytes off a 16-byte boundary, the widened fp32
   launch; each holds the plan's path and the profiled kernel names, y
   within SSD_TOL plus one bf16 ulp, the state within SSD_TOL, two calls
   bitwise equal; the tensor-core case a float64 witness (y before its
   rounding and the state no farther from it than the plain fp32
   version, +25%), the bound at the storage widths and the bf16 rate, the
   design's own floor and the host ms of an eager call.
9. Mamba serving: ``BayesianEngine.generate`` on mamba2-370m at full width
   (48 ``mamba`` layers, random fp32 weights from seed 0), 8 prompts of
   512 tokens (two chunks) x 8 chains, 32 new tokens: ``ssd_chunk_scan``
   48 launches a prefill and ``masked_activation`` 48 a prefill and 48 a
   decode step, the same checks, times, profiles and graph turns as
   phase 7; the scan's path in the prefill (``last_plan``: "cuda_cores"
   at fp32, "tensor_cores" at bf16).  Each LM phase also records the five
   kernels with the most device time in its prefill (``top_kernels``).
7b, 9b. The LMs at bf16: phases 7 and 9 again with the weights drawn in
   bf16 (the dtype the reference builds its LMs in): the same launch
   counts, the kernel run repeated on its own tokens, the ``reference``
   backend teacher-forced within BF16_LOGIT_TOL / BF16_UNC_TOL, printed
   beside the reference's own distance from fp32 on the same weights
   (held in fp32), LM_GRAPH_RUNS_BF16 runs a side of graph and eager
   (bit-equal; phase 15 LM_GRAPH_RUNS_ZOO), times and profiles.
7c. qwen3-1.7b with the int8 KV cache: bf16 weights, INT8_STEPS decode
   steps from ``init_decode_state(kv_quant=True)`` on both backends side
   by side, every step within the bf16 tolerances; the cache's bytes.
   Every main-path run of phases 7–9b, 7c and 13–16 runs inside
   ``no_plain_versions()``: a plain version of an LM kernel called there
   raises.
13. The MoE family, olmoe-1b-7b at full width in fp32 (16 ``attn.moe``
   layers, d_model 2048, 16 q / 16 KV heads of 128, 64 experts top-8 of
   d_ff 1024, vocab 50304; random weights from seed 0), the load of phase
   7 (8 prompts of 128 x 8 chains, 32 new): the launch counts
   (``masked_activation`` at every attention and routed-MoE site,
   ``decode_attention`` a layer a decode step); the run repeated on its
   own tokens; the same engine decoding eagerly under a ``RouteTap`` (its
   logits bit-equal to the graph run's); the ``reference`` backend
   teacher-forced with its routes forced to the kernel run's, within
   LOGIT_TOL / UNC_TOL on every row, and every token whose own top-k set
   differs a flip whose probability gap between the k-th and (k+1)-th
   expert is at most MOE_GAP_BOUND; dropped routes a layer at the prefill
   and a decode step (equal between the backends in every call without a
   flip); graph against eager, MOE_GRAPH_RUNS runs a side in turns; times,
   profiles (top kernels of the prefill and of 5 decode steps), peak
   memory, and the decode step's byte floor beside its device ms.
14. deepseek-v2-lite-16b at full width in bf16 (layer 0 ``mla.mlp`` of
   d_ff 10944, 26 ``mla.moe`` of 64 routed experts top-6 of d_ff 1408 and
   2 shared; kv_lora 512, rope 64, nope 128, v 128; vocab 102400): the
   same, at BF16_LOGIT_TOL / BF16_UNC_TOL (no fp32 twin: 63 GB at fp32),
   ``mcd_matmul`` at layer 0 and every shared expert, the MLA cache's
   bytes beside per-head K and V.  Both phases free the model before they
   start and after.
15. llama3-8b at full width in bf16 (32 ``attn.mlp`` layers, d_model
   4096, 32 q / 8 KV heads of 128, d_ff 14336, vocab 128256; 8.03 B
   parameters, random from seed 0): phase 7b's load and checks
   (``BayesianEngine.generate``, the launch counts, the ``reference``
   backend teacher-forced within BF16_LOGIT_TOL / BF16_UNC_TOL beside its
   own distance from the fp32 weights, graph against eager), peak memory
   and the decode step's device ms against its byte floor.
16. jamba-1.5-large-398b cut to its first three layers (``attn.moe``,
   ``mamba.mlp``, ``mamba.moe``: depth 72 -> 3, printed) at full width in
   bf16 (d_model 8192, 64 q / 8 KV heads, 16 experts top-2 of d_ff 24576,
   d_ff 24576, SSD 256 heads of 64, d_state 128, chunk 256; vocab 65536):
   phase 14's load and checks (routes forced, flips under MOE_GAP_BOUND,
   dropped routes), all four LM kernels launched (the SSD scan at the
   prefill's two mamba layers, on the tensor cores), the decode state's
   (k, v) cache and two ``MambaState``s in one graph replay.
   Phases 15 and 16 run in a fresh process of this script
   (``--zoo-child``), as phases 10 and 11 run theirs: late in this one
   torch.profiler drops the first records of most profiles.
17. The LM planning stack (``launch.{analysis,specs,dryrun}``): (a) the
   dry run on the 16 x 16 production mesh over fake tensors
   (``dryrun.run_cell``: the whole step and the probes counted, the
   residency of the spec trees, the H100 model's terms) of every arch's
   decode, long and prefill cells and DRY_TRAIN's train cells (the cut:
   a train cell's count takes 70-120 s there), in DRY_WORKERS spawned
   processes at the lowest CPU priority, started beside phases 15 and
   16's child and all counted before (b) starts: each cell ``ok`` or
   ``skipped`` exactly where ``shape_applicable`` says, no error.  (b)
   Then, on the card (``dryrun.measure_probes``): MEASURED's
   probes (llama3-8b ``decode_32k`` at batch 128, mamba2-370m
   ``long_500k`` at batch 1, qwen3-1.7b ``prefill_32k`` cut to batch 1)
   built at full width, each count equal to its fake-tensor count
   exactly, each timed (CUDA events, PROBE_ITERS calls) beside its bound
   at the H100 peaks (the counted flops, the bytes of its inputs and
   outputs) and the roofline of its counted, unfused work; and llama3's
   decode probe on the ``cuda`` backend, its cache of 32768 positions at
   random with DOMINANT keys a row scaled by DOMINANT_SCALE, so that a
   few positions spread over the cache carry the softmax, pos 32767: one
   launch each of ``masked_activation``, ``mcd_matmul`` and
   ``decode_attention``; the block output, and the attention sublayer's
   own output (the kernel's and wo's part of the block), each within
   PLAN_ATT_ULPS bf16 ulps of its largest value from the ``reference``
   backend, the sublayer's a tolerance that a kernel returning zeros or
   losing the dominant keys of the cache's second half breaks many times
   over;
   both backends timed.  (c) The counted composition against
   ``gpu_model.step_model`` at data = model = 1: flop and byte ratios,
   printed only.

10. Serving precisions, the kernels (last, in a fresh process of this
   script: its profiles hold thousands of records, torch.profiler has
   lost records in every later profile of a process after such a one, and
   it loses most profiles' first records late in a process that has
   profiled graph replays): each recurrent kernel at bf16, int8
   and int4 (the sequence kernels on int8 codes / packed int4 codes and
   their scales, dequantized at kernel entry; the step kernels on the
   dequantized bf16 weights, as the reference hands them) on the ECG
   layers at B = 1920 (T = 140), a block-path layer with an odd H (16, 9)
   for the int4 pad and (128, 128) at B = 256, p = 0.125 and 0, every
   16th row a student row: every output bit-equal to the plain version at
   its precision (bf16 ys / h, fp32 c) and the mask bits at the bf16
   scale equal to the plain stream's.  Times each case beside the same
   case at fp32 (call ms by CUDA events, device ms from one profile a
   kernel, split by marker kernels), the plain version, the bound at the
   storage widths and the bf16 cuDNN call (none at int8 / int4).

11. Training on the card (after 7c, before 10; each part in a fresh
   process of this script, as phase 10 and for its reason): (a) the ECG
   classifier at the paper's §V settings through ``launch.train``'s own
   ``setup`` (its ``make_ecg_loss`` and ``ecg_batches``: batch 64, whole
   140-step beats, H 8, NL 3, YNY, p 0.125, lr 1e-3), TRAIN_STEPS
   ``Trainer`` steps on the card: synced step seconds (p50 / p95 of the
   unprofiled ones), the loss a step, peak memory, the aten ops of a
   step (forward and backward apart, under a counting
   ``TorchDispatchMode``, on the CPU), device busy ms and idle share from one
   profile of the last TRAIN_PROFILE_STEPS steps (marker launches split
   it by step; the steps' records must agree); the first
   TRAIN_GATE_STEPS steps run again on the CPU from the same params
   within TRAIN_LOSS_TOL / TRAIN_PARAM_TOL.  (b) The autoencoder
   (``ecg-ae``: H 16, NL 2, YNYN, normal beats), the same records and
   gate.  (c) Kill -> resume: a child process runs ``launch.train.main``
   for the classifier with ``--ckpt-dir`` and a checkpoint every 2 steps,
   is killed (SIGKILL) once its step-4 checkpoint is on disk, and the
   same command relaunched finishes 8 steps: its params bit-equal to
   (a)'s after 8 steps.  (d) qwen3-1.7b and mamba2-370m at full width
   through ``launch.train.main --task lm --no-reduced`` at its defaults
   (batch 64, seq 64, fp32, remat), 3 steps each: step seconds, tokens/s,
   peak GB, the loss a step (finite).  (e)
   ``repro_torch.examples.quickstart`` and ``ecg_monitoring --smoke``,
   each a child process that must exit 0; their kernel launches join the
   serving phases' (training reaches no kernel: no kernel has a
   backward).

18. The encoder–decoder and VLM paths (in phases 15 and 16's child,
   after them) at qwen3-1.7b's published widths (d_model 2048, 16 q / 8
   KV heads of 128, qk_norm, d_ff 6144, vocab 151936) in bf16, seeded
   random weights, the audio / vlm fields set here (neither package's
   registry has such a config): (a) ENCDEC_LAYERS ``enc_attn.mlp``
   encoder layers over ENCODER_SEQ = 1500 seeded frames (Whisper's
   encoder output for 30 s of audio) and ENCDEC_LAYERS
   ``dec_attn.cross.mlp`` decoder layers (depth 28 -> 2 + 2, printed);
   (b) ENCDEC_LAYERS ``attn.mlp`` layers behind VLM_PATCHES = 256
   seeded patch embeddings (PaliGemma's image tokens at 224 px; depth 28
   -> 2).  Each: 8 prompts of 16 tokens x 8 chains, 8 new tokens through
   ``BayesianEngine.generate``; ``masked_activation`` (every site mask,
   the encoder's and the cross site's among them), ``mcd_matmul``
   (every MLP's gate/up, at prefill 96000 rows for the encoder) and
   ``decode_attention`` launched as ``_encdec_want`` counts; the run
   repeated on its own tokens; the ``reference`` backend teacher-forced
   within BF16_LOGIT_TOL / BF16_UNC_TOL; the decode graph against eager
   bit for bit, and again for a second request with other frames
   (patches), whose prefill must refill the graph's static cross K/V;
   greedy tokens, prefill ms, decode ms a token p50 / p95, the graph
   step's device ms (CUDA events over back-to-back replays) and peak
   memory beside the card line; for (a) also a decoder cross block's
   plain blockwise pass at decode against ``decode_attention`` at pos
   1499 on the same K/V (times and distance: ROADMAP B2).  Then, outside
   the launch counts: the prefill's state (the cross K/V, every cache) on
   the ``cuda`` backend against ``reference``, each tensor within
   ENCDEC_STATE_ULPS bf16 ulps of its largest value, and again with each
   kernel's wrapper returning zeros at the rows the path newly gives it
   (64 x 1500 in the encoder, 64 x 272 in the VLM prefill), which must
   fall outside it (both distances and the prefill logits' printed).
   Phase 6 holds the mask and ``mcd_matmul`` at those rows
   (``encdec_kernel_cases``; in the ``kernels`` line's ``encdec``).

12. Sharding (after 5g; ~9 s): the ECG engine on a data mesh that lists
   the card SHARDS = 4 times (the card is one device: the mesh proves the
   partition, its launches and what a shard adds to a tick, not
   placement across cards), 64 sessions x S = 30 over whole beats in 12
   ragged chunks, graphs on, prewarmed: (a) ``make_data_mesh(1)`` against
   no mesh (the classifier LSTM, ``cuda_seq``); (b) SHARD_CELLS (the
   classifier LSTM and the autoencoder GRU on ``cuda_seq``, the
   classifier GRU on ``cuda_step``) on the 4-entry mesh against the
   unsharded engine: summaries and carries bit-equal, ``TickMetrics.
   shards`` 4, 1920 rows, layers x 4 launches a tick (x T on
   ``cuda_step``), no capture after prewarm; (c) a snapshot of the
   4-shard engine after 5 ticks restored on an unsharded engine, and the
   other way round, each bit-equal to the uninterrupted run; (d) the
   gspmd strategy on a (2 data x 2 model) mesh of the card at the
   classifier's widths (B 64, T 20), both cells, bit-equal to the
   unsharded ``reference`` backend; (e) tick p50 / p95 and the host
   parts of (b)'s classifier cell against the unsharded engine, 2 runs a
   side in turns.  Prints ``torch.cuda.device_count()``; with two cards
   or more, (b)'s first cell also runs over real cards, eagerly.
19. Wide recurrent layers (after 17, in a fresh process of this script
   whose launch counts are the main path's): the classifier as
   ``launch/stream.py --hidden 2048 --layers 2 --placement YN`` builds it
   (I = 1, p = 0.125), 8 sessions x S = 8 (64 rows), every stream 40
   steps in ragged chunks of
   1 to 10, LSTM and GRU at fp32 and bf16 on ``cuda_seq`` (the sequence
   kernels' cluster path: one launch a layer a tick) and ``cuda_step``
   (the split path: the tick's T a layer), graph and eager: graph ==
   eager with no capture after prewarm, ``cuda_step`` == ``cuda_seq`` and
   chunked == one unchunked pass, bit for bit; at fp32 the summaries
   within SUMMARY_TOL of the ``reference`` backend.  Records each run's
   tick p50 and a tick's device busy ms.

Every count of kernel launches is set to 0 just before a serving phase and
read just after it; each kernel's ``launches`` is the sum over the serving
phases that run it.  Prints the ``kernels`` JSON line (one entry a kernel;
``mcd_lstm_seq`` has two, the classifier pass and the autoencoder pass;
each recurrent entry with its ``precisions``: the same pass at fp32, bf16,
int8 and int4 from phase 10; each LM entry with ``precisions.fp32`` and
``.bf16``, its case at bf16 from phases 6 and 8 with the launches of
phases 7b, 9b, 7c, 14-18; ``zoo``: its phase 6 cases at the shapes
of phases 15 and 16 with those phases' launches; and ``encdec``: phase
18's launches of ``masked_activation``, ``mcd_matmul`` and
``decode_attention`` and its cases at the prefill rows; ``wide`` on the
first entry of each recurrent kernel: its phase 2 wide cases), the
card's name and power limit, and as the last line ``{"ok": true, "device":
{...}}``.

Usage:  python3 chip_smoke.py [--out results.json]
        python3 chip_smoke.py --moe-only   # the build, phases 6, 13, 14
        python3 chip_smoke.py --zoo-only   # the build, phases 6, 15, 16
        python3 chip_smoke.py --plan-only  # the build, phase 17
        python3 chip_smoke.py --encdec-only  # the build, phases 6, 18
        python3 chip_smoke.py --wide-only  # the build, 2's wide cases, 19
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W): the
# kernels compute in fp32 on the CUDA cores; a bf16 product's bound is
# taken at the bf16 tensor-core rate.
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12   # tensor cores, dense: the bound of a bf16 product
PEAK_HBM_BYTES = 3.35e12
L2_BYTES = 50 * 2 ** 20   # its L2 cache (data sheet: 50 MB)
TOL = 1e-5          # fp32 gate of every recurrent case.  The cell rounds
                    # every product and sum alone, in the plain versions'
                    # order (csrc/mcd_cells.cuh), so the recurrent kernels
                    # are bit-equal to them; phase 2 requires it of all
                    # four
SUMMARY_TOL = 1e-5  # engine (kernel) vs the reference backend (cuBLAS)

S, SESSIONS, T_BEAT, CHUNK = 30, 64, 140, 20
AE_TICKS = 12       # autoencoder load: every beat in 12 ragged chunks
STEP_TICKS = 5      # step-backend phase: a few ticks

KERNELS = {
    # name: (gates, sequence kernel?, csrc file, TPU kernel it replaces)
    "mcd_lstm_seq": (4, True, "mcd_lstm_seq.cu",
                     "src/repro/kernels/mcd_lstm_seq.py:133"),
    "mcd_gru_seq": (3, True, "mcd_gru_seq.cu",
                    "src/repro/kernels/mcd_gru_seq.py:92"),
    "mcd_lstm_step": (4, False, "mcd_lstm_step.cu",
                      "src/repro/kernels/mcd_lstm.py:82"),
    "mcd_gru_step": (3, False, "mcd_gru_step.cu",
                     "src/repro/kernels/mcd_gru.py:96"),
}

# The LM decode path's kernels: name -> (module, csrc file, TPU kernel).
LM_KERNELS = {
    "masked_activation": ("bernoulli_mask", "masked_activation.cu",
                          "src/repro/kernels/bernoulli_mask.py:41"),
    "mcd_matmul": ("mcd_matmul", "mcd_matmul.cu",
                   "src/repro/kernels/mcd_matmul.py:52"),
    "decode_attention": ("decode_attn", "decode_attn.cu",
                         "src/repro/kernels/decode_attn.py:63"),
    "ssd_chunk_scan": ("ssd_chunk", "ssd_chunk.cu",
                       "src/repro/kernels/ssd_chunk.py:73"),
}
ALL_KERNELS = list(KERNELS) + list(LM_KERNELS)
# qwen3-1.7b decode serving: 8 prompts x 8 chains, 128-token prompts, 32
# new tokens (the configuration's own S = 8, p = 0.1, placement Y).
LM_B, LM_S, LM_PROMPT, LM_NEW = 8, 8, 128, 32
MM_TOL = 1e-4       # mcd_matmul vs cuBLAS: K = 2048 fp32 products summed
                    # in another order; on unit-scale outputs the spread is
                    # ~3e-6 and its max over 1e8 outputs ~2e-5
ATTN_TOL = 1e-5     # decode_attention: 128-long dot products and a
                    # softmax over <= 4096 positions in another order;
                    # outputs are weighted means of unit-scale V
# decode_attention cases of phase 6: (B, H, KV, hd, S, positions).
ATTN_SERVING = (LM_B * LM_S, 16, LM_PROMPT + LM_NEW)     # (B, H, S)
ATTN_CASES = [
    (LM_B * LM_S, 16, 8, 128, LM_PROMPT + LM_NEW, (0, 127, 159)),  # qwen3
    (LM_S, 16, 8, 128, LM_PROMPT + LM_NEW, (159,)),   # one prompt's chains
    (LM_S, 16, 8, 128, 4096, (2047, 4095)),           # a long cache
    (LM_B * LM_S, 32, 8, 128, LM_PROMPT + LM_NEW, (159,)),  # llama3-8b heads
    (LM_B * LM_S, 16, 16, 128, LM_PROMPT + LM_NEW, (127, 159)),  # olmoe
]
GRAPH_POSITIONS = (0, 63, 127, 159)   # replays of one captured call
LOGIT_TOL = 1e-3    # the engine on the kernels vs on the reference backend
UNC_TOL = 1e-4      # (cuBLAS), 28 (48) layers deep: per-step logits and
                    # the entropy / mutual information (nats)
# The LMs at bf16 (the dtype the reference builds them in), phases 7b and
# 9b: the engine on the kernels against its reference backend,
# teacher-forced.  bf16 rounds every activation to 8 bits of mantissa
# (2^-9 relative), the two backends round the decode softmax weights
# differently (fp32 in the TPU kernel, bf16 in the reference) and sum in
# other orders, 28 (48) layers deep on logits of ~4: a quarter of a logit,
# and 0.05 nats of entropy or MI.  Each run prints beside them how far the
# reference itself moves from fp32 on the same weights.
BF16_LOGIT_TOL = 0.25
BF16_UNC_TOL = 0.05
LM_GRAPH_RUNS_BF16 = 1   # generate runs a side, graph and eager, at bf16
                         # in 7b and 9b (one since phase 17: its time came
                         # from here)
LM_GRAPH_RUNS_ZOO = 2    # the same in phase 15 (llama3-8b)
INT8_STEPS = 48          # phase 7c: decode steps from an int8 zero state
# mamba2-370m serving: 8 prompts x 8 chains, 512-token prompts (two chunks
# of 256), 32 new tokens.
MB_PROMPT = 512
SSD_CASES = [       # (B, L, H, P, N, q_chunk)
    (LM_B * LM_S, MB_PROMPT, 32, 64, 128, 256),   # serving: 2 chunks
    (8, 320, 32, 64, 128, 256),                   # Q shrinks to 160
    (3, 40, 2, 8, 16, 16),                        # small, odd: Q = 10
]
SSD_TOL = 1e-4      # ssd_chunk_scan vs its plain version, fp32: outputs
                    # of a few units, log-decays of ~10^2 (both sum them in
                    # order: torch.cumsum along the chunk axis runs each
                    # column in order on the card), 128- and 256-long sums
                    # in another order

# Layer shapes (I, H, p) of one pass of each model; YNY / YNYN placement.
CLF_LAYERS = [(1, 8, 0.125), (8, 8, 0.0), (8, 8, 0.125)]
AE_LAYERS = [(1, 16, 0.125), (16, 8, 0.0), (8, 16, 0.125), (16, 16, 0.0)]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int, warmup: int = 1) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def _kernel_table(prof) -> dict:
    """Device time (us) and number of records of each kernel in a profile,
    by name.  CPU ops are skipped: they would count their kernels twice."""
    table = {}
    for ev in prof.key_averages():
        if "CUDA" not in str(ev.device_type):
            continue
        us, n = table.get(ev.key, (0.0, 0))
        table[ev.key] = (us + getattr(ev, "self_device_time_total",
                                      getattr(ev, "self_cuda_time_total",
                                              0.0)), n + ev.count)
    return table


def _device_events(table, match=None) -> tuple[float, int]:
    """Device-kernel time (us) and number of kernel records in a profile's
    ``_kernel_table``; only kernels whose name holds ``match`` when
    given."""
    got = [v for k, v in table.items() if match is None or match in k]
    return sum(us for us, _ in got), sum(n for _, n in got)


PROFILE_ATTEMPTS = 12  # the profiler drops some or all records of a
                       # profile now and then, at times several in a row


LOOSE_RECORDS = 0.002   # share of records a "loose" match may lose


def counts_agree(counts, seen, loose=()) -> bool:
    """Whether a whole profile's kernel record ``counts`` count, against
    the counts of the earlier whole profiles ``seen`` (oldest first): an
    earlier one had the same counts, entry for entry, and none taken
    since had more.  A record lost in one profile of an alternating pair
    never counts (53, 52, 53 counts the second 53; 52, 53, 52 not the
    second 52), and a first profile holding one-off launches more (the
    qwen3 prefill's 3433 records, 3422 in every later profile) does not
    stop the steady ones from counting.  The entries whose indices are
    in ``loose`` agree within LOOSE_RECORDS of the earlier count, and
    exceed it beyond that share."""
    def same(i, n, m):
        return abs(n - m) <= LOOSE_RECORDS * m if i in loose else n == m

    def at_most(i, n, m):
        return m <= n + (LOOSE_RECORDS * n if i in loose else 0)

    return any(
        all(same(i, n, m) for i, (n, m) in enumerate(zip(counts, earlier)))
        and all(at_most(i, n, m) for later in seen[k + 1:]
                for i, (n, m) in enumerate(zip(counts, later)))
        for k, earlier in enumerate(seen))


def profiled_us(prepare, matches, calls=None, loose=(), table=False):
    """Profile one call under torch.profiler (CUDA activity): ``prepare()``
    runs outside the profile and returns the call, which makes ``calls``
    repeats of one function when given.  Returns the device time (us) of
    the kernels matching each entry of ``matches`` (None: every kernel) and
    the call's return value; with ``table``, also the accepted profile's
    ``_kernel_table``.

    The profiler now and then loses kernel records -- a whole profile's, or
    some of them -- and a lost record reads as time that did not pass.  So
    a profile counts only when every entry of ``matches`` has records, a
    number of them divisible by ``calls``, and its counts agree with an
    earlier whole profile's, none taken since having more
    (:func:`counts_agree`; each profile with a fresh profiler).  The
    profile is taken again until one counts, and after
    ``PROFILE_ATTEMPTS`` profiles this raises.

    The entries whose indices are in ``loose`` (every kernel of an LM
    decode step: ~2,200 records a step, of which the profiler drops a few
    in most profiles) need only records, and a count within LOOSE_RECORDS
    of the earlier profile's: their time may lack that share of records.
    """
    import torch
    from torch.profiler import ProfilerActivity, profile
    seen = []               # the counts of each whole profile so far
    for attempt in range(PROFILE_ATTEMPTS):
        call = prepare()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = call()
            torch.cuda.synchronize()
        kernels = _kernel_table(prof)
        got = [_device_events(kernels, m) for m in matches]
        counts = [n for _, n in got]
        whole = all(n > 0 and (calls is None or i in loose
                               or n % calls == 0)
                    for i, n in enumerate(counts))
        if whole and counts_agree(counts, seen, loose):
            return ([us for us, _ in got], out) + ((kernels,) if table
                                                   else ())
        if seen or not whole:
            print(f"profile {attempt + 1} of {PROFILE_ATTEMPTS} for "
                  f"{matches}: kernel records {counts} (earlier whole "
                  f"{seen}); taking it again", flush=True)
        if whole:
            seen.append(counts)
    raise RuntimeError(f"torch.profiler gave no whole profile of the "
                       f"kernels matching {matches} agreeing with an "
                       f"earlier one in {PROFILE_ATTEMPTS} attempts")


def device_ms(fn, iters: int, match=None) -> float:
    """Device time per call (torch.profiler, CUDA activity)."""

    def prepare():
        fn()

        def run():
            for _ in range(iters):
                fn()
        return run

    (us,), _ = profiled_us(prepare, [match], calls=iters)
    return us / iters / 1e3


def host_ms(fn, calls: int = 100) -> float:
    """Host time a call of ``fn``: ``calls`` calls enqueued back to back,
    unsynchronised, after one warm-up call (a few launches a call: the
    launch queue does not fill)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e3


def max_abs_diff(a, b, what: str) -> float:
    """max |a - b|, raising if either side holds a non-finite value (a NaN
    would otherwise slip through every ``max`` and tolerance check)."""
    import torch
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
        raise RuntimeError(f"non-finite values in {what}")
    return (a - b).abs().max().item()


def layer_inputs(B, T, I, H, *, seed, gates=4, students=True, ragged=True,
                 weight_scale=None):
    import torch
    from repro_torch.core import mcd
    g = torch.Generator().manual_seed(seed)

    def r(*shape, k=1.0):
        return (torch.randn(shape, generator=g) * k).cuda()

    rows = torch.arange(B, dtype=torch.int64) + 1000
    if students:
        rows[::16] |= mcd.STUDENT_ROW_FLAG
    lens = (torch.randint(1, T + 1, (B,), generator=g) if ragged
            else torch.full((B,), T)).to(torch.int32)
    # Weight scale 0.4 up to the models' widest fan-in (I + H = 32), then
    # shrinking with 1/sqrt(fan-in) as the models' own init does.  At 0.4
    # with a fan-in of 256 the GRU recurrence amplifies fp32 rounding
    # step over step: the kernel and the plain version then drift apart by
    # more than TOL, each as far from a float64 evaluation as from the
    # other, which measures the inputs and not the kernel
    # (gru_f64_witness shows it on every run).
    kw = (0.4 * min(1.0, (32 / (I + H)) ** 0.5) if weight_scale is None
          else weight_scale)
    return dict(x=r(B, T, I), wx=r(I, gates, H, k=kw),
                wh=r(H, gates, H, k=kw), b=r(gates, H, k=0.1),
                rows=rows.cuda(), h0=r(B, H, k=0.5), c0=r(B, H, k=0.5),
                lengths=lens.cuda())


def _module(name):
    import importlib
    from repro_torch.kernels import mcd_gru, mcd_gru_seq, mcd_lstm, \
        mcd_lstm_seq
    if name in LM_KERNELS:
        return importlib.import_module(
            f"repro_torch.kernels.{LM_KERNELS[name][0]}")
    return {"mcd_lstm_seq": mcd_lstm_seq, "mcd_gru_seq": mcd_gru_seq,
            "mcd_lstm_step": mcd_lstm, "mcd_gru_step": mcd_gru}[name]


def _keys(name, n):
    from repro_torch.kernels import mcd_gru, mcd_lstm
    return (mcd_lstm if KERNELS[name][0] == 4 else mcd_gru).gate_keys(7, n)


def kernel_calls(name, d, keys, p):
    """(kernel call, plain call) on the inputs ``d`` (with the quantized
    weights' keywords ``d["qkw"]`` of ``precision_operands``, if any);
    outputs as tuples."""
    mod = _module(name)
    gates, seq, _, _ = KERNELS[name]
    lstm = gates == 4
    fn, plain = getattr(mod, name), getattr(mod, name + "_plain")
    if seq:
        args = (d["x"], d["wx"], d["wh"], d["b"], d["rows"], keys, p)
        kw = dict(h0=d["h0"], lengths=d["lengths"], **d.get("qkw", {}))
        if lstm:
            kw["c0"] = d["c0"]
        return (lambda: fn(*args, **kw)), (lambda: plain(*args, **kw))
    carry = (d["h0"], d["c0"]) if lstm else (d["h0"],)
    args = (d["x"][:, 0].contiguous(), *carry, d["wx"], d["wh"], d["b"],
            d["rows"], keys, p)
    if lstm:
        return (lambda: fn(*args)), (lambda: plain(*args))
    return (lambda: (fn(*args),)), (lambda: (plain(*args),))


def library_call(name, d, dtype=None):
    """One cuDNN call (torch.nn.LSTM / GRU / LSTMCell / GRUCell) on the
    inputs ``d`` (p = 0, full lengths, no student rows), its weights and
    inputs in ``dtype`` (default fp32).  PyTorch's GRU adds b_hn inside
    the reset product, so b_hn = 0 and b_in = b[2] give the reference's
    bias placement; the gate orders (i, f, g, o) and (r, z, n) match."""
    import torch
    gates, seq, _, _ = KERNELS[name]
    B, T, I = d["x"].shape
    H = d["wh"].shape[0]
    lstm = gates == 4
    cls = ({True: torch.nn.LSTM, False: torch.nn.GRU} if seq else
           {True: torch.nn.LSTMCell, False: torch.nn.GRUCell})[lstm]
    kw = dict(batch_first=True) if seq else {}
    mod = cls(I, H, **kw).cuda()
    with torch.no_grad():
        sfx = "_l0" if seq else ""
        getattr(mod, "weight_ih" + sfx).copy_(
            d["wx"].permute(1, 2, 0).reshape(gates * H, I))
        getattr(mod, "weight_hh" + sfx).copy_(
            d["wh"].permute(1, 2, 0).reshape(gates * H, H))
        getattr(mod, "bias_ih" + sfx).copy_(d["b"].reshape(-1))
        getattr(mod, "bias_hh" + sfx).zero_()
    dtype = dtype or torch.float32
    mod = mod.to(dtype)
    h0, c0 = d["h0"].to(dtype), d["c0"].to(dtype)
    if seq:
        state = ((h0[None].contiguous(), c0[None].contiguous()) if lstm
                 else h0[None].contiguous())
        x = d["x"].to(dtype)
    else:
        state = (h0, c0) if lstm else h0
        x = d["x"][:, 0].to(dtype).contiguous()

    def call():
        with torch.no_grad():
            return mod(x, state)
    return call


def library_ms(name, d, device=True) -> tuple[float, float, float]:
    """``library_call`` in fp32: (call ms, device ms -- None without
    ``device`` --, max abs diff to the kernel)."""
    gates, seq, _, _ = KERNELS[name]
    call = library_call(name, d)
    out = call()
    lib_out = out if not seq and gates == 3 else out[0]
    keys = _keys(name, 0)
    ours = kernel_calls(name, d, keys, 0.0)[0]()[0]
    diff = max_abs_diff(lib_out, ours, f"{name} vs its library call")
    return (cuda_time_ms(call, iters=20),
            device_ms(call, 10) if device else None, diff)


def kernel_cases():
    """(kernel, B, T, I, H, p) of the kernel phase."""
    cases = [("mcd_lstm_seq", 1920, T_BEAT, I, H, p) for I, H, p in
             CLF_LAYERS + [(1, 8, 0.0)]]
    cases += [("mcd_lstm_seq", 1920, CHUNK, I, H, p) for I, H, p in
              [(1, 8, 0.125), (8, 8, 0.0), (8, 8, 0.125)]]
    cases += [("mcd_lstm_seq", 256, 64, 128, 128, p) for p in (0.125, 0.0)]
    cases += [("mcd_lstm_seq", 1920, T_BEAT, I, H, p)
              for I, H, p in AE_LAYERS]
    shapes = [(I, H) for I, H, _ in AE_LAYERS] + [(1, 8), (8, 8)]
    for name in ("mcd_gru_seq", "mcd_lstm_step", "mcd_gru_step"):
        T = T_BEAT if KERNELS[name][1] else 1
        cases += [(name, 1920, T, I, H, p) for I, H in shapes
                  for p in (0.125, 0.0)]
        cases += [(name, 256, 64 if T > 1 else 1, 128, 128, p)
                  for p in (0.125, 0.0)]
    return cases


def kernel_phase(report):
    import torch
    from repro_torch.kernels import common
    records, library = [], {}
    for n, (name, B, T, I, H, p) in enumerate(kernel_cases()):
        gates, seq, _, _ = KERNELS[name]
        d = layer_inputs(B, T, I, H, seed=n, gates=gates, ragged=seq)
        keys = _keys(name, n)
        launch, plain = kernel_calls(name, d, keys, p)
        got = launch()
        torch.cuda.synchronize()
        ref = plain()
        errs = [max_abs_diff(g, r, f"{name} at {B, T, I, H, p}")
                for g, r in zip(got, ref)]
        err = max(errs)
        if err > TOL:
            raise RuntimeError(f"{name} disagrees with its plain version at "
                               f"B={B} T={T} I={I} H={H} p={p}: max abs "
                               f"err {errs} > {TOL}")
        kx, kh = common.kernel_mask_factors(keys, d["rows"], I, H, p)
        px, ph = common.gate_mask_factors(keys, d["rows"], I, H, p)
        if not (torch.equal(kx, px) and torch.equal(kh, ph)):
            raise RuntimeError(f"{name} mask bits differ from the plain "
                               f"stream at B={B} I={I} H={H} p={p}")
        bit_equal = all(torch.equal(g, r) for g, r in zip(got, ref))
        if not bit_equal:
            raise RuntimeError(f"{name} is not bit-equal to its plain "
                               f"version at B={B} T={T} I={I} H={H} p={p}: "
                               f"max abs err {errs}")
        rec = dict(kernel=name, B=B, T=T, I=I, H=H, p=p, max_abs_err=err,
                   bit_equal=bit_equal, mask_bits_equal=True)
        if seq:
            rec["path"] = common.seq_plan(gates, B, I, H)["path"]
        else:
            rec["plan"] = common.step_plan(gates, B, I, H)
            rec["path"] = rec["plan"]["path"]
        # Timed as the stack calls it: int32 rows and lengths converted
        # once per stack, the keys as host ints.
        d32 = dict(d, rows=common.rows_to_int32(d["rows"]))
        timed, _ = kernel_calls(name, d32,
                                tuple(keys.reshape(-1).tolist()), p)
        rec["kernel_ms"] = cuda_time_ms(timed, iters=20, warmup=2)
        rec["kernel_device_ms"] = device_ms(timed, 10, name + "_kernel")
        rec["plain_ms"] = cuda_time_ms(plain, iters=2, warmup=0)
        rec["bound_ms"], rec["bound_by"] = bound(name, d, p)
        shape = (name, B, T, I, H)
        if shape not in library:
            dl = layer_inputs(B, T, I, H, seed=n, gates=gates,
                              students=False, ragged=False)
            library[shape] = library_ms(name, dl)
        (rec["library_ms"], rec["library_device_ms"],
         rec["library_max_abs_diff"]) = library[shape]
        records.append(rec)
        print("kernel case " + json.dumps(rec), flush=True)
    report["kernel_cases"] = records
    report["gru_f64_witness"] = gru_f64_witness()
    return records


WITNESS_T = (0, 1, 2, 4, 8, 16, 32, 63)


def gru_f64_witness() -> list[dict]:
    """Why the wide layer's weights shrink with fan-in: ``mcd_gru_seq`` at
    B = 256, T = 64, I = H = 128 with the unshrunk weight scale 0.4, held
    against the plain version and against a float64 evaluation of the same
    function (the plain GRU body on float64 operands, the same fp32 mask
    factors).  Per step t: max |kernel - plain|, |kernel - f64| and
    |plain - f64| over the outputs ys[:, t].  Raises if the kernel is
    further from float64 than twice the plain version (plus TOL) at any
    step: where the two fp32 evaluations part, the kernel must not be the
    one that drifts."""
    import torch
    from repro_torch.kernels import common, mcd_gru
    B, T, I, H = 256, 64, 128, 128
    out = []
    for p in (0.125, 0.0):
        d = layer_inputs(B, T, I, H, seed=101, gates=3, weight_scale=0.4)
        keys = _keys("mcd_gru_seq", 5)
        launch, plain = kernel_calls("mcd_gru_seq", d, keys, p)
        ys_k = launch()[0]
        torch.cuda.synchronize()
        ys_p = plain()[0]
        fx, fh = (f.double() for f in
                  common.gate_mask_factors(keys, d["rows"], I, H, p))
        x, wx, wh, b = (d[k].double() for k in ("x", "wx", "wh", "b"))
        h = d["h0"].double()
        ys_f = []
        for t in range(T):
            h_new = mcd_gru.gru_update_plain(x[:, t], h, h, fx, fh, wx, wh, b)
            h = torch.where((t < d["lengths"])[:, None], h_new, h)
            ys_f.append(h)
        ys_f = torch.stack(ys_f, dim=1)

        def per_t(a, b):
            return [max_abs_diff(a[:, t].double(), b[:, t].double(),
                                 "the float64 witness") for t in WITNESS_T]

        rec = {"B": B, "T": T, "I": I, "H": H, "p": p, "weight_scale": 0.4,
               "t": list(WITNESS_T), "kernel_vs_plain": per_t(ys_k, ys_p),
               "kernel_vs_f64": per_t(ys_k, ys_f),
               "plain_vs_f64": per_t(ys_p, ys_f)}
        print("gru f64 witness " + json.dumps(rec), flush=True)
        if any(k > 2 * q + TOL for k, q in zip(rec["kernel_vs_f64"],
                                               rec["plain_vs_f64"])):
            raise RuntimeError(f"mcd_gru_seq is further from float64 than "
                               f"its plain version: {rec}")
        out.append(rec)
    return out


def _pass(records, name, T, layers, B=1920):
    """The records of one model pass: one launch per layer (I, H, p)."""
    out = []
    for I, H, p in layers:
        out += [r for r in records if r["kernel"] == name and r["B"] == B
                and r["T"] == T and (r["I"], r["H"], r["p"]) == (I, H, p)]
    if len(out) != len(layers):
        raise RuntimeError(f"missing kernel cases for a {name} pass")
    return out


def kernel_entry(name, recs, shape_note, library=None):
    """The ``kernels`` JSON entry of one kernel: the sums over one pass."""
    _, _, src, replaces = KERNELS[name]
    lib = library or (sum(r["library_ms"] for r in recs),
                      sum(r["library_device_ms"] for r in recs))
    return {
        "name": name, "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{src}",
        "replaces": replaces, "shape": shape_note,
        "launches": None,
        "max_abs_err": None,
        "ms": sum(r["kernel_ms"] for r in recs),
        "device_ms": sum(r["kernel_device_ms"] for r in recs),
        "plain_ms": sum(r["plain_ms"] for r in recs),
        "bound_ms": sum(r["bound_ms"] for r in recs),
        "bound_by": recs[0]["bound_by"],
        "library_ms": lib[0],
        "library_device_ms": lib[1],
    }


def classifier_library_ms() -> tuple[float, float]:
    """One 3-layer cuDNN torch.nn.LSTM call at the classifier's shapes
    (p = 0, full lengths), the yardstick for one full-beat pass: (call ms,
    device ms)."""
    import torch
    lstm = torch.nn.LSTM(1, 8, num_layers=3, batch_first=True).cuda()
    x = torch.randn(1920, T_BEAT, 1, device="cuda")

    def call():
        with torch.no_grad():
            return lstm(x)
    return cuda_time_ms(call, iters=20, warmup=2), device_ms(call, 10)


def kernel_entries(records):
    entries = [
        kernel_entry("mcd_lstm_seq", _pass(records, "mcd_lstm_seq", T_BEAT,
                                           CLF_LAYERS),
                     "classifier pass: 3 layers, B=1920 (64 sessions x "
                     "S=30), T=140, I=1/8/8, H=8, p=0.125/0/0.125, ragged "
                     "lengths", library=classifier_library_ms()),
        kernel_entry("mcd_lstm_seq", _pass(records, "mcd_lstm_seq", T_BEAT,
                                           AE_LAYERS),
                     "autoencoder pass: 4 layers, B=1920, T=140, "
                     "(I,H)=(1,16)/(16,8)/(8,16)/(16,16), p=0.125/0/0.125/0, "
                     "ragged lengths; library: 4 nn.LSTM calls"),
        kernel_entry("mcd_gru_seq", _pass(records, "mcd_gru_seq", T_BEAT,
                                          AE_LAYERS),
                     "autoencoder pass: 4 layers, B=1920, T=140, "
                     "(I,H)=(1,16)/(16,8)/(8,16)/(16,16), p=0.125/0/0.125/0, "
                     "ragged lengths"),
    ]
    for name in ("mcd_lstm_step", "mcd_gru_step"):
        entries.append(kernel_entry(
            name, _pass(records, name, 1, CLF_LAYERS),
            "one classifier time step: 3 launches, B=1920, I=1/8/8, H=8, "
            "p=0.125/0/0.125"))
    for e in entries:
        e["max_abs_err"] = max(r["max_abs_err"] for r in records
                               if r["kernel"] == e["name"])
        e["kernel_ms"] = e["ms"]
    return entries


# -- serving precisions: the recurrent kernels at bf16, int8 and int4 -------

PRECISIONS = ("bf16", "int8", "int4")
# (I, H) of phase 10: the ECG layers at B = 1920 (T = 140 for the sequence
# kernels), one block-path layer with an odd H (the int4 pad column) and
# the wide layer at B = 256 (T = 64).
PREC_SHAPES = ([(1920, I, H) for I, H in
                [(1, 8), (8, 8), (1, 16), (16, 16), (16, 8), (8, 16)]]
               + [(1920, 16, 9), (256, 128, 128)])


def precision_operands(name, d, precision):
    """A case's fp32 inputs ``d`` (``layer_inputs``) as the stack hands
    them to the kernel at ``precision`` (``ops._precision_weights`` from
    the fp32 master weights): x and h0 in the activation dtype, c0 fp32;
    the sequence kernels take int8 / int4 codes and their scales, the step
    kernels the dequantized bf16 weights.  fp32 returns ``d`` as it is."""
    from repro_torch.kernels import ops
    if precision == "fp32":
        return dict(d, qkw={})
    seq = KERNELS[name][1]
    wx, wh, x, qkw = ops._precision_weights(d["wx"], d["wh"], d["x"],
                                            precision, seq=seq)
    return dict(d, x=x, wx=wx, wh=wh, h0=d["h0"].to(x.dtype), qkw=qkw)


def bound(name, d, p, precision="fp32") -> tuple[float, str]:
    """Least time (ms) for one launch on these inputs: bytes each input read
    once and each output written once, over HBM, at the precision's storage
    widths (x, h0, ys and h_T in the activation dtype; the weights at their
    bits with the quantized precisions' fp32 scales; c and the bias fp32;
    rows and lengths int32); operations over the fp32 peak (the kernels
    compute in fp32 on the CUDA cores: a bf16 operand is widened, a code
    dequantized once).  A sequence kernel needs x and compute only for the
    live steps (t < length)."""
    from repro_torch.kernels import quantize
    gates, seq, _, _ = KERNELS[name]
    B, T, I = d["x"].shape
    H = d["wh"].shape[0]
    lstm = gates == 4
    a = 4 if precision == "fp32" else 2
    if seq:
        live = int(d["lengths"].clamp(max=T).sum())
        nbytes = (a * live * I + quantize.weight_bytes(I, H, gates, precision)
                  + 4 * 2 * B + a * B * H * (2 + T)
                  + (8 * B * H if lstm else 0))
    else:
        # the step kernels take dequantized weights in the activation dtype
        live = B
        nbytes = (a * B * I + quantize.weight_bytes(
            I, H, gates, "fp32" if a == 4 else "bf16") + 4 * B
            + a * 2 * B * H + (8 * B * H if lstm else 0))
    tail = 15 if lstm else 12                  # activations and update
    per_step = H * (2 * gates * (I + H) + gates + tail)
    if p > 0:
        per_step += gates * (I + H)            # the masked views
    t_bytes = nbytes / PEAK_HBM_BYTES
    t_ops = live * per_step / PEAK_FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


MARKER = "masked_activation_kernel"   # the kernel that splits a profile
LEAD_MARKERS = 8   # marker launches ahead of the first segment, behind a
LEAD_SLEEP = 2_000_000   # ~1 ms spin: late in a process torch.profiler
                         # loses a profile's first records


def segmented_device_us(calls, iters: int, per_call=None):
    """Device time a call (us) and kernel records a call of each of
    ``calls``, from one torch.profiler profile: each call runs ``iters``
    times after a marker launch (``masked_activation`` on one row of four
    with int32 row ids: one kernel of known name that none of the calls
    launches), and the device records between two markers are its.  The
    profile opens with a spin kernel and LEAD_MARKERS more markers, whose
    records may be lost; the last ``len(calls)`` segments are the calls'.  A profile counts when
    every segment holds ``per_call`` records a call (when given) or
    records in a multiple of ``iters``, and counts that agree with an
    earlier whole profile's, none taken since having more
    (:func:`counts_agree`, ``profiled_us``'s rule against lost records:
    late in a process every other profile may lose its first records);
    else it is taken again, and after PROFILE_ATTEMPTS this raises.  The marker
    launches are not counted in ``masked_activation.launches``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import bernoulli_mask
    wrapper = bernoulli_mask.masked_activation
    xm = torch.zeros((1, 4), device="cuda")
    rm = torch.zeros((1,), dtype=torch.int32, device="cuda")
    launches = wrapper.launches

    def marker():
        wrapper(xm, rm, 1, 0.5)

    marker()
    for call in calls:                       # warm: allocator, cuDNN plans
        call()
    seen = []
    for attempt in range(PROFILE_ATTEMPTS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(LEAD_SLEEP)
            for _ in range(LEAD_MARKERS):
                marker()
            for call in calls:
                marker()
                for _ in range(iters):
                    call()
            marker()
            torch.cuda.synchronize()
        evs = sorted((e for e in prof.events()
                      if "CUDA" in str(e.device_type)),
                     key=lambda e: e.time_range.start)
        segs, cur = [], None
        for e in evs:
            if MARKER in e.name:
                if cur is not None:
                    segs.append(cur)
                cur = [0.0, 0]
            elif cur is not None:
                cur[0] += e.time_range.elapsed_us()
                cur[1] += 1
        segs = segs[-len(calls):]
        counts = [n for _, n in segs]
        whole = (len(segs) == len(calls)
                 and all(n > 0 and (n == per_call * iters if per_call
                                    else n % iters == 0) for n in counts))
        if whole and counts_agree(counts, seen):
            wrapper.launches = launches
            return [(us / iters, n // iters) for us, n in segs]
        if seen or not whole:
            print(f"segmented profile {attempt + 1} of {PROFILE_ATTEMPTS}: "
                  f"{len(segs)} segments of {len(calls)}, records {counts} "
                  f"(earlier whole {seen}); taking it again", flush=True)
        if whole:
            seen.append(counts)
    raise RuntimeError("torch.profiler gave no whole segmented profile "
                       "agreeing with an earlier one")


def precision_check(name, d, keys, p, where) -> dict:
    """One launch of ``name`` on the precision operands ``d`` against its
    plain version: every output of the same dtype and bit-equal, finite,
    and the kernel's mask factors (the scale rounded to the activation
    dtype) equal to the plain stream's; raises otherwise.  Returns the
    plain version's time (one call, ms) and the flags."""
    import torch
    from repro_torch.kernels import common
    launch, plain = kernel_calls(name, d, keys, p)
    got = launch()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = plain()
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    for g, r in zip(got, ref, strict=True):
        err = max_abs_diff(g.float(), r.float(), where)
        if g.dtype != r.dtype or not torch.equal(g, r):
            raise RuntimeError(f"{where}: not bit-equal to its plain version "
                               f"({g.dtype} vs {r.dtype}, max abs err {err})")
    act = got[0].dtype
    I, H = d["x"].shape[-1], d["wh"].shape[0]
    kx, kh = common.kernel_mask_factors(keys, d["rows"], I, H, p, act)
    px, ph = common.gate_mask_factors(keys, d["rows"], I, H, p, act)
    if not (torch.equal(kx, px.float()) and torch.equal(kh, ph.float())):
        raise RuntimeError(f"{where}: mask bits differ from the plain "
                           "stream")
    return dict(bit_equal=True, mask_bits_equal=True, plain_ms=plain_ms,
                dtype=str(act).removeprefix("torch."))


def precision_kernel_phase(report, t_beat=T_BEAT):
    """Phase 10: each recurrent kernel at bf16, int8 and int4 (and fp32,
    for its times beside them) on PREC_SHAPES at p = 0.125 and 0, every
    16th row a student row, ragged lengths: every output bit-equal to the
    plain version at its precision and the mask bits at the bf16 scale
    equal to the plain stream's, or this raises.  Times each case (call ms
    by CUDA events; device ms from one segmented profile a kernel), its
    plain version, its bound at the precision and the bf16 cuDNN call."""
    import torch
    from repro_torch.kernels import common
    records = []
    for name, (gates, seq, _, _) in KERNELS.items():
        cases, timed, lib_calls = [], [], {}
        for n, (B, I, H) in enumerate(PREC_SHAPES):
            T = (t_beat if B == 1920 else 64) if seq else 1
            base = layer_inputs(B, T, I, H, seed=500 + n, gates=gates,
                                ragged=seq)
            keys = _keys(name, n)
            for p in (0.125, 0.0):
                for prec in ("fp32",) + PRECISIONS:
                    d = precision_operands(name, base, prec)
                    where = f"{name} {prec} at B={B} T={T} I={I} H={H} p={p}"
                    rec = dict(kernel=name, precision=prec, B=B, T=T, I=I,
                               H=H, p=p)
                    if prec != "fp32":   # fp32: checked in phase 2
                        rec.update(precision_check(name, d, keys, p, where))
                    d32 = dict(d, rows=common.rows_to_int32(d["rows"]))
                    call, _ = kernel_calls(
                        name, d32, tuple(keys.reshape(-1).tolist()), p)
                    act_bytes = 4 if prec == "fp32" else 2
                    rec["path"] = (common.seq_plan(gates, B, I, H, act_bytes)
                                   if seq else common.step_plan(
                                       gates, B, I, H))["path"]
                    rec["kernel_ms"] = cuda_time_ms(call, iters=20, warmup=2)
                    rec["bound_ms"], rec["bound_by"] = bound(name, d, p,
                                                             prec)
                    cases.append(rec)
                    timed.append(call)
            if (B, I, H) not in lib_calls:
                dl = layer_inputs(B, T, I, H, seed=500 + n, gates=gates,
                                  students=False, ragged=False)
                lib_calls[(B, I, H)] = library_call(name, dl,
                                                    torch.bfloat16)
        dev_us = segmented_device_us(timed, iters=5, per_call=1)
        for rec, (us, _) in zip(cases, dev_us, strict=True):
            rec["kernel_device_ms"] = us / 1e3
        shapes = list(lib_calls)
        lib_us = segmented_device_us([lib_calls[k] for k in shapes],
                                     iters=5)
        lib = {k: (cuda_time_ms(lib_calls[k], iters=10, warmup=1), us / 1e3)
               for k, (us, _) in zip(shapes, lib_us, strict=True)}
        for rec in cases:
            if rec["precision"] == "bf16":
                (rec["library_ms"],
                 rec["library_device_ms"]) = lib[(rec["B"], rec["I"],
                                                   rec["H"])]
            else:
                rec["library_ms"] = rec["library_device_ms"] = None
            print("precision case " + json.dumps(rec), flush=True)
        records += cases
    report["precision_kernel_cases"] = records
    return records


PHASE10_TIMEOUT = 600   # seconds; phase 10 takes ~45 on the card


def phase10_child(report):
    """Phase 10 in a fresh process of this script, which writes its records
    as JSON under ``build/`` (ignored by git) and exits; waited for here.
    Its profiles hold thousands of records, and torch.profiler has lost
    records in every later profile of a process after one of them; and
    late in a process that has profiled CUDA graph replays (phases 5c, 7,
    9) it loses a profile's first records in most profiles.  A fresh
    process profiles as the first phases of this one do.  The child's
    kernel launches are no serving path's and are not counted here."""
    path = os.path.join(ROOT, "build", "phase10.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if os.path.exists(path):
        os.remove(path)
    subprocess.run([sys.executable, os.path.abspath(__file__),
                    "--phase10-out", path], check=True,
                   timeout=PHASE10_TIMEOUT)
    with open(path) as fh:
        records = json.load(fh)
    os.remove(path)
    report["precision_kernel_cases"] = records
    return records


def precision_entries(entries, records):
    """Each recurrent ``kernels`` entry gains ``precisions``: per
    precision, the sums over the entry's pass of the call ms, device ms,
    bound and plain ms, beside the same cases at fp32 from phase 10; the
    library (bf16 cuDNN) at bf16, "none" at int8 / int4 (no PyTorch call
    computes on quantized weights)."""
    passes = {"classifier": CLF_LAYERS, "autoencoder": AE_LAYERS}
    for e in entries:
        if e["name"] not in KERNELS:
            continue
        layers = passes["autoencoder" if "autoencoder" in e["shape"]
                        else "classifier"]
        out = {}
        for prec in ("fp32",) + PRECISIONS:
            recs = []
            for I, H, p in layers:
                recs += [r for r in records if r["kernel"] == e["name"]
                         and r["precision"] == prec and r["B"] == 1920
                         and (r["I"], r["H"], r["p"]) == (I, H, p)]
            if len(recs) != len(layers):
                raise RuntimeError(f"missing {prec} cases of {e['name']}")
            lib = [r["library_device_ms"] for r in recs]
            out[prec] = {
                "ms": sum(r["kernel_ms"] for r in recs),
                "device_ms": sum(r["kernel_device_ms"] for r in recs),
                "bound_ms": sum(r["bound_ms"] for r in recs),
                "bound_by": recs[0]["bound_by"],
                "plain_ms": (sum(r["plain_ms"] for r in recs)
                             if prec != "fp32" else "phase 2"),
                "library_ms": (sum(r["library_ms"] for r in recs)
                               if prec == "bf16" else "none"),
                "library_device_ms": (sum(lib) if prec == "bf16"
                                      else "none")}
        e["precisions"] = out
    return entries


def _prec_serve(params, cfg, backend, precision, dev, plans, sids,
                streams):
    """One engine at ``precision`` over the chunk ``plans`` [sessions,
    ticks]; returns (engine, last results, launch counts)."""
    from repro_torch.serve import StreamingEngine
    eng = StreamingEngine(params, cfg, backend=backend,
                          max_sessions=SESSIONS, chunk_capacity=CHUNK,
                          device=dev, precision=precision)
    for sid in sids:
        eng.open_session(sid)
    reset_launches()                          # count the main path only
    res = None
    for t in range(plans.shape[1]):
        res = eng.step({sid: streams[k][eng.store.get(sid).steps:][
            :plans[k, t]] for k, sid in enumerate(sids)})
    return eng, res, read_launches()


PREC_CELLS = (("classifier", "lstm", "int8"), ("classifier", "lstm", "bf16"),
              ("autoencoder", "gru", "int4"))
PREC_TICKS = 12     # every beat in 12 ragged chunks, as the AE cells


def precision_serving_phase(report, dev):
    """Phase 5b: StreamingEngine at a serving precision -- the classifier
    LSTM at int8 and at bf16, the autoencoder GRU at int4 -- 64 sessions x
    S = 30 chains over whole beats in PREC_TICKS ragged chunks, on
    ``cuda_seq`` and on ``cuda_step``: the two backends' stored carries and
    summaries bit-equal, chunked == unchunked bit for bit (the carries; for
    the autoencoder the last chunk's reconstruction too), finite summaries
    of the expected shapes; and the fp32 cell of the same model and plans
    beside each, for the times."""
    import numpy as np
    import torch
    from repro_torch.core import autoencoder as ae, classifier as clf, mcd
    from repro_torch.core.uncertainty import (classification_summary,
                                              regression_summary)

    streams = _beats()
    plans = chunk_plans(np.random.default_rng(5), SESSIONS, PREC_TICKS)
    sids = [f"pr-{k}" for k in range(SESSIONS)]
    out, total = {}, {name: 0 for name in ALL_KERNELS}
    for model, cell, prec in PREC_CELLS:
        if model == "classifier":
            cfg = clf.ClassifierConfig(
                input_dim=1, hidden=8, num_layers=3, num_classes=4,
                cell=cell, mcd=mcd.MCDConfig(p=0.125, placement="YNY",
                                             n_samples=S, seed=0))
            params = clf.init(torch.Generator().manual_seed(0), cfg,
                              device=dev)
            per_tick = cfg.num_layers
        else:
            cfg = ae.AutoencoderConfig(
                input_dim=1, hidden=16, num_layers=2, cell=cell,
                heteroscedastic=True,
                mcd=mcd.MCDConfig(p=0.125, placement="YNYN", n_samples=S,
                                  seed=0))
            params = ae.init(torch.Generator().manual_seed(0), cfg,
                             device=dev)
            per_tick = 2 * cfg.num_layers
        key = f"{model}_{cell}_{prec}"
        runs = {}
        for backend, precision in (("cuda_seq", None), ("cuda_seq", prec),
                                   ("cuda_step", prec)):
            eng, res, counts = _prec_serve(params, cfg, backend, precision,
                                           dev, plans, sids, streams)
            kernel = f"mcd_{cell}_{'seq' if backend == 'cuda_seq' else 'step'}"
            _check_launches(f"{key} {backend}", counts, eng.metrics, kernel,
                            (lambda m: per_tick) if backend == "cuda_seq"
                            else (lambda m: per_tick * m.capacity))
            for name, v in counts.items():
                total[name] += v
            runs[(backend, precision)] = (eng, res, counts)
        (seq_eng, seq_res, _), (st_eng, st_res, _) = \
            runs[("cuda_seq", prec)], runs[("cuda_step", prec)]
        act = torch.bfloat16
        for sid in sids:
            for la, lb in zip(st_eng.store.get(sid).state,
                              seq_eng.store.get(sid).state):
                if la[0].dtype != act or (cell == "lstm"
                                          and la[1].dtype != torch.float32):
                    raise RuntimeError(f"{key}: carry dtypes "
                                       f"{[t.dtype for t in la]}")
                for a, b in zip(la, lb):
                    if not torch.equal(a, b):
                        raise RuntimeError(f"{key}: cuda_step != cuda_seq "
                                           f"carry for {sid}")
            for a, b in zip(st_res[sid].summary, seq_res[sid].summary):
                max_abs_diff(a, b, f"{key} summary of {sid}")
                if not torch.equal(a, b):
                    raise RuntimeError(f"{key}: cuda_step != cuda_seq "
                                       f"summary for {sid}")
        # chunked == unchunked, on the sequence kernel at the precision
        x, rows, full = _unchunked(streams, sids, seq_eng, dev)
        if model == "classifier":
            logits, states = clf.apply(params, x, rows, cfg,
                                       backend="cuda_seq", lengths=full,
                                       return_state=True, precision=prec,
                                       device=dev)
            if logits.dtype != act:
                raise RuntimeError(f"{key}: logits are {logits.dtype}")
            whole = classification_summary(
                logits.reshape(SESSIONS, S, -1).transpose(0, 1).float())
            probs = torch.stack([seq_res[s].summary.probs for s in sids])
            if probs.shape != (SESSIONS, 4) or \
                    (probs.sum(-1) - 1).abs().max().item() > 1e-5:
                raise RuntimeError(f"{key}: bad class probabilities")
            for k, sid in enumerate(sids):
                for v, u in zip(seq_res[sid].summary, whole):
                    if not torch.equal(v, u[k]):
                        raise RuntimeError(f"{key}: chunked != unchunked "
                                           f"summary for {sid}")
        else:
            ref_cfg = dataclasses.replace(cfg, decode_window=CHUNK)
            mean, log_var, states = ae.apply(
                params, x, rows, ref_cfg, backend="cuda_seq", lengths=full,
                return_state=True, precision=prec, device=dev)
            whole = regression_summary(_per_session(mean),
                                       _per_session(log_var))
            for k, sid in enumerate(sids):
                L = int(plans[k, -1])
                summ = seq_res[sid].summary
                if summ.mean.shape != (L, 1):
                    raise RuntimeError(f"{key}: summary shape "
                                       f"{summ.mean.shape}")
                for v, u in zip(summ, whole):
                    max_abs_diff(v, u[k][:L], f"{key} summary of {sid}")
                    if not torch.equal(v, u[k][:L]):
                        raise RuntimeError(f"{key}: chunked != unchunked "
                                           f"reconstruction for {sid}")
        _check_states(seq_eng, sids, states, key)
        out[key] = {
            backend + ("" if precision else " fp32"): dict(
                _serve_stats(eng.metrics, report["card"]),
                launches_by_kernel=counts)
            for (backend, precision), (eng, _, counts) in runs.items()}
        out[key].update(bit_equal_step_vs_seq=True,
                        chunked_equals_unchunked=True)
        print(f"serving {key} " + json.dumps(
            {k: ({kk: vv for kk, vv in v.items() if kk != "tick_ms"}
                 if isinstance(v, dict) else v) for k, v in
             out[key].items()}), flush=True)
    report["serving_precisions"] = out
    return total


# -- wide recurrent layers: the cluster and split paths (phases 2, 19) -------

# Phase 2's wide cases, for each recurrent kernel: (I, H, B, precision, p).
# The served wide classifier's layers (1, 2048) and (2048, 2048); H = 1100,
# not a multiple of 32 or of the units a block, so the last slice is
# ragged; the top of the range, (512, 8192); and the two inputs the block
# path refuses, (20000, 8) and (60000, 24).  B = 64, and 33 (a tile not
# filled); every shape at both dropout rates across its cases, and every
# precision at each served layer and at H = 1100.  The sequence kernels run
# WIDE_T steps with ragged lengths, non-zero h0 / c0 and student rows.  The
# plain versions cost 2I launches a layer and 2H a step on the card.
WIDE_T = 8
WIDE_CASES = [
    (1, 2048, 64, "fp32", 0.125), (1, 2048, 33, "bf16", 0.0),
    (1, 2048, 64, "int8", 0.125), (1, 2048, 33, "int4", 0.125),
    (2048, 2048, 64, "fp32", 0.0), (2048, 2048, 33, "bf16", 0.125),
    (2048, 2048, 33, "int8", 0.0), (2048, 2048, 64, "int4", 0.125),
    (64, 1100, 33, "fp32", 0.125), (64, 1100, 64, "bf16", 0.125),
    (64, 1100, 64, "int8", 0.0), (64, 1100, 33, "int4", 0.0),
    (512, 8192, 64, "fp32", 0.125), (512, 8192, 33, "int4", 0.0),
    (20000, 8, 64, "fp32", 0.0), (20000, 8, 33, "int8", 0.125),
    (60000, 24, 64, "fp32", 0.125),
]
WIDE_PATHS = {True: ("cluster",), False: ("split", "warp")}   # seq, step


def wide_inputs(B, T, I, H, gates, seed, ragged=True):
    """``layer_inputs``' operands made on the card (a (512, 8192) layer's
    weights are 1.1 GB), the weights at 1/sqrt(fan-in), as the models' own
    init scales them, so a gate sum stays O(1) at any width."""
    import torch
    from repro_torch.core import mcd
    g = torch.Generator(device="cuda").manual_seed(seed)

    def r(*shape, k=1.0):
        return torch.randn(shape, generator=g, device="cuda") * k

    rows = torch.arange(B, dtype=torch.int64, device="cuda") + 1000
    rows[::16] |= mcd.STUDENT_ROW_FLAG
    lens = (torch.randint(1, T + 1, (B,), generator=g, device="cuda")
            if ragged else torch.full((B,), T, device="cuda"))
    kw = (I + H) ** -0.5
    return dict(x=r(B, T, I), wx=r(I, gates, H, k=kw),
                wh=r(H, gates, H, k=kw), b=r(gates, H, k=0.1), rows=rows,
                h0=r(B, H, k=0.5), c0=r(B, H, k=0.5),
                lengths=lens.to(torch.int32))


def wide_kernel_cases(report) -> list[dict]:
    """Phase 2's wide cases: each recurrent kernel on WIDE_CASES, on the
    wide path (the sequence kernels' cluster path; the step kernels' split
    path, or their warp path where H divides 32), every output bit-equal to
    its plain version at its precision and the mask bits the plain
    stream's, or this raises.  Records each case's path and plan, the
    kernel's ms (CUDA events over back-to-back launches, no profiler: its
    profiles lose records on this card's host, phase 10's note), its
    plain version's ms, its bound, and at fp32 the PyTorch
    call (cuDNN ``torch.nn.LSTM`` / ``GRU`` / ``LSTMCell`` / ``GRUCell``,
    TF32 off) on the same shape at p = 0, full lengths and no students,
    with its distance to the kernel there."""
    import torch
    from repro_torch.kernels import common
    records = []
    for name, (gates, seq, _, _) in KERNELS.items():
        for n, (I, H, B, prec, p) in enumerate(WIDE_CASES):
            T = WIDE_T if seq else 1
            base = wide_inputs(B, T, I, H, gates, seed=900 + n, ragged=seq)
            keys = _keys(name, 40 + n)
            d = precision_operands(name, base, prec)
            where = f"{name} {prec} at B={B} T={T} I={I} H={H} p={p}"
            act_bytes = 4 if prec == "fp32" else 2
            plan = (common.seq_plan(gates, B, I, H, act_bytes) if seq
                    else common.step_plan(gates, B, I, H))
            if plan["path"] not in WIDE_PATHS[seq]:
                raise RuntimeError(f"{where}: on the {plan['path']} path")
            rec = dict(kernel=name, precision=prec, B=B, T=T, I=I, H=H, p=p,
                       path=plan["path"], plan=plan)
            rec.update(precision_check(name, d, keys, p, where))
            d32 = dict(d, rows=common.rows_to_int32(d["rows"]))
            call, _ = kernel_calls(name, d32,
                                   tuple(keys.reshape(-1).tolist()), p)
            # CUDA events over back-to-back launches: a launch takes 0.15
            # to 200 ms here, so the host's part hides behind the card's
            rec["kernel_ms"] = cuda_time_ms(call, iters=3, warmup=0)
            rec["bound_ms"], rec["bound_by"] = bound(name, d, p, prec)
            rec["library_ms"] = rec["library_max_abs_diff"] = None
            if prec == "fp32":           # no students, full lengths
                dl = dict(base, rows=base["rows"] % 2 ** 31,
                          lengths=torch.full_like(base["lengths"], T))
                rec["library_ms"], _, rec["library_max_abs_diff"] = (
                    library_ms(name, dl, device=False))
            records.append(rec)
            print("wide kernel case " + json.dumps(rec), flush=True)
    report["wide_kernel_cases"] = records
    return records


def wide_entries(entries, records) -> None:
    """Each recurrent ``kernels`` entry (the first of its name) gains
    ``wide``: its phase 2 wide cases, one row a case."""
    seen = set()
    for e in entries:
        if e["name"] not in KERNELS or e["name"] in seen:
            continue
        seen.add(e["name"])
        e["wide"] = [
            {k: r[k] for k in ("I", "H", "B", "T", "precision", "p", "path",
                               "kernel_ms", "plain_ms", "bound_ms",
                               "bound_by", "library_ms")}
            for r in records if r["kernel"] == e["name"]]


# Phase 19: the wide classifier as ``launch/stream.py --hidden 2048
# --layers 2 --placement YN`` builds it (I = 1, p = 0.125), 8 sessions x
# S = 8 chains (64 rows), every stream WIDE_STEPS steps in ragged chunks of
# 1 to WIDE_CHUNK, on both kernel backends, at fp32 and bf16, graph and
# eager.
WIDE_HIDDEN, WIDE_LAYERS, WIDE_SESSIONS, WIDE_S = 2048, 2, 8, 8
WIDE_STEPS, WIDE_CHUNK = 40, 10


def _wide_plans(rng) -> list[list[int]]:
    """Per session, chunk lengths in [1, WIDE_CHUNK] summing to
    WIDE_STEPS."""
    plans = []
    for _ in range(WIDE_SESSIONS):
        left, out = WIDE_STEPS, []
        while left:
            out.append(min(left, int(rng.integers(1, WIDE_CHUNK + 1))))
            left -= out[-1]
        plans.append(out)
    return plans


def _wide_run(params, cfg, dev, backend, precision, graphs, streams, plans,
              sids):
    """One engine over ``plans``: (engine, every tick's results, launches,
    prewarm capacities)."""
    import torch
    from repro_torch.serve import StreamingEngine, prewarm
    eng = StreamingEngine(params, cfg, backend=backend, precision=precision,
                          max_sessions=WIDE_SESSIONS,
                          chunk_capacity=WIDE_CHUNK, graphs=graphs,
                          device=dev)
    caps = prewarm(eng) if graphs else None
    for sid in sids:
        eng.open_session(sid)
    reset_launches()                          # count the main path only
    ticks = []
    for t in range(max(len(p) for p in plans)):
        chunks = {}
        for k, sid in enumerate(sids):
            if t < len(plans[k]):
                pos = eng.store.get(sid).steps
                chunks[sid] = streams[k][pos:pos + plans[k][t]]
        ticks.append(eng.step(chunks))
    torch.cuda.synchronize()
    return eng, ticks, read_launches(), caps


def _wide_last(ticks, sids) -> dict:
    """Each session's summary from the last tick that served it."""
    out = {}
    for res in ticks:
        for sid in sids:
            if sid in res:
                out[sid] = res[sid].summary
    return out


def wide_serving_phase(report, dev):
    """Phase 19: the wide classifier (H = 2048, two layers) served on
    ``cuda_seq`` (the sequence kernels' cluster path) and ``cuda_step``
    (the step kernels' split path), fp32 and bf16, graph and eager, LSTM
    and GRU.  Checks one launch a layer a tick on ``cuda_seq`` and the
    tick's T a layer on ``cuda_step``; graph == eager (carries and every
    tick's summaries) with no capture after prewarm; ``cuda_step`` ==
    ``cuda_seq``; chunked == one unchunked pass (the carries); and at fp32
    the summaries within SUMMARY_TOL of the port's ``reference`` backend.
    Records tick p50 of each run and, on the fp32 ``cuda_seq`` graph
    engine, the device busy ms of a tick."""
    import numpy as np
    import torch
    from repro_torch.core import classifier as clf, mcd
    from repro_torch.core.uncertainty import classification_summary
    from repro_torch.serve import StreamingEngine, prewarm

    rng = np.random.default_rng(19)
    streams = [rng.standard_normal((WIDE_STEPS, 1)).astype(np.float32)
               for _ in range(WIDE_SESSIONS)]
    plans = _wide_plans(rng)
    sids = [f"w{k}" for k in range(WIDE_SESSIONS)]
    out, total = {"plans": plans}, {name: 0 for name in ALL_KERNELS}
    x = torch.from_numpy(np.concatenate(
        [np.repeat(s[None], WIDE_S, 0) for s in streams])).to(dev)
    full = torch.full((len(x),), WIDE_STEPS, device=dev)
    for cell in ("lstm", "gru"):
        cfg = clf.ClassifierConfig(
            input_dim=1, hidden=WIDE_HIDDEN, num_layers=WIDE_LAYERS,
            cell=cell, mcd=mcd.MCDConfig(p=0.125, placement="YN",
                                         n_samples=WIDE_S, seed=0))
        params = clf.init(torch.Generator().manual_seed(0), cfg, device=dev)
        for precision in (None, "bf16"):
            prec = precision or "fp32"
            t_group = time.perf_counter()
            runs = {}
            for backend in ("cuda_seq", "cuda_step"):
                seq = backend == "cuda_seq"
                kernel = f"mcd_{cell}_{'seq' if seq else 'step'}"
                for graphs in (True, False):
                    what = (f"wide {cell} {prec} {backend} "
                            f"{'graph' if graphs else 'eager'}")
                    run = _wide_run(params, cfg, dev, backend, precision,
                                    graphs, streams, plans, sids)
                    eng, _, counts, _ = run
                    _check_launches(
                        what, counts, eng.metrics, kernel,
                        (lambda m: cfg.num_layers) if seq else
                        (lambda m: cfg.num_layers * m.capacity))
                    for k, v in counts.items():
                        total[k] += v
                    if graphs and sum(m.compiles for m in eng.metrics):
                        raise RuntimeError(f"{what}: captured after "
                                           "prewarm")
                    runs[(backend, graphs)] = run
            base = runs[("cuda_seq", True)]
            for key, run in runs.items():
                if key != ("cuda_seq", True):
                    _same_serving(base, run, sids,
                                  f"wide {cell} {prec} {key} vs cuda_seq "
                                  "graph")
            eng = base[0]
            rows = torch.from_numpy(np.concatenate(
                [eng.store.get(sid).rows for sid in sids]).astype(
                    np.int64)).to(dev)
            logits, states = clf.apply(params, x, rows, cfg,
                                       backend="cuda_seq", lengths=full,
                                       return_state=True, device=dev,
                                       precision=precision)
            for li, layer in enumerate(states):
                for k, sid in enumerate(sids):
                    for part, whole in zip(eng.store.get(sid).state[li],
                                           layer, strict=True):
                        if not torch.equal(
                                part, whole[k * WIDE_S:(k + 1) * WIDE_S]):
                            raise RuntimeError(
                                f"wide {cell} {prec}: chunked != unchunked "
                                f"for {sid} at layer {li}")
            rec = {"cell": cell, "precision": prec,
                   "tick_ms_p50": {f"{b} {'graph' if g else 'eager'}":
                                   _serve_stats(r[0].metrics,
                                                report["card"])[
                                       "tick_ms_p50"]
                                   for (b, g), r in runs.items()},
                   "ticks": len(base[1]),
                   "launches": {f"{b} {'graph' if g else 'eager'}":
                                sum(m.launches for m in r[0].metrics)
                                for (b, g), r in runs.items()},
                   "bit_equal": True, "chunked_equals_unchunked": True}
            if precision is None:
                ref = clf.apply(params, x, rows, cfg, backend="reference",
                                lengths=full, device=dev)
                ref_sum = classification_summary(
                    ref.reshape(WIDE_SESSIONS, WIDE_S, -1).transpose(0, 1))
                got = _wide_last(base[1], sids)
                d_ref = 0.0
                for k, sid in enumerate(sids):
                    for v, r in zip(got[sid], ref_sum, strict=True):
                        d_ref = max(d_ref, max_abs_diff(
                            v, r[k], f"wide {cell} summary of {sid}"))
                if d_ref > SUMMARY_TOL:
                    raise RuntimeError(f"wide {cell}: summaries {d_ref} from "
                                       f"the reference backend (tol "
                                       f"{SUMMARY_TOL})")
                rec["summary_diff_vs_reference"] = d_ref
                rec.update(_wide_busy(params, cfg, dev, streams, sids))
            rec["seconds"] = time.perf_counter() - t_group
            out[f"{cell} {prec}"] = rec
            print("wide serving " + json.dumps(rec), flush=True)
    out["card"] = report["card"]
    report["wide_serving"] = out
    return total


PHASE19_TIMEOUT = 600   # seconds; phase 19 takes ~30 on the card


def wide_serving_child(report, dev) -> dict:
    """Phase 19 in a fresh process of this script (its tick profile comes
    after phase 17, where a late profile of this process loses records,
    as phases 15, 16 and 10 run in children for), which writes its report
    and its launch counts as JSON under ``build/`` (ignored by git) and
    exits; waited for here.  Returns the counts: phase 19 serves, so its
    launches are the main path's."""
    path = os.path.join(ROOT, "build", "phase19.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if os.path.exists(path):
        os.remove(path)
    subprocess.run([sys.executable, os.path.abspath(__file__),
                    "--phase19-out", path], check=True,
                   timeout=PHASE19_TIMEOUT)
    with open(path) as fh:
        out = json.load(fh)
    os.remove(path)
    report["wide_serving"] = out["wide_serving"]
    return out["launches"]


def _wide_busy(params, cfg, dev, streams, sids, n_ticks=4) -> dict:
    """Device busy ms of a tick of the fp32 ``cuda_seq`` graph engine
    (torch.profiler, every kernel of the tick), over ``n_ticks`` ticks of
    WIDE_CHUNK / 2 steps a session; not part of the launch count."""
    import torch
    from repro_torch.serve import StreamingEngine, prewarm
    n = WIDE_CHUNK // 2                  # steps a session a tick

    def prepare():
        eng = StreamingEngine(params, cfg, backend="cuda_seq",
                              max_sessions=WIDE_SESSIONS,
                              chunk_capacity=WIDE_CHUNK, device=dev)
        prewarm(eng)
        for sid in sids:
            eng.open_session(sid)

        def tick(t):
            eng.step({sid: streams[k][t * n:(t + 1) * n]
                      for k, sid in enumerate(sids)})

        tick(0)

        def run():
            t0 = time.perf_counter()
            for t in range(1, n_ticks + 1):
                tick(t)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e6
        return run

    (dev_us, kern_us), wall_us = profiled_us(
        prepare, [None, f"mcd_{cfg.cell}_seq_kernel"])
    return {"busy_ticks": n_ticks, "busy_steps_a_tick": n,
            "busy_tick_ms": wall_us / n_ticks / 1e3,
            "device_busy_ms_per_tick": dev_us / n_ticks / 1e3,
            "kernel_ms_per_tick": kern_us / n_ticks / 1e3,
            "device_idle_share": 1.0 - dev_us / wall_us}


# -- serving --------------------------------------------------------------

def reset_launches():
    for name in ALL_KERNELS:
        getattr(_module(name), name).launches = 0


def read_launches() -> dict:
    return {name: getattr(_module(name), name).launches
            for name in ALL_KERNELS}


def _check_launches(phase, counts, metrics, kernel, per_tick, want=None):
    bad = [m.tick for m in metrics if m.launches != per_tick(m)]
    if want is None:
        want = sum(per_tick(m) for m in metrics)
    others = {k: v for k, v in counts.items() if k != kernel and v}
    if bad or counts[kernel] != want or others:
        raise RuntimeError(f"{phase}: ticks {bad} did not launch {kernel} "
                           f"as expected ({counts}, {len(metrics)} ticks, "
                           f"{want} wanted)")


def _serve_stats(metrics, card) -> dict:
    from repro_torch.serve import summarize
    agg = summarize(metrics)
    return {"card": card, "sessions": SESSIONS, "chains": S,
            "rows": SESSIONS * S, "ticks": agg["ticks"],
            "launches": agg["launches"],
            "tick_ms_p50": agg["duration_s_p50"] * 1e3,
            "tick_ms_p95": agg["duration_s_p95"] * 1e3,
            "chain_steps_per_s": agg["tokens_per_sec"],
            "pad_waste": agg["pad_waste"],
            "tick_ms": [m.duration_s * 1e3 for m in metrics]}


def _beats():
    from repro_torch.data import ecg
    from repro_torch.launch.stream import build_streams
    streams, _ = build_streams(SESSIONS, 1, seed=0)
    if any(len(s) != T_BEAT for s in streams) or ecg.T_STEPS != T_BEAT:
        raise RuntimeError("ECG beats are not 140 steps long")
    return streams


def _unchunked(streams, sids, eng, dev):
    """Every whole beat S times (session-major), its rows and lengths."""
    import numpy as np
    import torch
    x = torch.from_numpy(np.concatenate(
        [np.repeat(s[None], S, 0) for s in streams])).to(dev)
    rows = torch.from_numpy(np.concatenate(
        [eng.store.get(sid).rows for sid in sids]).astype(np.int64)).to(dev)
    return x, rows, torch.full((len(rows),), T_BEAT, device=dev)


def _check_states(eng, sids, states, phase):
    import torch
    for li, layer in enumerate(states):
        for k, sid in enumerate(sids):
            for part, whole in zip(eng.store.get(sid).state[li], layer):
                if not torch.equal(part, whole[k * S:(k + 1) * S]):
                    raise RuntimeError(f"{phase}: chunked != unchunked for "
                                       f"{sid} at layer {li}")


def serving_phase(report, dev):
    """The LSTM classifier on ``cuda_seq`` (random ragged chunks)."""
    import numpy as np
    import torch
    from repro_torch.core import classifier as clf, mcd
    from repro_torch.core.uncertainty import classification_summary
    from repro_torch.serve import StreamingEngine

    cfg = clf.ClassifierConfig(
        input_dim=1, hidden=8, num_layers=3, num_classes=4,
        mcd=mcd.MCDConfig(p=0.125, placement="YNY", n_samples=S, seed=0))
    params = clf.init(torch.Generator().manual_seed(0), cfg, device=dev)
    streams = _beats()
    eng = StreamingEngine(params, cfg, backend="cuda_seq",
                          max_sessions=SESSIONS, chunk_capacity=CHUNK,
                          device=dev)
    sids = [f"ecg-{k}" for k in range(SESSIONS)]
    for sid in sids:
        eng.open_session(sid)
    rng = np.random.default_rng(1)
    final = {}
    reset_launches()                          # count the main path only
    while len(final) < SESSIONS:
        chunks = {}
        for k, sid in enumerate(sids):
            pos = eng.store.get(sid).steps
            if pos < T_BEAT:
                n = int(rng.integers(1, CHUNK + 1))
                chunks[sid] = streams[k][pos:pos + n]
        for sid, res in eng.step(chunks).items():
            if res.steps_total == T_BEAT:
                final[sid] = res.summary
    counts = read_launches()
    metrics = eng.metrics
    _check_launches("classifier", counts, metrics, "mcd_lstm_seq",
                    lambda m: cfg.num_layers)

    x, rows, full = _unchunked(streams, sids, eng, dev)
    logits, states = clf.apply(params, x, rows, cfg, backend="cuda_seq",
                               lengths=full, return_state=True, device=dev)
    _check_states(eng, sids, states, "classifier")
    ref_logits = clf.apply(params, x, rows, cfg, backend="reference",
                           lengths=full, device=dev)
    per = lambda lg: classification_summary(  # noqa: E731
        lg.reshape(SESSIONS, S, -1).transpose(0, 1))
    unchunked, reference = per(logits), per(ref_logits)
    d_unchunked = d_ref = 0.0
    for k, sid in enumerate(sids):
        for v, u, r in zip(final[sid], unchunked, reference):
            d_unchunked = max(d_unchunked,
                              max_abs_diff(v, u[k], f"summary of {sid}"))
            d_ref = max(d_ref, max_abs_diff(v, r[k], f"summary of {sid}"))
    if d_ref > SUMMARY_TOL or d_unchunked > SUMMARY_TOL:
        raise RuntimeError(f"summaries disagree: vs reference {d_ref}, "
                           f"vs unchunked {d_unchunked} (tol {SUMMARY_TOL})")
    probs = torch.stack([final[s].probs for s in sids])
    if probs.shape != (SESSIONS, 4) or \
            (probs.sum(-1) - 1).abs().max().item() > 1e-5:
        raise RuntimeError(f"bad class probabilities {probs.shape}")
    serve = _serve_stats(metrics, report["card"])
    serve.update(launches_by_kernel=counts,
                 summary_diff_vs_reference=d_ref,
                 summary_diff_vs_unchunked=d_unchunked)
    serve.update(profile_ticks(params, cfg, streams, dev,
                               "mcd_lstm_seq_kernel"))
    report["serving"] = serve
    print("serving " + json.dumps(serve), flush=True)
    return counts


def chunk_plans(rng, n_sessions, ticks):
    """Per session, ``ticks`` ragged chunk lengths in [1, CHUNK] that sum to
    a whole beat: every session ends on the last tick."""
    import numpy as np
    plans = []
    while len(plans) < n_sessions:
        lens = rng.multinomial(T_BEAT - ticks, [1.0 / ticks] * ticks) + 1
        if lens.max() <= CHUNK:
            plans.append([int(v) for v in lens])
    return np.asarray(plans)


def _per_session(a):
    """[sessions*S, ...] -> [S, sessions, ...], the engine's layout."""
    return a.reshape((SESSIONS, S) + a.shape[1:]).transpose(0, 1).float()


def autoencoder_phase(report, dev, cell):
    """The anomaly autoencoder on ``cuda_seq``: 64 sessions x 30 chains,
    whole beats in AE_TICKS ragged chunks."""
    import numpy as np
    import torch
    from repro_torch.core import autoencoder as ae, mcd
    from repro_torch.core.uncertainty import regression_summary
    from repro_torch.serve import StreamingEngine

    cfg = ae.AutoencoderConfig(
        input_dim=1, hidden=16, num_layers=2, cell=cell,
        heteroscedastic=True,
        mcd=mcd.MCDConfig(p=0.125, placement="YNYN", n_samples=S, seed=0))
    params = ae.init(torch.Generator().manual_seed(0), cfg, device=dev)
    streams = _beats()
    plans = chunk_plans(np.random.default_rng(3), SESSIONS, AE_TICKS)
    eng = StreamingEngine(params, cfg, backend="cuda_seq",
                          max_sessions=SESSIONS, chunk_capacity=CHUNK,
                          device=dev)
    sids = [f"ae-{k}" for k in range(SESSIONS)]
    for sid in sids:
        eng.open_session(sid)
    kernel = f"mcd_{cell}_seq"
    reset_launches()                          # count the main path only
    for t in range(AE_TICKS):
        res = eng.step({sid: streams[k][eng.store.get(sid).steps:][
            :plans[k, t]] for k, sid in enumerate(sids)})
    counts = read_launches()
    metrics = eng.metrics
    _check_launches(f"autoencoder {cell}", counts, metrics, kernel,
                    lambda m: 2 * cfg.num_layers)
    if any(eng.store.get(sid).steps != T_BEAT for sid in sids):
        raise RuntimeError("autoencoder sessions did not end on one tick")

    # One unchunked pass, decoded over the last tick's launch width: the
    # decoder replays the final bottleneck, so the last chunk's positions
    # are the same computation (the windowed decode is bit-equal to the
    # full replay's first positions).
    x, rows, full = _unchunked(streams, sids, eng, dev)
    ref_cfg = dataclasses.replace(cfg, decode_window=CHUNK)
    mean, log_var, states = ae.apply(params, x, rows, ref_cfg,
                                     backend="cuda_seq", lengths=full,
                                     return_state=True, device=dev)
    _check_states(eng, sids, states, f"autoencoder {cell}")
    unchunked = regression_summary(_per_session(mean),
                                   _per_session(log_var))
    ref_mean, ref_lv = ae.apply(params, x, rows, ref_cfg,
                                backend="reference", lengths=full,
                                device=dev)
    reference = regression_summary(_per_session(ref_mean),
                                   _per_session(ref_lv))
    d_ref = 0.0
    for k, sid in enumerate(sids):
        L = int(plans[k, -1])
        summ = res[sid].summary
        if summ.mean.shape != (L, 1):
            raise RuntimeError(f"{sid}: summary shape {summ.mean.shape}, "
                               f"expected ({L}, 1)")
        for field, v, u, r in zip(summ._fields, summ, unchunked, reference):
            d_ref = max(d_ref, max_abs_diff(v, r[k][:L],
                                            f"{field} of {sid}"))
            if not torch.equal(v, u[k][:L]):
                raise RuntimeError(f"autoencoder {cell}: chunked != "
                                   f"unchunked {field} for {sid}")
    if d_ref > SUMMARY_TOL:
        raise RuntimeError(f"autoencoder {cell}: summaries vs reference "
                           f"{d_ref} > {SUMMARY_TOL}")
    serve = _serve_stats(metrics, report["card"])
    serve.update(cell=cell, launches_by_kernel=counts,
                 summary_diff_vs_reference=d_ref,
                 chunked_equals_unchunked=True)
    serve.update(profile_ticks(params, cfg, streams, dev,
                               f"{kernel}_kernel"))
    report[f"serving_autoencoder_{cell}"] = serve
    print(f"serving autoencoder {cell} " + json.dumps(serve), flush=True)
    return counts


def step_backend_phase(report, dev):
    """The GRU classifier on ``cuda_seq``, then the same streams on
    ``cuda_step`` for both cells, each compared with ``cuda_seq``."""
    import numpy as np
    import torch
    from repro_torch.core import classifier as clf, mcd
    from repro_torch.serve import StreamingEngine

    streams = _beats()
    plan = np.random.default_rng(4).integers(1, CHUNK + 1,
                                             (STEP_TICKS, SESSIONS))
    sids = [f"st-{k}" for k in range(SESSIONS)]
    out, all_counts = {}, {}
    for cell in ("gru", "lstm"):
        cfg = clf.ClassifierConfig(
            input_dim=1, hidden=8, num_layers=3, num_classes=4, cell=cell,
            mcd=mcd.MCDConfig(p=0.125, placement="YNY", n_samples=S,
                              seed=0))
        params = clf.init(torch.Generator().manual_seed(0), cfg, device=dev)
        runs = {}
        for backend in ("cuda_seq", "cuda_step"):
            eng = StreamingEngine(params, cfg, backend=backend,
                                  max_sessions=SESSIONS,
                                  chunk_capacity=CHUNK, device=dev)
            for sid in sids:
                eng.open_session(sid)
            reset_launches()                  # count the main path only
            for t in range(STEP_TICKS):
                res = eng.step({sid: streams[k][eng.store.get(sid).steps:][
                    :plan[t, k]] for k, sid in enumerate(sids)})
            counts = read_launches()
            seq = backend == "cuda_seq"
            kernel = f"mcd_{cell}_{'seq' if seq else 'step'}"
            _check_launches(f"{cell} classifier {backend}", counts,
                            eng.metrics, kernel,
                            (lambda m: cfg.num_layers) if seq else
                            (lambda m: cfg.num_layers * m.capacity))
            all_counts[f"{cell}/{backend}"] = counts
            runs[backend] = (eng, res, _serve_stats(eng.metrics,
                                                    report["card"]))
        (seq_eng, seq_res, seq_stats), (st_eng, st_res, st_stats) = \
            runs["cuda_seq"], runs["cuda_step"]
        diff, bit_equal = 0.0, True
        for sid in sids:
            pairs = [(a, b) for la, lb in zip(st_eng.store.get(sid).state,
                                              seq_eng.store.get(sid).state)
                     for a, b in zip(la, lb)]
            pairs += list(zip(st_res[sid].summary, seq_res[sid].summary))
            for a, b in pairs:
                diff = max(diff, max_abs_diff(
                    a, b, f"{cell} cuda_step vs cuda_seq, {sid}"))
                bit_equal = bit_equal and torch.equal(a, b)
        if diff > TOL or not bit_equal:
            raise RuntimeError(f"{cell} classifier: cuda_step vs cuda_seq "
                               f"differ ({diff}; tol {TOL}, bitwise "
                               f"required: both run mcd_cells.cuh)")
        out[cell] = {"cuda_seq": seq_stats, "cuda_step": st_stats,
                     "max_abs_diff_step_vs_seq": diff,
                     "bit_equal_step_vs_seq": bit_equal}
    out["launches_by_run"] = all_counts
    report["serving_step_backend"] = out
    print("serving step backend " + json.dumps(out), flush=True)
    total = {name: 0 for name in ALL_KERNELS}
    for counts in all_counts.values():
        for name, v in counts.items():
            total[name] += v
    return total


# -- the compiled tick: graph against eager ------------------------------

# (model, cell, backend, precision, chunk_capacity) of phase 5c.
GRAPH_CELLS = (
    ("classifier", "lstm", "cuda_seq", None, CHUNK),
    ("classifier", "lstm", "cuda_seq", None, "auto"),
    ("autoencoder", "gru", "cuda_seq", None, CHUNK),
    ("classifier", "lstm", "cuda_step", None, CHUNK),
    ("classifier", "gru", "cuda_step", None, "auto"),
    ("classifier", "lstm", "cuda_seq", "int8", "auto"),
    ("autoencoder", "gru", "cuda_seq", "int4", CHUNK),
)
GRAPH_RUNS = 1      # runs a side, graph and eager in turns (one: the
                    # time phases 15 and 16 take)
GRAPH_TICKS = 12    # every beat in 12 ragged chunks
TICK_PARTS = ("assemble", "to_device", "apply", "summaries", "store",
              "sync")


def ecg_model(model, cell, dev):
    """(cfg, params, layer launches a tick at T = 1) of the ECG classifier
    (I = 1, H = 8, NL = 3, YNY) or autoencoder (H = 16, NL = 2, YNYN,
    heteroscedastic), random weights from seed 0."""
    import torch
    from repro_torch.core import autoencoder as ae, classifier as clf, mcd
    if model == "classifier":
        cfg = clf.ClassifierConfig(
            input_dim=1, hidden=8, num_layers=3, num_classes=4, cell=cell,
            mcd=mcd.MCDConfig(p=0.125, placement="YNY", n_samples=S,
                              seed=0))
        return (cfg, clf.init(torch.Generator().manual_seed(0), cfg,
                              device=dev), cfg.num_layers)
    cfg = ae.AutoencoderConfig(
        input_dim=1, hidden=16, num_layers=2, cell=cell,
        heteroscedastic=True,
        mcd=mcd.MCDConfig(p=0.125, placement="YNYN", n_samples=S, seed=0))
    return (cfg, ae.init(torch.Generator().manual_seed(0), cfg, device=dev),
            2 * cfg.num_layers)


def _graph_run(params, cfg, dev, graphs, plans, sids, streams, **kw):
    """One engine over the chunk ``plans``: (engine, every tick's
    results, launch counts, prewarm seconds and capacities)."""
    import torch
    from repro_torch.serve import StreamingEngine, prewarm
    eng = StreamingEngine(params, cfg, max_sessions=SESSIONS, device=dev,
                          graphs=graphs, **kw)
    warm = None
    if graphs:
        t0 = time.perf_counter()
        caps = prewarm(eng)
        warm = (time.perf_counter() - t0, caps)
        if len(eng._graphs) != len(caps) or any(
                not e.step.ready or (dev.type == "cuda" and e.step.graph
                                     is None)
                for e in eng._graphs.values()):
            raise RuntimeError("prewarm did not capture every rung")
    for sid in sids:
        eng.open_session(sid)
    reset_launches()                          # count the main path only
    ticks = [eng.step({sid: streams[k][eng.store.get(sid).steps:][
        :plans[k, t]] for k, sid in enumerate(sids)})
        for t in range(plans.shape[1])]
    torch.cuda.synchronize()
    return eng, ticks, read_launches(), warm


def _same_serving(a, b, sids, what):
    """Carries and every tick's summaries of two runs, bit for bit (a tick
    serves the sessions that had a chunk)."""
    import torch
    ea, ta = a[:2]
    eb, tb = b[:2]
    for sid in sids:
        for la, lb in zip(ea.store.get(sid).state, eb.store.get(sid).state,
                          strict=True):
            for x, y in zip(la, lb, strict=True):
                if x.dtype != y.dtype or not torch.equal(x, y):
                    raise RuntimeError(f"{what}: carry of {sid} differs")
    for t, (ra, rb) in enumerate(zip(ta, tb, strict=True)):
        if ra.keys() != rb.keys():
            raise RuntimeError(f"{what}: tick {t} served other sessions")
        for sid in ra:
            for x, y in zip(ra[sid].summary, rb[sid].summary, strict=True):
                max_abs_diff(x, y, f"{what} tick {t} summary of {sid}")
                if not torch.equal(x, y):
                    raise RuntimeError(f"{what}: tick {t} summary of {sid} "
                                       "differs")


def _side_stats(runs, card) -> dict:
    """Tick times of one side's runs, pooled, with each run's first tick
    and the p50 host seconds of each part of a tick."""
    import numpy as np
    metrics = [m for eng, *_ in runs for m in eng.metrics]
    out = _serve_stats(metrics, card)
    out.pop("tick_ms")
    out["runs"] = len(runs)
    out["tick_ms_p50_by_run"] = [_serve_stats(eng.metrics, card)[
        "tick_ms_p50"] for eng, *_ in runs]
    out["first_tick_ms"] = [eng.metrics[0].duration_s * 1e3
                            for eng, *_ in runs]
    out["part_ms_p50"] = {
        part: float(np.percentile([m.parts_s[part] for m in metrics], 50))
        * 1e3 for part in TICK_PARTS}
    out["compiles"] = sum(m.compiles for m in metrics)
    return out


def graph_phase(report, dev):
    """Phase 5c: the tick as the replay of one captured CUDA graph against
    the same engine served eagerly, on GRAPH_CELLS: each cell GRAPH_RUNS
    runs a side in turns (graph, eager, eager, graph, ...), every run 64
    sessions x S = 30 over whole beats in GRAPH_TICKS ragged chunks.  A
    graph run is prewarmed (its capacities and seconds recorded).  Checks:
    every carry and every tick's summaries bit-equal to the first eager
    run's, chunked == unchunked (the first graph run against one pass over
    the whole beats on the cell's backend and precision), no capture on
    any tick after prewarm, and the launches of every tick equal to the
    eager tick's (one a layer, or one a layer a step).  Times: tick p50 /
    p95, chain-steps/s, each run's first tick, the parts of a tick, and
    the device's idle share from a profile of 5 ticks a side."""
    import numpy as np
    from repro_torch.core import autoencoder as ae, classifier as clf
    from repro_torch.serve import pow2_ladder

    streams = _beats()
    plans = chunk_plans(np.random.default_rng(6), SESSIONS, GRAPH_TICKS)
    sids = [f"g-{k}" for k in range(SESSIONS)]
    out, total = {}, {name: 0 for name in ALL_KERNELS}
    for model, cell, backend, prec, cap in GRAPH_CELLS:
        cfg, params, per_layer = ecg_model(model, cell, dev)
        kw = dict(backend=backend, precision=prec, chunk_capacity=cap,
                  ladder=pow2_ladder(CHUNK) if cap == "auto" else None)
        key = (f"{model}_{cell}_{backend}_{prec or 'fp32'}_"
               f"{'auto' if cap == 'auto' else 'fixed'}")
        seq = backend == "cuda_seq"
        kernel = f"mcd_{cell}_{'seq' if seq else 'step'}"
        runs = {True: [], False: []}
        for r in range(GRAPH_RUNS):
            for graphs in ((True, False) if r % 2 == 0 else (False, True)):
                run = _graph_run(params, cfg, dev, graphs, plans, sids,
                                 streams, **kw)
                eng, _, counts, _ = run
                _check_launches(
                    f"{key} {'graph' if graphs else 'eager'}", counts,
                    eng.metrics, kernel,
                    (lambda m: per_layer) if seq
                    else (lambda m: per_layer * m.capacity))
                if graphs:
                    for name, v in counts.items():
                        total[name] += v
                    if any(m.compiles for m in eng.metrics):
                        raise RuntimeError(f"{key}: a tick captured after "
                                           "prewarm")
                runs[graphs].append(run)
        base = runs[False][0]
        for k, run in enumerate(runs[True] + runs[False][1:]):
            _same_serving(run, base, sids, f"{key} run {k}")
        for g, e in zip(runs[True], runs[False]):
            if [m.launches for m in g[0].metrics] != \
                    [m.launches for m in e[0].metrics]:
                raise RuntimeError(f"{key}: launches a tick differ")
        # chunked == unchunked on the graph run's carries
        geng = runs[True][0][0]
        x, rows, full = _unchunked(streams, sids, geng, dev)
        if model == "classifier":
            _, states = clf.apply(params, x, rows, cfg, backend=backend,
                                  lengths=full, return_state=True,
                                  precision=prec, device=dev)
        else:
            *_, states = ae.apply(params, x, rows, cfg, backend=backend,
                                  lengths=full, return_state=True,
                                  precision=prec, device=dev)
        _check_states(geng, sids, states, key)
        match = f"{kernel}_kernel"
        cell_out = {
            "model": model, "cell": cell, "backend": backend,
            "precision": prec or "fp32",
            "chunk_capacity": cap,
            "prewarm": [{"seconds": w[0], "capacities": w[1]}
                        for *_, w in runs[True]],
            "graph": _side_stats(runs[True], report["card"]),
            "eager": _side_stats(runs[False], report["card"]),
            "bit_equal_graph_vs_eager": True,
            "chunked_equals_unchunked": True}
        for side, graphs in (("graph", True), ("eager", False)):
            cell_out[side].update(profile_ticks(
                params, cfg, streams, dev, match, graphs=graphs, **kw))
        out[key] = cell_out
        print(f"graph {key} " + json.dumps(cell_out), flush=True)
    report["serving_graphs"] = out
    return total


# -- durable and early-exiting streams ---------------------------------------

# (model, cell, backend, precision) of phase 5d's kill -> snapshot -> restore.
DURABLE_CELLS = (("classifier", "lstm", "cuda_seq", None),
                 ("classifier", "gru", "cuda_step", "bf16"),
                 ("autoencoder", "gru", "cuda_seq", "int4"))
DURABLE_TICKS = 12     # every beat in 12 ragged chunks
KILL_TICK = 5          # ticks served before the snapshot
REATTACH_TICK = 8      # a session closes here: the queued re-attach goes on
DURABLE_NEW = ("d-new-0", "d-new-1")   # fresh tickets; the first at S / 2
EE_THRESHOLD = 1e-3    # early exit: |MI_full - MI_prefix| at which to halve
EE_FLOOR = 4           # its min_samples
CHILD_TIMEOUT = 300    # seconds; the restore child takes ~15 on the card


def _durable_dir(k):
    return os.path.join(ROOT, "build", "phase5d", f"cell{k}")


def _durable_setup(k, dev):
    """Cell ``k``'s (cfg, params, layer launches a tick at T = 1, engine
    kwargs, streams, plans, session ids): 64 sessions and the two fresh
    tickets, each with a row of whole-beat chunk plans."""
    import numpy as np
    model, cell, backend, prec = DURABLE_CELLS[k]
    cfg, params, per_layer = ecg_model(model, cell, dev)
    kw = dict(backend=backend, precision=prec, max_sessions=SESSIONS,
              device=dev)
    plans = chunk_plans(np.random.default_rng(7 + k), SESSIONS + 2,
                        DURABLE_TICKS)
    sids = [f"d-{i}" for i in range(SESSIONS)] + list(DURABLE_NEW)
    return cfg, params, per_layer, kw, _beats(), plans, sids


def _durable_chunks(eng, streams, plans, sids):
    """Each live session's next planned chunk (none once its beat ends)."""
    chunks = {}
    for sid in eng.active_sessions:
        i, sess = sids.index(sid), eng.store.get(sid)
        if sess.chunks < plans.shape[1]:
            chunks[sid] = streams[i % SESSIONS][sess.steps:][
                :plans[i, sess.chunks]]
    return chunks


def _durable_pre(eng, streams, plans, sids):
    """Ticks 0 .. KILL_TICK - 1, then the wait-list: two fresh tickets
    queued on a full store (one at S / 2 chains), two sessions closed (each
    close drains one ticket), the first queued back as a re-attach."""
    for sid in sids[:SESSIONS]:
        eng.open_session(sid)
    for _ in range(KILL_TICK):
        eng.step(_durable_chunks(eng, streams, plans, sids))
    if (eng.admit(DURABLE_NEW[0], n_samples=S // 2) is not None
            or eng.admit(DURABLE_NEW[1]) is not None):
        raise RuntimeError("5d: a fresh ticket went live on a full store")
    evicted = eng.close_session(sids[0])
    eng.close_session(sids[1])
    if eng.admit(sids[0], session=evicted) is not None or \
            eng.queued_sessions != [sids[0]] or \
            eng.store.get(DURABLE_NEW[0]).rows.shape[0] != S // 2:
        raise RuntimeError("5d: the wait-list is not as planned")


def _durable_post(eng, streams, plans, sids):
    """The ticks after the kill point, to the end of every beat; at tick
    REATTACH_TICK a session closes and the queued re-attach goes live."""
    ticks = []
    while True:
        if eng.tick == REATTACH_TICK:
            eng.close_session(sids[2])
            if sids[0] not in eng.active_sessions:
                raise RuntimeError("5d: the re-attach did not go live")
        chunks = _durable_chunks(eng, streams, plans, sids)
        if not chunks:
            return ticks
        ticks.append(eng.step(chunks))


def _durable_restore(k, dev, capacity=CHUNK):
    """A fresh engine of cell ``k`` (``capacity``), prewarmed, restored
    from the cell's snapshot and served to the end: its ticks' results,
    the engine, the launch counts of those ticks, restore and prewarm
    seconds."""
    import torch
    from repro_torch.serve import StreamingEngine, pow2_ladder, prewarm
    cfg, params, _, kw, streams, plans, sids = _durable_setup(k, dev)
    eng = StreamingEngine(params, cfg, chunk_capacity=capacity,
                          ladder=pow2_ladder(CHUNK) if capacity == "auto"
                          else None, **kw)
    t0 = time.perf_counter()
    caps = prewarm(eng)
    prewarm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng.restore(_durable_dir(k))
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    reset_launches()                          # count the main path only
    ticks = _durable_post(eng, streams, plans, sids)
    return ticks, eng, read_launches(), restore_s, (prewarm_s, caps)


def durable_child(path):
    """Cell 0 restored in a fresh process of this script (nothing of the
    process that wrote the snapshot carries over): its results, carries,
    metrics and launch counts to ``path`` (torch.save, CPU tensors)."""
    import torch
    ticks, eng, counts, restore_s, warm = _durable_restore(
        0, torch.device("cuda"))
    torch.save({
        "ticks": [{sid: [v.cpu() for v in r.summary]
                   for sid, r in t.items()} for t in ticks],
        "states": {sid: [[p.cpu() for p in layer]
                         for layer in eng.store.get(sid).state]
                   for sid in eng.active_sessions},
        "launches": [m.launches for m in eng.metrics],
        "compiles": [m.compiles for m in eng.metrics],
        "tick_ms": [m.duration_s * 1e3 for m in eng.metrics],
        "counts": counts, "restore_s": restore_s, "prewarm": warm,
        "tick": eng.tick}, path)


def _same_durable(ticks, states, gold_ticks, gold, what):
    """Every tick's summaries and every final carry of a restored run,
    bit-equal to the uninterrupted run's (``ticks``: per tick, sid ->
    summary fields; ``states``: sid -> carry parts a layer)."""
    import torch
    if len(ticks) != len(gold_ticks):
        raise RuntimeError(f"{what}: {len(ticks)} ticks, the uninterrupted "
                           f"run served {len(gold_ticks)}")
    for t, (got, want) in enumerate(zip(ticks, gold_ticks)):
        if got.keys() != want.keys():
            raise RuntimeError(f"{what}: tick {t} served other sessions")
        for sid, fields in got.items():
            for a, b in zip(fields, want[sid].summary, strict=True):
                max_abs_diff(a.to(b.device), b, f"{what} tick {t} {sid}")
                if a.dtype != b.dtype or not torch.equal(a.to(b.device), b):
                    raise RuntimeError(f"{what}: tick {t} summary of {sid} "
                                       "differs")
    if sorted(states) != sorted(gold.active_sessions):
        raise RuntimeError(f"{what}: other sessions live at the end")
    for sid, layers in states.items():
        for la, lb in zip(layers, gold.store.get(sid).state, strict=True):
            for a, b in zip(la, lb, strict=True):
                if a.dtype != b.dtype or not torch.equal(a.to(b.device), b):
                    raise RuntimeError(f"{what}: carry of {sid} differs")


def _snapshot_disk(path) -> tuple[int, int]:
    names = os.listdir(path)
    return (sum(os.path.getsize(os.path.join(path, n)) for n in names),
            len(names))


def _kill_restore_cell(k, report, dev, total):
    """One cell of phase 5d: the uninterrupted run, the victim and its
    snapshot, the restore (in a child process for cell 0, then again
    into an ``"auto"`` engine), every check; returns the cell's record."""
    import numpy as np
    import torch
    from repro_torch.serve import StreamingEngine, prewarm
    model, cell, backend, prec = DURABLE_CELLS[k]
    cfg, params, per_layer, kw, streams, plans, sids = _durable_setup(k, dev)
    key = f"{model}_{cell}_{backend}_{prec or 'fp32'}"
    seq = backend == "cuda_seq"
    kernel = f"mcd_{cell}_{'seq' if seq else 'step'}"
    per_tick = ((lambda m: per_layer) if seq
                else (lambda m: per_layer * m.capacity))

    def counted(counts, metrics, what):
        _check_launches(f"5d {key} {what}", counts, metrics, kernel,
                        per_tick)
        for name, v in counts.items():
            total[name] += v

    gold = StreamingEngine(params, cfg, chunk_capacity=CHUNK, **kw)
    prewarm(gold)
    reset_launches()                          # count the main path only
    _durable_pre(gold, streams, plans, sids)
    n_pre = len(gold.metrics)
    gold_ticks = _durable_post(gold, streams, plans, sids)
    counted(read_launches(), gold.metrics, "uninterrupted")

    victim = StreamingEngine(params, cfg, chunk_capacity=CHUNK, **kw)
    prewarm(victim)
    reset_launches()
    _durable_pre(victim, streams, plans, sids)
    counted(read_launches(), victim.metrics, "victim")
    path = _durable_dir(k)
    shutil.rmtree(path, ignore_errors=True)
    t0 = time.perf_counter()
    snap = victim.snapshot(path)
    snapshot_s = time.perf_counter() - t0
    nbytes, nfiles = _snapshot_disk(snap)
    del victim

    restores = []
    if k == 0:
        out = os.path.join(ROOT, "build", "phase5d_child.pt")
        if os.path.exists(out):
            os.remove(out)
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--phase5d-child", out], check=True,
                        timeout=CHILD_TIMEOUT)
        rec = torch.load(out)
        os.remove(out)
        _same_durable(rec["ticks"], rec["states"], gold_ticks, gold,
                      f"5d {key} child")
        launches, compiles = rec["launches"], rec["compiles"]
        for name, v in rec["counts"].items():
            total[name] += v
        restores.append({"where": "child process", "capacity": CHUNK,
                         "restore_ms": rec["restore_s"] * 1e3,
                         "prewarm_s": rec["prewarm"][0],
                         "first_tick_ms": rec["tick_ms"][0],
                         "tick_ms_p50": float(np.percentile(
                             rec["tick_ms"], 50)),
                         "launches": launches, "compiles": compiles})
    for where, cap in ([("this process, auto", "auto")] if k == 0
                       else [("this process", CHUNK)]):
        ticks, eng, counts, restore_s, warm = _durable_restore(k, dev, cap)
        counted(counts, eng.metrics, f"restored ({where})")
        _same_durable([{sid: r.summary for sid, r in t.items()}
                       for t in ticks],
                      {sid: eng.store.get(sid).state
                       for sid in eng.active_sessions},
                      gold_ticks, gold, f"5d {key} {where}")
        if any(p.device != gold.store.get(sid).state[0][0].device
               for sid in eng.active_sessions
               for layer in eng.store.get(sid).state for p in layer):
            raise RuntimeError(f"5d {key}: a carry is off the card")
        restores.append({"where": where, "capacity": cap,
                         "restore_ms": restore_s * 1e3,
                         "prewarm_s": warm[0], "capacities": warm[1],
                         "first_tick_ms": eng.metrics[0].duration_s * 1e3,
                         "tick_ms_p50": float(np.percentile(
                             [m.duration_s * 1e3 for m in eng.metrics], 50)),
                         "launches": [m.launches for m in eng.metrics],
                         "compiles": [m.compiles for m in eng.metrics]})
    want = [m.launches for m in gold.metrics[n_pre:]]
    for r in restores:
        if r["launches"] != want:
            raise RuntimeError(f"5d {key} {r['where']}: launches a tick "
                               f"{r['launches']}, uninterrupted {want}")
        if any(r["compiles"]):
            raise RuntimeError(f"5d {key} {r['where']}: a tick captured "
                               f"after restore ({r['compiles']})")
        r["launches"] = sum(r["launches"])
        r.pop("compiles")
    gold_ms = [m.duration_s * 1e3 for m in gold.metrics]
    return key, {
        "card": report["card"], "model": model, "cell": cell,
        "backend": backend, "precision": prec or "fp32",
        "sessions": SESSIONS, "chains": S, "ticks": len(gold_ms),
        "kill_after_ticks": KILL_TICK,
        "snapshot_ms": snapshot_s * 1e3, "snapshot_bytes": nbytes,
        "snapshot_files": nfiles,
        "uninterrupted_tick_ms_p50": float(np.percentile(gold_ms, 50)),
        "restores": restores, "bit_equal_to_uninterrupted": True}


def _early_exit_run(params, cfg, dev, streams, plans, threshold):
    """64 sessions (the first 32 flat, the rest ECG beats) over ``plans``
    on the classifier LSTM (``cuda_seq``, capacity CHUNK, prewarmed)."""
    import numpy as np
    from repro_torch.serve import StreamingEngine, prewarm
    eng = StreamingEngine(params, cfg, backend="cuda_seq",
                          max_sessions=SESSIONS, chunk_capacity=CHUNK,
                          device=dev, early_exit_threshold=threshold,
                          min_samples=EE_FLOOR)
    prewarm(eng)
    sids = [f"ee-{k}" for k in range(SESSIONS)]
    for sid in sids:
        eng.open_session(sid)
    flat = np.zeros((T_BEAT, 1), np.float32)
    ticks, served = [], []                    # served: each tick's chains
    reset_launches()                          # count the main path only
    for t in range(plans.shape[1]):
        served.append({sid: int(eng.store.get(sid).rows.shape[0])
                       for sid in sids})
        ticks.append(eng.step({sid: (flat if k < SESSIONS // 2
                                     else streams[k])[
            eng.store.get(sid).steps:][:plans[k, t]]
            for k, sid in enumerate(sids)}))
    return eng, ticks, read_launches(), sids, served


def _early_exit_cell(report, dev, total):
    """Early exit on the graph path: the classifier LSTM with
    EE_THRESHOLD / EE_FLOOR against the same engine with it off."""
    import numpy as np
    import torch
    from repro_torch.serve import StreamingEngine, summarize
    cfg, params, per_layer = ecg_model("classifier", "lstm", dev)
    streams = _beats()
    plans = chunk_plans(np.random.default_rng(9), SESSIONS, DURABLE_TICKS)
    runs = {}
    for side, thr in (("off", None), ("on", EE_THRESHOLD)):
        eng, ticks, counts, sids, served = _early_exit_run(
            params, cfg, dev, streams, plans, thr)
        _check_launches(f"5d early exit {side}", counts, eng.metrics,
                        "mcd_lstm_seq", lambda m: per_layer)
        for name, v in counts.items():
            total[name] += v
        runs[side] = (eng, ticks, served)
    (off, off_ticks, _), (on, on_ticks, served) = runs["off"], runs["on"]
    s_end = {sid: int(on.store.get(sid).rows.shape[0]) for sid in sids}
    reclaimed = [m.reclaimed_rows for m in on.metrics]
    if not any(reclaimed):
        raise RuntimeError("5d early exit retired no chain")
    flat = sids[:SESSIONS // 2]
    if any(s_end[sid] != EE_FLOOR for sid in flat):
        raise RuntimeError(f"5d early exit: flat sessions end at "
                           f"{sorted({s_end[s] for s in flat})} chains, "
                           f"not {EE_FLOOR}")
    # A session served at all S chains on a tick has, up to that tick, the
    # carries and inputs it has with early exit off: its summary there is
    # the off engine's, bit for bit, whether or not it retires later.
    kept = [sid for sid in sids if s_end[sid] == S]
    full_ticks = 0
    for t, (a, b) in enumerate(zip(on_ticks, off_ticks)):
        for sid in sids:
            if served[t][sid] != S:
                continue
            full_ticks += 1
            for x, y in zip(a[sid].summary, b[sid].summary, strict=True):
                if not torch.equal(x, y):
                    raise RuntimeError(f"5d early exit: tick {t} summary of "
                                       f"{sid}, served at all {S} chains, "
                                       "moved")
    for sid in kept:
        for la, lb in zip(on.store.get(sid).state, off.store.get(sid).state):
            for x, y in zip(la, lb):
                if not torch.equal(x, y):
                    raise RuntimeError(f"5d early exit: carry of "
                                       f"never-retired {sid} moved")
    path = os.path.join(ROOT, "build", "phase5d", "early_exit")
    shutil.rmtree(path, ignore_errors=True)
    on.snapshot(path)
    back = StreamingEngine(params, cfg, backend="cuda_seq",
                           max_sessions=SESSIONS, chunk_capacity=CHUNK,
                           device=dev, early_exit_threshold=EE_THRESHOLD,
                           min_samples=EE_FLOOR)
    back.restore(path)
    if {sid: int(back.store.get(sid).rows.shape[0]) for sid in sids} \
            != s_end:
        raise RuntimeError("5d early exit: a restored session's S differs")
    agg_on, agg_off = summarize(on.metrics), summarize(off.metrics)
    ecg_s = [s_end[sid] for sid in sids[SESSIONS // 2:]]
    return {"card": report["card"], "threshold": EE_THRESHOLD,
            "min_samples": EE_FLOOR, "sessions_flat": len(flat),
            "sessions_ecg": len(ecg_s), "ticks": len(on_ticks),
            "reclaimed_rows_by_tick": reclaimed,
            "reclaimed_rows": agg_on["reclaimed_rows"],
            "active_chains_by_tick": [m.active_chains for m in on.metrics],
            "ecg_sessions_chains_at_end": {str(s): ecg_s.count(s)
                                           for s in sorted(set(ecg_s))},
            "never_retired": len(kept),
            "session_ticks_at_all_chains_bit_equal_to_off": full_ticks,
            "tick_ms_p50_on": agg_on["duration_s_p50"] * 1e3,
            "tick_ms_p50_off": agg_off["duration_s_p50"] * 1e3,
            "early_exit_part_ms_p50": float(np.percentile(
                [m.parts_s["early_exit"] for m in on.metrics], 50)) * 1e3,
            "never_retired_bit_equal_to_off": True,
            "restored_s_equal": True}


def durable_phase(report, dev):
    """Phase 5d: kill -> snapshot -> restore on DURABLE_CELLS, then early
    exit.  Each cell serves 64 sessions x S = 30 over whole beats in 12
    ragged chunks (capacity 20, graphs, prewarmed): ticks 0-4, then two
    fresh tickets queued on the full store (one at S / 2), two sessions
    closed (each drains a ticket) and the first queued back as a
    re-attach; a snapshot; a fresh prewarmed engine restores it and serves
    to the end (at tick 8 a session closes and the re-attach goes live).
    Cell 0 is restored in a child process of this script, then again
    into a ``chunk_capacity="auto"`` engine (8, 16, 20).  Checks: every
    tick's summaries and the final carries bit-equal to the same engine
    run uninterrupted, the launches of every tick equal, no capture after
    the restore.  Early exit: the classifier LSTM (``cuda_seq``, graphs)
    over 32 flat and 32 ECG sessions at EE_THRESHOLD / EE_FLOOR: some
    tick reclaims rows, flat sessions end at EE_FLOOR chains, every
    session's summary on every tick it was served at all S chains, and the
    carries of every session never retired, are bit-equal to the engine
    with early exit off, and a snapshot after the retirements restores
    each session's S."""
    total = {name: 0 for name in ALL_KERNELS}
    out = {}
    for k in range(len(DURABLE_CELLS)):
        key, rec = _kill_restore_cell(k, report, dev, total)
        out[key] = rec
        print(f"durable {key} " + json.dumps(rec), flush=True)
    out["early_exit"] = _early_exit_cell(report, dev, total)
    print("early_exit " + json.dumps(out["early_exit"]), flush=True)
    shutil.rmtree(os.path.join(ROOT, "build", "phase5d"),
                  ignore_errors=True)
    report["durable"] = out
    return total


# -- phase 5e: distilled students ----------------------------------------------

# (model, cell, backend) of each cell: fp32, S = 30, capacity 20, graphs.
STUDENT_CELLS = (("classifier", "lstm", "cuda_seq"),
                 ("autoencoder", "gru", "cuda_step"))
DISTILL_BEATS = 64     # the teacher batch: 64 beats x 30 chains, one launch
DISTILL_STEPS = 200    # head steps over the cached batch
TEACHER_TOL = 1e-5     # teacher targets and features: the kernels against
                       # the port's reference backend on the card
STUDENT_TOL = 1e-6     # a student's summary against the heads on a solo
                       # deterministic pass of its signal (a [32, H] and a
                       # [1, H] product may round differently in cuBLAS)
STUDENT_KILL_TICK = 5  # ticks served before the snapshot


def _student_setup(k, dev):
    """Cell ``k``'s (key, cfg, params, layer launches a tick at T = 1,
    kernel name, streams, plans, session ids, modes): 64 sessions, the
    odd ones students, every beat in 12 ragged chunks."""
    import numpy as np
    model, cell, backend = STUDENT_CELLS[k]
    cfg, params, per_layer = ecg_model(model, cell, dev)
    kernel = f"mcd_{cell}_{backend.removeprefix('cuda_')}"
    plans = chunk_plans(np.random.default_rng(11 + k), SESSIONS,
                        DURABLE_TICKS)
    sids = [f"e-{i}" for i in range(SESSIONS)]
    modes = ["student" if i % 2 else "mc" for i in range(SESSIONS)]
    return (f"{model}_{cell}_{backend}", cfg, params, per_layer, kernel,
            _beats(), plans, sids, modes)


def _distill(model, cfg, params, backend, dev):
    """Distil heads from the MC teacher on DISTILL_BEATS beats: the
    teacher sweep held against the reference backend, then the fit.
    Returns (student, record, launches of the fit)."""
    import torch
    from repro_torch.data import ecg
    from repro_torch.train import distill as dtrain
    x = torch.from_numpy(ecg.make_ecg5000(0)[0][:DISTILL_BEATS]).to(dev)
    batches, fit = ((dtrain.classifier_batches, dtrain.distill_classifier)
                    if model == "classifier" else
                    (dtrain.autoencoder_batches, dtrain.distill_autoencoder))
    dcfg = dtrain.DistillConfig(backend=backend, cache_targets=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = next(batches(params, cfg, [x], dcfg, dev))
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    want = next(batches(params, cfg, [x], dataclasses.replace(
        dcfg, backend="reference"), dev))
    errs = {name: max_abs_diff(got[name], want[name], f"5e teacher {name}")
            for name in got}
    if max(errs.values()) > TEACHER_TOL:
        raise RuntimeError(f"5e {model}: the teacher pass on {backend} is "
                           f"off the reference backend: {errs}")
    reset_launches()
    t0 = time.perf_counter()
    student, hist = fit(params, cfg, [x], DISTILL_STEPS, dcfg=dcfg,
                        generator=torch.Generator().manual_seed(1),
                        device=dev)
    torch.cuda.synchronize()
    distill_s = time.perf_counter() - t0
    counts = read_launches()
    if not hist[-1]["loss"] < hist[0]["loss"]:
        raise RuntimeError(f"5e {model}: the distillation loss did not fall "
                           f"({hist[0]['loss']} -> {hist[-1]['loss']})")
    rec = {"beats": DISTILL_BEATS, "teacher_rows": DISTILL_BEATS * S,
           "steps": len(hist), "teacher_sweep_s": sweep_s,
           "distill_s": distill_s, "head_steps_s": distill_s - sweep_s,
           "loss_first": hist[0]["loss"], "loss_last": hist[-1]["loss"],
           "teacher_vs_reference": errs}
    return student, rec, counts


def _student_step(eng, streams, plans, sids, t):
    """Tick ``t`` of the cell's plans for the engine's live sessions, in
    ``sids`` order (the order fixes the summaries' columns)."""
    chunks = {}
    for i, sid in enumerate(sids):
        if sid in eng.store:
            sess = eng.store.get(sid)
            chunks[sid] = streams[i][sess.steps:][:plans[i, t]]
    return eng.step(chunks)


def _same_results(a, b, sids, what):
    import torch
    for sid in sids:
        for x, y in zip(a[sid].summary, b[sid].summary, strict=True):
            max_abs_diff(x, y, f"{what} summary of {sid}")
            if x.dtype != y.dtype or not torch.equal(x, y):
                raise RuntimeError(f"{what}: summary of {sid} differs")


def _same_carries(ea, eb, sids, what):
    import numpy as np
    import torch
    for sid in sids:
        sa, sb = ea.store.get(sid), eb.store.get(sid)
        if sa.mode != sb.mode or not np.array_equal(sa.rows, sb.rows):
            raise RuntimeError(f"{what}: mode or rows of {sid} differ")
        for la, lb in zip(sa.state, sb.state, strict=True):
            for x, y in zip(la, lb, strict=True):
                if x.dtype != y.dtype or not torch.equal(x, y):
                    raise RuntimeError(f"{what}: carry of {sid} differs")


def _solo_pass(eng, stream, rows, length=None):
    """One pass of a whole beat on ``rows`` (no carry): (encoder states,
    the decoder's hidden sequence or None)."""
    import torch
    from repro_torch.core import autoencoder as ae, classifier as clf
    dev = eng.device
    x = torch.from_numpy(stream[None]).to(dev).repeat(len(rows), 1, 1)
    rows = torch.as_tensor(rows.astype("int64"), device=dev)
    lengths = torch.full((len(rows),), stream.shape[0], dtype=torch.int32,
                         device=dev)
    kw = dict(backend=eng.backend, lengths=lengths, return_state=True,
              device=dev)
    if eng.kind == "classifier":
        _, states = clf.apply(eng.params, x, rows, eng.cfg, **kw)
        return states, None
    *_, dec, states = ae.apply(eng.params, x, rows, eng.cfg,
                               return_decoded=True, **kw)
    return states, dec


def _student_checks(eng, streams, plans, sids, modes, last):
    """Chunked == unchunked for every session (its carry against one pass
    of its whole beat on its rows), each student's carry against a solo
    deterministic pass, each student's last summary against the heads on
    that pass.  Returns the largest head distance and whether every
    summary was bitwise."""
    import torch
    from repro_torch.core import distill
    worst, bitwise = 0.0, True
    for i, (sid, mode) in enumerate(zip(sids, modes)):
        sess = eng.store.get(sid)
        states, dec = _solo_pass(eng, streams[i], sess.rows)
        for li, (lp, lw) in enumerate(zip(sess.state, states, strict=True)):
            for part, whole in zip(lp, lw, strict=True):
                if not torch.equal(part, whole):
                    raise RuntimeError(f"5e: {sid}'s carry is not its "
                                       f"unchunked pass (layer {li})")
        if mode != "student":
            continue
        if eng.kind == "classifier":
            want = distill.classifier_student_summary(eng.student,
                                                      states[-1][0])
        else:
            L = int(plans[i, -1])
            want = distill.autoencoder_student_summary(
                eng.student, dec[:, :L], eng.cfg.heteroscedastic)
        for g, w in zip(last[sid].summary, want, strict=True):
            worst = max(worst, max_abs_diff(g, w[0], f"5e head {sid}"))
            bitwise = bitwise and torch.equal(g, w[0])
    if worst > STUDENT_TOL:
        raise RuntimeError(f"5e: a student summary is {worst} from the "
                           "heads on its solo pass")
    return worst, bitwise


def _student_cell(k, report, dev, total):
    """One cell of phase 5e; returns its record."""
    import dataclasses as dc
    import numpy as np
    import torch
    from repro_torch.serve import Session, StreamingEngine, prewarm
    (key, cfg, params, per_layer, kernel, streams, plans, sids,
     modes) = _student_setup(k, dev)
    model, cell, backend = STUDENT_CELLS[k]
    seq = backend == "cuda_seq"
    per_tick = ((lambda m: per_layer) if seq
                else (lambda m: per_layer * m.capacity))
    card = report["card"]
    student, rec, counts = _distill(model, cfg, params, backend, dev)
    # The teacher pass and the features' pass, each one launch a layer (a
    # time step on cuda_step).
    passes = 2 * (1 if seq else T_BEAT)
    _check_launches(f"5e {key} distillation", counts, [], kernel,
                    lambda m: 0, want=per_layer * passes)
    for name, v in counts.items():
        total[name] += v
    kw = dict(backend=backend, max_sessions=SESSIONS, chunk_capacity=CHUNK,
              device=dev)

    def engine(**extra):
        eng = StreamingEngine(params, cfg, **kw, **extra)
        prewarm(eng)
        return eng

    def counted(counts, metrics, what):
        _check_launches(f"5e {key} {what}", counts, metrics, kernel,
                        per_tick)
        for name, v in counts.items():
            total[name] += v

    # Serve: students and MC sessions co-batched, against an all-MC engine
    # with the same MC sessions on the same rows, ticks in turns.
    mixed = engine(student=student)
    for sid, mode in zip(sids, modes):
        mixed.open_session(sid, mode=mode)
    mc = [sid for sid, mode in zip(sids, modes) if mode == "mc"]
    alone = engine()
    for sid in mc:
        sess = mixed.store.get(sid)
        alone.attach_session(Session(sid=sid, rows=sess.rows.copy(),
                                     seed=sess.seed))
    field = "mutual_information" if model == "classifier" else "epistemic"
    students = [sid for sid, mode in zip(sids, modes) if mode == "student"]
    serve_counts = {name: 0 for name in ALL_KERNELS}
    last, served = {}, []
    for t in range(DURABLE_TICKS):
        reset_launches()
        res = _student_step(mixed, streams, plans, sids, t)
        for name, v in read_launches().items():
            serve_counts[name] += v
        _same_results(res, _student_step(alone, streams, plans, sids, t),
                      mc, f"5e {key} tick {t} MC beside students")
        last.update(res)
        served.append(torch.stack([getattr(res[sid].summary, field)
                                   .float().mean() for sid in students]))
    counted(serve_counts, mixed.metrics, "co-batched")
    _same_carries(mixed, alone, mc, f"5e {key} MC beside students")
    head_err, head_bitwise = _student_checks(mixed, streams, plans, sids,
                                             modes, last)
    if [m.launches for m in mixed.metrics] != \
            [m.launches for m in alone.metrics]:
        raise RuntimeError(f"5e {key}: students changed the launches")

    # Escalate: a threshold some students cross and some do not (the
    # median of the students' largest predicted uncertainty over the run).
    peak = torch.stack(served).amax(0).cpu().numpy()
    threshold = float(np.median(peak))
    esc = engine(student=student, student_escalate_threshold=threshold)
    for sid, mode in zip(sids, modes):
        esc.open_session(sid, mode=mode)
    twin = engine()
    for sid in mc:
        sess = esc.store.get(sid)
        twin.attach_session(Session(sid=sid, rows=sess.rows.copy(),
                                    seed=sess.seed))
    path = os.path.join(ROOT, "build", "phase5e", f"cell{k}")
    shutil.rmtree(path, ignore_errors=True)
    esc_counts = {name: 0 for name in ALL_KERNELS}
    esc_ticks, escalated = [], []
    for t in range(DURABLE_TICKS):
        if t == STUDENT_KILL_TICK:
            if esc.admit("e-queued", mode="student") is not None:
                raise RuntimeError("5e: a student ticket went live on a "
                                   "full store")
            t0 = time.perf_counter()
            esc.snapshot(path)
            snapshot_s = time.perf_counter() - t0
        before = {sid: esc.store.get(sid).mode for sid in sids}
        reset_launches()
        res = _student_step(esc, streams, plans, sids, t)
        for name, v in read_launches().items():
            esc_counts[name] += v
        esc_ticks.append(res)
        _same_results(res, _student_step(twin, streams, plans, sids, t),
                      list(twin.active_sessions),
                      f"5e {key} tick {t} escalated and MC vs twins")
        for sid in sids:
            sess = esc.store.get(sid)
            if before[sid] == "student" and sess.mode == "mc":
                escalated.append((t, sid))
                twin.attach_session(dc.replace(
                    sess, rows=sess.rows.copy(),
                    state=[tuple(p.clone() for p in layer)
                           for layer in sess.state]))
    counted(esc_counts, esc.metrics, "escalating")
    _same_carries(esc, twin, list(twin.active_sessions),
                  f"5e {key} escalated and MC vs twins")
    n_stu = len(students)
    if not 0 < len(escalated) < n_stu or \
            sum(m.escalations for m in esc.metrics) != len(escalated):
        raise RuntimeError(f"5e {key}: {len(escalated)} of {n_stu} students "
                           "escalated; some, not all, wanted")

    # Kill -> snapshot -> restore with students live and a queued student
    # ticket: a fresh prewarmed engine serves the rest bit-equal.
    revived = engine(student=student, student_escalate_threshold=threshold)
    t0 = time.perf_counter()
    revived.restore(path)
    restore_s = time.perf_counter() - t0
    waiting = revived.queue.waiting()
    if [(w.sid, w.mode) for w in waiting] != [("e-queued", "student")] or \
            sum(revived.store.get(sid).mode == "student" for sid in sids) \
            == 0:
        raise RuntimeError("5e: the restored wait-list or modes are wrong")
    reset_launches()
    for t in range(STUDENT_KILL_TICK, DURABLE_TICKS):
        _same_results(_student_step(revived, streams, plans, sids, t),
                      esc_ticks[t], sids, f"5e {key} restored tick {t}")
    counted(read_launches(), revived.metrics, "restored")
    _same_carries(revived, esc, sids, f"5e {key} restored")
    if any(m.compiles for m in revived.metrics):
        raise RuntimeError("5e: the restored engine captured a graph")
    shutil.rmtree(path, ignore_errors=True)

    stats = {side: _serve_stats(eng.metrics, card)
             for side, eng in (("co_batched", mixed), ("all_mc", alone))}
    for side in stats:
        stats[side].pop("tick_ms")
    m0 = mixed.metrics[0]
    rec.update({
        "card": card, "sessions": SESSIONS, "students": n_stu, "chains": S,
        "tick_ms_p50": stats["co_batched"]["tick_ms_p50"],
        "tick_ms_p95": stats["co_batched"]["tick_ms_p95"],
        "all_mc_tick_ms_p50": stats["all_mc"]["tick_ms_p50"],
        "all_mc_tick_ms_p95": stats["all_mc"]["tick_ms_p95"],
        "student_rows": [m.student_rows for m in mixed.metrics],
        "device_rows_per_tick": m0.batch_rows,
        "live_rows_per_tick": m0.live_rows,
        "all_mc_live_rows_per_tick": alone.metrics[0].live_rows,
        "part_ms_p50": {side: {part: float(np.percentile(
            [m.parts_s[part] for m in eng.metrics], 50)) * 1e3
            for part in eng.metrics[0].parts_s}
            for side, eng in (("co_batched", mixed), ("all_mc", alone))},
        "student_part_ms_p50": float(np.percentile(
            [m.parts_s["student"] for m in mixed.metrics], 50)) * 1e3,
        "escalate_part_ms_p50": float(np.percentile(
            [m.parts_s["escalate"] for m in esc.metrics], 50)) * 1e3,
        "threshold": threshold, "escalations": len(escalated),
        "escalation_ticks": sorted({t for t, _ in escalated}),
        "launches_per_tick": [m.launches for m in mixed.metrics],
        "head_vs_solo_max_abs": head_err, "head_vs_solo_bitwise":
            head_bitwise,
        "snapshot_ms": snapshot_s * 1e3, "restore_ms": restore_s * 1e3})
    return key, rec


def _distill_fixture(report, dev, total):
    """``tests/fixtures/snapshots/distill_v1`` (H 8, NL 2, S 2, seed 3,
    YN) restored into an engine with student heads and served one tick;
    an engine without heads refuses it."""
    import numpy as np
    import torch
    from repro_torch.core import classifier as clf, distill, mcd
    from repro_torch.serve import StreamingEngine
    cfg = clf.ClassifierConfig(
        hidden=8, num_layers=2, mcd=mcd.MCDConfig(
            p=0.125, placement="YN", n_samples=2, seed=3))
    params = clf.init(torch.Generator().manual_seed(0), cfg, device=dev)
    heads = distill.init_student(torch.Generator().manual_seed(1), cfg,
                                 params, device=dev)
    path = os.path.join(ROOT, "tests", "fixtures", "snapshots", "distill_v1")
    try:
        StreamingEngine(params, cfg, device=dev).restore(path)
    except ValueError as err:
        if "student" not in str(err):
            raise
    else:
        raise RuntimeError("5e: distill_v1 restored without heads")
    eng = StreamingEngine(params, cfg, backend="cuda_seq",
                          chunk_capacity=CHUNK, student=heads, device=dev)
    eng.restore(path)
    reset_launches()
    x = np.ones((3, 1), np.float32)
    out = eng.step({"ward_2": x, "ward_1": x})
    counts = read_launches()
    m = eng.last_metrics
    _check_launches("5e distill_v1", counts, [m], "mcd_lstm_seq",
                    lambda m: cfg.num_layers)
    for name, v in counts.items():
        total[name] += v
    for sid, r in out.items():
        for v in r.summary:
            max_abs_diff(v, v, f"5e distill_v1 {sid}")
    if (m.student_rows, out["ward_2"].steps_total,
            eng.store.get("ward_2").mode) != (1, 10, "student"):
        raise RuntimeError(f"5e: distill_v1 served {m.student_rows} student "
                           f"rows, ward_2 at {out['ward_2'].steps_total}")
    return {"student_rows": m.student_rows,
            "queued": [(t.sid, t.mode) for t in eng.queue.waiting()],
            "tick_ms": m.duration_s * 1e3}


def student_phase(report, dev):
    """Phase 5e: distilled students on STUDENT_CELLS (the classifier LSTM
    on ``cuda_seq``, the autoencoder GRU on ``cuda_step``; fp32, S = 30,
    capacity 20, graphs).  Each cell distils heads from the MC teacher on
    64 ECG5000 beats (one 1920-row teacher launch a layer, held within
    TEACHER_TOL of the reference backend; DISTILL_STEPS head steps; the
    loss falls), then serves 32 students and 32 MC sessions co-batched
    over whole beats in 12 ragged chunks: the launches of an all-MC tick,
    every MC summary and carry bit-equal to an all-MC engine serving the
    same MC sessions on the same rows (ticks in turns), chunked ==
    unchunked, each student's carry a solo deterministic pass and its
    summary within STUDENT_TOL of the heads on it.  Then with a threshold
    some students cross: every MC and escalated session bit-equal to an
    all-MC twin engine (escalated sessions attached there with their
    regrown rows and carry), a student ticket queued on the full store,
    a snapshot, and a fresh prewarmed engine that restores it and serves
    the rest bit-equal.  Last, ``distill_v1`` restores and serves one
    tick with heads, and is refused without."""
    total = {name: 0 for name in ALL_KERNELS}
    out = {}
    for k in range(len(STUDENT_CELLS)):
        key, rec = _student_cell(k, report, dev, total)
        out[key] = rec
        print(f"students {key} " + json.dumps(rec), flush=True)
    out["distill_v1"] = _distill_fixture(report, dev, total)
    print("students distill_v1 " + json.dumps(out["distill_v1"]),
          flush=True)
    shutil.rmtree(os.path.join(ROOT, "build", "phase5e"),
                  ignore_errors=True)
    report["students"] = out
    return total


# -- phase 5f: the multi-tenant fleet -----------------------------------------

# (tenant, model, cell, precision, backend, S, weight, max_sessions), each
# at capacity CHUNK; ward_lite shares ward's params object (one group).
FLEET_TENANTS = (
    ("ward", "classifier", "lstm", None, "cuda_seq", S, 3.0, 32),
    ("ward_lite", "classifier", "lstm", None, "cuda_seq", 10, 1.0, 16),
    ("anom", "autoencoder", "gru", "int4", "cuda_seq", S, 2.0, 24),
    ("night", "classifier", "gru", "bf16", "cuda_step", S, 1.0, 16))
FLEET_ADMIT = 16       # admit_per_tick: the weighted-fair queue binds
FLEET_STREAMS = 1.5    # streams a tenant submits, per row of max_sessions
FLEET_TICKS = 12       # every beat in 12 ragged chunks
FLEET_KILL_TICK = 8    # fleet ticks served before the snapshot
FLEET_SHRINK = 8       # ward's S after reconfigure_tenant


def _fleet_specs(dev):
    """The TenantSpecs of FLEET_TENANTS and each tenant's (model, layer
    launches a tick at T = 1, kernel)."""
    from repro_torch.serve import TenantSpec
    models, specs, info = {}, [], {}
    for name, model, cell, prec, backend, s, w, cap in FLEET_TENANTS:
        if (model, cell) not in models:
            models[model, cell] = ecg_model(model, cell, dev)
        cfg, params, per_layer = models[model, cell]
        specs.append(TenantSpec(
            name=name, cfg=cfg, params=params, weight=w, n_samples=s,
            precision=prec, backend=backend, max_sessions=cap,
            chunk_capacity=CHUNK))
        info[name] = (model, per_layer,
                      f"mcd_{cell}_{backend.removeprefix('cuda_')}")
    return specs, info


def _fleet(dev):
    """A fresh fleet of FLEET_TENANTS, every group engine prewarmed;
    (fleet, prewarm seconds)."""
    from repro_torch.serve import FleetEngine, prewarm
    specs, _ = _fleet_specs(dev)
    fleet = FleetEngine(specs, admit_per_tick=FLEET_ADMIT, max_pending=512,
                        device=dev)
    t0 = time.perf_counter()
    for g in fleet.groups.values():
        prewarm(g.engine)
    return fleet, time.perf_counter() - t0


def _fleet_load(dev):
    """Per tenant: its streams (whole synthetic ECG5000 beats) and their
    chunk plans [streams, FLEET_TICKS]."""
    import numpy as np
    from repro_torch.launch.stream import build_streams
    streams, plans = {}, {}
    for k, (name, *_, cap) in enumerate(FLEET_TENANTS):
        n = int(cap * FLEET_STREAMS)
        streams[name], _ = build_streams(n, 1, seed=30 + k)
        if any(len(s) != T_BEAT for s in streams[name]):
            raise RuntimeError("ECG beats are not 140 steps long")
        plans[name] = chunk_plans(np.random.default_rng(40 + k), n,
                                  FLEET_TICKS)
    return streams, plans


class _FleetRun:
    """One fleet driven over the load: every live session its next planned
    chunk a tick, a session closed once its beat ends (its final Session
    kept), the launches of the fleet's ticks summed (reset before and read
    after each ``step``), host seconds of each synced fleet tick and of
    its group ticks."""

    def __init__(self, fleet, streams, plans):
        self.fleet, self.streams, self.plans = fleet, streams, plans
        self.counts = {name: 0 for name in ALL_KERNELS}
        self.ticks, self.closed = {}, {}
        self.tick_s, self.group_s = [], []

    def chunks(self):
        out = {}
        for tenant, sids in self.fleet.active_sessions.items():
            store = self.fleet.group_of(tenant).engine.store
            for sid in sids:
                sess, i = store.get(f"{tenant}/{sid}"), int(sid[1:])
                out.setdefault(tenant, {})[sid] = self.streams[tenant][i][
                    sess.steps:][:self.plans[tenant][i, sess.chunks]]
        return out

    def step(self):
        import torch
        fleet = self.fleet
        chunks = self.chunks()
        before = {g: e.engine.tick for g, e in fleet.groups.items()}
        tick = fleet.tick
        reset_launches()
        t0 = time.perf_counter()
        res = fleet.step(chunks)
        torch.cuda.synchronize()
        self.tick_s.append(time.perf_counter() - t0)
        for name, v in read_launches().items():
            self.counts[name] += v
        self.group_s.append(sum(
            g.engine.last_metrics.duration_s
            for name, g in fleet.groups.items()
            if g.engine.tick != before.get(name, g.engine.tick)))
        self.ticks[tick] = res
        done = []
        for tenant, sids in fleet.active_sessions.items():
            store = fleet.group_of(tenant).engine.store
            for sid in sids:
                if store.get(f"{tenant}/{sid}").steps >= T_BEAT:
                    self.closed[tenant, sid] = fleet.close(tenant, sid)
                    done.append((tenant, sid))
        return chunks, res, done

    def busy(self) -> bool:
        return any(self.fleet.active_sessions.values()) or \
            len(self.fleet.queue) > 0


def _admit_all(fleet, streams):
    for tenant, ss in streams.items():
        for i in range(len(ss)):
            if fleet.admit(tenant, f"s{i}") is not None:
                raise RuntimeError("5f: a rate-limited admit went live")


def _fleet_launch_check(what, run, info):
    """Each group tick launched what its solo tick launches (one launch a
    layer on ``cuda_seq``, one a layer a step on ``cuda_step``), and the
    fleet's ticks launched the sum of its groups' ticks, nothing else."""
    want = {name: 0 for name in ALL_KERNELS}
    for g in run.fleet.groups.values():
        _, per_layer, kernel = info[g.tenants[0]]
        seq = kernel.endswith("_seq")
        for m in g.engine.metrics:
            n = per_layer if seq else per_layer * m.capacity
            if m.launches != n:
                raise RuntimeError(f"{what}: group {g.name} tick {m.tick} "
                                   f"launched {m.launches}, not {n}")
            want[kernel] += n
    if want != run.counts:
        raise RuntimeError(f"{what}: launches {run.counts}, want {want}")


def _fleet_same(a, b, what):
    """Two results of one (tenant, sid): summaries bit for bit."""
    import torch
    for x, y in zip(a.summary, b.summary, strict=True):
        max_abs_diff(x, y, what)
        if x.dtype != y.dtype or not torch.equal(x, y):
            raise RuntimeError(f"{what}: summaries differ")


def _fleet_same_session(a, b, what, rows=None):
    """Two final Sessions: rows and carries bit for bit (``rows``: the
    first ``rows`` chains of ``b``)."""
    import numpy as np
    import torch
    n = len(b.rows) if rows is None else rows
    if not np.array_equal(a.rows, b.rows[:n]):
        raise RuntimeError(f"{what}: rows differ")
    for la, lb in zip(a.state, b.state, strict=True):
        for x, y in zip(la, lb, strict=True):
            if x.dtype != y.dtype or not torch.equal(x, y[:n]):
                raise RuntimeError(f"{what}: carries differ")


def _fleet_unchunked(run, dev):
    """Every closed session's carry against one pass over its whole beat
    on its rows (a batch a tenant; not counted)."""
    import numpy as np
    import torch
    from repro_torch.core import autoencoder as ae, classifier as clf
    fleet = run.fleet
    for tenant, spec in fleet.specs.items():
        keys = [k for k in run.closed if k[0] == tenant]
        sess = [run.closed[k] for k in keys]
        x = torch.from_numpy(np.concatenate([np.repeat(
            run.streams[tenant][int(sid[1:])][None], len(s.rows), 0)
            for (_, sid), s in zip(keys, sess)])).to(dev)
        rows = torch.from_numpy(np.concatenate(
            [s.rows for s in sess]).astype(np.int64)).to(dev)
        kw = dict(backend=spec.backend, return_state=True,
                  lengths=torch.full((len(rows),), T_BEAT, device=dev),
                  precision=spec.precision, device=dev)
        mod = clf if isinstance(spec.cfg, clf.ClassifierConfig) else ae
        *_, states = mod.apply(spec.params, x, rows, spec.resolved_cfg(),
                               **kw)
        off = 0
        for (_, sid), s in zip(keys, sess):
            n = len(s.rows)
            for li, layer in enumerate(states):
                for part, whole in zip(s.state[li], layer, strict=True):
                    if not torch.equal(part, whole[off:off + n]):
                        raise RuntimeError(f"5f: {tenant}/{sid} chunked != "
                                           f"unchunked (layer {li})")
            off += n
    return len(run.closed)


def _fleet_solo(fleet, dev):
    """Per tenant an engine of its own (its spec, capacity CHUNK),
    prewarmed."""
    from repro_torch.serve import StreamingEngine, prewarm
    solo = {}
    for name, spec in fleet.specs.items():
        eng = StreamingEngine(spec.params, spec.resolved_cfg(),
                              backend=spec.backend,
                              max_sessions=spec.max_sessions,
                              chunk_capacity=CHUNK,
                              precision=spec.precision, device=dev)
        prewarm(eng)
        solo[name] = eng
    return solo


def _fleet_mirror(fleet, solo, evicted, chunks, res, done):
    """The solo engines follow the fleet tick just served: each takes the
    tenant's sessions that went live (fresh on the same rows, or its own
    evicted carry), serves the tenant's chunks, and must give the fleet's
    summaries; the sessions the fleet closed close there too."""
    from repro_torch.serve import Session
    for tenant, eng in solo.items():
        for sess in fleet.sessions_of(tenant):
            if sess.sid not in eng.store:
                eng.attach_session(evicted.pop(sess.sid, None) or Session(
                    sid=sess.sid, rows=sess.rows.copy(), seed=sess.seed))
        tchunks = chunks.get(tenant)
        if not tchunks:
            continue
        got = eng.step({f"{tenant}/{s}": c for s, c in tchunks.items()})
        for sid in tchunks:
            _fleet_same(res[tenant][sid], got[f"{tenant}/{sid}"],
                        f"5f {tenant}/{sid} fleet vs solo, tick "
                        f"{fleet.tick - 1}")
    for tenant, sid in done:
        gsid = f"{tenant}/{sid}"
        evicted[gsid] = solo[tenant].store.evict(gsid)


def _fleet_fixture(dev, counts):
    """``tests/fixtures/snapshots/fleet_v1`` (H 8, NL 2, S 2, seed 3, YN;
    tenants ward and anom on one params object) restored into a fleet on
    ``cuda_seq`` and served one tick."""
    import numpy as np
    import torch
    from repro_torch.core import classifier as clf, mcd
    from repro_torch.serve import FleetEngine, TenantSpec
    cfg = clf.ClassifierConfig(hidden=8, num_layers=2, mcd=mcd.MCDConfig(
        p=0.125, placement="YN", n_samples=2, seed=3))
    params = clf.init(torch.Generator().manual_seed(0), cfg, device=dev)
    fleet = FleetEngine([TenantSpec(name=n, cfg=cfg, params=params,
                                    max_sessions=4, chunk_capacity=CHUNK)
                         for n in ("ward", "anom")], device=dev)
    fleet.restore(os.path.join(ROOT, "tests", "fixtures", "snapshots",
                               "fleet_v1"))
    queued = [(t.tenant, t.sid) for t in fleet.queue.waiting()]
    reset_launches()
    out = fleet.step({"ward": {"p1": np.ones((3, 1), np.float32)}})
    got = read_launches()
    _check_launches("5f fleet_v1", got, fleet.groups["g0"].engine.metrics,
                    "mcd_lstm_seq", lambda m: cfg.num_layers)
    for name, v in got.items():
        counts[name] += v
    if out["ward"]["p1"].steps_total != 10 or \
            queued != [("ward", "ward/p2")]:
        raise RuntimeError(f"5f: fleet_v1 served "
                           f"{out['ward']['p1'].steps_total} steps, "
                           f"queue {queued}")
    for v in out["ward"]["p1"].summary:
        max_abs_diff(v, v, "5f fleet_v1")
    return {"tick": fleet.tick, "launches": got["mcd_lstm_seq"],
            "tick_ms": fleet.metrics[-1].duration_s * 1e3}


def fleet_phase(report, dev):
    """Phase 5f: the multi-tenant fleet at the ECG models' full width:
    FLEET_TENANTS (ward: clf LSTM fp32 ``cuda_seq`` S 30; ward_lite: the
    same params at S 10, one group with ward; anom: AE GRU int4
    ``cuda_seq``; night: clf GRU bf16 ``cuda_step``), each submitting 1.5x
    its max_sessions streams of one whole beat in 12 ragged chunks,
    FLEET_ADMIT admissions a tick, every group engine prewarmed.  Checks:
    three groups; each group tick launches what a solo tick launches; no
    capture after prewarm; every tenant's summaries (every tick) and
    final carries bit-equal to a prewarmed engine of its own on the same
    rows, ticked in turns with the fleet; chunked == unchunked; the first
    tick's admissions split by the weights and every stream admitted;
    kill -> snapshot -> restore mid-stream (a queued fresh ticket and a
    queued re-attach) into a fresh prewarmed fleet, bit-equal to the
    uninterrupted fleet; ``reconfigure_tenant("ward", S 8)`` once the
    queue is empty: the other tenants bit-unmoved, ward's kept chains
    equal to the first 8 rows, the first tick after the swap recorded;
    ``fleet_v1`` restored and served.  Records the fleet tick p50 / p95
    against the sum of the solo engines' tick p50s (in turns), the
    group ticks inside the fleet tick, per-tenant p95 / queue wait /
    drops, snapshot and restore ms."""
    from repro_torch.serve import ServingConfig
    from repro_torch.serve.scheduler import percentile
    card = report["card"]
    streams, plans = _fleet_load(dev)
    _, info = _fleet_specs(dev)
    path = os.path.join(ROOT, "build", "phase5f")
    shutil.rmtree(path, ignore_errors=True)
    total = {name: 0 for name in ALL_KERNELS}

    # The uninterrupted fleet, each tenant mirrored by a solo engine.
    fleet, prewarm_s = _fleet(dev)
    if len(fleet.groups) != 3 or fleet.group_of("ward") is not \
            fleet.group_of("ward_lite"):
        raise RuntimeError("5f: groups " + str(
            [g.tenants for g in fleet.groups.values()]))
    solo, evicted = _fleet_solo(fleet, dev), {}
    _admit_all(fleet, streams)
    run = _FleetRun(fleet, streams, plans)
    admitted, reattach, snapshot_s = [], None, None
    queue_empty = None
    while run.busy():
        if fleet.tick == FLEET_KILL_TICK:
            live = fleet.active_sessions["ward"]
            reattach = live[0]
            gone = fleet.close("ward", reattach)
            evicted[f"ward/{reattach}"] = solo["ward"].store.evict(
                f"ward/{reattach}")
            fleet.admit("ward", reattach, session=gone)
            kinds = {t.session is not None for t in fleet.queue.waiting()}
            if kinds != {False, True}:
                raise RuntimeError("5f: the wait-list lacks a fresh ticket "
                                   "or the re-attach")
            t0 = time.perf_counter()
            fleet.snapshot(path)
            snapshot_s = time.perf_counter() - t0
        before = dict(fleet.queue.state()["admitted"])
        chunks, res, done = run.step()
        admitted.append({n: fleet.queue.state()["admitted"][n] - before[n]
                         for n in before})
        if queue_empty is None and fleet.tick > FLEET_KILL_TICK and \
                not len(fleet.queue):
            queue_empty = fleet.tick
        _fleet_mirror(fleet, solo, evicted, chunks, res, done)
    _fleet_launch_check("5f fleet", run, info)
    for name, v in run.counts.items():
        total[name] += v
    for gsid, sess in evicted.items():
        tenant, sid = gsid.split("/", 1)
        _fleet_same_session(run.closed[tenant, sid], sess,
                            f"5f {gsid} fleet vs solo carry")
    if any(m.compiles for g in fleet.groups.values()
           for m in g.engine.metrics):
        raise RuntimeError("5f: a group tick captured after prewarm")
    closed = _fleet_unchunked(run, dev)
    n_streams = {n: len(s) for n, s in streams.items()}
    ledger = fleet.queue.state()["admitted"]
    if ledger != {n: v + (n == "ward") for n, v in n_streams.items()} or \
            closed != sum(n_streams.values()):
        raise RuntimeError(f"5f: admitted {ledger}, closed {closed}")
    w = {name: spec.weight for name, spec in fleet.specs.items()}
    first = admitted[0]
    if sum(first.values()) != FLEET_ADMIT or any(
            abs(first[n] - FLEET_ADMIT * w[n] / sum(w.values())) > 1
            for n in w):
        raise RuntimeError(f"5f: the first drain admitted {first}")

    # Kill -> restore: a fresh prewarmed fleet from the snapshot.
    back, _ = _fleet(dev)
    t0 = time.perf_counter()
    back.restore(path)
    restore_s = time.perf_counter() - t0
    if back.tick != FLEET_KILL_TICK or \
            [(t.tenant, t.sid) for t in back.queue.waiting()][-1] != \
            ("ward", f"ward/{reattach}"):
        raise RuntimeError("5f: the restored fleet's tick or queue differ")
    again = _FleetRun(back, streams, plans)
    while again.busy():
        _, res, _ = again.step()
        for tenant, rs in res.items():
            for sid, r in rs.items():
                _fleet_same(r, run.ticks[back.tick - 1][tenant][sid],
                            f"5f restored {tenant}/{sid}")
    _fleet_launch_check("5f restored", again, info)
    for name, v in again.counts.items():
        total[name] += v
    for key, sess in again.closed.items():
        _fleet_same_session(sess, run.closed[key], f"5f restored {key}")
    if any(m.compiles for g in back.groups.values()
           for m in g.engine.metrics):
        raise RuntimeError("5f: the restored fleet captured a graph")

    # reconfigure_tenant("ward", S 8) once the queue is empty, mid-stream.
    swap, _ = _fleet(dev)
    swap.restore(path)
    moved = _FleetRun(swap, streams, plans)
    while swap.tick < queue_empty:
        moved.step()
    kept = set(swap.active_sessions["ward"])
    if not any(0 < swap.group_of("ward").engine.store.get(
            f"ward/{s}").steps < T_BEAT for s in kept):
        raise RuntimeError("5f: no ward session mid-beat at the swap")
    new = swap.reconfigure_tenant("ward",
                                  ServingConfig(n_samples=FLEET_SHRINK))
    while moved.busy():
        _, res, _ = moved.step()
        for tenant, rs in res.items():
            if tenant == "ward":
                continue
            for sid, r in rs.items():
                _fleet_same(r, run.ticks[swap.tick - 1][tenant][sid],
                            f"5f {tenant}/{sid} after the swap")
    _fleet_launch_check("5f reconfigured", moved, info)
    for name, v in moved.counts.items():
        total[name] += v
    for key, sess in moved.closed.items():
        if key[0] != "ward":
            _fleet_same_session(sess, run.closed[key], f"5f swap {key}")
        elif key[1] in kept:
            _fleet_same_session(sess, run.closed[key], f"5f kept {key}",
                                rows=FLEET_SHRINK)
    if new.n_samples != FLEET_SHRINK or len(swap.groups) != 4:
        raise RuntimeError("5f: the reconfigured fleet is not as planned")
    first_swap = new.metrics[0]

    fixture = _fleet_fixture(dev, total)
    shutil.rmtree(path, ignore_errors=True)

    tick_ms = [t * 1e3 for t in run.tick_s]
    over_ms = [(t - g) * 1e3 for t, g in zip(run.tick_s, run.group_s)]
    solo_p50 = {n: percentile([m.duration_s for m in e.metrics], 50) * 1e3
                for n, e in solo.items()}
    tenants = fleet.summarize()["tenants"]
    rec = {
        "card": card, "tenants": {
            n: {"S": fleet._resolved_s(n), "weight": w[n],
                "max_sessions": fleet.specs[n].max_sessions,
                "streams": n_streams[n],
                "group": fleet._tenant_group[n],
                "tick_ms_p95": tenants[n]["duration_s_p95"] * 1e3,
                "queue_wait_ms_p95": tenants[n]["queue_wait_s_p95"] * 1e3,
                "dropped": tenants[n]["dropped"],
                "records": tenants[n]["ticks"],
                "solo_tick_ms_p50": solo_p50[n]} for n in w},
        "groups": {g.name: g.tenants for g in fleet.groups.values()},
        "ticks": len(tick_ms), "prewarm_s": prewarm_s,
        "fleet_tick_ms_p50": percentile(tick_ms, 50),
        "fleet_tick_ms_p95": percentile(tick_ms, 95),
        "group_ticks_ms_p50": percentile([g * 1e3 for g in run.group_s],
                                         50),
        "fleet_layer_ms_p50": percentile(over_ms, 50),
        "fleet_layer_ms_p95": percentile(over_ms, 95),
        "solo_tick_ms_p50_sum": sum(solo_p50.values()),
        "admitted_per_tick": admitted[:4], "kill_tick": FLEET_KILL_TICK,
        "snapshot_ms": snapshot_s * 1e3, "restore_ms": restore_s * 1e3,
        "swap_tick": queue_empty, "swap_kept_sessions": len(kept),
        "first_tick_after_swap": {"ms": first_swap.duration_s * 1e3,
                                  "compiles": first_swap.compiles},
        "launches": {k: v for k, v in total.items() if v},
        "fleet_v1": fixture, "closed_sessions": closed}
    report["fleet"] = rec
    print("fleet " + json.dumps(rec), flush=True)
    return total


# -- the co-design loop -------------------------------------------------------

CAL_SESSIONS = (8, 16, 32, 64)   # max_sessions of the calibration engines
CAL_BOUNDS = (8, 16, CHUNK)      # chunk-length bounds, one a block of ticks
CAL_BLOCK = 12         # ticks a block: each (sessions, rung) pair recurs
CAL_CYCLES = 2
CAL_BEATS = 8          # a calibration stream's beats (1120 steps)
CTRL_WARM = 8          # ticks served before the warm-up window
CTRL_WINDOW = 32       # the warm-up window, and the controller's window
CTRL_TICKS = 24        # ticks served with the controller attached
CTRL_QUEUED = 8        # fresh tickets waiting behind the live sessions
CTRL_BEATS = 10        # a controlled stream's beats (1400 steps)
CTRL_SLO = 0.6         # the SLO: this share of the warm-up window's p95
CTRL_FLOOR = 8         # the SLO's uncertainty floor (min_samples)
CTRL_FLEET_ROWS = 32   # max_sessions of each 5g fleet tenant


def _ctrl_engine(cfg, params, dev, n, **kw):
    """The classifier LSTM on ``cuda_seq`` at ``n`` sessions, capacity
    "auto" over pow2_ladder(CHUNK), prewarmed."""
    from repro_torch.serve import StreamingEngine, pow2_ladder, prewarm
    eng = StreamingEngine(params, cfg, backend="cuda_seq", max_sessions=n,
                          chunk_capacity="auto", ladder=pow2_ladder(CHUNK),
                          device=dev, **kw)
    prewarm(eng)
    return eng


def _ctrl_chunks(eng, streams, sids, rng, bound=CHUNK):
    """Each live session of ``sids`` its next ragged chunk of 1..bound
    steps (the first exactly ``bound``, so the tick's rung follows it)."""
    lens = rng.integers(1, bound + 1, size=len(sids))
    lens[0] = bound
    out = {}
    for k, sid in enumerate(sids):
        if sid in eng.store:
            pos = eng.store.get(sid).steps
            out[sid] = streams[k][pos:pos + int(lens[k])]
    return out


def _ctrl_step(eng, chunks, counts):
    """One counted engine tick (launches added to ``counts``), synced."""
    import torch
    reset_launches()
    res = eng.step(chunks)
    torch.cuda.synchronize()
    for name, v in read_launches().items():
        counts[name] += v
    return res


def _ctrl_launch_check(what, metrics, per_tick, counts=None, want=None):
    """Each tick of ``metrics`` launched ``per_tick`` layer kernels; and
    ``counts`` (a call's launch counts) holds ``want`` launches of
    ``mcd_lstm_seq`` and nothing else."""
    bad = [m.tick for m in metrics if m.launches != per_tick]
    if bad:
        raise RuntimeError(f"5g {what}: ticks {bad} did not launch "
                           f"{per_tick} layer kernels")
    if counts is not None and (counts["mcd_lstm_seq"] != want
                               or sum(counts.values()) != want):
        raise RuntimeError(f"5g {what}: launches {counts}, {want} wanted")


def _fit_dict(fit):
    return None if fit is None else dataclasses.asdict(fit)


def _calibration(cfg, params, dev, counts, per_layer):
    """5g (a): the roofline calibrated on the card."""
    import numpy as np
    from repro_torch.dse import calibrate
    from repro_torch.launch.stream import build_streams
    from repro_torch.serve import CoDesignController
    from repro_torch.serve.scheduler import percentile
    rng = np.random.default_rng(50)
    pooled, fits, arch = [], {}, None
    for n in CAL_SESSIONS:
        eng = _ctrl_engine(cfg, params, dev, n)
        arch = CoDesignController._derive_arch(
            eng, CoDesignController._derive_config(eng))
        streams, _ = build_streams(n, CAL_BEATS, seed=50 + n)
        sids = [f"c{k}" for k in range(n)]
        for sid in sids:
            eng.open_session(sid)
        for _ in range(CAL_CYCLES):
            for bound in CAL_BOUNDS:
                for _ in range(CAL_BLOCK):
                    _ctrl_step(eng, _ctrl_chunks(eng, streams, sids, rng,
                                                 bound), counts)
        metrics = list(eng.metrics)
        _ctrl_launch_check(f"calibration at {n} sessions", metrics,
                           per_layer)
        if any(m.compiles for m in metrics):
            raise RuntimeError("5g: a calibration tick captured a graph")
        fits[n] = calibrate.fit_roofline(metrics, arch)
        pooled += metrics
    fit = calibrate.fit_roofline(pooled, arch)
    # The same window without each engine's first tick: how far that one
    # tick (the eager summaries' first run at a shape) moves the fit.
    steady = calibrate.fit_roofline([m for m in pooled if m.tick], arch)
    if fit is None or any(f is None for f in fits.values()):
        raise RuntimeError("5g: a calibration window gave no fit")
    shapes = {}
    for m in pooled:
        shapes.setdefault((m.batch_rows, m.capacity), []).append(
            m.duration_s)
    table = []
    for (rows, cap), durs in sorted(shapes.items()):
        raw = calibrate.tick_raw_seconds(arch, rows=rows, capacity=cap)
        table.append({"rows": rows, "capacity": cap, "ticks": len(durs),
                      "raw_us": raw * 1e6,
                      "observed_ms_p50": percentile(durs, 50) * 1e3,
                      "predicted_ms": fit.predict(raw) * 1e3})
    if min(t["ticks"] for t in table) < 2:
        raise RuntimeError(f"5g: a (sessions, rung) pair did not recur: "
                           f"{table}")
    first = [m.duration_s * 1e3 for m in pooled if not m.tick]
    return {"pooled": _fit_dict(fit),
            "by_sessions": {n: _fit_dict(f) for n, f in fits.items()},
            "pooled_without_first_ticks": _fit_dict(steady),
            "first_tick_ms": dict(zip(CAL_SESSIONS, first)),
            "max_tick_ms": max(m.duration_s for m in pooled) * 1e3,
            "shapes": table}


def _ctrl_same(got, want, what):
    import torch
    for sid, r in want.items():
        for x, y in zip(got[sid].summary, r.summary, strict=True):
            max_abs_diff(x, y, what)
            if x.dtype != y.dtype or not torch.equal(x, y):
                raise RuntimeError(f"5g {what}: {sid} differs")


def _twin(ctrl, cfg, params, dev, old):
    """A prewarmed ``cuda_seq`` engine at the controller's new config fed
    ``convert_session`` of the swap's pre-swap sessions (the old engine's
    scheduler window loaded, as the swap carries it)."""
    from repro_torch.serve import carry_dtypes, convert_session
    new = ctrl.last_swap["new_config"]
    twin = _ctrl_engine(dataclasses.replace(cfg, mcd=cfg.mcd.replace(
        n_samples=new.n_samples)), params, dev, old.max_sessions,
        precision=new.precision)
    twin._scheduler.load_state(old._scheduler.state())
    dts = carry_dtypes("lstm", new.precision, "cuda_seq")
    for sess in ctrl.last_swap["old_sessions"]:
        twin.attach_session(convert_session(
            sess, n_samples=new.n_samples, part_dtypes=dts))
    return twin


def _controlled(report, cfg, params, dev, counts, per_layer):
    """5g (b): the attached controller on the card."""
    import numpy as np
    import torch
    from repro_torch.launch.stream import build_streams
    from repro_torch.serve import (CoDesignController, JsonlSink, KnobSpace,
                                   SLOPolicy)
    from repro_torch.serve.scheduler import percentile
    n = SESSIONS
    eng = _ctrl_engine(cfg, params, dev, n)
    streams, _ = build_streams(n + CTRL_QUEUED, CTRL_BEATS, seed=60)
    sids = [f"k{k}" for k in range(n + CTRL_QUEUED)]
    for sid in sids[:n]:
        eng.open_session(sid)
    for k, sid in enumerate(sids[n:]):
        if eng.admit(sid, priority=k % 3) is not None:
            raise RuntimeError("5g: a ticket went live on a full store")
    drawn = {sid: set(eng.store.get(sid).rows.tolist()) for sid in sids[:n]}
    rng = np.random.default_rng(61)
    for _ in range(CTRL_WARM + CTRL_WINDOW):
        _ctrl_step(eng, _ctrl_chunks(eng, streams, sids, rng), counts)
    warm = [m.duration_s for m in eng.metrics][-CTRL_WINDOW:]
    warm_p95 = percentile(warm, 95)
    slo = SLOPolicy(p95_tick_s=CTRL_SLO * warm_p95, min_samples=CTRL_FLOOR)
    print(f"5g SLO: p95 <= {slo.p95_tick_s * 1e3:.3f} ms ({CTRL_SLO} x the "
          f"warm-up p95 {warm_p95 * 1e3:.3f} ms), S >= {CTRL_FLOOR}",
          flush=True)
    path = os.path.join(ROOT, "build", "phase5g", "decisions.jsonl")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if os.path.exists(path):
        os.remove(path)
    config = CoDesignController._derive_config(eng)
    ctrl = CoDesignController(
        eng, slo, knobs=KnobSpace.around(config, precisions=(None, "bf16")),
        decision_sink=JsonlSink(path), window=CTRL_WINDOW)
    twin, swaps = None, []
    for _ in range(CTRL_TICKS):
        cur = ctrl.engine
        chunks = _ctrl_chunks(cur, streams, sids, rng)
        res = _ctrl_step(cur, chunks, counts)
        if twin is not None:
            _ctrl_same(res, twin.step(chunks),
                          f"tick {cur.tick - 1} against the twin")
        queued = cur.queued_sessions
        rec = ctrl.maybe_reconfigure()
        if rec is None or not rec.applied:
            continue
        new = ctrl.engine
        if new.queued_sessions != queued or len(queued) != CTRL_QUEUED:
            raise RuntimeError(f"5g: the queue {queued} came back "
                               f"{new.queued_sessions}")
        if rec.winner["n_samples"] <= rec.current["n_samples"]:
            for sid in new.active_sessions:
                if not set(new.store.get(sid).rows.tolist()) <= drawn[sid]:
                    raise RuntimeError(f"5g: {sid} drew new rows in a "
                                       "downshift")
        twin = _twin(ctrl, cfg, params, dev, cur)
        swaps.append({"rec": rec, "seconds": ctrl.last_swap["seconds"]})
    ctrl.decision_sink.close()
    final = ctrl.engine
    if twin is not None:
        for sid in final.active_sessions:
            for la, lb in zip(final.store.get(sid).state,
                              twin.store.get(sid).state, strict=True):
                for x, y in zip(la, lb, strict=True):
                    if x.dtype != y.dtype or not torch.equal(x, y):
                        raise RuntimeError(f"5g: the final carry of {sid} "
                                           "differs from the twin's")
    decisions = ctrl.decisions
    with open(path) as fh:
        lines = [json.loads(line) for line in fh]
    if len(lines) != len(decisions) or [
            (x["tick"], x["reason"], x["applied"]) for x in lines] != [
            (r.tick, r.reason, r.applied) for r in decisions]:
        raise RuntimeError(f"5g: the decision trail has {len(lines)} lines "
                           f"for {len(decisions)} decisions")
    good = [s for s in swaps if s["rec"].reason == "slo-breach"
            and CTRL_FLOOR <= s["rec"].winner["n_samples"] < S]
    if not good:
        raise RuntimeError("5g: no applied slo-breach downshift to "
                           f"{CTRL_FLOOR} <= S < {S}: " + json.dumps(
                               [dataclasses.asdict(r) for r in decisions]))
    first = good[0]["rec"]
    post = [m for m in final.metrics if m.tick > first.tick]
    if any(m.compiles for m in post):
        raise RuntimeError("5g: a tick after the swap captured a graph")
    _ctrl_launch_check("controlled", list(final.metrics), per_layer)
    cool = [m.duration_s for m in post
            if m.tick <= first.tick + ctrl.cooldown_ticks]
    # Rows: close the live sessions one by one; each close drains a queued
    # ticket, whose fresh rows no session ever drew.
    old_rows = set().union(*drawn.values())
    for sid in list(final.active_sessions):
        final.close_session(sid)
    fresh = [final.store.get(sid).rows.tolist() for sid in sids[n:]]
    flat = [r for rows in fresh for r in rows]
    if len(set(flat)) != len(flat) or set(flat) & old_rows:
        raise RuntimeError("5g: a row was drawn twice")
    shutil.rmtree(os.path.dirname(path), ignore_errors=True)
    return {
        "sessions": n, "queued": CTRL_QUEUED, "warm_ticks": CTRL_WARM,
        "window": CTRL_WINDOW, "warm_p95_ms": warm_p95 * 1e3,
        "slo_p95_ms": slo.p95_tick_s * 1e3, "min_samples": CTRL_FLOOR,
        "decisions": [{"tick": r.tick, "reason": r.reason,
                       "applied": r.applied, "winner": r.winner,
                       "predicted_ms": (None if r.predicted_s is None
                                        else r.predicted_s * 1e3),
                       "observed_p95_ms": r.observed["duration_s_p95"] * 1e3,
                       "observed_p50_ms": r.observed["duration_s_p50"] * 1e3,
                       "fit": r.fit} for r in decisions],
        "swaps": [{"tick": s["rec"].tick,
                   "winner": s["rec"].winner,
                   "apply_ms": {k: v * 1e3 for k, v in s["seconds"].items()},
                   "apply_ms_total": sum(s["seconds"].values()) * 1e3}
                  for s in swaps],
        "first_swap": {
            "winner": first.winner, "reason": first.reason,
            "predicted_ms": first.predicted_s * 1e3, "fit": first.fit,
            "cooldown_ticks": len(cool),
            "observed_ms_p50": percentile(cool, 50) * 1e3,
            "observed_ms_p95": percentile(cool, 95) * 1e3,
            "slo_met": percentile(cool, 95) <= slo.p95_tick_s},
        "post_swap_compiles": sum(m.compiles for m in post),
        "trail_lines": len(lines), "rows_fresh": len(flat)}


def _fleet_controlled(cfg, params, dev, counts):
    """5g (c): a FleetController over two tenants on the card."""
    import numpy as np
    from repro_torch.launch.stream import build_streams
    from repro_torch.serve import (FleetController, FleetEngine, KnobSpace,
                                   ServingConfig, Session, SLOPolicy,
                                   StreamingEngine, TenantSpec, prewarm)
    from repro_torch.serve.scheduler import percentile
    gcfg, gparams, _ = ecg_model("classifier", "gru", dev)
    rows = CTRL_FLEET_ROWS
    fleet = FleetEngine([
        TenantSpec(name="ward", cfg=cfg, params=params, max_sessions=rows,
                   chunk_capacity=CHUNK),
        TenantSpec(name="night", cfg=gcfg, params=gparams,
                   max_sessions=rows, chunk_capacity=CHUNK,
                   precision="bf16", backend="cuda_step")], device=dev)
    for g in fleet.groups.values():
        prewarm(g.engine)
    night = fleet.group_of("night").engine
    solo = StreamingEngine(gparams, gcfg, backend="cuda_step",
                           max_sessions=rows, chunk_capacity=CHUNK,
                           precision="bf16", device=dev)
    prewarm(solo)
    streams = {t: build_streams(rows, CTRL_BEATS, seed=70 + k)[0]
               for k, t in enumerate(("ward", "night"))}
    sids = [f"s{k}" for k in range(rows)]
    for t in streams:
        for sid in sids:
            fleet.admit(t, sid)
    for sid in sids:
        sess = night.store.get(f"night/{sid}")
        solo.attach_session(Session(sid=sess.sid, rows=sess.rows.copy(),
                                    seed=sess.seed))
    rng = np.random.default_rng(71)

    def tick():
        import torch
        chunks = {}
        for t in streams:
            store = fleet.group_of(t).engine.store
            lens = rng.integers(1, CHUNK + 1, size=rows)
            chunks[t] = {sid: streams[t][k][
                store.get(f"{t}/{sid}").steps:][:int(lens[k])]
                for k, sid in enumerate(sids)}
        reset_launches()
        res = fleet.step(chunks)
        torch.cuda.synchronize()
        for name, v in read_launches().items():
            counts[name] += v
        want = solo.step({f"night/{s}": c
                          for s, c in chunks["night"].items()})
        _ctrl_same(res["night"], {s: want[f"night/{s}"]
                                     for s in chunks["night"]},
                      f"fleet tick {fleet.tick - 1}, night against solo")

    for _ in range(CTRL_WARM + CTRL_WINDOW):
        tick()
    warm = [m.duration_s for m in fleet.metrics
            if m.tenant == "ward"][-CTRL_WINDOW:]
    warm_p95 = percentile(warm, 95)
    slo = SLOPolicy(p95_tick_s=CTRL_SLO * warm_p95, min_samples=CTRL_FLOOR)
    fleet.specs["ward"] = dataclasses.replace(fleet.specs["ward"], slo=slo)
    config = ServingConfig(n_samples=S, chunk_capacity=CHUNK)
    ctrl = FleetController(fleet, knobs={"ward": KnobSpace.around(
        config, precisions=(None, "bf16"))}, window=CTRL_WINDOW)
    if set(ctrl.controllers) != {"ward"}:
        raise RuntimeError(f"5g: the fleet controller manages "
                           f"{sorted(ctrl.controllers)}")
    for _ in range(CTRL_TICKS):
        tick()
        ctrl.maybe_reconfigure()
    decisions = ctrl.decisions
    applied = [r for r in decisions if r.applied]
    if not applied or {r.tenant for r in decisions} != {"ward"}:
        raise RuntimeError("5g fleet: decisions " + json.dumps(
            [dataclasses.asdict(r) for r in decisions]))
    if fleet.group_of("night").engine is not night or \
            fleet.group_of("ward").engine.n_samples != \
            applied[-1].winner["n_samples"]:
        raise RuntimeError("5g fleet: the wrong tenant was reconfigured")
    ward = [m for m in fleet.metrics if m.tenant == "ward"
            and m.tick > applied[0].tick]
    if not ward or any(m.compiles for m in ward):
        raise RuntimeError("5g fleet: ward captured after its swap: "
                           f"{[m.compiles for m in ward]}")
    return {"rows": rows, "warm_p95_ms": warm_p95 * 1e3,
            "slo_p95_ms": slo.p95_tick_s * 1e3,
            "decisions": [{"tick": r.tick, "tenant": r.tenant,
                           "reason": r.reason, "applied": r.applied,
                           "winner": r.winner,
                           "predicted_ms": (None if r.predicted_s is None
                                            else r.predicted_s * 1e3),
                           "observed_p95_ms":
                               r.observed["duration_s_p95"] * 1e3}
                          for r in decisions],
            "ward_after_ms_p50": percentile([m.duration_s for m in ward],
                                            50) * 1e3,
            "ward_first_tick_after": {"ms": ward[0].duration_s * 1e3,
                                      "compiles": ward[0].compiles}
            if ward else None,
            "night_bit_equal_to_solo": True}


def _predict_cell(cfg, params, dev, counts):
    """5g (d): ``predict`` fold against scan at the classifier's width."""
    import numpy as np
    import torch
    from repro_torch.core import bayesian, classifier as clf
    from repro_torch.launch.stream import build_streams
    streams, _ = build_streams(SESSIONS, 1, seed=80)
    x = torch.from_numpy(np.stack(streams)).to(dev)

    def run(strategy, backend="cuda_seq"):
        return bayesian.predict(
            lambda p, xx, r: clf.apply(p, xx, r, cfg, backend=backend,
                                       device=dev),
            params, x, cfg.mcd, strategy=strategy)

    out, launches = {}, {}
    for strategy in ("fold", "scan"):
        reset_launches()
        out[strategy] = run(strategy)
        torch.cuda.synchronize()
        launches[strategy] = read_launches()
        for name, v in launches[strategy].items():
            counts[name] += v
    want = {"fold": cfg.num_layers, "scan": S * cfg.num_layers}
    for strategy, got in launches.items():
        _ctrl_launch_check(f"predict {strategy}", [], 0, got,
                           want[strategy])
    fold, scan = out["fold"], out["scan"]
    if fold.shape != (S, SESSIONS, cfg.num_classes) or \
            not torch.equal(fold, scan):
        raise RuntimeError("5g predict: fold and scan differ")
    ref = run("fold", "reference")
    err = {s: max_abs_diff(out[s], ref, f"5g predict {s}")
           for s in out}
    if max(err.values()) > TOL:
        raise RuntimeError(f"5g predict: against the reference {err}")
    rec = {"batch": SESSIONS, "S": S, "T": T_BEAT, "max_abs_err": err,
           "bit_equal_fold_scan": True}
    for strategy in out:
        rec[strategy] = {
            "launches": launches[strategy]["mcd_lstm_seq"],
            "device_ms": device_ms(lambda s=strategy: run(s), 3,
                                   "mcd_lstm_seq_kernel"),
            "call_ms": cuda_time_ms(lambda s=strategy: run(s), 5)}
    return rec


def controller_phase(report, dev):
    """Phase 5g: the co-design loop on the card, at the classifier's full
    width (I = 1, H = 8, NL = 3, YNY, p = 0.125, S = 30, ``cuda_seq``,
    through the tick graphs).  (a) The roofline calibrated against prewarmed
    engines at CAL_SESSIONS sessions, capacity "auto" over (8, 16, 20),
    ragged chunks in blocks of bounds CAL_BOUNDS: ``fit_roofline`` on the
    pooled window and on each engine's, with the raw roofline of each
    (rows, rung) shape beside its observed p50.  (b) An attached
    ``CoDesignController`` on 64 sessions (and CTRL_QUEUED queued tickets),
    its SLO CTRL_SLO x the p95 of a warm-up window in this process,
    ``min_samples`` CTRL_FLOOR, knobs ``KnobSpace.around(config,
    precisions=(None, "bf16"))``: an applied slo-breach downshift to
    CTRL_FLOOR <= S < 30, no capture after the swap, the queue and its
    order kept, no row drawn twice, every post-swap summary and the final
    carries bit-equal to a prewarmed engine at the winner's config fed the
    converted pre-swap sessions, the JSONL trail one line a decision.  (c)
    A ``FleetController`` over a fleet of the classifier LSTM (fp32
    ``cuda_seq``, an SLO from its own warm-up) and the classifier GRU (bf16
    ``cuda_step``, no SLO): only the first reconfigured, no capture on its
    ticks after the swap, the second's engine object kept and its summaries bit-equal to an engine of its own
    ticked in turns, every record tagged.  (d) ``predict`` fold (one
    1920-row launch a layer) against scan (30 launches of 64 rows a layer):
    bit-equal, each within TOL of the ``reference`` backend; launches and
    device ms of each."""
    cfg, params, per_layer = ecg_model("classifier", "lstm", dev)
    total = {name: 0 for name in ALL_KERNELS}
    times = {}
    t0 = time.perf_counter()
    rec = {"card": report["card"],
           "calibration": _calibration(cfg, params, dev, total, per_layer)}
    times["a"] = time.perf_counter() - t0
    rec["controller"] = _controlled(report, cfg, params, dev, total,
                                    per_layer)
    times["b"] = time.perf_counter() - t0 - sum(times.values())
    rec["fleet"] = _fleet_controlled(cfg, params, dev, total)
    times["c"] = time.perf_counter() - t0 - sum(times.values())
    rec["predict"] = _predict_cell(cfg, params, dev, total)
    times["d"] = time.perf_counter() - t0 - sum(times.values())
    rec["seconds"] = times
    rec["launches"] = {k: v for k, v in total.items() if v}
    report["codesign"] = rec
    print("codesign " + json.dumps(rec), flush=True)
    return total


# -- sharding ---------------------------------------------------------------

# (model, cell, backend) of phase 12's engines on a mesh of the card.
SHARD_CELLS = (("classifier", "lstm", "cuda_seq"),
               ("autoencoder", "gru", "cuda_seq"),
               ("classifier", "gru", "cuda_step"))
SHARDS = 4            # data entries of the mesh that lists the card
SHARD_TICKS = 12      # every beat in 12 ragged chunks
SHARD_KILL = 5        # ticks before 12c's snapshot
SHARD_TURNS = 2       # runs a side of 12e's timing, in turns
GSPMD_B, GSPMD_T = 64, 20   # 12d: the stack at the classifier's widths


def _shard_chunks(eng, streams, plans, sids, t):
    return {sid: streams[k][eng.store.get(sid).steps:][:plans[k, t]]
            for k, sid in enumerate(sids)}


def _shard_check(run, base, sids, key, kernel, per_layer, shards, seq,
                 graphs=True):
    """A mesh run against the unsharded run: summaries and carries bit for
    bit, ``TickMetrics.shards``, whole sessions a shard, the launches of
    every tick (layers x shards, x T on the step backend) and no capture
    after prewarm."""
    eng, _, counts, _ = run
    _same_serving(run, base, sids, key)
    for m in eng.metrics:
        if m.shards != shards or m.batch_rows % (shards * S):
            raise RuntimeError(f"{key}: tick {m.tick} shards {m.shards}, "
                               f"batch rows {m.batch_rows}")
        if graphs and m.compiles:
            raise RuntimeError(f"{key}: tick {m.tick} captured after "
                               "prewarm")
    _check_launches(key, counts, eng.metrics, kernel,
                    (lambda m: per_layer * shards) if seq
                    else (lambda m: per_layer * shards * m.capacity))


def _shard_resume(params, cfg, dev, first, second, plans, sids, streams,
                  tag):
    """Phase 12c: an engine on ``first`` serves SHARD_KILL ticks and
    snapshots; a fresh prewarmed engine on ``second`` restores it and
    serves to the end.  Returns (engine, every tick's results)."""
    from repro_torch.serve import StreamingEngine, prewarm
    path = os.path.join(ROOT, "build", "phase12", tag)
    shutil.rmtree(path, ignore_errors=True)
    kw = dict(backend="cuda_seq", max_sessions=SESSIONS,
              chunk_capacity=CHUNK, device=dev)
    eng = StreamingEngine(params, cfg, mesh=first, **kw)
    prewarm(eng)
    for sid in sids:
        eng.open_session(sid)
    ticks = [eng.step(_shard_chunks(eng, streams, plans, sids, t))
             for t in range(SHARD_KILL)]
    eng.snapshot(path)
    fresh = StreamingEngine(params, cfg, mesh=second, **kw)
    prewarm(fresh)
    fresh.restore(path)
    ticks += [fresh.step(_shard_chunks(fresh, streams, plans, sids, t))
              for t in range(SHARD_KILL, plans.shape[1])]
    if any(m.compiles for m in fresh.metrics):
        raise RuntimeError(f"12c {tag}: a tick captured after the restore")
    return fresh, ticks


def _gspmd_check(dev, mesh):
    """Phase 12d: ``run_stack`` under the gspmd strategy (H over the
    model axis) at the classifier's widths against the unsharded
    ``reference`` backend, both cells: outputs and carries bit for bit."""
    import numpy as np
    import torch
    from repro_torch.core import rnn
    from repro_torch.launch import rnn_shardings as rs
    out = {}
    for cell in ("lstm", "gru"):
        cfg, params, _ = ecg_model("classifier", cell, dev)
        enc, hid = params["encoder"], (cfg.hidden,) * cfg.num_layers
        rng = np.random.default_rng(12)
        x = torch.from_numpy(rng.standard_normal(
            (GSPMD_B, GSPMD_T, 1)).astype(np.float32)).to(dev)
        rows = torch.arange(GSPMD_B, device=dev)
        lengths = torch.from_numpy(rng.integers(
            1, GSPMD_T + 1, GSPMD_B).astype(np.int32)).to(dev)
        kw = dict(rows=rows, seed=cfg.mcd.seed, lengths=lengths,
                  return_all_states=True, cell=cell, device=dev)
        t0 = time.perf_counter()
        want = rnn.run_stack(enc, x, rnn.sample_stack_masks(
            cfg.mcd, rows, 1, hid, cell=cell), cfg.mcd.p,
            backend="reference", **kw)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        got = rnn.run_stack(enc, x, rnn.stack_mask_plan(
            cfg.mcd, cfg.num_layers), cfg.mcd.p, backend="cuda_seq",
            mesh=mesh, policy=rs.StackShardingPolicy(strategy="gspmd"),
            **kw)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        same = torch.equal(got[0], want[0]) and all(
            a.dtype == b.dtype and torch.equal(a, b)
            for la, lb in zip(got[1], want[1], strict=True)
            for a, b in zip(la, lb, strict=True))
        if not same:
            raise RuntimeError(f"12d gspmd {cell}: not bit-equal to the "
                               "unsharded reference backend (max diff "
                               f"{max_abs_diff(got[0], want[0], cell)})")
        out[cell] = {"B": GSPMD_B, "T": GSPMD_T, "H": cfg.hidden,
                     "layers": cfg.num_layers, "bit_equal": True,
                     "specs": [sp.wh for sp in rs.stack_param_specs(
                         enc, mesh, strategy="gspmd")],
                     "reference_s": t1 - t0, "gspmd_s": t2 - t1}
    return out


def sharding_phase(report, dev):
    """Phase 12: the ECG engine on a data mesh that lists the card
    SHARDS times (the card is one device: the mesh proves the partition,
    its launches and what a shard adds to a tick, not placement across
    cards).  (a) ``make_data_mesh(1)`` == no mesh for the classifier LSTM
    on ``cuda_seq``; (b) SHARD_CELLS on the SHARDS-entry mesh, each
    bit-equal to the unsharded engine (``_shard_check``); (c) a snapshot
    of the SHARDS-shard engine restored on a one-shard engine and back,
    each bit-equal to the uninterrupted run; (d) gspmd on a (2 data x 2
    model) mesh of the card; (e) tick p50 / p95 of (b)'s classifier cell
    against the unsharded engine, SHARD_TURNS runs a side in turns.  With
    two cards or more, (b)'s first cell also runs over real cards
    (eagerly: a graph holds one card's launches)."""
    import numpy as np
    import torch
    from repro_torch.launch.mesh import make_data_mesh

    t_phase = time.perf_counter()
    n_cards = torch.cuda.device_count()
    print(f"phase 12: torch.cuda.device_count() = {n_cards}", flush=True)
    home = (torch.device("cuda", torch.cuda.current_device())
            if dev.type == "cuda" else dev)
    repeated = make_data_mesh(SHARDS, devices=[home] * SHARDS)
    streams = _beats()
    plans = chunk_plans(np.random.default_rng(12), SESSIONS, SHARD_TICKS)
    sids = [f"m-{k}" for k in range(SESSIONS)]
    total = {name: 0 for name in ALL_KERNELS}
    out = {"card": report["card"], "device_count": n_cards,
           "shards": SHARDS, "sessions": SESSIONS, "chains": S,
           "cells": {}}

    def run(params, cfg, backend, mesh, graphs=True):
        r = _graph_run(params, cfg, home, graphs, plans, sids, streams,
                       backend=backend, chunk_capacity=CHUNK, mesh=mesh)
        for name, v in r[2].items():
            total[name] += v
        return r

    for i, (model, cell, backend) in enumerate(SHARD_CELLS):
        cfg, params, per_layer = ecg_model(model, cell, home)
        seq = backend == "cuda_seq"
        kernel = f"mcd_{cell}_{'seq' if seq else 'step'}"
        key = f"{model}_{cell}_{backend}"
        runs = {"plain": [], "mesh": []}
        order = ((("plain", "mesh"), ("mesh", "plain")) if i == 0
                 else (("plain", "mesh"),))
        for turn in order:
            for side in turn:
                runs[side].append(run(params, cfg, backend,
                                      repeated if side == "mesh" else None))
        base = runs["plain"][0]
        _check_launches(f"12b {key} plain", base[2], base[0].metrics,
                        kernel, (lambda m: per_layer) if seq
                        else (lambda m: per_layer * m.capacity))
        for k, r in enumerate(runs["mesh"]):
            _shard_check(r, base, sids, f"12b {key} mesh {k}", kernel,
                         per_layer, SHARDS, seq)
        for r in runs["plain"][1:]:
            _same_serving(r, base, sids, f"12e {key} plain")
        cell_out = {"model": model, "cell": cell, "backend": backend,
                    "bit_equal": True,
                    "launches_per_tick": {
                        side: [m.launches for m in runs[side][0][0].metrics]
                        for side in runs},
                    "batch_rows": {side: runs[side][0][0].metrics[0]
                                   .batch_rows for side in runs},
                    "plain": _side_stats(runs["plain"], report["card"]),
                    "mesh": _side_stats(runs["mesh"], report["card"])}
        cell_out["host_ms_per_added_shard"] = (
            cell_out["mesh"]["tick_ms_p50"]
            - cell_out["plain"]["tick_ms_p50"]) / (SHARDS - 1)
        if i == 0:
            one = run(params, cfg, backend, make_data_mesh(1, device=home))
            _shard_check(one, base, sids, "12a mesh(1)", kernel, per_layer,
                         1, seq)
            cell_out["mesh1_bit_equal"] = True
            cell_out["mesh1_tick_ms_p50"] = _side_stats(
                [one], report["card"])["tick_ms_p50"]
            t0 = time.perf_counter()
            for tag, first, second in (("n_to_1", repeated, None),
                                       ("1_to_n", None, repeated)):
                got = _shard_resume(params, cfg, home, first, second, plans,
                                    sids, streams, tag)
                _same_serving(got, base, sids, f"12c {tag}")
            shutil.rmtree(os.path.join(ROOT, "build", "phase12"),
                          ignore_errors=True)
            cell_out["snapshot_round_trip"] = {
                "bit_equal": True, "seconds": time.perf_counter() - t0}
            if n_cards >= 2:
                cards = make_data_mesh(min(n_cards, SHARDS), device=home)
                r = run(params, cfg, backend, cards, graphs=False)
                _shard_check(r, base, sids, "12b real cards", kernel,
                             per_layer, cards.size, seq, graphs=False)
                cell_out["real_cards"] = _side_stats([r], report["card"])
        out["cells"][key] = cell_out
    t0 = time.perf_counter()
    out["gspmd"] = _gspmd_check(home, make_data_mesh(
        2, model=2, devices=[home] * 4))
    out["gspmd_s"] = time.perf_counter() - t0
    out["launches"] = {k: v for k, v in total.items() if v}
    out["seconds"] = time.perf_counter() - t_phase
    report["sharding"] = out
    print("sharding " + json.dumps(out), flush=True)
    return total


# -- the LM decode path -----------------------------------------------------

def _lm_rows(dev, n):
    """Row ids of ``n`` rows: chain rows 0..63 with bit 31 set on every
    16th (these kernels mask such rows too), each repeated per position as
    a prefill flattens them (n // 64 positions; n < 64 or not a multiple:
    the rows in turn); int64 uint32 values."""
    import torch
    chains = LM_B * LM_S
    rows = torch.arange(chains, dtype=torch.int64)
    rows[5::16] |= 1 << 31
    if n % chains == 0:
        return rows.repeat_interleave(n // chains).to(dev)
    return rows.repeat(-(-n // chains))[:n].to(dev)


def _lm_record(name, case, err, call, plain, nbytes, ops, library=None,
               iters=3, peak=PEAK_FP32_FLOPS):
    """One case: call and device time of the kernel (over ``iters``
    profiled calls), the plain version's time, the bound (the operations
    at ``peak``, the rate of their type) and the library call's times (or
    None)."""
    t_bytes, t_ops = nbytes / PEAK_HBM_BYTES, ops / peak
    rec = dict(kernel=name, **case, max_abs_err=err,
               kernel_ms=cuda_time_ms(call, iters=10, warmup=2),
               kernel_device_ms=device_ms(call, iters, name + "_kernel"),
               plain_ms=cuda_time_ms(plain, iters=3, warmup=1),
               bound_ms=max(t_bytes, t_ops) * 1e3,
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               library_ms=None, library_device_ms=None)
    if library is not None:
        rec["library_ms"] = cuda_time_ms(library, iters=10, warmup=2)
        rec["library_device_ms"] = device_ms(library, 3)
    print("lm kernel case " + json.dumps(rec), flush=True)
    return rec


# masked_activation cases of phase 6: (rows, F, x misaligned), each at
# p = 0.1 and, for its copy floor, at p = 0: qwen3-1.7b's decode and
# prefill, mamba2-370m's, F off the 16-byte path, and a view of x 4 bytes
# past a 16-byte boundary.
MASK_CASES = [
    (LM_B * LM_S, 2048, False), (LM_B * LM_S * LM_PROMPT, 2048, False),
    (LM_B * LM_S, 1024, False), (LM_B * LM_S * MB_PROMPT, 1024, False),
    (LM_B * LM_S, 2047, False), (LM_B * LM_S, 2048, True),
]
MASK_P = 0.1


def mask_cases(dev, g, key) -> list[dict]:
    """``masked_activation`` at MASK_CASES: bitwise equal to its plain
    version at p = 0.1 and at p = 0 (a copy), its keep bits equal to the
    plain stream (the rows with bit 31 set masked too); each record holds
    the plan, the times at p = 0.1 and the same launch's time at p = 0 (the
    copy of the same bytes: the floor for a launch of this size)."""
    import torch
    from repro_torch.kernels import bernoulli_mask, common
    records = []
    for M, D, misaligned in MASK_CASES:
        rows = _lm_rows(dev, M)
        if misaligned:
            buf = torch.randn((M * D + 1,), generator=g, device=dev)
            x = buf[1:].view(M, D)
        else:
            x = torch.randn((M, D), generator=g, device=dev)
        ones = torch.ones_like(x)
        for p in (MASK_P, 0.0):
            got = bernoulli_mask.masked_activation(x, rows, key, p)
            bits = bernoulli_mask.masked_activation(ones, rows, key, p) != 0
            torch.cuda.synchronize()
            want = bernoulli_mask.masked_activation_plain(x, rows, key, p)
            keep = (common.gate_mask(key, rows, D, p) if p else
                    torch.ones_like(bits))
            what = f"M={M} F={D} misaligned={misaligned} p={p}"
            if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                raise RuntimeError(f"masked_activation differs from its "
                                   f"plain version at {what}")
            if not torch.equal(bits, keep):
                raise RuntimeError(f"masked_activation mask bits differ from "
                                   f"the plain stream at {what}")
            hi = (rows >= 2 ** 31)
            if p and bits[hi].all():
                raise RuntimeError("masked_activation exempted the bit-31 "
                                   "rows")
        err = max_abs_diff(got, want, "masked_activation")
        r32 = common.rows_to_int32(rows)      # as the layers pass them
        iters = 20 if M * D <= 2 ** 20 else 5

        def call(p):
            return lambda: bernoulli_mask.masked_activation(x, r32, key, p)

        case = dict(M=M, F=D, p=MASK_P, misaligned=misaligned,
                    plan=bernoulli_mask.mask_plan(M, D, not misaligned),
                    bit_equal=True, mask_bits_equal=True,
                    copy_ms=cuda_time_ms(call(0.0), iters=10, warmup=2),
                    copy_device_ms=device_ms(call(0.0), iters,
                                             "masked_activation_kernel"))
        records.append(_lm_record(
            "masked_activation", case, err, call(MASK_P),
            lambda: bernoulli_mask.masked_activation_plain(x, rows, key,
                                                           MASK_P),
            # ~22 integer operations an element for the hash and select,
            # counted at the CUDA cores' fp32 rate: far under the bytes.
            nbytes=4 * (2 * M * D + M), ops=22 * M * D, iters=iters))
    return records


def matmul_cases(dev, g, key) -> list[dict]:
    """``mcd_matmul``: the SwiGLU gate/up product, fp32 out, at decode and
    prefill, and once with K and N off the 16-byte path (4-byte copies,
    ragged tiles on every edge).  Each case: within MM_TOL of the cuBLAS
    plain version (bit-equal where cuBLAS also sums in order), and two
    calls bitwise equal (no split of K, no atomics)."""
    import torch
    from repro_torch.kernels import bernoulli_mask, common, mcd_matmul
    rows_n = LM_B * LM_S                     # 8 prompts x 8 chains
    D, N = 2048, 2 * 6144
    records = []
    w = torch.randn((D, N), generator=g, device=dev) * D ** -0.5
    w_odd = torch.randn((D + 2, N + 2), generator=g, device=dev) * D ** -0.5
    for M, p, wm in ((rows_n, 0.1, w), (rows_n, 0.0, w),
                     (rows_n * LM_PROMPT, 0.1, w), (rows_n * LM_PROMPT, 0.0, w),
                     (rows_n + 1, 0.1, w_odd)):
        K_, N_ = wm.shape
        rows = _lm_rows(dev, M)
        x = torch.randn((M, K_), generator=g, device=dev)
        got = mcd_matmul.mcd_matmul(x, wm, rows, key, p, torch.float32)
        again = mcd_matmul.mcd_matmul(x, wm, rows, key, p, torch.float32)
        torch.cuda.synchronize()
        want = mcd_matmul.mcd_matmul_plain(x, wm, rows, key, p,
                                           torch.float32)
        err = max_abs_diff(got, want, "mcd_matmul")
        if err > MM_TOL or not torch.equal(got, again):
            raise RuntimeError(f"mcd_matmul at M={M} K={K_} N={N_} p={p}: "
                               f"{err} from its plain version (tol "
                               f"{MM_TOL}); two calls bitwise equal: "
                               f"{torch.equal(got, again)}")
        xm = bernoulli_mask.masked_activation_plain(x, rows, key, p)
        r32 = common.rows_to_int32(rows)
        plan = mcd_matmul.mcd_matmul.last_plan
        records.append(_lm_record(
            "mcd_matmul", dict(M=M, K=K_, N=N_, p=p, path=plan["path"],
                               tile=plan["tile"],
                               bit_equal=bool(torch.equal(got, want)),
                               repeat_bit_equal=True), err,
            lambda: mcd_matmul.mcd_matmul(x, wm, r32, key, p, torch.float32),
            lambda: mcd_matmul.mcd_matmul_plain(x, wm, rows, key, p,
                                                torch.float32),
            nbytes=4 * (M * K_ + K_ * N_ + M * N_ + M), ops=2 * M * K_ * N_,
            library=lambda: torch.matmul(xm, wm)))
        del got, again, want, xm
    return records


def lm_kernel_phase(report) -> list[dict]:
    """The three LM kernels against their plain versions at qwen3-1.7b's
    serving shapes (the mask at mamba2-370m's too), then the four at the
    zoo's bf16 shapes (:func:`zoo_kernel_cases`) and phase 18's prefill
    rows (:func:`encdec_kernel_cases`)."""
    import torch
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11)
    key = 0x2545F491
    records = mask_cases(dev, g, key)
    records += matmul_cases(dev, g, key)
    records += attention_cases()
    records += lm_bf16_cases(dev, g, key)
    records += zoo_kernel_cases(dev, g, key)
    records += encdec_kernel_cases(dev, g, key)
    report["lm_kernel_cases"] = records
    return records


def zoo_kernel_cases(dev, g, key) -> list[dict]:
    """The four LM kernels at bf16 at the shapes llama3-8b and the jamba
    cut give them (ZOO_*; phases 15 and 16), each held against its plain
    version as at qwen3's shapes: the mask bitwise, ``mcd_matmul`` at
    decode and prefill M on the tensor cores within MM_TOL,
    ``decode_attention`` within ATTN_TOL plus one bf16 ulp, the SSD scan
    within SSD_TOL plus one bf16 ulp on the tensor cores.  Each record
    names its ``model``."""
    import torch
    from repro_torch.kernels import mcd_matmul
    bf = torch.bfloat16
    records = [bf16_mask_case(dev, g, key, M, D, model)
               for M, D, model in ZOO_MASK_CASES]
    for K_, N_, model in ZOO_MM_CASES:
        w = (torch.randn((K_, N_), generator=g, device=dev)
             * K_ ** -0.5).to(bf)
        for M in (LM_B * LM_S, LM_B * LM_S * LM_PROMPT):
            records.append(bf16_matmul_case(
                dev, g, key, M, w, "tensor_cores",
                mcd_matmul.matmul_plan(M, N_, K_, 2)["tile"], model))
        del w
    for H, model in ZOO_ATTN_CASES:
        records += bf16_attention_cases(LM_B * LM_S, H, LM_PROMPT + LM_NEW,
                                        ZOO_ATTN_POSITIONS, model)
    records += ssd_bf16_cases(ZOO_SSD, [(False, "tensor_cores")],
                              "jamba-1.5-large prefill")
    return records


def bf16_excess(got, want, atol) -> float:
    """How far ``got`` lies past ``atol`` plus one bf16 ulp of ``want``
    (2^(e-7) at |want| in [2^e, 2^(e+1))), at its worst: <= 0 when every
    element is within (fp32 results within ``atol``, each rounded once to
    bf16, differ by at most that).  Raises on a non-finite value."""
    import torch
    g, w = got.float(), want.float()
    max_abs_diff(g, w, "a bf16 result")
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp(min=2 ** -126)))
                     - 7)
    return ((g - w).abs() - atol - ulp).max().item()


# The bf16 cases of phases 6 and 8: the serving shapes at bf16.
BF16_MASK_CASES = [(LM_B * LM_S, 2048), (LM_B * LM_S * LM_PROMPT, 2048),
                   (LM_B * LM_S, 1024), (LM_B * LM_S * MB_PROMPT, 1024)]
# bf16 mcd_matmul: (M, W, path, tile): decode and prefill on the tensor
# cores; K = 2050 and N = 12290 (W "ragged") on the CUDA cores.
BF16_MM_CASES = [(LM_B * LM_S, "aligned", "tensor_cores", "tc_narrow"),
                 (LM_B * LM_S * LM_PROMPT, "aligned", "tensor_cores",
                  "tc_wide"),
                 (LM_B * LM_S + 1, "ragged", "cuda_cores", "narrow"),
                 (LM_B * LM_S * LM_PROMPT, "ragged", "cuda_cores", "wide")]
# deepseek-v2-lite-16b's masked gate/up products (K = 2048, bf16), at
# decode and prefill M: layer 0's dense FFN and a MoE layer's two shared
# experts.
DEEPSEEK_MM_N = ((2 * 10944, "deepseek dense layer 0"),
                 (2 * 2 * 1408, "deepseek shared experts"))
BF16_ATTN_POSITIONS = (0, 127, 159)
# Phase 6's cases at the shapes phases 15 and 16 give the kernels, bf16:
# jamba-1.5-large (d_model 8192, 64 q heads to 8 KV heads: the decode
# kernel's largest group, _MAX_REP; the mamba.mlp gate/up N = 2 x 24576;
# the SSD scan's 256 heads at a 128-token prompt, Q = 128) and llama3-8b
# (d_model 4096, 32 q heads to 8, gate/up N = 2 x 14336).
ZOO_MASK_CASES = ((LM_B * LM_S, 8192, "jamba-1.5-large d_model"),
                  (LM_B * LM_S * LM_PROMPT, 8192, "jamba-1.5-large d_model"))
ZOO_MM_CASES = ((8192, 2 * 24576, "jamba-1.5-large mamba.mlp gate/up"),
                (4096, 2 * 14336, "llama3-8b gate/up"))
ZOO_ATTN_CASES = ((64, "jamba-1.5-large"), (32, "llama3-8b"))
ZOO_ATTN_POSITIONS = (0, 159)
ZOO_SSD = (LM_B * LM_S, LM_PROMPT, 256, 64, 128, 256)


def lm_bf16_cases(dev, g, key) -> list[dict]:
    """The three LM kernels at bf16 against their plain versions at the
    serving shapes: ``masked_activation`` bitwise equal (qwen3's and
    mamba2's decode and prefill); ``mcd_matmul``'s fp32 out (the SwiGLU
    gate/up product) within MM_TOL at decode and prefill on the tensor
    cores, and at K = 2050, N = 12290 on the CUDA cores, M = 65 on the
    narrow tile and M = 8192 on the wide one (the ``path`` and ``tile``
    of the plan the wrapper launched, checked; its host ms a call beside
    the device ms), two calls bitwise equal;
    ``decode_attention`` within ATTN_TOL plus one bf16 ulp
    at the serving shape, two calls and a tensor pos bitwise equal to the
    int.  Each record: ``dtype`` "bf16", times, the bound at bf16 bytes
    (operations of a product at the bf16 tensor-core rate) and the bf16
    library call (cuBLAS ``torch.matmul``, SDPA)."""
    import torch
    from repro_torch.kernels import mcd_matmul
    bf = torch.bfloat16
    records = [bf16_mask_case(dev, g, key, M, D)
               for M, D in BF16_MASK_CASES]
    D, N = 2048, 2 * 6144
    w = (torch.randn((D, N), generator=g, device=dev) * D ** -0.5).to(bf)
    w_odd = (torch.randn((D + 2, N + 2), generator=g, device=dev)
             * D ** -0.5).to(bf)
    cases = [(M, w if which == "aligned" else w_odd, path, tile, None)
             for M, which, path, tile in BF16_MM_CASES]
    for N_ds, model in DEEPSEEK_MM_N:
        w_ds = (torch.randn((D, N_ds), generator=g, device=dev)
                * D ** -0.5).to(bf)
        cases += [(M, w_ds, "tensor_cores",
                   mcd_matmul.matmul_plan(M, N_ds, D, 2)["tile"], model)
                  for M in (LM_B * LM_S, LM_B * LM_S * LM_PROMPT)]
    for M, wm, path, tile, model in cases:
        records.append(bf16_matmul_case(dev, g, key, M, wm, path, tile,
                                        model))
    del w, w_odd, cases, w_ds
    B, H, S = ATTN_SERVING
    records += bf16_attention_cases(B, H, S, BF16_ATTN_POSITIONS)
    return records


def bf16_mask_case(dev, g, key, M, D, model=None) -> dict:
    """bf16 ``masked_activation`` of [M, D]: bitwise equal to its plain
    version at p = 0.1 and p = 0; its record with the p = 0 copy's device
    ms (the floor for a launch of this size) and the bound at bf16
    bytes."""
    import torch
    from repro_torch.kernels import bernoulli_mask, common
    rows = _lm_rows(dev, M)
    x = torch.randn((M, D), generator=g, device=dev).to(torch.bfloat16)
    for p in (MASK_P, 0.0):
        got = bernoulli_mask.masked_activation(x, rows, key, p)
        torch.cuda.synchronize()
        want = bernoulli_mask.masked_activation_plain(x, rows, key, p)
        if not torch.equal(got.view(torch.int16), want.view(torch.int16)):
            raise RuntimeError(f"bf16 masked_activation differs from its "
                               f"plain version at M={M} F={D} p={p}")
    err = max_abs_diff(got.float(), want.float(), "masked_activation")
    r32 = common.rows_to_int32(rows)
    iters = 20 if M * D <= 2 ** 20 else 5

    def call(p):
        return lambda: bernoulli_mask.masked_activation(x, r32, key, p)

    return _lm_record(
        "masked_activation",
        dict(M=M, F=D, p=MASK_P, dtype="bf16", misaligned=False,
             model=model, plan=bernoulli_mask.mask_plan(M, D, True, 2),
             bit_equal=True,
             copy_device_ms=device_ms(call(0.0), iters,
                                      "masked_activation_kernel")),
        err, call(MASK_P),
        lambda: bernoulli_mask.masked_activation_plain(x, rows, key, MASK_P),
        nbytes=2 * 2 * M * D + 4 * M, ops=22 * M * D, iters=iters)


def bf16_matmul_case(dev, g, key, M, wm, path, tile, model) -> dict:
    """One bf16 ``mcd_matmul`` case (fp32 out, p = 0.1) at M rows of
    ``wm``'s K: the plan the wrapper launched must be (``path``,
    ``tile``), the product within MM_TOL of its plain version, two calls
    bitwise equal; its record with the host ms, the bound at bf16 bytes
    and the tensor-core rate, and cuBLAS ``torch.matmul``."""
    import torch
    from repro_torch.kernels import bernoulli_mask, common, mcd_matmul
    K_, N_ = wm.shape
    rows = _lm_rows(dev, M)
    x = torch.randn((M, K_), generator=g, device=dev).to(torch.bfloat16)
    got = mcd_matmul.mcd_matmul(x, wm, rows, key, 0.1, torch.float32)
    plan = mcd_matmul.mcd_matmul.last_plan
    if (plan["path"], plan["tile"]) != (path, tile):
        raise RuntimeError(f"bf16 mcd_matmul at M={M} K={K_} N={N_} "
                           f"launched {plan['path']} {plan['tile']}, "
                           f"not {path} {tile}")
    again = mcd_matmul.mcd_matmul(x, wm, rows, key, 0.1, torch.float32)
    torch.cuda.synchronize()
    want = mcd_matmul.mcd_matmul_plain(x, wm, rows, key, 0.1, torch.float32)
    err = max_abs_diff(got, want, "bf16 mcd_matmul")
    if err > MM_TOL or not torch.equal(got, again):
        raise RuntimeError(f"bf16 mcd_matmul at M={M} K={K_} N={N_}: "
                           f"{err} from its plain version (tol "
                           f"{MM_TOL}); two calls equal: "
                           f"{torch.equal(got, again)}")
    del got, again, want
    xm = bernoulli_mask.masked_activation_plain(x, rows, key, 0.1)
    r32 = common.rows_to_int32(rows)

    def mm_call():
        return mcd_matmul.mcd_matmul(x, wm, r32, key, 0.1, torch.float32)

    return _lm_record(
        "mcd_matmul", dict(M=M, K=K_, N=N_, p=0.1, dtype="bf16",
                           out="float32", path=plan["path"],
                           tile=plan["tile"], smem=plan["smem"],
                           repeat_bit_equal=True, model=model,
                           host_ms=host_ms(mm_call)),
        err, mm_call,
        lambda: mcd_matmul.mcd_matmul_plain(x, wm, rows, key, 0.1,
                                            torch.float32),
        nbytes=2 * (M * K_ + K_ * N_) + 4 * M * N_ + 4 * M,
        ops=2 * M * K_ * N_, peak=PEAK_BF16_FLOPS,
        library=lambda: torch.matmul(xm, wm))


def bf16_attention_cases(B, H, S, positions, model=None) -> list[dict]:
    """bf16 ``decode_attention`` of B rows, H query heads to 8 KV heads of
    128, an S-position cache, at each of ``positions``: within ATTN_TOL
    plus one bf16 ulp of its plain version, two calls and a tensor pos
    bitwise equal to the int; records with the bound at bf16 bytes and
    SDPA's time."""
    import itertools
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attn
    bf = torch.bfloat16
    dev = torch.device("cuda")
    KV, hd = 8, 128
    records = []
    q, kc, vc = (t.to(bf) for t in attention_inputs(B, H, KV, hd, S))
    inputs = attention_rotation(q, kc, vc)
    for pos in positions:
        got = decode_attn.decode_attention(q, kc, vc, pos)
        again = decode_attn.decode_attention(q, kc, vc, pos)
        got_t = decode_attn.decode_attention(
            q, kc, vc, torch.tensor([pos], dtype=torch.int32, device=dev))
        torch.cuda.synchronize()
        want = decode_attn.decode_attention_plain(q, kc, vc, pos)
        excess = bf16_excess(got, want, ATTN_TOL)
        if excess > 0 or not (torch.equal(got, again)
                              and torch.equal(got, got_t)):
            raise RuntimeError(f"bf16 decode_attention at pos={pos}: "
                               f"{excess} past ATTN_TOL plus one ulp; two "
                               f"calls / tensor pos equal: "
                               f"{torch.equal(got, again)}, "
                               f"{torch.equal(got, got_t)}")
        err = max_abs_diff(got.float(), want.float(), "decode_attention")
        turn = itertools.count()
        sdpa = [(a[:, :, None], k[:, :pos + 1].permute(0, 2, 1, 3),
                 v[:, :pos + 1].permute(0, 2, 1, 3)) for a, k, v in inputs]
        nbytes, ops = attention_cost(B, H, KV, hd, pos)
        records.append(_lm_record(
            "decode_attention",
            dict(B=B, H=H, KV=KV, hd=hd, S=S, pos=pos, dtype="bf16",
                 model=model,
                 plan=decode_attn.decode_plan(B, H, KV, hd, S, 2),
                 blocks_per_sm=decode_attn.blocks_per_sm(H, KV, hd, bf),
                 timed_copies=len(inputs), repeat_bit_equal=True,
                 tensor_pos_bit_equal=True),
            err,
            lambda: decode_attn.decode_attention(
                *inputs[next(turn) % len(inputs)], pos),
            lambda: decode_attn.decode_attention_plain(
                *inputs[next(turn) % len(inputs)], pos),
            nbytes=nbytes // 2, ops=ops, peak=PEAK_BF16_FLOPS,
            library=lambda: F.scaled_dot_product_attention(
                *sdpa[next(turn) % len(sdpa)], enable_gqa=True)))
        del got, again, got_t, want, sdpa
    del q, kc, vc, inputs
    return records


def attention_inputs(B, H, KV, hd, S):
    """q [B, H, hd] and the caches [B, S, KV, hd], unit normal, from a seed
    of the shape (the same inputs whichever tree runs them)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(B * S + H)
    return [torch.randn(shape, generator=g, device="cuda") for shape in
            ((B, H, hd), (B, S, KV, hd), (B, S, KV, hd))]


def attention_cost(B, H, KV, hd, pos) -> tuple[float, float]:
    """(bytes, operations) one call needs: q read and out written once, K
    and V up to pos read once; a score and its share of p . V a position."""
    n = pos + 1
    return 4 * (2 * B * H * hd + 2 * B * n * KV * hd), B * H * n * (4 * hd + 5)


def attention_check(q, kc, vc, pos):
    """The gates of one case, each raising: within ATTN_TOL of the plain
    version; no further from a float64 evaluation of the plain version than
    twice the fp32 plain version is; two calls bitwise equal; a tensor pos
    bitwise equal to the int; NaN in the cache past pos changes nothing.
    Returns the case's record and the kernel's output."""
    import torch
    from repro_torch.kernels import decode_attn
    S = kc.shape[1]
    got = decode_attn.decode_attention(q, kc, vc, pos)
    again = decode_attn.decode_attention(q, kc, vc, pos)
    pos_t = torch.tensor([pos], dtype=torch.int32, device=q.device)
    got_t = decode_attn.decode_attention(q, kc, vc, pos_t)
    torch.cuda.synchronize()
    want = decode_attn.decode_attention_plain(q, kc, vc, pos)
    err = max_abs_diff(got, want, "decode_attention")
    f64 = decode_attn.decode_attention_plain(q.double(), kc.double(),
                                             vc.double(), pos)
    witness = {"kernel_vs_f64": max_abs_diff(got.double(), f64,
                                             "f64 witness"),
               "plain_vs_f64": max_abs_diff(want.double(), f64,
                                            "f64 witness")}
    del f64
    nan_equal = None                      # nothing lies past S - 1
    if pos < S - 1:
        kn, vn = kc.clone(), vc.clone()
        kn[:, pos + 1:] = float("nan")
        vn[:, pos + 1:] = float("nan")
        nan_equal = bool(
            torch.equal(decode_attn.decode_attention(q, kn, vn, pos), got)
            and torch.equal(decode_attn.decode_attention(q, kn, vn, pos_t),
                            got))
        del kn, vn
    case = dict(max_abs_err=err, f64_witness=witness,
                bit_equal=bool(torch.equal(got, want)),
                repeat_bit_equal=bool(torch.equal(got, again)),
                tensor_pos_bit_equal=bool(torch.equal(got, got_t)),
                nan_past_pos_bit_equal=nan_equal)
    if (err > ATTN_TOL or witness["kernel_vs_f64"] > 2 *
            witness["plain_vs_f64"] or not case["repeat_bit_equal"]
            or not case["tensor_pos_bit_equal"] or nan_equal is False):
        raise RuntimeError(f"decode_attention at pos={pos}, shape "
                           f"{tuple(kc.shape)}: {case} (tol {ATTN_TOL})")
    return case, got


def attention_graph_check(q, kc, vc) -> dict:
    """One CUDA graph of a call with a tensor pos, replayed at
    GRAPH_POSITIONS: bitwise equal to eager calls with the int, or this
    raises."""
    import torch
    from repro_torch.kernels import decode_attn
    pos_t = torch.zeros(1, dtype=torch.int32, device=q.device)
    decode_attn.decode_attention(q, kc, vc, pos_t)   # loaded, attributes set
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = decode_attn.decode_attention(q, kc, vc, pos_t)
    equal = {}
    for pos in GRAPH_POSITIONS:
        pos_t.fill_(pos)
        graph.replay()
        torch.cuda.synchronize()
        equal[pos] = bool(torch.equal(
            out, decode_attn.decode_attention(q, kc, vc, pos)))
    if not all(equal.values()):
        raise RuntimeError(f"decode_attention graph replay != eager: {equal}")
    return equal


def attention_rotation(q, kc, vc) -> list[tuple]:
    """The inputs a case's timed calls take in turn: its own and, where its
    caches fit in L2, copies enough that twice L2 of other caches is read
    between two calls on one copy.  In a decode step each layer reads its
    own cache, which is not in L2; one small cache timed over and over
    would be read from L2."""
    cache = kc.nbytes + vc.nbytes
    n = 1 if cache >= L2_BYTES else -(-2 * L2_BYTES // cache)
    return [(q, kc, vc)] + [(q.clone(), kc.clone(), vc.clone())
                            for _ in range(n - 1)]


def attention_record(inputs, pos, case, err) -> dict:
    """Times of ``decode_attention`` at ``pos`` over ``inputs`` in turn
    (:func:`attention_rotation`): the kernel, its plain version and scaled
    dot-product attention over the live positions; and the bound."""
    import itertools
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attn
    q, kc, _ = inputs[0]
    (B, H, hd), KV = q.shape, kc.shape[2]
    turn = itertools.cycle(range(len(inputs)))
    sdpa = [(q[:, :, None], k[:, :pos + 1].permute(0, 2, 1, 3),
             v[:, :pos + 1].permute(0, 2, 1, 3)) for q, k, v in inputs]
    nbytes, ops = attention_cost(B, H, KV, hd, pos)
    return _lm_record(
        "decode_attention", dict(case, timed_copies=len(inputs)), err,
        lambda: decode_attn.decode_attention(*inputs[next(turn)], pos),
        lambda: decode_attn.decode_attention_plain(*inputs[next(turn)], pos),
        nbytes=nbytes, ops=ops,
        library=lambda: F.scaled_dot_product_attention(
            *sdpa[next(turn)], enable_gqa=True))


def attention_cases() -> list[dict]:
    """``decode_attention`` at ATTN_CASES: the gates of
    :func:`attention_check`, the plan and the split kernel's resident
    blocks an SM (the CUDA occupancy query), the graph replay at the
    serving shape, SDPA's distance, and :func:`attention_record`."""
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attn
    records = []
    for B, H, KV, hd, S, positions in ATTN_CASES:
        q, kc, vc = attention_inputs(B, H, KV, hd, S)
        plan = decode_attn.decode_plan(B, H, KV, hd, S)
        per_sm = decode_attn.blocks_per_sm(H, KV, hd)
        graph = (attention_graph_check(q, kc, vc)
                 if (B, H, S) == ATTN_SERVING else None)
        inputs = attention_rotation(q, kc, vc)
        for pos in positions:
            case, got = attention_check(q, kc, vc, pos)
            sdpa = F.scaled_dot_product_attention(
                q[:, :, None], kc[:, :pos + 1].permute(0, 2, 1, 3),
                vc[:, :pos + 1].permute(0, 2, 1, 3), enable_gqa=True)
            case["library_max_abs_diff"] = max_abs_diff(
                sdpa[:, :, 0], got, "decode_attention vs SDPA")
            err = case.pop("max_abs_err")
            records.append(attention_record(
                inputs, pos, dict(B=B, H=H, KV=KV, hd=hd, S=S, pos=pos,
                                  plan=plan, blocks_per_sm=per_sm,
                                  graph_bit_equal=graph, **case), err))
            del got, sdpa
        del q, kc, vc, inputs
    return records


def lm_kernel_entries(records) -> list[dict]:
    """The ``kernels`` entries of the three LM kernels, each at its decode
    step shape (the launch the main path repeats most)."""
    picks = {
        "masked_activation": (lambda r: (r["M"], r["F"], r["misaligned"])
                              == (LM_B * LM_S, 2048, False),
                              "attention-site mask at decode: [64, 2048] "
                              "fp32, p=0.1 (prefill [8192, 2048], mamba2's "
                              "[64, 1024] and [32768, 1024], odd F and a "
                              "misaligned view in the report)"),
        "mcd_matmul": (lambda r: r["M"] == LM_B * LM_S and r["p"] > 0,
                       "SwiGLU gate/up at decode: [64, 2048] @ [2048, "
                       "12288] fp32, p=0.1 (prefill M=8192 in the report)"),
        "decode_attention": (lambda r: (r["B"], r["H"], r["KV"], r["S"],
                                        r["pos"])
                             == (*ATTN_SERVING[:2], 8, ATTN_SERVING[2],
                                 LM_PROMPT + LM_NEW - 1),
                             "B=64, H=16, KV=8, hd=128, cache 160, pos=159 "
                             "(pos 0 and 127, one prompt's 8 rows, a "
                             "4096-position cache, rep=4 and olmoe's "
                             "KV=16 in the report)"),
    }
    entries = []
    records = [r for r in records if r.get("dtype") != "bf16"]
    for name, (pick, note) in picks.items():
        (rec,) = [r for r in records if r["kernel"] == name and pick(r)]
        _, src, replaces = LM_KERNELS[name]
        entries.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces, "shape": note, "launches": None,
            "max_abs_err": max(r["max_abs_err"] for r in records
                               if r["kernel"] == name),
            "ms": rec["kernel_ms"], "device_ms": rec["kernel_device_ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "library_device_ms": rec["library_device_ms"],
            "kernel_ms": rec["kernel_ms"]})
    return entries


def lm_bf16_entries(entries, records, launches) -> None:
    """Each LM ``kernels`` entry gains ``precisions``: ``fp32`` (the
    entry's own numbers) and ``bf16``, its case at the same shape at bf16
    from phases 6 and 8 (the mask [64, 2048], the decode product, the
    decode attention at pos 159, the SSD scan at its serving shape) with
    the launches of the bf16 serving phases (7b, 9b, 7c, 14-18)."""
    picks = {
        "masked_activation": lambda r: (r["M"], r["F"]) == (LM_B * LM_S,
                                                            2048),
        "mcd_matmul": lambda r: (r["M"], r["N"]) == (LM_B * LM_S, 2 * 6144),
        "decode_attention": lambda r: (r["pos"], r["H"]) == (
            LM_PROMPT + LM_NEW - 1, ATTN_SERVING[1]),
        "ssd_chunk_scan": lambda r: (r["path"], r["H"]) == (
            "tensor_cores", SSD_CASES[0][2]),
    }
    for e in entries:
        if e["name"] not in LM_KERNELS:
            continue
        (rec,) = [r for r in records if r["kernel"] == e["name"]
                  and r.get("dtype") == "bf16" and not r.get("model")
                  and picks[e["name"]](r)]
        keys = ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "library_device_ms", "max_abs_err")
        e["precisions"] = {
            "fp32": {k: e[k] for k in keys},
            "bf16": {"ms": rec["kernel_ms"],
                     "device_ms": rec["kernel_device_ms"],
                     "plain_ms": rec["plain_ms"],
                     "bound_ms": rec["bound_ms"],
                     "bound_by": rec["bound_by"],
                     "library_ms": rec["library_ms"],
                     "library_device_ms": rec["library_device_ms"],
                     "max_abs_err": max(
                         r["max_abs_err"] for r in records
                         if r["kernel"] == e["name"]
                         and r.get("dtype") == "bf16"),
                     "launches": launches[e["name"]]}}
        for key in ("path", "host_ms", "kernel_names"):
            if key in rec:
                e["precisions"]["bf16"][key] = rec[key]
        if not e["precisions"]["bf16"]["launches"]:
            raise RuntimeError(f"{e['name']} was never launched at bf16 on "
                               "a serving path")


def encdec_entries(entries, records, launches) -> None:
    """Each kernel of phase 18's main paths gains ``encdec``: the
    launches of the encoder–decoder and VLM serving (bf16), each of which
    must have launched, and its phase 6 cases at the prefill rows of
    those paths (``encdec_kernel_cases``; none for ``decode_attention``)."""
    keys = ("M", "F", "K", "N", "path", "tile")
    names = tuple(encdec_config(f).name for f in ("audio", "vlm"))
    for e in entries:
        if e["name"] not in ("masked_activation", "mcd_matmul",
                             "decode_attention"):
            continue
        if not launches[e["name"]]:
            raise RuntimeError(f"{e['name']} was never launched in phase 18")
        e["encdec"] = {"dtype": "bf16", "launches": launches[e["name"]],
                       "cases": [
            {"model": r["model"], **{k: r[k] for k in keys if k in r},
             "ms": r["kernel_ms"], "device_ms": r["kernel_device_ms"],
             "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
             "bound_by": r["bound_by"], "library_ms": r["library_ms"],
             "max_abs_err": r["max_abs_err"]}
            for r in records if r["kernel"] == e["name"]
            and str(r.get("model")).startswith(names)]}


def zoo_entries(entries, records, launches) -> None:
    """Each LM ``kernels`` entry gains ``zoo``: its phase 6 cases at the
    shapes of phases 15 and 16 (ZOO_*, bf16; each with the model it
    serves, its shape, times, bound and library time) and the launches of
    those two phases."""
    shape_keys = ("M", "F", "K", "N", "B", "H", "KV", "hd", "S", "pos", "L",
                  "P", "Q", "path", "tile")
    for e in entries:
        if e["name"] not in LM_KERNELS:
            continue
        cases = [{"model": r["model"],
                  **{k: r[k] for k in shape_keys if k in r},
                  "ms": r["kernel_ms"], "device_ms": r["kernel_device_ms"],
                  "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                  "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                  "max_abs_err": r["max_abs_err"]}
                 for r in records if r["kernel"] == e["name"]
                 and str(r.get("model")).startswith(("jamba", "llama3"))]
        if not cases or not launches[e["name"]]:
            raise RuntimeError(f"{e['name']}: {len(cases)} zoo cases, "
                               f"{launches[e['name']]} zoo launches")
        e["zoo"] = {"dtype": "bf16", "cases": cases,
                    "launches": launches[e["name"]]}


# -- the Mamba2 SSD scan ------------------------------------------------------

def ssd_cost(B, L, H, P, N, Q) -> tuple[float, float]:
    """(operations, bytes) the SSD scan needs, the least any kernel does.

    Operations: C . B once per (b, chunk) over the causal pairs (it does
    not depend on the head); per (b, h, chunk) the decay weights (one
    product a pair), the intra sum over the causal pairs, the inter term
    (C . state, scaled), the state update (decay of the state, the
    weighted dtx, the outer-product sum), dt * x, D * x + y, the cumulative
    sum, and one operation an exp.  Bytes: x, dt, B, C, a, D read once; y
    and the final state written once."""
    nc = L // Q
    pairs = Q * (Q + 1) // 2
    per_bhc = (pairs + 2 * pairs * P               # weights, intra
               + 2 * Q * N * P + Q * P             # inter
               + 2 * Q * P * N + P * N + Q * P     # state update
               + Q * P + 2 * Q * P                 # dt * x, + D * x
               + 2 * Q + pairs + 2 * Q)            # cumsum, exps
    ops = B * nc * (2 * pairs * N + H * per_bhc)
    nbytes = 4 * (2 * B * L * H * P + B * L * H + 2 * B * L * N + 2 * H
                  + B * H * P * N)
    return float(ops), float(nbytes)


def ssd_inputs(B, L, H, P, N, *, seed):
    """Inputs at the model's scales: a = -linspace(1, 16, H) (the init's
    a_log), dt = softplus(N(0, 1) + dt_bias) with the init's dt_bias (dt
    ~0.001-0.6; the fast heads' log-decay reaches ~-10^2 within a chunk),
    x unit-scale, B and C at 0.3."""
    import torch
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)

    def r(*shape, k=1.0):
        return torch.randn(shape, generator=g, device=dev) * k

    dt_bias = torch.log(torch.expm1(torch.linspace(1e-3, 0.1, H,
                                                   device=dev)))
    dt = torch.nn.functional.softplus(r(B, L, H) + dt_bias)
    a = -torch.linspace(1.0, 16.0, H, device=dev)
    return [r(B, L, H, P), dt, a, r(B, L, N, k=0.3), r(B, L, N, k=0.3),
            torch.ones(H, device=dev)]


def ssd_kernel_phase(report) -> list[dict]:
    """``ssd_chunk_scan`` against its plain version at SSD_CASES, with a
    float64 witness; times, bound (no library call computes the scan)."""
    import torch
    from repro_torch.kernels import common, ssd_chunk
    records = []
    for B, L, H, P, N, q in SSD_CASES:
        ins = ssd_inputs(B, L, H, P, N, seed=L + H)
        Q = common.largest_divisor(L, q)
        y, h = ssd_chunk.ssd_chunk_scan(*ins, q_chunk=q)
        torch.cuda.synchronize()
        wy, wh = ssd_chunk.ssd_chunk_scan_plain(*ins, q_chunk=q)
        err_y = max_abs_diff(y, wy, "ssd_chunk_scan y")
        err_h = max_abs_diff(h, wh, "ssd_chunk_scan h_final")
        bit_equal = bool(torch.equal(y, wy) and torch.equal(h, wh))
        fy, fh = ssd_chunk.ssd_chunk_scan_plain(
            *(t.double() for t in ins), q_chunk=q)
        witness = {
            "kernel_vs_f64": [max_abs_diff(y.double(), fy, "f64 witness"),
                              max_abs_diff(h.double(), fh, "f64 witness")],
            "plain_vs_f64": [max_abs_diff(wy.double(), fy, "f64 witness"),
                             max_abs_diff(wh.double(), fh, "f64 witness")]}
        cs_min = float(torch.cumsum(
            (ins[1] * ins[2]).reshape(B, L // Q, Q, H), dim=2).min())
        del fy, fh, wy, wh
        case = dict(B=B, L=L, H=H, P=P, N=N, q_chunk=q, Q=Q,
                    max_abs_err_y=err_y, max_abs_err_h=err_h,
                    bit_equal=bit_equal,
                    max_abs_y=float(y.abs().max()),
                    max_abs_h=float(h.abs().max()),
                    min_log_decay_in_a_chunk=cs_min, f64_witness=witness)
        print("ssd kernel check " + json.dumps(case), flush=True)
        if max(err_y, err_h) > SSD_TOL:
            raise RuntimeError(f"ssd_chunk_scan disagrees with its plain "
                               f"version: {case}")
        if any(k > 2 * w + 1e-6 for k, w in zip(witness["kernel_vs_f64"],
                                                witness["plain_vs_f64"])):
            raise RuntimeError(f"ssd_chunk_scan is further from float64 "
                               f"than its plain version: {case}")
        ops, nbytes = ssd_cost(B, L, H, P, N, Q)
        del y, h
        call = lambda ins=ins, q=q: ssd_chunk.ssd_chunk_scan(  # noqa: E731
            *ins, q_chunk=q)
        rec = _lm_record(
            "ssd_chunk_scan", case, max(err_y, err_h), call,
            lambda ins=ins, q=q: ssd_chunk.ssd_chunk_scan_plain(*ins,
                                                                q_chunk=q),
            nbytes=nbytes, ops=ops)
        # The launch's three kernels apart: the in-order cumsum, the C . B
        # pre-pass, and the head kernel (the rest of the launch's time).
        rec["part_device_ms"] = {
            part: device_ms(call, 3, f"ssd_chunk_scan_kernel_{part}")
            for part in ("cumsum", "scores")}
        rec["head_blocks_per_sm"] = ssd_chunk.blocks_per_sm()
        print("ssd kernel parts " + json.dumps(
            [rec["part_device_ms"], rec["head_blocks_per_sm"]]), flush=True)
        records.append(rec)
    records += ssd_bf16_cases()
    report["ssd_kernel_cases"] = records
    return records


# bf16 SSD cases of phase 8, at the serving shape: (x off 16 bytes, the path
# the plan must name).  The tensor-core kernel is the served path; the
# widened fp32 launch takes the bf16 shapes and pointers TMA cannot read.
SSD_BF16_CASES = [(False, "tensor_cores"), (True, "widen")]


def host_parts(fn, calls: int = 200, n: int = 10) -> list:
    """Where the host time of an eager call of ``fn`` goes: the ``n``
    functions with the most cumulative time a call under cProfile, [name,
    cumulative us, own us] (the profiler's own cost inflates each call; the
    shares are what it tells)."""
    import cProfile
    import pstats
    import torch
    fn()
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(calls):
        fn()
    prof.disable()
    torch.cuda.synchronize()
    rows = sorted(pstats.Stats(prof).stats.items(), key=lambda kv: -kv[1][3])
    return [[f"{os.path.basename(f)}:{line}({func})", ct / calls * 1e6,
             tt / calls * 1e6] for (f, line, func), (_, _, tt, ct, _)
            in rows[:n]]


def top_kernels(table, n: int = 5) -> list:
    """The ``n`` kernels of a ``_kernel_table`` with the most device time:
    [name (cut to 120 characters), device ms, calls]."""
    got = sorted(table.items(), key=lambda kv: -kv[1][0])
    return [[k[:120], us / 1e3, calls] for k, (us, calls) in got[:n]]


def ssd_bf16_cases(shape=None, cases=SSD_BF16_CASES,
                   model=None) -> list[dict]:
    """``ssd_chunk_scan`` at bf16 (x, B and C bf16; dt, a and D fp32) at the
    serving shape, on each path of SSD_BF16_CASES: the plan's path
    (``last_plan``) and the profiled kernels (``_bf16_tc`` on the
    tensor-core path only), y within SSD_TOL plus one bf16 ulp of the plain
    version, the fp32 state within SSD_TOL, two calls bitwise equal; on the
    tensor-core path also a float64 witness: y before its rounding and the
    state no farther from the float64 scan than the plain fp32 version,
    +25%.  The bound: the scan's bytes at the storage widths against its
    operations at the dense bf16 rate; beside it the tensor-core design's
    own floor (its wgmma work at that rate) and the host ms of an eager
    call.  ``shape``: (B, L, H, P, N, q_chunk), the serving shape
    SSD_CASES[0] if None; ``model`` names another model's shape."""
    import torch
    from repro_torch.kernels import ssd_chunk
    B, L, H, P, N, q = shape or SSD_CASES[0]
    records = []
    for misaligned, path in cases:
        ins = ssd_inputs(B, L, H, P, N, seed=L + H + 1)
        for i in (0, 3, 4):
            ins[i] = ins[i].to(torch.bfloat16)
        if misaligned:        # a view 8 bytes past a 16-byte boundary
            buf = torch.empty(ins[0].numel() + 4, dtype=torch.bfloat16,
                              device="cuda")
            ins[0] = buf[4:].view(ins[0].shape).copy_(ins[0])
        y, h = ssd_chunk.ssd_chunk_scan(*ins, q_chunk=q)
        plan = ssd_chunk.ssd_chunk_scan.last_plan
        again = ssd_chunk.ssd_chunk_scan(*ins, q_chunk=q)
        torch.cuda.synchronize()
        repeat = bool(torch.equal(y, again[0]) and torch.equal(h, again[1]))
        wy, wh = ssd_chunk.ssd_chunk_scan_plain(*ins, q_chunk=q)
        excess = bf16_excess(y, wy, SSD_TOL)
        err_h = max_abs_diff(h, wh, "bf16 ssd_chunk_scan h_final")
        err_y = max_abs_diff(y.float(), wy.float(), "bf16 ssd_chunk_scan y")
        del again, wy, wh

        def call(ins=ins):
            return ssd_chunk.ssd_chunk_scan(*ins, q_chunk=q)

        _, _, kernels = profiled_us(lambda: call, ["ssd_chunk_scan_kernel"],
                                    table=True)
        names = sorted(n for n in kernels if "ssd_chunk_scan_kernel" in n)
        tc = any("ssd_chunk_scan_kernel_bf16_tc" in n for n in names)
        case = dict(B=B, L=L, H=H, P=P, N=N, q_chunk=q, Q=plan["Q"],
                    dtype="bf16", model=model, path=plan["path"],
                    misaligned=misaligned,
                    smem=plan["smem"], kernel_names=names,
                    max_abs_err_y=err_y, max_abs_err_h=err_h,
                    y_excess_past_tol_and_ulp=excess,
                    repeat_bit_equal=repeat, host_ms=host_ms(call, 20),
                    host_parts_us=host_parts(call, 50))
        if path == "tensor_cores":
            yf, hf = ssd_chunk.ssd_chunk_scan(*ins, q_chunk=q,
                                              y_dtype=torch.float32)
            torch.cuda.synchronize()
            # the fp32-y instantiation is the served one but for its store
            case["unrounded_rounds_to_served"] = bool(
                torch.equal(yf.bfloat16(), y) and torch.equal(hf, h))
            py, ph = ssd_chunk.ssd_chunk_scan_plain(
                *(t.float() for t in ins), q_chunk=q)
            fy, fh = ssd_chunk.ssd_chunk_scan_plain(
                *(t.double() for t in ins), q_chunk=q)
            case["f64_witness"] = {
                "kernel_vs_f64": [max_abs_diff(yf.double(), fy, "witness"),
                                  max_abs_diff(hf.double(), fh, "witness")],
                "plain_vs_f64": [max_abs_diff(py.double(), fy, "witness"),
                                 max_abs_diff(ph.double(), fh, "witness")]}
            case["pieces"] = plan["pieces"]
            case["design_floor_ms"] = plan["wgmma_flop"] / PEAK_BF16_FLOPS \
                * 1e3
            del yf, hf, py, ph, fy, fh
        print("ssd kernel check " + json.dumps(case), flush=True)
        if plan["path"] != path or tc != (path == "tensor_cores"):
            raise RuntimeError(f"bf16 ssd_chunk_scan took {plan['path']} "
                               f"with kernels {names}, not {path}")
        if excess > 0 or err_h > SSD_TOL or not repeat:
            raise RuntimeError(f"bf16 ssd_chunk_scan disagrees with its "
                               f"plain version or itself: {case}")
        if case.get("unrounded_rounds_to_served") is False:
            raise RuntimeError(f"bf16 ssd_chunk_scan's unrounded y does not "
                               f"round to its served y: {case}")
        if "f64_witness" in case and any(
                k > 1.25 * w for k, w in zip(
                    case["f64_witness"]["kernel_vs_f64"],
                    case["f64_witness"]["plain_vs_f64"])):
            raise RuntimeError(f"bf16 ssd_chunk_scan is further from "
                               f"float64 than its plain version: {case}")
        ops, nbytes = ssd_cost(B, L, H, P, N, plan["Q"])
        # x, B, C and y at 2 bytes: half of those terms of the fp32 count
        nbytes -= 2 * (2 * B * L * H * P + 2 * B * L * N)
        del y, h
        records.append(_lm_record(
            "ssd_chunk_scan", case, max(err_y, err_h), call,
            lambda ins=ins: ssd_chunk.ssd_chunk_scan_plain(*ins, q_chunk=q),
            nbytes=nbytes, ops=ops, peak=PEAK_BF16_FLOPS))
        del ins
    return records


def ssd_kernel_entry(records) -> dict:
    """The ``kernels`` entry of ``ssd_chunk_scan`` at the serving shape."""
    records = [r for r in records if r.get("dtype") != "bf16"]
    (rec,) = [r for r in records if (r["B"], r["L"]) == (LM_B * LM_S,
                                                         MB_PROMPT)]
    _, src, replaces = LM_KERNELS["ssd_chunk_scan"]
    return {
        "name": "ssd_chunk_scan", "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{src}",
        "replaces": replaces,
        "shape": "mamba2-370m prefill: [64, 512, 32, 64], N=128, Q=256 "
                 "(two chunks) fp32; L=320 (Q=160) and a small odd shape "
                 "in the report",
        "launches": None,
        "max_abs_err": max(r["max_abs_err"] for r in records),
        "ms": rec["kernel_ms"], "device_ms": rec["kernel_device_ms"],
        "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
        "bound_by": rec["bound_by"], "library_ms": None,
        "library_device_ms": None, "kernel_ms": rec["kernel_ms"]}


def _qwen3_want(L):
    """Launches of a qwen3 ``generate``: the attention-site mask and the
    SwiGLU gate/up product a layer at prefill and at each decode step, the
    decode attention a layer a decode step."""
    return {"masked_activation": L * (1 + LM_NEW),
            "mcd_matmul": L * (1 + LM_NEW),
            "decode_attention": L * LM_NEW}


def _mamba_want(L):
    """Launches of a mamba2 ``generate``: the mixer-site mask a layer at
    prefill and at each decode step, the SSD scan a layer at prefill
    (decode is the plain recurrent update)."""
    return {"masked_activation": L * (1 + LM_NEW), "ssd_chunk_scan": L}


QWEN3_KERNELS = (["masked_activation", "mcd_matmul"],
                 ["masked_activation", "mcd_matmul", "decode_attention"])
MAMBA_KERNELS = (["masked_activation", "ssd_chunk_scan"],
                 ["masked_activation"])


def lm_serving_phase(report, dev):
    """qwen3-1.7b at full width through ``BayesianEngine.generate``, fp32."""
    return serve_lm(report, dev, "qwen3-1.7b", LM_PROMPT, _qwen3_want,
                    *QWEN3_KERNELS, "serving_lm")


def mamba_serving_phase(report, dev):
    """mamba2-370m at full width through ``BayesianEngine.generate``,
    fp32."""
    return serve_lm(report, dev, "mamba2-370m", MB_PROMPT, _mamba_want,
                    *MAMBA_KERNELS, "serving_mamba")


def lm_bf16_serving_phase(report, dev):
    """qwen3-1.7b at full width in bf16, the fp32 cell's traffic."""
    return serve_lm(report, dev, "qwen3-1.7b", LM_PROMPT, _qwen3_want,
                    *QWEN3_KERNELS, "serving_lm_bf16", dtype="bf16")


def mamba_bf16_serving_phase(report, dev):
    """mamba2-370m at full width in bf16, the fp32 cell's traffic."""
    return serve_lm(report, dev, "mamba2-370m", MB_PROMPT, _mamba_want,
                    *MAMBA_KERNELS, "serving_mamba_bf16", dtype="bf16")


ZOO_CHILD_TIMEOUT = 600   # seconds; phases 15 and 16 take ~80 on the card


def zoo_serving_phases(report, dev, dry=None):
    """Phases 15 and 16, then 18, in a fresh process of this script
    (``--zoo-child``), as phases 10 and 11 run theirs: late in this
    process torch.profiler drops the first records of most profiles (the
    llama3 decode profile then counts 159 of 160 mask launches each time
    it is taken again, until the cache has no positions left), and a
    fresh process profiles as the first phases of this one do; phase 18
    rides along to run beside phase 17a too.  The child resets and reads
    the launch counts around each main path as this process does; its
    records and seconds come back here, its launches summed (15 and 16's
    also as ``report["zoo_launches"]``, 18's as
    ``report["encdec_launches"]``)."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()            # the jamba cut peaks at ~63 GB
    if dry is not None:
        dry.start()                     # phase 17a beside the child
    got = _child("--zoo-child", timeout=ZOO_CHILD_TIMEOUT)
    report.update(got["report"])
    report["phase_s"].update(got["phase_s"])
    report["zoo_launches"] = got["launches"]["zoo"]
    report["encdec_launches"] = got["launches"]["encdec"]
    return {k: v + report["encdec_launches"][k]
            for k, v in report["zoo_launches"].items()}


def zoo_child(out):
    """``--zoo-child``'s body: phases 15 and 16, then 18; writes their
    records, launch counts (15 and 16's as ``zoo``, 18's as ``encdec``)
    and seconds to ``out``."""
    import torch
    dev = torch.device("cuda")
    report = {"card": card_line()}
    launches = {group: {name: 0 for name in ALL_KERNELS}
                for group in ("zoo", "encdec")}
    phase_s = {}
    for name, fn, group in (("15", llama3_serving_phase, "zoo"),
                            ("16", jamba_serving_phase, "zoo"),
                            ("18", encdec_serving_phase, "encdec")):
        t = time.perf_counter()
        for kernel, v in fn(report, dev).items():
            launches[group][kernel] += v
        phase_s[name] = time.perf_counter() - t
    del report["card"]
    with open(out, "w") as fh:
        json.dump({"report": report, "launches": launches,
                   "phase_s": phase_s}, fh)


def llama3_serving_phase(report, dev):
    """Phase 15: llama3-8b at full width in bf16, phase 7b's traffic."""
    return serve_lm(report, dev, "llama3-8b", LM_PROMPT, _qwen3_want,
                    *QWEN3_KERNELS, "serving_llama3", dtype="bf16",
                    graph_runs=LM_GRAPH_RUNS_ZOO)


# -- phase 18: the encoder–decoder and VLM paths ---------------------------

# qwen3-1.7b's published widths with the audio / vlm fields set here (a
# fixture: neither package's registry has such a config), bf16, 8 prompts
# x the config's 8 chains, 16-token prompts, 8 new tokens.
ENCDEC_PROMPT, ENCDEC_NEW = 16, 8
ENCDEC_LAYERS = 2       # of qwen3-1.7b's 28: the depth cut, each side
ENCODER_SEQ = 1500      # Whisper's encoder output for 30 s of audio
                        # (Radford et al. 2022, "Robust Speech Recognition
                        # via Large-Scale Weak Supervision")
VLM_PATCHES = 256       # PaliGemma's image tokens at 224 px (Beyer et al.
                        # 2024)
ENCDEC_GRAPH_RUNS = 1   # generate runs a side, graph and eager in turns
ENCDEC_STEP_ITERS = 20  # back-to-back graph replays timed by CUDA events
# The prefill's state (the cross K/V, every cache) on the ``cuda`` backend
# against ``reference``: the backends differ only where mcd_matmul's fp32
# gate/up sums, in another order than cuBLAS's, round to another bf16
# activation, a 1-ulp flip here and there through 2 layers; each tensor
# within this many bf16 ulps of its largest magnitude.
ENCDEC_STATE_ULPS = 4


def encdec_config(family):
    """qwen3-1.7b's config with its depth cut to ENCDEC_LAYERS and the
    ``audio`` (encoder stages, ``encoder_seq``) or ``vlm``
    (``num_patches``) fields set."""
    from repro_torch.configs import get_config
    from repro_torch.models.config import Stage
    base = get_config("qwen3-1.7b")
    if family == "audio":
        return base.replace(
            name=f"{base.name}-encdec", family="audio",
            stages=(Stage(("dec_attn.cross.mlp",), ENCDEC_LAYERS),),
            encoder_stages=(Stage(("enc_attn.mlp",), ENCDEC_LAYERS),),
            encoder_seq=ENCODER_SEQ)
    return base.replace(name=f"{base.name}-vlm", family="vlm",
                        stages=(Stage(("attn.mlp",), ENCDEC_LAYERS),),
                        num_patches=VLM_PATCHES)


def _encdec_want(cfg):
    """Launches of an encoder–decoder or VLM ``generate``: the prefill
    masks every block's attention site (the encoder's too) and a cross
    block's cross site, and runs every MLP's gate/up product; each decode
    step masks a decoder block's sites, runs its MLP and its decode
    attention."""
    enc = sum(st.num_layers for st in cfg.encoder_stages)
    dec = cfg.num_layers
    sites = dec * (2 if cfg.encoder_stages else 1)
    return {"masked_activation": enc + sites * (1 + ENCDEC_NEW),
            "mcd_matmul": enc + dec * (1 + ENCDEC_NEW),
            "decode_attention": dec * ENCDEC_NEW}


def _encdec_inputs(cfg, rng, dev, dtype):
    """A request's frames [LM_B, encoder_seq, D] or patches [LM_B,
    num_patches, D]: seeded normal draws, as the reference launcher's, in
    the model's dtype on the card."""
    import torch
    name, n = (("frames", cfg.encoder_seq) if cfg.family == "audio"
               else ("patches", cfg.num_patches))
    a = rng.normal(size=(LM_B, n, cfg.d_model)).astype("float32")
    return {name: torch.as_tensor(a).to(dev, dtype)}


def _second_request(eng, params, cfg, prompts, inputs, first) -> dict:
    """Another request's frames (patches) on the engine whose graph holds
    the first request's state: the prefill must refill the static cross
    K/V and caches, so the replays equal an eager engine on the same
    request bit for bit, and the logits are not the first request's."""
    import torch
    from repro_torch.serve.engine import BayesianEngine
    eager = BayesianEngine(params, cfg, max_len=eng.max_len, seed=0,
                           device=eng.device, graphs=False)
    with no_plain_versions():
        g = eng.generate(prompts, ENCDEC_NEW, keep_logits=True, **inputs)
        e = eager.generate(prompts, ENCDEC_NEW, keep_logits=True, **inputs)
    for what, a, b in (("tokens", g.tokens, e.tokens),
                       ("logits", g.logits, e.logits),
                       ("entropy", g.predictive_entropy,
                        e.predictive_entropy),
                       ("MI", g.mutual_information, e.mutual_information)):
        if not torch.equal(a, b):
            raise RuntimeError(f"{cfg.name} second request: graph {what} "
                               "differ from eager")
    if torch.equal(g.logits, first.logits):
        raise RuntimeError(f"{cfg.name}: the second request gave the first "
                           "request's logits")
    return {"bit_equal_graph_vs_eager": True,
            "greedy_tokens": g.tokens.cpu().tolist(),
            "tokens_differing_from_first": int(
                (g.tokens != first.tokens).sum())}


def _cross_vs_decode_attention(cfg, kv) -> dict:
    """ROADMAP B2: a decode step's cross-attention is a plain blockwise
    pass over all encoder_seq keys, which computes what
    ``decode_attention`` computes at pos = encoder_seq - 1.  Both on one
    cross block's K/V from the serving state, q a seeded draw: their
    times (CUDA events) and distance.  Outside any launch count."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import layers
    k, v = kv
    g = torch.Generator(device=k.device).manual_seed(1)
    q = torch.randn((k.shape[0], cfg.num_heads, cfg.head_dim), generator=g,
                    device=k.device).to(k.dtype)

    def plain():
        return layers.blockwise_attention(q[:, None], k, v, causal=False)

    def kernel():
        return ops.flash_decode_attention(q, k, v, k.shape[1] - 1)

    err = max_abs_diff(plain()[:, 0].float(), kernel().float(),
                       "cross-attention vs decode_attention")
    return {"rows": k.shape[0], "keys": k.shape[1], "dtype": str(k.dtype),
            "plain_blockwise_ms": cuda_time_ms(plain, ENCDEC_STEP_ITERS),
            "decode_attention_ms": cuda_time_ms(kernel, ENCDEC_STEP_ITERS),
            "max_abs_diff": err}


def encdec_prefill_rows(cfg) -> int:
    """The rows phase 18's prefill newly gives the mask and ``mcd_matmul``:
    the encoder's 64 x encoder_seq, the VLM prefill's 64 x (patches +
    prompt)."""
    return LM_B * LM_S * (cfg.encoder_seq if cfg.family == "audio"
                          else ENCDEC_PROMPT + cfg.num_patches)


def encdec_kernel_cases(dev, g, key) -> list[dict]:
    """Phase 6's bf16 cases at the rows phase 18's prefill gives the
    kernels (``encdec_prefill_rows``: 64 x 1500, 64 x 272):
    ``masked_activation`` of [rows, d_model] bitwise equal to its plain
    version; ``mcd_matmul``'s gate/up product (K d_model, N 2 d_ff, fp32
    out) within MM_TOL of its plain version on the tile its plan picks.
    Each record names its config's prefill as its ``model``."""
    import torch
    from repro_torch.kernels import mcd_matmul
    records = []
    for family in ("audio", "vlm"):
        cfg = encdec_config(family)
        rows, model = encdec_prefill_rows(cfg), f"{cfg.name} prefill"
        records.append(bf16_mask_case(dev, g, key, rows, cfg.d_model, model))
        K_, N_ = cfg.d_model, 2 * cfg.d_ff
        w = (torch.randn((K_, N_), generator=g, device=dev)
             * K_ ** -0.5).to(torch.bfloat16)
        records.append(bf16_matmul_case(
            dev, g, key, rows, w, "tensor_cores",
            mcd_matmul.matmul_plan(rows, N_, K_, 2)["tile"], model))
        del w
    return records


class zeroed_at_rows:
    """Within the block the wrapper ``ops.<name>`` returns zeros for every
    call on ``rows`` rows (its kernel still launched): a kernel gone wrong
    at one shape of the path."""

    def __init__(self, name, rows):
        self.name, self.rows = name, rows

    def __enter__(self):
        from repro_torch.kernels import ops
        self.fn = fn = getattr(ops, self.name)

        def zeroed(x, *args, **kw):
            out = fn(x, *args, **kw)
            return out.zero_() if x.shape[0] == self.rows else out
        setattr(ops, self.name, zeroed)
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        setattr(ops, self.name, self.fn)
        return False


def _prefill_state_check(eng, cfg, prompts, inputs, rows) -> dict:
    """The prefill's DecodeState -- an encoder–decoder's cross K/V (what
    the encoder hands the decoder) and every cache -- on the ``cuda``
    backend against the ``reference`` backend's for the same request:
    each tensor within ENCDEC_STATE_ULPS bf16 ulps of its largest
    magnitude; the prefill's logits printed beside BF16_LOGIT_TOL.  Then
    the same with each kernel's wrapper returning zeros at the ``rows``
    this path newly gives it (the encoder's, the VLM prefill's): its
    state's distance, in tolerances, and its logits', printed beside the
    kernels'; each must be past the tolerance (the check sees it).  These
    launches compare the path with its plain version: no main path's."""
    import torch
    from repro_torch.models import backbone
    ctx = eng._ctx(LM_B, LM_S)
    tokens = eng._tile(prompts, LM_S)
    tiled = {k: eng._tile(v, LM_S) for k, v in inputs.items()}

    def run(backend):
        lg, st = backbone.prefill(eng.params, cfg, tokens, ctx, eng.max_len,
                                  **tiled, backend=backend)
        return lg.float(), list(_leaves([st.caches, st.cross]))

    want_lg, want = run("reference")
    tols = [_ulps_of_largest(t, ENCDEC_STATE_ULPS) for t in want]

    def distance(what, wrapper=None):
        with no_plain_versions():
            if wrapper is None:
                lg, got = run("cuda")
            else:
                with zeroed_at_rows(wrapper, rows):
                    lg, got = run("cuda")
        return {"state_in_tolerances": max(
                    max_abs_diff(a.float(), b.float(),
                                 f"{cfg.name} prefill state {what}") / tol
                    for a, b, tol in zip(got, want, tols)),
                "prefill_logits": max_abs_diff(lg, want_lg,
                                               f"{cfg.name} {what} logits")}

    out = {"state_ulps": ENCDEC_STATE_ULPS, "state_tensors": len(want),
           "logit_tol": BF16_LOGIT_TOL, "zeroed_at_rows": rows,
           "cuda": distance("cuda")}
    for kernel, wrapper in (("masked_activation", "mcd_mask_apply"),
                            ("mcd_matmul", "mcd_dense")):
        out[f"{kernel}_zeroed"] = distance(f"{kernel} zeroed", wrapper)
    print(f"{cfg.name} prefill state vs reference " + json.dumps(out),
          flush=True)
    if out["cuda"]["state_in_tolerances"] > 1:
        raise RuntimeError(f"{cfg.name}: the prefill state is "
                           f"{out['cuda']} tolerances from the reference "
                           "backend's")
    for kernel in ("masked_activation", "mcd_matmul"):
        if out[f"{kernel}_zeroed"]["state_in_tolerances"] <= 1:
            raise RuntimeError(f"{cfg.name}: {kernel} zeroed at {rows} rows "
                               "leaves the prefill state within tolerance")
    return out


def serve_encdec(report, dev, family, key):
    """Phase 18a (``audio``) or 18b (``vlm``): see the module docstring.
    Returns the main path's launch counts."""
    import numpy as np
    import torch
    from repro_torch.models import backbone
    from repro_torch.serve.engine import BayesianEngine

    cfg = encdec_config(family)
    if cfg.mcd.n_samples != LM_S:
        raise RuntimeError(f"{cfg.name} serves {cfg.mcd.n_samples} chains")
    torch.cuda.reset_peak_memory_stats()
    params = backbone.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev,
        dtype=torch.bfloat16)
    n_params = sum(t.numel() for t in _leaves(params))
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (LM_B, ENCDEC_PROMPT),
                           dtype=np.int32)
    inputs = _encdec_inputs(cfg, rng, dev, torch.bfloat16)
    other = _encdec_inputs(cfg, rng, dev, torch.bfloat16)
    start = ENCDEC_PROMPT + cfg.num_patches * (family == "vlm")
    max_len = start + ENCDEC_NEW
    eng = BayesianEngine(params, cfg, max_len=max_len, seed=0, device=dev)
    want = _encdec_want(cfg)
    res, counts, again = _served(eng, cfg, prompts, want, ENCDEC_NEW,
                                 inputs)
    peak = torch.cuda.max_memory_allocated()
    ref = BayesianEngine(params, cfg, max_len=max_len, seed=0, device=dev,
                         backend="reference").generate(
        prompts, ENCDEC_NEW, teacher_tokens=res.tokens, keep_logits=True,
        **inputs)
    dev_ref = _deviation(again, ref, key)
    if (dev_ref["logits"] > BF16_LOGIT_TOL
            or max(dev_ref["entropy"], dev_ref["mi"]) > BF16_UNC_TOL):
        raise RuntimeError(f"{cfg.name} vs reference: {dev_ref} (tol "
                           f"{BF16_LOGIT_TOL}, {BF16_UNC_TOL})")
    flips = int((ref.tokens != res.tokens).sum())
    del ref
    graph_vs_eager = lm_graph_turns(eng, params, cfg, prompts, res, again,
                                    want, runs=ENCDEC_GRAPH_RUNS,
                                    n_new=ENCDEC_NEW, inputs=inputs)
    second = _second_request(eng, params, cfg, prompts, other, again)
    del again
    (entry,) = eng._graphs.values()

    def step():             # one decode step at the last position served
        entry.state.pos.fill_(max_len - 1)
        entry.step.replay()

    step_ms = cuda_time_ms(step, ENCDEC_STEP_ITERS)
    steps_ms = np.asarray(res.decode_s) * 1e3
    state_check = _prefill_state_check(eng, cfg, prompts, inputs,
                                       encdec_prefill_rows(cfg))
    depth = (f"depth 28 -> {cfg.num_layers} + "
             f"{sum(st.num_layers for st in cfg.encoder_stages)}"
             if family == "audio" else f"depth 28 -> {cfg.num_layers}")
    out = {"card": report["card"], "arch": cfg.name, "family": family,
           "reduced": depth, "params": n_params, "d_model": cfg.d_model,
           "vocab": cfg.vocab_size, "dtype": "bfloat16",
           "encoder_seq": cfg.encoder_seq, "num_patches": cfg.num_patches,
           "requests": LM_B, "chains": LM_S, "rows": LM_B * LM_S,
           "prompt_len": ENCDEC_PROMPT, "new_tokens": ENCDEC_NEW,
           "max_len": max_len, "p": cfg.mcd.p,
           "launches_by_kernel": counts,
           "prefill_ms": res.prefill_s * 1e3,
           "decode_ms_per_token_p50": float(np.percentile(steps_ms, 50)),
           "decode_ms_per_token_p95": float(np.percentile(steps_ms, 95)),
           "decode_step_graph_device_ms": step_ms,
           "max_memory_allocated_gb": peak / 1e9,
           "max_abs_diff_vs_reference": dev_ref,
           "tolerance_vs_reference": {"logits": BF16_LOGIT_TOL,
                                      "entropy_mi": BF16_UNC_TOL},
           "greedy_tokens_differing_in_reference": flips,
           "greedy_tokens": res.tokens.cpu().tolist(),
           "entropy_mean": float(res.predictive_entropy.mean()),
           "mi_mean": float(res.mutual_information.mean()),
           "graph_vs_eager": graph_vs_eager, "second_request": second,
           "prefill_state_vs_reference": state_check}
    if family == "audio":
        out["decode_cross_attention"] = _cross_vs_decode_attention(
            cfg, entry.state.cross[0][0][0])
    report[key] = out
    print(f"{key} " + json.dumps(out), flush=True)
    return counts


def encdec_serving_phase(report, dev):
    """Phase 18: the encoder–decoder (18a), then the VLM (18b); their
    summed launch counts."""
    import gc
    import torch
    counts = {}
    for key, family in (("serving_encdec", "audio"), ("serving_vlm", "vlm")):
        for kernel, v in serve_encdec(report, dev, family, key).items():
            counts[kernel] = counts.get(kernel, 0) + v
        gc.collect()
        torch.cuda.empty_cache()
    return counts


# The kernels' plain versions, by module: none may run on a main path on
# the card (a wrapper given a CUDA tensor launches its kernel or raises).
PLAIN_VERSIONS = {"bernoulli_mask": ["masked_activation_plain"],
                  "mcd_matmul": ["masked_activation_plain",
                                 "mcd_matmul_plain"],
                  "decode_attn": ["decode_attention_plain"],
                  "ssd_chunk": ["ssd_chunk_scan_plain"]}


class no_plain_versions:
    """Within the block every plain version of an LM kernel raises when
    called (each module's name for it replaced, then restored)."""

    def __enter__(self):
        import importlib
        self.saved = []
        for mod_name, names in PLAIN_VERSIONS.items():
            mod = importlib.import_module(f"repro_torch.kernels.{mod_name}")
            for name in names:
                self.saved.append((mod, name, getattr(mod, name)))

                def refuse(*_, name=name, **__):
                    raise RuntimeError(f"{name} ran on a main path on the "
                                       "card")
                setattr(mod, name, refuse)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)
        return False


def _tree_to(tree, dtype):
    """A copy of a parameter tree with its bf16 leaves in ``dtype`` (fp32
    leaves stay as they are)."""
    import torch
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.dtype == torch.bfloat16 else tree
    if isinstance(tree, dict):
        return {k: _tree_to(v, dtype) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_to(v, dtype) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_to(v, dtype) for v in tree)
    return tree


def _deviation(a, b, what) -> dict:
    """max |a - b| of the logits, entropy and MI of two GenerationResults."""
    return {"logits": max_abs_diff(a.logits, b.logits, f"{what} logits"),
            "entropy": max_abs_diff(a.predictive_entropy,
                                    b.predictive_entropy,
                                    f"{what} entropy"),
            "mi": max_abs_diff(a.mutual_information, b.mutual_information,
                               f"{what} mutual information")}


def _served(eng, cfg, prompts, want, n_new=LM_NEW, inputs=None):
    """The engine's main-path ``generate`` (``n_new`` tokens, no plain
    version of a kernel called; ``inputs`` its frames or patches), its
    launch counts held to ``want``, its outputs finite and in range, then
    the run teacher-forced on its own tokens (keeping its logits), which
    must repeat them.  Returns (the run, its launch counts, the forced
    run)."""
    import numpy as np
    import torch
    inputs = inputs or {}
    reset_launches()                          # count the main path only
    with no_plain_versions():
        res = eng.generate(prompts, n_new, **inputs)
    counts = read_launches()
    if {k: v for k, v in counts.items() if v} != want:
        raise RuntimeError(f"{cfg.name} serving launched {counts}, expected "
                           f"{want}")
    ent, mi = res.predictive_entropy, res.mutual_information
    if res.tokens.shape != (prompts.shape[0], n_new) or not (
            torch.isfinite(ent).all() and torch.isfinite(mi).all()):
        raise RuntimeError(f"{cfg.name} serving gave malformed outputs")
    if (ent.min() < -1e-5 or ent.max() > np.log(cfg.vocab_size) + 1e-4
            or mi.min() < -1e-4 or (mi > ent + 1e-4).any()):
        raise RuntimeError("entropy / mutual information out of range")
    again = eng.generate(prompts, n_new, teacher_tokens=res.tokens,
                         keep_logits=True, **inputs)
    if not torch.equal(again.tokens, res.tokens):
        raise RuntimeError(f"{cfg.name}: the kernel run did not repeat its "
                           "own tokens")
    return res, counts, again


def serve_lm(report, dev, arch, prompt_len, want_of, prefill_kernels,
             decode_kernels, key, dtype="fp32", graph_runs=None):
    """One LM at full width through ``BayesianEngine.generate``: 8 prompts
    of ``prompt_len`` tokens x the config's chains, LM_NEW new tokens, the
    launch counts ``want_of(layers)`` (no plain version of a kernel called
    meanwhile), the run repeated on its own tokens, the reference backend
    teacher-forced within LOGIT_TOL / UNC_TOL (at bf16 BF16_LOGIT_TOL /
    BF16_UNC_TOL, printed beside the reference's own distance from fp32 on
    the same weights), times, peak memory and profiles; ``graph_runs``
    runs a side of graph and eager (default LM_GRAPH_RUNS, at bf16
    LM_GRAPH_RUNS_BF16)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import backbone
    from repro_torch.serve.engine import BayesianEngine

    cfg = get_config(arch)
    S_LM = cfg.mcd.n_samples
    if S_LM != LM_S:
        raise RuntimeError(f"{arch} serves {S_LM} chains, not {LM_S}")
    bf16 = dtype == "bf16"
    logit_tol, unc_tol = ((BF16_LOGIT_TOL, BF16_UNC_TOL) if bf16
                          else (LOGIT_TOL, UNC_TOL))
    torch.cuda.reset_peak_memory_stats()
    params = backbone.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev,
        dtype=torch.bfloat16 if bf16 else torch.float32)
    n_params = sum(t.numel() for t in _leaves(params))
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (LM_B, prompt_len), dtype=np.int32)
    max_len = prompt_len + LM_NEW
    eng = BayesianEngine(params, cfg, max_len=max_len, seed=0, device=dev)
    want = want_of(cfg.num_layers)
    res, counts, again = _served(eng, cfg, prompts, want)
    peak = torch.cuda.max_memory_allocated()
    ssd_path = None
    if "ssd_chunk_scan" in prefill_kernels:   # the prefill's scan path
        from repro_torch.kernels import ssd_chunk
        plan = getattr(ssd_chunk.ssd_chunk_scan, "last_plan", None)
        ssd_path = plan and plan["path"]      # None: a tree before plans
        if ssd_path not in (None, "tensor_cores" if bf16 else "cuda_cores"):
            raise RuntimeError(f"{arch} prefill's SSD scan took {ssd_path}")
    ent, mi = res.predictive_entropy, res.mutual_information
    # The reference backend on the kernel run's tokens, within tolerance.
    ref = BayesianEngine(params, cfg, max_len=max_len, seed=0, device=dev,
                         backend="reference").generate(
        prompts, LM_NEW, teacher_tokens=res.tokens, keep_logits=True)
    dev_ref = _deviation(again, ref, "LM")
    d_logits, d_ent, d_mi = dev_ref["logits"], dev_ref["entropy"], \
        dev_ref["mi"]
    ref_vs_fp32 = None
    if bf16:
        # the reference backend on the same weights held in fp32
        ref32 = BayesianEngine(_tree_to(params, torch.float32), cfg,
                               max_len=max_len, seed=0, device=dev,
                               backend="reference").generate(
            prompts, LM_NEW, teacher_tokens=res.tokens, keep_logits=True)
        ref_vs_fp32 = _deviation(ref, ref32, "LM bf16 vs fp32")
        del ref32
        print(f"{key} cuda vs reference {json.dumps(dev_ref)} (tol "
              f"{logit_tol}, {unc_tol}); the reference's own bf16 vs fp32 "
              f"{json.dumps(ref_vs_fp32)}", flush=True)
    if d_logits > logit_tol or max(d_ent, d_mi) > unc_tol:
        raise RuntimeError(f"LM serving vs reference: logits {d_logits}, "
                           f"entropy {d_ent}, MI {d_mi} (tol {logit_tol}, "
                           f"{unc_tol})")
    flips = int((ref.tokens != res.tokens).sum())
    del ref
    graph_vs_eager = lm_graph_turns(
        eng, params, cfg, prompts, res, again, want,
        runs=graph_runs or (LM_GRAPH_RUNS_BF16 if bf16 else LM_GRAPH_RUNS))
    del again

    steps_ms = np.asarray(res.decode_s) * 1e3
    decode_s = float(np.sum(res.decode_s))
    floor = _decode_bytes(params, cfg, LM_B * S_LM, prompt_len + LM_NEW // 2,
                          2 if bf16 else 4)
    out = {"card": report["card"], "arch": cfg.name, "params": n_params,
           "layers": cfg.num_layers, "d_model": cfg.d_model,
           "vocab": cfg.vocab_size,
           "dtype": "bfloat16" if bf16 else "float32", "requests": LM_B,
           "chains": S_LM,
           "rows": LM_B * S_LM, "prompt_len": prompt_len,
           "new_tokens": LM_NEW, "p": cfg.mcd.p,
           "launches_by_kernel": counts, "ssd_path": ssd_path,
           "prefill_ms": res.prefill_s * 1e3,
           "decode_ms_per_token_p50": float(np.percentile(steps_ms, 50)),
           "decode_ms_per_token_p95": float(np.percentile(steps_ms, 95)),
           "decode_tokens_per_s": LM_B * LM_NEW / decode_s,
           "decode_chain_tokens_per_s": LM_B * S_LM * LM_NEW / decode_s,
           "tokens_per_s_with_prefill":
               LM_B * LM_NEW / (decode_s + res.prefill_s),
           "max_memory_allocated_gb": peak / 1e9,
           "card_memory_gb": torch.cuda.get_device_properties(
               dev).total_memory / 1e9,
           "decode_step_bytes": floor,
           "max_abs_diff_vs_reference": {"logits": d_logits,
                                         "entropy": d_ent, "mi": d_mi},
           "tolerance_vs_reference": {"logits": logit_tol,
                                      "entropy_mi": unc_tol},
           "reference_bf16_vs_fp32": ref_vs_fp32,
           "greedy_tokens_differing_in_reference": flips,
           "entropy_mean": float(ent.mean()), "mi_mean": float(mi.mean()),
           "graph_vs_eager": graph_vs_eager}
    report[key] = out
    print(f"{key} " + json.dumps(out), flush=True)
    out.update(profile_lm(eng, prompts, prefill_kernels, decode_kernels))
    graph_vs_eager["profiled_decode_step_graph"] = profile_lm(
        eng, prompts, prefill_kernels, decode_kernels,
        graph=True)["profiled_decode_step"]
    busy = graph_vs_eager["profiled_decode_step_graph"]["device_busy_ms"]
    out["decode_step_device_ms_vs_floor"] = {
        "device_busy_ms": busy, "floor_ms": floor["floor_ms"],
        "ratio": busy / floor["floor_ms"]}
    print(f"{key} profile " + json.dumps(out), flush=True)
    return counts


LM_GRAPH_RUNS = 1   # generate runs a side, graph and eager in turns (one,
                    # as GRAPH_RUNS)


def int8_kv_phase(report, dev):
    """qwen3-1.7b at full width in bf16 with the int8 KV cache: from
    ``init_decode_state(kv_quant=True)``, INT8_STEPS ``decode_step`` calls
    teacher-forced on seeded tokens, the ``cuda`` backend (the codes
    dequantized to bf16 by plain PyTorch, then the bf16 ``decode_attention``
    kernel; no plain version of a kernel called) and the ``reference``
    backend side by side: at every step the logits, entropy and MI within
    BF16_LOGIT_TOL / BF16_UNC_TOL.  The cache bytes beside a bf16 cache's;
    launches counted over the kernel backend's steps."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import mcd
    from repro_torch.core.uncertainty import classification_summary
    from repro_torch.models import backbone, layers

    cfg = get_config("qwen3-1.7b")
    rows = LM_B * LM_S
    max_len = LM_PROMPT + LM_NEW
    params = backbone.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev,
        dtype=torch.bfloat16)
    ctx = layers.Ctx(mcd.sample_rows(LM_B, LM_S, device=dev), 0, cfg.mcd)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (INT8_STEPS, LM_B), dtype=np.int32)).to(dev)
    states = {b: backbone.init_decode_state(cfg, rows, max_len,
                                            kv_quant=True, device=dev)
              for b in ("cuda", "reference")}
    cache_bytes = sum(t.nbytes for stage in states["cuda"].caches
                      for rep in stage for c in rep for t in c)
    bf16_bytes = 2 * cfg.num_layers * rows * max_len * cfg.num_kv_heads \
        * cfg.head_dim * 2
    worst = {"logits": 0.0, "entropy": 0.0, "mi": 0.0}
    want = {"masked_activation": cfg.num_layers * INT8_STEPS,
            "mcd_matmul": cfg.num_layers * INT8_STEPS,
            "decode_attention": cfg.num_layers * INT8_STEPS}
    counts = {name: 0 for name in ALL_KERNELS}
    step_ms = []
    for i in range(INT8_STEPS):
        fed = toks[i][None].expand(LM_S, LM_B).reshape(rows, 1)
        out = {}
        for backend in ("cuda", "reference"):
            reset_launches()
            t0 = time.perf_counter()
            with no_plain_versions():
                lg, states[backend] = backbone.decode_step(
                    params, cfg, fed, states[backend], ctx, backend)
            torch.cuda.synchronize()
            if backend == "cuda":
                step_ms.append((time.perf_counter() - t0) * 1e3)
                for k, v in read_launches().items():
                    counts[k] += v
            out[backend] = (lg[:, 0].float(), classification_summary(
                lg[:, 0].reshape(LM_S, LM_B, -1).float()))
        (a, sa), (b, sb) = out["cuda"], out["reference"]
        for what, x, y in (("logits", a, b),
                           ("entropy", sa.predictive_entropy,
                            sb.predictive_entropy),
                           ("mi", sa.mutual_information,
                            sb.mutual_information)):
            worst[what] = max(worst[what],
                              max_abs_diff(x, y, f"int8 KV {what}"))
        del out, lg
    counts = {k: v for k, v in counts.items() if v}
    if counts != want:
        raise RuntimeError(f"int8 KV decode launched {counts}, expected "
                           f"{want}")
    k8, ks = states["cuda"].caches[0][0][0][:2]
    if not (k8.dtype == torch.int8 and ks[:, INT8_STEPS:].eq(0).all()
            and ks[:, :INT8_STEPS].abs().min() > 0):
        raise RuntimeError("the int8 cache was not written at each step")
    out = {"card": report["card"], "arch": cfg.name, "dtype": "bfloat16",
           "kv_cache": "int8 codes, bf16 scales", "rows": rows,
           "steps": INT8_STEPS, "max_len": max_len,
           "launches_by_kernel": counts,
           "kv_cache_bytes": cache_bytes, "bf16_kv_cache_bytes": bf16_bytes,
           "max_abs_diff_vs_reference": worst,
           "tolerance_vs_reference": {"logits": BF16_LOGIT_TOL,
                                      "entropy_mi": BF16_UNC_TOL},
           "eager_decode_ms_per_step_p50": float(np.percentile(step_ms, 50))}
    print("int8_kv " + json.dumps(out), flush=True)
    if worst["logits"] > BF16_LOGIT_TOL or max(
            worst["entropy"], worst["mi"]) > BF16_UNC_TOL:
        raise RuntimeError(f"int8 KV decode, cuda vs reference: {worst}")
    report["int8_kv"] = out
    del states, params
    return counts


def lm_graph_turns(eng, params, cfg, prompts, res, forced, want,
                   runs=LM_GRAPH_RUNS, n_new=LM_NEW, inputs=None) -> dict:
    """The decode step as the replay of one captured graph (``eng``, which
    captured it on its first decode step) against the same engine decoding
    eagerly, ``runs`` ``generate`` runs a side in turns (``n_new``
    tokens, ``inputs`` the frames or patches): every run's
    tokens equal to ``res.tokens``, its logits, entropy and mutual
    information bit-equal to ``forced`` (the graph run teacher-forced on
    them, keeping its logits), its launch counts ``want``.  Times: decode ms
    a token p50 / p95 of each side, pooled, and each run's first step."""
    import numpy as np
    import torch
    from repro_torch.serve.engine import BayesianEngine

    eager = BayesianEngine(params, cfg, max_len=eng.max_len, seed=0,
                           device=eng.device, graphs=False)
    sides = {"graph": [], "eager": []}
    for r in range(runs):
        for side in (("graph", "eager") if r % 2 == 0
                     else ("eager", "graph")):
            e = eng if side == "graph" else eager
            reset_launches()
            with no_plain_versions():
                run = e.generate(prompts, n_new, keep_logits=True,
                                 **(inputs or {}))
            counts = {k: v for k, v in read_launches().items() if v}
            if counts != want:
                raise RuntimeError(f"{cfg.name} {side} run launched "
                                   f"{counts}, expected {want}")
            if not torch.equal(run.tokens, res.tokens):
                raise RuntimeError(f"{cfg.name}: {side} tokens differ")
            for what, a, b in (
                    ("logits", run.logits, forced.logits),
                    ("entropy", run.predictive_entropy,
                     forced.predictive_entropy),
                    ("MI", run.mutual_information,
                     forced.mutual_information)):
                max_abs_diff(a, b, f"{cfg.name} {side} {what}")
                if not torch.equal(a, b):
                    raise RuntimeError(f"{cfg.name}: {side} {what} differ "
                                       "from the graph run's")
            sides[side].append((run.decode_s, run.prefill_s))
            del run
    if len(eng._graphs) != 1 or eager._graphs is not None:
        raise RuntimeError(f"{cfg.name}: {len(eng._graphs)} decode graphs")
    out = {"card": card_line(), "runs": runs,
           "bit_equal_graph_vs_eager": True, "tokens_equal": True}
    for side, runs in sides.items():
        ms = np.concatenate([np.asarray(d) for d, _ in runs]) * 1e3
        out[side] = {
            "decode_ms_per_token_p50": float(np.percentile(ms, 50)),
            "decode_ms_per_token_p95": float(np.percentile(ms, 95)),
            "decode_ms_per_token_p50_by_run": [
                float(np.percentile(np.asarray(d) * 1e3, 50))
                for d, _ in runs],
            "first_step_ms": [d[0] * 1e3 for d, _ in runs],
            "prefill_ms": [p * 1e3 for _, p in runs]}
    return out


def _leaves(tree):
    import torch
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def profile_lm(eng, prompts, prefill_kernels, decode_kernels,
               n_steps: int = 5, graph: bool = False,
               decode: bool = True) -> dict:
    """Device time inside one prefill, then inside ``n_steps`` decode steps
    as ``generate`` makes them (summary, argmax, the decode call, a device
    sync): the device's idle share and the time of each kernel the model
    launches there (``prefill_kernels``, ``decode_kernels``: a kernel that
    a span does not launch has no records, and a profile without records
    of a named kernel is refused).  Each decode profile taken again
    continues from the last position; not part of the launch count.
    ``graph``: the decode call is the replay of the engine's captured
    step (the prefill's state copied into its buffers, as ``generate``
    does); else ``backbone.decode_step`` eagerly.  ``decode=False``
    profiles the prefill alone."""
    import torch
    from repro_torch.core import mcd
    from repro_torch.core.uncertainty import classification_summary
    from repro_torch.models import backbone, layers

    cfg = eng.cfg
    B, S_LM = prompts.shape[0], cfg.mcd.n_samples
    ctx = layers.Ctx(mcd.sample_rows(B, S_LM, device=eng.device), eng.seed,
                     cfg.mcd)
    p = torch.as_tensor(prompts, device=eng.device)
    tiled = p[None].expand(S_LM, *p.shape).reshape(S_LM * B, -1)
    entry = eng._decode_graph(B, S_LM, p.dtype) if graph else None
    if entry is not None:
        if not entry.step.ready:
            raise RuntimeError("the engine has no captured decode step")
        ctx = entry.ctx
    live = {}

    def prefill():
        live.clear()

        def run():
            t0 = time.perf_counter()
            live["logits"], live["state"] = backbone.prefill(
                eng.params, cfg, tiled, ctx, eng.max_len)
            if entry is not None:
                eng._adopt(entry, live["state"])
                live["state"] = entry.state
            torch.cuda.synchronize()
            live["pos"] = prompts.shape[1]
            return (time.perf_counter() - t0) * 1e6
        return run

    def decode_span():
        if live["pos"] + n_steps > eng.max_len:
            raise RuntimeError("no cache positions left to profile")

        def run():
            t0 = time.perf_counter()
            for _ in range(n_steps):
                summ = classification_summary(
                    live["logits"][:, 0].reshape(S_LM, B, -1).float())
                tok = torch.argmax(summ.probs, dim=-1).to(p.dtype)
                fed = tok[None].expand(S_LM, B).reshape(S_LM * B, 1)
                if entry is None:
                    live["logits"], live["state"] = backbone.decode_step(
                        eng.params, cfg, fed, live["state"], ctx)
                else:
                    entry.token.copy_(fed)
                    live["logits"] = entry.step.replay()
                torch.cuda.synchronize()
                live["pos"] += 1
            return (time.perf_counter() - t0) * 1e6
        return run

    spans = [("prefill", prefill, 1, prefill_kernels),
             ("decode_step", decode_span, n_steps, decode_kernels)]
    if not decode:
        spans = spans[:1]
    if graph:
        prefill()()                   # the state to decode from, unprofiled
        spans = spans[1:]
    out = {}
    for what, prepare, calls, kernels in spans:
        matches = [None] + [n + "_kernel" for n in kernels]
        us, wall_us, table = profiled_us(prepare, matches, calls=calls,
                                         loose=(0,), table=True)
        out[f"profiled_{what}"] = {
            "calls": calls, "wall_ms": wall_us / calls / 1e3,
            "device_busy_ms": us[0] / calls / 1e3,
            "kernel_device_ms": {n: v / calls / 1e3
                                 for n, v in zip(kernels, us[1:])},
            "device_idle_share": 1.0 - us[0] / wall_us}
        # what the span's device time is made of
        out[f"profiled_{what}"]["top_kernels"] = top_kernels(table)
    return out


def profile_ticks(params, cfg, streams, dev, kernel_match,
                  n_ticks: int = 5, **engine_kw) -> dict:
    """Device time inside a few serving ticks (torch.profiler, CUDA
    activity): the kernel's share and the device's idle share of the
    tick's wall time.  Runs a fresh engine (a fresh one for each profile
    taken again; ``engine_kw`` go to it, and an engine that replays tick
    graphs is prewarmed first); not part of the launch count.
    """
    import numpy as np
    import torch
    from repro_torch.serve import StreamingEngine, prewarm

    engine_kw.setdefault("chunk_capacity", CHUNK)

    def prepare():
        eng = StreamingEngine(params, cfg, max_sessions=SESSIONS,
                              device=dev, **engine_kw)
        if eng._graphs is not None:
            prewarm(eng)
        sids = [f"p{k}" for k in range(SESSIONS)]
        for sid in sids:
            eng.open_session(sid)
        rng = np.random.default_rng(2)

        def tick():
            eng.step({sid: streams[k][eng.store.get(sid).steps:][
                :int(rng.integers(1, CHUNK + 1))]
                for k, sid in enumerate(sids)})

        tick()                               # warm: allocator, cuBLAS

        def run():
            t0 = time.perf_counter()
            for _ in range(n_ticks):
                tick()
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e6
        return run

    (dev_us, kern_us), wall_us = profiled_us(prepare, [None, kernel_match])
    return {"profiled_ticks": n_ticks,
            "profiled_tick_ms": wall_us / n_ticks / 1e3,
            "device_busy_ms_per_tick": dev_us / n_ticks / 1e3,
            "kernel_ms_per_tick": kern_us / n_ticks / 1e3,
            "device_idle_share": 1.0 - dev_us / wall_us}


# -- phases 13, 14: the MoE family --------------------------------------------

# The bound on a route flip: where the reference backend's own top-k set
# differs from the kernel run's, its probability gap between the k-th and
# the (k+1)-th expert.  fp32 olmoe: the backends differ by the decode
# attention's ulps (~1e-7 on probabilities of ~1/64); bf16 deepseek: by a
# bf16 ulp on a few activations a layer (mcd_matmul's sum order before the
# rounding), ~1e-4 on the router's probabilities.  bf16 jamba: the same
# bf16 ulps, and the SSD scan's and the decode attention's other sum
# orders before the MoE layer at position 2, at the bound deepseek has.
MOE_GAP_BOUND = {"olmoe-1b-7b": 1e-4, "deepseek-v2-lite-16b": 1e-2,
                 "jamba-1.5-large-398b": 1e-2}
MOE_GRAPH_RUNS = 1   # generate runs a side, graph and eager in turns


class RouteTap:
    """While entered, ``repro_torch.models.moe._dispatch`` is this object's
    own: the same routing (``moe._route``, ``moe._assign``) that records,
    for each call in order, the token's top-k expert set (sorted), its
    probability gap between the k-th and (k+1)-th expert, and the routes
    the capacity dropped.  With ``force`` (the calls of a run recorded
    before, one for one) the dispatch takes that run's experts instead of
    its own, weighted by its own probabilities renormalised over them: the
    two runs then route alike, and each token whose own choice differs is
    a recorded flip.  Only for eager runs: a graph replay calls no Python."""

    def __init__(self, force=None):
        self.force = force
        self.calls = []

    def __enter__(self):
        from repro_torch.models import moe
        self.moe, self.saved = moe, moe._dispatch
        moe._dispatch = self.dispatch
        return self

    def __exit__(self, *exc):
        self.moe._dispatch = self.saved
        return False

    def dispatch(self, flat, flat_router, router_w, cfg, C):
        import torch
        moe = self.moe
        E, K = cfg.num_experts, cfg.top_k
        probs, gate_vals, gate_idx = moe._route(flat_router, router_w, K)
        srt = torch.sort(probs, dim=-1, descending=True, stable=True).values
        counts = torch.zeros((E,), dtype=torch.int64,
                             device=probs.device).scatter_add_(
            0, gate_idx.reshape(-1), torch.ones_like(gate_idx.reshape(-1)))
        rec = {"routes": gate_idx.sort(dim=-1).values,
               "gap": srt[:, K - 1] - srt[:, K],
               "dropped": (counts - C).clamp(min=0).sum(),
               "gate_idx": gate_idx}
        if self.force is not None:
            gate_idx = self.force[len(self.calls)]["gate_idx"]
            gv = probs.gather(1, gate_idx)
            gate_vals = gv / torch.clamp(gv.sum(dim=-1, keepdim=True),
                                         min=1e-9)
        self.calls.append(rec)
        return (*moe._assign(flat, gate_vals, gate_idx, E, C), probs)


def route_flips(kernel_calls, ref_calls, n_moe, prompt_len, bound, what):
    """Each token whose top-k set differs between the two runs (call by
    call: the prefill's MoE layers, then each decode step's): its step
    (-1: the prefill), layer, chain row, position and both runs' gaps.
    Raises where the reference's gap passes ``bound`` (a flip that is no
    near-tie) or where a call without flips drops other routes.  Returns
    (flips, dropped routes [calls] of the kernel run, calls whose dropped
    routes were held equal)."""
    import torch
    if len(kernel_calls) != len(ref_calls):
        raise RuntimeError(f"{what}: {len(kernel_calls)} MoE calls against "
                           f"{len(ref_calls)}")
    flips, dropped, held = [], [], 0
    for c, (a, b) in enumerate(zip(kernel_calls, ref_calls)):
        step, layer = c // n_moe - 1, c % n_moe
        ra, rb = a["routes"].cpu(), b["routes"].cpu()
        diff = (ra != rb).any(dim=-1)
        da, db = int(a["dropped"]), int(b["dropped"])
        dropped.append(da)
        idx = torch.nonzero(diff).flatten()
        if not len(idx):
            held += 1
            if da != db:
                raise RuntimeError(f"{what}: step {step} layer {layer} "
                                   f"dropped {da} routes against {db} with "
                                   "no flip")
            continue
        gaps = zip(a["gap"].cpu()[idx].tolist(), b["gap"].cpu()[idx].tolist())
        for t, (g_k, g_r) in zip(idx.tolist(), gaps):
            row, at = ((t // prompt_len, t % prompt_len) if step < 0
                       else (t, prompt_len + step))
            flips.append({"step": step, "layer": layer, "row": row,
                          "position": at, "kernel": ra[t].tolist(),
                          "reference": rb[t].tolist(), "gap_reference": g_r,
                          "gap_kernel": g_k})
    bad = [f for f in flips if f["gap_reference"] > bound]
    if bad:
        raise RuntimeError(f"{what}: {len(bad)} route flips past a gap of "
                           f"{bound}: {bad[:4]}")
    return flips, dropped, held


def flip_summary(flips, bound) -> dict:
    """Route flips in numbers: how many, at the prefill and a decode step,
    the reference's gaps (quantiles and largest) and the first few."""
    import numpy as np
    gaps = np.asarray([f["gap_reference"] for f in flips])
    steps = [f["step"] for f in flips]
    return {"count": len(flips), "gap_bound": bound,
            "at_prefill": steps.count(-1),
            "decode_by_step": [steps.count(i) for i in range(LM_NEW)],
            "gap_reference_quantiles_50_90_99_100": (
                np.quantile(gaps, [0.5, 0.9, 0.99, 1.0]).tolist()
                if len(gaps) else None),
            "first": flips[:6]}


def _moe_layers(cfg) -> dict:
    """Blocks of each kind: attention, MLA and mamba mixers, dense and MoE
    FFNs, and the MoE FFNs with a shared expert."""
    kinds = [k for st in cfg.stages for k in st.pattern * st.repeat]
    n = {"attn": 0, "mla": 0, "mamba": 0, "mlp": 0, "moe": 0}
    for k in kinds:
        for part in k.split("."):
            n[part] += 1
    n["shared"] = n["moe"] if cfg.moe and cfg.moe.num_shared else 0
    return n


def _moe_want(cfg):
    """Launches of a ``generate`` (a prefill and LM_NEW decode steps): the
    site mask at every attention / MLA / mamba mixer and every routed MoE
    input, the masked gate/up product at every dense FFN and shared
    expert, the decode attention at every attention layer a decode step
    (MLA's latent attention is plain, as in the reference), the SSD scan
    at every mamba layer of the prefill (its decode update is plain)."""
    n = _moe_layers(cfg)
    want = {"masked_activation": (n["attn"] + n["mla"] + n["mamba"]
                                  + n["moe"]) * (1 + LM_NEW),
            "mcd_matmul": (n["mlp"] + n["shared"]) * (1 + LM_NEW),
            "decode_attention": n["attn"] * LM_NEW,
            "ssd_chunk_scan": n["mamba"]}
    return {k: v for k, v in want.items() if v}


def _decode_bytes(params, cfg, rows, positions, elem) -> dict:
    """The bytes a decode step must move at a cache of ``positions``: every
    weight once (every expert: the dense batched product reads all E x C
    slots' experts; of the embedding only the head, or the tied table,
    and 64 table rows), the caches up to the position, each mamba layer's
    state read and written, the logits out."""
    import torch
    from repro_torch.models import mamba2
    n = _moe_layers(cfg)
    sizes = {"experts": 0, "shared_and_dense": 0, "mixers": 0}
    for stage in params["stages"]:
        for rep in stage:
            for blk in rep:
                sizes["mixers"] += sum(t.nbytes for t in _leaves(
                    blk["mixer"]))
                f = blk.get("ffn")
                if f is None:
                    continue
                if hasattr(f, "router"):
                    sizes["experts"] += f.wi.nbytes + f.wo.nbytes \
                        + f.router.nbytes + f.norm.nbytes
                    if f.shared is not None:
                        sizes["shared_and_dense"] += sum(
                            t.nbytes for t in _leaves(f.shared))
                else:
                    sizes["shared_and_dense"] += sum(
                        t.nbytes for t in _leaves(f))
    e = params["embed"]
    head = e.table if e.head is None else e.head
    sizes["head"] = (head.nbytes + e.final_norm.nbytes
                     + rows * cfg.d_model * e.table.element_size()
                     + rows * cfg.vocab_size * 4)
    sizes["cache"] = n["attn"] * 2 * rows * positions * cfg.num_kv_heads \
        * cfg.head_dim * elem
    if n["mla"]:
        sizes["cache"] += n["mla"] * rows * positions * (
            cfg.mla.kv_lora_rank + cfg.mla.rope_head_dim) * elem
    if n["mamba"]:
        st = mamba2.init_state(rows, cfg.d_model, cfg.ssm,
                               torch.bfloat16 if elem == 2 else
                               torch.float32, "meta")
        sizes["mamba_state"] = n["mamba"] * 2 * (st.ssm.nbytes
                                                 + st.conv.nbytes)
    sizes["total"] = sum(sizes.values())
    sizes["floor_ms"] = sizes["total"] / PEAK_HBM_BYTES * 1e3
    return sizes


def moe_serving_phase(report, dev):
    """Phase 13: olmoe-1b-7b at full width, fp32."""
    return serve_moe(report, dev, "olmoe-1b-7b", "fp32", "serving_olmoe")


def deepseek_serving_phase(report, dev):
    """Phase 14: deepseek-v2-lite-16b at full width, bf16."""
    return serve_moe(report, dev, "deepseek-v2-lite-16b", "bf16",
                     "serving_deepseek")


def jamba_serving_phase(report, dev):
    """Phase 16: jamba-1.5-large's first period cut to its first three
    layers (``attn.moe``, ``mamba.mlp``, ``mamba.moe``: one of each block
    kind) at full width, bf16.  The whole model (72 layers, ~796 GB at
    bf16) fits neither one card nor four."""
    from repro_torch.configs import jamba_1p5_large_398b as jamba
    from repro_torch.models.config import Stage
    cfg = jamba.CONFIG.replace(stages=(Stage(pattern=jamba._PERIOD[:3],
                                             repeat=1),))
    print(f"reduced: depth {jamba.CONFIG.num_layers} → {cfg.num_layers}",
          flush=True)
    counts = serve_moe(report, dev, cfg, "bf16", "serving_jamba")
    report["serving_jamba"]["reduced"] = {
        "depth": [jamba.CONFIG.num_layers, cfg.num_layers],
        "layers": list(cfg.stages[0].pattern)}
    return counts


def serve_moe(report, dev, arch, dtype, key):
    """A MoE model at full width through ``BayesianEngine.generate``: 8
    prompts of LM_PROMPT tokens x 8 chains, LM_NEW new tokens; the launch
    counts (no plain version of a kernel called); the run repeated on its
    own tokens; the same engine decoding eagerly under a RouteTap (bit-equal
    to the graph run); the ``reference`` backend teacher-forced on the
    tokens with its routes forced to the kernel run's (RouteTap(force)):
    logits, entropy and MI of every row within the tolerances, every token
    whose own top-k differs a flip under MOE_GAP_BOUND, dropped routes a
    layer at the prefill and a decode step; graph against eager in turns;
    times, profiles, peak memory, and the decode step's byte floor beside
    its device ms.  ``arch``: a registry name or an ``ArchConfig`` (a cut
    of one); with mamba blocks the prefill's SSD scan must take the
    tensor cores at bf16."""
    import gc
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import backbone, moe
    from repro_torch.serve.engine import BayesianEngine

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    cfg = get_config(arch) if isinstance(arch, str) else arch
    arch = cfg.name
    if cfg.mcd.n_samples != LM_S:
        raise RuntimeError(f"{arch} serves {cfg.mcd.n_samples} chains")
    bf16 = dtype == "bf16"
    logit_tol, unc_tol = ((BF16_LOGIT_TOL, BF16_UNC_TOL) if bf16
                          else (LOGIT_TOL, UNC_TOL))
    wdtype = torch.bfloat16 if bf16 else torch.float32
    torch.cuda.reset_peak_memory_stats()
    params = backbone.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev,
        dtype=wdtype)
    n_params = sum(t.numel() for t in _leaves(params))
    n = _moe_layers(cfg)
    rows = LM_B * LM_S
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (LM_B, LM_PROMPT), dtype=np.int32)
    max_len = LM_PROMPT + LM_NEW
    eng = BayesianEngine(params, cfg, max_len=max_len, seed=0, device=dev)
    want = _moe_want(cfg)
    res, counts, again = _served(eng, cfg, prompts, want)
    ssd_path = None
    if n["mamba"]:
        from repro_torch.kernels import ssd_chunk
        ssd_path = ssd_chunk.ssd_chunk_scan.last_plan["path"]
        if ssd_path != ("tensor_cores" if bf16 else "cuda_cores"):
            raise RuntimeError(f"{arch} prefill's SSD scan took {ssd_path}")
    ent, mi = res.predictive_entropy, res.mutual_information
    # The kernel backend eagerly, its routes recorded: bit-equal to the
    # graph run.
    eager = BayesianEngine(params, cfg, max_len=max_len, seed=0, device=dev,
                           graphs=False)
    with RouteTap() as tap_k, no_plain_versions():
        forced_k = eager.generate(prompts, LM_NEW, teacher_tokens=res.tokens,
                                  keep_logits=True)
    if not torch.equal(forced_k.logits, again.logits):
        raise RuntimeError(f"{arch}: the eager kernel run's logits differ "
                           "from the graph run's")
    del forced_k, eager
    with RouteTap(force=tap_k.calls) as tap_r:
        ref = BayesianEngine(params, cfg, max_len=max_len, seed=0,
                             device=dev, backend="reference").generate(
            prompts, LM_NEW, teacher_tokens=res.tokens, keep_logits=True)
    dev_ref = _deviation(again, ref, arch)
    flips, dropped, held = route_flips(tap_k.calls, tap_r.calls, n["moe"],
                                       LM_PROMPT, MOE_GAP_BOUND[arch], arch)
    del tap_k, tap_r
    flips = flip_summary(flips, MOE_GAP_BOUND[arch])
    print(f"{key} route flips " + json.dumps(flips), flush=True)
    if dev_ref["logits"] > logit_tol or max(dev_ref["entropy"],
                                            dev_ref["mi"]) > unc_tol:
        raise RuntimeError(f"{arch} serving vs reference (routes forced): "
                           f"{dev_ref} (tol {logit_tol}, {unc_tol})")
    greedy_differ = int((ref.tokens != res.tokens).sum())
    del ref
    graph_vs_eager = lm_graph_turns(eng, params, cfg, prompts, res, again,
                                    want, runs=MOE_GRAPH_RUNS)
    del again
    peak = torch.cuda.max_memory_allocated()

    steps_ms = np.asarray(res.decode_s) * 1e3
    decode_s = float(np.sum(res.decode_s))
    elem = 2 if bf16 else 4
    floor = _decode_bytes(params, cfg, rows, LM_PROMPT + LM_NEW // 2, elem)
    drops = np.asarray(dropped).reshape(1 + LM_NEW, n["moe"])
    out = {"card": report["card"], "arch": cfg.name, "params": n_params,
           "layers": cfg.num_layers, "moe_layers": n["moe"],
           "mamba_layers": n["mamba"], "ssd_path": ssd_path,
           "experts": cfg.moe.num_experts, "top_k": cfg.moe.top_k,
           "capacity_prefill": moe.capacity(rows * LM_PROMPT, cfg.moe),
           "capacity_decode": moe.capacity(rows, cfg.moe),
           "d_model": cfg.d_model, "vocab": cfg.vocab_size,
           "dtype": "bfloat16" if bf16 else "float32", "requests": LM_B,
           "chains": LM_S, "rows": rows, "prompt_len": LM_PROMPT,
           "new_tokens": LM_NEW, "p": cfg.mcd.p,
           "launches_by_kernel": {k: v for k, v in counts.items() if v},
           "prefill_ms": res.prefill_s * 1e3,
           "decode_ms_per_token_p50": float(np.percentile(steps_ms, 50)),
           "decode_ms_per_token_p95": float(np.percentile(steps_ms, 95)),
           "decode_tokens_per_s": LM_B * LM_NEW / decode_s,
           "max_memory_allocated_gb": peak / 1e9,
           "card_memory_gb": torch.cuda.get_device_properties(
               dev).total_memory / 1e9,
           "max_abs_diff_vs_reference_routes_forced": dev_ref,
           "tolerance_vs_reference": {"logits": logit_tol,
                                      "entropy_mi": unc_tol},
           "route_flips": flips,
           "calls_dropping_equal_routes": held,
           "greedy_tokens_differing_in_reference": greedy_differ,
           "dropped_routes_prefill_by_layer": drops[0].tolist(),
           "dropped_routes_decode_by_step": drops[1:].sum(1).tolist(),
           "dropped_routes_decode_by_layer": drops[1:].sum(0).tolist(),
           "decode_step_bytes": floor,
           "entropy_mean": float(ent.mean()), "mi_mean": float(mi.mean()),
           "graph_vs_eager": graph_vs_eager}
    if n["mla"]:
        lat = cfg.mla.kv_lora_rank + cfg.mla.rope_head_dim
        qk = cfg.mla.nope_head_dim + cfg.mla.rope_head_dim
        out["mla_cache"] = {
            "values_per_token_layer": lat,
            "bytes": n["mla"] * rows * max_len * lat * elem,
            "gqa_same_heads_bytes": n["mla"] * rows * max_len
            * cfg.num_heads * (qk + cfg.mla.v_head_dim) * elem,
            "gqa_2_h_128_bytes": n["mla"] * rows * max_len * 2
            * cfg.num_heads * 128 * elem}
    report[key] = out
    print(f"{key} " + json.dumps(out), flush=True)
    kernels = [k for k in ("masked_activation", "mcd_matmul")
               if k in want]
    out.update(profile_lm(eng, prompts, kernels + (
        ["ssd_chunk_scan"] if n["mamba"] else []), kernels, decode=False))
    graph_vs_eager["profiled_decode_step_graph"] = profile_lm(
        eng, prompts, kernels,
        kernels + (["decode_attention"] if n["attn"] else []),
        graph=True)["profiled_decode_step"]
    busy = graph_vs_eager["profiled_decode_step_graph"]["device_busy_ms"]
    out["decode_step_device_ms_vs_floor"] = {
        "device_busy_ms": busy, "floor_ms": floor["floor_ms"],
        "ratio": busy / floor["floor_ms"]}
    out["seconds"] = time.perf_counter() - t_phase
    print(f"{key} profile " + json.dumps(out), flush=True)
    del eng, params, res
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# -- phase 11: training on the card -------------------------------------------

TRAIN_STEPS = {"ecg-clf": 10,   # paper §V: B 64, whole 140-step beats,
               "ecg-ae": 5}     # lr 1e-3, p 0.125 (an AE step ~4 s)
TRAIN_GATE_STEPS = 3   # run again on the CPU from the same params
TRAIN_LOSS_TOL = 1e-5  # card vs CPU, the loss at each gated step
TRAIN_PARAM_TOL = 1e-4  # card vs CPU, params after the gated steps: a
                       # tenth of one step's AdamW update (lr 1e-3); the
                       # two devices' exp / tanh and sum orders differ in
                       # the last bits, which AdamW's normalization can
                       # lift where a gradient element is near zero
TRAIN_PROFILE_STEPS = 2  # the last steps of a cell, in one profile
TRAIN_PROFILES = 3     # profiles tried for one whose steps agree
KILL_STEP = 4          # the child is killed after its step-4 checkpoint
KILL_STEPS = 8         # ... and the relaunch finishes this many
LM_TRAIN = ("qwen3-1.7b", "mamba2-370m")
LM_TRAIN_STEPS = 3
TRAIN_CHILD_TIMEOUT = 600   # seconds a child of phase 11 may take
PHASE11_EXAMPLES = (("quickstart",), ("ecg_monitoring", "--smoke"))


def _train_args(task, *extra):
    from repro_torch.launch import train
    return train.parser().parse_args(["--task", task, *extra])


def _leaves_cpu(tree):
    from repro_torch.ckpt.checkpoint import tree_leaves
    return [t.detach().to("cpu", copy=True) for t in tree_leaves(tree)]


def _aten_ops(loss_fn, params, batch):
    """aten ops a training step dispatches, forward (the loss) and
    backward (``torch.autograd.grad``) apart, under a counting
    ``TorchDispatchMode``."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.ckpt.checkpoint import tree_leaves, tree_unflatten

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    live = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with Count():
        loss, _ = loss_fn(tree_unflatten(params, live), batch, 0)
    fwd = Count.n
    with Count():
        torch.autograd.grad(loss, live)
    return {"forward": fwd, "backward": Count.n - fwd}


def _profile_steps(step):
    """Device busy us, wall us and device records a step of
    TRAIN_PROFILE_STEPS calls of ``step`` (each synced at its end) in one
    torch.profiler profile (CUDA activity), each step behind a marker
    launch (``segmented_device_us``'s MARKER, not counted in its
    wrapper's launches) that splits the records by step; the profile
    opens with a spin and LEAD_MARKERS markers, as that one's does.  The records are
    read from the kineto events themselves: a training step launches
    ~10^5 kernels, and ``key_averages`` over such a profile takes minutes.
    A profile counts when its steps' records agree within LOOSE_RECORDS
    (a lost record reads as time that did not pass); else it is taken
    again, over the next steps, up to TRAIN_PROFILES times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import bernoulli_mask
    wrapper = bernoulli_mask.masked_activation
    xm = torch.zeros((1, 4), device="cuda")
    rm = torch.zeros((1,), dtype=torch.int32, device="cuda")
    launches = wrapper.launches

    def marker():
        wrapper(xm, rm, 1, 0.5)

    marker()
    for attempt in range(TRAIN_PROFILES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(LEAD_SLEEP)   # the profile's first records
            for _ in range(LEAD_MARKERS):   # may be lost
                marker()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(TRAIN_PROFILE_STEPS):
                marker()
                step()
            wall_us = (time.perf_counter() - t0) * 1e6
        evs = sorted((e.start_ns(), e.duration_ns(), e.name())
                     for e in prof.profiler.kineto_results.events()
                     if e.device_type() == DeviceType.CUDA)
        segs, cur = [], None
        for _, ns, name in evs:
            if MARKER in name:
                cur = [0, 0]
                segs.append(cur)
            elif cur is not None:
                cur[0] += ns
                cur[1] += 1
        segs = segs[-TRAIN_PROFILE_STEPS:]
        counts = [n for _, n in segs]
        if (len(segs) == TRAIN_PROFILE_STEPS and min(counts) > 0
                and max(counts) - min(counts)
                <= LOOSE_RECORDS * max(counts)):
            wrapper.launches = launches
            return sum(ns for ns, _ in segs) / 1e3, wall_us, counts
        print(f"training profile {attempt + 1} of {TRAIN_PROFILES}: "
              f"records a step {counts}; taking it again", flush=True)
    raise RuntimeError(f"no training profile of {TRAIN_PROFILE_STEPS} "
                       f"agreeing steps in {TRAIN_PROFILES}")


def _train_cell(task, dev):
    """(a) / (b): TRAIN_STEPS[task] launcher steps of one ECG task on the
    card, synced step seconds and the loss a step, the last
    TRAIN_PROFILE_STEPS under torch.profiler (``_profile_steps``); the
    aten ops of a step; TRAIN_GATE_STEPS steps again on the CPU from the
    same params.  Returns the record and the card's params after
    KILL_STEPS steps, if it ran so many (what 11c holds a resumed run
    to)."""
    import numpy as np
    import torch
    from repro_torch.launch import train
    from repro_torch.train import trainer

    cpu = torch.device("cpu")
    args = _train_args(task)
    loss_fn, params, np_batches, tcfg, cfg = train.setup(args, dev)
    tcfg = dataclasses.replace(tcfg, log_every=0)
    init = _leaves_cpu(params)
    used = []

    def on(device, b):
        return tuple(torch.as_tensor(a, device=device) for a in b)

    tr = trainer.Trainer(loss_fn, params, tcfg)
    step_s, losses, captured = [], [], {}

    def step():
        b = next(np_batches)
        used.append(b)
        t0 = time.perf_counter()
        (h,) = tr.run([on(dev, b)], tr.step + 1)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(h["loss"])
        if tr.step in (TRAIN_GATE_STEPS, KILL_STEPS):
            captured[tr.step] = _leaves_cpu(tr.params)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    parts = {}
    t_part = time.perf_counter()
    plain = TRAIN_STEPS[task] - TRAIN_PROFILE_STEPS
    for _ in range(plain):
        step()
    parts["steps"] = time.perf_counter() - t_part
    busy_us, wall_us, records = _profile_steps(step)
    parts["profile"] = time.perf_counter() - t_part - parts["steps"]
    t_part = time.perf_counter()
    peak = torch.cuda.max_memory_allocated() / 1e9
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"11 {task}: non-finite loss {losses}")
    # The gate: the same params and batches on the CPU.
    _, cparams, _, _, _ = train.setup(args, cpu)
    # The aten ops of a step, counted on the CPU (as ROADMAP B2.14 counts
    # them; the card's forward dispatches 16 more, its moves of x and
    # rows): one launch each on the card.
    ops = _aten_ops(loss_fn, cparams, on(cpu, used[0]))
    parts["aten_ops"] = time.perf_counter() - t_part
    t_part = time.perf_counter()
    if any(not torch.equal(a, b) for a, b in zip(init,
                                                  _leaves_cpu(cparams))):
        raise RuntimeError(f"11 {task}: the CPU's initial params are not "
                           "the card's")
    ctr = trainer.Trainer(loss_fn, cparams, tcfg)
    t0 = time.perf_counter()
    chist = ctr.run([on(cpu, b) for b in used[:TRAIN_GATE_STEPS]],
                    TRAIN_GATE_STEPS)
    cpu_step_s = (time.perf_counter() - t0) / TRAIN_GATE_STEPS
    parts["cpu_gate"] = time.perf_counter() - t_part
    loss_err = max(abs(a - h["loss"]) for a, h in zip(losses, chist))
    param_err = max((a - b).abs().max().item() for a, b in
                    zip(captured[TRAIN_GATE_STEPS], _leaves_cpu(ctr.params),
                        strict=True))
    if loss_err > TRAIN_LOSS_TOL or param_err > TRAIN_PARAM_TOL:
        raise RuntimeError(
            f"11 {task}: the card's first {TRAIN_GATE_STEPS} steps differ "
            f"from the CPU's: loss {loss_err:.3g} (tol {TRAIN_LOSS_TOL}), "
            f"params {param_err:.3g} (tol {TRAIN_PARAM_TOL})")
    st = sorted(step_s[:plain])
    p50 = st[len(st) // 2]
    busy_ms = busy_us / TRAIN_PROFILE_STEPS / 1e3
    rec = {"task": task, "cfg": dataclasses.asdict(cfg),
           "batch": args.batch, "steps": tr.step, "plain_steps": plain,
           "step_s": step_s, "step_s_p50": p50,
           "step_s_p95": st[min(len(st) - 1, int(0.95 * len(st)))],
           "loss": losses, "aten_ops": ops,
           "aten_ops_step": ops["forward"] + ops["backward"],
           "profiled_steps": TRAIN_PROFILE_STEPS,
           "profiled_records_a_step": records,
           "device_busy_ms_per_step": busy_ms,
           "profiled_step_ms": wall_us / TRAIN_PROFILE_STEPS / 1e3,
           "device_idle_share": 1.0 - busy_us / wall_us,
           "device_idle_share_of_p50": 1.0 - busy_ms / (p50 * 1e3),
           "peak_gb": peak, "cpu_step_s": cpu_step_s, "parts_s": parts,
           "cpu_gate": {"steps": TRAIN_GATE_STEPS,
                        "max_loss_diff": loss_err,
                        "max_param_diff": param_err,
                        "loss_tol": TRAIN_LOSS_TOL,
                        "param_tol": TRAIN_PARAM_TOL}}
    print(f"11 {task}: step p50 {p50:.3f} s p95 {rec['step_s_p95']:.3f} s "
          f"(of {plain} unprofiled), {rec['aten_ops_step']} aten ops a "
          f"step ({ops}), device busy {busy_ms:.1f} ms a step (idle "
          f"{rec['device_idle_share']:.1%} of a profiled step, "
          f"{rec['device_idle_share_of_p50']:.1%} of the p50), peak "
          f"{peak:.3f} GB, loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
          f"CPU gate loss {loss_err:.3g} params {param_err:.3g}",
          flush=True)
    return rec, captured.get(KILL_STEPS)


def train_child(ckpt_dir):
    """11c's child: ``launch.train.main`` for the classifier with
    ``--ckpt-dir`` and a checkpoint every 2 steps (the launcher saves every
    50), KILL_STEPS steps."""
    from repro_torch.launch import train
    setup = train.setup

    def every_2(args, device):
        loss, params, batches, tcfg, cfg = setup(args, device)
        return (loss, params, batches,
                dataclasses.replace(tcfg, ckpt_every=2), cfg)

    train.setup = every_2
    train.main(["--task", "ecg-clf", "--steps", str(KILL_STEPS),
                "--ckpt-dir", ckpt_dir])


def _kill_resume(dev, want):
    """(c): the child killed (SIGKILL) once its step-KILL_STEP checkpoint
    is on disk, the same command relaunched to KILL_STEPS; the final
    params bit-equal to ``want`` (the uninterrupted run's)."""
    import signal
    import torch
    from repro_torch.ckpt import checkpoint
    from repro_torch.ckpt.checkpoint import tree_leaves
    from repro_torch.launch import train
    from repro_torch.train import optimizer

    ckpt = os.path.join(ROOT, "build", "phase11", "ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    cmd = [sys.executable, os.path.abspath(__file__), "--train-child", ckpt]
    t0 = time.perf_counter()
    child = subprocess.Popen(cmd)
    while (checkpoint.latest_step(ckpt) or 0) < KILL_STEP:
        if child.poll() is not None:
            raise RuntimeError(f"11c: the child exited ({child.returncode}) "
                               f"before its step-{KILL_STEP} checkpoint")
        if time.perf_counter() - t0 > TRAIN_CHILD_TIMEOUT:
            child.kill()
            raise RuntimeError("11c: no step-4 checkpoint in time")
        time.sleep(0.02)
    child.send_signal(signal.SIGKILL)
    child.wait()
    killed_at = checkpoint.latest_step(ckpt)
    first_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    subprocess.run(cmd, check=True, timeout=TRAIN_CHILD_TIMEOUT)
    resume_s = time.perf_counter() - t1
    if checkpoint.latest_step(ckpt) != KILL_STEPS:
        raise RuntimeError(f"11c: the relaunch ended at step "
                           f"{checkpoint.latest_step(ckpt)}")
    _, like, _, _, _ = train.setup(_train_args("ecg-clf"), dev)
    _, (got, _) = checkpoint.resume_or_none(
        ckpt, (like, optimizer.init(like)), dev)
    diff = [i for i, (a, b) in enumerate(zip(_leaves_cpu(got), want,
                                             strict=True))
            if not torch.equal(a, b)]
    if diff:
        raise RuntimeError(f"11c: resumed params != uninterrupted at "
                           f"leaves {diff}")
    shutil.rmtree(os.path.join(ROOT, "build", "phase11"),
                  ignore_errors=True)
    print(f"11c kill -> resume: killed after the step-{killed_at} "
          f"checkpoint, relaunched to step {KILL_STEPS}: params bit-equal "
          f"({first_s:.1f} s + {resume_s:.1f} s)", flush=True)
    return {"killed_after_checkpoint": killed_at,
            "resumed_to": KILL_STEPS, "bit_equal": True,
            "leaves": len(tree_leaves(got)),
            "first_child_s": first_s, "relaunch_s": resume_s,
            "deterministic_algorithms": False}


def ecg_train_child(task, out):
    """11a-c, one task in a fresh process of this script: torch.profiler
    loses records in every later profile of a process after one of ~10^5
    records (phase 10's reason; a second cell's profile in one process
    lost its first step's records), and a fresh process steps as a
    training job does.  The classifier's child also runs (c).  Writes
    the records to ``out``."""
    import torch
    dev = torch.device("cuda")
    cell, at_kill = _train_cell(task, dev)
    rec = {"cell": cell}
    if task == "ecg-clf":
        rec["kill_resume"] = _kill_resume(dev, at_kill)
    with open(out, "w") as fh:
        json.dump(rec, fh)


def lm_train_child(out):
    """11d's child: ``launch.train.main`` for the LM task at its defaults
    on the published configs, one after the other; writes the records to
    ``out``."""
    import gc
    import torch
    from repro_torch.ckpt.checkpoint import tree_leaves
    from repro_torch.launch import train
    recs = []
    for arch in LM_TRAIN:
        argv = ["--task", "lm", "--arch", arch, "--no-reduced",
                "--steps", str(LM_TRAIN_STEPS)]
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = train.main(argv)
        tr = res["trainer"]
        args = train.parser().parse_args(argv)
        recs.append({
            "arch": arch, "argv": argv, "batch": args.batch,
            "seq": args.seq,
            "params": sum(p.numel() for p in tree_leaves(tr.params)),
            "step_s": tr.step_times,
            "tokens_per_s": [args.batch * args.seq / s
                             for s in tr.step_times],
            "loss": [h["loss"] for h in res["history"]],
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "peak_reserved_gb": torch.cuda.max_memory_reserved() / 1e9,
            "seconds": time.perf_counter() - t0})
        del res, tr
        gc.collect()
        torch.cuda.empty_cache()
    with open(out, "w") as fh:
        json.dump(recs, fh)


def example_child(spec, out):
    """11e's child: one example's ``main`` on the card, the kernel
    launches it made written to ``out``."""
    import importlib
    name, *argv = spec.split()
    reset_launches()
    importlib.import_module(f"repro_torch.examples.{name}").main(argv)
    with open(out, "w") as fh:
        json.dump(read_launches(), fh)


def _child(flag, *args, timeout=TRAIN_CHILD_TIMEOUT):
    """Run this script with ``flag`` and ``args`` in a fresh process that
    writes JSON to a file under ``build/``; returns what it wrote."""
    out = os.path.join(ROOT, "build", "child.json")
    if os.path.exists(out):
        os.remove(out)
    subprocess.run([sys.executable, os.path.abspath(__file__), flag, *args,
                    out], check=True, timeout=timeout)
    with open(out) as fh:
        got = json.load(fh)
    os.remove(out)
    return got


def training_phase(report, dev):
    """Phase 11: (a) the classifier and (b) the autoencoder trained on the
    card through the launcher's own loss and batches, each held against
    the CPU, each in a child process, the classifier's with (c) kill ->
    resume, bit-equal; (d)
    both LMs at full width through ``launch.train`` in another; (e)
    ``quickstart`` and ``ecg_monitoring --smoke``, each in its own.
    Returns the kernel launches of (e), the only part of the phase that
    reaches a kernel (training runs the plain path)."""
    import gc
    import math
    import torch
    rec = report["training"] = {"cells": []}
    for task in TRAIN_STEPS:
        t0 = time.perf_counter()
        got = _child("--phase11-ecg-child", task)
        got["cell"]["child_s"] = time.perf_counter() - t0
        rec["cells"].append(got["cell"])
        rec.update({k: v for k, v in got.items() if k != "cell"})
    gc.collect()
    torch.cuda.empty_cache()
    rec["parent_reserved_gb"] = torch.cuda.memory_reserved() / 1e9
    t0 = time.perf_counter()
    rec["lm"] = _child("--lm-train-child")
    rec["lm_child_s"] = time.perf_counter() - t0
    for lm in rec["lm"]:
        if (len(lm["loss"]) != LM_TRAIN_STEPS
                or not all(math.isfinite(v) for v in lm["loss"])):
            raise RuntimeError(f"11d {lm['arch']}: losses {lm['loss']}")
        print(f"11d {lm['arch']}: {lm['params'] / 1e9:.3f} B params, "
              f"steps {[round(s, 3) for s in lm['step_s']]} s, tokens/s "
              f"{[round(t) for t in lm['tokens_per_s']]}, peak "
              f"{lm['peak_gb']:.2f} GB (reserved "
              f"{lm['peak_reserved_gb']:.2f}), loss {lm['loss']}",
              flush=True)
    launches = {name: 0 for name in ALL_KERNELS}
    rec["examples"] = []
    for spec in PHASE11_EXAMPLES:
        t0 = time.perf_counter()
        counts = _child("--example-child", " ".join(spec))
        ex = {"example": " ".join(spec), "exit": 0,
              "seconds": time.perf_counter() - t0,
              "launches": {k: v for k, v in counts.items() if v}}
        rec["examples"].append(ex)
        print(f"11e {ex['example']}: exit 0 in {ex['seconds']:.1f} s, "
              f"launches {ex['launches']}", flush=True)
        for k, v in counts.items():
            launches[k] += v
    return launches


# Phase 17: the LM planning stack (launch.{analysis,specs,dryrun}) on the
# card.  (a) The dry run on fake tensors, its cells counted in DRY_WORKERS
# processes at the lowest CPU priority on the host's spare cores, started
# beside phases 15 and 16's child (GPU-bound, one core) and collected
# before (b), the card's measurements, whose probes it would slow.
DRY_WORKERS = 6          # of the host's 8 cores; 2 left to the zoo child
DRY_TIMEOUT = 600        # seconds to wait for the last cell
# The matrix cut to every arch's decode and prefill cells and two train
# cells (a train cell's count takes ~70-120 s on the card's host, the
# whole matrix ~870 CPU-s there); the CPU dry run covers all 24 cells.
DRY_TRAIN = ("qwen3-1.7b", "olmoe-1b-7b")
# (b) --measure: (arch, shape, batch, the cut); each probe built on the
# card at full width, counted (== its fake count, exactly) and timed.
MEASURED = (("llama3-8b", "decode_32k", None, None),
            ("mamba2-370m", "long_500k", None, None),
            ("qwen3-1.7b", "prefill_32k", 1, "batch 32 -> 1"))
PROBE_ITERS = 3          # timed calls a probe, after one warm-up call
# The llama3 decode probe on the ``cuda`` backend against ``reference``:
# the block output and, on its own, the attention sublayer (the residual
# dominates the block) each within PLAN_ATT_ULPS bf16 ulps of its own
# largest value: each rounds once to bf16, and the TPU kernel's fp32
# softmax weights differ from the reference's bf16-rounded ones in the
# last bits.  The sublayer's tolerance is at most 1 / PLAN_ATT_MARGIN of
# what a kernel returning zeros, or one losing the dominant keys of the
# cache's second half (a split it failed to merge), would be off by.
# With the cache at N(0, 1) alone the softmax spreads over 32768 keys and
# the sublayer is ~0.01 of the block, so DOMINANT keys a row, spread over
# the cache at random, are scaled by DOMINANT_SCALE (a power of two:
# exact in bf16): each scores ~N(0, 256) against ~N(0, 1) for the rest.
PLAN_ATT_ULPS = 2
PLAN_ATT_MARGIN = 8
DOMINANT = 8
DOMINANT_SCALE = 16.0
PLAN_CUDA_WANT = {"masked_activation": 1, "mcd_matmul": 1,
                  "decode_attention": 1}


def _dry_cells():
    """17a's (arch, shape) cells, the costliest counts first: every
    arch's decode, long and prefill cells, DRY_TRAIN's train cells."""
    from repro_torch.configs import ALIASES
    from repro_torch.models.config import SHAPES
    order = {"train": 0, "prefill": 1, "decode": 2}
    return sorted(((a, s) for a in sorted(ALIASES) for s in sorted(SHAPES)
                   if SHAPES[s].kind != "train" or a in DRY_TRAIN),
                  key=lambda c: order[SHAPES[c[1]].kind])


class DryRun:
    """17a's cells counting in a pool of spawned processes at the lowest
    CPU priority: ``start`` submits them all, ``collect`` waits for their
    records."""

    def __init__(self):
        self.pool = self.futures = None

    def start(self):
        import concurrent.futures
        import multiprocessing
        from repro_torch.launch import dryrun
        if self.pool is not None:
            return
        self.t0 = time.perf_counter()
        self.pool = concurrent.futures.ProcessPoolExecutor(
            max_workers=min(DRY_WORKERS, os.cpu_count() or 1),
            mp_context=multiprocessing.get_context("spawn"),
            initializer=os.nice, initargs=(19,))
        self.futures = [self.pool.submit(dryrun.run_cell, a, s, False,
                                         verbose=False)
                        for a, s in _dry_cells()]

    def collect(self) -> tuple[list, float]:
        try:
            records = [f.result(timeout=DRY_TIMEOUT) for f in self.futures]
        finally:
            self.pool.shutdown(cancel_futures=True)
        return records, time.perf_counter() - self.t0


def _check_dry(records) -> None:
    """17a's gate: each cell ok or skipped exactly where shape_applicable
    says, no error."""
    from repro_torch.configs import get_config
    from repro_torch.models.config import shape_applicable
    bad = []
    for r in records:
        want = ("ok" if shape_applicable(get_config(r["arch"]),
                                         r["shape"])[0] else "skipped")
        if r["status"] != want:
            bad.append((r["arch"], r["shape"], r["status"],
                        r.get("error", "")))
    if bad:
        raise RuntimeError(f"17a: dry-run cells not as applicable: {bad}")


def _model_ratios(records) -> list[dict]:
    """17c: the counted composition against ``gpu_model.step_model`` at
    data = model = 1 (one program, every chip's work): flops and bytes
    ratios.  Printed only; they gate nothing."""
    from repro_torch.configs import get_config
    from repro_torch.dse import gpu_model
    from repro_torch.models.config import SHAPES
    out = []
    hw = gpu_model.GpuHwConfig(data=1, model=1)
    for r in records:
        if r["status"] != "ok":
            continue
        m = gpu_model.step_model(get_config(r["arch"]), SHAPES[r["shape"]],
                                 hw)
        out.append({"arch": r["arch"], "shape": r["shape"],
                    "flops_ratio": r["composition_flops"] / m["flops"],
                    "bytes_ratio": r["composition_bytes"] / m["bytes"]})
    return out


def _ulps_of_largest(t, ulps=PLAN_ATT_ULPS) -> float:
    """``ulps`` bf16 ulps (8 significant bits) of t's largest
    magnitude."""
    import math
    top = t.float().abs().max().item()
    return ulps * 2.0 ** (math.floor(math.log2(top)) - 7)


def _attention_sublayer(dev, pr, cfg, bayes, hot) -> dict:
    """17b: the attention sublayer of llama3's decode probe
    (``layers.attention_decode``, the kernel's and wo's part of the block)
    on the ``cuda`` backend against ``reference`` on the same inputs,
    within PLAN_ATT_ULPS bf16 ulps of its largest value; beside it what a
    kernel returning zeros, and one losing the dominant keys of the
    cache's second half (``hot``: each row's dominant positions), would
    be off by (each at least PLAN_ATT_MARGIN tolerances).  Its launches
    compare a kernel with the plain path: they are no main path's."""
    import torch
    from repro_torch.models import layers
    params, x, cache, cross, pos, ctx = pr.args
    m = layers.site_mask(ctx, bayes, 0, layers.SITE_ATTN)

    def attn(backend):
        return layers.attention_decode(params["mixer"], x, cache, pos,
                                       cfg.rope_theta, m, ctx.cfg.p,
                                       backend)[0].float()

    with no_plain_versions():
        got = attn("cuda")
    want = attn("reference")
    err = max_abs_diff(got, want, "17b attention sublayer")
    top = want.abs().max().item()
    tol = _ulps_of_largest(want)
    k = cache[0]
    rows = torch.arange(k.shape[0], device=dev)[:, None].expand_as(hot)
    late = hot >= k.shape[1] // 2
    k[rows[late], hot[late]] /= DOMINANT_SCALE
    lost = max_abs_diff(attn("reference"), want, "17b lost keys")
    k[rows[late], hot[late]] *= DOMINANT_SCALE
    rec = {"max_abs_err": err, "tol": tol, "largest": top,
           "zeros_err": top, "lost_keys_err": lost}
    print(f"17b llama3-8b attention sublayer cuda vs reference: max err "
          f"{err:.4g} (tol {tol:.4g}: {PLAN_ATT_ULPS} bf16 ulps of its "
          f"largest {top:.4g}); a kernel returning zeros {top:.4g}, one "
          f"losing the second half's dominant keys {lost:.4g}", flush=True)
    if not err <= tol:
        raise RuntimeError(f"17b: the attention sublayer {err} from the "
                           f"reference backend (tol {tol})")
    if min(top, lost) < PLAN_ATT_MARGIN * tol:
        raise RuntimeError(f"17b: a faulty kernel's error ({top}, {lost}) "
                           f"is within {PLAN_ATT_MARGIN} tolerances {tol}")
    return rec


def _cuda_decode_probe(dev) -> dict:
    """17b: llama3-8b's decode probe (batch 128, the cache of 32768
    positions filled at random, DOMINANT keys a row scaled by
    DOMINANT_SCALE, pos 32767) on the ``cuda`` backend against the
    ``reference`` backend on the same inputs: one launch of each LM decode
    kernel, the block output within PLAN_ATT_ULPS bf16 ulps of its
    largest value, the attention sublayer as :func:`_attention_sublayer`
    holds it; both timed beside
    the bound (the counted flops, the bytes of the probe's inputs and
    outputs) and the roofline of the plain path's counted, unfused
    work."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import analysis, mesh as mesh_lib, specs
    from repro_torch.models import backbone
    cfg = get_config("llama3-8b")
    pm = mesh_lib.make_production_mesh()
    pr = next(p for p in specs.probe_jobs(cfg, "decode_32k", pm,
                                          device=dev, fake=False)
              if p.name.startswith("dec"))
    params, x, cache, cross, pos, ctx = pr.args
    g = torch.Generator(device=dev).manual_seed(1)
    for t in cache:
        t.normal_(generator=g)
    k = cache[0]
    hot = torch.randint(0, k.shape[1] - 1, (k.shape[0], DOMINANT),
                        generator=g, device=dev)
    k[torch.arange(k.shape[0], device=dev)[:, None], hot] *= DOMINANT_SCALE
    kind = pr.name.split(":", 1)[1]
    bayes = backbone._stage_bayes(cfg, 0, cfg.stages[0])[0]
    cuda_fn = specs._block_decode_fn(kind, cfg, bayes, backend="cuda")
    plain = analysis.count(pr.fn, *pr.args)
    want = plain.out[0]
    io = analysis.io_bytes(pr.args, plain.out)
    reset_launches()
    with no_plain_versions():
        got = cuda_fn(*pr.args)[0]
    torch.cuda.synchronize()
    counts = read_launches()
    wanted = {k: PLAN_CUDA_WANT.get(k, 0) for k in counts}
    if counts != wanted:
        raise RuntimeError(f"17b: the cuda decode probe launched {counts}, "
                           f"{wanted} wanted")
    err = max_abs_diff(got.float(), want.float(), "17b cuda probe")
    tol = _ulps_of_largest(want)
    if not err <= tol:
        raise RuntimeError(f"17b: cuda probe {err} from the reference "
                           f"backend (tol {tol})")
    sub = _attention_sublayer(dev, pr, cfg, bayes, hot)
    unfused = analysis.roofline(plain.flops, plain.bytes)
    floor = analysis.roofline(plain.flops, io)
    rec = {"probe": pr.name, "batch": x.shape[0], "pos": int(pos),
           "launches": counts, "max_abs_err": err, "tol": tol,
           "largest": want.float().abs().max().item(), "attention": sub,
           "plain_ms": cuda_time_ms(lambda: pr.fn(*pr.args), PROBE_ITERS),
           "cuda_ms": cuda_time_ms(lambda: cuda_fn(*pr.args), PROBE_ITERS),
           "bound_ms": floor.t_bound * 1e3, "bound_by": floor.bottleneck,
           "io_bytes": io, "t_unfused_ms": unfused.t_bound * 1e3,
           "unfused_by": unfused.bottleneck,
           "flops": plain.flops, "bytes": plain.bytes}
    print(f"17b llama3-8b {pr.name} cuda: launches {counts}, block max err "
          f"{err:.3g} (tol {tol:.3g}), plain {rec['plain_ms']:.3f} "
          f"ms, cuda {rec['cuda_ms']:.3f} ms, bound {rec['bound_ms']:.3f} "
          f"ms ({floor.bottleneck}, {io / 1e9:.2f} GB in and out), the "
          f"plain path's unfused count {rec['t_unfused_ms']:.3f} ms "
          f"({plain.bytes / 1e9:.1f} GB)", flush=True)
    del pr, params, x, cache, plain, want, got
    return rec


def _measured(dev) -> list[dict]:
    """17b: MEASURED's probes on the card (``dryrun.measure_probes``):
    every count equal to its fake-tensor count, exactly."""
    import torch
    from repro_torch.launch import dryrun
    out = []
    for arch, shape, batch, cut in MEASURED:
        t = time.perf_counter()
        recs = dryrun.measure_probes(arch, shape, batch=batch, device=dev,
                                     iters=PROBE_ITERS)
        for m in recs:
            print(f"17b {arch} {shape} {m['probe']} x{m['multiplier']} "
                  f"(batch {m['batch']}): {m['ms']:.3f} ms, bound "
                  f"{m['bound_ms']:.3f} ms ({m['bound_by']}), unfused "
                  f"count {m['t_unfused_ms']:.3f} ms ({m['unfused_by']}), "
                  f"counts equal: {m['equal']}", flush=True)
            if not m["equal"]:
                raise RuntimeError(f"17b {arch} {shape} {m['probe']}: the "
                                   f"card's count {m['real']} is not the "
                                   f"fake count {m['fake']}")
        out.append({"arch": arch, "shape": shape, "cut": cut,
                    "seconds": time.perf_counter() - t, "probes": recs})
        torch.cuda.empty_cache()
    return out


def planning_phase(report, dev, dry=None):
    """Phase 17: (a) ``dry``'s cells (started here if it was not beside
    phases 15 and 16) collected, all counted before (b) the card measures
    MEASURED's probes and llama3's decode probe on the ``cuda`` backend;
    (c) the counted composition against the H100 model.  Returns the
    cuda probe's launches."""
    import torch
    dry = dry or DryRun()
    dry.start()
    rec = report["planning"] = {}
    records, rec["dry_s"] = dry.collect()
    for r in records:
        r.pop("probes", None)         # the composition's sums are kept
    rec["dry_run"] = records
    rec["dry_cut"] = ("train_4k only for " + ", ".join(DRY_TRAIN)
                      + " (the CPU dry run covers all 24 cells)")
    _check_dry(records)
    n_ok = sum(r["status"] == "ok" for r in records)
    print(f"17a dry run: {n_ok} ok, {len(records) - n_ok} skipped, 0 errors "
          f"({len(records)} cells, 16x16; cut: {rec['dry_cut']}), "
          f"{rec['dry_s']:.1f} s from its start", flush=True)
    rec["measured"] = _measured(dev)
    rec["cuda_probe"] = _cuda_decode_probe(dev)
    torch.cuda.empty_cache()
    rec["model_ratios"] = _model_ratios(records)
    for m in rec["model_ratios"]:
        print(f"17c {m['arch']} {m['shape']}: counted / gpu_model flops "
              f"{m['flops_ratio']:.4g}, bytes {m['bytes_ratio']:.4g}",
              flush=True)
    return rec["cuda_probe"]["launches"]


def phases_only(report, dev, serving, out=None, kernels=True) -> int:
    """The build, then phase 6 (unless not ``kernels``) and the
    ``serving`` phases alone (a short call: ``--moe-only`` 13 and 14,
    ``--zoo-only`` 15 and 16, ``--plan-only`` 17 without 6); no
    ``kernels`` line."""
    import torch
    phase_s = report["phase_s"] = {}
    for name, fn, *args in (*((("6", lm_kernel_phase, report),)
                              if kernels else ()),
                            *((name, fn, report, dev)
                              for name, fn in serving)):
        t = time.perf_counter()
        fn(*args)
        phase_s[name] = time.perf_counter() - t
    print("phase seconds " + json.dumps(phase_s), flush=True)
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as fh:
            json.dump(report, fh, indent=1)
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write the full report as JSON here")
    ap.add_argument("--phase10-out", default=None,
                    help=argparse.SUPPRESS)   # the child of phase10_child
    ap.add_argument("--phase5d-child", default=None,
                    help=argparse.SUPPRESS)   # the restore child of 5d
    ap.add_argument("--phase11-ecg-child", nargs=2, default=None,
                    help=argparse.SUPPRESS)   # phase 11a-c: TASK OUT
    ap.add_argument("--train-child", default=None,
                    help=argparse.SUPPRESS)   # phase 11c's training child
    ap.add_argument("--lm-train-child", default=None,
                    help=argparse.SUPPRESS)   # phase 11d: OUT.json
    ap.add_argument("--example-child", nargs=2, default=None,
                    help=argparse.SUPPRESS)   # phase 11e: "NAME ARGS" OUT
    ap.add_argument("--phase11-only", action="store_true",
                    help=argparse.SUPPRESS)   # the build, then phase 11
    ap.add_argument("--moe-only", action="store_true",
                    help=argparse.SUPPRESS)   # the build, 6, 13 and 14
    ap.add_argument("--zoo-only", action="store_true",
                    help=argparse.SUPPRESS)   # the build, 6, 15 and 16
    ap.add_argument("--zoo-child", default=None,
                    help=argparse.SUPPRESS)   # phases 15 and 16: OUT.json
    ap.add_argument("--plan-only", action="store_true",
                    help=argparse.SUPPRESS)   # the build, 6 and 17
    ap.add_argument("--encdec-only", action="store_true",
                    help=argparse.SUPPRESS)   # the build, 6 and 18
    ap.add_argument("--wide-only", action="store_true",
                    help=argparse.SUPPRESS)   # the build, 2 wide and 19
    ap.add_argument("--phase19-out", default=None,
                    help=argparse.SUPPRESS)   # the child of phase 19
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script drives the port on "
              "a GPU", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}", flush=True)
    report = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda}
    t0 = time.perf_counter()
    logs = build.build_all(list(KERNELS) + [src.removesuffix(".cu") for
                                            _, src, _ in LM_KERNELS.values()])
    report["build_s"] = time.perf_counter() - t0
    for name, log in logs.items():
        print(f"nvcc {name}.cu ({report['build_s']:.1f}s):\n{log.strip()}",
              flush=True)
    dev = torch.device("cuda")
    if args.phase5d_child:
        durable_child(args.phase5d_child)
        return 0
    if args.phase11_ecg_child:
        ecg_train_child(*args.phase11_ecg_child)
        return 0
    if args.train_child:
        train_child(args.train_child)
        return 0
    if args.lm_train_child:
        lm_train_child(args.lm_train_child)
        return 0
    if args.example_child:
        example_child(*args.example_child)
        return 0
    if args.zoo_child:
        zoo_child(args.zoo_child)
        return 0
    if args.phase11_only:
        training_phase(report, dev)
        report["seconds"] = time.perf_counter() - t0
        print(json.dumps({"training": report["training"]}))
        return 0
    if args.moe_only:
        return phases_only(report, dev, (("13", moe_serving_phase),
                                         ("14", deepseek_serving_phase)),
                           args.out)
    if args.zoo_only:
        return phases_only(report, dev, (("15", llama3_serving_phase),
                                         ("16", jamba_serving_phase)),
                           args.out)
    if args.plan_only:
        return phases_only(report, dev, (("17", planning_phase),), args.out,
                           kernels=False)
    if args.encdec_only:
        return phases_only(report, dev, (("18", encdec_serving_phase),),
                           args.out)
    if args.wide_only:
        return phases_only(report, dev, (
            ("2 wide", lambda rep, _dev: wide_kernel_cases(rep)),
            ("19", wide_serving_phase)), args.out, kernels=False)
    if args.phase19_out:
        rep = {"card": card}
        counts = wide_serving_phase(rep, dev)
        with open(args.phase19_out, "w") as fh:
            json.dump({"wide_serving": rep["wide_serving"],
                       "launches": counts}, fh)
        return 0
    if args.phase10_out:
        records = precision_kernel_phase({})
        with open(args.phase10_out, "w") as fh:
            json.dump(records, fh)
        return 0
    phase_s = report["phase_s"] = {}

    def phase(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t
        return out

    entries = kernel_entries(phase("2", kernel_phase, report))
    entries += lm_kernel_entries(phase("6", lm_kernel_phase, report))
    entries.append(ssd_kernel_entry(phase("8", ssd_kernel_phase, report)))
    # Phase 2's wide cases after 6 and 8, whose profiles of short launches
    # are the ones that lose records
    wide_entries(entries, phase("2 wide", wide_kernel_cases, report))
    launches = {name: 0 for name in ALL_KERNELS}
    launches_bf16 = {name: 0 for name in ALL_KERNELS}
    dry = DryRun()          # phase 17a: started beside 15 and 16's child
    for name, fn, *rest in (
            ("3", serving_phase), ("4 lstm", autoencoder_phase, "lstm"),
            ("4 gru", autoencoder_phase, "gru"), ("5", step_backend_phase),
            ("5b", precision_serving_phase), ("5c", graph_phase),
            ("5d", durable_phase), ("5e", student_phase),
            ("5f", fleet_phase), ("5g", controller_phase),
            ("12", sharding_phase), ("7", lm_serving_phase),
            ("9", mamba_serving_phase), ("7b", lm_bf16_serving_phase),
            ("9b", mamba_bf16_serving_phase), ("7c", int8_kv_phase),
            ("13", moe_serving_phase), ("14", deepseek_serving_phase),
            ("15+16+18", zoo_serving_phases, dry),
            ("17", planning_phase, dry), ("19", wide_serving_child)):
        for kernel, v in phase(name, fn, report, dev, *rest).items():
            launches[kernel] += v
            if name in ("7b", "9b", "7c", "14", "15+16+18", "17"):
                launches_bf16[kernel] += v
    for kernel, v in phase("11", training_phase, report, dev).items():
        launches[kernel] += v
    lm_bf16_entries(entries, report["lm_kernel_cases"]
                    + report["ssd_kernel_cases"], launches_bf16)
    zoo_entries(entries, report["lm_kernel_cases"], report["zoo_launches"])
    encdec_entries(entries, report["lm_kernel_cases"],
                   report["encdec_launches"])
    # Last, in a process of its own (phase10_child).
    precision_entries(entries, phase("10", phase10_child, report))
    print("phase seconds " + json.dumps(phase_s), flush=True)
    for e in entries:
        e["launches"] = launches[e["name"]]
        if not e["launches"]:
            raise RuntimeError(f"{e['name']} was never launched on a "
                               "serving path")
    report["kernels"] = entries
    report["seconds"] = time.perf_counter() - t0
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(report, fh, indent=1)
    print(json.dumps({"kernels": entries}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
