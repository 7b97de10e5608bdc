"""Drive the PyTorch + CUDA port on one card and check it end to end.

    python3 chip_smoke.py

Phases, each one failing the script if it fails:

1. build every CUDA source of ``src/repro_torch/csrc`` with ``nvcc`` (all
   started together), print the ``-Xptxas -v`` summary and the count of
   tensor-core instructions (``HGMMA``, ``HMMA``) of each K9 and K2/K5 body
   in the built libraries' SASS (``cuobjdump -sass``), failing if K9's bf16
   body has none;
2. reference: serve dlrm-qr-smoke, dlrm-dense-smoke and dlrm-tt-smoke on the
   card and on the CPU (the kernels' plain versions) with the same weights
   and batches; the logits agree; ``EmbeddingEngine.cached_lookup`` on one
   dlrm-qr-smoke and one dlrm-dense-smoke table agrees between card and CPU
   with the same scheduler slots;
3. kernels: call K1 ``packed_qr_bag``, K3 ``packed_bag`` and K2
   ``packed_tt_bag`` at the shapes the full-width main path gives them
   (B = 2048, T = 26, K = 32, dim 128; the cache block holds this batch's
   most used big-table rows, as many as the plan's slot total: 16,384 rows
   of 512 B, 1,024 G2 rows of 8 KiB), and K5 ``tt_bag`` on one dlrm-tt
   table's cores as ``tt_embedding.lookup`` calls it (65,536 lookups of
   K = 1) and pooled (2,048 x 32); hold each against its plain PyTorch
   version on the same inputs (max abs error <= 1e-4, TF32 off), and time
   kernel, plain version and, where one exists, the one PyTorch call that
   computes the same function (``embedding_bag``) with CUDA events (K2 and
   K5: the whole wrapper call, sort, contraction and K sum, beside the
   body that ran, the batch's distinct middle-core rows and elements per
   row, the scratch round trip's floor and the earlier body's time); then
   the per-table kernels at one full-width table's shapes: K4b
   ``cached_qr_bag``, K6 ``gnr_bag`` and K8 ``qr_gather`` on dlrm-qr table 0
   (Q 31,360 x 128, R 64 x 128; (2,048, 32) bags, K4b's cache the batch's
   1,024 most used Q rows; 65,536 unpooled lookups), K4a ``cached_bag`` and
   K7 ``gnr_bag_dense`` on dlrm-dense table 0 (2,000,000 x 128), the same
   checks and times, K6 and K8 also in bf16; then the bf16 entries of K1,
   K3, K2 and K5 at the training path's shapes (train_8k: 8,192 x 26 bags
   of 32, all-miss slots and a 1-row cache; dlrm-dense at 200,000 rows per
   table).  Every bf16 output is held per element within one rounding of
   the plain version computed in fp32 on the same inputs: |out - plain| <=
   2^-8 |plain| + 1e-5 max|plain|.  The bag family's rows (K1, K3, K4, K6,
   K7) also give the time in a CUDA graph (device time without the host's
   per-call work, which sets the back-to-back time of a one-table bag) and
   K1 / K3 the profile readings of their body (``bag_profile``: unique
   bytes against the HBM peak, row-request rate, an all-in-cache probe);
   then K2 and K5 at rank 64 (dims 64 and 128, fp32 and bf16: the
   d2-sliced staging path), held to their plain versions and read for
   bitwise equality with them.  The per-table phase also logs the launch
   overhead: a one-table bag's back-to-back time minus its CUDA-graph time
   (``launch/mesh.py::DISPATCH_OVERHEAD_S`` holds a reading of it);
4. serve dlrm-qr at full width (26 x 2M rows, dim 128, pooling 32), batch
   2048, 6 batches, dlrm-dense at full width, 3 batches, and dlrm-tt at full
   width (26 x 2M logical rows as TT cores, rank 16), 6 batches, each in
   both modes with telemetry off: overlap logits equal sequential logits to
   1e-6, all finite, and the kernel's launch count equals the batches
   served in each run; then one fenced sequential run with telemetry on (4
   batches, dlrm-dense 3) on the same state and packed buffers: every span
   of each steady-state batch is there, ``engine/dispatch/serve_gather``
   counts the batches, the kernel launches once a batch, the traffic
   report's hit rate is the run's; it logs the attribution table
   (``obs.attribution``) and prints a ``{"serve_split": ...}`` line (stage
   -> ms per batch, the fenced total, the unfenced p50s); after
   ``obs.disable()`` and a reset the profiled run records nothing; then
   one ``tt_embedding.lookup`` on a dlrm-tt table launches K5 once; and
   ``serve_rec.main`` on dlrm-qr-smoke with the five telemetry flags
   (``--metrics-json --trace-out --slo --report --flight-dir``, outputs
   under ``build/serve_cli``), every artifact parsed;
5. the per-table paths at full width: ``engine_for(...).cached_lookup`` for
   4 batches of (2,048, 32) on dlrm-qr table 0 (K4b), dlrm-dense table 0
   (K4a) and dlrm-tt table 0 (K5), the scheduler prefetching the next batch
   between calls, one launch per batch, outputs equal to ``bag_lookup`` in
   fp32 to 1e-4; ``ops.qr_lookup`` (K8) and ``ops.gnr_pooled_dense`` (K7)
   once each; ``engine.lookup`` on 26 hashed tables of the dlrm-qr shape at
   (2,048, 26, 32) (the per-table branch: plain gathers) agrees with the
   CPU; the two examples run on the card (quickstart: K6 and K1 once each;
   cache_plan: K4b once per batch);
6. attention: ``ops.flash_attention_fused`` (K9) causal at qwen2-1.5b's width
   (batch 4, 12 query / 2 kv heads, D 128, seq 4,096), granite-34b's (batch
   1, 48 query heads on one kv head, seq 4,096), a 1,024-query block over
   a 4,096 cache, granite-moe-3b-a800m's (batch 4, 24 query / 8 kv heads
   of D 64, seq 4,096), zamba2-7b's shared block (batch 2, 32 query
   heads over 32 kv heads of D 112: the 128 bucket, zero fill past column
   112) and whisper-large-v3's non-causal encoder (batch 4, 20 / 20 heads
   of D 64, 1,536 x 1,536) and cross-attention (4,096 queries over 1,536
   keys), each in fp32 and bf16, then one backward (blockwise
   recompute) against plain autograd; every output held against K9's plain
   version (bf16 by the one-rounding rule of phase 3) and timed beside its
   bound, ``scaled_dot_product_attention`` and the earlier body's time, each
   case naming its body (fp32 on the CUDA cores, bf16 on the tensor cores);
   then K9 with ``p_bf16`` (``repro``'s bf16 probability tile) at
   qwen2-1.5b's shape in both bodies, held against its plain version
   ``layers.flash_attention(p_dtype=torch.bfloat16)`` over kv blocks of the
   body's tile (``P_TILE_RULES``: fp32 to the sums' order; bf16 within a
   rounding of each probability and of the output, and nearer the rounded
   plain version than the unrounded one; the default body on the same
   inputs must fail the rule) and timed beside the default body;
7. training: 4 steps each of dlrm-qr and dlrm-tt at full width and of
   dlrm-dense at 200,000 rows per table, batch 8,192 (train_8k), through
   ``train_step.make_train_step``: finite losses and gradient norms, one
   launch of the packed kernel (bf16 entry) per step, step-1 table
   gradients on a cut batch within ``GRAD_TOL`` of a plain path whose
   embedding-bag backward runs in fp32, the lookup's backward on that batch
   across 52 recompute chunks within one bf16 rounding (``RECOMPUTE_RULE``)
   of the exact fp32 gradient, ms per step split into forward, backward and
   update, peak memory; the training CLI (``launch.train --arch dlrm-qr``,
   4 steps at full width); one ``tt_embedding.lookup`` on bf16 cores under
   grad (K5 bf16); and the train-DLRM example at TT rank 64
   (``examples.train_dlrm --embedding tt --tt-rank 64``, 25 steps: K2 bf16
   on the sliced staging path);
8. the serving control plane: ``tune.fit(mode="measure", max_samples=4)``
   on full-width dlrm-qr traces at batch 2,048 (each sample's knobs,
   features and CUDA-event time logged, then the coefficients and the
   choice, which must lie in the knob space and be what ``plan(tuner=)``
   freezes), ``build_serve_state(tuner=)`` and 5 sequential batches (the
   prediction against the tuned plan's ``serve_gather`` by CUDA events and
   against its whole batches, and the drift monitor); one batch of 2,048
   through every rung of the degradation ladder on dlrm-qr, dlrm-tt and
   dlrm-dense (1,000,000 rows a table: the ladder holds three copies of the
   tables): rungs 0-2 bitwise identical, ``baseline`` within
   ``BASELINE_TOL``, the packed kernel launched once a call on ``full`` and
   ``nocache``, once per table on ``pertable``, never on ``baseline``, ms a
   batch of each; a chaos session of the front end on full-width dlrm-qr in
   ``measured`` mode (flash crowd, stall, replica loss, gather errors, a
   dropped prefetch): no request unaccounted, the ladder steps down and
   comes back to ``full``; at batch 256, a stationary adaptive session
   bitwise ``run_pipeline``'s, the controller's host cost (one ``observe``,
   one ``evaluate``), then a drifting session with ``refit=True`` on the
   tuner-armed state; ``serve_rec.main`` on dlrm-qr-smoke with ``--frontend
   --arrival --faults`` and with ``--adapt --drift`` (records under
   ``build/serve_cli``);
9. the sharded two-level GnR (``engine.gnr``, ``forward_partial``,
   ``inline_gnr``, ``baseline``), batch 2,048, bf16: world 1 over nccl in
   this process (mesh (1, 1), full-width dlrm-qr): ``gnr`` against the
   single-card ``lookup``, then a duplication plan of a 1 TiB budget (every
   table comm-free) that calls no collective; then four ranks over gloo on
   the one card (``launch.mesh.spawn``, mesh (1, 4), the kernels built here
   first): full-width dlrm-qr and dlrm-tt and dlrm-dense at 1,000,000 rows
   a table, each on the packed plan (one launch of K1 / K2 / K3 a rank a
   call on its routed streams), the per-table plan, duplication at 1 TiB
   (comm-free: no collective) and at 1 MiB (hot rows, mixed), and
   ``baseline`` on dlrm-qr (raw rows on the wire); every output held to
   ``SHARDED_RULE`` against the fp32 sum over the bf16-rounded tables and
   the single-card bf16 ``lookup``, every rank's output the same; per rank
   the gnr call (host clock), the local partial (CUDA events) and the
   combine (host clock), the bytes combined beside
   ``DuplicationPlan.ici_bytes_per_batch``; whether gloo reduced bf16 CUDA
   tensors and how; ``forward_dlrm`` under ``use_rules`` on a (2, 2) mesh
   of the same ranks (dlrm-qr, fp32 compute) against the single card to
   ``DLRM_TOL``.  A rank's exception or the ranks' timeout fails the script;
10. DLRM training on a mesh (``launch.train --mesh-shape``'s path: the
   params placed by their logical axes, the loss under ``use_rules``,
   ``inline_gnr`` -> ``forward_partial`` under grad, the data-axis gradient
   mean, AdamW on each rank's blocks with the mesh's global norm), batch
   8,192, bf16: the single-card references first (step-1 gradients, two
   steps' losses and norms, the lookup's backward at 4,096 bags); world 1
   over nccl in this process (mesh (1, 1), full-width dlrm-qr): the meshed
   step-1 gradients within ``GRAD_TOL`` of the single card's per leaf,
   bitwise or not recorded, loss and norm within ``MESH_LOSS_TOL``; four
   gloo ranks on the card, mesh (2, 2) (4,096 bags a ``data`` rank):
   full-width dlrm-qr and dlrm-tt and dlrm-dense at 50,000 rows a table,
   two steps each: the step-1 gradients, gathered to the
   logical shapes, within ``GRAD_TOL`` of the single card's per leaf, the
   two losses and norms within ``MESH_LOSS_TOL``, one packed launch a
   rank a step, a step's collectives (one combine, one entry psum for QR and
   TT, one data mean, one norm); ms a step (host clock, max over ranks), one
   step split into forward, backward, gradient mean and update, bytes
   all-reduced a rank a step on each axis, peak memory a rank, a rank's
   local backward alone against the single card's at the same bags (the
   share of accesses routed to the zero row beside it), with the zero rows
   left out of the recompute (what the step runs), traced by the profiler
   (top device operations); the fp32 reading: the single card fed the mesh's fp32
   pooled values against the mesh's fp32 step-1 gradients, and the top
   MLP's ReLUs the pooled values flip (bf16 and fp32); then the CLI's
   elastic drill (``launch.train --arch dlrm-qr --mesh-shape 2,2 --steps 2
   --ckpt-dir D``, then ``--mesh-shape 4,1 --steps 4``, batch 2,048, full
   width): both exit 0, the second resumes at step 2, the checkpoint holds
   the full logical arrays;
11. the dense transformer served (``launch.serve``'s path:
   ``transformer.forward_prefill`` with K9 in every layer, K8 for a QR
   vocabulary's tokens, ``forward_decode`` on the in-place cache):
   ``[lm-ref]`` the four dense smoke configs (qwen2-1.5b, granite-34b,
   chatglm3-6b, minitron-4b) with a dense and a QR (collision 8) vocabulary
   on the card and on the CPU, same weights and tokens: fp32 logits of
   ``forward_train``, prefill and decode within 1e-4, the greedy tokens
   equal, bf16 within 2e-2 of scale, K9 once a layer a forward and K8 once
   a QR ``embed_tokens``; qwen2-1.5b at full width and depth (28 layers)
   with the dense and the QR vocabulary (collision 64): ``repro``'s
   decode-vs-train consistency in fp32 at batch 2, sequence 256 (5e-5), K9
   on layer 0's own q/k/v at 4,096 tokens against the plain blockwise
   attention (fp32 1e-4, bf16 one rounding), ``prefill_32k`` at the largest
   batch that fits (the QR run at one sequence, ``QR_PREFILL_BATCH``) by the
   dry run (``launch.dryrun.fit``: the prefill
   traced on meta at batches 1 and 2, a third trace confirming; ms,
   tokens/s, K9's ms and share by CUDA events around every
   attention call, peak memory, the FLOP bound; K9 on the call's own
   layer-0 q/k/v and K8 on its lookups held against their plain versions)
   and ``decode_32k`` (one step against 32,768 positions at the largest
   batch whose cache fits: ms, tokens/s, peak memory, the bytes bound; each
   step's K8 call held against the plain sum), on the weights cast once to
   bf16; ``launch.serve --arch qwen2-1.5b --batch 8 --prompt-len
   512 --max-new 32`` with each vocabulary; chatglm3-6b and minitron-4b at
   full depth and granite-34b at the depth whose fp32 params fit: the fp32
   consistency at batch 1, sequence 128, and one ``greedy_generate`` at
   batch 4, prompt 512, 16 new tokens;
12. the dense transformer trained (``launch.train``'s path:
   ``registry.train_loss_fn`` -> ``next_token_loss`` on
   ``transformer.forward_train``, each layer under
   ``torch.utils.checkpoint``, K9 in every layer's forward and again in
   its recompute, the blockwise attention backward, K8 / K5 for a QR / TT
   vocabulary with the chunked plain recompute as backward;
   ``make_train_step``'s fp32 accumulation; AdamW): ``[lm-train-ref]``
   one step (2 microbatches) of the four dense smoke configs with a
   dense, a QR (collision 8) and a TT (``tt_exec="pallas"``) vocabulary
   on the card and on the CPU, same weights and tokens: fp32 loss within
   1e-5 relative, updated params and the batch's gradients within 1e-5 of
   each leaf's scale, bf16 loss within 2e-2, each step's launches counted;
   qwen2-1.5b at full width and depth, S 4,096 (train_4k), with the QR
   (collision 64) vocabulary under remat ``full`` (the dense vocabulary's
   step, the CLI and the profiled backward left the phase to make room
   for phase 15): the microbatch that fits by the dry run's traces of
   the step (the allocator's expandable segments on for the phase), then
   one step of 2 microbatches (train_4k's 256
   cut): ms a step and tokens/s, the split into forward, backward and
   update (CUDA events), K9's ms in the forwards and in the recompute,
   the blockwise attention backward's ms, peak memory, the model-FLOP
   bound and its share, K9 on the step's layer-0 q/k/v and K8 on its
   lookups held against their plain versions; one step with the TT
   vocabulary (K5's launches and ms, its first two calls held to 1e-4
   against the plain version); the step-1 gradients of a 2-layer cut at
   full width, each vocabulary, within 2^-6 of each leaf's scale of the
   same step through the kernels' plain versions on the card; remat
   ``dots`` at that cut against ``full`` (read for bitwise equality, held
   to 2^-6); each section's seconds;
13. the dense transformer trained on a mesh (``launch.train --mesh-shape``'s
   path: the params placed by ``sharding.lm_param_rules``, the loss under
   ``use_rules``, the tokens through the two-level GnR
   (``sharded_embedding.token_embed_inline``: K8 on each rank's routed Q
   shard, one combine), every layer tensor-parallel over ``model`` with K9
   on the rank's heads, the vocab-parallel loss, the data-axis gradient
   mean, AdamW on each rank's blocks): world 1 over nccl in this process
   (mesh (1, 1), qwen2-1.5b at full width cut to 2 layers, QR
   ``twolevel``, S 4,096, batch 2) against phase 12's single-card step,
   gradients, losses, norm and new params read for bitwise equality and
   held to 1e-5 of scale; two gloo ranks on the card, mesh (1, 2), at full
   width and depth with the QR vocabulary (collision 64, ``twolevel``,
   remat ``full``, S 4,096), ``LMM_MICROBATCH`` sequences a rank (a
   constant chosen for the script's time), two steps; four, mesh
   (2, 2), with the dense vocabulary: the fp32 step-1 gradients at 2
   layers, gathered, within 1e-5 of each leaf's scale of the single card's
   on the same data partition (each data block's gradient, averaged),
   at 6 layers (``LMM_DENSE_LAYERS``, a constant for the script's time
   below the 10-11 the line through depths 1 and 2 fitted), the bf16 step-1
   gradients there no more than ``LMM_BF16_FACTOR`` times as far from the
   single card's fp32-compute gradients as the single card's bf16 ones,
   two steps; per mesh ms a step (max over ranks), the split into forward,
   backward, gradient mean and update, bytes all-reduced a rank a step by
   axis, collectives a step, peak memory a rank, K9 and K8 ms a call and
   launches, and on rank (0, 0)'s own calls K9 on layer 0's local q/k/v
   within one rounding of its plain version and K8 bitwise the plain sum
   on the routed streams (its CLI drills now run in phase 15);
14. the MoE transformers (``models/moe.py``: the fp32 router's top-k,
   capacity-bounded dispatch, the experts' SwiGLU products, the combine
   added over k in order, no atomics; K9 in every layer at D 64, K8 for a
   QR vocabulary): ``[moe-ref]`` granite-moe-3b-a800m-smoke and
   qwen3-moe-235b-a22b-smoke with a dense and a QR (collision 8)
   vocabulary on the card and on the CPU, same weights and tokens, fp32:
   the routing of every layer call equal (the smallest top-k margin
   printed), ``forward_train``, prefill and decode logits within 1e-4, the
   greedy tokens equal, one step of 2 microbatches (loss to 1e-5
   relative, updated params and gradients to 1e-5 of each leaf's scale);
   granite-moe-3b-a800m at full width and depth (32 layers, 40 experts
   top 8) with the dense and the QR (collision 64) vocabulary:
   ``repro``'s decode-vs-train consistency in fp32 at batch 2, sequence
   256 at capacity factor 5.0 (no drops; at 1.25 a decode step drops by
   design), K9 on layer 0's own q/k/v (fp32 1e-4, bf16 one rounding),
   layer 0's MoE on its own input (1 x 4,096, fp32, factor 5.0) within
   1e-4 of scale of the per-token mixture over the 40 experts on the
   card's routing (dense vocabulary), ``prefill_32k`` and ``decode_32k``
   as phase 11 runs them, with the MoE layers' ms and share (events
   around each call) and the share of assignments dropped, the FLOP bound
   on the active weights; ``launch.serve --arch granite-moe-3b-a800m
   --batch 8 --prompt-len 512 --max-new 32`` with each vocabulary;
   qwen3-moe-235b-a22b at full width and the depth whose fp32 params fit
   (consistency at batch 1, sequence 128, factor 16.0; one
   ``greedy_generate``); training on one card (the allocator's expandable
   segments): granite-moe, QR, S 4,096, remat ``full``, batch 1, at the
   depth the dry run fits, 3 steps (losses finite,
   ms a step, tokens/s, the forward / backward / update split, K9's and
   the MoE layers' ms, peak), the step-1 gradients of a 2-layer cut
   against the kernels' plain versions within 2^-6 (the plain path on
   the kernel path's routing; the tokens its own top-k would route
   otherwise counted); world 1 over nccl (2 layers, QR
   ``twolevel``, S 4,096, batch 2) against the single card, read for
   bitwise equality; two gloo ranks on the card, mesh (1, 2), 4 layers,
   20 experts and 12 q / 4 kv heads a rank, one sequence: the fp32 step-1
   gradients at factor 5.0, gathered, within 1e-5 of each leaf's scale of
   the single card's, two bf16 steps whose losses hold the single card's
   to 2e-2, ms a step, bytes combined a rank, collectives a step;
15. the sub-quadratic models (``models/mamba2.py``, ``zamba2.py``,
   ``xlstm.py``: the SSD chunk scan, the mLSTM chunk loop and the sLSTM
   time loop in plain torch, the sLSTM's forward and written-out backward
   in blocks of steps replayed as CUDA graphs; K9 at each zamba2
   shared-attention site at D 112,
   K8 for a QR vocabulary): ``[ssm-ref]`` zamba2-7b-smoke and
   xlstm-125m-smoke with a dense and a QR (collision 8) vocabulary on the
   card and on the CPU, same weights and tokens, fp32: the train logits,
   the serve family's prefill (logits and every cache or state leaf) and
   decode within 1e-4, the greedy tokens equal, K9 once a site and K8 once
   a QR lookup, one step of 2 microbatches (loss to 1e-5 relative,
   gradients to 1e-5 of each leaf's scale, or to twice fp32's own distance
   from fp64 where that is larger, the updated params read); the sLSTM
   scan at xlstm's width graphed against eager, served and trained,
   bitwise; zamba2-7b at full width and depth (81 layers, 13 sites) and
   xlstm-125m (12 layers, 3 sLSTM), each with the dense and the QR
   (collision 64) vocabulary, the body weights shared: ``repro``'s
   decode-vs-train consistency (zamba2 in fp32, batch 2, 255 + 1 tokens,
   1e-4; xlstm 9 steps, 2e-4, held in fp64 compute and read in fp32,
   whose rounding alone is further than that at full width), zamba2's K9
   on site 0's own q/k/v (bf16, one rounding), the fp32 params dropped
   after the bf16 cast, ``prefill_32k`` at the batch the dry run fits
   for the dense run (on meta the sLSTM's loop runs one step) and at one
   sequence for the QR run (``QR_PREFILL_BATCH``), with K9's,
   the mamba layers' or the
   sLSTM / mLSTM blocks' ms and share (events around each call), peak,
   the flop bound, K9 on site 0's q/k/v and K8 on its lookups held to
   their plain versions, zamba2's K9 against SDPA; ``decode_32k`` at the
   largest batch whose cache fits (xlstm 128), ``long_500k`` (one step at
   position 524,287, batch 1; zamba2 at the depth whose cache fits) with
   the QR vocabulary; ``launch.serve --arch zamba2-7b --batch 4
   --prompt-len 512 --max-new 16`` with each vocabulary, ``--arch
   xlstm-125m`` (QR) and ``examples.serve_lm`` with its defaults; training
   on one card (the allocator's expandable segments), QR, S 4,096:
   xlstm-125m at full depth, one step of 2 microbatches of 1 sequence,
   zamba2-7b at the depth the dry run fits, 2 steps
   (ms a step, the forward / backward / update split, K9's ms, peak); the
   step-1 gradients of a cut (zamba2 one 6-layer segment and its site, in
   fp32, and read in bf16, where its all but vanished hidden state makes
   them ill-conditioned; xlstm its first 4 layers) within 2^-6 of each
   leaf's scale of the kernels' plain versions on the card;
   ``launch.train --arch xlstm-125m --smoke --embedding qr --seq 512 --batch 4
   --steps 2 --mesh-shape 1,2``, then ``--steps 4`` on one card, which
   prints ``[resume] step 2``; on a mesh (``ssm_mesh_start`` /
   ``ssm_mesh_finish``, started once phase 17's children have and held
   after them): world 1 over nccl (zamba2 at 6 layers, xlstm at 4, QR, bf16: the prefill, the
   cache or states, 4 greedy steps and the step-1 gradients bitwise the
   single card's), then one spawn of (1, 2) gloo ranks on the card: one
   full-width zamba2-7b mamba layer and the shared block on unit-scale
   hidden states (2 x 1,024 + 4 decode steps), their outputs and gathered
   states against one card's (fp32 within 1e-5 of scale, bf16 within 2x
   the single card's own distance); zamba2-7b at 12 layers (2 x 1,024 + 8
   steps) and xlstm-125m at full depth (2 x 4,096 + 16 steps), QR, served
   (prefill and decode ms, the collectives by site, peak a rank), their
   logits teacher-forced against the single card's fp32-compute logits
   (within 2x its own bf16 distance), K9 and K8 held on rank (0, 0)'s own
   calls, zamba2's prefill peak within 10% of the dry run's trace of that
   rank; the step-1 gradients gathered (xlstm full depth bf16 within 2x the
   single card's distance from fp32; zamba2 6 layers fp32 within 1e-5 of
   scale, or twice fp32's own distance from fp64 where larger);
   Every full-width LM cell of phases 11, 12, 14, 15 and 16 (prefill,
   decode, ``long_500k``, a training step) holds its measured peak
   (``torch.cuda.max_memory_allocated`` above the call's baseline) within
   10% of the dry run's prediction of the same call, kept tensors
   included; each reading is logged and a miss fails the script at its
   end;
16. the prefix models (``models/whisper.py``: the encoder over 1,536
   frames with K9 non-causal, the decoder's causal self-attention and its
   cross-attention to the encoder states through K9, the cross k / v
   frozen in the cache; ``models/pixtral.py``: 256 patches in front of the
   tokens, K9 causal over both; K8 for a QR vocabulary):
   ``[prefix-ref]`` whisper-large-v3-smoke and pixtral-12b-smoke with a
   dense and a QR (collision 8) vocabulary on the card and on the CPU, the
   weights carried by ``convert``, the same frames / patches and tokens,
   fp32: train logits, prefill (logits and every cache leaf) and decode
   within 1e-4, greedy tokens equal, K9 once an attention, ``repro``'s
   decode-vs-train consistency (5e-5 / 1e-4); whisper-large-v3 at full
   width and depth (32 + 32 layers) with the dense and the QR vocabulary
   (the body shared), pixtral-12b at full width and depth (40 layers)
   with the QR vocabulary, each drawn in fp32 and cast once to bf16, the
   fp32 tree freed and the peak recorded: ``prefill_32k`` at the batch the
   dry run fits (whisper's QR run at one sequence; ms, tokens/s, the FLOP bound, K9's
   share, whisper's encoder and decoder ms), K9 on the call's own q/k/v
   at each kind of site (non-causal, causal, cross) within one rounding,
   K8 bitwise the bf16 sum, K9 against SDPA at the decoder's and the
   cross shapes; ``decode_32k`` at the batch whose cache fits (ms a step,
   the bytes bound, the device's busy time); ``launch.serve --smoke`` and
   ``launch.train --smoke`` for each; training on one card, QR, S 4,096,
   remat ``full``: whisper at full depth, 4 sequences in 2 microbatches,
   pixtral at the depth the dry run fits, batch 1,
   2 steps each (ms a step, the split, K9's ms, peak); the step-1
   gradients of a 2-layer cut within 2^-6 of the kernels' plain versions;
   on a mesh (``prefix_mesh_start`` / ``prefix_mesh_finish``, started once
   phase 17's children have and held after them): world 1 over nccl
   (whisper at 2 + 2 layers, pixtral at 2, QR, bf16: the prefill, the
   cache, 4 greedy steps and the step-1 gradients bitwise the single
   card's), then one spawn of (1, 2) gloo ranks on the card: whisper at
   full width and depth (2 x (1,536 frames + 1,024 tokens) + 8 steps) and
   pixtral at 4 layers (2 x (256 patches + 1,024) + 8), QR, served
   (prefill and decode ms, the collectives by site, peak a rank), their
   logits teacher-forced against the single card's fp32-compute logits
   (within 2x its own bf16 distance), K9 at each kind of site (the
   cross-attention's local q/k/v among them) and K8 held on rank (0, 0)'s
   own calls, whisper's prefill peak within 10% of the dry run's trace of
   that rank; the step-1 gradients gathered (whisper 4 + 4 layers fp32
   within 1e-5 of scale or twice fp32's own distance from fp64, whisper in
   bf16 and pixtral 2 layers within 2x the single card's distance);
17. the launchers' drills on a mesh, each meshed run a child and the
   children side by side: DLRM (2, 2) then (4, 1) resuming; qwen2-1.5b and
   whisper-large-v3 smoke trained on (1, 2), then one card resuming;
   xlstm-125m at full width on one card, (1, 2), one card; ``launch.serve
   --mesh-shape 1,2`` in fp32 for qwen2, zamba2, whisper and pixtral smoke
   printing the one-card command's first sequence.

It prints the card's name and power limit, one ``{"serve_split": ...}``
line per served config, one ``{"training": [...]}`` line, one
``{"control_plane": ...}`` line, one ``{"sharded": ...}`` line, one
``{"mesh_training": ...}`` line, one ``{"lm_serving": ...}`` line, one
``{"lm_training": ...}`` line, one ``{"lm_mesh_training": ...}`` line,
one ``{"moe": ...}`` line, one ``{"sub_quadratic": ...}`` line, one
``{"prefix": ...}`` line, one ``{"cli_drills": ...}`` line, one
``{"dryrun": ...}`` line (the traces'
seconds, every cell's peak hold), one ``{"kernels": [...]}`` line, and last
``{"ok": true, "device": {...}}``.  Without a CUDA card it exits with code 2 and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# the card's datasheet rates, one definition for the port and this script
from repro_torch.launch.mesh import (  # noqa: E402
    DISPATCH_OVERHEAD_S, HBM_BW as BW_BYTES_S, PEAK_FLOPS_BF16 as BF16_FLOP_S,
    PEAK_FLOPS_FP32 as FP32_FLOP_S,
)
# the kernels' work (the bound column's formulas), one definition for the
# dry run (``launch.dryrun``, on meta) and this script
from repro_torch.kernels.bounds import flash_flops, tt_flops  # noqa: E402
ERR_TOL = 1e-4
BF16_TOL = 1e-2      # card and CPU each round an fp32 sum to bf16 once
# the previous bodies' times on an NVIDIA H100 80GB HBM3 at 700 W, ranges
# over calls (PERF.md, kernel table): K9 and K2/K5 before their sorted-run
# and tensor-core redesign, the bag family (K1, K3, K4, K6, K7) before the
# table-major body.  Printed in
# the log lines beside this run's times, never in the kernels line
EARLIER_MS = {
    "flash_fwd": {"float32": [8.2697, 8.3049], "bfloat16": [8.2338, 8.2617]},
    "packed_tt_bag": [8.3476, 8.5560], "packed_tt_bag_bf16": [32.9784, 33.2118],
    "tt_bag": [0.3442, 0.3700], "tt_bag_bf16": [0.3348, 0.3379],
    "packed_qr_bag": [0.1903, 0.1935], "packed_qr_bag_bf16": [0.4781, 0.4814],
    "packed_bag": [0.1683, 0.1739], "packed_bag_bf16": [0.3597, 0.3619],
    "cached_qr_bag": [0.0223, 0.0432], "gnr_bag": [0.0196, 0.0379],
    "cached_bag": [0.0197, 0.0431], "gnr_bag_dense": [0.0171, 0.0383],
}


def log(*a) -> None:
    print(*a, flush=True)


# the kernel function of each body in the built libraries' SASS
SASS_KERNEL = {("flash", torch.float32): "flash_kernel", ("flash", torch.bfloat16): "flash_tc_kernel",
               ("tt", torch.float32): "tt_rows_kernel<float>",
               ("tt", torch.bfloat16): "tt_rows_kernel<bf16>"}
_MANGLED = {"flash_kernel": "12flash_kernelI", "flash_tc_kernel": "15flash_tc_kernelI",
            "tt_rows_kernel<float>": "14tt_rows_kernelIf",
            "tt_rows_kernel<bf16>": "14tt_rows_kernelI13__nv_bfloat16"}


def tensor_core_sass(build) -> dict:
    """HGMMA and HMMA instructions in the built libraries (``cuobjdump
    -sass``), summed over each body's instances: the proof that K9's bf16
    body runs on the tensor cores (the script fails if it has none; the
    K2/K5 bodies compute in fp32 on the CUDA cores in both types)."""
    out = {}
    for src, kind in (("flash_attention", "flash"), ("tt_bag", "tt")):
        counts = build.sass_counts(src)
        out[src] = {}
        for dtype in (torch.float32, torch.bfloat16):
            name = SASS_KERNEL[kind, dtype]
            out[src][name] = {op: sum(c[op] for fn, c in counts.items() if _MANGLED[name] in fn)
                              for op in ("HGMMA", "HMMA")}
            log(f"[sass] {src}.cu {name}: {out[src][name]}")
    tc = out["flash_attention"][SASS_KERNEL["flash", torch.bfloat16]]
    if tc["HGMMA"] + tc["HMMA"] <= 0:
        raise AssertionError("flash_attention: the bf16 body has no tensor-core instruction")
    return out


def timed(fn, reps: int, warm: int = 2) -> float:
    """Mean ms per call over ``reps`` calls, CUDA events, after ``warm``."""
    for _ in range(warm):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, calls: int = 20, reps: int = 10) -> float:
    """Device ms per call: ``calls`` calls captured in one CUDA graph and
    replayed ``reps`` times (CUDA events), so the host's per-call work (the
    wrapper's checks, the ctypes call) does not gate the launches as it does
    in ``timed`` for kernels of a few microseconds."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    ms = timed(graph.replay, reps) / calls
    del graph
    return ms


# ---------------------------------------------------------------------------
# phase 2: the card against the CPU on small inputs
# ---------------------------------------------------------------------------

def reference_phase(dev, serve_rec, registry, dlrm, synthetic) -> None:
    for arch in ("dlrm-qr-smoke", "dlrm-dense-smoke", "dlrm-tt-smoke"):
        cfg = registry.get_dlrm(arch)
        params_cpu = dlrm.init_dlrm(cfg, seed=1, device="cpu")
        params_gpu = {k: [{n: v.to(dev) for n, v in p.items()} for p in layers]
                      for k, layers in params_cpu.items()}
        data = [synthetic.dlrm_batch(cfg, 16, seed=0, step=t) for t in range(4)]
        res = {}
        for where, params in (("cpu", params_cpu), ("gpu", params_gpu)):
            res[where] = serve_rec.run_pipeline(
                cfg, mode="sequential", params=params, data=data,
                device="cpu" if where == "cpu" else dev)
        err = max(float(np.abs(a - b).max())
                  for a, b in zip(res["cpu"]["logits"], res["gpu"]["logits"]))
        # bf16 head on two kinds of hardware: products may round one step apart
        if err > 5e-2 or res["cpu"]["hit_rate"] != res["gpu"]["hit_rate"]:
            raise AssertionError(f"{arch}: card vs CPU logits differ by {err}")
        log(f"[reference] {arch}: card vs CPU max |logit diff| {err:.3e}, "
            f"hit rate {res['gpu']['hit_rate']:.4f} on both")


def cached_reference_phase(dev, registry, dlrm, synthetic, qr_embedding, engine) -> None:
    """``cached_lookup`` on one smoke table, card against CPU, fed the same
    scheduler slots: the CPU runs the plain version, the card K4b / K4a."""
    for arch in ("dlrm-qr-smoke", "dlrm-dense-smoke"):
        cfg = registry.get_dlrm(arch)
        bag = dlrm.make_bags(cfg)[0]
        params = qr_embedding.init(bag.emb, generator=torch.Generator().manual_seed(2),
                                   device="cpu")
        eng = engine.engine_for(engine.EngineSpec.from_bags([bag], cache_slots=cfg.cache_slots))
        sched = eng.fresh_schedulers()[0]
        idx = synthetic.zipf_batch(cfg.vocab_per_table, (16, cfg.pooling), seed=3)
        rows = engine.big_rows(idx.numpy(), bag.emb)
        sched.prefetch(rows)
        slot = torch.from_numpy(sched.slots_for(rows))
        cache_rows = torch.from_numpy(sched.cache_rows())
        out = {}
        for where in ("cpu", dev):
            to = lambda t: t.to(where)
            out[str(where)] = eng.cached_lookup(
                {k: to(v) for k, v in params.items()}, to(idx), 0,
                cache_rows=to(cache_rows), slot=to(slot)).cpu()
        err = float((out["cpu"] - out[str(dev)]).abs().max())
        if not err <= ERR_TOL:
            raise AssertionError(f"{arch}: cached_lookup card vs CPU differ by {err}")
        log(f"[reference] {arch} cached_lookup: card vs CPU max abs diff {err:.3e}, "
            f"hit share {float((slot >= 0).float().mean()):.3f}")


# ---------------------------------------------------------------------------
# phase 3: the kernels at the main path's shapes
# ---------------------------------------------------------------------------

def plan_slots(cfg, layout) -> int:
    """The plan's cache-slot total: ``cache_slots`` per table, clamped so the
    block fits ``cache_vmem_mb`` (``tune/knobs.py:slot_budgets``)."""
    return min(cfg.cache_slots * cfg.num_tables,
               cfg.cache_vmem_mb * 2**20 // (layout.big_width * 4))


def main_path_streams(cfg, layout, pt, synthetic, dev, *, batch):
    """One full-width batch's packed (G, K) streams, with this batch's most
    used big-table rows staged in the cache block, as many as the plan has
    slots (the prefetcher's rule, applied to the packed buffer)."""
    idx = synthetic.zipf_batch(cfg.vocab_per_table, (batch, cfg.num_tables, cfg.pooling),
                               seed=11, step=0, device=dev)
    streams = {k: v.reshape(-1, cfg.pooling) for k, v in pt.pack_indices(idx, layout).items()}
    big = streams[{"qr": "q_idx", "tt": "i2"}.get(layout.kind, "idx")]
    streams["slot"], top = top_slots(big, layout.total_rows + 1, plan_slots(cfg, layout))
    return streams, top


def top_slots(big: torch.Tensor, rows: int, slots: int):
    """The batch's ``slots`` most used rows of a (B, K) stream, staged as the
    cache block: (slot stream, staged row ids)."""
    counts = torch.bincount(big.reshape(-1).long(), minlength=rows)
    top = torch.topk(counts, slots).indices
    slot_of = torch.full_like(counts, -1)
    slot_of[top] = torch.arange(slots, device=big.device)
    return slot_of[big.long()].to(torch.int32), top


def bound(streams, read_bytes: int, out_bytes: int, flops: int, *,
          flop_s: float = FP32_FLOP_S):
    """(bound_ms, bound_by, bytes): each input byte read once (the index
    streams, plus ``read_bytes`` of unique rows this batch touches), each
    output byte written once; ``flops`` over the peak ``flop_s`` of their
    type (fp32 by default)."""
    nbytes = sum(s.numel() * 4 for s in streams) + read_bytes + out_bytes
    t_bytes, t_ops = nbytes / BW_BYTES_S, flops / flop_s
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations",
            nbytes)


def unique(t: torch.Tensor) -> int:
    return int(torch.unique(t).numel())


BF16_ULP = 2.0 ** -8    # rounding to nearest bf16 moves a value by at most 2^-8 of it
ROUND_ATOL = 1e-5       # of the output's scale: the fp32 sums' order, kernel against plain
ROUND_RULE = "|out - plain fp32| <= 2^-8 |plain fp32| + 1e-5 max|plain fp32|"


def one_rounding(out: torch.Tensor, plain32: torch.Tensor) -> tuple[float, float]:
    """A bf16 ``out`` against the plain version computed in fp32 on the same
    inputs: (worst ratio of |out - plain32| to 2^-8 |plain32| + ROUND_ATOL x
    max|plain32|, max abs error).  A kernel that computes in fp32 and rounds
    its output once reads <= 1; a dropped or misweighted term reads far
    above."""
    p = plain32.float()
    d = (out.float() - p).abs()
    atol = max(ROUND_ATOL * float(p.abs().max()), 1e-30)
    return float((d / (p.abs() * BF16_ULP + atol)).max()), float(d.max())


def hold(name: str, got: torch.Tensor, plain, args) -> dict:
    """Hold a kernel's output against its plain version on the same inputs:
    fp32 to ``ERR_TOL`` max abs error; bf16 per element within one rounding
    of the plain version computed in fp32 on the inputs widened exactly
    (``one_rounding``).  Returns the row's error keys."""
    if got.dtype == torch.float32:
        err = float((got - plain(*args)).abs().max())
        if not err <= ERR_TOL:
            raise AssertionError(f"{name}: kernel vs plain max abs error {err}")
        return {"max_abs_err": err, "tolerance": ERR_TOL}
    wide = [a.float() if a.is_floating_point() else a for a in args]
    ratio, err = one_rounding(got, plain(*wide))
    if got.dtype != torch.bfloat16 or not ratio <= 1.0:
        raise AssertionError(f"{name}: {got.dtype}, max |kernel - plain fp32| {err}, "
                             f"{ratio} of one bf16 rounding")
    return {"max_abs_err": err, "rounding_ratio": ratio, "tolerance": ROUND_RULE}


def fmt_err(c: dict) -> str:
    return f"err {c['max_abs_err']:.3e}" + (
        f" ({c['rounding_ratio']:.3f} of one bf16 rounding)" if "rounding_ratio" in c else "")


def staged(cfg, layout, pt, synthetic, dev, batch: int, dtype, big: torch.Tensor):
    """The packed (G, K) streams and cache block a packed kernel gets on its
    path: serving (fp32) stages the batch's most used rows of ``big``, as
    many as the plan has slots (``main_path_streams``); the training lookup
    (bf16, ``packed_multi_bag_lookup``) passes all-miss slots and a 1-row
    zero cache."""
    if dtype == torch.float32:
        s, top = main_path_streams(cfg, layout, pt, synthetic, dev, batch=batch)
        return s, big[top]
    idx = synthetic.zipf_batch(cfg.vocab_per_table, (batch, cfg.num_tables, cfg.pooling),
                               seed=14, step=0, device=dev)
    s = {k: v.reshape(-1, cfg.pooling) for k, v in pt.pack_indices(idx, layout).items()}
    s["slot"] = torch.full_like(next(iter(s.values())), -1)
    return s, pt.dummy_cache(layout, dtype, dev)


def bag_case(dev, name, batch, dtype, registry, dlrm, synthetic, pt, pg, ref) -> dict:
    """K1 ``packed_qr_bag`` or K3 ``packed_bag`` on the packed streams and
    cache block their path gives them (``staged``): serving in fp32 (dlrm-qr,
    full dlrm-dense), training in bf16 (train_8k, dlrm-dense at 200k rows).
    Returns the call's pieces: the arguments and their all-miss variant, the
    kernel, its plain version, the library call, and what the bound counts."""
    import torch.nn.functional as F

    g = torch.Generator(device=dev)
    g.manual_seed(5 if name == "packed_qr_bag" else 6)
    train = dtype != torch.float32
    arch = "dlrm-qr" if name == "packed_qr_bag" else "dlrm-dense"
    cfg = train_config(arch, registry) if train else registry.get_dlrm(arch)
    layout = pt.build_layout(dlrm.make_bags(cfg))
    dim = cfg.dim
    big = torch.empty((layout.total_rows + 1, dim), device=dev)
    big = big.normal_(generator=g).mul_(dim ** -0.5).to(dtype)
    s, cache = staged(cfg, layout, pt, synthetic, dev, batch, dtype, big)
    miss = torch.full_like(s["slot"], -1)
    hit = s["slot"] >= 0
    c = {"name": name, "cfg": cfg, "layout": layout, "big": big, "cache": cache, "s": s,
         "hit": hit, "dim": dim, "dtype": dtype, "tables": cfg.num_tables}
    if name == "packed_qr_bag":
        r_lut = torch.randn((layout.total_small + 1, dim), generator=g, device=dev).to(dtype)
        c.update(
            args=(big, cache, r_lut, s["q_idx"], s["slot"], s["r_idx"]),
            miss_args=(big, cache, r_lut, s["q_idx"], miss, s["r_idx"]),
            kern=lambda *a: pg.packed_qr_bag(*a, tables=cfg.num_tables),
            plain=ref.packed_qr_bag_ref, r_lut=r_lut,
            library=lambda: (F.embedding_bag(s["q_idx"], big, mode="sum")
                             + F.embedding_bag(s["r_idx"], r_lut, mode="sum")),
            library_call="embedding_bag(Q) + embedding_bag(R), all-miss stream",
            rows_read=(unique(s["q_idx"][~hit]) + unique(s["slot"][hit])
                       + unique(s["r_idx"])),
            streams=(s["q_idx"], s["slot"], s["r_idx"]),
            adds=2 * s["q_idx"].numel() * dim,
            # rows each element requests: its table (or cache) row and its R row
            element_rows=2 * s["q_idx"].numel())
    else:
        c.update(
            args=(big, cache, s["idx"], s["slot"]),
            miss_args=(big, cache, s["idx"], miss),
            kern=lambda *a: pg.packed_bag(*a, tables=cfg.num_tables),
            plain=ref.packed_bag_ref,
            library=lambda: F.embedding_bag(s["idx"], big, mode="sum"),
            library_call="embedding_bag(T), all-miss stream",
            rows_read=unique(s["idx"][~hit]) + unique(s["slot"][hit]),
            streams=(s["idx"], s["slot"]),
            adds=s["idx"].numel() * dim, element_rows=s["idx"].numel())
    return c


def hot_args(c: dict) -> tuple:
    """The case's arguments with every table index folded onto the first
    256 rows: the same requests, all served by L2 (the profile's probe of
    whether device memory binds)."""
    a = list(c["args"])
    pos = 3 if c["name"] == "packed_qr_bag" else 2
    a[pos] = torch.remainder(a[pos], 256).to(torch.int32)
    return tuple(a)


def bag_profile(c: dict, ms: float, bound_bytes: int, kern=None) -> dict:
    """Readings of a bag body at one shape, in place of a profiler's (no
    Nsight on the card's machine): the unique bytes' rate as a share of the
    HBM peak; the rate of row requests (each element's table or cache row,
    and for K1 its R row, whoever serves them: L1, L2 or memory); and the
    time with every table request folded onto 256 rows that stay in cache
    (``hot_args``).  Hot time near the real time: device memory does not
    bind, the body's own issue and load latency do."""
    kern = kern or c["kern"]
    elem = torch.finfo(c["dtype"]).bits // 8
    req_bytes = c["element_rows"] * c["dim"] * elem
    hot = hot_args(c)
    hot_ms = timed(lambda: kern(*hot), 50)
    return {"ms": ms, "dram_share": bound_bytes / (ms * 1e-3) / BW_BYTES_S,
            "request_bytes": req_bytes, "request_tb_s": req_bytes / (ms * 1e-3) / 1e12,
            "hot_ms": hot_ms, "hot_ratio": hot_ms / ms}


def fmt_profile(p: dict) -> str:
    return (f"profile: unique bytes at {100 * p['dram_share']:.1f}% of the HBM peak, row "
            f"requests {p['request_tb_s']:.2f} TB/s, all-in-cache probe {p['hot_ms']:.4f} ms "
            f"({p['hot_ratio']:.3f} of the real time)")


def kernel_phase(dev, batch, registry, dlrm, synthetic, pt, pg, ref, *,
                 dtype=torch.float32) -> list[dict]:
    """K1 ``packed_qr_bag`` and K3 ``packed_bag`` on the packed streams and
    cache block their path gives them (``bag_case``), held against their
    plain versions (``hold``), timed beside the bound and ``embedding_bag``,
    and profiled (``bag_profile``)."""
    out = []
    train = dtype != torch.float32
    elem = torch.finfo(dtype).bits // 8
    for name in ("packed_qr_bag", "packed_bag"):
        c = bag_case(dev, name, batch, dtype, registry, dlrm, synthetic, pt, pg, ref)
        kern, plain, args, s, hit = c["kern"], c["plain"], c["args"], c["s"], c["hit"]
        got = kern(*args)
        torch.cuda.synchronize()
        checked = hold(name, got, plain, args)
        if not train:
            # the library sums in its own order: held in fp32 only
            lib_err = float((kern(*c["miss_args"]) - c["library"]()).abs().max())
            if not lib_err <= ERR_TOL:
                raise AssertionError(f"{name}: all-miss kernel vs library {lib_err}")
        bound_ms, bound_by, nbytes = bound(c["streams"], c["rows_read"] * c["dim"] * elem,
                                           got.numel() * elem, c["adds"],
                                           flop_s=BF16_FLOP_S if train else FP32_FLOP_S)
        row = {
            "name": name + ("_bf16" if train else ""), "route": "cuda",
            "source": "src/repro_torch/csrc/packed_gather.cu",
            "replaces": ("src/repro/kernels/packed_gather.py:130 -> cached_gather.py:123"
                         if name == "packed_qr_bag" else
                         "src/repro/kernels/packed_gather.py:103 -> cached_gather.py:82"),
            "launches": 0, **checked,
            "ms": timed(lambda: kern(*args), 50),
            "device_ms": graph_ms(lambda: kern(*args)),
            "plain_ms": timed(lambda: plain(*args), 3, warm=1),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": timed(c["library"], 20),
            "library_call": c["library_call"],
            "all_miss_ms": timed(lambda: kern(*c["miss_args"]), 50),
            "bytes": nbytes, "hit_share": float(hit.float().mean()),
            "shape": {"G": s["slot"].shape[0], "K": s["slot"].shape[1], "dim": c["dim"],
                      "tables": c["tables"], "rows": c["big"].shape[0],
                      "slots": c["cache"].shape[0], "dtype": str(dtype).replace("torch.", "")},
        }
        row["kernel_ms"] = row["ms"]
        row["profile"] = bag_profile(c, row["ms"], nbytes)
        log(f"[kernels] {row['name']}: {fmt_err(checked)}, kernel {row['ms']:.4f} ms "
            f"(earlier {fmt_range(EARLIER_MS[row['name']])} ms; in a CUDA graph "
            f"{row['device_ms']:.4f} ms), "
            f"plain {row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}, {nbytes} B), "
            f"hit share {row['hit_share']:.3f}; {fmt_profile(row['profile'])}")
        out.append(row)
        del c, args, got, s
        torch.cuda.empty_cache()
    return out


TT_LIBRARY = ("none: no one PyTorch call computes a TT bag (a gather of three "
              "cores, two chained per-lookup products, then a pooled sum)")


def tt_bound(spec, streams, i1, i2_miss, hit_slots, i3, out_rows: int, *, elem: int = 4,
             flop_s: float = FP32_FLOP_S):
    """Bound of a TT bag: 20,480 flops per dlrm-tt lookup (two products of
    FMAs), bytes of the streams, the unique G2 / cache, G1 and G3 rows this
    run touches, and the output, ``elem`` bytes a value."""
    flops = tt_flops(i1.numel(), spec.dims)
    read = ((unique(i2_miss) + unique(hit_slots)) * spec.g2_width
            + unique(i1) * spec.g1_width + unique(i3) * spec.g3_width) * elem
    return bound(streams, read, out_rows * spec.dim * elem, flops, flop_s=flop_s)


def chunked(fn, cores, streams, dims, chunk: int = 4096):
    """The plain version over G in chunks of ``chunk`` bags: gathering every
    lookup's 8 KiB G2 row at once would take ~14 GB at full width."""
    g = streams[0].shape[0]
    return torch.cat([fn(*cores, *(s[i:i + chunk] for s in streams), dims=dims)
                      for i in range(0, g, chunk)])


def tt_rows(i2: torch.Tensor, slot, cache_rows: int) -> tuple[int, int]:
    """(distinct middle-core rows, elements) of a TT bag's streams: the
    sources the sorted-run body stages, a cache slot or a G2 row each."""
    key = i2.reshape(-1).long()
    if slot is not None:
        key = torch.where(slot.reshape(-1) >= 0, slot.reshape(-1).long(), key + cache_rows)
    return unique(key), key.numel()


def tt_design(tg, dtype, sass: dict, rows: tuple[int, int]) -> dict:
    """The TT row's design keys: the body that ran, its tensor-core
    instructions in the built library, and the batch's distinct middle-core
    rows and elements per row."""
    distinct, elements = rows
    return {"body": tg.BODY[dtype], "sass": sass["tt_bag"][SASS_KERNEL["tt", dtype]],
            "distinct_middle_rows": distinct, "elements": elements,
            "elements_per_row": elements / max(distinct, 1)}


def scratch_floor_ms(values: int) -> float:
    """The sorted-run body's own floor: its fp32 scratch written once and
    read once at the HBM rate (for the log, beside the bound)."""
    return 2 * values * 4 / BW_BYTES_S * 1e3


def fmt_range(r) -> str:
    return f"{r[0]:.4f}-{r[1]:.4f}"


def fmt_design(k: dict) -> str:
    return (f"body {k['body']}, SASS {k['sass']}, {k['distinct_middle_rows']} distinct middle "
            f"rows, {k['elements_per_row']:.1f} elements a row")


def tt_kernel_phase(dev, batch, registry, dlrm, synthetic, pt, pg, tg, ref, tt_embedding,
                    sass: dict, *, dtype=torch.float32) -> list[dict]:
    """K2 on the packed streams and cache block its path gives it
    (``staged``) and K5 on one table's cores as ``tt_embedding.lookup``
    calls it (65,536 lookups of K = 1) and pooled (2,048 x 32); each held
    against its plain version (``hold``) and timed.  In bf16 the bound
    counts bf16 bytes and the flops over the bf16 tensor-core peak (the
    least time the card could take; the kernel computes in fp32 on the CUDA
    cores)."""
    from repro_torch.configs.base import DLRM_SHAPES

    cfg = registry.get_dlrm("dlrm-tt")
    bags = dlrm.make_bags(cfg)
    spec = bags[0].emb.tt_spec
    dims = spec.dims
    layout = pt.build_layout(bags)
    train = dtype != torch.float32
    suffix = "_bf16" if train else ""
    elem, flop_s = (2, BF16_FLOP_S) if train else (4, FP32_FLOP_S)
    params = dlrm.init_dlrm(cfg, seed=5, device=dev)          # cores at init scale
    packed = pt.pack_params(params["tables"], layout, dtype=dtype)
    s, cache = staged(cfg, layout, pt, synthetic, dev, batch, dtype, packed["g2"])
    args = (packed["g1"], packed["g2"], packed["g3"], cache,
            s["i1"], s["i2"], s["i3"], s["slot"])
    kern = lambda *a: pg.packed_tt_bag(*a, dims=dims)
    plain = lambda *a: chunked(ref.packed_tt_bag_ref, a[:4], a[4:], dims)
    hit = s["slot"] >= 0
    got = kern(*args)
    torch.cuda.synchronize()
    checked = hold("packed_tt_bag" + suffix, got, plain, args)
    bound_ms, bound_by, nbytes = tt_bound(spec, args[4:], s["i1"], s["i2"][~hit],
                                          s["slot"][hit], s["i3"], got.shape[0],
                                          elem=elem, flop_s=flop_s)
    k2 = {
        "name": "packed_tt_bag" + suffix, "route": "cuda",
        "source": "src/repro_torch/csrc/tt_bag.cu",
        "replaces": "src/repro/kernels/packed_gather.py:158",
        "launches": 0, **checked,
        "ms": timed(lambda: kern(*args), 5 if train else 20),
        "plain_ms": timed(lambda: plain(*args), 1 if train else 3, warm=1),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None, "library_call": TT_LIBRARY,
        "bytes": nbytes, "hit_share": float(hit.float().mean()),
        "shape": {"G": s["slot"].shape[0], "K": s["slot"].shape[1], "dim": spec.dim,
                  "rows": packed["g2"].shape[0], "slots": cache.shape[0],
                  "dims": list(dims), "dtype": str(dtype).replace("torch.", "")},
    }
    k2["kernel_ms"] = k2["ms"]
    k2.update(tt_design(tg, dtype, sass, tt_rows(s["i2"], s["slot"], cache.shape[0])))
    floor = scratch_floor_ms(got.shape[0] * s["slot"].shape[1] * spec.dim)
    log(f"[kernels] {k2['name']}: {fmt_err(checked)}, kernel {k2['ms']:.4f} ms "
        f"(earlier {fmt_range(EARLIER_MS[k2['name']])} ms), plain {k2['plain_ms']:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}, {nbytes} B), scratch floor {floor:.4f} "
        f"ms, hit share {k2['hit_share']:.3f}; {fmt_design(k2)}")
    del got, packed, cache, args, s

    # K5 on table 0's cores: the lookup path (K = 1) and one pooled batch
    one = tuple(params["tables"][0][n].to(dtype) for n in ("g1", "g2", "g3"))
    lookup_batch = DLRM_SHAPES[0].global_batch              # tt_embedding.lookup's (2,048, 32)
    idx = synthetic.zipf_batch(cfg.vocab_per_table, (lookup_batch, cfg.pooling), seed=12,
                               step=0, device=dev)
    pooled = tt_embedding.tt_decompose(idx, spec)
    lookups = tuple(x.reshape(-1, 1) for x in pooled)
    kern5 = lambda *a: tg.tt_bag(*a, dims=dims)
    plain5 = lambda *a: ref.tt_bag_ref(*a, dims=dims)
    rows = {}
    for shape, st in (("lookup", lookups), ("pooled", pooled)):
        out = kern5(*one, *st)
        torch.cuda.synchronize()
        c = hold(f"tt_bag{suffix} ({shape})", out, plain5, (*one, *st))
        b_ms, b_by, nb = tt_bound(spec, st, st[0], st[1], st[1][:0], st[2], out.shape[0],
                                  elem=elem, flop_s=flop_s)
        rows[shape] = dict(checked=c, bound_ms=b_ms, bound_by=b_by, bytes=nb,
                           ms=timed(lambda: kern5(*one, *st), 20),
                           plain_ms=timed(lambda: plain5(*one, *st), 3, warm=1),
                           rows=tt_rows(st[1], None, 0))
    lk, pl = rows["lookup"], rows["pooled"]
    worst = max((lk["checked"], pl["checked"]),
                key=lambda c: c.get("rounding_ratio", c["max_abs_err"]))
    k5 = {
        "name": "tt_bag" + suffix, "route": "cuda",
        "source": "src/repro_torch/csrc/tt_bag.cu",
        "replaces": "src/repro/kernels/tt_gather.py:64",
        "launches": 0, **worst,
        "max_abs_err": max(lk["checked"]["max_abs_err"], pl["checked"]["max_abs_err"]),
        "ms": lk["ms"], "plain_ms": lk["plain_ms"],
        "bound_ms": lk["bound_ms"], "bound_by": lk["bound_by"],
        "library_ms": None, "library_call": TT_LIBRARY,
        "bytes": lk["bytes"],
        "pooled_ms": pl["ms"], "pooled_plain_ms": pl["plain_ms"],
        "pooled_bound_ms": pl["bound_ms"], "pooled_bound_by": pl["bound_by"],
        "shape": {"lookup": [lookups[0].shape[0], 1], "pooled": list(pooled[0].shape),
                  "dim": spec.dim, "rows": one[1].shape[0], "dims": list(dims),
                  "dtype": str(dtype).replace("torch.", "")},
    }
    k5["kernel_ms"] = k5["ms"]
    k5.update(tt_design(tg, dtype, sass, lk["rows"]))
    k5["pooled_distinct_middle_rows"] = pl["rows"][0]
    k5["pooled_elements_per_row"] = pl["rows"][1] / max(pl["rows"][0], 1)
    log(f"[kernels] {k5['name']}: {fmt_err(k5)}; lookup ({lookups[0].shape[0]} x 1) "
        f"kernel {lk['ms']:.4f} ms (earlier {fmt_range(EARLIER_MS[k5['name']])} ms), plain "
        f"{lk['plain_ms']:.4f} ms, bound {lk['bound_ms']:.4f} ms ({lk['bound_by']}); pooled "
        f"({lookup_batch} x {cfg.pooling}) kernel {pl['ms']:.4f} ms, plain "
        f"{pl['plain_ms']:.4f} ms, bound {pl['bound_ms']:.4f} ms ({pl['bound_by']}), "
        f"{pl['rows'][0]} distinct middle rows; lookup {fmt_design(k5)}")
    del params, one
    torch.cuda.empty_cache()
    return [k2, k5]


# (name, dims): the train-DLRM example's tables at rank 64 (dim 64) and
# dlrm-tt's at rank 64 (dim 128), where a middle-core row (64 / 128 KiB of
# fp32) does not fit a block twice: K2 and K5 stage it in d2 slices
RANK64 = (("train-dlrm example, rank 64", (4, 4, 4, 64)), ("dlrm-tt, rank 64", (4, 8, 4, 64)))
RANK64_BATCH = 256


def tt_rank64_phase(dev, registry, dlrm, synthetic, pt, pg, tg, ref, tt_embedding,
                    train_dlrm) -> list[dict]:
    """K2 (packed, the path's slots: a staged cache in fp32, all miss in
    bf16) and K5 (one table's lookups, K = 1) at rank 64, dims 64 and 128,
    fp32 and bf16, at batch ``RANK64_BATCH``: each output held against the
    plain version (``hold``) and read for bitwise equality with it (at dim
    64 the plain version's second product does not sum its depth in order
    on the card), timed beside it and the bound."""
    rows = []
    for name, dims in RANK64:
        base = (train_dlrm.config("tt", dims[3]) if dims[:3] == (4, 4, 4) else
                registry.get_dlrm("dlrm-tt").replace(tt_rank=dims[3]))
        bags = dlrm.make_bags(base)
        spec = bags[0].emb.tt_spec
        assert spec.dims == dims, (spec.dims, dims)
        layout = pt.build_layout(bags)
        tables = dlrm.init_dlrm(base, seed=5, device=dev)["tables"]
        for dtype in (torch.float32, torch.bfloat16):
            packed = pt.pack_params(tables, layout, dtype=dtype)
            s, cache = staged(base, layout, pt, synthetic, dev, RANK64_BATCH, dtype,
                              packed["g2"])
            args = (packed["g1"], packed["g2"], packed["g3"], cache,
                    s["i1"], s["i2"], s["i3"], s["slot"])
            one = tuple(tables[0][n].to(dtype) for n in ("g1", "g2", "g3"))
            idx = synthetic.zipf_batch(base.vocab_per_table, (RANK64_BATCH, base.pooling),
                                       seed=12, step=0, device=dev)
            look = tuple(x.reshape(-1, 1) for x in tt_embedding.tt_decompose(idx, spec))
            elem, flop_s = (4, FP32_FLOP_S) if dtype == torch.float32 else (2, BF16_FLOP_S)
            for kernel, kern, plain, a, st in (
                    ("packed_tt_bag", lambda *a: pg.packed_tt_bag(*a, dims=dims),
                     lambda *a: chunked(ref.packed_tt_bag_ref, a[:4], a[4:], dims, 256),
                     args, args[4:]),
                    ("tt_bag", lambda *a: tg.tt_bag(*a, dims=dims),
                     lambda *a: chunked(ref.tt_bag_ref, a[:3], a[3:], dims, 4096),
                     (*one, *look), look)):
                got = kern(*a)
                torch.cuda.synchronize()
                checked = hold(f"{kernel} {name}", got, plain, a)
                bitwise = bool(torch.equal(got, plain(*a)))
                if kernel == "packed_tt_bag":
                    hit = st[3] >= 0
                    g2_rows, slots = st[1][~hit], st[3][hit]
                else:
                    g2_rows, slots = st[1], st[1][:0]
                b_ms, b_by, nbytes = tt_bound(spec, st, st[0], g2_rows, slots, st[2],
                                              got.shape[0], elem=elem, flop_s=flop_s)
                r = {"kernel": kernel, "case": name, "dims": list(dims),
                     "dtype": str(dtype).replace("torch.", ""),
                     "stage_width": tg.staging(dims, dtype), "G": st[0].shape[0],
                     "K": st[0].shape[1], **checked, "bitwise": bitwise,
                     "ms": timed(lambda: kern(*a), 5),
                     "plain_ms": timed(lambda: plain(*a), 1, warm=0),
                     "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes}
                log(f"[kernels] {kernel} {name} {r['dtype']} (G {r['G']}, K {r['K']}, d2 "
                    f"stage {r['stage_width']} of {dims[1]}): {fmt_err(checked)}, bitwise the "
                    f"plain version: {bitwise}, kernel "
                    f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound {b_ms:.4f} ms "
                    f"({b_by})")
                rows.append(r)
            del packed, cache, args, s, one, got
            torch.cuda.empty_cache()
        del tables
        torch.cuda.empty_cache()
    return rows


def rank64_example_run(mods, train_dlrm) -> int:
    """``python -m repro_torch.examples.train_dlrm --embedding tt --tt-rank
    64`` on the card, cut to 25 steps: K2 bf16 launches once a step and once
    for the held-out evaluation, and the losses are finite."""
    reset_all(mods)
    t0 = time.perf_counter()
    res = train_dlrm.main(["--embedding", "tt", "--tt-rank", "64", "--steps", "25"])
    torch.cuda.synchronize()
    counts = launches_now(mods)
    if counts["packed_tt_bag"] != 26 or sum(counts.values()) != 26 or not all(
            np.isfinite(v) for v in res.values()):
        raise AssertionError(f"train_dlrm --tt-rank 64: launches {counts}, result {res}")
    log(f"[train] examples.train_dlrm --embedding tt --tt-rank 64 --steps 25: loss "
        f"{res['train_loss']:.4f}, held-out loss {res['loss']:.4f}, AUC {res['auc']:.4f}, "
        f"packed_tt_bag launched {counts['packed_tt_bag']} times, "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    return counts["packed_tt_bag"]


def pertable_kernel_phase(dev, batch, registry, dlrm, synthetic, hashing, qr_embedding, ref,
                          cg, gb, qg) -> list[dict]:
    """K4b, K6, K8 on dlrm-qr table 0's shapes and K4a, K7 on dlrm-dense
    table 0's, each held against its plain version and timed beside its
    bound and the one PyTorch call that computes the same function."""
    import torch.nn.functional as F

    g = torch.Generator(device=dev)
    g.manual_seed(7)
    rows_out = []

    def row(name, kern, plain, args, *, replaces, streams, rows_read, out_numel, adds,
            library, library_call, check_library, bf16=None, **extra):
        got = kern(*args)
        torch.cuda.synchronize()
        err = float((got - plain(*args)).abs().max())
        lib_err = float((check_library() - library()).abs().max())
        if not err <= ERR_TOL or not lib_err <= ERR_TOL:
            raise AssertionError(f"{name}: kernel vs plain max abs error {err}, "
                                 f"kernel vs library {lib_err}")
        b_ms, b_by, nbytes = bound(streams, rows_read * extra["shape"]["dim"] * 4,
                                   out_numel * 4, adds)
        r = {"name": name, "route": "cuda", "source": (
                 "src/repro_torch/csrc/qr_gather.cu" if name == "qr_gather"
                 else "src/repro_torch/csrc/packed_gather.cu"),
             "replaces": replaces, "launches": 0, "max_abs_err": err,
             "ms": timed(lambda: kern(*args), 50),
             "device_ms": graph_ms(lambda: kern(*args)),
             "plain_ms": timed(lambda: plain(*args), 3, warm=1),
             "bound_ms": b_ms, "bound_by": b_by,
             "library_ms": timed(library, 20), "library_call": library_call,
             "bytes": nbytes, **extra}
        if bf16 is not None:
            hargs = [a.to(torch.bfloat16) if a.is_floating_point() else a for a in args]
            hgot = kern(*hargs)
            torch.cuda.synchronize()
            hc = hold(f"{name} bf16", hgot, plain, hargs)
            r["bf16_max_abs_err"] = hc["max_abs_err"]
            r["bf16_rounding_ratio"] = hc["rounding_ratio"]
            r["bf16_tolerance"] = hc["tolerance"]
            r["bf16_ms"] = timed(lambda: kern(*hargs), 50)
            r["bf16_device_ms"] = graph_ms(lambda: kern(*hargs))
        r["kernel_ms"] = r["ms"]
        log(f"[kernels] {name}: err {err:.3e}, kernel {r['ms']:.4f} ms"
            + (f" (earlier {fmt_range(EARLIER_MS[name])} ms)" if name in EARLIER_MS else "")
            + f", in a CUDA graph {r['device_ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}, {nbytes} B)"
            + (f", bf16 {r['bf16_ms']:.4f} ms (graph {r['bf16_device_ms']:.4f}) err "
               f"{r['bf16_max_abs_err']:.3e} "
               f"({r['bf16_rounding_ratio']:.3f} of one bf16 rounding)"
               if bf16 is not None else ""))
        rows_out.append(r)

    # dlrm-qr table 0: K4b, K6, K8
    cfg = registry.get_dlrm("dlrm-qr")
    emb = dlrm.make_bags(cfg)[0].emb
    scale = emb.dim ** -0.5
    q_rows = qr_embedding._pad_rows(emb.qr_spec.q_rows)         # 31,360
    q = torch.randn((q_rows, emb.dim), generator=g, device=dev).mul_(scale)
    r_lut = torch.randn((emb.collision, emb.dim), generator=g, device=dev).mul_(scale)
    idx = synthetic.zipf_batch(cfg.vocab_per_table, (batch, cfg.pooling), seed=11,
                               device=dev)
    q_idx, r_idx = hashing.qr_decompose(idx, emb.collision)
    slots = min(cfg.cache_slots, cfg.cache_vmem_mb * 2**20 // (emb.dim * 4))
    slot, top = top_slots(q_idx, q.shape[0], slots)
    cache = q[top]
    hit = slot >= 0
    miss = torch.full_like(slot, -1)
    two_bags = lambda: (F.embedding_bag(q_idx, q, mode="sum")
                        + F.embedding_bag(r_idx, r_lut, mode="sum"))
    shape = {"B": batch, "K": cfg.pooling, "dim": emb.dim, "q_rows": q.shape[0],
             "r_rows": r_lut.shape[0]}
    row("cached_qr_bag", cg.cached_qr_bag, ref.cached_qr_bag_ref,
        (q, cache, r_lut, q_idx, slot, r_idx),
        replaces="src/repro/kernels/cached_gather.py:123",
        streams=(q_idx, slot, r_idx),
        rows_read=unique(q_idx[~hit]) + unique(slot[hit]) + unique(r_idx),
        out_numel=batch * emb.dim, adds=2 * q_idx.numel() * emb.dim,
        library=two_bags, library_call="embedding_bag(Q) + embedding_bag(R), all-miss stream",
        check_library=lambda: cg.cached_qr_bag(q, cache, r_lut, q_idx, miss, r_idx),
        hit_share=float(hit.float().mean()), shape={**shape, "slots": slots})
    row("gnr_bag", gb.gnr_bag, ref.gnr_bag_ref, (q, r_lut, q_idx, r_idx),
        replaces="src/repro/kernels/gnr_bag.py:63", streams=(q_idx, r_idx),
        rows_read=unique(q_idx) + unique(r_idx), out_numel=batch * emb.dim,
        adds=2 * q_idx.numel() * emb.dim, library=two_bags,
        library_call="embedding_bag(Q) + embedding_bag(R)",
        check_library=lambda: gb.gnr_bag(q, r_lut, q_idx, r_idx), bf16=True, shape=shape)
    qf, rf = q_idx.reshape(-1), r_idx.reshape(-1)
    row("qr_gather", qg.qr_gather, ref.qr_lookup_ref, (q, r_lut, qf, rf),
        replaces="src/repro/kernels/qr_gather.py:42", streams=(qf, rf),
        rows_read=unique(qf) + unique(rf), out_numel=qf.numel() * emb.dim,
        adds=qf.numel() * emb.dim,
        library=lambda: F.embedding(qf, q) + F.embedding(rf, r_lut),
        library_call="embedding(Q) + embedding(R)",
        check_library=lambda: qg.qr_gather(q, r_lut, qf, rf), bf16=True,
        shape={**shape, "N": qf.numel()})
    del q, r_lut, cache

    # dlrm-dense table 0: K4a, K7
    cfg = registry.get_dlrm("dlrm-dense")
    table = torch.randn((cfg.vocab_per_table, cfg.dim), generator=g, device=dev)
    table.mul_(cfg.dim ** -0.5)
    idx = synthetic.zipf_batch(cfg.vocab_per_table, (batch, cfg.pooling), seed=12,
                               device=dev)
    slot, top = top_slots(idx, table.shape[0], slots)
    cache = table[top]
    hit = slot >= 0
    miss = torch.full_like(slot, -1)
    one_bag = lambda: F.embedding_bag(idx, table, mode="sum")
    shape = {"B": batch, "K": cfg.pooling, "dim": cfg.dim, "rows": table.shape[0]}
    row("cached_bag", cg.cached_bag, ref.cached_bag_ref, (table, cache, idx, slot),
        replaces="src/repro/kernels/cached_gather.py:82", streams=(idx, slot),
        rows_read=unique(idx[~hit]) + unique(slot[hit]), out_numel=batch * cfg.dim,
        adds=idx.numel() * cfg.dim, library=one_bag,
        library_call="embedding_bag(T), all-miss stream",
        check_library=lambda: cg.cached_bag(table, cache, idx, miss),
        hit_share=float(hit.float().mean()), shape={**shape, "slots": slots})
    row("gnr_bag_dense", gb.gnr_bag_dense, ref.dense_bag_ref, (table, idx),
        replaces="src/repro/kernels/gnr_bag.py:100", streams=(idx,),
        rows_read=unique(idx), out_numel=batch * cfg.dim, adds=idx.numel() * cfg.dim,
        library=one_bag, library_call="embedding_bag(T)",
        check_library=lambda: gb.gnr_bag_dense(table, idx), shape=shape)
    del table, cache
    torch.cuda.empty_cache()
    # the host's cost of one launch through a wrapper: back to back, a
    # one-table bag's time is set by it; in a CUDA graph it is gone
    over = {r["name"]: r["ms"] - r["device_ms"] for r in rows_out if r["name"] != "qr_gather"}
    log("[kernels] launch overhead (back to back - CUDA graph), one-table bags at "
        f"({batch}, {cfg.pooling}): "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in over.items())
        + f"; median {float(np.median(list(over.values()))):.4f} ms "
        f"(launch/mesh.py DISPATCH_OVERHEAD_S = {DISPATCH_OVERHEAD_S * 1e3:.4f} ms)")
    return rows_out


# ---------------------------------------------------------------------------
# phase 4: the main path at full width
# ---------------------------------------------------------------------------

KERNEL_OF = {"qr": "packed_qr_bag", "dense": "packed_bag", "tt": "packed_tt_bag"}


def reset_counts(pg, tg) -> None:
    pg.reset_launches()
    tg.reset_launches()


def serve_phase(dev, arch, batch, batches, tel_batches, serve_rec, registry, dlrm, synthetic,
                pg, tg, tt_embedding, obs, attribution) -> tuple[dict, dict]:
    """Serve ``arch`` at full width in both modes with telemetry off, then
    once fenced and sequential with it on (``telemetry_run``); returns the
    launches of each kernel over the three runs (and, for TT, of K5 in one
    lookup) and the fenced run's split of a batch."""
    cfg = registry.get_dlrm(arch)
    kernel = KERNEL_OF[cfg.embedding_kind]
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    params = dlrm.init_dlrm(cfg, seed=0, device=dev)
    state = serve_rec.build_serve_state(cfg, shards=4, alpha=1.05, seed=0, device=dev)
    launches = {kernel: 0}
    if cfg.embedding_kind == "tt":
        launches["tt_bag"] = tt_lookup_check(dev, cfg, batch, state, params, synthetic,
                                             tt_embedding, tg, pg)
    packed = state.engine.pack(params.pop("tables"))   # frees the per-table copies
    torch.cuda.empty_cache()
    log(f"[{arch}] offline plan + init + pack {time.perf_counter() - t0:.1f} s, "
        f"packed rows {state.layout.total_rows}, slots {sum(state.slot_budgets)}")
    res = {}
    for mode in ("sequential", "overlap"):
        reset_counts(pg, tg)
        r = serve_rec.run_pipeline(cfg, batch=batch, batches=batches, mode=mode,
                                   state=state, params=params, packed=packed, device=dev)
        n = pg.LAUNCHES[kernel]
        if n != batches:
            raise AssertionError(f"{arch} {mode}: {kernel} launched {n} times "
                                 f"for {batches} batches")
        launches[kernel] += n
        res[mode] = r
        log(f"[{arch}] {mode}: {r['qps']:.1f} QPS, batch latency p50 "
            f"{r['lat_p50_s'] * 1e3:.2f} ms p99 {r['lat_p99_s'] * 1e3:.2f} ms, "
            f"warm-up {r['compile_s']:.2f} s, hit rate {r['hit_rate']:.4f}, "
            f"{kernel} launches {n}, peak memory "
            f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    for a, b in zip(res["sequential"]["logits"], res["overlap"]["logits"]):
        if not (np.isfinite(a).all() and np.isfinite(b).all()):
            raise AssertionError(f"{arch}: non-finite logits")
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    log(f"[{arch}] overlap == sequential to 1e-6 over {batches} batches of {batch}; "
        f"phase {time.perf_counter() - t0:.1f} s")
    split = telemetry_run(dev, arch, cfg, batch, tel_batches, state, params, packed, serve_rec,
                          obs, attribution, pg, tg, kernel, res)
    launches[kernel] += tel_batches
    # telemetry off and wiped: the profiled run below must record nothing
    obs.registry().reset()
    obs.tracer().reset()
    device_share(arch, lambda: serve_rec.run_pipeline(
        cfg, batch=batch, batches=3, mode="sequential", state=state, params=params,
        packed=packed, device=dev))
    snap = obs.snapshot()
    if snap.counters or snap.histograms or obs.tracer().events:
        raise AssertionError(f"{arch}: telemetry recorded while disabled: "
                             f"{sorted(snap.counters)} {len(obs.tracer().events)} events")
    del packed, params, state
    torch.cuda.empty_cache()
    log(f"[{arch}] phase {time.perf_counter() - t0:.1f} s")
    return launches, split


# every span of a steady-state batch in a fenced sequential run
BATCH_SPANS = {"prefetch", "pack", "h2d", "dispatch", "device_compute", "interact",
               "device_head", "block", "batch"}


def telemetry_run(dev, arch, cfg, batch, batches, state, params, packed, serve_rec, obs,
                  attribution, pg, tg, kernel, unfenced: dict) -> dict:
    """One fenced sequential run with telemetry on, on the state and packed
    buffers of the unfenced runs: every span of each steady-state batch is
    there, ``engine/dispatch/serve_gather`` counts the batches, the kernel
    launches once a batch (the fence adds no launch), the traffic report's
    hit rate is the run's.  Logs the attribution table; returns the split
    of a batch (stage -> ms) beside the unfenced runs' p50."""
    obs.enable()
    try:
        reset_counts(pg, tg)
        r = serve_rec.run_pipeline(cfg, batch=batch, batches=batches, mode="sequential",
                                   state=state, params=params, packed=packed, device=dev,
                                   fence=True)
        n = pg.LAUNCHES[kernel]
        events = list(obs.tracer().events)
        counters = obs.snapshot().counters
    finally:
        obs.disable()
    if n != batches:
        raise AssertionError(f"{arch} fenced: {kernel} launched {n} times for {batches} "
                             f"batches")
    spans: dict = {}
    for ev in events:
        b = ev.get("args", {}).get("batch")
        if ev.get("ph") == "X" and b is not None:
            spans.setdefault(b, set()).add(ev["name"])
    for t in range(1, batches):
        if BATCH_SPANS - spans.get(t, set()):
            raise AssertionError(f"{arch} fenced: batch {t} lacks spans "
                                 f"{sorted(BATCH_SPANS - spans.get(t, set()))}")
    if counters.get("engine/dispatch/serve_gather") != batches:
        raise AssertionError(f"{arch} fenced: serve_gather dispatches "
                             f"{counters.get('engine/dispatch/serve_gather')} != {batches}")
    if r["traffic_report"].hit_rate != r["hit_rate"]:
        raise AssertionError(f"{arch} fenced: traffic hit rate "
                             f"{r['traffic_report'].hit_rate} != {r['hit_rate']}")
    att = attribution.attribute(events, r["traffic_report"], state.eplan, batch=batch,
                                fenced=True)
    log(f"[{arch}] attribution of a fenced sequential run ({batches} batches of {batch}, "
        f"telemetry on): bottleneck {att.bottleneck}, stages {att.total_s * 1e3:.2f} "
        f"ms/batch, p50 {r['lat_p50_s'] * 1e3:.2f} ms (unfenced sequential p50 "
        f"{unfenced['sequential']['lat_p50_s'] * 1e3:.2f} ms); {kernel} launches {n}")
    for line in att.format_table().splitlines():
        log(f"[{arch}] {line}")
    return {
        "config": arch, "batch": batch, "batches": batches, "mode": "sequential",
        "fenced": True, "bottleneck": att.bottleneck,
        "stages_ms": {row.stage: row.measured_s * 1e3 for row in att.rows
                      if row.measured_s is not None},
        "fenced_total_ms": att.total_s * 1e3,
        "fenced_p50_ms": r["lat_p50_s"] * 1e3,
        "unfenced_p50_ms": {m: unfenced[m]["lat_p50_s"] * 1e3
                            for m in ("sequential", "overlap")},
    }


def cli_serve_run(serve_rec, obs) -> int:
    """``serve_rec.main`` on dlrm-qr-smoke on the card with all five
    telemetry flags, both modes; every artifact it writes parses.  Returns
    the launches of K1."""
    from repro_torch.kernels import packed_gather as pg

    out = ROOT / "build" / "serve_cli"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    pg.reset_launches()
    try:
        rc = serve_rec.main([
            "--arch", "dlrm-qr", "--smoke", "--mode", "both",
            "--metrics-json", str(out / "metrics.json"), "--trace-out", str(out / "trace.json"),
            "--slo", "p99_ms=50,objective=0.99", "--report", str(out / "report.md"),
            "--flight-dir", str(out / "flight")])
    finally:
        obs.disable()
        obs.install_observatory()
    if rc != 0:
        raise AssertionError(f"serve_rec.main returned {rc}")
    metrics = json.loads((out / "metrics.json").read_text())
    trace = json.loads((out / "trace.json").read_text())
    report = json.loads((out / "report.json").read_text())
    dumps = [json.loads(f.read_text()) for f in sorted((out / "flight").glob("*.json"))]
    if not ((out / "report.md").read_text().startswith("# Serving report")
            and metrics["counters"]["engine/dispatch/serve_gather"] == 12
            and any(e.get("name") == "device_compute" for e in trace["traceEvents"])
            and report["schema"] == "serving-report/v1" and report["attribution"]["fenced"]
            and len(dumps) == len(report["flight_dumps"])):
        raise AssertionError("serve_rec.main: an artifact is missing or malformed")
    n = pg.LAUNCHES["packed_qr_bag"]
    log(f"[serve-cli] dlrm-qr-smoke on the card, both modes, fenced: metrics, trace "
        f"({len(trace['traceEvents'])} events), report (bottleneck "
        f"{report['attribution']['bottleneck']}), SLO "
        f"{'breached' if report['slo']['breached'] else 'met'}, {len(dumps)} flight "
        f"dumps; packed_qr_bag launches {n}")
    obs.registry().reset()
    obs.tracer().reset()
    return n


def device_rows(prof) -> list:
    """(name, device ms) of a profile's device operations (kernels,
    copies): a CPU op's device time counts the same kernels again."""
    from torch.autograd import DeviceType

    return [(e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]


def device_share(arch: str, run) -> None:
    """Trace one short sequential run with ``torch.profiler``: the share of
    its wall time the card spent in kernels and copies, and the device
    operations that took most of it."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = device_rows(prof)
    if not rows:
        log(f"[{arch}] profiler saw no device time: device share not measured")
        return
    busy_ms = sum(t for _k, t in rows)
    top = ", ".join(f"{k[:64]} {t:.2f} ms" for k, t in sorted(rows, key=lambda r: -r[1])[:5])
    log(f"[{arch}] profiler, 3 sequential batches: wall {wall_ms:.1f} ms, device "
        f"busy {busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f}%); top: {top}")


def tt_lookup_check(dev, cfg, batch, state, params, synthetic, tt_embedding, tg,
                    pg) -> int:
    """One ``tt_embedding.lookup`` of a batch's logical rows of one sparse
    feature (batch x pooling) on a full-width dlrm-tt table: K5 launches
    exactly once, and the rows agree with the plain contraction."""
    emb = state.bags[0].emb
    idx = synthetic.zipf_batch(cfg.vocab_per_table, (batch, cfg.pooling), seed=13,
                               step=0, device=dev)
    reset_counts(pg, tg)
    got = tt_embedding.lookup(params["tables"][0], idx, emb)
    torch.cuda.synchronize()
    n = tg.LAUNCHES["tt_bag"]
    if n != 1 or sum(pg.LAUNCHES.values()):
        raise AssertionError(f"tt_embedding.lookup launched tt_bag {n} times")
    plain = tt_embedding.lookup(params["tables"][0], idx, dataclasses.replace(
        emb, compute_dtype=torch.float32, tt_exec="jnp"))
    err = float((got.float() - plain.to(emb.compute_dtype).float()).abs().max())
    if got.shape != (*idx.shape, cfg.dim) or got.dtype != emb.compute_dtype or err > 1e-2:
        raise AssertionError(f"tt_embedding.lookup: {got.shape} {got.dtype}, "
                             f"max |kernel - plain| {err}")
    log(f"[{cfg.name}] tt_embedding.lookup {tuple(idx.shape)} -> {tuple(got.shape)} "
        f"{got.dtype}: tt_bag launched {n} time, max |kernel - plain| {err:.3e}")
    return n


# ---------------------------------------------------------------------------
# phase 5: the per-table paths at full width
# ---------------------------------------------------------------------------

PERTABLE_KERNEL = {"qr": "cached_qr_bag", "dense": "cached_bag", "tt": "tt_bag"}


def launches_now(mods) -> dict:
    return {name: n for m in mods for name, n in m.LAUNCHES.items()}


def reset_all(mods) -> None:
    for m in mods:
        m.reset_launches()


def cached_lookup_run(dev, arch, batch, batches, registry, dlrm, synthetic, qr_embedding,
                      embedding_bag, engine, mods) -> int:
    """``cached_lookup`` on table 0 of ``arch`` at full width for ``batches``
    batches, the scheduler prefetching the next batch between calls;
    returns the launches of the table's kernel."""
    cfg = registry.get_dlrm(arch)
    bag = dlrm.make_bags(cfg)[0]
    bag = dataclasses.replace(bag, emb=dataclasses.replace(bag.emb,
                                                           compute_dtype=torch.float32))
    emb = bag.emb
    params = qr_embedding.init(emb, generator=torch.Generator(dev).manual_seed(3), device=dev)
    eng = engine.engine_for(engine.EngineSpec.from_bags([bag], cache_slots=cfg.cache_slots))
    sched = eng.fresh_schedulers()[0]
    idx = [synthetic.zipf_batch(cfg.vocab_per_table, (batch, cfg.pooling), seed=20, step=t,
                                device=dev) for t in range(batches)]
    rows = [engine.big_rows(i.cpu().numpy(), emb) for i in idx]
    up = lambda a: torch.from_numpy(a).to(dev)
    sched.prefetch(rows[0])                                 # cold-start staging
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reset_all(mods)
    outs = []
    for t in range(batches):
        slot = up(sched.slots_for(rows[t]))
        outs.append(eng.cached_lookup(params, idx[t], 0, cache_rows=up(sched.cache_rows()),
                                      slot=slot if slot.shape == idx[t].shape else None))
        if t + 1 < batches:
            sched.prefetch(rows[t + 1])                    # the prefetch hook
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches_now(mods)
    kernel = PERTABLE_KERNEL[emb.kind]
    if counts[kernel] != batches or sum(counts.values()) != batches:
        raise AssertionError(f"{arch} cached_lookup: launches {counts} for {batches} batches")
    plain = dataclasses.replace(bag, emb=dataclasses.replace(emb, tt_exec="jnp"))
    err = max(float((o - embedding_bag.bag_lookup(params, i, plain)).abs().max())
              for o, i in zip(outs, idx))
    if not err <= ERR_TOL or not all(torch.isfinite(o).all() for o in outs):
        raise AssertionError(f"{arch} cached_lookup vs bag_lookup: max abs error {err}")
    log(f"[per-table] {arch} table 0 cached_lookup: {batches} batches of "
        f"{tuple(idx[0].shape)}, {kernel} launched {counts[kernel]} times, "
        f"hit rate {sched.stats.hit_rate:.4f}, max |cached - bag_lookup| {err:.3e}, "
        f"{wall / batches * 1e3:.2f} ms per batch (host scheduler included)")
    return counts[kernel]


def ops_entry_runs(dev, batch, registry, dlrm, synthetic, hashing, qr_embedding, ops,
                   mods) -> dict:
    """``ops.qr_lookup`` (K8) on dlrm-qr table 0 and ``ops.gnr_pooled_dense``
    (K7) on dlrm-dense table 0, once each, against the plain lookups."""
    out = {}
    for arch, kernel in (("dlrm-qr", "qr_gather"), ("dlrm-dense", "gnr_bag_dense")):
        cfg = registry.get_dlrm(arch)
        emb = dataclasses.replace(dlrm.make_bags(cfg)[0].emb, compute_dtype=torch.float32)
        params = qr_embedding.init(emb, generator=torch.Generator(dev).manual_seed(4),
                                   device=dev)
        idx = synthetic.zipf_batch(cfg.vocab_per_table, (batch, cfg.pooling), seed=21,
                                   device=dev)
        reset_all(mods)
        if kernel == "qr_gather":
            q_idx, r_idx = hashing.qr_decompose(idx, emb.collision)
            got = ops.qr_lookup(params["q"], params["r"], q_idx, r_idx)
            counts = launches_now(mods)
            expect = qr_embedding.lookup(params, idx, emb)
        else:
            got = ops.gnr_pooled_dense(params["table"], idx)
            counts = launches_now(mods)
            expect = qr_embedding.lookup(params, idx, emb).sum(dim=-2)
        err = float((got - expect).abs().max())
        if counts[kernel] != 1 or sum(counts.values()) != 1 or not err <= ERR_TOL:
            raise AssertionError(f"ops entry for {kernel}: launches {counts}, error {err}")
        log(f"[per-table] {arch} ops entry {tuple(idx.shape)} -> {tuple(got.shape)}: "
            f"{kernel} launched once, max |kernel - plain lookup| {err:.3e}")
        out[kernel] = counts[kernel]
        del params
    torch.cuda.empty_cache()
    return out


def hashed_lookup_run(dev, batch, registry, dlrm, synthetic, embedding_bag, engine,
                      mods) -> None:
    """``engine.lookup`` on 26 hashed tables of the dlrm-qr shape: the
    per-table branch (plain gathers, no kernel), card against CPU."""
    cfg = registry.get_dlrm("dlrm-qr").replace(embedding_kind="hashed")
    bags = dlrm.make_bags(cfg)
    tables = embedding_bag.init_tables(bags, generator=torch.Generator(dev).manual_seed(5),
                                       device=dev)
    idx = synthetic.zipf_batch(cfg.vocab_per_table, (batch, cfg.num_tables, cfg.pooling),
                               seed=22, device=dev)
    eng = engine.engine_for(engine.EngineSpec.from_bags(bags))
    reset_all(mods)
    t0 = time.perf_counter()
    got = eng.lookup(tables, idx)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if sum(launches_now(mods).values()) or eng.plan.packed:
        raise AssertionError("hashed lookup: expected the per-table branch, no kernel")
    cpu = eng.lookup([{k: v.cpu() for k, v in t.items()} for t in tables], idx.cpu())
    err = float((got.cpu().float() - cpu.float()).abs().max())
    if got.shape != (batch, cfg.num_tables, cfg.dim) or not torch.isfinite(got).all() \
            or err > 2 * BF16_TOL:
        raise AssertionError(f"hashed lookup: {tuple(got.shape)}, card vs CPU {err}")
    log(f"[per-table] hashed engine.lookup, {cfg.num_tables} tables of "
        f"{tables[0]['table'].shape[0]} x {cfg.dim}, {tuple(idx.shape)} -> "
        f"{tuple(got.shape)} {got.dtype}: card vs CPU max abs diff {err:.3e}, "
        f"{wall * 1e3:.1f} ms on the card")
    del tables
    torch.cuda.empty_cache()


def examples_run(mods, quickstart, cache_plan) -> dict:
    """Both per-table examples on the card: the quickstart launches K6 and
    K1 once each, then its QR LM's 10 training steps K8 once a step and K9
    twice a layer a step (the forward and the backward's recompute); the
    cache walkthrough K4b once per batch."""
    reset_all(mods)
    res = quickstart.main(["--device", "cuda"])
    counts = launches_now(mods)
    steps = len(res["lm_losses"])
    # qwen2-1.5b-smoke: 2 layers, K9 twice each a step
    want = {"gnr_bag": 1, "packed_qr_bag": 1, "qr_gather": steps, "flash_fwd": 2 * 2 * steps}
    if {k: v for k, v in counts.items() if v} != want:
        raise AssertionError(f"quickstart launches {counts}, not {want}")
    reset_all(mods)
    res = cache_plan.main(["--device", "cuda"])
    n = launches_now(mods)
    if n["cached_qr_bag"] != res["batches"] or sum(n.values()) != res["batches"]:
        raise AssertionError(f"cache_plan launches {n} for {res['batches']} batches")
    log(f"[per-table] examples: quickstart launched {counts}; cache_plan launched "
        f"cached_qr_bag {n['cached_qr_bag']} times, hit rate {res['hit_rate']:.3f}")
    return {"gnr_bag": counts["gnr_bag"], "packed_qr_bag": counts["packed_qr_bag"],
            "qr_gather": counts["qr_gather"], "cached_qr_bag": n["cached_qr_bag"]}


# ---------------------------------------------------------------------------
# phase 6: attention, K9
# ---------------------------------------------------------------------------

# (name, batch, query heads, kv heads, Sq, Skv, D): qwen2-1.5b's attention
# (configs/qwen2_1_5b.py) at the train_4k sequence, batch cut from 256 to 4;
# granite-34b's multi-query attention (48 heads on one kv head, the widest
# group in the repo), batch 1; a query block of 1,024 over a 4,096 cache;
# and granite-moe-3b-a800m's (24 query heads over 8 kv heads of 64: the
# D 64 bucket), batch 4
# name, B, H, KH, Sq, Skv, D, causal
FLASH_CASES = [
    ("qwen2-1.5b", 4, 12, 2, 4096, 4096, 128, True),
    ("granite-34b", 1, 48, 1, 4096, 4096, 128, True),
    ("qwen2-1.5b Sq 1024 / Skv 4096", 4, 12, 2, 1024, 4096, 128, True),
    ("granite-moe-3b-a800m", 4, 24, 8, 4096, 4096, 64, True),
    ("zamba2-7b", 2, 32, 32, 4096, 4096, 112, True),
    # whisper-large-v3: the encoder over its 1,536 frames, and a decoder's
    # cross-attention from 4,096 tokens to them, both non-causal
    ("whisper-large-v3 encoder", 4, 20, 20, 1536, 1536, 64, False),
    ("whisper-large-v3 cross Sq 4096 / Skv 1536", 4, 20, 20, 4096, 1536, 64, False),
]
SDPA_CALL = ("scaled_dot_product_attention(is_causal=causal, enable_gqa=True), top-left "
             "causal")
# K9 with ``p_bf16`` (repro's flash_block_dtype="bf16"): qwen2-1.5b's shape,
# each body against the blockwise plain version over kv blocks of the body's
# own tile (32 keys fp32, 64 bf16), so that both take each probability
# against the same running max and round it once to bf16
P_TILE_CASE = ("qwen2-1.5b p_bf16", 4, 12, 2, 4096, 4096, 128, True)
P_TILE_KEYS = {torch.float32: 32, torch.bfloat16: 64}
P_TILE_RULES = {
    "float32": "|out - plain| <= 1e-5 max|plain|: the fp32 sums' order",
    "bfloat16": "|out - plain| <= 2^-8 (|plain| + plain(|v|)) + 1e-5 max|plain|: a rounding "
                "of the output and of each probability (plain(|v|): the same weights on |v|), "
                "and mean |out - plain| under mean |out - plain without the rounding|"}


def p_tile_hold(out: torch.Tensor, want: torch.Tensor, unrounded: torch.Tensor,
                weight: torch.Tensor) -> tuple[float, float]:
    """``out`` against ``want``, the plain version with each probability
    rounded to bf16, by ``P_TILE_RULES``: (the worst ratio of |out - want|
    to the body's bound, mean |out - unrounded| / mean |out - want|).  An
    fp32 ``out`` is held to ``ROUND_ATOL max|want|``: the body rounds each
    probability where ``want`` does, its fp32 sums run in another order.  A
    bf16 body's q.k sums run in another order too, and a probability that
    sits by a bf16 rounding boundary rounds to the next value, a bf16 step
    (2^-7 of it) from ``want``'s, which one rounding of the output cannot
    cover (10.5x it at S 4,096, NVIDIA H100 80GB HBM3): its per-element
    bound is a rounding of the output and of each probability (``weight``:
    ``want``'s weights on |v|), which covers one such probability among
    others, and which the default body passes as well; the second number,
    which the rounding of the output moves alike on both sides, says which
    version ``out`` computes: above 1 with the probabilities rounded (the
    rule holds it above 1), below 1 without (the default body)."""
    d = (out.float() - want).abs()
    near = float((out.float() - unrounded).abs().mean()) / max(float(d.mean()), 1e-30)
    atol = ROUND_ATOL * float(want.abs().max())
    if out.dtype == torch.float32:
        return float(d.max()) / atol, near
    return float((d / (BF16_ULP * (want.abs() + weight) + atol)).max()), near


def flash_phase(dev, ops, fa, ref, sass: dict) -> dict:
    """The attention path ``ops.flash_attention_fused`` at the three widths
    above in fp32 and bf16, causal, then one backward; the counts cover that
    run only.  Then each output is held against K9's plain version
    (``hold``: fp32 to ``ERR_TOL``; bf16 per element within one rounding of
    the plain version in fp32 on the same inputs) and kernel, plain version
    and SDPA are timed with CUDA events."""
    import torch.nn.functional as F

    g = torch.Generator(device=dev)
    g.manual_seed(8)
    fa.reset_launches()
    runs = []
    for name, b, h, kh, sq, skv, d, causal in FLASH_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn((b, h, sq, d), generator=g, device=dev).to(dtype)
            k = torch.randn((b, kh, skv, d), generator=g, device=dev).to(dtype)
            v = torch.randn((b, kh, skv, d), generator=g, device=dev).to(dtype)
            runs.append((name, dtype, causal, (q, k, v),
                         ops.flash_attention_fused(q, k, v, causal=causal)))
    name, b, h, kh, sq, skv, d, causal = P_TILE_CASE
    tiles = []
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn((b, h, sq, d), generator=g, device=dev).to(dtype)
        k = torch.randn((b, kh, skv, d), generator=g, device=dev).to(dtype)
        v = torch.randn((b, kh, skv, d), generator=g, device=dev).to(dtype)
        tiles.append((name, dtype, causal, (q, k, v),
                      ops.flash_attention_fused(q, k, v, causal=causal, p_bf16=True)))
    # one backward at qwen2's width, batch 1, seq 1,024: the recompute through
    # the blockwise plain attention against plain autograd of K9's plain version
    q, k, v = (torch.randn(s, generator=g, device=dev)
               for s in ((1, 12, 1024, 128), (1, 2, 1024, 128), (1, 2, 1024, 128)))
    w = torch.randn((1, 12, 1024, 128), generator=g, device=dev)
    lhs = [t.clone().requires_grad_(True) for t in (q, k, v)]
    (ops.flash_attention_fused(*lhs, causal=True) * w).sum().backward()
    torch.cuda.synchronize()
    launches = fa.LAUNCHES["flash_fwd"]
    if launches != len(runs) + len(tiles) + 1:
        raise AssertionError(f"flash path launched flash_fwd {launches} times, "
                             f"not {len(runs) + len(tiles) + 1}")
    rhs = [t.clone().requires_grad_(True) for t in (q, k, v)]
    (ref.flash_fwd_ref(*rhs, causal=True) * w).sum().backward()
    grad_err = max(float((a.grad - b.grad).abs().max()) for a, b in zip(lhs, rhs))
    grad_scale = max(float(b.grad.abs().max()) for b in rhs)
    if not grad_err <= 1e-4 * max(grad_scale, 1.0):
        raise AssertionError(f"flash_mha backward vs plain autograd: {grad_err}")
    log(f"[flash] flash_mha backward (1, 12/2, 1024, 128): max |grad - plain autograd| "
        f"{grad_err:.3e} (largest gradient {grad_scale:.3e})")
    del lhs, rhs, q, k, v, w

    cases = []
    for name, dtype, causal, (q, k, v), out in runs:
        b, h, sq, d = q.shape
        skv = k.shape[2]
        if out.dtype != dtype:
            raise AssertionError(f"flash {name}: {out.dtype} out of {dtype} inputs")
        checked = hold(f"flash {name} {dtype}", out,
                       lambda *a: ref.flash_fwd_ref(*a, causal=causal), (q, k, v))
        library = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                         enable_gqa=True)
        lib_err = float((library().float() - out.float()).abs().max())
        flops = flash_flops(b, h, sq, skv, d, causal)
        nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
        peak = FP32_FLOP_S if dtype == torch.float32 else BF16_FLOP_S
        t_ops, t_bytes = flops / peak, nbytes / BW_BYTES_S
        c = {"case": name, "dtype": str(dtype).replace("torch.", ""), "body": fa.BODY[dtype][1],
             "shape": {"B": b, "H": h, "KH": k.shape[1], "Sq": sq, "Skv": skv, "D": d},
             "causal": causal,
             **checked, "ms": timed(lambda: fa.flash_fwd(q, k, v, causal=causal), 5),
             "plain_ms": timed(lambda: ref.flash_fwd_ref(q, k, v, causal=causal), 2, warm=1),
             "bound_ms": max(t_ops, t_bytes) * 1e3,
             "bound_by": "operations" if t_ops >= t_bytes else "bytes",
             "library_ms": timed(library, 5), "library_max_abs_diff": lib_err,
             "flops": flops, "bytes": nbytes}
        log(f"[flash] {name} {c['dtype']} ({c['body']}{'' if causal else ', non-causal'}): "
            f"{fmt_err(checked)}, kernel "
            f"{c['ms']:.4f} ms (earlier {fmt_range(EARLIER_MS['flash_fwd'][c['dtype']])} ms at "
            f"qwen2-1.5b width), plain "
            f"{c['plain_ms']:.4f} ms, SDPA {c['library_ms']:.4f} ms (|SDPA - kernel| "
            f"{lib_err:.2e}), bound {c['bound_ms']:.4f} ms ({c['bound_by']}, "
            f"{flops:.3e} flop, {nbytes} B)")
        cases.append(c)
    del runs
    torch.cuda.empty_cache()
    tile_cases = [p_tile_case(*t, fa) for t in tiles]
    del tiles
    torch.cuda.empty_cache()
    main_case = cases[0]                      # qwen2-1.5b, fp32 (the Pallas body's type)
    bf16_case = cases[1]                      # qwen2-1.5b, bf16: the tensor-core body
    row = {"name": "flash_fwd", "route": "cuda",
           "source": "src/repro_torch/csrc/flash_attention.cu",
           "replaces": "src/repro/kernels/flash_attention.py:88",
           "launches": launches,
           "max_abs_err": max(c["max_abs_err"] for c in cases if c["dtype"] == "float32"),
           "bf16_max_abs_err": max(c["max_abs_err"] for c in cases
                                   if c["dtype"] == "bfloat16"),
           "bf16_rounding_ratio": max(c["rounding_ratio"] for c in cases
                                      if c["dtype"] == "bfloat16"),
           "tolerance": {"float32": ERR_TOL, "bfloat16": ROUND_RULE},
           **{k: main_case[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                        "library_ms", "shape")},
           "library_call": SDPA_CALL, "dtype": main_case["dtype"], "cases": cases,
           "backward_max_abs_err": grad_err, "p_bf16": tile_cases,
           "bodies": {str(t).replace("torch.", ""): b[1] for t, b in fa.BODY.items()},
           "sass": sass["flash_attention"],
           **{f"bf16_{k}": bf16_case[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                   "library_ms")}}
    row["kernel_ms"] = row["ms"]
    return row


def p_tile_case(name, dtype, causal, qkv, out, fa) -> dict:
    """K9 with ``p_bf16`` held against ``layers.flash_attention(p_dtype=
    torch.bfloat16)`` on the inputs widened to fp32, over kv blocks of the
    body's tile, by its body's rule (``p_tile_hold``); the default body on
    the same inputs must fail the rule, so the hold sees the rounding.
    Timed beside the default body, the plain version and the bound (no
    PyTorch call rounds the probabilities, so no library time)."""
    q, k, v = qkv
    b, h, sq, d = q.shape
    skv = k.shape[2]
    wide = [t.float() for t in qkv]

    def plain(vv=wide[2], p_dtype=torch.bfloat16):
        return fa.layers.flash_attention(wide[0], wide[1], vv, causal=causal,
                                         kv_block=P_TILE_KEYS[dtype], p_dtype=p_dtype)

    want, unrounded, weight = plain(), plain(p_dtype=None), plain(wide[2].abs())
    ratio, near = p_tile_hold(out, want, unrounded, weight)
    default = p_tile_hold(fa.flash_fwd(q, k, v, causal=causal), want, unrounded, weight)
    err = float((out.float() - want).abs().max())
    rule = P_TILE_RULES[str(dtype).replace("torch.", "")]
    passes = lambda r, n: r <= 1.0 and (dtype == torch.float32 or n > 1.0)
    if out.dtype != dtype or not passes(ratio, near) or passes(*default):
        raise AssertionError(f"flash {name} {dtype}: max |kernel - plain| {err}, {ratio} of "
                             f"the bound, mean distances unrounded / rounded {near} ({rule}); "
                             f"the default body {default}")
    del want, unrounded, weight
    flops = flash_flops(b, h, sq, skv, d, causal)
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    peak = FP32_FLOP_S if dtype == torch.float32 else BF16_FLOP_S
    t_ops, t_bytes = flops / peak, nbytes / BW_BYTES_S
    c = {"case": name, "dtype": str(dtype).replace("torch.", ""),
         "body": fa.BODY[dtype][1] + ("" if dtype == torch.float32 else ", P_hi only") +
         ", p rounded to bf16",
         "shape": {"B": b, "H": h, "KH": k.shape[1], "Sq": sq, "Skv": skv, "D": d},
         "causal": causal, "max_abs_err": err, "bound_ratio": ratio,
         "mean_unrounded_over_rounded": near, "default_body": list(default), "tolerance": rule,
         "ms": timed(lambda: fa.flash_fwd(q, k, v, causal=causal, p_bf16=True), 5),
         "default_ms": timed(lambda: fa.flash_fwd(q, k, v, causal=causal), 5),
         "plain_ms": timed(plain, 2, warm=1),
         "bound_ms": max(t_ops, t_bytes) * 1e3,
         "bound_by": "operations" if t_ops >= t_bytes else "bytes", "library_ms": None}
    log(f"[flash] {name} {c['dtype']} ({c['body']}): max |kernel - plain| {err:.3e}, "
        f"{ratio:.3f} of the bound, mean distances from the unrounded / rounded plain "
        f"{near:.3f} ({rule}); the default body {default[0]:.3f} of the bound, {default[1]:.3f}; "
        f"kernel {c['ms']:.4f} ms (default body {c['default_ms']:.4f} ms), plain "
        f"{c['plain_ms']:.4f} ms, bound {c['bound_ms']:.4f} ms ({c['bound_by']})")
    return c

# ---------------------------------------------------------------------------
# phase 7: DLRM training at full width
# ---------------------------------------------------------------------------

TRAIN_STEPS = 4
# of each leaf's largest entry, kernel path against ``plain_dlrm_loss``.
# Both round one fp32 table gradient once to bf16 (the kernel path's chunked
# fp32 recompute, the reference's fp32 embedding-bag backward): where their
# fp32 sums, taken in other orders, straddle a rounding boundary they differ
# by one bf16 step of the element, at most 2^-7 of it.  A second step allows
# for a pooled value that the kernel's in-order sum and the plain reduction
# round one step apart, which the bf16 head carries into the bag's
# cotangent.  The readings at batch 64 / 256 / 1024
# (scripts/torch_step1_grad_readings.py) lie below it; a dropped, doubled or
# miswired chunk reads near 1
GRAD_TOL = 2.0 ** -6


def train_config(arch, registry):
    """dlrm-qr and dlrm-tt at full width; dlrm-dense at 200,000 rows per
    table (the example's vocabulary): at 2M rows its fp32 params, gradient
    and two moments would take 4 x 26.6 GB of the card's 80 GB."""
    cfg = registry.get_dlrm(arch)
    if cfg.embedding_kind == "dense":
        cfg = cfg.replace(name="dlrm-dense-200k", vocab_per_table=200_000)
    return cfg


def plain_packed(layout, packed: dict, cache, s: dict, ref) -> torch.Tensor:
    """The packed bags' plain version on packed buffers and (G, K) streams."""
    if layout.kind == "qr":
        return ref.packed_qr_bag_ref(packed["q"], cache, packed["r"], s["q_idx"], s["slot"],
                                     s["r_idx"])
    if layout.kind == "tt":
        return ref.packed_tt_bag_ref(packed["g1"], packed["g2"], packed["g3"], cache,
                                     s["i1"], s["i2"], s["i3"], s["slot"], dims=layout.tt_dims)
    return ref.packed_bag_ref(packed["table"], cache, s["idx"], s["slot"])


# dlrm-tt's training lookup at train_8k crosses 52 recompute chunks
RECOMPUTE_CHUNKS = 52
# of each element's summed contribution magnitudes m.  The recompute widens
# the buffers and the cotangent to fp32, sums every chunk's gradient in fp32
# and rounds the total once to bf16: at most 2^-8 of the exact value, which
# is at most m (the floor 1e-6 max m in ``exact_grad_check`` covers the fp32
# sums' order)
RECOMPUTE_RULE = 2.0 ** -8


def exact_grad_check(name, run, plain, bufs: dict, ct, row_bytes: int, lead: int, ops):
    """A kernel path's gradient across ``RECOMPUTE_CHUNKS`` recompute chunks,
    held against the exact gradient.  ``run(leaves)`` is the path on bf16
    leaves requiring grad; it takes the bf16 cotangent ``ct`` back with
    ``ops.RECOMPUTE_BYTES`` cut so its ``lead`` bags (``row_bytes`` of fp32
    rows each) cross the chunks.  The exact gradient is plain autograd of
    ``plain`` in one pass on the buffers and cotangent widened to fp32.
    Every element must lie within ``RECOMPUTE_RULE`` of the sum of its
    contributions' magnitudes (``plain``'s gradient on |buffers| and
    |cotangent|: the plain versions are multilinear); a dropped or doubled
    chunk reads far above.  Returns the row's keys."""
    names = list(bufs)
    leaves = {n: bufs[n].detach().requires_grad_(True) for n in names}
    out = run(leaves)
    per_chunk = -(-lead // RECOMPUTE_CHUNKS)
    saved = ops.RECOMPUTE_BYTES
    ops.RECOMPUTE_BYTES = per_chunk * row_bytes
    try:
        got = torch.autograd.grad(out, [leaves[n] for n in names], ct)
    finally:
        ops.RECOMPUTE_BYTES = saved
    wide = {n: bufs[n].float().requires_grad_(True) for n in names}
    exact = torch.autograd.grad(plain(wide), [wide[n] for n in names], ct.float())
    mags = {n: bufs[n].float().abs().requires_grad_(True) for n in names}
    total = torch.autograd.grad(plain(mags), [mags[n] for n in names], ct.float().abs())
    worst, err = 0.0, 0.0
    for n, a, e, m in zip(names, got, exact, total):
        d = (a.float() - e).abs()
        ratio = float((d / (RECOMPUTE_RULE * m + 1e-6 * float(m.max()) + 1e-30)).max())
        worst, err = max(worst, ratio), max(err, float(d.max()) / float(e.abs().max()))
        if a.dtype != bufs[n].dtype or not ratio <= 1.0:
            raise AssertionError(f"{name} recompute across {-(-lead // per_chunk)} chunks, "
                                 f"{n}: {ratio} of the rounding bound")
    return {"chunks": -(-lead // per_chunk), "bags": lead, "recompute_ratio": worst,
            "recompute_rel_err": err}


def recompute_check(dev, cfg, params, idx, dlrm, pt, ops, ref) -> dict:
    """The training lookup's backward (``ops.packed_multi_pooled`` on the
    bf16 packed buffers of ``params`` and the streams of ``idx``, all-miss
    slots and a 1-row cache, as ``packed_multi_bag_lookup`` calls it) across
    many chunks against the exact gradient (``exact_grad_check``)."""
    bags = dlrm.make_bags(cfg)
    layout = pt.layout_for(bags)
    dtype = bags[0].emb.compute_dtype
    with torch.no_grad():
        packed = pt.pack_params(params["tables"], layout, dtype=dtype)
    s = {k: v.reshape(-1, cfg.pooling) for k, v in pt.pack_indices(idx, layout).items()}
    s["slot"] = torch.full_like(next(iter(s.values())), -1)
    cache = pt.dummy_cache(layout, dtype, dev)
    ct = torch.randn((s["slot"].shape[0], cfg.dim),
                     generator=torch.Generator(dev).manual_seed(10), device=dev).to(dtype)
    return exact_grad_check(
        cfg.name, lambda leaves: ops.packed_multi_pooled(
            {**leaves, "cache": cache}, s, kind=layout.kind, dims=layout.tt_dims),
        lambda bufs: plain_packed(layout, bufs, cache.float(), s, ref), packed, ct,
        cfg.pooling * layout.big_width * 4, s["slot"].shape[0], ops)


def plain_dlrm_loss(params, batch, cfg, dlrm, pt, ref):
    """The DLRM loss with the embedding layer through the packed bags' plain
    versions on the same packed buffers and streams, autograd all the way:
    the reference of the step-1 check.  The buffers are packed in the
    compute dtype as the kernel path packs them, then widened to fp32, so
    the embedding-bag backward runs in fp32 and each table gradient is
    rounded once to the compute dtype (where the widening's backward casts
    it); the pooled output is rounded to the compute dtype as the kernel's
    is, so both paths feed the head the same values."""
    bags = dlrm.make_bags(cfg)
    layout = pt.layout_for(bags)
    dtype = bags[0].emb.compute_dtype
    packed = pt.pack_params(params["tables"], layout, dtype=dtype)
    wide = {k: v.float() for k, v in packed.items()}
    s = {k: v.reshape(-1, cfg.pooling) for k, v in pt.pack_indices(batch["idx"],
                                                                 layout).items()}
    s["slot"] = torch.full_like(next(iter(s.values())), -1)
    cache = pt.dummy_cache(layout, torch.float32, s["slot"].device)
    pooled = plain_packed(layout, wide, cache, s, ref).to(dtype)
    pooled = pooled.reshape(*batch["idx"].shape[:2], cfg.dim)
    pooled = pooled * pt.combiner_scale(bags, pooled.dtype, pooled.device)[None, :, None]
    logits = dlrm.forward_from_pooled(params, batch["dense"], pooled, cfg)
    return dlrm.bce_loss(logits, batch["labels"])


def train_phase(dev, arch, batch, registry, dlrm, synthetic, train_step, opt, tree, pt, ops,
                ref, mods) -> dict:
    """``TRAIN_STEPS`` steps of ``make_train_step`` at ``batch``; losses and
    gradient norms finite, one launch of the packed kernel per step; the
    step-1 table gradients on a cut batch (64) within ``GRAD_TOL`` of the
    plain path's with an fp32 embedding-bag backward (``plain_dlrm_loss``;
    dlrm-tt's cut batch fits one recompute chunk); the
    lookup's backward on the same cut batch across ``RECOMPUTE_CHUNKS``
    chunks against the exact gradient (``recompute_check``); then one step
    split into forward, backward and update with CUDA events.  Returns the
    launches of the run."""
    cfg = train_config(arch, registry)
    kernel = KERNEL_OF[cfg.embedding_kind]
    t0 = time.perf_counter()
    params = dlrm.init_dlrm(cfg, seed=0, device=dev)
    state = opt.init(params)
    truth = synthetic.dlrm_truth(cfg, device=dev)
    batches = [synthetic.dlrm_planted_batch(cfg, truth, batch, seed=0, step=s, device=dev)
               for s in range(TRAIN_STEPS)]
    loss_fn = train_step.make_dlrm_loss(cfg)
    # the train CLI's learning rate, warmed up over the run
    opt_cfg = opt.OptConfig(lr=3e-4, warmup_steps=TRAIN_STEPS, total_steps=TRAIN_STEPS)
    step = train_step.make_train_step(loss_fn, opt_cfg)

    # step-1 gradients on a cut batch: the kernels' path against the plain path
    cut = {k: v[:64] for k, v in batches[0].items()}
    _l, _m, g_kernel = train_step.value_and_grad(loss_fn, params, cut)
    _l, _m, g_plain = train_step.value_and_grad(
        lambda p, b: (plain_dlrm_loss(p, b, cfg, dlrm, pt, ref), {}), params, cut)
    worst = 0.0
    for (path, a), b in zip(tree.leaves_with_paths(g_kernel["tables"]),
                            tree.leaves(g_plain["tables"])):
        scale = max(float(b.abs().max()), 1e-12)
        rel = float((a - b).abs().max()) / scale
        worst = max(worst, rel)
        if not rel <= GRAD_TOL:
            raise AssertionError(f"{cfg.name} step-1 gradient {path}: kernel vs plain {rel}")
    del g_kernel, g_plain
    chunks = recompute_check(dev, cfg, params, cut["idx"], dlrm, pt, ops, ref)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats(dev)
    reset_all(mods)
    t0 = time.perf_counter()
    losses, norms = [], []
    for b in batches:
        params, state, m = step(params, state, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches_now(mods)
    peak = torch.cuda.max_memory_allocated(dev)
    if counts[kernel] != TRAIN_STEPS or sum(counts.values()) != TRAIN_STEPS:
        raise AssertionError(f"{cfg.name} training launches {counts} for {TRAIN_STEPS} steps")
    if not (np.isfinite(losses).all() and np.isfinite(norms).all()):
        raise AssertionError(f"{cfg.name}: losses {losses}, grad norms {norms}")

    # one more step, split: forward, backward, update
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    leaves = [p.detach().requires_grad_(True) for p in tree.leaves(params)]
    live = tree.unflatten(params, leaves)
    ev[0].record()
    with torch.enable_grad():
        loss, _ = loss_fn(live, batches[0])
        ev[1].record()
        grads = torch.autograd.grad(loss, leaves)
    ev[2].record()
    opt.update(params, tree.unflatten(params, list(grads)), state, opt_cfg)
    ev[3].record()
    torch.cuda.synchronize()
    split = [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]
    res = {"arch": cfg.name, "batch": batch, "steps": TRAIN_STEPS, "losses": losses,
           "grad_norms": norms, "ms_per_step": wall / TRAIN_STEPS * 1e3,
           "forward_ms": split[0], "backward_ms": split[1], "update_ms": split[2],
           "peak_gib": peak / 2**30, "launches": counts[kernel], "kernel": kernel,
           "step1_grad_rel_err": worst, **chunks}
    log(f"[train] {cfg.name} batch {batch}: {TRAIN_STEPS} steps {res['ms_per_step']:.1f} ms "
        f"per step (forward {split[0]:.1f}, backward {split[1]:.1f}, update {split[2]:.1f} "
        f"ms), losses {', '.join(f'{x:.4f}' for x in losses)}, grad norms "
        f"{', '.join(f'{x:.3f}' for x in norms)}, peak {res['peak_gib']:.2f} GiB, {kernel} "
        f"launches {counts[kernel]}, step-1 table gradients kernel vs plain (batch 64) "
        f"{worst:.2e} of scale; recompute across {chunks['chunks']} chunks vs exact fp32 "
        f"{chunks['recompute_rel_err']:.2e} of scale, {chunks['recompute_ratio']:.3f} of the "
        f"rounding bound; set-up {setup_s:.1f} s")
    del params, state, batches, truth, grads, leaves, live
    torch.cuda.empty_cache()
    return res


def cli_train_run(train_cli, batch, mods) -> int:
    """The training CLI on the card (``python -m repro_torch.launch.train
    --arch dlrm-qr``, full width, 4 steps of ``batch``): exit 0 and one
    launch of K1 per step."""
    reset_all(mods)
    t0 = time.perf_counter()
    rc = train_cli.main(["--arch", "dlrm-qr", "--steps", str(TRAIN_STEPS), "--batch",
                         str(batch), "--log-every", "1"])
    torch.cuda.synchronize()
    counts = launches_now(mods)
    if rc != 0 or counts["packed_qr_bag"] != TRAIN_STEPS or sum(counts.values()) != TRAIN_STEPS:
        raise AssertionError(f"train CLI: exit {rc}, launches {counts}")
    log(f"[train] launch.train --arch dlrm-qr --batch {batch}: {TRAIN_STEPS} steps in "
        f"{time.perf_counter() - t0:.1f} s (set-up included), packed_qr_bag launched "
        f"{counts['packed_qr_bag']} times")
    torch.cuda.empty_cache()
    return counts["packed_qr_bag"]


def tt_lookup_grad_run(dev, registry, dlrm, synthetic, tt_embedding, ref, ops, mods) -> dict:
    """``tt_embedding.lookup`` with ``tt_exec="pallas"`` on one full-width
    dlrm-tt table's cores held in bf16 and requiring grad (2,048 x 32 rows):
    K5 bf16 launches once, and the core gradients across many recompute
    chunks lie within bf16 rounding of the exact gradient through K5's plain
    version (``exact_grad_check``)."""
    cfg = registry.get_dlrm("dlrm-tt")
    emb = dataclasses.replace(dlrm.make_bags(cfg)[0].emb, param_dtype=torch.bfloat16)
    cores = tt_embedding.init(emb, generator=torch.Generator(dev).manual_seed(9), device=dev)
    cores = {k: v.to(torch.bfloat16) for k, v in cores.items()}
    idx = synthetic.zipf_batch(cfg.vocab_per_table, (2048, cfg.pooling), seed=16, device=dev)
    i1, i2, i3 = (x.reshape(-1, 1) for x in tt_embedding.tt_decompose(idx, emb.tt_spec))
    ct = torch.randn((*idx.shape, cfg.dim), generator=torch.Generator(dev).manual_seed(17),
                     device=dev).to(torch.bfloat16)
    reset_all(mods)
    res = exact_grad_check(
        "bf16 tt_embedding.lookup", lambda leaves: tt_embedding.lookup(leaves, idx, emb),
        lambda bufs: ref.tt_bag_ref(bufs["g1"], bufs["g2"], bufs["g3"], i1, i2, i3,
                                    dims=emb.tt_spec.dims).reshape(ct.shape),
        cores, ct, cores["g2"].shape[1] * 4, i1.shape[0], ops)
    torch.cuda.synchronize()
    counts = launches_now(mods)
    if counts["tt_bag"] != 1 or sum(counts.values()) != 1:
        raise AssertionError(f"bf16 tt_embedding.lookup launches {counts}")
    log(f"[train] tt_embedding.lookup, bf16 cores under grad {tuple(idx.shape)}: tt_bag "
        f"launched once; core gradients across {res['chunks']} recompute chunks vs exact "
        f"fp32 {res['recompute_rel_err']:.2e} of scale, {res['recompute_ratio']:.3f} of the "
        f"rounding bound")
    return {"launches": counts["tt_bag"], **res}


# ---------------------------------------------------------------------------
# phase 8: the serving control plane (tuner, ladder rungs, front end, adaptation)
# ---------------------------------------------------------------------------

# rows per table of dlrm-dense in the rungs phase: the ladder holds three
# copies of the tables (the params the baseline rung reads, the packed
# buffer, the 26 one-table packed buffers); at 2,000,000 rows they would take
# 80 GB
RUNG_DENSE_ROWS = 1_000_000
# the baseline rung (``multi_bag_lookup``) sums each subtable's rows in the
# compute dtype, bf16, and adds the sums there: where the Q and R sums cancel
# it sits up to ~180 roundings of the result away from the kernel rungs'
# fp32 sum (0.0274 max at dlrm-qr's widths on the CPU, batch 2,048), so it is
# held to repro's own bound between its baseline and kernel rungs
# (tests/test_serve_frontend.py: rtol = atol = 2e-2)
BASELINE_TOL = 2e-2
FRONTEND_BATCH = 256
# the adaptive sessions' batch: the controller's host work grows with a
# batch's distinct rows (SpaceSaving walks each against its 256 tracked keys
# in Python); at batch 2,048 on full-width dlrm-qr the adaptive sessions
# took 202.6 s on an NVIDIA H100 80GB HBM3 host (PERF.md, PR 18)
ADAPT_BATCH = 256
ADAPT_POLICY = dict(check_every=4, min_batches=8, min_gain=0.05, cooldown_batches=4)
FRONTEND_ARRIVAL = "rate=1000,horizon=3,deadline_ms=400,flash=0.2+0.3x10,seed=5"
FRONTEND_FAULTS = "stall@0.6:0.5,replica@0.9:0.2,gather@1.2:2,drop@1.3,retries=3"
FRONTEND_SLO = "p99_ms=150,objective=0.99,fast_window=4,slow_window=8,name=frontend"


def launch_delta(mods, before: dict) -> dict:
    now = launches_now(mods)
    return {k: n - before.get(k, 0) for k, n in now.items() if n - before.get(k, 0)}


def add_launches(by_name: dict, delta: dict) -> None:
    """Serving launches are the fp32 entries: each adds to its kernel's row."""
    for name, n in delta.items():
        by_name[name]["launches"] += n


def serving_traces(cfg, synthetic, n: int = 50_000) -> list:
    """The per-table Zipf traces ``build_serve_state`` profiles (seed 0)."""
    return [synthetic.zipf_trace(cfg.vocab_per_table, n, alpha=1.05, seed=7 + t)
            for t in range(cfg.num_tables)]


def tuner_phase(dev, batch, registry, dlrm, synthetic, serve_rec, engine, tune, mods):
    """``tune.fit(mode="measure", max_samples=4)`` on full-width dlrm-qr
    traces at batch ``batch`` (each sample timed by CUDA events, the median of
    3 calls), the choice in the knob space and frozen by ``plan(tuner=)``;
    then ``build_serve_state(tuner=)``, 5 sequential batches, the tuned
    plan's prediction against its measured ``serve_gather`` and its measured
    batches.  Returns (record, the tuned state, its params, launches)."""
    from repro_torch.tune import tuner as tuner_mod

    cfg = registry.get_dlrm("dlrm-qr")
    spec = engine.EngineSpec.from_dlrm(cfg, serving=True)
    traces = serving_traces(cfg, synthetic)
    before = launches_now(mods)
    t0 = time.perf_counter()
    tuner = tune.fit(spec, traces, mode="measure", batch=batch, num_shards=4,
                     max_samples=4, repeats=3, device=dev)
    fit_s = time.perf_counter() - t0
    samples = []
    for s in tuner.samples:
        samples.append({"knobs": s.knobs.describe(),
                        "features": dict(zip(tune.FEATURES, s.features)),
                        "ms": s.measured_s * 1e3})
        log(f"[tuner] sample {s.knobs.backend} slots {s.knobs.cache_slots} "
            f"{s.knobs.cache_slot_policy}, features "
            + ", ".join(f"{k} {v:.6g}" for k, v in samples[-1]["features"].items())
            + f": {s.measured_s * 1e3:.4f} ms (CUDA events, median of 3)")
    coef = {b: dict(zip(tune.FEATURES, m.coef)) for b, m in tuner.models.items()}
    for b, c in coef.items():
        log(f"[tuner] {b} model: " + ", ".join(f"{k} {v:.4g}" for k, v in c.items()))
    space = tune.knob_space(spec, packable=True)
    choice = tuner.choose(spec, backend="packed")
    if choice not in space:
        raise AssertionError(f"tuner chose {choice} outside the knob space")
    eplan = engine.plan(spec, traces, num_shards=4, tuner=tuner)
    if eplan.knobs != tuner.choose(spec, packable=True):
        raise AssertionError(f"plan(tuner=) froze {eplan.knobs}, not the tuner's choice")
    log(f"[tuner] fit {fit_s:.2f} s ({len(tuner.samples)} samples, {tuner.source}, "
        f"{tuner.metadata['device_kind']}); chosen (packed) {choice.describe()}, "
        f"default {choice == tune.default_knobs(spec, packable=True)}")

    state = serve_rec.build_serve_state(cfg, shards=4, alpha=1.05, seed=0, device=dev,
                                        tuner=tuner)
    if state.eplan.knobs != choice or state.drift is None or state.predicted_s is None:
        raise AssertionError("build_serve_state(tuner=) did not plan the choice and arm "
                             "the drift monitor")
    params = dlrm.init_dlrm(cfg, seed=0, device=dev)
    r = serve_rec.run_pipeline(cfg, batch=batch, batches=5, mode="sequential", state=state,
                               params=params, device=dev)
    if not all(np.isfinite(x).all() for x in r["logits"]):
        raise AssertionError("tuned plan: non-finite logits")
    idx = synthetic.dlrm_batch(cfg, batch, seed=0, step=1)["idx"].numpy()
    fn, args = tuner_mod._serving_call(state.engine, params["tables"], idx, dev)
    gather_s = tuner_mod._time_call(fn, *args, device=dev, iters=5)
    del fn, args
    drift = state.drift.summary()
    rec = {"config": "dlrm-qr", "batch": batch, "fit_s": fit_s, "samples": samples,
           "coef": coef, "choice": choice.describe(),
           "predicted_ms": state.predicted_s * 1e3, "serve_gather_ms": gather_s * 1e3,
           "batch_p50_ms": r["lat_p50_s"] * 1e3, "drift": drift}
    log(f"[tuner] tuned plan: predicted {state.predicted_s * 1e3:.4f} ms a batch, "
        f"serve_gather measured {gather_s * 1e3:.4f} ms (CUDA events, median of 5; "
        f"{gather_s / state.predicted_s:.3f}x the prediction), whole sequential batch p50 "
        f"{r['lat_p50_s'] * 1e3:.2f} ms ({r['lat_p50_s'] / state.predicted_s:.1f}x: the "
        f"host's prefetch and slot translation, which the model does not price); drift "
        f"monitor: {drift['observations']} observations, recent residual "
        f"{drift['recent_residual']:.1f}, refit recommended {drift['refit_recommended']}")
    return rec, state, params, launch_delta(mods, before)


def rungs_phase(dev, arch, batch, registry, dlrm, synthetic, serve_rec, engine, serve,
                mods) -> tuple[dict, dict]:
    """One batch of ``batch`` through every rung of the degradation ladder
    on ``arch`` at full width (dlrm-dense at ``RUNG_DENSE_ROWS`` rows a
    table): rungs 0-2 bitwise identical, ``baseline`` within
    ``BASELINE_TOL`` of them (it sums in the compute dtype, bf16), the packed kernel
    launched once on ``full`` and ``nocache``, once per table on
    ``pertable``, never on ``baseline``.  ms: host clock around the rung's
    call and a synchronise, median of 3."""
    from repro_torch.serve.degrade import RUNGS

    cfg = registry.get_dlrm(arch)
    if cfg.embedding_kind == "dense":
        cfg = cfg.replace(vocab_per_table=RUNG_DENSE_ROWS)
    kernel = KERNEL_OF[cfg.embedding_kind]
    before = launches_now(mods)
    t0 = time.perf_counter()
    state = serve_rec.build_serve_state(cfg, shards=4, alpha=1.05, seed=0, device=dev)
    params = dlrm.init_dlrm(cfg, seed=0, device=dev)
    ladder = serve.DegradationLadder(state, params)
    emb = state.bags[0].emb
    idx = synthetic.dlrm_batch(cfg, batch, seed=0, step=1)["idx"].numpy()
    rows = np.stack([engine.big_rows(idx[:, t], emb) for t in range(cfg.num_tables)], axis=1)
    scheds = state.fresh_schedulers()
    for t in range(cfg.num_tables):
        scheds[t].prefetch(rows[:, t])
    hit = float(np.mean(np.stack([scheds[t].slots_for(rows[:, t], record=False) >= 0
                                  for t in range(cfg.num_tables)])))
    if hit <= 0:
        raise AssertionError(f"{arch} rungs: the staged cache takes no hit")
    ladder.warm(idx, rows, scheds)
    out, ms, per_call = {}, {}, {}
    for rung in RUNGS[:-1]:
        ladder.rung_i = RUNGS.index(rung)
        walls = []
        for rep in range(3):
            b0 = launches_now(mods)
            tw = time.perf_counter()
            pooled = ladder.pooled(idx, rows, scheds)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - tw)
            if rep == 0:
                per_call[rung] = launch_delta(mods, b0)
                out[rung] = pooled
        ms[rung] = sorted(walls)[1] * 1e3
    ladder.rung_i = 0
    want = {"full": 1, "nocache": 1, "pertable": cfg.num_tables, "baseline": 0}
    got = {r: per_call[r].get(kernel, 0) for r in want}
    if got != want:
        raise AssertionError(f"{arch} rungs: {kernel} launches {got}, want {want}")
    for rung in ("nocache", "pertable"):
        if out[rung].dtype != out["full"].dtype or not torch.equal(out[rung], out["full"]):
            diff = float((out[rung].float() - out["full"].float()).abs().max())
            raise AssertionError(f"{arch}: rung {rung} is not bitwise the full rung "
                                 f"(max |diff| {diff})")
    base = out["baseline"].float()
    err = float((base - out["full"]).abs().max())
    if not torch.allclose(base, out["full"], rtol=BASELINE_TOL, atol=BASELINE_TOL):
        raise AssertionError(f"{arch}: baseline rung vs kernel rungs max |diff| {err}")
    rec = {"config": arch, "rows_per_table": cfg.vocab_per_table, "batch": batch,
           "hit_share": hit, "ms": ms, "launches": {r: per_call[r] for r in want},
           "baseline_max_abs_err": err, "baseline_dtype": str(out["baseline"].dtype)}
    log(f"[rungs] {arch} ({cfg.vocab_per_table:,} rows a table, batch {batch}, hit share "
        f"{hit:.3f}): full == nocache == pertable bitwise; baseline "
        f"({out['baseline'].dtype}) within {BASELINE_TOL} (max |diff| {err:.3e}); ms a batch "
        + ", ".join(f"{r} {v:.3f}" for r, v in ms.items())
        + f"; {kernel} launches a call " + ", ".join(f"{r} {got[r]}" for r in want)
        + (f"; baseline runs K5 {per_call['baseline'].get('tt_bag', 0)} times"
           if cfg.embedding_kind == "tt" else "")
        + f"; phase {time.perf_counter() - t0:.1f} s")
    del ladder, state, params, out, pooled, base
    torch.cuda.empty_cache()
    return rec, launch_delta(mods, before)


def frontend_phase(dev, registry, dlrm, serve_rec, serve, obs, mods) -> tuple[dict, dict]:
    """A chaos session on full-width dlrm-qr in ``measured`` service mode:
    a flash crowd, a stall, a replica loss, two transient gather errors and a
    dropped prefetch.  Every request lands in a bucket, and the ladder steps
    down and comes back to ``full``."""
    cfg = registry.get_dlrm("dlrm-qr")
    before = launches_now(mods)
    t0 = time.perf_counter()
    state = serve_rec.build_serve_state(cfg, shards=4, alpha=1.05, seed=0, device=dev)
    params = dlrm.init_dlrm(cfg, seed=0, device=dev)
    aspec = serve.ArrivalSpec.parse(FRONTEND_ARRIVAL)
    fspec = serve.FaultSpec.parse(FRONTEND_FAULTS)
    fe = serve.Frontend(
        cfg, serve.FrontendConfig(batch_size=FRONTEND_BATCH, queue_cap=1024,
                                  service_mode="measured"),
        state, params, slo=obs.SLOEngine(obs.SLOSpec.parse(FRONTEND_SLO)),
        faults=serve.FaultInjector(fspec))
    reqs = serve.generate(aspec, cfg)
    rep = fe.run(reqs)
    st, deg = rep["requests"], rep["degrade"]
    if st["unaccounted"] != 0 or st["generated"] != len(reqs):
        raise AssertionError(f"frontend: accounting broken {st}")
    if not any(t["from"] == "full" for t in deg["transitions"]):
        raise AssertionError("frontend: the ladder never stepped down")
    if not rep["recoveries_s"]:
        raise AssertionError(f"frontend: the ladder never came back to full "
                             f"({deg['transitions']})")
    if not fe.faults.exhausted():
        raise AssertionError("frontend: a scheduled fault never latched")
    pcts = {k: rep[k] * 1e3 for k in rep if k.startswith(("req_lat_p", "batch_lat_p"))}
    rec = {"config": "dlrm-qr", "batch": FRONTEND_BATCH, "arrival": FRONTEND_ARRIVAL,
           "faults": FRONTEND_FAULTS, "slo": FRONTEND_SLO, "requests": st,
           "virtual_ms": pcts, "s0_wall_ms": rep["calibration"]["s0_wall_s"] * 1e3,
           "hit_rate": rep["hit_rate"], "batches_at": deg["batches_at"],
           "transitions": deg["transitions"], "recoveries_s": rep["recoveries_s"],
           "wall_s": time.perf_counter() - t0}
    log(f"[frontend] dlrm-qr, batch {FRONTEND_BATCH}, measured mode (s0 = "
        f"{rec['s0_wall_ms']:.2f} ms of wall a full-rung batch = one 10 ms virtual unit), "
        f"{st['generated']} requests: served {st['served']}, missed {st['deadline_missed']}, "
        f"shed {st['shed_total']} (abandoned {st['abandoned']}), retries {st['retries']}, "
        f"unaccounted {st['unaccounted']}, hit rate {rep['hit_rate']:.4f}")
    log("[frontend] virtual latency ms: " + ", ".join(f"{k} {v:.2f}" for k, v in pcts.items()))
    for tr in deg["transitions"]:
        log(f"[frontend] batch {tr['at_batch']} t={tr['t_s']:.3f}s {tr['from']} -> "
            f"{tr['to']} ({tr['reason']})")
    log(f"[frontend] batches per rung {deg['batches_at']}, time to recover "
        f"{rep['time_to_recover_s']:.3f} s (virtual); phase {rec['wall_s']:.1f} s")
    del fe, state, params
    torch.cuda.empty_cache()
    return rec, launch_delta(mods, before)


def adapt_phase(dev, registry, dlrm, synthetic, serve_rec, adapt, tuned_state, tuned_params,
                mods) -> tuple[dict, dict]:
    """A stationary ``serve_adaptive`` session on full-width dlrm-qr is
    bitwise ``run_pipeline`` on the same batches (pinned residency against
    the oracle prefetcher: hits and misses load the same bits); the
    controller's host costs (``observe`` of one batch, ``evaluate`` over
    every table's 2M rows); then a drifting session with ``refit=True`` on
    the tuner-armed state.  Batch ``ADAPT_BATCH``."""
    from repro_torch.adapt import loop

    cfg = registry.get_dlrm("dlrm-qr")
    batch = ADAPT_BATCH
    before = launches_now(mods)
    t0 = time.perf_counter()
    state = serve_rec.build_serve_state(cfg, shards=4, alpha=1.05, seed=0, device=dev)
    params = dlrm.init_dlrm(cfg, seed=0, device=dev)
    ref = serve_rec.run_pipeline(cfg, batch=batch, batches=4, mode="sequential", state=state,
                                 params=params, device=dev)
    idx = [synthetic.dlrm_batch(cfg, batch, seed=0, step=t, device=dev)["idx"].cpu().numpy()
           for t in range(4)]
    res = loop.serve_adaptive(cfg, batch=batch, batches=4, seed=0, state=state,
                              params=params, idx_override=idx)
    for t in range(4):
        if not np.array_equal(ref["logits"][t], res["logits"][t]):
            raise AssertionError(f"adapt: stationary logits of batch {t} are not the "
                                 f"pipeline's")
    log(f"[adapt] stationary: 4 batches of {batch}, logits bitwise run_pipeline's "
        f"(hit rate pinned {res['hit_rate']:.4f}, prefetch {ref['hit_rate']:.4f})")
    ctl = adapt.AdaptController(state.eplan, seed=0)
    tc = time.perf_counter()
    ctl.observe(idx[1])
    observe_s = time.perf_counter() - tc
    tc = time.perf_counter()
    ctl.evaluate(ctl.fresh_caches())
    evaluate_s = time.perf_counter() - tc
    log(f"[adapt] controller host cost on full-width dlrm-qr: observe one batch of {batch} "
        f"{observe_s:.3f} s, evaluate (26 tables x {cfg.vocab_per_table:,} rows) "
        f"{evaluate_s:.3f} s")
    del state, params, ctl
    torch.cuda.empty_cache()
    engine_before = tuned_state.engine
    ctl = adapt.AdaptController(tuned_state.eplan, policy=adapt.AdaptPolicy(**ADAPT_POLICY),
                                seed=0)
    drift = loop.serve_adaptive(
        cfg, batch=batch, batches=16, seed=0, state=tuned_state, params=tuned_params,
        controller=ctl, schedule=adapt.DriftSchedule(period=6, fraction=0.25), refit=True,
        refit_kw=dict(max_samples=2, repeats=1))
    hs = drift["hit_series"]
    for ev in drift["events"]:
        log(f"[adapt] drift event at batch {ev['batch']}: {ev['kind']}"
            + (f", gain {ev['gain']}" if "gain" in ev else "")
            + (f", staged {ev['staged_rows']} rows" if "staged_rows" in ev else "")
            + (f", refit knobs {ev['knobs']}" if "knobs" in ev else ""))
    rec = {"config": "dlrm-qr", "batch": batch, "stationary_bitwise": True,
           "observe_s": observe_s, "evaluate_s": evaluate_s,
           "drift_schedule": drift["schedule"], "policy": ADAPT_POLICY, "hit_series": hs,
           "staged_series": drift["staged_series"],
           "events": [{k: v for k, v in e.items() if k != "drift"} for e in drift["events"]],
           "engine_rebuilt": tuned_state.engine is not engine_before,
           "batch_p50_ms": drift["lat_p50_s"] * 1e3, "wall_s": time.perf_counter() - t0}
    log(f"[adapt] drifting (period 6 batches, fraction 0.25), 16 batches of {batch}: "
        f"hit rate per batch {' '.join(f'{h:.3f}' for h in hs)}; "
        f"{len(drift['events'])} events, engine rebuilt {rec['engine_rebuilt']}, batch p50 "
        f"{rec['batch_p50_ms']:.2f} ms; phase {rec['wall_s']:.1f} s")
    return rec, launch_delta(mods, before)


def cli_control_runs(serve_rec, obs, mods) -> tuple[dict, dict]:
    """``serve_rec.main`` on dlrm-qr-smoke with ``--frontend --arrival
    --faults`` and with ``--adapt --drift``; each ``--json`` record parses."""
    out = ROOT / "build" / "serve_cli"
    out.mkdir(parents=True, exist_ok=True)
    before = launches_now(mods)
    runs = {
        "frontend": ["--frontend", "--arrival", "rate=400,horizon=2,flash=0.5+0.4x6",
                     "--faults", "stall@0.6:0.5,drop@0.7,replica@0.8:0.3,gather@1.0:1"],
        "adaptive": ["--adapt", "--drift", "period=8,frac=0.25", "--batches", "24"],
    }
    recs = {}
    for mode, flags in runs.items():
        path = out / f"{mode}.json"
        try:
            rc = serve_rec.main(["--arch", "dlrm-qr", "--smoke", *flags, "--json", str(path)])
        finally:
            obs.disable()
            obs.install_observatory()
        (rec,) = json.loads(path.read_text())
        if rc != 0 or rec["mode"] != mode:
            raise AssertionError(f"serve_rec.main --{mode}: rc {rc}, record {rec.get('mode')}")
        recs[mode] = rec
    fr, ad = recs["frontend"], recs["adaptive"]
    if fr["requests"]["unaccounted"] != 0 or not ad["events"]:
        raise AssertionError("serve_rec.main: frontend accounting or adaptive events wrong")
    log(f"[control-cli] --frontend: {fr['requests']['generated']} requests, served "
        f"{fr['requests']['served']}, {len(fr['degrade']['transitions'])} transitions, "
        f"virtual p99 {fr['req_lat_p99_s'] * 1e3:.1f} ms; --adapt: hit "
        f"{ad['hit_first']:.3f} -> {ad['hit_last']:.3f}, events "
        f"{[e['kind'] for e in ad['events']]}")
    obs.registry().reset()
    obs.tracer().reset()
    return ({"frontend": {"requests": fr["requests"],
                          "transitions": len(fr["degrade"]["transitions"])},
             "adaptive": {"hit_first": ad["hit_first"], "hit_last": ad["hit_last"],
                          "events": [e["kind"] for e in ad["events"]]}},
            launch_delta(mods, before))


def control_plane_phase(dev, batch, by_name, mods) -> dict:
    """Phase 8: the tuner, the ladder's rungs on the three configs, the front
    end, adaptation and the two CLI runs; their launches add to the kernel
    rows.  Returns the ``{"control_plane": ...}`` record."""
    from repro_torch import adapt, engine, obs, serve, tune
    from repro_torch.configs import registry
    from repro_torch.data import synthetic
    from repro_torch.launch import serve_rec
    from repro_torch.models import dlrm

    t0 = time.perf_counter()
    record = {}
    tp = time.perf_counter()
    record["tuner"], tuned_state, tuned_params, n = tuner_phase(
        dev, batch, registry, dlrm, synthetic, serve_rec, engine, tune, mods)
    add_launches(by_name, n)
    log(f"[tuner] phase {time.perf_counter() - tp:.1f} s")
    record["rungs"] = []
    for arch in ("dlrm-qr", "dlrm-tt", "dlrm-dense"):
        rec, n = rungs_phase(dev, arch, batch, registry, dlrm, synthetic, serve_rec, engine,
                             serve, mods)
        record["rungs"].append(rec)
        add_launches(by_name, n)
    record["frontend"], n = frontend_phase(dev, registry, dlrm, serve_rec, serve, obs, mods)
    add_launches(by_name, n)
    record["adapt"], n = adapt_phase(dev, registry, dlrm, synthetic, serve_rec, adapt,
                                     tuned_state, tuned_params, mods)
    add_launches(by_name, n)
    del tuned_state, tuned_params
    torch.cuda.empty_cache()
    record["cli"], n = cli_control_runs(serve_rec, obs, mods)
    add_launches(by_name, n)
    record["phase_s"] = time.perf_counter() - t0
    log(f"[control] phase {record['phase_s']:.1f} s")
    return record


# ---------------------------------------------------------------------------
# phase 9: the sharded two-level GnR
# ---------------------------------------------------------------------------

SHARDED_ARCHS = ("dlrm-qr", "dlrm-tt", "dlrm-dense")
# dlrm-dense's cut (the ladder's, RUNG_DENSE_ROWS): at 2,000,000 rows each
# rank's bf16 replicas and packed buffer of the comm-free plan take 26.6 GB,
# four ranks 106 GB, more than the card (at 1,000,000 rows 13.3 GB a rank)
SHARDED_DENSE_ROWS = RUNG_DENSE_ROWS
SHARDED_WORLD = (1, 4)
GENEROUS_BUDGET = 1 << 40      # every table whole on every rank: all comm-free
STARVED_BUDGET = 1 << 20       # the small subtables and a few hot rows: mixed
SHARDED_REPS = 5
SHARDED_TIMEOUT_S = 600
DLRM_TOL = 2e-3                # repro's sharded DLRM bound (tests/test_dlrm.py), fp32 compute
# Roundings to bf16 inside one rank's partial (PARTIAL_ROUNDINGS of
# tests/test_torch_sharded_ranks.py): the packed kernel sums in fp32 and rounds
# once; the per-table partials and the baseline's pooling round the Q + R add
# and the sum (QR), the sum (dense), the two chained products and the sum
# (TT).  Each errs by at most 2^-8 of a value whose magnitudes sum to at most
# A, the sum of |term| over the output's terms, so all shards' partials count
# once together.
PARTIAL_ROUNDINGS = {"packed": {"qr": 1, "dense": 1, "tt": 1},
                     "pertable": {"qr": 2, "dense": 1, "tt": 3}}
SHARDED_RULE = ("|out - S| <= ((P + C) 2^-8 (1 + 2^-8) + 2 n 2^-24) A: S the fp32 sum over "
                "the bf16-rounded tables, A the sum of its terms' magnitudes, P the roundings "
                "in a partial, C the combine's additions (N - 1, 0 without a combine), n the "
                "fp32 additions of a term chain; against the single-card bf16 lookup one "
                "rounding more")


def sharded_cfg(arch, registry):
    cfg = registry.get_dlrm(arch)
    return cfg.replace(vocab_per_table=SHARDED_DENSE_ROWS) if arch == "dlrm-dense" else cfg


def chain_terms(cfg) -> int:
    """fp32 additions in one output element's chain: 2K (QR), K (dense),
    K plus the two rank-long products (TT)."""
    k = cfg.pooling
    return {"qr": 2 * k, "dense": k}.get(cfg.embedding_kind, k + 2 * cfg.tt_rank)


def sharded_tol(a: torch.Tensor, roundings: int, terms: int) -> torch.Tensor:
    u = 2.0 ** -8
    return (roundings * u * (1 + u) + 2 * terms * 2.0 ** -24) * a


def plain_bag_sums(kind, params: dict, idx: torch.Tensor, spec, tt_embedding, hashing,
                   collision: int):
    """(S, A) of one table in fp32 by plain gathers: S the sum of the bag's
    rows over params rounded to bf16, A the same over their magnitudes (for
    TT the contraction of |G1|, |G2|, |G3|)."""
    r = {k: v.to(torch.bfloat16).float() for k, v in params.items()}
    out = []
    for p in (r, {k: v.abs() for k, v in r.items()}):
        if kind == "qr":
            q_idx, r_idx = hashing.qr_decompose(idx, collision)
            out.append(p["q"][q_idx].sum(-2) + p["r"][r_idx].sum(-2))
        elif kind == "tt":
            i1, i2, i3 = tt_embedding.tt_decompose(idx, spec)
            out.append(tt_embedding.contract_rows(p["g1"][i1], p["g2"][i2], p["g3"][i3],
                                                  spec).sum(-2))
        else:
            out.append(p["table"][idx].sum(-2))
    return out


def sharded_tables(cfg, dev, *, keep, seed: int = 0):
    """The config's tables drawn on the card from ``seed`` one at a time (the
    draws of ``init_tables``), each reduced by ``keep(t, params)`` before the
    next is drawn, so a rank never holds every global table at once."""
    from repro_torch.core import qr_embedding
    from repro_torch.models import dlrm

    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return [keep(t, qr_embedding.init(bag.emb, generator=g, device=dev))
            for t, bag in enumerate(dlrm.make_bags(cfg))]


def sharded_batch(cfg, batch: int, dev) -> torch.Tensor:
    from repro_torch.data import synthetic

    return synthetic.dlrm_batch(cfg, batch, seed=0, step=0, device=dev)["idx"]


def sharded_reference(dev, arch, batch, registry) -> dict:
    """The parent's single-card results for ``arch``: S and A (fp32, plain
    gathers over the bf16-rounded tables) and the single-card bf16
    ``engine.lookup`` (one packed launch), on the CPU."""
    from repro_torch import engine as E
    from repro_torch.core import hashing, tt_embedding
    from repro_torch.models import dlrm

    cfg = sharded_cfg(arch, registry)
    bags = dlrm.make_bags(cfg)
    idx = sharded_batch(cfg, batch, dev)
    tables = sharded_tables(cfg, dev, keep=lambda t, p: p)
    spec = bags[0].emb.tt_spec if cfg.embedding_kind == "tt" else None
    s, a = zip(*(plain_bag_sums(cfg.embedding_kind, p, idx[:, t], spec, tt_embedding,
                                hashing, cfg.qr_collision) for t, p in enumerate(tables)))
    single = E.engine_for(E.EngineSpec.from_bags(bags)).lookup(tables, idx)
    out = {"s": torch.stack(s, 1).cpu(), "a": torch.stack(a, 1).cpu(),
           "single": single.float().cpu()}
    del tables, single
    torch.cuda.empty_cache()
    return out


def sharded_world1(dev, batch, registry, mods, ref: dict) -> tuple[dict, dict]:
    """World 1 over nccl in this process, mesh (1, 1), full-width dlrm-qr:
    ``gnr`` against the single-card ``lookup`` of the same tables in the
    same dtype (bf16), then an all-comm-free duplication plan: no
    collective.  Each output is held to the rule against the lookup (one
    rounding in the partial, one in the lookup; ``ref`` is dlrm-qr's
    ``sharded_reference``), and whether it equals the lookup bit for bit
    (the same rows summed in the same order) is recorded.  Returns the
    record and the gnr calls' launches."""
    import datetime

    import torch.distributed as dist

    from repro_torch import engine as E
    from repro_torch.cache import duplication
    from repro_torch.core import placement
    from repro_torch.data import synthetic
    from repro_torch.distributed import collectives
    from repro_torch.launch import mesh as M
    from repro_torch.models import dlrm

    rdv = ROOT / "build" / "sharded" / "rdv_world1"
    rdv.parent.mkdir(parents=True, exist_ok=True)
    rdv.unlink(missing_ok=True)
    log("[mesh] 1 rank, mesh (1, 1) over ('data', 'model'), backend nccl, on 1 card "
        "(in process)")
    dist.init_process_group("nccl", init_method=f"file://{rdv}", world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=120))
    launched = {}
    try:
        mesh = M.make_mesh((1, 1), ("data", "model"), device=dev)
        cfg = registry.get_dlrm("dlrm-qr")
        bags = dlrm.make_bags(cfg)
        tables = sharded_tables(cfg, dev, keep=lambda t, p: p)
        idx = sharded_batch(cfg, batch, dev)
        single = E.engine_for(E.EngineSpec.from_bags(bags)).lookup(tables, idx)
        rec = {"mesh": [1, 1], "backend": "nccl", "arch": "dlrm-qr", "batch": batch}
        eng = E.compile(E.plan(E.EngineSpec.from_bags(bags), mesh=mesh))
        counts = [placement.profile_counts(tr, cfg.vocab_per_table)
                  for tr in serving_traces(cfg, synthetic)]
        dup = duplication.plan_duplication(bags, counts, num_shards=1,
                                           budget_bytes=GENEROUS_BUDGET)
        engd = E.compile(E.plan(E.EngineSpec.from_bags(bags, duplication=True), mesh=mesh,
                                dup=dup))
        tol = sharded_tol(ref["a"], 2, chain_terms(cfg))
        for name, e, tiers in (("packed", eng, None), ("dup_generous", engd,
                                                       engd.hot_tiers(tables))):
            collectives.reset_counts()
            before = launches_now(mods)
            out = e.gnr(mesh)(e.shard_tables(tables, mesh), idx, tiers)
            torch.cuda.synchronize()
            for k, v in launch_delta(mods, before).items():
                launched[k] = launched.get(k, 0) + v
            diff = (out.float() - single.float()).abs()
            rec[name] = {"max_abs_diff_vs_lookup": float(diff.max()),
                         "bitwise_equal_to_lookup": bool(torch.equal(out, single)),
                         "collectives": collectives.CALLS["all_reduce"],
                         "comm_free": all(e.plan.comm_free)}
            if not torch.isfinite(out.float()).all() or (diff.cpu() > tol).any():
                raise AssertionError(f"world 1 {name}: gnr differs from lookup beyond the "
                                     f"rule (max |diff| {rec[name]['max_abs_diff_vs_lookup']})")
            del out
        if rec["dup_generous"]["collectives"] != 0 or not rec["dup_generous"]["comm_free"]:
            raise AssertionError(f"world 1: the all-comm-free plan combined: {rec}")
        if rec["packed"]["collectives"] != 1:
            raise AssertionError(f"world 1: the packed plan made "
                                 f"{rec['packed']['collectives']} collectives, not 1")
        log(f"[sharded] world 1 nccl dlrm-qr: gnr vs lookup max |diff| "
            f"{rec['packed']['max_abs_diff_vs_lookup']} (1 collective, bitwise "
            f"{rec['packed']['bitwise_equal_to_lookup']}), all-comm-free "
            f"{rec['dup_generous']['max_abs_diff_vs_lookup']} (0 collectives, bitwise "
            f"{rec['dup_generous']['bitwise_equal_to_lookup']})")
        del tables, single
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    return rec, launched


def _host_ms(fn, reps: int) -> list[float]:
    """Host-clock ms of each of ``reps`` calls, the card synchronised before
    and after each (the combine crosses the host)."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t) * 1e3)
    return out


def _fingerprint(out: torch.Tensor) -> list:
    return [float(out.float().sum()), int(out.view(torch.int16).long().sum())]


def sharded_run(fn, args, mesh, pg, tg, collectives, SE, *, eng=None, plans=None,
                tables=None, tiers=None, idx=None, modeled=None, reps: int = SHARDED_REPS,
                combine: bool = True) -> dict:
    """One plan's gnr (or baseline) on this rank: its output (rank 0) or a
    fingerprint, the packed launches and collectives of one call, the bytes
    it combined, ms per call (host clock; the local partial by CUDA events
    on the packed plans, with the ranks side by side and then one rank at a
    time while the others wait in a barrier; the combine alone by the host
    clock)."""
    launches = lambda: sum(pg.LAUNCHES.values()) + sum(tg.LAUNCHES.values())
    collectives.reset_counts()
    before = launches()
    out = fn(*args)
    torch.cuda.synchronize()
    rec = {"launches_per_call": launches() - before,
           "collectives_per_call": collectives.CALLS["all_reduce"],
           "bytes_combined": collectives.BYTES["all_reduce"], "modeled_bytes": modeled,
           "fingerprint": _fingerprint(out)}
    if mesh.axis_index("model") == 0:
        rec["out"] = out.cpu()
    rec["gnr_ms"] = _host_ms(lambda: fn(*args), reps)
    if plans is not None:
        import torch.distributed as dist

        pack = eng.local_pack(tables, mesh, hot_tiers=tiers)
        local = lambda: SE.packed_local_partial(tables, idx, eng.bags, plans, mesh=mesh,
                                                pack=pack)
        rec["local_ms"] = timed(local, SHARDED_REPS)     # the ranks side by side
        group = mesh.group("model")
        for r in range(mesh.shape["model"]):              # then one rank at a time
            dist.barrier(group=group)
            if r == mesh.axis_index("model"):
                rec["local_ms_alone"] = timed(local, SHARDED_REPS)
        dist.barrier(group=group)
    if combine and rec["collectives_per_call"]:
        rec["combine_ms"] = _host_ms(lambda: collectives.psum(out, mesh, "model"), reps)
    rec["launches"] = launches() - before
    return rec


def gloo_bf16_check(mesh) -> dict:
    """Whether gloo reduces bf16 CUDA tensors, and how: four ranks' random
    bf16 vectors summed in place by ``dist.all_reduce`` on the card tensor,
    against their fp32 sum rounded once and the chain of bf16 additions."""
    import torch.distributed as dist

    g = torch.Generator(device=mesh.device)
    g.manual_seed(100)
    n = mesh.shape["model"]
    xs = [torch.randn(65536, generator=g, device=mesh.device).to(torch.bfloat16)
          for _ in range(n)]
    x = xs[mesh.axis_index("model")].clone()
    dist.all_reduce(x, group=mesh.group("model"))
    once = torch.stack(xs).float().sum(0).to(torch.bfloat16)
    chain = xs[0]
    for y in xs[1:]:
        chain = chain + y
    stacked = torch.stack(xs).double()
    exact = stacked.sum(0)
    # N - 1 additions in some order, each rounded to bf16 (2^-8 of a
    # partial sum, at most the sum of magnitudes)
    bound = (n - 1) * 2.0 ** -8 * (1 + 2.0 ** -8) * stacked.abs().sum(0)
    err = (x.double() - exact).abs()
    return {"device": str(x.device), "dtype": str(x.dtype),
            "finite": bool(torch.isfinite(x.float()).all()),
            "within_n_minus_1_roundings": bool((err <= bound).all()),
            "max_abs_err_vs_exact": float(err.max()),
            "equals_fp32_sum_rounded_once": bool(torch.equal(x, once)),
            "equals_bf16_chain": bool(torch.equal(x, chain))}


def sharded_rank(mesh, batch: int) -> dict:
    """Phase 9 on one rank of the (1, 4) gloo mesh on the card: per config
    the packed, per-table and starved-duplication plans on the rank's row
    shards (and ``baseline`` on dlrm-qr), then the generous-duplication
    plan on whole bf16 replicas; the gloo bf16 check; ``forward_dlrm`` on a
    (2, 2) mesh of the same ranks."""
    import dataclasses as dc

    from repro_torch import engine as E
    from repro_torch.cache import duplication
    from repro_torch.configs import registry
    from repro_torch.core import placement
    from repro_torch.core import sharded_embedding as SE
    from repro_torch.data import synthetic
    from repro_torch.distributed import collectives
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.sharding import P
    from repro_torch.kernels import packed_gather as pg
    from repro_torch.kernels import tt_gather as tg
    from repro_torch.launch import mesh as M
    from repro_torch.models import dlrm

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = mesh.device
    nsh = mesh.shape["model"]
    res = {"rank": mesh.axis_index("model"), "configs": {}}
    for arch in SHARDED_ARCHS:
        cfg = sharded_cfg(arch, registry)
        bags = dlrm.make_bags(cfg)
        cdt = cfg.cdtype
        idx = sharded_batch(cfg, batch, dev)
        counts = [placement.profile_counts(tr, cfg.vocab_per_table)
                  for tr in serving_traces(cfg, synthetic)]
        dups = {b: duplication.plan_duplication(bags, counts, num_shards=nsh, budget_bytes=v)
                for b, v in (("generous", GENEROUS_BUDGET), ("starved", STARVED_BUDGET))}
        plans = [SE.ShardPlan(b.emb, nsh) for b in bags]
        ici = {b: d.ici_bytes_per_batch(batch, cfg.dim, bytes_per_elem=2)
               for b, d in dups.items()}
        runs = res["configs"][arch] = {}

        # pass 1: the rank's row shards (bf16), the starved plan's layout
        # (its comm-free tables whole) and hot tiers
        starved = dups["starved"]

        def keep_shard(t, p, bag_of=bags, plan=starved):
            tp = plan.tables[t]
            tier = SE.make_dup_hot_tiers([p], [bag_of[t]], dc.replace(plan, tables=(tp,)))[0]
            shard = {k: v.to(cdt) for k, v in SE.shard_qr_params(p, bag_of[t].emb,
                                                                 mesh).items()}
            whole = {k: v.to(cdt) for k, v in p.items()} if tp.comm_free else shard
            return shard, whole, {"hot_table": tier["hot_table"].to(cdt),
                                  "hot_slot": tier["hot_slot"]}

        local, local_s, tiers = (list(x) for x in zip(*sharded_tables(cfg, dev,
                                                                       keep=keep_shard)))
        torch.cuda.empty_cache()
        spec = E.EngineSpec.from_bags(bags)
        eng = E.compile(E.plan(spec, mesh=mesh))
        runs["packed"] = sharded_run(eng.gnr(mesh), (local, idx), mesh, pg, tg, collectives,
                                     SE, eng=eng, plans=plans, tables=local, idx=idx,
                                     modeled=ici["starved"]["baseline"])
        del eng
        engp = E.compile(E.plan(spec.replace(packing="off"), mesh=mesh))
        runs["pertable"] = sharded_run(engp.gnr(mesh), (local, idx), mesh, pg, tg,
                                       collectives, SE, modeled=ici["starved"]["baseline"])
        del engp
        engs = E.compile(E.plan(spec.replace(duplication=True), mesh=mesh, dup=starved))
        runs["dup_starved"] = sharded_run(
            engs.gnr(mesh), (local_s, idx, tiers), mesh, pg, tg, collectives, SE, eng=engs,
            plans=plans, tables=local_s, tiers=tiers, idx=idx,
            modeled=ici["starved"]["duplicated"])
        runs["dup_starved"]["comm_free_tables"] = sum(engs.plan.comm_free)
        runs["dup_starved"]["hot_rows"] = sum(t.hot_plan.num_hot for t in starved.tables)
        del engs
        torch.cuda.empty_cache()
        if arch == "dlrm-qr":
            # raw rows on the wire: ~0.9 GB a rank a call, so one timed call
            engb = E.compile(E.plan(spec, mesh=mesh))
            runs["baseline"] = sharded_run(engb.baseline(mesh), (local, idx), mesh, pg, tg,
                                           collectives, SE, reps=1, combine=False)
            del engb
        del local, local_s, tiers
        torch.cuda.empty_cache()

        # pass 2: the generous plan's whole replicas (bf16) on every rank
        generous = dups["generous"]
        full = sharded_tables(cfg, dev, keep=lambda t, p: {k: v.to(cdt) for k, v in p.items()})
        engg = E.compile(E.plan(spec.replace(duplication=True), mesh=mesh, dup=generous))
        tiers_g = engg.hot_tiers(full)
        local_g = engg.shard_tables(full, mesh)
        runs["dup_generous"] = sharded_run(
            engg.gnr(mesh), (local_g, idx, tiers_g), mesh, pg, tg, collectives, SE, eng=engg,
            plans=plans, tables=local_g, tiers=tiers_g, idx=idx,
            modeled=ici["generous"]["duplicated"])
        runs["dup_generous"]["comm_free_tables"] = sum(engg.plan.comm_free)
        del engg, full, local_g, tiers_g
        torch.cuda.empty_cache()

    res["gloo_bf16"] = gloo_bf16_check(mesh)

    # forward_dlrm on a (2, 2) mesh of the same four ranks, fp32 compute
    mesh22 = M.make_mesh((2, 2), ("data", "model"), device=dev)
    cfg = registry.get_dlrm("dlrm-qr").replace(compute_dtype="float32")
    params = dlrm.init_dlrm(cfg, seed=0, device=dev)
    b = synthetic.dlrm_batch(cfg, batch, seed=0, step=0, device=dev)
    padded = dlrm.pad_tables_for_mesh(params, cfg, mesh22.shape["model"])
    local = {**padded, "tables": [SE.shard_qr_params(t, bag.emb, mesh22) for t, bag in
                                  zip(padded["tables"], dlrm.make_bags(cfg))]}
    del params, padded
    dense = SH.local_shard(b["dense"], mesh22, P("data"))
    idx = SH.local_shard(b["idx"], mesh22, P("data"))
    before = sum(pg.LAUNCHES.values())
    collectives.reset_counts()
    with SH.use_rules(mesh22, SH.DEFAULT_RULES):
        logits = dlrm.forward_dlrm(local, dense, idx, cfg)
    torch.cuda.synchronize()
    res["dlrm"] = {"coords": dict(mesh22.coords), "logits": logits.cpu(),
                   "launches": sum(pg.LAUNCHES.values()) - before,
                   "collectives": collectives.CALLS["all_reduce"]}
    res["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    return res


def sharded_phase(dev, batch, by_name, mods) -> dict:
    """Phase 9: the sharded two-level GnR.  World 1 over nccl in this
    process; the parent's single-card references; then four gloo ranks on
    the card (``launch.mesh.spawn``) run every plan of the three configs,
    the gloo bf16 check and the (2, 2) DLRM forward; their outputs are held
    to ``SHARDED_RULE`` and ``DLRM_TOL``; the ranks' launches add to the
    bf16 rows of K1 / K2 / K3 (the DLRM forward's to K1 fp32).  Returns the
    ``{"sharded": ...}`` record."""
    from repro_torch.configs import registry
    from repro_torch.data import synthetic
    from repro_torch.launch import mesh as M
    from repro_torch.models import dlrm

    t0 = time.perf_counter()
    record = {"world1": None, "configs": [], "rule": SHARDED_RULE}
    refs = {arch: sharded_reference(dev, arch, batch, registry) for arch in SHARDED_ARCHS}
    record["world1"], n = sharded_world1(dev, batch, registry, mods, refs["dlrm-qr"])
    for name, k in n.items():
        by_name[name + "_bf16"]["launches"] += k
    cfg = registry.get_dlrm("dlrm-qr").replace(compute_dtype="float32")
    params = dlrm.init_dlrm(cfg, seed=0, device=dev)
    b = synthetic.dlrm_batch(cfg, batch, seed=0, step=0, device=dev)
    single_logits = dlrm.forward_dlrm(params, b["dense"], b["idx"], cfg).cpu()
    del params, b
    torch.cuda.empty_cache()
    log(f"[sharded] references in {time.perf_counter() - t0:.1f} s")

    log(f"[sharded] parent before the ranks: {torch.cuda.memory_allocated(dev) / 2**30:.2f} "
        f"GiB allocated, {torch.cuda.memory_reserved(dev) / 2**30:.2f} GiB reserved")
    t1 = time.perf_counter()
    ranks = M.spawn(sharded_rank, SHARDED_WORLD, args=(batch,), device="cuda",
                    backend="gloo", init_file=ROOT / "build" / "sharded" / "rdv",
                    timeout_s=SHARDED_TIMEOUT_S)
    record["spawn_s"] = time.perf_counter() - t1
    nsh = SHARDED_WORLD[1]
    for arch in SHARDED_ARCHS:
        cfg = sharded_cfg(arch, registry)
        kind = cfg.embedding_kind
        ref = refs[arch]
        terms = chain_terms(cfg)
        rec = {"arch": arch, "rows": cfg.vocab_per_table, "batch": batch,
               "mesh": list(SHARDED_WORLD), "backend": "gloo", "runs": {}}
        for name, r0 in ranks[0]["configs"][arch].items():
            rs = [r["configs"][arch][name] for r in ranks]
            for r in rs[1:]:
                if r["fingerprint"] != r0["fingerprint"]:
                    raise AssertionError(f"{arch} {name}: ranks hold different outputs")
            path = "packed" if name in ("packed", "dup_starved", "dup_generous") else "pertable"
            # a plan whose every table is comm-free combines nothing
            all_cf = r0.get("comm_free_tables") == cfg.num_tables
            if name == "dup_generous" and not all_cf:
                raise AssertionError(f"{arch}: the generous budget left tables sharded")
            adds = 0 if name == "baseline" or all_cf else nsh - 1
            roundings = PARTIAL_ROUNDINGS[path][kind] + adds
            out = r0["out"].float()
            err = (out - ref["s"]).abs()
            tol = sharded_tol(ref["a"], roundings, terms)
            err_single = (out - ref["single"]).abs()
            tol_single = sharded_tol(ref["a"], roundings + 1, terms)
            if not torch.isfinite(out).all() or (err > tol).any() or (
                    err_single > tol_single).any():
                raise AssertionError(
                    f"{arch} {name}: max |diff| {float(err.max())} vs fp32, "
                    f"{float(err_single.max())} vs the single card, beyond the rule "
                    f"({roundings} roundings)")
            run = {"roundings": roundings,
                   "max_abs_err_vs_fp32": float(err.max()),
                   "max_err_over_tol": float((err / tol.clamp_min(1e-30)).max()),
                   "max_abs_err_vs_single_card": float(err_single.max()),
                   "launches_per_call": r0["launches_per_call"],
                   "collectives_per_call": r0["collectives_per_call"],
                   "bytes_combined_per_rank": r0["bytes_combined"],
                   "modeled_bytes": r0["modeled_bytes"],
                   "gnr_ms_max_over_ranks": max(np.median(r["gnr_ms"]) for r in rs)}
            for key in ("local_ms", "local_ms_alone"):
                if key in r0:
                    run[key + "_max_over_ranks"] = max(r[key] for r in rs)
            for key in ("comm_free_tables", "hot_rows"):
                if key in r0:
                    run[key] = r0[key]
            if "combine_ms" in r0:
                run["combine_ms_max_over_ranks"] = max(np.median(r["combine_ms"]) for r in rs)
            want_launch = 1 if path == "packed" else 0
            want_calls = 0 if all_cf else 1
            for r in rs:
                if r["launches_per_call"] != want_launch or \
                        r["collectives_per_call"] != want_calls:
                    raise AssertionError(f"{arch} {name}: {r['launches_per_call']} launches, "
                                         f"{r['collectives_per_call']} collectives a call")
                by_name[KERNEL_OF[kind] + "_bf16"]["launches"] += r["launches"]
            rec["runs"][name] = run
            log(f"[sharded] {arch} {name}: max |diff| {run['max_abs_err_vs_fp32']:.3g} vs fp32 "
                f"({run['max_err_over_tol']:.3f} of the rule, {roundings} roundings), "
                f"{run['max_abs_err_vs_single_card']:.3g} vs the single card; "
                f"{run['launches_per_call']} launch(es), {run['collectives_per_call']} "
                f"collective(s) a call, {run['bytes_combined_per_rank']} B combined a rank "
                f"(modeled {run['modeled_bytes']}); gnr {run['gnr_ms_max_over_ranks']:.3f} ms"
                + (f", local partial {run['local_ms_max_over_ranks']:.4f} ms "
                   f"({run['local_ms_alone_max_over_ranks']:.4f} ms a rank alone)"
                   if "local_ms_max_over_ranks" in run else "")
                + (f", {run['comm_free_tables']} comm-free tables"
                   if "comm_free_tables" in run else "")
                + (f", {run['hot_rows']} hot rows" if "hot_rows" in run else "")
                + (f", combine {run['combine_ms_max_over_ranks']:.3f} ms"
                   if "combine_ms_max_over_ranks" in run else "")
                + " (max over 4 ranks sharing one card)")
        record["configs"].append(rec)

    logits = torch.cat([r["dlrm"]["logits"] for r in ranks if r["dlrm"]["coords"]["model"] == 0])
    for r in ranks:
        other = [q for q in ranks if q["dlrm"]["coords"]["data"] == r["dlrm"]["coords"]["data"]]
        if any(not torch.equal(q["dlrm"]["logits"], r["dlrm"]["logits"]) for q in other):
            raise AssertionError("dlrm (2, 2): ranks of one data block differ")
    diff = (logits - single_logits).abs()
    if not torch.isfinite(logits).all() or not torch.allclose(logits, single_logits,
                                                              rtol=DLRM_TOL, atol=DLRM_TOL):
        raise AssertionError(f"dlrm (2, 2): logits differ from the single card by "
                             f"{float(diff.max())}")
    if any(r["dlrm"]["launches"] != 1 or r["dlrm"]["collectives"] != 1 for r in ranks):
        raise AssertionError("dlrm (2, 2): not one launch and one collective a rank")
    by_name["packed_qr_bag"]["launches"] += sum(r["dlrm"]["launches"] for r in ranks)
    record["dlrm_2x2"] = {"arch": "dlrm-qr", "compute_dtype": "float32", "batch": batch,
                          "max_abs_diff_vs_single_card": float(diff.max()), "tol": DLRM_TOL}
    log(f"[sharded] dlrm-qr forward on mesh (2, 2), fp32 compute: logits max |diff| "
        f"{float(diff.max()):.3g} vs the single card (tol {DLRM_TOL})")
    gb = ranks[0]["gloo_bf16"]
    if not (gb["finite"] and gb["within_n_minus_1_roundings"]):
        raise AssertionError(f"gloo bf16: {gb}")
    record["gloo_bf16"] = gb
    record["rank_peak_gib"] = [r["peak_gib"] for r in ranks]
    log(f"[sharded] gloo reduced bf16 CUDA tensors in place ({gb['device']}): "
        f"max |err| {gb['max_abs_err_vs_exact']:.3g} vs the exact sum, within "
        f"{SHARDED_WORLD[1] - 1} bf16 roundings: {gb['within_n_minus_1_roundings']}; the fp32 sum "
        f"rounded once: {gb['equals_fp32_sum_rounded_once']}; the chain of bf16 adds: "
        f"{gb['equals_bf16_chain']}")
    record["phase_s"] = time.perf_counter() - t0
    log(f"[sharded] phase {record['phase_s']:.1f} s (ranks {record['spawn_s']:.1f} s)")
    return record


# ---------------------------------------------------------------------------
# phase 10: DLRM training on a mesh
# ---------------------------------------------------------------------------

MESH_TRAIN_SHAPE = (2, 2)
MESH_TRAIN_STEPS = 2
# dlrm-dense's rows a table on the mesh (phase 7 trains 200,000 on one card):
# the ranks gather its gradients twice and average 26 tables' gradients over
# ``data`` through the host a step (2.2 s a step at 200,000 rows)
MESH_DENSE_ROWS = 50_000
# the steps' losses and gradient norms against the single card
# (tests/test_torch_train.py::test_train_steps_match_repro's bound)
MESH_LOSS_TOL = 2e-2
MESH_OPT = dict(lr=3e-4, warmup_steps=MESH_TRAIN_STEPS, total_steps=MESH_TRAIN_STEPS)
MESH_TIMEOUT_S = 600
# The step-1 gradients are held per leaf to GRAD_TOL against the single
# card's in fp32 compute (the tables packed fp32, K1 / K2 / K3's fp32
# entries, an fp32 combine).  In bf16 the mesh's combine adds two partials
# each rounded to bf16, so a share of the pooled values sits one bf16 step
# from the single card's, and the bf16 head's gradients move by several
# percent of a leaf's scale under such steps (ReLU and rounding flips): the
# bf16 gradients are held per leaf to GRAD_TOL against the single card fed
# the mesh's pooled values (a straight-through of the forward only), and
# their distance from the single card's own is recorded beside it.
# the CLI's elastic drill: full-width dlrm-qr, (2, 2) to step 2, then (4, 1)
# to step 8 from its checkpoint, which holds the full logical arrays (a Q
# table of dlrm-qr: 31,360 padded rows of 128)
MESH_CLI_BATCH = 2048
MESH_CLI_Q_SHAPE = [31360, 128]


def mesh_config(arch, registry):
    """``train_config`` with dlrm-dense at ``MESH_DENSE_ROWS`` rows a table."""
    cfg = train_config(arch, registry)
    if cfg.embedding_kind == "dense":
        cfg = cfg.replace(name=f"dlrm-dense-{MESH_DENSE_ROWS // 1000}k",
                          vocab_per_table=MESH_DENSE_ROWS)
    return cfg


def mesh_batches(cfg, batch: int, dev, synthetic) -> list:
    """The global batches of steps 0.. of a meshed run (seed 0), planted."""
    truth = synthetic.dlrm_truth(cfg, device=dev)
    return [synthetic.dlrm_planted_batch(cfg, truth, batch, seed=0, step=s, device=dev)
            for s in range(MESH_TRAIN_STEPS)]


def gathered_leaves(local, specs, mesh, keep: bool, tree, SH) -> list | None:
    """The full logical leaves of ``local`` (this rank's blocks under
    ``specs``), one all-gather at a time; on the host where ``keep`` (the
    writer), dropped on the other ranks, so no rank holds more than one full
    leaf on the card."""
    out = [] if keep else None
    for x, spec in zip(tree.leaves(local), specs):
        full = SH.gather(x, spec, mesh)
        if keep:
            out.append(full.cpu())
        del full
    return out


def leaf_errors(got: list, want: list, scale_of: list | None = None) -> list:
    """max |got - want| over max |want|, per leaf (both on one device); with
    ``scale_of`` over max |want[scale_of[i]]| (``key_bias_scale``'s leaf)."""
    scales = [max(float(b.abs().max()), 1e-12) for b in want]
    return [float((a.float() - b.float()).abs().max()) / scales[i if scale_of is None
                                                                else scale_of[i]]
            for i, (a, b) in enumerate(zip(got, want))]


def mesh_train_reference(dev, arch, batch, registry, mods) -> dict:
    """The single-card run a meshed one is held to: ``train_config``'s
    params (seed 0) and the global batches, the step-1 gradients of every
    leaf in bf16 and in fp32 compute (moved to the CPU), the losses and
    norms of ``MESH_TRAIN_STEPS`` steps, and the lookup's backward at one
    data rank's batch (batch / 2) by CUDA events: the recompute over as
    many accesses as a rank's, none of them routed to the zero row."""
    from repro_torch import engine as E
    from repro_torch import tree
    from repro_torch.data import synthetic
    from repro_torch.models import dlrm
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step

    cfg = mesh_config(arch, registry)
    params = dlrm.init_dlrm(cfg, seed=0, device=dev)
    batches = mesh_batches(cfg, batch, dev, synthetic)
    loss_fn = train_step.make_dlrm_loss(cfg)
    out = {}
    for key, c in (("grads", cfg), ("grads32", cfg.replace(compute_dtype="float32"))):
        _l, _m, grads = train_step.value_and_grad(train_step.make_dlrm_loss(c), params,
                                                  batches[0])
        out[key] = [g.cpu() for g in tree.leaves(grads)]
        del grads
    half = batch // MESH_TRAIN_SHAPE[0]
    leaves = [t.detach().requires_grad_(True) for t in tree.leaves(params["tables"])]
    eng = E.engine_for(E.EngineSpec.from_bags(dlrm.make_bags(cfg)))
    pooled = eng.lookup(tree.unflatten(params["tables"], leaves), batches[0]["idx"][:half])
    ct = torch.randn(pooled.shape, generator=torch.Generator(dev).manual_seed(11),
                     device=dev).to(pooled.dtype)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for i in range(3):      # a warm-up, the timed call, then one under the profiler
        pooled = eng.lookup(tree.unflatten(params["tables"], leaves), batches[0]["idx"][:half])
        torch.cuda.synchronize()
        if i == 0:
            torch.autograd.grad(pooled, leaves, ct)
        elif i == 1:
            start.record()
            torch.autograd.grad(pooled, leaves, ct)
            end.record()
            torch.cuda.synchronize()
        else:
            out["backward_half_batch_top"] = top_device_ops(
                lambda: torch.autograd.grad(pooled, leaves, ct))
    out["backward_half_batch_ms"] = start.elapsed_time(end)
    del pooled, leaves, ct
    step = train_step.make_train_step(loss_fn, opt.OptConfig(**MESH_OPT))
    state = opt.init(params)
    out["losses"], out["norms"] = [], []
    for b in batches:
        params, state, m = step(params, state, b)
        out["losses"].append(float(m["loss"]))
        out["norms"].append(float(m["grad_norm"]))
    reset_all(mods)
    del params, state, batches
    torch.cuda.empty_cache()
    return out


def top_relu_signs(params, dense, pooled, cfg, dlrm) -> torch.Tensor:
    """The signs of the top MLP's hidden pre-activations (its ReLUs'
    inputs) for these pooled values, ``forward_from_pooled``'s arithmetic."""
    bottom = dlrm._mlp_fwd(params["bottom"], dense, cfg.cdtype, final_linear=False)
    x = torch.cat([bottom, dlrm.interact(bottom.to(cfg.cdtype), pooled.to(cfg.cdtype))], -1)
    signs = []
    for p in params["top"][:-1]:
        x = x.to(cfg.cdtype) @ p["w"].to(cfg.cdtype) + p["b"].to(cfg.cdtype)
        signs.append((x > 0).reshape(-1))
        x = torch.relu(x)
    return torch.cat(signs)


def mesh_pooled_reference(dev, cfg, batch, pooled) -> dict:
    """The single card's step-1 gradients (in ``cfg``'s compute dtype) with
    its forward fed the mesh's pooled values (``pooled``, the ranks' data
    blocks in order) and its own backward (a straight-through of the forward
    only), how far those pooled values are from the single card's own, and
    how many of the top MLP's ReLUs they flip."""
    from repro_torch import engine as E
    from repro_torch import tree
    from repro_torch.data import synthetic
    from repro_torch.models import dlrm
    from repro_torch.train import train_step

    params = dlrm.init_dlrm(cfg, seed=0, device=dev)
    b = mesh_batches(cfg, batch, dev, synthetic)[0]
    eng = E.engine_for(E.EngineSpec.from_bags(dlrm.make_bags(cfg)))
    fed = pooled.to(dev)
    with torch.no_grad():
        own = eng.lookup(params["tables"], b["idx"])
    diff = (own.float() - fed.float()).abs()
    with torch.no_grad():
        flips = top_relu_signs(params, b["dense"], own, cfg, dlrm) != top_relu_signs(
            params, b["dense"], fed, cfg, dlrm)
    out = {"pooled_differ_share": float((diff > 0).float().mean()),
           "pooled_max_abs_diff": float(diff.max()), "top_relu_flips": int(flips.sum()),
           "top_relu_units": int(flips.numel())}
    del own, diff, flips

    def loss_fed(p, bb):
        mine = eng.lookup(p["tables"], bb["idx"])
        logits = dlrm.forward_from_pooled(p, bb["dense"], fed + (mine - mine.detach()), cfg)
        return dlrm.bce_loss(logits, bb["labels"]), {}

    _l, _m, grads = train_step.value_and_grad(loss_fed, params, b)
    out["grads"] = [g.cpu() for g in tree.leaves(grads)]
    del params, b, grads, fed
    torch.cuda.empty_cache()
    return out


def mesh_train_world1(dev, batch, registry, mods, ref: dict) -> tuple[dict, dict]:
    """World 1 over nccl in this process, mesh (1, 1), full-width dlrm-qr:
    the meshed step-1 gradients (``inline_gnr`` -> ``forward_partial``
    under grad, the combine and entry ops over a group of one) against the
    single-card step's (``ref``) within ``GRAD_TOL`` per leaf, whether they
    are bitwise equal, and one meshed step's loss and norm against the
    single card's.  Returns the record and the launches."""
    import datetime

    import torch.distributed as dist

    from repro_torch import tree
    from repro_torch.data import synthetic
    from repro_torch.distributed import collectives
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import mesh as M
    from repro_torch.models import dlrm
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step

    rdv = ROOT / "build" / "mesh_train" / "rdv_world1"
    rdv.parent.mkdir(parents=True, exist_ok=True)
    rdv.unlink(missing_ok=True)
    log("[mesh] 1 rank, mesh (1, 1) over ('data', 'model'), backend nccl, on 1 card "
        "(in process)")
    dist.init_process_group("nccl", init_method=f"file://{rdv}", world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=120))
    try:
        mesh = M.make_mesh((1, 1), ("data", "model"), device=dev)
        cfg = train_config("dlrm-qr", registry)
        params = dlrm.init_dlrm(cfg, seed=0, device=dev)
        specs = SH.tree_specs(params, dlrm.param_axes(cfg), mesh, SH.TRAIN_PARAM_RULES)
        local = SH.shard_tree(params, specs, mesh)
        b = mesh_batches(cfg, batch, dev, synthetic)[0]
        loss_fn = train_step.make_dlrm_loss(cfg)
        reset_all(mods)
        collectives.reset_counts()
        loss, _m, grads = train_step.meshed_grads(loss_fn, local, b, mesh, specs)
        torch.cuda.synchronize()
        got = [SH.gather(g, s, mesh) for g, s in zip(tree.leaves(grads), specs)]
        want = [g.to(dev) for g in ref["grads"]]
        errs = leaf_errors(got, want)
        bitwise = all(torch.equal(a, w) for a, w in zip(got, want))
        sites = {f"{k[0]}/{k[1]}": v[0] for k, v in collectives.SITES.items()}
        del got, want, grads
        step = train_step.make_train_step(loss_fn, opt.OptConfig(**MESH_OPT), mesh=mesh,
                                          specs=specs)
        _p, _s, m = step(local, opt.init(local), b)
        torch.cuda.synchronize()
        del _p, _s
        launched = {k: v for k, v in launches_now(mods).items() if v}
        rec = {"mesh": [1, 1], "backend": "nccl", "arch": cfg.name, "batch": batch,
               "step1_grad_rel_err_max": max(errs), "bitwise_equal_to_single_card": bitwise,
               "loss": float(m["loss"]), "loss_single_card": ref["losses"][0],
               "grad_norm": float(m["grad_norm"]), "grad_norm_single_card": ref["norms"][0],
               "collectives_of_the_gradient": sites}
        if not max(errs) <= GRAD_TOL:
            raise AssertionError(f"world 1 nccl: step-1 gradients {max(errs)} of scale")
        for key in ("loss", "grad_norm"):
            if not abs(rec[key] - rec[key + "_single_card"]) <= MESH_LOSS_TOL * (
                    1 + abs(rec[key + "_single_card"])):
                raise AssertionError(f"world 1 nccl: {key} {rec}")
        if launched.get("packed_qr_bag") != 2 or sum(launched.values()) != 2:
            raise AssertionError(f"world 1 nccl: launches {launched} for two forwards")
        log(f"[mesh-train] world 1 nccl {cfg.name} batch {batch}: step-1 gradients vs the "
            f"single card {max(errs):.3g} of scale (bitwise {bitwise}), loss {rec['loss']:.6f} "
            f"vs {rec['loss_single_card']:.6f}, grad norm {rec['grad_norm']:.6f} vs "
            f"{rec['grad_norm_single_card']:.6f}; collectives {sites}")
        del local, params, b
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    return rec, launched


def _split_step(local, state, b, loss_fn, opt_cfg, mesh, specs, opt, train_step, tree):
    """One meshed step (``make_train_step(mesh=)``'s: ``meshed_grads`` and
    the update) cut into forward (``meshed_loss``), backward (the entry ops'
    psum and FSDP's reduce-scatters inside), the data-axis gradient mean
    (``data_mean``) and the update (the norm's psum inside).  Returns the
    new params, state and metrics, the data-averaged gradients, and host ms
    of each part with the card synchronised between them (gloo crosses the
    host) and CUDA-event ms of each."""
    leaves = [p.detach().requires_grad_(True) for p in tree.leaves(local)]
    live = tree.unflatten(local, leaves)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    host = []
    torch.cuda.synchronize()
    host.append(time.perf_counter())
    ev[0].record()
    with torch.enable_grad():
        loss, _ = train_step.meshed_loss(loss_fn, mesh, specs)(live, b)
        ev[1].record()
        torch.cuda.synchronize()
        host.append(time.perf_counter())
        grads = torch.autograd.grad(loss, leaves)
    ev[2].record()
    torch.cuda.synchronize()
    host.append(time.perf_counter())
    grads, _loss = train_step.data_mean(tree.unflatten(local, list(grads)), loss.detach(), mesh,
                                        specs)
    ev[3].record()
    torch.cuda.synchronize()
    host.append(time.perf_counter())
    params, state, m = opt.update(local, grads, state, opt_cfg, mesh=mesh, specs=specs)
    ev[4].record()
    torch.cuda.synchronize()
    host.append(time.perf_counter())
    names = ("forward", "backward", "grad_reduce", "update")
    return (params, state, {**m, "loss": _loss}, grads,
            {n: (host[i + 1] - host[i]) * 1e3 for i, n in enumerate(names)},
            {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)})


def _zero_row_share(cfg, idx, mesh, SE, hashing, tt_embedding, dlrm) -> float:
    """The share of this rank's big-subtable accesses that route to the zero
    row (rows another rank owns)."""
    emb = dlrm.make_bags(cfg)[0].emb
    if cfg.embedding_kind == "qr":
        big, _ = hashing.qr_decompose(idx, cfg.qr_collision)
    elif cfg.embedding_kind == "tt":
        _i1, big, _i3 = tt_embedding.tt_decompose(idx, emb.tt_spec)
    else:
        big = idx
    rows = SE.ShardPlan(emb, mesh.shape["model"]).rows_per_shard
    return float((big.long() // rows != mesh.axis_index("model")).float().mean())


def top_device_ops(run, n: int = 5) -> list:
    """``run()`` traced by ``torch.profiler``: its ``n`` device operations
    (kernels, copies) with the most device time, ``[name, ms]``, and last
    ``["device busy", ms]``, the sum over all of them."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    rows = device_rows(prof)
    top = sorted(rows, key=lambda r: -r[1])[:n] + [("device busy", sum(t for _k, t in rows))]
    return [[k[:80], round(t, 3)] for k, t in top]


def local_backward_alone(tables, idx, bags, plans, mesh, SE) -> tuple:
    """This rank's packed local partial's backward (the zero rows left out
    of the recompute, as the step runs it): CUDA-event ms of one after a
    warm-up (each on its own forward), then the top device operations of
    another under the profiler."""
    def backward():
        leaves = [v.detach().requires_grad_(True) for t in tables for v in t.values()]
        it = iter(leaves)
        live = [{k: next(it) for k in t} for t in tables]
        with torch.enable_grad():
            parts = SE.packed_local_partial(live, idx, bags, plans, mesh=mesh)
        ct = torch.randn(parts.shape, generator=torch.Generator(parts.device).manual_seed(11),
                         device=parts.device).to(parts.dtype)
        torch.cuda.synchronize()
        return lambda: torch.autograd.grad(parts, leaves, ct)

    backward()()
    grad = backward()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    grad()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), top_device_ops(backward())


def mesh_train_rank(mesh, batch: int) -> dict:
    """Phase 10 on one rank of the (2, 2) gloo mesh on the card: per config
    the params (seed 0) placed by their logical axes, this rank's ``data``
    block of the global batches, the step-1 gradients in fp32 compute
    (data-averaged, gathered to the logical shapes; rank (0, 0) returns
    them), the bf16 pooled values of step 1 (the ranks at ``model`` 0
    return their data block's), then ``MESH_TRAIN_STEPS`` steps of
    ``make_train_step(mesh=)``'s (host ms of each, launches and
    collectives; the first's bf16 gradients, gathered; the last split),
    peak memory, and rank (0, 0)'s local partial backward alone on the
    card."""
    import torch.distributed as dist

    from repro_torch import tree
    from repro_torch.configs import registry
    from repro_torch.core import hashing, tt_embedding
    from repro_torch.core import sharded_embedding as SE
    from repro_torch.data import synthetic
    from repro_torch.distributed import collectives
    from repro_torch.distributed import sharding as SH
    from repro_torch.kernels import packed_gather as pg
    from repro_torch.kernels import tt_gather as tg
    from repro_torch.models import dlrm
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = mesh.device
    writer = not any(mesh.coords.values())
    launches = lambda: sum(pg.LAUNCHES.values()) + sum(tg.LAUNCHES.values())
    res = {"coords": dict(mesh.coords), "configs": {}}
    for arch in ("dlrm-qr", "dlrm-tt", "dlrm-dense"):
        cfg = mesh_config(arch, registry)
        bags = dlrm.make_bags(cfg)
        params = dlrm.init_dlrm(cfg, seed=0, device=dev)
        specs = SH.tree_specs(params, dlrm.param_axes(cfg), mesh, SH.TRAIN_PARAM_RULES)
        local = SH.shard_tree(params, specs, mesh)
        del params
        batches = [synthetic.data_block(b, mesh) for b in mesh_batches(cfg, batch, dev,
                                                                       synthetic)]
        torch.cuda.empty_cache()
        loss_fn = train_step.make_dlrm_loss(cfg)
        opt_cfg = opt.OptConfig(**MESH_OPT)
        rec = {"local_batch": int(batches[0]["idx"].shape[0]),
               "paths": [path for path, _leaf in tree.leaves_with_paths(local)],
               "zero_row_share": _zero_row_share(cfg, batches[0]["idx"], mesh, SE, hashing,
                                                 tt_embedding, dlrm)}

        # step-1 gradients in fp32 compute, data-averaged and gathered
        fn32 = train_step.make_dlrm_loss(cfg.replace(compute_dtype="float32"))
        _loss, _m, grads = train_step.meshed_grads(fn32, local, batches[0], mesh, specs)
        rec["grads32"] = gathered_leaves(grads, specs, mesh, writer, tree, SH)
        del grads
        # the pooled values the bf16 and the fp32 step's heads see, this data
        # block's (every rank of the block takes part in the combine)
        cfg32 = cfg.replace(compute_dtype="float32")
        for key, c in (("pooled", cfg), ("pooled32", cfg32)):
            with torch.no_grad(), SH.use_rules(mesh, SH.DEFAULT_RULES):
                pooled = dlrm._gnr(local["tables"], batches[0]["idx"], dlrm.make_bags(c), c)
            if mesh.axis_index("model") == 0:
                rec[key] = pooled.cpu()
            del pooled
        torch.cuda.empty_cache()

        # MESH_TRAIN_STEPS steps: the first and the last split (both written
        # out as make_train_step(mesh=) runs them; the first's data-averaged
        # gradients are the bf16 step-1 check's), the others whole
        step = train_step.make_train_step(loss_fn, opt_cfg, mesh=mesh, specs=specs)
        p, state = local, opt.init(local)
        torch.cuda.reset_peak_memory_stats(dev)
        collectives.reset_counts()
        before = launches()
        rec["losses"], rec["norms"], rec["step_ms"] = [], [], []
        for i, b in enumerate(batches):
            torch.cuda.synchronize()
            t = time.perf_counter()
            if i in (0, len(batches) - 1):
                p, state, m, grads, host, event = _split_step(
                    p, state, b, loss_fn, opt_cfg, mesh, specs, opt, train_step, tree)
            else:
                p, state, m = step(p, state, b)
            torch.cuda.synchronize()
            rec["step_ms"].append((time.perf_counter() - t) * 1e3)
            rec["losses"].append(float(m["loss"]))
            rec["norms"].append(float(m["grad_norm"]))
            if i == 0:      # the gather's all_gather calls count under their own site
                rec["grads"] = gathered_leaves(grads, specs, mesh, writer, tree, SH)
            elif i == len(batches) - 1:
                rec["split_host_ms"], rec["split_event_ms"] = host, event
            if i in (0, len(batches) - 1):
                del grads
        rec["launches"] = launches() - before
        rec["sites"] = {f"{k[0]}/{k[1]}": list(v) for k, v in collectives.SITES.items()
                        if k[0] != "all_gather"}
        rec["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
        del state, p
        torch.cuda.empty_cache()

        # the local partial's backward with this rank alone on the card, the
        # others waiting at the barrier: the recompute that leaves the zero
        # rows out (what the step runs), then the full one over every access
        # (the backward before the zero rows became sinks), each timed by CUDA
        # events and traced by the profiler (top device operations)
        dist.barrier()
        if writer:
            plans = [SE.ShardPlan(bag.emb, mesh.shape["model"]) for bag in bags]
            ms, top = local_backward_alone(local["tables"], batches[0]["idx"], bags, plans,
                                           mesh, SE)
            rec["local_backward_alone_ms"], rec["local_backward_alone_top"] = ms, top
        dist.barrier()
        res["configs"][cfg.name] = rec
        del local, batches
        torch.cuda.empty_cache()
    return res


def mesh_train_phase(dev, batch, by_name, mods) -> dict:
    """Phase 10: DLRM training on a mesh.  The single-card references; world
    1 over nccl in this process; four gloo ranks on the card
    (``MESH_TRAIN_SHAPE``) train every config, held per leaf to
    ``GRAD_TOL`` at step 1 (fp32 compute against the single card, bf16
    against the single card fed the mesh's pooled values) and to
    ``MESH_LOSS_TOL`` on the losses and norms, one packed launch a rank a
    forward, one combine, the entry psums, one data mean and one norm a
    step (the CLI's elastic drill runs in phase 17, ``cli_phase``).  The
    ranks' launches add to the bf16 rows of K1 / K2 / K3.  Returns the ``{"mesh_training": ...}``
    record."""
    from repro_torch.configs import registry
    from repro_torch.launch import mesh as M

    t0 = time.perf_counter()
    archs = ("dlrm-qr", "dlrm-tt", "dlrm-dense")
    refs = {arch: mesh_train_reference(dev, arch, batch, registry, mods) for arch in archs}
    record = {"mesh": list(MESH_TRAIN_SHAPE), "batch": batch, "steps": MESH_TRAIN_STEPS,
              "configs": []}
    record["world1"], n = mesh_train_world1(dev, batch, registry, mods, refs["dlrm-qr"])
    for name, k in n.items():
        by_name[name + "_bf16"]["launches"] += k
    log(f"[mesh-train] references and world 1 in {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[mesh-train] parent before the ranks: "
        f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB allocated, "
        f"{torch.cuda.memory_reserved(dev) / 2**30:.2f} GiB reserved")
    t1 = time.perf_counter()
    # four ranks share the card's 80 GB: let each rank's allocator grow its
    # segments in place rather than strand reserved blocks
    alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        ranks = M.spawn(mesh_train_rank, MESH_TRAIN_SHAPE, args=(batch,), device="cuda",
                        backend="gloo", init_file=ROOT / "build" / "mesh_train" / "rdv",
                        timeout_s=MESH_TIMEOUT_S)
    finally:
        if alloc is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc
    record["spawn_s"] = time.perf_counter() - t1
    writer = next(r for r in ranks if not any(r["coords"].values()))
    nsh = MESH_TRAIN_SHAPE[1]
    faults = []
    for arch in archs:
        cfg = mesh_config(arch, registry)
        kind = cfg.embedding_kind
        ref = refs[arch]
        rs = [r["configs"][cfg.name] for r in ranks]
        mine = writer["configs"][cfg.name]
        paths = mine["paths"]
        errs32 = leaf_errors(mine["grads32"], ref["grads32"])
        if not max(errs32) <= GRAD_TOL:
            worst = int(np.argmax(errs32))
            faults.append(f"{cfg.name} (2, 2): fp32 step-1 gradient {paths[worst]} "
                          f"{errs32[worst]} of scale")
        # the fp32 reading: the single card fed the mesh's fp32 pooled values
        # (near 1e-5 of scale from the mesh: the forward's order is the gap's
        # cause; recorded, held only by GRAD_TOL above)
        pooled32 = torch.cat([r["configs"][cfg.name].pop("pooled32") for r in ranks
                              if r["coords"]["model"] == 0])
        st32 = mesh_pooled_reference(dev, cfg.replace(compute_dtype="float32"), batch,
                                     pooled32)
        errs32_st = leaf_errors(st32["grads"], ref["grads32"])
        errs32_mesh_st = leaf_errors(mine["grads32"], st32.pop("grads"))
        del pooled32
        pooled = torch.cat([r["configs"][cfg.name]["pooled"] for r in ranks
                            if r["coords"]["model"] == 0])
        st = mesh_pooled_reference(dev, cfg, batch, pooled)
        errs = leaf_errors(mine["grads"], ref["grads"])
        errs_st = leaf_errors(st["grads"], ref["grads"])
        errs_mesh_st = leaf_errors(mine["grads"], st["grads"])
        del st["grads"]
        if not max(errs_mesh_st) <= GRAD_TOL:
            worst = int(np.argmax(errs_mesh_st))
            faults.append(f"{cfg.name} (2, 2): bf16 step-1 gradient {paths[worst]} "
                          f"{errs_mesh_st[worst]} of scale from the single card fed the "
                          f"mesh's pooled values")
        worst = lambda e: f"{max(e):.3g} ({paths[int(np.argmax(e))]})"
        log(f"[mesh-train] {cfg.name} (2, 2) step-1 gradients, worst leaf's share of its "
            f"scale: fp32 compute vs the single card {worst(errs32)} (held to {GRAD_TOL}); "
            f"bf16 vs the single card {worst(errs)}, the single card fed the mesh's pooled "
            f"values vs itself {worst(errs_st)}, the mesh vs that {worst(errs_mesh_st)} "
            f"(held to {GRAD_TOL}); "
            f"bf16 pooled values: {st['pooled_differ_share']:.4f} of them differ from the "
            f"single card's, by at most {st['pooled_max_abs_diff']:.3g}, flipping "
            f"{st['top_relu_flips']} of {st['top_relu_units']} top-MLP ReLUs")
        log(f"[mesh-train] {cfg.name} (2, 2) fp32 reading: the single card fed the mesh's "
            f"fp32 pooled values vs itself {worst(errs32_st)}, the mesh vs that "
            f"{worst(errs32_mesh_st)}; fp32 pooled values: {st32['pooled_differ_share']:.4f} "
            f"of them differ, by at most {st32['pooled_max_abs_diff']:.3g}, flipping "
            f"{st32['top_relu_flips']} of {st32['top_relu_units']} top-MLP ReLUs")
        for r in rs:
            for key, want in (("losses", ref["losses"]), ("norms", ref["norms"])):
                if not np.allclose(r[key], want, rtol=MESH_LOSS_TOL, atol=MESH_LOSS_TOL):
                    faults.append(f"{cfg.name} (2, 2) {key} {r[key]} vs {want}")
            if r["launches"] != MESH_TRAIN_STEPS:
                faults.append(f"{cfg.name} (2, 2): {r['launches']} launches in "
                              f"{MESH_TRAIN_STEPS} steps")
            want_sites = {"combine/model": MESH_TRAIN_STEPS, "grad_mean/data": MESH_TRAIN_STEPS,
                          "norm/model": MESH_TRAIN_STEPS}
            if kind in ("qr", "tt"):
                want_sites["entry/model"] = MESH_TRAIN_STEPS
            if {k: v[0] for k, v in r["sites"].items()} != want_sites:
                faults.append(f"{cfg.name} (2, 2) collectives {r['sites']}")
        by_name[KERNEL_OF[kind] + "_bf16"]["launches"] += sum(r["launches"] for r in rs)
        per_axis = {}
        for (site_axis, (calls, nbytes)) in rs[0]["sites"].items():
            axis = site_axis.split("/")[1]
            per_axis[axis] = per_axis.get(axis, 0) + nbytes // MESH_TRAIN_STEPS
        rec = {"arch": cfg.name, "rows": cfg.vocab_per_table, "backend": "gloo",
               "step1_grad_fp32_rel_err_max": max(errs32),
               "step1_grad_fp32_rel_err": dict(zip(paths, errs32)),
               "step1_grad_bf16_rel_err": dict(zip(paths, errs)),
               "step1_grad_bf16_single_fed_mesh_pooled_rel_err": dict(zip(paths, errs_st)),
               "step1_grad_bf16_mesh_vs_single_fed_mesh_pooled_rel_err": dict(
                   zip(paths, errs_mesh_st)), **st,
               "step1_grad_fp32_single_fed_mesh_pooled_rel_err_max": max(errs32_st),
               "step1_grad_fp32_mesh_vs_single_fed_mesh_pooled_rel_err_max": max(
                   errs32_mesh_st),
               "fp32_pooled": {k: st32[k] for k in ("pooled_differ_share", "pooled_max_abs_diff",
                                                    "top_relu_flips", "top_relu_units")},
               "losses": rs[0]["losses"],
               "losses_single_card": ref["losses"], "grad_norms": rs[0]["norms"],
               "grad_norms_single_card": ref["norms"],
               "ms_per_step_max_over_ranks": max(float(np.mean(r["step_ms"])) for r in rs),
               "step_ms_rank0": rs[0]["step_ms"],
               "split_host_ms_max_over_ranks": {k: max(r["split_host_ms"][k] for r in rs)
                                                for k in rs[0]["split_host_ms"]},
               "split_event_ms_max_over_ranks": {k: max(r["split_event_ms"][k] for r in rs)
                                                 for k in rs[0]["split_event_ms"]},
               "bytes_all_reduced_per_rank_per_step": per_axis,
               "collectives_per_step": {k: v[0] // MESH_TRAIN_STEPS
                                        for k, v in rs[0]["sites"].items()},
               "launches_per_rank_per_step": rs[0]["launches"] // MESH_TRAIN_STEPS,
               "peak_gib_max_over_ranks": max(r["peak_gib"] for r in rs),
               "local_backward_alone_ms": mine["local_backward_alone_ms"],
               "local_backward_top_device_ops": {"sinks": mine["local_backward_alone_top"]},
               "single_card_backward_half_batch_ms": ref["backward_half_batch_ms"],
               "zero_row_share": [r["zero_row_share"] for r in rs],
               "local_batch": rs[0]["local_batch"]}
        record["configs"].append(rec)
        split = rec["split_host_ms_max_over_ranks"]
        log(f"[mesh-train] {cfg.name} mesh {MESH_TRAIN_SHAPE} gloo, batch {batch} "
            f"({rec['local_batch']} a data rank): losses "
            f"{', '.join(f'{x:.4f}' for x in rec['losses'])} vs "
            f"{', '.join(f'{x:.4f}' for x in ref['losses'])}; grad norms "
            f"{', '.join(f'{x:.3f}' for x in rec['grad_norms'])} vs "
            f"{', '.join(f'{x:.3f}' for x in ref['norms'])}; "
            f"{rec['ms_per_step_max_over_ranks']:.1f} ms a step (max over ranks; forward "
            f"{split['forward']:.1f}, backward {split['backward']:.1f}, gradient mean "
            f"{split['grad_reduce']:.1f}, update {split['update']:.1f} ms); all-reduced a rank "
            f"a step {per_axis} B; collectives a step {rec['collectives_per_step']}; "
            f"{rec['launches_per_rank_per_step']} launch a rank a step; peak "
            f"{rec['peak_gib_max_over_ranks']:.2f} GiB a rank; local backward alone "
            f"{rec['local_backward_alone_ms']:.1f} ms ({np.mean(rec['zero_row_share']):.3f} "
            f"of its big-subtable accesses and {(nsh - 1) / nsh if kind == 'qr' else 0:.2f} of "
            f"its R accesses to the zero row, left out of the recompute) vs the "
            f"single card's {rec['single_card_backward_half_batch_ms']:.1f} ms at batch "
            f"{rec['local_batch']}")
        rec["local_backward_top_device_ops"]["single card"] = ref["backward_half_batch_top"]
        for name, top in rec["local_backward_top_device_ops"].items():
            log(f"[mesh-train] {cfg.name} local backward ({name} recompute), top device "
                f"operations: " + ", ".join(f"{k} {t:.2f} ms" for k, t in top))
    del ranks, refs
    if faults:
        raise AssertionError("; ".join(faults))
    record["phase_s"] = time.perf_counter() - t0
    log(f"[mesh-train] phase {record['phase_s']:.1f} s (ranks {record['spawn_s']:.1f} s)")
    return record


# ---------------------------------------------------------------------------
# phase 11: the dense transformer served (LM side's first path)
# ---------------------------------------------------------------------------

LM_ARCHS = ("qwen2-1.5b", "granite-34b", "chatglm3-6b", "minitron-4b")
LM_MAIN = "qwen2-1.5b"
LM_REF_TOL = 1e-4         # card vs CPU, fp32 compute, TF32 off (tests/test_torch_gpu.py)
LM_BF16_SCALE = 2e-2      # card vs CPU in bf16 compute, of the logits' scale
LM_CONSIST_TOL = 5e-5     # repro's decode-vs-train bound (tests/test_models_consistency.py)
LM_CONSIST_MAIN = (2, 256)                 # batch, sequence at qwen2-1.5b's full width
LM_CONSIST_OTHER = (1, 128)
LM_K9_SEQ = 4096          # one layer's attention on the model's own q/k/v
LM_HEADROOM = 6 << 30     # device bytes left free when a batch or a depth is sized
# the dry run predicts the bytes allocated; the caching allocator reserves
# more around them.  At the peak of a full-width prefill in its default
# segments the reserved bytes were 1.16-1.20 x the allocated at batch 2 and
# 1.23 x when a batch sized on allocated bytes alone ran out of memory
# (NVIDIA H100 80GB HBM3, 700 W; the second with 13.27 GiB reserved but
# unallocated): a call is sized to the free memory less LM_HEADROOM over this
LM_RESERVE = 1.3
LM_K8_CHUNK = 1 << 16     # lookups held against the plain sum at a time
LM_CLI = ("--batch", "8", "--prompt-len", "512", "--max-new", "32")
LM_GEN = (4, 512, 16)                      # batch, prompt, new tokens (the other archs)
LM_DECODE_REPS = 3


def lm_config(arch: str):
    """An arch's full-width config (a CPU rehearsal patches this)."""
    from repro_torch.configs import registry

    return registry.get(arch).config


def take_launches(mods, totals: dict) -> dict:
    """The launches since the last reset, added to ``totals``; then reset."""
    now = {k: v for k, v in launches_now(mods).items() if v}
    for k, v in now.items():
        totals[k] = totals.get(k, 0) + v
    reset_all(mods)
    return now


def lm_ref_phase(dev, mods, totals: dict) -> dict:
    """``[lm-ref]``: each dense smoke config with a dense and a QR
    (collision 8) vocabulary on the card and on the CPU, the same weights
    (built on the CPU and copied) and tokens: in fp32 compute
    ``forward_train``, prefill and decode logits within ``LM_REF_TOL`` and
    the greedy tokens equal; in bf16 compute ``forward_train`` within
    ``LM_BF16_SCALE`` of scale; K9 launched once a layer a forward, K8 once
    a QR ``embed_tokens``."""
    from repro_torch.models import transformer as T
    from repro_torch.train import serve_step as S
    from repro_torch.tree import tree_map
    from repro_torch.configs import registry

    fam = S.serve_family("transformer")
    out = {}
    for arch in LM_ARCHS:
        for vocab in ("dense", "qr"):
            cfg = registry.get(arch).smoke.replace(embedding_kind=vocab, qr_collision=8,
                                                   compute_dtype="float32")
            cpu, _ = T.init_lm(cfg, seed=0, device="cpu")
            card = tree_map(lambda a: a.to(dev), cpu)
            toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (2, 12))
                                    .astype(np.int32))
            errs = {}
            with torch.inference_mode():
                reset_all(mods)
                got = T.forward_train(card, toks.to(dev), cfg)
                torch.cuda.synchronize()
                n = take_launches(mods, totals)
                want_n = {"flash_fwd": cfg.num_layers, **({"qr_gather": 1} if vocab == "qr"
                                                          else {})}
                if n != want_n:
                    raise AssertionError(f"[lm-ref] {arch} {vocab}: launches {n}, not {want_n}")
                pairs = [("train", got, T.forward_train(cpu, toks, cfg))]
                lg, cache = T.forward_prefill(card, toks[:, :11].to(dev), cfg, 16)
                clg, ccache = T.forward_prefill(cpu, toks[:, :11], cfg, 16)
                pairs += [("prefill", lg, clg), ("cache_k", cache["k"], ccache["k"])]
                lg2, _ = T.forward_decode(card, toks[:, 11:].to(dev), cache, 11, cfg)
                clg2, _ = T.forward_decode(cpu, toks[:, 11:], ccache, 11, cfg)
                pairs.append(("decode", lg2, clg2))
                for name, a, b in pairs:
                    d = (a.cpu().float() - b.float()).abs()
                    errs[name] = float(d.max())
                    if not bool((d <= LM_REF_TOL + LM_REF_TOL * b.float().abs()).all()):
                        raise AssertionError(f"[lm-ref] {arch} {vocab} {name}: card vs CPU "
                                             f"{errs[name]}")
                b16 = cfg.replace(compute_dtype="bfloat16")
                a, b = T.forward_train(card, toks.to(dev), b16), T.forward_train(cpu, toks, b16)
                errs["train_bf16_share"] = float((a.cpu().float() - b.float()).abs().max()) / float(
                    b.float().abs().max())
                if not errs["train_bf16_share"] <= LM_BF16_SCALE:
                    raise AssertionError(f"[lm-ref] {arch} {vocab} bf16: {errs}")
            batch = {"tokens": toks[:, :8]}
            tok_card = S.greedy_generate(fam, card, {"tokens": toks[:, :8].to(dev)}, cfg,
                                         max_new=4, max_len=12).cpu()
            tok_cpu = S.greedy_generate(fam, cpu, batch, cfg, max_new=4, max_len=12)
            if not torch.equal(tok_card, tok_cpu):
                raise AssertionError(f"[lm-ref] {arch} {vocab}: greedy tokens {tok_card} vs "
                                     f"{tok_cpu}")
            take_launches(mods, totals)
            out[f"{arch}/{vocab}"] = errs
            log(f"[lm-ref] {cfg.name} {vocab} vocab: card vs CPU max |diff| "
                + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
                + f"; launches a forward {n}; greedy tokens equal")
    return out


def lm_consistency(params, cfg, batch: int, seq: int, dev) -> dict:
    """``repro``'s decode-vs-train test on the card (fp32 compute): prefill
    of seq - 1 tokens and one decode step reproduce ``forward_train``'s
    logits at the last two positions within ``LM_CONSIST_TOL``."""
    from repro_torch.models import transformer as T

    g = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (batch, seq), generator=g, device=dev, dtype=torch.int32)
    with torch.inference_mode():
        full = T.forward_train(params, toks, cfg)
        lg, cache = T.forward_prefill(params, toks[:, :seq - 1], cfg, seq)
        lg2, _ = T.forward_decode(params, toks[:, seq - 1:], cache, seq - 1, cfg)
        out = {}
        for name, a, b in (("prefill", lg[:, 0], full[:, seq - 2]),
                           ("decode", lg2[:, 0], full[:, seq - 1])):
            d = (a - b).abs()
            out[name] = float(d.max())
            if not bool((d <= LM_CONSIST_TOL + LM_CONSIST_TOL * b.abs()).all()):
                raise AssertionError(f"[lm] {cfg.name} consistency {name}: {out[name]}")
        out["logit_scale"] = float(full.abs().max())
    del full, cache
    return out


def hold_attention(q, k, v, out, causal: bool = True) -> dict:
    """K9's ``out`` on (q, k, v) against the plain blockwise
    ``layers.flash_attention`` on their fp32 widening (``causal``): fp32 to
    ``ERR_TOL``, bf16 per element within one rounding (phase 6's rule)."""
    from repro_torch.models import layers

    with torch.inference_mode():
        plain = layers.flash_attention(q.float(), k.float(), v.float(), causal=causal)
    if out.dtype == torch.float32:
        err = float((out - plain).abs().max())
        rec = {"max_abs_err": err, "tolerance": ERR_TOL}
        ok = err <= ERR_TOL
    else:
        ratio, err = one_rounding(out, plain)
        rec = {"max_abs_err": err, "rounding_ratio": ratio, "tolerance": ROUND_RULE}
        ok = ratio <= 1.0
    rec["shape"] = list(q.shape) + [k.shape[1]]
    rec["ok"] = ok
    return rec


def hold_qr_rows(q, r, q_idx, r_idx, out) -> dict:
    """K8's ``out`` against ``q[q_idx] + r[r_idx]``, ``LM_K8_CHUNK`` lookups
    at a time: a bf16 row per element within one rounding of the fp32 sum
    (``one_rounding``), an fp32 row to ``ERR_TOL``; also whether it is
    bitwise the sum in the tables' dtype (one rounding of an exact sum)."""
    qi, ri = q_idx.reshape(-1).long(), r_idx.reshape(-1).long()
    rows = out.reshape(qi.numel(), -1)
    q32, r32 = q.float(), r.float()
    worst, err, bitwise = 0.0, 0.0, True
    for lo in range(0, qi.numel(), LM_K8_CHUNK):
        part = slice(lo, lo + LM_K8_CHUNK)
        got = rows[part]
        bitwise &= torch.equal(got, q[qi[part]] + r[ri[part]])
        plain = q32[qi[part]] + r32[ri[part]]
        if got.dtype == torch.float32:
            err = max(err, float((got - plain).abs().max()))
        else:
            ratio, e = one_rounding(got, plain)
            worst, err = max(worst, ratio), max(err, e)
    ok = err <= ERR_TOL if out.dtype == torch.float32 else worst <= 1.0
    rec = {"lookups": qi.numel(), "table": list(q.shape), "dtype": str(out.dtype),
           "max_abs_err": err, "bitwise": bitwise, "ok": ok}
    if out.dtype != torch.float32:
        rec.update(rounding_ratio=worst, tolerance=ROUND_RULE)
    else:
        rec["tolerance"] = ERR_TOL
    return rec


@contextlib.contextmanager
def kept_calls(ops, name, keep):
    """While the context is open, every call of ``ops.<name>`` also hands
    its positional arguments and its output to ``keep``, after the call."""
    saved = getattr(ops, name)

    def call(*a, **kw):
        out = saved(*a, **kw)
        keep(a, out)
        return out

    setattr(ops, name, call)
    try:
        yield
    finally:
        setattr(ops, name, saved)


@contextlib.contextmanager
def kept_model_path(ops, kept: dict):
    """While open: layer 0's K9 q/k/v and output (the last batch row, the
    one at the largest offsets, copied) into ``kept["k9"]``, and every K8
    call's inputs and output into the list ``kept["k8"]``."""
    def k9(a, out):
        if "k9" not in kept:
            kept["k9"] = tuple(t[-1:].detach().clone() for t in (*a[:3], out))

    def k8(a, out):
        kept.setdefault("k8", []).append(tuple(t.detach() for t in (*a[:4], out)))

    with kept_calls(ops, "flash_attention_fused", k9), kept_calls(ops, "qr_lookup", k8):
        yield kept


def hold_kept(kept: dict, where: str) -> dict:
    """``kept_model_path``'s captures held against their plain versions:
    K9's by ``hold_attention``, each K8 call's by ``hold_qr_rows``."""
    rec = {}
    if "k9" in kept:
        rec["k9"] = hold_attention(*kept["k9"])
    if "k8" in kept:
        calls = [hold_qr_rows(*c) for c in kept["k8"]]
        rec["k8"] = {**max(calls, key=lambda c: c.get("rounding_ratio", c["max_abs_err"])),
                     "calls": len(calls), "all_bitwise": all(c["bitwise"] for c in calls),
                     "ok": all(c["ok"] for c in calls)}
    bad = {k: v for k, v in rec.items() if not v["ok"]}
    if bad:
        raise AssertionError(f"[lm] {where}: kernel vs plain on the main path {bad}")
    return rec


def held_text(held: dict) -> str:
    """``hold_kept``'s record as one line."""
    parts = []
    if "k9" in held:
        parts.append(f"K9 on layer 0's q/k/v {held['k9']['shape']} (last batch row) "
                     f"{fmt_err(held['k9'])}")
    if "k8" in held:
        k8 = held["k8"]
        parts.append(f"K8 on {k8['lookups']} lookups of a {k8['table']} {k8['dtype']} table "
                     f"x {k8['calls']} call(s): {fmt_err(k8)}, bitwise the sum in the tables' "
                     f"dtype: {k8['all_bitwise']}")
    return "; ".join(parts)


def lm_k9_check(params, cfg, dev, kind: str = "transformer") -> dict:
    """Layer 0's (a zamba2 hybrid's site 0's) attention of a batch-1
    prefill at ``LM_K9_SEQ`` tokens through ``kind``'s serve family: K9's
    output on the model's own q/k/v by ``hold_attention``."""
    from repro_torch.kernels import ops
    from repro_torch.train import serve_step as S

    seen = []
    g = torch.Generator(device=dev).manual_seed(2)
    toks = torch.randint(0, cfg.vocab, (1, LM_K9_SEQ), generator=g, device=dev,
                         dtype=torch.int32)
    with kept_calls(ops, "flash_attention_fused",
                    lambda a, out: seen or seen.append((*a[:3], out))):
        with torch.inference_mode():
            S.serve_family(kind).prefill(params, {"tokens": toks}, cfg, LM_K9_SEQ)
    rec = hold_attention(*seen[0])
    if not rec["ok"]:
        raise AssertionError(f"[lm] {cfg.name} K9 on the model path: {rec}")
    return rec


def layer_weights(cfg, *, total: bool = False) -> int:
    """One layer's projection weights (q, k, v, o and the MLP's); of an MoE
    layer the router and the ``top_k`` experts a token runs through (the
    active weights), or with ``total`` all ``num_experts``."""
    d, hd, h, kh, f = cfg.d_model, cfg.head_dim_, cfg.num_heads, cfg.kv_heads, cfg.d_ff
    attn = d * (h + 2 * kh) * hd + h * hd * d
    if cfg.num_experts:
        return attn + d * cfg.num_experts + (
            cfg.num_experts if total else cfg.top_k) * 3 * d * f
    return attn + (3 if cfg.activation == "silu" else 2) * d * f


@contextlib.contextmanager
def moe_watch(cfg):
    """While open, for an MoE ``cfg``: a pair of CUDA events around every
    ``moe.apply_moe`` call (``rec["marks"]``), and each layer call's dropped
    assignments (of the assignments to this rank's experts, those routed to
    the trash row; device counts summed by ``moe_drops``) beside those
    assignments; for a dense ``cfg`` nothing."""
    from repro_torch.models import moe as moe_mod

    rec = {"marks": [], "dropped": [], "mine": []}
    if not cfg.num_experts:
        yield rec
        return
    saved = moe_mod.apply_moe, moe_mod.slots

    def apply(*a, **kw):
        e = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        e[0].record()
        out = saved[0](*a, **kw)
        e[1].record()
        rec["marks"].append(e)
        return out

    def slots(ids, e_start, e_loc, capacity):
        out = saved[1](ids, e_start, e_loc, capacity)
        mine = ((ids >= e_start) & (ids < e_start + e_loc)).sum()
        rec["dropped"].append((out == e_loc * capacity).sum() - (ids.numel() - mine))
        rec["mine"].append(mine)
        return out

    moe_mod.apply_moe, moe_mod.slots = apply, slots
    try:
        yield rec
    finally:
        moe_mod.apply_moe, moe_mod.slots = saved


def moe_drops(watch: dict) -> dict:
    """``moe_watch``'s record summed: MoE ms, dropped assignments and their
    share of the assignments to this card's (this rank's) experts."""
    dropped = int(sum(int(t) for t in watch["dropped"]))
    mine = int(sum(int(t) for t in watch["mine"]))
    return {"moe_ms": event_ms(watch["marks"]), "moe_calls": len(watch["marks"]),
            "dropped": dropped, "assignments": mine, "dropped_share": dropped / max(mine, 1)}


def prefill_flops(cfg, batch: int, seq: int) -> int:
    """A prefill's matrix-product and attention flops: 2 x the layers'
    projection weights x tokens, causal attention's 4 D per visible (query,
    key) pair and head, and the head on the last token."""
    attn = 4 * cfg.head_dim_ * cfg.num_heads * seq * (seq + 1) // 2
    return batch * (cfg.num_layers * (2 * layer_weights(cfg) * seq + attn)
                    + 2 * cfg.d_model * cfg.vocab)


@contextlib.contextmanager
def timed_entries(ops, names):
    """Each ``ops`` entry in ``names`` wrapped in a pair of CUDA events a
    call while the context is open; yields ``{name: [(start, end), ...]}``."""
    marks = {n: [] for n in names}
    saved = {n: getattr(ops, n) for n in names}

    def wrap(n):
        def call(*a, **kw):
            e = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            e[0].record()
            out = saved[n](*a, **kw)
            e[1].record()
            marks[n].append(e)
            return out
        return call

    for n in names:
        setattr(ops, n, wrap(n))
    try:
        yield marks
    finally:
        for n in names:
            setattr(ops, n, saved[n])


def k9_against_sdpa(cfg, batch: int, seq: int, dev, skv: int | None = None,
                    causal: bool = True) -> dict:
    """One layer's attention at the prefill's shapes (``seq`` queries over
    ``skv`` keys, ``seq`` without) on random bf16 q/k/v: K9
    (``fa.flash_fwd``) and ``scaled_dot_product_attention`` (the flash
    backend, k and v repeated to the query heads beforehand), CUDA events,
    mean of 2 calls after one."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels import flash_attention as fa

    skv = seq if skv is None else skv
    g = torch.Generator(device=dev).manual_seed(6)
    h, kh, d = cfg.num_heads, cfg.kv_heads, cfg.head_dim_
    q = torch.randn((batch, h, seq, d), generator=g, device=dev, dtype=torch.bfloat16)
    k, v = (torch.randn((batch, kh, skv, d), generator=g, device=dev, dtype=torch.bfloat16)
            for _ in range(2))
    k9 = timed(lambda: fa.flash_fwd(q, k, v, causal=causal), 2, warm=1)
    kk, vv = (t.repeat_interleave(h // kh, dim=1) for t in (k, v))
    with sdpa_kernel([SDPBackend.FLASH_ATTENTION]):
        sdpa = timed(lambda: F.scaled_dot_product_attention(q, kk, vv, is_causal=causal), 2,
                     warm=1)
    del q, k, v, kk, vv
    torch.cuda.empty_cache()
    rec = {"k9_ms": k9, "sdpa_ms": sdpa, "shape": [batch, h, kh, seq, d]}
    if skv != seq or not causal:
        rec.update(skv=skv, causal=causal)
    return rec


# the measured peak of a full-width LM cell (``torch.cuda.max_memory_allocated``
# above the baseline before its call) against the dry run's prediction of it
PEAK_TOL = 0.10
DRYRUN = {"s": 0.0, "traces": 0}     # the dry run's traces in this run, on the CPU
PEAK_HOLDS: list = []                 # every cell's hold; a miss fails the script at its end


def dry(fn, keep=None, *, inference: bool = True) -> int:
    """The dry run's transient peak of ``fn()`` (bytes allocated beyond its
    arguments, ``launch.dryrun.measure``), ``fn`` called on meta tensors,
    under ``keep()`` where the card's call keeps tensors for its kernel
    holds (``kept_model_path``: the kept tensors' bytes then count in the
    prediction)."""
    from repro_torch.launch import dryrun

    with keep() if keep else contextlib.nullcontext():
        rec = dryrun.measure(fn, inference=inference)
    DRYRUN["s"] += rec["seconds"]
    DRYRUN["traces"] += 1
    return rec["transient_peak"]


def dry_fit(predict, budget: int, cap: int, sizes=(1, 2)) -> dict:
    """``launch.dryrun.fit``: the largest size up to ``cap`` whose
    predicted peak ``predict(size)`` fits ``budget`` bytes, from traces at
    ``sizes`` and the confirming trace of the size chosen."""
    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    got = dryrun.fit(predict, budget, sizes, cap=cap)
    got["budget"] = budget
    got["s"] = time.perf_counter() - t0
    return got


def fit_text(f: dict) -> str:
    """``fmt_fit``, or where the size was given (``QR_PREFILL_BATCH``) not
    fitted, that."""
    return "a cut for the script's time" if f.get("given") else fmt_fit(f)


def fmt_fit(f: dict) -> str:
    return (f"dry-run fit {f['size']}: {f['slope'] / 2**30:.2f} GiB a unit + "
            f"{f['fixed'] / 2**30:.2f} GiB from traces at {list(f['traced'])}, in "
            f"{f['budget'] / 2**30:.2f} GiB (free less {LM_HEADROOM / 2**30:.0f}, over "
            f"{LM_RESERVE}), "
            f"{f['s']:.1f} s")


def free_budget(dev) -> int:
    """The bytes a call may allocate: the free memory less ``LM_HEADROOM``,
    over ``LM_RESERVE`` (the allocator's blocks reserved around them)."""
    gc.collect()
    torch.cuda.empty_cache()
    return int((torch.cuda.mem_get_info(dev)[0] - LM_HEADROOM) / LM_RESERVE)


def peak_base(dev) -> int:
    """The allocated bytes before a held call, the peak reset."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    return torch.cuda.memory_allocated(dev)


def hold_peak(tag: str, want: int, base: int, dev) -> dict:
    """The cell's measured peak, ``torch.cuda.max_memory_allocated`` above
    ``base`` (the allocated bytes before its call; a decode cell's before
    its cache, whose bytes ``want`` then holds too: a decode step's own
    bytes are a few MB, the scale of the card's library allocations that a
    trace does not see), beside the dry run's prediction ``want``, held to
    ``PEAK_TOL``; with the reserved/allocated ratio of the peaks.  A miss
    is logged and recorded, and fails the script at its end."""
    measured = torch.cuda.max_memory_allocated(dev) - base
    res = torch.cuda.max_memory_reserved(dev) / max(torch.cuda.max_memory_allocated(dev), 1)
    return record_peak(tag, measured, want, res)


def record_peak(tag: str, measured: int, want: int, res: float) -> dict:
    """``hold_peak``'s record of a peak ``measured`` here or on a rank
    (``res`` its reserved / allocated ratio): logged, and a miss fails the
    script at its end."""
    ratio = measured / max(want, 1)
    rec = {"cell": tag, "measured": measured, "predicted": want, "ratio": ratio,
           "reserved_over_allocated": res, "ok": abs(ratio - 1) <= PEAK_TOL}
    PEAK_HOLDS.append(rec)
    log(f"[dryrun] {tag}: peak {measured / 2**30:.3f} GiB allocated above the baseline, dry "
        f"run {want / 2**30:.3f} GiB ({100 * (ratio - 1):+.2f}%, held to "
        f"{100 * PEAK_TOL:.0f}%: {'ok' if rec['ok'] else 'MISS'}); reserved / allocated at "
        f"the peak {res:.3f}")
    return rec


def decode_reps(decode, params, cache, tok, pos: int, cfg):
    """``LM_DECODE_REPS`` decode steps at ``pos``; the last one's output."""
    for _ in range(LM_DECODE_REPS):
        out = decode(params, cache, tok, pos, cfg)
    return out


def meta_tokens(cfg, batch: int, seq: int) -> dict:
    """A ``(batch, seq)`` token batch on meta, and a prefix model's
    frames or patches (``lm_batch_for``'s shapes)."""
    from repro_torch.configs import registry

    kind = "whisper" if cfg.is_encoder_decoder else "pixtral" if cfg.num_patches else "x"
    return registry.batch_specs(registry.ArchBinding("", "", kind, False), cfg, batch, seq)


def lm_prefill_run(params, cfg, dev, mods, totals, batch: int | None = None) -> dict:
    """``prefill_32k``: one prefill of ``seq`` tokens at ``batch`` or the
    largest batch that fits, timed by CUDA events, K9's and K8's time by events around
    every call.  The fit is the dry run's (``dry_fit``): the prefill traced
    on meta at batches 1 and 2 gives a line, fixed + slope x batch, of the
    bytes it allocates; the batch is the largest whose line fits the free
    memory less ``LM_HEADROOM`` (which covers the allocator's blocks
    reserved around them), cut to the cell's, confirmed by a third trace.
    A batch-1 prefill runs first under the profiler.  In the timed call
    ``kept_model_path`` keeps layer 0's K9 q/k/v and output and K8's inputs
    and output, held against their plain versions after it
    (``hold_kept``); the traces keep the same, so the prediction counts
    them.  Its measured peak is held to the dry run's (``hold_peak``).
    Then K9 against SDPA at the prefill's attention shapes."""
    from repro_torch.configs.base import LM_SHAPES
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.models import transformer as T

    cell = next(s for s in LM_SHAPES if s.name == "prefill_32k")
    seq = cell.seq_len
    g = torch.Generator(device=dev).manual_seed(3)

    def prefill(batch: int):
        toks = torch.randint(0, cfg.vocab, (batch, seq), generator=g, device=dev,
                             dtype=torch.int32)
        with kept_model_path(ops, {}), torch.inference_mode():
            T.forward_prefill(params, toks, cfg, seq)

    top = top_device_ops(lambda: prefill(1), 8)
    meta = dryrun.to_meta(params)

    def predict(b: int) -> int:
        return dry(lambda: T.forward_prefill(meta, meta_tokens(cfg, b, seq)["tokens"], cfg, seq),
                   lambda: kept_model_path(ops, {}))

    if batch is None:
        fit = dry_fit(predict, free_budget(dev), cell.global_batch)
        batch = fit["size"]
    else:
        fit = {"size": batch, "traced": {batch: predict(batch)}, "given": True}
    reset_all(mods)
    toks = torch.randint(0, cfg.vocab, (batch, seq), generator=g, device=dev, dtype=torch.int32)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    base = peak_base(dev)
    kept = {}
    with timed_entries(ops, ("flash_attention_fused", "qr_lookup")) as marks, \
            kept_model_path(ops, kept), moe_watch(cfg) as watch:
        with torch.inference_mode():
            start.record()
            logits, cache = T.forward_prefill(params, toks, cfg, seq)
            end.record()
            torch.cuda.synchronize()
    held_peak = hold_peak(f"{cfg.name} {cfg.embedding_kind} prefill_32k batch {batch}",
                          fit["traced"][batch], base, dev)
    n = take_launches(mods, totals)
    ms = start.elapsed_time(end)
    peak, peak_reserved = (torch.cuda.max_memory_allocated(dev),
                           torch.cuda.max_memory_reserved(dev))
    k9_ms = sum(a.elapsed_time(b) for a, b in marks["flash_attention_fused"])
    k8_ms = sum(a.elapsed_time(b) for a, b in marks["qr_lookup"])
    want = {"flash_fwd": cfg.num_layers, **({"qr_gather": 1} if cfg.embedding_kind == "qr"
                                            else {})}
    if n != want or tuple(logits.shape) != (batch, 1, cfg.vocab) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"[lm] {cfg.name} prefill_32k: launches {n}, logits "
                             f"{tuple(logits.shape)}")
    del logits, cache, toks
    torch.cuda.empty_cache()
    held = hold_kept(kept, f"{cfg.name} prefill_32k")
    del kept
    flops = prefill_flops(cfg, batch, seq)
    rec = {"seq": seq, "batch": batch, "cell_batch": cell.global_batch, "fit": fit,
           "peak_hold": held_peak, "ms": ms, "tokens_per_s": batch * seq / ms * 1e3, "k9_ms": k9_ms,
           "k9_share": k9_ms / ms, "k9_ms_a_call": k9_ms / cfg.num_layers, "k8_ms": k8_ms,
           "peak_gib": peak / 2**30, "peak_reserved_gib": peak_reserved / 2**30,
           "flops": flops, "bound_ms": flops / BF16_FLOP_S * 1e3, "launches": n,
           "held": held, "top_ops_batch1": top}
    if cfg.num_experts:
        rec["moe"] = moe_drops(watch)
        rec["moe"]["moe_share"] = rec["moe"]["moe_ms"] / ms
    rec["k9_vs_sdpa"] = k9_against_sdpa(cfg, batch, seq, dev)
    reset_all(mods)                 # the yardstick's launches are not the path's
    return rec


def lm_decode_run(params, cfg, dev, mods, totals) -> dict:
    """``decode_32k``: one ``forward_decode`` step against a cache 32,768
    deep (random, every position attended) at the largest batch whose cache
    fits the free memory less ``LM_HEADROOM``; ms a step by CUDA events over
    ``LM_DECODE_REPS`` steps, beside the bytes bound: every weight read once
    plus the whole cache read, over the HBM rate.  Each timed step's K8
    call (a QR vocabulary) is kept and held against the plain sum after
    them (``hold_kept``)."""
    from repro_torch import tree
    from repro_torch.configs.base import LM_SHAPES
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.models import transformer as T

    cell = next(s for s in LM_SHAPES if s.name == "decode_32k")
    depth = cell.seq_len
    elem = torch.empty((), dtype=cfg.cdtype).element_size()
    cache_seq = 2 * cfg.num_layers * depth * cfg.kv_heads * cfg.head_dim_ * elem
    gc.collect()
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info(dev)[0]
    batch = max(1, min(cell.global_batch, (free - LM_HEADROOM) // cache_seq))
    base = peak_base(dev)               # the cell's baseline: before its cache
    cache = T.init_cache(cfg, batch, depth, device=dev)
    g = torch.Generator(device=dev).manual_seed(4)
    for key in ("k", "v"):
        cache[key].normal_(generator=g)
    tok = torch.randint(0, cfg.vocab, (batch, 1), generator=g, device=dev, dtype=torch.int32)
    reset_all(mods)

    def steps(p, c, t):
        for _ in range(LM_DECODE_REPS):
            out = T.forward_decode(p, t, c, depth - 1, cfg)
        return out

    meta = dryrun.to_meta((params, cache, tok))
    predicted = dryrun.storage_bytes(meta[1:]) + dry(lambda: steps(*meta),
                                                     lambda: kept_model_path(ops, {}))
    with torch.inference_mode():
        top = top_device_ops(lambda: T.forward_decode(params, tok, cache, depth - 1, cfg), 8)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        kept = {}
        with kept_model_path(ops, kept), moe_watch(cfg) as watch:
            start.record()
            logits, out = steps(params, cache, tok)
            end.record()
            torch.cuda.synchronize()
    held_peak = hold_peak(f"{cfg.name} {cfg.embedding_kind} decode_32k batch {batch}", predicted,
                          base, dev)
    n = take_launches(mods, totals)
    if out is not cache or tuple(logits.shape) != (batch, 1, cfg.vocab) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"[lm] {cfg.name} decode_32k: logits {tuple(logits.shape)}")
    held = hold_kept(kept, f"{cfg.name} decode_32k")
    ms = start.elapsed_time(end) / LM_DECODE_REPS
    weight_bytes = sum(a.numel() * a.element_size() for a in tree.leaves(params))
    nbytes = weight_bytes + batch * cache_seq
    rec = {"depth": depth, "batch": batch, "cell_batch": cell.global_batch,
           "cache_bytes": batch * cache_seq, "weight_bytes": weight_bytes, "ms": ms,
           "tokens_per_s": batch / ms * 1e3,
           "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
           "bound_ms": nbytes / BW_BYTES_S * 1e3, "launches": n, "held": held, "top_ops": top,
           "peak_hold": held_peak}
    if cfg.num_experts:
        rec["moe"] = moe_drops(watch)
    del cache, logits, out, kept
    torch.cuda.empty_cache()
    return rec


def lm_cli_run(vocab: str, mods, totals, arch: str = LM_MAIN, tag: str = "[lm-cli]",
               cli=None) -> dict:
    """``python -m repro_torch.launch.serve --arch <arch>`` with ``cli``
    (``LM_CLI``; its ``main``, in this process): exit 0, a tokens/s line,
    K9 once a layer (a site) for its prefill, K8 once a QR lookup."""
    import io

    from repro_torch.configs import registry
    from repro_torch.launch import serve

    cli = cli or LM_CLI
    reset_all(mods)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = serve.main(["--arch", arch, "--embedding", vocab, *cli])
    secs = time.perf_counter() - t0
    n = take_launches(mods, totals)
    text = buf.getvalue()
    sites = k9_calls(registry.get(arch).smoke if "--smoke" in cli else lm_config(arch))
    new = int(cli[cli.index("--max-new") + 1])
    want = {**({"flash_fwd": sites} if sites else {}),
            **({"qr_gather": 1 + new} if vocab == "qr" else {})}
    if rc != 0 or "tok/s" not in text or n != want:
        raise AssertionError(f"{tag} serve CLI --arch {arch} --embedding {vocab}: exit {rc}, "
                             f"launches {n}, output {text[-500:]}")
    line = next(x for x in text.splitlines() if "tok/s" in x)
    log(f"{tag} --arch {arch} --embedding {vocab} {' '.join(cli)}: {line} (call "
        f"{secs:.1f} s, set-up included; launches {n})")
    return {"arch": arch, "embedding": vocab, "exit": rc, "line": line, "s": secs, "launches": n,
            "tokens_per_s": float(re.search(r"([0-9.]+) tok/s", line).group(1))}


def lm_main_run(dev, vocab: str, mods, totals, arch: str = LM_MAIN, tag: str = "[lm]",
                oracle: bool = False) -> dict:
    """``arch`` (qwen2-1.5b) at full width and depth with a ``vocab``
    vocabulary (QR at the config's collision): the fp32 consistency check
    (an MoE arch at the capacity factor ``moe_ample`` gives it, where
    nothing drops), K9 on the model path in fp32 and bf16, with ``oracle``
    the first MoE layer against its per-token oracle (``moe_oracle``), then
    ``prefill_32k`` and ``decode_32k`` on the weights cast once for serving
    (``ServeFamily.prepare``); an MoE arch's MoE ms and dropped share."""
    from repro_torch import tree
    from repro_torch.models import transformer as T
    from repro_torch.train import serve_step as S

    cfg = lm_config(arch).replace(embedding_kind=vocab)
    params, _ = T.init_lm(cfg, seed=0, device=dev)
    c32 = cfg.replace(compute_dtype="float32")
    rec = {"arch": cfg.name, "vocab": vocab, "collision": cfg.qr_collision,
           "layers": cfg.num_layers,
           "param_bytes_fp32": sum(a.numel() * 4 for a in tree.leaves(params))}
    rec["consistency_fp32"] = lm_consistency(params, c32.replace(
        capacity_factor=moe_ample(cfg)), *LM_CONSIST_MAIN, dev)
    rec["k9_model_path"] = {"float32": lm_k9_check(params, c32, dev)}
    if oracle:
        rec["oracle"] = moe_oracle(params, c32.replace(capacity_factor=moe_ample(cfg)), dev)
    take_launches(mods, totals)
    params = S.serve_family("transformer").prepare(params, cfg)
    gc.collect()
    torch.cuda.empty_cache()
    rec["k9_model_path"]["bfloat16"] = lm_k9_check(params, cfg, dev)
    take_launches(mods, totals)
    rec["prefill_32k"] = lm_prefill_run(params, cfg, dev, mods, totals,
                                        QR_PREFILL_BATCH if vocab == "qr" else None)
    rec["decode_32k"] = lm_decode_run(params, cfg, dev, mods, totals)
    k9, p, d = rec["k9_model_path"], rec["prefill_32k"], rec["decode_32k"]
    ample = (f", capacity factor {moe_ample(cfg):g}: no drops" if cfg.num_experts else "")
    log(f"{tag} {cfg.name} {vocab} vocab, {cfg.num_layers} layers: fp32 consistency "
        f"(batch {LM_CONSIST_MAIN[0]}, seq {LM_CONSIST_MAIN[1]}{ample}) prefill "
        f"{rec['consistency_fp32']['prefill']:.2e} decode {rec['consistency_fp32']['decode']:.2e} "
        f"(held to {LM_CONSIST_TOL}, logits up to {rec['consistency_fp32']['logit_scale']:.2f}); "
        f"K9 on layer 0's q/k/v {k9['float32']['shape']}: fp32 {fmt_err(k9['float32'])}, bf16 "
        f"{fmt_err(k9['bfloat16'])}")
    if oracle:
        o = rec["oracle"]
        log(f"{tag} {cfg.name} layer 0's MoE on its own input (1 x {o['tokens']}, fp32, "
            f"capacity factor {o['capacity_factor']:g}, {o['dropped']} dropped) vs the per-token "
            f"mixture over the {cfg.num_experts} experts on the card's routing: "
            f"{o['rel_err']:.3g} of scale (held to {MOE_ORACLE_TOL}); smallest top-"
            f"{cfg.top_k} margin {o['margin']:.3g}")
    moe_p = (f"; MoE layers {p['moe']['moe_ms']:.1f} ms ({100 * p['moe']['moe_share']:.1f}%), "
             f"dropped {p['moe']['dropped']} of {p['moe']['assignments']} assignments "
             f"({100 * p['moe']['dropped_share']:.2f}%)" if "moe" in p else "")
    moe_d = (f"; dropped {d['moe']['dropped']} of {d['moe']['assignments']} assignments "
             f"({100 * d['moe']['dropped_share']:.2f}%) over {LM_DECODE_REPS} steps, MoE layers "
             f"{d['moe']['moe_ms'] / LM_DECODE_REPS:.2f} ms a step" if "moe" in d else "")
    log(f"{tag} {cfg.name} {vocab} prefill_32k: batch {p['batch']} (cell {p['cell_batch']}; "
        f"{fit_text(p['fit'])}) x {p['seq']}: {p['ms']:.1f} ms, "
        f"{p['tokens_per_s']:.0f} tokens/s, K9 {p['k9_ms']:.1f} ms ({100 * p['k9_share']:.1f}%, "
        f"{p['k9_ms_a_call']:.2f} ms a layer), peak {p['peak_gib']:.2f} GiB allocated, "
        f"{p['peak_reserved_gib']:.2f} GiB reserved, bound "
        f"{p['bound_ms']:.1f} ms ({p['flops']:.3e} flop at the bf16 peak); K8 {p['k8_ms']:.2f} "
        f"ms; launches {p['launches']}; one layer's attention at these shapes: K9 "
        f"{p['k9_vs_sdpa']['k9_ms']:.1f} ms, SDPA (flash backend) "
        f"{p['k9_vs_sdpa']['sdpa_ms']:.1f} ms" + moe_p)
    log(f"{tag} {cfg.name} {vocab} prefill_32k kernels vs plain on the main path: "
        + held_text(p["held"]))
    log(f"{tag} {cfg.name} {vocab} prefill at batch 1, top device operations: "
        + ", ".join(f"{k} {t:.1f} ms" for k, t in p["top_ops_batch1"]))
    log(f"{tag} {cfg.name} {vocab} decode_32k: batch {d['batch']} (cell {d['cell_batch']}; cache "
        f"{d['cache_bytes'] / 2**30:.2f} GiB) against {d['depth']} positions: {d['ms']:.2f} ms a "
        f"step, {d['tokens_per_s']:.0f} tokens/s, peak {d['peak_gib']:.2f} GiB, bound "
        f"{d['bound_ms']:.2f} ms ({d['weight_bytes'] / 1e9:.2f} GB of weights + the cache at "
        f"{BW_BYTES_S / 1e12:.2f} TB/s); launches {d['launches']}"
        + (f"; K8 vs plain: {held_text(d['held'])}" if d["held"] else "") + moe_d)
    log(f"{tag} {cfg.name} {vocab} decode step, top device operations: "
        + ", ".join(f"{k} {t:.2f} ms" for k, t in d["top_ops"]))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def lm_other_run(dev, arch: str, mods, totals, tag: str = "[lm]") -> dict:
    """One of the other archs at full width (granite-34b and
    qwen3-moe-235b-a22b at the depth whose fp32 params fit the free memory
    less ``LM_HEADROOM``): the fp32 consistency check at
    ``LM_CONSIST_OTHER`` (an MoE arch at ``moe_ample``'s capacity factor,
    where nothing drops), then one ``greedy_generate`` at ``LM_GEN`` in
    bf16 compute on the fp32 params (each weight cast per call, as
    ``repro`` does), host clock."""
    from repro_torch import tree
    from repro_torch.models import transformer as T
    from repro_torch.train import serve_step as S

    cfg = lm_config(arch)
    gc.collect()
    torch.cuda.empty_cache()
    layer_bytes = layer_weights(cfg, total=True) * 4
    embed_bytes = cfg.vocab * cfg.d_model * 4 * (1 if cfg.tie_embedding else 2)
    # ``init_lm`` holds one layer's draws beside the stacked layers
    fit = (torch.cuda.mem_get_info(dev)[0] - LM_HEADROOM - embed_bytes) // max(
        layer_bytes, 1) - 1
    depth = int(min(cfg.num_layers, fit))
    if depth < cfg.num_layers:
        cfg = cfg.replace(num_layers=depth)
    params, _ = T.init_lm(cfg, seed=0, device=dev)
    rec = {"arch": arch, "layers": cfg.num_layers, "full_layers": lm_config(arch).num_layers,
           "param_bytes_fp32": sum(a.numel() * 4 for a in tree.leaves(params))}
    rec["consistency_fp32"] = lm_consistency(
        params, cfg.replace(compute_dtype="float32", capacity_factor=moe_ample(cfg)),
        *LM_CONSIST_OTHER, dev)
    take_launches(mods, totals)
    b, prompt, new = LM_GEN
    fam = S.serve_family("transformer")
    g = torch.Generator(device=dev).manual_seed(5)
    batch = {"tokens": torch.randint(0, cfg.vocab, (b, prompt), generator=g, device=dev,
                                     dtype=torch.int32)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = S.greedy_generate(fam, params, batch, cfg, max_new=new, max_len=prompt + new)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n = take_launches(mods, totals)
    if tuple(out.shape) != (b, new) or int(out.min()) < 0 or int(out.max()) >= cfg.vocab or (
            n.get("flash_fwd") != cfg.num_layers):
        raise AssertionError(f"{tag} {arch} greedy_generate: {tuple(out.shape)}, launches {n}")
    rec.update(generate_s=secs, tokens_per_s=b * new / secs, launches=n,
               first_tokens=out[0].tolist())
    experts = (f", {cfg.num_experts} experts top {cfg.top_k} (consistency at capacity factor "
               f"{moe_ample(cfg):g})" if cfg.num_experts else "")
    log(f"{tag} {arch} ({cfg.num_layers} of {rec['full_layers']} layers, "
        f"{rec['param_bytes_fp32'] / 1e9:.1f} GB fp32; {cfg.norm} norm, {cfg.activation}, "
        f"{cfg.num_heads}/{cfg.kv_heads} heads, rotary {cfg.partial_rotary}, "
        f"{'tied' if cfg.tie_embedding else 'untied'} head{experts}): fp32 consistency prefill "
        f"{rec['consistency_fp32']['prefill']:.2e} decode {rec['consistency_fp32']['decode']:.2e}; "
        f"greedy_generate batch {b}, prompt {prompt}, {new} new in {secs:.2f} s "
        f"({rec['tokens_per_s']:.1f} tokens/s, prefill + decode, host clock); launches {n}")
    del params, batch, out
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def lm_serving_phase(dev, by_name, mods) -> dict:
    """Phase 11: the dense transformer served.  ``[lm-ref]`` on the smoke
    configs; qwen2-1.5b at full width and depth with the dense and the QR
    vocabulary (consistency, K9 on the model path, ``prefill_32k``,
    ``decode_32k``), the serve CLI with each; the other three dense archs
    at full width (granite-34b's depth cut to fit).  The phase's launches
    add to the ``flash_fwd`` and ``qr_gather`` rows.  Returns the
    ``{"lm_serving": ...}`` record."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[lm] before the phase: {torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB "
        f"allocated, {torch.cuda.mem_get_info(dev)[0] / 2**30:.2f} GiB free")
    totals = {}
    reset_all(mods)
    record = {"ref": lm_ref_phase(dev, mods, totals)}
    record["main"] = [lm_main_run(dev, vocab, mods, totals) for vocab in ("dense", "qr")]
    record["cli"] = [lm_cli_run(vocab, mods, totals) for vocab in ("dense", "qr")]
    record["others"] = [lm_other_run(dev, arch, mods, totals)
                        for arch in LM_ARCHS if arch != LM_MAIN]
    record["launches"] = totals
    for name in ("flash_fwd", "qr_gather"):
        by_name[name]["launches"] += totals.get(name, 0)
    record["phase_s"] = time.perf_counter() - t0
    log(f"[lm] phase {record['phase_s']:.1f} s; launches {totals}")
    return record


# ---------------------------------------------------------------------------
# phase 12: the dense transformer trained on one card
# ---------------------------------------------------------------------------

LMT_VOCABS = ("dense", "qr", "tt")
LMT_REF_SHAPE = (4, 16)   # batch, sequence of the smoke reference step (2 microbatches)
LMT_REF_TOL = 1e-5        # card vs CPU in fp32 compute: loss relative, each leaf of its scale
LMT_BF16_TOL = 2e-2       # card vs CPU in bf16 compute: the loss, relative
# AdamW's first step moves an entry by lr u, u = g / (|g| + eps), and
# |du| <= |dg| / eps: at the default eps 1e-8 an entry whose |g| is near
# 1e-8 moves by anything up to lr when the card's and the CPU's fp32
# gradient sums, taken in other orders, differ in the last bit.  The two
# gradients differ by up to ~2.3e-6 of each leaf's scale at these shapes;
# a zero-initialized bias (its updated scale lr) read 3.4e-5 of its scale
# at eps 1e-4 and 1.0e-5 at 1e-3; eps 1e-2 bounds du by ~2e-6 for a leaf
# whose gradient scale is below 1e-2
LMT_REF_OPT = dict(lr=1e-3, eps=1e-2, warmup_steps=1, total_steps=4)
# qwen2-1.5b at full width: (vocabulary, remat policy) of each timed config.
# The QR ``dots`` step at full depth (6 sequences a microbatch: no faster a
# sequence than ``full``, PERF.md) left the list to make room for phase 14,
# the dense ``full`` step (within 3% of QR's a step, PERF.md) for phase 15;
# ``lm_train_dots_check`` runs ``dots`` at the gradient check's cut, and the
# gradient check and phase 11 / 13 run the dense vocabulary
LMT_MAIN = (("qr", "full"),)
LMT_MICRO = 2             # microbatches a step: the global batch is 2 x the fitted one
# the microbatch sizes whose traced peaks give the dry-run fit's line: up to
# ~6 sequences the layers' gradients and their stack set a step's peak
# (the dry run: 28.8 GiB at 4 and at 6, QR, remat full), beyond it the
# activations (37.0 GiB at 11)
LMT_FIT = (8, 12)
LMT_OPT = dict(lr=3e-4, warmup_steps=1, total_steps=1)
LMT_GRAD = (2, 2)         # layers, sequences of the step-1 gradient check
LMT_FIT_STEPS = 3         # steps of a depth-fitted run (``lm_train_fitted``), on one batch
# AdamW's first steps move every weight by ~lr: at lr 1e-3 chatglm3-6b's
# third loss rose above its first (11.57, 11.51, 11.91; granite-34b fell)
LMT_FIT_OPT = dict(lr=1e-4, warmup_steps=1, schedule="constant")
# depths whose traced peaks give the dry run's depth fit: over its first
# three layers a step's peak grows by less a layer than beyond them (the
# traces of granite-moe and zamba2, QR), so a line through depths 1 and 2
# falls short of the slope and its size needs more traces
LMT_DEPTHS = (4, 8)
# a step at full width holds (microbatch, 4,096, 151,936) bf16 tensors of
# ~1.2 GiB a sequence (the logits, their gradient): in the default
# allocator's fixed segments the steps left 14-32 GiB reserved but
# unallocated and a 13.9-16.2 GiB request failed (NVIDIA H100 80GB HBM3);
# segments that grow in place keep reserved near allocated
LMT_ALLOCATOR = "expandable_segments:True"


def lmt_shape():
    from repro_torch.configs.base import LM_SHAPES

    return next(s for s in LM_SHAPES if s.name == "train_4k")


def k9_calls(cfg) -> int:
    """K9 launches of one forward: one a layer (the transformers, pixtral),
    one a shared-attention site (the zamba2 hybrid), none (xlstm), one an
    encoder layer and two a decoder layer, self and cross (whisper)."""
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.attn_every
    if cfg.is_encoder_decoder:
        return cfg.enc_layers + 2 * cfg.dec_layers
    return 0 if cfg.family == "ssm" else cfg.num_layers


def depth_of(cfg) -> int:
    """The depth ``with_depth`` cuts: the layers, an encoder-decoder's
    encoder (and decoder) layers."""
    return cfg.enc_layers if cfg.is_encoder_decoder else cfg.num_layers


def with_depth(cfg, depth: int):
    """``cfg`` cut to ``depth`` layers; an encoder-decoder (whisper) to
    ``depth`` encoder and ``depth`` decoder layers."""
    if cfg.is_encoder_decoder:
        return cfg.replace(enc_layers=depth, dec_layers=depth, num_layers=2 * depth)
    return cfg.replace(num_layers=depth)


def lm_batch_for(cfg, batch: int, seq: int, g: torch.Generator, dev) -> dict:
    """``batch`` sequences of ``seq`` tokens drawn from ``g``, then a prefix
    model's standard normal rows: whisper's ``N_AUDIO`` frames, pixtral's
    ``num_patches`` patches."""
    out = {"tokens": torch.randint(0, cfg.vocab, (batch, seq), generator=g, device=dev,
                                   dtype=torch.int32)}
    if cfg.is_encoder_decoder:
        from repro_torch.models.whisper import N_AUDIO

        out["frames"] = torch.randn((batch, N_AUDIO, cfg.d_model), generator=g, device=dev)
    elif cfg.num_patches:
        out["patches"] = torch.randn((batch, cfg.num_patches, cfg.d_model), generator=g,
                                     device=dev)
    return out


def step_launches(cfg, microbatches: int) -> dict:
    """The kernels a training step launches: per microbatch K9 once a layer
    in the forward and once more in the backward's recompute (``remat``; a
    zamba2 hybrid once a site, its shared block not recomputed; xlstm
    never), K8 once for a QR vocabulary's tokens, K5 once for a TT
    vocabulary's tokens (``tt_exec="pallas"``) and once more for a tied
    head's ``materialize``, each K5 call one launch per ``d1_slices`` range
    of the row."""
    again = 2 if cfg.remat and cfg.family not in ("hybrid", "ssm") else 1
    n = {"flash_fwd": k9_calls(cfg) * again * microbatches}
    if not n["flash_fwd"]:
        del n["flash_fwd"]
    if cfg.embedding_kind == "qr":
        n["qr_gather"] = microbatches
    if cfg.embedding_kind == "tt" and cfg.tt_exec == "pallas":
        from repro_torch.kernels import tt_gather

        slices = len(tt_gather.d1_slices(cfg.emb_config.tt_spec.dims))
        n["tt_bag"] = (2 if cfg.tie_embedding else 1) * microbatches * slices
    return n


def leaf_scale_errors(got, want, scale_of=None) -> tuple[float, str]:
    """The worst leaf's max |got - want| over its max |want| (over the max
    |want| of the leaf at ``scale_of(path)``, where given), and its path."""
    from repro_torch import tree

    pairs = [(path, a, b.to(a.device).float())
             for (path, a), b in zip(tree.leaves_with_paths(got), tree.leaves(want))]
    scale = {path: float(b.abs().max()) for path, _, b in pairs}
    worst, where = 0.0, ""
    for path, a, b in pairs:
        ref = scale[scale_of(path)] if scale_of else scale[path]
        rel = float((a.float() - b).abs().max()) / max(ref, 1e-30)
        if rel > worst:
            worst, where = rel, path
    return worst, where


def key_bias_scale(path: str) -> str:
    """The leaf whose scale a gradient is held to in a model whose attention
    has no RoPE (whisper): a key projection's bias is held to its weight's.
    A softmax does not move when all of a query's scores move together, so
    that bias's gradient is zero but for rounding, on both paths (RoPE
    turns it by each key's own angle, and it is not zero there)."""
    return path[:-1] + "w" if path.endswith("wk/b") else path


def lm_train_ref(dev, mods, totals) -> dict:
    """``[lm-train-ref]``: one ``make_train_step`` step (2 microbatches of
    the ``LMT_REF_SHAPE`` batch) of each dense smoke config with a dense, a
    QR (collision 8) and a TT (``tt_exec="pallas"``) vocabulary on the card
    and on the CPU, from the same weights and tokens: in fp32 compute the
    loss within ``LMT_REF_TOL`` relative and every updated leaf within
    ``LMT_REF_TOL`` of its scale, and the batch's gradient (one pass, no
    microbatches) within ``LMT_REF_TOL`` of each leaf's scale; in bf16
    compute the loss within ``LMT_BF16_TOL``; each step's launches
    ``step_launches``."""
    from repro_torch.configs import registry
    from repro_torch.models import transformer as T
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as TS
    from repro_torch.tree import tree_map

    ocfg = opt.OptConfig(**LMT_REF_OPT)
    out = {}
    for arch in LM_ARCHS:
        binding = registry.get(arch)
        for vocab in LMT_VOCABS:
            cfg = binding.smoke.replace(embedding_kind=vocab, qr_collision=8, tt_exec="pallas",
                                        compute_dtype="float32")
            cpu, _ = T.init_lm(cfg, seed=0, device="cpu")
            card = tree_map(lambda a: a.to(dev), cpu)
            toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, LMT_REF_SHAPE)
                                    .astype(np.int32))
            rec = {}
            for compute in ("float32", "bfloat16"):
                c = cfg.replace(compute_dtype=compute)
                step = TS.make_train_step(registry.train_loss_fn(binding, c), ocfg,
                                          microbatches=2)
                want, _, wm = step(cpu, opt.init(cpu), {"tokens": toks})
                reset_all(mods)
                got, _, gm = step(card, opt.init(card), {"tokens": toks.to(dev)})
                torch.cuda.synchronize()
                n = take_launches(mods, totals)
                if n != step_launches(c, 2):
                    raise AssertionError(f"[lm-train-ref] {arch} {vocab} {compute}: launches "
                                         f"{n}, not {step_launches(c, 2)}")
                loss_rel = abs(float(gm["loss"]) - float(wm["loss"])) / abs(float(wm["loss"]))
                rec[compute] = {"loss": float(gm["loss"]), "loss_rel": loss_rel, "launches": n}
                if compute == "float32":
                    worst, where = leaf_scale_errors(got, want)
                    loss_fn = registry.train_loss_fn(binding, c)
                    g_card = TS.value_and_grad(loss_fn, card, {"tokens": toks.to(dev)})[2]
                    g_cpu = TS.value_and_grad(loss_fn, cpu, {"tokens": toks})[2]
                    take_launches(mods, totals)
                    g_worst, g_where = leaf_scale_errors(g_card, g_cpu)
                    rec[compute].update(param_rel=worst, param_leaf=where, grad_rel=g_worst,
                                        grad_leaf=g_where)
                    ok = loss_rel <= LMT_REF_TOL and max(worst, g_worst) <= LMT_REF_TOL
                else:
                    ok = loss_rel <= LMT_BF16_TOL
                if not ok:
                    raise AssertionError(f"[lm-train-ref] {arch} {vocab} {compute}: {rec}")
            out[f"{arch}/{vocab}"] = rec
            f32 = rec["float32"]
            log(f"[lm-train-ref] {cfg.name} {vocab} vocab, one step of 2 microbatches card vs "
                f"CPU: fp32 loss {f32['loss']:.5f} ({f32['loss_rel']:.1e} rel), updated params "
                f"{f32['param_rel']:.1e} of scale (worst {f32['param_leaf']}), gradients "
                f"{f32['grad_rel']:.1e} (worst {f32['grad_leaf']}); bf16 loss "
                f"{rec['bfloat16']['loss_rel']:.1e} rel; launches a step {f32['launches']}")
    return out


def lm_train_flops(cfg, tokens: int, seq: int) -> int:
    """Model flops of a training step (no recompute counted): 6 x the
    layers' projection weights a token, causal attention's 12 D flops a
    visible (query, key) pair and head (4 D forward, 8 D backward), and the
    head's products: 6 d x the vocabulary (dense, TT, hashed rows) or x the
    Q and R rows (the factorized QR head)."""
    if cfg.embedding_kind == "qr" and cfg.tie_embedding:
        spec = cfg.emb_config.qr_spec
        rows = -(-spec.q_rows // 128) * 128 + spec.r_rows
    elif cfg.embedding_kind == "hashed" and cfg.tie_embedding:
        rows = cfg.emb_config.physical_hashed_rows
    else:
        rows = cfg.vocab
    attn = 12 * cfg.head_dim_ * cfg.num_heads * (seq + 1) // 2
    return tokens * (cfg.num_layers * (6 * layer_weights(cfg) + attn) + 6 * cfg.d_model * rows)


@contextlib.contextmanager
def timed_backward(cls, marks: list):
    """While open, each call of the autograd Function ``cls``'s backward
    runs between a pair of CUDA events appended to ``marks``."""
    saved = cls.backward

    def backward(ctx, *grads):
        e = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        e[0].record()
        out = saved(ctx, *grads)
        e[1].record()
        marks.append(e)
        return out

    cls.backward = staticmethod(backward)
    try:
        yield marks
    finally:
        cls.backward = staticmethod(saved)


def event_ms(pairs) -> float:
    return sum(a.elapsed_time(b) for a, b in pairs)


def lm_train_main(dev, vocab: str, policy: str, mods, totals) -> dict:
    """qwen2-1.5b at full width and depth, ``vocab`` vocabulary (QR at the
    config's collision), ``remat_policy=policy``, S 4,096 (train_4k).  The
    microbatch is the largest that fits: the step traced on meta by the
    dry run (``dry_fit``) at ``LMT_FIT`` microbatch sizes, with the params
    and the AdamW state in place, gives a line fixed + slope x sequences of
    the bytes the step allocates (the fp32 accumulator, the activations,
    the gradients, the update's new copies); the microbatch is the largest
    whose line fits the free memory less ``LM_HEADROOM``, confirmed by a
    third trace, and the step's measured peak is held to it
    (``hold_peak``).  The global batch is
    ``LMT_MICRO`` microbatches (train_4k's 256 cut).  Then one step of
    ``make_train_step``, timed (host clock) and split by CUDA events: the
    forwards (around each microbatch's loss), the update (around
    ``optimizer.update``), the backward the rest; K9's ms in the forwards
    and in the backward's recompute, the blockwise attention backward's ms
    (events around each ``_FlashMHA.backward``), K8's ms.  Where either
    runs out of memory, both run again an eighth smaller (each such size
    recorded).  In the step ``kept_model_path`` keeps layer 0's K9 q/k/v
    and output and every K8 call, held against their plain versions
    after it."""
    from repro_torch.configs import registry
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.launch import dryrun
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as TS

    cell = lmt_shape()
    seq = cell.seq_len
    binding = registry.get(LM_MAIN)
    cfg = lm_config(LM_MAIN).replace(embedding_kind=vocab, remat_policy=policy)
    gc.collect()
    torch.cuda.empty_cache()
    params, _ = T.init_lm(cfg, seed=0, device=dev)
    state = opt.init(params)
    loss_fn = registry.train_loss_fn(binding, cfg)
    g = torch.Generator(device=dev).manual_seed(7)

    def toks(b: int) -> dict:
        return {"tokens": torch.randint(0, cfg.vocab, (b, seq), generator=g, device=dev,
                                        dtype=torch.int32)}

    meta_step = TS.make_train_step(loss_fn, opt.OptConfig(**LMT_OPT), microbatches=LMT_MICRO)
    meta = dryrun.to_meta((params, state))

    def predict(b: int) -> int:
        return dry(lambda: meta_step(*meta, meta_tokens(cfg, b * LMT_MICRO, seq)),
                   lambda: kept_model_path(ops, {}), inference=False)

    fit = dry_fit(predict, free_budget(dev), cell.global_batch // LMT_MICRO, sizes=LMT_FIT)
    mb = fit["size"]
    take_launches(mods, totals)

    fwd, upd, k9_at, k9_marks, attn_bwd = [], [], [], [], []

    def timed_loss(p, b):
        e = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        k9_at.append(len(k9_marks))
        e[0].record()
        out = loss_fn(p, b)
        e[1].record()
        k9_at.append(len(k9_marks))
        fwd.append(e)
        return out

    saved_update = TS.opt_mod.update

    def timed_update(*a, **kw):
        e = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        e[0].record()
        out = saved_update(*a, **kw)
        e[1].record()
        upd.append(e)
        return out

    step = TS.make_train_step(timed_loss, opt.OptConfig(**LMT_OPT), microbatches=LMT_MICRO)
    too_big = []
    while True:
        kept = {}
        for marks_list in (fwd, upd, k9_at, k9_marks, attn_bwd):
            marks_list.clear()
        try:
            take_launches(mods, totals)
            batch = toks(mb * LMT_MICRO)
            base = peak_base(dev)
            TS.opt_mod.update = timed_update
            try:
                with timed_entries(ops, ("flash_attention_fused", "qr_lookup")) as marks, \
                        timed_backward(fa._FlashMHA, attn_bwd), kept_model_path(ops, kept):
                    marks["flash_attention_fused"] = k9_marks
                    start = torch.cuda.Event(enable_timing=True)
                    start.record()
                    t0 = time.perf_counter()
                    new_params, _state, m = step(params, state, batch)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
            finally:
                TS.opt_mod.update = saved_update
            break
        except torch.OutOfMemoryError:
            if mb == 1:
                raise
            too_big.append(mb)
        gc.collect()
        torch.cuda.empty_cache()
        mb -= max(1, mb // 8)
    batch_n = mb * LMT_MICRO
    held_peak = hold_peak(f"{cfg.name} {vocab} train_4k {mb} x {LMT_MICRO}",
                          fit["traced"].get(mb) or predict(mb), base, dev)
    loss, norm = float(m["loss"]), float(m["grad_norm"])
    n = take_launches(mods, totals)
    peak, peak_reserved = (torch.cuda.max_memory_allocated(dev),
                           torch.cuda.max_memory_reserved(dev))
    del new_params, _state, batch
    if n != step_launches(cfg, LMT_MICRO) or not (np.isfinite(loss) and np.isfinite(norm)):
        raise AssertionError(f"[lm-train] {cfg.name} {vocab} {policy}: launches {n}, loss "
                             f"{loss}, norm {norm}")
    total = start.elapsed_time(upd[-1][1])
    forward = event_ms(fwd)
    update = event_ms(upd)
    in_fwd = set()
    for i in range(0, len(k9_at), 2):
        in_fwd.update(range(k9_at[i], k9_at[i + 1]))
    k9_fwd = event_ms(p for i, p in enumerate(k9_marks) if i in in_fwd)
    k9_re = event_ms(p for i, p in enumerate(k9_marks) if i not in in_fwd)
    held = hold_kept(kept, f"{cfg.name} {vocab} train step")
    del kept, params, state
    gc.collect()
    torch.cuda.empty_cache()
    flops = lm_train_flops(cfg, batch_n * seq, seq)
    bound = flops / BF16_FLOP_S * 1e3
    rec = {"arch": cfg.name, "vocab": vocab, "remat_policy": policy, "layers": cfg.num_layers,
           "seq": seq, "microbatch": mb, "microbatches": LMT_MICRO, "batch": batch_n,
           "cell_batch": cell.global_batch, "fit": fit, "out_of_memory_at": too_big,
           "peak_hold": held_peak, "loss": loss, "grad_norm": norm, "ms_per_step": wall * 1e3,
           "event_ms": total,
           "tokens_per_s": batch_n * seq / wall, "forward_ms": forward,
           "backward_ms": total - forward - update, "update_ms": update,
           "k9_forward_ms": k9_fwd, "k9_recompute_ms": k9_re,
           "attention_backward_ms": event_ms(attn_bwd), "k8_ms": event_ms(marks["qr_lookup"]),
           "peak_gib": peak / 2**30, "peak_reserved_gib": peak_reserved / 2**30,
           "flops": flops, "bound_ms": bound, "bound_share": bound / (wall * 1e3),
           "launches": n, "held": held}
    log(f"[lm-train] {cfg.name} {vocab} vocab, remat {policy}, {cfg.num_layers} layers, S {seq}: "
        f"microbatch {mb} ({fmt_fit(fit)}; out of memory at {too_big or 'none'}) x "
        f"{LMT_MICRO} = batch {batch_n} (cell {cell.global_batch}): "
        f"{rec['ms_per_step']:.1f} ms a step, {rec['tokens_per_s']:.0f} tokens/s; forward "
        f"{forward:.1f} ms (K9 {k9_fwd:.1f}), backward {rec['backward_ms']:.1f} ms (K9 "
        f"recompute {k9_re:.1f}, blockwise attention backward "
        f"{rec['attention_backward_ms']:.1f}), update {update:.1f} ms; peak "
        f"{rec['peak_gib']:.2f} GiB allocated, {rec['peak_reserved_gib']:.2f} GiB reserved; "
        f"bound {bound:.1f} ms ({flops:.3e} model flop at the bf16 peak, "
        f"{100 * rec['bound_share']:.1f}% reached); K8 {rec['k8_ms']:.2f} ms; loss {loss:.4f}, "
        f"gradient norm {norm:.3f}; launches {n}")
    log(f"[lm-train] {cfg.name} {vocab} {policy} train step kernels vs plain on the main path: "
        + held_text(held))
    return rec


@contextlib.contextmanager
def kept_tt_calls(ops, kept: list, calls: int):
    """While open, the first ``calls`` calls of ``ops.tt_pooled_auto`` hand
    their cores, streams, dims and output (detached, on the card) to
    ``kept``."""
    saved = ops.tt_pooled_auto

    def call(*a, **kw):
        out = saved(*a, **kw)
        if len(kept) < calls:
            kept.append((tuple(t.detach() for t in a[:6]), kw["dims"], out.detach()))
        return out

    ops.tt_pooled_auto = call
    try:
        yield kept
    finally:
        ops.tt_pooled_auto = saved


def hold_tt_rows(kept, ref) -> dict:
    """Each kept K5 call's output against its plain version on the same
    cores and (N, 1) streams (``chunked``): fp32 to ``ERR_TOL``, phase 3's
    rule for the fp32 body."""
    recs = []
    for (g1, g2, g3, i1, i2, i3), dims, out in kept:
        with torch.no_grad():
            plain = chunked(ref.tt_bag_ref, (g1, g2, g3), (i1, i2, i3), dims)
        recs.append({"lookups": int(i1.shape[0]),
                     "max_abs_err": float((out.float() - plain.float()).abs().max())})
    err = max(r["max_abs_err"] for r in recs)
    return {"calls": [r["lookups"] for r in recs], "max_abs_err": err, "tolerance": ERR_TOL,
            "ok": err <= ERR_TOL}


def lm_train_tt(dev, mods, totals) -> dict:
    """One step of qwen2-1.5b at full width with the TT vocabulary
    (``tt_exec="pallas"``, the config's rank), 2 microbatches of one
    sequence of 4,096: K5 launches for the tokens and the tied head's
    ``materialize`` of all 151,936 rows, its ms by CUDA events around each
    call, and the first microbatch's two calls held against the plain
    version."""
    from repro_torch.configs import registry
    from repro_torch.kernels import ops, ref
    from repro_torch.models import transformer as T
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as TS

    seq = lmt_shape().seq_len
    cfg = lm_config(LM_MAIN).replace(embedding_kind="tt", tt_exec="pallas")
    gc.collect()
    torch.cuda.empty_cache()
    params, _ = T.init_lm(cfg, seed=0, device=dev)
    step = TS.make_train_step(registry.train_loss_fn(registry.get(LM_MAIN), cfg),
                              opt.OptConfig(**LMT_OPT), microbatches=LMT_MICRO)
    g = torch.Generator(device=dev).manual_seed(8)
    batch = {"tokens": torch.randint(0, cfg.vocab, (LMT_MICRO, seq), generator=g, device=dev,
                                     dtype=torch.int32)}
    take_launches(mods, totals)
    kept = []
    with timed_entries(ops, ("tt_pooled_auto",)) as marks, kept_tt_calls(ops, kept, 2):
        t0 = time.perf_counter()
        params, _state, m = step(params, opt.init(params), batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n = take_launches(mods, totals)
    if n != step_launches(cfg, LMT_MICRO) or not np.isfinite(float(m["loss"])):
        raise AssertionError(f"[lm-train] {cfg.name} tt: launches {n}, loss {float(m['loss'])}")
    calls = [a.elapsed_time(b) for a, b in marks["tt_pooled_auto"]]
    held = hold_tt_rows(kept, ref)
    if not held["ok"]:
        raise AssertionError(f"[lm-train] {cfg.name} tt: K5 vs plain {held}")
    spec = cfg.emb_config.tt_spec
    rec = {"arch": cfg.name, "vocab": "tt", "tt_dims": list(spec.dims), "batch": LMT_MICRO,
           "seq": seq, "ms_per_step": wall * 1e3, "loss": float(m["loss"]), "launches": n,
           "k5_call_ms": calls, "k5_ms": sum(calls), "held": held}
    log(f"[lm-train] {cfg.name} tt vocab (dims {spec.dims}, cores fp32), one step of "
        f"{LMT_MICRO} x 1 x {seq}: {rec['ms_per_step']:.1f} ms (first step, set-up inside), "
        f"loss {rec['loss']:.4f}; K5 launches {n.get('tt_bag')}, ms a call (wrapper, events) "
        + ", ".join(f"{x:.2f}" for x in calls)
        + f"; K5 vs plain on the step's first {len(kept)} calls ({held['calls']} lookups) "
        f"max |diff| {held['max_abs_err']:.2e} (held to {ERR_TOL})")
    del params, _state, kept
    gc.collect()
    torch.cuda.empty_cache()
    return rec


@contextlib.contextmanager
def replayed_routing(moe_mod, routes: tuple):
    """While open, the n-th ``moe.route`` call returns ``routes[0][n]``'s
    ids (another run's, in call order) with the weights renormalized from
    this call's own router probabilities at those ids (differentiable as
    ever), and appends the ids its own top-k picks to ``routes[1]``."""
    saved = moe_mod.route
    replay = iter(routes[0])

    def route(router, x, cfg):
        own, _ = saved(router, x, cfg)
        routes[1].append(own)
        ids = next(replay)
        probs = torch.softmax(x.float().reshape(-1, x.shape[-1]) @ router.float(), dim=-1)
        wts = torch.gather(probs, 1, ids.long())
        return ids, wts / torch.clamp(wts.sum(dim=-1, keepdim=True), min=1e-9)

    moe_mod.route = route
    try:
        yield
    finally:
        moe_mod.route = saved


@contextlib.contextmanager
def plain_lm_path(fa, qg, tg, ref):
    """While open, each kernel the model's entries launch is its plain
    version on the card: K9's forward ``ref.flash_fwd_ref`` (fp32 softmax,
    rounded to q's dtype), K8 ``ref.qr_lookup_ref``, K5 ``ref.tt_bag_ref``;
    everything around them stays as it is, the backwards too (K9's
    blockwise recompute, the lookups' chunked fp32 recompute)."""
    saved = {(fa, "flash_fwd"): fa.flash_fwd, (qg, "qr_gather"): qg.qr_gather,
             (tg, "tt_bag"): tg.tt_bag}
    fa.flash_fwd = lambda q, k, v, *, causal=True, p_bf16=False: (
        fa.layers.flash_attention(q, k, v, causal=causal, p_dtype=torch.bfloat16).to(q.dtype)
        if p_bf16 else ref.flash_fwd_ref(q, k, v, causal=causal))
    qg.qr_gather = lambda q, r, qi, ri, **kw: ref.qr_lookup_ref(q, r, qi, ri)
    tg.tt_bag = lambda g1, g2, g3, i1, i2, i3, *, dims: ref.tt_bag_ref(g1, g2, g3, i1, i2, i3,
                                                                       dims=dims)
    try:
        yield
    finally:
        for (mod, name), f in saved.items():
            setattr(mod, name, f)


def lm_train_grad_check(dev, mods, totals, arch: str = LM_MAIN, vocabs=LMT_VOCABS,
                        tag: str = "[lm-train]", depth: int = LMT_GRAD[0],
                        compute: str = "bfloat16", hold: bool = True) -> dict:
    """Step-1 gradients of ``arch`` (qwen2-1.5b) at full width cut to
    ``depth`` layers (``LMT_GRAD``; ``compute`` bf16, remat ``full``) on
    ``LMT_GRAD`` sequences of 4,096, through the kernels (K9, K8 for QR, K5
    for TT) against the same step through their plain versions on the card
    (``plain_lm_path``): each leaf within ``GRAD_TOL`` of its scale (phase
    7's bound; without ``hold`` read, not held; whisper's key biases of
    their weights', ``key_bias_scale``).  Only the kernels'
    forwards differ between the two, each within one rounding of the
    other's.  An MoE layer would route the
    tokens whose top-k margin lies below that rounding either way, and
    each such flip moves the drop boundary of two experts' queues: so the
    plain path takes the kernel path's routing (``replayed_routing``: its
    ids, the weights from the plain path's own probabilities), and the
    tokens its own top-k would have routed otherwise are counted."""
    from repro_torch.configs import registry
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import qr_gather as qg
    from repro_torch.kernels import ref
    from repro_torch.kernels import tt_gather as tg
    from repro_torch.train import train_step as TS

    from repro_torch.models import moe as moe_mod

    b = LMT_GRAD[1]
    seq = lmt_shape().seq_len
    out = {}
    for vocab in vocabs:
        cfg = with_depth(lm_config(arch), depth).replace(embedding_kind=vocab, tt_exec="pallas",
                                                         compute_dtype=compute)
        params, _ = registry.init_fn(registry.get(arch))(cfg, seed=0, device=dev)
        loss_fn = registry.train_loss_fn(registry.get(arch), cfg)
        g = torch.Generator(device=dev).manual_seed(9)
        batch = lm_batch_for(cfg, b, seq, g, dev)
        take_launches(mods, totals)
        routes = ([], [])
        with kept_calls(moe_mod, "route", lambda a, o: routes[0].append(o[0])):
            loss_k, _, g_kernel = TS.value_and_grad(loss_fn, params, batch)
        torch.cuda.synchronize()
        n = take_launches(mods, totals)
        with plain_lm_path(fa, qg, tg, ref), replayed_routing(moe_mod, routes):
            loss_p, _, g_plain = TS.value_and_grad(loss_fn, params, batch)
        torch.cuda.synchronize()
        if take_launches(mods, totals) or n != step_launches(cfg, 1):
            raise AssertionError(f"{tag} grad check {vocab}: launches {n}")
        worst, where = leaf_scale_errors(
            g_kernel, g_plain, key_bias_scale if cfg.is_encoder_decoder else None)
        out[vocab] = {"layers": depth, "batch": b, "seq": seq, "compute": compute, "held": hold,
                      "rel_err": worst, "leaf": where, "loss_kernel": float(loss_k),
                      "loss_plain": float(loss_p), "launches": n}
        flips = ""
        if cfg.num_experts:
            out[vocab]["routing_differs"] = sum(int((x != y).any(-1).sum())
                                                for x, y in zip(*routes))
            out[vocab]["routed_tokens"] = sum(x.shape[0] for x in routes[0])
            flips = (f"; the plain path on the kernel path's routing (its own top-k differs "
                     f"for {out[vocab]['routing_differs']} of {out[vocab]['routed_tokens']} "
                     f"token-layer calls, recompute included)")
        if hold and not worst <= GRAD_TOL:
            raise AssertionError(f"{tag} step-1 gradient {vocab} {where}: kernel vs "
                                 f"plain {worst}{flips}")
        log(f"{tag} {cfg.name} {vocab} vocab at {depth} layers, {b} x {seq}, "
            f"{ {'float32': 'fp32', 'bfloat16': 'bf16'}[compute]}: step-1 gradients "
            f"kernels vs plain on the card {worst:.2e} of scale (worst {where}; "
            f"{'held to' if hold else 'read, not held; bound'} {GRAD_TOL}), loss "
            f"{float(loss_k):.6f} / {float(loss_p):.6f}; launches {n}" + flips)
        del params, g_kernel, g_plain
        gc.collect()
        torch.cuda.empty_cache()
    return out


def lm_train_fitted(dev, arch: str, vocab: str, mods, totals, tag: str = "[lm-train]",
                    steps: int = LMT_FIT_STEPS, depth: int | None = None, batch_size: int = 1,
                    microbatches: int = 1) -> dict:
    """``arch`` at full width with a ``vocab`` vocabulary, S 4,096,
    ``batch_size`` sequences (1) in ``microbatches`` (1), at ``depth`` or,
    without one, at the depth that fits: the dry run's traces of a step at
    ``LMT_DEPTHS`` layers give a line, fixed + slope x layers, of the
    params, the AdamW state and the bytes the step allocates (gradients,
    the functional update's new copies, the activations); the depth is the
    largest whose line fits the free memory less ``LM_HEADROOM``, confirmed
    by a third trace (where the first step runs out of memory, an eighth
    fewer layers, each recorded).  The steps' measured peak is held to the
    traced step's (``hold_peak``).  ``steps`` steps (``LMT_FIT_STEPS``) on one
    batch: losses finite; ms a step and tokens/s of the steps after the
    first (host clock); the last step split by CUDA events into the forward
    (around the loss), the update (around ``optimizer.update``) and the
    backward (the rest), K9's ms and an MoE config's MoE ms (forward and
    recompute) in it, peak memory."""
    from repro_torch.configs import registry
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as TS

    seq = lmt_shape().seq_len
    binding = registry.get(arch)
    init = registry.init_fn(binding)
    full = lm_config(arch).replace(embedding_kind=vocab)
    g = torch.Generator(device=dev).manual_seed(10)
    batch = lm_batch_for(full, batch_size, seq, g, dev)
    ocfg = opt.OptConfig(**LMT_FIT_OPT)

    mbatch = dryrun.to_meta(batch)
    traced = {}

    def traced_step(layers: int) -> int:
        """The step's transient peak at ``layers`` (the dry run), kept."""
        if layers not in traced:
            cfg = with_depth(full, layers)
            params, _ = init(cfg, seed=0, device="meta")
            state = opt.init(params)
            step = TS.make_train_step(registry.train_loss_fn(binding, cfg), ocfg,
                                      microbatches=microbatches)
            traced[layers] = (dryrun.storage_bytes(params, state),
                              dry(lambda: step(params, state, mbatch), inference=False))
        return sum(traced[layers])

    fit = {}
    if depth is None:
        fit = dry_fit(traced_step, free_budget(dev), depth_of(full), sizes=LMT_DEPTHS)
        depth = fit["size"]
    fwd, upd = [], []
    saved_update = TS.opt_mod.update

    def timed_update(*a, **kw):
        e = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        e[0].record()
        out = saved_update(*a, **kw)
        e[1].record()
        upd.append(e)
        return out

    too_big = []
    while True:         # the first step confirms the fit, as in ``lm_train_main``
        cfg = with_depth(full, depth)
        take_launches(mods, totals)
        params, _ = init(cfg, seed=0, device=dev)
        state = opt.init(params)
        loss_fn = registry.train_loss_fn(binding, cfg)

        def timed_loss(p, b):
            e = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            e[0].record()
            out = loss_fn(p, b)
            e[1].record()
            fwd.append(e)
            return out

        step = TS.make_train_step(timed_loss, ocfg, microbatches=microbatches)
        losses, secs = [], []
        base = peak_base(dev)
        try:
            for i in range(steps):
                last = i == steps - 1
                fwd.clear()
                upd.clear()
                TS.opt_mod.update = timed_update
                with timed_entries(ops, ("flash_attention_fused",)) as marks, \
                        (moe_watch(cfg) if last else contextlib.nullcontext()) as watch:
                    start = torch.cuda.Event(enable_timing=True)
                    start.record()
                    t0 = time.perf_counter()
                    params, state, m = step(params, state, batch)
                    losses.append(float(m["loss"]))
                    torch.cuda.synchronize()
                    secs.append(time.perf_counter() - t0)
            break
        except torch.OutOfMemoryError:
            if depth == 1 or secs or not fit:
                raise
            too_big.append(depth)
        finally:
            TS.opt_mod.update = saved_update
        del params, state
        gc.collect()
        torch.cuda.empty_cache()
        depth -= max(1, depth // 8)
    traced_step(depth)
    held_peak = hold_peak(f"{full.name} {full.embedding_kind} train_4k {batch_size} x {seq} at "
                          f"{depth} layers", traced[depth][1], base, dev)
    n = take_launches(mods, totals)
    want = {k: v * steps for k, v in step_launches(cfg, microbatches).items()}
    if n != want or not np.isfinite(losses).all():
        raise AssertionError(f"{tag} {full.name}: launches {n}, losses {losses}")
    later = secs[1:] or secs
    total = start.elapsed_time(upd[-1][1])
    forward, update = event_ms(fwd), event_ms(upd)
    rec = {"arch": full.name, "vocab": full.embedding_kind, "layers": depth,
           "full_layers": depth_of(full), "seq": seq, "batch": batch_size,
           "microbatches": microbatches, "out_of_memory_at": too_big, "fit": fit,
           "peak_hold": held_peak, "losses": losses,
           "step_s": secs, "ms_per_step": 1e3 * sum(later) / len(later),
           "tokens_per_s": batch_size * seq * len(later) / sum(later), "event_ms": total,
           "forward_ms": forward, "backward_ms": total - forward - update, "update_ms": update,
           "k9_ms": event_ms(marks["flash_attention_fused"]),
           "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30, "launches": n}
    moe = ""
    if cfg.num_experts:
        rec["moe"] = moe_drops(watch)
        moe = (f", MoE layers {rec['moe']['moe_ms']:.1f} ms in forward and recompute, "
               f"{100 * rec['moe']['dropped_share']:.2f}% of assignments dropped")
    fitted = (f"{fmt_fit(fit)}; out of memory at {too_big or 'none'}" if fit
              else "a depth given")
    log(f"{tag} {full.name} {full.embedding_kind} vocab ({depth} of {depth_of(full)} "
        f"{'encoder + decoder ' if full.is_encoder_decoder else ''}layers: "
        f"{fitted}), {batch_size} x {seq} in {microbatches} microbatch(es), {steps} steps on "
        f"one batch: losses {', '.join(f'{x:.4f}' for x in losses)}; "
        f"{rec['ms_per_step']:.1f} ms a step, {rec['tokens_per_s']:.0f} tokens/s"
        f"{' after the first' if len(secs) > 1 else ''}; the last step (events) forward "
        f"{forward:.1f} ms, backward {rec['backward_ms']:.1f} ms, update {update:.1f} ms, K9 "
        f"{rec['k9_ms']:.1f} ms{moe}; peak {rec['peak_gib']:.2f} GiB; launches {n}")
    del params, state
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def lm_train_dots_check(dev, mods, totals) -> dict:
    """Remat ``dots`` at the gradient check's cut (``LMT_GRAD``, QR
    vocabulary, bf16): the step-1 gradients against remat ``full``'s on the
    same params and tokens, read for bitwise equality (``dots`` keeps the
    products ``full`` recomputes with the same kernels) and held to
    ``GRAD_TOL`` of each leaf's scale; each policy's forward + backward ms
    (events) and peak."""
    from repro_torch import tree
    from repro_torch.configs import registry
    from repro_torch.models import transformer as T
    from repro_torch.train import train_step as TS

    depth, b = LMT_GRAD
    seq = lmt_shape().seq_len
    base = lm_config(LM_MAIN).replace(num_layers=depth, embedding_kind="qr")
    params, _ = T.init_lm(base, seed=0, device=dev)
    g = torch.Generator(device=dev).manual_seed(9)
    batch = {"tokens": torch.randint(0, base.vocab, (b, seq), generator=g, device=dev,
                                     dtype=torch.int32)}
    grads, rec = {}, {"layers": depth, "batch": b, "seq": seq}
    for policy in ("full", "dots"):
        cfg = base.replace(remat_policy=policy)
        take_launches(mods, totals)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        e = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        e[0].record()
        _, _, grads[policy] = TS.value_and_grad(registry.train_loss_fn(registry.get(LM_MAIN),
                                                                       cfg), params, batch)
        e[1].record()
        torch.cuda.synchronize()
        n = take_launches(mods, totals)
        if n != step_launches(cfg, 1):
            raise AssertionError(f"[lm-train] dots check {policy}: launches {n}")
        rec[policy] = {"ms": e[0].elapsed_time(e[1]),
                       "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
    worst, where = leaf_scale_errors(grads["dots"], grads["full"])
    rec.update(rel_err=worst, leaf=where, bitwise=all(
        torch.equal(x, y) for x, y in zip(tree.leaves(grads["dots"]),
                                          tree.leaves(grads["full"]))))
    log(f"[lm-train] {base.name} qr vocab at {depth} layers, {b} x {seq}: remat dots vs full "
        f"step-1 gradients {worst:.2e} of scale (worst {where or 'none'}; held to {GRAD_TOL}), "
        f"bitwise {rec['bitwise']}; forward + backward {rec['dots']['ms']:.1f} / "
        f"{rec['full']['ms']:.1f} ms, peak {rec['dots']['peak_gib']:.2f} / "
        f"{rec['full']['peak_gib']:.2f} GiB")
    if not worst <= GRAD_TOL:
        raise AssertionError(f"[lm-train] dots vs full: {rec}")
    del params, grads
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def lm_train_phase(dev, by_name, mods) -> dict:
    """Phase 12: the dense transformer trained on one card.  ``[lm-train-ref]``
    on the smoke configs; qwen2-1.5b at full width and depth, S 4,096, with
    the QR vocabulary under remat ``full``; one TT step; the step-1
    gradient check at 2 layers; remat ``dots`` against ``full`` at that
    cut; each section's seconds logged.  The phase's launches add to the ``flash_fwd``,
    ``qr_gather`` and ``tt_bag`` rows.  Returns the ``{"lm_training": ...}``
    record."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[lm-train] before the phase: {torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB "
        f"allocated, {torch.cuda.mem_get_info(dev)[0] / 2**30:.2f} GiB free; the allocator runs "
        f"with {LMT_ALLOCATOR} for the phase")
    totals = {}
    reset_all(mods)
    torch.cuda.memory._set_allocator_settings(LMT_ALLOCATOR)
    record = {"allocator": LMT_ALLOCATOR, "section_s": {}}
    try:
        for key, run in (
                ("ref", lambda: lm_train_ref(dev, mods, totals)),
                ("main", lambda: [lm_train_main(dev, vocab, policy, mods, totals)
                                  for vocab, policy in LMT_MAIN]),
                ("tt", lambda: lm_train_tt(dev, mods, totals)),
                ("grad_check", lambda: lm_train_grad_check(dev, mods, totals)),
                ("dots", lambda: lm_train_dots_check(dev, mods, totals))):
            t1 = time.perf_counter()
            record[key] = run()
            record["section_s"][key] = time.perf_counter() - t1
            log(f"[lm-train] section {key}: {record['section_s'][key]:.1f} s")
    finally:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.memory._set_allocator_settings("expandable_segments:False")
    record["launches"] = totals
    for name in ("flash_fwd", "qr_gather", "tt_bag"):
        by_name[name]["launches"] += totals.get(name, 0)
    record["phase_s"] = time.perf_counter() - t0
    log(f"[lm-train] phase {record['phase_s']:.1f} s; launches {totals}")
    return record


# ---------------------------------------------------------------------------
# phase 13: the LM trained on a mesh
# ---------------------------------------------------------------------------

LMM_TIMEOUT_S = 600
LMM_WORLD1 = (2, 2)        # layers, sequences of the world-1 check (S 4,096)
# (1, 2)'s microbatch, a constant chosen for the script's time, not fitted:
# each sequence adds about six gloo all-reduces of a 12.6 MB bf16 activation
# a layer through the host (~20 ms each, the combine rate phase 9 reads),
# ~3.5 s a sequence a step at 28 layers.  Memory holds more (4 sequences
# peaked at 23.6 GiB a rank on an H100 80GB); below 4 sequences a rank's
# reserved memory reads flat (the layers' gradients set the peak), so a
# line through two small microbatches bounds nothing, and one through
# phase 12's ``LMT_FIT`` sizes would cost ~35 s of gloo to pick a size the
# script could not take
LMM_MICROBATCH = 1
# the (2, 2) run's depth, a constant for the script's time: the line through
# depths 1 and 2 (four ranks' reserved memory) fitted 10-11 of 28 layers in
# every run where it ran (NVIDIA H100 80GB HBM3) and cost ~15 s of probes;
# the steps and the single-card bf16 gradient references scale with it
LMM_DENSE_LAYERS = 6
LMM_GRAD32_LAYERS = 2      # the (2, 2) fp32 step-1 gradient check's depth
LMM_STEPS = 2
# the (2, 2) run's split steps after its held FSDP step (``lmm_fsdp_step``,
# itself a timed step): one, whose gradients the bf16 check reads, to keep
# phase 13 in the time it took before FSDP's gathers through gloo
LMM_DP_STEPS = 1
LMM_OPT = dict(lr=3e-4, warmup_steps=1, total_steps=LMM_STEPS)
# an FSDP step's loss and gradient norm (``make_train_step``'s) against the
# single card's in the same bf16 compute on the same params and tokens,
# relative: phase 14's bound on the meshed MoE losses (``MOE_LOSS_TOL``).
# The norm reads a gradient that is dropped, doubled or not reduced over
# ``data`` at the scale of its leaf.  qwen2-1.5b's loss at the cut read
# 2.9e-06 from the single card's (NVIDIA H100 80GB HBM3, 700 W)
LMM_LOSS_TOL = 2e-2
# the fp32 meshed step-1 gradients against the single card's on the same
# data partition (each data block's gradient, averaged), of each leaf's
# scale: the tensor-parallel products sum their partials in another order
# (tests/test_torch_lm_mesh_train.py's bound).  Against the single card in
# one pass over the batch the token reductions run in another order too
# and read 1.03e-05 at full width (NVIDIA H100 80GB HBM3, 700 W): recorded
LMM_FP32_TOL = 1e-5
# The bf16 meshed step-1 gradients at the cut are held against the exact
# ones, the single card's in fp32 compute on the same params and tokens.
# The mesh rounds where the single card does (every bf16 product, K9's
# output, the norms' casts) and once more at each combine: a row-parallel
# product (wo, w_down) rounds every rank's partial to bf16 before the
# combine adds them, where the single card rounds the whole sum once; the
# loss and every gradient reduction run in fp32.  So the mesh's bf16
# gradients may stand up to twice as far from the exact ones as the single
# card's bf16 gradients do (the worst leaf's share of its scale, both
# measured in the same run); a dropped, doubled or misplaced partial reads
# at the scale of the leaf, as the fp32 check at 2 layers shows to 1e-5.
LMM_BF16_FACTOR = 2.0
# the MoE step on the (2, 2) ranks after qwen2's: granite-moe-3b-a800m at
# full width, 2 of 32 layers, one sequence of 1,024 tokens a data rank; its
# 40 experts split 20 a rank over ``model`` and along ``embed`` over
# ``data`` (FSDP).  Its vocabulary is the config's dense one, as the dry
# run's ``train_4k`` cells trace it: a meta trace cannot run the QR
# vocabulary's routed recompute (which accesses it keeps depends on the
# index values, ``ops._recompute``), so a QR step's peak has no trace
LMM_MOE = ("granite-moe-3b-a800m", 2, 1, 1024)
def lm_binding(cfg):
    """The registry's binding of ``cfg`` (a full-width config, cut or not,
    or a smoke one)."""
    from repro_torch.configs import registry

    return registry.get(cfg.name.removesuffix("-smoke"))


def lm_init(cfg, dev) -> tuple:
    """``cfg``'s params (seed 0) and logical axes, its family's ``init_fn``."""
    from repro_torch.configs import registry

    return registry.init_fn(lm_binding(cfg))(cfg, seed=0, device=dev)


def lmm_tokens(cfg, batch: int, seq: int, dev, seed: int = 7) -> dict:
    """The global batch of a phase 13 check (the same on every rank)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return {"tokens": torch.randint(0, cfg.vocab, (batch, seq), generator=g, device=dev,
                                    dtype=torch.int32)}


def lm_mesh_world1(dev, mods, totals, arch: str = LM_MAIN, tag: str = "[lm-mesh]") -> dict:
    """World 1 over nccl in this process, mesh (1, 1): ``arch`` (qwen2-1.5b)
    at full width cut to ``LMM_WORLD1`` layers (QR vocabulary, ``twolevel``, bf16,
    remat ``full``), S 4,096: the meshed step (the two-level GnR, the
    tensor-parallel layers, the vocab-parallel loss, every collective over a
    group of one) against phase 12's single-card step from the same params
    and tokens: step-1 gradients, loss, gradient norm and new params, each
    read for bitwise equality and held to ``LMM_FP32_TOL`` of scale."""
    import datetime

    import torch.distributed as dist

    from repro_torch import tree
    from repro_torch.configs import registry
    from repro_torch.distributed import collectives
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import mesh as M
    from repro_torch.models import transformer as T
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as TS

    depth, b = LMM_WORLD1
    seq = lmt_shape().seq_len
    binding = registry.get(arch)
    cfg = lm_config(arch).replace(num_layers=depth, embedding_kind="qr",
                                  embedding_exec="twolevel")
    params, axes = T.init_lm(cfg, seed=0, device=dev)
    batch = lmm_tokens(cfg, b, seq, dev)
    loss_fn = registry.train_loss_fn(binding, cfg)
    ocfg = opt.OptConfig(**LMM_OPT)
    take_launches(mods, totals)
    loss_s, _, g_single = TS.value_and_grad(loss_fn, params, batch)
    new_s, _, m_s = TS.make_train_step(loss_fn, ocfg)(params, opt.init(params), batch)
    torch.cuda.synchronize()
    single_launches = take_launches(mods, totals)
    rdv = ROOT / "build" / "lm_mesh" / "rdv_world1"
    rdv.parent.mkdir(parents=True, exist_ok=True)
    rdv.unlink(missing_ok=True)
    log("[mesh] 1 rank, mesh (1, 1) over ('data', 'model'), backend nccl, on 1 card "
        "(in process)")
    dist.init_process_group("nccl", init_method=f"file://{rdv}", world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=120))
    try:
        mesh = M.make_mesh((1, 1), ("data", "model"), device=dev)
        specs = SH.tree_specs(params, axes, mesh, SH.lm_param_rules(cfg, mesh))
        local = SH.shard_tree(params, specs, mesh)
        collectives.reset_counts()
        loss_m, _, g_mesh = TS.meshed_grads(loss_fn, local, batch, mesh, specs)
        sites = {f"{k[0]}/{k[1]}": v[0] for k, v in collectives.SITES.items()}
        new_m, _, m_m = TS.make_train_step(loss_fn, ocfg, mesh=mesh, specs=specs)(
            local, opt.init(local), batch)
        torch.cuda.synchronize()
        n = take_launches(mods, totals)
        got = [SH.gather(x, s, mesh) for x, s in zip(tree.leaves(g_mesh), specs)]
        errs = leaf_errors(got, tree.leaves(g_single))
        bitwise = {
            "grads": all(torch.equal(a, w) for a, w in zip(got, tree.leaves(g_single))),
            "params": all(torch.equal(SH.gather(a, s, mesh), w) for a, w, s in
                          zip(tree.leaves(new_m), tree.leaves(new_s), specs)),
            "loss": torch.equal(loss_m, loss_s), "step_loss": torch.equal(m_m["loss"], m_s["loss"]),
            "grad_norm": torch.equal(m_m["grad_norm"], m_s["grad_norm"])}
        del local, g_mesh, new_m
        serving = lms_world1(cfg, params, axes, mesh, batch)
        torch.cuda.synchronize()
        serving["launches"] = take_launches(mods, totals)
    finally:
        dist.destroy_process_group()
    want = {k: 2 * v for k, v in step_launches(cfg, 1).items()}
    rec = {"mesh": [1, 1], "backend": "nccl", "arch": cfg.name, "layers": depth, "batch": b,
           "seq": seq, "vocab": "qr", "embedding_exec": "twolevel",
           "step1_grad_rel_err_max": max(errs), "bitwise": bitwise,
           "loss": float(loss_m), "loss_single_card": float(loss_s),
           "grad_norm": float(m_m["grad_norm"]), "grad_norm_single_card": float(m_s["grad_norm"]),
           "collectives_of_the_gradient": sites, "launches": n,
           "launches_single_card": single_launches, "serving": serving}
    log(f"{tag} world 1 nccl {cfg.name} at {depth} layers, {b} x {seq}, QR twolevel bf16: "
        f"step-1 gradients vs the single card {max(errs):.3g} of scale; bitwise {bitwise}; "
        f"loss {rec['loss']:.6f} vs {rec['loss_single_card']:.6f}, grad norm "
        f"{rec['grad_norm']:.6f} vs {rec['grad_norm_single_card']:.6f}; collectives {sites}; "
        f"launches {n} (single card {single_launches})")
    log(f"{tag} world 1 nccl served at {depth} layers, {b} x {seq} prompts + "
        f"{serving['steps']} greedy steps, the mesh against the single card: bitwise "
        f"{serving['bitwise']}; launches {serving['launches']}")
    if (not max(errs) <= LMM_FP32_TOL or n != want or single_launches != want
            or not all(serving["bitwise"].values())):
        raise AssertionError(f"{tag} world 1 nccl: {rec}")
    del params, g_single, got, new_s
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def lmm_place(cfg, mesh, dev, serve: bool = False):
    """``cfg``'s params (seed 0) placed on ``mesh`` (``registry.lm_specs``:
    the training layout, FSDP over ``data``; with ``serve`` the serving
    one, ``embed`` whole): (this rank's blocks, their specs, the logical
    axes); the full tree is freed."""
    from repro_torch.configs import registry
    from repro_torch.distributed import sharding as SH

    params, axes = lm_init(cfg, dev)
    specs = registry.lm_specs(cfg, params, axes, mesh, serve=serve)
    local = SH.shard_tree(params, specs, mesh)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return local, specs, axes


def lmm_steps(local, specs, cfg, batch, mesh, mods, steps: int = LMM_STEPS,
              keep_grads: bool = False) -> dict:
    """``steps`` meshed steps on this rank's ``batch`` block, each split
    into forward, backward, gradient mean and update (``_split_step``):
    host ms of each step and split, losses and norms, K9 and K8 ms a call
    (CUDA events around each ``ops`` entry) and launches, collectives and
    bytes all-reduced a step by site and axis, peak memory; the first
    step's layer-0 K9 q/k/v and K8 calls held against their plain versions
    (``hold_kept``), K8 also for bitwise equality with the plain sum in the
    tables' dtype.  With ``keep_grads``, the first step's data-averaged
    gradients (the step-1 gradients), gathered whole on the writer (rank
    (0, 0)) alone, on the host, under "grads" (None elsewhere)."""
    from repro_torch import tree
    from repro_torch.configs import registry
    from repro_torch.distributed import collectives
    from repro_torch.distributed import sharding as SH
    from repro_torch.kernels import ops
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as TS

    dev = mesh.device
    loss_fn = registry.train_loss_fn(registry.get(LM_MAIN), cfg)
    ocfg = opt.OptConfig(**LMM_OPT)
    state = opt.init(local)
    rec = {"step_ms": [], "losses": [], "norms": [], "split_host_ms": [], "split_event_ms": []}
    kept = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    collectives.reset_counts()
    reset_all(mods)
    with timed_entries(ops, ("flash_attention_fused", "qr_lookup")) as marks:
        for i in range(steps):
            ctx = kept_model_path(ops, kept) if i == 0 else contextlib.nullcontext()
            t = time.perf_counter()
            with ctx:
                local, state, m, grads, host, event = _split_step(
                    local, state, batch, loss_fn, ocfg, mesh, specs, opt, TS, tree)
            torch.cuda.synchronize()
            rec["step_ms"].append((time.perf_counter() - t) * 1e3)
            rec["losses"].append(float(m["loss"]))
            rec["norms"].append(float(m["grad_norm"]))
            rec["split_host_ms"].append(host)
            rec["split_event_ms"].append(event)
            if i == 0:
                first = grads if keep_grads else None
            del grads
        torch.cuda.synchronize()
        rec["k9_ms_a_call"] = event_ms(marks["flash_attention_fused"]) / max(
            len(marks["flash_attention_fused"]), 1)
        rec["k8_ms_a_call"] = (event_ms(marks["qr_lookup"]) / len(marks["qr_lookup"])
                               if marks["qr_lookup"] else None)
    rec["launches"] = {k: v for k, v in launches_now(mods).items() if v}
    rec["sites"] = {f"{k[0]}/{k[1]}": [v[0] // steps, v[1] // steps]
                    for k, v in collectives.SITES.items()}
    rec["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    rec["held"] = hold_kept(kept, f"{cfg.name} mesh {tuple(mesh.shape.values())} rank "
                                  f"{tuple(mesh.coords.values())}")
    if "k8" in rec["held"] and not rec["held"]["k8"]["all_bitwise"]:
        raise AssertionError(f"[lm-mesh] K8 on the routed streams is not bitwise the plain "
                             f"sum: {rec['held']['k8']}")
    if keep_grads:
        writer = not any(mesh.coords.values())
        rec["grads"] = [] if writer else None
        for x, sp in zip(tree.leaves(first), specs):
            leaf = SH.gather(x, sp, mesh)
            if writer:
                rec["grads"].append(leaf.cpu())
            del leaf
        del first
    del kept, state, local
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def lm_mesh_rank(mesh, what: str, serve: dict) -> dict:
    """Phase 13 on one rank of a gloo mesh on the card.  ``what`` "tp": the
    (1, 2) run, qwen2-1.5b at full width and depth, QR vocabulary
    ``twolevel``, remat ``full``, S 4,096, ``LMM_MICROBATCH`` sequences a
    ``data`` rank, one untimed forward and backward, then ``lmm_steps``
    with the kernels held.  "dp": the (2, 2) run with the dense vocabulary,
    FSDP over ``data``: the fp32 step-1 gradients at ``LMM_GRAD32_LAYERS``
    layers (one sequence a ``data`` rank); at ``LMM_DENSE_LAYERS`` the held
    ``make_train_step`` step (``lmm_fsdp_step``), then ``lmm_steps``, whose
    first step gives the bf16 step-1 gradients; granite-moe's held step.
    Gradients come back gathered to the logical shapes on the writer (rank
    (0, 0)) alone, on the host.  Then each serves
    ``serve``'s prompts (``lms_rank``; the (1, 2) run with the dry run's
    peak hold)."""
    from repro_torch import tree
    from repro_torch.configs import registry
    from repro_torch.data import synthetic
    from repro_torch.distributed import sharding as SH
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import qr_gather as qg
    from repro_torch.train import train_step as TS

    torch.backends.cuda.matmul.allow_tf32 = False
    mods = (fa, qg)
    dev = mesh.device
    writer = not any(mesh.coords.values())
    seq = lmt_shape().seq_len
    full = lm_config(LM_MAIN)
    binding = registry.get(LM_MAIN)
    data = mesh.shape["data"]
    res = {"coords": dict(mesh.coords)}

    def grads_of(cfg, local, specs, batch) -> tuple:
        loss, _, g = TS.meshed_grads(registry.train_loss_fn(binding, cfg), local, batch, mesh,
                                     specs)
        out = [] if writer else None
        for x, s in zip(tree.leaves(g), specs):
            leaf = SH.gather(x, s, mesh)
            if writer:
                out.append(leaf.cpu())
            del leaf
        del g
        return out, float(loss)

    if what == "tp":
        cfg = full.replace(embedding_kind="qr", embedding_exec="twolevel")
        local, specs, _ = lmm_place(cfg, mesh, dev)
        batch = synthetic.data_block(lmm_tokens(cfg, LMM_MICROBATCH * data, seq, dev), mesh)
        # one untimed forward and backward first: a fresh rank's first pass
        # (allocator growth, gloo's buffers, first calls) took 18.0 s where
        # the next step took 6.8 s (H100 80GB HBM3), and would be averaged in
        fn = TS.meshed_loss(registry.train_loss_fn(binding, cfg), mesh, specs)
        leaves = [p.detach().requires_grad_(True) for p in tree.leaves(local)]
        with torch.enable_grad():
            loss, _ = fn(tree.unflatten(local, leaves), batch)
        torch.autograd.grad(loss, leaves)
        del leaves, loss
        res["steps"] = lmm_steps(local, specs, cfg, batch, mesh, mods)
        res["layers"], res["microbatch"] = cfg.num_layers, LMM_MICROBATCH
        del local, batch
        res["serve"] = lms_rank(mesh, cfg, serve, mods, dry_hold=True)
        return res

    # "dp": the dense vocabulary on (2, 2)
    cfg32 = full.replace(num_layers=LMM_GRAD32_LAYERS, embedding_kind="dense",
                         compute_dtype="float32")
    local, specs, _ = lmm_place(cfg32, mesh, dev)
    res["paths"] = [p for p, _ in tree.leaves_with_paths(local)]
    batch = synthetic.data_block(lmm_tokens(cfg32, data, seq, dev), mesh)
    res["grads32"], res["loss32"] = grads_of(cfg32, local, specs, batch)
    del local
    gc.collect()
    torch.cuda.empty_cache()

    cfg = full.replace(embedding_kind="dense", num_layers=LMM_DENSE_LAYERS)
    local, specs, _ = lmm_place(cfg, mesh, dev)
    batch = synthetic.data_block(lmm_tokens(cfg, data, seq, dev), mesh)
    # the held FSDP step (the program's make_train_step; its update is
    # dropped), then the split step from the same params, whose gradients
    # are the bf16 step-1 gradients (``LMM_DP_STEPS``)
    res["fsdp"] = lmm_fsdp_step(local, specs, cfg, batch, mesh, writer)
    res["steps"] = lmm_steps(local, specs, cfg, batch, mesh, mods, steps=LMM_DP_STEPS,
                             keep_grads=True)
    res["grads"], res["loss"] = res["steps"].pop("grads"), res["steps"]["losses"][0]
    res["layers"], res["microbatch"] = cfg.num_layers, 1
    del local, batch
    gc.collect()
    torch.cuda.empty_cache()
    moe = lm_config(LMM_MOE[0]).replace(num_layers=LMM_MOE[1])
    local, specs, _ = lmm_place(moe, mesh, dev)
    batch = synthetic.data_block(lmm_tokens(moe, data * LMM_MOE[2], LMM_MOE[3], dev), mesh)
    res["moe"] = lmm_fsdp_step(local, specs, moe, batch, mesh, writer)
    del local, batch
    gc.collect()
    torch.cuda.empty_cache()
    res["serve"] = lms_rank(mesh, cfg, serve, mods)
    return res


def lmm_fsdp_hold(ranks, shape, refs: dict) -> dict:
    """The (2, 2) ranks' FSDP steps (``lmm_fsdp_step``: qwen2-1.5b at the
    cut, then granite-moe), logged and held: each rank's params + AdamW
    bytes equal to the count of the layout FSDP should give
    (``lmm_state_bytes``' "expected": every ``embed``-split leaf a data
    rank's share), and to the FSDP layout's own count; the collectives a
    step by site and axis; rank (0, 0)'s peak within ``PEAK_TOL`` of the dry
    run's trace (``record_peak``: a miss fails the script at its end); each
    rank's loss and gradient norm within ``LMM_LOSS_TOL`` of the single
    card's on the same params and tokens (``refs``: (loss, norm) a key)."""
    out = {}
    for key in ("fsdp", "moe"):
        got = [r.pop(key) for r in ranks]
        mine = next(g for g, r in zip(got, ranks) if not any(r["coords"].values()))
        tag = f"{mine['arch']} {tuple(shape)} rank (0, 0) FSDP step"
        counts = mine["state_counts"]
        bytes_ok = all(g["state_bytes"] == counts["expected"] == counts["fsdp"] for g in got)
        losses, norms = [g["loss"] for g in got], [g["grad_norm"] for g in got]
        ref_loss, ref_norm = refs[key]
        near = lambda x, want: abs(x - want) <= LMM_LOSS_TOL * abs(want)
        refs_ok = all(near(x, ref_loss) for x in losses) and all(near(x, ref_norm)
                                                                 for x in norms)
        sites = {k: v for k, v in sorted(mine["sites"].items())
                 if k.split("/")[0] in ("fsdp_gather", "fsdp_scatter", "grad_mean")}
        log(f"[lm-mesh] {tag}: params + AdamW {mine['state_bytes'] / 2**30:.3f} GiB a rank, "
            f"{mine['state_bytes'] / counts['tp_only']:.3f}x the tensor-parallel layout's "
            f"{counts['tp_only'] / 2**30:.3f} GiB (expected with every embed-split leaf a data "
            f"rank's share {counts['expected'] / 2**30:.3f} GiB, "
            f"{counts['expected'] / counts['tp_only']:.3f}x; the FSDP specs' count "
            f"{counts['fsdp'] / 2**30:.3f} GiB); every rank at the expected count: {bytes_ok}")
        log(f"[lm-mesh] {tag}: collectives a step by site and axis [calls, bytes a rank]: "
            f"{sites}; all {len(mine['sites'])} sites {mine['sites']}")
        peak = record_peak(tag, mine["peak"], mine["predicted"],
                           mine["reserved_over_allocated"])
        log(f"[lm-mesh] {tag}: {mine['layers']} layers, {mine['vocab']} vocabulary, "
            f"{mine['tokens_a_data_rank']} tokens a data rank, make_train_step "
            f"{mine['step_ms']:.1f} ms (the trace {mine['trace_s']:.1f} s); losses {losses}, "
            f"gradient norms {norms}; the single card's {ref_loss:.6f}, {ref_norm:.6f} (held "
            f"to {LMM_LOSS_TOL:g} relative): {refs_ok}")
        if not (bytes_ok and refs_ok):
            raise AssertionError(f"[lm-mesh] {tag}: state bytes "
                                 f"{[g['state_bytes'] for g in got]} against {counts}, losses "
                                 f"{losses}, norms {norms} against {refs[key]}")
        out[key] = {**{k: mine[k] for k in ("arch", "layers", "vocab", "tokens_a_data_rank",
                                             "state_bytes", "state_counts", "step_ms",
                                             "sites")},
                    "peak_hold": peak, "losses": losses, "grad_norms": norms,
                    "single_card": {"loss": ref_loss, "grad_norm": ref_norm}}
    return out


def lmm_state_bytes(cfg, mesh) -> dict:
    """A rank's params + AdamW state bytes on ``mesh`` (its blocks of the
    params in their dtype, the fp32 moments of each, the int32 step count),
    counted on meta: "fsdp", from the training layout's specs; "tp_only",
    from the serving layout's (tensor parallel alone, ``embed`` whole); and
    "expected", the tensor-parallel blocks with each leaf whose logical
    axes name ``embed`` at a dim the data ranks divide a data rank's share,
    the MoE router (axes ending ``embed``, ``experts``) whole: what FSDP
    over ``data`` should store, found from the logical axes alone."""
    from repro_torch import tree
    from repro_torch.configs import registry
    from repro_torch.distributed import sharding as SH

    params, axes = registry.abstract_params(lm_binding(cfg), cfg)
    data = mesh.shape[SH.FSDP_AXIS]
    one = lambda x: x.numel() * (x.element_size() + 8)
    count = lambda xs: sum(one(x) for x in xs) + 4
    tp = SH.shard_tree(params, registry.lm_specs(cfg, params, axes, mesh, serve=True), mesh)
    embed = SH.tree_specs(params, axes, mesh, {"embed": (SH.FSDP_AXIS,),
                                               SH.WHOLE: (("embed", "experts"),)})
    split = [SH.fsdp_dim(sp, mesh) is not None for sp in embed]
    fsdp = SH.shard_tree(params, registry.lm_specs(cfg, params, axes, mesh), mesh)
    return {"fsdp": count(tree.leaves(fsdp)), "tp_only": count(tree.leaves(tp)),
            "expected": sum(one(x) // (data if s else 1)
                            for x, s in zip(tree.leaves(tp), split)) + 4}


def lmm_fsdp_step(local, specs, cfg, batch, mesh, writer: bool) -> dict:
    """One training step of ``cfg`` on this rank's blocks under the FSDP
    layout, the program's ``make_train_step(mesh=, specs=)`` at microbatch
    1 and ``LMM_OPT``: the loss and gradient norm (every rank's the
    global batch's), the collectives by site and axis, the rank's params +
    AdamW bytes (its tensors' storage) beside ``lmm_state_bytes``' counts,
    and on the writer the step's peak above its baseline beside the dry
    run's trace of this rank on ``abstract_mesh``
    (``launch.dryrun.trace_train``, the same step on meta)."""
    from repro_torch import tree
    from repro_torch.configs import registry
    from repro_torch.distributed import collectives
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as M
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as TS

    dev = mesh.device
    binding = lm_binding(cfg)
    state = opt.init(local)
    held = sum(x.numel() * x.element_size() for x in tree.leaves(local) + tree.leaves(state))
    rec = {"arch": cfg.name, "layers": cfg.num_layers, "vocab": cfg.embedding_kind,
           "tokens_a_data_rank": list(batch["tokens"].shape),
           "state_bytes": held, "state_counts": lmm_state_bytes(cfg, mesh)}
    step = TS.make_train_step(registry.train_loss_fn(binding, cfg), opt.OptConfig(**LMM_OPT),
                              mesh=mesh, specs=specs)
    if writer:
        at = M.abstract_mesh(tuple(mesh.shape.values()), tuple(mesh.shape),
                             tuple(mesh.coords.values()))
        t = time.perf_counter()
        rec["predicted"] = dryrun.trace_train(
            binding, cfg, batch["tokens"].shape[0] * SH.data_ranks(mesh),
            batch["tokens"].shape[1], mesh=at)["transient_peak"]
        rec["trace_s"] = time.perf_counter() - t
    base = peak_base(dev)
    collectives.reset_counts()
    t = time.perf_counter()
    new, state, m = step(local, state, batch)
    torch.cuda.synchronize()
    rec["step_ms"] = (time.perf_counter() - t) * 1e3
    rec["peak"] = torch.cuda.max_memory_allocated(dev) - base
    rec["reserved_over_allocated"] = (torch.cuda.max_memory_reserved(dev)
                                      / max(torch.cuda.max_memory_allocated(dev), 1))
    rec["sites"] = {f"{k[0]}/{k[1]}": list(v) for k, v in collectives.SITES.items()}
    rec["loss"], rec["grad_norm"] = float(m["loss"]), float(m["grad_norm"])
    del new, state, m
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def grad_norm(leaves) -> float:
    """The global L2 norm of a list of gradient leaves, in fp64."""
    return float(np.sqrt(sum(float(x.double().pow(2).sum()) for x in leaves)))


def lmm_single_grads(cfg, batch, dev, blocks: int = 1) -> tuple[list, float]:
    """The single card's step-1 gradients of ``cfg`` (params seed 0) on
    ``batch``, on the host, and the loss.  With ``blocks``, the batch's
    ``data`` partition: each block's gradient (one sequence each here) in
    turn, summed in fp32 and divided by the count, as the mesh's data mean
    and ``make_train_step``'s microbatches average them."""
    from repro_torch import tree
    from repro_torch.configs import registry
    from repro_torch.models import transformer as T
    from repro_torch.train import train_step as TS

    params, _ = T.init_lm(cfg, seed=0, device=dev)
    fn = registry.train_loss_fn(registry.get(LM_MAIN), cfg)
    toks = batch["tokens"]
    per = toks.shape[0] // blocks
    acc, loss = None, 0.0
    for i in range(blocks):
        lb, _, g = TS.value_and_grad(fn, params, {"tokens": toks[i * per:(i + 1) * per]})
        leaves = [x.float() for x in tree.leaves(g)]
        acc = leaves if acc is None else [a.add_(b) for a, b in zip(acc, leaves)]
        loss += float(lb) / blocks
        del g, leaves
    out = [a.div_(blocks).cpu() for a in acc]
    del params, acc
    gc.collect()
    torch.cuda.empty_cache()
    return out, loss


def lmm_record(ranks, shape, vocab: str) -> dict:
    """One mesh's record from its ranks' ``lmm_steps``: ms a step (max over
    ranks, mean of the steps), the split (max over ranks), bytes all-reduced
    a rank a step by axis, collectives a step, peak memory, K9 and K8."""
    st = [r["steps"] for r in ranks]
    per_axis = {}
    for site_axis, (_calls, nbytes) in st[0]["sites"].items():
        axis = site_axis.split("/")[1]
        per_axis[axis] = per_axis.get(axis, 0) + nbytes
    split = {k: max(float(np.mean([s[k] for s in r["split_host_ms"]])) for r in st)
             for k in st[0]["split_host_ms"][0]}
    launches = {}
    for r in st:
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    return {"mesh": list(shape), "backend": "gloo", "vocab": vocab,
            "layers": ranks[0]["layers"], "microbatch_a_data_rank": ranks[0]["microbatch"],
            "seq": lmt_shape().seq_len,
            "losses": st[0]["losses"], "grad_norms": st[0]["norms"],
            "ms_per_step_max_over_ranks": max(float(np.mean(r["step_ms"])) for r in st),
            "step_ms_rank0": st[0]["step_ms"], "split_host_ms_max_over_ranks": split,
            "bytes_all_reduced_per_rank_per_step": per_axis,
            "collectives_per_step": {k: v[0] for k, v in st[0]["sites"].items()},
            "peak_gib_max_over_ranks": max(r["peak_gib"] for r in st),
            "k9_ms_a_call": max(r["k9_ms_a_call"] for r in st),
            "k8_ms_a_call": (max(r["k8_ms_a_call"] for r in st)
                             if st[0]["k8_ms_a_call"] is not None else None),
            "launches_all_ranks": launches, "held": st[0]["held"]}


def lmm_log(rec: dict) -> None:
    split = rec["split_host_ms_max_over_ranks"]
    how = "microbatch and depth constants chosen for the script's time, not fitted"
    log(f"[lm-mesh] {rec.get('arch', LM_MAIN)} mesh {tuple(rec['mesh'])} gloo, {rec['vocab']} vocab, "
        f"{rec['layers']} layers, {rec['microbatch_a_data_rank']} x {rec['seq']} a data rank "
        f"({how}): losses "
        f"{', '.join(f'{x:.4f}' for x in rec['losses'])}; "
        f"{rec['ms_per_step_max_over_ranks']:.1f} ms a step (max over ranks; forward "
        f"{split['forward']:.1f}, backward {split['backward']:.1f}, gradient mean "
        f"{split['grad_reduce']:.1f}, update {split['update']:.1f} ms); all-reduced a rank a "
        f"step {rec['bytes_all_reduced_per_rank_per_step']} B; collectives a step "
        f"{rec['collectives_per_step']}; peak {rec['peak_gib_max_over_ranks']:.2f} GiB a rank; "
        f"K9 {rec['k9_ms_a_call']:.2f} ms a call"
        + (f", K8 {rec['k8_ms_a_call']:.3f} ms a call" if rec["k8_ms_a_call"] else "")
        + f"; launches (all ranks) {rec['launches_all_ranks']}; gloo through the host: "
        f"each layer combines and enters (B, 4,096, 1,536) bf16 partials about six times a "
        f"microbatch")
    log(f"[lm-mesh] mesh {tuple(rec['mesh'])} kernels vs plain on rank (0, 0)'s own calls: "
        + held_text(rec["held"]))


# ---------------------------------------------------------------------------
# phase 13 (and 14): the LM served on a mesh
# ---------------------------------------------------------------------------

# the (1, 2) run: sequences and prompt tokens (all on the one data rank),
# greedy decode steps; gloo combines through the host (~20 ms for 12.6 MB,
# phase 9's rate) put the prefill at ~2-3 s
LMS_PROMPT = (2, 4096)
LMS_STEPS = 8
# the (2, 2) run at ``LMM_DENSE_LAYERS``: one sequence a data rank
LMS_DP_STEPS = 4
# world 1 over nccl (phase 13's two layers, its batch): decode steps held
LMS_WORLD1_STEPS = 4
# granite-moe on phase 14's EP ranks: sequences, prompt tokens, decode steps
MOE_SERVE = (2, 1024, 8)


def lms_prompts(cfg, batch: int, seq: int, seed: int = 11):
    """The prompts of a serving hold, on the host (the same on every rank):
    the tokens, or for a prefix model the batch with its frames or patches
    (``lm_batch_for``)."""
    g = torch.Generator().manual_seed(seed)
    if cfg.is_encoder_decoder or cfg.num_patches:
        return lm_batch_for(cfg, batch, seq, g, "cpu")
    return torch.randint(0, cfg.vocab, (batch, seq), generator=g, dtype=torch.int32)


def serve_batch(prompts, dev=None) -> dict:
    """``lms_prompts``' prompts as a serve family's batch (on ``dev``)."""
    batch = dict(prompts) if isinstance(prompts, dict) else {"tokens": prompts}
    return {k: v.to(dev) for k, v in batch.items()} if dev is not None else batch


def first_pos(batch: dict) -> int:
    """The position of the first decode step after a prefill of ``batch``:
    its tokens, after pixtral's patches."""
    return batch["tokens"].shape[1] + (batch["patches"].shape[1] if "patches" in batch else 0)


@contextlib.contextmanager
def timed_collectives(collectives):
    """While open, the host ms of every all-reduce and all-gather the
    ``collectives`` module issues (the card synchronised first, so the
    time is the collective's own: gloo's copies through the host and its
    wire), summed into the yielded ``{"ms", "calls"}``."""
    rec = {"ms": 0.0, "calls": 0}
    saved = collectives._all_reduce, collectives.all_gather

    def timed(fn):
        def call(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            rec["ms"] += (time.perf_counter() - t) * 1e3
            rec["calls"] += 1
            return out
        return call

    collectives._all_reduce, collectives.all_gather = (timed(f) for f in saved)
    try:
        yield rec
    finally:
        collectives._all_reduce, collectives.all_gather = saved


def lms_steps(fam, params, cfg, logits, cache, pos0: int, steps: int, *, forced=None,
              mesh=None) -> dict:
    """``steps`` decode steps after a prefill whose last logits are
    ``logits``: greedy (``forced`` None) or each step fed ``forced[:, i]``;
    each step's last-row logits (fp32, on the host, (B, steps, V)), the
    tokens fed, and each step's ms on the host clock (synchronised)."""
    rows, fed, ms = [], [], []
    with torch.inference_mode():
        for i in range(steps):
            tok = (torch.argmax(logits[:, -1, :], dim=-1) if forced is None
                   else forced[:, i].to(logits.device))[:, None].to(torch.int32)
            fed.append(tok[:, 0].cpu())
            t = time.perf_counter()
            logits, cache = fam.decode(params, cache, tok, pos0 + i, cfg, mesh=mesh)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
            rows.append(logits[:, -1].float().cpu())
    return {"logits": torch.stack(rows, 1), "tokens": torch.stack(fed, 1), "step_ms": ms}


def lms_single(cfg, toks, steps: int, dev, fp64: bool = False) -> dict:
    """The single card's serving of ``cfg`` (params seed 0, cast once) on the
    prompts ``toks`` (``lms_prompts``'): greedy in the compute dtype (every
    step's logits, the prefill's first, and the tokens; an MoE's dropped
    share in the prefill), then in fp32 compute teacher-forced with those
    tokens, and with ``fp64`` in fp64 (params and compute, the kernels'
    entries plain: ``plain_entries``); on the host."""
    from repro_torch import tree
    from repro_torch.kernels import ops
    from repro_torch.train import serve_step as S

    fam = S.serve_family(lm_binding(cfg).kind)
    params, _ = lm_init(cfg, dev)
    batch = serve_batch(toks, dev)
    seq, pos0 = batch["tokens"].shape[1], first_pos(batch)
    out = {}
    runs = [("bf16", cfg), ("fp32", cfg.replace(compute_dtype="float32"))]
    if fp64:
        runs.append(("fp64", cfg.replace(compute_dtype="float64", param_dtype="float64")))
    for key, c in runs:
        p = fam.prepare(params if key != "fp64" else tree.tree_map(lambda a: a.double(), params),
                        c)
        with torch.inference_mode(), moe_watch(c) as watch, \
                (plain_entries(ops) if key == "fp64" else contextlib.nullcontext()):
            logits, cache = fam.prefill(p, batch, c, seq + steps)
        if cfg.num_experts and key == "bf16":
            out["dropped_share"] = moe_drops(watch)["dropped_share"]
        with plain_entries(ops) if key == "fp64" else contextlib.nullcontext():
            run = lms_steps(fam, p, c, logits, cache, pos0, steps, forced=out.get("tokens"))
        out[key] = torch.cat([logits[:, -1:].float().cpu(), run["logits"]], 1)
        out.setdefault("tokens", run["tokens"])
        del p, logits, cache
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def lms_rank(mesh, cfg, serve: dict, mods, *, dry_hold: bool = False,
             fp32: bool = False, sites: bool = False) -> dict:
    """A rank's serving on ``mesh``: ``cfg``'s params (seed 0) placed
    (``lm_param_rules``) and cast once, its ``data`` block of
    ``serve["prompts"]``; one timed prefill (its layer-0 K9 q/k/v and K8
    calls kept and held against their plain versions, K8 bitwise; the
    collectives by site; the MoE's dropped share on this rank), greedy
    decode steps (ms each), then the same steps teacher-forced with
    ``serve["forced"]`` over the same cache (the logits held in the
    parent).  With ``fp32`` the prefill and the teacher-forced steps once
    more in fp32 compute (``logits_fp32``, held in the parent to
    ``LMM_FP32_TOL``).  With ``dry_hold`` the prefill's peak above its
    baseline beside the dry run's trace of this rank on its
    ``abstract_mesh``.  With ``sites`` K9 is kept and held at the first
    call of each kind of site (``kept_attention_sites``: a prefix model's
    encoder, decoder and cross-attention) in place of layer 0's; the
    prompts may carry a prefix model's frames or patches
    (``lms_prompts``)."""
    from repro_torch import tree
    from repro_torch.data import synthetic
    from repro_torch.distributed import collectives
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as M
    from repro_torch.train import serve_step as S

    dev = mesh.device
    fam = S.serve_family(lm_binding(cfg).kind)
    with card_turn(mesh):
        placed, _specs, _ = lmm_place(cfg, mesh, dev, serve=True)
        local = fam.prepare(placed, cfg)
        if not fp32:
            del placed
        gc.collect()
        torch.cuda.empty_cache()
    whole = serve_batch(serve["prompts"], dev)
    batch = synthetic.data_block(whole, mesh)
    forced = synthetic.data_block({"tokens": serve["forced"]}, mesh)["tokens"]
    b, seq = batch["tokens"].shape
    pos0 = first_pos(batch)
    steps = forced.shape[1]
    max_len = seq + steps
    rec = {"coords": dict(mesh.coords), "batch": b, "seq": seq, "steps": steps}
    keep = kept_attention_sites if sites else kept_model_path
    # cuBLAS allocates its workspace through the caching allocator at a
    # process's first product: a rank whose first product is the held
    # prefill's would count it above the baseline, where no trace does
    torch.ones((8, 8), dtype=cfg.cdtype, device=dev).matmul(
        torch.ones((8, 8), dtype=cfg.cdtype, device=dev))
    if dry_hold:
        at = M.abstract_mesh(tuple(mesh.shape.values()), tuple(mesh.shape),
                             tuple(mesh.coords.values()))
        p_m, d_m, _ = dryrun.serve_inputs(lm_binding(cfg), cfg, "prefill",
                                          whole["tokens"].shape[0], seq, mesh=at)
        t = time.perf_counter()
        rec["dry"] = {"predicted": dry(lambda: fam.prefill(p_m, d_m, cfg, max_len, mesh=at),
                                       lambda: keep(ops, {})),
                      "s": time.perf_counter() - t}
        del p_m, d_m
    reset_all(mods)
    kept = {}
    base = peak_base(dev)
    collectives.reset_counts()
    with timed_entries(ops, ("flash_attention_fused", "qr_lookup")) as marks, \
            keep(ops, kept), moe_watch(cfg) as watch, torch.inference_mode(), \
            timed_collectives(collectives) as wire:
        t = time.perf_counter()
        logits, cache = fam.prefill(local, batch, cfg, max_len, mesh=mesh)
        torch.cuda.synchronize()
        rec["prefill_ms"] = (time.perf_counter() - t) * 1e3
    rec["prefill_collective_ms"] = wire["ms"]
    rec["prefill_peak"] = torch.cuda.max_memory_allocated(dev) - base
    rec["prefill_reserved_over_allocated"] = (torch.cuda.max_memory_reserved(dev)
                                              / max(torch.cuda.max_memory_allocated(dev), 1))
    rec["k9_ms"] = event_ms(marks["flash_attention_fused"])
    rec["k8_ms"] = event_ms(marks["qr_lookup"])
    if cfg.num_experts:
        rec["moe"] = moe_drops(watch)
    rec["prefill_sites"] = {f"{k[0]}/{k[1]}": list(v) for k, v in collectives.SITES.items()}
    first = logits[:, -1].float().cpu()
    # a recurrent family's decode advances its states in place: the forced
    # steps start from the prefill's
    start = (None if lm_binding(cfg).kind == "transformer"
             else tree.tree_map(lambda t: t.clone(), cache))
    collectives.reset_counts()
    with timed_collectives(collectives) as wire:
        greedy = lms_steps(fam, local, cfg, logits, cache, pos0, steps, mesh=mesh)
    rec["decode_collective_ms_a_step"] = wire["ms"] / steps
    rec["decode_sites"] = {f"{k[0]}/{k[1]}": [v[0] / steps, v[1] / steps]
                           for k, v in collectives.SITES.items()}
    run = lms_steps(fam, local, cfg, logits, cache if start is None else start, pos0, steps,
                    forced=forced, mesh=mesh)
    rec["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    rec["decode_ms_a_step"] = float(np.mean(greedy["step_ms"]))
    rec["tokens_per_s"] = b * steps / (rec["prefill_ms"] + sum(greedy["step_ms"])) * 1e3
    rec["greedy"] = greedy["tokens"]
    rec["logits"] = torch.cat([first[:, None], run["logits"]], 1)
    if fp32:
        del logits, cache, start
        c32 = cfg.replace(compute_dtype="float32")
        local = fam.prepare(placed, c32)
        del placed
        with torch.inference_mode():
            logits, cache = fam.prefill(local, batch, c32, max_len, mesh=mesh)
        run = lms_steps(fam, local, c32, logits, cache, pos0, steps, forced=forced, mesh=mesh)
        rec["logits_fp32"] = torch.cat([logits[:, -1:].float().cpu(), run["logits"]], 1)
        start = None
    rec["launches"] = {k: v for k, v in launches_now(mods).items() if v}
    hold = hold_sites if sites else hold_kept
    rec["held"] = hold(kept, f"{cfg.name} served on mesh {tuple(mesh.shape.values())} "
                             f"rank {tuple(mesh.coords.values())}")
    if "k8" in rec["held"] and not rec["held"]["k8"]["all_bitwise"]:
        raise AssertionError(f"[lm-serve] K8 on the routed streams is not bitwise the plain "
                             f"sum: {rec['held']['k8']}")
    del kept, local, cache, logits, start, batch, whole
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def lms_hold(ranks: list, single: dict, shape, cfg, tag: str) -> dict:
    """The meshed serving's holds in the parent against the single card on
    the same params and prompts: the ``data`` blocks of the logits (from
    the ``model``-0 ranks: every rank holds them whole) against the single
    card's fp32-compute logits, within ``LMM_BF16_FACTOR`` x the single
    card's own bf16 distance (each a share of the fp32 logits' scale); the
    greedy tokens that agree; the first token equal wherever the single
    card's top-2 margin exceeds twice the mesh's distance from it on that
    row; where the ranks served in fp32 compute as well (``lms_rank``'s
    ``fp32``), those logits against the single card's fp32 ones within
    ``LMM_FP32_TOL`` of the scale or, where larger, twice the single card's
    fp32 distance from its fp64 logits (``lms_single``'s ``fp64``): two fp32
    sums, each that far from the exact one (the step-1 gradients' rule,
    ``ssm_mesh_train``; a misplaced column reads at the scale).  Logs the
    record and raises on a failed hold."""
    blocks = sorted((r for r in ranks if r["coords"]["model"] == 0),
                    key=lambda r: r["coords"].get("data", 0))
    logits = torch.cat([r["logits"] for r in blocks])
    greedy = torch.cat([r["greedy"] for r in blocks])
    want, bf16 = single["fp32"], single["bf16"]
    scale = float(want.abs().max())
    e_mesh = float((logits - want).abs().max()) / scale
    e_single = float((bf16 - want).abs().max()) / scale
    rms = lambda a: float(((a - want) ** 2).mean().sqrt()) / float((want ** 2).mean().sqrt())
    top2 = torch.topk(bf16[:, 0], 2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    dist = (logits[:, 0] - bf16[:, 0]).abs().amax(dim=-1)
    sure = margin > 2 * dist
    first_ok = bool((greedy[:, 0] == single["tokens"][:, 0])[sure].all())
    agree = int((greedy == single["tokens"]).sum())
    bound = LMM_BF16_FACTOR * e_single
    e32 = None
    if "logits_fp32" in blocks[0]:
        got32, exact = torch.cat([r["logits_fp32"] for r in blocks]), single["fp64"]
        e32 = float((got32 - want).abs().max()) / scale
        floor32 = float((want - exact).abs().max()) / scale
        bound32 = max(LMM_FP32_TOL, 2 * floor32)
    r0 = next(r for r in ranks if not any(r["coords"].values()))
    rec = {"mesh": list(shape), "arch": cfg.name, "layers": cfg.num_layers,
           "vocab": cfg.embedding_kind, "batch": int(logits.shape[0]), "seq": r0["seq"],
           "steps": r0["steps"], "fp32_logit_scale": scale,
           "logits_vs_fp32": e_mesh, "single_card_vs_fp32": e_single,
           "bound": bound, "rms_vs_fp32": rms(logits), "single_card_rms_vs_fp32": rms(bf16),
           "greedy_agree": agree, "greedy_total": int(greedy.numel()),
           "first_token_held": int(sure.sum()), "first_token_ok": first_ok,
           "prefill_ms_max_over_ranks": max(r["prefill_ms"] for r in ranks),
           "prefill_collective_ms_rank0": r0["prefill_collective_ms"],
           "decode_collective_ms_a_step_rank0": r0["decode_collective_ms_a_step"],
           "decode_ms_a_step_max_over_ranks": max(r["decode_ms_a_step"] for r in ranks),
           "tokens_per_s": min(r["tokens_per_s"] for r in ranks),
           "k9_ms_rank0": r0["k9_ms"], "k8_ms_rank0": r0["k8_ms"],
           "prefill_sites_rank0": r0["prefill_sites"], "decode_sites_a_step_rank0":
           r0["decode_sites"], "peak_gib_max_over_ranks": max(r["peak_gib"] for r in ranks),
           "held": r0["held"]}
    if e32 is not None:
        rec["fp32_logits_vs_fp32"] = e32
        rec["single_card_fp32_vs_fp64"] = floor32
        rec["fp32_logits_vs_fp64"] = float((got32 - exact).abs().max()) / scale
        rec["fp32_bound"] = bound32
    if cfg.num_experts:
        rec["dropped_share_by_rank"] = {str(tuple(r["coords"].values())):
                                        r["moe"]["dropped_share"] for r in ranks}
        rec["dropped_share_single_card"] = single["dropped_share"]
    log(f"{tag} {cfg.name} served on mesh {tuple(shape)} gloo, {cfg.num_layers} layers, "
        f"{cfg.embedding_kind} vocab, {rec['batch']} x {rec['seq']} prompts + {rec['steps']} "
        f"decode steps: prefill {rec['prefill_ms_max_over_ranks']:.1f} ms (on rank (0, 0): "
        f"K9 {rec['k9_ms_rank0']:.1f}, K8 {rec['k8_ms_rank0']:.2f}, the collectives "
        f"{rec['prefill_collective_ms_rank0']:.1f} ms), decode "
        f"{rec['decode_ms_a_step_max_over_ranks']:.1f} ms a step (the collectives "
        f"{rec['decode_collective_ms_a_step_rank0']:.1f} on rank (0, 0)), "
        f"{rec['tokens_per_s']:.1f} "
        f"tokens/s (host clock, max over ranks); combined a rank in the prefill "
        f"{rec['prefill_sites_rank0']} [calls, B], a decode step {rec['decode_sites_a_step_rank0']}"
        f"; peak {rec['peak_gib_max_over_ranks']:.2f} GiB a rank"
        + (f"; dropped share by rank {rec['dropped_share_by_rank']} (the single card "
           f"{rec['dropped_share_single_card']:.4f})" if cfg.num_experts else ""))
    log(f"{tag} mesh {tuple(shape)} logits (prefill + {rec['steps']} teacher-forced steps) vs "
        f"the single card's in fp32 compute (scale {scale:.4g}): {e_mesh:.4g} of scale (held to "
        f"{LMM_BF16_FACTOR:g} x the single card's bf16 {e_single:.4g} = {bound:.4g}); rms "
        f"{rec['rms_vs_fp32']:.4g} vs {rec['single_card_rms_vs_fp32']:.4g}; greedy tokens "
        f"{agree} / {rec['greedy_total']} agree; first token equal on the {int(sure.sum())} "
        f"sequence(s) whose margin exceeds twice the distance: {first_ok}")
    if e32 is not None:
        log(f"{tag} mesh {tuple(shape)} logits in fp32 compute (prefill + {rec['steps']} "
            f"teacher-forced steps) vs the single card's: {e32:.4g} of scale (held to "
            f"{bound32:.4g}: {LMM_FP32_TOL:g}, or twice the single card's fp32 distance from "
            f"its fp64 {floor32:.4g}); the mesh's fp32 from that fp64 "
            f"{rec['fp32_logits_vs_fp64']:.4g}")
    log(f"{tag} mesh {tuple(shape)} kernels vs plain on rank (0, 0)'s own calls: "
        + (sites_text if any(k.startswith("k9 ") for k in rec["held"]) else held_text)(
            rec["held"]))
    if not (e_mesh <= bound and first_ok and (e32 is None or e32 <= bound32)):
        raise AssertionError(f"{tag} mesh {tuple(shape)} serving: {rec}")
    return rec


def lms_peak_hold(ranks: list, cfg, shape) -> dict:
    """The rank (0, 0)'s prefill peak above its baseline held to the dry
    run's trace of the same rank (``record_peak``); the trace's seconds
    count with the script's other traces."""
    r0 = next(r for r in ranks if not any(r["coords"].values()))
    DRYRUN["s"] += r0["dry"]["s"]
    DRYRUN["traces"] += 1
    return record_peak(f"{cfg.name} {cfg.embedding_kind} prefill {r0['batch']} x {r0['seq']} "
                       f"on mesh {tuple(shape)} rank (0, 0)", r0["prefill_peak"],
                       r0["dry"]["predicted"], r0["prefill_reserved_over_allocated"])


def lms_world1(cfg, params, axes, mesh, batch, steps: int = LMS_WORLD1_STEPS) -> dict:
    """World 1 (mesh (1, 1), nccl): ``params`` cast once for serving, the
    prefill of ``batch`` and ``steps`` greedy steps on the single card and
    on the mesh; the logits, the cache and the tokens read for bitwise
    equality."""
    from repro_torch import tree
    from repro_torch.configs import registry
    from repro_torch.distributed import sharding as SH
    from repro_torch.train import serve_step as S

    fam = S.serve_family(lm_binding(cfg).kind)
    p = fam.prepare(params, cfg)
    local = SH.shard_tree(p, registry.lm_specs(cfg, p, axes, mesh, serve=True), mesh)
    seq = batch["tokens"].shape[1]
    runs = {}
    for key, m, q in (("single", None, p), ("mesh", mesh, local)):
        with torch.inference_mode():
            logits, cache = fam.prefill(q, batch, cfg, seq + steps, mesh=m)
        first = logits.clone()
        run = lms_steps(fam, q, cfg, logits, cache, first_pos(batch), steps, mesh=m)
        runs[key] = (first, cache, run)
    (f1, c1, r1), (f2, c2, r2) = runs["single"], runs["mesh"]
    bitwise = {"prefill_logits": torch.equal(f1, f2),
               "cache": all(torch.equal(a, b) for a, b in zip(tree.leaves(c1),
                                                              tree.leaves(c2))),
               "decode_logits": torch.equal(r1["logits"], r2["logits"]),
               "tokens": torch.equal(r1["tokens"], r2["tokens"])}
    del p, local, runs
    gc.collect()
    torch.cuda.empty_cache()
    return {"steps": steps, "bitwise": bitwise}


def lm_mesh_phase(dev, by_name, mods) -> dict:
    """Phase 13: the LM trained and served on a mesh.  World 1 over nccl in
    this process (training and serving against the single card, bitwise);
    two gloo ranks on the card, mesh (1, 2), at full width and depth with
    the QR vocabulary; four, mesh (2, 2), with the dense vocabulary at
    ``LMM_DENSE_LAYERS``, their fp32 (2 layers) and bf16 (the cut) step-1
    gradients held against the single card's; each mesh's ranks then serve
    (``lms_rank``: a prefill and greedy steps, then the steps
    teacher-forced with the single card's tokens; ``lms_hold`` against the
    single card's fp32-compute logits, the (1, 2) prefill's peak against
    the dry run's).  The phase's K9
    and K8 launches (this process's and the ranks') add to the
    ``flash_fwd`` and ``qr_gather`` rows.  Returns the
    ``{"lm_mesh_training": ...}`` record."""
    from repro_torch.launch import mesh as M

    t0 = time.perf_counter()
    totals = {}
    reset_all(mods)
    record = {"world1": lm_mesh_world1(dev, mods, totals), "meshes": []}
    log(f"[lm-mesh] world 1 in {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    # the single card's serving on the prompts the meshes serve: its greedy
    # tokens feed the meshes' teacher-forced steps
    t1 = time.perf_counter()
    full = lm_config(LM_MAIN)
    serve_cfgs = {"tp": full.replace(embedding_kind="qr", embedding_exec="twolevel"),
                  "dp": full.replace(embedding_kind="dense", num_layers=LMM_DENSE_LAYERS)}
    serve_refs, serve_args = {}, {}
    for what, (b, steps) in (("tp", (LMS_PROMPT[0], LMS_STEPS)), ("dp", (2, LMS_DP_STEPS))):
        prompts = lms_prompts(serve_cfgs[what], b, LMS_PROMPT[1])
        serve_refs[what] = lms_single(serve_cfgs[what], prompts, steps, dev)
        serve_args[what] = {"prompts": prompts, "forced": serve_refs[what]["tokens"]}
    torch.cuda.synchronize()
    record["serve_single_card_launches"] = take_launches(mods, totals)
    log(f"[lm-serve] the single card's references (greedy bf16, forced fp32) in "
        f"{time.perf_counter() - t1:.1f} s")
    record["serving"] = []
    alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = LMT_ALLOCATOR
    try:
        for shape, what, vocab in (((1, 2), "tp", "qr"), ((2, 2), "dp", "dense")):
            t1 = time.perf_counter()
            ranks = M.spawn(lm_mesh_rank, shape, args=(what, serve_args[what]), device="cuda",
                            backend="gloo", init_file=ROOT / "build" / "lm_mesh" / "rdv",
                            timeout_s=LMM_TIMEOUT_S)
            rec = lmm_record(ranks, shape, vocab)
            rec["spawn_s"] = time.perf_counter() - t1
            log(f"[lm-mesh] mesh {shape}: the ranks took {rec['spawn_s']:.1f} s")
            for k, v in rec["launches_all_ranks"].items():
                totals[k] = totals.get(k, 0) + v
            lmm_log(rec)
            served = [r.pop("serve") for r in ranks]
            for r in served:
                for k, v in r["launches"].items():
                    totals[k] = totals.get(k, 0) + v
            srec = lms_hold(served, serve_refs[what], shape, serve_cfgs[what], "[lm-serve]")
            if what == "tp":
                srec["peak_hold"] = lms_peak_hold(served, serve_cfgs[what], shape)
            record["serving"].append(srec)
            if what == "dp":
                mine = next(r for r in ranks if not any(r["coords"].values()))
                seq = lmt_shape().seq_len
                full = lm_config(LM_MAIN).replace(embedding_kind="dense")
                cfg32 = full.replace(num_layers=LMM_GRAD32_LAYERS, compute_dtype="float32")
                got = mine.pop("grads32")
                toks32 = lmm_tokens(cfg32, shape[0], seq, dev)
                want, loss = lmm_single_grads(cfg32, toks32, dev, blocks=shape[0])
                e32 = leaf_errors(got, want)
                one_pass, _ = lmm_single_grads(cfg32, toks32, dev)
                e_one = leaf_errors(got, one_pass)
                checks = {"fp32": {"layers": LMM_GRAD32_LAYERS, "rel_err_max": max(e32),
                                   "leaf": mine["paths"][int(np.argmax(e32))],
                                   "tolerance": LMM_FP32_TOL, "loss": mine["loss32"],
                                   "loss_single_card": loss,
                                   "vs_one_pass": (max(e_one),
                                                   mine["paths"][int(np.argmax(e_one))])}}
                del got, want, one_pass
                # the cut in bf16: the mesh and the single card against the
                # single card in fp32 compute (the exact gradients)
                cut = full.replace(num_layers=rec["layers"])
                toks = lmm_tokens(cut, shape[0], seq, dev)
                exact, loss32 = lmm_single_grads(cut.replace(compute_dtype="float32"), toks, dev,
                                                 blocks=shape[0])
                single, loss16 = lmm_single_grads(cut, toks, dev, blocks=shape[0])
                got = mine.pop("grads")
                e_single, e_mesh = leaf_errors(single, exact), leaf_errors(got, exact)
                e_between = leaf_errors(got, single)
                refs = {"fsdp": (loss16, grad_norm(single))}
                del exact, single, got
                bound = LMM_BF16_FACTOR * max(e_single)
                worst = lambda e: (max(e), mine["paths"][int(np.argmax(e))])
                checks["bf16"] = {
                    "layers": cut.num_layers, "mesh_vs_exact": worst(e_mesh),
                    "single_card_vs_exact": worst(e_single), "mesh_vs_single_card":
                    worst(e_between), "bound": bound, "loss": mine["loss"],
                    "loss_single_card": loss16, "loss_single_card_fp32": loss32}
                rec["step1_grads"] = checks
                c32, c16 = checks["fp32"], checks["bf16"]
                log(f"[lm-mesh] (2, 2) fp32 step-1 gradients at {LMM_GRAD32_LAYERS} layers, "
                    f"gathered, vs the single card on the same data partition: "
                    f"{c32['rel_err_max']:.3g} of scale (worst {c32['leaf']}; held to "
                    f"{LMM_FP32_TOL}); vs the single card in one pass "
                    f"{c32['vs_one_pass'][0]:.3g} ({c32['vs_one_pass'][1]}); loss "
                    f"{c32['loss']:.6f} vs {c32['loss_single_card']:.6f}")
                log(f"[lm-mesh] (2, 2) bf16 step-1 gradients at {cut.num_layers} layers against "
                    f"the single card's in fp32 compute, worst leaf's share of its scale: the "
                    f"mesh {c16['mesh_vs_exact'][0]:.3g} ({c16['mesh_vs_exact'][1]}; held to "
                    f"{LMM_BF16_FACTOR:g} x the single card's = {bound:.3g}), the single card in "
                    f"bf16 {c16['single_card_vs_exact'][0]:.3g} "
                    f"({c16['single_card_vs_exact'][1]}); the mesh vs the single card in bf16 "
                    f"{c16['mesh_vs_single_card'][0]:.3g} ({c16['mesh_vs_single_card'][1]}); "
                    f"losses {c16['loss']:.6f} / {loss16:.6f} / fp32 {loss32:.6f}")
                if not (c32["rel_err_max"] <= LMM_FP32_TOL and max(e_mesh) <= bound):
                    raise AssertionError(f"[lm-mesh] (2, 2) step-1 gradients: {checks}")
                rec["step1_grads"] = checks
                # granite-moe's step on one card: the same params and tokens,
                # each data block's gradient averaged
                moe = lm_config(LMM_MOE[0]).replace(num_layers=LMM_MOE[1])
                g_moe, loss_moe = lmm_single_grads(
                    moe, lmm_tokens(moe, shape[0] * LMM_MOE[2], LMM_MOE[3], dev), dev,
                    blocks=shape[0])
                refs["moe"] = (loss_moe, grad_norm(g_moe))
                del g_moe
                rec["fsdp"] = lmm_fsdp_hold(ranks, shape, refs)
            record["meshes"].append(rec)
            del ranks
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        if alloc is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc
    # this phase's CLI drills (``LMM_CLI``, ``LMS_CLI``) run in phase 17
    # (``cli_phase``), beside the other phases' drills
    record["launches"] = totals
    for name in ("flash_fwd", "qr_gather"):
        by_name[name]["launches"] += totals.get(name, 0)
    record["phase_s"] = time.perf_counter() - t0
    log(f"[lm-mesh] phase {record['phase_s']:.1f} s; launches {totals}")
    return record


# ---------------------------------------------------------------------------
# phase 14: the MoE transformers served and trained
# ---------------------------------------------------------------------------

MOE_ARCHS = ("granite-moe-3b-a800m", "qwen3-moe-235b-a22b")
MOE_MAIN = "granite-moe-3b-a800m"
MOE_ORACLE_TOL = 1e-4     # the MoE layer vs its per-token mixture, of the output's scale
MOE_ORACLE_SEQ = 4096
# the (1, 2) EP check: granite-moe at full width cut to 4 layers (20 experts,
# 12 q / 4 kv heads a rank), one sequence of 4,096, two steps
MOE_EP_SHAPE = (1, 2)
MOE_EP_LAYERS = 4
MOE_EP_STEPS = LMM_STEPS  # ``lmm_steps`` runs the meshed steps
MOE_EP_OPT = LMM_OPT
MOE_LOSS_TOL = 2e-2       # the meshed bf16 steps' losses vs the single card's, relative
MOE_TIMEOUT_S = 600


def moe_ample(cfg) -> float:
    """A capacity factor at which no expert drops (``num_experts / top_k``:
    the capacity then holds every token), for checks that compare calls
    with different token counts; ``cfg``'s own for a dense config."""
    return cfg.num_experts / cfg.top_k if cfg.num_experts else cfg.capacity_factor


def routing_margin(router, x, k: int) -> float:
    """The smallest gap between a token's k-th and (k + 1)-th router
    probability: how far a top-k choice is from a tie."""
    probs = torch.softmax(x.float().reshape(-1, x.shape[-1]) @ router.float(), dim=-1)
    top = torch.topk(probs, k + 1, dim=-1).values
    return float((top[:, k - 1] - top[:, k]).min())


def moe_oracle(params, cfg, dev) -> dict:
    """Layer 0's MoE on its own input (a prefill of one sequence of
    ``MOE_ORACLE_SEQ`` tokens; ``cfg`` fp32 at an ample capacity) against
    the dense per-token mixture sum_k w_k FFN_{e_k}(x) of
    ``tests/test_moe.py``, a loop over the experts on the card's own ids
    and weights: within ``MOE_ORACLE_TOL`` of the output's scale."""
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as T

    seen = []
    g = torch.Generator(device=dev).manual_seed(12)
    toks = torch.randint(0, cfg.vocab, (1, MOE_ORACLE_SEQ), generator=g, device=dev,
                         dtype=torch.int32)
    with kept_calls(moe_mod, "apply_moe", lambda a, out: seen or seen.append(
            (a[0], a[1].detach().clone(), out.detach().clone()))):
        with torch.inference_mode():
            T.forward_prefill(params, toks, cfg, MOE_ORACLE_SEQ)
    p, x, out = seen[0]
    d = cfg.d_model
    with torch.inference_mode():
        ids, wts = moe_mod.route(p["router"], x, cfg)
        xs = x.reshape(-1, d).float()
        want = torch.zeros_like(xs)
        for e in range(cfg.num_experts):
            y = (torch.nn.functional.silu(xs @ p["w_gate"][e].float())
                 * (xs @ p["w_up"][e].float())) @ p["w_down"][e].float()
            want += ((ids == e) * wts).sum(-1, keepdim=True) * y
        err = float((out.reshape(-1, d).float() - want).abs().max())
        scale = float(want.abs().max())
    rec = {"tokens": MOE_ORACLE_SEQ, "capacity_factor": cfg.capacity_factor,
           "dropped": moe_mod.dropped(ids, cfg), "rel_err": err / scale, "scale": scale,
           "margin": routing_margin(p["router"], x, cfg.top_k), "tolerance": MOE_ORACLE_TOL}
    if not (rec["rel_err"] <= MOE_ORACLE_TOL and rec["dropped"] == 0):
        raise AssertionError(f"[moe] {cfg.name} oracle: {rec}")
    return rec


def moe_ref_phase(dev, mods, totals) -> dict:
    """``[moe-ref]``: granite-moe-smoke and qwen3-moe-smoke, each with a
    dense and a QR (collision 8) vocabulary, on the card and on the CPU
    with the same weights (built on the CPU and copied) and tokens, fp32
    compute: first every MoE layer call's routing (ids) card vs CPU, with
    the smallest top-k margin; then ``forward_train``, prefill and decode
    logits within ``LM_REF_TOL``, the greedy tokens equal, K9 once a layer
    a forward and K8 once a QR lookup; one step of 2 microbatches
    (``make_train_step``): the loss within ``LMT_REF_TOL`` relative, the
    updated params and the batch's gradients within ``LMT_REF_TOL`` of each
    leaf's scale (phase 12's rules)."""
    from repro_torch.configs import registry
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as T
    from repro_torch.train import optimizer as opt
    from repro_torch.train import serve_step as S
    from repro_torch.train import train_step as TS
    from repro_torch.tree import tree_map

    fam = S.serve_family("transformer")
    ocfg = opt.OptConfig(**LMT_REF_OPT)
    out = {}
    for arch in MOE_ARCHS:
        binding = registry.get(arch)
        for vocab in ("dense", "qr"):
            cfg = binding.smoke.replace(embedding_kind=vocab, qr_collision=8,
                                        compute_dtype="float32")
            cpu, _ = T.init_lm(cfg, seed=0, device="cpu")
            card = tree_map(lambda a: a.to(dev), cpu)
            toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (2, 12))
                                    .astype(np.int32))
            errs = {}
            routes = ([], [])
            with torch.inference_mode():
                reset_all(mods)
                with kept_calls(moe_mod, "route", lambda a, o: routes[0].append((a, o[0]))):
                    got = T.forward_train(card, toks.to(dev), cfg)
                torch.cuda.synchronize()
                n = take_launches(mods, totals)
                want_n = {"flash_fwd": cfg.num_layers, **({"qr_gather": 1} if vocab == "qr"
                                                          else {})}
                with kept_calls(moe_mod, "route", lambda a, o: routes[1].append((a, o[0]))):
                    want = T.forward_train(cpu, toks, cfg)
                margin = min(routing_margin(*a[:2], cfg.top_k) for a, _ in routes[1])
                same = all(torch.equal(x.cpu(), y) for (_, x), (_, y) in zip(*routes))
                if not same or n != want_n:
                    raise AssertionError(f"[moe-ref] {arch} {vocab}: routing equal {same} "
                                         f"(smallest top-k margin {margin:.3g}), launches {n}")
                pairs = [("train", got, want)]
                lg, cache = T.forward_prefill(card, toks[:, :11].to(dev), cfg, 16)
                clg, ccache = T.forward_prefill(cpu, toks[:, :11], cfg, 16)
                pairs.append(("prefill", lg, clg))
                lg2, _ = T.forward_decode(card, toks[:, 11:].to(dev), cache, 11, cfg)
                clg2, _ = T.forward_decode(cpu, toks[:, 11:], ccache, 11, cfg)
                pairs.append(("decode", lg2, clg2))
                for name, a, b in pairs:
                    dd = (a.cpu().float() - b.float()).abs()
                    errs[name] = float(dd.max())
                    if not bool((dd <= LM_REF_TOL + LM_REF_TOL * b.float().abs()).all()):
                        raise AssertionError(f"[moe-ref] {arch} {vocab} {name}: card vs CPU "
                                             f"{errs[name]}")
            tok_card = S.greedy_generate(fam, card, {"tokens": toks[:, :8].to(dev)}, cfg,
                                         max_new=4, max_len=12).cpu()
            tok_cpu = S.greedy_generate(fam, cpu, {"tokens": toks[:, :8]}, cfg, max_new=4,
                                        max_len=12)
            if not torch.equal(tok_card, tok_cpu):
                raise AssertionError(f"[moe-ref] {arch} {vocab}: greedy tokens {tok_card} vs "
                                     f"{tok_cpu}")
            btoks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, LMT_REF_SHAPE)
                                     .astype(np.int32))
            loss_fn = registry.train_loss_fn(binding, cfg)
            step = TS.make_train_step(loss_fn, ocfg, microbatches=2)
            new_cpu, _, m_cpu = step(cpu, opt.init(cpu), {"tokens": btoks})
            take_launches(mods, totals)
            new_card, _, m_card = step(card, opt.init(card), {"tokens": btoks.to(dev)})
            g_card = TS.value_and_grad(loss_fn, card, {"tokens": btoks.to(dev)})[2]
            g_cpu = TS.value_and_grad(loss_fn, cpu, {"tokens": btoks})[2]
            take_launches(mods, totals)
            loss_rel = abs(float(m_card["loss"]) - float(m_cpu["loss"])) / abs(
                float(m_cpu["loss"]))
            p_rel, p_leaf = leaf_scale_errors(new_card, new_cpu)
            g_rel, g_leaf = leaf_scale_errors(g_card, g_cpu)
            errs.update(margin=margin, step_loss_rel=loss_rel, param_rel=p_rel, grad_rel=g_rel)
            if not (loss_rel <= LMT_REF_TOL and max(p_rel, g_rel) <= LMT_REF_TOL):
                raise AssertionError(f"[moe-ref] {arch} {vocab} step: loss {loss_rel}, params "
                                     f"{p_rel} ({p_leaf}), gradients {g_rel} ({g_leaf})")
            out[f"{arch}/{vocab}"] = errs
            log(f"[moe-ref] {cfg.name} {vocab} vocab, card vs CPU (fp32): routing equal in "
                f"{len(routes[0])} layer calls (smallest top-{cfg.top_k} margin {margin:.3g}); "
                f"max |diff| train {errs['train']:.2e}, prefill {errs['prefill']:.2e}, decode "
                f"{errs['decode']:.2e}; greedy tokens equal; one step of 2 microbatches: loss "
                f"{loss_rel:.1e} rel, updated params {p_rel:.1e} of scale, gradients "
                f"{g_rel:.1e} (worst {g_leaf}); launches a forward {n}")
    return out


def moe_mesh_rank(mesh, serve: dict) -> dict:
    """Phase 14's EP check on one rank of a gloo mesh on the card:
    granite-moe at full width cut to ``MOE_EP_LAYERS`` layers, QR
    ``twolevel``, one sequence of 4,096.  The fp32 step-1 gradients at an
    ample capacity (``moe_ample``), gathered to the logical shapes on the
    writer (rank (0, 0)); then ``MOE_EP_STEPS`` bf16 steps at the config's
    capacity (``lmm_steps``: ms, split, collectives, K9 and K8 held on the
    rank's own calls); then the same cut served on ``serve``'s prompts
    (``lms_rank``: its dropped share, K9 and K8 held)."""
    from repro_torch import tree
    from repro_torch.configs import registry
    from repro_torch.data import synthetic
    from repro_torch.distributed import sharding as SH
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import qr_gather as qg
    from repro_torch.train import train_step as TS

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = mesh.device
    writer = not any(mesh.coords.values())
    seq = lmt_shape().seq_len
    cfg = lm_config(MOE_MAIN).replace(num_layers=MOE_EP_LAYERS, embedding_kind="qr",
                                      embedding_exec="twolevel")
    cfg32 = cfg.replace(compute_dtype="float32", capacity_factor=moe_ample(cfg))
    res = {"coords": dict(mesh.coords)}
    local, specs, _ = lmm_place(cfg32, mesh, dev)
    res["paths"] = [p for p, _ in tree.leaves_with_paths(local)]
    res["specs"] = {p: tuple(sp) for p, sp in zip(res["paths"], specs) if "/moe/" in p}
    res["local_experts"] = int(local["layers"]["moe"]["w_up"].shape[1])
    batch = synthetic.data_block(lmm_tokens(cfg32, 1, seq, dev), mesh)
    fn = registry.train_loss_fn(registry.get(MOE_MAIN), cfg32)
    loss, _, g = TS.meshed_grads(fn, local, batch, mesh, specs)
    res["loss32"] = float(loss)
    grads = []
    for x, sp in zip(tree.leaves(g), specs):
        leaf = SH.gather(x, sp, mesh)
        if writer:
            grads.append(leaf.cpu())
        del leaf
    res["grads32"] = grads if writer else None
    del local, g
    gc.collect()
    torch.cuda.empty_cache()
    local, specs, _ = lmm_place(cfg, mesh, dev)
    batch = synthetic.data_block(lmm_tokens(cfg, 1, seq, dev), mesh)
    res["steps"] = lmm_steps(local, specs, cfg, batch, mesh, (fa, qg))
    res["layers"], res["microbatch"] = cfg.num_layers, 1
    del local, batch
    res["serve"] = lms_rank(mesh, cfg, serve, (fa, qg))
    return res


def moe_single_steps(cfg, batch, dev) -> dict:
    """The single card's ``MOE_EP_STEPS`` steps of ``cfg`` (params seed 0)
    on ``batch``: losses and norms."""
    from repro_torch.configs import registry
    from repro_torch.models import transformer as T
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as TS

    params, _ = T.init_lm(cfg, seed=0, device=dev)
    state = opt.init(params)
    step = TS.make_train_step(registry.train_loss_fn(registry.get(MOE_MAIN), cfg),
                              opt.OptConfig(**MOE_EP_OPT))
    losses, norms = [], []
    for _ in range(MOE_EP_STEPS):
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    del params, state
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": losses, "norms": norms}


def moe_ep_run(dev, mods, totals) -> dict:
    """Two gloo ranks on the card, mesh ``MOE_EP_SHAPE`` (``moe_mesh_rank``):
    the fp32 step-1 gradients, gathered, within ``LMM_FP32_TOL`` of each
    leaf's scale of the single card's (``lmm_single_grads``, the same params
    and tokens), the stacks split by ``experts`` and the router whole; the
    bf16 steps' losses within ``MOE_LOSS_TOL`` of the single card's; ms a
    step, bytes combined a rank, collectives a step."""
    from repro_torch.launch import mesh as M

    seq = lmt_shape().seq_len
    rdv = ROOT / "build" / "moe_mesh" / "rdv"
    rdv.parent.mkdir(parents=True, exist_ok=True)
    cfg = lm_config(MOE_MAIN).replace(num_layers=MOE_EP_LAYERS, embedding_kind="qr",
                                      embedding_exec="twolevel")
    prompts = lms_prompts(cfg, MOE_SERVE[0], MOE_SERVE[1])
    serve_ref = lms_single(cfg, prompts, MOE_SERVE[2], dev)
    torch.cuda.synchronize()
    take_launches(mods, totals)
    t0 = time.perf_counter()
    ranks = M.spawn(moe_mesh_rank, MOE_EP_SHAPE, args=({"prompts": prompts,
                                                        "forced": serve_ref["tokens"]},),
                    device="cuda", backend="gloo", init_file=rdv, timeout_s=MOE_TIMEOUT_S)
    spawn_s = time.perf_counter() - t0
    rec = lmm_record(ranks, MOE_EP_SHAPE, "qr")
    for k, v in rec["launches_all_ranks"].items():
        totals[k] = totals.get(k, 0) + v
    served = [r.pop("serve") for r in ranks]
    for r in served:
        for k, v in r["launches"].items():
            totals[k] = totals.get(k, 0) + v
    rec["serving"] = lms_hold(served, serve_ref, MOE_EP_SHAPE, cfg, "[moe-serve]")
    mine = next(r for r in ranks if not any(r["coords"].values()))
    cfg32 = cfg.replace(compute_dtype="float32", capacity_factor=moe_ample(cfg))
    want, loss32 = lmm_single_grads(cfg32, lmm_tokens(cfg32, 1, seq, dev), dev)
    got = mine.pop("grads32")
    errs = leaf_errors(got, want)
    del got, want
    single = moe_single_steps(cfg, lmm_tokens(cfg, 1, seq, dev), dev)
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(rec["losses"], single["losses"]))
    # the training layout: the stacks by experts over ``model``, their
    # ``embed`` dim named ``data`` (FSDP; whole on this mesh's one data rank)
    split = "model"
    specs_ok = (mine["specs"]["layers/moe/router"] == (None, None, None) and all(
        mine["specs"][f"layers/moe/{k}"] == ((None, split, None, "data") if k == "w_down"
                                             else (None, split, "data", None))
        for k in ("w_up", "w_gate", "w_down")))
    rec.update(arch=cfg.name, spawn_s=spawn_s, local_experts=mine["local_experts"],
               step1_grad_rel_err_max=max(errs), step1_grad_leaf=mine["paths"][int(np.argmax(errs))],
               loss32=mine["loss32"], loss32_single_card=loss32,
               single_card=single, loss_rel_max=loss_rel, specs=mine["specs"])
    combine = {k: v for k, v in mine["steps"]["sites"].items() if k.startswith("combine")}
    rec["combined_a_rank_a_step"] = combine
    log(f"[moe-ep] {cfg.name} mesh {MOE_EP_SHAPE} gloo on the card, {MOE_EP_LAYERS} layers, "
        f"{mine['local_experts']} experts a rank, QR twolevel, 1 x {seq}: fp32 step-1 "
        f"gradients (capacity factor {moe_ample(cfg):g}) vs the single card "
        f"{max(errs):.3g} of scale (worst {rec['step1_grad_leaf']}; held to {LMM_FP32_TOL}), "
        f"loss {mine['loss32']:.6f} vs {loss32:.6f}; bf16 losses "
        f"{', '.join(f'{x:.4f}' for x in rec['losses'])} vs the single card's "
        f"{', '.join(f'{x:.4f}' for x in single['losses'])} ({loss_rel:.2e} rel, held to "
        f"{MOE_LOSS_TOL}); specs router whole, stacks by experts: {specs_ok}; the ranks took "
        f"{spawn_s:.1f} s")
    lmm_log(rec)
    log(f"[moe-ep] combines a step, [calls, bytes a rank]: {combine}")
    if not (max(errs) <= LMM_FP32_TOL and loss_rel <= MOE_LOSS_TOL and specs_ok):
        raise AssertionError(f"[moe-ep] mesh {MOE_EP_SHAPE}: {rec}")
    del ranks
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def moe_phase(dev, by_name, mods) -> dict:
    """Phase 14: the MoE transformers served and trained.  ``[moe-ref]`` on
    the two smoke configs; granite-moe-3b-a800m at full width and depth
    with the dense and the QR (collision 64) vocabulary (consistency where
    nothing drops, K9 on the model path at D 64, layer 0's MoE against its
    per-token oracle, ``prefill_32k`` and ``decode_32k`` with the MoE
    layers' ms and the dropped share, the serve CLI); qwen3-moe-235b-a22b at
    full width and the depth whose fp32 params fit; training on one card
    (granite-moe, QR, at the depth that fits; the step-1 gradient check at
    2 layers); world 1 over nccl and EP on (1, 2) gloo ranks, which then
    serve the cut (``lms_rank``, held by ``lms_hold``).  The phase's
    launches add to the ``flash_fwd`` and ``qr_gather`` rows.  Returns the
    ``{"moe": ...}`` record."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[moe] before the phase: {torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB "
        f"allocated, {torch.cuda.mem_get_info(dev)[0] / 2**30:.2f} GiB free")
    totals = {}
    reset_all(mods)
    record = {"section_s": {}}

    def section(key, run):
        t1 = time.perf_counter()
        record[key] = run()
        record["section_s"][key] = time.perf_counter() - t1
        log(f"[moe] section {key}: {record['section_s'][key]:.1f} s")

    section("ref", lambda: moe_ref_phase(dev, mods, totals))
    section("main", lambda: [lm_main_run(dev, vocab, mods, totals, arch=MOE_MAIN, tag="[moe]",
                                         oracle=vocab == "dense")
                             for vocab in ("dense", "qr")])
    section("cli", lambda: [lm_cli_run(vocab, mods, totals, arch=MOE_MAIN, tag="[moe-cli]")
                            for vocab in ("dense", "qr")])
    section("other", lambda: lm_other_run(dev, MOE_ARCHS[1], mods, totals, tag="[moe]"))
    torch.cuda.memory._set_allocator_settings(LMT_ALLOCATOR)
    alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = LMT_ALLOCATOR
    try:
        section("train", lambda: lm_train_fitted(dev, MOE_MAIN, "qr", mods, totals,
                                                 tag="[moe-train]"))
        section("grad_check", lambda: lm_train_grad_check(
            dev, mods, totals, arch=MOE_MAIN, vocabs=("qr",), tag="[moe-train]"))
        section("world1", lambda: lm_mesh_world1(dev, mods, totals, arch=MOE_MAIN,
                                                 tag="[moe-ep]"))
        section("ep", lambda: moe_ep_run(dev, mods, totals))
    finally:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.memory._set_allocator_settings("expandable_segments:False")
        if alloc is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc
    record["launches"] = totals
    for name in ("flash_fwd", "qr_gather"):
        by_name[name]["launches"] += totals.get(name, 0)
    record["phase_s"] = time.perf_counter() - t0
    log(f"[moe] phase {record['phase_s']:.1f} s; launches {totals}")
    return record


# ---------------------------------------------------------------------------
# phase 15: the sub-quadratic models (the zamba2 hybrid, xLSTM) served and
# trained on one card
# ---------------------------------------------------------------------------

SSM_ARCHS = ("zamba2-7b", "xlstm-125m")
# repro's decode-vs-train checks (tests/test_models_consistency.py): batch,
# sequence and bound; zamba2 prefills all but the last token, xlstm steps
SSM_CONSIST = {"zamba2-7b": (2, 256, 1e-4), "xlstm-125m": (2, 9, 2e-4)}
SSM_ZAMBA_CLI = ("--batch", "4", "--prompt-len", "512", "--max-new", "16")
# xlstm-125m's full-depth training step: sequences, microbatches (a constant
# for the script's time: its sLSTM time loop, not memory, sets the pace;
# 2 sequences, cut from 4 for room)
SSM_XLSTM_TRAIN = (2, 2)
SSM_GRAD_DEPTH = {"zamba2-7b": 6, "xlstm-125m": 4}   # one segment and its site; 1st sLSTM
SSM_TRAIN_STEPS = 2
# the training drill (phase 17) at full width: one card, then (1, 2), then
# one card, each resuming from the last one's checkpoint
SSM_TRAIN_CLI = ("--arch", "xlstm-125m", "--embedding", "qr", "--seq", "512", "--batch", "4")
SSM_EXAMPLE_ARGS = ()     # examples.serve_lm with its defaults
SSM_GRAPH_CHECK = (8, 1000)   # batch, steps of the sLSTM scan held graphed vs eager
# the QR vocabulary's ``prefill_32k`` (phases 11, 14, 15 and 16; the dense
# run's cell beside it fits its batch): one sequence, a cut for the
# script's time.  At the fitted batch (qwen2-1.5b 17,
# granite-moe 7, zamba2 3, xlstm 32, whisper 7) the QR runs cost ~10, ~5,
# 7.6, 7.6 and 4.5 s more in the whole script (NVIDIA H100
# 80GB HBM3, 700 W); K8's hold and the dry run's peak hold need no more
QR_PREFILL_BATCH = 1


def ssm_forward(kind: str):
    """The train forward of ``kind``: ``(params, tokens, cfg) -> logits``."""
    from repro_torch.models import xlstm as X
    from repro_torch.models import zamba2 as Z

    fwd = Z.forward_zamba2 if kind == "zamba2" else X.forward_xlstm
    return lambda p, toks, cfg: fwd(p, toks, cfg)[0]


def card_vs_cpu(name: str, a, b, errs: dict, tag: str) -> None:
    """``a`` (the card's) within ``LM_REF_TOL`` + ``LM_REF_TOL`` |b| of
    ``b`` (the CPU's); the worst |a - b| under ``errs[name]``."""
    d = (a.cpu().float() - b.float()).abs()
    errs[name] = max(errs.get(name, 0.0), float(d.max()))
    if not bool((d <= LM_REF_TOL + LM_REF_TOL * b.float().abs()).all()):
        raise AssertionError(f"{tag} {name}: card vs CPU {float(d.max())}")


def fp32_floor(binding, cfg, params, batch: dict) -> dict:
    """Each leaf's distance of the batch's fp32 gradient on the CPU from the
    same gradient in fp64 there (params and compute widened), of the fp64
    gradient's scale: how far fp32's rounding alone moves that leaf."""
    from repro_torch import tree
    from repro_torch.configs import registry
    from repro_torch.train import train_step as TS

    c64 = cfg.replace(compute_dtype="float64", param_dtype="float64")
    p64 = tree.tree_map(lambda a: a.double(), params)
    g32 = TS.value_and_grad(registry.train_loss_fn(binding, cfg), params, batch)[2]
    g64 = TS.value_and_grad(registry.train_loss_fn(binding, c64), p64, batch)[2]
    return {path: float((a.double() - b).abs().max()) / max(float(b.abs().max()), 1e-300)
            for (path, a), b in zip(tree.leaves_with_paths(g32), tree.leaves(g64))}


def ssm_ref_phase(dev, mods, totals) -> dict:
    """``[ssm-ref]``: zamba2-7b-smoke and xlstm-125m-smoke, each with a
    dense and a QR (collision 8) vocabulary, on the card and on the CPU with
    the same weights (built on the CPU and copied) and tokens, fp32
    compute: the train logits, the serve family's prefill (its last-row
    logits and every cache or state leaf) and one decode step within
    ``LM_REF_TOL``, the greedy tokens equal, K9 once a site a forward and
    K8 once a QR lookup; one step of 2 microbatches: the loss within
    ``LMT_REF_TOL`` relative and the batch's gradients within
    ``LMT_REF_TOL`` of each leaf's scale, or, where fp32 itself lies
    further than that from the fp64 gradients on the CPU (``fp32_floor``,
    the worst leaf: 1.18e-05 for zamba2-smoke's QR config, ``A_log``;
    6e-06–1.1e-05 for many xlstm-smoke leaves), within twice that
    distance (two fp32 sums, each that far from the exact one); the
    updated params' distance is
    read, not held (AdamW's first step moves a leaf whose gradients sit
    near ``eps`` by up to |dg| / eps of lr: 1.3e-05 of ``conv_b``'s scale
    for gradients within 8.6e-06, NVIDIA H100 80GB HBM3)."""
    from repro_torch import tree
    from repro_torch.configs import registry
    from repro_torch.train import optimizer as opt
    from repro_torch.train import serve_step as S
    from repro_torch.train import train_step as TS

    ocfg = opt.OptConfig(**LMT_REF_OPT)
    out = {}
    for arch in SSM_ARCHS:
        binding = registry.get(arch)
        fam, fwd = S.serve_family(binding.kind), ssm_forward(binding.kind)
        for vocab in ("dense", "qr"):
            tag = f"[ssm-ref] {arch} {vocab}"
            cfg = binding.smoke.replace(embedding_kind=vocab, qr_collision=8,
                                        compute_dtype="float32")
            cpu, _ = registry.init_fn(binding)(cfg, seed=0, device="cpu")
            card = tree.tree_map(lambda a: a.to(dev), cpu)
            toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (2, 12))
                                    .astype(np.int32))
            errs = {}
            with torch.inference_mode():
                reset_all(mods)
                got = fwd(card, toks.to(dev), cfg)
                torch.cuda.synchronize()
                n = take_launches(mods, totals)
                want_n = {**({"flash_fwd": k9_calls(cfg)} if k9_calls(cfg) else {}),
                          **({"qr_gather": 1} if vocab == "qr" else {})}
                if n != want_n:
                    raise AssertionError(f"{tag}: launches {n}, not {want_n}")
                card_vs_cpu("train", got, fwd(cpu, toks, cfg), errs, tag)
                lg, cache = fam.prefill(card, {"tokens": toks[:, :8].to(dev)}, cfg, 12)
                clg, ccache = fam.prefill(cpu, {"tokens": toks[:, :8]}, cfg, 12)
                card_vs_cpu("prefill", lg, clg, errs, tag)
                for a, b in zip(tree.leaves(cache), tree.leaves(ccache)):
                    card_vs_cpu("state", a, b, errs, tag)
                lg2, _ = fam.decode(card, cache, toks[:, 8:9].to(dev), 8, cfg)
                clg2, _ = fam.decode(cpu, ccache, toks[:, 8:9], 8, cfg)
                card_vs_cpu("decode", lg2, clg2, errs, tag)
            tok_card = S.greedy_generate(fam, card, {"tokens": toks[:, :8].to(dev)}, cfg,
                                         max_new=4, max_len=12).cpu()
            tok_cpu = S.greedy_generate(fam, cpu, {"tokens": toks[:, :8]}, cfg, max_new=4,
                                        max_len=12)
            if not torch.equal(tok_card, tok_cpu):
                raise AssertionError(f"{tag}: greedy tokens {tok_card} vs {tok_cpu}")
            btoks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, LMT_REF_SHAPE)
                                     .astype(np.int32))
            loss_fn = registry.train_loss_fn(binding, cfg)
            step = TS.make_train_step(loss_fn, ocfg, microbatches=2)
            new_cpu, _, m_cpu = step(cpu, opt.init(cpu), {"tokens": btoks})
            take_launches(mods, totals)
            new_card, _, m_card = step(card, opt.init(card), {"tokens": btoks.to(dev)})
            torch.cuda.synchronize()
            n_step = take_launches(mods, totals)
            g_card = TS.value_and_grad(loss_fn, card, {"tokens": btoks.to(dev)})[2]
            g_cpu = TS.value_and_grad(loss_fn, cpu, {"tokens": btoks})[2]
            take_launches(mods, totals)
            loss_rel = abs(float(m_card["loss"]) - float(m_cpu["loss"])) / abs(
                float(m_cpu["loss"]))
            p_rel, p_leaf = leaf_scale_errors(new_card, new_cpu)
            g_rel, g_leaf = leaf_scale_errors(g_card, g_cpu)
            errs.update(step_loss_rel=loss_rel, param_rel=p_rel, grad_rel=g_rel)
            over = {path: leaf_scale_errors(a, b)[0] for (path, a), b in
                    zip(tree.leaves_with_paths(g_card), tree.leaves(g_cpu))}
            over = {k: v for k, v in over.items() if v > LMT_REF_TOL}
            if over:                 # held to twice fp32's own distance from fp64
                floor = fp32_floor(binding, cfg, cpu, {"tokens": btoks})
                worst = max(floor, key=floor.get)
                errs["fp32_floor"] = {worst: floor[worst]}
                over = {k: v for k, v in over.items() if v > 2 * floor[worst]}
            if not (loss_rel <= LMT_REF_TOL and not over and n_step == step_launches(cfg, 2)):
                raise AssertionError(f"{tag} step: loss {loss_rel}, params {p_rel} ({p_leaf}), "
                                     f"gradients {g_rel} ({g_leaf}; beyond the bounds {over}), "
                                     f"launches {n_step}")
            out[f"{arch}/{vocab}"] = errs
            log(f"{tag} vocab, card vs CPU (fp32): max |diff| train {errs['train']:.2e}, prefill "
                f"{errs['prefill']:.2e}, cache / states {errs['state']:.2e}, decode "
                f"{errs['decode']:.2e}; greedy tokens equal; one step of 2 microbatches: loss "
                f"{loss_rel:.1e} rel, updated params {p_rel:.1e} of scale, gradients {g_rel:.1e} "
                f"(worst {g_leaf}"
                + (f"; fp32's own worst distance from fp64 {errs['fp32_floor']}"
                   if "fp32_floor" in errs else "")
                + f"); launches a forward {n}, a step {n_step}")
    return out


def ssm_consistency(params, cfg, kind: str, dev, hold: bool = True) -> dict:
    """``repro``'s decode-vs-train check on the card at ``SSM_CONSIST``
    (``hold``: held to its bound, else read): zamba2 prefills all but the
    last token into a cache and decodes it (the prefill's last row and the
    decode step against the train forward's last two rows); xlstm decodes
    every token from ``init_xlstm_state`` (each step against its row)."""
    from repro_torch.models import xlstm as X
    from repro_torch.models import zamba2 as Z

    batch, seq, tol = SSM_CONSIST[cfg.name]
    g = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (batch, seq), generator=g, device=dev, dtype=torch.int32)
    with torch.inference_mode():
        full = ssm_forward(kind)(params, toks, cfg)
        if kind == "zamba2":
            cache = Z.init_zamba2_cache(cfg, batch, seq, dtype=torch.float32, device=dev)
            lg, cache = Z.forward_zamba2(params, toks[:, :seq - 1], cfg, cache=cache, pos=0,
                                         last=True)
            lg2, _ = Z.forward_zamba2(params, toks[:, seq - 1:], cfg, cache=cache, pos=seq - 1,
                                      decode=True)
            pairs = (("prefill", lg[:, 0], full[:, seq - 2]), ("decode", lg2[:, 0], full[:, -1]))
            del cache
        else:
            st, rows = X.init_xlstm_state(cfg, batch, device=dev), []
            for t in range(seq):
                lg, st = X.forward_xlstm(params, toks[:, t:t + 1], cfg, states=st, decode=True)
                rows.append(lg[:, 0])
            pairs = (("decode", torch.stack(rows, dim=1), full),)
        out = {"batch": batch, "seq": seq, "tolerance": tol}
        for name, a, b in pairs:
            d = (a - b).abs()
            out[name] = float(d.max())
            out[f"{name}_within"] = bool((d <= tol + tol * b.abs()).all())
            if hold and not out[f"{name}_within"]:
                raise AssertionError(f"[ssm] {cfg.name} consistency {name}: {out[name]}")
        out["logit_scale"] = float(full.abs().max())
    del full
    return out


@contextlib.contextmanager
def ssm_watch(kind: str):
    """While open, a pair of CUDA events around every mamba layer call
    (zamba2) or every sLSTM and mLSTM block call (xlstm): ``{part:
    [(start, end), ...]}``."""
    from repro_torch.models import mamba2 as M
    from repro_torch.models import xlstm as X

    names = ((M, "mamba2_fwd", "mamba"),) if kind == "zamba2" else (
        (X, "slstm_block_fwd", "slstm"), (X, "mlstm_block_fwd", "mlstm"))
    marks = {part: [] for _, _, part in names}
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in names]

    def wrap(fn, part):
        def call(*a, **kw):
            e = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            e[0].record()
            out = fn(*a, **kw)
            e[1].record()
            marks[part].append(e)
            return out
        return call

    for (mod, name, part), (_, _, fn) in zip(names, saved):
        setattr(mod, name, wrap(fn, part))
    try:
        yield marks
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def ssm_prefill_flops(cfg, batch: int, seq: int) -> int:
    """A prefill's flops as the code computes them: the projections (2 x
    weights a token), a mamba layer's conv and SSD terms (the C·Bᵀ scores,
    the decay product and the product with x over every (query, key) pair
    of a chunk, the chunk states and the cross-chunk term), an mLSTM
    chunk's two products over its pairs and its two state products, the
    sLSTM's recurrent product, the shared sites' causal attention (4 D a
    visible pair and head), and the head on the last token."""
    from repro_torch.models import mamba2 as M
    from repro_torch.models import xlstm as X

    d = cfg.d_model
    if cfg.family == "hybrid":
        di, g, n, h, p = (M.d_inner(cfg), cfg.ssm_groups, cfg.ssm_state, M.num_ssm_heads(cfg),
                          cfg.ssm_head_dim)
        chunk = min(M.CHUNK, seq)
        conv = di + 2 * g * n
        layer = (2 * d * (2 * di + 2 * g * n + h) + 2 * di * d + 2 * M.CONV_WIDTH * conv
                 + 2 * g * chunk * n + h * chunk + 2 * h * chunk * p + 4 * h * p * n)
        sites = cfg.num_layers // cfg.attn_every
        attn = (2 * (2 * d * cfg.num_heads * cfg.head_dim_ + 2 * d * cfg.kv_heads * cfg.head_dim_)
                + 4 * d * cfg.d_ff + 4 * cfg.head_dim_ * cfg.num_heads * (seq + 1) // 2)
        body = cfg.num_layers * layer + sites * attn
    else:
        di, h = X.MLSTM_PF * d, cfg.num_heads
        hd, chunk, f = di // h, min(X.MLSTM_CHUNK, seq), int(X.SLSTM_PF * d)
        mlstm = (2 * d * 2 * di + 3 * 2 * di * di + 2 * 2 * di * h + 2 * di * d
                 + 4 * h * chunk * hd + 4 * h * hd * hd)
        slstm = 2 * d * 4 * d + 2 * h * (d // h) * 4 * (d // h) + 2 * d * 2 * f + 2 * f * d
        n_s = sum(X.is_slstm_layer(cfg, i) for i in range(cfg.num_layers))
        body = n_s * slstm + (cfg.num_layers - n_s) * mlstm
    return batch * (seq * body + 2 * d * cfg.vocab)


def ssm_prefill_run(params, cfg, kind: str, dev, mods, totals, batch: int | None = None) -> dict:
    """``prefill_32k`` through ``kind``'s serve family (the head on the last
    row): one prefill of 32,768 tokens at ``batch`` or, without one, at the
    largest batch that fits, cut to the cell's 32, by the dry run's fit as
    phase 11's (``dry_fit``: on meta the sLSTM's time loop runs one step);
    the measured peak held to the trace's (``hold_peak``).  Timed by CUDA
    events: the call, K9
    and K8 around every call, the mamba layers (zamba2) or the sLSTM and
    mLSTM blocks (xlstm) around every call; site 0's K9 q/k/v and output and
    every K8 call kept and held against their plain versions after it; peak
    memory; the flop bound (``ssm_prefill_flops``); zamba2's K9 against
    SDPA at the prefill's attention shapes."""
    from repro_torch.configs.base import LM_SHAPES
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.train import serve_step as S

    fam = S.serve_family(kind)
    cell = next(s for s in LM_SHAPES if s.name == "prefill_32k")
    seq = cell.seq_len
    g = torch.Generator(device=dev).manual_seed(3)

    meta = dryrun.to_meta(params)

    def predict(b: int) -> int:
        return dry(lambda: fam.prefill(meta, meta_tokens(cfg, b, seq), cfg, seq),
                   lambda: kept_model_path(ops, {}))

    fit = {}
    if batch is None:
        fit = dry_fit(predict, free_budget(dev), cell.global_batch)
        batch = fit["size"]
    reset_all(mods)
    toks = torch.randint(0, cfg.vocab, (batch, seq), generator=g, device=dev, dtype=torch.int32)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    base = peak_base(dev)
    kept = {}
    with timed_entries(ops, ("flash_attention_fused", "qr_lookup")) as marks, \
            kept_model_path(ops, kept), ssm_watch(kind) as parts:
        with torch.inference_mode():
            start.record()
            t0 = time.perf_counter()
            logits, cache = fam.prefill(params, {"tokens": toks}, cfg, seq)
            end.record()
            torch.cuda.synchronize()
            host_s = time.perf_counter() - t0
    held_peak = hold_peak(f"{cfg.name} {cfg.embedding_kind} prefill_32k batch {batch}",
                          fit["traced"][batch] if fit else predict(batch), base, dev)
    n = take_launches(mods, totals)
    ms = start.elapsed_time(end)
    peak = torch.cuda.max_memory_allocated(dev)
    want = {**({"flash_fwd": k9_calls(cfg)} if k9_calls(cfg) else {}),
            **({"qr_gather": 1} if cfg.embedding_kind == "qr" else {})}
    if n != want or tuple(logits.shape) != (batch, 1, cfg.vocab) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"[ssm] {cfg.name} prefill_32k: launches {n}, logits "
                             f"{tuple(logits.shape)}")
    del logits, cache, toks
    torch.cuda.empty_cache()
    held = hold_kept(kept, f"{cfg.name} prefill_32k")
    del kept
    flops = ssm_prefill_flops(cfg, batch, seq)
    k9_ms = event_ms(marks["flash_attention_fused"])
    rec = {"seq": seq, "batch": batch, "cell_batch": cell.global_batch, "fit": fit,
           "peak_hold": held_peak, "ms": ms,
           "host_s": host_s, "tokens_per_s": batch * seq / ms * 1e3, "k9_ms": k9_ms,
           "k9_share": k9_ms / ms, "k8_ms": event_ms(marks["qr_lookup"]),
           "parts_ms": {k: event_ms(v) for k, v in parts.items()},
           "parts_calls": {k: len(v) for k, v in parts.items()},
           "peak_gib": peak / 2**30, "flops": flops, "bound_ms": flops / BF16_FLOP_S * 1e3,
           "launches": n, "held": held}
    rec["parts_share"] = {k: v / ms for k, v in rec["parts_ms"].items()}
    if k9_calls(cfg):
        rec["k9_ms_a_call"] = k9_ms / k9_calls(cfg)
        rec["k9_vs_sdpa"] = k9_against_sdpa(cfg, batch, seq, dev)
    reset_all(mods)                 # the yardstick's launches are not the path's
    return rec


def ssm_decode_run(params, cfg, kind: str, dev, mods, totals, cell_name: str,
                   batch: int | None = None) -> dict:
    """One decode step of ``cell_name`` (``decode_32k``, ``long_500k``) at
    position seq - 1: zamba2 against a cache ``seq`` deep (k and v random,
    every position attended) at the largest batch whose cache fits the free
    memory less ``LM_HEADROOM`` (or ``batch``), xlstm from its recurrent
    states at the cell's batch (they do not grow); ms a step by CUDA events
    over ``LM_DECODE_REPS`` steps beside the bytes bound (every weight read
    once, the k / v caches read, the recurrent states read and written, at
    the HBM rate); each step's K8 call held against the plain sum."""
    from repro_torch import tree
    from repro_torch.configs.base import LM_SHAPES
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.train import serve_step as S

    fam = S.serve_family(kind)
    cell = next(s for s in LM_SHAPES if s.name == cell_name)
    depth = cell.seq_len
    gc.collect()
    torch.cuda.empty_cache()
    if batch is None:
        one = fam.make_cache(cfg, 1, depth, device=dev)
        per_seq = sum(a.numel() * a.element_size() for a in tree.leaves(one))
        del one
        torch.cuda.empty_cache()
        free = torch.cuda.mem_get_info(dev)[0]
        batch = int(max(1, min(cell.global_batch, (free - LM_HEADROOM) // per_seq)))
    base = peak_base(dev)               # the cell's baseline: before its cache
    cache = fam.make_cache(cfg, batch, depth, device=dev)
    g = torch.Generator(device=dev).manual_seed(4)
    if kind == "zamba2":
        for key in ("k", "v"):
            cache[key].normal_(generator=g)
    tok = torch.randint(0, cfg.vocab, (batch, 1), generator=g, device=dev, dtype=torch.int32)
    reset_all(mods)
    meta = dryrun.to_meta((params, cache, tok))
    predicted = dryrun.storage_bytes(meta[1:]) + dry(
        lambda: decode_reps(fam.decode, *meta, depth - 1, cfg), lambda: kept_model_path(ops, {}))
    with torch.inference_mode():
        top = top_device_ops(lambda: fam.decode(params, cache, tok, depth - 1, cfg), 6)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        kept = {}
        with kept_model_path(ops, kept):
            start.record()
            logits, out = decode_reps(fam.decode, params, cache, tok, depth - 1, cfg)
            end.record()
            torch.cuda.synchronize()
    held_peak = hold_peak(f"{cfg.name} {cfg.embedding_kind} {cell_name} batch {batch}", predicted,
                          base, dev)
    n = take_launches(mods, totals)
    if tuple(logits.shape) != (batch, 1, cfg.vocab) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"[ssm] {cfg.name} {cell_name}: logits {tuple(logits.shape)}")
    held = hold_kept(kept, f"{cfg.name} {cell_name}")
    ms = start.elapsed_time(end) / LM_DECODE_REPS
    weight_bytes = sum(a.numel() * a.element_size() for a in tree.leaves(params))
    kv = {k: v for k, v in cache.items() if k in ("k", "v")} if kind == "zamba2" else {}
    kv_bytes = sum(a.numel() * a.element_size() for a in tree.leaves(kv))
    state_bytes = sum(a.numel() * a.element_size() for a in tree.leaves(cache)) - kv_bytes
    nbytes = weight_bytes + kv_bytes + 2 * state_bytes
    rec = {"cell": cell_name, "position": depth - 1, "batch": batch,
           "cell_batch": cell.global_batch, "layers": cfg.num_layers, "kv_bytes": kv_bytes,
           "state_bytes": state_bytes, "weight_bytes": weight_bytes, "ms": ms,
           "tokens_per_s": batch / ms * 1e3,
           "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
           "bound_ms": nbytes / BW_BYTES_S * 1e3, "launches": n, "held": held, "top_ops": top,
           "peak_hold": held_peak}
    del cache, logits, out, kept
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def ssm_long_depth(params, cfg, dev) -> int:
    """The zamba2 depth whose ``long_500k`` cache (one sequence: 524,288
    positions a site, a layer's SSM and conv states) and mamba layers fit
    the free memory less ``LM_HEADROOM``, counting the mamba stack
    ``params`` holds now as free (``ssm_cut`` replaces it)."""
    from repro_torch import tree
    from repro_torch.configs.base import LM_SHAPES
    from repro_torch.models import zamba2 as Z

    positions = next(s for s in LM_SHAPES if s.name == "long_500k").seq_len
    stack = sum(a.numel() * a.element_size() for a in tree.leaves(params["mamba"]))
    one = Z.init_zamba2_cache(cfg.replace(num_layers=1, attn_every=1), 1, 1, device=dev)
    state = sum(one[k].numel() * one[k].element_size() for k in ("ssm", "conv"))
    del one
    layer = stack // cfg.num_layers + state
    elem = torch.empty((), dtype=cfg.cdtype).element_size()
    site = 2 * positions * cfg.kv_heads * cfg.head_dim_ * elem
    free = torch.cuda.mem_get_info(dev)[0] + stack - LM_HEADROOM
    depth = cfg.num_layers
    while depth > cfg.attn_every and depth * layer + (depth // cfg.attn_every) * site > free:
        depth -= 1
    return depth


def ssm_cut(params, depth: int) -> dict:
    """zamba2 params cut to the first ``depth`` mamba layers (copies: the
    full stack can then be freed)."""
    return {**params, "mamba": {k: v[:depth].clone() for k, v in params["mamba"].items()}}


def ssm_embed(cfg, vocab: str, dev) -> dict:
    """A ``vocab`` vocabulary's tables for ``cfg`` (QR at the config's
    collision), drawn from seed 1 and cast to the compute dtype: the
    other vocabulary's run shares the body weights."""
    from repro_torch.core import qr_embedding

    c = cfg.replace(embedding_kind=vocab)
    g = torch.Generator(device=dev).manual_seed(1)
    tables = qr_embedding.init(c.emb_config, generator=g, device=dev)
    return c, {k: v.to(c.cdtype) for k, v in tables.items()}


def ssm_serve_run(dev, arch: str, mods, totals) -> dict:
    """``arch`` at full width and depth, dense vocabulary first: the
    consistency (``ssm_consistency``); the weights cast once for serving
    (``prepare``) and the fp32 ones dropped; zamba2's K9 on site 0's own
    q/k/v (bf16; phase 6 holds D 112 in fp32); ``prefill_32k`` at the
    batch that fits, then with the QR vocabulary (collision 64; its tables
    drawn, the body shared) at ``QR_PREFILL_BATCH``; ``decode_32k`` with each;
    ``long_500k`` with the QR vocabulary (zamba2 at ``ssm_long_depth``)."""
    from repro_torch import tree
    from repro_torch.configs import registry
    from repro_torch.train import serve_step as S

    binding = registry.get(arch)
    kind = binding.kind
    cfg = lm_config(arch).replace(embedding_kind="dense")
    t0 = time.perf_counter()
    params, _ = registry.init_fn(binding)(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    rec = {"arch": arch, "layers": cfg.num_layers, "init_s": time.perf_counter() - t0,
           "param_bytes_fp32": sum(a.numel() * 4 for a in tree.leaves(params))}
    c32 = cfg.replace(compute_dtype="float32")
    if kind == "xlstm":
        # fp32 at full width lies 2.5e-4 (chunked) and 4.1e-4 (stepped) from
        # the fp64 logits on the CPU, past repro's 2e-4: the check is held in
        # fp64 compute (the cells fp32, as repro casts them) and fp32 read
        c64 = cfg.replace(compute_dtype="float64", param_dtype="float64")
        p64 = tree.tree_map(lambda a: a.double(), params)
        rec["consistency_fp64"] = ssm_consistency(p64, c64, kind, dev)
        del p64
    rec["consistency_fp32"] = ssm_consistency(params, c32, kind, dev, hold=kind != "xlstm")
    take_launches(mods, totals)
    params = S.serve_family(kind).prepare(params, cfg)
    gc.collect()
    torch.cuda.empty_cache()
    if kind == "zamba2":
        rec["k9_model_path"] = lm_k9_check(params, cfg, dev, kind)
        take_launches(mods, totals)
    def consistency(dtype):
        c = rec[f"consistency_{dtype}"]
        held = "held to" if dtype == "fp64" or kind != "xlstm" else "read; repro's bound"
        return (f"{dtype} consistency (batch {c['batch']}, seq {c['seq']}) "
                + ", ".join(f"{k} {c[k]:.2e}" for k in ("prefill", "decode") if k in c)
                + f" ({held} {c['tolerance']}, logits up to {c['logit_scale']:.3g})")

    k9 = rec.get("k9_model_path")
    log(f"[ssm] {arch} {cfg.num_layers} layers ({rec['param_bytes_fp32'] / 1e9:.2f} GB fp32, "
        f"drawn in {rec['init_s']:.1f} s): "
        + "; ".join(consistency(t) for t in ("fp64", "fp32") if f"consistency_{t}" in rec)
        + (f"; K9 on site 0's q/k/v {k9['shape']} (bf16) {fmt_err(k9)}" if k9 else ""))
    rec["prefill_32k"], rec["decode_32k"] = {}, {}
    vocab_cfgs = {"dense": (cfg, params["embed"])}
    vocab_cfgs["qr"] = ssm_embed(cfg, "qr", dev)
    batch = None
    for vocab, (vc, embed) in vocab_cfgs.items():
        p = {**params, "embed": embed}
        r = rec["prefill_32k"][vocab] = ssm_prefill_run(p, vc, kind, dev, mods, totals, batch)
        batch = QR_PREFILL_BATCH
        fit = fmt_fit(r["fit"]) if r["fit"] else "a cut for the script's time"
        parts = ", ".join(f"{k} {v:.1f} ms ({100 * r['parts_share'][k]:.1f}%, "
                          f"{r['parts_calls'][k]} calls)" for k, v in r["parts_ms"].items())
        sdpa = (f"; one site's attention at these shapes: K9 {r['k9_vs_sdpa']['k9_ms']:.1f} ms, "
                f"SDPA (flash backend) {r['k9_vs_sdpa']['sdpa_ms']:.1f} ms"
                if "k9_vs_sdpa" in r else "")
        log(f"[ssm] {arch} {vocab} prefill_32k: batch {r['batch']} (cell {r['cell_batch']}; "
            f"{fit}) x {r['seq']}: {r['ms']:.1f} ms ({r['host_s']:.2f} s host clock), "
            f"{r['tokens_per_s']:.0f} tokens/s, K9 {r['k9_ms']:.1f} ms "
            f"({100 * r['k9_share']:.1f}%), {parts}, K8 {r['k8_ms']:.2f} ms; peak "
            f"{r['peak_gib']:.2f} GiB; bound {r['bound_ms']:.1f} ms ({r['flops']:.3e} flop at the "
            f"bf16 peak); launches {r['launches']}{sdpa}")
        if r["held"]:
            log(f"[ssm] {arch} {vocab} prefill_32k kernels vs plain on the main path: "
                + held_text(r["held"]).replace("layer 0", "site 0"))
        d = rec["decode_32k"][vocab] = ssm_decode_run(p, vc, kind, dev, mods, totals,
                                                      "decode_32k")
        log(f"[ssm] {arch} {vocab} decode_32k: batch {d['batch']} (cell {d['cell_batch']}; k/v "
            f"{d['kv_bytes'] / 2**30:.2f} GiB, states {d['state_bytes'] / 2**30:.3f} GiB) at "
            f"position {d['position']}: {d['ms']:.2f} ms a step, "
            f"{d['tokens_per_s']:.0f} tokens/s, "
            f"peak {d['peak_gib']:.2f} GiB, bound {d['bound_ms']:.2f} ms; launches "
            f"{d['launches']}" + (f"; K8 vs plain: {held_text(d['held'])}" if d["held"] else "")
            + "; top device operations: "
            + ", ".join(f"{k} {t:.2f} ms" for k, t in d["top_ops"]))
    vc, embed = vocab_cfgs["qr"]
    p = {**params, "embed": embed}
    if kind == "zamba2":
        del vocab_cfgs, params
        gc.collect()
        torch.cuda.empty_cache()
        depth = ssm_long_depth(p, vc, dev)
        p = ssm_cut(p, depth)
        vc = vc.replace(num_layers=depth)
        gc.collect()
        torch.cuda.empty_cache()
    r = rec["long_500k"] = ssm_decode_run(p, vc, kind, dev, mods, totals, "long_500k", batch=1)
    r["full_layers"] = cfg.num_layers
    sites = f", {k9_calls(vc)} sites" if kind == "zamba2" else ""
    log(f"[ssm] {arch} qr long_500k ({vc.num_layers} of {cfg.num_layers} layers{sites}) one "
        f"step at position {r['position']}, batch 1 (k/v "
        f"{r['kv_bytes'] / 2**30:.2f} GiB, states {r['state_bytes'] / 2**30:.3f} GiB): "
        f"{r['ms']:.2f} ms, bound {r['bound_ms']:.2f} ms, peak {r['peak_gib']:.2f} GiB; "
        f"launches {r['launches']}")
    del p
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def ssm_example_run(mods, totals) -> dict:
    """``python -m repro_torch.examples.serve_lm`` with its defaults (its
    ``main``, in this process): ``repro``'s default arch, xlstm-125m-smoke,
    with the QR vocabulary on the card; K8 once a lookup."""
    import io

    from repro_torch.examples import serve_lm

    reset_all(mods)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        serve_lm.main(list(SSM_EXAMPLE_ARGS))
    secs = time.perf_counter() - t0
    n = take_launches(mods, totals)
    text = buf.getvalue()
    if not text.startswith("xlstm-125m (qr embedding): generated") or not n.get("qr_gather"):
        raise AssertionError(f"[ssm-cli] examples.serve_lm: launches {n}, output {text[-500:]}")
    log(f"[ssm-cli] examples.serve_lm (defaults): " + " | ".join(text.splitlines())
        + f" (call {secs:.1f} s; launches {n})")
    return {"s": secs, "launches": n, "lines": text.splitlines()}


def ssm_graph_check(dev) -> dict:
    """The sLSTM scan at xlstm-125m's width (4 heads of 192, bf16 input
    gates) on ``SSM_GRAPH_CHECK`` sequences and steps, eager and replayed
    as CUDA graphs of ``GRAPH_STEPS`` steps (``slstm_scan(graphs=)``), as
    served (no autograd) and as trained (``_SLSTMScan``: the forward and
    the written-out backward of a weighted sum): outputs, final states and
    gradients bitwise equal; each run's ms (CUDA events, the graphed ones'
    capture included) and ms a step."""
    from repro_torch.models import xlstm as X

    cfg = lm_config("xlstm-125m")
    h, d = cfg.num_heads, cfg.d_model // cfg.num_heads
    b, steps = SSM_GRAPH_CHECK
    g = torch.Generator(device=dev).manual_seed(13)
    x = torch.randn((b, steps, h, 4, d), generator=g, device=dev).to(cfg.cdtype)
    r = torch.randn((h, 4, d, d), generator=g, device=dev) / d ** 0.5
    w = torch.randn((b, steps, h, d), generator=g, device=dev)
    out, ms = {}, {}
    for graphs in (False, True):
        for train in (False, True):
            e = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            xx, rr = x.clone().requires_grad_(train), r.clone().requires_grad_(train)
            e[0].record()
            with torch.inference_mode(not train):
                hs, st = X.slstm_scan(xx, rr, graphs=graphs)
                if train:
                    (hs * w).sum().backward()
            e[1].record()
            torch.cuda.synchronize()
            ms[graphs, train] = e[0].elapsed_time(e[1])
            out[graphs, train] = [hs, *st] + ([xx.grad, rr.grad] if train else [])
    same = {train: all(torch.equal(a, c) for a, c in zip(out[True, train], out[False, train]))
            for train in (False, True)}
    rec = {"batch": b, "steps": steps, "graph_steps": X.GRAPH_STEPS, "bitwise": same[False],
           "bitwise_train": same[True],
           **{f"{'graphed' if gr else 'eager'}_{'train' if tr else 'serve'}_ms": v
              for (gr, tr), v in ms.items()}}
    log(f"[ssm] sLSTM scan {b} x {steps} steps (4 heads of {d}), graphed ({X.GRAPH_STEPS} steps "
        f"a CUDA graph) vs eager: served bitwise {same[False]}, eager {ms[False, False]:.1f} ms "
        f"({1e3 * ms[False, False] / steps:.1f} us a step), graphed {ms[True, False]:.1f} ms "
        f"({1e3 * ms[True, False] / steps:.1f} us a step, capture included); trained (forward "
        f"and the written-out backward) bitwise {same[True]}, eager {ms[False, True]:.1f} ms, "
        f"graphed {ms[True, True]:.1f} ms ({1e3 * ms[True, True] / steps:.1f} us a step)")
    if not (same[False] and same[True]):
        raise AssertionError(f"[ssm] sLSTM scan graphed vs eager: {rec}")
    return rec


# ---------------------------------------------------------------------------
# phase 15's meshed section: zamba2 and xlstm served and trained on (1, 2)
# gloo ranks sharing the card
# ---------------------------------------------------------------------------

SSM_MESH_SHAPE = (1, 2)
# the full-width layer hold (ROADMAP.md §3, to-check item 2): one zamba2-7b
# mamba layer and the shared block fed unit-scale random hidden states, so
# that a misplaced column reads at the output's scale (at full depth the
# reference's hidden state collapses to zero): sequences, prompt tokens,
# decode steps
SSM_LAYER_HOLD = (2, 1024, 4)
# zamba2-7b with the QR vocabulary at a depth that holds both sites of a cut
# (two segments of six mamba layers, each followed by the shared block):
# layers, sequences, prompt tokens, greedy decode steps
SSM_MESH_ZAMBA = (12, 2, 1024, 8)
# xlstm-125m with the QR vocabulary at full depth: sequences, prompt tokens,
# greedy decode steps
SSM_MESH_XLSTM = (2, 4096, 16)
# the ranks' training step: sequences, tokens; xlstm at full depth in bf16,
# zamba2 at SSM_GRAD_DEPTH in fp32 compute
SSM_MESH_TRAIN = (2, 512)
# world 1 over nccl: sequences, prompt tokens, decode steps (the depths are
# SSM_GRAD_DEPTH's)
SSM_WORLD1 = (2, 256, 4)
# the serving drill: the same first sequence on (1, 2) and on one card, fp32
SSM_SERVE_CLI = ("--arch", "zamba2-7b", "--smoke", "--batch", "2", "--prompt-len", "32",
                 "--max-new", "8", "--compute-dtype", "float32")


def ssm_mesh_cfg(arch: str, **kw):
    """``arch`` at full width with the QR vocabulary (its config's
    collision), cut and changed by ``kw``."""
    return lm_config(arch).replace(embedding_kind="qr", **kw)


def ssm_layer_parts(dev):
    """One zamba2-7b mamba layer and the shared block (its attention, MLP
    and two norms), drawn from a fixed seed on ``dev`` (every rank draws the
    same), their logical axes, and the unit-scale hidden states of
    ``SSM_LAYER_HOLD``'s prefill and decode steps."""
    from repro_torch.models import layers as L
    from repro_torch.models import mamba2 as M

    cfg = lm_config("zamba2-7b")
    b, s, steps = SSM_LAYER_HOLD
    g = torch.Generator(device=dev).manual_seed(21)
    kw = dict(generator=g, device=dev)
    layer, _ = M.init_mamba2(cfg, **kw)
    block, axes = {}, {}
    block["shared_attn"], axes["shared_attn"] = L.init_attention(cfg, **kw)
    block["shared_mlp"], axes["shared_mlp"] = L.init_mlp(cfg, **kw)
    for name in ("shared_ln1", "shared_ln2"):
        block[name], axes[name] = L.init_norm(cfg.norm, cfg.d_model, cfg.pdtype, device=dev)
    x = torch.randn((b, s + steps, cfg.d_model), generator=g, device=dev)
    return cfg, layer, block, axes, x


def ssm_layer_run(layer, block, x, cfg, mesh=None) -> dict:
    """The mamba layer then the shared block on ``x``: a prefill of all but
    ``SSM_LAYER_HOLD``'s decode steps (the layer's states and the block's
    k / v written), then each decode step; on ``mesh`` with the rank's
    blocks.  -> the layer's and the block's outputs over every position,
    the final SSM and conv states and the k / v (the rank's, on a mesh)."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import mamba2 as M
    from repro_torch.models import zamba2 as Z

    b, s, steps = SSM_LAYER_HOLD
    cd, dev = cfg.cdtype, x.device
    xs = x.to(cd)
    st, conv = M.init_ssm_state(cfg, b, device=dev, mesh=mesh)
    kv = torch.zeros((2, b, s + steps, SH.cache_heads(cfg, mesh), cfg.head_dim_), dtype=cd,
                     device=dev)
    ys, zs = [], []
    with torch.inference_mode():
        y, (st, conv) = M.mamba2_fwd(layer, xs[:, :s], cfg, state=st, conv_state=conv,
                                     mesh=mesh)
        z, (k, v) = Z._shared_block(block, y, cfg, mesh=mesh)
        kv[0, :, :s], kv[1, :, :s] = k, v
        ys.append(y)
        zs.append(z)
        for i in range(steps):
            y, (st, conv) = M.mamba2_fwd(layer, xs[:, s + i:s + i + 1], cfg, state=st,
                                         conv_state=conv, decode=True, mesh=mesh)
            z, _ = Z._shared_block(block, y, cfg, cache=(kv[0], kv[1]), pos=s + i, mesh=mesh)
            ys.append(y)
            zs.append(z)
    return {"mamba_out": torch.cat(ys, 1), "block_out": torch.cat(zs, 1), "ssm_state": st,
            "conv_state": conv, "kv": kv}


def ssm_layer_hold(mesh) -> dict | None:
    """The full-width layer hold on this rank (``SSM_LAYER_HOLD``): the
    mamba layer and the shared block placed by ``mamba2.layout`` and
    ``lm_param_rules``, run in fp32 and in bf16 compute on the ranks, the
    states gathered whole (each rank's heads and conv columns, its kv
    heads); then the rank at coordinates 0 runs both on one card, unplaced,
    and holds: fp32 within ``LMM_FP32_TOL`` of each output's scale, bf16
    within ``LMM_BF16_FACTOR`` x the single card's own bf16 distance from
    its fp32, each of the scale of the single card's fp32 output.  Returns
    the errors on that rank, None on the others."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import mamba2 as MB

    dev = mesh.device
    cfg, layer, block, axes, x = ssm_layer_parts(dev)
    lay = MB.layout(cfg, mesh)
    my_layer = {k: SH.local_shard(v, mesh, lay[k]) for k, v in layer.items()}
    my_block = SH.shard_tree(block, SH.tree_specs(block, axes, mesh,
                                                  SH.lm_param_rules(cfg, mesh, serve=True)),
                             mesh)
    split = SH.head_split(cfg, mesh)
    kv_spec = SH.P(None, None, None, "model") if split is not None and split.kv_local else SH.P()
    specs = {"ssm_state": SH.P(None, "model") if MB.ssm_split(cfg, mesh) else SH.P(),
             "conv_state": SH.P(None, None, *lay["conv_b"]), "kv": kv_spec}
    writer = not any(mesh.coords.values())
    got = {}
    for key, c in (("fp32", cfg.replace(compute_dtype="float32")), ("bf16", cfg)):
        t = time.perf_counter()
        out = ssm_layer_run(my_layer, my_block, x, c, mesh)
        got[key] = {k: SH.gather(v, specs[k], mesh) if k in specs else v for k, v in out.items()}
        got[f"{key}_ms"] = (time.perf_counter() - t) * 1e3
    if not writer:
        return None
    one = {key: ssm_layer_run(layer, block, x, c)
           for key, c in (("fp32", cfg.replace(compute_dtype="float32")), ("bf16", cfg))}
    rec = {"shape": list(x.shape), "fp32_ms": got["fp32_ms"], "bf16_ms": got["bf16_ms"],
           "fp32": {}, "bf16": {}, "bf16_single_card": {}, "bf16_vs_single_card_bf16": {}}
    for k, want in one["fp32"].items():
        scale = max(float(want.float().abs().max()), 1e-30)
        err = lambda a: float((a.float() - want.float()).abs().max()) / scale
        rec["fp32"][k] = err(got["fp32"][k])
        rec["bf16"][k] = err(got["bf16"][k])
        rec["bf16_single_card"][k] = err(one["bf16"][k])
        rec["bf16_vs_single_card_bf16"][k] = float(
            (got["bf16"][k].float() - one["bf16"][k].float()).abs().max()) / scale
    rec["ok"] = all(rec["fp32"][k] <= LMM_FP32_TOL
                    and rec["bf16"][k] <= LMM_BF16_FACTOR * rec["bf16_single_card"][k]
                    for k in rec["fp32"])
    return rec


@contextlib.contextmanager
def plain_entries(ops):
    """While open, the model's kernel entries are plain differentiable torch
    in their inputs' dtype, so that an fp64 step stays fp64 on the card:
    ``ops.flash_attention_fused`` a masked softmax product (the kernel's
    top-left causal mask, GQA), ``ops.qr_lookup`` two gathers and an add."""
    saved = ops.flash_attention_fused, ops.qr_lookup

    def attention(q, k, v, *, causal=True, p_bf16=False):
        if p_bf16:
            raise NotImplementedError("the plain fp64 entries keep fp32 probabilities")
        g = q.shape[1] // k.shape[1]
        kk, vv = k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1)
        s = torch.matmul(q * q.shape[-1] ** -0.5, kk.transpose(-1, -2))
        if causal:
            hidden = torch.ones(s.shape[-2:], dtype=torch.bool, device=s.device).triu(1)
            s = s.masked_fill(hidden, float("-inf"))
        return torch.matmul(torch.softmax(s, dim=-1), vv)

    ops.flash_attention_fused = attention
    ops.qr_lookup = lambda q, r, qi, ri, **kw: q[qi.long()] + r[ri.long()]
    try:
        yield
    finally:
        ops.flash_attention_fused, ops.qr_lookup = saved


def ssm_mesh_train(mesh, mods) -> dict | None:
    """``mesh_train_holds`` of the sub-quadratic models on ``SSM_MESH_TRAIN``'s
    batch: xlstm-125m at full depth in bf16 and in fp32 compute, zamba2-7b
    at ``SSM_GRAD_DEPTH`` in fp32 compute."""
    return mesh_train_holds(mesh, mods, SSM_MESH_TRAIN, (
        ("xlstm-125m", {}, ("bfloat16", "float32")),
        ("zamba2-7b", dict(num_layers=SSM_GRAD_DEPTH["zamba2-7b"]), ("float32",))))


# the lock that ``card_turn`` gives one holder at a time
CARD_TURN = ROOT / "build" / "card_turn.lock"


@contextlib.contextmanager
def card_turn(mesh=None):
    """While open, ``mesh``'s ranks (or, with no mesh, this process) hold
    the card's turn for a stage that needs a large share of its memory: a
    rank's draw of the whole fp32 tree (``lms_rank``), the full-width layer
    hold, the step-1 gradients (``mesh_train_holds``: the rank at
    coordinates 0 holds the whole tree several times over, its gradients
    gathered, the single card's and the fp64 ones), the single card's
    references in this process.  Phases 15's and 16's meshed sections run
    beside each other and beside phase 17's children, some twenty
    processes on one card, and two such stages at once do not fit it; with
    the turn they run one after the other while the rest overlaps.  The
    rank at coordinates 0 takes an exclusive lock on ``CARD_TURN`` and the
    other ranks wait for it at a barrier: were every rank to take the lock,
    each mesh could hold it on one rank and wait for it in a collective on
    another.  Yields ``{"wait_s": ...}``."""
    import fcntl

    import torch.distributed as dist

    t = time.perf_counter()
    held = None
    if mesh is None or not any(mesh.coords.values()):
        CARD_TURN.parent.mkdir(parents=True, exist_ok=True)
        held = open(CARD_TURN, "w")
        fcntl.flock(held, fcntl.LOCK_EX)
    try:
        if mesh is not None:
            dist.barrier()
        yield {"wait_s": time.perf_counter() - t}
    finally:
        if held is not None:
            held.close()


def mesh_train_holds(mesh, mods, shape: tuple, runs) -> dict | None:
    """The ranks' training, each with the QR vocabulary on ``shape``'s batch
    (sequences, tokens; the same on every rank, a prefix model's frames or
    patches with it, ``lm_batch_for``), for each ``(arch, cut, computes)``
    of ``runs``: ``arch`` at full width, ``cut`` (a config's fields), in
    each compute dtype of ``computes``. Each run's step-1 loss and gradients
    of the meshed loss (``make_train_step``'s, under the rules), gathered
    whole and timed (host clock); then the rank at coordinates 0 takes the
    single card's gradients from the same params and tokens, unplaced, in
    fp32 compute (and in bf16 where the mesh ran it): each leaf's distance
    of its scale. fp32 is held to ``LMM_FP32_TOL``, or for a leaf that fp32
    itself moves further from the fp64 gradient (``plain_entries``), to
    twice that distance; xlstm's worst leaf to twice fp32's worst distance
    from fp64 over the leaves (its recurrences scatter one rounding to 1e-2
    of a leaf's scale, so one leaf's fp32 distance is one sample of it, and
    the bound pools them as the bf16 rule does); bf16 to ``LMM_BF16_FACTOR``
    x the single card's own distance from its fp32. Returns that rank's
    records (keyed ``arch`` and ``arch fp32``, each with that rank's peak
    and the seconds the ranks waited for the card), None on the others. A
    whisper key projection's bias is held to its weight's scale
    (``key_bias_scale``). The runs hold the card's training turn
    (``card_turn``)."""
    from repro_torch import tree
    from repro_torch.configs import registry
    from repro_torch.distributed import collectives
    from repro_torch.distributed import sharding as SH
    from repro_torch.kernels import ops
    from repro_torch.train import train_step as TS

    dev = mesh.device
    writer = not any(mesh.coords.values())
    b, seq = shape
    out = {}
    with card_turn(mesh) as turn:
        for arch, kw, computes in runs:
            base = ssm_mesh_cfg(arch, **kw)
            binding = lm_binding(base)
            params, axes = lm_init(base, dev)
            specs = registry.lm_specs(base, params, axes, mesh)
            local = SH.shard_tree(params, specs, mesh)
            if not writer:
                del params
            batch = lm_batch_for(base, b, seq, torch.Generator(device=dev).manual_seed(17), dev)
            single = {}
            for compute in computes:
                cfg = base.replace(compute_dtype=compute)
                key = arch if compute == "bfloat16" else f"{arch} fp32"
                fn = registry.train_loss_fn(binding, cfg)

                def meshed(p, bb):
                    with SH.use_rules(mesh, SH.DEFAULT_RULES):
                        return fn(p, bb)

                reset_all(mods)
                collectives.reset_counts()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(dev)
                t = time.perf_counter()
                loss, _, grads = TS.value_and_grad(meshed, local, batch)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t) * 1e3
                sites = {f"{k[0]}/{k[1]}": list(v) for k, v in collectives.SITES.items()}
                launches = {k: v for k, v in launches_now(mods).items() if v}
                got = [SH.gather(g, sp, mesh) for g, sp in zip(tree.leaves(grads), specs)]
                del grads
                if not writer:
                    del got
                    out[key] = {"launches": launches}
                    continue
                paths = [p for p, _ in tree.leaves_with_paths(params)]
                scale_of = ([paths.index(key_bias_scale(p)) for p in paths]
                            if base.is_encoder_decoder else None)
                for k in {compute, "float32"} - set(single):
                    l1, _, g1 = TS.value_and_grad(
                        registry.train_loss_fn(binding, base.replace(compute_dtype=k)), params,
                        batch)
                    single[k] = (float(l1), tree.leaves(g1))
                e_mesh = leaf_errors(got, single["float32"][1], scale_of)
                e_single = leaf_errors(single[compute][1], single["float32"][1], scale_of)
                worst = lambda e: (max(e), paths[int(np.argmax(e))])
                rec = {"layers": cfg.num_layers, "compute": compute, "batch": b, "seq": seq,
                       "loss": float(loss), "loss_single_card": single[compute][0], "ms": ms,
                       "sites": sites, "launches": launches, "mesh_vs_fp32": worst(e_mesh),
                       "single_card_vs_fp32": worst(e_single)}
                if compute == "float32":
                    # a leaf that fp32 itself moves further than LMM_FP32_TOL
                    # from the fp64 gradient (zamba2's A_log through the
                    # collapsed hidden state, ROADMAP.md §3) is held to twice
                    # that distance: two fp32 sums, each that far from the
                    # exact one (the ``[ssm-ref]`` rule, ``fp32_floor``)
                    c64 = cfg.replace(compute_dtype="float64", param_dtype="float64")
                    p64 = tree.tree_map(lambda a: a.double(), params)
                    with plain_entries(ops):
                        g64 = tree.leaves(TS.value_and_grad(registry.train_loss_fn(binding, c64),
                                                            p64, batch)[2])
                    floor = leaf_errors(single["float32"][1], g64, scale_of)
                    del p64, g64
                    pooled = [max(floor)] * len(floor) if arch == "xlstm-125m" else floor
                    bounds = [max(LMM_FP32_TOL, 2 * f) for f in pooled]
                    over = [e / t for e, t in zip(e_mesh, bounds)]
                    k = int(np.argmax(over))
                    rec["fp32_floor"] = worst(floor)
                    rec["tolerance"] = LMM_FP32_TOL
                    rec["worst_of_its_bound"] = (over[k], paths[k], bounds[k])
                    rec["floor_pooled"] = pooled is not floor
                    rec["ok"] = max(over) <= 1.0
                else:
                    rec["tolerance"] = LMM_BF16_FACTOR * max(e_single)
                    rec["ok"] = max(e_mesh) <= rec["tolerance"]
                rec["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
                rec["turn_wait_s"] = turn["wait_s"]
                out[key] = rec
                del got
            del local, single
            if writer:
                del params
            gc.collect()
            torch.cuda.empty_cache()
    return out


def ssm_mesh_rank(mesh, serve: dict) -> dict:
    """Phase 15's meshed section on one rank of the (1, 2) gloo mesh on the
    card: the full-width layer hold (``ssm_layer_hold``); zamba2-7b at
    ``SSM_MESH_ZAMBA``'s depth and xlstm-125m at full depth served
    (``lms_rank``: a timed prefill with the kernels held on this rank's own
    calls, greedy and teacher-forced decode steps; zamba2's prefill peak
    beside the dry run's trace of this rank); the step-1 gradients
    (``ssm_mesh_train``)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import qr_gather as qg

    torch.backends.cuda.matmul.allow_tf32 = False
    mods = (fa, qg)
    res = {"coords": dict(mesh.coords)}
    t = time.perf_counter()
    with card_turn(mesh):
        res["layer_hold"] = ssm_layer_hold(mesh)
    res["layer_hold_s"] = time.perf_counter() - t
    for arch in SSM_ARCHS:
        t = time.perf_counter()
        res[arch] = lms_rank(mesh, serve[arch]["cfg"], serve[arch], mods,
                             dry_hold=arch == "zamba2-7b", fp32=arch == "xlstm-125m")
        res[f"{arch}_s"] = time.perf_counter() - t
    t = time.perf_counter()
    res["train"] = ssm_mesh_train(mesh, mods)
    res["train_s"] = time.perf_counter() - t
    return res


def ssm_mesh_world1(dev, mods, totals) -> dict:
    """World 1 over nccl in this process, mesh (1, 1): zamba2-7b and
    xlstm-125m at ``SSM_GRAD_DEPTH`` with the QR vocabulary, bf16: the
    meshed prefill of ``SSM_WORLD1``'s prompts, its cache or states and its
    greedy decode steps (``lms_world1``), and the step-1 gradients, each
    against the single card's from the same params and tokens, read for
    bitwise equality."""
    import datetime

    import torch.distributed as dist

    from repro_torch import tree
    from repro_torch.configs import registry
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import mesh as M
    from repro_torch.train import train_step as TS

    b, seq, steps = SSM_WORLD1
    rdv = ROOT / "build" / "ssm_mesh" / "rdv_world1"
    rdv.parent.mkdir(parents=True, exist_ok=True)
    rdv.unlink(missing_ok=True)
    log("[mesh] 1 rank, mesh (1, 1) over ('data', 'model'), backend nccl, on 1 card "
        "(in process)")
    dist.init_process_group("nccl", init_method=f"file://{rdv}", world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=120))
    rec = {}
    try:
        mesh = M.make_mesh((1, 1), ("data", "model"), device=dev)
        for arch in SSM_ARCHS:
            cfg = ssm_mesh_cfg(arch, num_layers=SSM_GRAD_DEPTH[arch])
            params, axes = lm_init(cfg, dev)
            batch = lmm_tokens(cfg, b, seq, dev, seed=19)
            take_launches(mods, totals)
            serving = lms_world1(cfg, params, axes, mesh, batch, steps)
            fn = registry.train_loss_fn(lm_binding(cfg), cfg)
            specs = registry.lm_specs(cfg, params, axes, mesh)
            local = SH.shard_tree(params, specs, mesh)

            def meshed(p, bb):
                with SH.use_rules(mesh, SH.DEFAULT_RULES):
                    return fn(p, bb)

            _, _, g_mesh = TS.value_and_grad(meshed, local, batch)
            _, _, g_one = TS.value_and_grad(fn, params, batch)
            torch.cuda.synchronize()
            grads = all(torch.equal(SH.gather(a, s, mesh), w) for a, s, w in
                        zip(tree.leaves(g_mesh), specs, tree.leaves(g_one)))
            n = take_launches(mods, totals)
            rec[arch] = {"layers": cfg.num_layers, "batch": b, "seq": seq, "steps": steps,
                         "bitwise": {**serving["bitwise"], "step1_grads": grads},
                         "launches": n}
            log(f"[ssm-mesh] world 1 nccl {arch} at {cfg.num_layers} layers, QR, bf16, {b} x "
                f"{seq} prompts + {steps} greedy steps and one step's gradients, the mesh "
                f"against the single card: bitwise {rec[arch]['bitwise']}; launches {n}")
            del params, local, g_mesh, g_one
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    if not all(all(r["bitwise"].values()) for r in rec.values()):
        raise AssertionError(f"[ssm-mesh] world 1 nccl: {rec}")
    return rec


def ranks_in_thread(fn, shape, args, init_file: Path, name: str, *, alloc=None) -> dict:
    """``launch.mesh.spawn(fn, shape, args=args)`` of gloo ranks on the card
    in a thread, so that this process goes on while they run (phase 17's
    drills); ``join_ranks`` returns their records.  With ``alloc`` the ranks
    start with it as their ``PYTORCH_CUDA_ALLOC_CONF``: set until their
    rendezvous file appears (the ranks have started), then restored."""
    import threading

    from repro_torch.launch import mesh as M

    got = {"t0": time.perf_counter()}
    init_file.parent.mkdir(parents=True, exist_ok=True)
    init_file.unlink(missing_ok=True)

    def run():
        try:
            got["ranks"] = M.spawn(fn, shape, args=args, device="cuda", backend="gloo",
                                   init_file=init_file, timeout_s=LMM_TIMEOUT_S)
        except BaseException as e:           # raised by ``join_ranks``
            got["error"] = e
        got["s"] = time.perf_counter() - got["t0"]

    saved = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    if alloc is not None:
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc
    got["thread"] = threading.Thread(target=run, name=name)
    got["thread"].start()
    if alloc is not None:
        deadline = time.perf_counter() + 120
        while (not init_file.exists() and got["thread"].is_alive()
               and time.perf_counter() < deadline):
            time.sleep(0.2)
        if saved is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = saved
    return got


def join_ranks(got: dict) -> tuple[list, float]:
    """The records of ``ranks_in_thread``'s ranks (a rank's error raised
    here) and their seconds from the start."""
    got["thread"].join()
    if "error" in got:
        raise got["error"]
    return got["ranks"], got["s"]


def ssm_mesh_section(dev, mods, totals) -> dict:
    """Phase 15's meshed section in one go: ``ssm_mesh_start`` then
    ``ssm_mesh_finish`` (the script runs the two halves around phase 17's
    drills instead).  The launches add to ``totals``."""
    return ssm_mesh_finish(ssm_mesh_start(dev, mods), totals)


def ssm_mesh_start(dev, mods) -> dict:
    """Phase 15's meshed section, its first half: world 1 over nccl in this
    process (``ssm_mesh_world1``); the single card's serving references
    (greedy bf16, teacher-forced fp32) of zamba2-7b at ``SSM_MESH_ZAMBA``'s
    depth and xlstm-125m at full depth, QR; one spawn of (1, 2) gloo ranks
    on the card (``ssm_mesh_rank``) started in a thread
    (``ranks_in_thread``), held by ``ssm_mesh_finish`` (the serving CLI
    drill, ``SSM_SERVE_CLI``, runs in phase 17).  Returns the pending
    record."""
    totals = {}
    reset_all(mods)
    rec = {"section_s": {}}
    t0 = time.perf_counter()
    rec["world1"] = ssm_mesh_world1(dev, mods, totals)
    rec["section_s"]["world1"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    layers, zb, zs, zsteps = SSM_MESH_ZAMBA
    xb, xs, xsteps = SSM_MESH_XLSTM
    cfgs = {"zamba2-7b": (ssm_mesh_cfg("zamba2-7b", num_layers=layers), zb, zs, zsteps),
            "xlstm-125m": (ssm_mesh_cfg("xlstm-125m"), xb, xs, xsteps)}
    serve, refs = {}, {}
    for arch, (cfg, b, seq, steps) in cfgs.items():
        prompts = lms_prompts(cfg, b, seq)
        refs[arch] = lms_single(cfg, prompts, steps, dev, fp64=arch == "xlstm-125m")
        serve[arch] = {"cfg": cfg, "prompts": prompts, "forced": refs[arch]["tokens"]}
    torch.cuda.synchronize()
    rec["single_card_launches"] = take_launches(mods, totals)
    rec["section_s"]["single_card"] = time.perf_counter() - t1
    log(f"[ssm-mesh] the single card's references (greedy bf16, forced fp32, xlstm's "
        f"forced fp64) in "
        f"{rec['section_s']['single_card']:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    got = ranks_in_thread(ssm_mesh_rank, SSM_MESH_SHAPE, (serve,),
                          ROOT / "build" / "ssm_mesh" / "rdv", "ssm-mesh-ranks",
                          alloc=LMT_ALLOCATOR)
    return {"rec": rec, "totals": totals, "cfgs": cfgs, "refs": refs, "got": got, "t0": t0}


def ssm_mesh_finish(pending: dict, totals) -> dict:
    """Phase 15's meshed section, its second half: the ranks of
    ``ssm_mesh_start`` joined and their records held: the layer hold, each
    arch's logits against the single card's (``lms_hold``), zamba2's prefill
    peak against the dry run's, the step-1 gradients.  The section's and the
    ranks' K9 and K8 launches add to ``totals``."""
    rec, cfgs, refs = pending["rec"], pending["cfgs"], pending["refs"]
    for k, v in pending["totals"].items():
        totals[k] = totals.get(k, 0) + v
    ranks, rec["section_s"]["ranks"] = join_ranks(pending["got"])
    r0 = next(r for r in ranks if not any(r["coords"].values()))
    log(f"[ssm-mesh] mesh {SSM_MESH_SHAPE}: the ranks took {rec['section_s']['ranks']:.1f} s "
        f"(on rank (0, 0): the layer hold {r0['layer_hold_s']:.1f} s, zamba2 "
        f"{r0['zamba2-7b_s']:.1f} s, xlstm {r0['xlstm-125m_s']:.1f} s, training "
        f"{r0['train_s']:.1f} s)")
    for r in ranks:
        for arch in SSM_ARCHS:
            for k, v in r[arch]["launches"].items():
                totals[k] = totals.get(k, 0) + v
        for t in r["train"].values():
            for k, v in t["launches"].items():
                totals[k] = totals.get(k, 0) + v
    lh = rec["layer_hold"] = r0["layer_hold"]
    log(f"[ssm-mesh] full-width layer hold, zamba2-7b's mamba layer and shared block on mesh "
        f"{SSM_MESH_SHAPE} against one card, {lh['shape'][0]} x {SSM_LAYER_HOLD[1]} unit-scale "
        f"hidden states + {SSM_LAYER_HOLD[2]} decode steps (fp32 {lh['fp32_ms']:.0f} ms, bf16 "
        f"{lh['bf16_ms']:.0f} ms on the ranks), each of its scale: "
        + "; ".join(f"{k} fp32 {lh['fp32'][k]:.3g} (held to {LMM_FP32_TOL:g}), bf16 "
                    f"{lh['bf16'][k]:.3g} (held to {LMM_BF16_FACTOR:g} x the single card's "
                    f"{lh['bf16_single_card'][k]:.3g}; from the single card's bf16 "
                    f"{lh['bf16_vs_single_card_bf16'][k]:.3g})" for k in lh["fp32"]))
    # every reading is logged before a failed hold raises
    faults = [] if lh["ok"] else [f"[ssm-mesh] the full-width layer hold: {lh}"]
    rec["serving"] = {}
    for arch in SSM_ARCHS:
        cfg = cfgs[arch][0]
        served = [r[arch] for r in ranks]
        try:
            srec = lms_hold(served, refs[arch], SSM_MESH_SHAPE, cfg, "[ssm-mesh]")
        except AssertionError as e:
            faults.append(str(e))
            continue
        if arch == "zamba2-7b":
            srec["peak_hold"] = lms_peak_hold(served, cfg, SSM_MESH_SHAPE)
            srec["collapse_note"] = ("the reference's hidden state collapses toward zero with "
                                     "depth (ROADMAP.md §3): the layer hold is the one that "
                                     "can fail")
        rec["serving"][arch] = srec
    rec["train"] = r0["train"]
    for arch, t in rec["train"].items():
        log(f"[ssm-mesh] {arch} mesh {SSM_MESH_SHAPE} step-1 gradients at {t['layers']} layers, "
            f"{t['batch']} x {t['seq']}, {t['compute']}, gathered, vs the single card in fp32 "
            f"compute: the mesh {t['mesh_vs_fp32'][0]:.3g} of scale (worst "
            f"{t['mesh_vs_fp32'][1]}; held to {t['tolerance']:.3g}"
            + (f", or twice fp32's own {'worst ' if t.get('floor_pooled') else ''}distance "
               f"from fp64 where larger: worst "
               f"{t['worst_of_its_bound'][0]:.3g} of its bound {t['worst_of_its_bound'][2]:.3g} "
               f"({t['worst_of_its_bound'][1]}; fp32's own worst {t['fp32_floor'][0]:.3g}, "
               f"{t['fp32_floor'][1]})" if "worst_of_its_bound" in t else "")
            + f"), the single card in the same compute {t['single_card_vs_fp32'][0]:.3g} "
            f"({t['single_card_vs_fp32'][1]}); "
            f"loss {t['loss']:.6f} vs {t['loss_single_card']:.6f}; the meshed forward and "
            f"backward {t['ms']:.1f} ms; rank (0, 0)'s peak {t['peak_gib']:.2f} GiB, the "
            f"ranks' wait for the card {t['turn_wait_s']:.1f} s; collectives {t['sites']} "
            f"[calls, B]")
        if not t["ok"]:
            faults.append(f"[ssm-mesh] {arch} step-1 gradients: {t}")
    if faults:
        raise AssertionError("\n".join(faults))
    rec["section_s"]["total"] = time.perf_counter() - pending["t0"]
    return rec


def ssm_phase(dev, by_name, mods, mesh: bool = True) -> dict:
    """Phase 15: the sub-quadratic models served and trained, on one card
    and on a mesh.
    ``[ssm-ref]`` on the two smoke configs; zamba2-7b and xlstm-125m at full
    width and depth (``ssm_serve_run``: consistency, zamba2's K9 on the
    model path at D 112, ``prefill_32k``, ``decode_32k``, ``long_500k``);
    the serve CLI (zamba2 with each vocabulary, xlstm with QR) and the
    serve-LM example; training on one card (the allocator's expandable
    segments): xlstm at full depth, one step of 2 microbatches, zamba2 at
    the depth the dry run fits, 2 steps, each QR at
    S 4,096; the step-1 gradients of a cut (``SSM_GRAD_DEPTH``) against the
    kernels' plain versions; the meshed section (``ssm_mesh_section``:
    world 1 over nccl, the full-width layer hold, both archs served and
    their step-1 gradients on (1, 2) gloo ranks; the CLI drills on a mesh
    run in phase 17; without ``mesh`` the script runs the section's two
    halves around phase 17, ``ssm_mesh_start`` / ``ssm_mesh_finish``).  The
    phase's launches add to the ``flash_fwd`` and ``qr_gather`` rows.  Returns the ``{"sub_quadratic": ...}``
    record."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[ssm] before the phase: {torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB "
        f"allocated, {torch.cuda.mem_get_info(dev)[0] / 2**30:.2f} GiB free")
    totals = {}
    reset_all(mods)
    record = {"section_s": {}}

    def section(key, run):
        t1 = time.perf_counter()
        record[key] = run()
        record["section_s"][key] = time.perf_counter() - t1
        log(f"[ssm] section {key}: {record['section_s'][key]:.1f} s")

    section("ref", lambda: ssm_ref_phase(dev, mods, totals))
    if dev.type == "cuda":
        section("slstm_graphs", lambda: ssm_graph_check(dev))
    for arch in SSM_ARCHS:
        section(arch, lambda: ssm_serve_run(dev, arch, mods, totals))
    section("cli", lambda: [lm_cli_run(v, mods, totals, arch="zamba2-7b", tag="[ssm-cli]",
                                       cli=SSM_ZAMBA_CLI) for v in ("dense", "qr")]
            + [lm_cli_run("qr", mods, totals, arch="xlstm-125m", tag="[ssm-cli]"),
               ssm_example_run(mods, totals)])
    torch.cuda.memory._set_allocator_settings(LMT_ALLOCATOR)
    try:
        batch, micro = SSM_XLSTM_TRAIN
        section("train_xlstm", lambda: lm_train_fitted(
            dev, "xlstm-125m", "qr", mods, totals, tag="[ssm-train]", steps=1,
            depth=lm_config("xlstm-125m").num_layers, batch_size=batch, microbatches=micro))
        section("train_zamba2", lambda: lm_train_fitted(
            dev, "zamba2-7b", "qr", mods, totals, tag="[ssm-train]", steps=SSM_TRAIN_STEPS))
        # zamba2's cut is held in fp32 and read in bf16: its hidden state has
        # all but collapsed by layer 6 (no residual, ROADMAP.md §3), where a
        # bf16 rounding of K9's output moves the step-1 gradients through
        # the gated norms' eps by up to 0.68 of a leaf's scale
        section("grad_check", lambda: {
            "xlstm-125m": lm_train_grad_check(
                dev, mods, totals, arch="xlstm-125m", vocabs=("qr",), tag="[ssm-train]",
                depth=SSM_GRAD_DEPTH["xlstm-125m"]),
            "zamba2-7b": lm_train_grad_check(
                dev, mods, totals, arch="zamba2-7b", vocabs=("qr",), tag="[ssm-train]",
                depth=SSM_GRAD_DEPTH["zamba2-7b"], compute="float32"),
            "zamba2-7b bf16": lm_train_grad_check(
                dev, mods, totals, arch="zamba2-7b", vocabs=("qr",), tag="[ssm-train]",
                depth=SSM_GRAD_DEPTH["zamba2-7b"], hold=False)})
    finally:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.memory._set_allocator_settings("expandable_segments:False")
    if mesh:
        section("mesh", lambda: ssm_mesh_section(dev, mods, totals))
    record["launches"] = totals
    for name in ("flash_fwd", "qr_gather"):
        by_name[name]["launches"] += totals.get(name, 0)
    record["phase_s"] = time.perf_counter() - t0
    log(f"[ssm] phase {record['phase_s']:.1f} s; launches {totals}")
    return record


# ---------------------------------------------------------------------------
# phase 16: the prefix models (whisper's encoder-decoder, pixtral's patch
# prefix) served and trained on one card
# ---------------------------------------------------------------------------

PREFIX_ARCHS = ("whisper-large-v3", "pixtral-12b")
# repro's decode-vs-train bounds (tests/test_models_consistency.py): the
# prefill's last row, the decode step
PREFIX_CONSIST_TOL = (5e-5, 1e-4)
# whisper-large-v3's full-depth training step: sequences, microbatches (train_4k's
# 256 cut for the script's time, as xlstm-125m's)
PREFIX_WHISPER_TRAIN = (4, 2)
PREFIX_TRAIN_STEPS = 2
PREFIX_GRAD_DEPTH = 2         # a 2-layer cut (whisper: 2 encoder + 2 decoder layers)
PREFIX_CLI = ("--smoke", "--batch", "2", "--prompt-len", "16", "--max-new", "4")
PREFIX_TRAIN_CLI = ("--smoke", "--embedding", "qr", "--batch", "2", "--seq", "32", "--steps",
                    "2", "--log-every", "1")


def prefix_key(cfg) -> str:
    """The batch key of a prefix model's rows: whisper's frames, pixtral's
    patches."""
    return "frames" if cfg.is_encoder_decoder else "patches"


def prefix_forward(cfg):
    """The train forward of a prefix model: ``(params, prefix, tokens, cfg)
    -> logits``."""
    from repro_torch.models import pixtral as P
    from repro_torch.models import whisper as W

    return W.forward_train if cfg.is_encoder_decoder else P.forward_train


def prefix_consistency(params, cfg, batch: dict, fam) -> dict:
    """``repro``'s decode-vs-train check on the port (fp32): the serve
    family's prefill of all but the last token and one decode step (at the
    position after the patches, for pixtral) against ``forward_train``'s
    last two rows, within ``PREFIX_CONSIST_TOL``."""
    toks = batch["tokens"]
    s = toks.shape[1]
    with torch.inference_mode():
        full = prefix_forward(cfg)(params, batch[prefix_key(cfg)], toks, cfg)
        lg, cache = fam.prefill(params, {**batch, "tokens": toks[:, :s - 1]}, cfg, s)
        lg2, _ = fam.decode(params, cache, toks[:, s - 1:], s - 1 + cfg.num_patches, cfg)
    out = {}
    for (name, a, b), tol in zip((("prefill", lg[:, 0], full[:, s - 2]),
                                  ("decode", lg2[:, 0], full[:, s - 1])), PREFIX_CONSIST_TOL):
        d = (a - b).abs()
        out[name] = float(d.max())
        if not bool((d <= tol + tol * b.abs()).all()):
            raise AssertionError(f"[prefix-ref] {cfg.name} consistency {name}: {out[name]}")
    return out


def prefix_ref_phase(dev, mods, totals) -> dict:
    """``[prefix-ref]``: whisper-large-v3-smoke and pixtral-12b-smoke, each
    with a dense and a QR (collision 8) vocabulary, fp32 compute, the same
    weights carried from the CPU onto the card by
    ``convert.lm_params_from_numpy`` and the same batch (frames or patches
    and 12 tokens): ``forward_train``'s logits, the serve family's prefill
    (its last logits and every cache leaf: whisper's self and cross k / v)
    and one decode step within ``LM_REF_TOL``, the greedy tokens equal, K9
    once an attention a forward and K8 once a QR lookup; ``repro``'s
    decode-vs-train consistency on the card (``prefix_consistency``)."""
    from repro_torch import convert, tree
    from repro_torch.configs import registry
    from repro_torch.train import serve_step as S

    out = {}
    for arch in PREFIX_ARCHS:
        binding = registry.get(arch)
        fam = S.serve_family(binding.kind)
        for vocab in ("dense", "qr"):
            tag = f"[prefix-ref] {arch} {vocab}"
            cfg = binding.smoke.replace(embedding_kind=vocab, qr_collision=8,
                                        compute_dtype="float32")
            key, fwd = prefix_key(cfg), prefix_forward(cfg)
            cpu, _ = registry.init_fn(binding)(cfg, seed=0, device="cpu")
            card = convert.lm_params_from_numpy(tree.tree_map(lambda a: a.numpy(), cpu), dev)
            batch = registry.make_batch_fn(binding, cfg)(2, 12, seed=1, step=0)
            on = {k: v.to(dev) for k, v in batch.items()}
            prompt = {**batch, "tokens": batch["tokens"][:, :8]}
            on_prompt = {**on, "tokens": on["tokens"][:, :8]}
            pos = 8 + cfg.num_patches
            errs = {}
            with torch.inference_mode():
                reset_all(mods)
                got = fwd(card, on[key], on["tokens"], cfg)
                torch.cuda.synchronize()
                n = take_launches(mods, totals)
                want_n = {"flash_fwd": k9_calls(cfg), **({"qr_gather": 1} if vocab == "qr"
                                                          else {})}
                if n != want_n:
                    raise AssertionError(f"{tag}: launches {n}, not {want_n}")
                card_vs_cpu("train", got, fwd(cpu, batch[key], batch["tokens"], cfg), errs, tag)
                lg, cache = fam.prefill(card, on_prompt, cfg, 12)
                clg, ccache = fam.prefill(cpu, prompt, cfg, 12)
                card_vs_cpu("prefill", lg, clg, errs, tag)
                for a, b in zip(tree.leaves(cache), tree.leaves(ccache)):
                    card_vs_cpu("cache", a, b, errs, tag)
                lg2, _ = fam.decode(card, cache, on["tokens"][:, 8:9], pos, cfg)
                clg2, _ = fam.decode(cpu, ccache, batch["tokens"][:, 8:9], pos, cfg)
                card_vs_cpu("decode", lg2, clg2, errs, tag)
            tok_card = S.greedy_generate(fam, card, on_prompt, cfg, max_new=4, max_len=12).cpu()
            tok_cpu = S.greedy_generate(fam, cpu, prompt, cfg, max_new=4, max_len=12)
            if not torch.equal(tok_card, tok_cpu):
                raise AssertionError(f"{tag}: greedy tokens {tok_card} vs {tok_cpu}")
            errs["consistency"] = prefix_consistency(card, cfg, on, fam)
            take_launches(mods, totals)
            out[f"{arch}/{vocab}"] = errs
            c = errs["consistency"]
            log(f"{tag} vocab, card vs CPU (fp32): max |diff| train {errs['train']:.2e}, prefill "
                f"{errs['prefill']:.2e}, cache {errs['cache']:.2e}, decode {errs['decode']:.2e} "
                f"(held to {LM_REF_TOL}); greedy tokens equal; repro's consistency on the card: "
                f"prefill {c['prefill']:.2e}, decode {c['decode']:.2e} (held to "
                f"{PREFIX_CONSIST_TOL}); launches a forward {n}")
    return out


@contextlib.contextmanager
def kept_attention_sites(ops, kept: dict):
    """While open: the first K9 call of each kind of site, its q/k/v and
    output (the last batch row, copied) under ``kept["k9"][site]`` with
    ``site`` ``causal`` (a decoder's self-attention, pixtral's),
    ``non-causal`` (whisper's encoder) or ``cross`` (Sq != Skv), and every K8
    call's inputs and output in the list ``kept["k8"]``."""
    saved = ops.flash_attention_fused

    def k9(q, k, v, *, causal=True, p_bf16=False):
        out = saved(q, k, v, causal=causal, p_bf16=p_bf16)
        site = "causal" if causal else ("cross" if q.shape[2] != k.shape[2] else "non-causal")
        sites = kept.setdefault("k9", {})
        if site not in sites:
            sites[site] = tuple(t[-1:].detach().clone() for t in (q, k, v, out))
        return out

    def k8(a, out):
        kept.setdefault("k8", []).append(tuple(t.detach() for t in (*a[:4], out)))

    ops.flash_attention_fused = k9
    try:
        with kept_calls(ops, "qr_lookup", k8):
            yield kept
    finally:
        ops.flash_attention_fused = saved


def hold_sites(kept: dict, where: str) -> dict:
    """``kept_attention_sites``' captures held against their plain versions:
    each site's K9 by ``hold_attention`` (its own causality), the K8 calls
    as ``hold_kept`` holds them."""
    rec = {f"k9 {site}": hold_attention(*args, causal=site == "causal")
           for site, args in kept.get("k9", {}).items()}
    bad = {k: v for k, v in rec.items() if not v["ok"]}
    if bad:
        raise AssertionError(f"[prefix] {where}: K9 vs plain on the main path {bad}")
    if "k8" in kept:
        rec.update(hold_kept({"k8": kept["k8"]}, where))
    return rec


def sites_text(held: dict) -> str:
    """``hold_sites``' record as one line."""
    parts = [f"K9 {k[3:]} {v['shape']} {fmt_err(v)}" for k, v in held.items()
             if k.startswith("k9 ")]
    if "k8" in held:
        parts.append(held_text({"k8": held["k8"]}))
    return "; ".join(parts)


@contextlib.contextmanager
def prefix_watch(cfg):
    """While open, for whisper: a pair of CUDA events around the encoder
    (``whisper.encode``) and around every decoder layer
    (``whisper._dec_layer_fwd``): ``{part: [(start, end), ...]}``; for
    pixtral nothing."""
    from repro_torch.models import whisper as W

    marks = {}
    if not cfg.is_encoder_decoder:
        yield marks
        return
    names = (("encode", "encoder"), ("_dec_layer_fwd", "decoder"))
    saved = {name: getattr(W, name) for name, _ in names}

    def wrap(fn, part):
        def call(*a, **kw):
            e = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            e[0].record()
            out = fn(*a, **kw)
            e[1].record()
            marks[part].append(e)
            return out
        return call

    for name, part in names:
        marks[part] = []
        setattr(W, name, wrap(saved[name], part))
    try:
        yield marks
    finally:
        for name, fn in saved.items():
            setattr(W, name, fn)


def prefix_prefill_flops(cfg, batch: int, seq: int) -> int:
    """A prefill's matrix-product and attention flops: pixtral's as a
    decoder's over its patches and tokens (``prefill_flops``); whisper's
    encoder over ``N_AUDIO`` frames (2 x its layers' weights a frame, 4 D a
    (query, key) pair and head), its decoder over ``seq`` tokens (2 x the
    self-attention's, q and o of the cross-attention's and the MLP's
    weights a token, causal self-attention, the cross-attention's 4 D a
    (token, frame) pair and head), the cross k and v over the frames, and
    the head on the last token."""
    from repro_torch.models.whisper import N_AUDIO

    if not cfg.is_encoder_decoder:
        return prefill_flops(cfg, batch, seq + cfg.num_patches)
    d, hd, h = cfg.d_model, cfg.head_dim_, cfg.num_heads
    attn_w = 4 * d * h * hd
    mlp_w = 2 * d * cfg.d_ff
    pair = 4 * hd * h
    enc = cfg.enc_layers * (2 * (attn_w + mlp_w) * N_AUDIO + pair * N_AUDIO * N_AUDIO)
    dec = cfg.dec_layers * (2 * (attn_w + 2 * d * h * hd + mlp_w) * seq
                            + pair * seq * (seq + 1) // 2 + pair * seq * N_AUDIO
                            + 2 * 2 * d * h * hd * N_AUDIO)
    return batch * (enc + dec + 2 * d * cfg.vocab)


def prefix_prefill_run(params, cfg, dev, mods, totals, batch: int | None = None) -> dict:
    """``prefill_32k`` through the serve family: one prefill of 32,768
    tokens (pixtral's behind its 256 patches) at ``batch`` or, without one,
    at the largest batch that fits, cut to the cell's 32, by the dry run's
    fit as phase 11's (``dry_fit``); the measured peak held to the trace's
    (``hold_peak``).  Timed by CUDA events: the call, K9 and K8 around every
    call, whisper's encoder and decoder layers around each call
    (``prefix_watch``); the first K9 call of each kind of site and every K8
    call kept and held against their plain versions after it
    (``hold_sites``); peak memory; the flop bound
    (``prefix_prefill_flops``); K9 against SDPA at the decoder's causal
    shapes, and whisper's at its cross shapes."""
    from repro_torch.configs.base import LM_SHAPES
    from repro_torch.kernels import ops
    from repro_torch.models.whisper import N_AUDIO
    from repro_torch.launch import dryrun
    from repro_torch.train import serve_step as S

    fam = S.serve_family("whisper" if cfg.is_encoder_decoder else "pixtral")
    cell = next(s for s in LM_SHAPES if s.name == "prefill_32k")
    seq = cell.seq_len
    g = torch.Generator(device=dev).manual_seed(3)

    meta = dryrun.to_meta(params)

    def predict(b: int) -> int:
        return dry(lambda: fam.prefill(meta, meta_tokens(cfg, b, seq), cfg, seq),
                   lambda: kept_attention_sites(ops, {}))

    fit = {}
    if batch is None:
        fit = dry_fit(predict, free_budget(dev), cell.global_batch)
        batch = fit["size"]
    reset_all(mods)
    inputs = lm_batch_for(cfg, batch, seq, g, dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    base = peak_base(dev)
    kept = {}
    with timed_entries(ops, ("flash_attention_fused", "qr_lookup")) as marks, \
            kept_attention_sites(ops, kept), prefix_watch(cfg) as parts:
        with torch.inference_mode():
            start.record()
            t0 = time.perf_counter()
            logits, cache = fam.prefill(params, inputs, cfg, seq)
            end.record()
            torch.cuda.synchronize()
            host_s = time.perf_counter() - t0
    held_peak = hold_peak(f"{cfg.name} {cfg.embedding_kind} prefill_32k batch {batch}",
                          fit["traced"][batch] if fit else predict(batch), base, dev)
    n = take_launches(mods, totals)
    ms = start.elapsed_time(end)
    peak = torch.cuda.max_memory_allocated(dev)
    want = {"flash_fwd": k9_calls(cfg), **({"qr_gather": 1} if cfg.embedding_kind == "qr"
                                            else {})}
    if n != want or tuple(logits.shape) != (batch, 1, cfg.vocab) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"[prefix] {cfg.name} prefill_32k: launches {n}, logits "
                             f"{tuple(logits.shape)}")
    cache_bytes = sum(a.numel() * a.element_size() for a in cache.values())
    del logits, cache, inputs
    torch.cuda.empty_cache()
    held = hold_sites(kept, f"{cfg.name} prefill_32k")
    del kept
    flops = prefix_prefill_flops(cfg, batch, seq)
    k9_ms = event_ms(marks["flash_attention_fused"])
    rec = {"seq": seq, "prefix_rows": N_AUDIO if cfg.is_encoder_decoder else cfg.num_patches,
           "batch": batch, "cell_batch": cell.global_batch, "fit": fit, "peak_hold": held_peak,
           "ms": ms, "host_s": host_s,
           "tokens_per_s": batch * seq / ms * 1e3, "k9_ms": k9_ms, "k9_share": k9_ms / ms,
           "k9_calls": len(marks["flash_attention_fused"]),
           "k8_ms": event_ms(marks["qr_lookup"]),
           "parts_ms": {k: event_ms(v) for k, v in parts.items()},
           "parts_calls": {k: len(v) for k, v in parts.items()}, "cache_bytes": cache_bytes,
           "peak_gib": peak / 2**30, "flops": flops, "bound_ms": flops / BF16_FLOP_S * 1e3,
           "launches": n, "held": held}
    rec["parts_share"] = {k: v / ms for k, v in rec["parts_ms"].items()}
    rec["k9_vs_sdpa"] = [k9_against_sdpa(cfg, batch, seq + cfg.num_patches, dev)]
    if cfg.is_encoder_decoder:
        rec["k9_vs_sdpa"].append(k9_against_sdpa(cfg, batch, seq, dev, skv=N_AUDIO,
                                                 causal=False))
    reset_all(mods)                 # the yardstick's launches are not the path's
    return rec


def prefix_decode_run(params, cfg, dev, mods, totals, batch: int | None = None) -> dict:
    """``decode_32k``: one decode step at the cache's last position (32,767,
    pixtral's 256 + 32,767) against a cache 32,768 text positions deep
    (every leaf random: whisper's self and cross k / v, pixtral's k / v over
    its patches and the text) at ``batch`` or the largest batch whose cache
    fits the free memory less ``LM_HEADROOM``; ms a step by CUDA events
    over ``LM_DECODE_REPS`` steps beside the bytes bound (every weight and
    the whole cache read once, at the HBM rate); each step's K8 call held
    against the plain sum; no K9 (a decode step's attention is plain)."""
    from repro_torch import tree
    from repro_torch.configs.base import LM_SHAPES
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.train import serve_step as S

    fam = S.serve_family("whisper" if cfg.is_encoder_decoder else "pixtral")
    cell = next(s for s in LM_SHAPES if s.name == "decode_32k")
    depth = cell.seq_len
    gc.collect()
    torch.cuda.empty_cache()
    if batch is None:
        one = fam.make_cache(cfg, 1, depth, device=dev)
        per_seq = sum(a.numel() * a.element_size() for a in one.values())
        del one
        torch.cuda.empty_cache()
        free = torch.cuda.mem_get_info(dev)[0]
        batch = int(max(1, min(cell.global_batch, (free - LM_HEADROOM) // per_seq)))
    base = peak_base(dev)               # the cell's baseline: before its cache
    cache = fam.make_cache(cfg, batch, depth, device=dev)
    g = torch.Generator(device=dev).manual_seed(4)
    for leaf in cache.values():
        leaf.normal_(generator=g)
    pos = cache["k"].shape[2] - 1
    tok = torch.randint(0, cfg.vocab, (batch, 1), generator=g, device=dev, dtype=torch.int32)
    reset_all(mods)
    meta = dryrun.to_meta((params, cache, tok))
    predicted = dryrun.storage_bytes(meta[1:]) + dry(
        lambda: decode_reps(fam.decode, *meta, pos, cfg), lambda: kept_model_path(ops, {}))
    with torch.inference_mode():
        top = top_device_ops(lambda: fam.decode(params, cache, tok, pos, cfg), 6)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        kept = {}
        with kept_model_path(ops, kept):
            start.record()
            logits, out = decode_reps(fam.decode, params, cache, tok, pos, cfg)
            end.record()
            torch.cuda.synchronize()
    held_peak = hold_peak(f"{cfg.name} {cfg.embedding_kind} decode_32k batch {batch}", predicted,
                          base, dev)
    n = take_launches(mods, totals)
    if out is not cache or n.get("flash_fwd") or tuple(logits.shape) != (
            batch, 1, cfg.vocab) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"[prefix] {cfg.name} decode_32k: launches {n}, logits "
                             f"{tuple(logits.shape)}")
    held = hold_kept(kept, f"{cfg.name} decode_32k")
    ms = start.elapsed_time(end) / LM_DECODE_REPS
    weight_bytes = sum(a.numel() * a.element_size() for a in tree.leaves(params))
    cache_bytes = sum(a.numel() * a.element_size() for a in cache.values())
    rec = {"depth": depth, "position": pos, "batch": batch, "cell_batch": cell.global_batch,
           "cache_bytes": cache_bytes, "weight_bytes": weight_bytes, "ms": ms,
           "tokens_per_s": batch / ms * 1e3,
           "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
           "bound_ms": (weight_bytes + cache_bytes) / BW_BYTES_S * 1e3, "launches": n,
           "held": held, "top_ops": top, "peak_hold": held_peak}
    del cache, logits, out, kept
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def prefix_serve_run(dev, arch: str, mods, totals) -> dict:
    """``arch`` at full width and depth: the fp32 params drawn and cast once
    for serving (``prepare``), the fp32 tree freed, the peak of the two
    recorded; whisper with the dense then the QR vocabulary (collision 64;
    its tables drawn, the body shared), pixtral with the QR vocabulary
    only: ``prefill_32k`` at the batch the first run fits (``PREFIX_FIT_
    BATCHES``; whisper's QR run at ``QR_PREFILL_BATCH``) and ``decode_32k``
    at the batch whose cache fits."""
    from repro_torch import tree
    from repro_torch.configs import registry
    from repro_torch.train import serve_step as S

    binding = registry.get(arch)
    fam = S.serve_family(binding.kind)
    vocabs = ("dense", "qr") if binding.kind == "whisper" else ("qr",)
    cfg = lm_config(arch).replace(embedding_kind=vocabs[0])
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    params, _ = registry.init_fn(binding)(cfg, seed=0, device=dev)
    fp32_bytes = sum(a.numel() * a.element_size() for a in tree.leaves(params))
    params = fam.prepare(params, cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated(dev) - base
    gc.collect()
    torch.cuda.empty_cache()
    rec = {"arch": arch, "layers": cfg.num_layers, "init_s": init_s,
           "param_bytes_fp32": fp32_bytes,
           "serving_bytes": sum(a.numel() * a.element_size() for a in tree.leaves(params)),
           "init_peak_gib": init_peak / 2**30,
           "after_init_gib": (torch.cuda.memory_allocated(dev) - base) / 2**30}
    depth = (f"{cfg.enc_layers} encoder + {cfg.dec_layers} decoder layers"
             if cfg.is_encoder_decoder else f"{cfg.num_layers} layers")
    log(f"[prefix] {arch} ({depth}): {fp32_bytes / 1e9:.2f} GB of fp32 params drawn and cast "
        f"once to bf16 ({rec['serving_bytes'] / 1e9:.2f} GB) in {init_s:.1f} s; peak "
        f"{rec['init_peak_gib']:.2f} GiB allocated at initialisation, "
        f"{rec['after_init_gib']:.2f} GiB held after the fp32 tree was freed")
    vocab_cfgs = {vocabs[0]: (cfg, params["embed"])}
    if len(vocabs) > 1:
        vocab_cfgs["qr"] = ssm_embed(cfg, "qr", dev)
    rec["prefill_32k"], rec["decode_32k"] = {}, {}
    batch = None
    for vocab, (vc, embed) in vocab_cfgs.items():
        p = {**params, "embed": embed}
        r = rec["prefill_32k"][vocab] = prefix_prefill_run(p, vc, dev, mods, totals, batch)
        batch = QR_PREFILL_BATCH
        fit = fmt_fit(r["fit"]) if r["fit"] else "a cut for the script's time"
        parts = "".join(f", {k} {v:.1f} ms ({100 * r['parts_share'][k]:.1f}%, "
                        f"{r['parts_calls'][k]} calls)" for k, v in r["parts_ms"].items())
        sdpa = "; ".join(
            f"{'causal' if x.get('causal', True) else 'cross'} {x['shape']}"
            f"{' over ' + str(x['skv']) if 'skv' in x else ''}: K9 {x['k9_ms']:.1f} ms, SDPA "
            f"(flash backend) {x['sdpa_ms']:.1f} ms" for x in r["k9_vs_sdpa"])
        log(f"[prefix] {arch} {vocab} prefill_32k: batch {r['batch']} (cell {r['cell_batch']}; "
            f"{fit}) x ({r['prefix_rows']} prefix rows + {r['seq']} tokens): {r['ms']:.1f} ms "
            f"({r['host_s']:.2f} s host clock), {r['tokens_per_s']:.0f} tokens/s, K9 "
            f"{r['k9_ms']:.1f} ms ({100 * r['k9_share']:.1f}%, {r['k9_calls']} calls){parts}, K8 "
            f"{r['k8_ms']:.2f} ms; cache {r['cache_bytes'] / 2**30:.2f} GiB, peak "
            f"{r['peak_gib']:.2f} GiB; bound {r['bound_ms']:.1f} ms ({r['flops']:.3e} flop at "
            f"the bf16 peak); launches {r['launches']}; one layer's attention at these shapes: "
            + sdpa)
        log(f"[prefix] {arch} {vocab} prefill_32k kernels vs plain on the main path: "
            + sites_text(r["held"]))
        d = rec["decode_32k"][vocab] = prefix_decode_run(p, vc, dev, mods, totals)
        log(f"[prefix] {arch} {vocab} decode_32k: batch {d['batch']} (cell {d['cell_batch']}; "
            f"cache {d['cache_bytes'] / 2**30:.2f} GiB) at position {d['position']}: "
            f"{d['ms']:.2f} ms a step, {d['tokens_per_s']:.0f} tokens/s, peak "
            f"{d['peak_gib']:.2f} GiB, bound {d['bound_ms']:.2f} ms "
            f"({d['weight_bytes'] / 1e9:.2f} GB of weights + the cache at "
            f"{BW_BYTES_S / 1e12:.2f} TB/s); launches {d['launches']}"
            + (f"; K8 vs plain: {held_text(d['held'])}" if d["held"] else "")
            + "; top device operations: "
            + ", ".join(f"{k} {t:.2f} ms" for k, t in d["top_ops"]))
    del params, vocab_cfgs, p
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def prefix_train_cli(arch: str, mods, totals) -> dict:
    """``python -m repro_torch.launch.train --arch <arch>`` with
    ``PREFIX_TRAIN_CLI`` on the smoke config (its ``main``, in this
    process): exit 0, two finite losses, the launches of two steps."""
    import io

    from repro_torch.configs import registry
    from repro_torch.launch import train as train_cli

    argv = ["--arch", arch, *PREFIX_TRAIN_CLI]
    take_launches(mods, totals)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = train_cli.main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n = take_launches(mods, totals)
    text = buf.getvalue()
    lines = [x for x in text.splitlines() if x.startswith("step")]
    cfg = registry.get(arch).smoke.replace(embedding_kind="qr")
    want = {k: 2 * v for k, v in step_launches(cfg, 1).items()}
    losses = [float(x.split()[3]) for x in lines]
    if rc != 0 or n != want or len(losses) != 2 or not np.isfinite(losses).all():
        raise AssertionError(f"[prefix-cli] train {arch}: exit {rc}, launches {n} (not {want}), "
                             f"output {text[-800:]}")
    log(f"[prefix-cli] launch.train {' '.join(argv)}: exit {rc} in {secs:.1f} s (set-up "
        f"included), launches {n}; " + " | ".join(lines))
    return {"arch": arch, "exit": rc, "s": secs, "launches": n, "losses": losses}


def prefix_phase(dev, by_name, mods) -> dict:
    """Phase 16: the prefix models served and trained on one card.
    ``[prefix-ref]`` on the two smoke configs; whisper-large-v3 (dense and
    QR vocabularies) and pixtral-12b (QR) at full width and depth
    (``prefix_serve_run``: ``prefill_32k``, ``decode_32k``, K9 held at each
    kind of site, K8 bitwise); the serve CLI and the train CLI with each
    arch's smoke config; training on one card (the allocator's expandable
    segments), QR, S 4,096, remat ``full``: whisper at full depth,
    ``PREFIX_WHISPER_TRAIN`` sequences and microbatches, pixtral at the
    depth the dry run fits, batch 1, each
    ``PREFIX_TRAIN_STEPS`` steps; the step-1 gradients of a
    ``PREFIX_GRAD_DEPTH``-layer cut against the kernels' plain versions.
    The phase's launches add to the ``flash_fwd`` and ``qr_gather`` rows.
    Returns the ``{"prefix": ...}`` record."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[prefix] before the phase: {torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB "
        f"allocated, {torch.cuda.mem_get_info(dev)[0] / 2**30:.2f} GiB free")
    totals = {}
    reset_all(mods)
    record = {"section_s": {}}

    def section(key, run):
        t1 = time.perf_counter()
        record[key] = run()
        record["section_s"][key] = time.perf_counter() - t1
        log(f"[prefix] section {key}: {record['section_s'][key]:.1f} s")

    section("ref", lambda: prefix_ref_phase(dev, mods, totals))
    for arch in PREFIX_ARCHS:
        section(arch, lambda: prefix_serve_run(dev, arch, mods, totals))
    section("cli", lambda: [lm_cli_run("qr", mods, totals, arch=arch, tag="[prefix-cli]",
                                       cli=PREFIX_CLI) for arch in PREFIX_ARCHS]
            + [prefix_train_cli(arch, mods, totals) for arch in PREFIX_ARCHS])
    torch.cuda.memory._set_allocator_settings(LMT_ALLOCATOR)
    try:
        batch, micro = PREFIX_WHISPER_TRAIN
        whisper = lm_config("whisper-large-v3")
        section("train_whisper", lambda: lm_train_fitted(
            dev, "whisper-large-v3", "qr", mods, totals, tag="[prefix-train]",
            steps=PREFIX_TRAIN_STEPS, depth=whisper.enc_layers, batch_size=batch,
            microbatches=micro))
        section("train_pixtral", lambda: lm_train_fitted(
            dev, "pixtral-12b", "qr", mods, totals, tag="[prefix-train]",
            steps=PREFIX_TRAIN_STEPS))
        section("grad_check", lambda: {arch: lm_train_grad_check(
            dev, mods, totals, arch=arch, vocabs=("qr",), tag="[prefix-train]",
            depth=PREFIX_GRAD_DEPTH) for arch in PREFIX_ARCHS})
    finally:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.memory._set_allocator_settings("expandable_segments:False")
    record["launches"] = totals
    for name in ("flash_fwd", "qr_gather"):
        by_name[name]["launches"] += totals.get(name, 0)
    record["phase_s"] = time.perf_counter() - t0
    log(f"[prefix] phase {record['phase_s']:.1f} s; launches {totals}")
    return record


# ---------------------------------------------------------------------------
# phase 16's meshed section: whisper and pixtral served and trained on (1, 2)
# gloo ranks sharing the card, beside phase 17's drills
# ---------------------------------------------------------------------------

PREFIX_MESH_SHAPE = (1, 2)
# whisper-large-v3 with the QR vocabulary at full width and depth (32 + 32
# layers), each sequence behind its 1,536 frames: sequences, prompt tokens,
# greedy decode steps
PREFIX_MESH_WHISPER = (2, 1024, 8)
# pixtral-12b with the QR vocabulary at full width, at the depth two ranks'
# draws fit on the one card beside phase 15's meshed ranks and phase 17's
# children (each rank draws the whole fp32 tree, ~1.09 GB a layer and ~5.4 GB
# for the vocabulary and the untied head, and keeps its blocks; at 8 layers
# a rank ran out of memory there, NVIDIA H100 80GB HBM3): layers, sequences,
# prompt tokens after the 256 patches, steps
PREFIX_MESH_PIXTRAL = (4, 2, 1024, 8)
# the ranks' step-1 gradients, 2 x 512 (``SSM_MESH_TRAIN``): whisper at
# 4 + 4 layers in fp32 and bf16 compute, pixtral at 2 layers in bf16
PREFIX_MESH_TRAIN = (("whisper-large-v3", dict(enc_layers=4, dec_layers=4, num_layers=8),
                      ("float32", "bfloat16")),
                     ("pixtral-12b", dict(num_layers=2), ("bfloat16",)))
# world 1 over nccl: layers (whisper's a stack), sequences, prompt tokens,
# decode steps
PREFIX_WORLD1 = (2, 2, 256, 4)


def prefix_mesh_world1(dev, mods, totals) -> dict:
    """World 1 over nccl in this process, mesh (1, 1): whisper-large-v3 and
    pixtral-12b at ``PREFIX_WORLD1``'s depth with the QR vocabulary, bf16:
    the meshed prefill of its prompts (behind the frames or patches), its
    cache and its greedy decode steps (``lms_world1``), and the step-1
    gradients, each against the single card's from the same params and
    batch, read for bitwise equality."""
    import datetime

    import torch.distributed as dist

    from repro_torch import tree
    from repro_torch.configs import registry
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import mesh as M
    from repro_torch.train import train_step as TS

    depth, b, seq, steps = PREFIX_WORLD1
    rdv = ROOT / "build" / "prefix_mesh" / "rdv_world1"
    rdv.parent.mkdir(parents=True, exist_ok=True)
    rdv.unlink(missing_ok=True)
    log("[mesh] 1 rank, mesh (1, 1) over ('data', 'model'), backend nccl, on 1 card "
        "(in process)")
    dist.init_process_group("nccl", init_method=f"file://{rdv}", world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=120))
    rec = {}
    try:
        mesh = M.make_mesh((1, 1), ("data", "model"), device=dev)
        for arch in PREFIX_ARCHS:
            cfg = with_depth(ssm_mesh_cfg(arch), depth)
            params, axes = lm_init(cfg, dev)
            batch = lm_batch_for(cfg, b, seq, torch.Generator(device=dev).manual_seed(19), dev)
            take_launches(mods, totals)
            serving = lms_world1(cfg, params, axes, mesh, batch, steps)
            fn = registry.train_loss_fn(lm_binding(cfg), cfg)
            specs = registry.lm_specs(cfg, params, axes, mesh)
            local = SH.shard_tree(params, specs, mesh)

            def meshed(p, bb):
                with SH.use_rules(mesh, SH.DEFAULT_RULES):
                    return fn(p, bb)

            _, _, g_mesh = TS.value_and_grad(meshed, local, batch)
            _, _, g_one = TS.value_and_grad(fn, params, batch)
            torch.cuda.synchronize()
            grads = all(torch.equal(SH.gather(a, s, mesh), w) for a, s, w in
                        zip(tree.leaves(g_mesh), specs, tree.leaves(g_one)))
            n = take_launches(mods, totals)
            rec[arch] = {"layers": depth, "batch": b, "seq": seq, "steps": steps,
                         "bitwise": {**serving["bitwise"], "step1_grads": grads},
                         "launches": n}
            stack = " a stack" if cfg.is_encoder_decoder else ""
            log(f"[prefix-mesh] world 1 nccl {arch} at {depth} layers{stack}, QR, bf16, "
                f"{b} x {seq} prompts + {steps} greedy steps and one step's gradients, the "
                f"mesh against the single card: bitwise {rec[arch]['bitwise']}; launches {n}")
            del params, local, g_mesh, g_one
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    if not all(all(r["bitwise"].values()) for r in rec.values()):
        raise AssertionError(f"[prefix-mesh] world 1 nccl: {rec}")
    return rec


def prefix_mesh_rank(mesh, serve: dict) -> dict:
    """Phase 16's meshed section on one rank of the (1, 2) gloo mesh on the
    card: whisper-large-v3 at full depth and pixtral-12b at
    ``PREFIX_MESH_PIXTRAL``'s depth served (``lms_rank``: a timed prefill
    with K9 held at each kind of site on this rank's own calls, the cross
    attention's local q/k/v among them, and K8 on its routed stream; greedy
    and teacher-forced decode steps; whisper's prefill peak beside the dry
    run's trace of this rank); the step-1 gradients (``mesh_train_holds``
    of ``PREFIX_MESH_TRAIN``)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import qr_gather as qg

    torch.backends.cuda.matmul.allow_tf32 = False
    mods = (fa, qg)
    res = {"coords": dict(mesh.coords)}
    for arch in PREFIX_ARCHS:
        t = time.perf_counter()
        res[arch] = lms_rank(mesh, serve[arch]["cfg"], serve[arch], mods,
                             dry_hold=arch == "whisper-large-v3", sites=True)
        res[f"{arch}_s"] = time.perf_counter() - t
    t = time.perf_counter()
    res["train"] = mesh_train_holds(mesh, mods, SSM_MESH_TRAIN, PREFIX_MESH_TRAIN)
    res["train_s"] = time.perf_counter() - t
    return res


def prefix_mesh_start(dev, mods) -> dict:
    """Phase 16's meshed section, its first half: world 1 over nccl in this
    process (``prefix_mesh_world1``); the single card's serving references
    (greedy bf16, teacher-forced fp32) of whisper-large-v3 at full depth and
    pixtral-12b at ``PREFIX_MESH_PIXTRAL``'s depth, QR; then one spawn of
    (1, 2) gloo ranks on the card (``prefix_mesh_rank``) started in a thread
    (``ranks_in_thread``), so that other work runs here while they do
    (phase 17's drills: this half runs while its children start).  Returns
    the pending record for ``prefix_mesh_finish``."""
    t0 = time.perf_counter()
    totals = {}
    reset_all(mods)
    rec = {"section_s": {}}
    # phase 15's ranks may already run beside this process: the card's turn
    with card_turn() as turn:
        rec["world1"] = prefix_mesh_world1(dev, mods, totals)
        rec["section_s"]["world1"] = time.perf_counter() - t0
        t1 = time.perf_counter()
        pl, pb, ps, psteps = PREFIX_MESH_PIXTRAL
        cfgs = {"whisper-large-v3": (ssm_mesh_cfg("whisper-large-v3"), *PREFIX_MESH_WHISPER),
                "pixtral-12b": (ssm_mesh_cfg("pixtral-12b", num_layers=pl), pb, ps, psteps)}
        serve, refs = {}, {}
        for arch, (cfg, b, seq, steps) in cfgs.items():
            prompts = lms_prompts(cfg, b, seq)
            refs[arch] = lms_single(cfg, prompts, steps, dev)
            serve[arch] = {"cfg": cfg, "prompts": prompts, "forced": refs[arch]["tokens"]}
        torch.cuda.synchronize()
        rec["single_card_launches"] = take_launches(mods, totals)
        rec["section_s"]["single_card"] = time.perf_counter() - t1
        log(f"[prefix-mesh] the single card's references (greedy bf16, forced fp32) in "
            f"{rec['section_s']['single_card']:.1f} s, after waiting {turn['wait_s']:.1f} s "
            f"for the card")
        gc.collect()
        torch.cuda.empty_cache()
    got = ranks_in_thread(prefix_mesh_rank, PREFIX_MESH_SHAPE, (serve,),
                          ROOT / "build" / "prefix_mesh" / "rdv", "prefix-mesh-ranks")
    return {"rec": rec, "totals": totals, "cfgs": cfgs, "refs": refs, "got": got, "t0": t0}


def prefix_mesh_finish(pending: dict, by_name) -> dict:
    """Phase 16's meshed section, its second half: the ranks of
    ``prefix_mesh_start`` joined and their records held: each arch's logits
    against the single card's (``lms_hold``), whisper's prefill peak against
    the dry run's, the step-1 gradients.  The section's and the ranks' K9
    and K8 launches add to the ``flash_fwd`` and ``qr_gather`` rows.
    Returns the section's record."""
    rec, totals, cfgs, refs = (pending[k] for k in ("rec", "totals", "cfgs", "refs"))
    ranks, rec["section_s"]["ranks"] = join_ranks(pending["got"])
    r0 = next(r for r in ranks if not any(r["coords"].values()))
    log(f"[prefix-mesh] mesh {PREFIX_MESH_SHAPE}: the ranks took "
        f"{rec['section_s']['ranks']:.1f} s, started "
        f"{rec['section_s']['world1'] + rec['section_s']['single_card']:.1f} s into the "
        f"section (on rank (0, 0): whisper {r0['whisper-large-v3_s']:.1f} s, pixtral "
        f"{r0['pixtral-12b_s']:.1f} s, training {r0['train_s']:.1f} s)")
    for r in ranks:
        for arch in PREFIX_ARCHS:
            for k, v in r[arch]["launches"].items():
                totals[k] = totals.get(k, 0) + v
        for t in r["train"].values():
            for k, v in t["launches"].items():
                totals[k] = totals.get(k, 0) + v
    faults = []
    rec["serving"] = {}
    for arch in PREFIX_ARCHS:
        cfg = cfgs[arch][0]
        served = [r[arch] for r in ranks]
        try:
            srec = lms_hold(served, refs[arch], PREFIX_MESH_SHAPE, cfg, "[prefix-mesh]")
        except AssertionError as e:
            faults.append(str(e))
            continue
        if arch == "whisper-large-v3":
            srec["peak_hold"] = lms_peak_hold(served, cfg, PREFIX_MESH_SHAPE)
        rec["serving"][arch] = srec
    rec["train"] = r0["train"]
    for arch, t in rec["train"].items():
        log(f"[prefix-mesh] {arch} mesh {PREFIX_MESH_SHAPE} step-1 gradients at {t['layers']} "
            f"layers, {t['batch']} x {t['seq']}, {t['compute']}, gathered, vs the single card "
            f"in fp32 compute: the mesh {t['mesh_vs_fp32'][0]:.3g} of scale (worst "
            f"{t['mesh_vs_fp32'][1]}; held to {t['tolerance']:.3g}"
            + (f", or twice fp32's own distance from fp64 where larger: worst "
               f"{t['worst_of_its_bound'][0]:.3g} of its bound {t['worst_of_its_bound'][2]:.3g} "
               f"({t['worst_of_its_bound'][1]}; fp32's own worst {t['fp32_floor'][0]:.3g}, "
               f"{t['fp32_floor'][1]})" if "worst_of_its_bound" in t else "")
            + f"), the single card in the same compute {t['single_card_vs_fp32'][0]:.3g} "
            f"({t['single_card_vs_fp32'][1]}); loss {t['loss']:.6f} vs "
            f"{t['loss_single_card']:.6f}; the meshed forward and backward {t['ms']:.1f} ms; "
            f"rank (0, 0)'s peak {t['peak_gib']:.2f} GiB, the ranks' wait for the card "
            f"{t['turn_wait_s']:.1f} s; "
            f"collectives {t['sites']} [calls, B]")
        if not t["ok"]:
            faults.append(f"[prefix-mesh] {arch} step-1 gradients: {t}")
    if faults:
        raise AssertionError("\n".join(faults))
    rec["launches"] = totals
    for name in ("flash_fwd", "qr_gather"):
        by_name[name]["launches"] += totals.get(name, 0)
    rec["section_s"]["total"] = time.perf_counter() - pending["t0"]
    log(f"[prefix-mesh] section {rec['section_s']['total']:.1f} s (world 1 "
        f"{rec['section_s']['world1']:.1f}, the references {rec['section_s']['single_card']:.1f}, "
        f"the ranks {rec['section_s']['ranks']:.1f}); launches {totals}")
    return rec


def prefix_mesh_phase(dev, by_name, mods) -> dict:
    """Phase 16's meshed section alone: ``prefix_mesh_start`` then
    ``prefix_mesh_finish``, nothing beside its ranks."""
    return prefix_mesh_finish(prefix_mesh_start(dev, mods), by_name)


# ---------------------------------------------------------------------------
# phase 17: the launchers' drills on a mesh, their children side by side
# ---------------------------------------------------------------------------

# qwen2's training drill: (1, 2) to step 2, then one card resuming to step 4
LMM_CLI = ("--arch", "qwen2-1.5b", "--smoke", "--embedding", "qr", "--batch", "2", "--seq",
           "512", "--log-every", "1", "--rank-timeout", "500")
# qwen2's serving drill: the same first sequence on (1, 2) and on one card, fp32
LMS_CLI = ("--arch", "qwen2-1.5b", "--smoke", "--batch", "2", "--prompt-len", "32",
           "--max-new", "8", "--compute-dtype", "float32")
# the prefix models' serving drills: the same first sequence on (1, 2) and on
# one card, fp32 (whisper's and pixtral's smoke configs, QR)
PREFIX_SERVE_CLI = ("--smoke", "--embedding", "qr", "--batch", "2", "--prompt-len", "16",
                    "--max-new", "8", "--compute-dtype", "float32")
# whisper's training drill: (1, 2) to step 2, then one card resuming to step 4
PREFIX_MESH_TRAIN_CLI = ("--arch", "whisper-large-v3", "--smoke", "--embedding", "qr",
                         "--batch", "2", "--seq", "32", "--log-every", "1",
                         "--rank-timeout", "500")
CLI_DIR = ROOT / "build" / "cli_drills"
CLI_LINES = ("[mesh]", "[resume]", "step", "done", "generated", "first")


def child_start(tag: str, module: str, argv, timeout_s: float) -> dict:
    """``python -m module argv`` started in a child that leads a process
    group of its own (the ranks it spawns join it), with the repo's ``src``
    on its path; its output and errors go to files under ``CLI_DIR``, so
    that children running side by side fill no pipe."""
    CLI_DIR.mkdir(parents=True, exist_ok=True)
    out, err = (open(CLI_DIR / f"{tag}.{x}", "w+") for x in ("out", "err"))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen([sys.executable, "-m", module, *argv], stdout=out, stderr=err,
                            env=env, start_new_session=True)
    return {"tag": tag, "proc": proc, "files": (out, err), "t0": time.perf_counter(),
            "timeout_s": timeout_s}


def child_stop(c: dict) -> None:
    """Kill ``c``'s process group, its ranks with it, if it still runs."""
    import signal

    if c["proc"].poll() is None:
        try:
            os.killpg(c["proc"].pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        c["proc"].wait()


def child_wait(c: dict) -> dict:
    """``c``'s exit code (124 where it outlived its time limit and was
    killed), output, errors and seconds from its start."""
    try:
        rc = c["proc"].wait(timeout=max(c["timeout_s"] - (time.perf_counter() - c["t0"]), 1))
    except subprocess.TimeoutExpired:
        child_stop(c)
        rc = 124
    texts = []
    for f in c["files"]:
        f.seek(0)
        texts.append(f.read())
        f.close()
    return {"exit": rc, "out": texts[0], "err": texts[1], "s": time.perf_counter() - c["t0"]}


def cli_main(main, argv, mods, totals) -> dict:
    """A launcher's ``main(argv)`` in this process, its printed lines
    caught: the exit code, the text, the seconds and the launches it
    made (added to ``totals``)."""
    import io

    buf = io.StringIO()
    reset_all(mods)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(list(argv))
    torch.cuda.synchronize()
    return {"exit": rc, "out": buf.getvalue(), "s": time.perf_counter() - t0,
            "launches": take_launches(mods, totals)}


def cli_phase(dev, by_name, mods, during=None) -> dict:
    """Phase 17: the launchers' drills on a mesh.  Each meshed run is a
    child (``python -m``; its ranks print), and the children run side by
    side: a child's time is mostly its start-up (the interpreter, its
    ranks' imports and CUDA contexts, gloo's rendezvous), and none of them
    measures more than its own seconds.

    - DLRM, full width (``MESH_CLI_BATCH``): ``launch.train --arch dlrm-qr
      --mesh-shape 2,2 --steps 2``, then ``--mesh-shape 4,1 --steps 4``,
      which resumes from step 2; the checkpoint holds the full logical
      arrays (``MESH_CLI_Q_SHAPE``).
    - qwen2-1.5b (``LMM_CLI``, smoke): ``--mesh-shape 2,1 --steps 2`` (FSDP
      over ``data``: the params and AdamW state stored split along
      ``embed``), then one card (``main``, in this process) ``--steps 4``,
      resuming from the meshed checkpoint.
    - xlstm-125m at full width (``SSM_TRAIN_CLI``): one card ``--steps 2``,
      then ``--mesh-shape 1,2 --steps 4``, then one card ``--steps 6``, each
      resuming from the last one's checkpoint, each one-card run two K8
      launches.
    - whisper-large-v3 (``PREFIX_MESH_TRAIN_CLI``, smoke): ``--mesh-shape
      1,2 --steps 2``, then one card ``--steps 4``, resuming from the meshed
      checkpoint.
    - ``launch.serve`` with ``LMS_CLI`` (qwen2), ``SSM_SERVE_CLI`` (zamba2)
      and ``PREFIX_SERVE_CLI`` (whisper and pixtral), fp32: ``--mesh-shape
      1,2`` prints the one-card run's first sequence.

    ``during()``, where given, runs here once the children have started,
    before this process's own runs (phase 16's meshed section: its world 1,
    its references and its ranks' start, ``prefix_mesh_start``), while the
    children spend their first minute starting up.  The in-process runs'
    launches add to the ``flash_fwd`` and ``qr_gather`` rows.  Returns the
    ``{"cli_drills": ...}`` record."""
    from repro_torch.checkpoint import checkpointer as ckpt
    from repro_torch.launch import serve
    from repro_torch.launch import train as train_cli

    t0 = time.perf_counter()
    totals, rec, kids = {}, {}, []
    dirs = {k: ROOT / "build" / k for k in ("mesh_cli_ckpt", "lm_mesh_cli", "ssm_train_cli",
                                            "prefix_mesh_cli")}
    dlrm = ["--arch", "dlrm-qr", "--batch", str(MESH_CLI_BATCH), "--ckpt-dir",
            str(dirs["mesh_cli_ckpt"]), "--log-every", "1", "--ckpt-every", "1000",
            "--rank-timeout", str(MESH_TIMEOUT_S - 60)]
    lm = [*LMM_CLI, "--ckpt-dir", str(dirs["lm_mesh_cli"])]
    xl = [*SSM_TRAIN_CLI, "--ckpt-dir", str(dirs["ssm_train_cli"]), "--log-every", "1"]
    wh = [*PREFIX_MESH_TRAIN_CLI, "--ckpt-dir", str(dirs["prefix_mesh_cli"])]
    serves = {"qwen2-1.5b": ("[lm-serve-cli]", LMS_CLI),
              "zamba2-7b": ("[ssm-mesh-cli]", SSM_SERVE_CLI),
              **{a: ("[prefix-mesh-cli]", ("--arch", a, *PREFIX_SERVE_CLI))
                 for a in PREFIX_ARCHS}}

    def start(tag, module, argv, timeout_s=LMM_TIMEOUT_S):
        kids.append(child_start(tag, module, argv, timeout_s))
        return kids[-1]

    def done(c, tag, must=()) -> dict:
        r = child_wait(c)
        text = r["err"] + r["out"]
        for line in text.splitlines():
            if line.startswith(CLI_LINES):
                log(f"{tag} {line}")
        if r["exit"] != 0 or any(m not in text for m in must):
            raise AssertionError(f"{tag} {c['tag']}: exit {r['exit']}, wanted {list(must)}\n"
                                 f"{r['out'][-3000:]}\n{r['err'][-3000:]}")
        return r

    def here(tag, main, argv, must=(), launches=None) -> dict:
        r = cli_main(main, argv, mods, totals)
        for line in r["out"].splitlines():
            if line.startswith(CLI_LINES):
                log(f"{tag} {line}")
        if (r["exit"] != 0 or any(m not in r["out"] for m in must)
                or launches not in (None, r["launches"])):
            raise AssertionError(f"{tag} {' '.join(argv)}: exit {r['exit']}, launches "
                                 f"{r['launches']}, wanted {list(must)}\n{r['out'][-3000:]}")
        return r

    def firsts(text):
        return [x for x in text.splitlines() if x.startswith("first")]

    for d in dirs.values():
        shutil.rmtree(d, ignore_errors=True)
    try:
        dlrm1 = start("dlrm_2x2", "repro_torch.launch.train",
                      [*dlrm, "--mesh-shape", "2,2", "--steps", "2"], MESH_TIMEOUT_S)
        lm1 = start("lm_train_2x1", "repro_torch.launch.train",
                    [*lm, "--mesh-shape", "2,1", "--steps", "2"])
        wh1 = start("whisper_train_1x2", "repro_torch.launch.train",
                    [*wh, "--mesh-shape", "1,2", "--steps", "2"])
        meshed = {a: start(f"serve_{a}_1x2", "repro_torch.launch.serve",
                           [*cli, "--mesh-shape", "1,2"]) for a, (_, cli) in serves.items()}
        if during is not None:
            t1 = time.perf_counter()
            during()
            rec["during_s"] = time.perf_counter() - t1
        # in this process while the children start
        xl1 = here("[ssm-train-cli]", train_cli.main, [*xl, "--steps", "2"],
                   launches={"qr_gather": 2})
        xl2 = start("xlstm_train_1x2", "repro_torch.launch.train",
                    [*xl, "--steps", "4", "--mesh-shape", "1,2", "--rank-timeout", "500"])
        one = {a: here(tag, serve.main, cli) for a, (tag, cli) in serves.items()}

        r = done(dlrm1, "[mesh-cli]", must=("done",))
        if ckpt.latest_step(str(dirs["mesh_cli_ckpt"])) != 2:
            raise AssertionError("[mesh-cli] (2, 2): no checkpoint of step 2")
        rec["dlrm"] = {"batch": MESH_CLI_BATCH, "first": {"mesh": "2,2", "steps": 2,
                                                          "exit": 0, "s": r["s"]}}
        dlrm2 = start("dlrm_4x1", "repro_torch.launch.train",
                      [*dlrm, "--mesh-shape", "4,1", "--steps", "4"], MESH_TIMEOUT_S)

        r = done(lm1, "[lm-mesh-cli]", must=("done",))
        r1 = here("[lm-mesh-cli]", train_cli.main, [*lm, "--steps", "4"],
                  must=("[resume] step 2",))
        rec["qwen2-1.5b train"] = {"argv": lm, "mesh": {"shape": "2,1", "exit": 0, "s": r["s"]},
                                   "one_card": {"exit": 0, "s": r1["s"],
                                                "launches": r1["launches"]}}
        log(f"[lm-mesh-cli] (2, 1) FSDP to step 2 in {r['s']:.1f} s, then one card resumed "
            f"to step 4 in {r1['s']:.1f} s (set-up and checkpoints included); launches of the "
            f"one-card run {r1['launches']}")

        r = done(wh1, "[prefix-mesh-cli]", must=("done",))
        r1 = here("[prefix-mesh-cli]", train_cli.main, [*wh, "--steps", "4"],
                  must=("[resume] step 2",))
        rec["whisper-large-v3 train"] = {"argv": wh, "mesh": {"exit": 0, "s": r["s"]},
                                         "one_card": {"exit": 0, "s": r1["s"],
                                                      "launches": r1["launches"]}}
        log(f"[prefix-mesh-cli] whisper-large-v3 smoke (1, 2) to step 2 in {r['s']:.1f} s, "
            f"then one card resumed to step 4 in {r1['s']:.1f} s (set-up and checkpoints "
            f"included); launches of the one-card run {r1['launches']}")

        rec["serve"] = {}
        for a, (tag, cli) in serves.items():
            r = done(meshed[a], tag)
            same = len(firsts(one[a]["out"])) == 1 and firsts(one[a]["out"]) == firsts(r["out"])
            rec["serve"][a] = {"argv": list(cli), "one_card": {"s": one[a]["s"],
                                                               "launches": one[a]["launches"]},
                               "mesh": {"s": r["s"]}, "same_first_sequence": same}
            log(f"{tag} one card {one[a]['s']:.1f} s (in this process; launches "
                f"{one[a]['launches']}), mesh (1, 2) {r['s']:.1f} s (a child, start-up "
                f"included); the same first sequence: {same}")
            if not same:
                raise AssertionError(f"{tag} the first sequences differ: "
                                     f"{firsts(one[a]['out'])} vs {firsts(r['out'])}")

        r = done(xl2, "[ssm-train-cli]", must=("[resume] step 2", "done"))
        xl3 = here("[ssm-train-cli]", train_cli.main, [*xl, "--steps", "6"],
                   must=("[resume] step 4",), launches={"qr_gather": 2})
        rec["xlstm-125m train"] = {"argv": xl, "runs": [
            {"steps": 2, "mesh": None, "s": xl1["s"], "launches": xl1["launches"]},
            {"steps": 4, "mesh": [1, 2], "s": r["s"]},
            {"steps": 6, "mesh": None, "s": xl3["s"], "launches": xl3["launches"]}]}
        log(f"[ssm-train-cli] {' '.join(SSM_TRAIN_CLI)}: one card to step 2 in "
            f"{xl1['s']:.1f} s, (1, 2) resumed to step 4 in {r['s']:.1f} s (a child), one "
            f"card resumed to step 6 in {xl3['s']:.1f} s (set-up and checkpoints included); "
            f"launches of each one-card run {xl3['launches']}")

        r = done(dlrm2, "[mesh-cli]", must=("[resume] step 2", "step     3"))
        if ckpt.latest_step(str(dirs["mesh_cli_ckpt"])) != 4:
            raise AssertionError("[mesh-cli] (4, 1): no checkpoint of step 4")
        with open(dirs["mesh_cli_ckpt"] / "step_00000004" / "manifest.json") as f:
            shapes = {leaf["path"]: leaf["shape"] for leaf in json.load(f)["leaves"]}
        rec["dlrm"]["resumed"] = {"mesh": "4,1", "steps": 4, "exit": 0, "s": r["s"]}
        rec["dlrm"]["q_shape_on_disk"] = shapes["opt/mu/tables/0/q"]
        if shapes["opt/mu/tables/0/q"] != MESH_CLI_Q_SHAPE:
            raise AssertionError(f"[mesh-cli] checkpoint leaf shapes: "
                                 f"{shapes['opt/mu/tables/0/q']}")
        log(f"[mesh-cli] (2, 2) to step 2 in {rec['dlrm']['first']['s']:.1f} s, then (4, 1) "
            f"resumed to step 4 in {r['s']:.1f} s; opt/mu/tables/0/q on disk "
            f"{rec['dlrm']['q_shape_on_disk']} (the full logical array)")
    finally:
        for c in kids:
            child_stop(c)
        for d in dirs.values():
            shutil.rmtree(d, ignore_errors=True)
    rec["launches"] = totals
    for name in ("flash_fwd", "qr_gather"):
        by_name[name]["launches"] += totals.get(name, 0)
    rec["phase_s"] = time.perf_counter() - t0
    log(f"[cli] phase {rec['phase_s']:.1f} s; launches {totals}")
    return rec


@contextlib.contextmanager
def card_memory_watch(what: str, period_ms: int = 250):
    """While open, ``nvidia-smi`` reads the card's memory in use by every
    process each ``period_ms`` (its own loop, one child; no CUDA call in
    this process, where a thread's call could meet a CUDA graph's capture)
    and a thread keeps the peak; yields a record that holds, on exit, the
    peak and the card's total in GiB, the peak's seconds from the start and
    the readings' count, and logs them for ``what``, also where the block
    raised."""
    import threading

    rec = {"peak_gib": 0.0, "at_s": 0.0, "readings": 0}
    t0 = time.perf_counter()
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=memory.used,memory.total",
                            "--format=csv,noheader,nounits", "-i", "0",
                            f"--loop-ms={period_ms}"],
                           stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)

    def watch():
        for line in smi.stdout:
            try:
                used, total = (float(x) / 1024 for x in line.split(","))
            except ValueError:
                continue
            rec["readings"] += 1
            rec["total_gib"] = total
            if used > rec["peak_gib"]:
                rec["peak_gib"], rec["at_s"] = used, time.perf_counter() - t0

    th = threading.Thread(target=watch, name="card-memory-watch", daemon=True)
    th.start()
    try:
        yield rec
    finally:
        smi.terminate()
        try:
            smi.wait(timeout=10)
        except subprocess.TimeoutExpired:
            smi.kill()
            smi.wait()
        th.join(timeout=10)
        log(f"[cli] the card's memory in use, every process together, {what}: peak "
            f"{rec['peak_gib']:.2f} of {rec.get('total_gib', 0):.2f} GiB, {rec['at_s']:.1f} s "
            f"in ({rec['readings']} readings)")


def cli_and_meshed_phase(dev, by_name, mods) -> tuple:
    """Phase 17 with phases 15's and 16's meshed sections beside it: once
    its children have started, each section's world 1, its references and
    its ranks' start (``ssm_mesh_start``, ``prefix_mesh_start``); the ranks
    run beside the drills and are held after them (``ssm_mesh_finish``,
    ``prefix_mesh_finish``; the stages that need a large share of the
    card's memory take turns, ``card_turn``).  The card's memory in use, all
    processes together, is watched from the start to the last hold
    (``card_memory_watch``).  Returns the drills' record (the peak in it),
    the two sections' records and phase 15's section's launches (added to
    the rows here)."""
    pending = {}
    log(f"[cli] before the phase, this process: "
        f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB allocated, "
        f"{torch.cuda.memory_reserved(dev) / 2**30:.2f} GiB reserved")

    def during():
        pending["ssm"] = ssm_mesh_start(dev, mods)
        pending["prefix"] = prefix_mesh_start(dev, mods)

    with card_memory_watch("from phase 17's start to the meshed sections' holds") as card:
        cli_drills = cli_phase(dev, by_name, mods, during=during)
        ssm_totals = {}
        ssm = ssm_mesh_finish(pending["ssm"], ssm_totals)
        for name, n in ssm_totals.items():
            by_name[name]["launches"] += n
        prefix = prefix_mesh_finish(pending["prefix"], by_name)
    cli_drills["card_memory"] = card
    return cli_drills, ssm, prefix, ssm_totals


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is available", file=sys.stderr)
        return 2
    from repro_torch import engine, obs
    from repro_torch.configs import registry
    from repro_torch.configs.base import DLRM_SHAPES
    from repro_torch.core import embedding_bag, hashing, qr_embedding, tt_embedding
    from repro_torch.core import packed_tables as pt
    from repro_torch.data import synthetic
    from repro_torch.examples import cache_plan, quickstart, train_dlrm
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import cached_gather as cg
    from repro_torch.kernels import gnr_bag as gb
    from repro_torch.kernels import packed_gather as pg
    from repro_torch.kernels import qr_gather as qg
    from repro_torch.kernels import tt_gather as tg
    from repro_torch import tree
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve_rec
    from repro_torch.launch import train as train_cli
    from repro_torch.models import dlrm
    from repro_torch.obs import attribution
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step
    mods = (pg, tg, cg, gb, qg, fa)

    # the plain versions' products in full fp32, as the kernels compute them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    sources = sorted(p.stem for p in build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    logs = build.build(sources)
    log(f"[build] {', '.join(sources)} in {time.perf_counter() - t0:.1f} s")
    for src in sources:
        for line in logs[src].splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"[ptxas] {line.strip()}")
    sass = tensor_core_sass(build)

    reference_phase(dev, serve_rec, registry, dlrm, synthetic)
    cached_reference_phase(dev, registry, dlrm, synthetic, qr_embedding, engine)
    batch = DLRM_SHAPES[0].global_batch          # serve_2k: 2048 requests
    kernels = kernel_phase(dev, batch, registry, dlrm, synthetic, pt, pg, ref)
    kernels += tt_kernel_phase(dev, batch, registry, dlrm, synthetic, pt, pg, tg, ref,
                               tt_embedding, sass)
    kernels += pertable_kernel_phase(dev, batch, registry, dlrm, synthetic, hashing,
                                     qr_embedding, ref, cg, gb, qg)
    # the packed kernels' bf16 entries at the training path's shapes (train_8k)
    train_batch = DLRM_SHAPES[1].global_batch                # 8,192
    kernels += kernel_phase(dev, train_batch, registry, dlrm, synthetic, pt, pg, ref,
                            dtype=torch.bfloat16)
    kernels += tt_kernel_phase(dev, train_batch, registry, dlrm, synthetic, pt, pg, tg, ref,
                               tt_embedding, sass, dtype=torch.bfloat16)
    by_name = {k["name"]: k for k in kernels}
    # K2 and K5 at rank 64: the sliced staging path, in each type's row
    for r in tt_rank64_phase(dev, registry, dlrm, synthetic, pt, pg, tg, ref, tt_embedding,
                             train_dlrm):
        suffix = "" if r["dtype"] == "float32" else "_bf16"
        by_name[r["kernel"] + suffix].setdefault("rank64", []).append(r)
    splits = []
    for arch, batches, tel_batches in (("dlrm-qr", 6, 4), ("dlrm-dense", 3, 3),
                                       ("dlrm-tt", 6, 4)):
        launches, split = serve_phase(dev, arch, batch, batches, tel_batches, serve_rec,
                                      registry, dlrm, synthetic, pg, tg, tt_embedding, obs,
                                      attribution)
        splits.append(split)
        for name, n in launches.items():
            by_name[name]["launches"] = n
    by_name["packed_qr_bag"]["launches"] += cli_serve_run(serve_rec, obs)
    # phase 5: each run's launches add to its kernel's count
    t0 = time.perf_counter()
    for arch in ("dlrm-qr", "dlrm-dense", "dlrm-tt"):
        n = cached_lookup_run(dev, arch, batch, 4, registry, dlrm, synthetic, qr_embedding,
                              embedding_bag, engine, mods)
        by_name[PERTABLE_KERNEL[registry.get_dlrm(arch).embedding_kind]]["launches"] += n
    for name, n in ops_entry_runs(dev, batch, registry, dlrm, synthetic, hashing,
                                  qr_embedding, ops, mods).items():
        by_name[name]["launches"] += n
    hashed_lookup_run(dev, batch, registry, dlrm, synthetic, embedding_bag, engine, mods)
    for name, n in examples_run(mods, quickstart, cache_plan).items():
        by_name[name]["launches"] += n
    log(f"[per-table] phase {time.perf_counter() - t0:.1f} s")

    # phase 6: attention
    t0 = time.perf_counter()
    kernels.append(flash_phase(dev, ops, fa, ref, sass))
    by_name["flash_fwd"] = kernels[-1]
    log(f"[flash] phase {time.perf_counter() - t0:.1f} s")

    # phase 7: training at train_8k (every launch of the packed kernels there
    # is their bf16 entry: the lookup packs in the compute dtype)
    t0 = time.perf_counter()
    training = []
    for arch in ("dlrm-qr", "dlrm-tt", "dlrm-dense"):
        r = train_phase(dev, arch, train_batch, registry, dlrm, synthetic, train_step, opt,
                        tree, pt, ops, ref, mods)
        training.append(r)
        by_name[r["kernel"] + "_bf16"]["launches"] += r["launches"]
    by_name["packed_qr_bag_bf16"]["launches"] += cli_train_run(train_cli, train_batch, mods)
    by_name["packed_tt_bag_bf16"]["launches"] += rank64_example_run(mods, train_dlrm)
    lookup_grad = tt_lookup_grad_run(dev, registry, dlrm, synthetic, tt_embedding, ref, ops,
                                     mods)
    by_name["tt_bag_bf16"]["launches"] += lookup_grad.pop("launches")
    by_name["tt_bag_bf16"]["lookup_grad"] = lookup_grad
    log(f"[train] phase {time.perf_counter() - t0:.1f} s")

    # phase 8: the serving control plane (fp32 serving launches of K1/K3/K2/K5)
    control = control_plane_phase(dev, batch, by_name, mods)
    # phase 9: the sharded two-level GnR (bf16 launches of K1/K2/K3 on the ranks)
    sharded = sharded_phase(dev, batch, by_name, mods)
    # phase 10: DLRM training on a mesh (bf16 launches of K1/K2/K3 on the ranks)
    mesh_training = mesh_train_phase(dev, train_batch, by_name, mods)
    # phase 11: the dense transformer served (K9 a layer a prefill, K8 for QR tokens)
    lm_serving = lm_serving_phase(dev, by_name, mods)
    # phase 12: the dense transformer trained (K9 twice a layer a microbatch,
    # K8 for QR tokens, K5 for TT tokens and the tied head)
    lm_training = lm_train_phase(dev, by_name, mods)
    # phase 13: the LM trained and served on a mesh (K9 twice a layer a
    # microbatch and once a layer a prefill, K8 for QR tokens on each rank's
    # shards)
    lm_mesh_training = lm_mesh_phase(dev, by_name, mods)
    # phase 14: the MoE transformers served and trained (K9 a layer a
    # forward at D 64, K8 for QR tokens, on one card and on the EP ranks)
    moe = moe_phase(dev, by_name, mods)
    # phase 15: the sub-quadratic models served and trained (K9 a zamba2
    # site a forward at D 112, K8 for QR tokens); its meshed section runs
    # around phase 17, below
    sub_quadratic = ssm_phase(dev, by_name, mods, mesh=False)
    # phase 16: the prefix models served and trained (K9 non-causal over
    # whisper's frames and across to them, causal over pixtral's patches and
    # tokens; K8 for QR tokens)
    prefix = prefix_phase(dev, by_name, mods)
    # phase 17: the launchers' drills on a mesh (K9 and K8 in the one-card
    # runs in this process), their children side by side; once they have
    # started, phases 15's and 16's meshed sections (K9 and K8 on each
    # (1, 2) rank's heads and shard) start their world 1, their references
    # and their ranks, which run beside the drills and are held after them
    cli_drills, sub_quadratic["mesh"], prefix["mesh"], mesh_totals = cli_and_meshed_phase(
        dev, by_name, mods)
    for name, n in mesh_totals.items():
        sub_quadratic["launches"][name] = sub_quadratic["launches"].get(name, 0) + n
    for k in kernels:
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']} was not launched on its path")
    dryrun_rec = {"traces": DRYRUN["traces"], "s": DRYRUN["s"], "holds": PEAK_HOLDS}
    misses = [h["cell"] for h in PEAK_HOLDS if not h["ok"]]
    log(f"[dryrun] {DRYRUN['traces']} traces on the CPU in {DRYRUN['s']:.1f} s; "
        f"{len(PEAK_HOLDS)} cells' peaks held to {100 * PEAK_TOL:.0f}% of the prediction, "
        f"missed: {misses or 'none'}")
    if misses:
        raise AssertionError(f"the dry run's peak missed the card's by more than "
                             f"{100 * PEAK_TOL:.0f}%: {misses}")

    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    for split in splits:
        print(json.dumps({"serve_split": split}), flush=True)
    print(json.dumps({"training": training}), flush=True)
    print(json.dumps({"control_plane": control}), flush=True)
    print(json.dumps({"sharded": sharded}), flush=True)
    print(json.dumps({"mesh_training": mesh_training}), flush=True)
    print(json.dumps({"lm_serving": lm_serving}), flush=True)
    print(json.dumps({"lm_training": lm_training}), flush=True)
    print(json.dumps({"lm_mesh_training": lm_mesh_training}), flush=True)
    print(json.dumps({"moe": moe}), flush=True)
    print(json.dumps({"sub_quadratic": sub_quadratic}), flush=True)
    print(json.dumps({"prefix": prefix}), flush=True)
    print(json.dumps({"cli_drills": cli_drills}), flush=True)
    print(json.dumps({"dryrun": dryrun_rec}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
