#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``paddle_tpu_torch``) on one card.

    python3 chip_smoke.py            # all phases; needs one CUDA card
    python3 chip_smoke.py --parent DIR --rnn-sweep
        # also: the recurrent forwards (#8, #9, #11) and the paged decode
        # reads (#6, #7) timed in turns with the bodies of the checkout in
        # DIR (the parent commit, unpacked by git archive), and every plan
        # of the forwards timed at the benches

Phases:

1. build  — compile the CUDA kernels (``paddle_tpu_torch/csrc``) with nvcc
   for sm_90a, print ptxas' register / shared-memory lines, and count the
   HGMMA (wgmma) and UTMALDG (TMA load) instructions in the SASS of the
   bf16 tensor-core bodies of #1, #2 and #3, and the TF32 HMMA (mma.sync),
   LDSM (ldmatrix) and LDGSTS (cp.async) instructions in the f32 bodies
   of #1, #2 and #3 (``cuobjdump -sass``; none fails); the LSTM
   backward's (#10) registers a thread and spills, at most 128 registers
   (its plan for two blocks an SM);
2. kernels — hold each kernel against its plain PyTorch version at the
   serving shapes (f32 and bf16) and time kernel, plain version, the
   PyTorch library call where one exists, and the roofline bound; the
   paged read (#6) with its split count, timed in turns with its per-row
   table lookup (and with ``--parent`` the parent's one-block body), and
   beside gather_pages + SDPA (two calls, for scale);
3. serving — a GPT-2-small TransformerLM (random weights from a seed)
   behind ``ServingEngine``: 8 requests through start/submit/poll, every
   greedy continuation equal to the solo full re-forward with plain
   attention, launch counts equal to 12 x dispatches; then the same
   traffic with bf16 weights for tokens/s, TTFT and peak memory;
4. lstm kernels — the three LSTM sequence kernels (inference forward,
   training forward, backward) against their plain versions in f32 and
   bf16 at the flagship text-classifier shape (B=64, T=100, H=256) and at
   an edge shape (B=5, lengths 0/1/T, nonzero h0/c0), with times, plain
   times and bounds at the flagship shape (the forwards' also a step, and
   with ``--parent`` beside the parent's bodies, timed in turns), the
   forwards' plan (``rnn_kernels.forward_plan``) and registers and
   spills; all three bit-equal across two runs there; with
   ``--rnn-sweep`` every plan of #8, #9 and #11 held against plain and
   timed at their bench shapes, the chosen plan printed beside the
   fastest;
5. lstm training — the flagship LSTM text classifier (vocab 30000, embed
   128, hidden 256, batch 64, lengths 30..100, last-step pooling; random
   weights from a seed) trained by ``Trainer.train`` for 24 Adam steps
   over 8 batches in bf16 over f32 master weights, then
   ``Trainer.test`` over 2 held batches: one launch of the training
   forward and of the backward kernel per step, the inference kernel in
   the test pass, a falling loss, one f32 step equal to the plain
   versions' step, and ms per step;
6. flash backward — the dq (#2) and dk/dv (#3) kernels against the plain
   backward in f32 and bf16 at the LM shape (B=8, T=S=1023, H=12,
   causal), the NMT shape (B=64, T=S=64, H=8, lengths 32..64 and a 0), a
   cross-attention shape with S != T and q/k/v as strided views of one
   fused projection; in f32 also each output's error against a float64
   backward beside the plain f32 version's, and two runs bit-equal; at
   the LM shape each kernel's time, the plain version's, the SDPA
   backward's and the bounds (f32: three TF32 products a product on the
   tensor cores, the CUDA cores' bound beside it). The forward (#1) is
   held against its plain version at the same shapes (in f32 also o and
   lse against a float64 forward, and two runs bit-equal) and timed at
   the LM's;
7. LM training — GPT-2 small (vocab 32768, d_model 768, 12 heads, 12
   layers, batch 8 x 1024 tokens; random weights and ids from the seed)
   trained by ``Trainer.train`` for 12 Adam steps over 2 batches in bf16
   over f32 master weights: 12 launches of each attention kernel a step,
   a falling loss on batch 0, one f32 step equal to the plain versions'
   step and a profile of that f32 step (its device time and the share of
   the backward pair #2 + #3), one bf16 loss and gradient within the
   stated tolerance of the plain route's, ms per step and a profile with
   the bf16 step's device time and #2's share of it;
8. NMT training — the transformer NMT (vocab 30000/30000, d_model 512, 8
   heads, 6+6 layers, batch 64, lengths 32..64) likewise for 12 steps
   over 4 batches: 18 launches of each attention kernel a step;
9. decode kernels — the dense read (#4), the int8 dense read (#5) and the
   int8 paged read (#7) against their plain versions in f32 and bf16 (an
   int8 cache under an f32 or bf16 query): #4 and #5 at B=8, H=12, D=64
   over [:, :L] views of a [8, 1024, 12, 64] cache, L 256/512/1024, pos
   with 0, L-1 and a drained value past L; #7 at NB 4/8/16 with null-page
   table tails; each timed with the plain version's time, SDPA with a
   boolean mask beside #4, the byte bound and the split count used (#7
   as #6 in phase 2); then #4 and #5 split across blocks against plain on
   reads that end inside, on and past chunk boundaries and at pos 0 (B
   1/2/8, chosen and forced counts, every query and cache dtype); #6 and
   #7 bit-equal to #4 and #5 over ``gather_pages`` of the same pools at
   the same split count (B 2/8, NB 4/8/16, every count swept, the table
   carried and looked up a row at a time); and the four reads' times over
   forced split counts, each count first held against plain, at the
   decode paths' B 2 and 8, each L and NB (with ``--split-sweep`` #4 and
   #5 also at B 1 and 32: the sweep decode_splits' thresholds come from);
10. dense decode — GPT-2 small (random weights from the seed):
   ``generate_fused`` of 8 prompts of 232 tokens, 32 new, bucket 256, in
   f32 and at ``kv_dtype="int8"``, equal to the same loop on the plain
   route; ``ContinuousBatcher`` and ``ServingEngine`` at int8 over the
   phase-3 traffic, equal to each request's solo int8 plain decode;
   ``SpeculativeDecoder`` on 2 prompts with the int8 self-draft and with a
   GPT-2 small from another seed as the draft (rounds reject proposals),
   each equal to the greedy decode; launch counts 12 x the decode steps of
   each run;
   then the engine's bf16 figures at int8 and bf16 KV;
11. gru kernels — the GRU forward (#11) and backward (#12) against their
   plain versions in f32 and bf16 at the seq2seq bench shape (B=64, T=32,
   H=512, lengths 16..32 with one 0, nonzero h0), on its within-length
   flipped input (the reverse direction) and at an edge shape (B=37: a
   partial row tile, lengths 0, 1 and T), with times, plain times and
   bounds at the bench shape (the forward's also a step, and with
   ``--parent`` beside the parent's body, timed in turns; its plan); both
   bit-equal across two runs at the bench and edge shapes, and their
   registers and spills;
12. seq2seq — the attention seq2seq of benchmarks/seq2seq_nmt.py (vocab
   30000/30000, embed 512, hidden 512, batch 64, lengths 16..32; random
   weights and ids from the seed): one f32 step through the kernels equal
   to the plain route's, then ``Trainer.train`` for 12 Adam steps over 4
   batches in bf16 over f32 masters with exactly 2 launches of #11 and 2
   of #12 a step and a falling loss, ms per step and a profile; then
   ``generate`` (beam 4) and ``greedy_generate`` (max_len 32) in f32, 2
   launches of #11 a call, tokens equal to the plain route's.

13. image — the image stack (no kernel of the port's: convs and BN go
   through cuDNN, as XLA's convs did): (a) every ported op (convs: the
   stem 7x7/s2 direct and by space-to-depth, a 3x3, a 1x1/s2 projection,
   a depthwise and a transpose conv; pools; BN in training mode, each
   training pass and ``batch_norm``, and eval mode; LRN) on the card
   against the port on the CPU in f32 (TF32 off) and bf16; (c) ResNet-50
   at batch 2 in f32: logits, loss, gradients and new BN stats on the
   card against the CPU's float64 run, within twice the CPU's own f32
   distance to it; (b) ResNet-50 trained as benchmarks/resnet50.py trains
   it (batch 64 of 224x224x3, 1000 classes, 4 rotating batches from the
   seed, Momentum(0.1, 0.9), bf16 over f32 masters, train-mode BN with
   the stat updates merged into the masters), one graph replay a step,
   12 steps on both routes: finite costs, no launch of the port's
   kernels, one f32 step through the graph equal to the eager step
   (under ``cudnn.deterministic``), and 8 steps on one repeated batch
   whose first two later costs fall below the first (all 8 printed);
   ms and images a second, device time and busy share, peak memory, the
   step's FLOP count (``torch.utils.flop_counter``) and its share of the
   bf16 peak, the device time by kind (convs, BN, pools, elementwise) and
   the top kernels; (d) the batch-64 rows of benchmarks/image_suite.py
   (SmallNet, AlexNet, GoogleNet) likewise with Momentum(0.01, 0.9) and
   dropout drawn from a card generator through the graph, a falling loss
   on batch 0; (e) the stem direct against space-to-depth, the two BN
   training passes at ResNet-50's 53 BN shapes, and an HWIO weight view
   against a channels-last weight, all timed.

14. training loop — the flagship of phase 5 trained as a user trains
   it: rows (ids, label, scale) from a reader through ``DataFeeder([
   SeqSlot(), IndexSlot(), DenseSlot(1)])`` (lengths 30..100 bucket to T
   = 128) on the ``DoubleBuffer`` prefetch thread into ``Trainer.train``
   with ``outputs_fn`` (logits, probabilities, labels; one forward shared
   with the loss through ``shared_forward``), the classification-error,
   AUC and sum evaluators, a test reader of 2 batches and a checkpoint a
   pass, 3 passes of 8 batches, bf16 over f32 masters, Adam 2e-3, warmed
   first: one replay and one launch of #9 and #10 a step, one #8 a test
   batch, a falling mean cost, finite in-range evaluator results, the
   checkpoints; ms a step (median) and a profiled pass's busy share beside
   the bare graphed step of the same batches fed beforehand, and the
   host timers of the loop; the pass checkpoint loaded on the CPU and,
   re-saved there, back on the card bit-equal, the seconds and bytes of a
   save and of a resume's load; in f32 a preemption after pass 1's batch
   3 and ``resume=True`` bit-equal to the uninterrupted run (replays
   only); under ``on_nonfinite="skip"`` a batch whose loss scale is inf
   leaving every parameter and the optimizer state (its step too)
   bit-equal to the run without that batch.

15. data plane — the flagship of phase 14 fed from files: (a) one pass of
   its rows (512, unbatched) written by ``dump_to_chunks`` into recordio
   chunks of 128 rows through the host library (built from native/'s
   sources with g++, its seconds printed, or "cached") and trained from
   ``batch(chunk_reader(paths), 64)`` with a test pass from chunks
   through the warmed graphed trainer: costs and parameters bit-equal to
   the same pass from the rows in memory, one replay and one #9 and #10
   a step, one #8 a test batch; the loop's ms a step (one pass, best of
   walls taken in turns) and busy share from chunks and from memory
   beside phase 14's, the rows a second of ``chunk_reader`` and of it
   with the feeder on the host alone, the seconds and bytes of the
   chunks; (b) ``cloud_reader`` over a ``TaskMaster`` with a
   ``FaultPlan`` raising at ``reader.next`` on the first task: every row
   exactly once (as a multiset), the failed task re-dispatched once, and
   a pass trained from it (the failure on the prefetch thread) with
   finite costs and the same launches; (c) ``step.grad`` corrupting the
   third step's cost under ``on_nonfinite="raise"``: the trainer raises
   at that batch; ``ckpt.write`` truncating the last pass's params.tar
   (f32): verification refuses it, the load falls back to the pass
   before, and ``resume=True`` replays the step graph and ends bit-equal
   to the run with no fault; (d) a DataFormat file of 64 rows (dense,
   index, sequence and nested-sequence slots) read back through
   ``format.reader_creator``, the feeder with ``SeqSlot(nested=True)`` on
   the card bit-equal to the CPU's, and a body over its
   ``NestedSeqBatch`` (embedding, masked means and sums, a product)
   through a CUDA graph against the eager body and the CPU's.

16. model zoo — the rest of the model zoo and its ops, each path's
   counts set to 0 just before and read just after: (a) the BiLSTM-CRF
   tagger (vocab 30000, embed 128, hidden 256 a direction, 9 tags, batch
   64, lengths 30..100): one f32 step through the kernels against the
   plain route's, the graphed step against the eager step, 12 f32 Adam
   steps a route on one repeated batch with 2 launches of #9 and 2 of #10
   and one replay a step and a falling cost, then ``decode`` through its
   graph (2 launches of #8 a call) against the plain route's tags, and a
   ``ChunkEvaluator`` test pass over the decoded tags of 2 held batches;
   (b) ``ConvTextCls`` (128 filters, context 3, batch 64, length 100),
   (c) ``Word2Vec`` (imikolov's vocabulary, embed 32, hidden 256, context
   4), ``Recommender`` (the movielens constants, dim 32) and ``DeepFM``
   (13 dense and 26 hashed fields, hash 2**20, factor 10, hidden 400 x 3,
   batch 4096; its embedding backward's share of a step): the graphed
   step against the eager one, 12 steps a route, a falling cost, ms a
   step; (d) the GAN (D and G steps one graph each, each Adam moving only
   its half) and the VAE (one graph with a card generator; the example's
   300 steps to below 0.8 of the first cost) of examples/gan_vae_mnist.py;
   (e) the zoo's ops on the card against the CPU: the CRF at the tagger's
   shape, CTC (and ``F.ctc_loss`` on the feasible rows), SSD300's 8732
   priors with 21 classes at batch 8 (multibox loss with its gradient,
   NMS, the detection output, keep_top_k 100), NCE, the hierarchical
   sigmoid, the sequence ops, and the CTC-error and detection-mAP
   evaluators; (f) GPT-2 small (phase 7's configuration) in f32: a
   ``remat=True`` loss and gradient bit-equal to ``remat=False``, #1 twice
   a block, #2 and #3 once, the peak memory of both, one Adam step of
   each through the trainer's graph bit-equal, and 4 ``tie_head=False``
   steps through the trainer's graph with a falling cost.

17. routes, ops, offload, prefix cache — (a) the flagship's LSTMTextCls
   at every ``SUITE_ROWS`` (B, H) of benchmarks/lstm_textcls.py (T=100,
   lengths 30..100): one f32 step through the kernels (the trainer's
   graph) against the plain route's, one bf16 step (loss within 1% of
   the plain route's) and its ms, each with the routes and launches
   ``rnn_kernels.plan_route`` gives (``ROUTES``; H = 1280 the step loop),
   and where a route tiles, in f32 and bf16, #9 and #10 on it against
   the plain versions on the same inputs and the tiled backward
   bit-equal across two runs; the seq2seq's GRU encoder likewise at B 64
   and 128 (#11 and #12 where they tile); (b) ``roi_pool`` (a ResNet-50 C4
   map, 128 RoIs), ``conv3d`` (a 16-frame 112² clip), ``group_norm`` (32
   groups) and the sparse SGD and Adagrad updates (a 2**20 x 64 table)
   on the card against the CPU, timed; (c) a 2**22 x 64 f32
   ``HostEmbeddingTable`` under 4 SGD steps of a bag-of-ids classifier
   through ``HostEmbedPrefetcher``, bit-equal to the same steps over the
   table on the card, and the rows a second it streams; (d) GPT-2 small's
   ``ServingEngine`` with ``prefix_cache=True``: a warm request, then two
   bursts of 8 prompts sharing its declared 200-token prefix (its last 8
   tokens on a partial page), tokens equal to the cache-off engine's and
   the solo plain decode, hits > 0, copies on write > 0 and a replay of
   the hit admission's graph, TTFT and TPOT beside cache-off. Phase
   10's engine bursts are queued whole before the engine starts, so the
   eager and graphed routes see one admission pattern.

18. head widths, GPT-Neo-1.3B's widths, the wire plane — (a) #1-#3 at
   head widths 8, 32, 80 and 128 (B=2, T=S=1024, 16 heads, causal; 64
   and 128 natively, the others by the counted pad route), f32 and bf16,
   against the plain versions; causal at S = T -/+ 64 with kv_lens and a
   view off the 16-byte rule (the copy16 route) at 80 and 128; #4-#7 at
   the same widths (every query and cache dtype, no route: caches read at
   their width), the paged reads bit-equal to the dense reads of their
   gathered pages; each kernel at D = 128 timed beside its plain version,
   SDPA where one call computes the same and its bound (the kernels
   line's D = 128 entries); (b) a TransformerLM at EleutherAI/
   gpt-neo-1.3B's widths (hidden 2048, 16 heads of 128, 8 of its 24 layers, vocab
   50257, 2048 positions; random weights; global attention in every
   layer): one f32 training step at 2 x 1024 tokens through #1-#3 against
   the plain route (transformer_step_check's bounds, the step written
   out), one graphed bf16 step timed, phase 10's burst through
   ``ServingEngine`` in bf16 and bf16 at int8 KV and ``generate_fused``
   through #4 and #5, each equal to its solo plain-attention decode;
   (c) the wire plane over GPT-2 small in bf16 (benchmarks/
   serving_daemon.py's and serving_router.py's layout): a
   ``ServingDaemon`` of 16 slots answering 24 requests over localhost,
   the in-process engine on the same traffic, and a ``ServingRouter``
   over one ``PrefillDaemon`` and two decode daemons of 8 slots answering
   16 requests at bf16 and int8 KV; 8 requests of each run equal to the
   solo plain decode, client-side TTFT and TPOT p50/p95 and tokens/s;
   shipped rows byte-equal to the prefill pool's; a decode worker
   stopped with no drain mid-stream re-routed with no token lost or
   duplicated; a ``srv.ship`` corrupt refused with data_loss and never
   adopted.

19. head widths up to 256, GPT-J-6B's widths — (a) #1-#3 at head widths
   12, 136, 200 and 256 (phase 18's shapes; 256 natively by
   csrc/flash_wide.cu, the others by the counted pad route), f32 and
   bf16, against the plain versions; causal at S = T -/+ 64 with kv_lens
   and a view off the 16-byte rule at 200 and 256; #4-#7 at the same
   widths (12 by the counted pad8 route; the paged reads bit-equal to
   the dense reads of their gathered pages at the multiples of 8); #2
   and #3 at 256 bit-equal across two runs; each kernel at D = 256 timed
   beside its plain version, SDPA where one call computes the same and
   its bound (the kernels line's D = 256 entries); (b) a TransformerLM at
   GPT-J-6B's attention and MLP widths (4096, 16 heads of 256, d_ff
   16384, vocab 50400) cut to 4 layers: one f32 training step through the
   trainer's graph on both routes (transformer_step_check), one graphed
   bf16 step timed, phase 10's burst through ``ServingEngine`` in f32 at
   f32 KV (equal to the solo plain decode) and int8 KV (each token the
   plain model's greedy choice up to a near-tie: an int8 code flip turns
   f32 rounding into a code step) and ``generate_fused`` at both, against
   the same loop on the plain route; every kernel of #1-#7 launched at
   D = 256.

20. the fluid plane — (a) the LSTM flagship (phase 5's widths) as a fluid
   program (embedding, ``dynamic_lstm``, ``sequence_last_step``, fc,
   softmax cross-entropy, mean; Adam), 20 ``exe.run`` steps over 4
   batches: one #9 and one #10 a step, one graph capture for the key, a
   falling loss, one f32 step equal to the same run with the kernels
   routed plain (``fluid.registry.routed``), ms a step graphed and
   eager; (b) its inference bundle (export, load) on 2 held batches: one
   #8 a run, logits equal to the plain route's; (c) a ``dynamic_gru``
   program at the seq2seq bench's widths (batch 64, hidden 512, T 32),
   10 steps: one #11 and one #12 a step, one f32 step equal to plain;
   (d) benchmarks/fluid_executor.py's MLP (784-256-64-10, Adam, batch
   256): 200 timed runs with ``return_numpy=False``, ms a run, the
   cache hit rate, no graph capture inside the window, and an LRU of one
   key evicting and recapturing; (e) small While, Cond and StaticRNN
   programs equal to the same programs on the CPU.
21. the v2 DSL — (a) the LSTM flagship (phase 5's widths) built with
   ``paddle_tpu_torch.v2`` (``data``, ``embedding``,
   ``networks.simple_lstm``, ``last_seq``, ``fc``,
   ``classification_cost``; Adam 2e-3) and trained by ``SGD.train`` with
   an event handler, 20 steps over phase 20's 4 batches: one #9 and one
   #10 a step, a falling loss, the first step equal to the plain route's
   (phase 20's ``fluid_step_check``), ms a step through ``SGD.train`` and
   through ``exe.run`` graphed; (b) ``v2.infer`` on 2 held batches:
   forward only through #8, logits equal to the plain route's, every
   parameter bit-equal before and after; (c) a ``networks.
   bidirectional_gru`` classifier at phase 20's GRU widths, 10 steps: #11
   and #12 twice a step, the first step equal to plain, a falling loss;
   (d) ``exe.run(verify=True)`` on (a)'s program: the pre-flight's
   diagnostics by code and seconds, then ms a step with the pre-flight
   memoized against ``verify=False``; (e) ``Parameters.to_tar`` on the
   card byte-equal to the tar of the same values on the CPU.

22. the parallel plane (``paddle_tpu_torch.parallel``) on a world of 4
   gloo ranks that all sit on cuda:0 (``torch.multiprocessing`` spawn, a
   FileStore; the machine has one card and NCCL refuses two ranks on one
   device; the parent builds the kernels, the ranks load them, rank 0
   sends its comparisons back and the parent checks): first #1-#3
   against plain at the ring's block shapes (diagonal, zigzag past,
   zigzag future) in f32 and bf16; (a) ``ring_self_attention`` (zigzag
   causal, contiguous causal, non-causal) and causal
   ``ulysses_attention`` over seq = 4 at GPT-2 small's attention widths
   (B 8, T 1024, 12 heads of 64), forward and backward in f32 and bf16,
   each against one ``flash_attention`` call and against the plain
   ring, the launches of #1-#3 per rank and call exact; (b) GPT-2 small
   trained sequence-parallel (``shifted_loss(positions=,
   seq_axis="seq")`` in ``shard_map``, T 1024, B 8): the f32 loss and
   gradients against the single-rank ones, bf16 steps through
   ``Trainer(mesh=)`` timed; (c) GPT-2 small data-parallel through
   ``Trainer`` (data = 4; fsdp = 2 x tp = 2 with
   ``benchmarks/sharded_gpt2.py``'s layout) and ``Zero1DataParallel``
   (data = 4), one f32 step each against one single-rank step on the
   global batch of 8, each rank's parameter and slot bytes, ms a step;
   (d) JAX's test shapes of ``ExpertParallelMoE``, ``pipeline_1f1b`` and
   the TP layers on the card; (e) (a)'s ring on a one-rank NCCL world;
   (f) the fluid executor on a mesh (``Executor(mesh=, layout=)``):
   phase 20's LSTM flagship program on data = 4, three ``exe.run``s each
   equal to the single-rank run (the loss to 1e-4 relative, the first
   run's gradient read from Adam's first moment to 1e-4 of the entry and
   its row's rms, the parameters Adam-aware; one #9 and one #10 a run on
   every rank), JAX's annotated program (tests/test_fluid_sharding.py)
   with a replicated L2 term of the head's weight beside the mean loss
   on data = 2 x fsdp = 2 with its parameters stored sharded (the first
   forward equal, the bytes a rank as forecast, 3 SGD steps to rtol
   1e-5), and
   ``save_persistables`` there loaded onto fsdp = 4, re-placed.
   Every collective's host staging (``collectives.STAGED``) is printed.

23. the obs session plane (``paddle_tpu_torch.obs``) — (a) phase 14's
   loop (the flagship, bf16, feeder + prefetch + evaluators + test +
   checkpoints) two passes under an ``ObsSession`` with a
   ``FlightRecorder`` armed, against the same run with no session: the
   costs and every parameter bit-equal, the ``trainer.*`` spans, the
   goodput buckets and ``goodput.ratio``, the session's
   ``kernels.routes_total`` equal to #8's and #9's launches (the counts a
   graph's capture recorded, re-emitted on each replay), the wall a step
   with and without the session; then a ``step.grad`` fault's flight
   dump; (b) the roofline: the peak resolves to the H100 row, the FLOPs
   counted on meta tensors for one GPT-2 step (phase 7's widths, B 8, T
   1024) equal 6 N tokens within 2%, and ``roofline.mfu`` and
   ``roofline.hbm_bw_util`` in (0, 1] after steps through ``Trainer``
   under a session; (c) phase 3's GPT-2 small engine burst in bf16 and
   int8 KV under a session with request timelines: each stitched
   timeline's TTFT within 5% of the engine's own, the tokens equal to
   the burst's with no session, ``ObsHttpServer``'s ``/metrics``,
   ``/trace`` and ``/requests`` scraped once; (d) device timelines:
   ``torch.profiler`` over 3 eager ``exe.run``s of phase 20's flagship
   program read by ``obs.xplane.read_torch_trace``: #9's and #10's
   kernels in ``op_totals`` attributed to the program's lstm op site, the
   merged Chrome trace holding host spans and device lanes; then
   ``python -m paddle_tpu_torch profile --decode 8,128,64``, whose report
   names #1's and #4's kernels.

24. the elastic and tune planes and the C inference API — (a)
   ``ElasticMaster`` (4 shards a step) and two ``ElasticWorker`` threads
   on the card train the LSTM flagship (vocab 30000, embed 128, H 256,
   B 64, T 100, f32, Adam) 4 steps over the master RPC plane, every
   step's parameters bit-equal to the sequential reference on the card
   (tests/torch_elastic_net.py: the same graphed shard gradients, the
   shard-ordered host reduce, the graphed Adam update), #9 and #10 in
   each worker's graph; (b) the same pass with a third worker, a
   subprocess (tests/torch_elastic_worker.py) SIGKILLed while it holds a
   shard: evicted, its shard re-bucketed, the pass bit-equal to (a)'s;
   (c) ``tune.run_tune(profile="bench", reps=3)`` over all five plan
   spaces into a temporary cache, each family's winner printed beside
   the heuristic (#4-#12 launched); with the cache installed, a GPT-2
   small f32 ``ServingEngine`` left to the consults serves the heuristic
   engine's greedy tokens, the flagship LSTM under the tuned row tiles
   and under a forced 16-row tile equals ``plan_route``'s (the forward
   bit for bit, the gradients to TILE_GRAD_TOL), a decode read at the
   tuned split count equals the heuristic count's, and ``plan_source()``
   says "tuned"; (d) the C inference API built from
   ``csrc/capi_inference.cc``: ``pti_forward`` on the fluid flagship's
   exported bundle bit-equal to ``Executor.run`` of the bundle, #8
   launched.

The bf16 serving checks of phases 18 and 19 (``greedy_within_ties``)
print, for each burst, the largest gap between a chosen token's plain
logit and the argmax's in bf16 ulps, and the run prints the largest of
them beside the bound (NEAR_TIE_ULPS).

Phases 3, 5, 7, 8, 10, 12 and 13 also run each path twice, on the eager
route (``core.graphs.disabled()``: every body run directly) and through
its CUDA graphs (``core/graphs.py``), each warmed once, then measured
with the counts set to 0 just before and read just after, then
profiled: tokens, search results and training costs compared (an f32
trainer step replayed through its graph against the eager step, bit-equal
or within GRAPH_STEP_LOSS_RTOL / GRAPH_STEP_PARAM_ATOL), the same kernel
launches, one graph replay a decode token, segment, speculative round,
trainer step or search call; each prints the wall a step, the device
time a step and the busy share, the graph dispatches and the kernel
launches a step of both routes (phase 10 profiles the graphed route
only). In each profiled run the port's kernel
launches that the profiler saw, by body, must equal what ``LAUNCHES``
counted (through the graphs: what the replays recorded at capture).
Phase 10 also calls ``generate_fused`` at six new prompt lengths with a
fresh generator each: one capture a length and no growth of the memory
allocated beyond an eighth of a KV cell.

Prints ``{"graph_paths": [...]}`` (those figures), ``{"image": {...}}``
(phase 13's), ``{"loop": {...}}`` (phase 14's), ``{"data": {...}}``
(phase 15's), ``{"zoo": {...}}`` (phase 16's), ``{"slice18": {...}}``
(phase 17's), ``{"slice19": {...}}`` (phase 18's), ``{"slice20": {...},
"fluid": {...}}`` (phases 19 and 20), ``{"world": {...}}`` (phase 22),
``{"obs": {...}}`` (phase 23), ``{"phase24": {...}}``,
``{"kernels": [...]}`` (with
``launches_obs`` on #1, #4, #6-#10: phase 23's launches, ``launches_world``
on #1-#3: phase 22's launches per rank and call,
``launches_routes`` and ``launches_fluid`` on #8-#12,
``launches_elastic`` on #9 and #10 and ``launches_tune`` on #4-#12:
phase 24's, ``launches_capi`` on #8, and #1-#7 again at D = 128 and
D = 256),
the card's name and power limit,
and last
``{"ok": true, "device": {...}}``. Exits non-zero on any failure, with no
card, or without the ``paddle_tpu_torch`` package beside this file.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# GPT-2 small, as `paddle_tpu serve` builds it by default
GPT2_SMALL = dict(vocab=50257, d_model=768, n_heads=12, n_layers=12,
                  d_ff=3072, max_len=1024)
ENGINE = dict(slots=8, segment=32, page_block=64, cache_bucket=256)
N_REQUESTS, NEW_TOKENS = 8, 48

# the card's published peaks (H100 SXM data sheet, dense)
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "tf32": 495e12}
PEAK_BYTES = 3.35e12
# an f32-accurate product on the tensor cores is three TF32 products
# (csrc/tf32x3.cuh; PyTorch's f32 SDPA kernels do the same): the f32 rows
# of the kernels whose products run there (#1-#3, #10, #12) are bound at
# three times their operations over the TF32 peak
TF32_PASSES = 3

# tolerances, with the reason: the kernels sum in another order than the
# plain versions (tiles, online softmax), nothing else differs
F32_ATOL, F32_RTOL = 1e-5, 1e-4
# the bf16 tensor-core bodies (#1 o, #2 dq, #3 dk and dv): see
# bf16_tc_close
BF16_TC_RTOL = 2.0 ** -7
# the one bf16 LM step through the kernels against the plain route's
# (phase 7): see bf16_step_check
BF16_STEP_LOSS_RTOL, BF16_STEP_GRAD_REL_L2 = 2.0 ** -9, 2.0 ** -5
# which body each attention kernel runs, by dtype
_TC = "tensor cores: wgmma on TMA-fed tiles"
_TF = ("tensor cores: three-pass TF32 mma.sync (m16n8k8, split operands) "
       "on cp.async-fed tiles")
DESIGN = {
    "flash_attention_fwd": {"bfloat16": _TC, "float32": _TF},
    "flash_attention_bwd_dq": {"bfloat16": _TC, "float32": _TF},
    "flash_attention_bwd_dkv": {"bfloat16": _TC, "float32": _TF},
}
# #4's, #5's, #6's and #7's design (every dtype): one body, templated over
# the row loader
SPLIT_DESIGN = ("one block per (head, sample) where B*H fills the card or "
                "the read is short; else the read split into chunks of "
                "rows, one block each, merged in chunk order by the last "
                "block to finish (ops/cuda_kernels.py decode_splits)")
# how #6 and #7 find a row's page
PAGED_TABLE = ("each row group carries its page's table entry across the "
               "page's rows and loads the entry of its next page when it "
               "enters one (csrc/decode_attn.cuh TableRows)")
PAGED_SOURCES = {"source": "paddle_tpu_torch/csrc/paged_decode.cu",
                 "body": "paddle_tpu_torch/csrc/decode_attn.cuh"}
# the wgmma+TMA bodies of this port: kernel name in the SASS -> JSON entry
TENSOR_CORE_BODIES = {"flash_fwd_wgmma_kernel": "flash_attention_fwd",
                      "flash_bwd_dq_wgmma_kernel": "flash_attention_bwd_dq",
                      "flash_bwd_dkv_wgmma_kernel": "flash_attention_bwd_dkv"}
# the head widths the tensor-core bodies of #1-#3 are built for (D = 256:
# the CUDA-core bodies of csrc/flash_wide.cu)
TC_WIDTHS = (64, 128)
# the three-pass TF32 bodies (mma.sync, cp.async): kernel -> JSON entry
TF32_BODIES = {"flash_fwd_tf32_kernel": "flash_attention_fwd",
               "flash_bwd_dq_tf32_kernel": "flash_attention_bwd_dq",
               "flash_bwd_dkv_tf32_kernel": "flash_attention_bwd_dkv"}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def bf16_ulp(x: float) -> float:
    """One bf16 ulp at magnitude ``x`` (8 significant bits)."""
    import math
    return 2.0 ** (math.floor(math.log2(x)) - 7) if x > 0 else 0.0


def bf16_tc_close(got, want, what: str) -> float:
    """Hold an output of a bf16 tensor-core body (#1's o, #2's dq, #3's dk
    and dv) against the plain version's; returns the max abs error.

    The bodies round P (#1), dS (#2) and P^T, dS^T (#3) to bf16 before
    their second product, the usual flash choice (the plain versions and
    JAX keep them in f32). Each term of an output entry then carries a
    relative error of at most 2**-9, so the entry is off by at most 2**-9
    of the sum of its terms' magnitudes; the terms have mixed signs, so
    that error stays under one bf16 ulp of the tensor's largest magnitude (atol, between
    2**-8 and 2**-7 of it), also at entries near zero where the sum
    cancels. The output's own rounding to bf16 adds one ulp of the entry
    on either side (rtol 2**-7), as the CUDA-core bodies' check allows."""
    import torch
    g, w = got.float(), want.float()
    err = (g - w).abs().max().item()
    atol = bf16_ulp(w.abs().max().item())
    check(torch.allclose(g, w, atol=atol, rtol=BF16_TC_RTOL),
          f"{what} bfloat16 differs from plain: max abs {err} (atol {atol}, "
          f"rtol {BF16_TC_RTOL})")
    return err


# SASS opcodes counted in each tensor-core body: HGMMA (wgmma) and
# UTMALDG (TMA load) in the wgmma bodies; the TF32 mma.sync, LDSM
# (ldmatrix) and LDGSTS (cp.async) in the three-pass bodies
SASS_OPS = {**{body: ("HGMMA", "UTMALDG") for body in TENSOR_CORE_BODIES},
            **{body: ("HMMA.1688.F32.TF32", "LDSM", "LDGSTS")
               for body in TF32_BODIES}}


def sass_counts(lib_path) -> dict:
    """The SASS_OPS instructions in the SASS of each tensor-core body of the
    built library, from ``cuobjdump -sass``, and each body's instruction
    count, by head width (the bodies are templates on D, built for
    TC_WIDTHS; D = 256 runs csrc/flash_wide.cu's bodies on the CUDA
    cores): {body: {"D64": {...}, "D128": {...}}}; fails when an
    instantiation is missing or lacks one of its opcodes."""
    import re
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", str(lib_path)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True, timeout=300).stdout
    counts, cur = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = None
            for k in SASS_OPS:
                w = re.search(k + r"ILi(\d+)E", m.group(1))
                if w:
                    cur = (k, f"D{w.group(1)}")
                    counts.setdefault(k, {})[cur[1]] = dict.fromkeys(
                        SASS_OPS[k] + ("all",), 0)
        elif cur and re.match(r"\s+/\*[0-9a-f]{4,}\*/", line):
            c = counts[cur[0]][cur[1]]
            c["all"] += 1
            for op in SASS_OPS[cur[0]]:
                c[op] += op in line
    for body, ops in SASS_OPS.items():
        for D in TC_WIDTHS:
            c = counts.get(body, {}).get(f"D{D}", {})
            check(all(c.get(op, 0) > 0 for op in ops),
                  f"{body} D={D}: not all of {ops} in its SASS ({c})")
    return counts


def ptxas_usage(build, kernel: str, flags=()) -> dict:
    """Registers a thread and spilled bytes (stores + loads) of each
    instantiation of ``kernel``, by its I/O dtype (and, for the forwards'
    templates, "/u<units>" and "/<flag>" for each of its bool template
    arguments ``flags`` that is true), from ptxas' lines of the build."""
    import re
    out, cur = {}, None
    for ln in build.resource_lines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            cur = None
            name = m.group(1)
            if re.search(kernel + r"I", name):
                cur = "bfloat16" if "nv_bfloat16" in name else "float32"
                units = re.search(r"Li(\d+)E", name)
                if units:
                    cur += f"/u{units.group(1)}"
                bools = re.findall(r"Lb([01])E", name)
                cur += "".join(f"/{f}" for f, b in zip(flags, bools)
                               if b == "1")
                out[cur] = {"registers": None, "spill_bytes": None}
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if cur and m:
            out[cur]["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if cur and m:
            out[cur]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
    return out


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(calls, rounds: int = 4, reps: int = 5) -> float:
    """Mean device time of one call, without the host's launch cost.

    ``calls`` are closures of one function over distinct input sets, whose
    total is larger than the 50 MB L2 cache, so that each call finds its
    inputs cold as a layer of the model does. ``rounds`` passes over them
    are captured in one CUDA graph; CUDA events time ``reps`` replays. The
    warm-up runs eagerly on the capture stream, so what a call keeps per
    stream (#4's tickets) exists before the capture."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                 # warm-up off the graph
        for c in calls:
            c()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(rounds):
            for c in calls:
                c()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * rounds * len(calls))


def input_sets(make, nbytes_one: int, floor: int = 4):
    """Enough input sets from ``make(i)`` to exceed the L2 cache twice."""
    n = max(floor, -(-2 * 50 * 2 ** 20 // nbytes_one))
    return [make(i) for i in range(n)]


def bound(flops: float, nbytes: float, dtype_name: str):
    t_ops = flops / PEAK_FLOPS[dtype_name]
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def tensor_core_bound(flops: float, nbytes: float, dtype_name: str) -> dict:
    """The bound of a kernel whose products run on the tensor cores (#1-#3,
    #10, #12): bf16 as :func:`bound`; in f32 at TF32_PASSES TF32 products a
    product over the TF32 peak (the least time f32-accurate products take
    on this card), with the CUDA cores' bound at 67 TF/s beside it as
    ``bound_cuda_core_ms``."""
    if dtype_name != "float32":
        b_ms, b_by = bound(flops, nbytes, dtype_name)
        return {"bound_ms": b_ms, "bound_by": b_by}
    b_ms, b_by = bound(TF32_PASSES * flops, nbytes, "tf32")
    return {"bound_ms": b_ms, "bound_by": b_by,
            "bound_cuda_core_ms": bound(flops, nbytes, dtype_name)[0]}


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _qkv_views(B, T, H, D, dtype, gen, device):
    """q, k, v as the model makes them: [B, T, H, D] views of one fused
    [B, T, 3*H*D] projection (strided, no copy)."""
    import torch
    qkv = torch.randn((B, T, 3 * H * D), generator=gen).to(device, dtype)
    return [t.unflatten(-1, (H, D)) for t in qkv.chunk(3, dim=-1)]


def flash_checks(say, device="cuda"):
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import cuda_kernels as ck
    B, T, H, D = 8, 256, 12, 64
    gen = torch.Generator().manual_seed(1)
    q, k, v = _qkv_views(B, T, H, D, torch.float32, gen, device)
    entry = {"name": "flash_attention_fwd", "route": "cuda",
             "source": "paddle_tpu_torch/csrc/flash_fwd.cu",
             "replaces": "paddle_tpu/ops/pallas_kernels.py:69",
             "replaces_kernel": "_fa_fwd_kernel",
             "design": DESIGN["flash_attention_fwd"],
             "shape": f"B={B} T=S={T} H={H} D={D} causal"}
    pairs = T * (T + 1) // 2                    # causal (i, j) pairs j <= i
    flops = 4.0 * B * H * D * pairs
    for dt, tag in ((torch.float32, "float32"), (torch.bfloat16, "bfloat16")):
        qd, kd, vd = (t.to(dt) for t in (q, k, v))
        o, lse = ck.flash_attention_fwd(qd, kd, vd, causal=True)
        po, plse = ck.flash_attention_fwd(qd.float(), kd.float(), vd.float(),
                                          causal=True, route="plain")
        torch.cuda.synchronize()
        err = (o.float() - po).abs().max().item()
        lse_err = (lse - plse).abs().max().item()
        if dt == torch.float32:
            check(torch.allclose(o, po, atol=F32_ATOL, rtol=F32_RTOL),
                  f"flash f32 output differs from plain: max {err}")
        else:
            err = bf16_tc_close(o, po, "flash fwd (phase 2)")
        check(torch.allclose(lse, plse, atol=F32_ATOL, rtol=F32_RTOL),
              f"flash {tag} lse differs from plain: max {lse_err}")
        sets = input_sets(lambda i: _qkv_views(B, T, H, D, dt, gen, device),
                          3 * B * T * H * D * qd.element_size())
        ms = time_ms([lambda s=s: ck.flash_attention_fwd(*s, causal=True)
                      for s in sets])
        plain_ms = time_ms([lambda s=s: ck.flash_attention_fwd(
            *s, causal=True, route="plain") for s in sets], rounds=1)
        lib_ms = time_ms([lambda s=s: F.scaled_dot_product_attention(
            *(t.transpose(1, 2) for t in s), is_causal=True) for s in sets])
        del sets
        nbytes = 4 * B * T * H * D * qd.element_size() + B * T * H * 4
        res = {"max_abs_err": err, "lse_max_abs_err": lse_err, "ms": ms,
               "plain_ms": plain_ms,
               **tensor_core_bound(flops, nbytes, tag), "library_ms": lib_ms}
        say(f"flash_attention_fwd {tag}: {json.dumps(res)}")
        if dt == torch.float32:
            entry.update(res)
            entry["dtype"] = tag
        else:
            entry["bf16"] = res
    # kv_lens masks, a sample with no keys included (non-causal)
    lens = torch.tensor([256, 0, 17, 100, 255, 1, 64, 200], device=device)
    o = ck.flash_attention(q, k, v, kv_lens=lens)
    po = ck.flash_attention(q, k, v, kv_lens=lens, route="plain")
    torch.cuda.synchronize()
    err = (o - po).abs().max().item()
    check(torch.allclose(o, po, atol=F32_ATOL, rtol=F32_RTOL),
          f"flash kv_lens output differs from plain: max {err}")
    check(o[1].abs().max().item() == 0.0, "kv_lens == 0 sample not zeroed")
    entry["kv_lens_max_abs_err"] = err
    say(f"flash_attention kv_lens (with a 0): max_abs_err {err}")
    return entry


def _paged_inputs(B, H, D, bs, NB, dtype, gen, device, full: bool):
    """Pools over a null page 0, tables and pos; q as decode_step_paged
    hands it over: ``q[:, 0]`` of the [B, 1, H, D] view of one fused
    [B, 1, 3*H*D] projection (strides 3*H*D per sample, D per head)."""
    import torch
    P = B * NB + 1                                   # + the null page 0
    k_pool = torch.randn((P, bs, H, D), generator=gen).to(device, dtype)
    v_pool = torch.randn((P, bs, H, D), generator=gen).to(device, dtype)
    qkv = torch.randn((B, 1, 3 * H * D), generator=gen).to(device, dtype)
    q = qkv.chunk(3, dim=-1)[0].unflatten(-1, (H, D))[:, 0]
    L = NB * bs
    if full:
        pos = torch.full((B,), L - 1, dtype=torch.int32)
    else:                                            # spread over [0, L)
        pos = torch.linspace(0, L - 1, B).round().to(torch.int32)
    perm = torch.randperm(P - 1, generator=gen) + 1
    tables = torch.zeros((B, NB), dtype=torch.int32)
    for b in range(B):
        live = int(pos[b]) // bs + 1
        tables[b, :live] = perm[b * NB:b * NB + live]
    return (q, k_pool, v_pool, tables.to(device), pos.to(device))


def paged_checks(say, device="cuda", parent=None):
    """#6 against its plain version at the serving shapes (f32 and bf16),
    timed at full reads beside its per-row table lookup, the ``parent``
    library's one-block body, the plain version and gather_pages + SDPA
    (two calls, for scale). Returns its JSON entry."""
    import torch
    from paddle_tpu_torch.ops import cuda_kernels as ck
    B, H, D, bs = 8, 12, 64, 64
    gen = torch.Generator().manual_seed(2)
    entry = {"name": "paged_decode_attention", "route": "cuda",
             **PAGED_SOURCES,
             "replaces": "paddle_tpu/ops/pallas_kernels.py:711",
             "replaces_kernel": "_paged_attn_kernel",
             "design": SPLIT_DESIGN, "table": PAGED_TABLE,
             "library_ms": None,
             "library_note": "no single PyTorch call reads through a block "
                             "table; two_calls_ms is gather_pages of k and "
                             "v then SDPA with a bool mask, for scale"}
    # NB 4 and 8: the 256- and 512-row reads of the serving phase; 16: the
    # 1024-row read a max_len request reaches
    for NB in (4, 8, 16):
        for dt, tag in ((torch.float32, "float32"),
                        (torch.bfloat16, "bfloat16")):
            args = _paged_inputs(B, H, D, bs, NB, dt, gen, device, full=False)
            check(args[0].stride()[:2] == (3 * H * D, D),
                  "paged q is not the strided view the model passes")
            o = ck.paged_decode_attention(*args)
            po = ck.paged_decode_attention(*args, route="plain")
            torch.cuda.synchronize()
            err = (o - po).abs().max().item()
            check(torch.allclose(o, po, atol=F32_ATOL, rtol=F32_RTOL),
                  f"paged NB={NB} {tag} differs from plain: max {err}")
            # timed with every row live (pos = NB*bs - 1): a full read
            rows = B * NB * bs
            esize = args[1].element_size()
            sets = input_sets(lambda i: (_paged_inputs(
                B, H, D, bs, NB, dt, gen, device, full=True), (None, None)),
                2 * (B * NB + 1) * bs * H * D * esize)
            res = {"max_abs_err": err,
                   **paged_times(sets, parent, two_calls=True)}
            del sets
            nbytes = (2 * rows * H * D + B * H * D) * esize \
                + B * H * D * 4 + B * NB * 4 + B * 4
            b_ms, b_by = bound(4.0 * rows * H * D, nbytes, tag)
            res.update(bound_ms=b_ms, bound_by=b_by)
            res["splits"], res["chunk"] = ck.decode_splits(B * H, NB * bs)
            say(f"paged_decode_attention NB={NB} {tag}: {json.dumps(res)}")
            if NB == 4 and dt == torch.float32:
                entry.update(res)
                entry["dtype"] = tag
                entry["shape"] = (f"B={B} bs={bs} NB={NB} H={H} D={D}, "
                                  "timed with every row live")
            else:
                entry[f"NB{NB}_{tag}"] = res
    return entry


def paged_read(s, splits=None, carry=True):
    """#6 or #7 (with scales) on ``s`` = ((q, k_pool, v_pool, tables,
    pos), (k_scale, v_scale)), at the split count ``splits`` (None:
    decode_splits' choice), the table carried or (``carry=False``) looked
    up a row at a time."""
    from paddle_tpu_torch.ops import cuda_kernels as ck
    (q, kp, vp, tables, pos), (ks, vs) = s
    return ck._paged_decode_attention_kernel(
        q, kp, vp, tables, pos, q.shape[-1] ** -0.5, ks, vs, splits=splits,
        carry=carry)


def paged_plain(s):
    from paddle_tpu_torch.ops import cuda_kernels as ck
    (q, kp, vp, tables, pos), (ks, vs) = s
    return ck.paged_decode_attention(q, kp, vp, tables, pos, k_scale=ks,
                                     v_scale=vs, route="plain")


def parent_paged(lib, s):
    """One launch of the parent's one-block #6 (#7 with scales) on ``s``
    (as :func:`paged_read` takes it) through its C entry, which has no
    split arguments: (q, k_pool, v_pool, tables, pos, o, B, H, D, bs, NB,
    q_sb, q_sh, scale, dtype, stream), each scale pool after its pool for
    #7. Returns o, or None when the parent's entry has another argument
    list (a parent that already splits these reads)."""
    import torch
    from paddle_tpu_torch.ops.cuda_kernels import _DTYPE_CODE, _stream
    (q, kp, vp, tables, pos), (ks, vs) = s
    entry = lib.paddle_paged_decode_attention_q if ks is not None \
        else lib.paddle_paged_decode_attention
    if len(entry.argtypes) != (18 if ks is not None else 16):
        return None
    B, H, D = q.shape
    o = torch.empty((B, H, D), dtype=torch.float32, device=q.device)
    tail = (tables.data_ptr(), pos.data_ptr(), o.data_ptr(), B, H, D,
            kp.shape[1], tables.shape[1], q.stride(0), q.stride(1),
            D ** -0.5, _DTYPE_CODE[q.dtype], _stream(q.device))
    pools = (kp.data_ptr(), vp.data_ptr()) if ks is None else \
        (kp.data_ptr(), ks.data_ptr(), vp.data_ptr(), vs.data_ptr())
    err = entry(q.data_ptr(), *pools, *tail)
    check(err == 0, f"the parent's paged read: error {err}")
    return o


def paged_times(sets, parent=None, two_calls=False) -> dict:
    """#6 or #7 over ``sets`` (as :func:`paged_read` takes them): the
    kernel timed in turns with its per-row table lookup and, with a
    ``parent`` library, with the parent's one-block body (its largest
    difference from plain on the first set beside); the plain version;
    with ``two_calls``, gather_pages of k and v then SDPA with a bool mask
    over the same pools."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import cuda_kernels as ck
    ours = [lambda s=s: paged_read(s) for s in sets]
    t = in_turns(ours, [lambda s=s: paged_read(s, carry=False)
                        for s in sets])
    out = {"ms": t["ms"], "per_row_lookup_ms": t["parent_ms"],
           "lookup_turns_ms": t["turns_ms"]}
    first = None if parent is None else parent_paged(parent, sets[0])
    if first is not None:
        err = (first - paged_plain(sets[0])).abs().max().item()
        t = in_turns(ours, [lambda s=s: parent_paged(parent, s)
                            for s in sets])
        out.update(ms_in_parent_turns=t["ms"], parent_ms=t["parent_ms"],
                   parent_turns_ms=t["turns_ms"], parent_max_abs_err=err)
    out["plain_ms"] = time_ms([lambda s=s: paged_plain(s) for s in sets],
                              rounds=1)
    if two_calls:
        calls = []
        for (q, kp, vp, tables, pos), _ in sets:
            L = tables.shape[1] * kp.shape[1]
            live = (torch.arange(L, device=pos.device)[None, :]
                    <= pos[:, None])[:, None, None, :]
            calls.append(lambda q=q, kp=kp, vp=vp, t=tables, m=live:
                         F.scaled_dot_product_attention(
                             q[:, :, None],
                             ck.gather_pages(kp, t).transpose(1, 2),
                             ck.gather_pages(vp, t).transpose(1, 2),
                             attn_mask=m))
        out["two_calls_ms"] = time_ms(calls)
    return out


# ---------------------------------------------------------------------------
# phase 3: serving GPT-2 small
# ---------------------------------------------------------------------------

def workload(seed: int, vocab: int):
    """8 prompts of 32-223 tokens (the serving_daemon mix, kept under 224 so
    that the first segment reads 256 rows and later ones 512), the first
    200 tokens long so that the 256-row prompt bucket is reached."""
    import numpy as np
    rs = np.random.RandomState(seed)
    lens = rs.randint(32, 224, N_REQUESTS)
    lens[0] = 200
    return [rs.randint(0, vocab, int(n)).astype(np.int32) for n in lens]


def serve(model, prompts, device, kv_dtype=None, eng=None, prefix_len=None):
    """Submit every prompt at once through start()/submit()/poll() (one
    burst, no arrival schedule); returns (tokens per request, (ttft, tpot)
    seconds per request, wall seconds, engine). ``eng``: a stopped engine
    to submit to (its graphs stay warm), in place of a new one;
    ``prefix_len``: the shared prefix each request declares. The whole
    burst is queued before the scheduler starts, so the first admission
    sees every request (a scheduler already running may admit the first
    before the rest arrive, and the admissions would differ run to run);
    the engine is stopped at the end."""
    import torch
    from paddle_tpu_torch.serving import ServingEngine
    if eng is None:
        eng = ServingEngine(model, device=device, kv_dtype=kv_dtype,
                            **ENGINE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        rids = [eng.submit(p, NEW_TOKENS, prefix_len=prefix_len)
                for p in prompts]
        eng.start()
        while not all(eng.poll(r)[1] for r in rids):
            time.sleep(0.002)
        wall = time.perf_counter() - t0
    finally:
        eng.stop()
    check(eng.failed is None, f"engine failed: {eng.failed}")
    toks, lat = [], []
    for r in rids:
        out, done, reason = eng.poll(r)
        check(done and reason == "length",
              f"request {r} ended with {reason!r}")
        toks.append(out)
        t = eng.timings(r)
        lat.append((t["t_first"] - t["t_submit"],
                    (t["t_done"] - t["t_first"]) / (len(out) - 1)))
    return toks, lat, wall, eng


def engine_pair(say, what, model, prompts, device, kv_dtype=None):
    """The engine's traffic on the eager route and through the graphs,
    each on one engine (warmed by one burst, then one measured burst and
    one profiled; each burst queued whole before the engine starts
    again): tokens equal, the same launches a segment, one graph replay a
    segment, latency figures and peak memory of the measured burst.
    Returns {route: figures}."""
    import torch
    from paddle_tpu_torch.serving import ServingEngine
    figs = {}

    def run_on(eng):
        seg0 = eng.pool.segments_total
        toks, lat, wall, _ = serve(model, prompts, device, eng=eng)
        return toks, lat, wall, eng.pool.segments_total - seg0

    res = {}
    for route in ("eager", "graphed"):
        eng = ServingEngine(model, device=device, kv_dtype=kv_dtype,
                            **ENGINE)
        try:
            with _route(route):
                run_on(eng)
                gc.collect()
                torch.cuda.reset_peak_memory_stats()
                out = counted(lambda: run_on(eng))
                peak = torch.cuda.max_memory_allocated() / 2 ** 30
                prof = profile_breakdown(say, f"{what} ({route})",
                                         lambda: run_on(eng), out[1],
                                         steps=out[0][3])
                if route == "graphed":
                    graph_launch_check(say, what)
        finally:
            eng.stop()
        res[route] = (out, peak, prof)
        del eng
        gc.collect()        # this engine's pool is not part of the next peak
    for route, (out, peak, prof) in res.items():
        (toks, lat, wall, segs), _, launches, disp = out
        f = latency_figures(lat, wall)
        f["peak_mem_gib"] = peak
        figs[route] = {"steps": segs, "wall_ms_per_step": wall * 1e3 / segs,
                       "launches_per_step": {k: v / segs for k, v in
                                             launches.items()},
                       "graph_dispatches": disp, "profile": prof,
                       "latency": f, "toks": toks}
    eager, graphed = figs["eager"], figs["graphed"]
    check(eager["toks"] == graphed["toks"],
          f"{what}: the graphed engine's tokens differ from the eager one's")
    check(eager["launches_per_step"] == graphed["launches_per_step"],
          f"{what}: kernel launches a segment eager "
          f"{eager['launches_per_step']} != graphed "
          f"{graphed['launches_per_step']}")
    mine = step_dispatches(graphed["graph_dispatches"], "segment")
    check(mine == {"captures": 0, "replays": graphed["steps"]},
          f"{what}: segment graphs {mine} in {graphed['steps']} segments")
    record_pair(say, what, "segment", figs)
    return {r: f["latency"] for r, f in figs.items()}


def latency_figures(lat, wall):
    import numpy as np
    ttft, tpot = np.asarray(lat).T
    return {"requests": len(lat), "tokens_per_s": len(lat) * NEW_TOKENS / wall,
            "ttft_p50_ms": float(np.median(ttft)) * 1e3,
            "ttft_max_ms": float(ttft.max()) * 1e3,
            "tpot_p50_ms": float(np.median(tpot)) * 1e3,
            "tpot_max_ms": float(tpot.max()) * 1e3}


def serving_phase(say, seed: int, device="cuda", config=GPT2_SMALL):
    import numpy as np
    import torch
    from paddle_tpu_torch.models import TransformerLM
    from paddle_tpu_torch.ops import cuda_kernels as ck
    model = TransformerLM(**config).init(seed=seed, device=device)
    prompts = workload(seed, config["vocab"])
    n_layers = config["n_layers"]

    ck.reset_launch_counts()
    toks, lat, wall, eng = serve(model, prompts, device)
    launches = dict(ck.LAUNCHES)
    pool = eng.pool
    say(f"serving f32: admissions {pool.admissions_total} "
        f"{pool.admissions_by_bucket}, segments {pool.segments_total} "
        f"{pool.segments_by_pages} (read pages -> count), launches "
        f"{launches}")
    check(256 in pool.admissions_by_bucket,
          "the 256-row prompt bucket was not reached")
    check(len(pool.segments_by_pages) >= 2,
          "fewer than two cache-read buckets were reached")
    steps = pool.segments_total * pool.segment
    check(launches["flash_attention_fwd"] > 0
          and launches["flash_attention_fwd"]
          == n_layers * pool.admissions_total,
          f"flash launches {launches['flash_attention_fwd']} != "
          f"{n_layers} x {pool.admissions_total} admissions")
    check(launches["paged_decode_attention"] > 0
          and launches["paged_decode_attention"] == n_layers * steps,
          f"paged launches {launches['paged_decode_attention']} != "
          f"{n_layers} x {steps} steps")
    for i, p in enumerate(prompts):
        check(len(toks[i]) == NEW_TOKENS,
              f"request {i}: {len(toks[i])} tokens, want {NEW_TOKENS}")
        ids = torch.as_tensor(p[None].astype(np.int64), device=device)
        solo = model.generate_greedy(ids, NEW_TOKENS, route="plain")
        want = solo[0, len(p):].cpu().numpy().tolist()
        if toks[i] != want:
            j = next(n for n in range(NEW_TOKENS) if toks[i][n] != want[n])
            ctx = solo[:, :len(p) + j]
            top2 = torch.topk(model(ctx, route="plain")[0, -1].float(), 2)
            raise SmokeFailure(
                f"request {i} (prompt {len(p)}): engine token {j} = "
                f"{toks[i][j]}, solo = {want[j]}; solo top-2 logit gap "
                f"{(top2.values[0] - top2.values[1]).item():.3e}")
    say(f"serving f32: {N_REQUESTS} requests x {NEW_TOKENS} tokens equal "
        "to the solo plain-attention greedy decode")
    f32 = latency_figures(lat, wall)
    del eng, pool                # its f32 pool is not part of the bf16 peak
    with _route("eager"):
        eager = serve(model, prompts, device)[0]
    check(eager == toks, "serving f32: the eager route's tokens differ "
          "from the graphed route's")
    say("serving f32: the eager route's tokens equal the graphed route's")

    model.to(torch.bfloat16)
    bf16 = engine_pair(say, "ServingEngine bf16", model, prompts, device)
    say(f"serving smoke figures (not a benchmark): f32 first traffic of the "
        f"process (graph captures included) {json.dumps(f32)}; bf16 warm "
        f"{json.dumps(bf16)}")
    return launches


#: the kernels that each count of ``LAUNCHES`` launches, by parts of their
#: names as a captured graph (mangled) or the profiler (demangled) gives
#: them (#8 and #9 are one body, ``lstm_seq_kernel``)
PORT_KERNEL_BODIES = (
    (("flash_attention_fwd",), ("flash_fwd_wgmma_kernel",
                                "flash_fwd_tf32_kernel")),
    (("flash_attention_bwd_dq",), ("flash_bwd_dq_wgmma_kernel",
                                   "flash_bwd_dq_tf32_kernel")),
    (("flash_attention_bwd_dkv",), ("flash_bwd_dkv_wgmma_kernel",
                                    "flash_bwd_dkv_tf32_kernel")),
    (("decode_attention",), ("DenseCacheI", "DenseCache<")),
    (("decode_attention_q",), ("DenseCacheQ",)),
    (("paged_decode_attention",), ("PagedCacheI", "PagedCache<")),
    (("paged_decode_attention_q",), ("PagedCacheQ",)),
    (("lstm_seq", "lstm_seq_train"), ("lstm_seq_kernel",)),
    (("lstm_seq_bwd",), ("lstm_seq_bwd_kernel",)),
    (("gru_seq",), ("gru_seq_kernel",)),
    (("gru_seq_bwd",), ("gru_seq_bwd_kernel",)),
)

#: the port's kernel nodes of each graph already read, by id (with the
#: graph, so that an id reused after a graph is freed is not mistaken)
_GRAPH_NODES = {}


def graph_kernel_nodes(graph) -> dict:
    """{body: kernel nodes} of the port's kernels in a captured graph, read
    from the graph itself: ``cuGraphDebugDotPrint`` of its cudaGraph_t
    (the cache keeps it, ``raw_cuda_graph``) names every kernel node."""
    import ctypes
    import re
    import tempfile
    hit = _GRAPH_NODES.get(id(graph))
    if hit is not None and hit[0] is graph:
        return hit[1]
    cuda = ctypes.CDLL("libcuda.so.1")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "graph.dot")
        err = cuda.cuGraphDebugDotPrint(
            ctypes.c_void_p(graph.raw_cuda_graph()), path.encode(), 1)
        check(err == 0, f"cuGraphDebugDotPrint failed with CUresult {err}")
        with open(path) as f:
            names = re.findall(r"topoId: \d+\) \| (\w+)", f.read())
    port = [n for n in names if "paddle_tpu_torch" in n]
    nodes, mapped = {}, 0
    for keys, bodies in PORT_KERNEL_BODIES:
        n = sum(1 for name in port if any(b in name for b in bodies))
        if n:
            nodes["+".join(keys)] = n
        mapped += n
    check(names and mapped == len(port), f"a graph of {len(names)} kernel "
          f"nodes holds {len(port)} of the port's, {mapped} of a counted "
          "body")
    _GRAPH_NODES[id(graph)] = (graph, nodes)
    return nodes


def graph_launch_check(say, what: str) -> None:
    """Every graph the caches hold launches, a replay, the port's kernels
    that its capture recorded in ``LAUNCHES``, counted from its kernel
    nodes: so the launches that replays add are measured, not inferred."""
    from paddle_tpu_torch.core import graphs
    total, n = {}, 0
    for owner, label, recorded, graph in graphs.captured():
        want = {}
        for keys, _ in PORT_KERNEL_BODIES:
            k = sum(recorded.get(x, 0) for x in keys)
            if k:
                want["+".join(keys)] = k
        nodes = graph_kernel_nodes(graph)
        check(nodes == want, f"{what}: graph {owner}.{label} holds kernel "
              f"nodes {nodes}, its capture recorded {want}")
        for k, v in nodes.items():
            total[k] = total.get(k, 0) + v
        n += 1
    say(f"{what}: the kernel nodes of the {n} graphs held equal the "
        f"launches their captures recorded (port kernel nodes in all: "
        f"{json.dumps(total)})")


def device_rows(run):
    """(device time in µs, count, name) of every kernel of one ``run()``
    under torch.profiler, and the profiled run's wall seconds."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            rows.append((getattr(e, "self_device_time_total",
                                 getattr(e, "self_cuda_time_total", 0.0)),
                         e.count, e.key))
    return rows, wall_prof


def profile_breakdown(say, what: str, run, wall: float, steps: int = 1,
                      share_of=None):
    """Device busy share of ``run()`` and its top kernels, from one run
    under torch.profiler. The share divides device kernel time by the wall
    time ``wall`` of the same work run unprofiled. ``run()`` takes
    ``steps`` steps; ``share_of`` {label: kernel-name substring, or a
    tuple of them} prints those kernels' device time a step and share.
    Returns {"device_ms_per_step", "busy_share", "kernels_per_step"}, or
    None when the profiler saw no device time. The kernels inside a CUDA
    graph's replay count one by one, as eager launches do."""
    rows, wall_prof = device_rows(run)
    dev_s = sum(r[0] for r in rows) / 1e6
    if dev_s == 0.0:
        say(f"profile {what}: the profiler saw no device time (not measured)")
        return None
    rows.sort(reverse=True)
    port_s = sum(r[0] for r in rows if "paddle_tpu_torch" in r[2]) / 1e6
    kernels = sum(r[1] for r in rows)
    say(f"profile {what}: device kernel time {dev_s * 1e3:.3f} ms, "
        f"wall {wall * 1e3:.3f} ms unprofiled / {wall_prof * 1e3:.3f} ms "
        f"profiled, device busy share {dev_s / wall:.4f}, "
        f"{kernels} kernel launches, the port's own "
        f"kernels {port_s * 1e3:.3f} ms ({100 * port_s / dev_s:.1f}%)")
    for us, n, name in rows[:8]:
        print(f"  {us / 1e3:9.3f} ms {100 * us / 1e6 / dev_s:5.1f}% "
              f"x{n:<6d} {name[:90]}")
    for label, key in (share_of or {}).items():
        keys = (key,) if isinstance(key, str) else key
        k_s = sum(r[0] for r in rows if any(k in r[2] for k in keys)) / 1e6
        say(f"profile {what}: device time a step {dev_s * 1e3 / steps:.3f} "
            f"ms; {label} {k_s * 1e3 / steps:.3f} ms a step, "
            f"{100 * k_s / dev_s:.1f}% of it")
    return {"device_ms_per_step": dev_s * 1e3 / steps,
            "busy_share": dev_s / wall, "kernels_per_step": kernels / steps}


# ---------------------------------------------------------------------------
# every phase's path twice: eager and through the CUDA graphs
# ---------------------------------------------------------------------------

#: one entry per path: its eager and graphed figures (the summary line)
GRAPH_PATHS = []
#: an f32 trainer step through its graph against the eager step, where a
#: GEMM's bits differ under capture: the loss to rtol 1e-6, each parameter
#: to 1e-5 (the f32 step checks' parameter bound)
GRAPH_STEP_LOSS_RTOL, GRAPH_STEP_PARAM_ATOL = 1e-6, 1e-5


def _route(route: str):
    """The eager route (every graph cache runs its bodies directly, as
    ``jax.disable_jit``) or the graphed one."""
    import contextlib
    from paddle_tpu_torch.core import graphs
    return graphs.disabled() if route == "eager" else contextlib.nullcontext()


def counted(fn):
    """fn() with the launch and dispatch counts set to 0 just before and
    read just after: (out, wall seconds, launches, dispatches)."""
    import torch
    from paddle_tpu_torch.core import graphs
    from paddle_tpu_torch.ops import cuda_kernels as ck
    torch.cuda.synchronize()
    ck.reset_launch_counts()
    graphs.reset_dispatch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (out, wall, {k: n for k, n in ck.LAUNCHES.items() if n},
            json.loads(json.dumps(graphs.DISPATCHES)))


def step_dispatches(dispatches, kind: str) -> dict:
    """Captures and replays of the keys whose label starts with ``kind``
    (``decode``, ``segment``, ``round``, ``step``, ...)."""
    out = {"captures": 0, "replays": 0}
    for keys in dispatches.values():
        for label, n in keys.items():
            if label.startswith(kind + "("):
                out["captures"] += n["captures"]
                out["replays"] += n["replays"]
    return out


def route_pair(say, what, run, steps, same, kind, per_step=1,
               share_of=None, profiled=("eager", "graphed")):
    """``run()`` on the eager route and through the graphs. Each route
    runs once to warm (the graphed one captures), once measured with the
    counts set to 0 just before and read just after, and (the routes of
    ``profiled``) once under the profiler. ``steps(out)`` counts the
    measured run's steps (tokens after
    the prefill, segments, rounds, trainer steps, calls); ``same(eager,
    graphed)`` must hold; the graphed run must launch every kernel as
    often as the eager one and replay its ``kind`` graphs ``per_step``
    times a step with no capture. Returns the graphed run's output."""
    figs, outs = {}, {}
    for route in ("eager", "graphed"):
        with _route(route):
            run()
            out, wall, launches, disp = counted(run)
            n = steps(out)
            prof = (profile_breakdown(say, f"{what} ({route})", run, wall,
                                      steps=n, share_of=share_of)
                    if route in profiled else None)
            if route == "graphed":
                graph_launch_check(say, what)
        outs[route] = out
        figs[route] = {
            "steps": n, "wall_ms_per_step": wall * 1e3 / n,
            "launches_per_step": {k: v / n for k, v in launches.items()},
            "graph_dispatches": disp, "profile": prof}
    eager, graphed = figs["eager"], figs["graphed"]
    check(same(outs["eager"], outs["graphed"]),
          f"{what}: the graphed route's output differs from the eager "
          "route's")
    check(eager["steps"] == graphed["steps"],
          f"{what}: {eager['steps']} eager steps, {graphed['steps']} graphed")
    check(eager["launches_per_step"] == graphed["launches_per_step"]
          and graphed["launches_per_step"],
          f"{what}: kernel launches eager {eager['launches_per_step']} != "
          f"graphed {graphed['launches_per_step']}")
    check(not eager["graph_dispatches"],
          f"{what}: the eager route dispatched graphs "
          f"{eager['graph_dispatches']}")
    mine = step_dispatches(graphed["graph_dispatches"], kind)
    check(mine == {"captures": 0, "replays": per_step * graphed["steps"]},
          f"{what}: {kind} graphs {mine} in {graphed['steps']} steps, want "
          f"{per_step} replay a step and no capture")
    record_pair(say, what, kind, figs)
    return outs["graphed"]


def record_pair(say, what, kind, figs) -> None:
    """Print a path's before (eager) and after (graphed) figures a step and
    keep them for the summary line."""
    row = {"path": what, "step": kind}
    for route, f in figs.items():
        prof = f["profile"] or {}
        row[route] = {
            "wall_ms_per_step": f["wall_ms_per_step"],
            "device_ms_per_step": prof.get("device_ms_per_step"),
            "busy_share": prof.get("busy_share"),
            "device_kernels_per_step": prof.get("kernels_per_step"),
            "graph_dispatches_per_step": sum(
                n["captures"] + n["replays"]
                for keys in f["graph_dispatches"].values()
                for n in keys.values()) / f["steps"],
            "port_launches_per_step": f["launches_per_step"]}
    GRAPH_PATHS.append(row)
    say(f"graphs {what}: eager -> graphed a {kind} step: "
        f"{json.dumps(row)}")


# ---------------------------------------------------------------------------
# phase 4: the LSTM kernels against their plain versions
# ---------------------------------------------------------------------------

# the flagship text classifier (benchmarks/lstm_textcls.py:28-35, the
# reference's benchmark/paddle/rnn/rnn.py): vocab 30000, embed 128, one
# LSTM layer of 256, 2 classes, batch 64, padded length 100, lengths
# uniform in 30..100, Adam 2e-3, bf16 compute over f32 master weights
TEXTCLS = dict(vocab=30000, embed=128, hidden=256, classes=2)
TEXTCLS_BATCH, TEXTCLS_LEN, TEXTCLS_MIN_LEN = 64, 100, 30
TEXTCLS_NBUF, TEXTCLS_PASSES, TEXTCLS_LR = 8, 3, 2e-3
# the edge shape: a batch under one tile, lengths 0, 1 and T, h0/c0 != 0
LSTM_EDGE_LENS = (0, 1, 7, 3, 5)
# #10's design (both dtypes)
LSTM_BWD_DESIGN = ("one cooperative launch in three phases: the gates of "
                   "every step recomputed in parallel (mma.sync, three TF32 "
                   "passes in f32, one for bf16 operands); the reverse "
                   "recurrence with one grid barrier and one product a "
                   "step (each block's 16-column partial of dgates @ U^T, "
                   "summed over blocks in a fixed order); dU in parallel "
                   "over (t, b) on the tensor cores")

LSTM_KERNELS = (
    ("lstm_seq", "paddle_tpu_torch/csrc/lstm_seq.cu",
     "paddle_tpu/ops/pallas_kernels.py:837", "_lstm_seq_kernel"),
    ("lstm_seq_train", "paddle_tpu_torch/csrc/lstm_seq.cu",
     "paddle_tpu/ops/pallas_kernels.py:872", "_lstm_seq_train_kernel"),
    ("lstm_seq_bwd", "paddle_tpu_torch/csrc/lstm_seq_bwd.cu",
     "paddle_tpu/ops/pallas_kernels.py:1019", "_lstm_seq_bwd_kernel"),
)


def lstm_close(got, want, what: str, dtype_name: str, sum_terms: int = 0):
    """Hold a kernel output against the plain version's, with the stated
    tolerance; returns the max abs error.

    Both compute in f32 and differ only in summation order (and carry h, c
    and dh in f32 across all steps: neither rounds state to bf16 between
    steps, as the JAX wrapper's chunked bf16 path does). f32 outputs: atol
    1e-5, rtol 1e-4. bf16 outputs are the same f32 values rounded once, so
    they differ by at most one bf16 ulp: rtol 2**-7, atol 1e-6. du is an
    f32 sum of ``sum_terms`` = B*T products per entry in both dtypes:
    rtol 1e-4, atol 1e-5 * its largest magnitude."""
    import torch
    g, w = got.float(), want.float()
    err = (g - w).abs().max().item() if g.numel() else 0.0
    if sum_terms:
        atol, rtol = 1e-5 * w.abs().max().item(), 1e-4
    elif dtype_name == "float32":
        atol, rtol = 1e-5, 1e-4
    else:
        atol, rtol = 1e-6, 2.0 ** -7
    check(torch.allclose(g, w, atol=atol, rtol=rtol),
          f"{what} {dtype_name} differs from plain: max abs {err} "
          f"(atol {atol}, rtol {rtol})")
    return err


def _lstm_inputs(B, T, H, lens, dtype, gen, device, state: bool):
    """Kernel inputs as the model makes them: xw = x@W of unit-scale
    embeddings through U(-0.08, 0.08) weights, U and b likewise, the
    cotangents of a mean loss; h0/c0 nonzero when ``state``."""
    import torch

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(device, dtype)
    zeros = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    xw = rnd(B, T, 4 * H, scale=0.5)
    u = ((torch.rand((H, 4 * H), generator=gen) - 0.5) * 0.16).to(device,
                                                                  dtype)
    b = rnd(4 * H, scale=0.1)
    h0 = rnd(B, H, scale=0.5) if state else zeros(B, H)
    c0 = rnd(B, H, scale=0.5) if state else zeros(B, H)
    lengths = torch.as_tensor(lens, dtype=torch.int32, device=device)
    cot = (rnd(B, T, H, scale=0.01), rnd(B, H, scale=0.01),
           rnd(B, H, scale=0.01))
    return (xw, lengths, u, b, h0, c0), cot


def _lstm_case(B, T, H, lens, dtype, gen, device, state):
    """Inputs of all three kernels: the forward's, then the backward's with
    the residuals (out, c_seq) of the plain training forward."""
    from paddle_tpu_torch.ops import rnn_kernels as rk
    fwd, (g_out, g_ht, g_ct) = _lstm_inputs(B, T, H, lens, dtype, gen,
                                            device, state)
    out, _, _, c_seq = rk.lstm_sequence_fused(
        *fwd, forget_bias=1.0, save_cell=True, route="plain")
    return fwd, fwd + (out, c_seq, g_out, g_ht, g_ct)


def lstm_kernel_checks(say, seed: int, device="cuda", timed: bool = True,
                       flagship=(TEXTCLS_BATCH, TEXTCLS_LEN,
                                 TEXTCLS["hidden"]), parent=None):
    """#8, #9 and #10 against their plain versions in f32 and bf16 at the
    flagship shape (lengths from the seed in 30..100), at the training
    loop's shape (phase 14's first batch through its feeder: the lengths
    of its rows, T bucketed to 128) and at the edge shape; at the
    flagship shape also their times, the plain versions' and the bound
    (and #8's and #9's beside the ``parent`` library's bodies, timed in
    turns, where one is given). Returns the kernels' JSON entries (the
    bf16 flagship numbers first: that is what the training path runs)."""
    import numpy as np
    import torch
    from paddle_tpu_torch.ops import rnn_kernels as rk
    B, T, H = flagship
    rs = np.random.RandomState(seed)
    flag_lens = rs.randint(min(TEXTCLS_MIN_LEN, T), T + 1, B)
    edge_T = max(LSTM_EDGE_LENS)
    loop_sb = loop_feeder(device)(next(loop_rows(seed + 1, 1)()))[0]
    shapes = (("flagship", B, T, flag_lens, False),
              ("loop", loop_sb.batch_size, loop_sb.max_len,
               loop_sb.lengths.tolist(), False),
              ("edge", len(LSTM_EDGE_LENS), edge_T, LSTM_EDGE_LENS, True))
    gen = torch.Generator().manual_seed(seed + 3)
    entries = {name: {"name": name, "route": "cuda", "source": src,
                      "replaces": rep, "replaces_kernel": body,
                      "library_ms": None,
                      "library_note": "no single PyTorch call: cuDNN's LSTM "
                                      "has no per-sample length mask with "
                                      "a frozen state"}
               for name, src, rep, body in LSTM_KERNELS}
    entries["lstm_seq_bwd"]["design"] = LSTM_BWD_DESIGN
    for name in ("lstm_seq", "lstm_seq_train"):
        entries[name]["design"] = RNN_FWD_DESIGN
        entries[name]["plan"] = forward_plan_entry("lstm", B, H)
    fwd_kw = dict(forget_bias=1.0)

    def run(name, args, route=None):
        if name == "lstm_seq_bwd":
            return rk.lstm_sequence_fused_bwd(*args, route=route, **fwd_kw)
        return rk.lstm_sequence_fused(*args, save_cell=name != "lstm_seq",
                                      route=route, **fwd_kw)

    for tag, Bs, Ts, lens, state in shapes:
        for dt, dname in ((torch.float32, "float32"),
                          (torch.bfloat16, "bfloat16")):
            fwd, bwd = _lstm_case(Bs, Ts, H, lens, dt, gen, device, state)
            for name, _, _, _ in LSTM_KERNELS:
                args = bwd if name == "lstm_seq_bwd" else fwd
                got, want = run(name, args), run(name, args, route="plain")
                if timed:
                    torch.cuda.synchronize()
                errs = [lstm_close(g, w, f"{name} {tag} output {i}", dname,
                                   sum_terms=Bs * Ts if (
                                       name == "lstm_seq_bwd" and i == 3)
                                   else 0)
                        for i, (g, w) in enumerate(zip(got, want))]
                if tag == "edge":
                    for b, n in enumerate(lens):
                        if n == 0 and name != "lstm_seq_bwd":
                            check(not got[0][b].any().item(),
                                  f"{name}: a 0-length sample has output")
                            check(torch.equal(got[1][b], fwd[4][b]),
                                  f"{name}: a 0-length sample's hT != h0")
                res = {"max_abs_err": max(errs)}
                if tag != "edge":
                    again = run(name, args)
                    check(all(torch.equal(a, b) for a, b in zip(got, again)),
                          f"{name} {tag} {dname}: two runs differ")
                    res["bit_equal_two_runs"] = True
                if timed and tag == "flagship":
                    res.update(_lstm_times(name, run, Bs, Ts, H, lens, dt,
                                           dname, gen, device, parent))
                say(f"{name} {tag} B={Bs} T={Ts} H={H} {dname}: "
                    f"{json.dumps(res)}")
                e = entries[name]
                if tag == "flagship" and dt == torch.bfloat16:
                    e.update(res)
                    e["dtype"] = dname
                    e["shape"] = (f"B={Bs} T={Ts} H={H}, lengths "
                                  f"{TEXTCLS_MIN_LEN}..{T} from the seed")
                else:
                    e[f"{tag}_{dname}"] = res
    return [entries[name] for name, _, _, _ in LSTM_KERNELS]


def _lstm_times(name, run, B, T, H, lens, dt, dname, gen, device,
                parent=None):
    """Kernel and plain times (CUDA graph over input sets larger than L2)
    and the bound: the recurrent products of the live steps (2*H*4H per
    live (sample, step), three of them in the backward) against each
    input read and each output written once; the backward's products run
    on the tensor cores (:func:`tensor_core_bound`), the forwards' on the
    CUDA cores. A forward's time is also given a step (over the longest
    length) and, with a ``parent`` library, beside the parent's body's
    (:func:`in_turns`)."""
    import torch
    esize = torch.empty((), dtype=dt).element_size()
    G = 4 * H
    seq, vec = B * T * H * esize, B * H * esize
    fwd_bytes = B * T * G * esize + H * G * esize + G * esize + 2 * vec \
        + B * 4 + seq + 2 * vec
    if name == "lstm_seq_train":
        fwd_bytes += seq
    if name == "lstm_seq_bwd":
        nbytes = (B * T * G * esize + H * G * esize + G * esize + 2 * vec
                  + B * 4 + 3 * seq + 2 * vec          # + out, c_seq, g_*
                  + B * T * G * esize + 2 * vec + H * G * 4)
        flops = 3 * 2.0 * int(sum(lens)) * H * G
    else:
        nbytes = fwd_bytes
        flops = 2.0 * int(sum(lens)) * H * G
    sets = input_sets(
        lambda i: _lstm_case(B, T, H, lens, dt, gen, device, False)[
            1 if name == "lstm_seq_bwd" else 0], nbytes)
    ours = [lambda s=s: run(name, s) for s in sets]
    extra = {}
    if name in FWD_NAMES:
        extra = (_parent_turns(name, ours, sets, parent) if parent
                 else {}) or {"ms": time_ms(ours)}
        extra["us_a_step"] = extra["ms"] * 1e3 / max(lens)
    ms = extra.get("ms") or time_ms(ours)
    plain_ms = time_ms([lambda s=s: run(name, s, route="plain")
                        for s in sets], rounds=1, reps=2)
    del sets
    if name == "lstm_seq_bwd":
        return {"ms": ms, "plain_ms": plain_ms,
                **tensor_core_bound(flops, nbytes, dname)}
    b_ms, b_by = bound(flops, nbytes, dname)
    return {**extra, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by}


# ---------------------------------------------------------------------------
# the recurrent forwards (#8, #9, #11): plans, the parent's bodies, sweep
# ---------------------------------------------------------------------------

# the forwards' design (both dtypes)
RNN_FWD_DESIGN = ("one cooperative launch on a planned grid "
                  "(ops/rnn_kernels.py forward_plan: 8 or 16 units x 8, 16 "
                  "or 32 rows a block, one wave): each step a row's "
                  "exchanged state read once a block from L2 into "
                  "registers, 8 lanes a row against the block's U columns "
                  "in shared memory (f32, CUDA cores), a reduce-scatter "
                  "over the 8 lanes to the owner lanes; one grid barrier a "
                  "step (the GRU two); dead rows not read, the loop ends at "
                  "the longest length")
# the bodies these replaced, in the parent commit: 4 units x 32 rows a
# block, rows staged through shared memory
FWD_NAMES = ("lstm_seq", "lstm_seq_train", "gru_seq")


def load_parent(root: str):
    """The kernels of another checkout of this repo (``--parent``: the
    parent commit unpacked by ``git archive``), built from its own sources
    by its own ``_build.py`` into its own ``_build/``, to time its
    forward bodies in turns with these. Returns its library."""
    import importlib.util
    path = os.path.join(root, "paddle_tpu_torch", "ops", "_build.py")
    spec = importlib.util.spec_from_file_location("parent_build", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.load().lib


# the argument counts of the forward entries parent_forward calls: those
# before the planned grids, which take no plan
PARENT_FORWARD_ARGS = {"lstm_seq": 16, "lstm_seq_train": 17, "gru_seq": 13}


def parent_forward(lib, name: str, args):
    """One launch of the parent's body of forward ``name`` through its C
    entry (whose argument lists these are), on the arguments the port's
    wrapper takes: (xw, lengths, u, b, h0, c0) for the LSTM, (xw, lengths,
    u, None, h0) for the GRU. Returns the outputs as the wrapper does."""
    import torch
    from paddle_tpu_torch.ops.cuda_kernels import _DTYPE_CODE, _stream
    xw, lens = args[0], args[1].to(torch.int32).contiguous()
    B, T, G = xw.shape
    H = G // (3 if name == "gru_seq" else 4)
    empty = lambda *s: torch.empty(s, dtype=xw.dtype, device=xw.device)
    f32 = lambda *s: torch.empty(s, dtype=torch.float32, device=xw.device)
    out, h_t = empty(B, T, H), empty(B, H)
    code, st = _DTYPE_CODE[xw.dtype], _stream(xw.device)
    if name == "gru_seq":
        u, h0 = args[2], args[4]
        err = lib.paddle_gru_seq(
            xw.data_ptr(), lens.data_ptr(), u.data_ptr(), h0.data_ptr(),
            out.data_ptr(), h_t.data_ptr(), f32(B, H).data_ptr(),
            f32(B, H).data_ptr(), B, T, H, code, st)
        res = (out, h_t)
    else:
        _, _, u, b, h0, c0 = args
        c_t = empty(B, H)
        ptrs = [xw.data_ptr(), lens.data_ptr(), u.data_ptr(), b.data_ptr(),
                h0.data_ptr(), c0.data_ptr(), out.data_ptr(),
                h_t.data_ptr(), c_t.data_ptr()]
        res = (out, h_t, c_t)
        if name == "lstm_seq_train":
            c_seq = empty(B, T, H)
            ptrs.append(c_seq.data_ptr())
            res += (c_seq,)
        entry = getattr(lib, "paddle_" + name)
        err = entry(*ptrs, f32(2, B, H).data_ptr(), B, T, H, 1.0, code, st)
    check(err == 0, f"the parent's {name}: error {err}")
    return res


def in_turns(ours, theirs) -> dict:
    """Our body's time and the parent's, timed in turns (parent, ours,
    ours, parent) in one run on one card; each a mean of its two turns."""
    t = [time_ms(theirs), time_ms(ours), time_ms(ours), time_ms(theirs)]
    return {"ms": (t[1] + t[2]) / 2, "parent_ms": (t[0] + t[3]) / 2,
            "turns_ms": t}


def forward_plan_entry(kind: str, B: int, H: int) -> dict:
    """The plan the wrapper launches a forward with on this card."""
    from paddle_tpu_torch.ops import rnn_kernels as rk
    p = rk.forward_plan(kind, B, H, *rk.card_limits(0))
    return {"units": p.units, "rows": p.rows, "parts": p.parts,
            "grid": list(p.grid), "threads": p.threads,
            "blocks_an_sm": p.per_sm, "smem_bytes": p.smem}


def _forward_run(name, args, plan=None):
    """The port's forward ``name`` on (xw, lengths, u, b, h0[, c0]), at
    the wrapper's plan or at ``plan``."""
    from paddle_tpu_torch.ops import rnn_kernels as rk
    if name == "gru_seq":
        if plan is None:
            return rk.gru_sequence_fused(*args)
        return rk._gru_sequence_fused_kernel(args[0], args[1], args[2],
                                             args[4], plan=plan)
    save = name == "lstm_seq_train"
    if plan is None:
        return rk.lstm_sequence_fused(*args, forget_bias=1.0, save_cell=save)
    return rk._lstm_sequence_fused_kernel(*args, 1.0, save, plan=plan)


def _parent_turns(name, ours, sets, parent) -> dict:
    """Our forward ``name`` timed in turns with the parent's body, whose
    largest difference from the plain version on the first input set is
    given beside (a report: the parent is not held to anything here).
    Nothing when the parent's entry takes a plan (its body is this one's)."""
    if len(getattr(parent, "paddle_" + name).argtypes) \
            != PARENT_FORWARD_ARGS[name]:
        return {}
    want = _plain_forward(name, sets[0])
    err = max((g.float() - w.float()).abs().max().item() for g, w in zip(
        parent_forward(parent, name, sets[0]), want))
    return {**in_turns(ours, [lambda s=s: parent_forward(parent, name, s)
                              for s in sets]), "parent_max_abs_err": err}


def rnn_sweep(say, seed: int, device="cuda") -> dict:
    """Every plan forward_plans lists for #8, #9 (the flagship B=64, T=100,
    H=256) and #11 (the seq2seq's B=64, T=32, H=512), in f32 and bf16:
    each held against the plain version, then timed (CUDA graph over input
    sets larger than L2); prints the chosen plan beside the fastest.
    Returns {"<name> <dtype>": {"chosen": .., "best": .., ...}}."""
    import numpy as np
    import torch
    from paddle_tpu_torch.ops import rnn_kernels as rk
    rs = np.random.RandomState(seed)
    gen = torch.Generator().manual_seed(seed + 29)
    res = {}
    for name in FWD_NAMES:
        kind = "gru" if name == "gru_seq" else "lstm"
        if kind == "gru":
            B, T, H = S2S_BATCH, S2S_SEQ, S2S["hidden"]
            lens = rs.randint(S2S_MIN_LEN, T + 1, B)
        else:
            B, T, H = TEXTCLS_BATCH, TEXTCLS_LEN, TEXTCLS["hidden"]
            lens = rs.randint(TEXTCLS_MIN_LEN, T + 1, B)
        plans = rk.forward_plans(kind, B, H, *rk.card_limits(0))
        for dt, dname in ((torch.float32, "float32"),
                          (torch.bfloat16, "bfloat16")):
            if kind == "gru":
                make = lambda i: _gru_inputs(B, T, H, lens, dt, gen,
                                             device)[0]
                nbytes = B * T * 3 * H * dt.itemsize * 2
            else:
                make = lambda i: _lstm_inputs(B, T, H, lens, dt, gen,
                                              device, False)[0]
                nbytes = B * T * 4 * H * dt.itemsize * 2
            sets = input_sets(make, nbytes)
            want = _plain_forward(name, sets[0])
            tag = lambda p: f"{p.units}x{p.rows}/{p.parts}"
            times = []
            for p in plans:
                got = _forward_run(name, sets[0], plan=p)
                for i, (g, w) in enumerate(zip(got, want)):
                    lstm_close(g, w, f"{name} plan {tag(p)} output {i}",
                               dname)
                times.append(time_ms([lambda s=s, p=p: _forward_run(
                    name, s, plan=p) for s in sets]))
            del sets
            best = min(range(len(plans)), key=times.__getitem__)
            entry = {"chosen": tag(plans[0]), "chosen_ms": times[0],
                     "best": tag(plans[best]), "best_ms": times[best],
                     "all_ms": {tag(p): t for p, t in zip(plans, times)}}
            res[f"{name} {dname}"] = entry
            say(f"rnn sweep {name} B={B} T={T} H={H} {dname}: chosen "
                f"{entry['chosen']} {times[0]:.4f} ms, best "
                f"{entry['best']} {times[best]:.4f} ms "
                f"({times[0] / times[best]:.3f}x); "
                f"{json.dumps(entry['all_ms'])}")
    return res


def _plain_forward(name, args):
    from paddle_tpu_torch.ops import rnn_kernels as rk
    if name == "gru_seq":
        return rk.gru_sequence_fused(*args, route="plain")
    return rk.lstm_sequence_fused(*args, forget_bias=1.0,
                                  save_cell=name == "lstm_seq_train",
                                  route="plain")


# ---------------------------------------------------------------------------
# phase 5: training the flagship LSTM text classifier
# ---------------------------------------------------------------------------

def textcls_batches(seed: int, n: int, device, batch=TEXTCLS_BATCH,
                    seq_len=TEXTCLS_LEN, vocab=TEXTCLS["vocab"]):
    """``n`` batches (data [B, T] int32, lengths [B] int32 in 30..T,
    labels [B]) from ``seed``. A label is the parity of the sample's last
    valid token, so that the loss of a batch seen before can fall (the
    benchmark's labels are random)."""
    import numpy as np
    import torch
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        data = rs.randint(0, vocab, (batch, seq_len)).astype(np.int32)
        lengths = rs.randint(min(TEXTCLS_MIN_LEN, seq_len), seq_len + 1,
                             batch).astype(np.int32)
        labels = data[np.arange(batch), lengths - 1] % 2
        out.append(tuple(torch.as_tensor(a, device=device)
                         for a in (data, lengths, labels)))
    return out


def cast_tree(params, dtype):
    """The benchmarks' mixed precision: f32 leaves cast to ``dtype`` (the
    f32 masters stay the optimizer's)."""
    import torch
    from paddle_tpu_torch.core.pytree import tree_map
    return tree_map(lambda a: a.to(dtype) if a.dtype == torch.float32
                    else a, params)


def bf16_loss(model):
    """The benchmark's loss: params cast to bf16 (f32 master weights stay
    the optimizer's), the forward in bf16, the loss as f32."""
    import torch
    from paddle_tpu_torch.core import SeqBatch

    def loss_fn(params, data, lengths, labels):
        return model.call(cast_tree(params, torch.bfloat16),
                          SeqBatch(data, lengths), labels).to(torch.float32)
    return loss_fn


def f32_loss(model, route=None):
    from paddle_tpu_torch.core import SeqBatch

    def loss_fn(params, data, lengths, labels):
        return model.call(params, SeqBatch(data, lengths), labels,
                          route=route)
    return loss_fn


def f32_step_check(say, model, batch, device, what="f32 training step",
                   loss_for=None, lr=TEXTCLS_LR):
    """One f32 Adam step through the kernels against the same step with
    the plain versions, on the card. Tolerances: the gradients (read as
    Adam's first moment, 0.1 g) to rtol 1e-4 plus 1e-5 of each tensor's
    largest magnitude (summation order); the updated parameters to atol
    1e-5 (0.5% of the lr: the first Adam step lr*g/(|g|+eps) turns ~1e-11
    differences of gradients near eps into ~1e-6). ``loss_for(route)``:
    the loss of another model than the text classifier."""
    import torch
    from paddle_tpu_torch.core.pytree import tree_get, tree_items
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.trainer import Trainer
    res = {}
    for route in (None, "plain"):
        loss = loss_for(route) if loss_for else f32_loss(model, route)
        tr = Trainer(loss, Adam(lr), device=device)
        res[route] = tr.step(model.tree(), tr.opt.init(model.tree()), *batch)
    (pk, sk, lk), (pp, sp, lp) = res[None], res["plain"]
    check(abs(lk.item() - lp.item()) <= 1e-5, f"f32 loss {lk.item()} != "
          f"plain {lp.item()}")
    worst = {}
    for path, m_p in tree_items(sp["slots"]):
        m_k = tree_get(sk["slots"], path)
        atol = 1e-5 * m_p.abs().max().item()
        err = (m_k - m_p).abs().max().item()
        check(torch.allclose(m_k, m_p, rtol=1e-4, atol=atol),
              f"f32 step: {'/'.join(path)} differs from plain: {err}")
        worst["/".join(path)] = err
    for (path, a), (_, b) in zip(tree_items(pk), tree_items(pp)):
        err = (a - b).abs().max().item()
        check(err <= 1e-5, f"f32 step: param {'/'.join(path)} differs "
              f"from plain by {err}")
        worst["param " + "/".join(path)] = err
    say(f"{what}, kernels vs plain on the card: loss "
        f"{lk.item():.6f} vs {lp.item():.6f}; max abs differences "
        f"{json.dumps(worst)}")


def training_phase(say, seed: int, device="cuda", config=TEXTCLS,
                   batch=TEXTCLS_BATCH, seq_len=TEXTCLS_LEN,
                   passes=TEXTCLS_PASSES, warmup=4):
    """Trainer.train over 8 batches for ``passes`` passes (bf16 compute,
    f32 master, Adam), then Trainer.test over two held batches, on the
    eager route and through the graphs; launch counts, a falling loss and
    ms per step; before that, one f32 step against the plain route's and
    one through its graph against the eager step. Returns the counts."""
    from paddle_tpu_torch.models import LSTMTextCls
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.trainer import Trainer
    model = LSTMTextCls(config["vocab"], config["embed"], config["hidden"],
                        config["classes"], pool="last").init(seed, device)
    data = textcls_batches(seed, TEXTCLS_NBUF + 2, device, batch, seq_len,
                           config["vocab"])
    batches, held = data[:TEXTCLS_NBUF], data[TEXTCLS_NBUF:]
    f32_step_check(say, model, batches[0], device)
    graph_step_check(say, "textcls", f32_loss(model), model.tree(),
                     batches[0], TEXTCLS_LR, device)
    names = ("lstm_seq_train", "lstm_seq_bwd")
    launches, steps = train_and_time(
        say, "textcls", lambda: Trainer(bf16_loss(model), Adam(TEXTCLS_LR),
                                        device=device),
        model.tree(), batches, passes, 1, device, warmup=warmup,
        names=names, held=held)
    check(launches.get("lstm_seq") == len(held),
          f"LSTM inference launches {launches.get('lstm_seq')} != one per "
          f"held batch ({len(held)})")
    return launches, steps


# ---------------------------------------------------------------------------
# phase 6: the flash-attention backward kernels against their plain versions
# ---------------------------------------------------------------------------

FLASH_BWD_KERNELS = (
    ("flash_attention_bwd_dq", "paddle_tpu/ops/pallas_kernels.py:123",
     "_fa_bwd_dq_kernel"),
    ("flash_attention_bwd_dkv", "paddle_tpu/ops/pallas_kernels.py:168",
     "_fa_bwd_dkv_kernel"),
)
# (name, B, T, S, H, causal, lengths, q/k/v as views of one fused
# projection): (a) the LM's, T = 1023 as the loss shifts a 1024-token
# batch; (b) the NMT's self-attention, lengths 32..64 and one 0 (clamped
# to 1 by the wrapper); (c) a cross-attention shape with S != T; (d) the
# strided views the models hand over
BWD_SHAPES = (
    ("lm", 8, 1023, 1023, 12, True, None, False),
    ("nmt", 64, 64, 64, 8, False, "nmt", False),
    ("cross", 16, 100, 77, 8, False, "any", False),
    ("fused", 4, 300, 300, 12, True, "any", True),
)
HEAD_DIM = 64


def _bwd_lens(kind, B, S, rs):
    import numpy as np
    if kind is None:
        return None
    lo = NMT_MIN_LEN if kind == "nmt" else 1
    lens = rs.randint(lo, S + 1, B).astype(np.int32)
    lens[1] = 0 if kind == "nmt" else S
    return lens


def _bwd_inputs(B, T, S, H, causal, lens, fused, dtype, gen, device,
                D=HEAD_DIM):
    """(q, k, v, o, lse, do) and kv_lens: o and lse from the plain forward,
    do a unit-scale cotangent."""
    import torch
    from paddle_tpu_torch.ops import cuda_kernels as ck
    rnd = lambda *shape: torch.randn(shape, generator=gen).to(device, dtype)
    if fused:
        q, k, v = _qkv_views(B, T, H, D, dtype, gen, device)
    else:
        q, k, v = rnd(B, T, H, D), rnd(B, S, H, D), rnd(B, S, H, D)
    kv = None if lens is None else torch.as_tensor(lens, device=device)
    o, lse = ck.flash_attention_fwd(q, k, v, causal=causal, kv_lens=kv,
                                    route="plain")
    return (q, k, v, o, lse, rnd(B, T, H, D)), kv


def live_pairs(T, S, causal, lens, B):
    """(q, k) pairs the kernels compute for these lengths (clamped to
    [1, S] as the wrapper clamps them), summed over the batch."""
    total = 0
    for n in ([S] * B if lens is None else [min(max(int(x), 1), S)
                                            for x in lens]):
        if causal:
            m = min(n, T)
            total += m * (m + 1) // 2 + (T - m) * n
        else:
            total += T * n
    return total


def bwd_close(got, want, what, dtype_name):
    """Hold an attention output against the plain version's; returns the max
    abs error. f32: summation order only (rtol 1e-4, atol 2e-5 of the
    largest magnitude: a dk entry sums up to T products); bf16: the same
    f32 values rounded once, so one bf16 ulp (rtol 2**-7) on top. The bf16
    tensor-core bodies are held by bf16_tc_close."""
    import torch
    g, w = got.float(), want.float()
    err = (g - w).abs().max().item()
    atol = 2e-5 * w.abs().max().item()
    rtol = 1e-4 if dtype_name == "float32" else 2.0 ** -7
    check(torch.allclose(g, w, atol=atol, rtol=rtol),
          f"{what} {dtype_name} differs from plain: max abs {err} (atol "
          f"{atol}, rtol {rtol})")
    return err


def bwd_f64(args, causal, kv):
    """The plain backward's arithmetic (``flash_attention_bwd_plain``) in
    float64 on the same f32 inputs: the yardstick of the f32 errors."""
    import torch
    q, k, v, o, lse, do = (a.double() for a in args)
    T, S, D = q.shape[1], k.shape[1], q.shape[-1]
    scale = D ** -0.5
    qs = q * scale
    live = torch.ones((1, 1, T, S), dtype=torch.bool, device=q.device)
    if kv is not None:
        lens = kv.clamp(1, S)
        live = live & (torch.arange(S, device=q.device)[None, :]
                       < lens[:, None])[:, None, None, :]
    if causal:
        live = live & torch.ones((T, S), dtype=torch.bool,
                                 device=q.device).tril()
    s = torch.einsum("bthd,bshd->bhts", qs, k)
    p = torch.where(live, torch.exp(s - lse.transpose(1, 2)[..., None]), 0.0)
    del s
    dp = torch.einsum("bthd,bshd->bhts", do, v)
    ds = p * (dp - torch.sum(do * o, dim=-1).transpose(1, 2)[..., None])
    del dp
    return (torch.einsum("bhts,bshd->bthd", ds, k) * scale,
            torch.einsum("bhts,bthd->bshd", ds, qs),
            torch.einsum("bhts,bthd->bshd", p, do))


def f64_errors(got, ref) -> list:
    """max |got - ref| of dq, dk, dv against the float64 backward."""
    return [(g.double() - r).abs().max().item() for g, r in zip(got, ref)]


def tolerance_used(got, want) -> float:
    """The largest share of bwd_close's f32 allowance (atol 2e-5 of the
    largest magnitude + rtol 1e-4) that an entry uses: 1 is the limit."""
    g, w = got.float(), want.float()
    allowed = 2e-5 * w.abs().max() + 1e-4 * w.abs()
    return ((g - w).abs() / allowed).max().item()


def fwd_f32_close(got, want, what: str) -> float:
    """#1's f32 output against the plain version's: summation order only
    (F32_ATOL, F32_RTOL, as phase 2); returns the max abs error."""
    import torch
    err = (got - want).abs().max().item()
    check(torch.allclose(got, want, atol=F32_ATOL, rtol=F32_RTOL),
          f"{what} float32 differs from plain: max abs {err} (atol "
          f"{F32_ATOL}, rtol {F32_RTOL})")
    return err


def fwd_f64_errors(got, plain, qkv, causal, kv) -> dict:
    """#1's f32 o and lse, and the plain f32 version's, against the plain
    version's arithmetic in float64 on the same inputs, and the largest
    share of the f32 allowance (F32_ATOL + F32_RTOL * |plain|) that the
    kernel's entries use: 1 is the limit."""
    import torch
    q, k, v = (t.double() for t in qkv)
    T, S, D = q.shape[1], k.shape[1], q.shape[-1]
    s = torch.einsum("bthd,bshd->bhts", q, k) * D ** -0.5
    live = torch.ones((1, 1, T, S), dtype=torch.bool, device=q.device)
    if kv is not None:
        lens = kv.clamp(1, S)
        live = live & (torch.arange(S, device=q.device)[None, :]
                       < lens[:, None])[:, None, None, :]
    if causal:
        live = live & torch.ones((T, S), dtype=torch.bool,
                                 device=q.device).tril()
    s = torch.where(live, s, -1e30)
    ref = (torch.einsum("bhts,bshd->bthd", torch.softmax(s, dim=-1), v),
           torch.logsumexp(s, dim=-1).transpose(1, 2))
    del s
    errs = lambda outs: [(a.double() - r).abs().max().item()
                         for a, r in zip(outs, ref)]
    used = [((g - w).abs() / (F32_ATOL + F32_RTOL * w.abs())).max().item()
            for g, w in zip(got, plain)]
    return {"kernels": errs(got), "plain_f32": errs(plain),
            "tolerance_used": used, "outputs": ["o", "lse"]}


def flash_bwd_checks(say, seed: int, device="cuda"):
    """#2 and #3 against the plain backward in f32 and bf16 at the four
    BWD_SHAPES (masked keys' dk/dv exactly 0); at the LM shape also each
    kernel's time, the plain version's, the SDPA backward's and the
    bounds. The forward (#1) is held against its plain version at the
    same shapes and timed at the LM's. Returns #1's results at these
    shapes and the two backward kernels' JSON entries (bf16 numbers
    first: the training paths run bf16)."""
    import numpy as np
    import torch
    from paddle_tpu_torch.ops import cuda_kernels as ck
    rs = np.random.RandomState(seed + 5)
    gen = torch.Generator().manual_seed(seed + 6)
    entries = {name: {"name": name, "route": "cuda",
                      "source": "paddle_tpu_torch/csrc/flash_bwd.cu",
                      "replaces": rep, "replaces_kernel": body,
                      "design": DESIGN[name]}
               for name, rep, body in FLASH_BWD_KERNELS}
    fwd = {}
    for tag, B, T, S, H, causal, kind, fused in BWD_SHAPES:
        lens = _bwd_lens(kind, B, S, rs)
        for dt, dname in ((torch.float32, "float32"),
                          (torch.bfloat16, "bfloat16")):
            args, kv = _bwd_inputs(B, T, S, H, causal, lens, fused, dt, gen,
                                   device)
            if fused:
                check(not args[0].is_contiguous()
                      and args[0].stride(1) == 3 * H * HEAD_DIM,
                      "q is not the strided view the model passes")
            o, lse = ck.flash_attention_fwd(*args[:3], causal=causal,
                                            kv_lens=kv)
            close = (bf16_tc_close if dt == torch.bfloat16
                     else lambda g, w, what: bwd_close(g, w, what, dname))
            if dt == torch.bfloat16:
                fwd_res = {"max_abs_err": close(o, args[3],
                                                f"flash fwd {tag}")}
            else:
                fwd_res = {"max_abs_err": fwd_f32_close(o, args[3],
                                                        f"flash fwd {tag}")}
                fwd_res["max_abs_err_f64"] = fwd_f64_errors(
                    (o, lse), args[3:5], args[:3], causal, kv)
                again = ck.flash_attention_fwd(*args[:3], causal=causal,
                                               kv_lens=kv)
                check(torch.equal(again[0], o) and torch.equal(again[1], lse),
                      f"flash fwd {tag} float32: two runs differ")
            check(torch.allclose(lse, args[4], atol=F32_ATOL, rtol=F32_RTOL),
                  f"flash fwd {tag} {dname} lse differs from plain")
            if tag == "lm":
                fwd_res.update(_fwd_times(B, T, H, dt, dname, gen, device))
            say(f"flash_attention_fwd {tag} {dname}: {json.dumps(fwd_res)}")
            fwd[f"{tag}_{dname}"] = fwd_res
            got = ck.flash_attention_bwd(*args, causal=causal, kv_lens=kv)
            want = ck.flash_attention_bwd(*args, causal=causal, kv_lens=kv,
                                          route="plain")
            torch.cuda.synchronize()
            errs = [close(g, w, f"flash bwd {tag} {nm}")
                    for nm, g, w in zip(("dq", "dk", "dv"), got, want)]
            f64 = None
            if dt == torch.float32:
                ref = bwd_f64(args, causal, kv)
                f64 = {"kernels": f64_errors(got, ref),
                       "plain_f32": f64_errors(want, ref),
                       "tolerance_used": [tolerance_used(g, w)
                                          for g, w in zip(got, want)]}
                del ref
                # bit-equal across two runs
                again = ck.flash_attention_bwd(*args, causal=causal,
                                               kv_lens=kv)
                check(all(torch.equal(a, b) for a, b in zip(got, again)),
                      f"flash bwd {tag} float32: two runs differ")
            if lens is not None:
                for b, n in enumerate(np.clip(lens, 1, S)):
                    check(not got[1][b, n:].any() and not got[2][b, n:].any(),
                          f"flash bwd {tag}: masked keys of sample {b} have "
                          "nonzero dk/dv")
            res = {"flash_attention_bwd_dq": {"max_abs_err": errs[0]},
                   "flash_attention_bwd_dkv": {"max_abs_err": max(errs[1:])}}
            if f64 is not None:       # dq; dk, dv against float64
                res["flash_attention_bwd_dq"]["max_abs_err_f64"] = {
                    who: e[0] for who, e in f64.items()}
                res["flash_attention_bwd_dkv"]["max_abs_err_f64"] = {
                    who: e[1:] for who, e in f64.items()}
            if tag == "lm":
                for name, r in _bwd_times(B, T, S, H, causal, lens, dt, dname,
                                          gen, device).items():
                    res[name].update(r)
            say(f"flash_attention_bwd {tag} B={B} T={T} S={S} H={H} "
                f"{'causal' if causal else 'non-causal'} {dname}: "
                f"{json.dumps(res)}")
            for name, r in res.items():
                e = entries[name]
                if tag == "lm" and dt == torch.bfloat16:
                    e.update(r)
                    e["dtype"] = dname
                    e["shape"] = (f"B={B} T=S={T} H={H} D={HEAD_DIM} causal "
                                  "(the LM's)")
                else:
                    e[f"{tag}_{dname}"] = r
    return fwd, [entries[name] for name, _, _ in FLASH_BWD_KERNELS]


def _fwd_times(B, T, H, dt, dname, gen, device, D=HEAD_DIM):
    """#1 at the LM's training shape (causal, S = T): its time, the plain
    version's, SDPA's and the bound, as phase 2 takes them."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import cuda_kernels as ck
    esize = torch.empty((), dtype=dt).element_size()
    sets = input_sets(lambda i: _qkv_views(B, T, H, D, dt, gen, device),
                      3 * B * T * H * D * esize)
    ms = time_ms([lambda s=s: ck.flash_attention_fwd(*s, causal=True)
                  for s in sets])
    plain_ms = time_ms([lambda s=s: ck.flash_attention_fwd(
        *s, causal=True, route="plain") for s in sets], rounds=1, reps=2)
    lib_ms = time_ms([lambda s=s: F.scaled_dot_product_attention(
        *(t.transpose(1, 2) for t in s), is_causal=True) for s in sets])
    del sets
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            **tensor_core_bound(
                4.0 * D * H * live_pairs(T, T, True, None, B),
                4 * B * T * H * D * esize + B * T * H * 4, dname)}


def _bwd_times(B, T, S, H, causal, lens, dt, dname, gen, device,
               D=HEAD_DIM):
    """Each kernel's time (CUDA graph over input sets larger than L2), the
    plain backward's and the SDPA backward's (both compute dq, dk and dv:
    they stand against the pair), and each kernel's bound: its products
    over the live pairs (6*D operations a pair for dq, 8*D for dk/dv)
    against each input read and each output written once."""
    import torch
    from paddle_tpu_torch.ops import cuda_kernels as ck
    esize = torch.empty((), dtype=dt).element_size()
    q_el, k_el, row = B * T * H * D, B * S * H * D, B * T * H * 4
    sets = input_sets(lambda i: _bwd_inputs(B, T, S, H, causal, lens, False,
                                            dt, gen, device, D=D)[0],
                      (3 * q_el + 2 * k_el) * esize)
    runs = [ck.FlashBwdLaunch(*s, causal, D ** -0.5, None, None)
            for s in sets]
    for r in runs:
        r.dq()                         # delta for the dk/dv timing
    dq_ms = time_ms([r.dq for r in runs])
    dkv_ms = time_ms([r.dkv for r in runs])
    del runs
    plain_ms = time_ms([lambda s=s: ck.flash_attention_bwd(
        *s, causal=causal, route="plain") for s in sets], rounds=1, reps=2)
    lib_ms = sdpa_bwd_ms(sets, causal)
    del sets
    pairs = live_pairs(T, S, causal, lens, B) * H
    dq_bytes = (4 * q_el + 2 * k_el) * esize + 2 * row   # + delta written
    dkv_bytes = (2 * q_el + 4 * k_el) * esize + 2 * row
    note = "the whole backward (dq, dk, dv): stands against the pair"
    out = {}
    for name, ms, flops, nbytes in (
            ("flash_attention_bwd_dq", dq_ms, 6.0 * D * pairs, dq_bytes),
            ("flash_attention_bwd_dkv", dkv_ms, 8.0 * D * pairs, dkv_bytes)):
        out[name] = {"ms": ms, "plain_ms": plain_ms,
                     **tensor_core_bound(flops, nbytes, dname),
                     "library_ms": lib_ms,
                     "pair_ms": dq_ms + dkv_ms, "live_pairs": pairs,
                     "plain_note": "the plain backward: " + note,
                     "library_note": "F.scaled_dot_product_attention "
                                     "backward through autograd, eager, "
                                     "CUDA events; " + note}
    return out


def sdpa_bwd_ms(sets, causal: bool, reps: int = 5) -> float:
    """Mean time of the backward of ``F.scaled_dot_product_attention`` over
    the input sets (in its [B, H, T, D] layout), replayed eagerly from one
    retained autograd graph per set and timed with CUDA events."""
    import torch
    import torch.nn.functional as F
    calls = []
    for q, k, v, o, lse, do in sets:
        ins = [t.detach().transpose(1, 2).contiguous().requires_grad_()
               for t in (q, k, v)]
        out = F.scaled_dot_product_attention(*ins, is_causal=causal)
        g = do.transpose(1, 2).contiguous()
        calls.append(lambda out=out, ins=ins, g=g: torch.autograd.grad(
            out, ins, g, retain_graph=True))
    for c in calls:
        c()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        for c in calls:
            c()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * len(calls))


# ---------------------------------------------------------------------------
# phases 7 and 8: training GPT-2 small and the transformer NMT
# ---------------------------------------------------------------------------

# benchmarks/transformer_lm.py:19-25: GPT-2 small with vocab 32768, batch 8
# of 1024 tokens, 2 batches (NBUF), Adam 3e-4, bf16 over f32 master weights
GPT2_TRAIN = dict(vocab=32768, d_model=768, n_heads=12, n_layers=12,
                  d_ff=3072, max_len=1024)
LM_BATCH, LM_SEQ, LM_NBUF, LM_PASSES, LM_LR = 8, 1024, 2, 6, 3e-4
# benchmarks/transformer_nmt.py:22-27: d512, 8 heads, 6+6 layers, vocab
# 30000/30000, length 64 with lengths 32..64, batch 64, 4 batches, Adam
# 1e-3, bf16 over f32 master weights
NMT_TRAIN = dict(src_vocab=30000, trg_vocab=30000, d_model=512, n_heads=8,
                 n_enc=6, n_dec=6, max_len=64)
NMT_BATCH, NMT_SEQ, NMT_MIN_LEN, NMT_NBUF, NMT_PASSES, NMT_LR = \
    64, 64, 32, 4, 3, 1e-3
ATTENTION_KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dq",
                     "flash_attention_bwd_dkv")


def lm_loss(model, dtype, route=None):
    def loss_fn(params, ids):
        return model.call(cast_tree(params, dtype), ids, method="loss",
                          route=route).float()
    return loss_fn


def nmt_loss(model, dtype, route=None):
    from paddle_tpu_torch.core import SeqBatch

    def loss_fn(params, src, slen, tin, tout, tlen):
        return model.call(cast_tree(params, dtype), SeqBatch(src, slen),
                          SeqBatch(tin, tlen), SeqBatch(tout, tlen),
                          method="loss", route=route).float()
    return loss_fn


def transformer_step_check(say, what, loss_for_route, params, batch, lr,
                           per_step, device, names=ATTENTION_KERNELS,
                           floor=0.0, row_scale=False):
    """One f32 Adam step through the kernels against the same step with the
    plain versions, on the card. Tolerances: the loss to rtol 1e-6; each
    gradient (read as Adam's first moment m = 0.1 g) to 1e-4 of its L2
    norm (an entry is a sum of many terms whose size, not the entry's,
    sets its rounding); the parameters to 1e-5 plus what the first Adam
    step lr*g/(|g|+eps) makes of a gradient difference of 1e-4 of the
    entry and of the tensor's rms (where g is rounding noise, as for the
    key bias whose gradient is zero analytically, the step divides it by
    eps). ``floor`` > 0 adds ``floor`` times the step's largest gradient
    norm to each gradient's allowance, for a gradient that sits at the
    step's rounding floor (a relative check of rounding noise fails
    however right the kernels are). ``row_scale``: the rms of each
    parameter's gradient is taken a row at a time where that is larger
    (a tied embedding's rows of the batch's tokens sum terms orders of
    magnitude larger than the other rows, whose tiny gradients set the
    tensor's rms; an entry of such a row rounds with its row). Each kernel
    of ``names`` (the attention kernels by default) launches ``per_step``
    times on the kernel route and never on the plain one."""
    import torch
    from paddle_tpu_torch.core.pytree import tree_get, tree_items
    from paddle_tpu_torch.ops import cuda_kernels as ck
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.trainer import Trainer
    res = {}
    for route in (None, "plain"):
        tr = Trainer(loss_for_route(route), Adam(lr), device=device)
        before = dict(ck.LAUNCHES)
        res[route] = tr.step(params, tr.opt.init(params), *batch)
        torch.cuda.synchronize()
        launched = {n: ck.LAUNCHES[n] - before[n] for n in names}
        want = {n: per_step if route is None else 0 for n in names}
        check(launched == want, f"{what} f32 step, route {route}: launches "
              f"{launched} != {want}")
    (pk, sk, lk), (pp, sp, lp) = res[None], res["plain"]
    check(abs(lk.item() - lp.item()) <= 1e-6 * abs(lp.item()),
          f"{what} f32 loss {lk.item()} != plain {lp.item()}")
    worst_g, worst_p, eps = 0.0, 0.0, 1e-8
    norm = torch.linalg.vector_norm
    g_max = max(norm(tree_get(sp["slots"], path)["m"]).item()
                for path, _ in tree_items(pp))
    at_floor = []
    for path, b in tree_items(pp):
        name = "/".join(path)
        mk = tree_get(sk["slots"], path)["m"]
        mp = tree_get(sp["slots"], path)["m"]
        err, ref = norm(mk - mp).item(), norm(mp).item()
        rel = err / max(ref, 1e-30)
        check(err <= 1e-4 * ref + floor * g_max, f"{what} f32 step: "
              f"gradient {name} differs from plain: relative L2 {rel}")
        if err > 1e-4 * ref:
            at_floor.append(f"{name} (norm {ref:.3e}, difference "
                            f"{err:.3e})")
            rel = 0.0       # held to the floor, not relatively
        g = mp.abs() / 0.1
        rms = g.square().mean().sqrt()
        if row_scale and g.dim() > 1:
            rms = torch.maximum(rms, g.square().mean(-1, keepdim=True)
                                .sqrt())
        dg = 1e-4 * (g + rms)
        allowed = 1e-5 + lr * dg * eps / (g + eps) ** 2
        diff = (tree_get(pk, path) - b).abs()
        check(bool((diff <= allowed).all()), f"{what} f32 step: param {name} "
              f"differs from plain by {diff.max().item()}")
        worst_g, worst_p = max(worst_g, rel), max(worst_p,
                                                  diff.max().item())
    say(f"{what} f32 training step, kernels vs plain on the card: loss "
        f"{lk.item():.6f} vs {lp.item():.6f}; worst gradient relative L2 "
        f"{worst_g:.3e}" + (f" (held to {floor:g} x the largest gradient "
                            f"norm {g_max:.3e}: {', '.join(at_floor)})"
                            if at_floor else "")
        + f"; worst parameter difference {worst_p:.3e}")


def f32_step_profile(say, what, loss, params, batch, lr, device,
                     share_of) -> None:
    """The device time of one f32 training step through the kernels (the
    f32 step check's step) and ``share_of``'s share of it, from
    profile_breakdown; the wall is the faster of two unprofiled steps (the
    step's graph replayed)."""
    import torch
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.trainer import Trainer
    tr = Trainer(loss, Adam(lr), device=device)
    trees = [params, tr.opt.init(params)]

    def run():          # the step's own trees passed back: nothing copied in
        trees[0], trees[1], _ = tr.step(*trees, *batch)
    walls = []
    for _ in range(3):                 # a warm-up, then two timed
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    profile_breakdown(say, f"f32 {what} step", run, min(walls[1:]),
                      share_of=share_of)


def bf16_step_check(say, what, loss_for, params, batch, per_step,
                    names=ATTENTION_KERNELS):
    """The loss and gradients of one bf16 training step (bf16 compute over
    f32 masters, the training recipe) through the kernels against the same
    on the plain route, on the card: this catches a layout fault of the
    tensor-core bodies that the shape checks could miss.
    ``loss_for(dtype, route)`` builds the loss.

    The two routes differ by the bodies' bf16 rounding of P and dS^T and
    by summation order, and every later bf16 op rounds those differences
    to whole ulps, so they compound through the 12 layers. Tolerances: the
    f32 loss to rtol 2**-9 (half a bf16 ulp); each gradient to a relative
    L2 of 2**-5 (four bf16 ulps). For scale, the plain bf16 route's own
    worst distance from the f32 plain route is printed beside it."""
    import torch
    from paddle_tpu_torch.core.pytree import tree_items, tree_map
    from paddle_tpu_torch.ops import cuda_kernels as ck
    norm = torch.linalg.vector_norm
    res = {}
    for dtype, route in ((torch.bfloat16, None), (torch.bfloat16, "plain"),
                         (torch.float32, "plain")):
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
        before = dict(ck.LAUNCHES)
        loss = loss_for(dtype, route)(leaves, *batch)
        grads = torch.autograd.grad(loss, [v for _, v in tree_items(leaves)])
        torch.cuda.synchronize()
        launched = {n: ck.LAUNCHES[n] - before[n] for n in names}
        want = {n: per_step if route is None else 0 for n in names}
        check(launched == want, f"{what} bf16 step check, route {route}: "
              f"launches {launched} != {want}")
        res[(dtype, route)] = (loss.item(), [g.float() for g in grads])
        del leaves, loss, grads
    (lk, gk), (lp, gp), (l32, g32) = res.values()
    check(abs(lk - lp) <= BF16_STEP_LOSS_RTOL * abs(lp),
          f"{what} bf16 loss {lk} through the kernels != plain {lp}")
    worst, worst_name, bf16_floor = 0.0, "", 0.0
    for (path, _), a, b, c in zip(tree_items(params), gk, gp, g32):
        name = "/".join(path)
        err, ref = norm(a - b).item(), norm(b).item()
        rel = err / max(ref, 1e-30)
        check(rel <= BF16_STEP_GRAD_REL_L2, f"{what} bf16 step: gradient "
              f"{name} through the kernels differs from plain: relative L2 "
              f"{rel}")
        bf16_floor = max(bf16_floor, norm(b - c).item() / norm(c).item())
        if rel > worst:
            worst, worst_name = rel, name
    say(f"{what} bf16 step, kernels vs plain on the card: loss {lk:.6f} vs "
        f"{lp:.6f} (f32 plain {l32:.6f}); worst gradient relative L2 "
        f"{worst:.3e} ({worst_name}); the plain bf16 route's own worst "
        f"distance from f32 {bf16_floor:.3e}")
    return {"loss": lk, "loss_plain": lp, "worst_grad_rel_l2": worst,
            "bf16_vs_f32_worst_rel_l2": bf16_floor}


def graph_step_check(say, what, loss, params, batch, lr, device,
                     make_opt=None, expect_launches=True, reseed=None):
    """One f32 Adam step (``make_opt()``'s optimizer, if given) replayed
    through the trainer's graph against the same step on the eager route,
    from copies of the same params and a fresh state: the loss and every
    parameter bit-equal, or, where a GEMM's bits differ under capture,
    within GRAPH_STEP_LOSS_RTOL and GRAPH_STEP_PARAM_ATOL; the same kernel
    launches on both routes, some with ``expect_launches`` and none
    without it (a path with no kernel of the port's: the image path), and
    the graphed step one replay. ``reseed()``, if given, runs before each
    step: a loss that draws from a generator in the batch then draws the
    same numbers on both routes."""
    import torch
    from paddle_tpu_torch.core.pytree import tree_items, tree_map
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.trainer import Trainer
    make_opt = make_opt or (lambda: Adam(lr))
    res = {}
    for route in ("eager", "graphed"):
        tr = Trainer(loss, make_opt(), device=device)
        reseed = reseed or (lambda: None)
        with _route(route):
            if route == "graphed":              # the capture
                p = tree_map(torch.clone, params)
                reseed()
                tr.step(p, tr.opt.init(p), *batch)
            p = tree_map(torch.clone, params)
            state = tr.opt.init(p)
            reseed()
            (new, _, cost), _, launches, disp = counted(
                lambda: tr.step(p, state, *batch))
        res[route] = (tree_map(torch.clone, new), cost.item(), launches,
                      step_dispatches(disp, "step"))
        del tr, p, state, new
    (pe, le, ne, de), (pg, lg, ng, dg) = res["eager"], res["graphed"]
    check(de == {"captures": 0, "replays": 0}
          and dg == {"captures": 0, "replays": 1},
          f"{what} graph step: dispatches eager {de}, graphed {dg}")
    check(ne == ng and bool(ne) == expect_launches,
          f"{what} graph step: launches eager {ne}, graphed {ng} (expected "
          f"{'some' if expect_launches else 'none'})")
    worst, equal = 0.0, le == lg
    for (path, a), (_, b) in zip(tree_items(pe), tree_items(pg)):
        equal = equal and torch.equal(a, b)
        worst = max(worst, (a - b).abs().max().item())
    check(abs(le - lg) <= GRAPH_STEP_LOSS_RTOL * abs(le)
          and worst <= GRAPH_STEP_PARAM_ATOL,
          f"{what} graph step: loss {lg!r} vs eager {le!r}, worst parameter "
          f"difference {worst!r}")
    say(f"{what} f32 step through its graph against the eager step: "
        f"{'bit-equal' if equal else 'not bit-equal'}; loss {lg!r} vs "
        f"{le!r}; worst parameter difference {worst!r}; launches {ng}")


def train_and_time(say, what, make_trainer, params, batches, passes,
                   per_step, device, warmup=2, names=ATTENTION_KERNELS,
                   share_of=None, held=None, probe=None, falls=True):
    """``Trainer.train`` over ``batches`` for ``passes`` passes on the
    eager route and through the graphs, each from a copy of ``params``
    with a fresh trainer (``make_trainer()``), the launch and dispatch
    counts set to 0 just before and read just after; checks the counts
    (``per_step`` of each kernel of ``names`` a step, the same on both
    routes, and through the graphs one capture of the one batch signature
    and a replay every later step), finite costs and a falling loss on
    batch 0; prints ms per step and a profile of two warm steps. With
    ``held`` also ``Trainer.test`` over it (one replay a batch). Returns
    the graphed route's counts (the held test's included) and the number
    of steps. ``probe`` is the batch list the falling loss is read on
    (default: batch 0 as it is; a dropout model's without its
    generator); ``falls=False`` prints the probe's costs without holding
    them (ResNet-50's recipe: its caller checks a repeated batch)."""
    import numpy as np
    import torch
    from paddle_tpu_torch.core.pytree import tree_map
    from paddle_tpu_torch.trainer import event
    steps = passes * len(batches)
    figs, costs_by = {}, {}
    for route in ("eager", "graphed"):
        trainer = make_trainer()
        params0 = tree_map(torch.clone, params)
        stamps, costs = [], []

        def on_event(e):
            if isinstance(e, event.EndIteration):
                stamps.append(time.perf_counter())
                costs.append(e.cost)

        with _route(route):
            before = trainer.test(lambda: probe or batches[:1],
                                  params0)["cost"]
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            (p, state), _, launches, disp = counted(
                lambda: trainer.train(lambda: batches, params0,
                                      num_passes=passes,
                                      event_handler=on_event))
            if held is not None:
                test, _, test_launches, test_disp = counted(
                    lambda: trainer.test(lambda: held, p))
                say(f"{what} ({route}): held-out test cost "
                    f"{test['cost']}, launches {test_launches}")
                check(np.isfinite(test["cost"]), f"{what}: a non-finite "
                      "test cost")
                check(step_dispatches(test_disp, "loss")["replays"]
                      == (len(held) if route == "graphed" else 0),
                      f"{what} ({route}): test dispatches {test_disp}")
                if route == "graphed":
                    for k, n in test_launches.items():
                        launches[k] = launches.get(k, 0) + n
            after = trainer.test(lambda: probe or batches[:1], p)["cost"]
            say(f"{what} training ({route}): {steps} steps, costs "
                f"{json.dumps(costs)}; batch 0 cost before {before} after "
                f"{after}; launches {launches}")
            check(len(costs) == steps and int(state["step"]) == steps,
                  f"{what}: {len(costs)} steps ran, want {steps}")
            check(all(np.isfinite(costs)), f"{what}: a non-finite cost")
            check(after < before or not falls,
                  f"{what} ({route}): batch 0 cost did not "
                  f"fall: {before} -> {after}")
            for n in names:
                check(launches.get(n, 0) == per_step * steps,
                      f"{what}: {n} launched {launches.get(n, 0)} times, "
                      f"want {per_step} x {steps} steps")
            step_ms = np.diff([t0] + stamps)[warmup:] * 1e3
            fig = {"steps_timed": len(step_ms),
                   "ms_per_step_median": float(np.median(step_ms)),
                   "ms_per_step_p10": float(np.percentile(step_ms, 10)),
                   "ms_per_step_p90": float(np.percentile(step_ms, 90)),
                   "ms_per_step_min": float(step_ms.min()),
                   "ms_per_step_max": float(step_ms.max()),
                   "peak_mem_gib": torch.cuda.max_memory_allocated()
                   / 2 ** 30,
                   "launches_per_step": {n: launches[n] / steps
                                         for n in names}}
            say(f"{what} training smoke figures ({route}; not a benchmark):"
                f" {json.dumps(fig)}")
            run = lambda: trainer.train(lambda: batches[:2], p)
            walls = []
            for _ in range(2):   # the faster of two: the host's load varies
                t1 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t1)
            prof = profile_breakdown(say, f"bf16 {what} training (2 steps, "
                                     f"{route})", run, min(walls), steps=2,
                                     share_of=share_of)
            if route == "graphed":
                graph_launch_check(say, f"{what} training")
        train_launches = {k: v for k, v in launches.items()
                          if held is None or k in names}
        figs[route] = {"steps": steps,
                       "wall_ms_per_step": fig["ms_per_step_median"],
                       "launches_per_step": {k: v / steps for k, v in
                                             train_launches.items()},
                       "graph_dispatches": disp, "profile": prof,
                       "launches": launches}
        costs_by[route] = costs
        del trainer, params0, p, state
    eager, graphed = figs["eager"], figs["graphed"]
    check(eager["launches_per_step"] == graphed["launches_per_step"],
          f"{what}: kernel launches a step eager {eager['launches_per_step']}"
          f" != graphed {graphed['launches_per_step']}")
    mine = step_dispatches(graphed["graph_dispatches"], "step")
    check(mine == {"captures": 1, "replays": steps - 1},
          f"{what}: step graphs {mine} in {steps} steps, want one capture "
          "and a replay a step after it")
    diff = max(abs(a - b) for a, b in zip(costs_by["eager"],
                                          costs_by["graphed"]))
    say(f"{what} training: graphed costs against eager, max difference "
        f"{diff!r} ({'bit-equal' if diff == 0.0 else 'not bit-equal'})")
    record_pair(say, f"{what} training", "step", figs)
    return graphed["launches"], steps


def lm_training_phase(say, seed: int, device="cuda", config=GPT2_TRAIN,
                      batch=LM_BATCH, seq=LM_SEQ, passes=LM_PASSES):
    """GPT-2 small trained by ``Trainer.train`` (bf16 over f32 masters,
    Adam) over the benchmark's 2 batches of random token ids, on the eager
    route and through the graphs; before that, one f32 step against the
    plain route's and one through its graph against the eager step."""
    import numpy as np
    import torch
    from paddle_tpu_torch.models import TransformerLM
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.trainer import Trainer
    model = TransformerLM(**config).init(seed=seed, device=device)
    rs = np.random.RandomState(seed)
    batches = [(torch.as_tensor(rs.randint(0, config["vocab"], (batch, seq))
                                .astype(np.int32), device=device),)
               for _ in range(LM_NBUF)]
    per_step = config["n_layers"]
    transformer_step_check(say, "LM", lambda r: lm_loss(model, torch.float32,
                                                         r),
                           model.tree(), batches[0], LM_LR, per_step, device)
    f32_step_profile(say, "LM", lm_loss(model, torch.float32), model.tree(),
                     batches[0], LM_LR, device,
                     {"the f32 backward pair #2 + #3":
                      ("flash_bwd_dq", "flash_bwd_dkv")})
    bf16_step_check(say, "LM", lambda dt, r: lm_loss(model, dt, r),
                    model.tree(), batches[0], per_step)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    graph_step_check(say, "LM", lm_loss(model, torch.float32), model.tree(),
                     batches[0], LM_LR, device)
    torch.cuda.empty_cache()
    return train_and_time(say, "LM", lambda: Trainer(
        lm_loss(model, torch.bfloat16), Adam(LM_LR), device=device),
        model.tree(), batches, passes, per_step, device,
        share_of={"#2 (dq)": "flash_bwd_dq"})


def nmt_batches(seed: int, n: int, device, batch=NMT_BATCH, seq=NMT_SEQ,
                vocab=NMT_TRAIN["src_vocab"], min_len=NMT_MIN_LEN):
    """``n`` batches (src, src_lens, trg_in, trg_out, trg_lens) as the
    NMT benchmarks draw them: ids in 3..vocab, lengths in min_len..seq
    (32..64 for the transformer NMT, 16..32 for the seq2seq)."""
    import numpy as np
    import torch
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ids = [rs.randint(3, vocab, (batch, seq)) for _ in range(3)]
        lens = [rs.randint(min_len, seq + 1, batch) for _ in range(2)]
        src, tin, tout = ids
        out.append(tuple(torch.as_tensor(a.astype(np.int32), device=device)
                         for a in (src, lens[0], tin, tout, lens[1])))
    return out


def nmt_training_phase(say, seed: int, device="cuda", config=NMT_TRAIN,
                       passes=NMT_PASSES):
    """The transformer NMT trained by ``Trainer.train`` (bf16 over f32
    masters, Adam) over the benchmark's 4 batches; before that, one f32
    step against the plain route's."""
    import torch
    from paddle_tpu_torch.models import TransformerSeq2Seq
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.trainer import Trainer
    model = TransformerSeq2Seq(**config).init(seed=seed, device=device)
    batches = nmt_batches(seed, NMT_NBUF, device)
    # encoder self-, decoder self- and cross-attention in every layer pair
    per_step = config["n_enc"] + 2 * config["n_dec"]
    transformer_step_check(say, "NMT", lambda r: nmt_loss(model,
                                                          torch.float32, r),
                           model.tree(), batches[0], NMT_LR, per_step,
                           device)
    graph_step_check(say, "NMT", nmt_loss(model, torch.float32),
                     model.tree(), batches[0], NMT_LR, device)
    torch.cuda.empty_cache()
    return train_and_time(say, "NMT", lambda: Trainer(
        nmt_loss(model, torch.bfloat16), Adam(NMT_LR), device=device),
        model.tree(), batches, passes, per_step, device)


# ---------------------------------------------------------------------------
# phase 9: the decode kernels against their plain versions
# ---------------------------------------------------------------------------

DECODE_KERNELS = (
    ("decode_attention", "paddle_tpu_torch/csrc/decode.cu",
     "paddle_tpu/ops/pallas_kernels.py:561", "_decode_attn_kernel"),
    ("decode_attention_q", "paddle_tpu_torch/csrc/decode.cu",
     "paddle_tpu/ops/pallas_kernels.py:571", "_decode_attn_q_kernel"),
    ("paged_decode_attention_q", PAGED_SOURCES["source"],
     "paddle_tpu/ops/pallas_kernels.py:727", "_paged_attn_q_kernel"),
)
# GPT-2 small's decode reads: B=8 slots, 12 heads of 64, a max_len-1024
# cache read through [:, :L] at the bucketed bounds 256/512/1024 (#4, #5)
# and 4/8/16 pages of 64 rows (#7)
DECODE_B, DECODE_H, DECODE_MAX = 8, 12, 1024
DECODE_READS, PAGED_READS, PAGE_ROWS = (256, 512, 1024), (4, 8, 16), 64
# (query dtype, cache): #4 reads a cache of the query's dtype, #5 an int8
# cache under either query dtype
DECODE_CASES = (("float32", "float32"), ("bfloat16", "bfloat16"),
                ("float32", "int8"), ("bfloat16", "int8"))


def _decode_query(B, H, D, dtype, gen, device):
    """q as decode_step hands it over: ``q[:, 0]`` of the [B, 1, H, D]
    view of one fused [B, 1, 3*H*D] projection."""
    import torch
    qkv = torch.randn((B, 1, 3 * H * D), generator=gen, device=gen.device)
    return qkv.to(device, dtype).chunk(3, dim=-1)[0].unflatten(
        -1, (H, D))[:, 0]


def _dense_decode_inputs(L, qname, kind, gen, device, full: bool,
                         B=DECODE_B):
    """(q, k[:, :L], v[:, :L], pos) over a [B, 1024, 12, 64] cache and the
    scales' [:, :L] views (None unless int8). pos: L - 1 everywhere for a
    full read, else spread over [0, L) with 0, L - 1 and a drained slot
    past the read bound."""
    import torch
    from paddle_tpu_torch.ops import cuda_kernels as ck
    H, D = DECODE_H, HEAD_DIM
    q = _decode_query(B, H, D, getattr(torch, qname), gen, device)
    k, v = (torch.randn((B, DECODE_MAX, H, D), generator=gen, device=device)
            for _ in range(2))
    if kind == "int8":
        (k, ks), (v, vs) = ck.quantize_kv(k), ck.quantize_kv(v)
        scales = (ks[:, :L], vs[:, :L])
    else:
        k, v = k.to(q.dtype), v.to(q.dtype)
        scales = (None, None)
    if full:
        pos = torch.full((B,), L - 1, dtype=torch.int32)
    else:
        pos = torch.linspace(0, L - 1, B).round().to(torch.int32)
        pos[-1] = L + 37
    return (q, k[:, :L], v[:, :L], pos.to(device)), scales


def _paged_set(NB, qname, kind, gen, device, full: bool, B=DECODE_B):
    """Phase 2's pools (a null page 0, tables with null tails unless
    ``full``) of ``NB`` pages of 64 rows in ``kind``: the query's dtype
    (#6), or int8 quantized from f32 pools with their scale pools (#7)
    under a query of ``qname``. As :func:`paged_read` takes them."""
    import torch
    from paddle_tpu_torch.ops import cuda_kernels as ck
    H, D = DECODE_H, HEAD_DIM
    if kind != "int8":
        return _paged_inputs(B, H, D, PAGE_ROWS, NB, getattr(torch, kind),
                             gen, device, full), (None, None)
    _, kp, vp, tables, pos = _paged_inputs(B, H, D, PAGE_ROWS, NB,
                                           torch.float32, gen, device, full)
    (kp, ks), (vp, vs) = ck.quantize_kv(kp), ck.quantize_kv(vp)
    q = _decode_query(B, H, D, getattr(torch, qname), gen, device)
    return (q, kp, vp, tables, pos), (ks, vs)


def decode_bound(rows: int, q_size: int, kv_size: int, int8: bool,
                 tables: int = 0, B: int = DECODE_B):
    """The byte bound of one read of ``rows`` live rows a sample (each
    input read once, the f32 output written once) against its operations
    (a dot product and an axpy per element, in f32)."""
    H, D = DECODE_H, HEAD_DIM
    nbytes = (B * H * D * q_size + 2 * B * rows * H * D * kv_size
              + (2 * B * rows * H * 4 if int8 else 0) + B * 4 + tables * 4
              + B * H * D * 4)
    return bound(4.0 * B * rows * H * D, nbytes, "float32")


def _decode_times(run, make, nbytes, sdpa: bool):
    """Kernel and plain times over input sets larger than L2 (CUDA graph,
    as phase 2), and SDPA with a boolean mask [B, 1, 1, L] over the same
    cache views when ``sdpa``."""
    import torch
    import torch.nn.functional as F
    sets = input_sets(make, nbytes)
    out = {"ms": time_ms([lambda s=s: run(s) for s in sets]),
           "plain_ms": time_ms([lambda s=s: run(s, route="plain")
                                for s in sets], rounds=1)}
    if sdpa:
        calls = []
        for (q, k, v, pos), _ in sets:
            live = (torch.arange(k.shape[1], device=pos.device)[None, :]
                    <= pos[:, None])[:, None, None, :]
            calls.append(lambda q=q, k=k, v=v, m=live:
                         F.scaled_dot_product_attention(
                             q[:, :, None], k.transpose(1, 2),
                             v.transpose(1, 2), attn_mask=m))
        out["library_ms"] = time_ms(calls)
    del sets
    return out


def decode_checks(say, seed: int, sweep_batches, device="cuda", parent=None,
                  paged_entry=None):
    """#4 and #5 over [:, :L] cache views and #7 over int8 pools against
    their plain versions, f32 and bf16 queries; each timed at its full
    read (#7 beside its per-row table lookup and the ``parent`` library's
    one-block body). Then the split edge checks, #6 and #7 bit-equal to
    #4 and #5 over their gathered pages, and the split sweep, whose #6
    part goes into phase 2's ``paged_entry``. Returns the three kernels'
    JSON entries (the f32 query at the shortest read first: the main
    path's f32 decode at a 256-row bucket)."""
    import torch
    from paddle_tpu_torch.ops import cuda_kernels as ck
    gen = torch.Generator(device=device).manual_seed(seed + 9)
    cpu_gen = torch.Generator().manual_seed(seed + 10)
    entries = {name: {"name": name, "route": "cuda", "source": src,
                      "replaces": rep, "replaces_kernel": body,
                      "library_ms": None}
               for name, src, rep, body in DECODE_KERNELS}
    entries["decode_attention_q"]["library_note"] = \
        entries["paged_decode_attention_q"]["library_note"] = \
        "no single PyTorch call reads an int8 cache with per-row scales"
    for name in entries:
        entries[name]["design"] = SPLIT_DESIGN
    entries["paged_decode_attention_q"].update(
        body=PAGED_SOURCES["body"], table=PAGED_TABLE)

    def dense(s, route=None):
        return ck.decode_attention(*s[0], k_scale=s[1][0], v_scale=s[1][1],
                                   route=route)

    def paged(s, route=None):
        return ck.paged_decode_attention(*s[0], k_scale=s[1][0],
                                         v_scale=s[1][1], route=route)

    cases = [("decode_attention_q" if kind == "int8" else "decode_attention",
              L, qname, kind) for qname, kind in DECODE_CASES
             for L in DECODE_READS]
    cases += [("paged_decode_attention_q", NB, qname, "int8")
              for qname in ("float32", "bfloat16") for NB in PAGED_READS]
    for name, n, qname, kind in cases:
        is_paged = name.startswith("paged")
        if is_paged:
            make = lambda i, full=True: _paged_set(
                n, qname, kind, cpu_gen, device, full)
            run, rows, shape = paged, n * PAGE_ROWS, f"NB={n} bs={PAGE_ROWS}"
        else:
            make = lambda i, full=True: _dense_decode_inputs(
                n, qname, kind, gen, device, full)
            run, rows, shape = dense, n, f"L={n} of a {DECODE_MAX}-row cache"
        s = make(0, full=False)
        if not is_paged:
            check(s[0][1].stride()[:2] == (DECODE_MAX * DECODE_H * HEAD_DIM,
                                           DECODE_H * HEAD_DIM),
                  "the cache is not the [:, :L] view decode_step passes")
        got, want = run(s), run(s, route="plain")
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        check(torch.allclose(got, want, atol=F32_ATOL, rtol=F32_RTOL),
              f"{name} {shape} q {qname} differs from plain: max {err}")
        q_size = torch.empty((), dtype=getattr(torch, qname)).element_size()
        kv_size = 1 if kind == "int8" else q_size
        b_ms, b_by = decode_bound(rows, q_size, kv_size, kind == "int8",
                                  tables=DECODE_B * n if is_paged else 0)
        res = {"max_abs_err": err}
        nbytes = 2 * DECODE_B * rows * DECODE_H * (
            HEAD_DIM * kv_size + (4 if kind == "int8" else 0))
        if is_paged:
            sets = input_sets(make, nbytes)
            res.update(paged_times(sets, parent))
            del sets
        else:
            res.update(_decode_times(run, make, nbytes,
                                     sdpa=name == "decode_attention"))
        res.update(bound_ms=b_ms, bound_by=b_by)
        # the split count timed
        res["splits"], res["chunk"] = ck.decode_splits(DECODE_B * DECODE_H,
                                                       rows)
        say(f"{name} {shape} q {qname}: {json.dumps(res)}")
        e = entries[name]
        if n in (DECODE_READS[0], PAGED_READS[0]) and qname == "float32":
            e.update(res)
            e["dtype"] = f"q {qname}, {kind} cache"
            e["shape"] = (f"B={DECODE_B} H={DECODE_H} D={HEAD_DIM} {shape}, "
                          "timed with every row live")
        else:
            e[f"{'NB' if is_paged else 'L'}{n}_q{qname}"] = res
    split_edge_checks(say, gen, device)
    n_equal = paged_equals_dense_checks(say, cpu_gen, device)
    entries["paged_decode_attention_q"]["bit_equal_to_dense_reads"] = \
        n_equal
    sweep = split_sweep(say, gen, cpu_gen, sweep_batches, device)
    if paged_entry is not None:
        paged_entry["bit_equal_to_dense_reads"] = n_equal
        entries["paged_decode_attention"] = paged_entry
    for name in entries:
        entries[name]["split_sweep"] = {
            key: res for key, res in sweep.items()
            if key.startswith(name + " ")}
    return [entries[name] for name, _, _, _ in DECODE_KERNELS]


# B of the split checks and sweep: 1 (12 pairs: many splits), the
# speculative draft's 2, the decode paths' 8, and 32 (384 pairs: past the
# target, one split); each run sweeps the paths' B, --split-sweep all four
SPLIT_BATCHES = (1, 2, 8, 32)
PATH_BATCHES = (2, 8)
SWEEP_SPLITS = (1, 2, 4, 8, 16)


def _split_read(s, asked):
    """#4 or #5 (with scales) on a ``_dense_decode_inputs`` set, at the
    split count ``asked`` (None: decode_splits' choice)."""
    from paddle_tpu_torch.ops import cuda_kernels as ck
    (q, k, v, pos), (ks, vs) = s
    return ck._decode_attention_kernel(q, k, v, pos, HEAD_DIM ** -0.5, ks,
                                       vs, asked)


def _plain_read(s):
    from paddle_tpu_torch.ops import cuda_kernels as ck
    (q, k, v, pos), (ks, vs) = s
    return ck.decode_attention(q, k, v, pos, k_scale=ks, v_scale=vs,
                               route="plain")


def split_edge_checks(say, gen, device="cuda"):
    """#4 and #5 against plain, every DECODE_CASES dtype, at every L of
    DECODE_READS, with the chosen split and forced counts, on reads whose
    live rows end inside a chunk, exactly on a chunk's last row, one row
    into the next chunk, at pos = 0 (every later chunk empty) and past L
    (drained); one launch a read."""
    import torch
    from paddle_tpu_torch.ops import cuda_kernels as ck
    worst, n_reads = 0.0, 0
    for qname, kind in DECODE_CASES:
        name = "decode_attention_q" if kind == "int8" else "decode_attention"
        for B in SPLIT_BATCHES[:3]:
            for L in DECODE_READS:
                for asked in (None, 3, 8):
                    (q, k, v, _), scales = _dense_decode_inputs(
                        L, qname, kind, gen, device, True, B=B)
                    n, chunk = ck.decode_splits(B * DECODE_H, L, asked)
                    ends = [0, chunk - 1, chunk, chunk // 2, L - 1,
                            min(2 * chunk - 1, L - 1), L + 37,
                            min(chunk + chunk // 2, L - 1)]
                    for b0 in range(0, len(ends), B):
                        pos = torch.tensor((ends[b0:] + ends)[:B],
                                           dtype=torch.int32, device=device)
                        s = ((q, k, v, pos), scales)
                        before = ck.LAUNCHES[name]
                        got = _split_read(s, asked)
                        want = _plain_read(s)
                        torch.cuda.synchronize()
                        err = (got - want).abs().max().item()
                        check(ck.LAUNCHES[name] == before + 1,
                              f"{name}: not one launch a read")
                        check(torch.isfinite(got).all().item() and
                              torch.allclose(got, want, atol=F32_ATOL,
                                             rtol=F32_RTOL),
                              f"{name} split B={B} L={L} splits={n} "
                              f"chunk={chunk} pos {pos.tolist()} q {qname} "
                              f"{kind} cache differs from plain: max {err}")
                        worst, n_reads = max(worst, err), n_reads + 1
    say(f"decode_attention and decode_attention_q split reads (ends inside, "
        f"on and past chunk boundaries, pos 0, drained): {n_reads} reads "
        f"equal to plain, max abs {worst}")


def paged_equals_dense_checks(say, gen, device="cuda"):
    """#6 and #7 against #4 and #5 over ``gather_pages`` of the same pools
    at the same split count, bit for bit: every DECODE_CASES dtype, the
    paths' B, NB 4/8/16, the counts of SWEEP_SPLITS and the chosen one,
    the table carried and looked up a row at a time; pos at 0, on page
    boundaries, at NB*bs - 1 and past it. Returns the reads compared."""
    import torch
    from paddle_tpu_torch.ops import cuda_kernels as ck
    n_reads = 0
    for qname, kind in DECODE_CASES:
        for B in PATH_BATCHES:
            for NB in PAGED_READS:
                L = NB * PAGE_ROWS
                (q, kp, vp, tables, _), (ks, vs) = _paged_set(
                    NB, qname, kind, gen, device, True, B=B)
                g = lambda t: None if t is None else ck.gather_pages(
                    t, tables)
                ends = [0, L - 1, PAGE_ROWS, L + 37, PAGE_ROWS - 1,
                        L // 2 + 1, 2 * PAGE_ROWS, 1]
                for b0 in range(0, len(ends), B):
                    pos = torch.tensor((ends[b0:] + ends)[:B],
                                       dtype=torch.int32, device=device)
                    s = ((q, kp, vp, tables, pos), (ks, vs))
                    dense = ((q, g(kp), g(vp), pos), (g(ks), g(vs)))
                    for asked in SWEEP_SPLITS + (None,):
                        want = _split_read(dense, asked)
                        for carry in (True, False):
                            got = paged_read(s, asked, carry)
                            check(torch.equal(got, want),
                                  f"paged B={B} NB={NB} splits={asked} "
                                  f"carry={carry} q {qname} {kind} pools "
                                  f"is not bit-equal to the dense read of "
                                  f"its pages: max "
                                  f"{(got - want).abs().max().item()}")
                            n_reads += 1
    say(f"paged_decode_attention and paged_decode_attention_q: {n_reads} "
        f"reads bit-equal to decode_attention(_q) over gather_pages of the "
        f"same pools at the same split count (B {PATH_BATCHES}, NB "
        f"{PAGED_READS}, splits {SWEEP_SPLITS} and the chosen, the table "
        f"carried and looked up a row at a time)")
    return n_reads


def _sweep_counts(sets, read, plain, bh, L, what) -> dict:
    """``read(s, asked)`` at the split counts of SWEEP_SPLITS and the
    chosen one (by the count each launch uses), each first held against
    ``plain``, then timed over ``sets``; the chosen count's time over the
    fastest's."""
    import torch
    from paddle_tpu_torch.ops import cuda_kernels as ck
    by = {ck.decode_splits(bh, L, n)[0]: n for n in SWEEP_SPLITS + (None,)}
    want = plain(sets[0])
    for n, a in by.items():
        got = read(sets[0], a)
        err = (got - want).abs().max().item()
        check(torch.allclose(got, want, atol=F32_ATOL, rtol=F32_RTOL),
              f"split sweep {what} splits={n} differs from plain: max {err}")
    ms = {n: time_ms([lambda s=s, a=a: read(s, a) for s in sets])
          for n, a in by.items()}
    chosen = ck.decode_splits(bh, L)
    fastest = min(ms, key=ms.get)
    return {"chosen": chosen, "ms_by_splits": ms, "fastest": fastest,
            "chosen_over_fastest": ms[chosen[0]] / ms[fastest]}


def split_sweep(say, gen, cpu_gen, batches, device="cuda"):
    """The split reads' times over forced split counts against the chosen
    one, every row live, each DECODE_CASES dtype, at each B of
    ``batches``: #4 and #5 at each L of DECODE_READS (at SPLIT_BATCHES:
    the measurement decode_splits' thresholds come from), #6 and #7 at
    each NB of PAGED_READS; each count's read first held against plain.
    Keys start with the kernel's name."""
    import torch
    out = {}
    for qname, kind in DECODE_CASES:
        q_size = torch.empty((), dtype=getattr(torch, qname)).element_size()
        int8 = kind == "int8"
        kv_size = 1 if int8 else q_size
        row_bytes = DECODE_H * (HEAD_DIM * kv_size + (4 if int8 else 0))
        for B in batches:
            reads = [("decode_attention", L, f"L{L}", lambda i, L=L: (
                _dense_decode_inputs(L, qname, kind, gen, device, True,
                                     B=B)), _split_read, _plain_read)
                     for L in DECODE_READS]
            if B in PATH_BATCHES:
                reads += [("paged_decode_attention", NB * PAGE_ROWS,
                           f"NB{NB}", lambda i, NB=NB: _paged_set(
                               NB, qname, kind, cpu_gen, device, True, B=B),
                           paged_read, paged_plain) for NB in PAGED_READS]
            for name, L, shape, make, read, plain in reads:
                name += "_q" if int8 else ""
                what = f"{name} B={B} H={DECODE_H} {shape} q {qname} " \
                    f"{kind} cache"
                sets = input_sets(make, 2 * B * L * row_bytes)
                res = _sweep_counts(sets, read, plain, B * DECODE_H, L, what)
                del sets
                res["bound_ms"] = decode_bound(
                    L, q_size, kv_size, int8, B=B,
                    tables=B * L // PAGE_ROWS if "paged" in name else 0)[0]
                say(f"{what} sweep: {json.dumps(res)}")
                out[f"{name} B{B}_{shape}_q{qname}_{kind}"] = res
    return out


# ---------------------------------------------------------------------------
# phase 10: dense decode at GPT-2-small width
# ---------------------------------------------------------------------------

# generate_fused: 8 prompts of 232, 32 new tokens (the reads cross the
# 256-row bucket into 512 rows); the speculative decoders 2 x 16 tokens.
# Phase 10 was the smoke's longest phase (353 s of a 965 s run): it
# generates 32 tokens a prompt (was 100, then 64 after prompts of 200
# until phase 24 took the smoke past 1050 s) and 16 a speculative run
# (was 48, then 32), and profiles only the graphed route of each path
# (the graphed profile is the path's figure; the eager one was more than
# half of it)
GEN_PROMPTS, GEN_PROMPT_LEN, GEN_NEW, GEN_BUCKET, GEN_TOP_K = \
    8, 232, 32, 256, 40
SPEC_PROMPTS, SPEC_PROMPT_LEN, SPEC_NEW, SPEC_K = 2, 100, 16, 4
# the routes phase 10 profiles
DECODE_PROFILED = ("graphed",)


def same_tokens(got, want, what: str) -> None:
    """Each row of ``got`` equals ``want``'s, or a failure naming the first
    difference."""
    for b, (g, w) in enumerate(zip(got, want)):
        g, w = [int(t) for t in g], [int(t) for t in w]
        if g != w:
            j = next((n for n, (x, y) in enumerate(zip(g, w)) if x != y),
                     min(len(g), len(w)))
            raise SmokeFailure(f"{what}: sequence {b} differs at token {j}: "
                               f"{g[j:j + 3]} vs {w[j:j + 3]} (lengths "
                               f"{len(g)} / {len(w)})")


def generate_memory_check(say, model, ids, device):
    """generate_fused at six new prompt lengths, a fresh generator each
    call: one prefill capture a length and no decode capture (the cache
    buckets are warm), and the memory allocated grows by less than an
    eighth of the one KV cell the model keeps for this batch."""
    import torch
    B = ids.shape[0]
    cell = sum(t.numel() * t.element_size()
               for t in model.empty_cell(B).values())
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    lengths = (37, 64, 101, 150, 180, 199)
    _, wall, _, disp = counted(lambda: [model.generate_fused(
        ids[:, :T], GEN_NEW, bucket=GEN_BUCKET, sample="topk",
        top_k=GEN_TOP_K, temperature=0.8,
        generator=torch.Generator(device=device).manual_seed(T))
        for T in lengths])
    grown = torch.cuda.memory_allocated() - base
    caps = {k: step_dispatches(disp, k)["captures"]
            for k in ("prefill", "decode")}
    check(caps == {"prefill": len(lengths), "decode": 0},
          f"generate_fused at new prompt lengths: captures {caps}")
    check(grown < cell / 8, f"generate_fused at {len(lengths)} new prompt "
          f"lengths: memory allocated grew {grown} bytes, a cell is {cell}")
    say(f"generate_fused at {len(lengths)} new prompt lengths with a fresh "
        f"generator each: captures {caps}, memory allocated grew {grown} "
        f"bytes (one KV cell of B={B}: {cell} bytes), {wall:.3f} s")


def dense_decode_phase(say, seed: int, device="cuda", config=GPT2_SMALL):
    """generate_fused, ContinuousBatcher, ServingEngine and
    SpeculativeDecoder on GPT-2 small, each against its plain-route
    reference and its launch counts; returns {run: launches}."""
    import numpy as np
    import torch
    from paddle_tpu_torch.models import TransformerLM
    from paddle_tpu_torch.serving import (ContinuousBatcher, Request,
                                          SpeculativeDecoder)
    model = TransformerLM(**config).init(seed=seed, device=device)
    n_layers, vocab = config["n_layers"], config["vocab"]
    rs = np.random.RandomState(seed + 11)
    runs = {}

    def launched(run, fn):
        """fn() with the counts set to 0 just before and read just after."""
        out, wall, runs[run], _ = counted(fn)
        return out, wall

    ids = torch.as_tensor(rs.randint(0, vocab, (GEN_PROMPTS, GEN_PROMPT_LEN)),
                          device=device)
    steps = GEN_NEW - 1
    walls = {}
    for kv in (None, "int8"):
        run = f"generate_fused {kv or 'float32'} KV"
        name = "decode_attention_q" if kv else "decode_attention"
        got, walls[kv] = launched(run, lambda: model.generate_fused(
            ids, GEN_NEW, bucket=GEN_BUCKET, kv_dtype=kv))
        check(runs[run].get(name) == n_layers * steps
              and runs[run].get("flash_attention_fwd") == n_layers,
              f"{run}: launches {runs[run]}, want {n_layers} x {steps} "
              f"{name} and {n_layers} flash_attention_fwd")
        want = model.generate_fused(ids, GEN_NEW, bucket=GEN_BUCKET,
                                    kv_dtype=kv, route="plain")
        same_tokens(got[:, GEN_PROMPT_LEN:].cpu(),
                    want[:, GEN_PROMPT_LEN:].cpu(), run)
        say(f"{run}: {GEN_PROMPTS} x {GEN_NEW} tokens equal to the same "
            f"loop on the plain route; {steps} decode steps "
            f"reading 256 then 512 rows; launches {runs[run]}; "
            f"{walls[kv]:.3f} s with the graphs' captures "
            f"({GEN_PROMPTS * GEN_NEW / walls[kv]:.1f} tokens/s, smoke "
            "figure)")
        route_pair(say, run, lambda: model.generate_fused(
            ids, GEN_NEW, bucket=GEN_BUCKET, kv_dtype=kv),
            lambda out: steps, torch.equal, "decode",
            profiled=DECODE_PROFILED)
    # top-k sampling: the graphs draw with the caller's generator, the
    # same tokens as the eager loop under the same seed; the generator is
    # no part of a key, so a fresh one each call replays the same graphs
    route_pair(say, "generate_fused top-k float32 KV",
               lambda: model.generate_fused(
                   ids, GEN_NEW, bucket=GEN_BUCKET, sample="topk",
                   top_k=GEN_TOP_K, temperature=0.8,
                   generator=torch.Generator(device=device).manual_seed(
                       seed)),
               lambda out: steps, torch.equal, "decode",
            profiled=DECODE_PROFILED)
    generate_memory_check(say, model, ids, device)

    prompts = workload(seed, vocab)
    solo = [model.generate_fused(
        torch.as_tensor(p[None].astype(np.int64), device=device), NEW_TOKENS,
        kv_dtype="int8", route="plain")[0, len(p):].cpu().tolist()
        for p in prompts]
    batcher = ContinuousBatcher(model, kv_dtype="int8", device=device,
                                slots=ENGINE["slots"],
                                segment=ENGINE["segment"],
                                cache_bucket=ENGINE["cache_bucket"])
    run = "ContinuousBatcher int8 KV"
    got, wall = launched(run, lambda: batcher.serve(
        [Request(i, p, NEW_TOKENS) for i, p in enumerate(prompts)]))
    steps = batcher.segments_total * batcher.segment
    check(runs[run].get("decode_attention_q") == n_layers * steps,
          f"{run}: launches {runs[run]}, want {n_layers} x {steps} "
          "decode_attention_q")
    same_tokens([got[i] for i in range(len(prompts))], solo, run)
    say(f"{run}: {len(prompts)} requests x {NEW_TOKENS} tokens equal to "
        f"each request's solo int8 plain decode; segments by read rows "
        f"{batcher.segments_by_len}; launches {runs[run]}; {wall:.3f} s")

    def batcher_run():
        seg0 = batcher.segments_total
        out = batcher.serve([Request(i, p, NEW_TOKENS)
                             for i, p in enumerate(prompts)])
        return out, batcher.segments_total - seg0
    route_pair(say, run, batcher_run, lambda out: out[1],
               lambda a, b: a[1] == b[1] and all(
                   np.array_equal(a[0][k], b[0][k]) for k in a[0]),
               "segment", profiled=DECODE_PROFILED)

    run = "ServingEngine int8 KV"
    (toks, _, wall, eng), _ = launched(run, lambda: serve(
        model, prompts, device, kv_dtype="int8"))
    steps = eng.pool.segments_total * eng.pool.segment
    check(runs[run].get("paged_decode_attention_q") == n_layers * steps,
          f"{run}: launches {runs[run]}, want {n_layers} x {steps} "
          "paged_decode_attention_q")
    same_tokens(toks, solo, run)
    say(f"{run}: {len(prompts)} requests equal to the solo int8 plain "
        f"decode; segments by read pages {eng.pool.segments_by_pages}; "
        f"launches {runs[run]}; {wall:.3f} s")
    del eng                 # its pool is not part of the figures' peaks

    sids = rs.randint(0, vocab, (SPEC_PROMPTS, SPEC_PROMPT_LEN))
    sd = SpeculativeDecoder(model, model, k=SPEC_K, draft_kv_dtype="int8")
    run = "SpeculativeDecoder int8 self-draft"
    (toks, stats), wall = launched(run, lambda: sd.generate(sids, SPEC_NEW))
    steps = stats["rounds"] * SPEC_K
    check(runs[run].get("decode_attention_q") == n_layers * steps,
          f"{run}: launches {runs[run]}, want {n_layers} x {steps} draft "
          "steps of decode_attention_q")
    want = model.generate_fused(torch.as_tensor(sids, device=device),
                                SPEC_NEW, route="plain")
    same_tokens(toks, want[:, SPEC_PROMPT_LEN:].cpu(), run)
    say(f"{run}: {SPEC_PROMPTS} x {SPEC_NEW} tokens equal to the greedy "
        f"plain decode; {json.dumps(stats)}; launches {runs[run]}; "
        f"{wall:.3f} s")
    same_spec = lambda a, b: np.array_equal(a[0], b[0]) and a[1] == b[1]
    route_pair(say, run, lambda: sd.generate(sids, SPEC_NEW),
               lambda out: out[1]["rounds"], same_spec, "round",
               profiled=DECODE_PROFILED)

    # a draft that disagrees: GPT-2 small from another seed, at f32 KV, so
    # rounds reject proposals, rewind pos and overwrite rejected rows
    draft = TransformerLM(**config).init(seed=seed + 1, device=device)
    sd = SpeculativeDecoder(model, draft, k=SPEC_K)
    run = "SpeculativeDecoder other-seed draft"
    (toks, stats), wall = launched(run, lambda: sd.generate(sids, SPEC_NEW))
    steps = stats["rounds"] * SPEC_K
    check(runs[run].get("decode_attention") == n_layers * steps,
          f"{run}: launches {runs[run]}, want {n_layers} x {steps} draft "
          "steps of decode_attention")
    check(stats["accepted"] < stats["proposed"],
          f"{run}: every proposal was accepted ({stats}), so no round "
          "rejected one")
    same_tokens(toks, want[:, SPEC_PROMPT_LEN:].cpu(), run)
    say(f"{run}: {SPEC_PROMPTS} x {SPEC_NEW} tokens equal to the greedy "
        f"plain decode; {json.dumps(stats)}; launches {runs[run]}; "
        f"{wall:.3f} s")
    route_pair(say, run, lambda: sd.generate(sids, SPEC_NEW),
               lambda out: out[1]["rounds"], same_spec, "round",
               profiled=DECODE_PROFILED)
    del draft, sd

    model.to(torch.bfloat16)
    figures = engine_pair(say, "ServingEngine bf16 int8 KV", model, prompts,
                          device, kv_dtype="int8")
    say("serving bf16 weights at int8 KV, eager and graphed (smoke "
        f"figures, not a benchmark; bf16 KV is phase 3's): "
        f"{json.dumps(figures)}")
    return runs


# ---------------------------------------------------------------------------
# phase 11: the GRU kernels against their plain versions
# ---------------------------------------------------------------------------

# the attention seq2seq of benchmarks/seq2seq_nmt.py:22-27 (a GNMT-small
# shape): vocab 30000/30000, embed 512, hidden 512, source and target
# padded to 32 with lengths uniform in 16..32, batch 64, 4 batches, Adam
# 1e-3, bf16 compute over f32 master weights
S2S = dict(src_vocab=30000, trg_vocab=30000, embed_dim=512, hidden=512)
S2S_BATCH, S2S_SEQ, S2S_MIN_LEN, S2S_NBUF, S2S_PASSES, S2S_LR = \
    64, 32, 16, 4, 3, 1e-3
GRU_KERNELS = (
    ("gru_seq", "paddle_tpu_torch/csrc/gru_seq.cu",
     "paddle_tpu/ops/pallas_kernels.py:1160", "_gru_seq_kernel"),
    ("gru_seq_bwd", "paddle_tpu_torch/csrc/gru_seq_bwd.cu",
     "paddle_tpu/ops/pallas_kernels.py:1192", "_gru_seq_bwd_kernel"),
)
# the edge shape: a partial last row tile (37 = 32 + 5), lengths 0, 1, T
GRU_EDGE = (37, 9)
# #12's design (both dtypes)
GRU_BWD_DESIGN = ("one cooperative launch in three phases over the live "
                  "(b, t) rows only: the gate recompute as 64 x 64 "
                  "tensor-core tiles (mma.sync, three TF32 passes where "
                  "both operands are f32, fewer for bf16 ones); the "
                  "reverse recurrence with two grid barriers a step, each "
                  "block 8 units x 32 rows, the live rows' cotangents "
                  "read from L2 into registers against U in shared memory "
                  "and reduced over half-warps; dU as tensor-core tiles")


def _gru_inputs(B, T, H, lens, dtype, gen, device, reverse=False):
    """Kernel inputs as the encoder makes them: xw = x@W + b of unit-scale
    embeddings through U(-0.08, 0.08) weights, U likewise, a nonzero h0,
    the cotangents of a mean loss; the within-length flipped xw for the
    reverse direction (what ``gru(reverse=True)`` hands the kernel).
    Returns the forward's and the backward's arguments (the backward's
    out is the plain forward's)."""
    import torch
    from paddle_tpu_torch.ops import rnn_kernels as rk
    from paddle_tpu_torch.ops.rnn import _reverse_within_length

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(device, dtype)
    lengths = torch.as_tensor(lens, dtype=torch.int32, device=device)
    xw = rnd(B, T, 3 * H, scale=0.5)
    if reverse:
        xw = _reverse_within_length(xw, lengths).contiguous()
    u = ((torch.rand((H, 3 * H), generator=gen) - 0.5) * 0.16).to(device,
                                                                  dtype)
    h0 = rnd(B, H, scale=0.5)
    fwd = (xw, lengths, u, None, h0)
    out, _ = rk.gru_sequence_fused(*fwd, route="plain")
    return fwd, (xw, lengths, u, h0, out, rnd(B, T, H, scale=0.01),
                 rnd(B, H, scale=0.01))


def _gru_run(name, args, route=None):
    from paddle_tpu_torch.ops import rnn_kernels as rk
    if name == "gru_seq":
        return rk.gru_sequence_fused(*args, route=route)
    return rk.gru_sequence_fused_bwd(*args, route=route)


def gru_kernel_checks(say, seed: int, device="cuda", parent=None):
    """#11 and #12 against their plain versions in f32 and bf16 at the
    bench shape (B=64, T=32, H=512, lengths from the seed in 16..32 with
    one 0, nonzero h0), on its within-length flipped input (the reverse
    direction) and at the edge shape; at the bench shape their times, the
    plain versions' and the bound (and #11's beside the ``parent``
    library's body, timed in turns, where one is given). Tolerances as
    phase 4's (lstm_close).
    Returns the kernels' JSON entries (the bf16 bench numbers first: that
    is what the training path runs)."""
    import numpy as np
    import torch
    B, T, H = S2S_BATCH, S2S_SEQ, S2S["hidden"]
    rs = np.random.RandomState(seed)
    bench_lens = rs.randint(S2S_MIN_LEN, T + 1, B)
    bench_lens[0] = 0
    eB, eT = GRU_EDGE
    edge_lens = rs.randint(0, eT + 1, eB)
    edge_lens[:3] = (0, 1, eT)
    shapes = (("bench", B, T, bench_lens, False),
              ("reverse", B, T, bench_lens, True),
              ("edge", eB, eT, edge_lens, False))
    gen = torch.Generator().manual_seed(seed + 11)
    entries = {name: {"name": name, "route": "cuda", "source": src,
                      "replaces": rep, "replaces_kernel": body,
                      "library_ms": None,
                      "library_note": "no single PyTorch call: cuDNN's GRU "
                                      "(torch.nn.GRU) computes r*(h@U_c + "
                                      "b_hc), not (r*h)@U_c, and has no "
                                      "per-sample length mask with a "
                                      "frozen state"}
               for name, src, rep, body in GRU_KERNELS}
    entries["gru_seq_bwd"]["design"] = GRU_BWD_DESIGN
    entries["gru_seq"]["design"] = RNN_FWD_DESIGN
    entries["gru_seq"]["plan"] = forward_plan_entry("gru", B, H)
    for tag, Bs, Ts, lens, reverse in shapes:
        for dt, dname in ((torch.float32, "float32"),
                          (torch.bfloat16, "bfloat16")):
            args = dict(zip(("gru_seq", "gru_seq_bwd"), _gru_inputs(
                Bs, Ts, H, lens, dt, gen, device, reverse)))
            for name, _, _, _ in GRU_KERNELS:
                got = _gru_run(name, args[name])
                want = _gru_run(name, args[name], route="plain")
                torch.cuda.synchronize()
                errs = [lstm_close(g, w, f"{name} {tag} output {i}", dname,
                                   sum_terms=Bs * Ts if (
                                       name == "gru_seq_bwd" and i == 2)
                                   else 0)
                        for i, (g, w) in enumerate(zip(got, want))]
                if name == "gru_seq":
                    for b, n in enumerate(lens):
                        if n == 0:
                            check(not got[0][b].any().item(),
                                  f"{name}: a 0-length sample has output")
                            check(torch.equal(got[1][b], args[name][4][b]),
                                  f"{name}: a 0-length sample's hT != h0")
                res = {"max_abs_err": max(errs)}
                if tag != "reverse":
                    again = _gru_run(name, args[name])
                    check(all(torch.equal(a, b) for a, b in zip(got, again)),
                          f"{name} {tag} {dname}: two runs differ")
                    res["bit_equal_two_runs"] = True
                if tag == "bench":
                    res.update(_gru_times(name, B, T, H, lens, dt, dname,
                                          gen, device, parent))
                say(f"{name} {tag} B={Bs} T={Ts} H={H} {dname}: "
                    f"{json.dumps(res)}")
                e = entries[name]
                if tag == "bench" and dt == torch.bfloat16:
                    e.update(res)
                    e["dtype"] = dname
                    e["shape"] = (f"B={Bs} T={Ts} H={H}, lengths "
                                  f"{S2S_MIN_LEN}..{T} from the seed, one 0")
                else:
                    e[f"{tag}_{dname}"] = res
    return [entries[name] for name, _, _, _ in GRU_KERNELS]


def _gru_times(name, B, T, H, lens, dt, dname, gen, device, parent=None):
    """Kernel and plain times (CUDA graph over input sets larger than L2)
    and the bound: the products of the live steps (2*H*3H per live
    (sample, step) in the forward, three times that in the backward)
    against each input read and each output written once; the backward's
    at the tensor cores' rate (:func:`tensor_core_bound`), the forward's
    at the CUDA cores'."""
    import torch
    es = torch.empty((), dtype=dt).element_size()
    G = 3 * H
    seq, vec, u_b = B * T * H * es, B * H * es, H * G * es
    live = int(sum(lens))
    if name == "gru_seq":       # xw, lens, u, h0 -> out, hT
        nbytes = B * T * G * es + B * 4 + u_b + vec + seq + vec
        flops = 2.0 * live * H * G
    else:       # xw, lens, u, h0, out, g_out, g_ht -> dxw, dh0, du (f32)
        nbytes = (B * T * G * es + B * 4 + u_b + vec + 2 * seq + vec
                  + B * T * G * es + vec + H * G * 4)
        flops = 3 * 2.0 * live * H * G
    idx = 0 if name == "gru_seq" else 1
    sets = input_sets(lambda i: _gru_inputs(B, T, H, lens, dt, gen,
                                            device)[idx], nbytes)
    ours = [lambda s=s: _gru_run(name, s) for s in sets]
    extra = {}
    if name == "gru_seq":
        extra = (_parent_turns(name, ours, sets, parent) if parent
                 else {}) or {"ms": time_ms(ours)}
        extra["us_a_step"] = extra["ms"] * 1e3 / max(lens)
    ms = extra.get("ms") or time_ms(ours)
    plain_ms = time_ms([lambda s=s: _gru_run(name, s, route="plain")
                        for s in sets], rounds=1, reps=2)
    del sets
    if name == "gru_seq_bwd":
        return {"ms": ms, "plain_ms": plain_ms,
                **tensor_core_bound(flops, nbytes, dname)}
    b_ms, b_by = bound(flops, nbytes, dname)
    return {**extra, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by}


# ---------------------------------------------------------------------------
# phase 12: the attention seq2seq at full width
# ---------------------------------------------------------------------------

def s2s_generation(say, model, batch, device):
    """``generate`` (beam 4) and ``greedy_generate`` on one batch of 64 in
    f32, each with the launch counts set to 0 just before and read just
    after: two launches of #11 a call (the encoder's directions), none of
    #12; tokens equal to the same call on the plain route; scores allclose
    (rtol 1e-5, atol 1e-4: a score sums 32 log-probabilities of ~-10, and
    the routes' encoders differ in summation order) and sorted best-first;
    then each call on the eager route and through its graph, tokens and
    scores equal. Returns the counts of each call."""
    import torch
    from paddle_tpu_torch.core import SeqBatch
    from paddle_tpu_torch.ops import cuda_kernels as ck
    src = SeqBatch(batch[0], batch[1])
    calls = {"beam": lambda r: model.generate(src, beam_size=4,
                                              max_len=S2S_SEQ, route=r),
             "greedy": lambda r: model.greedy_generate(src, max_len=S2S_SEQ,
                                                       route=r)}
    runs = {}
    for what, call in calls.items():
        call(None)                                  # warm this path
        torch.cuda.synchronize()
        ck.reset_launch_counts()
        t0 = time.perf_counter()
        toks, scores = call(None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {n: ck.LAUNCHES[n] for n in ("gru_seq", "gru_seq_bwd")}
        want_t, want_s = call("plain")
        check(launches == {"gru_seq": 2, "gru_seq_bwd": 0},
              f"seq2seq {what}: GRU launches {launches} != 2 forward, 0 "
              "backward")
        check(torch.equal(toks, want_t), f"seq2seq {what}: tokens differ "
              f"from the plain route's at "
              f"{(toks != want_t).nonzero()[:5].tolist()}")
        err = (scores - want_s).abs().max().item()
        check(torch.allclose(scores, want_s, rtol=1e-5, atol=1e-4),
              f"seq2seq {what}: scores differ from plain by {err}")
        check(bool(torch.isfinite(scores).all()), f"seq2seq {what}: a "
              "non-finite score")
        if what == "beam":
            check(tuple(toks.shape) == (S2S_BATCH, 4, S2S_SEQ)
                  and bool((scores[:, :-1] >= scores[:, 1:]).all()),
                  "seq2seq beam: shape or best-first order wrong")
        eos = (toks == 1).any(-1).float().mean().item()
        say(f"seq2seq {what} decode B={S2S_BATCH} max_len={S2S_SEQ} f32: "
            f"tokens equal to the plain route's, max score difference "
            f"{err:.3e}, {wall * 1e3:.3f} ms a call, share of sequences "
            f"with an EOS {eos:.3f}, launches {launches}")
        route_pair(say, f"seq2seq {what}", lambda: call(None),
                   lambda out: 1, lambda a, b: torch.equal(a[0], b[0])
                   and torch.equal(a[1], b[1]), what)
        runs[what] = launches
    return runs


def s2s_phase(say, seed: int, device="cuda", config=S2S,
              passes=S2S_PASSES):
    """The attention seq2seq (random weights from the seed) trained by
    ``Trainer.train`` (bf16 over f32 masters, Adam) over the benchmark's 4
    batches on the eager route and through the graphs, after one f32 step
    against the plain route's and one through its graph against the eager
    step; then beam and greedy generation. Returns the training and
    generation counts."""
    import torch
    from paddle_tpu_torch.models import AttentionSeq2Seq
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.trainer import Trainer
    model = AttentionSeq2Seq(**config).init(seed=seed, device=device)
    batches = nmt_batches(seed, S2S_NBUF, device, S2S_BATCH, S2S_SEQ,
                          config["src_vocab"], S2S_MIN_LEN)
    names = tuple(n for n, _, _, _ in GRU_KERNELS)
    # the encoder's two directions, each one forward and one backward.
    # att_dec/w's gradient sits at the rounding floor at initialization:
    # the encoder states are small, so tanh' barely varies over the source
    # positions and the decoder state shifts every score alike, which the
    # softmax cancels (a norm ~1e-14 against ~1e-1 for the largest)
    transformer_step_check(say, "seq2seq",
                           lambda r: nmt_loss(model, torch.float32, r),
                           model.tree(), batches[0], S2S_LR, 2, device,
                           names=names, floor=1e-7)
    graph_step_check(say, "seq2seq", nmt_loss(model, torch.float32),
                     model.tree(), batches[0], S2S_LR, device)
    torch.cuda.empty_cache()
    train, steps = train_and_time(
        say, "seq2seq", lambda: Trainer(nmt_loss(model, torch.bfloat16),
                                        Adam(S2S_LR), device=device),
        model.tree(), batches, passes, 2, device, names=names)
    return train, steps, s2s_generation(say, model, batches[0], device)


# ---------------------------------------------------------------------------
# phase 13: the image stack and ResNet-50 training
# ---------------------------------------------------------------------------

# benchmarks/resnet50.py:27-30,48-66: ResNet-50, batch 64 of 224x224x3,
# 1000 classes, 4 rotating batches, Momentum(0.1, 0.9), bf16 over f32
# masters (the running stats too), train-mode BN merged every step
RESNET_BATCH, RESNET_IMAGE, RESNET_CLASSES, RESNET_NBUF = 64, 224, 1000, 4
RESNET_LR, RESNET_MU, RESNET_PASSES = 0.1, 0.9, 3
# benchmarks/image_suite.py:28-35,55-60: the batch-64 rows, Momentum(0.01,
# 0.9), bf16 over f32, training mode with dropout, LRN and the aux towers
SUITE = (("smallnet", 32, 10), ("alexnet", 224, 1000),
         ("googlenet", 224, 1000))
SUITE_BATCH, SUITE_LR, SUITE_PASSES = 64, 0.01, 3
# op checks, card against the port on the CPU. f32 (TF32 off): cuDNN may
# pick a Winograd or FFT algorithm, whose f32 error is ~1e-5-1e-4 of the
# output's scale: convs to 1e-4 of the largest magnitude, the rest 1e-5;
# rtol 1e-4 (summation order). bf16: both sides round one f32 result, one
# bf16 ulp of the largest magnitude plus 2**-7 of each entry
IMAGE_CONV_ATOL, IMAGE_F32_ATOL, IMAGE_F32_RTOL = 1e-4, 1e-5, 1e-4
# the device time of an image step by kind, each kernel in the first
# kind whose name holds one of its keys
IMAGE_KINDS = (
    ("batch norm", ("batch_norm", "bn_fw", "bn_bw", "bn_", "batchnorm")),
    ("convolution", ("conv", "xmma", "cudnn", "cutlass", "implicit",
                     "wgrad", "dgrad", "fprop", "winograd", "fft",
                     "gemm", "nchwToNhwc", "nhwcToNchw")),
    ("pooling", ("pool",)),
    ("elementwise (relu, adds, casts, optimizer)", ("elementwise",
                                                    "vectorized",
                                                    "unrolled")),
    ("reductions", ("reduce",)),
)


def _image_close(got, want, dtype, atol_scale, what):
    """Card against CPU with the stated tolerance; returns the max abs
    error."""
    import torch
    g, w = got.detach().float().cpu(), want.detach().float()
    err = (g - w).abs().max().item()
    scale = max(w.abs().max().item(), 1e-30)
    if dtype == torch.float32:
        ok = torch.allclose(g, w, rtol=IMAGE_F32_RTOL,
                            atol=atol_scale * max(scale, 1.0))
    else:
        ok = torch.allclose(g, w, rtol=2.0 ** -7, atol=bf16_ulp(scale))
    check(ok, f"image op {what}: card differs from the CPU by {err}")
    return err


def image_op_checks(say, seed: int, device="cuda"):
    """Each ported op of the image stack on the card against the same op
    of the port on the CPU, in f32 (TF32 off) and bf16, at ResNet-50's
    shapes (batch 4): the stem 7x7/s2 direct and by space-to-depth, a 3x3,
    a 1x1 stride-2 projection, a depthwise 3x3, a 3x3/s2 transpose; the
    3/2/1 max pool, the 3/2/1 avg pool under both count rules, the global
    pools; BN in training mode (each pass with its batch moments, and
    ``batch_norm`` with the new stats) and eval
    mode; LRN at AlexNet's first map."""
    import torch
    from paddle_tpu_torch.ops import conv as C
    from paddle_tpu_torch.ops import norm as N
    from paddle_tpu_torch.ops import pool as P
    gen = torch.Generator().manual_seed(seed)
    r = lambda *s, scale=1.0, shift=0.0: (
        torch.randn(s, generator=gen) * scale + shift)
    bn_args = (r(4, 56, 56, 256, scale=2.0, shift=1.0),
               r(256, scale=0.3, shift=1.0), r(256, scale=0.3),
               r(256, scale=0.5), r(256).abs() + 0.5)
    cases = {
        "stem 7x7/s2 direct": (lambda x, w: C.conv2d(x, w, stride=2,
                                                     padding=3),
                               (r(4, 224, 224, 3), r(7, 7, 3, 64,
                                                     scale=0.1)), True),
        "stem 7x7/s2 space-to-depth": (C.conv7s2_space_to_depth,
                                       (r(4, 224, 224, 3),
                                        r(7, 7, 3, 64, scale=0.1)), True),
        "3x3 64->64": (lambda x, w: C.conv2d(x, w, padding=1),
                       (r(4, 56, 56, 64), r(3, 3, 64, 64, scale=0.05)),
                       True),
        "1x1/s2 projection 256->512": (
            lambda x, w: C.conv2d(x, w, stride=2),
            (r(4, 56, 56, 256), r(1, 1, 256, 512, scale=0.05)), True),
        "depthwise 3x3": (lambda x, w: C.depthwise_conv2d(x, w, padding=1),
                          (r(4, 56, 56, 64), r(3, 3, 1, 64, scale=0.3)),
                          True),
        "transpose 3x3/s2": (lambda x, w: C.conv2d_transpose(
            x, w, stride=2, padding=1), (r(4, 28, 28, 64),
                                         r(3, 3, 64, 32, scale=0.05)), True),
        "max pool 3/2/1": (lambda x: P.max_pool2d(x, 3, 2, 1),
                           (r(4, 112, 112, 64),), False),
        "avg pool 3/2/1 count pad": (lambda x: P.avg_pool2d(x, 3, 2, 1),
                                     (r(4, 112, 112, 64),), False),
        "avg pool 3/2/1 count cells": (
            lambda x: P.avg_pool2d(x, 3, 2, 1, count_include_pad=False),
            (r(4, 112, 112, 64),), False),
        "global avg pool": (P.global_avg_pool2d, (r(4, 7, 7, 2048),),
                            False),
        "global max pool": (P.global_max_pool2d, (r(4, 7, 7, 2048),),
                            False),
        "BN train fused": (lambda x, g, b, m, v: N._train_fused(
            x, g, b, 1e-5), bn_args, False),
        "BN train shifted": (lambda x, g, b, m, v: N._train_shifted(
            x, g, b, m, 1e-5), bn_args, False),
        "BN train": (lambda *a: N.batch_norm(*a, train=True), bn_args,
                     False),
        "BN eval": (lambda *a: N.batch_norm(*a, train=False), bn_args,
                    False),
        "LRN": (N.lrn, (r(4, 55, 55, 96, scale=3.0),), False),
    }
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        for what, (fn, args, is_conv) in cases.items():
            cpu = [a.to(dtype) for a in args]
            want = fn(*cpu)
            got = fn(*[a.to(device) for a in cpu])
            want = want if isinstance(want, tuple) else (want,)
            got = got if isinstance(got, tuple) else (got,)
            check(len(got) == len(want) and all(
                g.dtype == w.dtype and g.shape == w.shape
                for g, w in zip(got, want)),
                f"image op {what}: card and CPU outputs differ in kind")
            atol = IMAGE_CONV_ATOL if is_conv else IMAGE_F32_ATOL
            worst[f"{what} {str(dtype)[6:]}"] = max(
                _image_close(g, w, dtype, atol, what)
                for g, w in zip(got, want))
    say(f"image ops, card against the port on the CPU (f32 with TF32 off "
        f"and bf16), max abs errors: {json.dumps(worst)}")


def image_batches(seed: int, n: int, device, batch: int, image: int,
                  classes: int):
    """``n`` batches (x [B, image, image, 3] in [0, 1), labels) from the
    seed, as benchmarks/resnet50.py draws them."""
    import numpy as np
    import torch
    rs = np.random.RandomState(seed)
    return [(torch.as_tensor(rs.rand(batch, image, image, 3)
                             .astype(np.float32), device=device),
             torch.as_tensor(rs.randint(0, classes, batch), device=device))
            for _ in range(n)]


def resnet_loss(model, dtype):
    """benchmarks/resnet50.py's loss: every f32 leaf (the running stats
    too) cast to ``dtype``, train-mode BN, the logits as f32, the mean
    cross-entropy; returns (loss, stat updates) for the trainer to merge
    into the f32 masters."""
    import torch

    def loss_fn(params, x, y):
        mut = {}
        logits = model.call(cast_tree(params, dtype), x.to(dtype),
                            train=True, mutable=mut).to(torch.float32)
        logp = torch.log_softmax(logits, -1)
        return -logp.gather(1, y.long()[:, None]).mean(), mut
    return loss_fn


def step_flops(make_model, batch: int, image: int) -> float:
    """The operations of one training step of a fresh model on the meta
    device (``torch.utils.flop_counter``: convs and matmuls, forward and
    backward; none is run)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from paddle_tpu_torch.core.pytree import tree_from_items, tree_items
    model = make_model()
    items = [(p, v.to(torch.bfloat16).requires_grad_(True))
             for p, v in tree_items(model.tree())]
    x = torch.empty(batch, image, image, 3, device="meta",
                    dtype=torch.bfloat16)
    y = torch.zeros(batch, dtype=torch.long, device="meta")
    with FlopCounterMode(display=False) as fc:
        loss = model.call(tree_from_items(items), x, y, train=True,
                          mutable={}, method="loss")
        torch.autograd.grad(loss, [v for _, v in items],
                            materialize_grads=True)
    return float(fc.get_total_flops())


def kernel_split(say, what, run, steps: int, wall: float) -> dict:
    """The device time of ``run()`` (``steps`` steps) by IMAGE_KINDS from
    one profiled run, with the top kernels; ``wall`` is the same work's
    unprofiled wall time (for the busy share)."""
    rows, _ = device_rows(run)
    total = sum(r[0] for r in rows)
    check(total > 0, f"{what}: the profiler saw no device time")
    kinds = {k: 0.0 for k, _ in IMAGE_KINDS}
    kinds["other"] = 0.0
    for us, _, name in rows:
        low = name.lower()
        kind = next((k for k, keys in IMAGE_KINDS
                     if any(key.lower() in low for key in keys)), "other")
        kinds[kind] += us
    split = {k: {"ms_per_step": v / 1e3 / steps, "share": v / total}
             for k, v in kinds.items()}
    out = {"device_ms_per_step": total / 1e3 / steps,
           "busy_share": total / 1e6 / wall,
           "kernels_per_step": sum(r[1] for r in rows) / steps,
           "split": split}
    say(f"{what} device time by kind: {json.dumps(out)}")
    rows.sort(reverse=True)
    for us, n, name in rows[:15]:
        print(f"  {us / 1e3 / steps:9.3f} ms/step {100 * us / total:5.1f}% "
              f"x{n / steps:<6.1f} {name[:100]}")
    return out


def _time_fwd_bwd(fn, make, nbytes_one: int) -> float:
    """Mean device ms of one forward and backward of ``fn`` over input
    sets from ``make(i)`` (larger than L2 in all), through time_ms."""
    import torch

    def call(args):
        ins, cot = args
        out = fn(*ins)
        out = out[0] if isinstance(out, tuple) else out
        torch.autograd.grad(out, [a for a in ins if a.requires_grad], cot)
    sets = input_sets(make, nbytes_one, floor=2)
    return time_ms([lambda a=a: call(a) for a in sets], rounds=2, reps=3)


def image_route_timings(say, seed: int, device="cuda") -> dict:
    """(e) The two choices of this slice, timed on the card in bf16,
    forward and backward: the stem 7x7/s2 direct against space-to-depth at
    64x224x224x3 -> 64; the BN training passes (``ops/norm.py``
    ``_train_fused``, ``_train_shifted``) at each of ResNet-50's 53 BN
    input shapes at batch 64, summed a step; and what
    the HWIO weight's per-call conversion costs a conv (forward, the HWIO
    view against a channels-last OIHW copy of it) at three ResNet-50
    shapes."""
    import collections
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.models import resnet50
    from paddle_tpu_torch.nn import BatchNorm
    from paddle_tpu_torch.ops import conv as C
    from paddle_tpu_torch.ops import norm as N
    bf = torch.bfloat16
    gen = torch.Generator(device=device).manual_seed(seed)
    rnd = lambda *s, grad=False: torch.randn(
        s, generator=gen, device=device, dtype=bf).requires_grad_(grad)
    out = {}
    x_b = 64 * 224 * 224 * 3 * 2
    stem = {}
    for name, fn in (("direct", lambda x, w: C.conv2d(x, w, stride=2,
                                                      padding=3)),
                     ("s2d", C.conv7s2_space_to_depth)):
        stem[name] = _time_fwd_bwd(fn, lambda i: (
            (rnd(64, 224, 224, 3), rnd(7, 7, 3, 64, grad=True)),
            rnd(64, 112, 112, 64)), x_b)
    out["stem_ms_fwd_bwd"] = stem
    say(f"image stem 7x7/s2 at 64x224x224x3 -> 64, bf16 forward + dW: "
        f"{json.dumps(stem)}")
    # ResNet-50's BN input shapes, from a forward on the meta device
    model, shapes = resnet50(), []
    for mod in model.modules():
        if isinstance(mod, BatchNorm):
            mod.register_forward_pre_hook(
                lambda m, a: shapes.append(tuple(a[0].shape)))
    model(torch.empty(RESNET_BATCH, RESNET_IMAGE, RESNET_IMAGE, 3,
                      device="meta", dtype=bf), train=True, mutable={})
    counts = collections.Counter(shapes)
    check(sum(counts.values()) == 53, f"ResNet-50 has {len(shapes)} BNs")
    passes = {"fused": lambda x, g, b, m: N._train_fused(x, g, b, 1e-5),
              "shifted": lambda x, g, b, m: N._train_shifted(x, g, b, m,
                                                             1e-5)}

    def bn_train(bn_pass):
        """``batch_norm``'s training step through ``bn_pass``: the pass,
        then the running stats merged; returns y."""
        def run(x, g, b, m, v):
            y, mean, var = bn_pass(x, g, b, m)
            N._merge_running(m, v, mean, var, 0.9)
            return y
        return run
    forms = {f: 0.0 for f in passes}
    per_shape = {}
    for shape, n in counts.items():
        C_ = shape[-1]
        nbytes = 2 * torch.Size(shape).numel()
        for f, bn_pass in passes.items():
            ms = _time_fwd_bwd(
                bn_train(bn_pass),
                lambda i: ((rnd(*shape, grad=True), rnd(C_, grad=True),
                            rnd(C_, grad=True), rnd(C_), rnd(C_).abs()),
                           rnd(*shape)), nbytes)
            per_shape.setdefault("x".join(map(str, shape)), {})[f] = ms
            forms[f] += n * ms
    out["bn_ms_per_step"] = forms
    out["bn_ms_by_shape"] = per_shape
    say(f"image BN training passes, bf16 forward + backward summed over ResNet-50's "
        f"53 BNs at batch 64: {json.dumps(forms)}; by shape "
        f"{json.dumps(per_shape)}")
    layout = {}
    for (H, cin, cout, k, s) in ((56, 64, 64, 3, 1), (56, 256, 64, 1, 1),
                                 (14, 1024, 2048, 1, 2), (7, 512, 512, 3, 1)):
        w = rnd(k, k, cin, cout)
        w_cl = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        xs = input_sets(lambda i: rnd(64, H, H, cin).permute(0, 3, 1, 2),
                        64 * H * H * cin * 2, floor=2)
        ms = {}
        for name, wt in (("hwio_view", w.permute(3, 2, 0, 1)),
                         ("channels_last", w_cl)):
            ms[name] = time_ms([lambda x=x, wt=wt: F.conv2d(
                x, wt, stride=s, padding=k // 2) for x in xs], 2, 3)
        layout[f"{H}x{H}x{cin}->{cout} k{k} s{s}"] = ms
    out["weight_layout_ms_fwd"] = layout
    say(f"image conv forward, HWIO weight view (converted per call) "
        f"against a channels-last copy: {json.dumps(layout)}")
    return out


def repeated_batch_check(say, trainer, params, batch, steps: int = 8,
                         falls: int = 2):
    """``steps`` steps of ``trainer`` on one batch from ``params`` through
    the step's graph: every cost finite and the next ``falls`` costs below
    the first; all are printed. The bench's Momentum(0.1, 0.9), with no
    warm-up, overshoots on one repeated batch after a few steps, and so
    does JAX's ResNet-50 under the same recipe
    (tests/test_torch_image_models.py
    ``test_repeated_batch_losses_follow_jax``): only the first steps are
    held to fall. Returns the costs."""
    import numpy as np
    from paddle_tpu_torch.trainer import event
    costs = []
    trainer.train(lambda: [batch] * steps, params, event_handler=lambda e:
                  costs.append(e.cost)
                  if isinstance(e, event.EndIteration) else None)
    check(len(costs) == steps and all(np.isfinite(costs))
          and all(c < costs[0] for c in costs[1:1 + falls]),
          f"ResNet-50: the cost of a repeated batch did not fall in its "
          f"first {falls} steps: {costs}")
    say(f"ResNet-50 bf16, {steps} steps on one repeated batch (the first "
        f"{falls} after the first held to fall): costs {json.dumps(costs)}")
    return costs


def resnet_card_vs_cpu(say, seed: int, device="cuda"):
    """(c) ResNet-50 at batch 2 in f32 (TF32 off), weights from the seed:
    logits, loss, every gradient and the new BN stats of one train-mode
    forward and backward on the card against the same port code on the
    CPU. The card's f32 step is held to the CPU's float64 step within
    twice the CPU's own f32 distance to it (summation order, amplified
    through 53 batch norms), relative L2, and at least 1e-5 (~80 f32 ulps:
    one f32 scalar, the loss, may land nearer the float64 one on one side
    by chance)."""
    import torch
    from paddle_tpu_torch.core.pytree import tree_from_items, tree_items
    from paddle_tpu_torch.models import resnet50
    gen = torch.Generator().manual_seed(seed)
    x = torch.rand(2, RESNET_IMAGE, RESNET_IMAGE, 3, generator=gen)
    y = torch.randint(0, RESNET_CLASSES, (2,), generator=gen)

    def run(dev, dtype):
        model = resnet50(RESNET_CLASSES).init(seed, dev)
        items = [(p, v.to(dtype).requires_grad_(True))
                 for p, v in tree_items(model.tree())]
        mut = {}
        logits = model.call(tree_from_items(items), x.to(dev, dtype),
                            train=True, mutable=mut)
        loss = -torch.log_softmax(logits, -1).gather(
            1, y.to(dev)[:, None]).mean()
        grads = torch.autograd.grad(loss, [v for _, v in items],
                                    materialize_grads=True)
        flat = lambda ts: torch.cat([t.detach().double().cpu().reshape(-1)
                                     for t in ts])
        stats = [v for k in sorted(mut) for v in mut[k].values()]
        return {"logits": flat([logits]), "loss": flat([loss]),
                "grads": flat(grads), "stats": flat(stats)}
    t0 = time.perf_counter()
    card = run(device, torch.float32)
    cpu, cpu64 = run("cpu", torch.float32), run("cpu", torch.float64)
    rel = lambda a, b: ((a - b).norm() / b.norm().clamp_min(1e-30)).item()
    res = {}
    for k in card:
        res[k] = {"card_vs_cpu": rel(card[k], cpu[k]),
                  "card_vs_cpu_f64": rel(card[k], cpu64[k]),
                  "cpu_vs_cpu_f64": rel(cpu[k], cpu64[k])}
        check(res[k]["card_vs_cpu_f64"]
              <= max(2 * res[k]["cpu_vs_cpu_f64"], 1e-5),
              f"ResNet-50 batch 2 f32 {k}: card {res[k]}")
        check(bool(torch.isfinite(card[k]).all()), f"ResNet-50 {k}: "
              "non-finite on the card")
    say(f"ResNet-50 batch 2 f32, card against the CPU (relative L2; "
        f"{time.perf_counter() - t0:.1f} s): {json.dumps(res)}")
    return res


def suite_loss(model, takes_generator: bool):
    """benchmarks/image_suite.py's loss: bf16 over f32 masters, training
    mode with dropout drawn from the batch's generator (none: no
    dropout), the loss as f32."""
    import torch

    def loss_fn(params, x, y, generator=None):
        kw = ({"train": True, "generator": generator} if takes_generator
              else {})
        return model.call(cast_tree(params, torch.bfloat16),
                          x.to(torch.bfloat16), y, method="loss",
                          **kw).to(torch.float32)
    return loss_fn


def image_suite_phase(say, seed: int, device="cuda") -> dict:
    """(d) The batch-64 rows of benchmarks/image_suite.py (SmallNet 32²,
    AlexNet and GoogleNet 224²; random weights and data from the seed)
    trained by ``Trainer.train`` with Momentum(0.01, 0.9), bf16 over f32,
    training mode with dropout live (a card generator in every batch,
    through the graph), 12 steps over 4 batches on both routes: one
    replay a step, finite costs, a falling loss on batch 0 without
    dropout; ms a batch."""
    import torch
    from paddle_tpu_torch import models
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.trainer import Trainer
    make = {"smallnet": models.SmallNet, "alexnet": models.AlexNet,
            "googlenet": models.GoogleNet}
    out = {}
    for name, image, classes in SUITE:
        model = make[name](classes=classes).init(seed, device)
        takes = name != "smallnet"
        data = image_batches(seed, RESNET_NBUF, device, SUITE_BATCH, image,
                             classes)
        gen = torch.Generator(device=device).manual_seed(seed)
        batches = [b + (gen,) for b in data] if takes else data
        probe = [data[0] + (None,)] if takes else None

        def make_trainer():
            gen.manual_seed(seed)       # both routes draw the same masks
            return Trainer(suite_loss(model, takes),
                           Momentum(SUITE_LR, 0.9), device=device)
        launches, steps = train_and_time(
            say, name, make_trainer, model.tree(), batches, SUITE_PASSES, 0,
            device, names=(), probe=probe)
        check(not launches, f"{name}: the port's kernels launched "
              f"{launches}")
        out[name] = {r: GRAPH_PATHS[-1][r]["wall_ms_per_step"]
                     for r in ("eager", "graphed")}
        del model, data, batches
        torch.cuda.empty_cache()
    say(f"image_suite rows at batch 64, ms a batch eager -> graphed: "
        f"{json.dumps(out)}")
    return out


def image_phase(say, seed: int, device="cuda") -> dict:
    """Phase 13: (a) the image ops card against CPU, (b) ResNet-50 trained
    at the bench's shape and recipe on both routes, (c) ResNet-50 batch 2
    f32 card against CPU, (d) the image_suite rows, (e) the stem and BN
    route timings. Returns the figures."""
    import torch
    from paddle_tpu_torch.models import resnet50
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.trainer import Trainer
    figs = {}
    image_op_checks(say, seed, device)
    figs["card_vs_cpu_batch2"] = resnet_card_vs_cpu(say, seed, device)
    model = resnet50(RESNET_CLASSES).init(seed, device)
    batches = image_batches(seed, RESNET_NBUF, device, RESNET_BATCH,
                            RESNET_IMAGE, RESNET_CLASSES)
    flops = step_flops(lambda: resnet50(RESNET_CLASSES), RESNET_BATCH,
                       RESNET_IMAGE)
    momentum = lambda: Momentum(RESNET_LR, RESNET_MU)
    # cuDNN's backward may pick an algorithm that sums in another order
    # from call to call: the f32 graphed step is held to the eager one
    # under cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        graph_step_check(say, "ResNet-50", resnet_loss(model,
                                                        torch.float32),
                         model.tree(), batches[0], RESNET_LR, device,
                         make_opt=momentum, expect_launches=False)
    finally:
        torch.backends.cudnn.deterministic = False
    torch.cuda.empty_cache()
    figs["resnet50_repeated_batch"] = repeated_batch_check(
        say, Trainer(resnet_loss(model, torch.bfloat16), momentum(),
                     device=device), model.tree(), batches[0])
    launches, steps = train_and_time(
        say, "ResNet-50", lambda: Trainer(resnet_loss(model, torch.bfloat16),
                                          momentum(), device=device),
        model.tree(), batches, RESNET_PASSES, 0, device, names=(),
        falls=False)
    check(not launches, f"ResNet-50: the port's kernels launched {launches}")
    say("ResNet-50 training: the port's kernel launches (LAUNCHES) stayed 0 "
        "on both routes: the image path runs none of the twelve kernels")
    row = GRAPH_PATHS[-1]
    figs["resnet50"] = {}
    for route in ("eager", "graphed"):
        ms = row[route]["wall_ms_per_step"]
        dev_ms = row[route]["device_ms_per_step"]
        figs["resnet50"][route] = {
            "ms_per_step": ms, "images_per_s": RESNET_BATCH / ms * 1e3,
            "device_ms_per_step": dev_ms,
            "busy_share": row[route]["busy_share"],
            "step_tflop": flops / 1e12,
            "bf16_peak_share_wall": flops / (ms / 1e3) / PEAK_FLOPS[
                "bfloat16"],
            "bf16_peak_share_device": (flops / (dev_ms / 1e3) / PEAK_FLOPS[
                "bfloat16"]) if dev_ms else None}
    say(f"ResNet-50 bs{RESNET_BATCH} {RESNET_IMAGE}² bf16 train-mode BN "
        f"(figures a step): {json.dumps(figs['resnet50'])}")
    tr = Trainer(resnet_loss(model, torch.bfloat16), momentum(),
                 device=device)
    run = lambda: tr.train(lambda: batches[:2], model.tree())
    run()                                            # capture, warm
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    figs["resnet50_split"] = kernel_split(
        say, "ResNet-50 bf16 step (graphed)", run, 2,
        time.perf_counter() - t0)
    del tr, model, batches
    torch.cuda.empty_cache()
    figs["suite"] = image_suite_phase(say, seed, device)
    figs["routes"] = image_route_timings(say, seed, device)
    return figs


# ---------------------------------------------------------------------------
# phase 14: the whole training loop over the flagship
# ---------------------------------------------------------------------------

# 3 passes of 8 batches and a test pass of 2 batches after each pass;
# the preemption after pass 1's batch 3; the poisoned batch of the skip
# check; the prefetch watchdog
LOOP_BATCHES, LOOP_TEST_BATCHES, LOOP_PASSES = 8, 2, 3
LOOP_PREEMPT, LOOP_POISON, LOOP_TIMEOUT = (1, 3), 3, 120.0


def loop_rows(seed: int, n_batches: int, poison=None,
              batch=TEXTCLS_BATCH, vocab=TEXTCLS["vocab"]):
    """A reader creator of ``n_batches`` row batches of the flagship's
    rows, from ``seed``: (ids as a list, lengths 30..100; the label, the
    parity of the last id; [scale]); the rows of batch ``poison`` have
    scale inf."""
    import numpy as np

    def reader():
        rs = np.random.RandomState(seed)
        for b in range(n_batches):
            rows = []
            for n in rs.randint(TEXTCLS_MIN_LEN, TEXTCLS_LEN + 1, batch):
                ids = rs.randint(0, vocab, n)
                rows.append((ids.tolist(), int(ids[-1] % 2),
                             [float("inf") if b == poison else 1.0]))
            yield rows
    return reader


def loop_feeder(device):
    from paddle_tpu_torch.data import (DataFeeder, DenseSlot, IndexSlot,
                                       SeqSlot)
    return DataFeeder([SeqSlot(), IndexSlot(), DenseSlot(1)], device=device)


def loop_fns(model, dtype):
    """The loop's loss (each row's cross-entropy times its scale; in bf16
    the f32 masters cast as phase 5 casts them) and the evaluators'
    outputs (logits, the positive class's probability, labels), one
    forward for both (``shared_forward``)."""
    import torch
    from paddle_tpu_torch.ops.loss import softmax_with_cross_entropy
    from paddle_tpu_torch.trainer import shared_forward

    @shared_forward
    def logits(p, sb):
        if dtype != torch.float32:
            p = cast_tree(p, dtype)
        return model.call(p, sb).to(torch.float32)

    def loss(p, sb, y, sc):
        return torch.mean(softmax_with_cross_entropy(logits(p, sb), y)
                          * sc[:, 0])

    def outputs(p, sb, y, sc):
        lg = logits(p, sb)
        return {"logits": lg, "probs": torch.softmax(lg, -1)[:, 1],
                "labels": y}
    return loss, outputs


def loop_trainer(model, dtype, device, evaluators=True, **kw):
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.trainer import (AucEvaluator,
                                          ClassificationErrorEvaluator,
                                          SumEvaluator, Trainer)
    loss, outs = loop_fns(model, dtype)
    if evaluators:
        kw.update(outputs_fn=outs, evaluators=[
            ClassificationErrorEvaluator(), AucEvaluator(), SumEvaluator()])
    return Trainer(loss, Adam(TEXTCLS_LR), device=device,
                   prefetch_timeout=LOOP_TIMEOUT, **kw)


def check_results(what, res) -> None:
    """Evaluator results finite and in range (the AUC, an f32 sum of
    trapezoids as in JAX, within 2**-20 of [0, 1])."""
    import numpy as np
    check(res is not None and {"classification_error", "accuracy", "auc",
                               "avg_cost", "sum_cost"} <= set(res),
          f"{what}: evaluator result {res}")
    check(all(np.isfinite(v) for v in res.values()),
          f"{what}: a non-finite evaluator result {res}")
    check(all(-2.0 ** -20 <= res[k] <= 1.0 + 2.0 ** -20
              for k in ("classification_error", "accuracy", "auc")),
          f"{what}: a rate out of [0, 1]: {res}")


def tree_max_diff(a, b) -> dict:
    """Per leaf, the largest absolute difference of two trees with the same
    paths and dtypes."""
    from paddle_tpu_torch.core.pytree import tree_items
    want = dict(tree_items(b))
    check(sorted(want) == sorted(p for p, _ in tree_items(a)),
          "the trees have different paths")
    out = {}
    for path, x in tree_items(a):
        y = want[path]
        check(x.dtype == y.dtype and x.shape == y.shape,
              f"trees differ at {path}")
        out["/".join(path)] = (x.double() - y.double().to(x.device)
                               ).abs().max().item()
    return out


def stamped_run(run):
    """run(event_handler) with the host clock at each EndIteration: (out,
    ms per step after the first two: median, p10, p90, costs)."""
    import numpy as np
    from paddle_tpu_torch.trainer import event
    stamps, costs, results = [], [], []

    def on_event(e):
        if isinstance(e, event.EndIteration):
            stamps.append(time.perf_counter())
            costs.append(e.cost)
            results.append(e.evaluator_result)
    t0 = time.perf_counter()
    out = run(on_event)
    ms = np.diff([t0] + stamps)[2:] * 1e3
    return out, {"ms_per_step_median": float(np.median(ms)),
                 "ms_per_step_p10": float(np.percentile(ms, 10)),
                 "ms_per_step_p90": float(np.percentile(ms, 90))}, \
        costs, results


def dir_bytes(d: str) -> int:
    return sum(os.path.getsize(os.path.join(r, f))
               for r, _, fs in os.walk(d) for f in fs)


def one_pass_walls(run) -> list:
    """The walls in seconds of two calls of ``run`` (one pass each), each
    up to the card's end of its work."""
    import torch
    walls = []
    for _ in range(2):
        t1 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
    return walls


def loop_phase(say, seed: int, device="cuda") -> dict:
    """The flagship trained as a user trains it: rows from a reader
    through ``DataFeeder`` and the ``DoubleBuffer`` prefetch thread into
    ``Trainer.train`` with ``outputs_fn``, three evaluators, a test
    reader and a checkpoint a pass; beside it the bare graphed step of
    the same batches (and one f32 step of the first fed batch against
    the plain route's); then preempt-and-resume and the f32 runs it must
    equal, the skip policy on a poisoned batch against the run without
    it, a checkpoint written on the card loaded on the CPU and back, and
    the seconds and bytes of a pass checkpoint and of a resume."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from paddle_tpu_torch.core.pytree import tree_items, tree_map
    from paddle_tpu_torch.models import LSTMTextCls
    from paddle_tpu_torch.trainer import event
    from paddle_tpu_torch.trainer.checkpoint import (load_checkpoint,
                                                     save_checkpoint)
    cfg = TEXTCLS
    model = LSTMTextCls(cfg["vocab"], cfg["embed"], cfg["hidden"],
                        cfg["classes"], pool="last").init(seed, device)
    reader = loop_rows(seed + 1, LOOP_BATCHES)
    test_reader = loop_rows(seed + 2, LOOP_TEST_BATCHES)
    feeder = loop_feeder(device)
    tmp = tempfile.mkdtemp(prefix="loop_")
    figs = {}
    try:
        # (a) the loop, warmed (its step and test graphs captured) first
        tr = loop_trainer(model, torch.bfloat16, device)
        tr.train(loop_rows(seed + 3, 1), model.tree(), feeder=feeder,
                 test_reader=loop_rows(seed + 4, 1), handle_signals=False)
        tr.output_dir = os.path.join(tmp, "main")
        passes = []
        tests = []

        def on_pass(e):
            if isinstance(e, event.EndPass):
                passes.append(e.evaluator_result)
            elif isinstance(e, event.TestResult):
                tests.append((e.cost, e.evaluator_result))

        def loop_run(on_event):
            def handler(e):
                on_event(e)
                on_pass(e)
            return counted(lambda: tr.train(
                reader, model.tree(), num_passes=LOOP_PASSES,
                event_handler=handler, feeder=feeder,
                test_reader=test_reader, handle_signals=False))

        tr.stats.reset()
        (res, wall, launches, disp), loop_ms, costs, results = \
            stamped_run(loop_run)
        p, state = res
        host = {k: {"ms_avg": v.avg * 1e3, "count": v.count}
                for k, v in tr.stats.items().items()}
        steps = LOOP_PASSES * LOOP_BATCHES
        tests_n = LOOP_PASSES * LOOP_TEST_BATCHES
        say(f"training loop (bf16, {steps} steps, feeder + prefetch + "
            f"evaluators + test + checkpoints): costs {json.dumps(costs)}; "
            f"test costs {[t[0] for t in tests]}; launches {launches}; "
            f"dispatches {json.dumps(disp)}")
        check(int(state["step"]) == steps and len(costs) == steps,
              f"loop: {len(costs)} steps ran, want {steps}")
        check(all(np.isfinite(costs)), "loop: a non-finite cost")
        first, last = (np.mean(costs[:LOOP_BATCHES]),
                       np.mean(costs[-LOOP_BATCHES:]))
        check(last < first, f"loop: the mean cost of a pass did not fall: "
              f"{first} -> {last}")
        want = {"lstm_seq_train": steps, "lstm_seq_bwd": steps,
                "lstm_seq": tests_n}
        check(launches == want, f"loop: launches {launches}, want {want}")
        check(step_dispatches(disp, "step") == {"captures": 0,
                                                "replays": steps},
              f"loop: step graphs {step_dispatches(disp, 'step')}, want "
              f"one replay a step")
        check(step_dispatches(disp, "loss") == {"captures": 0,
                                                "replays": tests_n},
              f"loop: test graphs {step_dispatches(disp, 'loss')}")
        graph_launch_check(say, "training loop")
        for i, r in enumerate(results):
            check_results(f"loop step {i}", r)
        for i, r in enumerate(passes):
            check_results(f"loop pass {i}", r)
        for i, (c, r) in enumerate(tests):
            check(np.isfinite(c), f"loop test {i}: cost {c}")
            check_results(f"loop test {i}", r)
        check(sorted(os.listdir(tr.output_dir)) ==
              [f"pass-{i:05d}" for i in range(LOOP_PASSES)],
              f"loop: checkpoints {os.listdir(tr.output_dir)}")
        say(f"training loop evaluators: last step {json.dumps(results[-1])};"
            f" passes {json.dumps(passes)}; tests {json.dumps(tests)}")
        say(f"training loop host timers (StatSet): {json.dumps(host)} "
            f"(TrainBatch: the step's copy-in and graph launch; Eval: the "
            f"evaluators' update and result, host reads included)")
        figs["loop"] = dict(loop_ms, launches=launches, costs=costs,
                            passes=passes, tests=tests, host_timers=host)

        # (b) the bare graphed step of the same batches, fed beforehand
        fed = [feeder(rows) for rows in reader()]
        sb, y, _ = fed[0]
        f32_step_check(say, model, (sb.data, sb.lengths, y), device,
                       what=f"f32 step of the loop's first fed batch "
                            f"(B={sb.batch_size} T={sb.max_len})")
        bare = loop_trainer(model, torch.bfloat16, device, evaluators=False)
        bare.train(lambda: fed[:1], model.tree())
        (res_b, _, bare_launches, bare_disp), bare_ms, bare_costs, _ = \
            stamped_run(lambda on: counted(lambda: bare.train(
                lambda: fed, model.tree(), num_passes=LOOP_PASSES,
                event_handler=on)))
        check(bare_launches == {"lstm_seq_train": steps,
                                "lstm_seq_bwd": steps},
              f"bare step: launches {bare_launches}")
        check(step_dispatches(bare_disp, "step")["replays"] == steps,
              f"bare step: dispatches {bare_disp}")
        # both replay the same kernels and ops on the same batches from the
        # same weights (the evaluators' outputs read the loss's forward)
        diff = max(abs(a - b) for a, b in zip(costs, bare_costs))
        say(f"training loop against the bare graphed step of the same "
            f"batches: costs max difference {diff!r}")
        check(diff == 0.0, f"loop: costs differ from the bare step's by "
              f"{diff!r}")
        figs["bare"] = bare_ms

        # busy share of one pass of each (no test pass, no checkpoint)
        tr.output_dir = None
        runs = {"loop": lambda: tr.train(reader, model.tree(), feeder=feeder,
                                         handle_signals=False),
                "bare": lambda: bare.train(lambda: fed, model.tree())}
        for what, run in runs.items():
            walls = one_pass_walls(run)
            figs[what]["pass_wall_ms_per_step"] = min(walls) * 1e3 / \
                LOOP_BATCHES
            figs[what]["profile"] = profile_breakdown(
                say, f"training {what} (one pass of {LOOP_BATCHES} steps)",
                run, min(walls), steps=LOOP_BATCHES)
        say(f"training loop vs bare graphed step, ms a step: median of the "
            f"gaps between steps over {steps - 2} steps (3 passes, test "
            f"passes and checkpoints between them): loop "
            f"{loop_ms['ms_per_step_median']:.4f}, bare "
            f"{bare_ms['ms_per_step_median']:.4f}; one pass's wall over "
            f"{LOOP_BATCHES} steps (best of 2, no test, no checkpoint): "
            f"{figs['loop']['pass_wall_ms_per_step']:.4f} vs "
            f"{figs['bare']['pass_wall_ms_per_step']:.4f}; busy share of "
            f"that one-pass wall "
            f"{(figs['loop']['profile'] or {}).get('busy_share')} vs "
            f"{(figs['bare']['profile'] or {}).get('busy_share')}")
        del bare, fed

        # (c) a checkpoint written on the card, on the CPU and back
        cp, cs, st = load_checkpoint(os.path.join(tmp, "main"),
                                     device="cpu")
        check(st == {"pass_id": LOOP_PASSES - 1, "version": 1,
                     "pass_complete": True}, f"checkpoint state {st}")
        check(all(v == 0.0 for v in tree_max_diff(
            tree_map(lambda t: t.cpu(), p), cp).values()),
            "the card's checkpoint differs from the trained params on "
            "the CPU")
        save_checkpoint(os.path.join(tmp, "cpu"), 0, cp, cs)
        back, back_s, _ = load_checkpoint(os.path.join(tmp, "cpu"),
                                          device=device)
        check(all(v == 0.0 for v in tree_max_diff(back, cp).values())
              and int(back_s["step"]) == steps,
              "the CPU's checkpoint differs on the card")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        save_checkpoint(os.path.join(tmp, "timed"), 0, p, state)
        save_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        lp, ls, _ = load_checkpoint(os.path.join(tmp, "timed"),
                                    device=device)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t1
        nbytes = dir_bytes(os.path.join(tmp, "timed", "pass-00000"))
        figs["checkpoint"] = {"save_s": save_s, "resume_load_s": load_s,
                              "bytes": nbytes}
        say(f"checkpoint of the flagship's trees (params + Adam state): "
            f"{nbytes} bytes, saved (host copy, tar, fsync, rename) in "
            f"{save_s:.4f} s, loaded back onto the card in {load_s:.4f} s; "
            f"the card's pass checkpoint loaded on the CPU and, re-saved "
            f"there, on the card, bit-equal")
        del tr, lp, ls, cp, cs, back, back_s

        # (d) preempt and resume in f32 against the uninterrupted run
        f32 = loop_trainer(model, torch.float32, device)
        f32.train(loop_rows(seed + 3, 1), model.tree(), feeder=feeder,
                  handle_signals=False)
        want_p, want_s = f32.train(reader, model.tree(),
                                   num_passes=LOOP_PASSES, feeder=feeder,
                                   handle_signals=False)
        f32.output_dir = os.path.join(tmp, "f32")

        def preempt(e):
            if isinstance(e, event.EndIteration) and \
                    (e.pass_id, e.batch_id) == LOOP_PREEMPT:
                f32.request_preemption()

        f32.train(reader, model.tree(), num_passes=LOOP_PASSES,
                  feeder=feeder, event_handler=preempt,
                  handle_signals=False)
        check(f32.preempted and f32.train_stats["preemptions"] == 1,
              "f32: the preemption did not stop the run")
        (got_p, got_s), _, res_launches, res_disp = counted(
            lambda: f32.train(reader, model.tree(),
                              num_passes=LOOP_PASSES - LOOP_PREEMPT[0],
                              feeder=feeder, resume=True,
                              handle_signals=False))
        rest = steps - (LOOP_PREEMPT[0] * LOOP_BATCHES + LOOP_PREEMPT[1]
                        + 1)
        check(step_dispatches(res_disp, "step") == {"captures": 0,
                                                    "replays": rest},
              f"f32 resume: step graphs {res_disp}, want {rest} replays")
        pd_ = tree_max_diff(got_p, want_p)
        sd_ = tree_max_diff(got_s, want_s)
        say(f"f32 preempt at pass {LOOP_PREEMPT[0]} batch {LOOP_PREEMPT[1]}"
            f" and resume against the uninterrupted run: params "
            f"{json.dumps(pd_)}; opt_state {json.dumps(sd_)}")
        check(max(pd_.values()) == 0.0 and max(sd_.values()) == 0.0,
              "f32: resume is not bit-equal to the uninterrupted run")
        figs["resume"] = {"bit_equal": True, "replays": rest}
        del f32, want_p, want_s, got_p, got_s

        # (e) skip: a poisoned batch against the run without it (bf16)
        sk = loop_trainer(model, torch.bfloat16, device,
                          on_nonfinite="skip")
        sk.train(loop_rows(seed + 3, 1), model.tree(), feeder=feeder,
                 handle_signals=False)
        poisoned = loop_rows(seed + 1, LOOP_BATCHES, poison=LOOP_POISON)
        clean = lambda: (b for i, b in enumerate(poisoned())
                         if i != LOOP_POISON)
        (skip_p, skip_s), _, _, _ = counted(lambda: sk.train(
            poisoned, model.tree(), feeder=feeder, handle_signals=False))
        clean_p, clean_s = sk.train(clean, model.tree(), feeder=feeder,
                                    handle_signals=False)
        check(sk.train_stats["skipped_batches"] == 1,
              f"skip: {dict(sk.train_stats)}")
        pd_ = tree_max_diff(skip_p, clean_p)
        sd_ = tree_max_diff(skip_s, clean_s)
        say(f"skip (bf16): the poisoned batch {LOOP_POISON} skipped; "
            f"against the run without it: params {json.dumps(pd_)}; "
            f"opt_state {json.dumps(sd_)}; step {int(skip_s['step'])} vs "
            f"{int(clean_s['step'])}")
        check(max(pd_.values()) == 0.0 and max(sd_.values()) == 0.0
              and int(skip_s["step"]) == LOOP_BATCHES - 1,
              "skip: not bit-equal to the run without the batch")
        figs["skip"] = {"bit_equal": True}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return figs



# ---------------------------------------------------------------------------
# phase 15: the data plane from files
# ---------------------------------------------------------------------------

# 2 batches a chunk, so a re-dispatched task leaves every batch whole; a
# task timeout far past a pass, so no task is handed out twice mid-pass
DATA_CHUNK, DATA_TASK_TIMEOUT = 2 * TEXTCLS_BATCH, 600.0
# the nested DataFormat rows of (d): sub-sequences a row, ids a sub-sequence
DATA_SUBSEQS, DATA_SUBLEN = 8, 32


class RecordingMaster:
    """A ``TaskMaster`` whose task ids handed out, failed and finished are
    recorded (the master keeps no failure count past a finished task)."""

    def __init__(self, master):
        self.m = master
        self.handed, self.failed, self.finished = [], [], []

    def get_task(self):
        task = self.m.get_task()
        if task is not None:
            self.handed.append(task[0])
        return task

    def stats(self):
        return self.m.stats()

    def task_failed(self, tid):
        self.failed.append(tid)
        return self.m.task_failed(tid)

    def task_finished(self, tid):
        self.finished.append(tid)
        self.m.task_finished(tid)

    def new_pass(self):
        return self.m.new_pass()


def nested_rows(seed: int, n: int, vocab: int):
    """``n`` DataFormat rows: (dense [3], label, ids, sub-sequences of
    ids)."""
    import numpy as np
    rs = np.random.RandomState(seed)
    return [(rs.randn(3).astype(np.float32), int(rs.randint(2)),
             rs.randint(0, vocab, int(rs.randint(1, 65))).tolist(),
             [rs.randint(0, vocab, int(rs.randint(0, DATA_SUBLEN + 1)))
              .tolist() for _ in range(int(rs.randint(1, DATA_SUBSEQS + 1)))])
            for _ in range(n)]


def nested_body(emb, w, nb):
    """The embedding of every id of a ``NestedSeqBatch``, averaged over
    each sub-sequence's valid steps, summed over each row's valid
    sub-sequences, then a product: a nested model's head."""
    import torch
    inner = nb.inner_flat()
    m = inner.mask()
    x = emb[inner.data.long()] * m[..., None]
    mean = x.sum(1) / m.sum(-1, keepdim=True).clamp(min=1.0)
    outer = nb.outer(mean)
    return torch.tanh((outer.data * outer.mask()[..., None]).sum(1) @ w)


def data_phase(say, seed: int, loop_figs: dict, device="cuda") -> dict:
    """The flagship of phase 14 fed from files: its rows written to
    recordio chunks and trained from ``chunk_reader`` (bit-equal to the
    in-memory pass) and from ``cloud_reader`` over a ``TaskMaster`` with
    an injected task failure; the ``ckpt.write`` and ``step.grad`` faults
    in the trainer; a DataFormat file with nested sequences through the
    feeder on the card and a graphed body over its ``NestedSeqBatch``."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from paddle_tpu_torch import faults
    from paddle_tpu_torch.core import graphs
    from paddle_tpu_torch.core.graphs import GraphCache
    from paddle_tpu_torch.data import (DataFeeder, DenseSlot, IndexSlot,
                                       SeqSlot, batch)
    from paddle_tpu_torch.data import format as fmt
    from paddle_tpu_torch.data.chunks import (chunk_reader, cloud_reader,
                                              dump_to_chunks)
    from paddle_tpu_torch.models import LSTMTextCls
    from paddle_tpu_torch.runtime import TaskMaster
    from paddle_tpu_torch.runtime import lib as hostlib
    from paddle_tpu_torch.trainer import event
    from paddle_tpu_torch.trainer.checkpoint import (latest_pass,
                                                     load_checkpoint,
                                                     pass_dir,
                                                     verify_checkpoint)
    cfg = TEXTCLS
    B = TEXTCLS_BATCH
    figs = {}
    hb = hostlib.load()
    figs["host_library"] = {"built": hb.built, "seconds": hb.seconds}
    say(f"host runtime library (native/'s five sources, g++ -O2): "
        f"{'built in %.2f s' % hb.seconds if hb.built else 'cached'} -> "
        f"{hb.path.name}")
    model = LSTMTextCls(cfg["vocab"], cfg["embed"], cfg["hidden"],
                        cfg["classes"], pool="last").init(seed, device)
    mem_reader = loop_rows(seed + 1, LOOP_BATCHES)
    mem_test = loop_rows(seed + 2, LOOP_TEST_BATCHES)
    rows = [r for b in mem_reader() for r in b]
    test_rows = [r for b in mem_test() for r in b]
    feeder = loop_feeder(device)
    tmp = tempfile.mkdtemp(prefix="data_")
    steps, tests_n = LOOP_BATCHES, LOOP_TEST_BATCHES
    want_launches = {"lstm_seq_train": steps, "lstm_seq_bwd": steps,
                     "lstm_seq": tests_n}
    try:
        # (a) chunks: written, then one pass from them against the same
        # pass from the rows in memory, through one warmed trainer
        t1 = time.perf_counter()
        paths = dump_to_chunks(lambda: iter(rows), os.path.join(tmp, "c"),
                               samples_per_chunk=DATA_CHUNK)
        write_s = time.perf_counter() - t1
        test_paths = dump_to_chunks(lambda: iter(test_rows),
                                    os.path.join(tmp, "t"),
                                    samples_per_chunk=DATA_CHUNK)
        nbytes = sum(os.path.getsize(p) for p in paths)
        check(len(paths) == len(rows) // DATA_CHUNK,
              f"chunks: {len(paths)} files for {len(rows)} rows")
        figs["chunks"] = {"rows": len(rows), "files": len(paths),
                          "bytes": nbytes, "write_s": write_s,
                          "bytes_per_row": nbytes / len(rows)}
        say(f"chunks: {len(rows)} rows of the flagship (ids 30..100, label, "
            f"scale) pickled (protocol 4) into {len(paths)} recordio files "
            f"of {DATA_CHUNK} rows, {nbytes} bytes "
            f"({nbytes / len(rows):.1f} a row), written in {write_s:.4f} s")
        check(list(chunk_reader(paths)()) == rows,
              "chunks: the rows read back differ from those written")
        file_reader = batch(chunk_reader(paths), B)
        file_test = batch(chunk_reader(test_paths), B)
        tr = loop_trainer(model, torch.bfloat16, device)
        tr.train(loop_rows(seed + 3, 1), model.tree(), feeder=feeder,
                 test_reader=loop_rows(seed + 4, 1), handle_signals=False)

        def one_pass(reader, test):
            costs = []

            def on_event(e):
                if isinstance(e, event.EndIteration):
                    costs.append(e.cost)
            out = counted(lambda: tr.train(
                reader, model.tree(), feeder=feeder, test_reader=test,
                event_handler=on_event, handle_signals=False))
            return out, costs

        ((mem_p, _), _, mem_l, _), mem_costs = one_pass(mem_reader,
                                                        mem_test)
        ((file_p, file_s), _, file_l, file_d), file_costs = \
            one_pass(file_reader, file_test)
        diff = tree_max_diff(file_p, mem_p)
        say(f"one pass from the chunks (chunk_reader -> batch -> DataFeeder "
            f"-> DoubleBuffer -> graphed step, a test pass from chunks): "
            f"costs {json.dumps(file_costs)}; launches {file_l}; "
            f"dispatches {json.dumps(file_d)}; params against the pass "
            f"from the rows in memory: max difference "
            f"{max(diff.values())!r}")
        check(file_costs == mem_costs and len(file_costs) == steps,
              f"chunks: costs {file_costs} differ from the in-memory pass's "
              f"{mem_costs}")
        check(max(diff.values()) == 0.0 and int(file_s["step"]) == steps,
              "chunks: params not bit-equal to the in-memory pass's")
        check(file_l == want_launches == mem_l,
              f"chunks: launches {file_l} (memory {mem_l}), want "
              f"{want_launches}")
        check(step_dispatches(file_d, "step") == {"captures": 0,
                                                  "replays": steps}
              and step_dispatches(file_d, "loss") == {"captures": 0,
                                                      "replays": tests_n},
              f"chunks: dispatches {file_d}, want one replay a step and a "
              f"test batch")
        figs["chunk_pass"] = {"costs": file_costs, "launches": file_l,
                              "bit_equal": True}
        figs["launches"] = file_l

        # the loop's ms a step and busy share, chunks beside memory, in
        # turns (memory, chunks, chunks, memory), one pass, no test pass
        runs = {"memory": lambda: tr.train(mem_reader, model.tree(),
                                           feeder=feeder,
                                           handle_signals=False),
                "chunks": lambda: tr.train(file_reader, model.tree(),
                                           feeder=feeder,
                                           handle_signals=False)}
        walls = {k: [] for k in runs}
        for what in ("memory", "chunks", "chunks", "memory"):
            walls[what] += one_pass_walls(runs[what])
        timing = {}
        for what, run in runs.items():
            best = min(walls[what])
            prof = profile_breakdown(
                say, f"training loop from {what} (one pass of {steps} "
                f"steps)", run, best, steps=steps)
            timing[what] = {"pass_wall_ms_per_step": best * 1e3 / steps,
                            "walls_ms_per_step": [w * 1e3 / steps
                                                  for w in walls[what]],
                            "busy_share": (prof or {}).get("busy_share"),
                            "device_ms_per_step":
                                (prof or {}).get("device_ms_per_step")}
        figs["timing"] = timing
        p14 = loop_figs.get("loop", {})
        say(f"training loop, ms a step over one pass (best of 4 walls, in "
            f"turns): from chunks "
            f"{timing['chunks']['pass_wall_ms_per_step']:.4f} (busy "
            f"{timing['chunks']['busy_share']}), from memory "
            f"{timing['memory']['pass_wall_ms_per_step']:.4f} (busy "
            f"{timing['memory']['busy_share']}); phase 14's loop in this "
            f"run: {p14.get('pass_wall_ms_per_step')} ms a step, busy "
            f"{(p14.get('profile') or {}).get('busy_share')}")

        # the host alone: rows a second through chunk_reader, and through
        # chunk_reader + batch + the feeder onto the card
        def rate(fn, n):
            t1 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            return n / (time.perf_counter() - t1)

        host = {}
        for _ in range(2):
            for what, fn in (
                    ("chunk_reader", lambda: sum(1 for _ in
                                                 chunk_reader(paths)())),
                    ("chunk_reader + feeder", lambda: [
                        feeder(b) for b in file_reader()]),
                    ("memory + feeder", lambda: [feeder(b)
                                                 for b in mem_reader()])):
                host[what] = max(host.get(what, 0.0), rate(fn, len(rows)))
        figs["host_rows_per_s"] = host
        say(f"host alone, rows a second (best of 2 over {len(rows)} rows): "
            + "; ".join(f"{k} {v:.0f}" for k, v in host.items()))

        # (b) the cloud reader over a TaskMaster, the first task failing
        master = RecordingMaster(TaskMaster(timeout_s=DATA_TASK_TIMEOUT,
                                            failure_max=3))
        master.m.set_dataset(paths)
        plan = faults.FaultPlan(seed=seed)
        plan.add("reader.next", "raise", nth=1,
                 exc=OSError("injected chunk read failure"))
        with plan.installed():
            got = list(cloud_reader(master)())
        first = master.handed[0]
        handed, failed = list(master.handed), list(master.failed)
        say(f"cloud_reader over TaskMaster ({len(paths)} tasks): handed "
            f"{master.handed}, failed {master.failed}, finished "
            f"{master.finished}; fired {plan.fired}; stats (todo, pending, "
            f"done, discarded, epoch) {master.stats()}; {len(got)} rows")
        check(sorted(map(repr, got)) == sorted(map(repr, rows)),
              "cloud_reader: the rows delivered are not the rows written, "
              "each exactly once")
        check(master.failed == [first] and master.handed.count(first) == 2
              and len(master.handed) == len(paths) + 1
              and sorted(master.finished) == sorted(set(master.handed))
              and master.stats() == (0, 0, len(paths), 0, 0),
              "cloud_reader: the failed task was not re-dispatched once")
        check(master.new_pass(), "cloud_reader: the pass did not end")
        plan = faults.FaultPlan(seed=seed)
        plan.add("reader.next", "raise", nth=1,
                 exc=OSError("injected chunk read failure"))
        costs = []
        with plan.installed():
            (_, _, cl_l, cl_d) = counted(lambda: tr.train(
                batch(cloud_reader(master), B), model.tree(), feeder=feeder,
                test_reader=file_test, handle_signals=False,
                event_handler=lambda e: costs.append(e.cost)
                if isinstance(e, event.EndIteration) else None))
        say(f"one pass from cloud_reader (the first task failing on the "
            f"prefetch thread, re-dispatched last): costs "
            f"{json.dumps(costs)}; launches {cl_l}; fired {plan.fired}")
        check(len(costs) == steps and all(np.isfinite(costs)),
              f"cloud pass: costs {costs}")
        check(plan.fired == [("reader.next", 1, "raise")]
              and master.stats() == (0, 0, len(paths), 0, 1),
              f"cloud pass: fired {plan.fired}, stats {master.stats()}")
        check(cl_l == want_launches
              and step_dispatches(cl_d, "step")["replays"] == steps,
              f"cloud pass: launches {cl_l}, dispatches {cl_d}")
        figs["cloud"] = {"rows_exactly_once": True, "handed": handed,
                         "failed": failed, "launches": cl_l, "costs": costs}

        # (c1) step.grad corrupting batch 3's cost under "raise"
        plan = faults.FaultPlan(seed=seed)
        plan.add("step.grad", "corrupt", nth=3)
        raised = None
        with plan.installed():
            try:
                tr.train(file_reader, model.tree(), feeder=feeder,
                         handle_signals=False)
            except FloatingPointError as e:
                raised = str(e)
        say(f"step.grad corrupting the third step's cost, "
            f"on_nonfinite='raise': {raised!r}")
        check(raised is not None and "pass 0 batch 2" in raised
              and plan.fired == [("step.grad", 3, "corrupt")],
              f"step.grad: the trainer did not raise at batch 2 ({raised})")
        del tr

        # (c2) ckpt.write truncating the last pass's params.tar (f32)
        f32 = loop_trainer(model, torch.float32, device)
        f32.train(loop_rows(seed + 3, 1), model.tree(), feeder=feeder,
                  handle_signals=False)
        want_p, want_s = f32.train(file_reader, model.tree(),
                                   num_passes=LOOP_PASSES, feeder=feeder,
                                   handle_signals=False)
        out = os.path.join(tmp, "ckpt")
        f32.output_dir = out
        members = 3                     # params.tar, opt_state.tar, state
        plan = faults.FaultPlan(seed=seed)
        plan.add("ckpt.write", "truncate",
                 nth=(LOOP_PASSES - 1) * members + 1)
        with plan.installed():
            f32.train(file_reader, model.tree(), num_passes=LOOP_PASSES,
                      feeder=feeder, handle_signals=False)
        last = pass_dir(out, LOOP_PASSES - 1)
        torn = os.path.getsize(os.path.join(last, "params.tar"))
        _, _, st = load_checkpoint(out, device=device)
        say(f"ckpt.write truncating pass {LOOP_PASSES - 1}'s params.tar to "
            f"{torn} bytes: fired {plan.fired}; newest pass "
            f"{latest_pass(out)}, newest verified "
            f"{latest_pass(out, verify=True)}, loaded pass {st['pass_id']}")
        check(plan.fired == [("ckpt.write", (LOOP_PASSES - 1) * members + 1,
                              "truncate")]
              and latest_pass(out) == LOOP_PASSES - 1
              and not verify_checkpoint(last)
              and latest_pass(out, verify=True) == LOOP_PASSES - 2
              and st["pass_id"] == LOOP_PASSES - 2,
              "ckpt.write: the torn pass was not refused")
        (got_p, got_s), _, _, res_d = counted(lambda: f32.train(
            file_reader, model.tree(), num_passes=1, feeder=feeder,
            resume=True, handle_signals=False))
        pd_ = tree_max_diff(got_p, want_p)
        sd_ = tree_max_diff(got_s, want_s)
        say(f"resume after the torn pass (retrains pass "
            f"{LOOP_PASSES - 1}) against the run with no fault: params max "
            f"difference {max(pd_.values())!r}, opt_state "
            f"{max(sd_.values())!r}; step graphs "
            f"{step_dispatches(res_d, 'step')}")
        check(max(pd_.values()) == 0.0 and max(sd_.values()) == 0.0
              and verify_checkpoint(last),
              "ckpt.write: the resumed run is not bit-equal to the run "
              "with no fault")
        check(step_dispatches(res_d, "step") == {"captures": 0,
                                                 "replays": steps},
              f"ckpt.write: the resume did not replay its graph ({res_d})")
        figs["faults"] = {"step_grad_raised": raised,
                          "truncated_bytes": torn,
                          "resume_bit_equal": True}
        del f32, want_p, want_s, got_p, got_s

        # (d) a DataFormat file with nested sequences, the feeder on the
        # card against the CPU's, a graphed body over its NestedSeqBatch
        schema = [fmt.SlotDef(fmt.DENSE, 3), fmt.SlotDef(fmt.INDEX),
                  fmt.SlotDef(fmt.INDEX, 0, fmt.SEQ),
                  fmt.SlotDef(fmt.INDEX, 0, fmt.SUB_SEQ)]
        nrows = nested_rows(seed + 5, B, cfg["vocab"])
        path = os.path.join(tmp, "rows.ptdf")
        with open(path, "wb") as f:
            w = fmt.DataWriter(f, schema)
            for r in nrows:
                w.write(r)
        back = list(fmt.reader_creator(path)())
        check(len(back) == B and all(
            np.array_equal(a[0], b[0]) and a[1:] == tuple(b[1:])
            for a, b in zip(back, nrows)),
            "DataFormat: the rows read back differ from those written")
        slots = [DenseSlot(3), IndexSlot(), SeqSlot(), SeqSlot(nested=True)]
        on_card = DataFeeder(slots, device=device)(back)
        on_cpu = DataFeeder(slots, device="cpu")(back)
        pairs = [(on_card[0], on_cpu[0]), (on_card[1], on_cpu[1]),
                 (on_card[2].data, on_cpu[2].data),
                 (on_card[2].lengths, on_cpu[2].lengths)] + \
            [(getattr(on_card[3], f), getattr(on_cpu[3], f))
             for f in ("data", "sub_lengths", "seq_lengths")]
        check(all(a.device.type == "cuda" and a.dtype == b.dtype
                  and torch.equal(a.cpu(), b) for a, b in pairs),
              "nested feeder: the card's tensors differ from the CPU's")
        nb = on_card[3]
        gen = torch.Generator(device=device).manual_seed(seed)
        emb = model.tree()["embed"]["w"]
        wout = torch.randn(cfg["embed"], 16, generator=gen, device=device)
        cache = GraphCache("data_phase", device)
        inputs = {"emb": emb, "w": wout, "nb": nb}
        graphs.reset_dispatch_counts()
        cache.run("nested", nested_body, inputs)         # eager, capture
        graphed = cache.run("nested", nested_body, inputs)
        disp = json.loads(json.dumps(graphs.DISPATCHES))
        eager = nested_body(emb, wout, nb)
        ref = nested_body(emb.cpu(), wout.cpu(), on_cpu[3])
        g_err = (graphed - eager).abs().max().item()
        err = (graphed.cpu() - ref).abs().max().item()
        say(f"nested batch [B, S, T] = {list(nb.data.shape)} from the "
            f"DataFormat file: the card's feeder bit-equal to the CPU's; "
            f"graphed body ({json.dumps(disp)}) against eager: max abs "
            f"{g_err!r}, against the CPU: max abs {err:.3e}")
        check(step_dispatches(disp, "nested") == {"captures": 1,
                                                  "replays": 1},
              f"nested: dispatches {disp}")
        # the product's GEMM may pick another algorithm under capture: the
        # graph step checks' loss bound (f32, TF32 off)
        check(g_err <= GRAPH_STEP_LOSS_RTOL * eager.abs().max().item(),
              f"nested: the graphed body differs from the eager one by "
              f"{g_err}")
        check(err <= 1e-5 * max(1.0, ref.abs().max().item()),
              f"nested: the card's body differs from the CPU's by {err}")
        figs["nested"] = {"shape": list(nb.data.shape),
                          "graph_max_abs_err": g_err,
                          "cpu_max_abs_err": err}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return figs

# ---------------------------------------------------------------------------
# phase 16: the model zoo and its ops
# ---------------------------------------------------------------------------

# the BiLSTM-CRF tagger at the flagship's widths (benchmarks/lstm_textcls.py
# :28-33) over conll05's 9 IOB tags (4 chunk types and O), batch 64,
# padded length 100, lengths 30..100
TAGGER = dict(vocab_size=30000, num_tags=9, embed_dim=128, hidden=256)
TAGGER_CHUNK_TYPES = 4
ZOO_STEPS, ZOO_LR = 12, 2e-3
# ConvTextCls at the flagship's vocabulary and width: 128 filters over a
# context of 3
CONVTEXT = dict(vocab_size=30000, embed_dim=128, num_filters=128,
                context_len=3, classes=2)
# the fluid book's word2vec (embed 32, hidden 256, 4 context words, batch
# 100) over imikolov's vocabulary; the recommender at dim 32 over the
# movielens constants (batch 256, 6 category slots); DeepFM over the
# criteo layout (13 dense, 26 hashed fields) at the DeepFM paper's widths
# (Guo et al., 2017: factor 10, three hidden layers of 400), hash 2**20,
# batch 4096
W2V = dict(embed_dim=32, context=4, hidden=256)
W2V_BATCH = 100
REC_DIM, REC_BATCH, REC_SLOTS = 32, 256, 6
DEEPFM = dict(hash_size=2 ** 20, num_fields=26, dense_dim=13, factor=10,
              hidden=(400, 400, 400))
DEEPFM_BATCH = 4096
# examples/gan_vae_mnist.py: data 784, noise 32, hidden 128, VAE latent 16,
# batch 64; Adam 2e-4 (GAN) and 1e-3 (VAE); the VAE's loss must fall
# below 0.8 of its first within the example's 300 steps
GAN_CFG = dict(data_dim=784, noise_dim=32, hidden=128)
VAE_CFG = dict(data_dim=784, latent=16, hidden=128)
GEN_BATCH, GAN_LR, VAE_LR, VAE_STEPS, VAE_FALL = 64, 2e-4, 1e-3, 300, 0.8
# SSD300's six prior maps (feature side, min size, max size, aspect
# ratios): 8732 priors; 21 classes (VOC), batch 8, keep_top_k 100
SSD300_MAPS = ((38, 30.0, 60.0, (2.0,)), (19, 60.0, 111.0, (2.0, 3.0)),
               (10, 111.0, 162.0, (2.0, 3.0)), (5, 162.0, 213.0, (2.0, 3.0)),
               (3, 213.0, 264.0, (2.0,)), (1, 264.0, 315.0, (2.0,)))
SSD_CLASSES, SSD_BATCH, SSD_KEEP, SSD_GTS = 21, 8, 100, 8
# the zoo's ops on the card against the same code on the CPU, both f32
# with TF32 off: the same arithmetic in another summation order, so
# rtol 1e-4 and atol 1e-5 of the largest magnitude (at least 1); integer
# results (tags, tokens, indices, NMS keeps) equal
ZOO_RTOL, ZOO_ATOL = 1e-4, 1e-5


def zoo_close(got, want, what: str) -> float:
    """Hold a card result against the CPU's (ZOO_RTOL, ZOO_ATOL; integer
    and bool results equal); returns the max abs difference."""
    import torch
    got, want = got.detach().cpu(), want.detach().cpu()
    check(got.shape == want.shape, f"{what}: shape {tuple(got.shape)} != "
          f"{tuple(want.shape)}")
    if not want.dtype.is_floating_point:
        check(torch.equal(got, want), f"{what}: differs from the CPU")
        return 0.0
    err = (got - want).abs().max().item() if want.numel() else 0.0
    atol = ZOO_ATOL * max(want.abs().max().item() if want.numel() else 0.0,
                          1.0)
    check(torch.allclose(got, want, rtol=ZOO_RTOL, atol=atol),
          f"{what}: card differs from the CPU by {err} (atol {atol})")
    return err


def zoo_train(say, what, loss, params, batch, device, names=(),
              per_step=0, lr=ZOO_LR, steps=ZOO_STEPS, share_of=None,
              reseed=None, falls=True):
    """One f32 Adam step through the trainer's graph against the eager step
    (``graph_step_check``), then ``steps`` steps on one repeated batch on
    the eager route and through the graph (the first step of each route
    unmeasured: the graphed one captures), counted: ``per_step`` launches
    of each kernel of ``names`` a step (none of the port's kernels without
    ``names``), one replay a step, finite costs that fall (printed only
    with ``falls=False``). ``share_of`` {label: kernel-name substrings}:
    those kernels' share of one eager step's device time (and its top
    kernels). ``reseed()``
    starts each route (and each step of ``graph_step_check``) from the
    same generator state. Returns the figures."""
    import numpy as np
    import torch
    from paddle_tpu_torch.core.pytree import tree_map
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.trainer import Trainer
    graph_step_check(say, what, loss, params, batch, lr, device,
                     expect_launches=bool(names), reseed=reseed)
    figs = {}
    for route in ("eager", "graphed"):
        tr = Trainer(loss, Adam(lr), device=device)
        state = {"p": tree_map(torch.clone, params)}
        state["s"] = tr.opt.init(state["p"])

        def step():
            state["p"], state["s"], c = tr.step(state["p"], state["s"],
                                                *batch)
            return c

        if reseed:
            reseed()
        with _route(route):
            costs = [step().item()]
            out, wall, launches, disp = counted(
                lambda: [step() for _ in range(steps - 1)])
            costs += [c.item() for c in out]
            n = steps - 1
            fig = {"ms_per_step": wall * 1e3 / n, "costs": costs,
                   "launches_per_step": {k: v / n
                                         for k, v in launches.items()}}
            check(all(np.isfinite(costs))
                  and (costs[-1] < costs[0] or not falls),
                  f"{what} ({route}): the cost of a repeated batch did "
                  f"not fall: {costs}")
            check(fig["launches_per_step"] == {k: per_step for k in names},
                  f"{what} ({route}): launches a step "
                  f"{fig['launches_per_step']}, want {per_step} of each of "
                  f"{names}")
            replays = step_dispatches(disp, "step")
            check(replays == ({"captures": 0, "replays": n}
                              if route == "graphed"
                              else {"captures": 0, "replays": 0}),
                  f"{what} ({route}): step graphs {replays}")
            if route == "eager" and share_of:
                # the eager step's kernels are the graph's (the counts
                # above), and the profiler can drop the records of a fast
                # replay's first kernels
                rows, _ = device_rows(step)
                total = sum(r[0] for r in rows)
                check(total > 0, f"{what}: the profiler saw no device time")
                fig["device_ms_per_step"] = total / 1e3
                fig["share"] = {
                    label: sum(r[0] for r in rows
                               if any(k in r[2] for k in keys)) / total
                    for label, keys in share_of.items()}
                fig["top_kernels_ms"] = [(r[2][:100], r[1], r[0] / 1e3)
                                         for r in sorted(rows,
                                                         reverse=True)[:8]]
        figs[route] = fig
        del tr, state
    diff = max(abs(a - b) for a, b in zip(figs["eager"]["costs"],
                                          figs["graphed"]["costs"]))
    figs["graphed_vs_eager_max_cost_diff"] = diff
    say(f"zoo {what}: {steps} f32 Adam steps on one repeated batch, eager "
        f"and graphed (smoke figures, not a benchmark): "
        f"{json.dumps(figs)}")
    return figs


def tagger_zoo(say, seed: int, device="cuda") -> dict:
    """(a) The BiLSTM-CRF tagger: one f32 step through the kernels against
    the plain route's, the graphed step against the eager one, 12 steps a
    route (2 #9 and 2 #10 a step), then ``decode`` through its graph (2
    #8 a call) against the plain route's tags, and a test pass of
    ``ChunkEvaluator`` over the decoded tags of 2 held batches
    (``tools/tagger_step_profile.py`` splits the step's device time)."""
    import numpy as np
    import torch
    from paddle_tpu_torch.core import SeqBatch, graphs
    from paddle_tpu_torch.core.pytree import tree_get
    from paddle_tpu_torch.models import BiLSTMCRFTagger
    from paddle_tpu_torch.ops import crf
    from paddle_tpu_torch.trainer import ChunkEvaluator
    model = BiLSTMCRFTagger(**TAGGER).init(seed, device)
    rs = np.random.RandomState(seed + 16)

    def batch():
        data = rs.randint(0, TAGGER["vocab_size"], (TEXTCLS_BATCH,
                                                    TEXTCLS_LEN))
        lens = rs.randint(TEXTCLS_MIN_LEN, TEXTCLS_LEN + 1, TEXTCLS_BATCH)
        tags = rs.randint(0, TAGGER["num_tags"], (TEXTCLS_BATCH,
                                                  TEXTCLS_LEN))
        return tuple(torch.as_tensor(a.astype(np.int32), device=device)
                     for a in (data, lens, tags))

    train, held = batch(), [batch() for _ in range(2)]

    def loss_for(route):
        return lambda p, d, ln, t: model.call(p, SeqBatch(d, ln), t,
                                              route=route, method="loss")

    f32_step_check(say, model, train, device, "zoo tagger f32 step",
                   loss_for=loss_for, lr=ZOO_LR)
    names = ("lstm_seq_train", "lstm_seq_bwd")
    figs = zoo_train(say, "tagger", loss_for(None), model.tree(), train,
                     device, names=names, per_step=2)
    # decode with weights trained a few steps
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.trainer import Trainer
    tr = Trainer(loss_for(None), Adam(ZOO_LR), device=device)
    p, s = model.tree(), tr.opt.init(model.tree())
    for _ in range(4):
        p, s, _ = tr.step(p, s, *train)
    with torch.no_grad():
        for name, leaf in model.named_parameters():
            leaf.copy_(tree_get(p, tuple(name.split("."))))
    evaluator = ChunkEvaluator(TAGGER_CHUNK_TYPES)
    launches = {}
    dec = {}
    for i, (d, ln, t) in enumerate(held):
        sb = SeqBatch(d, ln)
        if i == 0:
            model.decode(sb)                               # the capture
        (tags, score), wall, n, disp = counted(lambda: model.decode(sb))
        check(n == {"lstm_seq": 2}
              and step_dispatches(disp, "decode") == {"captures": 0,
                                                      "replays": 1},
              f"tagger decode: launches {n}, dispatches {disp}")
        for k, v in n.items():
            launches[k] = launches.get(k, 0) + v
        with graphs.disabled():
            ptags, pscore = model.decode(sb, route="plain")
            _, ewall, _, _ = counted(lambda: model.decode(sb))
        same = torch.equal(tags, ptags)
        if not same:
            # another path of (nearly) the same score: compare the scores
            # of both paths under the same emissions
            with torch.no_grad():
                em = model.emissions(sb, route="plain")
                sk = crf.crf_score(em, tags, ln, model.crf.start,
                                   model.crf.end, model.crf.trans)
                sp = crf.crf_score(em, ptags, ln, model.crf.start,
                                   model.crf.end, model.crf.trans)
            say(f"tagger decode batch {i}: tags differ from the plain "
                f"route's at {int((tags != ptags).sum())} steps; best-path "
                f"scores {sk.tolist()} vs {sp.tolist()}")
            zoo_close(sk, sp, "tagger decode: best-path scores")
        zoo_close(score, pscore, f"tagger decode batch {i}: Viterbi scores")
        check(not tags[ln == 0].any() and torch.equal(
            tags * (torch.arange(TEXTCLS_LEN, device=device)[None]
                    < ln[:, None]), tags), "tagger decode: tags past a "
              "length are not 0")
        evaluator.update(pred_tags=tags, label_tags=t, lengths=ln)
        dec[f"batch{i}"] = {"tags_equal_plain": same,
                            "ms_graphed": wall * 1e3,
                            "ms_eager": ewall * 1e3}
    res = evaluator.result()
    check(all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in res.values()),
          f"tagger: chunk evaluator {res}")
    say(f"zoo tagger decode: {json.dumps(dec)}; launches {launches}; "
        f"ChunkEvaluator over the decoded tags {json.dumps(res)}")
    figs.update(decode=dec, decode_launches=launches, chunk=res)
    return figs


def embedding_zoo(say, seed: int, device="cuda") -> dict:
    """(b) ConvTextCls, (c) Word2Vec, Recommender and DeepFM: the graphed
    step against the eager step, 12 steps a route on one repeated batch,
    ms a step; DeepFM's embedding backward's share of a step."""
    import numpy as np
    import torch
    from paddle_tpu_torch.core import SeqBatch
    from paddle_tpu_torch.data.dataset import imikolov, movielens
    from paddle_tpu_torch.models import (ConvTextCls, DeepFM, Recommender,
                                         Word2Vec)
    rs = np.random.RandomState(seed + 17)
    dev = lambda a: torch.as_tensor(a, device=device)
    ints = lambda hi, *shape: dev(rs.randint(0, hi, shape).astype(np.int32))
    out = {}
    conv = ConvTextCls(**CONVTEXT).init(seed, device)
    out["convtext"] = zoo_train(
        say, "ConvTextCls",
        lambda p, d, ln, y: conv.call(p, SeqBatch(d, ln), y), conv.tree(),
        textcls_batches(seed + 17, 1, device)[0], device)
    w2v = Word2Vec(imikolov.VOCAB, **W2V).init(seed, device)
    out["word2vec"] = zoo_train(
        say, "Word2Vec", lambda p, c, t: w2v.call(p, c, t, method="loss"),
        w2v.tree(), (ints(imikolov.VOCAB, W2V_BATCH, W2V["context"]),
                     ints(imikolov.VOCAB, W2V_BATCH)), device)
    rec = Recommender(movielens.USERS, movielens.MOVIES,
                      movielens.CATEGORIES, movielens.JOBS, movielens.AGES,
                      dim=REC_DIM).init(seed, device)
    out["recommender"] = zoo_train(
        say, "Recommender",
        lambda p, *b: rec.call(p, *b, method="loss"), rec.tree(),
        (ints(movielens.USERS, REC_BATCH), ints(2, REC_BATCH),
         ints(movielens.AGES, REC_BATCH), ints(movielens.JOBS, REC_BATCH),
         ints(movielens.MOVIES, REC_BATCH),
         ints(movielens.CATEGORIES, REC_BATCH, REC_SLOTS),
         dev((rs.rand(REC_BATCH, REC_SLOTS) > 0.5).astype(np.float32)),
         dev(rs.uniform(1, 5, REC_BATCH).astype(np.float32))), device)
    fm = DeepFM(**DEEPFM).init(seed, device)
    out["deepfm"] = zoo_train(
        say, "DeepFM", lambda p, *b: fm.call(p, *b, method="loss"),
        fm.tree(),
        (dev(rs.randn(DEEPFM_BATCH, DEEPFM["dense_dim"]).astype(np.float32)),
         ints(DEEPFM["hash_size"], DEEPFM_BATCH, DEEPFM["num_fields"]),
         ints(2, DEEPFM_BATCH)), device,
        share_of={"embedding backward (indexing_backward)":
                  ("indexing_backward",)})
    with torch.no_grad():
        prob = fm.predict_proba(*(t for t in (
            dev(rs.randn(8, DEEPFM["dense_dim"]).astype(np.float32)),
            ints(DEEPFM["hash_size"], 8, DEEPFM["num_fields"]))))
    check(bool(((prob > 0) & (prob < 1)).all()), f"DeepFM.predict_proba "
          f"{prob.tolist()}")
    return out


def example_rows(n: int):
    """The rows of examples/gan_vae_mnist.py ``batches``: x = tanh(z A + b)
    on a fixed rank-8 manifold (RandomState(0))."""
    import numpy as np
    rs = np.random.RandomState(0)
    A = rs.randn(8, 784).astype(np.float32) * 0.6
    b = rs.randn(784).astype(np.float32) * 0.1
    z = rs.randn(n, 8).astype(np.float32)
    return np.tanh(z @ A + b)


def generative_zoo(say, seed: int, device="cuda") -> dict:
    """(d) The GAN's D step and G step, one graph each, each Adam moving
    only its own half (the other half's leaves detached, as
    ``GAN.split_grads`` splits them), on both routes; the VAE step as one
    graph with a card generator, 12 steps a route, then the example's 300
    steps and its 0.8 factor."""
    import numpy as np
    import torch
    from paddle_tpu_torch.core.pytree import tree_get, tree_items, tree_map
    from paddle_tpu_torch.models import GAN, VAE
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.trainer import Trainer
    rows = torch.as_tensor(example_rows(2048), device=device)
    data = [rows[i:i + GEN_BATCH] for i in range(0, 2048, GEN_BATCH)]
    gen = torch.Generator().manual_seed(seed + 18)
    zs = [torch.randn((GEN_BATCH, GAN_CFG["noise_dim"]),
                      generator=gen).to(device) for _ in range(2 * ZOO_STEPS)]
    gan = GAN(**GAN_CFG).init(seed, device)

    def frozen(p, half):
        g, d = GAN.split_grads(p)
        keep, other = (g, d) if half == "d" else (d, g)
        return {**keep, **tree_map(torch.Tensor.detach, other)}

    d_loss = lambda p, real, z: gan.call(frozen(p, "g"), real, z,
                                         method="d_loss")
    g_loss = lambda p, z: gan.call(frozen(p, "d"), z, method="g_loss")
    graph_step_check(say, "GAN D", d_loss, gan.tree(), (data[0], zs[0]),
                     GAN_LR, device, expect_launches=False)
    graph_step_check(say, "GAN G", g_loss, gan.tree(), (zs[1],), GAN_LR,
                     device, expect_launches=False)
    figs, finals = {}, {}
    for route in ("eager", "graphed"):
        d_tr = Trainer(d_loss, Adam(GAN_LR), device=device)
        g_tr = Trainer(g_loss, Adam(GAN_LR), device=device)
        p = tree_map(torch.clone, gan.tree())
        sd, sg = d_tr.opt.init(p), g_tr.opt.init(p)
        losses = []

        def alternate(i, p, sd, sg):
            before = tree_map(torch.clone, p)
            p, sd, dl = d_tr.step(p, sd, data[i % len(data)], zs[2 * i])
            moved_d = GAN.split_grads(tree_map(torch.clone, p))
            p, sg, gl = g_tr.step(p, sg, zs[2 * i + 1])
            return p, sd, sg, dl, gl, before, moved_d

        with _route(route):
            p, sd, sg, *_ = alternate(0, p, sd, sg)        # the captures

            def run():
                nonlocal p, sd, sg
                out = []
                for i in range(1, ZOO_STEPS):
                    p, sd, sg, dl, gl, before, after_d = alternate(i, p, sd,
                                                                   sg)
                    out.append((dl, gl, before, after_d,
                                tree_map(torch.clone, p)))
                return out

            out, wall, launches, disp = counted(run)
        for dl, gl, before, (g_after_d, d_after_d), after in out:
            g0, d0 = GAN.split_grads(before)
            g1, d1 = GAN.split_grads(after)
            check(all(torch.equal(a, b) for (_, a), (_, b) in
                      zip(tree_items(g0), tree_items(g_after_d))),
                  "GAN: the D step moved the generator")
            check(all(torch.equal(a, b) for (_, a), (_, b) in
                      zip(tree_items(d_after_d), tree_items(d1))),
                  "GAN: the G step moved the discriminator")
            check(not all(torch.equal(a, b) for (_, a), (_, b) in
                          zip(tree_items(d0), tree_items(d_after_d))),
                  "GAN: the D step did not move the discriminator")
            losses.append((dl.item(), gl.item()))
        n = ZOO_STEPS - 1
        check(all(np.isfinite(losses).ravel()), f"GAN: losses {losses}")
        check(not launches, f"GAN: launches of the port's kernels "
              f"{launches}")
        want = n if route == "graphed" else 0
        for key in ("step",):
            got = step_dispatches(disp, key)
            check(got == {"captures": 0, "replays": 2 * want},
                  f"GAN ({route}): step graphs {got}, want {want} D and "
                  f"{want} G replays")
        figs[route] = {"ms_per_d_plus_g_step": wall * 1e3 / n,
                       "losses": losses}
        finals[route] = losses
    diff = max(abs(a - b) for x, y in zip(finals["eager"], finals["graphed"])
               for a, b in zip(x, y))
    figs["graphed_vs_eager_max_loss_diff"] = diff
    say(f"zoo GAN: {ZOO_STEPS} D + G steps a route (smoke figures, not a "
        f"benchmark): {json.dumps(figs)}")
    out = {"gan": figs}

    vae = VAE(**VAE_CFG).init(seed, device)
    vae_loss = lambda p, x, g: vae.call(p, x, g, method="loss")
    vgen = torch.Generator(device=device).manual_seed(seed)
    # 12 steps draw 12 noises: the cost is held to fall over the
    # example's 300 steps below, not over these
    vfigs = zoo_train(say, "VAE", vae_loss, vae.tree(), (data[0], vgen),
                      device, lr=VAE_LR, reseed=lambda: vgen.manual_seed(seed),
                      falls=False)
    tr = Trainer(vae_loss, Adam(VAE_LR), device=device)
    p = tree_map(torch.clone, vae.tree())
    s = tr.opt.init(p)
    vgen.manual_seed(seed + 1)
    costs = []
    t0 = time.perf_counter()
    for i in range(VAE_STEPS):
        p, s, c = tr.step(p, s, data[i % len(data)], vgen)
        costs.append(c)
    costs = [c.item() for c in costs]
    wall = time.perf_counter() - t0
    check(all(np.isfinite(costs)), "VAE: a non-finite cost")
    fell = costs[-1] < VAE_FALL * costs[0]
    say(f"zoo VAE: {VAE_STEPS} graphed steps (the example's), cost "
        f"{costs[0]!r} -> {costs[-1]!r} ({'below' if fell else 'NOT below'}"
        f" {VAE_FALL} of the first), {wall * 1e3 / VAE_STEPS:.3f} ms a step "
        f"(costs read after the loop)")
    check(fell, f"VAE: the cost did not fall below {VAE_FALL} of the "
          f"first in {VAE_STEPS} steps: {costs[0]} -> {costs[-1]}")
    with torch.no_grad():
        for name, leaf in vae.named_parameters():
            leaf.copy_(tree_get(p, tuple(name.split("."))))
    smp = vae.sample(torch.Generator(device=device).manual_seed(1), 4)
    check(smp.shape == (4, 784) and bool(((smp >= 0) & (smp <= 1)).all()),
          "VAE.sample: out of [0, 1]")
    vfigs["example_steps"] = {"first": costs[0], "last": costs[-1],
                              "steps": VAE_STEPS, "fell_below": VAE_FALL}
    out["vae"] = vfigs
    return out


def ssd300_priors(device):
    """SSD300's 8732 priors and variances (SSD300_MAPS) on ``device``."""
    import torch
    from paddle_tpu_torch.ops import detection as D
    boxes, var = zip(*(D.prior_box((f, f), (300, 300), lo, hi, ars,
                                   device=device)
                       for f, lo, hi, ars in SSD300_MAPS))
    return torch.cat(boxes), torch.cat(var)


def zoo_op_checks(say, seed: int, device="cuda") -> dict:
    """(e) The zoo's ops on the card against the same code on the CPU:
    the CRF at the tagger's shape, CTC (loss with its gradient, also
    against ``F.ctc_loss`` on the feasible rows, and the greedy decode),
    SSD300's priors, multibox loss with its gradient, NMS and the
    detection output over a vmapped batch of 8, NCE and the hierarchical
    sigmoid with their gradients, the sequence ops, and the CTC-error and
    detection-mAP evaluators over card outputs against the CPU's."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import crf, ctc, nce
    from paddle_tpu_torch.ops import detection as D
    from paddle_tpu_torch.ops import sequence as S
    from paddle_tpu_torch.trainer import (CTCErrorEvaluator,
                                          DetectionMAPEvaluator)
    gen = torch.Generator().manual_seed(seed + 19)
    r = lambda *s, k=1.0: torch.randn(s, generator=gen) * k
    ri = lambda lo, hi, *s: torch.randint(lo, hi, s, generator=gen)
    errs = {}

    def both(what, fn, args, diff=()):
        """fn on the card and on the CPU (gradients of sum(out0) for the
        inputs in ``diff``); every output held; the card's outputs."""
        res = {}
        for dev in ("cpu", device):
            a = [t.to(dev) if isinstance(t, torch.Tensor) else t
                 for t in args]
            for i in diff:
                a[i] = a[i].clone().requires_grad_(True)
            out = fn(*a)
            outs = list(out) if isinstance(out, tuple) else [out]
            if diff:
                outs += list(torch.autograd.grad(outs[0].sum(),
                                                 [a[i] for i in diff]))
            res[str(dev)] = [o.detach() for o in outs]
        errs[what] = max(zoo_close(g, w, f"{what} [{j}]") for j, (g, w) in
                         enumerate(zip(res[str(device)], res["cpu"])))
        return res[str(device)], res["cpu"]

    B, T, N = TEXTCLS_BATCH, TEXTCLS_LEN, TAGGER["num_tags"]
    lens = ri(TEXTCLS_MIN_LEN, T + 1, B)
    crf_args = [r(B, T, N), r(N, k=0.05), r(N, k=0.05), r(N, N, k=0.05)]
    tags = ri(0, N, B, T)
    both("crf_loss", lambda e, s, n, t, tg, ln: crf.crf_loss(
        e, tg, ln, s, n, t), crf_args + [tags, lens], (0, 1, 2, 3))
    both("crf_decode", lambda e, s, n, t, ln: crf.crf_decode(e, ln, s, n, t),
         crf_args + [lens])

    Bc, Tc, V, L = 16, 50, 30, 20
    lp = torch.log_softmax(r(Bc, Tc, V, k=2.0), -1)
    il = ri(30, Tc + 1, Bc)
    ll = ri(0, L + 1, Bc)
    ll[0], il[1], ll[1] = 0, 10, L                 # empty; infeasible
    labels = ri(1, V, Bc, L)
    (loss_k, grad_k), _ = both("ctc_loss", lambda a, b, c, d: ctc.ctc_loss(
        a, b, c, d), [lp, il, labels, ll], (0,))
    check(bool(torch.isfinite(loss_k).all() and torch.isfinite(grad_k).all()),
          "ctc_loss: non-finite on the card")
    ref = F.ctc_loss(lp.to(device).transpose(0, 1), labels.to(device).long(),
                     il.to(device).long(), ll.to(device).long(),
                     reduction="none", zero_infinity=False)
    feasible = torch.isfinite(ref)
    check(not bool(feasible[1]), "ctc: the infeasible row is feasible")
    errs["ctc_loss_vs_F.ctc_loss"] = (loss_k[feasible] - ref[feasible]
                                      ).abs().max().item()
    check(torch.allclose(loss_k[feasible], ref[feasible], rtol=1e-4,
                         atol=1e-4), f"ctc_loss: against F.ctc_loss on the "
          f"feasible rows by {errs['ctc_loss_vs_F.ctc_loss']}")
    (dec_k, dl_k), (dec_c, dl_c) = both(
        "ctc_greedy_decode", lambda a, b: ctc.ctc_greedy_decode(a, b),
        [lp, il])
    ev = {}
    for dev, (dec, dl) in (("card", (dec_k, dl_k)), ("cpu", (dec_c, dl_c))):
        e = CTCErrorEvaluator()
        on = device if dev == "card" else "cpu"
        e.update(decoded=dec, decoded_lengths=dl, labels=labels.to(on),
                 label_lengths=ll.to(on))
        e.update(log_probs=lp.to(on), logit_lengths=il.to(on),
                 labels=labels.to(on), label_lengths=ll.to(on))
        ev[dev] = e.result()
    check(ev["card"] == ev["cpu"], f"CTCErrorEvaluator: card {ev['card']} "
          f"!= CPU {ev['cpu']}")

    pri_k, var_k = ssd300_priors(device)
    pri_c, var_c = ssd300_priors("cpu")
    errs["prior_box"] = max(zoo_close(pri_k, pri_c, "SSD300 priors"),
                            zoo_close(var_k, var_c, "SSD300 variances"))
    P = pri_c.shape[0]
    check(P == 8732, f"SSD300: {P} priors, want 8732")
    xy = torch.rand((SSD_BATCH, SSD_GTS, 2), generator=gen) * 0.7
    gt = torch.cat([xy, xy + 0.05 + 0.25 * torch.rand(
        (SSD_BATCH, SSD_GTS, 2), generator=gen)], -1)
    n_gt = ri(1, SSD_GTS + 1, SSD_BATCH)
    gmask = (torch.arange(SSD_GTS)[None] < n_gt[:, None]).float()
    glab = ri(1, SSD_CLASSES, SSD_BATCH, SSD_GTS)
    loc, conf = r(SSD_BATCH, P, 4, k=0.3), r(SSD_BATCH, P, SSD_CLASSES,
                                               k=2.0)

    def mbox(lc, cf, g, gl, m):
        pr, vr = pri_c.to(lc.device), var_c.to(lc.device)
        return torch.func.vmap(lambda a, b, c, d, e: D.multibox_loss(
            a, b, pr, vr, c, d, e))(lc, cf, g, gl, m)

    both("multibox_loss", mbox, [loc, conf, gt, glab, gmask], (0, 1))

    def detect(lc, cf):
        pr, vr = pri_c.to(lc.device), var_c.to(lc.device)
        return torch.func.vmap(lambda a, b: D.detection_output(
            a, b, pr, vr, num_classes=SSD_CLASSES,
            keep_top_k=SSD_KEEP))(lc, cf)

    det_k, det_c = both("detection_output", detect, [loc, conf * 2.0])
    both("nms", lambda bx, sc: D.nms(bx, sc, top_k=SSD_KEEP),
         [D.decode_boxes(loc[0], pri_c, var_c), torch.softmax(conf[0], -1)
          [:, 3]])
    maps = {}
    for dev, (bx, sc, valid) in (("card", det_k), ("cpu", det_c)):
        e = DetectionMAPEvaluator(SSD_CLASSES)
        for i in range(SSD_BATCH):
            keep = valid[i] > 0
            cls = (torch.arange(1, SSD_CLASSES, device=bx.device)[:, None]
                   .expand(-1, keep.shape[1]))
            det = torch.cat([cls[keep][:, None].float(),
                             sc[i][keep][:, None], bx[i][keep]], 1)
            g = torch.cat([glab[i][:n_gt[i], None].float(),
                           gt[i][:n_gt[i]]], 1)
            e.update(detections=det, gt=g)
        maps[dev] = e.result()
    check(maps["card"] == maps["cpu"], f"DetectionMAPEvaluator: card "
          f"{maps['card']} != CPU {maps['cpu']}")

    Bn, Dn, Vn, Sn = 256, 128, 10000, 64
    neg = nce._draw_negatives(torch.Generator().manual_seed(seed), Vn, Sn,
                              device="cpu")
    both("nce_loss", lambda h, w, b, y, ng: nce._nce_from_negatives(
        h, y, w, b, ng), [r(Bn, Dn), r(Vn, Dn, k=0.1), r(Vn, k=0.1),
                          ri(0, Vn, Bn), neg], (0, 1, 2))
    paths, codes = nce.build_huffman_codes(Vn, device="cpu")
    both("hsigmoid_loss", lambda h, w, b, y, p_, c_: nce.hsigmoid_loss(
        h, y, w, b, p_, c_), [r(Bn, Dn), r(2 * Vn, Dn, k=0.1),
                              r(2 * Vn, k=0.1), ri(0, Vn, Bn), paths, codes],
         (0, 1, 2))

    x = r(B, T, 128)
    both("sequence_pool", lambda a, ln: torch.stack([
        S.sequence_pool(a, ln, pool) for pool in
        ("average", "sum", "sqrt", "max", "min", "last", "first")]),
        [x, lens], (0,))
    both("context_projection", lambda a, ln, w: S.context_projection(
        a, ln, -2, 5, w), [x, lens, r(4, 128)], (0, 2))
    both("sequence_conv", lambda a, ln, f: S.sequence_conv(a, ln, f, -1, 3),
         [x, lens, r(384, 128, k=0.05)], (0, 2))
    both("sequence_reverse_slice_concat", lambda a, ln: (
        S.sequence_reverse(a, ln),
        S.sequence_slice(a, ln, ln // 3, ln // 2, 60),
        S.sequence_concat(a, ln, a[:, :40], ln.clamp(max=40))[0]),
        [x, lens], (0,))
    both("kmax_seq_score", lambda a, ln: S.kmax_seq_score(
        torch.round(a * 2.0), ln, 10), [x[..., 0], lens])
    say(f"zoo ops on the card against the CPU (f32, TF32 off; rtol "
        f"{ZOO_RTOL}, atol {ZOO_ATOL} of the largest magnitude; integer "
        f"results equal): max abs differences {json.dumps(errs)}; "
        f"CTCErrorEvaluator {json.dumps(ev['card'])}; DetectionMAPEvaluator "
        f"{json.dumps(maps['card'])} (both equal to the CPU's)")
    return {"max_abs_err": errs, "ctc_error": ev["card"],
            "detection_map": maps["card"]}


def lm_options_zoo(say, seed: int, device="cuda") -> dict:
    """(f) GPT-2 small (phase 7's configuration): one f32 loss and gradient
    with ``remat=True`` bit-equal to ``remat=False``, #1 twice a block and
    #2/#3 once, the peak memory of both, then one Adam step of each
    through the trainer's graph (the recompute inside the capture), the
    loss and every updated parameter bit-equal; then ``tie_head=False``
    trained 4 f32 steps on one repeated batch through the trainer's
    graph."""
    import numpy as np
    import torch
    from paddle_tpu_torch.core.pytree import tree_items, tree_map
    from paddle_tpu_torch.models import TransformerLM
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.trainer import Trainer
    rs = np.random.RandomState(seed + 20)
    ids = torch.as_tensor(rs.randint(0, GPT2_TRAIN["vocab"], (
        LM_BATCH, LM_SEQ)).astype(np.int32), device=device)
    res, figs, stepped = {}, {}, {}
    for remat in (False, True):
        model = TransformerLM(**GPT2_TRAIN, remat=remat).init(seed, device)
        leaves = tree_map(lambda t: t.detach().requires_grad_(True),
                          model.tree())

        def run():
            loss = model.call(leaves, ids, method="loss")
            return loss, torch.autograd.grad(
                loss, [v for _, v in tree_items(leaves)])

        run()                                              # warm
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        (loss, grads), wall, launches, _ = counted(run)
        res[remat] = (loss, grads, launches)
        figs["remat" if remat else "plain"] = {
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "ms_loss_and_grads": wall * 1e3, "launches": launches}
        del leaves, run
        tr = Trainer(lambda p, x, m=model: m.call(p, x, method="loss"),
                     Adam(LM_LR), device=device)
        p0 = model.tree()
        tr.step(p0, tr.opt.init(p0), ids)                  # the capture
        (new, _, cost), _, n, disp = counted(
            lambda: tr.step(p0, tr.opt.init(p0), ids))
        check(n == launches and step_dispatches(disp, "step") == {
            "captures": 0, "replays": 1}, f"GPT-2 remat={remat} graphed "
              f"step: launches {n}, dispatches {disp}")
        stepped[remat] = (cost, tree_map(torch.clone, new))
        del tr, new, model, p0
        gc.collect()
        torch.cuda.empty_cache()
    (l0, g0, n0), (l1, g1, n1) = res[False], res[True]
    layers = GPT2_TRAIN["n_layers"]
    check(n0 == {"flash_attention_fwd": layers,
                 "flash_attention_bwd_dq": layers,
                 "flash_attention_bwd_dkv": layers}
          and n1 == dict(n0, flash_attention_fwd=2 * layers),
          f"remat launches {n1}, plain {n0}")
    equal = torch.equal(l0, l1) and all(torch.equal(a, b)
                                        for a, b in zip(g0, g1))
    check(equal, "GPT-2 remat: the loss or a gradient differs from the "
          "plain forward's")
    (c0, p0), (c1, p1) = stepped[False], stepped[True]
    check(torch.equal(c0, c1) and all(
        torch.equal(a, b) for (_, a), (_, b) in zip(tree_items(p0),
                                                    tree_items(p1))),
          "GPT-2 remat: the graphed Adam step differs from the plain one's")
    del res, g0, g1, stepped, p0, p1
    torch.cuda.empty_cache()
    model = TransformerLM(**GPT2_TRAIN, tie_head=False).init(seed, device)
    check(tuple(model.head.w.shape) == (GPT2_TRAIN["d_model"],
                                        GPT2_TRAIN["vocab"]),
          "tie_head=False: no head")
    tr = Trainer(lambda p, x: model.call(p, x, method="loss"), Adam(LM_LR),
                 device=device)
    p, s = model.tree(), tr.opt.init(model.tree())
    costs = []
    for _ in range(4):
        p, s, c = tr.step(p, s, ids)
        costs.append(c.item())
    check(all(np.isfinite(costs)) and costs[-1] < costs[0],
          f"GPT-2 tie_head=False: costs {costs}")
    figs["untied_costs"] = costs
    say(f"zoo GPT-2 small f32 (B={LM_BATCH}, T={LM_SEQ}): remat=True loss "
        f"and gradients bit-equal to remat=False, and its Adam step through "
        f"the trainer's graph; {json.dumps(figs)}")
    del model, tr, p, s
    torch.cuda.empty_cache()
    return figs


def zoo_phase(say, seed: int, device="cuda") -> dict:
    """Phase 16: (a)-(f), each path's launch counts set to 0 just before
    and read just after. Returns the figures, with the tagger's launches
    of #8-#10 and GPT-2's of #1-#3 under "launches"."""
    t0 = time.perf_counter()
    figs = {"tagger": tagger_zoo(say, seed, device)}
    figs.update(embedding_zoo(say, seed, device))
    figs.update(generative_zoo(say, seed, device))
    figs["ops"] = zoo_op_checks(say, seed, device)
    figs["gpt2"] = lm_options_zoo(say, seed, device)
    tg = figs["tagger"]
    steps = ZOO_STEPS - 1
    launches = {k: int(round(v * steps)) for k, v in
                tg["graphed"]["launches_per_step"].items()}
    launches.update(tg["decode_launches"])
    for k, v in figs["gpt2"]["remat"]["launches"].items():
        launches[k] = launches.get(k, 0) + v
    figs["launches"] = launches
    figs["seconds"] = time.perf_counter() - t0
    say(f"zoo phase: {figs['seconds']:.1f} s")
    return figs


# ---------------------------------------------------------------------------
# phase 17: the recurrences at every bench shape, the ops A.4 left, the
# host-offloaded embedding table and the prefix cache
# ---------------------------------------------------------------------------

# benchmarks/lstm_textcls.py:132-136 SUITE_ROWS: every published LSTM row
# (batch, hidden) beyond the flagship, the flagship's model otherwise
SUITE_SHAPES = ((64, 512), (64, 1280), (128, 256), (128, 512), (128, 1280),
                (256, 256), (256, 512), (256, 1280))
# the seq2seq bench's encoder (batch 64, hidden 512) and a batch past the
# GRU backward's one-launch limit there
GRU_SHAPES = (64, 128)


def planned(name: str, B: int, H: int, dtype) -> "object":
    from paddle_tpu_torch.ops import rnn_kernels as rk
    return rk.plan_route(name, B, H, dtype, *rk.card_limits(0))


def route_counts(fn):
    """fn() with LAUNCHES and ROUTES set to 0 just before and read just
    after: (out, {kernel: launches}, {"kernel route": count})."""
    import torch
    from paddle_tpu_torch.ops import cuda_kernels as ck
    torch.cuda.synchronize()
    ck.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return (out, {k: n for k, n in ck.LAUNCHES.items() if n},
            {f"{k} {r}": n for (k, r), n in ck.ROUTES.items()})


def expected_counts(names, B, H, dtype, per_call=1):
    """The launches and routes one training step through ``names`` (a
    forward and a backward kernel, each called ``per_call`` times) must
    show by the planner."""
    launches, routes = {}, {}
    for name in names:
        rt = planned(name, B, H, dtype)
        routes[f"{name} {rt.kind}"] = per_call
        if rt.kind != "scan":
            launches[name] = per_call * len(rt.tiles)
    return launches, routes


def tiled_route_check(kind, B, H, dtype, gen, device="cuda"):
    """The planner's routes of one recurrence (``kind`` "lstm": #9 and #10
    at T = 100, lengths 30..100, nonzero h0/c0; "gru": #11 and #12 at the
    seq2seq's T = 32, lengths 16..32) on B rows against the plain versions
    on the same inputs (lstm_close's tolerances, du as a sum of B*T
    products), and the backward bit-equal across two runs. Returns each
    kernel's max abs error."""
    import torch
    from paddle_tpu_torch.ops import rnn_kernels as rk
    if kind == "lstm":
        T, lo = TEXTCLS_LEN, TEXTCLS_MIN_LEN
        lens = torch.randint(lo, T + 1, (B,), generator=gen).tolist()
        fwd, bwd = _lstm_case(B, T, H, lens, dtype, gen, device, True)
        names, du_index = ("lstm_seq_train", "lstm_seq_bwd"), 3

        def run(name, args, route=None):
            if name == "lstm_seq_bwd":
                return rk.lstm_sequence_fused_bwd(*args, route=route,
                                                  forget_bias=1.0)
            return rk.lstm_sequence_fused(*args, save_cell=True, route=route,
                                          forget_bias=1.0)
    else:
        T, lo = S2S_SEQ, S2S_MIN_LEN
        lens = torch.randint(lo, T + 1, (B,), generator=gen).tolist()
        fwd, bwd = _gru_inputs(B, T, H, lens, dtype, gen, device)
        names, run, du_index = ("gru_seq", "gru_seq_bwd"), _gru_run, 2
    dname = str(dtype).replace("torch.", "")
    errs = {}
    for name, args in zip(names, (fwd, bwd)):
        got, want = run(name, args), run(name, args, route="plain")
        errs[name] = max(
            lstm_close(g, w, f"{name} B={B} H={H} output {i}", dname,
                       sum_terms=B * T if (name == names[1]
                                           and i == du_index) else 0)
            for i, (g, w) in enumerate(zip(got, want)))
        if name == names[1]:
            again = run(name, args)
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"{name} B={B} H={H} {dname}: the backward differs "
                  "between two runs")
    return errs


def step_ms(trainer, params, batch, steps: int = 5) -> float:
    """The median wall of ``steps`` trainer steps (after one to warm and
    capture), on fresh state from ``params``."""
    import torch
    from paddle_tpu_torch.core.pytree import tree_map
    p = tree_map(torch.clone, params)
    state = trainer.opt.init(p)
    p, state, _ = trainer.step(p, state, *batch)
    walls = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, state, cost = trainer.step(p, state, *batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    check(bool(torch.isfinite(cost)), "step_ms: a non-finite cost")
    return sorted(walls)[len(walls) // 2] * 1e3


def recurrence_routes(say, seed: int, device="cuda") -> dict:
    """(a) One f32 training step of the flagship's LSTMTextCls at each
    SUITE_ROWS (B, H) through the kernels (the trainer's graph) against
    the plain route's step (transformer_step_check's tolerances: at H =
    1280 the step loop's gradients differ from the plain versions' in
    rounding, which the first Adam step turns into up to lr where a
    gradient is rounding noise), with the routes
    and launches the planner gives (counted across the step); one bf16
    step likewise (routes, launches, the loss within 1% of the plain
    route's) and its ms; where a route tiles, #9 and #10 on that route
    against the plain versions and the backward bit-equal across two
    runs, in f32 and bf16 (tiled_route_check); then the seq2seq's GRU
    encoder at batch 64 and 128 (transformer_step_check's tolerances),
    with #11 and #12 likewise where they tile. Returns the rows'
    figures."""
    import torch
    from paddle_tpu_torch.models import AttentionSeq2Seq, LSTMTextCls
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.trainer import Trainer
    gen = torch.Generator().manual_seed(seed + 17)
    names = ("lstm_seq_train", "lstm_seq_bwd")
    rows, launches_all = {}, {}
    for B, H in SUITE_SHAPES:
        model = LSTMTextCls(TEXTCLS["vocab"], TEXTCLS["embed"], H,
                            TEXTCLS["classes"], pool="last").init(seed,
                                                                  device)
        batch = textcls_batches(seed, 1, device, batch=B)[0]
        row = {}
        for dname, dtype in (("float32", torch.float32),
                             ("bfloat16", torch.bfloat16)):
            want = expected_counts(names, B, H, dtype)
            if dtype == torch.float32:
                _, got_l, got_r = route_counts(
                    lambda: transformer_step_check(
                        say, f"suite row B={B} H={H}",
                        lambda r: f32_loss(model, r), model.tree(), batch,
                        TEXTCLS_LR, 1, device, names=()))
            else:
                losses = {}
                for route in ("plain", None):
                    tr = Trainer(bf16_loss_route(model, route),
                                 Adam(TEXTCLS_LR), device=device)
                    step = lambda: tr.step(model.tree(),
                                           tr.opt.init(model.tree()), *batch)
                    if route is None:
                        (_, _, cost), got_l, got_r = route_counts(step)
                    else:
                        _, _, cost = step()
                    losses[route] = cost.item()
                plain_loss = losses["plain"]
                check(abs(losses[None] - plain_loss) <= 1e-2 * abs(plain_loss),
                      f"suite row B={B} H={H} bf16: loss {losses[None]} vs "
                      f"plain {plain_loss}")
                row["bf16_loss"] = [losses[None], plain_loss]
                row["bf16_step_ms"] = step_ms(
                    Trainer(bf16_loss(model), Adam(TEXTCLS_LR),
                            device=device), model.tree(), batch)
            check((got_l, got_r) == want,
                  f"suite row B={B} H={H} {dname}: launches {got_l} and "
                  f"routes {got_r}, the planner's {want}")
            row[dname] = {"routes": got_r, "launches": got_l}
            for k, n in got_l.items():
                launches_all[k] = launches_all.get(k, 0) + n
            if "tiles" in (planned(n, B, H, dtype).kind for n in names):
                row[dname]["tiled_vs_plain_max_abs"] = tiled_route_check(
                    "lstm", B, H, dtype, gen, device)
                row[dname]["tiled_bwd_bit_equal"] = True
        say(f"suite row B={B} H={H}: {json.dumps(row)}")
        rows[f"lstm B={B} H={H}"] = row
        del model
        torch.cuda.empty_cache()
    gnames = ("gru_seq", "gru_seq_bwd")
    model = AttentionSeq2Seq(**S2S).init(seed=seed, device=device)
    for B in GRU_SHAPES:
        batch = nmt_batches(seed, 1, device, B, S2S_SEQ, S2S["src_vocab"],
                            S2S_MIN_LEN)[0]
        want = expected_counts(gnames, B, S2S["hidden"], torch.float32, 2)
        _, got_l, got_r = route_counts(lambda: transformer_step_check(
            say, f"seq2seq B={B}", lambda r: nmt_loss(model, torch.float32,
                                                      r),
            model.tree(), batch, S2S_LR, 2, device, names=(), floor=1e-7))
        check((got_l, got_r) == want,
              f"seq2seq B={B} f32: launches {got_l} and routes {got_r}, the "
              f"planner's {want}")
        row = {"float32": {"routes": got_r, "launches": got_l}}
        for k, n in got_l.items():
            launches_all[k] = launches_all.get(k, 0) + n
        for dname, dtype in (("float32", torch.float32),
                             ("bfloat16", torch.bfloat16)):
            if "tiles" in (planned(n, B, S2S["hidden"], dtype).kind
                           for n in gnames):
                row.setdefault(dname, {})["tiled_vs_plain_max_abs"] = (
                    tiled_route_check("gru", B, S2S["hidden"], dtype, gen,
                                      device))
        rows[f"gru B={B} H={S2S['hidden']}"] = row
        say(f"seq2seq B={B}: {json.dumps(row)}")
    return {"rows": rows, "launches": launches_all}


def bf16_loss_route(model, route):
    """bf16_loss with the kernels' ``route`` (None or "plain")."""
    import torch
    from paddle_tpu_torch.core import SeqBatch

    def loss_fn(params, data, lengths, labels):
        return model.call(cast_tree(params, torch.bfloat16),
                          SeqBatch(data, lengths), labels,
                          route=route).to(torch.float32)
    return loss_fn


def cuda_ms(fn, reps: int = 5) -> float:
    """The median of ``reps`` timed calls of fn() (after one to warm), by
    CUDA events."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def card_vs_cpu(what, fn, args, rtol, atol_scale, exact=False):
    """fn on the card against fn on the CPU over the same inputs: every
    output within rtol plus atol_scale of its largest magnitude (or bit
    for bit with ``exact``). Returns (max abs difference, card ms)."""
    import torch
    cpu = fn(*[a.cpu() if isinstance(a, torch.Tensor) else a for a in args])
    card = fn(*args)
    outs = (card,) if isinstance(card, torch.Tensor) else tuple(card)
    wants = (cpu,) if isinstance(cpu, torch.Tensor) else tuple(cpu)
    worst = 0.0
    for got, want in zip(outs, wants):
        got = got.cpu()
        if exact:
            check(torch.equal(got, want), f"{what}: the card's result "
                  "differs from the CPU's")
            continue
        fin = torch.isfinite(want)
        check(torch.equal(fin, torch.isfinite(got)),
              f"{what}: non-finite entries differ")
        g, w = got[fin].double(), want[fin].double()
        err = (g - w).abs().max().item() if w.numel() else 0.0
        tol = atol_scale * (w.abs().max().item() if w.numel() else 0.0)
        check(bool(((g - w).abs() <= tol + rtol * w.abs()).all()),
              f"{what}: card vs CPU max abs difference {err}")
        worst = max(worst, err)
    return worst, cuda_ms(lambda: fn(*args))


# the C4 map of ResNet-50 (stride 16, 1024 channels) of a 600 x 800 image,
# the Fast R-CNN head's 128 RoIs a batch and 7 x 7 bins; C3D's first conv
# (a 16-frame 112 x 112 clip, 3 x 3 x 3 to 64 channels); group norm at 32
# groups over ResNet-50's 56 x 56 x 256 stage; the sparse updates of
# DeepFM's 2**20-row hashed table at embed 64 (a batch of 4096 x 26 ids)
ROI_FEAT, ROI_N, ROI_OUT = (38, 50, 1024), 128, (7, 7)
CLIP, CLIP_W = (4, 16, 112, 112, 3), (3, 3, 3, 3, 64)
GN_X, GN_GROUPS = (8, 56, 56, 256), 32
SPARSE_TABLE, SPARSE_IDS = (2 ** 20, 64), (4096, 26)


def a4b_ops(say, seed: int, device="cuda") -> dict:
    """(b) The ops A.4 left on the card against the CPU, at their callers'
    shapes (f32, TF32 off): roi_pool bit for bit (a max), conv3d and
    group_norm within rtol 1e-4 plus 1e-5 of the largest magnitude, the
    SGD sparse update bit for bit (ordered adds), Adagrad's (a square
    root and a division a row) within rtol 1e-6 plus 1e-6 of the largest
    magnitude; each one's ms on the card."""
    import torch
    from paddle_tpu_torch.ops import conv as C
    from paddle_tpu_torch.ops import norm as N
    from paddle_tpu_torch.ops import pool as P
    from paddle_tpu_torch.ops import sparse as S
    gen = torch.Generator().manual_seed(seed + 18)
    rnd = lambda *s, scale=1.0: (torch.randn(s, generator=gen) * scale).to(
        device)
    figs = {}
    H, W, _ = ROI_FEAT
    feat = rnd(*ROI_FEAT)
    xy = torch.rand((ROI_N, 2), generator=gen) * torch.tensor(
        [W * 16.0 - 64, H * 16.0 - 64])
    wh = 32 + torch.rand((ROI_N, 2), generator=gen) * 320
    rois = torch.cat([xy, torch.minimum(xy + wh, torch.tensor(
        [W * 16.0 - 1, H * 16.0 - 1]))], dim=1).to(device)
    err, ms = card_vs_cpu("roi_pool", lambda f, r: P.roi_pool(
        f, r, ROI_OUT, spatial_scale=1 / 16), (feat, rois), 0, 0,
        exact=True)
    figs["roi_pool"] = {"ms": ms, "bit_equal": True}
    x, w = rnd(*CLIP), rnd(*CLIP_W, scale=0.2)
    err, ms = card_vs_cpu("conv3d", lambda x, w: C.conv3d(x, w, padding=1),
                          (x, w), 1e-4, 1e-5)
    figs["conv3d"] = {"ms": ms, "max_abs_err": err}
    x = rnd(*GN_X) + 0.5
    g, b = rnd(GN_X[-1]), rnd(GN_X[-1])
    err, ms = card_vs_cpu("group_norm", lambda x, g, b: N.group_norm(
        x, g, b, GN_GROUPS), (x, g, b), 1e-4, 1e-5)
    figs["group_norm"] = {"ms": ms, "max_abs_err": err}
    table = rnd(*SPARSE_TABLE, scale=0.01)
    moment = rnd(*SPARSE_TABLE).abs()
    # hashed ids pile up on few rows (zipf), as a click log's do
    ids = torch.from_numpy(__import__("numpy").random.RandomState(
        seed).zipf(1.2, SPARSE_IDS) % SPARSE_TABLE[0]).to(device)
    grads = rnd(*SPARSE_IDS, SPARSE_TABLE[1], scale=0.1)
    sr = lambda i, g: S.embedding_grad_rows(i, g, SPARSE_TABLE[0])
    _, ms = card_vs_cpu("sgd_sparse_update", lambda t, i, g:
                        S.sgd_sparse_update(t, sr(i, g), 0.05),
                        (table, ids, grads), 0, 0, exact=True)
    figs["sgd_sparse_update"] = {"ms": ms, "bit_equal": True}
    err, ms = card_vs_cpu("adagrad_sparse_update", lambda t, m, i, g:
                          S.adagrad_sparse_update(t, m, sr(i, g), 0.05),
                          (table, moment, ids, grads), 1e-6, 1e-6)
    figs["adagrad_sparse_update"] = {"ms": ms, "max_abs_err": err}
    figs["sparse_ids"] = {"ids": ids.numel(),
                          "rows": int(torch.unique(ids).numel()),
                          "most_repeats": int(torch.unique(
                              ids, return_counts=True)[1].max())}
    say(f"A.4b ops, card vs CPU: {json.dumps(figs)}")
    return figs


# a bag-of-ids classifier over a 2**22 x 64 f32 table: a batch of 512
# samples of 32 ids, the ids Zipf-distributed over the table
EMB_TABLE, EMB_BATCH, EMB_IDS, EMB_STEPS, EMB_LR = (2 ** 22, 64), 512, 32, \
    4, 0.05


def host_embedding_steps(say, seed: int, device="cuda") -> dict:
    """(c) ``HostEmbeddingTable`` (the table in host memory, the
    prefetcher streaming each batch's rows) inside EMB_STEPS SGD steps of
    a bag-of-ids classifier, against the same steps over the table on
    the card (its SGD as the host library computes it: lr a double, the
    step rounded to f32): per-step losses, the head and every touched
    row bit-equal, untouched rows unchanged; the rows a second of the
    prefetch (unique rows gathered and sent to the card)."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.runtime import (HostEmbeddingTable,
                                          HostEmbedPrefetcher)
    V, Dm = EMB_TABLE
    gen = torch.Generator(device=device).manual_seed(seed + 19)
    init = torch.randn(EMB_TABLE, generator=gen, device=device) * 0.01
    head0 = torch.randn((Dm, 2), generator=gen, device=device) * 0.1
    rs = np.random.RandomState(seed + 19)
    batches = [(rs.zipf(1.3, (EMB_BATCH, EMB_IDS)) % V,
                rs.randint(0, 2, EMB_BATCH)) for _ in range(EMB_STEPS)]

    def loss_of(rows, idx, head, y):
        e = F.embedding(idx, rows).mean(dim=1)
        return F.cross_entropy(e @ head, y)

    t0 = time.perf_counter()
    table = HostEmbeddingTable(V, Dm, lr=EMB_LR, capacity=EMB_BATCH *
                               EMB_IDS, init=init.cpu().numpy(),
                               device=device)
    build_s = time.perf_counter() - t0
    head = head0.clone()
    pf = HostEmbedPrefetcher(table, iter([ids for ids, _ in batches]))
    host_losses, rows_moved = [], 0
    for _, y in batches:
        b = pf.next()
        rows = b.rows.detach().requires_grad_()
        hd = head.detach().requires_grad_()
        loss = loss_of(rows, b.inverse, hd, torch.as_tensor(y,
                                                            device=device))
        g_rows, g_head = torch.autograd.grad(loss, (rows, hd))
        pf.commit(b, g_rows)
        head = head - EMB_LR * g_head
        host_losses.append(loss.item())
        rows_moved += b.count
    check(pf.next() is None, "host embedding: the prefetcher ran on")
    dense, head = init.clone(), head0.clone()
    card_losses = []
    for ids, y in batches:
        tb = dense.detach().requires_grad_()
        hd = head.detach().requires_grad_()
        idx = torch.as_tensor(ids, device=device)
        loss = loss_of(tb, idx, hd, torch.as_tensor(y, device=device))
        g_tab, g_head = torch.autograd.grad(loss, (tb, hd))
        touched = torch.unique(idx)
        dense[touched] -= (EMB_LR * g_tab[touched].double()).float()
        head = head - EMB_LR * g_head
        card_losses.append(loss.item())
    check(host_losses == card_losses,
          f"host embedding: losses {host_losses} != on-card {card_losses}")
    touched = np.unique(np.concatenate([ids.reshape(-1)
                                        for ids, _ in batches]))
    got = torch.from_numpy(table.rows_host(touched))
    check(torch.equal(got, dense[torch.from_numpy(touched).to(device)]
                      .cpu()), "host embedding: touched rows differ from "
          "the on-card table's")
    probe = np.setdiff1d(np.arange(0, V, 9973), touched)
    check(torch.equal(torch.from_numpy(table.rows_host(probe)),
                      init[torch.from_numpy(probe).to(device)].cpu()),
          "host embedding: an untouched row moved")
    # the prefetch alone: unique rows gathered on the host and sent over
    t0 = time.perf_counter()
    n = 0
    for ids, _ in batches * 2:
        n += table.prefetch(ids).count
    torch.cuda.synchronize()
    rate = n / (time.perf_counter() - t0)
    figs = {"table": list(EMB_TABLE), "steps": EMB_STEPS,
            "losses": host_losses, "unique_rows_a_step": rows_moved /
            EMB_STEPS, "prefetch_rows_per_s": rate,
            "host_table_build_s": build_s, "bit_equal": True}
    say(f"host embedding (host table vs on-card table): {json.dumps(figs)}")
    return figs


#: the bursts of (d): 8 prompts sharing a 200-token prefix (3 full pages
#: of 64 and 8 tokens of a fourth, which every hit copies on write), each
#: request declaring it, with distinct suffixes of 16..64 tokens, after
#: one request that warms the cache with the prefix; then 8 more with
#: other suffixes of the same lengths (the hit admission's graph replays)
PREFIX_LEN, SUFFIX_LENS = 200, (16, 64)


def prefix_engine(say, seed: int, device="cuda", config=GPT2_SMALL) -> dict:
    """(d) GPT-2 small's ``ServingEngine`` (phase 10's ENGINE) with
    ``prefix_cache=True``, f32: a warm request, then the burst queued whole
    before the engine starts again, then a second burst of the same
    shapes; every request's tokens equal to the cache-off engine's, and
    the warm request's and the first burst's to the solo plain decode;
    the hits, the prefill tokens saved, the copies on write of the
    prefix's partial page and the hit graph's captures and replays (hits
    > 0, copies > 0, a replay). Latency figures: the second burst (the
    first captures the hit admission's graph; the cache-off engine's
    admission graph was captured by the warm request)."""
    import numpy as np
    import torch
    from paddle_tpu_torch.core import graphs
    from paddle_tpu_torch.models import TransformerLM
    from paddle_tpu_torch.ops import cuda_kernels as ck
    from paddle_tpu_torch.serving import ServingEngine
    model = TransformerLM(**config).init(seed=seed, device=device)
    rs = np.random.RandomState(seed + 20)
    prefix = rs.randint(0, config["vocab"], PREFIX_LEN)
    lens = [int(n) + 1 for n in rs.randint(*SUFFIX_LENS, N_REQUESTS + 1)]
    prompts = [np.concatenate([prefix, rs.randint(0, config["vocab"], n)])
               for n in lens]
    again = [np.concatenate([prefix, rs.randint(0, config["vocab"], n)])
             for n in lens[1:]]
    res = {}
    for cache in (False, True):
        eng = ServingEngine(model, device=device, prefix_cache=cache,
                            **ENGINE)
        warm = serve(model, prompts[:1], device, eng=eng,
                     prefix_len=PREFIX_LEN)[0]
        ck.reset_launch_counts()
        graphs.reset_dispatch_counts()
        toks = serve(model, prompts[1:], device, eng=eng,
                     prefix_len=PREFIX_LEN)[0]
        toks2, lat, wall, _ = serve(model, again, device, eng=eng,
                                    prefix_len=PREFIX_LEN)
        res[cache] = {"toks": warm + toks, "again": toks2, "wall": wall,
                      "launches": {k: n for k, n in ck.LAUNCHES.items()
                                   if n},
                      "hit": step_dispatches(graphs.DISPATCHES, "hit"),
                      "stats": eng.stats(), "latency": latency_figures(
                          lat, wall)}
        del eng
        gc.collect()
    check(res[True]["toks"] == res[False]["toks"]
          and res[True]["again"] == res[False]["again"],
          "prefix cache: the engine's tokens differ from the cache-off "
          "engine's")
    for i, p in enumerate(prompts):
        ids = torch.as_tensor(p[None].astype(np.int64), device=device)
        solo = model.generate_greedy(ids, NEW_TOKENS, route="plain")
        same_tokens([res[True]["toks"][i]], [solo[0, len(p):].cpu()
                                             .numpy().tolist()],
                    f"prefix cache request {i}")
    st = res[True]["stats"]
    hits = st["prefix_hits"]
    check(hits > 0, f"prefix cache: no hit in the burst ({st})")
    check(st["cow_copies"] > 0, "prefix cache: no hit copied the prefix's "
          f"partial page ({st})")
    check(res[True]["hit"]["replays"] > 0,
          f"prefix cache: the hit admission's graph never replayed "
          f"({res[True]['hit']})")
    figs = {"hits": hits, "misses": st["prefix_misses"],
            "prefill_tokens_saved": st["prompt_tokens"]
            - st["prefill_tokens"], "prompt_tokens": st["prompt_tokens"],
            "cow_copies": st["cow_copies"], "hit_graph": res[True]["hit"],
            "launches": res[True]["launches"],
            "launches_cache_off": res[False]["launches"],
            "latency": res[True]["latency"],
            "latency_cache_off": res[False]["latency"]}
    say(f"prefix cache, GPT-2 small f32 engine: tokens equal to the solo "
        f"plain decode and the cache-off engine's; {json.dumps(figs)}")
    return figs


def slice18_phase(say, seed: int, device="cuda") -> dict:
    """Phase 17: (a) the recurrences at every bench shape, (b) the ops A.4
    left, (c) the host-offloaded embedding table, (d) the prefix cache
    ((e), phase 10's engine check with each burst queued before the
    engine starts, runs in phase 10)."""
    import torch
    out = {"recurrences": recurrence_routes(say, seed, device)}
    torch.cuda.empty_cache()
    out["ops"] = a4b_ops(say, seed, device)
    torch.cuda.empty_cache()
    out["host_embedding"] = host_embedding_steps(say, seed, device)
    torch.cuda.empty_cache()
    out["prefix_cache"] = prefix_engine(say, seed, device)
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 18: every head width up to 128; GPT-Neo-1.3B's widths; the wire plane
# ---------------------------------------------------------------------------

# EleutherAI/gpt-neo-1.3B's config.json: hidden_size 2048, num_heads 16
# (head width 128), num_layers 24, vocab_size 50257,
# max_position_embeddings 2048, intermediate 4 x 2048. TransformerLM's
# global attention runs in every layer, where GPT-Neo alternates it with
# a 256-token local window. Weights random from the seed. Depth cut to 8
# of the 24 layers since phase 24 took the smoke past 1050 s of its 1200
# (the widths, and so every kernel shape, are the model's).
GPT_NEO = dict(vocab=50257, d_model=2048, n_heads=16, n_layers=8,
               d_ff=8192, max_len=2048)
NEO_TRAIN_B, NEO_TRAIN_T, NEO_LR = 2, 1024, 3e-4
# the head widths phase 18 holds every kernel at: 8 and 32 (the repo's
# small examples and `paddle_tpu profile`'s default), 80 (Phi-2's
# 2560/32), 128 (GPT-Neo's); at GPT-Neo's 16 heads
WIDTHS, WIDTH_H = (8, 32, 80, 128), 16
# the decode reads at GPT-Neo's widths: 8 slots, a [:, :512] read of a
# 640-row cache (#4, #5), 8 pages of 64 rows (#6, #7)
NEO_DECODE_B, NEO_DECODE_L, NEO_DECODE_MAX, NEO_DECODE_NB = 8, 512, 640, 8
# the wire plane over GPT-2 small, as benchmarks/serving_daemon.py and
# benchmarks/serving_router.py lay it out: prompts 32-256, 32-256 new
# tokens, page_block 64, cache_bucket 512, one prompt bucket of 256
WIRE_POOL = dict(segment=32, page_block=64, cache_bucket=512,
                 prompt_buckets=(256,))
# (48 daemon and 32 router requests until phase 24 took the smoke past
# 1050 s of its 1200: cut to 24 + 16)
WIRE_DAEMON_SLOTS, WIRE_DAEMON_REQUESTS = 16, 24
WIRE_ROUTER_SLOTS, WIRE_ROUTER_REQUESTS, WIRE_PREFILL_SLOTS = 8, 16, 4
WIRE_CHECKED = 8            # requests of each run held to the solo decode


def _pad_route(D):
    from paddle_tpu_torch.ops import cuda_kernels as ck
    return None if D in ck.KERNEL_HEAD_DIMS else \
        f"pad{next(w for w in ck.KERNEL_HEAD_DIMS if w >= D)}"


def _flash_pair(q, k, v, do, causal, lens, dname, what):
    """#1 and #2/#3 on (q, k, v) against the plain versions (f32 inputs
    for bf16: the plain version's accuracy); returns the max abs errors
    of o, dq, dk, dv and the routes counted."""
    import torch
    from paddle_tpu_torch.ops import cuda_kernels as ck
    ck.reset_launch_counts()
    o, lse = ck.flash_attention_fwd(q, k, v, causal=causal, kv_lens=lens)
    po, plse = ck.flash_attention_fwd(q.float(), k.float(), v.float(),
                                      causal=causal, kv_lens=lens,
                                      route="plain")
    torch.cuda.synchronize()
    if dname == "float32":
        err = fwd_f32_close(o, po, what)
    else:
        err = bf16_tc_close(o, po, what)
    check(torch.allclose(lse, plse, atol=F32_ATOL, rtol=F32_RTOL),
          f"{what}: lse differs from plain")
    o_in = po.to(q.dtype)
    got = ck.flash_attention_bwd(q, k, v, o_in, plse, do, causal=causal,
                                 kv_lens=lens)
    want = ck.flash_attention_bwd(q.float(), k.float(), v.float(),
                                  o_in.float(), plse, do.float(),
                                  causal=causal, kv_lens=lens, route="plain")
    errs = {"o": err}
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        check(g.shape == w.shape and g.dtype == q.dtype,
              f"{what}: {name} {tuple(g.shape)} {g.dtype}")
        errs[name] = (bwd_close(g, w, f"{what} {name}", dname)
                      if dname == "float32"
                      else bf16_tc_close(g, w, f"{what} {name}"))
    launches = {n: ck.LAUNCHES[n] for n in ATTENTION_KERNELS}
    check(launches == dict.fromkeys(ATTENTION_KERNELS, 1),
          f"{what}: launches {launches}")
    return errs, dict(ck.ROUTES)


def width_flash_checks(say, gen, device, widths=WIDTHS,
                       views=(128, 80)) -> dict:
    """#1-#3 at each width of ``widths``, f32 and bf16, at GPT-Neo's
    training shape (B=2, T=S=1024, 16 heads, causal): against the plain
    versions, natively at the built widths and by the counted pad route at
    the others; then causal at S = T - 64 and T + 64 with kv_lens
    (top-left aligned) and a view off the 16-byte rule (the copy16 route
    at a built width) at each width of ``views``."""
    import torch
    B, T, H = NEO_TRAIN_B, NEO_TRAIN_T, WIDTH_H
    out = {}
    for D in widths:
        for dt in (torch.float32, torch.bfloat16):
            dname = str(dt).split(".")[1]
            rnd = lambda *shape: torch.randn(shape, generator=gen).to(
                device, dt)
            q, k, v, do = rnd(B, T, H, D), rnd(B, T, H, D), rnd(B, T, H, D), \
                rnd(B, T, H, D)
            what = f"flash D={D} {dname}"
            errs, routes = _flash_pair(q, k, v, do, True, None, dname, what)
            r = _pad_route(D)
            want = {} if r is None else {(n, r): 1 for n in ATTENTION_KERNELS}
            check(routes == want, f"{what}: routes {routes} != {want}")
            out[f"D{D} {dname}"] = {"max_abs_err": errs,
                                    "route": r or "native"}
            del q, k, v, do
    for D in views:
        for dt in (torch.float32, torch.bfloat16):
            dname = str(dt).split(".")[1]
            rnd = lambda *shape: torch.randn(shape, generator=gen).to(
                device, dt)
            for S in (T - 64, T + 64):
                q, k, v, do = rnd(B, T, H, D), rnd(B, S, H, D), \
                    rnd(B, S, H, D), rnd(B, T, H, D)
                lens = torch.tensor([S, S // 2 + 3], device=device)
                what = f"flash causal T={T} S={S} D={D} {dname}"
                errs, _ = _flash_pair(q, k, v, do, True, lens, dname, what)
                out[f"causal S={S} D{D} {dname}"] = {"max_abs_err": errs}
            # q, k, v 2 elements past a 16-byte boundary (copy16 at 128)
            flat = torch.randn(3 * B * T * H * D + 2, generator=gen).to(
                device, dt)
            q, k, v = (flat[2 + i * B * T * H * D:2 + (i + 1) * B * T * H * D]
                       .view(B, T, H, D) for i in range(3))
            errs, routes = _flash_pair(q, k, v, rnd(B, T, H, D), True, None,
                                       dname, f"flash view off 16 bytes D={D}"
                                       f" {dname}")
            r = _pad_route(D) or "copy16"
            check(routes == {(n, r): 1 for n in ATTENTION_KERNELS},
                  f"flash view off 16 bytes D={D}: routes {routes}")
            out[f"view off 16 bytes D{D} {dname}"] = {
                "max_abs_err": errs, "route": r}
    say(f"flash #1-#3 at head widths {widths} (B={B} T={T} H={H} causal), "
        "causal S = T -/+ 64 with kv_lens and views off the 16-byte rule, "
        f"against plain: {json.dumps(out)}")
    return out


def _neo_decode_inputs(D, qname, kind, gen, device, B=NEO_DECODE_B,
                       H=WIDTH_H, L=NEO_DECODE_L, Lmax=NEO_DECODE_MAX):
    """(q, k[:, :L], v[:, :L], pos) over a [B, Lmax, H, D] cache (int8 with
    its scales' views for ``kind`` "int8", else the query's dtype); pos
    with 0, L - 1 and a drained slot past L."""
    import torch
    from paddle_tpu_torch.ops import cuda_kernels as ck
    q = _decode_query(B, H, D, getattr(torch, qname), gen, device)
    k, v = (torch.randn((B, Lmax, H, D), generator=gen).to(device)
            for _ in range(2))
    scales = (None, None)
    if kind == "int8":
        (k, ks), (v, vs) = ck.quantize_kv(k), ck.quantize_kv(v)
        scales = (ks[:, :L], vs[:, :L])
    else:
        k, v = k.to(q.dtype), v.to(q.dtype)
    pos = torch.linspace(0, L - 1, B).round().to(torch.int32)
    pos[-1] = L + 37
    return (q, k[:, :L], v[:, :L], pos.to(device)), scales


def _neo_paged_inputs(D, qname, kind, gen, device, B=NEO_DECODE_B,
                      H=WIDTH_H, NB=NEO_DECODE_NB):
    """Pools of B*NB + 1 pages of 64 rows (page 0 the null page), a
    permuted table with null tails, pos spread over the rows; int8 pools
    with their scale pools for ``kind`` "int8"."""
    import torch
    from paddle_tpu_torch.ops import cuda_kernels as ck
    P = B * NB + 1
    q = _decode_query(B, H, D, getattr(torch, qname), gen, device)
    kp, vp = (torch.randn((P, PAGE_ROWS, H, D), generator=gen).to(device)
              for _ in range(2))
    scales = (None, None)
    if kind == "int8":
        (kp, ks), (vp, vs) = ck.quantize_kv(kp), ck.quantize_kv(vp)
        scales = (ks, vs)
    else:
        kp, vp = kp.to(q.dtype), vp.to(q.dtype)
    tables = (torch.randperm(P - 1, generator=gen)[:B * NB] + 1).reshape(
        B, NB).to(torch.int32)
    pos = torch.linspace(0, NB * PAGE_ROWS - 1, B).round().to(torch.int32)
    for b in range(B):
        tables[b, int(pos[b]) // PAGE_ROWS + 1:] = 0
    return (q, kp, vp, tables.to(device), pos.to(device)), scales


def width_decode_checks(say, gen, device, widths=WIDTHS) -> dict:
    """#4-#7 at each width of ``widths``, every query and cache dtype,
    against their plain versions over caches at the real width (no route
    at a multiple of 8: nothing padded or copied; the counted pad8 route
    at any other), and, at the multiples of 8, #6/#7 bit-equal to #4/#5
    over ``gather_pages`` of the same pools at the same split count."""
    import torch
    from paddle_tpu_torch.ops import cuda_kernels as ck
    out = {}
    B, H = NEO_DECODE_B, WIDTH_H
    for D in widths:
        for qname, kind in DECODE_CASES:
            ck.reset_launch_counts()
            (q, k, v, pos), (ks, vs) = _neo_decode_inputs(D, qname, kind,
                                                          gen, device)
            o = ck.decode_attention(q, k, v, pos, k_scale=ks, v_scale=vs)
            po = ck.decode_attention(q, k, v, pos, k_scale=ks, v_scale=vs,
                                     route="plain")
            (q2, kp, vp, tables, ppos), (kps, vps) = _neo_paged_inputs(
                D, qname, kind, gen, device)
            pg = ck.paged_decode_attention(q2, kp, vp, tables, ppos,
                                           k_scale=kps, v_scale=vps)
            ppg = ck.paged_decode_attention(q2, kp, vp, tables, ppos,
                                            k_scale=kps, v_scale=vps,
                                            route="plain")
            routes = dict(ck.ROUTES)
            n_split = ck.decode_splits(B * H, NEO_DECODE_NB * PAGE_ROWS)[0]
            gathered = None if D % 8 else ck._decode_attention_kernel(
                q2, ck.gather_pages(kp, tables), ck.gather_pages(vp, tables),
                ppos, D ** -0.5,
                None if kps is None else ck.gather_pages(kps, tables),
                None if vps is None else ck.gather_pages(vps, tables),
                n_split)
            torch.cuda.synchronize()
            what = f"decode D={D} q {qname} cache {kind}"
            errs = {}
            for name, g, w in (("dense", o, po), ("paged", pg, ppg)):
                errs[name] = (g - w).abs().max().item()
                check(torch.allclose(g, w, atol=F32_ATOL, rtol=F32_RTOL),
                      f"{what} {name}: max abs {errs[name]} from plain")
            check(gathered is None or torch.equal(pg, gathered),
                  f"{what}: the paged read differs from the dense read of "
                  "its gathered pages")
            q8 = "_q" if kind == "int8" else ""
            want = {} if D % 8 == 0 else {
                ("decode_attention" + q8, "pad8"): 1,
                ("paged_decode_attention" + q8, "pad8"): 1}
            check(routes == want, f"{what}: routes {routes} != {want}")
            out[f"D{D} {qname}/{kind}"] = errs
    say(f"decode #4-#7 at head widths {widths} (B={B} H={H}, a [:, :"
        f"{NEO_DECODE_L}] read and {NEO_DECODE_NB} pages of {PAGE_ROWS}), "
        f"every query/cache dtype, against plain, paged bit-equal to dense "
        f"over its gathered pages, no route: {json.dumps(out)}")
    return out


def width_timings(say, gen, device, D=128, errs=None) -> list:
    """Each kernel at head width D on GPT-Neo's shapes (#1-#3: B=2,
    T=S=1024, 16 heads, causal, f32 and bf16; #4-#7: phase 18's decode
    reads, bf16 queries) timed beside the plain version, SDPA where one
    call computes the same (#1's forward and #2/#3's backward; #4's read
    with a bool mask) and the bound: the kernels line's entries at D
    (launches are filled in from the model runs at that width). ``errs``
    are the width checks' errors (default WIDTH_ERRS)."""
    import torch
    from paddle_tpu_torch.ops import cuda_kernels as ck
    B, T, H = NEO_TRAIN_B, NEO_TRAIN_T, WIDTH_H
    entries = {}
    for dt in (torch.bfloat16, torch.float32):
        dname = str(dt).split(".")[1]
        fwd = _fwd_times(B, T, H, dt, dname, gen, device, D=D)
        bwd = _bwd_times(B, T, T, H, True, None, dt, dname, gen, device,
                         D=D)
        for name, res in (("flash_attention_fwd", fwd), *bwd.items()):
            e = entries.setdefault(name, {})
            if dt == torch.bfloat16:
                e.update(res)
            else:
                e["float32"] = res
    sources = {"flash_attention_fwd": ("paddle_tpu_torch/csrc/flash_fwd.cu",
                                       "paddle_tpu/ops/pallas_kernels.py:69"),
               "flash_attention_bwd_dq": (
                   "paddle_tpu_torch/csrc/flash_bwd.cu",
                   "paddle_tpu/ops/pallas_kernels.py:123"),
               "flash_attention_bwd_dkv": (
                   "paddle_tpu_torch/csrc/flash_bwd.cu",
                   "paddle_tpu/ops/pallas_kernels.py:168")}
    out = []
    errs = WIDTH_ERRS if errs is None else errs
    for name, e in entries.items():
        src, rep = sources[name]
        err_key = {"flash_attention_fwd": "o", "flash_attention_bwd_dq":
                   "dq", "flash_attention_bwd_dkv": "dk"}[name]
        out.append({"name": name, "head_dim": D, "route": "cuda",
                    "source": src, "replaces": rep, "dtype": "bfloat16",
                    "shape": f"B={B} T=S={T} H={H} D={D} causal",
                    "max_abs_err": errs["flash"][f"D{D} bfloat16"][
                        "max_abs_err"][err_key], **e})
    B, H, L, NB = NEO_DECODE_B, WIDTH_H, NEO_DECODE_L, NEO_DECODE_NB
    for name, kind, paged, rep in (
            ("decode_attention", "bfloat16", False,
             "paddle_tpu/ops/pallas_kernels.py:561"),
            ("decode_attention_q", "int8", False,
             "paddle_tpu/ops/pallas_kernels.py:571"),
            ("paged_decode_attention", "bfloat16", True,
             "paddle_tpu/ops/pallas_kernels.py:711"),
            ("paged_decode_attention_q", "int8", True,
             "paddle_tpu/ops/pallas_kernels.py:727")):
        int8 = kind == "int8"
        if paged:
            make = lambda i, kind=kind: _neo_paged_inputs(
                D, "bfloat16", kind, gen, device)
            run = lambda s, route=None: ck.paged_decode_attention(
                *s[0], k_scale=s[1][0], v_scale=s[1][1], route=route)
            rows = NB * PAGE_ROWS
        else:
            make = lambda i, kind=kind: _neo_decode_inputs(
                D, "bfloat16", kind, gen, device)
            run = lambda s, route=None: ck.decode_attention(
                *s[0], k_scale=s[1][0], v_scale=s[1][1], route=route)
            rows = L
        kv_size = 1 if int8 else 2
        # live rows of the spread pos (clamped to the read), as the
        # kernels read them
        live = sum(min(int(p) + 1, rows) for p in torch.linspace(
            0, rows - 1, B).round().tolist()[:-1]) + rows
        nbytes = (B * H * D * 2 + 2 * live * H * D * kv_size
                  + (2 * live * H * 4 if int8 else 0) + B * 4
                  + (B * NB * 4 if paged else 0) + B * H * D * 4)
        b_ms, b_by = bound(4.0 * live * H * D, nbytes, "float32")
        times = _decode_times(run, make, 2 * B * rows * H * D * kv_size,
                              sdpa=name == "decode_attention")
        key = f"D{D} bfloat16/{'int8' if int8 else 'bfloat16'}"
        out.append({"name": name, "head_dim": D, "route": "cuda",
                    "source": ("paddle_tpu_torch/csrc/paged_decode.cu"
                               if paged else "paddle_tpu_torch/csrc/"
                               "decode.cu"),
                    "body": "paddle_tpu_torch/csrc/decode_attn.cuh",
                    "replaces": rep, "dtype": "bfloat16",
                    "shape": f"B={B} H={H} D={D} "
                             + (f"{NB} pages of {PAGE_ROWS}" if paged
                                else f"[:, :{L}] of {NEO_DECODE_MAX} rows"),
                    "max_abs_err": errs["decode"][key][
                        "paged" if paged else "dense"],
                    "ms": times["ms"], "plain_ms": times["plain_ms"],
                    "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": times.get("library_ms")})
    say(f"kernels at D = {D} (GPT-Neo's shapes): {json.dumps(out)}")
    return out


# the errors of the width checks, kept for the D = 128 entries
WIDTH_ERRS: dict = {}
# bf16 serving: an engine token may differ from the plain model's greedy
# choice only where the two are within this many bf16 ulps of the largest
# logit (a near-tie; see greedy_within_ties)
NEAR_TIE_ULPS = 4
#: what greedy_within_ties held, per checked burst, in call order
NEAR_TIE_GAPS: list = []


def _tie_groups(prompts, toks, max_len: int) -> list:
    """The requests of a burst in batches for greedy_within_ties: in
    order, each batch as long as its longest prompt plus its longest
    continuation fits the model's cache (max_len rows); mostly one batch."""
    groups, cur, longest, most = [], [], 0, 0
    for i, (p, t) in enumerate(zip(prompts, toks)):
        lp, lt = max(longest, len(p)), max(most, len(t))
        if cur and lp + lt > max_len:
            groups.append(cur)
            cur, lp, lt = [], len(p), len(t)
        cur.append(i)
        longest, most = lp, lt
    if cur:
        groups.append(cur)
    return groups


def greedy_within_ties(model, prompts, toks, kv, what, device) -> dict:
    """Hold bf16 serving tokens to the plain model's greedy choices. In
    bf16 an exact match with a solo decode is not a sound check: the
    solo decode's GEMMs run other shapes (one row against the engine's
    full pool width) and #1 rounds P to bf16, so hidden states differ by
    a few bf16 ulps, and where two tokens' logits lie that close the
    argmax may go either way, after which the two sequences part for
    good (phase 18's first card run: GPT-Neo's widths, request 0, token
    17, the top two tokens swapped). So each request's tokens are fed
    back through the plain route (``prefill`` then ``decode_step``,
    ``route="plain"``, the request's own KV dtype): at every step the
    engine's token must be the plain logits' argmax, or within
    NEAR_TIE_ULPS bf16 ulps of the largest logit of it. The requests of
    a burst go through one batched cell (a ragged ``prefill`` with their
    lengths, then one ``decode_step`` a token for all of them; a request
    past its last token feeds token 0, which no other row reads) where
    their lengths fit the cache (_tie_groups); each step's top logit,
    chosen logit, ulp and argmax are computed on the card, and read back
    once a batch. Returns the tokens checked, those equal to the argmax
    and the largest gap in ulps."""
    import numpy as np
    import torch
    checked = equal = 0
    worst = 0.0
    with torch.no_grad():
        for idx in _tie_groups(prompts, toks, model.max_len):
            lens = [len(prompts[i]) for i in idx]
            ids = np.zeros((len(idx), max(lens)), np.int64)
            want = np.zeros((len(idx), max(len(toks[i]) for i in idx)),
                            np.int64)
            for r, i in enumerate(idx):
                ids[r, :lens[r]] = np.asarray(prompts[i])
                want[r, :len(toks[i])] = np.asarray(toks[i], np.int64)
            ragged = min(lens) != max(lens)
            cell, logits = model.prefill(
                torch.as_tensor(ids, device=device),
                torch.as_tensor(lens, device=device) if ragged else None,
                kv_dtype=kv, route="plain")
            tok = torch.as_tensor(want, device=device)
            gaps, argmaxes = [], []
            for j in range(want.shape[1]):
                row = logits.float()
                big = row.abs().amax(-1)
                ulp = torch.exp2(torch.floor(torch.log2(big)) - 7)
                chosen = row.gather(1, tok[:, j:j + 1])[:, 0]
                gaps.append((row.amax(-1) - chosen) / ulp)
                argmaxes.append(row.argmax(-1))
                if j + 1 < want.shape[1]:
                    logits, cell = model.decode_step(cell, tok[:, j],
                                                     route="plain")
            gaps = torch.stack(gaps, 1).cpu().numpy()         # one read
            argmaxes = torch.stack(argmaxes, 1).cpu().numpy()
            for r, i in enumerate(idx):
                n = len(toks[i])
                for j in range(n):
                    check(gaps[r, j] <= NEAR_TIE_ULPS, f"{what}: request {i} "
                          f"token {j} = {want[r, j]} is {gaps[r, j]:.1f} "
                          f"bf16 ulps below the plain model's greedy choice "
                          f"{argmaxes[r, j]}")
                worst = max([worst] + gaps[r, :n].tolist())
                equal += int((argmaxes[r, :n] == want[r, :n]).sum())
                checked += n
    held = {"tokens": checked, "equal_to_argmax": equal,
            "worst_gap_bf16_ulps": float(worst)}
    NEAR_TIE_GAPS.append(dict(held, burst=what))
    return held


def gpt_neo_phase(say, seed: int, device="cuda") -> dict:
    """(b) A TransformerLM at GPT-Neo-1.3B's widths: one f32 training
    step at 2 x 1024 tokens through #1-#3 against the plain route
    (lean_step_check), one graphed bf16 step timed; then phase 10's burst
    through ``ServingEngine`` (phase 10's ENGINE; one burst to capture the
    graphs, one measured) with f32 weights at f32 and int8 KV, tokens
    equal to each request's solo plain-attention decode, and with bf16
    weights at bf16 and int8 KV, each token the plain model's greedy
    choice up to a near-tie (greedy_within_ties); and ``generate_fused``
    through #4 and #5 in bf16 likewise. Each path's counts set to 0 just
    before and read just after; returns the launches, the serving
    figures and the training figures."""
    import numpy as np
    import torch
    from paddle_tpu_torch.models import TransformerLM
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.serving import ServingEngine
    from paddle_tpu_torch.trainer import Trainer
    runs = {}
    cfg = GPT_NEO
    L = cfg["n_layers"]
    model = TransformerLM(**cfg).init(seed=seed, device=device)
    n_params = sum(t.numel() for t in model.parameters())
    say(f"GPT-Neo-1.3B widths: {n_params / 1e9:.3f} B "
        f"parameters, head width {model.blocks[0].d_head}")
    rs = np.random.RandomState(seed + 18)
    ids = torch.as_tensor(rs.randint(0, cfg["vocab"], (NEO_TRAIN_B,
                                                       NEO_TRAIN_T + 1)),
                          device=device)
    params = model.tree()
    runs["f32 training step"] = lean_step_check(
        say, "GPT-Neo widths", lm_loss(model, torch.float32),
        lm_loss(model, torch.float32, route="plain"), params, (ids,),
        NEO_LR, per_step=L)
    # one graphed bf16 step over f32 masters (the training recipe), timed
    tr = Trainer(lm_loss(model, torch.bfloat16), Adam(NEO_LR), device=device)
    trees = [params, tr.opt.init(params)]

    def step():
        trees[0], trees[1], cost = tr.step(*trees, ids)
        return cost
    step()                                         # eager + capture
    (cost,), wall, launches, disp = counted(lambda: [step()])
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    check(step_dispatches(disp, "step") == {"captures": 0, "replays": 1}
          and launches == {n: L for n in ATTENTION_KERNELS}
          and torch.isfinite(cost).item(),
          f"GPT-Neo widths bf16 graphed step: dispatches "
          f"{step_dispatches(disp, 'step')}, launches {launches}, cost "
          f"{cost.item()}")
    runs["bf16 graphed step"] = launches
    toks_s = NEO_TRAIN_B * NEO_TRAIN_T / min(walls)
    say(f"GPT-Neo widths bf16 graphed training step ({NEO_TRAIN_B} x "
        f"{NEO_TRAIN_T} tokens, Adam over f32 masters): "
        f"{min(walls) * 1e3:.2f} ms (best of 3; "
        f"{toks_s:.0f} tokens/s), cost {cost.item():.4f}, launches a step "
        f"{launches}")
    neo_train = {"bf16_step_ms": min(walls) * 1e3, "tokens_per_s": toks_s}
    del tr, trees, params
    gc.collect()
    torch.cuda.empty_cache()

    prompts = workload(seed, cfg["vocab"])
    serving = {}
    for wdt in (torch.float32, torch.bfloat16):
        wname = str(wdt).split(".")[1]
        model.to(wdt)
        for kv in (None, "int8"):
            run = f"ServingEngine {wname} {kv or wname} KV"
            eng = ServingEngine(model, device=device, kv_dtype=kv, **ENGINE)
            if wdt == torch.bfloat16:       # the figures: a warm engine's
                serve(model, prompts, device, eng=eng)
            seg0 = eng.pool.segments_total
            adm0 = eng.pool.admissions_total
            (toks, lat, wall, eng), _, runs[run], _ = counted(
                lambda: serve(model, prompts, device, eng=eng))
            steps = (eng.pool.segments_total - seg0) * eng.pool.segment
            name = ("paged_decode_attention_q" if kv
                    else "paged_decode_attention")
            check(runs[run].get(name) == L * steps
                  and runs[run].get("flash_attention_fwd")
                  == L * (eng.pool.admissions_total - adm0),
                  f"{run}: launches {runs[run]}, want {L} x {steps} {name}")
            if wdt == torch.float32:
                solo = [model.generate_fused(
                    torch.as_tensor(p[None].astype(np.int64),
                                    device=device),
                    NEW_TOKENS, kv_dtype=kv, route="plain")[0, len(p):]
                    .cpu().tolist() for p in prompts]
                same_tokens(toks, solo, f"GPT-Neo widths {run}")
                held = "equal to each request's solo plain-attention decode"
            else:
                ties = greedy_within_ties(model, prompts, toks, kv,
                                          f"GPT-Neo widths {run}", device)
                held = ("each the plain model's greedy choice up to a "
                        f"bf16 near-tie ({json.dumps(ties)})")
            serving[run] = latency_figures(lat, wall)
            if wdt == torch.float32:
                serving[run]["note"] = "the engine's first burst: its " \
                    "graphs' captures included"
            say(f"GPT-Neo widths {run}: {len(prompts)} requests x "
                f"{NEW_TOKENS} tokens {held}; launches {runs[run]}; "
                f"{json.dumps(serving[run])}")
            del eng
            gc.collect()
    gids = torch.as_tensor(rs.randint(0, cfg["vocab"], (2, 200)),
                           device=device)
    for kv in (None, "int8"):
        run = f"generate_fused bf16 {kv or 'bf16'} KV"
        name = "decode_attention_q" if kv else "decode_attention"
        got, _, runs[run], _ = counted(lambda: model.generate_fused(
            gids, 32, bucket=256, kv_dtype=kv))
        check(runs[run].get(name) == L * 31,
              f"{run}: launches {runs[run]}, want {L} x 31 {name}")
        ties = greedy_within_ties(model, gids.cpu().numpy(),
                                  got[:, 200:].cpu().tolist(), kv,
                                  f"GPT-Neo widths {run}", device)
        say(f"GPT-Neo widths {run}: 2 x 32 tokens, each the plain model's "
            f"greedy choice up to a bf16 near-tie ({json.dumps(ties)}); "
            f"launches {runs[run]}")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": runs, "serving": serving, "training": neo_train}


def lean_step_check(say, what, loss_k, loss_p, params, batch, lr,
                    per_step):
    """transformer_step_check's bounds on one f32 Adam step, with the
    step's arithmetic written out instead of two trainers (which would
    hold two copies of a 1.3B model's parameters and Adam states): the
    loss and the gradients of both routes by autograd, each parameter's
    first Adam update p - lr * g / (|g| + eps) (bias-corrected m and v of
    one step), the loss to rtol 1e-6, each gradient to 1e-4 of its L2
    norm, each updated parameter within 1e-5 plus what the update makes
    of a gradient difference of 1e-4 of the entry and of the tensor's
    rms. #1-#3 launch ``per_step`` times on the kernel route, never on the
    plain one. Returns the kernel route's launches."""
    import torch
    from paddle_tpu_torch.core.pytree import tree_items, tree_map
    from paddle_tpu_torch.ops import cuda_kernels as ck
    norm = torch.linalg.vector_norm
    res = {}
    for route, loss_fn in ((None, loss_k), ("plain", loss_p)):
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
        ck.reset_launch_counts()
        loss = loss_fn(leaves, *batch)
        grads = torch.autograd.grad(loss, [v for _, v in tree_items(leaves)])
        torch.cuda.synchronize()
        launched = {n: ck.LAUNCHES[n] for n in ATTENTION_KERNELS}
        want = {n: per_step if route is None else 0
                for n in ATTENTION_KERNELS}
        check(launched == want, f"{what} f32 step, route {route}: launches "
              f"{launched} != {want}")
        res[route] = (loss.item(), grads, launched)
        del leaves, loss
    (lk, gk, launched), (lp, gp, _) = res[None], res["plain"]
    check(abs(lk - lp) <= 1e-6 * abs(lp), f"{what} f32 loss {lk} != plain "
          f"{lp}")
    eps, worst_g, worst_p = 1e-8, 0.0, 0.0
    for (path, p), a, b in zip(tree_items(params), gk, gp):
        name = "/".join(path)
        err, ref = norm(a - b).item(), norm(b).item()
        check(err <= 1e-4 * ref, f"{what} f32 step: gradient {name} differs "
              f"from plain: relative L2 {err / max(ref, 1e-30)}")
        worst_g = max(worst_g, err / max(ref, 1e-30))
        g = b.abs()
        dg = 1e-4 * (g + g.square().mean().sqrt())
        allowed = 1e-5 + lr * dg * eps / (g + eps) ** 2
        step_k = p - lr * a / (a.abs() + eps)
        step_p = p - lr * b / (b.abs() + eps)
        diff = (step_k - step_p).abs()
        check(bool((diff <= allowed).all()), f"{what} f32 step: param {name} "
              f"differs from plain by {diff.max().item()}")
        worst_p = max(worst_p, diff.max().item())
    say(f"{what} f32 training step (2 x {NEO_TRAIN_T} tokens, full depth), "
        f"kernels vs plain on the card: loss {lk:.6f} vs {lp:.6f}; worst "
        f"gradient relative L2 {worst_g:.3e}; worst parameter difference "
        f"after Adam's first update {worst_p:.3e}; launches {launched}")
    return launched


def _wire_workload(seed, n, vocab):
    import numpy as np
    rs = np.random.RandomState(seed)
    return [(rs.randint(0, vocab, int(rs.randint(32, 257))).astype(np.int32),
             int(rs.randint(32, 257))) for _ in range(n)]


def _pct(xs, q):
    import numpy as np
    return float(np.percentile(np.asarray(xs, np.float64), q)) if xs else 0.0


def client_run(client, work, submit=None, deadline_s=240.0):
    """Submit every (prompt, new tokens) of ``work`` at once and stream
    them home by polling, timed on the client's clock as the benchmarks
    time them: (tokens per request, figures)."""
    submit = submit or (lambda p, n: client.submit_with_backoff(p, n))
    t0 = time.perf_counter()
    t_sub, t_first, t_done, toks = {}, {}, {}, {}
    pending = []
    for i, (p, n) in enumerate(work):
        t_sub[i] = time.perf_counter()
        pending.append((i, submit(p, n)))
        toks[i] = []
    while pending:
        check(time.perf_counter() - t0 < deadline_s,
              f"client run: {len(pending)} requests still open after "
              f"{deadline_s} s")
        for i, rid in list(pending):
            got, done, reason = client.poll(rid, len(toks[i]))
            now = time.perf_counter()
            if got and i not in t_first:
                t_first[i] = now
            toks[i].extend(got)
            if done:
                check(reason == "length", f"request {i} ended {reason!r}")
                t_done[i] = now
                pending.remove((i, rid))
        time.sleep(0.005)
    wall = time.perf_counter() - t0
    delivered = sum(len(t) for t in toks.values())
    ttft = [(t_first[i] - t_sub[i]) * 1e3 for i in t_first]
    tpot = [(t_done[i] - t_first[i]) / (len(toks[i]) - 1) * 1e3
            for i in t_done if len(toks[i]) > 1]
    return toks, {"requests": len(work), "delivered_tokens": delivered,
                  "tokens_per_s": delivered / wall, "wall_s": wall,
                  "ttft_p50_ms": _pct(ttft, 50), "ttft_p95_ms": _pct(ttft, 95),
                  "tpot_p50_ms": _pct(tpot, 50), "tpot_p95_ms": _pct(tpot, 95)}


class _EngineClient:
    """The in-process engine behind the client surface client_run polls
    (submit, poll): the wire plane's figures have their in-process
    counterpart on the same traffic."""

    def __init__(self, eng):
        self.eng = eng

    def poll(self, rid, cursor=0):
        return self.eng.poll(rid, cursor)


def _solo_check(model, work, toks, what, device, kv=None):
    """WIRE_CHECKED requests of a run against the solo plain decode: equal
    token for token in f32; in bf16 each token the plain model's greedy
    choice up to a near-tie (greedy_within_ties). Returns what was held."""
    import numpy as np
    import torch
    if model.dtype == torch.bfloat16:
        return greedy_within_ties(model, [w[0] for w in work[:WIRE_CHECKED]],
                                  [toks[i] for i in range(WIRE_CHECKED)], kv,
                                  what, device)
    got, want = [], []
    for i in range(WIRE_CHECKED):
        p, n = work[i]
        ids = torch.as_tensor(p[None].astype(np.int64), device=device)
        want.append(model.generate_fused(ids, n, kv_dtype=kv, route="plain")
                    [0, len(p):].cpu().tolist())
        got.append(toks[i])
    same_tokens(got, want, what)
    return {"tokens": sum(len(t) for t in got), "equal_to_solo": True}


def _fleet(model, kv, device, router_ttl=2.0):
    """A ServingRouter over two decode daemons (WIRE_ROUTER_SLOTS each)
    and one PrefillDaemon, all joined: (router, [decode, decode,
    prefill])."""
    from paddle_tpu_torch.serving import (PagePool, PrefillDaemon,
                                          ServingDaemon, ServingEngine,
                                          ServingRouter)
    router = ServingRouter(ttl=router_ttl, scrape_interval_s=0.1).start()
    daemons = []
    try:
        for i in range(2):
            dd = ServingDaemon(ServingEngine(
                model, slots=WIRE_ROUTER_SLOTS, kv_dtype=kv, device=device,
                queue_cap=4 * WIRE_ROUTER_REQUESTS, **WIRE_POOL)).start()
            dd.join_router(router.address, f"decode-{i}")
            daemons.append(dd)
        pool = PagePool(model, slots=WIRE_PREFILL_SLOTS, kv_dtype=kv,
                        device=device, **WIRE_POOL)
        pd = PrefillDaemon(pool).start()
        pd.join_router(router.address, "prefill-0", role="prefill")
        daemons.append(pd)
    except Exception:
        for x in daemons:
            x.stop()
        router.stop()
        raise
    return router, daemons


def wire_phase(say, seed: int, device="cuda", config=GPT2_SMALL) -> dict:
    """(c) The wire plane over GPT-2 small (phase 10's model) in bf16:
    one ServingDaemon (16 slots) answering 24 requests over localhost,
    the same traffic through the in-process engine for scale, and a
    ServingRouter over one PrefillDaemon and two decode daemons (8 slots
    each) answering 16 requests at bf16 and int8 KV; 8 requests of each
    run held to the solo plain decode (in bf16 up to near-ties:
    greedy_within_ties); shipped rows byte-equal to the prefill pool's.
    Then the same fleet in f32, where the solo check is exact: 8 requests
    equal to the solo plain decode, a decode worker stopped with no drain
    mid-stream re-routed with no token lost or duplicated, and a
    ``srv.ship`` corrupt refused with data_loss and never adopted. Counts
    set to 0 just before each run and read just after; returns figures
    and launches."""
    import numpy as np
    import torch
    from paddle_tpu_torch.models import TransformerLM
    from paddle_tpu_torch.serving import (RouterClient, ServingClient,
                                          ServingDaemon, ServingEngine, ship)
    model = TransformerLM(**config).init(seed=seed, device=device)
    model.to(torch.bfloat16)
    vocab = config["vocab"]
    figs, launches, held = {}, {}, {}
    work = _wire_workload(seed + 30, WIRE_DAEMON_REQUESTS, vocab)
    warm = [(np.full(256, 7, np.int32), 256)] * 4

    # the in-process engine on the daemon's traffic (the yardstick)
    eng = ServingEngine(model, slots=WIRE_DAEMON_SLOTS, device=device,
                        queue_cap=4 * WIRE_DAEMON_REQUESTS, **WIRE_POOL)
    eng.start()
    try:
        client_run(_EngineClient(eng), warm,
                   submit=lambda p, n: eng.submit(p, n))
        _, figs["in-process engine"] = client_run(
            _EngineClient(eng), work, submit=lambda p, n: eng.submit(p, n))
    finally:
        eng.stop()
    del eng
    # one daemon over localhost
    d = ServingDaemon(ServingEngine(
        model, slots=WIRE_DAEMON_SLOTS, device=device,
        queue_cap=4 * WIRE_DAEMON_REQUESTS, **WIRE_POOL)).start()
    try:
        c = ServingClient(*d.address, call_timeout=120.0)
        client_run(c, warm)
        (toks, figs["daemon"]), _, launches["daemon"], _ = counted(
            lambda: client_run(c, work))
        c.close()
    finally:
        d.stop()
    held["daemon"] = _solo_check(model, work, toks, "daemon bf16", device)
    say(f"wire: ServingDaemon ({WIRE_DAEMON_SLOTS} slots) over localhost, "
        f"{len(work)} requests, {WIRE_CHECKED} held to the solo plain "
        f"decode {json.dumps(held['daemon'])}; client-side "
        f"{json.dumps(figs['daemon'])}; the in-process engine on the same "
        f"traffic {json.dumps(figs['in-process engine'])}; launches "
        f"{launches['daemon']}")

    rwork = _wire_workload(seed + 31, WIRE_ROUTER_REQUESTS, vocab)
    for kv in (None, "int8"):
        tag = f"router {kv or 'bf16'} KV"
        router, daemons = _fleet(model, kv, device)
        try:
            c = RouterClient(*router.address, call_timeout=120.0)
            client_run(c, warm)
            (toks, figs[tag]), _, launches[tag], _ = counted(
                lambda: client_run(c, rwork))
            adopted = sum(x.engine.pool.prompt_tokens_total
                          for x in daemons[:2])
            check(all(x.engine.pool.admissions_total == 0
                      for x in daemons[:2]),
                  f"{tag}: a decode worker prefilled (no shipment)")
            c.close()
        finally:
            for x in daemons:
                x.stop()
            router.stop()
        held[tag] = _solo_check(model, rwork, toks, tag, device, kv)
        say(f"wire: ServingRouter over 1 prefill + 2 decode daemons "
            f"({WIRE_ROUTER_SLOTS} slots each) at {kv or 'bf16'} KV, "
            f"{len(rwork)} requests (the decode pools adopted {adopted} "
            f"shipped prompt tokens, warm-up included, and prefilled none), "
            f"{WIRE_CHECKED} held to the solo plain decode "
            f"{json.dumps(held[tag])}; client-side {json.dumps(figs[tag])}; "
            f"launches {launches[tag]}")
        figs[f"shipped rows {kv or 'bf16'} KV"] = _shipped_rows_check(
            model, kv, device, ship)

    # f32: the exact checks (solo tokens, re-route, a corrupted shipment)
    model.to(torch.float32)
    tag = "router f32 KV"
    router, daemons = _fleet(model, None, device)
    try:
        c = RouterClient(*router.address, call_timeout=120.0)
        (toks, figs[tag]), _, launches[tag], _ = counted(
            lambda: client_run(c, rwork[:WIRE_CHECKED]))
        held[tag] = _solo_check(model, rwork, toks, tag, device)
        figs["reroute"] = _reroute_check(c, daemons, router, model, device)
        figs["ship_corrupt"] = _ship_corrupt_check(daemons[-1], daemons[0])
        c.close()
    finally:
        for x in daemons:
            x.stop()
        router.stop()
    say(f"wire: ServingRouter f32, {WIRE_CHECKED} requests equal to the "
        f"solo plain decode; client-side {json.dumps(figs[tag])}; re-route "
        f"{json.dumps(figs['reroute'])}; ship corrupt "
        f"{json.dumps(figs['ship_corrupt'])}; launches {launches[tag]}; "
        f"a 200-token prompt's shipment, byte-equal once adopted: bf16 KV "
        f"{json.dumps(figs['shipped rows bf16 KV'])}, int8 KV "
        f"{json.dumps(figs['shipped rows int8 KV'])}")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return {"figures": figs, "held": held, "launches": launches}


def _shipped_rows_check(model, kv, device, ship):
    """A prompt prefilled in one pool, exported, chunked, reassembled and
    adopted by a second engine: the adopted pages' rows equal the prefill
    pool's byte for byte (every pool array, the int8 scales included)."""
    import numpy as np
    import torch
    from paddle_tpu_torch.serving import PagePool, Request, ServingEngine
    rs = np.random.RandomState(7)
    prompt = rs.randint(0, GPT2_SMALL["vocab"], 200).astype(np.int32)
    pre = PagePool(model, slots=2, kv_dtype=kv, device=device, **WIRE_POOL)
    r = Request(-1, prompt, 16)
    pre.validate(r)
    plan = pre.plan_admission(prompt, pre.effective_budget(200, 16))
    first = int(pre.admit([(1, plan)])[1])
    npg = -(-200 // pre.bs)
    pages = torch.as_tensor(pre.tables[1, :npg].astype(np.int64),
                            device=device)
    src = {nm: a[pages].clone() for nm, a in pre.pools.items()}
    t = [time.perf_counter()]
    manifest, payload = pre.export_slot(1, first)
    t.append(time.perf_counter())
    frames = list(ship.iter_chunks(payload))
    asm = ship.ChunkAssembler(frames[0][1])
    for seq, _, fr in frames:
        asm.add(seq, fr["data"], fr["crc"])
    t.append(time.perf_counter())
    arrays = ship.unpack(manifest, asm.payload())
    t.append(time.perf_counter())
    eng = ServingEngine(model, slots=2, kv_dtype=kv, device=device,
                        **WIRE_POOL)
    rid = eng.submit_prefilled(manifest["plen"], manifest["first"], arrays,
                               max_new=16)
    eng.admit_prefill()
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    slot = next(s for s, rec in eng._live.items() if rec.rid == rid)
    dst = torch.as_tensor(eng.pool.tables[slot, :npg].astype(np.int64),
                          device=device)
    for nm, rows in src.items():
        got = eng.pool.pools[nm][dst]
        check(got.dtype == rows.dtype and torch.equal(
            got.view(torch.uint8) if got.dtype != torch.bfloat16
            else got.view(torch.int16),
            rows.view(torch.uint8) if rows.dtype != torch.bfloat16
            else rows.view(torch.int16)),
              f"shipped rows {nm} ({kv or 'bf16'} KV) differ from the "
              "prefill pool's")
    # the host's seconds of each step of the hop (no RPC: the frames'
    # JSON and the sockets come on top in the fleet)
    return {"arrays": len(src), "pages": npg, "payload_bytes": len(payload),
            "chunks": len(frames), "byte_equal": True,
            "export_ms": (t[1] - t[0]) * 1e3,
            "chunk_and_reassemble_ms": (t[2] - t[1]) * 1e3,
            "unpack_ms": (t[3] - t[2]) * 1e3,
            "submit_and_adopt_ms": (t[4] - t[3]) * 1e3}


def _reroute_check(c, daemons, router, model, device):
    """Stop the decode worker holding a live stream, with no drain: the
    router re-prefills prompt + delivered tokens on the survivor, and the
    client's whole sequence equals the solo plain decode."""
    import numpy as np
    import torch
    rs = np.random.RandomState(9)
    prompt, n = rs.randint(0, GPT2_SMALL["vocab"], 120), 160
    rid = c.submit(prompt, n)
    toks = []
    t0 = time.perf_counter()
    while not toks:
        check(time.perf_counter() - t0 < 60, "re-route: no first token")
        got, done, _ = c.poll(rid, 0)
        toks.extend(got)
        check(not done, "re-route: the stream finished before the stop")
        time.sleep(0.002)
    rec = router._recs[rid]
    victim = next(x for x in daemons[:2]
                  if x._mbr_worker == rec.worker)
    victim.stop()
    daemons.remove(victim)
    cursor = before = len(toks)
    while True:
        check(time.perf_counter() - t0 < 300, "re-route: stream stalled")
        got, done, reason = c.poll(rid, cursor)
        toks.extend(got)
        cursor += len(got)
        if done:
            check(reason == "length", f"re-route: ended {reason!r}")
            break
        time.sleep(0.005)
    want = model.generate_fused(torch.as_tensor(prompt[None], device=device),
                                n, route="plain")[0, len(prompt):].cpu()
    same_tokens([toks], [want.tolist()], "re-routed stream")
    check(rec.reroutes == 1, f"re-route: {rec.reroutes} re-routes")
    return {"tokens_before_stop": before, "reroutes": rec.reroutes,
            "tokens": len(toks), "equal_to_solo": True}


def _ship_corrupt_check(pd, decode):
    """``srv.ship`` corrupting the first chunk of a prefill's shipment:
    the decode worker refuses it (data_loss, a CRC), admits nothing and
    holds no reassembly."""
    from paddle_tpu_torch import faults
    from paddle_tpu_torch.runtime import MasterClient
    raw = MasterClient(*pd.address, call_timeout=60.0)
    host, port = decode.address
    before = decode.engine._next_rid
    plan = faults.FaultPlan(seed=3).add("srv.ship", "corrupt", nth=1)
    try:
        with plan.installed():
            r = raw._call({"op": "srv_prefill", "prompt": list(range(1, 90)),
                           "max_new": 8, "decode_host": host,
                           "decode_port": port})
    finally:
        raw.close()
    check(not r.get("ok") and r.get("code") == "data_loss"
          and "CRC" in str(r.get("error")),
          f"ship corrupt: the decode worker answered {r}")
    check(decode.engine._next_rid == before and not decode._ships,
          "ship corrupt: a corrupted shipment was adopted or kept")
    return {"code": r["code"], "fired": plan.fired, "adopted": False}


def slice19_phase(say, seed: int, device="cuda") -> dict:
    """Phase 18: (a) #1-#7 at head widths 8/32/80/128 against plain, the
    causal S != T and 16-byte-view routes, the D = 128 timings; (b) GPT-Neo
    1.3B's widths training and serving; (c) the wire plane."""
    import torch
    # the node counts graph_launch_check memoized hold the earlier phases'
    # graphs (and their memory pools) alive: GPT-Neo's widths need the room
    _GRAPH_NODES.clear()
    gc.collect()
    torch.cuda.empty_cache()
    say(f"phase 18: {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB "
        "allocated at its start")
    gen = torch.Generator().manual_seed(seed + 19)
    t0 = time.perf_counter()
    WIDTH_ERRS["flash"] = width_flash_checks(say, gen, device)
    WIDTH_ERRS["decode"] = width_decode_checks(say, gen, device)
    entries = width_timings(say, gen, device)
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    neo = gpt_neo_phase(say, seed, device)
    t2 = time.perf_counter()
    wire = wire_phase(say, seed, device)
    t3 = time.perf_counter()
    for e in entries:
        e["launches"] = sum(n.get(e["name"], 0)
                            for n in neo["launches"].values())
        e["launches_note"] = {run: n.get(e["name"], 0)
                              for run, n in neo["launches"].items()}
    seconds = {"widths": t1 - t0, "gpt_neo": t2 - t1, "wire": t3 - t2}
    say(f"phase 18 seconds: {json.dumps(seconds)}")
    return {"entries": entries, "gpt_neo": {k: v for k, v in neo.items()},
            "wire": wire, "seconds": seconds}


# ---------------------------------------------------------------------------
# phase 19: head widths up to 256 (ROADMAP B.1.4) and GPT-J-6B's widths
# ---------------------------------------------------------------------------

# GPT-J-6B's attention and MLP widths (EleutherAI/gpt-j-6b config.json:
# n_embd 4096, n_head 16, rotary_dim aside, n_inner 4 * 4096, vocab
# 50400), cut to 4 of its 28 layers for the smoke's time (about 1.0 B
# parameters; a f32 Adam step holds about 16 GB)
GPTJ = dict(vocab=50400, d_model=4096, n_heads=16, n_layers=4, d_ff=16384,
            max_len=2048)
# the widths phase 19 holds #1-#7 at: off the multiples of 8 (12), between
# the built widths (136, 200) and the widest built one (256, GPT-J's and
# Gemma's heads)
WIDE_WIDTHS = (12, 136, 200, 256)
# the errors of phase 19's width checks, for the D = 256 entries
WIDE_ERRS: dict = {}


def wide_bwd_bits(say, gen, device) -> dict:
    """#2 and #3 at D = 256 (csrc/flash_wide.cu) run twice on the same
    inputs, f32 and bf16: bit-equal (one owner a sum, a fixed order, no
    atomics)."""
    import torch
    from paddle_tpu_torch.ops import cuda_kernels as ck
    B, T, H, D = NEO_TRAIN_B, 512, WIDTH_H, 256
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).split(".")[1]
        q, k, v, do = (torch.randn((B, T, H, D), generator=gen).to(device, dt)
                       for _ in range(4))
        o, lse = ck.flash_attention_fwd(q, k, v, causal=True)
        a = ck.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
        b = ck.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
        same = all(torch.equal(x, y) for x, y in zip(a, b))
        check(same, f"D=256 {dname} backward: two runs differ")
        out[dname] = same
    say(f"#2 and #3 at D = 256 (B={B} T={T} H={H} causal): two runs "
        f"bit-equal {json.dumps(out)}")
    return out


def gptj_phase(say, seed: int, device="cuda") -> dict:
    """A TransformerLM at GPT-J-6B's attention and MLP widths (GPTJ, 4
    layers): one f32 training step through the Trainer's graph on both
    routes, kernels against plain (transformer_step_check's Adam-aware
    bounds); one graphed bf16 step timed; ServingEngine with f32 weights
    at f32 KV (phase 10's burst, tokens equal to each request's solo plain
    decode) and int8 KV (each token the plain model's greedy choice up to
    a near-tie, greedy_within_ties), the figures from a second burst on
    the warm engine; generate_fused at f32 and int8 KV against the same
    loop on the plain route. Each path's counts set to 0 just before and
    read just after; #1-#7 all launch at D = 256."""
    import numpy as np
    import torch
    from paddle_tpu_torch.models import TransformerLM
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.trainer import Trainer
    runs = {}
    cfg = GPTJ
    L = cfg["n_layers"]
    model = TransformerLM(**cfg).init(seed=seed, device=device)
    n_params = sum(t.numel() for t in model.parameters())
    check(model.blocks[0].d_head == 256, "GPT-J widths: head width "
          f"{model.blocks[0].d_head}")
    say(f"GPT-J-6B widths ({L} of 28 layers): {n_params / 1e9:.3f} B "
        f"parameters, head width {model.blocks[0].d_head}")
    rs = np.random.RandomState(seed + 20)
    ids = torch.as_tensor(rs.randint(0, cfg["vocab"], (NEO_TRAIN_B,
                                                       NEO_TRAIN_T + 1)),
                          device=device)
    params = model.tree()
    _, wall, runs["f32 graphed step"], _ = counted(
        lambda: transformer_step_check(
            say, "GPT-J widths", lambda r: lm_loss(model, torch.float32, r),
            params, (ids,), NEO_LR, L, device, row_scale=True))
    gc.collect()
    torch.cuda.empty_cache()
    tr = Trainer(lm_loss(model, torch.bfloat16), Adam(NEO_LR), device=device)
    trees = [params, tr.opt.init(params)]

    def step():
        trees[0], trees[1], cost = tr.step(*trees, ids)
        return cost
    step()                                         # eager + capture
    (cost,), _, launches, disp = counted(lambda: [step()])
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    check(step_dispatches(disp, "step") == {"captures": 0, "replays": 1}
          and launches == {n: L for n in ATTENTION_KERNELS}
          and torch.isfinite(cost).item(),
          f"GPT-J widths bf16 graphed step: dispatches "
          f"{step_dispatches(disp, 'step')}, launches {launches}, cost "
          f"{cost.item()}")
    runs["bf16 graphed step"] = launches
    toks_s = NEO_TRAIN_B * NEO_TRAIN_T / min(walls)
    say(f"GPT-J widths bf16 graphed training step ({NEO_TRAIN_B} x "
        f"{NEO_TRAIN_T} tokens, Adam over f32 masters): "
        f"{min(walls) * 1e3:.2f} ms (best of 3; {toks_s:.0f} tokens/s), "
        f"cost {cost.item():.4f}, launches a step {launches}")
    training = {"bf16_step_ms": min(walls) * 1e3, "tokens_per_s": toks_s}
    del tr, trees, params
    gc.collect()
    torch.cuda.empty_cache()

    prompts = workload(seed, cfg["vocab"])
    serving = {}
    for kv in (None, "int8"):
        run = f"ServingEngine float32 {kv or 'float32'} KV"
        (toks, _, _, eng), _, runs[run], _ = counted(
            lambda: serve(model, prompts, device, kv_dtype=kv))
        steps = eng.pool.segments_total * eng.pool.segment
        name = "paged_decode_attention_q" if kv else "paged_decode_attention"
        check(runs[run].get(name) == L * steps
              and runs[run].get("flash_attention_fwd")
              == L * eng.pool.admissions_total,
              f"{run}: launches {runs[run]}, want {L} x {steps} {name}")
        if kv is None:
            solo = [model.generate_fused(
                torch.as_tensor(p[None].astype(np.int64), device=device),
                NEW_TOKENS, route="plain")[0, len(p):].cpu().tolist()
                for p in prompts]
            same_tokens(toks, solo, f"GPT-J widths {run}")
            held = "equal to each request's solo plain-attention decode"
        else:
            # int8 KV: the kernel and plain routes' hidden states differ
            # by f32 rounding, and a value that close to a rounding
            # boundary of its row's int8 codebook takes the next code, a
            # step of 1/127 of the row's largest value: so exact equality
            # with a plain-route decode is not a sound check at int8 KV
            # (phase 18's bf16 reason); each token is held to the plain
            # model's greedy choice at int8 KV up to a near-tie
            ties = greedy_within_ties(model, prompts, toks, kv,
                                      f"GPT-J widths {run}", device)
            held = ("each the plain model's greedy choice at int8 KV up to "
                    f"a near-tie ({json.dumps(ties)})")
        # the figures: a second burst on the warm engine (graphs captured)
        _, lat, wall, eng = serve(model, prompts, device, eng=eng)
        serving[run] = latency_figures(lat, wall)
        say(f"GPT-J widths {run}: {len(prompts)} requests x {NEW_TOKENS} "
            f"tokens {held}; launches {runs[run]}; the warm engine's second "
            f"burst: {json.dumps(serving[run])}")
        del eng
        gc.collect()
    gids = torch.as_tensor(rs.randint(0, cfg["vocab"], (2, 200)),
                           device=device)
    for kv in (None, "int8"):
        run = f"generate_fused float32 {kv or 'float32'} KV"
        name = "decode_attention_q" if kv else "decode_attention"
        got, _, runs[run], _ = counted(lambda: model.generate_fused(
            gids, 32, bucket=256, kv_dtype=kv))
        check(runs[run].get(name) == L * 31,
              f"{run}: launches {runs[run]}, want {L} x 31 {name}")
        want = model.generate_fused(gids, 32, bucket=256, kv_dtype=kv,
                                    route="plain")
        same_tokens(got[:, 200:].cpu(), want[:, 200:].cpu(),
                    f"GPT-J widths {run}")
        say(f"GPT-J widths {run}: 2 x 32 tokens equal to the same loop on "
            f"the plain route; launches {runs[run]}")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": runs, "serving": serving, "training": training,
            "parameters": n_params}


def slice20_widths_phase(say, seed: int, device="cuda") -> dict:
    """Phase 19: (a) #1-#7 at head widths 12/136/200/256 against plain
    (f32 and bf16; causal S != T and views off the 16-byte rule at 256 and
    200), #2/#3 at 256 bit-equal run to run, the D = 256 timings; (b)
    GPT-J-6B's widths training and serving."""
    import torch
    _GRAPH_NODES.clear()
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator().manual_seed(seed + 20)
    t0 = time.perf_counter()
    WIDE_ERRS["flash"] = width_flash_checks(say, gen, device,
                                            widths=WIDE_WIDTHS,
                                            views=(256, 200))
    WIDE_ERRS["decode"] = width_decode_checks(say, gen, device,
                                              widths=WIDE_WIDTHS)
    bits = wide_bwd_bits(say, gen, device)
    entries = width_timings(say, gen, device, D=256, errs=WIDE_ERRS)
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    gptj = gptj_phase(say, seed, device)
    t2 = time.perf_counter()
    for e in entries:
        if e["name"].startswith("flash"):
            e["body"] = "paddle_tpu_torch/csrc/flash_wide.cu"
        e["launches"] = sum(n.get(e["name"], 0)
                            for n in gptj["launches"].values())
        e["launches_note"] = {run: n.get(e["name"], 0)
                              for run, n in gptj["launches"].items()}
        check(e["launches"] > 0, f"GPT-J widths: {e['name']} never "
              "launched at D = 256")
    seconds = {"widths": t1 - t0, "gpt_j": t2 - t1}
    say(f"phase 19 seconds: {json.dumps(seconds)}")
    return {"entries": entries, "gpt_j": gptj, "bwd_bit_equal": bits,
            "seconds": seconds}


# ---------------------------------------------------------------------------
# phase 20: the fluid plane (Program IR + Executor) through #8-#12
# ---------------------------------------------------------------------------

# the LSTM flagship as a fluid program: benchmarks/lstm_textcls.py's
# widths (phase 5's TEXTCLS), Adam 2e-3, batch 64, padded length 100,
# lengths 30..100, 20 exe.run steps over 4 batches
FLUID_STEPS, FLUID_NBUF = 20, 4
# the dynamic_gru program at the seq2seq bench's widths: batch 64, embed
# and hidden 512, T 32 (lengths 16..32), 10 steps
FLUID_GRU = dict(vocab=30000, embed=512, hidden=512, batch=64, seq=32,
                 steps=10)
# benchmarks/fluid_executor.py's MLP: fc 784-256-64-10, Adam, batch 256,
# 200 timed runs
FLUID_MLP_BATCH, FLUID_MLP_RUNS = 256, 200


def _fluid_textcls(fl, cell, vocab, embed, hidden, lr):
    """A text classifier as a fluid program: embedding -> dynamic_lstm (or
    dynamic_gru) -> sequence_last_step -> fc 2 -> softmax CE -> mean, Adam.
    Returns (logits, loss)."""
    layers = fl.layers
    words = layers.data("words", shape=(-1,), dtype="int32")
    lens = layers.data("lens", shape=(), dtype="int32")
    label = layers.data("label", shape=(), dtype="int32")
    emb = layers.embedding(words, (vocab, embed))
    rnn = layers.dynamic_lstm if cell == "lstm" else layers.dynamic_gru
    last = layers.sequence_last_step(rnn(emb, lens, hidden), lens)
    logits = layers.fc(last, 2)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    fl.AdamOptimizer(lr).minimize(loss)
    return logits, loss


def _fluid_feed(batch):
    data, lengths, labels = batch
    return {"words": data, "lens": lengths, "label": labels}


def _fluid_scope(vars, device):
    """A fresh scope holding copies of ``vars`` (name -> tensor)."""
    from paddle_tpu_torch import fluid
    scope = fluid.Scope()
    for n, v in vars.items():
        scope.set(n, v.detach().clone().to(device))
    return scope


def fluid_step_check(say, what, main, start_vars, feed, loss, device):
    """One f32 exe.run of ``main`` from ``start_vars`` through the kernels
    against the same run with the kernels routed plain: f32_step_check's
    bounds (the loss to 1e-5, Adam's first moments to rtol 1e-4 plus 1e-5
    of each tensor's largest, the parameters to 1e-5)."""
    import torch
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid.registry import routed
    res = {}
    for route in (None, "plain"):
        exe = fluid.Executor(device=device,
                             scope=_fluid_scope(start_vars, device))
        with routed(route):
            out, = exe.run(main, feed=feed, fetch_list=[loss],
                           return_numpy=False)
        res[route] = (float(out), exe.scope)
    (lk, sk), (lp, sp) = res[None], res["plain"]
    check(abs(lk - lp) <= 1e-5, f"{what}: f32 loss {lk} != plain {lp}")
    worst = {}
    for n in start_vars:
        a, b = sk.get(n), sp.get(n)
        if n.endswith("@moment1"):
            atol = 1e-5 * b.abs().max().item()
            ok = torch.allclose(a, b, rtol=1e-4, atol=atol)
        elif "@" in n or not a.is_floating_point():
            continue
        else:
            ok = (a - b).abs().max().item() <= 1e-5
        worst[n] = (a - b).abs().max().item()
        check(ok, f"{what}: {n} differs from plain by {worst[n]}")
    say(f"{what}, kernels vs plain on the card: loss {lk:.6f} vs "
        f"{lp:.6f}; max abs differences {json.dumps(worst)}")
    return worst


def fluid_flagship(say, seed: int, device="cuda") -> dict:
    """(a) The LSTM flagship as a fluid program, 20 exe.run steps: #9 and
    #10 once a step, one graph capture for the key; the losses fall; one
    f32 step equal to the plain route's; graphed and eager ms a step.
    (b) Its inference bundle: export -> load -> 2 held batches through #8,
    equal to the plain route."""
    import tempfile
    import torch
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid.registry import routed
    cfg = TEXTCLS
    fluid.reset_default_programs()
    logits, loss = _fluid_textcls(fluid, "lstm", cfg["vocab"], cfg["embed"],
                                  cfg["hidden"], TEXTCLS_LR)
    main, start = fluid.default_main_program(), fluid.default_startup_program()
    exe = fluid.Executor(device=device, scope=fluid.Scope())
    exe.run(start)
    start_vars = {n: v.detach().clone() for n, v in exe.scope.vars.items()}
    batches = textcls_batches(seed + 30, FLUID_NBUF + 2, device)
    train, held = batches[:FLUID_NBUF], batches[FLUID_NBUF:]
    check_res = fluid_step_check(say, "fluid LSTM flagship", main,
                                 start_vars, _fluid_feed(train[0]), loss,
                                 device)

    def run_steps(ex, n):
        return [ex.run(main, feed=_fluid_feed(train[i % FLUID_NBUF]),
                       fetch_list=[loss], return_numpy=False)[0]
                for i in range(n)]
    outs, wall, launches, disp = counted(lambda: run_steps(exe, FLUID_STEPS))
    losses = [float(o) for o in outs]
    want = {"lstm_seq_train": FLUID_STEPS, "lstm_seq_bwd": FLUID_STEPS}
    mine = step_dispatches(disp, "fluid.run")
    check(launches == want, f"fluid flagship: launches {launches} != {want}")
    check(mine == {"captures": 1, "replays": FLUID_STEPS - 1},
          f"fluid flagship: graphs {mine}, want one capture for the key")
    first, last = (sum(losses[:FLUID_NBUF]) / FLUID_NBUF,
                   sum(losses[-FLUID_NBUF:]) / FLUID_NBUF)
    check(last < first, f"fluid flagship: losses did not fall ({first} -> "
          f"{last})")
    # graphed ms a step (the key's graph warm) and eager ms a step
    timed = {}
    for route in ("graphed", "eager"):
        with _route(route):
            run_steps(exe, 2)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_steps(exe, 10)
            torch.cuda.synchronize()
            timed[route] = (time.perf_counter() - t0) * 1e3 / 10
    say(f"fluid LSTM flagship ({TEXTCLS_BATCH} x {TEXTCLS_LEN}, embed "
        f"{cfg['embed']}, LSTM {cfg['hidden']}, Adam): {FLUID_STEPS} "
        f"exe.run steps, losses {losses[0]:.4f} -> {losses[-1]:.4f} (means "
        f"of the first and last {FLUID_NBUF}: {first:.4f} -> {last:.4f}); "
        f"launches {launches}; graphs {mine}; ms a step graphed "
        f"{timed['graphed']:.3f}, eager {timed['eager']:.3f}")
    # (b) the inference bundle
    with tempfile.TemporaryDirectory() as d:
        fluid.io.export_inference_model(d, ["words", "lens"], [logits], exe,
                                        main)
        iexe = fluid.Executor(device=device, scope=fluid.Scope())
        prog, feeds, fetches = fluid.io.load_inference_model(d, iexe)
        pexe = fluid.Executor(device=device, scope=fluid.Scope())
        fluid.io.load_inference_model(d, pexe)
    feed_of = lambda b: {"words": b[0], "lens": b[1]}  # noqa: E731
    outs, _, inf_launches, _ = counted(lambda: [
        iexe.run(prog, feed=feed_of(b), fetch_list=fetches,
                 return_numpy=False)[0] for b in held])
    check(inf_launches == {"lstm_seq": len(held)},
          f"fluid bundle: launches {inf_launches}")
    errs = []
    with routed("plain"):
        for b, o in zip(held, outs):
            want, = pexe.run(prog, feed=feed_of(b), fetch_list=fetches,
                             return_numpy=False)
            errs.append((o - want).abs().max().item())
            check(torch.allclose(o, want, atol=F32_ATOL, rtol=F32_RTOL),
                  f"fluid bundle: logits differ from plain by {errs[-1]}")
    say(f"fluid inference bundle (export -> load, {len(held)} held "
        f"batches): launches {inf_launches}, logits within {max(errs):.3e} "
        "of the plain route")
    return {"train": {"launches": launches, "graphs": mine,
                      "losses_first_last": [losses[0], losses[-1]],
                      "ms_per_step": timed, "step_check": check_res},
            "bundle": {"launches": inf_launches, "max_abs_err": max(errs)}}


def fluid_gru_batch(seed: int, device):
    """(data [B, T] int32, lengths [B] int32 in T/2..T, labels [B]) at
    FLUID_GRU's widths; a label is the parity of the last valid token."""
    import numpy as np
    import torch
    g = FLUID_GRU
    rs = np.random.RandomState(seed)
    data = rs.randint(0, g["vocab"], (g["batch"], g["seq"])).astype(np.int32)
    lens = rs.randint(g["seq"] // 2, g["seq"] + 1, g["batch"]).astype(
        np.int32)
    labels = data[np.arange(g["batch"]), lens - 1] % 2
    return tuple(torch.as_tensor(a, device=device)
                 for a in (data, lens, labels))


def fluid_gru(say, seed: int, device="cuda") -> dict:
    """(c) A dynamic_gru program at the seq2seq bench's widths, 10 steps:
    #11 and #12 once a step, one f32 step equal to the plain route's."""
    from paddle_tpu_torch import fluid
    g = FLUID_GRU
    fluid.reset_default_programs()
    _, loss = _fluid_textcls(fluid, "gru", g["vocab"], g["embed"],
                             g["hidden"], S2S_LR)
    main, start = fluid.default_main_program(), fluid.default_startup_program()
    exe = fluid.Executor(device=device, scope=fluid.Scope())
    exe.run(start)
    start_vars = {n: v.detach().clone() for n, v in exe.scope.vars.items()}
    data, lens, labels = fluid_gru_batch(seed + 31, device)
    feed = {"words": data, "lens": lens, "label": labels}
    worst = fluid_step_check(say, "fluid dynamic_gru", main, start_vars,
                             feed, loss, device)
    outs, _, launches, disp = counted(lambda: [
        exe.run(main, feed=feed, fetch_list=[loss], return_numpy=False)[0]
        for _ in range(g["steps"])])
    want = {"gru_seq": g["steps"], "gru_seq_bwd": g["steps"]}
    check(launches == want, f"fluid gru: launches {launches} != {want}")
    losses = [float(o) for o in outs]
    check(losses[-1] < losses[0], f"fluid gru: losses {losses}")
    say(f"fluid dynamic_gru (batch {g['batch']}, hidden {g['hidden']}, T "
        f"{g['seq']}): {g['steps']} steps, losses {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}; launches {launches}; graphs "
        f"{step_dispatches(disp, 'fluid.run')}")
    return {"launches": launches, "step_check": worst}


def fluid_mlp(say, seed: int, device="cuda") -> dict:
    """(d) benchmarks/fluid_executor.py's MLP: 200 timed exe.run with
    return_numpy=False after a warm-up; ms a run, the cache hit rate and
    the graph captures inside the timed window (0); then an LRU of one key
    evicting and recapturing."""
    import numpy as np
    import torch
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.core import graphs
    fluid.reset_default_programs()
    layers = fluid.layers
    img = layers.data("img", shape=(784,))
    label = layers.data("label", shape=(), dtype="int32")
    h = layers.fc(layers.fc(img, 256, act="relu"), 64, act="relu")
    loss = layers.mean(layers.softmax_with_cross_entropy(layers.fc(h, 10),
                                                         label))
    fluid.AdamOptimizer(1e-3).minimize(loss)
    main = fluid.default_main_program()
    exe = fluid.Executor(device=device, scope=fluid.Scope())
    exe.run(fluid.default_startup_program())
    rs = np.random.RandomState(seed + 32)
    feed = {"img": torch.as_tensor(rs.randn(FLUID_MLP_BATCH, 784).astype(
        np.float32), device=device),
            "label": torch.as_tensor(rs.randint(0, 10, FLUID_MLP_BATCH)
                                     .astype(np.int32), device=device)}
    for _ in range(3):
        exe.run(main, feed=feed, fetch_list=[loss], return_numpy=False)
    stats0 = dict(exe.stats)
    torch.cuda.synchronize()
    graphs.reset_dispatch_counts()
    t0 = time.perf_counter()
    for _ in range(FLUID_MLP_RUNS):
        out, = exe.run(main, feed=feed, fetch_list=[loss],
                       return_numpy=False)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / FLUID_MLP_RUNS
    disp = step_dispatches(json.loads(json.dumps(graphs.DISPATCHES)),
                           "fluid.run")
    hits = exe.stats["cache_hits"] - stats0["cache_hits"]
    runs = exe.stats["runs"] - stats0["runs"]
    check(disp["captures"] == 0 and disp["replays"] == FLUID_MLP_RUNS,
          f"fluid MLP: graphs in the timed window {disp}")
    check(torch.isfinite(out).item(), "fluid MLP: loss not finite")
    # an LRU of one key: two batch shapes alternating evict each other
    lru = fluid.Executor(device=device, cache_capacity=1,
                         scope=_fluid_scope(exe.scope.vars, device))
    graphs.reset_dispatch_counts()
    for bs in (FLUID_MLP_BATCH, 128, FLUID_MLP_BATCH):
        lru.run(main, feed={k: v[:bs] for k, v in feed.items()},
                fetch_list=[loss])
    ev = step_dispatches(json.loads(json.dumps(graphs.DISPATCHES)),
                         "fluid.run")
    check(lru.stats["cache_evictions"] == 2 and ev["captures"] == 3
          and len(lru.graphs._graphs) == 1,
          f"fluid MLP LRU: evictions {lru.stats['cache_evictions']}, graphs "
          f"{ev}, live {len(lru.graphs._graphs)}")
    say(f"fluid MLP (784-256-64-10, Adam, batch {FLUID_MLP_BATCH}): "
        f"{FLUID_MLP_RUNS} timed exe.run (return_numpy=False): {ms:.4f} ms "
        f"a run, cache hit rate {hits / runs:.3f}, graph captures in the "
        f"window {disp['captures']}; an LRU of one key: 2 evictions, "
        f"{ev['captures']} captures, 1 graph live")
    return {"ms_per_run": ms, "hit_rate": hits / runs,
            "captures_in_window": disp["captures"],
            "lru": {"evictions": 2, "captures": ev["captures"]}}


def fluid_control_flow(say, device="cuda") -> dict:
    """(e) Small While, Cond and StaticRNN programs: the card's fetches
    equal the same programs run by the port on the CPU (While and Cond
    run eagerly, StaticRNN through its graph)."""
    import numpy as np
    from paddle_tpu_torch import fluid
    layers = fluid.layers
    out = {}

    def both(name, build, feed):
        # the startup's initializers draw from CPU generators, so both
        # devices start from the same weights
        fluid.reset_default_programs()
        fetch = build()
        got = {}
        for dev in (device, "cpu"):
            exe = fluid.Executor(device=dev, scope=fluid.Scope())
            exe.run(fluid.default_startup_program())
            before = exe.stats["eager_runs"]
            got[dev] = exe.run(feed=feed, fetch_list=fetch)
            got[dev + "_eager"] = exe.stats["eager_runs"] - before
        errs = [float(np.abs(a.astype(np.float64) - b).max())
                for a, b in zip(got[device], got["cpu"])]
        check(all(e <= 1e-5 for e in errs), f"fluid {name}: card vs CPU "
              f"{errs}")
        out[name] = {"max_abs_err": max(errs),
                     "eager_runs": got[device + "_eager"]}

    def while_prog():
        i = layers.fill_constant((), "int32", 0)
        n = layers.fill_constant((), "int32", 10)
        acc = layers.fill_constant((), "float32", 0.0)
        cond = layers.less_than(i, n)
        with fluid.While(cond).block():
            b = fluid.default_main_program().current_block()
            fi = layers.cast(i, "float32")
            b.append_op("elementwise_add", {"X": [acc.name], "Y": [fi.name]},
                        {"Out": [acc.name]})
            layers.increment(i)
            layers.less_than(i, n, cond=cond)
        return [acc, i]

    def cond_prog():
        x = layers.data("x", shape=())
        res = layers.fill_constant((), "float32", 0.0)
        c = fluid.Cond(layers.greater_than(
            x, layers.fill_constant((), "float32", 5.0)))
        with c.true_block():
            layers.assign(layers.elementwise_add(x, x), res)
        with c.false_block():
            layers.assign(x, res)
        return [res]

    def rnn_prog():
        x = layers.data("x", shape=(6, 8))
        rnn = fluid.StaticRNN()
        with rnn.step():
            x_t = rnn.step_input(x)
            h = rnn.memory(shape=(16,), value=0.0, batch_ref=x_t)
            h_new = layers.fc(layers.concat([x_t, h], axis=1), 16,
                              act="tanh")
            rnn.update_memory(h, h_new)
            rnn.step_output(h_new)
        return [rnn()[0]]

    both("While", while_prog, {})
    both("Cond", cond_prog, {"x": np.float32(7.0)})
    both("StaticRNN", rnn_prog, {"x": np.random.RandomState(5).randn(
        4, 6, 8).astype(np.float32)})
    check(out["While"]["eager_runs"] == 1 and out["Cond"]["eager_runs"] == 1
          and out["StaticRNN"]["eager_runs"] == 0,
          f"fluid control flow: eager runs {out}")
    say(f"fluid While, Cond and StaticRNN: card equal to the CPU "
        f"{json.dumps(out)}")
    return out


def fluid_phase(say, seed: int, device="cuda") -> dict:
    """Phase 20: the fluid plane, (a)-(e) (see each part)."""
    import torch
    _GRAPH_NODES.clear()
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    flag = fluid_flagship(say, seed, device)
    gru = fluid_gru(say, seed, device)
    mlp = fluid_mlp(say, seed, device)
    cf = fluid_control_flow(say, device)
    launches = {}
    for part in (flag["train"]["launches"], flag["bundle"]["launches"],
                 gru["launches"]):
        for k, n in part.items():
            launches[k] = launches.get(k, 0) + n
    seconds = time.perf_counter() - t0
    say(f"phase 20 seconds: {seconds:.1f}; launches {json.dumps(launches)}")
    return {"flagship": flag, "gru": gru, "mlp": mlp, "control_flow": cf,
            "launches": launches, "seconds": seconds}


# ---------------------------------------------------------------------------
# phase 21: the v2 DSL over the fluid plane, and Executor.run(verify=True)
# ---------------------------------------------------------------------------

# (a) trains 20 SGD.train steps over phase 20's 4 batches; (c) 10 steps
V2_STEPS, V2_GRU_STEPS = FLUID_STEPS, FLUID_GRU["steps"]


def _v2_textcls(v2, vocab, embed, hidden, lr, cell):
    """A v2 classifier: data(integer_value_sequence) -> embedding ->
    networks.simple_lstm -> last_seq (or networks.bidirectional_gru) ->
    fc 2 -> classification_cost, under Adam(lr). Returns (logits, cost,
    optimizer)."""
    L = v2.layer
    words = L.data("words", v2.data_type.integer_value_sequence(vocab))
    label = L.data("label", v2.data_type.integer_value(2))
    emb = L.embedding(words, embed)
    if cell == "lstm":
        feat = L.last_seq(v2.networks.simple_lstm(emb, hidden))
    else:
        feat = v2.networks.bidirectional_gru(emb, hidden)
    logits = L.fc(feat, 2)
    return logits, L.classification_cost(logits, label), \
        v2.optimizer.Adam(lr)


def _v2_feed(batch):
    data, lengths, labels = batch
    return {"words": data, "words__len__": lengths, "label": labels}


def _scope_copy(scope) -> dict:
    return {n: v.detach().clone() for n, v in scope.vars.items()}


def _v2_train(say, what, trainer, cost, batches, steps, want, device):
    """``trainer``'s first step held to the plain route's (from the
    scope as it is), then ``steps`` SGD.train steps over ``batches`` with
    an event handler: the launches equal ``want``, one graph capture for
    the key, the losses fall. Returns the figures."""
    from paddle_tpu_torch import fluid
    main = fluid.default_main_program()
    step_check = fluid_step_check(say, what, main,
                                  _scope_copy(trainer.exe.scope),
                                  _v2_feed(batches[0]), cost.var, device)
    events = []

    def handler(e):
        events.append((type(e).__name__, getattr(e, "cost", None)))

    reader = lambda: (_v2_feed(batches[i % len(batches)])  # noqa: E731
                      for i in range(steps))
    _, wall, launches, disp = counted(lambda: trainer.train(
        reader, event_handler=handler))
    losses = [c for name, c in events if name == "EndIteration"]
    mine = step_dispatches(disp, "fluid.run")
    check(launches == want, f"{what}: launches {launches} != {want}")
    check(mine == {"captures": 1, "replays": steps - 1},
          f"{what}: graphs {mine}, want one capture for the key")
    check([n for n, _ in events][:2] == ["BeginPass", "BeginIteration"]
          and events[-1][0] == "EndPass" and len(losses) == steps,
          f"{what}: events {[n for n, _ in events]}")
    k = len(batches)
    first, last = sum(losses[:k]) / k, sum(losses[-k:]) / k
    check(last < first, f"{what}: losses did not fall ({first} -> {last})")
    return {"launches": launches, "graphs": mine, "step_check": step_check,
            "losses_first_last": [losses[0], losses[-1]],
            "loss_means_first_last": [first, last],
            "train_ms_per_step": wall * 1e3 / steps}


def v2_flagship(say, seed: int, device="cuda") -> dict:
    """(a) The LSTM flagship built with the v2 DSL and trained by
    SGD.train; (b) v2.infer on it, forward only; (d) exe.run(verify=True)
    on its program; (e) Parameters.to_tar against the CPU's bytes."""
    import collections
    import io
    import torch
    from paddle_tpu_torch import analysis, fluid
    from paddle_tpu_torch import v2 as paddle
    from paddle_tpu_torch.fluid.registry import routed
    cfg = TEXTCLS
    fluid.reset_default_programs()
    logits, cost, opt = _v2_textcls(paddle, cfg["vocab"], cfg["embed"],
                                    cfg["hidden"], TEXTCLS_LR, "lstm")
    trainer = paddle.SGD(cost, opt, device=device)
    batches = textcls_batches(seed + 30, FLUID_NBUF + 2, device)
    train, held = batches[:FLUID_NBUF], batches[FLUID_NBUF:]
    out = _v2_train(say, "v2 LSTM flagship", trainer, cost, train,
                    V2_STEPS, {"lstm_seq_train": V2_STEPS,
                               "lstm_seq_bwd": V2_STEPS}, device)
    main, exe = fluid.default_main_program(), trainer.exe

    def exe_ms(verify, n=10):
        for i in range(2):
            exe.run(main, feed=_v2_feed(train[i]), fetch_list=[cost.var],
                    return_numpy=False, verify=verify)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            exe.run(main, feed=_v2_feed(train[i % FLUID_NBUF]),
                    fetch_list=[cost.var], return_numpy=False, verify=verify)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n
    out["exe_ms_per_step_graphed"] = exe_ms(False)
    say(f"v2 LSTM flagship ({TEXTCLS_BATCH} x {TEXTCLS_LEN}, embed "
        f"{cfg['embed']}, simple_lstm {cfg['hidden']}, Adam): {V2_STEPS} "
        f"SGD.train steps, losses {out['losses_first_last'][0]:.4f} -> "
        f"{out['losses_first_last'][1]:.4f} (means of the first and last "
        f"{FLUID_NBUF}: {out['loss_means_first_last'][0]:.4f} -> "
        f"{out['loss_means_first_last'][1]:.4f}); launches "
        f"{out['launches']}; graphs {out['graphs']}; ms a step through "
        f"SGD.train {out['train_ms_per_step']:.3f} (the first step's "
        f"capture included), through exe.run graphed "
        f"{out['exe_ms_per_step_graphed']:.3f}")

    # (b) infer: the program pruned to the logits, on the same executor
    before = _scope_copy(exe.scope)
    feeds = [{"words": b[0], "words__len__": b[1]} for b in held]
    got, _, inf_launches, _ = counted(lambda: [
        paddle.infer(logits, trainer, f) for f in feeds])
    check(inf_launches == {"lstm_seq": len(held)},
          f"v2 infer: launches {inf_launches}, want one #8 a call")
    with routed("plain"):
        want = [paddle.infer(logits, trainer, f) for f in feeds]
    errs = [float(abs(a - b).max()) for a, b in zip(got, want)]
    check(all(e <= F32_ATOL + F32_RTOL * float(abs(b).max())
              for e, b in zip(errs, want)),
          f"v2 infer: logits differ from plain by {errs}")
    moved = [n for n, v in before.items()
             if not torch.equal(v, exe.scope.get(n))]
    check(not moved, f"v2 infer moved {moved}")
    out["infer"] = {"launches": inf_launches, "max_abs_err": max(errs),
                    "params_moved": len(moved)}
    say(f"v2 infer on {len(held)} held batches: launches {inf_launches}, "
        f"logits within {max(errs):.3e} of the plain route, "
        f"{len(before)} scope tensors bit-equal before and after")

    # (d) the pre-flight on the card (twice: the process's first shape
    # inference on meta tensors pays PyTorch's one-time set-up), then the
    # step with the pre-flight memoized
    feed = _v2_feed(train[0])
    pre_s = []
    for _ in range(2):
        t0 = time.perf_counter()
        diags = analysis.check_or_raise(main, feed=feed,
                                        fetch=[cost.var.name], donate=True)
        pre_s.append(time.perf_counter() - t0)
    codes = dict(collections.Counter(d.code for d in diags))
    ms = {"verify": exe_ms(True), "no_verify": exe_ms(False)}
    check(len(exe._verified) == 1, f"verify: memoized {exe._verified}")
    out["verify"] = {"diagnostics": codes, "preflight_s": pre_s,
                     "ms_per_step": ms}
    say(f"exe.run(verify=True) on the v2 flagship: diagnostics by code "
        f"{json.dumps(codes)} (no error); pre-flight {pre_s[0]:.3f} s, "
        f"again {pre_s[1]:.3f} s; ms a step with the pre-flight memoized "
        f"{ms['verify']:.3f} against {ms['no_verify']:.3f} with "
        "verify=False")

    # (e) Parameters.to_tar from the card against the CPU's
    names = trainer.parameters.names()
    card_tar, cpu_tar = io.BytesIO(), io.BytesIO()
    trainer.parameters.to_tar(card_tar)
    cpu_scope = fluid.Scope()
    for n in names:
        cpu_scope.set(n, exe.scope.get(n).detach().cpu())
    paddle.Parameters(cpu_scope, main, device="cpu").to_tar(cpu_tar)
    check(card_tar.getvalue() == cpu_tar.getvalue(),
          "Parameters.to_tar: the card's tar differs from the CPU's")
    out["tar_bytes"] = len(card_tar.getvalue())
    say(f"Parameters.to_tar on the card: {len(names)} parameters, "
        f"{out['tar_bytes']} bytes, byte-equal to the CPU's tar")
    out["launches_all"] = dict(out["launches"])
    for k, n in inf_launches.items():
        out["launches_all"][k] = out["launches_all"].get(k, 0) + n
    del trainer, exe
    return out


def v2_gru(say, seed: int, device="cuda") -> dict:
    """(c) A networks.bidirectional_gru classifier at phase 20's GRU
    widths: 10 SGD.train steps, #11 and #12 twice a step."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch import v2 as paddle
    g = FLUID_GRU
    fluid.reset_default_programs()
    _, cost, opt = _v2_textcls(paddle, g["vocab"], g["embed"], g["hidden"],
                               S2S_LR, "gru")
    trainer = paddle.SGD(cost, opt, device=device)
    batch = fluid_gru_batch(seed + 31, device)
    out = _v2_train(say, "v2 bidirectional_gru", trainer, cost, [batch],
                    V2_GRU_STEPS, {"gru_seq": 2 * V2_GRU_STEPS,
                                   "gru_seq_bwd": 2 * V2_GRU_STEPS}, device)
    say(f"v2 bidirectional_gru (batch {g['batch']}, embed {g['embed']}, "
        f"hidden {g['hidden']}, T {g['seq']}): {V2_GRU_STEPS} SGD.train "
        f"steps, losses {out['losses_first_last'][0]:.4f} -> "
        f"{out['losses_first_last'][1]:.4f}; launches {out['launches']}; "
        f"graphs {out['graphs']}; ms a step {out['train_ms_per_step']:.3f}")
    out["launches_all"] = out["launches"]
    return out


def v2_phase(say, seed: int, device="cuda") -> dict:
    """Phase 21: the v2 DSL, (a)-(e) (see each part)."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    flag = v2_flagship(say, seed, device)
    gru = v2_gru(say, seed, device)
    launches = {}
    for part in (flag["launches_all"], gru["launches_all"]):
        for k, n in part.items():
            launches[k] = launches.get(k, 0) + n
    seconds = time.perf_counter() - t0
    say(f"phase 21 seconds: {seconds:.1f}; launches {json.dumps(launches)}")
    return {"flagship": flag, "gru": gru, "launches": launches,
            "seconds": seconds}


# ---------------------------------------------------------------------------
# phase 22: the parallel plane on a world of ranks on the card
# ---------------------------------------------------------------------------

# the world: 4 gloo ranks that all sit on cuda:0 (the machine has one card
# and NCCL refuses two ranks on one device), spawned with a FileStore
WORLD = 4
WORLD_TIMEOUT_S = 420
# (a): GPT-2 small's attention, 12 heads of 64, B = 8, T = 1024 global
RING = dict(B=8, T=1024, H=12, D=64)
# the ring in bf16 against one flash call: each step's partial output and
# gradients are rounded to bf16 before the f32 merge or sum (JAX does the
# same), on top of the tensor-core bodies' own rounding (bf16_tc_close's
# one ulp): two bf16 ulps of the largest entry for o, four for dq/dk/dv
# (each a sum of four rounded partials); rtol BF16_TC_RTOL
RING_BF16_ULPS = {"o": 2, "grads": 4}
# (b), (c): GPT-2 small (GPT2_SMALL), batch 8 of 1024 tokens, Adam 3e-4
WORLD_BATCH, WORLD_LR = 8, 3e-4


def _sync() -> None:
    """Wait for the card (no-op in a CPU rehearsal)."""
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _close_entry(got, want, atol: float, rtol: float) -> dict:
    """max |got - want| and whether allclose(atol, rtol) holds (the parent
    checks ``ok``)."""
    import torch
    g, w = got.float(), want.float()
    return {"err": (g - w).abs().max().item(), "atol": atol, "rtol": rtol,
            "ok": bool(torch.allclose(g, w, atol=atol, rtol=rtol))}


def _attn_close(got, want, dtype_name: str, kind: str) -> dict:
    """The tolerance of a ring output (``kind`` "o") or gradient
    ("grads") against one flash call or the plain ring: f32 as phases 2
    and 6 (summation order only: o at F32_ATOL/F32_RTOL, gradients at
    2e-5 of the largest magnitude and rtol 1e-4); bf16 RING_BF16_ULPS
    bf16 ulps of the largest entry, rtol BF16_TC_RTOL."""
    top = want.float().abs().max().item()
    if dtype_name == "float32":
        if kind == "o":
            return _close_entry(got, want, F32_ATOL, F32_RTOL)
        return _close_entry(got, want, 2e-5 * top, 1e-4)
    out = _close_entry(got, want, RING_BF16_ULPS[kind] * bf16_ulp(top),
                       BF16_TC_RTOL)
    out["ulps"] = out["err"] / bf16_ulp(top)
    return out


def ring_block_checks(say, seed: int, device="cuda", ring=None) -> dict:
    """#1, #2 and #3 against their plain versions at each block shape of
    (a)'s ring (a rank's 256 of 1024 positions, 8 x 12 heads of 64): the
    diagonal (causal, 256 x 256), a zigzag block from the past (256
    queries against the first 128 keys, a strided view) and from the
    future (the second 128 queries against 256 keys), the backward with
    the outside delta and lse the ring passes. f32 at the f32 tolerances,
    bf16 by bf16_tc_close."""
    import torch
    from paddle_tpu_torch.ops import cuda_kernels as ck
    ring = ring or RING
    B, H, D = ring["B"], ring["H"], ring["D"]
    t = ring["T"] // WORLD
    c = t // 2
    gen = torch.Generator().manual_seed(seed + 2201)
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).split(".")[-1]
        q, k, v, do = (torch.randn(B, t, H, D, generator=gen).to(device, dt)
                       for _ in range(4))
        for name, qq, kk, vv, dd, causal in (
                ("diag", q, k, v, do, True),
                ("past", q, k[:, :c], v[:, :c], do, False),
                ("future", q[:, c:], k, v, do[:, c:], False)):
            o, lse = ck.flash_attention_fwd(qq, kk, vv, causal=causal)
            po, plse = ck.flash_attention_fwd(qq, kk, vv, causal=causal,
                                              route="plain")
            delta = torch.sum(dd.float() * po.float(), -1)
            grads = ck.flash_attention_bwd(qq, kk, vv, po, plse, dd,
                                           causal=causal, delta=delta)
            plain = ck.flash_attention_bwd(qq, kk, vv, po, plse, dd,
                                           causal=causal, delta=delta,
                                           route="plain")
            _sync()
            errs = {}
            if dname == "float32":
                errs["o"] = fwd_f32_close(o, po, f"ring block {name} #1")
                for n, a, b in zip(("dq", "dk", "dv"), grads, plain):
                    errs[n] = bwd_close(a, b, f"ring block {name} {n}",
                                        dname)
            else:
                errs["o"] = bf16_tc_close(o, po, f"ring block {name} #1")
                for n, a, b in zip(("dq", "dk", "dv"), grads, plain):
                    errs[n] = bf16_tc_close(a, b, f"ring block {name} {n}")
            out[f"{name} {dname}"] = dict(
                errs, shape=f"q {tuple(qq.shape)} k {tuple(kk.shape)}"
                f"{' causal' if causal else ''}")
    say(f"ring blocks, #1-#3 against plain (max abs errors): "
        f"{json.dumps(out)}")
    return out


def _ring_inputs(seed: int, dt, device, ring):
    import torch
    gen = torch.Generator().manual_seed(seed + 2202)
    shape = (ring["B"], ring["T"], ring["H"], ring["D"])
    return [torch.randn(shape, generator=gen).to(device, dt)
            for _ in range(4)]


def _fwd_bwd(fn, q, k, v, g):
    """(o, dq, dk, dv) of ``fn(q, k, v)`` with cotangent ``g``."""
    import torch
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    o = fn(*leaves)
    grads = torch.autograd.grad(o, leaves, grad_outputs=g)
    return [o.detach()] + list(grads)


def _counted_world(fn):
    """fn() with LAUNCHES and STAGED at 0 before and read after, the wall
    in ms: (out, launches of #1-#3, staged, ms)."""
    import torch
    from paddle_tpu_torch.ops import cuda_kernels as ck
    from paddle_tpu_torch.parallel import collectives as cc
    _sync()
    ck.reset_launch_counts()
    cc.reset_staged()
    t0 = time.perf_counter()
    out = fn()
    _sync()
    ms = (time.perf_counter() - t0) * 1e3
    return (out, {n: ck.LAUNCHES[n] for n in ATTENTION_KERNELS},
            {f"{op}/{be}": dict(v) for (op, be), v in cc.STAGED.items()}, ms)


def _world_ring(rank: int, seed: int, cfg: dict) -> dict:
    """(a) ring_self_attention (zigzag causal, contiguous causal,
    non-causal) and ulysses_attention (causal) over seq = 4, forward and
    backward, in f32 and bf16, each through the kernels and on the plain
    route; rank 0 holds each against one flash_attention call on the
    whole sequence and the kernels' ring against the plain ring."""
    import torch
    from paddle_tpu_torch import parallel as pp
    from paddle_tpu_torch.ops import cuda_kernels as ck
    device = cfg["device"]
    mesh = pp.make_mesh(seq=WORLD, device=device)
    calls = {
        "zigzag": lambda r: lambda q, k, v: pp.ring_self_attention(
            mesh, q, k, v, causal=True, route=r),
        "contiguous": lambda r: lambda q, k, v: pp.ring_self_attention(
            mesh, q, k, v, causal=True, layout="contiguous", route=r),
        "full": lambda r: lambda q, k, v: pp.ring_self_attention(
            mesh, q, k, v, causal=False, route=r),
        "ulysses": lambda r: lambda q, k, v: pp.ulysses_attention(
            mesh, q, k, v, causal=True, route=r),
    }
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).split(".")[-1]
        q, k, v, g = _ring_inputs(seed, dt, device, cfg["ring"])
        ref = {}
        if rank == 0:
            for causal in (True, False):
                ref[causal] = _fwd_bwd(lambda a, b, c: ck.flash_attention(
                    a, b, c, causal=causal), q, k, v, g)
        for name, make in calls.items():
            got, launches, staged, ms = _counted_world(
                lambda: _fwd_bwd(make(None), q, k, v, g))
            plain = _fwd_bwd(make("plain"), q, k, v, g)
            entry = {"launches": launches, "staged": staged, "ms": ms}
            if rank == 0:
                want = ref[name != "full"]
                entry["vs_flash"] = {n: _attn_close(a, b, dname, "o" if
                                                    n == "o" else "grads")
                                     for n, a, b in zip(("o", "dq", "dk",
                                                         "dv"), got, want)}
                entry["vs_plain"] = {n: _attn_close(a, b, dname, "o" if
                                                    n == "o" else "grads")
                                     for n, a, b in zip(("o", "dq", "dk",
                                                         "dv"), got, plain)}
            out[f"{name} {dname}"] = entry
            del got, plain
        del ref
        _empty_cache(device)
    return out


def _empty_cache(device) -> None:
    import torch
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def _grad_compare(got: dict, want: dict, floor: float = 1e-6) -> dict:
    """Each gradient against the reference's: relative L2 at most 1e-4,
    plus ``floor`` times the largest gradient norm (a gradient at the
    step's rounding floor, the tied embedding's far rows)."""
    import torch
    norm = torch.linalg.vector_norm
    g_max = max(norm(w.float()).item() for w in want.values())
    worst, bad = 0.0, []
    for name, w in want.items():
        err = norm(got[name].float() - w.float()).item()
        ref = norm(w.float()).item()
        if err > 1e-4 * ref + floor * g_max:
            bad.append(f"{name}: {err:.3e} of {ref:.3e}")
        worst = max(worst, err / max(ref, 1e-30))
    return {"worst_rel_l2": worst, "ok": not bad, "bad": bad[:5],
            "g_max": g_max}


def _world_seq(rank: int, seed: int, cfg: dict) -> dict:
    """(b) GPT-2 small trained sequence-parallel: ``shifted_loss(positions=,
    seq_axis="seq")`` inside shard_map over seq = 4 at T = 1024 (256
    positions a rank), its f32 loss and gradients against the single-rank
    ``shifted_loss`` on the whole sequence (rank 0), then bf16 steps
    (bf16 over f32 masters, Adam) through ``Trainer(mesh=)`` timed."""
    import torch
    from paddle_tpu_torch import parallel as pp
    from paddle_tpu_torch.core.pytree import tree_from_items, tree_items
    from paddle_tpu_torch.models import TransformerLM
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.parallel.sharding import P
    from paddle_tpu_torch.trainer import Trainer
    device, lm, T = cfg["device"], cfg["lm"], cfg["ring"]["T"]
    mesh = pp.make_mesh(seq=WORLD, device=device)
    model = TransformerLM(**lm).init(seed, device=device)
    gen = torch.Generator().manual_seed(seed + 2203)
    ids = torch.randint(0, lm["vocab"], (cfg["batch"], T + 1),
                        generator=gen)
    ids = ids.to(device)
    ids_in, targets = ids[:, :-1], ids[:, 1:]
    pos = torch.arange(T, device=device).expand(ids_in.shape)
    spec = P(None, "seq")

    def seq_loss(dtype):
        body = pp.shard_map(
            lambda p, a, b, c: model.call(
                cast_tree(p, dtype), a, b, positions=c, seq_axis="seq",
                method="shifted_loss").float(),
            mesh=mesh, in_specs=(P(), spec, spec, spec), out_specs=P())
        return body

    items = [(path, t.detach().requires_grad_(True))
             for path, t in tree_items(model.tree())]
    tree = tree_from_items(items)

    def f32_run():
        lv = seq_loss(torch.float32)(tree, ids_in, targets, pos)
        return lv.detach(), torch.autograd.grad(lv, [t for _, t in items])
    (lv, grads), launches, staged, ms = _counted_world(f32_run)
    out = {"f32": {"loss": lv.item(), "launches": launches,
                   "staged": staged, "ms": ms}}
    if rank == 0:
        ref = model.call(tree, ids_in, targets, method="shifted_loss")
        rgrads = torch.autograd.grad(ref, [t for _, t in items])
        names = ["/".join(p) for p, _ in items]
        out["f32"]["ref_loss"] = ref.item()
        out["f32"]["grads"] = _grad_compare(dict(zip(names, grads)),
                                            dict(zip(names, rgrads)))
        del ref, rgrads
    del grads, tree, items
    # bf16 steps through the trainer's data-parallel step over the seq
    # mesh: no data axis, so each rank takes the whole batch and the
    # shard_map inside the loss cuts its positions
    tr = Trainer(lambda p, a, b, c: seq_loss(torch.bfloat16)(p, a, b, c),
                 Adam(WORLD_LR), mesh=mesh)
    params, opt_state = tr._dp.init(model.tree())
    steps = []
    for i in range(3):
        (params, opt_state, loss), launches, staged, ms = _counted_world(
            lambda: tr.step(params, opt_state, ids_in, targets, pos))
        steps.append({"loss": loss.item(), "ms": ms, "launches": launches,
                      "staged": staged})
    out["bf16_steps"] = steps
    del params, opt_state, tr, model
    _empty_cache(device)
    return out


def _local_bytes(tree) -> int:
    from paddle_tpu_torch.core.pytree import tree_items
    from paddle_tpu_torch.parallel.sharding import local
    return sum(local(leaf).nbytes for _, leaf in tree_items(tree))


def _layout_bytes(tree) -> dict:
    """This rank's bytes of a placed tree, beside the full bytes of the
    leaves its layout shards and of those it leaves replicated."""
    from paddle_tpu_torch.core.pytree import tree_items
    from paddle_tpu_torch.parallel.sharding import P, local, spec_of
    out = {"local": 0, "sharded_full": 0, "replicated": 0}
    for _, leaf in tree_items(tree):
        out["local"] += local(leaf).nbytes
        full = leaf.numel() * leaf.element_size()
        out["replicated" if (spec_of(leaf) or P()) == P()
            else "sharded_full"] += full
    return out


def _adam_param_check(got: dict, want: dict, m_ref: dict, lr: float
                      ) -> dict:
    """Parameters after one Adam step against the reference's, bound as
    transformer_step_check bounds them: 1e-5 plus what the first Adam
    step lr*g/(|g|+eps) makes of a gradient difference of 1e-4 of the
    entry and of its row's rms (the mean over ranks reassociates the
    batch sum; where g is rounding noise the step divides it by eps)."""
    import torch
    eps, worst, bad = 1e-8, 0.0, []
    for name, w in want.items():
        g = m_ref[name].abs() / 0.1
        rms = g.square().mean().sqrt()
        if g.dim() > 1:
            rms = torch.maximum(rms, g.square().mean(-1, keepdim=True).sqrt())
        dg = 1e-4 * (g + rms)
        allowed = 1e-5 + lr * dg * eps / (g + eps) ** 2
        diff = (got[name] - w).abs()
        if not bool((diff <= allowed).all()):
            bad.append(f"{name}: {diff.max().item():.3e}")
        worst = max(worst, diff.max().item())
    return {"worst_param_diff": worst, "ok": not bad, "bad": bad[:5]}


def _world_dp(rank: int, seed: int, cfg: dict) -> dict:
    """(c) GPT-2 small trained data-parallel: one f32 step through
    ``Trainer(mesh=make_mesh(data=4))``, through ``Trainer(mesh=
    make_mesh(fsdp=2, tp=2), layout=SpecLayout(rules=[(r"pos_embed$",
    P())]))`` (benchmarks/sharded_gpt2.py's layout) and through
    ``Zero1DataParallel`` over data = 4, each against one single-rank
    step on the global batch of 8 (rank 0): the loss, the gradients (as
    Adam's first moment) and the parameters (Adam-aware); each rank's
    parameter and slot bytes; two more steps timed."""
    import torch
    from paddle_tpu_torch import parallel as pp
    from paddle_tpu_torch.core.pytree import tree_get, tree_items
    from paddle_tpu_torch.models import TransformerLM
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.parallel.sharding import P, tree_to_global
    from paddle_tpu_torch.trainer import Trainer
    device, lm = cfg["device"], cfg["lm"]
    model = TransformerLM(**lm).init(seed, device=device)
    gen = torch.Generator().manual_seed(seed + 2204)
    ids = torch.randint(0, lm["vocab"], (cfg["batch"], cfg["ring"]["T"]),
                        generator=gen).to(device)
    loss = lm_loss(model, torch.float32)
    out = {}
    ref = None
    if rank == 0:
        # eager: a captured step's memory pool would stay with this rank
        # while the three meshes' steps run
        from paddle_tpu_torch.core import graphs
        tr = Trainer(loss, Adam(WORLD_LR), device=device)
        p0 = model.tree()
        with graphs.disabled():
            rp, rs, rl = tr.step(p0, tr.opt.init(p0), ids)
        ref = ({"/".join(k): v.clone() for k, v in tree_items(rp)},
               {"/".join(k): tree_get(rs["slots"], k)["m"].clone()
                for k, _ in tree_items(rp)}, rl.item())
        del tr, rp, rs
        _empty_cache(device)
    replicated = sum(t.nbytes for _, t in tree_items(model.tree()))
    configs = (("data=4", pp.make_mesh(data=WORLD, device=device), None),
               ("fsdp=2 x tp=2", pp.make_mesh(fsdp=2, tp=2, device=device),
                pp.SpecLayout(rules=[(r"pos_embed$", P())])),
               ("zero1 data=4", pp.make_mesh(data=WORLD, device=device),
                "zero1"))
    for name, mesh, layout in configs:
        if layout == "zero1":
            z = pp.Zero1DataParallel(loss, Adam(WORLD_LR), mesh=mesh)
            state = z.init(model.tree())
            batch = z.shard_batch((ids,))

            def step():
                nonlocal state
                state, lv = z.step(state, *batch)
                return lv
            per_rank = {"slots": _layout_bytes(state.opt_state["slots"]),
                        "master": _layout_bytes({"f": state.flat})}
        else:
            tr = Trainer(loss, Adam(WORLD_LR), mesh=mesh, layout=layout)
            trees = list(tr._dp.init(model.tree()))

            def step():
                trees[0], trees[1], lv = tr.step(trees[0], trees[1], ids)
                return lv
        lv, launches, staged, ms = _counted_world(step)
        entry = {"loss": lv.item(), "check_step_ms": ms,
                 "launches": launches, "staged": staged}
        if layout == "zero1":
            full = z.params(state)
            slots = None
            entry["bytes"] = per_rank
        else:
            full = tree_to_global(trees[0])
            slots = tree_to_global(trees[1])["slots"]
            entry["bytes"] = {"params": _layout_bytes(trees[0]),
                              "slots": _layout_bytes(trees[1]["slots"])}
            if layout is not None:
                entry["specs"] = {"/".join(k): list(pp.sharding.spec_of(v))
                                  for k, v in tree_items(trees[0])
                                  if pp.sharding.spec_of(v) != P()}
        if rank == 0:
            got = {"/".join(k): v for k, v in tree_items(full)}
            want_p, want_m, want_l = ref
            entry["ref_loss"] = want_l
            entry["params"] = _adam_param_check(got, want_p, want_m,
                                                WORLD_LR)
            if slots is not None:
                entry["grads"] = _grad_compare(
                    {k: tree_get(slots, tuple(k.split("/")))["m"]
                     for k in want_m}, want_m)
        del full, slots
        timed = []
        for _ in range(2):
            _, _, staged, ms = _counted_world(step)
            timed.append({"ms": ms, "staged": staged})
        entry["timed"] = timed
        entry["replicated_bytes"] = replicated
        out[name] = entry
        # this mesh's trees go before the next one's are placed
        del step
        if layout == "zero1":
            del z, state, batch
        else:
            del tr, trees
        _empty_cache(device)
    return out


def _world_small(rank: int, seed: int, cfg: dict) -> dict:
    """(d) JAX's test shapes on the card: ExpertParallelMoE (D 8, F 16, E
    8, 64 tokens over expert = 4; k 1 and 2, no drops) against the dense
    math routed per shard; pipeline_1f1b's loss and gradients (4 stages
    of Linear(8, 8, tanh), 4 microbatches of 2) against the sequential
    ones; the column -> row parallel MLP (16 -> 64 -> 8 on data = 2 x
    model = 2) and the vocab-sharded embedding (64 x 16 on model = 4)
    against the dense math. f32 at 2e-5 / 1e-4 (JAX's bounds)."""
    import torch
    from paddle_tpu_torch import parallel as pp
    from paddle_tpu_torch.nn import Linear, Module
    from paddle_tpu_torch.parallel.moe import moe_ffn_dense
    from paddle_tpu_torch.parallel.sharding import P
    device = cfg["device"]
    gen = torch.Generator().manual_seed(seed + 2205)
    out = {}
    mesh = pp.make_mesh(expert=WORLD, device=device)
    params = pp.init_moe_params(gen, 8, 16, 8, device=device)
    x = torch.randn(64, 8, generator=gen).to(device)
    for k in (1, 2):
        moe = pp.ExpertParallelMoE(mesh, k=k, capacity=16)
        y, _ = moe(moe.shard_params(params), moe.shard_tokens(x))
        dense = torch.cat([moe_ffn_dense(params, x[s * 16:(s + 1) * 16],
                                         k=k, capacity=16)[0]
                           for s in range(WORLD)])
        out[f"moe k={k}"] = _close_entry(y, dense, 2e-5, 2e-5)

    pipe = pp.make_mesh(pipe=WORLD, device=device)
    stage = pp.PipelineStage(lambda: Linear(8, 8, act="tanh"), n_stages=4)
    stage.init(seed, device=device)
    tree = stage.tree()
    xb = torch.randn(8, 8, generator=gen).to(device)
    yb = torch.randn(8, 8, generator=gen).to(device)

    def stage_fn(p, mb):
        return torch.tanh(mb @ p["w"] + p["b"])

    def loss_fn(o, yy):
        return torch.mean((o - yy) ** 2)
    loss, grads = pp.pipeline_1f1b(stage_fn, loss_fn, pipe,
                                   n_microbatches=4)(tree, xb, yb)
    leaves = {k: v.detach().requires_grad_(True) for k, v in tree.items()}
    total = 0.0
    for m in range(4):
        h = xb[2 * m:2 * m + 2]
        for s in range(4):
            h = stage_fn({k: v[s] for k, v in leaves.items()}, h)
        total = total + loss_fn(h, yb[2 * m:2 * m + 2])
    total = total / 4
    rg = torch.autograd.grad(total, list(leaves.values()))
    out["1f1b loss"] = _close_entry(loss, total.detach(), 1e-6, 1e-5)
    for (k, _), g in zip(leaves.items(), rg):
        out[f"1f1b d{k}"] = _close_entry(grads[k], g, 1e-5, 1e-4)

    class TPNet(Module):
        def __init__(self):
            super().__init__()
            self.up = pp.ColumnParallelLinear(16, 64, act="relu")
            self.down = pp.RowParallelLinear(64, 8)

        def forward(self, x):
            return self.down(self.up(x))
    net = TPNet().init(seed, device=device)
    xt = torch.randn(32, 16, generator=gen).to(device)
    tp = pp.make_mesh(data=2, model=2, device=device)
    sp = pp.ShardingRules(pp.tensor_parallel.collect_tp_rules(net)
                          + [(r".*", P())]).apply(tp, net.tree())
    with tp:
        out["tp mlp"] = _close_entry(net.call(sp, xt), net(xt), 1e-5, 1e-5)
    emb = pp.ShardedEmbedding(64, 16).init(seed, device=device)
    m4 = pp.make_mesh(model=WORLD, device=device)
    se = pp.ShardingRules(pp.tensor_parallel.collect_tp_rules(emb)).apply(
        m4, emb.tree())
    ids = torch.tensor([0, 5, 63, 17, 16, 48], device=device)
    with m4:
        out["sharded embedding"] = _close_entry(emb.call(se, ids),
                                                emb.table[ids], 0.0, 0.0)
    return out


def _world_rank(rank: int, world: int, store: str, out_dir: str, seed: int,
                backend: str, cfg: dict) -> None:
    """One rank of phase 22's world (spawned): the cases, its results
    pickled for the parent; a failure records the traceback and exits
    non-zero at once (the parent then stops the world)."""
    import datetime
    import pickle
    import traceback
    res = {}
    try:
        import torch
        import torch.distributed as dist
        sys.path.insert(0, HERE)
        if cfg["device"].startswith("cuda"):
            torch.cuda.set_device(cfg["device"])
        torch.set_num_threads(1)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dist.init_process_group(
            backend, init_method=f"file://{store}", rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=WORLD_TIMEOUT_S))
        if cfg["device"].startswith("cuda"):
            from paddle_tpu_torch.ops import _build
            _build.load()                  # built by the parent: loaded
        t0 = time.perf_counter()
        if world == 1:
            res["nccl"] = _nccl_ring(seed, cfg)
        else:
            on_card = cfg["device"].startswith("cuda")
            for name, fn in (("ring", _world_ring), ("seq", _world_seq),
                             ("dp", _world_dp), ("small", _world_small),
                             ("fluid", _world_fluid)):
                t1 = time.perf_counter()
                if on_card:
                    torch.cuda.reset_peak_memory_stats()
                res[name] = fn(rank, seed, cfg)
                res.setdefault("seconds", {})[name] = \
                    time.perf_counter() - t1
                if on_card:
                    res.setdefault("peak_gib", {})[name] = round(
                        torch.cuda.max_memory_allocated() / 2 ** 30, 2)
        res["world_s"] = time.perf_counter() - t0
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - reported to the parent
        res["error"] = traceback.format_exc()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    if "error" in res:
        os._exit(1)


#: (f): the fluid flagship's three runs on data = 4
FLUID_WORLD_RUNS = 3
#: (f): JAX's annotated program's f32 parameter bytes a rank on data=2 x
#: fsdp=2: the embedding [16, 8] split over fsdp (256 of 512 bytes), the
#: tp-column fc [8, 16] replicated (no tp axis: 512), its bias (64), the
#: head [16, 1] and its bias (64 + 4)
FLUID_ANNOTATED_BYTES_A_RANK = 256 + 512 + 64 + 64 + 4


def _fluid_adam_check(got: dict, want: dict, g: dict, lr: float,
                      runs: int) -> dict:
    """Parameters after ``runs`` Adam runs against the single-rank runs':
    ``runs`` times _adam_param_check's one-step bound (1e-5 plus what an
    Adam step lr*g/(|g|+eps) makes of a gradient difference of 1e-4 of
    the entry and of its row's rms), with g the first run's gradient
    (the reference's first moment / 0.1): each run's update adds at most
    that much."""
    import torch
    eps, worst, bad = 1e-8, 0.0, []
    for name, w in want.items():
        gg = g[name].abs()
        rms = gg.square().mean().sqrt()
        if gg.dim() > 1:
            rms = torch.maximum(rms, gg.square().mean(-1, keepdim=True)
                                .sqrt())
        dg = 1e-4 * (gg + rms)
        allowed = runs * (1e-5 + lr * dg * eps / (gg + eps) ** 2)
        diff = (got[name] - w).abs()
        if not bool((diff <= allowed).all()):
            bad.append(f"{name}: {diff.max().item():.3e}")
        worst = max(worst, diff.max().item())
    return {"worst_param_diff": worst, "ok": not bad, "bad": bad[:5]}


def _world_fluid(rank: int, seed: int, cfg: dict) -> dict:
    """(f) the fluid executor on a mesh (ROADMAP A.7b): phase 20's LSTM
    flagship program on make_mesh(data=4), three exe.runs, each rank's
    16 rows of the 64 through #9/#10, held to the single-rank run of the
    same program (the loss to 1e-4 relative, the first run's gradient
    from Adam's first moment, the parameters Adam-aware); JAX's annotated
    program (embedding over fsdp, a tp-column fc) with 0.3 *
    reduce_sum(square(head weight)) added to the mean loss, a parameter
    path that skips the batch reduction, on data=2 x fsdp=2 with its
    parameters stored sharded (the first forward equal to the single-rank
    one, the bytes a rank, 3 SGD steps to rtol 1e-5); save_persistables
    on that mesh and load_persistables onto fsdp=4, re-placed."""
    import tempfile
    import torch
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch import parallel as pp
    from paddle_tpu_torch.core import graphs
    from paddle_tpu_torch.ops import cuda_kernels as ck
    from paddle_tpu_torch.parallel.sharding import local, spec_of, to_global
    device = cfg["device"]
    out = {}
    fluid.reset_default_programs()
    t = TEXTCLS
    logits, loss = _fluid_textcls(fluid, "lstm", t["vocab"], t["embed"],
                                  t["hidden"], TEXTCLS_LR)
    main, start = fluid.default_main_program(), \
        fluid.default_startup_program()
    exe0 = fluid.Executor(device=device, scope=fluid.Scope())
    exe0.run(start)
    start_vars = {n: v.detach().clone() for n, v in exe0.scope.vars.items()}
    batches = textcls_batches(seed + 2230, FLUID_WORLD_RUNS, device)
    params = [n for n, v in main.global_block().vars.items()
              if v.persistable and v.trainable]
    ref = fluid.Executor(device=device, scope=_fluid_scope(start_vars,
                                                           device))
    ref_loss, g1 = [], None
    with graphs.disabled():
        for i, b in enumerate(batches):
            ref_loss.append(float(ref.run(main, feed=_fluid_feed(b),
                                          fetch_list=[loss])[0]))
            if i == 0:
                g1 = {n: ref.scope.get(n + "@moment1").clone() / 0.1
                      for n in params}
    want = {n: ref.scope.get(n).clone() for n in params}
    del ref
    mesh = pp.make_mesh(data=WORLD, device=device)
    exe = fluid.Executor(scope=_fluid_scope(start_vars, device), mesh=mesh,
                         layout=pp.SpecLayout(roles=False))
    _sync()
    ck.reset_launch_counts()
    got_loss, g1_mesh, ms = [], None, 0.0
    for i, b in enumerate(batches):
        t0 = time.perf_counter()
        got_loss.append(float(exe.run(main, feed=_fluid_feed(b),
                                      fetch_list=[loss])[0]))
        ms += (time.perf_counter() - t0) * 1e3 / FLUID_WORLD_RUNS
        if i == 0:
            g1_mesh = {n: to_global(exe.scope.get(n + "@moment1")) / 0.1
                       for n in params}
    launches = {k: n for k, n in ck.LAUNCHES.items() if n}
    grad_bad = []
    for n in params:
        gg = g1[n].abs()
        room = 1e-4 * (gg + gg.square().mean().sqrt())
        diff = (g1_mesh[n] - g1[n]).abs()
        if not bool((diff <= room).all()):
            grad_bad.append(f"{n}: {diff.max().item():.3e}")
    got = {n: to_global(exe.scope.get(n)) for n in params}
    out["flagship"] = {
        "losses": got_loss, "ref_losses": ref_loss,
        "loss_ok": all(abs(a - b) <= 1e-4 * max(1.0, abs(b))
                       for a, b in zip(got_loss, ref_loss)),
        "grad_ok": not grad_bad, "grad_bad": grad_bad[:5],
        "params": _fluid_adam_check(got, want, g1, TEXTCLS_LR,
                                    FLUID_WORLD_RUNS),
        "launches": launches, "ms_per_run": ms}
    del exe, got, want
    # JAX's annotated program on data=2 x fsdp=2
    fluid.reset_default_programs()
    ids = fluid.layers.data("ids", shape=(), dtype="int32",
                            sharding=("data",))
    y = fluid.layers.data("y", shape=(1,))
    emb = fluid.layers.embedding(ids, (16, 8),
                                 param_attr={"sharding": ("fsdp", None)})
    h = fluid.layers.fc(emb, 16, act="relu",
                        param_attr={"sharding": (None, "tp")})
    diff = fluid.layers.elementwise_sub(fluid.layers.fc(h, 1), y)
    persample = fluid.layers.elementwise_mul(diff, diff)
    head = [v for n, v in fluid.default_main_program().global_block()
            .vars.items() if v.persistable and n.startswith("fc_w")][-1]
    aloss = fluid.layers.elementwise_add(
        fluid.layers.mean(persample), fluid.layers.elementwise_mul(
            fluid.layers.reduce_sum(fluid.layers.activation(head, "square")),
            fluid.layers.fill_constant((), value=0.3)))
    fluid.SGDOptimizer(0.05).minimize(aloss)
    amain = fluid.default_main_program()
    exe0 = fluid.Executor(device=device, scope=fluid.Scope())
    exe0.run(fluid.default_startup_program())
    avars = {n: v.detach().clone() for n, v in exe0.scope.vars.items()}
    gen = torch.Generator().manual_seed(seed + 2231)
    feed = {"ids": torch.randint(0, 16, (8,), generator=gen,
                                 dtype=torch.int32).to(device),
            "y": torch.randn(8, 1, generator=gen).to(device)}
    rep = fluid.Executor(device=device, scope=_fluid_scope(avars, device))
    mesh2 = pp.make_mesh(data=2, fsdp=2, device=device)
    sh = fluid.Executor(scope=_fluid_scope(avars, device), mesh=mesh2,
                        layout=pp.SpecLayout(roles=False))
    with tempfile.TemporaryDirectory() as d:
        # every rank writes its own copy's directory: the mesh's first
        # rank writes the file, the others wait for it
        saved = os.path.join(d, "p") if rank == 0 else None
        saved = _share_dir(saved)
        fluid.io.save_persistables(sh, saved, amain)
        with graphs.disabled():
            r_ps, r_l = rep.run(amain, feed=feed,
                                fetch_list=[persample, aloss])
        s_ps, s_l = sh.run(amain, feed=feed, fetch_list=[persample, aloss])
        steps = []
        for _ in range(3):
            with graphs.disabled():
                _, rl = rep.run(amain, feed=feed,
                                fetch_list=[persample, aloss])
            _, sl = sh.run(amain, feed=feed, fetch_list=[persample, aloss])
            steps.append((float(sl), float(rl)))
        names = [n for n, v in amain.global_block().vars.items()
                 if v.persistable and v.trainable]
        per_rank = sum(local(sh.scope.get(n)).numel() * 4 for n in names)
        replicated = sum(sh.scope.get(n).numel() * 4 for n in names)
        emb_name = next(n for n in names if "embedding" in n)
        placed = (tuple(spec_of(sh.scope.get(emb_name))),
                  tuple(local(sh.scope.get(emb_name)).shape))
        m4 = pp.make_mesh(fsdp=WORLD, device=device)
        ld = fluid.Executor(scope=fluid.Scope(), mesh=m4,
                            layout=pp.SpecLayout(roles=False))
        fluid.io.load_persistables(ld, saved, amain)
        loaded = (tuple(spec_of(ld.scope.get(emb_name))),
                  tuple(local(ld.scope.get(emb_name)).shape))
        l_ps, = ld.run(amain, feed=feed, fetch_list=[persample],
                       donate=False)
    out["annotated"] = {
        "first_equal": bool(torch.equal(torch.as_tensor(s_ps),
                                        torch.as_tensor(r_ps))),
        "first_loss": [float(s_l), float(r_l)],
        "steps": steps,
        "steps_ok": all(abs(a - b) <= 1e-5 * abs(b) + 1e-7
                        for a, b in steps),
        "per_rank_bytes": per_rank, "replicated_bytes": replicated,
        "placed": placed, "loaded": loaded,
        "restored_equal": bool(torch.equal(torch.as_tensor(l_ps),
                                           torch.as_tensor(r_ps)))}
    return out


def _share_dir(path):
    """Rank 0's directory name, the same on every rank of the world."""
    import torch.distributed as dist
    box = [path]
    dist.broadcast_object_list(box, src=0)
    os.makedirs(box[0], exist_ok=True)
    return box[0]


def _nccl_ring(seed: int, cfg: dict) -> dict:
    """(e) (a)'s zigzag ring on a one-rank NCCL world (n = 1: the ring is
    one diagonal step, flash_attention itself), f32 forward and backward
    against one flash_attention call: the NCCL code path of the
    collectives (the output's all-gather, the input's cotangent
    all-reduce) runs."""
    import torch
    from paddle_tpu_torch import parallel as pp
    from paddle_tpu_torch.ops import cuda_kernels as ck
    device = cfg["device"]
    mesh = pp.make_mesh(data=1, device=device)
    q, k, v, g = _ring_inputs(seed, torch.float32, device, cfg["ring"])
    got, launches, staged, ms = _counted_world(lambda: _fwd_bwd(
        lambda a, b, c: pp.ring_self_attention(mesh, a, b, c,
                                               seq_axis="data", causal=True),
        q, k, v, g))
    want = _fwd_bwd(lambda a, b, c: ck.flash_attention(a, b, c, causal=True),
                    q, k, v, g)
    return {"backend": mesh.backend, "launches": launches, "staged": staged,
            "ms": ms,
            "vs_flash": {n: _attn_close(a, b, "float32", "o" if n == "o"
                                        else "grads")
                         for n, a, b in zip(("o", "dq", "dk", "dv"), got,
                                            want)}}


def _spawn_world(world: int, seed: int, backend: str, cfg: dict) -> list:
    """Run ``world`` ranks of _world_rank (torch.multiprocessing spawn, a
    FileStore in a temp dir) within WORLD_TIMEOUT_S; a rank that fails
    or a world past its limit fails the phase, and no rank is left
    running. Returns each rank's results."""
    import pickle
    import shutil
    import tempfile
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_world_")
    store = os.path.join(tmp, "store")
    procs = [ctx.Process(target=_world_rank,
                         args=(r, world, store, tmp, seed, backend, cfg))
             for r in range(world)]
    # the ranks share one card: growable segments keep each rank's cache
    # from holding memory the others need (the ranks inherit this)
    prior = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        for p in procs:
            p.start()
    finally:
        if prior is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = prior
    deadline = time.monotonic() + WORLD_TIMEOUT_S
    try:
        while any(p.is_alive() for p in procs):
            failed = [r for r, p in enumerate(procs)
                      if p.exitcode not in (None, 0)]
            if failed:
                break
            check(time.monotonic() < deadline, f"phase 22: the {backend} "
                  f"world outlived {WORLD_TIMEOUT_S} s")
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=30)
    res, failed = [], []
    for r in range(world):
        path = os.path.join(tmp, f"rank{r}.pkl")
        if not os.path.exists(path):
            failed.append(f"rank {r}: no results (exit code "
                          f"{procs[r].exitcode})")
            continue
        with open(path, "rb") as f:
            res.append(pickle.load(f))
        if "error" in res[-1]:
            failed.append(f"rank {r}:\n{res[-1]['error']}")
    shutil.rmtree(tmp, ignore_errors=True)
    # every failing rank, as a peer's failure shows on the others as a
    # reset connection
    check(not failed, f"phase 22: the {backend} world failed:\n"
          + "\n".join(failed))
    return res


def _check_entries(what: str, entries: dict) -> None:
    for name, e in entries.items():
        check(e["ok"], f"{what} {name}: max abs {e['err']} (atol "
              f"{e['atol']}, rtol {e['rtol']})")


def world_phase(say, seed: int, device="cuda:0", ring=None, lm=None,
                batch: int = WORLD_BATCH, nccl: str = "nccl") -> dict:
    """Phase 22: the parallel plane on a world of 4 gloo ranks on
    ``device`` (module docstring; (a)-(d)), then (e) a one-rank world over
    ``nccl``. The parent built the kernels; the ranks load them. Returns
    the launches of #1-#3 per rank and call, and the figures. ``ring``,
    ``lm``, ``batch`` (default RING, GPT2_SMALL, WORLD_BATCH) and a CPU
    ``device`` with ``nccl="gloo"`` make a small rehearsal on the CPU."""
    t0 = time.perf_counter()
    if device.startswith("cuda"):
        # the ranks share the card with this process: hand back what the
        # earlier phases' graphs and caches hold
        import torch
        _GRAPH_NODES.clear()
        gc.collect()
        torch.cuda.empty_cache()
        say(f"phase 22: {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB "
            "allocated in the parent at its start")
    cfg = {"device": device, "ring": ring or RING, "lm": lm or GPT2_SMALL,
           "batch": batch}
    # a CPU rehearsal runs the plain versions: nothing launches there
    on_card = device.startswith("cuda")
    blocks = ring_block_checks(say, seed, device, cfg["ring"])
    ranks = _spawn_world(WORLD, seed, "gloo", cfg)
    r0 = ranks[0]
    figs = {"blocks": blocks, "seconds": ranks[0]["seconds"]}
    # (a)
    launches = {}
    for name, e in r0["ring"].items():
        _check_entries(f"phase 22 (a) {name} vs flash_attention",
                       e["vs_flash"])
        _check_entries(f"phase 22 (a) {name} vs the plain ring",
                       e["vs_plain"])
        call = name.split()[0]
        for r, res in enumerate(ranks):
            got = res["ring"][name]["launches"]
            n = (1 if call == "ulysses" else
                 r + 1 if call == "contiguous" else WORLD)
            check(not on_card or got == {k: n for k in ATTENTION_KERNELS},
                  f"phase 22 (a) {name} rank {r}: launches {got}, want {n} "
                  "of each of #1-#3")
            launches.setdefault(f"rank{r}", {})[name] = got
    figs["ring"] = {name: {k: e[k] for k in ("vs_flash", "vs_plain", "ms",
                                             "staged")}
                    for name, e in r0["ring"].items()}
    say(f"phase 22 (a) ring/Ulysses at {json.dumps(cfg['ring'])} over "
        f"seq={WORLD}: {json.dumps(figs['ring'])}")
    say(f"phase 22 (a) launches of #1-#3 per rank and call: "
        f"{json.dumps(launches)} (the contiguous causal ring skips the "
        "future blocks: rank r launches r + 1 of each)")
    # (b)
    seq = r0["seq"]
    f32 = seq["f32"]
    check(abs(f32["loss"] - f32["ref_loss"]) <= 1e-5 * abs(f32["ref_loss"]),
          f"phase 22 (b) seq-parallel f32 loss {f32['loss']} != single-rank "
          f"{f32['ref_loss']}")
    check(f32["grads"]["ok"], f"phase 22 (b) seq-parallel gradients: "
          f"{f32['grads']['bad']}")
    for r, res in enumerate(ranks):
        want = {k: cfg["lm"]["n_layers"] * (r + 1)
                for k in ATTENTION_KERNELS}
        check(not on_card or res["seq"]["f32"]["launches"] == want,
              f"phase 22 (b) rank {r}: launches "
              f"{res['seq']['f32']['launches']} != {want}")
        launches[f"rank{r}"]["seq f32 step"] = res["seq"]["f32"]["launches"]
        launches[f"rank{r}"]["seq bf16 step"] = \
            res["seq"]["bf16_steps"][-1]["launches"]
    steps = seq["bf16_steps"]
    figs["seq"] = {"f32": {k: f32[k] for k in ("loss", "ref_loss", "ms",
                                              "staged")},
                   "f32_worst_grad_rel_l2": f32["grads"]["worst_rel_l2"],
                   "bf16_ms_a_step": [s["ms"] for s in steps],
                   "bf16_losses": [s["loss"] for s in steps],
                   "bf16_staged_a_step": steps[-1]["staged"]}
    say(f"phase 22 (b) GPT-2 small sequence-parallel over seq={WORLD}, T="
        f"{cfg['ring']['T']}, B={batch}: {json.dumps(figs['seq'])}")
    # (c)
    figs["dp"] = {}
    for name, e in r0["dp"].items():
        check(abs(e["loss"] - e["ref_loss"]) <= 1e-6 * abs(e["ref_loss"]),
              f"phase 22 (c) {name}: f32 loss {e['loss']} != single-rank "
              f"{e['ref_loss']}")
        check(e["params"]["ok"], f"phase 22 (c) {name}: parameters "
              f"{e['params']['bad']}")
        if "grads" in e:
            check(e["grads"]["ok"], f"phase 22 (c) {name}: gradients "
                  f"{e['grads']['bad']}")
        for r, res in enumerate(ranks):
            launches[f"rank{r}"][f"dp {name} step"] = \
                res["dp"][name]["launches"]
            check(not on_card or all(
                n > 0 for n in res["dp"][name]["launches"].values()),
                  f"phase 22 (c) {name} rank {r}: a kernel never launched")
        figs["dp"][name] = {k: e[k] for k in ("loss", "ref_loss", "bytes",
                                             "timed", "check_step_ms")}
        figs["dp"][name].update(params=e["params"]["worst_param_diff"],
                                grads=e.get("grads", {}).get("worst_rel_l2"))
    # each rank stores a quarter of every leaf the layout shards over
    # fsdp x tp and all of the leaves it leaves replicated (the vectors,
    # pos_embed by the rule, and the token embedding, whose 50257 rows do
    # not split four ways: SpecLayout.fit, as in JAX)
    for name, e in r0["dp"].items():
        for kind, b in e["bytes"].items():
            check(b["local"] <= b["sharded_full"] / WORLD + b["replicated"],
                  f"phase 22 (c) {name}: {kind} {b['local']} bytes a rank, "
                  f"over a quarter of {b['sharded_full']} sharded + "
                  f"{b['replicated']} replicated")
    fsdp = r0["dp"]["fsdp=2 x tp=2"]["bytes"]["params"]
    check(fsdp["sharded_full"] > 0.6 * fsdp["replicated"],
          f"phase 22 (c) fsdp/tp: too little sharded ({fsdp})")
    dp4 = r0["dp"]["data=4"]["bytes"]["slots"]
    z1 = r0["dp"]["zero1 data=4"]["bytes"]["slots"]
    check(z1["local"] <= dp4["local"] / WORLD * 1.01,
          f"phase 22 (c) ZeRO-1: {z1['local']} slot bytes a rank, not a "
          f"quarter of data-parallel's {dp4['local']}")
    say(f"phase 22 (c) GPT-2 small data-parallel, one f32 step against the "
        f"single-rank step on the global batch of 8, then two timed: "
        f"{json.dumps(figs['dp'])}")
    # (d)
    _check_entries("phase 22 (d)", r0["small"])
    figs["small"] = r0["small"]
    say(f"phase 22 (d) MoE, 1F1B, TP on the card: {json.dumps(r0['small'])}")
    # (f) the fluid executor on the mesh
    for r, res in enumerate(ranks):
        fl = res["fluid"]["flagship"]
        check(fl["loss_ok"], f"phase 22 (f) rank {r}: flagship losses "
              f"{fl['losses']} != single-rank {fl['ref_losses']}")
        check(fl["grad_ok"], f"phase 22 (f) rank {r}: flagship first "
              f"gradient past 1e-4 of the single-rank one {fl['grad_bad']}")
        check(fl["params"]["ok"], f"phase 22 (f) rank {r}: flagship "
              f"parameters {fl['params']}")
        check(not on_card or fl["launches"] == {
            "lstm_seq_train": FLUID_WORLD_RUNS,
            "lstm_seq_bwd": FLUID_WORLD_RUNS},
              f"phase 22 (f) rank {r}: launches {fl['launches']}")
        an = res["fluid"]["annotated"]
        check(an["first_equal"], f"phase 22 (f) rank {r}: the sharded "
              f"first forward differs from the single-rank one")
        check(an["steps_ok"], f"phase 22 (f) rank {r}: 3 SGD steps "
              f"{an['steps']} (sharded, single-rank) past rtol 1e-5")
        check(an["per_rank_bytes"] == FLUID_ANNOTATED_BYTES_A_RANK,
              f"phase 22 (f) rank {r}: {an['per_rank_bytes']} parameter "
              f"bytes a rank, forecast {FLUID_ANNOTATED_BYTES_A_RANK}")
        check(an["placed"] == (("fsdp",), (8, 8))
              and an["loaded"] == (("fsdp",), (4, 8)),
              f"phase 22 (f) rank {r}: placement {an['placed']} -> "
              f"{an['loaded']}")
        check(an["restored_equal"], f"phase 22 (f) rank {r}: the restored "
              "program's forward differs")
    figs["fluid"] = r0["fluid"]
    say(f"phase 22 (f) the fluid executor on a mesh (A.7b): "
        f"{json.dumps(r0['fluid'])}")
    # (e)
    nccl_res = _spawn_world(1, seed, nccl, cfg)[0]["nccl"]
    check(nccl_res["backend"] == nccl, f"phase 22 (e): backend "
          f"{nccl_res['backend']}")
    nccl = nccl_res
    _check_entries("phase 22 (e) one-rank NCCL ring vs flash_attention",
                   nccl["vs_flash"])
    check(not on_card or nccl["launches"] == {k: 1 for k in
                                              ATTENTION_KERNELS},
          f"phase 22 (e) launches {nccl['launches']}")
    launches["nccl rank0"] = {"zigzag float32": nccl["launches"]}
    figs["nccl"] = nccl
    say(f"phase 22 (e) one-rank NCCL world, the zigzag ring (n = 1): "
        f"{json.dumps(nccl)}")
    figs["launches"] = launches
    figs["wall_s"] = time.perf_counter() - t0
    figs["peak_gib"] = {f"rank{r}": res.get("peak_gib")
                        for r, res in enumerate(ranks)}
    say(f"phase 22: {figs['wall_s']:.1f} s (world {ranks[0]['world_s']:.1f}"
        f" s; by part {json.dumps(ranks[0]['seconds'])}; peak GiB allocated "
        f"by rank and part {json.dumps(figs['peak_gib'])})")
    return figs

# ---------------------------------------------------------------------------
# phase 23: the obs session plane on the card
# ---------------------------------------------------------------------------

#: (a) two passes of phase 14's loop, a test pass of 2 batches after each
OBS_PASSES = 2
#: (b) GPT-2 steps under the session: enough for the roofline gauges'
#: 0.25 s window to close at least twice
OBS_LM_STEPS = 14
#: (c) a stitched timeline's TTFT against the engine's own observation
OBS_TTFT_RTOL = 0.05


def _obs_counter(reg, name, **labels) -> float:
    return sum(s["value"] for s in reg.collect()
               if s["name"] == name and all(
                   s["labels"].get(k) == v for k, v in labels.items()))


def obs_loop(say, seed: int, device: str) -> dict:
    """(a) the flagship's loop with and without a session, each trainer
    warmed first (its graphs captured; under the session for the
    session's run, so that the captures record its counts), and a
    flight dump on an injected fault."""
    import shutil
    import tempfile
    import torch
    from paddle_tpu_torch import faults, obs
    from paddle_tpu_torch.core.pytree import tree_items
    from paddle_tpu_torch.models import LSTMTextCls
    from paddle_tpu_torch.ops import cuda_kernels as ck
    cfg = TEXTCLS
    model = LSTMTextCls(cfg["vocab"], cfg["embed"], cfg["hidden"],
                        cfg["classes"], pool="last").init(seed, device)
    reader = loop_rows(seed + 2301, LOOP_BATCHES)
    test_reader = loop_rows(seed + 2302, LOOP_TEST_BATCHES)
    feeder = loop_feeder(device)
    res = {}
    tmp = tempfile.mkdtemp(prefix="obs_loop_")
    flight_path = os.path.join(tmp, "flight.jsonl")

    def goodput(reg):
        return {b: _obs_counter(reg, f"goodput.{b}_seconds_total",
                                component="trainer")
                for b in ("compile", "host_input", "device", "host_sync",
                          "idle")}
    try:
        for mode in ("off", "on"):
            tr = loop_trainer(model, torch.bfloat16, device,
                              output_dir=os.path.join(tmp, mode))
            costs = []

            def on_event(e, costs=costs):
                if type(e).__name__ == "EndIteration":
                    costs.append(e.cost)

            def warm():
                tr.train(loop_rows(seed + 2303, 1), model.tree(),
                         feeder=feeder, test_reader=loop_rows(seed + 2304, 1),
                         handle_signals=False)

            def run():
                return tr.train(reader, model.tree(), num_passes=OBS_PASSES,
                                feeder=feeder, test_reader=test_reader,
                                event_handler=on_event,
                                handle_signals=False)
            if mode == "off":
                warm()
                (p, _), wall, launches, _ = counted(run)
                res[mode] = (p, list(costs), wall, launches)
                continue
            reg = obs.MetricsRegistry()
            session = obs.ObsSession(registry=reg)
            with session.installed():
                warm()
                g0 = goodput(reg)
                fused0 = _obs_counter(reg, "kernels.routes_total",
                                      kernel="lstm_sequence_fused",
                                      route="fused")
                kb0 = _obs_counter(reg, "kernels.bytes_total",
                                   kernel="lstm_sequence_fused")
                rec = obs.FlightRecorder(session, flight_path).arm()
                try:
                    # counted() sets LAUNCHES and ROUTES to 0 first
                    (p, _), wall, launches, _ = counted(run)
                    routes = {k: n for k, n in ck.ROUTES.items() if n}
                    g1 = goodput(reg)
                    ratio = reg.gauge("goodput.ratio").get(
                        component="trainer")
                    # the counted run's own counts (the warm-up's out)
                    fused = _obs_counter(reg, "kernels.routes_total",
                                         kernel="lstm_sequence_fused",
                                         route="fused") - fused0
                    kb = _obs_counter(reg, "kernels.bytes_total",
                                      kernel="lstm_sequence_fused") - kb0
                    dump = session.dump()
                    # a fault at the loss read: the flight ring hits disk
                    # before the raise unwinds the loop
                    plan = faults.FaultPlan().add("step.grad", "raise",
                                                  nth=2)
                    raised = False
                    with plan.installed():
                        try:
                            tr.train(reader, model.tree(), feeder=feeder,
                                     handle_signals=False)
                        except faults.FaultError:
                            raised = True
                finally:
                    rec.disarm()
            res[mode] = (p, list(costs), wall, launches)
        p_off, c_off, w_off, l_off = res["off"]
        p_on, c_on, w_on, l_on = res["on"]
        check(c_on == c_off, f"obs (a): costs under the session {c_on} != "
              f"{c_off}")
        want = dict(tree_items(p_off))
        same = all(torch.equal(v, want[k]) for k, v in tree_items(p_on))
        check(same, "obs (a): parameters under the session differ")
        check(l_on == l_off, f"obs (a): launches {l_on} != {l_off}")
        spans = {e["name"] for e in dump["events"] if e["kind"] == "span"}
        need = {"trainer.pass", "trainer.step", "trainer.device_step",
                "trainer.host_sync", "trainer.checkpoint"}
        check(need <= spans, f"obs (a): spans {sorted(spans)}")
        buckets = {b: g1[b] - g0[b] for b in g1}
        check(all(v >= 0 for v in buckets.values()) and 0 < ratio <= 1,
              f"obs (a): goodput {buckets}, ratio {ratio}")
        want_fused = l_on.get("lstm_seq", 0) + l_on.get("lstm_seq_train", 0)
        check(fused == want_fused and fused > 0,
              f"obs (a): kernels.routes_total fused {fused} != #8 + #9 "
              f"launches {want_fused}")
        planned = sum(n for (name, kind), n in routes.items()
                      if name in ("lstm_seq", "lstm_seq_train"))
        check(planned == fused, f"obs (a): ROUTES {routes} against the "
              f"session's {fused}")
        check(kb > 0, "obs (a): no kernel bytes counted")
        check(raised, "obs (a): the injected step.grad fault did not raise")
        flight = obs.read_jsonl(flight_path)
        check(flight["meta"].get("reason") == "fault:step.grad"
              and any(e.get("name") == "trainer.step"
                      for e in flight["events"]),
              f"obs (a): flight dump {flight['meta']}")
        steps = OBS_PASSES * LOOP_BATCHES
        out = {"ms_per_step_off": w_off * 1e3 / steps,
               "ms_per_step_on": w_on * 1e3 / steps,
               "goodput_ratio": ratio, "goodput_s": buckets,
               "routes_fused": fused, "kernel_bytes": kb,
               "launches": l_on, "flight_events": len(flight["events"])}
        say(f"obs (a) the flagship's loop (bf16, {steps} steps + tests + "
            f"checkpoints, warmed) under a session: costs and parameters "
            f"bit-equal to the run without; {json.dumps(out)}")
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def obs_roofline(say, seed: int, device: str) -> dict:
    """(b) the peak row, the meta-tensor FLOPs of a GPT-2 step against
    6 N tokens, and the derived gauges after steps under a session."""
    import numpy as np
    import torch
    from paddle_tpu_torch import obs
    from paddle_tpu_torch.models import TransformerLM
    from paddle_tpu_torch.obs import roofline
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.trainer import Trainer
    name = torch.cuda.get_device_name(0)
    peak = roofline.peak_flops_per_sec()
    check(name in roofline.PEAK_TFLOPS and peak == 989e12
          and roofline.peak_hbm_bytes_per_sec() == 3350e9,
          f"obs (b): {name} resolves to peaks {peak}, "
          f"{roofline.peak_hbm_bytes_per_sec()}")
    cfg = GPT2_TRAIN
    model = TransformerLM(**cfg).init(seed=seed, device=device)
    rs = np.random.RandomState(seed + 2310)
    ids = torch.as_tensor(rs.randint(0, cfg["vocab"], (LM_BATCH, LM_SEQ))
                          .astype(np.int32), device=device)
    tr = Trainer(lm_loss(model, torch.bfloat16), Adam(LM_LR), device=device)
    reg = obs.MetricsRegistry()
    roofline._reset_derivers()
    with obs.ObsSession(registry=reg).installed():
        # through train: its goodput ledger waits for the card in the
        # device bucket, so each step's accounting follows its work; the
        # first call captures the step and counts its cost
        tr.train(lambda: iter([(ids,)] * 2), model.tree(),
                 handle_signals=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, st = tr.train(lambda: iter([(ids,)] * OBS_LM_STEPS),
                         model.tree(), handle_signals=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    (cost,) = tr.graphs.costs.values()
    d, V, L = cfg["d_model"], cfg["vocab"], cfg["n_layers"]
    n_params = 12 * L * d * d + V * d
    tokens = LM_BATCH * (LM_SEQ - 1)
    want = 6 * n_params * tokens
    check(cost.flops is not None and abs(cost.flops / want - 1) <= 0.02,
          f"obs (b): counted FLOPs {cost.flops} against 6 N tokens {want}")
    mfu = reg.gauge("roofline.mfu").get()
    bw = reg.gauge("roofline.hbm_bw_util").get()
    check(0 < mfu <= 1 and 0 < bw <= 1,
          f"obs (b): roofline.mfu {mfu}, hbm_bw_util {bw}")
    out = {"device": name, "peak_tflops": peak / 1e12,
           "step_flops": cost.flops, "six_n_tokens": want,
           "step_bytes": cost.bytes, "mfu": mfu, "hbm_bw_util": bw,
           "ms_per_step": wall * 1e3 / OBS_LM_STEPS,
           "mfu_from_wall": cost.flops * OBS_LM_STEPS / wall / peak,
           "dtype": "bfloat16 over f32 masters"}
    say(f"obs (b) roofline over GPT-2 ({cfg['vocab']} x {L} x {d}, "
        f"B {LM_BATCH} x T {LM_SEQ}): {json.dumps(out)}")
    del tr, p, st, model
    torch.cuda.empty_cache()
    return out


def obs_serving(say, seed: int, device: str) -> dict:
    """(c) phase 3's burst under a session with request timelines, bf16
    and int8 KV, against the same burst with no session; the HTTP view
    scraped once."""
    import urllib.request
    import torch
    from paddle_tpu_torch import obs
    from paddle_tpu_torch.models import TransformerLM
    from paddle_tpu_torch.obs.aggregate import ObsHttpServer
    from paddle_tpu_torch.obs.requests import stitch
    from paddle_tpu_torch.ops import cuda_kernels as ck
    from paddle_tpu_torch.serving import ServingEngine
    model = TransformerLM(**GPT2_SMALL).init(seed=seed, device=device)
    model.to(torch.bfloat16)
    prompts = workload(seed, GPT2_SMALL["vocab"])
    out, launches = {}, {}

    def burst(kv, keyed):
        eng = ServingEngine(model, device=device, kv_dtype=kv, **ENGINE)
        try:
            rids = [eng.submit(p, NEW_TOKENS,
                               submit_key=f"{kv}-{i}" if keyed else None)
                    for i, p in enumerate(prompts)]
            eng.start()
            while not all(eng.poll(r)[1] for r in rids):
                time.sleep(0.002)
        finally:
            eng.stop()
        check(eng.failed is None, f"obs (c): engine failed: {eng.failed}")
        return ([eng.poll(r)[0] for r in rids],
                [eng.timings(r)["t_first"] - eng.timings(r)["t_submit"]
                 for r in rids])

    for kv in (None, "int8"):
        tag = kv or "bf16"
        plain, _ = burst(kv, False)
        reg = obs.MetricsRegistry()
        with obs.ObsSession(registry=reg).installed() as s:
            led = obs.ensure_request_ledger()
            ck.reset_launch_counts()
            toks, ttft = burst(kv, True)
            launches[tag] = {k: n for k, n in ck.LAUNCHES.items() if n}
            dump = s.dump()
        check(toks == plain, f"obs (c) {tag}: tokens under the session "
              "differ from the burst without")
        errs = []
        for i, t in enumerate(ttft):
            st = stitch([led.get(f"{kv}-{i}")])
            check(st is not None and st["done"],
                  f"obs (c) {tag}: request {i} has no finished timeline")
            errs.append(abs(st["ttft_s"] - t) / t)
        check(max(errs) <= OBS_TTFT_RTOL, f"obs (c) {tag}: stitched TTFT "
              f"off the engine's by {max(errs):.3f} (> {OBS_TTFT_RTOL})")
        srv = ObsHttpServer(lambda d=dump: d).start()
        host, port = srv.address
        try:
            got = {}
            for path in ("/metrics", "/trace", "/requests"):
                with urllib.request.urlopen(f"http://{host}:{port}{path}",
                                            timeout=30) as r:
                    got[path] = r.read().decode()
        finally:
            srv.stop()
        check("paddle_tpu_serving_ttft_seconds" in got["/metrics"]
              and json.loads(got["/trace"])["traceEvents"]
              and len(json.loads(got["/requests"])["requests"])
              == len(prompts), f"obs (c) {tag}: the HTTP view")
        out[tag] = {"ttft_rel_err_max": max(errs),
                    "ttft_ms_median": sorted(ttft)[len(ttft) // 2] * 1e3,
                    "dispatches": _obs_counter(reg,
                                               "decode.dispatches_total"),
                    "tokens": _obs_counter(reg, "decode.tokens_total"),
                    "kernel_bytes": _obs_counter(reg, "kernels.bytes_total"),
                    "launches": launches[tag]}
    say(f"obs (c) GPT-2 small engine bursts under a session (request "
        f"timelines on): {json.dumps(out)}")
    del model
    torch.cuda.empty_cache()
    return out


def obs_timelines(say, seed: int, device: str) -> dict:
    """(d) torch.profiler over the fluid flagship's eager runs read by the
    xplane reader, the merged trace, and ``profile --decode``."""
    import tempfile
    import torch
    from paddle_tpu_torch import fluid, obs
    from paddle_tpu_torch.core import graphs
    from paddle_tpu_torch.obs import xplane
    cfg = TEXTCLS
    fluid.reset_default_programs()
    logits, loss = _fluid_textcls(fluid, "lstm", cfg["vocab"], cfg["embed"],
                                  cfg["hidden"], TEXTCLS_LR)
    main = fluid.default_main_program()
    exe = fluid.Executor(device=device, scope=fluid.Scope())
    exe.run(fluid.default_startup_program())
    batches = textcls_batches(seed + 2320, 3, device)
    with graphs.disabled():
        exe.run(main, feed=_fluid_feed(batches[0]), fetch_list=[loss])
        torch.cuda.synchronize()
        session = obs.ObsSession(registry=obs.MetricsRegistry())
        with session.installed(), torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for b in batches:
                exe.run(main, feed=_fluid_feed(b), fetch_list=[loss])
            torch.cuda.synchronize()
    space = xplane.read_torch_trace(prof)
    rows = xplane.op_totals(space)
    lstm_site = next(
        f"block 0, op #{i} (lstm)"
        for i, op in enumerate(main.global_block().ops)
        if op.type == "lstm")
    found = {}
    for body in ("lstm_seq_kernel", "lstm_seq_bwd_kernel"):
        hit = [r for r in rows if body in r["op"]
               and (body != "lstm_seq_kernel" or "bwd" not in r["op"])]
        # the profiler may drop a kernel record at the start of its
        # window: the kernel must be there and every record of it at the
        # lstm site (the count is printed)
        check(hit and all(r["site"] == lstm_site for r in hit),
              f"obs (d): {body} rows {hit} (want them at {lstm_site})")
        found[body] = {"count": sum(r["count"] for r in hit),
                       "self_ms": sum(r["self_ns"] for r in hit) / 1e6,
                       "site": hit[0]["site"]}
    report = xplane.top_ops_report(space, topk=12, steps=len(batches))
    check(lstm_site in report, "obs (d): the report names no lstm site")
    merged = obs.chrome_trace(obs.merge_dumps([
        session.dump(), xplane.xplane_dump(space)]))
    lanes = {e["args"]["name"] for e in merged["traceEvents"]
             if e.get("ph") == "M" and e.get("name") == "process_name"}
    check("/device:GPU:0" in lanes and any(
        e.get("name") == "fluid.run" for e in merged["traceEvents"]),
        f"obs (d): merged lanes {lanes}")
    print(report)
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "paddle_tpu_torch", "profile",
             "--decode", "8,128,64", "--trace-dir", d],
            cwd=HERE, capture_output=True, text=True, timeout=300)
        cli_s = time.perf_counter() - t0
        check(r.returncode == 0, f"obs (d): profile --decode exited "
              f"{r.returncode}: {r.stderr[-2000:]}")
        # the report cuts names at 44 characters: the trace it wrote
        # holds them whole
        rows = xplane.op_totals(
            xplane.read_trace(os.path.join(d, "trace.json")))
    ops = [row["op"] for row in rows]
    has = {"#1": [o for o in ops if "flash_fwd" in o],
           "#4": [o for o in ops if "decode_split" in o]}
    records = {k: sum(row["count"] for row in rows if row["op"] in v)
               for k, v in has.items()}
    check(all(has.values()), f"obs (d): profile --decode's trace names "
          f"{ {k: bool(v) for k, v in has.items()} }:\n{r.stdout[-3000:]}")
    print("\n".join(ln for ln in r.stdout.splitlines()[:8]))
    out = {"kernels": found, "lanes": sorted(lanes), "profile_cli_s": cli_s,
           "profile_cli_kernels": {k: v[0][:120] for k, v in has.items()},
           "profile_cli_records": records}
    say(f"obs (d) device timelines of 3 eager exe.runs of the fluid "
        f"flagship: {json.dumps(out)}")
    return out


def obs_phase(say, seed: int, device="cuda") -> dict:
    """Phase 23 (module docstring): (a)-(d)."""
    t0 = time.perf_counter()
    out = {"loop": obs_loop(say, seed, device)}
    out["roofline"] = obs_roofline(say, seed, device)
    out["serving"] = obs_serving(say, seed, device)
    out["timelines"] = obs_timelines(say, seed, device)
    out["launches"] = {
        "loop": out["loop"]["launches"],
        **{f"serving {k}": v["launches"]
           for k, v in out["serving"].items()}}
    out["wall_s"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# phase 24: the elastic plane and the tune plane on the card, and the C
# inference API
# ---------------------------------------------------------------------------

ELASTIC_STEPS, ELASTIC_SHARDS = 4, 4
#: kernels the tune sweep launches (#4-#12)
TUNE_KERNELS = ("decode_attention", "decode_attention_q",
                "paged_decode_attention", "paged_decode_attention_q",
                "lstm_seq", "lstm_seq_train", "lstm_seq_bwd", "gru_seq",
                "gru_seq_bwd")
#: the tiled LSTM backward against the untiled one: each tile's dU partial
#: is summed in tile order (tests/test_torch_tune.py states 2e-5, absolute
#: and relative, on the CPU; here the absolute part scales with the
#: tensor's largest magnitude)
TILE_GRAD_TOL = 2e-5
#: the sweep's profile (tune/spaces.py PROFILES: the flagship shapes)
TUNE_PROFILE = "bench"
#: the tuned engine's traffic: the first prompts of the serving workload
TUNE_REQUESTS, TUNE_TOKENS = 4, 16


def _tests_on_path() -> None:
    tests = os.path.join(HERE, "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)


def _host_tree(tree) -> dict:
    from paddle_tpu_torch.core.pytree import tree_items
    return {"/".join(p): v.detach().cpu().clone() for p, v in
            tree_items(tree)}


def _trees_equal(a: dict, b: dict) -> bool:
    import torch
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def _graph_launches(worker) -> dict:
    """The kernel launches each captured graph of an elastic worker holds
    (recorded at its capture)."""
    out: dict = {}
    for g in worker.graphs._graphs.values():
        for k, n in g.launches.items():
            out[k] = out.get(k, 0) + n
    return out


def _elastic_master(loss_fn, make_opt, device, on_step, **kw):
    from paddle_tpu_torch.trainer.elastic import ElasticMaster
    em = ElasticMaster(loss_fn, make_opt(), shards_per_step=ELASTIC_SHARDS,
                       device=device, **kw)
    em.on_step = lambda p, s, l: on_step(s, em._params, l)
    return em.start()


def _thread_workers(em, n, seed, device, prefix):
    import threading
    from torch_elastic_net import flagship
    from paddle_tpu_torch.trainer.elastic import ElasticWorker
    stop = threading.Event()
    pairs = []
    for i in range(n):
        # a module of its own: functional_call swaps its parameters
        w = ElasticWorker(flagship(steps=0, seed=seed)[0], em.address,
                          worker=f"{prefix}{i}", device=device)
        t = threading.Thread(target=w.run, kwargs={"stop": stop},
                             daemon=True)
        t.start()
        pairs.append((w, t))
    return stop, pairs


def elastic_phase(say, seed: int, device="cuda") -> dict:
    """(a) ElasticMaster (4 shards a step) and two ElasticWorker threads on
    one card train the LSTM flagship at full width (f32, Adam) for
    ELASTIC_STEPS steps: each step's parameters bit-equal to the
    sequential reference on the card (the same graphed shard gradients,
    the shard-ordered reduce, one graphed Adam update), #9 and #10 in
    each worker's graph; (b) the same pass with a third worker, a
    subprocess (tests/torch_elastic_worker.py) SIGKILLed while it holds a
    shard: eviction re-buckets its shard and the pass equals (a)'s."""
    import signal
    import threading
    import torch
    from paddle_tpu_torch import obs
    from paddle_tpu_torch.ops import cuda_kernels as ck
    _tests_on_path()
    from torch_elastic_net import flagship, sequential_reference
    loss_fn, make_params, make_opt, batches = flagship(steps=ELASTIC_STEPS,
                                                      seed=seed)
    dev = torch.device(device)
    t0 = time.perf_counter()
    ref = []
    sequential_reference(loss_fn, make_params(dev), make_opt, batches,
                         shards=ELASTIC_SHARDS, device=dev,
                         on_step=lambda s, p, l: ref.append(
                             (_host_tree(p), l)))
    t_ref = time.perf_counter() - t0

    got = []
    em = _elastic_master(loss_fn, make_opt, dev,
                         lambda s, p, l: got.append((_host_tree(p), l)),
                         min_workers=2, ttl=10.0, task_timeout_s=120.0)
    stop, pairs = _thread_workers(em, 2, seed, dev, "smoke-w")
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        em.fit(batches, make_params(dev), progress_timeout=120.0)
        torch.cuda.synchronize()
        launches = dict(ck.LAUNCHES)
        t_fit = time.perf_counter() - t0
    finally:
        stop.set()
        for _, t in pairs:
            t.join(timeout=30)
        em.stop()
    check(len(got) == len(ref) == ELASTIC_STEPS,
          f"elastic: {len(got)} steps applied, want {ELASTIC_STEPS}")
    for s, ((gp, gl), (rp, rl)) in enumerate(zip(got, ref)):
        check(_trees_equal(gp, rp), f"elastic step {s}: the parameters "
              "differ from the sequential reference's")
        check(gl == rl, f"elastic step {s}: loss {gl} != reference {rl}")
    per_worker = {}
    for w, _ in pairs:
        gl = _graph_launches(w)
        per_worker[w.worker] = {"shards": w.shards_contributed,
                                "graph_launches": gl}
        check(w.shards_contributed > 0
              and gl.get("lstm_seq_train", 0) > 0
              and gl.get("lstm_seq_bwd", 0) > 0,
              f"elastic worker {w.worker}: {per_worker[w.worker]}")
    check(launches["lstm_seq_train"] > 0 and launches["lstm_seq_bwd"] > 0,
          f"elastic: #9/#10 launches {launches}")
    say(f"elastic (a): {ELASTIC_STEPS} steps of the LSTM flagship (vocab "
        f"30000, embed 128, H 256, B 64 in {ELASTIC_SHARDS} shards, T 100, "
        f"f32, Adam) by 2 thread workers, every step's parameters bit-equal "
        f"to the sequential reference; losses {[l for _, l in got]}; "
        f"workers {json.dumps(per_worker)}; launches {launches}; fit "
        f"{t_fit:.2f} s, reference {t_ref:.2f} s (host-clock smoke "
        "figures, not a benchmark)")

    # (b) a subprocess worker killed mid-pass
    reg = obs.MetricsRegistry()
    kill = {"killed": False, "epoch": None}
    final = {}
    with obs.ObsSession(registry=reg).installed():
        em = _elastic_master(loss_fn, make_opt, dev,
                             lambda s, p, l: final.update(params=p, loss=l),
                             min_workers=3, ttl=1.5, task_timeout_s=300.0)
        host, port = em.address
        proc = subprocess.Popen(
            [sys.executable, os.path.join(HERE, "tests",
                                          "torch_elastic_worker.py"),
             host, str(port), "smoke-kw", "300", "--workload", "flagship",
             "--device", str(dev)],
            cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        stop, pairs = _thread_workers(em, 2, seed, dev, "smoke-s")

        def killer():
            deadline = time.monotonic() + 240.0
            while time.monotonic() < deadline and proc.poll() is None:
                with em._mu:
                    holding = "smoke-kw" in em._assigned.values()
                    step = em._step
                if step >= 1 and holding:
                    kill["epoch"] = em.membership.epoch
                    os.kill(proc.pid, signal.SIGKILL)
                    kill["killed"] = True
                    return
                time.sleep(0.001)

        kt = threading.Thread(target=killer, daemon=True)
        kt.start()
        t0 = time.perf_counter()
        try:
            params, _, loss = em.fit(batches, make_params(dev),
                                     progress_timeout=240.0)
            kt.join(timeout=10)
            t_kill = time.perf_counter() - t0
            survivors = len(em.membership.members())
            epoch = em.membership.epoch
        finally:
            stop.set()
            for _, t in pairs:
                t.join(timeout=30)
            if proc.poll() is None:
                proc.kill()
            out = proc.communicate(timeout=60)[0].decode(errors="replace")
            em.stop()
    check(kill["killed"], f"elastic (b): the subprocess worker was never "
          f"killed holding a shard; its output: {out[-2000:]}")
    check(epoch > kill["epoch"] and survivors == 2,
          f"elastic (b): epoch {kill['epoch']} -> {epoch}, {survivors} "
          "survivors")
    rebucket = reg.counter("cluster.rebucket_tasks_total").get()
    evicted = reg.counter("cluster.leaves_total").get(reason="evicted")
    check(rebucket >= 1 and evicted >= 1,
          f"elastic (b): rebucketed {rebucket}, evicted {evicted}")
    check(_trees_equal(_host_tree(params), got[-1][0])
          and loss == got[-1][1],
          "elastic (b): the pass with a killed worker differs from (a)'s")
    say(f"elastic (b): a subprocess worker SIGKILLed holding a shard at "
        f"epoch {kill['epoch']}; evicted {evicted:.0f}, re-bucketed "
        f"{rebucket:.0f} shard(s), {survivors} survivors, the pass bit-equal "
        f"to (a)'s ({t_kill:.2f} s, subprocess start included)")
    return {"launches": launches, "workers": per_worker,
            "losses": [l for _, l in got], "fit_s": t_fit,
            "killed": {"epoch": kill["epoch"], "rebucketed": rebucket,
                       "evicted": evicted, "seconds": t_kill}}


def _serve_tokens(eng, prompts, n: int) -> list:
    """Greedy tokens of ``prompts`` through a stopped ServingEngine, every
    prompt queued before the scheduler starts."""
    try:
        rids = [eng.submit(p, n) for p in prompts]
        eng.start()
        while not all(eng.poll(r)[1] for r in rids):
            time.sleep(0.002)
    finally:
        eng.stop()
    check(eng.failed is None, f"engine failed: {eng.failed}")
    return [eng.poll(r)[0] for r in rids]


def _tiled_lstm_check(say, what, tune, cache, device, seed) -> dict:
    """The fused LSTM at the flagship's shape (B 64, T 100, H 256, f32)
    with ``cache`` installed against the heuristic route (no cache): the
    outputs bit for bit, the gradients to TILE_GRAD_TOL."""
    import numpy as np
    import torch
    from paddle_tpu_torch.ops import rnn as R
    from paddle_tpu_torch.ops import rnn_kernels as rk
    rs = np.random.RandomState(seed)
    B, T, D, H = 64, 100, 128, 256
    x = rs.randn(B, T, D).astype(np.float32) * 0.3
    w = rs.randn(D, 4 * H).astype(np.float32) * 0.05
    u = rs.randn(H, 4 * H).astype(np.float32) * 0.05
    b = rs.randn(4 * H).astype(np.float32) * 0.05
    lens = torch.tensor(rs.randint(30, T + 1, B).astype(np.int32),
                        device=device)
    g = torch.tensor(rs.randn(B, T, H).astype(np.float32), device=device)

    def run():
        args = [torch.tensor(a, device=device, requires_grad=True)
                for a in (x, w, u, b)]
        out, st = R.lstm(args[0], lens, *args[1:])
        loss = (out * g).sum() + st.h.sum() + st.c.sum()
        grads = torch.autograd.grad(loss, args)
        torch.cuda.synchronize()
        return [out.detach(), st.h.detach(), st.c.detach()], grads

    tune.set_cache(cache)
    xw = torch.zeros(B, T, 4 * H, device=device)
    routes = {n: rk.route_for(n, xw, H) for n in ("lstm_seq_train",
                                                  "lstm_seq_bwd")}
    got = run()
    tune.set_cache(None)
    want = run()
    for a, bb in zip(got[0], want[0]):
        check(torch.equal(a, bb), f"{what}: the forward differs from the "
              "heuristic route's")
    worst = 0.0
    for a, bb in zip(got[1], want[1]):
        scale = bb.abs().max().item()
        err = (a - bb).abs().max().item()
        worst = max(worst, err / max(scale, 1e-30))
        torch.testing.assert_close(a, bb, rtol=TILE_GRAD_TOL,
                                   atol=TILE_GRAD_TOL * scale)
    res = {n: (r.kind, [t for _, t in r.tiles]) for n, r in routes.items()}
    say(f"{what}: routes {res}; forward bit-equal to the heuristic route's, "
        f"gradients within {TILE_GRAD_TOL} (the largest error {worst:.2e} "
        "of its tensor's largest magnitude)")
    return {"routes": res, "grad_rel_err": worst}


def tune_phase(say, seed: int, device="cuda") -> dict:
    """(c) ``tune.run_tune(profile="bench", reps=3)`` over all five spaces
    on the card into a temporary cache, each family's winner printed
    beside the heuristic; with the cache installed: a GPT-2-small f32
    ServingEngine with page_block, cache_bucket and prompt buckets left to
    the consults serves the greedy tokens of the heuristic engine; the
    flagship LSTM under the tuned row tiles (and under a forced 16-row
    tile) equals plan_route's; a decode read at the tuned split count
    equals the heuristic count's; plan_source() says "tuned"."""
    import tempfile
    import numpy as np
    import torch
    from paddle_tpu_torch import tune
    from paddle_tpu_torch.models import TransformerLM
    from paddle_tpu_torch.ops import cuda_kernels as ck
    from paddle_tpu_torch.serving import ServingEngine
    from paddle_tpu_torch.serving.batcher import DEFAULT_PROMPT_BUCKETS
    out = {}
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "autotune.json")
        ck.reset_launch_counts()
        t0 = time.perf_counter()
        rep = tune.run_tune(profile=TUNE_PROFILE, reps=3, cache_path=path,
                            device=device)
        torch.cuda.synchronize()
        launches = dict(ck.LAUNCHES)
        out["seconds"] = time.perf_counter() - t0
        out["launches"] = launches
        rows = []
        for r in rep["results"]:
            row = {k: r.get(k) for k in ("space", "kernel", "family", "plan",
                                         "tuned_ms", "heuristic_plan",
                                         "heuristic_ms", "speedup", "note")}
            if r["space"] == "decode_route":
                row["sweep"] = [{k: v for k, v in x.items() if k != "sweep"}
                                for x in r["sweep"]]
            rows.append(row)
            say(f"tune {json.dumps(row)}")
        out["results"] = rows
        check({r["space"] for r in rows} == set(tune.SPACE_NAMES),
              f"tune: spaces swept {sorted({r['space'] for r in rows})}")
        check(rep["backend"] == "device"
              and rep["device_kind"] == torch.cuda.get_device_name(0),
              f"tune: backend {rep['backend']}, kind {rep['device_kind']}")
        check(all(launches[k] > 0 for k in TUNE_KERNELS),
              f"tune: a kernel of #4-#12 never launched: {launches}")
        say(f"tune sweep: {out['seconds']:.1f} s; launches {launches}")
        cache = tune.load_cache(path)
        tune.set_cache(cache)
        try:
            check(tune.plan_source() == "tuned", "plan_source() is not "
                  "'tuned' with the sweep's cache installed")
            # a GPT-2-small engine left to the consults
            model = TransformerLM(**GPT2_SMALL).init(seed=seed,
                                                     device=device)
            prompts = workload(seed, GPT2_SMALL["vocab"])[:TUNE_REQUESTS]
            tuned = ServingEngine(model, device=device, slots=8, segment=32)
            pool = tuned.pool
            out["engine"] = {"page_block": pool.bs,
                             "cache_bucket": pool.cache_bucket,
                             "prompt_buckets": list(pool.prompt_buckets)}
            toks = _serve_tokens(tuned, prompts, TUNE_TOKENS)
            heur = ServingEngine(model, device=device,
                                 prompt_buckets=DEFAULT_PROMPT_BUCKETS,
                                 **ENGINE)
            want = _serve_tokens(heur, prompts, TUNE_TOKENS)
            check(toks == want, "tuned engine: greedy tokens differ from "
                  "the heuristic engine's")
            say(f"tuned GPT-2-small f32 engine {json.dumps(out['engine'])}: "
                f"{TUNE_REQUESTS} requests x {TUNE_TOKENS} greedy tokens "
                "equal to the heuristic engine's (page_block 64, "
                "cache_bucket 256, prompt buckets 32-512)")
            del tuned, heur, pool, model
            gc.collect()
            out["lstm_tuned"] = _tiled_lstm_check(
                say, "flagship LSTM under the tuned row tiles", tune, cache,
                device, seed)
            forced = tune.AutotuneCache()
            fam = tune.fused_family(gates=4, T=100, H=256, batch=64)
            for k in ("lstm_seq_train", "lstm_seq_bwd"):
                forced.put("fused_rnn", k, torch.cuda.get_device_name(0),
                           fam, 16, tune.space_hash("fused_rnn"))
            out["lstm_tile16"] = _tiled_lstm_check(
                say, "flagship LSTM under a forced 16-row tile", tune,
                forced, device, seed)
            tune.set_cache(cache)
            # a decode read at the tuned split count
            B, Hh, Dh, L = 8, 12, 64, 512
            n = tune._decode_splits(B * Hh, L)
            h = ck.decode_splits(B * Hh, L, ck.default_split_count(B * Hh,
                                                                   L))[0]
            check(n is not None and ck.decode_splits(B * Hh, L)[0]
                  == ck.decode_splits(B * Hh, L, n)[0],
                  f"decode: the tuned count {n} is not consulted")
            rs = np.random.RandomState(seed)
            q, k, v = (torch.tensor(rs.randn(*s).astype(np.float32),
                                    device=device)
                       for s in ((B, Hh, Dh), (B, L, Hh, Dh), (B, L, Hh, Dh)))
            pos = torch.full((B,), L - 1, dtype=torch.int32, device=device)
            o_t = ck._decode_attention_kernel(q, k, v, pos, Dh ** -0.5,
                                              None, None, n)
            o_h = ck._decode_attention_kernel(q, k, v, pos, Dh ** -0.5,
                                              None, None, h)
            err = (o_t - o_h).abs().max().item()
            torch.testing.assert_close(o_t, o_h, rtol=1e-5, atol=1e-6)
            out["decode"] = {"L": L, "tuned_splits": n,
                             "heuristic_splits": h, "max_abs_err": err}
            say(f"decode read (B 8, 12 heads of 64, L 512): tuned split "
                f"count {n} against the heuristic {h}: max |diff| {err:.2e}")
        finally:
            tune.set_cache(None)
    return out


def capi_phase(say, seed: int, device="cuda") -> dict:
    """(d) The C inference API built from csrc/capi_inference.cc; pti_create
    on the fluid LSTM flagship's exported bundle (vocab 30000, embed 128,
    H 256) and pti_forward on a batch of 64 x 100: the output bit-equal to
    InferenceHost(...).run (Executor.run of the same bundle), #8
    launched."""
    import ctypes
    import tempfile
    import numpy as np
    import torch
    from paddle_tpu_torch import fluid as tfluid
    from paddle_tpu_torch.ops import cuda_kernels as ck
    from paddle_tpu_torch.runtime.capi_host import InferenceHost
    from paddle_tpu_torch.runtime.lib import load_capi
    build = load_capi()
    say(f"C inference API: {build.seconds:.1f} s "
        f"({'built' if build.built else 'cached'} with g++) -> "
        f"{build.path.name}")
    lib = build.lib
    cfg = TEXTCLS
    tfluid.reset_default_programs()
    logits, _ = _fluid_textcls(tfluid, "lstm", cfg["vocab"], cfg["embed"],
                               cfg["hidden"], TEXTCLS_LR)
    exe = tfluid.Executor(scope=tfluid.Scope(), device=device)
    exe.run(tfluid.default_startup_program())
    rs = np.random.RandomState(seed)
    words = rs.randint(0, cfg["vocab"], (TEXTCLS_BATCH, TEXTCLS_LEN)
                       ).astype(np.int32)
    lens = rs.randint(TEXTCLS_MIN_LEN, TEXTCLS_LEN + 1,
                      TEXTCLS_BATCH).astype(np.int32)
    with tempfile.TemporaryDirectory() as d:
        bundle = os.path.join(d, "textcls")
        tfluid.io.export_inference_model(bundle, ["words", "lens"],
                                         [logits], exe)
        want = InferenceHost(bundle, device=device).run([words, lens])
        ck.reset_launch_counts()
        h = lib.pti_create(bundle.encode())
        check(bool(h), f"pti_create: {lib.pti_last_error().decode()}")
        try:
            arrs = [np.ascontiguousarray(words), np.ascontiguousarray(lens)]
            inputs = (ctypes.c_void_p * 2)(*[a.ctypes.data for a in arrs])
            shapes = (ctypes.c_longlong * 3)(*words.shape, *lens.shape)
            ndims = (ctypes.c_int * 2)(2, 1)
            dtypes = (ctypes.c_int * 2)(1, 1)
            buf = np.zeros(4096, np.float32)
            oshape = (ctypes.c_longlong * 8)()
            ondim = ctypes.c_int(0)
            rc = lib.pti_forward(
                h, inputs, shapes, ndims, dtypes, 2, 0,
                buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                buf.size, oshape, ctypes.byref(ondim))
            torch.cuda.synchronize()
            launches = dict(ck.LAUNCHES)
        finally:
            lib.pti_destroy(h)
    check(rc >= 0, f"pti_forward: {lib.pti_last_error().decode()}")
    got = buf[:rc].reshape(tuple(oshape[i] for i in range(ondim.value)))
    check(got.shape == want.shape and got.tobytes() == want.tobytes(),
          f"C API forward {got.shape} differs from Executor.run's "
          f"{want.shape}")
    check(launches["lstm_seq"] > 0, f"C API: #8 not launched: {launches}")
    say(f"C inference API: pti_forward on the flagship bundle (B "
        f"{TEXTCLS_BATCH}, T {TEXTCLS_LEN}) bit-equal to Executor.run; "
        f"launches {launches}")
    return {"launches": launches, "out_shape": list(got.shape),
            "build_s": build.seconds}


def elastic_tune_phase(say, seed: int, device="cuda:0") -> dict:
    """Phase 24: (a)-(b) elastic_phase, (c) tune_phase, (d) capi_phase."""
    t0 = time.perf_counter()
    res = {"elastic": elastic_phase(say, seed, device)}
    res["tune"] = tune_phase(say, seed, device)
    res["capi"] = capi_phase(say, seed, device)
    res["seconds"] = time.perf_counter() - t0
    say(f"phase 24: {res['seconds']:.1f} s")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--split-sweep", action="store_true",
                    help="time #4's and #5's split counts at B 1/2/8/32, "
                         "not only at the decode paths' B (2 and 8, where "
                         "#6 and #7 are swept too)")
    ap.add_argument("--rnn-sweep", action="store_true",
                    help="time every plan of the recurrent forwards (#8, "
                         "#9, #11) at their bench shapes and print the "
                         "chosen plan beside the fastest")
    ap.add_argument("--parent", metavar="DIR",
                    help="a checkout of the parent commit (git archive); "
                         "its forward bodies of #8, #9 and #11 and its "
                         "one-block paged reads #6 and #7 are built there "
                         "and timed in turns with these")
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(HERE, "paddle_tpu_torch")):
        print("chip_smoke: the paddle_tpu_torch package is not beside this "
              "script", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()

    def say(msg: str) -> None:
        print(f"{msg} | {card}", flush=True)

    t_start = time.perf_counter()

    def stamp(what: str) -> None:
        say(f"elapsed {time.perf_counter() - t_start:.1f} s after {what}")

    from paddle_tpu_torch.ops import _build
    build = _build.load()
    say(f"build: {build.seconds:.1f} s ({'built' if build.built else 'cached'}"
        f" with nvcc for sm_90a) -> {build.path.name}")
    for ln in build.resource_lines():
        print(f"  ptxas: {ln}")
    sass = sass_counts(build.path / _build.LIB_NAME)
    say(f"SASS of the tensor-core bodies: {json.dumps(sass)}")
    # #10 plans for two blocks an SM on grids past one wave: its launch
    # bounds must keep it at 128 registers a thread (256 threads)
    lstm_regs = ptxas_usage(build, "lstm_seq_bwd_kernel")
    say(f"lstm_seq_bwd_kernel registers and spills: {json.dumps(lstm_regs)}")
    check(sorted(lstm_regs) == ["bfloat16", "float32"]
          and all(0 < (r["registers"] or 0) <= 128
                  for r in lstm_regs.values()),
          f"lstm_seq_bwd_kernel: over 128 registers a thread ({lstm_regs})")

    parent = load_parent(args.parent) if args.parent else None
    flash = flash_checks(say)
    paged = paged_checks(say, parent=parent)
    stamp("phases 1-2")
    launches = serving_phase(say, args.seed)
    stamp("phase 3")
    for entry in (flash, paged):
        entry["launches"] = launches[entry["name"]]
    fwd_regs = {"lstm_seq_kernel": ptxas_usage(build, "lstm_seq_kernel",
                                               ("save", "wide")),
                "gru_seq_kernel": ptxas_usage(build, "gru_seq_kernel",
                                              ("wide",))}
    say(f"forward kernels' registers and spills: {json.dumps(fwd_regs)}")
    lstm = lstm_kernel_checks(say, args.seed, parent=parent)
    if args.rnn_sweep:
        sweep = rnn_sweep(say, args.seed)
    stamp("phase 4")
    launches, steps = training_phase(say, args.seed)
    stamp("phase 5")
    for entry in lstm:
        entry["launches"] = launches[entry["name"]]
        entry["launches_note"] = (f"{steps} training steps, then a test "
                                  "pass over 2 batches")
        if entry["name"] == "lstm_seq_bwd":
            entry["ptxas"] = lstm_regs
        else:
            entry["ptxas"] = fwd_regs["lstm_seq_kernel"]
    flash["training_shapes"], bwd = flash_bwd_checks(say, args.seed)
    stamp("phase 6")
    lm_launches, lm_steps = lm_training_phase(say, args.seed)
    stamp("phase 7")
    nmt_launches, nmt_steps = nmt_training_phase(say, args.seed)
    stamp("phase 8")
    for entry in bwd:
        name = entry["name"]
        entry["launches"] = lm_launches[name] + nmt_launches[name]
        entry["launches_note"] = (
            f"{lm_launches[name]} in {lm_steps} LM training steps + "
            f"{nmt_launches[name]} in {nmt_steps} NMT training steps")
    flash["launches_training"] = {
        "lm": lm_launches["flash_attention_fwd"],
        "nmt": nmt_launches["flash_attention_fwd"]}
    decode = decode_checks(
        say, args.seed, SPLIT_BATCHES if args.split_sweep else PATH_BATCHES,
        parent=parent, paged_entry=paged)
    stamp("phase 9")
    runs = dense_decode_phase(say, args.seed)
    stamp("phase 10")
    for entry in decode:
        per_run = {run: n[entry["name"]] for run, n in runs.items()
                   if entry["name"] in n}
        entry["launches"] = sum(per_run.values())
        entry["launches_note"] = per_run
    flash["launches_decode"] = {run: n.get("flash_attention_fwd", 0)
                                for run, n in runs.items()}
    gru = gru_kernel_checks(say, args.seed, parent=parent)
    gru[0]["ptxas"] = fwd_regs["gru_seq_kernel"]
    gru[1]["ptxas"] = ptxas_usage(build, "gru_seq_bwd_kernel")
    say(f"gru_seq_bwd_kernel registers and spills: "
        f"{json.dumps(gru[1]['ptxas'])}")
    stamp("phase 11")
    train, s2s_steps, gen = s2s_phase(say, args.seed)
    stamp("phase 12")
    for entry in gru:
        name = entry["name"]
        entry["launches"] = train[name] + sum(g[name] for g in gen.values())
        entry["launches_note"] = (
            f"{train[name]} in {s2s_steps} seq2seq training steps + "
            + " + ".join(f"{g[name]} in one {what} generate call"
                         for what, g in gen.items()))
    image = image_phase(say, args.seed)
    stamp("phase 13")
    loop = loop_phase(say, args.seed)
    stamp("phase 14")
    data = data_phase(say, args.seed, loop)
    stamp("phase 15")
    zoo = zoo_phase(say, args.seed)
    stamp("phase 16")
    s18 = slice18_phase(say, args.seed)
    stamp("phase 17")
    s19 = slice19_phase(say, args.seed)
    stamp("phase 18")
    s20 = slice20_widths_phase(say, args.seed)
    stamp("phase 19")
    fl = fluid_phase(say, args.seed)
    stamp("phase 20")
    v2r = v2_phase(say, args.seed)
    stamp("phase 21")
    world = world_phase(say, args.seed)
    stamp("phase 22")
    obs_res = obs_phase(say, args.seed)
    stamp("phase 23")
    p24 = elastic_tune_phase(say, args.seed)
    stamp("phase 24")
    elastic_l = p24["elastic"]["launches"]
    tune_l = p24["tune"]["launches"]
    for entry in [paged] + decode + lstm + gru:
        name = entry["name"]
        if name in ("lstm_seq_train", "lstm_seq_bwd"):
            entry["launches_elastic"] = elastic_l[name]
            check(elastic_l[name] > 0, f"phase 24: {name} never launched "
                  "by the elastic workers")
        if name in TUNE_KERNELS:
            entry["launches_tune"] = tune_l[name]
            check(tune_l[name] > 0,
                  f"phase 24: {name} never launched by the tune sweep")
        if name == "lstm_seq":
            entry["launches_capi"] = p24["capi"]["launches"][name]
    for entry in [flash] + decode + [paged] + lstm:
        entry["launches_obs"] = {
            run: n.get(entry["name"], 0)
            for run, n in obs_res["launches"].items()}
    for entry in [flash] + bwd:
        entry["launches_world"] = {
            rank: {call: n[entry["name"]] for call, n in calls.items()}
            for rank, calls in world["launches"].items()}
        check(all(all(v > 0 for v in per.values())
                  for per in entry["launches_world"].values()),
              f"phase 22: {entry['name']} not launched on every rank")
    for entry in lstm + gru:
        entry["launches_fluid"] = fl["launches"].get(entry["name"], 0)
        check(entry["launches_fluid"] > 0,
              f"fluid phase: {entry['name']} never launched")
        entry["launches_v2"] = v2r["launches"].get(entry["name"], 0)
        check(entry["launches_v2"] > 0,
              f"v2 phase: {entry['name']} never launched")
    gaps = [g["worst_gap_bf16_ulps"] for g in NEAR_TIE_GAPS]
    check(bool(gaps), "no burst was held by greedy_within_ties")
    say(f"near-tie gaps of the bf16 serving checks (bf16 ulps between each "
        f"chosen token's plain logit and the argmax's, the largest a "
        f"burst): {json.dumps(NEAR_TIE_GAPS)}; the largest {max(gaps):.3f} "
        f"against the bound {NEAR_TIE_ULPS}")
    for entry in lstm:
        entry["launches_loop"] = loop["loop"]["launches"][entry["name"]]
        entry["launches_data"] = data["launches"][entry["name"]]
        entry["launches_zoo"] = zoo["launches"][entry["name"]]
    for entry in [flash] + bwd:
        entry["launches_zoo"] = zoo["launches"][entry["name"]]
    for entry in lstm + gru:
        entry["launches_routes"] = s18["recurrences"]["launches"].get(
            entry["name"], 0)
    if args.rnn_sweep:
        for entry in lstm + gru:
            for tag, res in sweep.items():
                if tag.split()[0] == entry["name"]:
                    entry.setdefault("sweep", {})[tag.split()[1]] = res
    for entry in [flash] + bwd:
        for bodies, key in ((TENSOR_CORE_BODIES, "sass_bfloat16"),
                            (TF32_BODIES, "sass_float32")):
            for body, name in bodies.items():
                if entry["name"] == name:
                    entry[key] = sass[body]
    print(json.dumps({"graph_paths": GRAPH_PATHS, "card": card}))
    print(json.dumps({"image": image, "card": card}))
    print(json.dumps({"loop": loop, "card": card}))
    print(json.dumps({"data": data, "card": card}))
    print(json.dumps({"zoo": zoo, "card": card}))
    print(json.dumps({"slice18": s18, "card": card}))
    print(json.dumps({"slice19": {k: v for k, v in s19.items()
                                  if k != "entries"}, "card": card}))
    print(json.dumps({"slice20": {k: v for k, v in s20.items()
                                  if k != "entries"}, "fluid": fl,
                      "card": card}))
    print(json.dumps({"v2": v2r, "near_tie_gaps": NEAR_TIE_GAPS,
                      "card": card}))
    print(json.dumps({"world": {k: v for k, v in world.items()
                                if k != "launches"}, "card": card}))
    print(json.dumps({"obs": obs_res, "card": card}))
    print(json.dumps({"phase24": p24, "card": card}))
    print(json.dumps({"kernels": [flash] + bwd + [paged] + decode + lstm
                      + gru + s19["entries"] + s20["entries"],
                      "card": card}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
