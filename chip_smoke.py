#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py        # from the repository root, on a CUDA machine

Phases (any failure exits non-zero):

1. device  — needs ``torch.cuda.is_available()``; prints the card's name and
   power limit as ``nvidia-smi`` reports them.
2. build   — compiles the hand-written CUDA kernels from the sources in this
   checkout (``nvcc``, sm_90a) and prints the build seconds, then the bf16
   tensor-core kernels' and the split decode kernel's registers and spill
   stores from ptxas' report and, from the card, their registers, local
   bytes, dynamic shared memory and blocks per SM at D 64, 80 and 128
   (the flash forward also in its training instance, which writes the
   rows' logsumexp; the flash backward's dK/dV and dQ kernels through
   ``flash_attention_backward_info``); the same for the SSD scan kernels
   (``ssd_scan_info``) at the calls phases 10-12 make.
3. kernels — each paged-attention kernel against its plain PyTorch version
   on the card, at the main path's widths (KVH 5, G 3, D 64, page 16), at
   llama3-8b's (KVH 8, G 4, D 128, page 8) and at zamba2-2.7b's (KVH 32,
   G 1, D 80, page 16), each over a pool of q's dtype and over an int8
   pool with f32 scales (the int8 variant, which reads the pool in int8
   and applies the scales on the card, against ``dequantize_pages`` + the
   plain versions). Decode runs the split decode kernel; the mixed step
   runs as the engine calls it (``num_decode=SLOTS``: with bf16 q the
   decode rows through the split kernel, the chunk rows through the
   tensor-core chunk kernel) and without the hint (every row through the
   split kernel); the chunked prefill runs the tensor-core kernel with
   bf16 q and the CUDA-core one with f32 q: bf16 within
   2e-2 absolute (f32 accumulation, bf16 output: a few bf16 ulps of
   outputs of magnitude ~1), f32 within 1e-3, and dead rows (idle slots,
   padded chunk rows, length 0) bit-exact zeros. Every width runs the
   main path's shapes: MAX_LEN / page table entries over 400 shuffled
   physical pages, lengths 0, 1, page+-1, partial last pages up to 631, a
   chunk straddling a page with valid < C, a full chunk from position 0,
   an all-padding chunk, and a mixed batch with dead rows among live ones.
   Then times each kernel, its plain version and a library yardstick
   (``F.scaled_dot_product_attention`` on the gathered dense K/V, which the
   port never calls) at the shapes of one engine step, cycling over 32
   layers' pools as a step does (the mixed kernel with the engine's hint,
   and also without it); and all three the same way at the llama3-8b and
   zamba2-2.7b widths.
4. engine  — full-width smollm-360m (bf16, seeded random weights) served by
   ``ContinuousBatchingEngine(max_slots=8, page_size=16, prefill_chunk=64)``:
   16 requests of 100-600 prompt tokens (half share a 128-token prefix),
   32 new tokens each, greedy and seeded top-p. Every request must finish
   by length, the prefix index must hit, and each kernel's launch count
   (reset just before this run) must be > 0: the decode-only, chunk-only
   and mixed routes all ran. Prints tok/s, TTFT and ITL, then a
   torch.profiler window over a second run (device busy share, the
   paged-attention kernels' share of it by kernel, the top device ops);
   the window must show the split decode kernel and no instance of the
   CUDA-core prefill template (which serves f32 q only).
5. parity  — the same engine in f32 with TF32 off, once through the kernels
   and once through the plain versions (``attn_impl="ref"``): the greedy
   token streams must be identical. Depth is cut to 2 layers for this
   phase: the random-weight model amplifies f32 rounding differences with
   depth until the argmax flips (the phase prints the one-chunk logit gap
   at 32 and at 2 layers to show it).

6. flash    — the flash-attention kernel against its plain version
   (``ref.flash_attention_chunked``) at smollm widths (H 15, KVH 5, D 64):
   bf16 within 2e-2 and f32 within 1e-3. Fixed cases at B 8: causal with
   Sq = Skv in {1, 64, 100, 256, 300, 512}, causal with Sq 64 < Skv 320,
   non-causal with Sq 37, Skv 300; at B 1 every whole-prompt bucket from
   128 to 1024. Then every (B, S) that phases 7 and 8 gave the kernel, as
   recorded from their prefills, and zamba2's D 80 (32 heads, G 1),
   causal and not, with every (B, S) of phase 15's zamba2 prefills (the
   check runs after phase 15 for that reason). The ragged lengths go to
   the kernel's wrapper directly (the op keeps the reference's
   Skv-multiple-of-256 rule), and llama3-8b's D 128 (32 / 8 heads). bf16
   runs the tensor-core kernel, f32 the CUDA-core one. Before the engines
   it times the kernel, its plain version and
   ``F.scaled_dot_product_attention (..., is_causal=True, enable_gqa=True)``
   (which the port never calls) at the two engine shapes: lockstep (B 8,
   S 256) and whole-prompt (B 1, S 512), cycling over 32 layers' inputs, at
   smollm's widths and at llama3-8b's and zamba2-2.7b's.
7. lockstep — full-width smollm-360m through ``GenerationEngine(max_batch=8,
   max_len=512)``: 16 requests of 64-256 prompt tokens (every batch's
   longest prompt inside the reference's flash contract), 32 new tokens
   each, greedy and seeded top-p alternating. Every request finishes by
   length and the flash launch count (reset just before) is 32 per
   prefilled batch. Prints tok/s, TTFT, ITL and a profiler window.
8. whole-prompt — full-width smollm-360m through
   ``ContinuousBatchingEngine(max_slots=8, page_size=16, prefill_chunk=None,
   max_len=1024)`` (buckets 128-1024, all inside the contract): 8 requests
   of 100-600 prompt tokens, 32 new each. Flash launches = 32 per
   admission, decode-kernel launches > 0. Prints tok/s, TTFT, ITL and a
   profiler window (checked as phase 4's).
9. whole-prompt parity — f32, TF32 off: the one-prefill logit gap of the
   flash kernel to its plain version at 32 and at 2 layers, then at 2
   layers (PARITY_LAYERS, as phase 5) greedy lockstep streams through the
   kernels equal those through the plain versions, and the whole-prompt
   paged engine's streams equal the chunked paged engine's and the
   lockstep engine's (one request at a time) on the same requests.

10. ssd     — both Mamba2 SSD kernels against their plain versions on the
   card at mamba2-1.3b widths (H 64, P 64, N 128) and zamba2-2.7b's
   (H 80, N 64): bf16 within 5e-2 and f32 within 1e-3 (atol and rtol;
   the JAX package's SSD bounds). The check runs after phase 15, to take
   its prompts. Scan cases, at both widths: a 64-token chunk whose tail
   has dt = 0 (valid 41 < C) from a non-zero init_state, a full chunk
   from a non-zero state, and the engines' pattern: 7 chained 64-token
   calls carrying the state against one plain call over 448 tokens; S =
   200 over two sequences (four of the kernel's 64-token sub-chunks,
   ragged end) from zero; a whole 512-token prompt from zero (mamba2);
   and every (B, S) batch of phase 15's lockstep prefills from zero at
   its arch's widths. bf16 scans must all take the tensor-core kernel and
   f32 ones the CUDA-core template (``LAUNCHES_BY_PATH``). Decode, at
   both widths: 8 slots with 3 idle, in place, the idle slots' state bit
   for bit unchanged, and 8 slots ungated (the lockstep engine's call).
   Before the engines it times each kernel and its plain version at one
   engine step's
   shapes (decode: 8 slots, 2 of them idle; scan: one 64-token chunk of
   one sequence), cycling over 48 layers' states, and the scan at S 512
   and at zamba2's widths.
11. mamba2  — mamba2-1.3b at full width (bf16, seeded random weights),
   depth cut to SSM_ENGINE_LAYERS (12) of its 48 layers to keep the
   script in its limit (phases 12 and 15 run all 48), served by
   ``SSMEngine(max_slots=8, prefill_chunk=64,
   max_len=512)``: 8 requests of 64-400 prompt tokens, 24 new tokens each,
   greedy and seeded top-p alternating. Every request must finish by
   length, both SSD launch counts (reset just before this run) must be
   > 0, and every scan launch must have taken the tensor-core kernel.
   Prints tok/s, TTFT and ITL and a torch.profiler window (device busy
   share, the SSD kernels' share of it, the top device ops), which must
   show the tensor-core scan and no CUDA-core scan instance.
12. mamba2 parity — f32 with TF32 off, at the full 48 layers (the SSD
   kernels keep the one-chunk logit gap to plain far below the argmax
   margin, unlike the smollm phase's attention, so no depth cut): the
   one-chunk logit gap to plain must stay under 1e-3, greedy streams
   through the kernels equal those through the plain versions
   (``ssd_impl="ref"``), and a run with one snapshot preemption and one
   discard preemption gives the same streams as the undisturbed run.
13. zamba2  — zamba2-2.7b at full width (bf16, seeded random weights,
   32 heads of D 80), depth cut to SSM_ENGINE_LAYERS (12) of its 54 Mamba2
   layers: 2 groups, each led by the one shared attention + MLP block
   (phase 15 runs all 54), served by ``SSMEngine(max_slots=8,
   prefill_chunk=64, max_len=512, page_size=16)``: 8 requests of 64-400
   prompt tokens, 24 new each, greedy and seeded top-p alternating; then 8
   more over a pool of Z_TIGHT_PAGES pages, on which decode-time page
   growth preempts (youngest first, at least once). Every request must
   finish by length; the paged decode and chunk kernels and both SSD
   kernels (counts reset before each run) must launch in each run, the
   fused mixed kernel never (the hybrid engine has no mixed step), and
   every scan must take the tensor-core kernel. Prints tok/s, TTFT, ITL
   and a profiler window (device busy share, each kernel's share of it),
   which must show the split decode, tensor-core chunk, tensor-core scan
   and SSD decode kernels and neither CUDA-core template.
14. zamba2 parity — f32, TF32 off, at Z_PARITY_LAYERS (24): the one-chunk
   logit gaps of the kernels to the plain versions and of the plain path
   in f32 to the same path with f64 weights (``_hybrid_chunk_logits``)
   beside the top-2 margin, and the plain engine's greedy streams in f32
   and in f64, which must agree (f32 rounding alone flips no argmax of
   the check; at 54 and 36 layers it does). There, greedy
   ``SSMEngine`` streams through the kernels equal the plain f32 ones
   (``attn_impl``/``ssd_impl="ref"``) and those of a run over
   Z_PARITY_TIGHT_PAGES pages that preempts, and
   ``preempt_youngest(snapshot=True)`` on a hybrid slot raises.
15. lockstep ssm/hybrid — full-width mamba2-1.3b and zamba2-2.7b (bf16)
   through ``GenerationEngine(max_batch=8, max_len=512)``: 8 requests of
   64-256 prompt tokens (the flash contract), 16 new each; every request
   finishes by length, the scan (all on the tensor-core kernel), the SSD
   decode and (zamba2) flash launch counts are > 0. Then, in f32 at the
   parity depths (mamba2 48, zamba2 24), the greedy streams of 5
   equal-length prompts (one left-pad-free batch) through lockstep equal
   those through ``SSMEngine``.
16. ssm serve driver — ``python -m repro_torch.launch.serve --arch
   zamba2-2.7b`` and ``--engine lockstep --arch mamba2-1.3b`` at full
   width (each serving-driver phase runs the driver's ``main`` in this
   process, ``serve_cli``): 8/8 served, ``engine=ssm`` and
   ``engine=lockstep``.

17. int8 timing — the int8 variant of the three paged kernels (checked in
   phase 3), their plain versions and SDPA on K/V dequantized and gathered
   in advance, at phase 3's engine-step shapes and at the llama3-8b and
   zamba2-2.7b widths; the bound counts int8
   K/V plus a 4-byte scale per (position, kv head).
18. int8 engine — phase 4's trace through ``ContinuousBatchingEngine(...,
   kv_quant="int8")`` on smollm-360m at full width, depth cut to
   VARIANT_LAYERS (4) of its 32 layers (here and in phase 19), in turns
   with bf16 pages
   (bf16, int8, int8, bf16): every request finishes by length, the prefix
   index hits and each paged kernel runs (path ``chunked_int8`` in
   ``launches_by_path``, the first int8 turn). Prints tok/s, TTFT, ITL
   per turn and a profiler window of each page type (checked as phase
   4's).
19. tier restart — smollm-360m (VARIANT_LAYERS), once with bf16 pages (path
   ``tiered``) and once with int8 pages (path ``tiered_int8``), a pool of
   128 pages with ``host_pages`` and ``persist_dir`` in a temporary
   directory: phase 4's trace must reclaim and spill parked pages; after
   ``flush_tiers()`` a NEW engine on the same directory reruns the same
   prompts with persisted hits and fewer prefill chunks (the TTFT change
   is printed), and every page it reloaded holds, byte for byte, what the
   store kept under the page's content key, for every pool tensor (int8
   K/V and their f32 scales for int8 pages).
20. tier + int8 parity — f32, TF32 off, PARITY_LAYERS layers: greedy int8
   streams through the kernels equal those through the plain versions;
   the tiered run, its restart from the store and an untiered run give
   the same streams with one slot (f32 pages) and with four slots (f32
   and int8 pages, interleaved steps, a pool on which the tiered run
   reclaims and spills while other slots are live; its dispatches must
   equal the untiered run's one for one, and no run may preempt).
21. serve driver — ``python -m repro_torch.launch.serve --kv-quant int8
   --host-pages 8 --persist-dir DIR`` at full width, twice on one
   directory: 12/12 served each time, persisted hits only on the second.

22. verify — the chunk kernel (row 2) at speculative-verify widths: bundles
   of C = k + 1 rows (k 1-8) with valid < C, at the smollm, llama3 and
   zamba2 widths, over bf16, int8 and f32 pools, on a plain and a
   COW-forked table, against ``paged_verify_attention_ref`` (bf16 within
   2e-2, f32 1e-3, padded rows exact zeros); the paged kernels at the
   other shapes phases 23-25 give them, bf16 and f32, against their plain
   versions: decode of 1 row over 44-entry tables (the draft's greedy
   steps: 44 splits of one page), of 4 rows over 16-entry tables (the
   chaos engines) and over 44-entry ones, the chunk kernel at C 32 (the
   draft's catch-up) from position 0, a page boundary and deep in the
   table, the hinted mixed step with num_decode 4 over 16-entry tables;
   then the C 5 call (SPEC_K 4 drafts + 1) timed against its plain
   version, SDPA and its bound.
23. spec engine — the first SPEC_REQUESTS (4) of phase 4's requests on
   full-width smollm-360m (bf16) with speculation off, ``ngram`` and a
   2-layer smollm draft on its own seeded weights (the reduced config's
   256-token vocabulary cannot draft for a 49152-token target), SPEC_K 4:
   every request finishes by length, the page pool and the draft pool
   drain, the draft arm dispatches bundles. Prints each arm's tok/s, TTFT,
   ITL, bundles, proposed, accepted and rolled-back drafts, and the host
   seconds in proposals, verify dispatches and plain steps
   (``launches_by_path``: ``spec ngram``, ``spec draft``). Then a witness
   for the oracle draft's acceptance in bf16: the target's own weights as
   the draft on 2 greedy requests, through the kernels and through the
   plain versions, at full width and at 2 layers, where the kernels must
   land half the drafts or more; at 16, 8 and 4 layers through the kernels
   alone (acceptance by depth).
24. spec parity — f32, TF32 off, PARITY_LAYERS: greedy and seeded top-p
   streams with ngram, an oracle draft and a random proposer equal
   speculation off through the kernels and through the plain versions, on
   prompts repeated around their own spec-off streams; every proposer
   dispatches bundles, the oracle draft lands drafts and the random
   proposer rolls back.
25. fleet — ``python -m repro_torch.launch.serve --fleet 2`` at full width
   serves 12/12; then two chaos runs in this process (2-3 engine workers,
   threads on the one card; the long stream's owner killed once two of
   its tokens reached the client): f32 at PARITY_LAYERS, whose streams
   equal a single-engine oracle with no mismatched delta, and bf16 at full
   width, where every request is terminal and each (uid, index) is on
   ``responses`` once, before its finish (streams differing from the
   oracle are printed; path ``fleet chaos``: the launches from the fleet's
   start to the end of its run, after the oracle). Device memory after the
   chaos runs may not exceed what it was before them (engines collected,
   cuBLAS workspaces cleared).
26. put_tree — a tree of CUDA bf16 and f32 tensors stores under the refs of
   the same values on the CPU.

27. notebook — the notebook of ``examples/notebook_to_pipeline.py`` (its
   cells copied here) through ``repro_torch.core`` on the card: split
   into piped sections, sealed (every capsule must record the ``cuda``
   backend and ``torch.cuda.device_count()``), deployed as Deployment and
   PV/PVC YAML into a temporary directory, then scheduled with one chaos
   kill of its second step: the ``report`` must equal
   ``Notebook.run_linear``'s and the killed step must have been retried.
28. flash gradients — ``ops.flash_attention`` under autograd on the card
   (``FlashAttentionFunction``: the forward kernel, which also writes the
   rows' logsumexp, and the backward kernel, ``csrc/flash_backward.cu``)
   against the plain version's own autograd, with a loss whose upstream
   gradient depends on the output, and the backward kernel alone against
   ``ref.flash_attention_bwd`` on the same inputs, at FLASH_GRAD_SHAPES:
   the training shape (B 16 x S 64, 15 / 5 heads, D 64), D 80 (32 / 32
   heads), D 128 (32 / 8) and group 6 (48 / 8), whisper-tiny's
   encoder (not causal) and cross attention (Sq 37, Skv 300), a causal
   length of 300 that ``causal_flash`` pads to 512, and the backward's
   ragged edges (Skv 200, not a multiple of its 128-key blocks; Sq 45
   over Skv 320), bf16 and f32;
   the q, k and v gradients within 2e-2 (bf16) and 1e-3 (f32) of the
   gradient's largest magnitude (at least 1); each call one forward and
   one backward launch; two backward runs bit-equal. Prints the largest
   gaps. Then times, at the training shape (cycling over 32 layers'
   inputs) and at phase 38's B 4 x S 4096 (over 4), the forward kernel
   against its plain version, SDPA and its bound, the backward kernel
   against ``ref.flash_attention_bwd``, SDPA's backward and its bound,
   and forward + backward through the autograd Function, the plain
   version's autograd and SDPA's (the kernels line's flash ``train``
   entry and the backward's times); then the backward kernel alone at
   FLASH_BWD_WIDTHS (zamba2's D 80, 32 / 32 heads, and the group of 6 at
   D 128, 48 / 8, B 1 x S 4096) beside SDPA's backward and its bound, and
   the wrapper's host enqueue time a call at the training shape (1000
   calls, no synchronise). At each timed backward shape one layer's dq,
   dk and dv from the kernel are held against ``ref.flash_attention_bwd``
   on the same inputs within 2e-2 of each gradient's scale, and two
   kernel calls must give the same bits.
29. train — ``launch.train`` (``repro_torch.launch.train.run``) at full
   width as TRAIN_RUNS gives it: smollm-360m, 16 of its 32 layers, bf16
   parameters, f32 moments, B 16 x S 64, 60 steps at ``--lr`` 1e-2, a checkpoint
   every 20, ``--chaos`` (the train pod killed twice): the loss must
   improve and the eval loss lie below the first step's, the train step
   must be retried twice, the flash forward and backward kernels must
   launch (path ``train`` in ``launches_by_path``: the counts reset just
   before the run and read just after), and the third attempt must start
   within 64 MiB of the
   first attempt's device memory (the killed attempts' model and train
   state freed; what remains is a cuBLAS workspace per dead thread).
   Prints s/step and tokens/s, checkpoint save and restore seconds and
   bytes, device memory at each attempt's start and after the run, and a
   torch.profiler window over TRACE_TRAIN_STEPS train steps (device busy
   share, the flash forward, flash backward and SSD kernels' shares of
   it, the top device ops).
   Then PARITY_LAYERS layers in f32 (TF32 off), 60 steps: through the
   kernel, again with ``--chaos`` (a checkpoint every 20 steps), through
   the plain version (``--attn-impl ref``) and through the plain version
   in f64 (every f32 cast of the plain path kept at f64): the chaos run's
   losses must equal the uninterrupted run's exactly (after at least one
   kill), and the largest per-step gap between the kernel and the plain
   version may not exceed the plain version's own largest f32-vs-f64
   gap.

30. ssd gradients — ``ops.ssd_scan`` under autograd on the card (the scan
   kernel's forward inside ``SSDScanFunction``, the plain scan's
   recompute for backward) against the plain version's own autograd,
   with a loss whose upstream gradient depends on y and on the final
   state: at mamba2's (H 64, P 64, N 128) and zamba2's (H 80, N 64) SSD
   widths, B 4 x S 256 (four of the kernel's 64-token sub-chunks), bf16
   and f32; the x, dt, A, Bm and Cm gradients within 5e-2 (bf16) and
   1e-3 (f32) of the gradient's largest magnitude (at least 1). Both SSD
   wrappers must refuse inputs that require grad. Then times the kernel
   at that shape (mamba2 widths, cycling over 48 layers' inputs) against
   its plain version and its bound, and forward + backward through the
   Function against the plain autograd (the kernels line's SSD ``train``
   entry).
31. ssm/hybrid train — phase 29's run for mamba2-1.3b (12 of its 48
   layers, to keep the script in its limit; B 4 x S 256, ``--chaos``;
   the SSD scan on path ``train``, every scan on the tensor-core kernel)
   and zamba2-2.7b (12 of its 54 layers: 2 occurrences of the shared
   block, the same shape, no chaos, one checkpoint at the end;
   flash and the scan on ``train zamba2``), then each at PARITY_LAYERS in
   f32 as phase 29's, 30 steps, a checkpoint every 10 in the chaos run
   (plain: ``--ssd-impl ref``, and ``--attn-impl ref`` for zamba2, whose
   one group keeps the shared block before PARITY_LAYERS Mamba layers),
   with the kernel-vs-plain gap held within twice the plain path's own
   f32-vs-f64 gap: the triangle bound for a kernel that rounds no worse
   than the plain version (|k - p| <= |k - f64| + |p - f64|), since each
   f32 path's rounding is amplified alike by the training (PERF.md,
   section 6).
32. whisper — whisper-tiny at full width (4 + 4 layers, d_model 384, 6 /
   6 heads of D 64, vocab 51865, bf16): phase 29's run (B 16 x S 64,
   frames S 64, ``--chaos``; flash on ``train whisper``); the lockstep
   engine (8 requests of 64-256 tokens, 16 new, greedy and seeded top-p
   alternating; 12 flash launches a prefilled batch on ``lockstep
   whisper``; tok/s, TTFT, ITL); the same engine in f32 with TF32 off
   through the kernel and through the plain version, whose greedy streams
   must be equal (or, where the plain path's own f32 and f64 streams part
   too, the one-prefill logit gap must stay within the plain path's
   f32-vs-f64 gap); ``python -m repro_torch.launch.serve --arch
   whisper-tiny --engine lockstep`` (``engine=lockstep``) and without
   ``--engine`` (``UnsupportedConfigError``); and the flash kernel at
   whisper's widths, causal and not, at every (B, S) the phase gave it.

33. dbrx — dbrx-132b at full width (d_model 6144, 48 / 8 heads of D 128,
   16 experts of d_ff 10752, top 4, bf16, seeded random weights), depth
   cut to MOE_LAYERS (4) of its 40 layers (28.5 GB; the whole model is
   263 GB), through ``ContinuousBatchingEngine(max_slots=8, page_size=16,
   prefill_chunk=64)`` in the fused step mode (paths ``dbrx fused``) and
   the interleaved one (``dbrx interleaved``): 8 requests of 64-400 prompt
   tokens, 24 new each, greedy and seeded top-p alternating; then through
   ``GenerationEngine(max_batch=8)`` (``lockstep dbrx``; the same prompt
   lengths, left-padded to a batch's longest, which attention past 256
   positions pads to a multiple of 256: ``causal_flash``). Every request
   finishes by length and every kernel of each path launches (counts
   reset before each run). Prints
   tok/s, TTFT, ITL, launches and the peak device memory a run, and a
   profiler window of MV_TRACE_STEPS decode steps per engine: ms a step on
   the host and on the device against the step's least time (every
   weight but the embedding read once: every expert, as the reference's
   dense decode reads them), the device busy share and the cuBLAS GEMMs'
   share. Then ``python -m repro_torch.launch.serve --arch dbrx-132b
   --layers 4`` (in this process, ``serve_cli``): 8/8 served on the paged
   engine.
34. internvl2 — internvl2-26b whole (48 layers, 39.7 GB, 256 stub vision
   positions of zeros) through the paged engine, whose vlm prompts are
   always prefilled whole (``internvl2 whole-prompt``: flash over 256 +
   bucket, padded to a multiple of 256, then the paged decode kernel; 8
   requests of 64-400 tokens), and at VLM_LOCK_LAYERS (24) through the
   lockstep engine (``lockstep internvl2``: the same lengths); the
   same prints and windows as phase 33. Engines hold the state dict they
   are given without a copy (``build_model(params=...)``). Then the flash
   kernel at their 48 / 8-head width against its plain version, at fixed
   cases and at every (B, S) phases 33-34 gave it (bf16 2e-2, f32 1e-3).
35. moe/vlm parity — both at PARITY_LAYERS, full width, f32, TF32 off:
   greedy streams through the kernels equal those through the plain
   versions on dbrx's paged engine in both step modes and its lockstep
   engine, and on internvl2's whole-prompt and lockstep engines; the one-
   prefill logit gap (dbrx: a 64-token chunk, the capacity dispatch;
   internvl2: a 200-token prompt after its vision positions) of the
   kernels to the plain versions within twice the plain path's own
   f32-vs-f64 gap (the triangle bound), and, for dbrx, the router top-k
   choices of that prefill that differ between kernels and plain versions.
36. moe/vlm train — ``python -m repro_torch.launch.train`` (in this
   process, ``launch.train.run`` with the depth cut, as phase 29 runs it:
   bf16 parameters, f32 moments) at full width, TRAIN_RUNS' shapes, no
   chaos, one checkpoint after the last step: internvl2 at 4 layers (2.7
   B parameters, B 4 x S 64 after the 256 vision positions) and dbrx at 1
   (4.5 B, B 2 x S 128; its 45 GB checkpoint outlasts the 30 s liveness
   window, so the pod lives on its side-thread beats: no retry). Before
   each, every leaf's first gradient finite and nonzero (the router's and
   ``vision_proj``'s included). The loss must improve and the eval loss
   lie below the first step's; flash launched (paths ``train internvl2``,
   ``train dbrx``); s/step, tokens/s, saves, peak memory and a profiler
   window of TRACE_TRAIN_STEPS steps.
37. tensor-parallel serving — a mesh of TP_RANKS (2) ranks sharing
   cuda:0 (``make_serving_mesh(devices=...)``; gloo, NCCL taking one rank
   per card; the follower spawned once for the phase): llama3-8b at full
   width and TP_LAYERS (2) of its 32 layers (16 q over 4 kv heads of D
   128 a rank; the untied vocab's logits gathered) through the paged
   engine chunked in both step modes and whole-prompt (paths ``tp llama3
   chunked fused``, ``... interleaved``, ``... whole-prompt``), after
   the same 8 requests at tp 1 (the baseline); mamba2-1.3b at
   TP_SSM_LAYERS (6) of 48 (32 SSD heads a rank) through ``SSMEngine``
   (``tp mamba2``). Every request finished by length; each rank's pool
   or bank at its local heads; every kernel of each path launched on both
   ranks (``launches_by_path`` sums the ranks); tok/s (one card shared
   by two gloo ranks: not tensor parallelism's speed), collectives and
   broadcast bytes a call, peak memory. On the same mesh and llama3
   weights, three more paths: ``tp llama3 tiers`` (host and persisted KV
   tiers under pool pressure, every parked page flushed; a new engine on
   the same store reloads pages from it, and every reloaded page, read
   whole through the gathered page read, equals the store's bytes),
   ``tp llama3 fleet`` (a FleetSupervisor of 2 workers on the mesh, one
   killed: every request terminal, each (uid, index) once, the streams
   that part from the unperturbed tp-2 engine's counted, and the follower
   holds no executor after shutdown) and ``tp llama3 draft``
   (speculation with the first TP_DRAFT_LAYERS layer as the draft, whole
   on rank 0: bundles, accepted drafts, tok/s). Then, at PARITY_LAYERS in
   f32 with TF32 off, greedy streams at tp 2 through the kernels equal
   tp 1's and tp 2's through the plain versions, for both models, and,
   for llama3, tp 2's with the draft proposer; there a fleet with a kill
   gives every stream of the unperturbed tp-2 engine.
38. dry run against the card — the dry run's cost model
   (``launch/builders.py``, ``analysis/``: the step counted on meta
   tensors, beside the kernels' build) held against the card on
   DRYRUN_CELLS, each at full width on a (data 1, model 1) mesh with the
   batch cut to one card: smollm-360m ``train_4k`` at B 4 (ga 1, flash
   inside its autograd Function), llama3-8b ``decode_32k`` at B 8 (the
   lockstep ``decode_step``, 34 GB of cache) and mamba2-1.3b
   ``prefill_32k`` at B 1 (the SSD scan kernel).
   Prints the card's ``total_memory`` beside ``HW().hbm_per_chip``; per
   cell the predicted resident bytes (the arguments the step reads + the
   f32 unembedding a serving step keeps) and peak bytes beside the
   measured ones (``memory_allocated`` after a warm step, and
   ``max_memory_allocated`` over a step less what was allocated before
   it; each within DRYRUN_MEM_TOL, 10%), the cuBLAS workspaces' share of
   the resident bytes, the median of DRYRUN_STEPS steps, which must not
   be under the roofline bound (``RooflineTerms.bound_s``: a lower
   bound), the bound's share of the step and the MFU. Flash, its
   backward and the SSD scan launch there (paths ``dryrun smollm
   train``, ``dryrun mamba2 prefill``); since the backward kernel, the
   smollm cell counts about 0.67 TB a step, not 5.67.

Kernel and plain times are device time per call: the calls are enqueued
behind a sleep kernel and timed with CUDA events, so the host's per-call
overhead stays out (``_time_ms``). A ``[t s] phase: s`` line after each
phase gives the wall time so far and the phase's own (PERF.md has a
run's).

The line before the last is ``{"kernels": [...]}`` (the six ported
kernels and the flash backward, which replaces no Pallas kernel: its
``replaces`` is the JAX function whose gradient it computes); each
kernel's ``launches`` is the sum of ``launches_by_path``,
the counts read after each engine path that ran it (each reset just
before its path). The three paged kernels also carry ``int8``: the int8
variant's max abs error, times and bound; the mixed kernel's ``ms`` is the
hinted call's and ``generic_ms`` the call without the hint; the chunk
kernel carries ``verify``: phase 22's errors (bf16, int8 and f32 pools)
and the C 5 call's times and bound; the SSD scan carries ``train``:
phase 30's largest bf16 gradient gap and its times there (forward, and
forward + backward); flash carries ``train``: phase 28's
largest bf16 gradient gap at the training shape and the times there
(forward, and forward + backward). Flash's ``train`` path counts its
launches in phase 29's full-width run (each layer's forward, again in
the layer's checkpointed recompute, and the evaluation); the backward's
one per layer and step. The backward's own times are at the training
shape, and its ``train_4k`` entry at B 4 x S 4096 (with the forward's
times there and forward + backward through the Function, the plain
autograd and SDPA), its ``zamba2 D80`` and ``group 6 D128`` entries at S
4096 and its ``host_enqueue_us``. The last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import re
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
PAGED_SOURCE = "src/repro_torch/kernels/csrc/paged_attention.cu"
SSD_SOURCE = "src/repro_torch/kernels/csrc/ssd_scan.cu"
FLASH_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
FLASH_BWD_SOURCE = "src/repro_torch/kernels/csrc/flash_backward.cu"
# kernel -> (its CUDA source, the Pallas function it replaces)
KERNELS = {
    "paged_attention_bkgd": (
        PAGED_SOURCE, "src/repro/kernels/paged_attention.py:141"),
    "paged_prefill_attention_ckgd": (
        PAGED_SOURCE, "src/repro/kernels/paged_attention.py:289"),
    "paged_mixed_attention_rkgd": (
        PAGED_SOURCE, "src/repro/kernels/paged_attention.py:443"),
    "ssd_scan_bshp": (SSD_SOURCE, "src/repro/kernels/ssd_scan.py:89"),
    "ssd_decode_step_bh": (SSD_SOURCE, "src/repro/kernels/ssd_scan.py:146"),
    "flash_attention_bhsd": (
        FLASH_SOURCE, "src/repro/kernels/flash_attention.py:87"),
    # no Pallas backward: it replaces the gradient JAX takes of its plain
    # chunked attention (``jax.vjp`` through ``jax.checkpoint``)
    "flash_attention_bwd": (
        FLASH_BWD_SOURCE, "src/repro/kernels/ref.py:76"),
}
# the card's data-sheet rates: one place states them,
# src/repro_torch/analysis/roofline.py (HW); outside a checkout this import
# fails and the script exits non-zero
sys.path.insert(0, str(SRC))
from repro_torch.analysis.roofline import HW as _HW  # noqa: E402

HBM_BYTES_PER_S = _HW().hbm_bw          # bytes/s
BF16_FLOP_PER_S = _HW().peak_flops      # dense bf16
F32_FLOP_PER_S = _HW().f32_flops        # f32, CUDA cores
BF16_TOL, F32_TOL = 2e-2, 1e-3
SLEEP_CYCLES = 200_000_000     # ~0.1 s at the H100's ~1.98 GHz boost clock
KVH, G, D, PAGE, LAYERS = 5, 3, 64, 16, 32
SLOTS, CHUNK, MAX_LEN = 8, 64, 704
PARITY_LAYERS = 2
# speculative decoding: drafts a bundle, and the verify width timed
SPEC_K = 4
VERIFY_C = SPEC_K + 1
# phase 23 serves the first 4 of phase 4's 16 requests; its oracle-draft
# witness (k serial draft decodes a slot a step: 61 s over 8 requests at
# 32 layers) serves the first WITNESS_REQUESTS greedy ones
SPEC_REQUESTS, WITNESS_REQUESTS = 4, 2
# the witness's depths: the plain versions run at the first and the last
WITNESS_DEPTHS = (LAYERS, 16, 8, 4, PARITY_LAYERS)
# the draft model's catch-up chunk (DraftModelProposer's default)
DRAFT_CHUNK = 32
# phases 29, 31, 32, 36: the full-width training runs: B x S, steps, the
# learning rate, the checkpoint interval, --chaos (two kills), and the
# PARITY_LAYERS f32 runs (run_train_parity): their steps, the chaos run's
# checkpoint interval (attempts that outlive --chaos's 1 s kill timer, and
# restore from a checkpoint) and the factor on the plain path's own
# f32-vs-f64 gap that the kernel-vs-plain gap must stay within. The rates
# are tools/train_lr_sweep.py's: the one at which each model leaves its
# ln(vocab) plateau within the run without diverging (a 32-layer smollm
# stays on it from the driver's default 3e-3 and diverges from 3e-2;
# mamba2 diverges from 1e-2, zamba2 from 1e-2 and stays on it at 3e-3;
# PERF.md has each sweep). ``layers`` cuts a run's depth (None: the
# config's): smollm trains at 16 layers (its rate swept at 32), mamba2 and
# zamba2 at 12 (the script's time limit), internvl2-26b at 4 and dbrx-132b at 1 (one card's memory:
# 2.7 B and 4.5 B parameters with their f32 moments; their 27 GB and
# 45 GB checkpoints outlast the scheduler's 30 s liveness window, C.10).
# ``timed`` times a restore of the final checkpoint onto the card (the
# script's time limit leaves it to the smollm and whisper runs)
TRAIN_RUNS = {
    arch: dict(arch=arch, layers=layers, batch=b, seq=s, steps=n, lr=lr,
               ckpt_every=c, chaos=chaos, parity=parity, timed=timed)
    for arch, layers, b, s, n, lr, c, chaos, parity, timed in (
        ("smollm-360m", 16, 16, 64, 60, 1e-2, 20, True, (60, 20, 1.0),
         True),
        ("mamba2-1.3b", 12, 4, 256, 16, 3e-3, 16, True, (20, 10, 2.0),
         False),
        ("zamba2-2.7b", 12, 4, 256, 12, 6e-3, 12, False, (20, 10, 2.0),
         False),
        ("whisper-tiny", None, 16, 64, 60, 1e-2, 20, True, None, True),
        ("internvl2-26b", 4, 4, 64, 30, 1e-2, 30, False, None, False),
        ("dbrx-132b", 1, 2, 128, 30, 3e-3, 30, False, None, False))}
# the profiled steps of each full-width run
TRACE_TRAIN_STEPS = 3
# depth cuts of earlier paths, to keep the script inside its time limit:
# the smollm variants of phases 18-19 (int8 pages, the tiers) and the SSM
# engine runs of phases 11 and 13 (their parity phases keep their depths)
VARIANT_LAYERS, SSM_ENGINE_LAYERS = 4, 12
# phase 30: the SSD scan under autograd at the trainer's (B, S)
SSD_TRAIN_SHAPE = (4, 256)
# phase 32: whisper's f32 parity streams
W_PARITY_REQUESTS = 5
# the chaos runs' engines: slots and max_len (16-entry block tables)
FLEET_SLOTS, FLEET_MAX_LEN = 4, 256
# mamba2-1.3b: SSD widths, layers, and the engine's shape
SSD_H, SSD_P, SSD_N, M_LAYERS, M_MAX_LEN = 64, 64, 128, 48, 512
SSD_BF16_TOL, SSD_F32_TOL = 5e-2, 1e-3
ZAMBA_SSD = (80, 64)  # zamba2-2.7b's SSD heads and N (P 64 as mamba2's)
# zamba2-2.7b's engine max_len; the page-pressure pools of phase 13's and
# phase 14's traces (each preempts twice); the f32 parity depth: 4 of the
# 9 groups of attn_every 6, the deepest of 54/36/24 at which the plain
# engine's f32 and f64 greedy streams agreed on the H100 (at 54 and 36 f32
# rounding alone flips an argmax)
Z_MAX_LEN, Z_TIGHT_PAGES, Z_PARITY_TIGHT_PAGES = 512, 48, 32
Z_PARITY_LAYERS = 24
# the kernels of the hybrid engine's path (no fused mixed step)
HYBRID_KERNELS = ("paged_attention_bkgd", "paged_prefill_attention_ckgd",
                  "ssd_scan_bshp", "ssd_decode_step_bh")
# (kv heads, group, head_dim, page) of the paged int8 / head-dim checks:
# smollm-360m, llama3-8b (32 / 8 heads, D 128) and zamba2-2.7b (D 80)
PAGED_WIDTHS = {"smollm D64": (KVH, G, D, PAGE),
                "llama3 D128": (8, 4, 128, 8), "zamba2 D80": (32, 1, 80, 16),
                "dbrx D128": (8, 6, 128, PAGE)}
MAIN_WIDTH = "smollm D64"  # the widths the engine phases run
TIER_PAGES, TIER_HOST_PAGES = 128, 64
# the 4-slot tier parity pool: reclaims and spills, preempts nothing
TIER_PARITY_PAGES = 80
# device kernel names the trace windows count as paged / flash attention
PAGED_TRACE_KEYS = ("paged_decode_split_kernel", "paged_decode_merge_kernel",
                    "paged_prefill_mma_kernel", "paged_prefill_f32_kernel")
# (the kernels a bf16 window must show, the CUDA-core templates it must
# not)
PAGED_BF16_CHECK = (("paged_decode_split_kernel",),
                    ("paged_prefill_f32_kernel",))
SSD_TRACE_KEYS = ("ssd_scan_mma_kernel", "ssd_scan_kernel",
                  "ssd_decode_kernel")
SSD_BF16_CHECK = (("ssd_scan_mma_kernel",), ("ssd_scan_kernel",))
# (the kernels a bf16 zamba2 window must show, the CUDA-core templates it
# must not)
ZAMBA_BF16_CHECK = (("paged_decode_split_kernel", "paged_prefill_mma_kernel",
                     "ssd_scan_mma_kernel", "ssd_decode_kernel"),
                    ("ssd_scan_kernel", "paged_prefill_f32_kernel"))
FLASH_TRACE_KEYS = ("flash_attention_kernel", "flash_attention_mma_kernel")
FLASH_BWD_TRACE_KEYS = ("flash_bwd_",)
# cuBLAS GEMM kernels, by name (the H100's are "nvjet_*" and "*gemm*")
GEMM_TRACE_KEYS = ("nvjet", "gemm", "gemv")
# smollm-360m's whole-prompt paths: q heads, the engines' shapes
FLASH_H, LOCK_BATCH, LOCK_MAX_LEN, WHOLE_MAX_LEN = KVH * G, 8, 512, 1024
# (q heads, kv heads, head_dim) of the flash checks and timings: smollm-360m
# (the engines' widths), llama3-8b, zamba2-2.7b, and dbrx-132b and
# internvl2-26b (a group of 6)
FLASH_WIDTHS = {"smollm D64": (FLASH_H, KVH, D), "llama3 D128": (32, 8, 128),
                "zamba2 D80": (32, 32, 80), "dbrx D128": (48, 8, 128)}
# phase 28: (B, Sq, Skv, H, KVH, D, causal) of the flash gradient checks,
# every kind of call the trainers make: smollm's training shape, zamba2's
# D 80, llama3's D 128, dbrx's and internvl2's group of 6, whisper-tiny's
# encoder (not causal) and cross attention (Sq != Skv), and a causal
# length that ``models/attention.py::causal_flash`` pads to a multiple of
# 256 (FLASH_GRAD_REAL: the real length, padded to Sq inside the model);
# and the backward kernels' ragged edges: Skv not a multiple of their
# 128-key blocks, and Sq < Skv with Sq not a multiple of 64
FLASH_GRAD_SHAPES = {
    "train D 64": (16, 64, 64, FLASH_H, KVH, D, True),
    "D 80": (2, 256, 256, 32, 32, 80, True),
    "D 128": (2, 256, 256, 32, 8, 128, True),
    "group 6 D 128": (2, 256, 256, 48, 8, 128, True),
    "whisper encoder": (16, 64, 64, 6, 6, 64, False),
    "whisper cross": (4, 37, 300, 6, 6, 64, False),
    "causal_flash 300 -> 512": (1, 512, 512, FLASH_H, KVH, D, True),
    "Skv 200": (2, 200, 200, FLASH_H, KVH, D, True),
    "Sq 45 over 320": (2, 45, 320, FLASH_H, KVH, D, True),
}
FLASH_GRAD_REAL = {"causal_flash 300 -> 512": 300}
# phases 33-35: dbrx-132b serves at MOE_LAYERS of its 40 layers (28.5 GB in
# bf16; the whole model is 263 GB); internvl2-26b serves whole (48 layers,
# 39.7 GB) on the paged engine and at VLM_LOCK_LAYERS on the lockstep
# engine (the script's time limit); phase 36 trains both as TRAIN_RUNS
# gives. Their engines' max_len: dbrx's prompts of up to 400 tokens +
# MV_NEW; internvl2's 256 vision positions + a 512-token bucket.
# MV_REQUESTS requests a run, MV_TRACE_STEPS decode steps a profiler window
MOE_LAYERS, VLM_LOCK_LAYERS = 4, 24
# phase 38: the dry run's cells held against the card, (arch, shape,
# batch): full width on a (data 1, model 1) mesh, the batch cut to one
# card; the memory check's tolerance and the timed steps
DRYRUN_CELLS = (("smollm-360m", "train_4k", 4), ("llama3-8b", "decode_32k", 8),
                ("mamba2-1.3b", "prefill_32k", 1))
DRYRUN_MEM_TOL, DRYRUN_STEPS = 0.10, 3
MOE_MAX_LEN, VLM_MAX_LEN = 448, 768
MV_REQUESTS, MV_NEW, MV_TRACE_STEPS = 8, 24, 8


def log(msg: str) -> None:
    print(msg, flush=True)


def serve_cli(*argv) -> str:
    """``python -m repro_torch.launch.serve *argv``, as a user runs it, but
    in this process (a new interpreter would pay the import and the
    card's start-up again, ~8 s a run). Returns its standard output;
    raises what it raises."""
    import contextlib
    import io

    from repro_torch.launch import serve

    out, saved = io.StringIO(), sys.argv
    sys.argv = ["repro_torch.launch.serve", *argv]
    try:
        with contextlib.redirect_stdout(out):
            rc = serve.main()
    finally:
        sys.argv = saved
    if rc != 0:
        raise AssertionError(f"serve {' '.join(argv)} returned {rc}: "
                             f"{out.getvalue()[-2000:]}")
    gc.collect()
    return out.getvalue()


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def _pools(torch, n_pages, dtype, layers=1, seed=0, width=None):
    kvh, _, d, page = width or PAGED_WIDTHS[MAIN_WIDTH]
    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = (layers, n_pages, page, kvh, d)
    k = torch.randn(shape, generator=g, device="cuda").to(dtype)
    v = torch.randn(shape, generator=g, device="cuda").to(dtype)
    return k, v


def _tables(torch, rows, mp, n_pages, seed):
    """Rows of distinct physical pages in shuffled order (never the null
    page 0)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.stack([torch.randperm(n_pages - 1, generator=g,
                                       device="cuda")[:mp] + 1
                        for _ in range(rows)]).int().contiguous()


def check_kernels(torch, ops, ref, wname, quant):
    """Run every paged kernel against its plain version at one of
    PAGED_WIDTHS, over a pool of q's dtype or (``quant``) an int8 pool with
    f32 scales, at the main path's shapes: tables of MAX_LEN / page
    entries over 400 pages, decode lengths up to 631, and chunks from
    position 0, straddling a page and all padding. Returns max abs error
    per kernel over the bf16 cases (the mixed one over the hinted and the
    generic call) and logs the f32 ones."""
    kvh, group, d, page = PAGED_WIDTHS[wname]
    mp, n_pages = -(-MAX_LEN // page), 400
    pool_kind = "int8" if quant else "pool"
    errs = {}

    def compare(name, got, want, dead, tol, label):
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        if not err <= tol:
            raise AssertionError(f"{name} [{label}]: max abs err {err} > {tol}")
        if dead is not None and dead.any() and not (got[dead] == 0).all():
            raise AssertionError(f"{name} [{label}]: dead rows not exact 0")
        return err

    kf, vf = _pools(torch, n_pages, torch.float32, seed=1,
                    width=PAGED_WIDTHS[wname])
    kf, vf = kf[0], vf[0]
    if quant:
        (kq, ks), (vq, vs) = ref.quantize_kv(kf), ref.quantize_kv(vf)
        sc = dict(k_scale=ks, v_scale=vs)
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
        label = (f"{str(dtype).removeprefix('torch.')} {pool_kind} {wname}")
        if quant:
            kp, vp = kq, vq
        else:
            kp, vp, sc = kf.to(dtype), vf.to(dtype), {}
        g = torch.Generator(device="cuda").manual_seed(2)
        # decode: idle slot, 1, page-1, page, page+1, partial pages
        lengths = torch.tensor([0, 1, page - 1, page, page + 1, 2 * page + 1,
                                250, 631], dtype=torch.int32, device="cuda")
        tables = _tables(torch, SLOTS, mp, n_pages, seed=3)
        q = torch.randn(SLOTS, kvh * group, d, generator=g,
                        device="cuda").to(dtype)
        e_dec = compare(
            "paged_attention_bkgd",
            ops.paged_attention(q, kp, vp, tables, lengths, **sc),
            ops.paged_attention(q, kp, vp, tables, lengths, impl="ref", **sc),
            lengths == 0, tol, label)
        # prefill: a chunk straddling a page with valid < C, a full chunk
        # from position 0, and an all-padding chunk
        qc = torch.randn(CHUNK, kvh * group, d, generator=g,
                         device="cuda").to(dtype)
        e_pre = 0.0
        for start, valid in ((23, 41), (0, CHUNK), (300, 0)):
            st = torch.tensor(start, dtype=torch.int32, device="cuda")
            va = torch.tensor(valid, dtype=torch.int32, device="cuda")
            dead = torch.arange(CHUNK, device="cuda") >= valid
            e_pre = max(e_pre, compare(
                "paged_prefill_attention_ckgd",
                ops.paged_prefill_attention(qc, kp, vp, tables[5], st, va,
                                            **sc),
                ops.paged_prefill_attention(qc, kp, vp, tables[5], st, va,
                                            impl="ref", **sc),
                dead, tol, f"{label} start={start} valid={valid}"))
        # mixed: decode rows (one idle) + a chunk straddling a page with a
        # dead suffix, every row its own table row; with the engine's hint
        # (the chunk's rows share table row 5) and without it
        cpos = torch.arange(CHUNK, dtype=torch.int32, device="cuda")
        last_pos = torch.cat([lengths - 1,
                              torch.where(cpos < 41, 23 + cpos, -1)])
        mtables = torch.cat([tables, tables[5:6].expand(CHUNK, mp)])
        mtables = mtables.contiguous()
        qm = torch.cat([q, qc])
        want = ops.paged_mixed_attention(qm, kp, vp, mtables, last_pos,
                                         impl="ref", **sc)
        e_mix = max(compare(
            "paged_mixed_attention_rkgd",
            ops.paged_mixed_attention(qm, kp, vp, mtables, last_pos,
                                      num_decode=hint, **sc),
            want, last_pos < 0, tol, f"{label} num_decode={hint}")
            for hint in (SLOTS, None))
        log(f"kernel check {label} (KVH {kvh}, G {group}, D {d}, page {page},"
            f" {mp}-entry tables): decode {e_dec:.3e}, prefill {e_pre:.3e}, "
            f"mixed {e_mix:.3e} (bound {tol})")
        if dtype == torch.bfloat16:
            errs = {"paged_attention_bkgd": e_dec,
                    "paged_prefill_attention_ckgd": e_pre,
                    "paged_mixed_attention_rkgd": e_mix}
    return errs


def _time_ms(torch, fn, iters=64, warmup=8):
    """Device time per call: CUDA events around ``iters`` calls, enqueued
    while the stream is held by a sleep kernel, so the calls run back to
    back and the host's Python and launch overhead (tens of microseconds
    per call, more than some kernels take) stays out of the measurement."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    t0.record()
    for i in range(iters):
        fn(i)
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def _bound(n_positions, rows_attended, q_rows, tables_elems, scalars, elt,
           quant=False, width=None):
    """Least time for the function at one of PAGED_WIDTHS (the main one by
    default): every K/V position it must read (each (page, offset) once,
    all kv heads; int8 pages: one byte per element plus a 4-byte f32 scale
    per (position, kv head)), q in, out back, its int32 tables and
    positions; against the operations of QK^T and PV over the attended
    positions. Returns (ms, 'bytes' | 'operations')."""
    kvh, group, d, _ = width or PAGED_WIDTHS[MAIN_WIDTH]
    kv_bytes = 2 * n_positions * kvh * (d + 4 if quant else d * elt)
    qo_bytes = 2 * q_rows * kvh * group * d * elt
    nbytes = kv_bytes + qo_bytes + 4 * (tables_elems + scalars)
    flops = 4 * d * kvh * group * rows_attended
    rate = BF16_FLOP_PER_S if elt == 2 else F32_FLOP_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_kernels(torch, F, ops, ref, quant=False, wname=MAIN_WIDTH):
    """kernel / plain / library times (ms) and the bound, at the shapes of
    one full-width engine step at one of PAGED_WIDTHS, cycling through 32
    layers' pools so each launch finds its pages outside L2 as in a real
    step. ``quant``: int8 pools with f32 scales (the plain version
    dequantizes them, SDPA reads K/V dequantized to bf16 and gathered in
    advance)."""
    width = PAGED_WIDTHS[wname]
    kvh, group, d, page = width
    mp = -(-MAX_LEN // page)
    n_pages = SLOTS * mp + 1
    dt = torch.bfloat16
    kp, vp = _pools(torch, n_pages, dt, layers=LAYERS, seed=5, width=width)
    sc = [{}] * LAYERS
    if quant:
        (kq, ks), (vq, vs) = ref.quantize_kv(kp), ref.quantize_kv(vp)
        sc = [dict(k_scale=ks[i], v_scale=vs[i]) for i in range(LAYERS)]
        kp = ref.dequantize_pages(kq, ks).to(dt)  # what SDPA reads
        vp = ref.dequantize_pages(vq, vs).to(dt)
    g = torch.Generator(device="cuda").manual_seed(6)
    lengths = torch.randint(100, 632, (SLOTS,), generator=g, device="cuda",
                            dtype=torch.int32)
    tables = _tables(torch, SLOTS, mp, n_pages, seed=7)
    q = torch.randn(SLOTS, kvh * group, d, generator=g, device="cuda").to(dt)
    qc = torch.randn(CHUNK, kvh * group, d, generator=g,
                     device="cuda").to(dt)
    start = torch.tensor(256, dtype=torch.int32, device="cuda")
    valid = torch.tensor(CHUNK, dtype=torch.int32, device="cuda")
    cpos = torch.arange(CHUNK, dtype=torch.int32, device="cuda")
    last_pos = torch.cat([lengths - 1, 256 + cpos])
    mtables = torch.cat([tables, tables[0:1].expand(CHUNK, mp)]).contiguous()
    qm = torch.cat([q, qc])
    scale = d ** -0.5

    def layer(i):
        if quant:
            return kq[i % LAYERS], vq[i % LAYERS]
        return kp[i % LAYERS], vp[i % LAYERS]

    def dense(tbl, n):
        """Gathered dense K/V for SDPA: (rows, H, n, D) over the q heads."""
        def gather(pool):
            x = pool[tbl.long()].reshape(tbl.shape[0], -1, kvh, d)[:, :n]
            return x.permute(0, 2, 1, 3).repeat_interleave(group, dim=1)
        return [(gather(kp[i]), gather(vp[i])) for i in range(LAYERS)]

    def decode_row():
        lens = lengths.tolist()
        n_max = max(lens)
        dec_dense = dense(tables, n_max)
        dec_mask = (torch.arange(n_max, device="cuda")[None, :]
                    < lengths[:, None])[:, None, None, :]
        return dict(
            kernel=lambda i: ops.paged_attention(
                q, *layer(i), tables, lengths, scale=scale,
                **sc[i % LAYERS]),
            plain=lambda i: ops.paged_attention(
                q, *layer(i), tables, lengths, scale=scale, impl="ref",
                **sc[i % LAYERS]),
            library=lambda i: F.scaled_dot_product_attention(
                q[:, :, None], *dec_dense[i % LAYERS],
                attn_mask=dec_mask),
            bound=_bound(sum(lens), sum(lens), SLOTS, SLOTS * mp, SLOTS, 2,
                         quant, width))

    def prefill_row():
        pre_dense = dense(tables[0:1], 256 + CHUNK)
        kpos = torch.arange(256 + CHUNK, device="cuda")
        pre_mask = (kpos[None, :] <= 256 + cpos[:, None])[None, None]
        return dict(
            kernel=lambda i: ops.paged_prefill_attention(
                qc, *layer(i), tables[0], start, valid, scale=scale,
                **sc[i % LAYERS]),
            plain=lambda i: ops.paged_prefill_attention(
                qc, *layer(i), tables[0], start, valid, scale=scale,
                impl="ref", **sc[i % LAYERS]),
            library=lambda i: F.scaled_dot_product_attention(
                qc.transpose(0, 1)[None], *pre_dense[i % LAYERS],
                attn_mask=pre_mask),
            bound=_bound(256 + CHUNK, sum(257 + c for c in range(CHUNK)),
                         CHUNK, mp, 2, 2, quant, width))

    def mixed_row():
        lens = lengths.tolist()
        mix_n = max(max(lens), 256 + CHUNK)
        mix_dense = dense(mtables, mix_n)
        mix_mask = (torch.arange(mix_n, device="cuda")[None, :]
                    <= last_pos[:, None])[:, None, None, :]
        # as the engine calls it: with the hint (kernel and plain)
        return dict(
            kernel=lambda i: ops.paged_mixed_attention(
                qm, *layer(i), mtables, last_pos, scale=scale,
                num_decode=SLOTS, **sc[i % LAYERS]),
            generic=lambda i: ops.paged_mixed_attention(
                qm, *layer(i), mtables, last_pos, scale=scale,
                **sc[i % LAYERS]),
            plain=lambda i: ops.paged_mixed_attention(
                qm, *layer(i), mtables, last_pos, scale=scale, impl="ref",
                num_decode=SLOTS, **sc[i % LAYERS]),
            library=lambda i: F.scaled_dot_product_attention(
                qm[:, :, None], *mix_dense[i % LAYERS],
                attn_mask=mix_mask),
            # the chunk shares slot 0's table: its positions are slot 0's
            bound=_bound(sum(lens) + max(0, 256 + CHUNK - lens[0]),
                         sum(lens) + sum(257 + c for c in range(CHUNK)),
                         SLOTS + CHUNK, (SLOTS + CHUNK) * mp, SLOTS + CHUNK,
                         2, quant, width))

    makers = {"paged_attention_bkgd": decode_row,
              "paged_prefill_attention_ckgd": prefill_row,
              "paged_mixed_attention_rkgd": mixed_row}
    out = {}
    for name, make in makers.items():
        r = make()  # its gathered K/V for SDPA live for one row
        # plain, kernel, kernel, plain: compare within one call, in turns
        p1 = _time_ms(torch, r["plain"])
        k1 = _time_ms(torch, r["kernel"])
        k2 = _time_ms(torch, r["kernel"])
        p2 = _time_ms(torch, r["plain"])
        lib = _time_ms(torch, r["library"])
        out[name] = dict(ms=min(k1, k2), plain_ms=min(p1, p2),
                         library_ms=lib, bound_ms=r["bound"][0],
                         bound_by=r["bound"][1])
        extra = ""
        if "generic" in r:  # the mixed kernel without the hint
            g1, g2 = (_time_ms(torch, r["generic"]) for _ in range(2))
            out[name]["generic_ms"] = min(g1, g2)
            extra = f" (hinted; without the hint {g1:.4f}/{g2:.4f} ms)"
        log(f"timing {name}{' int8' if quant else ''} [{wname}: KVH {kvh}, "
            f"G {group}, D {d}, page {page}]: kernel {k1:.4f}/{k2:.4f} ms"
            f"{extra}, plain {p1:.4f}/{p2:.4f} ms, sdpa {lib:.4f} ms, bound "
            f"{r['bound'][0]:.5f} ms ({r['bound'][1]})")
        del r
    return out


# ---------------------------------------------------------------------------
# phase 10: the SSD kernels against their plain versions
# ---------------------------------------------------------------------------


def _ssd_inputs(torch, g, b, s, dtype, layers=None, h=SSD_H, n=SSD_N):
    """The JAX package's SSD test distribution (tests/test_kernels.py) at
    mamba2 widths (or ``h`` heads of N ``n``): x ~ N(0, 1), dt in [0.1, 1),
    A in (-1.1, -0.1], B/C ~ N(0, 1/N); with ``layers``, a leading layer
    axis on all but A."""
    pre = (layers,) if layers else ()
    x = torch.randn(pre + (b, s, h, SSD_P), generator=g,
                    device="cuda").to(dtype)
    dt = 0.1 + 0.9 * torch.rand(pre + (b, s, h), generator=g, device="cuda")
    A = -torch.rand(h, generator=g, device="cuda") - 0.1
    bc = [(torch.randn(pre + (b, s, n), generator=g, device="cuda")
           / n ** 0.5).to(dtype) for _ in range(2)]
    return x, dt, A, bc[0], bc[1]


def check_ssd_kernels(torch, ops, sk, engine_scans):
    """Both SSD kernels against their plain versions, at mamba2-1.3b's and
    zamba2-2.7b's SSD widths; ``engine_scans`` adds each (B, S, H, N)
    whole-prompt scan from a zero state that the lockstep phases ran.
    Returns the max abs error per kernel over the bf16 cases and logs the
    f32 ones. Every bf16 scan must take the tensor-core kernel, every f32
    one the CUDA-core template (``LAUNCHES_BY_PATH``)."""
    errs = {}
    widths = ((SSD_H, SSD_N), ZAMBA_SSD)

    def compare(name, got, want, tol, label):
        torch.cuda.synchronize()
        got, want = got.float(), want.float()
        err = (got - want).abs().max().item()
        bad = ((got - want).abs() > tol + tol * want.abs()).sum().item()
        if bad or not err == err:
            raise AssertionError(f"{name} [{label}]: {bad} elements outside "
                                 f"atol=rtol={tol} (max abs err {err})")
        return err

    # (B, S, valid, init, H, N): at both widths the engine's chunk (a
    # dt = 0 tail, or full) from a state; S 200 from zero; a whole
    # 512-token prompt; the lockstep phases' prompts
    cases = [(1, CHUNK, valid, True, h, n) for h, n in widths
             for valid in (41, CHUNK)]
    cases += [(2, 200, 200, False, SSD_H, SSD_N),
              (1, 512, 512, False, SSD_H, SSD_N),
              (2, 200, 200, False, *ZAMBA_SSD)]
    cases += [(b, s, s, False, h, n) for b, s, h, n in engine_scans]
    n_scans = len(cases) + 7 * len(widths)
    for dtype, tol in ((torch.bfloat16, SSD_BF16_TOL),
                       (torch.float32, SSD_F32_TOL)):
        label = str(dtype).removeprefix("torch.")
        g = torch.Generator(device="cuda").manual_seed(11)
        e_scan = 0.0
        sk.reset_launches()
        for b, s, valid, with_init, h, n in cases:
            x, dt, A, Bm, Cm = _ssd_inputs(torch, g, b, s, dtype, h=h, n=n)
            dt[:, valid:] = 0.0
            init = (torch.randn(b, h, SSD_P, n, generator=g, device="cuda")
                    if with_init else None)
            y, fs = ops.ssd_scan(x, dt, A, Bm, Cm, init_state=init)
            yr, fsr = ops.ssd_scan(x, dt, A, Bm, Cm, init_state=init,
                                   impl="ref")
            case = (f"{label} B={b} S={s} valid={valid} init={with_init} "
                    f"H={h} N={n}")
            e_scan = max(e_scan,
                         compare("ssd_scan_bshp y", y, yr, tol, case),
                         compare("ssd_scan_bshp state", fs, fsr, tol, case))
        # the engines' pattern: 7 chained 64-token calls carrying the
        # state against one plain call over the 448 tokens
        for h, n in widths:
            x, dt, A, Bm, Cm = _ssd_inputs(torch, g, 1, 7 * CHUNK, dtype,
                                           h=h, n=n)
            init = torch.randn(1, h, SSD_P, n, generator=g, device="cuda")
            yr, fsr = ops.ssd_scan(x, dt, A, Bm, Cm, init_state=init,
                                   impl="ref")
            fs, ys = init, []
            for k in range(7):
                sl = slice(k * CHUNK, (k + 1) * CHUNK)
                y, fs = ops.ssd_scan(x[:, sl], dt[:, sl], A, Bm[:, sl],
                                     Cm[:, sl], init_state=fs, chunk=CHUNK)
                ys.append(y)
            case = f"{label} 7 chained chunks H={h} N={n}"
            e_scan = max(e_scan,
                         compare("ssd_scan_bshp y", torch.cat(ys, 1), yr,
                                 tol, case),
                         compare("ssd_scan_bshp state", fs, fsr, tol, case))
        paths = dict(sk.LAUNCHES_BY_PATH)
        want = "mma" if dtype == torch.bfloat16 else "cuda_core"
        if paths[want] != n_scans or sum(paths.values()) != n_scans:
            raise AssertionError(f"{label} scans took {paths}, expected all "
                                 f"{n_scans} through {want}")
        # the decode step at the engines' SLOTS rows: gated by an active
        # vector with idle rows (the SSM engine), and ungated (lockstep)
        e_dec = 0.0
        for h, n in widths:
            x, dt, A, Bm, Cm = _ssd_inputs(torch, g, SLOTS, 1, dtype, h=h,
                                           n=n)
            step = (x[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0])
            for active in (torch.tensor([1, 0, 1, 1, 0, 1, 0, 1],
                                        dtype=torch.int32, device="cuda"),
                           None):
                state = torch.randn(SLOTS, h, SSD_P, n, generator=g,
                                    device="cuda")
                yr, sr = ops.ssd_decode_step(state.clone(), *step,
                                             active=active, impl="ref")
                old = state.clone()
                y, s_out = ops.ssd_decode_step(state, *step, active=active)
                case = f"{label} H={h} N={n} active={active is not None}"
                if s_out.data_ptr() != state.data_ptr():
                    raise AssertionError(f"ssd_decode_step_bh [{case}]: made "
                                         f"a copy of the state instead of "
                                         f"advancing it in place")
                if active is not None:
                    idle = active == 0
                    if not torch.equal(state[idle], old[idle]):
                        raise AssertionError(f"ssd_decode_step_bh [{case}]: "
                                             f"an idle slot's state changed")
                e_dec = max(e_dec,
                            compare("ssd_decode_step_bh y", y, yr, tol, case),
                            compare("ssd_decode_step_bh state", state, sr,
                                    tol, case))
        log(f"ssd kernel check {label}: {n_scans} scans (H/N {widths}; "
            f"lockstep (B, S, H, N) {engine_scans}) {e_scan:.3e} (paths "
            f"{paths}), decode at {SLOTS} slots, gated and not, "
            f"{e_dec:.3e} (atol=rtol={tol}); idle slots untouched")
        if dtype == torch.bfloat16:
            errs = {"ssd_scan_bshp": e_scan, "ssd_decode_step_bh": e_dec}
    return errs


def _ssd_bound(b, s, elt, decode, written=None, h=SSD_H, n=SSD_N,
               read_state=True):
    """Least time for one SSD call at mamba2 widths (or ``h`` heads of N
    ``n``): the bytes it must move (inputs read once, outputs written once;
    the f32 state read for all b rows and written for the ``written`` rows,
    all b unless given: the in-place decode step writes only its active
    slots; a scan without an entering state reads none) against its
    operations at the inputs' type's peak. The scan counts the chunked
    algorithm at the kernel's 64-token chunk: causal C B^T, the decay mask,
    the causal (scores)(x dt), C state and the state update.
    Returns (ms, 'bytes' | 'operations')."""
    p = SSD_P
    written = b if written is None else written
    if decode:
        state_bytes = (b + written) * h * p * n * 4
        nbytes = (state_bytes + 2 * b * h * p * elt + b * h * 4 + h * 4
                  + 2 * b * n * elt + b * 4)
        flops = 5 * b * h * p * n + b * h * p
    else:
        state_bytes = (written + (b if read_state else 0)) * h * p * n * 4
        nbytes = (state_bytes + 2 * b * s * h * p * elt + b * s * h * 4
                  + h * 4 + 2 * b * s * n * elt)
        q = min(64, s)
        pairs = q * (q + 1) // 2
        per_chunk = (2 * pairs * n + h * pairs + 2 * h * p * pairs
                     + 4 * h * q * p * n + h * p * n)
        flops = b * (-(-s // q)) * per_chunk
    rate = BF16_FLOP_PER_S if elt == 2 else F32_FLOP_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_ssd_kernels(torch, ops, sk):
    """kernel / plain times (ms) and the bound at the shapes of one
    full-width mamba2 engine step (bf16): decode over 8 slots (2 idle, so
    the bound counts 6 slots' state written back) in place, and one
    64-token prefill chunk of one sequence from a carried state, each
    cycling through 48 layers' states so every launch finds its state
    outside L2, as in a real step. Then the scan alone at a whole
    512-token prompt from zero (B 1) and at zamba2-2.7b's SSD widths (H 80,
    N 64; the engine's chunk from a state), kernel calls only: no engine
    takes those yet. No single PyTorch call computes either function:
    library_ms is null. Logs the scan's LAUNCHES_BY_PATH over the timed
    calls."""
    g = torch.Generator(device="cuda").manual_seed(12)
    dt_ = torch.bfloat16
    bank = torch.randn(M_LAYERS, SLOTS, SSD_H, SSD_P, SSD_N, generator=g,
                       device="cuda")
    dx, ddt, A, dB, dC = _ssd_inputs(torch, g, SLOTS, 1, dt_, M_LAYERS)
    active = torch.tensor([1, 1, 1, 0, 1, 1, 0, 1], dtype=torch.int32,
                          device="cuda")

    def decode(impl):
        def fn(i):
            l = i % M_LAYERS
            ops.ssd_decode_step(bank[l], dx[l, :, 0], ddt[l, :, 0], A,
                                dB[l, :, 0], dC[l, :, 0], active=active,
                                impl=impl)
        return fn

    def scan_inputs(s, with_init, h=SSD_H, n=SSD_N):
        sx, sdt, sA, sB, sC = _ssd_inputs(torch, g, 1, s, dt_, M_LAYERS,
                                          h=h, n=n)
        init = (torch.randn(M_LAYERS, 1, h, SSD_P, n, generator=g,
                            device="cuda") if with_init else None)

        def scan(impl):
            def fn(i):
                l = i % M_LAYERS
                ops.ssd_scan(sx[l], sdt[l], sA, sB[l], sC[l],
                             init_state=None if init is None else init[l],
                             impl=impl)
            return fn
        return scan

    n_active = int(active.sum().item())
    rows = {"ssd_decode_step_bh": (decode, _ssd_bound(SLOTS, 1, 2, True,
                                                       n_active)),
            "ssd_scan_bshp": (scan_inputs(CHUNK, True),
                              _ssd_bound(1, CHUNK, 2, False))}
    out = {}
    sk.reset_launches()
    for name, (make, bound) in rows.items():
        p1 = _time_ms(torch, make("ref"), iters=96)
        k1 = _time_ms(torch, make("auto"), iters=96)
        k2 = _time_ms(torch, make("auto"), iters=96)
        p2 = _time_ms(torch, make("ref"), iters=96)
        out[name] = dict(ms=min(k1, k2), plain_ms=min(p1, p2),
                         library_ms=None, bound_ms=bound[0],
                         bound_by=bound[1])
        log(f"timing {name}: kernel {k1:.4f}/{k2:.4f} ms, plain "
            f"{p1:.4f}/{p2:.4f} ms, no library call, bound "
            f"{bound[0]:.5f} ms ({bound[1]})")
    del bank
    for label, make, bound in (
            ("S 512 from zero", scan_inputs(512, False),
             _ssd_bound(1, 512, 2, False, written=1, read_state=False)),
            ("zamba2 H 80 N 64", scan_inputs(CHUNK, True, *ZAMBA_SSD),
             _ssd_bound(1, CHUNK, 2, False, h=ZAMBA_SSD[0],
                        n=ZAMBA_SSD[1]))):
        k1 = _time_ms(torch, make("auto"), iters=48)
        p1 = _time_ms(torch, make("ref"), iters=48)
        k2 = _time_ms(torch, make("auto"), iters=48)
        log(f"timing ssd_scan_bshp [{label}]: kernel {k1:.4f}/{k2:.4f} ms, "
            f"plain {p1:.4f} ms, bound {bound[0]:.5f} ms ({bound[1]})")
    log(f"timing ssd_scan_bshp paths: {dict(sk.LAUNCHES_BY_PATH)}")
    return out


# ---------------------------------------------------------------------------
# phases 4-5: the engine
# ---------------------------------------------------------------------------


def _requests(serving, n, rng, sampled_every):
    shared = rng.integers(1, 49152, 128).tolist()
    reqs = []
    for i in range(n):
        plen = int(rng.integers(100, 601))
        if i % 2 == 0:
            prompt = shared + rng.integers(1, 49152, plen - 128).tolist()
        else:
            prompt = rng.integers(1, 49152, plen).tolist()
        sp = (serving.SamplingParams(temperature=0.8, top_p=0.9,
                                     max_new_tokens=32, seed=1000 + i)
              if sampled_every and i % sampled_every == 1 else
              serving.SamplingParams(max_new_tokens=32, seed=1000 + i))
        reqs.append(serving.Request(f"r{i}", prompt, sampling=sp))
    return reqs


def _drive(torch, engine, reqs):
    handles = [engine.submit(r) for r in reqs]
    steps = 0
    while not engine.idle:
        engine.step()
        steps += 1
    torch.cuda.synchronize()
    return handles, steps


def _random_requests(serving, n, rng, sampled_every, *, lo, hi, max_new,
                     uid, vocab, seed0):
    """n requests of random prompts of lo..hi tokens, max_new new tokens
    each; every ``sampled_every``-th one (from the second) seeded top-p,
    the rest greedy."""
    reqs = []
    for i in range(n):
        prompt = rng.integers(1, vocab, int(rng.integers(lo, hi + 1)))
        sp = (serving.SamplingParams(temperature=0.8, top_p=0.9,
                                     max_new_tokens=max_new, seed=seed0 + i)
              if sampled_every and i % sampled_every == 1 else
              serving.SamplingParams(max_new_tokens=max_new, seed=seed0 + i))
        reqs.append(serving.Request(f"{uid}{i}", prompt.tolist(),
                                    sampling=sp))
    return reqs


def _check_served(np, cfg, results, max_new):
    bad = [(r.uid, r.finish_reason.value) for r in results
           if r.finish_reason.value != "length" or len(r.tokens) != max_new]
    if bad:
        raise AssertionError(f"requests not finished by length: {bad}")
    for r in results:
        toks = np.asarray(r.tokens)
        if not ((toks >= 0) & (toks < cfg.vocab_size)).all():
            raise AssertionError(f"{r.uid}: token out of vocab")


def _log_run(name, cfg, card, reqs, results, wall, steps, extra):
    from repro_torch.serving.metrics import latency_percentiles

    lat = latency_percentiles(results)
    n_tok = sum(len(r.tokens) for r in results)
    log(f"{name} {cfg.name} bf16 on {card}: {len(results)}/{len(reqs)} "
        f"requests ({sum(len(r.prompt) for r in reqs)} prompt tokens), "
        f"{n_tok} tokens in {wall:.3f} s = {n_tok / wall:.1f} tok/s;"
        f" TTFT p50 {lat['ttft_ms'][0]:.1f} ms p99 {lat['ttft_ms'][2]:.1f} ms;"
        f" ITL p50 {lat['itl_ms'][0]:.2f} ms p99 {lat['itl_ms'][2]:.2f} ms")
    log(f"{name} steps {steps}: {extra}")


def run_engine(torch, np, cfg, serving, models, pk, card):
    params = models.build_model(cfg, device="cuda").init(seed=0)
    engine_kw = dict(max_len=MAX_LEN, max_slots=SLOTS, page_size=PAGE,
                     prefill_chunk=CHUNK, device="cuda")
    engine = serving.ContinuousBatchingEngine(cfg, params, **engine_kw)
    rng = np.random.default_rng(0)
    # warm-up (cuBLAS handles, allocator, first launches): not measured
    _drive(torch, engine, _requests(serving, 2, rng, sampled_every=2))
    engine = serving.ContinuousBatchingEngine(cfg, params, **engine_kw)
    reqs = _requests(serving, 16, rng, sampled_every=2)
    pk.reset_launches()
    t0 = time.perf_counter()
    handles, steps = _drive(torch, engine, reqs)
    wall = time.perf_counter() - t0
    launches = dict(pk.LAUNCHES)
    results = [h.result() for h in handles]
    _check_served(np, cfg, results, 32)
    hits = engine.cache.stats["prefix_hits"]
    if hits <= 0:
        raise AssertionError("no prefix hits on the shared-prefix requests")
    if not all(launches[k] > 0 for k in launches):
        raise AssertionError(f"a route never ran its kernel: {launches}")
    st = engine.stats
    _log_run("engine", cfg, card, reqs, results, wall, steps,
             f"decode_steps {st['decode_steps']}, prefill_chunks "
             f"{st['prefill_chunks']}, preemptions {st['preemptions']}, "
             f"prefix hits {hits} "
             f"({engine.cache.stats['prefix_tokens_reused']} tokens "
             f"reused); kernel launches {launches} over {LAYERS} layers per "
             f"dispatch")
    log("utilization: " + engine.utilization.format())
    del engine
    _trace(torch,
           lambda: serving.ContinuousBatchingEngine(cfg, params, **engine_kw),
           _requests(serving, 8, np.random.default_rng(5), sampled_every=0),
           PAGED_TRACE_KEYS, "paged-attention kernels",
           check=PAGED_BF16_CHECK)
    return launches


def _device_times(prof):
    """{device activity name: [ms, count]} of a torch.profiler window,
    from the raw events (``key_averages()`` takes minutes over a window's
    several hundred thousand events). The windows record the device
    activities alone: the host's op events would add ~2 s of stop and
    read per 100k device ops and change no device time (PERF.md)."""
    from torch.autograd import DeviceType

    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            acc = by_name.setdefault(e.name(), [0.0, 0])
            acc[0] += e.duration_ns() / 1e6
            acc[1] += 1
    return by_name


def _trace(torch, make_engine, reqs, kernel_keys, label, check=None):
    """Where a step's time goes: a torch.profiler window over a fresh
    engine serving ``reqs``. Device busy = the sum of the device activities
    (kernels, copies, fills) the profiler recorded (one stream, so no
    overlap) over the window's wall time; the kernels' share sums the
    activities whose name holds one of ``kernel_keys``, also logged kernel
    by kernel. The raw events are read, not ``key_averages()``, which takes
    minutes over a window's several hundred thousand events.
    ``check``: (the kernels the window must show, the ones it must not),
    for a bf16 engine (PAGED_BF16_CHECK, SSD_BF16_CHECK,
    ZAMBA_BF16_CHECK)."""
    from torch.profiler import ProfilerActivity, profile

    engine = make_engine()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, steps = _drive(torch, engine, reqs)
        wall_ms = (time.perf_counter() - t0) * 1e3

    by_name = _device_times(prof)
    busy_ms = sum(ms for ms, _ in by_name.values())
    if busy_ms <= 0:
        log("trace: the profiler recorded no device time (not measured)")
        return
    kern_ms = sum(ms for name, (ms, _) in by_name.items()
                  if any(k in name for k in kernel_keys))
    for key in kernel_keys:
        hits = [(ms, n) for name, (ms, n) in by_name.items() if key in name]
        if hits:
            ms, n = sum(h[0] for h in hits), sum(h[1] for h in hits)
            log(f"trace kernel: {key} {ms:.2f} ms x{n} "
                f"({1e3 * ms / n:.2f} us each) = "
                f"{100 * ms / busy_ms:.1f}% of busy")
    if check:
        shown, barred = check
        stale = [name for name in by_name if any(b in name for b in barred)]
        missing = [k for k in shown if not any(k in name for name in by_name)]
        if stale or missing:
            raise AssertionError(f"a bf16 window ran a CUDA-core template "
                                 f"or missed {missing}: {stale}")
    top = sorted(by_name.items(), key=lambda kv: kv[1][0], reverse=True)[:6]
    log(f"trace: {steps} steps in {wall_ms:.1f} ms wall "
        f"({wall_ms / steps:.2f} ms/step); device busy {busy_ms:.1f} ms = "
        f"{100 * busy_ms / wall_ms:.1f}% (idle {100 - 100 * busy_ms / wall_ms:.1f}%);"
        f" {label} {kern_ms:.1f} ms = "
        f"{100 * kern_ms / busy_ms:.1f}% of busy; "
        f"{sum(n for _, n in by_name.values())} device ops")
    for name, (ms, n) in top:
        log(f"trace top: {ms:9.2f} ms x{n:6d}  {name[:90]}")


def _chunk_logits(torch, np, model, impl):
    """Logits of one 64-token prompt chunk into an empty pool."""
    cfg = model.cfg
    model.attn_impl = impl
    shape = (cfg.num_layers, 6, PAGE, KVH, D)  # null page, 4 pages, sink
    pages = {"k": torch.zeros(shape, device="cuda"),
             "v": torch.zeros(shape, device="cuda")}
    row = torch.tensor([1, 2, 3, 4], dtype=torch.int32, device="cuda")
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        1, cfg.vocab_size, CHUNK).astype(np.int32)).cuda()
    start = torch.tensor(0, dtype=torch.int32, device="cuda")
    valid = torch.tensor(CHUNK, dtype=torch.int32, device="cuda")
    return model.prefill_chunk(pages, row, toks, start, valid)[:cfg.vocab_size]


def run_parity(torch, np, cfg, serving, models):
    """f32 with TF32 off: the engine through the kernels vs through the
    plain versions (``attn_impl="ref"``), greedy streams identical.

    The random-weight model is chaotic in depth: a perturbation of the
    attention output at f32 rounding level (the kernels' online softmax sums
    in another order than the plain versions) grows by orders of magnitude
    per few layers, so at 32 layers the greedy argmax flips on noise while at
    2 layers it cannot. The phase prints the one-chunk logit gap at both
    depths, then asserts stream identity at PARITY_LAYERS (full width, depth
    cut)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"parity: f32, TF32 off (matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32}, cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32})")
    for layers in (LAYERS, PARITY_LAYERS):
        cfg32 = dataclasses.replace(cfg, dtype="float32", num_layers=layers)
        model = models.build_model(cfg32, device="cuda")
        model.init(seed=1)
        a = _chunk_logits(torch, np, model, "auto")
        b = _chunk_logits(torch, np, model, "ref")
        gap = (a - b).abs().max().item()
        top2 = b.topk(2).values
        log(f"parity: {layers} layers, one 64-token chunk: max |logit "
            f"kernel - plain| = {gap:.3e}, argmax {a.argmax().item()} vs "
            f"{b.argmax().item()}, plain top-2 margin "
            f"{(top2[0] - top2[1]).item():.3e}")
        if layers == PARITY_LAYERS and not gap < 1e-3:
            raise AssertionError(f"kernel vs plain logits differ by {gap}")
        del model
    cfg32 = dataclasses.replace(cfg, dtype="float32",
                                num_layers=PARITY_LAYERS)
    params = models.build_model(cfg32, device="cuda").init(seed=1)
    streams = {}
    for impl in ("auto", "ref"):
        engine = serving.ContinuousBatchingEngine(
            cfg32, params, max_len=MAX_LEN, max_slots=4, page_size=PAGE,
            prefill_chunk=CHUNK, attn_impl=impl, device="cuda")
        rng = np.random.default_rng(3)
        reqs = [serving.Request(
            f"g{i}", rng.integers(1, 49152, int(rng.integers(70, 200))).tolist(),
            sampling=serving.SamplingParams(max_new_tokens=16))
            for i in range(5)]
        handles, _ = _drive(torch, engine, reqs)
        streams[impl] = [list(h.tokens) for h in handles]
    if streams["auto"] != streams["ref"]:
        raise AssertionError(f"f32 kernel vs plain streams differ: {streams}")
    log(f"parity: {PARITY_LAYERS} layers, full width: "
        f"{len(streams['auto'])} greedy streams of 16 tokens identical "
        f"through kernels and plain versions")


# ---------------------------------------------------------------------------
# phases 18-20: int8 pages and the KV tiers in the engine
# ---------------------------------------------------------------------------


def run_int8_engine(torch, np, cfg, serving, models, pk, card):
    """Phase 4's trace through the chunked engine with int8 pages, in turns
    with bf16 pages (bf16, int8, int8, bf16: one call's host drifts, so the
    two are compared side by side), then a profiler window of each.
    Returns the paged kernels' launch counts over the first int8 run."""
    params = models.build_model(cfg, device="cuda").init(seed=0)

    def make(quant):
        return serving.ContinuousBatchingEngine(
            cfg, params, max_len=MAX_LEN, max_slots=SLOTS, page_size=PAGE,
            prefill_chunk=CHUNK, kv_quant=quant, device="cuda")

    def requests():  # phase 4's: 2 warm-up requests, then 16 measured
        rng = np.random.default_rng(0)
        return (_requests(serving, 2, rng, sampled_every=2),
                _requests(serving, 16, rng, sampled_every=2))

    for quant in ("none", "int8"):
        _drive(torch, make(quant), requests()[0])  # warm-up
    launches = None
    for turn, quant in enumerate(("none", "int8", "int8", "none")):
        engine = make(quant)
        reqs = requests()[1]
        first_int8 = quant == "int8" and launches is None
        if first_int8:
            if engine.cache.pages["k"].dtype != torch.int8:
                raise AssertionError("kv_quant='int8' built a pool of "
                                     f"{engine.cache.pages['k'].dtype}")
            pk.reset_launches()
        t0 = time.perf_counter()
        handles, steps = _drive(torch, engine, reqs)
        wall = time.perf_counter() - t0
        if first_int8:
            launches = dict(pk.LAUNCHES)
            if not all(launches[k] > 0 for k in launches):
                raise AssertionError(f"a route never ran its kernel: "
                                     f"{launches}")
        results = [h.result() for h in handles]
        _check_served(np, cfg, results, 32)
        hits = engine.cache.stats["prefix_hits"]
        if hits <= 0:
            raise AssertionError("no prefix hits on the shared-prefix requests")
        _log_run(f"int8 phase, {quant} pages, turn {turn + 1}", cfg, card,
                 reqs, results, wall, steps,
                 f"{1e3 * wall / steps:.2f} ms/step, prefill_chunks "
                 f"{engine.stats['prefill_chunks']}, prefix hits {hits}; "
                 f"pool {engine.cache.page_nbytes} B per page"
                 + (f"; kernel launches {launches}" if first_int8 else ""))
        del engine
    for quant in ("none", "int8"):
        _trace(torch, lambda quant=quant: make(quant),
               _requests(serving, 8, np.random.default_rng(5),
                         sampled_every=0),
               PAGED_TRACE_KEYS, f"paged-attention kernels "
               f"({quant} pages)", check=PAGED_BF16_CHECK)
    return launches


class _UploadLog:
    """Records (page, content key) for every page a cache uploads from the
    host or persisted tier, to hold the pages against the store later."""

    def __init__(self, cache):
        self.uploads, inner = [], cache._upload_page

        def upload(page, arrays):
            inner(page, arrays)
            self.uploads.append(page)

        cache._upload_page = upload


def _check_reloaded(torch, np, engine, store_root, keys):
    """Every reloaded page still registered under its content key holds,
    byte for byte, what the store kept under that key for each pool tensor
    in ``keys``. Returns how many pages were compared."""
    from repro_torch.core.storage import ArtifactStore

    cache, store = engine.cache, ArtifactStore(store_root)
    index = cache.tiers.persist_index
    torch.cuda.synchronize()
    n = 0
    for page in set(engine._uploads.uploads):
        ck = cache._page_ck.get(page)
        if ck is None or ck.hex() not in index:
            continue  # the page was reclaimed and reused since
        got, refs = cache._read_page(page), index[ck.hex()]
        if set(refs) != keys:
            raise AssertionError(f"page {page} persisted {sorted(refs)}")
        for key, ref_ in refs.items():
            want = store.get(ref_)
            if got[key].dtype != want.dtype or not np.array_equal(got[key],
                                                                  want):
                raise AssertionError(f"reloaded page {page} [{key}] differs "
                                     f"from the persisted bytes")
        n += 1
    if n == 0:
        raise AssertionError("no reloaded page left to compare")
    return n


def run_tier_restart(torch, np, cfg, serving, models, pk, card, quant):
    """Full-width smollm-360m, bf16 or int8 pages (``quant``), a pool small
    enough to reclaim: the run spills parked pages to host RAM and a
    persisted store; a NEW engine on the same store reruns the prompts
    from persisted pages. Returns the paged kernels' launch counts over
    both runs."""
    from repro_torch.serving.metrics import latency_percentiles

    params = models.build_model(cfg, device="cuda").init(seed=0)
    with tempfile.TemporaryDirectory(prefix="kv_tiers_") as tmp:
        kw = dict(max_len=MAX_LEN, max_slots=SLOTS, page_size=PAGE,
                  prefill_chunk=CHUNK, num_pages=TIER_PAGES,
                  host_pages=TIER_HOST_PAGES, persist_dir=tmp,
                  kv_quant=quant, device="cuda")
        pk.reset_launches()
        runs = []
        for label in ("first run", "restart"):
            engine = serving.ContinuousBatchingEngine(cfg, params, **kw)
            want = {"k", "v"} | ({"k_scale", "v_scale"} if quant == "int8"
                                 else set())
            if set(engine.cache.pages) != want:
                raise AssertionError(f"kv_quant={quant!r} built pool tensors "
                                     f"{sorted(engine.cache.pages)}")
            engine._uploads = _UploadLog(engine.cache)
            reqs = _requests(serving, 16, np.random.default_rng(7),
                             sampled_every=2)
            t0 = time.perf_counter()
            handles, steps = _drive(torch, engine, reqs)
            wall = time.perf_counter() - t0
            results = [h.result() for h in handles]
            _check_served(np, cfg, results, 32)
            t = engine.cache.tiers.counters
            lat = latency_percentiles(results)
            _log_run(f"tiers ({quant} pages) {label}", cfg, card, reqs,
                     results, wall, steps,
                     f"prefill_chunks {engine.stats['prefill_chunks']}, "
                     f"preemptions {engine.stats['preemptions']}; tiers "
                     + ", ".join(f"{k} {v:.4g}" if isinstance(v, float)
                                 else f"{k} {v}" for k, v in t.items()))
            if label == "first run":
                if not (t["reclaimed_pages"] > 0 and t["spilled_pages"] > 0):
                    raise AssertionError(f"the pool never reclaimed and "
                                         f"spilled parked pages: {t}")
                flushed = engine.cache.flush_tiers()
                log(f"tiers ({quant} pages): flush_tiers() spilled {flushed} "
                    f"parked pages; {engine.cache.tiers.persisted_count} "
                    f"pages persisted ({engine.cache.page_nbytes} B each)")
            else:
                if not t["persist_hits"] > 0:
                    raise AssertionError(f"the restart found no persisted "
                                         f"page: {t}")
                n = _check_reloaded(torch, np, engine, tmp, want)
                log(f"tiers ({quant} pages): {n} reloaded pages equal the "
                    f"persisted bytes of {sorted(want)} under their content "
                    f"keys")
            runs.append((engine.stats["prefill_chunks"], lat, results))
            del engine
        launches = dict(pk.LAUNCHES)
    if not all(launches[k] > 0 for k in launches):
        raise AssertionError(f"a route never ran its kernel: {launches}")
    (c1, lat1, _), (c2, lat2, _) = runs
    if not c2 < c1:
        raise AssertionError(f"the restart prefilled {c2} chunks, the first "
                             f"run {c1}")
    log(f"tiers ({quant} pages): restart prefill chunks {c2} vs {c1}; TTFT "
        f"p50 {lat1['ttft_ms'][0]:.1f} -> {lat2['ttft_ms'][0]:.1f} ms, p99 "
        f"{lat1['ttft_ms'][2]:.1f} -> {lat2['ttft_ms'][2]:.1f} ms")
    return launches


def _record_dispatches(engine):
    """Record the interleaved engine's dispatches: ("d", uids decoded) for
    each decode over ``max_slots`` rows, ("c", uid, start, valid) for each
    CHUNK-row prefill chunk."""
    ex, sched, log_ = engine.executor, engine.scheduler, []
    decode, chunk = ex.decode, ex.prefill_chunk

    def rec_decode(inputs=None):
        log_.append(("d", tuple(sorted(seq.handle.uid
                                       for _, seq in sched.decoding()))))
        return decode(inputs)

    def rec_chunk(work):
        log_.append(("c", work.seq.handle.uid, work.start, work.valid))
        return chunk(work)

    ex.decode, ex.prefill_chunk = rec_decode, rec_chunk
    return log_


def run_tier_int8_parity(torch, np, cfg, serving, models):
    """f32, TF32 off, PARITY_LAYERS layers: int8 streams through the kernels
    = through the plain versions; the tiered run, its restart from the
    store and an untiered run give the same streams.

    With one slot all three runs step through the same shapes (a reused
    prefix ends on a chunk boundary: 128 = 2 x 64). With four slots, in
    the interleaved step mode, every decode dispatch has ``max_slots`` rows
    and every chunk CHUNK rows, whatever the schedule, so no row's matmul
    shape depends on the schedule (a fused step's are slots + CHUNK rows,
    a decode-only step's slots rows; a fused 4-slot tiered run and an
    untiered run on a pool of another size once differed in one greedy
    token on an H100 80GB HBM3, 700 W). The 4-slot runs share TIER_PARITY_PAGES, a
    pool on which the tiered run reclaims and spills while other slots are
    live and preempts nothing, so its dispatches must equal the untiered
    run's one for one; the restart skips the persisted chunks."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = dataclasses.replace(cfg, dtype="float32",
                                num_layers=PARITY_LAYERS)
    params = models.build_model(cfg32, device="cuda").init(seed=1)

    def streams(slots=4, **kw):
        engine = serving.ContinuousBatchingEngine(
            cfg32, params, max_len=MAX_LEN, max_slots=slots, page_size=PAGE,
            prefill_chunk=CHUNK, device="cuda", **kw)
        dispatches = (_record_dispatches(engine)
                      if kw.get("step_mode") == "interleaved" else None)
        reqs = _requests(serving, 8, np.random.default_rng(9),
                         sampled_every=0)
        handles, _ = _drive(torch, engine, reqs)
        return [list(h.tokens) for h in handles], engine, dispatches

    runs = {impl: streams(kv_quant="int8", attn_impl=impl)[0]
            for impl in ("auto", "ref")}
    if runs["auto"] != runs["ref"]:
        raise AssertionError(f"f32 int8 kernel vs plain streams differ: {runs}")
    log(f"tier + int8 parity: f32, {PARITY_LAYERS} layers, full width: 8 "
        f"greedy int8 streams of 32 tokens identical through kernels and "
        f"plain versions")
    for slots, quant, pages, mode in (
            (1, "none", TIER_PAGES // 2, "fused"),
            (4, "none", TIER_PARITY_PAGES, "interleaved"),
            (4, "int8", TIER_PARITY_PAGES, "interleaved")):
        kw = dict(slots=slots, num_pages=pages, kv_quant=quant,
                  step_mode=mode)
        with tempfile.TemporaryDirectory(prefix="kv_tiers_") as tmp:
            tier_kw = dict(kw, host_pages=16, persist_dir=tmp)
            tiered, engine, d_tiered = streams(**tier_kw)
            t = dict(engine.cache.tiers.counters)
            pre = [engine.stats["preemptions"]]
            if not (t["spilled_pages"] > 0 and t["reclaimed_pages"] > 0):
                raise AssertionError(f"the parity run never spilled: {t}")
            engine.cache.flush_tiers()
            restart, engine, _ = streams(**tier_kw)
            hits = engine.cache.tiers.counters["persist_hits"]
            pre.append(engine.stats["preemptions"])
            if not hits > 0:
                raise AssertionError("the parity restart found no persisted "
                                     "page")
        untiered, engine, d_untiered = streams(kv_tiers=False, **kw)
        pre.append(engine.stats["preemptions"])
        if slots > 1:
            if any(pre):
                raise AssertionError(f"preemptions {pre} (tiered, restart, "
                                     f"untiered): recomputed rows break the "
                                     f"comparison")
            if d_tiered != d_untiered:
                raise AssertionError("the tiered run dispatched other steps "
                                     "than the untiered run")
        if not tiered == restart == untiered:
            raise AssertionError(
                f"{slots} slot(s), {quant} pages: tiered / restart / untiered"
                f" streams differ: {tiered} / {restart} / {untiered}")
        log(f"tier parity: {slots} slot(s), {quant} pages, {pages} pages, "
            f"{mode} steps: tiered ({t['reclaimed_pages']} reclaimed, "
            f"{t['spilled_pages']} spilled, {t['host_hits']} host hits) = "
            f"restart from the store ({hits} persisted hits) = untiered"
            + (f"; tiered and untiered dispatched the same {len(d_tiered)} "
               f"steps" if slots > 1 else ""))


def run_serve_tiers(card):
    """The serving driver, as a user runs it, on the card at full width:
    ``python -m repro_torch.launch.serve --kv-quant int8 --host-pages 8
    --persist-dir DIR`` twice on one directory. Both serve every request;
    only the second reports persisted hits (``tier_hits=.../pvN``)."""
    with tempfile.TemporaryDirectory(prefix="serve_tiers_") as tmp:
        for n in (1, 2):
            t0 = time.perf_counter()
            out = serve_cli(
                "--requests", "12", "--max-new", "8", "--shared-prefix",
                "32", "--kv-quant", "int8", "--host-pages", "8",
                "--persist-dir", f"{tmp}/kv", "--workdir", f"{tmp}/run{n}")
            hits = re.search(r"tier_hits=dev\d+/host\d+/pv(\d+);", out)
            if "served 12/12" not in out or not hits:
                raise AssertionError(f"serve run {n}: {out[-2000:]}")
            if (int(hits.group(1)) > 0) != (n == 2):
                raise AssertionError(f"serve run {n}: persisted hits "
                                     f"{hits.group(1)}")
            served = next(line for line in out.splitlines()
                          if line.startswith("served"))
            log(f"serve driver run {n} on {card} (--kv-quant int8 "
                f"--host-pages 8 --persist-dir, {time.perf_counter() - t0:.1f}"
                f" s): {served}; tier_hits=...pv{hits.group(1)}")


# ---------------------------------------------------------------------------
# phases 6-9: the flash kernel, the lockstep and whole-prompt engines
# ---------------------------------------------------------------------------


def _flash_plain(ref, q, k, v, causal):
    """The plain version on the kernel's (B, H, S, D) layout: the op's
    chunked reference, one K/V block when Skv is ragged."""
    skv = k.shape[2]
    out = ref.flash_attention_chunked(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, chunk_kv=256 if skv % 256 == 0 else skv)
    return out.transpose(1, 2)


def check_flash(torch, fk, ref, engine_shapes, d80_shapes):
    """The flash kernel against its plain version at smollm widths: fixed
    ragged and contract cases, every whole-prompt bucket, and each
    (B, S) in ``engine_shapes`` (the prefills the engine phases ran); then
    at zamba2's D 80 (32 heads, G 1; with each (B, S) in ``d80_shapes``,
    the lockstep zamba2 prefills) and llama3's D 128 (32 / 8 heads),
    causal and not. Returns the max abs error over the smollm bf16 cases
    and logs the rest."""
    cases = [(LOCK_BATCH, s, s, True) for s in (1, 64, 100, 256, 300, 512)]
    cases += [(LOCK_BATCH, 64, 320, True), (LOCK_BATCH, 37, 300, False)]
    buckets = [1 << i for i in range(7, WHOLE_MAX_LEN.bit_length())]
    shapes = sorted({(1, s) for s in buckets} | set(engine_shapes))
    cases += [(b, s, s, True) for b, s in shapes if (b, s, s, True)
              not in cases]
    d80_cases = [(2, 100, 100, True), (1, 256, 256, True),
                 (2, 37, 300, False), (1, 64, 320, True)]
    d128_cases = d80_cases + [(1, 512, 512, True), (LOCK_BATCH, 256, 256,
                                                     True)]
    d80_cases += [(b, s, s, True) for b, s in sorted(set(d80_shapes))]
    widths = {"smollm": (FLASH_WIDTHS["smollm D64"], cases),
              "D 80": (FLASH_WIDTHS["zamba2 D80"], d80_cases),
              "D 128": (FLASH_WIDTHS["llama3 D128"], d128_cases)}
    err_bf16 = 0.0
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
        label = str(dtype).removeprefix("torch.")
        g = torch.Generator(device="cuda").manual_seed(31)
        worst = {}
        for wname, ((h, kvh, d), wcases) in widths.items():
            worst[wname] = 0.0
            for b, sq, skv, causal in wcases:
                q = torch.randn(b, h, sq, d, generator=g,
                                device="cuda").to(dtype)
                k, v = (torch.randn(b, kvh, skv, d, generator=g,
                                    device="cuda").to(dtype)
                        for _ in range(2))
                got = fk.flash_attention_bhsd(q, k, v, causal=causal)
                want = _flash_plain(ref, q, k, v, causal)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                if not err <= tol:
                    raise AssertionError(
                        f"flash_attention_bhsd [{label} {wname} B={b} Sq={sq}"
                        f" Skv={skv} causal={causal}]: max abs err {err} > "
                        f"{tol}")
                worst[wname] = max(worst[wname], err)
        log(f"flash kernel check {label}: {len(cases)} cases (H {FLASH_H}, "
            f"KVH {KVH}, D {D}; B 8: Sq=Skv 1..512, Sq 64 < Skv 320, "
            f"non-causal 37 x 300; B 1: buckets {buckets}; engine (B, S) "
            f"{sorted(set(engine_shapes))}): max abs err "
            f"{worst['smollm']:.3e} (bound {tol})")
        log(f"flash kernel check {label} D 80 (32 heads, G 1; causal 100, "
            f"256 and 64 < 320, non-causal 37 x 300; lockstep zamba2 (B, S) "
            f"{sorted(set(d80_shapes))}): max abs err {worst['D 80']:.3e} "
            f"(bound {tol})")
        log(f"flash kernel check {label} D 128 (32 / 8 heads; the D 80 cases"
            f", B 1 x 512 and B 8 x 256): max abs err {worst['D 128']:.3e} "
            f"(bound {tol})")
        if dtype == torch.bfloat16:
            err_bf16 = worst["smollm"]
    return {"flash_attention_bhsd": err_bf16}


def _flash_bound(b, sq, skv, causal, elt, width=None):
    """Least time for one flash call at FLASH_WIDTHS[width] (smollm's by
    default): q, k, v read once and out written once, against 4 D H flops
    per attended (query, key) pair at the inputs' type's peak. Returns
    (ms, 'bytes' | 'operations')."""
    h, kvh, d = FLASH_WIDTHS[width or "smollm D64"]
    nbytes = elt * d * b * (2 * h * sq + 2 * kvh * skv)
    off = skv - sq
    pairs = (sum(off + i + 1 for i in range(sq)) if causal else sq * skv) * b
    flops = 4 * d * h * pairs
    rate = BF16_FLOP_PER_S if elt == 2 else F32_FLOP_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_flash(torch, F, fk, ref):
    """kernel / plain / SDPA times (ms) and the bound at the two engine
    shapes (bf16, causal) at every one of FLASH_WIDTHS, each cycling over
    32 layers' inputs so every launch reads them from HBM. Returns smollm's
    lockstep row (the one the kernels line carries) and logs all."""
    rows = {}
    for wname, (h, kvh, d) in FLASH_WIDTHS.items():
        for label, b, s in (("lockstep", LOCK_BATCH, 256),
                            ("whole-prompt", 1, 512)):
            g = torch.Generator(device="cuda").manual_seed(32)
            qs = torch.randn(LAYERS, b, h, s, d, generator=g,
                             device="cuda").to(torch.bfloat16)
            ks, vs = (torch.randn(LAYERS, b, kvh, s, d, generator=g,
                                  device="cuda").to(torch.bfloat16)
                      for _ in range(2))
            # the plain version's own (B, S, H, D) layout, made in advance
            qt, kt, vt = (x.transpose(2, 3).contiguous() for x in (qs, ks, vs))

            def kernel(i):
                l = i % LAYERS
                fk.flash_attention_bhsd(qs[l], ks[l], vs[l], causal=True)

            def plain(i):
                l = i % LAYERS
                ref.flash_attention_chunked(qt[l], kt[l], vt[l], causal=True,
                                            chunk_kv=256)

            def library(i):
                l = i % LAYERS
                F.scaled_dot_product_attention(qs[l], ks[l], vs[l],
                                               is_causal=True,
                                               enable_gqa=True)

            p1 = _time_ms(torch, plain, iters=32)
            k1 = _time_ms(torch, kernel)
            k2 = _time_ms(torch, kernel)
            p2 = _time_ms(torch, plain, iters=32)
            lib = _time_ms(torch, library)
            bound = _flash_bound(b, s, s, True, 2, wname)
            rows[wname, label] = dict(ms=min(k1, k2), plain_ms=min(p1, p2),
                                      library_ms=lib, bound_ms=bound[0],
                                      bound_by=bound[1])
            log(f"timing flash_attention_bhsd {label} [{wname}: H {h}, KVH "
                f"{kvh}] (B {b}, S {s}, causal, bf16): kernel "
                f"{k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms, sdpa "
                f"{lib:.4f} ms, bound {bound[0]:.5f} ms ({bound[1]})")
            del qs, ks, vs, qt, kt, vt
    return {"flash_attention_bhsd": rows["smollm D64", "lockstep"]}


def _record_prefills(model):
    """Record the token shape (B, S) of each of the model's dense prefills
    (one per lockstep batch or whole-prompt admission) by wrapping its
    entry point; the flash kernel sees (B, H, S, D) at each."""
    shapes = []
    inner = model.prefill

    def prefill(batch, *a, **kw):
        shapes.append(tuple(batch["tokens"].shape))
        return inner(batch, *a, **kw)

    model.prefill = prefill
    return shapes


def run_lockstep(torch, np, cfg, serving, models, fk, card):
    """Full-width smollm-360m through the lockstep engine; returns the
    flash kernel's launch count over the measured run and the (B, S) of
    its prefills."""
    params = models.build_model(cfg, device="cuda").init(seed=0)
    kw = dict(max_len=LOCK_MAX_LEN, max_batch=LOCK_BATCH, device="cuda")
    rng = np.random.default_rng(40)
    # warm-up (cuBLAS handles, allocator, first launches): not measured
    _drive(torch, serving.GenerationEngine(cfg, params, **kw),
           _random_requests(serving, 2, rng, 2, lo=64, hi=256, max_new=4,
                            uid="l", vocab=49152, seed0=3000))
    engine = serving.GenerationEngine(cfg, params, **kw)
    prefills = _record_prefills(engine.model)
    reqs = _random_requests(serving, 16, rng, 2, lo=64, hi=256, max_new=32,
                            uid="l", vocab=49152, seed0=3000)
    fk.reset_launches()
    t0 = time.perf_counter()
    handles, steps = _drive(torch, engine, reqs)
    wall = time.perf_counter() - t0
    launches = fk.LAUNCHES["flash_attention_bhsd"]
    results = [h.result() for h in handles]
    _check_served(np, cfg, results, 32)
    if not (prefills and launches == LAYERS * len(prefills)):
        raise AssertionError(f"flash launches {launches} != {LAYERS} x "
                             f"{len(prefills)} prefilled batches")
    _log_run("lockstep", cfg, card, reqs, results, wall, steps,
             f"{len(prefills)} prefilled batches (B, S) {prefills}; flash "
             f"launches {launches} = {LAYERS} layers x {len(prefills)}; peak "
             f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
             f" GiB")
    log("utilization: " + engine.utilization.format())
    del engine
    _trace(torch, lambda: serving.GenerationEngine(cfg, params, **kw),
           _random_requests(serving, 8, np.random.default_rng(41), 0, lo=64,
                            hi=256, max_new=32, uid="l", vocab=49152, seed0=3000),
           FLASH_TRACE_KEYS, "flash kernel")
    return launches, prefills


def run_whole_prompt(torch, np, cfg, serving, models, fk, pk, card):
    """Full-width smollm-360m through the paged engine with whole-prompt
    prefill; returns the flash and paged kernels' launch counts over the
    measured run and the (B, S) of its prefills."""
    params = models.build_model(cfg, device="cuda").init(seed=0)
    kw = dict(max_len=WHOLE_MAX_LEN, max_slots=SLOTS, page_size=PAGE,
              prefill_chunk=None, device="cuda")
    rng = np.random.default_rng(50)
    _drive(torch, serving.ContinuousBatchingEngine(cfg, params, **kw),
           _random_requests(serving, 2, rng, 2, lo=100, hi=600, max_new=4,
                            uid="w", vocab=49152, seed0=3000))
    engine = serving.ContinuousBatchingEngine(cfg, params, **kw)
    prefills = _record_prefills(engine.model)
    reqs = _random_requests(serving, 8, rng, 2, lo=100, hi=600, max_new=32,
                            uid="w", vocab=49152, seed0=3000)
    fk.reset_launches()
    pk.reset_launches()
    t0 = time.perf_counter()
    handles, steps = _drive(torch, engine, reqs)
    wall = time.perf_counter() - t0
    launches = fk.LAUNCHES["flash_attention_bhsd"]
    paged = dict(pk.LAUNCHES)
    results = [h.result() for h in handles]
    _check_served(np, cfg, results, 32)
    st = engine.stats
    if not (st["prefills"] == len(reqs) and st["preemptions"] == 0
            and len(prefills) == st["prefills"]
            and launches == LAYERS * st["prefills"]):
        raise AssertionError(f"flash launches {launches} != {LAYERS} x "
                             f"{st['prefills']} admissions ({st})")
    if not paged["paged_attention_bkgd"] > 0:
        raise AssertionError(f"the decode kernel never ran: {paged}")
    _log_run("whole-prompt", cfg, card, reqs, results, wall, steps,
             f"{st['prefills']} whole-prompt prefills ((B, S) {sorted(set(prefills))}), "
             f"decode_steps {st['decode_steps']}, prefill_chunks "
             f"{st['prefill_chunks']}; flash launches {launches} = {LAYERS} "
             f"layers x {st['prefills']}; paged launches {paged}")
    log("utilization: " + engine.utilization.format())
    del engine
    _trace(torch, lambda: serving.ContinuousBatchingEngine(cfg, params, **kw),
           _random_requests(serving, 8, np.random.default_rng(51), 0, lo=100,
                            hi=600, max_new=32, uid="w", vocab=49152, seed0=3000),
           PAGED_TRACE_KEYS + FLASH_TRACE_KEYS,
           "flash + paged kernels", check=PAGED_BF16_CHECK)
    return launches, paged, prefills


def run_whole_prompt_parity(torch, np, cfg, serving, models):
    """f32 with TF32 off: the flash kernel's one-prefill logit gap to its
    plain version at 32 and 2 layers; then, at PARITY_LAYERS, greedy
    lockstep streams through kernels = through plain versions, and the
    whole-prompt paged engine = the chunked paged engine = lockstep one
    request at a time, on the same requests."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(6)
    toks = np.zeros((2, 256), np.int32)  # a left-padded lockstep batch
    toks[0] = rng.integers(1, cfg.vocab_size, 256)
    toks[1, 56:] = rng.integers(1, cfg.vocab_size, 200)
    batch = {"tokens": torch.from_numpy(toks).cuda()}
    for layers in (LAYERS, PARITY_LAYERS):
        cfg32 = dataclasses.replace(cfg, dtype="float32", num_layers=layers)
        model = models.build_model(cfg32, device="cuda")
        model.init(seed=1)
        logits = {}
        for impl in ("auto", "ref"):
            model.attn_impl = impl
            logits[impl] = model.prefill(batch, 256)[1][:, :cfg.vocab_size]
        a, b = logits["auto"], logits["ref"]
        gap = (a - b).abs().max().item()
        top2 = b.topk(2, dim=-1).values
        log(f"whole-prompt parity: {layers} layers, one prefill (B 2, S 256,"
            f" left-padded): max |logit kernel - plain| = {gap:.3e}, argmax "
            f"{a.argmax(-1).tolist()} vs {b.argmax(-1).tolist()}, plain "
            f"top-2 margin {(top2[:, 0] - top2[:, 1]).min().item():.3e}")
        if layers == PARITY_LAYERS and not gap < 1e-3:
            raise AssertionError(f"kernel vs plain logits differ by {gap}")
        del model
    cfg32 = dataclasses.replace(cfg, dtype="float32",
                                num_layers=PARITY_LAYERS)
    params = models.build_model(cfg32, device="cuda").init(seed=1)

    def requests():
        return _random_requests(serving, 5, np.random.default_rng(3), 0,
                                lo=70, hi=200, max_new=16, uid="g",
                                vocab=49152, seed0=3000)

    def streams(engine, one_by_one=False):
        if one_by_one:
            return [list(engine.generate([r])[0].tokens) for r in requests()]
        handles, _ = _drive(torch, engine, requests())
        return [list(h.tokens) for h in handles]

    runs = {}
    for impl in ("auto", "ref"):
        runs[f"lockstep {impl}"] = streams(serving.GenerationEngine(
            cfg32, params, max_len=LOCK_MAX_LEN, max_batch=LOCK_BATCH,
            attn_impl=impl, device="cuda"))
    if runs["lockstep auto"] != runs["lockstep ref"]:
        raise AssertionError(f"f32 lockstep kernel vs plain streams differ: "
                             f"{runs}")
    runs["lockstep one by one"] = streams(serving.GenerationEngine(
        cfg32, params, max_len=LOCK_MAX_LEN, device="cuda"), one_by_one=True)
    for label, chunk in (("whole-prompt", None), ("chunked", CHUNK)):
        runs[label] = streams(serving.ContinuousBatchingEngine(
            cfg32, params, max_len=LOCK_MAX_LEN, max_slots=4, page_size=PAGE,
            prefill_chunk=chunk, device="cuda"))
    want = runs["lockstep one by one"]
    if not runs["whole-prompt"] == runs["chunked"] == want:
        raise AssertionError(f"f32 whole-prompt / chunked / lockstep streams "
                             f"differ: {runs}")
    log(f"whole-prompt parity: {PARITY_LAYERS} layers, full width: 5 greedy "
        f"streams of 16 tokens identical through the lockstep engine "
        f"(kernels and plain versions), and whole-prompt paged = chunked "
        f"paged = lockstep one request at a time")


# ---------------------------------------------------------------------------
# phases 11-12: the mamba2 SSM engine
# ---------------------------------------------------------------------------


def run_mamba_engine(torch, np, cfg, serving, models, sk, card):
    """Full-width mamba2-1.3b through the SSM engine; returns the SSD
    kernels' launch counts over the measured run."""
    params = models.build_model(cfg, device="cuda").init(seed=0)
    engine_kw = dict(max_len=M_MAX_LEN, max_slots=SLOTS,
                     prefill_chunk=CHUNK, device="cuda")
    rng = np.random.default_rng(20)
    # warm-up (cuBLAS handles, allocator, first launches): not measured
    _drive(torch, serving.SSMEngine(cfg, params, **engine_kw),
           _random_requests(serving, 2, rng, 2, lo=64, hi=400, max_new=4,
                            uid="m", vocab=50280, seed0=2000))
    engine = serving.SSMEngine(cfg, params, **engine_kw)
    reqs = _random_requests(serving, 8, rng, 2, lo=64, hi=400, max_new=24,
                            uid="m", vocab=50280, seed0=2000)
    sk.reset_launches()
    t0 = time.perf_counter()
    handles, steps = _drive(torch, engine, reqs)
    wall = time.perf_counter() - t0
    launches = dict(sk.LAUNCHES)
    paths = dict(sk.LAUNCHES_BY_PATH)
    results = [h.result() for h in handles]
    _check_served(np, cfg, results, 24)
    if not all(launches[k] > 0 for k in launches):
        raise AssertionError(f"an SSD kernel never ran: {launches}")
    if paths != {"mma": launches["ssd_scan_bshp"], "cuda_core": 0}:
        raise AssertionError(f"a bf16 scan left the tensor-core kernel: "
                             f"{paths}")
    st = engine.stats
    _log_run("engine", cfg, card, reqs, results, wall, steps,
             f"decode_steps {st['decode_steps']}, prefill_chunks "
             f"{st['prefill_chunks']}, preemptions {st['preemptions']}; "
             f"kernel launches {launches} (scan paths {paths}) over "
             f"{cfg.num_layers} layers per "
             f"dispatch; peak device memory "
             f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log("utilization: " + engine.utilization.format())
    del engine
    _trace(torch, lambda: serving.SSMEngine(cfg, params, **engine_kw),
           _random_requests(serving, 8, np.random.default_rng(21), 0, lo=64,
                            hi=400, max_new=24, uid="m", vocab=50280,
                            seed0=2000),
           SSD_TRACE_KEYS, "SSD kernels", check=SSD_BF16_CHECK)
    return launches


def _drive_preempting(torch, engine, reqs):
    """_drive with one snapshot preemption and then one discard preemption
    of the youngest decoding request, each at the first third step where
    something is decoding."""
    handles = [engine.submit(r) for r in reqs]
    plan, steps = [True, False], 0
    while not engine.idle:
        engine.step()
        steps += 1
        if plan and steps % 3 == 0 and engine.preempt_youngest(
                snapshot=plan[0]) is not None:
            plan.pop(0)
    torch.cuda.synchronize()
    st = engine.stats
    if plan or st["preemptions"] != 2 or st["restores"] != 1:
        raise AssertionError(f"preemptions not taken as planned: {st}")
    return handles


def run_mamba_parity(torch, np, cfg, serving, models):
    """f32 with TF32 off, at the full 48 layers: the one-chunk logit gap of
    the kernels to the plain versions, then the SSM engine through the
    kernels vs through the plain versions (``ssd_impl="ref"``), and under
    preemption; greedy streams identical."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model = models.build_model(cfg32, device="cuda")
    params = model.init(seed=1)
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        1, cfg.vocab_size, CHUNK).astype(np.int32)).cuda()
    logits = {}
    for impl in ("auto", "ref"):
        model.ssd_impl = impl
        bank = serving.SlotStateBank(cfg32, 1, torch.float32, device="cuda")
        _, logits[impl] = model.prefill_chunk_ssm(bank.state, toks, 50)
    a, b = logits["auto"][:cfg.vocab_size], logits["ref"][:cfg.vocab_size]
    gap = (a - b).abs().max().item()
    top2 = b.topk(2).values
    log(f"mamba2 parity: f32, TF32 off, {cfg32.num_layers} layers, one "
        f"64-token chunk (valid 50): max |logit kernel - plain| = {gap:.3e}, "
        f"argmax {a.argmax().item()} vs {b.argmax().item()}, plain top-2 "
        f"margin {(top2[0] - top2[1]).item():.3e}")
    if not gap < 1e-3:
        raise AssertionError(f"kernel vs plain logits differ by {gap}")
    del model, bank

    def requests():
        return _random_requests(serving, 5, np.random.default_rng(3), 0,
                                lo=70, hi=200, max_new=16, uid="m",
                                vocab=50280, seed0=2000)

    streams = {}
    for impl in ("auto", "ref"):
        engine = serving.SSMEngine(cfg32, params, max_len=M_MAX_LEN,
                                   max_slots=4, prefill_chunk=CHUNK,
                                   ssd_impl=impl, device="cuda")
        handles, _ = _drive(torch, engine, requests())
        streams[impl] = [list(h.tokens) for h in handles]
        del engine
    if streams["auto"] != streams["ref"]:
        raise AssertionError(f"f32 kernel vs plain streams differ: {streams}")
    engine = serving.SSMEngine(cfg32, params, max_len=M_MAX_LEN, max_slots=4,
                               prefill_chunk=CHUNK, device="cuda")
    handles = _drive_preempting(torch, engine, requests())
    if [list(h.tokens) for h in handles] != streams["auto"]:
        raise AssertionError("streams under snapshot + discard preemption "
                             "differ from the undisturbed run")
    log(f"mamba2 parity: {cfg32.num_layers} layers, full width: "
        f"{len(streams['auto'])} greedy streams of 16 tokens identical "
        f"through kernels and plain versions, and through one snapshot and "
        f"one discard preemption")


# ---------------------------------------------------------------------------
# phases 13-16: the zamba2 hybrid engine, the ssm/hybrid lockstep engine
# ---------------------------------------------------------------------------


def _path_launches(pk, sk, fk=None):
    """The launch counts of every kernel since the last reset."""
    out = {**pk.LAUNCHES, **sk.LAUNCHES}
    if fk is not None:
        out.update(fk.LAUNCHES)
    return out


def _check_scans_mma(sk, what):
    paths = dict(sk.LAUNCHES_BY_PATH)
    if paths != {"mma": sk.LAUNCHES["ssd_scan_bshp"], "cuda_core": 0}:
        raise AssertionError(f"{what}: a bf16 scan left the tensor-core "
                             f"kernel: {paths}")
    return paths


def run_zamba_engine(torch, np, cfg, serving, models, pk, sk, card):
    """Full-width zamba2-2.7b through the hybrid SSM engine, with an ample
    pool and with one that preempts; returns {path: the hybrid path's
    kernels' launch counts} for both runs."""
    params = models.build_model(cfg, device="cuda").init(seed=0)
    kw = dict(max_len=Z_MAX_LEN, max_slots=SLOTS, prefill_chunk=CHUNK,
              page_size=PAGE, device="cuda")
    rng = np.random.default_rng(60)
    # warm-up (cuBLAS handles, allocator, first launches): not measured
    _drive(torch, serving.SSMEngine(cfg, params, **kw),
           _random_requests(serving, 2, rng, 2, lo=64, hi=400, max_new=4,
                            uid="z", vocab=cfg.vocab_size, seed0=4000))
    out = {}
    for path, pages, seed in (("zamba2", None, 61),
                              ("zamba2 page pressure", Z_TIGHT_PAGES, 62)):
        engine = serving.SSMEngine(cfg, params, num_pages=pages, **kw)
        reqs = _random_requests(serving, 8, np.random.default_rng(seed), 2,
                                lo=64, hi=400, max_new=24, uid="z",
                                vocab=cfg.vocab_size, seed0=4000)
        pk.reset_launches()
        sk.reset_launches()
        t0 = time.perf_counter()
        handles, steps = _drive(torch, engine, reqs)
        wall = time.perf_counter() - t0
        launches = _path_launches(pk, sk)
        paths = _check_scans_mma(sk, path)
        results = [h.result() for h in handles]
        _check_served(np, cfg, results, 24)
        if not all(launches[k] > 0 for k in HYBRID_KERNELS):
            raise AssertionError(f"{path}: a kernel of the hybrid path never "
                                 f"ran: {launches}")
        if launches["paged_mixed_attention_rkgd"] != 0:
            raise AssertionError(f"{path}: the hybrid engine ran a mixed "
                                 f"step: {launches}")
        st = engine.stats
        if (st["preemptions"] > 0) != (pages is not None):
            raise AssertionError(f"{path}: preemptions {st['preemptions']} "
                                 f"with num_pages {pages}")
        _log_run(path, cfg, card, reqs, results, wall, steps,
                 f"decode_steps {st['decode_steps']}, prefill_chunks "
                 f"{st['prefill_chunks']}, preemptions {st['preemptions']}, "
                 f"pool {engine.cache.num_pages - 1} pages of "
                 f"{engine.cache.page_nbytes} B over "
                 f"{cfg.num_layers // cfg.attn_every} attention layers; "
                 f"kernel launches {launches} (scan paths {paths}); peak "
                 f"device memory "
                 f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        log("utilization: " + engine.utilization.format())
        out[path] = {k: launches[k] for k in HYBRID_KERNELS}
        del engine
    _trace(torch, lambda: serving.SSMEngine(cfg, params, **kw),
           _random_requests(serving, 8, np.random.default_rng(63), 0, lo=64,
                            hi=400, max_new=24, uid="z", vocab=cfg.vocab_size,
                            seed0=4000),
           PAGED_TRACE_KEYS + SSD_TRACE_KEYS, "paged + SSD kernels",
           check=ZAMBA_BF16_CHECK)
    return out


def _hybrid_chunk_logits(torch, np, model, serving, impl):
    """Logits of one 64-token prompt chunk (valid 50) from a zero state
    into an empty pool, through ``prefill_chunk_hybrid``."""
    cfg = model.cfg
    model.attn_impl = model.ssd_impl = impl
    dt = getattr(torch, cfg.dtype)
    shape = (cfg.num_layers // cfg.attn_every, 6, PAGE, cfg.eff_kv_heads,
             cfg.head_dim)  # null page, 4 pages, sink
    pages = {k: torch.zeros(shape, dtype=dt, device="cuda")
             for k in ("k", "v")}
    bank = serving.SlotStateBank(cfg, 1, dt, device="cuda")
    row = torch.tensor([1, 2, 3, 4], dtype=torch.int32, device="cuda")
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        1, cfg.vocab_size, CHUNK).astype(np.int32)).cuda()
    _, logits = model.prefill_chunk_hybrid(pages, bank.state, row, toks, 0,
                                           50)
    return logits[:cfg.vocab_size].double()


def _first_diffs(a, b):
    """Per stream, the index of the first token where two runs differ
    (None where equal)."""
    return [next((i for i, (x, y) in enumerate(zip(ra, rb)) if x != y),
                 None) for ra, rb in zip(a, b)]


def _plain_f32_streams(torch, np, cfg, serving, models, requests, kw):
    """The plain engine's greedy streams at Z_PARITY_LAYERS in f32, held
    equal to those with f64 weights, activations and matmuls (the plain
    versions' norms, attention and SSD sums stay f32): f32 rounding flips
    no greedy decision of the stream check. Prints the one-chunk gaps
    (kernels - plain, plain f32 - f64) beside the top-2 margin."""
    logits, streams = {}, {}
    for dtype in ("float32", "float64"):
        c = dataclasses.replace(cfg, dtype=dtype, num_layers=Z_PARITY_LAYERS)
        model = models.build_model(c, device="cuda")
        params = model.init(seed=1)
        if dtype == "float32":
            logits["kernel"] = _hybrid_chunk_logits(torch, np, model,
                                                    serving, "auto")
        logits[dtype] = _hybrid_chunk_logits(torch, np, model, serving,
                                             "ref")
        streams[dtype] = _ssm_streams(torch, serving.SSMEngine(
            c, params, attn_impl="ref", ssd_impl="ref", **kw), requests())
        del model, params
    a, b, c = logits["kernel"], logits["float32"], logits["float64"]
    top2 = c.topk(2).values
    log(f"zamba2 parity: f32, TF32 off, {Z_PARITY_LAYERS} layers, one "
        f"64-token chunk (valid 50): max |logit kernel - plain| = "
        f"{(a - b).abs().max().item():.3e}, plain f32 - f64 = "
        f"{(b - c).abs().max().item():.3e}, argmax {a.argmax().item()} / "
        f"{b.argmax().item()} / {c.argmax().item()}, f64 top-2 margin "
        f"{(top2[0] - top2[1]).item():.3e}")
    diffs = _first_diffs(streams["float32"], streams["float64"])
    if any(d is not None for d in diffs):
        raise AssertionError(f"at {Z_PARITY_LAYERS} layers the plain path's "
                             f"f32 and f64 greedy streams differ (first "
                             f"differing token per stream {diffs})")
    return streams["float32"]


def _ssm_streams(torch, engine, reqs):
    handles, _ = _drive(torch, engine, reqs)
    return [list(h.tokens) for h in handles]


def run_zamba_parity(torch, np, cfg, serving, models):
    """f32 with TF32 off, at Z_PARITY_LAYERS: the plain streams agree
    with f64 (``_plain_f32_streams``), the hybrid engine's greedy streams
    through the kernels = through the plain versions = under page-pressure
    preemption, and snapshot preemption of a hybrid slot refused."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kw = dict(max_len=Z_MAX_LEN, max_slots=4, prefill_chunk=CHUNK,
              page_size=PAGE, device="cuda")

    def requests():
        return _random_requests(serving, 5, np.random.default_rng(3), 0,
                                lo=70, hi=200, max_new=16, uid="z",
                                vocab=cfg.vocab_size, seed0=4000)

    plain = _plain_f32_streams(torch, np, cfg, serving, models, requests,
                               kw)
    cfg32 = dataclasses.replace(cfg, dtype="float32",
                                num_layers=Z_PARITY_LAYERS)
    params = models.build_model(cfg32, device="cuda").init(seed=1)
    streams = _ssm_streams(torch, serving.SSMEngine(cfg32, params, **kw),
                           requests())
    if streams != plain:
        raise AssertionError(f"f32 kernel vs plain streams differ at "
                             f"{_first_diffs(streams, plain)}")
    tight = serving.SSMEngine(cfg32, params, num_pages=Z_PARITY_TIGHT_PAGES,
                              **kw)
    if _ssm_streams(torch, tight, requests()) != streams:
        raise AssertionError("streams under page-pressure preemption differ "
                             "from the undisturbed run")
    if tight.stats["preemptions"] == 0:
        raise AssertionError(f"{Z_PARITY_TIGHT_PAGES} pages never preempted")
    engine = serving.SSMEngine(cfg32, params, **kw)
    engine.submit(requests()[0])
    while not engine._has_decodable():
        engine.step()
    try:
        engine.preempt_youngest(snapshot=True)
    except ValueError as e:
        refusal = str(e)
    else:
        raise AssertionError("snapshot preemption of a hybrid slot passed")
    engine.abort_all()
    _drive(torch, engine, [])
    log(f"zamba2 parity: {Z_PARITY_LAYERS} layers, full width: "
        f"{len(streams)} greedy streams of 16 tokens identical through "
        f"kernels and plain versions, and through "
        f"{tight.stats['preemptions']} page-pressure "
        f"preemptions ({Z_PARITY_TIGHT_PAGES} pages); snapshot preemption "
        f"refused: {refusal}")


def run_lockstep_ssm(torch, np, cfgs, serving, models, fk, pk, sk, card):
    """Full-width mamba2-1.3b and zamba2-2.7b through the lockstep engine;
    returns {path: kernel launches} (scan, SSD decode, zamba2's flash) and
    {arch: the (B, S) of its prefills}."""
    out, shapes = {}, {}
    kw = dict(max_len=LOCK_MAX_LEN, max_batch=LOCK_BATCH, device="cuda")
    for name, cfg in cfgs.items():
        params = models.build_model(cfg, device="cuda").init(seed=0)
        vocab = cfg.vocab_size
        rng = np.random.default_rng(70)
        _drive(torch, serving.GenerationEngine(cfg, params, **kw),
               _random_requests(serving, 2, rng, 2, lo=64, hi=256, max_new=4,
                                uid="s", vocab=vocab, seed0=5000))
        engine = serving.GenerationEngine(cfg, params, **kw)
        prefills = _record_prefills(engine.model)
        reqs = _random_requests(serving, 8, rng, 2, lo=64, hi=256,
                                max_new=16, uid="s", vocab=vocab, seed0=5000)
        for mod in (fk, pk, sk):
            mod.reset_launches()
        t0 = time.perf_counter()
        handles, steps = _drive(torch, engine, reqs)
        wall = time.perf_counter() - t0
        launches = _path_launches(pk, sk, fk)
        paths = _check_scans_mma(sk, f"lockstep {name}")
        results = [h.result() for h in handles]
        _check_served(np, cfg, results, 16)
        want = ["ssd_scan_bshp", "ssd_decode_step_bh"]
        # per prefilled batch: one scan per Mamba layer, one flash call per
        # shared-block occurrence
        exact = {"ssd_scan_bshp": cfg.num_layers * len(prefills)}
        if cfg.family == "hybrid":
            want.append("flash_attention_bhsd")
            exact["flash_attention_bhsd"] = (
                cfg.num_layers // cfg.attn_every * len(prefills))
        if (not all(launches[k] > 0 for k in want)
                or any(launches[k] != n for k, n in exact.items())
                or any(launches[k] for k in pk.LAUNCHES)):
            raise AssertionError(f"lockstep {name}: launches {launches}, "
                                 f"{len(prefills)} prefilled batches")
        _log_run(f"lockstep {name}", cfg, card, reqs, results, wall, steps,
                 f"{len(prefills)} prefilled batches (B, S) {prefills}; "
                 f"kernel launches {launches} (scan paths {paths})")
        out[f"lockstep {name}"] = {k: launches[k] for k in want}
        shapes[name] = prefills
        del engine, params
    return out, shapes


def run_lockstep_ssm_parity(torch, np, cfgs, depths, serving, models):
    """f32, TF32 off, at each arch's parity depth: 5 equal-length prompts
    (one batch with no left padding) give the same greedy streams through
    the lockstep engine as through the SSM engine, as
    ``tests/test_ssm_engine.py:285`` asserts on the CPU."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for name, cfg in cfgs.items():
        cfg32 = dataclasses.replace(cfg, dtype="float32",
                                    num_layers=depths[name])
        params = models.build_model(cfg32, device="cuda").init(seed=1)
        rng = np.random.default_rng(8)
        prompts = [rng.integers(1, cfg.vocab_size, 160).tolist()
                   for _ in range(5)]

        def requests():
            return [serving.Request(f"e{i}", list(p), sampling=serving
                                    .SamplingParams(max_new_tokens=16))
                    for i, p in enumerate(prompts)]

        lock = _ssm_streams(torch, serving.GenerationEngine(
            cfg32, params, max_len=LOCK_MAX_LEN, max_batch=LOCK_BATCH,
            device="cuda"), requests())
        ssm = _ssm_streams(torch, serving.SSMEngine(
            cfg32, params, max_len=LOCK_MAX_LEN, max_slots=SLOTS,
            prefill_chunk=CHUNK, device="cuda"), requests())
        if lock != ssm:
            raise AssertionError(f"{name}: lockstep vs SSM engine streams "
                                 f"differ at {_first_diffs(lock, ssm)}")
        log(f"lockstep parity: {name}, f32, {depths[name]} layers, full "
            f"width: 5 greedy streams of 16 tokens (prompts of 160) "
            f"identical through the lockstep and SSM engines")
        del params


def run_serve_ssm(card):
    """The serving driver at full width on the recurrent families: zamba2
    through the SSM engine, mamba2 through lockstep."""
    with tempfile.TemporaryDirectory(prefix="serve_ssm_") as tmp:
        for args, kind in ((["--arch", "zamba2-2.7b"], "ssm"),
                           (["--engine", "lockstep", "--arch",
                             "mamba2-1.3b"], "lockstep")):
            t0 = time.perf_counter()
            out = serve_cli(*args, "--requests", "8", "--max-new", "8",
                            "--workdir", f"{tmp}/{kind}")
            if "served 8/8" not in out or f"engine={kind}" not in out:
                raise AssertionError(f"serve {args}: {out[-2000:]}")
            served = next(line for line in out.splitlines()
                          if line.startswith("served"))
            log(f"serve driver {' '.join(args)} on {card} "
                f"({time.perf_counter() - t0:.1f} s): {served}")


# ---------------------------------------------------------------------------
# phases 22-26: speculative decoding, the fleet, put_tree on the card
# ---------------------------------------------------------------------------


def check_verify(torch, ops, ref):
    """Kernel 2 at speculative-verify widths: bundles of C = k + 1 rows (k
    1-8) with valid < C, at every one of PAGED_WIDTHS, over bf16, int8 and
    f32 pools, on a plain and a COW-forked table (a prefix of one table's
    pages, then another's), from starts inside the first page, on a page
    boundary and deep in the table; against ``paged_verify_attention_ref``
    (int8: over the dequantized pool). Padded rows must be exact zeros.
    Returns the max abs error per pool kind."""
    errs = {"bf16": 0.0, "int8": 0.0, "f32": 0.0}
    n_pages = 400
    for wname, width in PAGED_WIDTHS.items():
        kvh, group, d, page = width
        mp = -(-MAX_LEN // page)
        kf, vf = _pools(torch, n_pages, torch.float32, seed=11, width=width)
        kf, vf = kf[0], vf[0]
        (kq, ks), (vq, vs) = ref.quantize_kv(kf), ref.quantize_kv(vf)
        pools = {
            "bf16": (torch.bfloat16, kf.bfloat16(), vf.bfloat16(), {},
                     kf.bfloat16(), vf.bfloat16(), BF16_TOL),
            "int8": (torch.bfloat16, kq, vq, dict(k_scale=ks, v_scale=vs),
                     ref.dequantize_pages(kq, ks),
                     ref.dequantize_pages(vq, vs), BF16_TOL),
            "f32": (torch.float32, kf, vf, {}, kf, vf, F32_TOL)}
        tables = _tables(torch, 2, mp, n_pages, seed=12)
        forked = torch.cat([tables[0][:mp // 2], tables[1][mp // 2:]])
        g = torch.Generator(device="cuda").manual_seed(13)
        for kind, (dt, kp, vp, sc, kd, vd, tol) in pools.items():
            n = 0
            for c in range(2, 10):
                q = torch.randn(c, kvh * group, d, generator=g,
                                device="cuda").to(dt)
                for valid in sorted({1, c // 2, c - 1}):
                    dead = torch.arange(c, device="cuda") >= valid
                    for row in (tables[0], forked):
                        for start in (1, page, mp * page - 10):
                            st = torch.tensor(start, dtype=torch.int32,
                                              device="cuda")
                            va = torch.tensor(valid, dtype=torch.int32,
                                              device="cuda")
                            got = ops.paged_prefill_attention(
                                q, kp, vp, row, st, va, **sc)
                            want = ref.paged_verify_attention_ref(
                                q, kd, vd, row, st, va)
                            torch.cuda.synchronize()
                            err = (got.float() - want.float()).abs().max()
                            err = err.item()
                            if not err <= tol or not (got[dead] == 0).all():
                                raise AssertionError(
                                    f"verify {wname} {kind} C={c} valid="
                                    f"{valid} start={start}: max abs err "
                                    f"{err} (bound {tol}) or dead rows not 0")
                            errs[kind] = max(errs[kind], err)
                            n += 1
            log(f"verify check {wname} (KVH {kvh}, G {group}, D {d}, page "
                f"{page}) {kind} pool: {n} bundles, C 2-9, max abs err "
                f"{errs[kind]:.3e} (bound {tol}); padded rows exact 0")
    return errs


def check_spec_fleet_shapes(torch, ops, pk):
    """The paged kernels at the other shapes phases 23-25 give them, at the
    main width over bf16 and f32 pools, against their plain versions:
    decode of 1 row over MAX_LEN / PAGE-entry tables (the draft model's
    greedy steps), of FLEET_SLOTS rows over FLEET_MAX_LEN / PAGE-entry
    tables (the chaos engines) and over MAX_LEN / PAGE-entry ones (phase
    24's engines), one row idle; the chunk kernel at C = DRAFT_CHUNK (the
    draft's catch-up) with valid < C from position 0, from a page boundary
    and deep in the table, and with valid = C; the hinted mixed step with
    num_decode = FLEET_SLOTS (and unhinted) over the chaos engines' tables.
    Dead rows must be exact zeros. Returns max abs error per kernel over
    the bf16 cases."""
    kvh, group, d, page = PAGED_WIDTHS[MAIN_WIDTH]
    n_pages = 400
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mp_main, mp_fleet = -(-MAX_LEN // page), -(-FLEET_MAX_LEN // page)
    kf, vf = _pools(torch, n_pages, torch.float32, seed=17)
    kf, vf = kf[0], vf[0]
    errs = {}
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
        kp, vp = kf.to(dtype), vf.to(dtype)
        g = torch.Generator(device="cuda").manual_seed(18)
        e = dict.fromkeys(("paged_attention_bkgd",
                           "paged_prefill_attention_ckgd",
                           "paged_mixed_attention_rkgd"), 0.0)

        def compare(name, got, want, dead, label):
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            if not err <= tol or (dead.any() and not (got[dead] == 0).all()):
                raise AssertionError(f"{name} [{label}]: max abs err {err} "
                                     f"(bound {tol}) or dead rows not 0")
            e[name] = max(e[name], err)

        splits = []
        for mp, lens in ((mp_main, [1]), (mp_main, [page + 1]),
                         (mp_main, [400]), (mp_main, [MAX_LEN]),
                         (mp_fleet, [0, page + 1, 100, FLEET_MAX_LEN]),
                         (mp_main, [250, 0, 1, MAX_LEN - 3])):
            rows = len(lens)
            lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
            tables = _tables(torch, rows, mp, n_pages, seed=19 + rows)
            q = torch.randn(rows, kvh * group, d, generator=g,
                            device="cuda").to(dtype)
            compare("paged_attention_bkgd",
                    ops.paged_attention(q, kp, vp, tables, lengths),
                    ops.paged_attention(q, kp, vp, tables, lengths,
                                        impl="ref"),
                    lengths == 0, f"{rows} rows x {mp} pages, lengths {lens}")
            splits.append((rows, mp, *pk.decode_splits(rows, kvh, mp, sms)))
        table = _tables(torch, 1, mp_main, n_pages, seed=23)[0]
        qc = torch.randn(DRAFT_CHUNK, kvh * group, d, generator=g,
                         device="cuda").to(dtype)
        for start, valid in ((0, 20), (2 * page, DRAFT_CHUNK - 1),
                             (MAX_LEN - 2 * DRAFT_CHUNK, 17),
                             (0, DRAFT_CHUNK)):
            st = torch.tensor(start, dtype=torch.int32, device="cuda")
            va = torch.tensor(valid, dtype=torch.int32, device="cuda")
            compare("paged_prefill_attention_ckgd",
                    ops.paged_prefill_attention(qc, kp, vp, table, st, va),
                    ops.paged_prefill_attention(qc, kp, vp, table, st, va,
                                                impl="ref"),
                    torch.arange(DRAFT_CHUNK, device="cuda") >= valid,
                    f"C {DRAFT_CHUNK} start {start} valid {valid}")
        lengths = torch.tensor([0, page + 1, 100, FLEET_MAX_LEN - CHUNK],
                               dtype=torch.int32, device="cuda")
        tables = _tables(torch, FLEET_SLOTS, mp_fleet, n_pages, seed=24)
        cpos = torch.arange(CHUNK, dtype=torch.int32, device="cuda")
        last_pos = torch.cat([lengths - 1,
                              torch.where(cpos < 41, 23 + cpos, -1)])
        mtables = torch.cat([tables, tables[2:3].expand(CHUNK, mp_fleet)])
        mtables = mtables.contiguous()
        qm = torch.randn(FLEET_SLOTS + CHUNK, kvh * group, d, generator=g,
                         device="cuda").to(dtype)
        want = ops.paged_mixed_attention(qm, kp, vp, mtables, last_pos,
                                         impl="ref")
        for hint in (FLEET_SLOTS, None):
            compare("paged_mixed_attention_rkgd",
                    ops.paged_mixed_attention(qm, kp, vp, mtables, last_pos,
                                              num_decode=hint),
                    want, last_pos < 0, f"num_decode={hint}")
        log(f"spec/fleet shapes {str(dtype).removeprefix('torch.')} "
            f"{MAIN_WIDTH}: decode (rows, table, splits, pages a split) "
            f"{sorted(set(splits))} {e['paged_attention_bkgd']:.3e}; chunk C "
            f"{DRAFT_CHUNK} {e['paged_prefill_attention_ckgd']:.3e}; mixed "
            f"{FLEET_SLOTS} decode rows + {CHUNK} over {mp_fleet}-entry "
            f"tables {e['paged_mixed_attention_rkgd']:.3e} (bound {tol}); "
            f"dead rows exact 0")
        if dtype == torch.bfloat16:
            errs = e
    return errs


def time_verify(torch, F, ops, ref):
    """Kernel 2 at one verify bundle of the spec engine (C = SPEC_K + 1 =
    VERIFY_C rows at positions 400.., the main width, 32 layers' pools
    cycled), its plain version (``paged_verify_attention_ref``) and SDPA on
    the gathered dense K/V, as row 2 is timed."""
    kvh, group, d, page = PAGED_WIDTHS[MAIN_WIDTH]
    mp = -(-MAX_LEN // page)
    n_pages = SLOTS * mp + 1
    dt = torch.bfloat16
    kp, vp = _pools(torch, n_pages, dt, layers=LAYERS, seed=14)
    table = _tables(torch, 1, mp, n_pages, seed=15)[0]
    g = torch.Generator(device="cuda").manual_seed(16)
    c, s0 = VERIFY_C, 400
    q = torch.randn(c, kvh * group, d, generator=g, device="cuda").to(dt)
    st = torch.tensor(s0, dtype=torch.int32, device="cuda")
    va = torch.tensor(c, dtype=torch.int32, device="cuda")
    n = s0 + c
    dense = []
    for i in range(LAYERS):
        kv = [x[i][table.long()].reshape(-1, kvh, d)[:n].permute(1, 0, 2)
              .repeat_interleave(group, dim=0)[None] for x in (kp, vp)]
        dense.append(kv)
    kpos = torch.arange(n, device="cuda")
    mask = (kpos[None, :] <= s0 + torch.arange(c, device="cuda")[:, None])
    qd = q.transpose(0, 1)[None]
    scale = d ** -0.5
    r = dict(
        kernel=lambda i: ops.paged_prefill_attention(
            q, kp[i % LAYERS], vp[i % LAYERS], table, st, va, scale=scale),
        plain=lambda i: ref.paged_verify_attention_ref(
            q, kp[i % LAYERS], vp[i % LAYERS], table, st, va, scale=scale),
        library=lambda i: F.scaled_dot_product_attention(
            qd, *dense[i % LAYERS], attn_mask=mask[None, None]))
    bound = _bound(n, sum(s0 + 1 + j for j in range(c)), c, mp, 2, 2)
    p1 = _time_ms(torch, r["plain"])
    k1 = _time_ms(torch, r["kernel"])
    k2 = _time_ms(torch, r["kernel"])
    p2 = _time_ms(torch, r["plain"])
    lib = _time_ms(torch, r["library"])
    log(f"timing paged_prefill_attention_ckgd at verify width [C {c}, "
        f"start {s0}, {MAIN_WIDTH}]: kernel {k1:.4f}/{k2:.4f} ms, plain "
        f"{p1:.4f}/{p2:.4f} ms, sdpa {lib:.4f} ms, bound {bound[0]:.5f} ms "
        f"({bound[1]})")
    return dict(ms=min(k1, k2), plain_ms=min(p1, p2), library_ms=lib,
                bound_ms=bound[0], bound_by=bound[1])


class _RandomProposer:
    """Drafts k random tokens for every slot: every bundle dispatches and
    nearly every draft is rejected (the rollback path)."""

    def __init__(self, seed, vocab):
        import numpy as np

        self.rng, self.vocab = np.random.default_rng(seed), vocab

    def propose(self, uid, history, k):
        return [int(t) for t in self.rng.integers(1, self.vocab, k)]

    def retire(self, uid):
        return None


def _spec_counts(engine):
    u = engine.utilization
    return dict(bundles=engine.stats["spec_bundles"],
                proposed=u.spec_proposed, accepted=u.spec_accepted,
                rollbacks=u.spec_rollbacks)


def _host_split(engine):
    """Wrap the engine's proposal, verify and plain-step calls with wall
    clocks (each ends in a host sync: a draft argmax, the sampled tokens
    to the host), to split its step time by where the host waits."""
    acc = {"propose": 0.0, "verify": 0.0, "step": 0.0}

    def timed(key, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            acc[key] += time.perf_counter() - t0
            return out
        return run

    engine._propose_bundles = timed("propose", engine._propose_bundles)
    engine.executor.verify = timed("verify", engine.executor.verify)
    engine.executor.step = timed("step", engine.executor.step)
    return acc


def _oracle_acceptance(torch, cfg, params, serving, reqs, plain=True):
    """An oracle draft (the target's own weights) on ``reqs`` through the
    kernels and (``plain``) through the plain versions (``attn_impl="ref"``,
    target and draft alike): {impl: spec counts and the streams}."""
    out = {}
    for impl in ("kernels", "plain")[:1 + plain]:
        engine = serving.ContinuousBatchingEngine(
            cfg, params, max_len=MAX_LEN, max_slots=SLOTS, page_size=PAGE,
            prefill_chunk=CHUNK, device="cuda", speculative="draft",
            spec_k=SPEC_K, draft_config=cfg, draft_params=params,
            attn_impl="ref" if impl == "plain" else None)
        handles, _ = _drive(torch, engine, reqs)
        out[impl] = dict(_spec_counts(engine),
                         streams=[list(h.tokens) for h in handles])
    return out


def run_spec_engine(torch, np, cfg, serving, models, pk, card):
    """Phase 23: full-width smollm-360m (bf16) serving the first
    SPEC_REQUESTS requests of phase 4's trace with speculation off, ngram
    and a 2-layer smollm draft on its own seeded weights (drafts mostly
    rejected: the rollback path), SPEC_K drafts a bundle. Every request
    finishes by length and both pools drain. Then the oracle-draft witness:
    the first WITNESS_REQUESTS greedy requests (16 new tokens) with the
    target's own weights as the draft, through the kernels at each of
    WITNESS_DEPTHS and through the plain versions at the first and the
    last; at PARITY_LAYERS the kernels must land half the drafts or more
    (the commit path in bf16). Returns
    {path: launches}."""
    params = models.build_model(cfg, device="cuda").init(seed=0)
    # a small draft must share the target's vocabulary (the reduced
    # config's has 256 tokens): the target's widths cut to 2 layers
    small = dataclasses.replace(cfg, num_layers=PARITY_LAYERS)
    engine_kw = dict(max_len=MAX_LEN, max_slots=SLOTS, page_size=PAGE,
                     prefill_chunk=CHUNK, device="cuda")
    arms = (("off", {}),
            ("spec ngram", dict(speculative="ngram")),
            ("spec draft", dict(
                speculative="draft", draft_config=small,
                draft_params=models.build_model(small, device="cuda")
                .init(seed=5))))
    out = {}
    for path, kw in arms:
        if kw:
            kw = dict(kw, spec_k=SPEC_K)
        engine = serving.ContinuousBatchingEngine(cfg, params, **engine_kw,
                                                  **kw)
        split = _host_split(engine)
        rng = np.random.default_rng(0)
        _requests(serving, 2, rng, sampled_every=2)  # phase 4's warm-up draw
        trace = _requests(serving, 16, rng, sampled_every=2)
        reqs = trace[:SPEC_REQUESTS]
        pk.reset_launches()
        t0 = time.perf_counter()
        handles, steps = _drive(torch, engine, reqs)
        wall = time.perf_counter() - t0
        launches = dict(pk.LAUNCHES)
        results = [h.result() for h in handles]
        _check_served(np, cfg, results, 32)
        cache = engine.cache
        if cache.pool.available + cache.parked_count != cache.num_pages - 1:
            raise AssertionError(f"{path}: the page pool did not drain")
        dc = getattr(engine.spec, "cache", None)  # the draft model's pool
        if dc is not None:
            if (dc.free_slot_count != dc.max_slots
                    or dc.pool.available != dc.num_pages - 1):
                raise AssertionError(f"{path}: the draft pool did not drain")
        counts = _spec_counts(engine)
        # a random-weight model rarely repeats its history, so the ngram
        # arm may draft nothing here (phase 24 makes it draft)
        if "draft" in path and counts["bundles"] <= 0:
            raise AssertionError(f"{path}: no bundle dispatched")
        acc = counts["accepted"] / max(counts["proposed"], 1)
        _log_run(path, cfg, card, reqs, results, wall, steps,
                 f"decode_steps {engine.stats['decode_steps']}, spec "
                 f"{counts}, acceptance {acc:.3f}; host s: propose "
                 f"{split['propose']:.3f}, verify {split['verify']:.3f}, "
                 f"plain steps {split['step']:.3f}, rest "
                 f"{wall - sum(split.values()):.3f}; kernel launches "
                 f"{launches}")
        if kw:
            out[path] = launches
        del engine
    greedy = [serving.Request(r.uid, r.prompt, sampling=dataclasses.replace(
        r.sampling, max_new_tokens=16)) for r in trace
        if r.sampling.temperature <= 0][:WITNESS_REQUESTS]
    rates = []
    for depth in WITNESS_DEPTHS:
        c = dataclasses.replace(cfg, num_layers=depth)
        p = params if depth == cfg.num_layers else \
            models.build_model(c, device="cuda").init(seed=0)
        w = _oracle_acceptance(torch, c, p, serving, greedy,
                               plain=depth in (cfg.num_layers, PARITY_LAYERS))
        k = w["kernels"]
        rate = f"{depth} layers {k['accepted']}/{k['proposed']}"
        if "plain" in w:
            same = sum(a == b for a, b in zip(k["streams"],
                                              w["plain"]["streams"]))
            rate += (f" (plain {w['plain']['accepted']}/"
                     f"{w['plain']['proposed']}, streams equal {same}/"
                     f"{len(greedy)})")
        rates.append(rate)
        if depth == PARITY_LAYERS and 2 * k["accepted"] < k["proposed"]:
            raise AssertionError(f"{depth}-layer bf16 oracle draft landed "
                                 f"under half its drafts: {k}")
        del p
    log(f"oracle draft witness, bf16, {len(greedy)} greedy requests x 16 "
        f"tokens, accepted/proposed through the kernels: {'; '.join(rates)}")
    return out


def _spec_requests(serving, vocab, streams=None, n=6, new=16):
    """Greedy and seeded top-p requests alternating, on prompts of 40-150
    random tokens; given each prompt's spec-off stream ``s``, on ``prompt +
    s + prompt`` instead, a history that holds n-grams for the ngram
    proposer to continue."""
    import numpy as np

    rng = np.random.default_rng(21)
    reqs = []
    for i in range(n):
        prompt = rng.integers(1, vocab, int(rng.integers(40, 151))).tolist()
        if streams is not None:
            prompt = prompt + streams[i] + prompt
        sp = (serving.SamplingParams(temperature=0.8, top_p=0.9,
                                     max_new_tokens=new, seed=50 + i)
              if i % 2 else
              serving.SamplingParams(max_new_tokens=new, seed=50 + i))
        reqs.append(serving.Request(f"v{i}", prompt, sampling=sp))
    return reqs


def run_spec_parity(torch, np, cfg, serving, models):
    """Phase 24: f32, TF32 off, PARITY_LAYERS layers: greedy and seeded
    top-p streams with speculation on (ngram, an oracle draft, a random
    proposer) equal speculation off through the kernels and through the
    plain versions, on prompts that repeat themselves around their own
    spec-off streams (``_spec_requests``); every proposer dispatches
    bundles, the oracle draft lands drafts and the random proposer rolls
    back."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = dataclasses.replace(cfg, dtype="float32",
                                num_layers=PARITY_LAYERS)
    params = models.build_model(cfg32, device="cuda").init(seed=1)
    kw = dict(max_len=MAX_LEN, max_slots=4, page_size=PAGE,
              prefill_chunk=CHUNK, device="cuda")
    handles, _ = _drive(torch, serving.ContinuousBatchingEngine(
        cfg32, params, **kw), _spec_requests(serving, cfg.vocab_size))
    first = [list(h.tokens) for h in handles]
    arms = {"off": {}, "off plain": dict(attn_impl="ref"),
            "ngram": dict(speculative="ngram", spec_k=SPEC_K),
            "draft": dict(speculative="draft", spec_k=SPEC_K,
                          draft_config=cfg32, draft_params=params),
            "random": dict(speculative="ngram", spec_k=SPEC_K)}
    streams, counts = {}, {}
    for name, akw in arms.items():
        engine = serving.ContinuousBatchingEngine(cfg32, params, **kw, **akw)
        if name == "random":
            engine.spec = _RandomProposer(7, cfg.vocab_size)
        handles, _ = _drive(torch, engine,
                            _spec_requests(serving, cfg.vocab_size, first))
        streams[name] = [list(h.tokens) for h in handles]
        counts[name] = _spec_counts(engine)
    bad = [name for name in arms if streams[name] != streams["off"]]
    if bad:
        raise AssertionError(f"f32 spec streams differ from spec off: {bad}")
    if not (all(counts[a]["bundles"] > 0 for a in ("ngram", "draft", "random"))
            and counts["draft"]["accepted"] > 0
            and counts["random"]["rollbacks"] > 0):
        raise AssertionError(f"a spec path went unexercised: {counts}")
    log(f"spec parity: {PARITY_LAYERS} layers, f32: 6 streams of 16 tokens "
        f"(greedy and seeded top-p) identical with speculation off (kernels "
        f"and plain), ngram, oracle draft and random drafts; {counts}")


def _fleet_trace(vocab, n=8):
    """Bus payloads for the chaos runs: prompts of 40-150 tokens, greedy
    and seeded top-k, two unseeded (the supervisor stamps them), and one
    long stream to kill mid-decode."""
    import numpy as np

    rng = np.random.default_rng(31)
    payloads = []
    for i in range(n):
        payloads.append({
            "uid": f"c{i}",
            "prompt": rng.integers(1, vocab, int(rng.integers(40, 150)))
            .tolist(),
            "max_new_tokens": int(rng.integers(4, 12)),
            "temperature": 0.7 if i % 3 == 2 else 0.0,
            "top_k": 8 if i % 3 == 2 else 0,
            "seed": 1000 + i if i % 4 else None})
    payloads.append({"uid": "long", "prompt": rng.integers(1, vocab, 60)
                     .tolist(), "max_new_tokens": 40, "temperature": 0.7,
                     "top_k": 8, "seed": 4242})
    return payloads


def _chaos(torch, cfg, params, serving, pk, tmp, seed_base=777):
    """One fleet run over ``payloads`` on the card: 2 engine workers (3 at
    most), the long stream's owner killed once two of its tokens reached
    the client, against a single-engine oracle of the same payloads run
    first. Returns (states, oracle, supervisor, the paged kernels'
    launches from the fleet's start to the end of its run)."""
    from repro_torch.core import TopicBus
    from repro_torch.core.faults import FaultInjector, WorkerKillRule

    payloads = _fleet_trace(cfg.vocab_size)
    ekw = dict(max_len=FLEET_MAX_LEN, max_slots=FLEET_SLOTS, page_size=PAGE,
               prefill_chunk=CHUNK, device="cuda")
    oracle_eng = serving.ContinuousBatchingEngine(cfg, params, **ekw)
    handles = {}
    for i, pl in enumerate(payloads):
        q = dict(pl)
        if q.get("seed") is None:
            q["seed"] = serving.fleet_seed(seed_base, i)
        handles[q["uid"]] = oracle_eng.submit(serving.request_from_message(q))
    while not oracle_eng.idle:
        oracle_eng.step()
    oracle = {u: list(h.tokens) for u, h in handles.items()}
    del oracle_eng
    injector = FaultInjector()
    sup = serving.FleetSupervisor(
        TopicBus(Path(tmp) / "bus"),
        lambda: serving.ContinuousBatchingEngine(cfg, params, **ekw),
        serving.FleetConfig(workers=2, min_replicas=1, max_replicas=3,
                            beat_interval_s=0.01, seed_base=seed_base,
                            max_restarts=3),
        injector=injector)
    try:
        for pl in payloads:
            sup.submit(pl)
        pk.reset_launches()
        sup.start()
        deadline = time.monotonic() + 300
        while not ("long" in sup.states and sup.states["long"].owner
                   and len(sup.states["long"].tokens) >= 2):
            if time.monotonic() > deadline:
                raise AssertionError("the long stream never started")
            sup.poll()
            time.sleep(0.002)
        owner = sup.states["long"].owner.rsplit("-a", 1)[0]
        injector.worker_rules.append(
            WorkerKillRule(worker=owner, after_steps=0, times=1))
        done = sup.run(expected=[pl["uid"] for pl in payloads],
                       timeout_s=300)
        launches = dict(pk.LAUNCHES)
        if not done:
            raise AssertionError("fleet run timed out")
    finally:
        sup.shutdown()
    if injector.kills_armed() != 1 or sup.states["long"].resubmits < 1:
        raise AssertionError("the kill did not land on the long stream")
    return sup.results(), oracle, sup, launches


def _check_responses(sup, states):
    """Every request terminal; on ``responses`` each (uid, index) once, in
    order, before the uid's single finish."""
    seen, finishes = {}, {}
    for m in sup.bus.read("responses"):
        v = m.value
        if v["event"] == "delta":
            seen.setdefault(v["uid"], []).append(v["index"])
            if v["uid"] in finishes:
                raise AssertionError(f"{v['uid']}: delta after finish")
        elif v["uid"] in finishes:
            raise AssertionError(f"{v['uid']}: two finishes")
        else:
            finishes[v["uid"]] = v
    for uid, st in states.items():
        if st.finish_reason not in ("length", "stop"):
            raise AssertionError(f"{uid}: finished {st.finish_reason}")
        if seen.get(uid, []) != list(range(len(st.tokens))):
            raise AssertionError(f"{uid}: delta indices {seen.get(uid)}")


def _settled_memory(torch):
    """Device bytes allocated once dropped engines are collected, then the
    same once PyTorch's cuBLAS workspaces are cleared (one for each cuBLAS
    handle that ran a matmul: a thread takes its own handle, and the
    workspace outlives the thread)."""
    gc.collect()
    torch.cuda.synchronize()
    raw = torch.cuda.memory_allocated()
    torch._C._cuda_clearCublasWorkspaces()
    return raw, torch.cuda.memory_allocated()


def run_fleet(torch, np, cfg, serving, models, pk, card):
    """Phase 25: ``launch.serve --fleet 2`` at full width in a subprocess,
    then two chaos runs in this process (fleet workers are threads on the
    one card): f32 at PARITY_LAYERS, whose streams must equal the
    single-engine oracle with no mismatched delta, and bf16 at full width,
    where every request must be terminal and each (uid, index) on
    ``responses`` once (mismatches are printed: a replay can see other
    chunk boundaries, so bf16 rounding can differ). Device memory after
    the chaos runs, every engine collected and the cuBLAS workspaces
    cleared, must not exceed what it was before them: the killed workers'
    pools come back. Returns the bf16 fleet run's kernel launches."""
    with tempfile.TemporaryDirectory(prefix="serve_fleet_") as tmp:
        t0 = time.perf_counter()
        out = serve_cli("--fleet", "2", "--requests", "12", "--max-new", "8",
                        "--workdir", f"{tmp}/run")
        if "fleet served 12/12" not in out:
            raise AssertionError(f"serve --fleet 2: {out[-1500:]}")
        served = next(line for line in out.splitlines()
                      if line.startswith("fleet served"))
        log(f"serve driver --fleet 2 on {card} ({time.perf_counter() - t0:.1f}"
            f" s): {served}")
    raw0, mem0 = _settled_memory(torch)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = dataclasses.replace(cfg, dtype="float32",
                                num_layers=PARITY_LAYERS)
    params32 = models.build_model(cfg32, device="cuda").init(seed=1)
    with tempfile.TemporaryDirectory(prefix="chaos32_") as tmp:
        states, oracle, sup, _ = _chaos(torch, cfg32, params32, serving, pk,
                                        tmp)
        _check_responses(sup, states)  # reads the bus under tmp
    diff = [u for u, st in states.items() if st.tokens != oracle[u]]
    m = sup.metrics
    if diff or m.mismatched_deltas or m.gapped_deltas:
        raise AssertionError(f"f32 chaos: streams {diff} differ from the "
                             f"oracle; {m.format()}")
    log(f"fleet chaos f32 ({PARITY_LAYERS} layers): {len(states)} requests "
        f"equal the single-engine oracle; {m.format()}; recovery s "
        f"{[round(r, 4) for r in m.recovery_s]}")
    del sup, params32
    params = models.build_model(cfg, device="cuda").init(seed=0)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chaos16_") as tmp:
        states, oracle, sup, launches = _chaos(torch, cfg, params, serving,
                                               pk, tmp)
        _check_responses(sup, states)
    diff = [u for u, st in states.items() if st.tokens != oracle[u]]
    m = sup.metrics
    if m.gapped_deltas:
        raise AssertionError(f"bf16 chaos: gapped deltas; {m.format()}")
    log(f"fleet chaos bf16 {cfg.name} on {card} "
        f"({time.perf_counter() - t0:.1f} s with the oracle): "
        f"{len(states)} requests terminal, each (uid, index) once; "
        f"{len(diff)} streams differ from the oracle {diff}; "
        f"mismatched deltas {m.mismatched_deltas}; {m.format()}; kernel "
        f"launches {launches}")
    del sup, params
    raw1, mem1 = _settled_memory(torch)
    mib = 2 ** 20
    log(f"fleet chaos device memory: allocated {raw0 / mib:.1f} MiB before, "
        f"{raw1 / mib:.1f} MiB after (peak "
        f"{torch.cuda.max_memory_allocated() / mib:.1f} MiB); with the "
        f"cuBLAS workspaces cleared {mem0 / mib:.1f} MiB before, "
        f"{mem1 / mib:.1f} MiB after")
    if mem1 > mem0:
        raise AssertionError(f"fleet chaos: {(mem1 - mem0) / mib:.1f} MiB "
                             f"of device memory not returned")
    return launches


def check_put_tree(torch):
    """Phase 26: a tree of CUDA bf16 and f32 tensors (one requiring grad)
    and a host int tensor stores under the same refs as the same values
    on the CPU."""
    from repro_torch.core import ArtifactStore

    g = torch.Generator(device="cuda").manual_seed(41)
    dev = {"w": torch.randn(64, 32, generator=g, device="cuda").bfloat16(),
           "b": [torch.randn(32, generator=g, device="cuda")
                 .requires_grad_(True), (torch.arange(5), None)],
           "a": {"z": torch.randn(3, 4, generator=g, device="cuda").t()}}

    def to_cpu(x):
        if isinstance(x, dict):
            return {k: to_cpu(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(to_cpu(v) for v in x)
        return x.detach().cpu() if isinstance(x, torch.Tensor) else x

    with tempfile.TemporaryDirectory(prefix="put_tree_") as tmp:
        r_dev = ArtifactStore(f"{tmp}/d").put_tree(dev)
        store = ArtifactStore(f"{tmp}/h")
        r_cpu = store.put_tree(to_cpu(dev))
        if r_dev != r_cpu:
            raise AssertionError(f"put_tree refs differ: {r_dev} {r_cpu}")
        meta = store.get(r_cpu)
    log(f"put_tree on the card: CUDA bf16/f32 leaves give the CPU refs; "
        f"{meta['treedef']}")


# ---------------------------------------------------------------------------
# phases 27-29: the notebook pipeline, flash under autograd, the trainer
# ---------------------------------------------------------------------------

# the notebook of examples/notebook_to_pipeline.py
NOTEBOOK = [
    "import math\n"
    "samples = [math.sin(i / 7.0) + 0.1 * ((i * 2654435761) % 97 / 97.0)\n"
    "           for i in range(2000)]",
    "cleaned = [s for s in samples if abs(s) < 1.05]",
    "# %%pipe\n"
    "n = len(cleaned)\n"
    "mean = sum(cleaned) / n",
    "var = sum((s - mean) ** 2 for s in cleaned) / n\n"
    "std = math.sqrt(var)",
    "# %%pipe\n"
    "zscores = [(s - mean) / std for s in cleaned]",
    "outliers = [z for z in zscores if abs(z) > 2.0]\n"
    "report = {'n': n, 'mean': round(mean, 4), 'std': round(std, 4),\n"
    "          'outliers': len(outliers)}",
]


def run_notebook(torch):
    """Phase 27: the example notebook split, sealed, deployed and run with
    one chaos kill on the card."""
    from repro_torch.core import (ArtifactStore, Notebook, TopicBus,
                                  WorkflowScheduler, split_pipeline)
    from repro_torch.core.deployer import DynamicPodDeployer, PodManager
    from repro_torch.core.faults import FaultInjector, KillRule
    from repro_torch.core.scheduler import RetryPolicy

    nb = Notebook.from_sources(NOTEBOOK, name="analysis")
    graph = split_pipeline(nb)
    with tempfile.TemporaryDirectory(prefix="notebook_") as tmp:
        specs = DynamicPodDeployer(PodManager(graph), out_dir=Path(tmp, "k8s"),
                                   device="cuda").deploy_all()
        rendered = sorted(p.name for p in Path(tmp, "k8s").iterdir())
        if len(rendered) != 2 * len(graph.steps):
            raise AssertionError(f"notebook: rendered {rendered}")
        victim = sorted(graph.steps)[1]
        sched = WorkflowScheduler(
            graph, TopicBus(Path(tmp, "bus")), ArtifactStore(Path(tmp, "store")),
            retry=RetryPolicy(max_attempts=4, backoff_s=0.02),
            fault_injector=FaultInjector(
                [KillRule(step=victim, after_s=0.0, times=1)]),
            device="cuda")
        arts = sched.run(timeout_s=60)
        kinds = [e["kind"] for e in sched.events.history()]
    linear = nb.run_linear()
    if arts["report"] != linear["report"]:
        raise AssertionError(f"notebook: distributed report {arts['report']} "
                             f"!= linear {linear['report']}")
    if kinds.count("step_retry_scheduled") < 1:
        raise AssertionError(f"notebook: the chaos kill did not land: {kinds}")
    platforms = {n: st.image.capsule.platform for n, st in sched._state.items()}
    want = {"torch_backend": "cuda",
            "device_count": str(torch.cuda.device_count())}
    bad = {n: p for n, p in platforms.items()
           if any(p[k] != v for k, v in want.items())}
    if bad:
        raise AssertionError(f"notebook: capsules record {bad}, want {want}")
    log(f"notebook: {len(nb.cells)} cells -> {len(graph.steps)} steps "
        f"{[(s.name, s.role, s.replicas) for s in specs]}; {len(rendered)} "
        f"manifests; '{victim}' killed once, retried; report {arts['report']}"
        f" = the linear run's; capsules {want}, "
        f"{next(iter(platforms.values()))['torch_cuda']} CUDA, tag "
        f"{sched._state[victim].image.tag}")


def _grad_gap(got, want):
    """The largest |gap| over max(1, the largest |gradient|)."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1.0)).item()


def check_flash_grads(torch, ops, ref, fk):
    """Phase 28: the flash kernels under autograd against the plain
    version's autograd, and the backward kernel against its plain version,
    at every FLASH_GRAD_SHAPES entry, bf16 and f32. Returns the largest
    bf16 gradient gap at the training shape (the Function against the
    plain autograd) and the backward kernel's largest bf16 absolute error
    against ``ref.flash_attention_bwd`` there."""
    from repro_torch.models.attention import causal_flash

    worst, bwd_abs = {}, 0.0
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
        for wname, (b, sq, skv, h, kvh, d, causal) in \
                FLASH_GRAD_SHAPES.items():
            g = torch.Generator(device="cuda").manual_seed(43)
            # q, k, v on the op's (B, S, H, D) layouts, and a weight for a
            # loss whose upstream gradient depends on the output
            base = [torch.randn(b, n, m, d, generator=g, device="cuda")
                    .to(dtype) for n, m in ((sq, h), (skv, kvh), (skv, kvh))]
            w = torch.randn(b, sq, h, d, generator=g, device="cuda")
            real = FLASH_GRAD_REAL.get(wname, sq)  # causal_flash's length

            def grads(attend):
                q, k, v = (t[:, :real].detach().clone().requires_grad_()
                           if real < sq else t.detach().clone()
                           .requires_grad_() for t in base)
                out = attend(q, k, v)
                loss = (0.5 * out.float().square()
                        + w[:, :real] * out.float()).sum()
                return out, torch.autograd.grad(loss, (q, k, v))

            def kernel(q, k, v):
                if real < sq:  # padded to sq inside, as the models run it
                    return causal_flash(q, k, v, "auto")
                return ops.flash_attention(q, k, v, causal=causal,
                                           block_kv=skv if skv % 256 else 256)

            n0 = dict(fk.LAUNCHES)
            out, got = grads(kernel)
            if (type(out.grad_fn).__name__ != "FlashAttentionFunctionBackward"
                    and real == sq) or {
                        n: fk.LAUNCHES[n] - n0[n] for n in n0} != {
                        "flash_attention_bhsd": 1, "flash_attention_bwd": 1}:
                raise AssertionError(
                    f"flash grads [{wname}]: the Function did not run one "
                    f"forward and one backward kernel: {fk.LAUNCHES} after "
                    f"{n0}")
            _, again = grads(kernel)
            torch.cuda.synchronize()
            if not all(torch.equal(a, c) for a, c in zip(got, again)):
                raise AssertionError(f"flash grads [{wname}]: two backward "
                                     f"runs differ")
            _, want = grads(lambda q, k, v: ref.flash_attention_chunked(
                q, k, v, causal=causal, chunk_kv=k.shape[1]))
            # the backward kernel alone against its plain version
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in base)
            dot = w.to(dtype).transpose(1, 2).contiguous()
            with torch.no_grad():
                o, lse = fk.flash_attention_bhsd(qt, kt, vt, causal=causal,
                                                 return_lse=True)
                kern = fk.flash_attention_bwd(qt, kt, vt, o, dot, lse,
                                              causal=causal)
                plain = ref.flash_attention_bwd(
                    *base, o.transpose(1, 2), w.to(dtype), lse,
                    causal=causal, block_kv=skv)
            torch.cuda.synchronize()
            errs = [_grad_gap(a, r) for a, r in zip(got, want)] + [
                _grad_gap(a.transpose(1, 2), r) for a, r in zip(kern, plain)]
            label = f"{str(dtype).removeprefix('torch.')} {wname}"
            worst[label] = max(errs)
            if dtype == torch.bfloat16 and wname == "train D 64":
                bwd_abs = max((a.transpose(1, 2).float() - r.float()).abs()
                              .max().item() for a, r in zip(kern, plain))
            if not max(errs) <= tol:
                raise AssertionError(
                    f"flash grads [{label}]: dq/dk/dv gaps (the Function vs "
                    f"the plain autograd; the backward kernel vs "
                    f"ref.flash_attention_bwd) {errs} > {tol}")
    log("flash gradient check (the forward and backward kernels in the "
        "autograd Function vs the plain version's autograd, and the "
        "backward kernel vs ref.flash_attention_bwd; max |gap| over max(1, "
        "max |grad|); two backward runs bit-equal): "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
        + f" (bounds bf16 {BF16_TOL}, f32 {F32_TOL}); shapes (B, Sq, Skv, "
        f"H, KVH, D, causal) {FLASH_GRAD_SHAPES}, causal_flash at "
        f"{FLASH_GRAD_REAL}")
    return worst["bfloat16 train D 64"], bwd_abs


def _flash_bwd_bound(b, sq, skv, h, kvh, d, causal, elt):
    """Least time for one backward call: q, k, v, o, dO and lse read once
    and dq, dk, dv written once, against five products (S, dV, dP, dQ,
    dK) of 2 D FLOPs a head per attended (query, key) pair. Returns (ms,
    'bytes' | 'operations')."""
    nbytes = elt * d * b * (4 * h * sq + 4 * kvh * skv) + 4 * b * h * sq
    off = skv - sq
    pairs = (sum(off + i + 1 for i in range(sq)) if causal else sq * skv) * b
    flops = 5 * 2 * d * h * pairs
    rate = BF16_FLOP_PER_S if elt == 2 else F32_FLOP_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _check_bwd(torch, label, got, again, want):
    """The backward kernel's (B, H, S, D) dq, dk, dv against the plain
    version's (B, S, H, D) on the same inputs: each within BF16_TOL of its
    gradient's scale (``_grad_gap``), and a second call bit-equal. Returns
    the largest gap."""
    torch.cuda.synchronize()
    gaps = [_grad_gap(a.transpose(1, 2), r) for a, r in zip(got, want)]
    if not max(gaps) <= BF16_TOL:
        raise AssertionError(f"flash backward {label}: dq/dk/dv gaps vs "
                             f"ref.flash_attention_bwd {gaps} > {BF16_TOL}")
    if not all(torch.equal(a, c) for a, c in zip(got, again)):
        raise AssertionError(f"flash backward {label}: two calls differ")
    return max(gaps)


# phase 28's training shapes (label, B, S, layers whose inputs the timing
# cycles over): phase 29's and phase 38's smollm-360m flash calls (15 / 5
# heads, D 64, causal, bf16)
FLASH_TRAIN_SHAPES = (("train", 16, 64, LAYERS), ("train_4k", 4, 4096, 4))


def time_flash_train(torch, F, ops, ref, fk):
    """Flash at FLASH_TRAIN_SHAPES. The forward (kernel, plain version,
    SDPA) against its bound; the backward alone (kernel, ``ref.flash_
    attention_bwd``, SDPA's backward through autograd) against its bound,
    the kernel held against the plain version on one layer's inputs
    (``_check_bwd``); forward + backward (``ops.flash_attention``'s
    autograd Function, the plain version's autograd, SDPA's). Returns the
    kernels line's entries: flash's ``train`` and the backward kernel's
    times."""
    h, kvh, d = FLASH_H, KVH, D
    rows = {}
    for label, b, s, layers in FLASH_TRAIN_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(44)

        def make(n, grad=False):
            return torch.randn(layers, b, s, n, d, generator=g,
                               device="cuda").to(
                torch.bfloat16).requires_grad_(grad)

        q, k, v = make(h, True), make(kvh, True), make(kvh, True)
        up = make(h)
        qt, kt, vt, ut = (x.detach().transpose(2, 3).contiguous()
                          for x in (q, k, v, up))
        with torch.no_grad():
            stats = [fk.flash_attention_bhsd(qt[l], kt[l], vt[l],
                                             causal=True, return_lse=True)
                     for l in range(layers)]
            outs = [o.transpose(1, 2) for o, _ in stats]
        # SDPA's graphs, kept for its backward alone
        sdpa_in = [tuple(x[l].detach().requires_grad_() for x in (qt, kt, vt))
                   for l in range(layers)]
        sdpa_outs = [F.scaled_dot_product_attention(
            *xs, is_causal=True, enable_gqa=True) for xs in sdpa_in]

        def kernel(i):
            l = i % layers
            fk.flash_attention_bhsd(qt[l], kt[l], vt[l], causal=True)

        def plain(i):
            l = i % layers
            with torch.no_grad():
                ref.flash_attention_chunked(q[l], k[l], v[l], causal=True,
                                            chunk_kv=256)

        def library(i):
            l = i % layers
            F.scaled_dot_product_attention(qt[l], kt[l], vt[l],
                                           is_causal=True, enable_gqa=True)

        def bwd_kernel(i):
            l = i % layers
            return fk.flash_attention_bwd(qt[l], kt[l], vt[l], stats[l][0],
                                          ut[l], stats[l][1], causal=True)

        def bwd_plain(i):
            l = i % layers
            return ref.flash_attention_bwd(
                q[l].detach(), k[l].detach(), v[l].detach(), outs[l], up[l],
                stats[l][1], causal=True, block_kv=256)

        def bwd_library(i):
            l = i % layers
            torch.autograd.grad(sdpa_outs[l], sdpa_in[l], ut[l],
                                retain_graph=True)

        def both(attend):
            def fn(i):
                l = i % layers
                ql, kl, vl = q[l], k[l], v[l]
                torch.autograd.grad(attend(ql, kl, vl), (ql, kl, vl), up[l])
            return fn

        fwd_bwd = {
            "kernel": both(lambda q_, k_, v_: ops.flash_attention(
                q_, k_, v_)),
            "plain": both(lambda q_, k_, v_: ref.flash_attention_chunked(
                q_, k_, v_, causal=True, chunk_kv=256)),
            "sdpa": both(lambda q_, k_, v_: F.scaled_dot_product_attention(
                q_.transpose(1, 2), k_.transpose(1, 2), v_.transpose(1, 2),
                is_causal=True, enable_gqa=True).transpose(1, 2)),
        }
        short = s == 64
        n_fast, n_slow = (64, 32) if short else (8, 2)
        p1 = _time_ms(torch, plain, iters=n_slow, warmup=2)
        k1 = _time_ms(torch, kernel, iters=n_fast)
        k2 = _time_ms(torch, kernel, iters=n_fast)
        p2 = _time_ms(torch, plain, iters=n_slow, warmup=2)
        lib = _time_ms(torch, library, iters=n_fast)
        bp1 = _time_ms(torch, bwd_plain, iters=n_slow, warmup=2)
        bk1 = _time_ms(torch, bwd_kernel, iters=n_fast)
        bk2 = _time_ms(torch, bwd_kernel, iters=n_fast)
        bp2 = _time_ms(torch, bwd_plain, iters=n_slow, warmup=2)
        blib = _time_ms(torch, bwd_library, iters=n_fast)
        gap = _check_bwd(torch, label, bwd_kernel(0), bwd_kernel(0),
                         bwd_plain(0))
        # 8 calls: their ~100 autograd launches each stay inside the sleep
        # kernel's ~0.1 s, so the host's enqueue time stays out
        both_ms = {name: _time_ms(torch, fn, iters=8 if short or
                                  name != "plain" else 2, warmup=2)
                   for name, fn in fwd_bwd.items()}
        bound = _flash_bound(b, s, s, True, 2)
        bwd_bound = _flash_bwd_bound(b, s, s, h, kvh, d, True, 2)
        log(f"timing flash {label} (B {b}, S {s}, H {h}, KVH {kvh}, causal, "
            f"bf16): forward kernel {k1:.4f}/{k2:.4f} ms, plain "
            f"{p1:.4f}/{p2:.4f} ms, sdpa {lib:.4f} ms, bound "
            f"{bound[0]:.5f} ms ({bound[1]}); backward kernel "
            f"{bk1:.4f}/{bk2:.4f} ms, plain {bp1:.4f}/{bp2:.4f} ms, sdpa "
            f"{blib:.4f} ms, bound {bwd_bound[0]:.5f} ms ({bwd_bound[1]}), "
            f"gap vs plain {gap:.3e} (bound {BF16_TOL}; two calls "
            f"bit-equal); forward + backward: autograd Function "
            f"{both_ms['kernel']:.4f} ms, plain autograd "
            f"{both_ms['plain']:.4f} ms, sdpa {both_ms['sdpa']:.4f} ms")
        rows[label] = dict(
            fwd=dict(ms=min(k1, k2), plain_ms=min(p1, p2), library_ms=lib,
                     bound_ms=bound[0], bound_by=bound[1],
                     fwd_bwd_ms=both_ms["kernel"],
                     plain_fwd_bwd_ms=both_ms["plain"],
                     library_fwd_bwd_ms=both_ms["sdpa"]),
            bwd=dict(ms=min(bk1, bk2), plain_ms=min(bp1, bp2),
                     library_ms=blib, bound_ms=bwd_bound[0],
                     bound_by=bwd_bound[1], max_gap=gap))
        del q, k, v, up, qt, kt, vt, ut, stats, outs, sdpa_in, sdpa_outs
    widths = time_flash_bwd_widths(torch, F, fk, ref)
    return rows["train"]["fwd"], dict(**rows["train"]["bwd"], train_4k=dict(
        **rows["train_4k"]["bwd"], forward=rows["train_4k"]["fwd"]),
        **widths)


# phase 28: the backward alone at the other trainers' head dims, S 4096
# (B, H, KVH, D): zamba2-2.7b's D 80 and dbrx's / internvl2's group of 6
FLASH_BWD_WIDTHS = {"zamba2 D80": (1, 32, 32, 80),
                    "group 6 D128": (1, 48, 8, 128)}


def time_flash_bwd_widths(torch, F, fk, ref, s=4096, layers=4):
    """Phase 28's backward kernel alone at FLASH_BWD_WIDTHS (causal, bf16,
    S 4096, cycling over 4 layers' inputs) beside SDPA's backward through
    autograd and ``_flash_bwd_bound``, held against ``ref.flash_attention_
    bwd`` on one layer's inputs (``_check_bwd``); and the wrapper's host
    enqueue time at the short training shape (B 16 x S 64: 1000 calls, no
    synchronise; it builds four tensor maps a call). Returns {label:
    times, ..., "host_enqueue_us": x}."""
    out = {}
    for label, (b, h, kvh, d) in FLASH_BWD_WIDTHS.items():
        g = torch.Generator(device="cuda").manual_seed(45)
        sets = []
        for _ in range(layers):
            q, up = (torch.randn(b, h, s, d, generator=g, device="cuda")
                     .to(torch.bfloat16) for _ in range(2))
            k, v = (torch.randn(b, kvh, s, d, generator=g, device="cuda")
                    .to(torch.bfloat16) for _ in range(2))
            with torch.no_grad():
                o, lse = fk.flash_attention_bhsd(q, k, v, causal=True,
                                                 return_lse=True)
            xs = tuple(x.detach().requires_grad_() for x in (q, k, v))
            sets.append((q, k, v, o, up, lse, xs,
                         F.scaled_dot_product_attention(
                             *xs, is_causal=True, enable_gqa=True)))

        def kernel(i):
            q, k, v, o, up, lse, _, _ = sets[i % layers]
            return fk.flash_attention_bwd(q, k, v, o, up, lse, causal=True)

        def library(i):
            _, _, _, _, up, _, xs, o = sets[i % layers]
            torch.autograd.grad(o, xs, up, retain_graph=True)

        k1 = _time_ms(torch, kernel, iters=8, warmup=2)
        lib = _time_ms(torch, library, iters=8, warmup=2)
        k2 = _time_ms(torch, kernel, iters=8, warmup=2)
        q, k, v, o, up, lse, _, _ = sets[0]
        gap = _check_bwd(torch, label, kernel(0), kernel(0),
                         ref.flash_attention_bwd(
                             *(x.transpose(1, 2) for x in (q, k, v, o, up)),
                             lse, causal=True, block_kv=256))
        bound = _flash_bwd_bound(b, s, s, h, kvh, d, True, 2)
        log(f"timing flash backward {label} (B {b}, S {s}, H {h}, KVH {kvh}, "
            f"D {d}, causal, bf16): kernel {k1:.4f}/{k2:.4f} ms, sdpa "
            f"backward {lib:.4f} ms, bound {bound[0]:.5f} ms ({bound[1]}), "
            f"gap vs plain {gap:.3e} (bound {BF16_TOL}; two calls "
            f"bit-equal)")
        out[label] = dict(ms=min(k1, k2), library_ms=lib, bound_ms=bound[0],
                          bound_by=bound[1], max_gap=gap)
        del sets
    g = torch.Generator(device="cuda").manual_seed(46)
    q, up = (torch.randn(16, FLASH_H, 64, D, generator=g, device="cuda")
             .to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(16, KVH, 64, D, generator=g, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    with torch.no_grad():
        o, lse = fk.flash_attention_bhsd(q, k, v, causal=True, return_lse=True)
    for _ in range(20):
        fk.flash_attention_bwd(q, k, v, o, up, lse)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(1000):
        fk.flash_attention_bwd(q, k, v, o, up, lse)
    host = (time.perf_counter() - t0) / 1000 * 1e6
    torch.cuda.synchronize()
    log(f"flash backward host enqueue (B 16 x S 64): {host:.1f} us a call "
        f"(1000 calls, no synchronise)")
    out["host_enqueue_us"] = host
    return out


def _trace_train(torch, cfg, run, steps):
    """A torch.profiler window over ``steps`` full-width train steps of
    ``run`` (a TRAIN_RUNS entry; after one warm step): device busy share,
    the flash and SSD kernels' shares of it, the top ops."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data import DataConfig, SyntheticCorpus
    from repro_torch.models import build_model, frontend_len
    from repro_torch.train import AdamWConfig, init_train_state, make_train_step

    model = build_model(cfg, device="cuda")
    opt = AdamWConfig(lr=run["lr"], warmup_steps=10, decay_steps=400,
                      weight_decay=0.0, moment_dtype="float32")
    state = init_train_state(model, 0, opt)
    step = make_train_step(model, opt)
    corpus = SyntheticCorpus(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=run["seq"],
        global_batch=run["batch"], frames=cfg.is_encoder_decoder,
        vision_tokens=frontend_len(cfg), d_model=cfg.d_model,
        dtype=cfg.dtype))
    dt = getattr(torch, cfg.dtype)
    batches = [{k: torch.as_tensor(v, device="cuda").to(
        dt if k in ("frames", "vision_embeds") else torch.int32)
        for k, v in corpus.batch_at(i).items()} for i in range(steps + 1)]
    state, m = step(state, batches[0])
    float(m["loss"])
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches[1:]:
            state, m = step(state, b)
            float(m["loss"])
        wall_ms = (time.perf_counter() - t0) * 1e3
    del state, model
    by_name = _device_times(prof)
    busy_ms = sum(ms for ms, _ in by_name.values())
    if busy_ms <= 0:
        log(f"train trace {cfg.name}: the profiler recorded no device time "
            f"(not measured)")
        return None
    shares = {label: sum(ms for name, (ms, _) in by_name.items()
                         if any(k in name for k in keys))
              for label, keys in (("flash", FLASH_TRACE_KEYS),
                                  ("flash backward", FLASH_BWD_TRACE_KEYS),
                                  ("ssd", SSD_TRACE_KEYS))}
    log(f"train trace {cfg.name}: {steps} steps in {wall_ms:.1f} ms wall "
        f"({wall_ms / steps:.2f} ms/step); device busy {busy_ms:.1f} ms = "
        f"{100 * busy_ms / wall_ms:.1f}% (idle "
        f"{100 - 100 * busy_ms / wall_ms:.1f}%); "
        + "; ".join(f"{k} kernels {ms:.2f} ms = {100 * ms / busy_ms:.1f}% of "
                    f"busy" for k, ms in shares.items())
        + f"; {sum(n for _, n in by_name.values())} device ops")
    top = sorted(by_name.items(), key=lambda kv: kv[1][0], reverse=True)[:8]
    for name, (ms, n) in top:
        log(f"train trace top: {ms:9.2f} ms x{n:6d}  {name[:90]}")
    return busy_ms / wall_ms


def _time_restore(torch, cfg, ckpt_dir):
    """Seconds to restore the latest checkpoint under ``ckpt_dir`` (the
    whole train state, integrity checked) onto the card, and its bytes."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map
    from repro_torch.train import AdamWConfig
    from repro_torch.train.step import abstract_train_state

    ck = CheckpointManager(ckpt_dir)
    like = abstract_train_state(build_model(cfg, device="meta"),
                                AdamWConfig(moment_dtype="float32"))
    t0 = time.perf_counter()
    state, _ = ck.restore(like)
    state = tree_map(lambda x: x.to("cuda"), state)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    nbytes = sum(f.stat().st_size
                 for f in ck._step_dir(ck.latest_step()).iterdir())
    del state
    return seconds, nbytes


def _train_args(train, tmp, name, run, *extra):
    return train.parse_args([
        "--arch", run["arch"], "--batch", str(run["batch"]), "--seq-len",
        str(run["seq"]), "--workdir", f"{tmp}/{name}", *extra])


def _longest_beat_gap(bus, prefix):
    """The longest time between two heartbeats of one pod whose name
    starts with ``prefix`` (the scheduler's liveness probe kills a pod at
    30 s), over the bus's health topic."""
    last, worst = {}, 0.0
    for m in bus.read("health"):
        pod = m.value["pod"]
        if pod.startswith(prefix):
            if pod in last:
                worst = max(worst, m.ts - last[pod])
            last[pod] = m.ts
    return worst


def run_train(torch, cfg, fk, pk, sk, card, must):
    """Phases 29, 31, 32, 36: ``launch.train`` at full width as TRAIN_RUNS
    gives it for ``cfg`` (bf16 parameters, f32 moments), its stats and a
    profiler window. The loss must improve and the eval loss lie below the
    first step's; with ``--chaos`` the train step must be retried twice
    and the third attempt start within 64 MiB of the first's device
    memory; every kernel in ``must`` must launch. Returns the launches of
    every kernel (counts reset just before the run, read just after)."""
    from repro_torch.launch import train

    run = TRAIN_RUNS[cfg.name]
    if run["layers"]:
        cfg = dataclasses.replace(cfg, num_layers=run["layers"])
    mib = 2 ** 20
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    for mod in (fk, pk, sk):
        mod.reset_launches()
    with tempfile.TemporaryDirectory(prefix="train_") as tmp:
        t0 = time.perf_counter()
        arts, sched, stats = train.run(_train_args(
            train, tmp, "full", run, "--steps", str(run["steps"]),
            "--ckpt-every", str(run["ckpt_every"]), "--lr", str(run["lr"]),
            *(("--chaos",) if run["chaos"] else ())), cfg=cfg)
        wall = time.perf_counter() - t0
        launches = _path_launches(pk, sk, fk)
        scan_paths = dict(sk.LAUNCHES_BY_PATH)
        retries = [e for e in sched.events.history("step_retry_scheduled")
                   if e["step"] == "train"]
        errors = [(e["attempt"], e["error"][:200]) for e in
                  sched.events.history("step_error") if e["step"] == "train"]
        kills = [e["attempt"] for e in
                 sched.events.history("pod_liveness_kill")
                 if e["step"] == "train"]
        gap = _longest_beat_gap(sched.bus, "train-a")
        gc.collect()
        after = torch.cuda.memory_allocated()
        restore = (_time_restore(torch, cfg, arts["ckpt_dir"])
                   if run["timed"] else None)
    rep = arts["report"]
    att = stats["attempts"]
    step_s = sorted(t for a in att for t in a["step_s"][1:])
    med = step_s[len(step_s) // 2]
    tokens = run["batch"] * run["seq"]
    log(f"train {rep['arch']} on {card}: {rep['steps']} steps ("
        f"{cfg.num_layers} layers, B {run['batch']} x S {run['seq']}"
        + (f" after {cfg.num_frontend_tokens} vision positions"
           if cfg.family == "vlm" else "") + ", bf16 "
        f"parameters, f32 moments, lr "
        f"{run['lr']:g}) in {wall:.1f} s with {len(retries)} retries; loss "
        f"{rep['first_loss']:.4f} -> {rep['last_loss']:.4f}, eval "
        f"{rep['eval_loss']:.4f}; attempts "
        f"{[(a['attempt'], a['start_step'], len(a['step_s'])) for a in att]} "
        f"(attempt, first step, steps run)")
    log(f"train {rep['arch']} speed: {med:.4f} s/step (median of the "
        f"attempts' steps after each one's first; min {step_s[0]:.4f}, max "
        f"{step_s[-1]:.4f}) = {tokens / med:.0f} tokens/s")
    saves = [(s, b) for a in att for s, b in zip(a["save_s"], a["save_bytes"])]
    log(f"train {rep['arch']} checkpoints: saves (s, bytes) "
        f"{[(round(s, 3), b) for s, b in saves]} (the liveness window is "
        f"30 s); restores in the run (s, bytes) "
        f"{[(round(a['restore_s'], 3), a['restore_bytes']) for a in att if a['restore_s'] is not None]}"
        + (f"; the final checkpoint restored onto the card {restore[0]:.3f} "
           f"s, {restore[1]} bytes" if restore else "")
        + f"; the longest gap between a train attempt's beats {gap:.3f} s")
    log(f"train {rep['arch']} attempts' errors {errors}; liveness kills of "
        f"attempts {kills}")
    log(f"train {rep['arch']} device memory: allocated at each attempt's "
        f"start {[round(a['memory_start'] / mib, 1) for a in att]} MiB; after "
        f"the run {after / mib:.1f} MiB (peak "
        f"{torch.cuda.max_memory_allocated() / mib:.1f} MiB); launches "
        f"{launches}, scan paths {scan_paths}")
    if not (rep["improved"] and rep["eval_loss"] < rep["first_loss"]):
        raise AssertionError(f"train {rep['arch']}: the loss did not "
                             f"improve: {rep}")
    if len(retries) != (2 if run["chaos"] else 0):
        raise AssertionError(f"train {rep['arch']}: {len(retries)} retries "
                             f"of the train step (chaos {run['chaos']}); "
                             f"errors {errors}, liveness kills {kills}, "
                             f"longest beat gap {gap:.3f} s")
    missing = [k for k in must if launches[k] <= 0]
    if missing:
        raise AssertionError(f"train {rep['arch']}: {missing} never launched")
    if scan_paths["cuda_core"]:
        raise AssertionError(f"train {rep['arch']}: a bf16 scan left the "
                             f"tensor-core kernel: {scan_paths}")
    if run["chaos"]:
        gap = att[2]["memory_start"] - att[0]["memory_start"]
        if gap > 64 * mib:
            raise AssertionError(f"train {rep['arch']}: the third attempt "
                                 f"started with {gap / mib:.1f} MiB more "
                                 f"than the first")
    _trace_train(torch, cfg, run, TRACE_TRAIN_STEPS)
    gc.collect()
    return launches


def run_train_parity(torch, np, cfg, plain):
    """The trainer at PARITY_LAYERS in f32, TF32 off, at TRAIN_RUNS' shape
    for ``cfg`` and its ``parity`` (steps, chaos checkpoint interval,
    bound): through the kernels, again with ``--chaos`` (so the later
    attempts restore), through the plain versions (``plain``: the
    ``--attn-impl``/``--ssd-impl ref`` flags) and through them in f64 (the
    plain path's f32 casts kept at f64). The chaos run's losses must equal
    the uninterrupted run's exactly (after at least one kill), and the
    largest per-step gap between the kernels and the plain versions may
    not exceed ``bound`` times the plain versions' own largest f32-vs-f64
    gap. A hybrid config keeps one group: attn_every is cut with the
    depth."""
    from repro_torch.launch import train
    from repro_torch.models.common import all_f64

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run = TRAIN_RUNS[cfg.name]
    n_steps, ckpt_every, bound = run["parity"]
    cut = dict(num_layers=PARITY_LAYERS, dtype="float32")
    if cfg.attn_every:
        cut["attn_every"] = PARITY_LAYERS
    cfg32 = dataclasses.replace(cfg, **cut)
    steps = str(n_steps)
    runs = {}
    with tempfile.TemporaryDirectory(prefix="train32_") as tmp:
        for name, extra in (
                ("kernel", ("--ckpt-every", steps)),
                ("kernel chaos", ("--ckpt-every", str(ckpt_every),
                                  "--chaos")),
                ("plain", ("--ckpt-every", steps, *plain))):
            t0 = time.perf_counter()
            a, sch, st = train.run(_train_args(
                train, tmp, name.replace(" ", "_"), run, "--steps", steps,
                *extra), cfg=cfg32)
            kills = sum(e["step"] == "train" for e in
                        sch.events.history("step_retry_scheduled"))
            runs[name] = np.asarray(a["losses"], np.float64)
            log(f"train {cfg.name} f32 {PARITY_LAYERS} layers, {name}: "
                f"{time.perf_counter() - t0:.1f} s, {kills} kills, attempts "
                f"{[(x['attempt'], x['start_step'], len(x['step_s'])) for x in st['attempts']]}"
                f", loss {runs[name][0]:.6f} -> {runs[name][-1]:.6f}")
            if "--chaos" in extra and kills < 1:
                raise AssertionError(f"train {cfg.name} f32 chaos: no kill "
                                     f"landed")
        with all_f64():
            a, _, _ = train.run(_train_args(
                train, tmp, "plain64", run, "--steps", steps, "--ckpt-every",
                steps, *plain), cfg=dataclasses.replace(cfg32,
                                                        dtype="float64"))
        runs["plain f64"] = np.asarray(a["losses"], np.float64)
    if not np.array_equal(runs["kernel chaos"], runs["kernel"]):
        bad = np.flatnonzero(runs["kernel chaos"] != runs["kernel"])
        raise AssertionError(f"train {cfg.name} f32: the chaos run's losses "
                             f"differ from the uninterrupted run's at steps "
                             f"{bad[:10]}")
    rel = lambda a, b: np.abs(a - b) / np.abs(b)  # noqa: E731
    kp = rel(runs["kernel"], runs["plain"])
    own = rel(runs["plain"], runs["plain f64"])
    log(f"train {cfg.name} f32 parity ({n_steps} steps): chaos = "
        f"uninterrupted exactly; kernel vs plain max {kp.max():.3e} (step "
        f"{int(kp.argmax()) + 1}; first 5 {np.array2string(kp[:5], precision=2)})"
        f"; plain f32 vs f64 max {own.max():.3e} (step {int(own.argmax()) + 1};"
        f" first 5 {np.array2string(own[:5], precision=2)}); bound {bound:g}"
        f" x the latter")
    if not kp.max() <= bound * own.max():
        raise AssertionError(f"train {cfg.name} f32: kernel vs plain "
                             f"{kp.max():.3e} > {bound:g} x the plain path's "
                             f"own f32-vs-f64 gap {own.max():.3e}")


# ---------------------------------------------------------------------------
# phases 30-32: the SSD scan under autograd, ssm/hybrid and whisper
# ---------------------------------------------------------------------------


def check_ssd_grads(torch, ops, sk):
    """Phase 30: ``ops.ssd_scan`` under autograd on the card (the scan
    kernel's forward inside ``SSDScanFunction``) against the plain
    version's own autograd, with a loss whose upstream gradient depends on
    y and on the final state, at mamba2's and zamba2's SSD widths, B 4 x S
    256, bf16 and f32: the x, dt, A, Bm and Cm gradients within the SSD
    bounds of each gradient's largest magnitude (at least 1). Then both
    wrappers must refuse inputs that require grad. Returns the largest
    bf16 gap at mamba2's widths."""
    b, s = SSD_TRAIN_SHAPE
    worst = {}
    for dtype, tol in ((torch.bfloat16, SSD_BF16_TOL),
                       (torch.float32, SSD_F32_TOL)):
        for wname, (h, n) in (("mamba2", (SSD_H, SSD_N)),
                              ("zamba2", ZAMBA_SSD)):
            g = torch.Generator(device="cuda").manual_seed(45)
            base = _ssd_inputs(torch, g, b, s, dtype, h=h, n=n)
            wy = torch.randn(b, s, h, SSD_P, generator=g, device="cuda")
            ws = torch.randn(b, h, SSD_P, n, generator=g, device="cuda")

            def grads(impl):
                inputs = [t.detach().clone().requires_grad_() for t in base]
                y, fs = ops.ssd_scan(*inputs, impl=impl)
                loss = ((0.5 * y.float().square() + wy * y.float()).sum()
                        + (ws * fs).sum())
                return y, torch.autograd.grad(loss, inputs)

            n0 = sk.LAUNCHES["ssd_scan_bshp"]
            y, got = grads("auto")
            if (type(y.grad_fn).__name__ != "SSDScanFunctionBackward"
                    or sk.LAUNCHES["ssd_scan_bshp"] != n0 + 1):
                raise AssertionError(f"ssd grads [{wname}]: the forward did "
                                     f"not run the kernel inside the Function")
            _, want = grads("ref")
            torch.cuda.synchronize()
            errs = [((a.float() - r.float()).abs().max()
                     / r.float().abs().max().clamp_min(1.0)).item()
                    for a, r in zip(got, want)]
            label = f"{str(dtype).removeprefix('torch.')} {wname}"
            worst[label] = max(errs)
            if not max(errs) <= tol:
                raise AssertionError(f"ssd grads [{label}]: dx/ddt/dA/dB/dC "
                                     f"gaps {errs} > {tol}")
    x, dt, A, Bm, Cm = (t.detach().clone().requires_grad_() for t in base)
    state = torch.zeros(b, ZAMBA_SSD[0], SSD_P, ZAMBA_SSD[1], device="cuda")
    for name, call in (
            ("ssd_scan_bshp", lambda: sk.ssd_scan_bshp(x, dt, A, Bm, Cm)),
            ("ssd_decode_step_bh", lambda: sk.ssd_decode_step_bh(
                state, x[:, 0].contiguous(), dt[:, 0].contiguous(), A,
                Bm[:, 0].contiguous(), Cm[:, 0].contiguous()))):
        try:
            call()
        except RuntimeError as e:
            if "gives no gradient" not in str(e):
                raise
        else:
            raise AssertionError(f"{name} took inputs that require grad")
    log("ssd gradient check (the scan kernel's forward in the autograd "
        f"Function vs the plain version's autograd, B {b} x S {s}; max |gap| "
        "over max(1, max |grad|)): "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
        + f" (bounds bf16 {SSD_BF16_TOL}, f32 {SSD_F32_TOL}); both SSD "
        f"wrappers refuse inputs that require grad")
    return worst["bfloat16 mamba2"]


def time_ssd_train(torch, ops, sk):
    """The scan at the trainer's shape (B 4 x S 256 from zero, mamba2
    widths, bf16), cycling over 48 layers' inputs: the forward (kernel,
    plain version) against its bound, and forward + backward
    (``ops.ssd_scan``'s autograd Function, the plain version's autograd).
    No single PyTorch call computes the scan. Returns the kernels line's
    ``train`` entry."""
    b, s = SSD_TRAIN_SHAPE
    g = torch.Generator(device="cuda").manual_seed(46)
    x, dt, A, Bm, Cm = _ssd_inputs(torch, g, b, s, torch.bfloat16, M_LAYERS)
    for t in (x, dt, Bm, Cm):
        t.requires_grad_()
    up = torch.randn(x.shape, generator=g, device="cuda").to(torch.bfloat16)

    def forward(impl):
        def fn(i):
            l = i % M_LAYERS
            with torch.no_grad():
                ops.ssd_scan(x[l], dt[l], A, Bm[l], Cm[l], impl=impl)
        return fn

    def both(impl):
        def fn(i):
            l = i % M_LAYERS
            ins = (x[l], dt[l], Bm[l], Cm[l])
            y, _ = ops.ssd_scan(*ins[:2], A, *ins[2:], impl=impl)
            torch.autograd.grad(y, ins, up[l])
        return fn

    p1 = _time_ms(torch, forward("ref"), iters=16)
    k1 = _time_ms(torch, forward("auto"))
    k2 = _time_ms(torch, forward("auto"))
    p2 = _time_ms(torch, forward("ref"), iters=16)
    fb = {impl: _time_ms(torch, both(impl), iters=8) for impl in ("auto",
                                                                 "ref")}
    bound = _ssd_bound(b, s, 2, False, read_state=False)
    log(f"timing ssd_scan_bshp train (B {b}, S {s}, H {SSD_H}, N {SSD_N}, "
        f"from zero, bf16): kernel {k1:.4f}/{k2:.4f} ms, plain "
        f"{p1:.4f}/{p2:.4f} ms, bound {bound[0]:.5f} ms ({bound[1]}); "
        f"forward + backward: autograd Function {fb['auto']:.4f} ms, plain "
        f"autograd {fb['ref']:.4f} ms; no library call")
    return dict(ms=min(k1, k2), plain_ms=min(p1, p2), library_ms=None,
                bound_ms=bound[0], bound_by=bound[1], fwd_bwd_ms=fb["auto"],
                plain_fwd_bwd_ms=fb["ref"])


def _whisper_streams(torch, np, serving, models, cfg, impl, dtype):
    """Greedy lockstep streams of W_PARITY_REQUESTS prompts and the logits
    of one prefill of the first two, at ``dtype`` with weights of seed 1,
    attention ``impl``."""
    c = dataclasses.replace(cfg, dtype=dtype)
    model = models.build_model(c, device="cuda", attn_impl=impl)
    params = model.init(seed=1)
    rng = np.random.default_rng(48)
    prompts = [rng.integers(1, cfg.vocab_size, int(rng.integers(64, 129)))
               .tolist() for _ in range(W_PARITY_REQUESTS)]
    plen = len(prompts[0])
    toks = torch.tensor([prompts[0], prompts[0][::-1]], device="cuda")
    _, logits = model.prefill({"tokens": toks, "frames": torch.zeros(
        2, plen, cfg.d_model, device="cuda", dtype=getattr(torch, dtype))},
        LOCK_MAX_LEN)
    engine = serving.GenerationEngine(c, params, max_len=LOCK_MAX_LEN,
                                      max_batch=LOCK_BATCH, attn_impl=impl,
                                      device="cuda")
    reqs = [serving.Request(f"w{i}", p, sampling=serving.SamplingParams(
        max_new_tokens=16)) for i, p in enumerate(prompts)]
    handles, _ = _drive(torch, engine, reqs)
    return [list(h.tokens) for h in handles], logits[:, :cfg.vocab_size]


def run_whisper(torch, np, cfg, serving, models, fk, ref, card):
    """Phase 32: whisper-tiny at full width through the lockstep engine
    (bf16: tok/s, TTFT, flash launches = 12 a prefilled batch), its f32
    parity (greedy streams through the kernel equal the plain version's,
    or, where f32 rounding alone flips an argmax, the one-prefill logit
    gap within the plain path's own f32-vs-f64 gap), the serving driver
    with and without ``--engine lockstep``, and the flash kernel at
    whisper's widths at every (B, S) the phase and the trainer gave it.
    Returns ({path: flash launches}, the bf16 flash check's max error)."""
    from repro_torch.models.common import all_f64

    params = models.build_model(cfg, device="cuda").init(seed=0)
    kw = dict(max_len=LOCK_MAX_LEN, max_batch=LOCK_BATCH, device="cuda")
    rng = np.random.default_rng(47)
    _drive(torch, serving.GenerationEngine(cfg, params, **kw),
           _random_requests(serving, 2, rng, 2, lo=64, hi=256, max_new=4,
                            uid="w", vocab=cfg.vocab_size, seed0=4000))
    engine = serving.GenerationEngine(cfg, params, **kw)
    prefills = _record_prefills(engine.model)
    reqs = _random_requests(serving, 8, rng, 2, lo=64, hi=256, max_new=16,
                            uid="w", vocab=cfg.vocab_size, seed0=4000)
    fk.reset_launches()
    t0 = time.perf_counter()
    handles, steps = _drive(torch, engine, reqs)
    wall = time.perf_counter() - t0
    launches = fk.LAUNCHES["flash_attention_bhsd"]
    results = [h.result() for h in handles]
    _check_served(np, cfg, results, 16)
    per_batch = 3 * cfg.num_layers  # encoder self, decoder self and cross
    if not (prefills and launches == per_batch * len(prefills)):
        raise AssertionError(f"whisper lockstep: flash launches {launches} "
                             f"!= {per_batch} x {len(prefills)} batches")
    _log_run("lockstep", cfg, card, reqs, results, wall, steps,
             f"{len(prefills)} prefilled batches (B, S) {prefills}; flash "
             f"launches {launches} = {per_batch} x {len(prefills)}")
    del engine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    streams, logits = {}, {}
    for name, impl, dtype in (("kernel", "auto", "float32"),
                              ("plain", "ref", "float32")):
        streams[name], logits[name] = _whisper_streams(
            torch, np, serving, models, cfg, impl, dtype)
    with all_f64():
        streams["f64"], logits["f64"] = _whisper_streams(
            torch, np, serving, models, cfg, "ref", "float64")
    kp = (logits["kernel"] - logits["plain"]).abs().max().item()
    own = (logits["plain"].double() - logits["f64"]).abs().max().item()
    diffs = _first_diffs(streams["kernel"], streams["plain"])
    own_diffs = _first_diffs(streams["plain"], streams["f64"])
    log(f"whisper parity: f32, TF32 off, {cfg.num_layers} + "
        f"{cfg.num_layers} layers, {W_PARITY_REQUESTS} greedy streams of 16: "
        f"first differing token kernel vs plain {diffs}, plain f32 vs f64 "
        f"{own_diffs}; one prefill: max |logit kernel - plain| {kp:.3e}, "
        f"plain f32 - f64 {own:.3e}")
    if any(d is not None for d in diffs) and not (
            any(d is not None for d in own_diffs) and kp <= own):
        raise AssertionError(f"whisper f32: kernel streams differ from the "
                             f"plain ones {diffs} (plain f32 vs f64 "
                             f"{own_diffs}; logit gaps {kp:.3e} vs {own:.3e})")

    with tempfile.TemporaryDirectory(prefix="serve_whisper_") as tmp:
        t0 = time.perf_counter()
        out = serve_cli("--arch", cfg.name, "--engine", "lockstep",
                        "--requests", "8", "--max-new", "8", "--workdir",
                        f"{tmp}/lockstep")
        if "served 8/8" not in out or "engine=lockstep" not in out:
            raise AssertionError(f"serve {cfg.name} --engine lockstep: "
                                 f"{out[-1500:]}")
        served = next(line for line in out.splitlines()
                      if line.startswith("served"))
        log(f"serve driver --arch {cfg.name} --engine lockstep on {card} "
            f"({time.perf_counter() - t0:.1f} s): {served}")
        try:
            serve_cli("--arch", cfg.name, "--workdir", f"{tmp}/paged")
        except serving.UnsupportedConfigError as e:
            log(f"serve driver --arch {cfg.name} (the paged default): "
                f"UnsupportedConfigError: {str(e)[:160]}")
        else:
            raise AssertionError(f"serve {cfg.name} (paged default) did not "
                                 f"refuse")

    # the flash kernel at whisper's widths: every (B, S) of the lockstep
    # prefills (encoder and cross attention not causal, decoder causal;
    # S frames = S tokens) and of the trainer, both ways
    h, kvh, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    run = TRAIN_RUNS[cfg.name]
    shapes = sorted(set(prefills) | {(run["batch"], run["seq"])})
    worst = {}
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
        g = torch.Generator(device="cuda").manual_seed(49)
        label = str(dtype).removeprefix("torch.")
        worst[label] = 0.0
        for b, s in shapes:
            for causal in (True, False):
                q, k, v = (torch.randn(b, n, s, d, generator=g,
                                       device="cuda").to(dtype)
                           for n in (h, kvh, kvh))
                err = (fk.flash_attention_bhsd(q, k, v, causal=causal).float()
                       - _flash_plain(ref, q, k, v, causal).float()
                       ).abs().max().item()
                if not err <= tol:
                    raise AssertionError(f"flash [whisper {label} B={b} S={s}"
                                         f" causal={causal}]: {err} > {tol}")
                worst[label] = max(worst[label], err)
    log(f"flash kernel check at whisper's widths (H {h}, KVH {kvh}, D {d}; "
        f"causal and not; (B, S) {shapes}): max abs err bf16 "
        f"{worst['bfloat16']:.3e}, f32 {worst['float32']:.3e} (bounds "
        f"{BF16_TOL}, {F32_TOL})")
    return {"lockstep whisper": launches}, worst["bfloat16"]


# ---------------------------------------------------------------------------
# phases 33-36: the moe family (dbrx-132b) and the vlm path (internvl2-26b)
# ---------------------------------------------------------------------------


def _free(torch):
    """Give the device memory of the phase before back to the allocator
    and the driver: the next phase loads tens of GB."""
    gc.collect()
    torch.cuda.empty_cache()


def _weight_bytes(model):
    """Bytes of the weights one decode step reads: every parameter in its
    own dtype but the embedding, of which it gathers one row a token."""
    return sum(p.numel() * p.element_size()
               for name, p in model.named_parameters() if name != "embed")


def _mv_requests(serving, cfg, n, rng, *, lo, hi, new, uid):
    """``_random_requests`` over cfg's vocabulary."""
    return _random_requests(serving, n, rng, 2, lo=lo, hi=hi, max_new=new,
                            uid=uid, vocab=cfg.vocab_size, seed0=5000)


def _trace_decode(torch, engine, reqs, ready, label, bound_ms, bound_gb):
    """A torch.profiler window over MV_TRACE_STEPS decode steps of
    ``engine`` once ``ready(engine)`` (every prompt prefilled): ms per
    step on the host and on the device against the step's least time
    (``bound_ms``: ``bound_gb`` of weights read at the card's memory
    rate), the device busy share and the top device ops. Returns the busy
    share."""
    from torch.profiler import ProfilerActivity, profile

    for r in reqs:
        engine.submit(r)
    while not ready(engine):
        engine.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(MV_TRACE_STEPS):
            engine.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    _drive(torch, engine, [])
    by_name = _device_times(prof)
    busy_ms = sum(ms for ms, _ in by_name.values())
    if busy_ms <= 0:
        log(f"decode trace {label}: the profiler recorded no device time "
            f"(not measured)")
        return None
    n = MV_TRACE_STEPS
    gemm_ms = sum(ms for name, (ms, _) in by_name.items()
                  if any(k in name.lower() for k in GEMM_TRACE_KEYS))
    log(f"decode trace {label}: {n} decode steps in {wall_ms:.1f} ms wall "
        f"({wall_ms / n:.2f} ms/step); device busy {busy_ms:.1f} ms = "
        f"{100 * busy_ms / wall_ms:.1f}% (idle "
        f"{100 - 100 * busy_ms / wall_ms:.1f}%), {busy_ms / n:.2f} ms/step "
        f"on the device against a bound of {bound_ms:.2f} ms ({bound_gb:.2f}"
        f" GB of weights at {HBM_BYTES_PER_S / 1e12:.2f} TB/s): "
        f"{100 * bound_ms * n / busy_ms:.1f}% of it; cuBLAS GEMM kernels "
        f"{100 * gemm_ms / busy_ms:.1f}% of busy; "
        f"{sum(c for _, c in by_name.values())} device ops")
    top = sorted(by_name.items(), key=lambda kv: kv[1][0], reverse=True)[:6]
    for name, (ms, c) in top:
        log(f"decode trace top: {ms:9.2f} ms x{c:6d}  {name[:90]}")
    return busy_ms / wall_ms


def _mv_run(torch, np, cfg, card, label, make_engine, reqs, must, pk, fk):
    """One measured engine run of phases 33-34 (every kernel count reset
    just before it, read just after): every request finishes by length,
    each kernel in ``must`` launched. Logs tok/s, TTFT, ITL, the launches
    and the peak device memory. Returns (launches, the (B, S) of the
    flash calls of its prefills: vision positions included, past 256
    padded to a multiple of 256 as ``causal_flash`` pads them)."""
    from repro_torch.models import frontend_len

    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    engine = make_engine()
    prefills = _record_prefills(engine.model)
    pk.reset_launches()
    fk.reset_launches()
    t0 = time.perf_counter()
    handles, steps = _drive(torch, engine, reqs)
    wall = time.perf_counter() - t0
    launches = {**pk.LAUNCHES, **fk.LAUNCHES}
    results = [h.result() for h in handles]
    _check_served(np, cfg, results, MV_NEW)
    missing = [k for k in must if launches[k] <= 0]
    if missing:
        raise AssertionError(f"{label}: {missing} never launched: {launches}")
    nf = frontend_len(cfg)
    shapes = [(b, nf + s + (-(nf + s) % 256 if nf + s > 256 else 0))
              for b, s in prefills]
    stats = getattr(engine, "stats", {})
    _log_run(label, cfg, card, reqs, results, wall, steps,
             f"{cfg.num_layers} layers; launches {launches}; prefills "
             f"{stats.get('prefills', len(prefills))}, chunks "
             f"{stats.get('prefill_chunks', 0)}; flash calls (B, S) "
             f"{shapes}; peak device memory "
             f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches, shapes


def run_moe_vlm_engines(torch, np, serving, models, get_arch, pk, fk, card):
    """Phases 33-34: dbrx-132b at full width, MOE_LAYERS of its 40 layers,
    through the paged engine in both step modes and the lockstep engine;
    internvl2-26b whole through the paged engine (whole-prompt prefill
    after 256 zero vision positions) and VLM_LOCK_LAYERS of it through the
    lockstep engine; a decode window of each. Returns ({path: {kernel:
    launches}}, the flash calls' (B, S))."""
    paths, shapes = {}, []
    lock_kernels = ("flash_attention_bhsd",)
    for arch in ("dbrx-132b", "internvl2-26b"):
        _free(torch)
        full = get_arch(arch)
        moe = full.family == "moe"
        cfg = dataclasses.replace(full, num_layers=MOE_LAYERS if moe
                                  else full.num_layers)
        name = arch.split("-")[0]
        before = torch.cuda.memory_allocated() / 2**30
        t0 = time.perf_counter()
        params = models.build_model(cfg, device="cuda").init(seed=0)
        torch.cuda.synchronize()
        log(f"{arch} ({before:.2f} GiB allocated before it): "
            f"{cfg.num_layers} of {full.num_layers} layers at full "
            f"width (d_model {cfg.d_model}, {cfg.num_heads} / "
            f"{cfg.num_kv_heads} heads of D {cfg.head_dim}"
            + (f", {cfg.num_experts} experts of d_ff {cfg.d_ff}, top "
               f"{cfg.experts_per_token}" if moe else
               f", d_ff {cfg.d_ff}, {cfg.num_frontend_tokens} vision "
               f"positions") + f"), bf16: "
            f"{sum(p.numel() for p in params.values()) / 1e9:.3f} B "
            f"parameters, "
            f"{sum(p.numel() * p.element_size() for p in params.values()) / 1e9:.2f}"
            f" GB, seeded on the card in {time.perf_counter() - t0:.1f} s")
        max_len = MOE_MAX_LEN if moe else VLM_MAX_LEN
        kw = dict(max_len=max_len, max_slots=SLOTS, page_size=PAGE,
                  device="cuda")
        rng = np.random.default_rng(60 if moe else 61)
        # paged: dbrx chunked, internvl2 whole-prompt (256 vision
        # positions + a bucket of 64-512), 64-400 tokens each
        paged = dict(kw, prefill_chunk=CHUNK)
        lo = 64
        warm = _mv_requests(serving, cfg, 2, rng, lo=lo, hi=lo + 8, new=4,
                            uid="w")
        _drive(torch, serving.ContinuousBatchingEngine(cfg, params, **paged),
               warm)
        reqs = _mv_requests(serving, cfg, MV_REQUESTS, rng, lo=lo, hi=400,
                            new=MV_NEW, uid="p")
        modes = ("fused", "interleaved") if moe else ("fused",)
        for mode in modes:
            path = f"{name} {mode}" if moe else f"{name} whole-prompt"
            must = (("paged_attention_bkgd", "paged_prefill_attention_ckgd")
                    + (("paged_mixed_attention_rkgd",) if mode == "fused"
                       else ()) if moe
                    else ("paged_attention_bkgd", "flash_attention_bhsd"))
            paths[path], sh = _mv_run(
                torch, np, cfg, card, path,
                lambda m=mode: serving.ContinuousBatchingEngine(
                    cfg, params, step_mode=m, **paged),
                reqs, must, pk, fk)
            shapes += sh
        wbytes = _weight_bytes(models.build_model(cfg, device="meta"))
        bound = wbytes / HBM_BYTES_PER_S * 1e3
        win = _mv_requests(serving, cfg, SLOTS, np.random.default_rng(62),
                           lo=lo, hi=lo + 60, new=MV_NEW, uid="d")
        _trace_decode(
            torch, serving.ContinuousBatchingEngine(cfg, params, **paged),
            win, lambda e: e.stats["prefills"] >= len(win),
            f"{name} paged ({cfg.num_layers} layers, {SLOTS} slots)", bound,
            wbytes / 1e9)
        # lockstep: the same prompt lengths, each batch left-padded to its
        # longest
        if not moe:
            del params
            _free(torch)
            cfg = dataclasses.replace(full, num_layers=VLM_LOCK_LAYERS)
            params = models.build_model(cfg, device="cuda").init(seed=0)
        lock = dict(max_len=max_len, max_batch=LOCK_BATCH, device="cuda")
        lreqs = _mv_requests(serving, cfg, MV_REQUESTS, rng, lo=lo, hi=400,
                             new=MV_NEW, uid="l")
        _drive(torch, serving.GenerationEngine(cfg, params, **lock),
               _mv_requests(serving, cfg, 2, rng, lo=lo, hi=400, new=4,
                            uid="w"))
        path = f"lockstep {name}"
        paths[path], sh = _mv_run(
            torch, np, cfg, card, path,
            lambda: serving.GenerationEngine(cfg, params, **lock), lreqs,
            lock_kernels, pk, fk)
        shapes += sh
        wbytes = _weight_bytes(models.build_model(cfg, device="meta"))
        _trace_decode(
            torch, serving.GenerationEngine(cfg, params, **lock),
            _mv_requests(serving, cfg, LOCK_BATCH, np.random.default_rng(63),
                         lo=lo, hi=400, new=MV_NEW, uid="e"),
            lambda e: e._bstate is not None,
            f"{name} lockstep ({cfg.num_layers} layers, B {LOCK_BATCH})",
            wbytes / HBM_BYTES_PER_S * 1e3, wbytes / 1e9)
        del params
    _free(torch)
    # the serving driver, as a user runs dbrx-132b on one card
    args = ("--arch", "dbrx-132b", "--layers", str(MOE_LAYERS))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="serve_moe_") as tmp:
        out = serve_cli(*args, "--requests", "8", "--max-new", "8",
                        "--workdir", tmp)
    if "served 8/8" not in out or "engine=paged" not in out:
        raise AssertionError(f"serve {args}: {out[-2000:]}")
    log(f"serve driver {' '.join(args)} on {card} "
        f"({time.perf_counter() - t0:.1f} s): "
        + next(line for line in out.splitlines() if line.startswith("served")))
    _free(torch)
    return paths, sorted(set(shapes))


def check_flash_group6(torch, fk, ref, engine_shapes):
    """Flash at dbrx-132b's and internvl2-26b's widths (48 q over 8 kv
    heads, D 128): fixed cases (causal Sq = Skv 1, 100, 272, 512; Sq 64 <
    Skv 320; non-causal 37 x 300) and every (B, S) phases 33-34 gave the
    kernel, bf16 within 2e-2 and f32 within 1e-3 of the plain version.
    Returns the bf16 max abs error."""
    h, kvh, d = FLASH_WIDTHS["dbrx D128"]
    cases = [(2, s, s, True) for s in (1, 100, 272, 512)]
    cases += [(2, 64, 320, True), (2, 37, 300, False)]
    cases += [(b, s, s, True) for b, s in engine_shapes]
    err = {}
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
        g = torch.Generator(device="cuda").manual_seed(34)
        worst = 0.0
        for b, sq, skv, causal in cases:
            q = torch.randn(b, h, sq, d, generator=g, device="cuda").to(dtype)
            k, v = (torch.randn(b, kvh, skv, d, generator=g,
                                device="cuda").to(dtype) for _ in range(2))
            got = fk.flash_attention_bhsd(q, k, v, causal=causal)
            want = _flash_plain(ref, q, k, v, causal)
            torch.cuda.synchronize()
            e = (got.float() - want.float()).abs().max().item()
            if not e <= tol:
                raise AssertionError(
                    f"flash_attention_bhsd [dbrx D128 {dtype} B={b} Sq={sq} "
                    f"Skv={skv} causal={causal}]: max abs err {e} > {tol}")
            worst = max(worst, e)
            del q, k, v, got, want
        err[dtype] = worst
        log(f"flash kernel check {str(dtype).removeprefix('torch.')} dbrx "
            f"D128 (48 / 8 heads, G 6): {len(cases)} cases, engine (B, S) "
            f"{engine_shapes}: max abs err {worst:.3e} (bound {tol})")
    return err[torch.bfloat16]


def _mv_prefill_logits(torch, np, model, impl, routes=None):
    """One prefill's f64 logits through ``impl``: dbrx, one 64-token
    chunk into an empty pool (``prefill_chunk``: the capacity dispatch);
    internvl2, ``prefill`` of a 200-token prompt after 256 zero vision
    positions (S 456, which ``causal_flash`` pads to 512). ``routes``
    collects each layer's router top-k choices."""
    from repro_torch.models import moe as moe_mod

    cfg = model.cfg
    model.attn_impl = impl
    dt = model.embed.dtype
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        1, cfg.vocab_size, 256).astype(np.int32)).cuda()
    route = moe_mod.route
    if routes is not None:
        def recording(p, x, c):
            out = route(p, x, c)
            routes.append(out[1])
            return out
        moe_mod.route = recording
    try:
        if cfg.family == "moe":
            shape = (cfg.num_layers, 6, PAGE, cfg.num_kv_heads, cfg.head_dim)
            pages = {k: torch.zeros(shape, dtype=dt, device="cuda")
                     for k in ("k", "v")}
            row = torch.tensor([1, 2, 3, 4], dtype=torch.int32, device="cuda")
            i32 = dict(dtype=torch.int32, device="cuda")
            logits = model.prefill_chunk(pages, row, toks[:CHUNK],
                                         torch.tensor(0, **i32),
                                         torch.tensor(CHUNK, **i32))
        else:
            vis = torch.zeros((1, cfg.num_frontend_tokens, cfg.d_model),
                              dtype=dt, device="cuda")
            _, logits = model.prefill({"tokens": toks[None, :200],
                                       "vision_embeds": vis}, 456)
            logits = logits[0]
    finally:
        moe_mod.route = route
    return logits[:cfg.vocab_size].double()


def _vlm_next_logits(torch, model, impl, row):
    """The f64 logits of the token after ``row`` (a prompt and the tokens
    generated after it; a lockstep row left-padded with 0 as its batch
    pads it) through ``impl``: a dense prefill after zero vision
    positions, the computation every engine's step makes for that row."""
    cfg = model.cfg
    model.attn_impl = impl
    nf = cfg.num_frontend_tokens
    toks = torch.tensor([row], dtype=torch.int32, device="cuda")
    vis = torch.zeros((1, nf, cfg.d_model), dtype=model.embed.dtype,
                      device="cuda")
    _, logits = model.prefill({"tokens": toks, "vision_embeds": vis},
                              nf + len(row))
    return logits[0, :cfg.vocab_size].double()


def _check_vlm_partings(torch, name, parted, m32, m64):
    """Each greedy decision where internvl2's kernel and plain streams
    part (label, the row before it, the kernel's and the plain pick),
    recomputed by a dense prefill through the kernels and the plain
    versions in f32 and the plain versions in f64: the two picks must be
    a tie at f32's resolution (their f64 logits within the plain path's
    own f32-vs-f64 gap at that row) and the kernel-vs-plain gap within
    twice that gap (the triangle bound, ROADMAP "Parity on the card").
    Anything else is a fault."""
    from repro_torch.models.common import all_f64

    for label, row, kpick, ppick in parted:
        a = _vlm_next_logits(torch, m32, "auto", row)
        b = _vlm_next_logits(torch, m32, "ref", row)
        with all_f64():
            c = _vlm_next_logits(torch, m64, "ref", row)
        kp = (a - b).abs().max().item()
        own = (b - c).abs().max().item()
        tie = abs(c[kpick] - c[ppick]).item()
        log(f"{name} parity {label}: the streams part after {len(row)} "
            f"tokens: kernel {kpick}, plain {ppick}, f64 argmax "
            f"{c.argmax().item()}; f64 logits of the two picks differ by "
            f"{tie:.3e}; max |logit kernel - plain| {kp:.3e}, plain f32 - "
            f"f64 {own:.3e}")
        if not (tie <= own and kp <= 2 * own):
            raise AssertionError(
                f"{name} {label} f32: the kernel and plain streams part "
                f"where the f64 logits of the two picks differ by {tie:.3e} "
                f"(plain f32 - f64 {own:.3e}; kernel - plain {kp:.3e})")


def run_moe_vlm_parity(torch, np, serving, models, get_arch):
    """Phase 35: both families at PARITY_LAYERS, full width, f32, TF32
    off. The one-prefill logit gap of the kernels to the plain versions
    must stay within twice the plain path's own f32-vs-f64 gap (the
    triangle bound, ROADMAP "Parity on the card"); the routers' top-k
    choices of that prefill through kernels and plain versions are
    counted (dbrx). The greedy streams of dbrx's paged engine in each step
    mode and of its lockstep engine through the kernels equal those
    through the plain versions; so do those of internvl2's whole-prompt
    paged and lockstep engines, but where f32 rounding alone decides a
    near-tie (``_check_vlm_partings``)."""
    from repro_torch.models.common import all_f64

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for arch in ("dbrx-132b", "internvl2-26b"):
        _free(torch)
        full = get_arch(arch)
        moe = full.family == "moe"
        name = arch.split("-")[0]
        cfg32 = dataclasses.replace(full, num_layers=PARITY_LAYERS,
                                    dtype="float32")
        model = models.build_model(cfg32, device="cuda")
        params = model.init(seed=1)
        routes = {"auto": [], "ref": []}
        logits = {impl: _mv_prefill_logits(torch, np, model, impl,
                                           routes[impl])
                  for impl in ("auto", "ref")}
        max_len = MOE_MAX_LEN if moe else VLM_MAX_LEN
        kw = dict(max_len=max_len, device="cuda")
        lo, hi = 64, 200 if moe else 256
        engines = {}
        if moe:
            for mode in ("fused", "interleaved"):
                engines[mode] = (
                    lambda impl, m=mode: serving.ContinuousBatchingEngine(
                        cfg32, params, max_slots=4, page_size=PAGE,
                        prefill_chunk=CHUNK, step_mode=m, attn_impl=impl,
                        **kw))
        else:
            engines["whole-prompt"] = (
                lambda impl: serving.ContinuousBatchingEngine(
                    cfg32, params, max_slots=4, page_size=PAGE,
                    attn_impl=impl, **kw))
        engines["lockstep"] = (
            lambda impl: serving.GenerationEngine(
                cfg32, params, max_batch=4, attn_impl=impl, **kw))
        parted = []  # vlm: (label, row, kernel pick, plain pick)
        for label, make in engines.items():
            streams = {}
            for impl in ("auto", "ref"):
                reqs = [serving.Request(r.uid, r.prompt,
                                        sampling=serving.SamplingParams(
                                            max_new_tokens=12))
                        for r in _mv_requests(serving, cfg32, 4,
                                              np.random.default_rng(64),
                                              lo=lo, hi=hi, new=12,
                                              uid="q")]
                # the handles, which hold their engine, die in the helper
                streams[impl] = _ssm_streams(torch, make(impl), reqs)
            diffs = _first_diffs(streams["auto"], streams["ref"])
            if moe and any(d is not None for d in diffs):
                raise AssertionError(
                    f"{name} {label} f32: kernel vs plain streams differ at "
                    f"{diffs}")
            # lockstep rows are left-padded to the batch's longest prompt
            plen = max(len(r.prompt) for r in reqs)
            for r, d, k, p in zip(reqs, diffs, streams["auto"],
                                  streams["ref"]):
                if d is not None:
                    pad = [0] * (plen - len(r.prompt)
                                 if label == "lockstep" else 0)
                    parted.append((label, pad + r.prompt + p[:d], k[d],
                                   p[d]))
            log(f"{name} parity {label}: {PARITY_LAYERS} layers, full width,"
                f" f32: {len(streams['auto'])} greedy streams of 12 tokens "
                f"through kernels and plain versions, first differing "
                f"token {diffs}")
        del engines
        if moe:  # 31 GB in f32 at 2 layers: gone before its f64 copy
            model = params = None
        _free(torch)
        with all_f64():
            m64 = models.build_model(dataclasses.replace(
                cfg32, dtype="float64"), device="cuda")
            m64.init(seed=1)
            logits["f64"] = _mv_prefill_logits(torch, np, m64, "ref")
        _check_vlm_partings(torch, name, parted, model, m64)
        del m64, model, params
        a, b, c = logits["auto"], logits["ref"], logits["f64"]
        kp = (a - b).abs().max().item()
        own = (b - c).abs().max().item()
        flips = ""
        if moe:
            differ = sum(int((x != y).any(-1).sum())
                         for x, y in zip(routes["auto"], routes["ref"]))
            total = sum(x.shape[0] * x.shape[1] for x in routes["auto"])
            flips = (f"; router top-{cfg32.experts_per_token} choices that "
                     f"differ between kernels and plain versions: {differ} "
                     f"of {total} (token, layer) pairs")
        top2 = c.topk(2).values
        log(f"{name} parity: one prefill, max |logit kernel - plain| = "
            f"{kp:.3e}, plain f32 - f64 = {own:.3e}, argmax "
            f"{a.argmax().item()} / {b.argmax().item()} / "
            f"{c.argmax().item()}, f64 top-2 margin "
            f"{(top2[0] - top2[1]).item():.3e}{flips}")
        if not kp <= 2 * own:
            raise AssertionError(f"{name} f32: kernel vs plain logits "
                                 f"{kp:.3e} > 2 x the plain path's own "
                                 f"f32-vs-f64 gap {own:.3e}")
    _free(torch)


def run_moe_vlm_train(torch, np, get_arch, fk, pk, sk, card):
    """Phase 36: ``launch.train`` (``run_train``) at full width on
    internvl2-26b and dbrx-132b at the depths TRAIN_RUNS gives them, no
    chaos, one checkpoint (after the last step, which the evaluation
    restores). Before each run, every leaf's first gradient (the driver's
    initial weights, the corpus's first batch) must be finite and nonzero,
    the router's and ``vision_proj``'s included. Returns {path: {kernel:
    launches}} of the flash forward and backward kernels."""
    from repro_torch.data import DataConfig, SyntheticCorpus
    from repro_torch.models import build_model, frontend_len
    from repro_torch.models.common import flatten_tree
    from repro_torch.train import AdamWConfig, init_train_state
    from repro_torch.train.step import _loss_and_grads

    flash = ("flash_attention_bhsd", "flash_attention_bwd")
    out = {}
    for arch in ("internvl2-26b", "dbrx-132b"):
        _free(torch)
        run = TRAIN_RUNS[arch]
        cfg = get_arch(arch)
        cut = dataclasses.replace(cfg, num_layers=run["layers"])
        model = build_model(cut, device="cuda")
        state = init_train_state(model, 0, AdamWConfig(
            moment_dtype="float32"))
        batch = SyntheticCorpus(DataConfig(
            vocab_size=cut.vocab_size, seq_len=run["seq"],
            global_batch=run["batch"], vision_tokens=frontend_len(cut),
            d_model=cut.d_model, dtype=cut.dtype)).batch_at(0)
        dt = getattr(torch, cut.dtype)
        batch = {k: torch.as_tensor(v, device="cuda").to(
            dt if k == "vision_embeds" else torch.int32)
            for k, v in batch.items()}
        _, _, grads = _loss_and_grads(model, state["params"], batch)
        flat = flatten_tree(grads)
        dead = [k for k, g in flat.items()
                if not (torch.isfinite(g).all() and g.abs().sum() > 0)]
        log(f"train {arch} first gradients: {len(flat)} leaves, "
            f"{len(dead)} zero or non-finite")
        if dead:
            raise AssertionError(f"train {arch}: zero or non-finite "
                                 f"gradients: {dead}")
        del model, state, batch, grads, flat
        _free(torch)
        launches = run_train(torch, cfg, fk, pk, sk, card, flash)
        out[f"train {arch.split('-')[0]}"] = {k: launches[k] for k in flash}
    _free(torch)
    return out


# the bf16 tensor-core kernels: library -> (C info entry, its page kinds)
# ---------------------------------------------------------------------------
# phase 37: tensor-parallel serving, two ranks sharing the one card
# ---------------------------------------------------------------------------

# TP_RANKS ranks on cuda:0 (gloo: NCCL takes one rank per card), llama3-8b
# at TP_LAYERS of its 32 layers and mamba2-1.3b at TP_SSM_LAYERS of its 48,
# full width; TP_REQUESTS requests of 64-400 tokens, TP_NEW new each
TP_RANKS, TP_LAYERS, TP_SSM_LAYERS = 2, 2, 6
TP_REQUESTS, TP_NEW, TP_MAX_LEN = 8, 24, 448
# mamba2's tp run serves the first TP_SSM_REQUESTS of the same mix (the
# phase's time: every gloo collective syncs the shared card)
TP_SSM_REQUESTS = 4
# the paged kernels each llama3 path must launch on every rank
TP_PATHS = {
    "chunked fused": (dict(prefill_chunk=CHUNK),
                      ("paged_attention_bkgd", "paged_prefill_attention_ckgd",
                       "paged_mixed_attention_rkgd")),
    "chunked interleaved": (dict(prefill_chunk=CHUNK,
                                 step_mode="interleaved"),
                            ("paged_attention_bkgd",
                             "paged_prefill_attention_ckgd")),
    "whole-prompt": (dict(prefill_chunk=None),
                     ("paged_attention_bkgd", "flash_attention_bhsd")),
}


# the sub-runs on the same mesh and llama3 weights (ROADMAP A.10b): the
# host and persisted KV tiers (a pool of TP_TIER_PAGES pages, TP_TIER_HOST
# of them in host RAM, a TP_TIER_PREFIX-token prefix on half the
# requests), then a restart on the store; a fleet of 2 workers, one killed
# after TP_FLEET_KILL_STEPS engine steps, over TP_FLEET_REQUESTS requests;
# speculation with the first TP_DRAFT_LAYERS layers as the draft model,
# TP_SPEC_K drafts a bundle
TP_TIER_PAGES, TP_TIER_HOST, TP_TIER_PREFIX = 96, 16, 128
TP_FLEET_REQUESTS, TP_FLEET_NEW, TP_FLEET_KILL_STEPS = 6, 16, 2
TP_DRAFT_LAYERS, TP_SPEC_K = 1, 4


def _tp_requests(np, serving, cfg, seed, n=TP_REQUESTS, new=TP_NEW,
                 sampled=2, hi=400):
    return _random_requests(serving, n, np.random.default_rng(seed), sampled,
                            lo=64, hi=hi, max_new=new, uid="tp",
                            vocab=cfg.vocab_size, seed0=3000)


def _tp_run(torch, np, cfg, card, label, make_engine, reqs, must, pk, fk,
            sk, heads, after=None):
    """One tp engine run: streams finished by length, every rank's pool or
    bank at its local heads (``heads(rank_info)``: {what: (got, want)}),
    each kernel of ``must`` launched on every rank; ``after(engine,
    results)``, when given, checks more before the engine closes and
    returns a note for the log line. Returns the kernels' launches summed
    over the ranks."""
    t_build = time.perf_counter()
    engine = make_engine()
    ex = engine.executor
    c0 = dict(ex.mesh.comm.stats)
    for mod in (pk, fk, sk):
        mod.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    handles, steps = _drive(torch, engine, reqs)
    wall = time.perf_counter() - t0
    mine = _path_launches(pk, sk, fk)
    calls, sent = ex.stats["calls"], ex.stats["broadcast_bytes"]
    coll = {k: v - c0[k] for k, v in ex.mesh.comm.stats.items()}
    infos = {0: ex.rank_info()}
    results = [h.result() for h in handles]
    try:
        note = after(engine, results) if after is not None else ""
    finally:
        engine.close()
    infos.update(ex.follower_info)
    counts = {0: mine, **ex.follower_launches}
    _check_served(np, cfg, results, reqs[0].sampling.max_new_tokens)
    for r, info in infos.items():
        for what, (got, want) in heads(info).items():
            if got != want:
                raise AssertionError(f"{label}: rank {r} {what} {got}, not "
                                     f"{want}")
        bad = [k for k in must if not counts[r][k] > 0]
        if bad:
            raise AssertionError(f"{label}: {bad} not launched on rank {r}: "
                                 f"{counts[r]}")
    n_tok = sum(len(r.tokens) for r in results)
    log(f"{label} on {card} (built and run in "
        f"{time.perf_counter() - t_build:.1f} s), {TP_RANKS} ranks sharing "
        f"one card over gloo "
        f"(collectives staged through the host: not tensor parallelism's "
        f"speed): {len(results)}/{len(reqs)} requests, {n_tok} tokens in "
        f"{wall:.3f} s = {n_tok / wall:.1f} tok/s, {steps} steps, {calls} "
        f"executor calls, {sent / max(calls, 1):.0f} broadcast bytes a call, "
        f"{coll['collectives'] / max(calls, 1):.1f} collectives "
        f"({coll['bytes'] / max(calls, 1) / 2**20:.3f} MiB) a call; peak "
        f"device memory of rank 0's process "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches per "
        f"rank {[{k: v for k, v in c.items() if v} for _, c in sorted(counts.items())]}"
        f"; local heads {[heads(i) for _, i in sorted(infos.items())]}"
        + (f"; {note}" if note else ""))
    return {k: sum(c[k] for c in counts.values()) for k in mine}


def _tp_baseline(torch, np, serving, cfg, params, kw, reqs, card):
    """The same trace at tp 1 (the weights whole on the card, no
    follower): what the gloo ranks' tok/s is held against."""
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.serving.executor import serving_mesh_scope

    with serving_mesh_scope(make_serving_mesh(1, devices=["cuda:0"])):
        engine = serving.ContinuousBatchingEngine(cfg, params, **kw,
                                                  prefill_chunk=CHUNK)
    t0 = time.perf_counter()
    handles, steps = _drive(torch, engine, reqs)
    wall = time.perf_counter() - t0
    results = [h.result() for h in handles]
    _check_served(np, cfg, results, reqs[0].sampling.max_new_tokens)
    n_tok = sum(len(r.tokens) for r in results)
    log(f"tp llama3 chunked fused at tp 1 on {card} (the baseline): "
        f"{n_tok} tokens in {wall:.3f} s = {n_tok / wall:.1f} tok/s, "
        f"{steps} steps")


def _tp_streams(torch, engine, reqs):
    handles, _ = _drive(torch, engine, reqs)
    engine.close()
    return [list(h.tokens) for h in handles]


def _first_layers(params, n):
    """A state dict cut to its first ``n`` layers (the draft model: the
    same embedding, norm and unembedding, the vocab shared)."""
    return {k: v[:n].clone() if k.startswith("layers.") else v
            for k, v in params.items()}


def _tp_tier_requests(np, serving, cfg):
    """TP_REQUESTS requests of 64-200 new prompt tokens, every other one
    after the same TP_TIER_PREFIX-token prefix; greedy and seeded top-p
    alternating."""
    rng = np.random.default_rng(74)
    prefix = rng.integers(1, cfg.vocab_size, TP_TIER_PREFIX).tolist()
    reqs = []
    for i in range(TP_REQUESTS):
        tail = rng.integers(1, cfg.vocab_size,
                            int(rng.integers(64, 201))).tolist()
        sp = (serving.SamplingParams(temperature=0.8, top_p=0.9,
                                     max_new_tokens=TP_NEW, seed=3100 + i)
              if i % 2 else
              serving.SamplingParams(max_new_tokens=TP_NEW, seed=3100 + i))
        reqs.append(serving.Request(f"tk{i}", (prefix if i % 2 == 0 else [])
                                    + tail, sampling=sp))
    return reqs


def _tp_tiers(torch, np, serving, cfg, placed, kw, card, pk, fk, sk, heads):
    """``tp llama3 tiers``: a fused tp-2 engine with host and persisted
    tiers serves the shared-prefix trace and flushes every parked page;
    a new tp-2 engine on the same store serves it again, reloading pages
    from the store (``persist_hits`` >= 1), and every reloaded page, read
    through the gathered page read (both ranks' heads), equals the store's
    bytes. A spilled page is whole: every kv head, ``spill_bytes`` a
    whole page's. Returns the two runs' launches summed over the ranks."""
    from repro_torch.core.storage import ArtifactStore

    must = ("paged_attention_bkgd", "paged_prefill_attention_ckgd",
            "paged_mixed_attention_rkgd")
    with tempfile.TemporaryDirectory(prefix="tp_kv_") as tmp:
        ekw = dict(kw, prefill_chunk=CHUNK, num_pages=TP_TIER_PAGES,
                   host_pages=TP_TIER_HOST, persist_dir=tmp)

        def make():
            engine = serving.ContinuousBatchingEngine(cfg, placed, **ekw)
            engine._uploads = _UploadLog(engine.cache)
            return engine

        def tiers_note(t):
            return ", ".join(f"{k} {t[k]}" for k in (
                "spilled_pages", "spill_bytes", "host_hits", "persist_hits",
                "prefetched_pages", "reclaimed_pages"))

        def first(engine, results):
            freed = engine.cache.flush_tiers()
            t = engine.cache.tiers.counters
            whole = engine.cache.page_nbytes * TP_RANKS  # every rank's heads
            if not t["spilled_pages"] or t["spill_bytes"] != (
                    t["spilled_pages"] * whole):
                raise AssertionError(f"tp tiers: spilled {tiers_note(t)}, "
                                     f"not whole pages of {whole} B")
            index = engine.cache.tiers.persist_index
            block = ArtifactStore(tmp).get(next(iter(index.values()))["k"])
            if block.shape[2] != cfg.eff_kv_heads:
                raise AssertionError(f"tp tiers: a persisted page of "
                                     f"{block.shape}, not every kv head")
            return (f"flushed {freed} pages, {len(index)} persisted pages "
                    f"of {cfg.eff_kv_heads} kv heads; {tiers_note(t)}")

        def restart(engine, results):
            t = engine.cache.tiers.counters
            if t["persist_hits"] < 1:
                raise AssertionError(f"tp tiers restart: no page reloaded "
                                     f"from the store ({tiers_note(t)})")
            n = _check_reloaded(torch, np, engine, tmp, {"k", "v"})
            return (f"{n} reloaded pages equal the store's bytes on both "
                    f"ranks; {tiers_note(t)}")

        runs = [_tp_run(torch, np, cfg, card, f"tp llama3 tiers {label}",
                        make, _tp_tier_requests(np, serving, cfg), must, pk,
                        fk, sk, heads, after)
                for label, after in (("first run", first),
                                     ("restart", restart))]
    return {k: sum(r[k] for r in runs) for k in runs[0]}


def _tp_fleet(torch, np, serving, cfg, placed, ekw, mesh, label, exact,
              card, pk, fk, sk):
    """A FleetSupervisor of 2 engine workers (threads on the one mesh), the
    first to finish TP_FLEET_KILL_STEPS steps killed: every request
    terminal, each (uid, index) once on ``responses`` with no mismatched
    or gapped delta, the paged kernels launched on both ranks, and after
    shutdown the follower holds no executor of any attempt. With ``exact``
    (f32, TF32 off) every stream equals the unperturbed tp-2 engine's; in
    bf16 the streams that part from it are counted (a worker batches other
    requests than the oracle, and bf16 GEMMs round by batch shape).
    Returns the fleet's launches summed over the ranks."""
    from repro_torch.core import TopicBus
    from repro_torch.core.faults import FaultInjector, WorkerKillRule

    reqs = _tp_requests(np, serving, cfg, 73, n=TP_FLEET_REQUESTS,
                        new=TP_FLEET_NEW)
    payloads = [{"uid": r.uid, "prompt": list(r.prompt),
                 "max_new_tokens": r.sampling.max_new_tokens,
                 "temperature": r.sampling.temperature,
                 "top_p": r.sampling.top_p, "seed": r.sampling.seed}
                for r in reqs]
    t0 = time.perf_counter()
    oracle = dict(zip([r.uid for r in reqs], _tp_streams(
        torch, serving.ContinuousBatchingEngine(cfg, placed, **ekw), reqs)))
    t_oracle = time.perf_counter() - t0
    group = mesh.group
    held0, f0 = group.held(), group.launches()
    for mod in (pk, fk, sk):
        mod.reset_launches()
    injector = FaultInjector(worker_rules=[WorkerKillRule(
        after_steps=TP_FLEET_KILL_STEPS, times=1)])
    with tempfile.TemporaryDirectory(prefix="tp_fleet_") as tmp:
        sup = serving.FleetSupervisor(
            TopicBus(Path(tmp) / "bus"),
            lambda: serving.ContinuousBatchingEngine(cfg, placed, **ekw),
            serving.FleetConfig(workers=2, min_replicas=1, max_replicas=2,
                                beat_interval_s=0.01, max_restarts=3),
            injector=injector)
        t1 = time.perf_counter()
        try:
            for pl in payloads:
                sup.submit(pl)
            done = sup.run(expected=list(oracle), timeout_s=300)
        finally:
            sup.shutdown()
        wall = time.perf_counter() - t1
        if not done:
            raise AssertionError("tp fleet: run timed out")
        states = sup.results()
        _check_responses(sup, states)
    torch.cuda.synchronize()
    mine = _path_launches(pk, sk, fk)
    f1, held1 = group.launches(), group.held()
    m = sup.metrics
    diff = {u: _first_diffs([st.tokens], [oracle[u]])[0]
            for u, st in states.items() if st.tokens != oracle[u]}
    if (exact and diff) or m.mismatched_deltas or m.gapped_deltas:
        raise AssertionError(f"{label}: streams part from the tp-2 engine's "
                             f"at {diff}; mismatched deltas "
                             f"{m.mismatched_deltas}, gapped "
                             f"{m.gapped_deltas}; {m.format()}")
    if injector.kills_armed() != 1 or m.crashes < 1:
        raise AssertionError(f"{label}: the kill did not land; {m.format()}")
    if held1 != held0:
        raise AssertionError(f"{label}: the follower holds {held1} after "
                             f"shutdown, {held0} before the fleet")
    counts = {0: mine, **{r: {k: v - f0[r].get(k, 0) for k, v in c.items()}
                          for r, c in f1.items()}}
    must = ("paged_attention_bkgd", "paged_prefill_attention_ckgd",
            "paged_mixed_attention_rkgd")
    for r, c in counts.items():
        bad = [k for k in must if not c.get(k, 0) > 0]
        if bad:
            raise AssertionError(f"{label}: {bad} not launched on rank {r}")
    n_tok = sum(len(st.tokens) for st in states.values())
    log(f"{label} on {card}: 2 workers (threads) on the 2-rank mesh, one "
        f"killed after {TP_FLEET_KILL_STEPS} steps: {len(states)}/"
        f"{len(payloads)} requests terminal, "
        f"{len(payloads) - len(diff)} streams equal the unperturbed tp-2 "
        f"engine's (parting at {diff}; oracle {t_oracle:.1f} s), each (uid, "
        f"index) once, no mismatched delta; {n_tok} tokens "
        f"in {wall:.3f} s; {m.format()}; recovery s "
        f"{[round(r, 4) for r in m.recovery_s]}; follower objects after "
        f"shutdown {held1}; launches per rank "
        f"{[{k: v for k, v in c.items() if v} for _, c in sorted(counts.items())]}")
    return {k: sum(c.get(k, 0) for c in counts.values()) for k in mine}


def _tp_draft(torch, np, serving, cfg, placed, dcfg, dparams, kw, card, pk,
              fk, sk, heads):
    """``tp llama3 draft``: speculation at tp 2 with the draft model (the
    target's first TP_DRAFT_LAYERS layers, whole on rank 0, outside every
    executor call): bundles, accepted drafts and tok/s. Returns the
    launches summed over the ranks (the draft's are rank 0's)."""
    def spec(engine, results):
        u = engine.utilization
        if not engine.stats["spec_bundles"]:
            raise AssertionError("tp draft: no bundle dispatched")
        return (f"draft {dcfg.num_layers} layer(s) on rank 0: "
                f"{engine.stats['spec_bundles']} bundles, "
                f"{u.spec_proposed} drafted, {u.spec_accepted} accepted, "
                f"{u.spec_rollbacks} rollbacks")

    return _tp_run(
        torch, np, cfg, card, "tp llama3 draft",
        lambda: serving.ContinuousBatchingEngine(
            cfg, placed, **kw, prefill_chunk=CHUNK, speculative="draft",
            spec_k=TP_SPEC_K, draft_config=dcfg, draft_params=dparams),
        _tp_requests(np, serving, cfg, 70), ("paged_prefill_attention_ckgd",),
        pk, fk, sk, heads, spec)


def run_tp(torch, np, serving, models, get_arch, pk, fk, sk, card):
    """Phase 37: TP_RANKS ranks on the one card (a mesh of explicit
    devices; gloo) serve llama3-8b (TP_LAYERS layers, full width: 16 q over
    4 kv heads a rank, untied vocab gathered) through the paged engine in
    both step modes and whole-prompt, and mamba2-1.3b (TP_SSM_LAYERS
    layers: 32 SSD heads a rank) through the SSM engine, the llama3 trace
    first at tp 1 (the baseline); on the same llama3 weights the KV tiers
    with a restart, the fleet with a kill and the draft proposer; then, at
    PARITY_LAYERS in f32 with TF32 off, tp-2 greedy streams through the
    kernels equal tp 1's and tp 2's through the plain versions (and, for
    llama3, with the draft). Returns {path: {kernel: launches summed over
    the ranks}}."""
    from repro_torch.launch.mesh import describe_mesh, make_serving_mesh
    from repro_torch.serving.executor import (place_serving_params,
                                              serving_mesh_scope)

    paths = {}
    mesh = make_serving_mesh(TP_RANKS, devices=["cuda:0"] * TP_RANKS)
    t0 = time.perf_counter()
    try:
        mesh.group  # spawn the follower, join the group
        log(f"tp mesh {describe_mesh(mesh)} on {card}: backend "
            f"{mesh.backend}, started in {time.perf_counter() - t0:.1f} s")
        with serving_mesh_scope(mesh):
            full = get_arch("llama3-8b")
            cfg = dataclasses.replace(full, num_layers=TP_LAYERS)
            params = models.build_model(cfg, device="cuda").init(seed=0)
            kvh = cfg.eff_kv_heads // TP_RANKS
            kw = dict(max_len=TP_MAX_LEN, max_slots=SLOTS, page_size=PAGE,
                      device="cuda")
            reqs = _tp_requests(np, serving, cfg, 70)
            _tp_baseline(torch, np, serving, cfg, params, kw, reqs, card)
            placed = place_serving_params(cfg, params, mesh)
            dcfg = dataclasses.replace(cfg, num_layers=TP_DRAFT_LAYERS)
            dparams = _first_layers(params, TP_DRAFT_LAYERS)
            del params

            def heads(info):
                return {"page kv heads": (info["pages"]["k"][3], kvh)}

            for name, (ekw, must) in TP_PATHS.items():
                label = f"tp llama3 {name}"
                paths[label] = _tp_run(
                    torch, np, cfg, card, label,
                    lambda ekw=ekw: serving.ContinuousBatchingEngine(
                        cfg, placed, **kw, **ekw),
                    reqs, must, pk, fk, sk, heads)
            t1 = time.perf_counter()
            paths["tp llama3 tiers"] = _tp_tiers(
                torch, np, serving, cfg, placed, kw, card, pk, fk, sk, heads)
            t2 = time.perf_counter()
            paths["tp llama3 fleet"] = _tp_fleet(
                torch, np, serving, cfg, placed, dict(kw, prefill_chunk=CHUNK),
                mesh, "tp llama3 fleet", False, card, pk, fk, sk)
            t3 = time.perf_counter()
            paths["tp llama3 draft"] = _tp_draft(
                torch, np, serving, cfg, placed, dcfg, dparams, kw, card, pk,
                fk, sk, heads)
            log(f"tp llama3 sub-runs: tiers {t2 - t1:.1f} s, fleet "
                f"{t3 - t2:.1f} s, draft {time.perf_counter() - t3:.1f} s")
            del placed, dparams
            _free(torch)
            mfull = get_arch("mamba2-1.3b")
            mcfg = dataclasses.replace(mfull, num_layers=TP_SSM_LAYERS)
            params = models.build_model(mcfg, device="cuda").init(seed=0)
            h_local = mcfg.ssm_heads // TP_RANKS

            def bank_heads(info):
                return {"bank ssd heads": (info["bank"]["ssm"][2], h_local)}

            paths["tp mamba2"] = _tp_run(
                torch, np, mcfg, card, "tp mamba2",
                lambda: serving.SSMEngine(mcfg, params, max_len=M_MAX_LEN,
                                          max_slots=SLOTS,
                                          prefill_chunk=CHUNK,
                                          device="cuda"),
                _tp_requests(np, serving, mcfg, 71, n=TP_SSM_REQUESTS),
                ("ssd_scan_bshp", "ssd_decode_step_bh"),
                pk, fk, sk, bank_heads)
            del params
            _free(torch)
            _tp_parity(torch, np, serving, models, cfg, mcfg, mesh, card, pk,
                       fk, sk)
    finally:
        mesh.close()
    log(f"tp phase: {time.perf_counter() - t0:.1f} s; the mesh closed, "
        f"its follower ended")
    return paths


def _tp_parity(torch, np, serving, models, cfg, mcfg, mesh, card, pk, fk,
               sk):
    """PARITY_LAYERS, f32, TF32 off: greedy streams at tp 2 through the
    kernels = tp 1 through the kernels = tp 2 through the plain versions,
    for llama3-8b (paged, fused) and mamba2-1.3b (SSM engine); for llama3
    also = tp 2 with the draft proposer (the first TP_DRAFT_LAYERS layers
    of the same weights), and a tp-2 fleet with a kill gives every stream
    of the unperturbed tp-2 engine (``_tp_fleet``, exact)."""
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.serving.executor import (place_serving_params,
                                              serving_mesh_scope)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    one = make_serving_mesh(1, devices=["cuda:0"])
    t0 = time.perf_counter()
    for name, c, make in (
            ("llama3", cfg, lambda c, p, impl, **x:
             serving.ContinuousBatchingEngine(
                 c, p, max_len=TP_MAX_LEN, max_slots=4, page_size=PAGE,
                 prefill_chunk=CHUNK, attn_impl=impl, device="cuda", **x)),
            ("mamba2", mcfg, lambda c, p, impl: serving.SSMEngine(
                c, p, max_len=M_MAX_LEN, max_slots=4, prefill_chunk=CHUNK,
                ssd_impl=impl, device="cuda"))):
        c32 = dataclasses.replace(c, dtype="float32",
                                  num_layers=PARITY_LAYERS)
        params = models.build_model(c32, device="cuda").init(seed=1)
        reqs = lambda: _tp_requests(np, serving, c32, 72, n=5, new=16,
                                    sampled=0, hi=200)
        streams = {}
        with serving_mesh_scope(one):
            streams["tp1 kernels"] = _tp_streams(
                torch, make(c32, params, "auto"), reqs())
        placed = place_serving_params(c32, params, mesh)
        draft = {}
        if name == "llama3":
            draft = dict(speculative="draft", spec_k=TP_SPEC_K,
                         draft_config=dataclasses.replace(
                             c32, num_layers=TP_DRAFT_LAYERS),
                         draft_params=_first_layers(params, TP_DRAFT_LAYERS))
        del params
        for key, impl in (("tp2 kernels", "auto"), ("tp2 plain", "ref")):
            with serving_mesh_scope(mesh):
                streams[key] = _tp_streams(torch, make(c32, placed, impl),
                                           reqs())
        spec = ""
        if draft:
            with serving_mesh_scope(mesh):
                engine = make(c32, placed, "auto", **draft)
            streams["tp2 draft"] = _tp_streams(torch, engine, reqs())
            u = engine.utilization
            if not engine.stats["spec_bundles"]:
                raise AssertionError("tp parity llama3: the draft never "
                                     "drafted")
            spec = (f"; with the draft proposer {engine.stats['spec_bundles']}"
                    f" bundles, {u.spec_accepted}/{u.spec_proposed} drafts "
                    f"accepted")
            del engine, draft
            with serving_mesh_scope(mesh):
                _tp_fleet(torch, np, serving, c32, placed, dict(
                    max_len=TP_MAX_LEN, max_slots=4, page_size=PAGE,
                    prefill_chunk=CHUNK, device="cuda"), mesh,
                    f"tp llama3 fleet f32 ({PARITY_LAYERS} layers)", True,
                    card, pk, fk, sk)
        base = streams["tp2 kernels"]
        del placed
        bad = {k: _first_diffs(base, v) for k, v in streams.items()
               if v != base}
        if bad:
            raise AssertionError(f"tp parity {name}: streams part from tp 2 "
                                 f"through the kernels: {bad}")
        log(f"[{time.perf_counter() - t0:.1f} s] tp parity {name}: "
            f"{PARITY_LAYERS} layers, f32, TF32 off: "
            f"{len(base)} greedy streams of 16 tokens equal at tp 2 through "
            f"the kernels, tp 1 through the kernels and tp 2 through the "
            f"plain versions" + (" and tp 2 with the draft" if spec else "")
            + spec)
        _free(torch)


MMA_KERNELS = {"flash_attention": ("flash_attention_mma_info", (None,)),
               "paged_attention": ("paged_attention_prefill_mma_info",
                                   (0, 1))}


def _dryrun_step(torch, cfg, shape, seed=38):
    """The step a dry-run cell counts, on the card at full width: the
    train step (ga 1, bf16 moments and accumulation, as ``lower_cell``),
    the lockstep prefill or decode step. Returns the step as a callable
    and what it holds (kept alive by the caller)."""
    from repro_torch.models.api import build_model, cache_len
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.step import init_train_state, make_train_step

    g = torch.Generator(device="cuda").manual_seed(seed)
    b, s = shape.global_batch, shape.seq_len
    model = build_model(cfg, device="cuda")

    def tokens(rows, cols):
        return torch.randint(0, cfg.vocab_size, (rows, cols), generator=g,
                             device="cuda", dtype=torch.int32)

    if shape.kind == "train":
        opt = AdamWConfig(moment_dtype="bfloat16")
        state = init_train_state(model, seed, opt)
        step = make_train_step(model, opt, ga=1, accum_dtype="bfloat16")
        batch = {"tokens": tokens(b, s), "targets": tokens(b, s)}
        return (lambda: step(state, batch)), (model, state, batch)
    model.init(seed)
    if shape.kind == "prefill":  # the tokens: a prefill reads no targets
        batch = {"tokens": tokens(b, s)}
        clen = cache_len(cfg, s)
        return (lambda: model.prefill(batch, clen)), (model, batch)
    cache = model.init_cache(b, cache_len(cfg, s))
    tok = tokens(b, 1)
    return (lambda: model.decode_step(cache, tok)), (model, cache, tok)


def count_dryrun_cells(np, get_arch):
    """Phase 38's counts: each of DRYRUN_CELLS counted on meta tensors over
    a (data 1, model 1) mesh (no card, no allocation; ``main`` runs this
    in a thread beside the kernels' build). Returns one dict a cell: its
    config, shape, label, count, argument and resident bytes, roofline
    terms and counting seconds."""
    from repro_torch.analysis.roofline import (HW, model_flops_per_chip,
                                               roofline_terms)
    from repro_torch.configs import get_shape
    from repro_torch.launch import builders
    from repro_torch.parallel import Mesh

    mesh = Mesh(np.full((1, 1), "meta", dtype=object), ("data", "model"))
    cells = []
    for arch, shape_name, batch in DRYRUN_CELLS:
        cfg = get_arch(arch)
        shape = dataclasses.replace(get_shape(shape_name), global_batch=batch)
        t0 = time.perf_counter()
        plan = builders.lower_cell(cfg, shape, mesh, ga=1)
        cost = builders.count_cell(plan, batch)
        cells.append(dict(
            cfg=cfg, shape=shape, batch=batch, cost=cost,
            label=f"dryrun {arch.split('-')[0]} {shape.kind}",
            args_b=builders.argument_bytes(
                plan, builders.used_arguments(plan, cost)),
            res_b=builders.resident_bytes(plan),
            terms=roofline_terms(cost, HW(),
                                 model_flops_per_chip(cfg, shape, 1)),
            t_count=time.perf_counter() - t0))
    return cells


def run_dryrun(torch, np, cells, fk, sk, card):
    """Phase 38: the dry run (``launch/builders.py``, ``analysis/``)
    against the card, on each of DRYRUN_CELLS: the cell counted on meta
    tensors (``cells``, from :func:`count_dryrun_cells`), then its step run
    at full width on the card, one warm step and DRYRUN_STEPS timed ones
    (host clock around the step and a synchronize). The resident state
    (``memory_allocated`` once the step's arguments and the warm step's
    leftovers are in place, less the phase's start) must match the
    predicted argument + resident bytes, and the measured peak
    (``max_memory_allocated`` over a step after ``reset_peak_memory_stats``,
    less what was allocated just before it) the predicted peak, each
    within DRYRUN_MEM_TOL; the median step must take at least the
    roofline bound (a lower bound: a faster step means the count is
    wrong). Prints both, the bound's share of the step and the MFU (the
    analytic model FLOPs over the step time and the bf16 peak). Returns
    {kernel: {path: launches}} of the timed steps."""
    from repro_torch.analysis.roofline import HW

    hw = HW()
    total = torch.cuda.get_device_properties(0).total_memory
    log(f"dryrun: total_memory {total} B, HW().hbm_per_chip "
        f"{hw.hbm_per_chip:.0f} B"
        f"{'' if total == hw.hbm_per_chip else ' (differs)'}; {card}")
    paths = {"flash_attention_bhsd": {}, "flash_attention_bwd": {},
             "ssd_scan_bshp": {}}
    for cell in cells:
        cfg, shape, batch, cost = (cell["cfg"], cell["shape"], cell["batch"],
                                   cell["cost"])
        label, args_b, res_b, terms, t_count = (
            cell["label"], cell["args_b"], cell["res_b"], cell["terms"],
            cell["t_count"])
        _free(torch)
        base = _settled_memory(torch)[1]  # no cuBLAS workspace left
        step, held = _dryrun_step(torch, cfg, shape)
        gc.collect()
        out = step()  # warm: the f32 unembedding, cuBLAS handles
        del out
        gc.collect()
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated() - base
        fk.reset_launches()
        sk.reset_launches()
        times, peaks = [], []
        for _ in range(DRYRUN_STEPS):
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            out = step()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            peaks.append(torch.cuda.max_memory_allocated() - before)
            del out
            gc.collect()
        for name, counts in (("flash_attention_bhsd", fk.LAUNCHES),
                             ("flash_attention_bwd", fk.LAUNCHES),
                             ("ssd_scan_bshp", sk.LAUNCHES)):
            if counts[name]:
                paths[name][label] = counts[name]
        # cuBLAS's own part of the resident state: the workspaces made
        # since the cell began, one per handle (the autograd engine's
        # backward thread takes its own)
        raw, bare = _settled_memory(torch)
        del step, held
        _free(torch)
        med, peak = float(np.median(times)), float(np.median(peaks))
        pred_res, pred_peak = args_b + res_b, cost.peak_bytes
        log(f"{label}: B {batch} x S {shape.seq_len} (count {t_count:.1f} s,"
            f" {cost.ops} ops, regions {cost.regions}): resident predicted "
            f"{pred_res / 1e9:.3f} GB (arguments {args_b / 1e9:.3f} + f32 "
            f"unembedding {res_b / 1e9:.3f}) measured {resident / 1e9:.3f} "
            f"(of it cuBLAS workspaces {(raw - bare) / 1e9:.3f}); peak "
            f"predicted {pred_peak / 1e9:.3f} GB measured "
            f"{peak / 1e9:.3f} (steps {[round(p / 1e9, 3) for p in peaks]})")
        log(f"{label}: step {med * 1e3:.1f} ms (steps "
            f"{[round(t * 1e3, 1) for t in times]}); bound "
            f"{terms.bound_s * 1e3:.2f} ms ({terms.dominant}: compute "
            f"{terms.compute_s * 1e3:.2f}, memory {terms.memory_s * 1e3:.2f}"
            f", unfused {terms.memory_xla_s * 1e3:.2f}); FLOPs "
            f"{cost.flops:.4e}, kernelized bytes "
            f"{cost.hbm_bytes_kernelized:.4e}; bound/step "
            f"{terms.bound_s / med:.3f}; MFU "
            f"{terms.model_flops / (med * hw.peak_flops):.4f}; {card}")
        for what, pred, got in (("resident", pred_res, resident),
                                ("peak", pred_peak, peak)):
            if abs(got - pred) > DRYRUN_MEM_TOL * pred:
                raise AssertionError(
                    f"{label}: measured {what} {got} B is not within "
                    f"{DRYRUN_MEM_TOL:.0%} of the predicted {pred:.0f} B")
        if med < terms.bound_s:
            raise AssertionError(
                f"{label}: the step took {med * 1e3:.2f} ms, under the "
                f"roofline bound {terms.bound_s * 1e3:.2f} ms: the count "
                f"is wrong")
    if not all(paths.values()):
        raise AssertionError(f"dryrun: a kernel did not launch: {paths}")
    return paths


def report_mma_kernels(build):
    """Phase 2's report on the bf16 tensor-core kernels, one instance per
    head dim, page kind and warp-group count: registers and spill stores as
    ptxas gave them in this process's build (none when the libraries were
    already built), then the card's own figures through each library's
    info entry: registers and local (spilled) bytes a thread, dynamic
    shared memory a block, and blocks resident per SM."""
    import ctypes

    entry = re.compile(r"Compiling entry function '(\w+)'")
    for lib, (info_fn, kinds) in MMA_KERNELS.items():
        ptxas = build.build_log.get(lib, "")
        parts = entry.split(ptxas)
        for name, body in zip(parts[1::2], parts[2::2]):
            if "_mma_kernel" not in name:
                continue
            regs = re.search(r"Used (\d+) registers", body)
            spill = re.search(r"(\d+) bytes spill stores", body)
            d, groups = re.findall(r"Li(\d+)E", name)[:2]
            pages = " int8 pages" if "kernelIa" in name else ""
            rows = " mixed chunk rows" if "MixedChunkLimits" in name else ""
            lse = " lse" if "Lb1E" in name else ""  # the training forward
            log(f"ptxas {lib} mma D {d}{pages}{rows}{lse} groups {groups}: "
                f"{regs.group(1) if regs else '?'} registers, "
                f"{spill.group(1) if spill else '?'} bytes spill stores")
        fn = getattr(build.load(lib), info_fn)
        info = (ctypes.c_int * 4)()
        for d in (64, 80, 128):
            for quant in kinds:
                for groups in (1, 2):
                    args = (d, groups) if quant is None else (d, quant, groups)
                    err = fn(*args, info)
                    if err != 0:
                        raise RuntimeError(f"{info_fn}{args}: error {err}")
                    pages = "" if quant is None else (
                        " int8 pages" if quant else " bf16 pages")
                    log(f"card {lib} mma D {d}{pages} groups {groups}: "
                        f"{info[0]} registers, {info[1]} local bytes a "
                        f"thread, {info[2]} B dynamic shared memory, "
                        f"{info[3]} blocks per SM")


def report_flash_backward(build, fk):
    """Phase 2's report on the bf16 flash backward kernels (dK/dV and dQ,
    wgmma) at D 64, 80 and 128: registers and spill stores as ptxas gave
    them in this process's build, and any wgmma it serialised, then the
    card's figures through ``flash_attention_backward_info``."""
    import ctypes

    entry = re.compile(r"Compiling entry function '(\w+)'")
    log_text = build.build_log.get("flash_backward", "")
    parts = entry.split(log_text)
    for name, body in zip(parts[1::2], parts[2::2]):
        if "_wgmma_kernel" not in name:
            continue
        regs = re.search(r"Used (\d+) registers", body)
        spill = re.search(r"(\d+) bytes spill stores", body)
        kind = "dkdv" if "dkdv" in name else "dq"
        d = re.findall(r"Li(\d+)E", name)[0]
        log(f"ptxas flash_backward {kind} wgmma D {d}: "
            f"{regs.group(1) if regs else '?'} registers, "
            f"{spill.group(1) if spill else '?'} bytes spill stores")
    for line in log_text.splitlines():
        if "wgmma.mma_async instructions are serialized" in line:
            log(f"ptxas flash_backward: {line.strip()}")
    fn = fk._backward_library().flash_attention_backward_info
    info = (ctypes.c_int * 4)()
    for d in (64, 80, 128):
        for which, kind in enumerate(("dkdv", "dq")):
            err = fn(d, which, info)
            if err != 0:
                raise RuntimeError(f"flash_attention_backward_info({d}, "
                                   f"{which}): error {err}")
            log(f"card flash_backward {kind} wgmma D {d}: {info[0]} "
                f"registers, {info[1]} local bytes a thread, {info[2]} B "
                f"dynamic shared memory, {info[3]} blocks per SM")


def report_decode_kernel(torch, build, pk):
    """Phase 2's report on the split decode kernel (decode, and mixed rows
    without the hint): registers and spill stores per instance as ptxas
    gave them in this process's build, then the card's figures through
    ``paged_attention_decode_info`` for bf16 q over bf16 and int8 pages at
    each of PAGED_WIDTHS' head dim and group, with the split size the
    decode step of SLOTS rows takes there."""
    import ctypes

    parts = re.compile(r"Compiling entry function '(\w+)'").split(
        build.build_log.get("paged_attention", ""))
    for name, body in zip(parts[1::2], parts[2::2]):
        if "paged_decode_split_kernel" not in name:
            continue
        regs = re.search(r"Used (\d+) registers", body)
        spill = re.search(r"(\d+) bytes spill stores", body)
        d, gm = re.findall(r"Li(\d+)E", name)[:2]
        qt = "bf16" if "kernelI13__nv_bfloat16" in name else "f32"
        pages = "int8" if re.search(r"kernelI(f|13__nv_bfloat16)a", name) \
            else qt
        log(f"ptxas paged_attention split decode D {d} G {gm} q {qt} pages "
            f"{pages}:"
            f" {regs.group(1) if regs else '?'} registers, "
            f"{spill.group(1) if spill else '?'} bytes spill stores")
    fn = build.load("paged_attention").paged_attention_decode_info
    info = (ctypes.c_int * 4)()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for wname, (kvh, group, d, page) in PAGED_WIDTHS.items():
        splits, pps = pk.decode_splits(SLOTS, kvh, -(-MAX_LEN // page), sms)
        for quant in (0, 1):
            err = fn(d, 1, quant, group, pps, info)
            if err != 0:
                raise RuntimeError(f"paged_attention_decode_info({d}, 1, "
                                   f"{quant}, {group}, {pps}): error {err}")
            log(f"card paged_attention split decode [{wname}] D {d} G "
                f"{group} bf16 q, {'int8' if quant else 'bf16'} pages, "
                f"{splits} splits of {pps} pages: "
                f"{info[0]} registers, {info[1]} local bytes a thread, "
                f"{info[2]} B dynamic shared memory, {info[3]} blocks per SM")


def report_ssd_scan(torch, build, sk):
    """Phase 2's report on the scan kernels: registers and spill stores per
    instance as ptxas gave them in this process's build, then the card's
    figures through ``ssd_scan_info`` for the calls the engine and the
    timing phase make: bf16 at the engine's chunk (S 64) and a 512-token
    prompt at mamba2's widths, bf16 at zamba2's N 64, and f32 (the
    CUDA-core template of the parity runs)."""
    parts = re.compile(r"Compiling entry function '(\w+)'").split(
        build.build_log.get("ssd_scan", ""))
    for name, body in zip(parts[1::2], parts[2::2]):
        # the anonymous namespace's mangled name holds the file's name, so
        # match the kernels' own names
        if not re.search(r"ssd_scan_(mma_)?kernel", name):
            continue
        regs = re.search(r"Used (\d+) registers", body)
        spill = re.search(r"(\d+) bytes spill stores", body)
        rows = re.search(r"Li(\d+)E", name)
        kind = (f"mma rows {rows.group(1)}" if "mma" in name and rows else
                "cuda-core " + ("bf16" if "bfloat16" in name else "f32"))
        log(f"ptxas ssd_scan {kind}: {regs.group(1) if regs else '?'} "
            f"registers, {spill.group(1) if spill else '?'} bytes spill "
            f"stores")
    for label, dtype, s, n in (
            ("bf16 engine chunk S 64 N 128", torch.bfloat16, CHUNK, SSD_N),
            ("bf16 prompt S 512 N 128", torch.bfloat16, 512, SSD_N),
            ("bf16 zamba2 S 64 N 64", torch.bfloat16, CHUNK, ZAMBA_SSD[1]),
            ("f32 S 64 N 128", torch.float32, CHUNK, SSD_N)):
        i = sk.ssd_scan_info(dtype, s, SSD_P, n)
        log(f"card ssd_scan [{label}]: {i['path']}, {i['rows']} P rows a "
            f"block, {i['registers']} registers, {i['local_bytes']} local "
            f"bytes a thread, {i['smem_bytes']} B dynamic shared memory, "
            f"{i['blocks_per_sm']} blocks per SM")


def main() -> int:
    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    from repro_torch import models, serving
    from repro_torch.configs import get_arch
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import paged_attention as pk
    from repro_torch.kernels import ssd_scan as sk

    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = last = time.perf_counter()

    def lap(phase):  # wall time per phase, to keep the script in its limit
        nonlocal last
        now = time.perf_counter()
        log(f"[{now - t0:.1f} s] {phase}: {now - last:.1f} s")
        last = now

    # phase 38's counts need no card: they run beside the kernels' build
    dryrun_cells: list = []
    counter = threading.Thread(
        target=lambda: dryrun_cells.extend(count_dryrun_cells(np, get_arch)))
    counter.start()
    build.build()
    counter.join()
    if len(dryrun_cells) != len(DRYRUN_CELLS):
        raise RuntimeError("phase 38's counts failed (traceback above)")
    log(f"build: {time.perf_counter() - t0:.1f} s "
        f"({', '.join(f'{n} {s:.1f} s' for n, s in build.build_seconds.items())})")
    for lib, ptxas in build.build_log.items():  # empty when already built
        regs = sorted({int(n) for n in re.findall(r"Used (\d+) registers",
                                                  ptxas)})
        spills = sorted({int(n) for n in re.findall(
            r"(\d+) bytes spill stores", ptxas)})
        log(f"ptxas {lib}: registers per thread {regs}, spill-store bytes "
            f"{spills} over {ptxas.count('Compiling entry function')} "
            f"kernel instances")
    report_mma_kernels(build)
    report_flash_backward(build, fk)
    report_decode_kernel(torch, build, pk)
    report_ssd_scan(torch, build, sk)

    lap("build")
    # kernel -> max abs err over the main width's bf16 cases, per pool kind
    errs, int8_errs = {}, {}
    for wname in PAGED_WIDTHS:
        for quant in (False, True):
            e = check_kernels(torch, ops, ref, wname, quant)
            if wname in (MAIN_WIDTH, "dbrx D128"):  # the engines' widths
                acc = int8_errs if quant else errs
                for name, x in e.items():
                    acc[name] = max(acc.get(name, 0.0), x)
    lap("paged kernel checks")
    times = time_kernels(torch, F, ops, ref)
    for wname in PAGED_WIDTHS:  # the redesigned kernels at the other widths
        if wname != MAIN_WIDTH:
            time_kernels(torch, F, ops, ref, wname=wname)
    lap("paged timing")
    cfg = get_arch("smollm-360m")
    # kernel -> {path: launches read just after that path's run}
    by_path = {name: {} for name in KERNELS}
    for name, n in run_engine(torch, np, cfg, serving, models, pk,
                              card).items():
        by_path[name]["paged chunked"] = n
    lap("engine")
    run_parity(torch, np, cfg, serving, models)
    lap("parity")
    times.update(time_flash(torch, F, fk, ref))
    flash, lock_shapes = run_lockstep(torch, np, cfg, serving, models, fk,
                                      card)
    by_path["flash_attention_bhsd"]["lockstep"] = flash
    flash, paged, whole_shapes = run_whole_prompt(
        torch, np, cfg, serving, models, fk, pk, card)
    by_path["flash_attention_bhsd"]["whole-prompt"] = flash
    for name, n in paged.items():
        by_path[name]["whole-prompt"] = n
    lap("flash timing, lockstep, whole-prompt")
    run_whole_prompt_parity(torch, np, cfg, serving, models)
    lap("whole-prompt parity")
    times.update(time_ssd_kernels(torch, ops, sk))
    lap("ssd timing")
    mcfg = get_arch("mamba2-1.3b")
    for name, n in run_mamba_engine(
            torch, np, dataclasses.replace(mcfg, num_layers=SSM_ENGINE_LAYERS),
            serving, models, sk, card).items():
        by_path[name]["mamba2"] = n
    lap("mamba2 engine")
    run_mamba_parity(torch, np, mcfg, serving, models)
    lap("mamba2 parity")
    zcfg = get_arch("zamba2-2.7b")
    for path, counts in run_zamba_engine(
            torch, np, dataclasses.replace(zcfg, num_layers=SSM_ENGINE_LAYERS),
            serving, models, pk, sk, card).items():
        for name, n in counts.items():
            by_path[name][path] = n
    lap("zamba2 engine")
    run_zamba_parity(torch, np, zcfg, serving, models)
    lap("zamba2 parity")
    ssm_cfgs = {"mamba2": mcfg, "zamba2": zcfg}
    counts_by_path, ssm_shapes = run_lockstep_ssm(
        torch, np, ssm_cfgs, serving, models, fk, pk, sk, card)
    for path, counts in counts_by_path.items():
        for name, n in counts.items():
            by_path[name][path] = n
    run_lockstep_ssm_parity(torch, np, ssm_cfgs, {
        "mamba2": mcfg.num_layers, "zamba2": Z_PARITY_LAYERS}, serving, models)
    lap("lockstep ssm/hybrid")
    # the flash and SSD checks, at every shape the engines gave the kernels
    errs.update(check_flash(torch, fk, ref, lock_shapes + whole_shapes,
                            ssm_shapes["zamba2"]))
    errs.update(check_ssd_kernels(torch, ops, sk, [
        (b, s, c.ssm_heads, c.ssm_state) for name, c in ssm_cfgs.items()
        for b, s in ssm_shapes[name]]))
    lap("flash and ssd checks")
    run_serve_ssm(card)
    lap("ssm serve driver")
    int8_times = time_kernels(torch, F, ops, ref, quant=True)
    for wname in PAGED_WIDTHS:
        if wname != MAIN_WIDTH:
            time_kernels(torch, F, ops, ref, quant=True, wname=wname)
    lap("int8 timing")
    variant = dataclasses.replace(cfg, num_layers=VARIANT_LAYERS)
    for name, n in run_int8_engine(torch, np, variant, serving, models, pk,
                                   card).items():
        by_path[name]["chunked_int8"] = n
    lap("int8 engine")
    for quant, path in (("none", "tiered"), ("int8", "tiered_int8")):
        for name, n in run_tier_restart(torch, np, variant, serving, models,
                                        pk, card, quant).items():
            by_path[name][path] = n
    lap("tier restarts")
    run_tier_int8_parity(torch, np, cfg, serving, models)
    lap("tier + int8 parity")
    run_serve_tiers(card)
    lap("serve driver")
    verify_errs = check_verify(torch, ops, ref)
    for name, e in check_spec_fleet_shapes(torch, ops, pk).items():
        errs[name] = max(errs[name], e)
    verify_times = time_verify(torch, F, ops, ref)
    lap("verify checks and timing")
    for path, counts in run_spec_engine(torch, np, cfg, serving, models, pk,
                                        card).items():
        for name, n in counts.items():
            by_path[name][path] = n
    lap("spec engine")
    run_spec_parity(torch, np, cfg, serving, models)
    lap("spec parity")
    for name, n in run_fleet(torch, np, cfg, serving, models, pk,
                             card).items():
        by_path[name]["fleet chaos"] = n
    lap("fleet")
    check_put_tree(torch)
    lap("put_tree")
    run_notebook(torch)
    lap("notebook")
    flash, flash_bwd = "flash_attention_bhsd", "flash_attention_bwd"
    train_grad_err, errs[flash_bwd] = check_flash_grads(torch, ops, ref, fk)
    train_flash, times[flash_bwd] = time_flash_train(torch, F, ops, ref, fk)
    lap("flash gradients and timing")
    launches = run_train(torch, cfg, fk, pk, sk, card, (flash, flash_bwd))
    for name in (flash, flash_bwd):
        by_path[name]["train"] = launches[name]
    run_train_parity(torch, np, cfg, ("--attn-impl", "ref"))
    lap("train")
    ssd_grad_err = check_ssd_grads(torch, ops, sk)
    train_ssd = time_ssd_train(torch, ops, sk)
    lap("ssd gradients and timing")
    by_path["ssd_scan_bshp"]["train"] = run_train(
        torch, mcfg, fk, pk, sk, card, ("ssd_scan_bshp",))["ssd_scan_bshp"]
    both = (flash, flash_bwd, "ssd_scan_bshp")
    for name, n in run_train(torch, zcfg, fk, pk, sk, card, both).items():
        if name in both:
            by_path[name]["train zamba2"] = n
    run_train_parity(torch, np, mcfg, ("--ssd-impl", "ref"))
    run_train_parity(torch, np, zcfg, ("--ssd-impl", "ref", "--attn-impl",
                                       "ref"))
    lap("ssm/hybrid train")
    wcfg = get_arch("whisper-tiny")
    launches = run_train(torch, wcfg, fk, pk, sk, card, (flash, flash_bwd))
    for name in (flash, flash_bwd):
        by_path[name]["train whisper"] = launches[name]
    paths, whisper_err = run_whisper(torch, np, wcfg, serving, models, fk,
                                     ref, card)
    by_path[flash].update(paths)
    errs[flash] = max(errs[flash], whisper_err)
    lap("whisper")
    del paths
    counts_by_path, mv_shapes = run_moe_vlm_engines(
        torch, np, serving, models, get_arch, pk, fk, card)
    for path, counts in counts_by_path.items():
        for name, n in counts.items():
            if n:
                by_path[name][path] = n
    lap("dbrx and internvl2 engines")
    errs[flash] = max(errs[flash], check_flash_group6(torch, fk, ref,
                                                      mv_shapes))
    lap("flash check at the group-6 width")
    run_moe_vlm_parity(torch, np, serving, models, get_arch)
    lap("dbrx and internvl2 parity")
    for path, counts in run_moe_vlm_train(torch, np, get_arch, fk, pk, sk,
                                          card).items():
        for name, n in counts.items():
            by_path[name][path] = n
    lap("dbrx and internvl2 train")
    for path, counts in run_tp(torch, np, serving, models, get_arch, pk, fk,
                               sk, card).items():
        for name, n in counts.items():
            if n:
                by_path[name][path] = n
    lap("tensor-parallel serving")
    for name, counts in run_dryrun(torch, np, dryrun_cells, fk, sk,
                                   card).items():
        by_path[name].update(counts)
    lap("dry run against the card")
    kernels = [dict(name=name, route="cuda", source=source,
                    replaces=replaces, launches=sum(by_path[name].values()),
                    launches_by_path=by_path[name],
                    max_abs_err=errs[name], **times[name])
               for name, (source, replaces) in KERNELS.items()]
    for k in kernels:
        if k["name"] in int8_times:
            k["int8"] = dict(max_abs_err=int8_errs[k["name"]],
                             **int8_times[k["name"]])
        if k["name"] == "flash_attention_bhsd":
            k["train"] = dict(grad_max_err=train_grad_err, **train_flash)
        if k["name"] == "ssd_scan_bshp":
            k["train"] = dict(grad_max_err=ssd_grad_err, **train_ssd)
        if k["name"] == "paged_prefill_attention_ckgd":
            k["verify"] = dict(max_abs_err=verify_errs["bf16"],
                               int8_max_abs_err=verify_errs["int8"],
                               f32_max_abs_err=verify_errs["f32"],
                               **verify_times)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
