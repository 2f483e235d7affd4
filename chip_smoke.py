#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``).

    python3 chip_smoke.py          # from the repository root, one H100

Phases (none catches an error; any failure exits non-zero):
  1. Card and build: the card's name and power limit, then every CUDA
     kernel built with nvcc for sm_90a (one nvcc per source, all started
     together; timed). Every phase logs its wall seconds.
  2. Segment kernels against their plain PyTorch versions on the card, at
     the main path's shapes (h2o-danube-1.8b: K = 2560 / 6912 split into
     [K4|K2|K1] segments, N in {640, 2560, 6912}, bf16 activations, M = 4
     decode rows and M = 32 prefill rows): B7 through its one-launch
     entry (one h2o-danube-1.8b layer, 7 launches, and one
     deepseek-moe-16b MoE layer, 10 launches, rows read through a random
     channel perm) bitwise its plain version, timed on both rulers; the
     segment GEMMs (one launch a linear over its segments) within the
     fp32 reordering bound |kernel - plain| <= 1e-5 * (|xq| @ |wd|) +
     1e-6. B1, B2 (uniform 4-bit) and B3 (x as it is) each timed on one
     layer's 7 launches at M = 4 and M = 32 with CUDA events, as a loop
     of calls (``ms``, the host's launch gaps included) and with the
     host's launches queued ahead while the card sleeps (``device_ms``,
     the kernels back to back), beside the plain version and one
     torch.matmul a linear of the same dequantized operands on both
     rulers. One launch over a leaf's segments equals the
     single-segment launches bitwise in every mode; rows are bitwise equal
     across M in {1, 4, 5, 16, 17, 32, 33}. B6 (the grouped GEMM) on one
     deepseek-moe-16b layer's 3 launches (E = 64 experts, T = 4 rows in
     the dispatch layout of a top-6 route of 4 tokens), held to the same
     bound, each expert bitwise the dense launch on its operands, and with
     ``rows`` (each expert's live rows) bitwise the launch without it on
     every live row, rows past the count untouched; timed on both rulers
     with and without ``rows`` beside its plain version and a torch.bmm
     of the dequantized operands over the same experts. The speculative
     widths: B1 at M = 16 (the verify step of k = 3 at batch 4), held and
     timed as at M = 4; the draft launches (the [K2|K1] slice, first
     segment at k_off = K4) of B1 over one h2o-danube-1.8b layer and of
     B6 over one deepseek-moe-16b layer, held to the same bound and
     checks, each bitwise the same launch on x's columns from K4 (k_off
     0), timed beside the full launches. The other dense configs'
     shapes, one full-width layer each of starcoder2-7b (6 linears:
     K = 18432 down, N = 512 k/v), deepseek-67b and mistral-large-123b:
     B1 held to the same bound at M = 4 and 16, its draft launches held
     and bitwise the launch at k_off 0, B7 bitwise its plain version.
  3. Decode attention over the packed 4-bit KV cache against the plain
     versions, at full width, batch 4 (``ATTENTION_CASES``):
     h2o-danube-1.8b (Hk = 8, G = 4, D = 80) B4 on rings of T = 256 and
     T = 4096 (window 1024, so the window binds), B5 on page pools
     (page_size 16; 16 pages a slot with and without a window, 17 pages
     (272 entries, not a multiple of the split's chunk), 256 pages with
     window 1024; shuffled tables, unmapped pages, a page two slots
     share); deepseek-moe-16b (Hk = 16, G = 1, D = 128) B4 at T = 256 and
     B5 at 16 and 17 pages; starcoder2-7b (Hk = 4, G = 9, D = 128) B4 at
     T = 256 and B5 at 16 pages, at S = 1 and 4; at S = 1 and (most) S = 8
     with masked lanes,
     held to |kernel - plain| <= 1e-6 * (P @ |V|) + 1e-12; B5's rows
     equal B4's bitwise on the same content laid out as a ring. The S = 1
     decode shapes timed with CUDA events on both rulers (a loop of calls;
     queued ahead) beside the plain versions and one
     scaled_dot_product_attention on the dequantized fp32 K/V (also on
     both rulers). The verify step: at S = 4, each lane of B4 and B5
     bitwise the S = 1 call at its position, at G = 4, 1 and 9.
  4. Serve: DecodeEngine on full-width h2o-danube-1.8b cut to
     SERVE_LAYERS = 4 of its 24 layers (random weights from a seed,
     default mix), fp ring KV cache, greedy; packing and serving must go
     through quantize_pack and the driver-scale segment GEMM, one launch
     a linear (56 B7 launches at load, 56 B1 a decode step); the load's pack_s, device busy, device events, idle
     share and split by op (a profiled second load); a second run
     gives the same tokens; lockstep equals
     continuous; the card agrees with the plain versions on the CPU in
     fp32: the reduced config end to end, and two full-width layers
     teacher-forced at every serve linear (each op held on its own;
     flipped activation codes counted). The two-pass activation form
     (fuse_act_quant=False: B8, then B3) equals the fused form bitwise at
     every linear of layer 0, and serving the packed model in it gives
     the fused run's tokens through B8 and B3 alone. The fp page pool
     (page_size 16, no kernel of its own) gives the fp ring's tokens;
     its decode step profiled. Speculative decoding (k = 3, draft bits 2)
     over the fp ring and the fp pool on the first 4 requests: tokens
     identical to spec-off, ``spec_stats``, round ms, tokens/s beside
     a spec-off run of the same requests (every spec run), the
     launches of a round (224 B1: one a linear in each of 3 draft steps
     and the verify) and, on the fp ring, a profile of a round.
  5. U4: the same arch at depth 2 with every group at 4 bits, which must
     go through the self-scale segment GEMM; lockstep equals continuous.
  6. 4-bit KV serve at full width, cut to KV4_LAYERS = 6 of its 24
     layers (so the script stays inside its time limit; the lockstep
     engine's host-bound steps set the phase's time; the 4-bit ring and
     pool also serve deepseek-moe-16b, starcoder2-7b and
     whisper-medium in phases 12, 14 and 20): the ring
     DecodeEngine (built
     from the QAT weights, so it packs), the LockstepEngine and the paged
     DecodeEngine on requests that share a 224-token prompt prefix and
     wrap the 256-entry ring, so the prefix map hits and shared pages are
     copied on write. Greedy tokens must be identical across the three;
     the ring runs must go through B4 and the paged run through B5, one
     launch a layer (6 a decode step); the pool's invariants must hold.
     Decode step times and tokens/s of each; a device profile of the ring
     and the paged decode step (busy time, B4/B5's share). Then
     speculative decoding over the 4-bit ring (B4) and pool (B5) on a
     64-entry ring that 4 requests of 16-64 prompt tokens and 16 new
     wrap (the ring-wrap guard, paged rollback): tokens identical to the
     spec-off 4-bit ring's.
  7. Training kernels against their plain versions, bitwise, at the full
     width: B9 noise_inject on the four weight shapes of a layer (with
     weights beyond the clip and logits at both ends), B8 fake_quant on
     the same weights with per-group scales (read in place, K along rows)
     and on [8 * 128, K] bf16 activations with per-row abs-max / 1.875
     scales (a power of two on the tie row), precisions {1, 2, 4} mixed
     per group, with values on rounding ties and beyond the grid. Their
     backward kernels on the same operands and a random cotangent: dw and
     dx bitwise (-0 included), ds within ``noise_inject.ds_bound``. One
     layer's calls of each timed on both rulers beside the plain versions,
     B9 and B8 also alone (their C entries on operands and outputs made
     before the timed calls: ``alone_device_ms``) and B8 beside torch's
     ``clone`` of the same tensors (``copy_device_ms``: the bytes alone).
     The bank forms:
     B9, B8 (weight and activation layouts) and both backward kernels on
     one full-width deepseek-moe-16b MoE layer's three expert banks (E =
     64, every expert its own seed, logits, mixed precisions and scales;
     the activations of the training dispatch buffer, 120 rows an expert),
     one launch a bank, bitwise the plain versions (ds within
     ``ds_bound``) and bitwise E single launches; the same on one
     mixtral-8x22b bank ([8, 16384, 6144], 3.2 GB: byte offsets past
     2^31) against per-expert plain versions; the layer's bank launches
     timed on both rulers beside the plain versions and the single
     launches.
  8. Training: full-width h2o-danube-1.8b cut to TRAIN_LAYERS = 8 of its
     24 layers (phase 11's launcher runs all 24) through Phase I
     (noise, steps 0-2), the pattern freeze and Phase II (QAT, steps 3-5)
     with ``train.loop.train`` on TokenStream(batch 8, seq 128, seed 0);
     per step the phase, loss, gradient norm, step ms, B8/B9 launches
     (forward and backward) and peak memory; a device profile of one step
     of each phase (steps 2 and 5), its plain ops split by the op that
     launched them
     (``tools/step_profile.py``); the boundary's pattern report. Phase I
     must launch B9 and not B8, with one B9 backward a linear (56 a step
     at 8 layers); Phase II B8 and not B9, with one B8 backward a weight
     and one an activation (112 a step); every loss finite.
  9. The trained model packed (B7) and served: 4 requests through the
     DecodeEngine and the LockstepEngine, greedy tokens equal.
 10. Card vs CPU, teacher-forced: each of one full-width layer's seven
     NOISE and QAT linears on the same fp32 input, weights and replayed
     draws; output, dx, dw and ds each within relative L2 1e-5.
 11. The launcher, ``repro_torch.launch.train --arch h2o-danube-1.8b
     --steps 2 --batch 8 --seq 128`` in a subprocess, must exit 0.
 12. MoE serve: full-width deepseek-moe-16b cut to MOE_SERVE_LAYERS = 8
     of its 28 layers, from random QAT weights of the seed (~17 GiB in
     fp32; every earlier model is freed first), packed (B7, one launch a
     linear and an expert bank: 77; the load's profile as in phase 4) and served through the
     DecodeEngine with the fp ring: 8 requests of 16-32 prompt tokens and 12 new, which
     must go through B6 (one launch an expert bank: 21 a decode step), B8
     and B1; a second run gives the same tokens;
     lockstep equals continuous; the 4-bit ring (B4) and page pool (B5)
     give equal tokens. Peak memory, decode step ms and its device
     profile. Speculative decoding on the fp ring (4 requests): tokens
     identical to spec-off, 84 B6 launches a round (63 of them draft
     launches over the [K2|K1] slice).
 13. Card vs CPU, teacher-forced, on full-width deepseek-moe-16b cut to
     its dense layer and one MoE layer, and on full-width starcoder2-7b
     cut to two layers: every linear, expert bank, the router and the
     logits within relative L2 1e-5.
 14. The other dense configs at full width: starcoder2-7b cut to 16 of
     its 32 layers (so the script stays inside its time limit),
     deepseek-67b and mistral-large-123b at depth 2 (their trees do not
     fit): packed (one B7 launch a linear),
     served with the fp ring (4 requests of 16-48 prompt tokens, 12 new),
     lockstep equal to continuous; starcoder2-7b also speculatively
     (tokens identical to spec-off) and over the 4-bit ring and pool
     (equal tokens).
 15. MoE training: full-width deepseek-moe-16b cut to MOE_TRAIN_LAYERS =
     2 layers (the dense layer and one MoE layer of 64 experts) through
     Phase I (steps 0-2),
     the freeze and Phase II (steps 3-5) on TokenStream(batch 8, seq 128,
     seed 0): per step the loss, load-balancing loss, gradient norm, step
     ms, launches and peak memory, a device profile of one step of each
     phase; one B9 launch a linear or bank a forward (34 a Phase-I step
     with the recompute, 17 B9 backward), 68 B8 and 34 B8 backward a
     Phase-II step, checked; a second run bitwise the first; the trained
     model packed (B7) and served (B6, B1), lockstep equal to continuous.
     Then one MoE layer's three banks (16 experts each), card vs CPU,
     teacher-forced in NOISE and QAT: y, dx, dw, ds within relative L2
     1e-5.
 16. Training, the rest: (a) full-width h2o-danube-1.8b cut to
     REST_LAYERS = 2 of its 24 layers (so phases 19 to 24 fit the time
     limit), every linear's logits drawn over the 4/2/1-bit bands of the
     default mix,
     through 3 Phase-I and 3 Phase-II steps at 2 microbatches on phase
     8's stream, hoisted (B8 once a weight a step), so the frozen model
     holds 1-, 2- and 4-bit groups (histogram, average bpp) and B8 and
     its backward run at all three inside a step; the B8 and B9 launches
     of every step checked (hoisted: 28 + 112 B8 and 28 + 56 B8
     backward a Phase-II step; unhoisted: 224 and 112); the unhoisted
     run bitwise the hoisted one (losses, gradient norms, parameters);
     with int8 gradient compression twice, bitwise (the state holds
     ``err``); host ms and peak GiB a step of each, the device busy of
     one Phase-II step (step 4, profiled on the device alone) of each,
     and the compression of a step's gradients alone (loop ruler).
     Phase 10's QAT linears again on layer 0's frozen precisions. (b)
     Checkpoint and restart at full width cut to 2 layers: run A fed the
     batches of steps 0-1 checkpoints at step 2 (t1 = 2), run B resumes
     from it fed steps 2-3, run C trains 0-3 uninterrupted; B's pattern
     report, losses and parameters bitwise C's; a save and a restore
     timed, with their bytes. (c) ``repro_torch.launch.train --reduced
     --steps 4 --t1 2 --ckpt DIR``, then the same again (it resumes)
     beside ``repro_torch.launch.serve --reduced --ckpt DIR``, the two
     started together, in subprocesses; each must exit 0.
 17. The ``soniq`` façade and the CNN: (a) one full-width
     h2o-danube-1.8b q projection (LinearSpec 2560 x 2560) through
     init_linear, 3 Phase-I steps (1 B9 and 1 B9 backward each), to_qat,
     3 Phase-II steps (2 B8 and 1 B8 backward each), to_serve (1 B7) and
     the packed forward (1 B1); kernel vs QAT max err < 1e-4. (b) The
     paper benchmarks' CNN (channels (128,), 2 blocks, 6x6x3 images,
     batch 32) by ``train_cnn``'s recipe, the logits spread over the
     4/2/1-bit bands first: 20 FP warm-start steps, 4 Phase-I steps (AdamW, s_lr_mult 25), to_qat, 4 Phase-II steps, test
     accuracy and bits per parameter, to_serve; every step's launches
     checked (per pw conv: 1 B9 and 1 B9 backward a Phase-I step, 2 B8 and
     2 B8 backward a Phase-II step; 1 B7 at to_serve, 1 B8 a served
     forward); serve vs QAT logits within atol 1e-4, rtol 1e-3; a second
     run bitwise the first. (c) A CIFAR-size CNN (32x32x3, batch 128,
     channels (128, 256), 2 blocks a stage: stride 2 with XLA's
     asymmetric padding) 3 + 3 steps, the same checks, one step of each
     phase's loss card vs CPU within 1e-5 relative, and the device busy
     of a Phase-I and a Phase-II step. (d) The port's three examples in
     subprocesses started together (quickstart --steps 200,
     serve_quantized --steps 10, train_lm_soniq --preset 100m --steps 4),
     each timed from their start; each must exit 0. The ``soniq`` JSON line.
 18. SSM serve: mamba2-2.7b at full width, cut to SSM_SERVE_LAYERS = 4
     of its 64 layers (so the script stays inside its time limit; phase
     19(d) runs all 64) (d_model
     2560, 80 SSD heads of 64, state 128, ssm_chunk 256; random QAT
     weights of the seed). (a) B7 and B1 at its linears' shapes (in_proj
     2560 x 10576, whose N leaves a partial column tile, and out_proj
     5120 x 2560): B7 bitwise its plain version, B1 at M = 4, 16 and 32
     within the fp32 reordering bound, its draft launches within it and
     bitwise the launch at k_off 0; both timed on both rulers beside
     torch.matmul on the dequantized operands. (b) The DecodeEngine
     (default mix, max_batch 4, prefill chunk 8, greedy; 8 requests of
     16-64 prompt tokens and 16 new): 16 B7 launches at load and 16 B1
     a decode step (checked), pack_s and the load's device busy, a second
     run bitwise the first, decode-step host ms, a device profile of a
     decode step and an 8-lane prefill step (kernels, busy, B1 ms, the
     plain ops split by op with the chunked SSD apart, idle share), the
     resident SSM state bytes. (c) The first 4 requests at prefill chunk
     1, through the LockstepEngine (prompts cut to 16 tokens) and
     speculatively (k = 3, draft bits 2;
     ``spec_stats``, round ms, 80 B1 launches a drafting round checked:
     3 drafts, the verify and the recommit): token agreement with the
     chunk-8 run, reported (chunked SSD and the decode recurrence are
     different sums); teacher-forced on the chunk-8 run's tokens, the
     logits of chunked steps 8 and 4 lanes wide against token-by-token
     decode within 1e-2 relative L2 at every lane, at fp32 compute with
     the activations unquantized (~1e-6 apart; in the served form one
     flipped activation code moves every later lane by order 1, so there
     the bitwise-equal lanes are reported). (d) Card vs CPU,
     fp32: the reduced config's tokens identical and its logits within
     1e-5; full width at 2 layers, teacher-forced, every serve linear
     and the chunked SSD's output and state within relative L2 1e-5.
     The ``ssm_serve`` JSON line.
 19. SSM training: mamba2-2.7b at full width. (a) B9, B8 and both
     backward kernels at one layer's training linears (in_proj 2560 x
     10576, N not a multiple of 64; out_proj 5120 x 2560; activations
     [8 * 128, K] bf16) against their plain versions as in phase 7
     (forward, dw and dx bitwise, ds within its bound), one layer's calls
     timed on both rulers (``ssm_train_*`` keys). (b) SSM_TRAIN_LAYERS =
     4 layers, the logits drawn over the 4/2/1-bit bands, through 3
     Phase-I steps, the freeze and 3 Phase-II steps on TokenStream(batch
     8, seq 128, seed 0): every step's launches asserted (16 B9 and 8
     B9 backward a Phase-I step, 32 B8 and 16 B8 backward a Phase-II
     step: each block is recomputed), peak memory, a device profile of
     steps 2 and 5 (busy, fp32 GEMMs, B8/B9 and their backward, the
     chunked SSD's forward and backward apart, the rest); a second run
     bitwise the first (losses, gradient norms, every parameter); the
     frozen precision histogram and bpp; ``soniq.to_serve`` (16 B7
     launches, asserted) and a DecodeEngine run of 4 requests (16 B1 a
     decode step, asserted), tokens reported. (c) Two full-width layers,
     fp32, card vs CPU teacher-forced at NOISE (the same host-made draws)
     and QAT: each block's y, dx and every leaf's gradient within
     relative L2 1e-5. (d) Full depth (64 layers): one Phase-I step, the
     freeze and one Phase-II step (launches asserted), each step's peak
     memory under the card's. The ``ssm_training`` JSON line.
 20. Encoder-decoder serve: whisper-medium at full width, cut to
     WHISPER_SERVE_LAYERS = 6 of its 24 encoder and 24 decoder layers
     (d_model 1024, 16 heads of 64, d_ff 4096, GELU, LayerNorm, tied
     vocab 51865; random QAT weights of the seed, bf16 compute). (a) B1
     at the encoder's six linears at M = 4 x
     1500 frames = 6000 rows and at the decoder's M = 4, 16 and 32,
     within the fp32 reordering bound; B7 on one decoder layer's ten
     linears, bitwise; B4 on the cross K/V (T = 1500, Hk = 16, G = 1,
     D = 64, every key position 0, the queries at 2^30) at S = 1, 4 and
     8 within its bound and each lane bitwise the S = 1 call; B4 and B5
     on the self ring and pool at this geometry; each timed on both
     rulers beside its plain version and torch.matmul / SDPA. (b) The
     DecodeEngine's load: 192 B7 launches (asserted), pack_s, device
     busy, peak memory. (c) One encode pass of 4 x 1500 mel frames: 72
     B1 launches (asserted), host ms and device ms by op (B1, the
     float64 attention, LayerNorm, GELU, the rest). (d) ``load_cross`` at
     fp and at 4 bits: 24 B1 launches each (asserted), the cross
     payload bytes. (e) 8 requests of 16-64 prompt tokens and 16 new
     over the fp ring (twice, bitwise); the first 4 over the 4-bit ring
     and the 4-bit pool (tokens equal the ring's) and, prompts cut to 16
     tokens, speculatively (k = 3, draft bits 2; tokens equal spec-off,
     384 B1 a round); per decode
     step 96 B1 (the cross layer's wk/wv of x are not projected), 24 B4
     on the 4-bit ring, 12 B5 and 12 B4 on the pool (asserted); a device
     profile of a decode and an 8-lane prefill step. (f) Card vs CPU,
     fp32: the reduced config's encoder output within relative L2 1e-5
     and its tokens identical; one full-width encoder and decoder layer
     teacher-forced, every linear and the logits within 1e-5. (g)
     ``soniq.apply(..., frames=...)`` of the reduced config at SERVE,
     card vs CPU within 1e-5. The ``whisper_serve`` JSON line.
     ``python3 chip_smoke.py --only 20`` builds the kernels and runs this
     phase alone.
 21. Encoder-decoder training: whisper-medium at full width, cut to
     WHISPER_TRAIN_LAYERS = 6 + 6 of its 24 + 24 layers (fp32
     parameters, bf16 compute), batches of
     TokenStream(batch 8, seq 128, seed 0) with mel frames [8, 1500, 80]
     fp32 from ``default_rng(SEED)``. (a) B9, B8 and both backward
     kernels against their plain versions at one encoder layer's six
     linears (B8's activations at M = 8 x 1500 = 12,000 rows) and one
     decoder layer's ten (M = 1024; the cross wk/wv at 12,000): forward,
     dw and dx bitwise, ds within its bound, timed on both rulers
     (``whisper_train_*`` keys). (b) The logits over the 4/2/1-bit
     bands, 3 Phase-I steps, the freeze and 3 Phase-II steps through
     ``loop.train``: every step's launches asserted (384 B9 and 192 B9
     backward a Phase-I step, 768 B8 and 384 B8 backward a Phase-II
     step: 192 linears, each block recomputed), host ms and peak memory a
     step, the device busy of steps 2 and 5, their split into fp32 GEMMs,
     B8/B9, their backward kernels, the float64 attention, the LayerNorms
     and the GELU (forward with the recompute, and backward) and the rest
     (``step_profile.WHISPER_TRAIN_SPANS``, ``whisper_train_summary``) at
     2 + 2 layers (a profile of every host op at 6 + 6 reads for
     minutes; there the device alone: busy, kernels); the report
     in the reference's walk (the encoder first, path by path); a second
     run at 2 + 2 layers bitwise the first (losses, gradient norms,
     pbits, every parameter). (c) One full-width encoder and decoder layer, fp32, card
     vs CPU teacher-forced at NOISE (the same host-made draws) and QAT:
     each block's y, dx, the cross input's gradient, every leaf's
     gradient and every linear within relative L2 1e-5. (d) The trained
     model through ``soniq.to_serve`` (192 B7), one encode of 4 x 1500
     frames (72 B1), ``load_cross`` and 4 greedy requests on the fp
     ring, twice bitwise. The ``whisper_training`` JSON line. ``python3
     chip_smoke.py --only 21`` builds the kernels and runs this phase
     alone.
 22. The VLM family: qwen2-vl-72b at full width (d_model 8192, 64
     heads of 128 over 8, d_ff 29568, attention and MLP biases, the
     untied readout over 152064, M-RoPE sections (16, 24, 24); random
     weights from the seed). (a) B1 on one layer's seven linears at M = 4
     and 2304 and on the readout's shape (8192 x 152064, packed as a
     stand-in) at M = 4 and 2304, within the fp32 bound, beside
     torch.matmul; B7 on one layer and on the readout's shape, bitwise;
     B9, B8 and both backward kernels on one layer's training linears and
     on a weight of the readout's shape (1.246e9 elements, held band by
     band: ``vlm_*`` keys). (b) Serve at VLM_SERVE_LAYERS = 2 of 80
     layers: the load (14 B7 launches, ``pack_s``, peak), 8 text requests
     over the fp ring (14 B1 a step; lockstep == continuous), the 4-bit
     ring and pool (2 B4 / 2 B5 a step; pool == ring) and speculatively
     (k = 3; tokens == spec-off). (c) ``soniq.apply`` on the packed state
     over a 2304-token multimodal prompt (text, a 4 x 16 x 16 video, text,
     a 24 x 40 image, text; embeddings bf16, M-RoPE streams [3, 1, 2304]
     as Qwen2-VL lays them): 28 B1 at M = 2304, the chunked attention,
     finite logits, host ms and a device profile by op; table-row
     embeddings at three equal streams bitwise the tokens path; one
     full-width layer card vs CPU, teacher-forced, every op within
     relative L2 1e-5. (d) Training at VLM_TRAIN_LAYERS = 1 layer beside
     the table and readout (3.37 B parameters) on embeddings [4, 384,
     8192] with labels -1 on the image: 3 Phase-I steps, the freeze, 3
     Phase-II steps (launches asserted), one 2-microbatch Phase-II step
     hoisted, a second run bitwise, the unread table decayed as AdamW
     decays a zero gradient, ``soniq.to_serve`` (7 B7) and an apply. The
     ``vlm`` JSON line. ``python3 chip_smoke.py --only 22`` builds the
     kernels and runs this phase alone.
 23. The hybrid family: jamba-1.5-large-398b at its published widths
     (d_model 8192, 64 heads of 128 over 8, d_ff 24576, d_inner 16384,
     256 SSD heads of 64, state 128, vocab 65536 untied, top-2 routing,
     bf16 parameters and compute), cut to HYBRID_UNITS = 1 unit of its 9
     (8 sublayers: 7 Mamba2 mixers and one attention sublayer, 4 dense
     MLPs and 4 MoEs) and HYBRID_EXPERTS = 8 of 16 experts; random
     weights of the seed. (a) B7 on bf16 weights (one mixer, one
     attention sublayer, one dense MLP, one 8-expert bank), bitwise its
     plain version and the fp32 launch on the widened weights, timed
     against the byte bound at 2 bytes an element beside the fp32 launch
     and torch's group abs-max; B1 on in_proj, out_proj and the MLP at
     M = 4, 16, 32 within the fp32 bound beside torch.matmul; B6 on one
     MoE sublayer's banks (every row live; the live rows of a top-2
     route of 4 tokens) beside torch.bmm (``jamba_*`` keys). (b) The
     DecodeEngine's load of the bf16 QAT tree: 42 B7 launches (asserted),
     ``pack_s``, device busy, peak memory. (c) 8 requests of 16-64 prompt
     tokens and 16 new at batch 4: the fp ring at chunk 8 twice
     (bitwise), chunk 1 and lockstep (agreement reported), the 4-bit ring
     and pool (tokens equal), the fp pool (tokens equal the fp ring's),
     speculatively (k = 3) on the fp ring and the 4-bit pool (tokens
     equal spec-off's; 150 B1 and 60 B6 a drafting round asserted); 30
     B1, 12 B6, 12 B8 and 1 B4 / B5
     a decode step asserted; the snapshot's bytes. (d) A decode step and
     an 8-lane prefill step profiled by op (``step_profile.HYBRID_SPANS``,
     ``hybrid_summary``). (e) Card vs CPU: the reduced config's tokens
     identical; two full-width sublayers (a mixer with the MLP, attention
     with the MoE) at fp32 over 4 tokens,
     teacher-forced: every linear, router, bank, the chunked SSD and each
     sublayer's output within relative L2 1e-5. The ``hybrid`` JSON
     line. ``python3 chip_smoke.py --only 23`` builds the kernels and
     runs this phase alone.
 24. The hybrid's training (jamba-1.5-large-398b) at its published
     widths, cut to one unit of two sublayers (a Mamba2 mixer with the
     dense MLP, GQA attention with the MoE) and 4 of 16 experts, bf16
     parameters and compute, fp32 moments: B9, B8 and their backward
     kernels at in_proj (8192 x 33280) and one bank [4, 8192, 24576] (B9
     on the fp32 widening, B8 on the bf16 weights and on bf16
     activations) bitwise their plain versions, timed beside the byte
     bound and torch's ``clone``; 3 + 3 steps of ``loop.train`` through
     the freeze, every step's launches asserted (24 B9 / 12 B9-backward
     a Phase-I step, 48 B8 / 24 B8-backward a Phase-II step: 12
     quantized leaves, each block recomputed), peak memory, steps 2 and
     5 profiled by op (``step_profile.HYBRID_TRAIN_SPANS``,
     ``hybrid_train_summary``), the freeze's report in the reference's
     walk; a second run bitwise; ``soniq.to_serve`` (12 B7) and 4
     requests twice, bitwise; the two sublayers card vs CPU at fp32
     (d_ff cut to ``HYBRID_CPU_D_FF``) at NOISE and QAT, teacher-forced,
     within relative L2 1e-5, flipped QAT activation codes counted. The
     ``hybrid_training`` JSON line. ``python3 chip_smoke.py --only 24``
     runs this phase alone.
 25. Summary: a ``kernels`` JSON line (B1-B9 and the backward passes of
     B8 and B9; the bank forms' ``bank_*`` keys on B8, B9 and the
     backward rows; the hoisted and unhoisted launches of a 2-microbatch
     Phase-II step on B8 and its backward; phase 17's launches on B1, B7,
     B8, B9 and the backward rows; phase 18's ``ssm_*`` keys and SSM
     launches on B1 and B7; phase 19's ``ssm_train_*`` keys on B8, B9
     and the backward rows; phase 20's ``whisper_*`` keys and launches
     on B1, B4, B5 and B7; phase 21's ``whisper_train_*`` keys on B8, B9
     and the backward rows; phase 22's ``vlm_*`` keys and launches on
     B1, B4, B5, B7, B8, B9 and the backward rows; phase 23's ``jamba_*``
     keys and launches on B1, B4, B5, B6, B7 and B8; phase 24's
     ``jamba_train_*`` keys on B8, B9 and the backward rows), the
     ``kv4_serve``,
     ``training``,
     ``moe_training``, ``training_rest``, ``moe_serve``, ``load``,
     ``spec_serve``, ``fp_paged_serve``, ``dense_configs``, ``soniq``,
     ``ssm_serve``, ``ssm_training``, ``whisper_serve``,
     ``whisper_training``, ``vlm``, ``hybrid``, ``hybrid_training``,
     ``phase_seconds`` and
     ``phase_cpu_seconds``
     JSON lines, the nvidia-smi line, and last the ``{"ok": true, ...}``
     line.
"""
from __future__ import annotations

import copy
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
sys.path.insert(0, str(Path(__file__).resolve().parent / "tools"))

from repro_torch import kernels  # noqa: E402
from repro_torch.backend import base as backend  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import quant  # noqa: E402
from repro_torch.core import smol  # noqa: E402
from repro_torch.core.qtypes import U4, QuantConfig  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.core import schedule  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.kernels import attn_decode as ad  # noqa: E402
from repro_torch.kernels import fake_quant as fq  # noqa: E402
from repro_torch.kernels import noise_inject as ni  # noqa: E402
from repro_torch.kernels import packed_matmul as pm  # noqa: E402
from repro_torch.kernels import quant_pack as qp  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.models import blocks as blocks_lib  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import moe as moe_lib  # noqa: E402
from repro_torch.serve import engine, kv_pool, kv_quant  # noqa: E402
from repro_torch.serve.scheduler import DECODE, Request  # noqa: E402
from repro_torch.train import loop  # noqa: E402
import sass_count  # noqa: E402
import step_profile  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_FLOPS = 67e12             # H100 SXM fp32 outside the tensor cores
ARCH = "h2o-danube-1.8b"
SEED = 0
B1, B2, B7 = ("fused_act_segment_matmul", "fused_act_selfscale_matmul",
              "quantize_pack")
B4, B5 = "qkv_attn_decode", "qkv_attn_decode_paged"
B8, B9 = "fake_quant", "noise_inject"
B8_BWD, B9_BWD = "fake_quant_bwd", "noise_inject_bwd"
B3, B6 = "packed_segment_matmul", "packed_segment_matmul_grouped"
MOE_ARCH = "deepseek-moe-16b"
DENSE_ARCH = "starcoder2-7b"
# Phase 4's depth (h2o-danube-1.8b has 24; 8 before PR 32, cut for phase
# 24's time).
SERVE_LAYERS = 4
KV4_LAYERS = 6               # phase 6's depth (h2o-danube-1.8b has 24)
# Phase 8's depth (phase 11's launcher runs all 24 layers).
TRAIN_LAYERS = 8
# The other dense configs (arch, depth: None = the config's own), each at
# full width; starcoder2-7b has 32 layers.
DENSE_CONFIGS = ((DENSE_ARCH, 16), ("deepseek-67b", 2),
                 ("mistral-large-123b", 2))
SOURCES = {B1: "src/repro_torch/csrc/segment_gemm.cu",
           B2: "src/repro_torch/csrc/segment_gemm.cu",
           B3: "src/repro_torch/csrc/segment_gemm.cu",
           B6: "src/repro_torch/csrc/segment_gemm.cu",
           B4: "src/repro_torch/csrc/attn_decode.cu",
           B5: "src/repro_torch/csrc/attn_decode.cu",
           B7: "src/repro_torch/csrc/quant_pack.cu",
           B8: "src/repro_torch/csrc/fake_quant.cu",
           B9: "src/repro_torch/csrc/noise_inject.cu",
           B8_BWD: "src/repro_torch/csrc/fake_quant.cu",
           B9_BWD: "src/repro_torch/csrc/noise_inject.cu"}
REPLACES = {B1: "src/repro/kernels/packed_matmul.py:108",
            B2: "src/repro/kernels/packed_matmul.py:121",
            B3: "src/repro/kernels/packed_matmul.py:100",
            B6: "src/repro/kernels/packed_matmul.py:260",
            B4: "src/repro/kernels/attn_decode.py:54",
            B5: "src/repro/kernels/attn_decode.py:155",
            B7: "src/repro/kernels/quant_pack.py:21",
            B8: "src/repro/kernels/fake_quant.py:27",
            B9: "src/repro/kernels/noise_inject.py:22",
            # The backward passes port the custom VJPs around B8 and B9.
            B8_BWD: "src/repro/backend/base.py:190",
            B9_BWD: "src/repro/backend/base.py:145"}
TRAIN_BATCH, TRAIN_SEQ, T1, T2 = 8, 128, 3, 6


def log(msg: str) -> None:
    print(msg, flush=True)


class PhaseClock:
    """Wall seconds of each phase, logged as it ends, and the CPU seconds
    this process used in it (all its threads): a host that holds the
    script back raises the wall seconds of a phase and not its CPU
    seconds."""

    def __init__(self):
        self.laps, self.cpu_s = {}, {}
        self.t, self.cpu = time.perf_counter(), time.process_time()

    def lap(self, phase: int) -> None:
        now, cpu = time.perf_counter(), time.process_time()
        self.laps[phase] = round(now - self.t, 2)
        self.cpu_s[phase] = round(cpu - self.cpu, 2)
        self.t, self.cpu = now, cpu
        log(f"[{phase}] phase done in {self.laps[phase]:.2f} s "
            f"({self.cpu_s[phase]:.2f} s of process CPU)")


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (after a warm-up)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 10) -> float:
    """Mean device time of ``fn`` with the host queued ahead: the stream
    first sleeps ~0.1 s on the card while the host enqueues every launch,
    so CUDA events around the launches see the kernels back to back,
    without the launch gaps that a loop of short kernels leaves when the
    host is slower than the card."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


# ---------------------------------------------------------------- shapes ----
def layer_linears(cfg):
    """(name, K, N) of one layer's serve linears: a decoder layer's seven,
    or six where the MLP has no gate (non-gated gelu); a mamba layer's
    in_proj (to z, x, B, C and dt) and out_proj."""
    if cfg.family == "ssm":
        di, n = cfg.d_inner, cfg.ssm_state
        return [("in_proj", cfg.d_model, 2 * di + 2 * n + di // 64),
                ("out_proj", di, cfg.d_model)]
    d, f = cfg.d_model, cfg.d_ff
    hq, hk = cfg.num_heads * cfg.hd, cfg.num_kv_heads * cfg.hd
    gate = [("gate", d, f)] if cfg.mlp_act == "swiglu" else []
    return [("wq", d, hq), ("wk", d, hk), ("wv", d, hk), ("wo", hq, d),
            *gate, ("up", d, f), ("down", f, d)]


def segment_shapes(qcfg, k):
    """[(p, k_off, kp, g_off)] of the non-empty segments of a K-dim."""
    out, off = [], 0
    for p, kp in zip((4, 2, 1), qcfg.segments(k)):
        if kp:
            out.append((p, off, kp, off // 16))
            off += kp
    return out


class LayerOperands:
    """Random operands of one layer's seven linears (or of ``shapes``,
    (name, K, N) each) at batch M: per linear the bf16 input x [M, K] (an
    outlier row), its per-token scale and the leaf's non-empty segments
    [(carriers, group scales, p, k_off)], as ``backend.packed_matmul``
    passes them to one launch."""

    def __init__(self, cfg, qcfg, m, gen, dev, shapes=None):
        self.linears = []
        for _name, k, n in shapes or layer_linears(cfg):
            x = torch.randn((m, k), generator=gen, device=dev).to(
                torch.bfloat16)
            x[0, : k // 2] *= 40.0                     # an outlier row
            sx = quant.abs_max_scale(x, dim=-1).float().contiguous()
            wscale = torch.rand((k // 16,), generator=gen, device=dev) \
                * 0.02 + 0.001
            ops = []
            for p, off, kp, goff in segment_shapes(qcfg, k):
                wp = torch.randint(0, 256, (kp * p // 8, n), generator=gen,
                                   device=dev, dtype=torch.uint8)
                ops.append((wp, wscale[goff:goff + kp // 16], p, off))
            self.linears.append(dict(x=x, sx=sx, ops=ops, n=n))


def _segment_kwargs(name, lin):
    """The mode of B1 (driver scale), B2 (self-scale) or B3 (x as it is)
    as ``segments_matmul`` arguments."""
    if name == B1:
        return dict(sx=lin["sx"])
    return dict(self_scale=name == B2)


def _xq_wd(name, lin, sel=lambda t: t):
    """The x the GEMM multiplies and the dequantized weights, over the
    linear's segments (``sel`` picks one expert of a grouped operand)."""
    x, xq, wd = sel(lin["x"]), [], []
    sx = quant.abs_max_scale(x, dim=-1) if name == B2 else lin.get("sx")
    for wp, sc, p, off in lin["ops"]:
        xs = x[:, off:off + sel(wp).shape[0] * 8 // p]
        xq.append(pm.act_quant(xs, sx, p) if name in (B1, B2)
                  else xs.float())
        wd.append(pm.unpack_dequant(sel(wp), p, sel(sc).contiguous()))
    return torch.cat(xq, dim=-1), torch.cat(wd)


def _held(name, got, want, xq, wd):
    """|kernel - plain| within the fp32 reordering bound
    1e-5 * (|xq| @ |wd|) + 1e-6; returns the max |error|."""
    mag = xq.abs().double() @ wd.abs().double()
    err = (got.double() - want.double()).abs()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite output")
    if (err > 1e-5 * mag + 1e-6).any():
        raise AssertionError(f"{name} {tuple(xq.shape)}x{tuple(wd.shape)}: "
                             f"|err| {err.max().item():.3e} over the fp32 "
                             f"reordering bound")
    return err.max().item()


def check_segment_gemm(name, ops_list):
    """Kernel vs plain for every linear (one launch over its segments);
    returns the max |error|."""
    worst = 0.0
    for ops in ops_list:
        for lin in ops.linears:
            kw = _segment_kwargs(name, lin)
            got = pm.segments_matmul(lin["x"], lin["ops"], **kw)
            want = pm.segments_matmul_plain(lin["x"], lin["ops"], **kw)
            torch.cuda.synchronize()
            worst = max(worst, _held(name, got, want, *_xq_wd(name, lin)))
    return worst


def time_segment_gemm(name, sets, reps=20):
    """ms of one layer's 7 launches (one a linear; rotating operand sets
    so the weights come from device memory, as in a 24-layer step) as a
    loop of calls, the host's launch gaps included, and ``device_ms`` with
    the host queued ahead (the kernels back to back); plain ms; library
    ms (one torch.matmul a linear of the same quantized x and dequantized
    weights) on both rulers."""
    def run(fn):
        return lambda: [fn(lin["x"], lin["ops"], **_segment_kwargs(name, lin))
                        for ops in sets for lin in ops.linears]

    lib_ops = [_xq_wd(name, lin) for ops in sets for lin in ops.linears]

    def library():
        for a, b in lib_ops:
            torch.matmul(a, b)

    n = len(sets)
    ms = time_ms(run(pm.segments_matmul), reps) / n
    dev_ms = device_ms(run(pm.segments_matmul), reps) / n
    plain_ms = time_ms(run(pm.segments_matmul_plain), 2) / n
    library_ms = time_ms(library, reps) / n
    library_dev_ms = device_ms(library, reps) / n
    nbytes = flops = 0
    for lin in sets[0].linears:
        m = lin["x"].shape[0]
        k = sum(wp.shape[-2] * 8 // p for wp, _s, p, _o in lin["ops"])
        nbytes += (m * k * 2 + 2 * m * lin["n"] * 4
                   + (m * 4 if name == B1 else 0)
                   + sum(wp.numel() + sc.numel() * 4
                         for wp, sc, _p, _o in lin["ops"]))
        flops += 2 * m * k * lin["n"]
    b_ms, b_by = bound(nbytes, flops)
    return dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                library_ms=library_ms, library_device_ms=library_dev_ms,
                bound_ms=b_ms, bound_by=b_by)


def check_multi_segment_launches(cfg, gen, dev):
    """One launch over a leaf's segments is bitwise the single-segment
    launches into the same accumulator, in every mode: B1, B3 (x as it is
    and snapped), B6 (both) on h2o-danube-1.8b's k_proj shape (K = 2560,
    N = 640, default mix) at M = 4 and 32, and B2 (one segment) against
    its per-segment wrapper. Returns the number of comparisons."""
    qcfg = QuantConfig(mode="qat")
    n = 0
    for m in (4, 32):
        lin = LayerOperands(cfg, qcfg, m, gen, dev).linears[1]
        x, ops = lin["x"], lin["ops"]
        grouped = [(torch.stack([wp, wp.flip(0)]),
                    torch.stack([sc, sc.flip(0)]), p, off)
                   for wp, sc, p, off in ops]
        xg = torch.stack([x, x.flip(0)])
        for mode in ("fused", "plain", "snap", "grouped", "grouped_snap"):
            snap = mode.endswith("snap")
            xx, oo = (xg, grouped) if mode.startswith("grouped") else (x, ops)
            sx = lin["sx"] if mode == "fused" else None
            base = torch.randn(tuple(xx.shape[:-1]) + (lin["n"],),
                               generator=gen, device=dev)
            one = pm.segments_matmul(xx, oo, sx=sx, act_quant=snap,
                                     out=base.clone())
            three = base.clone()
            for wp, sc, p, off in oo:
                xs = xx[..., off:off + wp.shape[-2] * 8 // p]
                if xx.dim() == 3:
                    pm.packed_segment_matmul_grouped(xs, wp, sc, p=p,
                                                     act_quant=snap,
                                                     out=three)
                elif sx is not None:
                    pm.fused_act_segment_matmul(xs, sx, wp, sc, p=p,
                                                out=three)
                else:
                    pm.packed_segment_matmul(xs, wp, sc.contiguous(), p=p,
                                             act_quant=snap, out=three)
            torch.cuda.synchronize()
            if not torch.equal(one, three):
                raise AssertionError(f"one launch over the segments != "
                                     f"the single launches ({mode}, M={m})")
            n += 1
    u4 = LayerOperands(cfg, U4, 4, gen, dev).linears[0]
    wp, sc, p, _off = u4["ops"][0]
    if not torch.equal(
            pm.segments_matmul(u4["x"], u4["ops"], self_scale=True),
            pm.fused_act_selfscale_matmul(u4["x"], wp, sc, p=p)):
        raise AssertionError("self-scale: segments_matmul != its wrapper")
    return n + 1


def check_rows_across_batch(cfg, gen, dev):
    """A row's output is bitwise the same whatever the number of rows in
    the launch, M in {1, 4, 5, 16, 17, 32, 33} (every row tile the kernel
    picks), for B1, B2, B3 and B6 on h2o-danube-1.8b's k_proj shape.
    Returns the number of comparisons."""
    n = 0
    for name, qcfg in ((B1, QuantConfig(mode="qat")), (B2, U4),
                       (B3, QuantConfig(mode="qat")), (B6, None)):
        lin = LayerOperands(cfg, qcfg or QuantConfig(mode="qat"), 33, gen,
                            dev).linears[1]
        x, ops = lin["x"], lin["ops"]
        if name == B6:
            x = torch.stack([x, x.flip(0)])
            ops = [(torch.stack([wp, wp]), torch.stack([sc, sc]), p, off)
                   for wp, sc, p, off in ops]
        ref = None
        for m in (33, 32, 17, 16, 5, 4, 1):
            kw = _segment_kwargs(name, lin) if name != B6 else {}
            if name == B1:
                kw = dict(sx=lin["sx"][:m].contiguous())
            got = pm.segments_matmul(x[..., :m, :], ops, **kw)
            if ref is None:
                ref = got
            elif not torch.equal(got, ref[..., :m, :]):
                raise AssertionError(f"{name}: rows at M={m} differ from "
                                     f"the same rows at M=33")
            n += 1
    return n


# ------------------------------------------------- speculative widths ----
SPEC_TOKENS, DRAFT_BITS = 3, 2


def draft_ops(ops):
    """A leaf's draft segments (the [K2|K1] slice, the first at
    k_off = K4), cut by the drivers' own rule."""
    return backend.draft_segments(ops, DRAFT_BITS, bits_of=lambda op: op[2])


class DraftView:
    """Operands (``LayerOperands`` or ``GroupedOperands``) with every
    linear's segments cut to the draft slice."""

    def __init__(self, ops):
        for key in ("linears", "projs"):
            if hasattr(ops, key):
                setattr(self, key, [dict(lin, ops=draft_ops(lin["ops"]))
                                    for lin in getattr(ops, key)])
        if hasattr(ops, "rows"):
            self.rows = ops.rows


def check_draft_at_offset(name, lins):
    """Each draft launch (its first segment at k_off = K4 > 0) bitwise a
    launch of the same segments on x's columns from K4 on, which starts
    at k_off = 0 as every full launch does. Returns the launches
    compared."""
    for lin in lins:
        ops = lin["ops"]
        k0 = ops[0][3]
        if k0 == 0:
            raise AssertionError(f"{name}: a draft slice at k_off 0")
        kw = dict(sx=lin["sx"]) if name == B1 else {}
        got = pm.segments_matmul(lin["x"], ops, **kw)
        at0 = pm.segments_matmul(lin["x"][..., k0:],
                                 [(wp, sc, p, off - k0)
                                  for wp, sc, p, off in ops], **kw)
        torch.cuda.synchronize()
        if not torch.equal(got, at0):
            raise AssertionError(f"{name}: a draft launch at k_off {k0} "
                                 f"differs from the same launch at 0")
    return len(lins)


def check_dense_shapes(qcfg, gen, dev):
    """The shapes of the other dense configs (DENSE_CONFIGS: starcoder2-7b
    K = 18432 down, N = 512 k/v; deepseek-67b K = 22016; mistral-large-
    123b D = 12288, K = 28672), one full-width layer each: B1 within the
    fp32 bound at M = 4 (decode) and M = 16 (the verify), its draft
    launches within it and bitwise the launch at k_off 0, and B7 bitwise
    its plain version, one launch a linear. Returns per arch the max
    |error| and the launches compared."""
    out = {}
    for arch, _depth in DENSE_CONFIGS:
        cfg = get_config(arch)
        res = {}
        for m in (4, 4 * (SPEC_TOKENS + 1)):
            ops = LayerOperands(cfg, qcfg, m, gen, dev)
            res[f"M{m}_max_abs_err"] = check_segment_gemm(B1, [ops])
            if m == 4:
                draft = DraftView(ops)
                res["draft_max_abs_err"] = check_segment_gemm(B1, [draft])
                res["draft_bitwise_k_off_0"] = check_draft_at_offset(
                    B1, draft.linears)
                del draft
            del ops
            torch.cuda.empty_cache()
        calls = [pack_operands((k, n), qcfg, gen, dev)
                 for _name, k, n in layer_linears(cfg)]
        _check_pack(calls)
        res["b7_bitwise_launches"] = len(calls)
        del calls
        torch.cuda.empty_cache()
        out[arch] = res
    return out


def pack_operands(shape, qcfg, gen, dev):
    """B7 operands of a [K, N] linear or an [S, K, N] bank as the packing
    driver hands them: a random group order per slice expanded to an int32
    channel perm, the group scales in sorted order, and ``qcfg``'s
    [K4|K2|K1] split."""
    *lead, k, n = shape
    s = lead[0] if lead else 1
    w = torch.randn((s, k, n), generator=gen, device=dev) * 0.02
    gperm = torch.argsort(torch.rand((s, k // 16), generator=gen,
                                     device=dev), dim=-1)
    perm = (gperm[..., None] * 16 + torch.arange(16, device=dev)).reshape(
        s, k).to(torch.int32)
    mag = torch.linalg.vector_norm(w.reshape(s, k // 16, -1),
                                   ord=float("inf"), dim=-1)
    sc = quant.div_const(torch.clamp_min(torch.gather(mag, 1, gperm),
                                         quant.ACT_SCALE_EPS),
                         quant.static_grid_max(4))
    if not lead:
        w, perm, sc = w[0], perm[0], sc[0]
    return w, perm, sc, qcfg.segments(k)


def _pack_layer(calls):
    return [qp.quantize_pack_segments(w, perm, sc, segments=segs)
            for w, perm, sc, segs in calls]


def _pack_layer_plain(calls):
    return [qp.quantize_pack_segments_plain(w, perm, sc, segments=segs)
            for w, perm, sc, segs in calls]


def _check_pack(calls):
    """Each launch bitwise its plain version; one launch a call."""
    kernels.reset_launch_counts()
    got = _pack_layer(calls)
    torch.cuda.synchronize()
    if kernels.launch_counts()[B7] != len(calls):
        raise AssertionError(f"{kernels.launch_counts()[B7]} B7 launches "
                             f"for {len(calls)} linears and banks")
    for (w, _perm, _sc, segs), outs, want in zip(calls, got,
                                                 _pack_layer_plain(calls)):
        for a, b in zip(outs, want):
            if a.shape != b.shape or not torch.equal(a, b):
                raise AssertionError(
                    f"quantize_pack_segments {tuple(w.shape)} {segs}: "
                    f"{(a != b).sum().item()} bytes differ from the plain "
                    f"version")


def _pack_bound(calls):
    """Each weight (in its own dtype), perm and scale read once, each
    carrier byte written once; ~6 operations an element."""
    nbytes = sum(w.numel() * w.element_size() + perm.numel() * 4
                 + sc.numel() * 4
                 + sum(kp * p // 8 for p, kp in zip((4, 2, 1), segs))
                 * w.shape[-1] * (w.shape[0] if w.dim() == 3 else 1)
                 for w, perm, sc, segs in calls)
    return bound(nbytes, sum(6 * w.numel() for w, *_ in calls))


def phase_quant_pack(cfg, moe_cfg, qcfg, gen, dev, reps=10):
    """B7 vs plain (bitwise) through the one-launch entry: one
    h2o-danube-1.8b layer (7 launches, one a linear; timed rotating 4
    weight sets: 4 x 278 MB of fp32 weights) and one deepseek-moe-16b MoE
    layer (q/k/v/o, the shared experts, the three [E, K, N] routed banks:
    10 launches, 2.35 GB of fp32 weights), each read through a random
    channel perm."""
    sets = [[pack_operands((k, n), qcfg, gen, dev)
             for _name, k, n in layer_linears(cfg)] for _ in range(4)]
    _check_pack(sets[0])
    kern = lambda: [_pack_layer(c) for c in sets]  # noqa: E731
    plain = lambda: [_pack_layer_plain(c) for c in sets]  # noqa: E731
    ms = time_ms(kern, reps) / 4
    dev_ms = device_ms(kern, reps) / 4
    plain_ms = time_ms(plain, 2) / 4
    b_ms, b_by = _pack_bound(sets[0])
    del sets
    torch.cuda.empty_cache()
    d, f, e = moe_cfg.d_model, moe_cfg.d_ff, moe_cfg.num_experts
    hq = moe_cfg.num_heads * moe_cfg.hd
    hk = moe_cfg.num_kv_heads * moe_cfg.hd
    fs = f * moe_cfg.num_shared_experts
    moe = [pack_operands(shape, qcfg, gen, dev) for shape in (
        (d, hq), (d, hk), (d, hk), (hq, d), (d, fs), (d, fs), (fs, d),
        (e, d, f), (e, d, f), (e, f, d))]
    _check_pack(moe)
    moe_b_ms, _by = _pack_bound(moe)
    out = dict(max_abs_err=0.0, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
               library_ms=None, bound_ms=b_ms, bound_by=b_by,
               launches_per_layer=7,
               moe_layer_ms=time_ms(lambda: _pack_layer(moe), 5),
               moe_layer_device_ms=device_ms(lambda: _pack_layer(moe), 5),
               moe_layer_plain_ms=time_ms(lambda: _pack_layer_plain(moe),
                                          1),
               moe_layer_bound_ms=moe_b_ms, moe_layer_launches=len(moe))
    del moe
    torch.cuda.empty_cache()
    return out


def profile_load(build):
    """(what ``build`` returns, the device view of the call under
    torch.profiler: busy ms, device events and the split by op of
    ``step_profile.load_summary``)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = build()
        torch.cuda.synchronize()
    return out, step_profile.load_summary(prof)


def packed_leaves(model) -> int:
    """Packed linears and expert banks of a serve model."""
    count = 0

    def walk(node):
        nonlocal count
        if isinstance(node, dict):
            count += "w4" in node
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)

    walk(model.tree())
    return count


# ---------------------------------------------------- grouped GEMM ----
class GroupedOperands:
    """B6 operands of one MoE layer's three expert projections (up, gate,
    down) in the dispatch layout: a top-k route of T random router logits
    gives each expert its count of rows, its live rows come first in
    x [E, T, K] bf16 and the rest are zero; ``rows`` [E] int32 holds the
    counts. Carriers [E, Kp * p / 8, N], per-expert group scales read as
    column slices of [E, K / 16], as the grouped driver passes them."""

    def __init__(self, cfg, qcfg, t, gen, dev):
        e = cfg.num_experts
        _gates, ids = moe_lib.route(
            torch.randn((t, e), generator=gen, device=dev), cfg.top_k)
        flat = ids.reshape(-1)
        self.rows = torch.zeros(e, dtype=torch.int32, device=dev)
        self.rows.scatter_add_(0, flat, torch.ones_like(flat,
                                                        dtype=torch.int32))
        live = (torch.arange(t, device=dev)[None, :]
                < self.rows[:, None]).float()
        self.projs = []
        for k, n in ((cfg.d_model, cfg.d_ff), (cfg.d_model, cfg.d_ff),
                     (cfg.d_ff, cfg.d_model)):
            x = torch.randn((e, t, k), generator=gen, device=dev)
            x = (x * live[..., None]).to(torch.bfloat16)
            wscale = torch.rand((e, k // 16), generator=gen, device=dev) \
                * 0.02 + 0.001
            ops = []
            for p, off, kp, goff in segment_shapes(qcfg, k):
                wp = torch.randint(0, 256, (e, kp * p // 8, n),
                                   generator=gen, device=dev,
                                   dtype=torch.uint8)
                ops.append((wp, wscale[:, goff:goff + kp // 16], p, off))
            self.projs.append(dict(x=x, ops=ops, n=n))


def _grouped_bound(ops, experts, live_rows):
    """(bound ms, by what) of the projections over the given experts, each
    with every row or with its live rows only: each read carrier, scale
    and activation byte once, each output read and written once."""
    t = ops.projs[0]["x"].shape[1]
    rows = ops.rows.tolist() if live_rows else [t] * len(ops.rows)
    nbytes = flops = 0
    for pr in ops.projs:
        k = sum(wp.shape[-2] * 8 // p for wp, _s, p, _o in pr["ops"])
        for e in experts:
            nbytes += (rows[e] * k * 2 + 2 * rows[e] * pr["n"] * 4
                       + sum(wp[e].numel() + sc[e].numel() * 4
                             for wp, sc, _p, _o in pr["ops"]))
            flops += 2 * rows[e] * k * pr["n"]
    return bound(nbytes, flops)


def phase_grouped_segment(ops):
    """B6 on one MoE layer's 3 projections (one launch over the three
    segments each) against its plain version: every expert held to the
    fp32 reordering bound and bitwise the dense launch on its operands;
    with ``rows`` bitwise the launch without it on every live row, every
    row past the count untouched. Timed with and without ``rows``, as a
    loop of calls (``ms``) and with the host queued ahead (``device_ms``),
    beside the plain version and a torch.bmm of the dequantized operands
    over the same experts (all of them; the live ones) on both rulers."""
    worst = 0.0
    counts = ops.rows.tolist()
    for pr in ops.projs:
        x = pr["x"]
        got = pm.segments_matmul(x, pr["ops"])
        want = pm.segments_matmul_plain(x, pr["ops"])
        sentinel = torch.full_like(got, 3.25)
        full = pm.segments_matmul(x, pr["ops"], out=sentinel.clone())
        part = pm.segments_matmul(x, pr["ops"], rows=ops.rows,
                                  out=sentinel.clone())
        torch.cuda.synchronize()
        for e in range(x.shape[0]):
            sel = lambda t, e=e: t[e]  # noqa: E731
            worst = max(worst, _held(B6, got[e], want[e],
                                     *_xq_wd(B3, pr, sel)))
            alone = pm.segments_matmul(
                x[e], [(wp[e], sc[e].contiguous(), p, off)
                       for wp, sc, p, off in pr["ops"]])
            if not torch.equal(alone, got[e]):
                raise AssertionError(f"B6 expert {e} differs from the dense "
                                     f"launch on its operands")
            r = counts[e]
            if not torch.equal(part[e, :r], full[e, :r]) or \
                    not (part[e, r:] == 3.25).all():
                raise AssertionError(f"B6 with rows: expert {e} ({r} live "
                                     f"rows) differs")
    kern = lambda rows=None: [pm.segments_matmul(  # noqa: E731
        pr["x"], pr["ops"], rows=rows) for pr in ops.projs]
    plain = lambda: [pm.segments_matmul_plain(  # noqa: E731
        pr["x"], pr["ops"]) for pr in ops.projs]
    every = list(range(ops.projs[0]["x"].shape[0]))
    live = [e for e in every if counts[e] > 0]

    def bmm_ops(experts):
        out = []
        for pr in ops.projs:
            xw = [_xq_wd(B3, pr, lambda t, e=e: t[e]) for e in experts]
            out.append((torch.stack([a for a, _b in xw]).contiguous(),
                        torch.stack([b for _a, b in xw])))
        return out

    lib_all, lib_live = bmm_ops(every), bmm_ops(live)
    b_all, by_all = _grouped_bound(ops, every, live_rows=False)
    b_live, by_live = _grouped_bound(ops, live, live_rows=True)
    bmm_all = lambda: [torch.bmm(a, b) for a, b in lib_all]  # noqa: E731
    bmm_live = lambda: [torch.bmm(a, b) for a, b in lib_live]  # noqa: E731
    return dict(max_abs_err=worst, ms=time_ms(kern, 20),
                device_ms=device_ms(kern, 20), plain_ms=time_ms(plain, 1),
                library_ms=time_ms(bmm_all, 20),
                library_device_ms=device_ms(bmm_all, 20),
                bound_ms=b_all, bound_by=by_all,
                rows_ms=time_ms(lambda: kern(ops.rows), 20),
                rows_device_ms=device_ms(lambda: kern(ops.rows), 20),
                rows_bound_ms=b_live, rows_bound_by=by_live,
                rows_library_ms=time_ms(bmm_live, 20),
                rows_library_device_ms=device_ms(bmm_live, 20),
                live_experts=len(live), live_rows=sum(counts),
                carrier_bytes=sum(wp.numel() for pr in ops.projs
                                  for wp, _s, _p, _o in pr["ops"]))


def check_two_pass_equals_fused(model, qcfg, gen, dev):
    """Every serve linear of the model's first layer on bf16 activations
    (M = 4 and M = 32): the two-pass form (B8, then B3) bitwise the fused
    form (B1 / B2), under per-token and per-tensor scales. Returns the
    number of outputs compared."""
    n = 0
    for name, lin in smol.smol_linears(model.blocks[0]):
        leaf = lin.leaf()
        if "w4" not in leaf:
            continue
        k = leaf["perm"].shape[-1]
        for m in (4, 32):
            x = (torch.randn((m, k), generator=gen, device=dev)
                 * 3).to(torch.bfloat16)
            for mode in ("per_token", "per_tensor"):
                fused = dataclasses.replace(qcfg, act_scale_mode=mode,
                                            fuse_act_quant=True)
                two = dataclasses.replace(fused, fuse_act_quant=False)
                a = backend.packed_matmul(leaf, x, fused)
                b = backend.packed_matmul(leaf, x, two)
                if not torch.equal(a, b):
                    raise AssertionError(f"two-pass != fused at {name} "
                                         f"(M={m}, {mode})")
                n += 1
    return n


# ------------------------------------------------------ decode attention ----
class RingOperands:
    """B4 operands at full width: batch 4, a ring of T entries (row 0
    wrapped, row 1 half empty), S query rows at the newest positions (a
    masked lane in row 3)."""

    def __init__(self, cfg, s, t, window, gen, dev, b=4):
        hk, g, d = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads, \
            cfg.hd
        self.window = window
        self.q = torch.randn((b, s, hk, g, d), generator=gen, device=dev)
        k = torch.randn((b, t, hk, d), generator=gen, device=dev) * 2.0
        v = torch.randn((b, t, hk, d), generator=gen, device=dev)
        self.kc, self.ks = kv_quant.quantize_kv(k)
        self.vc, self.vs = kv_quant.quantize_kv(v)
        pos = torch.arange(t, device=dev, dtype=torch.int32).repeat(b, 1)
        pos[0] = (pos[0] + t // 3) % t + t
        pos[1, t // 2:] = -1
        self.kv_pos = pos
        qp_ = torch.arange(s, device=dev, dtype=torch.int32) \
            + int(pos.max()) - s + 1
        self.q_pos = qp_.repeat(b, 1)
        self.q_pos[3, 0] = -1

    def args(self):
        return (self.q, self.kc, self.vc, self.ks, self.vs, self.kv_pos,
                self.q_pos)

    def dense(self):
        return (kv_quant.dequantize_kv(self.kc, self.ks, torch.float32),
                kv_quant.dequantize_kv(self.vc, self.vs, torch.float32),
                self.kv_pos)

    def nbytes(self):
        b, t = self.kv_pos.shape
        return (2 * self.kc.numel() + 2 * self.ks.numel() * 2 + b * t * 4
                + 2 * self.q.numel() * 4 + self.q_pos.numel() * 4)

    def flops(self):
        return 4 * self.q.numel() * self.kv_pos.shape[1]


class PagedOperands:
    """B5 operands at full width: batch 4, ``npg`` pages of 16 a slot from
    a shuffled pool, slot 0's page 3 unmapped, slot 1's page 0 shared with
    slot 0's, positions stamped as a ring of npg * 16 entries."""

    def __init__(self, cfg, s, npg, window, gen, dev, b=4, ps=16):
        hk, g, d = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads, \
            cfg.hd
        npages = b * npg + 1
        self.window = window
        self.q = torch.randn((b, s, hk, g, d), generator=gen, device=dev)
        k = torch.randn((npages, ps, hk, d), generator=gen, device=dev) * 2.0
        v = torch.randn((npages, ps, hk, d), generator=gen, device=dev)
        self.kc, self.ks = kv_quant.quantize_kv(k)
        self.vc, self.vs = kv_quant.quantize_kv(v)
        for x in (self.kc, self.ks, self.vc, self.vs):
            x[0] = 0                                   # the null page
        perm = torch.randperm(npages - 1, generator=gen, device=dev) + 1
        table = perm[:b * npg].reshape(b, npg).to(torch.int32)
        table[0, 3] = -1
        table[1, 0] = table[0, 0]
        self.table = table
        pos = torch.full((npages, ps), -1, dtype=torch.int32, device=dev)
        lp = torch.arange(npg, device=dev)[:, None] * ps \
            + torch.arange(ps, device=dev)[None]
        for bi in range(b):
            live = table[bi] >= 0
            pos[table[bi][live].long()] = lp[live].to(torch.int32)
        self.pool_pos = pos
        qp_ = torch.arange(s, device=dev, dtype=torch.int32) + npg * ps - s
        self.q_pos = qp_.repeat(b, 1)
        self.q_pos[3, 0] = -1

    def args(self):
        return (self.q, self.kc, self.vc, self.ks, self.vs, self.pool_pos,
                self.table, self.q_pos)

    def cache(self):
        return {"k_codes": self.kc, "v_codes": self.vc, "k_scale": self.ks,
                "v_scale": self.vs, "pos": self.pool_pos,
                "page_table": self.table}

    def dense(self):
        return kv_pool.gather_paged(self.cache())

    def ring_args(self):
        """The same content as a [B, NP * ps] ring (B4's operands)."""
        safe = self.table.long().clamp(min=0)
        b, npg = self.table.shape
        ring = [x[safe].reshape((b, npg * x.shape[1]) + x.shape[2:])
                .contiguous() for x in (self.kc, self.vc, self.ks, self.vs)]
        return (self.q, *ring, self.dense()[2].contiguous(), self.q_pos)

    def nbytes(self):
        pages = torch.unique(self.table.clamp(min=0)).numel()
        ps = self.pool_pos.shape[1]
        per_page = ps * (2 * self.kc[0, 0].numel() + 2 * 2
                         * self.ks[0, 0].numel() + 4)
        return (pages * per_page + self.table.numel() * 4
                + 2 * self.q.numel() * 4 + self.q_pos.numel() * 4)

    def flops(self):
        return 4 * self.q.numel() * self.table.shape[1] \
            * self.pool_pos.shape[1]


def check_attention(name, ops):
    """Kernel vs plain on one operand set; returns the max |error|."""
    if name == B4:
        got = ad.qkv_attn_decode(*ops.args(), window=ops.window)
        want = ad.qkv_attn_decode_plain(*ops.args(), window=ops.window)
    else:
        got = ad.qkv_attn_decode_paged(*ops.args(), window=ops.window)
        want = ad.qkv_attn_decode_paged_plain(*ops.args(),
                                              window=ops.window)
    torch.cuda.synchronize()
    k, v, k_pos = ops.dense()
    bound = ad.error_bound(ops.q, k, v, k_pos, ops.q_pos, ops.window)
    err = (got.double() - want.double()).abs()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite output")
    if (err > bound).any():
        raise AssertionError(f"{name} {tuple(ops.q.shape)}: |err| "
                             f"{err.max().item():.3e} over the bound")
    if name == B5:
        ring = ad.qkv_attn_decode(*ops.ring_args(), window=ops.window)
        if not torch.equal(ring, got):
            raise AssertionError("B5 rows differ from B4's on the same "
                                 "content laid out as a ring")
    return err.max().item()


def time_attention(name, ops, reps=50):
    """ms of the kernel, its plain version and one
    scaled_dot_product_attention on the dequantized fp32 K/V under the
    same mask (heads expanded beforehand; timing only), with the bound.
    The kernel and SDPA on both rulers: a loop of calls (``ms``,
    ``library_ms``) and queued ahead (``device_ms``,
    ``library_device_ms``)."""
    import torch.nn.functional as F
    fn = ad.qkv_attn_decode if name == B4 else ad.qkv_attn_decode_paged
    plain = ad.qkv_attn_decode_plain if name == B4 \
        else ad.qkv_attn_decode_paged_plain
    args = ops.args()

    def kernel():
        fn(*args, window=ops.window)

    k, v, k_pos = ops.dense()
    b, s, hk, g, d = ops.q.shape
    q4 = ops.q.reshape(b, s, hk * g, d).transpose(1, 2).contiguous()
    k4 = k.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
    v4 = v.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
    mask = ad.attention_mask(ops.q_pos, k_pos, ops.window)[:, None]

    def library():
        F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask)

    b_ms, b_by = bound(ops.nbytes(), ops.flops())
    return dict(ms=time_ms(kernel, reps), device_ms=device_ms(kernel, reps),
                plain_ms=time_ms(lambda: plain(*args, window=ops.window), 5),
                library_ms=time_ms(library, reps),
                library_device_ms=device_ms(library, reps),
                bound_ms=b_ms, bound_by=b_by)


# (label, kernel, config, T or pages a slot, window, S checked, timed at
# S = 1): the decode shapes of the two serve configurations, a window that
# binds, entry counts not a multiple of the split's chunk (17 pages of 16)
# and the long paged row.
ATTENTION_CASES = (
    ("h2o_T256", B4, ARCH, 256, None, (1, 8), True),
    ("h2o_T4096_w1024", B4, ARCH, 4096, 1024, (1, 8), True),
    ("h2o_16x16", B5, ARCH, 16, None, (1, 8), True),
    ("h2o_16x16_w100", B5, ARCH, 16, 100, (1, 8), False),
    ("h2o_17x16_w100", B5, ARCH, 17, 100, (1,), False),
    ("h2o_256x16_w1024", B5, ARCH, 256, 1024, (1,), True),
    ("deepseek_T256", B4, MOE_ARCH, 256, None, (1, 8), True),
    ("deepseek_16x16", B5, MOE_ARCH, 16, None, (1, 8), True),
    ("deepseek_17x16_w100", B5, MOE_ARCH, 17, 100, (1,), False),
    ("starcoder2_T256", B4, DENSE_ARCH, 256, None, (1, 4), True),
    ("starcoder2_16x16", B5, DENSE_ARCH, 16, None, (1, 4), True),
)


def check_verify_lanes(gen, dev):
    """B4 and B5 at S = k + 1 = 4, the verify step at batch 4 (four lanes
    at the newest positions of each row, one lane masked, the later lanes'
    entries already in the cache): lane j bitwise the S = 1 call at lane
    j's position on the same cache, at G = 4 (h2o-danube-1.8b), G = 1
    (deepseek-moe-16b: the decode runs the 1-row body, the verify the
    4-row one) and G = 9 (starcoder2-7b, Hk = 4, D = 128: the decode's
    S * G = 9 ends in a ragged tile). Returns the lanes compared."""
    n = 0
    for arch in (ARCH, MOE_ARCH, DENSE_ARCH):
        cfg = get_config(arch)
        for name, fn in ((B4, ad.qkv_attn_decode),
                         (B5, ad.qkv_attn_decode_paged)):
            ops = RingOperands(cfg, SPEC_TOKENS + 1, 256, None, gen, dev) \
                if name == B4 else PagedOperands(cfg, SPEC_TOKENS + 1, 16,
                                                 None, gen, dev)
            args = list(ops.args())
            full = fn(*args)
            for j in range(SPEC_TOKENS + 1):
                args[0] = ops.q[:, j:j + 1].contiguous()
                args[-1] = ops.q_pos[:, j:j + 1].contiguous()
                lane = fn(*args)
                torch.cuda.synchronize()
                if not torch.equal(lane[:, 0], full[:, j]):
                    raise AssertionError(f"{name} {arch}: verify lane {j} "
                                         f"differs from the S=1 call")
                n += 1
            del ops
    return n


def phase_attention(gen, dev):
    """B4 and B5 against their plain versions at every case of
    ``ATTENTION_CASES`` (B5 also bitwise B4 on its content laid out as a
    ring), timed at S = 1 where marked. A kernel's row: its h2o decode
    shape (T = 256; 16 pages of 16) at the top, every timed case under
    ``shapes``."""
    results = {B4: {"max_abs_err": 0.0, "shapes": {}},
               B5: {"max_abs_err": 0.0, "shapes": {}}}
    for label, name, arch, size, w, svals, timed in ATTENTION_CASES:
        cfg = get_config(arch)
        for s in svals:
            ops = RingOperands(cfg, s, size, w, gen, dev) if name == B4 \
                else PagedOperands(cfg, s, size, w, gen, dev)
            err = check_attention(name, ops)
            res = results[name]
            res["max_abs_err"] = max(res["max_abs_err"], err)
            log(f"[3] {name} {label} S={s}: max |err| {err:.3e} within the "
                f"bound{'' if name == B4 else '; == B4 on the ring layout'}")
            if timed and s == 1:
                res["shapes"][label] = time_attention(name, ops)
                log(f"[3] {name} {label} S=1: {res['shapes'][label]}")
            del ops
    results[B4].update(results[B4]["shapes"]["h2o_T256"])
    results[B5].update(results[B5]["shapes"]["h2o_16x16"])
    n = check_verify_lanes(gen, dev)
    log(f"[3] verify lanes (S={SPEC_TOKENS + 1}) bitwise the S=1 calls at "
        f"G in {{4, 1, 9}}, B4 and B5: {n} lanes")
    return results


# ----------------------------------------------------------------- serve ----
def requests(vocab, rng, n=8, lo=16, hi=64, new=16):
    return [Request(prompt=rng.integers(0, vocab, int(rng.integers(lo, hi + 1))
                                        ).astype(np.int32),
                    max_new_tokens=new, seed=i) for i in range(n)]


def serve_all(eng, reqs, cross=None):
    """``reqs`` through the emptied engine: (completions in request order,
    wall seconds of the serve). ``cross``: an encoder output loaded first
    (``load_cross``, outside the timed serve)."""
    eng.reset()
    if cross is not None:
        eng.load_cross(cross)
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = {c.request_id: c for c in eng.serve(
        [dataclasses.replace(r) for r in reqs])}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    base = min(out)
    return [out[base + i] for i in range(len(reqs))], wall


def decode_step_ms(eng, steps=10):
    """Host-clock time of one greedy decode step at batch max_batch."""
    b = eng.ecfg.max_batch
    cache = fresh_cache(eng)
    tokens = np.arange(1, b + 1, dtype=np.int32)
    times = []
    for t in range(steps + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = lm.decode_step(eng.model, eng.cfg, cache, tokens,
                                       np.full(b, 64 + t))
        tokens = logits.argmax(-1).cpu().numpy().astype(np.int32)
        times.append(time.perf_counter() - t0)
    return float(np.median(times[2:]) * 1e3)


def fresh_cache(eng):
    """A fresh decode cache at batch max_batch; a paged one maps each slot
    to its own run of pages (what the engine's allocator would hand out),
    so the step writes and attends as in serving."""
    b = eng.ecfg.max_batch
    cache = eng.init_cache(b)
    if eng.ecfg.kv_layout == "paged":
        table = kv_pool.paged_layers(cache)[0]["page_table"]
        table.copy_(1 + torch.arange(table.numel(), device=table.device,
                                     dtype=torch.int32).reshape(table.shape))
    return cache


def step_launches(eng):
    """Launches of each kernel in one greedy decode step at batch
    max_batch."""
    b = eng.ecfg.max_batch
    cache = fresh_cache(eng)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    lm.decode_step(eng.model, eng.cfg, cache,
                   np.arange(1, b + 1, dtype=np.int32), np.full(b, 64))
    torch.cuda.synchronize()
    return kernels.launch_counts()


def profile_decode(eng, steps=3):
    """Device view of greedy decode steps at batch max_batch (torch
    profiler): kernels launched, device busy time and the top kernels by
    device time, per step."""
    from torch.profiler import ProfilerActivity, profile
    b = eng.ecfg.max_batch
    state = {"cache": fresh_cache(eng),
             "tokens": np.arange(1, b + 1, dtype=np.int32)}

    def step(t):
        logits, state["cache"] = lm.decode_step(
            eng.model, eng.cfg, state["cache"], state["tokens"],
            np.full(b, 64 + t))
        state["tokens"] = logits.argmax(-1).cpu().numpy().astype(np.int32)

    step(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for t in range(steps):
            step(1 + t)
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")]
    busy = sum(e.device_time_total for e in kern) / steps / 1e3
    top = sorted(kern, key=lambda e: -e.device_time_total)[:4]
    attn = [e for e in kern if "attn_kernel" in e.key]
    return {"kernels_per_step": sum(e.count for e in kern) / steps,
            "device_busy_ms_per_step": busy,
            "attn_ms_per_step": sum(e.device_time_total for e in attn)
            / steps / 1e3,
            "top": [(e.key[:72], round(e.device_time_total / steps / 1e3, 3))
                    for e in top]}


def check_lockstep_equals_continuous(eng, cfg, ecfg, vocab, rng, s0, new):
    lock = engine.LockstepEngine(eng.model, cfg, ecfg, already_serve=True,
                                 device=eng.device)
    prompts = rng.integers(0, vocab, (ecfg.max_batch, s0)).astype(np.int32)
    a = lock.generate(prompts, new)
    b = eng.generate(prompts, new)
    if not np.array_equal(a, b):
        raise AssertionError(f"lockstep != continuous:\n{a}\n{b}")


def _prefill_then_decode(model, cfg, dev):
    """Logits of a 4 x 8 prefill chunk and of one decode step after it."""
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab_size, (4, 9)).astype(np.int32)
    pos = np.tile(np.arange(8), (4, 1))
    cache = lm.init_cache(cfg, 4, 64, torch.float32, device=dev)
    a, cache = lm.prefill_step(model, cfg, cache, tokens[:, :8], pos,
                               np.full(4, 7))
    b, _ = lm.decode_step(model, cfg, cache, tokens[:, 8], np.full(4, 8))
    return [a.double().cpu(), b.double().cpu()]


def rel_l2(a, b) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return ((a - b).norm() / b.norm()).item()


class LinearTape:
    """Hooks on every linear of a model, recording each call's input and
    output in call order. With ``feed`` (another tape's inputs) each call
    runs on the fed input; the input the model's own ops made is still
    what the tape records, and a gradient still reaches it (the fed values
    enter as ``fed + (x - x.detach())``)."""

    def __init__(self, model, feed=None):
        self.inputs, self.outputs, self.feed = [], [], feed
        self.handles = []
        for name, mod in model.named_modules():
            if isinstance(mod, smol.SmolLinear):
                self.handles += [
                    mod.register_forward_pre_hook(self._pre(name)),
                    mod.register_forward_hook(self._post)]

    def _pre(self, name):
        def hook(mod, args):
            self.inputs.append((name, mod, args[0].detach()))
            if self.feed is None:
                return None
            fed_name, _mod, x = self.feed[len(self.inputs) - 1]
            if fed_name != name:
                raise AssertionError(f"call order: {name} vs {fed_name}")
            x = x.to(args[0].device)
            if args[0].requires_grad:
                x = x + (args[0] - args[0].detach())
            return (x,) + tuple(args[1:])
        return hook

    def _post(self, mod, args, out):
        self.outputs.append(out.detach())

    def close(self):
        for h in self.handles:
            h.remove()


def code_coords(lin, x, qcfg):
    """A serve linear's input in activation code units, as
    ``backend.base.packed_matmul`` quantizes it: the channel perm, the
    per-token scale, then t = (u / h + 2^p - 1) / 2 at
    each channel's precision p (h = 2^(1-p)); the code is t rounded half
    to even and clipped to [0, 2^p - 1]. Returns (codes, t)."""
    xp = x.reshape(-1, x.shape[-1]).float().cpu().index_select(
        -1, lin.perm.cpu())
    k = xp.shape[-1]
    p = quant.expand_groups(lin.pbits_sorted.float().cpu(), k,
                            qcfg.eff_group_size(k))
    u = xp / quant.abs_max_scale(xp, dim=-1)
    t = (u / torch.exp2(1.0 - p) + (torch.exp2(p) - 1.0)) / 2.0
    return quant.quantize_to_int(u, p), t


def check_against_cpu(qat_cfg, ecfg, dev, full_layers=2):
    """The kernels on the card against the plain versions on the CPU, fp32.

    (1) Reduced h2o-danube-1.8b end to end: the logits of a prefill chunk
    and a decode step within relative L2 1e-5.
    (2) Full width, ``full_layers`` layers, a prefill chunk and a decode
    step, teacher-forced: the CPU runs them and records every serve
    linear's input; the card runs them with each linear fed the CPU's
    input to it. No activation the card computes then reaches a later
    requantization, so a code that flips cannot cascade, and every op of
    the card's path is held on its own: each linear's output on the CPU's
    input (the segment kernels); each linear's input as the card's own
    ops made it (norms, RoPE, ring write, attention, SwiGLU, residual
    adds); and the logits. Each within relative L2 1e-5. Where a card
    input quantizes to another code than the CPU's, both values must sit
    within 1e-3 of a code step of each other, across the rounding boundary
    between them: a knife edge, not a fault (ROADMAP.md §C).
    Returns the numbers."""
    out = {}
    small = dataclasses.replace(qat_cfg.reduced(), dtype="float32")
    eng = engine.DecodeEngine(lm.init_params(small, seed=SEED + 1,
                                             device=dev), small, ecfg,
                            device=dev)
    card = _prefill_then_decode(eng.model, eng.cfg, dev)
    cpu = _prefill_then_decode(copy.deepcopy(eng.model).to("cpu"), eng.cfg,
                               "cpu")
    out["reduced_logits_rel_l2"] = max(
        rel_l2(a, b) for a, b in zip(card, cpu))
    wide = dataclasses.replace(qat_cfg, num_layers=full_layers,
                               dtype="float32")
    eng = engine.DecodeEngine(lm.init_params(wide, seed=SEED + 1,
                                             device=dev), wide, ecfg,
                            device=dev)
    host = copy.deepcopy(eng.model).to("cpu")
    qcfg = eng.cfg.quant
    tape_cpu = LinearTape(host)
    logits_cpu = _prefill_then_decode(host, eng.cfg, "cpu")
    tape_cpu.close()
    tape_card = LinearTape(eng.model, feed=tape_cpu.inputs)
    logits_card = _prefill_then_decode(eng.model, eng.cfg, dev)
    tape_card.close()
    calls = len(tape_cpu.inputs)
    if len(tape_card.inputs) != calls or calls != 7 * full_layers * 2:
        raise AssertionError(f"linear calls: card {len(tape_card.inputs)}, "
                             f"CPU {calls}")
    worst_in = worst_out = worst_dt = 0.0
    flips = []
    for (name, lin, x_card), (_n, _l, x_cpu), y_card, y_cpu in zip(
            tape_card.inputs, tape_cpu.inputs, tape_card.outputs,
            tape_cpu.outputs):
        worst_out = max(worst_out, rel_l2(y_card, y_cpu))
        worst_in = max(worst_in, rel_l2(x_card, x_cpu))
        c_card, t_card = code_coords(lin, x_card, qcfg)
        c_cpu, t_cpu = code_coords(lin, x_cpu, qcfg)
        flip = c_card != c_cpu
        if flip.any():
            flips.append((name, int(flip.sum())))
            worst_dt = max(worst_dt,
                           (t_card - t_cpu)[flip].abs().max().item())
    out.update(full_width_calls=calls,
               full_width_linear_out_rel_l2=worst_out,
               full_width_linear_in_rel_l2=worst_in,
               full_width_logits_rel_l2=max(
                   rel_l2(a, b) for a, b in zip(logits_card, logits_cpu)),
               flipped_codes=flips, flipped_max_code_step=worst_dt)
    held = (out["reduced_logits_rel_l2"] <= 1e-5 and worst_out <= 1e-5
            and worst_in <= 1e-5 and out["full_width_logits_rel_l2"] <= 1e-5
            and worst_dt <= 1e-3)
    if not held:
        raise AssertionError(f"card vs CPU: {out}")
    return out


def shared_prefix_requests(vocab, rng, prefix=224, tail=16, waves=(8, 32),
                           per_wave=4):
    """Two waves of same-length prompts sharing a ``prefix``-token system
    prompt: the first (short answers) registers the prefix pages, the
    second maps them and decodes past the ring's end."""
    system = rng.integers(0, vocab, prefix).astype(np.int32)
    reqs = []
    for new in waves:
        for _ in range(per_wave):
            prompt = np.concatenate(
                [system, rng.integers(0, vocab, tail).astype(np.int32)])
            reqs.append(Request(prompt=prompt, max_new_tokens=new,
                                seed=len(reqs)))
    return reqs


def timed_serve(eng, reqs, step_counts=None, cross=None):
    """Serve ``reqs`` step by step: (completions in request order, wall
    seconds, median host-clock ms of the steps where every active slot
    decodes (a speculative engine's rounds), with the pool checked after
    every step). ``step_counts``, a dict, receives the kernel launches of
    the first such step. ``cross``: an encoder output, loaded into the
    emptied engine (``load_cross``) before the requests."""
    eng.reset()
    if cross is not None:
        eng.load_cross(cross)
    for r in reqs:
        eng.submit(dataclasses.replace(r))
    out, decode_ms = {}, []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while eng.sched.has_work():
        decoding = bool(eng.sched.slots) and not eng.sched.pending and all(
            st.phase == DECODE for st in eng.sched.slots.values())
        before = kernels.launch_counts()
        t1 = time.perf_counter()
        done = eng.step()
        torch.cuda.synchronize()
        if decoding:
            decode_ms.append((time.perf_counter() - t1) * 1e3)
            if step_counts is not None and not step_counts:
                step_counts.update(
                    (k, v - before[k]) for k, v in kernels.launch_counts()
                    .items() if v > before[k])
        for c in done:
            out[c.request_id] = c
        if eng.pool is not None:
            eng.pool.check()
    wall = time.perf_counter() - t0
    base = min(out)
    return ([out[base + i] for i in range(len(reqs))], wall,
            float(np.median(decode_ms)))


def spec_serve(model, cfg, ecfg, reqs, want, dev, per_round=None,
               profile=False, cross=None):
    """``reqs`` through a speculative DecodeEngine (k = SPEC_TOKENS, draft
    bits DRAFT_BITS) over ``ecfg``'s cache, on the packed ``model``: its
    greedy tokens must equal ``want`` (the spec-off completions), rounds
    must draft, and the draft must run the low-slice matmuls. Returns its
    numbers: ``spec_stats``, tokens/s, wall seconds, median host ms of a
    round where every slot decodes, the kernel launches of one such round
    (checked against ``per_round``, {kernel: launches}, where given),
    ``spec_off_tok_s`` (a spec-off engine over the same cache and
    requests, whose tokens must also equal ``want``; None: they are the
    reference the speculative tokens are held to) and, with ``profile``,
    a device profile of a round. ``cross``: an encoder-decoder's encoder
    output, loaded into each engine first."""
    t0 = time.perf_counter()
    off = engine.DecodeEngine(model, cfg, ecfg, already_serve=True,
                              device=dev)
    off_out, off_wall, _step = timed_serve(off, reqs, cross=cross)
    del off
    want = off_out if want is None else want
    for a, b in zip(want, off_out):
        if not np.array_equal(a.tokens, b.tokens):
            raise AssertionError(f"spec-off rerun != spec-off tokens "
                                 f"(request {a.request_id})")
    eng = engine.DecodeEngine(model, cfg, dataclasses.replace(
        ecfg, spec_tokens=SPEC_TOKENS, spec_draft_bits=DRAFT_BITS),
        already_serve=True, device=dev)
    drafts = backend.draft_matmul_call_count()
    kernels.reset_launch_counts()
    round_counts = {}
    out, wall, round_ms = timed_serve(eng, reqs, round_counts, cross=cross)
    for a, b in zip(want, out):
        if not np.array_equal(a.tokens, b.tokens):
            raise AssertionError(f"spec tokens != spec-off tokens (request "
                                 f"{a.request_id}): {a.new_tokens} vs "
                                 f"{b.new_tokens}")
    st = eng.spec_stats()
    if st["rounds"] == 0 or backend.draft_matmul_call_count() == drafts:
        raise AssertionError(f"no draft ran: {st}")
    for name, n in (per_round or {}).items():
        if round_counts.get(name) != n:
            raise AssertionError(f"{round_counts.get(name)} {name} launches "
                                 f"a round, not {n}")
    new = sum(c.new_tokens.size for c in out)
    res = dict(spec=st, tok_s=new / wall, spec_off_tok_s=new / off_wall,
               wall_s=wall, round_ms=round_ms,
               steps=eng.sched.step_count, launches=kernels.launch_counts(),
               round_launches=round_counts)
    if profile:
        res["profile"] = profile_round(eng)
    res["call_s"] = time.perf_counter() - t0
    return res


def profile_round(eng, rounds=1):
    """Device view of speculative rounds at batch max_batch on a fresh
    cache (torch profiler), as the engine runs them: k greedy draft steps
    with the low-slice forward, each with its argmax read to the host,
    then one verify step of k + 1 lanes and its argmaxes. Kernels, device
    busy ms and the top kernels a round, and the host-clock ms of an
    unprofiled round."""
    from torch.profiler import ProfilerActivity, profile
    b, c = eng.ecfg.max_batch, eng.spec_width
    state = {"cache": fresh_cache(eng), "base": 64,
             "cur": np.arange(1, b + 1, dtype=np.int32)}

    def one_round():
        cache, base, cur = state["cache"], state["base"], state["cur"]
        lanes = [cur]
        for j in range(c - 1):
            lg, cache = lm.decode_step(eng.model, eng.draft_cfg, cache,
                                       lanes[-1], np.full(b, base + j))
            lanes.append(lg.argmax(-1).cpu().numpy().astype(np.int32))
        pos = base + np.tile(np.arange(c), (b, 1))
        lg, cache = lm.verify_step(eng.model, eng.cfg, cache,
                                   np.stack(lanes, 1), pos)
        state["cur"] = lg[:, -1].argmax(-1).cpu().numpy().astype(np.int32)
        state["cache"], state["base"] = cache, base + c

    one_round()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one_round()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(rounds):
            one_round()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")]
    top = sorted(kern, key=lambda e: -e.device_time_total)[:4]
    return {"host_ms_per_round": host_ms,
            "kernels_per_round": sum(e.count for e in kern) / rounds,
            "device_busy_ms_per_round": sum(e.device_time_total
                                            for e in kern) / rounds / 1e3,
            "top": [(e.key[:72], round(e.device_time_total / rounds / 1e3,
                                       3)) for e in top]}


def phase_kv4_serve(qat_cfg, vocab, dev, rng, launches, per_step,
                    spec_runs):
    """Full-width 4-bit KV serving, ring (continuous and lockstep) and
    paged, with identical greedy tokens; then speculative decoding over
    both on a ring of 64 entries that the requests wrap (into
    ``spec_runs``). Returns the per-engine numbers."""
    kw = dict(max_batch=4, cache_len=256, prefill_chunk=8, kv_bits=4)
    reqs = shared_prefix_requests(vocab, rng)
    stats = {}
    params = lm.init_params(qat_cfg, seed=SEED + 3, device=dev)
    kernels.reset_launch_counts()
    ring = engine.DecodeEngine(params, qat_cfg, engine.EngineConfig(**kw))
    del params
    torch.cuda.empty_cache()
    ring_out, wall, step = timed_serve(ring, reqs)
    counts = kernels.launch_counts()
    launches[B4] = counts[B4]
    log(f"[6] ring kv4 launches {counts}")
    if counts[B4] == 0 or counts[B5] != 0 or counts[B1] == 0:
        raise AssertionError(f"kv4 ring path launches {counts}")
    new = sum(c.new_tokens.size for c in ring_out)
    stats["ring"] = dict(tok_s=new / wall, decode_step_ms=step,
                         fresh_cache_step_ms=decode_step_ms(ring),
                         steps=ring.sched.step_count)
    cache = ring.init_cache(4)
    stats["ring"]["kv_payload_bytes"] = kv_quant.cache_payload_bytes(cache)
    del cache
    stats["ring"]["profile"] = profile_decode(ring)
    per_step[B4] = step_launches(ring)[B4]
    log(f"[6] ring DecodeEngine: {new} tokens in {wall:.2f} s; "
        f"{stats['ring']}; {per_step[B4]} {B4} launches a decode step")
    if per_step[B4] != qat_cfg.num_layers:
        raise AssertionError(f"{per_step[B4]} {B4} launches a 4-bit ring "
                             f"decode step, not one a layer")

    lock = engine.LockstepEngine(ring.model, ring.cfg,
                                 engine.EngineConfig(**kw),
                                 already_serve=True, device=dev)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for w in range(0, len(reqs), 4):
        group = reqs[w:w + 4]
        got = lock.generate(np.stack([r.prompt for r in group]),
                            group[0].max_new_tokens)
        for r, row, c in zip(group, got, ring_out[w:w + 4]):
            if not np.array_equal(row, c.tokens):
                raise AssertionError(f"kv4 lockstep != ring continuous "
                                     f"(request {c.request_id})")
    wall = time.perf_counter() - t0
    if kernels.launch_counts()[B4] == 0:
        raise AssertionError("kv4 lockstep ran no B4 launch")
    stats["lockstep"] = dict(tok_s=new / wall,
                             fresh_cache_step_ms=decode_step_ms(lock))
    log(f"[6] LockstepEngine == ring DecodeEngine; {stats['lockstep']}")

    paged = engine.DecodeEngine(ring.model, ring.cfg, engine.EngineConfig(
        kv_layout="paged", page_size=16, **kw), already_serve=True,
        device=dev)
    kernels.reset_launch_counts()
    paged_out, wall, step = timed_serve(paged, reqs)
    counts = kernels.launch_counts()
    launches[B5] = counts[B5]
    log(f"[6] paged kv4 launches {counts}")
    if counts[B5] == 0 or counts[B4] != 0:
        raise AssertionError(f"kv4 paged path launches {counts}")
    for a, b in zip(ring_out, paged_out):
        if not np.array_equal(a.tokens, b.tokens):
            raise AssertionError(f"kv4 paged != ring (request "
                                 f"{a.request_id})")
    pool_stats = paged.paged_kv_stats()
    if pool_stats["prefix_hits"] == 0 or pool_stats["cow_copies"] == 0:
        raise AssertionError(f"prefix map / copy-on-write idle: "
                             f"{pool_stats}")
    paged.pool.check()
    stats["paged"] = dict(tok_s=new / wall, decode_step_ms=step,
                          steps=paged.sched.step_count, pool=pool_stats,
                          fresh_cache_step_ms=decode_step_ms(paged),
                          profile=profile_decode(paged))
    per_step[B5] = step_launches(paged)[B5]
    if per_step[B5] != qat_cfg.num_layers:
        raise AssertionError(f"{per_step[B5]} {B5} launches a paged "
                             f"decode step, not one a layer")
    log(f"[6] paged DecodeEngine == ring: {new} tokens in {wall:.2f} s; "
        f"{stats['paged']}")
    for c in ring_out[:2] + ring_out[4:6]:
        log(f"[6] request {c.request_id}: {c.new_tokens[:8].tolist()}")
    # Speculative decoding over the 4-bit ring and pool: a 64-entry ring
    # that 16-64-token prompts and 16 new tokens wrap, so rounds near the
    # end may not draft (the ring-wrap guard) and the pool rolls back
    # rejected pages.
    kw64 = dict(kw, cache_len=64)
    sreqs = requests(vocab, rng, n=4, lo=16, hi=64, new=16)
    base = engine.DecodeEngine(ring.model, ring.cfg,
                               engine.EngineConfig(**kw64),
                               already_serve=True, device=dev)
    base_out, _wall, _step = timed_serve(base, sreqs)
    del base
    for tag, layout, kern in (("h2o_kv4_ring", "ring", B4),
                              ("h2o_kv4_paged", "paged", B5)):
        spec_runs[tag] = spec_serve(ring.model, ring.cfg, engine.EngineConfig(
            kv_layout=layout, page_size=16, **kw64), sreqs, base_out, dev)
        if spec_runs[tag]["launches"][kern] == 0:
            raise AssertionError(f"spec {tag} ran no {kern}")
        log(f"[6] spec {tag} (cache_len 64) tokens == spec-off: "
            f"{spec_runs[tag]}")
    return stats


# ------------------------------------------------------ training kernels ----
TIE_SCALE = 0.0625           # a power of two: x / s is exact


def _mixed_pbits(k, gen, dev):
    return torch.tensor([1.0, 2.0, 4.0], device=dev)[torch.randint(
        0, 3, (k // 16,), generator=gen, device=dev)]


def _tie_values(p, gen):
    """Per-channel scaled values on a rounding tie of precision p (below
    the grid top, so the group's abs-max is not moved)."""
    top = torch.exp2(p) - 1.0
    j = torch.floor(torch.rand(p.shape, generator=gen, device=p.device)
                    * torch.clamp(top, min=1.0))
    return (2.0 * (j + 0.5) - top) * torch.exp2(1.0 - p)


def b8_weight_operands(k, n, gen, dev):
    """A [K, N] weight with per-group precisions; every group's abs-max is
    1.875 * TIE_SCALE, so its scale is exactly TIE_SCALE and its second
    row sits on rounding ties."""
    pb = _mixed_pbits(k, gen, dev)
    w = torch.clamp(torch.randn((k, n), generator=gen, device=dev) * 0.02,
                    -0.1, 0.1)
    rows = torch.arange(0, k, 16, device=dev)
    w[rows, 0] = 1.875 * TIE_SCALE
    p_ties = pb[:, None].expand(-1, n)
    w[rows + 1] = _tie_values(p_ties, gen) * TIE_SCALE
    return w, pb, quant.per_group_weight_scale(w, 16)


def b8_act_operands(m, k, gen, dev, per_row=True):
    """bf16 activations [M, K] with a row of rounding ties and a row
    beyond the 1- and 2-bit grids. ``per_row``: each row's abs-max / 1.875
    scale (the divisions the kernel must take exactly: every row's
    abs-max element lands on the grid's top), but the tie row's, a power
    of two (x / s is exact there); else one per-tensor scale, a power of
    two."""
    pb = _mixed_pbits(k, gen, dev)
    x = torch.clamp(torch.randn((m, k), generator=gen, device=dev), -7, 7)
    x[0, 0] = 1.875 * 4.0
    x[1] = _tie_values(quant.expand_groups(pb, k, 16), gen) * 4.0
    x[2] = 1.8 * 4.0
    x = x.to(torch.bfloat16)
    if not per_row:
        return x, pb, quant.abs_max_scale(x).reshape(1).expand(m).contiguous()
    sx = quant.abs_max_scale(x, dim=1).reshape(m)
    sx[1] = 4.0
    return x, pb, sx.contiguous()


def alone_ms(calls, dev, reps=10):
    """Device ms (the host queued ahead) of the kernels alone: the C
    entries of ``calls`` ((entry, *args) without the stream) launched
    directly on operands and outputs that the caller made before the
    timed calls and holds. Not counted as launches."""
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run():
        for fn, *args in calls:
            _build.check(fn(*args, stream), "kernel alone")
    return device_ms(run, reps)


def b9_alone_ms(b9_ops, dev):
    """B9's kernel alone on ``b9_ops`` ((w, s, seed), fp32 [K, N]): the
    per-group sigmoid and the seed tensor, which the wrapper launches
    ahead of the kernel in each call, are made outside the timed calls."""
    lib = _build.library(ni.SOURCE, ni._bind)
    keep, calls = [], []
    for w, s, seed in b9_ops:
        sig = ni.group_sigma(s).contiguous()
        sd = ni.seed_tensor(seed, dev)
        out = torch.empty_like(w)
        keep.append((sig, sd, out))
        calls.append((lib.soniq_noise_inject, w.data_ptr(), sig.data_ptr(),
                      sd.data_ptr(), out.data_ptr(), 1, *w.shape, 16))
    return alone_ms(calls, dev)


def b8_alone_ms(b8_w, b8_x, dev):
    """B8's kernel alone on one layer's weights ([K, N] fp32, per-group
    scales) and activations ([M, K] bf16, per-row scales), outputs made
    outside the timed calls. The layer's operands exceed the 50 MB L2, so
    each call finds its own cold."""
    lib = _build.library(fq.SOURCE, fq._bind)
    keep, calls = [], []
    for ops, k_rows, dtype in ((b8_w, 1, 0), (b8_x, 0, 1)):
        for x, pb, sc in ops:
            out = torch.empty_like(x)
            keep.append(out)
            calls.append((lib.soniq_fake_quant, x.data_ptr(), pb.data_ptr(),
                          sc.data_ptr(), out.data_ptr(), 1, *x.shape, 16,
                          k_rows, 1 - k_rows, dtype))
    return alone_ms(calls, dev)


def phase_training_kernels(cfg, gen, dev, reps=10, shapes=None):
    """B9 and B8 against their plain versions (bitwise) on one layer's
    operands; times one layer's calls (B9: its weights; B8: its weights
    and their activations, at 8 x 128 tokens unless ``shapes`` gives each
    linear's rows: (name, K, N, M)) with CUDA events around a loop of
    calls (``ms``, as every kernel here is timed, which includes the
    host's launch gaps between these short kernels) and with the host
    queued ahead (``device_ms``, the kernels alone)."""
    if shapes is None:
        shapes = [(name, k, n, TRAIN_BATCH * TRAIN_SEQ)
                  for name, k, n in layer_linears(cfg)]
    b9_ops, b8_w, b8_x = [], [], []
    for _name, k, n, m in shapes:
        w = torch.rand((k, n), generator=gen, device=dev) * 2.2 - 1.1
        w[0, :4] = torch.tensor([2.5, -2.5, 1.999, -1.0], device=dev)
        s = torch.randn((k // 16,), generator=gen, device=dev) * 2.0 - 0.5
        s[:2] = torch.tensor([8.0, -8.0], device=dev)
        seed = torch.randint(0, 1 << 32, (1,), generator=gen, device=dev)
        b9_ops.append((w, s, seed))
        b8_w.append(b8_weight_operands(k, n, gen, dev))
        b8_x.append(b8_act_operands(m, k, gen, dev))
    for w, s, seed in b9_ops:
        got = ni.noise_inject(w, s, seed)
        want = ni.noise_inject_plain(w, ni.group_sigma(s), seed)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"noise_inject {tuple(w.shape)}: "
                                 f"{(got != want).sum().item()} elements "
                                 f"differ from the plain version")
    for (w, pb, sw), (x, pbx, sx) in zip(b8_w, b8_x):
        for args, kw in (((w, pb, sw), dict(row_scale=False, k_dim=0)),
                         ((x, pbx, sx), dict(row_scale=True))):
            got = fq.fake_quant(*args, **kw)
            want = fq.fake_quant_plain(*args, **kw)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(
                    f"fake_quant {tuple(args[0].shape)} {args[0].dtype}: "
                    f"{(got != want).sum().item()} elements differ")
    out = {}
    b9 = lambda: [ni.noise_inject(*o) for o in b9_ops]  # noqa: E731
    b9p = lambda: [ni.noise_inject_plain(w, ni.group_sigma(s), sd)  # noqa
                   for w, s, sd in b9_ops]
    elems = sum(w.numel() for w, _s, _sd in b9_ops)
    # Bytes: each weight read and written once in fp32. Operations: ~16 a
    # element (the hash, eps, the product, sum and clip), integer ones
    # counted at the fp32 rate.
    b_ms, b_by = bound(8 * elems + sum(4 * s.numel() + 8
                                       for _w, s, _sd in b9_ops),
                       16 * elems)
    out[B9] = dict(max_abs_err=0.0, ms=time_ms(b9, reps),
                   device_ms=device_ms(b9),
                   alone_device_ms=b9_alone_ms(b9_ops, dev),
                   plain_ms=time_ms(b9p, 2), bound_ms=b_ms, bound_by=b_by,
                   library_ms=None)
    b8 = lambda: ([fq.fake_quant(w, pb, sw, row_scale=False, k_dim=0)  # noqa
                   for w, pb, sw in b8_w]
                  + [fq.fake_quant(x, pb, sx, row_scale=True)
                     for x, pb, sx in b8_x])
    b8p = lambda: ([fq.fake_quant_plain(w, pb, sw, row_scale=False,  # noqa
                                        k_dim=0) for w, pb, sw in b8_w]
                   + [fq.fake_quant_plain(x, pb, sx, row_scale=True)
                      for x, pb, sx in b8_x])
    nbytes = sum(8 * w.numel() + 8 * pb.numel() for w, pb, _sw in b8_w) \
        + sum(4 * x.numel() + 4 * (pb.numel() + sx.numel())
              for x, pb, sx in b8_x)
    nel = sum(w.numel() for w, _p, _s in b8_w) + \
        sum(x.numel() for x, _p, _s in b8_x)
    b_ms, b_by = bound(nbytes, 12 * nel)
    weights_only = lambda: [fq.fake_quant(  # noqa: E731
        w, pb, sw, row_scale=False, k_dim=0) for w, pb, sw in b8_w]
    copies = lambda: [t.clone() for t, _p, _s in b8_w + b8_x]  # noqa
    out[B8] = dict(max_abs_err=0.0, ms=time_ms(b8, reps),
                   device_ms=device_ms(b8),
                   alone_device_ms=b8_alone_ms(b8_w, b8_x, dev),
                   copy_device_ms=device_ms(copies),
                   plain_ms=time_ms(b8p, 2), bound_ms=b_ms, bound_by=b_by,
                   library_ms=None, weights_ms=time_ms(weights_only, reps))
    out.update(training_backward_kernels(b9_ops, b8_w, b8_x, gen, dev, reps))
    return out


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def training_backward_kernels(b9_ops, b8_w, b8_x, gen, dev, reps):
    """B9's and B8's backward kernels against their plain versions on one
    layer's operands and a random cotangent: dw and dx bitwise (-0
    included), ds within ``noise_inject.ds_bound``; one layer's backward
    calls timed on both rulers."""
    b9 = [(w, s, seed, torch.randn(w.shape, generator=gen, device=dev))
          for w, s, seed in b9_ops]
    ds_err = 0.0
    for w, s, seed, g in b9:
        dw, ds = ni.noise_inject_bwd(w, s, seed, g)
        dw_p, ds_p = ni.noise_inject_bwd_plain(w, s, seed, g)
        torch.cuda.synchronize()
        if not torch.equal(_bits(dw), _bits(dw_p)):
            raise AssertionError(f"noise_inject_bwd {tuple(w.shape)}: dw "
                                 f"differs from the plain version in "
                                 f"{(_bits(dw) != _bits(dw_p)).sum().item()}"
                                 f" elements")
        err = (ds - ds_p).abs()
        if not (err <= ni.ds_bound(w, s, seed, g)).all():
            raise AssertionError(f"noise_inject_bwd {tuple(w.shape)}: ds "
                                 f"off the plain version by {err.max()}")
        ds_err = max(ds_err, err.max().item())
    b8 = [((w, pb, sw, torch.randn(w.shape, generator=gen, device=dev)),
           dict(row_scale=False, k_dim=0)) for w, pb, sw in b8_w]
    b8 += [((x, pb, sx, torch.randn(x.shape, generator=gen, device=dev).to(
        x.dtype)), dict(row_scale=True)) for x, pb, sx in b8_x]
    for args, kw in b8:
        got = fq.fake_quant_bwd(*args, **kw)
        want = fq.fake_quant_bwd_plain(*args, **kw)
        torch.cuda.synchronize()
        if not torch.equal(_bits(got), _bits(want)):
            raise AssertionError(
                f"fake_quant_bwd {tuple(args[0].shape)} {args[0].dtype}: "
                f"{(_bits(got) != _bits(want)).sum().item()} elements "
                f"differ from the plain version")
    out = {}
    kern = lambda: [ni.noise_inject_bwd(*o) for o in b9]  # noqa: E731
    plain = lambda: [ni.noise_inject_bwd_plain(*o) for o in b9]  # noqa
    elems = sum(w.numel() for w, _s, _sd, _g in b9)
    # Bytes: w and g read, dw written, fp32; s read and ds written per
    # group. Operations: ~20 an element (the hash, eps, z, the mask, the
    # select, the product and its sum), integer ones at the fp32 rate.
    b_ms, b_by = bound(12 * elems + sum(8 * s.numel() + 8
                                        for _w, s, _sd, _g in b9),
                       20 * elems)
    out[B9_BWD] = dict(max_abs_err=ds_err, ms=time_ms(kern, reps),
                       device_ms=device_ms(kern), plain_ms=time_ms(plain, 2),
                       bound_ms=b_ms, bound_by=b_by, library_ms=None)
    kern = lambda: [fq.fake_quant_bwd(*a, **kw) for a, kw in b8]  # noqa
    plain = lambda: [fq.fake_quant_bwd_plain(*a, **kw)  # noqa: E731
                     for a, kw in b8]
    # Bytes: x and g read, dx written, in x's dtype; pbits and the scale
    # once. Operations: ~6 an element (the division, the bound, the
    # compare, the product).
    nbytes = sum(3 * a[0].numel() * a[0].element_size()
                 + 4 * (a[1].numel() + a[2].numel()) for a, _kw in b8)
    b_ms, b_by = bound(nbytes, 6 * sum(a[0].numel() for a, _kw in b8))
    out[B8_BWD] = dict(max_abs_err=0.0, ms=time_ms(kern, reps),
                       device_ms=device_ms(kern), plain_ms=time_ms(plain, 2),
                       bound_ms=b_ms, bound_by=b_by, library_ms=None)
    return out


# ------------------------------------------------------------- training ----
def train_step_launches(cfg, phase):
    """B8/B9 launches a step of one microbatch, unhoisted: every block is
    recomputed in the backward, so each quantized linear runs its forward
    twice: Phase I one B9 a forward and one B9 backward; Phase II two B8
    (weight and activation) a forward and two B8 backward. An
    encoder-decoder counts its encoder's linears and the decoder's cross
    attention (the frontend is an fp skip linear); a hybrid its blocks'
    linears and expert banks (``quantized_leaves``: a bank is one launch
    each way)."""
    n = len(layer_linears(cfg)) * cfg.num_layers
    if cfg.family == "hybrid":
        n = quantized_leaves(cfg)
    if cfg.encoder_layers:
        n = (WHISPER_ENC_LINEARS * cfg.encoder_layers
             + WHISPER_DEC_LINEARS * cfg.num_layers)
    if phase == 1:
        return {"b9": 2 * n, "b9_bwd": n, "b8": 0, "b8_bwd": 0}
    return {"b8": 4 * n, "b8_bwd": 2 * n, "b9": 0, "b9_bwd": 0}


def phase_training(cfg, dev, tag=8, spans=step_profile.SPANS,
                   summary=step_profile.device_summary, profiled=True,
                   t1=T1, t2=T2, mixed_seed=None):
    """Full-width two-phase training through ``train.loop.train`` (``t1``
    Phase-I steps of ``t2``), every step's B8/B9 launches checked
    (``train_step_launches``) and its peak memory kept; with ``profiled``,
    a device profile (``summary`` under ``spans``; ``spans=None``: the
    device alone, cheap to read, for ``step_profile.device_busy``) of the
    last step of each phase; with ``mixed_seed``, the logits drawn over the 4/2/1-bit
    bands first (``set_mixed_logits``). An encoder-decoder's batches
    carry mel frames (``with_frames``). Returns (the trained state,
    per-step records, profiles, pattern report)."""
    from torch.profiler import ProfilerActivity, profile
    from torch.profiler import schedule as prof_schedule
    from repro_torch.train import state as state_lib
    tcfg = state_lib.TrainConfig(t1=t1, t2=t2, warmup=1, seed=SEED)
    stream = synthetic.TokenStream(synthetic.TokenStreamConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
        batch_size=TRAIN_BATCH, seed=0))
    batches = stream.batches()
    if cfg.encoder_layers:
        batches = with_frames(batches, cfg)
    records, profiles = [], {}
    counted = {"b8": B8, "b9": B9, "b8_bwd": B8_BWD, "b9_bwd": B9_BWD}
    prev = dict.fromkeys(counted.values(), 0)

    def on_ready(prof):
        profiles[records[-1]["step"]] = summary(prof)

    def hook(step, _state, met):
        counts = kernels.launch_counts()
        rec = dict(step=step, phase=met["phase"], loss=met["loss"],
                   grad_norm=met["grad_norm"], ms=met["wall"] * 1e3,
                   peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        rec.update({key: counts[name] - prev[name]
                    for key, name in counted.items()})
        prev.update({name: counts[name] for name in counted.values()})
        records.append(rec)
        torch.cuda.reset_peak_memory_stats()
        log(f"[{tag}] step {step} phase {rec['phase']}: loss "
            f"{rec['loss']:.4f} gnorm {rec['grad_norm']:.4f} "
            f"{rec['ms']:.1f} ms, launches B8 {rec['b8']} B9 {rec['b9']} "
            f"B8 backward {rec['b8_bwd']} B9 backward {rec['b9_bwd']}, "
            f"peak {rec['peak_gib']:.2f} GiB")
        if prof is not None:
            prof.step()

    model = lm.init_params(cfg.with_quant_mode("noise"), seed=SEED,
                           device=dev)
    if mixed_seed is not None:
        set_mixed_logits(model, mixed_seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    prof = None
    if profiled:
        acts = [ProfilerActivity.CUDA]
        undo_spans = lambda: None  # noqa: E731
        if spans is not None:
            acts.insert(0, ProfilerActivity.CPU)
            undo_spans = step_profile.install_spans(spans)
        try:
            with profile(activities=acts,
                         schedule=prof_schedule(wait=t1 - 1, warmup=0,
                                                active=1, repeat=2),
                         on_trace_ready=on_ready) as prof:
                out = loop.train(cfg, tcfg, batches, model=model,
                                 device=dev, hooks=[hook])
        finally:
            undo_spans()
    else:
        out = loop.train(cfg, tcfg, batches, model=model, device=dev,
                         hooks=[hook])
    wall = time.perf_counter() - t0
    for r in records:
        if not math.isfinite(r["loss"]):
            raise AssertionError(f"non-finite loss at step {r['step']}")
        want = train_step_launches(cfg, r["phase"])
        if any(r[k] != n for k, n in want.items()):
            raise AssertionError(f"step {r['step']} (phase {r['phase']}) "
                                 f"launches { {k: r[k] for k in counted} }, "
                                 f"wanted {want}")
    rep = out["pattern_report"]
    log(f"[{tag}] boundary: average bpp {schedule.average_bpp(rep):.4f} "
        f"over {len(rep['layers'])} linears; allowed patterns "
        f"{rep['allowed']}")
    log(f"[{tag}] {t2} steps in {wall:.2f} s; profiles {profiles}")
    return out["state"], records, profiles, rep


def phase_serve_trained(state, cfg, dev, rng):
    """Pack the trained QAT model (B7) and serve 4 requests through both
    engines; greedy tokens must be equal."""
    qat_cfg = cfg.with_quant_mode("qat")
    ecfg = engine.EngineConfig(max_batch=4, cache_len=256, prefill_chunk=8)
    kernels.reset_launch_counts()
    eng = engine.DecodeEngine(state["model"], qat_cfg, ecfg, device=dev)
    prompts = rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
    a = eng.generate(prompts, 8)
    counts = kernels.launch_counts()
    if counts[B7] == 0 or counts[B1] == 0:
        raise AssertionError(f"trained-model serve launches {counts}")
    lock = engine.LockstepEngine(eng.model, eng.cfg, ecfg,
                                 already_serve=True, device=dev)
    b = lock.generate(prompts, 8)
    if not np.array_equal(a, b):
        raise AssertionError(f"trained model: lockstep != continuous\n{a}"
                             f"\n{b}")
    log(f"[9] trained model packed ({engine.packed_model_bytes(eng.model):,}"
        f" bytes) and served; lockstep == continuous; tokens "
        f"{a[:, 16:].tolist()}; launches {counts}")


def _train_linear(leaf, x, g, qcfg, draw, dev):
    """One linear's forward and backward on ``dev``: (y, dx, dw, ds)."""
    lin = smol.SmolLinear({k: v.to(dev) for k, v in leaf.items()})
    lin.requires_grad_(True)
    xt = x.to(dev).requires_grad_(True)
    d = None if draw is None else smol.NoiseDraw(
        seed=draw.seed.to(dev), act_eps=draw.act_eps.to(dev))
    y = smol.linear_apply(lin.leaf(), xt, qcfg, d)
    (y * g.to(dev)).sum().backward()
    ds = lin.s.grad if "s" in leaf else None
    return y.detach(), xt.grad, lin.w.grad, ds


def check_training_against_cpu(cfg, dev, qat_pbits=None,
                               modes=("noise", "qat")):
    """Teacher-forced card vs CPU for every NOISE and QAT linear of one
    full-width layer (fp32, 2 x 64 tokens, the same weights, input,
    cotangent and noise draws on both): y, dx, dw, ds within relative L2
    1e-5. QAT precisions are drawn from {1, 2, 4} per group, or are
    ``qat_pbits`` (linear name -> a trained layer's frozen pbits)."""
    gen = torch.Generator().manual_seed(SEED + 7)
    worst = {}
    for mode in modes:
        qcfg = QuantConfig(mode=mode)
        for name, k, n in layer_linears(cfg):
            leaf = {"w": torch.randn((k, n), generator=gen) / math.sqrt(k)}
            if mode == "noise":
                leaf["s"] = torch.randn((k // 16,), generator=gen) * 1.5 - 0.5
            elif qat_pbits is not None:
                leaf["pbits"] = qat_pbits[name]
            else:
                leaf["pbits"] = torch.tensor([1, 2, 4], dtype=torch.int8)[
                    torch.randint(0, 3, (k // 16,), generator=gen)]
            x = torch.randn((2, 64, k), generator=gen)
            g = torch.randn((2, 64, n), generator=gen)
            draw = None
            if mode == "noise":
                draw = smol.NoiseDraw(
                    seed=torch.randint(0, 1 << 32, (1,), generator=gen),
                    act_eps=torch.rand(x.shape, generator=gen) * 2 - 1)
            card = _train_linear(leaf, x, g, qcfg, draw, dev)
            host = _train_linear(leaf, x, g, qcfg, draw, "cpu")
            for what, a, b in zip(("y", "dx", "dw", "ds"), card, host):
                if b is None:
                    continue
                err = rel_l2(a, b)
                key = f"{mode}.{what}"
                worst[key] = max(worst.get(key, 0.0), err)
                if not err <= 1e-5:
                    raise AssertionError(f"{mode} {name} {what}: relative "
                                         f"L2 {err:.3e} card vs CPU")
    return worst


# ------------------------------------------------- training kernels, banks ----
def moe_banks(cfg):
    """(name, K, N) of one MoE layer's expert banks."""
    d, f = cfg.d_model, cfg.d_ff
    return [("up", d, f), ("gate", d, f), ("down", f, d)]


def moe_capacity(cfg, tokens=TRAIN_BATCH * TRAIN_SEQ):
    """The training dispatch buffer's rows an expert (``moe_apply``)."""
    return max(1, math.ceil(tokens * cfg.top_k / cfg.num_experts * 1.25))


def b9_bank_operands(e, k, n, gen, dev):
    """A bank w [E, K, N] with weights beyond the clip, logits [E, K / 16]
    at both ends, a seed an expert."""
    w = torch.rand((e, k, n), generator=gen, device=dev) * 2.2 - 1.1
    w[:, 0, :4] = torch.tensor([2.5, -2.5, 1.999, -1.0], device=dev)
    s = torch.randn((e, k // 16), generator=gen, device=dev) * 2.0 - 0.5
    s[:, :2] = torch.tensor([8.0, -8.0], device=dev)
    seeds = torch.randint(0, 1 << 32, (e,), generator=gen, device=dev)
    return w, s, seeds


def b8_bank_operands(e, k, n, c, gen, dev):
    """B8's weight and activation operands of one bank: every expert its
    own mixed precisions, weight scales (ties as ``b8_weight_operands``)
    and per-tensor activation scale (``b8_act_operands``)."""
    ws = [b8_weight_operands(k, n, gen, dev) for _ in range(e)]
    xs = [b8_act_operands(c, k, gen, dev, per_row=False) for _ in range(e)]
    weight = tuple(torch.stack(t) for t in zip(*ws))
    act = (torch.stack([x for x, _p, _s in xs]),
           torch.stack([p for _x, p, _s in xs]),
           torch.stack([s for _x, _p, s in xs]))
    return weight, act


def _per_expert(fn, bank_args, e):
    """``fn`` launched on each expert's slices (E single launches)."""
    return [fn(*[a[i].contiguous() if torch.is_tensor(a) and a.dim()
                 else a for a in bank_args]) for i in range(e)]


def _check_equal(what, got, want):
    if not torch.equal(_bits(got), _bits(want)):
        raise AssertionError(f"{what}: {(_bits(got) != _bits(want)).sum()}"
                             f" elements differ")


def check_bank_b9(w, s, seeds, g, tag, plain=True):
    """B9 and its backward over a bank, one launch each: bitwise its plain
    version (ds within ``ds_bound``) and E single-weight launches. Returns
    the largest |ds - plain ds|."""
    e = w.shape[0]
    out = ni.noise_inject(w, s, seeds)
    dw, ds = ni.noise_inject_bwd(w, s, seeds, g)
    one = _per_expert(lambda *a: (ni.noise_inject(*a[:3]),
                                  ni.noise_inject_bwd(*a)),
                      (w, s, seeds[:, None], g), e)
    for i, (oi, (dwi, dsi)) in enumerate(one):
        _check_equal(f"{tag} B9 expert {i} vs its launch", out[i], oi)
        _check_equal(f"{tag} B9 backward dw expert {i}", dw[i], dwi)
        _check_equal(f"{tag} B9 backward ds expert {i}", ds[i], dsi)
    del one
    err = 0.0
    if plain:
        sig = ni.group_sigma(s)
        _check_equal(f"{tag} B9 vs plain", out,
                     ni.noise_inject_plain(w, sig, seeds))
        dw_p, ds_p = ni.noise_inject_bwd_plain(w, s, seeds, g)
        _check_equal(f"{tag} B9 backward dw vs plain", dw, dw_p)
        e_ds = (ds - ds_p).abs()
        if not (e_ds <= ni.ds_bound(w, s, seeds, g)).all():
            raise AssertionError(f"{tag} B9 backward ds off the plain "
                                 f"version by {e_ds.max()}")
        err = e_ds.max().item()
    else:
        for i in range(e):
            dw_p, ds_p = ni.noise_inject_bwd_plain(w[i], s[i], seeds[i], g[i])
            _check_equal(f"{tag} B9 expert {i} vs plain", out[i],
                         ni.noise_inject_plain(w[i], ni.group_sigma(s[i]),
                                               seeds[i]))
            _check_equal(f"{tag} B9 backward dw expert {i} vs plain", dw[i],
                         dw_p)
            e_ds = (ds[i] - ds_p).abs()
            if not (e_ds <= ni.ds_bound(w[i], s[i], seeds[i], g[i])).all():
                raise AssertionError(f"{tag} B9 backward ds expert {i}: "
                                     f"{e_ds.max()}")
            err = max(err, e_ds.max().item())
    torch.cuda.synchronize()
    return err


def check_bank_b8(x, pb, sc, g, kw, tag):
    """B8 and its backward over a bank, one launch each: bitwise their
    plain versions and E launches on the slices."""
    e = x.shape[0]
    y = fq.fake_quant(x, pb, sc, **kw)
    dx = fq.fake_quant_bwd(x, pb, sc, g, **kw)
    _check_equal(f"{tag} B8 vs plain", y, fq.fake_quant_plain(x, pb, sc,
                                                              **kw))
    _check_equal(f"{tag} B8 backward vs plain", dx,
                 fq.fake_quant_bwd_plain(x, pb, sc, g, **kw))
    rows = sc.reshape(e, -1)
    for i in range(e):
        a = (x[i].contiguous(), pb[i].contiguous(), rows[i].contiguous())
        _check_equal(f"{tag} B8 expert {i}", y[i], fq.fake_quant(*a, **kw))
        _check_equal(f"{tag} B8 backward expert {i}", dx[i],
                     fq.fake_quant_bwd(*a, g[i].contiguous(), **kw))
    torch.cuda.synchronize()


def phase_bank_kernels(moe_cfg, big_cfg, gen, dev, reps=5):
    """The bank forms on one full-width deepseek-moe-16b MoE layer's three
    banks (E = 64; the activations of the training dispatch buffer, C =
    120 rows an expert at 8 x 128 tokens): B9 and B8 (weight and
    activation layouts) with their backward kernels, every expert its own
    seed, logits, mixed precisions and scales, each one launch a bank,
    bitwise the plain versions (ds within ``ds_bound``) and E single
    launches; and one mixtral-8x22b bank (down, [8, 16384, 6144]: 3.2 GB,
    byte offsets past 2^31) the same way, against per-expert plain
    versions. Times the layer's bank launches on both rulers beside the
    plain versions and the 192 single launches."""
    e, c = moe_cfg.num_experts, moe_capacity(moe_cfg)
    b9, b8w, b8x = [], [], []
    ds_err = 0.0
    for name, k, n in moe_banks(moe_cfg):
        w, s, seeds = b9_bank_operands(e, k, n, gen, dev)
        g = torch.randn(w.shape, generator=gen, device=dev)
        ds_err = max(ds_err, check_bank_b9(w, s, seeds, g, name))
        b9.append((w, s, seeds, g))
        weight, act = b8_bank_operands(e, k, n, c, gen, dev)
        gw = torch.randn(weight[0].shape, generator=gen, device=dev)
        gx = torch.randn(act[0].shape, generator=gen, device=dev).to(
            act[0].dtype)
        check_bank_b8(*weight, gw, dict(row_scale=False, k_dim=0), name)
        check_bank_b8(*act, gx, dict(row_scale=True), name)
        b8w.append(weight + (gw,))
        b8x.append(act + (gx,))
    # mixtral-8x22b's down bank: the last expert starts 2.8 GB in.
    name, k, n = moe_banks(big_cfg)[2]
    e_big = big_cfg.num_experts
    w, s, seeds = b9_bank_operands(e_big, k, n, gen, dev)
    g = torch.randn(w.shape, generator=gen, device=dev)
    big_err = check_bank_b9(w, s, seeds, g, f"mixtral {name}", plain=False)
    del w, s, g
    torch.cuda.empty_cache()
    weight, _act = b8_bank_operands(e_big, k, n, 4, gen, dev)
    gw = torch.randn(weight[0].shape, generator=gen, device=dev)
    check_bank_b8(*weight, gw, dict(row_scale=False, k_dim=0),
                  f"mixtral {name}")
    del weight, gw, _act
    torch.cuda.empty_cache()
    log(f"[7] bank forms bitwise the plain versions and {e} single "
        f"launches a bank on one {MOE_ARCH} MoE layer (max |ds - plain| "
        f"{ds_err:.3e}) and on a {e_big}-expert mixtral-8x22b bank [{e_big},"
        f" {k}, {n}] (max {big_err:.3e})")
    w_el = sum(w.numel() for w, _s, _sd, _g in b9)
    x_el = sum(x.numel() for x, *_ in b8x)
    groups = sum(s.numel() for _w, s, _sd, _g in b9)
    out = {}

    def rec(key, kern, plain, single, nbytes, flops, err=0.0):
        b_ms, b_by = bound(nbytes, flops)
        out[key] = dict(bank_ms=time_ms(kern, reps),
                        bank_device_ms=device_ms(kern, reps),
                        bank_plain_ms=time_ms(plain, 1),
                        bank_single_launches_ms=time_ms(single, 2),
                        bank_bound_ms=b_ms, bank_bound_by=b_by,
                        bank_max_abs_err=err)
        torch.cuda.empty_cache()

    # Bytes and operations as phase 7 counts them for the 2-D forms.
    rec(B9, lambda: [ni.noise_inject(w, s, sd) for w, s, sd, _g in b9],
        lambda: [ni.noise_inject_plain(w, ni.group_sigma(s), sd)
                 for w, s, sd, _g in b9],
        lambda: [_per_expert(ni.noise_inject, (w, s, sd[:, None]), e)
                 for w, s, sd, _g in b9],
        8 * w_el + 4 * groups + 8 * e * 3, 16 * w_el)
    rec(B9_BWD, lambda: [ni.noise_inject_bwd(*o) for o in b9],
        lambda: [ni.noise_inject_bwd_plain(*o) for o in b9],
        lambda: [_per_expert(ni.noise_inject_bwd, (w, s, sd[:, None], g), e)
                 for w, s, sd, g in b9],
        12 * w_el + 8 * groups + 8 * e * 3, 20 * w_el, ds_err)
    wk = dict(row_scale=False, k_dim=0)
    xk = dict(row_scale=True)
    b8_calls = [(a[:3], wk) for a in b8w] + [(a[:3], xk) for a in b8x]
    b8_bwd_calls = [(a, wk) for a in b8w] + [(a, xk) for a in b8x]
    nbytes = 8 * w_el + 2 * 2 * x_el + 4 * 4 * groups
    rec(B8, lambda: [fq.fake_quant(*a, **kw) for a, kw in b8_calls],
        lambda: [fq.fake_quant_plain(*a, **kw) for a, kw in b8_calls],
        lambda: [_per_expert(lambda *t, kw=kw: fq.fake_quant(*t, **kw),
                             (a[0], a[1], a[2].reshape(e, -1)), e)
                 for a, kw in b8_calls],
        nbytes, 12 * (w_el + x_el))
    rec(B8_BWD, lambda: [fq.fake_quant_bwd(*a, **kw)
                         for a, kw in b8_bwd_calls],
        lambda: [fq.fake_quant_bwd_plain(*a, **kw)
                 for a, kw in b8_bwd_calls],
        lambda: [_per_expert(lambda *t, kw=kw: fq.fake_quant_bwd(*t, **kw),
                             (a[0], a[1], a[2].reshape(e, -1), a[3]), e)
                 for a, kw in b8_bwd_calls],
        12 * w_el + 3 * 2 * x_el + 4 * 4 * groups, 6 * (w_el + x_el))
    log(f"[7] one {MOE_ARCH} MoE layer's bank launches (B9, B9 backward: 3;"
        f" B8, B8 backward: 3 weights + 3 activations [64, {c}, K] bf16): "
        f"{out}")
    return out


# --------------------------------------------------------- MoE training ----
MOE_TRAIN_LAYERS = 2         # the dense layer and one MoE layer


def _quantized_linears(model) -> int:
    """Linears and expert banks with quantized leaves (one B9 or B8 call
    each a forward)."""
    return sum(1 for _n, lin in smol.smol_linears(model)
               if "s" in lin._names or "pbits" in lin._names)


def _moe_train(cfg, dev, hook=None, prof=None):
    from repro_torch.train import state as state_lib
    tcfg = state_lib.TrainConfig(t1=T1, t2=T2, warmup=1, seed=SEED)
    stream = synthetic.TokenStream(synthetic.TokenStreamConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
        batch_size=TRAIN_BATCH, seed=0))
    model = lm.init_params(cfg.with_quant_mode("noise"), seed=SEED,
                           device=dev)
    n_lin = _quantized_linears(model)
    return loop.train(cfg, tcfg, stream.batches(), model=model, device=dev,
                      hooks=[hook] if hook else None), n_lin


def phase_moe_training(dev, rng):
    """Full-width deepseek-moe-16b cut to MOE_TRAIN_LAYERS layers through
    3 Phase-I and 3 Phase-II steps (``train.loop.train``), profiled; the
    launches of every step (one B9 / B8 call a linear or bank, each block
    recomputed once); a second run bitwise the first; the trained model
    packed (B7) and served (B6, B1), lockstep equal to continuous."""
    from torch.profiler import ProfilerActivity, profile
    from torch.profiler import schedule as prof_schedule
    cfg = dataclasses.replace(get_config(MOE_ARCH),
                              num_layers=MOE_TRAIN_LAYERS)
    records, profiles = [], {}
    counted = {"b8": B8, "b9": B9, "b8_bwd": B8_BWD, "b9_bwd": B9_BWD}
    prev = dict.fromkeys(counted.values(), 0)

    def on_ready(p):
        profiles[records[-1]["step"]] = step_profile.device_summary(p)

    def hook(step, _state, met):
        counts = kernels.launch_counts()
        rec = dict(step=step, phase=met["phase"], loss=met["loss"],
                   moe_aux=met["moe_aux"], grad_norm=met["grad_norm"],
                   ms=met["wall"] * 1e3,
                   peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        rec.update({key: counts[name] - prev[name]
                    for key, name in counted.items()})
        prev.update({name: counts[name] for name in counted.values()})
        records.append(rec)
        log(f"[15] step {step} phase {rec['phase']}: loss "
            f"{rec['loss']:.4f} moe_aux {rec['moe_aux']:.4f} gnorm "
            f"{rec['grad_norm']:.4f} {rec['ms']:.1f} ms, launches B8 "
            f"{rec['b8']} B9 {rec['b9']} B8 backward {rec['b8_bwd']} B9 "
            f"backward {rec['b9_bwd']}, peak {rec['peak_gib']:.2f} GiB")
        prof.step()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    undo_spans = step_profile.install_spans()
    t0 = time.perf_counter()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=prof_schedule(wait=1, warmup=0, active=1,
                                            repeat=T2 // 2),
                     on_trace_ready=on_ready) as prof:
            out, n_lin = _moe_train(cfg, dev, hook)
    finally:
        undo_spans()
    wall = time.perf_counter() - t0
    # One call a linear or bank a forward, each block run twice (the
    # recompute); one backward call a weight and one an activation.
    want = {1: dict(b9=2 * n_lin, b9_bwd=n_lin, b8=0, b8_bwd=0),
            2: dict(b8=4 * n_lin, b8_bwd=2 * n_lin, b9=0, b9_bwd=0)}
    if n_lin != 7 + 10 * (MOE_TRAIN_LAYERS - 1):
        raise AssertionError(f"{n_lin} quantized linears and banks")
    for r in records:
        if not (math.isfinite(r["loss"]) and math.isfinite(r["moe_aux"])):
            raise AssertionError(f"non-finite loss at step {r['step']}")
        if any(r[k] != n for k, n in want[r["phase"]].items()):
            raise AssertionError(f"MoE step {r['step']} (phase "
                                 f"{r['phase']}) launches "
                                 f"{ {k: r[k] for k in counted} }, wanted "
                                 f"{want[r['phase']]}")
    rep = out["pattern_report"]
    log(f"[15] boundary: average bpp {schedule.average_bpp(rep):.4f} over "
        f"{len(rep['layers'])} rows (a row a linear and an expert); "
        f"{T2} steps in {wall:.2f} s; profiles {profiles}")
    state = out["state"]
    state["opt"] = None
    del out
    gc.collect()
    torch.cuda.empty_cache()
    again, _n = _moe_train(cfg, dev)
    first = [(r["loss"], r["moe_aux"], r["grad_norm"]) for r in records]
    second = [(m["loss"], m["moe_aux"], m["grad_norm"])
              for m in again["history"]]
    if first != second:
        raise AssertionError(f"second MoE training run differs:\n{first}\n"
                             f"{second}")
    log("[15] a second run gives bitwise the same losses, load-balancing "
        "losses and gradient norms")
    del again
    gc.collect()
    torch.cuda.empty_cache()
    qat_cfg = cfg.with_quant_mode("qat")
    ecfg = engine.EngineConfig(max_batch=4, cache_len=256, prefill_chunk=8)
    kernels.reset_launch_counts()
    eng = engine.DecodeEngine(state["model"], qat_cfg, ecfg, device=dev)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    prompts = rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
    a = eng.generate(prompts, 8)
    counts = kernels.launch_counts()
    if counts[B7] == 0 or counts[B6] == 0 or counts[B1] == 0:
        raise AssertionError(f"trained MoE serve launches {counts}")
    lock = engine.LockstepEngine(eng.model, eng.cfg, ecfg,
                                 already_serve=True, device=dev)
    b = lock.generate(prompts, 8)
    if not np.array_equal(a, b):
        raise AssertionError(f"trained MoE model: lockstep != continuous\n"
                             f"{a}\n{b}")
    log(f"[15] trained MoE model packed ({engine.packed_model_bytes(eng.model):,}"
        f" bytes) and served; lockstep == continuous; tokens "
        f"{a[:, 16:].tolist()}; launches {counts}")
    del eng, lock
    gc.collect()
    torch.cuda.empty_cache()
    per_step = {B9: records[0]["b9"], B9_BWD: records[0]["b9_bwd"],
                B8: records[-1]["b8"], B8_BWD: records[-1]["b8_bwd"]}
    return dict(layers=MOE_TRAIN_LAYERS, steps=records, profiles=profiles,
                wall_s=wall, average_bpp=schedule.average_bpp(rep),
                allowed_patterns=rep["allowed"],
                launches_per_step=per_step,
                launches={name: sum(r[key] for r in records)
                          for key, name in counted.items()})


def _train_bank(leaf, x, g, qcfg, draw, dev):
    """One bank's forward and backward on ``dev``: (y, dx, dw, ds)."""
    bank = moe_lib.ExpertBank({k: v.to(dev) for k, v in leaf.items()})
    bank.requires_grad_(True)
    xt = x.to(dev).requires_grad_(True)
    d = None if draw is None else smol.NoiseDraw(
        seed=draw.seed.to(dev), act_eps=draw.act_eps.to(dev))
    y = smol.linear_apply(bank.leaf(), xt, qcfg, d)
    (y * g.to(dev)).sum().backward()
    ds = bank.s.grad if "s" in leaf else None
    return y.detach(), xt.grad, bank.w.grad, ds


BANK_CPU_EXPERTS = 16        # experts of each bank held card vs CPU


def check_banks_against_cpu(dev):
    """Teacher-forced card vs CPU for one full-width deepseek-moe-16b MoE
    layer's three banks, cut to their first BANK_CPU_EXPERTS experts (the
    CPU's plain noise takes ~3 s an expert-bank's forward and backward),
    in NOISE and QAT (fp32, C = 24 rows an expert, empty rows included;
    per-expert seeds, logits, precisions; the same input, cotangent and
    draws on both): y, dx, dw, ds within relative L2 1e-5."""
    cfg = get_config(MOE_ARCH)
    e, c = BANK_CPU_EXPERTS, 24
    gen = torch.Generator().manual_seed(SEED + 11)
    worst = {}
    for mode in ("noise", "qat"):
        qcfg = QuantConfig(mode=mode)
        for name, k, n in moe_banks(cfg):
            leaf = {"w": torch.randn((e, k, n), generator=gen)
                    / math.sqrt(k)}
            if mode == "noise":
                leaf["s"] = torch.randn((e, k // 16), generator=gen) \
                    * 1.5 - 0.5
            else:
                leaf["pbits"] = torch.tensor([1, 2, 4], dtype=torch.int8)[
                    torch.randint(0, 3, (e, k // 16), generator=gen)]
            x = torch.randn((e, c, k), generator=gen)
            x[:, -4:] = 0.0
            g = torch.randn((e, c, n), generator=gen)
            draw = None
            if mode == "noise":
                draw = smol.NoiseDraw(
                    seed=torch.randint(0, 1 << 32, (e,), generator=gen),
                    act_eps=torch.rand(x.shape, generator=gen) * 2 - 1)
            card = _train_bank(leaf, x, g, qcfg, draw, dev)
            host = _train_bank(leaf, x, g, qcfg, draw, "cpu")
            for what, a, b in zip(("y", "dx", "dw", "ds"), card, host):
                if b is None:
                    continue
                err = rel_l2(a, b)
                key = f"{mode}.{what}"
                worst[key] = max(worst.get(key, 0.0), err)
                if not err <= 1e-5:
                    raise AssertionError(f"{mode} bank {name} {what}: "
                                         f"relative L2 {err:.3e} card vs "
                                         f"CPU")
            del card, host
    torch.cuda.empty_cache()
    return worst


def phase_launcher():
    """The training launcher at full width in a subprocess."""
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
           "--steps", "2", "--batch", str(TRAIN_BATCH), "--seq",
           str(TRAIN_SEQ)]
    src = str(Path(__file__).resolve().parent / "src")
    env = dict(os.environ, PYTHONPATH=src + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          timeout=900)
    wall = time.perf_counter() - t0
    tail = (proc.stdout.strip().splitlines() or [""])[-3:]
    log(f"[11] launcher exit {proc.returncode} in {wall:.1f} s: {tail}")
    if proc.returncode:
        raise AssertionError(f"launcher failed:\n{proc.stdout}\n"
                             f"{proc.stderr[-4000:]}")
    return wall


# ----------------------------------------------------- training, the rest ----
REST_MB = 2                  # phase 16's microbatches a step
# Phase 16(a)'s depth (h2o-danube-1.8b has 24; 4 before PR 32, cut for
# phase 24's time).
REST_LAYERS = 2
CKPT_LAYERS = 2              # phase 16(b)'s depth (full width)
# The middle of each precision's band of the logit s, where p = 1 +
# round(log2(1 + e^-s)): (-2.33, -1.54] gives 4 bits, (-0.60, 0.88] 2 and
# above 0.88 1; a draw lands within 0.2 of the middle.
BAND_S = {4: -1.9, 2: 0.1, 1: 2.5}
SMOKE_DIR = Path(__file__).resolve().parent / ".smoke_ckpt"


def set_mixed_logits(model, seed):
    """Every linear's logits s drawn per group over the 4/2/1-bit bands
    in the default mix (0.5, 0.375, 0.125), so the freeze yields all three
    precisions."""
    rng = np.random.default_rng(seed)
    mix = QuantConfig().mix
    with torch.no_grad():
        for _n, lin in smol.smol_linears(model):
            if "s" not in lin._names:
                continue
            bits = rng.choice([4, 2, 1], size=tuple(lin.s.shape), p=mix)
            s = np.vectorize(BAND_S.get)(bits) + rng.uniform(
                -0.2, 0.2, bits.shape)
            lin.s.copy_(torch.tensor(s, dtype=torch.float32))


def precision_histogram(model):
    """Frozen groups at 4, 2 and 1 bits over every linear."""
    hist = {4: 0, 2: 0, 1: 0}
    for _n, lin in smol.smol_linears(model):
        if "pbits" in lin._names:
            vals, counts = np.unique(lin.pbits.cpu().numpy(),
                                     return_counts=True)
            for v, c in zip(vals, counts):
                hist[int(v)] += int(c)
    return hist


REST_PROFILED_STEP = 4       # a steady Phase-II step


def _rest_run(cfg, dev, tag, *, hoist, compress, profiled=True):
    """3 Phase-I + 3 Phase-II steps of phase 16(a) (mixed logits,
    REST_MB microbatches): (loop output, per-step records, the profile of
    step REST_PROFILED_STEP)."""
    from torch.profiler import ProfilerActivity, profile
    from torch.profiler import schedule as prof_schedule
    from repro_torch.train import state as state_lib
    tcfg = state_lib.TrainConfig(t1=T1, t2=T2, warmup=1, seed=SEED,
                                 num_microbatches=REST_MB,
                                 hoist_weight_quant=hoist,
                                 grad_compress=compress)
    stream = synthetic.TokenStream(synthetic.TokenStreamConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
        batch_size=TRAIN_BATCH, seed=0))
    records, profiles = [], {}
    counted = {"b8": B8, "b9": B9, "b8_bwd": B8_BWD, "b9_bwd": B9_BWD}
    prev = dict.fromkeys(counted.values(), 0)

    def on_ready(p):
        profiles[records[-1]["step"]] = step_profile.device_busy(p)

    def hook(step, _state, met):
        counts = kernels.launch_counts()
        rec = dict(step=step, phase=met["phase"], loss=met["loss"],
                   grad_norm=met["grad_norm"], ms=met["wall"] * 1e3,
                   peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        rec.update({key: counts[name] - prev[name]
                    for key, name in counted.items()})
        prev.update({name: counts[name] for name in counted.values()})
        records.append(rec)
        torch.cuda.reset_peak_memory_stats()
        log(f"[16] {tag} step {step} phase {rec['phase']}: loss "
            f"{rec['loss']:.4f} gnorm {rec['grad_norm']:.4f} "
            f"{rec['ms']:.1f} ms, launches B8 {rec['b8']} B9 {rec['b9']} "
            f"B8 backward {rec['b8_bwd']} B9 backward {rec['b9_bwd']}, "
            f"peak {rec['peak_gib']:.2f} GiB")
        if profiled:
            prof.step()

    model = lm.init_params(cfg.with_quant_mode("noise"), seed=SEED,
                           device=dev)
    set_mixed_logits(model, SEED + 16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    if not profiled:
        return loop.train(cfg, tcfg, stream.batches(), model=model,
                          device=dev, hooks=[hook]), records, profiles
    # Device activity only: a host-and-device profile of a 2-microbatch
    # step takes tens of seconds to read (phase 8 splits its steps by op).
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=prof_schedule(wait=REST_PROFILED_STEP, warmup=0,
                                        active=1, repeat=1),
                 on_trace_ready=on_ready) as prof:
        out = loop.train(cfg, tcfg, stream.batches(), model=model,
                         device=dev, hooks=[hook])
    return out, records, profiles


def _release():
    """Return what the caller has just deleted to the card."""
    gc.collect()
    torch.cuda.empty_cache()


def phase_mixed_training(cfg, dev):
    from repro_torch.optim import grad_compress as gcomp
    """Phase 16(a): full-width h2o-danube-1.8b cut to REST_LAYERS, from
    mixed logits through 3 Phase-I and 3 Phase-II steps at REST_MB
    microbatches,
    hoisted, unhoisted and compressed (twice); the launches of every step
    checked, hoisted bitwise unhoisted, compressed bitwise run to run.
    Returns its record and (layer 0's frozen pbits by linear name)."""
    runs = {}
    out, records, profiles = _rest_run(cfg, dev, "hoisted", hoist=True,
                                       compress=False)
    model = out["state"]["model"]
    n_lin = _quantized_linears(model)
    hist = precision_histogram(model)
    rep = out["pattern_report"]
    bpp = schedule.average_bpp(rep)
    log(f"[16] boundary: frozen groups by precision {hist}, average bpp "
        f"{bpp:.4f} over {len(rep['layers'])} linears, allowed patterns "
        f"{rep['allowed']}")
    if min(hist.values()) == 0:
        raise AssertionError(f"the freeze left precisions {hist}")
    blk = model.blocks[0]
    layer0 = {name: getattr(blk.attn if name.startswith("w") else blk.mlp,
                            name).pbits.cpu()
              for name, _k, _n in layer_linears(cfg)}
    kept = [p.detach().clone() for p in model.parameters()]
    runs["hoisted"] = dict(steps=records, profiles=profiles)
    del out, model, blk
    _release()
    out, records, profiles = _rest_run(cfg, dev, "unhoisted", hoist=False,
                                       compress=False)
    runs["unhoisted"] = dict(steps=records, profiles=profiles)
    same = [(r["loss"], r["grad_norm"]) for r in runs["hoisted"]["steps"]] \
        == [(r["loss"], r["grad_norm"]) for r in records]
    params_same = all(torch.equal(a, b.detach()) for a, b in zip(
        kept, out["state"]["model"].parameters()))
    if not (same and params_same):
        raise AssertionError(f"hoisted != unhoisted: losses equal {same}, "
                             f"parameters equal {params_same}")
    log("[16] hoisted == unhoisted bitwise: losses, gradient norms and "
        "the final parameters")
    del out, kept
    _release()
    # One call a weight a microbatch and recompute unhoisted; hoisted, one
    # call a weight a step and the activations as before.
    m = REST_MB
    want = {"hoisted": {1: dict(b9=2 * m * n_lin,
                                b9_bwd=m * n_lin, b8=0, b8_bwd=0),
                        2: dict(b8=n_lin + 2 * m * n_lin,
                                b8_bwd=n_lin + m * n_lin, b9=0, b9_bwd=0)},
            "unhoisted": {1: dict(b9=2 * m * n_lin, b9_bwd=m * n_lin, b8=0,
                                  b8_bwd=0),
                          2: dict(b8=4 * m * n_lin, b8_bwd=2 * m * n_lin,
                                  b9=0, b9_bwd=0)}}
    want["compressed"] = want["hoisted"]
    for tag in ("compressed", "compressed_again"):
        out, records, profiles = _rest_run(
            cfg, dev, tag, hoist=True, compress=True,
            profiled=tag == "compressed")
        err = out["state"].get("err")
        params = dict(out["state"]["model"].named_parameters())
        if err is None or set(err) != set(params):
            raise AssertionError(f"{tag}: the state's err does not cover "
                                 f"the parameters")
        runs[tag] = dict(steps=records, profiles=profiles)
        if tag == "compressed":
            # A step's compression alone: every gradient and its error.
            grads = {n: torch.randn_like(p) for n, p in params.items()}
            runs[tag]["grad_compress_ms"] = time_ms(
                lambda: gcomp.decompress_tree(gcomp.compress_tree(
                    grads, err)[0]), reps=3)
            log(f"[16] gradient compression of a step (every gradient, "
                f"loop ruler): {runs[tag]['grad_compress_ms']:.2f} ms")
            del grads
        del out, err, params
        _release()
    a = [(r["loss"], r["grad_norm"]) for r in runs["compressed"]["steps"]]
    b = [(r["loss"], r["grad_norm"])
         for r in runs["compressed_again"]["steps"]]
    if a != b or not all(math.isfinite(v) for pair in a for v in pair):
        raise AssertionError(f"compressed runs differ or diverge:\n{a}\n{b}")
    log("[16] compressed: finite, a second run bitwise the first, err in "
        "the state")
    for tag in ("hoisted", "unhoisted", "compressed"):
        for r in runs[tag]["steps"]:
            got = {k: r[k] for k in ("b8", "b9", "b8_bwd", "b9_bwd")}
            if got != want[tag][r["phase"]]:
                raise AssertionError(f"{tag} step {r['step']} launches "
                                     f"{got}, wanted {want[tag][r['phase']]}")
    log(f"[16] launches a step as counted: {want}")
    runs["compressed_again"] = {
        "steps": [{k: r[k] for k in ("step", "loss", "grad_norm", "ms")}
                  for r in runs["compressed_again"]["steps"]]}
    return dict(layers=cfg.num_layers, microbatches=m, histogram=hist,
                average_bpp=bpp, allowed_patterns=rep["allowed"],
                launches_per_step=want, runs=runs), layer0


def _dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*")
               if f.is_file())


def phase_checkpoint_restart(dev):
    """Phase 16(b): full width cut to CKPT_LAYERS layers, t1 = 2, t2 = 4
    (the boundary at the resumed step). Run A is fed the batches of steps
    0-1 and checkpoints at step 2; run B resumes from A's directory fed
    the batches of steps 2-3; run C trains 0-3 uninterrupted. B's pattern
    report, losses and final parameters must be bitwise C's. Then one
    save and one restore of C's final state, timed, with their bytes."""
    import itertools
    import shutil
    from repro_torch import interop
    from repro_torch.train import checkpoint as ckpt_lib
    from repro_torch.train import state as state_lib
    cfg = dataclasses.replace(get_config(ARCH), num_layers=CKPT_LAYERS)

    def stream():
        return synthetic.TokenStream(synthetic.TokenStreamConfig(
            vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
            batch_size=TRAIN_BATCH, seed=0)).batches()

    def tcfg(d, every=2):
        return state_lib.TrainConfig(t1=2, t2=4, warmup=1, seed=SEED,
                                     ckpt_dir=d, checkpoint_every=every)

    def fresh():
        model = lm.init_params(cfg.with_quant_mode("noise"), seed=SEED,
                               device=dev)
        set_mixed_logits(model, SEED + 17)
        return model

    shutil.rmtree(SMOKE_DIR, ignore_errors=True)
    a_dir, t_dir = SMOKE_DIR / "a", SMOKE_DIR / "timed"
    try:
        t0 = time.perf_counter()
        try:
            loop.train(cfg, tcfg(str(a_dir)), itertools.islice(stream(), 2),
                       model=fresh(), device=dev)
        except StopIteration:
            pass
        a_s = time.perf_counter() - t0
        if ckpt_lib.latest_step(str(a_dir)) != 2:
            raise AssertionError("run A left no step-2 checkpoint")
        ckpt_bytes = _dir_bytes(a_dir / "step_00000002")
        t0 = time.perf_counter()
        b = loop.train(cfg, tcfg(str(a_dir), every=T2),   # no save of its own
                       itertools.islice(stream(), 2, None), device=dev)
        b_s = time.perf_counter() - t0
        c = loop.train(cfg, tcfg(None), stream(), model=fresh(), device=dev)
        same = dict(
            steps=[m["step"] for m in b["history"]] == [2, 3],
            report=b["pattern_report"] == c["pattern_report"],
            losses=[(m["loss"], m["grad_norm"]) for m in b["history"]]
            == [(m["loss"], m["grad_norm"]) for m in c["history"][2:]],
            params=all(torch.equal(x, y) for x, y in zip(
                b["state"]["model"].parameters(),
                c["state"]["model"].parameters())))
        if not all(same.values()):
            raise AssertionError(f"resumed run != uninterrupted run: {same}")
        log(f"[16] resumed run (from step 2, boundary after it) bitwise the "
            f"uninterrupted one: {same}; losses "
            f"{[round(m['loss'], 4) for m in b['history']]}")
        state = c["state"]
        del b
        _release()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tree = interop.state_to_tree(state)
        copy_s = time.perf_counter() - t0
        ckpt_lib.save(tree, str(t_dir), 4)
        save_s = time.perf_counter() - t0
        del tree
        t0 = time.perf_counter()
        tree, _ = ckpt_lib.restore(str(t_dir))
        back = interop.state_from_tree(tree, cfg, dev)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        if not all(torch.equal(x, y) for x, y in zip(
                state["model"].parameters(), back["model"].parameters())):
            raise AssertionError("restored parameters differ")
        rec = dict(layers=CKPT_LAYERS, checkpoint_bytes=ckpt_bytes,
                   timed_bytes=_dir_bytes(t_dir / "step_00000004"),
                   host_copy_s=copy_s, save_s=save_s, restore_s=restore_s,
                   run_a_s=a_s, run_b_s=b_s, bitwise=same)
        log(f"[16] checkpoint at {CKPT_LAYERS} layers: {rec}")
        del c, state, back, tree
        _release()
        return rec
    finally:
        shutil.rmtree(SMOKE_DIR, ignore_errors=True)


def phase_rest_launchers():
    """Phase 16(c): the train launcher on one checkpoint directory, then
    the train launcher again (it resumes) and the serve launcher on it,
    those two started together; each must exit 0 in a subprocess."""
    import shutil
    d = SMOKE_DIR / "launch"
    shutil.rmtree(SMOKE_DIR, ignore_errors=True)
    src = str(Path(__file__).resolve().parent / "src")
    env = dict(os.environ, PYTHONPATH=src + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    train = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
             ARCH, "--reduced", "--steps", "4", "--t1", "2", "--ckpt",
             str(d)]
    serve = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
             ARCH, "--reduced", "--ckpt", str(d), "--requests", "2",
             "--prompt-len", "6", "--new-tokens", "4", "--cache-len", "32"]
    out, procs = {}, {}
    try:
        # The second train run resumes at its last step and writes nothing,
        # so it and the serve launcher read the directory together.
        for wave in ((("train", train),),
                     (("train_again", train), ("serve", serve))):
            t0 = time.perf_counter()
            procs = {tag: subprocess.Popen(cmd, env=env, text=True,
                                           stdout=subprocess.PIPE,
                                           stderr=subprocess.PIPE)
                     for tag, cmd in wave}
            for tag, proc in procs.items():
                stdout, stderr = proc.communicate(timeout=600)
                out[tag] = round(time.perf_counter() - t0, 2)
                tail = (stdout.strip().splitlines() or [""])[-2:]
                log(f"[16] {tag} launcher exit {proc.returncode} in "
                    f"{out[tag]} s: {tail}")
                if proc.returncode:
                    raise AssertionError(f"{tag} launcher failed:\n"
                                         f"{stdout}\n{stderr[-4000:]}")
                if tag == "train_again" and "resumed from step" not in \
                        stdout:
                    raise AssertionError(f"no resume:\n{stdout}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(SMOKE_DIR, ignore_errors=True)
    return out


# ------------------------------------------------------ soniq and CNN ----
SONIQ_STEPS = 3              # phase 17(a): Phase-I and Phase-II steps
SONIQ_LAM = 1e-3
# Phase 17(b): the paper benchmarks' CNN (benchmarks/_common.py:
# CNN_CHANNELS, CNN_BLOCKS, IMG, BATCH; train_cnn's recipe with T1 = 4 and
# T2 = 8); (c) a CIFAR-size CNN that takes stride 2.
CNN_CELLS = {
    "bench": dict(channels=(128,), blocks=2, img=(6, 6, 3), batch=32,
                  n_train=1024, t1=4, t2=8),
    "cifar": dict(channels=(128, 256), blocks=2, img=(32, 32, 3),
                  batch=128, n_train=1024, t1=3, t2=6)}
CNN_OPT = dict(lr=3e-3, weight_decay=1e-4, s_lr_mult=25.0)   # train_cnn's
SERVE_TOL = dict(atol=1e-4, rtol=1e-3)   # serve vs QAT (the reference's)
SOLO = (B1, B7, B8, B9, B8_BWD, B9_BWD)


def _solo_counts():
    counts = kernels.launch_counts()
    return {name: counts[name] for name in SOLO}


def _since(before):
    now = _solo_counts()
    return {name: now[name] - before[name] for name in SOLO
            if now[name] != before[name]}


def _expect(what, got, want):
    if got != want:
        raise AssertionError(f"{what}: launches {got}, derived {want}")


def phase_soniq_linear(dev):
    """Phase 17(a): the façade on one full-width h2o-danube-1.8b q
    projection: init_linear, SONIQ_STEPS Phase-I steps, to_qat,
    SONIQ_STEPS Phase-II steps, to_serve and the packed forward; kernel vs
    QAT < 1e-4. Launches derived from the rules: a Phase-I step is one B9
    and one B9 backward; a Phase-II step two B8 (weight, activation) and
    one B8 backward (the input takes no gradient); to_serve one B7; the
    packed forward one B1."""
    from repro_torch import soniq
    cfg = get_config(ARCH)
    k, n = cfg.d_model, cfg.num_heads * cfg.hd
    g = torch.Generator(device=dev).manual_seed(SEED + 17)
    x = torch.randn((64, k), generator=g, device=dev)
    target = torch.randn((64, n), generator=g, device=dev) * 0.1
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    state = soniq.init_linear(k, n, soniq.QuantConfig(
        mode=soniq.Phase.NOISE, lam=SONIQ_LAM), seed=SEED, device=dev)
    lin = state.model
    set_mixed_logits(lin, SEED + 17)       # a [K4|K2|K1] split to serve
    steps = []
    for i in range(SONIQ_STEPS):
        before = _solo_counts()
        loss = torch.mean((soniq.apply(state, x, noise=(SEED, i)) - target)
                          ** 2) + SONIQ_LAM * soniq.bit_penalty(lin.s)
        gw, gs = torch.autograd.grad(loss, [lin.w, lin.s])
        with torch.no_grad():
            lin.w -= 0.01 * gw
            lin.s -= 0.08 * gs
        steps.append(_since(before))
        _expect(f"[17a] Phase-I step {i}", steps[-1], {B9: 1, B9_BWD: 1})
    qat, report = soniq.to_qat(state)
    for i in range(SONIQ_STEPS):
        before = _solo_counts()
        loss = torch.mean((soniq.apply(qat, x) - target) ** 2)
        (gw,) = torch.autograd.grad(loss, [lin.w])
        with torch.no_grad():
            lin.w -= 0.01 * gw
        steps.append(_since(before))
        _expect(f"[17a] Phase-II step {i}", steps[-1], {B8: 2, B8_BWD: 1})
    with torch.no_grad():
        y_qat = soniq.apply(qat, x)
        before = _solo_counts()
        served = soniq.to_serve(qat)
        pack = _since(before)
        before = _solo_counts()
        y = soniq.apply(served, x)
        fwd = _since(before)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _expect("[17a] to_serve", pack, {B7: 1})
    _expect("[17a] packed forward", fwd, {B1: 1})
    err = float((y - y_qat).abs().max())
    log(f"[17a] soniq on one {ARCH} q projection [{k}, {n}]: "
        f"{SONIQ_STEPS} + {SONIQ_STEPS} steps, bpp "
        f"{soniq.average_bpp(report):.3f}, kernel vs QAT max err {err:.3e} "
        f"(< 1e-4), {wall:.2f} s")
    if not err < 1e-4:
        raise AssertionError(f"kernel vs QAT max err {err}")
    return {"k": k, "n": n, "kernel_vs_qat": err, "s": round(wall, 3),
            "bpp": soniq.average_bpp(report),
            "launches": _solo_counts()}


class HostNoise:
    """Phase-I draws made on the host (a CPU generator keyed by path) and
    moved to x's device: the same draws on the card and the CPU."""

    def __init__(self, key):
        self.src = smol.StepNoise(key)

    def draw(self, path, x, experts=None):
        d = self.src.draw(path, torch.empty(x.shape, dtype=x.dtype),
                          experts)
        return smol.NoiseDraw(d.seed.to(x.device), None if d.act_eps is None
                              else d.act_eps.to(x.device))


def _cnn_busy(fn):
    """Device busy ms and kernels of one call, profiled on the device
    alone, with its five longest kernels (name, ms, count)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = step_profile.device_busy(prof)
    kern = sorted((e for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA")),
                  key=lambda e: -e.device_time_total)
    out["top"] = [(e.key[:60], round(e.device_time_total / 1e3, 3), e.count)
                  for e in kern[:5]]
    return out


def _cnn_run(cell, dev, *, cpu_check=False, profiled=False):
    """Phase 17(b)/(c): ``benchmarks/_common.py::train_cnn``'s recipe
    through the façade on the card, the logits spread over the 4/2/1-bit
    bands first: an FP warm start of max(t1 // 2, 20) steps, t1 Phase-I steps (AdamW, s_lr_mult 25), to_qat, Phase II to t2,
    test accuracy and bits per parameter, to_serve; serve vs QAT logits on
    a test batch. Each quantized (pw) conv is one B9 and one B9 backward a
    Phase-I step, two B8 and two B8 backward a Phase-II step (weight and
    activation), one B7 at to_serve and one B8 a served forward."""
    from repro_torch import soniq
    from repro_torch.models import cnn
    from repro_torch.optim import adamw
    c = CNN_CELLS[cell]
    (xtr, ytr), (xte, yte) = synthetic.classification_dataset(
        num_classes=10, dim=c["img"], n_train=c["n_train"], n_test=256,
        seed=SEED)
    xtr_d, ytr_d = torch.as_tensor(xtr, device=dev), torch.as_tensor(
        ytr, device=dev)
    qcfg = QuantConfig(mode="qat")
    cfg = cnn.CNNConfig(channels=c["channels"], blocks_per_stage=c["blocks"],
                        quant=qcfg.with_mode("noise"))
    state = soniq.init(cfg, seed=SEED, device=dev)
    model = state.model
    # A few Phase-I steps cannot move s across its bands, so the logits
    # start spread over them (as phase 16's): the freeze then yields 4-,
    # 2- and 1-bit groups, which B8 and the packed serve path run.
    set_mixed_logits(model, SEED + 17)
    pw = sum(1 for name, _ in smol.smol_linears(model)
             if name.endswith(".pw"))
    per_step = {1: {B9: pw, B9_BWD: pw}, 2: {B8: 2 * pw, B8_BWD: 2 * pw}}
    ocfg = adamw.AdamWConfig(**CNN_OPT)
    opt = adamw.init_state(model)

    def step(fcfg, idx, noise):
        batch = {"x": xtr_d[idx], "y": ytr_d[idx]}
        loss, _ = cnn.xent_loss(model, batch, fcfg, noise)
        params = adamw.trainable(model)
        # The FP warm start leaves the logits s unused (no update).
        grads = torch.autograd.grad(loss, [p for _, p in params],
                                    allow_unused=True)
        adamw.apply_updates(model, {name: gr for (name, _), gr in
                                    zip(params, grads)}, opt, ocfg)
        return loss.detach()

    def cpu_loss(fcfg, idx, key):
        """This step's loss on the card and, from a host copy of the
        model, on the CPU (the same draws)."""
        host = copy.deepcopy(model).cpu()
        batch = {"x": xtr[idx.cpu().numpy()], "y": ytr[idx.cpu().numpy()]}
        with torch.no_grad():
            card = cnn.xent_loss(model, batch, fcfg, HostNoise(key))[0]
            cpu = cnn.xent_loss(host, batch, fcfg, HostNoise(key))[0]
        return abs(float(card) - float(cpu)) / abs(float(cpu))

    fp_cfg = soniq.with_phase(cfg, "fp")
    rng_w = np.random.default_rng(SEED + 7)
    for _ in range(max(c["t1"] // 2, 20)):
        step(fp_cfg, torch.as_tensor(rng_w.integers(0, len(xtr), c["batch"]),
                                     device=dev), None)
    rng = np.random.default_rng(SEED)
    records, busy, card_vs_cpu, report = [], {}, {}, None
    fcfg = cfg
    for it in range(c["t2"]):
        if it == c["t1"]:
            state, report = soniq.to_qat(state)
            fcfg = state.forward_cfg
            opt = adamw.init_state(model)
        phase = 1 if it < c["t1"] else 2
        idx = torch.as_tensor(rng.integers(0, len(xtr), c["batch"]),
                              device=dev)
        key = (SEED, 1000 + it)
        noise = smol.StepNoise(key) if phase == 1 else None
        if cpu_check and it in (0, c["t1"]):
            card_vs_cpu[f"phase{phase}_loss_rel"] = cpu_loss(fcfg, idx, key)
        if profiled and it in (c["t1"] - 1, c["t1"]):
            busy[f"phase{phase}"] = _cnn_busy(
                lambda: step(fcfg, idx, noise))
            continue
        before = _solo_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(fcfg, idx, noise)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        got = _since(before)
        _expect(f"[17] {cell} step {it} (phase {phase})", got,
                per_step[phase])
        records.append({"step": it, "phase": phase, "loss": float(loss),
                        "ms": ms})
    with torch.no_grad():
        acc = cnn.accuracy(model, xte, yte, fcfg)
        bpp = cnn.bits_per_param(model, qcfg)
        probe = torch.as_tensor(xte[:c["batch"]], device=dev)
        y_qat = soniq.apply(state, probe)
        before = _solo_counts()
        served = soniq.to_serve(state)
        pack = _since(before)
        before = _solo_counts()
        y_srv = soniq.apply(served, probe)
        fwd = _since(before)
    _expect(f"[17] {cell} to_serve", pack, {B7: pw})
    _expect(f"[17] {cell} served forward", fwd, {B8: pw})
    torch.testing.assert_close(y_srv, y_qat, **SERVE_TOL)
    err = float((y_srv - y_qat).abs().max())
    out = {"channels": list(c["channels"]), "blocks": c["blocks"],
           "img": list(c["img"]), "batch": c["batch"], "t1": c["t1"],
           "t2": c["t2"], "pw_convs": pw, "accuracy": acc, "bpp": bpp,
           "average_bpp": soniq.average_bpp(report),
           "serve_vs_qat_max_abs": err, "steps": records,
           "launches_per_step": {str(p): v for p, v in per_step.items()},
           "to_serve_b7": pack.get(B7, 0),
           "served_forward_b8": fwd.get(B8, 0)}
    if busy:
        out["busy"] = busy
    if card_vs_cpu:
        out["card_vs_cpu"] = card_vs_cpu
    return out, [p.detach().clone() for p in served.model.parameters()] + [
        b.detach().clone() for b in served.model.buffers()
        if b is not None], y_srv


def phase_soniq_cnn(dev):
    """Phase 17(b) and (c): the benchmarks' CNN twice (the second run
    bitwise the first), then the CIFAR-size CNN with one step of each
    phase card vs CPU (loss within 1e-5 relative) and the device busy of
    a Phase-I and a Phase-II step."""
    out = {}
    first, tensors, y = _cnn_run("bench", dev)
    again, tensors2, y2 = _cnn_run("bench", dev)
    same = torch.equal(y, y2) and len(tensors) == len(tensors2) and all(
        torch.equal(a, b) for a, b in zip(tensors, tensors2)) and [
        r["loss"] for r in first["steps"]] == [r["loss"]
                                               for r in again["steps"]]
    if not same:
        raise AssertionError("[17b] the second CNN run is not bitwise the "
                             "first")
    first["second_run_bitwise"] = True
    out["cnn_bench"] = first
    log(f"[17b] benchmarks' CNN {first['channels']} x {first['blocks']} on "
        f"{first['img']} batch {first['batch']}: accuracy "
        f"{first['accuracy']:.4f}, bpp {first['bpp']:.4f}, serve vs QAT "
        f"{first['serve_vs_qat_max_abs']:.3e}, second run bitwise; steps "
        f"{[(r['phase'], round(r['ms'], 2)) for r in first['steps']]} ms")
    del tensors, tensors2
    cifar, _tensors, _y = _cnn_run("cifar", dev, cpu_check=True,
                                   profiled=True)
    bad = {k: v for k, v in cifar["card_vs_cpu"].items() if not v <= 1e-5}
    if bad:
        raise AssertionError(f"[17c] card vs CPU loss {bad} > 1e-5")
    out["cnn_cifar"] = cifar
    log(f"[17c] CIFAR-size CNN {cifar['channels']} x {cifar['blocks']} on "
        f"{cifar['img']} batch {cifar['batch']}: serve vs QAT "
        f"{cifar['serve_vs_qat_max_abs']:.3e}, card vs CPU "
        f"{cifar['card_vs_cpu']}, busy {cifar['busy']}, steps "
        f"{[(r['phase'], round(r['ms'], 2)) for r in cifar['steps']]} ms")
    return out


def phase_examples():
    """Phase 17(d): the port's three examples in subprocesses on the card,
    started together; each must exit 0. Returns the seconds from their
    start to each one's end."""
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    runs = {"quickstart": ["examples/torch_quickstart.py", "--steps",
                           "200"],
            "serve_quantized": ["examples/torch_serve_quantized.py",
                                "--steps", "10"],
            "train_lm_100m": ["examples/torch_train_lm_soniq.py", "--preset",
                              "100m", "--steps", "4"]}
    out, procs = {}, {}
    t0 = time.perf_counter()
    for tag, args in runs.items():      # all three at once
        procs[tag] = subprocess.Popen([sys.executable, *args], env=env,
                                      cwd=root, text=True,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE)
    try:
        for tag, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=600)
            out[tag] = round(time.perf_counter() - t0, 2)
            lines = stdout.strip().splitlines()
            log(f"[17d] {tag} exit {proc.returncode} in {out[tag]} s: "
                f"{[ln for ln in lines if 'err' in ln or 'bpp' in ln or 'bytes' in ln][:3] or lines[-2:]}")
            if proc.returncode:
                raise AssertionError(f"{tag} failed:\n{stdout}\n"
                                     f"{stderr[-4000:]}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


# ------------------------------------------------------------ MoE serve ----
MOE_SERVE_LAYERS = 8         # phase 12's depth (deepseek-moe-16b has 28)


def phase_moe_serve(dev, rng, launches, per_step, spec_runs):
    """Full-width deepseek-moe-16b cut to MOE_SERVE_LAYERS of its 28 layers
    (the dense layer first) from random QAT weights of the
    seed, packed (B7) and served through the DecodeEngine with the fp
    ring (B6 for every routed-expert projection after B8 over [E, T, K];
    B1 for attention, the dense layer and the shared experts), then
    lockstep == continuous, and the 4-bit ring (B4) and page pool (B5)
    with equal tokens. Returns the numbers."""
    cfg = dataclasses.replace(get_config(MOE_ARCH),
                              num_layers=MOE_SERVE_LAYERS).with_quant_mode(
                                  "qat")
    ecfg = engine.EngineConfig(max_batch=4, cache_len=256, prefill_chunk=8)
    stats = {}
    # Earlier phases' models may sit in reference cycles: free them before
    # the tree (60.8 GiB at 28 layers) is drawn.
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=SEED + 5, device=dev)
    torch.cuda.synchronize()
    stats["init_s"] = time.perf_counter() - t0
    stats["qat_gib"] = sum(t.numel() * t.element_size() for t in
                           params.state_dict().values()) / 2 ** 30
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    eng = engine.DecodeEngine(params, cfg, ecfg)
    torch.cuda.synchronize()
    stats["pack_s"] = time.perf_counter() - t0
    stats["pack_launches"] = kernels.launch_counts()[B7]
    stats["packed_leaves"] = packed_leaves(eng.model)
    if stats["pack_launches"] != stats["packed_leaves"]:
        raise AssertionError(f"{stats['pack_launches']} B7 launches at "
                             f"load for {stats['packed_leaves']} linears "
                             f"and expert banks")
    launches["b7_moe_load"] = stats["pack_launches"]
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    eng, prof = profile_load(lambda: engine.DecodeEngine(params, cfg, ecfg))
    del params
    torch.cuda.empty_cache()
    stats["peak_gib_init_and_pack"] = \
        torch.cuda.max_memory_allocated() / 2 ** 30
    stats["packed_bytes"] = engine.packed_model_bytes(eng.model)
    stats["load"] = dict(
        device_busy_ms=prof["device_busy_ms"],
        device_events=prof["device_events"],
        idle_share=1 - prof["device_busy_ms"] / (stats["pack_s"] * 1e3),
        by_op=prof["by_op"])
    log(f"[12] load: pack_s {stats['pack_s']:.3f} s, "
        f"{stats['pack_launches']} B7 launches (one a linear and an expert "
        f"bank), {stats['load']}")
    log(f"[12] {MOE_ARCH}: {cfg.num_layers} layers, QAT tree "
        f"{stats['qat_gib']:.2f} GiB in {stats['init_s']:.2f} s, packed "
        f"to {stats['packed_bytes']:,} bytes in {stats['pack_s']:.2f} s "
        f"({stats['pack_launches']} B7 launches); peak "
        f"{stats['peak_gib_init_and_pack']:.2f} GiB")
    reqs = requests(cfg.vocab_size, rng, n=8, lo=16, hi=32, new=12)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    out, wall = serve_all(eng, reqs)
    counts = kernels.launch_counts()
    launches[B6] = counts[B6]
    stats["serve_launches"] = counts
    log(f"[12] fp ring launches {counts}")
    if counts[B6] == 0 or counts[B8] == 0 or counts[B1] == 0 \
            or counts[B3] != 0:
        raise AssertionError(f"MoE fp ring path launches {counts}")
    for c in out:
        if c.new_tokens.size != 12 or not (
                (c.new_tokens >= 0) & (c.new_tokens < cfg.vocab_size)).all():
            raise AssertionError(f"bad completion {c.new_tokens}")
    again, _wall = serve_all(eng, reqs)
    for a, b in zip(out, again):
        if not np.array_equal(a.tokens, b.tokens):
            raise AssertionError("MoE: a second identical run gave other "
                                 "tokens")
    new = sum(c.new_tokens.size for c in out)
    stats["fp_ring"] = dict(tok_s=new / wall, wall_s=wall,
                            steps=eng.sched.step_count,
                            decode_step_ms=decode_step_ms(eng),
                            peak_gib_serve=torch.cuda.max_memory_allocated()
                            / 2 ** 30)
    prof = profile_decode(eng)
    stats["fp_ring"]["profile"] = prof
    banks = sum(isinstance(m, moe_lib.ExpertBank) for m in eng.model.modules())
    per_step[B6] = step_launches(eng)[B6]
    stats["fp_ring"]["b6_launches_per_step"] = per_step[B6]
    if per_step[B6] != banks:
        raise AssertionError(f"{per_step[B6]} {B6} launches a MoE step for "
                             f"{banks} expert banks")
    log(f"[12] fp ring: {len(reqs)} requests, {new} tokens in {wall:.2f} s;"
        f" {stats['fp_ring']}; device idle share "
        f"{1 - prof['device_busy_ms_per_step'] / stats['fp_ring']['decode_step_ms']:.3f}")
    log(f"[12] tokens {[c.new_tokens[:6].tolist() for c in out[:3]]}")
    check_lockstep_equals_continuous(eng, eng.cfg, ecfg, cfg.vocab_size,
                                     rng, 16, 6)
    log("[12] lockstep == continuous on same-length prompts")
    kw = dict(max_batch=4, cache_len=256, prefill_chunk=8, kv_bits=4)
    runs = {}
    for layout in ("ring", "paged"):
        e = engine.DecodeEngine(eng.model, eng.cfg, engine.EngineConfig(
            kv_layout=layout, page_size=16, **kw), already_serve=True,
            device=dev)
        kernels.reset_launch_counts()
        runs[layout], wall, step = timed_serve(e, reqs)
        counts = kernels.launch_counts()
        want = B4 if layout == "ring" else B5
        if counts[want] == 0 or counts[B6] == 0:
            raise AssertionError(f"MoE kv4 {layout} launches {counts}")
        stats[f"kv4_{layout}"] = dict(tok_s=new / wall, wall_s=wall,
                                      decode_step_ms=step)
        log(f"[12] kv4 {layout}: {stats[f'kv4_{layout}']}")
        del e
    for a, b in zip(runs["ring"], runs["paged"]):
        if not np.array_equal(a.tokens, b.tokens):
            raise AssertionError(f"MoE kv4 paged != ring (request "
                                 f"{a.request_id})")
    log("[12] kv4 ring == paged")
    # Speculative decoding on the fp ring: the draft runs B6 over the
    # [K2|K1] slice of every expert bank (k draft steps and the verify a
    # round, one launch a bank each).
    spec_runs["deepseek_moe_fp_ring"] = spec_serve(
        eng.model, eng.cfg, ecfg, reqs[:4], out[:4], dev,
        {B6: (SPEC_TOKENS + 1) * banks}, profile=True)
    log(f"[12] spec fp ring tokens == spec-off, {SPEC_TOKENS * banks} B6 "
        f"draft launches a round: {spec_runs['deepseek_moe_fp_ring']}")
    del eng
    torch.cuda.empty_cache()
    return stats


def check_layers_against_cpu(arch, seed, ecfg, dev):
    """The kernels on the card against the plain versions on the CPU, fp32,
    teacher-forced (as ``check_against_cpu``) on full-width ``arch`` cut
    to its first two layers (deepseek-moe-16b: the dense layer and one
    MoE layer; starcoder2-7b: biases, gelu, Hk = 4, G = 9): every serve
    linear and expert bank, the router and the readout, on a prefill
    chunk and a decode step; each output on the CPU's input and each
    input as the card's own ops made it (norms, attention, routing,
    dispatch, the MLP's activation, combine) within relative L2 1e-5."""
    cfg = dataclasses.replace(get_config(arch), num_layers=2,
                              dtype="float32").with_quant_mode("qat")
    eng = engine.DecodeEngine(lm.init_params(cfg, seed=seed, device=dev),
                              cfg, ecfg, device=dev)
    host = copy.deepcopy(eng.model).to("cpu")
    tape_cpu = LinearTape(host)
    logits_cpu = _prefill_then_decode(host, eng.cfg, "cpu")
    tape_cpu.close()
    tape_card = LinearTape(eng.model, feed=tape_cpu.inputs)
    logits_card = _prefill_then_decode(eng.model, eng.cfg, dev)
    tape_card.close()
    calls = len(tape_cpu.inputs)
    if len(tape_card.inputs) != calls:
        raise AssertionError(f"calls: card {len(tape_card.inputs)}, CPU "
                             f"{calls}")
    worst = {}
    for (name, _lin, x_card), (_n, _l, x_cpu), y_card, y_cpu in zip(
            tape_card.inputs, tape_cpu.inputs, tape_card.outputs,
            tape_cpu.outputs):
        kind = name.rsplit(".", 1)[-1]
        for what, a, b in (("out", y_card, y_cpu), ("in", x_card, x_cpu)):
            err = rel_l2(a, b)
            key = f"{kind}.{what}"
            worst[key] = max(worst.get(key, 0.0), err)
            if not err <= 1e-5:
                raise AssertionError(f"card vs CPU at {name} ({what}): "
                                     f"relative L2 {err:.3e}")
    worst["logits"] = max(rel_l2(a, b) for a, b in zip(logits_card,
                                                       logits_cpu))
    if not worst["logits"] <= 1e-5:
        raise AssertionError(f"card vs CPU logits: {worst['logits']:.3e}")
    worst["calls"] = calls
    del eng, host
    torch.cuda.empty_cache()
    return worst


# ------------------------------------------------------- dense configs ----


def phase_dense_configs(dev, rng, spec_runs):
    """The other dense configs at full width from random QAT weights of
    the seed: starcoder2-7b at the depth ``DENSE_CONFIGS`` gives (16 of
    its 32 layers; biases, non-gated gelu, Hk = 4, G = 9), deepseek-67b
    and mistral-large-123b at depth 2
    (their fp32 trees, ~268 and ~492 GB, do not fit the card). Each is
    packed (one B7 launch a linear: 6 a starcoder2-7b layer, whose MLP
    has no gate, 7 for the others) and served with the fp ring through
    B1, and lockstep equals continuous; starcoder2-7b also speculatively
    (tokens equal to spec-off, into ``spec_runs``) and over the 4-bit
    ring (B4) and page pool (B5), whose tokens must agree. Returns the
    numbers."""
    stats = {}
    for arch, depth in DENSE_CONFIGS:
        cfg = get_config(arch)
        if depth is not None:
            cfg = dataclasses.replace(cfg, num_layers=depth)
        cfg = cfg.with_quant_mode("qat")
        ecfg = engine.EngineConfig(max_batch=4, cache_len=256,
                                   prefill_chunk=8)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = lm.init_params(cfg, seed=SEED + 7, device=dev)
        torch.cuda.synchronize()
        st = dict(layers=cfg.num_layers, init_s=time.perf_counter() - t0,
                  qat_gib=sum(t.numel() * t.element_size() for t in
                              params.state_dict().values()) / 2 ** 30)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        eng = engine.DecodeEngine(params, cfg, ecfg)
        torch.cuda.synchronize()
        st["pack_s"] = time.perf_counter() - t0
        st["b7_launches"] = kernels.launch_counts()[B7]
        linears = packed_leaves(eng.model)
        if st["b7_launches"] != linears:
            raise AssertionError(f"{arch}: {st['b7_launches']} B7 launches "
                                 f"at load for {linears} linears")
        del params
        torch.cuda.empty_cache()
        st["peak_gib_init_and_pack"] = \
            torch.cuda.max_memory_allocated() / 2 ** 30
        st["packed_bytes"] = engine.packed_model_bytes(eng.model)
        reqs = requests(cfg.vocab_size, rng, n=4, lo=16, hi=48, new=12)
        kernels.reset_launch_counts()
        out, wall, step = timed_serve(eng, reqs)
        counts = kernels.launch_counts()
        if counts[B1] == 0 or counts[B4] or counts[B5]:
            raise AssertionError(f"{arch} fp ring launches {counts}")
        for c in out:
            if c.new_tokens.size != 12 or not (
                    (c.new_tokens >= 0)
                    & (c.new_tokens < cfg.vocab_size)).all():
                raise AssertionError(f"{arch}: bad completion {c.new_tokens}")
        new = sum(c.new_tokens.size for c in out)
        st.update(tok_s=new / wall, wall_s=wall, decode_step_ms=step,
                  fresh_cache_step_ms=decode_step_ms(eng))
        check_lockstep_equals_continuous(eng, eng.cfg, ecfg, cfg.vocab_size,
                                         rng, 16, 6)
        log(f"[14] {arch} ({cfg.num_layers} layers): lockstep == "
            f"continuous; {st}; tokens {[c.new_tokens[:6].tolist() for c in out[:2]]}")
        if arch == DENSE_ARCH:
            spec_runs["starcoder2_fp_ring"] = spec_serve(
                eng.model, eng.cfg, ecfg, reqs, out, dev,
                {B1: (SPEC_TOKENS + 1) * linears}, profile=True)
            log(f"[14] {arch} spec tokens == spec-off: "
                f"{spec_runs['starcoder2_fp_ring']}")
            runs = {}
            for layout, kern in (("ring", B4), ("paged", B5)):
                e = engine.DecodeEngine(eng.model, eng.cfg, dataclasses.replace(
                    ecfg, kv_bits=4, kv_layout=layout, page_size=16),
                    already_serve=True, device=dev)
                kernels.reset_launch_counts()
                runs[layout], wall, step = timed_serve(e, reqs)
                if kernels.launch_counts()[kern] == 0:
                    raise AssertionError(f"{arch} kv4 {layout} ran no {kern}")
                st[f"kv4_{layout}"] = dict(tok_s=new / wall,
                                           decode_step_ms=step)
                del e
            for a, b in zip(runs["ring"], runs["paged"]):
                if not np.array_equal(a.tokens, b.tokens):
                    raise AssertionError(f"{arch} kv4 paged != ring "
                                         f"(request {a.request_id})")
            log(f"[14] {arch} kv4 ring == paged: {st['kv4_ring']}, "
                f"{st['kv4_paged']}")
        stats[arch] = st
        del eng
    gc.collect()
    torch.cuda.empty_cache()
    return stats


# ------------------------------------------------------------- SSM serve ----
SSM_ARCH = "mamba2-2.7b"
SSM_LINEARS = 2                 # in_proj, out_proj: one B7 / B1 launch each
# Phase 18's depth (mamba2-2.7b has 64; 8 before PR 32, cut for phase
# 24's time).
SSM_SERVE_LAYERS = 4
# Phase 18(c)'s cross-form bound: teacher-forced logits of the chunked
# steps against token-by-token decode, relative L2 at every lane.
SSM_CROSS_FORM = 1e-2


def phase_ssm_kernels(cfg, qcfg, gen, dev):
    """Phase 18(a): B7 and B1 at one full-width mamba2-2.7b layer's serve
    linears (in_proj 2560 x 10576: N not a multiple of B1's 32-column or
    B7's 128-column tile; out_proj 5120 x 2560). B7 through its one-launch
    entry bitwise its plain version (2 launches), timed on both rulers; B1
    at M = 4 (decode), 16 (the verify of k = 3 at batch 4) and 32 (an
    8-lane prefill at batch 4) within the fp32 reordering bound and timed
    on both rulers beside torch.matmul on the dequantized operands; its
    draft launches within the bound and bitwise the launch at k_off 0.
    Returns {B7: numbers, B1: numbers}."""
    calls = [pack_operands((k, n), qcfg, gen, dev)
             for _name, k, n in layer_linears(cfg)]
    _check_pack(calls)
    b_ms, b_by = _pack_bound(calls)
    b7 = dict(ssm_layer_ms=time_ms(lambda: _pack_layer(calls), 10),
              ssm_layer_device_ms=device_ms(lambda: _pack_layer(calls), 10),
              ssm_layer_plain_ms=time_ms(lambda: _pack_layer_plain(calls),
                                         2),
              ssm_layer_bound_ms=b_ms, ssm_layer_bound_by=b_by,
              ssm_layer_launches=len(calls))
    del calls
    torch.cuda.empty_cache()
    b1 = {}
    for m in (4, 4 * (SPEC_TOKENS + 1), 32):
        sets = [LayerOperands(cfg, qcfg, m, gen, dev) for _ in range(4)]
        err = check_segment_gemm(B1, sets[:1])
        res = time_segment_gemm(B1, sets)
        b1.update({f"ssm_M{m}_{k}": v for k, v in res.items()},
                  **{f"ssm_M{m}_max_abs_err": err})
        if m == 4:
            draft = [DraftView(ops) for ops in sets]
            b1["ssm_draft_max_abs_err"] = check_segment_gemm(B1, draft[:1])
            b1["ssm_draft_bitwise_k_off_0"] = check_draft_at_offset(
                B1, draft[0].linears)
            res = time_segment_gemm(B1, draft)
            b1.update({f"ssm_draft_{k}": v for k, v in res.items()})
            del draft
        del sets
        torch.cuda.empty_cache()
    return {B7: b7, B1: b1}


def _agreement(want, got):
    """Token agreement of two runs' new tokens for the same requests
    (lists of arrays): tokens equal position by position, and each
    request's leading run of equal tokens."""
    same = total = 0
    lead = []
    for a, b in zip(want, got):
        eq = np.asarray(a) == np.asarray(b)
        same += int(eq.sum())
        total += eq.size
        lead.append(int(eq.size if eq.all() else np.argmin(eq)))
    return dict(equal_tokens=same, tokens=total, leading_equal=lead)


def profile_summary(prof, host_ms):
    """A profiled window beside the host-clock ms of the same work
    unprofiled: kernels, busy ms, idle share (1 - busy / host ms), B1 ms,
    the plain ops split by the op that launched them (the ranges of
    ``step_profile.install_spans``) and the top kernels."""
    kern = [e for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")
            and not e.key.startswith(("ProfilerStep", step_profile.PREFIX))]
    busy = sum(e.device_time_total for e in kern) / 1e3
    b1 = sum(e.device_time_total for e in kern
             if "segment_gemm" in e.key) / 1e3
    by_op = step_profile.op_split(prof.events(),
                                  lambda k: "segment_gemm" in k)
    by_op["unlinked"] = busy - b1 - sum(by_op.values())
    top = sorted(kern, key=lambda e: -e.device_time_total)[:5]
    return {"host_ms": host_ms, "kernels": sum(e.count for e in kern),
            "device_busy_ms": busy, "idle_share": 1 - busy / host_ms,
            "b1_ms": b1,
            "plain_by_op_ms": {k: round(v, 3) for k, v in by_op.items()},
            "top": [(e.key[:60], round(e.device_time_total / 1e3, 3),
                     e.count) for e in top]}


def ssm_profile_steps(eng, spans=step_profile.SSM_SPANS,
                      summary=None):
    """Device view (torch profiler, ``spans``: ``step_profile.SSM_SPANS``
    by default; ``summary(prof, host_ms)``: ``profile_summary`` by
    default) of one
    greedy decode step and of one 8-lane prefill step at batch max_batch on
    a fresh cache, beside the host-clock ms of each unprofiled: kernels,
    busy ms, idle share (1 - busy / host ms), B1 ms and the plain ops
    split by op (``ssd``: the chunked scan; ``mixer``: the mixer's other
    ops; ``serve_linear``: the driver's ops around B1; ``readout``;
    ``rest``)."""
    from torch.profiler import ProfilerActivity, profile
    b, c = eng.ecfg.max_batch, eng.chunk
    tokens = np.arange(1, b * c + 1, dtype=np.int32).reshape(b, c)

    def prefill(cache):
        lm.prefill_step(eng.model, eng.cfg, cache, tokens,
                        np.tile(np.arange(c), (b, 1)), np.full(b, c - 1))

    def decode(cache):
        lm.decode_step(eng.model, eng.cfg, cache, tokens[:, 0],
                       np.full(b, c))

    out = {}
    undo = step_profile.install_spans(spans)
    try:
        for name, fn in (("decode", decode), ("prefill", prefill)):
            cache = fresh_cache(eng)
            fn(cache)
            times = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(cache)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn(cache)
                torch.cuda.synchronize()
            out[name] = (summary or profile_summary)(
                prof, float(np.median(times)))
    finally:
        undo()
    return out


def _decode_logits(eng, cfg, tokens, lens):
    """fp32 logits [N] x [B, V] of token-by-token ``decode_step``s over
    ``tokens`` [B, N] from a fresh state (row i live for its first
    ``lens[i]`` lanes)."""
    b, n = tokens.shape
    cache = fresh_cache(eng)
    ref = []
    for t in range(n):
        lg, cache = lm.decode_step(eng.model, cfg, cache, tokens[:, t],
                                   np.full(b, t), active=t < lens)
        ref.append(lg.float())
    return ref


def _lane_errors(eng, cfg, tokens, lens, width, ref):
    """Relative L2 [B, N] of each lane's fp32 logits from ``verify_step``s
    ``width`` lanes wide over ``tokens`` (from a fresh state) against the
    decode logits ``ref`` (NaN at dead lanes)."""
    b, n = tokens.shape
    cache = fresh_cache(eng)
    err = np.full((b, n), np.nan)
    for t0 in range(0, n, width):
        pos = t0 + np.tile(np.arange(width), (b, 1))
        pos = np.where(pos < lens[:, None], pos, -1)
        chunk = np.zeros((b, width), np.int32)
        take = tokens[:, t0:t0 + width]
        chunk[:, :take.shape[1]] = take
        lg, cache = lm.verify_step(eng.model, cfg, cache, chunk, pos)
        for j in range(min(width, n - t0)):
            want = ref[t0 + j].double()
            got = lg[:, j].double()
            e = ((got - want).norm(dim=-1) / want.norm(dim=-1)).cpu().numpy()
            err[:, t0 + j] = np.where(pos[:, j] >= 0, e, np.nan)
    return err


def ssm_cross_form(eng, done, widths=(8, SPEC_TOKENS + 1)):
    """Phase 18(c)'s must-hold: on the token streams (prompt + new) of the
    first max_batch completions, teacher-forced, the fp32 logits of every
    lane of chunked steps (``verify_step`` as wide as the prefill chunk and
    as the verify) against those of token-by-token decode from the same
    fresh state.

    Held (largest relative L2 over the lanes within ``SSM_CROSS_FORM``;
    a stale or wrong state gives order 1) at fp32 compute with the
    activations unquantized, where the two forms differ only by the
    summation order of the SSD (~1e-6). In the served form (bf16, the
    activations requantized to 1/2/4 bits) one code that a last-bit
    difference flips anywhere in the 64 layers moves every later lane by
    order 1, whatever the state, so there the lanes bitwise equal, the
    largest value and the first lane past the bound are reported, not
    held. Returns the numbers."""
    b = eng.ecfg.max_batch
    streams = [np.concatenate([c.request.prompt, c.new_tokens])
               for c in done[:b]]
    lens = np.array([len(t) for t in streams])
    tokens = np.zeros((b, int(lens.max())), np.int32)
    for i, t in enumerate(streams):
        tokens[i, :len(t)] = t
    smooth = dataclasses.replace(eng.cfg, dtype="float32", quant=(
        dataclasses.replace(eng.cfg.quant, quantize_activations=False)))
    out = {"lanes": int(lens.sum())}
    ref = _decode_logits(eng, smooth, tokens, lens)
    for w in widths:
        err = _lane_errors(eng, smooth, tokens, lens, w, ref)
        worst = float(np.nanmax(err))
        out[f"fp32_unquantized_width_{w}_max_rel_l2"] = worst
        if not worst <= SSM_CROSS_FORM:
            raise AssertionError(f"cross-form logits at width {w}: relative "
                                 f"L2 {worst:.3e} > {SSM_CROSS_FORM}")
    ref = _decode_logits(eng, eng.cfg, tokens, lens)
    err = _lane_errors(eng, eng.cfg, tokens, lens, widths[0], ref)
    live = ~np.isnan(err)
    over = [int(np.argmax(r > SSM_CROSS_FORM)) if (r > SSM_CROSS_FORM).any()
            else -1 for r in np.nan_to_num(err)]
    out[f"served_width_{widths[0]}"] = dict(
        max_rel_l2=float(np.nanmax(err)),
        lanes_bitwise=int((err[live] == 0).sum()),
        first_lane_over_bound=over)
    return out


class SSDTape:
    """Records every ``ssm.ssd_chunked`` call's arguments and outputs in
    call order; with ``feed`` (another tape) each call runs on the fed
    call's arguments instead (teacher forcing, as ``LinearTape``)."""

    def __init__(self, feed=None):
        from repro_torch.models import ssm
        self.ssm, self.real = ssm, ssm.ssd_chunked
        self.args, self.outputs, self.feed = [], [], feed

        def run(*args, **kw):
            if self.feed is not None:
                fed, fed_kw = self.feed.args[len(self.args)]
                dev = args[0].device
                args = tuple(a.to(dev) if isinstance(a, torch.Tensor) else a
                             for a in fed)
                kw = {k: v.to(dev) if isinstance(v, torch.Tensor) else v
                      for k, v in fed_kw.items()}
            # Copies: h0 is the cache's state, which the step then
            # overwrites in place.
            self.args.append((
                tuple(a.clone() if isinstance(a, torch.Tensor) else a
                      for a in args),
                {k: v.clone() if isinstance(v, torch.Tensor) else v
                 for k, v in kw.items()}))
            out = self.real(*args, **kw)
            self.outputs.append(out)
            return out

        ssm.ssd_chunked = run

    def close(self):
        self.ssm.ssd_chunked = self.real


def check_ssm_against_cpu(dev, ecfg):
    """Phase 18(d): the card against the plain versions on the CPU, fp32.
    (1) Reduced mamba2-2.7b end to end: the greedy tokens of 4 requests
    identical, and the logits of a prefill chunk and a decode step within
    relative L2 1e-5. (2) Full width cut to 2 layers, a prefill chunk and
    a decode step teacher-forced (``LinearTape``, ``SSDTape``): every serve
    linear's output on the CPU's input and its input as the card's own ops
    made it, the chunked SSD's output and final state on the CPU's
    arguments, and the logits, each within relative L2 1e-5. Returns the
    numbers."""
    out = {}
    small = get_config(SSM_ARCH).reduced().with_quant_mode("qat")
    eng = engine.DecodeEngine(lm.init_params(small, seed=SEED + 9,
                                             device=dev), small, ecfg,
                              device=dev)
    host = engine.DecodeEngine(copy.deepcopy(eng.model).to("cpu"), small,
                               ecfg, already_serve=True, device="cpu")
    reqs = requests(small.vocab_size, np.random.default_rng(SEED + 9), n=4,
                    lo=8, hi=16, new=8)
    card_out, _ = serve_all(eng, reqs)
    cpu_out = {c.request_id: c for c in host.serve(
        [dataclasses.replace(r) for r in reqs])}
    base = min(cpu_out)
    for i, c in enumerate(card_out):
        if not np.array_equal(c.tokens, cpu_out[base + i].tokens):
            raise AssertionError(f"reduced SSM card != CPU tokens (request "
                                 f"{i}): {c.new_tokens} vs "
                                 f"{cpu_out[base + i].new_tokens}")
    card = _prefill_then_decode(eng.model, eng.cfg, dev)
    cpu = _prefill_then_decode(host.model, host.cfg, "cpu")
    out["reduced_tokens_identical"] = len(reqs)
    out["reduced_logits_rel_l2"] = max(rel_l2(a, b)
                                       for a, b in zip(card, cpu))
    del eng, host
    wide = dataclasses.replace(get_config(SSM_ARCH), num_layers=2,
                               dtype="float32").with_quant_mode("qat")
    eng = engine.DecodeEngine(lm.init_params(wide, seed=SEED + 9,
                                             device=dev), wide, ecfg,
                              device=dev)
    host = copy.deepcopy(eng.model).to("cpu")
    tape_cpu, ssd_cpu = LinearTape(host), SSDTape()
    try:
        logits_cpu = _prefill_then_decode(host, eng.cfg, "cpu")
    finally:
        tape_cpu.close()
        ssd_cpu.close()
    tape_card, ssd_card = LinearTape(eng.model, feed=tape_cpu.inputs), \
        SSDTape(feed=ssd_cpu)
    try:
        logits_card = _prefill_then_decode(eng.model, eng.cfg, dev)
    finally:
        tape_card.close()
        ssd_card.close()
    calls = len(tape_cpu.inputs)
    if len(tape_card.inputs) != calls or calls != SSM_LINEARS * 2 * 2 \
            or len(ssd_card.outputs) != 2 or len(ssd_cpu.outputs) != 2:
        raise AssertionError(f"calls: card {len(tape_card.inputs)}, CPU "
                             f"{calls}; SSD {len(ssd_card.outputs)}, "
                             f"{len(ssd_cpu.outputs)}")
    worst = {}
    for (name, _lin, x_card), (_n, _l, x_cpu), y_card, y_cpu in zip(
            tape_card.inputs, tape_cpu.inputs, tape_card.outputs,
            tape_cpu.outputs):
        kind = name.rsplit(".", 1)[-1]
        for what, a, b in (("out", y_card, y_cpu), ("in", x_card, x_cpu)):
            key = f"{kind}.{what}"
            worst[key] = max(worst.get(key, 0.0), rel_l2(a, b))
    for (y_c, h_c), (y_h, h_h) in zip(ssd_card.outputs, ssd_cpu.outputs):
        worst["ssd.y"] = max(worst.get("ssd.y", 0.0), rel_l2(y_c, y_h))
        worst["ssd.h"] = max(worst.get("ssd.h", 0.0), rel_l2(h_c, h_h))
    worst["logits"] = max(rel_l2(a, b) for a, b in zip(logits_card,
                                                       logits_cpu))
    out["full_width_2_layers"] = worst
    out["full_width_linear_calls"] = calls
    bad = {k: v for k, v in worst.items() if not v <= 1e-5}
    if not out["reduced_logits_rel_l2"] <= 1e-5 or bad:
        raise AssertionError(f"SSM card vs CPU over 1e-5: {bad}; {out}")
    del eng, host
    torch.cuda.empty_cache()
    return out


def ssm_spec_serve(model, cfg, ecfg, reqs, want, dev):
    """Speculative decoding (k = SPEC_TOKENS, draft bits DRAFT_BITS) of the
    SSM on ``reqs``: the snapshot/recommit round drafts k steps, verifies
    k + 1 lanes and re-feeds the accepted ones, five forwards a drafting
    round (one B1 launch a linear each: asserted). Tokens need not equal
    spec-off at bf16 (the verify lanes are a chunked sum); their agreement
    with ``want`` is reported. Returns ``spec_stats``, round ms, tokens/s,
    the launches of a round and the agreement."""
    eng = engine.DecodeEngine(model, cfg, dataclasses.replace(
        ecfg, spec_tokens=SPEC_TOKENS, spec_draft_bits=DRAFT_BITS),
        already_serve=True, device=dev)
    drafts = backend.draft_matmul_call_count()
    round_counts = {}
    out, wall, round_ms = timed_serve(eng, reqs, round_counts)
    st = eng.spec_stats()
    if st["rounds"] == 0 or backend.draft_matmul_call_count() == drafts:
        raise AssertionError(f"no draft ran: {st}")
    per_round = (SPEC_TOKENS + 2) * SSM_LINEARS * cfg.num_layers
    if round_counts.get(B1) != per_round:
        raise AssertionError(f"{round_counts.get(B1)} {B1} launches a "
                             f"drafting round, not {per_round}")
    _same_tokens("jamba spec tokens != spec-off tokens", want, out)
    new = sum(c.new_tokens.size for c in out)
    return dict(spec=st, tok_s=new / wall, wall_s=wall, round_ms=round_ms,
                round_launches=round_counts)


def phase_ssm_serve(dev, rng, gen, results, launches, per_step):
    """Phase 18: serve the SSM family at the full width of mamba2-2.7b
    (d_model 2560, 80 SSD heads of 64, state 128, ssm_chunk 256), cut to
    SSM_SERVE_LAYERS of its 64 layers so the script stays inside its
    time limit. (a) B7 and B1 at its linears' shapes
    (``phase_ssm_kernels``, into ``results``). (b) DecodeEngine from
    random QAT weights of the seed (default mix, max_batch 4, prefill
    chunk 8, greedy; 8 requests of 16-64 prompt tokens and 16 new): one
    B7 launch a linear at load and one B1 a linear a decode step
    (asserted), the load's
    pack_s and device busy, a second run bitwise the first, decode-step
    host ms, a device profile of a decode step and an 8-lane prefill step,
    the resident SSM state bytes. (c) The first 4 requests at prefill
    chunk 1, through the LockstepEngine (prompts cut to 16 tokens, one
    batch) and speculatively (k = 3, draft bits 2; 5 B1 launches a linear
    a drafting round): token agreement with the chunk-8 run;
    the teacher-forced cross-form logits within 1e-2 relative L2
    (``ssm_cross_form``). (d) Card vs CPU (``check_ssm_against_cpu``).
    Returns the numbers."""
    cfg = dataclasses.replace(get_config(SSM_ARCH),
                              num_layers=SSM_SERVE_LAYERS).with_quant_mode(
                                  "qat")
    qcfg = QuantConfig(mode="qat")
    laps, t_lap = {}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        laps[name] = round(now - t_lap[0], 2)
        t_lap[0] = now

    for name, rec in phase_ssm_kernels(cfg, qcfg, gen, dev).items():
        results[name].update(rec)
    log(f"[18] {B7} and {B1} at the {SSM_ARCH} linears "
        f"({layer_linears(cfg)}): B7 bitwise, B1 within the fp32 bound, "
        f"drafts bitwise at k_off 0: "
        f"{ {k: v for k, v in results[B7].items() if k.startswith('ssm')} }"
        f"; {B1}: "
        f"{ {k: v for k, v in results[B1].items() if k.startswith('ssm')} }")
    lap("kernels")
    st = {"layers": cfg.num_layers}
    ecfg = engine.EngineConfig(max_batch=4, cache_len=256, prefill_chunk=8)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = lm.init_params(cfg, seed=SEED + 9, device=dev)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    eng = engine.DecodeEngine(params, cfg, ecfg)
    torch.cuda.synchronize()
    st["pack_s"] = time.perf_counter() - t0
    launches["b7_ssm_load"] = kernels.launch_counts()[B7]
    want = SSM_LINEARS * cfg.num_layers
    if launches["b7_ssm_load"] != want or packed_leaves(eng.model) != want:
        raise AssertionError(f"{launches['b7_ssm_load']} B7 launches at the "
                             f"SSM load, not one a linear ({want})")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    eng, prof = profile_load(lambda: engine.DecodeEngine(params, cfg, ecfg))
    del params
    torch.cuda.empty_cache()
    st["load"] = dict(device_busy_ms=prof["device_busy_ms"],
                      device_events=prof["device_events"],
                      idle_share=1 - prof["device_busy_ms"]
                      / (st["pack_s"] * 1e3), by_op=prof["by_op"])
    st["peak_gib_init_and_pack"] = torch.cuda.max_memory_allocated() / 2 ** 30
    st["packed_bytes"] = engine.packed_model_bytes(eng.model)
    log(f"[18] {SSM_ARCH} load: pack_s {st['pack_s']:.3f}, "
        f"{launches['b7_ssm_load']} B7 launches; {st['load']}")
    lap("load")
    reqs = requests(cfg.vocab_size, rng)
    kernels.reset_launch_counts()
    first, wall1 = serve_all(eng, reqs)
    counts = kernels.launch_counts()
    launches["b1_ssm_serve"] = counts[B1]
    if counts[B1] == 0 or counts[B2] or counts[B3] or counts[B8]:
        raise AssertionError(f"SSM serve launches {counts}")
    for c in first:
        if c.new_tokens.size != 16 or not (
                (c.new_tokens >= 0) & (c.new_tokens < cfg.vocab_size)).all():
            raise AssertionError(f"bad SSM completion {c.new_tokens}")
    second, wall2 = serve_all(eng, reqs)
    for a, b in zip(first, second):
        if not np.array_equal(a.tokens, b.tokens):
            raise AssertionError("SSM: a second identical run gave other "
                                 "tokens")
    new = sum(c.new_tokens.size for c in second)
    st.update(tok_s=new / wall2, wall_s=[wall1, wall2],
              steps=eng.sched.step_count,
              state_bytes=lm.seq_state_bytes(eng.cache),
              decode_step_ms=decode_step_ms(eng))
    per_step["b1_ssm"] = step_launches(eng)[B1]
    if per_step["b1_ssm"] != want:
        raise AssertionError(f"{per_step['b1_ssm']} {B1} launches an SSM "
                             f"decode step, not {want}")
    log(f"[18] served {len(reqs)} requests ({new} new tokens, a second run "
        f"bitwise) in {st['steps']} steps: {st['tok_s']:.2f} tok/s; decode "
        f"step {st['decode_step_ms']:.2f} ms; {per_step['b1_ssm']} B1 a "
        f"step; state {st['state_bytes']:,} bytes; tokens[0] "
        f"{second[0].new_tokens[:8]}")
    lap("serve")
    st["profile"] = ssm_profile_steps(eng)
    log(f"[18] step profiles: {st['profile']}")
    lap("profiles")
    # (c) Other forms of the same requests.
    one = engine.DecodeEngine(eng.model, cfg, dataclasses.replace(
        ecfg, prefill_chunk=1), already_serve=True, device=dev)
    out1, wall = serve_all(one, reqs[:4])
    st["chunk1"] = dict(
        tok_s=sum(c.new_tokens.size for c in out1) / wall,
        agreement=_agreement([c.new_tokens for c in second[:4]],
                             [c.new_tokens for c in out1]))
    del one
    lap("chunk1")
    cut = [dataclasses.replace(r, prompt=r.prompt[:16]) for r in reqs[:4]]
    cut_out, _ = serve_all(eng, cut)
    lock = engine.LockstepEngine(eng.model, cfg, ecfg, already_serve=True,
                                 device=dev)
    t0 = time.perf_counter()
    grid = lock.generate(np.stack([r.prompt for r in cut]), 16)
    wall = time.perf_counter() - t0
    st["lockstep"] = dict(tok_s=grid[:, 16:].size / wall,
                          agreement=_agreement(
                              [c.new_tokens for c in cut_out], grid[:, 16:]))
    del lock
    lap("lockstep")
    st["spec"] = ssm_spec_serve(eng.model, cfg, ecfg, reqs[:4], second[:4],
                                dev)
    per_step["b1_ssm_spec_round"] = st["spec"]["round_launches"][B1]
    lap("spec")
    st["cross_form"] = ssm_cross_form(eng, second)
    log(f"[18] chunk 1: {st['chunk1']}; lockstep: {st['lockstep']}; spec: "
        f"{st['spec']}")
    log(f"[18] cross-form logits (teacher-forced; held at fp32 with the "
        f"activations unquantized): {st['cross_form']}")
    lap("cross_form")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    st["card_vs_cpu"] = check_ssm_against_cpu(dev, ecfg)
    log(f"[18] card vs CPU (fp32, relative L2): {st['card_vs_cpu']}")
    lap("card_vs_cpu")
    st["seconds"] = laps
    log(f"[18] seconds by part: {laps}")
    return st


# ---------------------------------------------------------- SSM training ----
# Phase 19(b)'s depth (mamba2-2.7b has 64; 8 before PR 32, cut for phase
# 24's time).
SSM_TRAIN_LAYERS = 4
SSM_CPU_TOKENS = 128         # phase 19(c)'s tokens a layer (1 x 128)


def param_digest(model) -> float:
    """A float64 sum of every parameter, weighted by its position in the
    model (a printable fingerprint; equality is checked tensor by
    tensor)."""
    total = 0.0
    for i, p in enumerate(model.parameters()):
        total += (i + 1) * p.detach().double().sum().item()
    return total


def _block_grads(block, x, g, cfg, noise, feed=None, positions=None,
                 cross_x=None):
    """One block's forward and backward on x's device (a ``dec`` block
    attends ``cross_x``), its linears' inputs fed from ``feed`` (a
    LinearTape's inputs) when given: (y, dx, {parameter name: gradient,
    and ``cross_x``'s gradient under that name}, the LinearTape)."""
    from repro_torch.models import blocks as blocks_lib
    tape = LinearTape(block, feed)
    try:
        inputs = (x.clone().requires_grad_(True),)
        if cross_x is not None:
            inputs += (cross_x.clone().requires_grad_(True),)
        y, _ = blocks_lib.block_apply(
            block, inputs[0], positions, cfg, cfg.quant, noise,
            cross_x=None if cross_x is None else inputs[1])
        names, params = zip(*block.named_parameters())
        grads = torch.autograd.grad(y, inputs + params, g)
    finally:
        tape.close()
    out = dict(zip(names, grads[len(inputs):]))
    if cross_x is not None:
        out["cross_x"] = grads[1]
    return y.detach(), grads[0], out, tape


def check_ssm_training_against_cpu(dev):
    """Phase 19(c): full-width mamba2-2.7b cut to 2 layers, fp32, at NOISE
    (logits over the 4/2/1-bit bands, the same host-made draws) and QAT
    (the default mix): each block on the card and on the CPU from the same
    weights, input and cotangent, teacher-forced: layer 1 takes the card's
    layer-0 output on both, and each linear on the card runs on the CPU's
    input to it (``LinearTape``; a 1/2/4-bit activation code that the
    upstream ops' rounding flips would otherwise move the block by order
    1e-2). Every linear's output and its input as the card's own ops made
    it, the block's y, dx and every leaf's gradient (the two linears' w
    and s, conv_w, conv_b, A_log, D, dt_bias, norm_g, the block norm's g)
    within relative L2 1e-5. Returns the worst of each."""
    worst = {}
    wide = dataclasses.replace(get_config(SSM_ARCH), num_layers=2,
                               dtype="float32")
    for mode in ("noise", "qat"):
        cfg = wide.with_quant_mode(mode)
        host = lm.init_params(cfg, seed=SEED + 19, device="cpu")
        if mode == "noise":
            set_mixed_logits(host, SEED + 19)
        card = copy.deepcopy(host).to(dev)
        host.requires_grad_(True)
        card.requires_grad_(True)
        noise = HostNoise((SEED, 19)) if mode == "noise" else None
        gen = torch.Generator().manual_seed(SEED + 19)
        x = torch.randn((1, SSM_CPU_TOKENS, cfg.d_model), generator=gen)
        for i in range(cfg.num_layers):
            g = torch.randn(x.shape, generator=gen)
            yh, dxh, gh, th = _block_grads(host.blocks[i], x, g, cfg, noise)
            yc, dxc, gc_, tc = _block_grads(card.blocks[i], x.to(dev),
                                            g.to(dev), cfg, noise,
                                            feed=th.inputs)
            pairs = [("y", yc, yh), ("dx", dxc, dxh)] + [
                (n, gc_[n], gh[n]) for n in gh]
            for (name, _m, xc), (_n, _mh, xh), oc, oh in zip(
                    tc.inputs, th.inputs, tc.outputs, th.outputs):
                kind = name.rsplit(".", 1)[-1]
                pairs += [(f"{kind}.in", xc, xh), (f"{kind}.out", oc, oh)]
            for what, a, b in pairs:
                key = f"{mode}.{what}"
                worst[key] = max(worst.get(key, 0.0), rel_l2(a, b))
            x = yc.cpu()
        del host, card
        torch.cuda.empty_cache()
    bad = {k: v for k, v in worst.items() if not v <= 1e-5}
    if bad:
        raise AssertionError(f"SSM training card vs CPU over 1e-5: {bad}")
    return worst


def _ssm_training_summary(records, profiles, rep, model):
    """Phase 19(b)'s record; the report must walk the mixer's linears as
    the reference does, every layer's in_proj (K = 2560 channels: 160
    groups) before every layer's out_proj (5120: 320 groups)."""
    channels = [sum(layer["hist"]) for layer in rep["layers"]]
    n = len(channels) // SSM_LINEARS
    cfg = get_config(SSM_ARCH)
    if channels != [cfg.d_model] * n + [cfg.d_inner] * n:
        raise AssertionError(f"freeze order or widths: {channels}")
    return {"steps": records, "profiles": profiles,
            "histogram": precision_histogram(model),
            "average_bpp": schedule.average_bpp(rep),
            "allowed_patterns": rep["allowed"], "linears": len(rep["layers"])}


def phase_ssm_training(dev, gen, results, rng):
    """Phase 19: train the SSM family at the full width of mamba2-2.7b.
    (a) B9, B8 and both backward kernels against their plain versions at
    one layer's training linears (in_proj 2560 x 10576, N not a multiple
    of 64; out_proj 5120 x 2560; B8's activations [8 * 128, K] bf16):
    forward, dw and dx bitwise, ds within ``noise_inject.ds_bound``, one
    layer's calls timed on both rulers (``phase_training_kernels``, into
    ``results`` as ``ssm_train_*``). (b) SSM_TRAIN_LAYERS
    layers, the logits over the 4/2/1-bit bands, 3 Phase-I steps, the
    freeze and 3 Phase-II steps on TokenStream(batch 8, seq 128, seed 0)
    (``phase_training``: each step's launches asserted, 4L B9 and 2L B9
    backward a Phase-I step, 8L B8 and 4L B8 backward a Phase-II step;
    peak memory; a device profile of steps 2 and 5 with the chunked SSD
    apart, ``step_profile.ssm_train_summary``), then a second run bitwise
    the first (losses, gradient norms, every parameter); the trained
    model through ``soniq.to_serve`` (2L B7 launches, asserted) and a
    DecodeEngine run of 4 requests (2L B1 a decode step, asserted).
    (c) ``check_ssm_training_against_cpu``. (d) Full depth (64 layers):
    one Phase-I step, the freeze and one Phase-II step, each step's
    launches asserted and its peak memory under the card's. Returns the
    numbers."""
    from repro_torch import soniq
    from repro_torch.api.state import SoniqState
    from repro_torch.core.phases import Phase
    out, laps, t_lap = {}, {}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        laps[name] = round(now - t_lap[0], 2)
        t_lap[0] = now

    full = get_config(SSM_ARCH)
    for name, rec in phase_training_kernels(full, gen, dev).items():
        results[name].update({f"ssm_train_{k}": v for k, v in rec.items()})
    log(f"[19] {B9}, {B8} and both backward kernels at the {SSM_ARCH} "
        f"training linears ({layer_linears(full)}): forward, dw and dx "
        f"bitwise, ds within its bound: "
        f"{ {n: results[n] for n in (B9, B8, B9_BWD, B8_BWD)} }")
    torch.cuda.empty_cache()
    lap("kernels")

    cfg = dataclasses.replace(full, num_layers=SSM_TRAIN_LAYERS)
    runs = []
    for profiled in (True, False):
        state, records, profiles, rep = phase_training(
            cfg, dev, tag=19, spans=step_profile.SSM_TRAIN_SPANS,
            summary=step_profile.ssm_train_summary, profiled=profiled,
            mixed_seed=SEED + 19)
        state["opt"] = None
        runs.append((state["model"], records, profiles, rep))
        del state
        gc.collect()
        torch.cuda.empty_cache()
        if profiled:
            lap("train_16")
    (model, records, profiles, rep), (again, rec2, _p, rep2) = runs
    del runs
    same = [(r["loss"], r["grad_norm"]) for r in records] == \
        [(r["loss"], r["grad_norm"]) for r in rec2]
    params_same = all(torch.equal(a, b) for a, b in zip(
        model.parameters(), again.parameters()))
    if not (same and params_same and rep["layers"] == rep2["layers"]):
        raise AssertionError(f"a second SSM training run differs: losses "
                             f"equal {same}, parameters equal "
                             f"{params_same}")
    digest = param_digest(model)
    del again
    gc.collect()
    torch.cuda.empty_cache()
    lap("train_16_again")
    st = _ssm_training_summary(records, profiles, rep, model)
    st.update(layers=cfg.num_layers, second_run_bitwise=True,
              param_digest=digest,
              second_run_ms=[r["ms"] for r in rec2],
              launches_per_step={p: train_step_launches(cfg, p)
                                 for p in (1, 2)})
    log(f"[19] {cfg.num_layers} layers: a second run bitwise the first "
        f"(losses, gradient norms, parameters; digest {digest!r}); frozen "
        f"groups by precision {st['histogram']}, average bpp "
        f"{st['average_bpp']:.4f} over {st['linears']} linears")
    for name, key in ((B8, "b8"), (B9, "b9"), (B8_BWD, "b8_bwd"),
                      (B9_BWD, "b9_bwd")):
        results[name]["ssm_train_run_launches"] = sum(r[key]
                                                      for r in records)
        results[name]["ssm_train_launches_per_step"] = max(
            r[key] for r in records)
    qcfg = cfg.with_quant_mode("qat")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    served = soniq.to_serve(SoniqState(Phase.QAT, model, qcfg))
    torch.cuda.synchronize()
    st["to_serve_s"] = time.perf_counter() - t0
    st["to_serve_b7"] = kernels.launch_counts()[B7]
    if st["to_serve_b7"] != SSM_LINEARS * cfg.num_layers:
        raise AssertionError(f"{st['to_serve_b7']} B7 launches at to_serve,"
                             f" not one a linear")
    ecfg = engine.EngineConfig(max_batch=4, cache_len=256, prefill_chunk=8)
    eng = engine.DecodeEngine(served.model, qcfg, ecfg, already_serve=True,
                              device=dev)
    prompts = rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
    kernels.reset_launch_counts()
    tokens = eng.generate(prompts, 8)
    st["serve_b1"] = kernels.launch_counts()[B1]
    st["b1_per_decode_step"] = step_launches(eng)[B1]
    if st["b1_per_decode_step"] != SSM_LINEARS * cfg.num_layers \
            or not ((tokens >= 0) & (tokens < cfg.vocab_size)).all():
        raise AssertionError(f"trained SSM serve: {st['b1_per_decode_step']}"
                             f" B1 a decode step, tokens {tokens}")
    st["served_tokens"] = tokens[:, 16:].tolist()
    log(f"[19] to_serve: {st['to_serve_b7']} B7 launches in "
        f"{st['to_serve_s']:.3f} s; served 4 requests ({st['serve_b1']} B1 "
        f"launches, {st['b1_per_decode_step']} a decode step): tokens "
        f"{st['served_tokens']}")
    out["train_16"] = st
    del eng, served, model
    gc.collect()
    torch.cuda.empty_cache()
    lap("serve")

    out["card_vs_cpu"] = check_ssm_training_against_cpu(dev)
    log(f"[19] two full-width layers, card vs CPU (fp32, relative L2; y, "
        f"dx, every leaf's gradient): {out['card_vs_cpu']}")
    lap("card_vs_cpu")

    gc.collect()
    torch.cuda.empty_cache()
    state, records, _prof, rep = phase_training(
        full, dev, tag=19, profiled=False, t1=1, t2=2)
    card_bytes = torch.cuda.get_device_properties(dev).total_memory
    n_params = sum(p.numel() for p in state["model"].parameters())
    del state
    gc.collect()
    torch.cuda.empty_cache()
    peaks = {r["phase"]: r["peak_gib"] for r in records}
    if max(peaks.values()) * 2 ** 30 >= card_bytes:
        raise AssertionError(f"full-depth peaks {peaks} GiB")
    out["full_depth"] = dict(layers=full.num_layers, steps=records,
                             peak_gib_by_phase=peaks,
                             card_gib=card_bytes / 2 ** 30,
                             qat_parameters=n_params,
                             average_bpp=schedule.average_bpp(rep))
    log(f"[19] full depth ({full.num_layers} layers, {n_params:,} "
        f"parameters after the freeze): peak GiB by phase {peaks} of "
        f"{card_bytes / 2 ** 30:.1f}")
    lap("full_depth")
    out["seconds"] = laps
    return out


# ----------------------------------------------------- whisper serving ----
WHISPER_ARCH = "whisper-medium"
WHISPER_BATCH = 4
WHISPER_FRAMES = 1500        # the reference's default enc_len: 30 s of audio
WHISPER_ENC_LINEARS = 6      # q, k, v, o, up, down
WHISPER_DEC_LINEARS = 10     # self q, k, v, o; cross q, k, v, o; up, down
# The linears a decode step runs a decoder layer: self q, k, v, o, cross q
# and o, up, down (the cross wk/wv run once a batch, in load_cross).
WHISPER_STEP_LINEARS = 8
# Phase 20's depth, encoder and decoder (whisper-medium has 24 + 24; 12
# before PR 32, cut for phase 24's time).
WHISPER_SERVE_LAYERS = 6


class CrossOperands(RingOperands):
    """B4 operands of cross attention over an encoder's K/V: the ring of
    ``RingOperands`` at T entries with every stored key position 0 and
    every query at ``attention.CROSS_QUERY_POS``, as the decoder calls B4
    on its packed 4-bit cross K/V: every entry attended."""

    def __init__(self, cfg, s, t, gen, dev, b=WHISPER_BATCH):
        from repro_torch.models.attention import CROSS_QUERY_POS
        super().__init__(cfg, s, t, None, gen, dev, b=b)
        self.kv_pos = torch.zeros_like(self.kv_pos)
        self.q_pos = torch.full_like(self.q_pos, CROSS_QUERY_POS)


def check_cross_lanes(ops):
    """Each lane of a multi-lane cross call bitwise the S = 1 call on its
    query (all lanes share every key). Returns the lanes compared."""
    full = ad.qkv_attn_decode(*ops.args())
    args = list(ops.args())
    s = ops.q.shape[1]
    for j in range(s):
        args[0] = ops.q[:, j:j + 1].contiguous()
        args[-1] = ops.q_pos[:, j:j + 1].contiguous()
        lane = ad.qkv_attn_decode(*args)
        torch.cuda.synchronize()
        if not torch.equal(lane[:, 0], full[:, j]):
            raise AssertionError(f"cross lane {j} of {s} differs from the "
                                 f"S=1 call")
    return s


def phase_whisper_kernels(cfg, qcfg, gen, dev, results):
    """Phase 20(a), into ``results`` (``whisper_*`` keys): B1 at the
    encoder's six linears at M = 4 x 1500 (q/k/v/o 1024 x 1024, fc1 1024 x
    4096, fc2 4096 x 1024; 1500 row tiles over each column tile) and at
    the decoder's M = 4 (decode), 16 (verify of k = 3) and 32 (an 8-lane
    prefill), within the fp32 reordering bound, timed on both rulers
    beside torch.matmul on the dequantized operands; B7 on one decoder
    layer's ten linears, bitwise; B4 on the cross K/V (T = 1500, Hk = 16,
    G = 1, D = 64, key positions 0, queries at 2^30) at S = 1, 4 and 8
    within its bound, the lanes bitwise the S = 1 calls, timed at S = 1
    beside SDPA; B4 and B5 on the self ring (T = 256) and pool (16 pages
    of 16) at this geometry, S = 1 and 8, timed at S = 1."""
    m_enc = WHISPER_BATCH * WHISPER_FRAMES
    for m, reps, nsets in ((m_enc, 3, 2), (4, 20, 4),
                           (4 * (SPEC_TOKENS + 1), 20, 4), (32, 20, 4)):
        sets = [LayerOperands(cfg, qcfg, m, gen, dev) for _ in range(nsets)]
        err = check_segment_gemm(B1, sets[:1])
        res = time_segment_gemm(B1, sets, reps=reps)
        results[B1].update({f"whisper_M{m}_{k}": v for k, v in res.items()},
                           **{f"whisper_M{m}_max_abs_err": err})
        log(f"[20] {B1} at M={m} on one {WHISPER_ARCH} layer's "
            f"{len(sets[0].linears)} linears: max |err| {err:.3e} within "
            f"the fp32 bound; {res}")
        del sets
        torch.cuda.empty_cache()
    d, f = cfg.d_model, cfg.d_ff
    shapes = [(d, d)] * 8 + [(d, f), (f, d)]
    calls = [pack_operands(shape, qcfg, gen, dev) for shape in shapes]
    _check_pack(calls)
    b_ms, b_by = _pack_bound(calls)
    results[B7].update(
        whisper_layer_ms=time_ms(lambda: _pack_layer(calls), 10),
        whisper_layer_device_ms=device_ms(lambda: _pack_layer(calls), 10),
        whisper_layer_plain_ms=time_ms(lambda: _pack_layer_plain(calls), 2),
        whisper_layer_bound_ms=b_ms, whisper_layer_bound_by=b_by,
        whisper_layer_launches=len(calls))
    del calls
    lanes = 0
    for s in (1, SPEC_TOKENS + 1, 8):
        ops = CrossOperands(cfg, s, WHISPER_FRAMES, gen, dev)
        err = check_attention(B4, ops)
        results[B4]["whisper_cross_max_abs_err"] = max(
            err, results[B4].get("whisper_cross_max_abs_err", 0.0))
        if s > 1:
            lanes += check_cross_lanes(ops)
        else:
            res = time_attention(B4, ops)
            results[B4].update({f"whisper_cross_{k}": v
                                for k, v in res.items()})
        del ops
    results[B4]["whisper_cross_lanes_bitwise"] = lanes
    for name in (B4, B5):
        for s in (1, 8):
            ops = RingOperands(cfg, s, 256, None, gen, dev) if name == B4 \
                else PagedOperands(cfg, s, 16, None, gen, dev)
            err = check_attention(name, ops)
            results[name]["whisper_self_max_abs_err"] = max(
                err, results[name].get("whisper_self_max_abs_err", 0.0))
            if s == 1:
                res = time_attention(name, ops)
                results[name].update({f"whisper_self_{k}": v
                                      for k, v in res.items()})
            del ops
    torch.cuda.empty_cache()
    log(f"[20] {B7} on one decoder layer (10 launches) bitwise; {B4} cross "
        f"(T={WHISPER_FRAMES}, G=1, D=64) within the bound, {lanes} lanes "
        f"bitwise the S=1 calls; self ring and pool within the bound: "
        f"{B7}: { {k: v for k, v in results[B7].items() if 'whisper' in k} }"
        f"; {B4}: "
        f"{ {k: v for k, v in results[B4].items() if 'whisper' in k} }; "
        f"{B5}: "
        f"{ {k: v for k, v in results[B5].items() if 'whisper' in k} }")


def whisper_frames(cfg, seed, batch=WHISPER_BATCH, frames=None):
    """Random mel frames [batch, frames (default ``WHISPER_FRAMES``),
    frontend_dim] fp32 from ``seed`` (the stub frontend's input)."""
    return np.random.default_rng(seed).standard_normal(
        (batch, frames or WHISPER_FRAMES, cfg.frontend_dim)).astype(
            np.float32)


def with_frames(batches, cfg, seed=SEED):
    """Training batches with mel frames [B, WHISPER_FRAMES, frontend_dim]
    fp32, one draw a batch from ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    for b in batches:
        yield dict(b, frames=rng.standard_normal(
            (len(b["tokens"]), WHISPER_FRAMES, cfg.frontend_dim)).astype(
                np.float32))


def profile_encode(eng, frames):
    """One encode pass at the engine's config: host-clock ms (median of
    3, each ending in a synchronize) and a device profile split by op
    (``step_profile.WHISPER_SPANS``): B1 ms, the float64 attention, the
    LayerNorms, the GELU, the serve linears' driver ops, the rest."""
    from torch.profiler import ProfilerActivity, profile
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lm.encode(eng.model, eng.cfg, frames)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    undo = step_profile.install_spans(step_profile.WHISPER_SPANS)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            lm.encode(eng.model, eng.cfg, frames)
            torch.cuda.synchronize()
    finally:
        undo()
    return dict(profile_summary(prof, float(np.median(times))),
                host_ms_runs=times)


def _same_tokens(what, want, got):
    for a, b in zip(want, got):
        if not np.array_equal(a.tokens, b.tokens):
            raise AssertionError(f"{what} (request {a.request_id}): "
                                 f"{a.new_tokens} vs {b.new_tokens}")


def _whisper_pass(model, cfg, dev, frames):
    """The encoder on ``frames``, every decoder layer's fp cross K/V of its
    output, then a 2 x 8 prefill chunk and one decode step: [encoder
    output, prefill logits, decode logits] in float64 on the host."""
    rng = np.random.default_rng(3)
    b, t = frames.shape[:2]
    tokens = rng.integers(0, cfg.vocab_size, (b, 9)).astype(np.int32)
    enc = lm.encode(model, cfg, frames)
    cache = lm.init_cache(cfg, b, 64, torch.float32, device=dev, enc_len=t)
    cache["cross"] = lm.build_cross_cache(model, cfg, enc)
    a, cache = lm.prefill_step(model, cfg, cache, tokens[:, :8],
                               np.tile(np.arange(8), (b, 1)), np.full(b, 7))
    c, _ = lm.decode_step(model, cfg, cache, tokens[:, 8], np.full(b, 8))
    return [enc.double().cpu(), a.double().cpu(), c.double().cpu()]


def check_whisper_against_cpu(dev, ecfg):
    """Phase 20(f) and (g): the card against the plain versions on the
    CPU, fp32. (1) Reduced whisper-medium end to end: the encoder output
    of 4 x 12 frames within relative L2 1e-5 and the greedy tokens of 4
    requests served after ``load_cross`` of it identical. (2) Full width,
    one encoder and one decoder layer, 2 x 64 frames, teacher-forced
    (``LinearTape``): the frontend, the encoder layer's six linears, the
    cross K/V of the decoder layer and its eight linears a step (self,
    cross, MLP) on a prefill chunk and a decode step, each output on the
    CPU's input and each input as the card's own ops made it (norms,
    sinusoids, attention, GELU, residual adds), and the encoder output
    and logits, within relative L2 1e-5. (3) ``soniq.apply(...,
    frames=...)`` of the reduced config at SERVE (per-token activation
    scales, as the engine's): logits within relative L2 1e-5. Returns
    the numbers."""
    from repro_torch import soniq
    out = {}
    small = get_config(WHISPER_ARCH).reduced().with_quant_mode("qat")
    frames = whisper_frames(small, SEED + 10, frames=12)
    eng = engine.DecodeEngine(lm.init_params(small, seed=SEED + 10,
                                             device=dev), small, ecfg,
                              device=dev)
    host = engine.DecodeEngine(copy.deepcopy(eng.model).to("cpu"), small,
                               ecfg, already_serve=True, device="cpu")
    enc_card = lm.encode(eng.model, eng.cfg, frames)
    enc_cpu = lm.encode(host.model, host.cfg, frames)
    out["reduced_encode_rel_l2"] = rel_l2(enc_card, enc_cpu)
    reqs = requests(small.vocab_size, np.random.default_rng(SEED + 10), n=4,
                    lo=8, hi=16, new=8)
    card_out, _ = serve_all(eng, reqs, enc_card)
    cpu_out, _ = serve_all(host, reqs, enc_cpu)
    _same_tokens("reduced whisper card != CPU tokens", card_out, cpu_out)
    out["reduced_tokens_identical"] = len(reqs)
    del eng, host
    wide = dataclasses.replace(get_config(WHISPER_ARCH), num_layers=1,
                               encoder_layers=1,
                               dtype="float32").with_quant_mode("qat")
    eng = engine.DecodeEngine(lm.init_params(wide, seed=SEED + 10,
                                             device=dev), wide, ecfg,
                              device=dev)
    host = copy.deepcopy(eng.model).to("cpu")
    frames = whisper_frames(wide, SEED + 11, batch=2, frames=64)
    tape_cpu = LinearTape(host)
    try:
        ref = _whisper_pass(host, eng.cfg, "cpu", frames)
    finally:
        tape_cpu.close()
    tape_card = LinearTape(eng.model, feed=tape_cpu.inputs)
    try:
        got = _whisper_pass(eng.model, eng.cfg, dev, frames)
    finally:
        tape_card.close()
    calls = len(tape_cpu.inputs)
    want_calls = 1 + WHISPER_ENC_LINEARS + 2 + 2 * WHISPER_STEP_LINEARS
    if len(tape_card.inputs) != calls or calls != want_calls:
        raise AssertionError(f"linear calls: card {len(tape_card.inputs)}, "
                             f"CPU {calls}, expected {want_calls}")
    worst = {}
    for (name, _lin, x_card), (_n, _l, x_cpu), y_card, y_cpu in zip(
            tape_card.inputs, tape_cpu.inputs, tape_card.outputs,
            tape_cpu.outputs):
        kind = ".".join(name.split(".")[-2:]) if "." in name else name
        if name.startswith("enc_blocks"):
            kind = "enc." + kind
        for what, a, b in (("out", y_card, y_cpu), ("in", x_card, x_cpu)):
            key = f"{kind}.{what}"
            worst[key] = max(worst.get(key, 0.0), rel_l2(a, b))
    for key, a, b in zip(("encoder_out", "prefill_logits", "decode_logits"),
                         got, ref):
        worst[key] = rel_l2(a, b)
    out["full_width_2_layers"] = worst
    out["full_width_linear_calls"] = calls
    del eng, host
    torch.cuda.empty_cache()
    tokens = np.random.default_rng(SEED + 12).integers(
        0, small.vocab_size, (2, 6)).astype(np.int32)
    fr = whisper_frames(small, SEED + 12, batch=2, frames=12)
    scfg = dataclasses.replace(small, quant=dataclasses.replace(
        small.quant, act_scale_mode="per_token"))
    state = soniq.init(scfg, seed=SEED + 12, device=dev)
    cpu_state = soniq.SoniqState(state.phase,
                                 copy.deepcopy(state.model).to("cpu"), scfg)
    logits = [soniq.apply(soniq.to_serve(st), tokens, frames=fr)
              for st in (state, cpu_state)]
    out["soniq_serve_rel_l2"] = rel_l2(*logits)
    bad = {k: v for k, v in worst.items() if not v <= 1e-5}
    if bad or not out["reduced_encode_rel_l2"] <= 1e-5 \
            or not out["soniq_serve_rel_l2"] <= 1e-5:
        raise AssertionError(f"whisper card vs CPU over 1e-5: {bad}; {out}")
    return out


def phase_whisper_serve(dev, rng, gen, results, launches, per_step):
    """Phase 20: serve the encoder-decoder family at the full width of
    whisper-medium, cut to WHISPER_SERVE_LAYERS of its 24 encoder and 24
    decoder layers (d_model 1024, 16 heads of 64, d_ff 4096, GELU,
    LayerNorm, tied vocab 51865; random QAT weights of the seed, default
    mix, bf16 compute). (a) The
    kernels at its shapes (``phase_whisper_kernels``). (b) The
    DecodeEngine's load (max_batch 4, cache_len 256, prefill chunk 8): one
    B7 launch a linear (asserted), pack_s, the load's device busy, peak
    memory. (c) One encode pass of 4 x 1500 mel frames: one B1 launch an
    encoder linear (asserted), host ms and a device profile by op. (d)
    ``load_cross`` of its output at fp and at 4 bits: 2 B1 launches a
    decoder layer each (asserted), the cross
    payload bytes. (e) 8 requests of 16-64 prompt tokens and 16 new over
    the fp ring (twice: bitwise), the 4-bit ring and the 4-bit pool
    (the first 4: tokens equal to the ring's), and the first 4, prompts
    cut to 16 tokens, speculatively (k = 3, draft bits 2; tokens equal
    spec-off; 32 B1 a decoder layer a round); 8 B1 launches a decoder
    layer a decode step (asserted: the step skips the cross wk/wv of x),
    2 B4 a layer a 4-bit ring step, one B5 and one B4 a layer a pool step;
    decode-step host ms
    and a device profile of a decode and an 8-lane prefill step. (f), (g)
    Card vs CPU (``check_whisper_against_cpu``). Returns the numbers."""
    cfg = dataclasses.replace(get_config(WHISPER_ARCH),
                              num_layers=WHISPER_SERVE_LAYERS,
                              encoder_layers=WHISPER_SERVE_LAYERS
                              ).with_quant_mode("qat")
    qcfg = QuantConfig(mode="qat")
    laps, t_lap = {}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        laps[name] = round(now - t_lap[0], 2)
        t_lap[0] = now

    phase_whisper_kernels(cfg, qcfg, gen, dev, results)
    lap("kernels")
    st = {"layers": [cfg.encoder_layers, cfg.num_layers],
          "frames": [WHISPER_BATCH, WHISPER_FRAMES, cfg.frontend_dim]}
    ecfg = engine.EngineConfig(max_batch=WHISPER_BATCH, cache_len=256,
                               prefill_chunk=8)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = lm.init_params(cfg, seed=SEED + 10, device=dev)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    eng = engine.DecodeEngine(params, cfg, ecfg)
    torch.cuda.synchronize()
    st["pack_s"] = time.perf_counter() - t0
    launches["b7_whisper_load"] = kernels.launch_counts()[B7]
    want = (WHISPER_ENC_LINEARS * cfg.encoder_layers
            + WHISPER_DEC_LINEARS * cfg.num_layers)
    if launches["b7_whisper_load"] != want or packed_leaves(eng.model) != \
            want:
        raise AssertionError(f"{launches['b7_whisper_load']} B7 launches at "
                             f"the whisper load, not one a linear ({want})")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    eng, prof = profile_load(lambda: engine.DecodeEngine(params, cfg, ecfg))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    st["load"] = dict(device_busy_ms=prof["device_busy_ms"],
                      device_events=prof["device_events"],
                      idle_share=1 - prof["device_busy_ms"]
                      / (st["pack_s"] * 1e3), by_op=prof["by_op"])
    st["peak_gib_init_and_pack"] = torch.cuda.max_memory_allocated() / 2 ** 30
    st["packed_bytes"] = engine.packed_model_bytes(eng.model)
    log(f"[20] {WHISPER_ARCH} load: pack_s {st['pack_s']:.3f}, "
        f"{launches['b7_whisper_load']} B7 launches, peak "
        f"{st['peak_gib_init_and_pack']:.2f} GiB; {st['load']}")
    lap("load")
    # (c) The encoder.
    frames = whisper_frames(cfg, SEED + 10)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    enc = lm.encode(eng.model, eng.cfg, frames)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    launches["b1_whisper_encode"] = counts[B1]
    if counts[B1] != WHISPER_ENC_LINEARS * cfg.encoder_layers \
            or counts[B2] or counts[B3] or counts[B8]:
        raise AssertionError(f"encode launches {counts}")
    if enc.shape != (WHISPER_BATCH, WHISPER_FRAMES, cfg.d_model) \
            or not torch.isfinite(enc).all():
        raise AssertionError(f"encoder output {tuple(enc.shape)} not finite")
    st["encode"] = profile_encode(eng, frames)
    st["encode"]["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[20] encode {st['frames']}: {counts[B1]} B1 launches; "
        f"{st['encode']}")
    lap("encode")
    # (d) The cross K/V at fp and at 4 bits.
    eng4 = engine.DecodeEngine(eng.model, cfg, dataclasses.replace(
        ecfg, kv_bits=4), already_serve=True, device=dev)
    st["load_cross"] = {}
    for tag, e in (("fp", eng), ("kv4", eng4)):
        e.reset()
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        e.load_cross(enc)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        n = kernels.launch_counts()[B1]
        if n != 2 * cfg.num_layers:
            raise AssertionError(f"load_cross ({tag}): {n} B1 launches, not "
                                 f"{2 * cfg.num_layers}")
        st["load_cross"][tag] = dict(
            host_ms=ms, b1_launches=n,
            cross_payload_bytes=kv_quant.cross_payload_bytes(e.cache),
            ring_payload_bytes=kv_quant.cache_payload_bytes(e.cache))
    launches["b1_whisper_load_cross"] = n
    log(f"[20] load_cross: {st['load_cross']}")
    lap("load_cross")
    # (e) The engines.
    reqs = requests(cfg.vocab_size, rng)
    kernels.reset_launch_counts()
    first, wall1 = serve_all(eng, reqs, enc)
    counts = kernels.launch_counts()
    launches["b1_whisper_serve"] = counts[B1] - 2 * cfg.num_layers
    if counts[B1] == 0 or counts[B2] or counts[B3] or counts[B8] \
            or counts[B4] or counts[B5]:
        raise AssertionError(f"whisper fp serve launches {counts}")
    for c in first:
        if c.new_tokens.size != 16 or not (
                (c.new_tokens >= 0) & (c.new_tokens < cfg.vocab_size)).all():
            raise AssertionError(f"bad whisper completion {c.new_tokens}")
    second, wall2 = serve_all(eng, reqs, enc)
    _same_tokens("whisper: a second identical run gave other tokens", first,
                 second)
    new = sum(c.new_tokens.size for c in second)
    st["fp_ring"] = dict(tok_s=new / wall2, wall_s=[wall1, wall2],
                         steps=eng.sched.step_count,
                         decode_step_ms=decode_step_ms(eng))
    per_step["b1_whisper"] = step_launches(eng)[B1]
    if per_step["b1_whisper"] != WHISPER_STEP_LINEARS * cfg.num_layers:
        raise AssertionError(f"{per_step['b1_whisper']} {B1} launches a "
                             f"whisper decode step, not "
                             f"{WHISPER_STEP_LINEARS * cfg.num_layers}")
    log(f"[20] fp ring: {len(reqs)} requests ({new} new tokens, a second "
        f"run bitwise): {st['fp_ring']}; {per_step['b1_whisper']} B1 a "
        f"step; tokens[0] {second[0].new_tokens[:8]}")
    lap("fp_ring")
    st["profile"] = ssm_profile_steps(eng, step_profile.WHISPER_SPANS)
    log(f"[20] step profiles: {st['profile']}")
    lap("profiles")
    wave = reqs[:WHISPER_BATCH]
    new4 = sum(c.new_tokens.size for c in second[:WHISPER_BATCH])
    kernels.reset_launch_counts()
    ring4, wall = serve_all(eng4, wave, enc)
    counts = kernels.launch_counts()
    launches["b4_whisper_kv4_serve"] = counts[B4]
    if counts[B4] == 0 or counts[B5]:
        raise AssertionError(f"whisper 4-bit ring launches {counts}")
    per_step["b4_whisper"] = step_launches(eng4)[B4]
    if per_step["b4_whisper"] != 2 * cfg.num_layers:
        raise AssertionError(f"{per_step['b4_whisper']} {B4} launches a "
                             f"4-bit ring step, not {2 * cfg.num_layers}")
    st["kv4_ring"] = dict(tok_s=new4 / wall, wall_s=wall,
                          decode_step_ms=decode_step_ms(eng4),
                          b4_launches_per_step=per_step["b4_whisper"])
    del eng4
    paged = engine.DecodeEngine(eng.model, cfg, dataclasses.replace(
        ecfg, kv_bits=4, kv_layout="paged", page_size=16),
        already_serve=True, device=dev)
    kernels.reset_launch_counts()
    pool_out, wall = serve_all(paged, wave, enc)
    counts = kernels.launch_counts()
    launches["b5_whisper_paged_serve"] = counts[B5]
    _same_tokens("whisper 4-bit pool != 4-bit ring", ring4, pool_out)
    paged.pool.check()
    step = step_launches(paged)
    per_step["b5_whisper"] = step[B5]
    if step[B5] != cfg.num_layers or step[B4] != cfg.num_layers:
        raise AssertionError(f"a 4-bit pool step: {step[B5]} {B5}, "
                             f"{step[B4]} {B4} (cross), not "
                             f"{cfg.num_layers} each")
    st["kv4_paged"] = dict(tok_s=new4 / wall, wall_s=wall,
                           pool=paged.paged_kv_stats(),
                           b5_b4_launches_per_step=[step[B5], step[B4]])
    del paged
    log(f"[20] 4-bit ring: {st['kv4_ring']}; 4-bit pool (tokens == ring): "
        f"{st['kv4_paged']}; agreement of the 4-bit ring with the fp ring: "
        f"{_agreement([c.new_tokens for c in second[:WHISPER_BATCH]], [c.new_tokens for c in ring4])}")
    lap("kv4")
    # Prompts cut to 16 tokens: the round's verify (k + 1 = 4 lanes)
    # would otherwise prefill a 64-token prompt in 16 rounds.
    short = [dataclasses.replace(r, prompt=r.prompt[:16]) for r in wave]
    st["spec"] = spec_serve(
        eng.model, cfg, ecfg, short, None, dev,
        {B1: (SPEC_TOKENS + 1) * WHISPER_STEP_LINEARS * cfg.num_layers},
        cross=enc)
    st["spec"].pop("launches")
    per_step["b1_whisper_spec_round"] = st["spec"]["round_launches"][B1]
    log(f"[20] spec (tokens == spec-off): {st['spec']}")
    lap("spec")
    del eng, enc
    gc.collect()
    torch.cuda.empty_cache()
    st["card_vs_cpu"] = check_whisper_against_cpu(dev, ecfg)
    log(f"[20] card vs CPU (fp32, relative L2): {st['card_vs_cpu']}")
    lap("card_vs_cpu")
    st["seconds"] = laps
    log(f"[20] seconds by part: {laps}")
    return st


# ------------------------------------------------------ whisper training ----
WHISPER_CPU_FRAMES = 128     # phase 21(c)'s encoder rows a layer (1 x 128)
WHISPER_CPU_TOKENS = 64      # phase 21(c)'s decoder tokens (1 x 64)
# Phase 21(b)'s training run: encoder and decoder layers (whisper-medium
# has 24 + 24), whose profile is read on the device alone; its op-split
# profile and second run at WHISPER_PROFILE_LAYERS each (12 before PR 32,
# cut for phase 24's time).
WHISPER_TRAIN_LAYERS = 6
WHISPER_PROFILE_LAYERS = 2


def whisper_train_shapes(cfg):
    """(name, K, N, M) of the training linears of one encoder layer (its
    six on 8 x 1500 frame rows) and one decoder layer (its ten on 8 x 128
    tokens, but the cross wk/wv, which project the encoder's 12,000
    rows)."""
    m_enc, m_dec = TRAIN_BATCH * WHISPER_FRAMES, TRAIN_BATCH * TRAIN_SEQ
    d, f = cfg.d_model, cfg.d_ff
    hq, hk = cfg.num_heads * cfg.hd, cfg.num_kv_heads * cfg.hd
    attn = [("wq", d, hq), ("wk", d, hk), ("wv", d, hk), ("wo", hq, d)]
    mlp = [("mlp.up", d, f), ("mlp.down", f, d)]
    enc = [(f"enc.{n}", k, nn, m_enc) for n, k, nn in
           [(f"attn.{a}", k, nn) for a, k, nn in attn] + mlp]
    dec = [(f"dec.attn.{a}", k, nn, m_dec) for a, k, nn in attn]
    dec += [(f"dec.cross.{a}", k, nn, m_enc if a in ("wk", "wv") else m_dec)
            for a, k, nn in attn]
    dec += [(f"dec.{n}", k, nn, m_dec) for n, k, nn in mlp]
    return enc + dec


def whisper_freeze_channels(cfg):
    """Input channels of each row of the freeze's report in the
    reference's walk: the encoder's stacked linears (``enc_groups``)
    before the decoder's, path by path (sorted), the layers inside each
    path."""
    d, f = cfg.d_model, cfg.d_ff
    attn = [d] * 4                     # wk, wo, wq, wv sorted; K = d each
    enc = attn + [f, d]                # mlp.down, mlp.up
    dec = attn + attn + [f, d]         # attn, cross, mlp
    return ([k for k in enc for _ in range(cfg.encoder_layers)]
            + [k for k in dec for _ in range(cfg.num_layers)])


def check_whisper_training_against_cpu(dev):
    """Phase 21(c): full-width whisper-medium cut to one encoder and one
    decoder layer, fp32, at NOISE (logits over the 4/2/1-bit bands, the
    same host-made draws) and QAT (the default mix): the encoder block
    on 1 x 128 frame rows, then the decoder block on 1 x 64 tokens
    attending the card's encoder-block output, each on the card and on
    the CPU from the same weights, input and cotangent, teacher-forced:
    each linear on the card runs on the CPU's input to it
    (``LinearTape``). Every linear's output and its input as the card's
    own ops made it, each block's y, dx (and the cross input's gradient)
    and every leaf's gradient (q/k/v/o and MLP weights, biases, logits,
    the LayerNorms' g and b; a key bias's gradient, zero up to rounding,
    against its query bias's) within relative L2 1e-5. Returns the worst
    of each kind (``grad``: over the leaves; ``linear_in``,
    ``linear_out``: over the linears) and the four largest by name."""
    worst, detail = {}, {}
    wide = dataclasses.replace(get_config(WHISPER_ARCH), num_layers=1,
                               encoder_layers=1, dtype="float32")
    for mode in ("noise", "qat"):
        cfg = wide.with_quant_mode(mode)
        host = lm.init_params(cfg, seed=SEED + 21, device="cpu")
        if mode == "noise":
            set_mixed_logits(host, SEED + 21)
        card = copy.deepcopy(host).to(dev)
        host.requires_grad_(True)
        card.requires_grad_(True)
        noise = HostNoise((SEED, 21)) if mode == "noise" else None
        gen = torch.Generator().manual_seed(SEED + 21)
        x = torch.randn((1, WHISPER_CPU_FRAMES, cfg.d_model), generator=gen)
        t = torch.randn((1, WHISPER_CPU_TOKENS, cfg.d_model), generator=gen)
        cross = None
        for tag, block, inp in (("enc", host.enc_blocks[0], x),
                                ("dec", host.blocks[0], t)):
            pos = torch.arange(inp.shape[1])[None]
            g = torch.randn(inp.shape, generator=gen)
            twin = card.enc_blocks[0] if tag == "enc" else card.blocks[0]
            yh, dxh, gh, th = _block_grads(block, inp, g, cfg, noise,
                                           positions=pos, cross_x=cross)
            yc, dxc, gc_, tc = _block_grads(
                twin, inp.to(dev), g.to(dev), cfg, noise, feed=th.inputs,
                positions=pos.to(dev),
                cross_x=None if cross is None else cross.to(dev))
            errs = {"y": rel_l2(yc, yh), "dx": rel_l2(dxc, dxh)}
            for n in gh:
                if n.endswith(".wk.b"):
                    # Zero up to rounding: a constant added to every key
                    # of a row leaves its softmax unchanged.
                    ref = gh[n.replace(".wk.b", ".wq.b")].double().norm()
                    errs[n] = ((gc_[n].cpu().double() - gh[n].double())
                               .norm() / ref).item()
                else:
                    errs[n] = rel_l2(gc_[n], gh[n])
            for (name, _m, xc), (_n, _mh, xh), oc, oh in zip(
                    tc.inputs, th.inputs, tc.outputs, th.outputs):
                kind = ".".join(name.split(".")[-2:])
                errs[f"{kind}.in"] = rel_l2(xc, xh)
                errs[f"{kind}.out"] = rel_l2(oc, oh)
            for what, err in errs.items():
                detail[f"{mode}.{tag}.{what}"] = err
                kind = what if what in ("y", "dx", "cross_x") else (
                    "linear_" + what.rsplit(".", 1)[1]
                    if what.endswith((".in", ".out")) else "grad")
                key = f"{mode}.{tag}.{kind}"
                worst[key] = max(worst.get(key, 0.0), err)
            cross = yc.cpu()
        del host, card
        torch.cuda.empty_cache()
    bad = {k: v for k, v in detail.items() if not v <= 1e-5}
    if bad:
        raise AssertionError(f"whisper training card vs CPU over 1e-5: "
                             f"{bad}")
    worst["largest"] = sorted(detail.items(), key=lambda kv: -kv[1])[:4]
    return worst


def phase_whisper_training(dev, gen, results, rng):
    """Phase 21: train the encoder-decoder family at the full width of
    whisper-medium, cut to WHISPER_TRAIN_LAYERS of its 24 encoder and 24
    decoder layers (fp32 parameters, bf16 compute; batches of
    TokenStream(8, 128, seed 0) with
    mel frames [8, 1500, 80] from ``default_rng(SEED)``). (a) B9, B8 and
    both backward kernels against their plain versions at one encoder
    layer's six linears (activations at M = 8 x 1500 = 12,000 rows) and
    one decoder layer's ten (M = 1024; the cross wk/wv at 12,000):
    forward, dw and dx bitwise, ds within ``noise_inject.ds_bound``, timed
    on both rulers (``whisper_train_*`` keys). (b) The logits over the
    4/2/1-bit bands, 3 Phase-I steps, the freeze and 3 Phase-II steps
    through ``loop.train``: every step's launches asserted (two B9 and
    one B9 backward a linear a Phase-I step, four B8 and two B8 backward
    a Phase-II step: each block recomputed), host ms and peak
    memory a step, the device busy of steps 2 and 5; the report in the
    reference's walk (``whisper_freeze_channels``); the same at
    WHISPER_PROFILE_LAYERS + WHISPER_PROFILE_LAYERS layers with steps 2
    and 5 split by op (``step_profile.whisper_train_summary``), and a
    second run at that depth bitwise the first (losses, gradient norms,
    pbits, every parameter).
    (c) ``check_whisper_training_against_cpu``. (d) The trained model
    through ``soniq.to_serve`` (one B7 a linear, asserted), one encode of
    4 x 1500 frames (one B1 an encoder linear, asserted), ``load_cross``
    and 4 greedy requests on the
    fp ring, twice bitwise. Returns the numbers."""
    from repro_torch import soniq
    from repro_torch.api.state import SoniqState
    from repro_torch.core.phases import Phase
    out, laps, t_lap = {}, {}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        laps[name] = round(now - t_lap[0], 2)
        t_lap[0] = now

    full = dataclasses.replace(get_config(WHISPER_ARCH),
                               num_layers=WHISPER_TRAIN_LAYERS,
                               encoder_layers=WHISPER_TRAIN_LAYERS)
    shapes = whisper_train_shapes(full)
    for name, rec in phase_training_kernels(full, gen, dev,
                                            shapes=shapes).items():
        results[name].update({f"whisper_train_{k}": v
                              for k, v in rec.items()})
    log(f"[21] {B9}, {B8} and both backward kernels at one {WHISPER_ARCH} "
        f"encoder and decoder layer's training linears ({shapes}): forward,"
        f" dw and dx bitwise, ds within its bound: "
        f"{ {n: {k: v for k, v in results[n].items() if k.startswith('whisper_train_')} for n in (B9, B8, B9_BWD, B8_BWD)} }")
    torch.cuda.empty_cache()
    lap("kernels")

    state, records, profiles, rep = phase_training(
        full, dev, tag=21, spans=None, summary=step_profile.device_busy,
        mixed_seed=SEED + 21)
    model = state["model"]
    del state
    gc.collect()
    torch.cuda.empty_cache()
    channels = [sum(layer["hist"]) for layer in rep["layers"]]
    if channels != whisper_freeze_channels(full):
        raise AssertionError(f"freeze order or widths: {channels}")
    digest = param_digest(model)
    st = {"layers": [full.encoder_layers, full.num_layers],
          "frames": [TRAIN_BATCH, WHISPER_FRAMES, full.frontend_dim],
          "steps": records, "device_busy": profiles,
          "histogram": precision_histogram(model),
          "average_bpp": schedule.average_bpp(rep),
          "allowed_patterns": rep["allowed"], "linears": len(rep["layers"]),
          "param_digest": digest,
          "launches_per_step": {p: train_step_launches(full, p)
                                for p in (1, 2)}}
    log(f"[21] {full.encoder_layers} + {full.num_layers} layers: the freeze "
        f"walks the encoder first, path by path; frozen groups by "
        f"precision {st['histogram']}, average bpp {st['average_bpp']:.4f} "
        f"over {st['linears']} linears; digest {digest!r}")
    for name, key in ((B8, "b8"), (B9, "b9"), (B8_BWD, "b8_bwd"),
                      (B9_BWD, "b9_bwd")):
        results[name]["whisper_train_run_launches"] = sum(r[key]
                                                          for r in records)
        results[name]["whisper_train_launches_per_step"] = max(
            r[key] for r in records)
    lap("train")

    # The op split and the second run, at WHISPER_PROFILE_LAYERS: a
    # profile that records every host op as well reads for minutes at
    # WHISPER_TRAIN_LAYERS, and a second run there would take the smoke
    # past its time.
    small = dataclasses.replace(full, num_layers=WHISPER_PROFILE_LAYERS,
                                encoder_layers=WHISPER_PROFILE_LAYERS)
    runs = []
    for profiled in (True, False):
        state, rec, split, rep_small = phase_training(
            small, dev, tag=21, spans=step_profile.WHISPER_TRAIN_SPANS,
            summary=step_profile.whisper_train_summary, profiled=profiled,
            mixed_seed=SEED + 21)
        runs.append((state["model"], rec, split, rep_small))
        del state
    (one, rec, split, rep_small), (again, rec2, _s, rep2) = runs
    del runs
    same = [(r["loss"], r["grad_norm"]) for r in rec] == \
        [(r["loss"], r["grad_norm"]) for r in rec2]
    params_same = all(torch.equal(a, b) for a, b in zip(
        one.parameters(), again.parameters()))
    pbits_same = all(torch.equal(a.pbits, b.pbits) for (_n, a), (_m, b)
                     in zip(smol.smol_linears(one), smol.smol_linears(again))
                     if "pbits" in a._names)
    if not (same and params_same and pbits_same
            and rep_small["layers"] == rep2["layers"]):
        raise AssertionError(f"a second whisper training run differs: "
                             f"losses equal {same}, parameters equal "
                             f"{params_same}, pbits equal {pbits_same}")
    del one, again
    gc.collect()
    torch.cuda.empty_cache()
    st["op_split"] = dict(layers=[WHISPER_PROFILE_LAYERS] * 2,
                          step_ms=[r["ms"] for r in rec], profiles=split)
    st["second_run"] = dict(layers=[WHISPER_PROFILE_LAYERS] * 2,
                            bitwise=True, step_ms=[r["ms"] for r in rec2])
    log(f"[21] {WHISPER_PROFILE_LAYERS} + {WHISPER_PROFILE_LAYERS} layers: "
        f"a second run bitwise the first (losses, gradient norms, pbits, "
        f"parameters)")
    lap("op_split_and_second_run")

    st["card_vs_cpu"] = check_whisper_training_against_cpu(dev)
    log(f"[21] one full-width encoder and decoder layer, card vs CPU "
        f"(fp32, relative L2; y, dx, every leaf's gradient, every linear): "
        f"{st['card_vs_cpu']}")
    lap("card_vs_cpu")

    qcfg = full.with_quant_mode("qat")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    served = soniq.to_serve(SoniqState(Phase.QAT, model, qcfg))
    torch.cuda.synchronize()
    st["to_serve_s"] = time.perf_counter() - t0
    st["to_serve_b7"] = kernels.launch_counts()[B7]
    want = (WHISPER_ENC_LINEARS * full.encoder_layers
            + WHISPER_DEC_LINEARS * full.num_layers)
    if st["to_serve_b7"] != want:
        raise AssertionError(f"{st['to_serve_b7']} B7 launches at to_serve,"
                             f" not one a linear ({want})")
    ecfg = engine.EngineConfig(max_batch=WHISPER_BATCH, cache_len=256,
                               prefill_chunk=8)
    eng = engine.DecodeEngine(served.model, qcfg, ecfg, already_serve=True,
                              device=dev)
    frames = whisper_frames(full, SEED + 21)
    kernels.reset_launch_counts()
    enc = lm.encode(eng.model, eng.cfg, frames)
    torch.cuda.synchronize()
    st["encode_b1"] = kernels.launch_counts()[B1]
    if st["encode_b1"] != WHISPER_ENC_LINEARS * full.encoder_layers \
            or not torch.isfinite(enc).all():
        raise AssertionError(f"trained encode: {st['encode_b1']} B1 "
                             f"launches, finite {torch.isfinite(enc).all()}")
    reqs = requests(full.vocab_size, rng, n=WHISPER_BATCH, lo=16, hi=16,
                    new=8)
    kernels.reset_launch_counts()
    first, _wall = serve_all(eng, reqs, enc)
    st["serve_b1"] = kernels.launch_counts()[B1]
    second, _wall = serve_all(eng, reqs, enc)
    _same_tokens("trained whisper: a second serve gave other tokens", first,
                 second)
    for c in first:
        if c.new_tokens.size != 8 or not (
                (c.new_tokens >= 0) & (c.new_tokens < full.vocab_size)).all():
            raise AssertionError(f"bad trained-whisper completion "
                                 f"{c.new_tokens}")
    st["served_tokens"] = [c.new_tokens.tolist() for c in first]
    log(f"[21] to_serve: {st['to_serve_b7']} B7 launches in "
        f"{st['to_serve_s']:.3f} s; encode {st['encode_b1']} B1; served 4 "
        f"requests twice, bitwise ({st['serve_b1']} B1 launches with "
        f"load_cross): tokens {st['served_tokens']}")
    del eng, served, model, enc
    gc.collect()
    torch.cuda.empty_cache()
    lap("serve")
    st["seconds"] = laps
    log(f"[21] seconds by part: {laps}")
    return st


# ------------------------------------------------------------------- VLM ----
VLM_ARCH = "qwen2-vl-72b"
# Phase 22(b)'s depth (qwen2-vl-72b has 80; 4 before PR 32, cut for phase
# 24's time).
VLM_SERVE_LAYERS = 2
VLM_TRAIN_LAYERS = 1         # phase 22(d)'s depth, beside the table and head
VLM_LINEARS = 7              # q, k, v, o, gate, up, down
# The multimodal prompt of phase 22(c), laid out as Qwen2-VL lays its
# inputs (arXiv:2409.12191 §2.1): text, a video of 4 frames of 16 x 16
# merged patches, text, an image of 24 x 40, text; 2304 tokens, past the
# chunked attention's threshold.
VLM_PREFILL = (("text", 64), ("vision", 4, 16, 16), ("text", 64),
               ("vision", 1, 24, 40), ("text", 192))
# A training row of phase 22(d): text, a 16 x 16 image, text (384).
VLM_TRAIN = (("text", 64), ("vision", 1, 16, 16), ("text", 64))
VLM_TRAIN_BATCH = 4
# The card-vs-CPU layout of phase 22(c): an image and a video of 2 frames.
VLM_CPU = (("text", 16), ("vision", 1, 4, 8), ("text", 16),
           ("vision", 2, 4, 4), ("text", 16))
VLM_TABLE_SCALE = 0.02       # the embedding table's init scale


def mrope_positions(layout) -> np.ndarray:
    """int32 [3, S] M-RoPE position streams (temporal, height, width) of a
    layout of ("text", n) and ("vision", t, h, w) segments: text runs on
    all three streams; a vision block's (t, h, w) grid is offset from the
    previous maximum plus 1, and the text after it starts at the block's
    maximum plus 1."""
    parts, start = [], 0
    for seg in layout:
        if seg[0] == "text":
            p = start + np.arange(seg[1])
            parts.append(np.stack([p, p, p]))
            start += seg[1]
        else:
            t, h, w = seg[1:]
            grid = np.meshgrid(np.arange(t), np.arange(h), np.arange(w),
                               indexing="ij")
            parts.append(np.stack([g.ravel() for g in grid]) + start)
            start += max(t, h, w)
    return np.concatenate(parts, axis=1).astype(np.int32)


def vision_mask(layout) -> np.ndarray:
    """bool [S]: True at a vision segment's patches."""
    return np.concatenate([np.full(seg[1] if seg[0] == "text"
                                   else int(np.prod(seg[1:])),
                                   seg[0] != "text") for seg in layout])


def vlm_inputs(table, layout, seed, batch=1, dtype=torch.bfloat16):
    """(embeds [batch, S, D] in ``dtype``: the table's rows of seeded
    tokens at the text positions, seeded normals at the table's scale at
    the patches (the vision tower is a stub); positions int64 [3, batch,
    S]; the tokens [batch, S]), on the table's device."""
    dev = table.device
    mask = torch.as_tensor(vision_mask(layout), device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    s = mask.numel()
    tokens = torch.randint(0, table.shape[0], (batch, s), generator=g,
                           device=dev)
    emb = torch.nn.functional.embedding(tokens, table).float()
    patches = torch.randn(emb.shape, generator=g, device=dev) \
        * VLM_TABLE_SCALE
    emb = torch.where(mask[None, :, None], patches, emb).to(dtype)
    pos = torch.as_tensor(mrope_positions(layout), device=dev).long()
    return emb, pos[:, None].expand(3, batch, s).contiguous(), tokens


def vlm_head_training_kernels(k, n, gen, dev, band=1024, reps=5):
    """B9, B8 and both backward kernels on one weight of the ``lm_head``'s
    shape ([K, N] fp32, K * N = 1.246e9 elements, 4.98 GB: fp32 byte
    offsets past 2^32): each call's output against its plain version a
    band of ``band`` rows at a time (the plain versions' int64 hash
    temporaries do not fit the card at once; B9's ``row0`` keeps the
    element index of the whole weight): forward, dw and dx bitwise, ds
    within ``noise_inject.ds_bound``. Timed on both rulers; ``plain_ms``
    is the plain versions over every band. Returns {kernel: numbers}."""
    out = {}
    bands = [(r, min(r + band, k)) for r in range(0, k, band)]
    w = torch.rand((k, n), generator=gen, device=dev) * 2.2 - 1.1
    s = torch.randn((k // 16,), generator=gen, device=dev) * 2.0 - 0.5
    seed = torch.randint(0, 1 << 32, (1,), generator=gen, device=dev)
    sig = ni.group_sigma(s)
    got = ni.noise_inject(w, s, seed)
    for a, b in bands:
        want = ni.noise_inject_plain(w[a:b], sig[a // 16:b // 16], seed,
                                     row0=a)
        if not torch.equal(got[a:b], want):
            raise AssertionError(f"noise_inject [{k}, {n}] rows {a}:{b}: "
                                 f"{(got[a:b] != want).sum().item()} "
                                 f"elements differ from the plain version")
    del got, want
    elems = k * n

    def plain_b9():
        for a, b in bands:
            ni.noise_inject_plain(w[a:b], sig[a // 16:b // 16], seed, row0=a)

    kern = lambda: ni.noise_inject(w, s, seed)  # noqa: E731
    b_ms, b_by = bound(8 * elems + 4 * s.numel() + 8, 16 * elems)
    out[B9] = dict(max_abs_err=0.0, ms=time_ms(kern, reps),
                   device_ms=device_ms(kern, reps),
                   plain_ms=time_ms(plain_b9, 1), bound_ms=b_ms,
                   bound_by=b_by, library_ms=None)
    g = torch.randn((k, n), generator=gen, device=dev)
    dw, ds = ni.noise_inject_bwd(w, s, seed, g)
    ds_err = 0.0
    for a, b in bands:
        sl = slice(a // 16, b // 16)
        dw_p, ds_p = ni.noise_inject_bwd_plain(w[a:b], s[sl], seed, g[a:b],
                                               row0=a)
        if not torch.equal(_bits(dw[a:b]), _bits(dw_p)):
            raise AssertionError(f"noise_inject_bwd [{k}, {n}] rows {a}:{b}"
                                 f": dw differs from the plain version")
        err = (ds[sl] - ds_p).abs()
        if not (err <= ni.ds_bound(w[a:b], s[sl], seed, g[a:b],
                                   row0=a)).all():
            raise AssertionError(f"noise_inject_bwd [{k}, {n}] rows {a}:{b}"
                                 f": ds off the plain version by "
                                 f"{err.max().item()}")
        ds_err = max(ds_err, err.max().item())
    del dw, ds, dw_p, ds_p

    def plain_b9_bwd():
        for a, b in bands:
            ni.noise_inject_bwd_plain(w[a:b], s[a // 16:b // 16], seed,
                                      g[a:b], row0=a)

    kern = lambda: ni.noise_inject_bwd(w, s, seed, g)  # noqa: E731
    b_ms, b_by = bound(12 * elems + 8 * s.numel() + 8, 20 * elems)
    out[B9_BWD] = dict(max_abs_err=ds_err, ms=time_ms(kern, reps),
                       device_ms=device_ms(kern, reps),
                       plain_ms=time_ms(plain_b9_bwd, 1), bound_ms=b_ms,
                       bound_by=b_by, library_ms=None)
    del w, s, seed, sig
    w, pb, sw = b8_weight_operands(k, n, gen, dev)
    kw = dict(row_scale=False, k_dim=0)
    got = fq.fake_quant(w, pb, sw, **kw)
    dx = fq.fake_quant_bwd(w, pb, sw, g, **kw)
    for a, b in bands:
        sl = slice(a // 16, b // 16)
        if not torch.equal(got[a:b], fq.fake_quant_plain(
                w[a:b], pb[sl], sw[sl], **kw)):
            raise AssertionError(f"fake_quant [{k}, {n}] rows {a}:{b} "
                                 f"differ from the plain version")
        if not torch.equal(_bits(dx[a:b]), _bits(fq.fake_quant_bwd_plain(
                w[a:b], pb[sl], sw[sl], g[a:b], **kw))):
            raise AssertionError(f"fake_quant_bwd [{k}, {n}] rows {a}:{b} "
                                 f"differ from the plain version")
    del got, dx

    def plain_b8(bwd):
        for a, b in bands:
            sl = slice(a // 16, b // 16)
            if bwd:
                fq.fake_quant_bwd_plain(w[a:b], pb[sl], sw[sl], g[a:b], **kw)
            else:
                fq.fake_quant_plain(w[a:b], pb[sl], sw[sl], **kw)

    kern = lambda: fq.fake_quant(w, pb, sw, **kw)  # noqa: E731
    b_ms, b_by = bound(8 * elems + 8 * pb.numel(), 12 * elems)
    out[B8] = dict(max_abs_err=0.0, ms=time_ms(kern, reps),
                   device_ms=device_ms(kern, reps),
                   copy_device_ms=device_ms(lambda: w.clone(), reps),
                   plain_ms=time_ms(lambda: plain_b8(False), 1),
                   bound_ms=b_ms, bound_by=b_by, library_ms=None)
    kern = lambda: fq.fake_quant_bwd(w, pb, sw, g, **kw)  # noqa: E731
    b_ms, b_by = bound(12 * elems + 8 * pb.numel(), 6 * elems)
    out[B8_BWD] = dict(max_abs_err=0.0, ms=time_ms(kern, reps),
                       device_ms=device_ms(kern, reps),
                       plain_ms=time_ms(lambda: plain_b8(True), 1),
                       bound_ms=b_ms, bound_by=b_by, library_ms=None)
    return out


def phase_vlm_kernels(cfg, qcfg, gen, dev, results):
    """Phase 22(a), into ``results`` (``vlm_*`` keys): at qwen2-vl-72b's
    full width (d_model 8192, 64 heads of 128 over 8, d_ff 29568: the
    down projection's K holds 1848 groups, 924 / 693 / 231 at 4 / 2 / 1
    bits, so the 2- and 1-bit segments hold an odd number of groups and
    the 1-bit segment starts at k_off 25872, off every 32-channel tile),
    B1 on one layer's seven linears at M = 4 (decode) and M = 2304 (the
    multimodal prefill) and on the untied readout's shape (8192 x 152064,
    fp in the model: a packed stand-in, the widest GEMM any config gives
    B1) at M = 4 and 2304, each within the fp32 reordering bound and
    timed on both rulers beside torch.matmul of the dequantized operands;
    B7 on one layer (7 launches) and on the readout's shape, bitwise;
    B9, B8 and both backward kernels on one layer's training linears
    (activations at M = 4 x 384) and on the readout's shape
    (``vlm_head_training_kernels``)."""
    d, v = cfg.d_model, cfg.vocab_size
    head = [("lm_head", d, v)]
    m_pre = int(mrope_positions(VLM_PREFILL).shape[1])
    for tag, shapes, m, nsets, reps in (
            ("layer_M4", None, 4, 2, 10), ("layer_M2304", None, m_pre, 1, 1),
            ("head_M4", head, 4, 1, 10), ("head_M2304", head, m_pre, 1, 1)):
        sets = [LayerOperands(cfg, qcfg, m, gen, dev, shapes)
                for _ in range(nsets)]
        err = check_segment_gemm(B1, sets[:1])
        res = time_segment_gemm(B1, sets, reps=reps)
        results[B1].update({f"vlm_{tag}_{k}": x for k, x in res.items()},
                           **{f"vlm_{tag}_max_abs_err": err})
        log(f"[22] {B1} {tag} ({len(sets[0].linears)} launches): max |err| "
            f"{err:.3e} within the fp32 bound; {res}")
        del sets
        gc.collect()
        torch.cuda.empty_cache()
    for tag, shapes in (("layer", layer_linears(cfg)), ("head", head)):
        calls = [pack_operands((k, n), qcfg, gen, dev)
                 for _name, k, n in shapes]
        _check_pack(calls)
        b_ms, b_by = _pack_bound(calls)
        reps = 10 if tag == "layer" else 3
        results[B7].update({
            f"vlm_{tag}_ms": time_ms(lambda: _pack_layer(calls), reps),
            f"vlm_{tag}_device_ms": device_ms(lambda: _pack_layer(calls),
                                              reps),
            f"vlm_{tag}_plain_ms": time_ms(lambda: _pack_layer_plain(calls),
                                           1),
            f"vlm_{tag}_bound_ms": b_ms, f"vlm_{tag}_bound_by": b_by,
            f"vlm_{tag}_launches": len(calls)})
        del calls
        gc.collect()
        torch.cuda.empty_cache()
    log(f"[22] {B7} bitwise on one layer (7 launches) and the readout's "
        f"shape: { {k: x for k, x in results[B7].items() if 'vlm' in k} }")
    shapes = [(name, k, n, VLM_TRAIN_BATCH * len(vision_mask(VLM_TRAIN)))
              for name, k, n in layer_linears(cfg)]
    for name, rec in phase_training_kernels(cfg, gen, dev,
                                            shapes=shapes).items():
        results[name].update({f"vlm_train_{k}": x for k, x in rec.items()})
    gc.collect()
    torch.cuda.empty_cache()
    for name, rec in vlm_head_training_kernels(d, v, gen, dev).items():
        results[name].update({f"vlm_head_{k}": x for k, x in rec.items()})
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[22] {B9}, {B8} and both backward kernels on one layer's training "
        f"linears and on the readout's shape: forward, dw and dx bitwise, "
        f"ds within its bound: "
        f"{ {n: {k: x for k, x in results[n].items() if k.startswith(('vlm_train_', 'vlm_head_'))} for n in (B9, B8, B9_BWD, B8_BWD)} }")


def check_vlm_against_cpu(dev, ecfg):
    """Phase 22(c)'s card vs CPU: qwen2-vl-72b at full width cut to one
    layer, fp32, packed on the card, the packed model copied to the CPU;
    ``forward(embeds=, positions=[3, 1, S])`` over ``VLM_CPU`` (an image
    and a 2-frame video, M-RoPE streams) and the readout, teacher-forced
    (``LinearTape``): each of the layer's seven linears on the CPU's input
    to it, and each input as the card's own ops made it (the RMS norms,
    M-RoPE, the float64 attention under the temporal stream's mask,
    SwiGLU, residual adds), the hidden state and the logits, within
    relative L2 1e-5. Returns the numbers."""
    wide = dataclasses.replace(get_config(VLM_ARCH), num_layers=1,
                               dtype="float32").with_quant_mode("qat")
    eng = engine.DecodeEngine(lm.init_params(wide, seed=SEED + 24,
                                             device=dev), wide, ecfg,
                              device=dev)
    host = copy.deepcopy(eng.model).to("cpu")
    emb, pos, _tok = vlm_inputs(eng.model.embed.table, VLM_CPU, SEED + 24,
                                dtype=torch.float32)

    def run(model, device):
        with torch.no_grad():
            h, _ = lm.forward(model, eng.cfg, embeds=emb.to(device),
                              positions=pos.to(device))
            return [h.double().cpu(),
                    lm.logits(model, eng.cfg, h).double().cpu()]

    tape_cpu = LinearTape(host)
    try:
        ref = run(host, "cpu")
    finally:
        tape_cpu.close()
    tape_card = LinearTape(eng.model, feed=tape_cpu.inputs)
    try:
        got = run(eng.model, dev)
    finally:
        tape_card.close()
    calls = len(tape_cpu.inputs)
    if len(tape_card.inputs) != calls or calls != VLM_LINEARS:
        raise AssertionError(f"linear calls: card {len(tape_card.inputs)}, "
                             f"CPU {calls}, expected {VLM_LINEARS}")
    worst = {}
    for (name, _lin, x_card), (_n, _l, x_cpu), y_card, y_cpu in zip(
            tape_card.inputs, tape_cpu.inputs, tape_card.outputs,
            tape_cpu.outputs):
        kind = ".".join(name.split(".")[-2:])
        worst[f"{kind}.out"] = rel_l2(y_card, y_cpu)
        worst[f"{kind}.in"] = rel_l2(x_card, x_cpu)
    worst["hidden"], worst["logits"] = (rel_l2(a, b)
                                        for a, b in zip(got, ref))
    del eng, host
    gc.collect()
    torch.cuda.empty_cache()
    bad = {k: x for k, x in worst.items() if not x <= 1e-5}
    if bad:
        raise AssertionError(f"qwen2-vl card vs CPU over 1e-5: {bad}")
    return worst


def profile_apply(state, emb, pos):
    """One ``soniq.apply`` of the served VLM (after a first one): host-clock
    ms and a device profile split by op (``step_profile.VLM_SPANS``)."""
    from repro_torch import soniq
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        soniq.apply(state, embeds=emb, positions=pos)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    undo = step_profile.install_spans(step_profile.VLM_SPANS)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof, \
                torch.no_grad():
            soniq.apply(state, embeds=emb, positions=pos)
            torch.cuda.synchronize()
    finally:
        undo()
    return profile_summary(prof, host_ms)


def phase_vlm_serve(dev, rng, results, launches, per_step):
    """Phase 22(b) and (c): serve qwen2-vl-72b at full width cut to
    VLM_SERVE_LAYERS of its 80 layers (d_model 8192, 64 heads of 128 over
    8, d_ff 29568, attention and MLP biases, the untied readout over
    152064; random QAT weights of the seed, default mix, bf16 compute).
    (b) The DecodeEngine's load (max_batch 4, cache_len 256, prefill
    chunk 8): one B7 launch a linear (28; the readout is an fp linear, as
    in the reference), ``pack_s``, peak memory; 8 text requests of 16-64
    prompt tokens and 16 new over the fp ring (28 B1 a decode step;
    lockstep == continuous), the 4-bit ring (4 B4 a step) and the 4-bit
    pool (4 B5 a step; tokens == the 4-bit ring's), and the first 4,
    prompts cut to 16 tokens, speculatively (k = 3, draft bits 2; tokens
    == spec-off; 112 B1 a round). (c) ``soniq.apply`` on the packed
    state over the multimodal prompt (``VLM_PREFILL``, 2304 tokens,
    embeddings [1, 2304, 8192] bf16, M-RoPE streams [3, 1, 2304]): 28 B1
    launches at M = 2304, the chunked attention, finite logits, host ms
    and a device profile by op; the table's rows of 2304 seeded tokens as
    embeddings at three equal streams give bitwise the tokens path's
    logits at [1, S] positions; one layer card vs CPU
    (``check_vlm_against_cpu``). Returns the numbers."""
    from repro_torch import soniq
    from repro_torch.core.phases import Phase
    cfg = dataclasses.replace(get_config(VLM_ARCH),
                              num_layers=VLM_SERVE_LAYERS
                              ).with_quant_mode("qat")
    n_lin = VLM_LINEARS * cfg.num_layers
    laps, t_lap = {}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        laps[name] = round(now - t_lap[0], 2)
        t_lap[0] = now

    st = {"layers": cfg.num_layers}
    ecfg = engine.EngineConfig(max_batch=4, cache_len=256, prefill_chunk=8)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = lm.init_params(cfg, seed=SEED + 22, device=dev)
    torch.cuda.synchronize()
    st["qat_tree_gib"] = sum(p.numel() * p.element_size()
                             for p in params.parameters()) / 2 ** 30
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    eng = engine.DecodeEngine(params, cfg, ecfg)
    torch.cuda.synchronize()
    st["pack_s"] = time.perf_counter() - t0
    launches["b7_vlm_load"] = kernels.launch_counts()[B7]
    if launches["b7_vlm_load"] != n_lin or packed_leaves(eng.model) != n_lin:
        raise AssertionError(f"{launches['b7_vlm_load']} B7 launches at the "
                             f"qwen2-vl load, not one a linear ({n_lin})")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    st["peak_gib_init_and_pack"] = torch.cuda.max_memory_allocated() / 2 ** 30
    st["packed_bytes"] = engine.packed_model_bytes(eng.model)
    log(f"[22] {VLM_ARCH} at {cfg.num_layers} layers: QAT tree "
        f"{st['qat_tree_gib']:.2f} GiB, pack_s {st['pack_s']:.3f}, "
        f"{launches['b7_vlm_load']} B7 launches, peak "
        f"{st['peak_gib_init_and_pack']:.2f} GiB, packed "
        f"{st['packed_bytes']:,} bytes")
    lap("load")
    reqs = requests(cfg.vocab_size, rng)
    kernels.reset_launch_counts()
    ring, wall = serve_all(eng, reqs)
    counts = kernels.launch_counts()
    launches["b1_vlm_serve"] = counts[B1]
    if counts[B1] == 0 or counts[B2] or counts[B3] or counts[B8] \
            or counts[B4] or counts[B5]:
        raise AssertionError(f"qwen2-vl fp serve launches {counts}")
    for c in ring:
        if c.new_tokens.size != 16 or not (
                (c.new_tokens >= 0) & (c.new_tokens < cfg.vocab_size)).all():
            raise AssertionError(f"bad qwen2-vl completion {c.new_tokens}")
    new = sum(c.new_tokens.size for c in ring)
    per_step["b1_vlm"] = step_launches(eng)[B1]
    if per_step["b1_vlm"] != n_lin:
        raise AssertionError(f"{per_step['b1_vlm']} {B1} launches a "
                             f"qwen2-vl decode step, not {n_lin}")
    st["fp_ring"] = dict(tok_s=new / wall, wall_s=wall,
                         steps=eng.sched.step_count,
                         decode_step_ms=decode_step_ms(eng))
    check_lockstep_equals_continuous(eng, cfg, ecfg, cfg.vocab_size, rng,
                                     16, 8)
    log(f"[22] fp ring: {len(reqs)} requests ({new} new tokens): "
        f"{st['fp_ring']}; {per_step['b1_vlm']} B1 a step; lockstep == "
        f"continuous; tokens[0] {ring[0].new_tokens[:8]}")
    lap("fp_ring")
    e4 = engine.DecodeEngine(eng.model, cfg, dataclasses.replace(
        ecfg, kv_bits=4), already_serve=True, device=dev)
    kernels.reset_launch_counts()
    ring4, wall4 = serve_all(e4, reqs)
    counts = kernels.launch_counts()
    launches["b4_vlm_kv4_serve"] = counts[B4]
    per_step["b4_vlm"] = step_launches(e4)[B4]
    if counts[B4] == 0 or counts[B5] or per_step["b4_vlm"] != cfg.num_layers:
        raise AssertionError(f"qwen2-vl 4-bit ring launches {counts}, "
                             f"{per_step['b4_vlm']} B4 a step")
    del e4
    paged = engine.DecodeEngine(eng.model, cfg, dataclasses.replace(
        ecfg, kv_bits=4, kv_layout="paged", page_size=16),
        already_serve=True, device=dev)
    kernels.reset_launch_counts()
    pool, wallp = serve_all(paged, reqs)
    counts = kernels.launch_counts()
    launches["b5_vlm_paged_serve"] = counts[B5]
    _same_tokens("qwen2-vl 4-bit pool != 4-bit ring", ring4, pool)
    paged.pool.check()
    step = step_launches(paged)
    per_step["b5_vlm"] = step[B5]
    if step[B5] != cfg.num_layers or step[B4]:
        raise AssertionError(f"a qwen2-vl 4-bit pool step: {step[B5]} B5, "
                             f"{step[B4]} B4")
    new4 = sum(c.new_tokens.size for c in ring4)
    st["kv4"] = dict(ring_tok_s=new4 / wall4, pool_tok_s=new4 / wallp,
                     pool=paged.paged_kv_stats(),
                     agreement_with_fp=_agreement(
                         [c.new_tokens for c in ring],
                         [c.new_tokens for c in ring4]))
    del paged
    log(f"[22] 4-bit ring and pool (tokens == ring): {st['kv4']}")
    lap("kv4")
    short = [dataclasses.replace(r, prompt=r.prompt[:16]) for r in reqs[:4]]
    st["spec"] = spec_serve(eng.model, cfg, ecfg, short, None, dev,
                            {B1: (SPEC_TOKENS + 1) * n_lin})
    st["spec"].pop("launches")
    per_step["b1_vlm_spec_round"] = st["spec"]["round_launches"][B1]
    log(f"[22] spec (tokens == spec-off): {st['spec']}")
    lap("spec")
    # (c) The multimodal prefill on the packed state.
    state = soniq.SoniqState(Phase.SERVE, eng.model, eng.cfg)
    emb, pos, _tok = vlm_inputs(eng.model.embed.table, VLM_PREFILL,
                                SEED + 22)
    s = emb.shape[1]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    with torch.no_grad():
        logits = soniq.apply(state, embeds=emb, positions=pos)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    launches["b1_vlm_prefill"] = counts[B1]
    if counts[B1] != n_lin or counts[B2] or counts[B3] or counts[B8]:
        raise AssertionError(f"multimodal prefill launches {counts}")
    if logits.shape != (1, s, cfg.vocab_size) \
            or not torch.isfinite(logits).all():
        raise AssertionError(f"multimodal logits {tuple(logits.shape)} not "
                             f"finite")
    del logits
    st["prefill"] = profile_apply(state, emb, pos)
    st["prefill"].update(tokens=s, peak_gib=torch.cuda.max_memory_allocated()
                         / 2 ** 30, layout=[list(x) for x in VLM_PREFILL])
    log(f"[22] multimodal prefill ({s} tokens, M-RoPE streams, chunked "
        f"attention): {counts[B1]} B1 launches; {st['prefill']}")
    tokens = torch.randint(0, cfg.vocab_size, (1, s), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(
                               SEED + 23))
    rows = torch.nn.functional.embedding(tokens, eng.model.embed.table).to(
        torch.bfloat16)
    flat = torch.arange(s, device=dev)[None]
    with torch.no_grad():
        a = soniq.apply(state, tokens, positions=flat)
        b = soniq.apply(state, embeds=rows, positions=flat[None].expand(
            3, 1, s))
    if not torch.equal(a, b):
        raise AssertionError(f"table-row embeds at equal streams != the "
                             f"tokens path: max |diff| "
                             f"{(a - b).abs().max().item()}")
    st["equal_streams_bitwise"] = True
    del a, b, rows, state, eng
    gc.collect()
    torch.cuda.empty_cache()
    log("[22] table-row embeddings at three equal streams == the tokens path "
        "at [1, S] positions, bitwise")
    lap("prefill")
    st["card_vs_cpu"] = check_vlm_against_cpu(dev, ecfg)
    log(f"[22] one full-width layer, card vs CPU (fp32, relative L2): "
        f"{st['card_vs_cpu']}")
    lap("card_vs_cpu")
    st["seconds"] = laps
    return st


def vlm_batches(table, n, seed):
    """``n`` training batches of VLM_TRAIN_BATCH rows of ``VLM_TRAIN``:
    embeddings bf16 (``vlm_inputs``), M-RoPE streams, labels (the text's
    tokens, -1 on the image)."""
    mask = torch.as_tensor(vision_mask(VLM_TRAIN), device=table.device)
    out = []
    for i in range(n):
        emb, pos, tok = vlm_inputs(table, VLM_TRAIN, seed + i,
                                   batch=VLM_TRAIN_BATCH)
        out.append({"embeds": emb, "positions": pos,
                    "labels": torch.where(mask[None], -1, tok)})
    return out


def _vlm_train(cfg, dev, tag="22"):
    """Phase 22(d)'s run: a model from the seed (mixed logits) and
    T2 + 1 batches made from its table (``vlm_batches``); T1 Phase-I
    steps, the freeze and T2 - T1 Phase-II steps through ``loop.train``,
    every step's B8/B9 launches checked, then one 2-microbatch Phase-II
    step hoisted. Returns (the state, per-step records, the report, the
    table's first 64 rows before training, on the host)."""
    from repro_torch.train import state as state_lib
    tcfg = state_lib.TrainConfig(t1=T1, t2=T2, warmup=1, seed=SEED)
    counted = {"b8": B8, "b9": B9, "b8_bwd": B8_BWD, "b9_bwd": B9_BWD}
    records, prev = [], dict.fromkeys(counted.values(), 0)

    def record(step, phase, met):
        counts = kernels.launch_counts()
        rec = dict(step=step, phase=phase, loss=float(met["loss"]),
                   grad_norm=float(met["grad_norm"]),
                   lr_scale=float(met["lr_scale"]),
                   ms=float(met.get("wall", 0.0)) * 1e3,
                   peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        rec.update({key: counts[name] - prev[name]
                    for key, name in counted.items()})
        prev.update({name: counts[name] for name in counted.values()})
        records.append(rec)
        torch.cuda.reset_peak_memory_stats()
        log(f"[{tag}] step {step} phase {phase}: loss {rec['loss']:.4f} "
            f"gnorm {rec['grad_norm']:.4f} {rec['ms']:.1f} ms, launches "
            f"{ {k: rec[k] for k in counted} }, peak "
            f"{rec['peak_gib']:.2f} GiB")

    model = lm.init_params(cfg.with_quant_mode("noise"), seed=SEED + 22,
                           device=dev)
    set_mixed_logits(model, SEED + 22)
    table0 = model.embed.table[:64].detach().cpu()
    batches = vlm_batches(model.embed.table.detach(), T2 + 1, SEED + 25)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    out = loop.train(cfg, tcfg, iter(batches[:T2]), model=model, device=dev,
                     hooks=[lambda s, _st, m: record(s, m["phase"], m)])
    del model
    state = out["state"]
    for r in records:
        want = train_step_launches(cfg, r["phase"])
        if not math.isfinite(r["loss"]) or any(r[k] != x
                                               for k, x in want.items()):
            raise AssertionError(f"step {r['step']}: loss {r['loss']}, "
                                 f"launches {r}, wanted {want}")
    qcfg = cfg.with_quant_mode("qat")
    mb = state_lib.TrainConfig(t1=T1, t2=T2 + 1, warmup=1, seed=SEED,
                               num_microbatches=2, hoist_weight_quant=True)
    t0 = time.perf_counter()
    state, met = state_lib.train_step(state, batches[T2], qcfg, mb)
    torch.cuda.synchronize()
    record(T2, 2, dict(met, wall=time.perf_counter() - t0))
    n = VLM_LINEARS * cfg.num_layers
    if records[-1]["b8"] != 5 * n or records[-1]["b8_bwd"] != 3 * n \
            or not math.isfinite(records[-1]["loss"]):
        raise AssertionError(f"the hoisted 2-microbatch step: "
                             f"{records[-1]}")
    return state, records, out["pattern_report"], table0


def _table_decayed(table0, table, records, adamw_cfg):
    """The trained table's first rows against the host's replay of AdamW's
    decoupled decay on a zero gradient (the update ``mu / c1 / (sqrt(nu /
    c2) + eps)`` is 0), step by step at each step's lr scale: bitwise."""
    p = table0.clone()
    for r in records:
        lr = torch.tensor(adamw_cfg.lr, dtype=torch.float32) * torch.tensor(
            r["lr_scale"], dtype=torch.float32)
        update = torch.zeros_like(p) + adamw_cfg.weight_decay * p.float()
        p = (p.float() - lr * update).to(p.dtype)
    return torch.equal(p, table), (table - table0).abs().max().item()


def phase_vlm_training(dev, results):
    """Phase 22(d): train qwen2-vl-72b at full width cut to
    VLM_TRAIN_LAYERS layer beside the embedding table and the untied
    readout (3.37 B parameters: ~54 GB of fp32 parameters, gradients and
    AdamW moments; two layers would need ~68 GB before activations) on
    embeddings [4, 384, 8192] bf16 (64 text, a 16 x 16 image, 64 text;
    labels -1 on the image) and M-RoPE streams: the logits over the
    4/2/1-bit bands, T1 Phase-I steps, the freeze, T2 - T1 Phase-II steps
    through ``loop.train`` (every step's launches checked), then one
    2-microbatch Phase-II step hoisted (peak memory kept); a second run
    bitwise the first (losses, gradient norms, pbits, every parameter);
    the table, which no step reads, decayed as AdamW decays it on a zero
    gradient (bitwise the host's replay on its first rows); then
    ``soniq.to_serve`` (7 B7) and ``soniq.apply`` on the served model over
    ``VLM_CPU``. Returns the numbers."""
    from repro_torch import soniq
    from repro_torch.api.state import SoniqState
    from repro_torch.core.phases import Phase
    from repro_torch.optim.adamw import AdamWConfig
    cfg = dataclasses.replace(get_config(VLM_ARCH),
                              num_layers=VLM_TRAIN_LAYERS)
    laps, t_lap = {}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        laps[name] = round(now - t_lap[0], 2)
        t_lap[0] = now

    gc.collect()
    torch.cuda.empty_cache()
    runs = []
    for i in range(2):
        state, records, rep, table0 = _vlm_train(cfg, dev)
        model = state["model"]
        state["opt"] = None
        del state
        gc.collect()
        torch.cuda.empty_cache()
        decayed, moved = _table_decayed(
            table0, model.embed.table[:64].detach().cpu(), records,
            AdamWConfig())
        if not decayed:
            raise AssertionError(f"run {i}: the table's decay differs from "
                                 f"AdamW's on a zero gradient")
        if i == 0:
            first = ([p.detach().cpu() for p in model.parameters()],
                     [lin.pbits.cpu() for _n, lin in smol.smol_linears(model)
                      if "pbits" in lin._names], records, rep)
            del model
            gc.collect()
            torch.cuda.empty_cache()
        lap(f"run_{i}")
    params, pbits, rec1, rep1 = first
    same = [(r["loss"], r["grad_norm"]) for r in rec1] == \
        [(r["loss"], r["grad_norm"]) for r in records]
    params_same = all(torch.equal(a.to(dev), b.detach())
                      for a, b in zip(params, model.parameters()))
    pbits_same = all(torch.equal(a, lin.pbits.cpu()) for a, (_n, lin) in zip(
        pbits, [x for x in smol.smol_linears(model) if "pbits" in x[1]._names]))
    if not (same and params_same and pbits_same
            and rep1["layers"] == rep["layers"]):
        raise AssertionError(f"a second qwen2-vl training run differs: "
                             f"losses {same}, parameters {params_same}, "
                             f"pbits {pbits_same}")
    del params, first
    out = {"layers": cfg.num_layers, "params": sum(
        p.numel() for p in model.parameters()),
        "batch": [VLM_TRAIN_BATCH, len(vision_mask(VLM_TRAIN)), cfg.d_model],
        "steps": records, "peak_gib": max(r["peak_gib"] for r in records),
        "histogram": precision_histogram(model),
        "average_bpp": schedule.average_bpp(rep),
        "second_run_bitwise": True, "table_decay_bitwise": True,
        "table_max_move": moved,
        "launches_per_step": {p: train_step_launches(cfg, p)
                              for p in (1, 2)}}
    for name, key in ((B8, "b8"), (B9, "b9"), (B8_BWD, "b8_bwd"),
                      (B9_BWD, "b9_bwd")):
        results[name]["vlm_train_run_launches"] = sum(r[key]
                                                      for r in records)
        results[name]["vlm_train_launches_per_step"] = max(
            r[key] for r in records[:-1])
    log(f"[22] {cfg.num_layers} layer + table + readout "
        f"({out['params']:,} parameters): peak {out['peak_gib']:.2f} GiB; "
        f"a second run bitwise (losses, gradient norms, pbits, parameters);"
        f" the table decayed as AdamW on a zero gradient (bitwise); frozen "
        f"groups {out['histogram']}, average bpp {out['average_bpp']:.4f}")
    lap("second_run_check")
    qcfg = cfg.with_quant_mode("qat")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    served = soniq.to_serve(SoniqState(Phase.QAT, model, qcfg))
    torch.cuda.synchronize()
    out["to_serve_s"] = time.perf_counter() - t0
    out["to_serve_b7"] = kernels.launch_counts()[B7]
    if out["to_serve_b7"] != VLM_LINEARS * cfg.num_layers:
        raise AssertionError(f"{out['to_serve_b7']} B7 launches at to_serve")
    emb, pos, _tok = vlm_inputs(served.model.embed.table, VLM_CPU, SEED + 26)
    with torch.no_grad():
        lg = soniq.apply(served, embeds=emb, positions=pos)
    if lg.shape != (1, emb.shape[1], cfg.vocab_size) \
            or not torch.isfinite(lg).all():
        raise AssertionError("served trained qwen2-vl: logits not finite")
    out["served_argmax"] = lg[0, -8:].argmax(-1).tolist()
    del served, model, lg
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[22] to_serve: {out['to_serve_b7']} B7 launches in "
        f"{out['to_serve_s']:.3f} s; apply over {emb.shape[1]} multimodal "
        f"tokens finite")
    lap("serve")
    out["seconds"] = laps
    return out


def phase_vlm(dev, gen, results, launches, per_step):
    """Phase 22: the VLM family (qwen2-vl-72b). (a) the kernels at its
    shapes (``phase_vlm_kernels``); (b), (c) serving, the multimodal
    prefill and the card-vs-CPU check (``phase_vlm_serve``); (d) training
    (``phase_vlm_training``). Returns the ``vlm`` JSON line's numbers."""
    cfg = get_config(VLM_ARCH)
    t0 = time.perf_counter()
    phase_vlm_kernels(cfg, QuantConfig(mode="qat"), gen, dev, results)
    kernels_s = round(time.perf_counter() - t0, 2)
    out = {"serve": phase_vlm_serve(dev, np.random.default_rng(SEED + 22),
                                    results, launches, per_step)}
    out["training"] = phase_vlm_training(dev, results)
    out["serve"]["seconds"]["kernels"] = kernels_s
    return out


# ---------------------------------------------------------------- hybrid ----
HYBRID_ARCH = "jamba-1.5-large-398b"
HYBRID_UNITS = 1             # phase 23's depth: one 8-sublayer unit of 9
HYBRID_EXPERTS = 8           # experts a MoE sublayer (the config has 16)
# Phase 23(e)'s teacher-forced sublayers of the unit: a Mamba2 mixer with
# the MLP and the attention sublayer with the MoE, every part of a unit.
HYBRID_CPU_SUBLAYERS = (0, 3)
HYBRID_CPU_TOKENS = 4


def hybrid_cfg():
    """jamba-1.5-large-398b at its published widths, cut to HYBRID_UNITS
    units of 8 sublayers and HYBRID_EXPERTS experts a MoE sublayer (the
    router narrowed to them); bf16 parameters and compute; QAT (the
    engine packs it)."""
    base = get_config(HYBRID_ARCH)
    return dataclasses.replace(base, num_layers=base.attn_every
                               * HYBRID_UNITS,
                               num_experts=HYBRID_EXPERTS
                               ).with_quant_mode("qat")


def hybrid_plan(cfg):
    """Per unit: the packed leaves (one B7 launch each at load), and a
    decode step's B1 (every dense linear), B6 and B8 (one each an expert
    bank: B8 over its dispatch buffer) and attention launches."""
    kinds = cfg.hybrid_unit_kinds()
    mixers = sum(k.startswith("mamba") for k in kinds)
    attn = len(kinds) - mixers
    moe = sum(k.endswith("moe") for k in kinds)
    mlp = len(kinds) - moe
    b1 = 2 * mixers + 4 * attn + 3 * mlp
    units = cfg.num_layers // cfg.attn_every
    return dict(b7=units * (b1 + 3 * moe), b1=units * b1, b6=units * 3 * moe,
                b8=units * 3 * moe, attn=units * attn)


def hybrid_shapes(cfg):
    """{group: [(name, K, N) or (name, E, K, N)]}: one mixer's, one
    attention sublayer's and one dense MLP's serve linears, and one
    expert bank."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    di, n = cfg.d_inner, cfg.ssm_state
    hq, hk = cfg.num_heads * cfg.hd, cfg.num_kv_heads * cfg.hd
    return {"mixer": [("in_proj", d, 2 * di + 2 * n + di // 64),
                      ("out_proj", di, d)],
            "attention": [("wq", d, hq), ("wk", d, hk), ("wv", d, hk),
                          ("wo", hq, d)],
            "mlp": [("gate", d, f), ("up", d, f), ("down", f, d)],
            "bank": [("up", e, d, f)]}


def hybrid_pack(shapes, qcfg, gen, dev):
    """B7 on bf16 weights of ``shapes`` (one launch each, rows read
    through a random channel perm): bitwise its plain version and bitwise
    the fp32 launch on the widened weights; timed on both rulers against
    the byte bound at 2 bytes an element read, beside the fp32 launches
    on the widened weights and torch's group abs-max over the same bf16
    weights (``transforms.group_absmax``, one read of each: the
    yardstick)."""
    calls = []
    for _name, *shape in shapes:
        w, perm, sc, segs = pack_operands(tuple(shape), qcfg, gen, dev)
        calls.append((w.bfloat16(), perm, sc, segs))
        del w
    _check_pack(calls)
    wide = [(w.float(), perm, sc, segs) for w, perm, sc, segs in calls]
    for (w, *_r, segs), got, want in zip(calls, _pack_layer(calls),
                                          _pack_layer(wide)):
        for a, b in zip(got, want):
            if not torch.equal(a, b):
                raise AssertionError(f"B7 on bf16 {tuple(w.shape)} {segs} "
                                     f"!= the fp32 launch on its widening")
    b_ms, b_by = _pack_bound(calls)
    reps = 3 if calls[0][0].numel() > 1e9 else 10
    from repro_torch.api.transforms import group_absmax
    def absmax():
        return [group_absmax(w.reshape((-1,) + w.shape[-2:]), 16)
                for w, *_r in calls]

    out = dict(ms=time_ms(lambda: _pack_layer(calls), reps),
               device_ms=device_ms(lambda: _pack_layer(calls), reps),
               fp32_device_ms=device_ms(lambda: _pack_layer(wide), reps),
               plain_ms=time_ms(lambda: _pack_layer_plain(calls), 1),
               bound_ms=b_ms, bound_by=b_by, launches=len(calls),
               absmax_ms=time_ms(absmax, reps),
               absmax_device_ms=device_ms(absmax, reps),
               weight_bytes=sum(w.numel() * 2 for w, *_r in calls))
    del calls, wide
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_hybrid_kernels(cfg, qcfg, gen, dev, results):
    """Phase 23(a), into ``results`` (``jamba_*`` keys): B7 on bf16
    weights (``hybrid_pack``) of one mixer (in_proj 8192 x 33280, out_proj
    16384 x 8192), one attention sublayer (8192 x 8192 q/o, 8192 x 1024
    k/v), one dense MLP (8192 <-> 24576) and one expert bank [8, 8192,
    24576]; B1 on the mixer's and the MLP's linears at M = 4 (decode), 16
    (the verify of k = 3 at batch 4) and 32 (an 8-lane prefill at batch
    4) within the fp32 reordering bound, beside torch.matmul; B6 on one
    MoE sublayer's three banks (E = 8, T = 4: every row live, and the
    live rows of a top-2 route of 4 tokens) within the bound, beside
    torch.bmm."""
    shapes = hybrid_shapes(cfg)
    for group, sh in shapes.items():
        rec = hybrid_pack(sh, qcfg, gen, dev)
        results[B7].update({f"jamba_{group}_{k}": v for k, v in rec.items()})
        log(f"[23] {B7} on bf16, one {group} ({rec['launches']} launches, "
            f"{rec['weight_bytes']:,} weight bytes): bitwise plain and the "
            f"fp32 launch; {rec}")
    b1_shapes = shapes["mixer"] + shapes["mlp"]
    for m in (4, 4 * (SPEC_TOKENS + 1), 32):
        sets = [LayerOperands(cfg, qcfg, m, gen, dev, b1_shapes)
                for _ in range(2)]
        err = check_segment_gemm(B1, sets[:1])
        res = time_segment_gemm(B1, sets)
        results[B1].update({f"jamba_M{m}_{k}": v for k, v in res.items()},
                           **{f"jamba_M{m}_max_abs_err": err})
        log(f"[23] {B1} at M={m} on in_proj, out_proj, gate, up, down "
            f"(5 launches): max |err| {err:.3e} within the fp32 bound; {res}")
        del sets
        gc.collect()
        torch.cuda.empty_cache()
    ops = GroupedOperands(cfg, qcfg, 4, gen, dev)
    res = phase_grouped_segment(ops)
    results[B6].update({f"jamba_{k}": v for k, v in res.items()})
    log(f"[23] {B6} on one MoE sublayer's 3 banks (E={cfg.num_experts}, "
        f"T=4): within the fp32 bound, each expert bitwise the dense "
        f"launch, rows= bitwise on live rows; {res}")
    del ops
    gc.collect()
    torch.cuda.empty_cache()


def hybrid_spec_serve(model, cfg, ecfg, reqs, want, dev, plan):
    """Speculative decoding (k = SPEC_TOKENS, draft bits DRAFT_BITS) of the
    hybrid on ``reqs`` over ``ecfg``'s cache: the snapshot/recommit round
    drafts k steps, verifies k + 1 lanes and re-feeds the accepted ones,
    five forwards a drafting round (one B1 launch a dense linear and one
    B6 an expert bank each: asserted). Its greedy tokens must equal
    ``want`` (spec-off). The verify lanes run the mixers' chunked SSD
    where spec-off decodes token by token, different sums that agree
    until an activation code flips (none does on these requests; the
    SSM's phase 18 reports agreement instead at 8 layers of 64).
    Returns ``spec_stats``, round ms, tokens/s and the launches of a
    round."""
    eng = engine.DecodeEngine(model, cfg, dataclasses.replace(
        ecfg, spec_tokens=SPEC_TOKENS, spec_draft_bits=DRAFT_BITS),
        already_serve=True, device=dev)
    drafts = backend.draft_matmul_call_count()
    round_counts = {}
    out, wall, round_ms = timed_serve(eng, reqs, round_counts)
    st = eng.spec_stats()
    if st["rounds"] == 0 or backend.draft_matmul_call_count() == drafts:
        raise AssertionError(f"no draft ran: {st}")
    forwards = SPEC_TOKENS + 2
    for name, per in ((B1, plan["b1"]), (B6, plan["b6"])):
        if round_counts.get(name) != forwards * per:
            raise AssertionError(f"{round_counts.get(name)} {name} launches "
                                 f"a drafting round, not {forwards * per}")
    _same_tokens("jamba spec tokens != spec-off tokens", want, out)
    new = sum(c.new_tokens.size for c in out)
    return dict(spec=st, tok_s=new / wall, wall_s=wall, round_ms=round_ms,
                round_launches=round_counts)


def hybrid_sublayers(stack, cfg, x, dev):
    """x [1, S, D] through the sublayers of ``stack`` (a chunked step at
    positions 0 .. S - 1 from fresh caches, as ``lm.prefill_step`` runs
    them): each sublayer's output in float64 on the host."""
    s = x.shape[1]
    pos = np.arange(s)[None]
    posb = torch.as_tensor(pos, device=dev)
    caches = [blocks_lib.block_cache_init(b.kind, cfg, 1, 64,
                                          torch.float32, device=dev)
              for b in stack]
    kv = next(c["kv"] for c in caches if "kv" in c)
    rope = lm._rope(cfg, posb)
    write = attention.cache_write_index(kv, pos, dev)
    out = []
    with torch.no_grad():
        for b, c in zip(stack, caches):
            x = blocks_lib.block_decode(b, x, c, posb, cfg, cfg.quant,
                                        rope=rope, write=write)
            out.append(x.double().cpu())
    return out


def check_hybrid_against_cpu(dev, ecfg, model, cfg):
    """Phase 23(e): the card against the plain versions on the CPU.
    (1) The reduced config (one unit at d_model 128, 4 experts, fp32):
    the greedy tokens of 4 requests identical. (2) Full width: the served
    model's sublayers HYBRID_CPU_SUBLAYERS (a mixer with the MLP, the
    attention sublayer with the MoE: every part of the unit) copied to
    the host, packed as they are, at fp32
    compute over HYBRID_CPU_TOKENS tokens, teacher-forced (``LinearTape``,
    ``SSDTape``): every serve linear, router and expert bank on the CPU's
    input and each input as the card's own ops made it, the chunked SSD's
    output and state on the CPU's arguments, each sublayer's output,
    within relative L2 1e-5. Returns the numbers."""
    out = {}
    small = get_config(HYBRID_ARCH).reduced().with_quant_mode("qat")
    red = engine.DecodeEngine(lm.init_params(small, seed=SEED + 23,
                                             device=dev), small, ecfg,
                              device=dev)
    host = engine.DecodeEngine(copy.deepcopy(red.model).to("cpu"), small,
                               ecfg, already_serve=True, device="cpu")
    reqs = requests(small.vocab_size, np.random.default_rng(SEED + 23),
                    n=4, lo=8, hi=16, new=8)
    card_out, _ = serve_all(red, reqs)
    cpu_out = {c.request_id: c for c in host.serve(
        [dataclasses.replace(r) for r in reqs])}
    base = min(cpu_out)
    for i, c in enumerate(card_out):
        if not np.array_equal(c.tokens, cpu_out[base + i].tokens):
            raise AssertionError(f"reduced hybrid card != CPU tokens "
                                 f"(request {i}): {c.new_tokens} vs "
                                 f"{cpu_out[base + i].new_tokens}")
    out["reduced_tokens_identical"] = len(reqs)
    del red, host
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    card = torch.nn.ModuleList(model.blocks[i]
                               for i in HYBRID_CPU_SUBLAYERS)
    cpu = copy.deepcopy(card).to("cpu")
    x = torch.randn((1, HYBRID_CPU_TOKENS, cfg.d_model),
                    generator=torch.Generator().manual_seed(SEED + 23))
    tape_cpu, ssd_cpu = LinearTape(cpu), SSDTape()
    t0 = time.perf_counter()
    try:
        want = hybrid_sublayers(cpu, cfg32, x, "cpu")
    finally:
        tape_cpu.close()
        ssd_cpu.close()
    out["cpu_s"] = time.perf_counter() - t0
    tape_card, ssd_card = LinearTape(card, feed=tape_cpu.inputs), \
        SSDTape(feed=ssd_cpu)
    try:
        got = hybrid_sublayers(card, cfg32, x.to(dev), dev)
    finally:
        tape_card.close()
        ssd_card.close()
    calls = len(tape_cpu.inputs)
    mixers = sum(model.blocks[i].mixer == "mamba"
                 for i in HYBRID_CPU_SUBLAYERS)
    if len(tape_card.inputs) != calls or len(ssd_card.outputs) != mixers \
            or len(ssd_cpu.outputs) != mixers:
        raise AssertionError(f"calls: card {len(tape_card.inputs)}, CPU "
                             f"{calls}; SSD {len(ssd_card.outputs)}, "
                             f"{len(ssd_cpu.outputs)}")
    worst = {}
    for (name, _lin, x_card), (_n, _l, x_cpu), y_card, y_cpu in zip(
            tape_card.inputs, tape_cpu.inputs, tape_card.outputs,
            tape_cpu.outputs):
        kind = ".".join(name.split(".")[-2:])
        for what, a, b in (("out", y_card, y_cpu), ("in", x_card, x_cpu)):
            key = f"{kind}.{what}"
            worst[key] = max(worst.get(key, 0.0), rel_l2(a, b))
    for (y_c, h_c), (y_h, h_h) in zip(ssd_card.outputs, ssd_cpu.outputs):
        worst["ssd.y"] = max(worst.get("ssd.y", 0.0), rel_l2(y_c, y_h))
        worst["ssd.h"] = max(worst.get("ssd.h", 0.0), rel_l2(h_c, h_h))
    for i, a, b in zip(HYBRID_CPU_SUBLAYERS, got, want):
        worst[f"sublayer{i}.out"] = rel_l2(a, b)
    out["full_width_sublayers"] = worst
    out["full_width_calls"] = calls
    del card, cpu
    gc.collect()
    bad = {k: v for k, v in worst.items() if not v <= 1e-5}
    if bad:
        raise AssertionError(f"hybrid card vs CPU over 1e-5: {bad}")
    return out


def phase_hybrid(dev, gen, results, launches, per_step):
    """Phase 23: serve the hybrid family, jamba-1.5-large-398b at its
    published widths (d_model 8192, 64 heads of 128 over 8, d_ff 24576,
    d_inner 16384, 256 SSD heads of 64, state 128, vocab 65536 untied,
    top-2 routing, bf16 parameters and compute), cut to HYBRID_UNITS unit
    of 8 sublayers (Mamba2 mixers, one attention sublayer; MLPs and MoEs)
    and HYBRID_EXPERTS experts a MoE sublayer. (a) The kernels at its
    shapes (``phase_hybrid_kernels``). (b) The DecodeEngine's load of the
    bf16 QAT tree (random weights of the seed): one B7 launch a linear
    and a bank (asserted), ``pack_s``, device busy, peak memory. (c) 8
    requests of 16-64 prompt tokens and 16 new at batch 4 (cache_len
    256): the fp ring at chunk 8 twice (bitwise), chunk 1 and lockstep
    (agreement reported), the 4-bit ring and pool (tokens equal), the fp
    pool (tokens equal the fp ring's), speculatively (k = 3) on the fp
    ring and the 4-bit pool (tokens equal spec-off's); every
    decode step's B1, B6, B8 and B4/B5 launches asserted from the plan;
    the snapshot's bytes. (d) A decode step and an 8-lane prefill step
    profiled by op (``step_profile.HYBRID_SPANS``). (e) Card vs CPU
    (``check_hybrid_against_cpu``). Returns the ``hybrid`` JSON line's
    numbers."""
    cfg = hybrid_cfg()
    qcfg = QuantConfig(mode="qat")
    plan = hybrid_plan(cfg)
    laps, t_lap = {}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        laps[name] = round(now - t_lap[0], 2)
        t_lap[0] = now

    phase_hybrid_kernels(cfg, qcfg, gen, dev, results)
    lap("kernels")
    st = {"units": cfg.num_layers // cfg.attn_every,
          "sublayers": list(cfg.hybrid_unit_kinds()),
          "experts": cfg.num_experts, "plan": plan}
    ecfg = engine.EngineConfig(max_batch=4, cache_len=256, prefill_chunk=8)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = lm.init_params(cfg, seed=SEED + 23, device=dev)
    torch.cuda.synchronize()
    st["parameters"] = sum(p.numel() for p in params.parameters())
    st["qat_tree_gib"] = sum(p.numel() * p.element_size()
                             for p in params.parameters()) / 2 ** 30
    st["init_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    eng = engine.DecodeEngine(params, cfg, ecfg, device=dev)
    torch.cuda.synchronize()
    st["pack_s"] = time.perf_counter() - t0
    st["peak_gib_init_and_pack"] = torch.cuda.max_memory_allocated() / 2 ** 30
    launches["b7_jamba_load"] = kernels.launch_counts()[B7]
    if launches["b7_jamba_load"] != plan["b7"] \
            or packed_leaves(eng.model) != plan["b7"]:
        raise AssertionError(f"{launches['b7_jamba_load']} B7 launches at "
                             f"the jamba load, not one a linear and a bank "
                             f"({plan['b7']})")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    eng, prof = profile_load(lambda: engine.DecodeEngine(params, cfg, ecfg,
                                                         device=dev))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    st["load"] = dict(device_busy_ms=prof["device_busy_ms"],
                      device_events=prof["device_events"],
                      idle_share=1 - prof["device_busy_ms"]
                      / (st["pack_s"] * 1e3), by_op=prof["by_op"])
    st["packed_bytes"] = engine.packed_model_bytes(eng.model)
    st["resident_gib"] = torch.cuda.memory_allocated() / 2 ** 30
    log(f"[23] {HYBRID_ARCH}, {st['units']} unit x 8 sublayers, "
        f"{cfg.num_experts} experts: {st['parameters']:,} parameters "
        f"({st['qat_tree_gib']:.2f} GiB bf16); pack_s {st['pack_s']:.3f}, "
        f"{launches['b7_jamba_load']} B7 launches, peak "
        f"{st['peak_gib_init_and_pack']:.2f} GiB; packed "
        f"{st['packed_bytes']:,} bytes; {st['load']}")
    if st["peak_gib_init_and_pack"] * 2 ** 30 > 80e9:
        raise AssertionError(f"load peak {st['peak_gib_init_and_pack']:.2f} "
                             f"GiB over 80 GB")
    lap("load")
    # (c) Serving.
    rng = np.random.default_rng(SEED + 23)
    reqs = requests(cfg.vocab_size, rng)
    kernels.reset_launch_counts()
    ring, wall1 = serve_all(eng, reqs)
    counts = kernels.launch_counts()
    launches.update(b1_jamba_serve=counts[B1], b6_jamba_serve=counts[B6],
                    b8_jamba_serve=counts[B8])
    if counts[B1] == 0 or counts[B6] == 0 or counts[B8] == 0 or counts[B2] \
            or counts[B3] or counts[B4] or counts[B5]:
        raise AssertionError(f"jamba fp ring launches {counts}")
    for c in ring:
        if c.new_tokens.size != 16 or not (
                (c.new_tokens >= 0) & (c.new_tokens < cfg.vocab_size)).all():
            raise AssertionError(f"bad jamba completion {c.new_tokens}")
    again, wall2 = serve_all(eng, reqs)
    _same_tokens("jamba: a second identical run gave other tokens", ring,
                 again)
    new = sum(c.new_tokens.size for c in ring)
    step = step_launches(eng)
    for name, key in ((B1, "b1"), (B6, "b6"), (B8, "b8")):
        per_step[f"{key}_jamba"] = step[name]
        if step[name] != plan[key]:
            raise AssertionError(f"{step[name]} {name} launches a jamba "
                                 f"decode step, not {plan[key]}")
    if step[B4] or step[B5]:
        raise AssertionError(f"jamba fp decode step launches {step}")
    st["fp_ring"] = dict(tok_s=new / wall2, wall_s=[wall1, wall2],
                         steps=eng.sched.step_count,
                         decode_step_ms=decode_step_ms(eng),
                         snapshot_bytes=lm.seq_state_bytes(
                             lm.extract_seq_state(eng.cache)),
                         launches_per_decode_step={
                             k: v for k, v in step.items() if v})
    log(f"[23] fp ring: {len(reqs)} requests ({new} new tokens; a second "
        f"run bitwise): {st['fp_ring']}; tokens[0] "
        f"{ring[0].new_tokens[:8]}")
    lap("fp_ring")
    st["profile"] = ssm_profile_steps(eng, spans=step_profile.HYBRID_SPANS,
                                      summary=step_profile.hybrid_summary)
    log(f"[23] step profiles: {st['profile']}")
    lap("profiles")
    one = engine.DecodeEngine(eng.model, cfg, dataclasses.replace(
        ecfg, prefill_chunk=1), already_serve=True, device=dev)
    out1, wall = serve_all(one, reqs[:4])
    st["chunk1"] = dict(
        tok_s=sum(c.new_tokens.size for c in out1) / wall,
        agreement=_agreement([c.new_tokens for c in ring[:4]],
                             [c.new_tokens for c in out1]))
    del one
    cut = [dataclasses.replace(r, prompt=r.prompt[:16]) for r in reqs[:4]]
    cut_out, _ = serve_all(eng, cut)
    lock = engine.LockstepEngine(eng.model, cfg, ecfg, already_serve=True,
                                 device=dev)
    t0 = time.perf_counter()
    grid = lock.generate(np.stack([r.prompt for r in cut]), 16)
    wall = time.perf_counter() - t0
    st["lockstep"] = dict(tok_s=grid[:, 16:].size / wall,
                          agreement=_agreement(
                              [c.new_tokens for c in cut_out], grid[:, 16:]))
    del lock
    log(f"[23] chunk 1: {st['chunk1']}; lockstep: {st['lockstep']}")
    lap("chunk1_lockstep")
    forms = {}
    for tag, kw in (("kv4_ring", dict(kv_bits=4)),
                    ("kv4_pool", dict(kv_bits=4, kv_layout="paged",
                                      page_size=16)),
                    ("fp_pool", dict(kv_layout="paged", page_size=16))):
        e = engine.DecodeEngine(eng.model, cfg, dataclasses.replace(
            ecfg, **kw), already_serve=True, device=dev)
        kernels.reset_launch_counts()
        forms[tag], wall = serve_all(e, reqs)
        counts = kernels.launch_counts()
        step = step_launches(e)
        want = {"kv4_ring": (plan["attn"], 0), "kv4_pool": (0, plan["attn"]),
                "fp_pool": (0, 0)}[tag]
        if (step[B4], step[B5]) != want or step[B1] != plan["b1"] \
                or step[B6] != plan["b6"]:
            raise AssertionError(f"jamba {tag} decode step launches {step}")
        st[tag] = dict(tok_s=new / wall, wall_s=wall, serve_launches={
            k: v for k, v in counts.items() if v})
        if e.pool is not None:
            e.pool.check()
            st[tag]["pool"] = e.paged_kv_stats()
        if tag == "kv4_ring":
            launches["b4_jamba_kv4_serve"] = counts[B4]
            per_step["b4_jamba"] = step[B4]
        elif tag == "kv4_pool":
            launches["b5_jamba_paged_serve"] = counts[B5]
            per_step["b5_jamba"] = step[B5]
        del e
    _same_tokens("jamba 4-bit pool != 4-bit ring", forms["kv4_ring"],
                 forms["kv4_pool"])
    _same_tokens("jamba fp pool != fp ring", ring, forms["fp_pool"])
    st["kv4_ring"]["agreement_with_fp"] = _agreement(
        [c.new_tokens for c in ring],
        [c.new_tokens for c in forms["kv4_ring"]])
    log(f"[23] 4-bit ring, 4-bit pool (== ring), fp pool (== fp ring): "
        f"{ {k: st[k] for k in forms} }")
    lap("kv_forms")
    pool_ecfg = dataclasses.replace(ecfg, kv_bits=4, kv_layout="paged",
                                    page_size=16)
    e = engine.DecodeEngine(eng.model, cfg, pool_ecfg, already_serve=True,
                            device=dev)
    cut_pool, _ = serve_all(e, cut)
    del e
    st["spec"] = {}
    for tag, e_cfg, want in (("fp_ring", ecfg, cut_out),
                             ("kv4_pool", pool_ecfg, cut_pool)):
        st["spec"][tag] = hybrid_spec_serve(eng.model, cfg, e_cfg, cut,
                                            want, dev, plan)
        log(f"[23] spec {tag}: {st['spec'][tag]}")
    per_step["b1_jamba_spec_round"] = \
        st["spec"]["fp_ring"]["round_launches"][B1]
    per_step["b6_jamba_spec_round"] = \
        st["spec"]["fp_ring"]["round_launches"][B6]
    lap("spec")
    st["card_vs_cpu"] = check_hybrid_against_cpu(dev, ecfg, eng.model,
                                                 eng.cfg)
    log(f"[23] card vs CPU (relative L2): {st['card_vs_cpu']}")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    lap("card_vs_cpu")
    st["seconds"] = laps
    log(f"[23] seconds by part: {laps}")
    return st


# ------------------------------------------------------- hybrid training ----
# Phase 24's card configuration: jamba-1.5-large-398b at its published
# widths (d_model 8192, 64 heads of 128 over 8, d_ff 24576, d_inner 16384,
# 256 SSD heads of 64, state 128, vocab 65536 untied, bf16 parameters and
# compute, fp32 moments), cut to one unit of two sublayers, a Mamba2 mixer
# with the dense MLP and GQA attention with the MoE (the kinds of the
# published unit's sublayers 2 and 3; attention 1:1 with the mixers, not
# 1:7), and 4 of its 16 experts (the router narrowed to them, top-2 kept).
# A whole 8-sublayer unit holds 16.15 B parameters even at 4 experts,
# ~194 GB of training state at 12 bytes a parameter: past one card.
HYBRID_TRAIN_CUT = dict(num_layers=2, attn_every=2, attn_offset=1,
                        moe_every=2, num_experts=4)
# Phase 24(d)'s FFN width (the MLP's and every expert's d_ff; the config's
# 24576) for the card-vs-CPU check: the CPU's plain B9 over the full
# banks would take minutes.
HYBRID_CPU_D_FF = 1536


def hybrid_train_cfg():
    """jamba-1.5-large-398b at its published widths cut as
    HYBRID_TRAIN_CUT says (bf16 parameters and compute)."""
    return dataclasses.replace(get_config(HYBRID_ARCH), **HYBRID_TRAIN_CUT)


def quantized_leaves(cfg) -> int:
    """Quantized linears and expert banks of an LM's blocks, by kind: an
    attention mixer's 4, a Mamba2 mixer's 2, a gated MLP's 3 (a gelu
    MLP's 2), a MoE's 3 banks (and its shared MLP's linears)."""
    mlp = 3 if cfg.mlp_act == "swiglu" else 2
    n = 0
    for kind in lm.block_kinds(cfg):
        n += 4 if blocks_lib.mixer_of(kind) == "attn" else 2
        ffn = blocks_lib.ffn_of(kind)
        if ffn == "moe":
            n += 3 + mlp * (cfg.num_shared_experts > 0)
        elif ffn == "mlp":
            n += mlp
    return n


def hybrid_freeze_channels(cfg):
    """Input channels of each row of the freeze's report in the
    reference's walk of a hybrid: plan group, sublayer (``sub{i}``), the
    path within it (sorted), the unit, then a bank's experts."""
    d, f, di = cfg.d_model, cfg.d_ff, cfg.d_inner
    units = cfg.num_layers // cfg.attn_every
    rows = []
    for kind in cfg.hybrid_unit_kinds():
        part = []
        if blocks_lib.mixer_of(kind) == "attn":
            part += [("attn.wk", d, 1), ("attn.wo", d, 1), ("attn.wq", d, 1),
                     ("attn.wv", d, 1)]
        else:
            part += [("mamba.in_proj", d, 1), ("mamba.out_proj", di, 1)]
        e = cfg.num_experts if blocks_lib.ffn_of(kind) == "moe" else 1
        ffn = blocks_lib.ffn_of(kind)
        part += [(f"{ffn}.down", f, e), (f"{ffn}.gate", d, e),
                 (f"{ffn}.up", d, e)]
        for _path, k, rows_a_unit in sorted(part):
            rows += [k] * (units * rows_a_unit)
    return rows


def hybrid_train_kernels(cfg, gen, dev, reps=5):
    """Phase 24(a): B9, B8 and their backward kernels at the card
    configuration's training shapes: the mixer's in_proj (8192 x 33280)
    and one expert bank [4, 8192, 24576]. B9 runs on the fp32 widening of
    bf16 weights (as ``smol._linear_noise`` hands them over), B8 on the
    bf16 weights as stored and on bf16 activations: 1024 rows (8 x 128
    tokens) of in_proj's input with per-row scales, and the bank's
    training dispatch buffer [4, 640, 8192] with a per-tensor scale an
    expert. Each bitwise its plain version (B9's ds within
    ``noise_inject.ds_bound``), the bank one launch each way and bitwise
    its experts' single launches; timed on both rulers beside the byte
    bound and torch's ``clone`` of the same tensors (the copy floor).
    Returns {kernel: record}."""
    d, e, f = cfg.d_model, cfg.num_experts, cfg.d_ff
    k_in, n_in = d, 2 * cfg.d_inner + 2 * cfg.ssm_state + cfg.d_inner // 64
    c = moe_capacity(cfg)
    w = torch.rand((k_in, n_in), generator=gen, device=dev) * 2.2 - 1.1
    w[0, :4] = torch.tensor([2.5, -2.5, 1.999, -1.0], device=dev)
    s = torch.randn((k_in // 16,), generator=gen, device=dev) * 2.0 - 0.5
    s[:2] = torch.tensor([8.0, -8.0], device=dev)
    seed = torch.randint(0, 1 << 32, (1,), generator=gen, device=dev)
    wb, sb, seeds = b9_bank_operands(e, d, f, gen, dev)
    b9_ops = [(w.bfloat16().float(), s, seed), (wb.bfloat16().float(), sb,
                                                 seeds)]
    del w, wb
    g9 = [torch.randn(o[0].shape, generator=gen, device=dev)
          for o in b9_ops]
    (w1, s1, sd1), (w2, s2, sd2) = b9_ops
    _check_equal("jamba in_proj B9 vs plain", ni.noise_inject(w1, s1, sd1),
                 ni.noise_inject_plain(w1, ni.group_sigma(s1), sd1))
    dw, ds = ni.noise_inject_bwd(w1, s1, sd1, g9[0])
    dw_p, ds_p = ni.noise_inject_bwd_plain(w1, s1, sd1, g9[0])
    _check_equal("jamba in_proj B9 backward dw vs plain", dw, dw_p)
    e_ds = (ds - ds_p).abs()
    if not (e_ds <= ni.ds_bound(w1, s1, sd1, g9[0])).all():
        raise AssertionError(f"jamba in_proj B9 backward ds off the plain "
                             f"version by {e_ds.max()}")
    ds_err = max(e_ds.max().item(),
                 check_bank_b9(w2, s2, sd2, g9[1], "jamba bank"))
    del dw, ds, dw_p, ds_p, e_ds
    gc.collect()
    torch.cuda.empty_cache()
    w8, pb8, _sw = b8_weight_operands(k_in, n_in, gen, dev)
    w8 = w8.bfloat16()
    (wb8, pbb, _swb), (xb, pbxb, sxb) = b8_bank_operands(e, d, f, c, gen,
                                                         dev)
    wb8 = wb8.bfloat16()
    weights = [(w8, pb8, quant.per_group_weight_scale(w8, 16)),
               (wb8, pbb, quant.per_group_weight_scale(wb8, 16))]
    acts = [b8_act_operands(TRAIN_BATCH * TRAIN_SEQ, k_in, gen, dev),
            (xb, pbxb, sxb)]
    del _sw, _swb
    wkw, xkw = dict(row_scale=False, k_dim=0), dict(row_scale=True)
    b8_calls = [(ops, wkw) for ops in weights] + [(ops, xkw) for ops in acts]
    g8 = [torch.randn(ops[0].shape, generator=gen, device=dev).to(
        torch.bfloat16) for ops, _kw in b8_calls]
    for (ops, kw), g in zip(b8_calls, g8):
        if ops[0].dim() == 3:
            check_bank_b8(*ops, g, kw, f"jamba {tuple(ops[0].shape)}")
            continue
        _check_equal(f"jamba B8 {tuple(ops[0].shape)} vs plain",
                     fq.fake_quant(*ops, **kw), fq.fake_quant_plain(*ops,
                                                                    **kw))
        _check_equal(f"jamba B8 backward {tuple(ops[0].shape)} vs plain",
                     fq.fake_quant_bwd(*ops, g, **kw),
                     fq.fake_quant_bwd_plain(*ops, g, **kw))
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    out = {}
    elems = sum(o[0].numel() for o in b9_ops)
    groups = sum(o[1].numel() for o in b9_ops)
    copies = [o[0] for o in b9_ops]

    def clone(ts):
        return lambda: [t.clone() for t in ts]

    b_ms, b_by = bound(8 * elems + 4 * groups, 16 * elems)
    out[B9] = dict(
        max_abs_err=0.0,
        ms=time_ms(lambda: [ni.noise_inject(*o) for o in b9_ops], reps),
        device_ms=device_ms(lambda: [ni.noise_inject(*o) for o in b9_ops],
                            reps),
        plain_ms=time_ms(lambda: [ni.noise_inject_plain(
            w_, ni.group_sigma(s_), sd_) for w_, s_, sd_ in b9_ops], 1),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        copy_device_ms=device_ms(clone(copies), reps), launches=2)
    b_ms, b_by = bound(12 * elems + 8 * groups, 20 * elems)
    bwd = [o + (g,) for o, g in zip(b9_ops, g9)]
    out[B9_BWD] = dict(
        max_abs_err=ds_err,
        ms=time_ms(lambda: [ni.noise_inject_bwd(*o) for o in bwd], reps),
        device_ms=device_ms(lambda: [ni.noise_inject_bwd(*o) for o in bwd],
                            reps),
        plain_ms=time_ms(lambda: [ni.noise_inject_bwd_plain(*o)
                                  for o in bwd], 1),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        copy_device_ms=device_ms(clone(copies + g9), reps), launches=2)
    del bwd, copies
    nel = sum(ops[0].numel() for ops, _kw in b8_calls)
    small = sum(4 * (ops[1].numel() + ops[2].numel()) for ops, _kw in b8_calls)
    b_ms, b_by = bound(4 * nel + small, 12 * nel)
    xs = [ops[0] for ops, _kw in b8_calls]
    out[B8] = dict(
        max_abs_err=0.0,
        ms=time_ms(lambda: [fq.fake_quant(*ops, **kw)
                            for ops, kw in b8_calls], reps),
        device_ms=device_ms(lambda: [fq.fake_quant(*ops, **kw)
                                     for ops, kw in b8_calls], reps),
        plain_ms=time_ms(lambda: [fq.fake_quant_plain(*ops, **kw)
                                  for ops, kw in b8_calls], 1),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        copy_device_ms=device_ms(clone(xs), reps), launches=4)
    b_ms, b_by = bound(6 * nel + small, 6 * nel)
    bwd = [(ops + (g,), kw) for (ops, kw), g in zip(b8_calls, g8)]
    out[B8_BWD] = dict(
        max_abs_err=0.0,
        ms=time_ms(lambda: [fq.fake_quant_bwd(*a, **kw) for a, kw in bwd],
                   reps),
        device_ms=device_ms(lambda: [fq.fake_quant_bwd(*a, **kw)
                                     for a, kw in bwd], reps),
        plain_ms=time_ms(lambda: [fq.fake_quant_bwd_plain(*a, **kw)
                                  for a, kw in bwd], 1),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        copy_device_ms=device_ms(clone(xs + g8), reps), launches=4)
    for rec in out.values():
        rec["shapes"] = dict(in_proj=[k_in, n_in], bank=[e, d, f],
                             activations=[TRAIN_BATCH * TRAIN_SEQ, k_in],
                             dispatch=[e, c, d])
    del b9_ops, g9, b8_calls, g8, weights, acts, xs, bwd
    gc.collect()
    torch.cuda.empty_cache()
    return out


def act_code_flips(tape_a, tape_b, qcfg):
    """Activation codes that differ between two tapes' inputs to each
    QAT linear and bank (each input's integer codes at its linear's
    precisions under its own scale, on the host): {linear: count} of the
    non-zero."""
    out = {}
    for (name, lin, xa), (_n, _l, xb) in zip(tape_a.inputs, tape_b.inputs):
        if "pbits" not in lin._names:
            continue
        pb = lin.pbits.float().cpu()
        bank = pb.dim() == 2
        codes = []
        for x in (xa, xb):
            x = x.float().cpu()
            p = quant.expand_groups(pb, x.shape[-1], 16)
            if bank:
                p = p[:, None, :]
            codes.append(quant.quantize_to_int(
                x / smol._act_scale(x, qcfg, bank), p))
        n = int((codes[0] != codes[1]).sum())
        if n:
            out[name] = n
    return out


def check_hybrid_training_against_cpu(dev):
    """Phase 24(d): the card configuration's two sublayers (a Mamba2
    mixer with the MLP, attention with the 4-expert MoE) at full width but
    the FFNs' d_ff, cut to HYBRID_CPU_D_FF, at fp32 parameters and
    compute, at NOISE (logits over the 4/2/1-bit bands, the same
    host-made draws) and QAT (the default mix): each sublayer on the card
    and on the CPU from the same weights, input (HYBRID_CPU_TOKENS
    tokens) and cotangent, teacher-forced: the attention sublayer takes
    the card's mixer output on both, and each linear, router and bank on
    the card runs on the CPU's input to it (``LinearTape``). Every
    linear's output and its input as the card's own ops made it, each
    sublayer's y, dx and every leaf's gradient (the mixer's conv, A_log,
    D, dt_bias, norm_g; the norms; the router; every linear's and bank's
    w and s) within relative L2 1e-5; the QAT activation codes that the
    card's own inputs flip against the CPU's are counted
    (``act_code_flips``). Returns the worst of each kind and the
    flips."""
    worst, flips = {}, {}
    cfg0 = dataclasses.replace(hybrid_train_cfg(), d_ff=HYBRID_CPU_D_FF,
                               dtype="float32", param_dtype="float32")
    t0 = time.perf_counter()
    for mode in ("noise", "qat"):
        cfg = cfg0.with_quant_mode(mode)
        # Drawn on the card (the host's generator is slow at 0.75e9
        # weights), then copied: the same weights on both.
        init = torch.Generator(device=dev).manual_seed(SEED + 24)
        card = torch.nn.ModuleList(
            blocks_lib.Block(kind, blocks_lib.block_init(
                kind, cfg, cfg.quant, generator=init, device=dev),
                act=cfg.mlp_act) for kind in lm.block_kinds(cfg))
        for name, lin in smol.smol_linears(card):
            lin.path = f"blocks.{name}"
        if mode == "noise":
            set_mixed_logits(card, SEED + 24)
        host = copy.deepcopy(card).to("cpu")
        gen = torch.Generator().manual_seed(SEED + 24)
        host.requires_grad_(True)
        card.requires_grad_(True)
        noise = HostNoise((SEED, 24)) if mode == "noise" else None
        x = torch.randn((1, HYBRID_CPU_TOKENS, cfg.d_model), generator=gen)
        pos = torch.arange(HYBRID_CPU_TOKENS)[None]
        for i in range(len(host)):
            g = torch.randn(x.shape, generator=gen)
            yh, dxh, gh, th = _block_grads(host[i], x, g, cfg, noise,
                                           positions=pos)
            yc, dxc, gc_, tc = _block_grads(card[i], x.to(dev), g.to(dev),
                                            cfg, noise, feed=th.inputs,
                                            positions=pos.to(dev))
            pairs = [("y", yc, yh), ("dx", dxc, dxh)] + [
                (n, gc_[n], gh[n]) for n in gh]
            for (name, _m, xc), (_n, _mh, xh), oc, oh in zip(
                    tc.inputs, th.inputs, tc.outputs, th.outputs):
                kind = ".".join(name.split(".")[-2:])
                pairs += [(f"{kind}.in", xc, xh), (f"{kind}.out", oc, oh)]
            for what, a, b in pairs:
                key = f"{mode}.{host[i].kind}.{what}"
                worst[key] = max(worst.get(key, 0.0), rel_l2(a, b))
            if mode == "qat":
                flips.update(act_code_flips(tc, th, cfg.quant))
            x = yc.cpu()
        del host, card
        gc.collect()
        torch.cuda.empty_cache()
    bad = {k: v for k, v in worst.items() if not v <= 1e-5}
    if bad:
        raise AssertionError(f"hybrid training card vs CPU over 1e-5: "
                             f"{bad}")
    largest = sorted(worst.items(), key=lambda kv: -kv[1])[:6]
    return {"largest": largest, "qat_code_flips": flips,
            "compared": len(worst), "d_ff": HYBRID_CPU_D_FF,
            "seconds": time.perf_counter() - t0}


def phase_hybrid_training(dev, gen, results, rng):
    """Phase 24: train the hybrid family at jamba-1.5-large-398b's
    published widths, cut to one unit of two sublayers and 4 experts
    (HYBRID_TRAIN_CUT; bf16 parameters and compute, fp32 moments;
    batches of TokenStream(8, 128, seed 0)). (a) ``hybrid_train_kernels``
    (``jamba_train_*`` keys). (b) The logits over the 4/2/1-bit bands, 3
    Phase-I steps, the freeze and 3 Phase-II steps through ``loop.train``
    (``phase_training``): every step's launches asserted (one B9 a
    quantized leaf in the forward and again in the recompute and one B9
    backward a Phase-I step; two B8 (weight, activation) each way and two
    B8 backward a Phase-II step; 12 leaves: 9 linears and 3 banks), host
    ms and peak memory a step, steps 2 and 5 profiled by op
    (``step_profile.HYBRID_TRAIN_SPANS``, ``hybrid_train_summary``); the
    freeze's report in the reference's walk
    (``hybrid_freeze_channels``), its bpp and histogram. (c) A second run
    bitwise the first (losses, gradient norms, parameters, pbits). (d)
    ``check_hybrid_training_against_cpu``. (e) The trained model through
    ``soniq.to_serve`` (one B7 a leaf, asserted) and a ``DecodeEngine``
    on 4 requests twice, bitwise (B1, B6 and B8 launched). Returns the
    ``hybrid_training`` JSON line's numbers."""
    from repro_torch import soniq
    from repro_torch.api.state import SoniqState
    from repro_torch.core.phases import Phase
    laps, t_lap = {}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        laps[name] = round(now - t_lap[0], 2)
        t_lap[0] = now

    cfg = hybrid_train_cfg()
    for name, rec in hybrid_train_kernels(cfg, gen, dev).items():
        results[name].update({f"jamba_train_{k}": v for k, v in rec.items()})
        log(f"[24] {name} at jamba's training shapes (in_proj and a "
            f"[4, 8192, 24576] bank; B8 also their activations), bitwise "
            f"plain: {rec}")
    gc.collect()
    torch.cuda.empty_cache()
    lap("kernels")

    leaves = quantized_leaves(cfg)
    state, records, profiles, rep = phase_training(
        cfg, dev, tag=24, spans=step_profile.HYBRID_TRAIN_SPANS,
        summary=step_profile.hybrid_train_summary, mixed_seed=SEED + 24)
    model = state["model"]
    del state
    gc.collect()
    torch.cuda.empty_cache()
    channels = [sum(layer["hist"]) for layer in rep["layers"]]
    if channels != hybrid_freeze_channels(cfg):
        raise AssertionError(f"freeze order or widths: {channels}")
    st = {"cut": HYBRID_TRAIN_CUT, "sublayers": list(cfg.hybrid_unit_kinds()),
          "parameters": sum(p.numel() for p in model.parameters()),
          "quantized_leaves": leaves, "steps": records,
          "profiles": profiles, "histogram": precision_histogram(model),
          "average_bpp": schedule.average_bpp(rep),
          "allowed_patterns": rep["allowed"], "report_rows": len(channels),
          "peak_gib": max(r["peak_gib"] for r in records),
          "launches_per_step": {p: train_step_launches(cfg, p)
                                for p in (1, 2)}}
    for name, key in ((B8, "b8"), (B9, "b9"), (B8_BWD, "b8_bwd"),
                      (B9_BWD, "b9_bwd")):
        results[name]["jamba_train_run_launches"] = sum(r[key]
                                                        for r in records)
        results[name]["jamba_train_launches_per_step"] = max(
            r[key] for r in records)
    log(f"[24] {st['parameters']:,} parameters, {leaves} quantized leaves; "
        f"peak {st['peak_gib']:.2f} GiB; frozen groups by precision "
        f"{st['histogram']}, average bpp {st['average_bpp']:.4f} over "
        f"{len(channels)} report rows; profiles {profiles}")
    if st["peak_gib"] * 2 ** 30 > 80e9:
        raise AssertionError(f"training peak {st['peak_gib']:.2f} GiB over "
                             f"80 GB")
    first = ([p.detach().cpu() for p in model.parameters()],
             [lin.pbits.cpu() for _n, lin in smol.smol_linears(model)
              if "pbits" in lin._names])
    del model
    gc.collect()
    torch.cuda.empty_cache()
    lap("train")

    state, rec2, _p, rep2 = phase_training(cfg, dev, tag=24, profiled=False,
                                           mixed_seed=SEED + 24)
    model = state["model"]
    del state
    gc.collect()
    torch.cuda.empty_cache()
    same = [(r["loss"], r["grad_norm"]) for r in records] == \
        [(r["loss"], r["grad_norm"]) for r in rec2]
    params_same = all(torch.equal(a, b.detach().cpu())
                      for a, b in zip(first[0], model.parameters()))
    pbits_same = all(torch.equal(a, lin.pbits.cpu()) for a, (_n, lin) in zip(
        first[1], [(n, lin) for n, lin in smol.smol_linears(model)
                   if "pbits" in lin._names]))
    if not (same and params_same and pbits_same
            and rep["layers"] == rep2["layers"]):
        raise AssertionError(f"a second jamba training run differs: losses "
                             f"equal {same}, parameters equal "
                             f"{params_same}, pbits equal {pbits_same}")
    del first
    st["second_run"] = dict(bitwise=True, step_ms=[r["ms"] for r in rec2],
                            peak_gib=max(r["peak_gib"] for r in rec2))
    log(f"[24] a second run bitwise the first (losses, gradient norms, "
        f"parameters, pbits): {st['second_run']}")
    lap("second_run")

    qcfg = cfg.with_quant_mode("qat")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    served = soniq.to_serve(SoniqState(Phase.QAT, model, qcfg))
    torch.cuda.synchronize()
    st["to_serve_s"] = time.perf_counter() - t0
    st["to_serve_b7"] = kernels.launch_counts()[B7]
    if st["to_serve_b7"] != leaves:
        raise AssertionError(f"{st['to_serve_b7']} B7 launches at to_serve, "
                             f"not one a leaf ({leaves})")
    ecfg = engine.EngineConfig(max_batch=4, cache_len=256, prefill_chunk=8)
    eng = engine.DecodeEngine(served.model, qcfg, ecfg, already_serve=True,
                              device=dev)
    reqs = requests(cfg.vocab_size, rng, n=4, lo=16, hi=16, new=8)
    kernels.reset_launch_counts()
    first_out, _wall = serve_all(eng, reqs)
    counts = kernels.launch_counts()
    second_out, _wall = serve_all(eng, reqs)
    _same_tokens("trained jamba: a second serve gave other tokens",
                 first_out, second_out)
    if counts[B1] == 0 or counts[B6] == 0 or counts[B8] == 0:
        raise AssertionError(f"trained jamba serve launches {counts}")
    for c in first_out:
        if c.new_tokens.size != 8 or not (
                (c.new_tokens >= 0) & (c.new_tokens < cfg.vocab_size)).all():
            raise AssertionError(f"bad trained-jamba completion "
                                 f"{c.new_tokens}")
    st["serve_launches"] = {k: v for k, v in counts.items() if v}
    st["served_tokens"] = [c.new_tokens.tolist() for c in first_out]
    log(f"[24] to_serve: {st['to_serve_b7']} B7 launches in "
        f"{st['to_serve_s']:.3f} s; served 4 requests twice, bitwise "
        f"({st['serve_launches']}): tokens {st['served_tokens']}")
    del eng, served, model
    gc.collect()
    torch.cuda.empty_cache()
    lap("serve")

    st["card_vs_cpu"] = check_hybrid_training_against_cpu(dev)
    log(f"[24] the two sublayers (d_ff {HYBRID_CPU_D_FF}), card vs CPU "
        f"(fp32, relative L2; y, dx, every leaf's gradient, every linear): "
        f"{st['card_vs_cpu']}")
    lap("card_vs_cpu")
    st["seconds"] = laps
    log(f"[24] seconds by part: {laps}")
    return st


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", type=int, choices=[20, 21, 22, 23, 24],
                    default=None,
                    help="build the kernels and run this phase alone (no "
                         "summary); the default runs every phase")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    clock = PhaseClock()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(f"[1] card: {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    t0 = time.perf_counter()
    built = _build.build()
    log(f"[1] built {sorted(built)} in {time.perf_counter() - t0:.2f} s "
        f"(per source: { {k: round(v, 2) for k, v in built.items()} })")
    for src in _build.SOURCES:
        report = _build.ptxas_report(src) or ""
        for line in report.splitlines():
            if "Used" in line or "spill" in line:
                log(f"    ptxas {src}: {line.strip()}")
    try:
        b8_sass = {tag: v["per_element"] for tag, v in
                   sass_count.kernel_counts(
                       str(_build.target(fq.SOURCE)), "fake_quant_kernel",
                       sass_count.fake_quant_per_pass(
                           (_build.CSRC / fq.SOURCE).read_text())).items()}
    except (RuntimeError, subprocess.SubprocessError) as err:
        b8_sass = f"not measured: {err}"
    log(f"[1] {B8}: SASS instructions of the forward's main loop an "
        f"element, by instance (type/K_ROWS/ROW_SCALE/GROUP/ALIGNED): "
        f"{b8_sass}")

    clock.lap(1)
    if args.only == 20:
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED)
        results = {name: {} for name in (B1, B4, B5, B7)}
        out = phase_whisper_serve(dev, np.random.default_rng(SEED + 20),
                                  gen, results, {}, {})
        clock.lap(20)
        print(json.dumps({"kernels_whisper": results}))
        print(json.dumps({"whisper_serve": out}))
        print(json.dumps({"phase_seconds": clock.laps}))
        print(card)
        return 0
    if args.only == 21:
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED)
        results = {name: {} for name in (B8, B9, B8_BWD, B9_BWD)}
        out = phase_whisper_training(dev, gen, results,
                                     np.random.default_rng(SEED + 21))
        clock.lap(21)
        print(json.dumps({"kernels_whisper_training": results}))
        print(json.dumps({"whisper_training": out}))
        print(json.dumps({"phase_seconds": clock.laps}))
        print(card)
        return 0
    if args.only == 22:
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED)
        results = {name: {} for name in (B1, B7, B8, B9, B8_BWD, B9_BWD)}
        launches, per_step = {}, {}
        out = phase_vlm(dev, gen, results, launches, per_step)
        clock.lap(22)
        print(json.dumps({"kernels_vlm": results}))
        print(json.dumps({"vlm": out, "launches": launches,
                          "per_step": per_step}))
        print(json.dumps({"phase_seconds": clock.laps}))
        print(card)
        return 0
    if args.only == 23:
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED)
        results = {name: {} for name in (B1, B6, B7)}
        launches, per_step = {}, {}
        out = phase_hybrid(dev, gen, results, launches, per_step)
        clock.lap(23)
        print(json.dumps({"kernels_hybrid": results}))
        print(json.dumps({"hybrid": out, "launches": launches,
                          "per_step": per_step}))
        print(json.dumps({"phase_seconds": clock.laps}))
        print(card)
        return 0
    if args.only == 24:
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED)
        results = {name: {} for name in (B8, B9, B8_BWD, B9_BWD, B7)}
        out = phase_hybrid_training(dev, gen, results,
                                    np.random.default_rng(SEED + 24))
        clock.lap(24)
        print(json.dumps({"kernels_hybrid_training": {
            k: v for k, v in results.items() if v}}))
        print(json.dumps({"hybrid_training": out}))
        print(json.dumps({"phase_seconds": clock.laps}))
        print(card)
        return 0

    # -------------------------------------------------------- phase 2 ----
    cfg = get_config(ARCH)
    mixed = QuantConfig(mode="qat")
    u4 = U4
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    results = {B7: phase_quant_pack(cfg, get_config(MOE_ARCH), mixed, gen,
                                    dev)}
    log(f"[2] quantize_pack_segments bitwise its plain version, one launch "
        f"a linear and a bank; one {ARCH} layer (7 launches; moe_layer_*: "
        f"one {MOE_ARCH} MoE layer, 10 launches): {results[B7]}")
    for name, qcfg in ((B1, mixed), (B2, u4), (B3, mixed)):
        decode_sets = [LayerOperands(cfg, qcfg, 4, gen, dev)
                       for _ in range(4)]
        prefill = LayerOperands(cfg, qcfg, 32, gen, dev)
        err = check_segment_gemm(name, decode_sets[:1] + [prefill])
        res = time_segment_gemm(name, decode_sets)
        res["max_abs_err"] = err
        pre = time_segment_gemm(name, [prefill])
        res.update(prefill_ms=pre["ms"], prefill_device_ms=pre["device_ms"],
                   prefill_library_ms=pre["library_ms"],
                   prefill_library_device_ms=pre["library_device_ms"],
                   prefill_bound_ms=pre["bound_ms"])
        results[name] = res
        log(f"[2] {name} within the fp32 bound (max |err| {err:.3e}); one "
            f"layer, 7 launches, at M=4 (M=32: prefill_*): {res}")
        del decode_sets, prefill
        torch.cuda.empty_cache()
    log(f"[2] one launch over a leaf's segments == the single-segment "
        f"launches bitwise: {check_multi_segment_launches(cfg, gen, dev)} "
        f"comparisons")
    log(f"[2] rows bitwise equal across M in {{1, 4, 5, 16, 17, 32, 33}}: "
        f"{check_rows_across_batch(cfg, gen, dev)} comparisons")
    # The speculative widths: B1 at M = 16 (the verify step, batch 4 x
    # k + 1 lanes) and the draft launches over the [K2|K1] slice.
    verify_sets = [LayerOperands(cfg, mixed, 4 * (SPEC_TOKENS + 1), gen,
                                 dev) for _ in range(4)]
    err = check_segment_gemm(B1, verify_sets[:1])
    res = time_segment_gemm(B1, verify_sets)
    results[B1].update({f"verify_{k}": v for k, v in res.items()},
                       verify_max_abs_err=err)
    log(f"[2] {B1} at M={4 * (SPEC_TOKENS + 1)} (verify) within the fp32 "
        f"bound (max |err| {err:.3e}); one layer, 7 launches: {res}")
    del verify_sets
    draft_sets = [DraftView(LayerOperands(cfg, mixed, 4, gen, dev))
                  for _ in range(4)]
    err = check_segment_gemm(B1, draft_sets[:1])
    n = check_draft_at_offset(B1, draft_sets[0].linears)
    res = time_segment_gemm(B1, draft_sets)
    results[B1].update({f"draft_{k}": v for k, v in res.items()},
                       draft_max_abs_err=err)
    log(f"[2] {B1} draft launches ([K2|K1], bits <= {DRAFT_BITS}) within "
        f"the fp32 bound (max |err| {err:.3e}), {n} bitwise the launch at "
        f"k_off 0; one layer at M=4, 7 launches (full: ms "
        f"{results[B1]['ms']:.4f}, device {results[B1]['device_ms']:.4f})"
        f": {res}")
    del draft_sets
    torch.cuda.empty_cache()
    moe_ops = GroupedOperands(get_config(MOE_ARCH), mixed, 4, gen, dev)
    results[B6] = phase_grouped_segment(moe_ops)
    log(f"[2] {B6} within the fp32 bound, every expert bitwise the dense "
        f"launch, rows= bitwise on live rows and past rows untouched; one "
        f"{MOE_ARCH} layer (E=64, T=4, 3 launches): {results[B6]}")
    draft6 = DraftView(moe_ops)
    res = phase_grouped_segment(draft6)
    n = check_draft_at_offset(B6, draft6.projs)
    results[B6].update({f"draft_{k}": v for k, v in res.items()
                        if k not in ("live_experts", "live_rows")})
    log(f"[2] {B6} draft launches: the same checks, {n} bitwise the launch "
        f"at k_off 0: {res}")
    del moe_ops, draft6
    torch.cuda.empty_cache()
    results[B1]["dense_configs"] = check_dense_shapes(mixed, gen, dev)
    log(f"[2] {B1} at the other dense configs' full-width layers: within "
        f"the fp32 bound at M=4 and M={4 * (SPEC_TOKENS + 1)}, draft "
        f"launches within it and bitwise the launch at k_off 0, {B7} "
        f"bitwise its plain version: {results[B1]['dense_configs']}")
    clock.lap(2)

    # -------------------------------------------------------- phase 3 ----
    results.update(phase_attention(gen, dev))
    torch.cuda.empty_cache()

    clock.lap(3)

    # -------------------------------------------------------- phase 4 ----
    launches, per_step = {}, {}
    qat_cfg = dataclasses.replace(
        cfg, num_layers=SERVE_LAYERS).with_quant_mode("qat")
    ecfg = engine.EngineConfig(max_batch=4, cache_len=256, prefill_chunk=8)
    params = lm.init_params(qat_cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    eng = engine.DecodeEngine(params, qat_cfg, ecfg)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    launches[B7] = kernels.launch_counts()[B7]
    load = {"pack_s": pack_s, "b7_launches": launches[B7]}
    if launches[B7] != packed_leaves(eng.model) \
            or launches[B7] != 7 * qat_cfg.num_layers:
        raise AssertionError(f"{launches[B7]} B7 launches at load, not one "
                             f"a linear ({7 * qat_cfg.num_layers})")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    eng, prof = profile_load(lambda: engine.DecodeEngine(params, qat_cfg,
                                                         ecfg))
    del params
    torch.cuda.empty_cache()
    load.update(device_busy_ms=prof["device_busy_ms"],
                device_events=prof["device_events"],
                idle_share=1 - prof["device_busy_ms"] / (pack_s * 1e3),
                by_op=prof["by_op"])
    log(f"[4] load: {load}")
    rng = np.random.default_rng(SEED)
    reqs = requests(cfg.vocab_size, rng)
    kernels.reset_launch_counts()
    first, wall1 = serve_all(eng, reqs)
    counts = kernels.launch_counts()
    launches[B1] = counts[B1]
    log(f"[4] packed {qat_cfg.num_layers} layers in {pack_s:.2f} s "
        f"({engine.packed_model_bytes(eng.model):,} bytes; {launches[B7]} "
        f"B7 launches); serve launches {counts}")
    if counts[B1] == 0 or counts[B2] != 0:
        raise AssertionError(f"main path launches {counts}")
    for c in first:
        if c.new_tokens.size != 16 or not (
                (c.new_tokens >= 0) & (c.new_tokens < cfg.vocab_size)).all():
            raise AssertionError(f"bad completion {c.new_tokens}")
    second, wall2 = serve_all(eng, reqs)
    for a, b in zip(first, second):
        if not np.array_equal(a.tokens, b.tokens):
            raise AssertionError("second identical run gave other tokens")
    new = sum(c.new_tokens.size for c in second)
    step_ms = decode_step_ms(eng)
    log(f"[4] served {len(reqs)} requests ({new} new tokens) in "
        f"{eng.sched.step_count} steps: {new / wall2:.2f} tok/s "
        f"(first run {wall1:.2f} s, second {wall2:.2f} s); decode step at "
        f"batch 4: {step_ms:.2f} ms; tokens[0] {second[0].new_tokens[:8]}")
    prof = profile_decode(eng)
    log(f"[4] decode step profile (batch 4): {prof}; device idle share "
        f"{1 - prof['device_busy_ms_per_step'] / step_ms:.3f} of the "
        f"unprofiled {step_ms:.2f} ms step")
    per_step[B1] = step_launches(eng)[B1]
    if per_step[B1] != 7 * qat_cfg.num_layers:
        raise AssertionError(f"{per_step[B1]} {B1} launches a decode step, "
                             f"not one a linear")
    check_lockstep_equals_continuous(eng, qat_cfg, ecfg, cfg.vocab_size,
                                     rng, 16, 8)
    log("[4] lockstep == continuous on same-length prompts")
    log(f"[4] two-pass == fused bitwise at "
        f"{check_two_pass_equals_fused(eng.model, eng.cfg.quant, gen, dev)}"
        f" outputs of layer 0's linears")
    two = engine.DecodeEngine(eng.model, qat_cfg, dataclasses.replace(
        ecfg, fuse_act_quant=False), already_serve=True, device=dev)
    kernels.reset_launch_counts()
    two_out, wall = serve_all(two, reqs)
    counts = kernels.launch_counts()
    launches[B3] = counts[B3]
    log(f"[4] two-pass serve: {wall:.2f} s; launches {counts}")
    if counts[B3] == 0 or counts[B8] == 0 or counts[B1] or counts[B2]:
        raise AssertionError(f"two-pass serve path launches {counts}")
    for a, b in zip(second, two_out):
        if not np.array_equal(a.tokens, b.tokens):
            raise AssertionError(f"two-pass tokens != fused tokens (request "
                                 f"{a.request_id})")
    per_step[B3] = step_launches(two)[B3]
    log(f"[4] two-pass tokens == fused tokens; decode step at batch 4: "
        f"{decode_step_ms(two):.2f} ms; {per_step[B1]} {B1} launches a "
        f"fused step, {per_step[B3]} {B3} a two-pass step")
    if per_step[B3] != 7 * qat_cfg.num_layers:
        raise AssertionError(f"{per_step[B3]} {B3} launches a two-pass "
                             f"decode step, not one a linear")
    del two
    # The fp page pool: no kernel of its own (the gathered pages feed the
    # fp ring's attention), tokens equal to the fp ring's.
    paged_ecfg = dataclasses.replace(ecfg, kv_layout="paged", page_size=16)
    paged = engine.DecodeEngine(eng.model, qat_cfg, paged_ecfg,
                                already_serve=True, device=dev)
    kernels.reset_launch_counts()
    paged_out, wall, step = timed_serve(paged, reqs)
    counts = kernels.launch_counts()
    if counts[B1] == 0 or counts[B4] or counts[B5]:
        raise AssertionError(f"fp paged path launches {counts}")
    for a, b in zip(second, paged_out):
        if not np.array_equal(a.tokens, b.tokens):
            raise AssertionError(f"fp paged != fp ring (request "
                                 f"{a.request_id})")
    fp_paged = dict(tok_s=new / wall, decode_step_ms=step,
                    steps=paged.sched.step_count,
                    pool=paged.paged_kv_stats(),
                    fresh_cache_step_ms=decode_step_ms(paged),
                    profile=profile_decode(paged))
    log(f"[4] fp paged DecodeEngine == fp ring: {fp_paged}")
    del paged
    # Speculative decoding (k = 3, draft bits 2) over both fp caches on
    # the first wave of requests: tokens equal to spec-off; one round
    # launches B1 once a linear a step, k draft steps and the verify.
    spec_runs = {}
    for tag, e_cfg in (("h2o_fp_ring", ecfg), ("h2o_fp_paged", paged_ecfg)):
        spec_runs[tag] = spec_serve(
            eng.model, qat_cfg, e_cfg, reqs[:4], second[:4], dev,
            {B1: (SPEC_TOKENS + 1) * 7 * qat_cfg.num_layers},
            profile=tag == "h2o_fp_ring")
        log(f"[4] spec {tag} tokens == spec-off: {spec_runs[tag]}")
    del eng
    torch.cuda.empty_cache()
    log(f"[4] card kernels vs CPU plain versions (fp32, relative L2): "
        f"{check_against_cpu(qat_cfg, ecfg, dev)}")
    torch.cuda.empty_cache()

    clock.lap(4)

    # -------------------------------------------------------- phase 5 ----
    u4_cfg = dataclasses.replace(cfg, num_layers=2, quant=u4)
    params = lm.init_params(u4_cfg, seed=SEED + 2, device=dev)
    kernels.reset_launch_counts()
    eng = engine.DecodeEngine(params, u4_cfg, ecfg)
    del params
    done, wall = serve_all(eng, requests(cfg.vocab_size, rng, n=4))
    counts = kernels.launch_counts()
    launches[B2] = counts[B2]
    log(f"[5] U4 depth 2: {sum(c.new_tokens.size for c in done)} tokens in "
        f"{wall:.2f} s; launches {counts}")
    if counts[B2] == 0 or counts[B1] != 0:
        raise AssertionError(f"U4 path launches {counts}")
    check_lockstep_equals_continuous(eng, u4_cfg, ecfg, cfg.vocab_size, rng,
                                     12, 6)
    per_step[B2] = step_launches(eng)[B2]
    log(f"[5] lockstep == continuous; {per_step[B2]} {B2} launches a step")
    if per_step[B2] != 7 * u4_cfg.num_layers:
        raise AssertionError(f"{per_step[B2]} {B2} launches a U4 step")

    del eng
    torch.cuda.empty_cache()

    clock.lap(5)

    # -------------------------------------------------------- phase 6 ----
    kv4 = phase_kv4_serve(dataclasses.replace(qat_cfg, num_layers=KV4_LAYERS),
                          cfg.vocab_size, dev, rng, launches, per_step,
                          spec_runs)
    torch.cuda.empty_cache()

    clock.lap(6)

    # -------------------------------------------------------- phase 7 ----
    train_kern = phase_training_kernels(cfg, gen, dev)
    results.update(train_kern)
    log(f"[7] noise_inject and fake_quant bit-equal to their plain "
        f"versions, their backward passes dw and dx bitwise and ds within "
        f"its bound; {train_kern}")
    torch.cuda.empty_cache()
    for name, rec in phase_bank_kernels(get_config(MOE_ARCH),
                                        get_config("mixtral-8x22b"), gen,
                                        dev).items():
        results[name].update(rec)
    torch.cuda.empty_cache()

    clock.lap(7)

    # -------------------------------------------------------- phase 8 ----
    train_cfg = dataclasses.replace(cfg, num_layers=TRAIN_LAYERS)
    state, records, profiles, report = phase_training(train_cfg, dev)
    for name, key in ((B8, "b8"), (B9, "b9"), (B8_BWD, "b8_bwd"),
                      (B9_BWD, "b9_bwd")):
        launches[name] = sum(r[key] for r in records)
    per_train_step = {B9_BWD: records[0]["b9_bwd"],
                      B8_BWD: records[-1]["b8_bwd"]}

    clock.lap(8)

    # -------------------------------------------------------- phase 9 ----
    state["opt"] = None
    torch.cuda.empty_cache()
    phase_serve_trained(state, train_cfg, dev, rng)
    del state
    torch.cuda.empty_cache()

    clock.lap(9)

    # ------------------------------------------------------- phase 10 ----
    log(f"[10] training linears, card vs CPU (fp32, relative L2): "
        f"{check_training_against_cpu(cfg, dev)}")
    torch.cuda.empty_cache()

    clock.lap(10)

    # ------------------------------------------------------- phase 11 ----
    launcher_s = phase_launcher()
    clock.lap(11)

    # ------------------------------------------------------- phase 12 ----
    moe = phase_moe_serve(dev, rng, launches, per_step, spec_runs)
    clock.lap(12)

    # ------------------------------------------------------- phase 13 ----
    for arch, seed in ((MOE_ARCH, SEED + 6), (DENSE_ARCH, SEED + 8)):
        log(f"[13] {arch} layers 0-1, card vs CPU (fp32, relative L2): "
            f"{check_layers_against_cpu(arch, seed, ecfg, dev)}")
        gc.collect()
        torch.cuda.empty_cache()
    clock.lap(13)

    # ------------------------------------------------------- phase 14 ----
    dense = phase_dense_configs(dev, rng, spec_runs)
    clock.lap(14)

    # ------------------------------------------------------- phase 15 ----
    moe_train = phase_moe_training(dev, rng)
    moe_train["banks_card_vs_cpu"] = check_banks_against_cpu(dev)
    log(f"[15] one {MOE_ARCH} MoE layer's banks ({BANK_CPU_EXPERTS} experts "
        f"each), card vs CPU (fp32, relative L2): "
        f"{moe_train['banks_card_vs_cpu']}")
    clock.lap(15)

    # ------------------------------------------------------- phase 16 ----
    rest, layer0 = phase_mixed_training(
        dataclasses.replace(cfg, num_layers=REST_LAYERS), dev)
    rest["layer0_card_vs_cpu"] = check_training_against_cpu(
        cfg, dev, qat_pbits=layer0, modes=("qat",))
    log(f"[16] phase 10's QAT linears on layer 0's frozen precisions "
        f"(groups at 4/2/1 bits "
        f"{ {p: sum(int((t == p).sum()) for t in layer0.values()) for p in (4, 2, 1)} }"
        f"), card vs CPU (fp32, relative L2): {rest['layer0_card_vs_cpu']}")
    torch.cuda.empty_cache()
    rest["checkpoint"] = phase_checkpoint_restart(dev)
    rest["launchers_s"] = phase_rest_launchers()
    clock.lap(16)

    # ------------------------------------------------------- phase 17 ----
    gc.collect()
    torch.cuda.empty_cache()
    soniq_out = {"linear": phase_soniq_linear(dev)}
    soniq_out.update(phase_soniq_cnn(dev))
    soniq_out["examples_s"] = phase_examples()
    clock.lap(17)

    # ------------------------------------------------------- phase 18 ----
    gc.collect()
    torch.cuda.empty_cache()
    ssm_out = phase_ssm_serve(dev, rng, gen, results, launches, per_step)
    clock.lap(18)

    # ------------------------------------------------------- phase 19 ----
    gc.collect()
    torch.cuda.empty_cache()
    ssm_train = phase_ssm_training(dev, gen, results, rng)
    clock.lap(19)

    # ------------------------------------------------------- phase 20 ----
    gc.collect()
    torch.cuda.empty_cache()
    whisper_out = phase_whisper_serve(dev, np.random.default_rng(SEED + 20),
                                      gen, results, launches, per_step)
    clock.lap(20)

    # ------------------------------------------------------- phase 21 ----
    gc.collect()
    torch.cuda.empty_cache()
    whisper_train = phase_whisper_training(dev, gen, results,
                                           np.random.default_rng(SEED + 21))
    clock.lap(21)

    # ------------------------------------------------------- phase 22 ----
    gc.collect()
    torch.cuda.empty_cache()
    vlm = phase_vlm(dev, gen, results, launches, per_step)
    clock.lap(22)

    # ------------------------------------------------------- phase 23 ----
    gc.collect()
    torch.cuda.empty_cache()
    hybrid = phase_hybrid(dev, gen, results, launches, per_step)
    clock.lap(23)

    # ------------------------------------------------------- phase 24 ----
    gc.collect()
    torch.cuda.empty_cache()
    hybrid_train = phase_hybrid_training(dev, gen, results,
                                         np.random.default_rng(SEED + 24))
    clock.lap(24)

    # ------------------------------------------------------- phase 25 ----
    work = {B7: "one h2o-danube-1.8b layer of packing (7 launches, one a "
                "linear, rows read through the channel perm; moe_layer_*: "
                "one deepseek-moe-16b MoE layer, 10 launches; ssm_layer_*: "
                "one mamba2-2.7b layer, 2 launches; whisper_layer_*: one "
                "whisper-medium decoder layer, 10 launches; launches: "
                "the h2o-danube-1.8b load, moe_load_launches: the "
                "deepseek-moe-16b load, ssm_load_launches: the mamba2-2.7b "
                "load, whisper_load_launches: the whisper-medium load; "
                "vlm_layer_*: one qwen2-vl-72b layer, 7 launches; "
                "vlm_head_*: its readout's shape, 8192x152064, 1 launch; "
                "vlm_load_launches: the 4-layer qwen2-vl-72b load; "
                "jamba_{mixer,attention,mlp,bank}_*: jamba-1.5-large-398b's "
                "bf16 weights, one mixer (in_proj 8192x33280, out_proj "
                "16384x8192), one attention sublayer, one dense MLP, one "
                "8-expert bank [8, 8192, 24576], read as bf16 "
                "(fp32_device_ms: the fp32 launch on the widened weights; "
                "absmax_*: torch's group abs-max of the same bf16 weights); "
                "jamba_load_launches: the one-unit jamba load)",
            B1: "one h2o-danube-1.8b layer of decode GEMMs at M=4 (7 "
                "launches, one a linear; prefill_*: M=32; verify_*: M=16, "
                "the verify step of k=3 at batch 4; draft_*: the draft "
                "launches over the [K2|K1] slice at M=4; ssm_M{4,16,32}_*"
                ", ssm_draft_*: one mamba2-2.7b layer, in_proj 2560x10576 "
                "and out_proj 5120x2560, 2 launches; ssm_serve_launches: "
                "the mamba2-2.7b serve run; whisper_M{6000,4,16,32}_*: one "
                "whisper-medium layer's 6 linear shapes (q/k/v/o 1024x1024,"
                " fc1 1024x4096, fc2 4096x1024), M=6000 the encoder's 4 x "
                "1500 frames; whisper_{encode,load_cross,serve}_launches: "
                "one encode pass, one load_cross, the fp ring serve run; "
                "vlm_layer_M{4,2304}_*: one qwen2-vl-72b layer's 7 linears "
                "(K = 29568 down: odd 2- and 1-bit group counts), "
                "vlm_head_M{4,2304}_*: its readout's shape 8192x152064 "
                "packed, M=2304 the multimodal prefill; vlm_serve_launches,"
                " vlm_prefill_launches: the 4-layer fp ring serve run and "
                "the multimodal soniq.apply; jamba_M{4,16,32}_*: "
                "jamba-1.5-large-398b's in_proj 8192x33280, out_proj "
                "16384x8192 and MLP 8192<->24576, 5 launches; "
                "jamba_serve_launches: its one-unit fp ring serve run)",
            B2: "one uniform 4-bit h2o-danube-1.8b layer of decode GEMMs "
                "at M=4 (7 launches; prefill_*: M=32)",
            B3: "one h2o-danube-1.8b layer of plain segment GEMMs at M=4 "
                "(7 launches; prefill_*: M=32; launches: the two-pass "
                "serve run)",
            B6: "one deepseek-moe-16b layer of grouped expert GEMMs at "
                "E=64, T=4, every row live (3 launches, one a projection; "
                "rows_*: the same with the live rows of a top-6 route of "
                "4 tokens; launches: the fp ring MoE serve run; draft_*: "
                "the same over the [K2|K1] slice; jamba_*: one "
                "jamba-1.5-large-398b MoE sublayer's 3 banks at E=8, T=4, "
                "jamba_rows_*: the live rows of a top-2 route of 4 tokens; "
                "jamba_serve_launches: its one-unit fp ring serve run)",
            B4: "one decode attention call: B=4, S=1, Hk=8, G=4, D=80, "
                "T=256 (the kv4 serve ring); shapes: T=4096 with window "
                "1024, deepseek-moe-16b (Hk=16, G=1, D=128) and "
                "starcoder2-7b (Hk=4, G=9, D=128) at T=256; "
                "whisper_cross_*: whisper-medium's cross attention, B=4, "
                "S=1, Hk=16, G=1, D=64 over T=1500 encoder entries (key "
                "positions 0, query 2^30); whisper_self_*: its self ring, "
                "T=256",
            B5: "one decode attention call: B=4, S=1, Hk=8, G=4, D=80, "
                "16 pages of 16 a slot; shapes: 256 pages with window "
                "1024, deepseek-moe-16b and starcoder2-7b at 16 pages; "
                "whisper_self_*: whisper-medium (Hk=16, G=1, D=64) at 16 "
                "pages",
            B8: "one h2o-danube-1.8b layer of Phase-II fake_quant: 7 "
                "weights (fp32, group scale) + 7 activations (bf16, "
                "8 x 128 tokens, per-row abs-max / 1.875 scales); "
                "alone_device_ms: the kernel's C entry alone on the same "
                "operands (the layer's exceed the 50 MB L2); "
                "copy_device_ms: torch's clone of the same tensors (one "
                "read and one write of each: the bytes alone); "
                "sass_per_element: static SASS instructions of the "
                "forward's main loop an element, by template instance",
            B9: "one h2o-danube-1.8b layer of Phase-I noise_inject: 7 "
                "weights (fp32); device_ms: the wrapper's calls (each "
                "also launches the group sigmoid and the seed mask); "
                "alone_device_ms: the kernel alone, those made outside "
                "the timed calls",
            B8_BWD: "one h2o-danube-1.8b layer of Phase-II fake_quant "
                    "backward: 7 weights (fp32) + 7 activations (bf16, "
                    "8 x 128 tokens); launches_per_train_step: a Phase-II "
                    "step",
            B9_BWD: "one h2o-danube-1.8b layer of Phase-I noise_inject "
                    "backward: 7 weights (fp32); launches_per_train_step: "
                    "a Phase-I step"}
    bank_work = {
        B8: "; bank_*: one deepseek-moe-16b MoE layer's 3 expert banks "
            "(E=64, one launch a bank: fp32 weights, group scales an "
            "expert) + their 3 dispatch-buffer activations ([64, 120, K] "
            "bf16, a per-tensor scale an expert); "
            "bank_single_launches_ms: the same as 384 single launches",
        B9: "; bank_*: one deepseek-moe-16b MoE layer's 3 expert banks "
            "(E=64, one launch a bank, a seed an expert); "
            "bank_single_launches_ms: 192 single launches"}
    bank_work[B8_BWD], bank_work[B9_BWD] = bank_work[B8], bank_work[B9]
    for name, text in bank_work.items():
        work[name] += text + ("; moe_train_launches: the MoE training run"
                              ", launches_per_moe_train_step: a Phase-I "
                              "(B9) or Phase-II (B8) step of it; "
                              "ssm_train_*: one mamba2-2.7b layer's "
                              "training linears (in_proj 2560x10576, "
                              "out_proj 5120x2560; B8 also their 8 x 128 "
                              "bf16 activations), ssm_train_run_launches "
                              "and ssm_train_launches_per_step: phase 19's "
                              "8-layer run and a step of it; "
                              "whisper_train_*: one whisper-medium encoder "
                              "layer's 6 training linears and one decoder "
                              "layer's 10 (B8 also their bf16 activations: "
                              "8 x 1500 encoder rows, 8 x 128 decoder "
                              "tokens, the cross wk/wv on the encoder's "
                              "rows), whisper_train_run_launches and "
                              "whisper_train_launches_per_step: phase 21's "
                              "6 + 6-layer run and a step of it; "
                              "vlm_train_*: one qwen2-vl-72b layer's 7 "
                              "training linears (B8 also their 4 x 384 "
                              "bf16 activations); vlm_head_*: one fp32 "
                              "weight of its readout's shape, 8192x152064 "
                              "(1.246e9 elements; plain_ms band by band); "
                              "vlm_train_run_launches, "
                              "vlm_train_launches_per_step: phase 22's "
                              "1-layer run and a step of it; "
                              "jamba_train_*: jamba-1.5-large-398b's "
                              "in_proj 8192x33280 and one bank [4, 8192, "
                              "24576], B9 on their fp32 widening, B8 on "
                              "the bf16 weights and on bf16 activations "
                              "(1024 x 8192 per-row scales; the bank's "
                              "dispatch buffer [4, 640, 8192]), "
                              "copy_device_ms: torch's clone of the same "
                              "tensors; jamba_train_run_launches, "
                              "jamba_train_launches_per_step: phase 24's "
                              "run and a step of it")
    rows = []
    for name in (B1, B2, B3, B4, B5, B6, B7, B8, B9, B8_BWD, B9_BWD):
        r = results[name]
        rows.append({"name": name, "route": "cuda", "source": SOURCES[name],
                     "replaces": REPLACES[name], "launches": launches[name],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"], "work": work[name]})
        for key in ("device_ms", "alone_device_ms", "copy_device_ms",
                    "library_device_ms", "prefill_ms",
                    "prefill_device_ms", "prefill_library_ms",
                    "prefill_library_device_ms", "prefill_bound_ms",
                    "rows_ms", "rows_device_ms", "rows_bound_ms",
                    "rows_library_ms", "rows_library_device_ms",
                    "live_experts", "shapes", "launches_per_layer",
                    "moe_layer_ms", "moe_layer_device_ms",
                    "moe_layer_plain_ms", "moe_layer_bound_ms",
                    "moe_layer_launches"):
            if key in r:
                rows[-1][key] = r[key]
        rows[-1].update((k, v) for k, v in r.items()
                        if k.startswith(("verify_", "draft_", "ssm_",
                                         "whisper_", "vlm_", "jamba_")))
        if name in per_step:
            rows[-1]["launches_per_decode_step"] = per_step[name]
        if name in per_train_step:
            rows[-1]["launches_per_train_step"] = per_train_step[name]
        if name == B8:
            rows[-1]["sass_per_element"] = b8_sass
            rows[-1]["jamba_serve_launches"] = launches["b8_jamba_serve"]
            rows[-1]["jamba_launches_per_decode_step"] = per_step["b8_jamba"]
        if name in (B8, B8_BWD):
            key = "b8" if name == B8 else "b8_bwd"
            for tag in ("hoisted", "unhoisted"):
                rows[-1][f"launches_per_{tag}_2mb_step"] = \
                    rest["launches_per_step"][tag][2][key]
        if name == B7:
            rows[-1]["moe_load_launches"] = launches["b7_moe_load"]
            rows[-1]["ssm_load_launches"] = launches["b7_ssm_load"]
            rows[-1]["whisper_load_launches"] = launches["b7_whisper_load"]
            rows[-1]["vlm_load_launches"] = launches["b7_vlm_load"]
            rows[-1]["jamba_load_launches"] = launches["b7_jamba_load"]
        if name == B1:
            rows[-1]["ssm_serve_launches"] = launches["b1_ssm_serve"]
            rows[-1]["ssm_launches_per_decode_step"] = per_step["b1_ssm"]
            rows[-1]["ssm_launches_per_spec_round"] = \
                per_step["b1_ssm_spec_round"]
            for key in ("encode", "load_cross", "serve"):
                rows[-1][f"whisper_{key}_launches"] = \
                    launches[f"b1_whisper_{key}"]
            rows[-1]["whisper_launches_per_decode_step"] = \
                per_step["b1_whisper"]
            rows[-1]["whisper_launches_per_spec_round"] = \
                per_step["b1_whisper_spec_round"]
            for key in ("serve", "prefill"):
                rows[-1][f"vlm_{key}_launches"] = launches[f"b1_vlm_{key}"]
            rows[-1]["vlm_launches_per_decode_step"] = per_step["b1_vlm"]
            rows[-1]["vlm_launches_per_spec_round"] = \
                per_step["b1_vlm_spec_round"]
            rows[-1]["jamba_serve_launches"] = launches["b1_jamba_serve"]
            rows[-1]["jamba_launches_per_decode_step"] = per_step["b1_jamba"]
            rows[-1]["jamba_launches_per_spec_round"] = \
                per_step["b1_jamba_spec_round"]
        if name == B6:
            rows[-1]["jamba_serve_launches"] = launches["b6_jamba_serve"]
            rows[-1]["jamba_launches_per_decode_step"] = per_step["b6_jamba"]
            rows[-1]["jamba_launches_per_spec_round"] = \
                per_step["b6_jamba_spec_round"]
        if name == B4:
            rows[-1]["whisper_kv4_serve_launches"] = \
                launches["b4_whisper_kv4_serve"]
            rows[-1]["whisper_launches_per_kv4_decode_step"] = \
                per_step["b4_whisper"]
            rows[-1]["vlm_kv4_serve_launches"] = launches["b4_vlm_kv4_serve"]
            rows[-1]["vlm_launches_per_kv4_decode_step"] = per_step["b4_vlm"]
            rows[-1]["jamba_kv4_serve_launches"] = \
                launches["b4_jamba_kv4_serve"]
            rows[-1]["jamba_launches_per_kv4_decode_step"] = \
                per_step["b4_jamba"]
        if name == B5:
            rows[-1]["whisper_paged_serve_launches"] = \
                launches["b5_whisper_paged_serve"]
            rows[-1]["whisper_launches_per_paged_decode_step"] = \
                per_step["b5_whisper"]
            rows[-1]["vlm_paged_serve_launches"] = \
                launches["b5_vlm_paged_serve"]
            rows[-1]["vlm_launches_per_paged_decode_step"] = \
                per_step["b5_vlm"]
            rows[-1]["jamba_paged_serve_launches"] = \
                launches["b5_jamba_paged_serve"]
            rows[-1]["jamba_launches_per_paged_decode_step"] = \
                per_step["b5_jamba"]
        if name in SOLO:
            lin = soniq_out["linear"]["launches"][name]
            if lin:
                rows[-1]["soniq_linear_launches"] = lin
            for cell in ("cnn_bench", "cnn_cifar"):
                cell_out = soniq_out[cell]
                per = {n: v.get(name, 0)
                       for n, v in cell_out["launches_per_step"].items()}
                if any(per.values()):
                    rows[-1][f"{cell}_launches_per_step"] = per
            if name == B7:
                rows[-1]["cnn_to_serve_launches"] = {
                    cell: soniq_out[cell]["to_serve_b7"]
                    for cell in ("cnn_bench", "cnn_cifar")}
            if name == B8:
                rows[-1]["cnn_served_forward_launches"] = {
                    cell: soniq_out[cell]["served_forward_b8"]
                    for cell in ("cnn_bench", "cnn_cifar")}
        if name in moe_train["launches_per_step"]:
            rows[-1].update((k, v) for k, v in r.items()
                            if k.startswith("bank_"))
            rows[-1]["moe_train_launches"] = moe_train["launches"][name]
            rows[-1]["launches_per_moe_train_step"] = \
                moe_train["launches_per_step"][name]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"kv4_serve": {
        k: {n: x for n, x in v.items() if n != "profile"}
        for k, v in kv4.items()}}))
    print(json.dumps({"training": {
        "layers": TRAIN_LAYERS, "steps": records, "profiles": profiles,
        "average_bpp": schedule.average_bpp(report),
        "allowed_patterns": report["allowed"],
        "b8_weights_ms_per_layer": results[B8]["weights_ms"],
        "launcher_s": launcher_s}}))
    print(json.dumps({"moe_training": moe_train}))
    print(json.dumps({"training_rest": rest}))
    print(json.dumps({"moe_serve": {
        k: ({n: x for n, x in v.items() if n != "profile"}
            if isinstance(v, dict) else v) for k, v in moe.items()}}))
    print(json.dumps({"load": {ARCH: load, MOE_ARCH: dict(
        pack_s=moe["pack_s"], b7_launches=moe["pack_launches"],
        peak_gib_init_and_pack=moe["peak_gib_init_and_pack"],
        **moe["load"])}}))
    print(json.dumps({"spec_serve": {
        tag: {n: x for n, x in v.items() if n != "launches"}
        for tag, v in spec_runs.items()}}))
    print(json.dumps({"fp_paged_serve": fp_paged}))
    print(json.dumps({"dense_configs": dense}))
    print(json.dumps({"soniq": soniq_out}))
    print(json.dumps({"ssm_serve": ssm_out}))
    print(json.dumps({"ssm_training": ssm_train}))
    print(json.dumps({"whisper_serve": whisper_out}))
    print(json.dumps({"whisper_training": whisper_train}))
    print(json.dumps({"vlm": vlm}))
    print(json.dumps({"hybrid": hybrid}))
    print(json.dumps({"hybrid_training": hybrid_train}))
    print(json.dumps({"phase_seconds": clock.laps}))
    print(json.dumps({"phase_cpu_seconds": clock.cpu_s}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
