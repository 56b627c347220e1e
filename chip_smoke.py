#!/usr/bin/env python3
"""Smoke test of the PyTorch port (`fish_speech_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which ends the run with a nonzero exit if it fails:

1. the card (`nvidia-smi` name and power limit), torch and CUDA versions,
   the build of the CUDA kernels from `fish_speech_tpu_torch/csrc/` (the
   tensor-core kernels' registers and spills from ptxas' report), and the
   count of HGMMA (wgmma) instructions in the SASS (`cuobjdump -sass`) of
   the int4 tensor-core kernel, of the two attention forwards
   (`train_fwd_wgmma_kernel`, `prefill_wgmma_kernel`) and of the training
   backward's two kernels (`train_bwd_dkdv_wgmma_kernel`,
   `train_bwd_dq_wgmma_kernel`), none of which may be 0, and the blocks
   per SM of the backward's two kernels (CUDA's occupancy calculator);
   ptxas' report covers the int8 matvec's kernels (`int8_gemv_mma_kernel`,
   `int8_gemv_cluster_kernel`) and the fused int8 FFN
   (`int8_ffn_mma_kernel`) too;
2. each kernel against its plain PyTorch version at the main paths' shapes,
   in bf16 from N(0,1) inputs (pass: max abs error <= 2e-2, mean <= 2e-3,
   the bound of bf16 rounding of P before P.V in the plain version; the
   training forward's O also gets one bf16 step of the value, 2^-7 |O|;
   the training backward's dQ/dK/dV, 2e-2 of the tensor's largest
   magnitude and 1e-2 of its mean magnitude), timed with CUDA events in
   turns (plain, kernel, kernel, plain). The attention kernels' bf16
   cases run their tensor-core route and print TFLOP/s (the backward's
   on the minimal five products a pair): the prefill at B=1 T=64, 1024
   and 4096 and B=2 T=600 with offsets [0, 129], the training forward
   and backward at B=2 T=1024 with a right-padded row, B=1 T=4096 and a
   ragged B=2 T=1000; their fp32 routes ("fp32_tc", on the tensor cores
   in 3xTF32, the prefill's and the training pair's) are held
   on fp32 inputs at JAX's tiny heads (H=2 Hkv=1 D=32: the prefill at
   buckets 64 and 256, the training pair at phase 3b's B=2 T=200) and at
   s2-pro's heads (the prefill at T=256 and at the full width's T=1024, the
   training pair at B=2 T=256, one row padded 30), to 1e-4 (the backward's of each
   tensor's largest magnitude); the training pair in bf16 at the tiny
   heads ("bf16_tf32", the train CLI's B=2 T=256) to the bf16
   bounds. The training rows on the TF32 routes also print `device_ms`
   (the calls replayed from a CUDA graph); their bound is the TF32
   products the kernels issue at 495 TFLOP/s ("fp32_tc", 3 a product)
   with the fp32 one beside it, or bf16's peak ("bf16_tf32").
   The int4 matmul's matvec route runs at s2-pro's eight decode shapes
   (B=1), its tensor-core route at the slow stack's four shapes at B=128
   and B=1024 (the two prompt buckets) and at a ragged (1000, 384, 200,
   g=64); every case is held to one bf16 rounding of W and y, 2^-8
   (|x| @ |W| + |y|) elementwise, against the fp32-W plain version, and
   the tensor-core cases also to their own plain version (the Pallas
   kernel's bf16 W, summed in fp32) within 2^-8 |y| + 1e-5 (|x| @ |W|);
   each prints its TFLOP/s. The int8-KV decode kernel runs in bf16 at the
   slow caches (S = 2048 + 64 at len 1, 257, 1100 and 2048, S = 4096 + 64
   at len 4000) to kernel 2's bounds and in fp32 at phase 3c's tiny cache
   to 1e-4. The fp32 routes of the decode (phase 3's tiny slow and fast
   caches at JAX's widths, D=32 and D=16; the `--tiny` server's slow cache;
   the 64-wide heads of the earlier tiny model) and of the int4 matvec
   (phase 3c's tiny fast shapes) are held
   to 1e-4 and to 1e-5 of |x| @ |W|; the int4 matmul's fp32 route
   ("fp32_tc", `int4_tf32_kernel` on mma.sync, `int4_tf32_wgmma_kernel`
   from 64 rows: x as two TF32 terms times the exact q on
   the tensor cores, each group's sum scaled once) on fp32 x at s2-pro's
   slow wqkv, wo, w13, w2 and fast w13 at B = 9, 128 and 1024, at JAX's
   tiny widths at B = 64 and at the products 13(b') gives it (289 rows
   through the slow stack, 2890 through the fast one), to 1e-5 of
   |x| @ |W| and equal bits on two replays, beside cuBLAS in fp32 on the
   dequantized W (TF32 off), with its `device_ms`; its bound, and that of
   the fp32 prefill and suffix ("fp32_tc"), is the TF32 products the
   kernel issues at 495 TFLOP/s (`_tf32_bound`), with the fp32 one (67
   TFLOP/s) beside it for comparison; the fp32 prefill, decode and training
   forward also at the shapes the parity tool reaches in phase 11 (the
   prompt's bucket at H=32 Hkv=8 D=128; the cut-depth slow and fast
   caches; B=1 at the teacher-forced prompt's length), beside SDPA. The decode cases (slow cache
   S = 4160 at len 1, 257 and 4000, S = 2112 at len 2048, fast cache S =
   10), the int8-KV and fp32 cases and the matvec cases also print
   `device_ms`: the same calls
   captured in one CUDA graph and replayed (no wrapper host cost; the
   matvec walking copies of its weight, and cuBLAS copies of the bf16 W,
   over twice the L2), with the library call's `library_device_ms` and the
   wrapper's host cost (`ms` - `device_ms`). Each case also reports its
   bound (the larger of its bytes over 3.35 TB/s and its operations over
   989 TFLOP/s, H100 SXM) and, where one PyTorch call computes the same
   function, that call's time (SDPA, with `is_causal` where the mask is
   plain causal and the mask tensor where padding or offsets need it, the
   best of three runs for the attention cases; cuBLAS on the dequantized
   weight);
   the int8 matmul's tensor-core kernels (bf16 x: `int8_gemv_mma_kernel`
   at 1-16 rows, `int8_gemv_cluster_kernel` at 17-32, split-K runs summed
   in a thread block cluster's shared memory) run at every int8 shape of
   the serving paths (the slow and fast stacks' eight, the full LM head,
   the semantic head's 4097 columns as a view of rows 16 bytes apart, the
   fast head) at B = 1, 4, 16 and 32, held to 2^-8 |y| + 1e-5 (|x| @ |q|)
   * s of the plain version summed in fp32 and to equal bits on two
   replays of a graph, its CUDA-core kernel (`int8_gemv_fp32_kernel`, fp32
   x) at JAX's tiny model's products (B = 1 and 4) and s2-pro's slow w13
   (B = 1) to 1e-5 (|x| @ |q|) * s and equal bits on two replays; each
   prints `device_ms`, cuBLAS on the
   dequantized bf16 W (`library_device_ms`) and the cast route it replaces
   (`cast_device_ms`, `x @ q.to(bf16) * s.to(bf16)`), all from graphs
   walking weight copies over twice the L2; the fused int8 FFN's
   tensor-core kernel (`int8_ffn_mma_kernel`, bf16 x) at s2-pro's slow and
   fast FFNs at B = 1, 4, 16 and 32, held to 2 bf16 ulps of max |y| of its
   plain version and to equal bits on two replays of a graph, its CUDA-core
   kernel (`int8_ffn_fp32_kernel`, fp32 x) at JAX's tiny slow and fast FFNs
   (B = 1 and 4) and s2-pro's slow FFN (B = 1) to 1e-5 of max |y| and equal
   bits on two replays (cuBLAS on the dequantized fp32 weights with torch's
   gate beside it); each prints `device_ms`, cuBLAS on the dequantized bf16
   w13 and w2 with torch's gate (`library_device_ms`) and the route it
   replaces (`replaced_device_ms`: two `int8_matmul` launches and torch's
   gate), from graphs walking weight copies over twice the L2; the bf16
   decode and int8-KV decode kernels with per-row starts (the lockstep
   batch's left pad) at the slow cache's full width, L=36 B=4 S=2112
   Hkv=8 G=4, starts (700, 129, 5, 0), lengths (2048, 1100, 701, 1), with
   SDPA under the [start, len) mask as the library call;
3. a small-input reference: JAX's tiny model at its widths (slow heads
   D=32, fast heads D=16, G=2; QK norm, untied embeddings, ten codebooks)
   in fp32 runs the same greedy request
   through the kernels on the card (its session's graphs captured at first
   use) and through the plain versions on the CPU (the same step bodies
   run eagerly); token columns must be identical and prefill logits within
   1e-4; then a prefix-cache miss and hit (two prompts sharing 140
   columns; the hit's suffix through the suffix attention's fp32 route)
   give identical columns on the card and the CPU (3c does the same over
   the int8 cache);
3b. a small training reference: a tiny fp32 LoRA model takes two
   `make_train_step` steps through the training kernels on the card (the
   forward's and the backward's "fp32_tc" route, which must carry every
   launch) and
   the plain versions on the CPU; losses and LoRA leaves must agree to
   1e-5;
3c. a small quantized reference: phase 3's tiny fp32 model quantized
   `mixed` (slow int8, fast int4, heads int8) with the int8 KV cache, card
   kernels against CPU plain versions: identical greedy token columns,
   prefill logits within 1e-4; the int4, int8-KV, int8 and fused int8 FFN
   kernels must launch (the int8 matmul's and the FFN's fp32 routes
   counted);
4. the serving slice: the full-width `dual_ar_s2_pro` LM (bf16, random
   weights from a seed, max_seq_len 2048) and the full `dac_s2_pro` codec
   (encoder included) answer streamed requests through
   `TTSInferenceEngine`, one of them with a prompt over 512 tokens. The
   session's CUDA graphs (each request's prefill bucket, the decode step)
   are captured first by `GenerationSession.precompile`, and the codec's
   decode graphs of the code buckets the requests reach (32 and 128) by
   `TTSInferenceEngine.precompile` (capture seconds and both pools printed
   apart from the requests). The audio must be finite and in whole
   frames, the decode kernel and the prefill's tensor-core route must have
   been launched (by graph replays: a replay adds the launches its capture
   recorded), every decode step must have been a replay of the step graph
   and every codec call a replay of a codec graph (no eager body run on
   the card), and a repeated request with the same seed must give
   identical codes. The requests stream from device partials (the
   engine's default for a single-stream session, JAX's): the codec graph
   runs on a partial's device columns before the host reads them. Then
   the short request is served from device and host partials in turns
   (device, host, host, device, one seed): equal codes, each TTFA and
   decode frames/s printed. The first request's TTFA is printed beside the
   others'; then the codec's device ms per replay for each (rows, bucket)
   reached, and the launches of one replayed step by kernel and its
   device time (CUDA events over 64 replays);
4c. the lockstep batch: full-width s2-pro (seed 0) in a
   `GenerationSession(max_batch=4)` serves `generate_batch` over phase 4's
   three prompts and one more (left-padded to a common end, bucket 1024),
   72 new tokens, bf16, then quantized `mixed` with the int8 KV cache: the
   graphs `prefill_4_1024` and `decode_4` captured by `precompile`, no
   body run eagerly after it, the decode kernels (with starts) and the
   prefill's tensor-core route launched (under `mixed` the int8 matvec
   and fused FFN too), a repeat of the seed giving the same codes, every
   row's columns in range, and each row's first logits within 0.05 x max
   |logit| of its prompt's single-stream prefill, from position 0 and at
   the row's own padded positions, with the latter's argmax;
   aggregate frames/s, the replayed step's device ms and its launches are
   printed;
4b. voice cloning on the same model, session and engine: a ~30 s
   reference clip written from a seed under `build/` (16-bit mono PCM at
   24 kHz, so `load_audio` resamples it) with its transcript, in a
   references directory. Its encode graph (bucket 1024) and its prompt's
   prefill graph are captured first; then three streamed requests of 72
   new tokens: by `reference_id` (memory cache on), by `references` (the
   same bytes and text) and by id again, with one seed. Each must give
   finite whole frames and no `error`; the clip must have been encoded
   once (one VQ cache miss, a hit), every prompt prefilled by
   `prefill_1024`, the prefill's tensor-core route and the decode kernel
   launched, the encode graph replayed, no step or codec body run eagerly
   on the card, and the three requests' codes identical. The session keeps
   the prefix cache (`prefix_cache_size=4`): the first request stores its
   prompt's rows, the request by bytes and the repeat by id are hits (two
   `suffix_64` replays, the suffix kernel's bf16 route launched), and a
   fourth with the cache off is cold (`prefill_1024`); the two hits must
   give identical codes, as must the two cold runs; the hit TTFAs are
   printed beside the cold one; the prompt's first logits from the stored
   rows and `prefill_suffix` (at the hit's start and at a 40-column
   suffix) must lie within 0.05 x max |logit| of a cold `prefill`'s, with
   the same argmax. The TTFAs (the
   first with the clip's `load_audio` + encode time apart), frames/s, the
   encode's device ms at bucket 1024, the codec pool and the peak memory
   are printed. The replayed encode's codes must equal an eager run of
   the same body on the card bit for bit; their agreement with an eager
   run without TF32 (cuDNN and matmul) is printed per codebook, not held
   (TF32 against fp32 moves near ties of the argmax);
5. the training slice: the serving model is freed, then `Trainer.fit` runs
   8 LoRA steps (r=8, alpha=16, attention/mlp/embeddings/output, remat on)
   of the full-width `dual_ar_s2_pro` (bf16, random weights, max_seq_len
   1024) on one B=2 x T=1024 batch of the shared data pipeline, repeated.
   Every loss must be finite and the last below the first, sampled frozen
   base tensors bitwise unchanged, every LoRA B leaf nonzero, the
   forward's tensor-core route launched, the backward 288 times on its
   "wgmma" route and never on another, and the checkpoint
   must restore; s/step and tokens/s are printed beside the
   prediction;
5b. the train CLI as a user runs it: `python -m
   fish_speech_tpu_torch.train.cli --tiny` (JAX's tiny model, heads 32
   wide; bf16, its default precision) takes 2 LoRA steps in a process of
   its own on the card, on a proto shard of phase 5's writer: both losses
   must be finite, the slow stack's attention must launch forward and
   backward on "bf16_tf32" (the TF32 kernels on bf16 inputs) and on no
   other route;
6. quantized serving: the training model is freed, full-width s2-pro (bf16,
   seed 0, max_seq_len 2048) is quantized `mixed` (`quantize_dual_ar_lowmem
   (mode="int8", fast_mode="int4")`) and served with the int8 KV cache
   (`kv_quant=True`) to phase 4's short request and its repeat: finite
   whole frames, identical codes on the repeated seed, and `int4_mm`,
   `flash_decode_kv8` and `flash_prefill` (tensor-core route) launched. Then the model is
   rebuilt and quantized `int4` (every layer int4, heads int8) and serves
   the 700-byte request (prefill bucket 1024: the int4 matmul's
   tensor-core route, whose launch count must be > 0). `mixed` keeps the
   prefix cache: the medium request and its repeat, which must be a hit
   through `suffix_64` (the suffix kernel over the int8 cache). Both serve through
   graphs captured beforehand, as phase 4 does, with the same replay
   checks (the codec's decode graphs captured first, as in phase 4), and
   the int8 matmul's kernel must be launched by a replayed decode step and
   torch's int8 cast route never (both sessions' heads are int8); the
   `mixed` step must launch the fused int8 FFN once per slow layer (36)
   and the `int4` step never.
   TTFA, frames/s, weight bytes and peak memory for both, the graph pool
   and the replayed step beside an earlier run's with the int8 cast, the
   replayed step's launches and device time, and the fast stack's time per
   frame on the serving path, eager and replayed from a graph;
7. the fast-stack probe at flagship dims (12 layers x 10 steps, 1536 /
   2560 / 6144): R in {0, 1} x {bf16, w8a8}, each against its plain version
   on one and on two codebook steps (12 and 24 layers at full width, the
   second step re-reading every layer; outputs of rms 1): w8a8 to 1e-5
   (int8 products summed exactly in int32 on both sides), bf16 to 5e-2
   (fp32 sums in another order move a few activations across a bf16
   rounding boundary, a 2^-8 jump each, compounding over the layers).
   Faulty weights in the plain chain (one layer's w2, or one 128-column
   tile of it, from the next layer) must score above each bound. The whole
   120-layer frame is chaotic under such jumps: its error is printed, not
   held; two frames must give equal bits (each column is summed in one
   order). Then ms per frame and effective GB/s through the probe's own
   `_bench`, and, timed alike, the frame's grid barriers alone and its
   weight stream alone (`part_ms`);
8. the continuous batcher's pool: the earlier models freed, full-width
   s2-pro (seed 0, max_seq_len 2048) behind a `ContinuousBatcher(pool_size
   =32, decode_chunk_size=128, first_chunk_size=8, admit_every=4)` and a
   `TTSInferenceEngine` over its `BatcherSession`, with the codec; first
   bf16, then int8 weights (`quantize_dual_ar_lowmem(mode="int8")`) with
   the int8 KV cache. The pool's graphs (the step, and each admission
   signature {1, 4, 16} at the two prompt buckets the texts reach) are
   captured by `precompile` and the codec's decode graphs (buckets 32
   and 64) by the engine's, before any request. A burst of 40 streamed
   requests of 64 new tokens (distinct seeds) from 40 threads: 32
   admitted, the rest parked. Every request must give finite whole frames
   and no `error`; a group must have been parked; every decode step and
   admission prefill must have been a graph replay (no eager body on the
   card after `precompile`); `flash_prefill`'s tensor-core route and
   `flash_decode` (bf16) or `flash_decode_kv8` and the int8 matmul's
   kernel (int8) must have launched, and the int8 pool's replayed step
   must launch that kernel and never torch's int8 cast route, and the
   fused int8 FFN once per FFN of both stacks (36 + 12 x 10 = 156);
   one of the 40 sent again alone must give the codes it got in the
   burst. Printed, not held: aggregate frames/s (all frames over the wall
   time from the first submit to the last frame), per-stream frames/s p50
   and min, TTFA p50, p90 and max, the replayed step's device ms at P=32
   (CUDA events over its replays, every row at position 256) with its
   launches by kernel, the KV pool's bytes, each graph's pool growth, the
   peak memory, the bf16 step at P=8 beside phase 4's P=1 step, and under
   int8 each graph's pool growth beside its body's eager peak of
   temporaries at P=32 and P=1; the graph pools and the int8 steps beside
   an earlier run's with the int8 cast. The int8 pool keeps the prefix
   cache (`prefix_cache_size=4`, the repeat alone runs with it off) and
   then serves a same-reference burst: one request by phase 4b's reference
   stores its prompt's rows, 16 more by the same reference must be
   admitted as prefix hits through `suffix_{k}_64` replays (no eager body);
   four of their prompts, submitted as one admission group and served
   twice, must be two `suffix_4_*` hits with the same codes, and the first
   logits of all 16 as one hit group computes them (the stored row in
   every row of the cache, the suffixes at the group's start) must lie
   within 0.05 x max |logit| of a cold prefill of the same prompts, row
   by row, and of the suffixes over the cold prefill's own int8 rows with
   their argmax (against the cold prefill the argmax is printed: the hit
   attends the prefix's int8 keys, the cold prefill fresh ones);
9. the port's HTTP server over phase 8's int8 / int8-KV pool engine (the
   JAX server's `--int8 --kv-int8 --pool-size 32`): the server's `warm_up`
   (the pool's precompile at every prompt bucket, the codec's, the warm
   request and burst), then `create_app` on 127.0.0.1: health, references
   added from WAV and from FLAC bytes, four concurrent streamed /v1/tts by
   reference id, a msgpack request, /v1/audio/speech as pcm, a client that
   drops its stream after the first frame, and the metrics. Each request
   must answer 200 with a valid WAV header and whole frames of audio, the
   dropped stream must count `cancelled` once, its row must be freed and
   the next request served, and no pool body may run eagerly after
   `warm_up`. Then `python -m fish_speech_tpu_torch.server.main --tiny
   --int8 --no-warmup` in a process of its own on the card answers one
   /v1/tts: JAX's tiny model (heads 32 and 16 wide) with int8 weights,
   through the fp32 attention kernels at those widths and the fp32 int8
   matvec and fused FFN (no route falls back: an answer on the card is the
   kernels' answer);
10. the generation tools as a user runs them, each a process of its own on
   the card: `python -m fish_speech_tpu_torch.tools.tts --tiny` (codes and
   a WAV of whole frames) and the codec CLI's round trip with `--tiny` (7
   frames of audio to codes and back);
11. the checkpoint lifecycle on s2-pro's widths cut to 2 slow and 2 fast
   layers (1.2B parameters), in a temporary directory under `build/`
   removed at the end, each CLI a process of its own on the card:
   `init_dual_ar` in bf16 and `save_dual_ar`, `convert.cli export-dual-ar`
   then `convert.cli dual-ar`, whose checkpoint `load_dual_ar(bf16)` must
   give back bitwise; the full `dac_s2_pro` from `init_dac(1)` through
   `save_codec` and `load_codec`, bitwise; `tools.parity_check
   --save-golden`, then `--golden` (`PARITY OK`), then one run in this
   process that must launch the fp32 prefill, decode and training-forward
   kernels; `tools.quantize --mode int8`, whose checkpoint serves a greedy
   16-token request with the codes of a session over the in-memory
   quantization (the int8 matvec and fused FFN launched), and `--mode int4
   --group-size 128`, bitwise the in-memory tree; two LoRA steps (r 8,
   alpha 16, B=1 x T=512) through `Trainer.fit`, then `tools.merge_lora` on
   their checkpoint: an L1 line above 0, the merged tree bitwise the
   in-memory `merge_lora` on the card, teacher-forced logits within 2e-2
   of max |logit| of the LoRA model's; and `forward_train_naive` at
   B=1 x T=1024 in bf16 (finite logits, the training forward's tensor-core
   route launched). It prints its bytes written and seconds;
12. multi-device on torch.distributed (below, at its code);
13. the evaluation tools on phase 11's model (s2-pro's widths at 2 + 2
   layers, bf16, and the full codec) saved in a temporary directory under
   `build/`: (a) `tools.eval_quality` in this process over a manifest of
   four items (English, Chinese, two by one seeded 5 s reference clip) at
   `--pool-size 8 --ab kv-int8 --ab prefix-cache --asr mock --sim spectral
   --max-new-tokens 32`, once bf16 under one worker (the prefix-cache
   config's second clone a hit) and once `--int8` with the items in
   flight: every config in `report.json`, mock WER and CER 0, SIM in
   [-1, 1], every WAV whole frames, and each config's launches of the
   prefill, decode, suffix (the prefix-cache config of the bf16 run),
   int8-KV decode (the kv-int8 configs), int8 matvec and fused int8 FFN
   (the `--int8` run) above 0; (b) `tools.eval_in_context --precision
   bfloat16`: finite per-frame losses whose mean is `dual_ar_loss`'s
   semantic loss in the same call, through `train_fwd_wgmma_kernel`; (b')
   the same inputs through `tools.eval_in_context` at its default
   `--precision float32` over an int4 checkpoint of the model written by
   `tools.quantize --mode int4 --group-size 128`: finite per-frame losses
   whose mean is within 1e-4 relative the fp32 `dual_ar_loss` semantic
   loss of the int4 tree with every weight dequantized (plain fp32
   products, TF32 off, no int4 kernel launched), every layer product
   through the int4 matmul's "fp32_tc" route (its wgmma tile, launched); (c)
   in phase 9, `tools.api_client --streaming --play` as a process against
   the server: the same bytes as a direct request with its payload, whole
   frames, file-only with no audio backend; (d) `dac_forward` at
   `dac_s2_pro`'s widths in fp32 on 43 frames of seeded audio: the codes
   of `dac_encode`, audio within 1e-4 of `dac_from_indices`, finite
   losses, and the quantizer-dropout draw of 64 samples; (e) the libav
   shim's mp3 and Ogg/Opus decodes against `audio/libcodec`'s, or why it
   is unavailable; (f) phase 5's analytic FLOPs per step, its TFLOP/s and
   its share of 989 TFLOP/s dense bf16;
14. fp16 serving (`--half`): (the kernel cases) the fp16 forms of the
   prefill, suffix (fp16 and int8 cache), decode, int8-KV decode, int8
   matvec (1-16 and 17-32 rows), fused int8 FFN, int4 matvec and int4
   tensor-core kernels against their plain versions at the serving shapes,
   to the bf16 forms' bounds (the int4 products to one fp16 rounding of
   y), timed beside SDPA / cuBLAS on fp16 operands; (a) full-width, full-depth
   `dual_ar_s2_pro` in fp16 with `dac_s2_pro` in fp16 through the single
   session's graphs (prefix cache on): phase 4's short and long requests,
   the short one again (identical codes) and the long one again (a prefix
   hit, the fp16 suffix kernel), TTFA, frames/s, the replayed step's device
   ms, and the audio's max |x| and share of exact zeros beside the fp32
   codec's on the same codes; (b) the server's `build_engine --half --int8
   --kv-int8 --pool-size 32 --prefix-cache 4` and `warm_up` on phase 11's
   model written by the port's writer, a burst of 24 streamed requests
   (the cluster kernel's rows) and one of them again (a prefix hit over the
   int8 cache); (c) fp16 int4 serving: full-width `dual_ar_s2_pro` in fp16
   quantized as phase 6 (`int4`, then `mixed`) with the int8 KV cache and
   the fp16 codec, the short request and its repeat each (whole finite
   frames, identical codes), then `build_engine --half` over an int4
   checkpoint of phase 11's model and one request. Every fp16 kernel
   launches in (a), (b) or (c), no bf16 route does, and the fp16 prefill,
   suffix and int4 tensor-core forms hold HGMMA in their SASS.
   `python3 chip_smoke.py --phase14` runs phase 14 alone (no result line).

Phase 2 also holds the kernels at the pool's shapes: `decode_mma_kernel`
and `decode_kv8_mma_kernel` at B=32, S=2176 (8 layers) with ragged
lengths in 1..2048 (SDPA with the ragged mask as the library call),
`decode_mma_kernel` on the fast cache at B=32 (12 layers, S=10, len 10),
`prefill_wgmma_kernel` over the group prefills (k = 4 and 16 rows at
buckets 128 and 256, offsets 0; every bf16 prefill case with its
`device_ms` and SDPA's), and `int4_wgmma_kernel` at B=32 on the slow
stack's four shapes (cuBLAS on the dequantized W); the kernels' line
gives each kernel's launches in one replayed P=32 step, read from the
pools' captured steps (`launches_per_p32_step`); `int8_mm` (1-16 rows),
`int8_mm_cluster` (17-32 rows: the pool's step) and `int8_mm_fp32` replace
`scripts/microbench/matvec_pallas.py:18`, `int8_ffn`
and `int8_ffn_fp32` `scripts/microbench/ffn_fused_packed.py:17`. The
suffix attention (a prefix-cache hit's prefill over the KV cache, JAX's
einsum in `prefill_suffix`) has four routes: `flash_suffix` (bf16 q, bf16
cache) and `flash_suffix_kv8` (int8 cache), held at S = 2176, start 951,
Ts 64 and 128 at one row and Ts 64 at 4 and 16 rows, with SDPA under the
suffix's mask (over the dequantized cache for int8) as the library call;
`flash_suffix_fp32` and `flash_suffix_kv8_fp32` (`attn_tf32_kernel` with
the bf16 kernel's packing and key split, 64 rows a block) at phase 3's tiny
cache (JAX's widths, then the earlier 64-wide heads) and at the serving
cache's full width (S = 2176, start 951, Ts 64, H=32 Hkv=8 D=128, split
over seven slices) to 1e-4, launched in phases 3 and 3c. `int4_mm_fp32_tc`
is the int4 matmul's fp32 route, launched by 13(b'). `flash_train_fwd_fp32`
and `flash_train_bwd_fp32` are the training pair's "fp32_tc" route
(`attn_tf32_kernel<D, kTrain, float>`, `train_bwd_tf32_kernel<D, float>`),
launched in phases 3b, 11 and 12(c); `flash_train_fwd_bf16_tf32` and
`flash_train_bwd_bf16_tf32` its "bf16_tf32" route at D=32 (the same
kernels on bf16 inputs), launched by phase 5b's train CLI.

Each phase sets the kernels' launch counts to 0 before it drives its path
and reads them after. The line before the last is a JSON object with each
kernel's numbers; the last line is `{"ok": true, "device": {...}}`. No
result is printed when CUDA is unavailable or when the port's package is
not beside this script.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import re
import subprocess
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, iters: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(fn, iters: int) -> float:
    """Device time of one call: `iters` calls (`fn(i)`) captured in one CUDA
    graph, its replay timed with CUDA events, best of three replays. The
    wrappers' host cost (checks, allocation, the ctypes call) is left out,
    and the capture shows that `fn` runs under a CUDA graph."""
    import torch

    fn(0)  # built, scratch made, library plans chosen before the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    best = float("inf")
    for _ in range(3):
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    del graph
    return best


def _library_ms(fn, iters: int) -> float:
    """The library call's time: the best of three `_time_ms` runs, so that
    its first calls on a new shape (plan and workspace set-up) do not count."""
    return min(_time_ms(fn, iters) for _ in range(3))


def _in_turns(plain, kernel, iters):
    """Times (plain, kernel, kernel, plain); returns the two means in ms."""
    p1 = _time_ms(plain, iters)
    k1 = _time_ms(kernel, iters)
    k2 = _time_ms(kernel, iters)
    p2 = _time_ms(plain, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


# H100 SXM peaks (NVIDIA's data sheet): HBM3 bytes/s, dense bf16, int8 and
# TF32 on the tensor cores, fp32 on the CUDA cores
HBM_BYTES_PER_S = 3.35e12
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
PEAK_TF32 = 495e12
PEAK_FP32 = 67e12


# calls each timing of the older phase-2 loops makes (the bf16 decode rows,
# the int4 and int8 matvecs at one row, the bf16 fused FFN), kept short for
# the script's time: timings only, no check reads them
DECODE_ITERS = 50
MATVEC_ITERS = 100
FFN_ITERS = 50


def _bound(flops, nbytes, peak=PEAK_BF16):
    """(ms, "bytes" | "operations"): the least time the card could take."""
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops > t_bytes else "bytes"


def _tf32_bound(flops, nbytes, terms):
    """The bound of an "fp32_tc" kernel, which runs each fp32 product as
    `terms` TF32 products on the tensor cores (2 where one operand is exact
    in TF32: the int4 weights, an int8 cache; else 3, hi hi + hi lo + lo
    hi): those products at the TF32 peak, or the bytes. The fp32 bound
    (67 TFLOP/s on the CUDA cores) is a comparison only, `fp32_bound_ms`:
    these kernels can beat it."""
    return _bound(terms * flops, nbytes, PEAK_TF32)


def _sdpa(q, k, v, mask, causal, **kw):
    """SDPA over (B, H, T, D) with GQA: `is_causal` where the mask is plain
    causal (its flash kernel takes that case, not a mask tensor), else the
    explicit boolean mask."""
    import torch.nn.functional as F

    if causal:
        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              enable_gqa=True, **kw)
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                          enable_gqa=True, **kw)


def _ms_text(ms):
    """A time in ms, or in us where it is under 1 us (bounds of the decode
    and fast-stack cases)."""
    return f"{ms * 1e3:.4f}us" if ms < 1e-3 else f"{ms:.4f}ms"


def _offsets_text(offsets):
    """A prefill case's offsets, one value for a group whose rows share it."""
    if len(offsets) > 1 and len(set(offsets)) == 1:
        return f"[{offsets[0]}] x {len(offsets)}"
    return str(offsets)


def _errors(got, want):
    err = (got.float() - want.float()).abs()
    return err.max().item(), err.mean().item()


def kernel_cases(dev, parity):
    """Phase 2: every kernel against its plain version at main-path shapes;
    `parity` (`parity_shapes`) gives the fp32 routes' shapes in phase 11."""
    import torch

    import torch.nn.functional as F

    from fish_speech_tpu_torch.ops.flash_decode import (flash_decode_attention,
                                                        flash_decode_reference)
    from fish_speech_tpu_torch.ops.flash_prefill import _route as flash_prefill_route
    from fish_speech_tpu_torch.ops.flash_prefill import (
        flash_prefill_attention, flash_prefill_reference)

    gen = torch.Generator(device=dev).manual_seed(0)
    gen32 = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)

    def randn32(*shape):  # fp32 inputs whose low bits are not zero
        return torch.randn(shape, generator=gen32, device=dev, dtype=torch.float32)

    cases = {"flash_prefill": [], "flash_prefill_fp32": [], "flash_decode": []}
    # prefill: flagship heads (H=32, Hkv=8, D=128), prompt buckets, bf16
    # (the tensor-core route), also the pool's group prefills (k = 4 and 16
    # rows at buckets 128 and 256, offsets 0, phase 8); the fp32 route
    # ("fp32_tc", 3xTF32 on the tensor cores: the fp32 models of phases 3,
    # 3c and 11) on fp32 inputs at T=256, at the parity tool's prompt bucket
    # (phase 11) and at the full width's T=1024, to fp32's 1e-4
    for b, t, offsets, dtype in [(1, 64, [0], torch.bfloat16),
                                 (1, 1024, [0], torch.bfloat16),
                                 (2, 600, [0, 129], torch.bfloat16),
                                 (1, 4096, [0], torch.bfloat16),
                                 *((k, t, [0] * k, torch.bfloat16)
                                   for k in (4, 16) for t in (128, 256)),
                                 (1, 256, [0], torch.float32),
                                 (1, parity["bucket"], [0], torch.float32),
                                 (1, 1024, [0], torch.float32)]:
        rand = randn32 if dtype == torch.float32 else randn
        q, k, v = (rand(b, t, n, 128).to(dtype) for n in (32, 8, 8))
        off = torch.tensor(offsets, dtype=torch.int32, device=dev)
        route = flash_prefill_route(dtype)
        got = flash_prefill_attention(q, k, v, off)
        want = flash_prefill_reference(q, k, v, off)
        mx, mean = _errors(got, want)
        iters = 5 if t == 4096 else 20
        ms, plain_ms = _in_turns(lambda i=0: flash_prefill_reference(q, k, v, off),
                                 lambda i=0: flash_prefill_attention(q, k, v, off),
                                 iters)
        pairs = sum((t - o) * (t - o + 1) // 2 for o in offsets)
        flops = 4 * 32 * 128 * pairs
        nbytes = q.element_size() * b * t * 128 * 2 * (32 + 8)
        fp32 = dtype == torch.float32
        bound = _tf32_bound(flops, nbytes, 3) if fp32 else _bound(flops, nbytes)
        # SDPA on the same function: is_causal where every offset is 0, else
        # the causal, offset mask
        i = torch.arange(t, device=dev)
        mask = ((i[None, :] <= i[:, None])[None]
                & (i[None, None, :] >= off[:, None, None]))[:, None]
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        causal = not any(offsets)
        lib = _library_ms(lambda i=0: _sdpa(qt, kt, vt, mask, causal), iters)
        # the kernel's device time, as the pool's prefill graphs replay it,
        # beside SDPA's
        dev_ms = dict(
            **({"fp32_bound_ms": _bound(flops, nbytes, PEAK_FP32)[0]} if fp32 else {}),
            device_ms=_device_ms(lambda i=0: flash_prefill_attention(q, k, v, off),
                                 iters),
            library_device_ms=_device_ms(lambda i=0: _sdpa(qt, kt, vt, mask, causal),
                                         iters))
        cases["flash_prefill_fp32" if fp32 else "flash_prefill"].append(dict(
            shape=f"B={b} T={t} H=32 Hkv=8 D=128 offsets={_offsets_text(offsets)} "
                  f"{str(dtype)[6:]} {route} ({flops / ms / 1e9:.1f} TFLOP/s; "
                  f"SDPA {'is_causal' if causal else 'mask'})",
            max_abs_err=mx, mean_abs_err=mean, ms=ms, plain_ms=plain_ms,
            bound_ms=bound[0], bound_by=bound[1], library_ms=lib,
            tflop_s=flops / ms / 1e9, **dev_ms,
            ok=mx <= 1e-4 if fp32 else mx <= 2e-2 and mean <= 2e-3))
        del q, k, v, got, want, mask
    # the fp32 route at JAX's tiny model's slow heads (H=2 Hkv=1 D=32, the
    # tiny models of phases 3 and 3c and of `--tiny`) at its prompt buckets
    # 64 and 256, first in the list (the headline)
    tiny = []
    for t in (64, 256):
        q, k, v = (randn32(1, t, n, 32) for n in (2, 1, 1))
        off = torch.zeros(1, dtype=torch.int32, device=dev)
        mx, mean = _errors(flash_prefill_attention(q, k, v, off),
                           flash_prefill_reference(q, k, v, off))
        ms, plain_ms = _in_turns(lambda i=0: flash_prefill_reference(q, k, v, off),
                                 lambda i=0: flash_prefill_attention(q, k, v, off), 20)
        flops = 4 * 2 * 32 * t * (t + 1) // 2
        bound = _tf32_bound(flops, 4 * t * 32 * 2 * (2 + 1), 3)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        tiny.append(dict(
            shape=f"B=1 T={t} H=2 Hkv=1 D=32 offsets=[0] fp32 fp32_tc "
                  f"({flops / ms / 1e9:.3f} TFLOP/s; SDPA is_causal)",
            max_abs_err=mx, mean_abs_err=mean, ms=ms, plain_ms=plain_ms,
            bound_ms=bound[0], bound_by=bound[1],
            fp32_bound_ms=_bound(flops, 4 * t * 32 * 2 * (2 + 1), PEAK_FP32)[0],
            library_ms=_library_ms(lambda i=0: _sdpa(qt, kt, vt, None, True), 20),
            device_ms=_device_ms(lambda i=0: flash_prefill_attention(q, k, v, off), 20),
            library_device_ms=_device_ms(lambda i=0: _sdpa(qt, kt, vt, None, True), 20),
            tflop_s=flops / ms / 1e9, ok=mx <= 1e-4))
    cases["flash_prefill_fp32"][:0] = tiny
    # decode: slow cache (36 layers, S = 2048 + 64 is the serving session's;
    # 4160 the 4096-context one) and fast cache (12 layers, S = 10
    # codebooks), one row, and the fast cache at the pool's 32 rows (phase
    # 8's fast stack: every row at the same codebook). Each timed launch
    # reads the next layer, as the decode loop does, so the cache is not
    # served from L2. `device_ms` and `library_device_ms` time the same
    # calls replayed from a CUDA graph.
    for n_layer, b, s, hkv, g, length in [(36, 1, 4160, 8, 4, 1),
                                          (36, 1, 4160, 8, 4, 257),
                                          (36, 1, 2112, 8, 4, 2048),
                                          (36, 1, 4160, 8, 4, 4000),
                                          (12, 1, 10, 4, 3, 10),
                                          (12, 32, 10, 4, 3, 10)]:
        q = randn(b, hkv, g, 128)
        kc, vc = randn(n_layer, b, s, hkv, 128), randn(n_layer, b, s, hkv, 128)
        lens = torch.full((b,), length, dtype=torch.int32, device=dev)
        mx = mean = 0.0
        for layer in (0, n_layer - 1):
            got = flash_decode_attention(q, kc, vc, layer, lens)
            want = flash_decode_reference(q, kc, vc, layer, lens)
            e = _errors(got, want)
            mx, mean = max(mx, e[0]), max(mean, e[1])
        ms, plain_ms = _in_turns(
            lambda i=0: flash_decode_reference(q, kc, vc, i % n_layer, lens),
            lambda i=0: flash_decode_attention(q, kc, vc, i % n_layer, lens),
            DECODE_ITERS)
        bound = _bound(4 * b * hkv * g * 128 * length,
                       2 * b * (2 * length * hkv * 128 + 2 * hkv * g * 128))
        qs = q.reshape(b, hkv * g, 1, 128)

        def sdpa(i=0):
            return F.scaled_dot_product_attention(
                qs, kc[i % n_layer, :, :length].transpose(1, 2),
                vc[i % n_layer, :, :length].transpose(1, 2), enable_gqa=True)

        lib = _time_ms(sdpa, DECODE_ITERS)
        cases["flash_decode"].append(dict(
            shape=f"L={n_layer} B={b} S={s} Hkv={hkv} G={g} D=128 len={length}",
            max_abs_err=mx, mean_abs_err=mean, ms=ms, plain_ms=plain_ms,
            bound_ms=bound[0], bound_by=bound[1], library_ms=lib,
            device_ms=_device_ms(lambda i=0: flash_decode_attention(
                q, kc, vc, i % n_layer, lens), DECODE_ITERS),
            library_device_ms=_device_ms(sdpa, DECODE_ITERS)))
        del kc, vc
    cases["flash_decode"].append(pool_decode_case(dev, randn))
    # the fp32 route (CUDA cores) at the caches of phase 3's tiny fp32 model,
    # JAX's widths: the slow one (2 layers, S = 256 + 8, Hkv=1 G=2 D=32)
    # and the fast one (S = 10 codebooks, Hkv=1 G=2 D=16), at the `--tiny`
    # server's slow cache (S = 256 + 64), at the 64-wide heads of the
    # earlier tiny model (Hkv=2 G=2, Hkv=1 G=3), and at phase 11's
    # cut-depth s2-pro caches (the parity tool's greedy decode: 2 slow
    # layers of the session's S at the prompt plus 32, 2 fast layers), to
    # fp32's 1e-4
    cases["flash_decode_fp32"] = []
    for n_layer, s, hkv, g, length, d in [
            (2, 264, 1, 2, 100, 32), (2, 10, 1, 2, 10, 16), (2, 320, 1, 2, 300, 32),
            (2, 264, 2, 2, 100, 64), (2, 10, 1, 3, 10, 64),
            (2, parity["cache_len"], 8, 4, parity["prompt"] + 32, 128),
            (2, 10, 4, 3, 10, 128)]:
        q = randn(1, hkv, g, d).float()
        kc, vc = (randn(n_layer, 1, s, hkv, d).float() for _ in range(2))
        lens = torch.tensor([length], dtype=torch.int32, device=dev)
        mx, mean = _errors(flash_decode_attention(q, kc, vc, 1, lens),
                           flash_decode_reference(q, kc, vc, 1, lens))
        ms, plain_ms = _in_turns(
            lambda i=0: flash_decode_reference(q, kc, vc, i % n_layer, lens),
            lambda i=0: flash_decode_attention(q, kc, vc, i % n_layer, lens),
            100)
        bound = _bound(4 * hkv * g * d * length,
                       4 * (2 * length * hkv * d + 2 * hkv * g * d), PEAK_FP32)
        qs = q.reshape(1, hkv * g, 1, d)

        def sdpa(i=0):
            return F.scaled_dot_product_attention(
                qs, kc[i % n_layer, :, :length].transpose(1, 2),
                vc[i % n_layer, :, :length].transpose(1, 2), enable_gqa=True)

        cases["flash_decode_fp32"].append(dict(
            shape=f"L={n_layer} B=1 S={s} Hkv={hkv} G={g} D={d} len={length} fp32",
            max_abs_err=mx, mean_abs_err=mean, ms=ms, plain_ms=plain_ms,
            bound_ms=bound[0], bound_by=bound[1], library_ms=_time_ms(sdpa, 100),
            device_ms=_device_ms(lambda i=0: flash_decode_attention(
                q, kc, vc, i % n_layer, lens), 100),
            library_device_ms=_device_ms(sdpa, 100), ok=mx <= 1e-4))
    cases.update(suffix_kernel_cases(dev, randn, randn32))
    cases.update(train_kernel_cases(dev, randn, parity["train_t"]))
    cases.update(quant_kernel_cases(dev, randn))
    cases["int4_mm_fp32_tc"] = int4_fp32_tc_cases(dev, randn32)
    for name, row in starts_decode_cases(dev, randn).items():
        cases[name].append(row)
    cases.update(int8_kernel_cases(dev, randn))
    cases.update(int8_ffn_kernel_cases(dev, randn))
    torch.cuda.synchronize()
    for name, rows in cases.items():
        for r in rows:
            lib = r.get("library_ms")
            print(f"kernel {name} [{r['shape']}]: max_abs_err={r['max_abs_err']:.3e} "
                  f"mean_abs_err={r['mean_abs_err']:.3e} kernel_ms={r['ms']:.4f} "
                  f"plain_ms={r['plain_ms']:.4f} bound={_ms_text(r['bound_ms'])} "
                  f"({r['bound_by']}) library_ms="
                  + ("null" if lib is None else f"{lib:.4f}")
                  + (f" library_causal_ms={r['library_causal_ms']:.4f}"
                     if "library_causal_ms" in r else "")
                  + (f" device_ms={r['device_ms']:.4f} wrapper_host_ms="
                     f"{max(0.0, r['ms'] - r['device_ms']):.4f}"
                     if "device_ms" in r else "")
                  + (f" library_device_ms={r['library_device_ms']:.4f}"
                     if "library_device_ms" in r else "")
                  + (f" cast_device_ms={r['cast_device_ms']:.4f} replays_equal="
                     f"{r['replays_equal']}" if "cast_device_ms" in r else "")
                  + (f" replaced_device_ms={r['replaced_device_ms']:.4f} max_ulps="
                     f"{r['max_ulps']:.2f} replays_equal={r['replays_equal']}"
                     if "replaced_device_ms" in r else "")
                  + (f" replays_equal={r['replays_equal']}" if "replays_equal" in r
                     and "cast_device_ms" not in r and "replaced_device_ms" not in r
                     else "")
                  + (f" fp32_bound={_ms_text(r['fp32_bound_ms'])}"
                     if "fp32_bound_ms" in r else "")
                  + "".join(f" {k}={v[0]:.3e}/{v[1]:.3e}"
                            for k, v in r.get("outputs", {}).items()))
            ok = r.get("ok", r["max_abs_err"] <= 2e-2 and r["mean_abs_err"] <= 2e-3)
            if not ok:
                raise SystemExit(f"{name} disagrees with its plain version at "
                                 f"{r['shape']}")
    return cases


# the prefix cache's suffix prefill (phases 4b, 6 and 8): the slow cache of
# the serving sessions and pool (S = 2048 + 128, Hkv=8, G=4, D=128) with a
# stored ~950-column voice-clone prefix, start 951: one request (a 64- or a
# 128-column suffix bucket) and admission groups of 4 and 16 rows; 8 layers,
# each timed call reading the next, over a bf16 and an int8 cache; the fp32
# route at phase 3's tiny cache (2 layers, S = 256 + 8, start 140) at JAX's
# tiny widths (H=2 Hkv=1 D=32), at the earlier 64-wide heads (H=4 Hkv=2)
# and at the serving cache's full width (start 951, Ts 64, 8 layers)
SUFFIX_START, SUFFIX_S = 951, 2176
SUFFIX_CASES = [(1, 64), (1, 128), (4, 64), (16, 64)]


def _suffix_cache(dev, randn, n_layer, b, s, hkv, d, kv8, dtype, randn32=None):
    """A random stacked cache: bf16 (or `dtype`) k/v from N(0, 1), or int8
    k/v (N(0, 1) x 40, rounded) with bf16 scales within 10% of 1/40: k and
    v of unit scale either way, as the bf16 bound assumes."""
    import torch

    shape = (n_layer, b, s, hkv, d)
    if not kv8:
        if dtype == torch.float32 and randn32 is not None:
            return {"k": randn32(*shape), "v": randn32(*shape)}
        return {"k": randn(*shape).to(dtype), "v": randn(*shape).to(dtype)}
    out = {}
    for n in ("k", "v"):
        out[n] = (randn(*shape).float() * 40).clamp(-127, 127).round().to(torch.int8)
        out[n + "s"] = ((1 + 0.1 * randn(*shape[:4]).float().clamp(-1, 1)) / 40
                        ).to(torch.bfloat16)
    return out


def suffix_kernel_cases(dev, randn, randn32):
    """The suffix attention's four routes against their plain version: bf16
    q over a bf16 and an int8 cache (wgmma) at the serving shapes, fp32 q
    (`randn32`'s inputs) over an fp32 and an int8 cache (3xTF32 on mma.sync)
    at the tiny ones and the serving one.
    SDPA with the suffix's causal mask is the library call (over the
    dequantized cache for int8). Each case prints its bound: the q, K/V
    (scales) and output bytes of keys [0, start + Ts) of each row, and
    4 D H operations per visible (query, key) pair (on fp32 q the TF32
    products the kernel issues for them, `_tf32_bound`)."""
    import torch

    import torch.nn.functional as F

    from fish_speech_tpu_torch.ops.flash_prefill import (
        _suffix_route, flash_suffix_attention, flash_suffix_reference)

    cases = {n: [] for n in ("flash_suffix", "flash_suffix_kv8", "flash_suffix_fp32",
                             "flash_suffix_kv8_fp32")}
    shapes = [(8, b, SUFFIX_S, 32, 8, 128, SUFFIX_START, ts, torch.bfloat16)
              for b, ts in SUFFIX_CASES]
    shapes.append((2, 1, 264, 2, 1, 32, 140, 64, torch.float32))  # JAX's tiny widths
    shapes.append((2, 1, 264, 4, 2, 64, 140, 64, torch.float32))
    shapes.append((8, 1, SUFFIX_S, 32, 8, 128, SUFFIX_START, 64, torch.float32))
    for n_layer, b, s, h, hkv, d, start, ts, dtype in shapes:
        fp32 = dtype == torch.float32
        for kv8 in (False, True):
            name = "flash_suffix" + ("_kv8" if kv8 else "") + ("_fp32" if fp32 else "")
            cache = _suffix_cache(dev, randn, n_layer, b, s, hkv, d, kv8, dtype, randn32)
            q = (randn32(b, ts, h, d) if fp32 else randn(b, ts, h, d).to(dtype))
            st = torch.tensor([start], dtype=torch.int32, device=dev)
            mx = mean = 0.0
            for layer in (0, n_layer - 1):
                e = _errors(flash_suffix_attention(q, cache, layer, st),
                            flash_suffix_reference(q, cache, layer, st))
                mx, mean = max(mx, e[0]), max(mean, e[1])
            iters = 20
            ms, plain_ms = _in_turns(
                lambda i=0: flash_suffix_reference(q, cache, i % n_layer, st),
                lambda i=0: flash_suffix_attention(q, cache, i % n_layer, st), iters)
            kv = start + ts
            pairs = b * (ts * start + ts * (ts + 1) // 2)
            flops = 4 * d * h * pairs
            kv_bytes = b * kv * hkv * d * (1 if kv8 else q.element_size()) * 2
            nbytes = (2 * q.numel() * q.element_size() + kv_bytes
                      + (b * kv * hkv * 2 * 2 if kv8 else 0))
            bound = (_tf32_bound(flops, nbytes, 2 if kv8 else 3) if fp32
                     else _bound(flops, nbytes))
            # SDPA on the same function: the suffix's causal mask over keys
            # [0, start + Ts) of each layer (the int8 cache dequantized
            # beforehand, not timed)
            i_, j_ = torch.arange(ts, device=dev), torch.arange(kv, device=dev)
            mask = (j_[None, :] <= start + i_[:, None])[None, None]
            if kv8:
                kl = [(cache["k"][i, :, :kv].float() * cache["ks"][i, :, :kv, :, None].float()
                       ).to(dtype).transpose(1, 2) for i in range(n_layer)]
                vl = [(cache["v"][i, :, :kv].float() * cache["vs"][i, :, :kv, :, None].float()
                       ).to(dtype).transpose(1, 2) for i in range(n_layer)]
            else:
                kl = [cache["k"][i, :, :kv].transpose(1, 2) for i in range(n_layer)]
                vl = [cache["v"][i, :, :kv].transpose(1, 2) for i in range(n_layer)]
            qt = q.transpose(1, 2)

            def sdpa(i=0):
                return F.scaled_dot_product_attention(
                    qt, kl[i % n_layer], vl[i % n_layer], attn_mask=mask,
                    enable_gqa=True)

            cases[name].append(dict(
                shape=f"L={n_layer} B={b} S={s} H={h} Hkv={hkv} D={d} start={start} "
                      f"Ts={ts} {str(dtype)[6:]} q, {'int8' if kv8 else str(dtype)[6:]} "
                      f"cache, {_suffix_route(dtype, kv8)} "
                      f"({flops / ms / 1e9:.1f} TFLOP/s; SDPA mask)",
                max_abs_err=mx, mean_abs_err=mean, ms=ms, plain_ms=plain_ms,
                bound_ms=bound[0], bound_by=bound[1],
                library_ms=_library_ms(sdpa, iters),
                device_ms=_device_ms(lambda i=0: flash_suffix_attention(
                    q, cache, i % n_layer, st), iters),
                library_device_ms=_device_ms(sdpa, iters),
                ok=mx <= 1e-4 if fp32 else mx <= 2e-2 and mean <= 2e-3,
                **({"fp32_bound_ms": _bound(flops, nbytes, PEAK_FP32)[0]} if fp32 else {})))
            del cache, kl, vl
    return cases


# the pool's decode attention (phase 8): B=32 rows of the P=32 step's slow
# cache (S = 2048 + 128, Hkv=8, G=4, D=128) at ragged lengths in 1..2048
# from a seed, over 8 layers (each timed call reads the next, 1.1 GB of K
# and of V in all, so the cache is not served from L2)
POOL_LAYERS, POOL_S = 8, 2176


def _pool_lengths(dev):
    import torch

    lens = np.random.default_rng(8).integers(1, 2049, 32)
    lens[:2] = (1, 2048)
    return torch.tensor(lens, dtype=torch.int32, device=dev)


def _ragged_sdpa(lens, s):
    """SDPA's boolean mask for ragged rows: (B, 1, 1, s), key j visible to
    row b iff j < lens[b]."""
    import torch

    return (torch.arange(s, device=lens.device)[None, :] < lens[:, None])[:, None, None]


def pool_decode_case(dev, randn, dtype=None):
    """`decode_mma_kernel` at the pool's shapes against its plain version,
    with device times (graph replays) and SDPA's on the ragged mask; q and
    the cache in `randn`'s dtype (bf16), or in `dtype` (fp16)."""
    import torch
    import torch.nn.functional as F

    from fish_speech_tpu_torch.ops.flash_decode import (flash_decode_attention,
                                                        flash_decode_reference)

    hkv, g, n_layer, s = 8, 4, POOL_LAYERS, POOL_S
    dtype = dtype or torch.bfloat16
    lens = _pool_lengths(dev)
    lmax = int(lens.max())
    q = randn(32, hkv, g, 128).to(dtype)
    kc = randn(n_layer, 32, s, hkv, 128).to(dtype)
    vc = randn(n_layer, 32, s, hkv, 128).to(dtype)
    mx = mean = 0.0
    for layer in (0, n_layer - 1):
        e = _errors(flash_decode_attention(q, kc, vc, layer, lens),
                    flash_decode_reference(q, kc, vc, layer, lens))
        mx, mean = max(mx, e[0]), max(mean, e[1])
    ms, plain_ms = _in_turns(
        lambda i=0: flash_decode_reference(q, kc, vc, i % n_layer, lens),
        lambda i=0: flash_decode_attention(q, kc, vc, i % n_layer, lens), 20)
    total = int(lens.sum())
    bound = _bound(4 * hkv * g * 128 * total,
                   2 * (2 * total * hkv * 128 + 2 * 32 * hkv * g * 128))
    qs = q.reshape(32, hkv * g, 1, 128)
    mask = _ragged_sdpa(lens, lmax)

    def sdpa(i=0):
        return F.scaled_dot_product_attention(
            qs, kc[i % n_layer, :, :lmax].transpose(1, 2),
            vc[i % n_layer, :, :lmax].transpose(1, 2), attn_mask=mask,
            enable_gqa=True)

    row = dict(shape=f"L={n_layer} B=32 S={s} Hkv={hkv} G={g} D=128 ragged "
                     f"len 1..2048 (sum {total}; SDPA ragged mask) {str(q.dtype)[6:]}",
               max_abs_err=mx, mean_abs_err=mean, ms=ms, plain_ms=plain_ms,
               bound_ms=bound[0], bound_by=bound[1], library_ms=_library_ms(sdpa, 20),
               device_ms=_device_ms(lambda i=0: flash_decode_attention(
                   q, kc, vc, i % n_layer, lens), 40),
               library_device_ms=_device_ms(sdpa, 40))
    del kc, vc
    return row


def pool_decode_kv8_case(dev, randn, dtype=None):
    """`decode_kv8_mma_kernel` at the pool's shapes (the int8 pool's slow
    cache), against its plain version; SDPA on K/V dequantized beforehand
    to q's dtype, with the ragged mask; q in `randn`'s dtype (bf16), or in
    `dtype` (fp16)."""
    import torch
    import torch.nn.functional as F

    from fish_speech_tpu_torch.models.dual_ar import _kv_dequant, _kv_quant
    from fish_speech_tpu_torch.ops.flash_decode import (
        flash_decode_attention_kv8, flash_decode_kv8_reference)

    hkv, g, n_layer, s = 8, 4, POOL_LAYERS, POOL_S
    dtype = dtype or torch.bfloat16
    lens = _pool_lengths(dev)
    lmax = int(lens.max())
    kq, ks = _kv_quant(randn(n_layer, 32, s, hkv, 128))
    vq, vs = _kv_quant(randn(n_layer, 32, s, hkv, 128))
    q = randn(32, hkv, g, 128).to(dtype)
    mx = mean = 0.0
    for layer in (0, n_layer - 1):
        e = _errors(flash_decode_attention_kv8(q, kq, ks, vq, vs, layer, lens),
                    flash_decode_kv8_reference(q, kq, ks, vq, vs, layer, lens))
        mx, mean = max(mx, e[0]), max(mean, e[1])

    def kernel(i=0):
        return flash_decode_attention_kv8(q, kq, ks, vq, vs, i % n_layer, lens)

    ms, plain_ms = _in_turns(
        lambda i=0: flash_decode_kv8_reference(q, kq, ks, vq, vs, i % n_layer, lens),
        kernel, 20)
    kd = _kv_dequant(kq[:, :, :lmax], ks[:, :, :lmax], q.dtype)
    vd = _kv_dequant(vq[:, :, :lmax], vs[:, :, :lmax], q.dtype)
    qs = q.reshape(32, hkv * g, 1, 128)
    mask = _ragged_sdpa(lens, lmax)

    def sdpa(i=0):
        return F.scaled_dot_product_attention(
            qs, kd[i % n_layer].transpose(1, 2), vd[i % n_layer].transpose(1, 2),
            attn_mask=mask, enable_gqa=True)

    total = int(lens.sum())
    bound = _bound(4 * hkv * g * 128 * total,
                   2 * total * hkv * 128 + 2 * 2 * total * hkv + 2 * 2 * 32 * hkv * g * 128)
    row = dict(shape=f"L={n_layer} B=32 S={s} Hkv={hkv} G={g} D=128 ragged len "
                     f"1..2048 (sum {total}) int8 K/V {str(q.dtype)[6:]} (SDPA ragged "
                     f"mask)",
               max_abs_err=mx, mean_abs_err=mean, ms=ms, plain_ms=plain_ms,
               bound_ms=bound[0], bound_by=bound[1], library_ms=_library_ms(sdpa, 20),
               device_ms=_device_ms(kernel, 40), library_device_ms=_device_ms(sdpa, 40))
    del kq, ks, vq, vs, kd, vd
    return row


# the lockstep batch's decode (phase 4c) at the slow cache's full width: 36
# layers of the serving session's S = 2048 + 64, Hkv=8 G=4 D=128, B=4 rows
# left-padded to a common end, each attending [start, len) (the kernels'
# `starts`: one start past two whole slices and inside a tile)
STARTS_LENS, STARTS = (2048, 1100, 701, 1), (700, 129, 5, 0)


def starts_decode_cases(dev, randn):
    """`decode_mma_kernel` and `decode_kv8_mma_kernel` with per-row starts
    against their plain versions, with device times (graph replays) and
    SDPA's under the [start, len) mask (over K/V dequantized beforehand for
    the int8 cache)."""
    import torch
    import torch.nn.functional as F

    from fish_speech_tpu_torch.models.dual_ar import _kv_dequant, _kv_quant
    from fish_speech_tpu_torch.ops.flash_decode import (
        flash_decode_attention, flash_decode_attention_kv8,
        flash_decode_kv8_reference, flash_decode_reference)

    n_layer, b, s, hkv, g = 36, len(STARTS_LENS), 2112, 8, 4
    lens = torch.tensor(STARTS_LENS, dtype=torch.int32, device=dev)
    starts = torch.tensor(STARTS, dtype=torch.int32, device=dev)
    lmax = max(STARTS_LENS)
    visible = sum(e - a for a, e in zip(STARTS, STARTS_LENS))
    j = torch.arange(lmax, device=dev)
    mask = ((j[None, :] >= starts[:, None]) & (j[None, :] < lens[:, None]))[:, None, None]
    q = randn(b, hkv, g, 128)
    qs = q.reshape(b, hkv * g, 1, 128)
    rows = {}
    for name in ("flash_decode", "flash_decode_kv8"):
        kv8 = name == "flash_decode_kv8"
        if kv8:
            kc, ks = _kv_quant(randn(n_layer, b, s, hkv, 128))
            vc, vs = _kv_quant(randn(n_layer, b, s, hkv, 128))
            kd = _kv_dequant(kc[:, :, :lmax], ks[:, :, :lmax], torch.bfloat16)
            vd = _kv_dequant(vc[:, :, :lmax], vs[:, :, :lmax], torch.bfloat16)

            def kernel(i=0):
                return flash_decode_attention_kv8(q, kc, ks, vc, vs, i % n_layer,
                                                  lens, starts)

            def plain(i=0):
                return flash_decode_kv8_reference(q, kc, ks, vc, vs, i % n_layer,
                                                  lens, starts)

            nbytes = (visible * hkv * 128 * 2 + 2 * 2 * visible * hkv
                      + 2 * 2 * b * hkv * g * 128)
        else:
            kc, vc = randn(n_layer, b, s, hkv, 128), randn(n_layer, b, s, hkv, 128)
            kd, vd = kc[:, :, :lmax], vc[:, :, :lmax]

            def kernel(i=0):
                return flash_decode_attention(q, kc, vc, i % n_layer, lens, starts)

            def plain(i=0):
                return flash_decode_reference(q, kc, vc, i % n_layer, lens, starts)

            nbytes = 2 * (2 * visible * hkv * 128 + 2 * b * hkv * g * 128)

        def sdpa(i=0):
            return F.scaled_dot_product_attention(
                qs, kd[i % n_layer].transpose(1, 2), vd[i % n_layer].transpose(1, 2),
                attn_mask=mask, enable_gqa=True)

        mx = mean = 0.0
        for layer in (0, n_layer - 1):
            e = _errors(kernel(layer), plain(layer))
            mx, mean = max(mx, e[0]), max(mean, e[1])
        ms, plain_ms = _in_turns(plain, kernel, 100)
        bound = _bound(4 * hkv * g * 128 * visible, nbytes)
        rows[name] = dict(
            shape=f"L={n_layer} B={b} S={s} Hkv={hkv} G={g} D=128 starts={list(STARTS)} "
                  f"len={list(STARTS_LENS)} ({visible} visible){' int8 K/V' if kv8 else ''}"
                  f" (SDPA [start, len) mask)",
            max_abs_err=mx, mean_abs_err=mean, ms=ms, plain_ms=plain_ms,
            bound_ms=bound[0], bound_by=bound[1], library_ms=_library_ms(sdpa, 100),
            device_ms=_device_ms(kernel, 100), library_device_ms=_device_ms(sdpa, 100))
        del kc, vc, kd, vd
    return rows


def _within_bf16_step(got, want):
    want = want.float()
    return bool(((got.float() - want).abs() <= 2e-2 + 2 ** -7 * want.abs()).all())


def train_kernel_cases(dev, randn, parity_t):
    """The training attention's forward and backward kernels against their
    plain versions on the same inputs (the backward on the plain forward's
    O and lse). Bounds, bf16 from N(0,1): O to 2e-2 plus one bf16 step of
    the value (2^-7 |O|) elementwise and 2e-3 mean abs (the tensor-core
    kernel rounds the unnormalised P to bf16, the plain version the
    normalised one; rows with few visible keys have |O| above 2, where the
    two roundings can land one step apart); lse, fp32 on both sides, to
    1e-4; the fp32 route's O to 1e-4; dQ, dK and dV, which are not convex
    combinations, to 2e-2 of the tensor's largest magnitude (max) and 1e-2
    of its mean magnitude (mean): one bf16 rounding of the output, plus the
    plain version's bf16 rounding of P and dS."""
    import torch

    from fish_speech_tpu_torch.ops.flash_train import _route as flash_train_route
    from fish_speech_tpu_torch.ops.flash_train import (
        flash_train_backward, flash_train_backward_reference, flash_train_forward,
        flash_train_forward_reference)

    cases = {"flash_train_fwd": [], "flash_train_fwd_fp32": [],
             "flash_train_bwd": [], "flash_train_bwd_fp32": [],
             "flash_train_fwd_bf16_tf32": [], "flash_train_bwd_bf16_tf32": []}
    names = {"wgmma": "", "fp32_tc": "_fp32", "bf16_tf32": "_bf16_tf32"}
    # s2-pro's heads (H=32 Hkv=8 D=128): the fine-tune shape with a
    # right-padded row, the default max_length, and a ragged T (not a
    # multiple of the 64-row tile), in bf16 (the tensor-core route); the
    # fp32 route ("fp32_tc", 3xTF32 on the tensor cores) first at JAX's
    # tiny heads (H=2 Hkv=1 D=32, phase 3b's B=2 T=200 with a padded row),
    # then once at a small shape and at the parity tool's teacher-forced
    # prompt (`parity_t`, phase 11), to 1e-4; bf16 at the tiny heads
    # ("bf16_tf32", the train CLI's `--tiny` batch: B=2 T=256, a padded row)
    big, tiny = (32, 8, 128), (2, 1, 32)
    for b, t, pads, dtype, (h, hkv, d) in [
            (2, 1024, [0, 100], torch.bfloat16, big),
            (1, 4096, [0], torch.bfloat16, big),
            (2, 1000, [0, 0], torch.bfloat16, big),
            (2, 200, [0, 37], torch.float32, tiny),
            (2, 256, [0, 30], torch.float32, big),
            (1, parity_t, [0], torch.float32, big),
            (2, 256, [0, 40], torch.bfloat16, tiny)]:
        q, k, v = (randn(b, t, n, d).to(dtype) for n in (h, hkv, hkv))
        kvalid = torch.ones((b, t), dtype=torch.int32, device=dev)
        for i, n in enumerate(pads):
            if n:
                kvalid[i, -n:] = 0
        do = randn(b, t, h, d).to(dtype) * kvalid[:, :, None, None].to(dtype)
        fp32 = dtype == torch.float32
        route = flash_train_route(dtype, d)
        # visible (query, key) pairs: causal and key-valid
        pairs = sum((t - n) * (t - n + 1) // 2 + n * (t - n) for n in pads)
        flops = 4 * h * d * pairs

        o, lse = flash_train_forward(q, k, v, kvalid)
        want_o, want_lse = flash_train_forward_reference(q, k, v, kvalid)
        e_o, e_lse = _errors(o, want_o), _errors(lse, want_lse)
        ms, plain_ms = _in_turns(
            lambda i=0: flash_train_forward_reference(q, k, v, kvalid),
            lambda i=0: flash_train_forward(q, k, v, kvalid), 10)
        shape = (f"B={b} T={t} H={h} Hkv={hkv} D={d} right_pad={pads} "
                 f"{str(dtype)[6:]} {route} ({flops / ms / 1e9:.3f} TFLOP/s)")
        io_bytes = q.element_size() * b * t * d * (h + hkv)  # q, o | k, v
        fwd_bytes = 2 * io_bytes + 4 * b * h * t
        # inputs q, k, v, O, dO, lse and kvalid once, dQ, dK and dV once
        bwd_bytes = (q.element_size() * b * t * d * (4 * h + 4 * hkv)
                     + 4 * b * h * t + 4 * b * t)
        # "fp32_tc": the TF32 products its kernels issue (3 a product) at
        # 495 TFLOP/s, the fp32 bound beside it; bf16: bf16's peak
        # the minimal five products (S, dP, dV, dK, dQ) a pair
        bwd_flops = 10 * h * d * pairs
        if fp32:
            fwd_bound = _tf32_bound(flops, fwd_bytes, 3)
            bwd_bound = _tf32_bound(bwd_flops, bwd_bytes, 3)
            extra_fwd = {"fp32_bound_ms": _bound(flops, fwd_bytes, PEAK_FP32)[0]}
            extra_bwd = {"fp32_bound_ms": _bound(bwd_flops, bwd_bytes, PEAK_FP32)[0]}
        else:
            fwd_bound = _bound(flops, fwd_bytes)
            bwd_bound = _bound(bwd_flops, bwd_bytes)
            extra_fwd, extra_bwd = {}, {}
        tc = route != "wgmma"  # the TF32 kernels: their device time too
        if tc:
            extra_fwd["device_ms"] = _device_ms(
                lambda i=0: flash_train_forward(q, k, v, kvalid), 10)
        # SDPA on the same function: is_causal where no key is padded, else
        # the causal, key-valid mask; a padded case also times is_causal,
        # which gives the same O on every row that is not padding
        i = torch.arange(t, device=dev)
        mask = ((i[None, :] <= i[:, None])[None]
                & kvalid[:, None, :].bool())[:, None]
        qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
        causal = not any(pads)
        shape += f"; SDPA {'is_causal' if causal else 'mask'}"

        def sdpa_fwd(i=0, causal=causal):
            return _sdpa(qt, kt, vt, mask, causal)

        def sdpa_fwd_bwd(i=0, causal=causal):
            leaves = [x.detach().requires_grad_(True) for x in (qt, kt, vt)]
            out = _sdpa(*leaves, mask, causal)
            return torch.autograd.grad(out, leaves, dot)

        lib_fwd = _library_ms(sdpa_fwd, 10)
        if tc:  # SDPA's device time beside the kernel's
            extra_fwd["library_device_ms"] = _device_ms(sdpa_fwd, 10)
        extra = dict(extra_fwd, **({} if causal else {
            "library_causal_ms": _library_ms(lambda i=0: sdpa_fwd(causal=True), 10)}))
        cases["flash_train_fwd" + names[route]].append(dict(
            shape=shape, max_abs_err=max(e_o[0], e_lse[0]),
            mean_abs_err=max(e_o[1], e_lse[1]), ms=ms, plain_ms=plain_ms,
            bound_ms=fwd_bound[0], bound_by=fwd_bound[1], library_ms=lib_fwd,
            **extra,
            outputs={"O": e_o, "lse": e_lse}, tflop_s=flops / ms / 1e9,
            ok=(e_o[0] <= 1e-4 if fp32 else _within_bf16_step(o, want_o)
                and e_o[1] <= 2e-3) and e_lse[0] <= 1e-4
            and getattr(flash_train_forward, f"launches_{route}") > 0))
        # the backward: SDPA forward+backward minus its forward, on the same
        # mask (and is_causal beside it where a key is padded)
        lib_bwd = _library_ms(sdpa_fwd_bwd, 5) - lib_fwd
        lib_causal = extra.get("library_causal_ms")
        extra = extra_bwd
        if not causal:
            extra["library_causal_ms"] = _library_ms(
                lambda i=0: sdpa_fwd_bwd(causal=True), 5) - lib_causal
        args = (q, k, v, kvalid, want_o, want_lse, do)
        if tc:
            extra["device_ms"] = _device_ms(lambda i=0: flash_train_backward(*args), 5)
        n_route = getattr(flash_train_backward, f"launches_{route}")
        got = flash_train_backward(*args)
        ran = getattr(flash_train_backward, f"launches_{route}") == n_route + 1
        want = flash_train_backward_reference(*args)
        errs, ok = {}, ran
        for name, g, w in zip(("dQ", "dK", "dV"), got, want):
            errs[name] = _errors(g, w)
            ref = w.float().abs()
            ok &= bool(torch.isfinite(g.float()).all())
            if fp32:  # only the order of the fp32 sums differs
                ok &= errs[name][0] <= 1e-4 * max(1.0, ref.max().item())
            else:
                ok &= (errs[name][0] <= 2e-2 * ref.max().item()
                       and errs[name][1] <= 1e-2 * ref.mean().item())
        ms, plain_ms = _in_turns(lambda i=0: flash_train_backward_reference(*args),
                                 lambda i=0: flash_train_backward(*args), 5)
        cases["flash_train_bwd" + names[route]].append(dict(
            shape=f"B={b} T={t} H={h} Hkv={hkv} D={d} right_pad={pads} "
                  f"{str(dtype)[6:]} {route} ({bwd_flops / ms / 1e9:.3f} TFLOP/s "
                  f"on five products; SDPA {'is_causal' if causal else 'mask'})",
            max_abs_err=max(e[0] for e in errs.values()),
            mean_abs_err=max(e[1] for e in errs.values()), ms=ms,
            plain_ms=plain_ms, bound_ms=bwd_bound[0], bound_by=bwd_bound[1],
            library_ms=lib_bwd, **extra, outputs=errs,
            tflop_s=bwd_flops / ms / 1e9, ok=ok))
        del q, k, v, do, o, lse, want_o, want_lse, got, want, args
    torch.cuda.empty_cache()
    return cases


L2_COLD_BYTES = 100_000_000  # twice the H100's 50 MB L2

# s2-pro's int4 weights, I -> O (w13 fused): slow stack, then fast stack
INT4_SHAPES = [("slow wqkv", 2560, 6144), ("slow wo", 4096, 2560),
               ("slow w13", 2560, 19456), ("slow w2", 9728, 2560),
               ("fast wqkv", 1536, 2560), ("fast wo", 1536, 1536),
               ("fast w13", 1536, 12288), ("fast w2", 6144, 1536)]


def quant_kernel_cases(dev, randn):
    """The int4 matmul's routes and the int8-KV decode kernel against their
    plain versions at the quantized serving path's shapes: the matvec route
    at the eight decode shapes (B=1); the tensor-core route at the slow
    stack's four shapes at B=128 (the short prompt's bucket) and B=1024
    (the long one's), and at a ragged (1000, 384, 200, g=64); the matvec's
    fp32 route at phase 3c's tiny shapes; the int8-KV decode at the slow
    caches (bf16) and phase 3c's tiny one (fp32)."""
    import torch
    import torch.nn.functional as F

    from fish_speech_tpu_torch.models.dual_ar import _kv_dequant, _kv_quant
    from fish_speech_tpu_torch.ops.flash_decode import (
        flash_decode_attention_kv8, flash_decode_kv8_reference)
    from fish_speech_tpu_torch.ops.int4 import (_route, int4_dequant_bf16,
                                                 int4_matmul,
                                                 int4_matmul_bf16w_reference,
                                                 int4_matmul_reference)
    from fish_speech_tpu_torch.ops.quant import (_int4_effective_weight,
                                                 quantize_int4)

    cases = {"int4_mm": [], "int4_mm_wgmma": [], "flash_decode_kv8": []}
    slow = INT4_SHAPES[:4]
    shapes = ([(1, *s, 128) for s in INT4_SHAPES]
              + [(b, *s, 128) for b in (128, 1024) for s in slow]
              + [(1000, "ragged", 384, 200, 64)]
              + [(32, *s, 128) for s in slow])  # a 32-row pool's decode
    for b, name, i, o, g in shapes:
        qw = quantize_int4(randn(i, o).float() * 0.02, group_size=g)
        p, gs = qw["p"], qw["gs"]
        x = randn(b, i)
        route = _route(b, x.dtype)
        got = int4_matmul(x, p, gs).float()
        want = int4_matmul_reference(x, p, gs).float()
        scale = x.float().abs() @ _int4_effective_weight(qw, torch.float32).abs()
        # every route: one bf16 rounding of W and of y against the fp32 W
        ok = bool(((got - want).abs() <= 2.0 ** -8 * (scale + want.abs())).all())
        if route == "wgmma":
            # the Pallas kernel's bf16 W, summed in fp32: one rounding of y
            # plus the order of the sums
            plain = int4_matmul_bf16w_reference
            w_lib = int4_dequant_bf16(p, gs)
            exact = plain(x.float(), p, gs)
            err = (got - exact).abs()
            ok &= bool((err <= 2.0 ** -8 * exact.abs() + 1e-5 * scale).all())
            del exact
        else:
            plain = int4_matmul_reference
            w_lib = _int4_effective_weight(qw, torch.bfloat16)
            err = (got - want).abs()
        del got, want, scale
        iters = MATVEC_ITERS if b == 1 else 20
        ms, plain_ms = _in_turns(lambda k=0: plain(x, p, gs),
                                 lambda k=0: int4_matmul(x, p, gs), iters)
        lib = _time_ms(lambda k=0: x @ w_lib, iters)
        flops = 2 * b * i * o
        bound = _bound(flops, i // 2 * o + 4 * (i // g) * o + 2 * b * (i + o))
        tflops = flops / ms / 1e9
        device = {}
        if route == "gemv":
            # device time with the weights read cold, as the decode loop reads
            # each layer's own: the graph walks copies of (p, gs), and cuBLAS
            # copies of its bf16 W, over at least twice the 50 MB L2
            n_q = -(-L2_COLD_BYTES // (p.numel() + 4 * gs.numel()))
            n_w = -(-L2_COLD_BYTES // (2 * i * o))
            qs = [(p.clone(), gs.clone()) for _ in range(n_q)]
            ws = [w_lib.clone() for _ in range(n_w)]
            device = dict(
                device_ms=_device_ms(lambda k=0: int4_matmul(x, *qs[k % n_q]), iters),
                library_device_ms=_device_ms(lambda k=0: x @ ws[k % n_w], iters),
                weight_copies=[n_q, n_w])
            del qs, ws
        cases["int4_mm_wgmma" if route == "wgmma" else "int4_mm"].append(dict(
            shape=f"{name} B={b} I={i} O={o} g={g} ({tflops:.1f} TFLOP/s)",
            max_abs_err=err.max().item(), mean_abs_err=err.mean().item(), ms=ms,
            plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1],
            library_ms=lib, tflop_s=tflops, ok=ok, **device))
        del qw, p, gs, x, w_lib, err
    # the int4 matvec's fp32 route (`int4_gemv_kernel`) at the fast-stack
    # shapes of phase 3c's tiny model, JAX's widths (fast dim 32, 2 x 16 q,
    # 1 x 16 k and v, ffn 64; the group size `quantize_dual_ar_lowmem`
    # picks), held to 1e-5 of |x| @ |W| (the order of the fp32 sums)
    cases["int4_mm_fp32"] = []
    for name, i, o, g in [("tiny fast wqkv", 32, 64, 16), ("tiny fast wo", 32, 32, 16),
                          ("tiny fast w13", 32, 128, 16), ("tiny fast w2", 64, 32, 32)]:
        qw = quantize_int4(randn(i, o).float() * 0.02, group_size=g)
        p, gs = qw["p"], qw["gs"]
        x = randn(1, i).float()
        w_lib = _int4_effective_weight(qw, torch.float32)
        err = (int4_matmul(x, p, gs) - int4_matmul_reference(x, p, gs)).abs()
        scale = x.abs() @ w_lib.abs()
        ms, plain_ms = _in_turns(lambda k=0: int4_matmul_reference(x, p, gs),
                                 lambda k=0: int4_matmul(x, p, gs), 200)
        bound = _bound(2 * i * o, i // 2 * o + 4 * (i // g) * o + 4 * (i + o),
                       PEAK_FP32)
        cases["int4_mm_fp32"].append(dict(
            shape=f"{name} B=1 I={i} O={o} g={g} fp32", max_abs_err=err.max().item(),
            mean_abs_err=err.mean().item(), ms=ms, plain_ms=plain_ms,
            bound_ms=bound[0], bound_by=bound[1],
            library_ms=_time_ms(lambda k=0: x @ w_lib, 200),
            device_ms=_device_ms(lambda k=0: int4_matmul(x, p, gs), 200),
            library_device_ms=_device_ms(lambda k=0: x @ w_lib, 200),
            ok=bool((err <= 1e-5 * scale + 1e-6).all())))
    # the int8 cache of the serving session (36 layers, S = 2048 + 64) and
    # of the 4096-context one (S = 4096 + 64); each timed call reads the
    # next layer, `device_ms` / `library_device_ms` from a CUDA-graph replay
    # as for the decode rows. Then the fp32 route (CUDA cores) at phase 3c's
    # tiny cache (2 layers, S = 264) at JAX's widths (Hkv=1 G=2 D=32) and at
    # the earlier 64-wide heads (Hkv=2 G=2), to fp32's 1e-4.
    for n_layer, s, lengths, d, dtype, (h, gq) in [
            (36, 2112, (1, 257, 1100, 2048), 128, torch.bfloat16, (8, 4)),
            (36, 4160, (4000,), 128, torch.bfloat16, (8, 4)),
            (2, 264, (100,), 32, torch.float32, (1, 2)),
            (2, 264, (100,), 64, torch.float32, (2, 2))]:
        kq, ks = _kv_quant(randn(n_layer, 1, s, h, d))
        vq, vs = _kv_quant(randn(n_layer, 1, s, h, d))
        for length in lengths:
            q = randn(1, h, gq, d).to(dtype)
            lens = torch.tensor([length], dtype=torch.int32, device=dev)
            mx = mean = 0.0
            for layer in (0, n_layer - 1):
                e = _errors(flash_decode_attention_kv8(q, kq, ks, vq, vs, layer, lens),
                            flash_decode_kv8_reference(q, kq, ks, vq, vs, layer, lens))
                mx, mean = max(mx, e[0]), max(mean, e[1])

            def kernel(k=0):
                return flash_decode_attention_kv8(q, kq, ks, vq, vs, k % n_layer, lens)

            ms, plain_ms = _in_turns(
                lambda k=0: flash_decode_kv8_reference(q, kq, ks, vq, vs,
                                                       k % n_layer, lens),
                kernel, 100)
            # SDPA over the same cache dequantized to q's dtype beforehand
            kd = _kv_dequant(kq[:, :, :length], ks[:, :, :length], dtype)
            vd = _kv_dequant(vq[:, :, :length], vs[:, :, :length], dtype)
            qs = q.reshape(1, h * gq, 1, d)

            def sdpa(k=0):
                return F.scaled_dot_product_attention(
                    qs, kd[k % n_layer].transpose(1, 2),
                    vd[k % n_layer].transpose(1, 2), enable_gqa=True)

            lib = _time_ms(sdpa, 100)
            device = dict(device_ms=_device_ms(kernel, 100),
                          library_device_ms=_device_ms(sdpa, 100))
            del kd, vd
            bound = _bound(4 * h * gq * d * length,
                           2 * length * h * d + 2 * 2 * length * h
                           + 2 * q.element_size() * h * gq * d,
                           PEAK_BF16 if dtype == torch.bfloat16 else PEAK_FP32)
            fp32 = dtype == torch.float32
            cases["flash_decode_kv8"].append(dict(
                shape=f"L={n_layer} B=1 S={s} Hkv={h} G={gq} D={d} len={length} "
                      f"int8 K/V {str(dtype)[6:]}", max_abs_err=mx,
                mean_abs_err=mean, ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
                bound_by=bound[1], library_ms=lib,
                ok=mx <= 1e-4 if fp32 else mx <= 2e-2 and mean <= 2e-3, **device))
    del kq, ks, vq, vs
    cases["flash_decode_kv8"].append(pool_decode_kv8_case(dev, randn))
    torch.cuda.empty_cache()
    return cases


# the int4 matmul's fp32 route ("fp32_tc", `int4_tf32_kernel` and its wgmma
# tile shape `int4_tf32_wgmma_kernel`): s2-pro's
# slow wqkv, wo, w13, w2 and fast w13 at B = 9 (the fewest rows it takes),
# 128 and 1024 (the prompt buckets) with g = 128, then JAX's tiny widths at
# B = 64 (the group sizes the quantizer picks there), then the products
# phase 13(b') gives it: the in-context evaluation's 289 tokens through the
# slow stack and their 289 x 10 codebook rows through the fast one (w1 and
# w3 apart, as the checkpoint holds them)
FP32_TC_ROWS = (9, 128, 1024)
FP32_TC_SHAPES = [INT4_SHAPES[k] for k in (0, 1, 2, 3, 6)]
FP32_TC_TINY = [("tiny slow wqkv", 64, 128, 32), ("tiny slow w2", 128, 64, 64),
                ("tiny fast wqkv", 32, 64, 16), ("tiny fast w13", 32, 128, 16)]
IN_CONTEXT_TOKENS, IN_CONTEXT_CODEBOOKS = 289, 10
FP32_TC_EVAL = ([(IN_CONTEXT_TOKENS, "slow " + n, i, o) for n, i, o in
                 (("wqkv", 2560, 6144), ("wo", 4096, 2560), ("w1", 2560, 9728),
                  ("w2", 9728, 2560))]
                + [(IN_CONTEXT_TOKENS * IN_CONTEXT_CODEBOOKS, "fast " + n, i, o) for n, i, o in
                   (("wqkv", 1536, 2560), ("wo", 1536, 1536), ("w1", 1536, 6144),
                    ("w2", 6144, 1536))])


def int4_fp32_tc_cases(dev, randn32):
    """The int4 matmul's fp32 route on fp32 x against its plain version
    (`int4_matmul_reference`: x @ (q * s) in fp32), within 1e-5 of |x| @ |W|
    and in equal bits on two replays of a graph, timed in turns with it,
    with its device time beside cuBLAS fp32 (TF32 off) on the dequantized
    W: the weights are warm in L2 (one weight, as in a prefill). The bound
    is the TF32 products the kernel issues (two a product) at 495 TFLOP/s,
    or the bytes; `fp32_bound_ms` is fp32's on the CUDA cores, for
    comparison."""
    import torch

    from fish_speech_tpu_torch.ops._kernels import sm_count
    from fish_speech_tpu_torch.ops.int4 import (FP32_TC_TILES, _route, fp32_tc_plan,
                                                 fp32_tc_resident, int4_matmul,
                                                 int4_matmul_reference)
    from fish_speech_tpu_torch.ops.quant import _int4_effective_weight, quantize_int4

    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []
    try:
        shapes = ([(b, name, i, o, 128) for b in FP32_TC_ROWS for name, i, o in FP32_TC_SHAPES]
                  + [(64, *t) for t in FP32_TC_TINY] + [(*t, 128) for t in FP32_TC_EVAL])
        for b, name, i, o, g in shapes:
            qw = quantize_int4(randn32(i, o) * 0.02, group_size=g)
            p, gs = qw["p"], qw["gs"]
            x = randn32(b, i)
            assert _route(b, x.dtype) == "fp32_tc"
            w = _int4_effective_weight(qw, torch.float32)
            err = (int4_matmul(x, p, gs) - int4_matmul_reference(x, p, gs)).abs()
            scale = x.abs() @ w.abs()
            iters = 5 if b >= 1024 else 10
            ms, plain_ms = _in_turns(lambda k=0: int4_matmul_reference(x, p, gs),
                                     lambda k=0: int4_matmul(x, p, gs), iters)
            flops = 2 * b * i * o
            nbytes = i // 2 * o + 4 * (i // g) * o + 4 * b * (i + o)
            bound = _tf32_bound(flops, nbytes, 2)
            tile, n_split = fp32_tc_plan(b, i, o, g, sm_count(x.device),
                                         fp32_tc_resident(x.device))
            bm, bn = FP32_TC_TILES[tile]
            rows.append(dict(
                shape=f"{name} B={b} I={i} O={o} g={g} fp32 fp32_tc tile {bm}x{bn} runs "
                      f"{n_split} ({flops / ms / 1e9:.1f} TFLOP/s)",
                max_abs_err=err.max().item(), mean_abs_err=err.mean().item(), ms=ms,
                plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1],
                fp32_bound_ms=_bound(flops, nbytes, PEAK_FP32)[0],
                library_ms=_library_ms(lambda k=0: x @ w, iters),
                device_ms=_device_ms(lambda k=0: int4_matmul(x, p, gs), iters),
                library_device_ms=_device_ms(lambda k=0: x @ w, iters),
                replays_equal=_replays_equal(lambda: int4_matmul(x, p, gs)),
                ok=bool((err <= 1e-5 * scale + 1e-6).all())))
            rows[-1]["ok"] &= rows[-1]["replays_equal"]
            del qw, p, gs, x, w, err, scale
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    return rows


# s2-pro's int8 products at decode, I -> O: the slow and fast stacks (w13
# fused) and the three heads: the full LM head (the prefill's, one row per
# prompt), the semantic head (S + 1 columns, rows 16 bytes apart as
# `precompute_semantic_head` lays them out) and the fast head
INT8_SHAPES = INT4_SHAPES + [("LM head", 2560, 155136),
                             ("semantic head", 2560, 4097),
                             ("fast head", 1536, 4096)]
INT8_ROWS = (1, 4, 16, 32)  # the session, the group prefills' heads, the pool
# the fp32 int8 products of JAX's tiny model as `--tiny --int8` serves it
# (I -> O, w13 fused): the slow and fast stacks, the semantic head (4097
# columns, rows 16 bytes apart) and the fast head, at one row and at four;
# then s2-pro's slow w13 at one row, where the weight's bytes bound it
INT8_TINY_SHAPES = [("tiny slow wqkv", 64, 128), ("tiny slow wo", 64, 64),
                    ("tiny slow w13", 64, 256), ("tiny slow w2", 128, 64),
                    ("tiny fast wqkv", 32, 64), ("tiny fast wo", 32, 32),
                    ("tiny fast w13", 32, 128), ("tiny fast w2", 64, 32),
                    ("tiny semantic head", 64, 4097), ("tiny fast head", 32, 4096)]
INT8_FP32_ROWS = (1, 4)
INT8_FP32_WIDE = ("slow w13", 2560, 19456)


def int8_kernel_cases(dev, randn):
    """The int8 matmul against its plain version: `int8_gemv_mma_kernel` at
    every int8 shape of the serving paths and B in {1, 4, 16, 32}, held to
    2^-8 |y| (its one rounding) + 1e-5 (|x| @ |q|) * s (the order of the
    fp32 sums) of the plain version summed in fp32, two replays of a graph
    giving equal bits; `int8_gemv_fp32_kernel` (fp32 x) at JAX's tiny
    model's shapes (B = 1 and 4) and s2-pro's slow w13 (B = 1) to 1e-5
    (|x| @ |q|) * s, replays giving equal bits, timed beside cuBLAS on the
    dequantized fp32 W. Each bf16 case is timed
    against the plain version, cuBLAS on the dequantized bf16 W (the library
    call) and the cast route it replaces (`x @ q.to(bf16) * s.to(bf16)`),
    and from CUDA-graph replays that walk copies of the weights over twice
    the L2 (`device_ms`, `library_device_ms`, `cast_device_ms`)."""
    import torch

    from fish_speech_tpu_torch.models.dual_ar import _rows_16_bytes_apart
    from fish_speech_tpu_torch.ops.int8 import int8_matmul, int8_matmul_reference
    from fish_speech_tpu_torch.ops.quant import quantize_int8

    from fish_speech_tpu_torch.ops.int8 import _route

    cases = {"int8_mm": [], "int8_mm_cluster": [], "int8_mm_fp32": []}
    for name, i, o in INT8_SHAPES:
        qw = quantize_int8(randn(i, o).float() * 0.02)
        q, s = _rows_16_bytes_apart(qw["q"]), qw["s"]
        del qw
        qf = q.float()
        w_lib = (qf * s).to(torch.bfloat16)  # cuBLAS's operand: W dequantized
        n_q = -(-L2_COLD_BYTES // (i * q.stride(0) + 4 * o))
        n_w = -(-L2_COLD_BYTES // (2 * i * o))
        qs = [(q.clone() if o % 16 == 0 else _rows_16_bytes_apart(q), s.clone())
              for _ in range(n_q)]
        ws = [w_lib.clone() for _ in range(n_w)]
        for b in INT8_ROWS:
            x = randn(b, i)
            got = int8_matmul(x, q, s)
            exact = (x.float() @ qf) * s  # the plain version in fp32, not rounded
            scale = (x.float().abs() @ qf.abs()) * s
            same = _replays_equal(lambda: int8_matmul(x, q, s))
            ok = same and bool(((got.float() - exact).abs()
                                <= 2.0 ** -8 * exact.abs() + 1e-5 * scale).all())
            err = (got.float() - int8_matmul_reference(x, q, s).float()).abs()
            del exact, scale
            iters = 20 if o > 100_000 else MATVEC_ITERS
            ms, plain_ms = _in_turns(lambda k=0: int8_matmul_reference(x, q, s),
                                     lambda k=0: int8_matmul(x, q, s), iters)
            lib = _library_ms(lambda k=0: x @ w_lib, iters)
            bound = _bound(2 * b * i * o, i * o + 4 * o + 2 * b * (i + o))
            kernel = "int8_mm_cluster" if _route(b, x.dtype) == "gemv_cluster" else "int8_mm"
            cases[kernel].append(dict(
                shape=f"{name} B={b} I={i} O={o} bf16", max_abs_err=err.max().item(),
                mean_abs_err=err.mean().item(), ms=ms, plain_ms=plain_ms,
                bound_ms=bound[0], bound_by=bound[1], library_ms=lib, ok=ok,
                replays_equal=same,
                device_ms=_device_ms(lambda k=0: int8_matmul(x, *qs[k % n_q]), iters),
                library_device_ms=_device_ms(lambda k=0: x @ ws[k % n_w], iters),
                cast_device_ms=_device_ms(
                    lambda k=0: x @ qs[k % n_q][0].to(x.dtype)
                    * qs[k % n_q][1].to(x.dtype), iters),
                weight_copies=[n_q, n_w]))
            del got, err
        del q, s, qf, w_lib, qs, ws
        torch.cuda.empty_cache()
    # the fp32 route (`int8_gemv_fp32_kernel`): JAX's tiny shapes at B = 1
    # and 4 (its weights sit in L2, as the tiny model's all do), then
    # s2-pro's slow w13 at B = 1 over weight copies that walk twice the L2
    tiny = [(name, i, o, b) for name, i, o in INT8_TINY_SHAPES for b in INT8_FP32_ROWS]
    for name, i, o, b in tiny + [(*INT8_FP32_WIDE, 1)]:
        qw = quantize_int8(randn(i, o).float() * 0.02)
        q, s = _rows_16_bytes_apart(qw["q"]), qw["s"]
        del qw
        x = randn(b, i).float()
        w_lib = q.float() * s  # cuBLAS's operand: W dequantized, fp32
        wide = i * o > L2_COLD_BYTES // 4
        n_q = -(-L2_COLD_BYTES // (i * q.stride(0) + 4 * o)) if wide else 1
        n_w = -(-L2_COLD_BYTES // (4 * i * o)) if wide else 1
        qs = [(q, s)] + [(_rows_16_bytes_apart(q.contiguous()), s.clone())
                         for _ in range(n_q - 1)]
        ws = [w_lib] + [w_lib.clone() for _ in range(n_w - 1)]
        got = int8_matmul(x, q, s)
        err = (got - int8_matmul_reference(x, q, s)).abs()
        scale = x.abs() @ w_lib.abs()
        same = _replays_equal(lambda: int8_matmul(x, q, s))
        iters = 200
        ms, plain_ms = _in_turns(lambda k=0: int8_matmul_reference(x, q, s),
                                 lambda k=0: int8_matmul(x, q, s), iters)
        bound = _bound(2 * b * i * o, i * o + 4 * o + 4 * b * (i + o), PEAK_FP32)
        cases["int8_mm_fp32"].append(dict(
            shape=f"{name} B={b} I={i} O={o} fp32", max_abs_err=err.max().item(),
            mean_abs_err=err.mean().item(), ms=ms, plain_ms=plain_ms,
            bound_ms=bound[0], bound_by=bound[1],
            library_ms=_library_ms(lambda k=0: x @ w_lib, iters), replays_equal=same,
            device_ms=_device_ms(lambda k=0: int8_matmul(x, *qs[k % n_q]), iters),
            library_device_ms=_device_ms(lambda k=0: x @ ws[k % n_w], iters),
            weight_copies=[n_q, n_w],
            ok=same and bool((err <= 1e-5 * scale + 1e-6).all())))
        del q, s, x, w_lib, qs, ws, got, err, scale
    torch.cuda.empty_cache()
    return cases


# s2-pro's int8 FFNs at decode (D, I), w13 fused: the slow and the fast
# stack (the `mixed` session's slow stack at B=1, both stacks of the int8
# pool at B=32)
INT8_FFN_SHAPES = [("slow FFN", 2560, 9728), ("fast FFN", 1536, 6144)]
# the fp32 FFNs of JAX's tiny model (the slow and the fast stack) at one
# row and at four, then s2-pro's slow FFN at one row
INT8_FFN_TINY = [("tiny slow FFN", 64, 128), ("tiny fast FFN", 32, 64)]
INT8_FFN_WIDE = ("slow FFN", 2560, 9728)


def _replays_equal(fn):
    """Two replays of one CUDA graph of `fn` give the same bits."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    first = out.clone()
    graph.replay()
    torch.cuda.synchronize()
    same = torch.equal(first, out)
    del graph
    return same


def int8_ffn_kernel_cases(dev, randn):
    """The fused int8 FFN against its plain version: `int8_ffn_mma_kernel`
    (bf16 x) at s2-pro's slow and fast FFNs and B in {1, 4, 16, 32}, held to
    2 bf16 ulps of max |y| (the two sum u1 and u3 in another order, so g's
    rounding can land one step apart), two replays of a graph giving equal
    bits; `int8_ffn_fp32_kernel` (fp32 x) at JAX's tiny model's slow and
    fast FFNs (B = 1 and 4) and s2-pro's slow FFN (B = 1) to 1e-5 of max
    |y|, replays giving equal bits, beside cuBLAS on the dequantized fp32
    weights with torch's gate. Each bf16 case is timed against the plain
    version and, from
    CUDA-graph replays that walk copies of the weights over twice the L2,
    beside the route it replaces (`replaced_device_ms`: two `int8_matmul`
    launches with torch's silu * mul between) and the library call
    (`library_device_ms`: cuBLAS on the dequantized bf16 w13 and w2 with
    torch's silu * mul)."""
    import torch
    import torch.nn.functional as F

    from fish_speech_tpu_torch.ops.int8 import int8_matmul
    from fish_speech_tpu_torch.ops.int8_ffn import int8_ffn, int8_ffn_reference
    from fish_speech_tpu_torch.ops.quant import quantize_int8

    def weights(d, i):
        w1, w3, w2 = (quantize_int8(randn(*shape).float() * 0.02)
                      for shape in ((d, i), (d, i), (i, d)))
        return {k: torch.cat([w1[k], w3[k]], dim=-1) for k in ("q", "s")}, w2

    def ulps(got, want):
        top = want.float().abs().max().item()
        return (got.float() - want.float()).abs().max().item() / 2.0 ** (
            np.floor(np.log2(top)) - 7)

    cases = {"int8_ffn": [], "int8_ffn_fp32": []}
    for name, d, i in INT8_FFN_SHAPES:
        w13, w2 = weights(d, i)
        lib13 = (w13["q"].float() * w13["s"]).to(torch.bfloat16)
        lib2 = (w2["q"].float() * w2["s"]).to(torch.bfloat16)
        nbytes = 3 * d * i + 4 * (2 * i + d)  # int8 weights and fp32 scales
        n_w = -(-L2_COLD_BYTES // nbytes)
        n_lib = -(-L2_COLD_BYTES // (6 * d * i))
        ws = [({k: v.clone() for k, v in w13.items()}, {k: v.clone() for k, v in w2.items()})
              for _ in range(n_w)]
        libs = [(lib13.clone(), lib2.clone()) for _ in range(n_lib)]
        del lib13, lib2
        for b in INT8_ROWS:
            x = randn(b, d)
            got = int8_ffn(x, w13, w2)
            plain = int8_ffn_reference(x, w13, w2)
            err = (got.float() - plain.float()).abs()
            same = _replays_equal(lambda: int8_ffn(x, w13, w2))

            def replaced(k=0):
                a, c = ws[k % n_w]
                u = int8_matmul(x, a["q"], a["s"])
                return int8_matmul(F.silu(u[:, :i]) * u[:, i:], c["q"], c["s"])

            def library(k=0):
                a, c = libs[k % n_lib]
                u = x @ a
                return (F.silu(u[:, :i]) * u[:, i:]) @ c

            ms, plain_ms = _in_turns(lambda k=0: int8_ffn_reference(x, w13, w2),
                                     lambda k=0: int8_ffn(x, w13, w2), FFN_ITERS)
            bound = _bound(6 * b * d * i, nbytes + 4 * b * d)  # x in, y out, bf16
            cases["int8_ffn"].append(dict(
                shape=f"{name} B={b} D={d} I={i} bf16", max_abs_err=err.max().item(),
                mean_abs_err=err.mean().item(), max_ulps=ulps(got, plain),
                replays_equal=same, ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
                bound_by=bound[1], library_ms=_library_ms(library, FFN_ITERS),
                ok=bool(torch.isfinite(got).all()) and ulps(got, plain) <= 2 and same,
                device_ms=_device_ms(lambda k=0: int8_ffn(x, *ws[k % n_w]), 2 * FFN_ITERS),
                replaced_device_ms=_device_ms(replaced, 2 * FFN_ITERS),
                library_device_ms=_device_ms(library, 2 * FFN_ITERS),
                weight_copies=[n_w, n_lib]))
            del got, plain, err
        del w13, w2, ws, libs
        torch.cuda.empty_cache()
    # the fp32 route (`int8_ffn_fp32_kernel`): JAX's tiny FFNs (their
    # weights in L2, as the tiny model's all are), then s2-pro's slow FFN
    # over weight copies that walk twice the L2
    tiny = [(name, d, i, b) for name, d, i in INT8_FFN_TINY for b in INT8_FP32_ROWS]
    for name, d, i, b in tiny + [(*INT8_FFN_WIDE, 1)]:
        w13, w2 = weights(d, i)
        x = randn(b, d).float()
        got, plain = int8_ffn(x, w13, w2), int8_ffn_reference(x, w13, w2)
        err = (got - plain).abs()
        same = _replays_equal(lambda: int8_ffn(x, w13, w2))
        nbytes = 3 * d * i + 4 * (2 * i + d)
        wide = nbytes > L2_COLD_BYTES // 4
        n_w = -(-L2_COLD_BYTES // nbytes) if wide else 1
        n_lib = -(-L2_COLD_BYTES // (12 * d * i)) if wide else 1
        ws = [(w13, w2)] + [({k: v.clone() for k, v in w13.items()},
                             {k: v.clone() for k, v in w2.items()})
                            for _ in range(n_w - 1)]
        libs = [(w13["q"].float() * w13["s"], w2["q"].float() * w2["s"])]
        libs += [(a.clone(), c.clone()) for a, c in libs * (n_lib - 1)]

        def library_fp32(k=0):
            a, c = libs[k % n_lib]
            u = x @ a
            return (F.silu(u[:, :i]) * u[:, i:]) @ c

        ms, plain_ms = _in_turns(lambda k=0: int8_ffn_reference(x, w13, w2),
                                 lambda k=0: int8_ffn(x, w13, w2), 200)
        bound = _bound(6 * b * d * i, nbytes + 8 * b * d, PEAK_FP32)
        cases["int8_ffn_fp32"].append(dict(
            shape=f"{name} B={b} D={d} I={i} fp32", max_abs_err=err.max().item(),
            mean_abs_err=err.mean().item(), ms=ms, plain_ms=plain_ms,
            bound_ms=bound[0], bound_by=bound[1], replays_equal=same,
            library_ms=_library_ms(library_fp32, 200),
            device_ms=_device_ms(lambda k=0: int8_ffn(x, *ws[k % n_w]), 200),
            library_device_ms=_device_ms(library_fp32, 200), weight_copies=[n_w, n_lib],
            ok=same and bool((err <= 1e-5 * plain.abs().max()).all())))
        del w13, w2, ws, libs, x, got, plain, err
    torch.cuda.empty_cache()
    return cases


def _tiny_cfg(tokenizer):
    """JAX's tiny model at its own widths (slow heads D=32, 2 over 1 KV
    head; fast heads D=16, G=2), with QK norm, untied embeddings and ten
    codebooks."""
    from fish_speech_tpu_torch.config import dual_ar_tiny

    return dual_ar_tiny(vocab_size=tokenizer.vocab_size, num_codebooks=10,
                        attention_qk_norm=True, tie_word_embeddings=False,
                        semantic_begin_id=tokenizer.semantic_begin_id,
                        semantic_end_id=tokenizer.semantic_end_id,
                        im_end_id=tokenizer.im_end_id)


def _prefix_hit_codes(params, cfg, kv_quant, label):
    """A tiny fp32 session with the prefix cache serves two greedy prompts
    that share 140 columns: the second is a hit (its suffix through the
    suffix attention, on the card its graph `suffix_64`). Returns the two
    requests' columns."""
    import torch

    from fish_speech_tpu_torch.config import SamplingConfig
    from fish_speech_tpu_torch.generate import GenerationSession

    session = GenerationSession(params, cfg, SamplingConfig(), dtype=torch.float32,
                                decode_chunk_size=8, first_chunk_size=4,
                                kv_quant=kv_quant, prefix_cache_size=2)
    rng = np.random.default_rng(17)
    head = rng.integers(0, cfg.codebook_size, (cfg.num_codebooks + 1, 140))
    head[0, 20:60] += cfg.semantic_begin_id
    out = []
    for n in (12, 20):
        tail = rng.integers(0, cfg.codebook_size, (cfg.num_codebooks + 1, n))
        prompt = np.concatenate([head, tail], axis=1).astype(np.int32)
        out.append(session.generate(prompt, 5, max_new_tokens=12, top_k=1))
    if session.prefix_hits != 1:
        raise SystemExit(f"{label}: the shared prefix was not a hit "
                         f"({session.prefix_hits} hits)")
    return out


def small_reference(dev, tokenizer):
    """Phase 3: a tiny fp32 model through the kernels (card) and the plain
    versions (CPU) on the same weights and request."""
    import torch

    from fish_speech_tpu_torch.config import SamplingConfig
    from fish_speech_tpu_torch.generate import GenerationSession, generate_long
    from fish_speech_tpu_torch.models import dual_ar

    cfg = _tiny_cfg(tokenizer)
    cpu_params = dual_ar.init_dual_ar(3, cfg, torch.float32, "cpu")
    gpu_params = _to(cpu_params, dev)
    inp = torch.randint(0, cfg.codebook_size, (1, cfg.num_codebooks + 1, 64),
                        generator=torch.Generator().manual_seed(0),
                        dtype=torch.int32)
    inp[0, 0, 10:30] += cfg.semantic_begin_id  # a stretch of semantic tokens
    logits = []
    for params, d in ((cpu_params, "cpu"), (gpu_params, dev)):
        cache = dual_ar.init_kv_cache(cfg, 1, 96, torch.float32, d)
        lg, _, _ = dual_ar.prefill(params, cfg, inp.to(d), cache,
                                   torch.zeros(1, dtype=torch.int32, device=d), 60)
        logits.append(lg.cpu())
    err = (logits[0] - logits[1]).abs().max().item()
    codes = []
    for params in (cpu_params, gpu_params):
        session = GenerationSession(params, cfg, SamplingConfig(),
                                    dtype=torch.float32, decode_chunk_size=8,
                                    first_chunk_size=4)
        out = [r.codes for r in generate_long(
            session=session, tokenizer=tokenizer, text="A small check.",
            max_new_tokens=20, top_k=1, seed=5) if r.action == "sample"]
        codes.append(np.concatenate(out, axis=1))
    same = codes[0].shape == codes[1].shape and np.array_equal(*codes)
    hits = [_prefix_hit_codes(p, cfg, False, "small reference")
            for p in (cpu_params, gpu_params)]
    hit_same = all(np.array_equal(a, b) for a, b in zip(*hits))
    print(f"small reference (tiny fp32, card kernels vs CPU plain): "
          f"prefill max_abs_err={err:.3e}, greedy codes {codes[0].shape} "
          f"identical={same}; a prefix miss and hit (suffix over the fp32 "
          f"cache), columns identical={hit_same}")
    if err > 1e-4 or not same or not hit_same:
        raise SystemExit("the kernel path disagrees with the plain path on "
                         "the small reference")


def small_quant_reference(dev, tokenizer):
    """Phase 3c: phase 3's tiny fp32 model quantized `mixed` (slow int8,
    fast int4, heads int8), with the int8 KV cache, through the kernels
    (card) and the plain versions (CPU) on the same weights and request."""
    import torch

    from fish_speech_tpu_torch.config import SamplingConfig
    from fish_speech_tpu_torch.generate import GenerationSession, generate_long
    from fish_speech_tpu_torch.models import dual_ar
    from fish_speech_tpu_torch.ops.flash_decode import flash_decode_attention_kv8
    from fish_speech_tpu_torch.ops.int4 import int4_matmul
    from fish_speech_tpu_torch.ops.int8 import int8_matmul
    from fish_speech_tpu_torch.ops.int8_ffn import int8_ffn
    from fish_speech_tpu_torch.ops.quant import quantize_dual_ar_lowmem

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _tiny_cfg(tokenizer)
    cpu_params = quantize_dual_ar_lowmem(
        dual_ar.init_dual_ar(3, cfg, torch.float32, "cpu"), mode="int8",
        fast_mode="int4")
    gpu_params = _to(cpu_params, dev)
    inp = torch.randint(0, cfg.codebook_size, (1, cfg.num_codebooks + 1, 64),
                        generator=torch.Generator().manual_seed(0),
                        dtype=torch.int32)
    inp[0, 0, 10:30] += cfg.semantic_begin_id
    launches = (int4_matmul.launches, flash_decode_attention_kv8.launches,
                int8_matmul.launches, int8_ffn.launches)
    logits = []
    for params, d in ((cpu_params, "cpu"), (gpu_params, dev)):
        cache = dual_ar.init_kv_cache(cfg, 1, 96, torch.float32, d, quant=True)
        lg, _, _ = dual_ar.prefill(params, cfg, inp.to(d), cache,
                                   torch.zeros(1, dtype=torch.int32, device=d), 60)
        logits.append(lg.cpu())
    err = (logits[0] - logits[1]).abs().max().item()
    codes = []
    for params in (cpu_params, gpu_params):
        session = GenerationSession(params, cfg, SamplingConfig(),
                                    dtype=torch.float32, decode_chunk_size=8,
                                    first_chunk_size=4, kv_quant=True)
        out = [r.codes for r in generate_long(
            session=session, tokenizer=tokenizer, text="A small check.",
            max_new_tokens=20, top_k=1, seed=5) if r.action == "sample"]
        codes.append(np.concatenate(out, axis=1))
    same = codes[0].shape == codes[1].shape and np.array_equal(*codes)
    hits = [_prefix_hit_codes(p, cfg, True, "small quantized reference")
            for p in (cpu_params, gpu_params)]
    same = same and all(np.array_equal(a, b) for a, b in zip(*hits))
    ran = (int4_matmul.launches > launches[0]
           and flash_decode_attention_kv8.launches > launches[1]
           and int8_matmul.launches > launches[2]
           and int8_ffn.launches > launches[3])
    print(f"small quantized reference (tiny fp32 mixed int8/int4 + int8 KV, card "
          f"kernels vs CPU plain): prefill max_abs_err={err:.3e}, greedy codes "
          f"{codes[0].shape} and a prefix miss and hit (suffix over the int8 "
          f"cache) identical={same}, int4/kv8/int8/int8 FFN kernels ran={ran}")
    if err > 1e-4 or not same or not ran:
        raise SystemExit("the quantized kernel path disagrees with the plain "
                         "path on the small reference")


def _to(tree, dev):
    """A copy of a tensor tree on `dev` (new leaf tensors, never shared)."""
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.detach().to(dev, copy=True)


def _flat(tree, prefix=""):
    """{"/"-joined path: tensor} of a tree of dicts and lists."""
    out = {}
    items = enumerate(tree) if isinstance(tree, (list, tuple)) else tree.items()
    for k, v in items:
        if isinstance(v, (dict, list, tuple)):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _numpy_batch(cfg, rng, b, t, pads):
    """A training batch in `TextDataCollator`'s layout: text ids with
    stretches of semantic tokens carrying codebook values, rows right-padded
    by `pads` (padding is IGNORE_INDEX in the labels)."""
    inputs = np.zeros((b, cfg.num_codebooks + 1, t), dtype=np.int32)
    inputs[:, 0] = rng.integers(4, 200, size=(b, t))
    sem = rng.random((b, t)) < 0.6
    for i in range(b):
        codes = rng.integers(0, cfg.codebook_size, size=(cfg.num_codebooks, t))
        inputs[i, 0, sem[i]] = cfg.semantic_begin_id + codes[0, sem[i]]
        inputs[i, 1:, sem[i]] = codes[:, sem[i]].T
    labels = inputs.copy()
    pad = np.zeros((b, t), bool)
    for i, n in enumerate(pads):
        if n:
            pad[i, -n:] = True
            labels[i, :, -n:] = -100
    return {"inputs": inputs, "labels": labels, "pad_mask": pad}


def small_train_reference(dev, tokenizer):
    """Phase 3b: a tiny fp32 LoRA model takes two optimizer steps through the
    training attention kernels (card) and the plain versions (CPU), from the
    same weights on the same batch (T=200: a ragged tile, one row padded).
    Pass: both steps' losses within 1e-5 and every LoRA leaf within 1e-5
    after the steps (fp32 on both sides, TF32 off; only the summation order
    differs)."""
    import torch

    from fish_speech_tpu_torch.models import dual_ar
    from fish_speech_tpu_torch.models.lora import (LoraConfig, add_lora,
                                                   apply_lora_config,
                                                   lora_filter)
    from fish_speech_tpu_torch.ops.flash_train import (flash_train_backward,
                                                       flash_train_forward)
    from fish_speech_tpu_torch.train.step import make_optimizer, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _tiny_cfg(tokenizer)
    lcfg = LoraConfig(r=4, lora_alpha=8.0)
    base = add_lora(dual_ar.init_dual_ar(4, cfg, torch.float32, "cpu"), cfg,
                    lcfg, seed=5, dtype=torch.float32)
    cfg = apply_lora_config(cfg, lcfg)
    batch = _numpy_batch(cfg, np.random.default_rng(0), 2, 200, [0, 37])
    launches = (flash_train_forward.launches, flash_train_backward.launches)
    losses, trees = [], []
    for d in ("cpu", dev):
        params = _to(base, d)
        opt = make_optimizer(params, lr=1e-3, trainable_mask=lora_filter(params))
        step = make_train_step(cfg, opt)
        placed = {k: torch.from_numpy(v).to(d) for k, v in batch.items()}
        losses.append([float(step(params, placed)["loss"]) for _ in range(2)])
        trees.append({k: v.detach().cpu() for k, v in _flat(params).items()
                      if "lora" in k})
    if (flash_train_forward.launches == launches[0]
            or flash_train_backward.launches == launches[1]):
        raise SystemExit("the card's training steps did not run the kernels")
    if (flash_train_forward.launches != flash_train_forward.launches_fp32_tc
            or flash_train_backward.launches != flash_train_backward.launches_fp32_tc):
        raise SystemExit("the card's fp32 training steps launched off the fp32_tc route")
    loss_err = max(abs(a - b) for a, b in zip(*losses))
    leaf_err = max((trees[0][k] - trees[1][k]).abs().max().item()
                   for k in trees[0])
    moved = all(not torch.equal(trees[0][k], _flat(base)[k]) for k in trees[0])
    print(f"small training reference (tiny fp32 LoRA, 2 steps, card kernels vs "
          f"CPU plain): losses {losses[0]} vs {losses[1]}, max loss err "
          f"{loss_err:.3e}, max LoRA leaf err {leaf_err:.3e} over "
          f"{len(trees[0])} leaves, all moved={moved}")
    if loss_err > 1e-5 or leaf_err > 1e-5 or not moved:
        raise SystemExit("the training kernels disagree with the plain path on "
                         "the small reference")


def _recording_engine(session, tokenizer, codec, dac_cfg, references_dir="references"):
    """A `TTSInferenceEngine` that keeps the codes of the last decoded
    segment, for the repeat check, and the host seconds of each codec
    decode (of a host or a device partial) and reference encode
    (`load_audio` and the codec's encode); each ends in a host copy, so
    each is the call's whole time."""
    from fish_speech_tpu_torch.engine.tts import TTSInferenceEngine

    class RecordingEngine(TTSInferenceEngine):
        def __init__(self, *args):
            super().__init__(*args)
            self.encode_seconds = []
            self.decode_seconds = []
            self.codes_by_request = {}

        def decode_vq_tokens(self, codes):
            self.last_codes = np.array(codes)
            t0 = time.perf_counter()
            out = super().decode_vq_tokens(codes)
            self.decode_seconds.append(time.perf_counter() - t0)
            return out

        def _decode_vq_device(self, codes_dev, valid_frames):
            t0 = time.perf_counter()
            out = super()._decode_vq_device(codes_dev, valid_frames)
            self.decode_seconds.append(time.perf_counter() - t0)
            return out

        def encode_references_batch(self, audios):
            t0 = time.perf_counter()
            out = super().encode_references_batch(audios)
            self.encode_seconds.append(time.perf_counter() - t0)
            return out

    return RecordingEngine(session, tokenizer, codec, dac_cfg, references_dir)


def _s2_pro_cfg(tokenizer, max_seq_len):
    from fish_speech_tpu_torch.config import dual_ar_s2_pro

    cfg = dual_ar_s2_pro(semantic_begin_id=tokenizer.semantic_begin_id,
                         semantic_end_id=tokenizer.semantic_end_id,
                         im_end_id=tokenizer.im_end_id)
    return dataclasses.replace(cfg, max_seq_len=max_seq_len).resolve()


def _requests():
    """Phase 4's streamed requests (one client, in this order). 72 new
    tokens each: the first chunk of 8 and one of 64, so no step is cut."""
    from fish_speech_tpu_torch.engine.tts import TTSRequest

    short = "Hello from the port. This is a short streamed request."
    long_text = ("The quick brown fox jumps over the lazy dog, and then it runs "
                 "back home before the rain. ") * 8
    long_text = long_text[:700]
    medium = ("Streaming speech synthesis sends the first audio while the "
              "rest is still being generated. ") * 3
    return [
        ("short", TTSRequest(text=short, streaming=True, max_new_tokens=72, seed=11)),
        ("long", TTSRequest(text=long_text, streaming=True, max_new_tokens=72,
                            seed=12, chunk_length=1000)),
        ("medium", TTSRequest(text=medium, streaming=True, max_new_tokens=72,
                              seed=13)),
        ("short-repeat", TTSRequest(text=short, streaming=True,
                                    max_new_tokens=72, seed=11)),
    ]


def serve(dev, tokenizer, engine, requests, frame, label):
    """Stream `requests` through `engine`, checking every segment; returns
    the per-request rows and codes."""
    import torch

    results, codes = [], {}
    for name, req in requests:
        torch.cuda.synchronize()
        engine.decode_seconds.clear()
        t_start = time.perf_counter()
        t_first = t_last = None
        samples, n_seg = 0, 0
        for res in engine.inference(req):
            now = time.perf_counter()
            if res.code == "error":
                raise SystemExit(f"{label} request {name} failed: {res.error!r}")
            if res.code == "segment":
                audio = res.audio[1]
                if len(audio) % frame or not np.isfinite(audio).all():
                    raise SystemExit(f"{label} request {name}: a segment of "
                                     f"{len(audio)} samples is not whole finite "
                                     f"frames")
                samples += len(audio)
                n_seg += 1
                t_first = t_first or now
                t_last = now
            if res.code == "final":
                if not np.isfinite(res.audio[1]).all() or len(res.audio[1]) != samples:
                    raise SystemExit(f"{label} request {name}: bad final audio")
        frames = samples // frame
        if frames < 2 or t_first is None:
            raise SystemExit(f"{label} request {name}: only {frames} frames")
        codes[name] = engine.last_codes
        engine.codes_by_request[name] = engine.last_codes
        prompt_len = len(tokenizer.encode(req.text))
        row = dict(request=name, text_bytes=len(req.text.encode()),
                   ttfa_s=t_first - t_start, frames=frames, segments=n_seg,
                   samples=samples,
                   decode_frames_per_s=(frames - 1) / (t_last - t_first),
                   wall_s=t_last - t_start,
                   codec_s=[round(x, 4) for x in engine.decode_seconds])
        results.append(row)
        print(f"{label} request {name}: text {row['text_bytes']} bytes "
              f"(~{prompt_len} text tokens), TTFA {row['ttfa_s'] * 1e3:.1f} ms, "
              f"{frames} frames in {n_seg} segments, decode "
              f"{row['decode_frames_per_s']:.2f} frames/s, {samples} samples, "
              f"wall {row['wall_s']:.2f}s; codec decodes (host s each, "
              f"replay + copy) {row['codec_s']}")
    torch.cuda.synchronize()
    if "short-repeat" in codes:
        same = np.array_equal(codes["short"], codes["short-repeat"])
        print(f"{label} repeat with the same seed: codes {codes['short'].shape} "
              f"identical={same}")
        if not same:
            raise SystemExit(f"{label}: the repeated request gave different codes")
    return results


def _counted(wrappers):
    """Launch counts of `wrappers` (name -> function), read after a path."""
    return {name: f.launches for name, f in wrappers.items()}


def _prompt_len(tokenizer, cfg, text, prompt_text=None, prompt_tokens=None):
    """The prompt length of a request's (only) text batch, built as
    `generate_long` builds it (with a voice-clone prompt of reference
    texts and codes, if given)."""
    from fish_speech_tpu_torch.generate import build_base_conversation, encode_turn

    return encode_turn(build_base_conversation(prompt_text, prompt_tokens), text,
                       tokenizer, cfg.num_codebooks).shape[1]


def precompile_for(session, tokenizer, requests, label, suffix_buckets=()):
    """Capture the graphs of `requests` (and the suffix prefills of
    `suffix_buckets`, a prefix hit's) before they are measured, as the JAX
    server's `warm_up` compiles; prints the capture seconds and pool."""
    times = {}
    for t in sorted({_prompt_len(tokenizer, session.cfg, req.text)
                     for _, req in requests}):
        times.update(session.precompile(t, requests[0][1].max_new_tokens,
                                        session.first_chunk_size, suffix_buckets))
    print(f"{label} graphs captured (s, each with its eager run): "
          + ", ".join(f"{k} {v:.3f}" for k, v in times.items())
          + f"; graph pool {session.pool_bytes / 2**20:.1f} MiB")
    session.replays.clear()
    session.eager_runs.clear()
    return times


def precompile_codec(engine, code_buckets, reference_buckets, label):
    """Capture the codec graphs the timed requests reach, before them (the
    engine's `precompile`); prints the capture seconds and the codec pool,
    then clears the codec's replay and eager-run counts."""
    times, grown = {}, {}
    for kind, buckets in (("code", code_buckets), ("reference", reference_buckets)):
        for b in buckets:  # one graph a call, to read each one's pool growth
            before = engine.codec_pool_bytes
            new = engine.precompile(**{f"{kind}_buckets": (b,)})
            times.update(new)
            grown.update({k: (engine.codec_pool_bytes - before) / 2**20 for k in new})
    print(f"{label} codec graphs captured by engine.precompile (s, each with its "
          f"eager run; the pool's growth in MiB): "
          + ", ".join(f"{k} {v:.3f} s +{grown[k]:.1f}" for k, v in times.items())
          + f"; codec graph pool {engine.codec_pool_bytes / 2**20:.1f} MiB")
    engine.codec_replays.clear()
    engine.codec_eager_runs.clear()
    return times


def check_codec_replayed(engine, kinds, label):
    """Every codec call of the measured requests was a graph replay (no
    codec body ran eagerly on the card), and each kind in `kinds` replayed."""
    print(f"{label}: codec graph replays {dict(engine.codec_replays)}; codec "
          f"eager body runs {dict(engine.codec_eager_runs)}")
    replayed = {k[0] for k, n in engine.codec_replays.items() if n > 0}
    if engine.codec_eager_runs or not set(kinds) <= replayed:
        raise SystemExit(f"{label}: a codec body ran eagerly on the card, or "
                         f"the codec's {kinds} graphs never replayed")


def codec_device_ms(engine, key, n):
    """Device ms of one replay of codec graph `key`: n replays between CUDA
    events, after one untimed (not counted as the engine's replays)."""
    import torch

    graph = engine.codec_graphs[key].graph
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def eager_peak_mib(engine, key):
    """MiB above the allocation before it that an eager run of codec graph
    `key`'s body peaks at (its live temporaries), to set beside the pool
    its capture grew."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with torch.no_grad():
        engine._codec_body(key)()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2**20


def print_codec_ms(engine, label, reps=10):
    """The codec's device ms per replay for each (rows, bucket) a timed
    request reached, and each body's eager peak of live temporaries."""
    out = {}
    for key in sorted(engine.codec_replays):
        out[key] = codec_device_ms(engine, key, reps)
    peaks = {key: eager_peak_mib(engine, key) for key in out}
    print(f"{label} codec device ms per replay (CUDA events, {reps} replays): "
          + ", ".join(f"{k} {v:.3f}" for k, v in out.items())
          + "; eager peak of each body's temporaries (MiB): "
          + ", ".join(f"{k} {v:.1f}" for k, v in peaks.items()))
    return out


def replayed_step_ms(session, n=64, rows=1):
    """Device ms of one decode step of the `rows`-row buffers (a lockstep
    batch's for rows > 1): n replays of the step graph (one chunk: its
    uniforms, the replays, the copy of its columns) between CUDA events,
    after one such chunk untimed."""
    import torch

    session.decode_chunk(n, rows=rows)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    session.decode_chunk(n, rows=rows)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def check_replayed(session, label):
    """Every decode step of the measured requests was a graph replay: no
    eager body ran on the card, and the step graph replayed. Prints the
    replays and the launches one replayed step makes."""
    per_step = session.launches_per_replay("decode")
    print(f"{label}: graph replays {dict(session.replays)}; eager body runs "
          f"{dict(session.eager_runs)}; launches per replayed decode step "
          f"{per_step}")
    if session.eager_runs or session.replays["decode"] <= 0:
        raise SystemExit(f"{label}: a step ran eagerly on the card, or the "
                         f"decode graph never replayed")
    return per_step


# the eager session's figures that the replayed runs replace (earlier runs
# of this script, before the decode ran as CUDA graphs; NVIDIA H100 80GB
# HBM3, 700.00 W): decode frames/s and TTFA of the streamed requests
EAGER_FIGURES = {"bf16": "decode 4.31-6.38 frames/s, TTFA 173-253 ms",
                 "mixed": "decode 4.31-6.38 frames/s",
                 "int4": "TTFA 248.2-306.7 ms"}


# phase 4's requests decode at these code buckets: the first partial (the
# prefill's frame, then 9 frames after the first chunk of 8) and 72 frames
PHASE4_CODE_BUCKETS = (32, 128)


def partials_in_turns(dev, tokenizer, engine, frame):
    """Phase 4's short request served from device partials (the engine's
    default, JAX's) and from host partials, in turns (device, host, host,
    device) with one seed: the codes must be equal; prints each one's TTFA
    and decode frames/s."""
    from fish_speech_tpu_torch.engine.tts import TTSRequest

    text = _requests()[0][1].text
    rows, codes = {"device": [], "host": []}, []
    for mode in ("device", "host", "host", "device"):
        engine.device_partials = mode == "device"
        req = TTSRequest(text=text, streaming=True, max_new_tokens=72, seed=11)
        rows[mode].append(serve(dev, tokenizer, engine, [(f"short {mode} partials",
                                                         req)], frame, "bf16")[0])
        codes.append(engine.last_codes)
    engine.device_partials = True
    same = all(np.array_equal(codes[0], c) for c in codes[1:])
    print("bf16 device vs host partials, in turns (device, host, host, device; "
          f"{_nvidia_smi()}): TTFA device "
          + " / ".join(f"{r['ttfa_s'] * 1e3:.2f}" for r in rows["device"])
          + " ms, host " + " / ".join(f"{r['ttfa_s'] * 1e3:.2f}" for r in rows["host"])
          + " ms; decode frames/s device "
          + " / ".join(f"{r['decode_frames_per_s']:.2f}" for r in rows["device"])
          + ", host " + " / ".join(f"{r['decode_frames_per_s']:.2f}" for r in rows["host"])
          + f"; codes identical={same}")
    if not same:
        raise SystemExit("device and host partials gave different codes")
    return rows


def run_slice(dev, tokenizer):
    """Phase 4: the full-width LM and codec answer streamed requests; then
    phase 4b, voice cloning, on the same model, session and engine."""
    import torch

    from fish_speech_tpu_torch.config import SamplingConfig, dac_s2_pro
    from fish_speech_tpu_torch.generate import GenerationSession
    from fish_speech_tpu_torch.models import dual_ar
    from fish_speech_tpu_torch.models.dac.model import init_dac
    from fish_speech_tpu_torch.ops.flash_decode import flash_decode_attention
    from fish_speech_tpu_torch.ops.flash_prefill import flash_prefill_attention

    t0 = time.perf_counter()
    cfg = _s2_pro_cfg(tokenizer, 2048)
    dac_cfg = dac_s2_pro()
    if cfg.num_codebooks != dac_cfg.rvq.total_codebooks:
        raise SystemExit("LM and codec codebook counts differ")
    params = dual_ar.init_dual_ar(0, cfg, torch.bfloat16, dev)
    n_params = dual_ar.param_count(params)
    codec = init_dac(1, dac_cfg, torch.float32, dev)
    session = GenerationSession(params, cfg, SamplingConfig(),
                                dtype=torch.bfloat16, decode_chunk_size=64,
                                first_chunk_size=8, prefix_cache_size=4)
    del params  # the session holds the fused-FFN copy it decodes with
    refs_dir = Path(__file__).resolve().parent / "build" / "chip_smoke_refs"
    engine = _recording_engine(session, tokenizer, codec, dac_cfg, str(refs_dir))
    torch.cuda.synchronize()
    print(f"slice: dual_ar_s2_pro {n_params / 1e9:.3f}B params bf16 "
          f"(max_seq_len 2048) + dac_s2_pro with its encoder "
          f"({_tree_bytes(codec) / 2**30:.2f} GiB fp32), built in "
          f"{time.perf_counter() - t0:.1f}s; device memory allocated "
          f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB")
    precompile_for(session, tokenizer, _requests(), "bf16")
    precompile_codec(engine, PHASE4_CODE_BUCKETS, (), "bf16")
    _zero_counts()
    results = serve(dev, tokenizer, engine, _requests(), dac_cfg.frame_length,
                    "bf16")
    print("bf16 TTFA after precompile: first request "
          f"{results[0]['ttfa_s'] * 1e3:.1f} ms, the others "
          + " / ".join(f"{r['ttfa_s'] * 1e3:.1f}" for r in results[1:])
          + " ms (earlier runs of this script with the codec eager, NVIDIA "
          "H100 80GB HBM3, 700.00 W: first 424.1-573.3, warm 43.5-65.9)")
    launches = {"flash_prefill": flash_prefill_attention.launches_wgmma,
                "flash_decode": flash_decode_attention.launches}
    print(f"kernel launches on the engine path: {launches} (prefill on the "
          f"tensor-core route; all routes {flash_prefill_attention.launches})")
    if min(launches.values()) <= 0:
        raise SystemExit("a kernel of the path was never launched")
    check_replayed(session, "bf16")
    check_codec_replayed(engine, ("decode",), "bf16")
    partials_in_turns(dev, tokenizer, engine, dac_cfg.frame_length)
    check_codec_replayed(engine, ("decode",), "bf16 partials")
    print(f"peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB "
          f"(allocated; the graph pools' reserved memory aside)")
    print_codec_ms(engine, "bf16")
    step_ms = replayed_step_ms(session)
    print(f"bf16 replayed decode step: {step_ms:.3f} ms of device time "
          f"({1e3 / step_ms:.2f} steps/s; the eager session: "
          f"{EAGER_FIGURES['bf16']})")
    clone = run_clone(dev, tokenizer, session, engine, refs_dir)
    return results, launches, clone, step_ms


# phase 4c: phase 4's three texts and one more, as one lockstep batch
BATCH_EXTRA = "A fourth voice joins the batch, with a prompt of its own length."
BATCH_SEED = 17


def _batch_prompts(tokenizer, cfg):
    """The (C+1, T) prompts of phase 4's three texts and BATCH_EXTRA, built
    as `generate_long` builds a request's only text batch."""
    from fish_speech_tpu_torch.generate import build_base_conversation, encode_turn

    texts = [req.text for name, req in _requests() if name != "short-repeat"]
    return [encode_turn(build_base_conversation(None, None), text, tokenizer,
                        cfg.num_codebooks) for text in texts + [BATCH_EXTRA]]


def check_batch_logits(session, prompts, label):
    """Each row's first logits of the batch's prefill (the prompts
    left-padded to a common end, per-row offsets; the body the
    `prefill_4_{bucket}` graph runs, eager on the card) against a
    single-stream prefill of the same prompt: within 0.05 x max |logit|
    and with the same argmax against the one-row prefill of the row's own
    padded columns (the same positions: the row's own arithmetic at one
    row); within 0.05 x max |logit| of the prompt prefilled alone from
    position 0, whose argmax is printed with its top-two margin (its RoPE
    angles sit at other positions, so near ties may move)."""
    import torch

    from fish_speech_tpu_torch.models import dual_ar

    cfg, dev = session.cfg, session.device
    t_max = max(p.shape[1] for p in prompts)
    bucket = session._bucket(t_max)
    inp = np.zeros((len(prompts), cfg.num_codebooks + 1, bucket), np.int32)
    offsets = np.asarray([t_max - p.shape[1] for p in prompts], np.int32)
    for i, p in enumerate(prompts):
        inp[i, :, offsets[i]:t_max] = p

    def prefill(cols, offs, t_end):
        cache = dual_ar.init_kv_cache(cfg, cols.shape[0], cols.shape[2],
                                      torch.bfloat16, dev, quant=session.kv_quant)
        logits, _, _ = dual_ar.prefill(
            session.params, cfg, torch.from_numpy(cols).to(dev), cache,
            torch.as_tensor(offs, dtype=torch.int32, device=dev), t_end)
        return logits

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    worst_own, worst_alone, argmax_own, notes = 0.0, 0.0, True, []
    with torch.no_grad():
        batch = prefill(inp, offsets, t_max)
        for i, p in enumerate(prompts):
            own = prefill(inp[i : i + 1], offsets[i : i + 1], t_max)[0]
            t = p.shape[1]
            one = np.zeros((1, cfg.num_codebooks + 1, session._bucket(t)), np.int32)
            one[0, :, :t] = p
            alone = prefill(one, [0], t)[0]
            worst_own = max(worst_own, rel(batch[i], own))
            worst_alone = max(worst_alone, rel(batch[i], alone))
            argmax_own &= int(batch[i].argmax()) == int(own.argmax())
            top2 = alone.topk(2).values
            notes.append(f"row {i}: argmax {'equal' if int(batch[i].argmax()) == int(alone.argmax()) else 'moved'}"
                         f" (margin {(top2[0] - top2[1]).item():.4f}, max |diff| "
                         f"{(batch[i] - alone).abs().max().item():.4f})")
    print(f"{label} batch prefill (offsets {offsets.tolist()}, bucket {bucket}): "
          f"first logits, worst max |diff| / max |logit|: {worst_own:.4f} against "
          f"each row's padded columns prefilled alone (argmax equal={argmax_own}), "
          f"{worst_alone:.4f} against each prompt prefilled alone from 0 (bound "
          f"0.05; {'; '.join(notes)})")
    if max(worst_own, worst_alone) > 0.05 or not argmax_own:
        raise SystemExit(f"{label}: a batch row's first logits left its "
                         f"single-stream prefill's")


def run_batch(dev, tokenizer):
    """Phase 4c: full-width s2-pro (seed 0, max_seq_len 2048) serves
    `generate_batch` at B=4 (phase 4's three prompts and one more,
    left-padded to a common end at bucket 1024), bf16, then quantized
    `mixed` with the int8 KV cache: every step a replay of the graphs
    `precompile` captured, the decode kernels launched with starts,
    aggregate frames/s, the replayed lockstep step's device ms and
    launches, a repeat of the seed giving the same codes, and each row's
    first logits held to its prompt's single-stream prefill."""
    import torch

    from fish_speech_tpu_torch.config import SamplingConfig
    from fish_speech_tpu_torch.generate import GenerationSession
    from fish_speech_tpu_torch.models import dual_ar
    from fish_speech_tpu_torch.ops.flash_decode import (
        flash_decode_attention, flash_decode_attention_kv8)
    from fish_speech_tpu_torch.ops.flash_prefill import flash_prefill_attention
    from fish_speech_tpu_torch.ops.int8 import int8_matmul
    from fish_speech_tpu_torch.ops.int8_ffn import int8_ffn
    from fish_speech_tpu_torch.ops.quant import quantize_dual_ar_lowmem

    t_phase = time.perf_counter()
    cfg = _s2_pro_cfg(tokenizer, 2048)
    prompts = _batch_prompts(tokenizer, cfg)
    lens = [p.shape[1] for p in prompts]
    params = dual_ar.init_dual_ar(0, cfg, torch.bfloat16, dev)
    out = {}
    for label in ("bf16", "mixed"):
        if label == "mixed":
            params = quantize_dual_ar_lowmem(params, mode="int8", fast_mode="int4")
        session = GenerationSession(params, cfg, SamplingConfig(), max_batch=4,
                                    dtype=torch.bfloat16, decode_chunk_size=64,
                                    first_chunk_size=8, kv_quant=label == "mixed")
        label = f"batch {label}" + (" + int8 KV" if label == "mixed" else "")
        times = session.precompile(max(lens), 72, first_chunk=8, batch=4)
        captured = dict(session.eager_runs)
        print(f"{label}: prompts of {lens} tokens, graphs captured (s, each with "
              f"its eager run) " + ", ".join(f"{k} {v:.3f}" for k, v in times.items())
              + f"; graph pool {session.pool_bytes / 2**20:.1f} MiB")
        kw = dict(max_new_tokens=72, temperature=0.8, top_p=0.8, top_k=30,
                  first_chunk_size=8)
        _zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = session.generate_batch(prompts, BATCH_SEED, **kw)
        wall = time.perf_counter() - t0
        counts = {"flash_prefill": flash_prefill_attention.launches_wgmma,
                  "flash_decode": flash_decode_attention.launches,
                  "flash_decode_kv8": flash_decode_attention_kv8.launches,
                  "int8_mm": int8_matmul.launches_gemv_mma,
                  "int8_ffn": int8_ffn.launches_mma}
        again = session.generate_batch(prompts, BATCH_SEED, **kw)
        same = all(np.array_equal(a, b) for a, b in zip(outs, again))
        frames = sum(o.shape[1] for o in outs)
        if dict(session.eager_runs) != captured:
            raise SystemExit(f"{label}: a body ran eagerly after precompile: "
                             f"{dict(session.eager_runs)}")
        if not same:
            raise SystemExit(f"{label}: the repeated seed gave other codes")
        sb, se = cfg.semantic_begin_id, cfg.semantic_end_id
        for o in outs:
            ok = ((o[0] >= sb) & (o[0] <= se)) | (o[0] == cfg.im_end_id)
            if o.shape[0] != cfg.num_codebooks + 1 or not ok.all() or (
                    o[1:] < 0).any() or (o[1:] >= cfg.codebook_size).any():
                raise SystemExit(f"{label}: a row's columns are out of range")
        decode = counts["flash_decode_kv8" if "int8" in label else "flash_decode"]
        need = [decode, counts["flash_prefill"]] + (
            [counts["int8_mm"], counts["int8_ffn"]] if "int8" in label else [])
        if min(need) <= 0:
            raise SystemExit(f"{label}: a kernel of the path never launched: {counts}")
        per_step = session.launches_per_replay("decode_4")
        step_ms = replayed_step_ms(session, rows=4)
        print(f"{label}: {frames} frames in rows of {[o.shape[1] for o in outs]} "
              f"in {wall:.2f}s: aggregate {frames / wall:.1f} frames/s "
              f"(prefill + {session.replays['decode_4']} replayed steps in both "
              f"runs); replayed lockstep step {step_ms:.3f} ms of device time "
              f"({4e3 / step_ms:.1f} frames/s of steps; {_nvidia_smi()}); "
              f"launches per replayed step {per_step}; launches in the timed run "
              f"{counts}; repeat identical={same}; graph replays "
              f"{dict(session.replays)}")
        check_batch_logits(session, prompts, label)
        out[label] = dict(launches=counts, step_ms=step_ms,
                          frames_per_s=frames / wall, per_step=per_step)
        del session
        gc.collect()
        torch.cuda.empty_cache()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 4c (the lockstep batch) took {time.perf_counter() - t_phase:.1f}s")
    return out


def run_tools(tokenizer):
    """Phase 10: the generation tools as a user runs them, each in a process
    of its own on the card: `tools.tts --tiny` (codes and a WAV) and the
    codec CLI's round trip with `--tiny` (a WAV to codes and back)."""
    import os

    from fish_speech_tpu_torch.audio.io import read_wav, write_wav
    from fish_speech_tpu_torch.config import dac_tiny

    root = Path(__file__).resolve().parent
    out = root / "build" / "chip_smoke_tools"
    out.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(root))
    cfg = dac_tiny()

    def tool(name, *args):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", f"fish_speech_tpu_torch.tools.{name}",
                               *map(str, args)], cwd=str(root), env=env,
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise SystemExit(f"tools.{name} {args} failed: {proc.stderr[-3000:]}")
        return time.perf_counter() - t0

    wav = out / "tts.wav"
    t_tts = tool("tts", "--tiny", "--text", "<|speaker:0|>The tools on the card.",
                 "--max-new-tokens", 24, "--output", wav, "--output-dir", out)
    codes = np.load(out / "codes_0.npy")
    audio, sr = read_wav(wav)
    if (codes.shape[0] != cfg.rvq.total_codebooks or sr != cfg.sample_rate
            or audio.shape[1] != codes.shape[1] * cfg.frame_length):
        raise SystemExit(f"tools.tts: codes {codes.shape}, audio {audio.shape} at {sr}")
    rng = np.random.default_rng(31)
    write_wav(out / "in.wav", 0.1 * rng.standard_normal(7 * cfg.frame_length),
              cfg.sample_rate)
    t_enc = tool("codec", "-i", out / "in.wav", "-o", out / "codes.npy", "--tiny")
    t_dec = tool("codec", "-i", out / "codes.npy", "-o", out / "recon.wav", "--tiny")
    enc = np.load(out / "codes.npy")
    recon, _ = read_wav(out / "recon.wav")
    if enc.shape != (cfg.rvq.total_codebooks, 7) or recon.shape != (1, 7 * cfg.frame_length):
        raise SystemExit(f"tools.codec round trip: codes {enc.shape}, audio {recon.shape}")
    print(f"tools on the card: tools.tts --tiny wrote codes {codes.shape} and "
          f"{audio.shape[1]} samples in {t_tts:.1f}s; tools.codec --tiny encoded 7 "
          f"frames to {enc.shape} in {t_enc:.1f}s and decoded them to "
          f"{recon.shape[1]} samples in {t_dec:.1f}s (each a process of its own)")


# phase 11: the checkpoint tools on s2-pro's widths at 2 slow and 2 fast
# layers (the parity tool's text and budget are its defaults)
PARITY_TEXT = "Hello world."
PARITY_NEW_TOKENS = 64
CKPT_MAX_SEQ_LEN = 1024


def _ckpt_cfg(tokenizer):
    """Phase 11's model: s2-pro's widths (vocab 155136, dim 2560, 32/8 heads
    of 128, inter 9728; fast dim 1536, 12/4 heads, inter 6144; 10 codebooks
    of 4096) at 2 slow and 2 fast layers."""
    return dataclasses.replace(_s2_pro_cfg(tokenizer, CKPT_MAX_SEQ_LEN),
                               n_layer=2, n_fast_layer=2).resolve()


def parity_shapes(tokenizer):
    """The attention shapes the parity tool reaches on phase 11's model: the
    prompt's prefill bucket, the session's slow cache (max_seq_len plus the
    default decode chunk of 32) and the teacher-forced prompt's length."""
    from fish_speech_tpu_torch.generate import pick_bucket

    cfg = _ckpt_cfg(tokenizer)
    cache_len = cfg.max_seq_len + 32
    prompt = _prompt_len(tokenizer, cfg, PARITY_TEXT)
    return dict(prompt=prompt, bucket=min(pick_bucket(prompt, cache_len),
                                          cfg.max_seq_len),
                cache_len=cache_len, train_t=len(tokenizer.encode(PARITY_TEXT)))


def _bitwise(got, want, label):
    """Raise unless the two trees have the same paths and every leaf the
    same dtype, shape and bits; returns the count of leaves."""
    import torch

    got, want = _flat(got), _flat(want)
    if sorted(got) != sorted(want):
        raise SystemExit(f"{label}: paths differ: {sorted(set(got) ^ set(want))[:8]}")
    bad = [k for k, w in want.items()
           if got[k].dtype != w.dtype or got[k].shape != w.shape
           or not torch.equal(got[k].to(w.device), w)]
    if bad:
        raise SystemExit(f"{label}: {len(bad)} leaves differ, e.g. {bad[:4]}")
    return len(want)


def _dir_bytes(path):
    return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())


def run_checkpoint_tools(dev, tokenizer):
    """Phase 11: the checkpoint lifecycle on the card, each CLI a process of
    its own: random s2-pro weights (2 + 2 layers) saved, exported to the
    upstream layout and converted back (bitwise), the full codec saved with
    `save_codec` (bitwise), the parity tool's golden saved and checked
    (`PARITY OK`) and one run in this process through the fp32 kernels,
    `tools.quantize` int8 (a greedy request's codes equal a session over the
    in-memory quantization) and int4 (bitwise), two LoRA steps then
    `tools.merge_lora` (bitwise against the in-memory merge, logits near the
    LoRA model's), and the naive model's forward at T=1024."""
    import os
    import shutil
    import tempfile

    import torch

    from fish_speech_tpu_torch.config import SamplingConfig, dac_s2_pro
    from fish_speech_tpu_torch.data.dataset import (SemanticIterableDataset,
                                                    TextDataCollator)
    from fish_speech_tpu_torch.generate import GenerationSession
    from fish_speech_tpu_torch.models import dual_ar
    from fish_speech_tpu_torch.models.dac.model import init_dac
    from fish_speech_tpu_torch.models.lora import LoraConfig, merge_lora
    from fish_speech_tpu_torch.models.naive import (forward_train_naive,
                                                    init_naive)
    from fish_speech_tpu_torch.ops.flash_decode import flash_decode_attention
    from fish_speech_tpu_torch.ops.flash_prefill import flash_prefill_attention
    from fish_speech_tpu_torch.ops.flash_train import flash_train_forward
    from fish_speech_tpu_torch.ops.int8 import int8_matmul
    from fish_speech_tpu_torch.ops.int8_ffn import int8_ffn
    from fish_speech_tpu_torch.ops.quant import quantize_dual_ar_lowmem
    from fish_speech_tpu_torch.tools.parity_check import parity_report
    from fish_speech_tpu_torch.train.trainer import TrainConfig, Trainer
    from fish_speech_tpu_torch.utils.checkpoint import (load_codec, load_dual_ar,
                                                        save_codec, save_dual_ar)

    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent
    (root / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir=root / "build"))
    env = dict(os.environ, PYTHONPATH=str(root))
    written = 0
    launches = {}

    def tool(module, *args):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", f"fish_speech_tpu_torch.{module}",
                               *map(str, args)], cwd=str(root), env=env,
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise SystemExit(f"{module} {args} failed ({proc.returncode}): "
                             f"{proc.stdout[-2000:]} {proc.stderr[-3000:]}")
        return proc.stdout, time.perf_counter() - t0

    try:
        cfg = _ckpt_cfg(tokenizer)
        # 1. save, export to the upstream layout, convert back: bitwise
        params = dual_ar.init_dual_ar(0, cfg, torch.bfloat16, dev)
        n_params = dual_ar.param_count(params)
        base = tmp / "base"
        t0 = time.perf_counter()
        save_dual_ar(base, params, cfg, tokenizer)
        t_save = time.perf_counter() - t0
        _, t_export = tool("convert.cli", "export-dual-ar", "--input", base,
                           "--output", tmp / "upstream")
        shutil.copy(base / "tokenizer.json", tmp / "upstream" / "tokenizer.json")
        _, t_convert = tool("convert.cli", "dual-ar", "--input", tmp / "upstream",
                            "--output", tmp / "native")
        written += _dir_bytes(base) + _dir_bytes(tmp / "upstream")
        shutil.rmtree(tmp / "upstream")
        native = tmp / "native"
        back, back_cfg = load_dual_ar(native, dtype=torch.bfloat16, device=dev)
        n = _bitwise(back, params, "converter round trip")
        if back_cfg != cfg:
            raise SystemExit("converter round trip: the config changed")
        del back
        print(f"checkpoint tools: {n_params / 1e9:.3f}B params (s2-pro widths, "
              f"2 + 2 layers) saved bf16 in {t_save:.1f}s ({_dir_bytes(base) / 1e9:.2f}"
              f" GB); convert.cli export-dual-ar {t_export:.1f}s, dual-ar "
              f"{t_convert:.1f}s ({_dir_bytes(native) / 1e9:.2f} GB fp32); "
              f"load_dual_ar(bf16) gives back all {n} leaves bitwise")

        # 2. the full codec through save_codec / load_codec: bitwise
        dac_cfg = dac_s2_pro()
        codec = init_dac(1, dac_cfg, torch.float32, dev)
        t0 = time.perf_counter()
        save_codec(native, codec, dac_cfg)
        codec_back, codec_cfg = load_codec(native, device=dev)
        n = _bitwise(codec_back, codec, "save_codec / load_codec")
        if codec_cfg != dac_cfg:
            raise SystemExit("save_codec / load_codec: the config changed")
        print(f"checkpoint tools: dac_s2_pro ({sum(v.numel() for v in _flat(codec).values()) / 1e6:.1f}M"
              f" params) save_codec + load_codec {time.perf_counter() - t0:.1f}s, "
              f"all {n} leaves bitwise")
        del codec, codec_back

        # 3. the parity tool: a golden saved, then checked, as processes
        golden = tmp / "golden.json"
        _, t_save_golden = tool("tools.parity_check", "--checkpoint-path", native,
                                "--save-golden", golden)
        out, t_check = tool("tools.parity_check", "--checkpoint-path", native,
                            "--golden", golden)
        if "PARITY OK" not in out:
            raise SystemExit(f"tools.parity_check --golden: {out[-2000:]}")
        gc.collect()
        torch.cuda.empty_cache()
        _zero_counts()
        t0 = time.perf_counter()
        report = parity_report(native, device=dev)
        t_report = time.perf_counter() - t0
        fp32 = {"flash_prefill_fp32": flash_prefill_attention.launches_fp32_tc,
                "flash_decode_fp32": flash_decode_attention.launches,
                "flash_train_fwd_fp32": flash_train_forward.launches_fp32_tc}
        launches.update(fp32)
        print(f"checkpoint tools: tools.parity_check --save-golden {t_save_golden:.1f}s,"
              f" --golden {t_check:.1f}s: PARITY OK; in this process "
              f"{t_report:.1f}s, fp32 kernel launches {fp32}; report "
              f"{json.dumps(report)}")
        if min(fp32.values()) <= 0:
            raise SystemExit(f"parity_check: an fp32 kernel was never launched: {fp32}")
        want = json.loads(golden.read_text())
        from fish_speech_tpu_torch.tools.parity_check import _diff

        if _diff(want, report):
            raise SystemExit(f"parity_check in process: {_diff(want, report)}")
        written += _dir_bytes(native)
        shutil.rmtree(native)

        # 4. tools.quantize: int8 serves the in-memory tree's codes; int4
        # writes the in-memory tree
        _, t_int8 = tool("tools.quantize", "--checkpoint-path", base, "--mode", "int8",
                         "--output", tmp / "int8")
        q8, _ = load_dual_ar(tmp / "int8", dtype=None, device=dev)
        rng = np.random.default_rng(23)
        prompt = rng.integers(0, cfg.codebook_size, (cfg.num_codebooks + 1, 16))
        prompt[0, :6] = rng.integers(0, 200, 6)
        prompt[0, 6:] += cfg.semantic_begin_id
        prompt = prompt.astype(np.int32)
        codes = {}
        for name, tree in (("in_memory", quantize_dual_ar_lowmem(params, "int8")),
                           ("checkpoint", q8)):
            session = GenerationSession(tree, cfg, SamplingConfig(),
                                        decode_chunk_size=16, first_chunk_size=4)
            _zero_counts()
            codes[name] = session.generate(prompt, 7, max_new_tokens=16, top_k=1)
            counts = {"int8_mm": int8_matmul.launches_gemv_mma,
                      "int8_ffn": int8_ffn.launches_mma}
            del session, tree
        launches.update(counts)
        same = np.array_equal(codes["in_memory"], codes["checkpoint"])
        print(f"checkpoint tools: tools.quantize --mode int8 {t_int8:.1f}s "
              f"({_dir_bytes(tmp / 'int8') / 1e9:.2f} GB); greedy codes "
              f"{codes['checkpoint'].shape} from the checkpoint identical to the "
              f"in-memory quantization={same}; launches {counts}")
        if not same or min(counts.values()) <= 0:
            raise SystemExit("quantize int8: codes differ or an int8 kernel was "
                             "never launched")
        del q8
        written += _dir_bytes(tmp / "int8")
        shutil.rmtree(tmp / "int8")
        _, t_int4 = tool("tools.quantize", "--checkpoint-path", base, "--mode", "int4",
                         "--group-size", 128, "--output", tmp / "int4")
        q4, _ = load_dual_ar(tmp / "int4", dtype=None, device=dev)
        n = _bitwise(q4, quantize_dual_ar_lowmem(params, "int4", group_size=128),
                     "quantize int4")
        print(f"checkpoint tools: tools.quantize --mode int4 --group-size 128 "
              f"{t_int4:.1f}s ({_dir_bytes(tmp / 'int4') / 1e9:.2f} GB), all {n} "
              f"leaves bitwise the in-memory quantization")
        del q4
        written += _dir_bytes(tmp / "int4")
        shutil.rmtree(tmp / "int4")

        # 5. two LoRA steps, then tools.merge_lora on their checkpoint
        steps, max_length = 2, 512
        proto = _write_protos(tmp / "data.protos", cfg.num_codebooks,
                              cfg.codebook_size, np.random.default_rng(5))
        stream = iter(SemanticIterableDataset([str(proto)], tokenizer, seed=0,
                                              max_length=max_length,
                                              num_codebooks=cfg.num_codebooks))
        batch = TextDataCollator(tokenizer, max_length)([next(stream)])
        lora = LoraConfig(r=8, lora_alpha=16.0)
        tcfg = TrainConfig(output_dir=str(tmp / "train"), project="lora",
                           max_steps=steps, batch_size=1, max_length=max_length,
                           lr=1e-2, warmup_steps=0, schedule="constant",
                           log_every_steps=1, val_every_steps=10 ** 9,
                           ckpt_every_steps=steps, seed=0, precision="bfloat16",
                           lora=lora)
        trainer = Trainer(cfg, tcfg, params=params, device=dev)
        t0 = time.perf_counter()
        trainer.fit([batch] * steps, resume=False)
        torch.cuda.synchronize()
        t_fit = time.perf_counter() - t0
        step_dir = trainer.latest_checkpoint()
        out, t_merge = tool("tools.merge_lora", "--base", base, "--lora", step_dir,
                            "--lora-r", 8, "--lora-alpha", 16,
                            "--output", tmp / "merged")
        l1 = float(re.search(r"L1 delta on layers\.0\.wqkv after merge: ([0-9.]+)",
                             out).group(1))
        merged, _ = load_dual_ar(tmp / "merged", dtype=None, device=dev)
        lora_fp32 = _leafmap(trainer.params, lambda t: t.detach().float())
        n = _bitwise(merged, merge_lora(lora_fp32, trainer.cfg), "merge_lora")
        # teacher-forced logits in fp32: the merged model against the LoRA
        # model (base and LoRA leaves widened exactly), and the base alone
        # for the LoRA's own effect
        inp = torch.from_numpy(np.asarray(batch["inputs"])).to(dev)
        with torch.no_grad():
            want = dual_ar.forward_train(lora_fp32, trainer.cfg, inp, remat=False)
            got = dual_ar.forward_train(merged, cfg, inp, remat=False)
            del merged
            base_fp32 = _leafmap(params, lambda t: t.detach().float())
            plain = dual_ar.forward_train(base_fp32, cfg, inp, remat=False)
        rel = [((g - w).abs().max() / w.abs().max()).item() for g, w in zip(got, want)]
        effect = [((p - w).abs().max() / w.abs().max()).item()
                  for p, w in zip(plain, want)]
        print(f"checkpoint tools: 2 LoRA steps (r 8, alpha 16, B=1 x T={max_length}) "
              f"{t_fit:.1f}s; tools.merge_lora {t_merge:.1f}s, L1 {l1:.6f}; the merged "
              f"tree equals the in-memory merge on the card in all {n} leaves; "
              f"teacher-forced fp32 logits, max |diff| / max |logit|: merged vs "
              f"LoRA model {rel[0]:.3e} (token) {rel[1]:.3e} (codebook); base vs "
              f"LoRA model {effect[0]:.3e} / {effect[1]:.3e}")
        if not l1 > 0 or max(rel) > 2e-2:
            raise SystemExit(f"merge_lora: L1 {l1}, logits off by {rel}")
        written += _dir_bytes(tmp / "merged") + _dir_bytes(tmp / "train")
        del trainer, got, want, plain, lora_fp32, base_fp32
        gc.collect()
        torch.cuda.empty_cache()

        # 6. the naive model at the same widths and depth, T=1024, bf16
        naive = init_naive(0, cfg, torch.bfloat16, dev)
        gen = torch.Generator().manual_seed(9)
        inp = torch.randint(0, cfg.codebook_size, (1, cfg.num_codebooks + 1, 1024),
                            generator=gen, dtype=torch.int32)
        inp[0, 0, :200] = torch.randint(0, 200, (200,), generator=gen)
        inp[0, 0, 200:] += cfg.semantic_begin_id
        _zero_counts()
        t0 = time.perf_counter()
        with torch.no_grad():
            tok_logits, cb_logits = forward_train_naive(naive, cfg, inp.to(dev))
        torch.cuda.synchronize()
        t_naive = time.perf_counter() - t0
        finite = bool(torch.isfinite(tok_logits).all() and torch.isfinite(cb_logits).all())
        launches["flash_train_fwd"] = flash_train_forward.launches_wgmma
        print(f"checkpoint tools: forward_train_naive B=1 x T=1024 bf16 {t_naive:.2f}s, "
              f"logits {tuple(tok_logits.shape)} / {tuple(cb_logits.shape)} "
              f"finite={finite}; training-forward launches on the tensor-core "
              f"route {flash_train_forward.launches_wgmma}")
        if not finite or flash_train_forward.launches_wgmma <= 0:
            raise SystemExit("naive: logits not finite or the training forward's "
                             "tensor-core route never launched")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 11 (the checkpoint tools) took {time.perf_counter() - t_phase:.1f}s "
          f"and wrote {written / 1e9:.2f} GB; {_nvidia_smi()}")
    return launches


def _leafmap(tree, fn):
    if isinstance(tree, dict):
        return {k: _leafmap(v, fn) for k, v in tree.items()}
    return fn(tree)


CLONE_TEXT = ("A reference speaker reads a few calm sentences, so that the model "
              "can follow the voice, the pace and the tone of the recording.")


def _reference_clip(path, seconds=30.0, sr=24000, seed=21):
    """A ~30 s reference clip from a seed, written as 16-bit mono PCM at
    24 kHz (so `load_audio` resamples it to 44.1 kHz): a tone gliding
    around 140 Hz with its harmonics, in syllable-like bursts, and noise."""
    from fish_speech_tpu_torch.audio.io import write_wav

    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    f0 = 140 + 30 * np.sin(2 * np.pi * 0.3 * t)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    voice = sum(np.sin(k * phase) / k for k in range(1, 6))
    bursts = 0.5 + 0.5 * np.sin(2 * np.pi * 3.7 * t + rng.uniform(0, 2 * np.pi))
    x = 0.25 * voice * bursts + 0.02 * rng.standard_normal(len(t))
    path.parent.mkdir(parents=True, exist_ok=True)
    write_wav(path, x, sr)
    return path.read_bytes()


def run_clone(dev, tokenizer, session, engine, refs_dir):
    """Phase 4b: voice cloning on phase 4's model, session and engine: a
    ~30 s reference by id, by bytes, and by id again (the same seed)."""
    import shutil
    from types import SimpleNamespace

    import torch

    from fish_speech_tpu_torch.audio.io import load_audio
    from fish_speech_tpu_torch.engine.tts import TTSRequest
    from fish_speech_tpu_torch.models.dac.model import dac_encode
    from fish_speech_tpu_torch.ops.flash_decode import (flash_decode_attention,
                                                        flash_decode_attention_kv8)
    from fish_speech_tpu_torch.ops.flash_prefill import (flash_prefill_attention,
                                                         flash_suffix_attention)

    cfg, dac_cfg = session.cfg, engine.codec_cfg
    frame = dac_cfg.frame_length
    shutil.rmtree(refs_dir, ignore_errors=True)
    clip = _reference_clip(refs_dir / "speaker" / "sample.wav")
    (refs_dir / "speaker" / "sample.lab").write_text(CLONE_TEXT)
    n_frames = -(-len(load_audio(clip, dac_cfg.sample_rate)) // frame)
    text = _requests()[0][1].text
    prompt_len = _prompt_len(tokenizer, cfg, text, [CLONE_TEXT],
                             [np.zeros((dac_cfg.rvq.total_codebooks, n_frames),
                                       np.int32)])
    bucket = session._bucket(prompt_len)
    print(f"clone reference: {len(clip)} bytes of 16-bit mono PCM at 24 kHz "
          f"(~30 s), {n_frames} frames at 44.1 kHz; transcript "
          f"{len(CLONE_TEXT)} bytes; prompt {prompt_len} tokens (prefill "
          f"bucket {bucket}) with phase 4's {len(text)}-byte short text")
    torch.cuda.reset_peak_memory_stats(dev)
    times = session.precompile(prompt_len, 72, session.first_chunk_size,
                               suffix_buckets=(1,))
    print(f"clone session graphs captured (s): {times or 'none new'}")
    precompile_codec(engine, (), (n_frames,), "clone")
    session.replays.clear()
    session.eager_runs.clear()
    engine.encode_seconds.clear()
    _zero_counts()
    hits0, misses0 = session.prefix_hits, session.prefix_misses
    common = dict(text=text, streaming=True, max_new_tokens=72, seed=31)
    # the first stores the prompt's rows (the prefix cache); the bytes and
    # the repeat are hits; the cold one runs with the cache off, to set the
    # full prefill's TTFA and codes beside the hits'
    requests = [
        ("clone-id", TTSRequest(**common, reference_id="speaker",
                                use_memory_cache="on")),
        ("clone-bytes", TTSRequest(**common, references=[
            SimpleNamespace(audio=clip, text=CLONE_TEXT)])),
        ("clone-id-cold", TTSRequest(**common, reference_id="speaker",
                                     use_memory_cache="on")),
        ("clone-id-repeat", TTSRequest(**common, reference_id="speaker",
                                       use_memory_cache="on")),
    ]
    codes = {}
    rows = []
    for name, req in requests:
        session.prefix.size = 0 if name.endswith("cold") else 4
        rows += serve(dev, tokenizer, engine, [(name, req)], frame, "clone")
        codes[name] = engine.last_codes
    session.prefix.size = 4
    launches = {"flash_prefill": flash_prefill_attention.launches_wgmma,
                "flash_decode": flash_decode_attention.launches,
                "flash_suffix": flash_suffix_attention.launches_suffix_wgmma}
    hits, misses = session.prefix_hits - hits0, session.prefix_misses - misses0
    encode_key = ("encode", 1, engine._code_bucket(n_frames))
    print(f"clone: reference load_audio + encode {engine.encode_seconds[0] * 1e3:.1f} "
          f"ms inside request clone-id's TTFA; VQ cache misses "
          f"{engine.vq_cache_misses}, hits {engine.vq_cache_hits}; prefix cache "
          f"hits {hits}, misses {misses}; prefill graph replays "
          f"{dict(session.replays)}; kernel launches {launches}")
    check_replayed(session, "clone")
    check_codec_replayed(engine, ("decode", "encode"), "clone")
    ttfa = {r["request"]: r["ttfa_s"] * 1e3 for r in rows}
    hit_same = np.array_equal(codes["clone-bytes"], codes["clone-id-repeat"])
    cold_same = np.array_equal(codes["clone-id"], codes["clone-id-cold"])
    cross = np.array_equal(codes["clone-id"], codes["clone-bytes"])
    print(f"clone TTFA: prefix hits (suffix_64) {ttfa['clone-bytes']:.1f} / "
          f"{ttfa['clone-id-repeat']:.1f} ms against the cold prefill_1024 "
          f"{ttfa['clone-id-cold']:.1f} ms (and {ttfa['clone-id']:.1f} ms with "
          f"the reference's load and encode; earlier runs of this script, "
          f"NVIDIA H100 80GB HBM3, 700.00 W: 52.5-59.5 ms for a cold repeat)")
    print(f"clone codes {codes['clone-id'].shape}: the two hits identical="
          f"{hit_same}, the two cold runs identical={cold_same}, hit vs cold "
          f"identical={cross} (printed, not held: bf16 sums in another order)")
    failures = [msg for bad, msg in (
        (engine.vq_cache_misses != 1 or engine.vq_cache_hits < 1,
         "the clip was not encoded exactly once"),
        (bucket != 1024 or session.replays[f"prefill_{bucket}"] != 2,
         "the cold prompts did not go through prefill_1024"),
        (hits != 2 or session.replays["suffix_64"] != 2,
         "the repeats were not prefix hits through suffix_64"),
        (min(launches.values()) <= 0, "a kernel of the path was never launched"),
        (engine.codec_replays[encode_key] < 1, "the encode graph never replayed"),
        (not hit_same or not cold_same,
         "the same reference, text and seed gave different codes"))
        if bad]
    if failures:
        raise SystemExit(f"clone: {'; '.join(failures)}")
    check_hit_logits(session, prompt_len)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    encode_ms = codec_device_ms(engine, encode_key, 5)
    step_ms = replayed_step_ms(session)
    print(f"clone: encode device ms per replay at {encode_key}: {encode_ms:.3f} "
          f"(its body's eager peak of temporaries "
          f"{eager_peak_mib(engine, encode_key):.1f} MiB); codec graph pool "
          f"{engine.codec_pool_bytes / 2**20:.1f} MiB; peak device memory over "
          f"the requests {peak:.2f} GiB; replayed decode step after them "
          f"{step_ms:.3f} ms of device time")

    # the replayed codes against eager runs of the same body on the card
    entry = engine.codec_graphs[encode_key]
    entry.graph.replay()
    replayed = entry.out.clone()
    with torch.no_grad():
        eager = dac_encode(engine.codec_params, dac_cfg, entry.inp)[0]
        flags = (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            fp32 = dac_encode(engine.codec_params, dac_cfg, entry.inp)[0]
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = flags
    bitwise = torch.equal(replayed, eager)
    share = (replayed[0, :, :n_frames] == fp32[0, :, :n_frames]).float().mean(dim=1)
    print(f"clone encode check: replayed codes equal an eager run on the card "
          f"bit for bit: {bitwise}; share of codes equal to an eager run "
          f"without TF32 (cuDNN and matmul), per codebook over {n_frames} "
          f"frames: {[round(float(x), 4) for x in share]} (printed, not held)")
    if not bitwise:
        raise SystemExit("clone: the replayed encode differs from its eager body")
    return dict(rows=rows, encode_ms=encode_ms, encode_s=engine.encode_seconds[0],
                prompt_len=prompt_len, launches=launches)


def check_hit_logits(session, prompt_len, label="clone"):
    """The stored clone prompt's (or `label`'s) first logits, cold (`dual_ar.prefill` at
    bucket 1024) against a prefix hit (the stored rows restored, then
    `prefill_suffix`), at the served hit's start (prompt - 1) and at a
    40-column suffix: within 0.05 of max |logit|, with the same argmax
    (the bound of `tests/test_prefix_cache.py`'s bf16 case)."""
    import torch

    from fish_speech_tpu_torch.generate import restore_prefix_rows
    from fish_speech_tpu_torch.models import dual_ar

    entry = next(e for e in session.prefix._store.values()
                 if e["cols"].shape[1] == prompt_len)
    cols, cfg, dev = entry["cols"], session.cfg, session.device
    t, bucket = cols.shape[1], session._bucket(prompt_len)
    inp = torch.zeros((1, cfg.num_codebooks + 1, bucket), dtype=torch.int32,
                      device=dev)
    inp[0, :, :t] = torch.from_numpy(cols)
    with torch.no_grad():
        cold, _, _ = dual_ar.prefill(session.params, cfg, inp, session.cache,
                                     torch.zeros(1, dtype=torch.int32, device=dev), t)
        for m in (t - 1, t - 40):
            restore_prefix_rows(session.cache, entry["rows"])
            sfx = torch.zeros((1, cfg.num_codebooks + 1, 64), dtype=torch.int32,
                              device=dev)
            sfx[0, :, : t - m] = inp[0, :, m:t]
            hit, _, _ = dual_ar.prefill_suffix(
                session.params, cfg, sfx, session.cache,
                torch.tensor([m], dtype=torch.int32, device=dev), t - m)
            delta = (hit - cold).abs().max().item()
            scale = cold.abs().max().item()
            same = int(hit.argmax()) == int(cold.argmax())
            print(f"{label} hit vs cold first logits (start {m}, suffix {t - m}): "
                  f"max |delta| {delta:.4f} against 0.05 x max |logit| "
                  f"{0.05 * scale:.4f}; argmax equal={same}")
            if not np.isfinite(delta) or delta > 0.05 * max(scale, 1.0) or not same:
                raise SystemExit(f"{label}: the hit's first logits left the cold "
                                 f"prefill's envelope")


def _tree_bytes(tree):
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def _fast_stack_frame(session):
    """One frame of the serving path's fast stack: `_sample_column` (project
    in, NC fast steps with their heads and samplers, one top-k of the slow
    head) on a random hidden state, reading the session's fixed buffers."""
    import torch

    from fish_speech_tpu_torch.generate import _sample_column

    cfg, dev, st = session.cfg, session.device, session.state
    gen = torch.Generator(device=dev).manual_seed(0)
    hidden = torch.randn((1, cfg.dim), generator=gen, device=dev,
                         dtype=session.params["embeddings"].dtype)
    logits = torch.randn((1, cfg.semantic_end_id - cfg.semantic_begin_id + 2),
                         generator=gen, device=dev)
    u = st.uniforms(cfg, st.draw)

    def frame(i=0):
        return _sample_column(session.params, cfg, session.scfg, logits, hidden,
                              None, u, st.sampling_args(), st.fast_cache)

    return frame


def fast_stack_frame_ms(session, frames=20):
    """The serving path's fast stack per frame, run eagerly: CUDA events
    over `frames` frames."""
    return _time_ms(_fast_stack_frame(session), frames)


def fast_stack_replayed_ms(session, frames=20):
    """The same frame captured in a CUDA graph: CUDA events over `frames`
    replays."""
    import torch

    frame = _fast_stack_frame(session)
    frame()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        frame()
    ms = _time_ms(lambda i=0: graph.replay(), frames)
    del graph
    return ms


# the serving fast stack per frame in three earlier runs of this script
# with the two-launch int4 matvec (NVIDIA H100 80GB HBM3, 700.00 W)
TWO_LAUNCH_FAST_STACK_MS = {"mixed": "159.234 / 172.634 / 174.479",
                            "int4": "161.277 / 155.006 / 261.142"}


# the figures of an earlier run of this script, before int8 products ran the
# int8 kernel (every one cast its weight to bf16; NVIDIA H100 80GB HBM3,
# 700.00 W): the graph pools and replayed steps of phase 6's sessions and
# phase 8's pools
CAST_ROUTE_GRAPH_POOL_MIB = {"mixed": 916.0, "int4": 984.0, "pool bf16": 1088.0,
                       "pool int8": 1288.0, "pool int8 P=1": 896.0}
CAST_ROUTE_STEP_MS = {"mixed": 33.952, "int4": 27.004, "pool int8": 53.500,
                "pool int8 P=1": 47.516}


def check_int8_ffn(per_step, label, want):
    """A replayed decode step runs each of its `want` int8 FFNs (every one
    has at most 32 rows) as one launch of the fused FFN kernel."""
    got = per_step.get("int8_ffn.launches", 0)
    if got != want:
        raise SystemExit(f"{label}: a replayed decode step launched the fused "
                         f"int8 FFN {got} times, not {want}")


def check_int8_route(per_step, label, required=True):
    """A replayed decode step launches the int8 kernel (where the weights
    hold int8 products) and never torch's cast route: every int8 product
    of a decode step has at most 32 rows."""
    kernel = per_step.get("int8_matmul.launches", 0)
    cast = per_step.get("mm.launches_int8_cast", 0)
    if cast or (required and kernel <= 0):
        raise SystemExit(f"{label}: a replayed decode step launched the int8 "
                         f"cast route {cast} times and the int8 kernel {kernel}")


def run_quant_slice(dev, tokenizer):
    """Phase 6: quantized serving of full-width s2-pro with the int8 KV
    cache, `mixed` (the short request and its repeat), then `int4` (the
    700-byte request)."""
    import torch

    from fish_speech_tpu_torch.config import SamplingConfig, dac_s2_pro
    from fish_speech_tpu_torch.convert.from_jax import init_dac_decoder
    from fish_speech_tpu_torch.generate import GenerationSession
    from fish_speech_tpu_torch.models import dual_ar
    from fish_speech_tpu_torch.ops.flash_decode import flash_decode_attention_kv8
    from fish_speech_tpu_torch.ops.flash_prefill import (flash_prefill_attention,
                                                         flash_suffix_attention)
    from fish_speech_tpu_torch.ops.int4 import int4_matmul
    from fish_speech_tpu_torch.ops.int8 import int8_matmul
    from fish_speech_tpu_torch.ops.int8_ffn import int8_ffn
    from fish_speech_tpu_torch.ops.quant import mm, quantize_dual_ar_lowmem

    cfg = _s2_pro_cfg(tokenizer, 2048)
    dac_cfg = dac_s2_pro()
    codec = init_dac_decoder(1, dac_cfg, torch.float32, dev)
    wrappers = {"flash_decode_kv8": flash_decode_attention_kv8}
    requests = dict(_requests())
    # `mixed` keeps the prefix cache on: the medium request (a prompt of
    # over 128 columns, stored) and its repeat, a hit over the int8 cache
    requests["medium-repeat"] = requests["medium"]
    out = {}
    for label, mode, fast_mode, names in (
            ("mixed", "int8", "int4", ["short", "short-repeat", "medium",
                                       "medium-repeat"]),
            ("int4", "int4", None, ["long"])):
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        params = quantize_dual_ar_lowmem(
            dual_ar.init_dual_ar(0, cfg, torch.bfloat16, dev), mode=mode,
            fast_mode=fast_mode)
        session = GenerationSession(params, cfg, SamplingConfig(), max_batch=1,
                                    dtype=torch.bfloat16, decode_chunk_size=64,
                                    first_chunk_size=8, kv_quant=True,
                                    prefix_cache_size=4 if label == "mixed" else 0)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        engine = _recording_engine(session, tokenizer, codec, dac_cfg)
        torch.cuda.synchronize()
        weight_bytes = _tree_bytes(session.params)
        print(f"quantized slice {label} (slow {mode}, fast {fast_mode or mode}, "
              f"heads int8, int8 KV cache): built and quantized in "
              f"{time.perf_counter() - t0:.1f}s; session weights "
              f"{weight_bytes / 2**30:.3f} GiB; device memory allocated "
              f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB")
        served = [(n, requests[n]) for n in names]
        precompile_for(session, tokenizer, served, label,
                       suffix_buckets=(1,) if label == "mixed" else ())
        print(f"{label} graph pool {session.pool_bytes / 2**20:.1f} MiB against "
              f"{CAST_ROUTE_GRAPH_POOL_MIB[label]:.1f} before the int8 kernel (the "
              f"prefill's LM head cast its whole int8 head to bf16; an earlier "
              f"run of this script)")
        precompile_codec(engine, PHASE4_CODE_BUCKETS, (), label)
        _zero_counts()
        rows = serve(dev, tokenizer, engine, served, dac_cfg.frame_length, label)
        # the int4 matmul's routes: matvec (decode), tensor cores (bf16
        # prefill); the fp32 route ("fp32_tc") serves no bf16 model
        launches = dict(_counted(wrappers),
                        flash_prefill=flash_prefill_attention.launches_wgmma,
                        int4_mm=int4_matmul.launches_gemv,
                        int4_mm_wgmma=int4_matmul.launches_wgmma,
                        int4_mm_fp32_tc=int4_matmul.launches_fp32_tc,
                        int8_mm=int8_matmul.launches_gemv_mma,
                        int8_mm_cluster=int8_matmul.launches_gemv_cluster,
                        int8_ffn=int8_ffn.launches_mma,
                        int8_cast=mm.launches_int8_cast,
                        flash_suffix_kv8=flash_suffix_attention.launches_suffix_kv8_wgmma)
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        if label == "mixed":
            same = np.array_equal(engine.codes_by_request["medium"],
                                  engine.codes_by_request["medium-repeat"])
            print(f"mixed prefix cache: hits {session.prefix_hits}, misses "
                  f"{session.prefix_misses}; the repeat's suffix_64 replays "
                  f"{session.replays['suffix_64']}, its TTFA "
                  f"{rows[3]['ttfa_s'] * 1e3:.1f} ms against the cold "
                  f"{rows[2]['ttfa_s'] * 1e3:.1f} ms; codes of the hit equal the "
                  f"cold run's={same} (printed, not held: the hit attends the "
                  f"prefix's int8 keys, the cold prefill its fresh ones)")
            if (session.prefix_hits != 1 or session.replays["suffix_64"] != 1
                    or launches["flash_suffix_kv8"] <= 0):
                raise SystemExit("mixed: the repeated medium request was not a "
                                 "prefix hit through suffix_64")
        per_step = check_replayed(session, label)
        check_int8_route(per_step, label)
        # `mixed`: the slow stack's FFNs are int8, the fast stack's int4
        check_int8_ffn(per_step, label, cfg.n_layer if label == "mixed" else 0)
        check_codec_replayed(engine, ("decode",), label)
        step_ms = replayed_step_ms(session)
        fast_ms = fast_stack_frame_ms(session)
        fast_replayed_ms = fast_stack_replayed_ms(session)
        print(f"{label}: kernel launches {launches}; peak device memory "
              f"{peak:.2f} GiB; replayed decode step {step_ms:.3f} ms "
              f"({1e3 / step_ms:.2f} steps/s; the eager session: "
              f"{EAGER_FIGURES[label]}); serving fast stack "
              f"{fast_ms:.3f} ms/frame eager, {fast_replayed_ms:.3f} replayed "
              f"(_sample_column, CUDA events; eager with the two-launch "
              f"matvec: {TWO_LAUNCH_FAST_STACK_MS[label]} ms/frame)")
        # `mixed` keeps its slow stack int8, so only `int4` prefills in int4;
        # both keep their heads int8
        required = ["int4_mm", "flash_prefill", "int8_mm", *wrappers] + (
            ["int4_mm_wgmma"] if label == "int4" else ["int8_ffn"])
        if min(launches[k] for k in required) <= 0:
            raise SystemExit(f"{label}: a kernel of the quantized path was never "
                             f"launched: {launches}")
        if label == "int4":
            ttfa_ms = rows[0]["ttfa_s"] * 1e3
            print(f"int4 700-byte request: TTFA {ttfa_ms:.1f} ms against the "
                  f"predicted 80-160 ms (the eager session: "
                  f"{EAGER_FIGURES['int4']}); tensor-core route launched "
                  f"{launches['int4_mm_wgmma']} times")
        print(f"{label}: replayed decode step {step_ms:.3f} ms against "
              f"{CAST_ROUTE_STEP_MS[label]} ms before the int8 kernel (an earlier run "
              f"of this script); int8 kernel launches per replayed step "
              f"{per_step.get('int8_matmul.launches', 0)}, fused int8 FFN "
              f"{per_step.get('int8_ffn.launches', 0)}")
        out[label] = dict(rows=rows, launches=launches, peak_gib=peak,
                          weight_bytes=weight_bytes, fast_stack_ms=fast_ms,
                          step_ms=step_ms, launches_per_step=per_step,
                          graph_pool_mib=session.pool_bytes / 2**20)
        del engine, session
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _probe_faults(weights, dims):
    """Two faulty weight sets for the plain chain, to show what a wrong
    kernel scores against the check's bound: layer 0 reads layer 1's whole
    w2 (the kind of fault the TPU probe's prefetch race makes), and layer 0
    reads layer 1's w2 in one 128-column tile only (one block's share)."""
    from fish_speech_tpu_torch.ops.faststack import layer_weights

    faults = {}
    for name, cols in (("layer 0 reads layer 1's w2", slice(None)),
                       ("one 128-column tile of layer 0's w2 from layer 1",
                        slice(0, 128))):
        bad = {"w": weights["w"].clone(), "sc": weights["sc"]}
        layer_weights(bad, 0, dims)["w2"][0][:, cols] = (
            layer_weights(weights, 1, dims)["w2"][0][:, cols])
        faults[name] = bad
    return faults


def run_probe(dev, serving_fast_ms):
    """Phase 7: the fast-stack probe at flagship dims against its plain
    version, R in {0, 1} x {bf16, w8a8}."""
    import torch

    from fish_speech_tpu_torch.ops import faststack

    dims = faststack.ProbeDims()
    t0 = time.perf_counter()
    weights = faststack.make_weights(dims, dev)
    print(f"probe: {dims}, weights {dims.layer_bytes * dims.n_layer / 1e6:.1f} MB "
          f"int8 made in {time.perf_counter() - t0:.1f}s")
    x = torch.full((1, dims.df), 0.01, device=dev)
    configs = [(variant, r) for variant in ("bf16", "w8a8") for r in (0, 1)]
    # the checks: one and two codebook steps (12 and 24 layers; the second
    # step re-reads every layer, the resident one from L2) at full width
    held = [dataclasses.replace(dims, steps=n) for n in (1, 2)]
    tol = {"bf16": 5e-2, "w8a8": 1e-5}
    faults = _probe_faults(weights, dims)
    for variant in tol:
        for d in held:
            want = faststack.probe_reference(x, weights, variant, d)
            for name, bad in faults.items():
                e = (faststack.probe_reference(x, bad, variant, d) - want).abs()
                print(f"probe fault yardstick {variant} steps={d.steps}: {name}: "
                      f"max_abs_err {e.max().item():.3e} mean {e.mean().item():.3e} "
                      f"(bound {tol[variant]:g})")
                if e.max().item() <= tol[variant]:
                    raise SystemExit(f"probe: the {variant} bound cannot see a "
                                     f"fault ({name})")
    del faults
    checks = {}
    for variant, r in configs:
        errs = []
        for d in held:
            got = faststack.faststack_probe(x, weights, r, variant, d)
            want = faststack.probe_reference(x, weights, variant, d)
            errs.append((got - want).abs())
        frame = faststack.faststack_probe(x, weights, r, variant, dims)
        again = faststack.faststack_probe(x, weights, r, variant, dims)
        if not torch.equal(frame, again):  # each column summed in one order
            raise SystemExit(f"probe R={r} {variant}: two frames differ")
        frame_want = faststack.probe_reference(x, weights, variant, dims)
        plain_ms = _time_ms(lambda i=0: faststack.probe_reference(
            x, weights, variant, dims), 2)
        checks[variant, r] = dict(
            errs=errs, out_max=want.abs().max().item(),
            finite=bool(torch.isfinite(frame).all()), plain_ms=plain_ms,
            frame_err=(frame - frame_want).abs().max().item(),
            spread=(frame - again).abs().max().item())
    # the probe's own entry point (`python -m ...faststack`'s `_bench`):
    # best of 3 x 30 chained frames; only these launches are counted
    faststack.faststack_probe.launches = 0
    rows = []
    scale_bytes = 4 * (dims.dqkv + 2 * dims.df + 2 * dims.inter)
    for variant, r in configs:
        ms = faststack._bench(r, variant, dims=dims, weights=weights, device=dev)
        # a frame's pieces alone (the same best of 3 x 30 frames)
        parts = {part: faststack.part_ms(part, r, variant, dims=dims,
                                         weights=weights, device=dev)
                 for part in ("barriers", "loads")}
        c = checks[variant, r]
        plain_ms = c["plain_ms"]
        traffic = dims.frame_bytes(r)
        # least time: every streamed layer (weights and scales) is read on
        # each step, the resident one once; the L2 cannot hold the rest
        layer_reads = r + dims.steps * (dims.n_layer - r)
        flops = 2 * dims.layer_bytes * dims.n_layer * dims.steps
        bound = _bound(flops, traffic + layer_reads * scale_bytes + 8 * dims.df,
                       PEAK_INT8 if variant == "w8a8" else PEAK_BF16)
        row = dict(shape=f"R={r} {variant} DF={dims.df} DQKV={dims.dqkv} "
                         f"INTER={dims.inter} NL={dims.n_layer} "
                         f"steps={dims.steps} (error: 1 and 2 steps)",
                   max_abs_err=max(e.max().item() for e in c["errs"]),
                   mean_abs_err=max(e.mean().item() for e in c["errs"]),
                   step_max_abs_err=[e.max().item() for e in c["errs"]],
                   frame_max_abs_err=c["frame_err"], frame_spread=c["spread"],
                   ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
                   bound_by=bound[1], library_ms=None,
                   effective_gb_s=traffic / ms / 1e6,
                   barriers_ms=parts["barriers"], loads_ms=parts["loads"])
        rows.append(row)
        steps_err = ", ".join(f"{d.steps} step(s) ({d.steps * d.n_layer} layers) "
                              f"{e.max().item():.3e} mean {e.mean().item():.3e}"
                              for d, e in zip(held, c["errs"]))
        print(f"probe R={r} {variant}: {ms:.4f} ms/frame, effective "
              f"{row['effective_gb_s']:.0f} GB/s over {traffic / 1e9:.3f} GB "
              f"(bound {row['bound_ms']:.4f} ms, {row['bound_by']}, "
              f"{row['bound_ms'] / ms:.1%} of it); its "
              f"{4 * dims.n_layer * dims.steps} grid barriers alone "
              f"{parts['barriers']:.4f} ms/frame, its weight stream alone "
              f"{parts['loads']:.4f} ms/frame; plain "
              f"{plain_ms:.2f} ms; max_abs_err at {steps_err} (bound "
              f"{tol[variant]:g}), max |out| {c['out_max']:.3f}; whole frame "
              f"({dims.steps * dims.n_layer} layers): max_abs_err "
              f"{c['frame_err']:.3e}, kernel run-to-run {c['spread']:.3e} "
              f"(equal bits required)")
        if not (c["finite"] and row["max_abs_err"] <= tol[variant]):
            raise SystemExit(f"probe R={r} {variant} disagrees with its plain "
                             f"version")
    launches = faststack.faststack_probe.launches
    faststack.reset_l2_persistence()
    print(f"probe vs serving: the probe's matvec chain {min(r['ms'] for r in rows):.3f}"
          f"-{max(r['ms'] for r in rows):.3f} ms/frame against the serving fast "
          f"stack's {serving_fast_ms:.3f} ms/frame (mixed: fast int4, with "
          f"attention, heads and sampling); kernel launches {launches}")
    if launches <= 0:
        raise SystemExit("the probe kernel was never launched")
    return rows, launches


def _write_protos(path, num_codebooks, codebook_size, rng):
    """A small proto shard: two speakers, sentences of random text and
    random codes, enough for samples past 1024 tokens and shorter ones."""
    from fish_speech_tpu_torch.data.protos import Semantics, Sentence, TextData
    from fish_speech_tpu_torch.data.stream import write_pb_stream

    words = ["speech", "model", "voice", "quiet", "river", "light", "stone",
             "window", "morning", "paper", "simple", "garden"]
    with open(path, "wb") as f:
        for name, n_sentences in (("spk0", 16), ("spk1", 5)):
            sentences = []
            for _ in range(n_sentences):
                text = " ".join(rng.choice(words, size=int(rng.integers(4, 9))))
                frames = int(rng.integers(20, 60))
                sems = [Semantics(values=rng.integers(0, codebook_size,
                                                      size=frames).tolist())
                        for _ in range(num_codebooks)]
                sentences.append(Sentence(texts=[text], semantics=sems))
            write_pb_stream(f, TextData(source="chip_smoke", name=name,
                                        sentences=sentences))
    return path


def run_train_slice(dev, tokenizer, cfg, out_dir):
    """Phase 5: LoRA fine-tuning of `cfg` through `Trainer.fit` on one batch
    of the shared data pipeline, repeated, so that the loss must fall."""
    import itertools
    import shutil

    import torch

    from fish_speech_tpu_torch.data.dataset import (SemanticIterableDataset,
                                              TextDataCollator)
    from fish_speech_tpu_torch.models.dual_ar import param_count
    from fish_speech_tpu_torch.models.lora import LoraConfig
    from fish_speech_tpu_torch.ops.flash_train import (flash_train_backward,
                                                       flash_train_forward)
    from fish_speech_tpu_torch.train.trainer import TrainConfig, Trainer

    steps, batch_size, max_length = 8, 2, 1024
    # constant after a one-step warmup: at this rate the loss on the
    # repeated batch falls within the 8 steps
    lr = 1e-3
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    rng = np.random.default_rng(0)
    proto = _write_protos(out_dir / "data.protos", cfg.num_codebooks,
                          cfg.codebook_size, rng)
    ds = SemanticIterableDataset([str(proto)], tokenizer, seed=0,
                                 max_length=max_length,
                                 num_codebooks=cfg.num_codebooks)
    stream = iter(ds)
    batch = TextDataCollator(tokenizer, max_length)(
        [next(stream) for _ in range(batch_size)])
    real_tokens = int((~batch["pad_mask"]).sum())

    lora = LoraConfig(r=8, lora_alpha=16.0,
                      target_modules=["attention", "mlp", "embeddings", "output"])
    tcfg = TrainConfig(output_dir=str(out_dir), project="lora",
                       max_steps=steps, batch_size=batch_size,
                       max_length=max_length, lr=lr, warmup_steps=1,
                       schedule="constant", log_every_steps=1,
                       val_every_steps=10 ** 9, ckpt_every_steps=steps,
                       seed=0, precision="bfloat16", lora=lora)
    t0 = time.perf_counter()
    trainer = Trainer(cfg, tcfg, device=dev)
    torch.cuda.synchronize()
    flat = _flat(trainer.params)
    n_lora = sum(v.numel() for k, v in flat.items() if "lora" in k)
    n_base = param_count(trainer.params) - n_lora
    print(f"training slice: {n_base / 1e9:.3f}B base params bf16 (frozen, "
          f"remat={trainer.cfg.use_gradient_checkpointing}), "
          f"{n_lora / 1e6:.2f}M LoRA params (r=8, alpha=16, "
          f"{','.join(lora.target_modules)}), built in "
          f"{time.perf_counter() - t0:.1f}s; batch {tuple(batch['inputs'].shape)} "
          f"from the data pipeline, {real_tokens} real tokens; constant LR "
          f"{lr:g} after a 1-step warmup; device memory allocated "
          f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB")
    # samples of the frozen base: first/last layers, the semantic rows and
    # columns of the tables the batch reads
    sem = slice(cfg.semantic_begin_id, cfg.semantic_end_id + 1)
    samples = {"layers/wqkv": (0,), "layers/w2": (-1,), "fast/layers/w1": (0,),
               "embeddings": (sem,), "codebook_embeddings": (slice(0, 4096),),
               "output": (slice(None), sem), "fast/output": (slice(None),)}
    frozen = {k: flat[k][idx].clone() for k, idx in samples.items()}

    _zero_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    trainer.fit(itertools.repeat(batch, steps), resume=False)
    torch.cuda.synchronize()
    launches = {"flash_train_fwd": flash_train_forward.launches_wgmma,
                "flash_train_bwd": flash_train_backward.launches_wgmma}
    bwd_other = flash_train_backward.launches - flash_train_backward.launches_wgmma
    peak = torch.cuda.max_memory_allocated(dev) / 2**30

    recs = [json.loads(line) for line in
            (trainer.out_dir / "metrics.jsonl").read_text().splitlines()]
    step_tokens = batch_size * max_length
    for r in recs:
        s = 1.0 / r["it_per_s"]
        print(f"train step {r['step']}: loss {r['loss']:.4f} (base "
              f"{r['base_loss']:.4f} semantic {r['semantic_loss']:.4f}) grad_norm "
              f"{r['grad_norm']:.4f} {s:.3f} s/step {step_tokens / s:.0f} tokens/s "
              f"({real_tokens / s:.0f} real)")
    steady = float(np.mean([1.0 / r["it_per_s"] for r in recs[1:]]))
    print(f"training: steps 2-{steps} mean {steady:.4f} s/step, "
          f"{step_tokens / steady:.0f} tokens/s (predicted 0.74-0.77 s/step, "
          f"about 2,650-2,770 tokens/s, with the tensor-core attention "
          f"forward; 0.8586-0.8709 s/step without); peak device memory "
          f"{peak:.2f} GiB; kernel launches {launches} (forward and backward "
          f"on the tensor-core route; all routes: forward "
          f"{flash_train_forward.launches}, backward "
          f"{flash_train_backward.launches})")

    losses = [r["loss"] for r in recs]
    if len(recs) != steps or not np.isfinite(losses).all():
        raise SystemExit(f"training: losses {losses}")
    if not losses[-1] < losses[0]:
        raise SystemExit(f"training: the loss did not fall on a repeated batch: "
                         f"{losses}")
    flat = _flat(trainer.params)
    changed = [k for k, v in frozen.items()
               if not torch.equal(flat[k][samples[k]], v)]
    zero_b = [k for k, v in flat.items()
              if "lora" in k and k.endswith("/b") and not bool(v.any())]
    if changed or zero_b:
        raise SystemExit(f"training: frozen tensors changed {changed}, LoRA B "
                         f"leaves still zero {zero_b}")
    if min(launches.values()) <= 0:
        raise SystemExit("a training kernel of the path was never launched")
    # 36 layers, each backward once under remat, over 8 steps
    if launches["flash_train_bwd"] != 288 or bwd_other:
        raise SystemExit(f"training: {launches['flash_train_bwd']} backward "
                         f"launches on the wgmma route (want 288) and "
                         f"{bwd_other} on the others (want 0)")

    # the checkpoint holds the LoRA leaves and the optimizer state: wipe the
    # leaves and restore them
    ckpt = trainer.latest_checkpoint()
    lora_now = {k: v.detach().clone() for k, v in flat.items() if "lora" in k}
    with torch.no_grad():
        for k in lora_now:
            flat[k].zero_()
    trainer.step = 0
    restored = trainer.restore_checkpoint(ckpt)
    same = all(torch.equal(flat[k], v) for k, v in lora_now.items())
    print(f"checkpoint {ckpt.name}: {len(lora_now)} LoRA leaves restored "
          f"identical={same}, step {trainer.step}, optimizer count "
          f"{trainer.optimizer.count}")
    if not (restored and same and trainer.step == steps
            and trainer.optimizer.count == steps):
        raise SystemExit("training: the checkpoint did not restore")
    return launches, dict(cfg=cfg, batch=batch_size, seq=max_length, step_s=steady)


# phase 5b: the train CLI as a user runs it, `--tiny` (JAX's tiny model)
# in bf16, its default precision, in a process of its own on the card. The
# harness runs the CLI's `main` with the user's flags, logs every step's
# metrics (`TrainConfig.log_every_steps`, 10 by default, to 1) and prints
# the training attention's launch counts at the end.
TRAIN_CLI_HARNESS = """
import dataclasses, json, sys
from fish_speech_tpu_torch.ops import flash_train
from fish_speech_tpu_torch.train import cli, trainer

@dataclasses.dataclass
class EveryStep(trainer.TrainConfig):
    log_every_steps: int = 1

trainer.TrainConfig = EveryStep
cli.main(sys.argv[1:], standalone_mode=False)
print(json.dumps({f"{w.__name__}.{r}": getattr(w, "launches_" + r)
                  for w in (flash_train.flash_train_forward,
                            flash_train.flash_train_backward)
                  for r in flash_train.ROUTES}))
"""


def run_train_cli(out_dir):
    """Phase 5b: `python -m fish_speech_tpu_torch.train.cli --tiny` takes 2
    LoRA steps in bf16 on a proto shard written by phase 5's writer (ten
    codebooks of the tiny model's 32 codes): the slow stack's attention at
    JAX's D=32 must launch on "bf16_tf32" (forward and backward) and on
    no other route, and both steps' losses must be finite. Returns the
    route's launches."""
    import os
    import shutil

    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    root = Path(__file__).resolve().parent
    proto = _write_protos(out_dir / "tiny.protos", 10, 32, np.random.default_rng(3))
    args = ["--tiny", "--data", proto, "--output", out_dir / "run", "--max-steps", 2,
            "--batch-size", 2, "--max-length", 256, "--lora-r", 8, "--warmup-steps", 1,
            "--val-every", 10 ** 9, "--no-resume"]
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", TRAIN_CLI_HARNESS, *map(str, args)],
                          cwd=str(root), env=dict(os.environ, PYTHONPATH=str(root)),
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise SystemExit(f"train.cli --tiny failed: {proc.stderr[-3000:]}")
    counts = json.loads(proc.stdout.strip().splitlines()[-1])
    metrics = next((out_dir / "run").rglob("metrics.jsonl"))
    losses = [json.loads(line)["loss"] for line in metrics.read_text().splitlines()]
    launches = {
        "flash_train_fwd_bf16_tf32": counts["flash_train_forward.bf16_tf32"],
        "flash_train_bwd_bf16_tf32": counts["flash_train_backward.bf16_tf32"]}
    others = sum(n for name, n in counts.items() if not name.endswith(".bf16_tf32"))
    print(f"train.cli --tiny (bf16, JAX's tiny model, heads 32 wide; a process of "
          f"its own): losses {losses}, launches {counts}, "
          f"{time.perf_counter() - t0:.1f}s")
    if len(losses) != 2 or not np.isfinite(losses).all():
        raise SystemExit(f"train.cli --tiny: losses {losses}")
    if min(launches.values()) <= 0 or others:
        raise SystemExit(f"train.cli --tiny: the bf16 D=32 route did not carry the "
                         f"attention: {counts}")
    shutil.rmtree(out_dir, ignore_errors=True)
    return launches


# phase 8: the 40 texts of the burst, whose prompts reach two buckets
# (128 and 256 with the system prompt), and the index of the request sent
# again alone
POOL_CLIENTS, POOL_REPEAT = 40, 5
POOL_TIMED_POS = 256  # the rows' position when a step alone is timed


def _pool_requests():
    from fish_speech_tpu_torch.engine.tts import TTSRequest

    long_tail = (" The pool decodes every stream in one step, and each one keeps "
                 "its own place, seed and budget.")
    # the index first: no two prompts share 64 leading columns, so the
    # burst is the prefix cache's miss side (the same-reference burst after
    # it is the hit side) and the request repeated alone takes the path it
    # took in the burst
    texts = [f"{i} is a pooled request saying hello." + (long_tail if i % 2 else "")
             for i in range(POOL_CLIENTS)]
    return [TTSRequest(text=t, streaming=True, max_new_tokens=64, seed=100 + i)
            for i, t in enumerate(texts)]


def _pool_engine(session, tokenizer, codec, dac_cfg, references_dir="references"):
    """An engine that keeps each request thread's last decoded codes (the
    closing decode of its segment) and the host seconds of each decode."""
    from fish_speech_tpu_torch.engine.tts import TTSInferenceEngine

    class PoolRecordingEngine(TTSInferenceEngine):
        def __init__(self, *args):
            super().__init__(*args)
            self.codes = {}
            self.decode_seconds = []

        def decode_vq_tokens(self, codes):
            self.codes[threading.get_ident()] = np.array(codes)
            t0 = time.perf_counter()
            out = super().decode_vq_tokens(codes)
            self.decode_seconds.append(time.perf_counter() - t0)
            return out

    return PoolRecordingEngine(session, tokenizer, codec, dac_cfg, references_dir)


def pool_serve(engine, requests, frame, label):
    """Stream `requests` from one thread each, all released together;
    returns (rows per request, the wall time of the first submit)."""
    rows = [None] * len(requests)
    errors = []
    gate = threading.Barrier(len(requests) + 1)

    def client(i, req):
        gate.wait()
        t0 = time.perf_counter()
        first = last = None
        samples = 0
        try:
            for res in engine.inference(req):
                now = time.perf_counter()
                if res.code == "error":
                    raise res.error
                if res.code == "segment":
                    audio = res.audio[1]
                    if len(audio) % frame or not np.isfinite(audio).all():
                        raise ValueError(f"a segment of {len(audio)} samples is "
                                         f"not whole finite frames")
                    samples += len(audio)
                    first = first or now
                    last = now
                if res.code == "final" and (not np.isfinite(res.audio[1]).all()
                                            or len(res.audio[1]) != samples):
                    raise ValueError("bad final audio")
            if first is None or samples // frame < 2:
                raise ValueError(f"only {samples // frame} frames")
            rows[i] = dict(t0=t0, first=first, last=last, frames=samples // frame,
                           codes=engine.codes[threading.get_ident()])
        except Exception as e:  # reported below, after every client ends
            errors.append((i, e))

    threads = [threading.Thread(target=client, args=(i, r), daemon=True)
               for i, r in enumerate(requests)]
    for t in threads:
        t.start()
    gate.wait()
    t_submit = time.perf_counter()
    deadline = time.monotonic() + 300
    for t in threads:
        t.join(timeout=max(0.0, deadline - time.monotonic()))
    if any(t.is_alive() for t in threads):
        # a hung request: every thread's stack, then out without waiting
        # for threads blocked on the device
        import faulthandler
        import os

        print(f"{label} pool: {sum(t.is_alive() for t in threads)} requests "
              f"still running after 300 s; every thread's stack:", flush=True)
        faulthandler.dump_traceback(all_threads=True)
        sys.stderr.flush()
        os._exit(1)
    if errors:
        raise SystemExit(f"{label} pool: failed requests {errors[:4]} "
                         f"({len(errors)} in all)")
    return rows, t_submit


def _pct(xs, q):
    return float(np.percentile(np.asarray(xs, np.float64), q))


def pool_step_ms(batcher, reps=8, pos=POOL_TIMED_POS):
    """Device ms of one replayed pool step: `reps` sub-chunks of the
    batcher's step buffer (the step index reset, then its replays) between
    CUDA events, after one untimed, with every row at position `pos` and
    inactive (an inactive row computes as an active one does and keeps its
    position, so each replay reads pos + 1 cached positions)."""
    import torch

    from fish_speech_tpu_torch.generate import replay_graph

    graph = batcher._graphs["decode"]
    n = batcher.state.cols.shape[0]

    def sub_chunks(k):
        for _ in range(k):
            batcher.state.step.zero_()
            for _ in range(n):
                replay_graph(*graph)

    with batcher._state_lock:  # the worker, idle, stays off the buffers
        batcher.state.active.zero_()
        batcher.state.pos.fill_(pos)
        sub_chunks(1)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        sub_chunks(reps)
        end.record()
        end.synchronize()
    return start.elapsed_time(end) / (reps * n)


def graph_eager_peak_mib(batcher, name):
    """MiB above the allocation before it that an eager run of graph
    `name`'s body (`ContinuousBatcher._eager_run`, which puts the pool's
    carried buffers back) peaks at: its live temporaries, with the
    carry's copies."""
    import torch

    with batcher._state_lock:  # the worker, idle, stays off the buffers
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        batcher._eager_run(name)
        torch.cuda.synchronize()
        return (torch.cuda.max_memory_allocated() - base) / 2**20


def print_pool_accounting(batcher, label):
    """Each graph's pool growth beside its body's eager peak of temporaries."""
    rows = {name: (batcher.pool_growth[name] / 2**20,
                   graph_eager_peak_mib(batcher, name))
            for name in batcher.pool_growth}
    print(f"{label} graph pool accounting (MiB: the capture's pool growth / the "
          f"body's eager peak of temporaries): "
          + ", ".join(f"{k} {g:.1f}/{e:.1f}" for k, (g, e) in rows.items())
          + f"; pool {batcher.pool_bytes / 2**20:.1f} MiB")
    return rows


def _pool_for(params, cfg, pool_size, kv_quant, prefix_cache_size=0):
    import torch

    from fish_speech_tpu_torch.config import SamplingConfig
    from fish_speech_tpu_torch.engine.batcher import ContinuousBatcher

    return ContinuousBatcher(params, cfg, SamplingConfig(), pool_size=pool_size,
                             dtype=torch.bfloat16, decode_chunk_size=128,
                             first_chunk_size=8, admit_every=4,
                             kv_quant=kv_quant, prefix_cache_size=prefix_cache_size)


# phase 8's same-reference burst (int8 pool): one request stores the
# speaker's prompt, then CLONE_BURST more by the same reference id are hits
CLONE_BURST = 16


def _clone_requests(n, seed0):
    from fish_speech_tpu_torch.engine.tts import TTSRequest

    return [TTSRequest(text=f"Line {i} of the same speaker.", reference_id="speaker",
                       use_memory_cache="on", streaming=True, max_new_tokens=32,
                       seed=seed0 + i) for i in range(n)]


def run_clone_burst(engine, batcher, frame):
    """Phase 8's int8 pool: a clone request stores its prompt's rows, then
    a burst of CLONE_BURST more by the same reference: their admission
    groups must be prefix hits through `suffix_*` replays. Then four of the
    burst's prompts (the lowest seeds: the same four in every run) as one
    admission group, served twice: a hit through `suffix_4_*` both times,
    with the same codes; and the first logits of all 16 prompts as one hit
    group computes them against a cold prefill of the same prompts
    (`check_pool_hit_logits`)."""
    from fish_speech_tpu_torch.ops.flash_prefill import flash_suffix_attention

    hits0 = batcher.prefix.hits
    batcher.replays.clear()
    batcher.eager_runs.clear()  # the accounting above ran every body eagerly
    first, _ = pool_serve(engine, _clone_requests(1, 300), frame, "clone burst")
    n0 = flash_suffix_attention.launches_suffix_kv8_wgmma
    recorded = []  # the burst's (seed, prompt) as the engine built them
    submit = batcher.submit

    def recording(req):
        recorded.append((req.seed, req.prompt))
        return submit(req)

    batcher.submit = recording
    try:
        rows, _ = pool_serve(engine, _clone_requests(CLONE_BURST + 1, 300)[1:],
                             frame, "clone burst")
    finally:
        del batcher.submit
    launched = flash_suffix_attention.launches_suffix_kv8_wgmma - n0
    hits = batcher.prefix.hits - hits0
    suffix = {k: n for k, n in batcher.replays.items() if k.startswith("suffix")}
    ttfa = [(r["first"] - r["t0"]) * 1e3 for r in rows]
    print(f"pool int8 same-reference burst: the first request (stores its rows) "
          f"TTFA {(first[0]['first'] - first[0]['t0']) * 1e3:.1f} ms; "
          f"{CLONE_BURST} more by the same reference: prefix hits {hits}, "
          f"suffix graph replays {suffix}, TTFA ms p50 {_pct(ttfa, 50):.1f} max "
          f"{max(ttfa):.1f}; suffix kernel launches {launched}; eager body runs "
          f"{dict(batcher.eager_runs)}; prefix store {batcher.prefix.hits} hits, "
          f"{batcher.prefix.misses} misses")
    if hits < 1 or not suffix or launched <= 0 or batcher.eager_runs:
        raise SystemExit("pool int8: the same-reference burst was not served by "
                         "prefix hits through suffix graphs")
    prompts = [p for _, p in sorted(recorded, key=lambda r: r[0])]
    group = prompts[:4]
    pre = batcher._group_prefix([SimpleNamespace(prompt=p) for p in group])
    if pre is None:
        raise SystemExit("pool int8: four of the burst's prompts are no prefix hit")
    name = f"suffix_4_{pre[2]}"
    hits0, replays0 = batcher.prefix.hits, batcher.replays[name]
    served = [_serve_group(batcher, group, 400) for _ in range(2)]
    same = all(np.array_equal(a, b) for a, b in zip(*served))
    print(f"pool int8 hit group (4 of the burst's prompts, start {pre[0]}) served "
          f"twice: prefix hits {batcher.prefix.hits - hits0}, {name} replays "
          f"{batcher.replays[name] - replays0}, codes "
          f"{[c.shape[1] for c in served[0]]} columns identical={same}; eager "
          f"body runs {dict(batcher.eager_runs)}")
    if (batcher.prefix.hits - hits0 != 2 or batcher.replays[name] - replays0 != 2
            or batcher.eager_runs or not same):
        raise SystemExit("pool int8: the hit group served twice was not two "
                         f"{name} replays with the same codes")
    with _counts_kept():  # a comparison's launches, not the path's
        check_pool_hit_logits(batcher, prompts)


def _serve_group(batcher, prompts, seed0):
    """The sampled columns of `prompts` (16 new tokens each), submitted
    while the worker waits on the batcher's lock, so that one admission
    pass takes them all: one group."""
    from fish_speech_tpu_torch.engine.batcher import BatchRequest

    reqs = [BatchRequest(prompt=p, seed=seed0 + j, max_new_tokens=16)
            for j, p in enumerate(prompts)]
    with batcher._state_lock:
        outs = [batcher.submit(r) for r in reqs]
    cols = []
    for out in outs:
        chunks = []
        while (item := out.get(timeout=300)) is not None:
            if isinstance(item, BaseException):
                raise SystemExit(f"pool int8: the hit group failed: {item!r}")
            chunks.append(item)
        cols.append(np.concatenate(chunks).T)
    return cols


def check_pool_hit_logits(batcher, prompts):
    """A pool hit group's first logits against a cold prefill of the same
    prompts: cold, `dual_ar.prefill` of the whole prompts into a fresh
    cache; as the batcher's hit computes them, the stored row restored into
    every row of a fresh cache (`restore_prefix_rows`), then
    `prefill_suffix` at the group's start with each row's suffix length;
    and, with the cold prefill's own int8 rows in place of the stored ones,
    `prefill_suffix` again over the cache the cold prefill wrote. Each row
    of the hit within 0.05 of its max |logit| of both (phase 4b's bound),
    with the argmax of the second: both attend the same int8 prefix keys.
    The argmax against the cold prefill is printed, not held: the hit
    attends the prefix's int8 keys where the cold prefill attends fresh
    ones, and a row whose top two logits lie closer than twice that
    difference may change its argmax (JAX's int8 cache does the same)."""
    import torch

    from fish_speech_tpu_torch.generate import pick_bucket, restore_prefix_rows
    from fish_speech_tpu_torch.models import dual_ar

    cfg, dev, k = batcher.cfg, batcher.device, len(prompts)
    m, rows, sbucket = batcher._group_prefix([SimpleNamespace(prompt=p)
                                              for p in prompts])
    t = [p.shape[1] for p in prompts]
    entry_bucket = rows["k"].shape[2]
    bucket = (entry_bucket if m + sbucket <= entry_bucket
              else pick_bucket(m + sbucket, batcher.cache_len))
    cold_bucket = pick_bucket(max(t), batcher.cache_len)
    inp = np.zeros((k, cfg.num_codebooks + 1, cold_bucket), np.int32)
    sfx = np.zeros((k, cfg.num_codebooks + 1, sbucket), np.int32)
    for j, p in enumerate(prompts):
        inp[j, :, : t[j]] = p
        sfx[j, :, : t[j] - m] = p[:, m:]
    sfx = torch.from_numpy(sfx).to(dev)
    start = torch.tensor([m], dtype=torch.int32, device=dev)
    lengths = torch.tensor([n - m for n in t], dtype=torch.int64, device=dev)

    def fresh():
        return dual_ar.init_kv_cache(cfg, k, max(bucket, cold_bucket), batcher.dtype,
                                     dev, quant=batcher.kv_quant)

    with torch.no_grad():
        cold_cache = fresh()
        cold, _, _ = dual_ar.prefill(
            batcher.params, cfg, torch.from_numpy(inp).to(dev), cold_cache,
            torch.zeros(k, dtype=torch.int32, device=dev),
            torch.tensor(t, dtype=torch.int64, device=dev))
        cache = fresh()
        restore_prefix_rows(cache, rows)
        hit, _, _ = dual_ar.prefill_suffix(batcher.params, cfg, sfx, cache, start,
                                           lengths)
        own, _, _ = dual_ar.prefill_suffix(batcher.params, cfg, sfx, cold_cache,
                                           start, lengths)
    scale = cold.abs().amax(dim=1)
    top2 = cold.topk(2, dim=1).values
    rows_out = {  # name: (max |delta|, argmax equal, the argmax held)
        "cold": ((hit - cold).abs().amax(dim=1), hit.argmax(1) == cold.argmax(1),
                 False),
        "own rows": ((hit - own).abs().amax(dim=1), hit.argmax(1) == own.argmax(1),
                     True),
    }
    print(f"pool int8 hit group (start {m}, suffixes {[n - m for n in t]}, bucket "
          f"{bucket}), first logits per row, 0.05 x max |logit| "
          f"{[round(0.05 * c, 4) for c in scale.tolist()]}, the cold prefill's "
          f"top-two margins {[round(x, 4) for x in (top2[:, 0] - top2[:, 1]).tolist()]}")
    ok = True
    for name, (delta, same, held) in rows_out.items():
        print(f"  hit vs {name}: max |delta| {[round(d, 4) for d in delta.tolist()]}; "
              f"argmax equal {same.tolist()}{'' if held else ' (printed, not held)'}")
        ok &= bool(torch.isfinite(delta).all()) and bool(
            (delta <= 0.05 * scale.clamp(min=1.0)).all()) and (
                not held or bool(same.all()))
    if not ok:
        raise SystemExit("pool int8: the hit group's first logits left the cold "
                         "prefill's envelope")


@contextlib.contextmanager
def _counts_kept():
    """Every kernel wrapper's launch counts as they were before the block."""
    from fish_speech_tpu_torch.ops.flash_prefill import flash_suffix_attention
    from fish_speech_tpu_torch.ops.quant import mm

    wrappers = (*_kernel_wrappers(), flash_suffix_attention, mm)
    saved = [(f, {n: v for n, v in vars(f).items() if n.startswith("launches")})
             for f in wrappers]
    try:
        yield
    finally:
        for f, counts in saved:
            for n, v in counts.items():
                setattr(f, n, v)


def run_pool(dev, tokenizer, p1_step_ms):
    """Phase 8: the continuous batcher's 32-slot pool on full-width s2-pro
    and the codec, bf16 and then int8 weights with the int8 KV cache: a
    burst of 40 concurrent streamed requests through the engine (32
    admitted, 8 parked), then one of them again alone."""
    import torch

    from fish_speech_tpu_torch.config import dac_s2_pro
    from fish_speech_tpu_torch.audio.io import load_audio
    from fish_speech_tpu_torch.engine.batcher import BatcherSession
    from fish_speech_tpu_torch.generate import pick_bucket
    from fish_speech_tpu_torch.models import dual_ar
    from fish_speech_tpu_torch.models.dac.model import init_dac
    from fish_speech_tpu_torch.ops.flash_decode import (
        flash_decode_attention, flash_decode_attention_kv8)
    from fish_speech_tpu_torch.ops.flash_prefill import (flash_prefill_attention,
                                                         flash_suffix_attention)
    from fish_speech_tpu_torch.ops.int8 import int8_matmul
    from fish_speech_tpu_torch.ops.int8_ffn import int8_ffn
    from fish_speech_tpu_torch.ops.quant import quantize_dual_ar_lowmem

    t_phase = time.perf_counter()
    cfg = _s2_pro_cfg(tokenizer, 2048)
    dac_cfg = dac_s2_pro()
    frame = dac_cfg.frame_length
    # the whole codec: the int8 pool's same-reference burst encodes a clip
    codec = init_dac(1, dac_cfg, torch.float32, dev)
    refs_dir = Path(__file__).resolve().parent / "build" / "chip_smoke_refs"
    n_frames = -(-len(load_audio(refs_dir / "speaker" / "sample.wav",
                                  dac_cfg.sample_rate)) // frame)
    requests = _pool_requests()
    out = {}
    for label in ("bf16", "int8"):
        quant = label == "int8"
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        params = dual_ar.init_dual_ar(0, cfg, torch.bfloat16, dev)
        if quant:
            params = quantize_dual_ar_lowmem(params, mode="int8")
        # the int8 pool keeps the prefix cache on (the JAX server's
        # --int8 --kv-int8 defaults)
        batcher = _pool_for(params, cfg, 32, quant, 4 if quant else 0)
        cache_len = batcher.cache_len
        engine = _pool_engine(BatcherSession(batcher), tokenizer, codec, dac_cfg,
                              str(refs_dir))
        kv_bytes = sum(t.numel() * t.element_size()
                       for t in batcher.state.cache.values())
        buckets = sorted({pick_bucket(_prompt_len(tokenizer, cfg, r.text), cache_len)
                          for r in requests})
        if len(buckets) < 2:
            raise SystemExit(f"pool: the texts reach one bucket only {buckets}")
        if quant:  # the same-reference burst's prompts
            clone_len = _prompt_len(
                tokenizer, cfg, _clone_requests(1, 0)[0].text, [CLONE_TEXT],
                [np.zeros((dac_cfg.rvq.total_codebooks, n_frames), np.int32)])
            buckets = sorted({*buckets, pick_bucket(clone_len, cache_len)})
        torch.cuda.synchronize()
        print(f"pool {label} (P=32, weights {'int8' if quant else 'bf16'}, KV "
              f"{'int8' if quant else 'bf16'}, chunk 128, first chunk 8, admit "
              f"every 4): built in {time.perf_counter() - t0:.1f}s; KV pool "
              f"{kv_bytes / 2**30:.2f} GiB; device memory allocated "
              f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB")
        t0 = time.perf_counter()
        times = batcher.precompile(buckets)
        print(f"pool {label} graphs captured by precompile({buckets}) in "
              f"{time.perf_counter() - t0:.1f}s (s, each with its eager run; the "
              f"pool's growth in MiB): "
              + ", ".join(f"{k} {v:.2f} s +{batcher.pool_growth[k] / 2**20:.1f}"
                          for k, v in times.items())
              + f"; graph pool {batcher.pool_bytes / 2**20:.1f} MiB (before the "
              f"int8 kernel: {CAST_ROUTE_GRAPH_POOL_MIB[f'pool {label}']:.1f}, an "
              f"earlier run of this script)")
        precompile_codec(engine, (32, 64), (n_frames,) if quant else (),
                         f"pool {label}")
        batcher.replays.clear()
        batcher.eager_runs.clear()
        _zero_counts()
        rows, t_submit = pool_serve(engine, requests, frame, f"{label}")
        launches = {"flash_decode": flash_decode_attention.launches,
                    "flash_decode_kv8": flash_decode_attention_kv8.launches,
                    "flash_prefill": flash_prefill_attention.launches_wgmma,
                    "int8_mm": int8_matmul.launches_gemv_mma,
                    "int8_mm_cluster": int8_matmul.launches_gemv_cluster,
                    "int8_ffn": int8_ffn.launches_mma}
        stats = batcher.stats()
        frames = sum(r["frames"] for r in rows)
        wall = max(r["last"] for r in rows) - t_submit
        ttfa = [(r["first"] - r["t0"]) * 1e3 for r in rows]
        fps = [(r["frames"] - 1) / (r["last"] - r["first"]) for r in rows]
        print(f"pool {label} burst: {len(rows)} requests, {frames} frames in "
              f"{wall:.3f}s: aggregate {frames / wall:.1f} frames/s; per stream "
              f"frames/s p50 {_pct(fps, 50):.2f} min {min(fps):.2f}; TTFA ms p50 "
              f"{_pct(ttfa, 50):.1f} p90 {_pct(ttfa, 90):.1f} max {max(ttfa):.1f}; "
              f"stats {stats}; graph replays {dict(batcher.replays)}; eager body "
              f"runs {dict(batcher.eager_runs)}; kernel launches {launches}; "
              f"codec decodes {len(engine.decode_seconds)} (host s p50 "
              f"{_pct(engine.decode_seconds, 50):.4f})")
        if stats["parked_groups"] < 1:
            raise SystemExit(f"pool {label}: no group was parked")
        prefills = sum(n for k, n in batcher.replays.items() if k.startswith("prefill"))
        if batcher.eager_runs or batcher.replays["decode"] <= 0 or prefills <= 0:
            raise SystemExit(f"pool {label}: a step or prefill ran eagerly on the "
                             f"card, or a graph never replayed")
        need = ["flash_prefill"] + (["flash_decode_kv8", "int8_mm", "int8_mm_cluster",
                                     "int8_ffn"] if quant else ["flash_decode"])
        if min(launches[k] for k in need) <= 0:
            raise SystemExit(f"pool {label}: a kernel of the path was never "
                             f"launched: {launches}")
        check_codec_replayed(engine, ("decode",), f"pool {label}")
        # alone with the prefix cache off: a hit would attend the int8 keys
        # of its stored prefix where the burst's prefill attended fresh ones
        size, batcher.prefix.size = batcher.prefix.size, 0
        again, _ = pool_serve(engine, [requests[POOL_REPEAT]], frame, label)
        batcher.prefix.size = size
        same = np.array_equal(again[0]["codes"], rows[POOL_REPEAT]["codes"])
        print(f"pool {label} request {POOL_REPEAT} alone in the idle pool: TTFA "
              f"{(again[0]['first'] - again[0]['t0']) * 1e3:.1f} ms, codes "
              f"{again[0]['codes'].shape} identical to its run in the burst={same}")
        if not same:
            raise SystemExit(f"pool {label}: the repeated request gave other codes")
        per_step = batcher.launches_per_replay("decode")
        check_int8_route(per_step, f"pool {label}", required=quant)
        # int8: every FFN of both stacks (the slow step's and the fast
        # stack's per codebook column)
        check_int8_ffn(per_step, f"pool {label}",
                       cfg.n_layer + cfg.n_fast_layer * cfg.num_codebooks if quant else 0)
        step_ms = pool_step_ms(batcher)
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        print(f"pool {label} replayed step at P=32: {step_ms:.3f} ms of device time "
              f"({32e3 / step_ms:.1f} row-steps/s); launches per step {per_step}; "
              f"peak device memory {peak:.2f} GiB"
              + (f"; int8 kernel launches per step "
                 f"{per_step.get('int8_matmul.launches', 0)}, fused int8 FFN "
                 f"{per_step.get('int8_ffn.launches', 0)}, before the int8 "
                 f"kernel the step took {CAST_ROUTE_STEP_MS['pool int8']} ms (an earlier "
                 f"run of this script)" if quant else ""))
        row = dict(frames_per_s=frames / wall, fps_p50=_pct(fps, 50), fps_min=min(fps),
                   ttfa_ms=(_pct(ttfa, 50), _pct(ttfa, 90), max(ttfa)),
                   step_ms=step_ms, per_step=per_step, launches=launches,
                   kv_bytes=kv_bytes, peak_gib=peak)
        if quant:
            row["accounting"] = {"P=32": print_pool_accounting(batcher, "int8 P=32")}
            _zero_counts()
            run_clone_burst(engine, batcher, frame)
            row["launches"]["flash_suffix_kv8"] = (
                flash_suffix_attention.launches_suffix_kv8_wgmma)
            _zero_counts()
            row["server"] = run_server(engine, batcher, refs_dir, frame)
            row["launches"]["flash_suffix_kv8"] += (
                flash_suffix_attention.launches_suffix_kv8_wgmma)
        batcher.shutdown()
        del engine, batcher
        gc.collect()
        torch.cuda.empty_cache()
        # the same weights at P=8 (bf16) and P=1 (int8): the step alone
        small = 1 if quant else 8
        batcher = _pool_for(params, cfg, small, quant)
        del params
        gc.collect()
        if quant:
            batcher.precompile(buckets[:1])
        else:
            batcher._graph("decode")
        row[f"step_ms_p{small}"] = pool_step_ms(batcher)
        print(f"pool {label} replayed step at P={small}: {row[f'step_ms_p{small}']:.3f} "
              f"ms of device time"
              + (f" (phase 4's single-stream step at P=1: {p1_step_ms:.3f} ms)"
                 if not quant else f" (before the int8 kernel: "
                 f"{CAST_ROUTE_STEP_MS['pool int8 P=1']} ms, an earlier run of this "
                 f"script)"))
        if quant:
            row["accounting"]["P=1"] = print_pool_accounting(batcher, "int8 P=1")
            print(f"int8 P=1 graph pool {batcher.pool_bytes / 2**20:.1f} MiB (before "
                  f"the int8 kernel: {CAST_ROUTE_GRAPH_POOL_MIB['pool int8 P=1']:.1f}, an "
                  f"earlier run of this script)")
        batcher.shutdown()
        del batcher
        gc.collect()
        torch.cuda.empty_cache()
        out[label] = row
    print(f"phase 8 (the pool) took {time.perf_counter() - t_phase:.1f}s")
    return out


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _wav_frames(body, frame, label):
    """Whole frames of 16-bit PCM (int16: finite by construction) behind a
    valid WAV header (a streamed one's data size is left open)."""
    if body[:4] != b"RIFF" or body[8:16] != b"WAVEfmt " or body[36:40] != b"data":
        raise SystemExit(f"server {label}: not a WAV header {body[:44]!r}")
    pcm = np.frombuffer(body[44:], "<i2")
    if not len(pcm) or len(pcm) % frame:
        raise SystemExit(f"server {label}: {len(pcm)} samples are not whole "
                         f"frames of audio")
    return len(pcm) // frame


def run_server(engine, batcher, refs_dir, frame):
    """Phase 9: phase 8's int8 / int8-KV pool engine (the JAX server's
    `--int8 --kv-int8 --pool-size 32`) behind the port's HTTP app on
    127.0.0.1, after the server's `warm_up`: health, references added from
    WAV and FLAC bytes, concurrent streamed /v1/tts by reference id, a
    msgpack request, /v1/audio/speech as pcm, a client that drops its
    stream (counted cancelled, its row freed and reused), and the metrics;
    then `python -m fish_speech_tpu_torch.server.main --tiny --int8
    --no-warmup` in a process of its own answers one request."""
    import asyncio
    import os
    import urllib.request

    import aiohttp
    import msgpack
    import torch
    from aiohttp import web

    from fish_speech_tpu_torch.audio.io import read_wav
    from fish_speech_tpu_torch.audio.transcode import encode_flac
    from fish_speech_tpu_torch.config import dac_tiny
    from fish_speech_tpu_torch.server.app import create_app
    from fish_speech_tpu_torch.server.main import warm_up

    t0 = time.perf_counter()
    import shutil

    clip = (refs_dir / "speaker" / "sample.wav").read_bytes()
    for rid in ("srv-wav", "srv-flac"):  # added below through the API
        shutil.rmtree(refs_dir / rid, ignore_errors=True)
    warm_up(engine, code_buckets=(32, 64), reference_buckets=())
    eager_after_warm = dict(batcher.eager_runs)
    batcher.replays.clear()
    print(f"server: warm_up (the pool's precompile at every bucket, the codec's, "
          f"the warm requests and burst) took {time.perf_counter() - t0:.1f}s; "
          f"pool graphs {len(batcher._graphs)}")
    batcher.eager_runs.clear()
    samples, sr = read_wav(clip)
    flac = encode_flac(samples.T, sr)
    port = _free_port()
    app = create_app(engine)
    loop = asyncio.new_event_loop()
    runner = web.AppRunner(app, handler_cancellation=True)
    loop.run_until_complete(runner.setup())
    loop.run_until_complete(web.TCPSite(runner, "127.0.0.1", port).start())
    server = threading.Thread(target=loop.run_forever, daemon=True)
    server.start()
    url = f"http://127.0.0.1:{port}"
    timings = {}

    async def client():
        async with aiohttp.ClientSession() as http:
            async def post(path, **kw):
                async with http.post(url + path, **kw) as r:
                    return r.status, await r.read()

            async with http.get(url + "/v1/health") as r:
                health = (r.status, await r.json())
            added = [await post("/v1/references/add", data=msgpack.packb(
                {"id": rid, "audio": audio, "text": CLONE_TEXT}),
                headers={"Content-Type": "application/msgpack"})
                for rid, audio in (("srv-wav", clip), ("srv-flac", flac))]

            async def tts(i, rid):
                t = time.perf_counter()
                status, body = await post("/v1/tts", json={
                    "text": f"Served line {i} by reference.", "reference_id": rid,
                    "streaming": True, "max_new_tokens": 48, "seed": 400 + i})
                timings[f"tts {i}"] = time.perf_counter() - t
                return status, body

            streamed = await asyncio.gather(*(tts(i, ("srv-wav", "srv-flac")[i % 2])
                                              for i in range(4)))
            packed = await post("/v1/tts", data=msgpack.packb(
                {"text": "A msgpack request.", "max_new_tokens": 24, "format": "wav"}),
                headers={"Content-Type": "application/msgpack"})
            speech = await post("/v1/audio/speech", json={
                "input": "The OpenAI route.", "voice": "alloy",
                "response_format": "pcm", "max_new_tokens": 24})
            # a client that drops its stream after the header and a chunk
            async with http.post(url + "/v1/tts", json={
                    "text": "A stream the client leaves.", "streaming": True,
                    "max_new_tokens": 400}) as r:
                head = await r.content.readexactly(44 + 2 * frame)
                r.close()
            for _ in range(600):
                async with http.get(url + "/v1/metrics") as r:
                    metrics = await r.json()
                if metrics["cancelled"] >= 1 and not metrics["inflight"]:
                    break
                await asyncio.sleep(0.05)
            for _ in range(600):  # the worker reaps at its next boundary
                if batcher.stats()["active_slots"] == 0:
                    break
                await asyncio.sleep(0.05)
            freed = batcher.stats()
            after = await post("/v1/tts", json={"text": "The freed row again.",
                                                "streaming": True,
                                                "max_new_tokens": 24})
            async with http.get(url + "/v1/metrics") as r:
                metrics = await r.json()
            return dict(health=health, added=added, streamed=streamed,
                        packed=packed, speech=speech, head=head, freed=freed,
                        after=after, metrics=metrics)

    try:
        got = asyncio.run(client())
        api_client = run_api_client(url, frame)
    finally:
        asyncio.run_coroutine_threadsafe(runner.cleanup(), loop).result(60)
        loop.call_soon_threadsafe(loop.stop)
        server.join(timeout=30)
    failures = []
    if got["health"] != (200, {"status": "ok"}):
        failures.append(f"health {got['health']}")
    failures += [f"references/add {s} {b[:200]!r}" for s, b in got["added"] if s != 200]
    frames = []
    for name, (status, body) in [*((f"tts {i}", r) for i, r in enumerate(got["streamed"])),
                                 ("msgpack", got["packed"]), ("freed row", got["after"])]:
        if status != 200:
            failures.append(f"{name} {status} {body[:200]!r}")
        else:
            frames.append(_wav_frames(body, frame, name))
    status, pcm = got["speech"]
    if status != 200 or not len(pcm) or len(pcm) % 2:
        failures.append(f"audio/speech {status} {len(pcm)} bytes")
    m = got["metrics"]
    if got["head"][:4] != b"RIFF" or m["cancelled"] != 1 or m["errors"]:
        failures.append(f"the dropped stream: metrics {m}")
    if got["freed"]["active_slots"] != 0:
        failures.append(f"the dropped stream's row was not freed: {got['freed']}")
    print(f"server on 127.0.0.1:{port}: health {got['health']}; references added "
          f"(WAV, FLAC) {[s for s, _ in got['added']]}; 4 concurrent streamed "
          f"/v1/tts by reference id, the msgpack request and the freed row's "
          f"request: frames {frames}, host s "
          f"{ {k: round(v, 3) for k, v in timings.items()} }; /v1/audio/speech "
          f"pcm {len(pcm)} bytes; after the dropped stream: pool {got['freed']}; "
          f"metrics {m}; pool graph replays {dict(batcher.replays)}, eager body "
          f"runs after warm_up {dict(batcher.eager_runs)} (during it "
          f"{eager_after_warm}); prefix store hits {batcher.prefix.hits}")
    if batcher.eager_runs:
        failures.append(f"a pool body ran eagerly after warm_up: {dict(batcher.eager_runs)}")

    # the entry point, a process of its own on the card
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "fish_speech_tpu_torch.server.main", "--tiny",
         "--int8", "--no-warmup", "--listen", f"127.0.0.1:{port}",
         "--references-dir", str(refs_dir)],
        cwd=str(Path(__file__).resolve().parent), env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    try:
        for _ in range(1200):
            try:
                urllib.request.urlopen(f"http://127.0.0.1:{port}/v1/health",
                                       timeout=1).read()
                break
            except OSError:
                if proc.poll() is not None:
                    break
                time.sleep(0.1)
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/tts",
            data=json.dumps({"text": "hello", "max_new_tokens": 16}).encode(),
            headers={"Content-Type": "application/json"})
        body = urllib.request.urlopen(req, timeout=300).read()
        tiny_frames = _wav_frames(body, dac_tiny().frame_length, "--tiny")
    except Exception as e:  # reported with the process's log
        proc.terminate()
        err = proc.communicate(timeout=60)[1]
        raise SystemExit(f"server --tiny --int8: {e!r}; its log: {err[-3000:]}")
    finally:
        if proc.poll() is None:
            proc.terminate()
            proc.wait(timeout=60)
    print(f"server entry point (--tiny --int8 --no-warmup, on the card: JAX's "
          f"tiny model, heads 32 and 16 wide, int8 weights through the fp32 "
          f"int8 matvec and fused FFN): one /v1/tts "
          f"answered, {tiny_frames} frames, {time.perf_counter() - t0:.1f}s from "
          f"the process's start")
    if failures:
        raise SystemExit(f"server: {'; '.join(failures)}")
    torch.cuda.synchronize()
    return dict(frames=frames, metrics=m, timings=timings, api_client=api_client)


# 13(c)'s request: the API client's payload (its defaults, a seed) and the
# same payload sent directly
API_CLIENT_TEXT = "The API client's request, streamed to a file."
API_CLIENT_ARGS = dict(seed=77, max_new_tokens=40)


def run_api_client(url, frame):
    """13(c), against phase 9's server: one streamed request sent directly
    with the API client's payload, then `python -m
    fish_speech_tpu_torch.tools.api_client --streaming --play` (a process
    of its own) with the same text and seed, saving to a file: whole frames
    of audio, the same bytes as the direct request's, and `--play` with no
    audio backend on the machine ends file-only ("playback disabled")."""
    import os
    import tempfile
    import urllib.request

    import msgpack

    payload = {"text": API_CLIENT_TEXT, "references": [], "reference_id": None,
               "format": "wav", "streaming": True, "chunk_length": 200,
               "max_new_tokens": API_CLIENT_ARGS["max_new_tokens"], "top_p": 0.8,
               "temperature": 0.8, "repetition_penalty": 1.1,
               "seed": API_CLIENT_ARGS["seed"], "use_memory_cache": "off",
               "latency": "normal"}
    req = urllib.request.Request(
        url + "/v1/tts", data=msgpack.packb(payload, use_bin_type=True),
        headers={"Content-Type": "application/msgpack"})
    direct = urllib.request.urlopen(req, timeout=300).read()
    root = Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory(dir=root / "build") as tmp:
        out = Path(tmp) / "client.wav"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "fish_speech_tpu_torch.tools.api_client", "--url",
             url + "/v1/tts", "--text", API_CLIENT_TEXT, "--streaming", "--play",
             "--seed", str(API_CLIENT_ARGS["seed"]), "--max-new-tokens",
             str(API_CLIENT_ARGS["max_new_tokens"]), "-o", str(out)],
            cwd=str(root), env=dict(os.environ, PYTHONPATH=str(root)),
            capture_output=True, text=True, timeout=300)
        seconds = time.perf_counter() - t0
        body = out.read_bytes() if out.exists() else b""
    if proc.returncode != 0:
        raise SystemExit(f"phase 13(c): api_client failed ({proc.returncode}): "
                         f"{proc.stdout[-2000:]} {proc.stderr[-3000:]}")
    frames = _wav_frames(body, frame, "api_client")
    same = body == direct
    file_only = "playback disabled" in proc.stderr
    print(f"phase 13(c) api_client --streaming --play against phase 9's server: "
          f"{frames} frames ({len(body)} bytes) in {seconds:.1f}s from the process's "
          f"start; equal to the direct request's bytes {same}; file-only "
          f"{file_only} ({proc.stderr.strip().splitlines()[:1]}); {proc.stdout.strip()}")
    if not same or not file_only:
        a = np.frombuffer(body[44:], "<i2").astype(np.int32)
        b = np.frombuffer(direct[44:], "<i2").astype(np.int32)
        n = min(len(a), len(b))
        raise SystemExit(f"phase 13(c): the client's file differs from the direct "
                         f"request ({len(a)} vs {len(b)} samples, max |diff| "
                         f"{np.abs(a[:n] - b[:n]).max() if n else None}) or played "
                         f"({proc.stderr[-500:]})")
    return dict(frames=frames, seconds=seconds)


# ---------------------------------------------------------------------------
# Phase 12: multi-device on torch.distributed
# ---------------------------------------------------------------------------

PHASE12_SEED = 0
# 12(b) and 12(c) run two ranks on the one card, over gloo
PHASE12_DEVICE = "cuda:0"
# the teacher-forced semantic logits of the tp=2 ranks against the
# unsharded model, bf16 at full depth (max |difference| over the first 8
# steps, in units of that step's max |logit|): the bound this script holds.
# Measured 0.0240-0.0390, the same digits in every run (fixed inputs, a
# deterministic path). The witness is the unsharded bf16 model against the
# same weights in fp32: 0.0244-0.0464, so bf16 rounding alone at this depth
# is as large (NVIDIA H100 80GB HBM3, 700.00 W)
PHASE12_TF_BOUND = 0.05
# and the tp=2 ranks' largest distance from fp32 may exceed the unsharded
# bf16 model's by this factor at most (measured 0.97 and 1.11); a fault of
# the split moves the logits by their own size
PHASE12_WITNESS_RATIO = 1.5
# 12(b)'s streamed request: phase 4's short text, 24 new tokens (the
# first chunk of 8 and one of 16); gloo steps copy through the host
PHASE12_STREAM_TOKENS = 24


def _phase12_prompt(tokenizer, cfg, text):
    from fish_speech_tpu_torch.generate import build_base_conversation, encode_turn

    return encode_turn(build_base_conversation(None, None), text, tokenizer,
                       cfg.num_codebooks)


def _counts():
    """Every launch count of the kernel wrappers (per route too)."""
    return {f"{f.__name__}.{k}": v for f in _kernel_wrappers()
            for k, v in vars(f).items() if k.startswith("launches")}


def _recording(session):
    """Keep the last columns each `generate_stream` of `session` yielded
    (`session.last_codes`), on a leader and a follower alike."""
    orig = session.generate_stream

    def generate_stream(*args, **kw):
        for cols in orig(*args, **kw):
            session.last_codes = cols
            yield cols

    session.generate_stream = generate_stream
    session.last_codes = None


def _teacher_forced_logits(params, cfg, prompt, cols, kv_quant, dev, mesh=None):
    """The restricted head's fp32 logits of the prompt's last position and
    of each of `cols` (C+1, n) fed in turn, on `params` (a session's
    prepared tree, this rank's shard under `mesh`)."""
    import torch

    from fish_speech_tpu_torch.generate import _restricted_logits
    from fish_speech_tpu_torch.models import dual_ar
    from fish_speech_tpu_torch.parallel.mesh import use_mesh

    t = prompt.shape[1]
    with use_mesh(mesh), torch.no_grad():
        cache = dual_ar.init_kv_cache(cfg, 1, t + cols.shape[1] + 1,
                                      params["embeddings"].dtype, dev,
                                      quant=kv_quant)
        inp = torch.from_numpy(prompt[None]).to(dev)
        logits, _, _ = dual_ar.prefill(params, cfg, inp, cache,
                                       torch.zeros(1, dtype=torch.int32, device=dev), t)
        out = [_restricted_logits(cfg, logits)]
        for j in range(cols.shape[1] - 1):
            tok = torch.from_numpy(cols[:, j][None].astype(np.int32)).to(dev)
            _, slow, _ = dual_ar.decode_slow_step(params, cfg, tok, cache, t + j)
            out.append(dual_ar.semantic_head_logits(params, cfg, slow))
    return torch.cat(out).float().cpu()


def _step_errors(got, want):
    """Per step (row): max |got - want| over max |want|."""
    return ((got - want).abs().amax(dim=1) / want.abs().amax(dim=1)).tolist()


def _fp32_in_place(tree):
    """Turn every floating leaf of a parameter tree to fp32, one at a time
    (each 16-bit leaf goes as its copy comes)."""
    import torch

    for k, v in (tree.items() if isinstance(tree, dict) else enumerate(tree)):
        if isinstance(v, (dict, list)):
            _fp32_in_place(v)
        elif v.is_floating_point():
            tree[k] = v.float()
            del v
            if tree[k].is_cuda:
                torch.cuda.empty_cache()


def _phase12_tp_rank(rank, tmp):
    """12(b), one of two ranks over gloo with CUDA tensors on cuda:0."""
    import torch

    from fish_speech_tpu_torch.config import SamplingConfig, dac_s2_pro
    from fish_speech_tpu_torch.engine.tts import TTSInferenceEngine, TTSRequest
    from fish_speech_tpu_torch.generate import GenerationSession
    from fish_speech_tpu_torch.models import dual_ar
    from fish_speech_tpu_torch.models.dac.model import init_dac
    from fish_speech_tpu_torch.parallel.mesh import (init_distributed, make_mesh,
                                                     shard_params)
    from fish_speech_tpu_torch.server import multihost as mh
    from fish_speech_tpu_torch.tokenizer import build_test_tokenizer

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(PHASE12_DEVICE)
    init_distributed(f"file://{tmp}/rendezvous", 2, rank, backend="gloo", device=dev)
    mesh = make_mesh(dp=1, tp=2, device=dev)
    tokenizer = build_test_tokenizer()
    text = _requests()[0][1].text
    report = {"rank": rank}
    # fp32 at s2-pro's widths, 2 slow and 2 fast layers: greedy codes
    cfg = dataclasses.replace(_s2_pro_cfg(tokenizer, 1024), n_layer=2,
                              n_fast_layer=2).resolve()
    prompt = _phase12_prompt(tokenizer, cfg, text)
    full = dual_ar.init_dual_ar(PHASE12_SEED, cfg, torch.float32, dev)
    kw = dict(max_new_tokens=32, top_k=1)
    if rank == 0:
        s = GenerationSession(full, cfg, SamplingConfig(), dtype=torch.float32,
                              decode_chunk_size=16, first_chunk_size=8)
        report["fp32_unsharded"] = s.generate(prompt, 5, **kw).tolist()
        del s
    s = GenerationSession(shard_params(full, cfg, mesh), cfg, SamplingConfig(),
                          dtype=torch.float32, decode_chunk_size=16,
                          first_chunk_size=8, mesh=mesh)
    del full
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _zero_counts()  # the counts read only the mesh session's runs
    report["fp32_codes"] = s.generate(prompt, 5, **kw).tolist()
    report["launches_fp32"] = _counts()
    report["fp32_s"] = time.perf_counter() - t0
    report["fp32_eager_runs"] = dict(s.eager_runs)
    del s
    gc.collect()
    torch.cuda.empty_cache()
    # the full depth in bf16: one streamed request through the multi-card
    # leader and follower, the engine and codec on rank 0
    cfg = _s2_pro_cfg(tokenizer, 2048)
    prompt = _phase12_prompt(tokenizer, cfg, text)
    full = dual_ar.init_dual_ar(PHASE12_SEED, cfg, torch.bfloat16, dev)
    ref = None
    if rank == 0:
        ref = dual_ar.precompute_semantic_head(full, cfg)
        dac_cfg = dac_s2_pro()
        codec = init_dac(1, dac_cfg, torch.float32, dev)
    shard = shard_params(full, cfg, mesh)
    del full
    gc.collect()  # rank 1 keeps only its shard; the card is shared
    torch.cuda.empty_cache()
    launches, forced = {}, {}
    for kv_quant in (False, True):
        label = "int8 KV" if kv_quant else "bf16 KV"
        s = GenerationSession(shard, cfg, SamplingConfig(), dtype=torch.bfloat16,
                              decode_chunk_size=16, first_chunk_size=8,
                              kv_quant=kv_quant, mesh=mesh)
        report[label] = row = {"heads": s.cache["k"].shape[3],
                               "fast_heads": s.state.fast_cache["k"].shape[3]}
        _recording(s)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _zero_counts()
        if rank == 0:
            mh.wrap_leader(s, cfg)
            engine = TTSInferenceEngine(s, tokenizer, codec, dac_cfg)
            req = dataclasses.replace(_requests()[0][1],
                                      max_new_tokens=PHASE12_STREAM_TOKENS)
            segments = [r.audio[1] for r in engine.inference(req)
                        if r.code == "segment"]
            audio = np.concatenate(segments) if segments else np.zeros(0)
            mh.broadcast_stop(s, cfg)
            del engine  # it holds the session
            row["audio_samples"] = int(audio.size)
            row["audio_finite"] = bool(np.isfinite(audio).all())
            row["frame"] = dac_cfg.frame_length
        else:
            row["served"] = mh.follower_loop(s, cfg)
        torch.cuda.synchronize()
        for name, n in _counts().items():
            launches[name] = launches.get(name, 0) + n
        row["s"] = time.perf_counter() - t0
        cols = s.last_codes
        row["codes"] = cols.tolist()
        row["eager_runs"] = dict(s.eager_runs)
        tf = _teacher_forced_logits(s.params, cfg, prompt, cols[:, :8], kv_quant,
                                    dev, mesh)
        del s
        gc.collect()
        torch.cuda.empty_cache()
        if rank == 0:
            want = _teacher_forced_logits(ref, cfg, prompt, cols[:, :8], kv_quant,
                                          dev)
            row["tf_err"] = _step_errors(tf, want)
            forced[label] = (cols[:, :8], tf, want)
    report["launches"] = launches
    del shard  # the card is shared: only rank 0's witness follows
    gc.collect()
    torch.cuda.empty_cache()
    if rank == 0:
        # the witness: the same weights in fp32 (fp32 cache, no int8): the
        # unsharded bf16 model's distance from it is what bf16 rounding
        # alone does at this depth
        del codec
        gc.collect()
        torch.cuda.empty_cache()
        report["free_gib_before_witness"] = torch.cuda.mem_get_info(dev)[0] / 2**30
        _fp32_in_place(ref)
        for label, (cols, tf, want) in forced.items():
            exact = _teacher_forced_logits(ref, cfg, prompt, cols, False, dev)
            report[label]["unsharded_vs_fp32"] = _step_errors(want, exact)
            report[label]["tp_vs_fp32"] = _step_errors(tf, exact)
    (Path(tmp) / f"tp_{rank}.json").write_text(json.dumps(report))
    mesh.barrier()
    torch.distributed.destroy_process_group()


def _phase12_dp_batches(cfg):
    rng = np.random.default_rng(7)
    return [_numpy_batch(cfg, rng, 2, 256, [0, 40]) for _ in range(3)]


def _phase12_train(cfg, dev, mesh, zero1, out_dir):
    """3 LoRA steps (r 8, alpha 16) of fp32 s2-pro widths at 2 + 2 layers:
    (metrics, AdamW m/v bytes on this rank)."""
    import torch

    from fish_speech_tpu_torch.models import dual_ar
    from fish_speech_tpu_torch.models.lora import LoraConfig
    from fish_speech_tpu_torch.train.trainer import TrainConfig, Trainer

    tcfg = TrainConfig(output_dir=str(out_dir), project="p12", max_steps=3,
                       batch_size=2, max_length=256, lr=1e-3, warmup_steps=1,
                       precision="float32", dp=mesh.dp.size if mesh else None,
                       zero1=zero1, lora=LoraConfig(r=8, lora_alpha=16.0))
    params = dual_ar.init_dual_ar(PHASE12_SEED, cfg, torch.float32, dev)
    trainer = Trainer(cfg, tcfg, params=params, device=dev, mesh=mesh)
    metrics = [{k: float(v) for k, v in trainer.train_step(
        trainer.params, trainer._place_batch(b)).items()}
        for b in _phase12_dp_batches(cfg)]
    opt_bytes = sum(t.numel() * t.element_size()
                    for st in trainer.optimizer.adamw.state.values()
                    for k, t in st.items() if k != "step")
    return metrics, opt_bytes


def _phase12_dp_cfg(tokenizer):
    return dataclasses.replace(_s2_pro_cfg(tokenizer, 256), n_layer=2,
                               n_fast_layer=2).resolve()


def _phase12_dp_rank(rank, tmp):
    """12(c), one of two dp ranks over gloo with CUDA tensors on cuda:0."""
    import torch

    from fish_speech_tpu_torch.parallel.mesh import init_distributed, make_mesh
    from fish_speech_tpu_torch.tokenizer import build_test_tokenizer

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(PHASE12_DEVICE)
    init_distributed(f"file://{tmp}/rendezvous", 2, rank, backend="gloo", device=dev)
    mesh = make_mesh(dp=2, tp=1, device=dev)
    cfg = _phase12_dp_cfg(build_test_tokenizer())
    _zero_counts()
    report = {"rank": rank}
    for zero1 in (False, True):
        t0 = time.perf_counter()
        metrics, opt_bytes = _phase12_train(cfg, dev, mesh, zero1,
                                            Path(tmp) / f"out_{rank}")
        report["zero1" if zero1 else "dp"] = {
            "metrics": metrics, "opt_bytes": opt_bytes,
            "s": time.perf_counter() - t0}
        gc.collect()
        torch.cuda.empty_cache()
    report["launches"] = _counts()
    (Path(tmp) / f"dp_{rank}.json").write_text(json.dumps(report))
    mesh.barrier()
    torch.distributed.destroy_process_group()


def _phase12_nccl_rank(rank, tmp):
    """12(d), one of two ranks over nccl on cuda:{rank}: tp=2 serving with
    the collectives captured in the session's graphs; decode frames/s. Each
    stage is printed as it starts (a rank that stops shows where)."""
    import torch

    from fish_speech_tpu_torch.config import SamplingConfig
    from fish_speech_tpu_torch.generate import GenerationSession
    from fish_speech_tpu_torch.models import dual_ar
    from fish_speech_tpu_torch.parallel.mesh import (init_distributed, make_mesh,
                                                     shard_params)
    from fish_speech_tpu_torch.tokenizer import build_test_tokenizer

    t0 = time.perf_counter()

    def stage(what):
        print(f"rank {rank} +{time.perf_counter() - t0:.1f}s: {what}", flush=True)

    dev = torch.device(f"cuda:{rank}")
    stage("init_distributed")
    init_distributed(f"file://{tmp}/rendezvous", 2, rank, backend="nccl", device=dev)
    stage("make_mesh")
    mesh = make_mesh(dp=1, tp=2, device=dev)
    tokenizer = build_test_tokenizer()
    cfg = _s2_pro_cfg(tokenizer, 2048)
    stage("init_dual_ar")
    full = dual_ar.init_dual_ar(PHASE12_SEED, cfg, torch.bfloat16, dev)
    stage("session")
    s = GenerationSession(shard_params(full, cfg, mesh), cfg, SamplingConfig(),
                          dtype=torch.bfloat16, decode_chunk_size=64,
                          first_chunk_size=8, mesh=mesh)
    del full
    prompt = _phase12_prompt(tokenizer, cfg, _requests()[0][1].text)
    stage(f"precompile (collectives so far {mesh.tp.calls})")
    s.precompile(prompt.shape[1], 72, 8)
    stage(f"generate (collectives so far {mesh.tp.calls})")
    codes = s.generate(prompt, 11, max_new_tokens=72)
    stage("replayed step")
    step_ms = replayed_step_ms(s)
    report = {"rank": rank, "codes": codes.tolist(), "step_ms": step_ms,
              "replays": dict(s.replays), "eager_runs": dict(s.eager_runs)}
    (Path(tmp) / f"nccl_{rank}.json").write_text(json.dumps(report))
    del s
    gc.collect()
    stage("barrier")
    mesh.barrier()
    torch.distributed.destroy_process_group()


PHASE12_RANKS = {"tp": _phase12_tp_rank, "dp": _phase12_dp_rank,
                 "nccl": _phase12_nccl_rank}


def _spawn_phase12(kind, tmp, timeout):
    """Run `kind`'s two ranks as processes of this script; kill both if one
    fails or the time runs out (a rank left waiting on a failed one would
    wait for the process group's timeout); returns their reports."""
    import os

    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root))
    logs = [open(Path(tmp) / f"{kind}_{r}.log", "w") for r in range(2)]
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                               "--phase12-rank", kind, str(r), str(tmp)],
                              cwd=str(root), env=env, stdout=logs[r],
                              stderr=subprocess.STDOUT) for r in range(2)]
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    if any(p.returncode != 0 for p in procs):
        raise SystemExit(f"phase 12 {kind} ranks failed:\n" + "\n".join(
            f"--- rank {r} (exit {p.returncode}) ---\n"
            + (Path(tmp) / f"{kind}_{r}.log").read_text()[-4000:]
            for r, p in enumerate(procs)))
    return [json.loads((Path(tmp) / f"{kind}_{r}.json").read_text())
            for r in range(2)]


def _phase12_nccl_world1(dev, tokenizer):
    """12(a): full s2-pro in bf16 on a (1, 1) mesh over nccl in this
    process: the mesh session's graphs hold the collectives; phase 4's
    first two requests give the unsharded session's codes bit for bit."""
    import torch
    import torch.distributed as dist

    from fish_speech_tpu_torch.config import SamplingConfig
    from fish_speech_tpu_torch.generate import GenerationSession
    from fish_speech_tpu_torch.models import dual_ar
    from fish_speech_tpu_torch.parallel.mesh import (init_distributed, make_mesh,
                                                     shard_params)

    init_distributed(f"tcp://127.0.0.1:{_free_port()}", 1, 0, backend="nccl",
                     device=dev)
    try:
        mesh = make_mesh(dp=1, tp=1, device=dev)
        cfg = _s2_pro_cfg(tokenizer, 2048)
        params = dual_ar.init_dual_ar(PHASE12_SEED, cfg, torch.bfloat16, dev)
        kw = dict(dtype=torch.bfloat16, decode_chunk_size=64, first_chunk_size=8)
        plain = GenerationSession(params, cfg, SamplingConfig(), **kw)
        meshed = GenerationSession(shard_params(params, cfg, mesh), cfg,
                                   SamplingConfig(), mesh=mesh, **kw)
        del params
        calls = mesh.tp.calls
        requests = _requests()[:2]
        for s in (plain, meshed):
            precompile_for(s, tokenizer, requests, "12(a)")
        captured = mesh.tp.calls - calls
        prompts = [(_phase12_prompt(tokenizer, cfg, req.text), req)
                   for _, req in requests]
        want = [plain.generate(p, r.seed, max_new_tokens=r.max_new_tokens)
                for p, r in prompts]
        _zero_counts()  # the launches of the mesh session's requests alone
        got = [meshed.generate(p, r.seed, max_new_tokens=r.max_new_tokens)
               for p, r in prompts]
        launches = _counts()
        same = [bool(np.array_equal(g, w)) and g.shape[1] > 1
                for g, w in zip(got, want)]
        per_step = check_replayed(meshed, "12(a) mesh session")
        ms = {name: replayed_step_ms(s) for name, s in (("unsharded", plain),
                                                        ("mesh", meshed))}
        print(f"phase 12(a): nccl world size 1, full s2-pro bf16: {captured} "
              f"collectives recorded by the captures (their eager runs "
              f"included), codes equal to the unsharded session's bit for "
              f"bit: {same}; replayed decode step {ms['mesh']:.3f} ms (mesh) "
              f"vs {ms['unsharded']:.3f} ms (unsharded) of device time; "
              f"launches per replayed step {per_step}")
        if not all(same) or captured <= 0:
            raise SystemExit("phase 12(a): the mesh session's graphs disagree "
                             "with the unsharded session, or captured no "
                             "collective")
        del plain, meshed
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    return launches, ms


def _phase12_reference_train(dev, tokenizer, tmp):
    """12(c)'s reference: one process, no mesh, the global batches."""
    metrics, opt_bytes = _phase12_train(_phase12_dp_cfg(tokenizer), dev, None,
                                        False, Path(tmp) / "out_ref")
    return metrics, opt_bytes


def run_multidevice(dev, tokenizer):
    """Phase 12: the mesh on torch.distributed. Returns the local-head
    kernel cases and the launches of the kernels on the paths of this
    process (12(a)) and of the tp ranks (12(b), rank 0)."""
    import tempfile

    import torch

    t_phase = time.perf_counter()
    launches_a, step_ms = _phase12_nccl_world1(dev, tokenizer)
    # the ranks of 12(b) and 12(c) share the card with this process
    print(f"phase 12: this process holds {torch.cuda.memory_allocated(dev) / 2**30:.2f} "
          f"GiB allocated, {torch.cuda.memory_reserved(dev) / 2**30:.2f} GiB "
          f"reserved before the ranks start")
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_p12_", dir=build) as tmp:
        t0 = time.perf_counter()
        tp = _spawn_phase12("tp", tmp, 600)
        for r in tp:
            print(f"phase 12(b) rank {r['rank']}: fp32 2+2 layers "
                  f"{r['fp32_s']:.1f}s eager runs {r['fp32_eager_runs']}; "
                  + "; ".join(f"{lab}: heads {r[lab]['heads']} fast heads "
                              f"{r[lab]['fast_heads']}, {len(r[lab]['codes'][0])} "
                              f"columns in {r[lab]['s']:.1f}s, eager runs "
                              f"{r[lab]['eager_runs']}"
                              for lab in ("bf16 KV", "int8 KV")))
        ok = tp[0]["fp32_codes"] == tp[0]["fp32_unsharded"] == tp[1]["fp32_codes"]
        print(f"phase 12(b): tp=2 over gloo, fp32 s2-pro widths 2+2 layers: "
              f"greedy codes equal to the unsharded session's on both ranks: {ok}")
        bad = not ok
        for lab in ("bf16 KV", "int8 KV"):
            r0, r1 = tp[0][lab], tp[1][lab]
            whole = r0["audio_samples"] % r0["frame"] == 0 and r0["audio_samples"] > 0
            same = r0["codes"] == r1["codes"]
            tf = max(r0["tf_err"])
            ratio = max(r0["tp_vs_fp32"]) / max(r0["unsharded_vs_fp32"])
            print(f"phase 12(b) full depth bf16, {lab}: {r0['audio_samples']} audio "
                  f"samples (whole frames {whole}, finite {r0['audio_finite']}), "
                  f"rank 0's codes equal to rank 1's: {same}, follower served "
                  f"{r1['served']}; teacher-forced semantic logits of the first 8 "
                  f"steps, max |diff| / max |logit| per step: tp=2 vs the "
                  f"unsharded model {r0['tf_err']} (bound {PHASE12_TF_BOUND}); "
                  f"witness, the unsharded bf16 model vs the same weights in "
                  f"fp32 {r0['unsharded_vs_fp32']}; tp=2 vs fp32 "
                  f"{r0['tp_vs_fp32']}, the largest {ratio:.3f} times the "
                  f"witness's (bound {PHASE12_WITNESS_RATIO})")
            bad |= not (whole and r0["audio_finite"] and same and r1["served"] >= 1
                        and tf <= PHASE12_TF_BOUND
                        and ratio <= PHASE12_WITNESS_RATIO)
        print(f"phase 12(b): the card had {tp[0]['free_gib_before_witness']:.1f} GiB "
              f"free before rank 0 made the fp32 witness")
        print(f"phase 12(b) took {time.perf_counter() - t0:.1f}s (gloo: correctness "
              f"runs; their rates are not a speed of the port)")
        if bad:
            raise SystemExit("phase 12(b): tp=2 serving disagrees")
        t0 = time.perf_counter()
        want, ref_bytes = _phase12_reference_train(dev, tokenizer, tmp)
        gc.collect()
        torch.cuda.empty_cache()
        dp = _spawn_phase12("dp", tmp, 600)
        bad = False
        for r in dp:
            for kind in ("dp", "zero1"):
                got = r[kind]["metrics"]
                dl = max(abs(g["loss"] - w["loss"]) for g, w in zip(got, want))
                dg = max(abs(g["grad_norm"] - w["grad_norm"]) for g, w in zip(got, want))
                print(f"phase 12(c) rank {r['rank']} {kind}: losses "
                      f"{[g['loss'] for g in got]} vs one process "
                      f"{[w['loss'] for w in want]}: max |diff| loss {dl:.2e}, "
                      f"grad_norm {dg:.2e}; AdamW m/v {r[kind]['opt_bytes']} bytes "
                      f"(one process {ref_bytes}); {r[kind]['s']:.1f}s")
                bad |= dl > 2e-5 or dg > 2e-4
            bad |= not (r["zero1"]["opt_bytes"] * 2 <= ref_bytes
                        <= r["dp"]["opt_bytes"])
        print(f"phase 12(c) took {time.perf_counter() - t0:.1f}s")
        if bad:
            raise SystemExit("phase 12(c): dp training disagrees with one process, "
                             "or ZeRO-1 keeps more than half of AdamW's state")
        if torch.cuda.device_count() >= 2:
            nccl = _spawn_phase12("nccl", tmp, 600)
            ms = max(r["step_ms"] for r in nccl)
            print(f"phase 12(d): tp=2 over nccl on cuda:0 and cuda:1, graphs: "
                  f"replayed decode step {ms:.3f} ms ({1e3 / ms:.1f} frames/s); "
                  f"codes equal on both ranks {nccl[0]['codes'] == nccl[1]['codes']}; "
                  f"replays {nccl[0]['replays']}, eager runs {nccl[0]['eager_runs']}")
            if nccl[0]["codes"] != nccl[1]["codes"] or nccl[0]["eager_runs"].get(
                    "decode", 0) != 1:
                raise SystemExit("phase 12(d): the ranks disagree")
        else:
            print(f"phase 12(d) did not run: {torch.cuda.device_count()} card; "
                  f"tp over nccl needs two (nccl refuses two ranks on one card)")
    cases = local_head_cases(dev)
    # each count is read around the mesh runs alone: 12(a)'s mesh session,
    # 12(b) rank 0's fp32 mesh session and its two streamed requests, 12(c)
    # rank 0's mesh trainers
    paths = {"12(a)": launches_a, "12(b) fp32": tp[0]["launches_fp32"],
             "12(b) bf16": tp[0]["launches"], "12(c)": dp[0]["launches"]}
    need = (("12(a)", "flash_prefill", "flash_prefill_attention.launches_wgmma"),
            ("12(a)", "flash_decode", "flash_decode_attention.launches"),
            ("12(b) fp32", "flash_prefill_fp32",
             "flash_prefill_attention.launches_fp32_tc"),
            ("12(b) fp32", "flash_decode_fp32", "flash_decode_attention.launches"),
            ("12(b) bf16", "flash_prefill", "flash_prefill_attention.launches_wgmma"),
            ("12(b) bf16", "flash_decode", "flash_decode_attention.launches"),
            ("12(b) bf16", "flash_decode_kv8", "flash_decode_attention_kv8.launches"),
            ("12(c)", "flash_train_fwd_fp32", "flash_train_forward.launches_fp32_tc"),
            ("12(c)", "flash_train_bwd_fp32", "flash_train_backward.launches_fp32_tc"))
    launches, missing = {}, []
    for path, name, counter in need:
        n = paths[path].get(counter, 0)
        launches[name] = launches.get(name, 0) + n
        if n <= 0:
            missing.append(f"{name} in {path}")
    print(f"phase 12 launches of the mesh runs: {launches}; phase 12 took "
          f"{time.perf_counter() - t_phase:.1f}s")
    if missing:
        raise SystemExit(f"phase 12: a kernel of a mesh path never launched: {missing}")
    return cases, launches


# s2-pro's heads on one tp rank (D = 128): the slow stack's (H, Hkv) at
# tp=2 and tp=4, and the fast stack's
PHASE12_SLOW_HEADS = {2: (16, 4), 4: (8, 2)}
PHASE12_FAST_HEADS = {2: (6, 2), 4: (3, 1)}


def _print_case(name, r):
    print(f"kernel {name} [{r['shape']}]: max_abs_err={r['max_abs_err']:.3e} "
          f"mean_abs_err={r['mean_abs_err']:.3e} kernel_ms={r['ms']:.4f} "
          f"plain_ms={r['plain_ms']:.4f} bound={_ms_text(r['bound_ms'])} "
          f"({r['bound_by']}) library_ms={r['library_ms']:.4f}")
    if not r["ok"]:
        raise SystemExit(f"{name} disagrees with its plain version at {r['shape']}")


def local_head_cases(dev):
    """Phase 12: the attention kernels at the heads of one tp rank against
    their plain versions, bf16 (the tensor-core routes; bounds as phase
    2's): the prefill and the suffix (bf16 and int8 cache), the decode
    of both stacks, the int8-KV decode and the training forward and
    backward, timed in turns beside SDPA."""
    import torch
    import torch.nn.functional as F

    from fish_speech_tpu_torch.models.dual_ar import _kv_dequant, _kv_quant
    from fish_speech_tpu_torch.ops.flash_decode import (
        flash_decode_attention, flash_decode_attention_kv8,
        flash_decode_kv8_reference, flash_decode_reference)
    from fish_speech_tpu_torch.ops.flash_prefill import (
        flash_prefill_attention, flash_prefill_reference, flash_suffix_attention,
        flash_suffix_reference)
    from fish_speech_tpu_torch.ops.flash_train import (
        flash_train_backward, flash_train_backward_reference, flash_train_forward,
        flash_train_forward_reference)

    gen = torch.Generator(device=dev).manual_seed(12)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)

    cases = {n: [] for n in ("flash_prefill", "flash_suffix", "flash_suffix_kv8",
                             "flash_decode", "flash_decode_kv8", "flash_train_fwd",
                             "flash_train_bwd")}
    for tp, (h, hkv) in PHASE12_SLOW_HEADS.items():
        heads = f"tp={tp} rank: H={h} Hkv={hkv}"
        # the prefill at the long request's bucket
        t = 1024
        q, k, v = randn(1, t, h, 128), randn(1, t, hkv, 128), randn(1, t, hkv, 128)
        off = torch.zeros(1, dtype=torch.int32, device=dev)
        mx, mean = _errors(flash_prefill_attention(q, k, v, off),
                           flash_prefill_reference(q, k, v, off))
        ms, plain_ms = _in_turns(lambda i=0: flash_prefill_reference(q, k, v, off),
                                 lambda i=0: flash_prefill_attention(q, k, v, off), 20)
        flops = 4 * h * 128 * t * (t + 1) // 2
        bound = _bound(flops, 2 * t * 128 * 2 * (h + hkv))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        cases["flash_prefill"].append(dict(
            shape=f"{heads} B=1 T={t} D=128 bf16 wgmma (SDPA is_causal)",
            max_abs_err=mx, mean_abs_err=mean, ms=ms, plain_ms=plain_ms,
            bound_ms=bound[0], bound_by=bound[1],
            library_ms=_library_ms(lambda i=0: _sdpa(qt, kt, vt, None, True), 20),
            ok=mx <= 2e-2 and mean <= 2e-3))
        # a prefix hit's suffix over the session's cache, start 951, Ts 64
        for kv8 in (False, True):
            n_layer, s, start, ts = 8, SUFFIX_S, SUFFIX_START, 64
            cache = _suffix_cache(dev, randn, n_layer, 1, s, hkv, 128, kv8,
                                  torch.bfloat16)
            qs = randn(1, ts, h, 128)
            st = torch.tensor([start], dtype=torch.int32, device=dev)
            mx, mean = _errors(flash_suffix_attention(qs, cache, 1, st),
                               flash_suffix_reference(qs, cache, 1, st))
            ms, plain_ms = _in_turns(
                lambda i=0: flash_suffix_reference(qs, cache, i % n_layer, st),
                lambda i=0: flash_suffix_attention(qs, cache, i % n_layer, st), 20)
            kv = start + ts
            flops = 4 * 128 * h * (ts * start + ts * (ts + 1) // 2)
            nbytes = (2 * qs.numel() * 2 + kv * hkv * 128 * (1 if kv8 else 2) * 2
                      + (kv * hkv * 2 * 2 if kv8 else 0))
            bound = _bound(flops, nbytes)
            i_, j_ = torch.arange(ts, device=dev), torch.arange(kv, device=dev)
            mask = (j_[None, :] <= start + i_[:, None])[None, None]
            if kv8:
                kl = [_kv_dequant(cache["k"][i, :, :kv], cache["ks"][i, :, :kv],
                                  torch.bfloat16).transpose(1, 2) for i in range(n_layer)]
                vl = [_kv_dequant(cache["v"][i, :, :kv], cache["vs"][i, :, :kv],
                                  torch.bfloat16).transpose(1, 2) for i in range(n_layer)]
            else:
                kl = [cache["k"][i, :, :kv].transpose(1, 2) for i in range(n_layer)]
                vl = [cache["v"][i, :, :kv].transpose(1, 2) for i in range(n_layer)]
            qst = qs.transpose(1, 2)
            cases["flash_suffix_kv8" if kv8 else "flash_suffix"].append(dict(
                shape=f"{heads} L={n_layer} B=1 S={s} D=128 start={start} Ts={ts} "
                      f"{'int8' if kv8 else 'bf16'} cache (SDPA mask)",
                max_abs_err=mx, mean_abs_err=mean, ms=ms, plain_ms=plain_ms,
                bound_ms=bound[0], bound_by=bound[1],
                library_ms=_library_ms(lambda i=0: F.scaled_dot_product_attention(
                    qst, kl[i % n_layer], vl[i % n_layer], attn_mask=mask,
                    enable_gqa=True), 20),
                ok=mx <= 2e-2 and mean <= 2e-3))
            del cache, kl, vl
        # the decode over the slow cache (36 layers, len 2000) and the
        # int8 one
        n_layer, s, length, g = 36, 2112, 2000, h // hkv
        qd = randn(1, hkv, g, 128)
        lens = torch.tensor([length], dtype=torch.int32, device=dev)
        for kv8 in (False, True):
            if kv8:
                kq, ks = _kv_quant(randn(n_layer, 1, s, hkv, 128))
                vq, vs = _kv_quant(randn(n_layer, 1, s, hkv, 128))

                def kernel(i=0):
                    return flash_decode_attention_kv8(qd, kq, ks, vq, vs, i % n_layer,
                                                      lens)

                def plain(i=0):
                    return flash_decode_kv8_reference(qd, kq, ks, vq, vs, i % n_layer,
                                                      lens)

                kd = _kv_dequant(kq[:, :, :length], ks[:, :, :length], torch.bfloat16)
                vd = _kv_dequant(vq[:, :, :length], vs[:, :, :length], torch.bfloat16)
                nbytes = 2 * length * hkv * 128 + 2 * 2 * length * hkv + 4 * hkv * g * 128
            else:
                kc, vc = randn(n_layer, 1, s, hkv, 128), randn(n_layer, 1, s, hkv, 128)

                def kernel(i=0):
                    return flash_decode_attention(qd, kc, vc, i % n_layer, lens)

                def plain(i=0):
                    return flash_decode_reference(qd, kc, vc, i % n_layer, lens)

                kd, vd = kc[:, :, :length], vc[:, :, :length]
                nbytes = 2 * (2 * length * hkv * 128 + 2 * hkv * g * 128)
            mx, mean = _errors(kernel(0), plain(0))
            ms, plain_ms = _in_turns(plain, kernel, 100)
            bound = _bound(4 * hkv * g * 128 * length, nbytes)
            qs = qd.reshape(1, hkv * g, 1, 128)
            cases["flash_decode_kv8" if kv8 else "flash_decode"].append(dict(
                shape=f"{heads} L={n_layer} B=1 S={s} G={g} D=128 len={length} "
                      f"{'int8' if kv8 else 'bf16'} K/V",
                max_abs_err=mx, mean_abs_err=mean, ms=ms, plain_ms=plain_ms,
                bound_ms=bound[0], bound_by=bound[1],
                library_ms=_time_ms(lambda i=0: F.scaled_dot_product_attention(
                    qs, kd[i % n_layer].transpose(1, 2), vd[i % n_layer].transpose(1, 2),
                    enable_gqa=True), 100),
                ok=mx <= 2e-2 and mean <= 2e-3))
            del kd, vd
        # the training forward and backward at the fine-tune shape
        b, t, pads = 2, 1024, [0, 100]
        q, k, v = randn(b, t, h, 128), randn(b, t, hkv, 128), randn(b, t, hkv, 128)
        kvalid = torch.ones((b, t), dtype=torch.int32, device=dev)
        kvalid[1, -100:] = 0
        do = randn(b, t, h, 128) * kvalid[:, :, None, None].to(torch.bfloat16)
        pairs = sum((t - n) * (t - n + 1) // 2 + n * (t - n) for n in pads)
        o, lse = flash_train_forward(q, k, v, kvalid)
        want_o, want_lse = flash_train_forward_reference(q, k, v, kvalid)
        e_o, e_lse = _errors(o, want_o), _errors(lse, want_lse)
        ms, plain_ms = _in_turns(lambda i=0: flash_train_forward_reference(q, k, v, kvalid),
                                 lambda i=0: flash_train_forward(q, k, v, kvalid), 10)
        i = torch.arange(t, device=dev)
        mask = ((i[None, :] <= i[:, None])[None] & kvalid[:, None, :].bool())[:, None]
        qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
        lib_fwd = _library_ms(lambda i=0: _sdpa(qt, kt, vt, mask, False), 10)
        bound = _bound(4 * h * 128 * pairs, 2 * 2 * b * t * 128 * (h + hkv) + 4 * b * h * t)
        cases["flash_train_fwd"].append(dict(
            shape=f"{heads} B={b} T={t} D=128 right_pad={pads} bf16 wgmma (SDPA mask)",
            max_abs_err=max(e_o[0], e_lse[0]), mean_abs_err=max(e_o[1], e_lse[1]),
            ms=ms, plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1],
            library_ms=lib_fwd,
            ok=_within_bf16_step(o, want_o) and e_o[1] <= 2e-3 and e_lse[0] <= 1e-4))
        args = (q, k, v, kvalid, want_o, want_lse, do)
        got, want = flash_train_backward(*args), flash_train_backward_reference(*args)
        ok, errs = True, []
        for g_, w_ in zip(got, want):
            e = _errors(g_, w_)
            errs.append(e)
            ref = w_.float().abs()
            ok &= (bool(torch.isfinite(g_.float()).all())
                   and e[0] <= 2e-2 * ref.max().item() and e[1] <= 1e-2 * ref.mean().item())
        ms, plain_ms = _in_turns(lambda i=0: flash_train_backward_reference(*args),
                                 lambda i=0: flash_train_backward(*args), 5)

        def sdpa_fwd_bwd(i=0):
            leaves = [x.detach().requires_grad_(True) for x in (qt, kt, vt)]
            return torch.autograd.grad(_sdpa(*leaves, mask, False), leaves, dot)

        bound = _bound(10 * h * 128 * pairs,
                       2 * b * t * 128 * (4 * h + 4 * hkv) + 4 * b * h * t + 4 * b * t)
        cases["flash_train_bwd"].append(dict(
            shape=f"{heads} B={b} T={t} D=128 right_pad={pads} bf16 wgmma "
                  f"(SDPA forward+backward minus forward, mask)",
            max_abs_err=max(e[0] for e in errs), mean_abs_err=max(e[1] for e in errs),
            ms=ms, plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1],
            library_ms=_library_ms(sdpa_fwd_bwd, 5) - lib_fwd, ok=ok))
        del q, k, v, do, o, lse, want_o, want_lse, got, want, args
    # the fast stack's decode at a rank's heads (12 layers, S = 10 codebooks)
    for tp, (h, hkv) in PHASE12_FAST_HEADS.items():
        n_layer, s, g = 12, 10, h // hkv
        qd = randn(1, hkv, g, 128)
        kc, vc = randn(n_layer, 1, s, hkv, 128), randn(n_layer, 1, s, hkv, 128)
        lens = torch.tensor([s], dtype=torch.int32, device=dev)
        mx, mean = _errors(flash_decode_attention(qd, kc, vc, 0, lens),
                           flash_decode_reference(qd, kc, vc, 0, lens))
        ms, plain_ms = _in_turns(
            lambda i=0: flash_decode_reference(qd, kc, vc, i % n_layer, lens),
            lambda i=0: flash_decode_attention(qd, kc, vc, i % n_layer, lens), 100)
        qs = qd.reshape(1, hkv * g, 1, 128)
        bound = _bound(4 * hkv * g * 128 * s, 2 * (2 * s * hkv * 128 + 2 * hkv * g * 128))
        cases["flash_decode"].append(dict(
            shape=f"tp={tp} rank, fast stack: Hkv={hkv} G={g} L={n_layer} B=1 S={s} "
                  f"D=128 len={s} bf16 K/V",
            max_abs_err=mx, mean_abs_err=mean, ms=ms, plain_ms=plain_ms,
            bound_ms=bound[0], bound_by=bound[1],
            library_ms=_time_ms(lambda i=0: F.scaled_dot_product_attention(
                qs, kc[i % n_layer].transpose(1, 2), vc[i % n_layer].transpose(1, 2),
                enable_gqa=True), 100),
            ok=mx <= 2e-2 and mean <= 2e-3))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    for name, rows in cases.items():
        for r in rows:
            _print_case(name, r)
    return cases


# ---------------------------------------------------------------------------
# Phase 13: the evaluation tools, the codec's training round trip, libav
# input and the FLOPs accounting
# ---------------------------------------------------------------------------

# the harness's manifest: two English items, one Chinese, one with a seeded
# reference clip, and a second item by that clip (listed last, so that under
# one worker the prefix-cache config serves it as a hit of the first)
EVAL_REF_SECONDS = 5.0
EVAL_TOKENS = 32
# the wrappers' launch counts that each harness config must show above 0:
# (the counter, the `kernels` line's name it adds to)
EVAL_COUNTERS = {
    "prefill": ("flash_prefill_attention", "launches_wgmma", "flash_prefill"),
    "decode": ("flash_decode_attention", "launches", "flash_decode"),
    "suffix": ("flash_suffix_attention", "launches_suffix_wgmma", "flash_suffix"),
    "decode_kv8": ("flash_decode_attention_kv8", "launches", "flash_decode_kv8"),
    # 8 slots: every int8 product takes the 1-16-row kernel
    "int8_mm": ("int8_matmul", "launches_gemv_mma", "int8_mm"),
    "int8_ffn": ("int8_ffn", "launches_mma", "int8_ffn"),
}


def _eval_counts():
    from fish_speech_tpu_torch.ops.flash_prefill import flash_suffix_attention

    wrappers = {f.__name__: f for f in (*_kernel_wrappers(), flash_suffix_attention)}
    return {key: getattr(wrappers[name], attr)
            for key, (name, attr, _) in EVAL_COUNTERS.items()}


def _eval_manifest(root):
    ref = root / "speaker.wav"
    _reference_clip(ref, seconds=EVAL_REF_SECONDS, seed=23)
    items = [
        {"id": "en_ref", "text": "The first line spoken in the reference voice.",
         "lang": "en", "ref_audio": str(ref), "ref_text": CLONE_TEXT},
        {"id": "en_1", "text": "Hello, this is a quality check.", "lang": "en"},
        {"id": "zh_1", "text": "今天天气很好。", "lang": "zh"},
        {"id": "en_clone", "text": "A second line in the same voice.", "lang": "en",
         "ref_audio": str(ref), "ref_text": CLONE_TEXT},
    ]
    path = root / "manifest.jsonl"
    path.write_text("\n".join(json.dumps(i, ensure_ascii=False) for i in items),
                    encoding="utf-8")
    return path


def run_eval_quality(ckpt, root, frame):
    """13(a): `tools.eval_quality` in this process on the checkpoint: the
    pool of 8 slots, both A/Bs, mock ASR, the spectral SIM, 32 new tokens;
    first bf16 under one worker (the prefix-cache config's second clone is
    a hit), then `--int8` with the pool's 8 items in flight. Each config's
    launch counts are read around its synthesis. Returns {run: {config:
    counts}}."""
    import torch

    from fish_speech_tpu_torch.tools import eval_quality

    manifest = _eval_manifest(root)
    synthesize = eval_quality.synthesize_manifest
    counts = {}

    def counted(engine, items, out_dir, tag, *args, **kw):
        _zero_counts()
        t0 = time.perf_counter()
        out = synthesize(engine, items, out_dir, tag, *args, **kw)
        torch.cuda.synchronize()
        counts[tag] = dict(_eval_counts(), seconds=round(time.perf_counter() - t0, 2),
                           prefix_hits=engine.session.prefix_hits)
        return out

    runs = {}
    eval_quality.synthesize_manifest = counted
    try:
        for run, extra in (("bf16", ["--workers", "1"]), ("int8", ["--int8"])):
            out = root / f"eval_{run}"
            counts.clear()
            t0 = time.perf_counter()
            eval_quality.main(
                ["--manifest", str(manifest), "--out-dir", str(out),
                 "--checkpoint-path", str(ckpt), "--pool-size", "8", "--ab", "kv-int8",
                 "--ab", "prefix-cache", "--asr", "mock", "--sim", "spectral",
                 "--max-new-tokens", str(EVAL_TOKENS), *extra], standalone_mode=False)
            seconds = time.perf_counter() - t0
            report = json.loads((out / "report.json").read_text())
            runs[run] = dict(counts)
            failures = []
            if list(report["configs"]) != ["baseline", "kv-int8", "prefix-cache"]:
                failures.append(f"configs {list(report['configs'])}")
            for tag, conf in report["configs"].items():
                agg = conf["aggregates"]
                if agg.get("wer_en") != 0.0 or agg.get("wer_zh") != 0.0:
                    failures.append(f"{tag}: mock WER/CER {agg}")
                if not -1.0 <= agg.get("sim_mean", 2.0) <= 1.0:
                    failures.append(f"{tag}: SIM {agg.get('sim_mean')}")
                for row in conf["items"]:
                    _wav_frames(Path(row["wav"]).read_bytes(), frame,
                                f"eval {run} {tag} {row['id']}")
            want = {"baseline": ["prefill", "decode"],
                    "kv-int8": ["prefill", "decode_kv8"],
                    "prefix-cache": ["prefill", "decode"]
                    + (["suffix"] if run == "bf16" else [])}
            if run == "int8":
                for tag in want:
                    want[tag] += ["int8_mm", "int8_ffn"]
            for tag, keys in want.items():
                zero = [k for k in keys if counts[tag][k] <= 0]
                if zero:
                    failures.append(f"{tag}: no launch of {zero}: {counts[tag]}")
            print(f"phase 13(a) eval_quality {run} ({' '.join(extra)}): "
                  f"{seconds:.1f}s; aggregates "
                  f"{ {t: c['aggregates'] for t, c in report['configs'].items()} }; "
                  f"launches per config {counts}")
            if failures:
                raise SystemExit(f"phase 13(a) eval_quality {run}: {'; '.join(failures)}")
    finally:
        eval_quality.synthesize_manifest = synthesize
    return runs


def run_eval_in_context(ckpt, root, tokenizer, dev):
    """13(b): `tools.eval_in_context --precision bfloat16` on the checkpoint
    with seeded reference and target codes: finite per-frame losses whose
    mean is `dual_ar_loss`'s semantic loss on the same inputs in this call,
    through the training forward's tensor-core route."""
    import dataclasses as dc

    import torch

    from fish_speech_tpu_torch.ops.flash_train import flash_train_forward
    from fish_speech_tpu_torch.tools import eval_in_context
    from fish_speech_tpu_torch.train.loss import dual_ar_loss
    from fish_speech_tpu_torch.utils.checkpoint import load_dual_ar

    rng = np.random.default_rng(13)
    cfg = _ckpt_cfg(tokenizer)
    ref = rng.integers(0, cfg.codebook_size, (cfg.num_codebooks, 60)).astype(np.int32)
    tgt = rng.integers(0, cfg.codebook_size, (cfg.num_codebooks, 40)).astype(np.int32)
    np.save(root / "ref.npy", ref)
    np.save(root / "tgt.npy", tgt)
    texts = ("A reference line read in a calm voice.", "The target line to follow.")
    _zero_counts()
    t0 = time.perf_counter()
    eval_in_context.main(
        ["--checkpoint-path", str(ckpt), "--reference-codes", str(root / "ref.npy"),
         "--reference-text", texts[0], "--target-codes", str(root / "tgt.npy"),
         "--target-text", texts[1], "--output", str(root / "in_context.json"),
         "--precision", "bfloat16"], standalone_mode=False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = flash_train_forward.launches_wgmma
    curve = np.asarray(json.loads((root / "in_context.json").read_text())[str(ckpt)]
                       ["per_frame"])
    params, _ = load_dual_ar(ckpt, dtype=torch.bfloat16, device=dev)
    cfg = dc.replace(cfg, use_gradient_checkpointing=False)
    inp, labels = eval_in_context.in_context_inputs(tokenizer, cfg, ref, texts[0],
                                                    tgt, texts[1])
    with torch.no_grad():
        _, metrics = dual_ar_loss(params, cfg, {
            "inputs": torch.from_numpy(inp[None]).to(dev),
            "labels": torch.from_numpy(labels[None]).to(dev)}, remat=False)
    semantic = float(metrics["semantic_loss"])
    err = abs(float(curve.mean()) - semantic)
    print(f"phase 13(b) eval_in_context (bf16, {inp.shape[1]} tokens): {len(curve)} "
          f"frames, per-frame loss {curve.min():.4f}..{curve.max():.4f}, mean "
          f"{curve.mean():.6f}; dual_ar_loss's semantic loss {semantic:.6f} (|diff| "
          f"{err:.2e}); train_fwd_wgmma_kernel launches {launches}; {seconds:.1f}s")
    if (len(curve) != tgt.shape[1] or not np.isfinite(curve).all()
            or err > 1e-3 * max(1.0, abs(semantic)) or launches <= 0):
        raise SystemExit("phase 13(b): the in-context evaluation failed")
    return launches


def _dense_fp32(params):
    """The tree with every quantized weight replaced by its plain fp32
    value: int4 W = q * s (`int4_matmul_reference`'s), int8 W = q * s."""
    import torch

    from fish_speech_tpu_torch.ops.quant import _int4_effective_weight, dequantize_int8

    if isinstance(params, dict):
        if {"p", "gs"} <= params.keys():
            return _int4_effective_weight(params, torch.float32)
        if {"q", "s"} <= params.keys():
            return dequantize_int8(params, torch.float32)
        return {k: _dense_fp32(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(_dense_fp32(v) for v in params)
    return params


def run_eval_in_context_int4(ckpt, root, tokenizer, dev):
    """13(b'): `tools.quantize --mode int4 --group-size 128` of the
    checkpoint, then `tools.eval_in_context` at its default `--precision
    float32` over it on 13(b)'s inputs: finite per-frame losses whose mean
    is, within 1e-4 relative, the fp32 `dual_ar_loss` semantic loss of the
    int4 tree with every weight dequantized (W = q * s, plain fp32 products
    with TF32 off: no int4 kernel in the reference), every int4 layer
    product of the teacher-forced forward on the "fp32_tc" route (the slow
    stack at B = T rows, the fast one at T x codebooks; phase 2 holds the
    kernel to its plain version at those shapes). Returns its launches."""
    import dataclasses as dc

    import torch

    from fish_speech_tpu_torch.ops.int4 import int4_matmul
    from fish_speech_tpu_torch.tools import eval_in_context, quantize
    from fish_speech_tpu_torch.train.loss import dual_ar_loss
    from fish_speech_tpu_torch.utils.checkpoint import load_dual_ar

    qckpt = root / "ckpt-int4"
    t0 = time.perf_counter()
    quantize.main(["--checkpoint-path", str(ckpt), "--output", str(qckpt), "--mode", "int4",
                   "--group-size", "128"], standalone_mode=False)
    t_quant = time.perf_counter() - t0
    ref, tgt = np.load(root / "ref.npy"), np.load(root / "tgt.npy")
    texts = ("A reference line read in a calm voice.", "The target line to follow.")
    gc.collect()
    torch.cuda.empty_cache()
    _zero_counts()
    t0 = time.perf_counter()
    eval_in_context.main(
        ["--checkpoint-path", str(qckpt), "--reference-codes", str(root / "ref.npy"),
         "--reference-text", texts[0], "--target-codes", str(root / "tgt.npy"),
         "--target-text", texts[1], "--output", str(root / "in_context_int4.json")],
        standalone_mode=False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = int4_matmul.launches_fp32_tc
    others = {r: getattr(int4_matmul, f"launches_{r}") for r in ("gemv", "wgmma")}
    curve = np.asarray(json.loads((root / "in_context_int4.json").read_text())[str(qckpt)]
                       ["per_frame"])
    params, cfg = load_dual_ar(qckpt, dtype=torch.float32, device=dev)
    cfg = dc.replace(cfg, semantic_begin_id=tokenizer.semantic_begin_id,
                     semantic_end_id=tokenizer.semantic_end_id, im_end_id=tokenizer.im_end_id,
                     use_gradient_checkpointing=False).resolve()
    quantized = any(isinstance(w, dict) and "p" in w for w in params["layers"].values())
    inp, labels = eval_in_context.in_context_inputs(tokenizer, cfg, ref, texts[0], tgt,
                                                    texts[1])
    dense = _dense_fp32(params)
    del params
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    n0 = int4_matmul.launches
    try:
        with torch.no_grad():
            _, metrics = dual_ar_loss(dense, cfg, {
                "inputs": torch.from_numpy(inp[None]).to(dev),
                "labels": torch.from_numpy(labels[None]).to(dev)}, remat=False)
        semantic = float(metrics["semantic_loss"])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    plain = int4_matmul.launches == n0  # the reference launched no int4 kernel
    del dense
    err = abs(float(curve.mean()) - semantic)
    print(f"phase 13(b') eval_in_context (fp32 over the int4 checkpoint, g=128, "
          f"{inp.shape[1]} tokens; quantize {t_quant:.1f}s): {len(curve)} frames, per-frame "
          f"loss {curve.min():.4f}..{curve.max():.4f}, mean {curve.mean():.6f}; fp32 "
          f"dual_ar_loss's semantic loss over the dequantized tree {semantic:.6f} (|diff| "
          f"{err:.2e}; reference free of int4 kernels {plain}); int4_matmul launches "
          f"fp32_tc {launches}, others {others}; {seconds:.1f}s")
    if (not quantized or not plain or inp.shape[1] != IN_CONTEXT_TOKENS
            or cfg.num_codebooks != IN_CONTEXT_CODEBOOKS or len(curve) != tgt.shape[1]
            or not np.isfinite(curve).all()
            or err > 1e-4 * max(1.0, abs(semantic)) or launches <= 0):
        raise SystemExit("phase 13(b'): the fp32 in-context evaluation over int4 failed")
    return launches


def run_dac_forward(dev):
    """13(d): `dac_forward` at `dac_s2_pro`'s widths in fp32 (TF32 off) on
    ~2 s of seeded audio (43 whole frames): without a generator its codes
    are `dac_encode`'s, its audio within 1e-4 of `dac_from_indices` of them
    and its losses finite; with one, the quantizer-dropout draw of 64
    samples and a round trip under it."""
    import torch

    from fish_speech_tpu_torch.config import dac_s2_pro
    from fish_speech_tpu_torch.models.dac import model as dac
    from fish_speech_tpu_torch.models.dac.rvq import quantizer_dropout_mask

    cfg = dac_s2_pro()
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        params = dac.init_dac(1, cfg, torch.float32, dev)
        t = 43 * cfg.frame_length
        audio = torch.from_numpy(np.random.default_rng(31).normal(size=(1, 1, t))
                                 .astype(np.float32) * 0.1).to(dev)
        t0 = time.perf_counter()
        with torch.no_grad():
            out, res = dac.dac_forward(params, cfg, audio)
            codes, _ = dac.dac_encode(params, cfg, audio)
            back = dac.dac_from_indices(params, cfg, codes)[..., :t]
            gen = torch.Generator(device=dev).manual_seed(5)
            drawn = quantizer_dropout_mask(cfg.rvq, 64, gen).sum(1).long()
            out_g, res_g = dac.dac_forward(params, cfg, audio, generator=gen)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    same = torch.equal(res["codes"], codes)
    err = float((out - back).abs().max())
    losses = [float(res[k][0]) for k in ("commitment_loss", "codebook_loss")]
    hist = torch.bincount(drawn.cpu(), minlength=cfg.rvq.n_codebooks + 1).tolist()
    print(f"phase 13(d) dac_forward (dac_s2_pro fp32, {t} samples): codes "
          f"{tuple(codes.shape)} equal to dac_encode's {same}; audio vs "
          f"dac_from_indices max abs {err:.2e}; commitment/codebook losses "
          f"{losses[0]:.6f} / {losses[1]:.6f}; with a generator: codebooks kept "
          f"per sample over 64 draws (p = {cfg.rvq.quantizer_dropout}, count of n = "
          f"0..{cfg.rvq.n_codebooks}) {hist}, round trip finite "
          f"{bool(torch.isfinite(out_g).all())}; {seconds:.1f}s")
    if (not same or err > 1e-4 or not np.isfinite(losses).all()
            or not torch.isfinite(out_g).all() or out.shape != audio.shape
            or not all(np.isfinite([float(res_g[k][0]) for k in
                                    ("commitment_loss", "codebook_loss")]))):
        raise SystemExit("phase 13(d): dac_forward failed")


def run_libav():
    """13(e): the libav shim where it builds: mp3 and Ogg/Opus bytes of the
    port's `audio/libcodec` through `load_audio`, against libcodec's own
    decoders; else why it is unavailable."""
    from fish_speech_tpu_torch.audio import libav, libcodec
    from fish_speech_tpu_torch.audio.io import load_audio, resample
    from fish_speech_tpu_torch.audio.transcode import TranscodeUnavailable

    try:
        libav._load()
    except TranscodeUnavailable as e:
        reason = str(e).splitlines()[0][:300]
        print(f"phase 13(e) libav: unavailable ({reason})")
        return
    sr = 24000
    t = np.arange(sr) / sr
    x = (0.3 * np.sin(2 * np.pi * 330 * t)).astype(np.float32)
    for name, enc, dec in (("mp3", libcodec.encode_mp3, libcodec.decode_mp3),
                           ("opus", libcodec.encode_opus, libcodec.decode_opus)):
        try:
            data = enc(x, sr)
            want, want_sr = dec(data)
        except TranscodeUnavailable as e:
            print(f"phase 13(e) libav: {name} encoder unavailable ({e})")
            continue
        if np.issubdtype(want.dtype, np.integer):
            want = want / 32768.0
        want = np.asarray(want, np.float32).mean(axis=1)
        got = load_audio(data, want_sr)
        n = min(len(got), len(want))
        err = float(np.abs(got[:n] - want[:n]).max()) if n else float("inf")
        print(f"phase 13(e) libav: {name} {len(data)} bytes, load_audio {len(got)} "
              f"samples at {want_sr} Hz vs libcodec's decoder {len(want)}, max abs "
              f"{err:.2e}")
        if not n or err > 2e-2:
            raise SystemExit(f"phase 13(e): libav's {name} decode disagrees")


def print_flops(cfg, batch, seq, step_s, smi):
    """13(f): phase 5's analytic model FLOPs per step (the LoRA step with
    remat, `utils/flops.py:dual_ar_train_step_flops`), its rate at phase
    5's steady s/step and its share of 989 TFLOP/s dense bf16."""
    from fish_speech_tpu_torch.utils.flops import dual_ar_train_step_flops

    plan = dual_ar_train_step_flops(cfg, batch, seq, mode="lora", remat=True)
    rate = plan["total"] / step_s / 1e12
    print(f"phase 13(f) FLOPs: phase 5's step (B={batch} x T={seq}, LoRA, remat) "
          f"{plan['total'] / 1e12:.3f} TFLOP model ({plan['hfu_total'] / 1e12:.3f} "
          f"with the remat forward) at {step_s:.4f} s/step: {rate:.1f} TFLOP/s, "
          f"MFU {100 * rate * 1e12 / PEAK_BF16:.2f}% of 989 TFLOP/s dense bf16 "
          f"({100 * plan['hfu_total'] / step_s / PEAK_BF16:.2f}% HFU); card {smi}")


def run_eval_tools(dev, tokenizer, train, smi):
    """Phase 13: (a) the quality harness, (b) the in-context evaluation in
    bf16 and (b') in fp32 over an int4 checkpoint, (d)
    the codec's training round trip, (e) libav input and (f) the FLOPs of
    phase 5's step ((c), the API client, runs against phase 9's server).
    The checkpoint is phase 11's model (s2-pro's widths at 2 + 2 layers,
    bf16) and the full codec, in a temporary directory under `build/`
    removed at the end. Returns the launches of (a), (b) and (b') by the
    `kernels` line's names."""
    import shutil
    import tempfile

    import torch

    from fish_speech_tpu_torch.config import dac_s2_pro
    from fish_speech_tpu_torch.models import dual_ar
    from fish_speech_tpu_torch.models.dac.model import init_dac
    from fish_speech_tpu_torch.utils.checkpoint import save_codec, save_dual_ar

    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent
    (root / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_eval_", dir=root / "build"))
    try:
        cfg = _ckpt_cfg(tokenizer)
        ckpt = tmp / "ckpt"
        save_dual_ar(ckpt, dual_ar.init_dual_ar(0, cfg, torch.bfloat16, dev), cfg,
                     tokenizer)
        codec_cfg = dac_s2_pro()
        save_codec(ckpt, init_dac(1, codec_cfg, torch.float32, dev), codec_cfg)
        gc.collect()
        torch.cuda.empty_cache()
        runs = run_eval_quality(ckpt, tmp, codec_cfg.frame_length)
        launches = {}
        for counts in runs.values():
            for tag_counts in counts.values():
                for key, (_, _, name) in EVAL_COUNTERS.items():
                    launches[name] = launches.get(name, 0) + tag_counts[key]
        gc.collect()
        torch.cuda.empty_cache()
        launches["flash_train_fwd"] = run_eval_in_context(ckpt, tmp, tokenizer, dev)
        gc.collect()
        torch.cuda.empty_cache()
        launches["int4_mm_fp32_tc"] = run_eval_in_context_int4(ckpt, tmp, tokenizer, dev)
        gc.collect()
        torch.cuda.empty_cache()
        run_dac_forward(dev)
        run_libav()
        print_flops(train["cfg"], train["batch"], train["seq"], train["step_s"], smi)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.synchronize()
    print(f"phase 13 (the evaluation tools, dac_forward, libav, FLOPs) took "
          f"{time.perf_counter() - t_phase:.1f}s; its launches {launches}")
    return launches


# ---------------------------------------------------------------------------
# phase 14: fp16 serving (`--half`): the fp16 forms of the kernels against
# their plain versions, full-width s2-pro in fp16 through the single
# session's graphs with the fp16 codec, and `build_engine --half --int8
# --kv-int8 --pool-size 32 --prefix-cache 4` under a burst
# ---------------------------------------------------------------------------

HALF_CLIENTS = 24  # 17-32 rows: the int8 matvec's cluster kernel
HALF_TOKENS = 32   # new tokens of each request of the burst


def half_kernel_cases(dev, randn):
    """Each fp16 kernel against its plain version at the fp16 serving
    path's shapes (the bf16 cases' shapes, a few each): the prefill at a
    prompt bucket and a group prefill; the decode over the session's slow
    cache, the fast cache and the pool's ragged rows; the int8-KV decode
    likewise; the suffix over an fp16 and an int8 cache at a voice-clone
    start; the int8 matvec (1-16 rows) and its cluster kernel (17-32 rows)
    at the slow and fast w13 and the LM head; the fused FFN at the slow and
    fast FFN. Each is held to its bf16 form's bound (attention 2e-2 max /
    2e-3 mean; the int8 products to one fp16 rounding of y, 2^-11 |y|, +
    1e-5 (|x| @ |q|) * s; the FFN to 2 fp16 ulps of max |y|) and timed
    beside its plain version and the library call on fp16 operands (SDPA;
    cuBLAS on the dequantized fp16 weight)."""
    import torch
    import torch.nn.functional as F

    from fish_speech_tpu_torch.models.dual_ar import _kv_dequant, _kv_quant
    from fish_speech_tpu_torch.ops.flash_decode import (
        flash_decode_attention, flash_decode_attention_kv8,
        flash_decode_kv8_reference, flash_decode_reference)
    from fish_speech_tpu_torch.ops.flash_prefill import (
        flash_prefill_attention, flash_prefill_reference, flash_suffix_attention,
        flash_suffix_reference)
    from fish_speech_tpu_torch.ops.int4 import (int4_dequant_f16, int4_matmul,
                                                 int4_matmul_f16w_reference)
    from fish_speech_tpu_torch.ops.int8 import (_route, int8_matmul,
                                                int8_matmul_reference)
    from fish_speech_tpu_torch.ops.int8_ffn import int8_ffn, int8_ffn_reference
    from fish_speech_tpu_torch.ops.quant import quantize_int4, quantize_int8

    f16 = torch.float16

    def h(*shape):
        return randn(*shape).to(f16)

    def attn_ok(mx, mean):
        return mx <= 2e-2 and mean <= 2e-3

    cases = {n: [] for n in HALF_KERNELS}
    for b, t, offsets in [(1, 1024, [0]), (4, 128, [0] * 4)]:
        q, k, v = (h(b, t, n, 128) for n in (32, 8, 8))
        off = torch.tensor(offsets, dtype=torch.int32, device=dev)
        mx, mean = _errors(flash_prefill_attention(q, k, v, off),
                           flash_prefill_reference(q, k, v, off))
        ms, plain_ms = _in_turns(lambda i=0: flash_prefill_reference(q, k, v, off),
                                 lambda i=0: flash_prefill_attention(q, k, v, off), 20)
        pairs = sum((t - o) * (t - o + 1) // 2 for o in offsets)
        flops = 4 * 32 * 128 * pairs
        bound = _bound(flops, 2 * b * t * 128 * 2 * (32 + 8))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib = _library_ms(lambda i=0: _sdpa(qt, kt, vt, None, True), 20)
        cases["flash_prefill_f16"].append(dict(
            shape=f"B={b} T={t} H=32 Hkv=8 D=128 offsets={_offsets_text(offsets)} "
                  f"float16 wgmma_f16 ({flops / ms / 1e9:.1f} TFLOP/s; SDPA is_causal)",
            max_abs_err=mx, mean_abs_err=mean, ms=ms, plain_ms=plain_ms,
            bound_ms=bound[0], bound_by=bound[1], library_ms=lib,
            device_ms=_device_ms(lambda i=0: flash_prefill_attention(q, k, v, off), 20),
            library_device_ms=_device_ms(lambda i=0: _sdpa(qt, kt, vt, None, True), 20),
            ok=attn_ok(mx, mean)))
        del q, k, v
    for n_layer, s, hkv, g, length in [(36, 2112, 8, 4, 2048), (12, 10, 4, 3, 10)]:
        q = h(1, hkv, g, 128)
        kc, vc = h(n_layer, 1, s, hkv, 128), h(n_layer, 1, s, hkv, 128)
        lens = torch.tensor([length], dtype=torch.int32, device=dev)
        mx = mean = 0.0
        for layer in (0, n_layer - 1):
            e = _errors(flash_decode_attention(q, kc, vc, layer, lens),
                        flash_decode_reference(q, kc, vc, layer, lens))
            mx, mean = max(mx, e[0]), max(mean, e[1])
        ms, plain_ms = _in_turns(
            lambda i=0: flash_decode_reference(q, kc, vc, i % n_layer, lens),
            lambda i=0: flash_decode_attention(q, kc, vc, i % n_layer, lens), 100)
        bound = _bound(4 * hkv * g * 128 * length,
                       2 * (2 * length * hkv * 128 + 2 * hkv * g * 128))
        qs = q.reshape(1, hkv * g, 1, 128)

        def sdpa(i=0):
            return F.scaled_dot_product_attention(
                qs, kc[i % n_layer, :, :length].transpose(1, 2),
                vc[i % n_layer, :, :length].transpose(1, 2), enable_gqa=True)

        cases["flash_decode_f16"].append(dict(
            shape=f"L={n_layer} B=1 S={s} Hkv={hkv} G={g} D=128 len={length} float16",
            max_abs_err=mx, mean_abs_err=mean, ms=ms, plain_ms=plain_ms,
            bound_ms=bound[0], bound_by=bound[1], library_ms=_library_ms(sdpa, 100),
            device_ms=_device_ms(lambda i=0: flash_decode_attention(
                q, kc, vc, i % n_layer, lens), 100),
            library_device_ms=_device_ms(sdpa, 100), ok=attn_ok(mx, mean)))
        del kc, vc
    cases["flash_decode_f16"].append(pool_decode_case(dev, randn, f16))
    n_layer, s, length = 36, 2112, 2048
    kq, ks = _kv_quant(randn(n_layer, 1, s, 8, 128))
    vq, vs = _kv_quant(randn(n_layer, 1, s, 8, 128))
    q = h(1, 8, 4, 128)
    lens = torch.tensor([length], dtype=torch.int32, device=dev)
    mx = mean = 0.0
    for layer in (0, n_layer - 1):
        e = _errors(flash_decode_attention_kv8(q, kq, ks, vq, vs, layer, lens),
                    flash_decode_kv8_reference(q, kq, ks, vq, vs, layer, lens))
        mx, mean = max(mx, e[0]), max(mean, e[1])

    def kv8_kernel(k=0):
        return flash_decode_attention_kv8(q, kq, ks, vq, vs, k % n_layer, lens)

    ms, plain_ms = _in_turns(
        lambda k=0: flash_decode_kv8_reference(q, kq, ks, vq, vs, k % n_layer, lens),
        kv8_kernel, 100)
    kd = _kv_dequant(kq[:, :, :length], ks[:, :, :length], f16)
    vd = _kv_dequant(vq[:, :, :length], vs[:, :, :length], f16)
    qs = q.reshape(1, 32, 1, 128)

    def kv8_sdpa(k=0):
        return F.scaled_dot_product_attention(
            qs, kd[k % n_layer].transpose(1, 2), vd[k % n_layer].transpose(1, 2),
            enable_gqa=True)

    bound = _bound(4 * 8 * 4 * 128 * length,
                   2 * length * 8 * 128 + 2 * 2 * length * 8 + 2 * 2 * 8 * 4 * 128)
    cases["flash_decode_kv8_f16"].append(dict(
        shape=f"L={n_layer} B=1 S={s} Hkv=8 G=4 D=128 len={length} int8 K/V float16",
        max_abs_err=mx, mean_abs_err=mean, ms=ms, plain_ms=plain_ms,
        bound_ms=bound[0], bound_by=bound[1], library_ms=_library_ms(kv8_sdpa, 100),
        device_ms=_device_ms(kv8_kernel, 100),
        library_device_ms=_device_ms(kv8_sdpa, 100), ok=attn_ok(mx, mean)))
    del kq, ks, vq, vs, kd, vd
    cases["flash_decode_kv8_f16"].append(pool_decode_kv8_case(dev, randn, f16))
    # the suffix at a voice-clone start over 8 layers of the session's cache
    n_layer, b, ts = 8, 1, 64
    kv = SUFFIX_START + ts
    st = torch.tensor([SUFFIX_START], dtype=torch.int32, device=dev)
    q = h(b, ts, 32, 128)
    i_, j_ = torch.arange(ts, device=dev), torch.arange(kv, device=dev)
    mask = (j_[None, :] <= SUFFIX_START + i_[:, None])[None, None]
    for kv8 in (False, True):
        cache = _suffix_cache(dev, randn, n_layer, b, SUFFIX_S, 8, 128, kv8, f16)
        mx = mean = 0.0
        for layer in (0, n_layer - 1):
            e = _errors(flash_suffix_attention(q, cache, layer, st),
                        flash_suffix_reference(q, cache, layer, st))
            mx, mean = max(mx, e[0]), max(mean, e[1])
        ms, plain_ms = _in_turns(
            lambda i=0: flash_suffix_reference(q, cache, i % n_layer, st),
            lambda i=0: flash_suffix_attention(q, cache, i % n_layer, st), 20)
        if kv8:
            kl = [_kv_dequant(cache["k"][i, :, :kv], cache["ks"][i, :, :kv], f16
                              ).transpose(1, 2) for i in range(n_layer)]
            vl = [_kv_dequant(cache["v"][i, :, :kv], cache["vs"][i, :, :kv], f16
                              ).transpose(1, 2) for i in range(n_layer)]
        else:
            kl = [cache["k"][i, :, :kv].transpose(1, 2) for i in range(n_layer)]
            vl = [cache["v"][i, :, :kv].transpose(1, 2) for i in range(n_layer)]
        qt = q.transpose(1, 2)

        def sfx_sdpa(i=0):
            return F.scaled_dot_product_attention(
                qt, kl[i % n_layer], vl[i % n_layer], attn_mask=mask, enable_gqa=True)

        flops = 4 * 128 * 32 * b * (ts * SUFFIX_START + ts * (ts + 1) // 2)
        nbytes = (2 * q.numel() * 2 + b * kv * 8 * 128 * (1 if kv8 else 2) * 2
                  + (b * kv * 8 * 2 * 2 if kv8 else 0))
        bound = _bound(flops, nbytes)
        name = "flash_suffix_kv8_f16" if kv8 else "flash_suffix_f16"
        cases[name].append(dict(
            shape=f"L={n_layer} B={b} S={SUFFIX_S} H=32 Hkv=8 D=128 start="
                  f"{SUFFIX_START} Ts={ts} float16 q, {'int8' if kv8 else 'float16'} "
                  f"cache (SDPA mask)",
            max_abs_err=mx, mean_abs_err=mean, ms=ms, plain_ms=plain_ms,
            bound_ms=bound[0], bound_by=bound[1], library_ms=_library_ms(sfx_sdpa, 20),
            device_ms=_device_ms(lambda i=0: flash_suffix_attention(
                q, cache, i % n_layer, st), 20),
            library_device_ms=_device_ms(sfx_sdpa, 20), ok=attn_ok(mx, mean)))
        del cache, kl, vl
    # the int8 products: rows 1 and 4 (the session, a group's heads) on the
    # 1-16-row kernel, 32 (the pool) on the cluster kernel
    for label, i, o, rows in [("slow w13", 2560, 19456, (1, 4, 32)),
                              ("fast w13", 1536, 12288, (32,)),
                              ("LM head", 2560, 155136, (1,))]:
        qw = quantize_int8(randn(i, o).float() * 0.02)
        q8, s8 = qw["q"], qw["s"]
        del qw
        w16 = (q8.float() * s8).to(f16)  # cuBLAS's operand: W dequantized
        for b in rows:
            x = h(b, i)
            got = int8_matmul(x, q8, s8)
            exact = (x.float() @ q8.float()) * s8
            scale = (x.float().abs() @ q8.float().abs()) * s8
            ok = bool(((got.float() - exact).abs()
                       <= 2.0 ** -11 * exact.abs() + 1e-5 * scale).all())
            err = (got.float() - int8_matmul_reference(x, q8, s8).float()).abs()
            del exact, scale
            iters = 20 if o > 100_000 else 100
            ms, plain_ms = _in_turns(lambda k=0: int8_matmul_reference(x, q8, s8),
                                     lambda k=0: int8_matmul(x, q8, s8), iters)
            bound = _bound(2 * b * i * o, i * o + 4 * o + 2 * b * (i + o))
            name = ("int8_mm_cluster_f16" if _route(b, f16) == "gemv_cluster_f16"
                    else "int8_mm_f16")
            cases[name].append(dict(
                shape=f"{label} B={b} I={i} O={o} float16", max_abs_err=err.max().item(),
                mean_abs_err=err.mean().item(), ms=ms, plain_ms=plain_ms,
                bound_ms=bound[0], bound_by=bound[1],
                library_ms=_library_ms(lambda k=0: x @ w16, iters),
                device_ms=_device_ms(lambda k=0: int8_matmul(x, q8, s8), iters),
                library_device_ms=_device_ms(lambda k=0: x @ w16, iters), ok=ok))
            del got, err
        del q8, s8, w16
        torch.cuda.empty_cache()
    # the int4 products (phase 14(c)'s `int4` and `mixed`): the matvec
    # ("gemv_f16", B = 1) at the slow w13 and w2 and the fast w13, the
    # tensor cores ("wgmma_f16") at the slow w13 and w2 at B = 1024 and the
    # slow w2 at B = 128 (the prefill buckets); fp16-valued scales (a
    # checkpoint read under `--half`), so W is the JAX `mm`'s, held to one
    # fp16 rounding of y, 2^-11 |y|, + 1e-5 |x| @ |W| of x @ W in fp32. The
    # matvec's device ms walks copies of (p, gs), and cuBLAS copies of its
    # fp16 W, over twice the L2, as phase 2's bf16 rows
    for label, i, o, rows in [("slow w13", 2560, 19456, (1, 1024)),
                              ("slow w2", 9728, 2560, (1, 128, 1024)),
                              ("fast w13", 1536, 12288, (1,))]:
        qw = quantize_int4(randn(i, o).float() * 0.02, group_size=128)
        p, gs = qw["p"], qw["gs"].half().float()
        del qw
        w16 = int4_dequant_f16(p, gs)  # cuBLAS's operand
        for b in rows:
            x = h(b, i)
            got = int4_matmul(x, p, gs)
            exact = x.float() @ w16.float()
            scale = x.float().abs() @ w16.float().abs()
            ok = bool(((got.float() - exact).abs()
                       <= 2.0 ** -11 * exact.abs() + 1e-5 * scale).all())
            err = (got.float() - int4_matmul_f16w_reference(x, p, gs).float()).abs()
            del exact, scale
            iters = MATVEC_ITERS if b == 1 else 20
            ms, plain_ms = _in_turns(lambda k=0: int4_matmul_f16w_reference(x, p, gs),
                                     lambda k=0: int4_matmul(x, p, gs), iters)
            flops = 2 * b * i * o
            bound = _bound(flops, i // 2 * o + 4 * (i // 128) * o + 2 * b * (i + o))
            n_q = -(-L2_COLD_BYTES // (p.numel() + 4 * gs.numel())) if b == 1 else 1
            n_w = -(-L2_COLD_BYTES // (2 * i * o)) if b == 1 else 1
            qs = [(p, gs)] + [(p.clone(), gs.clone()) for _ in range(n_q - 1)]
            ws = [w16] + [w16.clone() for _ in range(n_w - 1)]
            name = "int4_mm_f16" if b <= 8 else "int4_mm_wgmma_f16"
            cases[name].append(dict(
                shape=f"{label} B={b} I={i} O={o} g=128 float16 "
                      f"({flops / ms / 1e9:.1f} TFLOP/s)",
                max_abs_err=err.max().item(), mean_abs_err=err.mean().item(), ms=ms,
                plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1],
                library_ms=_library_ms(lambda k=0: x @ w16, iters),
                device_ms=_device_ms(lambda k=0: int4_matmul(x, *qs[k % n_q]), iters),
                library_device_ms=_device_ms(lambda k=0: x @ ws[k % n_w], iters),
                weight_copies=[n_q, n_w], ok=ok))
            del got, err, qs, ws
        del p, gs, w16
        torch.cuda.empty_cache()
    for label, d, i, b in [("slow FFN", 2560, 9728, 1), ("fast FFN", 1536, 6144, 32)]:
        w1, w3, w2 = (quantize_int8(randn(*shape).float() * 0.02)
                      for shape in ((d, i), (d, i), (i, d)))
        w13 = {k: torch.cat([w1[k], w3[k]], dim=-1) for k in ("q", "s")}
        lib13 = (w13["q"].float() * w13["s"]).to(f16)
        lib2 = (w2["q"].float() * w2["s"]).to(f16)
        x = h(b, d)
        got, plain = int8_ffn(x, w13, w2), int8_ffn_reference(x, w13, w2)
        err = (got.float() - plain.float()).abs()
        top = plain.float().abs().max().item()
        ulps = err.max().item() / 2.0 ** (np.floor(np.log2(top)) - 10)

        def ffn_lib(k=0):
            u = x @ lib13
            return (F.silu(u[:, :i]) * u[:, i:]) @ lib2

        ms, plain_ms = _in_turns(lambda k=0: int8_ffn_reference(x, w13, w2),
                                 lambda k=0: int8_ffn(x, w13, w2), 100)
        bound = _bound(6 * b * d * i, 3 * d * i + 4 * (2 * i + d) + 4 * b * d)
        cases["int8_ffn_f16"].append(dict(
            shape=f"{label} B={b} D={d} I={i} float16", max_abs_err=err.max().item(),
            mean_abs_err=err.mean().item(), max_ulps=ulps, ms=ms, plain_ms=plain_ms,
            bound_ms=bound[0], bound_by=bound[1], library_ms=_library_ms(ffn_lib, 100),
            device_ms=_device_ms(lambda k=0: int8_ffn(x, w13, w2), 100),
            library_device_ms=_device_ms(ffn_lib, 100),
            ok=bool(torch.isfinite(got).all() and ulps <= 2)))
        del w1, w3, w2, w13, lib13, lib2, got, plain, err
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    for name, rows in cases.items():
        for r in rows:
            print(f"kernel {name} [{r['shape']}]: max_abs_err={r['max_abs_err']:.3e} "
                  f"mean_abs_err={r['mean_abs_err']:.3e} kernel_ms={r['ms']:.4f} "
                  f"plain_ms={r['plain_ms']:.4f} bound={_ms_text(r['bound_ms'])} "
                  f"({r['bound_by']}) library_ms={r['library_ms']:.4f} device_ms="
                  f"{r['device_ms']:.4f} library_device_ms={r['library_device_ms']:.4f}"
                  + (f" max_ulps={r['max_ulps']:.2f}" if "max_ulps" in r else ""))
            # the pool's rows (`pool_decode_case`) carry no verdict: the
            # attention bound
            if not r.get("ok", r["max_abs_err"] <= 2e-2 and r["mean_abs_err"] <= 2e-3):
                raise SystemExit(f"{name} disagrees with its plain version at "
                                 f"{r['shape']}")
    return cases


# the fp16 kernels' launch counters: (kernel name, wrapper, attribute)
HALF_COUNTERS = {
    "flash_prefill_f16": ("flash_prefill_attention", "launches_wgmma_f16"),
    "flash_suffix_f16": ("flash_suffix_attention", "launches_suffix_wgmma_f16"),
    "flash_suffix_kv8_f16": ("flash_suffix_attention", "launches_suffix_kv8_wgmma_f16"),
    "flash_decode_f16": ("flash_decode_attention", "launches_f16"),
    "flash_decode_kv8_f16": ("flash_decode_attention_kv8", "launches_f16"),
    "int8_mm_f16": ("int8_matmul", "launches_gemv_mma_f16"),
    "int8_mm_cluster_f16": ("int8_matmul", "launches_gemv_cluster_f16"),
    "int8_ffn_f16": ("int8_ffn", "launches_mma_f16"),
    "int4_mm_f16": ("int4_matmul", "launches_gemv_f16"),
    "int4_mm_wgmma_f16": ("int4_matmul", "launches_wgmma_f16"),
}
HALF_KERNELS = tuple(HALF_COUNTERS)
# the bf16 routes, which no fp16 request may take
BF16_COUNTERS = (("flash_prefill_attention", "launches_wgmma"),
                 ("flash_suffix_attention", "launches_suffix_wgmma"),
                 ("flash_suffix_attention", "launches_suffix_kv8_wgmma"),
                 ("int8_matmul", "launches_gemv_mma"),
                 ("int8_matmul", "launches_gemv_cluster"),
                 ("int8_ffn", "launches_mma"),
                 ("int4_matmul", "launches_gemv"),
                 ("int4_matmul", "launches_wgmma"))


def _half_counts():
    """{fp16 kernel name: launches} and the bf16 routes' launches, read from
    the wrappers' counters."""
    from fish_speech_tpu_torch.ops.flash_prefill import flash_suffix_attention

    wrappers = {f.__name__: f for f in (*_kernel_wrappers(), flash_suffix_attention)}
    half = {name: getattr(wrappers[f], attr) for name, (f, attr) in HALF_COUNTERS.items()}
    bf16 = sum(getattr(wrappers[f], attr) for f, attr in BF16_COUNTERS)
    return half, bf16


def _audio_stats(audio):
    return float(np.abs(audio).max()), float((audio == 0).mean())


def run_half_session(dev, tokenizer):
    """14(a): `dual_ar_s2_pro` at full width and depth in fp16 with the
    codec in fp16, through the single session's graphs (the prefix cache
    on): phase 4's short and long requests, the short one again (the same
    seed: identical codes) and the long one again (a prefix hit: the fp16
    suffix kernel). Prints TTFA, frames/s, the replayed step's device ms,
    and the audio's max |x| and share of exact zeros beside the fp32
    codec's on the same codes (random weights: the fp16 codec may
    underflow). Returns the fp16 kernels' launches."""
    import torch

    from fish_speech_tpu_torch.config import SamplingConfig, dac_s2_pro
    from fish_speech_tpu_torch.generate import GenerationSession
    from fish_speech_tpu_torch.models import dual_ar
    from fish_speech_tpu_torch.models.dac.model import dac_from_indices, init_dac

    t0 = time.perf_counter()
    cfg = _s2_pro_cfg(tokenizer, 2048)
    dac_cfg = dac_s2_pro()
    params = dual_ar.init_dual_ar(0, cfg, torch.float16, dev)
    codec = init_dac(1, dac_cfg, torch.float16, dev)
    session = GenerationSession(params, cfg, SamplingConfig(), dtype=torch.float16,
                                decode_chunk_size=64, first_chunk_size=8,
                                prefix_cache_size=4)
    del params
    engine = _recording_engine(session, tokenizer, codec, dac_cfg)
    short, long_ = _requests()[:2]
    requests = [short, long_, ("short-repeat", short[1]), ("long-repeat", long_[1])]
    print(f"14(a): dual_ar_s2_pro fp16 (max_seq_len 2048) + dac_s2_pro fp16 built in "
          f"{time.perf_counter() - t0:.1f}s; device memory allocated "
          f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB")
    precompile_for(session, tokenizer, requests, "fp16", suffix_buckets=(1,))
    precompile_codec(engine, PHASE4_CODE_BUCKETS, (), "fp16")
    _zero_counts()
    results = serve(dev, tokenizer, engine, requests, dac_cfg.frame_length, "fp16")
    torch.cuda.synchronize()
    launches, bf16 = _half_counts()
    hits = session.prefix_hits
    check_replayed(session, "fp16")
    check_codec_replayed(engine, ("decode",), "fp16")
    step_ms = replayed_step_ms(session)
    same_hit = np.array_equal(engine.codes_by_request["long"],
                              engine.codes_by_request["long-repeat"])
    # the hit's first logits within the cold prefill's envelope (phase 4b's
    # bound); its codes are printed, not held: the suffix kernel sums in
    # another order than the prefill's
    check_hit_logits(session, _prompt_len(tokenizer, cfg, long_[1].text), "14(a) fp16")
    codes = torch.from_numpy(engine.codes_by_request["long"][None]).to(dev)
    with torch.no_grad():
        a16 = dac_from_indices(codec, dac_cfg, codes).float().cpu().numpy()
        del codec
        codec32 = init_dac(1, dac_cfg, torch.float32, dev)
        a32 = dac_from_indices(codec32, dac_cfg, codes).cpu().numpy()
    del codec32
    print(f"14(a) fp16 session: TTFA " + " / ".join(
              f"{r['request']} {r['ttfa_s'] * 1e3:.1f} ms" for r in results)
          + "; decode frames/s " + " / ".join(
              f"{r['decode_frames_per_s']:.2f}" for r in results)
          + f"; replayed step {step_ms:.3f} ms of device time; prefix hits {hits} "
          f"(the hit's codes equal the cold run's: {same_hit}, printed, not held); "
          f"long request's audio "
          f"fp16 codec max|x| {_audio_stats(a16)[0]:.3e}, exact zeros "
          f"{_audio_stats(a16)[1]:.4f}; fp32 codec on the same codes max|x| "
          f"{_audio_stats(a32)[0]:.3e}, exact zeros {_audio_stats(a32)[1]:.4f}, "
          f"max |fp16 - fp32| {np.abs(a16 - a32).max():.3e}; launches {launches}; "
          f"bf16 routes {bf16}; {_nvidia_smi()}")
    if hits < 1 or bf16:
        raise SystemExit(f"14(a): prefix hits {hits}, bf16 route launches {bf16}")
    for name in ("flash_prefill_f16", "flash_decode_f16", "flash_suffix_f16"):
        if launches[name] <= 0:
            raise SystemExit(f"14(a): {name} was never launched: {launches}")
    if not (np.isfinite(a16).all() and np.isfinite(a32).all()):
        raise SystemExit("14(a): the codec's audio is not finite")
    del session, engine
    return launches, dict(step_ms=step_ms, results=results)


def run_half_pool(dev, tokenizer):
    """14(b): `build_engine --half --int8 --kv-int8 --pool-size 32
    --prefix-cache 4` (the server's own function and warm-up) on a
    checkpoint at s2-pro's widths with 2 + 2 layers written by the port's
    writer (bf16 LM, fp32 codec), then a burst of HALF_CLIENTS concurrent
    requests (the pool's step at 17-32 rows: the cluster kernel) and one
    request of the burst twice more alone (the second a prefix hit
    whatever the burst left in the 4-entry cache: the int8-cache suffix
    kernel). Returns the fp16 kernels' launches."""
    import shutil
    import tempfile

    import torch

    from fish_speech_tpu_torch.config import dac_s2_pro
    from fish_speech_tpu_torch.models import dual_ar
    from fish_speech_tpu_torch.models.dac.model import init_dac
    from fish_speech_tpu_torch.server import main as server_main
    from fish_speech_tpu_torch.utils.checkpoint import save_codec, save_dual_ar

    root = Path(__file__).resolve().parent
    (root / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_half_", dir=root / "build"))
    try:
        t0 = time.perf_counter()
        cfg = _ckpt_cfg(tokenizer)
        ckpt = tmp / "ckpt"
        save_dual_ar(ckpt, dual_ar.init_dual_ar(0, cfg, torch.bfloat16, dev), cfg,
                     tokenizer)
        codec_cfg = dac_s2_pro()
        save_codec(ckpt, init_dac(1, codec_cfg, torch.float32, dev), codec_cfg)
        gc.collect()
        torch.cuda.empty_cache()
        args = server_main.parse_args([
            "--checkpoint-path", str(ckpt), "--half", "--int8", "--kv-int8",
            "--pool-size", "32", "--prefix-cache", "4",
            "--references-dir", str(tmp / "refs")])
        built = server_main.build_engine(args)
        batcher = built.session.batcher
        dtypes = {str(t.dtype) for t in (batcher.params["embeddings"],
                                         *_flat(built.codec_params).values())}
        if dtypes != {"torch.float16"}:
            raise SystemExit(f"14(b): --half built {dtypes} weights")
        engine = _pool_engine(built.session, built.tokenizer, built.codec_params,
                              built.codec_cfg, str(tmp / "refs"))
        del built
        t_built = time.perf_counter() - t0
        server_main.warm_up(engine)
        t_warm = time.perf_counter() - t0 - t_built
        requests = [dataclasses.replace(r, max_new_tokens=HALF_TOKENS)
                    for r in _pool_requests()[:HALF_CLIENTS]]
        _zero_counts()
        hits0 = batcher.prefix.hits
        rows, t_submit = pool_serve(engine, requests, codec_cfg.frame_length, "fp16")
        again = [pool_serve(engine, [requests[POOL_REPEAT]], codec_cfg.frame_length,
                            "fp16 repeat")[0][0] for _ in range(2)]
        torch.cuda.synchronize()
        launches, bf16 = _half_counts()
        hits = batcher.prefix.hits - hits0
        per_step = batcher.launches_per_replay("decode")
        frames = sum(r["frames"] for r in rows)
        wall = max(r["last"] for r in rows) - t_submit
        ttfa = [r["first"] - r["t0"] for r in rows]
        same = all(np.array_equal(rows[POOL_REPEAT]["codes"], a["codes"])
                   for a in again)
        print(f"14(b) build_engine --half --int8 --kv-int8 --pool-size 32 "
              f"--prefix-cache 4 on s2-pro's widths at 2 + 2 layers: checkpoint and "
              f"engine {t_built:.1f}s, warm_up {t_warm:.1f}s; embeddings and codec "
              f"in {sorted(dtypes)}; burst of {len(rows)}: {frames} frames in "
              f"{wall:.2f}s ({frames / wall:.1f} frames/s), TTFA p50 "
              f"{_pct(ttfa, 50) * 1e3:.1f} ms p90 {_pct(ttfa, 90) * 1e3:.1f} ms; "
              f"request {POOL_REPEAT} twice again: prefix hits {hits}, codes equal "
              f"to the burst's {same} (printed, not held); launches per replayed "
              f"P=32 step {per_step}; "
              f"launches {launches}; bf16 routes {bf16}; {_nvidia_smi()}")
        if hits < 1 or bf16:
            raise SystemExit(f"14(b): prefix hits {hits}, bf16 route launches {bf16}")
        for name in ("flash_prefill_f16", "flash_decode_f16", "flash_decode_kv8_f16",
                     "flash_suffix_kv8_f16", "int8_mm_f16", "int8_mm_cluster_f16",
                     "int8_ffn_f16"):
            if launches[name] <= 0:
                raise SystemExit(f"14(b): {name} was never launched: {launches}")
        batcher.shutdown()
        del engine, batcher
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


def run_half_int4(dev, tokenizer):
    """14(c): fp16 int4 serving. `dual_ar_s2_pro` at full width and depth in
    fp16, quantized as phase 6 quantizes it (`int4`: both stacks int4;
    `mixed`: slow int8, fast int4; heads int8), with the int8 KV cache and
    the fp16 codec: phase 4's short request and its repeat each (whole
    finite frames; the same seed gives the same codes), through the int4
    kernels' fp16 forms; then `build_engine --half` (the server's function)
    over an int4 checkpoint of phase 11's 2 + 2-layer model (the port's
    writer; fp16 scales when read) and one request. No bf16 route launches.
    Returns the fp16 kernels' launches."""
    import shutil
    import tempfile

    import torch

    from fish_speech_tpu_torch.config import SamplingConfig, dac_s2_pro
    from fish_speech_tpu_torch.generate import GenerationSession
    from fish_speech_tpu_torch.models import dual_ar
    from fish_speech_tpu_torch.models.dac.model import init_dac
    from fish_speech_tpu_torch.ops.quant import quantize_dual_ar_lowmem
    from fish_speech_tpu_torch.server import main as server_main
    from fish_speech_tpu_torch.utils.checkpoint import save_codec, save_dual_ar

    t_start = time.perf_counter()
    cfg = _s2_pro_cfg(tokenizer, 2048)
    dac_cfg = dac_s2_pro()
    codec = init_dac(1, dac_cfg, torch.float16, dev)
    short = _requests()[0]
    served = [short, ("short-repeat", short[1])]
    total = {name: 0 for name in HALF_KERNELS}
    for label, mode, fast_mode in (("int4", "int4", None), ("mixed", "int8", "int4")):
        t0 = time.perf_counter()
        params = quantize_dual_ar_lowmem(
            dual_ar.init_dual_ar(0, cfg, torch.float16, dev), mode=mode,
            fast_mode=fast_mode)
        session = GenerationSession(params, cfg, SamplingConfig(), max_batch=1,
                                    dtype=torch.float16, decode_chunk_size=64,
                                    first_chunk_size=8, kv_quant=True)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        engine = _recording_engine(session, tokenizer, codec, dac_cfg)
        precompile_for(session, tokenizer, served, f"14(c) fp16 {label}")
        precompile_codec(engine, PHASE4_CODE_BUCKETS, (), f"14(c) fp16 {label}")
        _zero_counts()
        rows = serve(dev, tokenizer, engine, served, dac_cfg.frame_length,
                     f"14(c) fp16 {label}")
        torch.cuda.synchronize()
        launches, bf16 = _half_counts()
        check_replayed(session, f"14(c) fp16 {label}")
        step_ms = replayed_step_ms(session)
        print(f"14(c) fp16 {label} (slow {mode}, fast {fast_mode or mode}, heads int8, "
              f"int8 KV cache) on dual_ar_s2_pro: built, quantized, captured and "
              f"served in {time.perf_counter() - t0:.1f}s; TTFA "
              + " / ".join(f"{r['request']} {r['ttfa_s'] * 1e3:.1f} ms" for r in rows)
              + f"; replayed step {step_ms:.3f} ms of device time; int4 fp16 "
              f"launches: matvec {launches['int4_mm_f16']}, tensor cores "
              f"{launches['int4_mm_wgmma_f16']}; bf16 routes {bf16}")
        need = ["int4_mm_f16"] + (["int4_mm_wgmma_f16"] if label == "int4" else [])
        if bf16 or min(launches[n] for n in need) <= 0:
            raise SystemExit(f"14(c) {label}: bf16 route launches {bf16}, "
                             f"launches {launches}")
        for name, n in launches.items():
            total[name] += n
        del engine, session
        gc.collect()
        torch.cuda.empty_cache()
    del codec
    root = Path(__file__).resolve().parent
    (root / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_int4_", dir=root / "build"))
    try:
        t0 = time.perf_counter()
        ckpt_cfg = _ckpt_cfg(tokenizer)
        ckpt = tmp / "ckpt"
        save_dual_ar(ckpt, quantize_dual_ar_lowmem(
            dual_ar.init_dual_ar(0, ckpt_cfg, torch.bfloat16, dev), mode="int4"),
            ckpt_cfg, tokenizer)
        save_codec(ckpt, init_dac(1, dac_cfg, torch.float32, dev), dac_cfg)
        gc.collect()
        torch.cuda.empty_cache()
        built = server_main.build_engine(server_main.parse_args([
            "--checkpoint-path", str(ckpt), "--half",
            "--references-dir", str(tmp / "refs")]))
        layers = built.session.params["layers"]
        if not ({"p", "gs"} <= layers["wqkv"].keys()
                and built.session.dtype == torch.float16):
            raise SystemExit("14(c): build_engine --half did not serve int4 leaves "
                             "in fp16")
        engine = _recording_engine(built.session, built.tokenizer, built.codec_params,
                                   built.codec_cfg)
        _zero_counts()
        rows = serve(dev, built.tokenizer, engine, [short], dac_cfg.frame_length,
                     "14(c) build_engine --half int4")
        torch.cuda.synchronize()
        launches, bf16 = _half_counts()
        print(f"14(c) build_engine --half over an int4 checkpoint (s2-pro's widths, "
              f"2 + 2 layers): written, built and served in "
              f"{time.perf_counter() - t0:.1f}s; TTFA {rows[0]['ttfa_s'] * 1e3:.1f} ms; "
              f"int4 fp16 launches: matvec {launches['int4_mm_f16']}, tensor cores "
              f"{launches['int4_mm_wgmma_f16']}; bf16 routes {bf16}")
        if bf16 or min(launches[n] for n in ("int4_mm_f16", "int4_mm_wgmma_f16")) <= 0:
            raise SystemExit(f"14(c) build_engine: bf16 route launches {bf16}, "
                             f"launches {launches}")
        for name, n in launches.items():
            total[name] += n
        del engine, built
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"14(c) fp16 int4 serving took {time.perf_counter() - t_start:.1f}s; "
          f"{_nvidia_smi()}")
    return total


def run_half(dev, tokenizer):
    """Phase 14: fp16 serving. Returns (the fp16 kernels' cases, their
    launches in 14(a), 14(b) and 14(c))."""
    import torch

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(14)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)

    cases = half_kernel_cases(dev, randn)
    t_cases = time.perf_counter() - t_phase
    gc.collect()
    torch.cuda.empty_cache()
    launches, _ = run_half_session(dev, tokenizer)
    gc.collect()
    torch.cuda.empty_cache()
    for name, n in run_half_pool(dev, tokenizer).items():
        launches[name] += n
    gc.collect()
    torch.cuda.empty_cache()
    for name, n in run_half_int4(dev, tokenizer).items():
        launches[name] += n
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 14 (fp16 serving) took {time.perf_counter() - t_phase:.1f}s "
          f"(the kernel cases {t_cases:.1f}s); launches {launches}")
    if min(launches.values()) <= 0:
        raise SystemExit(f"phase 14: an fp16 kernel was never launched: {launches}")
    return cases, launches


def _zero_counts():
    """Set every kernel wrapper's launch counts to 0 (per route too)."""
    from fish_speech_tpu_torch.ops import (flash_prefill, flash_train, int4, int8,
                                           int8_ffn, quant)

    for f in _kernel_wrappers():
        f.launches = 0
        if hasattr(f, "launches_f16"):  # the decodes' fp16 count
            f.launches_f16 = 0
    for mod in (flash_prefill, flash_train, int4, int8, int8_ffn, quant):
        mod.reset_launches()


def _kernel_wrappers():
    from fish_speech_tpu_torch.ops.faststack import faststack_probe
    from fish_speech_tpu_torch.ops.flash_decode import (
        flash_decode_attention, flash_decode_attention_kv8)
    from fish_speech_tpu_torch.ops.flash_prefill import flash_prefill_attention
    from fish_speech_tpu_torch.ops.flash_train import (flash_train_backward,
                                                       flash_train_forward)
    from fish_speech_tpu_torch.ops.int4 import int4_matmul
    from fish_speech_tpu_torch.ops.int8 import int8_matmul
    from fish_speech_tpu_torch.ops.int8_ffn import int8_ffn

    return (flash_prefill_attention, flash_decode_attention, flash_train_forward,
            flash_train_backward, int4_matmul, flash_decode_attention_kv8,
            faststack_probe, int8_matmul, int8_ffn)


SRC = "fish_speech_tpu_torch/csrc/"
KERNELS = {  # name: (source, the TPU kernel or JAX code it replaces)
    "flash_prefill": (SRC + "attn_wgmma.cuh",
                      "fish_speech_tpu/ops/pallas_attention.py:26"),
    "flash_prefill_fp32": (SRC + "flash_fp32.cu",
                           "fish_speech_tpu/ops/pallas_attention.py:26"),
    "flash_decode": (SRC + "flash_decode.cu",
                     "fish_speech_tpu/ops/pallas_decode.py:47"),
    "flash_decode_fp32": (SRC + "flash_decode.cu",
                          "fish_speech_tpu/ops/pallas_decode.py:47"),
    "flash_train_fwd": (SRC + "attn_wgmma.cuh",
                        "fish_speech_tpu/ops/pallas_attention_train.py:56"),
    # fp32 and bf16 at D = 32: the 3xTF32 forward (flash_fp32.cu) and backward
    "flash_train_fwd_fp32": (SRC + "flash_fp32.cu",
                             "fish_speech_tpu/ops/pallas_attention_train.py:56"),
    "flash_train_bwd": (SRC + "attn_bwd_wgmma.cuh",
                        "fish_speech_tpu/ops/pallas_attention_train.py:131"),
    "flash_train_bwd_fp32": (SRC + "flash_train.cu",
                             "fish_speech_tpu/ops/pallas_attention_train.py:131"),
    "flash_train_fwd_bf16_tf32": (
        SRC + "flash_fp32.cu", "fish_speech_tpu/ops/pallas_attention_train.py:56"),
    "flash_train_bwd_bf16_tf32": (
        SRC + "flash_train.cu", "fish_speech_tpu/ops/pallas_attention_train.py:131"),
    "int4_mm": (SRC + "int4_mm.cuh", "fish_speech_tpu/ops/pallas_int4.py:32"),
    "int4_mm_wgmma": (SRC + "int4_mm.cuh",
                      "fish_speech_tpu/ops/pallas_int4.py:32"),
    "int4_mm_fp32": (SRC + "int4_mm.cuh", "fish_speech_tpu/ops/pallas_int4.py:32"),
    # fp32 x, B > 8: the products on the tensor cores as two TF32 terms
    "int4_mm_fp32_tc": (SRC + "int4_mm.cuh", "fish_speech_tpu/ops/pallas_int4.py:32"),
    "flash_decode_kv8": (SRC + "flash_decode.cu",
                         "fish_speech_tpu/ops/attention.py:66"),
    "faststack_probe": (SRC + "faststack.cu",
                        "fish_speech_tpu/ops/pallas_faststack.py:136"),
    "int8_mm": (SRC + "int8_mm.cu", "scripts/microbench/matvec_pallas.py:18"),
    "int8_mm_cluster": (SRC + "int8_mm.cu", "scripts/microbench/matvec_pallas.py:18"),
    "int8_mm_fp32": (SRC + "int8_mm.cu", "scripts/microbench/matvec_pallas.py:18"),
    "int8_ffn": (SRC + "int8_ffn.cu", "scripts/microbench/ffn_fused_packed.py:17"),
    "int8_ffn_fp32": (SRC + "int8_ffn.cu", "scripts/microbench/ffn_fused_packed.py:17"),
    # the prefix-cache hit's suffix attention: JAX runs an einsum over the
    # cache there (`gqa_attention`, `gqa_attention_kv8`)
    "flash_suffix": (SRC + "flash_prefill.cu", "fish_speech_tpu/models/dual_ar.py:769"),
    "flash_suffix_kv8": (SRC + "flash_prefill.cu", "fish_speech_tpu/ops/attention.py:66"),
    "flash_suffix_fp32": (SRC + "flash_fp32.cu",
                          "fish_speech_tpu/models/dual_ar.py:769"),
    "flash_suffix_kv8_fp32": (SRC + "flash_fp32.cu",
                              "fish_speech_tpu/ops/attention.py:66"),
    # the fp16 forms (`--half` serving, phase 14): the same kernels
    # instantiated for __half
    "flash_prefill_f16": (SRC + "attn_wgmma.cuh",
                          "fish_speech_tpu/ops/pallas_attention.py:26"),
    "flash_suffix_f16": (SRC + "flash_prefill.cu", "fish_speech_tpu/models/dual_ar.py:769"),
    "flash_suffix_kv8_f16": (SRC + "flash_prefill.cu",
                             "fish_speech_tpu/ops/attention.py:66"),
    "flash_decode_f16": (SRC + "flash_decode.cu",
                         "fish_speech_tpu/ops/pallas_decode.py:47"),
    "flash_decode_kv8_f16": (SRC + "flash_decode.cu",
                             "fish_speech_tpu/ops/attention.py:66"),
    "int8_mm_f16": (SRC + "int8_mm.cu", "scripts/microbench/matvec_pallas.py:18"),
    "int8_mm_cluster_f16": (SRC + "int8_mm.cu",
                            "scripts/microbench/matvec_pallas.py:18"),
    "int8_ffn_f16": (SRC + "int8_ffn.cu", "scripts/microbench/ffn_fused_packed.py:17"),
    "int4_mm_f16": (SRC + "int4_mm.cuh", "fish_speech_tpu/ops/pallas_int4.py:32"),
    "int4_mm_wgmma_f16": (SRC + "int4_mm.cuh", "fish_speech_tpu/ops/pallas_int4.py:32"),
}
# headline shapes: the long request's prefill bucket, a 257-long cache, the
# B=2 x T=1024 fine-tune shape, the slow w13 at B=1 (matvec route) and at
# B=1024 (tensor-core route), a 257-long int8 cache, the probe at R=0 in
# bf16; the fp32 attention routes at JAX's tiny widths (the prefill at
# bucket 64, the slow cache, phase 3b's training batch, the suffix at
# start 140), the tiny fast wqkv for the fp32 int4 matvec; bf16 training
# at the tiny widths on the train CLI's batch; the int8 matmul on the slow
# w13 at B=1 (its cluster kernel at B=32) and the tiny slow wqkv in fp32
# at B=1; the fused int8 FFN on the slow FFN at B=1 and the tiny slow FFN
# in fp32 at B=1
HEADLINE = {"flash_prefill": 1, "flash_prefill_fp32": 0, "flash_decode": 1,
            "flash_decode_fp32": 0, "flash_train_fwd": 0, "flash_train_fwd_fp32": 0,
            "flash_train_bwd": 0, "flash_train_bwd_fp32": 0, "int4_mm": 2,
            "int4_mm_wgmma": 6, "int4_mm_fp32": 0, "flash_decode_kv8": 1,
            # the slow w13 at B=1024
            "int4_mm_fp32_tc": 2 * len(FP32_TC_SHAPES) + 2,
            "faststack_probe": 0, "int8_mm": 2 * (len(INT8_ROWS) - 1),
            "int8_mm_cluster": 2, "int8_mm_fp32": 0,
            "int8_ffn": 0, "int8_ffn_fp32": 0, "flash_suffix": 0,
            "flash_train_fwd_bf16_tf32": 0, "flash_train_bwd_bf16_tf32": 0,
            "flash_suffix_kv8": 0, "flash_suffix_fp32": 0, "flash_suffix_kv8_fp32": 0,
            # phase 14: the prompt bucket 1024, the session's slow cache at
            # len 2048, the suffix at start 951, the slow w13 at B=1 and 32,
            # the slow FFN at B=1
            "flash_prefill_f16": 0, "flash_decode_f16": 0, "flash_decode_kv8_f16": 0,
            "flash_suffix_f16": 0, "flash_suffix_kv8_f16": 0, "int8_mm_f16": 0,
            "int8_mm_cluster_f16": 0, "int8_ffn_f16": 0,
            # phase 14(c): the slow w13 at B=1 and 1024
            "int4_mm_f16": 0, "int4_mm_wgmma_f16": 0}
# the kernels whose SASS must hold HGMMA (wgmma) instructions, and those of
# them with fp16 instantiations (a `__half` in the mangled name), which
# must hold them too
WGMMA_KERNELS = ("int4_wgmma_kernel", "train_fwd_wgmma_kernel",
                 "prefill_wgmma_kernel", "suffix_wgmma_kernel",
                 "train_bwd_dkdv_wgmma_kernel", "train_bwd_dq_wgmma_kernel")
HALF_WGMMA_KERNELS = ("prefill_wgmma_kernel", "suffix_wgmma_kernel",
                      "int4_wgmma_kernel")
# the int8 kernels whose registers and spills ptxas' report shows too
INT8_KERNELS = ("int8_gemv_mma_kernel", "int8_gemv_cluster_kernel", "int8_ffn_mma_kernel")
# and the 3xTF32 attention kernels (the fp32 prefill, suffix and training
# forward; the training backward)
TF32_KERNELS = ("attn_tf32_kernel", "train_bwd_tf32_kernel")
TF32_MODES = {"0": "prefill", "1": "suffix", "2": "train"}
TF32_TYPES = {"f": "fp32", "a": "int8 cache", "13__nv_bfloat16": "bf16"}


def _ptxas_report(build_log):
    """Print ptxas' registers, shared memory and spills of the tensor-core
    kernels from the build's log (the int8 matvec's per n8 tiles of x rows
    and load path: TMA or the block's own copy)."""
    name = None
    for line in build_log.read_text().splitlines():
        if "Compiling entry function" in line:
            name = next((k for k in (*WGMMA_KERNELS, *INT8_KERNELS, *TF32_KERNELS)
                         if k in line), None)
            dims = "<64>" if "ILi64E" in line else "<128>" if "ILi128E" in line else ""
            int8 = re.search(r"int8_gemv_(?:mma|cluster)_kernelILi(\d)ELb(\d)E", line)
            if int8:
                dims = f"<{int8[1]} n8 tiles, {'TMA' if int8[2] == '1' else 'copy'}>"
            ffn = re.search(r"int8_ffn_mma_kernelILi(\d)E", line)
            if ffn:
                dims = f"<{ffn[1]} n8 tiles>"
            suffix = re.search(r"suffix_wgmma_kernelILi(\d+)ELb(\d)E", line)
            if suffix:
                dims = f"<{suffix[1]}, {'int8' if suffix[2] == '1' else 'bf16'} cache>"
            tf32 = re.search(r"attn_tf32_kernelILi(\d+)ELi(\d)E(f|a|13__nv_bfloat16)E", line)
            if tf32:
                dims = f"<{tf32[1]}, {TF32_MODES[tf32[2]]}, {TF32_TYPES[tf32[3]]}>"
            tf32 = re.search(r"train_bwd_tf32_kernelILi(\d+)E(f|13__nv_bfloat16)E", line)
            if tf32:
                dims = f"<{tf32[1]}, {TF32_TYPES[tf32[2]]}>"
            if "6__half" in line:  # the fp16 forms of the templated kernels
                dims = dims.replace("bf16 cache", "fp16 cache") + " fp16"
        elif name and ("spill" in line or "Used" in line):
            print(f"ptxas {name}{dims}: {line.strip()}")
        if "C7513" in line:
            print(f"ptxas: {line.strip()}")


def _sass_hgmma(lib_path):
    """Count of HGMMA (wgmma) instructions per kernel in the built library's
    SASS, read with the toolkit's cuobjdump."""
    from fish_speech_tpu_torch.ops import _kernels

    cuobjdump = Path(_kernels._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = 0
        elif name is not None and "HGMMA" in line:
            counts[name] += 1
    return counts


def _bwd_occupancy():
    """Blocks per SM of the bf16 backward's two kernels at D = 64 and 128,
    from the CUDA occupancy calculator."""
    import ctypes

    from fish_speech_tpu_torch.ops import _kernels

    lib = _kernels.load_kernels()
    out = {}
    for d in (64, 128):
        dkdv, dq = ctypes.c_int(), ctypes.c_int()
        rc = lib.fs_flash_train_bwd_occupancy(d, ctypes.byref(dkdv), ctypes.byref(dq))
        _kernels.check_launch(rc, "fs_flash_train_bwd_occupancy")
        out[f"train_bwd_dkdv_wgmma_kernel<{d}>"] = dkdv.value
        out[f"train_bwd_dq_wgmma_kernel<{d}>"] = dq.value
    return out


def main():
    import torch

    if sys.argv[1:2] == ["--phase12-rank"]:  # a rank of phase 12's processes
        kind, rank, tmp = sys.argv[2], int(sys.argv[3]), sys.argv[4]
        PHASE12_RANKS[kind](rank, tmp)
        return
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    from fish_speech_tpu_torch.tokenizer import build_test_tokenizer
    from fish_speech_tpu_torch.ops import _kernels

    dev = torch.device("cuda:0")
    smi = _nvidia_smi()
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _kernels.load_kernels()
    print(f"kernels built from {_kernels.CSRC} and loaded in "
          f"{time.perf_counter() - t0:.1f}s: {_kernels.library_path()}")
    _ptxas_report(_kernels.library_path().parent / "build.log")
    sass = _sass_hgmma(_kernels.library_path())
    for name in WGMMA_KERNELS:
        hgmma = {k: n for k, n in sass.items() if name in k}
        print(f"HGMMA instructions in {name}'s SASS: {hgmma}")
        if not hgmma or min(hgmma.values()) <= 0:
            raise SystemExit(f"{name} issues no HGMMA")
    for name in HALF_WGMMA_KERNELS:
        half = {k: n for k, n in sass.items() if name in k and "6__half" in k}
        print(f"HGMMA instructions in {name}'s fp16 forms: {half}")
        if not half or min(half.values()) <= 0:
            raise SystemExit(f"{name} has no fp16 form issuing HGMMA")
    occupancy = _bwd_occupancy()
    print(f"blocks per SM of the training backward's kernels: {occupancy}")
    if min(occupancy.values()) <= 0:
        raise SystemExit("a training backward kernel fits no block on an SM")

    tokenizer = build_test_tokenizer()
    if sys.argv[1:2] == ["--phase14"]:  # phase 14 alone (no result line)
        cases14, launches14 = run_half(dev, tokenizer)
        print(json.dumps({name: dict(launches=launches14[name], cases=rows)
                          for name, rows in cases14.items()}))
        return
    cases = kernel_cases(dev, parity_shapes(tokenizer))
    from fish_speech_tpu_torch.ops.flash_decode import (flash_decode_attention,
                                                        flash_decode_attention_kv8)
    from fish_speech_tpu_torch.ops.flash_prefill import (flash_prefill_attention,
                                                         flash_suffix_attention)
    from fish_speech_tpu_torch.ops.flash_train import (flash_train_backward,
                                                       flash_train_forward)
    from fish_speech_tpu_torch.ops.int4 import int4_matmul
    from fish_speech_tpu_torch.ops.int8 import int8_matmul
    from fish_speech_tpu_torch.ops.int8_ffn import int8_ffn

    # the fp32 routes run in the tiny fp32 models' phases (phase 3's decode
    # is all fp32, so its launches are the fp32 route's)
    _zero_counts()
    small_reference(dev, tokenizer)
    fp32_launches = {"flash_prefill_fp32": flash_prefill_attention.launches_fp32_tc,
                     "flash_decode_fp32": flash_decode_attention.launches,
                     "flash_suffix_fp32": flash_suffix_attention.launches_suffix_fp32_tc}
    _zero_counts()
    small_train_reference(dev, tokenizer)
    fp32_launches["flash_train_fwd_fp32"] = flash_train_forward.launches_fp32_tc
    fp32_launches["flash_train_bwd_fp32"] = flash_train_backward.launches_fp32_tc
    _zero_counts()
    small_quant_reference(dev, tokenizer)
    fp32_launches["int4_mm_fp32"] = int4_matmul.launches_gemv
    fp32_launches["int8_mm_fp32"] = int8_matmul.launches_gemv
    fp32_launches["int8_ffn_fp32"] = int8_ffn.launches_cuda_cores
    fp32_launches["flash_suffix_kv8_fp32"] = (
        flash_suffix_attention.launches_suffix_kv8_fp32_tc)
    fp32_launches["flash_decode_kv8_fp32"] = flash_decode_attention_kv8.launches
    print(f"fp32 routes' launches in phases 3, 3b and 3c: {fp32_launches}")
    if min(fp32_launches.values()) <= 0:
        raise SystemExit("an fp32 route was never launched")
    _, launches, clone, p1_step_ms = run_slice(dev, tokenizer)
    launches["flash_suffix"] = clone["launches"]["flash_suffix"]
    gc.collect()  # the serving slice's model and caches go before the batch
    torch.cuda.empty_cache()
    batch = run_batch(dev, tokenizer)
    train_launches, train = run_train_slice(
        dev, tokenizer, _s2_pro_cfg(tokenizer, 1024),
        Path(__file__).resolve().parent / "build" / "chip_smoke_train")
    launches.update(train_launches)
    launches.update(run_train_cli(
        Path(__file__).resolve().parent / "build" / "chip_smoke_train_cli"))
    launches.update(fp32_launches)
    gc.collect()  # the training model goes before quantized serving
    torch.cuda.empty_cache()
    quant = run_quant_slice(dev, tokenizer)
    launches["int4_mm"] = quant["mixed"]["launches"]["int4_mm"]
    launches["int4_mm_wgmma"] = quant["int4"]["launches"]["int4_mm_wgmma"]
    launches["flash_decode_kv8"] = quant["mixed"]["launches"]["flash_decode_kv8"]
    launches["int8_mm"] = sum(row["launches"]["int8_mm"] for row in quant.values())
    launches["int8_mm_cluster"] = sum(row["launches"]["int8_mm_cluster"]
                                      for row in quant.values())
    launches["int8_ffn"] = sum(row["launches"]["int8_ffn"] for row in quant.values())
    launches["flash_suffix_kv8"] = quant["mixed"]["launches"]["flash_suffix_kv8"]
    cases["faststack_probe"], launches["faststack_probe"] = run_probe(
        dev, quant["mixed"]["fast_stack_ms"])
    gc.collect()  # the probe's weights go before the pool
    torch.cuda.empty_cache()
    pool = run_pool(dev, tokenizer, p1_step_ms)
    gc.collect()  # the pools go before the tools' processes
    torch.cuda.empty_cache()
    run_tools(tokenizer)
    gc.collect()  # nothing of the earlier phases stays for the checkpoint tools
    torch.cuda.empty_cache()
    for name, n in run_checkpoint_tools(dev, tokenizer).items():
        launches[name] += n
    gc.collect()  # nothing of the earlier phases stays for the mesh
    torch.cuda.empty_cache()
    cases12, launches12 = run_multidevice(dev, tokenizer)
    for name, rows in cases12.items():
        cases[name].extend(rows)
    for name, n in launches12.items():
        launches[name] += n
    gc.collect()  # nothing of the mesh stays for the evaluation tools
    torch.cuda.empty_cache()
    for name, n in run_eval_tools(dev, tokenizer, train, smi).items():
        launches[name] = launches.get(name, 0) + n
    gc.collect()  # nothing of the evaluation tools stays for fp16 serving
    torch.cuda.empty_cache()
    half_cases, half_launches = run_half(dev, tokenizer)
    cases.update(half_cases)
    launches.update(half_launches)
    for row in pool.values():
        for name in ("flash_decode", "flash_decode_kv8", "flash_prefill", "int8_mm",
                     "int8_mm_cluster", "int8_ffn", "flash_suffix_kv8"):
            launches[name] += row["launches"].get(name, 0)
    for row in batch.values():
        for name in ("flash_decode", "flash_decode_kv8", "flash_prefill", "int8_mm",
                     "int8_ffn"):
            launches[name] += row["launches"][name]
    if min(launches[n] for n in ("flash_suffix", "flash_suffix_kv8")) <= 0:
        raise SystemExit(f"a suffix route was never launched: {launches}")
    per_step = {}  # launches of each kernel in one replayed P=32 step
    for label, name, counter in (
            ("bf16", "flash_decode", "flash_decode_attention.launches"),
            ("int8", "flash_decode_kv8", "flash_decode_attention_kv8.launches"),
            ("int8", "int8_mm", "int8_matmul.launches_gemv_mma"),
            ("int8", "int8_mm_cluster", "int8_matmul.launches_gemv_cluster"),
            ("int8", "int8_ffn", "int8_ffn.launches_mma")):
        per_step[name] = pool[label]["per_step"].get(counter, 0)
    # the pools are bf16 and int8: each pool's count of the int4 tensor-core
    # route's launches in its captured step
    per_step["int4_mm_wgmma"] = max(row["per_step"].get("int4_matmul.launches_wgmma", 0)
                                    for row in pool.values())

    kernels = []
    for name, rows in cases.items():
        pick = rows[HEADLINE[name]]
        source, replaces = KERNELS[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": pick["ms"], "plain_ms": pick["plain_ms"],
            "bound_ms": pick["bound_ms"], "bound_by": pick["bound_by"],
            "library_ms": pick["library_ms"],
            "shape": pick["shape"], "cases": rows,
            **({"launches_per_p32_step": per_step[name]} if name in per_step else {}),
        })
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
