#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout
    python3 chip_smoke.py --bq-only  # phase 1 and the bq timings alone
    python3 chip_smoke.py --pp-only  # phase 1, phase 4's step, phase 7
    python3 chip_smoke.py --ckpt-only  # phase 1, phase 6's plr8 run, phase 8
    python3 chip_smoke.py --hier-only  # phase 1, phases 9 to 18
    python3 chip_smoke.py --cp-only    # phase 1 and phase 11
    python3 chip_smoke.py --serve-only # phase 1 and phase 12
    python3 chip_smoke.py --zero3-only # phase 1 and phase 13
    python3 chip_smoke.py --moe-only   # phase 1 and phase 14
    python3 chip_smoke.py --recurrent-only  # phase 1 and phase 15
    python3 chip_smoke.py --encdec-only     # phase 1 and phase 16
    python3 chip_smoke.py --pod-only        # phase 1 and phase 17
    python3 chip_smoke.py --archs-only      # phase 1 and phase 18

``--bq-only`` prints the bq kernels' timings and those of the fused TP
all-gather, TP reduce-scatter and KV-read ops beside the compositions
they replace, and stops; copied into a checkout of another commit it
times that commit's kernels the same way (an op the commit lacks is
skipped), so two trees compare in one call.

Phase 1 builds the kernels from src/repro_torch/kernels/csrc with nvcc (one
nvcc per source, all started together), in this process, before any rank
is spawned.
Phase 2 holds each kernel against its plain PyTorch version on the card,
bit for bit, at rates 4/8/16/24 on random, all-zero, extreme-magnitude and
denormal rows: encode, decode and the fused ring hops (#3 with the sum and
wire-only, #4) at M = 8, 16, 65536 and at the training step's ring shapes,
the encode also on rows whose scales span 2^-70..2^110, gather-decode on
the serving table.  It holds the flat encode and decode (the TP
all-gather's, fused with the cast, the padding and the shard layout)
against their plain versions bit for bit (NaN by position) from and to
bf16, f16 and f32 (encode also int32) at ragged n and the TP activation's
size, misaligned and strided inputs included, and the gathered decode of
two shards along every axis.  It holds the lowrank matmul's three
forms (tall M @ Q, M.T @ P as a view, the small-k reconstruction P @ Q.T)
at the training step's shape (gemma3-1b's per-rank gradient at dp 2 x tp
2 at phase 4's depth; 1051352 x 512 at 26 layers) at the plr ladder's ranks 2, 4 and 8 and at 64, and the
register-tiled tall and small_k also at 16 and 32 (each form's wide
instance below 64): equal to their plain versions on
integer operands in [-2, 2] (exact in any sum order), within
lowrank.error_bound of them and within lowrank.order_bound of the f64
product on normal operands, and a second call repeating bit for bit; it
times the plr step's Gram-Schmidt at the same shapes.  It
holds the TP reduce-scatter's shard-view forms (the view encode, the
wire-only hop reading its local chunk through the view, the fused
decode-add writing bf16, f16 or f32 to its place in the chunk) against
their plain versions bit for bit (NaN by position), every chunk of
payloads split 2, 3 and 4 ways along each axis and of the TP shapes, on
whole chunks and ring parts, and the fused KV read (gather-decode writing
bf16, f16 or f32 at a width) against gather-decode, slice and cast.  It
times every kernel and its plain version beside its bound: device time
with the L2 flushed before each call (the time the kernel line reports),
device time by CUDA-graph replay on warm L2, and the time per eager call;
the matmul forms also beside torch.matmul with TF32 off, and at_b's two
passes apart (torch.profiler's kernel times, L2 flushed; where a card's
profiler reports no device time, CUDA events around the whole call, and
the output says so).  It times the TP all-gather's encode and gathered
decode of the bf16 [2, 512, 1152] activation as the path calls them
(the fused ops), as it called them before (cast, padded copy and block
encode; block decode, strip, cast and movedim copy) and through the plain versions, with the kernels' own
times, a copy of the same bytes as the floor, and the host's time per
step of each; the same for the TP reduce-scatter's end at tp 2 (bf16
[2, 1024, 1152] and [2, 1024, 256] along axis 1: the view encode and the
fused decode-add, alone and together, against ``_split_for_scatter``,
block encode, block decode-add and ``from_blocks``) and for the paged KV
read at the serving table (the fused read against gather-decode and
cast).  It checks and times phase 18's shapes the same way: the flat
encode and decode at minitron-4b's TP gather (bf16 [2, 512, 3072]), the
view encode and fused decode-add at its TP reduce-scatter ([2, 1024,
3072] along axis 1, 24576 rows a chunk), and the fused KV read at
kimi-k2's width 224 of 256-wide tokens on an 8 x 37 table.
Phase 3 serves gemma3-1b (full published width, its first 6 layers with
the 5:1 local:global pattern kept; 26 until phase 11 came in, 13 until
phase 12) by
continuous batching over a bq8 paged KV pool, 4 requests of
520 + 8 tokens on 4 slots (8 of 560 + 24 on 8 until phase 14 came in,
4 of 560 + 8 until the remat did),
through the kernels and through their plain
versions, and its first layer alone with a dense pool (the whole model
until phase 17 came in: the check reads layer 0 only), and requires
identical tokens and pool planes between the first two and the bq8 error
bound against the third, and the KV read through the fused form only.
Phase 4 drives the main path: the compressed ZeRO-1, Megatron-SP training
step of gemma3-1b at full published width, its first 6 layers (one
5:1 local:global block; all 26 until phase 13 came in, 13 until phase 16
did; bf16 weights from a seed), 5 steps at dp 2 x tp 2 (four ranks sharing the card, exchanging
through gloo), sequence 1024, global batch 4, under zhybrid_16_8 through
the kernels, through their plain versions, and under baseline, with
deterministic algorithms and TF32 off and the exchanges timed (a device
drain before each, to split the step into compute and exchange).  It requires equal losses, grad
norms and per-dimension ledger bytes between the first two, launches of
the fused hops, of the flat encode and decode and of the view encode and
fused decode-add in the first and none in the second, no block encode or
decode-add at the TP reduce-scatters' rows, every loss finite and
within 1 % of baseline's, and the dp and zero wire bytes below baseline's
by their codecs' ratios.  Its config rematerializes every layer in
training (``remat``, on in every full-size config, as in the reference:
the layer's forward, collectives included, runs again in the backward),
and a fourth run, the kernel run for 2 steps with remat off, must give
the kernel run's first two losses and grad norms bit for bit on every
rank and more device memory allocated at the end of each forward; the
phase prints that memory, the peak GiB per rank and the priced MB per
``dim/level`` both ways.  Every later training phase rematerializes
too, and every reckoning of an in-layer site prices its forward twice.
Phase 5 runs reduce_scatter_flat and the all-reduce ring over a 4-rank
data axis at bq8, unidirectional and bidirectional, on one rank's flat
gradient from phase 4, through the kernels and the plain versions, and
requires identical sums and wires on every rank and launches of the
wire-only fused hop.
Phase 6 drives the carried-state codecs on phase 4's training step, 4
steps each: zhybrid_16_8 with plr8 on the DP gradient sync
(--codec-for 'dp@zero1_grad*=plr8') through the kernels and through their
plain versions, and ef_zhybrid_16_4 (ef:bq4) through the kernels, and
the plr8 kernel run again at its first 6 layers (phase 8's reference).
It requires equal ledger bytes and losses within PLR_RTOL between the two plr
runs, every lowrank form launched in the kernel run and nothing in the
plain run, finite and falling losses, and the dp wire bytes at plr8's and
bq4's priced ratios to phase 4's baseline.

Phase 7 drives the pipeline (the paper's PP dimension): gemma3-1b at full
published width, dp 1 x pp 2 x tp 2 (four ranks on the card), 4
microbatches of 1 x 1024 tokens, zhybrid_16_8 (bq16 on the stage
handoffs and the stage fold), deterministic: 7a 1F1B at ``--layers 4``, 2
steps (cut from 26 layers when phase 10 came in, from 16 when phase 12
did, from 8 when phase 17 did), and 7b interleaved (vpp 2, remat
per_stage:0) at ``--layers 4``, 2 steps (cut from 3 steps and 24 layers
when phase 8 came in, from 16 when phase 12 did, from 8 when phase 17
did; gemma3-1b's
5:1 local:global stack does not split into identical stages, so
``--layers`` makes it uniform), each through the kernels and
through the plain versions.  It requires equal losses, grad norms and
per-dimension ledger bytes between the two, finite losses, in the kernel
run the flat decode launched at the handoff's 4608 rows exactly once per
handoff and direction on every rank (and the flat encode at least as
often), none in the plain run, and the pp sites' priced bytes at bq16's
ratio to their payload (bf16 handoffs, the f32 fold); it prints the
bubble fraction and the stage fold's share of the step.

Phase 8 checkpoints and resumes phase 6's plr8 kernel run (gemma3-1b at
full published width, its first 6 layers, the pattern kept: 26 until
phase 12 came in; dp 2 x tp 2, deterministic; its first 2 steps are the
uninterrupted run, which phase 6's world trained apart until phase 17
came in): 8a trains 1
step with ``--ckpt-dir .smoke/ckpt --ckpt-every 1`` (a non-blocking save
of params, optimizer state and codec state, 14.9 GB at 26 layers), 8b
resumes and trains 1 step, 8c resumes from step 1 at dp 4 x tp 1 and
trains 1 step (8a and 8b trained 2 steps each until phase 14 came in);
all three run in one world of processes, each building its mesh, model
and state anew (8b and 8c restore them from the files), 8c after rank 0
has read the heartbeat and pointed the checkpoints back at step 1 (three
worlds until phase 15 came in, two until phase 17).
It checks the free disk space first and fails with the numbers when it
is short.  It requires 8a's losses and grad norms bit-equal to that
run's first step and 8b's to its second, 8b's kernel launches per step
those of that run (every lowrank form, the bq kernels), the heartbeat at
step 1,
8b's state restored, and 8c's optimizer and codec state each restored
where its global layout at dp 4 x tp 1 is the one saved and otherwise
re-initialized with the reference's ``WARNING:`` line (at full width the
ZeRO-1 chunks change and plr8's factor keeps its shape), and 8c's first
loss within 1 % of 8b's (the same params on the same batch).  It prints
the seconds in save calls, in the saving threads, waiting for them and
restoring, the bytes written and each step's seconds beside phase 6's,
and deletes the checkpoints.

Phase 9 drives the node-factored meshes (the paper's hierarchical
collectives): gemma3-1b at full published width, sequence 1024, global
batch 4, in one world of four ranks on the card: 9a ``--dp 4 --nodes 2``
(node 2 x data 2) under hier_zpp_8_16, ``--layers 6`` (at 26 the four
ranks' model copies and half-size ZeRO-1 state outgrow the card; 13
until phase 12 came in), 2
steps (the DP gradient a bq16 reduce-scatter inside the node, then a bq8
all-reduce of its half across, the param gather bq16 inside); 9b ``--tp
4 --tp-nodes 2`` (tpnode 2 x model 2) under hier_tpp_8_16, ``--layers
6`` (26 until phase 12 came in, 13 until phase 17), 2 steps (every TP
all-gather, reduce-scatter and f/g two-level, the class-C fold a
two-level all-reduce, attention in ring mode); each through the kernels
and the plain versions; and 9c ``--pp 4 --pp-nodes 2 --layers 4`` (8
until phase 17 came in), 4
microbatches, 1F1B under hier_tpp_8_16, 2 steps, through the kernels
(the middle handoff crosses a node, the other two stay inside one; the
stage fold two-level).  It requires equal losses, grad norms and ledger
between each kernel run and its plain run, finite 9c losses, and a
launch at each link level of every kernel the decomposition implies
there; it prints each run's ms/step, tokens/s, peak memory and staging
share (as phase 4), the priced wire bytes per ``dim/level``, the fast and
slow link bytes, and the launches per kernel and level.

Phase 10 drives the self-tuning controller (repro_torch.tune) in phase
9's world of four ranks: gemma3-1b at full published width, ``--dp 4
--nodes 2 --layers 6`` (the tuned sites' union codec state, the dp_inner
residual of the whole flat gradient and the dp_outer one of its half,
does not fit four ranks at 9a's 13 layers), sequence 1024, global batch
4, from hier_zpp_16_16 with ``--tune --tune-interval 2``, 8 steps (4
decision rounds), through the kernels and through the plain versions.
It requires equal decisions and rung indices on every rank and between
the two runs, losses and grad norms bit-equal before the first live plr
rung and within PLR_RTOL after, equal measured wire per ``dim/level`` at
every step, a codec changed, the last step's measured dp/outer bytes
below the first's, ``roofline.savings_report`` of the start plan against
the final one saving slow-link bytes, each rung taken launching its
kernels (rate-4 encode, fused hop and decode for ef:bq4; matmul_tall and
matmul_at_b for ef:bq4 and plr; matmul_small_k for plr), none in the
plain run, no rank importing jax or repro, and the largest rank within
18 GiB.  It prints each round's decisions, each step's rungs, time and
measured dp/inner and dp/outer bytes, ms/step, tokens/s, peak memory,
the staging share and the launches per kernel, rate and level.

Phase 11 drives context parallelism in phase 9's world of four ranks:
gemma3-1b at full published width, its first 6 layers in 11a (one 5:1
local:global block, window 512; four ranks holding the whole model and
the cp fold's flat f32 copies do not fit the card at 13) and 4 in 11b
(which holds the whole Adam state), sequence 1024, global batch 4, 2
steps each: 11a ``--dp 2 --cp 2`` under zhybrid_16_8
(each rank attends over its zigzag 2 x 256 tokens, the K/V blocks ride
the cp ring in bf16 at rate 16, the cp fold and the DP sync on the block
forms) through the kernels and the plain versions, and 11b ``--cp 4
--cp-nodes 2`` under hier_tpp_8_16 (two hops inside a node at bq16, two
across at bq8, the cp fold RS(inner) -> AR(outer) -> AG(inner)) through
the kernels.  It requires 11a's kernel run equal to its plain run
(losses, grad norms, ledger per dim and ``dim/level``, link bytes),
finite losses, priced cp bytes and no pp bytes, 11b's ``cp/outer`` bytes
below what ``baseline`` prices for the same events, a launch at each
link level of every kernel its decomposition implies there (CP_LEVELS),
none in the plain run; it prints each run's ms/step, tokens/s, peak
memory, staging share, the cp fold's seconds (``comms.span``), the
priced and measured wire per ``dim/level``, and ``cp_ring_seconds`` at
the assumed link rates of phase 10.

Phase 12 drives the rest of serving in phase 9's world of four ranks
after phase 11 (its training state freed): gemma3-1b at full published
width, its first 6 layers (one 5:1 local:global block, window 512; all
26 took 635.7 s), bf16, prompts of 512 tokens, 16 tokens generated: 12a ``--mode batched --dp 2 --tp 2``
under zhybrid_16_8, batch 4 (ring attention, the flash-decoding combine
at bq16), 12b ``--mode batched --tp 4 --tp-nodes 2`` under hier_tpp_8_16,
12c ``--mode paged --dp 4 --kv-codec bq8``, 16 requests of 64-128
tokens on 8 slots (128-320 until phase 18 came in), 12d ``--mode disagg --dp 1 --tp 2 --kv-codec bq8``,
batch 4; 12a, 12c and 12d through the kernels and the plain versions,
12b through the kernels.  It requires the kernel run equal to the plain
run bit for bit (tokens, every cache leaf and pool plane after the
prefill, the handoff and the last step), a launch at each link level of
every kernel SERVE_LEVELS names, none in the plain runs, 12d's handoff
all ``kv`` and below the bytes the same scheme prices with a ``none`` kv
codec; it prints each run's prefill seconds, decode ms/step, generated
tokens/s, peak memory, staging share, priced MB per ``dim/level`` of the
prefill and of one decode step, 12d's handoff MB and
``kv_handoff_seconds`` at the assumed link rates of phase 10, and 12c's
``kv_hbm_bytes`` beside the pool's allocated bytes.

Phase 13 drives another dense decoder and ZeRO-3 in phase 9's world of
four ranks after phase 12: gemma3-4b at full published width (head
attention at tp 2), its first 6 layers (one 5:1 local:global block,
window 1024), bf16, sequence 1024, global batch 4: 13a ``--dp 2 --tp 2``
under zhybrid_16_8 with ZeRO-3 on (``fsdp_params=True``, a train_rank
override; every class-A leaf re-gathered at the zero site under bq16 and
its gradient reduce-scattered back), 2 steps (3 until phase 18 came
in), through the kernels, 13b
the same through the plain versions, and 13c paged serving ``--dp 2 --tp
2 --kv-codec bq8``, 4 requests of 64-128 tokens plus 8 generated on 4
slots, kernels and plain.  It requires 13a equal to 13b (losses, grad
norms, ledger per dim and ``dim/level``), finite losses, priced zero
bytes, the flat encode and decode and the view encode and fused
decode-add launched at the class-A shards' rows at rate 16 (the
gather's flat forms twice for each reduce-scatter: the remat re-gathers
each shard in the backward), 13c's kernel
run equal to its plain run bit for bit (tokens, every pool plane by
sha256) with the pool write and KV read launched, and nothing launched
in the plain runs; it prints ms/step, tokens/s, peak memory, staging
share, the priced MB per ``dim/level`` beside what ZeRO-1 would price for
the dp and zero dims of the same step, the zero site's launches, and
13c's decode numbers.

Phase 14 drives Mixture-of-Experts in phase 9's world of four ranks
after phase 13: qwen3-moe-235b-a22b at full published width (d 4096, 64
q and 4 kv heads of 128, qk-norm; experts of d_ff 1536, top-8, capacity
factor 1.25; vocab 151936, untied), bf16, seed 0: 14a ``--dp 2 --tp 2``
under zhybrid_16_8 (the ep all-to-alls on bq16 both ways) with the
config's own ZeRO-3 (the expert leaves sharded over data), its first
layer (2 until phase 17 came in) and its expert count cut from 128 to 16 (8 a rank; 128 do not
fit training), sequence 1024, global batch 4, 3 steps, through the
kernels; 14b the same through the plain versions; 14c the batched dense
Server at ``--tp 4`` with all 128 experts (32 a rank), its first
layer, two prompts of 512 tokens plus 16 generated, kernels and plain.  It requires 14a equal to 14b
(losses, grad norms, the load-balance loss and drop fraction per step,
ledger per dim and ``dim/level``), finite losses, the priced ``ep`` bytes
equal to their reckoning (two bq16 all-to-alls a layer of the [E * C,
D] dispatch buffer, each priced forward, again in the remat and
backward, half of each crossing), priced zero bytes, the block
encode and decode launched at the ep sites' rows exactly six times a
layer per rank per step, 14c's kernel run equal to its plain run (tokens,
every cache leaf after the prefill and at the end by sha256), and nothing
launched in the plain runs; it prints ms/step, tokens/s, peak memory,
staging share, the priced MB per ``dim/level`` beside the ep reckoning,
``lb_loss`` and ``drop_frac`` per step, the ep sites' launches and 14c's
prefill and decode numbers.

Phase 15 drives the recurrent families in phase 9's world of four
ranks after phase 14, bf16 random weights from seed 0, sequence 1024,
global batch 4, ``--dp 2 --tp 2`` under zhybrid_16_8, 2 steps: 15a
zamba2-1.2b at full published width (d 2048, d_inner 4096, 64 SSM heads
of 64, state 64, conv kernel 4; the shared block's 32 q and kv heads of
64 and swiglu MLP of 8192; vocab 32000, tied), its first ``[6 x
mamba, shared_attn]`` block (6 mamba layers, the shared block applied
once; 12 and twice until phase 16 came in; ``depth``:
``ArchConfig.truncated`` keeps whole hybrid blocks), through the
kernels; 15b the same through the plain versions; 15c and
15d xlstm-1.3b at full published width (d 2048, 4 heads of 512, value
width 4096, LayerNorm; vocab 50304, tied), its first 8 layers (7 mLSTM,
1 sLSTM), kernels and plain (``B_loc`` 2 at tp 2: the sLSTM's all-to-all
path); 15e both models in the batched dense Server at ``--dp 2 --tp 2``,
4 prompts of 512 tokens plus 16 generated, kernels and plain.  It
requires the kernel runs equal to the plain runs (losses, grad norms,
ledger per dim and ``dim/level``; tokens and every cache leaf after the
prefill and at the end by sha256), finite losses, the priced bytes of the
state prefix (``pp@ssm_scan``), the conv halo (``pp@conv_halo``) and the
sLSTM transpose (``ep@slstm_transpose``) equal to their reckoning
(``rec_reckoned``), the flat encode and decode launched at the prefix's
and the halo's rows and the block encode and decode at the transpose's,
and nothing launched in the plain runs; it prints ms/step, tokens/s, peak
memory, staging share, the priced and measured MB per ``dim/level``
beside the reckoning, the sites' launches, the prefill seconds and
decode ms per step, and the phase's seconds.

Phase 16 drives the encoder-decoder family in phase 9's world of four
ranks after phase 15: whisper-base at its full published width and
depth (6 encoder and 6 decoder layers, d 512, 8 q and 8 kv heads of 64,
so head attention at tp 2; d_ff 2048 gelu, LayerNorm; vocab 51865 padded
to 51968, tied), bf16 random weights from seed 0, sequence 448 (the
decoder's context) with stub frames of the same length (the reference
ties them: the one cut), global batch 4, ``--dp 2 --tp 2`` under
zhybrid_16_8: 16a 2 steps through the kernels, 16b the same through the
plain versions, 16c the batched dense Server, 4 prompts of 432 tokens
plus 16 generated (s_max 448), the frames from the seed, kernels and
plain.  It requires 16a equal to 16b (losses, grad norms, ledger per dim
and ``dim/level``), finite losses, ``tp@attn_cross_kv``'s priced bytes
equal to their reckoning (``encdec_reckoned``: each decoder layer
gathers the encoder's [2, 224, 512] slice, ``tp - 1`` hops forward and
back), the flat encode and decode launched at that gather's rows, 16c's
kernel run equal to its plain run (tokens, every cache leaf after the
prefill and at the end by sha256, the cross-attention's ``xk``, ``xv``
and ``xlen`` among them), nothing launched in the plain runs and no
rank importing jax or repro; it prints ms/step, tokens/s, peak memory,
staging share, the priced and measured MB per ``dim/level`` beside the
reckoning, the launches at the cross gather's rows, the prefill seconds,
decode ms per step and generated tokens/s, and the phase's seconds.

Phase 17 runs in phase 9's world of four ranks after phase 16: 17a
gemma3-1b at full width, its first 6 layers, ``--pod 2 --dp 2 --tp 1``
(the outer data-parallel pod axis: the ZeRO-1 chunk of the data
reduce-scatter all-reduces over the pods at ``dp@zero1_grad_pod``) under
zhybrid_16_8, seq 1024, global batch 4, 3 steps, through the kernels,
17b the same through the plain versions, beside a ``--dp 4`` run of the
same scheme and data; 17c the long-context decode, gemma3-1b at full
width, its first 6 layers (one 5:1 local:global block; all 26 until phase
18 came in), served by ``Server(seq_axes=("data", "model"))`` at dp 2
x tp 2, a batch of one against 524288 positions (131072 a rank), the
cache filled with seeded values to 8 short of the end in place of a
prefill, 8 tokens decoded, through the kernels, 17d the same plain.  It
requires 17a equal to 17b (losses, grad norms, ledger per ``dim/level``),
finite falling losses within 1 % of ``--dp 4``'s, the ZeRO-1 sites'
priced bytes equal to ``pod_reckoned``, #1-#4 launched in 17a (#3 with
the sum: the pod all-reduce's tail) and nothing in 17b; 17c equal to 17d
(tokens, every cache leaf after the fill and at the end by sha256),
``tp@attn_combine`` priced as ``long_reckoned`` (the flash-decoding
combine over data, then model).  17e, the dry-run of gemma3-1b's four
cells on pod16x16 and pod2x16x16 on meta tensors (``repro_torch.launch.
dryrun``), runs in a process of its own (``--dryrun FILE``) beside the
world from the start of phase 9, and every cell must trace; its
records and the report's tables are printed.  Phase 17 prints ms/step,
tokens/s, peak memory, staging share, the priced MB per site beside the
reckoning, the decode ms per step, the cache bytes a rank, the dry-run's
seconds, and the whole step's share of the H100's dense bf16 peak (model
FLOPs per device over the measured step time over 989e12, per rank and
for the one card all ranks share) for 17a and phase 4.

Phase 18 runs in phase 9's world of four ranks after phase 17, each
rank's allocator capped at ARCH_FRACTION of the card in its training
runs (uncapped, 18a ran out of memory in that world and in one of its
own): the four
architectures that had run on the CPU only, each at its full published
width and its first 2 layers (the one cut), bf16 random weights from
seed 0, under zhybrid_16_8.  18a minitron-4b (d 3072, 24 q and 8 kv heads
of 128, head attention at tp 2; relu² MLP of 9216; vocab 256000, untied)
``--dp 2 --tp 2`` with the config's ZeRO-1 and remat, sequence 1024,
global batch 4, 2 steps, through the kernels, 18b the same through the
plain versions; 18c minitron-4b served paged at ``--dp 2 --tp 2`` with a
bq8 pool, phase 13c's four requests of 64-128 tokens plus 8 on 4 slots;
18d qwen2-72b served paged at ``--tp 4`` (2 kv heads of 128 a rank),
bq8 pool, the same requests, and qwen2-vl-72b batched at ``--tp 4``, two
prompts of 512 plus 16 generated, its M-RoPE ids in the prefill and in
every decode step; 18e kimi-k2-1t-a32b (the dense layer, then the first
MoE layer with all 384 experts, 96 a rank, top-8, the shared expert)
served paged at ``--tp 4`` with a bq8 pool (2 kv heads of 112 a rank: the
fused KV read takes 224 values of a 256-wide token row), the same
requests; each served run through the kernels and the plain versions.
It requires 18a equal to 18b (losses, grad norms, ledger per dim and
``dim/level``), finite losses, the training step's kernels launched
(ARCH_KERNELS) and no block form at the TP reduce-scatters' rows; each
served run's kernel run equal to its plain run (tokens, every cache leaf
or pool plane by sha256), the pool write and the fused KV read launched
in the paged runs and the TP collectives' kernels in the batched one,
18e's ep all-to-alls' block encode and decode at their rows
(``arch_ep_rows``) twice a decode step on every rank, nothing launched in
a plain run and no rank importing jax or repro; it prints ms/step,
tokens/s, peak memory, staging share and priced MB per ``dim/level`` of
the training runs, the prefill seconds, decode ms per step, generated
tokens/s, peak memory and priced MB of the served runs, the paged pools'
bytes beside ``roofline.kv_hbm_bytes``, and the phase's seconds.  Training
qwen2-72b, qwen2-vl-72b or kimi-k2 at full width fits no single card: the
untied tables and heads alone need about 77 and 73 GiB of training state.

After phase 8, a fresh process (this script with ``--reckon FILE``, which
the script starts itself) times each (kernel, rows, rate) that phase 4's
kernel run launched, at its shape, and reckons launches x (time - bound)
per rank per step.

Every line with a number carries the card's name and power limit.  Before
the last line come the kernel JSON (all six kernels: launches on their
path, cold-L2 device time at the path's shape, bound, plain time, and the
library call's time where one exists; the encode and decode also with
their flat form, the encode and decode-add with the TP reduce-scatter's
view forms, the gather-decode's times those of the fused KV read, and
the bq kernels with the per-shape reckoning, phase 10's launches by
rate and level, phase 13's at the zero site, phase 14's at the ep
sites, phase 15's at the recurrent sites, phase 16's at the cross
gather's rows, phase 17's by run and level and phase 18's by run, level
and 18e's ep rows) and the card line; the last
line is the result JSON.  Any failure exits non-zero;
without a card, or outside a checkout, it fails before printing a result.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (data sheet)
F32_OPS_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
L2_FLUSH_BYTES = 256 << 20    # five times the H100's 50 MB L2
SPIN_CYCLES = 2_000_000       # about 1 ms of the card's clock
BITS = (4, 8, 16, 24)
MAIN_BITS = 8                 # the serving pool is bq8

# serving: gemma3-1b, 4 slots, 16-token blocks, 520 + 8 (prompts just past
# the 512 window: 560 until the remat came in, each prompt token a decode
# step); its first 6 layers (one 5:1 block, the pattern kept: cut
# from 26 to 13 to pay for phase 11's runs, about half of phase 3's 199 s,
# and from 13 to 6 for phase 12's); 8 slots and 560 + 24 until phase 14
# came in; the dense run on layer 0 alone since phase 17 came in
SLOTS, BLOCK_TOKENS, PROMPT, GEN, SEED = 4, 16, 520, 8, 0
SERVE_LAYERS = 6
# main path: the training step at full width, its first 6 layers (one
# 5:1 local:global block, the pattern kept; all 26 until phase 13 came in:
# at 26 phase 4 took 151.3 s and phase 6, on the same step, 102.7 s of the
# script's 1047.1 s; 13 until phase 16 came in: at 13 phase 4 took 128.3
# s, phase 6 91.0 s and phase 2's block-form checks, at phase 4's ring
# rows, 75.5 s of 1199.7 on a slow host)
DP, TP, STEPS, SEQ, GLOBAL_BATCH = 2, 2, 5, 1024, 4
MAIN_DEPTH = 6
# phase 4's kernel run again with remat off (its config's is on), for
# these steps: the losses equal, the memory at the end of the forward
REMAT_OFF_STEPS = 2
RING_WORLD = 4                # phase 5's data axis
STATEFUL_STEPS = 4            # phase 6
PLR = ["--codec-for", "dp@zero1_grad*=plr8"]
# plr8 kernel run vs plain run: the matmuls sum in other orders (each
# within lowrank.error_bound), so losses and grad norms agree to this
PLR_RTOL = 1e-4
MM_FORMS = ("tall", "at_b", "small_k")
# ranks each form is checked and timed at: the plr ladder's ranks 2, 4
# and 8 (tune.ladder.PLR_RANKS) and the widest, 64; the register-tiled
# forms also at 16 and 32 (their wide instance below 64)
MM_RANKS = {"tall": (2, 4, 8, 16, 32, 64), "at_b": (2, 4, 8, 64),
            "small_k": (2, 4, 8, 16, 32, 64)}
SCRATCH = ROOT / ".smoke"     # git-ignored: phase 4's flat gradient
CKPT_DIR = SCRATCH / "ckpt"   # phase 8's checkpoints
CKPT_STEPS = 1                # phase 8: save after 8a's step (2 until
#                               phase 14 came in)
# phase 8 checkpoints phase 6's plr8 step at its first 6 layers (one 5:1
# block, the pattern kept; cut from 26 when phase 12 came in), against
# the first 2 * CKPT_STEPS steps of phase 6's uninterrupted plr8 kernel
# run (at MAIN_DEPTH, which CKPT_DEPTH must equal)
CKPT_DEPTH = MAIN_DEPTH
# phase 7: the pipeline, dp 1 x pp 2 x tp 2, 4 microbatches of 1 x SEQ;
# (name, layers, steps, flags) of its two runs
PP, PP_MICRO = 2, 4
# (--layers 8 until phase 17 came in; 4 is one layer a virtual stage of
# 7b)
PP_RUNS = (("7a", 4, 2, ()),
           ("7b", 4, 2, ("--vpp", "2", "--remat-policy", "per_stage:0")))
# wire rows of one handoff: a microbatch's bf16 [1, SEQ / TP, 1152]
HANDOFF_ROWS = (GLOBAL_BATCH // PP_MICRO) * (SEQ // TP) * 1152 // 128
# the stage-replicated leaves' fold: the tied embedding's vocab shard and
# the final norm
STAGE_FOLD_ELEMS = 262144 // TP * 1152 + 1152
# phase 9: node-factored meshes, four ranks; (name, scheme, steps, flags,
# with a plain run) of its runs.  9a holds the whole model on each of four
# ranks and half the ZeRO-1 state: at 26 layers the four need more than
# the card's 80 GB (the Adam update ran out at 18.7 GiB per rank), so its
# depth is cut to 13 (uniform global attention), its width kept, and to
# 6 when phase 12 came in (the script's time); 9b's from 13 to 6 and 9c's
# from 8 to 4 (one layer a stage) when phase 17 came in
HIER_RUNS = (
    ("9a", "hier_zpp_8_16", 2, ("--dp", "4", "--tp", "1", "--nodes", "2",
                                "--layers", "6"), True),
    ("9b", "hier_tpp_8_16", 2, ("--dp", "1", "--tp", "4", "--tp-nodes", "2",
                                "--layers", "6"), True),
    ("9c", "hier_tpp_8_16", 2, ("--dp", "1", "--tp", "1", "--pp", "4",
                                "--pp-nodes", "2", "--layers", "4",
                                "--microbatches", "4"), False))
# the kernels each run's decomposition launches at each link level: the
# rings of two ranks encode on their first hop and decode-add on their
# last (a reduce-scatter's block or view form; an all-reduce's with the
# sum, whose compressed chunk is then gathered and decoded); the
# all-gathers and handoffs encode and decode a bf16 activation (the flat
# forms)
_DP_AR = {"outer": {"bq_encode", "bq_decode_add_encode", "bq_decode"}}
_BLOCK_RS_AG = {"bq_encode", "bq_decode_add", "bq_decode"}
HIER_LEVELS = {
    # DP: RS(data, bq16) -> AR(node, bq8) -> hpZ AG(data, bq16)
    "9a": {"inner": _BLOCK_RS_AG, **_DP_AR},
    # TP: gathers and reduce-scatters of activations at both levels, the
    # class-C fold's RS -> AR -> AG on blocks
    "9b": {"inner": {"bq_encode_flat", "bq_decode_flat", "bq_encode_view",
                     "bq_decode_add_flat"} | _BLOCK_RS_AG,
           "outer": {"bq_encode_flat", "bq_decode_flat", "bq_encode_view",
                     "bq_decode_add_flat"} | _DP_AR["outer"]},
    # PP: handoffs inside and across nodes, the stage fold's RS -> AR -> AG
    "9c": {"inner": {"bq_encode_flat", "bq_decode_flat"} | _BLOCK_RS_AG,
           "outer": {"bq_encode_flat", "bq_decode_flat"} | _DP_AR["outer"]},
}
# phase 10: the self-tuning controller on 9a's mesh (--dp 4 --nodes 2, in
# phase 9's world), from hier_zpp_16_16 with a decision round every 2
# steps, 8 steps (4 rounds), through the kernels and the plain versions.
# Its depth: the tuned sites' union slots add the dp_inner residual (the
# rank's whole f32 flat gradient) and the dp_outer residual (its half) to
# 9a's state; at 9a's 13 layers (14.8 GiB per rank) that is about 18.4 GiB
# per rank before any transient, which four ranks sharing the card do not
# fit, so 6 layers (463M parameters per rank), the width kept
TUNE_SCHEME, TUNE_LAYERS, TUNE_STEPS, TUNE_INTERVAL = \
    "hier_zpp_16_16", 6, 8, 2
TUNE_FLAGS = ("--dp", "4", "--tp", "1", "--nodes", "2", "--layers",
              str(TUNE_LAYERS), "--tune", "--tune-interval",
              str(TUNE_INTERVAL))
TUNE_PEAK_GIB = 18.0          # the largest rank's allowance
# phase 11: context parallelism in phase 9's world of four ranks, gemma3-1b
# at full width with its 5:1 local:global pattern (window 512) kept, seq
# 1024, global batch 4: 11a --dp 2 --cp 2 under zhybrid_16_8 (each rank
# attends over its zigzag 2 x 256 tokens, K/V ride the cp ring in bf16 at
# rate 16) through the kernels and the plain versions, 11b --cp 4
# --cp-nodes 2 under hier_tpp_8_16 (hops and the cp fold inside and across
# nodes) through the kernels.  Depth: 11a holds the whole model per rank
# and half the ZeRO-1 state, as 9a, which peaked at 14.8 GiB per rank at
# 13 layers; the cp fold adds a flat f32 copy of every gradient and its
# sum (about 2.6 GB each at 13 layers), about 20 GiB per rank, which four
# ranks sharing the card do not fit, so 11a keeps the first 6 layers (one
# 5:1 block, 463M parameters; ``depth``, the pattern kept): 11.73 GiB per
# rank.  11b (dp 1) holds the whole Adam state: at 6 layers a rank ran out
# of memory in the Adam update (16.45 GiB allocated and 1.73 GiB more
# asked, with the update's temporaries then all alive), so it keeps the
# first 4 (local) layers, 409M parameters: 14.55 GiB per rank with the
# temporaries freed as used (NVIDIA H100 80GB HBM3, 700.00 W).  (name,
# scheme, steps, flags, with a plain run, depth), 2 steps each
CP_RUNS = (
    ("11a", "zhybrid_16_8", 2, ("--dp", "2", "--tp", "1", "--cp", "2"),
     True, 6),
    ("11b", "hier_tpp_8_16", 2, ("--dp", "1", "--tp", "1", "--cp", "4",
                                 "--cp-nodes", "2"), False, 4))
# the kernels each cp run launches at each link level: the K/V hops encode
# and decode bf16 blocks on the flat forms; the cp fold is an all-reduce
# (11a: over two ranks, its hop with the sum; 11b: RS(inner) -> AR(outer)
# -> AG(inner)), and 11a's DP sync a reduce-scatter and a gather
CP_LEVELS = {
    "11a": {"flat": {"bq_encode_flat", "bq_decode_flat", "bq_encode",
                     "bq_decode_add_encode", "bq_decode_add", "bq_decode"}},
    "11b": HIER_LEVELS["9c"],
}
# link rates the slow-link saving's seconds are priced at (nominal: one
# direction of H100 NVLink 4, one 400 Gb/s InfiniBand port; assumed, not
# measured: the check itself is on bytes)
FAST_LINK_BYTES_PER_S, SLOW_LINK_BYTES_PER_S = 450e9, 50e9
# phase 12: serving in phase 9's world of four ranks after phase 11,
# gemma3-1b at full width, bf16, prompts of 512 tokens, 16 generated.  At
# all 26 layers the phase took 635.7 s alone (NVIDIA H100 80GB HBM3,
# 700.00 W): 12c's 1032 prompt-streaming steps at 257 ms (four ranks'
# eager launches sharing the card) were 530 s of it, and a decode step of
# 12a took 799 ms; the script has no such room, so every run keeps the
# first 6 layers (one 5:1 local:global block, window 512; ``depth``, the
# pattern kept), which memory never forced: at 26 layers a rank peaked at
# 1.41-3.04 GiB.  Per rank, by reckoning at 26 layers: 12a's dense cache
# is 26 x 2 x 264 x 256 x 2 B, about 7 MB for K and V (2 rows, s_max 528
# over tp 2, 1 KV head of 256); its prefill logits 2 x 512 x 131072 x 4
# B, 0.54 GB; a paged rank of 12c holds the whole model, about 2 GB.
# (name, serve_rank keywords, with a plain run)
SERVE_PROMPT, SERVE_GEN, SERVE_BATCH, SERVE_DEPTH = 512, 16, 4, 6
# 12c's prompts: 16 requests on 8 slots (each slot serves two: slot and
# block reuse over the data ranks); 64-128 tokens each since phase 18 came
# in (256-560 streamed 1032 steps, 125 s of the script for the kernel and
# plain runs; 128-320 595 steps, about 76 s; phase 3 holds prompts past
# the 512 window on the paged read)
PAGED_REQUESTS, PAGED_SLOTS, PAGED_LENS = 16, 8, (64, 128)
SERVE_RUNS = (
    ("12a", dict(mode="batched", dp=2, tp=2, scheme="zhybrid_16_8"), True),
    ("12b", dict(mode="batched", tp=4, tp_nodes=2, scheme="hier_tpp_8_16"),
     False),
    ("12c", dict(mode="paged", dp=4, kv_codec="bq8", slots=PAGED_SLOTS),
     True),
    ("12d", dict(mode="disagg", tp=2, kv_codec="bq8"), True))
# the kernels each serving run launches at each link level: 12a's
# prefill gathers (flat forms) and reduce-scatters (view forms) at bq16,
# its decode all-reduces (block encode, the hop with the sum, decode);
# 12b's at both levels; 12c's pool writes and fused KV reads; 12d's
# handoff (flat forms at bq8)
SERVE_LEVELS = {
    "12a": {"flat": {"bq_encode_flat", "bq_decode_flat", "bq_encode_view",
                     "bq_decode_add_flat", "bq_encode",
                     "bq_decode_add_encode", "bq_decode"}},
    "12b": {"inner": {"bq_encode_flat", "bq_decode_flat"},
            "outer": {"bq_encode_flat", "bq_decode_flat",
                      "bq_decode_add_encode"}},
    "12c": {"flat": {"bq_encode", "bq_gather_decode"}},
    "12d": {"flat": {"bq_encode_flat", "bq_decode_flat"}},
}
# phase 13: another dense decoder and ZeRO-3 in phase 9's world of four
# ranks after phase 12: gemma3-4b at full published width (d 2560, 8 q and
# 4 kv heads of 256, so head attention at tp 2; d_ff 10240 geglu, vocab
# 262144), its first 6 layers (one 5:1 local:global block, window 1024;
# ``depth``, the pattern kept), bf16, seq 1024, global batch 4.  13a ``--dp
# 2 --tp 2`` under zhybrid_16_8 with ZeRO-3 on (``fsdp_params=True``, a
# train_rank override, as the reference's tests turn it on for a config
# that ships without it: every class-A leaf is re-gathered at the zero
# site under bq16, its gradient reduce-scattered back), 2 steps (3 until
# phase 18 came in), through the kernels; 13b the same through the plain
# versions; 13c paged serving,
# bq8 pool, 4 requests of 64-128 tokens plus 8 generated on 4 slots, at
# ``--dp 2 --tp 2`` (the world's four ranks: a dp 1 x tp 2 run would need
# a world of its own), kernels and plain: the first paged run at tp > 1.
Z3_ARCH, Z3_DEPTH, Z3_STEPS, Z3_SCHEME = "gemma3-4b", 6, 2, "zhybrid_16_8"
Z3_FLAGS = ("--dp", "2", "--tp", "2")
Z3_REQUESTS, Z3_SLOTS, Z3_LENS, Z3_GEN = 4, 4, (64, 128), 8
Z3_SERVE = dict(mode="paged", dp=2, tp=2, kv_codec="bq8", slots=Z3_SLOTS)
# the kernels 13a launches at the zero site (each leaf's shard encoded and
# its gathered shards decoded on the flat forms, the backward's
# reduce-scatter on the view forms), and 13c's at tp 2
Z3_ZERO_KERNELS = ("bq_encode_flat", "bq_decode_flat", "bq_encode_view",
                   "bq_decode_add_flat")
Z3_SERVE_KERNELS = {"bq_encode", "bq_gather_decode"}
# phase 14: Mixture-of-Experts in phase 9's world of four ranks after phase
# 13: qwen3-moe-235b-a22b at full published width (d 4096, 64 q and 4 kv
# heads of 128 with qk-norm, so head attention at tp 2 and tp 4; experts
# of d_ff 1536, top-8, capacity factor 1.25; vocab 151936, untied), bf16,
# seed 0.  14a ``--dp 2 --tp 2`` under zhybrid_16_8 (the ep all-to-alls at
# bq16 both ways), the config's own ZeRO-3 (``fsdp_params``: the expert
# leaves sharded over data), seq 1024, global batch 4, 3 steps, through
# the kernels; its expert count cut from 128 to 16 (8 a rank at ep 2, the
# config's own 8 experts a chip): one full-width layer of 128 experts
# holds 2.42 B expert parameters, over 100 GB of training state at
# phase 13's 38 B a parameter.  Its first layer (``depth``): a rank
# ran out of memory in the ZeRO-1 gather of the first step at 2 layers
# (16.39 GiB
# allocated and 2.32 GiB more asked, the four ranks holding 77.77 GiB) and
# at 1 (14.04 GiB and 2.32 more, 77.19 GiB; NVIDIA H100 80GB HBM3, 700.00
# W) while the Adam update kept the old f32 master and moments of the
# untied table and head (622 M parameters a rank) beside the new ones; it
# writes them in place since.  14b the same through the plain versions.
# 14c the batched dense Server at ``--tp 4`` (ep 4, 32 experts a rank)
# with all 128 experts, its first layer, two prompts of 512 tokens plus
# 16 generated, kernels and plain.
# (14a-14c at 2 layers until phase 17 came in: qwen3-moe's layers are
# alike, each an attention and an MoE block)
MOE_ARCH, MOE_DEPTH, MOE_EXPERTS, MOE_STEPS, MOE_SCHEME = \
    "qwen3-moe-235b-a22b", 1, 16, 3, "zhybrid_16_8"
MOE_SERVE_DEPTH = 1
MOE_FLAGS = ("--dp", "2", "--tp", "2")
MOE_SERVE = dict(mode="batched", tp=4, scheme="zhybrid_16_8", batch=2)
# the ep sites' block encode and decode: the [E * C, D] dispatch buffer of
# one rank (C = 640 for 2 x 512 tokens), split over ep = 2 ranks, launched
# whole (both chunks, 163840 rows each) at rate 16
MOE_EP_ROWS = 2 * (MOE_EXPERTS * 640 * 4096 // 2) // 128


# phase 15: the recurrent families in phase 9's world of four ranks after
# phase 14, bf16, seed 0, seq 1024, global batch 4, --dp 2 --tp 2 under
# zhybrid_16_8 (the state prefix, the conv halo and the sLSTM transpose on
# bq16 both ways), 2 steps, kernels and plain.  Width is the published
# one; depth is the only cut, for the script's time (about 265 s were
# left of its 1200): zamba2's first two [6 x mamba, shared_attn] blocks
# (12 of its 38 mamba layers, the shared block applied twice) and
# xLSTM's first 8 layers (7 mLSTM, 1 sLSTM: one of its six blocks).
# zamba2's depth was cut to its first whole [6 x mamba, shared_attn] block
# (6 mamba layers, the shared block once) when phase 16 came in.
# (train label, plain label, arch, depth); 15e serves each at its depth
REC_RUNS = (("15a", "15b", "zamba2-1.2b", 6),
            ("15c", "15d", "xlstm-1.3b", 8))
REC_SCHEME, REC_STEPS = "zhybrid_16_8", 2
REC_DP, REC_TP = 2, 2
REC_FLAGS = ("--dp", str(REC_DP), "--tp", str(REC_TP))
REC_SERVE = dict(mode="batched", dp=REC_DP, tp=REC_TP, scheme=REC_SCHEME,
                 batch=4)


# phase 16: the encoder-decoder family in phase 9's world of four ranks
# after phase 15: whisper-base at its full published width and depth (6
# encoder and 6 decoder layers, d 512, 8 q and 8 kv heads of 64, so head
# attention at tp 2; d_ff 2048 gelu, LayerNorm; vocab 51865 padded to
# 51968, tied; 70.7 M parameters), bf16, seed 0.  The sequence is
# whisper's decoder context, 448 tokens (n_text_ctx); the stub frames have
# the same length, since the reference's backbone ties the encoder's
# length to the decoder's (``encoder_seq`` 0): the one cut (whisper's
# encoder takes 1500 frames).  16a ``--dp 2 --tp 2`` under zhybrid_16_8,
# global batch 4, 2 steps, through the kernels; 16b the same through the
# plain versions; 16c the batched Server at ``--dp 2 --tp 2``, 4 prompts
# of 432 tokens plus 16 generated (s_max 448), the frames from the seed,
# kernels and plain.
ENC_ARCH, ENC_SEQ, ENC_STEPS, ENC_SCHEME = "whisper-base", 448, 2, \
    "zhybrid_16_8"
ENC_DP, ENC_TP = 2, 2
ENC_FLAGS = ("--dp", str(ENC_DP), "--tp", str(ENC_TP), "--seq",
             str(ENC_SEQ))
ENC_SERVE = dict(mode="batched", dp=ENC_DP, tp=ENC_TP, scheme=ENC_SCHEME,
                 batch=4, prompt_len=432, gen=16, depth=0)

# phase 17: the outer data-parallel pod axis, the long-context decode and
# the dry-run, in phase 9's world of four ranks after phase 16.  17a
# gemma3-1b at full published width, its first 6 layers (the 5:1 pattern
# kept), ``--pod 2 --dp 2 --tp 1`` under zhybrid_16_8, seq 1024, global
# batch 4, 3 steps, through the kernels; 17b the same through the plain
# versions; beside them a ``--dp 4`` run of the same scheme on the same
# data (the losses' yardstick).  17c gemma3-1b at full width, its first 6
# layers (one 5:1 local:global block, the pattern kept; all 26 until phase
# 18 came in: 17c and 17d took about 68 s of the script at 26), served by
# ``Server(seq_axes=("data", "model"))`` at dp 2 x tp 2 (ring
# mode: one KV head), a batch of one against the long_500k cell's 524288
# positions (131072 a rank): the cache filled with seeded values to 8
# short of the end (a prefill of 524288 tokens is beyond eager
# attention), then 8 tokens decoded, kernels; 17d the same, plain.  17e
# the dry-run of gemma3-1b's four cells on pod16x16 and pod2x16x16, traced
# on meta tensors in a process of its own on the host, beside the world.
POD_ARCH, POD_DEPTH, POD_STEPS, POD_SCHEME = "gemma3-1b", 6, 3, \
    "zhybrid_16_8"
POD, POD_DP = 2, 2
POD_FLAGS = ("--pod", str(POD), "--dp", str(POD_DP), "--tp", "1")
POD_BASE_FLAGS = ("--dp", str(POD * POD_DP), "--tp", "1")
LONG_DP, LONG_TP, LONG_S, LONG_GEN, LONG_DEPTH = 2, 2, 524288, 8, 6
LONG_SERVE = dict(mode="batched", dp=LONG_DP, tp=LONG_TP,
                  scheme="zhybrid_16_8", depth=LONG_DEPTH, batch=1,
                  prompt_len=2,
                  gen=LONG_GEN + 1, max_len=LONG_S, fill=LONG_S - LONG_GEN,
                  seq_axes=("data", "model"))
DRY_ARCH = "gemma3-1b"

# phase 18: the four architectures that had run on the CPU only, in phase
# 9's world of four ranks after phase 17, bf16 random weights from seed 0,
# each at its published width and its first 2 layers (the one cut), under
# zhybrid_16_8.  18a minitron-4b (d 3072, 24 q and 8 kv heads of 128, so
# head attention at tp 2; relu² MLP of 9216; vocab 256000, untied; the
# config's ZeRO-1 and remat) ``--dp 2 --tp 2``, seq 1024, global batch 4,
# 2 steps, through the kernels; 18b the same through the plain versions
# (by reckoning 0.87 B parameters a rank: about 12 GB of parameters,
# gradients, flat gradient and Adam chunk, and 1.05 GB of f32 logits);
# 18c minitron-4b served paged at ``--dp 2 --tp 2``, bq8 pool, phase 13c's
# four requests of 64-128 tokens plus 8 on 4 slots; 18d qwen2-72b served
# paged at ``--tp 4`` (2 kv heads of 128 a rank: a 256-wide read), bq8
# pool, the same requests, and qwen2-vl-72b batched at ``--tp 4``, two
# prompts of 512 plus 16 generated (its M-RoPE ids built in the prefill
# and in every decode step); 18e kimi-k2-1t-a32b's first 2 layers (the
# dense layer, then the first MoE layer with all 384 experts, 96 a rank,
# top-8, and the shared expert; 8.46 GB of experts a rank) served paged
# at ``--tp 4`` (2 kv heads of 112 a rank: a 224-wide read of a 256-wide
# token row), bq8 pool, the same requests; each served run through the
# kernels and the plain versions.  Training qwen2-72b, qwen2-vl-72b or
# kimi-k2 fits no single card at any depth: their untied tables and heads
# alone (2.49 B and 2.35 B parameters) need about 77 and 73 GiB of
# training state at phase 13's 31 GiB a billion parameters.
ARCH_DEPTH, ARCH_SCHEME, ARCH_STEPS = 2, "zhybrid_16_8", 2
# 18a's and 18b's share of the card a rank: 0.23 of 79.18 GiB is 18.21
# GiB, 0.71 GiB (4 %) above the most either run reserved a rank under a
# cap (18b: 17.38 GiB allocated, 17.50 reserved under 0.23 and under
# 0.225; 18a: 15.77 allocated, its allocator caching up to the cap, 18.07
# reserved under 0.23); the four caps, 72.85 GiB, leave 6.33 GiB for what
# the card holds besides, which 18a's line prints.  Uncapped, in phase 9's
# world and in a fresh one, a rank with 11.34 GiB allocated found 0.38-2.87
# GiB free for the 3.24 GiB f32 decode of its ZeRO-1 param gather, 76-79
# GiB of the card in use where the four ranks' allocations came to about
# 58: the rest, by inference, the other ranks' cached free blocks, which a
# rank short of memory cannot make them give back
ARCH_FRACTION = 0.23
ARCH_TRAIN, ARCH_FLAGS = "minitron-4b", ("--dp", "2", "--tp", "2")
_ARCH_PAGED = dict(mode="paged", kv_codec="bq8", slots=Z3_SLOTS, gen=Z3_GEN)
# (name, arch, serve_rank keywords) of the served runs
ARCH_SERVE = (
    ("18c", "minitron-4b", dict(_ARCH_PAGED, dp=2, tp=2)),
    ("18d qwen2-72b", "qwen2-72b", dict(_ARCH_PAGED, tp=4)),
    ("18d qwen2-vl-72b", "qwen2-vl-72b",
     dict(mode="batched", tp=4, batch=2, prompt_len=SERVE_PROMPT,
          gen=SERVE_GEN)),
    ("18e", "kimi-k2-1t-a32b", dict(_ARCH_PAGED, tp=4)))
# the kernels each run launches (all at the flat level): 18a the training
# step's (phase 4's); the paged runs' pool writes (#1) and fused KV reads
# (#5); the batched run's TP gathers (flat forms), reduce-scatters (view
# forms) and decode all-reduces (the block encode, the hop with the sum,
# the block decode); 18e's ep all-to-alls, the block encode and decode at
# arch_ep_rows()
_PAGED_KERNELS = {"bq_encode", "bq_gather_decode"}
ARCH_KERNELS = {
    "18a": {"bq_encode", "bq_encode_flat", "bq_encode_view", "bq_decode",
            "bq_decode_flat", "bq_decode_add_encode", "bq_decode_add",
            "bq_decode_add_flat"},
    "18c": _PAGED_KERNELS, "18d qwen2-72b": _PAGED_KERNELS,
    "18d qwen2-vl-72b": SERVE_LEVELS["12a"]["flat"],
    "18e": _PAGED_KERNELS | {"bq_decode"}}


# a bq kernel's wrappers: its block form and the flat and view forms that
# launch the same kernel (the kernel line counts them together)
KERNEL_FORMS = {"bq_encode": ("bq_encode", "bq_encode_flat", "bq_encode_view"),
                "bq_decode": ("bq_decode", "bq_decode_flat"),
                "bq_decode_add_encode": ("bq_decode_add_encode",
                                         "bq_decode_add_encode_wire",
                                         "bq_decode_add_encode_view"),
                "bq_decode_add": ("bq_decode_add", "bq_decode_add_flat")}


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def ptxas_lines(log: str):
    """(kernel, line) for each register and spill line of ``nvcc -Xptxas
    -v``: the kernel's name and integer template arguments read from the
    mangled name of the entry function the lines follow."""
    name = "?"
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '_ZN(\w+)'", line)
        if entry:
            rest, name = entry.group(1), "?"
            while (part := re.match(r"(\d+)", rest)):      # <len><id> ...
                n = int(part.group(1))
                name = rest[len(part.group(1)):len(part.group(1)) + n]
                rest = rest[len(part.group(1)) + n:]
            if rest.startswith("I"):
                args = re.findall(r"L[ib](\d+)E", rest.split("EE", 1)[0] + "E")
                name += f"<{','.join(args)}>"
        elif "registers" in line or "spill" in line:
            yield name, line.split(":", 1)[-1].strip()


def eager_ms(torch, fn, iters: int = 100, warmup: int = 10) -> float:
    """Per-call time on the stream when called from Python one call after
    another (host wrapper included)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def host_us(torch, fn, iters: int = 1000) -> float:
    """Host us per call of ``fn`` called back to back (perf_counter_ns):
    what the caller's thread spends per call while the card keeps up."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter_ns()
    torch.cuda.synchronize()
    return (t1 - t0) / iters / 1e3


def graph_ms(torch, fn, iters: int = 50, reps: int = 5) -> float:
    """Device time per call: ``iters`` calls captured in one CUDA graph and
    replayed ``reps`` times between two events, so no host work falls in
    the timed region."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        graph.replay()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / (reps * iters)


def cold_ms(torch, fn, iters: int = 20) -> float:
    """Device time per call with a cold L2, the median over ``iters``
    calls: before each, a 256 MB write evicts the L2 and a spin on the card
    gives the host time to queue the call, so the two events bracket the
    call's device work alone."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in pairs]))


def _profiled_us(torch, fn, iters: int) -> dict:
    """Device us per profiled run of ``fn`` (``iters`` runs) by kernel
    name, from torch.profiler's CUDA activity."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            out[e.key] = us
    return out


# what times a kernel alone: torch.profiler's CUDA activity, or, once a
# profiler session has reported no device time three times running (a card
# whose profiler is closed to this process), CUDA events around the call
# for the rest of the process
KERNEL_TIMER = {"by": "torch.profiler"}


def kernel_ms(torch, fn, match: str | None = None, iters: int = 10) -> dict:
    """Device ms per call of each kernel that ``fn`` launches, with the L2
    flushed before each call: the kernels' own durations from
    torch.profiler's CUDA activity, by name.  With ``match``, only the
    kernels whose name holds it, under their short names; without, every
    kernel but the flush's, under its full name.  Where the profiler
    reports no device time (``KERNEL_TIMER``), the cold-L2 event time of
    the whole call, under ``match`` or ``"all kernels"``."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()

    def by_events() -> dict:
        if KERNEL_TIMER["by"] != "CUDA events":
            KERNEL_TIMER["by"] = "CUDA events"
            print("kernel_ms: the profiler reported no device time for a "
                  "call three sessions running; kernels alone are timed by CUDA events "
                  "around the whole call (L2 flushed) from here on "
                  f"[{card_line()}]", flush=True)
        return {match or "all kernels": cold_ms(torch, fn, iters)}

    def profiled(f, n) -> dict:
        # a profiler session now and then reports nothing: retry
        for _ in range(3):
            got = _profiled_us(torch, f, n)
            if got:
                return got
        return {}
    if KERNEL_TIMER["by"] != "torch.profiler":
        return by_events()
    flush_keys = set(profiled(flush.zero_, 2))
    if not flush_keys:
        return by_events()

    def call():
        flush.zero_()
        fn()
    seen = set()
    for _ in range(3):      # a session may also report the flush's alone
        out = {}
        for key, us in profiled(call, iters).items():
            if key in flush_keys:
                continue
            seen.add(key)
            if match is None:
                out[key] = us / 1e3 / iters
                continue
            name = re.search(rf"\w*{match}\w*(<[^>]*>)?", key)
            if name:
                out[name.group(0)] = us / 1e3 / iters
        if out:
            return out
    if seen:
        fail(f"the profiler saw no kernel named *{match}*, only "
             f"{sorted(seen)}")
    return by_events()


def timings(torch, kernel, plain, iters: int = 50):
    """(kernel, plain) device ms with a cold L2, then (kernel, plain)
    device ms by graph replay on a warm L2, then (kernel, plain) ms per
    eager call."""
    return (cold_ms(torch, kernel), cold_ms(torch, plain),
            graph_ms(torch, kernel, iters), graph_ms(torch, plain, iters),
            eager_ms(torch, kernel, 2 * iters), eager_ms(torch, plain,
                                                         2 * iters))


def row_bytes(torch, bits: int) -> int:
    """Stored bytes of one 128-value row: q_hi (+ q_lo at rate 24) + scale."""
    return token_read_bytes(torch, bits, 128)


def token_read_bytes(torch, bits: int, width: int) -> int:
    """Stored bytes that reading the first ``width`` values of a token's
    128-value rows needs: the scale of each row the width reaches and the
    q bytes (q_hi, + q_lo at rate 24) of those values alone."""
    from repro_torch.core import codecs
    rows, out = -(-width // 128), 0
    for plane, (w, d) in codecs.get(f"bq{bits}").storage_row_layout().items():
        size = torch.empty((), dtype=d).element_size()
        out += rows * size if plane == "scale" else -(-width * w * size // 128)
    return out


def bound(nbytes: float, nops: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    f32 operations over the f32 rate."""
    t_b, t_o = nbytes / HBM_BYTES_PER_S, nops / F32_OPS_PER_S
    return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations")


def special_rows(torch):
    """Rows that stress the scale and rounding arithmetic, most telling
    first (all-zero, extreme magnitudes, denormals)."""
    g = torch.Generator().manual_seed(7)
    u = lambda: torch.rand(128, generator=g) * 2 - 1  # noqa: E731
    rows = [
        torch.zeros(128),
        u() * 3.4e38,
        torch.cat([torch.tensor([3.0e38]), u()[1:] * 1e-3]),
        u() * 1e-40,
        torch.cat([torch.tensor([1.0]), u()[1:] * 1e-40]),
        torch.full((128,), -2.5),
        torch.cat([torch.tensor([1.0]), torch.zeros(126), torch.tensor([-0.0])]),
        torch.full((128,), 1e-45),
        (torch.arange(128) - 63.5) * 0.5,
        u() * 1e20,
        u() * 1e-20,
        torch.cat([torch.tensor([1e-30]), u()[1:] * 1e-38]),
        torch.cat([torch.full((64,), 7.0), torch.full((64,), -7.0)]),
        u(),
        u() * 65504.0,
        torch.cat([torch.tensor([2e-31]), u()[1:] * 2e-31]),
    ]
    return torch.stack(rows).to(torch.float32)


def division_rows(torch, m: int, seed: int):
    """Rows whose scales span 2^-70 .. 2^110 (both sides of the encode's
    fast-division range, csrc/bq.cu div_rn) with uniform values, powers of
    two of the scale, and values near the rounding boundaries of every
    rate; each row reaches its scale."""
    g = torch.Generator().manual_seed(seed)
    scale = torch.exp2(torch.rand(m, 1, generator=g) * 180 - 70)
    u = torch.rand(m, 128, generator=g) * 2 - 1
    x = u * scale
    x[0::5] = torch.exp2(-torch.randint(0, 40, (len(x[0::5]), 128),
                                        generator=g).float()) * \
        torch.sign(u[0::5]) * scale[0::5]
    for i, qmax in enumerate((7, 127, 32767, 8388607)):
        rows = x[1 + i::5]
        k = torch.randint(-qmax, qmax, rows.shape, generator=g).double()
        rows.copy_(((k + 0.5) / qmax * scale[1 + i::5].double()).float())
    x[:, 0] = scale[:, 0]
    return x.cuda()


def test_rows(torch, m: int, seed: int):
    """m rows of normals x 10 drawn on the card (drawn on the host until
    phase 16 came in: 13 M rows a rate, most of phase 2's block-form
    checks), the first ones ``special_rows``."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(m, 128, generator=g, device="cuda") * 10
    sp = special_rows(torch)
    k = min(m, sp.shape[0])
    x[:k] = sp[:k].cuda()
    return x


def max_diff(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def layer0_model(model, params):
    """``model`` cut to its first layer and its parameters' slice: the same
    embedding and layer-0 weights, so its layer-0 K/V are the model's."""
    from repro_torch.models.model import Model
    from repro_torch.models.params import map_leaves

    one = Model(model.cfg.truncated(1), model.mi, device=model.device)
    return one, map_leaves(
        lambda d, t: t[:d.shape[0]] if tuple(t.shape) != d.shape else t,
        one.plan, params)


def drive_serving(torch, model, params, card) -> dict:
    """Serve SLOTS random prompts through the kernels, through their plain
    versions and, for layer 0 alone, with a dense pool; check the three
    runs against each other; return the kernel run's launch counts."""
    from repro_torch.kernels import bq, ref
    from repro_torch.launch import serve
    from repro_torch.serve import paged_kv

    cfg = model.cfg
    prompt_len, gen, slots, bt = PROMPT, GEN, SLOTS, BLOCK_TOKENS
    mb = paged_kv.blocks_needed(prompt_len + gen, bt)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, prompt_len).tolist()
               for _ in range(slots)]
    # warm cuBLAS and the allocator on a short request
    serve.serve_requests(model, params, [prompts[0][:8]], 2, kv_codec="bq8",
                         block_tokens=bt, slots=slots)

    def run(codec, backend, model=model, params=params):
        torch.cuda.reset_peak_memory_stats()
        bq.reset_launches()
        fin, pool, steps, secs = serve.serve_requests(
            model, params, prompts, gen, kv_codec=codec, block_tokens=bt,
            slots=slots, backend=backend)
        launches = dict(bq.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        n_gen = sum(len(v) for v in fin.values())
        print(f"  paged[{codec}] {'plain' if backend else 'kernels'}: "
              f"{len(prompts)} requests ({prompt_len}+{gen}) on {slots} "
              f"slots: {steps} steps, {secs * 1e3 / steps:.2f} ms/step, "
              f"{n_gen / secs:.1f} generated tok/s, peak "
              f"{peak / 2**30:.2f} GiB, launches {launches} [{card}]")
        if sorted(fin) != list(range(len(prompts))) or any(
                len(v) != gen or min(v) < 0 or max(v) >= cfg.vocab_size
                for v in fin.values()):
            fail(f"paged[{codec}]: malformed output tokens")
        return fin, pool, steps, secs, launches

    k_fin, k_pool, k_steps, k_secs, k_launch = run("bq8", None)
    p_fin, p_pool, _, p_secs, p_launch = run("bq8", "torch")
    # the dense pool only has to hold layer 0 (the check below reads no
    # other), so that run serves the model's first layer alone
    d_fin, d_pool, _, d_secs, _ = run("none", None,
                                      *layer0_model(model, params))

    for name in ("bq_encode", "bq_gather_decode"):
        if k_launch[name] <= 0:
            fail(f"main path never launched {name}")
    if any(p_launch.values()):
        fail(f"plain run launched kernels: {p_launch}")
    if k_fin != p_fin:
        fail("tokens differ between the kernel run and the plain run")
    for gi, (a, b) in enumerate(zip(k_pool, p_pool)):
        for nm in ("k", "v"):
            for pl in ("q_hi", "q_lo", "scale"):
                if a[nm][pl] is None:
                    continue
                if not torch.equal(a[nm][pl], b[nm][pl]):
                    fail(f"pool group {gi} {nm}.{pl} differs between the "
                         f"kernel run and the plain run")
                if pl == "scale" and not bool(
                        (a[nm][pl].isfinite() & (a[nm][pl] >= 0)).all()):
                    fail(f"pool group {gi} {nm}.scale not finite")
    # layer 0 K/V depend only on the prompt tokens and positions, so the
    # bq8 pool must decode to the dense pool within the bq8 error bound
    # (request i owns blocks [i*mb, (i+1)*mb); its prompt fills the first
    # prompt_len // bt of them)
    pb = prompt_len // bt
    sel = torch.cat([torch.arange(i * mb, i * mb + pb) for i in range(slots)])
    worst = 0.0
    for nm in ("k", "v"):
        planes = {pl: None if v is None else v[0][sel]
                  for pl, v in k_pool[0][nm].items()}
        dense = d_pool[0][nm][0][sel].float().flatten(2)   # [S, bt, KV*hd]
        f = dense.shape[-1]
        dec = ref.bq_decode_ref(planes["q_hi"], planes["q_lo"],
                                planes["scale"], MAIN_BITS).flatten(2)[..., :f]
        lim = ref.max_abs_error_bound(planes["scale"], MAIN_BITS)
        lim = lim.repeat_interleave(ref.BLOCK, dim=-1)[..., :f]
        excess = ((dec - dense).abs() - lim).max().item()
        worst = max(worst, (dec - dense).abs().max().item())
        if excess > 0:
            fail(f"layer 0 {nm}: bq8 pool off the dense pool beyond the "
                 f"error bound by {excess}")
    print(f"phase 3: kernel run == plain run (tokens and every pool plane); "
          f"layer-0 bq8 pool within the error bound of the dense pool (max "
          f"abs diff {worst:.3g}); dense run (layer 0 alone) "
          f"{d_secs * 1e3 / k_steps:.2f} ms/step, plain bq8 run "
          f"{p_secs * 1e3 / k_steps:.2f} ms/step [{card}]")
    return k_launch


def ring_rows(cfg) -> dict:
    """Rows per hop (padded, per rank) of the training step's rings: the
    shapes the path gives the fused hops, and the rows of its TP
    all-gather's encode and decode."""
    from repro_torch.kernels.ops import padded_rows
    from repro_torch.models.params import MeshInfo, defs, local_shape
    from repro_torch.models.transformer import model_plan

    mi = MeshInfo(tp=TP, dp=DP)
    ds = defs(model_plan(cfg, mi))
    n_flat = sum(int(np.prod(local_shape(d, mi))) for d in ds)
    n_rep = sum(int(np.prod(local_shape(d, mi))) for d in ds
                if "model" not in d.spec)
    act = (GLOBAL_BATCH // DP) * (SEQ // TP) * cfg.d_model
    return {"zero1_rs": padded_rows(-(-n_flat // DP)),          # bq8, #4
            "grad_rep_psum": padded_rows(-(-n_rep // TP)),      # bq16, #3
            "mlp_out_rs": padded_rows(act),                     # bq16, #4
            "phase5_ring": padded_rows(-(-n_flat // RING_WORLD)),  # bq8
            "mlp_in_encode": padded_rows(act),                  # bq16, #1
            "mlp_in_decode": TP * padded_rows(act)}             # bq16, #2


def fused_bytes(torch, kind: str, m: int, bits: int) -> int:
    """Bytes a fused hop must move at M rows: the received wire and the
    local f32 rows in; the new wire (#3) and the f32 sum (#3 with the
    sum, #4) out."""
    w, f = m * row_bytes(torch, bits), m * 128 * 4
    return {"sum": 2 * w + 2 * f, "wire": 2 * w + f, "add": w + 2 * f}[kind]


def fused_fns(torch, kind: str, m: int, bits: int, seed: int,
              data=None):
    """(kernel call, plain call) of one fused-hop form on fresh rows
    (``data(torch, m, seed)``, by default ``test_rows``)."""
    from repro_torch.kernels import ops
    data = data or test_rows
    w = ops.bq_encode_blocks(data(torch, m, seed), bits, backend="torch")
    local = data(torch, m, seed + 1) * 0.25
    if kind == "add":
        return (lambda be=None: ops.bq_decode_add_blocks(w, local, bits, be),
                lambda: ops.bq_decode_add_blocks(w, local, bits, "torch"))
    want = kind == "sum"
    return (lambda be=None: ops.bq_decode_add_encode_blocks(
                w, local, bits, be, want_sum=want),
            lambda: ops.bq_decode_add_encode_blocks(
                w, local, bits, "torch", want_sum=want))


def check_fused(torch, kind: str, m: int, bits: int) -> float:
    """Hold one fused-hop form against its plain version bit for bit;
    returns the max abs difference (0)."""
    kern, plain = fused_fns(torch, kind, m, bits, seed=bits * 31 + m % 997)
    got, want = kern(), plain()
    if kind == "add":
        pairs = [(got, want, "sum")]
    else:
        (gw, gs), (ww, ws) = got, want
        pairs = [(gw[k], ww[k], k) for k in ww if ww[k] is not None]
        pairs += [(gs, ws, "sum")] if ws is not None or gs is not None else []
    worst = 0.0
    for a, b, k in pairs:
        if not torch.equal(a, b):
            fail(f"fused hop {kind} rate {bits} M={m}: {k} differs")
        worst = max(worst, max_diff(a, b))
    return worst


def normal_rows(torch, m: int, seed: int):
    """m rows of normals x 10 drawn on the card: activations and gradients
    have no denormal, infinite or near-f32-max rows, which the division
    takes its slow path on."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(m, 128, generator=g, device="cuda") * 10


def big_rows(torch, m: int, seed: int):
    """``test_rows`` up to 65536 rows; above, ``normal_rows``."""
    return test_rows(torch, m, seed) if m <= 65536 else \
        normal_rows(torch, m, seed)


def time_encode(torch, m, bits, iters=50):
    from repro_torch.kernels import ops
    x = big_rows(torch, m, seed=1)
    return timings(torch, lambda: ops.bq_encode_blocks(x, bits),
                   lambda: ops.bq_encode_blocks(x, bits, backend="torch"),
                   iters), bound(m * 128 * 4 + m * row_bytes(torch, bits),
                            m * 128 * 6)


def time_decode(torch, m, bits, iters=50):
    from repro_torch.kernels import ops
    w = ops.bq_encode_blocks(big_rows(torch, m, seed=2), bits)
    return timings(torch, lambda: ops.bq_decode_blocks(w, bits),
                   lambda: ops.bq_decode_blocks(w, bits, backend="torch"),
                   iters), bound(m * row_bytes(torch, bits) + m * 128 * 4,
                            m * 128)


def time_gather(torch, bits, n_blocks, serve, iters=50):
    """Gather-decode of every block of an ``n_blocks`` pool in a SLOTS-row
    table; ``serve`` = (rows per token, rows per pool block, -)."""
    from repro_torch.kernels import ops
    r, rpb, _ = serve
    w = ops.bq_encode_blocks(test_rows(torch, n_blocks * rpb, seed=3), bits)
    pool = {k: None if v is None else
            v.reshape(n_blocks, BLOCK_TOKENS, r, -1) for k, v in w.items()}
    idx = torch.arange(n_blocks, dtype=torch.int32,
                       device="cuda").reshape(SLOTS, -1)
    rows = idx.numel() * rpb
    uniq = int(torch.unique(idx).numel()) * rpb
    return timings(
        torch, lambda: ops.bq_gather_decode(pool, idx, bits),
        lambda: ops.bq_gather_decode(pool, idx, bits, backend="torch"),
        iters), bound(idx.numel() * 4 + uniq * row_bytes(torch, bits)
             + rows * 128 * 4, rows * 128)


def time_fused(torch, kind, m, bits, iters=50):
    kern, plain = fused_fns(torch, kind, m, bits, seed=5)
    return timings(torch, kern, plain, iters), \
        bound(fused_bytes(torch, kind, m, bits), m * 128 * 8)


def show(card, name, bits, shape, t, b, extra=""):
    (ms, pms, wms, wpms, ems, epms), (bms, by) = t, b
    print(f"  {name} rate {bits} {shape}: device, L2 flushed, "
          f"{ms * 1e3:.2f} us kernel ({bms / ms * 100:.1f}% of bound) vs "
          f"{pms * 1e3:.2f} us plain; warm L2 (graph) {wms * 1e3:.2f} "
          f"vs {wpms * 1e3:.2f} us; per eager call {ems * 1e3:.2f} vs "
          f"{epms * 1e3:.2f} us; bound {bms * 1e3:.3f} us ({by}){extra} "
          f"[{card}]")


def time_bq(torch, card, rows, serve):
    """Each bq kernel at the shape and rate its path gives it (the kernel
    line), the block encode and decode also at the ZeRO-1 parameter
    gather's rows, then every kernel at 65536 rows at rate 8.  Returns
    ``{kernel: (where, rate, shape, timings, bound)}`` at the path and the
    block encode's and decode's own device ms at the path (torch.profiler,
    L2 flushed)."""
    from repro_torch.kernels import ops
    big = dict(iters=5)                  # GB-sized rows: fewer graph calls
    enc_m, dec_m = rows["mlp_in_encode"], rows["mlp_in_decode"]
    nb = serve[2]
    path = {
        "bq_encode": ("tp@mlp_out reduce-scatter, first hop", 16,
                      f"M={enc_m}", *time_encode(torch, enc_m, 16)),
        "bq_decode": ("TP shards of the activation (the gather decodes "
                      "them flat)", 16, f"M={dec_m}",
                      *time_decode(torch, dec_m, 16)),
        "bq_decode_add_encode": (
            "tp@grad_rep all-reduce, last hop", 16,
            f"M={rows['grad_rep_psum']}",
            *time_fused(torch, "sum", rows["grad_rep_psum"], 16, **big)),
        "bq_decode_add_encode_wire": (
            "phase-5 ring, intermediate hops", 8,
            f"M={rows['phase5_ring']}",
            *time_fused(torch, "wire", rows["phase5_ring"], 8, **big)),
        "bq_decode_add": ("dp@zero1_grad reduce-scatter, last hop", 8,
                          f"M={rows['zero1_rs']}",
                          *time_fused(torch, "add", rows["zero1_rs"], 8,
                                      **big)),
        "bq_gather_decode": ("serving read", MAIN_BITS,
                             f"idx {SLOTS}x{nb // SLOTS}, {serve[1]} "
                             f"rows/block",
                             *time_gather(torch, MAIN_BITS, nb, serve)),
    }
    x = big_rows(torch, enc_m, seed=1)
    w = ops.bq_encode_blocks(big_rows(torch, dec_m, seed=2), 16)
    block_kms = {
        "bq_encode": sum(kernel_ms(
            torch, lambda: ops.bq_encode_blocks(x, 16)).values()),
        "bq_decode": sum(kernel_ms(
            torch, lambda: ops.bq_decode_blocks(w, 16)).values())}
    del x, w
    for name, (where, bits, shape, t, b) in path.items():
        extra = "" if name not in block_kms else (
            f"; the kernel alone ({KERNEL_TIMER['by']}) "
            f"{block_kms[name] * 1e3:.2f} us")
        show(card, f"{name} [{where}]", bits, shape, t, b, extra)
        torch.cuda.empty_cache()
    show(card, "bq_decode_add [tp@mlp_out reduce-scatter, last hop]", 16,
         f"M={rows['mlp_out_rs']}",
         *time_fused(torch, "add", rows["mlp_out_rs"], 16))
    zm = rows["zero1_rs"]
    show(card, "bq_encode [zero param all-gather]", 16, f"M={zm}",
         *time_encode(torch, zm, 16, **big))
    show(card, "bq_decode [zero param all-gather]", 16, f"M={DP * zm}",
         *time_decode(torch, DP * zm, 16, **big))
    torch.cuda.empty_cache()
    # at 65536 rows, the pool's rate (every rate in BITS until phase 13
    # came in; the script's time), 10 graph calls and 20 eager calls a
    # timing (50 and 100 until phase 16 came in)
    few = dict(iters=10)
    for bits in (MAIN_BITS,):
        show(card, "bq_encode", bits, "65536 rows",
             *time_encode(torch, 65536, bits, **few))
        show(card, "bq_decode", bits, "65536 rows",
             *time_decode(torch, 65536, bits, **few))
        show(card, "bq_gather_decode", bits, "65536 rows",
             *time_gather(torch, bits, 65536 // serve[1], serve, **few))
        for kind, name in (("sum", "bq_decode_add_encode"),
                           ("wire", "bq_decode_add_encode_wire"),
                           ("add", "bq_decode_add")):
            show(card, name, bits, "65536 rows",
                 *time_fused(torch, kind, 65536, bits, **few))
    torch.cuda.empty_cache()
    return path, block_kms


# --------------------------------------------------------------------------
# the flat encode and decode (the TP all-gather's, fused with its layout)
# --------------------------------------------------------------------------

FLAT_N = (1, 127, 1025, 70000)
FLAT_DTYPES = ("bfloat16", "float16", "float32")
GATHER_SHAPES = ((3, 5, 7),)


def tp_shape(cfg) -> tuple:
    """One rank's sequence-sharded activation at the training step."""
    return (GLOBAL_BATCH // DP, SEQ // TP, cfg.d_model)


def flat_input(torch, n: int, dtype: str, seed: int):
    """n values in ``dtype`` on the card: normals x 50 with a near-f32-max
    row, an all-zero row and (for floats) values past the 16-bit types'
    range, cast by torch."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, generator=g) * 50
    if n > 512:
        x[:128] = special_rows(torch)[1]
        x[128:256] = 0.0
        x[256:384] *= 1e4
    return x.to(getattr(torch, dtype)).cuda()


def same_bits(torch, a, b) -> bool:
    """Equal bit for bit, but a NaN only needs a NaN in the same place
    (the kernel's NaN payload may differ from torch's canonical one)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if not a.dtype.is_floating_point:
        return torch.equal(a, b)
    na, nb = a.isnan(), b.isnan()
    return torch.equal(na, nb) and torch.equal(a[~na], b[~nb])


def arch_shapes() -> dict:
    """Phase 18's kernel shapes that no earlier path gives: minitron-4b's
    TP all-gather payload (``tp@mlp_in``, a rank's [2, 512, 3072]) and
    reduce-scatter activation (``tp@mlp_out``, [2, 1024, 3072] along axis
    1) at dp 2 x tp 2, and kimi-k2's paged pool at tp 4 (2 kv heads of
    112 a rank: token rows of 2 x 128 values, the read's width 224) for an
    8 x 37 block table."""
    from repro_torch import configs
    from repro_torch.serve import paged_kv
    cfg, kimi = configs.get(ARCH_TRAIN), configs.get("kimi-k2-1t-a32b")
    kv_loc = kimi.n_kv_heads // 4
    r = paged_kv.token_rows(kv_loc, kimi.head_dim_)
    return {"tp": tp_shape(cfg), "rs": (GLOBAL_BATCH // DP, SEQ, cfg.d_model),
            "kv": (r, BLOCK_TOKENS * r, 8 * 37), "kv_slots": 8,
            "kv_width": kv_loc * kimi.head_dim_}


def check_flat(torch, err: dict) -> None:
    """Hold bq_encode_flat and bq_decode_flat against their plain versions
    (fail on any difference): encode from bf16, f16, f32 and int32, decode
    to the three float types, at n in FLAT_N and the TP activations' sizes
    (gemma3-1b's and minitron-4b's), the encode also on a misaligned and a
    strided view; the gathered decode of TP shards along every axis of a
    small 3-D shape and of both TP activations'.  Scales of inf and NaN
    are planted in the decode's wire, so NaN positions are held too."""
    from repro_torch import configs
    from repro_torch.kernels import bq, ops

    tp_shapes = (tp_shape(configs.get("gemma3-1b")), arch_shapes()["tp"])
    sizes = FLAT_N + tuple(int(np.prod(sh)) for sh in tp_shapes)
    for bits in BITS:
        for dtype in FLAT_DTYPES + ("int32",):
            for n in sizes:
                x = flat_input(torch, n, dtype, seed=bits * 1000 + n % 997)
                for view, xv in (("", x), (" misaligned", x[1:]),
                                 (" strided", x[::3])):
                    got = bq.bq_encode_flat(xv, bits)
                    want = bq.encode_flat_plain(xv, bits)
                    for k, a, b in zip(("q_hi", "q_lo", "scale"), got, want):
                        if b is not None and not torch.equal(a, b):
                            fail(f"bq_encode_flat rate {bits} {dtype} "
                                 f"n={n}{view}: {k} differs")
                if dtype == "int32":
                    continue
                w = bq.encode_flat_plain(x, bits)
                if w[2].shape[0] > 8:
                    w[2][1], w[2][2] = float("inf"), float("nan")
                got = bq.bq_decode_flat(*w, bits, n, x.dtype)
                if not same_bits(torch, got, bq.decode_flat_plain(
                        *w, bits, n, x.dtype)):
                    fail(f"bq_decode_flat rate {bits} {dtype} n={n} differs")
        for dtype in FLAT_DTYPES:
            for shp in GATHER_SHAPES + tp_shapes:
                ws = [ops.bq_encode(flat_input(torch, int(np.prod(shp)),
                                               dtype, seed=s).reshape(shp),
                                    bits, backend="torch")
                      for s in range(TP)]
                gw = {k: None if ws[0][k] is None else
                      torch.stack([w[k] for w in ws]) for k in ws[0]}
                for ax in range(len(shp)):
                    args = (gw, bits, shp, getattr(torch, dtype), ax)
                    if not same_bits(torch, ops.bq_decode_gathered(*args),
                                     ops.bq_decode_gathered(
                                         *args, backend="torch")):
                        fail(f"gathered decode rate {bits} {dtype} {shp} "
                             f"axis {ax} differs")
        torch.cuda.empty_cache()
    err["bq_encode_flat"] = err["bq_decode_flat"] = 0.0


VIEW_BASES = ((3, 5, 7), (2, 8, 64))


def view_spans(x, axis_dim: int, n: int):
    """Every shard view of the n chunks of x: whole, and the row ranges of
    a bidirectional ring of two stripes (``comms._ring_schedule``)."""
    from repro_torch.core import comms
    from repro_torch.kernels import bq
    m = bq.padded_rows(x.numel() // n)
    spans = {(0, m)} | {(lo, hi) for lo, hi, _ in
                        comms._ring_schedule(m, True, 2).parts}
    return [bq.shard_view(x, axis_dim, n, k, lo, hi)
            for k in range(n) for lo, hi in sorted(spans)]


def check_view(torch, view, bits: int, what: str) -> None:
    """Hold the view encode, the view wire-only hop and the fused
    decode-add against their plain versions (the block forms on
    ``bq.view_rows``, equal to ``comms._split_for_scatter``'s rows): bit
    for bit, NaN by position (inf and NaN scales planted in the
    decode-add's wire)."""
    from repro_torch.kernels import bq
    rows = bq.view_rows(view)
    where = f"{what} chunk {view.index} rows [{view.lo}, {view.hi})"
    for name, got, want in (
            ("bq_encode_view", bq.bq_encode_view(view, bits),
             bq.encode_plain(rows, bits)),
            ("bq_decode_add_encode_view", bq.bq_decode_add_encode_view(
                *bq.encode_plain(rows * 0.5 + 1.0, bits), view, bits),
             bq.decode_add_encode_plain(*bq.encode_plain(rows * 0.5 + 1.0,
                                                         bits), rows,
                                        bits)[:3])):
        for k, a, b in zip(("q_hi", "q_lo", "scale"), got, want):
            if b is not None and not same_bits(torch, a, b):
                fail(f"{name} {where}: {k} differs")
    w = [t.clone() if t is not None else None for t in
         bq.encode_plain(rows * 0.5 + 1.0, bits)]
    if view.rows > 2:
        w[2][1], w[2][2] = float("inf"), float("nan")
    out = torch.full((view.n,), 7.0, dtype=view.x.dtype, device="cuda")
    want = bq.decode_add_flat_plain(*w, view, bits, out.clone())
    if not same_bits(torch, bq.bq_decode_add_flat(*w, view, bits, out),
                     want):
        fail(f"bq_decode_add_flat {where} differs")


def check_views(torch, err: dict, serve) -> None:
    """The TP reduce-scatter's view forms against their plain versions at
    rates 4/8/16/24 in bf16, f16 and f32, every chunk of payloads split 2,
    3 and 4 ways along each of three axes (aligned and misaligned) and of
    the TP shapes (RS_SHAPES and minitron-4b's, along axis 1); the fused
    KV read (bf16, f16, f32; widths 256, 192 and 100) against
    gather-decode, slice and cast at the serving table, and at kimi-k2's
    width 224 of 2-row tokens on an 8 x 37 table (``arch_shapes``), an id
    outside the pool writing NaN."""
    from repro_torch.kernels import bq, ops
    for bits in BITS:
        for dtype in FLAT_DTYPES:
            for base in VIEW_BASES:
                for n in (2, 3, 4):
                    for ax in range(3):
                        shape = list(base)
                        shape[ax] *= n
                        x = flat_input(torch, int(np.prod(shape)) + 1, dtype,
                                       seed=bits + n + ax)
                        for xv in (x[:-1], x[1:]):
                            for view in view_spans(xv.reshape(shape), ax,
                                                   n):
                                check_view(torch, view, bits,
                                           f"rate {bits} {dtype} {shape} "
                                           f"axis {ax}")
        torch.cuda.empty_cache()
    arch = arch_shapes()
    for shape in RS_SHAPES + (arch["rs"],):
        for bits in (8, 16):
            x = flat_input(torch, int(np.prod(shape)), "bfloat16", seed=bits)
            for view in view_spans(x.reshape(shape), 1, TP):
                check_view(torch, view, bits, f"rate {bits} {list(shape)}")
    r, _, _ = serve
    for (r, rpb, nb), slots, widths in (
            (serve, SLOTS, (100, 192, r * 128)),
            (arch["kv"], arch["kv_slots"], (arch["kv_width"],))):
        w = ops.bq_encode_blocks(test_rows(torch, nb * rpb, seed=5),
                                 MAIN_BITS)
        pool = [None if w[k] is None else
                w[k].reshape(nb, BLOCK_TOKENS, r, -1)
                for k in ("q_hi", "q_lo", "scale")]
        g = torch.Generator().manual_seed(5)
        idx = torch.randint(0, nb, (slots, nb // slots), generator=g,
                            dtype=torch.int32).cuda()
        bad = idx.clone()
        bad[0, 0], bad[1, 1] = nb, -1
        ok = torch.ones(bad.shape, dtype=torch.bool, device="cuda")
        ok[0, 0] = ok[1, 1] = False
        for dtype in FLAT_DTYPES:
            dt = getattr(torch, dtype)
            for width in widths:
                got = bq.bq_gather_decode(*pool, idx, MAIN_BITS, dtype=dt,
                                          width=width)
                want = bq.gather_decode_flat_plain(*pool, idx, MAIN_BITS, dt,
                                                   width)
                if not same_bits(torch, got, want):
                    fail(f"bq_gather_decode {dtype} width {width} of "
                         f"{r * 128}-wide tokens differs")
            got = bq.bq_gather_decode(*pool, bad, MAIN_BITS, dtype=dt,
                                      width=widths[-1])  # want: this width's
            torch.cuda.synchronize()
            if not (got[0, 0].isnan().all() and got[1, 1].isnan().all()
                    and same_bits(torch, got[ok], want[ok])):
                fail(f"bq_gather_decode {dtype} width {widths[-1]}: "
                     f"out-of-range ids")
        torch.cuda.empty_cache()
    err["bq_encode_view"] = err["bq_decode_add_encode_view"] = 0.0
    err["bq_decode_add_flat"] = 0.0


def tp_calls(torch, shape, bits: int = 16):
    """The TP all-gather's encode and gathered decode of a bf16 activation
    of ``shape`` (the gather along axis 1 over TP shards), each as
    ``(fused, plain, unfused, nbytes, nops)``: the fused op the path calls
    (None before it existed), its plain version, the unfused composition
    the path called before (cast, padded copy, block encode; block decode,
    strip, cast, movedim copy), and the bytes and operations the op must
    move and do."""
    from repro_torch.kernels import bq, ops
    g = torch.Generator().manual_seed(11)
    x = (torch.randn(*shape, generator=g) * 3).to(torch.bfloat16).cuda()
    n, ax = x.numel(), 1
    full = list(shape)
    full[ax] *= TP
    w = ops.bq_encode_blocks(ops.to_blocks(x), bits, backend="torch")
    gw = {k: None if v is None else torch.stack([v] * TP) for k, v in
          w.items()}
    m = w["scale"].shape[0]
    rb = row_bytes(torch, bits)

    def dec_unfused(backend=None):
        blocks = ops.bq_decode_blocks(gw, bits, backend)
        parts = blocks.reshape(TP, -1)[:, :n].reshape(
            (TP,) + tuple(shape)).to(x.dtype)
        return torch.movedim(parts, 0, ax).reshape(full)
    fused = hasattr(bq, "bq_encode_flat")
    return {
        "encode": (
            (lambda: ops.bq_encode(x, bits)) if fused else None,
            lambda: ops.bq_encode(x, bits, backend="torch"),
            lambda: ops.bq_encode_blocks(ops.to_blocks(x), bits),
            n * 2 + m * rb, n * 6),
        "decode": (
            (lambda: ops.bq_decode_gathered(gw, bits, shape, x.dtype, ax))
            if fused else None,
            lambda: dec_unfused("torch"),
            dec_unfused,
            TP * m * rb + TP * n * 2, TP * n)}


def rs_calls(torch, shape, bits: int = 16):
    """One end of the TP reduce-scatter of a bf16 activation of ``shape``
    along axis 1 over TP ranks, as rank 0 runs it at tp 2: the first
    hop's encode of chunk 1 and the last hop's decode-add onto chunk 0 of
    that wire (standing in for the peer's), alone and together (``end``),
    each as ``(fused, plain, unfused, nbytes, nops)``: the view ops the
    path calls (None before they existed), the plain versions of the
    unfused composition, and the composition the path called before
    (``comms._split_for_scatter``, block encode, block decode-add,
    ``from_blocks``; alone, the block kernel on its split rows)."""
    from repro_torch.core import comms
    from repro_torch.kernels import bq, ops
    g = torch.Generator().manual_seed(13)
    x = (torch.randn(*shape, generator=g) * 3).to(torch.bfloat16).cuda()
    nc = x.numel() // TP                      # values of one chunk
    xb, cs = comms._split_for_scatter(x, 1, TP)
    w = ops.bq_encode_blocks(xb[1], bits, backend="torch")
    m, rb = w["scale"].shape[0], row_bytes(torch, bits)

    def end_unfused(backend=None):
        xb_, cs_ = comms._split_for_scatter(x, 1, TP)
        wire = ops.bq_encode_blocks(xb_[1], bits, backend)
        acc = ops.bq_decode_add_blocks(wire, xb_[0], bits, backend)
        return ops.from_blocks(acc, cs_, x.dtype)
    calls = {
        "encode": (None, lambda: ops.bq_encode_blocks(xb[1], bits, "torch"),
                   lambda: ops.bq_encode_blocks(xb[1], bits),
                   nc * 2 + m * rb, nc * 6),
        "decode_add": (None, lambda: ops.bq_decode_add_blocks(
                           w, xb[0], bits, "torch"),
                       lambda: ops.bq_decode_add_blocks(w, xb[0], bits),
                       m * rb + 2 * nc * 2, nc * 2),
        "end": (None, lambda: end_unfused("torch"), end_unfused,
                3 * nc * 2 + 2 * m * rb, nc * 8)}
    if hasattr(bq, "bq_decode_add_flat"):
        view = lambda k: bq.shard_view(x, 1, TP, k)  # noqa: E731

        def dec_add(wire):
            out = torch.empty(cs, dtype=x.dtype, device=x.device)
            return ops.bq_decode_add_view(wire, view(0), bits, out)

        def end_fused():
            return dec_add(ops.bq_encode_view(view(1), bits))
        calls = {
            "encode": (lambda: ops.bq_encode_view(view(1), bits),
                       *calls["encode"][1:]),
            "decode_add": (lambda: dec_add(w), *calls["decode_add"][1:]),
            "end": (end_fused, *calls["end"][1:])}
    return calls


def kv_calls(torch, serve, bits: int = MAIN_BITS, slots: int = SLOTS,
             width: int | None = None):
    """The paged KV read of one pool plane at the serving table (every
    block of the pool in a ``slots``-row table, as ``time_gather``) into
    bf16 tokens of ``width`` values (``R * 128`` by default;
    ``read_tables``): ``(fused, plain, unfused, nbytes, nops)`` with the
    fused gather-decode writing bf16 (None before it existed), and the f32
    gather-decode followed by the cast the path ran before.  The bytes
    read are the table and, of each token it names, the scales and q
    bytes of the first ``width`` values (:func:`token_read_bytes`: the
    kernel loads no column past ``width``), those written ``width`` bf16
    values a token."""
    from repro_torch.kernels import bq, ops
    r, rpb, nb = serve
    width = r * 128 if width is None else width
    w = ops.bq_encode_blocks(test_rows(torch, nb * rpb, seed=3), bits)
    pool = {k: None if v is None else
            v.reshape(nb, BLOCK_TOKENS, r, -1) for k, v in w.items()}
    idx = torch.arange(nb, dtype=torch.int32,
                       device="cuda").reshape(slots, -1)
    tokens = idx.numel() * BLOCK_TOKENS
    read = idx.numel() * 4 + tokens * token_read_bytes(torch, bits, width)

    def unfused(backend=None):
        dec = ops.bq_gather_decode(pool, idx, bits, backend)
        return dec.flatten(-2)[..., :width].to(torch.bfloat16)
    fused = None
    if hasattr(bq, "gather_decode_flat_plain"):
        def fused():
            return ops.bq_gather_decode(pool, idx, bits,
                                        dtype=torch.bfloat16, width=width)
    return {"read": (fused, lambda: unfused("torch"), unfused,
                     read + tokens * width * 2, tokens * width)}


def time_ops(torch, card, label: str, calls: dict) -> dict:
    """Times of fused ops, their plain versions and the unfused
    compositions they replace (``calls``: ``{op: (fused, plain, unfused,
    nbytes, nops)}``): device ms with the L2 flushed, by graph replay on a
    warm L2 and per eager call, the kernels' own device ms (torch.profiler,
    summed over every kernel the call launches) and host us per call; the
    kernel time of a plain streaming kernel that moves the same bytes
    (``stream_kernel_ms``), the floor such a call meets on the card below
    its bound; and the unfused composition's kernels one by one.  Lines
    are headed ``label`` with ``{op}`` filled in."""
    out = {}
    for op, (fused, plain, unfused, nbytes, nops) in calls.items():
        b = bound(nbytes, nops)
        res = {"bound_ms": b[0], "plain_ms": cold_ms(torch, plain)}
        for lab, fn in (("", fused), ("unfused_", unfused)):
            if fn is None:
                continue
            res.update({
                f"{lab}ms": cold_ms(torch, fn),
                f"{lab}warm_l2_ms": graph_ms(torch, fn),
                f"{lab}eager_ms": eager_ms(torch, fn, 200),
                f"{lab}kernel_ms": sum(kernel_ms(torch, fn).values()),
                f"{lab}host_us": host_us(torch, fn)})
        # what a plain streaming kernel takes to move these bytes (torch's
        # vectorized elementwise negation reading half of them and writing
        # the other half), L2 flushed: the floor at this size
        src = torch.zeros(nbytes // 8, dtype=torch.float32, device="cuda")
        dst = torch.empty_like(src)
        res["stream_kernel_ms"] = sum(kernel_ms(
            torch, lambda: torch.neg(src, out=dst)).values())
        del src, dst
        head = label.format(op=op)
        kernels = kernel_ms(torch, unfused)
        print(f"  {head}, unfused: kernels alone ({KERNEL_TIMER['by']}) "
              + "; ".join(f"{k.removeprefix('void ')[:72]} {v * 1e3:.2f}"
                          f" us" for k, v in kernels.items())
              + f" [{card}]")
        line = ", ".join(f"{k} {v * 1e3:.2f} us" if k.endswith("ms") else
                         f"{k} {v:.2f} us" for k, v in res.items())
        share = {lab: f"{b[0] / res[lab + 'kernel_ms'] * 100:.1f} %"
                 for lab in ("", "unfused_") if lab + "kernel_ms" in res}
        print(f"  {head}: {line}; kernel share of bound {share.get('', '-')}"
              f" (unfused {share.get('unfused_', '-')}) [{card}]")
        out[op] = res
        torch.cuda.empty_cache()
    return out


def time_tp_ops(torch, card, shape) -> dict:
    """:func:`time_ops` of the TP all-gather's encode and decode."""
    return time_ops(torch, card, f"TP all-gather {{op}}, bf16 {list(shape)} "
                    f"x {TP} shards, rate 16", tp_calls(torch, shape))


# the bf16 activations the TP reduce-scatters take, split along axis 1:
# tp@mlp_out / tp@attn_out ([2, 1024, 1152]: chunks of 9216 rows) and the
# narrow attention sites ([2, 1024, 256]: 2048 rows)
RS_SHAPES = ((GLOBAL_BATCH // DP, SEQ, 1152), (GLOBAL_BATCH // DP, SEQ, 256))


def time_rs_ops(torch, card, shapes=RS_SHAPES) -> dict:
    """:func:`time_ops` of the TP reduce-scatter's end at ``shapes``,
    keyed by the chunk's wire rows."""
    from repro_torch.kernels import bq
    out = {}
    for shape in shapes:
        rows = bq.padded_rows(int(np.prod(shape)) // TP)
        out[rows] = time_ops(
            torch, card, f"TP reduce-scatter {{op}}, bf16 {list(shape)} axis "
            f"1 over {TP} ranks (M={rows}), rate 16", rs_calls(torch, shape))
    return out


def time_kv_ops(torch, card, serve, slots: int = SLOTS,
                width: int | None = None) -> dict:
    """:func:`time_ops` of the paged KV read at the serving table (or
    another: ``slots`` rows, tokens of ``width`` values)."""
    r, rpb, nb = serve
    width = r * 128 if width is None else width
    return time_ops(torch, card, f"paged KV {{op}}, idx {slots}x"
                    f"{nb // slots}, {BLOCK_TOKENS} tokens x {width} of "
                    f"{r * 128} values, rate {MAIN_BITS}",
                    kv_calls(torch, serve, slots=slots, width=width))


def host_breakdown(torch, card, shape, bits: int = 16) -> None:
    """Host us per call of each step of the fused and the unfused TP ops
    (``host_us``: the caller's thread, the card keeping up)."""
    from repro_torch.kernels import bq, ops
    (fe, _, ue, _, _), (fd, _, ud, _, _) = tp_calls(torch, shape,
                                                    bits).values()
    x = torch.zeros(shape, dtype=torch.bfloat16, device="cuda")
    flat = x.reshape(-1)
    n, m = flat.numel(), bq.padded_rows(flat.numel())
    lib, dev = bq._load(), x.device
    hi, lo, sc = bq._wire_empty(m, bits, dev)
    stream = bq._stream(dev.index)
    blocks = torch.zeros((TP, m, 128), device=dev)
    steps = {
        "encode, fused op": fe,
        "  bq.bq_encode_flat wrapper": lambda: bq.bq_encode_flat(x, bits),
        "  output planes (torch.empty)": lambda: bq._wire_empty(m, bits,
                                                                dev),
        "  stream handle": lambda: bq._stream(dev.index),
        "  C call alone (ctypes + launch)": lambda: lib.bq_encode(
            flat.data_ptr(), 1, n, 1, hi.data_ptr(), None, sc.data_ptr(),
            m, bits, 32767.0, stream),
        "encode, unfused": ue,
        "  ops.to_blocks (cast + pad)": lambda: ops.to_blocks(x),
        "decode, fused op": fd,
        "decode, unfused": ud,
        "  strip + cast + movedim": lambda: torch.movedim(
            blocks.reshape(TP, -1)[:, :n].reshape((TP,) + tuple(shape))
            .to(torch.bfloat16), 0, 1).reshape(-1)}
    print("  host us per call (TP ops, rate 16): " + "; ".join(
        f"{k.strip()} {host_us(torch, f):.2f}" for k, f in steps.items())
        + f" [{card}]")


# --------------------------------------------------------------------------
# launches x (time - bound) per shape on the training path
# --------------------------------------------------------------------------

SHAPE_KERNELS = ("bq_encode", "bq_encode_flat", "bq_encode_view",
                 "bq_decode", "bq_decode_flat", "bq_decode_add_encode",
                 "bq_decode_add_encode_wire", "bq_decode_add_encode_view",
                 "bq_decode_add", "bq_decode_add_flat")


def shape_call(torch, name: str, rows: int, bits: int):
    """(call, bytes, operations) of one bq kernel at ``rows`` wire rows
    and rate ``bits`` on normals; the flat forms in bf16 with every row
    full (a gathered decode's shards as one); the view forms on chunk 0 of
    a bf16 payload split in two along an axis with runs of ``64 rows``
    values (the TP reduce-scatters' layout: [2, 1024, d] along axis 1)."""
    from repro_torch.kernels import bq
    rb = row_bytes(torch, bits)
    if name.endswith("_view") or name == "bq_decode_add_flat":
        x = normal_rows(torch, 2 * rows, seed=1).to(torch.bfloat16)
        view = bq.shard_view(x.reshape(2, 2 * rows * 64), 1, 2, 0)
        w = bq.encode_plain(normal_rows(torch, rows, seed=2), bits)
        if name == "bq_encode_view":
            return (lambda: bq.bq_encode_view(view, bits)), \
                rows * (256 + rb), rows * 128 * 6
        if name == "bq_decode_add_encode_view":
            return (lambda: bq.bq_decode_add_encode_view(*w, view, bits)), \
                rows * (2 * rb + 256), rows * 128 * 8
        out = torch.empty(rows * 128, dtype=torch.bfloat16, device="cuda")
        return (lambda: bq.bq_decode_add_flat(*w, view, bits, out)), \
            rows * (rb + 2 * 256), rows * 128 * 2
    if name in ("bq_encode", "bq_encode_flat"):
        x = normal_rows(torch, rows, seed=1)
        if name == "bq_encode":
            return (lambda: bq.bq_encode(x, bits)), rows * (512 + rb), \
                rows * 128 * 6
        x = x.to(torch.bfloat16).reshape(-1)
        return (lambda: bq.bq_encode_flat(x, bits)), rows * (256 + rb), \
            rows * 128 * 6
    if name in ("bq_decode", "bq_decode_flat"):
        w = bq.encode_plain(normal_rows(torch, rows, seed=2), bits)
        if name == "bq_decode":
            return (lambda: bq.bq_decode(*w, bits)), rows * (rb + 512), \
                rows * 128
        return (lambda: bq.bq_decode_flat(*w, bits, rows * 128,
                                          torch.bfloat16)), \
            rows * (rb + 256), rows * 128
    kind = {"bq_decode_add_encode": "sum", "bq_decode_add_encode_wire":
            "wire", "bq_decode_add": "add"}[name]
    return fused_fns(torch, kind, rows, bits, seed=5, data=normal_rows)[0], \
        fused_bytes(torch, kind, rows, bits), rows * 128 * 8


def shape_sums(res) -> dict:
    """{(kernel, rows, rate): launches} over the ranks of one run."""
    out = {}
    for r in res:
        for name, rows, bits, count in r["launch_shapes"]:
            out[(name, rows, bits)] = out.get((name, rows, bits), 0) + count
    return out


def reckon_shapes(torch, card, shapes: dict, rank_steps: int) -> dict:
    """Each (kernel, rows, rate) launched on the path, timed at its shape
    (L2 flushed: by events and the kernel alone by the profiler) beside its
    bound; launches and launches x (time - bound) per rank per step."""
    out = {}
    for (name, rows, bits), count in sorted(shapes.items()):
        if name not in SHAPE_KERNELS:
            continue
        fn, nbytes, nops = shape_call(torch, name, rows, bits)
        ms, kms = cold_ms(torch, fn), sum(kernel_ms(torch, fn).values())
        bms = bound(nbytes, nops)[0]
        per = count / rank_steps
        e = {"rows": rows, "rate": bits, "launches_per_rank_step": per,
             "ms": ms, "kernel_ms": kms, "kernel_ms_by": KERNEL_TIMER["by"],
             "bound_ms": bms,
             "gap_ms": per * (ms - bms), "kernel_gap_ms": per * (kms - bms)}
        out.setdefault(name, []).append(e)
        print(f"  {name} M={rows} rate {bits}: {per:g} launches per rank "
              f"per step, {ms * 1e3:.2f} us (L2 flushed; the kernel alone "
              f"{kms * 1e3:.2f} us) vs bound {bms * 1e3:.3f} us: "
              f"{e['gap_ms'] * 1e3:.1f} us ({e['kernel_gap_ms'] * 1e3:.1f} "
              f"us by the kernel alone) per rank per step [{card}]")
        del fn
        torch.cuda.empty_cache()
    for name, es in out.items():
        print(f"  {name}: launches x (time - bound) per rank per step "
              f"{sum(e['gap_ms'] for e in es):.4f} ms (kernel alone "
              f"{sum(e['kernel_gap_ms'] for e in es):.4f} ms) over "
              f"{len(es)} shapes [{card}]")
    return out


def rank_runs(*, rank: int, world: int, runs: list) -> list:
    """Body of one rank of :func:`train_runs`' world: ``train_rank`` for
    each keyword set of ``runs`` (``serve_rank`` for ``{"serve":
    keywords}``; for ``{"between": name}`` rank 0 calls this module's
    function ``name`` and every rank waits for it), in turn, each run's
    cached device memory given back before the next (the ranks share the
    card, and a run's largest rank may be another than the last run's).
    A training run's ``memory_fraction`` keeps this rank's allocator to
    that share of the card for the run: past it the allocator gives its
    own cached blocks back before it asks for more, where without a cap a
    rank short of memory cannot make its neighbours give back theirs; the
    card's bytes in use before such a run, every rank's cache given back,
    are its ``card_used_before``."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.serve import serve_rank
    from repro_torch.launch.train import train_rank
    out = []
    for kw in runs:
        t0 = time.perf_counter()
        if "serve" in kw:
            out.append(serve_rank(rank=rank, world=world, **kw["serve"]))
        elif "between" in kw:
            out.append(globals()[kw["between"]]() if rank == 0 else None)
            if world > 1:
                dist.barrier()
        else:
            kw = dict(kw)
            fraction = kw.pop("memory_fraction", 0.0)
            if fraction:
                # the card's use before the run, every rank's cache given
                # back: what the ranks' caps must leave room for
                if world > 1:
                    dist.barrier()
                free, total = torch.cuda.mem_get_info()
                torch.cuda.set_per_process_memory_fraction(fraction)
            out.append(train_rank(rank=rank, world=world, **kw))
            if fraction:
                torch.cuda.set_per_process_memory_fraction(1.0)
                out[-1]["card_used_before"] = total - free
        if isinstance(out[-1], dict):
            # the run's seconds in the world, its setup included, and its
            # allocator's peak reserved bytes (allocated, and cached free)
            out[-1]["run_s"] = time.perf_counter() - t0
            out[-1]["peak_reserved"] = torch.cuda.max_memory_reserved()
        torch.cuda.empty_cache()
    return out


def phase_seconds(card, world: str, runs: dict) -> dict:
    """Print and return the seconds each phase's runs took in a world
    (rank 0: setup, steps, serving), from ``runs`` ``{phase: [per-rank
    results of each run]}``."""
    out = {ph: sum(r[0]["run_s"] for r in res) for ph, res in runs.items()}
    print(f"seconds in the world of {world} by phase (rank 0, setup "
          f"included): " + ", ".join(f"{ph} {v:.1f}" for ph, v in
                                     out.items()) + f" [{card}]")
    return out


def run(label, scheme, backend=None, steps=STEPS, extra=(), dp=DP, tp=TP,
        arch="gemma3-1b", memory_fraction=0.0, **kw) -> dict:
    """One run of :func:`train_runs`: the launcher's flags for ``arch``
    (the main path's model by default), ``extra`` after them, and
    ``train_rank`` keywords; ``memory_fraction`` caps each rank's
    allocator in this run (:func:`rank_runs`)."""
    return dict(label=label, scheme=scheme, backend=backend, steps=steps,
                extra=tuple(extra), dp=dp, tp=tp, arch=arch, kw=kw,
                memory_fraction=memory_fraction)


def serve_run(label: str, backend=None, **kw) -> dict:
    """One serving run of :func:`train_runs`' world: ``serve_rank``'s
    keywords for gemma3-1b at full width on the card, deterministic, its
    exchanges timed, and ``kw``."""
    return dict(label=label, serve=dict(
        dict(arch="gemma3-1b", depth=SERVE_DEPTH, batch=SERVE_BATCH,
             prompt_len=SERVE_PROMPT, gen=SERVE_GEN, seed=SEED,
             device="cuda", backend=backend, deterministic=True,
             time_staging=True), **kw))


def train_runs(card, runs: list) -> list:
    """Runs of the launcher's training step in one world of ``pod x dp x cp
    x pp x tp`` processes on this card (:func:`run`; the ranks start once and
    train the runs in turn, each deterministic with its exchanges timed),
    and serving runs in the same world (:func:`serve_run`, whose numbers
    their phase prints); prints each training run's numbers and the
    world's wall, and returns each run's per-rank results."""
    from repro_torch.launch import serve, train

    kws, worlds = [], set()
    for r in runs:
        if "between" in r:
            kws.append(r)
            continue
        if "serve" in r:
            kw = r["serve"]
            kws.append({"serve": kw})
            worlds.add(serve.world_size(kw["mode"], kw.get("dp", 1),
                                        kw.get("tp", 1)))
            continue
        args = train.parser().parse_args(
            ["--arch", r["arch"], "--dp", str(r["dp"]), "--tp",
             str(r["tp"]), "--steps", str(r["steps"]), "--seq", str(SEQ),
             "--global-batch", str(GLOBAL_BATCH), "--seed", str(SEED),
             "--scheme", r["scheme"], *r["extra"]])
        kws.append(train.rank_kwargs(args, backend=r["backend"],
                                     deterministic=True, time_staging=True,
                                     **r["kw"]))
        if r["memory_fraction"]:
            kws[-1]["memory_fraction"] = r["memory_fraction"]
        r["tokens"] = args.global_batch * args.seq
        worlds.add(args.pod * args.dp * args.cp * args.pp * args.tp)
    if len(worlds) != 1:
        fail(f"runs of one world need one world size, got {worlds}")
    t0 = time.perf_counter()
    per_rank = train.spawn_world("chip_smoke:rank_runs", worlds.pop(),
                                 {"runs": kws})
    wall = time.perf_counter() - t0
    out = []
    for i, r in enumerate(runs):
        res = [ranks[i] for ranks in per_rank]
        if "between" in r:
            out.append(res[0])
            continue
        if "serve" in r:
            out.append(res)
            continue
        k = 1 if r["steps"] > 1 else 0         # the first step warms up
        step = [float(np.median(x["step_s"][k:])) for x in res]
        share = [sum(x["staging_s"][k:]) / sum(x["step_s"][k:]) for x in res]
        ms = max(step) * 1e3
        setup = res[0]["run_s"] - sum(res[0]["step_s"])
        print(f"  {r['label']}: {res[0]['run_s']:.1f} s in the world (setup "
              f"{setup:.1f} s, rank 0); losses {res[0]['losses']} grad norms "
              f"{[round(g, 6) for g in res[0]['grad_norms']]}; median "
              f"{ms:.1f} ms/step (steps {k + 1}-{r['steps']}, slowest "
              f"rank), {r['tokens'] / (ms / 1e3):.0f} tokens/s, peak "
              f"{[round(x['peak_bytes'] / 2**30, 2) for x in res]} GiB per "
              f"rank (reserved "
              f"{[round(x['peak_reserved'] / 2**30, 2) for x in res]}"
              + (f", under a cap of {r['memory_fraction']} of the card; "
                 f"the card held {res[0]['card_used_before'] / 2**30:.2f} "
                 f"GiB before the run" if r["memory_fraction"] else "")
              + f"), "
              f"staging+exchange {min(share) * 100:.0f}-"
              f"{max(share) * 100:.0f} % of step time, "
              f"{res[0]['staging_bytes'][-1] / 1e9:.2f} GB staged per step "
              f"(rank 0) [{card}]")
        out.append(res)
    n_runs = sum("between" not in r for r in runs)
    print(f"  wall {wall:.0f}s for {n_runs} run(s) in one world of "
          f"processes [{card}]")
    return out


def train_run(card, *args, **kw) -> list:
    """One :func:`run` in a world of its own."""
    return train_runs(card, [run(*args, **kw)])[0]


def level_sums(res) -> dict:
    """Launches per ``kernel/level``, all ranks."""
    out = {}
    for r in res:
        for k, v in r["launch_levels"].items():
            out[k] = out.get(k, 0) + v
    return out


def drive_hier(torch, card, only: str | None = None) -> tuple:
    """Phase 9: the node-factored meshes (9a ``--nodes``, 9b
    ``--tp-nodes``, 9c ``--pp-nodes``) in one world of four ranks, through
    the kernels and (9a, 9b) the plain versions, then phase 10, the tuned
    step, phase 11, context parallelism, phase 12, serving, phase 13,
    gemma3-4b with ZeRO-3, phase 14, qwen3-moe, phase 15, the recurrent
    families, phase 16, whisper-base, phase 17, the pod axis and the
    long-context decode, and phase 18, the four architectures that had run
    on the CPU only, in the same world, the dry-run (17e) in a process
    of its own beside it (:func:`check_tune`, :func:`check_cp`,
    :func:`check_serve`, :func:`check_zero3`, :func:`check_moe`,
    :func:`check_recurrent`, :func:`check_encdec`, :func:`check_pod`,
    :func:`check_archs`); returns each phase 9 run's launches per kernel
    and level (all ranks) and its numbers, phase 10's, 11's, 12's, 13's,
    14's, 15's, 16's, 17's and 18's.  ``only="cp"`` runs phase 11 alone,
    ``only="serve"`` phase 12 alone, ``only="zero3"`` phase 13 alone,
    ``only="moe"`` phase 14 alone, ``only="recurrent"`` phase 15 alone,
    ``only="encdec"`` phase 16 alone, ``only="pod"`` phase 17 alone,
    ``only="archs"`` phase 18 alone."""
    dry = start_dryrun() if only in (None, "pod") else None
    runs, names = [], []
    for name, scheme, steps, flags, plain, depth in \
            tuple(r + (0,) for r in (() if only else HIER_RUNS)) \
            + (CP_RUNS if only in (None, "cp") else ()):
        for backend in (None, "torch") if plain else (None,):
            runs.append(run(f"{name} {'plain' if backend else 'kernels'}",
                            scheme, backend, steps, flags, dp=1, tp=1,
                            **({"depth": depth} if depth else {})))
            names.append((name, backend))
    if not only:
        for backend in (None, "torch"):
            runs.append(run(f"10 {'plain' if backend else 'kernels'}",
                            TUNE_SCHEME, backend, TUNE_STEPS, TUNE_FLAGS,
                            dp=1, tp=1))
            names.append(("10", backend))
    if only in (None, "serve"):
        for name, kw, plain in SERVE_RUNS:
            extra = {"prompts": paged_prompts()} if kw["mode"] == "paged" \
                else {}
            for backend in (None, "torch") if plain else (None,):
                runs.append(serve_run(name, backend, **kw, **extra))
                names.append((name, backend))
    if only in (None, "zero3"):
        for backend in (None, "torch"):
            label = "13a kernels" if backend is None else "13b plain"
            runs.append(run(label, Z3_SCHEME, backend, Z3_STEPS, Z3_FLAGS,
                            dp=1, tp=1, arch=Z3_ARCH, depth=Z3_DEPTH,
                            overrides={"fsdp_params": True}))
            names.append(("13", backend))
        for backend in (None, "torch"):
            runs.append(serve_run("13c", backend, arch=Z3_ARCH,
                                  depth=Z3_DEPTH, gen=Z3_GEN,
                                  prompts=z3_prompts(), **Z3_SERVE))
            names.append(("13c", backend))
    if only in (None, "moe"):
        for backend in (None, "torch"):
            label = "14a kernels" if backend is None else "14b plain"
            runs.append(run(label, MOE_SCHEME, backend, MOE_STEPS, MOE_FLAGS,
                            dp=1, tp=1, arch=MOE_ARCH, depth=MOE_DEPTH,
                            overrides={"n_experts": MOE_EXPERTS}))
            names.append(("14", backend))
        for backend in (None, "torch"):
            runs.append(serve_run("14c", backend, arch=MOE_ARCH,
                                  depth=MOE_SERVE_DEPTH, **MOE_SERVE))
            names.append(("14c", backend))
    if only in (None, "recurrent"):
        for name, pname, arch, depth in REC_RUNS:
            for backend in (None, "torch"):
                label = f"{name} kernels" if backend is None \
                    else f"{pname} plain"
                runs.append(run(label, REC_SCHEME, backend, REC_STEPS,
                                REC_FLAGS, dp=1, tp=1, arch=arch,
                                depth=depth))
                names.append((name, backend))
        for _, _, arch, depth in REC_RUNS:
            for backend in (None, "torch"):
                runs.append(serve_run(f"15e {arch}", backend, arch=arch,
                                      depth=depth, **REC_SERVE))
                names.append((f"15e {arch}", backend))
    if only in (None, "encdec"):
        for backend in (None, "torch"):
            label = "16a kernels" if backend is None else "16b plain"
            runs.append(run(label, ENC_SCHEME, backend, ENC_STEPS, ENC_FLAGS,
                            dp=1, tp=1, arch=ENC_ARCH))
            names.append(("16", backend))
        for backend in (None, "torch"):
            runs.append(serve_run("16c", backend, arch=ENC_ARCH,
                                  **ENC_SERVE))
            names.append(("16c", backend))
    if only in (None, "pod"):
        for backend in (None, "torch"):
            label = "17a kernels" if backend is None else "17b plain"
            runs.append(run(label, POD_SCHEME, backend, POD_STEPS, POD_FLAGS,
                            dp=1, tp=1, arch=POD_ARCH, depth=POD_DEPTH))
            names.append(("17", backend))
        runs.append(run("17 --dp 4", POD_SCHEME, None, POD_STEPS,
                        POD_BASE_FLAGS, dp=1, tp=1, arch=POD_ARCH,
                        depth=POD_DEPTH))
        names.append(("17 dp4", None))
        for backend in (None, "torch"):
            runs.append(serve_run("17c" if backend is None else "17d",
                                  backend, arch=POD_ARCH, **LONG_SERVE))
            names.append(("17c", backend))
    if only in (None, "archs"):
        more, more_names = arch_runs()
        runs += more
        names += more_names
    t0 = time.perf_counter()
    res = dict(zip(names, train_runs(card, runs)))
    wall = time.perf_counter() - t0
    by_phase = {}
    for (name, _), r in res.items():
        by_phase.setdefault(re.match(r"\d+", name).group(), []).append(r)
    phase_seconds(card, "phases 9 to 18" if only is None
                  else f"phase {only}", by_phase)
    cp = check_cp(card, res) if only in (None, "cp") else {}
    serve = check_serve(card, res) if only in (None, "serve") else {}
    z3 = check_zero3(card, res) if only in (None, "zero3") else {}
    moe = check_moe(card, res) if only in (None, "moe") else {}
    rec = check_recurrent(card, res) if only in (None, "recurrent") else {}
    if rec:
        # phase 15's runs' own seconds in the world (its share of the wall)
        rec["seconds"] = sum(sum(r["step_s"]) for r in (
            res[(n, b)][0] for n, _, _, _ in REC_RUNS
            for b in (None, "torch"))) + sum(
            res[(f"15e {a}", b)][0]["wall_s"] for _, _, a, _ in REC_RUNS
            for b in (None, "torch"))
        print(f"phase 15: {rec['seconds']:.1f} s of steps and serving "
              f"(rank 0) of the world's {wall:.1f} s [{card}]")
    enc = check_encdec(card, res) if only in (None, "encdec") else {}
    if enc:
        # phase 16's runs' own seconds in the world
        enc["seconds"] = sum(sum(res[("16", b)][0]["step_s"])
                             + res[("16c", b)][0]["wall_s"]
                             for b in (None, "torch"))
        print(f"phase 16: {enc['seconds']:.1f} s of steps and serving "
              f"(rank 0) of the world's {wall:.1f} s [{card}]")
    pod = check_pod(card, res, finish_dryrun(dry)) \
        if only in (None, "pod") else {}
    if pod:
        # phase 17's runs' own seconds in the world
        pod["seconds"] = sum(sum(res[(n, b)][0]["step_s"]) for n, b in (
            ("17", None), ("17", "torch"), ("17 dp4", None))) + sum(
            res[("17c", b)][0]["wall_s"] for b in (None, "torch"))
        print(f"phase 17: {pod['seconds']:.1f} s of steps and serving "
              f"(rank 0) of the world's {wall:.1f} s; the dry-run "
              f"{pod['17e']['seconds']:.1f} s beside it [{card}]")
    archs = check_archs(card, res) if only in (None, "archs") else {}
    if archs:
        # phase 18's runs' own seconds in the world
        archs["seconds"] = sum(sum(res[("18", b)][0]["step_s"])
                               for b in (None, "torch")) + sum(
            res[(n, b)][0]["wall_s"] for n, _, _ in ARCH_SERVE
            for b in (None, "torch"))
        print(f"phase 18: {archs['seconds']:.1f} s of steps and serving "
              f"(rank 0) of the world's {wall:.1f} s [{card}]")
    if only:
        return {}, {}, cp, serve, z3, moe, rec, enc, pod, archs
    out = {}
    for name, scheme, steps, flags, plain in HIER_RUNS:
        k = res[(name, None)]
        for rk in k:
            if not np.isfinite(rk["losses"]).all():
                fail(f"phase {name} rank {rk['rank']}: losses "
                     f"{rk['losses']}")
        if plain:
            p = res[(name, "torch")]
            for rk, rp in zip(k, p):
                for key in ("losses", "grad_norms", "wire_per_dim",
                            "priced_per_dim_level", "link_bytes"):
                    if rk[key] != rp[key]:
                        fail(f"phase {name} rank {rk['rank']}: {key} differ "
                             f"between the kernel run ({rk[key]}) and the "
                             f"plain run ({rp[key]})")
            if any(v for r in p for v in r["launches"].values()):
                fail(f"phase {name}: the plain run launched kernels: "
                     f"{[r['launches'] for r in p]}")
        levels = level_sums(k)
        missing = sorted(f"{kern}/{lvl}"
                         for lvl, kerns in HIER_LEVELS[name].items()
                         for kern in kerns if not levels.get(f"{kern}/{lvl}"))
        if missing:
            fail(f"phase {name}: no launch of {missing}; launches by level "
                 f"{levels}")
        step = max(float(np.median(r["step_s"][1:])) for r in k)
        share = [sum(r["staging_s"][1:]) / sum(r["step_s"][1:]) for r in k]
        peak = [round(r["peak_bytes"] / 2**30, 2) for r in k]
        r0 = k[0]
        same = ("kernel run == plain run (losses, grad norms, ledger per dim "
                "and dim/level, link bytes) on every rank; ") if plain else ""
        print(f"phase {name} ({scheme}, {' '.join(flags)}): {same}"
              f"losses {r0['losses']}; {step * 1e3:.1f} ms/step, "
              f"{GLOBAL_BATCH * SEQ / step:.0f} tokens/s, peak {peak} GiB per "
              f"rank, staging+exchange {min(share) * 100:.0f}-"
              f"{max(share) * 100:.0f} %; priced wire per rank per step by "
              f"dim/level {r0['priced_per_dim_level']}, link bytes "
              f"{r0['link_bytes']}; launches (all ranks) by kernel/level "
              f"{levels} [{card}]")
        out[name] = {"launches": launch_sums(k), "levels": levels,
                     "step_ms": step * 1e3, "tokens_per_s":
                     GLOBAL_BATCH * SEQ / step, "peak_gib": peak,
                     "staging_share": [min(share), max(share)],
                     "per_dim_level": r0["priced_per_dim_level"],
                     "link_bytes": r0["link_bytes"]}
    return out, check_tune(card, res[("10", None)], res[("10", "torch")]), \
        cp, serve, z3, moe, rec, enc, pod, archs


# what a training run's kernel and plain runs must agree in
TRAIN_KEYS = ("losses", "grad_norms", "wire_per_dim", "priced_per_dim",
              "priced_per_dim_level")


def same_runs(what: str, k, p, keys) -> None:
    """Fail unless the kernel run ``k`` and the plain run ``p`` agree on
    every rank in ``keys`` (and, for served runs, every cache leaf or pool
    plane by sha256), no rank imported jax or repro, and ``p`` launched
    nothing."""
    for rk, rp in zip(k, p):
        if rk["foreign_modules"] or rp["foreign_modules"]:
            fail(f"phase {what} rank {rk['rank']} imported "
                 f"{rk['foreign_modules'] or rp['foreign_modules']}")
        for key in keys:
            if rk[key] != rp[key]:
                fail(f"phase {what} rank {rk['rank']}: {key} differ between "
                     f"the kernel run ({rk[key]}) and the plain run "
                     f"({rp[key]})")
        for when, dig in rk.get("digests", {}).items():
            bad = sorted(leaf for leaf, h in dig.items()
                         if rp["digests"][when][leaf] != h)
            if bad:
                fail(f"phase {what} rank {rk['rank']}: {when} caches or pool "
                     f"planes {bad} differ between the kernel run and the "
                     f"plain run")
    if any(v for r in p for v in r["launches"].values()):
        fail(f"phase {what}: the plain run launched kernels: "
             f"{[r['launches'] for r in p]}")


def missing_kernels(what: str, k, kernels) -> dict:
    """Launches (all ranks) by ``kernel/level`` of the kernel run ``k``;
    fail if a kernel of ``kernels`` never launched at the flat level."""
    levels = level_sums(k)
    missing = sorted(n for n in kernels if not levels.get(f"{n}/flat"))
    if missing:
        fail(f"phase {what}: no launch of {missing}; launches by level "
             f"{levels}")
    return levels


def paged_prompts() -> list:
    """12c's requests: PAGED_REQUESTS prompts of mixed lengths in
    PAGED_LENS, from SEED."""
    rng = np.random.default_rng(SEED)
    lens = rng.integers(PAGED_LENS[0], PAGED_LENS[1] + 1, PAGED_REQUESTS)
    return [rng.integers(0, 262144, int(n)).tolist() for n in lens]


def check_serve(card, res: dict) -> dict:
    """Phase 12: the serving runs (``res[(name, backend)]``): well-formed
    tokens, the kernel run equal to the plain run bit for bit (tokens and
    every cache leaf or pool plane after the prefill, the handoff and the
    last step, by sha256), none launched in the plain run, a launch at
    each link level of every kernel SERVE_LEVELS names, 12d's handoff all
    ``kv`` and below what the same scheme with a ``none`` kv codec prices
    for its events (``roofline.recost_events``), no rank importing jax or
    repro; prints each run's numbers and returns them."""
    from repro_torch.analysis import roofline
    from repro_torch.serve import paged_kv

    out = {}
    for name, kw, plain in SERVE_RUNS:
        k = res[(name, None)]
        for rk in k:
            if rk["foreign_modules"]:
                fail(f"phase {name} rank {rk['rank']} imported "
                     f"{rk['foreign_modules']}")
        live = [r for r in k if r.get("meaningful", True)]
        toks = live[0]["tokens"]
        n_req = PAGED_REQUESTS if kw["mode"] == "paged" else SERVE_BATCH
        if len(toks) != n_req or any(
                len(t) != SERVE_GEN or min(t) < 0 or max(t) >= 262144
                for t in toks) or any(r["tokens"] != toks for r in live):
            fail(f"phase {name}: malformed or disagreeing tokens")
        if plain:
            p = res[(name, "torch")]
            for rk, rp in zip(k, p):
                if rk["tokens"] != rp["tokens"]:
                    fail(f"phase {name} rank {rk['rank']}: tokens differ "
                         f"between the kernel run and the plain run")
                for when, dig in rk["digests"].items():
                    bad = sorted(leaf for leaf, h in dig.items()
                                 if rp["digests"][when][leaf] != h)
                    if bad:
                        fail(f"phase {name} rank {rk['rank']}: {when} "
                             f"caches {bad} differ between the kernel run "
                             f"and the plain run")
            if any(v for r in p for v in r["launches"].values()):
                fail(f"phase {name}: the plain run launched kernels: "
                     f"{[r['launches'] for r in p]}")
        levels = level_sums(k)
        missing = sorted(f"{kern}/{lvl}"
                         for lvl, kerns in SERVE_LEVELS[name].items()
                         for kern in kerns if not levels.get(f"{kern}/{lvl}"))
        if missing:
            fail(f"phase {name}: no launch of {missing}; launches by level "
                 f"{levels}")
        r0 = live[0]
        dec = [sum(r["decode_s"]) for r in k]
        step_ms = max(float(np.median(r["decode_s"])) for r in k) * 1e3
        n_gen = sum(len(t) for t in toks) if kw["mode"] == "paged" \
            else SERVE_BATCH * (SERVE_GEN - 1)
        share = [r["staging_s"] / r["wall_s"] for r in k]
        peak = [round(r["peak_bytes"] / 2**30, 2) for r in k]
        mb = {ph: {key: round(v / 1e6, 4) for key, v in led["priced"].items()
                   if v} for ph, led in r0["ledger"].items()}
        entry = {"launches": launch_sums(k), "levels": levels,
                 "prefill_s": max(r["prefill_s"] for r in k),
                 "decode_ms_per_step": step_ms, "steps": r0["steps"],
                 "gen_tokens_per_s": n_gen / max(dec),
                 "peak_gib": peak, "staging_share": [min(share), max(share)],
                 "priced_mb": mb}
        extra = ""
        if kw["mode"] == "disagg":
            evs = r0["ledger"]["handoff"]["events"]
            dims = {roofline.tag_dim(e["tag"]) for e in evs}
            kv_b = r0["ledger"]["handoff"]["priced"].get("kv/flat", 0.0)
            none_b = roofline.ledger_summary(
                roofline.recost_events(evs, "baseline"),
                train=False)["per_dim_level"].get("kv/flat", 0.0)
            if dims != {"kv"} or not 0 < kv_b < none_b:
                fail(f"phase {name}: handoff dims {dims}, kv bytes {kv_b} "
                     f"against {none_b} under a none kv codec")
            secs = roofline.kv_handoff_seconds(
                evs, FAST_LINK_BYTES_PER_S, SLOW_LINK_BYTES_PER_S)
            entry.update(handoff_mb=kv_b / 1e6, handoff_none_mb=none_b / 1e6,
                         handoff_s=max(r["handoff_s"] for r in k),
                         kv_handoff_s_assumed_rates=secs)
            extra = (f"; handoff {kv_b / 1e6:.4f} MB per rank priced "
                     f"(under a none kv codec {none_b / 1e6:.4f} MB), "
                     f"{entry['handoff_s'] * 1e3:.1f} ms (slowest rank), "
                     f"kv_handoff_seconds {secs * 1e3:.4f} ms at assumed "
                     f"link rates {FAST_LINK_BYTES_PER_S / 1e9:.0f} / "
                     f"{SLOW_LINK_BYTES_PER_S / 1e9:.0f} GB/s")
        if kw["mode"] == "paged":
            mbk = paged_kv.blocks_needed(
                max(map(len, paged_prompts())) + SERVE_GEN, BLOCK_TOKENS)
            n_blocks = max(PAGED_SLOTS, kw["dp"]) * mbk
            hbm = roofline.kv_hbm_bytes(n_blocks, BLOCK_TOKENS, SERVE_DEPTH,
                                        1, 256, "bq8", "bfloat16")
            alloc = sum(r["pool_bytes"] for r in k)
            entry.update(kv_hbm_bytes=hbm, pool_bytes=alloc,
                         n_blocks=n_blocks)
            extra = (f"; pool {n_blocks} blocks: kv_hbm_bytes {hbm:.0f} B, "
                     f"allocated {alloc} B (all ranks)")
        same = ("kernel run == plain run (tokens, every cache leaf or pool "
                "plane by sha256) on every rank; ") if plain else ""
        print(f"phase {name} ({', '.join(f'{a} {b}' for a, b in kw.items())}"
              f"): {same}first tokens {[t[0] for t in toks[:4]]}; prefill "
              f"{entry['prefill_s']:.3f} s, {r0['steps']} decode steps at "
              f"{step_ms:.2f} ms/step (median, slowest rank), "
              f"{entry['gen_tokens_per_s']:.1f} generated tok/s, peak {peak} "
              f"GiB per rank, staging+exchange {min(share) * 100:.0f}-"
              f"{max(share) * 100:.0f} %; priced MB per rank per dim/level "
              f"{mb}{extra}; launches (all ranks) by kernel/level {levels} "
              f"[{card}]")
        out[name] = entry
    return out


def z3_prompts(vocab: int = 262144) -> list:
    """13c's requests: Z3_REQUESTS prompts of lengths in Z3_LENS, from
    SEED, their token ids below ``vocab`` (phase 18's take each model's)."""
    rng = np.random.default_rng(SEED + 13)
    lens = rng.integers(Z3_LENS[0], Z3_LENS[1] + 1, Z3_REQUESTS)
    return [rng.integers(0, vocab, int(n)).tolist() for n in lens]


def z3_zero_rows() -> dict:
    """Per class-A leaf of 13a's plan (one layer's shard on a rank), its
    wire rows: ``{leaf: rows}``, the rows the zero site's flat encode,
    view encode and fused decode-add run at (the flat decode at twice
    them: the two data ranks' shards)."""
    from repro_torch import configs
    from repro_torch.kernels.bq import padded_rows
    from repro_torch.models.params import MeshInfo, _leaves, local_shape
    from repro_torch.models.transformer import model_plan

    mi = MeshInfo(tp=2, dp=2)
    cfg = configs.get(Z3_ARCH).truncated(Z3_DEPTH).replace(fsdp_params=True)
    return {"/".join(map(str, path[1:])): padded_rows(
                int(np.prod(local_shape(d, mi)[1:])))
            for path, d in _leaves(model_plan(cfg, mi)) if "data" in d.spec}


def zero1_priced(events, n_all: int, n_flat: int) -> dict:
    """What ZeRO-1 would price, per ``dim/level``, for the dp and zero
    dims of a ZeRO-3 step: its ``dp@zero1_grad`` reduce-scatter and
    ``zero@zero1_param`` gather scaled from the step's flat vector of
    ``n_flat`` elements (classes B and C) to every leaf's ``n_all`` (the
    padding of the scaled vector not re-derived)."""
    from repro_torch.analysis import roofline
    evs = [{**{k: v for k, v in e.items() if k != "ring"},
            "elems": int(e["elems"] * n_all / n_flat),
            "nbytes": int(e["nbytes"] * n_all / n_flat)}
           for e in events if e["tag"] in ("dp@zero1_grad",
                                           "zero@zero1_param")]
    return roofline.ledger_summary(evs, train=True)["per_dim_level"]


def check_zero3(card, res: dict) -> dict:
    """Phase 13: 13a (ZeRO-3 through the kernels) equal to 13b (the plain
    versions) in losses, grad norms and ledger (measured per dim, priced
    per dim and per ``dim/level``), finite losses, priced ``zero`` bytes,
    the four zero-site kernels launched at the class-A shards' rows at
    rate 16, the gather's flat encode and decode twice (the config's
    remat) for each reduce-scatter's view encode and fused decode-add,
    and nothing launched in 13b; 13c's kernel run equal to its
    plain run bit for bit (tokens and every pool plane by sha256) with
    the pool write and the KV read launched, none in the plain run; no
    rank importing jax or repro.  Prints the numbers and returns them."""
    from repro_torch.models.params import MeshInfo, defs, local_shape
    from repro_torch.models.transformer import model_plan
    from repro_torch import configs

    k, p = res[("13", None)], res[("13", "torch")]
    same_runs("13a/13b", k, p, TRAIN_KEYS)
    for rk in k:
        if not np.isfinite(rk["losses"]).all():
            fail(f"phase 13a rank {rk['rank']}: losses {rk['losses']}")
    zrows = z3_zero_rows()
    shapes = {}
    for r in k:
        for name, rows, bits, c in r["launch_shapes"]:
            shapes[(name, rows, bits)] = shapes.get((name, rows, bits), 0) + c
    at_zero = {}
    for kern in Z3_ZERO_KERNELS:
        want = {2 * m if kern == "bq_decode_flat" else m
                for m in zrows.values()}
        at_zero[kern] = {rows: c for (n, rows, bits), c in shapes.items()
                         if n == kern and bits == 16 and rows in want}
        if not at_zero[kern]:
            fail(f"phase 13a: {kern} never launched at the zero site's rows "
                 f"{sorted(want)} (rate 16); launches by shape "
                 f"{sorted(key for key in shapes if key[0] == kern)}")
    # each shard's gather runs in the forward (again in the remat's
    # recompute: the flat encode and decode), its gradient's
    # reduce-scatter once in the backward (the view encode, the fused
    # decode-add)
    cfg = configs.get(Z3_ARCH).truncated(Z3_DEPTH).replace(fsdp_params=True)
    n_rs, n_ag = sum(at_zero["bq_encode_view"].values()), \
        layer_passes(cfg) - 1
    want_n = {"bq_encode_flat": n_ag * n_rs, "bq_decode_flat": n_ag * n_rs,
              "bq_encode_view": n_rs, "bq_decode_add_flat": n_rs}
    got_n = {kern: sum(v.values()) for kern, v in at_zero.items()}
    if got_n != want_n:
        fail(f"phase 13a: launches at the zero site's rows {got_n}, want "
             f"{want_n} (the gather {n_ag} times a reduce-scatter)")
    r0 = k[0]
    priced = {key: v for key, v in r0["priced_per_dim_level"].items() if v}
    if not priced.get("zero/flat"):
        fail(f"phase 13a: no zero bytes priced: {priced}")
    mi = MeshInfo(tp=2, dp=2)
    ds = defs(model_plan(cfg, mi))
    n_all = sum(int(np.prod(local_shape(d, mi))) for d in ds)
    n_flat = sum(int(np.prod(local_shape(d, mi))) for d in ds
                 if "data" not in d.spec)
    z1 = zero1_priced(r0["events0"], n_all, n_flat)
    step = max(float(np.median(r["step_s"][1:])) for r in k)
    share = [sum(r["staging_s"][1:]) / sum(r["step_s"][1:]) for r in k]
    peak = [round(r["peak_bytes"] / 2**30, 2) for r in k]
    mb = {key: round(v / 1e6, 3) for key, v in priced.items()}
    z1mb = {key: round(v / 1e6, 3) for key, v in z1.items() if v}
    out = {"step_ms": step * 1e3, "tokens_per_s": GLOBAL_BATCH * SEQ / step,
           "peak_gib": peak, "staging_share": [min(share), max(share)],
           "priced_mb": mb, "zero1_priced_mb": z1mb,
           "zero_site_launches": {kk: {str(rows): c for rows, c in v.items()}
                                  for kk, v in at_zero.items()},
           "launches": launch_sums(k), "levels": level_sums(k),
           "class_a_rows": zrows, "losses": r0["losses"]}
    print(f"phase 13a/13b ({Z3_ARCH} full width, the first {Z3_DEPTH} "
          f"layers, {' '.join(Z3_FLAGS)}, {Z3_SCHEME}, ZeRO-3): kernel run "
          f"== plain run (losses, grad norms, ledger per dim and dim/level) "
          f"on every rank; losses {r0['losses']}, grad norms "
          f"{[round(g, 6) for g in r0['grad_norms']]}; {step * 1e3:.1f} "
          f"ms/step (median of steps 2-{Z3_STEPS}, slowest rank), "
          f"{out['tokens_per_s']:.0f} tokens/s, peak {peak} GiB per rank, "
          f"staging+exchange {min(share) * 100:.0f}-{max(share) * 100:.0f} "
          f"% [{card}]")
    print(f"phase 13a priced MB per rank per step by dim/level {mb}; "
          f"ZeRO-1 would price for the same step dp and zero (its flat "
          f"sync scaled to every leaf) {z1mb}; {len(zrows)} class-A group "
          f"leaves, a layer's shard at rows {sorted(set(zrows.values()))}; "
          f"zero-site "
          f"launches (all ranks) by kernel {{rows: launches}} {at_zero}; "
          f"launches (all ranks) {out['launches']} [{card}]")
    # 13c: paged serving at tp 2
    k, p = res[("13c", None)], res[("13c", "torch")]
    toks = k[0]["tokens"]
    if len(toks) != Z3_REQUESTS or any(
            len(t) != Z3_GEN or min(t) < 0 or max(t) >= 262144
            for t in toks) or any(r["tokens"] != toks for r in k):
        fail("phase 13c: malformed or disagreeing tokens")
    same_runs("13c", k, p, ("tokens",))
    levels = missing_kernels("13c", k, Z3_SERVE_KERNELS)
    dec = [sum(r["decode_s"]) for r in k]
    step_ms = max(float(np.median(r["decode_s"])) for r in k) * 1e3
    n_gen = sum(len(t) for t in toks)
    sshare = [r["staging_s"] / r["wall_s"] for r in k]
    speak = [round(r["peak_bytes"] / 2**30, 2) for r in k]
    out["13c"] = {"launches": launch_sums(k), "levels": levels,
                  "decode_ms_per_step": step_ms, "steps": k[0]["steps"],
                  "gen_tokens_per_s": n_gen / max(dec), "peak_gib": speak,
                  "staging_share": [min(sshare), max(sshare)],
                  "pool_bytes": sum(r["pool_bytes"] for r in k)}
    print(f"phase 13c ({Z3_ARCH}, the first {Z3_DEPTH} layers, "
          f"{', '.join(f'{a} {b}' for a, b in Z3_SERVE.items())}, "
          f"{Z3_REQUESTS} requests of {Z3_LENS[0]}-{Z3_LENS[1]} tokens + "
          f"{Z3_GEN}): kernel run == plain run (tokens, every pool plane by "
          f"sha256) on every rank; first tokens {[t[0] for t in toks]}; "
          f"{k[0]['steps']} decode steps at {step_ms:.2f} ms/step (median, "
          f"slowest rank), {out['13c']['gen_tokens_per_s']:.1f} generated "
          f"tok/s, peak {speak} GiB per rank, staging+exchange "
          f"{min(sshare) * 100:.0f}-{max(sshare) * 100:.0f} %; launches (all "
          f"ranks) by kernel/level {levels} [{card}]")
    return out


def layer_passes(cfg) -> int:
    """How often a training step moves a collective inside a layer group
    (and the ledger prices it): its forward, its backward twin and, under
    ``cfg.remat``, the forward again in the rematerialized backward."""
    return 3 if cfg.remat else 2


def moe_ep_reckoned() -> float:
    """14a's priced ep bytes per rank per step, reckoned: two all-to-alls
    a layer (dispatch and combine) of the [E * C, D] buffer at bq16, each
    :func:`layer_passes` times (six a layer under the config's remat),
    (ep - 1) / ep of it crossing."""
    from repro_torch import configs
    from repro_torch.core import codecs
    elems = MOE_EXPERTS * 640 * 4096
    return MOE_DEPTH * 2 * layer_passes(configs.get(MOE_ARCH)) \
        * codecs.get("bq16").wire_nbytes_for(elems) / 2


def check_moe(card, res: dict) -> dict:
    """Phase 14: 14a (qwen3-moe through the kernels) equal to 14b (the
    plain versions) in losses, grad norms, the load-balance loss, the drop
    fraction and the ledger (measured per dim, priced per dim and per
    ``dim/level``), finite losses, the ep bytes priced at their reckoning,
    the block encode and decode launched at the ep sites' rows at rate 16
    and nothing launched in 14b; 14c's kernel run equal to its plain run
    (tokens, every cache leaf after the prefill and at the end by sha256),
    its ep all-to-alls launched; no rank importing jax or repro.  Prints
    the numbers and returns them."""
    k, p = res[("14", None)], res[("14", "torch")]
    same_runs("14a/14b", k, p, TRAIN_KEYS + ("lb_loss", "drop_frac"))
    for rk in k:
        if not np.isfinite(rk["losses"]).all():
            fail(f"phase 14a rank {rk['rank']}: losses {rk['losses']}")
    r0 = k[0]
    priced = {key: v for key, v in r0["priced_per_dim_level"].items() if v}
    want_ep = moe_ep_reckoned()
    if abs(priced.get("ep/flat", 0) / want_ep - 1) > 1e-9:
        fail(f"phase 14a: ep priced {priced.get('ep/flat')} B per rank per "
             f"step, reckoned {want_ep}")
    if not priced.get("zero/flat"):
        fail(f"phase 14a: no zero bytes priced (ZeRO-3): {priced}")
    shapes = {}
    for r in k:
        for name, rows, bits, c in r["launch_shapes"]:
            shapes[(name, rows, bits)] = shapes.get((name, rows, bits), 0) + c
    # per rank per step: a layer's 2 sites x (forward, the remat's
    # forward, backward)
    from repro_torch import configs
    want_n = MOE_DEPTH * 2 * layer_passes(configs.get(MOE_ARCH)) * len(k) \
        * MOE_STEPS
    at_ep = {kern: shapes.get((kern, MOE_EP_ROWS, 16), 0)
             for kern in ("bq_encode", "bq_decode")}
    if any(v != want_n for v in at_ep.values()):
        fail(f"phase 14a: the ep sites' block launches at {MOE_EP_ROWS} "
             f"rows (rate 16) {at_ep}, want {want_n} each")
    step = max(float(np.median(r["step_s"][1:])) for r in k)
    share = [sum(r["staging_s"][1:]) / sum(r["step_s"][1:]) for r in k]
    peak = [round(r["peak_bytes"] / 2**30, 2) for r in k]
    mb = {key: round(v / 1e6, 3) for key, v in priced.items()}
    out = {"step_ms": step * 1e3, "tokens_per_s": GLOBAL_BATCH * SEQ / step,
           "peak_gib": peak, "staging_share": [min(share), max(share)],
           "priced_mb": mb, "ep_reckoned_mb": want_ep / 1e6,
           "lb_loss": r0["lb_loss"], "drop_frac": r0["drop_frac"],
           "ep_site_launches": at_ep, "ep_rows": MOE_EP_ROWS,
           "launches": launch_sums(k), "levels": level_sums(k),
           "losses": r0["losses"]}
    print(f"phase 14a/14b ({MOE_ARCH} full width but {MOE_EXPERTS} experts, "
          f"the first {MOE_DEPTH} layer(s), {' '.join(MOE_FLAGS)}, "
          f"{MOE_SCHEME}, ZeRO-3): kernel run == plain run (losses, grad "
          f"norms, lb_loss, drop_frac, ledger per dim and dim/level) on "
          f"every rank; losses {r0['losses']}, grad norms "
          f"{[round(g, 6) for g in r0['grad_norms']]}, lb_loss per step "
          f"{r0['lb_loss']}, drop_frac per step {r0['drop_frac']}; "
          f"{step * 1e3:.1f} ms/step (median of steps 2-{MOE_STEPS}, "
          f"slowest rank), {out['tokens_per_s']:.0f} tokens/s, peak {peak} "
          f"GiB per rank, staging+exchange {min(share) * 100:.0f}-"
          f"{max(share) * 100:.0f} % [{card}]")
    print(f"phase 14a priced MB per rank per step by dim/level {mb}; ep/flat "
          f"reckoned {want_ep / 1e6:.3f} MB; the ep sites' block launches "
          f"(all ranks) at {MOE_EP_ROWS} rows, rate 16: {at_ep}; launches "
          f"(all ranks) {out['launches']} [{card}]")
    # 14c: serving all 128 experts at tp 4
    k, p = res[("14c", None)], res[("14c", "torch")]
    toks = k[0]["tokens"]
    vocab = 151936
    if len(toks) != MOE_SERVE["batch"] or any(
            len(t) != SERVE_GEN or min(t) < 0 or max(t) >= vocab
            for t in toks) or any(r["tokens"] != toks for r in k):
        fail("phase 14c: malformed or disagreeing tokens")
    same_runs("14c", k, p, ("tokens",))
    levels = missing_kernels("14c", k, ("bq_encode", "bq_decode"))
    sprice = {ph: {key: round(v / 1e6, 3)
                   for key, v in k[0]["ledger"][ph]["priced"].items() if v}
              for ph in ("prefill", "decode")}
    if not all(sprice[ph].get("ep/flat") for ph in sprice):
        fail(f"phase 14c: no ep bytes priced: {sprice}")
    dec = [sum(r["decode_s"]) for r in k]
    step_ms = max(float(np.median(r["decode_s"])) for r in k) * 1e3
    sshare = [r["staging_s"] / r["wall_s"] for r in k]
    speak = [round(r["peak_bytes"] / 2**30, 2) for r in k]
    out["14c"] = {"launches": launch_sums(k), "levels": levels,
                  "prefill_s": max(r["prefill_s"] for r in k),
                  "decode_ms_per_step": step_ms,
                  "gen_tokens_per_s": MOE_SERVE["batch"] * (SERVE_GEN - 1)
                  / max(dec), "peak_gib": speak,
                  "staging_share": [min(sshare), max(sshare)],
                  "priced_mb": sprice}
    print(f"phase 14c ({MOE_ARCH} full width, all 128 experts, the first "
          f"{MOE_SERVE_DEPTH} layers, batched --tp {MOE_SERVE['tp']}, "
          f"{MOE_SERVE['scheme']}, {MOE_SERVE['batch']} prompts of "
          f"{SERVE_PROMPT} + {SERVE_GEN}): kernel run == plain run (tokens, "
          f"every cache leaf after the prefill and at the end by sha256) on "
          f"every rank; tokens {toks}; prefill {out['14c']['prefill_s']:.2f}"
          f" s, {step_ms:.2f} ms/decode step (median, slowest rank), "
          f"{out['14c']['gen_tokens_per_s']:.1f} generated tok/s, peak "
          f"{speak} GiB per rank, staging+exchange {min(sshare) * 100:.0f}-"
          f"{max(sshare) * 100:.0f} %; priced MB per rank by dim/level "
          f"{sprice}; launches (all ranks) by kernel/level {levels} "
          f"[{card}]")
    return out


def arch_ep_rows(cfg, tokens: int) -> int:
    """Wire rows of one rank's ep all-to-all (the whole [E * C, D] dispatch
    buffer encoded at once) when ``tokens`` tokens are routed, C the
    capacity (``moe.capacity``)."""
    from repro_torch.kernels.bq import padded_rows
    from repro_torch.models.moe import capacity
    return padded_rows(cfg.n_experts * capacity(cfg, tokens) * cfg.d_model)


def arch_runs() -> tuple:
    """Phase 18's runs (:func:`run`, :func:`serve_run`) and their names:
    18a/18b minitron-4b trained (kernels, plain), then each of ARCH_SERVE
    served through the kernels and through the plain versions."""
    from repro_torch import configs
    runs, names = [], []
    for backend in (None, "torch"):
        label = "18a kernels" if backend is None else "18b plain"
        runs.append(run(label, ARCH_SCHEME, backend, ARCH_STEPS, ARCH_FLAGS,
                        dp=1, tp=1, arch=ARCH_TRAIN, depth=ARCH_DEPTH,
                        memory_fraction=ARCH_FRACTION))
        names.append(("18", backend))
    for name, arch, kw in ARCH_SERVE:
        extra = {"prompts": z3_prompts(configs.get(arch).vocab_size)} \
            if kw["mode"] == "paged" else {}
        for backend in (None, "torch"):
            runs.append(serve_run(name, backend, arch=arch, depth=ARCH_DEPTH,
                                  scheme=ARCH_SCHEME, **kw, **extra))
            names.append((name, backend))
    return runs, names


def check_archs(card, res: dict) -> dict:
    """Phase 18: 18a (minitron-4b trained through the kernels) equal to 18b
    (the plain versions) in losses, grad norms and ledger (measured per
    dim, priced per dim and per ``dim/level``), finite losses, each kernel
    of ARCH_KERNELS["18a"] launched and no block encode or decode-add at
    the TP reduce-scatters' rows; each served run of ARCH_SERVE equal to
    its plain run (tokens, every cache leaf or pool plane by sha256), its
    kernels launched, 18e's ep all-to-alls' block encode and decode at
    :func:`arch_ep_rows` twice a decode step on every rank; nothing
    launched in a plain run, no rank importing jax or repro.  Prints each
    run's numbers and returns them."""
    from repro_torch import configs
    from repro_torch.analysis import roofline
    from repro_torch.kernels.bq import padded_rows
    from repro_torch.serve import paged_kv

    k, p = res[("18", None)], res[("18", "torch")]
    same_runs("18a/18b", k, p, TRAIN_KEYS)
    for rk in k:
        if not np.isfinite(rk["losses"]).all():
            fail(f"phase 18a rank {rk['rank']}: losses {rk['losses']}")
    levels = missing_kernels("18a", k, ARCH_KERNELS["18a"])
    # the TP reduce-scatters' chunk: a rank's [2, SEQ, d_model] over tp 2
    tp_rows = {padded_rows(GLOBAL_BATCH // 2 * SEQ
                           * configs.get(ARCH_TRAIN).d_model // 2)}
    block = {key: c for key, c in shape_sums(k).items()
             if key[0] in ("bq_encode", "bq_decode_add") and key[1] in tp_rows}
    if block:
        fail(f"phase 18a: block forms at the TP reduce-scatters' rows "
             f"{block}")
    r0 = k[0]
    step = max(float(np.median(r["step_s"][1:])) for r in k)
    share = [sum(r["staging_s"][1:]) / sum(r["step_s"][1:]) for r in k]
    peak = [round(r["peak_bytes"] / 2**30, 2) for r in k]
    mb = {key: round(v / 1e6, 3) for key, v in
          r0["priced_per_dim_level"].items() if v}
    out = {"18a": {"step_ms": step * 1e3,
                   "tokens_per_s": GLOBAL_BATCH * SEQ / step,
                   "peak_gib": peak, "staging_share": [min(share), max(share)],
                   "priced_mb": mb, "losses": r0["losses"],
                   "grad_norms": r0["grad_norms"],
                   "launches": launch_sums(k), "levels": levels}}
    print(f"phase 18a/18b ({ARCH_TRAIN} full width, its first {ARCH_DEPTH} "
          f"layers, {' '.join(ARCH_FLAGS)}, {ARCH_SCHEME}, ZeRO-1, remat): "
          f"kernel run == plain run (losses, grad norms, ledger per dim and "
          f"dim/level) on every rank; losses {r0['losses']}, grad norms "
          f"{[round(g, 6) for g in r0['grad_norms']]}; {step * 1e3:.1f} "
          f"ms/step (step {ARCH_STEPS}, slowest rank), "
          f"{out['18a']['tokens_per_s']:.0f} tokens/s, peak {peak} GiB per "
          f"rank, staging+exchange {min(share) * 100:.0f}-"
          f"{max(share) * 100:.0f} %; priced MB per rank per step by "
          f"dim/level {mb}; launches (all ranks) by kernel/level {levels} "
          f"[{card}]")
    for name, arch, kw in ARCH_SERVE:
        cfg = configs.get(arch).truncated(ARCH_DEPTH)
        k, p = res[(name, None)], res[(name, "torch")]
        paged = kw["mode"] == "paged"
        toks = k[0]["tokens"]
        n_req = Z3_REQUESTS if paged else kw["batch"]
        if len(toks) != n_req or any(
                len(t) != kw["gen"] or min(t) < 0 or max(t) >= cfg.vocab_size
                for t in toks) or any(r["tokens"] != toks for r in k):
            fail(f"phase {name}: malformed or disagreeing tokens {toks}")
        same_runs(name, k, p, ("tokens",))
        levels = missing_kernels(name, k, ARCH_KERNELS[name])
        dec = [sum(r["decode_s"]) for r in k]
        step_ms = max(float(np.median(r["decode_s"])) for r in k) * 1e3
        n_gen = sum(len(t) for t in toks) if paged \
            else kw["batch"] * (kw["gen"] - 1)
        sshare = [r["staging_s"] / r["wall_s"] for r in k]
        speak = [round(r["peak_bytes"] / 2**30, 2) for r in k]
        entry = {"launches": launch_sums(k), "levels": levels,
                 "prefill_s": max(r["prefill_s"] for r in k),
                 "decode_ms_per_step": step_ms, "steps": k[0]["steps"],
                 "gen_tokens_per_s": n_gen / max(dec), "peak_gib": speak,
                 "staging_share": [min(sshare), max(sshare)],
                 "priced_mb": {ph: {key: round(v / 1e6, 4) for key, v in
                                    led["priced"].items() if v}
                               for ph, led in k[0]["ledger"].items()}}
        extra = ""
        if paged:
            mbk = paged_kv.blocks_needed(
                max(map(len, z3_prompts(cfg.vocab_size))) + kw["gen"],
                BLOCK_TOKENS)
            n_blocks = max(kw["slots"], kw.get("dp", 1)) * mbk
            hbm = roofline.kv_hbm_bytes(n_blocks, BLOCK_TOKENS, ARCH_DEPTH,
                                        cfg.n_kv_heads, cfg.head_dim_, "bq8",
                                        "bfloat16")
            kv_loc = cfg.n_kv_heads // kw["tp"]
            entry.update(kv_hbm_bytes=hbm, n_blocks=n_blocks,
                         pool_bytes=sum(r["pool_bytes"] for r in k),
                         read_width=kv_loc * cfg.head_dim_,
                         row_width=paged_kv.token_rows(
                             kv_loc, cfg.head_dim_) * 128)
            extra = (f"; pool {n_blocks} blocks: kv_hbm_bytes {hbm:.0f} B, "
                     f"allocated {entry['pool_bytes']} B (all ranks); the "
                     f"KV read {entry['read_width']} values of a "
                     f"{entry['row_width']}-wide token row a rank")
        if cfg.n_experts:
            # every decode step routes its slots' tokens through the MoE
            # layer: two all-to-alls, each one block encode and one block
            # decode of the whole buffer at rate 16, on every rank
            rows = arch_ep_rows(cfg, kw["slots"])
            want = 2 * k[0]["steps"] * len(k) * sum(
                g.n for g in cfg.layer_groups if g.kind == "moe")
            at_ep = {n: sum(c for kk, r_, b, c in
                            (x for rk in k for x in rk["launch_shapes"])
                            if kk == n and r_ == rows and b == 16)
                     for n in ("bq_encode", "bq_decode")}
            if any(v != want for v in at_ep.values()):
                fail(f"phase {name}: the ep all-to-alls' block launches at "
                     f"{rows} rows (rate 16) {at_ep}, want {want} each")
            entry.update(ep_rows=rows, ep_site_launches=at_ep)
            extra += (f"; {cfg.n_experts} experts ({cfg.n_experts // kw['tp']}"
                      f" a rank), the ep all-to-alls' block encode and decode "
                      f"at {rows} rows {at_ep}")
        same = "tokens, every pool plane" if paged else \
            "tokens, every cache leaf after the prefill and at the end"
        print(f"phase {name} ({arch} full width, its first {ARCH_DEPTH} "
              f"layers, {', '.join(f'{a} {b}' for a, b in kw.items())}, "
              f"{ARCH_SCHEME}): kernel run == plain run ({same} by sha256) "
              f"on every rank; first tokens {[t[0] for t in toks]}; prefill "
              f"{entry['prefill_s']:.3f} s, {entry['steps']} decode steps at "
              f"{step_ms:.2f} ms/step (median, slowest rank), "
              f"{entry['gen_tokens_per_s']:.1f} generated tok/s, peak "
              f"{speak} GiB per rank, staging+exchange "
              f"{min(sshare) * 100:.0f}-{max(sshare) * 100:.0f} %; priced MB "
              f"per rank by dim/level {entry['priced_mb']}{extra}; launches "
              f"(all ranks) by kernel/level {levels} [{card}]")
        out[name] = entry
    return out


def rec_reckoned(cfg, b_loc: int, s_loc: int, tp: int, wire) -> dict:
    """The recurrent sites' priced bytes per rank per training step of
    ``cfg`` (a zamba2 or xLSTM stack) at ``b_loc`` rows and ``s_loc``
    tokens a rank over ``tp`` model ranks, reckoned by hand; ``wire(n)``
    is the codec's wire bytes for n values.  Each state prefix sends the
    decay [B, H] and the state [B, H, P, N] at each doubling hop and the
    state once more in the final shift (``pp@ssm_scan``; a hop's payload
    counted for the ranks that send, ``(tp - step) / tp`` of them); a
    mamba layer runs one prefix and sends its conv halo [B, K - 1,
    d_inner] (``pp@conv_halo``, all but the last rank), an mLSTM layer
    runs two prefixes (the numerator's state, P the value width per head,
    N the q/k width; the denominator's, P = 1), and an sLSTM layer two
    all-to-alls of [B, S, D] (``ep@slstm_transpose``, ``(tp - 1) / tp``
    crossing) where ``b_loc`` divides by tp; every one forward and
    backward, and under ``cfg.remat`` forward again
    (:func:`layer_passes`)."""
    out = {"pp@ssm_scan": 0.0, "pp@conv_halo": 0.0,
           "ep@slstm_transpose": 0.0}
    if tp == 1:
        return out
    n = layer_passes(cfg)

    def prefix(H: int, P: int, N: int) -> int:
        n, step = 0, 1
        while step < tp:
            n += b_loc * H * (tp - step) // tp \
                + b_loc * H * P * N * (tp - step) // tp
            step *= 2
        return n + b_loc * H * P * N * (tp - 1) // tp

    pv = int(cfg.proj_factor * cfg.d_model) // cfg.n_heads
    for g in cfg.layer_groups:
        for _ in range(g.n):
            if g.kind == "mamba":
                out["pp@ssm_scan"] += n * wire(prefix(
                    cfg.d_inner // cfg.ssm_head_dim, cfg.ssm_head_dim,
                    cfg.ssm_state))
                out["pp@conv_halo"] += n * wire(
                    b_loc * (cfg.conv_kernel - 1) * cfg.d_inner
                    * (tp - 1) // tp)
            elif g.kind == "mlstm":
                for p in (pv, 1):
                    out["pp@ssm_scan"] += n * wire(prefix(
                        cfg.n_heads, p, cfg.head_dim_))
            elif g.kind == "slstm" and b_loc % tp == 0:
                out["ep@slstm_transpose"] += \
                    2 * n * wire(b_loc * s_loc * cfg.d_model) * (tp - 1) / tp
    return out


def encdec_reckoned(cfg, b_loc: int, s_loc: int, tp: int, wire) -> dict:
    """``tp@attn_cross_kv``'s priced bytes per rank per training step of
    ``cfg`` (an encoder-decoder) at ``b_loc`` rows and ``s_loc`` encoder
    frames a rank over ``tp`` model ranks, reckoned by hand; ``wire(n)``
    is the codec's wire bytes for n values.  In head mode each decoder
    layer's cross-attention all-gathers the encoder's output [B, S_enc /
    tp, D]: ``tp - 1`` ring hops of this rank's slice forward (twice
    under ``cfg.remat``: :func:`layer_passes`), and as many of the same
    slice in its backward reduce-scatter.  Ring mode gathers the projected
    K/V at ``tp@attn_kv`` instead: nothing here."""
    n = 0.0
    if tp > 1 and cfg.attn_mode_for(tp) == "head":
        dec = sum(g.n for g in cfg.layer_groups if g.kind == "dec_attn")
        n = dec * layer_passes(cfg) * (tp - 1) \
            * wire(b_loc * s_loc * cfg.d_model)
    return {"tp@attn_cross_kv": float(n)}


def rec_site_rows(cfg, b_loc: int, s_loc: int, tp: int) -> dict:
    """Wire rows of the recurrent sites' encodes and decodes: the state
    prefix's state payload and the conv halo on the flat forms (one
    ``padded_rows`` of the payload), the sLSTM transpose on the block forms
    (``tp`` tile-padded slices of [B, S, D])."""
    from repro_torch.kernels.ops import padded_rows

    out = {}
    kinds = {g.kind for g in cfg.layer_groups}
    if "mamba" in kinds:
        H = cfg.d_inner // cfg.ssm_head_dim
        out["pp@ssm_scan"] = ("flat", padded_rows(
            b_loc * H * cfg.ssm_head_dim * cfg.ssm_state))
        out["pp@conv_halo"] = ("flat", padded_rows(
            b_loc * (cfg.conv_kernel - 1) * cfg.d_inner))
    if "mlstm" in kinds:
        pv = int(cfg.proj_factor * cfg.d_model) // cfg.n_heads
        out["pp@ssm_scan"] = ("flat", padded_rows(
            b_loc * cfg.n_heads * pv * cfg.head_dim_))
    if "slstm" in kinds:
        out["ep@slstm_transpose"] = ("block", tp * padded_rows(
            b_loc * s_loc * cfg.d_model // tp))
    return out


def check_encdec(card, res: dict) -> dict:
    """Phase 16: whisper-base's training run through the kernels (16a)
    equal to its plain run (16b) in losses, grad norms and the ledger
    (measured per dim, priced per dim and per ``dim/level``), finite
    losses, ``tp@attn_cross_kv``'s priced bytes equal to
    :func:`encdec_reckoned`, the flat encode and decode launched at the
    cross gather's rows (the encoder's slice, and its ``tp`` shards
    gathered), nothing launched in the plain run; 16c's kernel run equal
    to its plain run (tokens, every cache leaf after the prefill and at the
    end by sha256, the cross-attention's ``xk`` / ``xv`` / ``xlen``
    among them); no rank importing jax or repro.  Prints the numbers and
    returns them."""
    from repro_torch.core import codecs
    from repro_torch.kernels.ops import padded_rows
    from repro_torch.launch.train import model_config

    cfg = model_config(ENC_ARCH)
    k, p = res[("16", None)], res[("16", "torch")]
    same_runs("16a/16b", k, p, TRAIN_KEYS)
    for rk in k:
        if not np.isfinite(rk["losses"]).all():
            fail(f"phase 16a rank {rk['rank']}: losses {rk['losses']}")
    b_loc, s_loc = GLOBAL_BATCH // ENC_DP, ENC_SEQ // ENC_TP
    want = encdec_reckoned(cfg, b_loc, s_loc, ENC_TP,
                           codecs.get("bq16").wire_nbytes_for)
    sites = k[0]["priced_per_site"]
    for site, v in want.items():
        if not v or abs(sites.get(site, 0.0) - v) > 1e-9 * v:
            fail(f"phase 16a: {site} priced {sites.get(site, 0.0)} B per "
                 f"rank per step, reckoned {v}")
    shapes = {}
    for r in k:
        for kern, rows, bits, c in r["launch_shapes"]:
            shapes[(kern, rows, bits)] = shapes.get((kern, rows, bits), 0) + c
    rows = padded_rows(b_loc * s_loc * cfg.d_model)
    at_site = {f"bq_encode_flat/{rows}":
               shapes.get(("bq_encode_flat", rows, 16), 0),
               f"bq_decode_flat/{ENC_TP * rows}":
               shapes.get(("bq_decode_flat", ENC_TP * rows, 16), 0)}
    if not all(at_site.values()):
        fail(f"phase 16a: no launch at tp@attn_cross_kv's rows: {at_site}")
    step = max(float(np.median(r["step_s"][1:])) for r in k)
    share = [sum(r["staging_s"][1:]) / sum(r["step_s"][1:]) for r in k]
    peak = [round(r["peak_bytes"] / 2**30, 2) for r in k]
    r0 = k[0]
    priced = {key: round(v / 1e6, 3)
              for key, v in r0["priced_per_dim_level"].items() if v}
    measured = {key: round(v / 1e6, 3)
                for key, v in r0["wire_per_dim_level"].items() if v}
    reck = {key: round(v / 1e6, 3) for key, v in want.items()}
    out = {"step_ms": step * 1e3,
           "tokens_per_s": GLOBAL_BATCH * ENC_SEQ / step, "peak_gib": peak,
           "staging_share": [min(share), max(share)], "priced_mb": priced,
           "measured_mb": measured, "reckoned_mb": reck,
           "site_launches": at_site, "launches": launch_sums(k),
           "levels": level_sums(k), "losses": r0["losses"],
           "grad_norms": r0["grad_norms"]}
    print(f"phase 16a/16b ({ENC_ARCH} full width and depth, "
          f"{' '.join(ENC_FLAGS)}, global batch {GLOBAL_BATCH}, "
          f"{ENC_SCHEME}): kernel run == plain run (losses, grad norms, "
          f"ledger per dim and dim/level) on every rank; losses "
          f"{r0['losses']}, grad norms "
          f"{[round(g, 6) for g in r0['grad_norms']]}; {step * 1e3:.1f} "
          f"ms/step (step {ENC_STEPS}, slowest rank), "
          f"{out['tokens_per_s']:.0f} tokens/s, peak {peak} GiB per rank, "
          f"staging+exchange {min(share) * 100:.0f}-"
          f"{max(share) * 100:.0f} % [{card}]")
    print(f"phase 16a MB per rank per step by dim/level: priced {priced}, "
          f"measured {measured}; tp@attn_cross_kv priced "
          f"{ {key: round(sites.get(key, 0) / 1e6, 3) for key in want} } == "
          f"reckoned {reck}; launches at its rows (all ranks; the "
          f"decoder's own gathers share them, S_enc = S) {at_site}; "
          f"launches (all ranks) {out['launches']} [{card}]")
    # 16c: serving
    k, p = res[("16c", None)], res[("16c", "torch")]
    toks = k[0]["tokens"]
    if len(toks) != ENC_SERVE["batch"] or any(
            len(t) != ENC_SERVE["gen"] or min(t) < 0
            or max(t) >= cfg.vocab_size for t in toks) or any(
            r["tokens"] != toks for r in k):
        fail("phase 16c: malformed or disagreeing tokens")
    same_runs("16c", k, p, ("tokens",))
    for rk in k:
        for when, dig in rk["digests"].items():
            cross = {leaf.rsplit("/", 1)[-1] for leaf in dig}
            if not {"xk", "xv", "xlen"} <= cross:
                fail(f"phase 16c rank {rk['rank']}: no cross-attention "
                     f"cache among the {when} leaves {sorted(dig)}")
    levels = level_sums(k)
    sprice = {ph: {key: round(v / 1e6, 3)
                   for key, v in k[0]["ledger"][ph]["priced"].items() if v}
              for ph in ("prefill", "decode")}
    dec = [sum(r["decode_s"]) for r in k]
    step_ms = max(float(np.median(r["decode_s"])) for r in k) * 1e3
    sshare = [r["staging_s"] / r["wall_s"] for r in k]
    speak = [round(r["peak_bytes"] / 2**30, 2) for r in k]
    n_gen = ENC_SERVE["batch"] * (ENC_SERVE["gen"] - 1)
    out["16c"] = {
        "launches": launch_sums(k), "levels": levels,
        "prefill_s": max(r["prefill_s"] for r in k),
        "decode_ms_per_step": step_ms,
        "gen_tokens_per_s": n_gen / max(dec), "peak_gib": speak,
        "staging_share": [min(sshare), max(sshare)], "priced_mb": sprice}
    print(f"phase 16c ({ENC_ARCH} full width and depth, batched --dp "
          f"{ENC_DP} --tp {ENC_TP}, {ENC_SCHEME}, {ENC_SERVE['batch']} "
          f"prompts of {ENC_SERVE['prompt_len']} + {ENC_SERVE['gen']}, "
          f"frames of {ENC_SERVE['prompt_len']}): kernel run == plain run "
          f"(tokens, every cache leaf after the prefill and at the end by "
          f"sha256, xk / xv / xlen included) on every rank; tokens {toks}; "
          f"prefill {out['16c']['prefill_s']:.2f} s, {step_ms:.2f} "
          f"ms/decode step (median, slowest rank), "
          f"{out['16c']['gen_tokens_per_s']:.1f} generated tok/s, peak "
          f"{speak} GiB per rank, staging+exchange "
          f"{min(sshare) * 100:.0f}-{max(sshare) * 100:.0f} %; priced MB "
          f"per rank by dim/level {sprice}; launches (all ranks) by "
          f"kernel/level {levels} [{card}]")
    return out


def check_recurrent(card, res: dict) -> dict:
    """Phase 15: each recurrent training run through the kernels (15a
    zamba2, 15c xLSTM) equal to its plain run (15b, 15d) in losses, grad
    norms and the ledger (measured per dim, priced per dim and per
    ``dim/level``), finite losses, the recurrent sites' priced bytes equal
    to :func:`rec_reckoned`, their encodes and decodes launched at their
    rows (:func:`rec_site_rows`), nothing launched in the plain runs; 15e's
    kernel run equal to its plain run for each model (tokens, every cache
    leaf after the prefill and at the end by sha256); no rank importing
    jax or repro.  Prints the numbers and returns them."""
    from repro_torch.core import codecs
    from repro_torch.launch.train import model_config

    wire = codecs.get("bq16").wire_nbytes_for
    out = {}
    b_loc, s_loc = GLOBAL_BATCH // REC_DP, SEQ // REC_TP
    for name, pname, arch, depth in REC_RUNS:
        k, p = res[(name, None)], res[(name, "torch")]
        same_runs(f"{name}/{pname}", k, p, TRAIN_KEYS)
        for rk in k:
            if not np.isfinite(rk["losses"]).all():
                fail(f"phase {name} rank {rk['rank']}: losses "
                     f"{rk['losses']}")
        cfg = model_config(arch, depth=depth)
        want = rec_reckoned(cfg, b_loc, s_loc, REC_TP, wire)
        sites = k[0]["priced_per_site"]
        for site, v in want.items():
            if abs(sites.get(site, 0.0) - v) > 1e-9 * max(v, 1.0):
                fail(f"phase {name}: {site} priced {sites.get(site, 0.0)} B "
                     f"per rank per step, reckoned {v}")
        shapes = {}
        for r in k:
            for kern, rows, bits, c in r["launch_shapes"]:
                shapes[(kern, rows, bits)] = \
                    shapes.get((kern, rows, bits), 0) + c
        at_site = {}
        for site, (form, rows) in rec_site_rows(cfg, b_loc, s_loc,
                                                REC_TP).items():
            kerns = ("bq_encode_flat", "bq_decode_flat") if form == "flat" \
                else ("bq_encode", "bq_decode")
            at_site[site] = {f"{kern}/{rows}": shapes.get((kern, rows, 16), 0)
                             for kern in kerns}
            if not all(at_site[site].values()):
                fail(f"phase {name}: no launch at {site}'s rows: "
                     f"{at_site[site]}")
        step = max(float(np.median(r["step_s"][1:])) for r in k)
        share = [sum(r["staging_s"][1:]) / sum(r["step_s"][1:]) for r in k]
        peak = [round(r["peak_bytes"] / 2**30, 2) for r in k]
        r0 = k[0]
        priced = {key: round(v / 1e6, 3)
                  for key, v in r0["priced_per_dim_level"].items() if v}
        measured = {key: round(v / 1e6, 3)
                    for key, v in r0["wire_per_dim_level"].items() if v}
        reck = {key: round(v / 1e6, 3) for key, v in want.items() if v}
        out[arch] = {"depth": depth, "step_ms": step * 1e3,
                     "tokens_per_s": GLOBAL_BATCH * SEQ / step,
                     "peak_gib": peak,
                     "staging_share": [min(share), max(share)],
                     "priced_mb": priced, "measured_mb": measured,
                     "reckoned_mb": reck, "site_launches": at_site,
                     "launches": launch_sums(k), "levels": level_sums(k),
                     "losses": r0["losses"]}
        print(f"phase {name}/{pname} ({arch} full width, the first {depth} "
              f"layers, {' '.join(REC_FLAGS)}, {REC_SCHEME}): kernel run == "
              f"plain run (losses, grad norms, ledger per dim and "
              f"dim/level) on every rank; losses {r0['losses']}, grad norms "
              f"{[round(g, 6) for g in r0['grad_norms']]}; {step * 1e3:.1f} "
              f"ms/step (step {REC_STEPS}, slowest rank), "
              f"{out[arch]['tokens_per_s']:.0f} tokens/s, peak {peak} GiB "
              f"per rank, staging+exchange {min(share) * 100:.0f}-"
              f"{max(share) * 100:.0f} % [{card}]")
        print(f"phase {name} MB per rank per step by dim/level: priced "
              f"{priced}, measured {measured}; recurrent sites priced "
              f"{ {key: round(sites.get(key, 0) / 1e6, 3) for key in want} }"
              f" == reckoned {reck}; their launches (all ranks) {at_site}; "
              f"launches (all ranks) {out[arch]['launches']} [{card}]")
        # 15e: serving
        k, p = res[(f"15e {arch}", None)], res[(f"15e {arch}", "torch")]
        toks = k[0]["tokens"]
        if len(toks) != REC_SERVE["batch"] or any(
                len(t) != SERVE_GEN or min(t) < 0 or max(t) >=
                cfg.vocab_size for t in toks) or any(
                r["tokens"] != toks for r in k):
            fail(f"phase 15e {arch}: malformed or disagreeing tokens")
        same_runs(f"15e {arch}", k, p, ("tokens",))
        levels = level_sums(k)
        sprice = {ph: {key: round(v / 1e6, 3)
                       for key, v in k[0]["ledger"][ph]["priced"].items()
                       if v} for ph in ("prefill", "decode")}
        dec = [sum(r["decode_s"]) for r in k]
        step_ms = max(float(np.median(r["decode_s"])) for r in k) * 1e3
        sshare = [r["staging_s"] / r["wall_s"] for r in k]
        speak = [round(r["peak_bytes"] / 2**30, 2) for r in k]
        out[arch]["15e"] = {
            "launches": launch_sums(k), "levels": levels,
            "prefill_s": max(r["prefill_s"] for r in k),
            "decode_ms_per_step": step_ms,
            "gen_tokens_per_s": REC_SERVE["batch"] * (SERVE_GEN - 1)
            / max(dec), "peak_gib": speak,
            "staging_share": [min(sshare), max(sshare)],
            "priced_mb": sprice}
        print(f"phase 15e ({arch} full width, the first {depth} layers, "
              f"batched --dp {REC_DP} --tp {REC_TP}, {REC_SCHEME}, "
              f"{REC_SERVE['batch']} prompts of {SERVE_PROMPT} + "
              f"{SERVE_GEN}): kernel run == plain run (tokens, every cache "
              f"leaf after the prefill and at the end by sha256) on every "
              f"rank; tokens {toks}; prefill "
              f"{out[arch]['15e']['prefill_s']:.2f} s, {step_ms:.2f} "
              f"ms/decode step (median, slowest rank), "
              f"{out[arch]['15e']['gen_tokens_per_s']:.1f} generated tok/s, "
              f"peak {speak} GiB per rank, staging+exchange "
              f"{min(sshare) * 100:.0f}-{max(sshare) * 100:.0f} %; priced MB "
              f"per rank by dim/level {sprice}; launches (all ranks) by "
              f"kernel/level {levels} [{card}]")
    return out


def check_cp(card, res: dict) -> dict:
    """Phase 11: the cp runs (``res[(name, backend)]``): 11a's kernel run
    equal to its plain run (losses, grad norms, ledger per dim and
    dim/level, link bytes), finite losses, priced ``cp`` bytes and no
    ``pp`` bytes, 11b's ``cp/outer`` bytes below what ``baseline`` prices
    for the same events, a launch at each link level of every kernel
    CP_LEVELS names, none in the plain run, no rank importing jax or
    repro; prints each run's numbers and returns them."""
    from repro_torch.analysis import roofline

    out = {}
    for name, scheme, steps, flags, plain, depth in CP_RUNS:
        k = res[(name, None)]
        for rk in k:
            if not np.isfinite(rk["losses"]).all():
                fail(f"phase {name} rank {rk['rank']}: losses "
                     f"{rk['losses']}")
            if rk["foreign_modules"]:
                fail(f"phase {name} rank {rk['rank']} imported "
                     f"{rk['foreign_modules']}")
        if plain:
            p = res[(name, "torch")]
            for rk, rp in zip(k, p):
                for key in ("losses", "grad_norms", "wire_per_dim",
                            "priced_per_dim_level", "link_bytes"):
                    if rk[key] != rp[key]:
                        fail(f"phase {name} rank {rk['rank']}: {key} differ "
                             f"between the kernel run ({rk[key]}) and the "
                             f"plain run ({rp[key]})")
            if any(v for r in p for v in r["launches"].values()):
                fail(f"phase {name}: the plain run launched kernels: "
                     f"{[r['launches'] for r in p]}")
        r0 = k[0]
        priced = r0["priced_per_dim_level"]
        cp_b = sum(v for key, v in priced.items() if key.startswith("cp/"))
        pp_b = sum(v for key, v in priced.items() if key.startswith("pp/"))
        if not cp_b > 0 or pp_b:
            fail(f"phase {name}: priced cp bytes {cp_b}, pp bytes {pp_b}: "
                 f"{priced}")
        base = roofline.ledger_summary(
            roofline.recost_events(r0["events0"], "baseline"),
            train=True)["per_dim_level"]
        if name == "11b" and not priced["cp/outer"] < base["cp/outer"]:
            fail(f"phase 11b: cp/outer {priced['cp/outer']} bytes, not "
                 f"below baseline's {base['cp/outer']}")
        levels = level_sums(k)
        missing = sorted(f"{kern}/{lvl}"
                         for lvl, kerns in CP_LEVELS[name].items()
                         for kern in kerns if not levels.get(f"{kern}/{lvl}"))
        if missing:
            fail(f"phase {name}: no launch of {missing}; launches by level "
                 f"{levels}")
        step = max(float(np.median(r["step_s"][1:])) for r in k)
        share = [sum(r["staging_s"][1:]) / sum(r["step_s"][1:]) for r in k]
        fold = max(float(np.median([s.get("cp_bwd@grad_seq_rep", 0.0)
                                    for s in r["span_s"][1:]])) for r in k)
        ring_s = roofline.cp_ring_seconds(r0["events0"], True,
                                          FAST_LINK_BYTES_PER_S,
                                          SLOW_LINK_BYTES_PER_S)
        peak = [round(r["peak_bytes"] / 2**30, 2) for r in k]
        mb = {key: round(v / 1e6, 2) for key, v in priced.items() if v}
        meas = {key: round(v / 1e6, 2)
                for key, v in r0["wire_per_dim_level"].items() if v}
        same = ("kernel run == plain run (losses, grad norms, ledger per dim "
                "and dim/level, link bytes) on every rank; ") if plain else ""
        print(f"phase {name} ({scheme}, {' '.join(flags)}, first {depth} "
              f"layers): {same}losses {r0['losses']}; {step * 1e3:.1f} "
              f"ms/step, {GLOBAL_BATCH * SEQ / step:.0f} tokens/s, peak "
              f"{peak} GiB per rank, staging+exchange "
              f"{min(share) * 100:.0f}-{max(share) * 100:.0f} %, "
              f"{r0['staging_bytes'][-1] / 1e9:.2f} GB staged per step "
              f"(rank 0); cp fold {fold * 1e3:.1f} ms per step (slowest "
              f"rank); wire per rank per step, MB priced {mb}, measured "
              f"(a two-level collective's under its dim's flat key) {meas}; "
              f"cp/outer priced under baseline "
              f"{base.get('cp/outer', 0) / 1e6:.2f} MB; cp_ring_seconds "
              f"{ring_s * 1e3:.3f} ms at assumed link rates "
              f"{FAST_LINK_BYTES_PER_S / 1e9:.0f} / "
              f"{SLOW_LINK_BYTES_PER_S / 1e9:.0f} GB/s (fast / slow); "
              f"launches (all ranks) by kernel/level {levels} [{card}]")
        out[name] = {"launches": launch_sums(k), "levels": levels,
                     "step_ms": step * 1e3, "tokens_per_s":
                     GLOBAL_BATCH * SEQ / step, "peak_gib": peak,
                     "staging_share": [min(share), max(share)],
                     "staged_gb": r0["staging_bytes"][-1] / 1e9,
                     "cp_fold_ms": fold * 1e3,
                     "per_dim_level": priced,
                     "measured_per_dim_level": r0["wire_per_dim_level"],
                     "baseline_per_dim_level": base,
                     "cp_ring_s_assumed_rates": ring_s,
                     "losses": r0["losses"], "layers": depth}
    return out


def _rounds(tune: dict) -> list:
    """A decision history as (site, step, action, from, to)."""
    return [(h["site"], h["step"], h["action"], h["from_codec"],
             h["to_codec"]) for h in tune["history"]]


def check_tune(card, k, p) -> dict:
    """Phase 10: the tuned ``--dp 4 --nodes 2`` runs through the kernels
    (``k``) and the plain versions (``p``): equal decisions on every rank,
    losses and grad norms bit-equal before the first live plr rung and
    within PLR_RTOL after, equal measured wire per ``dim/level`` at every
    step, a codec changed, the measured ``dp/outer`` bytes fallen, the
    start plan against the final one saving slow-link bytes
    (``roofline.savings_report``), each rung taken launching its kernels,
    none in the plain run, no rank importing jax or repro, and the largest
    rank within TUNE_PEAK_GIB; prints each round's decisions and the
    numbers, and returns them."""
    from repro_torch.analysis import roofline
    from repro_torch.core import policy
    from repro_torch.tune import ladder

    for label, res in (("kernel", k), ("plain", p)):
        for r in res:
            if r["foreign_modules"]:
                fail(f"phase 10 {label} rank {r['rank']} imported "
                     f"{r['foreign_modules']}")
            if r["tune"]["history"] != res[0]["tune"]["history"] or \
                    r["tune"]["select_per_step"] != \
                    res[0]["tune"]["select_per_step"]:
                fail(f"phase 10 {label} run: rank {r['rank']} decided "
                     f"otherwise than rank 0: {_rounds(r['tune'])} vs "
                     f"{_rounds(res[0]['tune'])}")
    t0 = k[0]["tune"]
    sel = t0["select_per_step"]
    first_plr = next((i for i, s in enumerate(sel)
                      if any(v >= 3 for v in s.values())), len(sel))
    for rk, rp in zip(k, p):
        tk, tp_ = rk["tune"], rp["tune"]
        if _rounds(tk) != _rounds(tp_) or \
                tk["select_per_step"] != tp_["select_per_step"]:
            fail(f"phase 10 rank {rk['rank']}: the kernel run decided "
                 f"{_rounds(tk)}, the plain run {_rounds(tp_)}")
        for key in ("losses", "grad_norms"):
            a, b = rk[key], rp[key]
            if a[:first_plr] != b[:first_plr] or not np.allclose(
                    a[first_plr:], b[first_plr:], rtol=PLR_RTOL, atol=0):
                fail(f"phase 10 rank {rk['rank']}: {key} {a} (kernels) vs "
                     f"{b} (plain); bit-equal before step {first_plr}, "
                     f"within {PLR_RTOL} after")
        if tk["wire_per_step"] != tp_["wire_per_step"]:
            fail(f"phase 10 rank {rk['rank']}: measured wire per dim/level "
                 f"{tk['wire_per_step']} (kernels) vs {tp_['wire_per_step']}"
                 f" (plain)")
    changed = [h for h in t0["history"] if h["to_codec"] != h["from_codec"]]
    if not changed:
        fail(f"phase 10: no codec changed: {_rounds(t0)}")
    wire = t0["wire_per_step"]
    if not wire[-1]["dp/outer"] < wire[0]["dp/outer"]:
        fail(f"phase 10: measured dp/outer bytes did not fall: first step "
             f"{wire[0]['dp/outer']}, last {wire[-1]['dp/outer']}")
    start = policy.as_policy(TUNE_SCHEME)
    final = start.with_rules(*[policy.Rule(**r) for r in t0["rules"]])
    sav = roofline.savings_report(
        t0["events0"], start, final,
        fast_bytes_per_s=FAST_LINK_BYTES_PER_S,
        slow_bytes_per_s=SLOW_LINK_BYTES_PER_S)
    if not sav["after"]["slow_bytes"] < sav["before"]["slow_bytes"]:
        fail(f"phase 10: the final plan saves no slow-link bytes: {sav}")
    # each rung taken launched its kernels (all ranks, whole run)
    taken = {ladder.RUNGS[v] for s in sel for v in s.values()}
    by_rate = {}
    for r in k:
        for kern, rows, bits, n in r["launch_shapes"]:
            by_rate[(kern, bits)] = by_rate.get((kern, bits), 0) + n
    kl = launch_sums(k)
    need = []
    if "ef:bq4" in taken:
        need += [(f"{kern} rate 4", by_rate.get((kern, 4), 0))
                 for kern in ("bq_encode", "bq_decode")]
        need.append(("bq_decode_add_encode or bq_decode_add rate 4",
                     by_rate.get(("bq_decode_add_encode", 4), 0)
                     + by_rate.get(("bq_decode_add", 4), 0)))
    if taken & {"ef:bq4", "plr2", "plr4", "plr8"}:
        need += [(n, kl[n]) for n in ("matmul_tall", "matmul_at_b")]
    if taken & {"plr2", "plr4", "plr8"}:
        need.append(("matmul_small_k", kl["matmul_small_k"]))
    missing = [n for n, v in need if not v]
    if missing:
        fail(f"phase 10: rungs {sorted(taken)} taken, but no launch of "
             f"{missing}; by (kernel, rate) {by_rate}, lowrank {kl}")
    if any(v for r in p for v in r["launches"].values()):
        fail(f"phase 10: the plain run launched kernels: "
             f"{[r['launches'] for r in p]}")
    peak = [r["peak_bytes"] / 2**30 for r in k + p]
    if max(peak) > TUNE_PEAK_GIB:
        fail(f"phase 10: a rank peaked at {max(peak):.2f} GiB, above "
             f"{TUNE_PEAK_GIB} GiB: {[round(g, 2) for g in peak]}")
    # the numbers: per round, per step, per kernel and rate and level
    for h in t0["history"]:
        print(f"  phase 10 round at step {h['step']}: {h['site']} "
              f"{h['action']} {h['from_codec']} -> {h['to_codec']} "
              f"(err_ratio {h['err_ratio']:.6f}; {h['reason']}) [{card}]")
    step_ms = [max(r["step_s"][i] for r in k) * 1e3 for i in range(len(sel))]
    for i, (s_, w) in enumerate(zip(sel, wire)):
        print(f"  phase 10 step {i}: rungs "
              f"{ {key: ladder.RUNGS[v] for key, v in s_.items()} }, "
              f"{step_ms[i]:.1f} ms (slowest rank), measured wire per rank "
              f"dp/inner {w.get('dp/inner', 0)} B, dp/outer "
              f"{w.get('dp/outer', 0)} B [{card}]")
    levels = level_sums(k)
    tail = [max(r["step_s"][i] for r in k) for i in range(1, len(sel))]
    share = [sum(r["staging_s"][1:]) / sum(r["step_s"][1:]) for r in k]
    print(f"phase 10 ({TUNE_SCHEME}, {' '.join(TUNE_FLAGS)}): kernel run == "
          f"plain run (decisions, selects, measured wire per dim/level; "
          f"losses and grad norms bit-equal before step {first_plr}, within "
          f"{PLR_RTOL} after) on every rank; codecs "
          f"{t0['codecs']}; losses {k[0]['losses']}; median "
          f"{float(np.median(tail)) * 1e3:.1f} ms/step, "
          f"{GLOBAL_BATCH * SEQ / float(np.median(tail)):.0f} tokens/s, "
          f"peak {[round(g, 2) for g in peak[:len(k)]]} GiB per rank, "
          f"staging+exchange {min(share) * 100:.0f}-{max(share) * 100:.0f} "
          f"%; measured dp/outer {wire[0]['dp/outer']} -> "
          f"{wire[-1]['dp/outer']} B per rank per step; slow-link bytes "
          f"start plan {sav['before']['slow_bytes']:.0f} -> final "
          f"{sav['after']['slow_bytes']:.0f} per rank per step "
          f"({sav['slow_saved_frac'] * 100:.1f} % saved); launches (all "
          f"ranks) by kernel/rate "
          f"{ {f'{a}/{b}': v for (a, b), v in sorted(by_rate.items())} }, "
          f"by kernel/level {levels}, lowrank "
          f"{ {n: v for n, v in kl.items() if n.startswith('matmul')} } "
          f"[{card}]")
    return {"history": t0["history"], "codecs": t0["codecs"],
            "select_per_step": sel, "wire_per_step": wire,
            "step_ms": step_ms, "median_step_ms":
            float(np.median(tail)) * 1e3, "peak_gib": peak[:len(k)],
            "staging_share": [min(share), max(share)],
            "first_plr_step": first_plr, "losses": k[0]["losses"],
            "savings": sav, "launches": kl,
            "by_rate": {f"{a}/{b}": v for (a, b), v in by_rate.items()},
            "levels": levels}


def pipeline_runs() -> list:
    """Phase 7's runs (:func:`run`): each of PP_RUNS through the kernels
    and the plain versions."""
    runs = []
    for name, layers, steps, extra in PP_RUNS:
        flags = ["--layers", str(layers), "--pp", str(PP), "--microbatches",
                 str(PP_MICRO), *extra]
        runs += [run(f"{name} kernels", "zhybrid_16_8", None, steps, flags,
                     dp=1),
                 run(f"{name} plain", "zhybrid_16_8", "torch", steps, flags,
                     dp=1)]
    return runs


def drive_pipeline(torch, card, res=None) -> dict:
    """Phase 7: the pipeline at full width, dp 1 x pp 2 x tp 2 (four ranks
    on the card), 1F1B and interleaved (vpp 2, remat per_stage:0) at
    PP_RUNS' ``--layers``, through the kernels and the plain versions
    (``res``: their per-rank results, trained here when ``None``);
    returns each run's launches (all ranks), by shape too."""
    out = {}
    res = res or train_runs(card, pipeline_runs())
    for i, (name, layers, steps, extra) in enumerate(PP_RUNS):
        k, p = res[2 * i], res[2 * i + 1]
        for rk, rp in zip(k, p):
            for key in ("losses", "grad_norms", "wire_per_dim",
                        "priced_per_dim"):
                if rk[key] != rp[key]:
                    fail(f"phase {name} rank {rk['rank']}: {key} differ "
                         f"between the kernel run ({rk[key]}) and the plain "
                         f"run ({rp[key]})")
            if not np.isfinite(rk["losses"]).all():
                fail(f"phase {name} rank {rk['rank']}: losses "
                     f"{rk['losses']}")
        if any(v for r in p for v in r["launches"].values()):
            fail(f"phase {name}: the plain run launched kernels: "
                 f"{[r['launches'] for r in p]}")
        # every tick hands off once forward and, but for the first tick's
        # (constant zeros), once backward; each decodes on every rank at
        # the handoff's rows (a TP all-gather's gathered decode has twice
        # as many)
        ticks, shapes = k[0]["ticks"], shape_sums(k)
        want = len(k) * steps * (2 * ticks - 1)
        dec = shapes.get(("bq_decode_flat", HANDOFF_ROWS, 16), 0)
        enc = shapes.get(("bq_encode_flat", HANDOFF_ROWS, 16), 0)
        if dec != want or enc < want:
            fail(f"phase {name}: flat decode {dec} and encode {enc} "
                 f"launches at the handoff's {HANDOFF_ROWS} rows, want "
                 f"{want} and at least {want}")
        # the pp sites' priced bytes at bq16's ratio to their payload: the
        # bf16 handoff and the f32 stage fold
        ratios = {}
        for tag, bits in (("pp@stage_handoff", 16), ("pp_bwd@grad_stage_rep",
                                                      32)):
            r = k[0]["priced_per_tag"][tag] / k[0]["payload_per_tag"][tag]
            ratios[tag] = r
            want_r = (16 + 32 / 128) / bits
            if not want_r <= r <= want_r * 1.01:
                fail(f"phase {name}: {tag} priced {r:.5f} of its payload, "
                     f"bq16's ratio {want_r:.5f}")
        step = max(float(np.median(r["step_s"][1:])) for r in k)
        fold = max(float(np.median([sp.get("pp_bwd@grad_stage_rep", 0.0)
                                    for sp in r["span_s"][1:]])) for r in k)
        print(f"phase {name}: kernel run == plain run (losses, grad norms, "
              f"ledger per dim) on every rank; {ticks} ticks, bubble "
              f"fraction {k[0]['bubble']:.4f}; flat decode {dec} and encode "
              f"{enc} launches at the handoff's {HANDOFF_ROWS} rows; the "
              f"stage fold (bq16 psum of {STAGE_FOLD_ELEMS} floats) "
              f"{fold * 1e3:.1f} ms of the slowest rank's {step * 1e3:.1f} ms "
              f"step ({fold / step * 100:.1f} %); priced wire per rank per "
              f"step {k[0]['priced_per_dim']} (pp: handoff "
              f"{ratios['pp@stage_handoff']:.5f}, stage fold "
              f"{ratios["pp_bwd@grad_stage_rep"]:.5f} of the payload); measured "
              f"{k[0]['wire_per_dim']}; launches (all ranks) "
              f"{launch_sums(k)} [{card}]")
        out[name] = {"launches": launch_sums(k), "shapes": shapes,
                     "step_ms": step * 1e3, "fold_ms": fold * 1e3}
    return out


def pod_reckoned(n_flat: int, dp: int, pod: int, wire8, wire16) -> dict:
    """The ZeRO-1 sync's priced bytes per rank per step of an ``n_flat``
    value gradient (every leaf whole: tp 1) at ``dp`` data x ``pod`` pod
    ranks, reckoned by hand; ``wire8(n)`` and ``wire16(n)`` are the bq8 and
    bq16 wire bytes of n values.  The reduce-scatter over data sends ``dp
    - 1`` ring hops of its chunk (``padded_rows(ceil(n / dp))`` rows) under
    bq8 (``dp@zero1_grad``); that chunk's all-reduce over the pods ``pod -
    1`` reduce-scatter hops and as many all-gather hops of its own padded
    ``1 / pod`` part under bq8 (``dp@zero1_grad_pod``), priced twice: the
    ledger gives every psum event its backward twin (an all-reduce), as
    the reference's does, though the optimizer's runs outside autodiff
    (the measured wire is the half); the param gather ``dp - 1`` hops of
    the chunk under bq16 (``zero@zero1_param``)."""
    from repro_torch.kernels.ops import padded_rows

    chunk = padded_rows(-(-n_flat // dp)) * 128
    part = padded_rows(-(-chunk // pod)) * 128
    return {"dp@zero1_grad": float((dp - 1) * wire8(chunk)),
            "dp@zero1_grad_pod": float(2 * 2 * (pod - 1) * wire8(part)),
            "zero@zero1_param": float((dp - 1) * wire16(chunk))}


def long_reckoned(cfg, dp: int, tp: int, wire) -> dict:
    """``tp@attn_combine``'s priced bytes per rank per decode step of the
    long-context decode (a batch of one, the cache's sequence over (data,
    model)), reckoned by hand; ``wire(n)`` is the bq16 wire bytes of n
    values.  Every attention layer merges its shards' partial softmax by
    two sums over each of data and model: the output [1, 1, H, hd] and the
    denominator [1, 1, H], each a ring all-reduce of ``n`` ranks (``n -
    1`` reduce-scatter and ``n - 1`` all-gather hops of its padded ``1 /
    n`` part)."""
    from repro_torch.kernels.ops import padded_rows

    layers = sum(g.n for g in cfg.layer_groups
                 if g.kind in ("attn", "moe", "dec_attn", "shared_attn"))
    per = 0
    for n in (dp, tp):
        for elems in (cfg.n_heads * cfg.head_dim_, cfg.n_heads):
            if n > 1:
                per += 2 * (n - 1) * wire(padded_rows(-(-elems // n)) * 128)
    return {"tp@attn_combine": float(layers * per)}


def step_share(cfg, mi, step_s: float, ranks_per_card: int) -> dict:
    """The cost model's per-device FLOPs and bytes of a training step of
    ``cfg`` at GLOBAL_BATCH x SEQ on ``mi``, its model FLOPs (6 N D), and
    the share of the H100's dense bf16 peak that the model FLOPs per
    device reach at the measured ``step_s``; the ranks share one card, so
    also the card's share (all ``ranks_per_card`` ranks' model FLOPs)."""
    from repro_torch.analysis import costmodel, roofline
    from repro_torch.models.params import count_params
    from repro_torch.models.transformer import model_plan

    peak = roofline.H100_PEAK_FLOPS
    n = count_params(model_plan(cfg, mi))
    n_act = roofline.active_params(cfg, n)
    cost = costmodel.train_cost(cfg, mi, GLOBAL_BATCH, SEQ, n_act, n)
    mf = roofline.model_flops(cfg, n_act, GLOBAL_BATCH * SEQ)
    chips = mi.world_size
    per_dev = mf / chips / step_s
    return {"params": n, "cost_flops_per_device": cost.flops,
            "cost_hbm_bytes_per_device": cost.hbm_bytes,
            "model_flops": mf, "model_flops_per_device": mf / chips,
            "step_s": step_s, "share_per_device": per_dev / peak,
            "share_of_card": per_dev * ranks_per_card / peak}


def start_dryrun():
    """Phase 17e: the dry-run of DRY_ARCH's four cells on both production
    meshes in a process of its own (host only: meta tensors, no card),
    started now and read by :func:`finish_dryrun`."""
    SCRATCH.mkdir(exist_ok=True)
    out = SCRATCH / "dryrun.json"
    out.unlink(missing_ok=True)
    return out, subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                                  "--dryrun", str(out)])


def finish_dryrun(dry) -> dict:
    out, proc = dry
    if proc.wait(timeout=600) != 0:
        fail(f"phase 17e: the dry-run failed ({proc.returncode})")
    return json.loads(out.read_text())


def dryrun_main(path: str) -> None:
    """``--dryrun FILE``: trace DRY_ARCH's four cells on pod16x16 and
    pod2x16x16 on meta tensors (no card), write the records, the report's
    roofline and dry-run tables and the wall seconds to FILE."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.analysis import report
    from repro_torch.launch import dryrun, specs

    t0 = time.perf_counter()
    out = {"records": {}, "tables": {}}
    for multi_pod in (False, True):
        mesh = "pod2x16x16" if multi_pod else "pod16x16"
        recs = {}
        for shape in specs.SHAPES:
            r = dryrun.run_cell(DRY_ARCH, shape, multi_pod, "zhybrid_16_8")
            recs[(DRY_ARCH, shape)] = r
            out["records"][f"{mesh}/{shape}"] = r
        out["tables"][mesh] = {"roofline": report.roofline_table(recs),
                               "dryrun": report.dryrun_table(recs)}
    out["seconds"] = time.perf_counter() - t0
    Path(path).write_text(json.dumps(out))


def check_pod(card, res: dict, dry: dict) -> dict:
    """Phase 17: the pod run through the kernels (17a) equal to its plain
    run (17b) in losses, grad norms and the ledger per ``dim/level``
    (priced and measured), finite and falling losses within 1 % of the
    ``--dp 4`` run's, the three ZeRO-1 sites' priced bytes equal to
    :func:`pod_reckoned`, the block encode (#1), decode (#2), the fused hop
    with the sum (#3, the pod all-reduce's tail) and the decode-add (#4)
    launched in 17a and nothing in 17b; the long-context decode through
    the kernels (17c) equal to its plain run (17d) in tokens and every
    cache leaf after the fill and at the end (sha256), ``tp@attn_combine``
    priced as :func:`long_reckoned`; every dry-run cell (17e) traced; no
    rank importing jax or repro.  Prints the numbers (and the whole-step
    shares of the H100's peak) and returns them."""
    from repro_torch.core import codecs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import model_config
    from repro_torch.models.params import count_params
    from repro_torch.models.transformer import model_plan
    from repro_torch.serve import kv_cache

    cfg = model_config(POD_ARCH, depth=POD_DEPTH)
    k, p, b = res[("17", None)], res[("17", "torch")], res[("17 dp4", None)]
    for rk, rp, rb in zip(k, p, b):
        if rk["foreign_modules"] or rp["foreign_modules"]:
            fail(f"phase 17 rank {rk['rank']} imported "
                 f"{rk['foreign_modules'] or rp['foreign_modules']}")
        for key in ("losses", "grad_norms", "wire_per_dim_level",
                    "priced_per_dim_level"):
            if rk[key] != rp[key]:
                fail(f"phase 17a/17b rank {rk['rank']}: {key} differ between "
                     f"the kernel run ({rk[key]}) and the plain run "
                     f"({rp[key]})")
        ls = rk["losses"]
        if not np.isfinite(ls).all() or not ls[-1] < ls[0]:
            fail(f"phase 17a rank {rk['rank']}: losses {ls} not finite and "
                 f"falling")
        for s_, (lk, lb) in enumerate(zip(ls, rb["losses"])):
            if abs(lk - lb) > 0.01 * abs(lb):
                fail(f"phase 17a rank {rk['rank']} step {s_}: loss {lk} vs "
                     f"--dp 4 {lb}")
    if any(v for r in p for v in r["launches"].values()):
        fail(f"phase 17b: the plain run launched kernels: "
             f"{[r['launches'] for r in p]}")
    launches = launch_sums(k)
    need = ("bq_encode", "bq_decode", "bq_decode_add_encode", "bq_decode_add")
    if not all(launches[n] > 0 for n in need):
        fail(f"phase 17a: not every kernel of the pod sync launched: "
             f"{launches}")
    n_flat = count_params(model_plan(cfg, make_mesh(1, 1)))
    want = pod_reckoned(n_flat, POD_DP, POD,
                        codecs.get("bq8").wire_nbytes_for,
                        codecs.get("bq16").wire_nbytes_for)
    sites = k[0]["priced_per_site"]
    for site, v in want.items():
        if abs(sites.get(site, 0.0) - v) > 1e-9 * v:
            fail(f"phase 17a: {site} priced {sites.get(site, 0.0)} B per "
                 f"rank per step, reckoned {v}")
    step = max(float(np.median(r["step_s"][1:])) for r in k)
    base = max(float(np.median(r["step_s"][1:])) for r in b)
    share = [sum(r["staging_s"][1:]) / sum(r["step_s"][1:]) for r in k]
    peak = [round(r["peak_bytes"] / 2**30, 2) for r in k]
    r0 = k[0]
    out = {"step_ms": step * 1e3, "dp4_step_ms": base * 1e3,
           "tokens_per_s": GLOBAL_BATCH * SEQ / step, "peak_gib": peak,
           "staging_share": [min(share), max(share)],
           "priced_mb": {s_: sites.get(s_, 0.0) / 1e6 for s_ in want},
           "reckoned_mb": {s_: v / 1e6 for s_, v in want.items()},
           "priced_per_dim_level": r0["priced_per_dim_level"],
           "launches": launches, "levels": level_sums(k),
           "losses": r0["losses"], "dp4_losses": b[0]["losses"],
           "grad_norms": r0["grad_norms"], "n_flat": n_flat,
           "share": step_share(cfg, make_mesh(POD_DP, 1, pod=POD, rank=0),
                               step, POD * POD_DP)}
    print(f"phase 17a/17b ({POD_ARCH} full width, its first {POD_DEPTH} "
          f"layers, {' '.join(POD_FLAGS)}, global batch {GLOBAL_BATCH}, "
          f"seq {SEQ}, {POD_SCHEME}): kernel run == plain run (losses, grad "
          f"norms, ledger per dim/level) on every rank; losses "
          f"{r0['losses']} (--dp 4: {b[0]['losses']}), grad norms "
          f"{[round(g, 6) for g in r0['grad_norms']]}; {step * 1e3:.1f} "
          f"ms/step (slowest rank; --dp 4 {base * 1e3:.1f}), "
          f"{out['tokens_per_s']:.0f} tokens/s, peak {peak} GiB per rank, "
          f"staging+exchange {min(share) * 100:.0f}-{max(share) * 100:.0f} "
          f"% [{card}]")
    print(f"phase 17a MB per rank per step: priced "
          f"{ {s_: round(v, 3) for s_, v in out['priced_mb'].items()} } == "
          f"reckoned { {s_: round(v, 3) for s_, v in out['reckoned_mb'].items()} }"
          f" ({n_flat} values); by dim/level "
          f"{ {d: round(v / 1e6, 3) for d, v in r0['priced_per_dim_level'].items() if v} }"
          f"; launches (all ranks) {launches} [{card}]")
    # 17c/17d: the long-context decode
    k, p = res[("17c", None)], res[("17c", "torch")]
    lcfg = model_config(POD_ARCH, depth=LONG_DEPTH)
    toks = k[0]["tokens"]
    if len(toks) != 1 or len(toks[0]) != LONG_GEN + 1 or any(
            not 0 <= t < lcfg.vocab_size for t in toks[0]) or any(
            r["tokens"] != toks for r in k):
        fail(f"phase 17c: malformed or disagreeing tokens {toks}")
    for rk, rp in zip(k, p):
        if rk["foreign_modules"]:
            fail(f"phase 17c rank {rk['rank']} imported "
                 f"{rk['foreign_modules']}")
        if rk["tokens"] != rp["tokens"] or rk["digests"] != rp["digests"]:
            fail(f"phase 17c/17d rank {rk['rank']}: tokens or cache "
                 f"digests differ between the kernel run and the plain run")
        if rk["s_max"] != LONG_S:
            fail(f"phase 17c: cache of {rk['s_max']} positions")
    if any(v for r in p for v in r["launches"].values()):
        fail(f"phase 17d: the plain run launched kernels")
    lwant = long_reckoned(lcfg, LONG_DP, LONG_TP,
                          codecs.get("bq16").wire_nbytes_for)
    from repro_torch.analysis import roofline
    got = k[0]["ledger"]["decode"]
    csite = roofline.ledger_summary(got["events"], train=False)["per_site"]
    for site, v in lwant.items():
        if abs(csite.get(site, 0.0) - v) > 1e-9 * v:
            fail(f"phase 17c: {site} priced {csite.get(site, 0.0)} B per "
                 f"rank per decode step, reckoned {v}")
    dec_ms = max(float(np.median(r["decode_s"])) for r in k) * 1e3
    structs, _ = kv_cache.cache_structs(
        lcfg, make_mesh(LONG_DP, LONG_TP, rank=0), 1, LONG_S,
        seq_axes=LONG_SERVE["seq_axes"])
    cache_b = sum(int(np.prod(st.shape)) * st.dtype.itemsize
                  for c in structs if c for st in c.values())
    out["17c"] = {"tokens": toks, "decode_ms_per_step": dec_ms,
                  "fill_s": k[0]["prefill_s"], "cache_bytes_per_rank":
                  cache_b, "peak_gib": [round(r["peak_bytes"] / 2**30, 2)
                                        for r in k],
                  "combine_priced": csite.get("tp@attn_combine", 0.0),
                  "combine_reckoned": lwant["tp@attn_combine"],
                  "priced_mb": {d: v / 1e6 for d, v in got["priced"].items()},
                  "launches": launch_sums(k), "levels": level_sums(k),
                  "staging_share": [r["staging_s"] / max(r["wall_s"], 1e-9)
                                    for r in k]}
    print(f"phase 17c/17d ({POD_ARCH} full width, its first {LONG_DEPTH} "
          f"layers, dp {LONG_DP} x "
          f"tp {LONG_TP}, seq_axes (data, model), 1 x {LONG_S} positions, "
          f"{LONG_S // (LONG_DP * LONG_TP)} a rank, "
          f"{cache_b / 1e9:.3f} GB of cache a rank, filled to "
          f"{LONG_SERVE['fill']} in {k[0]['prefill_s']:.2f} s): kernel run "
          f"== plain run (tokens, every cache leaf after the fill and at "
          f"the end by sha256); tokens {toks[0]}; {dec_ms:.2f} ms a decode "
          f"step (median, slowest rank); tp@attn_combine "
          f"{csite.get('tp@attn_combine', 0.0):.0f} B == reckoned "
          f"{lwant['tp@attn_combine']:.0f} B per rank per step; peak "
          f"{out['17c']['peak_gib']} GiB per rank [{card}]")
    # 17e: the dry-run
    bad = {c: r["status"] for c, r in dry["records"].items()
           if r["status"] != "traced"}
    if bad or len(dry["records"]) != 8:
        fail(f"phase 17e: cells not traced: {bad}")
    out["17e"] = {"seconds": dry["seconds"], "records": {
        c: {k_: r[k_] for k_ in ("roofline", "traced", "memory",
                                 "collectives", "trace_s", "analytic")}
        for c, r in dry["records"].items()}}
    print(f"phase 17e: {DRY_ARCH}'s four cells on pod16x16 and pod2x16x16 "
          f"traced on meta tensors in {dry['seconds']:.1f} s (host) "
          f"[{card}]")
    for mesh, tables in dry["tables"].items():
        print(f"  {mesh} roofline (H100 peaks):\n{tables['roofline']}")
        print(f"  {mesh} dry-run:\n{tables['dryrun']}")
    sh = out["share"]
    print(f"phase 17 share of the step: {POD_ARCH} {POD_DEPTH} layers, "
          f"{sh['params']} params, model FLOPs {sh['model_flops']:.4g} a "
          f"step, cost model {sh['cost_flops_per_device']:.4g} FLOP and "
          f"{sh['cost_hbm_bytes_per_device']:.4g} B per device; "
          f"{sh['model_flops_per_device']:.4g} model FLOPs per device at "
          f"{step * 1e3:.1f} ms = {sh['share_per_device'] * 100:.3f} % of "
          f"989e12 per rank, {sh['share_of_card'] * 100:.3f} % of the one "
          f"card's peak (all {POD * POD_DP} ranks) [{card}]")
    return out


def launch_sums(res) -> dict:
    return {n: sum(r["launches"][n] for r in res) for n in res[0]["launches"]}


def mm_operands(torch, kind: str, rows: int, width: int, r: int, seed: int,
                integer: bool = False):
    """(a, b) of one lowrank product form as the plr codec passes them:
    ``tall`` M @ Q, ``at_b`` M.T @ P (a view of M), ``small_k`` P @ Q.T (a
    view of Q), M the (rows, width) matrix view of the flat gradient;
    standard normals, or integers in [-2, 2] under ``integer``."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def draw(*shape):
        if integer:
            return torch.randint(-2, 3, shape, generator=g, device="cuda",
                                 dtype=torch.int32).float()
        return torch.randn(*shape, generator=g, device="cuda")
    if kind == "tall":
        return draw(rows, width), draw(width, r)
    if kind == "at_b":
        return draw(rows, width).T, draw(rows, r)
    return draw(rows, r), draw(width, r).T


def check_matmul(torch, kind: str, rows: int, width: int, r: int):
    """Hold one form against its plain version: bit for bit on integer
    operands in [-2, 2] (every partial sum is an integer below 2^24, exact
    in any order, so a dropped or doubled slab shows); on normal operands
    within lowrank.error_bound of it and within lowrank.order_bound (the
    kernel's own sum order) of the f64 product, and a second call repeats
    bit for bit.  Returns (max abs difference from the plain version on
    normal operands, the largest share of the order bound)."""
    from repro_torch.kernels import lowrank

    a, b = mm_operands(torch, kind, rows, width, r, seed=r + len(kind),
                       integer=True)
    if lowrank.form(a, b) != kind:
        fail(f"matmul {kind}: operands take form {lowrank.form(a, b)}")
    got, want = lowrank.matmul(a, b), lowrank.matmul(a, b, backend="torch")
    if not torch.equal(got, want):
        fail(f"matmul {kind} r={r}: differs from the plain version on "
             f"integer operands (exact) by {max_diff(got, want)}")
    del a, b, got, want
    a, b = mm_operands(torch, kind, rows, width, r, seed=r + len(kind))
    got, again = lowrank.matmul(a, b), lowrank.matmul(a, b)
    want = lowrank.matmul(a, b, backend="torch")
    if not torch.equal(got, again):
        fail(f"matmul {kind} r={r}: a second call differs")
    err = (got.double() - want.double()).abs()
    bnd = lowrank.error_bound(a, b)
    if not bool((err <= bnd).all()):
        fail(f"matmul {kind} r={r}: beyond the error bound by "
             f"{float((err - bnd).max())}")
    e_abs = float(err.max())
    del err, bnd, want
    with lowrank._no_tf32():
        err = (got.double() - torch.matmul(a.double(), b.double())).abs()
    bnd = lowrank.order_bound(a, b)
    if not bool((err <= bnd).all()):
        fail(f"matmul {kind} r={r}: beyond its order bound of the f64 "
             f"product by {float((err - bnd).max())}")
    return e_abs, float((err / bnd.clamp_min(1e-300)).max())


def time_matmul(torch, kind: str, rows: int, width: int, r: int):
    """(timings, bound, torch.matmul's cold-L2 ms, the kernels' own ms by
    name) of one form; the last only for at_b, whose two passes are two
    kernels."""
    from repro_torch.kernels import lowrank

    a, b = mm_operands(torch, kind, rows, width, r, seed=1)
    m, k = a.shape
    n = b.shape[1]

    def library():
        with lowrank._no_tf32():
            return torch.matmul(a, b)
    t = timings(torch, lambda: lowrank.matmul(a, b),
                lambda: lowrank.matmul(a, b, backend="torch"), iters=5)
    passes = kernel_ms(torch, lambda: lowrank.matmul(a, b), "mm_at_b") \
        if kind == "at_b" else None
    return t, bound((m * k + k * n + m * n) * 4, 2 * m * k * n), \
        cold_ms(torch, library), passes


GRAD_PATH = SCRATCH / "flat_grad.pt"   # phase 4's flat gradient, phase 5's


def training_runs() -> list:
    """Phase 4's runs (:func:`run`): the config's own remat (on, as in
    every full-size config) through the kernels, the plain versions and
    under baseline, and REMAT_OFF_STEPS steps of the kernel run with remat
    off."""
    SCRATCH.mkdir(exist_ok=True)
    return [run("zhybrid_16_8 kernels", "zhybrid_16_8",
                flat_grad_out=str(GRAD_PATH), depth=MAIN_DEPTH),
            run("zhybrid_16_8 plain", "zhybrid_16_8", "torch",
                depth=MAIN_DEPTH),
            run("baseline", "baseline", depth=MAIN_DEPTH),
            run("zhybrid_16_8 kernels, remat off", "zhybrid_16_8",
                steps=REMAT_OFF_STEPS, depth=MAIN_DEPTH,
                overrides={"remat": False})]


def check_remat(card, k, off) -> dict:
    """Phase 4's remat against its remat-off run: the kernel run (``k``,
    the config's remat) and ``off`` (remat off) bit-equal in losses and
    grad norms over ``off``'s steps on every rank, and less device memory
    allocated at the end of every forward with remat; prints those bytes,
    the peak GiB a rank and the priced MB per ``dim/level`` both ways."""
    n = len(off[0]["losses"])
    for rk, ro in zip(k, off):
        for key in ("losses", "grad_norms"):
            if rk[key][:n] != ro[key]:
                fail(f"phase 4 rank {rk['rank']}: {key} differ with remat "
                     f"({rk[key][:n]}) and without ({ro[key]})")
    fwd = {w: [max(r["fwd_allocated"][:n]) for r in res]
           for w, res in (("remat", k), ("off", off))}
    if not all(a < b for a, b in zip(fwd["remat"], fwd["off"])):
        fail(f"phase 4: device bytes at the end of the forward with remat "
             f"{fwd['remat']} not below those without {fwd['off']}")
    peak = {w: [round(r["peak_bytes"] / 2**30, 2) for r in res]
            for w, res in (("remat", k), ("off", off))}
    mb = {w: {key: round(v / 1e6, 3) for key, v in
              res[0]["priced_per_dim_level"].items() if v}
          for w, res in (("remat", k), ("off", off))}
    gib = {w: [round(b / 2**30, 3) for b in v] for w, v in fwd.items()}
    saved = [round((b - a) / 2**30, 3)
             for a, b in zip(fwd["remat"], fwd["off"])]
    print(f"phase 4 remat: losses and grad norms of steps 1-{n} bit-equal "
          f"with and without remat on every rank; allocated at the end of "
          f"the forward (max of those steps) {gib['remat']} GiB per rank "
          f"with remat, {gib['off']} without (saved {saved}); peak {peak['remat']} vs {peak['off']} GiB per rank; priced "
          f"MB per rank per step by dim/level {mb['remat']} with remat, "
          f"{mb['off']} without [{card}]")
    return {"fwd_allocated": fwd, "peak_gib": peak, "priced_mb": mb}


def drive_training(torch, card, res=None) -> dict:
    """Phase 4: the training step through the kernels, the plain versions
    and baseline (``res``: their per-rank results, trained here when
    ``None``); returns the kernel run's launches (all ranks), the file
    holding rank 0's flat gradient, and baseline's priced ledger."""
    grad_path = GRAD_PATH
    k, p, b, off = res or train_runs(card, training_runs())
    for rk, rp in zip(k, p):
        for key in ("losses", "grad_norms", "wire_per_dim", "priced_per_dim"):
            if rk[key] != rp[key]:
                fail(f"rank {rk['rank']}: {key} differ between the kernel "
                     f"run ({rk[key]}) and the plain run ({rp[key]})")
    launches = launch_sums(k)
    for n in ("bq_encode", "bq_encode_flat", "bq_encode_view", "bq_decode",
              "bq_decode_flat", "bq_decode_add_encode", "bq_decode_add",
              "bq_decode_add_flat"):
        if launches[n] <= 0:
            fail(f"the training step never launched {n}: {launches}")
    # the TP reduce-scatters run on the view forms: no block encode or
    # decode-add at their chunks' rows
    from repro_torch.kernels.bq import padded_rows
    tp_rows = {padded_rows(int(np.prod(sh)) // TP) for sh in RS_SHAPES}
    block = {key: c for key, c in shape_sums(k).items()
             if key[0] in ("bq_encode", "bq_decode_add") and key[1] in tp_rows}
    if block:
        fail(f"block forms launched at the TP reduce-scatters' rows: {block}")
    if any(v for r in p for v in r["launches"].values()):
        fail(f"the plain run launched kernels: {[r['launches'] for r in p]}")
    for r, rb in zip(k, b):
        for s, (lk, lb) in enumerate(zip(r["losses"], rb["losses"])):
            if not (np.isfinite(lk) and np.isfinite(lb)) or \
                    abs(lk - lb) > 0.01 * abs(lb):
                fail(f"rank {r['rank']} step {s}: loss {lk} vs baseline {lb}")
    zk, zb = k[0]["priced_per_dim"], b[0]["priced_per_dim"]
    ratio = {d: zk[d] / zb[d] for d in zb}
    for d, bits in (("dp", 8), ("zero", 16)):
        want = (bits + 32 / 128) / 32
        if not want <= ratio[d] <= want * 1.01:
            fail(f"{d} wire bytes {zk[d]} vs baseline {zb[d]}: ratio "
                 f"{ratio[d]:.4f}, codec ratio {want:.4f}")
    if not ratio["tp"] < 1:
        fail(f"tp wire bytes {zk['tp']} not below baseline {zb['tp']}")
    print(f"phase 4: kernel run == plain run (losses, grad norms, ledger "
          f"per dim) on every rank; losses within 1 % of baseline; priced "
          f"wire bytes per rank per step, zhybrid_16_8 vs baseline: "
          + ", ".join(f"{d} {zk[d] / 1e6:.1f} vs {zb[d] / 1e6:.1f} MB "
                      f"({ratio[d]:.4f})" for d in sorted(zb))
          + f"; measured {k[0]['wire_per_dim']}; launches (all ranks) "
          f"{launches} [{card}]")
    remat = check_remat(card, k, off)
    if not grad_path.exists():
        fail("phase 4 saved no flat gradient for phase 5")
    return {"launches": launches, "shapes": shape_sums(k), "remat": remat,
            "grad_path": grad_path,
            "step_s": max(float(np.median(r["step_s"][1:])) for r in k),
            "zhybrid": zk, "baseline": zb, "baseline_losses": b[0]["losses"]}


def flat_elems(cfg) -> int:
    """Per-rank flat gradient elements of the training step (the DP
    sync's payload)."""
    from repro_torch.models.params import MeshInfo, defs, local_shape
    from repro_torch.models.transformer import model_plan

    mi = MeshInfo(tp=TP, dp=DP)
    return sum(int(np.prod(local_shape(d, mi)))
               for d in defs(model_plan(cfg, mi)))


def stateful_runs() -> list:
    """Phase 6's runs (:func:`run`)."""
    return [run("plr8 kernels", "zhybrid_16_8", None, STATEFUL_STEPS, PLR,
                depth=MAIN_DEPTH),
            run("plr8 plain", "zhybrid_16_8", "torch", STATEFUL_STEPS, PLR,
                depth=MAIN_DEPTH),
            run("ef_zhybrid_16_4 kernels", "ef_zhybrid_16_4", None,
                STATEFUL_STEPS, depth=MAIN_DEPTH)]


def drive_stateful(torch, card, train, n_flat, res=None) -> dict:
    """Phase 6: plr8 on the DP gradient sync through the kernels and the
    plain versions, and ef_zhybrid_16_4 through the kernels (``res``:
    their per-rank results, trained here when ``None``); returns the
    kernel runs' launches (all ranks)."""
    from repro_torch.core import codecs

    k, p, e = res or train_runs(card, stateful_runs())
    for rk, rp in zip(k, p):
        for key in ("wire_per_dim", "priced_per_dim"):
            if rk[key] != rp[key]:
                fail(f"phase 6 rank {rk['rank']}: {key} differ between the "
                     f"plr8 kernel run ({rk[key]}) and plain run "
                     f"({rp[key]})")
        for key in ("losses", "grad_norms"):
            if not np.allclose(rk[key], rp[key], rtol=PLR_RTOL, atol=0):
                fail(f"phase 6 rank {rk['rank']}: plr8 {key} beyond rtol "
                     f"{PLR_RTOL}: kernels {rk[key]}, plain {rp[key]}")
    worst = max(abs(a / b - 1) for rk, rp in zip(k, p)
                for key in ("losses", "grad_norms")
                for a, b in zip(rk[key], rp[key]))
    kl, el = launch_sums(k), launch_sums(e)
    for n in MM_FORMS:
        if kl[f"matmul_{n}"] <= 0:
            fail(f"the plr8 step never launched matmul_{n}: {kl}")
    if any(v for r in p for v in r["launches"].values()):
        fail(f"the plr8 plain run launched kernels: "
             f"{[r['launches'] for r in p]}")
    for n in ("bq_encode", "bq_decode", "bq_decode_add"):
        if el[n] <= 0:
            fail(f"the ef_zhybrid_16_4 step never launched {n}: {el}")
    for label, res in (("plr8", k), ("ef_zhybrid_16_4", e)):
        for r in res:
            ls = r["losses"]
            if not (np.isfinite(ls).all() and ls[-1] < ls[0]):
                fail(f"{label} rank {r['rank']}: losses {ls} not finite and "
                     f"falling")
    base, zh = train["baseline"], train["zhybrid"]
    pk, pe = k[0]["priced_per_dim"], e[0]["priced_per_dim"]
    want = {"plr8": 2 * codecs.get("plr8").wire_nbytes_for(n_flat)
            / (4 * n_flat),
            "ef:bq4": (4 + 32 / 128) / 32}
    got = {"plr8": pk["dp"] / base["dp"], "ef:bq4": pe["dp"] / base["dp"]}
    if abs(got["plr8"] / want["plr8"] - 1) > 1e-9:
        fail(f"plr8 dp bytes {pk['dp']} vs baseline {base['dp']}: ratio "
             f"{got['plr8']:.6f}, priced {want['plr8']:.6f}")
    if not want["ef:bq4"] <= got["ef:bq4"] <= want["ef:bq4"] * 1.01:
        fail(f"ef:bq4 dp bytes {pe['dp']} vs baseline {base['dp']}: ratio "
             f"{got['ef:bq4']:.4f}, codec ratio {want['ef:bq4']:.4f}")
    for d in ("tp", "zero"):
        if not pk[d] == pe[d] == zh[d]:
            fail(f"{d} bytes differ from zhybrid_16_8's: plr8 {pk[d]}, "
                 f"ef {pe[d]}, zhybrid {zh[d]}")
    print(f"phase 6: plr8 kernel run vs plain run: ledger equal, losses and "
          f"grad norms within {worst:.2e} (rtol {PLR_RTOL}); priced wire per "
          f"rank per step vs baseline: dp plr8 {pk['dp'] / 1e6:.2f} MB "
          f"({got['plr8']:.5f}), ef:bq4 {pe['dp'] / 1e6:.1f} MB "
          f"({got['ef:bq4']:.4f}), baseline {base['dp'] / 1e6:.1f} MB; tp "
          f"{pk['tp'] / 1e6:.1f} and zero {pk['zero'] / 1e6:.1f} MB as "
          f"zhybrid_16_8; measured plr8 {k[0]['wire_per_dim']}, ef "
          f"{e[0]['wire_per_dim']}; codec state rank 0: plr8 "
          f"{k[0]['codec_state']}, ef {e[0]['codec_state']}; launches (all "
          f"ranks) plr8 {kl}, ef {el} [{card}]")
    # phase 8's uninterrupted run: the plr8 kernel run (CKPT_DEPTH is
    # MAIN_DEPTH; phase 6's world trained a 2-step run of its own until
    # phase 17 came in)
    return {"plr": kl, "ef": el, "plr_run": k}


def ckpt_bytes(cfg, n_flat) -> int:
    """Bytes of one phase-8 checkpoint but its codec state: the bf16
    parameters and the f32 master, m and v of every rank's ZeRO-1 chunk."""
    from repro_torch.kernels.ops import padded_rows
    from repro_torch.models.params import MeshInfo, count_params
    from repro_torch.models.transformer import model_plan

    chunk = padded_rows(-(-n_flat // DP)) * 128
    return 2 * count_params(model_plan(cfg, MeshInfo())) \
        + 3 * 4 * DP * TP * chunk


def layout_shapes(cfg, dp: int, tp: int) -> dict:
    """Global shapes of phase 8's optimizer and codec state on a dp x tp
    mesh (the layout a checkpoint holds)."""
    from repro_torch.launch.train import comm_policy
    from repro_torch.models.model import Model
    from repro_torch.models.params import MeshInfo
    from repro_torch.train import checkpoint
    from repro_torch.train.train_step import make_trainer

    tr = make_trainer(Model(cfg, MeshInfo(tp=tp, dp=dp), device="cpu"),
                      scheme=comm_policy("zhybrid_16_8", PLR[1:]))
    return {k: [s.shape for s in checkpoint.flatten(shards)]
            for k, shards in (("opt", tr.opt_state_shards()),
                              ("codec", tr.codec_state_shards()))}


def point_latest(step: int) -> None:
    """Make ``step`` the restore point of phase 8's checkpoints again (a
    restart from an earlier checkpoint): drop the later step, flip
    ``latest`` back, atomically as the save does."""
    import shutil
    for sub in ("", "opt", "codec"):
        d = CKPT_DIR / sub
        for later in d.glob("step_*"):
            if int(later.name[5:]) > step:
                shutil.rmtree(later)
        tmp = d / ".latest.tmp"
        tmp.symlink_to(f"step_{step}")
        os.replace(tmp, d / "latest")


def restart_point() -> dict:
    """Between 8b and 8c: 8b's heartbeat, then the checkpoints pointed back
    at step CKPT_STEPS (:func:`point_latest`)."""
    hb = json.loads((CKPT_DIR / "heartbeat.json").read_text())
    point_latest(CKPT_STEPS)
    return hb


def checkpoint_prepare(card, cfg, n_flat) -> tuple:
    """Phase 8's checkpoint directory emptied and the free disk checked
    for two checkpoints of ``cfg`` (``n_flat`` its flat gradient); ->
    (free bytes, needed bytes)."""
    import shutil

    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    SCRATCH.mkdir(exist_ok=True)
    need = 2 * ckpt_bytes(cfg, n_flat)       # 8a's and 8b's (8c's replaces)
    free = shutil.disk_usage(SCRATCH).free
    if free < need * 1.1:
        fail(f"phase 8 needs {need / 1e9:.1f} GB (+10 %) free beside the "
             f"checkpoints' directory, {free / 1e9:.1f} GB are")
    print(f"phase 8: {free / 1e9:.1f} GB free, {need / 1e9:.1f} GB needed "
          f"for two checkpoints [{card}]")
    return free, need


def checkpoint_runs() -> list:
    """Phase 8's runs, in one world: 8a saves; 8b restarts from it
    (train_rank builds its mesh, model and state anew and restores them
    from the files, as a new process would); 8c then restarts from 8b's
    restore point (rank 0 reads 8b's heartbeat and points the checkpoints
    back between the two).  8a and 8b had a world each until phase 17
    came in."""
    flags = [*PLR, "--ckpt-dir", str(CKPT_DIR), "--ckpt-every",
             str(CKPT_STEPS)]
    return [run("8a plr8 kernels, save", "zhybrid_16_8", None, CKPT_STEPS,
                flags, depth=CKPT_DEPTH),
            run("8b resume", "zhybrid_16_8", None, CKPT_STEPS,
                [*flags, "--resume"], depth=CKPT_DEPTH),
            {"between": "restart_point"},
            run("8c resume at dp 4 x tp 1", "zhybrid_16_8", None, 1,
                [*flags, "--resume"], dp=DP * TP, tp=1, depth=CKPT_DEPTH)]


def drive_checkpoint(torch, card, plr, cfg, n_flat, res=None,
                     disk=None) -> dict:
    """Phase 8: save, resume and an elastic resume of phase 6's plr8
    kernel run at CKPT_DEPTH layers ``plr`` (its per-rank results; ``cfg``
    that depth's config, ``n_flat`` its flat gradient; ``res`` the runs'
    results and ``disk`` :func:`checkpoint_prepare`'s, both made here when
    ``None``); returns 8b's launches (all ranks) and the checkpoints'
    numbers."""
    import shutil

    if res is None:
        disk = checkpoint_prepare(card, cfg, n_flat)
        try:
            res = train_runs(card, checkpoint_runs())
        finally:
            shutil.rmtree(CKPT_DIR, ignore_errors=True)
    free, need = disk
    a, b, hb, c = res
    ck = {label: r[0]["ckpt"] for label, r in (("8a", a), ("8b", b),
                                               ("8c", c))}
    for label, x in ck.items():
        print(f"  {label}: saved steps {x['steps']}, {x['bytes'] / 1e9:.3f} GB "
              f"on disk; {x['save_s']:.2f}s in save calls (a blocking save "
              f"whole), {x['thread_s']:.2f}s in saving threads, "
              f"{x['wait_s']:.2f}s waiting for them after the last step, "
              f"{x['restore_s']:.2f}s restoring (rank 0) [{card}]")
    # the steps around the checkpoints beside phase 6's (slowest rank)
    secs = {label: [round(max(s), 4)
                    for s in zip(*(r["step_s"] for r in res))]
            for label, res in (("phase 6", plr), ("8a", a), ("8b", b),
                               ("8c", c))}
    print(f"  step seconds, slowest rank: {secs} [{card}]")
    for ra, rb, rp in zip(a, b, plr):
        for key in ("losses", "grad_norms"):
            if ra[key] + rb[key] != rp[key][:2 * CKPT_STEPS]:
                fail(f"phase 8 rank {rp['rank']}: {key} of 8a and 8b "
                     f"{ra[key] + rb[key]} differ from phase 6's "
                     f"uninterrupted run {rp[key]}")
    if hb["step"] != 2 * CKPT_STEPS - 1:
        fail(f"phase 8: heartbeat at step {hb['step']} after 8b, want "
             f"{2 * CKPT_STEPS - 1}")
    # 8b runs phase 6's step: the same launches per step
    lb, lp = launch_sums(b), launch_sums(plr)
    n_ref = len(plr[0]["losses"])
    if any(lb[n] * n_ref != lp[n] * CKPT_STEPS for n in lp) or \
            not all(lb[f"matmul_{n}"] for n in MM_FORMS):
        fail(f"phase 8: 8b's launches {lb} in {CKPT_STEPS} steps are not "
             f"phase 6's {lp} in {n_ref}")
    # the state restores where its global layout is the same at dp 4 x tp
    # 1, and falls back loudly where it is not (the reference's rule)
    same = {k: v == layout_shapes(cfg, DP * TP, 1)[k]
            for k, v in layout_shapes(cfg, DP, TP).items()}
    name = {"opt": "optimizer", "codec": "codec"}
    want = {"8b": [f"restored {name[k]} state at step {CKPT_STEPS}"
                   for k in name],
            "8c": [f"restored {name[k]} state at step {CKPT_STEPS}"
                   if same[k] else f"WARNING: {name[k]} state not portable "
                   f"to this topology" for k in name]}
    logs = {"8b": b[0]["restore_log"], "8c": c[0]["restore_log"]}
    for label, lines in want.items():
        for got, line in zip(logs[label], lines):
            if not got.startswith(line):
                fail(f"phase 8: {label} printed {got!r}, want {line!r}...")
    l8b, l8c = b[0]["losses"][0], c[0]["losses"][0]
    if not (np.isfinite(l8c) and abs(l8c - l8b) <= 0.01 * abs(l8b)):
        fail(f"phase 8: 8c's first loss {l8c} not within 1 % of 8b's {l8b}")
    print(f"phase 8 (the first {CKPT_DEPTH} layers): 8a + 8b == phase "
          f"6's {CKPT_DEPTH}-layer plr8 kernel run bit for bit "
          f"(losses, grad norms, every rank); 8b launched phase 6's kernels "
          f"per step {lb}; heartbeat at step {hb['step']}; 8c at dp "
          f"{DP * TP} x tp 1 (global layout unchanged: {same}): "
          f"{[m[:60] for m in logs['8c'][:2]]}; first loss {l8c} vs 8b's "
          f"{l8b} ({abs(l8c / l8b - 1) * 100:.4f} %) [{card}]")
    return {"launches": lb, "ckpt": ck, "free_bytes": free,
            "need_bytes": need}


def rings_rank(*, rank: int, world: int, **kw) -> tuple:
    """One rank of phase 5's world: the cases through the kernels, then
    through the plain versions (``ring_check.collectives_rank``)."""
    from repro_torch.launch.ring_check import collectives_rank
    return tuple(collectives_rank(rank=rank, world=world, backend=b, **kw)
                 for b in (None, "torch"))


def drive_rings(torch, card, grad_path) -> dict:
    """Phase 5: the flat collectives alone over a 4-rank data axis, the
    kernel and plain runs in one world (two until phase 17 came in)."""
    from repro_torch.launch.train import spawn_world

    cases = [dict(op=op, codec="bq8", bidir=bd, chunks=1)
             for bd in (False, True) for op in ("reduce_scatter_flat", "ring")]
    kw = dict(cases=cases, payload=str(grad_path), device="cuda",
              digest=True)
    both = spawn_world("chip_smoke:rings_rank", RING_WORLD, kw)
    k, p = [r[0] for r in both], [r[1] for r in both]
    for rk, rp in zip(k, p):
        for ck, cp in zip(rk, rp):
            if ck["result"] != cp["result"] or ck["wire"] != cp["wire"]:
                fail(f"phase 5 {ck['case']}: kernel and plain runs differ")
            if any(cp["launches"].values()):
                fail(f"phase 5 plain run launched {cp['launches']}")
    launches = {n: sum(c["launches"][n] for r in k for c in r)
                for n in k[0][0]["launches"]}
    if launches["bq_decode_add_encode_wire"] <= 0:
        fail(f"phase 5 never launched the wire-only hop: {launches}")
    for i, c in enumerate(cases):
        tk = max(r[i]["seconds"] for r in k)
        tp_ = max(r[i]["seconds"] for r in p)
        print(f"  {c['op']} bq8 {'bidir' if c['bidir'] else 'unidir'} over "
              f"{RING_WORLD} ranks: {tk:.2f}s kernels, {tp_:.2f}s plain "
              f"(slowest rank, exchange through gloo included) [{card}]")
    print(f"phase 5: kernel run == plain run (sums and wires, every rank); "
          f"launches (all ranks) {launches} [{card}]")
    return {"launches": launches}


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"{ROOT} is not a checkout of the repo (src/repro_torch missing)")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import configs
    from repro_torch.kernels import bq, lowrank, ops
    from repro_torch.models.model import Model
    from repro_torch.serve import paged_kv

    card = card_line()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} [{card}]")

    # ---------------------------------------------------------- phase 1
    starts = {"1": time.perf_counter()}    # wall clock at each phase
    t0 = time.perf_counter()
    bq._load()
    lowrank._load()
    print(f"phase 1: built {bq.build_info['path']} in "
          f"{bq.build_info['seconds']:.2f}s "
          f"(load {time.perf_counter() - t0:.2f}s) [{card}]")
    for name, line in ptxas_lines(bq.build_info.get("log", "")):
        print(f"  ptxas: {name}: {line}")

    if sys.argv[1:] == ["--ckpt-only"]:
        # phase 6's plr8 kernel run and phase 8 alone
        os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                              "expandable_segments:True")
        cfg = configs.get("gemma3-1b").truncated(CKPT_DEPTH)
        plr = train_run(card, "phase 6 plr8 kernels", "zhybrid_16_8", None,
                        2 * CKPT_STEPS, PLR, depth=CKPT_DEPTH)
        drive_checkpoint(torch, card, plr, cfg, flat_elems(cfg))
        print(f"card: {card}")
        return

    if sys.argv[1:] == ["--hier-only"]:
        # phases 9 to 18 alone
        os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                              "expandable_segments:True")
        hier, tune, cp, serve, z3, moe, rec, enc, pod, archs = drive_hier(
            torch, card)
        print(json.dumps({"phase9": hier, "phase10": tune, "phase11": cp,
                          "phase12": serve, "phase13": z3, "phase14": moe,
                          "phase15": rec, "phase16": enc, "phase17": pod,
                          "phase18": archs}))
        print(f"card: {card}")
        return

    if sys.argv[1:] in (["--cp-only"], ["--serve-only"], ["--zero3-only"],
                        ["--moe-only"], ["--recurrent-only"],
                        ["--encdec-only"], ["--pod-only"], ["--archs-only"]):
        # phase 11, 12, 13, 14, 15, 16, 17 or 18 alone
        os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                              "expandable_segments:True")
        only = sys.argv[1][2:-5]
        t0 = time.perf_counter()
        _, _, cp, serve, z3, moe, rec, enc, pod, archs = drive_hier(
            torch, card, only=only)
        print(json.dumps({"cp": {"phase11": cp}, "serve": {"phase12": serve},
                          "zero3": {"phase13": z3},
                          "moe": {"phase14": moe},
                          "recurrent": {"phase15": rec},
                          "encdec": {"phase16": enc},
                          "pod": {"phase17": pod},
                          "archs": {"phase18": archs}}[only]))
        print(f"wall seconds of the phase {time.perf_counter() - t0:.1f} "
              f"[{card}]")
        print(f"card: {card}")
        return

    if sys.argv[1:] == ["--pp-only"]:
        # phase 7 alone, beside phase 4's zhybrid_16_8 step
        os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                              "expandable_segments:True")
        train_run(card, "phase 4 zhybrid_16_8 kernels", "zhybrid_16_8",
                  depth=MAIN_DEPTH)
        drive_pipeline(torch, card)
        print(f"card: {card}")
        return

    # ---------------------------------------------------------- phase 2
    starts["2"] = time.perf_counter()
    nb = SLOTS * paged_kv.blocks_needed(PROMPT + GEN, BLOCK_TOKENS)
    cfg = configs.get("gemma3-1b")
    r = paged_kv.token_rows(cfg.n_kv_heads, cfg.head_dim_)
    rpb = BLOCK_TOKENS * r                       # rows per pool block
    mb = nb // SLOTS
    rows = ring_rows(cfg.truncated(MAIN_DEPTH))
    if sys.argv[1:] == ["--bq-only"]:
        # the bq timings alone, so that two trees can be compared in one
        # call (this file copied into each)
        path, block_kms = time_bq(torch, card, rows, (r, rpb, nb))
        tp_ops = time_tp_ops(torch, card, tp_shape(cfg))
        rs_ops = time_rs_ops(torch, card)
        kv_ops = time_kv_ops(torch, card, (r, rpb, nb))
        print(json.dumps({"bq_only": {
            "path": {k: {"ms": v[3][0], "warm_l2_ms": v[3][2],
                         "eager_ms": v[3][4], "bound_ms": v[4][0]}
                     for k, v in path.items()},
            "block_kernel_ms": block_kms, "tp_ops": tp_ops,
            "rs_ops": rs_ops, "kv_ops": kv_ops}}))
        print(f"card: {card}")
        return
    err = {"bq_encode": 0.0, "bq_decode": 0.0, "bq_gather_decode": 0.0,
           "bq_decode_add_encode": 0.0, "bq_decode_add": 0.0}
    fused_m = sorted({8, 16, 65536, rows["zero1_rs"], rows["grad_rep_psum"],
                      rows["mlp_out_rs"], rows["phase5_ring"]})
    for bits in BITS:
        for m in fused_m:
            for kind, name in (("sum", "bq_decode_add_encode"),
                               ("wire", "bq_decode_add_encode"),
                               ("add", "bq_decode_add")):
                err[name] = max(err[name], check_fused(torch, kind, m, bits))
            torch.cuda.empty_cache()
        for m in (8, 16, 65536):
            x = test_rows(torch, m, seed=bits * 7 + m)
            w = ops.bq_encode_blocks(x, bits)
            wp = ops.bq_encode_blocks(x, bits, backend="torch")
            for k in ("q_hi", "q_lo", "scale"):
                if wp[k] is None:
                    continue
                if not torch.equal(w[k], wp[k]):
                    fail(f"bq_encode rate {bits} M={m}: {k} differs")
                err["bq_encode"] = max(err["bq_encode"], max_diff(w[k], wp[k]))
            d = ops.bq_decode_blocks(w, bits)
            dp = ops.bq_decode_blocks(w, bits, backend="torch")
            if not torch.equal(d, dp):
                fail(f"bq_decode rate {bits} M={m} differs")
            err["bq_decode"] = max(err["bq_decode"], max_diff(d, dp))
        # the encode's division on scales across and beyond its fast range
        xd = division_rows(torch, 262144, seed=bits)
        for form, got, want in (
                ("block", bq.bq_encode(xd, bits), bq.encode_plain(xd, bits)),
                ("flat bf16", bq.bq_encode_flat(xd.to(torch.bfloat16), bits),
                 bq.encode_flat_plain(xd.to(torch.bfloat16), bits))):
            for k, a, b in zip(("q_hi", "q_lo", "scale"), got, want):
                if b is not None and not torch.equal(a, b):
                    fail(f"bq_encode {form} rate {bits} on division rows: "
                         f"{k} differs")
        # gather-decode at the main path's pool and table shapes
        x = test_rows(torch, nb * rpb, seed=bits)
        w = ops.bq_encode_blocks(x, bits, backend="torch")
        pool = {k: None if v is None else v.reshape(nb, BLOCK_TOKENS, r, -1)
                for k, v in w.items()}
        g = torch.Generator().manual_seed(bits)
        idx = torch.randint(0, nb, (SLOTS, mb), generator=g,
                            dtype=torch.int32).cuda()
        got = ops.bq_gather_decode(pool, idx, bits)
        want = ops.bq_gather_decode(pool, idx, bits, backend="torch")
        if not torch.equal(got, want):
            fail(f"bq_gather_decode rate {bits} differs")
        err["bq_gather_decode"] = max(err["bq_gather_decode"],
                                      max_diff(got, want))
        # ids outside the pool decode to NaN and read nothing
        bad = idx.clone()
        bad[0, 0], bad[1, 1] = nb, -1
        got = ops.bq_gather_decode(pool, bad, bits)
        torch.cuda.synchronize()
        if not (got[0, 0].isnan().all() and got[1, 1].isnan().all()):
            fail(f"bq_gather_decode rate {bits}: out-of-range id not NaN")
        ok = torch.ones(bad.shape, dtype=torch.bool, device=dev)
        ok[0, 0] = ok[1, 1] = False
        if not torch.equal(got[ok], want[ok]):
            fail(f"bq_gather_decode rate {bits}: in-range rows disturbed")
    torch.cuda.synchronize()
    print(f"phase 2: kernels == plain versions bit for bit at rates "
          f"{list(BITS)} (encode/decode M=8,16,65536, encode also on 262144 "
          f"rows of scales 2^-70..2^110; fused hops with the "
          f"sum, wire-only and decode-add at M={fused_m}; gather-decode "
          f"{SLOTS}x{mb} table over {nb} blocks x {BLOCK_TOKENS} tokens x "
          f"{r} rows) [{card}]")

    parts = {"block forms checked": time.perf_counter()}
    check_flat(torch, err)
    parts["flat forms checked"] = time.perf_counter()
    print(f"phase 2: flat encode and decode == plain versions bit for bit "
          f"(NaN positions equal) at rates {list(BITS)}, in "
          f"{list(FLAT_DTYPES)} (encode also int32) at n = {list(FLAT_N)} "
          f"and the TP activations' {int(np.prod(tp_shape(cfg)))} and "
          f"{int(np.prod(arch_shapes()['tp']))} (phase 18's minitron-4b), "
          f"misaligned and strided inputs included; gathered decode of "
          f"{TP} shards of {list(GATHER_SHAPES)} and both TP activations "
          f"along axes 0, 1 and 2 [{card}]")
    check_views(torch, err, (r, rpb, nb))
    parts["view forms checked"] = time.perf_counter()
    print(f"phase 2: TP reduce-scatter view forms (encode, wire-only hop, "
          f"fused decode-add) == plain versions bit for bit (NaN positions "
          f"equal) at rates {list(BITS)} in {list(FLAT_DTYPES)}, every chunk "
          f"of {list(VIEW_BASES)} split 2, 3 and 4 ways along each axis "
          f"(whole and ring-part rows, aligned and misaligned) and of "
          f"{[list(s) for s in RS_SHAPES + (arch_shapes()['rs'],)]} along "
          f"axis 1; fused KV read == gather-decode, slice and cast at the "
          f"serving table and at width {arch_shapes()['kv_width']} of "
          f"{arch_shapes()['kv'][0] * 128}-wide tokens on an "
          f"{arch_shapes()['kv_slots']} x {arch_shapes()['kv'][2] // arch_shapes()['kv_slots']}"
          f" table in {list(FLAT_DTYPES)}, out-of-range ids NaN [{card}]")
    path, block_kms = time_bq(torch, card, rows, (r, rpb, nb))
    parts["bq timed"] = time.perf_counter()
    tp_ops = time_tp_ops(torch, card, tp_shape(cfg))
    rs_ops = time_rs_ops(torch, card)
    kv_ops = time_kv_ops(torch, card, (r, rpb, nb))
    # phase 18's shapes: minitron-4b's TP gather and reduce-scatter, kimi-k2's
    # 224-wide KV read
    arch = arch_shapes()
    tp_ops_arch = time_tp_ops(torch, card, arch["tp"])
    rs_ops_arch = time_rs_ops(torch, card, (arch["rs"],))
    kv_ops_arch = time_kv_ops(torch, card, arch["kv"], arch["kv_slots"],
                              arch["kv_width"])
    host_breakdown(torch, card, tp_shape(cfg))
    parts["fused ops timed"] = time.perf_counter()

    # the lowrank matmul's three forms at the training step's matrix view
    n_flat = flat_elems(cfg.truncated(MAIN_DEPTH))
    mm_rows, mm_width = lowrank.mat_shape(n_flat)
    mm = {}
    for r_mm in sorted({r for rs in MM_RANKS.values() for r in rs}):
        for kind in (f for f in MM_FORMS if r_mm in MM_RANKS[f]):
            e_abs, share = check_matmul(torch, kind, mm_rows, mm_width, r_mm)
            t, b, lib, passes = time_matmul(torch, kind, mm_rows, mm_width,
                                            r_mm)
            mm[(kind, r_mm)] = (e_abs, share, t, b, lib, passes)
            (ms, pms, wms, wpms, ems, epms), (bms, by) = t, b
            each = "" if passes is None else "; kernels alone " + ", ".join(
                f"{nm} {v * 1e3:.2f} us" for nm, v in passes.items())
            print(f"  lowrank matmul {kind} r={r_mm} on the {mm_rows} x "
                  f"{mm_width} view: equal to plain on integers; on normals "
                  f"max abs diff from plain {e_abs:.3g}, from the f64 "
                  f"product {share * 100:.2f}% of its order bound, repeats "
                  f"bit for bit; "
                  f"device, L2 flushed, {ms * 1e3:.2f} us kernel "
                  f"({bms / ms * 100:.1f}% of bound) vs {pms * 1e3:.2f} us "
                  f"plain, torch.matmul {lib * 1e3:.2f} us; warm L2 (graph) "
                  f"{wms * 1e3:.2f} vs {wpms * 1e3:.2f} us; per eager call "
                  f"{ems * 1e3:.2f} vs {epms * 1e3:.2f} us; bound "
                  f"{bms * 1e3:.3f} us ({by}){each} [{card}]")
            torch.cuda.empty_cache()
    # modified Gram-Schmidt (plain PyTorch, not a kernel) at the plr8 step's
    # shapes: P^ of the view and Q' of its width, once each per step
    gs = {}
    for name, rows_gs in (("p", mm_rows), ("q", mm_width)):
        x = torch.randn(rows_gs, 8, device="cuda")
        gs[name] = eager_ms(torch, lambda x=x: lowrank.orthonormalize(x),
                            iters=10, warmup=2)
    gs["step"] = gs["p"] + gs["q"]
    print(f"phase 2: lowrank matmul equal to its plain version on integers, "
          f"within lowrank.error_bound of it and lowrank.order_bound of the "
          f"f64 product on normals, deterministic, all three forms at r=2, "
          f"4, 8 and 64 (tall and small_k also at 16, 32) on the {mm_rows} x "
          f"{mm_width} view; orthonormalize per "
          f"eager call {gs['p']:.3f} ms ({mm_rows} x 8) + {gs['q']:.3f} ms "
          f"({mm_width} x 8) = {gs['step']:.3f} ms per plr8 step [{card}]")

    # ---------------------------------------------------------- phase 3
    parts["lowrank checked and timed"] = time.perf_counter()
    prev = [starts["2"], *parts.values()]
    print("phase 2 seconds by part: " + ", ".join(
        f"{k} {t - p:.1f}" for (k, t), p in zip(parts.items(), prev))
        + f" [{card}]")
    starts["3"] = time.perf_counter()
    model = Model(cfg.truncated(SERVE_LAYERS))            # on the card
    t0 = time.perf_counter()
    params = model.init(SEED)
    torch.cuda.synchronize()
    print(f"phase 3: gemma3-1b, the first {model.cfg.n_layers} layers, "
          f"{model.n_params() / 1e9:.3f}B params bf16, init "
          f"{time.perf_counter() - t0:.2f}s [{card}]")
    s_launch = drive_serving(torch, model, params, card)
    del model, params
    torch.cuda.empty_cache()

    # ------------------------------------------------- phases 4, 6, 7, 8
    # one world of four ranks trains the runs of phases 4, 6, 7 and 8 in
    # turn (a world each until phase 17 came in); their checks follow,
    # phase 5's rings (on phase 4's flat gradient) between them
    starts["4, 6, 7, 8"] = time.perf_counter()
    # the ranks (fresh processes) share the card: growable segments keep
    # their reserved-but-free memory from fragmenting it
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    print(f"phase 4: gemma3-1b full width, the first {MAIN_DEPTH} layers, "
          f"dp {DP} x tp {TP} "
          f"ranks on this card, {STEPS} steps, seq {SEQ}, global batch "
          f"{GLOBAL_BATCH}; this process keeps "
          f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved "
          f"[{card}]")
    print(f"phase 6: carried-state codecs on phase 4's step, "
          f"{STATEFUL_STEPS} steps: plr8 on the DP sync (kernels, plain), "
          f"ef_zhybrid_16_4 (kernels) [{card}]")
    print(f"phase 7: the pipeline, gemma3-1b full width, dp 1 x pp {PP} x "
          f"tp {TP} ranks on this card, {PP_MICRO} microbatches, seq {SEQ}, "
          f"global batch {GLOBAL_BATCH}, zhybrid_16_8: 7a --layers "
          f"{PP_RUNS[0][1]} (1F1B), 7b --layers {PP_RUNS[1][1]} (vpp 2, "
          f"remat per_stage:0) [{card}]")
    print(f"phase 8: checkpoint and resume phase 6's plr8 kernel run at "
          f"its first {CKPT_DEPTH} layers "
          f"(8a {CKPT_STEPS} steps and a save, 8b resume {CKPT_STEPS} steps, "
          f"8c resume at dp {DP * TP} x tp 1, 1 step) [{card}]")
    cfg8 = cfg.truncated(CKPT_DEPTH)
    disk = checkpoint_prepare(card, cfg8, flat_elems(cfg8))
    groups = [training_runs(), stateful_runs(), pipeline_runs(),
              checkpoint_runs()]
    try:
        res = train_runs(card, [r for g in groups for r in g])
    finally:
        import shutil
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    parts, at = [], 0
    for g in groups:
        parts.append(res[at:at + len(g)])
        at += len(g)
    phase_seconds(card, "phases 4, 6, 7 and 8", {
        ph: [r for r in part if isinstance(r, list)]
        for ph, part in zip(("4", "6", "7", "8"), parts)})
    train = drive_training(torch, card, res=parts[0])

    # ---------------------------------------------------------- phase 5
    starts["5"] = time.perf_counter()
    rings = drive_rings(torch, card, train["grad_path"])
    train["grad_path"].unlink()
    starts["checks of 6, 7, 8"] = time.perf_counter()
    stateful = drive_stateful(torch, card, train, n_flat, res=parts[1])
    pipe = drive_pipeline(torch, card, res=parts[2])
    ckpt = drive_checkpoint(torch, card, stateful["plr_run"], cfg8,
                            flat_elems(cfg8), res=parts[3], disk=disk)

    # ---------------------------------------------------------- phase 9
    starts["9 to 18"] = time.perf_counter()
    print(f"phase 9: node-factored meshes, gemma3-1b full width, four ranks "
          f"on this card, seq {SEQ}, global batch {GLOBAL_BATCH}: 9a --dp 4 "
          f"--nodes 2 --layers {HIER_RUNS[0][3][-1]} (hier_zpp_8_16), 9b "
          f"--tp 4 --tp-nodes 2 --layers {HIER_RUNS[1][3][-1]} "
          f"(hier_tpp_8_16), 9c --pp 4 --pp-nodes 2 --layers "
          f"{HIER_RUNS[2][3][-3]} "
          f"(hier_tpp_8_16, 1F1B); then phase 10 in the same world, the "
          f"tuned step: {' '.join(TUNE_FLAGS)} from {TUNE_SCHEME}, "
          f"{TUNE_STEPS} steps (kernels, plain); then phase 11, context "
          f"parallelism: 11a --dp 2 --cp 2, the first {CP_RUNS[0][5]} "
          f"layers (zhybrid_16_8; kernels, plain), 11b --cp 4 --cp-nodes 2, "
          f"the first {CP_RUNS[1][5]} (hier_tpp_8_16; kernels); then "
          f"phase 12, serving, the first {SERVE_DEPTH} layers, prompts of "
          f"{SERVE_PROMPT}, "
          f"{SERVE_GEN} generated: 12a batched --dp 2 --tp 2 "
          f"(zhybrid_16_8; kernels, plain), 12b batched --tp 4 --tp-nodes "
          f"2 (hier_tpp_8_16; kernels), 12c paged --dp 4 --kv-codec bq8, "
          f"{PAGED_REQUESTS} requests on {PAGED_SLOTS} slots (kernels, "
          f"plain), 12d disagg --tp 2 --kv-codec bq8 (kernels, plain); "
          f"then phase 13, {Z3_ARCH} at full width, the first {Z3_DEPTH} "
          f"layers: 13a {' '.join(Z3_FLAGS)} with ZeRO-3 ({Z3_SCHEME}, "
          f"{Z3_STEPS} steps; kernels), 13b the same (plain), 13c paged "
          f"--dp 2 --tp 2 --kv-codec bq8, {Z3_REQUESTS} requests on "
          f"{Z3_SLOTS} slots (kernels, plain); then phase 14, {MOE_ARCH} at "
          f"full width: 14a the first {MOE_DEPTH} layer(s), "
          f"{' '.join(MOE_FLAGS)} with {MOE_EXPERTS} experts and ZeRO-3 "
          f"({MOE_SCHEME}, {MOE_STEPS} steps; kernels), 14b the same "
          f"(plain), 14c the first {MOE_SERVE_DEPTH} layers, batched --tp "
          f"{MOE_SERVE['tp']} with all 128 "
          f"experts, {MOE_SERVE['batch']} prompts of {SERVE_PROMPT} + "
          f"{SERVE_GEN} (kernels, plain); then phase 15, the recurrent "
          f"families at full width, {' '.join(REC_FLAGS)} ({REC_SCHEME}, "
          f"{REC_STEPS} steps): 15a/15b {REC_RUNS[0][2]}, the first "
          f"{REC_RUNS[0][3]} mamba layers with the shared block once, "
          f"15c/15d {REC_RUNS[1][2]}, the first {REC_RUNS[1][3]} layers "
          f"(kernels, plain), 15e both served batched, "
          f"{REC_SERVE['batch']} prompts of {SERVE_PROMPT} + {SERVE_GEN} "
          f"(kernels, plain); then phase 16, {ENC_ARCH} at full width and "
          f"depth, {' '.join(ENC_FLAGS)} ({ENC_SCHEME}, {ENC_STEPS} steps): "
          f"16a kernels, 16b plain, 16c batched, {ENC_SERVE['batch']} "
          f"prompts of {ENC_SERVE['prompt_len']} + {ENC_SERVE['gen']} "
          f"(kernels, plain); then phase 17, {POD_ARCH} at full width: "
          f"17a/17b the first {POD_DEPTH} layers, {' '.join(POD_FLAGS)} "
          f"({POD_SCHEME}, {POD_STEPS} steps; kernels, plain) beside "
          f"{' '.join(POD_BASE_FLAGS)}, 17c/17d its first {LONG_DEPTH} "
          f"layers served at "
          f"dp {LONG_DP} x tp {LONG_TP} with the cache's {LONG_S} "
          f"positions over (data, model), {LONG_GEN} tokens decoded "
          f"(kernels, plain), 17e the dry-run beside the world; then phase "
          f"18, the first {ARCH_DEPTH} layers at full width ({ARCH_SCHEME}): "
          f"18a/18b {ARCH_TRAIN} {' '.join(ARCH_FLAGS)}, {ARCH_STEPS} steps "
          f"(kernels, plain), "
          + ", ".join(f"{n} {a} {kw['mode']} --tp {kw['tp']}"
                      for n, a, kw in ARCH_SERVE)
          + f" (kernels, plain) [{card}]")
    hier, tune, cp, serve, z3, moe, rec, enc, pod, archs = drive_hier(torch,
                                                                      card)
    # the whole-step shares of the H100's peak: phase 4's step and 17a's
    from repro_torch.launch.mesh import make_mesh
    sh4 = step_share(cfg.truncated(MAIN_DEPTH), make_mesh(DP, TP, rank=0),
                     train["step_s"], DP * TP)
    print(f"phase 4 share of the step: gemma3-1b {MAIN_DEPTH} layers, "
          f"{sh4['params']} params, model FLOPs {sh4['model_flops']:.4g} a "
          f"step, cost model {sh4['cost_flops_per_device']:.4g} FLOP and "
          f"{sh4['cost_hbm_bytes_per_device']:.4g} B per device; "
          f"{sh4['model_flops_per_device']:.4g} model FLOPs per device at "
          f"{train['step_s'] * 1e3:.1f} ms = "
          f"{sh4['share_per_device'] * 100:.3f} % of 989e12 per rank, "
          f"{sh4['share_of_card'] * 100:.3f} % of the one card's peak (all "
          f"{DP * TP} ranks); phase 17a "
          f"{pod['share']['share_per_device'] * 100:.3f} % per rank, "
          f"{pod['share']['share_of_card'] * 100:.3f} % of the card [{card}]")

    starts["reckoning"] = time.perf_counter()
    # launches x (time - bound) per shape of phase 4's kernel run, timed in
    # a fresh process (this one's profiler reports nothing after phases
    # 3-6 have run)
    print(f"launches by shape on phase 4's path (zhybrid_16_8, per rank per "
          f"step) [{card}]", flush=True)
    shapes_path = SCRATCH / "launch_shapes.json"
    shapes_path.write_text(json.dumps([[*k, v] for k, v in
                                       train["shapes"].items()]))
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                           "--reckon", str(shapes_path)], timeout=600)
    if proc.returncode != 0:
        fail(f"timing the path's shapes failed ({proc.returncode})")
    by_shape = json.loads(shapes_path.with_suffix(".out.json").read_text())

    starts["end"] = time.perf_counter()
    # kernel line: launches on each kernel's path (phase 4 the training
    # step, phase 3 serving, phase 5 the rings, phase 7 the pipeline, phase 8
    # the resumed step), times at the path's shape
    t_launch, r_launch = train["launches"], rings["launches"]
    kernels = []

    def p7_launches(kernel: str) -> int:
        return sum(run["launches"][kernel] for run in pipe.values())

    def p7_entry(kernel: str) -> dict:
        """Phase 7's launches of one kernel (all ranks) per run, and by
        (wire rows, rate)."""
        return {run: {"launches": r["launches"][kernel],
                      "by_shape": [[rows, bits, c] for (k, rows, bits), c
                                   in sorted(r["shapes"].items())
                                   if k == kernel]}
                for run, r in pipe.items()}

    def p9_launches(kernel: str) -> int:
        return sum(run["launches"][kernel] for run in hier.values())

    def p9_entry(kernel: str) -> dict:
        """Phase 9's launches of a kernel (all ranks, the kernel runs) per
        run, by link level; a bq kernel's flat and view forms count with
        it."""
        forms = KERNEL_FORMS.get(kernel, (kernel,))
        return {run: {key: v for key, v in r["levels"].items()
                      if key.split("/")[0] in forms}
                for run, r in hier.items()}

    def p11_entry(kernel: str) -> dict:
        """Phase 11's launches of a kernel (all ranks, the kernel runs) per
        run, by link level; a bq kernel's flat and view forms count with
        it."""
        forms = KERNEL_FORMS.get(kernel, (kernel,))
        return {run: {key: v for key, v in r["levels"].items()
                      if key.split("/")[0] in forms}
                for run, r in cp.items()}

    def p11_launches(kernel: str) -> int:
        return sum(run["launches"][kernel] for run in cp.values())

    def p12_entry(kernel: str) -> dict:
        """Phase 12's launches of a kernel (all ranks, the kernel runs) per
        run, by link level; a bq kernel's flat and view forms count with
        it."""
        forms = KERNEL_FORMS.get(kernel, (kernel,))
        return {run: {key: v for key, v in r["levels"].items()
                      if key.split("/")[0] in forms}
                for run, r in serve.items()}

    def p12_launches(kernel: str) -> int:
        return sum(run["launches"][kernel] for run in serve.values())

    def p13_launches(kernel: str) -> int:
        return z3["launches"][kernel] + z3["13c"]["launches"][kernel]

    def p14_launches(kernel: str) -> int:
        return moe["launches"][kernel] + moe["14c"]["launches"][kernel]

    def p14_entry(kernel: str) -> dict:
        """Phase 14's launches of a kernel (all ranks, the kernel runs) per
        run by link level, and 14a's at the ep sites' rows; a bq kernel's
        flat and view forms count with it."""
        forms = KERNEL_FORMS.get(kernel, (kernel,))
        return {"14a": {key: v for key, v in moe["levels"].items()
                        if key.split("/")[0] in forms},
                "14a_ep_sites": {f"{kernel}/{moe['ep_rows']}":
                                 moe["ep_site_launches"][kernel]}
                if kernel in moe["ep_site_launches"] else {},
                "14c": {key: v for key, v in moe["14c"]["levels"].items()
                        if key.split("/")[0] in forms}}

    def p15_launches(kernel: str) -> int:
        return sum(m["launches"][kernel] + m["15e"]["launches"][kernel]
                   for m in rec.values() if isinstance(m, dict))

    def p15_entry(kernel: str) -> dict:
        """Phase 15's launches of a kernel (all ranks, the kernel runs) per
        model and run by link level, and at the recurrent sites' rows; a bq
        kernel's flat and view forms count with it."""
        forms = KERNEL_FORMS.get(kernel, (kernel,))
        return {arch: {"train": {key: v for key, v in m["levels"].items()
                                 if key.split("/")[0] in forms},
                       "sites": {site: {key: v for key, v in at.items()
                                        if key.split("/")[0] in forms}
                                 for site, at in m["site_launches"].items()},
                       "15e": {key: v for key, v in m["15e"]["levels"].items()
                               if key.split("/")[0] in forms}}
                for arch, m in rec.items() if isinstance(m, dict)}

    def p16_launches(kernel: str) -> int:
        return enc["launches"][kernel] + enc["16c"]["launches"][kernel]

    def p17_launches(kernel: str) -> int:
        return pod["launches"][kernel] + pod["17c"]["launches"][kernel]

    def p17_entry(kernel: str) -> dict:
        """Phase 17's launches of a kernel (all ranks, the kernel runs) by
        link level: 17a's and 17c's; a bq kernel's flat and view forms
        count with it."""
        forms = KERNEL_FORMS.get(kernel, (kernel,))
        return {run: {key: v for key, v in levels.items()
                      if key.split("/")[0] in forms}
                for run, levels in (("17a", pod["levels"]),
                                    ("17c", pod["17c"]["levels"]))}

    def p18_launches(kernel: str) -> int:
        return sum(r["launches"][kernel] for r in archs.values()
                   if isinstance(r, dict))

    def p18_entry(kernel: str) -> dict:
        """Phase 18's launches of a kernel (all ranks, the kernel runs)
        per run by link level, and 18e's at the ep all-to-alls' rows; a bq
        kernel's flat and view forms count with it."""
        forms = KERNEL_FORMS.get(kernel, (kernel,))
        out = {run: {key: v for key, v in r["levels"].items()
                     if key.split("/")[0] in forms}
               for run, r in archs.items() if isinstance(r, dict)}
        if kernel in archs["18e"]["ep_site_launches"]:
            out["18e_ep_sites"] = {
                f"{kernel}/{archs['18e']['ep_rows']}":
                archs["18e"]["ep_site_launches"][kernel]}
        return out

    def p16_entry(kernel: str) -> dict:
        """Phase 16's launches of a kernel (all ranks, the kernel runs) per
        run by link level, and 16a's at the cross gather's rows; a bq
        kernel's flat and view forms count with it."""
        forms = KERNEL_FORMS.get(kernel, (kernel,))
        return {"16a": {key: v for key, v in enc["levels"].items()
                        if key.split("/")[0] in forms},
                "16a_cross_kv_rows": {key: v for key, v in
                                      enc["site_launches"].items()
                                      if key.split("/")[0] in forms},
                "16c": {key: v for key, v in enc["16c"]["levels"].items()
                        if key.split("/")[0] in forms}}

    def p13_entry(kernel: str) -> dict:
        """Phase 13's launches of a kernel (all ranks, the kernel runs) per
        run by link level, and 13a's at the zero site's rows; a bq
        kernel's flat and view forms count with it."""
        forms = KERNEL_FORMS.get(kernel, (kernel,))
        return {"13a": {key: v for key, v in z3["levels"].items()
                        if key.split("/")[0] in forms},
                "13a_zero_site": {f: z3["zero_site_launches"][f]
                                  for f in forms
                                  if f in z3["zero_site_launches"]},
                "13c": {key: v for key, v in z3["13c"]["levels"].items()
                        if key.split("/")[0] in forms}}

    def p10_entry(kernel: str) -> dict:
        """Phase 10's launches of a kernel (all ranks, the kernel run) by
        rate and by link level; a bq kernel's flat and view forms count
        with it."""
        forms = {"bq_decode_add_encode": ("bq_decode_add_encode",
                                          "bq_decode_add_encode_wire")
                 }.get(kernel, (kernel,))
        return {"by_rate": {k: v for k, v in tune["by_rate"].items()
                            if k.split("/")[0] in forms},
                "by_level": {k: v for k, v in tune["levels"].items()
                             if k.split("/")[0] in forms}}

    for name, line, launches in (
            ("bq_encode", 173, t_launch["bq_encode"]),
            ("bq_decode", 205, t_launch["bq_decode"]),
            ("bq_decode_add_encode", 229,
             t_launch["bq_decode_add_encode"]
             + r_launch["bq_decode_add_encode_wire"]),
            ("bq_decode_add", 278, t_launch["bq_decode_add"]),
            ("bq_gather_decode", 302, s_launch["bq_gather_decode"])):
        where, bits, shape, (ms, pms, wms, _, _, _), (bms, by) = path[name]
        entry = {
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/bq.cu",
            "replaces": f"src/repro/kernels/bq.py:{line}",
            "launches": launches, "max_abs_err": err[name],
            "ms": ms, "plain_ms": pms, "bound_ms": bms, "bound_by": by,
            "library_ms": None, "l2": "flushed before each call",
            "warm_l2_ms": wms, "path": where, "rate": bits, "shape": shape}
        if name == "bq_decode_add_encode":
            wh, wb, wsh, (ows, owps, owws, _, _, _), (wbms, _) = \
                path["bq_decode_add_encode_wire"]
            entry["launches_with_sum"] = t_launch["bq_decode_add_encode"]
            entry["wire_only"] = {
                "path": wh, "rate": wb, "shape": wsh, "ms": ows,
                "plain_ms": owps, "warm_l2_ms": owws, "bound_ms": wbms,
                "launches": r_launch["bq_decode_add_encode_wire"]}
        entry["launches_ef_zhybrid_16_4"] = stateful["ef"][name]
        entry["launches"] += p7_launches(name) + ckpt["launches"][name] \
            + p9_launches(name) + tune["launches"][name] \
            + p11_launches(name) + p12_launches(name) + p13_launches(name) \
            + p14_launches(name) + p15_launches(name) + p16_launches(name) \
            + p17_launches(name) + p18_launches(name)
        entry["phase7"] = p7_entry(name)
        entry["phase8"] = ckpt["launches"][name]        # after the restore
        entry["phase9"] = p9_entry(name)
        entry["phase10"] = p10_entry(name)
        entry["phase11"] = p11_entry(name)
        entry["phase12"] = p12_entry(name)
        entry["phase13"] = p13_entry(name)
        entry["phase14"] = p14_entry(name)
        entry["phase15"] = p15_entry(name)
        entry["phase16"] = p16_entry(name)
        entry["phase17"] = p17_entry(name)
        entry["phase18"] = p18_entry(name)
        if name in ("bq_encode", "bq_decode"):
            # the block form's kernel alone, and the flat form the TP
            # all-gather calls (the same kernel, fused with its layout)
            entry["kernel_ms"] = block_kms[name]
            op = tp_ops[name[3:]]
            entry["flat"] = {
                "path": "tp@mlp_in all-gather, bf16 "
                        f"{list(tp_shape(cfg))} x {TP} shards", "rate": 16,
                "ms": op["ms"], "plain_ms": op["plain_ms"],
                "unfused_ms": op["unfused_ms"],
                "warm_l2_ms": op["warm_l2_ms"],
                "unfused_warm_l2_ms": op["unfused_warm_l2_ms"],
                "eager_ms": op["eager_ms"],
                "unfused_eager_ms": op["unfused_eager_ms"],
                "kernel_ms": op["kernel_ms"],
                "unfused_kernel_ms": op["unfused_kernel_ms"],
                "bound_ms": op["bound_ms"], "bound_by": "bytes",
                "stream_kernel_ms": op["stream_kernel_ms"],
                "launches": t_launch[f"{name}_flat"]
                + p7_launches(f"{name}_flat") + p9_launches(f"{name}_flat")
                + p11_launches(f"{name}_flat")
                + p12_launches(f"{name}_flat")
                + p13_launches(f"{name}_flat")
                + p14_launches(f"{name}_flat")
                + p15_launches(f"{name}_flat")
                + p16_launches(f"{name}_flat")
                + p17_launches(f"{name}_flat")
                + p18_launches(f"{name}_flat"),
                "phase7": p7_entry(f"{name}_flat"),
                "max_abs_err": err[f"{name}_flat"],
                "by_shape": by_shape.get(f"{name}_flat", []),
                "minitron_4b": {
                    "path": "phase 18a tp@mlp_in all-gather, bf16 "
                            f"{list(arch['tp'])} x {TP} shards",
                    **{key: tp_ops_arch[name[3:]][key] for key in (
                        "ms", "plain_ms", "unfused_ms", "warm_l2_ms",
                        "kernel_ms", "bound_ms", "stream_kernel_ms")}}}
        entry["by_shape"] = by_shape.get(name, [])
        if name == "bq_decode_add_encode":
            entry["wire_only"]["by_shape"] = by_shape.get(
                "bq_decode_add_encode_wire", [])
            # a middle hop of a TP ring of 3 or more ranks: checked in
            # phase 2, not on this path (tp 2)
            entry["view_wire_only"] = {
                "launches": t_launch["bq_decode_add_encode_view"],
                "max_abs_err": err["bq_decode_add_encode_view"]}
        if name in ("bq_encode", "bq_decode_add"):
            # the TP reduce-scatter's first and last hop on the view forms,
            # beside the block kernel alone and (the decode-add) the whole
            # end beside the composition it replaces
            form = {"bq_encode": ("bq_encode_view", "encode"),
                    "bq_decode_add": ("bq_decode_add_flat", "decode_add")}
            fname, op = form[name]
            entry["view" if op == "encode" else "flat"] = {
                "path": f"TP reduce-scatter, bf16 {[list(sh) for sh in RS_SHAPES]}"
                        f" along axis 1 over {TP} ranks", "rate": 16,
                "launches": t_launch[fname] + p7_launches(fname)
                + p9_launches(fname) + p11_launches(fname)
                + p12_launches(fname) + p13_launches(fname)
                + p14_launches(fname) + p15_launches(fname)
                + p16_launches(fname) + p17_launches(fname)
                + p18_launches(fname),
                "phase7": p7_entry(fname), "max_abs_err": err[fname],
                "bound_by": "bytes",
                "by_rows": {rows: {**ops_[op], "end": ops_["end"]}
                            for rows, ops_ in {**rs_ops,
                                               **rs_ops_arch}.items()},
                "by_shape": by_shape.get(fname, [])}
        if name == "bq_gather_decode":
            # the serving path reads through the fused KV read (bf16): the
            # entry's times are its
            kv = kv_ops["read"]
            entry.update({
                "ms": kv["ms"], "plain_ms": kv["plain_ms"],
                "bound_ms": kv["bound_ms"], "warm_l2_ms": kv["warm_l2_ms"],
                "kernel_ms": kv["kernel_ms"], "eager_ms": kv["eager_ms"],
                "unfused_ms": kv["unfused_ms"],
                "unfused_kernel_ms": kv["unfused_kernel_ms"],
                "stream_kernel_ms": kv["stream_kernel_ms"],
                "path": "serving read (fused KV read, bf16)"})
            kv = kv_ops_arch["read"]
            entry["width_224"] = {
                "path": f"phase 18e's read (kimi-k2 at tp 4): "
                        f"{arch['kv_width']} of {arch['kv'][0] * 128} values "
                        f"a token, {arch['kv_slots']} x "
                        f"{arch['kv'][2] // arch['kv_slots']} table",
                **{key: kv[key] for key in (
                    "ms", "plain_ms", "bound_ms", "warm_l2_ms", "kernel_ms",
                    "unfused_ms", "unfused_kernel_ms", "stream_kernel_ms")}}
        kernels.append(entry)
    # the lowrank matmul: one plr exchange runs each form once, so the
    # entry's times are the three forms' sums at the path's r = 8
    forms = {}
    for kind in MM_FORMS:
        e_abs, share, (ms, pms, wms, _, _, _), (bms, by), lib, passes = \
            mm[(kind, 8)]
        forms[kind] = {
            "launches": stateful["plr"][f"matmul_{kind}"]
            + ckpt["launches"][f"matmul_{kind}"]
            + tune["launches"][f"matmul_{kind}"],
            "phase8": ckpt["launches"][f"matmul_{kind}"],
            "phase10": tune["launches"][f"matmul_{kind}"],
            "max_abs_err": e_abs, "share_of_order_bound": share, "ms": ms,
            "plain_ms": pms, "bound_ms": bms, "bound_by": by,
            "library_ms": lib, "warm_l2_ms": wms}
        if passes:
            forms[kind]["kernels_ms"] = passes
        for r_mm in (r for r in MM_RANKS[kind] if r != 8):
            er, sr, (msr, pmsr, _, _, _, _), (bmsr, byr), libr, pr = \
                mm[(kind, r_mm)]
            forms[kind][f"r{r_mm}"] = {
                "max_abs_err": er, "share_of_order_bound": sr, "ms": msr,
                "plain_ms": pmsr, "bound_ms": bmsr, "bound_by": byr,
                "library_ms": libr}
            if pr:
                forms[kind][f"r{r_mm}"]["kernels_ms"] = pr
    total = {k: sum(f[k] for f in forms.values())
             for k in ("ms", "plain_ms", "bound_ms", "library_ms")}
    kernels.append({
        "name": "lowrank_matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/lowrank.cu",
        "replaces": "src/repro/kernels/lowrank.py:103",
        "launches": sum(f["launches"] for f in forms.values()),
        "phase9": {run: {k: v for k, v in r["launches"].items()
                         if k.startswith("matmul_")}
                   for run, r in hier.items()},
        "phase10": {k: v for k, v in tune["launches"].items()
                    if k.startswith("matmul_")},
        "phase11": {run: {k: v for k, v in r["launches"].items()
                          if k.startswith("matmul_")}
                    for run, r in cp.items()},
        "phase12": {},            # plr rides no serving path
        "phase13": {},            # nor the ZeRO-3 step (zhybrid_16_8)
        "phase14": {},            # nor the MoE runs (zhybrid_16_8)
        "phase15": {},            # nor the recurrent runs (zhybrid_16_8)
        "phase16": {},            # nor whisper's (zhybrid_16_8)
        "phase17": {},            # nor the pod runs (zhybrid_16_8)
        "phase18": {},            # nor phase 18's (zhybrid_16_8)
        "max_abs_err": max(f["max_abs_err"] for f in forms.values()),
        **total, "bound_by": "bytes" if all(
            f["bound_by"] == "bytes" for f in forms.values()) else
        "operations",
        "l2": "flushed before each call",
        "path": "dp@zero1_grad plr8 exchange (one of each form)", "rate": 8,
        "shape": f"{mm_rows}x{mm_width}, r=8", "forms": forms,
        "orthonormalize_eager_ms": gs})
    names = list(starts)
    print("wall seconds per phase: " + ", ".join(
        f"{a} {starts[b] - starts[a]:.1f}" for a, b in zip(names, names[1:]))
        + f" [{card}]")
    for entry in kernels:
        # the timer of the "kernel alone" times (kernel_ms)
        entry["kernel_alone_by"] = KERNEL_TIMER["by"]
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def reckon_main(path: str) -> None:
    """``--reckon FILE``: time the (kernel, rows, rate, launches) of FILE
    (phase 4's launch shapes) in this fresh process; write the result
    beside it."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import bq

    bq._load()
    shapes = {(n, r, b): c for n, r, b, c in json.loads(Path(path)
                                                        .read_text())}
    out = reckon_shapes(torch, card_line(), shapes, DP * TP * STEPS)
    Path(path).with_suffix(".out.json").write_text(json.dumps(out))


if __name__ == "__main__":
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    if sys.argv[1:2] == ["--reckon"]:
        reckon_main(sys.argv[2])
    elif sys.argv[1:2] == ["--dryrun"]:
        dryrun_main(sys.argv[2])
    else:
        main()
