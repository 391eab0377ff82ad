#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (paddle_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure ends the run with a non-zero exit code and
no result line:

1. require a CUDA device; print the card's name and power limit;
2. build the CUDA kernels from the sources in paddle_tpu_torch/csrc, one
   nvcc per source, all at once;
3. hold each kernel against its plain PyTorch version at the main paths'
   shapes (the flash kernels at B 1 for each prefill bucket, at B 4,
   S 256 for the one-shot engine's batch and at B 8, S 1024 for a
   training step), and time the kernel, the plain version,
   PyTorch's scaled_dot_product_attention forward (flash forward) and
   its backward less its forward (flash backward), beside each kernel's
   bound; the paged decode kernel also two calls bit for bit, over six
   distinct pool pairs in turn (as the decode step's layers read them),
   with its device ms and CUDA launches a call (torch.profiler), host us
   a call and TB/s; then the three conv-epilogue kernels (channel
   stats, apply, apply with an addend) at every epilogue shape of
   ResNet-50 at batch 128, taken from the fused training program, each
   timed beside its plain version, its bound and a PyTorch yardstick
   (torch.var_mean for the stats, F.batch_norm in training mode for
   stats + apply), with its device ms a launch and launches a call
   (torch.profiler) and its host us a call (200 calls queued with no
   sync) beside the event time, and two stats calls on one input held
   to the same bits;
4. serve the Transformer LM at full width (vocab 32000, 6 layers,
   d_model 2048, 8 heads, d_ff 8192, context 1024, 8 slots, 16-token
   blocks, random weights from --seed) through DecodeEngine, whose
   prefill runs the bundle's transformer_lm programs (one a length
   bucket) and whose decode step runs the bundle's
   transformer_decode_step program: 12 requests, launch counts read
   around the run (the paged kernel once a layer a step), the prefill ms per
   bucket, then a teacher-forced check of two requests (decode-step
   logits against the prefill program's, within LOGIT_TOL), then device
   time by kernel (torch.profiler) for one prefill per bucket and for
   decode steps;
5. train the same model at full width (batch 8, sequence 1024, Adam at
   lr 1e-4, float32) through Program / program_guard / Executor: startup,
   one warm-up step and TRAIN_STEPS timed steps on the bench's pool-probe
   feeds, launch counts read around them, finite and falling losses,
   then device time by kernel for one step; then the trained weights
   loaded into the serving module (TransformerLM) give the logits of an
   inference program built by the same builder;
6. take two Adam steps of one reduced program (2 layers, d_model 256,
   2 heads, sequence 128, batch 2) from one startup state on the card and
   on the CPU, and hold losses, state and each update together;
7. train ResNet-50 at full width (224 px, 1000 classes, batch 128,
   Momentum at lr 0.005, float32, bench.py bench_resnet's feeds) through
   resnet.get_model and the Executor, whose fusion pass makes 17
   fused_conv2d ops: startup, one warm-up step and RESNET_STEPS timed
   steps on one feed, launch counts read around them and held to the
   fused program's epilogue counts, finite and falling losses, peak
   memory, images/s and device time by class for one step; then the
   inference clone (every BN folded into its conv) gives finite
   predictions;
8. take two Momentum steps of ResNet-50 at 64 px, 102 classes, batch 4
   from one startup state on the card and on the CPU, and hold losses,
   state and each update together;
9. train the stacked dynamic LSTM at full width (vocab 30000, embedding
   512, hidden 512, 2 classes, batch 64, sequence 100, Adam at lr 1e-3,
   float32, bench.py bench_lstm's varied feeds) through
   stacked_dynamic_lstm.get_model(use_fused=True) and the Executor:
   startup, one warm-up step and LSTM_STEPS timed steps on one repeated
   feed (finite, falling losses), LSTM_STEPS steps on the next varied
   feeds, one ragged step (padded ids with explicit lengths), launch
   counts held to one forward and one backward call a step, peak memory,
   tokens/s and device time by class for one step, the backward's by its
   kernels (recurrence, gates' recompute, dW, the rest; the recurrence
   must show); then the inference clone gives finite predictions;
10. take two Adam steps of a reduced LSTM (vocab 1000, embedding 64,
   hidden 128, batch 8, ragged sequences up to 24) from one startup
   state on the card and on the CPU, and hold losses, state and each
   update together;
11. run ResNet-50's training-mode forward (the training program pruned
   to its loss and accuracy, data and label fed, batch 128, 224 px) from
   one startup state through the composition and with
   PT_FUSED_BLOCK=always, which sends the 10 rest blocks the gate takes
   through the bottleneck chain's kernels: hold the loss and the twelve
   stat outputs of every rest block together (beside what a PERTURB
   change of the images does to the composition), time a warm-up and
   CHAIN_FORWARDS forwards of each, profile one of each by kernel class,
   and hold the chain kernels' launch counts to 10 a forward;
12. train ResNet-50 at full width (phase 7's program, feed and startup
   state) through the composition and with PT_FUSED_BLOCK=always, which
   sends the 10 rest blocks the gate takes through the chain's four
   forward and four backward kernels: one Momentum step of each from the
   startup state, the losses within LOSS_RTOL and every var's update
   (parameters, velocities, running stats) held to SPREAD times what a
   PERTURB change of the images does to the composition's step (as phase
   8 holds the card to the CPU); then a warm-up and RESNET_STEPS timed
   steps of each in turns (finite, falling losses through the chain),
   peak memory, a profiled step of each by kernel class, the host time
   of the fused_bottleneck ops' forwards and of the chain's backwards,
   and the eight chain kernels' launch counts held to 10 a step;
13. serve phase 4's model through the one-shot ServingEngine: (a)
   io.export_serving_model of transformer_lm's inference program at
   src_ids [256] (pos_table_len 1024, batch 4, the logits fetched) and
   a phase-4 decode bundle, exported once for phases 13 and 14, the
   artifact loaded by ServingEngine(max_wait_ms=5,
   queue_depth=64).load_model;
   (b) a burst of 16 requests, each held to load_serving_model's run of
   it alone in row 0 of a batch (KERNEL_ATOL / KERNEL_RTOL, and whether
   the bits are the same) and to that run with the attention op on the
   flash kernel's plain version (mha_reference, the same limits), the
   flash forward's launches held to 6 a
   batch, requests/s, batch fill, p50 / p99 of every phase, the same
   16 served one at a time, and device time by kernel class for one
   batch (torch.profiler); (c) a second burst with a hot reload from
   another thread in the middle: no request fails or is dropped, version
   2; (d) load_decode_model of a phase-4 bundle, 2 generate requests of
   16 tokens (the paged kernel launched), one streamed :generate over
   start_http_server(engine, port=0) with the facade's tokens; (e)
   GET /v1/models lists both models, a bad feed to :predict is 400
   InvalidRequest, /metrics?format=prometheus passes validate_exposition
   with pt_serve_* and pt_decode_* series;
14. serve the same artifact and bundle through the fleet tier: (a)
   make_fleet with 2 replicas, each a ServingEngine on the card holding
   both (engine queue bound FLEET_ENGINE_QUEUE); (b) a burst of
   FLEET_REQUESTS one-shot requests in FLEET_CLASSES priority classes
   (requests/s on 2 replicas) and FLEET_GENERATE generations in
   FLEET_SESSIONS sessions, each session on its replica (the decode
   engines' received counts); (c) one injected router_dispatch crash:
   one failover, the replica rebuilt, nothing failed; (d) scale 2 -> 3
   -> 1 while a client keeps requests in flight, none dropped, then the
   first burst again on 1 replica (requests/s, the same bits); (e) a
   router with a queue bound of FLEET_SMALL_QUEUE over the same pool,
   overloaded: every shed typed Overloaded with its class, the lowest
   class shed most; (f) an Autoscaler ticked by hand: up on the
   replica's queue depth, down after its idle window; (g) GET
   /v1/fleet over HTTP and a pt_fleet_* scrape through
   validate_exposition; then the phase's launches and peak memory, and
   every held answer against one ServingEngine's (the same bits), the
   generations against its DecodeEngine's tokens and, through it, the
   attention op on mha_reference (phase 13's limits);
15. train phase 5's model through the Trainer with the step's contract:
   Adam at noam_decay(d_model, warmup_steps=TRAINER_WARMUP) scaled to
   peak at TRAIN["lr"], GradientClipByGlobalNorm(1.0), L2Decay(1e-4),
   PT_GUARD=skip, a reader of TRAINER_STEPS lm_probe_feeds batches with
   log_every TRAINER_LOG_EVERY (lazy metrics between), checkpoints every
   TRAINER_INTERVAL steps (max_num_checkpoints 1) into a temporary dir:
   (a) the uninterrupted run: the losses (finite, the last below the
   first), ms a step between two read boundaries, peak memory, the
   checkpoint's size, each save's seconds and one verification's (the
   step-6 serial is kept by hard links when it is written); (b) a new
   Trainer over that dir holding the step-6 serial resumes at step 7:
   its losses of steps 7-12 within TRAINER_RTOL of (a)'s, its final
   state within TRAINER_RTOL of (a)'s (largest difference printed, and
   whether the bits are the same); (c) one more guarded step with
   PT_FAULT_INJECT=nan_grad@1: the health flag false and every
   persistable var, the step counter included, bit-identical; (d) the
   three flash kernels launched n_layers times a step over (a)-(c);
   then launches and device ms by class of one step of phase 5's
   program, of the Trainer's program unguarded and guarded (the clip,
   decay and schedule's cost, and the guard's);
16. train phase 5's model with main.amp_dtype = "bfloat16" (float32
   masters, bf16 compute) through the Executor: startup, one warm-up step
   and TRAIN_STEPS timed steps on phase 5's feeds, launch counts read
   around them (n_layers of each bf16 flash kernel a step, no float32
   flash launch), finite and falling losses, every master still float32,
   ms a step, tokens/s, peak memory, one step's launches and device ms by
   class, the same program's float32 step timed in this run, and the
   inference clone's logits finite; then the reduced program of phase 6
   under AMP, two Adam steps on the card and on the CPU from one startup
   state: losses, first-step float32 gradients and masters held to the
   AMP limits (AMP_LOSS_RTOL, AMP_GRAD_RTOL, AMP_STEP_ATOL);
17. train phase 9's stacked LSTM with main.amp_dtype = "bfloat16" (float32
   masters, bf16 compute) through the Executor: startup, one warm-up step
   and LSTM_STEPS timed steps on phase 9's repeated feed (finite, falling
   losses), LSTM_STEPS steps on the next varied feeds, the bf16 LSTM
   kernels' launches held to one forward and one backward call a step and
   the float32 LSTM kernels' to none, every master still float32, peak
   memory, tokens/s, one step's device time by class (the bf16 backward
   by its three kernels; the recurrence must show), and phase 9's float32
   step of the same program timed in this run;
18. take two Adam steps of phase 10's reduced LSTM under AMP from one
   startup state on the card and on the CPU: losses within
   AMP_LOSS_RTOL, masters within LSTM_AMP_STEP_ATOL (5 lr), each
   parameter's update within AMP_UPDATE_RTOL (rms);
19. train ResNet-50 in bf16 at full width: the bench's bf16 program
   (resnet.get_model(dtype="bfloat16"): a bf16 data var, float32
   masters; bench.py bench_resnet's TPU arm) through the Executor, on
   phase 7's float32 feed, which the Executor casts to the data var's
   dtype: startup, one warm-up step and RESNET_STEPS timed steps, the
   bf16 epilogue kernels' launches held to the fused program's 17 / 13 /
   4 a step and the float32 ones' to none, finite and falling losses,
   every parameter, velocity and running stat still float32, images/s,
   peak memory, one step's launches and device time by class, the
   inference clone's predictions finite; then phase 7's float32 program
   timed in this run, and the same program under amp_dtype "bfloat16"
   (a warm-up and RESNET_STEPS steps, the same launch counts and float32
   state, ms a step);
20. take two Momentum steps of ResNet-50 cut to one bottleneck block a
   stage (full width, phase 8's 64 px, 102 classes, batch 4) as a bf16
   program from one startup state on the card and on the CPU, and as a
   float32 program on the CPU: the step-0 loss within AMP_LOSS_RTOL, the
   first-step gradients, the updates after two steps and the running
   stats within BF16_SPREAD times what float32 reads against bf16 on the
   CPU, each limit under BF16_CEILING, and every master float32;
21. run the bench's bf16 program (build_resnet50_bf16) pruned to its loss
   and accuracy, its training-mode forward at full width (batch 128,
   224 px) from one startup state, through the composition and with
   PT_FUSED_BLOCK=always, whose gate takes the 10 rest blocks at 56²,
   28² and 14² through the four bf16 chain kernels: each bf16 chain
   kernel launched 10 times a forward and no float32 chain kernel; the
   float32 program (phase 7's) composed from the same state (the bf16
   program's float32 masters loaded by position) is the reference: the
   chain's loss within AMP_LOSS_RTOL of it (relative, as phase 20 holds
   its step-0 loss: one number is a sample of bf16's noise); the bf16
   composition's distance from it (the 128 per-image losses' relative
   rms; the 120 stat outputs' largest and median relative rms, running
   stats as their updates) is the reading, the chain's distance within
   BF16_SPREAD times it, each limit under BF16_CEILING; a warm-up and
   CHAIN_FORWARDS forwards of each in turns (ms, images/s), the peak
   memory of one forward of each and one profiled forward of each by
   kernel class;
22. hold one Momentum step at each of the chain's three stages
   (build_chain_stage: the stage's block input as a bf16 data var at
   batch 128, two rest blocks at full width, global pooling, an fc to
   1000 classes, softmax cross-entropy, Momentum) from one startup
   state, through the chain (PT_FUSED_BLOCK=always: the eight bf16 chain
   kernels forward and backward) against the same bf16 program composed
   and the float32 program composed: the chain's loss within
   AMP_LOSS_RTOL of float32's; its updates of the parameters and
   velocities, and of the running stats (largest and median relative rms
   over the vars), within BF16_SPREAD times the bf16 composition's
   distance from float32, each limit under BF16_CEILING; the same step
   with bwd_mid's tap gradients zeroed must fail those limits; each bf16
   chain kernel launched twice a chain step and no float32 chain kernel.
   Then train the bench's bf16 program (build_resnet50_bf16) at full
   width (batch 128, 224 px, Momentum at lr 0.005, phase 7's feed centred
   at 0.5),
   composed and through the chain, whose gate sends its 10 rest blocks
   through the eight bf16 chain kernels: the chain's step-0 loss within
   AMP_LOSS_RTOL of phase 7's float32 program's from the same masters; a
   warm-up and RESNET_STEPS steps of each in turns (ms a step, images/s,
   peak memory, the chain's losses finite and falling, every master
   float32), one profiled step of each by kernel class, and phase 7's
   float32 program under amp_dtype "bfloat16" through the chain (a
   warm-up and RESNET_STEPS steps); each bf16 chain kernel launched 10
   times a step and no float32 chain kernel;
23. serve phase 4's model in bf16 at full width: transformer_decode_step
   built at its configuration, phase 4's weights in a Scope cast to bf16
   by Float16Transpiler (the Scope's memory after the cast, and its
   peak), resident bf16 pools seeded from the float32 bundle's prefill
   K/V of 8 prompts (3 to 900 tokens), BF16_DECODE_STEPS greedy steps
   through Executor.run with return_numpy=False: 6 launches of the bf16
   paged kernel a step and none of the float32 one, the pools written in
   place, finite logits, each step's logits against the float32 step
   program's on the same tokens and pools within BF16_DECODE_RTOL and a
   step whose pool write is skipped failing it; then ms a step and peak
   memory of the bf16 and the float32 programs in turns, and one
   profiled step of each;
24. print the kernels' JSON line, the card line and the result line.

Phase 3 also holds the bf16 paged decode kernel (csrc/paged_attention.cu's
bf16 instance) against its plain version on the same bf16 inputs at the
paged shape, over the six pool pairs in turn, within BF16_REL
max|plain| + BF16_REL |plain| with the share of values whose bits
differ, two calls the same bits, timed beside its bound (bf16 bytes),
its plain version and the float32 kernel, with device ms and launches a
call, host us a call and TB/s.
Phase 3 also holds the three bf16 flash kernels (forward, dQ, dK/dV;
csrc/flash_attention_bf16.cu) against their plain versions at
FLASH_BF16_SHAPES (H 8, D 256, causal; the AMP training step's B 8, S
1024 among them), printing each output's largest share of its limit,
each timed beside its plain version, its bound at the bf16 tensor
cores' rate and SDPA in bf16 (its forward; its backward alone, its
device time over a graph built once, beside dQ and dK/dV). All three
run on wgmma, fed by TMA through mbarrier rings in warp-specialised
blocks (csrc/sm90.cuh).
Phase 3 also holds the three bf16 conv-epilogue kernels (stats, apply,
apply with an addend; csrc/fused_conv.cu's bf16 instances) against their
plain versions at the same nine shapes on bf16 inputs: y bit for bit
(its share of BF16_REL max|plain| + BF16_REL |plain| printed), the
float32 sums within the float32 kernel's limits,
two stats calls the same bits; each timed beside its plain version, its
bound over bf16 bytes, torch.var_mean and F.batch_norm in bf16, with
device ms a launch, launches a call and host us a call.
Phase 3 also holds the two LSTM kernels against their plain versions at
the bench shape (T 100, B 64, H 512), full-length and ragged, timed
beside their bounds (3xTF32, with the f32 FMA bounds beside them) and
torch.nn.LSTM (cuDNN) as the yardstick, with each one's CUDA launches a
call (profiler) and the plan it took; then their bf16 versions
(csrc/fused_lstm_bf16.cu) at the same shapes, rs, cs and dx within
BF16_REL max|plain| + BF16_REL |plain| and dw, db, dr0, dc0 within
LSTM_SUM_REL max|plain| + LSTM_SUM_REL |plain| of the plain versions on
the same bf16 inputs, each timed beside its plain version, its bound at
the bf16 tensor cores' rate and torch.nn.LSTM in bf16 (cuDNN; its
forward, and its backward less its forward).
Phase 3 also holds the four bf16 bottleneck-chain kernels
(csrc/fused_block_bf16.cu) against their plain versions at the three
chain stages at batch 128, on bf16 inputs made as the chain makes them:
y and out within BF16_REL max|plain| + BF16_REL |plain| with the share
of elements that differ printed, the float32 sums within STATS_RTOL of
their terms' magnitudes plus what the y that round to the neighbouring
bf16 value move, Σh and M2 within STATS_RTOL, two calls the same bits;
each timed beside its plain version, its bound at the bf16 tensor
cores' rate and a bf16 PyTorch yardstick (F.conv2d of the same product;
torch.bmm of h·hᵀ and the sum), with its registers and spills from the
build's ptxas report; then the chain's four bf16 backward kernels (the
same source) at the same stages on the inputs the bf16 chain makes: g3
bit for bit, g2, g1 and dx within BF16_REL max|plain| + BF16_REL |plain|
with the share that differs printed, the sums of g2 and g1 within
STATS_RTOL of their terms plus what the flipped values move, P, Σg3,
dtaps and dW1 within STATS_RTOL of their terms, two calls the same bits;
each timed beside its plain version, its bound at the bf16 tensor cores'
rate and a bf16 PyTorch yardstick (torch.bmm + sum; torch.matmul;
cuDNN's conv2d_input + conv2d_weight; matmul + bmm + sum), with its
registers and spills.
Phase 3 also holds the four bottleneck-chain kernels against their
plain versions at ResNet-50's three chain stages at batch 128 (Cin, C,
H = 256, 64, 56 / 512, 128, 28 / 1024, 256, 14), each timed beside its
plain version, its bound and a PyTorch yardstick (F.conv2d of the same
product, product only, for the three convolutions; torch.bmm of h·hᵀ
and the sum for the moments); all four, whose products run in 3xTF32
on the tensor cores, are bounded by that arithmetic (their float32 FMA
bounds printed beside them) and print the largest shares of their
limits;
then the chain's four backward kernels at
the same stages, on the inputs the chain makes (the forward, a random
cotangent, each kernel fed by its plain predecessors), each timed
beside its plain version, its bound and the same products on
materialized operands (torch.matmul / bmm; cuDNN's dgrad + wgrad for
the 3x3); bwd_mid and bwd_final, whose two products run in 3xTF32 on
the tensor cores, are bounded by that arithmetic (their float32 FMA
bounds printed beside them), and their launches' device times print
apart (bwd_mid: the fold of da2, the input gradient, the tap gradients,
the fixed-order sums; bwd_final: dx with the fold of da1, dW1, the
fixed-order sum of its splits). The flash forward, whose two products
run in 3xTF32 on the tensor cores, is bounded by that arithmetic too
(its float32 FMA bound printed beside it), and prints the largest shares
of its limit for O and lse and its TF32 rate at each shape; so does the
flash backward's dQ kernel, whose three products run in 3xTF32 too (its
largest share of the 1e-4 limit, its TF32 rate, its 3xTF32 bound with
the float32 FMA bound beside it).

cudnn.benchmark stays at its default (off); TF32 is off for products
and convolutions; bf16 products reduce in float32
(allow_bf16_reduced_precision_reduction off).
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM3 bytes/s, float32 flop/s
# outside the tensor cores, dense TF32 and bf16 flop/s of the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 495e12
BF16_FLOPS_PER_S = 989e12

# kernel vs plain version, both float32 on the card with TF32 off: the
# sums run in another order (tiles, pages, cuBLAS), about 1e-6 apart
KERNEL_ATOL = KERNEL_RTOL = 1e-5
# the backward kernels: each dK/dV entry sums up to 1024 products of p or
# dS and a row of dO or Q, in another order than the plain version
BWD_ATOL = BWD_RTOL = 1e-4
# card vs CPU, the same program from one state, two Adam steps: losses
# within the CPU parity tests' rtol; every state element within
# PARAM_ATOL (4.4e-7 measured on the H100); each parameter's update and
# each accumulator within STATE_RTOL of the CPU's, as rms, as
# tests/test_torch_executor.py holds the port to the JAX package (but for
# the key biases: their gradient is zero in exact arithmetic, so their
# updates and moments are rounding noise, held by PARAM_ATOL alone)
LOSS_RTOL, PARAM_ATOL, STATE_RTOL = 1e-4, 1e-5, 1e-3
# the Program path and the serving module at full width, the same ops on
# the same card
MODULE_ATOL = MODULE_RTOL = 1e-5
# decode path vs prefill path on the same tokens: f32 through every layer
# at width 2048, with GEMV-shaped vs GEMM-shaped products and paged vs
# flash attention sums, so the logits differ by more than one kernel does
LOGIT_TOL = 1e-3

MODEL = dict(vocab_size=32000, n_layers=6, d_model=2048, n_heads=8,
             d_ff=8192, max_context=1024)
BUCKETS = (128, 256, 512, 1024)
SLOTS, BLOCK, POOL_BLOCKS = 8, 16, 513
N_REQUESTS, MAX_NEW = 12, 32
# the one-shot engine (phase 13): MODEL's inference program at src_ids
# [SERVE_SEQ] with pos_table_len max_context, BATCH requests a batch,
# bursts of SERVE_REQUESTS requests; the decode facade's generations
SERVE_SEQ, SERVE_BATCH, SERVE_REQUESTS, SERVE_NEW = 256, 4, 16, 16
SERVE_PROMPTS = (200, 77)
# the fleet (phase 14): make_fleet over replicas of phase 13's artifact and
# bundle, engines with a queue bound of FLEET_ENGINE_QUEUE; bursts of
# FLEET_REQUESTS one-shot requests in FLEET_CLASSES priority classes,
# FLEET_GENERATE generations of FLEET_NEW tokens in FLEET_SESSIONS
# sessions; FLEET_OVERLOAD requests at a router queue bound of
# FLEET_SMALL_QUEUE
FLEET_REQUESTS, FLEET_CLASSES, FLEET_QUEUE, FLEET_ENGINE_QUEUE = 32, 3, 64, 8
FLEET_GENERATE, FLEET_SESSIONS, FLEET_NEW = 8, 4, 8
FLEET_OVERLOAD, FLEET_SMALL_QUEUE = 40, 4
# bench.py bench_transformer's TPU arm (bench.py:822-833)
TRAIN = dict(batch=8, seq_len=1024, lr=1e-4)
TRAIN_STEPS = 6
LM_PROBE_POOL = 64
# the Trainer (phase 15): steps over a reader of that many batches, the
# checkpoint interval, the read interval of the lazy metrics, noam's
# warm-up; a resumed run's losses and state against the uninterrupted
# run's, the same steps on the same card from the same checkpoint
TRAINER_STEPS, TRAINER_INTERVAL, TRAINER_LOG_EVERY = 12, 6, 4
TRAINER_WARMUP = 8
TRAINER_RTOL = 1e-5
# the flash kernels' checks, (batch, sequence) at H 8, D 256, causal: the
# prefill buckets' batch 1 (and a ragged length), the one-shot engine's
# batch (phase 13) and a training step; the kernels line reports the
# training shape
FLASH_SHAPES = ((1, 128), (1, 256), (1, 512), (1, 1024), (1, 333),
                (4, SERVE_SEQ), (8, 1024))
LINE_SHAPE = (8, 1024)
REDUCED = dict(vocab_size=32000, n_layers=2, d_model=256, n_heads=2,
               d_ff=1024, seq_len=128, batch=2)
# the bf16 flash kernels (phase 3), (batch, sequence) at H 8, D 256,
# causal: a short and a ragged prefill, the longest, and the AMP training
# step (LINE_SHAPE, which the kernels line reports). bf16's unit roundoff
# is 2^-8: O, dQ, dK and dV within BF16_REL max|plain| + BF16_REL |plain|
# of the plain version (each output's own rounding is up to 2^-8 |plain|,
# and the kernels round P and dS to bf16 before their products, where the
# plain versions keep them float32); lse, float32 in both, within
# atol = rtol = LSE_TOL
FLASH_BF16_SHAPES = ((1, 128), (1, 333), (1, 1024), (8, 1024))
BF16_REL, LSE_TOL = 2.0 ** -7, 1e-4
# bf16 decode (phase 23): phase 4's model as a transpiled step program
# (Float16Transpiler) over resident bf16 pools seeded from the float32
# bundle's prefill of prompts of these lengths (short ones, where one
# missing key row moves the output, beside long ones), BF16_DECODE_STEPS
# greedy steps; each teacher-forced step's logits against the float32
# program's on the same tokens and pools, as the relative rms over the
# vocabulary of each slot (rms of the difference over rms of the float32
# logits), the largest over slots and steps within BF16_DECODE_RTOL. The
# JAX package's own bf16 step sits 8.3e-3 from its float32 one at the
# CPU tests' width (tests/test_torch_decode_program.py); the limit leaves
# room for a wider, deeper model, and a step whose pool write is skipped
# must read above it.
BF16_DECODE_PROMPTS = (3, 9, 17, 40, 130, 333, 640, 900)
BF16_DECODE_STEPS = 8
BF16_DECODE_RTOL = 0.05
BF16_DECODE_TIMED = 10
# mixed precision (phase 16), card vs CPU, tests/test_torch_amp.py's
# limits (bf16 rounds at other places on the card, in the bf16 flash
# kernels and cuBLAS, than on the CPU): losses within AMP_LOSS_RTOL; the
# first step's float32 gradients within AMP_GRAD_RTOL as rms (the key
# biases, zero in exact arithmetic, apart); every master element within
# AMP_STEP_ATOL after two Adam steps, which move an element by about lr
# each, and by up to 2 lr apart where bf16's noise flips the sign of a
# near-zero gradient
AMP_LOSS_RTOL, AMP_GRAD_RTOL = 1e-2, 5e-2
AMP_STEP_ATOL = 5 * TRAIN["lr"]
# ... and each parameter's update (the two steps' sum) within
# AMP_UPDATE_RTOL as rms: Adam's first steps are about lr sign(g), so the
# sign flips of near-zero gradients dominate the difference (0.090 in
# PR 27's first chip run; the two packages on the CPU, the same
# program: up to 0.14)
AMP_UPDATE_RTOL = 0.25
# the conv-epilogue kernels vs their plain versions, float32 on the card:
# apply is one fma and at most one add per element; the stats kernel's
# sums of up to 1.6 M elements run in another order than the plain
# version's: the sum of squares within STATS_RTOL of the plain one, the
# sum (which can sit near zero) within STATS_RTOL * sum(|a|), and the
# derived variance within STATS_RTOL * E[a^2] (E[a^2] - mean^2 cancels)
EPI_ATOL = EPI_RTOL = 1e-5
STATS_RTOL = 1e-5
# bench.py bench_resnet's TPU arm (bench.py:411-456), in float32
RESNET = dict(data_set="imagenet", depth=50, batch=128, image=224, lr=0.005)
RESNET_STEPS = 6
# card vs CPU: ResNet-50 at 64 px, flowers' 102 classes, batch 4. The
# model is chaotic at init: its first-step gradients move by about as
# much (a few % median relative rms) between the card and the CPU as on
# the CPU alone when the images move by PERTURB (phase 8 prints both);
# the card may differ from the CPU by SPREAD times what that
# perturbation does, and need not come closer than the LM's limits
# (LOSS_RTOL, PARAM_ATOL, STATE_RTOL)
RESNET_REDUCED = dict(image=64, class_dim=102, batch=4)
PERTURB, SPREAD = 3e-7, 3.0
# card vs CPU in bf16 (phase 20): ResNet-50's stem and four stages at
# full width, cut to one bottleneck block a stage, at RESNET_REDUCED's
# shape. At full depth bf16 ResNet-50 is chaotic at init: one bf16 step
# on one pixel in 64 moves its first-step gradients by more than the 1.0
# (relative rms) of a step that computes nothing, so no limit there could
# fail (scripts/resnet_bf16_spread_cpu.py). Cut to a block a stage, the
# CPU's float32 run reads about 0.33 against its bf16 run. The card's
# bf16 run and the CPU's each sit about that far from float32, so they
# may sit BF16_SPREAD times as far apart; a limit at BF16_CEILING or
# above fails the phase, as it could not tell a step that updates
# nothing (1.0) or sees half the batch (about 1.45) from a right one
RESNET_BF16_BLOCKS = (1, 1, 1, 1)
BF16_SPREAD, BF16_CEILING = 2.0, 0.8
# phase 22 holds a bf16 training step through the chain on three
# programs, one a stage of CHAIN_SHAPES: the stage's block input as a
# bf16 data var at RESNET's batch, CHAIN_STAGE_BLOCKS rest blocks at
# full width, global pooling, an fc to 1000 classes, softmax
# cross-entropy and Momentum at RESNET's lr. A deeper program does not
# do: at init the first step's updates grow more sensitive to their
# inputs at every batch norm the gradient passes back through. bf16's
# own updates of ResNet-50 cut to (2, 2, 2, 1) blocks (224 px, batch 8,
# on the CPU) sit 0.93 (largest relative rms over the vars) and 0.58
# (median) from float32's, at full depth on an H100 1.42 and 1.26: as
# far as a step that drops a filter's gradient (1.0). The stage programs
# read about 0.19 and 0.14 (scripts/resnet_bf16_spread_cpu.py
# --chain-step)
CHAIN_STAGE_BLOCKS = 2
# bench.py bench_lstm's TPU arm (bench.py:611-663), in float32
LSTM = dict(dict_size=30000, emb_dim=512, lstm_size=512, batch=64,
            seq_len=100)
LSTM_STEPS = 6
# card vs CPU: a reduced LSTM on ragged sequences, at the LM's limits
LSTM_REDUCED = dict(dict_size=1000, emb_dim=64, lstm_size=128, batch=8,
                    seq_len=24)
# the bf16 LSTM kernels (phase 3) against their plain versions on the same
# bf16 inputs: rs, cs and dx within BF16_REL max|plain| + BF16_REL |plain|
# (kernel and plain version sum in other orders, so a carry or a dgates
# element can round to the neighbouring bf16 value, and that travels
# through the later steps: scripts/lstm_bf16_arith.py), their float32
# sums dw, db, dr0 and dc0 within LSTM_SUM_REL max|plain| + LSTM_SUM_REL
# |plain|; phase 18 holds the AMP LSTM's masters within 5 lr of the CPU's
# (Adam at lr 1e-3: get_model's)
LSTM_SUM_REL = 2.0 ** -9
LSTM_AMP_STEP_ATOL = 5 * 1e-3
# the bottleneck chain's stages in ResNet-50 (Cin, C, H) at RESNET's
# batch; the kernels line reports the first. Outputs within KERNEL_ATOL /
# KERNEL_RTOL of the plain versions, sums within STATS_RTOL of the sum of
# their terms' magnitudes (M2 and the sum of h, whose terms are >= 0,
# within STATS_RTOL of themselves)
CHAIN_SHAPES = ((256, 64, 56), (512, 128, 28), (1024, 256, 14))
CHAIN_KERNELS = ("conv1x1_stats", "conv3x3_norm_stats", "norm_relu_moments",
                 "conv1x1_bn_residual")
CHAIN_BLOCKS = 10       # rest blocks of ResNet-50 that the chain's gate takes
CHAIN_FORWARDS = 6
# the chain's backward kernels, in the order bottleneck_rest_bwd calls
# them: g3 bitwise, the other elementwise outputs (sums of at most 9C or
# Cin + C products) within BWD_ATOL / BWD_RTOL of the plain versions,
# the sums over N·S within STATS_RTOL of the sum of their terms'
# magnitudes
CHAIN_BWD_KERNELS = ("bwd_reduce3", "bwd_apply3", "bwd_mid", "bwd_final")
# the chain's bf16 forward kernels (phase 3) against their plain versions
# on bf16 inputs made as the chain makes them, at CHAIN_SHAPES: y within
# BF16_REL max|plain| + BF16_REL |plain| (the kernels sum K in another
# order, so a y can round to the neighbouring bf16 value); the float32
# sums within STATS_RTOL of their terms' magnitudes plus what those flips
# move (the sum of |y - plain y| for Σy, of |y² - plain y²| for Σy²):
# scripts/emulate_fused_block_bf16_cpu.py shows the flips alone taking a
# sum to 25 times the float32 limit; Σh and M2 (of the same rounded h in
# both) within STATS_RTOL of themselves. Phase 21 runs them on the bench's
# bf16 program's training-mode forward, held to BF16_SPREAD times the bf16
# composition's distance from float32 (the loss to AMP_LOSS_RTOL)
CHAIN_BF16_KERNELS = tuple(k + "_bf16" for k in CHAIN_KERNELS)
# the chain's bf16 backward kernels (phase 3) against their plain versions
# on the inputs the bf16 chain makes, at CHAIN_SHAPES: g3 bit for bit; g2,
# g1 and dx within BF16_REL max|plain| + BF16_REL |plain|; the sums of g2
# and g1 within STATS_RTOL of their terms' magnitudes plus what the values
# that round to the neighbouring bf16 value move; P, Σg3 and dW1
# (products of the same bf16 operands) within STATS_RTOL of their terms,
# dtaps within STATS_RTOL of its terms from their float64 product.
# Phase 22 holds a step through all eight on programs of one stage
# (build_chain_stage), then trains the bench's bf16 program through them
CHAIN_BF16_BWD_KERNELS = tuple(k + "_bf16" for k in CHAIN_BWD_KERNELS)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, n: int) -> float:
    """Mean ms of one call over n back-to-back calls, by CUDA events."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def device_host(torch, fn, n: int = 20, queued: int = 200):
    """(device ms per call, kernel launches per call, host us per call):
    device time and launches from torch.profiler over n calls, host time
    by a host clock around `queued` calls queued with no sync between
    them (then one sync, outside the clock). Device ms and launches are
    None where five profiles in a row lost kernel events (held none, or
    a count that is not a multiple of n)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(5):
        # a profile that lost kernel events (none, or a count that is not
        # a multiple of n) is taken again
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
        if kernels and len(kernels) % n == 0:
            device = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / n
            launches = len(kernels) // n
            break
    else:
        device = launches = None
    t0 = time.perf_counter()
    for _ in range(queued):
        fn()
    host = (time.perf_counter() - t0) / queued * 1e6
    torch.cuda.synchronize()
    return device, launches, host


def graph_device_ms(torch, fn, n: int = 20, replays: int = 5):
    """Device ms a call of fn, from a CUDA graph of n calls replayed
    `replays` times between two events (no host time between the
    launches); None if fn cannot be captured. For wrappers whose launch
    needs no host sync (the epilogue kernels)."""
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()   # the stream's scratch exists before the capture
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            for _ in range(n):
                fn()
        graph.replay()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(replays):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / (replays * n)
    except RuntimeError:
        torch.cuda.synchronize()
        return None


def bound_ms(nbytes: float, flops: float, rate: float = F32_FLOPS_PER_S):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def max_err(torch, got, want, atol=KERNEL_ATOL, rtol=KERNEL_RTOL) -> float:
    """Largest |got - want|; raises if any element is outside the
    stated tolerance or not finite."""
    diff = (got - want).abs()
    if not bool(torch.isfinite(got).all()):
        raise RuntimeError("kernel output is not finite")
    if not bool((diff <= atol + rtol * want.abs()).all()):
        raise RuntimeError(f"kernel disagrees with its plain version: "
                           f"max abs err {float(diff.max()):.3e}")
    return float(diff.max())


def limit_share(torch, got, want, atol=KERNEL_ATOL,
                rtol=KERNEL_RTOL) -> float:
    """The largest |got - want| / (atol + rtol·|want|): 1 is the limit."""
    return float(((got - want).abs() / (atol + rtol * want.abs())).max())


def check_flash(torch, F, fa, card):
    """Flash forward vs its plain version at H=8, D=256, causal, at each
    of FLASH_SHAPES. Its two products run in 3xTF32 on the tensor cores:
    its bound is that arithmetic's (three TF32 products of 4·D flops a
    visible pair), printed beside the float32 FMA bound."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    row, errs, shares = None, [], []
    for b, s in FLASH_SHAPES:
        q, k, v = (torch.randn(b, s, 8, 256, device="cuda", generator=gen)
                   for _ in range(3))
        o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
        ro, rlse = fa.flash_attention_fwd_reference(q, k, v, causal=True)
        torch.cuda.synchronize()
        err = max(max_err(torch, o, ro), max_err(torch, lse, rlse))
        errs.append(err)
        share = (limit_share(torch, o, ro), limit_share(torch, lse, rlse))
        shares.append(share)
        pairs = b * s * (s + 1) // 2 * 8
        nbytes = 4 * b * (4 * s * 8 * 256 + 8 * s)
        flops = 4 * 256 * pairs
        b_ms, b_by = bound_ms(nbytes, 3 * flops, TF32_FLOPS_PER_S)
        f32_ms, f32_by = bound_ms(nbytes, flops)
        ms = cuda_ms(torch, lambda: fa.flash_attention_fwd(q, k, v,
                                                           causal=True), 20)
        plain = cuda_ms(torch, lambda: fa.flash_attention_fwd_reference(
            q, k, v, causal=True), 5)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), 20)
        print(f"flash_attention_fwd B={b} S={s}: max_abs_err {err:.3e} (tol "
              f"atol {KERNEL_ATOL} rtol {KERNEL_RTOL}; largest share of the "
              f"limit O {share[0]:.4f}, lse {share[1]:.4f}), kernel "
              f"{ms:.4f} ms ({3 * flops / ms / 1e9:.1f} TFLOP/s of TF32), "
              f"plain {plain:.4f} ms, sdpa {lib:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by}) by 3xTF32 at {TF32_FLOPS_PER_S / 1e12:.0f} TFLOP/s, "
              f"f32 FMA bound {f32_ms:.4f} ms ({f32_by}) [{card}]")
        if (b, s) == LINE_SHAPE:
            row = dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                       library_ms=lib)
    row["max_abs_err"] = max(errs)
    print(f"flash_attention_fwd: largest share of the 1e-5 limit over "
          f"FLASH_SHAPES, O {max(x[0] for x in shares):.4f}, lse "
          f"{max(x[1] for x in shares):.4f} [{card}]")
    return row


def check_flash_bwd(torch, F, fa, card):
    """The two backward kernels vs their plain versions at H=8, D=256,
    causal, at each of FLASH_SHAPES, from the plain forward's O and lse;
    SDPA's backward (autograd through it, less its forward) as the
    yardstick of the pair. Both kernels run their products in 3xTF32 on
    the tensor cores: each bound is that arithmetic's (three TF32 products
    of 6·D flops a visible pair for dQ, 8·D for dK/dV), printed beside the
    float32 FMA bound."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    rows, errs = {}, {"dq": [], "dkv": []}
    shares = {"dq": [], "dkv": []}
    for b, s in FLASH_SHAPES:
        q, k, v, do = (torch.randn(b, s, 8, 256, device="cuda",
                                   generator=gen) for _ in range(4))
        o, lse = fa.flash_attention_fwd_reference(q, k, v, causal=True)
        delta = fa.flash_attention_bwd_delta(o, do)
        args = (q, k, v, do, lse, delta)
        dq = fa.flash_attention_bwd_dq(*args, causal=True)
        dk, dv = fa.flash_attention_bwd_dkv(*args, causal=True)
        rq, rk, rv = fa.flash_attention_bwd_reference(q, k, v, o, lse, do,
                                                      causal=True)
        torch.cuda.synchronize()
        errs["dq"].append(max_err(torch, dq, rq, BWD_ATOL, BWD_RTOL))
        shares["dq"].append(limit_share(torch, dq, rq, BWD_ATOL, BWD_RTOL))
        errs["dkv"].append(max(max_err(torch, dk, rk, BWD_ATOL, BWD_RTOL),
                               max_err(torch, dv, rv, BWD_ATOL, BWD_RTOL)))
        shares["dkv"].append(max(
            limit_share(torch, dk, rk, BWD_ATOL, BWD_RTOL),
            limit_share(torch, dv, rv, BWD_ATOL, BWD_RTOL)))
        pairs = b * s * (s + 1) // 2 * 8
        in_bytes = 4 * b * (4 * s * 8 * 256 + 2 * 8 * s)
        out = 4 * b * s * 8 * 256
        flops = {"dq": 6 * 256 * pairs, "dkv": 8 * 256 * pairs}
        nbytes = {"dq": in_bytes + out, "dkv": in_bytes + 2 * out}
        bounds = {part: bound_ms(nbytes[part], 3 * flops[part],
                                 TF32_FLOPS_PER_S) for part in flops}
        f32 = {part: bound_ms(nbytes[part], flops[part]) for part in flops}
        pair = {"dq": (fa.flash_attention_bwd_dq,
                       fa.flash_attention_bwd_dq_reference),
                "dkv": (fa.flash_attention_bwd_dkv,
                        fa.flash_attention_bwd_dkv_reference)}
        ms = {part: cuda_ms(torch, lambda f=f: f(*args, causal=True), 20)
              for part, (f, _) in pair.items()}
        plain = {part: cuda_ms(torch, lambda r=r: r(*args, causal=True), 5)
                 for part, (_, r) in pair.items()}
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                      for x in (q, k, v))
        dot = do.transpose(1, 2)
        fwd = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), 20)
        both = cuda_ms(torch, lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
            (qt, kt, vt), dot), 20)
        lib = both - fwd
        total_bound = bound_ms(in_bytes + 3 * out, 14 * 256 * pairs)
        kern = "; ".join(
            f"{part} kernel {ms[part]:.4f} ms "
            f"({3 * flops[part] / ms[part] / 1e9:.1f} TFLOP/s of TF32; "
            f"plain {plain[part]:.4f}, bound {bounds[part][0]:.4f} "
            f"{bounds[part][1]} by 3xTF32 at "
            f"{TF32_FLOPS_PER_S / 1e12:.0f} TFLOP/s, f32 FMA bound "
            f"{f32[part][0]:.4f} {f32[part][1]})" for part in ("dq", "dkv"))
        print(f"flash_attention_bwd B={b} S={s}: max_abs_err dq "
              f"{errs['dq'][-1]:.3e} (largest share of the limit "
              f"{shares['dq'][-1]:.4f}), dk/dv {errs['dkv'][-1]:.3e} "
              f"({shares['dkv'][-1]:.4f}; tol atol {BWD_ATOL} rtol "
              f"{BWD_RTOL}); {kern}; both {ms['dq'] + ms['dkv']:.4f} ms vs "
              f"f32 FMA bound {total_bound[0]:.4f} ms "
              f"({14 * 256 * pairs / 1e9:.2f} GFLOP) and sdpa backward "
              f"{lib:.4f} ms (sdpa fwd+bwd {both:.4f}, fwd {fwd:.4f}) "
              f"[{card}]")
        if (b, s) == LINE_SHAPE:
            for part in ("dq", "dkv"):
                rows[part] = dict(ms=ms[part], plain_ms=plain[part],
                                  bound_ms=bounds[part][0],
                                  bound_by=bounds[part][1], library_ms=lib)
    for part in ("dq", "dkv"):
        rows[part]["max_abs_err"] = max(errs[part])
    print(f"flash_attention_bwd: largest share of the 1e-4 limit over "
          f"FLASH_SHAPES, dq {max(shares['dq']):.4f}, dk/dv "
          f"{max(shares['dkv']):.4f} [{card}]")
    return rows["dq"], rows["dkv"]


def bf16_share(torch, got, want) -> float:
    """The largest |got - want| over BF16_REL max|want| + BF16_REL |want|
    (1 is the limit); raises if got is not finite."""
    got, want = got.float(), want.float()
    if not bool(torch.isfinite(got).all()):
        raise RuntimeError("bf16 kernel output is not finite")
    limit = BF16_REL * want.abs().max() + BF16_REL * want.abs()
    return float(((got - want).abs() / limit).max())


FLASH_BF16_KERNELS = ("flash_attention_fwd_bf16",
                      "flash_attention_bwd_dq_bf16",
                      "flash_attention_bwd_dkv_bf16")


def check_flash_bf16(torch, F, fa, card):
    """The three bf16 kernels (csrc/flash_attention_bf16.cu) vs their
    plain versions at H 8, D 256, causal, at each of FLASH_BF16_SHAPES,
    the backward from the plain forward's O and lse (bf16 in, float32
    math in the plain versions); each timed beside its plain version, its
    bound (the bf16 tensor cores' rate) and SDPA in bf16 (its forward for
    the forward; for dQ and dK/dV its backward alone, dQ, dK and dV over a
    graph built once, as device time). Returns {kernel: row} at
    LINE_SHAPE."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    parts = dict(zip(("fwd", "dq", "dkv"), FLASH_BF16_KERNELS))
    rows, shares = {}, {p: [] for p in parts}
    errs = {p: [] for p in parts}
    for b, s in FLASH_BF16_SHAPES:
        q, k, v, do = (torch.randn(b, s, 8, 256, device="cuda",
                                   generator=gen).bfloat16()
                       for _ in range(4))
        ro, rlse = fa.flash_attention_fwd_reference(q, k, v, causal=True)
        delta = fa.flash_attention_bwd_delta(ro, do)
        args = (q, k, v, do, rlse, delta)
        o, lse = fa.flash_attention_fwd_bf16(q, k, v, causal=True)
        dq = fa.flash_attention_bwd_dq_bf16(*args, causal=True)
        dk, dv = fa.flash_attention_bwd_dkv_bf16(*args, causal=True)
        rq, rk, rv = fa.flash_attention_bwd_reference(q, k, v, ro, rlse, do,
                                                      causal=True)
        torch.cuda.synchronize()
        diff = lambda x, y: float((x.float() - y.float()).abs().max())
        share = {"fwd": (bf16_share(torch, o, ro),
                         limit_share(torch, lse, rlse, LSE_TOL, LSE_TOL)),
                 "dq": (bf16_share(torch, dq, rq),),
                 "dkv": (bf16_share(torch, dk, rk), bf16_share(torch, dv, rv))}
        err = {"fwd": max(diff(o, ro), diff(lse, rlse)), "dq": diff(dq, rq),
               "dkv": max(diff(dk, rk), diff(dv, rv))}
        for p in parts:
            shares[p].append(max(share[p]))
            errs[p].append(err[p])
            if max(share[p]) > 1:
                raise RuntimeError(f"{parts[p]} B={b} S={s} disagrees with "
                                   f"its plain version: {share[p]} of the "
                                   "limit")
        pairs = b * s * (s + 1) // 2 * 8
        elems, rowvec = b * s * 8 * 256, 4 * b * 8 * s
        nbytes = {"fwd": 2 * 4 * elems + rowvec,
                  "dq": 2 * 5 * elems + 2 * rowvec,
                  "dkv": 2 * 6 * elems + 2 * rowvec}
        flops = {"fwd": 4 * 256 * pairs, "dq": 6 * 256 * pairs,
                 "dkv": 8 * 256 * pairs}
        bounds = {p: bound_ms(nbytes[p], flops[p], BF16_FLOPS_PER_S)
                  for p in parts}
        calls = {"fwd": (lambda: fa.flash_attention_fwd_bf16(
                    q, k, v, causal=True),
                    lambda: fa.flash_attention_fwd_reference(
                        q, k, v, causal=True)),
                 "dq": (lambda: fa.flash_attention_bwd_dq_bf16(
                    *args, causal=True),
                    lambda: fa.flash_attention_bwd_dq_reference(
                        *args, causal=True)),
                 "dkv": (lambda: fa.flash_attention_bwd_dkv_bf16(
                     *args, causal=True),
                     lambda: fa.flash_attention_bwd_dkv_reference(
                         *args, causal=True))}
        ms = {p: cuda_ms(torch, calls[p][0], 20) for p in parts}
        plain = {p: cuda_ms(torch, calls[p][1], 5) for p in parts}
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), 20)
        # SDPA's backward alone: its graph built once, then the gradient
        # taken over it again and again; its device time (torch.profiler),
        # since its autograd calls can leave the card waiting on the host
        # here; CUDA events where the profile lost kernels
        qg, kg, vg = (x.detach().requires_grad_(True) for x in (qt, kt, vt))
        graph = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        grad = lambda: torch.autograd.grad(graph, (qg, kg, vg),
                                           do.transpose(1, 2),
                                           retain_graph=True)
        bwd_events = cuda_ms(torch, grad, 20)
        bwd = device_host(torch, grad, queued=20)[0] or bwd_events
        del graph
        lib = {"fwd": sdpa, "dq": bwd, "dkv": bwd}
        bwd_note = (f" (its backward alone: dQ, dK, dV; device time, "
                    f"{bwd_events:.4f} ms by events)")
        for p, name in parts.items():
            print(f"{name} B={b} S={s}: largest share of the limit "
                  f"{' / '.join(f'{x:.4f}' for x in share[p])} (bf16 outputs "
                  f"{BF16_REL} max|plain| + {BF16_REL} |plain|"
                  f"{', lse ' + str(LSE_TOL) if p == 'fwd' else ''}), "
                  f"max_abs_err {err[p]:.3e}; kernel {ms[p]:.4f} ms "
                  f"({flops[p] / ms[p] / 1e9:.1f} TFLOP/s), plain "
                  f"{plain[p]:.4f} ms, sdpa bf16 {lib[p]:.4f} ms"
                  f"{'' if p == 'fwd' else bwd_note}"
                  f", bound {bounds[p][0]:.4f} ms ({bounds[p][1]}; "
                  f"{nbytes[p] / 1e6:.1f} MB, {flops[p] / 1e9:.2f} GFLOP at "
                  f"{BF16_FLOPS_PER_S / 1e12:.0f} TFLOP/s) [{card}]")
            if (b, s) == LINE_SHAPE:
                rows[name] = dict(ms=ms[p], plain_ms=plain[p],
                                  bound_ms=bounds[p][0],
                                  bound_by=bounds[p][1], library_ms=lib[p])
    for p, name in parts.items():
        rows[name]["max_abs_err"] = max(errs[p])
    print("flash bf16 kernels: largest share of the limit over "
          "FLASH_BF16_SHAPES, " + ", ".join(
              f"{parts[p]} {max(shares[p]):.4f}" for p in parts)
          + f" [{card}]")
    return rows


PAGED_LENS = (1024, 1, 17, 500, 0, 999, 64, 777)
PAGED_POOLS = 6   # the decode step's layers, each with its own pools


def paged_case(torch, seed: int = 2, pools: int = 1):
    """Phase 3's paged decode inputs: 8 slots, H=8, D=256, BS=16, the
    lengths PAGED_LENS (one idle slot) through tables of the serving
    path's width, and `pools` distinct (K, V) pool pairs. Returns (q,
    [(k_pool, v_pool), ...], tables, lens)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    h, d, mb = 8, 256, MODEL["max_context"] // BLOCK
    pairs = [tuple(torch.randn(POOL_BLOCKS, BLOCK, h, d, device="cuda",
                               generator=gen) for _ in range(2))
             for _ in range(pools)]
    lens = torch.tensor(PAGED_LENS, dtype=torch.int32)
    perm = torch.randperm(POOL_BLOCKS - 1, generator=torch.Generator()
                          .manual_seed(seed + 1)) + 1
    tables = torch.zeros(SLOTS, mb, dtype=torch.int32)
    used = 0
    for i, n in enumerate(lens.tolist()):
        nb = -(-n // BLOCK)
        tables[i, :nb] = perm[used:used + nb]
        used += nb
    q = torch.randn(SLOTS, h, d, device="cuda", generator=gen)
    return q, pairs, tables.cuda(), lens.cuda()


def paged_bytes(q, tables, lens) -> int:
    """What one call must move: the live keys' K and V rows, q, out (in
    q's element size), the tables and the lengths (int32)."""
    _, h, d = q.shape
    return (q.element_size() * (2 * int(lens.sum()) * h * d + 2 * q.numel())
            + 4 * (tables.numel() + lens.numel()))


def check_paged(torch, fa, card, bf16: bool = False):
    """Paged decode (row 4; with bf16, row 4b on paged_case's inputs
    rounded to bf16) vs its plain version at paged_case's shape over the
    PAGED_POOLS pool pairs, within KERNEL_ATOL / KERNEL_RTOL (bf16:
    BF16_REL max|plain| + BF16_REL |plain|, with the share of values
    whose bits differ), the idle slot zeros, two calls bit for bit;
    timed back to back on one pool pair and over the pairs in turn (as
    the decode step's layers read them: the 55.5 MB of one float32 call
    fit the 50 MB L2 nearly whole, so back-to-back calls on one pair may
    partly hit it); device ms and CUDA launches a call (profiler), host
    us a call (200 queued), TB/s; bf16 beside the float32 kernel on the
    same values."""
    q, pairs, tables, lens = paged_case(torch, pools=PAGED_POOLS)
    wrapper = fa.paged_decode_attention
    if bf16:
        q = q.bfloat16()
        pairs = [(k.bfloat16(), v.bfloat16()) for k, v in pairs]
        wrapper = fa.paged_decode_attention_bf16
    name = wrapper.__name__
    errs, shares, differ = [], [], []
    for k_pool, v_pool in pairs:
        out = wrapper(q, k_pool, v_pool, tables, lens)
        ref = fa.paged_attention_reference(q, k_pool, v_pool, tables, lens)
        torch.cuda.synchronize()
        if bf16:
            shares.append(bf16_share(torch, out, ref))
            differ.append(bits_differ(torch, out, ref))
            errs.append(float((out.float() - ref.float()).abs().max()))
        else:
            errs.append(max_err(torch, out, ref))
        if bool(out[4].abs().max() != 0):
            raise RuntimeError(f"{name}: the idle slot's output is not zero")
    if bf16 and max(shares) > 1.0:
        raise RuntimeError(f"{name}: {max(shares):.3f} of the bf16 limit")
    k_pool, v_pool = pairs[0]
    out = wrapper(q, k_pool, v_pool, tables, lens)
    if not torch.equal(out, wrapper(q, k_pool, v_pool, tables, lens)):
        raise RuntimeError(f"two {name} calls differ")
    keys = int(lens.sum())
    nbytes = paged_bytes(q, tables, lens)
    b_ms, b_by = bound_ms(nbytes, 4 * keys * q.shape[1] * q.shape[2])

    def call():
        wrapper(q, k_pool, v_pool, tables, lens)

    def six():
        for kp, vp in pairs:
            wrapper(q, kp, vp, tables, lens)

    ms = cuda_ms(torch, call, 50)
    ms_six = cuda_ms(torch, six, 10) / len(pairs)
    device, launches, host = device_host(torch, call)
    if launches is not None and launches != 1:
        raise RuntimeError(f"{name}: {launches} CUDA launches a call, "
                           "expected 1")
    plain = cuda_ms(torch, lambda: fa.paged_attention_reference(
        q, k_pool, v_pool, tables, lens), 10)
    dev = "not measured" if device is None else f"{device:.4f} ms"
    by_dev = ("not measured" if device is None
              else f"{b_ms / device:.3f}")
    if bf16:
        q32, k32, v32 = q.float(), k_pool.float(), v_pool.float()
        f32_ms = cuda_ms(torch, lambda: fa.paged_decode_attention(
            q32, k32, v32, tables, lens), 50)
        held = (f"largest share of the bf16 limit over {len(pairs)} pool "
                f"pairs {max(shares):.4f}, values whose bits differ from "
                f"the plain version's {max(differ):.2e}, max_abs_err "
                f"{max(errs):.3e}")
        beside = f"; the float32 kernel on the same values {f32_ms:.4f} ms"
    else:
        held = (f"max_abs_err {max(errs):.3e} over {len(pairs)} pool "
                f"pairs (tol atol {KERNEL_ATOL} rtol {KERNEL_RTOL})")
        beside = ""
    print(f"{name} slots={SLOTS} lens={lens.tolist()}: {held}, kernel "
          f"{ms:.4f} ms back to back, {ms_six:.4f} ms over {len(pairs)} "
          f"pool pairs in turn, device {dev} and {launches} CUDA launch(es)"
          f" a call (profiler), host {host:.1f} us a call (200 queued); "
          f"{nbytes / ms / 1e9:.3f} TB/s ({nbytes / ms_six / 1e9:.3f} over "
          f"the pools) of {nbytes / 1e6:.1f} MB, {b_ms / ms:.3f} of the "
          f"bytes bound ({b_ms / ms_six:.3f}; by device time {by_dev})"
          f"{beside}; plain {plain:.4f} ms, bound {b_ms:.4f} ms ({b_by}) "
          f"[{card}]")
    return dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, max_abs_err=max(errs))


def make_params(np, param_shapes, seed: int) -> dict:
    """normal(0, 0.02) weights and embeddings, zero biases, unit LN scales
    (the JAX package's initializers for this model)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in param_shapes(MODEL).items():
        if name.endswith("_scale"):
            out[name] = np.ones(shape, np.float32)
        elif name.endswith(("_b", "_bias")):
            out[name] = np.zeros(shape, np.float32)
        else:
            a = rng.standard_normal(shape, dtype=np.float32)
            a *= 0.02
            out[name] = a
    return out


def teacher_forced(np, engine, prompt, generated):
    """Replay one finished request on the idle engine: decode-path logits
    (prefill the prompt, then one decode step per generated token) and
    prefill-path logits (one prefill of prompt + generated[:-1]) for the
    same positions. Returns (decode logits, prefill logits), [n, vocab]."""
    from paddle_tpu_torch.serving.decode.kv_cache import block_table_row

    model, pool = engine.model, engine.pool
    blocks = pool.alloc(pool.blocks_for_tokens(len(prompt) + len(generated)))
    try:
        logits, kv = model.prefill(prompt)
        model.seed_sequence(blocks, kv)
        dec = [logits]
        for j, tok in enumerate(generated[:-1]):
            tokens = np.zeros(model.slots, np.int64)
            lens = np.zeros(model.slots, np.int32)
            tables = np.zeros((model.slots, model.max_blocks_per_seq),
                              np.int32)
            tokens[0], lens[0] = tok, len(prompt) + j + 1
            tables[0] = block_table_row(blocks, model.max_blocks_per_seq)
            dec.append(model.decode_step(tokens, lens, tables)[0])
    finally:
        pool.free(blocks)
    full = np.asarray(prompt + generated[:-1], np.int32)
    pm = model.prefill_model
    res, _ = pm.execute_batch(pm.bucket_of({"src_ids": full}),
                              [{"src_ids": full}], host=False)
    n0 = len(prompt) - 1
    pre = res[0]["logits"][n0:n0 + len(generated)].cpu().numpy()
    return np.stack(dec), pre


def kernel_class(name: str) -> str:
    n = name.lower()
    # one tensor-core 3x3 kernel, two instances: the forward's, and
    # bwd_mid's input gradient (its policies live in namespace bwd_mid)
    if "conv3x3_kernel<" in n:
        return ("bwd_mid" if "bwd_mid::" in n else "conv3x3_norm_stats") + \
            " (port kernel)"
    # one tensor-core 1x1 kernel, two instances: conv1x1_bn_residual's,
    # and bwd_final's dx (its policy lives in namespace bwd_final)
    if "conv1x1_tc_kernel<" in n:
        return ("bwd_final" if "bwd_final::" in n
                else "conv1x1_bn_residual") + " (port kernel)"
    # the LSTM's names first: lstm_bwd_final_kernel holds "bwd_final_";
    # the forward is lstm_fwd_seq_kernel (one launch a call) or, where no
    # plan takes the shape, lstm_fwd_step_kernel
    if "lstm_" in n and "_bf16_" in n:
        return ("lstm_seq_fwd_bf16" if "lstm_fwd_" in n
                else "lstm_seq_bwd_bf16") + " (port kernel)"
    if "lstm_fwd_" in n:
        return "lstm_seq_fwd (port kernel)"
    if "lstm_gemm_kernel" in n or "lstm_bwd_" in n:
        return "lstm_seq_bwd (port kernel)"
    # the bf16 chain's wgmma kernels (csrc/abt_bf16_tc.cuh: bwd_mid's tap
    # gradients and the split products, bwd_reduce3's P and bwd_final's
    # dW1; csrc/conv1x1_bf16_tc.cuh: the 1x1 tile of conv1x1_bn_residual
    # and bwd_final's dx) and its other kernels (csrc/fused_block_bf16.cu):
    # templates whose mode says which wrapper launched them
    if "taps_bf16_kernel" in n:
        return "bwd_mid_bf16 (port kernel)"
    for pat, modes in (
            (r"reduce3_bf16_kernel<\d+, (\d)", ("bwd_reduce3", "bwd_final")),
            (r"tile1x1_bf16_kernel<\d+, (\d)",
             ("conv1x1_bn_residual", "bwd_final")),
            (r"conv1x1_bf16_kernel<\d+, (\d)",
             ("conv1x1_stats", None, "bwd_apply3")),
            (r"conv3x3_bf16_kernel<\d+, (\d)",
             ("conv3x3_norm_stats", "bwd_mid"))):
        mode = re.search(pat, n)
        if mode:
            return f"{modes[int(mode.group(1))]}_bf16 (port kernel)"
    if "fold_bf16_kernel" in n:
        return "bwd_mid_bf16 / bwd_final_bf16 fold (port kernel)"
    if "moments_bf16_kernel" in n:
        return "norm_relu_moments_bf16 (port kernel)"
    for kernel in ("conv1x1_stats", "conv3x3_norm_stats",
                   "conv1x1_bn_residual", "moments", "bwd_reduce3",
                   "bwd_apply3", "bwd_mid", "bwd_final"):
        if kernel + "_" in n:
            return (f"{kernel.replace('moments', 'norm_relu_moments')} "
                    f"(port kernel)")
    if "chain_stats_final_kernel" in n or "split_sum_kernel" in n:
        return "chain sums finalize (port kernel)"
    # the epilogue kernels are templates on the element type: float, or
    # bfloat16 as its bits (unsigned short)
    epi = re.search(r"(channel_stats|apply)_kernel<(float|unsigned short)"
                    r"(, (true|false))?", n)
    if epi:
        name = ("fused_conv_channel_stats" if epi.group(1) == "channel_stats"
                else "fused_conv_apply" + ("_add" if epi.group(4) == "true"
                                           else ""))
        return name + ("_bf16" if epi.group(2) != "float" else "") + \
            " (port kernel)"
    if "paged_split_kernel" in n:
        return "paged_decode_attention (port kernel)"
    for kernel in ("fwd", "dq", "dkv"):
        if f"flash_bf16_{kernel}_" in n:
            return (f"flash_attention_{'bwd_' if kernel != 'fwd' else ''}"
                    f"{kernel}_bf16 (port kernel)")
    if "flash_fwd" in n:
        return "flash_attention_fwd (port kernel)"
    if "flash_bwd_dq" in n:
        return "flash_attention_bwd_dq (port kernel)"
    if "flash_bwd_dkv" in n:
        return "flash_attention_bwd_dkv (port kernel)"
    if re.search(r"conv(?!ert)|fprop|dgrad|wgrad|implicit|winograd|"
                 r"nchwtonhwc|nhwctonchw", n):
        return "conv (cuDNN)"
    if "gemm" in n or "gemv" in n or "nvjet" in n:
        # nvjet: cuBLAS's Hopper kernels (the bf16 products of phase 16)
        return "matmul (cuBLAS)"
    if "memcpy" in n or "memset" in n:
        return "memcpy/memset"
    return "other PyTorch kernels"


def profiled(torch, fn, n: int, labels=()):
    """(wall ms per call, {kernel name: device ms per call}, {label:
    device ms per call}) over n calls under torch.profiler; each call
    ends in a host sync of its own. A label is the name of a
    torch.profiler.record_function range: its device time is that of the
    kernels launched inside it (the range's own device-side marker is
    not a kernel and is left out)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name, by_label = {}, {}
    for e in prof.events():
        if e.name in labels:
            if e.device_type == DeviceType.CPU:
                by_label[e.name] = (by_label.get(e.name, 0.0)
                                    + e.device_time_total / 1e3 / n)
        elif e.device_type == DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3 / n)
    return 1e3 * wall / n, by_name, by_label


def print_profile(what: str, wall_ms: float, by_name: dict, card: str,
                  carved=None):
    """carved: {class: device ms} taken out of "other PyTorch kernels"
    (kernels that a label, not a name, attributes)."""
    if not by_name:
        print(f"profile {what}: wall {wall_ms:.3f} ms per call; the "
              f"profiler saw no device time [{card}]")
        return
    busy = sum(by_name.values())
    print(f"profile {what}: wall {wall_ms:.3f} ms per call, device busy "
          f"{busy:.3f} ms, idle share {1 - busy / wall_ms:.3f} [{card}]")
    classes = {}
    for name, ms in by_name.items():
        classes[kernel_class(name)] = classes.get(kernel_class(name), 0) + ms
    for cls, ms in (carved or {}).items():
        classes[cls] = ms
        classes["other PyTorch kernels"] = classes.get(
            "other PyTorch kernels", 0.0) - ms
    for cls, ms in sorted(classes.items(), key=lambda kv: -kv[1]):
        print(f"  {cls}: {ms:.3f} ms ({ms / wall_ms:.3f} of wall)")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"    {ms:.3f} ms  {name[:100]}")


def profile_main_path(np, torch, engine, card, seed: int, steps: int = 10):
    """Where the time goes on the idle engine: one prefill per bucket, and
    decode steps with every slot holding a live sequence."""
    from paddle_tpu_torch.serving.decode.kv_cache import block_table_row

    model, pool = engine.model, engine.pool
    rng = np.random.default_rng(seed + 2)
    for bound in BUCKETS:
        toks = rng.integers(1, MODEL["vocab_size"], bound).tolist()
        wall, by_name, _ = profiled(torch, lambda: model.prefill(toks), 3)
        print_profile(f"prefill bucket {bound}", wall, by_name, card)
    lens = rng.integers(64, MODEL["max_context"] - steps - 2,
                        model.slots).astype(np.int32)
    blocks = [pool.alloc(pool.blocks_for_tokens(int(n) + steps + 2))
              for n in lens]
    try:
        for n, blk in zip(lens, blocks):
            _, kv = model.prefill(
                rng.integers(1, MODEL["vocab_size"], int(n)).tolist())
            model.seed_sequence(blk, kv)
        tables = np.stack([block_table_row(b, model.max_blocks_per_seq)
                           for b in blocks])
        state = {"lens": lens.copy()}

        def step():
            state["lens"] += 1
            model.decode_step(
                rng.integers(1, MODEL["vocab_size"], model.slots),
                state["lens"], tables)

        wall, by_name, _ = profiled(torch, step, steps)
    finally:
        for blk in blocks:
            pool.free(blk)
    print_profile(f"decode step ({model.slots} live slots, context "
                  f"{int(lens.min())}..{int(lens.max())}, {int(lens.sum())} "
                  f"keys, + {steps} steps)", wall, by_name, card)


def main_path(np, torch, fa, card, seed: int):
    from paddle_tpu_torch import io
    from paddle_tpu_torch.models.transformer import param_shapes
    from paddle_tpu_torch.serving.decode import DecodeEngine

    t0 = time.perf_counter()
    params = make_params(np, param_shapes, seed)
    rng = np.random.default_rng(seed + 1)
    prompts = [rng.integers(1, MODEL["vocab_size"],
                            int(rng.integers(64, 901))).tolist()
               for _ in range(N_REQUESTS)]
    with tempfile.TemporaryDirectory() as d:
        io.export_decode_model(d, MODEL, params=params,
                               length_buckets=BUCKETS, slots=SLOTS,
                               block_size=BLOCK, pool_blocks=POOL_BLOCKS)
        del params
        engine = DecodeEngine(d, name="lm")
    print(f"main path: weights made, exported and loaded in "
          f"{time.perf_counter() - t0:.1f} s; prompt lengths "
          f"{[len(p) for p in prompts]}")
    try:
        fa.flash_attention_fwd.launches = 0
        fa.paged_decode_attention.launches = 0
        t0 = time.perf_counter()
        handles = [engine.generate(p, max_new_tokens=MAX_NEW)
                   for p in prompts]
        results = [h.result(timeout=600) for h in handles]
        wall = time.perf_counter() - t0
        launches = {"flash_attention_fwd": fa.flash_attention_fwd.launches,
                    "paged_decode_attention":
                        fa.paged_decode_attention.launches}
        print(f"main path launches: {launches}")
        for name, n in launches.items():
            if n == 0:
                raise RuntimeError(f"{name} was not launched on the main "
                                   "path")
        for r in results:
            if (len(r["tokens"]) != MAX_NEW or r["finish_reason"] != "length"
                    or not all(0 <= t < MODEL["vocab_size"]
                               for t in r["tokens"])):
                raise RuntimeError(f"bad generation result {r}")
        snap = engine.metrics_snapshot()
        # the bundle's step program runs the paged kernel once a layer
        per_step = launches["paged_decode_attention"] / snap["decode_steps"]
        print(f"main path: {per_step:.3f} paged kernel launches a decode "
              f"step (the step program's {MODEL['n_layers']} layers)")
        if per_step != MODEL["n_layers"]:
            raise RuntimeError("the decode step did not launch the paged "
                               "kernel once a layer")
        step_ms = 1e3 * snap["decode_s"] / snap["decode_steps"]
        print(f"main path: {N_REQUESTS} requests x {MAX_NEW} tokens in "
              f"{wall:.3f} s: {snap['tokens_out'] / wall:.1f} tokens/s, "
              f"{snap['decode_steps']} decode steps at {step_ms:.3f} ms "
              f"mean, slot occupancy {snap['slot_occupancy']}, "
              f"{snap['prefills']} prefills [{card}]")
        for bound in BUCKETS:
            toks = rng.integers(1, MODEL["vocab_size"], bound).tolist()
            engine.model.prefill(toks)
            t0 = time.perf_counter()
            for _ in range(3):
                engine.model.prefill(toks)
            print(f"prefill bucket {bound}: "
                  f"{1e3 * (time.perf_counter() - t0) / 3:.3f} ms [{card}]")
        for i in (0, N_REQUESTS - 1):
            gen = results[i]["tokens"]
            dec, pre = teacher_forced(np, engine, prompts[i], gen)
            diff = float(np.abs(dec - pre).max())
            top2 = np.sort(pre, axis=1)[:, -2:]
            sure = (top2[:, 1] - top2[:, 0]) > LOGIT_TOL
            agree = pre.argmax(axis=1) == np.asarray(gen)
            print(f"teacher-forced request {i} (prompt {len(prompts[i])}): "
                  f"decode vs prefill logits max abs diff {diff:.3e} (tol "
                  f"{LOGIT_TOL}), {int(sure.sum())}/{len(gen)} tokens with "
                  f"top-2 gap > tol, all identical: "
                  f"{bool(agree[sure].all())}")
            if not (np.isfinite(dec).all() and diff <= LOGIT_TOL
                    and agree[sure].all()):
                raise RuntimeError("teacher-forced check failed")
        profile_main_path(np, torch, engine, card, seed)
    finally:
        engine.shutdown()
    return launches


def http_call(url, payload=None):
    """(status, body bytes) of a GET (payload None) or a JSON POST."""
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(
        url, data=data, headers={"Content-Type": "application/json"},
        method="GET" if data is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@contextlib.contextmanager
def plain_attention(fa):
    """The programs' attention op routed to the flash kernel's plain
    version (mha_reference) on the card, for a reference run of the same
    program on the same weights."""
    from paddle_tpu_torch.ops import attention_ops

    def plain(q, k, v, bias=None, *, causal=False, scale=None):
        return fa.mha_reference(q, k, v, bias, causal=causal, scale=scale)

    real = attention_ops.dot_product_attention
    attention_ops.dot_product_attention = plain
    try:
        yield
    finally:
        attention_ops.dot_product_attention = real


def export_lm(np, seed: int, root: str) -> dict:
    """MODEL's one-shot artifact (transformer_lm's inference program at
    src_ids [SERVE_SEQ], pos_table_len max_context, batch SERVE_BATCH,
    the logits fetched) and its decode bundle, random weights from
    `seed`, written under `root` for phases 13 and 14: {"dir", "bundle",
    "fetch" (the logits' name), "seconds"}."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import io
    from paddle_tpu_torch.models.transformer import (param_shapes,
                                                     transformer_lm)

    t0 = time.perf_counter()
    params = make_params(np, param_shapes, seed)
    infer = pt.Program()
    with pt.program_guard(infer, pt.Program()):
        src = pt.layers.data("src_ids", [SERVE_SEQ], dtype="int64")
        logits = transformer_lm(
            src, MODEL["vocab_size"], max_len=MODEL["max_context"],
            pos_table_len=MODEL["max_context"],
            **{k: MODEL[k] for k in ("n_layers", "d_model", "n_heads",
                                     "d_ff")})
    d, bundle = os.path.join(root, "lm"), os.path.join(root, "decode")
    scope = io.scope_from_numpy(params)
    io.export_serving_model(d, ["src_ids"], [logits], main_program=infer,
                            scope=scope, batch_size=SERVE_BATCH)
    del scope
    io.export_decode_model(bundle, MODEL, params=params,
                           length_buckets=BUCKETS, slots=SLOTS,
                           block_size=BLOCK, pool_blocks=POOL_BLOCKS)
    return {"dir": d, "bundle": bundle, "fetch": logits.name,
            "seconds": time.perf_counter() - t0}


def serving_path(np, torch, fa, card, seed: int, lm: dict):
    """Phase 13: the one-shot ServingEngine at full width, its hot
    reload, the decode facade and the HTTP front end, on export_lm's
    artifact and bundle. Returns the flash forward's and the paged
    kernel's launches of the phase (the reference runs of (b) left
    out)."""
    from paddle_tpu_torch import io
    from paddle_tpu_torch.obs.metrics import validate_exposition
    from paddle_tpu_torch.serving import ServingEngine
    from paddle_tpu_torch.serving.http import start_http_server

    flash, paged = fa.flash_attention_fwd, fa.paged_decode_attention
    flash.launches = paged.launches = 0
    left_out = 0
    layers, vocab = MODEL["n_layers"], MODEL["vocab_size"]
    d, bundle, fetch = lm["dir"], lm["bundle"], lm["fetch"]
    t0 = time.perf_counter()
    engine = ServingEngine(max_wait_ms=5, queue_depth=64)
    engine.load_model("lm", d)
    print(f"serving path (a): exported and loaded in "
          f"{lm['seconds']:.1f} + "
          f"{time.perf_counter() - t0:.1f} s; batch {SERVE_BATCH}, "
          f"src_ids [{SERVE_SEQ}], buckets "
          f"{engine.models()['lm']['buckets']}")
    server = None
    try:
        rng = np.random.default_rng(seed + 13)

        def burst():
            return [{"src_ids": rng.integers(1, vocab, SERVE_SEQ)}
                    for _ in range(SERVE_REQUESTS)]

        # (b) the first burst, then the same requests one at a time
        reqs = burst()
        n0 = flash.launches
        t0 = time.perf_counter()
        futs = [engine.submit("lm", r) for r in reqs]
        outs = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t0
        n_burst = flash.launches - n0
        snap = engine.metrics_snapshot()["models"]["lm"]
        print(f"serving path (b): {SERVE_REQUESTS} requests in "
              f"{1e3 * wall:.3f} ms, {SERVE_REQUESTS / wall:.2f} "
              f"requests/s, {snap['batches']} batches, fill "
              f"{snap['batch_fill_ratio']}, flash launches {n_burst} "
              f"[{card}]")
        for phase, pcts in snap["latency"].items():
            print(f"  {phase}: p50 {pcts['p50_ms']} ms, p99 "
                  f"{pcts['p99_ms']} ms")
        if not 0 < n_burst == layers * snap["batches"]:
            raise RuntimeError(f"{n_burst} flash launches over "
                               f"{snap['batches']} batches")
        t0 = time.perf_counter()
        for r in reqs:
            engine.predict("lm", r, timeout=600)
        wall1 = time.perf_counter() - t0
        print(f"serving path (b): the same {SERVE_REQUESTS} one at a "
              f"time: {SERVE_REQUESTS / wall1:.2f} requests/s "
              f"({1e3 * wall1 / SERVE_REQUESTS:.3f} ms each) [{card}]")
        n0 = flash.launches
        version = engine.registry.get("lm").model
        wall, by_name, _ = profiled(torch, lambda: version.execute_batch(
            None, reqs[:SERVE_BATCH]), 2)
        print_profile(f"one-shot batch ({SERVE_BATCH} x {SERVE_SEQ} "
                      f"tokens, pad + step + copy to the host + "
                      f"scatter)", wall, by_name, card)
        predict, _, _ = io.load_serving_model(d)
        worst, same, plain_worst, plain_share = 0.0, True, 0.0, 0.0
        for r, out in zip(reqs, outs):
            batch = np.zeros((SERVE_BATCH, SERVE_SEQ), np.int32)
            batch[0] = r["src_ids"]
            want = predict(batch)[0][0]
            with plain_attention(fa):
                plain = predict(batch)[0][0]
            got = out[fetch]
            same = same and got.tobytes() == want.tobytes()
            worst = max(worst, float(np.abs(got - want).max()))
            plain_worst = max(plain_worst,
                              float(np.abs(got - plain).max()))
            share = np.abs(got - plain) / (KERNEL_ATOL + KERNEL_RTOL *
                                           np.abs(plain))
            plain_share = max(plain_share, float(share.max()))
            ok = np.abs(got - want) <= KERNEL_ATOL + KERNEL_RTOL * \
                np.abs(want)
            if not (np.isfinite(got).all() and ok.all()
                    and got.shape == (SERVE_SEQ, vocab)):
                raise RuntimeError("a coalesced request disagrees with "
                                   "load_serving_model's run")
        del predict, version
        left_out += flash.launches - n0
        print(f"serving path (b): each request vs load_serving_model "
              f"alone in row 0: max abs diff {worst:.3e} (tol atol "
              f"{KERNEL_ATOL} rtol {KERNEL_RTOL}), the same bits: "
              f"{same}; vs that run with the attention op on "
              f"mha_reference: max abs diff {plain_worst:.3e}, largest "
              f"share of the limit {plain_share:.4f}")
        if not plain_share <= 1.0:
            raise RuntimeError("the served logits disagree with the "
                               "plain attention's run")

        # (c) a second burst with a hot reload in the middle of it
        reqs = burst()
        reload = threading.Thread(
            target=lambda: engine.load_model("lm", d))
        t0 = time.perf_counter()
        futs = [engine.submit("lm", r) for r in reqs[:8]]
        reload.start()
        for r in reqs[8:]:
            time.sleep(0.05)
            futs.append(engine.submit("lm", r))
        outs = [f.result(timeout=600) for f in futs]
        reload.join()
        snap = engine.metrics_snapshot()["models"]["lm"]
        version = engine.models()["lm"]["version"]
        print(f"serving path (c): {len(outs)} requests with a hot "
              f"reload inside {time.perf_counter() - t0:.1f} s: version "
              f"{version}, received {snap['received']}, completed "
              f"{snap['completed']}, failed {snap['failed']}, reloads "
              f"{snap['reloads']}")
        if not (version == 2 and snap["failed"] == 0
                and snap["received"] == snap["completed"]
                and all(o[fetch].shape == (SERVE_SEQ, vocab)
                        for o in outs)):
            raise RuntimeError("the hot reload dropped or failed "
                               "requests")

        # (d) the decode facade, in process and over HTTP
        engine.load_decode_model("lm_decode", bundle)
        prompts = [rng.integers(1, vocab, n).tolist()
                   for n in SERVE_PROMPTS]
        p0 = paged.launches
        hs = [engine.generate("lm_decode", p, max_new_tokens=SERVE_NEW)
              for p in prompts]
        gen = [h.result(timeout=600)["tokens"] for h in hs]
        server, _ = start_http_server(engine, port=0)
        base = f"http://127.0.0.1:{server.server_address[1]}"
        status, body = http_call(
            f"{base}/v1/models/lm_decode:generate",
            {"prompt_ids": prompts[0], "max_new_tokens": SERVE_NEW})
        lines = [json.loads(ln) for ln in body.decode().splitlines()]
        streamed = [ln["token"] for ln in lines if "token" in ln]
        print(f"serving path (d): 2 generate requests of {SERVE_NEW} "
              f"tokens, paged launches {paged.launches - p0}; HTTP "
              f":generate {status}, {len(lines)} NDJSON lines, the "
              f"facade's tokens: {streamed == gen[0]}")
        if not (paged.launches > p0 and status == 200
                and streamed == gen[0] == lines[-1]["tokens"]
                and all(len(g) == SERVE_NEW for g in gen)):
            raise RuntimeError("the decode facade or its HTTP stream "
                               "failed")

        # (e) the HTTP routes
        status, body = http_call(f"{base}/v1/models")
        models = json.loads(body)["models"]
        bad, bad_body = http_call(f"{base}/v1/models/lm:predict",
                                  {"feeds": {"src_ids": [1, 2, 3]}})
        m_status, text = http_call(f"{base}/metrics?format=prometheus")
        text = text.decode()
        problems = validate_exposition(text)
        want = ('pt_serve_completed_total{model="lm"}',
                'pt_decode_tokens_out_total{model="lm_decode"}')
        found = [w in text for w in want]
        print(f"serving path (e): /v1/models {status} {sorted(models)}; "
              f"bad feed {bad} {json.loads(bad_body)['error']}; "
              f"/metrics {m_status}, {len(text.splitlines())} lines, "
              f"{len(problems)} problems, series {dict(zip(want, found))}")
        if not (status == 200 and {"lm", "lm_decode"} <= set(models)
                and bad == 400
                and json.loads(bad_body)["error"] == "InvalidRequest"
                and m_status == 200 and not problems and all(found)):
            raise RuntimeError("an HTTP route failed")
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
        engine.shutdown()
    return {"flash_attention_fwd": flash.launches - left_out,
            "paged_decode_attention": paged.launches}


def fleet_burst(router, reqs, fetch):
    """Submit `reqs` in FLEET_CLASSES priority classes in turn and wait
    for every answer: (outputs, requests/s)."""
    t0 = time.perf_counter()
    futs = [router.submit("lm", r, priority=i % FLEET_CLASSES)
            for i, r in enumerate(reqs)]
    outs = [f.result(timeout=600)[fetch] for f in futs]
    return outs, len(reqs) / (time.perf_counter() - t0)


def fleet_path(np, torch, fa, card, seed: int, lm: dict):
    """Phase 14: the fleet tier (make_fleet: ReplicaPool, FleetRouter,
    Autoscaler) over replicas of phase 13's artifact and decode bundle,
    each replica a ServingEngine on the card holding both. Returns the
    flash forward's and the paged kernel's launches of the phase (the
    reference engine's runs left out)."""
    from paddle_tpu_torch.obs.metrics import (render_prometheus,
                                              validate_exposition)
    from paddle_tpu_torch.resilience import faults
    from paddle_tpu_torch.serving import ServingEngine
    from paddle_tpu_torch.serving.admission import Overloaded
    from paddle_tpu_torch.serving.fleet import (Autoscaler, FleetRouter,
                                                make_fleet)
    from paddle_tpu_torch.serving.http import start_http_server

    t_phase = time.perf_counter()
    flash, paged = fa.flash_attention_fwd, fa.paged_decode_attention
    flash.launches = paged.launches = 0
    torch.cuda.reset_peak_memory_stats()
    vocab, fetch = MODEL["vocab_size"], lm["fetch"]
    rng = np.random.default_rng(seed + 14)
    engine_opts = dict(max_wait_ms=5, queue_depth=FLEET_ENGINE_QUEUE)

    def loader(engine, rid):
        engine.load_model("lm", lm["dir"])
        engine.load_decode_model("lm_decode", lm["bundle"])

    def burst(n):
        return [{"src_ids": rng.integers(1, vocab, SERVE_SEQ)}
                for _ in range(n)]

    def healthy(n):
        reps = router.pool.all_replicas()
        return len(reps) == n and all(r.healthy for r in reps)

    def wait_for(pred, what, timeout=300.0):
        deadline = time.monotonic() + timeout
        while not pred():
            if time.monotonic() > deadline:
                raise RuntimeError(f"fleet: {what} within {timeout} s")
            time.sleep(0.01)

    answered = []   # (request, the fleet's answer), held to the reference
    t0 = time.perf_counter()
    router = make_fleet(loader, replicas=2, autoscale=False,
                        queue_depth=FLEET_QUEUE,
                        pool_opts=dict(engine_opts=engine_opts,
                                       max_replicas=3))
    small = server = None
    try:
        print(f"fleet (a): make_fleet built {router.pool.size()} replicas "
              f"(the one-shot artifact and the decode bundle each) in "
              f"{time.perf_counter() - t0:.1f} s, policy {router.policy}")

        # (b) a burst of one-shot requests in FLEET_CLASSES classes, then
        # generations in FLEET_SESSIONS sessions
        reqs = burst(FLEET_REQUESTS)
        outs, rps2 = fleet_burst(router, reqs, fetch)
        answered += zip(reqs, outs)
        prompts = [rng.integers(1, vocab, int(n)).tolist()
                   for n in rng.integers(BUCKETS[0] // 8,
                                         min(200, BUCKETS[-1] - FLEET_NEW),
                                         FLEET_GENERATE)]
        sessions = [f"chat-{i % FLEET_SESSIONS}"
                    for i in range(FLEET_GENERATE)]
        home = {s: router._pick_for(s, set()).rid for s in sessions}
        hs = [router.generate("lm_decode", p, session=s,
                              max_new_tokens=FLEET_NEW)
              for p, s in zip(prompts, sessions)]
        gens = [h.result(timeout=600)["tokens"] for h in hs]
        want = {}
        for s in sessions:
            want[home[s]] = want.get(home[s], 0) + 1
        got = {r.rid: r.engine.decode_engine("lm_decode").metrics
               .snapshot()["received"] for r in router.pool.replicas()}
        got = {rid: n for rid, n in got.items() if n}
        print(f"fleet (b): {FLEET_REQUESTS} one-shot requests on 2 "
              f"replicas: {rps2:.2f} requests/s [{card}]; "
              f"{FLEET_GENERATE} generations in {FLEET_SESSIONS} sessions "
              f"{home}, by replica {got} (want {want})")
        if got != want:
            raise RuntimeError("a session left its replica")

        # (c) one injected router_dispatch crash: failover, rebuild
        os.environ[faults.ENV_VAR] = "router_dispatch@3"
        faults.reset()
        try:
            reqs = burst(8)
            outs, _ = fleet_burst(router, reqs, fetch)
        finally:
            del os.environ[faults.ENV_VAR]
            faults.reset()
        answered += zip(reqs, outs)
        t0 = time.perf_counter()
        wait_for(lambda: healthy(2), "the crashed replica was not rebuilt")
        snap = router.metrics.snapshot()
        print(f"fleet (c): one router_dispatch crash: failovers "
              f"{snap['failovers']}, rebuilds {snap['rebuilds']}, "
              f"{len(outs)} of {len(reqs)} answered, rebuilt healthy "
              f"{time.perf_counter() - t0:.1f} s later")
        if not (snap["failovers"] == 1 and snap["rebuilds"] == 1
                and snap["failed"] == 0):
            raise RuntimeError("the crash did not fail over cleanly")

        # (d) scale 2 -> 3 -> 1 while a client keeps FLEET_ENGINE_QUEUE
        # requests in flight
        stop, sent, load_errors = threading.Event(), [], []

        def client():
            while not stop.is_set():
                batch = burst(FLEET_ENGINE_QUEUE)
                try:
                    outs, _ = fleet_burst(router, batch, fetch)
                except Exception as e:  # noqa: BLE001 — the drop count
                    load_errors.append(f"{type(e).__name__}: {e}")
                    return
                if not sent:
                    answered.extend(zip(batch, outs))
                sent.extend(o.shape == (SERVE_SEQ, vocab)
                            and bool(np.isfinite(o).all()) for o in outs)

        load = threading.Thread(target=client)
        load.start()
        try:
            t0 = time.perf_counter()
            up = router.pool.scale_to(3, reason="chip_smoke")
            t_up = time.perf_counter() - t0
            down = router.pool.scale_to(1, reason="chip_smoke")
        finally:
            stop.set()
            load.join(600)
        print(f"fleet (d): scaled to {up} ({t_up:.1f} s) then {down} "
              f"under load: {len(sent)} requests answered, "
              f"{len(load_errors)} failed")
        if load.is_alive() or load_errors or up != 3 or down != 1 or \
                not sent or not all(sent):
            raise RuntimeError(f"the scale events dropped requests: "
                               f"{load_errors[:3]}")
        first = answered[:FLEET_REQUESTS]
        outs, rps1 = fleet_burst(router, [r for r, _ in first], fetch)
        same = all(o.tobytes() == a.tobytes()
                   for o, (_, a) in zip(outs, first))
        print(f"fleet (d): the same {FLEET_REQUESTS} one-shot requests on "
              f"1 replica: {rps1:.2f} requests/s, against {rps2:.2f} on 2 "
              f"[{card}]; the same bits: {same}")
        if not same:
            raise RuntimeError("one replica answered otherwise than two")

        # (e) a router with a queue bound of FLEET_SMALL_QUEUE over the
        # same pool, overloaded: the lowest class sheds first, typed
        small = FleetRouter(router.pool, queue_depth=FLEET_SMALL_QUEUE,
                            name="fleet_small")
        served, shed, futs = 0, [], []
        for i, r in enumerate(burst(FLEET_OVERLOAD)):
            cls = i % FLEET_CLASSES
            try:
                futs.append((cls, small.submit("lm", r, priority=cls)))
            except Overloaded as e:
                shed.append((cls, e.shed_class))
        for cls, f in futs:
            try:
                f.result(timeout=600)
                served += 1
            except Overloaded as e:
                shed.append((cls, e.shed_class))
        by_class = [sum(c == k for c, _ in shed)
                    for k in range(FLEET_CLASSES)]
        sheds = small.metrics.snapshot()["sheds"]
        print(f"fleet (e): {FLEET_OVERLOAD} requests at a queue bound of "
              f"{FLEET_SMALL_QUEUE}: {served} served, shed by class "
              f"{by_class}, metrics {sheds}")
        if not (served + len(shed) == FLEET_OVERLOAD and by_class[0] > 0
                and all(c == sc for c, sc in shed)
                and by_class == sorted(by_class, reverse=True)
                and sheds == {str(k): n for k, n in enumerate(by_class)
                              if n}):
            raise RuntimeError("the overload did not shed lowest class "
                               "first, typed")

        # (f) the autoscaler, ticked by hand: up on queue depth, back
        # down after its idle window
        asc = Autoscaler(router.pool, metrics=router.metrics, up_depth=4.0,
                         down_depth=0.5, up_after=2, down_after=3)
        reqs = burst(3 * FLEET_ENGINE_QUEUE)
        futs = [router.submit("lm", r) for r in reqs]
        wait_for(lambda: router.pool.health()["r0"]["queue_depth"] >= 4,
                 "the replica's queue never reached 4")
        ups = [asc.tick(), asc.tick()]
        outs = [f.result(timeout=600)[fetch] for f in futs]
        downs = [asc.tick() for _ in range(3)]
        print(f"fleet (f): autoscaler ticks {ups} under load, {downs} "
              f"idle; replicas {router.pool.size()}")
        if ups != [None, "up"] or downs != [None, None, "down"] or \
                router.pool.size() != 1 or not all(
                    np.isfinite(o).all() for o in outs):
            raise RuntimeError("the autoscaler did not scale up and back "
                               "down")

        # (g) /v1/fleet and the pt_fleet_* scrape over HTTP
        server, _ = start_http_server(router, port=0)
        base = f"http://127.0.0.1:{server.server_address[1]}"
        status, body = http_call(f"{base}/v1/fleet")
        st = json.loads(body)
        m_status, text = http_call(f"{base}/metrics?format=prometheus")
        text = text.decode()
        problems = validate_exposition(text)
        series = sorted({ln.split("{")[0].split(" ")[0]
                         for ln in text.splitlines()
                         if ln.startswith("pt_fleet_")})
        print(f"fleet (g): /v1/fleet {status} replicas "
              f"{sorted(st['replicas'])} policy {st['policy']}; /metrics "
              f"{m_status}, {len(problems)} problems, series {series}")
        if not (status == 200 and set(st["replicas"]) == {"r0"}
                and m_status == 200 and not problems
                and {"pt_fleet_replicas", "pt_fleet_failovers_total",
                     "pt_fleet_sheds_total", "pt_fleet_scale_events_total",
                     "pt_fleet_replica_healthy"} <= set(series)
                and validate_exposition(render_prometheus(
                    router.metrics_snapshot())) == []):
            raise RuntimeError("/v1/fleet or the pt_fleet_* scrape failed")
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
        for r in (small, router):
            if r is not None:
                r.close()
    launches = {"flash_attention_fwd": flash.launches,
                "paged_decode_attention": paged.launches}
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"fleet: launches {launches}, peak device memory {peak:.2f} GB, "
          f"{len(answered)} one-shot answers [{card}]")

    # every answer against one ServingEngine's answer to the same request
    # and the generations against its DecodeEngine's; through that engine
    # the attention op on mha_reference, as phase 13 holds it
    ref = ServingEngine(max_wait_ms=5, queue_depth=len(answered))
    try:
        loader(ref, "reference")
        futs = [ref.submit("lm", r) for r, _ in answered]
        same = all(f.result(timeout=600)[fetch].tobytes() == o.tobytes()
                   for f, (_, o) in zip(futs, answered))
        ref_gens = [ref.generate("lm_decode", p, max_new_tokens=FLEET_NEW)
                    .result(timeout=600)["tokens"] for p in prompts]
        share = 0.0
        with plain_attention(fa):
            for r, o in answered[:SERVE_BATCH]:
                plain = ref.predict("lm", r, timeout=600)[fetch]
                share = max(share, float((np.abs(o - plain) / (
                    KERNEL_ATOL + KERNEL_RTOL * np.abs(plain))).max()))
    finally:
        ref.shutdown()
    wall = time.perf_counter() - t_phase
    print(f"fleet: every answer the bits of one engine's: {same}; the "
          f"generations its DecodeEngine's tokens: {gens == ref_gens}; "
          f"vs the attention op on mha_reference, largest share of the "
          f"limit {share:.4f}; phase wall {wall:.1f} s")
    if not (same and gens == ref_gens and share <= 1.0
            and all(len(g) == FLEET_NEW for g in gens)
            and all(np.isfinite(o).all() and o.shape == (SERVE_SEQ, vocab)
                    for _, o in answered)):
        raise RuntimeError("the fleet's answers disagree with one "
                           "engine's")
    for name, n in launches.items():
        if n == 0:
            raise RuntimeError(f"{name} was not launched by the fleet")
    return launches


def lm_probe_feeds(np, i, batch, seqlen, vocab):
    """bench.py lm_probe_feeds: batch i of the current-token copy task
    over an LM_PROBE_POOL-id pool."""
    vrng = np.random.RandomState(7000 + i)
    src = vrng.randint(0, min(vocab, LM_PROBE_POOL),
                       (batch, seqlen)).astype("int64")
    return {"src_ids": src, "tgt_ids": src[..., None]}


def build_lm(pt, cfg, seq_len, seed):
    from paddle_tpu_torch.models.transformer import transformer_lm_loss

    main_prog, startup = pt.Program(), pt.Program()
    main_prog.random_seed = startup.random_seed = seed
    with pt.program_guard(main_prog, startup):
        avg, _ = transformer_lm_loss(
            vocab_size=cfg["vocab_size"], seq_len=seq_len,
            n_layers=cfg["n_layers"], d_model=cfg["d_model"],
            n_heads=cfg["n_heads"], d_ff=cfg["d_ff"], max_len=seq_len)
        pt.optimizer.AdamOptimizer(learning_rate=TRAIN["lr"]).minimize(avg)
    return main_prog, startup, avg


TRAIN_KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv")


def train_path(np, torch, fa, card, seed: int):
    """Full-width training through the Executor; returns the launch
    counts of the run (startup, warm-up and timed steps)."""
    import paddle_tpu_torch as pt

    b, s = TRAIN["batch"], TRAIN["seq_len"]
    main_prog, startup, avg = build_lm(pt, MODEL, s, seed)
    n_params = sum(int(np.prod(v.shape)) for v in
                   main_prog.global_block.all_parameters())
    exe, scope = pt.Executor(), pt.Scope()
    torch.cuda.reset_peak_memory_stats()
    for name in TRAIN_KERNELS:
        getattr(fa, name).launches = 0
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    losses, step_s = [], []
    for i in range(1 + TRAIN_STEPS):
        feed = lm_probe_feeds(np, i, b, s, MODEL["vocab_size"])
        t0 = time.perf_counter()
        loss, = exe.run(main_prog, feed=feed, fetch_list=[avg], scope=scope)
        step_s.append(time.perf_counter() - t0)
        losses.append(float(loss[0]))
    launches = {name: getattr(fa, name).launches for name in TRAIN_KERNELS}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ms = 1e3 * sum(step_s[1:]) / TRAIN_STEPS
    print(f"train path: {n_params} parameters, startup {t_init:.2f} s, "
          f"losses {losses}, warm-up step {1e3 * step_s[0]:.1f} ms, "
          f"{TRAIN_STEPS} timed steps {[round(1e3 * x, 1) for x in step_s[1:]]}"
          f" ms: {ms:.3f} ms per step, {b * s / ms * 1e3:.1f} tokens/s, "
          f"peak memory {peak_gb:.2f} GB [{card}]")
    print(f"train path launches: {launches}")
    want = MODEL["n_layers"] * (1 + TRAIN_STEPS)
    for name, n in launches.items():
        if n != want:
            raise RuntimeError(f"{name} was launched {n} times on the "
                               f"training path, expected {want}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"training losses are not finite and falling: "
                           f"{losses}")
    feed = lm_probe_feeds(np, 1 + TRAIN_STEPS, b, s, MODEL["vocab_size"])
    wall, by_name, _ = profiled(torch, lambda: exe.run(
        main_prog, feed=feed, fetch_list=[avg], scope=scope), 1)
    print_profile(f"training step (batch {b}, sequence {s})", wall, by_name,
                  card)
    program_vs_module(np, torch, pt, scope, card)
    return launches


def program_vs_module(np, torch, pt, scope, card):
    """The trained weights, by name, in the serving module: its forward
    logits equal those of an inference program that the training
    builder makes, on one sequence of the training length."""
    from paddle_tpu_torch.models.transformer import (TransformerLM,
                                                     param_shapes,
                                                     transformer_lm)

    s = TRAIN["seq_len"]
    infer = pt.Program()
    with pt.program_guard(infer, pt.Program()):
        src = pt.layers.data("src_ids", [s], dtype="int64")
        logits = transformer_lm(src, MODEL["vocab_size"], max_len=s,
                                **{k: MODEL[k] for k in ("n_layers",
                                                         "d_model", "n_heads",
                                                         "d_ff")})
    ids = np.random.default_rng(5).integers(
        0, MODEL["vocab_size"], (1, s)).astype(np.int64)
    exe = pt.Executor()
    got, = exe.run(infer, feed={"src_ids": ids}, fetch_list=[logits],
                   scope=scope, return_numpy=False)
    cfg = dict(MODEL, max_context=s)
    model = TransformerLM.from_config(cfg, device=exe.device)
    model.load_jax_params({p: scope.find_var(p) for p in param_shapes(cfg)})
    with torch.no_grad():
        want = model(torch.from_numpy(ids).to(exe.device))[0]
    torch.cuda.synchronize()
    diff = (got - want).abs()
    ok = bool(torch.isfinite(got).all()) and bool(
        (diff <= MODULE_ATOL + MODULE_RTOL * want.abs()).all())
    print(f"program vs module, full width, trained weights, 1 x {s} tokens: "
          f"logits max abs diff {float(diff.max()):.3e} (tol atol "
          f"{MODULE_ATOL} rtol {MODULE_RTOL}), logits max abs "
          f"{float(want.abs().max()):.3e} [{card}]")
    if not ok:
        raise RuntimeError("the Program path and the serving module disagree")
    del model


def launch_profile(torch, fn):
    """(kernel launches, device ms, {class: (launches, ms)}) of one call
    of fn under torch.profiler, after one call outside it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    classes = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, ms = classes.get(kernel_class(e.name), (0, 0.0))
            classes[kernel_class(e.name)] = (
                n + 1, ms + e.time_range.elapsed_us() / 1e3)
    return (sum(n for n, _ in classes.values()),
            sum(ms for _, ms in classes.values()), classes)


def build_trainer(pt, seed, ckpt_dir):
    """The Trainer of phase 15 over MODEL at TRAIN's shape, built with
    fresh name counters (a second one names its vars as the first)."""
    from paddle_tpu_torch.core.program import unique_name_guard
    from paddle_tpu_torch.models.transformer import transformer_lm_loss

    s = TRAIN["seq_len"]

    def train_func():
        pt.default_main_program().random_seed = seed
        pt.default_startup_program().random_seed = seed
        avg, _ = transformer_lm_loss(
            vocab_size=MODEL["vocab_size"], seq_len=s,
            n_layers=MODEL["n_layers"], d_model=MODEL["d_model"],
            n_heads=MODEL["n_heads"], d_ff=MODEL["d_ff"], max_len=s)
        return [avg]

    def optimizer_func():
        # noam's rate peaks at step warmup_steps, at d^-0.5 warmup^-0.5
        peak = (MODEL["d_model"] * TRAINER_WARMUP) ** -0.5
        lr = pt.layers.noam_decay(MODEL["d_model"],
                                  warmup_steps=TRAINER_WARMUP) \
            * (TRAIN["lr"] / peak)
        pt.clip.set_gradient_clip(pt.clip.GradientClipByGlobalNorm(1.0))
        return pt.optimizer.AdamOptimizer(
            learning_rate=lr, regularization=pt.regularizer.L2Decay(1e-4))

    cfg = pt.CheckpointConfig(ckpt_dir, max_num_checkpoints=1,
                              step_interval=TRAINER_INTERVAL)
    with unique_name_guard():
        return pt.Trainer(train_func, optimizer_func, checkpoint_config=cfg)


def trainer_path(np, torch, fa, card, seed: int):
    """Phase 15: the Trainer at full width, its checkpoint, resume and
    guard; returns the flash kernels' launches of (a)-(c)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.resilience import faults, manifest

    b, s, v = TRAIN["batch"], TRAIN["seq_len"], MODEL["vocab_size"]

    def reader():
        return (lm_probe_feeds(np, i, b, s, v) for i in range(TRAINER_STEPS))

    def persistables(trainer):
        block = trainer.train_program.global_block
        return {n: trainer.scope.find_var(n) for n, var in block.vars.items()
                if var.persistable and trainer.scope.find_var(n) is not None}

    old_guard = os.environ.get("PT_GUARD")
    os.environ["PT_GUARD"] = "skip"
    root = tempfile.mkdtemp(prefix="trainer_ckpt_")
    try:
        ckpt, snap = os.path.join(root, "ckpt"), os.path.join(root, "step6")
        for name in TRAIN_KERNELS:
            getattr(fa, name).launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        a = build_trainer(pt, seed, ckpt)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        saves, handles, ends = [], {}, {}
        save = a._save_checkpoint

        def timed_save(*args):
            t = time.perf_counter()
            save(*args)
            saves.append(time.perf_counter() - t)
        a._save_checkpoint = timed_save

        def on_a(event):
            if isinstance(event, pt.BeginStepEvent) and \
                    event.step == TRAINER_INTERVAL:
                # keep the step-6 serial: the next save scrolls it away
                (serial,) = os.listdir(ckpt)
                os.makedirs(snap)
                for f in os.listdir(os.path.join(ckpt, serial)):
                    os.link(os.path.join(ckpt, serial, f),
                            os.path.join(snap, f))
            if isinstance(event, pt.EndStepEvent):
                handles[event.step] = event.metrics[0]
                ends[event.step] = time.perf_counter()

        t0 = time.perf_counter()
        a.train(num_epochs=1, event_handler=on_a, reader=reader,
                log_every=TRAINER_LOG_EVERY)
        t_train = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        losses = [float(np.ravel(np.asarray(handles[i]))[0])
                  for i in range(TRAINER_STEPS)]
        # steps 1-4, between two read boundaries (steps 0 and 4 read
        # their loss before their EndStepEvent), no checkpoint between
        ms = 1e3 * (ends[TRAINER_LOG_EVERY] - ends[0]) / TRAINER_LOG_EVERY
        ckpt_gb = sum(os.path.getsize(os.path.join(snap, f))
                      for f in os.listdir(snap)) / 1e9
        t0 = time.perf_counter()
        status, problems = manifest.verify_dir(snap)
        t_verify = time.perf_counter() - t0
        print(f"trainer (a): {TRAINER_STEPS} steps, built in {t_build:.1f} "
              f"s, train() {t_train:.1f} s, losses {losses}, {ms:.3f} ms a "
              f"step (steps 1-{TRAINER_LOG_EVERY}), peak memory "
              f"{peak_gb:.2f} GB; checkpoint {ckpt_gb:.3f} GB, saves "
              f"{[round(x, 2) for x in saves]} s, verify {t_verify:.2f} s "
              f"({status}) [{card}]")
        if status != "ok" or problems:
            raise RuntimeError(f"the step-6 serial does not verify: "
                               f"{problems}")
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise RuntimeError(f"trainer losses are not finite and "
                               f"falling: {losses}")

        # (b) the dir holds the step-6 serial alone; a new Trainer resumes
        shutil.rmtree(ckpt)
        os.makedirs(ckpt)
        os.rename(snap, os.path.join(ckpt, "checkpoint_0"))
        t0 = time.perf_counter()
        r = build_trainer(pt, seed, ckpt)
        torch.cuda.synchronize()
        t_resume = time.perf_counter() - t0
        if (r.checkpoint_cfg.epoch_id, r.checkpoint_cfg.step_id) != \
                (0, TRAINER_INTERVAL):
            raise RuntimeError(
                f"resumed at epoch {r.checkpoint_cfg.epoch_id} step "
                f"{r.checkpoint_cfg.step_id}, expected step "
                f"{TRAINER_INTERVAL}")
        rhandles = {}
        r.train(num_epochs=1, reader=reader, log_every=TRAINER_LOG_EVERY,
                event_handler=lambda e: rhandles.__setitem__(
                    e.step, e.metrics[0])
                if isinstance(e, pt.EndStepEvent) else None)
        rlosses = [float(np.ravel(np.asarray(rhandles[i]))[0])
                   for i in range(TRAINER_INTERVAL, TRAINER_STEPS)]
        loss_rel = max(abs(x - y) / abs(y) for x, y in
                       zip(rlosses, losses[TRAINER_INTERVAL:]))
        got, want = persistables(r), persistables(a)
        if sorted(got) != sorted(want):
            raise RuntimeError("the resumed run holds other vars")
        worst, same = 0.0, True
        for n in want:
            d = (got[n].float() - want[n].float()).abs()
            worst = max(worst, float(d.max()))
            same = same and torch.equal(got[n], want[n])
            if not bool((d <= TRAINER_RTOL * want[n].float().abs()
                         + TRAINER_RTOL).all()):
                raise RuntimeError(f"{n}: the resumed run's state is "
                                   f"{float(d.max()):.3e} from the "
                                   "uninterrupted run's")
        print(f"trainer (b): resumed at step {TRAINER_INTERVAL + 1} in "
              f"{t_resume:.1f} s (build, verify, load), losses of steps "
              f"{TRAINER_INTERVAL + 1}-{TRAINER_STEPS} {rlosses}, largest "
              f"relative loss difference {loss_rel:.3e}, largest state "
              f"difference {worst:.3e} (tol rtol {TRAINER_RTOL}), "
              f"bit-identical {same} [{card}]")
        if not loss_rel <= TRAINER_RTOL:
            raise RuntimeError("the resumed run's losses differ")
        del a, got, want, save, timed_save
        gc.collect()

        # (c) a poisoned step leaves every persistable var as it was
        before = {n: t.clone() for n, t in persistables(r).items()}
        os.environ["PT_FAULT_INJECT"] = "nan_grad@1"
        faults.reset()
        try:
            loss, health = r.exe.run(
                r.train_program, feed=lm_probe_feeds(
                    np, TRAINER_STEPS, b, s, v),
                fetch_list=[r.loss], scope=r.scope, guard=True, lazy=True)
            healthy = bool(health)
        finally:
            del os.environ["PT_FAULT_INJECT"]
            faults.reset()
        after = persistables(r)
        changed = [n for n in before if not torch.equal(before[n], after[n])]
        print(f"trainer (c): nan_grad step: health {healthy}, loss "
              f"{float(loss):.6f}, {len(before)} persistable vars, "
              f"{len(changed)} changed [{card}]")
        if healthy or changed:
            raise RuntimeError(f"the guarded step was not skipped: health "
                               f"{healthy}, changed {changed[:5]}")
        del before, after

        # (d) the flash kernels ran n_layers times a step
        launches = {name: getattr(fa, name).launches
                    for name in TRAIN_KERNELS}
        steps = TRAINER_STEPS + (TRAINER_STEPS - TRAINER_INTERVAL) + 1
        print(f"trainer (d): launches over {steps} steps {launches}")
        for name, n in launches.items():
            if n != MODEL["n_layers"] * steps:
                raise RuntimeError(f"{name} was launched {n} times by the "
                                   f"Trainer, expected "
                                   f"{MODEL['n_layers'] * steps}")

        # what the contract costs a step: phase 5's program, the
        # Trainer's unguarded and guarded
        plain, startup, avg = build_lm(pt, MODEL, s, seed)
        feed = lm_probe_feeds(np, TRAINER_STEPS + 1, b, s, v)
        exe, scope = pt.Executor(), pt.Scope()
        exe.run(startup, scope=scope)
        runs = (("phase 5's program", lambda: exe.run(
                    plain, feed=feed, fetch_list=[avg], scope=scope)),
                ("Trainer's program, unguarded", lambda: r.exe.run(
                    r.train_program, feed=feed, fetch_list=[r.loss],
                    scope=r.scope)),
                ("Trainer's program, guarded", lambda: r.exe.run(
                    r.train_program, feed=feed, fetch_list=[r.loss],
                    scope=r.scope, guard=True)))
        for what, fn in runs:
            n, dev, classes = launch_profile(torch, fn)
            top = sorted(classes.items(), key=lambda kv: -kv[1][1])[:4]
            print(f"trainer profile, {what}: {n} launches, device "
                  f"{dev:.3f} ms; " + "; ".join(
                      f"{c} {k} launches {ms:.3f} ms" for c, (k, ms) in top)
                  + f" [{card}]")
        del exe, scope, r
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)
        if old_guard is None:
            os.environ.pop("PT_GUARD", None)
        else:
            os.environ["PT_GUARD"] = old_guard


def rms(np, a):
    return float(np.sqrt(np.mean(np.square(a.astype(np.float64)))))


def hold_updates(np, names, start, got_scope, want_scope,
                 skip=lambda n: False):
    """(largest elementwise state diff, largest relative rms diff of an
    update or accumulator) of the card's scope against the CPU's; raises
    where an update or accumulator is further than STATE_RTOL (rms) from
    the CPU's. Vars that `skip` names count in the first only."""
    worst, worst_rel = 0.0, 0.0
    for n in names:
        got, want = got_scope.get_numpy(n), want_scope.get_numpy(n)
        worst = max(worst, float(np.abs(got - want).max()))
        if not ("_moment" in n or "_pow_acc" in n):
            got, want = got - start[n], want - start[n]
        if skip(n):
            continue
        if rms(np, want) > 0:
            worst_rel = max(worst_rel, rms(np, got - want) / rms(np, want))
        if not rms(np, got - want) <= STATE_RTOL * rms(np, want):
            raise RuntimeError(f"{n}: card vs CPU rms diff "
                               f"{rms(np, got - want):.3e}, rms "
                               f"{rms(np, want):.3e}")
    return worst, worst_rel


def card_vs_cpu(np, torch, card, seed: int):
    """One reduced program from one startup state: two Adam steps on the
    card and on the CPU agree."""
    import paddle_tpu_torch as pt

    cfg = {k: REDUCED[k] for k in ("vocab_size", "n_layers", "d_model",
                                   "n_heads", "d_ff")}
    s, b = REDUCED["seq_len"], REDUCED["batch"]
    main_prog, startup, avg = build_lm(pt, cfg, s, seed)
    cpu, gpu = pt.Executor(pt.CPUPlace()), pt.Executor()
    cpu_scope, gpu_scope = pt.Scope(), pt.Scope()
    cpu.run(startup, scope=cpu_scope)
    names = sorted(cpu_scope.local_var_names())
    start = {n: cpu_scope.get_numpy(n) for n in names}
    for name in names:
        gpu_scope.set_var(name, cpu_scope.find_var(name).to(gpu.device))
    loss_diff = []
    for i in range(2):
        feed = lm_probe_feeds(np, i, b, s, cfg["vocab_size"])
        lc, = cpu.run(main_prog, feed=feed, fetch_list=[avg], scope=cpu_scope)
        lg, = gpu.run(main_prog, feed=feed, fetch_list=[avg], scope=gpu_scope)
        loss_diff.append(abs(float(lg[0]) - float(lc[0])))
        if not loss_diff[-1] <= LOSS_RTOL * abs(float(lc[0])):
            raise RuntimeError(f"step {i}: card loss {lg[0]} vs CPU {lc[0]}")
    # the key biases: zero gradient in exact arithmetic (see LOSS_RTOL)
    worst, worst_rel = hold_updates(
        np, names, start, gpu_scope, cpu_scope,
        skip=lambda n: n.split("_moment")[0].endswith("_k_b"))
    print(f"card vs CPU, reduced program, 2 Adam steps: loss diffs "
          f"{loss_diff} (tol rtol {LOSS_RTOL}), largest state diff "
          f"{worst:.3e} (tol atol {PARAM_ATOL}), largest relative rms diff "
          f"of an update or accumulator {worst_rel:.3e} (tol {STATE_RTOL}) "
          f"[{card}]")
    if not worst <= PARAM_ATOL:
        raise RuntimeError("card and CPU states disagree")


def logits_of(program) -> str:
    """The name of the LM's logits: softmax_with_cross_entropy's input."""
    return next(op.inputs["Logits"][0] for op in program.global_block.ops
                if op.type == "softmax_with_cross_entropy")


def amp_train_path(np, torch, fa, card, seed: int):
    """Phase 16: phase 5's model, feeds and steps with main.amp_dtype =
    "bfloat16" through the Executor; returns the bf16 flash kernels'
    launch counts of the warm-up and timed steps."""
    import paddle_tpu_torch as pt

    b, s = TRAIN["batch"], TRAIN["seq_len"]
    main_prog, startup, avg = build_lm(pt, MODEL, s, seed)
    main_prog.amp_dtype = "bfloat16"
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    names = TRAIN_KERNELS + FLASH_BF16_KERNELS
    for name in names:
        getattr(fa, name).launches = 0

    def steps(first: int):
        losses, step_s = [], []
        for i in range(first, first + 1 + TRAIN_STEPS):
            feed = lm_probe_feeds(np, i, b, s, MODEL["vocab_size"])
            t0 = time.perf_counter()
            loss, = exe.run(main_prog, feed=feed, fetch_list=[avg],
                            scope=scope)
            step_s.append(time.perf_counter() - t0)
            losses.append(float(loss[0]))
        return losses, 1e3 * sum(step_s[1:]) / TRAIN_STEPS, step_s

    losses, ms, step_s = steps(0)
    launches = {name: getattr(fa, name).launches for name in names}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"AMP train path (bfloat16, float32 masters): losses {losses}, "
          f"warm-up step {1e3 * step_s[0]:.1f} ms, {TRAIN_STEPS} timed steps "
          f"{[round(1e3 * x, 1) for x in step_s[1:]]} ms: {ms:.3f} ms per "
          f"step, {b * s / ms * 1e3:.1f} tokens/s, peak memory "
          f"{peak_gb:.2f} GB [{card}]")
    print(f"AMP train path launches: {launches}")
    want = MODEL["n_layers"] * (1 + TRAIN_STEPS)
    for name, n in launches.items():
        expect = want if name in FLASH_BF16_KERNELS else 0
        if n != expect:
            raise RuntimeError(f"{name} was launched {n} times on the AMP "
                               f"training path, expected {expect}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"AMP training losses are not finite and "
                           f"falling: {losses}")
    wide = [p.name for p in main_prog.global_block.all_parameters()
            if scope.find_var(p.name).dtype != torch.float32]
    if wide:
        raise RuntimeError(f"masters no longer float32 after AMP steps: "
                           f"{wide}")
    feed = lm_probe_feeds(np, 1 + TRAIN_STEPS, b, s, MODEL["vocab_size"])
    run = lambda: exe.run(main_prog, feed=feed, fetch_list=[avg],
                          scope=scope)
    n, dev_ms, classes = launch_profile(torch, run)
    print(f"AMP training step profiled: {n} kernel launches (phase 5's "
          f"float32 step: 2775, PERF.md), device {dev_ms:.3f} ms: "
          + ", ".join(f"{c} {m:.3f} ms / {k}" for c, (k, m) in
                      sorted(classes.items(), key=lambda kv: -kv[1][1]))
          + f" [{card}]")
    wall, by_name, _ = profiled(torch, run, 1)
    print_profile(f"AMP training step (batch {b}, sequence {s})", wall,
                  by_name, card)
    # the same program's float32 step, the same scope, in this run
    main_prog.amp_dtype = None
    f32_losses, f32_ms, _ = steps(2 + TRAIN_STEPS)
    main_prog.amp_dtype = "bfloat16"
    print(f"float32 step of the same program in this run: {f32_ms:.3f} ms "
          f"per step (losses {f32_losses}); AMP {f32_ms / ms:.3f}x its "
          f"speed [{card}]")
    # the inference clone keeps amp_dtype; with no autodiff op nothing
    # casts the masters, so it computes in float32 (as the JAX package's)
    lname = logits_of(main_prog)
    test = main_prog.clone(for_test=True).prune([lname])
    ids = lm_probe_feeds(np, 99, 1, s, MODEL["vocab_size"])["src_ids"]
    logits, = exe.run(test, feed={"src_ids": ids}, fetch_list=[lname],
                      scope=scope, return_numpy=False)
    torch.cuda.synchronize()
    if test.amp_dtype != "bfloat16" or not bool(
            torch.isfinite(logits).all()):
        raise RuntimeError("the AMP program's inference clone lost "
                           "amp_dtype or gave non-finite logits")
    print(f"AMP inference clone: logits {tuple(logits.shape)} "
          f"{logits.dtype}, finite, max abs {float(logits.abs().max()):.3e}")
    return {name: launches[name] for name in FLASH_BF16_KERNELS}


def amp_card_vs_cpu(np, torch, card, seed: int):
    """Phase 16's reduced part: phase 6's reduced program under AMP, two
    Adam steps from one startup state on the card and on the CPU."""
    import paddle_tpu_torch as pt

    cfg = {k: REDUCED[k] for k in ("vocab_size", "n_layers", "d_model",
                                   "n_heads", "d_ff")}
    s, b = REDUCED["seq_len"], REDUCED["batch"]
    main_prog, startup, avg = build_lm(pt, cfg, s, seed)
    main_prog.amp_dtype = "bfloat16"
    cpu, gpu = pt.Executor(pt.CPUPlace()), pt.Executor()
    cpu_scope, gpu_scope = pt.Scope(), pt.Scope()
    cpu.run(startup, scope=cpu_scope)
    for name in cpu_scope.local_var_names():
        gpu_scope.set_var(name, cpu_scope.find_var(name).to(gpu.device))
    params = [p.name for p in main_prog.global_block.all_parameters()]
    start = {n: cpu_scope.get_numpy(n) for n in params}
    loss_diff, grad_rel = [], 0.0
    for i in range(2):
        feed = lm_probe_feeds(np, i, b, s, cfg["vocab_size"])
        fetch = [avg.name] + ([p + "@GRAD" for p in params] if i == 0
                              else [])
        oc = cpu.run(main_prog, feed=feed, fetch_list=fetch, scope=cpu_scope)
        og = gpu.run(main_prog, feed=feed, fetch_list=fetch, scope=gpu_scope)
        loss_diff.append(abs(float(og[0][0]) - float(oc[0][0])))
        if not loss_diff[-1] <= AMP_LOSS_RTOL * abs(float(oc[0][0])):
            raise RuntimeError(f"AMP step {i}: card loss {og[0][0]} vs CPU "
                               f"{oc[0][0]}")
        for p, g, c in zip(params, og[1:], oc[1:]):
            if g.dtype != np.float32:
                raise RuntimeError(f"{p}@GRAD is {g.dtype} under AMP")
            if p.endswith("_k_b"):   # zero in exact arithmetic
                continue
            rel = rms(np, g - c) / rms(np, c)
            grad_rel = max(grad_rel, rel)
            if not rel <= AMP_GRAD_RTOL:
                raise RuntimeError(f"{p}@GRAD: card vs CPU rms diff {rel:.3e} "
                                   "of the CPU's under AMP")
    worst, upd_rel = 0.0, 0.0
    for p in params:
        got, want = gpu_scope.get_numpy(p), cpu_scope.get_numpy(p)
        if gpu_scope.find_var(p).dtype != torch.float32:
            raise RuntimeError(f"master {p} is not float32")
        worst = max(worst, float(np.abs(got - want).max()))
        if not p.endswith("_k_b"):   # zero gradient: noise-driven steps
            upd_rel = max(upd_rel, rms(np, got - want)
                          / rms(np, want - start[p]))
    print(f"card vs CPU, reduced program under AMP, 2 Adam steps: loss "
          f"diffs {loss_diff} (tol rtol {AMP_LOSS_RTOL}), largest relative "
          f"rms diff of a first-step float32 gradient {grad_rel:.3e} (tol "
          f"{AMP_GRAD_RTOL}), largest master diff {worst:.3e} (tol atol "
          f"{AMP_STEP_ATOL}), largest relative rms diff of an update "
          f"{upd_rel:.3e} (tol {AMP_UPDATE_RTOL}) [{card}]")
    if not (worst <= AMP_STEP_ATOL and upd_rel <= AMP_UPDATE_RTOL):
        raise RuntimeError("card and CPU masters disagree under AMP")


def resnet_varied(np, i, batch, image, center=0.0):
    """bench.py bench_resnet varied(i): uniform images, labels a function
    of one pixel (so the loss can fall); `center` is subtracted from the
    images after the labels are taken."""
    vrng = np.random.RandomState(1000 + i)
    data = vrng.rand(batch, 3, image, image).astype("float32")
    label = (data[:, 0, 0, 0] * 9.999).astype("int64")
    return {"data": data - np.float32(center), "label": label.reshape(-1, 1)}


def build_resnet50(pt, seed):
    """The full-width training program through the user's entry point,
    and its fused form as the Executor runs it (the pass's memo)."""
    from paddle_tpu_torch.analysis import fuse
    from paddle_tpu_torch.models import resnet

    main_prog, startup = pt.Program(), pt.Program()
    main_prog.random_seed = startup.random_seed = seed
    with pt.program_guard(main_prog, startup):
        avg, acc, predict, _ = resnet.get_model(
            data_set=RESNET["data_set"], depth=RESNET["depth"],
            fused_xent=True, learning_rate=RESNET["lr"])
    fused = fuse.maybe_fuse(main_prog, protect=[avg.name, acc.name])
    return dict(main=main_prog, startup=startup, avg=avg, acc=acc,
                predict=predict, fused=fused)


def epilogue_ops(fused, batch):
    """[(shape [N, C, H, W], relu, with_add)] of the fused_conv2d ops."""
    out = []
    for op in fused.global_block.ops:
        if op.type == "fused_conv2d":
            shape = fused.global_block.var(op.output("Output")[0]).shape
            out.append(((batch,) + tuple(shape[1:]),
                        op.attrs.get("act") == "relu",
                        bool(op.input("Addend"))))
    return out


def epilogue_launches_per_step(fused):
    ops = epilogue_ops(fused, 1)
    with_add = sum(1 for _, _, add in ops if add)
    return {"channel_stats": len(ops), "apply_epilogue": len(ops) - with_add,
            "apply_epilogue_add": with_add}


def bits_differ(torch, got, want) -> float:
    """The share of elements of two bfloat16 tensors whose bits differ."""
    return float((got.view(torch.int16) != want.view(torch.int16))
                 .float().mean())


def check_epilogue(torch, F, fc, card, ops, bf16: bool = False):
    """The three epilogue kernels vs their plain versions at every
    distinct epilogue shape of the path; the kernels line reports stats
    and apply at the first op's shape (the stem) and apply + add at the
    first shortcut's, the largest of each on the path. bf16: the bfloat16
    kernels (their wrappers' names end in _bf16) on bfloat16 a and
    addend: y bit for bit the plain version's (its share of BF16_REL
    max|plain| + BF16_REL |plain| printed), the float32 sums as
    the float32 kernel's, bounds over bfloat16 bytes, the yardsticks in
    bfloat16."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    sfx, esize = ("_bf16", 2) if bf16 else ("", 4)
    fn = {k: getattr(fc, k + sfx) for k in EPILOGUE_KERNELS}
    shapes = list(dict.fromkeys(shape for shape, _, _ in ops))
    relu_of = {}
    for shape, relu, add in ops:
        if not add:
            relu_of.setdefault(shape, relu)
    line = {"channel_stats": ops[0][0], "apply_epilogue": ops[0][0],
            "apply_epilogue_add": next(sh for sh, _, add in ops if add)}
    rows, errs = {}, {k: [] for k in line}
    for shape in shapes:
        n, c, h, w = shape
        s, m = h * w, n * h * w
        a = torch.randn(n, c, s, device="cuda", generator=gen) + 0.5
        d = torch.randn(n, c, s, device="cuda", generator=gen)
        if bf16:
            a, d = a.bfloat16(), d.bfloat16()
        gamma = torch.rand(c, device="cuda", generator=gen) + 0.5
        beta = 0.1 * torch.randn(c, device="cuda", generator=gen)
        ssum, ssq = fn["channel_stats"](a)
        rsum, rsq = fc.channel_stats_reference(a)
        abs_sum = a.float().abs().sum(dim=(0, 2))
        var_k = ssq / m - torch.square(ssum / m)
        var_p = rsq / m - torch.square(rsum / m)
        torch.cuda.synchronize()
        ok = (bool(((ssum - rsum).abs() <= STATS_RTOL * abs_sum).all())
              and bool(((ssq - rsq).abs() <= STATS_RTOL * rsq).all())
              and bool(((var_k - var_p).abs() <= STATS_RTOL * rsq / m)
                       .all()))
        if not ok:
            raise RuntimeError(f"channel_stats{sfx} disagrees with its "
                               f"plain version at {shape}")
        errs["channel_stats"].append(float(torch.maximum(
            (ssum - rsum).abs().max(), (ssq - rsq).abs().max())) / m)
        inv = torch.rsqrt(torch.clamp_min(var_p, 0.0) + 1e-5)
        scale_c = gamma * inv
        shift_c = beta - rsum / m * scale_c
        relu = relu_of.get(shape, True)
        y = fn["apply_epilogue"](a, scale_c, shift_c, relu)
        ry = fc.apply_epilogue_reference(a, scale_c, shift_c, None, relu)
        y2 = fn["apply_epilogue_add"](a, scale_c, shift_c, d, True)
        ry2 = fc.apply_epilogue_reference(a, scale_c, shift_c, d, True)
        torch.cuda.synchronize()
        if bf16:
            # one fused multiply-add and one rounding on both sides: the
            # same bits, and the share of the bf16 limit printed
            shares = [bf16_share(torch, y, ry), bf16_share(torch, y2, ry2)]
            differ = (bits_differ(torch, y, ry), bits_differ(torch, y2, ry2))
            if max(differ) > 0:
                raise RuntimeError(f"the bf16 apply kernels disagree with "
                                   f"their plain versions at {shape}: "
                                   f"shares of y whose bits differ {differ}"
                                   f", of the bf16 limit {shares}")
            errs["apply_epilogue"].append(float((y.float() - ry.float())
                                                .abs().max()))
            errs["apply_epilogue_add"].append(float(
                (y2.float() - ry2.float()).abs().max()))
        else:
            errs["apply_epilogue"].append(max_err(torch, y, ry, EPI_ATOL,
                                                  EPI_RTOL))
            errs["apply_epilogue_add"].append(max_err(torch, y2, ry2,
                                                      EPI_ATOL, EPI_RTOL))
        del y, ry, y2, ry2
        elems = n * c * s
        bounds = {"channel_stats": bound_ms(esize * elems + 8 * c,
                                            3 * elems),
                  "apply_epilogue": bound_ms(2 * esize * elems + 8 * c,
                                             (2 + relu) * elems),
                  "apply_epilogue_add": bound_ms(3 * esize * elems + 8 * c,
                                                 4 * elems)}
        calls = {"channel_stats": (lambda: fn["channel_stats"](a),
                                   lambda: fc.channel_stats_reference(a)),
                 "apply_epilogue": (
                     lambda: fn["apply_epilogue"](a, scale_c, shift_c, relu),
                     lambda: fc.apply_epilogue_reference(
                         a, scale_c, shift_c, None, relu)),
                 "apply_epilogue_add": (
                     lambda: fn["apply_epilogue_add"](a, scale_c, shift_c,
                                                      d),
                     lambda: fc.apply_epilogue_reference(a, scale_c,
                                                         shift_c, d, True))}
        ms = {k: cuda_ms(torch, f, 20) for k, (f, _) in calls.items()}
        plain = {k: cuda_ms(torch, r, 5) for k, (_, r) in calls.items()}
        # device ms a launch, launches a call, host us a call
        split = {k: device_host(torch, f) for k, (f, _) in calls.items()}
        again = fn["channel_stats"](a)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip((ssum, ssq), again)):
            raise RuntimeError(f"channel_stats{sfx} gives other bits on a "
                               f"second call at {shape}")
        a4 = a.view(n, c, h, w)
        lib = {"channel_stats": cuda_ms(
                   torch, lambda: torch.var_mean(a, dim=(0, 2)), 20),
               "apply_epilogue": cuda_ms(
                   torch, lambda: F.batch_norm(a4, None, None, gamma, beta,
                                               True, 0.1, 1e-5), 20),
               "apply_epilogue_add": None}
        def apart(k):
            # device time also from a CUDA graph of the calls (no host
            # time between launches), beside the profiler's, which at
            # times loses kernel events
            dev, launches, host = split[k]
            graph = graph_device_ms(torch, calls[k][0])
            graph = ("" if graph is None else
                     f", CUDA graph {graph:.4f} ms a call")
            if dev is None:
                return (f"device not measured by the profiler (it lost "
                        f"kernel events){graph}, host {host:.1f} us a call")
            return (f"device {dev / launches:.4f} ms a launch x "
                    f"{launches}{graph}, host {host:.1f} us a call")

        if bf16:
            tail = (f"largest share of the bf16 limit (BF16_REL "
                    f"{BF16_REL}) apply {shares[0]:.4f}, add "
                    f"{shares[1]:.4f}; y elements whose bits differ from "
                    f"the plain version: apply {differ[0]:.2e}, add "
                    f"{differ[1]:.2e}")
        else:
            tail = (f"apply {errs['apply_epilogue'][-1]:.3e}, add "
                    f"{errs['apply_epilogue_add'][-1]:.3e} (tol atol "
                    f"{EPI_ATOL} rtol {EPI_RTOL})")
        print(f"conv epilogue{' bf16' * bf16} {list(shape)}: stats "
              f"{ms['channel_stats']:.4f}"
              f" ms ({apart('channel_stats')}; plain "
              f"{plain['channel_stats']:.4f}, var_mean "
              f"{lib['channel_stats']:.4f}, bound "
              f"{bounds['channel_stats'][0]:.4f}), apply{' relu' * relu} "
              f"{ms['apply_epilogue']:.4f} ms ({apart('apply_epilogue')}; "
              f"plain {plain['apply_epilogue']:.4f}, bound "
              f"{bounds['apply_epilogue'][0]:.4f}), apply+add relu "
              f"{ms['apply_epilogue_add']:.4f} ms "
              f"({apart('apply_epilogue_add')}; plain "
              f"{plain['apply_epilogue_add']:.4f}, bound "
              f"{bounds['apply_epilogue_add'][0]:.4f}); stats + apply "
              f"{ms['channel_stats'] + ms['apply_epilogue']:.4f} ms vs "
              f"F.batch_norm {lib['apply_epilogue']:.4f} ms; max_abs_err "
              f"E[a], E[a^2] {errs['channel_stats'][-1]:.3e} (tol rtol "
              f"{STATS_RTOL}), {tail} [{card}]")
        for k, sh in line.items():
            if sh == shape:
                rows[k + sfx] = dict(ms=ms[k], plain_ms=plain[k],
                                     bound_ms=bounds[k][0],
                                     bound_by=bounds[k][1],
                                     library_ms=lib[k])
        del a, d, a4
    for k in line:
        rows[k + sfx]["max_abs_err"] = max(errs[k])
    return rows


EPILOGUE_KERNELS = ("channel_stats", "apply_epilogue", "apply_epilogue_add")
EPILOGUE_BF16_KERNELS = tuple(k + "_bf16" for k in EPILOGUE_KERNELS)


def resnet_path(np, torch, fc, card, built):
    """Full-width ResNet-50 training through the Executor; returns the
    epilogue kernels' launch counts of the run (startup, warm-up and
    timed steps)."""
    import paddle_tpu_torch as pt

    b, img = RESNET["batch"], RESNET["image"]
    main_prog, avg, acc = built["main"], built["avg"], built["acc"]
    n_params = sum(int(np.prod(v.shape)) for v in
                   main_prog.global_block.all_parameters())
    exe, scope = pt.Executor(), pt.Scope()
    # one upload of the fixed feed, as bench.py's loop feeds one batch
    feed = {k: torch.from_numpy(v).to(exe.device)
            for k, v in resnet_varied(np, 0, b, img).items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for name in EPILOGUE_KERNELS:
        getattr(fc, name).launches = 0
    t0 = time.perf_counter()
    exe.run(built["startup"], scope=scope)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    losses, accs, step_s = [], [], []
    for _ in range(1 + RESNET_STEPS):
        t0 = time.perf_counter()
        loss, a = exe.run(main_prog, feed=feed, fetch_list=[avg, acc],
                          scope=scope)
        step_s.append(time.perf_counter() - t0)
        losses.append(float(loss[0]))
        accs.append(float(a[0]))
    launches = {name: getattr(fc, name).launches for name in EPILOGUE_KERNELS}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ms = 1e3 * sum(step_s[1:]) / RESNET_STEPS
    print(f"resnet path: ResNet-50, {n_params} parameters, batch {b}, {img} "
          f"px, startup {t_init:.2f} s, losses {losses}, accuracies {accs}, "
          f"warm-up step {1e3 * step_s[0]:.1f} ms, {RESNET_STEPS} timed steps "
          f"{[round(1e3 * x, 1) for x in step_s[1:]]} ms: {ms:.3f} ms per "
          f"step, {b / ms * 1e3:.1f} images/s, peak memory {peak_gb:.2f} GB "
          f"[{card}]")
    print(f"resnet path launches: {launches}")
    want = {k: v * (1 + RESNET_STEPS) for k, v in
            epilogue_launches_per_step(built["fused"]).items()}
    if launches != want:
        raise RuntimeError(f"epilogue launches {launches} on the ResNet "
                           f"path, expected {want} (the fused program's "
                           f"fused_conv2d counts x {1 + RESNET_STEPS} steps)")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"ResNet losses are not finite and falling: "
                           f"{losses}")
    wall, by_name, _ = profiled(torch, lambda: exe.run(
        main_prog, feed=feed, fetch_list=[avg], scope=scope), 1)
    print_profile(f"ResNet-50 training step (batch {b}, {img} px)", wall,
                  by_name, card)
    name = built["predict"].name
    test = main_prog.clone(for_test=True).prune([name])
    pred, = exe.run(test, feed={"data": feed["data"]}, fetch_list=[name],
                    scope=scope, return_numpy=False)
    train_fwd = main_prog.prune([name])
    pred_train, = exe.run(train_fwd, feed={"data": feed["data"]},
                          fetch_list=[name], scope=scope, return_numpy=False)
    rows_ok = bool(((pred.sum(dim=1) - 1).abs() <= 1e-4).all())
    agree = float((pred.argmax(1) == pred_train.argmax(1)).float().mean())
    print(f"resnet inference clone (BN folded into the convs): predictions "
          f"{tuple(pred.shape)}, finite {bool(torch.isfinite(pred).all())}, "
          f"rows sum to 1 within 1e-4: {rows_ok}; argmax agreement with the "
          f"training-mode forward {agree:.3f} (information) [{card}]")
    if not (bool(torch.isfinite(pred).all()) and rows_ok
            and tuple(pred.shape) == (b, 1000)):
        raise RuntimeError("the inference clone's predictions are not "
                           "finite probabilities")
    return launches


def state_diffs(np, got, want, base=None, updated=()):
    """(largest elementwise diff, largest and median relative rms diff
    over the vars of `want`; for the vars in `updated`, of their updates
    from `base`)"""
    worst, rels = 0.0, []
    for n, b in want.items():
        a = got[n]
        worst = max(worst, float(np.abs(a - b).max()))
        if base is not None and n in updated:
            a, b = a - base[n], b - base[n]
        if rms(np, b) > 0:
            rels.append(rms(np, a - b) / rms(np, b))
    return worst, max(rels), float(np.median(rels))


def hold_to_perturbation(np, what, got, perturbed):
    """Print a state_diffs triple beside the perturbed run's and return
    whether it is within SPREAD times it (the LM's limits the floor)."""
    (c_abs, c_max, c_med), (p_abs, p_max, p_med) = got, perturbed
    lim = (max(PARAM_ATOL, SPREAD * p_abs), max(STATE_RTOL, SPREAD * p_max),
           max(STATE_RTOL, SPREAD * p_med))
    print(f"  {what}: largest elementwise {c_abs:.3e}, relative rms "
          f"largest {c_max:.3e} median {c_med:.3e}; with images x (1 + "
          f"{PERTURB}): {p_abs:.3e}, {p_max:.3e}, {p_med:.3e}; limits "
          f"{lim[0]:.3e}, {lim[1]:.3e}, {lim[2]:.3e}")
    return c_abs <= lim[0] and c_max <= lim[1] and c_med <= lim[2]


def resnet_card_vs_cpu(np, torch, card, seed: int):
    """ResNet-50 at 64 px, batch 4, from one startup state on the card and
    on the CPU. This model is chaotic at init: moving its images by
    PERTURB (relative) moves its first-step gradients by a few % (rms),
    about as much as the card differs from the CPU. So the card is held
    to SPREAD times what that perturbation does on the CPU,
    with the LM's limits as the floor: the step-0 loss (the forward, from
    one state) within LOSS_RTOL; the first step's gradients, and the
    parameters' updates, velocities and running stats after two Momentum
    steps, as relative rms differences (the largest and the median over
    the vars) and elementwise. The second step's loss, one sample of the
    chaos, is printed beside the perturbed run's. The images are centred
    (the bench's uniform pixels less 0.5)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import resnet

    r = RESNET_REDUCED
    main_prog, startup = pt.Program(), pt.Program()
    main_prog.random_seed = startup.random_seed = seed
    with pt.program_guard(main_prog, startup):
        x = pt.layers.data("data", [3, r["image"], r["image"]])
        label = pt.layers.data("label", [1], dtype="int64")
        logits = resnet.resnet_imagenet(x, r["class_dim"], depth=50,
                                        head_act=None)
        predict = pt.layers.softmax(logits)
        avg = pt.layers.mean(pt.layers.softmax_with_cross_entropy(logits,
                                                                  label))
        pt.layers.accuracy(input=predict, label=label)
        pt.optimizer.MomentumOptimizer(learning_rate=RESNET["lr"],
                                       momentum=0.9).minimize(avg)
    params = [p.name for p in main_prog.global_block.all_parameters()]
    cpu, gpu = pt.Executor(pt.CPUPlace()), pt.Executor()
    scope0 = pt.Scope()
    cpu.run(startup, scope=scope0)
    names = sorted(scope0.local_var_names())
    start = {n: scope0.get_numpy(n) for n in names}
    runs = {"cpu": cpu, "card": gpu, "cpu, perturbed": cpu}
    losses, grads, ends = {k: [] for k in runs}, {}, {}
    for key, exe in runs.items():
        sc = pt.Scope()
        for n in names:
            sc.set_var(n, scope0.find_var(n).to(exe.device, copy=True))
        for i in range(2):
            feed = resnet_varied(np, i, r["batch"], r["image"], center=0.5)
            if key == "cpu, perturbed":
                feed["data"] = feed["data"] * np.float32(1 + PERTURB)
            out = exe.run(main_prog, feed=feed, fetch_list=[avg] + (
                [p + "@GRAD" for p in params] if i == 0 else []), scope=sc)
            losses[key].append(float(out[0][0]))
            if i == 0:
                grads[key] = dict(zip(params, out[1:]))
        ends[key] = {n: sc.get_numpy(n) for n in names}

    measured = {what: {key: state_diffs(np, src[key], src["cpu"], base,
                                        params)
                       for key in ("card", "cpu, perturbed")}
                for what, src, base in (("first-step gradients", grads,
                                         None),
                                        ("state after 2 steps", ends,
                                         start))}
    loss0 = abs(losses["card"][0] - losses["cpu"][0])
    print(f"card vs CPU, ResNet-50 at {r['image']} px, batch {r['batch']}, 2 "
          f"Momentum steps: losses {losses}; step-0 loss diff {loss0:.3e} "
          f"(tol rtol {LOSS_RTOL}) [{card}]")
    bad = [] if loss0 <= LOSS_RTOL * abs(losses["cpu"][0]) else [
        "step-0 loss"]
    for what, m in measured.items():
        if not hold_to_perturbation(np, f"{what}, card - CPU", m["card"],
                                    m["cpu, perturbed"]):
            bad.append(what)
    if bad:
        raise RuntimeError(f"ResNet card and CPU disagree beyond the "
                           f"chaos of a {PERTURB} input change: {bad}")


def build_resnet50_bf16(pt, seed):
    """The bench's bf16 program through the user's entry point
    (resnet.get_model(dtype="bfloat16"): a bfloat16 data var, float32
    masters), and its fused form as the Executor runs it."""
    from paddle_tpu_torch.analysis import fuse
    from paddle_tpu_torch.models import resnet

    main_prog, startup = pt.Program(), pt.Program()
    main_prog.random_seed = startup.random_seed = seed
    with pt.program_guard(main_prog, startup):
        avg, acc, predict, _ = resnet.get_model(
            data_set=RESNET["data_set"], depth=RESNET["depth"],
            dtype="bfloat16", fused_xent=True, learning_rate=RESNET["lr"])
    fused = fuse.maybe_fuse(main_prog, protect=[avg.name, acc.name])
    return dict(main=main_prog, startup=startup, avg=avg, acc=acc,
                predict=predict, fused=fused)


def resnet_bf16_path(np, torch, fc, card, built, seed: int):
    """Phase 19: ResNet-50 trained in bf16 at full width, as the bench's
    bf16 program and as phase 7's float32 program under amp_dtype
    "bfloat16", with phase 7's float32 step timed in the same run.
    Returns the bf16 epilogue kernels' launch counts of both runs."""
    import paddle_tpu_torch as pt

    b, img = RESNET["batch"], RESNET["image"]
    bf = build_resnet50_bf16(pt, seed)
    exe = pt.Executor()
    # phase 7's feed, float32, uploaded once: the Executor casts the
    # images to the bf16 data var's dtype at each step
    feed = {k: torch.from_numpy(v).to(exe.device)
            for k, v in resnet_varied(np, 0, b, img).items()}
    names = EPILOGUE_KERNELS + EPILOGUE_BF16_KERNELS
    per_step = {k + "_bf16": v for k, v in
                epilogue_launches_per_step(bf["fused"]).items()}
    for name in names:
        getattr(fc, name).launches = 0

    def train(main_prog, startup, avg, acc, what):
        """A fresh scope: startup, a warm-up and RESNET_STEPS timed steps;
        (scope, losses, ms a step, launches of the steps, peak GB)."""
        scope = pt.Scope()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        exe.run(startup, scope=scope)
        before = {k: getattr(fc, k).launches for k in names}
        losses, accs, step_s = [], [], []
        for _ in range(1 + RESNET_STEPS):
            t0 = time.perf_counter()
            loss, a = exe.run(main_prog, feed=feed, fetch_list=[avg, acc],
                              scope=scope)
            step_s.append(time.perf_counter() - t0)
            losses.append(float(loss[0]))
            accs.append(float(a[0]))
        launches = {k: getattr(fc, k).launches - before[k] for k in names}
        ms = 1e3 * sum(step_s[1:]) / RESNET_STEPS
        peak = torch.cuda.max_memory_allocated() / 1e9
        print(f"{what}: losses {losses}, accuracies {accs}, warm-up step "
              f"{1e3 * step_s[0]:.1f} ms, {RESNET_STEPS} timed steps "
              f"{[round(1e3 * x, 1) for x in step_s[1:]]} ms: {ms:.3f} ms "
              f"per step, {b / ms * 1e3:.1f} images/s, peak memory "
              f"{peak:.2f} GB [{card}]")
        return scope, losses, ms, launches, peak

    def classes_of(what, main_prog, scope):
        """One step's launches and device ms by kernel class."""
        n_launch, dev_ms, classes = launch_profile(torch, lambda: exe.run(
            main_prog, feed=feed, fetch_list=[], scope=scope))
        print(f"{what}, one step profiled: {n_launch} kernel launches, "
              f"device {dev_ms:.3f} ms: " + ", ".join(
                  f"{c} {m:.3f} ms / {k}" for c, (k, m) in
                  sorted(classes.items(), key=lambda kv: -kv[1][1]))
              + f" [{card}]")

    def hold(what, scope, losses, launches):
        print(f"{what} launches: {launches}")
        want = {k: per_step.get(k, 0) * (1 + RESNET_STEPS) for k in names}
        if launches != want:
            raise RuntimeError(f"epilogue launches {launches} on the {what}"
                               f" path, expected {want} (the fused "
                               f"program's fused_conv2d counts x "
                               f"{1 + RESNET_STEPS} steps in bf16, none in "
                               f"float32)")
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise RuntimeError(f"{what} losses are not finite and falling: "
                               f"{losses}")
        # parameters, velocities, running stats: every float state float32
        wide = [n for n in scope.local_var_names()
                if scope.find_var(n).is_floating_point()
                and scope.find_var(n).dtype != torch.float32]
        if wide:
            raise RuntimeError(f"{what}: state no longer float32: {wide}")

    what = "resnet bf16 program (bench's TPU arm)"
    scope, losses, ms_bf16, launches, peak = train(
        bf["main"], bf["startup"], bf["avg"], bf["acc"], what)
    hold(what, scope, losses, launches)
    total = {k: launches[k] for k in EPILOGUE_BF16_KERNELS}
    run = lambda: exe.run(bf["main"], feed=feed, fetch_list=[bf["avg"]],
                          scope=scope)
    classes_of("bf16 ResNet-50 step", bf["main"], scope)
    wall, by_name, _ = profiled(torch, run, 1)
    print_profile(f"bf16 ResNet-50 training step (batch {b}, {img} px)",
                  wall, by_name, card)
    name = bf["predict"].name
    test = bf["main"].clone(for_test=True).prune([name])
    pred, = exe.run(test, feed={"data": feed["data"]}, fetch_list=[name],
                    scope=scope, return_numpy=False)
    if not (bool(torch.isfinite(pred.float()).all())
            and tuple(pred.shape) == (b, 1000)):
        raise RuntimeError("the bf16 program's inference clone gives "
                           "predictions that are not finite")
    print(f"bf16 inference clone (BN folded into bf16 filters): "
          f"predictions {tuple(pred.shape)} {pred.dtype}, finite [{card}]")
    del scope, pred
    # phase 7's float32 step in this run: the same feed, a fresh scope
    scope, f32_losses, ms_f32, _, peak_f32 = train(
        built["main"], built["startup"], built["avg"], built["acc"],
        "phase 7's float32 program in this run")
    classes_of("float32 ResNet-50 step (phase 7's program)", built["main"],
               scope)
    del scope
    print(f"bf16 program {ms_bf16:.3f} ms a step against float32 "
          f"{ms_f32:.3f}: {ms_f32 / ms_bf16:.3f}x its speed; peak memory "
          f"{peak:.2f} against {peak_f32:.2f} GB [{card}]")
    # the float32 program under AMP (float32 feeds and parameter leaves
    # cast to bf16 at the step's entry)
    built["main"].amp_dtype = "bfloat16"
    try:
        what = "resnet AMP (phase 7's program, amp_dtype bfloat16)"
        scope, losses, ms_amp, launches, _ = train(
            built["main"], built["startup"], built["avg"], built["acc"],
            what)
        hold(what, scope, losses, launches)
        classes_of("AMP ResNet-50 step", built["main"], scope)
    finally:
        built["main"].amp_dtype = None
    del scope
    print(f"AMP step {ms_amp:.3f} ms against the bf16 program's "
          f"{ms_bf16:.3f} and float32's {ms_f32:.3f} [{card}]")
    return {k: total[k] + launches[k] for k in EPILOGUE_BF16_KERNELS}


def build_resnet_cut(pt, seed, dtype, blocks=RESNET_BF16_BLOCKS):
    """Phase 20's program: ResNet-50's stem and four stages at full width
    (bottleneck blocks, 64-512 x 4 channels), `blocks` blocks a stage
    ((3, 4, 6, 3) is ResNet-50's full depth), RESNET_REDUCED's image and
    classes, Momentum at RESNET's lr,
    the data var in `dtype`. Each build takes fresh name counters, so the
    float32 and the bf16 program name their parameters alike."""
    from paddle_tpu_torch.core.program import unique_name_guard
    from paddle_tpu_torch.models import resnet

    r = RESNET_REDUCED
    main_prog, startup = pt.Program(), pt.Program()
    main_prog.random_seed = startup.random_seed = seed
    with unique_name_guard(), pt.program_guard(main_prog, startup):
        x = pt.layers.data("data", [3, r["image"], r["image"]], dtype=dtype)
        label = pt.layers.data("label", [1], dtype="int64")
        h = resnet.conv_bn_layer(x, 64, 7, 2, 3)
        h = pt.layers.pool2d(h, pool_type="max", pool_size=3, pool_stride=2,
                             pool_padding=1)
        for i, (width, count) in enumerate(zip((64, 128, 256, 512),
                                               blocks)):
            h = resnet.layer_warp(resnet.bottleneck, h, width, count,
                                  1 if i == 0 else 2)
        h = pt.layers.pool2d(h, pool_size=7, pool_type="avg",
                             global_pooling=True)
        logits = pt.layers.fc(h, size=r["class_dim"])
        avg = pt.layers.mean(pt.layers.softmax_with_cross_entropy(logits,
                                                                  label))
        pt.optimizer.MomentumOptimizer(learning_rate=RESNET["lr"],
                                       momentum=0.9).minimize(avg)
    return main_prog, startup, avg


def resnet_bf16_card_vs_cpu(np, torch, card, seed: int):
    """Phase 20: build_resnet_cut's program as a bf16 program, two
    Momentum steps from one startup state on the card and on the CPU,
    beside the float32 program's two steps on the CPU from the same state
    and images. Readings, each the card's bf16 run against the CPU's: the
    step-0 loss (relative), within AMP_LOSS_RTOL; the first-step
    gradients (the relative rms of all of them together, and the median
    over the parameters of each one's), the parameters' updates after
    two steps (the same two) and the running stats (together). Each of
    these is held within BF16_SPREAD times the CPU float32 run's reading
    against the CPU's bf16 run, and each such limit must come out under
    BF16_CEILING. Every master stays float32. The images are centred."""
    import paddle_tpu_torch as pt

    r = RESNET_REDUCED
    progs = {dtype: build_resnet_cut(pt, seed, dtype)
             for dtype in ("bfloat16", "float32")}
    main_prog, startup, _ = progs["bfloat16"]
    params = [p.name for p in main_prog.global_block.all_parameters()]
    cpu, gpu = pt.Executor(pt.CPUPlace()), pt.Executor()
    scope0 = pt.Scope()
    cpu.run(startup, scope=scope0)
    names = sorted(scope0.local_var_names())
    start = {n: scope0.get_numpy(n) for n in names}
    stats = [n for n in names if n not in params and "velocity" not in n
             and "learning_rate" not in n]
    runs = {"cpu": (cpu, "bfloat16"), "card": (gpu, "bfloat16"),
            "cpu, float32": (cpu, "float32")}
    losses, grads, ends = {k: [] for k in runs}, {}, {}
    for key, (exe, dtype) in runs.items():
        prog, _, avg = progs[dtype]
        sc = pt.Scope()
        for n in names:
            sc.set_var(n, scope0.find_var(n).to(exe.device, copy=True))
        for i in range(2):
            feed = resnet_varied(np, i, r["batch"], r["image"], center=0.5)
            out = exe.run(prog, feed=feed, fetch_list=[avg] + (
                [p + "@GRAD" for p in params] if i == 0 else []), scope=sc)
            losses[key].append(float(out[0][0]))
            if i == 0:
                grads[key] = dict(zip(params, out[1:]))
        wide = [p for p in params if sc.find_var(p).dtype != torch.float32]
        if wide:
            raise RuntimeError(f"masters no longer float32 ({key}): {wide}")
        ends[key] = {n: sc.get_numpy(n) for n in names}
    if not all(np.isfinite(v).all() for v in losses.values()):
        raise RuntimeError(f"bf16 ResNet losses are not finite: {losses}")

    def rel(a, b):
        return rms(np, a - b) / rms(np, b)

    def together(got, want, keys, base=None):
        def cat(d):
            return np.concatenate([(d[n] - (0 if base is None else base[n]))
                                   .ravel() for n in keys])
        return rel(cat(got), cat(want))

    def readings(key):
        g, wg = grads[key], grads["cpu"]
        e, we = ends[key], ends["cpu"]
        return {"gradients": together(g, wg, params),
                "gradients, median": float(np.median(
                    [rel(g[p], wg[p]) for p in params])),
                "updates": together(e, we, params, start),
                "updates, median": float(np.median(
                    [rel(e[p] - start[p], we[p] - start[p])
                     for p in params])),
                "running stats": together(e, we, stats)}

    loss0 = abs(losses["card"][0] - losses["cpu"][0]) / abs(losses["cpu"][0])
    card_r, f32_r = readings("card"), readings("cpu, float32")
    print(f"card vs CPU, bf16 ResNet-50 cut to {RESNET_BF16_BLOCKS} blocks "
          f"a stage, {r['image']} px, batch {r['batch']}, 2 Momentum steps: "
          f"losses {losses}; step-0 loss {loss0:.3e} relative (tol "
          f"{AMP_LOSS_RTOL}) [{card}]")
    bad = [] if loss0 <= AMP_LOSS_RTOL else ["step-0 loss"]
    for k, got in card_r.items():
        lim = BF16_SPREAD * f32_r[k]
        print(f"  {k}: card - CPU {got:.4e} relative rms; CPU float32 - "
              f"CPU bf16 {f32_r[k]:.4e}; limit {lim:.4e} (ceiling "
              f"{BF16_CEILING})")
        if not (got <= lim < BF16_CEILING):
            bad.append(k)
    if bad:
        raise RuntimeError(f"bf16 ResNet card and CPU disagree beyond "
                           f"{BF16_SPREAD} x what bf16 does against "
                           f"float32, or the limit reached "
                           f"{BF16_CEILING}: {bad}")


def chain_stat_names(prog):
    """The stat outputs of the fused_bottleneck ops of `prog` that the
    chain's gate takes at RESNET's image (declared H·W >= CHAIN_MIN_S:
    the 10 rest blocks at 56², 28² and 14²), op by op, slot by slot."""
    from paddle_tpu_torch.ops.fused_ops import CHAIN_MIN_S

    block = prog.global_block
    slots = [slot.format(k=k) for k in "123" for slot in
             ("MeanOut{k}", "VarOut{k}", "SavedMean{k}", "SavedVar{k}")]
    return [op.output(slot)[0] for op in block.ops
            if op.type == "fused_bottleneck"
            and math.prod(block.var(op.input("X")[0]).shape[2:])
            >= CHAIN_MIN_S for slot in slots]


def bf16_forward_runs(np, pt, exe, bf, built, feed):
    """Training-mode forwards of ResNet-50 pruned to its loss and
    accuracy, from one startup state: the bf16 program's (bf, from
    build_resnet50_bf16), its float32 masters and running stats loaded
    by position into the float32 program (built, phase 7's). Returns
    run(what, restore=True, with_stats=True, data=None) for what in
    "float32" (the float32 program composed), "bf16" (the bf16 program
    composed) and "chain" (the bf16 program with PT_FUSED_BLOCK=always):
    (loss, the per-image losses whose mean it is, [stat outputs]), the
    stat outputs chain_stat_names' (running stats as their update this
    forward); data: other images. The caller restores PT_FUSED_BLOCK."""
    progs = {k: d["main"].prune([d["avg"].name, d["acc"].name])
             for k, d in (("float32", built), ("bf16", bf))}
    loss_of = {"float32": built["avg"].name, "bf16": bf["avg"].name}
    # the per-image cross-entropies: the input of the mean that is the loss
    terms_of = {k: next(op.input("X")[0] for op in p.global_block.ops
                        if op.type == "mean"
                        and op.output("Out")[0] == loss_of[k])
                for k, p in progs.items()}
    names = {k: [n for n, v in p.global_block.vars.items() if v.persistable]
             for k, p in progs.items()}
    scope = pt.Scope()
    exe.run(bf["startup"], scope=scope)
    state = {"bf16": {n: scope.find_var(n).clone() for n in names["bf16"]}}
    state["float32"] = {f: state["bf16"][b]
                        for f, b in zip(names["float32"], names["bf16"])}
    if len(names["float32"]) != len(names["bf16"]) or any(
            tuple(progs["float32"].global_block.var(f).shape)
            != tuple(progs["bf16"].global_block.var(b).shape)
            for f, b in zip(names["float32"], names["bf16"])):
        raise RuntimeError("the float32 and bf16 programs' state does not "
                           "match by position")
    stats = {k: chain_stat_names(p) for k, p in progs.items()}

    def run(what, restore=True, with_stats=True, data=None):
        """data: other images than the feed's."""
        key = "float32" if what == "float32" else "bf16"
        if restore:
            for n, v in state[key].items():
                scope.set_var(n, v.clone())
        os.environ["PT_FUSED_BLOCK"] = "always" if what == "chain" \
            else "never"
        fetch = [loss_of[key], terms_of[key]] + (stats[key] if with_stats
                                                 else [])
        got = exe.run(progs[key], feed=feed if data is None else dict(
            feed, data=data), fetch_list=fetch, scope=scope)
        vals = [np.asarray(v, np.float32) - (
                    state[key][n].float().cpu().numpy() if n in state[key]
                    else 0) for n, v in zip(stats[key], got[2:])]
        return float(got[0][0]), np.asarray(got[1], np.float32), vals

    return run


def forward_distance(np, got, want):
    """(loss relative difference, the per-image losses' relative rms
    difference, the stat outputs' largest relative rms difference, their
    median) of one forward against another."""
    rel = [rms(np, g - w) / max(rms(np, w), 1e-30)
           for g, w in zip(got[2], want[2])]
    return (abs(got[0] - want[0]) / abs(want[0]),
            rms(np, got[1] - want[1]) / rms(np, want[1]), max(rel),
            float(np.median(rel)))


def resnet_bf16_chain_path(np, torch, fb, card, built, seed: int):
    """Phase 21: the bench's bf16 program (build_resnet50_bf16) pruned to
    its loss and accuracy, its training-mode forward at full width from
    one startup state through the composition and through the chain
    (PT_FUSED_BLOCK=always), whose gate takes the 10 rest blocks at 56²,
    28² and 14² through the four bf16 chain kernels; the float32 program
    composed, from the same state, is the reference. Returns the bf16
    chain kernels' launch counts of the phase."""
    import paddle_tpu_torch as pt

    b, img = RESNET["batch"], RESNET["image"]
    bf = build_resnet50_bf16(pt, seed)
    exe = pt.Executor()
    feed = {k: torch.from_numpy(v).to(exe.device)
            for k, v in resnet_varied(np, 0, b, img).items()}
    names = CHAIN_BF16_KERNELS + CHAIN_KERNELS
    prev = os.environ.get("PT_FUSED_BLOCK")
    try:
        run = bf16_forward_runs(np, pt, exe, bf, built, feed)
        f32, comp = run("float32"), run("bf16")
        for name in names:
            getattr(fb, name).launches = 0
        chain = run("chain")
        n_fwd = 1
        comp_r, chain_r = forward_distance(np, comp, f32), \
            forward_distance(np, chain, f32)
        print(f"bf16 chain path: ResNet-50 bf16 training-mode forward, batch"
              f" {b}, {img} px, {CHAIN_BLOCKS} rest blocks through the chain"
              f", {len(chain[2])} stat outputs (running stats as their "
              f"updates): loss float32 {f32[0]!r}, bf16 composition "
              f"{comp[0]!r}, bf16 chain {chain[0]!r}; relative to float32 "
              f"{comp_r[0]:.4e} and {chain_r[0]:.4e} (tol {AMP_LOSS_RTOL})"
              f" [{card}]")
        # the loss, one number, is a sample of bf16's noise: held to the
        # AMP limit, as phase 20 holds its step-0 loss; its per-image terms
        # and the stat outputs, aggregates, to the composition's reading
        bad = [] if chain_r[0] <= AMP_LOSS_RTOL else ["loss"]
        for what, c_r, k_r in zip(
                ("per-image losses' relative rms",
                 "stat outputs' largest relative rms",
                 "stat outputs' median relative rms"), comp_r[1:],
                chain_r[1:]):
            lim = BF16_SPREAD * c_r
            print(f"  {what}: bf16 composition - float32 {c_r:.4e}; bf16 "
                  f"chain - float32 {k_r:.4e}; limit {lim:.4e} "
                  f"({BF16_SPREAD} x the composition's; ceiling "
                  f"{BF16_CEILING})")
            if not (np.isfinite(k_r) and k_r <= lim < BF16_CEILING):
                bad.append(what)
        if bad:
            raise RuntimeError(f"the bf16 chain's training-mode forward sits"
                               f" beyond its limits (the loss "
                               f"{AMP_LOSS_RTOL}, the rest {BF16_SPREAD} x "
                               f"the bf16 composition's distance from "
                               f"float32), or a limit reached "
                               f"{BF16_CEILING}: {bad}")
        times = {"bf16": [], "chain": []}
        for what in times:
            run(what, restore=False, with_stats=False)
        n_fwd += 1
        for _ in range(CHAIN_FORWARDS):
            for what in times:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run(what, restore=False, with_stats=False)
                torch.cuda.synchronize()
                times[what].append(time.perf_counter() - t0)
        n_fwd += CHAIN_FORWARDS
        for what, label in (("bf16", "composition"), ("chain", "chain")):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            run(what, restore=False, with_stats=False)
            peak = torch.cuda.max_memory_allocated() / 1e9
            ms = 1e3 * sum(times[what]) / CHAIN_FORWARDS
            print(f"bf16 chain path: {label} forward {ms:.3f} ms "
                  f"({[round(1e3 * t, 2) for t in times[what]]}), "
                  f"{b / ms * 1e3:.1f} images/s, peak memory of one "
                  f"forward {peak:.2f} GB [{card}]")
        n_fwd += 1
        for what, label in (("bf16", "composition"), ("chain", "chain")):
            wall, by_name, _ = profiled(
                torch, lambda w=what: run(w, restore=False, with_stats=False),
                1)
            print_profile(f"bf16 ResNet-50 training-mode forward, {label} "
                          f"(batch {b}, {img} px)", wall, by_name, card)
        n_fwd += 2
        launches = {name: getattr(fb, name).launches for name in names}
    finally:
        if prev is None:
            os.environ.pop("PT_FUSED_BLOCK", None)
        else:
            os.environ["PT_FUSED_BLOCK"] = prev
    print(f"bf16 chain path launches over {n_fwd} chain forwards: "
          f"{launches}")
    for name, count in launches.items():
        want = CHAIN_BLOCKS * n_fwd if name in CHAIN_BF16_KERNELS else 0
        if count != want:
            raise RuntimeError(f"{name} was launched {count} times on the "
                               f"bf16 chain path, expected {want}")
    return {name: launches[name] for name in CHAIN_BF16_KERNELS}


def bf16_update_distance(np, got, want, which):
    """(largest, median) relative rms of each var's update against want's,
    over the vars that want moves of `which`: "stats" (the running stats,
    named .tmp_) or "params" (the parameters and velocities)."""
    rel = [rms(np, got[n] - w) / rms(np, w) for n, w in want.items()
           if rms(np, w) > 0 and (".tmp_" in n) == (which == "stats")]
    return max(rel), float(np.median(rel))


def build_chain_stage(pt, seed, dtype, cin, c, h):
    """Phase 22's program at one of CHAIN_SHAPES: a data var [cin, h, h]
    of `dtype` (the stage's block input), CHAIN_STAGE_BLOCKS rest blocks
    (fused_bottleneck, C c), global average pooling, an fc to 1000
    classes, softmax cross-entropy and Momentum at RESNET's lr. Fresh name
    counters, so the float32 and the bf16 program name their vars alike.
    (main, startup, loss)."""
    from paddle_tpu_torch.core.program import unique_name_guard

    main_prog, startup = pt.Program(), pt.Program()
    main_prog.random_seed = startup.random_seed = seed
    with unique_name_guard(), pt.program_guard(main_prog, startup):
        y = pt.layers.data("data", [cin, h, h], dtype=dtype)
        label = pt.layers.data("label", [1], dtype="int64")
        for _ in range(CHAIN_STAGE_BLOCKS):
            y = pt.layers.fused_bottleneck(y, ch_out=c)
        y = pt.layers.pool2d(y, pool_size=h, pool_type="avg",
                             global_pooling=True)
        logits = pt.layers.fc(y, size=1000)
        avg = pt.layers.mean(pt.layers.softmax_with_cross_entropy(logits,
                                                                  label))
        pt.optimizer.MomentumOptimizer(learning_rate=RESNET["lr"],
                                       momentum=0.9).minimize(avg)
    return main_prog, startup, avg


def bf16_chain_step_held(np, torch, fb, card, seed: int):
    """Phase 22's agreement, on build_chain_stage's program at each of
    CHAIN_SHAPES at RESNET's batch: one Momentum step from one startup
    state of the float32 program composed (the reference), the bf16
    program composed, the bf16 program through the chain, and the chain
    again with bwd_mid's tap gradients zeroed. The chain's loss within
    AMP_LOSS_RTOL of float32's; its updates (parameters and velocities;
    running stats; the largest and the median relative rms over the
    vars) within BF16_SPREAD times the bf16 composition's distance from
    float32, each limit under BF16_CEILING; the planted fault must fail
    those limits. Every master stays float32, each bf16 chain kernel is
    launched once a rest block a chain step and no float32 chain kernel
    at all."""
    import paddle_tpu_torch as pt

    n = RESNET["batch"]
    exe = pt.Executor()
    gen = torch.Generator(device=exe.device).manual_seed(seed + 22)
    kernels = CHAIN_BF16_KERNELS + CHAIN_BF16_BWD_KERNELS
    f32_kernels = CHAIN_KERNELS + CHAIN_BWD_KERNELS
    real_mid = fb.bwd_mid_bf16
    runs = (("float32", "float32", "never"), ("bf16", "bfloat16", "never"),
            ("chain", "bfloat16", "always"),
            ("chain without tap gradients", "bfloat16", "always"))

    def no_taps(*a):
        g1, dtaps, s1, q1 = real_mid(*a)
        return g1, torch.zeros_like(dtaps), s1, q1

    # the wrapper counts its launches on the name it is bound to
    no_taps.launches = 0
    prev = os.environ.get("PT_FUSED_BLOCK")
    failures = []
    try:
        for name in kernels + f32_kernels:
            getattr(fb, name).launches = 0
        for cin, c, h in CHAIN_SHAPES:
            progs = {dtype: build_chain_stage(pt, seed, dtype, cin, c, h)
                     for dtype in ("bfloat16", "float32")}
            scope0 = pt.Scope()
            exe.run(progs["float32"][1], scope=scope0)
            start = {k: scope0.find_var(k).clone()
                     for k in scope0.local_var_names()}
            del scope0
            # the block input after a ReLU: >= 0; labels over 1000 classes
            feed = {"data": torch.rand(n, cin, h, h, device=exe.device,
                                       generator=gen),
                    "label": torch.randint(0, 1000, (n, 1), device=exe.device,
                                           generator=gen)}
            got = {}
            for what, dtype, mode in runs:
                main_prog, _, avg = progs[dtype]
                sc = pt.Scope()
                for k, v in start.items():
                    sc.set_var(k, v.clone())
                os.environ["PT_FUSED_BLOCK"] = mode
                if what.endswith("tap gradients"):
                    fb.bwd_mid_bf16 = no_taps
                try:
                    loss, = exe.run(main_prog, feed=feed, fetch_list=[avg],
                                    scope=sc)
                finally:
                    fb.bwd_mid_bf16 = real_mid
                wide = [k for k in start if sc.find_var(k).is_floating_point()
                        and sc.find_var(k).dtype != torch.float32]
                if wide:
                    raise RuntimeError(f"{what}: state no longer float32: "
                                       f"{wide}")
                got[what] = (float(np.asarray(loss).ravel()[0]),
                             {k: sc.get_numpy(k) - start[k].cpu().numpy()
                              for k in start})
                del sc
            del feed
            failures += bf16_step_verdicts(np, got, f"Cin {cin}, C {c}, "
                                           f"{h}x{h}", card)
        launches = {name: getattr(fb, name).launches
                    for name in kernels + f32_kernels}
        launches["bwd_mid_bf16"] += no_taps.launches
    finally:
        if prev is None:
            os.environ.pop("PT_FUSED_BLOCK", None)
        else:
            os.environ["PT_FUSED_BLOCK"] = prev
    want_n = 2 * CHAIN_STAGE_BLOCKS * len(CHAIN_SHAPES)
    for name, count in launches.items():
        want = want_n if name in kernels else 0
        if count != want:
            raise RuntimeError(f"{name} was launched {count} times in the "
                               f"stage programs' chain steps, expected "
                               f"{want}")
    if failures:
        raise RuntimeError("; ".join(failures))


def bf16_step_verdicts(np, got, stage, card):
    """Prints the readings of one stage's four runs and returns what
    failed: the chain beyond a limit, or the chain without tap gradients
    within all of them."""
    loss_f, up_f = got["float32"]
    print(f"bf16 chain step held, stage {stage}: {CHAIN_STAGE_BLOCKS} rest "
          f"blocks, batch {RESNET['batch']}, one Momentum step from one "
          f"startup state: losses " + ", ".join(
              f"{k} {v[0]!r}" for k, v in got.items()) + f" [{card}]")
    comp = {which: bf16_update_distance(np, got["bf16"][1], up_f, which)
            for which in ("params", "stats")}
    verdicts = {}
    for what in ("chain", "chain without tap gradients"):
        loss, up = got[what]
        rel = abs(loss - loss_f) / abs(loss_f)
        bad = [] if np.isfinite(loss) and rel <= AMP_LOSS_RTOL else [
            "loss"]
        print(f"  {what}: loss relative to float32 {rel:.4e} (tol "
              f"{AMP_LOSS_RTOL}; the bf16 composition "
              f"{abs(got['bf16'][0] - loss_f) / abs(loss_f):.4e})")
        for which, label in (("params", "parameters and velocities"),
                             ("stats", "running stats")):
            mine = bf16_update_distance(np, up, up_f, which)
            for part, c_r, k_r in zip(("largest", "median"), comp[which],
                                      mine):
                lim = BF16_SPREAD * c_r
                print(f"  {what}: {label}' updates, {part} relative rms "
                      f"from float32 {k_r:.4e}; the bf16 composition's "
                      f"{c_r:.4e}; limit {lim:.4e} ({BF16_SPREAD} x it; "
                      f"ceiling {BF16_CEILING})")
                if not (np.isfinite(k_r) and k_r <= lim < BF16_CEILING):
                    bad.append(f"{label} {part}")
        verdicts[what] = bad
    out = []
    if verdicts["chain"]:
        out.append(f"stage {stage}: the bf16 chain's training step sits "
                   f"beyond its limits (the loss {AMP_LOSS_RTOL}, the "
                   f"updates {BF16_SPREAD} x the bf16 composition's "
                   f"distance from float32), or a limit reached "
                   f"{BF16_CEILING}: {verdicts['chain']}")
    if verdicts["chain without tap gradients"]:
        print(f"  the chain without tap gradients fails: "
              f"{verdicts['chain without tap gradients']}")
    else:
        out.append(f"stage {stage}: the limits pass a chain whose bwd_mid "
                   f"drops its tap gradients")
    return out


def slot_rrms(torch, got, want) -> float:
    """The largest relative rms over the slots (rows) of two [slots,
    vocab] logits: rms of the difference over rms of `want`."""
    got, want = got.float(), want.float()
    num = (got - want).square().mean(dim=-1)
    return float((num / want.square().mean(dim=-1)).sqrt().max())


def decode_bf16_path(np, torch, fa, card, seed: int):
    """Phase 23: phase 4's model served in bf16 at full width:
    transformer_decode_step built at its configuration, phase 4's
    weights (its float32 bundle exported again, for the prefill and the
    float32 step's weights) in a Scope cast by Float16Transpiler (the
    memory the Scope holds after the cast and its peak: no float32 copy
    stays beside the bf16 weights), resident bf16 pools seeded from the float32 bundle's
    prefill K/V of BF16_DECODE_PROMPTS, BF16_DECODE_STEPS greedy steps
    through Executor.run (6 launches of the bf16 paged kernel a step and
    none of the float32 one, the pools written in place, finite logits),
    the float32 step program on the same tokens and pools within
    BF16_DECODE_RTOL, a step whose pool write is skipped failing it, and
    ms a step and peak memory of both programs in turns. Returns the bf16
    kernel's launches of the greedy steps."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import io
    from paddle_tpu_torch.core.types import resolve_device
    from paddle_tpu_torch.models.transformer import (param_shapes,
                                                     transformer_decode_step)
    from paddle_tpu_torch.ops import attention_ops
    from paddle_tpu_torch.serving.decode import DecodeModel
    from paddle_tpu_torch.serving.decode.kv_cache import (
        block_table_row, blocks_for_tokens, write_prefill_pages)
    from paddle_tpu_torch.transpiler import Float16Transpiler

    t_phase = time.perf_counter()
    device = resolve_device()
    params = make_params(np, param_shapes, seed)
    with tempfile.TemporaryDirectory() as d:
        io.export_decode_model(d, MODEL, params=params,
                               length_buckets=BUCKETS, slots=SLOTS,
                               block_size=BLOCK, pool_blocks=POOL_BLOCKS)
        model = DecodeModel(d, device=device, warmup=False)
    nl, bs, mb = MODEL["n_layers"], model.block_size, model.max_blocks_per_seq
    main = pt.Program()
    with pt.program_guard(main, pt.Program()):
        logits, pools, feed_names = transformer_decode_step(
            MODEL["vocab_size"], slots=model.slots, block_size=bs,
            pool_blocks=model.pool_blocks, max_blocks_per_seq=mb,
            **{k: MODEL[k] for k in ("n_layers", "d_model", "n_heads",
                                     "d_ff", "max_context")})
    fetch = [logits.name] + [v.name for kv in pools for v in kv]
    prog32 = main.clone(for_test=True).prune(targets=fetch,
                                             feeds=feed_names)
    prog16 = prog32.clone(for_test=True)
    scope32 = pt.Scope()
    for name, t in model.prefill_model.state.items():
        scope32.set_var(name, t)

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    scope16 = io.scope_from_numpy(params, device)
    del params
    Float16Transpiler().transpile(prog16, scope16)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - base
    peak = torch.cuda.max_memory_allocated() - base
    weights = [scope16.find_var(n) for n in scope16.local_var_names()]
    w_bytes = sum(t.numel() * t.element_size() for t in weights)
    n_params = sum(t.numel() for t in weights)
    print(f"bf16 decode: {n_params / 1e6:.1f} M weights in the Scope, "
          f"dtypes {sorted({str(t.dtype) for t in weights})}, "
          f"{w_bytes / 1e9:.3f} GB; the Scope holds {held / 1e9:.3f} GB "
          f"on the card after Float16Transpiler, peak {peak / 1e9:.3f} GB "
          f"while casting [{card}]")
    if any(t.dtype != torch.bfloat16 for t in weights):
        raise RuntimeError("a weight in the Scope is not bf16")
    if held > w_bytes + (64 << 20):
        raise RuntimeError(f"{held / 1e9:.3f} GB held beside "
                           f"{w_bytes / 1e9:.3f} GB of bf16 weights: a "
                           "float32 copy stayed alive")

    # resident pools seeded from the float32 bundle's prefill
    rng = np.random.default_rng(seed + 5)
    shape = tuple(model._feed_meta[3]["shape"])
    pools16 = [torch.zeros(shape, dtype=torch.bfloat16, device=device)
               for _ in range(2 * nl)]
    pools32 = [torch.zeros(shape, dtype=torch.float32, device=device)
               for _ in range(2 * nl)]
    tables = np.zeros((model.slots, mb), np.int32)
    toks = np.zeros(model.slots, np.int64)
    lens = np.zeros(model.slots, np.int32)
    nxt = 1
    for i, n in enumerate(BF16_DECODE_PROMPTS):
        prompt = rng.integers(1, MODEL["vocab_size"], n).tolist()
        first, kv = model.prefill(prompt)
        blocks = list(range(nxt, nxt + blocks_for_tokens(
            n + BF16_DECODE_STEPS + 2 * BF16_DECODE_TIMED + 2, bs)))
        nxt += len(blocks)
        for j, (k_rows, v_rows) in enumerate(kv):
            for pl in (pools16, pools32):
                write_prefill_pages(pl[2 * j], blocks, k_rows, bs)
                write_prefill_pages(pl[2 * j + 1], blocks, v_rows, bs)
        tables[i] = block_table_row(blocks, mb)
        toks[i], lens[i] = int(np.argmax(first)), n + 1
    if nxt > model.pool_blocks:
        raise RuntimeError("the prompts do not fit the pool")
    names = [f"{kv}_cache_{j}" for j in range(nl) for kv in "kv"]
    exe = pt.Executor()

    def step(prog, scope, pl, tok, ln):
        feed = {"token_ids": tok, "context_lens": ln, "block_tables": tables}
        feed.update(zip(names, pl))
        return exe.run(prog, feed=feed, fetch_list=fetch, scope=scope,
                       return_numpy=False)

    # the greedy steps: the bf16 kernel's launches read around them
    record = []
    fa.paged_decode_attention.launches = 0
    fa.paged_decode_attention_bf16.launches = 0
    for _ in range(BF16_DECODE_STEPS):
        out = step(prog16, scope16, pools16, toks, lens)
        if not all(a is b for a, b in zip(out[1:], pools16)):
            raise RuntimeError("the bf16 step did not write its pools in "
                               "place")
        record.append((toks.copy(), lens.copy(), out[0]))
        toks = out[0].float().argmax(dim=-1).cpu().numpy()
        lens = lens + 1
    torch.cuda.synchronize()
    launches = {"paged_decode_attention_bf16":
                    fa.paged_decode_attention_bf16.launches,
                "paged_decode_attention": fa.paged_decode_attention.launches}
    print(f"bf16 decode launches over {BF16_DECODE_STEPS} greedy steps: "
          f"{launches}")
    if (launches["paged_decode_attention_bf16"] != nl * BF16_DECODE_STEPS
            or launches["paged_decode_attention"] != 0):
        raise RuntimeError(f"the bf16 step should launch the bf16 paged "
                           f"kernel {nl} times and the float32 one none")

    # the float32 program, teacher-forced on the same tokens
    readings, agree = [], []
    for tok, ln, l16 in record:
        if not bool(torch.isfinite(l16.float()).all()):
            raise RuntimeError("bf16 decode logits are not finite")
        l32 = step(prog32, scope32, pools32, tok, ln)[0]
        readings.append(slot_rrms(torch, l16, l32))
        agree.append(int((l16.float().argmax(-1) == l32.argmax(-1)).sum()))
    # a planted fault: the next step with its pool write skipped
    real = attention_ops.paged_kv_update
    attention_ops.paged_kv_update = lambda kp, vp, *a: (kp, vp)
    try:
        bad16 = step(prog16, scope16, pools16, toks, lens)[0]
    finally:
        attention_ops.paged_kv_update = real
    ok32 = step(prog32, scope32, pools32, toks, lens)[0]
    fault = slot_rrms(torch, bad16, ok32)
    print(f"bf16 decode vs the float32 program, teacher-forced: largest "
          f"relative rms over the slots by step "
          f"{[round(r, 5) for r in readings]} (limit {BF16_DECODE_RTOL}); "
          f"greedy tokens the same in {agree} of {model.slots} slots; a "
          f"step whose pool write is skipped {fault:.4f} [{card}]")
    if max(readings) > BF16_DECODE_RTOL:
        raise RuntimeError("bf16 decode logits outside the limit of the "
                           "float32 program's")
    if fault <= BF16_DECODE_RTOL:
        raise RuntimeError("a bf16 step that skips its pool write passes "
                           "the limit: the hold cannot see it")

    # ms a step and peak memory, the two programs in turns
    lens = lens + 1
    times = {"bf16": [], "float32": []}
    peaks = {"bf16": [], "float32": []}
    runs = {"bf16": (prog16, scope16, pools16),
            "float32": (prog32, scope32, pools32)}
    for which in ("bf16", "float32", "float32", "bf16"):
        prog, scope, pl = runs[which]
        step(prog, scope, pl, toks, lens)[0].cpu()
        torch.cuda.synchronize()
        at = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(BF16_DECODE_TIMED):
            step(prog, scope, pl, toks, lens)[0].cpu()
        times[which].append(1e3 * (time.perf_counter() - t0)
                            / BF16_DECODE_TIMED)
        peaks[which].append((torch.cuda.max_memory_allocated() - at) / 1e9)
    for which, (prog, scope, pl) in runs.items():
        wall, by_name, _ = profiled(
            torch, lambda: step(prog, scope, pl, toks, lens)[0].cpu(), 3)
        print_profile(f"{which} decode step program (Executor.run)", wall,
                      by_name, card)
    print(f"bf16 decode step: {[round(t, 3) for t in times['bf16']]} ms "
          f"against float32 {[round(t, 3) for t in times['float32']]} ms "
          f"(in turns bf16, float32, float32, bf16; Executor.run, logits "
          f"to the host); peak above the resident state "
          f"{max(peaks['bf16']):.3f} against {max(peaks['float32']):.3f} GB; resident pools "
          f"{sum(p.numel() * 2 for p in pools16) / 1e9:.3f} against "
          f"{sum(p.numel() * 4 for p in pools32) / 1e9:.3f} GB; phase wall "
          f"{time.perf_counter() - t_phase:.1f} s [{card}]")
    return {"paged_decode_attention_bf16":
                launches["paged_decode_attention_bf16"]}


def resnet_bf16_chain_train_path(np, torch, fb, card, built, seed: int):
    """Phase 22: bf16_chain_step_held's agreement on the cut program; then
    the bench's bf16 program (build_resnet50_bf16) trained at full width,
    composed and with PT_FUSED_BLOCK=always, whose gate takes the 10 rest
    blocks through the eight bf16 chain kernels, forward and backward: the
    chain's step-0 loss beside phase 7's float32 program's from the same
    masters, steps of each in turns, profiled steps, and phase 7's
    program under amp_dtype "bfloat16" through the chain. Returns the
    bf16 chain kernels' launch counts of the full-depth runs."""
    import paddle_tpu_torch as pt

    bf16_chain_step_held(np, torch, fb, card, seed)
    b, img = RESNET["batch"], RESNET["image"]
    bf = build_resnet50_bf16(pt, seed)
    exe = pt.Executor()
    # centred images, as phase 20 feeds them
    feed = {k: torch.from_numpy(v).to(exe.device)
            for k, v in resnet_varied(np, 0, b, img, center=0.5).items()}
    progs = {"float32": built, "bf16": bf}
    names = {k: [n for n, v in d["main"].global_block.vars.items()
                 if v.persistable] for k, d in progs.items()}
    scope0 = pt.Scope()
    exe.run(bf["startup"], scope=scope0)
    # the state the startup makes (parameters, velocities, running stats,
    # the learning rate), paired by position
    by_pos = {f: n for f, n in zip(names["float32"], names["bf16"])
              if scope0.find_var(n) is not None}
    start = {n: scope0.find_var(n).clone() for n in by_pos.values()}
    if len(names["float32"]) != len(names["bf16"]) or any(
            tuple(built["main"].global_block.var(f).shape)
            != tuple(bf["main"].global_block.var(n).shape)
            for f, n in by_pos.items()):
        raise RuntimeError("the float32 and bf16 programs' state does not "
                           "match by position")
    del scope0
    kernels = CHAIN_BF16_KERNELS + CHAIN_BF16_BWD_KERNELS
    f32_kernels = CHAIN_KERNELS + CHAIN_BWD_KERNELS
    prev = os.environ.get("PT_FUSED_BLOCK")

    def fresh(key):
        sc = pt.Scope()
        for f, n in by_pos.items():
            sc.set_var(n if key == "bf16" else f, start[n].clone())
        return sc

    def step(key, chain, sc):
        """One Momentum step; the loss fetch syncs."""
        os.environ["PT_FUSED_BLOCK"] = "always" if chain else "never"
        d = progs[key]
        loss, = exe.run(d["main"], feed=feed, fetch_list=[d["avg"]],
                        scope=sc)
        return float(loss[0])

    def float32_state(what, sc):
        wide = [n for n in sc.local_var_names()
                if sc.find_var(n).is_floating_point()
                and sc.find_var(n).dtype != torch.float32]
        if wide:
            raise RuntimeError(f"{what}: state no longer float32: {wide}")

    try:
        # the reference's step-0 loss from the same masters
        loss_f = step("float32", False, fresh("float32"))
        for name in kernels + f32_kernels:
            getattr(fb, name).launches = 0
        n_chain = 0
        # timing: a warm-up and RESNET_STEPS steps of each, in turns, each
        # on its own state; peak memory of each step, reset before it
        scopes = {False: fresh("bf16"), True: fresh("bf16")}
        losses = {False: [], True: []}
        times = {False: [], True: []}
        peak = {False: 0.0, True: 0.0}
        for i in range(1 + RESNET_STEPS):
            for chain_on in (False, True):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                losses[chain_on].append(step("bf16", chain_on,
                                             scopes[chain_on]))
                if i:
                    times[chain_on].append(time.perf_counter() - t0)
                peak[chain_on] = max(peak[chain_on],
                                     torch.cuda.max_memory_allocated() / 1e9)
        n_chain += 1 + RESNET_STEPS
        ms = {}
        for chain_on, what in ((False, "composition"), (True, "chain")):
            ms[chain_on] = 1e3 * sum(times[chain_on]) / RESNET_STEPS
            print(f"bf16 chain train path: {what} losses {losses[chain_on]},"
                  f" {RESNET_STEPS} timed steps "
                  f"{[round(1e3 * t, 2) for t in times[chain_on]]} ms: "
                  f"{ms[chain_on]:.3f} ms per step, "
                  f"{b / ms[chain_on] * 1e3:.1f} images/s, peak memory "
                  f"{peak[chain_on]:.2f} GB (both states resident) [{card}]")
        print(f"bf16 chain train path: chain {ms[True]:.3f} ms a step against"
              f" the bf16 composition's {ms[False]:.3f} ms, in turns "
              f"[{card}]")
        rel = {c: abs(losses[c][0] - loss_f) / abs(loss_f)
               for c in (False, True)}
        print(f"bf16 chain train path: step-0 loss float32 {loss_f!r}, bf16 "
              f"composition {losses[False][0]!r}, bf16 chain "
              f"{losses[True][0]!r}; relative to float32 {rel[False]:.4e} "
              f"and {rel[True]:.4e} (tol {AMP_LOSS_RTOL}) [{card}]")
        if not rel[True] <= AMP_LOSS_RTOL:
            raise RuntimeError(f"the bf16 chain's step-0 loss sits "
                               f"{rel[True]:.4e} from float32's, beyond "
                               f"{AMP_LOSS_RTOL}")
        if not (all(np.isfinite(losses[True]))
                and losses[True][-1] < losses[True][0]):
            raise RuntimeError(f"the bf16 chain's losses are not finite and "
                               f"falling: {losses[True]}")
        float32_state("bf16 chain steps", scopes[True])
        for chain_on, what in ((False, "composition"), (True, "chain")):
            wall, by_name, _ = profiled(
                torch, lambda c=chain_on: step("bf16", c, scopes[c]), 1)
            print_profile(f"bf16 ResNet-50 training step, {what} (batch {b},"
                          f" {img} px)", wall, by_name, card)
        n_chain += 2      # profiled() runs its step twice
        del scopes
        # phase 7's float32 program under AMP, through the chain
        built["main"].amp_dtype = "bfloat16"
        try:
            sc = fresh("float32")
            amp_losses, amp_s = [], []
            for _ in range(1 + RESNET_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                amp_losses.append(step("float32", True, sc))
                amp_s.append(time.perf_counter() - t0)
            n_chain += 1 + RESNET_STEPS
        finally:
            built["main"].amp_dtype = None
        amp_ms = 1e3 * sum(amp_s[1:]) / RESNET_STEPS
        print(f"bf16 chain train path: AMP (phase 7's program, amp_dtype "
              f"bfloat16) through the chain: losses {amp_losses}, "
              f"{RESNET_STEPS} timed steps "
              f"{[round(1e3 * t, 2) for t in amp_s[1:]]} ms: {amp_ms:.3f} "
              f"ms per step, {b / amp_ms * 1e3:.1f} images/s [{card}]")
        if not (all(np.isfinite(amp_losses))
                and amp_losses[-1] < amp_losses[0]):
            raise RuntimeError(f"the AMP chain's losses are not finite and "
                               f"falling: {amp_losses}")
        float32_state("AMP chain steps", sc)
        del sc
        launches = {name: getattr(fb, name).launches
                    for name in kernels + f32_kernels}
    finally:
        if prev is None:
            os.environ.pop("PT_FUSED_BLOCK", None)
        else:
            os.environ["PT_FUSED_BLOCK"] = prev
    print(f"bf16 chain train path launches over {n_chain} chain steps: "
          f"{launches}")
    for name, count in launches.items():
        want = CHAIN_BLOCKS * n_chain if name in kernels else 0
        if count != want:
            raise RuntimeError(f"{name} was launched {count} times on the "
                               f"bf16 chain's training path, expected {want}"
                               f" ({CHAIN_BLOCKS} a step in bf16, none in "
                               f"float32)")
    return {name: launches[name] for name in kernels}


def lstm_case(torch, t, b, h, lens, seed):
    """Inputs of the LSTM kernels on the card: x ~ N(0, 1) (a pre-projected
    input), W ~ U(+-sqrt(6 / (H + 4H))) (the model's Xavier init), small
    biases, initial states that are not zero, the mask of `lens` (None:
    full length), cotangents ~ N(0, 1)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    lim = (6.0 / (5 * h)) ** 0.5

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    w = (torch.rand(h, 4 * h, device="cuda", generator=gen) * 2 - 1) * lim
    if lens is None:
        mask = torch.ones(t, b, device="cuda")
    else:
        steps = torch.arange(t, device="cuda")[:, None]
        mask = (steps < torch.as_tensor(lens, device="cuda")[None, :]).float()
    return dict(x=randn(t, b, 4 * h), w=w, b=0.1 * randn(4 * h), mask=mask,
                r0=0.5 * randn(b, h), c0=randn(b, h), drs=randn(t, b, h),
                dcs=randn(t, b, h))


def lstm_plan_text(plan, other: str) -> str:
    return (other if plan is None else
            f"sequence kernel, row tiles of {16 * plan.mt}, {plan.nt} a "
            f"block, {plan.kb} k16 blocks a warp, grid {plan.grid}")


def check_lstm(np, torch, fl, card, seed: int):
    """The two LSTM kernels vs their plain versions at the bench shape,
    full length and ragged (lengths drawn in [1, T]); each timed beside
    its plain version, its bound and torch.nn.LSTM (cuDNN: the forward,
    and the backward less the forward; it also computes the input
    projection, so it is an upper yardstick). The kernels line reports
    the full-length shape."""
    t, b, h = LSTM["seq_len"], LSTM["batch"], LSTM["lstm_size"]
    rng = np.random.default_rng(seed + 11)
    ragged = rng.integers(1, t + 1, b)
    ragged[:2] = (1, t)
    rows, errs = {}, {"lstm_seq_fwd": [], "lstm_seq_bwd": []}
    for what, lens in (("full length", None), ("ragged", ragged.tolist())):
        d = lstm_case(torch, t, b, h, lens, seed + 12)
        fwd_args = [d[k] for k in ("x", "w", "b", "mask", "r0", "c0")]
        rs, cs = fl.lstm_seq_fwd(*fwd_args)
        rrs, rcs = fl.lstm_seq_fwd_reference(*fwd_args)
        torch.cuda.synchronize()
        errs["lstm_seq_fwd"].append(max(max_err(torch, rs, rrs),
                                        max_err(torch, cs, rcs)))
        fwd_share = max(limit_share(torch, rs, rrs),
                        limit_share(torch, cs, rcs))
        r_prevs = torch.cat([d["r0"][None], rrs[:-1]])
        c_prevs = torch.cat([d["c0"][None], rcs[:-1]])
        bwd_args = fwd_args[:4] + [r_prevs, c_prevs, d["drs"], d["dcs"]]
        got = fl.lstm_seq_bwd(*bwd_args)
        want = fl.lstm_seq_bwd_reference(*bwd_args)
        torch.cuda.synchronize()
        errs["lstm_seq_bwd"].append(max(
            max_err(torch, g, w_, BWD_ATOL, BWD_RTOL)
            for g, w_ in zip(got, want)))
        # the products this run's data needs: the rows a sequence reaches
        live = t * b if lens is None else int(sum(lens))
        prod = 2 * live * h * 4 * h
        # fwd: x, w, b, mask, r0, c0 in; rs, cs out. bwd: x, w, b, mask,
        # r_prevs, c_prevs, drs, dcs in; dx, dw, db, dr0, dc0 out
        f_bytes = 4 * (t * b * 4 * h + h * 4 * h + 4 * h + t * b + 2 * b * h
                       + 2 * t * b * h)
        b_bytes = 4 * (2 * t * b * 4 * h + 2 * h * 4 * h + 2 * 4 * h + t * b
                       + 4 * t * b * h + 2 * b * h)
        # the products run in 3xTF32, the forward's one and the
        # backward's three (the gates' recompute, dgates W^T, dW); the f32
        # bounds beside them
        bounds = {"lstm_seq_fwd": bound_ms(f_bytes, 3 * prod,
                                           TF32_FLOPS_PER_S),
                  "lstm_seq_bwd": bound_ms(b_bytes, 9 * prod,
                                           TF32_FLOPS_PER_S)}
        f32_fwd = bound_ms(f_bytes, prod)
        f32_bwd = bound_ms(b_bytes, 3 * prod)
        calls = {"lstm_seq_fwd": (lambda: fl.lstm_seq_fwd(*fwd_args),
                                  lambda: fl.lstm_seq_fwd_reference(
                                      *fwd_args)),
                 "lstm_seq_bwd": (lambda: fl.lstm_seq_bwd(*bwd_args),
                                  lambda: fl.lstm_seq_bwd_reference(
                                      *bwd_args))}
        ms = {k: cuda_ms(torch, f, 10) for k, (f, _) in calls.items()}
        # each kernel's CUDA launches a call (profiler) and its plan
        n_launch = {k: device_host(torch, f, 5, 1)[1]
                    for k, (f, _) in calls.items()}
        index = d["x"].device.index
        plan = lstm_plan_text(fl._plan_of(b, h, index), "step kernel")
        bwd_plan = lstm_plan_text(fl._bwd_plan_of(b, h, index),
                                  "per-step path, 2T + 4 launches")
        plain = {k: cuda_ms(torch, r, 3) for k, (_, r) in calls.items()}
        lstm = torch.nn.LSTM(h, h).cuda()
        inp = d["x"][:, :, :h].contiguous().requires_grad_(True)
        h0 = (d["r0"][None].contiguous(), d["c0"][None].contiguous())
        gout = d["drs"]
        lib_fwd = cuda_ms(torch, lambda: lstm(inp, h0), 10)
        lib_both = cuda_ms(torch, lambda: torch.autograd.grad(
            lstm(inp, h0)[0], [inp] + list(lstm.parameters()), gout), 10)
        lib = {"lstm_seq_fwd": lib_fwd, "lstm_seq_bwd": lib_both - lib_fwd}
        del lstm, inp
        print(f"lstm kernels T={t} B={b} H={h} {what} ({live} live rows): "
              f"fwd {ms['lstm_seq_fwd']:.4f} ms (plain "
              f"{plain['lstm_seq_fwd']:.4f}, nn.LSTM fwd "
              f"{lib['lstm_seq_fwd']:.4f}, bound "
              f"{bounds['lstm_seq_fwd'][0]:.4f} "
              f"{bounds['lstm_seq_fwd'][1]} by 3xTF32, f32 "
              f"{f32_fwd[0]:.4f} {f32_fwd[1]}; {n_launch['lstm_seq_fwd']} "
              f"launches a call, {plan}), bwd "
              f"{ms['lstm_seq_bwd']:.4f} ms (plain "
              f"{plain['lstm_seq_bwd']:.4f}, nn.LSTM bwd "
              f"{lib['lstm_seq_bwd']:.4f} [fwd+bwd {lib_both:.4f}], bound "
              f"{bounds['lstm_seq_bwd'][0]:.4f} "
              f"{bounds['lstm_seq_bwd'][1]} by 3xTF32, f32 "
              f"{f32_bwd[0]:.4f} {f32_bwd[1]}; "
              f"{n_launch['lstm_seq_bwd']} launches a call, "
              f"{bwd_plan}); "
              f"max_abs_err fwd {errs['lstm_seq_fwd'][-1]:.3e} (tol atol "
              f"{KERNEL_ATOL} rtol {KERNEL_RTOL}; {fwd_share:.4f} of the "
              f"limit), bwd "
              f"{errs['lstm_seq_bwd'][-1]:.3e} (tol atol {BWD_ATOL} rtol "
              f"{BWD_RTOL}) [{card}]")
        if lens is None:
            for k in calls:
                rows[k] = dict(ms=ms[k], plain_ms=plain[k],
                               bound_ms=bounds[k][0], bound_by=bounds[k][1],
                               library_ms=lib[k])
    for k in rows:
        rows[k]["max_abs_err"] = max(errs[k])
    return rows


def sum_share(torch, got, want) -> float:
    """The largest |got - want| over LSTM_SUM_REL max|want| + LSTM_SUM_REL
    |want| (1 is the limit); raises if got is not finite."""
    if not bool(torch.isfinite(got).all()):
        raise RuntimeError("bf16 kernel output is not finite")
    limit = LSTM_SUM_REL * want.abs().max() + LSTM_SUM_REL * want.abs()
    return float(((got - want).abs() / limit).max())


def check_lstm_bf16(np, torch, fl, card, seed: int):
    """The two bf16 LSTM kernels (csrc/fused_lstm_bf16.cu) vs their plain
    versions on the same bf16 inputs at the bench shape, full length and
    ragged (check_lstm's inputs and lengths, rounded to bf16); each timed
    beside its plain version, its bound at the bf16 tensor cores' rate
    and torch.nn.LSTM in bf16 (cuDNN: the forward, and the backward less
    the forward; it also computes the input projection, so it is an upper
    yardstick). Their CUDA launches a call (1 and 3) are held by
    tests/test_torch_gpu.py. The kernels line reports the full-length
    shape."""
    t, b, h = LSTM["seq_len"], LSTM["batch"], LSTM["lstm_size"]
    rng = np.random.default_rng(seed + 11)
    ragged = rng.integers(1, t + 1, b)
    ragged[:2] = (1, t)
    rows = {}
    errs = {k: [] for k in LSTM_BF16_KERNELS}
    shares = {k: [] for k in LSTM_BF16_KERNELS}
    for what, lens in (("full length", None), ("ragged", ragged.tolist())):
        d = {k: v.bfloat16() for k, v in
             lstm_case(torch, t, b, h, lens, seed + 12).items()}
        fwd_args = [d[k] for k in ("x", "w", "b", "mask", "r0", "c0")]
        rs, cs = fl.lstm_seq_fwd_bf16(*fwd_args)
        rrs, rcs = fl.lstm_seq_fwd_reference(*fwd_args)
        torch.cuda.synchronize()
        f_share = (bf16_share(torch, rs, rrs), bf16_share(torch, cs, rcs))
        r_prevs = torch.cat([d["r0"][None], rrs[:-1]])
        c_prevs = torch.cat([d["c0"][None], rcs[:-1]])
        bwd_args = fwd_args[:4] + [r_prevs, c_prevs, d["drs"], d["dcs"]]
        got = fl.lstm_seq_bwd_bf16(*bwd_args)
        want = fl.lstm_seq_bwd_reference(*bwd_args)
        torch.cuda.synchronize()
        b_share = (bf16_share(torch, got[0], want[0]),) + tuple(
            sum_share(torch, g, w_) for g, w_ in zip(got[1:], want[1:]))
        diff = lambda x, y: float((x.float() - y.float()).abs().max())
        errs["lstm_seq_fwd_bf16"].append(max(diff(rs, rrs), diff(cs, rcs)))
        errs["lstm_seq_bwd_bf16"].append(max(diff(g, w_) for g, w_ in
                                             zip(got, want)))
        shares["lstm_seq_fwd_bf16"].append(max(f_share))
        shares["lstm_seq_bwd_bf16"].append(max(b_share))
        if max(f_share + b_share) > 1:
            raise RuntimeError(f"the bf16 LSTM kernels ({what}) disagree "
                               f"with their plain versions: shares of the "
                               f"limits rs, cs {f_share}, dx, dw, db, dr0, "
                               f"dc0 {b_share}")
        # the products this run's data needs: the rows a sequence reaches
        live = t * b if lens is None else int(sum(lens))
        prod = 2 * live * h * 4 * h
        # bf16 in and out but for the backward's float32 dw, db, dr0, dc0
        f_bytes = 2 * (t * b * 4 * h + h * 4 * h + 4 * h + t * b + 2 * b * h
                       + 2 * t * b * h)
        b_bytes = (2 * (2 * t * b * 4 * h + h * 4 * h + 4 * h + t * b
                        + 4 * t * b * h)
                   + 4 * (h * 4 * h + 4 * h + 2 * b * h))
        bounds = {"lstm_seq_fwd_bf16": bound_ms(f_bytes, prod,
                                                BF16_FLOPS_PER_S),
                  "lstm_seq_bwd_bf16": bound_ms(b_bytes, 3 * prod,
                                                BF16_FLOPS_PER_S)}
        calls = {"lstm_seq_fwd_bf16": (
                     lambda: fl.lstm_seq_fwd_bf16(*fwd_args),
                     lambda: fl.lstm_seq_fwd_reference(*fwd_args)),
                 "lstm_seq_bwd_bf16": (
                     lambda: fl.lstm_seq_bwd_bf16(*bwd_args),
                     lambda: fl.lstm_seq_bwd_reference(*bwd_args))}
        ms = {k: cuda_ms(torch, f, 10) for k, (f, _) in calls.items()}
        plain = {k: cuda_ms(torch, r, 3) for k, (_, r) in calls.items()}
        index = d["x"].device.index
        plans = (fl._plan_of(b, h, index, torch.bfloat16),
                 fl._bwd_plan_of(b, h, index, torch.bfloat16))
        lstm = torch.nn.LSTM(h, h).cuda().bfloat16()
        inp = d["x"][:, :, :h].contiguous().requires_grad_(True)
        h0 = (d["r0"][None].contiguous(), d["c0"][None].contiguous())
        lib_fwd = cuda_ms(torch, lambda: lstm(inp, h0), 10)
        lib_both = cuda_ms(torch, lambda: torch.autograd.grad(
            lstm(inp, h0)[0], [inp] + list(lstm.parameters()), d["drs"]), 10)
        lib = {"lstm_seq_fwd_bf16": lib_fwd,
               "lstm_seq_bwd_bf16": lib_both - lib_fwd}
        del lstm, inp
        print(f"lstm bf16 kernels T={t} B={b} H={h} {what} ({live} live "
              f"rows): fwd {ms['lstm_seq_fwd_bf16']:.4f} ms (plain "
              f"{plain['lstm_seq_fwd_bf16']:.4f}, nn.LSTM bf16 fwd "
              f"{lib['lstm_seq_fwd_bf16']:.4f}, bound "
              f"{bounds['lstm_seq_fwd_bf16'][0]:.4f} "
              f"{bounds['lstm_seq_fwd_bf16'][1]} at "
              f"{BF16_FLOPS_PER_S / 1e12:.0f} TFLOP/s; "
              f"{lstm_plan_text(plans[0], 'none')}), bwd "
              f"{ms['lstm_seq_bwd_bf16']:.4f} ms (plain "
              f"{plain['lstm_seq_bwd_bf16']:.4f}, nn.LSTM bf16 bwd "
              f"{lib['lstm_seq_bwd_bf16']:.4f} [fwd+bwd {lib_both:.4f}], "
              f"bound {bounds['lstm_seq_bwd_bf16'][0]:.4f} "
              f"{bounds['lstm_seq_bwd_bf16'][1]}; "
              f"{lstm_plan_text(plans[1], 'none')}); largest shares of the "
              f"limits rs, cs {' / '.join(f'{x:.4f}' for x in f_share)} "
              f"(bf16 {BF16_REL}), dx {b_share[0]:.4f} (bf16 {BF16_REL}), "
              f"dw, db, dr0, dc0 "
              f"{' / '.join(f'{x:.4f}' for x in b_share[1:])} (sums "
              f"{LSTM_SUM_REL}); max_abs_err fwd "
              f"{errs['lstm_seq_fwd_bf16'][-1]:.3e}, bwd "
              f"{errs['lstm_seq_bwd_bf16'][-1]:.3e} [{card}]")
        if lens is None:
            for k in calls:
                rows[k] = dict(ms=ms[k], plain_ms=plain[k],
                               bound_ms=bounds[k][0], bound_by=bounds[k][1],
                               library_ms=lib[k])
    for k in rows:
        rows[k]["max_abs_err"] = max(errs[k])
    print("lstm bf16 kernels: largest share of the limits over both "
          "shapes, " + ", ".join(f"{k} {max(v):.4f}" for k, v in
                                 shares.items()) + f" [{card}]")
    return rows


def lstm_varied(np, i, batch, seqlen, vocab):
    """bench.py bench_lstm varied(i): random ids, the label the parity of
    the last word, drawn from a 16-token pool."""
    vrng = np.random.RandomState(5000 + i)
    words = vrng.randint(0, vocab, (batch, seqlen)).astype("int64")
    words[:, -1] = vrng.randint(0, 16, batch)
    label = (words[:, -1:] % 2).astype("int64")
    return {"words": words, "label": label}


def build_lstm(pt, cfg, seed):
    from paddle_tpu_torch.models import stacked_dynamic_lstm as sdl

    main_prog, startup = pt.Program(), pt.Program()
    main_prog.random_seed = startup.random_seed = seed
    with pt.program_guard(main_prog, startup):
        loss, acc, logit, _ = sdl.get_model(
            dict_size=cfg["dict_size"], lstm_size=cfg["lstm_size"],
            emb_dim=cfg["emb_dim"], use_fused=True)
    return main_prog, startup, loss, logit


LSTM_KERNELS = ("lstm_seq_fwd", "lstm_seq_bwd")
LSTM_BF16_KERNELS = ("lstm_seq_fwd_bf16", "lstm_seq_bwd_bf16")
# lstm_seq_bwd's kernels by name: the recurrence, the gates' recompute, dW
LSTM_BWD_PARTS = (("recurrence", "lstm_bwd_seq_kernel"),
                  ("gates", "lstm_bwd_gemm_tc_kernel<true>"),
                  ("dW", "lstm_bwd_gemm_tc_kernel<false>"))
LSTM_BF16_BWD_PARTS = (("recurrence", "lstm_bwd_seq_bf16_kernel"),
                       ("gates", "lstm_bwd_gemm_bf16_kernel<true>"),
                       ("dW", "lstm_bwd_gemm_bf16_kernel<false>"))


def lstm_bwd_parts(by_name: dict, kernel: str = "lstm_seq_bwd",
                   parts_of=LSTM_BWD_PARTS) -> dict:
    """{part: device ms} of the backward wrapper `kernel`'s kernels in a
    profile ("rest": the kernels of the per-step path)."""
    parts = dict.fromkeys([p for p, _ in parts_of] + ["rest"], 0.0)
    for name, ms in by_name.items():
        if kernel_class(name) != f"{kernel} (port kernel)":
            continue
        part = next((p for p, key in parts_of if key in name), "rest")
        parts[part] += ms
    return parts


def lstm_path(np, torch, fl, card, seed: int):
    """Full-width stacked-LSTM training through the Executor; returns the
    LSTM kernels' launch counts of the run (training steps and the
    inference clone)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core import registry

    b, t = LSTM["batch"], LSTM["seq_len"]
    main_prog, startup, loss, logit = build_lstm(pt, LSTM, seed)
    n_params = sum(int(np.prod(v.shape)) for v in
                   main_prog.global_block.all_parameters())
    exe, scope = pt.Executor(), pt.Scope()
    feed0 = lstm_varied(np, 0, b, t, LSTM["dict_size"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for name in LSTM_KERNELS:
        getattr(fl, name).launches = 0
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    state0 = {n: scope.find_var(n).clone() for n in scope.local_var_names()}

    def step(feed, sc=scope):
        return float(exe.run(main_prog, feed=feed, fetch_list=[loss],
                             scope=sc)[0][0])

    losses, step_s = [], []
    for _ in range(1 + LSTM_STEPS):
        t0 = time.perf_counter()
        losses.append(step(feed0))
        step_s.append(time.perf_counter() - t0)
    varied = [step(lstm_varied(np, i, b, t, LSTM["dict_size"]))
              for i in range(1, 1 + LSTM_STEPS)]
    rng = np.random.default_rng(seed + 13)
    lens = rng.integers(1, t + 1, b).astype(np.int32)
    lens[:2] = (1, t)
    ragged = dict(lstm_varied(np, 1 + LSTM_STEPS, b, t, LSTM["dict_size"]),
                  **{"words@SEQ_LEN": lens})
    ragged_loss = step(ragged)
    n_steps = 2 + 2 * LSTM_STEPS
    launches = {name: getattr(fl, name).launches for name in LSTM_KERNELS}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ms = 1e3 * sum(step_s[1:]) / LSTM_STEPS
    print(f"lstm path: stacked dynamic LSTM, {n_params} parameters, batch "
          f"{b}, sequence {t}, startup {t_init:.2f} s, losses on one feed "
          f"{losses}, warm-up step {1e3 * step_s[0]:.1f} ms, {LSTM_STEPS} "
          f"timed steps {[round(1e3 * x, 2) for x in step_s[1:]]} ms: "
          f"{ms:.3f} ms per step, {b * t / ms * 1e3:.1f} tokens/s, peak "
          f"memory {peak_gb:.2f} GB; losses on varied feeds 1-{LSTM_STEPS} "
          f"{varied}; ragged step (lengths {int(lens.min())}..."
          f"{int(lens.max())}, {int(lens.sum())} tokens) loss {ragged_loss} "
          f"[{card}]")
    print(f"lstm path launches over {n_steps} steps: {launches}")
    for name, n in launches.items():
        if n != n_steps:
            raise RuntimeError(f"{name} was launched {n} times on the LSTM "
                               f"path, expected {n_steps} (one a step)")
    every = losses + varied + [ragged_loss]
    # Adam at lr 1e-3 on one repeated batch fits it within a few steps and
    # can overshoot after that (see the plain replay below): the losses
    # must fall from the first, not every step
    if not all(np.isfinite(every)) or not min(losses[1:]) < losses[0]:
        raise RuntimeError(f"LSTM losses are not finite and falling on one "
                           f"feed: {every}")
    # the same steps from the same state through the plain path (the scan
    # in PyTorch ops, PT_FUSED_LSTM=never) on the card: the first loss is
    # one forward from one state
    replay = pt.Scope()
    for n, v in state0.items():
        replay.set_var(n, v)
    os.environ["PT_FUSED_LSTM"] = "never"
    try:
        plain = [step(feed0, replay) for _ in range(1 + LSTM_STEPS)]
    finally:
        del os.environ["PT_FUSED_LSTM"]
    del replay, state0
    print(f"lstm path, the same steps through the plain path (scan in "
          f"PyTorch ops): losses {plain}; largest relative loss diff "
          f"{max(abs(a - b) / abs(b) for a, b in zip(losses, plain)):.3e}, "
          f"first step {abs(losses[0] - plain[0]) / abs(plain[0]):.3e} (tol "
          f"rtol {LOSS_RTOL}) [{card}]")
    if not abs(losses[0] - plain[0]) <= LOSS_RTOL * abs(plain[0]):
        raise RuntimeError("the kernel path and the plain path disagree on "
                           "the first LSTM step")
    # Adam's kernels carry no name of their own: a record_function range
    # around each adam op attributes them
    adam = registry.get_op("adam")
    compute = adam.compute

    def labelled(ctx, ins, attrs):
        with torch.profiler.record_function("adam op"):
            return compute(ctx, ins, attrs)

    adam.compute = labelled
    try:
        # a profile that holds no recurrence kernel lost its events: it is
        # taken again, up to three times
        for _ in range(3):
            wall, by_name, by_label = profiled(torch, lambda: step(feed0), 1,
                                               labels=("adam op",))
            bwd = lstm_bwd_parts(by_name)
            if bwd["recurrence"] > 0:
                break
    finally:
        adam.compute = compute
    adam_ms = by_label.get("adam op", 0.0)
    print_profile(f"LSTM training step (batch {b}, sequence {t})", wall,
                  by_name, card,
                  carved={"Adam (9 adam ops)": adam_ms} if adam_ms else None)
    if not adam_ms:
        print("  Adam (9 adam ops): not measured (the profiler attributed "
              "no device time to the adam op ranges)")
    print("  lstm_seq_bwd's parts: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in bwd.items()) + f" [{card}]")
    if not bwd["recurrence"] > 0:
        raise RuntimeError("the LSTM step's profile shows no device time in "
                           "the backward's recurrence (lstm_bwd_seq_kernel)")
    name = logit.name
    test = main_prog.clone(for_test=True).prune([name])
    before = fl.lstm_seq_fwd.launches
    pred, = exe.run(test, feed={"words": feed0["words"]}, fetch_list=[name],
                    scope=scope, return_numpy=False)
    rows_ok = bool(((pred.sum(dim=1) - 1).abs() <= 1e-5).all())
    acc = float((pred.argmax(1).cpu().numpy()
                 == feed0["label"][:, 0]).mean())
    print(f"lstm inference clone: predictions {tuple(pred.shape)}, finite "
          f"{bool(torch.isfinite(pred).all())}, rows sum to 1 within 1e-5: "
          f"{rows_ok}, accuracy on the training feed {acc:.3f} "
          f"(information), forward launches {fl.lstm_seq_fwd.launches - before}"
          f" [{card}]")
    if not (bool(torch.isfinite(pred).all()) and rows_ok
            and tuple(pred.shape) == (b, 2)
            and fl.lstm_seq_fwd.launches == before + 1):
        raise RuntimeError("the LSTM inference clone did not give finite "
                           "probabilities through the forward kernel")
    launches["lstm_seq_fwd"] += 1
    return launches


def lstm_ragged_feed(np, i, cfg):
    rng = np.random.RandomState(9000 + i)
    lens = rng.randint(1, cfg["seq_len"] + 1, cfg["batch"])
    lens[0], lens[1] = 1, cfg["seq_len"]
    words = [rng.randint(0, cfg["dict_size"], (n, 1)).astype("int64")
             for n in lens]
    return {"words": words,
            "label": rng.randint(0, 2, (cfg["batch"], 1)).astype("int64")}


def lstm_card_vs_cpu(np, torch, card, seed: int):
    """The reduced LSTM from one startup state: two Adam steps on ragged
    list feeds on the card (the kernels) and on the CPU (their plain
    versions) agree at the LM's limits."""
    import paddle_tpu_torch as pt

    main_prog, startup, loss, _ = build_lstm(pt, LSTM_REDUCED, seed)
    cpu, gpu = pt.Executor(pt.CPUPlace()), pt.Executor()
    cpu_scope, gpu_scope = pt.Scope(), pt.Scope()
    cpu.run(startup, scope=cpu_scope)
    names = sorted(cpu_scope.local_var_names())
    start = {n: cpu_scope.get_numpy(n) for n in names}
    for name in names:
        gpu_scope.set_var(name, cpu_scope.find_var(name).to(gpu.device))
    losses = []
    for i in range(2):
        feed = lstm_ragged_feed(np, i, LSTM_REDUCED)
        lc, = cpu.run(main_prog, feed=feed, fetch_list=[loss],
                      scope=cpu_scope)
        lg, = gpu.run(main_prog, feed=feed, fetch_list=[loss],
                      scope=gpu_scope)
        losses.append((float(lg[0]), float(lc[0])))
        if not abs(float(lg[0]) - float(lc[0])) <= LOSS_RTOL * abs(
                float(lc[0])):
            raise RuntimeError(f"step {i}: card loss {lg[0]} vs CPU {lc[0]}")
    worst, worst_rel = hold_updates(np, names, start, gpu_scope, cpu_scope)
    print(f"card vs CPU, reduced LSTM {LSTM_REDUCED}, 2 Adam steps on ragged "
          f"feeds: losses (card, CPU) {losses} (tol rtol {LOSS_RTOL}), "
          f"largest state diff {worst:.3e} (tol atol {PARAM_ATOL}), largest "
          f"relative rms diff of an update or accumulator {worst_rel:.3e} "
          f"(tol {STATE_RTOL}) [{card}]")
    if not worst <= PARAM_ATOL:
        raise RuntimeError("LSTM card and CPU states disagree")


def lstm_amp_path(np, torch, fl, card, seed: int):
    """Phase 17: phase 9's stacked LSTM with main.amp_dtype = "bfloat16"
    through the Executor; returns the bf16 LSTM kernels' launch counts of
    its steps."""
    import paddle_tpu_torch as pt

    b, t = LSTM["batch"], LSTM["seq_len"]
    main_prog, startup, loss, _ = build_lstm(pt, LSTM, seed)
    main_prog.amp_dtype = "bfloat16"
    exe, scope = pt.Executor(), pt.Scope()
    feed0 = lstm_varied(np, 0, b, t, LSTM["dict_size"])
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    names = LSTM_KERNELS + LSTM_BF16_KERNELS
    for name in names:
        getattr(fl, name).launches = 0

    def step(feed):
        return float(exe.run(main_prog, feed=feed, fetch_list=[loss],
                             scope=scope)[0][0])

    def timed():
        losses, step_s = [], []
        for _ in range(1 + LSTM_STEPS):
            t0 = time.perf_counter()
            losses.append(step(feed0))
            step_s.append(time.perf_counter() - t0)
        return losses, 1e3 * sum(step_s[1:]) / LSTM_STEPS, step_s

    losses, ms, step_s = timed()
    varied = [step(lstm_varied(np, i, b, t, LSTM["dict_size"]))
              for i in range(1, 1 + LSTM_STEPS)]
    n_steps = 1 + 2 * LSTM_STEPS
    launches = {name: getattr(fl, name).launches for name in names}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"lstm AMP path (bfloat16, float32 masters): batch {b}, sequence "
          f"{t}, losses on one feed {losses}, warm-up step "
          f"{1e3 * step_s[0]:.1f} ms, {LSTM_STEPS} timed steps "
          f"{[round(1e3 * x, 2) for x in step_s[1:]]} ms: {ms:.3f} ms per "
          f"step, {b * t / ms * 1e3:.1f} tokens/s, peak memory "
          f"{peak_gb:.2f} GB; losses on varied feeds 1-{LSTM_STEPS} "
          f"{varied} [{card}]")
    print(f"lstm AMP path launches over {n_steps} steps: {launches}")
    for name, n in launches.items():
        expect = n_steps if name in LSTM_BF16_KERNELS else 0
        if n != expect:
            raise RuntimeError(f"{name} was launched {n} times on the AMP "
                               f"LSTM path, expected {expect}")
    every = losses + varied
    if not all(np.isfinite(every)) or not min(losses[1:]) < losses[0]:
        raise RuntimeError(f"AMP LSTM losses are not finite and falling on "
                           f"one feed: {every}")
    wide = [p.name for p in main_prog.global_block.all_parameters()
            if scope.find_var(p.name).dtype != torch.float32]
    if wide:
        raise RuntimeError(f"masters no longer float32 after AMP steps: "
                           f"{wide}")
    # a profile that holds no recurrence kernel lost its events: it is
    # taken again, up to three times
    for _ in range(3):
        wall, by_name, _ = profiled(torch, lambda: step(feed0), 1)
        bwd = lstm_bwd_parts(by_name, "lstm_seq_bwd_bf16",
                             LSTM_BF16_BWD_PARTS)
        if bwd["recurrence"] > 0:
            break
    print_profile(f"AMP LSTM training step (batch {b}, sequence {t})", wall,
                  by_name, card)
    print("  lstm_seq_bwd_bf16's parts: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in bwd.items()) + f" [{card}]")
    if not bwd["recurrence"] > 0:
        raise RuntimeError("the AMP LSTM step's profile shows no device time "
                           "in the backward's recurrence "
                           "(lstm_bwd_seq_bf16_kernel)")
    # phase 9's float32 step: the same program and scope, in this run;
    # one step of each: its launches and device ms by class
    counts = {"AMP": launch_profile(torch, lambda: step(feed0))}
    main_prog.amp_dtype = None
    try:
        f32_losses, f32_ms, _ = timed()
        counts["float32"] = launch_profile(torch, lambda: step(feed0))
    finally:
        main_prog.amp_dtype = "bfloat16"
    print(f"float32 step of the same program in this run: {f32_ms:.3f} ms "
          f"per step (losses {f32_losses}); AMP {f32_ms / ms:.3f}x its "
          f"speed [{card}]")
    for what, (n, dev_ms, classes) in counts.items():
        print(f"{what} LSTM step: {n} kernel launches, device {dev_ms:.3f} "
              f"ms: " + ", ".join(
                  f"{c} {m:.3f} ms / {k}" for c, (k, m) in
                  sorted(classes.items(), key=lambda kv: -kv[1][1]))
              + f" [{card}]")
    return {name: launches[name] for name in LSTM_BF16_KERNELS}


def lstm_amp_card_vs_cpu(np, torch, card, seed: int):
    """Phase 18: phase 10's reduced LSTM under AMP, two Adam steps on
    ragged list feeds from one startup state on the card (the bf16
    kernels) and on the CPU (their plain versions)."""
    import paddle_tpu_torch as pt

    main_prog, startup, loss, _ = build_lstm(pt, LSTM_REDUCED, seed)
    main_prog.amp_dtype = "bfloat16"
    cpu, gpu = pt.Executor(pt.CPUPlace()), pt.Executor()
    cpu_scope, gpu_scope = pt.Scope(), pt.Scope()
    cpu.run(startup, scope=cpu_scope)
    for name in cpu_scope.local_var_names():
        gpu_scope.set_var(name, cpu_scope.find_var(name).to(gpu.device))
    params = [p.name for p in main_prog.global_block.all_parameters()]
    start = {n: cpu_scope.get_numpy(n) for n in params}
    losses = []
    for i in range(2):
        feed = lstm_ragged_feed(np, i, LSTM_REDUCED)
        lc, = cpu.run(main_prog, feed=feed, fetch_list=[loss],
                      scope=cpu_scope)
        lg, = gpu.run(main_prog, feed=feed, fetch_list=[loss],
                      scope=gpu_scope)
        losses.append((float(lg[0]), float(lc[0])))
        if not abs(float(lg[0]) - float(lc[0])) <= AMP_LOSS_RTOL * abs(
                float(lc[0])):
            raise RuntimeError(f"AMP LSTM step {i}: card loss {lg[0]} vs "
                               f"CPU {lc[0]}")
    worst, upd = 0.0, {}
    for p in params:
        got, want = gpu_scope.get_numpy(p), cpu_scope.get_numpy(p)
        if gpu_scope.find_var(p).dtype != torch.float32:
            raise RuntimeError(f"master {p} is not float32")
        worst = max(worst, float(np.abs(got - want).max()))
        upd[p] = rms(np, got - want) / rms(np, want - start[p])
    print(f"card vs CPU, reduced LSTM {LSTM_REDUCED} under AMP, 2 Adam steps "
          f"on ragged feeds: losses (card, CPU) {losses} (tol rtol "
          f"{AMP_LOSS_RTOL}), largest master diff {worst:.3e} (tol atol "
          f"{LSTM_AMP_STEP_ATOL}), relative rms diff of each update "
          + ", ".join(f"{p} {v:.3e}" for p, v in upd.items())
          + f" (tol {AMP_UPDATE_RTOL}) [{card}]")
    if not (worst <= LSTM_AMP_STEP_ATOL
            and max(upd.values()) <= AMP_UPDATE_RTOL):
        raise RuntimeError("AMP LSTM card and CPU masters disagree")


def chain_case(torch, n, cin, c, h, gen):
    """Inputs of one chain stage: a block input >= 0 (it follows a ReLU),
    He-scaled weights, BN scales around 1 and shifts that are not zero."""
    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    return dict(x=torch.rand(n, cin, h * h, device="cuda", generator=gen),
                w1=randn(c, cin) * (2 / cin) ** 0.5,
                taps=randn(9, c, c) * (2 / (9 * c)) ** 0.5,
                w3=randn(cin, c) * (2 / c) ** 0.5,
                gam=[1 + 0.2 * randn(k) for k in (c, c, cin)],
                bet=[0.2 * randn(k) for k in (c, c, cin)])


def check_sums(torch, name, got, want, terms):
    """A sum within STATS_RTOL of the sum of its terms' magnitudes;
    returns (the largest difference, the largest share of its limit)."""
    diff, lim = (got - want).abs(), STATS_RTOL * terms
    if not bool((diff <= lim).all()):
        raise RuntimeError(f"{name}: the kernel's sums disagree with the "
                           f"plain version's beyond rtol {STATS_RTOL}")
    return float(diff.max()), float((diff / lim.clamp_min(1e-30)).max())


def check_chain(torch, F, fb, card):
    """The four chain kernels vs their plain versions at each of
    CHAIN_SHAPES, each stage's inputs made as the chain makes them (the
    plain version of the kernel before); the kernels line reports the
    first stage."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    n = RESNET["batch"]
    rows, errs = {}, {k: [] for k in CHAIN_KERNELS}
    share1, share3, share_mom, share_res = [], [], [], []
    for cin, c, h in CHAIN_SHAPES:
        s, m = h * h, n * h * h
        d = chain_case(torch, n, cin, c, h, gen)
        x, w1, taps, w3 = d["x"], d["w1"], d["taps"], d["w3"]
        a1, s1, q1 = fb.conv1x1_stats(x, w1)
        ra1, rs1, rq1 = fb.conv1x1_stats_reference(x, w1)
        torch.cuda.synchronize()
        errs["conv1x1_stats"].append(max_err(torch, a1, ra1))
        share1.append(limit_share(torch, a1, ra1))
        sums = {"conv1x1_stats": [
            check_sums(torch, "conv1x1_stats", s1, rs1,
                       ra1.abs().sum(dim=(0, 2))),
            check_sums(torch, "conv1x1_stats", q1, rq1, rq1)]}
        del a1
        _, _, sc1, sh1 = fb._bn_fold(rs1, rq1, m, d["gam"][0], d["bet"][0])
        a2, s2, q2 = fb.conv3x3_norm_stats(ra1, taps, sc1, sh1, h)
        ra2, rs2, rq2 = fb.conv3x3_norm_stats_reference(ra1, taps, sc1, sh1,
                                                        h)
        torch.cuda.synchronize()
        errs["conv3x3_norm_stats"].append(max_err(torch, a2, ra2))
        share3.append(limit_share(torch, a2, ra2))
        sums["conv3x3_norm_stats"] = [
            check_sums(torch, "conv3x3_norm_stats", s2, rs2,
                       ra2.abs().sum(dim=(0, 2))),
            check_sums(torch, "conv3x3_norm_stats", q2, rq2, rq2)]
        del a2
        _, _, sc2, sh2 = fb._bn_fold(rs2, rq2, m, d["gam"][1], d["bet"][1])
        sum_h, m2h = fb.norm_relu_moments(ra2, sc2, sh2)
        rsum_h, rm2h = fb.norm_relu_moments_reference(ra2, sc2, sh2)
        torch.cuda.synchronize()
        # h >= 0, so Σh and M2 are their terms' magnitudes summed
        sums["norm_relu_moments"] = [
            check_sums(torch, "norm_relu_moments", sum_h, rsum_h, rsum_h),
            check_sums(torch, "norm_relu_moments", m2h, rm2h, rm2h)]
        errs["norm_relu_moments"].append(
            max(e for e, _ in sums["norm_relu_moments"]))
        share_mom.append(max(sh for _, sh in sums["norm_relu_moments"]))
        if not torch.equal(m2h, m2h.T):
            raise RuntimeError("norm_relu_moments: M2 is not symmetric")
        # bn3's affine from the plain moments, as bottleneck_rest_fwd
        _, _, sc3, sh3 = fb._bn3_fold(w3, rsum_h, rm2h, m, d["gam"][2],
                                      d["bet"][2])
        res_args = (ra2, x, sc2, sh2, w3, sc3, sh3)
        out = fb.conv1x1_bn_residual(*res_args)
        rout = fb.conv1x1_bn_residual_reference(*res_args)
        torch.cuda.synchronize()
        errs["conv1x1_bn_residual"].append(max_err(torch, out, rout))
        share_res.append(limit_share(torch, out, rout))
        del out, rout
        # bounds: each input read once, each output written once; the
        # products (M2 is symmetric: C(C+1)/2 products a column), the
        # loaders' normalize (3 a value), the statistics (3 a value) and
        # the residual's epilogue (4 a value). All four run their
        # products as three TF32 products on the tensor cores: their
        # bounds are that arithmetic's, printed beside the float32 FMA
        # bounds
        ea, ex = n * c * s, n * cin * s
        bytes3 = 4 * (2 * ea + 9 * c * c + 4 * c)
        f32_bound3 = bound_ms(bytes3, 18 * c * c * m + 6 * ea)
        bytes_mom = 4 * (ea + 2 * c + c * (c + 1))
        f32_bound_mom = bound_ms(bytes_mom, c * (c + 1) * m + 4 * ea)
        bytes_res = 4 * (ea + 2 * ex + cin * c + 2 * c + 2 * cin)
        f32_bound_res = bound_ms(bytes_res, 2 * cin * c * m + 3 * ea + 4 * ex)
        bytes1 = 4 * (ex + c * cin + ea + 2 * c)
        f32_bound1 = bound_ms(bytes1, 2 * c * cin * m + 3 * ea)
        bounds = {
            "conv1x1_stats": bound_ms(bytes1, 3 * 2 * c * cin * m,
                                      TF32_FLOPS_PER_S),
            "conv3x3_norm_stats": bound_ms(bytes3, 3 * 18 * c * c * m,
                                           TF32_FLOPS_PER_S),
            "norm_relu_moments": bound_ms(bytes_mom, 3 * c * (c + 1) * m,
                                          TF32_FLOPS_PER_S),
            "conv1x1_bn_residual": bound_ms(bytes_res, 3 * 2 * cin * c * m,
                                            TF32_FLOPS_PER_S)}
        calls = {
            "conv1x1_stats": (lambda: fb.conv1x1_stats(x, w1),
                              lambda: fb.conv1x1_stats_reference(x, w1)),
            "conv3x3_norm_stats": (
                lambda: fb.conv3x3_norm_stats(ra1, taps, sc1, sh1, h),
                lambda: fb.conv3x3_norm_stats_reference(ra1, taps, sc1, sh1,
                                                        h)),
            "norm_relu_moments": (
                lambda: fb.norm_relu_moments(ra2, sc2, sh2),
                lambda: fb.norm_relu_moments_reference(ra2, sc2, sh2)),
            "conv1x1_bn_residual": (
                lambda: fb.conv1x1_bn_residual(*res_args),
                lambda: fb.conv1x1_bn_residual_reference(*res_args))}
        ms = {k: cuda_ms(torch, f, 10) for k, (f, _) in calls.items()}
        plain = {k: cuda_ms(torch, r, 3) for k, (_, r) in calls.items()}
        # yardsticks: the same product through cuDNN (TF32 off), on the
        # materialized h where the kernel normalizes on load
        h1 = fb._norm_relu(ra1, sc1, sh1).view(n, c, h, h)
        h2 = fb._norm_relu(ra2, sc2, sh2)
        w2 = taps.view(3, 3, c, c).permute(2, 3, 0, 1).contiguous()
        lib = {"conv1x1_stats": cuda_ms(torch, lambda: F.conv2d(
                   x.view(n, cin, h, h), w1.view(c, cin, 1, 1)), 10),
               "conv3x3_norm_stats": cuda_ms(
                   torch, lambda: F.conv2d(h1, w2, padding=1), 10),
               "norm_relu_moments": cuda_ms(torch, lambda: (
                   torch.bmm(h2, h2.transpose(1, 2)).sum(dim=0),
                   h2.sum(dim=(0, 2))), 10),
               "conv1x1_bn_residual": cuda_ms(torch, lambda: F.conv2d(
                   h2.view(n, c, h, h), w3.view(cin, c, 1, 1)), 10)}
        notes = {"conv1x1_stats": (
            f" by 3xTF32 at {TF32_FLOPS_PER_S / 1e12:.0f} TFLOP/s, f32 FMA "
            f"bound {f32_bound1[0]:.4f} {f32_bound1[1]}, largest share of "
            f"its limit {share1[-1]:.4f}"),
                 "conv3x3_norm_stats": (
            f" by 3xTF32 at {TF32_FLOPS_PER_S / 1e12:.0f} TFLOP/s, f32 FMA "
            f"bound {f32_bound3[0]:.4f} {f32_bound3[1]}, largest share of "
            f"its limit {share3[-1]:.4f}"),
                 "norm_relu_moments": (
            f" by 3xTF32 at {TF32_FLOPS_PER_S / 1e12:.0f} TFLOP/s, f32 FMA "
            f"bound {f32_bound_mom[0]:.4f} {f32_bound_mom[1]}, largest share "
            f"of its limit {share_mom[-1]:.4f}"),
                 "conv1x1_bn_residual": (
            f" by 3xTF32 at {TF32_FLOPS_PER_S / 1e12:.0f} TFLOP/s, f32 FMA "
            f"bound {f32_bound_res[0]:.4f} {f32_bound_res[1]}, largest share "
            f"of its limit {share_res[-1]:.4f}")}
        print(f"bottleneck chain stage Cin {cin}, C {c}, {h}x{h}, batch {n}: "
              + "; ".join(
                  f"{k} {ms[k]:.4f} ms (plain {plain[k]:.4f}, "
                  f"{'bmm + sum' if k == 'norm_relu_moments' else 'conv2d'} "
                  f"{lib[k]:.4f}, bound {bounds[k][0]:.4f} {bounds[k][1]}"
                  f"{notes.get(k, '')}, max_abs_err {errs[k][-1]:.3e})"
                  for k in CHAIN_KERNELS)
              + f"; chain {sum(ms.values()):.4f} ms vs bound "
              f"{sum(b[0] for b in bounds.values()):.4f} ms; the 3x3's "
              f"largest |a2| {float(ra2.abs().max()):.3f}; tol atol "
              f"{KERNEL_ATOL} rtol {KERNEL_RTOL} [{card}]")
        print(f"bottleneck chain stage Cin {cin}, C {c}, {h}x{h} sums (tol "
              f"rtol {STATS_RTOL} of Σ|terms|), largest |kernel - plain| and"
              f" largest share of the limit: " + "; ".join(
                  f"{k} {what} {e:.3e} ({share:.3f})"
                  for k, pair in sums.items()
                  for what, (e, share) in zip(
                      ("Σh, M2" if k == "norm_relu_moments" else "Σ, Σ²")
                      .split(", "), pair)) + f" [{card}]")
        if (cin, c, h) == CHAIN_SHAPES[0]:
            for k in CHAIN_KERNELS:
                rows[k] = dict(ms=ms[k], plain_ms=plain[k],
                               bound_ms=bounds[k][0], bound_by=bounds[k][1],
                               library_ms=lib[k])
        del d, x, ra1, ra2, h1, h2, res_args, calls
    for k in rows:
        rows[k]["max_abs_err"] = max(errs[k])
    for k, shares in (("conv1x1_stats", share1),
                      ("conv3x3_norm_stats", share3),
                      ("conv1x1_bn_residual", share_res)):
        print(f"{k}: largest share of its elementwise limit |kernel - "
              f"plain| / (atol + rtol·|plain|) over the three stages "
              f"{max(shares):.4f} (atol {KERNEL_ATOL}, rtol {KERNEL_RTOL}) "
              f"[{card}]")
    print(f"norm_relu_moments: largest share of its limit |kernel - plain| "
          f"/ (rtol·Σ|terms|) of Σh and M2 over the three stages "
          f"{max(share_mom):.4f} (rtol {STATS_RTOL}) [{card}]")
    return rows


def bf16_sum_share(torch, name, got, want, terms, moved):
    """A float32 sum of rounded bf16 values within STATS_RTOL of its
    terms' magnitudes plus `moved`, what the kernel's rounded values that
    differ from the plain version's move it; returns the largest share
    of that limit."""
    lim = STATS_RTOL * terms + moved
    share = float(((got - want).abs() / lim.clamp_min(1e-30)).max())
    if not share <= 1:
        raise RuntimeError(f"{name}: the kernel's sums disagree with the "
                           f"plain version's (share {share:.3f} of the "
                           f"limit)")
    return share


def ptxas_of(report: dict, source: str) -> dict:
    """{kernel entry: (registers, spill store bytes)} from the build's
    ptxas report of `source` (empty where the build was cached)."""
    out, entry = {}, None
    for line in report.get(source, {}).get("log", "").splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and entry:
            out[entry] = (None, int(m.group(1)))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            out[entry] = (int(m.group(1)), out.get(entry, (0, 0))[1])
    return out


def bf16_chain_regs(report: dict) -> dict:
    """{bf16 chain kernel: "registers r1/r2/..., spills s1/s2/... bytes"}
    over the instances of its CUDA kernels in csrc/fused_block_bf16.cu,
    csrc/abt_bf16_tc.cuh and csrc/conv1x1_bf16_tc.cuh (bwd_mid's and
    bwd_final's: their fold, product and tile kernels)."""
    match = {"conv1x1_stats_bf16": r"conv1x1_bf16_kernelILi\d+ELi0E",
             "conv1x1_bn_residual_bf16": r"tile1x1_bf16_kernelILi\d+ELi0E",
             "conv3x3_norm_stats_bf16": r"conv3x3_bf16_kernelILi\d+ELi0E",
             "norm_relu_moments_bf16": r"moments_bf16_kernel",
             "bwd_reduce3_bf16": r"reduce3_bf16_kernelILi\d+ELi0E",
             "bwd_apply3_bf16": r"conv1x1_bf16_kernelILi\d+ELi2E",
             "bwd_mid_bf16": r"conv3x3_bf16_kernelILi\d+ELi1E|"
                             r"taps_bf16_kernel|fold_bf16",
             "bwd_final_bf16": r"tile1x1_bf16_kernelILi\d+ELi1E|"
                               r"reduce3_bf16_kernelILi\d+ELi1E|fold_bf16"}
    entries = ptxas_of(report, "fused_block_bf16.cu")
    out = {}
    for k, pat in match.items():
        got = [v for e, v in entries.items() if re.search(pat, e)]
        out[k] = ("registers " + "/".join(str(r) for r, _ in got)
                  + ", spill stores " + "/".join(str(s) for _, s in got)
                  + " bytes") if got else "registers not measured (cached)"
    return out


def check_chain_bf16(torch, F, fb, card, report):
    """The four bf16 chain kernels (csrc/fused_block_bf16.cu) vs their
    plain versions at each of CHAIN_SHAPES, on bf16 inputs made as the
    chain makes them (the plain version of the kernel before; BN folds
    from its float32 sums); two calls on one input held to the same bits;
    each timed beside its plain version, its bound (bf16 bytes at 3.35
    TB/s, products at the bf16 tensor cores' rate) and a bf16 PyTorch
    yardstick (F.conv2d of the same product for the convolutions,
    torch.bmm of h·hᵀ and the sum for the moments). The kernels line
    reports the first stage."""
    gen = torch.Generator(device="cuda").manual_seed(17)
    n, bf = RESNET["batch"], torch.bfloat16
    regs = bf16_chain_regs(report)
    rows, errs = {}, {k: [] for k in CHAIN_BF16_KERNELS}
    shares = {k: [] for k in CHAIN_BF16_KERNELS}
    for cin, c, h in CHAIN_SHAPES:
        s, m = h * h, n * h * h
        d = chain_case(torch, n, cin, c, h, gen)
        x, w1, taps, w3 = (d[k].to(bf) for k in ("x", "w1", "taps", "w3"))
        differ, sums = {}, {}

        def hold_y(name, got, want):
            shares[name].append(bf16_share(torch, got, want))
            errs[name].append(float((got.float() - want.float()).abs()
                                    .max()))
            differ[name] = float((got != want).float().mean())

        def hold_sums(name, y, ry, s_, q, rs, rq):
            yf, ryf = y.float(), ry.float()
            moved = (yf - ryf).abs()
            sums[name] = (
                bf16_sum_share(torch, name, s_, rs,
                               ryf.abs().sum(dim=(0, 2)),
                               moved.sum(dim=(0, 2))),
                bf16_sum_share(torch, name, q, rq, rq,
                               (moved * (yf.abs() + ryf.abs()))
                               .sum(dim=(0, 2))))

        def same_bits(name, fn, first):
            again = fn()
            torch.cuda.synchronize()
            pairs = zip(first, again) if isinstance(first, tuple) \
                else [(first, again)]
            if not all(torch.equal(a, b) for a, b in pairs):
                raise RuntimeError(f"{name}: two calls on one input differ")

        k1 = lambda: fb.conv1x1_stats_bf16(x, w1)
        a1 = k1()
        ra1, rs1, rq1 = fb.conv1x1_stats_reference(x, w1)
        torch.cuda.synchronize()
        hold_y("conv1x1_stats_bf16", a1[0], ra1)
        hold_sums("conv1x1_stats_bf16", a1[0], ra1, a1[1], a1[2], rs1, rq1)
        same_bits("conv1x1_stats_bf16", k1, a1)
        del a1
        _, _, sc1, sh1 = fb._bn_fold(rs1, rq1, m, d["gam"][0], d["bet"][0])
        k2 = lambda: fb.conv3x3_norm_stats_bf16(ra1, taps, sc1, sh1, h)
        a2 = k2()
        ra2, rs2, rq2 = fb.conv3x3_norm_stats_reference(ra1, taps, sc1, sh1,
                                                        h)
        torch.cuda.synchronize()
        hold_y("conv3x3_norm_stats_bf16", a2[0], ra2)
        hold_sums("conv3x3_norm_stats_bf16", a2[0], ra2, a2[1], a2[2], rs2,
                  rq2)
        same_bits("conv3x3_norm_stats_bf16", k2, a2)
        del a2
        _, _, sc2, sh2 = fb._bn_fold(rs2, rq2, m, d["gam"][1], d["bet"][1])
        k3 = lambda: fb.norm_relu_moments_bf16(ra2, sc2, sh2)
        sum_h, m2h = k3()
        rsum_h, rm2h = fb.norm_relu_moments_reference(ra2, sc2, sh2)
        torch.cuda.synchronize()
        # h >= 0, rounded to bf16 in both: Σh and M2 are their terms'
        # magnitudes summed
        sums["norm_relu_moments_bf16"] = (
            check_sums(torch, "norm_relu_moments_bf16", sum_h, rsum_h,
                       rsum_h)[1],
            check_sums(torch, "norm_relu_moments_bf16", m2h, rm2h, rm2h)[1])
        shares["norm_relu_moments_bf16"].append(
            max(sums["norm_relu_moments_bf16"]))
        errs["norm_relu_moments_bf16"].append(float(max(
            (sum_h - rsum_h).abs().max(), (m2h - rm2h).abs().max())))
        if not torch.equal(m2h, m2h.T):
            raise RuntimeError("norm_relu_moments_bf16: M2 is not symmetric")
        same_bits("norm_relu_moments_bf16", k3, (sum_h, m2h))
        _, _, sc3, sh3 = fb._bn3_fold(w3, rsum_h, rm2h, m, d["gam"][2],
                                      d["bet"][2])
        res_args = (ra2, x, sc2, sh2, w3, sc3, sh3)
        k4 = lambda: fb.conv1x1_bn_residual_bf16(*res_args)
        out = k4()
        rout = fb.conv1x1_bn_residual_reference(*res_args)
        torch.cuda.synchronize()
        hold_y("conv1x1_bn_residual_bf16", out, rout)
        same_bits("conv1x1_bn_residual_bf16", k4, out)
        del out, rout
        # bounds: each input read once and each output written once (bf16
        # activations, taps and weights; float32 affines and sums); the
        # products at the bf16 tensor cores' rate (M2 is symmetric: C(C+1)
        # / 2 products a column)
        ea, ex = n * c * s, n * cin * s
        bounds = {
            "conv1x1_stats_bf16": bound_ms(
                2 * (ex + c * cin + ea) + 4 * 2 * c, 2 * c * cin * m,
                BF16_FLOPS_PER_S),
            "conv3x3_norm_stats_bf16": bound_ms(
                2 * (2 * ea + 9 * c * c) + 4 * 4 * c, 18 * c * c * m,
                BF16_FLOPS_PER_S),
            "norm_relu_moments_bf16": bound_ms(
                2 * ea + 4 * (2 * c + c * (c + 1)), c * (c + 1) * m,
                BF16_FLOPS_PER_S),
            "conv1x1_bn_residual_bf16": bound_ms(
                2 * (ea + 2 * ex + cin * c) + 4 * (2 * c + 2 * cin),
                2 * cin * c * m, BF16_FLOPS_PER_S)}
        calls = {
            "conv1x1_stats_bf16": (
                k1, lambda: fb.conv1x1_stats_reference(x, w1)),
            "conv3x3_norm_stats_bf16": (
                k2, lambda: fb.conv3x3_norm_stats_reference(ra1, taps, sc1,
                                                            sh1, h)),
            "norm_relu_moments_bf16": (
                k3, lambda: fb.norm_relu_moments_reference(ra2, sc2, sh2)),
            "conv1x1_bn_residual_bf16": (
                k4, lambda: fb.conv1x1_bn_residual_reference(*res_args))}
        ms = {k: cuda_ms(torch, f, 10) for k, (f, _) in calls.items()}
        plain = {k: cuda_ms(torch, r, 3) for k, (_, r) in calls.items()}
        # yardsticks: the same product in bf16 through cuDNN / cuBLAS, on
        # the materialized bf16 h where the kernel normalizes on load
        h1 = fb._norm_relu(ra1, sc1, sh1).view(n, c, h, h)
        h2 = fb._norm_relu(ra2, sc2, sh2)
        w2 = taps.view(3, 3, c, c).permute(2, 3, 0, 1).contiguous()
        lib = {"conv1x1_stats_bf16": cuda_ms(torch, lambda: F.conv2d(
                   x.view(n, cin, h, h), w1.view(c, cin, 1, 1)), 10),
               "conv3x3_norm_stats_bf16": cuda_ms(
                   torch, lambda: F.conv2d(h1, w2, padding=1), 10),
               "norm_relu_moments_bf16": cuda_ms(torch, lambda: (
                   torch.bmm(h2, h2.transpose(1, 2)).sum(dim=0),
                   h2.sum(dim=(0, 2))), 10),
               "conv1x1_bn_residual_bf16": cuda_ms(torch, lambda: F.conv2d(
                   h2.view(n, c, h, h), w3.view(cin, c, 1, 1)), 10)}
        print(f"bottleneck chain bf16 stage Cin {cin}, C {c}, {h}x{h}, batch "
              f"{n}: " + "; ".join(
                  f"{k} {ms[k]:.4f} ms (plain {plain[k]:.4f}, "
                  f"{'bmm + sum' if 'moments' in k else 'conv2d'} bf16 "
                  f"{lib[k]:.4f}, bound {bounds[k][0]:.4f} {bounds[k][1]}, "
                  f"largest share of its limit {shares[k][-1]:.4f}"
                  + (f", elements that differ {differ[k]:.5f}"
                     if k in differ else "") + ")"
                  for k in CHAIN_BF16_KERNELS)
              + f"; chain {sum(ms.values()):.4f} ms vs bound "
              f"{sum(b[0] for b in bounds.values()):.4f} ms; two calls the "
              f"same bits [{card}]")
        print(f"bottleneck chain bf16 stage Cin {cin}, C {c}, {h}x{h} sums, "
              f"largest share of the limit (rtol {STATS_RTOL} of Σ|terms| "
              f"plus what flipped y move): " + "; ".join(
                  f"{k} {what} {share:.3f}" for k, pair in sums.items()
                  for what, share in zip(
                      ("Σh", "M2") if "moments" in k else ("Σ", "Σ²"),
                      pair)) + f" [{card}]")
        if (cin, c, h) == CHAIN_SHAPES[0]:
            for k in CHAIN_BF16_KERNELS:
                rows[k] = dict(ms=ms[k], plain_ms=plain[k],
                               bound_ms=bounds[k][0], bound_by=bounds[k][1],
                               library_ms=lib[k])
        del d, x, ra1, ra2, h1, h2, res_args, calls
    for k in CHAIN_BF16_KERNELS:
        rows[k]["max_abs_err"] = max(errs[k])
        print(f"{k}: largest share of its limit over the three stages "
              f"{max(shares[k]):.4f}; {regs[k]} [{card}]")
    return rows


def chain_bwd_inputs(torch, fb, d, dout, h, suffix="", cots=None):
    """{kernel: args} of the four backward wrappers (their names + suffix:
    "_bf16" for a bf16 d and dout) in one run of bottleneck_rest_fwd and
    bottleneck_rest_bwd on d (a chain_case: x, w1, taps, w3, gam, bet; h
    rows an image), a cotangent dout of out and cots of the six batch
    statistics (zeros by default), with the chain's eight wrappers
    replaced by their plain versions: each kernel's inputs as its plain
    predecessors make them. The card tests and
    scripts/emulate_fused_block_bf16_cpu.py take their inputs here too."""
    g, b = d["gam"], d["bet"]
    args = {}
    names = [k + suffix for k in CHAIN_KERNELS + CHAIN_BWD_KERNELS]
    wrappers = {k: getattr(fb, k) for k in names}

    def plain(name):
        ref = getattr(fb, name + "_reference")

        def call(*a):
            args[name] = a
            return ref(*a)
        return call

    try:
        for k in CHAIN_KERNELS:
            setattr(fb, k + suffix, getattr(fb, k + "_reference"))
        for k in CHAIN_BWD_KERNELS:
            setattr(fb, k + suffix, plain(k))
        out, stats, aux = fb.bottleneck_rest_fwd(
            d["x"], d["w1"], d["taps"], d["w3"], g[0], b[0], g[1], b[1],
            g[2], b[2], h)
        a1, a2, sum_h, m2h, sc1, sh1, sc2, sh2 = aux
        res = (d["x"], a1, a2, out, d["w1"], d["taps"], d["w3"], g[0],
               g[1], g[2], *stats, sum_h, m2h, sc1, sh1, sc2, sh2)
        fb.bottleneck_rest_bwd(res, dout, [torch.zeros_like(st)
                                           for st in stats]
                               if cots is None else cots, h)
    finally:
        for k, w in wrappers.items():
            setattr(fb, k, w)
    return args


def bwd_terms(torch, fb, name, args, want):
    """The sum of each summed output's terms' magnitudes, in the order the
    wrapper returns its outputs (None for an elementwise output)."""
    def col(v):
        return v.reshape(1, -1, 1)

    if name == "bwd_reduce3":
        g3 = want[0].abs()
        h2 = fb._norm_relu(*args[2:5])
        return None, torch.einsum("nis,ncs->ic", g3, h2), g3.sum(dim=(0, 2))
    if name == "bwd_apply3":
        a2, inv2, m2 = args[1], args[7], args[8]
        gx = (want[0] * (a2 * col(inv2) + col(-m2 * inv2))).abs()
        return None, want[0].abs().sum(dim=(0, 2)), gx.sum(dim=(0, 2))
    if name == "bwd_mid":
        g2, a2, a1, sc1, sh1, p2, q2, r2, inv1, m1, taps, h = args
        n, c, s = g2.shape
        da2 = (g2 * col(p2) + a2 * col(q2) + col(r2)).abs()
        h1 = fb._norm_relu(a1, sc1, sh1).view(n, c, h, s // h)
        dw = torch.nn.grad.conv2d_weight(h1, (c, c, 3, 3),
                                         da2.view(n, c, h, s // h), padding=1)
        gx = (want[0] * (a1 * col(inv1) + col(-m1 * inv1))).abs()
        return (None, dw.permute(2, 3, 0, 1).reshape(9, c, c),
                want[0].abs().sum(dim=(0, 2)), gx.sum(dim=(0, 2)))
    g3, g1, a1, x, p1, q1, r1, _ = args
    da1 = (g1 * col(p1) + a1 * col(q1) + col(r1)).abs()
    return None, torch.einsum("ncs,nks->ck", da1, x)


BWD_OUTPUTS = {"bwd_reduce3": ("g3", "P", "Σg3"),
               "bwd_apply3": ("g2", "Σg2", "Σg2·x̂2"),
               "bwd_mid": ("g1", "dtaps", "Σg1", "Σg1·x̂1"),
               "bwd_final": ("dx", "dW1")}


def check_chain_bwd(torch, fb, card):
    """The four backward kernels vs their plain versions at each of
    CHAIN_SHAPES, on the inputs the chain makes (chain_bwd_inputs), each
    timed beside its plain version, its bound and a library yardstick of
    the same products on materialized operands (cuBLAS for rows 10, 11
    and 13; cuDNN's dgrad + wgrad for row 12; TF32 off); the kernels line
    reports the first stage and the largest raw |kernel - plain| over
    the stages and outputs."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    n = RESNET["batch"]
    rows, errs = {}, {k: [] for k in CHAIN_BWD_KERNELS}

    def col(v):
        return v.reshape(1, -1, 1)

    for cin, c, h in CHAIN_SHAPES:
        s, m = h * h, n * h * h
        d = chain_case(torch, n, cin, c, h, gen)
        dout = torch.randn(n, cin, s, device="cuda", generator=gen)
        args = chain_bwd_inputs(torch, fb, d, dout, h)
        del d
        notes = []
        for name, a in args.items():
            got = getattr(fb, name)(*a)
            want = getattr(fb, name + "_reference")(*a)
            torch.cuda.synchronize()
            worst = 0.0
            for what, gt, wt, terms in zip(BWD_OUTPUTS[name], got, want,
                                           bwd_terms(torch, fb, name, a,
                                                     want)):
                if terms is not None:
                    e, share = check_sums(torch, f"{name} {what}", gt, wt,
                                          terms)
                    notes.append(f"{name} {what} {e:.3e} ({share:.3f} of "
                                 f"the limit)")
                elif what == "g3":
                    if not torch.equal(gt, wt):
                        raise RuntimeError("bwd_reduce3: g3 is not the plain "
                                           "version's, bit for bit")
                    e = 0.0
                    notes.append("g3 bitwise")
                else:
                    e = max_err(torch, gt, wt, BWD_ATOL, BWD_RTOL)
                    share = limit_share(torch, gt, wt, BWD_ATOL, BWD_RTOL)
                    notes.append(f"{name} {what} {e:.3e} ({share:.3f} of "
                                 f"the limit)")
                worst = max(worst, e)
            errs[name].append(worst)
            del got, want
        # bounds: each input read once, each output written once; the
        # products, the loaders' elementwise work (a normalize 3 a value,
        # a fold 4, a mask 1) and the epilogues' (mask 2, bias 1, the two
        # sums 5). bwd_apply3, bwd_mid and bwd_final run their products as
        # three TF32 products each on the tensor cores: their bounds are
        # that arithmetic's, printed beside the float32 FMA bounds
        ea, ex = n * c * s, n * cin * s
        a3_bytes = 4 * (ex + 2 * ea + c * cin + c * c + 7 * c)
        a3_ops = 2 * c * (cin + c) * m
        f32_bound_a3 = bound_ms(a3_bytes, a3_ops + 11 * ea)
        mid_bytes = 4 * (4 * ea + 18 * c * c + 9 * c)
        f32_bound_mid = bound_ms(mid_bytes, 36 * c * c * m + 14 * ea)
        final_bytes = 4 * (3 * ex + 2 * ea + 2 * c * cin + 3 * c)
        f32_bound_final = bound_ms(final_bytes, 4 * c * cin * m + 4 * ea + ex)
        r3_bytes = 4 * (3 * ex + ea + 2 * c + cin * c + cin)
        r3_ops = 2 * cin * c * m + 3 * ea + 2 * ex
        bounds = {
            "bwd_reduce3": bound_ms(r3_bytes, r3_ops),
            "bwd_apply3": bound_ms(a3_bytes, 3 * a3_ops, TF32_FLOPS_PER_S),
            "bwd_mid": bound_ms(mid_bytes, 3 * 36 * c * c * m,
                                TF32_FLOPS_PER_S),
            "bwd_final": bound_ms(final_bytes, 3 * 4 * c * cin * m,
                                  TF32_FLOPS_PER_S)}
        ms = {k: cuda_ms(torch, lambda k=k: getattr(fb, k)(*args[k]), 10)
              for k in CHAIN_BWD_KERNELS}
        plain = {k: cuda_ms(torch, lambda k=k: getattr(
            fb, k + "_reference")(*args[k]), 3) for k in CHAIN_BWD_KERNELS}
        # yardsticks on materialized operands
        g3, a2, sc2, sh2, amat, bmat = args["bwd_apply3"][:6]
        h2 = fb._norm_relu(a2, sc2, sh2)
        ab, gh = torch.cat([amat, bmat], 1), torch.cat([g3, h2], 1)
        g2, _, a1, sc1, sh1, p2, q2, r2 = args["bwd_mid"][:8]
        taps = args["bwd_mid"][10]
        da2 = (g2 * col(p2) + a2 * col(q2) + col(r2)).view(n, c, h, h)
        h1 = fb._norm_relu(a1, sc1, sh1).view(n, c, h, h)
        w2 = taps.view(3, 3, c, c).permute(2, 3, 0, 1).contiguous()
        _, g1, _, x, p1, q1, r1, w1 = args["bwd_final"]
        da1 = g1 * col(p1) + a1 * col(q1) + col(r1)
        lib = {"bwd_reduce3": cuda_ms(torch, lambda: torch.bmm(
                   g3, h2.transpose(1, 2)).sum(dim=0), 10),
               "bwd_apply3": cuda_ms(torch, lambda: torch.matmul(ab, gh), 10),
               "bwd_mid": cuda_ms(torch, lambda: (
                   torch.nn.grad.conv2d_input(h1.shape, w2, da2, padding=1),
                   torch.nn.grad.conv2d_weight(h1, w2.shape, da2, padding=1)),
                   10),
               "bwd_final": cuda_ms(torch, lambda: (
                   torch.matmul(w1.T, da1),
                   torch.bmm(da1, x.transpose(1, 2)).sum(dim=0)), 10)}
        yard = {"bwd_reduce3": "bmm + sum", "bwd_apply3": "matmul",
                "bwd_mid": "cuDNN dgrad + wgrad",
                "bwd_final": "matmul + bmm + sum"}
        print(f"bottleneck chain backward stage Cin {cin}, C {c}, {h}x{h}, "
              f"batch {n}: " + "; ".join(
                  f"{k} {ms[k]:.4f} ms (plain {plain[k]:.4f}, {yard[k]} "
                  f"{lib[k]:.4f}, bound {bounds[k][0]:.4f} {bounds[k][1]})"
                  for k in CHAIN_BWD_KERNELS)
              + f"; backward {sum(ms.values()):.4f} ms vs bound "
              f"{sum(b[0] for b in bounds.values()):.4f} ms [{card}]")
        # bwd_mid's launches apart, by the profiler's device times: the
        # fold, the input gradient, the tap gradients and the two
        # fixed-order passes
        _, by_name, _ = profiled(torch, lambda: fb.bwd_mid(*args["bwd_mid"]),
                                 5)
        parts = {}
        for kname, kms in by_name.items():
            low = kname.lower()
            part = ("input gradient" if "conv3x3_kernel<" in low else
                    "tap gradients" if "bwd_mid_wgrad" in low else
                    "fold" if "bwd_mid_fold" in low else "sums")
            parts[part] = parts.get(part, 0.0) + kms
        print(f"bwd_mid stage C {c}, {h}x{h}, batch {n}: {ms['bwd_mid']:.4f} "
              f"ms; device ms by launch (profiler): " + "; ".join(
                  f"{k} {parts.get(k, 0.0):.4f}" for k in (
                      "fold", "input gradient", "tap gradients", "sums"))
              + f"; bound {bounds['bwd_mid'][0]:.4f} {bounds['bwd_mid'][1]}"
              f" by 3xTF32 at {TF32_FLOPS_PER_S / 1e12:.0f} TFLOP/s, f32 "
              f"FMA bound {f32_bound_mid[0]:.4f} {f32_bound_mid[1]} "
              f"[{card}]")
        # bwd_final's launches apart: dx (with the fold of da1), dW1 and
        # the fixed-order sum of its splits
        _, by_name, _ = profiled(
            torch, lambda: fb.bwd_final(*args["bwd_final"]), 5)
        parts = {}
        for kname, kms in by_name.items():
            low = kname.lower()
            # dx is an instance of conv1x1_tc.cuh's kernel under a policy
            # of namespace bwd_final
            part = ("dx" if "conv1x1_tc_kernel<" in low
                    and "bwd_final::" in low else
                    "dW1" if "bwd_final_dw_kernel" in low else
                    "sums" if "split_sum_kernel" in low else "other")
            parts[part] = parts.get(part, 0.0) + kms
        missing = [k for k in ("dx", "dW1", "sums") if not parts.get(k)]
        if missing:
            raise RuntimeError(f"bwd_final stage {h}x{h}: the profile "
                               f"holds no time for {missing}")
        print(f"bwd_final stage Cin {cin}, C {c}, {h}x{h}, batch {n}: "
              f"{ms['bwd_final']:.4f} ms; device ms by launch (profiler): "
              + "; ".join(f"{k} {parts.get(k, 0.0):.4f}"
                          for k in ("dx", "dW1", "sums", "other")
                          if k != "other" or k in parts)
              + f"; bound {bounds['bwd_final'][0]:.4f} "
              f"{bounds['bwd_final'][1]} by 3xTF32 at "
              f"{TF32_FLOPS_PER_S / 1e12:.0f} TFLOP/s, f32 FMA bound "
              f"{f32_bound_final[0]:.4f} {f32_bound_final[1]} [{card}]")
        print(f"bwd_apply3 stage Cin {cin}, C {c}, {h}x{h}, batch {n}: "
              f"{ms['bwd_apply3']:.4f} ms, "
              f"{a3_bytes / ms['bwd_apply3'] / 1e9:.3f} TB/s of "
              f"{a3_bytes / 1e9:.3f} GB, "
              f"{a3_ops / ms['bwd_apply3'] / 1e9:.2f} TFLOP/s of the "
              f"product's {a3_ops / 1e9:.2f} GFLOP "
              f"({3 * a3_ops / ms['bwd_apply3'] / 1e9:.2f} TFLOP/s of its "
              f"3xTF32); bound {bounds['bwd_apply3'][0]:.4f} "
              f"{bounds['bwd_apply3'][1]} by 3xTF32 at "
              f"{TF32_FLOPS_PER_S / 1e12:.0f} TFLOP/s, f32 FMA bound "
              f"{f32_bound_a3[0]:.4f} {f32_bound_a3[1]} [{card}]")
        print(f"bwd_reduce3 stage Cin {cin}, C {c}, {h}x{h}: "
              f"{ms['bwd_reduce3']:.4f} ms, "
              f"{r3_bytes / ms['bwd_reduce3'] / 1e9:.3f} TB/s of "
              f"{r3_bytes / 1e9:.3f} GB, "
              f"{r3_ops / ms['bwd_reduce3'] / 1e9:.2f} TFLOP/s of "
              f"{r3_ops / 1e9:.2f} GFLOP (peaks 3.35 TB/s, 67 TFLOP/s) "
              f"[{card}]")
        print(f"bottleneck chain backward stage Cin {cin}, C {c}, {h}x{h}, "
              f"largest |kernel - plain| (elementwise tol atol {BWD_ATOL} "
              f"rtol {BWD_RTOL}; sums rtol {STATS_RTOL} of Σ|terms|): "
              + "; ".join(notes) + f" [{card}]")
        if (cin, c, h) == CHAIN_SHAPES[0]:
            for k in CHAIN_BWD_KERNELS:
                rows[k] = dict(ms=ms[k], plain_ms=plain[k],
                               bound_ms=bounds[k][0], bound_by=bounds[k][1],
                               library_ms=lib[k])
        del args, g3, a2, h2, ab, gh, g2, a1, da2, h1, g1, x, da1
    for k in rows:
        rows[k]["max_abs_err"] = max(errs[k])
    return rows


def check_chain_bf16_bwd(torch, fb, card, report):
    """The four bf16 backward kernels (csrc/fused_block_bf16.cu) vs their
    plain versions at each of CHAIN_SHAPES, on the inputs the bf16 chain
    makes (chain_bwd_inputs on a chain_case rounded to bf16 and a bf16
    cotangent of out): g3 bit for bit, g2, g1 and dx within BF16_REL
    max|plain| + BF16_REL |plain| with the share of elements that differ
    printed, the sums of g2 and g1 within STATS_RTOL of their terms'
    magnitudes plus what the flipped values move, P, Σg3 and dW1 within
    STATS_RTOL of their terms, dtaps within STATS_RTOL of its terms from
    the float64 product (bf16_bwd_readings); two calls on one input the
    same bits; each timed beside its plain version, its bound (bf16 bytes
    at 3.35 TB/s, products at the bf16 tensor cores' rate) and a bf16
    PyTorch yardstick of the same products on materialized operands
    (torch.bmm + sum; torch.matmul; cuDNN's conv2d_input + conv2d_weight;
    matmul + bmm + sum). The kernels line reports the first stage."""
    gen = torch.Generator(device="cuda").manual_seed(18)
    n, bf = RESNET["batch"], torch.bfloat16
    regs = bf16_chain_regs(report)
    rows, errs = {}, {k: [] for k in CHAIN_BF16_BWD_KERNELS}
    shares = {k: [] for k in CHAIN_BF16_BWD_KERNELS}
    for cin, c, h in CHAIN_SHAPES:
        s, m = h * h, n * h * h
        d = chain_case(torch, n, cin, c, h, gen)
        for k in ("x", "w1", "taps", "w3"):
            d[k] = d[k].to(bf)
        dout = torch.randn(n, cin, s, device="cuda", generator=gen).to(bf)
        args = chain_bwd_inputs(torch, fb, d, dout, h, "_bf16")
        del d, dout
        notes, differ, calls = [], {}, {}
        for name in CHAIN_BWD_KERNELS:
            k = name + "_bf16"
            a = args[name]
            fn = lambda k=k, a=a: getattr(fb, k)(*a)
            got = fn()
            want = getattr(fb, name + "_reference")(*a)
            torch.cuda.synchronize()
            readings = bf16_bwd_readings(torch, fb, name, a, got, want)
            bad = [what for what, (sh, _) in readings.items()
                   if not sh <= 1]
            if bad:
                raise RuntimeError(f"{k}: {bad} beyond their limits "
                                   f"(g3 bit for bit): {readings}")
            worst = max(float((gt.float() - wt.float()).abs().max())
                        for gt, wt in zip(got, want))
            share = max(sh for sh, _ in readings.values())
            for what, (sh, dif) in readings.items():
                if dif is None:
                    notes.append(f"{what} {sh:.3f}")
                elif what == "g3":
                    notes.append("g3 bitwise")
                else:
                    differ[k] = dif
                    notes.append(f"{what} {sh:.3f} of the bf16 limit, "
                                 f"{dif:.5f} differ")
            errs[k].append(worst)
            shares[k].append(share)
            again = fn()
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                raise RuntimeError(f"{k}: two calls on one input differ")
            calls[k] = (fn, lambda n_=name, a=a: getattr(
                fb, n_ + "_reference")(*a))
            del got, want, again
        # bounds: each input read once, each output written once (bf16
        # activations, taps and weights; float32 vectors, sums and
        # products over N·S); the products at the bf16 tensor cores' rate
        ea, ex = n * c * s, n * cin * s
        bounds = {
            "bwd_reduce3_bf16": bound_ms(
                2 * (3 * ex + ea) + 4 * (2 * c + cin * (c + 1)),
                2 * cin * c * m, BF16_FLOPS_PER_S),
            "bwd_apply3_bf16": bound_ms(
                2 * (ex + 2 * ea + c * (cin + c)) + 4 * 7 * c,
                2 * c * (cin + c) * m, BF16_FLOPS_PER_S),
            "bwd_mid_bf16": bound_ms(
                2 * (4 * ea + 9 * c * c) + 4 * (9 * c + 9 * c * c),
                36 * c * c * m, BF16_FLOPS_PER_S),
            "bwd_final_bf16": bound_ms(
                2 * (3 * ex + 2 * ea + c * cin) + 4 * (3 * c + c * cin),
                4 * c * cin * m, BF16_FLOPS_PER_S)}
        ms = {k: cuda_ms(torch, f, 10) for k, (f, _) in calls.items()}
        plain = {k: cuda_ms(torch, r, 3) for k, (_, r) in calls.items()}
        # yardsticks: the same products in bf16 through cuBLAS / cuDNN on
        # materialized bf16 operands
        g3, a2, sc2, sh2, amat, bmat = args["bwd_apply3"][:6]
        h2 = fb._norm_relu(a2, sc2, sh2)
        ab, gh = torch.cat([amat, bmat], 1), torch.cat([g3, h2], 1)
        g2, _, a1, sc1, sh1, p2, q2, r2 = args["bwd_mid"][:8]
        taps = args["bwd_mid"][10]
        da2 = fb._unfold(g2, a2, p2, q2, r2).to(bf).view(n, c, h, h)
        h1 = fb._norm_relu(a1, sc1, sh1).view(n, c, h, h)
        w2 = taps.view(3, 3, c, c).permute(2, 3, 0, 1).contiguous()
        _, g1, _, x, p1, q1, r1, w1 = args["bwd_final"]
        da1 = fb._unfold(g1, a1, p1, q1, r1).to(bf)
        lib = {"bwd_reduce3_bf16": cuda_ms(torch, lambda: (torch.bmm(
                   g3, h2.transpose(1, 2)).sum(dim=0),
                   g3.float().sum(dim=(0, 2))), 10),
               "bwd_apply3_bf16": cuda_ms(torch, lambda: torch.matmul(
                   ab, gh), 10),
               "bwd_mid_bf16": cuda_ms(torch, lambda: (
                   torch.nn.grad.conv2d_input(h1.shape, w2, da2, padding=1),
                   torch.nn.grad.conv2d_weight(h1, w2.shape, da2, padding=1)),
                   10),
               "bwd_final_bf16": cuda_ms(torch, lambda: (
                   torch.matmul(w1.T, da1),
                   torch.bmm(da1, x.transpose(1, 2)).sum(dim=0)), 10)}
        yard = {"bwd_reduce3_bf16": "bmm + sum", "bwd_apply3_bf16": "matmul",
                "bwd_mid_bf16": "cuDNN dgrad + wgrad",
                "bwd_final_bf16": "matmul + bmm + sum"}
        print(f"bottleneck chain bf16 backward stage Cin {cin}, C {c}, "
              f"{h}x{h}, batch {n}: " + "; ".join(
                  f"{k} {ms[k]:.4f} ms (plain {plain[k]:.4f}, {yard[k]} "
                  f"bf16 {lib[k]:.4f}, bound {bounds[k][0]:.4f} "
                  f"{bounds[k][1]}, largest share of its limits "
                  f"{shares[k][-1]:.4f}" + (
                      f", elements that differ {differ[k]:.5f}"
                      if k in differ else "") + ")"
                  for k in CHAIN_BF16_BWD_KERNELS)
              + f"; backward {sum(ms.values()):.4f} ms vs bound "
              f"{sum(b[0] for b in bounds.values()):.4f} ms; two calls the "
              f"same bits [{card}]")
        print(f"bottleneck chain bf16 backward stage Cin {cin}, C {c}, "
              f"{h}x{h}, shares of the limits: " + "; ".join(notes)
              + f" [{card}]")
        if (cin, c, h) == CHAIN_SHAPES[0]:
            for k in CHAIN_BF16_BWD_KERNELS:
                rows[k] = dict(ms=ms[k], plain_ms=plain[k],
                               bound_ms=bounds[k][0], bound_by=bounds[k][1],
                               library_ms=lib[k])
        del args, calls, g3, a2, h2, ab, gh, g2, a1, da2, h1, g1, x, da1
    for k in CHAIN_BF16_BWD_KERNELS:
        rows[k]["max_abs_err"] = max(errs[k])
        print(f"{k}: largest share of its limits over the three stages "
              f"{max(shares[k]):.4f}; {regs[k]} [{card}]")
    return rows


def bf16_bwd_readings(torch, fb, name, args, got, want):
    """A bf16 backward kernel's outputs (got) against its plain version's
    (want) on args: {output: (its largest share of its limit, the share
    of its elements that differ from the plain version's; None for a
    float32 sum)}. g3 bit for bit (share 0, else inf); g2, g1 and dx
    within BF16_REL max|plain| + BF16_REL |plain|; the sums of g2 and g1
    within STATS_RTOL of their terms' magnitudes plus what the values
    that differ move them; P, Σg3 and dW1 (products of the same bf16
    operands) within STATS_RTOL of their terms; dtaps within STATS_RTOL
    of its terms from the float64 product of the same bf16 operands (the
    plain version's product, cuDNN's float32 wgrad on the card, reads
    1.13 of that limit itself at N 1, C 256, 14²). Phase 3, the card
    tests and scripts/emulate_fused_block_bf16_cpu.py hold them here."""
    def share(gt, wt, terms, moved=0.0):
        lim = STATS_RTOL * terms + moved
        return float(((gt.double() - wt.double()).abs()
                      / lim.clamp_min(1e-30)).max())

    def differ(gt, wt):
        return float((gt != wt).float().mean())

    out = {}
    if name == "bwd_reduce3":
        g3 = want[0].float().abs()
        h2 = fb._norm_relu(*args[2:5]).float()
        out["g3"] = (0.0 if torch.equal(got[0], want[0]) else math.inf,
                     differ(got[0], want[0]))
        out["P"] = (share(got[1], want[1],
                          torch.einsum("nis,ncs->ic", g3, h2)), None)
        out["Σg3"] = (share(got[2], want[2], g3.sum(dim=(0, 2))), None)
        return out
    if name == "bwd_final":
        g3, g1, a1, x, p1, q1, r1, _ = args
        da1 = fb._unfold(g1, a1, p1, q1, r1).to(torch.bfloat16).float()
        out["dx"] = (bf16_share(torch, got[0], want[0]),
                     differ(got[0], want[0]))
        out["dW1"] = (share(got[1], want[1], torch.einsum(
            "ncs,nks->ck", da1.abs(), x.float())), None)
        return out
    g, k = ("g2", "2") if name == "bwd_apply3" else ("g1", "1")
    a, inv, m = ((args[1], args[7], args[8]) if name == "bwd_apply3"
                 else (args[2], args[8], args[9]))
    out[g] = (bf16_share(torch, got[0], want[0]), differ(got[0], want[0]))
    moved = (got[0].float() - want[0].float()).abs()
    gw = want[0].float().abs()
    xh = fb._affine(a, inv, -m * inv).abs()
    out["Σ" + g] = (share(got[-2], want[-2], gw.sum(dim=(0, 2)),
                          moved.sum(dim=(0, 2))), None)
    out[f"Σ{g}·x̂{k}"] = (share(got[-1], want[-1], (gw * xh).sum(dim=(0, 2)),
                               (moved * xh).sum(dim=(0, 2))), None)
    if name == "bwd_mid":
        g2, a2, a1, sc1, sh1, p2, q2, r2, _, _, _, h = args
        n, c, s = g2.shape
        da2 = fb._unfold(g2, a2, p2, q2, r2).to(torch.bfloat16).double()
        h1 = fb._norm_relu(a1, sc1, sh1).double().view(n, c, h, s // h)

        def taps(hh, dd):
            return torch.nn.grad.conv2d_weight(
                hh, (c, c, 3, 3), dd.view(n, c, h, s // h),
                padding=1).permute(2, 3, 0, 1).reshape(9, c, c)

        out["dtaps"] = (share(got[1], taps(h1, da2),
                              taps(h1.abs(), da2.abs())), None)
    return out


def block_host_ms(torch, fb, run):
    """Host time of each fused_bottleneck op in one run of each variant,
    on the host clock around the op's compute (which queues its launches
    and syncs nowhere): {chain: [(ms, through the chain)]}; and of each
    chain block's backward (bottleneck_rest_bwd, which syncs nowhere
    either): {chain: [ms]}."""
    from paddle_tpu_torch.core import registry

    op = registry.get_op("fused_bottleneck")
    compute, backward, host, host_bwd = (op.compute, fb.bottleneck_rest_bwd,
                                         [], [])

    def timed(ctx, ins, attrs):
        before = fb.conv1x1_stats.launches
        t0 = time.perf_counter()
        out = compute(ctx, ins, attrs)
        host.append((1e3 * (time.perf_counter() - t0),
                     fb.conv1x1_stats.launches > before))
        return out

    def timed_bwd(*args):
        t0 = time.perf_counter()
        out = backward(*args)
        host_bwd.append(1e3 * (time.perf_counter() - t0))
        return out

    op.compute, fb.bottleneck_rest_bwd = timed, timed_bwd
    got, got_bwd = {}, {}
    try:
        for chain_on in (False, True):
            torch.cuda.synchronize()
            host.clear()
            host_bwd.clear()
            run(chain_on)
            got[chain_on], got_bwd[chain_on] = list(host), list(host_bwd)
    finally:
        op.compute, fb.bottleneck_rest_bwd = compute, backward
    return got, got_bwd


def chain_path(np, torch, fb, card, built):
    """ResNet-50's training-mode forward at full width, through the
    composition and through the chain (PT_FUSED_BLOCK=always), from one
    startup state; returns the chain kernels' launch counts."""
    import paddle_tpu_torch as pt

    b, img = RESNET["batch"], RESNET["image"]
    avg, acc = built["avg"], built["acc"]
    fwd = built["main"].prune([avg.name, acc.name])
    ops = [op for op in fwd.global_block.ops if op.type == "fused_bottleneck"]
    slots = [slot.format(k=k) for k in "123" for slot in
             ("MeanOut{k}", "VarOut{k}", "SavedMean{k}", "SavedVar{k}")]
    stat_names = [op.output(slot)[0] for op in ops for slot in slots]
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(built["startup"], scope=scope)
    state0 = {name: scope.find_var(name).clone()
              for name in scope.local_var_names()}
    feed = {k: torch.from_numpy(v).to(exe.device)
            for k, v in resnet_varied(np, 0, b, img).items()}
    torch.cuda.synchronize()
    prev = os.environ.get("PT_FUSED_BLOCK")

    def forward(chain, fetch=(), data=None, restore=True):
        """One training-mode forward; restore: from the startup state."""
        if restore:
            for name, v in state0.items():
                scope.set_var(name, v.clone())
        os.environ["PT_FUSED_BLOCK"] = "always" if chain else "never"
        f = dict(feed, data=feed["data"] if data is None else data)
        return exe.run(fwd, feed=f, fetch_list=[avg.name] + list(fetch),
                       scope=scope)

    def outputs(chain, data=None):
        got = forward(chain, stat_names, data)
        vals = dict(zip(stat_names, got[1:]))
        for name in stat_names:
            if name in state0:     # a running stat: its update this forward
                vals[name] = vals[name] - state0[name].cpu().numpy()
        return float(got[0][0]), vals

    def rel_rms(got, want):
        return max(rms(np, got[k] - want[k]) / max(rms(np, want[k]), 1e-30)
                   for k in want)

    try:
        loss_c, comp = outputs(False)
        loss_p, pert = outputs(False, feed["data"] * (1 + PERTURB))
        for name in CHAIN_KERNELS:
            getattr(fb, name).launches = 0
        loss_k, chain = outputs(True)
        n_fwd = 1
        loss_lim = LOSS_RTOL * abs(loss_c)
        stat_lim = max(STATE_RTOL, SPREAD * rel_rms(pert, comp))
        d_loss, d_stats = abs(loss_k - loss_c), rel_rms(chain, comp)
        print(f"chain path: ResNet-50 training-mode forward, batch {b}, {img} "
              f"px, {len(ops)} rest blocks ({fb.conv1x1_stats.launches} "
              f"through the chain), {len(stat_names)} stat outputs: "
              f"loss composition {loss_c!r}, chain {loss_k!r} (diff "
              f"{d_loss:.3e}, tol {loss_lim:.3e}); stat outputs (running "
              f"stats as their updates) largest relative rms diff "
              f"{d_stats:.3e} (tol {stat_lim:.3e}); the composition with "
              f"images x (1 + {PERTURB}): loss diff {abs(loss_p - loss_c):.3e},"
              f" stats {rel_rms(pert, comp):.3e} [{card}]")
        if not (np.isfinite(loss_k) and d_loss <= loss_lim
                and d_stats <= stat_lim):
            raise RuntimeError("the chain's training-mode forward disagrees "
                               "with the composition's")
        times = {False: [], True: []}
        for chain_on in (False, True):
            forward(chain_on, restore=False)
        n_fwd += 1
        for _ in range(CHAIN_FORWARDS):
            for chain_on in (False, True):
                t0 = time.perf_counter()
                forward(chain_on, restore=False)
                times[chain_on].append(time.perf_counter() - t0)
        n_fwd += CHAIN_FORWARDS
        for chain_on, what in ((False, "composition"), (True, "chain")):
            ms = 1e3 * sum(times[chain_on]) / CHAIN_FORWARDS
            print(f"chain path: {what} forward {ms:.3f} ms "
                  f"({[round(1e3 * t, 2) for t in times[chain_on]]}), "
                  f"{b / ms * 1e3:.1f} images/s [{card}]")
            wall, by_name, _ = profiled(
                torch, lambda c=chain_on: forward(c, restore=False), 1)
            print_profile(f"ResNet-50 training-mode forward, {what} (batch "
                          f"{b}, {img} px)", wall, by_name, card)
        n_fwd += 2
        host, _ = block_host_ms(torch, fb,
                                lambda c: forward(c, restore=False))
        n_fwd += 1
        print(f"chain path: host ms of each fused_bottleneck op (its "
              f"launches queued, no sync): composition "
              f"{[round(t, 3) for t, _ in host[False]]}, chain "
              f"{[round(t, 3) for t, _ in host[True]]}; the chain's blocks "
              f"{sum(t for t, k in host[True] if k):.3f} ms against "
              f"{sum(t for (t, _), (_, k) in zip(host[False], host[True]) if k):.3f}"
              f" for the same blocks composed [{card}]")
        launches = {name: getattr(fb, name).launches
                    for name in CHAIN_KERNELS}
    finally:
        if prev is None:
            os.environ.pop("PT_FUSED_BLOCK", None)
        else:
            os.environ["PT_FUSED_BLOCK"] = prev
    print(f"chain path launches over {n_fwd} chain forwards: {launches}")
    want = CHAIN_BLOCKS * n_fwd
    for name, count in launches.items():
        if count != want:
            raise RuntimeError(f"{name} was launched {count} times on the "
                               f"chain path, expected {want} ({CHAIN_BLOCKS} "
                               f"a forward)")
    return launches


def chain_train_path(np, torch, fb, card, built):
    """ResNet-50 training at full width through the composition and
    through the chain (PT_FUSED_BLOCK=always), from one startup state;
    returns the eight chain kernels' launch counts of the phase."""
    import paddle_tpu_torch as pt

    b, img = RESNET["batch"], RESNET["image"]
    main_prog, avg = built["main"], built["avg"]
    exe, scope0 = pt.Executor(), pt.Scope()
    exe.run(built["startup"], scope=scope0)
    names = sorted(scope0.local_var_names())
    start = {n: scope0.find_var(n).clone() for n in names}
    start_np = {n: v.cpu().numpy() for n, v in start.items()}
    del scope0
    feed = {k: torch.from_numpy(v).to(exe.device)
            for k, v in resnet_varied(np, 0, b, img).items()}
    kernels = CHAIN_KERNELS + CHAIN_BWD_KERNELS
    prev = os.environ.get("PT_FUSED_BLOCK")

    def fresh():
        sc = pt.Scope()
        for n in names:
            sc.set_var(n, start[n].clone())
        return sc

    def step(chain, sc, data=None):
        """One Momentum step; the loss fetch syncs."""
        os.environ["PT_FUSED_BLOCK"] = "always" if chain else "never"
        f = feed if data is None else dict(feed, data=data)
        loss, = exe.run(main_prog, feed=f, fetch_list=[avg], scope=sc)
        return float(loss[0])

    def one_step(chain, data=None):
        sc = fresh()
        loss = step(chain, sc, data)
        return loss, {n: sc.get_numpy(n) for n in names}

    try:
        for name in kernels:
            getattr(fb, name).launches = 0
        # agreement: one step of each from the startup state, beside what
        # a PERTURB change of the images does to the composition's step
        loss_c, comp = one_step(False)
        loss_p, pert = one_step(False, feed["data"] * (1 + PERTURB))
        loss_k, chain = one_step(True)
        n_chain = 1
        loss_lim = LOSS_RTOL * abs(loss_c)
        print(f"chain train path: ResNet-50, batch {b}, {img} px, one "
              f"Momentum step from one startup state: loss composition "
              f"{loss_c!r}, chain {loss_k!r} (diff {abs(loss_k - loss_c):.3e}"
              f", tol {loss_lim:.3e}), images x (1 + {PERTURB}) "
              f"{loss_p!r}; every var's update, chain - composition "
              f"[{card}]")
        ok = hold_to_perturbation(
            np, "updates (parameters, velocities, running stats)",
            state_diffs(np, chain, comp, start_np, names),
            state_diffs(np, pert, comp, start_np, names))
        if not (np.isfinite(loss_k) and abs(loss_k - loss_c) <= loss_lim
                and ok):
            raise RuntimeError("the chain's training step disagrees with "
                               "the composition's beyond the chaos of a "
                               f"{PERTURB} input change")
        del comp, pert, chain
        # timing: a warm-up and RESNET_STEPS steps of each, in turns, each
        # on its own state; peak memory of each step, reset before it
        scopes = {False: fresh(), True: fresh()}
        losses = {False: [], True: []}
        times = {False: [], True: []}
        peak = {False: 0.0, True: 0.0}
        for i in range(1 + RESNET_STEPS):
            for chain_on in (False, True):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                losses[chain_on].append(step(chain_on, scopes[chain_on]))
                if i:
                    times[chain_on].append(time.perf_counter() - t0)
                peak[chain_on] = max(peak[chain_on],
                                     torch.cuda.max_memory_allocated() / 1e9)
        n_chain += 1 + RESNET_STEPS
        for chain_on, what in ((False, "composition"), (True, "chain")):
            ms = 1e3 * sum(times[chain_on]) / RESNET_STEPS
            print(f"chain train path: {what} losses {losses[chain_on]}, "
                  f"{RESNET_STEPS} timed steps "
                  f"{[round(1e3 * t, 2) for t in times[chain_on]]} ms: "
                  f"{ms:.3f} ms per step, {b / ms * 1e3:.1f} images/s, peak "
                  f"memory {peak[chain_on]:.2f} GB (both states resident) "
                  f"[{card}]")
        if not (all(np.isfinite(losses[True]))
                and losses[True][-1] < losses[True][0]):
            raise RuntimeError(f"the chain's losses are not finite and "
                               f"falling: {losses[True]}")
        for chain_on, what in ((False, "composition"), (True, "chain")):
            wall, by_name, _ = profiled(
                torch, lambda c=chain_on: step(c, scopes[c]), 1)
            print_profile(f"ResNet-50 training step, {what} (batch {b}, "
                          f"{img} px)", wall, by_name, card)
        n_chain += 2      # profiled() runs its step twice
        host, host_bwd = block_host_ms(torch, fb,
                                       lambda c: step(c, scopes[c]))
        n_chain += 1
        same = [t for (t, _), (_, k) in zip(host[False], host[True]) if k]
        print(f"chain train path: host ms of each fused_bottleneck op's "
              f"forward (its launches queued, no sync): composition "
              f"{[round(t, 3) for t, _ in host[False]]}, chain "
              f"{[round(t, 3) for t, _ in host[True]]}; the chain's blocks "
              f"{sum(t for t, k in host[True] if k):.3f} ms against "
              f"{sum(same):.3f} for the same blocks composed; the chain "
              f"blocks' backward (bottleneck_rest_bwd) "
              f"{[round(t, 3) for t in host_bwd[True]]}, "
              f"{sum(host_bwd[True]):.3f} ms [{card}]")
        launches = {name: getattr(fb, name).launches for name in kernels}
    finally:
        if prev is None:
            os.environ.pop("PT_FUSED_BLOCK", None)
        else:
            os.environ["PT_FUSED_BLOCK"] = prev
    print(f"chain train path launches over {n_chain} chain steps: "
          f"{launches}")
    want = CHAIN_BLOCKS * n_chain
    for name, count in launches.items():
        if count != want:
            raise RuntimeError(f"{name} was launched {count} times on the "
                               f"chain's training path, expected {want} "
                               f"({CHAIN_BLOCKS} a step)")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    card = card_line()
    print(f"card: {card}")
    from paddle_tpu_torch.kernels import build
    from paddle_tpu_torch.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 products (phase 16) sum in float32 throughout: with PyTorch's
    # default (True) cuBLAS may round a product's partial sums to bf16
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    t0 = time.perf_counter()
    report = build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s for "
          f"{sorted(report) or 'nothing (cached)'}")
    for src, r in report.items():
        for line in r["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {src}: {line.strip()}")

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.kernels import fused_block as fb
    from paddle_tpu_torch.kernels import fused_conv as fc
    from paddle_tpu_torch.kernels import fused_lstm as fl

    built = build_resnet50(pt, args.seed)
    dq_row, dkv_row = check_flash_bwd(torch, F, fa, card)
    rows = {"flash_attention_fwd": check_flash(torch, F, fa, card),
            "paged_decode_attention": check_paged(torch, fa, card),
            "paged_decode_attention_bf16": check_paged(torch, fa, card,
                                                       bf16=True),
            "flash_attention_bwd_dq": dq_row,
            "flash_attention_bwd_dkv": dkv_row}
    rows.update(check_flash_bf16(torch, F, fa, card))
    ops = epilogue_ops(built["fused"], RESNET["batch"])
    rows.update(check_epilogue(torch, F, fc, card, ops))
    rows.update(check_epilogue(torch, F, fc, card, ops, bf16=True))
    rows.update(check_lstm(np, torch, fl, card, args.seed))
    rows.update(check_lstm_bf16(np, torch, fl, card, args.seed))
    rows.update(check_chain(torch, F, fb, card))
    rows.update(check_chain_bf16(torch, F, fb, card, report))
    rows.update(check_chain_bwd(torch, fb, card))
    rows.update(check_chain_bf16_bwd(torch, fb, card, report))
    launches = main_path(np, torch, fa, card, args.seed)
    trained = train_path(np, torch, fa, card, args.seed)
    # the forward kernel runs on both main paths
    launches["flash_attention_fwd"] += trained["flash_attention_fwd"]
    launches.update(flash_attention_bwd_dq=trained["flash_attention_bwd_dq"],
                    flash_attention_bwd_dkv=trained["flash_attention_bwd_dkv"])
    card_vs_cpu(np, torch, card, args.seed)
    launches.update(resnet_path(np, torch, fc, card, built))
    resnet_card_vs_cpu(np, torch, card, args.seed)
    launches.update(lstm_path(np, torch, fl, card, args.seed))
    lstm_card_vs_cpu(np, torch, card, args.seed)
    forward = chain_path(np, torch, fb, card, built)
    # the forward kernels run on both chain paths
    launches.update({k: forward.get(k, 0) + v for k, v in
                     chain_train_path(np, torch, fb, card, built).items()})
    # the one-shot engine, the decode facade and the fleet run both
    # attention kernels
    with tempfile.TemporaryDirectory() as root:
        lm = export_lm(np, args.seed, root)
        for path in (serving_path, fleet_path):
            for name, n in path(np, torch, fa, card, args.seed, lm).items():
                launches[name] += n
    for name, n in trainer_path(np, torch, fa, card, args.seed).items():
        launches[name] += n
    launches.update(amp_train_path(np, torch, fa, card, args.seed))
    amp_card_vs_cpu(np, torch, card, args.seed)
    launches.update(lstm_amp_path(np, torch, fl, card, args.seed))
    lstm_amp_card_vs_cpu(np, torch, card, args.seed)
    launches.update(resnet_bf16_path(np, torch, fc, card, built, args.seed))
    resnet_bf16_card_vs_cpu(np, torch, card, args.seed)
    launches.update(resnet_bf16_chain_path(np, torch, fb, card, built,
                                           args.seed))
    # the bf16 forward kernels run on both bf16 chain paths
    for name, n in resnet_bf16_chain_train_path(np, torch, fb, card, built,
                                                args.seed).items():
        launches[name] = launches.get(name, 0) + n
    launches.update(decode_bf16_path(np, torch, fa, card, args.seed))

    meta = {"flash_attention_fwd": (
                "paddle_tpu_torch/csrc/flash_attention.cu",
                "paddle_tpu/kernels/flash_attention.py:151"),
            "paged_decode_attention": (
                "paddle_tpu_torch/csrc/paged_attention.cu",
                "paddle_tpu/kernels/flash_attention.py:570"),
            "paged_decode_attention_bf16": (
                "paddle_tpu_torch/csrc/paged_attention.cu",
                "paddle_tpu/kernels/flash_attention.py:570"),
            "flash_attention_bwd_dq": (
                "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
                "paddle_tpu/kernels/flash_attention.py:279"),
            "flash_attention_bwd_dkv": (
                "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
                "paddle_tpu/kernels/flash_attention.py:298"),
            "flash_attention_fwd_bf16": (
                "paddle_tpu_torch/csrc/flash_attention_bf16.cu",
                "paddle_tpu/kernels/flash_attention.py:151"),
            "flash_attention_bwd_dq_bf16": (
                "paddle_tpu_torch/csrc/flash_attention_bf16.cu",
                "paddle_tpu/kernels/flash_attention.py:279"),
            "flash_attention_bwd_dkv_bf16": (
                "paddle_tpu_torch/csrc/flash_attention_bf16.cu",
                "paddle_tpu/kernels/flash_attention.py:298"),
            "channel_stats": ("paddle_tpu_torch/csrc/fused_conv.cu",
                              "paddle_tpu/kernels/fused_conv.py:85"),
            "apply_epilogue": ("paddle_tpu_torch/csrc/fused_conv.cu",
                               "paddle_tpu/kernels/fused_conv.py:137"),
            "apply_epilogue_add": ("paddle_tpu_torch/csrc/fused_conv.cu",
                                   "paddle_tpu/kernels/fused_conv.py:147"),
            "channel_stats_bf16": ("paddle_tpu_torch/csrc/fused_conv.cu",
                                   "paddle_tpu/kernels/fused_conv.py:85"),
            "apply_epilogue_bf16": ("paddle_tpu_torch/csrc/fused_conv.cu",
                                    "paddle_tpu/kernels/fused_conv.py:137"),
            "apply_epilogue_add_bf16": (
                "paddle_tpu_torch/csrc/fused_conv.cu",
                "paddle_tpu/kernels/fused_conv.py:147"),
            "lstm_seq_fwd": ("paddle_tpu_torch/csrc/fused_lstm.cu",
                             "paddle_tpu/kernels/fused_lstm.py:78"),
            "lstm_seq_bwd": ("paddle_tpu_torch/csrc/fused_lstm.cu",
                             "paddle_tpu/kernels/fused_lstm.py:207"),
            "lstm_seq_fwd_bf16": ("paddle_tpu_torch/csrc/fused_lstm_bf16.cu",
                                  "paddle_tpu/kernels/fused_lstm.py:78"),
            "lstm_seq_bwd_bf16": ("paddle_tpu_torch/csrc/fused_lstm_bf16.cu",
                                  "paddle_tpu/kernels/fused_lstm.py:207"),
            "conv1x1_stats": ("paddle_tpu_torch/csrc/conv1x1_stats_tc.cuh",
                              "paddle_tpu/kernels/fused_block.py:790"),
            "conv3x3_norm_stats": ("paddle_tpu_torch/csrc/conv3x3_tc.cuh",
                                   "paddle_tpu/kernels/fused_block.py:653"),
            "norm_relu_moments": ("paddle_tpu_torch/csrc/moments_tc.cuh",
                                  "paddle_tpu/kernels/fused_block.py:714"),
            "conv1x1_bn_residual": ("paddle_tpu_torch/csrc/conv1x1_tc.cuh",
                                    "paddle_tpu/kernels/fused_block.py:756"),
            "conv1x1_stats_bf16": ("paddle_tpu_torch/csrc/fused_block_bf16.cu",
                                   "paddle_tpu/kernels/fused_block.py:790"),
            "conv3x3_norm_stats_bf16": (
                "paddle_tpu_torch/csrc/fused_block_bf16.cu",
                "paddle_tpu/kernels/fused_block.py:653"),
            "norm_relu_moments_bf16": (
                "paddle_tpu_torch/csrc/fused_block_bf16.cu",
                "paddle_tpu/kernels/fused_block.py:714"),
            "conv1x1_bn_residual_bf16": (
                "paddle_tpu_torch/csrc/conv1x1_bf16_tc.cuh",
                "paddle_tpu/kernels/fused_block.py:756"),
            "bwd_reduce3": ("paddle_tpu_torch/csrc/bwd_reduce3.cuh",
                            "paddle_tpu/kernels/fused_block.py:192"),
            "bwd_apply3": ("paddle_tpu_torch/csrc/bwd_apply3_tc.cuh",
                           "paddle_tpu/kernels/fused_block.py:261"),
            "bwd_mid": ("paddle_tpu_torch/csrc/bwd_mid_tc.cuh",
                        "paddle_tpu/kernels/fused_block.py:399"),
            "bwd_final": ("paddle_tpu_torch/csrc/bwd_final_tc.cuh",
                          "paddle_tpu/kernels/fused_block.py:466"),
            "bwd_reduce3_bf16": ("paddle_tpu_torch/csrc/abt_bf16_tc.cuh",
                                 "paddle_tpu/kernels/fused_block.py:192"),
            "bwd_apply3_bf16": ("paddle_tpu_torch/csrc/fused_block_bf16.cu",
                                "paddle_tpu/kernels/fused_block.py:261"),
            "bwd_mid_bf16": ("paddle_tpu_torch/csrc/fused_block_bf16.cu",
                             "paddle_tpu/kernels/fused_block.py:399"),
            "bwd_final_bf16": ("paddle_tpu_torch/csrc/conv1x1_bf16_tc.cuh",
                               "paddle_tpu/kernels/fused_block.py:466")}
    kernels = [dict(name=name, route="cuda", source=meta[name][0],
                    replaces=meta[name][1], launches=launches[name], **row)
               for name, row in rows.items()]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
