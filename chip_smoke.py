"""Smoke run of ray_tpu_torch on one NVIDIA GPU: builds the CUDA kernels from
the checkout, holds each against its plain PyTorch version, then drives the
GPT-2-small forward and train step through them, bare and through the port's
runtime and its GPU trainer, the ResNet-50 train step, the port's bench, the
sharded step on a one-device mesh with ring attention's kernel route, the
collective groups and a compiled graph's CUDA device edge in runtime actors,
RLlib's learners on the card with CPU env runners, Serve's GPU replicas
answering GPT-2-small requests under loadgen, Tune trials that are GPU
trainers, the port as a GPU cluster: cluster_utils, the CLI, a job,
the state API, the dashboard, client mode and a workflow of GPU steps, and
its scale-out: the native extensions, an autoscaled GPU node and ray_perf,
chaos: the port's lint gate, the chaos suite and a nemesis against GPU
work, the kernels at the head dims of the JAX package's example,
Phi-3-mini and Gemma-2B, and at every call the TPU kernels take past
those: head dim 512 in a train step, 66,560 heads in one call, and the
streamed kernels past 512 (head dim 1024, forward and train step) and at
f32 512.

    python3 chip_smoke.py            # needs one CUDA card, nvcc, the checkout

Phases, each printing one JSON line:
  1. card     nvidia-smi's name and power limit, torch's device name;
     build    each kernel's registers and spills (ptxas -v) and its counts of
              tensor-core instructions (HMMA for mma.sync, HGMMA for wgmma,
              in cuobjdump -sass); every Hopper kernel (*_sm90: the bf16
              forward and both backward kernels, at each of the widths 32,
              64, 96, 128, 256 and 512: 48; *_sm90_f32: the f32 forward and
              both f32 backward kernels at 32, 64, 96, 128 and 256: 40;
              *_sm90_stream: the streamed forward over P (bf16, f32 as
              parts), CAUSAL and WRITE_LSE, and both streamed backward
              kernels over P and CAUSAL, D a runtime value: 8 + 8) must
              have HGMMA, no spill and no wgmma that ptxas serialized;
  2. kernels  every kernel against its plain version, element by element
              (f32 with TF32 off and bf16; causal and not; head_dim 64 and
              128; T in 1, 100, 192, 1000, 1024; T = 300 on S = 1000 keys
              without the mask (head_dim 64 and 128), T = 1000 on S = 300
              with it (128); head_dim 32, 80, 96, 192 and 256 (80 and 192
              padded to the next width) at T in 1, 100, 1000 and T =
              1000 on S = 300 with the mask; the same at head dims 320,
              384 and 512 (320 and 384 padded to 512); GQA through `mha`;
              BH = 65536 and 66,560 heads in one call, and B1-B4 at
              [65600, 256, 128] bf16 (BH*T*D past 2^31 elements) held on
              sampled heads, the last among them, against the plain
              versions run on those heads alone); B1-B4 on the streamed
              kernels at head dims 576, 768, 1024 and 2048 (576 and 768
              padded to 1024), both dtypes, and f32 at 512, at T in 1,
              100, 1000 and T = 1000 on S = 300 with the mask, their
              column slices agreeing bitwise at 1024 and a second call
              repeating bitwise; B1-B4 at scales -1/sqrt(D) and 0; and at
              head dim 16 (padded to 32), both dtypes, causal or not, T in
              1, 100, 1000 and T = 1000 on S = 300 with the mask; then at
              the slice's shape (batch 8), the bench's (batch 32) and phase
              17's ([128, 2048, 96], [32, 2048, 256], [64, 256, 32]), the
              example's widths at [128, 2048, 32], phase 18's
              ([16, 2048, 512], [66560, 64, 96]) and [16, 2048, 320]
              (padded to 512), and the f32 kernels at [96, 1024, 64],
              [32, 2048, 256], [16, 2048, 512] (the streamed kernels),
              [96, 1024, 128] (bf16 too) and [128, 2048, 96], B1-B4 at
              [8, 2048, 1024] and [4, 2048, 2048] in bf16 and f32, with the
              f32 route's split passes (bitwise their plain version; f32
              bounds at PEAK_F32_SPLIT; the f32 B3 and B4 timed on their
              parts, and with the backward's split of do beside SDPA's f32
              backward): the kernel's
              time, the plain version's, F.scaled_dot_product_attention's (a
              yardstick only: the port never calls it; with the backends
              that take the inputs), the bound (the largest of the bytes,
              the flops and the exps, one a (query, key) pair, at the
              card's exp rate), the
              useful TFLOP/s, the share of the bound reached (bound_ms /
              ms) and the host's us per call; which kernels an f32 B1-B4
              launch at each width, by the profiler's names (64-256: the
              split pass and the *_sm90_f32 kernels; 512: the split pass
              and the *_sm90_stream kernels); and where the forward and the
              backward kernels (bf16 and f32) spend a streamed tile, in SM
              cycles, from a build with their cycle stamps (kernel_ab
              --timeline);
  3. forward  transformer_apply at GPT-2-small widths through the kernels and
              through the plain attention in bf16, each against the same
              weights run in f32; then those weights built in f32 through
              the kernels (B1 on the tensor cores through the split pass,
              once a layer) against the plain attention in f32, within
              F32_LOGITS_ATOL;
  4. train    the first step's loss and gradients through the kernels and
              through the plain attention in bf16, each against f32; the
              same weights built in f32 through the kernels (B2-B4 on the
              tensor cores through the split passes, B3 and B4 once a
              layer, no flash kernel off the *_sm90* ones by the
              profiler's names): loss within F32_ATOL and every gradient
              within F32_GRAD_REL of the plain f32 path's; then
              make_train_step: a warm-up and ten steps on one repeated
              batch; losses, tokens/s, useful- and hardware-MFU;
  5. profile  where a train step spends its device time, by kernel family,
              and the device's idle share;
  6. trainer  the same step through the runtime: a bare run in this process
              on weights and a batch from SEED + 1, then ray_tpu_torch.init
              and a one-worker TorchTrainer (use_gpu=True) whose runtime
              worker takes the same warm-up and ten steps on cuda:0,
              checkpointing after step 5, and a second fit resumed from that
              checkpoint for steps 6-10; losses, launches and step times of
              the worker against the bare run;
  7. resnet   ResNet-50 at full width (1000 classes, 224x224): the bf16
              train-mode forward and its running statistics, and the first
              gradients (eval mode; train mode's are reported), against the
              same weights run in f32 (TF32 off), each within its stated
              bound; ResNet-18's train-mode gradients, and each of
              ResNet-50's batch norms alone in train mode, forward and
              backward, likewise; then the bench's step
              (batch 128, SGD): a warm-up and ten steps on one batch with a
              falling loss, images/s, MFU and peak memory, and where two
              further steps spend their device time;
  8. bench    `python -m ray_tpu_torch.bench` (its step, transformer and e2e
              phases, each in a process of its own): its line must hold all
              three phases, no `*_error` key, rates above 0, MFUs below 1,
              4096 e2e images, each read by the worker's step with the
              label and bytes the dataset made for it (rows_intact), no jax
              or ray_tpu module in the e2e worker and
              CUDA tensors bitwise equal through the object store;
  9. mesh     (a) make_train_step on make_mesh(_factor_axes(1)), a world of
              one on NCCL (FSDP2 over the 1x1 data/fsdp sub-mesh), against
              the bare step on the same weights and batch: a warm-up and
              MESH_STEPS steps each, in turns; losses and grad_norms within
              LOSS_BOUND of the bare run's, the same kernel launches, step
              ms and peak memory of both; (b) ring attention's kernel route
              in loopback (RING_SHAPE in RING_SHARDS shards, bf16 and f32,
              causal and not; one B2, B3 and B4 launch per hop not skipped)
              against the plain full attention, its ms beside one
              full-sequence kernel call's, no synchronising call in it and
              its device time by kernel family; each kernel timed without
              the causal mask and at one hop's shape; (c) a one-worker GPU TorchTrainer running (a)'s
              sharded step, its losses within LOSS_BOUND of (a)'s;
 10. collective in two GPU actors of the runtime sharing the card (GPU 0.5
              each): (a) one joins a collective group on NCCL at world 1
              and a store group, runs every op on both on 16 MiB bf16 and
              f32 CUDA tensors (the same answers, bitwise) and reports both
              allreduce rates and the telemetry families; (b) ring and
              Ulysses attention on the NCCL group at RING_SHAPE (bf16/f32,
              causal or not) against the kernels' plain versions, one B2,
              B3 and B4 launch each, their ms beside one full-sequence
              call's; (c) the two form a 2-rank gloo group (NCCL refuses two
              ranks on one card) and a compiled DAG moves the producer's
              16 MiB bf16 CUDA tensor to the consumer over a device edge:
              by CUDA IPC, bitwise, with no device-to-host copy in the
              producer's profile, and STOP through the same edge; its rate
              against the same graph on a "tensor" (shm) edge;
 11. rllib    RLlib on the port, no gymnasium needed: (a) every learner
              (PPO separate and shared, IMPALA, APPO, DQN, CQL, SAC at
              (256, 256), BC, MARWIL) on cuda, TF32 off, against the same
              learner on the CPU in f64: loss, metrics and gradients, then
              three update_from_batch steps; (b) PPO learns the numpy CartPole of
              ray_tpu_torch.testing at cartpole-ppo.yaml's settings, two CPU
              runner actors of four envs and the learner on cuda, to
              RL_THRESHOLD within RL_MAX_ITERS iterations: env steps/s, the
              update's host ms, its device ms and the learner's idle share
              (one profiled iteration), each iteration's sampling/learning
              split; no runner process has a CUDA context or jax; (c) two
              learner actors sharing the card (GPU 0.5 each) take one
              averaged update, bitwise in sync; (d) (b)'s checkpoint restored
              into an algorithm whose learner is on the CPU;
 12. serve    GPT-2 small (bf16, weights from a seed) in two Serve replicas
              of GPU 0.5 each, continuous batching up to 8 prompts of 64-1024
              tokens, right-padded, under inference_mode: (a) 64 seeded
              prompts through the handle and the HTTP proxy, each answer (the
              last position's f32 log-probs, the greedy token) against the
              same prompt alone in f32 and in bf16 on the plain path, by
              phase 3's rule; (b) loadgen's closed loop at concurrency 16,
              then its open loop at 5x the calibrated rate with a 1 s
              deadline: rate, latency percentiles, prompt tokens/s, batch
              sizes, B1 launches per batch (12, no B2-B4), no overrun and
              no error, overload as typed sheds; (c) one batch profiled in
              a replica (device ms, host ms, idle share) beside the same
              batch bare here; (d) @serve.multiplexed with one model a
              replica, two seeds in turns: the replica's allocated memory
              within one model after each eviction, answers equal to bare
              runs;
 13. tune     a Tuner over two learning rates, each trial
              TorchTrainer(...).as_trainable() with one worker at GPU 0.5
              (both on the card at once) taking five AdamW steps of the
              GPT-2-small step at batch 4: each trial's losses against a
              bare run here, the best result the lower last loss, B2-B4
              launched in every trial's worker, each trial's times;
 14. cluster  the port as a GPU cluster, GPT-2 small at full width: (a) a
              cluster_utils Cluster whose head has no GPU and one added
              node has one: a num_gpus=1 task's forward (B1) must run on
              that node and give a bare forward's last-position log-probs
              bitwise; (b) a head started by `python -m
              ray_tpu_torch.scripts.cli start --head --num-gpus 1` with its
              dashboard and client server: `cli status` shows GPU 1, a job
              whose driver attaches with address="auto" runs (a)'s task and
              logs the same log-probs' digest, `cli list tasks` and
              util.state show the task with GPU 1.0 in its resources, the
              dashboard's JSON endpoints answer; (c) a client-mode driver
              with CUDA_VISIBLE_DEVICES="" on the head's client server runs
              a num_gpus=1 task of TUNE_STEPS AdamW steps (B2-B4): its
              losses and a gradient (a CUDA tensor in the task, a CPU
              tensor in the client) bitwise a bare run's, no CUDA state in
              the client, the proxy's round trip beside a driver's;
              (d) a workflow init -> train -> eval of num_gpus=1 steps
              whose train fails once (a marker file): run raises, resume
              finishes, bitwise an uninterrupted run, init run once, the
              checkpointed CUDA tensors CPU tensors on disk; then `cli
              stop`, and no process of the port is left;
 15. scale_out (a) the runtime's native extensions, which this process
              built from ray_tpu_torch/_native/csrc/ at its first import
              (the seconds of each build), are the ones loaded here and in
              a num_gpus=1 worker (the native wire codec, store core and
              shm segments, not the pure-Python fallbacks), and
              `python -m ray_tpu_torch._native.native_ab`'s codec and
              end-to-end legs on this host, its threshold misses printed
              as data (single runs on this shared host swing across both
              sides of them);
              (b) a ClusterLauncher on the `fake` provider, its head of no
              CPU and no GPU, one worker type `gpu` of {CPU: 2, GPU: 1}
              (0 to 1 of it): a num_gpus=1 task runs 14a's forward (B1),
              waiting on the head alone until update() launches the GPU
              node; then a job submitted through the launcher (its
              supervisor can only land on that node) runs the same forward
              there; both bitwise the bare forward (the job by its
              digest), the job's supervisor DEAD once it has ended, the
              idle node terminated and `down` leaving no process of the
              port; the time from demand to registered node, the task's,
              the job's and idle to terminated; (c) `python -m
              ray_tpu_torch._private.ray_perf --json` on the card: every
              key of the reference's main and
              the CUDA keys (NCCL at world 1, the CUDA IPC device edge)
              above 0 (the store's eviction grace at 1 s, as the spill
              bench otherwise waits out its 10 s); with loadgen's smoke
              through benchmarks/perf_gate.py against its floors, whose
              misses are printed as data;
 16. chaos    (a) `python -m ray_tpu_torch.devtools.lint`, the port's
              static gate over its tree: clean within its 120 s budget,
              each pass's seconds; (b) `python -m ray_tpu_torch.chaos
              --suite smoke --seeds 1`: every seed of every scenario
              converges with every invariant held (each seed's fault count
              and seconds), and `--check-determinism` on one scenario gives
              the digests that run used; (c) the port's Nemesis against GPU
              work: a Cluster whose head has no GPU and one added
              {GPU: 1} node, 14a's forward as num_gpus=1 tasks with 3
              retries: kill_worker while the first is inside its forward,
              the retry bitwise the bare forward; a second's answer left
              unfetched on the GPU node, kill_raylet on that node and a
              replacement {GPU: 1} node, the get rebuilt by lineage,
              bitwise; then every raylet's leases and store settled, no
              acknowledged answer lost, the replacement's GPU available
              1.0, and the seconds from each kill to its answer;
 17. head_dims the kernels at other head dims, through the port's entry
              points: (a) the JAX package's example (EXAMPLE, head dim 32,
              on the kernels at 32), its loop of 20 AdamW steps on a new
              batch each and one eval loss without gradients, in a
              one-worker GPU TorchTrainer: its losses bitwise the same
              run's bare here, every launch at 32, and one more bare step
              profiled: only *_sm90<32, ...> flash kernels and no pad or
              cut copy; (b) Phi-3-mini's widths (head dim
              96) and (c) Gemma-2B's attention and matrix widths in the JAX
              package's architecture (head dim 256, one kv head), each cut
              to WIDE_LAYERS layers at WIDE_BATCH x WIDE_SEQ: bf16 logits and
              first gradients through the kernels within phases 3 and 4's
              ratios of f32, then a warm-up and WIDE_STEPS steps (the loss
              falls), tokens/s and MFU, and two profiled steps (device ms
              by kernel family, idle share); (d) one served batch at (b)'s
              widths: device ms, B1 once a layer at head dim 96;
 18. wide     the calls the TPU kernels take past phase 17's, through the
              port's entry points: (a) the JAX package's architecture at
              head dim 512 (WIDE_512: d_model 2048, 4 heads, 1 kv head),
              WIDE_LAYERS layers at WIDE_BATCH x WIDE_SEQ, held and timed as
              17b and 17c are (B2-B4 at 512); (b) a no-grad scoring forward
              at 17b's widths of SCORE_BATCH x SCORE_SEQ tokens, 66,560
              heads in one B1 call a layer: its f32 logits held by phase
              3's ratios against the plain attention's, its host ms,
              device ms and launches; (c) the streamed forward on the
              model's paths: the architecture at head dim 1024 (WIDE_1024:
              d_model 2048, 2 heads) in a no-grad forward held by phase 3's
              ratios (B1 at 1024 once a layer), and WIDE_512 built in f32,
              its no-grad forward through the split pass and the streamed
              forward within F32_LOGITS_ATOL of the plain f32 path and its
              first step's gradients within F32_GRAD_REL (B2, B3 and B4 on
              the streamed kernels; by the profiler's names, none on the
              CUDA cores), each with host and device ms and launches;
              (d) WIDE_1024 trained at full width, held and timed as 18a
              (B2-B4 at 1024 on the streamed kernels);
then the kernels line, with each kernel's launches in phases 3, 4, 6, the
bench's transformer phase and phases 9-18 (none in 11: RLlib's modules
are MLPs; the reference and timing runs this script makes itself in 12,
13, 14, 15, 16, 17 and 18 are not counted, nor 16's killed attempt), one
entry a kernel and width launched (64; 32, 96 and 256 in phase 17, 32
with 17a's launches a step, B1's in its eval; 512 in 18a), one for B1 at 66,560 heads
(18b), the f32 route at 64: B1 (phase
3's f32 forward), B2 (9b's f32 ring hops and phase 4's f32 step), B3 and
B4 (both of those) and their split passes, 18c's: B1 at 1024, and at f32
512 B1, B2, B3, B4 and the split passes, and 18d's B2, B3 and B4 at 1024.
Any failure exits non-zero.
The last line is the ok line.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import importlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch
import torch.nn.functional as F

SEED = 0
# GPT-2 small, as the JAX package's bench configures it, at batch 8.
GPT2_SMALL = dict(vocab_size=50304, d_model=768, n_layers=12, n_heads=12,
                  max_seq_len=1024, dtype=torch.bfloat16, remat=True)
BATCH, SEQ, TRAIN_STEPS = 8, 1024, 10
# Peaks from NVIDIA's data sheets (dense bf16) and the H100's HBM3 rate.
PEAK_BF16 = 989e12
HBM_BYTES_PER_S = 3.35e12
# The least time for f32 attention: f32 products within F32_ATOL take three
# bf16 products each on the tensor cores (hi.hi + hi.lo + lo.hi of each
# operand's two bf16 parts; two miss it: tests/test_torch_f32_forward.py),
# so its useful flops run at a third of the bf16 rate, above the CUDA
# cores' 67 TFLOP/s.
PEAK_F32_SPLIT = PEAK_BF16 / 3
# The exp unit (MUFU): 16 ex2 a clock on each SM. Attention takes one exp a
# (query, key) pair in each of B1-B4 and, at D = 32, 4 D = 128 useful flops
# a pair in the forward: there the exps, not the flops, set the least time.
EXPS_PER_CLOCK_PER_SM = 16
# Kernel against its plain version, element by element. Both take the same
# inputs, do f32 arithmetic (TF32 off) and differ only in the order they sum.
#  - f32 outputs (lse, dq, dk, dv always; o from f32 inputs): within
#    F32_ATOL, as tests/test_kernels_and_tensors.py:56 holds its kernels.
#  - bf16 outputs (o from bf16 inputs, the grads `mha` casts back to bf16):
#    both sides round f32 values that agree to ~1e-6, so they end at most
#    one bf16 ulp apart, and an ulp is at most 2^-7 of the value:
#    |kernel - plain| <= BF16_RTOL * |plain| + BF16_ATOL, where BF16_ATOL
#    covers the f32 difference near 0. A limit relative to each element
#    holds the small outputs too, which an absolute one would not.
F32_ATOL = 2e-4
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-4
# Phase 3's f32 forward: GPT-2 small built in f32 through the kernels
# against the same weights through the plain attention in f32. The two
# differ only in attention, which phase 2 holds to F32_ATOL on unit-scale
# inputs per call; at this initialisation attention's inputs are smaller
# than that and the layers after it shrink an error (0.02-scale weights), so
# the logits are held to the same F32_ATOL.
F32_LOGITS_ATOL = F32_ATOL
# Logits: the kernel path and the plain path both run in bf16 and round at
# different places, and an ulp of difference spreads through 12 random-init
# layers. So each is held against the same weights run in f32 through the
# plain path, and the kernel path must be no further from that than the
# plain bf16 path is: mean abs error within 1.25x, max abs error within 2x
# (the max is a count of whole bf16 ulps at the largest logits).
LOGITS_MEAN_RATIO, LOGITS_MAX_RATIO = 1.25, 2.0
# The first step's gradients, the same way: every parameter's gradient
# through the kernels no further (relative L2) from the f32 run's than the
# plain bf16 path's is, within 1.25x. The attention projections get their
# gradients only through the backward kernels, so a wrong dq, dk or dv shows
# there as an error of order 1, against bf16's ~1e-2.
GRAD_RATIO = 1.25
# First loss, kernel path against plain path, both bf16 on the same weights
# and batch: ln(V) plus O(0.1) at random init, so this is a weak check
# beside the gradients'; the two differ by rounding only.
LOSS_BOUND = 1e-3
# Phase 4's f32 first step: GPT-2 small built in f32 through the kernels
# (B2-B4 on the tensor cores) against the plain attention in f32 on the
# same weights and batch: the loss within F32_ATOL and every parameter's
# gradient within F32_GRAD_REL, relative L2, of the plain path's. The two
# differ only in attention, held to F32_ATOL on unit-scale inputs per call;
# the bf16 kernel path sits near 1e-2 of f32, and a lost cross product in
# dq, dk or dv (a bf16-rounded operand, ~2^-9 of it) shows in wq, wk, wv.
F32_GRAD_REL = 1e-3
# Phase 6: the trainer's worker against the bare run, the same code on the
# same card in two processes, and the resumed fit against the first: every
# loss within LOSS_BOUND. The trainer checkpoints after step TRAINER_SAVE_AT,
# where every run of phases 4 and 6 splits its timed span (run_steps).
TRAINER_SAVE_AT = 5

# Phase 7: ResNet-50 as the JAX package's bench configures it (bench.py:110-125):
# the bf16-against-f32 checks at batch 32, the bench's step at batch 128.
RESNET_SIZE, RESNET_CHECK_BATCH, RESNET_BATCH = 224, 32, 128
# bf16 against f32 on the same weights and images, by relative L2 (||bf16 -
# f32|| / ||f32||). bf16 keeps 8 significant bits, and each of the 53 batch
# norms rounds its folded per-channel scale and bias to bf16 (up to 2^-9 of
# the value, the same for every position of a channel), so at
# initialisation, where train-mode logits are O(1) averages of normalised
# features, these errors add up over the layers: 53 * 2^-9 ~ 0.1. Bounds:
# - train-mode logits within 0.25; each batch norm's running statistics
#   after that forward within 5e-2 (means and variances of the batch);
# - the first gradients of every parameter within 0.15, taken in eval mode.
#   Train-mode gradients at initialisation are chaotic in f32 itself: a
#   one-ulp change of the images moves ResNet-50's by ~2% and rounding the
#   images alone to bf16 by ~95% (median relative L2 over the parameters,
#   measured on an H100 by this phase), so at depth 50 they are reported,
#   with those moves, and not bounded. In eval mode the batch norms are
#   fixed affine maps and a one-ulp change moves the gradients by ~2e-4.
# - train-mode gradients where they are less chaotic: ResNet-18, same
#   width, classes, size, batch and code, where rounding the images to bf16
#   moves f32's by ~19%. The bf16 run's median over the parameters within
#   RESNET18_GRAD_RATIO times that move (measured 2.0-2.1 times, with the
#   bf16 run 0.38-0.40 from f32); a wrong backward is of order 1 from it.
# - each of ResNet-50's batch norms alone in train mode, on the activations
#   a bf16 forward gives it: output and input, scale and bias gradients
#   within RESNET_BN_LAYER_REL of f32 (measured worst 8.2e-3, the scale
#   gradient), so the bf16 train-mode batch-norm backward that the eval-mode
#   gradients skip is held layer by layer.
# A wrong cast, layout or statistic gives errors of order 1.
RESNET_LOGITS_REL, RESNET_STATS_REL, RESNET_GRAD_REL = 0.25, 5e-2, 0.15
RESNET18_GRAD_RATIO, RESNET_BN_LAYER_REL = 3.0, 2e-2

# Phase 9: the sharded step against the bare one, a warm-up and MESH_STEPS
# steps each; its one-worker trainer MESH_TRAINER_STEPS steps; ring
# attention's kernel route in loopback on RING_SHAPE [B, T, H, D] (phase
# 4's batch, sequence and heads) in RING_SHARDS sequence shards, held by
# phase 2's limits (F32_ATOL; BF16_RTOL, BF16_ATOL with the merged hop
# outputs' magnitudes as slack: each hop's bf16 output is rounded once
# before the merge, as a bf16 dk term is before gqa_case's sum).
# The ring's ms are a mean over RING_TIME_REPS calls: it queues ~190
# launches a call causal and ~290 not, and the host blocks once ~1024 wait
# on the stream, held or not, so time_ms can hold the card for few calls.
MESH_STEPS, MESH_TRAINER_STEPS = 5, 3
RING_SHAPE, RING_SHARDS, RING_TIME_REPS = (8, 1024, 12, 64), 4, 2
# Phase 10: collective groups and the compiled graph's device edge, in GPU
# actors of the runtime. 10a holds every op of the NCCL group at world 1 to
# the store backend's answer on the same 16 MiB input, bitwise (a world of
# one reduces nothing, so both return the input; the store carries bf16 as
# float32); its rates are of COLL_RATE_REPS allreduces of that input. 10b
# holds ring and Ulysses attention on the group at RING_SHAPE by phase 2's
# limits (one hop at world 1: no merge, no slack). 10c's edge moves
# DAG_EDGE_ELEMS bf16 (16 MiB) per execute; its rates are of DAG_RATE_REPS
# executes.
COLL_BYTES, COLL_RATE_REPS = 16 << 20, {"nccl": 50, "store": 5}
DAG_EDGE_ELEMS, DAG_SEEDS, DAG_RATE_REPS = 8 << 20, (1, 2, 3), 20
NCCL_GROUP, STORE_GROUP, DAG_GROUP = "smoke_nccl", "smoke_store", "smoke_dag"
# Phase 11: RLlib. PPO on CartPole at tests/test_rllib.py's settings
# (rllib/tuned_examples/ppo/cartpole-ppo.yaml): the (64, 64) separate
# policy and value nets, two CPU runner actors of four envs each, the
# learner on cuda; RL_THRESHOLD within RL_MAX_ITERS iterations. 11a holds
# every learner (SAC at its default (256, 256)) on cuda, TF32 off, against
# the same learner on the CPU on one batch of RL_CHECK_ROWS rows (IMPALA and
# APPO: [RL_FRAGMENT, RL_ENVS] fragments), lr RL_CHECK_LR. The CPU learner
# runs in f64 from the same f32 weights and batch: an f32 CPU learner's
# rounding depends on the host's CPU kernels, and where a gradient leaf is a
# sum that cancels (PPO's value bias) that alone came to 3.5e-5 relative L2
# against the card on one host and 6e-7 on another. So the card's f32
# arithmetic is held to one reference on every host, ~1e-7 relative per
# product:
#  - loss and every metric: |cuda - cpu| <= RL_METRIC_TOL * max(1, |cpu|);
#  - each gradient leaf: relative L2 within RL_GRAD_REL;
#  - every parameter after each of RL_UPDATES updates: within
#    RL_UPDATE_ATOL, 1% of an Adam step at lr 1e-3 (a gradient component
#    near 0 lets rounding move m / sqrt(v); the CPU tests measured 1.6e-6
#    against the JAX package); 11c and 11d's updates too.
# 11d's restored state is the saved numpy: weights bitwise, Adam's moments
# within RL_STATE_ATOL (0: bitwise too).
RL_HIDDEN, RL_SAC_HIDDEN = (64, 64), (256, 256)
RL_PPO = dict(train_batch_size=2048, minibatch_size=256, num_epochs=10, lr=3e-4,
              entropy_coeff=0.01)
RL_RUNNERS, RL_ENVS, RL_FRAGMENT = 2, 8, 50
RL_THRESHOLD, RL_MAX_ITERS = 150, 40
RL_CHECK_ROWS, RL_CHECK_LR, RL_UPDATES = 256, 1e-3, 3
RL_METRIC_TOL, RL_GRAD_REL, RL_UPDATE_ATOL, RL_STATE_ATOL = 1e-5, 1e-5, 1e-5, 0.0
# Phase 12: Serve. GPT-2 small (GPT2_SMALL's widths, bf16, no remat)
# served by SERVE_REPLICAS replicas at GPU SERVE_GPU each, sharing the card,
# with continuous batching (up to SERVE_MAX_BATCH requests a call, formed
# within SERVE_BATCH_WAIT_S); SERVE_PROMPTS prompts of int32 tokens, their
# lengths drawn from a seed in SERVE_PROMPT_LENS. 12a holds the served
# log-probs by phase 3's rule (LOGITS_MEAN_RATIO, LOGITS_MAX_RATIO: no
# further from f32 than the plain bf16 path on each prompt alone), and the
# greedy token to f32's wherever f32's top-2 margin is above
# GREEDY_MARGIN_RATIO times the plain bf16 path's max abs error on that
# prompt: each of the two tokens may move by the served path's error, at
# most LOGITS_MAX_RATIO times bf16's. SERVE_HTTP: the card's machine has
# aiohttp, so 12a sends every prompt through the HTTP proxy too. 12b runs
# loadgen at SERVE_CONCURRENCY for SERVE_CLOSED_S, then the open loop at
# SERVE_OVERLOAD times the calibrated rate for SERVE_OPEN_S, deadline
# SERVE_TIMEOUT_S (loadgen.run_smoke's settings). 12d's multiplexed replica
# keeps one model: after each eviction its allocated memory is within one
# model's bytes plus SERVE_MUX_SLACK (what a request leaves allocated).
SERVE_REPLICAS, SERVE_GPU, SERVE_MAX_BATCH, SERVE_BATCH_WAIT_S = 2, 0.5, 8, 0.01
SERVE_PROMPTS, SERVE_PROMPT_LENS, SERVE_CONCURRENCY = 64, (64, 1024), 16
SERVE_CLOSED_S, SERVE_OPEN_S, SERVE_OVERLOAD, SERVE_TIMEOUT_S = 5.0, 5.0, 5.0, 1.0
GREEDY_MARGIN_RATIO = 2 * LOGITS_MAX_RATIO
SERVE_HTTP = True
SERVE_MUX_SEEDS, SERVE_MUX_SLACK = (SEED + 20, SEED + 21), 64 << 20
# Phase 13: Tune. A grid over TUNE_LRS, each trial a TorchTrainer with one
# worker at GPU TUNE_GPU (both trials on the card at once) taking
# TUNE_STEPS AdamW steps of the GPT-2-small step at TUNE_BATCH x SEQ; each
# trial's losses within LOSS_BOUND of a bare run in this process.
TUNE_LRS, TUNE_GPU, TUNE_BATCH, TUNE_STEPS = (3e-4, 1e-3), 0.5, 4, 5
# Phase 14: the port as a GPU cluster. 14a's forward (and 14d's eval) run
# GPT2_SMALL on CLUSTER_BATCH x SEQ tokens; 14b's head, started by the CLI,
# has CLUSTER_HEAD_CPUS CPUs and one GPU; 14c times the client's proxy by
# CLIENT_PINGS round trips of a task that does nothing; 14c's task and 14d's
# train step take TUNE_STEPS and WORKFLOW_STEPS AdamW steps at TUNE_BATCH x
# SEQ. Every answer that crosses the cluster is held bitwise to a bare run
# in this process (14c's losses within LOSS_BOUND, which bitwise meets).
CLUSTER_BATCH, CLUSTER_HEAD_CPUS, CLIENT_PINGS, WORKFLOW_STEPS = 8, 4, 20, 3
# Phase 15: scale-out. 15b's autoscaler waits AUTOSCALE_UPSCALE_S of unmet
# demand before it launches, and terminates a node idle AUTOSCALE_IDLE_S.
# 15c runs ray_perf with the object store's eviction grace at
# PERF_EVICTION_GRACE_S (the runtime's default 10 s): its spill bench's
# oversubscribed pass otherwise waits out the grace, ~230 s of the smoke's
# time limit; its rates are data, not gated.
AUTOSCALE_UPSCALE_S, AUTOSCALE_IDLE_S, PERF_EVICTION_GRACE_S = 0.5, 5.0, 1.0
# Phase 16: chaos. 16b runs the chaos CLI's smoke suite over CHAOS_SEEDS
# seeds and its determinism check on CHAOS_DETERMINISM_SCENARIO (one seed,
# every scenario: two took ~44 s of the smoke's 1200 s on a slow host).
# 16c's tasks
# run 14a's forward on NEMESIS_SEEDS with max_retries NEMESIS_RETRIES; the
# first's first attempt forwards in a loop once it is inside its forward, for
# at most NEMESIS_HOLD_S, and is killed NEMESIS_IN_FORWARD_S after it says so.
CHAOS_SEEDS, CHAOS_DETERMINISM_SCENARIO = 1, "chunk_loss"
NEMESIS_SEEDS, NEMESIS_RETRIES = (SEED + 16, SEED + 17), 3
NEMESIS_HOLD_S, NEMESIS_IN_FORWARD_S = 120.0, 1.0

# Phase 2's cases at the head dims beside GPT-2 small's 64 and 128: on the
# kernels' widths (32, 96, 256) and off them (80, 192: padded to 96, 256);
# and, from a generator of their own after every other case, below the
# narrowest width (16, padded to 32: the flagship configuration's head dim
# in __graft_entry__.py).
WIDE_HEAD_DIMS = (32, 80, 96, 192, 256)
NARROW_HEAD_DIMS = (16,)
# Phase 17: the head dims the JAX package's architecture takes past GPT-2
# small's. 17a: the JAX package's own example (examples/train_transformer.py:
# 22-25, head dim 32), its loop of EXAMPLE_STEPS AdamW(3e-4) steps on a new
# batch each, in a one-worker GPU TorchTrainer and bare here, bitwise.
# 17b: Phi-3-mini's widths (its config.json: hidden 3072, 32 heads and kv
# heads, intermediate 8192, vocab 32064, untied, rope_theta 10000; head dim
# 96); 17c: Gemma-2B's attention and matrix widths (hidden 2048, 8 heads, 1
# kv head, intermediate 16384, vocab 256000, tied; head dim 256) in the JAX
# package's architecture, which has SwiGLU where Gemma has GeGLU and no
# embedding scale: that configuration of this model, not Gemma. Both cut to
# WIDE_LAYERS layers (from 32 and 18), at WIDE_BATCH x WIDE_SEQ, held as
# phases 3 and 4 hold GPT-2 small, then a warm-up and WIDE_STEPS steps on
# one batch. 17d: one served batch of SERVE_MAX_BATCH prompts at 17b's
# widths (no remat) under inference_mode.
EXAMPLE = dict(vocab_size=1024, d_model=256, n_layers=4, n_heads=8, max_seq_len=256,
               dtype=torch.bfloat16, remat=True)
EXAMPLE_BATCH, EXAMPLE_STEPS = 8, 20
PHI3_MINI = dict(vocab_size=32064, d_model=3072, n_heads=32, n_kv_heads=32, d_ff=8192,
                 tied_embeddings=False, rope_theta=10_000.0)
GEMMA_2B = dict(vocab_size=256000, d_model=2048, n_heads=8, n_kv_heads=1, d_ff=16384,
                tied_embeddings=True)
WIDE_LAYERS, WIDE_BATCH, WIDE_SEQ, WIDE_STEPS = 2, 2, 2048, 5
# Phase 2's cases past 256 (320 and 384 padded to 512) and its calls of
# more than 65535 heads: BH_CASES [BH, T, D] held whole against the plain
# versions, and HUGE_CASE, whose BH * T * D passes 2^31 elements (~4.3 GB
# an operand), held on HUGE_HEADS (the last among them), each against the
# plain versions run on that head alone (heads are independent: exact).
WIDER_HEAD_DIMS = (320, 384, 512)
BH_CASES = ((65536, 64, 64, True), (66560, 64, 96, False))
HUGE_CASE, HUGE_HEADS = (65600, 256, 128), (0, 1, 32799, 65598, 65599)
# Phase 18: the calls past phase 17's. 18a: the JAX package's architecture
# (ray_tpu/models/transformer.py:38-68) at head dim 512: d_model 2048, 4
# heads on 1 kv head, d_ff 5504, vocab 32000, tied (no published model has
# this head dim; it is the one the TPU kernels take and the port took
# last), WIDE_LAYERS layers at WIDE_BATCH x WIDE_SEQ, as 17c. 18b: a
# scoring batch at 17b's widths (Phi-3-mini's, 32 heads), SCORE_BATCH x
# SCORE_SEQ tokens: 66,560 heads in one call; its references run in
# SCORE_CHUNKS chunks of the batch (attention is per sequence), so three
# [2080, 64, 32064] f32 logits are never held at once.
WIDE_512 = dict(vocab_size=32000, d_model=2048, n_heads=4, n_kv_heads=1, d_ff=5504,
                tied_embeddings=True)
SCORE_BATCH, SCORE_SEQ, SCORE_CHUNKS = 2080, 64, 8
# Phase 2's cases past 512, B1-B4 on the streamed kernels: off their slices
# of 512 (576, 768: padded to 1024) and on them (1024, 2048), from a
# generator of their own. 18c: (a) the JAX package's architecture at head
# dim 1024 (WIDE_1024: WIDE_512 with 2 heads on 2 kv heads; no published
# model has this head dim: a width the TPU kernels take), WIDE_LAYERS layers
# at WIDE_BATCH x WIDE_SEQ, a no-grad forward (B1 on the streamed forward,
# bf16); (b) WIDE_512 built in f32: a no-grad forward through the split
# pass and the streamed forward at P = 2, and the first step's gradients
# (B2-B4 on the streamed kernels), against the plain f32 path. 18d:
# WIDE_1024 trained as 18a trains WIDE_512 (B2-B4 at 1024).
STREAM_HEAD_DIMS = (576, 768, 1024, 2048)
WIDE_1024 = dict(WIDE_512, n_heads=2, n_kv_heads=2)

# Phase 2's cases at a scale of -1/sqrt(D) and 0, which the TPU kernels
# take and the wrappers route before a launch (the kernels take the row max
# of the raw scores, so they launch at a scale > 0): (dtype, D, T, S,
# causal) at head dim 64, at 80 (padded to 96) and at 1024 (streamed).
SCALE_CASES = ([(dtype, 64, 1000, 1000, causal) for dtype in (torch.bfloat16, torch.float32)
                for causal in (True, False)]
               + [(dtype, 80, 1000, 1000, True) for dtype in (torch.bfloat16, torch.float32)]
               + [(dtype, 1024, 300, 300, True) for dtype in (torch.bfloat16, torch.float32)])
SCALE_KINDS = ("-1/sqrt(D)", "0")

KERNELS = [  # name, launch-count key, TPU kernel it replaces
    ("flash_fwd", "fwd", "ray_tpu/ops/flash_attention.py:35"),
    ("flash_fwd_lse", "fwd_lse", "ray_tpu/ops/flash_attention.py:109"),
    ("flash_bwd_dq", "bwd_dq", "ray_tpu/ops/flash_attention.py:289"),
    ("flash_bwd_dkv", "bwd_dkv", "ray_tpu/ops/flash_attention.py:328"),
]
SOURCE = "ray_tpu_torch/ops/csrc/flash_attention.cu"


class SmokeFailure(Exception):
    pass


_T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also says when it was written
    (t_s, seconds since this script started)."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - _T0}
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def forbidden_modules() -> list:
    """The modules of this process the port must never load."""
    return sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "optax", "ray_tpu"))


def max_err(a, b) -> float:
    return float((a.detach().float() - b.detach().float()).abs().max())


def err_ratio(x, ref, slack=None) -> float:
    """Worst element of |x - ref| over its limit; the check passes at <= 1.
    The limit is F32_ATOL for f32 outputs and BF16_RTOL * (|ref| + slack) +
    BF16_ATOL for bf16 ones, where `slack` is the magnitude of bf16 terms
    that were each rounded before they were summed into ref."""
    err = (x.detach().float() - ref.detach().float()).abs()
    if x.dtype != torch.bfloat16:
        return float(err.max()) / F32_ATOL
    mag = ref.detach().float().abs()
    if slack is not None:
        mag = mag + slack
    return float((err / (BF16_RTOL * mag + BF16_ATOL)).max())


def compare(pairs: dict) -> tuple:
    """{kernel: [(out, plain out[, slack]), ...]} -> ({kernel: max abs
    error}, {kernel: worst error-to-limit ratio})."""
    errs = {key: max(max_err(p[0], p[1]) for p in ps) for key, ps in pairs.items()}
    ratios = {key: max(err_ratio(*p) for p in ps) for key, ps in pairs.items()}
    return errs, ratios


def check_ratios(ratios: dict, where) -> None:
    for key, r in ratios.items():
        check(math.isfinite(r) and r <= 1.0, f"{key} off its plain version in {where}: {ratios}")


def time_ms(fn, reps: int = 20) -> float:
    """Mean device time of fn over reps calls run back to back, after one
    warm-up. The stream is held busy (torch.cuda._sleep) until every call is
    queued, so the card never waits on the host between calls: a host slower
    than the card, as for an autograd backward of many small launches, would
    otherwise set the figure. The hold grows until the start event is still
    pending once the last call is queued."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for hold in (10_000_000 * 4 ** i for i in range(6)):  # GPU cycles, ~5 ms up
        torch.cuda._sleep(hold)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        queued_in_time = not start.query()
        torch.cuda.synchronize()
        if queued_in_time:
            return start.elapsed_time(end) / reps
    raise SmokeFailure("the host could not queue the timed calls ahead of the card")


@functools.lru_cache(maxsize=None)
def exps_per_s() -> float:
    """The card's exp rate: EXPS_PER_CLOCK_PER_SM on each of its SMs at its
    highest SM clock (nvidia-smi's clocks.max.sm)."""
    mhz = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits", "-i", "0"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.split()[0]
    return EXPS_PER_CLOCK_PER_SM * torch.cuda.get_device_properties(0).multi_processor_count * float(mhz) * 1e6


def bound(flops: float, nbytes: float, exps: float, peak: float = PEAK_BF16) -> dict:
    """The least time a kernel could take for this work: the largest of its
    bytes at HBM_BYTES_PER_S, its flops at `peak` and its exps at
    exps_per_s(); "bound_by" is "bytes" or "operations" (flops or exps:
    "bound_of" says which), "bound_parts_ms" each of the three."""
    parts = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3, "flops": flops / peak * 1e3,
             "exps": exps / exps_per_s() * 1e3}
    of = max(parts, key=parts.get)
    return {"bound_ms": parts[of], "bound_by": "bytes" if of == "bytes" else "operations", "bound_of": of,
            "bound_parts_ms": parts}


def timed(fn) -> float:
    """Seconds that fn() takes."""
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def card() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    return {"nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


# ------------------------------------------------------------ build report

_KERNEL_NAME = re.compile(r"((?:fwd|bwd_dq|bwd_dkv)_kernel(?:_tc|_sm90(?:_f32|_stream)?)?)"
                          r"I((?:Li\d+E|Lb[01]E|f|13__nv_bfloat16)+)E")
# The Hopper kernels in the build (wgmma: HGMMA in the SASS): the bf16
# forward fwd_kernel_sm90 over D x CAUSAL x WRITE_LSE and the bf16 backward
# bwd_dq_kernel_sm90 and bwd_dkv_kernel_sm90, each over D x CAUSAL, D in
# the kernels' six widths (32, 64, 96, 128, 256, 512); and the f32 forward
# fwd_kernel_sm90_f32 over D x CAUSAL x WRITE_LSE and the f32 backward
# bwd_dq_kernel_sm90_f32 and bwd_dkv_kernel_sm90_f32 over D x CAUSAL, D in
# 32, 64, 96, 128, 256; and the streamed forward fwd_kernel_sm90_stream over
# P (1: bf16, 2: f32 as parts) x CAUSAL x WRITE_LSE and the streamed
# backward bwd_dq_kernel_sm90_stream and bwd_dkv_kernel_sm90_stream over P x
# CAUSAL, D a runtime value.
N_SM90_KERNELS = 6 * (4 + 2 + 2) + 5 * (4 + 2 + 2) + 2 * 4 + 2 * (2 + 2)
_SM90 = re.compile(r"_sm90(?:_f32|_stream)?<")
_TEMPLATE_ARG = re.compile(r"Li(\d+)E|Lb([01])E|(13__nv_bfloat16|f)")
_SERIALIZED = re.compile(r"wgmma\.mma_async instructions are serialized due to (.*) "
                         r"(?:in|for) the function '([^']+)'")


def kernel_label(mangled: str) -> str:
    """A kernel's mangled name as 'fwd_kernel_sm90<64,true,false>'; other
    names unchanged."""
    m = _KERNEL_NAME.search(mangled)
    if not m:
        return mangled
    args = [n or {"1": "true", "0": "false"}.get(b) or {"f": "f32"}.get(t, "bf16")
            for n, b, t in _TEMPLATE_ARG.findall(m.group(2))]
    return f"{m.group(1)}<{','.join(args)}>"


def ptxas_report(log: str) -> dict:
    """{kernel: {"registers", "spill_stores", "spill_loads"[, "wgmma_serialized"]}}
    from ptxas -v; the last is ptxas's reason where it serialized a kernel's
    wgmma (it runs right, and slow)."""
    out, cur = {}, None
    for line in log.splitlines():
        m = _SERIALIZED.search(line)
        if m:
            out.setdefault(kernel_label(m.group(2)), {})["wgmma_serialized"] = m.group(1)
            continue
        m = re.search(r"(?:Compiling entry function '|Function properties for )([^'\s]+)", line)
        if m:
            cur = out.setdefault(kernel_label(m.group(1)), {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur is not None:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    return out


def sass_mma(sass: str) -> dict:
    """{kernel: {"hmma": n, "hgmma": n}} from cuobjdump -sass: its counts of
    mma.sync (HMMA) and wgmma (HGMMA) tensor-core instructions."""
    out, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = out[kernel_label(m.group(1))] = {"hmma": 0, "hgmma": 0}
        elif cur is not None:
            cur["hmma"] += "HMMA" in line
            cur["hgmma"] += "HGMMA" in line
    return out


def build_report(build) -> dict:
    """Registers, spills and tensor-core instruction counts of each kernel of
    the flash library; fails unless all N_SM90_KERNELS Hopper kernels are
    there, each with HGMMA, no spill and no serialized wgmma."""
    lib = build.library_path("flash_attention")
    regs = ptxas_report(lib.with_suffix(".log").read_text())
    sass = subprocess.run([build.tool("cuobjdump"), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    report = {name: {**regs.get(name, {}), **n} for name, n in sorted(sass_mma(sass).items())}

    check_sm90(report)
    return report


def check_sm90(report: dict) -> None:
    """Fails unless the report holds N_SM90_KERNELS Hopper kernels, each
    with HGMMA, no spill and no wgmma that ptxas serialized."""
    def ok(r):
        return (r.get("hgmma", 0) > 0 and r.get("spill_stores") == 0 and r.get("spill_loads") == 0
                and "wgmma_serialized" not in r)

    sm90 = {name: r for name, r in report.items() if _SM90.search(name)}
    check(len(sm90) == N_SM90_KERNELS and all(ok(r) for r in sm90.values()),
          f"want {N_SM90_KERNELS} Hopper kernels, each with HGMMA, no spill and no "
          f"serialized wgmma: {sm90}")


# ----------------------------------------------------------------- phase 2

def stream_cases(fa, dev, gen) -> int:
    """B1-B4 on the streamed kernels (STREAM_HEAD_DIMS in bf16 and f32, and
    f32 at 512) against their plain versions at T in 1, 100 and 1000,
    causal or not, and T = 1000 on S = 300 with the mask, by phase 2's
    limits. Then their column slices at 1024: with q's, k's, v's and do's
    second 512 columns a copy of their first, the halves of o, dq, dk and
    dv are bitwise equal (every slice makes the same S, P and dS), and a
    second call repeats o, lse, dq, dk and dv bitwise. Prints one line a
    case; returns the number of cases."""
    cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        dims = STREAM_HEAD_DIMS + ((512,) if dtype == torch.float32 else ())
        shapes = [(D, T, T, causal) for D in dims for T in (1, 100, 1000) for causal in (True, False)]
        shapes += [(D, 1000, 300, True) for D in dims]
        for D, T, S, causal in shapes:
            q, k, v, do = (torch.randn(4, n, D, device=dev, generator=gen).to(dtype) for n in (T, S, S, T))
            scale = D ** -0.5
            ref_o, ref_lse = fa._flash_fwd_ref(q, k, v, causal, scale, True)
            o, lse = fa.flash_fwd(q, k, v, causal=causal, scale=scale, with_lse=True)
            delta = (do.float() * ref_o.float()).sum(-1)
            args = (q, k, v, do, ref_lse, delta)
            errs, ratios = compare({
                "fwd": [(fa.flash_fwd(q, k, v, causal=causal, scale=scale), ref_o)],
                "fwd_lse": [(o, ref_o), (lse, ref_lse)],
                "bwd_dq": [(fa.flash_bwd_dq(*args, causal=causal, scale=scale),
                            fa._flash_bwd_dq_ref(*args, causal, scale))],
                "bwd_dkv": list(zip(fa.flash_bwd_dkv(*args, causal=causal, scale=scale),
                                    fa._flash_bwd_dkv_ref(*args, causal, scale))),
            })
            case = dict(dtype=str(dtype).split(".")[-1], D=D, width=fa.kernel_width(D), T=T, S=S, causal=causal,
                        max_abs_err=errs, err_to_limit=ratios)
            emit({"phase": "kernels", "stream_case": case})
            check_ratios(ratios, case)
            cases += 1
        q, k, v, do = (torch.randn(4, 1000, 1024, device=dev, generator=gen).to(dtype) for _ in range(4))
        for x in (q, k, v, do):
            x[..., 512:] = x[..., :512]
        runs = []
        for _ in range(2):
            o, lse = fa.flash_fwd(q, k, v, causal=True, scale=1024 ** -0.5, with_lse=True)
            delta = (do.float() * o.float()).sum(-1)
            args = (q, k, v, do, lse, delta)
            runs.append((o, lse, fa.flash_bwd_dq(*args, causal=True, scale=1024 ** -0.5),
                         *fa.flash_bwd_dkv(*args, causal=True, scale=1024 ** -0.5)))
        names = ("o", "lse", "dq", "dk", "dv")
        slices = {"dtype": str(dtype).split(".")[-1],
                  "halves_equal": {n: bool(torch.equal(x[..., 512:], x[..., :512]))
                                   for n, x in zip(names, runs[0]) if n != "lse"},
                  "repeats": {n: bool(torch.equal(a, b)) for n, a, b in zip(names, *runs)}}
        emit({"phase": "kernels", "stream_slices": slices})
        check(all(slices["halves_equal"].values()) and all(slices["repeats"].values()),
              f"the streamed kernels' slices disagree or a call does not repeat: {slices}")
        cases += 1
    return cases


def scale_case(fa, dev, gen, dtype, D: int, T: int, S: int, causal: bool, kind: str) -> dict:
    """B1-B4 through their wrappers at scale -1/sqrt(D) or 0 (SCALE_KINDS)
    against their plain versions at that scale. Returns the case: each
    kernel's max abs error and error-to-limit ratio by phase 2's limits, the
    launches of each kernel (dq at 0 launches none), and at 0 whether dq
    and dk came out exactly zero."""
    scale = -(D ** -0.5) if kind == "-1/sqrt(D)" else 0.0
    q, k, v, do = (torch.randn(4, n, D, device=dev, generator=gen).to(dtype) for n in (T, S, S, T))
    ref_o, ref_lse = fa._flash_fwd_ref(q, k, v, causal, scale, True)
    delta = (do.float() * ref_o.float()).sum(-1)
    args = (q, k, v, do, ref_lse, delta)
    before = dict(fa.launches)
    o, lse = fa.flash_fwd(q, k, v, causal=causal, scale=scale, with_lse=True)
    o1 = fa.flash_fwd(q, k, v, causal=causal, scale=scale)
    dq = fa.flash_bwd_dq(*args, causal=causal, scale=scale)
    dk, dv = fa.flash_bwd_dkv(*args, causal=causal, scale=scale)
    launched = {key: fa.launches[key] - before[key] for key in before}
    errs, ratios = compare({
        "fwd": [(o1, ref_o)],
        "fwd_lse": [(o, ref_o), (lse, ref_lse)],
        "bwd_dq": [(dq, fa._flash_bwd_dq_ref(*args, causal, scale))],
        "bwd_dkv": list(zip((dk, dv), fa._flash_bwd_dkv_ref(*args, causal, scale))),
    })
    case = dict(dtype=str(dtype).split(".")[-1], D=D, width=fa.kernel_width(D), T=T, S=S, causal=causal,
                scale=scale, max_abs_err=errs, err_to_limit=ratios, launches=launched)
    if scale == 0:
        case["dq_dk_zero"] = not dq.any() and not dk.any()
    return case


def scale_ok(case: dict) -> bool:
    """A scale case passes: every ratio within its limit, each kernel
    launched once (dq none at 0), dq and dk exactly zero at 0."""
    want = {"fwd": 1, "fwd_lse": 1, "bwd_dq": 0 if case["scale"] == 0 else 1, "bwd_dkv": 1}
    return (all(math.isfinite(r) and r <= 1.0 for r in case["err_to_limit"].values())
            and case["launches"] == want and case.get("dq_dk_zero", True))


def scale_cases(fa, dev, gen) -> int:
    """Every SCALE_CASES shape at each SCALE_KINDS scale (scale_case), one
    "scale_case" line each, then their worst error-to-limit ratio; returns
    the number of cases."""
    worst = 0.0
    for dtype, D, T, S, causal in SCALE_CASES:
        for kind in SCALE_KINDS:
            case = scale_case(fa, dev, gen, dtype, D, T, S, causal, kind)
            emit({"phase": "kernels", "scale_case": case})
            check(scale_ok(case), f"a kernel at scale {kind} is off its plain version, launched "
                                  f"otherwise than once, or left dq or dk nonzero at 0: {case}")
            worst = max(worst, *case["err_to_limit"].values())
    emit({"phase": "kernels", "scale_cases": len(SCALE_CASES) * len(SCALE_KINDS),
          "worst_err_to_limit": worst})
    return len(SCALE_CASES) * len(SCALE_KINDS)


def kernel_cases(fa, dev, gen, gen_more, gen_widths, gen_wider, gen_stream, gen_scale, gen_narrow) -> None:
    """Every kernel against its plain version on the listed cases. Prints
    each case's max abs error and worst error-to-limit ratio (F32_ATOL,
    BF16_RTOL, BF16_ATOL) per kernel. The cases T in 1, 100 and S != T
    draw from gen_more, those at WIDE_HEAD_DIMS from gen_widths, those at
    WIDER_HEAD_DIMS from gen_wider, the others from gen in the order they
    always have, so the later phases' inputs do not move when a case is
    added; the streamed kernels' cases (stream_cases) from gen_stream,
    after all of those; the cases at a scale <= 0 (scale_cases) from
    gen_scale; those at NARROW_HEAD_DIMS from gen_narrow, last."""
    worst = {key: {"max_abs_err": 0.0, "err_to_limit": 0.0} for _, key, _ in KERNELS}
    cases = 0

    def run(dtype, D, T, S, causal, g):
        q, k, v, do = (torch.randn(4, n, D, device=dev, generator=g).to(dtype) for n in (T, S, S, T))
        scale = D ** -0.5
        ref_o, ref_lse = fa._flash_fwd_ref(q, k, v, causal, scale, True)
        o, lse = fa.flash_fwd(q, k, v, causal=causal, scale=scale, with_lse=True)
        o1 = fa.flash_fwd(q, k, v, causal=causal, scale=scale)
        delta = (do.float() * ref_o.float()).sum(-1)
        dq = fa.flash_bwd_dq(q, k, v, do, ref_lse, delta, causal=causal, scale=scale)
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, ref_lse, delta, causal=causal, scale=scale)
        ref_dq = fa._flash_bwd_dq_ref(q, k, v, do, ref_lse, delta, causal, scale)
        ref_dk, ref_dv = fa._flash_bwd_dkv_ref(q, k, v, do, ref_lse, delta, causal, scale)
        errs, ratios = compare({
            "fwd": [(o1, ref_o)],
            "fwd_lse": [(o, ref_o), (lse, ref_lse)],
            "bwd_dq": [(dq, ref_dq)],
            "bwd_dkv": [(dk, ref_dk), (dv, ref_dv)],
        })
        case = dict(dtype=str(dtype).split(".")[-1], D=D, width=fa.kernel_width(D), T=T, S=S,
                    causal=causal, max_abs_err=errs, err_to_limit=ratios)
        emit({"phase": "kernels", "case": case})
        check_ratios(ratios, case)
        for key in errs:
            w = worst[key]
            w["max_abs_err"] = max(w["max_abs_err"], errs[key])
            w["err_to_limit"] = max(w["err_to_limit"], ratios[key])

    for dtype in (torch.float32, torch.bfloat16):
        shapes = [(D, T, T, causal, gen) for D in (64, 128) for T in (192, 1000, 1024)
                  for causal in (True, False)]
        shapes += [(D, T, T, causal, gen_more) for D in (64, 128) for T in (1, 100)
                   for causal in (True, False)]
        shapes += [(64, 300, 1000, False, gen_more), (128, 300, 1000, False, gen_more),
                   (128, 1000, 300, True, gen_more)]
        shapes += [(D, T, T, causal, gen_widths) for D in WIDE_HEAD_DIMS for T in (1, 100, 1000)
                   for causal in (True, False)]
        shapes += [(D, 1000, 300, True, gen_widths) for D in WIDE_HEAD_DIMS]
        shapes += [(D, T, T, causal, gen_wider) for D in WIDER_HEAD_DIMS for T in (1, 100, 1000)
                   for causal in (True, False)]
        shapes += [(D, 1000, 300, True, gen_wider) for D in WIDER_HEAD_DIMS]
        for D, T, S, causal, g in shapes:
            run(dtype, D, T, S, causal, g)
            cases += 1
    for dtype in (torch.float32, torch.bfloat16):
        gqa_case(fa, dev, gen, dtype)
        cases += 1
    cases += stream_cases(fa, dev, gen_stream)
    cases += scale_cases(fa, dev, gen_scale)
    for dtype in (torch.float32, torch.bfloat16):
        shapes = [(D, T, T, causal) for D in NARROW_HEAD_DIMS for T in (1, 100, 1000) for causal in (True, False)]
        shapes += [(D, 1000, 300, True) for D in NARROW_HEAD_DIMS]
        for D, T, S, causal in shapes:
            run(dtype, D, T, S, causal, gen_narrow)
            cases += 1
    emit({"phase": "kernels", "cases": cases, "worst": worst,
          "limits": {"f32_atol": F32_ATOL, "bf16_rtol": BF16_RTOL, "bf16_atol": BF16_ATOL}})


def heads_cases(fa, dev, gen) -> None:
    """Calls of more than 65535 heads, which the TPU kernels' grid takes:
    each BH_CASES shape at both dtypes, every kernel against its plain
    version on the whole call; then HUGE_CASE in bf16, causal, whose
    operands pass 2^31 elements, every kernel on the whole call and held on
    the HUGE_HEADS heads against its plain version on each head alone (lse
    and delta from the kernel's own forward, as the autograd function forms
    them). Prints one line a case with its errors, by phase 2's limits."""
    for BH, T, D, causal in BH_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = (torch.randn(BH, T, D, device=dev, generator=gen).to(dtype) for _ in range(4))
            scale = D ** -0.5
            ref_o, ref_lse = fa._flash_fwd_ref(q, k, v, causal, scale, True)
            delta = (do.float() * ref_o.float()).sum(-1)
            args = (q, k, v, do, ref_lse, delta)
            o, lse = fa.flash_fwd(q, k, v, causal=causal, scale=scale, with_lse=True)
            pairs = {"fwd": [(fa.flash_fwd(q, k, v, causal=causal, scale=scale), ref_o)],
                     "fwd_lse": [(o, ref_o), (lse, ref_lse)]}
            del o, lse, ref_o
            pairs["bwd_dq"] = [(fa.flash_bwd_dq(*args, causal=causal, scale=scale),
                                fa._flash_bwd_dq_ref(*args, causal, scale))]
            errs, ratios = compare(pairs)
            dkv_errs, dkv_ratios = compare({"bwd_dkv": list(zip(
                fa.flash_bwd_dkv(*args, causal=causal, scale=scale),
                fa._flash_bwd_dkv_ref(*args, causal, scale)))})
            errs.update(dkv_errs)
            ratios.update(dkv_ratios)
            case = {"dtype": str(dtype).split(".")[-1], "BH": BH, "T": T, "D": D, "causal": causal,
                    "max_abs_err": errs, "err_to_limit": ratios}
            emit({"phase": "kernels", "heads": case})
            check_ratios(ratios, {"heads": case})
            del q, k, v, do, args, pairs
            torch.cuda.empty_cache()
    BH, T, D = HUGE_CASE
    q, k, v, do = (torch.randn(BH, T, D, device=dev, generator=gen, dtype=torch.bfloat16) for _ in range(4))
    scale = D ** -0.5
    t0 = time.perf_counter()
    o, lse = fa.flash_fwd(q, k, v, causal=True, scale=scale, with_lse=True)
    o1 = fa.flash_fwd(q, k, v, causal=True, scale=scale)
    delta = (do.float() * o.float()).sum(-1)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, causal=True, scale=scale)
    torch.cuda.synchronize()
    pairs = {key: [] for _, key, _ in KERNELS}
    for h in HUGE_HEADS:
        hq, hk, hv, hdo = (x[h:h + 1] for x in (q, k, v, do))
        ref_o, ref_lse = fa._flash_fwd_ref(hq, hk, hv, True, scale, True)
        pairs["fwd"].append((o1[h:h + 1], ref_o))
        pairs["fwd_lse"] += [(o[h:h + 1], ref_o), (lse[h:h + 1], ref_lse)]
        pairs["bwd_dq"].append((dq[h:h + 1], fa._flash_bwd_dq_ref(
            hq, hk, hv, hdo, lse[h:h + 1], delta[h:h + 1], True, scale)))
    del o1, dq
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal=True, scale=scale)
    torch.cuda.synchronize()
    for h in HUGE_HEADS:
        ref_dk, ref_dv = fa._flash_bwd_dkv_ref(*(x[h:h + 1] for x in (q, k, v, do, lse, delta)),
                                               True, scale)
        pairs["bwd_dkv"] += [(dk[h:h + 1], ref_dk), (dv[h:h + 1], ref_dv)]
    errs, ratios = compare(pairs)
    case = {"dtype": "bfloat16", "BH": BH, "T": T, "D": D, "causal": True,
            "elements_per_operand": BH * T * D, "heads_held": list(HUGE_HEADS),
            "seconds": time.perf_counter() - t0, "max_abs_err": errs, "err_to_limit": ratios}
    emit({"phase": "kernels", "heads": case})
    check_ratios(ratios, {"heads": case})
    del q, k, v, do, o, lse, delta, dk, dv, pairs
    torch.cuda.empty_cache()


def sdpa_backends(q, k, v) -> list:
    """The F.scaled_dot_product_attention backends that take these [B, H, T,
    D] inputs with the causal mask (cuDNN, flash, memory-efficient, math,
    each tried alone); the yardstick's call is served by PyTorch's pick
    among them (past 256 only the memory-efficient and math ones take bf16,
    and PyTorch prefers the first)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    taken = []
    for backend in (SDPBackend.CUDNN_ATTENTION, SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        try:
            with torch.no_grad(), sdpa_kernel([backend]):
                F.scaled_dot_product_attention(q, k, v, is_causal=True)
            taken.append(backend.name)
        except RuntimeError:
            pass
    return taken


def gqa_case(fa, dev, gen, dtype) -> None:
    """GQA through `mha` (8 query heads on 2 kv heads): forward and
    gradients of the autograd function around the kernels.

    f32: against autograd through the plain attention, another formulation
    of the same function. bf16: against the kernels' plain versions,
    composed as the autograd function composes them, on kv heads this
    script expands itself in jnp.repeat's order. Both take delta =
    rowsum(do * o) from the kernel path's bf16 o: where two o's are an ulp
    apart, delta moves dq by more than an ulp where dq is near 0, which is
    also why autograd through the plain attention (no rounded o at all) is
    no reference in bf16. Each head's bf16 dk and dv is rounded before the
    heads that share a kv head are summed, so those sums get the rounded
    terms' magnitudes as slack."""
    B, T, H, Hk, D = 2, 1000, 8, 2, 64
    rep, scale = H // Hk, D ** -0.5
    q, do = (torch.randn(B, T, H, D, device=dev, generator=gen).to(dtype) for _ in range(2))
    k, v = (torch.randn(B, T, Hk, D, device=dev, generator=gen).to(dtype) for _ in range(2))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = fa.mha(*leaves, causal=True, impl="kernel")
    got = (o, *torch.autograd.grad(o, leaves, do))
    if dtype == torch.float32:
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        o = fa.mha(*leaves, causal=True, impl="torch")
        want = (o, *torch.autograd.grad(o, leaves, do))
        slack = (None,) * 4
    else:
        def bhtd(x):  # [B, T, h, D] -> [B*h, T, D]
            return x.transpose(1, 2).reshape(-1, T, D)

        def bthd(x):  # [B*h, T, D] -> [B, T, h, D]
            return x.reshape(B, -1, T, D).transpose(1, 2)

        qf, kf, vf, dof = (bhtd(t) for t in (q, k.repeat_interleave(rep, dim=2),
                                             v.repeat_interleave(rep, dim=2), do))
        o_ref, lse = fa._flash_fwd_ref(qf, kf, vf, True, scale, True)
        delta = (dof.float() * bhtd(got[0].detach()).float()).sum(-1)
        dq = fa._flash_bwd_dq_ref(qf, kf, vf, dof, lse, delta, True, scale).to(dtype)
        heads = [bthd(g.to(dtype)).float().reshape(B, T, Hk, rep, D)
                 for g in fa._flash_bwd_dkv_ref(qf, kf, vf, dof, lse, delta, True, scale)]
        want = (bthd(o_ref), bthd(dq), *(h.sum(3).to(dtype) for h in heads))
        slack = (None, None, *(h.abs().sum(3) for h in heads))
    names = ("o", "dq", "dk", "dv")
    errs = {n: max_err(a, b) for n, a, b in zip(names, got, want)}
    ratios = {n: err_ratio(a, b, s) for n, a, b, s in zip(names, got, want, slack)}
    case = {"dtype": str(dtype).split(".")[-1], "B_T_H_Hk_D": [B, T, H, Hk, D],
            "max_abs_err": errs, "err_to_limit": ratios}
    emit({"phase": "kernels", "gqa": case})
    check_ratios(ratios, {"gqa": case})


def kernel_timings(fa, dev, gen, cfg, batch: int = BATCH, seq: int = SEQ) -> dict:
    """Each kernel at the shapes the train step of `cfg` gives it at `batch`
    x `seq` (bf16, causal, [B*H, T, D]): its time, its plain version's, the
    library call's, its bound and the host's us per call (every bf16 kernel
    encodes its tensor maps at each call). A head dim off the kernels'
    widths runs padded (the wrappers' own padding: each call pads its
    inputs and cuts its outputs), and the line gives those copies' device
    ms. On the f32 route (fa.parts_route) B3 and B4 are timed on parts made
    beforehand, and the line gives the backward's work as the autograd
    function does it (do split, then B3 and B4 on the forward's parts)
    beside SDPA's backward. Returns {key: row}."""
    BH, T, D = batch * cfg.n_heads, seq, cfg.head_dim
    dt = cfg.dtype
    width = fa.kernel_width(D)
    q, k, v, do = (torch.randn(BH, T, D, device=dev, generator=gen).to(dt) for _ in range(4))
    scale = D ** -0.5
    o, lse = fa.flash_fwd(q, k, v, causal=True, scale=scale, with_lse=True)
    delta = (do.float() * o.float()).sum(-1)

    ref_o, ref_lse = fa._flash_fwd_ref(q, k, v, True, scale, True)
    pairs = {"fwd": [(fa.flash_fwd(q, k, v, causal=True, scale=scale), ref_o)],
             "fwd_lse": [(o, ref_o), (lse, ref_lse)],
             "bwd_dq": [(fa.flash_bwd_dq(q, k, v, do, lse, delta, causal=True, scale=scale),
                         fa._flash_bwd_dq_ref(q, k, v, do, lse, delta, True, scale))],
             "bwd_dkv": list(zip(fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal=True, scale=scale),
                                 fa._flash_bwd_dkv_ref(q, k, v, do, lse, delta, True, scale)))}
    errs, ratios = compare(pairs)
    del ref_o, ref_lse, pairs
    check_ratios(ratios, "the slice's shape")

    kernel_fns = {
        "fwd": lambda: fa.flash_fwd(q, k, v, causal=True, scale=scale),
        "fwd_lse": lambda: fa.flash_fwd(q, k, v, causal=True, scale=scale, with_lse=True),
        "bwd_dq": lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, causal=True, scale=scale),
        "bwd_dkv": lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal=True, scale=scale),
    }
    parts = fa.split_parts(q, k, v, do) if fa.parts_route(q) else None
    if parts is not None:  # the f32 B3 and B4 alone, on their operands' parts
        kernel_fns["bwd_dq"] = lambda: fa.flash_bwd_dq_parts(parts, lse, delta, causal=True, scale=scale)
        kernel_fns["bwd_dkv"] = lambda: fa.flash_bwd_dkv_parts(parts, lse, delta, causal=True, scale=scale)

        def autograd_bwd():  # _FlashAttention.backward's kernels on the forward's saved parts
            both = (*parts[:3], *fa.split_parts(do))
            return (fa.flash_bwd_dq_parts(both, lse, delta, causal=True, scale=scale),
                    fa.flash_bwd_dkv_parts(both, lse, delta, causal=True, scale=scale))
    plain_fns = {
        "fwd": lambda: fa._flash_fwd_ref(q, k, v, True, scale),
        "fwd_lse": lambda: fa._flash_fwd_ref(q, k, v, True, scale, True),
        "bwd_dq": lambda: fa._flash_bwd_dq_ref(q, k, v, do, lse, delta, True, scale),
        "bwd_dkv": lambda: fa._flash_bwd_dkv_ref(q, k, v, do, lse, delta, True, scale),
    }
    # Yardstick: PyTorch's fused attention on the same inputs, [B, H, T, D].
    sq, sk, sv = (t.view(batch, cfg.n_heads, T, D).detach().requires_grad_(True) for t in (q, k, v))
    sdo = do.view(batch, cfg.n_heads, T, D)
    with torch.no_grad():
        sdpa_fwd_ms = time_ms(lambda: F.scaled_dot_product_attention(sq, sk, sv, is_causal=True))
    so = F.scaled_dot_product_attention(sq, sk, sv, is_causal=True)
    sdpa_bwd_ms = time_ms(lambda: torch.autograd.grad(so, (sq, sk, sv), sdo, retain_graph=True))
    library = {"fwd": sdpa_fwd_ms, "fwd_lse": sdpa_fwd_ms, "bwd_dq": sdpa_bwd_ms, "bwd_dkv": sdpa_bwd_ms}
    line = {"phase": "kernels", "shape": [BH, T, D], "width": width, "dtype": str(dt).split(".")[-1],
            "causal": True, "sdpa_fwd_ms": sdpa_fwd_ms, "sdpa_bwd_ms": sdpa_bwd_ms}
    line["sdpa_fwd_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(sq, sk, sv, is_causal=True), (sq, sk, sv), sdo))
    # The port's forward and backward through its autograd function, the same work.
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    line["port_fwd_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
        fa._FlashAttention.apply(*leaves, True, scale), leaves, do))

    pairs = BH * T * (T + 1) / 2  # (query, key) pairs under the causal mask: one exp each
    elt = q.element_size()
    mat = BH * T * D  # elements of one [BH, T, D] operand
    work = {  # (flops, bytes): each input read once, each output written once
        "fwd": (4 * D * pairs, 4 * mat * elt),
        "fwd_lse": (4 * D * pairs, 4 * mat * elt + BH * T * 4),
        "bwd_dq": (6 * D * pairs, 4 * mat * elt + 2 * BH * T * 4 + mat * 4),
        "bwd_dkv": (8 * D * pairs, 4 * mat * elt + 2 * BH * T * 4 + 2 * mat * 4),
    }
    peak = PEAK_BF16 if dt == torch.bfloat16 else PEAK_F32_SPLIT
    host_us = importlib.import_module("ray_tpu_torch.ops.kernel_ab").host_us
    rows = {}
    for _, key, _ in KERNELS:
        flops, nbytes = work[key]
        least = bound(flops, nbytes, pairs, peak)
        ms = time_ms(kernel_fns[key])
        rows[key] = {
            "max_abs_err": errs[key],
            "err_to_limit": ratios[key],
            "ms": ms,
            "plain_ms": time_ms(plain_fns[key], reps=5),
            **least,
            "library_ms": library[key],
            "tflops": flops / ms * 1e-9,  # useful flops, no recompute, no hi/lo split
            "bound_share": least["bound_ms"] / ms,
        }
        # ~50 ms of device work at most: 200 calls of a fast kernel, 20 of
        # a slow one (200 calls of a 10 ms one held the card 2 s a kernel).
        rows[key]["host_us"] = host_us(kernel_fns[key], calls=max(20, min(200, int(50 / ms))))
    line.update(timings=rows, sdpa_backends=sdpa_backends(sq.detach(), sk.detach(), sv.detach()))
    if parts is not None:
        rows["split"] = split_timing(fa, q, k, v)
        rows["split_bwd"] = split_timing(fa, do)
        line["bwd_with_split_ms"] = time_ms(autograd_bwd)
    if width != D:  # the padded route's copies: q, k, v and do padded, o, dq, dk, dv cut
        outs = [torch.empty(BH, T, width, dtype=dt, device=dev),
                *(torch.empty(BH, T, width, device=dev) for _ in range(3))]
        line["pad_ms"] = time_ms(lambda: fa._pad(width, q, k, v, do))
        line["cut_ms"] = time_ms(lambda: [fa._cut(x, D) for x in outs])
    emit(line)
    return rows


def split_timing(fa, *xs) -> dict:
    """The f32 route's split pass on xs (the forward's q, k, v; the
    backward's do): bitwise against its plain version (max_abs_err 0), its
    time, the plain version's and its bound (bytes: each element read as
    f32 and written as two bf16 parts)."""
    got = fa.split_parts(*xs)
    err = max(max_err(a, fa._split_ref(x)) for a, x in zip(got, xs))
    check(err == 0, f"the split pass is off its plain version by {err}")
    t_bytes = 8 * sum(x.numel() for x in xs) / HBM_BYTES_PER_S * 1e3
    ms = time_ms(lambda: fa.split_parts(*xs))
    return {"max_abs_err": err, "ms": ms, "plain_ms": time_ms(lambda: [fa._split_ref(x) for x in xs], reps=5),
            "bound_ms": t_bytes, "bound_by": "bytes", "library_ms": None, "bound_share": t_bytes / ms}


# This repo's flash kernels (and the split pass) in a profiler event's name,
# as the profiler demangles it: "bwd_dq_kernel_sm90_f32<64, true>",
# "fwd_kernel_sm90<32, true, true>".
_FLASH_NAME = re.compile(r"\b(?:fwd|bwd_dq|bwd_dkv|split)_kernel(?:_sm90(?:_f32|_stream)?)?(?:<[^>]*>)?")


def flash_kernel_names(prof) -> list:
    """The sorted names of this repo's kernels a profile saw."""
    return sorted({m.group(0) for e in prof.events() for m in [_FLASH_NAME.search(e.name)] if m})


def f32_route(fa, dev) -> None:
    """Which kernels an f32 B1, B2 and the autograd function's backward
    (B3, B4) launch at each width, by the profiler's kernel names: the
    split pass and, at 64-256, the *_sm90_f32 kernels, at 512 the
    *_sm90_stream ones at P = 2; the backward's split on do alone (the
    forward's parts saved); and the wrappers' f32_launches agree."""
    from torch.profiler import ProfilerActivity, profile

    line = {}
    for D in fa.WIDTHS:
        q, k, v, do = (torch.randn(2, 300, D, device=dev) for _ in range(4))
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        fa.reset_launches()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fa.flash_fwd(q, k, v, causal=True, scale=D ** -0.5)
            torch.autograd.grad(fa._FlashAttention.apply(*leaves, True, D ** -0.5), leaves, do)
            torch.cuda.synchronize()
        names = flash_kernel_names(prof)
        line[D] = {"kernels": names, "f32_launches": dict(fa.f32_launches)}
        want = ([f"fwd_kernel_sm90_f32<{D}, true, false>", f"fwd_kernel_sm90_f32<{D}, true, true>",
                 f"bwd_dq_kernel_sm90_f32<{D}, true>", f"bwd_dkv_kernel_sm90_f32<{D}, true>", "split_kernel"]
                if D in fa.SPLIT_WIDTHS else
                ["fwd_kernel_sm90_stream<2, true, false>", "fwd_kernel_sm90_stream<2, true, true>",
                 "bwd_dq_kernel_sm90_stream<2, true>", "bwd_dkv_kernel_sm90_stream<2, true>", "split_kernel"])
        check(names == sorted(want) and fa.f32_launches == {
                  "split": 3, "fwd": 1, "fwd_lse": 1, "bwd_dq": 1, "bwd_dkv": 1},
              f"f32 B1-B4 at head dim {D} launched {line[D]}")
    emit({"phase": "kernels", "f32_route": line})


# ------------------------------------------------------------- phases 3, 4

def forward_phase(tr, fa, cfg, dev, gen, tokens) -> tuple:
    """Phase 3: the bf16 forward (logits_check), then the same weights in f32
    through the kernels (f32_forward_check). Returns both runs' launches."""
    model = tr.transformer_init(cfg, gen, device=dev)
    launches = logits_check(tr, fa, cfg, dev, model, tokens, {"phase": "forward"})
    return launches, f32_forward_check(tr, fa, cfg, dev, model, tokens)


def f32_forward_check(tr, fa, cfg, dev, model, tokens, line=None) -> dict:
    """transformer_apply of `model`'s weights built in f32, through the
    kernels (B1 on the tensor cores through the split pass) and through the
    plain attention; fails unless the logits are finite, of their shape and
    within F32_LOGITS_ATOL. Emits phase 3's line unless `line` is given.
    Returns the kernel run's f32 launches (fa.f32_launches)."""
    def build(impl):
        m = tr.Transformer(dataclasses.replace(cfg, attention_impl=impl, dtype=torch.float32), dev)
        m.load_state_dict(model.state_dict())
        return m

    kernel = build("kernel")
    fa.reset_launches()
    with torch.no_grad():
        logits = tr.transformer_apply(kernel, tokens)
        torch.cuda.synchronize()
        launches, f32 = dict(fa.launches), dict(fa.f32_launches)
        del kernel
        truth = tr.transformer_apply(build("torch"), tokens)
    err = max_err(logits, truth)
    emit({**(line or {"phase": "forward"}), "dtype": "float32", "shape": list(logits.shape), "max_abs_err": err,
          "mean_abs_err": float((logits - truth).abs().mean()), "bound": F32_LOGITS_ATOL,
          "f32_max_abs": float(truth.abs().max()), "launches": launches, "f32_launches": f32})
    check(tuple(logits.shape) == (*tokens.shape, cfg.vocab_size) and bool(torch.isfinite(logits).all()),
          "f32 logits are not finite or have the wrong shape")
    check(err <= F32_LOGITS_ATOL, f"f32 logits through the kernels {err} off the plain path's")
    check(f32["fwd"] == cfg.n_layers and f32["split"] == cfg.n_layers,
          f"the f32 forward did not run B1 through the split pass once a layer: {f32}")
    return f32


def logits_check(tr, fa, cfg, dev, model, tokens, line: dict) -> dict:
    """transformer_apply on `tokens` through the kernels and through the
    plain attention in bf16, each against the same weights run in f32;
    emits `line` with the errors and fails past LOGITS_MEAN_RATIO and
    LOGITS_MAX_RATIO. Returns the kernels' launches."""
    plain = tr.Transformer(dataclasses.replace(cfg, attention_impl="torch"), dev)
    plain.load_state_dict(model.state_dict())
    fa.reset_launches()
    with torch.no_grad():
        logits = tr.transformer_apply(model, tokens)
        torch.cuda.synchronize()
        launches = dict(fa.launches)
        ref = tr.transformer_apply(plain, tokens)
        del plain
        f32 = tr.Transformer(dataclasses.replace(cfg, attention_impl="torch", dtype=torch.float32), dev)
        f32.load_state_dict(model.state_dict())
        truth = tr.transformer_apply(f32, tokens)
        del f32
    errs = {name: {"max_abs_err": max_err(x, truth),
                   "mean_abs_err": float((x - truth).abs().mean())}
            for name, x in (("kernel_bf16", logits), ("plain_bf16", ref))}
    line = {**line, "shape": list(logits.shape), "vs_f32": errs,
            "kernel_vs_plain_max_abs_err": max_err(logits, ref),
            "f32_max_abs": float(truth.abs().max()),
            "f32_mean_abs": float(truth.abs().mean()),
            "ratio_bounds": [LOGITS_MEAN_RATIO, LOGITS_MAX_RATIO], "launches": launches}
    emit(line)
    check(tuple(logits.shape) == (*tokens.shape, cfg.vocab_size), "logits have the wrong shape")
    check(bool(torch.isfinite(logits).all()), "logits are not finite")
    k, p = errs["kernel_bf16"], errs["plain_bf16"]
    check(k["mean_abs_err"] <= LOGITS_MEAN_RATIO * p["mean_abs_err"]
          and k["max_abs_err"] <= LOGITS_MAX_RATIO * p["max_abs_err"],
          f"kernel-path logits further from f32 than the plain path's: {errs}")
    return launches


def first_grads(tr, model, batch) -> tuple:
    """(loss, {name: gradient}) of one forward and backward."""
    loss = tr.transformer_loss(model, batch)
    loss.backward()
    grads = {name: p.grad for name, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), grads


def grads_check(tr, cfg, dev, model, batch, line=None, f32=False):
    """The first step's loss and every parameter's gradient through the
    kernels, against the plain path in bf16 and in f32 on the same weights;
    emitted as phase 4's line unless `line` is given. With f32, then the
    same weights built in f32 through the kernels (f32_grads_check), whose
    f32 launches it returns."""
    loss, grads = first_grads(tr, model, batch)
    ref = {}
    for name, c in (("plain_bf16", dataclasses.replace(cfg, attention_impl="torch")),
                    ("plain_f32", dataclasses.replace(cfg, attention_impl="torch",
                                                      dtype=torch.float32))):
        m = tr.Transformer(c, dev)
        m.load_state_dict(model.state_dict())
        ref[name] = first_grads(tr, m, batch)
        del m
    truth = ref["plain_f32"][1]

    def rel(g, n):
        return float(torch.linalg.vector_norm(g[n] - truth[n]) / torch.linalg.vector_norm(truth[n]))

    ratios = {n: rel(grads, n) / max(rel(ref["plain_bf16"][1], n), 1e-12) for n in truth}
    worst = sorted(ratios, key=ratios.get)[-3:]
    emit({**(line or {"phase": "train"}), "first_step": {
        "loss": loss, "loss_plain_bf16": ref["plain_bf16"][0], "loss_plain_f32": ref["plain_f32"][0],
        "loss_bound": LOSS_BOUND, "grad_ratio_bound": GRAD_RATIO,
        "worst_grad_ratio": {n: ratios[n] for n in worst},
        "rel_err_vs_f32": {n: {"kernel_bf16": rel(grads, n), "plain_bf16": rel(ref["plain_bf16"][1], n)}
                           for n in ("embed", "blocks.0.wq", "blocks.0.wk", "blocks.0.wv",
                                     f"blocks.{cfg.n_layers - 1}.wk", worst[-1])},
    }})
    check(abs(loss - ref["plain_bf16"][0]) <= LOSS_BOUND, "first loss off the plain path")
    check(all(math.isfinite(r) and r <= GRAD_RATIO for r in ratios.values()),
          f"gradients through the kernels further from f32 than the plain path's: {worst}")
    if f32:
        return f32_grads_check(tr, cfg, dev, model, batch, ref["plain_f32"], line)
    return None


def f32_grads_check(tr, cfg, dev, model, batch, truth, line=None) -> dict:
    """`model`'s weights built in f32 through the kernels (B2-B4 on the
    tensor cores through the split passes; at head dim 512 and past on the
    streamed kernels): the first loss within F32_ATOL and every parameter's
    gradient within F32_GRAD_REL (relative L2) of `truth`, the plain f32
    path's (loss, grads) on the same weights and batch; B3 and B4 once a
    layer, one split pass for each forward (remat runs a layer's forward
    again in the backward) and one for each backward; by the profiler's
    names, every flash kernel a Hopper one (*_sm90*) or the split pass.
    Returns the run's fa.f32_launches."""
    from torch.profiler import ProfilerActivity, profile

    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    m = tr.Transformer(dataclasses.replace(cfg, attention_impl="kernel", dtype=torch.float32), dev)
    m.load_state_dict(model.state_dict())
    fa.reset_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        loss, grads = first_grads(tr, m, batch)
        torch.cuda.synchronize()
    launches, by_width = dict(fa.f32_launches), dict(fa.launches_by_width)
    names = flash_kernel_names(prof)
    del m
    rel = {n: float(torch.linalg.vector_norm(grads[n] - g) / torch.linalg.vector_norm(g))
           for n, g in truth[1].items()}
    worst = sorted(rel, key=rel.get)[-3:]
    emit({**(line or {"phase": "train"}), "first_step_f32": {
        "loss": loss, "loss_plain_f32": truth[0], "loss_err": abs(loss - truth[0]), "loss_bound": F32_ATOL,
        "grad_rel_bound": F32_GRAD_REL, "worst_grad_rel": {n: rel[n] for n in worst},
        "rel_err_vs_plain_f32": {n: rel[n] for n in ("blocks.0.wq", "blocks.0.wk", "blocks.0.wv",
                                                      f"blocks.{cfg.n_layers - 1}.wk")},
        "f32_launches": launches, "flash_kernels": names}})
    check(math.isfinite(loss) and abs(loss - truth[0]) <= F32_ATOL, "f32 first loss off the plain f32 path")
    check(all(math.isfinite(r) and r <= F32_GRAD_REL for r in rel.values()),
          f"f32 gradients through the kernels off the plain f32 path's: {worst}")
    n, width = cfg.n_layers, fa.kernel_width(cfg.head_dim)
    check(launches["bwd_dq"] == n and launches["bwd_dkv"] == n and launches["fwd_lse"] >= n
          and launches["split"] == launches["fwd_lse"] + n
          and by_width.get(f"bwd_dq@{width}") == n and by_width.get(f"bwd_dkv@{width}") == n,
          f"the f32 step did not run B2-B4 through the split passes once a layer: {launches}, {by_width}")
    check(names and all("_sm90" in name or name == "split_kernel" for name in names),
          f"the f32 step ran a flash kernel off the tensor cores: {names}")
    return launches


def train_phase(tr, fa, cfg, dev, gen) -> tuple:
    from ray_tpu_torch.device import peak_bf16_flops

    raw = torch.randint(0, cfg.vocab_size, (BATCH, SEQ + 1), device=dev, generator=gen)
    batch = {"tokens": raw[:, :-1].contiguous(), "targets": raw[:, 1:].contiguous()}
    model = tr.transformer_init(cfg, gen, device=dev)
    f32_launches = grads_check(tr, cfg, dev, model, batch, f32=True)
    init_state, step = tr.make_train_step(cfg, dev)
    state = init_state(model=model)

    fa.reset_launches()
    run = run_steps(step, state, batch)
    launches = dict(fa.launches)
    losses = [run["losses"][k] for k in sorted(run["losses"])]

    tokens_per_s = BATCH * SEQ / run["step_ms"] * 1e3
    peak = peak_bf16_flops(torch.cuda.get_device_name(0))
    useful = tr.flops_per_token(cfg, SEQ)
    hardware = tr.hardware_flops_per_token(cfg, SEQ)
    line = {
        "phase": "train", "batch": BATCH, "seq": SEQ, "steps": TRAIN_STEPS,
        "losses": losses, "step_ms": run["step_ms"], "tokens_per_s": tokens_per_s,
        "useful_mfu": useful * tokens_per_s / peak,
        "hardware_mfu": hardware * tokens_per_s / peak,
        "useful_flops_per_token": useful, "hardware_flops_per_token": hardware,
        "peak_flops": peak, "grad_norm": run["grad_norm"],
        "max_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches": launches,
    }
    emit(line)
    check(all(math.isfinite(x) for x in losses), "a loss is not finite")
    check(losses[-1] < losses[0], "the loss did not fall")
    check(line["hardware_mfu"] < 1.0, "hardware-MFU is not below 1")
    return launches, lambda: step(state, batch), line["step_ms"], f32_launches


def run_steps(step, state, batch, save=None) -> dict:
    """make_train_step's warm-up (step 0, unless the state resumes past it)
    and its steps up to TRAIN_STEPS, as phases 4 and 6 all run them. The
    steps after the warm-up are timed with the card synchronised only at the
    ends of the timed span, which is split after step TRAINER_SAVE_AT, where
    `save(state)` runs when it is given; the losses are read back after the
    run, so the host may queue ahead of the card. Returns {"losses": {k:
    loss}, "step_ms": mean time of the timed steps, "grad_norm": the last
    step's}."""
    losses = {}
    if state["step"] == 0:
        state, m = step(state, batch)
        losses[0] = m["loss"]
    timed, seconds = 0, 0.0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while state["step"] <= TRAIN_STEPS:
        k = state["step"]
        state, m = step(state, batch)
        losses[k] = m["loss"]
        timed += 1
        if k == TRAINER_SAVE_AT:
            torch.cuda.synchronize()
            seconds += time.perf_counter() - t0
            if save is not None:
                save(state)
            t0 = time.perf_counter()
    torch.cuda.synchronize()
    seconds += time.perf_counter() - t0
    return {"losses": {k: float(v) for k, v in losses.items()},
            "step_ms": seconds / timed * 1e3, "grad_norm": float(m["grad_norm"])}


def kernel_family(name: str) -> str:
    if any(s in name for s in ("fwd_kernel", "bwd_dq_kernel", "bwd_dkv_kernel", "split_kernel")):
        return "flash (this repo)"
    if any(s in name.lower() for s in ("conv", "fprop", "dgrad", "wgrad", "cudnn")):
        return "conv (cuDNN)"
    if any(s in name.lower() for s in ("gemm", "cutlass", "xmma", "nvjet", "sm90")):
        return "matmul (cuBLAS)"
    if "multi_tensor" in name or "adam" in name.lower() or "sgd" in name.lower():
        return "optimizer"
    return "other"


SCOPE = "smoke::"  # prefix of the record_function scopes profile_phase opens


@contextlib.contextmanager
def scoped(scopes: dict):
    """Run each function of `scopes` ({label: (module, attribute name)})
    inside record_function(SCOPE + label) until the block ends."""
    from torch.profiler import record_function

    def wrap(label, fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with record_function(SCOPE + label):
                return fn(*args, **kwargs)
        return inner

    saved = [(mod, attr, getattr(mod, attr)) for mod, attr in scopes.values()]
    for label, (mod, attr) in scopes.items():
        setattr(mod, attr, wrap(label, getattr(mod, attr)))
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def scope_times(events, leaf) -> dict:
    """{label: {key: time}} over the profiler's host events. `leaf(event)`
    gives the (key, time) pairs an event launched itself (its kernels).
    An event's label is the SCOPE it ran in; a backward op's is the scope
    its forward op ran in, matched by autograd sequence number (the node
    of number n is made by the last forward op that reports n); any other
    event takes its outermost op's name, "bwd " + the node's for the
    backward."""
    from torch.autograd import DeviceType

    def chain(e):
        while e is not None:
            yield e
            e = e.cpu_parent

    bwd = "autograd::engine::evaluate_function: "
    host = sorted((e for e in events if e.device_type == DeviceType.CPU),
                  key=lambda e: e.time_range.start)
    node_scope = {}
    for e in host:
        names = [a.name for a in chain(e)]
        if e.sequence_nr >= 0 and not any(n.startswith(bwd) for n in names):
            node_scope[e.sequence_nr] = next(
                (n[len(SCOPE):] for n in names if n.startswith(SCOPE)), None)
    out = {}
    for e in host:
        pairs = leaf(e)
        if not pairs:
            continue
        label = root = None
        for a in chain(e):
            if a.name.startswith(SCOPE):
                label = a.name[len(SCOPE):]
                break
            if a.name.startswith(bwd):
                label = node_scope.get(a.sequence_nr) or "bwd " + a.name[len(bwd):]
                break
            root = a.name
        row = out.setdefault(label or root, {})
        for key, t in pairs:
            row[key] = row.get(key, 0.0) + t
    return out


def profile_phase(run_step, step_ms: float, phase: str = "profile", scopes=None) -> None:
    """Where the device time of two train steps goes, by kernel family
    (torch.profiler), each flash kernel's share, and the device's idle share
    in the unprofiled steps timed before: 1 - device time per step / step
    time. With `scopes` (scoped's argument), also by op: each kernel goes
    to the scope or op that launched it (scope_times), forward and backward."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    steps = 2
    with scoped(scopes or {}), profile(activities=[ProfilerActivity.CPU,
                                                   ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            run_step()
        torch.cuda.synchronize()
    # Device-side user annotations (Optimizer.step#...) span kernels already counted.
    kernels = [e for e in prof.events()
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    by_name, flash = {}, {}
    families, counts = {}, {}
    for e in kernels:
        name, ms = e.name, e.time_range.elapsed_us() / 1e3 / steps
        by_name[name] = by_name.get(name, 0.0) + ms
        fam = kernel_family(name)
        if fam == "flash (this repo)":
            m = re.search(r"\w+_kernel(?:_tc|_sm90(?:_f32)?)?<[^>]*>", name)  # demangled: drop the arguments
            key = m.group(0) if m else kernel_label(name)
            flash[key] = flash.get(key, 0.0) + ms
        families[fam] = families.get(fam, 0.0) + ms
        counts[fam] = counts.get(fam, 0) + 1
    device_ms = sum(families.values())
    top = sorted(((ms, name) for name, ms in by_name.items()), reverse=True)[:8]
    line = {"phase": phase, "per_step": True, "device_ms": device_ms, "step_ms": step_ms,
            "idle_share": 1 - device_ms / step_ms if device_ms else None,
            "ms_by_family": families,
            "launches_by_family": {k: v // steps for k, v in counts.items()},
            "flash_ms_by_kernel": flash,
            "top_kernels_ms": [[n[:80], ms] for ms, n in top]}
    if scopes:
        by_op = scope_times(prof.events(), lambda e: [
            (kernel_family(k.name), k.duration / 1e3 / steps) for k in e.kernels])
        total = {op: sum(row.values()) for op, row in by_op.items()}
        ranked = sorted(total, key=total.get, reverse=True)
        line["ms_by_op"] = {op: by_op[op] for op in ranked[:12]}
        line["ms_by_op_rest"] = sum(total[op] for op in ranked[12:])
        line["ms_not_linked_to_an_op"] = device_ms - sum(total.values())
    emit(line)
    return device_ms


# ----------------------------------------------------------------- phase 6

def seeded_steps(cfg, dev, restore=None, save=None) -> dict:
    """Phase 6's run on `dev`, in the driver (the bare run) or in the
    trainer's worker: a batch and the weights drawn in that order from
    SEED + 1, then run_steps. `restore` loads a checkpoint into the state
    first and the run goes on from its step; `save` is run_steps'. Returns
    run_steps' result and "launches", the flash kernels' launches."""
    from ray_tpu_torch.models import transformer as tr

    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    raw = torch.randint(0, cfg.vocab_size, (BATCH, SEQ + 1), device=dev, generator=gen)
    batch = {"tokens": raw[:, :-1].contiguous(), "targets": raw[:, 1:].contiguous()}
    init_state, step = tr.make_train_step(cfg, dev)
    state = init_state(gen)
    if restore is not None:
        restore(state)
    fa.reset_launches()
    run = run_steps(step, state, batch, save)
    return {**run, "launches": dict(fa.launches)}


def trainer_loop(config) -> None:
    """The train loop a runtime worker runs for TorchTrainer: seeded_steps on
    get_device(), saving a checkpoint (model and AdamW state) after step
    TRAINER_SAVE_AT unless it resumed from one; then a report of each step's
    loss, the checkpoint with step TRAINER_SAVE_AT's, and one summary
    report."""
    import tempfile

    from ray_tpu_torch import train
    from ray_tpu_torch.train.torch import get_device, load_state, save_state

    started = time.time()
    dev = get_device()  # matmuls keep TF32 off, PyTorch's default, as main() sets it
    ckpt = train.get_checkpoint()

    def restore(state):
        with ckpt.as_directory() as d:
            load_state(state, d)

    torch.cuda.reset_peak_memory_stats(dev)
    with tempfile.TemporaryDirectory() as d:
        if ckpt is None:
            run = seeded_steps(config["cfg"], dev, save=lambda state: save_state(state, d))
        else:
            run = seeded_steps(config["cfg"], dev, restore=restore)
        for k, loss in sorted(run["losses"].items()):
            saved = ckpt is None and k == TRAINER_SAVE_AT
            train.report({"step": k, "loss": loss},
                         checkpoint=train.Checkpoint.from_directory(d) if saved else None)
    train.report({"summary": {
        "device": str(dev), "device_name": torch.cuda.get_device_name(dev),
        "pid": os.getpid(), "loop_started_at": started,
        "step_ms": run["step_ms"],
        "tokens_per_s": BATCH * SEQ / run["step_ms"] * 1e3,
        "max_memory_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
        "launches": run["launches"],
        "library": importlib.import_module("ray_tpu_torch.ops.flash_attention")._kernels()._name,
        "forbidden_modules": forbidden_modules(),
    }})


def fit_trainer(cfg, storage: str, name: str, resume=None) -> tuple:
    """One fit of trainer_loop on a one-worker GPU gang: (result, its step
    losses {k: loss}, its summary, seconds from fit() to the loop's start)."""
    from ray_tpu_torch.air import RunConfig, ScalingConfig
    from ray_tpu_torch.train.torch import TorchTrainer

    t0 = time.time()
    result = TorchTrainer(
        trainer_loop,
        train_loop_config={"cfg": cfg},
        scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
        run_config=RunConfig(name=name, storage_path=storage),
        resume_from_checkpoint=resume,
    ).fit()
    losses = {m["step"]: m["loss"] for m in result.metrics_history if "step" in m}
    summary = result.metrics_history[-1]["summary"]
    return result, losses, summary, summary["loop_started_at"] - t0


def trainer_phase(cfg, dev, build) -> dict:
    """The GPT-2-small step through the runtime: a bare run here, then the
    same run in a TorchTrainer worker and a resumed fit. Returns the
    trainer's launches per kernel (both fits)."""
    import ray_tpu_torch as rt

    bare = seeded_steps(cfg, dev)
    torch.cuda.synchronize()
    lib = build.library_path("flash_attention")
    lib_mtime = lib.stat().st_mtime_ns
    storage = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                           "chip_smoke_trainer")
    shutil.rmtree(storage, ignore_errors=True)

    t0 = time.time()
    rt.init(num_cpus=2)
    init_s = time.time() - t0
    try:
        resources = rt.cluster_resources()
        check(resources.get("GPU") == torch.cuda.device_count(),
              f"the runtime detected GPU {resources.get('GPU')}, "
              f"torch sees {torch.cuda.device_count()}")
        t0 = time.time()
        first, losses, summary, start_s = fit_trainer(cfg, storage, "fit")
        fit_s = time.time() - t0
        check(first.checkpoint is not None, "the trainer saved no checkpoint")
        t0 = time.time()
        _, resumed, resumed_summary, resumed_start_s = fit_trainer(
            cfg, storage, "resumed", resume=first.checkpoint)
        resumed_fit_s = time.time() - t0
    finally:
        rt.shutdown()
        shutil.rmtree(storage, ignore_errors=True)

    steps = sorted(bare["losses"])
    vs_bare = {k: abs(losses[k] - bare["losses"][k]) for k in steps if k in losses}
    vs_first = {k: abs(resumed[k] - losses[k]) for k in resumed if k in losses}
    n_bare, n_resumed = len(bare["losses"]), len(resumed)
    launches = {key: summary["launches"][key] + resumed_summary["launches"][key]
                for _, key, _ in KERNELS}
    emit({"phase": "trainer", "batch": BATCH, "seq": SEQ, "steps": TRAIN_STEPS,
          "save_at": TRAINER_SAVE_AT,
          "bare": {"losses": [bare["losses"][k] for k in steps], "step_ms": bare["step_ms"],
                   "tokens_per_s": BATCH * SEQ / bare["step_ms"] * 1e3,
                   "launches": bare["launches"]},
          "worker": {**summary, "losses": [losses.get(k) for k in steps]},
          "resumed": {"losses": {str(k): v for k, v in sorted(resumed.items())},
                      "launches": resumed_summary["launches"],
                      "device": resumed_summary["device"],
                      "fit_s": resumed_fit_s, "worker_start_s": resumed_start_s},
          "max_loss_diff_vs_bare": max(vs_bare.values(), default=None),
          "loss_bitwise_equal_to_bare": all(d == 0.0 for d in vs_bare.values()),
          "max_loss_diff_resumed_vs_fit": max(vs_first.values(), default=None),
          "init_s": init_s, "fit_s": fit_s, "worker_start_s": start_s,
          "loss_bound": LOSS_BOUND})
    check(summary["device"].startswith("cuda") and resumed_summary["device"].startswith("cuda"),
          f"the worker trained on {summary['device']}")
    check(sorted(losses) == steps, f"the worker reported steps {sorted(losses)}")
    check(all(d <= LOSS_BOUND for d in vs_bare.values()), f"worker's losses off the bare run's: {vs_bare}")
    check(sorted(resumed) == list(range(TRAINER_SAVE_AT + 1, TRAIN_STEPS + 1)),
          f"the resumed fit ran steps {sorted(resumed)}")
    check(all(d <= LOSS_BOUND for d in vs_first.values()), f"resumed losses off: {vs_first}")
    check(losses[TRAIN_STEPS] < losses[0], "the trainer's loss did not fall")
    check(not summary["forbidden_modules"] and not resumed_summary["forbidden_modules"],
          f"the worker imported {summary['forbidden_modules']}")
    check(os.path.samefile(summary["library"], lib) and lib.stat().st_mtime_ns == lib_mtime,
          f"the worker loaded {summary['library']}, not the build of phase 1 ({lib})")
    for key in ("fwd_lse", "bwd_dq", "bwd_dkv"):
        check(summary["launches"][key] > 0, f"{key} was not launched in the trainer's worker")
    for key in launches:
        check(summary["launches"][key] == bare["launches"][key]
              and resumed_summary["launches"][key] * n_bare == bare["launches"][key] * n_resumed,
              f"the worker's launches per step differ from the bare run's: {summary['launches']}, "
              f"{resumed_summary['launches']} ({n_resumed} steps), bare {bare['launches']}")
    return launches


# ----------------------------------------------------------------- phase 7

def rel_l2(x, ref) -> float:
    x, ref = x.detach().float(), ref.detach().float()
    return float(torch.linalg.vector_norm(x - ref) / torch.linalg.vector_norm(ref))


def resnet_first_pass(resnet, cfg, weights, images, labels, train: bool) -> dict:
    """One forward and backward of a fresh ResNet in `cfg` holding
    `weights`: its logits, loss, running statistics and gradients."""
    model = resnet.ResNet(cfg, images.device)
    model.load_state_dict(weights)
    logits = resnet.resnet_apply(model, images, train=train)
    loss = F.cross_entropy(logits, labels)
    loss.backward()
    return {"logits": logits.detach(), "loss": float(loss.detach()),
            "stats": {n: b.clone() for n, b in model.named_buffers()},
            "grads": {n: p.grad for n, p in model.named_parameters()}}


def worst(errs: dict, n: int = 3) -> dict:
    return dict(sorted(errs.items(), key=lambda kv: kv[1])[-n:])


def median(values) -> float:
    values = sorted(values)
    return values[len(values) // 2]


def check_inputs(resnet, cfg, dev, gen) -> tuple:
    """Weights, RESNET_CHECK_BATCH channels_last images and labels."""
    weights = resnet.resnet_init(cfg, dev, gen).state_dict()
    images = torch.randn(RESNET_CHECK_BATCH, RESNET_SIZE, RESNET_SIZE, 3, device=dev,
                         generator=gen).permute(0, 3, 1, 2)
    labels = torch.randint(0, cfg.num_classes, (RESNET_CHECK_BATCH,), device=dev, generator=gen)
    return weights, images, labels


def vs(a, b, key) -> dict:
    return {n: rel_l2(a[key][n], t) for n, t in b[key].items()}


def train_passes(resnet, cfg, weights, images, labels, moves) -> tuple:
    """Train-mode first passes of bf16 `cfg` and of f32 on the same inputs,
    and of f32 on each image set of `moves` ({name: images}). Returns the
    bf16 and f32 passes and, for each move, the median relative L2 over
    the parameters of how far it moves f32's gradients."""
    f32 = dataclasses.replace(cfg, dtype=torch.float32)
    got, want = (resnet_first_pass(resnet, c, weights, images, labels, True) for c in (cfg, f32))
    medians = {}
    for name, moved in moves.items():
        medians[name] = median(vs(resnet_first_pass(resnet, f32, weights, moved, labels, True),
                                  want, "grads").values())
    return got, want, medians


def resnet_checks(resnet, cfg, dev, gen) -> None:
    """bf16 against f32 on the same weights and images at batch
    RESNET_CHECK_BATCH: train-mode logits and running statistics, eval-mode
    gradients; the train-mode gradients reported beside how far f32's move
    for a one-ulp change of the images and for images rounded to bf16."""
    weights, images, labels = check_inputs(resnet, cfg, dev, gen)
    ulp = images * (1 + 2.0 ** -23 * torch.randn(images.shape, device=dev, generator=gen).sign())
    moves = {"one_ulp": ulp, "bf16_images": images.to(cfg.dtype).float()}
    got, want, f32_moves = train_passes(resnet, cfg, weights, images, labels, moves)
    logits = rel_l2(got["logits"], want["logits"])
    stats, train_grads = vs(got, want, "stats"), vs(got, want, "grads")
    check(tuple(got["logits"].shape) == (RESNET_CHECK_BATCH, cfg.num_classes)
          and bool(torch.isfinite(got["logits"]).all()), "ResNet logits: wrong shape or not finite")
    del got, want
    f32 = dataclasses.replace(cfg, dtype=torch.float32)
    got, want = (resnet_first_pass(resnet, c, weights, images, labels, False) for c in (cfg, f32))
    grads = vs(got, want, "grads")
    line = {"logits_rel_l2": logits, "worst_stats_rel_l2": worst(stats),
            "eval_worst_grad_rel_l2": worst(grads), "eval_median_grad_rel_l2": median(grads.values()),
            "train_median_grad_rel_l2": median(train_grads.values()),
            "f32_train_median_grad_move": f32_moves,
            "bounds": {"logits": RESNET_LOGITS_REL, "stats": RESNET_STATS_REL,
                       "eval_grads": RESNET_GRAD_REL}}
    emit({"phase": "resnet", "batch": RESNET_CHECK_BATCH, "size": RESNET_SIZE, "bf16_vs_f32": line})
    check(logits <= RESNET_LOGITS_REL, f"bf16 ResNet logits off f32: {line}")
    check(all(math.isfinite(r) and r <= RESNET_STATS_REL for r in stats.values()),
          f"bf16 running statistics off f32: {line['worst_stats_rel_l2']}")
    check(all(math.isfinite(r) and r <= RESNET_GRAD_REL for r in grads.values()),
          f"bf16 first gradients off f32: {line['eval_worst_grad_rel_l2']}")
    check(all(math.isfinite(r) for r in train_grads.values()), "a train-mode gradient is not finite")


def resnet18_train_grads(resnet, dev, gen) -> None:
    """ResNet-18 at full width, train mode: the bf16 first gradients
    against f32's, their median within RESNET18_GRAD_RATIO times how far
    rounding the images to bf16 moves f32's."""
    cfg = resnet.ResNetConfig(depth=18, num_classes=1000, dtype=torch.bfloat16)
    weights, images, labels = check_inputs(resnet, cfg, dev, gen)
    got, want, moves = train_passes(resnet, cfg, weights, images, labels,
                                    {"bf16_images": images.to(cfg.dtype).float()})
    grads = vs(got, want, "grads")
    line = {"train_median_grad_rel_l2": median(grads.values()),
            "train_worst_grad_rel_l2": worst(grads),
            "f32_train_median_grad_move": moves,
            "ratio": median(grads.values()) / moves["bf16_images"], "bound": RESNET18_GRAD_RATIO}
    emit({"phase": "resnet", "depth": 18, "batch": RESNET_CHECK_BATCH, "size": RESNET_SIZE,
          "bf16_vs_f32": line})
    check(all(math.isfinite(r) for r in grads.values()), "a ResNet-18 gradient is not finite")
    check(line["ratio"] <= RESNET18_GRAD_RATIO,
          f"bf16 ResNet-18 train-mode gradients off f32: {line}")


BN_CHECKED = ("output", "input_grad", "scale_grad", "bias_grad")


def bn_layer_checks(resnet, cfg, dev, gen) -> dict:
    """Each batch norm of `cfg`, train mode, forward and backward alone, in
    bf16 against f32: the activations a bf16 train-mode forward of
    RESNET_CHECK_BATCH images hands each one, the same upstream gradient,
    its trained scale and bias. {layer: {output, input grad, scale grad,
    bias grad: relative L2}}."""
    model = resnet.resnet_init(cfg, dev, gen)
    names = {id(m): n for n, m in model.named_modules()}
    seen = []
    bn = resnet._bn

    def record(x, mod, train):
        seen.append((names[id(mod)], x.detach().clone()))
        return bn(x, mod, train)

    images = torch.randn(RESNET_CHECK_BATCH, RESNET_SIZE, RESNET_SIZE, 3, device=dev,
                         generator=gen).permute(0, 3, 1, 2)
    resnet._bn = record
    try:
        with torch.no_grad():
            resnet.resnet_apply(model, images, train=True)
    finally:
        resnet._bn = bn
    out = {}
    for name, x in seen:
        mod = model.get_submodule(name)
        with torch.no_grad():  # a trained layer's scale and bias, not init's 1 and 0
            mod.scale.copy_(1 + 0.5 * torch.randn(mod.scale.shape, device=dev, generator=gen))
            mod.bias.copy_(0.5 * torch.randn(mod.bias.shape, device=dev, generator=gen))
        g = torch.randn(x.shape, device=dev, generator=gen).to(x.dtype)
        runs = {}
        for dt in (x.dtype, torch.float32):
            xi = x.to(dt, copy=True).requires_grad_()
            mod.zero_grad(set_to_none=True)
            y = bn(xi, mod, True)
            y.backward(g.to(dt))
            runs[dt] = (y.detach(), xi.grad, mod.scale.grad.clone(), mod.bias.grad.clone())
        out[name] = {k: rel_l2(a, b)
                     for k, a, b in zip(BN_CHECKED, runs[x.dtype], runs[torch.float32])}
    return out


def resnet_bn_layers(resnet, cfg, dev, gen) -> None:
    """bn_layer_checks on `cfg`, each relative L2 within RESNET_BN_LAYER_REL."""
    layers = bn_layer_checks(resnet, cfg, dev, gen)
    line = {"layers": len(layers), "bound": RESNET_BN_LAYER_REL,
            "worst": {k: max((v[k], n) for n, v in layers.items()) for k in BN_CHECKED},
            "median": {k: median([v[k] for v in layers.values()]) for k in BN_CHECKED}}
    emit({"phase": "resnet", "bn_layers_bf16_vs_f32": line})
    check(all(math.isfinite(r) and r <= RESNET_BN_LAYER_REL for v in layers.values()
              for r in v.values()), f"a bf16 train-mode batch norm is off f32: {line}")


def resnet_phase(dev, gen) -> None:
    """ResNet-50 at full width: resnet_checks, resnet18_train_grads and
    resnet_bn_layers, then the bench's step at
    batch RESNET_BATCH: a warm-up and TRAIN_STEPS steps on one batch, timed
    with the card synchronised at the ends; the loss must fall. Then a
    profile of two further steps."""
    from ray_tpu_torch.device import peak_bf16_flops
    from ray_tpu_torch.models import resnet

    cfg = resnet.ResNetConfig(depth=50, num_classes=1000, dtype=torch.bfloat16)
    resnet_checks(resnet, cfg, dev, gen)
    resnet18_train_grads(resnet, dev, gen)
    resnet_bn_layers(resnet, cfg, dev, gen)
    gc.collect()
    torch.cuda.empty_cache()

    init_state, step = resnet.make_train_step(cfg, dev)
    state = init_state(gen)
    images = torch.randn(RESNET_BATCH, RESNET_SIZE, RESNET_SIZE, 3, device=dev, generator=gen)
    batch = {"images": images.to(cfg.dtype).permute(0, 3, 1, 2),
             "labels": torch.randint(0, cfg.num_classes, (RESNET_BATCH,), device=dev,
                                     generator=gen)}
    torch.cuda.reset_peak_memory_stats(dev)
    losses = [step(state, batch)[1]["loss"]]  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        losses.append(step(state, batch)[1]["loss"])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / TRAIN_STEPS * 1e3
    losses = [float(x) for x in losses]
    images_per_s = RESNET_BATCH / step_ms * 1e3
    flops = resnet.train_flops_per_image(cfg, RESNET_SIZE)
    emit({"phase": "resnet", "batch": RESNET_BATCH, "size": RESNET_SIZE, "steps": TRAIN_STEPS,
          "losses": losses, "step_ms": step_ms, "images_per_s": images_per_s,
          "flops_per_image": flops,
          "mfu": flops * images_per_s / peak_bf16_flops(torch.cuda.get_device_name(0)),
          "max_memory_gib": torch.cuda.max_memory_allocated(dev) / 2**30})
    check(all(math.isfinite(x) for x in losses), "a ResNet loss is not finite")
    check(losses[-1] < losses[0], "the ResNet loss did not fall")
    profile_phase(lambda: step(state, batch), step_ms, phase="resnet_profile",
                  scopes={"batch_norm": (resnet, "_bn"), "conv": (resnet, "_conv")})


# ----------------------------------------------------------------- phase 8

def bench_phase() -> dict:
    """`python -m ray_tpu_torch.bench` from this checkout, and the checks on
    its line. Returns its transformer phase's flash launches."""
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-m", "ray_tpu_torch.bench"],
                          cwd=os.path.dirname(os.path.abspath(__file__)),
                          capture_output=True, text=True, timeout=900)
    seconds = time.time() - t0
    check(proc.returncode == 0, f"the bench exited {proc.returncode}:\n{proc.stdout[-2000:]}\n"
                                f"{proc.stderr[-4000:]}")
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    emit({"phase": "bench", "seconds": seconds, "line": line})
    errors = [k for k in line if k.endswith("_error")]
    check(not errors, f"the bench folded a phase's failure into {errors}")
    rates = ("value", "transformer_tokens_per_sec", "e2e_images_per_sec",
             "ingest_only_images_per_sec", "iter_only_images_per_sec")
    check(all(k in line for k in rates), f"the bench's line lacks a phase: {sorted(line)}")
    check(all(line[k] > 0 for k in rates), f"a bench rate is not above 0: {[line[k] for k in rates]}")
    check(0 < line["mfu"] < 1.0 and 0 < line["transformer_hw_mfu"] < 1.0,
          f"bench MFU out of (0, 1): {line['mfu']}, {line['transformer_hw_mfu']}")
    check(line["e2e_images"] == 4096 and line["e2e_rows_intact"] is True,
          f"the e2e worker saw {line['e2e_images']} images, not 4096 rows intact")
    check(line["e2e_worker_device"].startswith("cuda") and not line["e2e_worker_forbidden_modules"],
          f"e2e worker on {line['e2e_worker_device']} with {line['e2e_worker_forbidden_modules']}")
    check(line["e2e_put_get_bitwise"] is True and line["e2e_task_tensor_bitwise"] is True,
          "a CUDA tensor did not come back bitwise equal through the object store")
    check(all(math.isfinite(line[k]) for k in ("step_loss_last", "transformer_loss_last",
                                                "e2e_loss_last")), "a bench loss is not finite")
    launches = line["transformer_flash_launches"]
    for key in ("fwd_lse", "bwd_dq", "bwd_dkv"):
        check(launches[key] > 0, f"{key} was not launched in the bench's transformer phase")
    return launches


# ----------------------------------------------------------------- phase 9

def mesh_inputs(cfg, dev) -> tuple:
    """Phase 9's weights and batch, drawn in that order from SEED + 2 (the
    bare step, the sharded step and the trainer's worker all start here)."""
    from ray_tpu_torch.models import transformer as tr

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    model = tr.transformer_init(cfg, gen, device=dev)
    raw = torch.randint(0, cfg.vocab_size, (BATCH, SEQ + 1), device=dev, generator=gen)
    return model, {"tokens": raw[:, :-1].contiguous(), "targets": raw[:, 1:].contiguous()}


def mesh_step(cfg, dev, model):
    """make_train_step on make_mesh(_factor_axes(1)) (a world of one: NCCL
    on the card), with `model` placed on it: (state, step)."""
    from ray_tpu_torch.dryrun import _factor_axes
    from ray_tpu_torch.models import transformer as tr
    from ray_tpu_torch.parallel import make_mesh

    mesh = make_mesh(_factor_axes(1), device=dev)
    init_state, step = tr.make_train_step(cfg, mesh=mesh)
    return init_state(model=model), step


def sharded_phase(tr, fa, cfg, dev) -> dict:
    """9a: the sharded step at world 1 against the bare step on the same
    weights and batch, a warm-up and MESH_STEPS steps each, taken in turns
    (bare, sharded, sharded, bare, ...), each step timed with the card
    synchronised at its ends. Every loss and grad_norm within LOSS_BOUND of
    the bare run's, and the same launches of every kernel. Then two profiled
    steps of each (profile_phase): device time and idle share. Returns the
    launches of both runs' timed steps and the sharded run's losses."""
    model, batch = mesh_inputs(cfg, dev)
    twin = tr.Transformer(cfg, dev)
    twin.load_state_dict(model.state_dict())
    init_state, bare_step = tr.make_train_step(cfg, dev)
    runs = {"bare": (init_state(model=twin), bare_step), "sharded": mesh_step(cfg, dev, model)}
    resident = torch.cuda.memory_allocated(dev)
    out = {name: {"losses": [], "grad_norms": [], "ms": [], "peak_gib": 0.0,
                  "launches": {key: 0 for _, key, _ in KERNELS}} for name in runs}
    fa.reset_launches()
    for k in range(MESH_STEPS + 1):
        for name in (("bare", "sharded") if k % 2 else ("sharded", "bare")):
            state, step = runs[name]
            row = out[name]
            before = dict(fa.launches)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            _, m = step(state, batch)
            torch.cuda.synchronize()
            if k:  # step 0 is the warm-up
                row["ms"].append((time.perf_counter() - t0) * 1e3)
            row["peak_gib"] = max(row["peak_gib"], torch.cuda.max_memory_allocated(dev) / 2**30)
            row["losses"].append(float(m["loss"]))
            row["grad_norms"].append(float(m["grad_norm"]))
            for key in row["launches"]:
                row["launches"][key] += fa.launches[key] - before[key]
    launches = dict(fa.launches)
    bare, sharded = out["bare"], out["sharded"]
    diffs = {"loss": max(abs(a - b) for a, b in zip(sharded["losses"], bare["losses"])),
             "grad_norm": max(abs(a - b) for a, b in zip(sharded["grad_norms"], bare["grad_norms"]))}
    line = {"phase": "mesh", "part": "sharded_step", "mesh": "_factor_axes(1)", "batch": BATCH,
            "seq": SEQ, "steps": MESH_STEPS, "resident_gib": resident / 2**30,
            "max_diff_vs_bare": diffs, "loss_bound": LOSS_BOUND,
            **{name: {**row, "step_ms": sum(row["ms"]) / len(row["ms"])} for name, row in out.items()},
            "sharded_over_bare_ms": sum(sharded["ms"]) / sum(bare["ms"])}
    emit(line)
    check(all(math.isfinite(x) for x in sharded["losses"] + sharded["grad_norms"]),
          "a sharded loss or grad_norm is not finite")
    check(diffs["loss"] <= LOSS_BOUND and diffs["grad_norm"] <= LOSS_BOUND,
          f"the sharded step is off the bare step: {diffs}")
    check(sharded["launches"] == bare["launches"],
          f"the sharded step's launches differ from the bare step's: {sharded['launches']}, "
          f"{bare['launches']}")
    for key in ("fwd_lse", "bwd_dq", "bwd_dkv"):
        check(sharded["launches"][key] > 0, f"{key} was not launched by the sharded step")
    # The sharded step's cost split into the card's and the host's share.
    device_ms = {name: profile_phase(lambda run=runs[name]: run[1](run[0], batch),
                                     line[name]["step_ms"], phase=f"mesh_{name}_profile")
                 for name in runs}
    emit({"phase": "mesh", "part": "sharded_step_device", "device_ms": device_ms,
          "sharded_over_bare_device_ms": device_ms["sharded"] / device_ms["bare"]})
    return {"launches": launches, "losses": sharded["losses"]}


def ring_slack(fa, qf, kf, vf, shards: int, causal: bool, scale: float, lse):
    """sum over the hops of exp(lse_hop - lse) * |o_hop| for each output
    element: the magnitude of the bf16 hop outputs the ring merges, each
    rounded once before the merge (err_ratio's slack)."""
    from ray_tpu_torch.parallel.ring_attention import _hop_case

    c = qf.shape[1] // shards
    slack = torch.zeros(qf.shape, dtype=torch.float32, device=qf.device)
    for r in range(shards):
        rows = slice(r * c, (r + 1) * c)
        for src in range(shards):
            case = _hop_case(r, src, causal)
            if case == "skip":
                continue
            cols = slice(src * c, (src + 1) * c)
            o_h, lse_h = fa._flash_fwd_ref(qf[:, rows], kf[:, cols], vf[:, cols], case == "diag",
                                           scale, True)
            slack[:, rows] += torch.exp(lse_h - lse[:, rows])[..., None] * o_h.float().abs()
    return slack


def ring_host_checks(run, reps: int = 10) -> None:
    """The ring's forward and backward with no synchronising CUDA call in
    it (torch.cuda.set_sync_debug_mode("error") raises on one), then where
    its device time goes (profile_phase: flash kernels against the rest)
    and its idle share against its time on the host's clock, taken as the
    train steps' are: what the host costs it."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        run()
    except RuntimeError as exc:
        raise SmokeFailure(f"the ring synchronises with the card: {exc}") from None
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        run()
    torch.cuda.synchronize()
    profile_phase(run, (time.perf_counter() - t0) / reps * 1e3, phase="ring_profile")


def ring_phase(fa, dev, gen) -> dict:
    """9b: ring attention's kernel route in loopback, RING_SHAPE split into
    RING_SHARDS sequence shards, bf16 and f32, causal and not: the output
    and dq, dk, dv against the plain full attention (the kernels' plain
    versions on the whole sequence) under phase 2's limits, the launches
    per kernel (one per hop that is not skipped), and the ring's forward
    and backward device ms beside one full-sequence kernel call's; for
    bf16 causal, ring_host_checks. Then the kernels' times without the
    causal mask and at one hop's shape (template_times). Returns the
    ring's launches."""
    from ray_tpu_torch.parallel import ring_attention_loopback

    B, T, H, D = RING_SHAPE
    S, scale = RING_SHARDS, D ** -0.5
    launches = {key: 0 for _, key, _ in KERNELS}
    # the f32 hops' B2-B4 on the tensor cores and their split passes
    launches.update(fwd_lse_f32=0, bwd_dq_f32=0, bwd_dkv_f32=0, split_f32=0)

    def bhtd(x):
        return x.transpose(1, 2).reshape(B * H, T, D)

    for dtype in (torch.bfloat16, torch.float32):
        for causal in (True, False):
            q, k, v, do = (torch.randn(B, T, H, D, device=dev, generator=gen).to(dtype)
                           for _ in range(4))
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            fa.reset_launches()
            o = ring_attention_loopback(*leaves, S, causal=causal, impl="kernel")
            got = [o, *torch.autograd.grad(o, leaves, do)]
            torch.cuda.synchronize()
            hops = dict(fa.launches)
            for _, key, _ in KERNELS:
                launches[key] += hops[key]
            for key in ("fwd_lse", "bwd_dq", "bwd_dkv", "split"):
                launches[f"{key}_f32"] += fa.f32_launches[key]
            qf, kf, vf, dof = (bhtd(t) for t in (q, k, v, do))
            o_ref, lse = fa._flash_fwd_ref(qf, kf, vf, causal, scale, True)
            o_ring = bhtd(got[0].detach())
            # bf16: delta from the ring's rounded o, as gqa_case takes it.
            delta = (dof.float() * (o_ring if dtype == torch.bfloat16 else o_ref).float()).sum(-1)
            dq = fa._flash_bwd_dq_ref(qf, kf, vf, dof, lse, delta, causal, scale)
            dk, dv = fa._flash_bwd_dkv_ref(qf, kf, vf, dof, lse, delta, causal, scale)
            slack = ring_slack(fa, qf, kf, vf, S, causal, scale, lse) if dtype == torch.bfloat16 else None
            pairs = {"o": (o_ring, o_ref, slack)}
            for name, a, b in zip(("dq", "dk", "dv"), got[1:], (dq, dk, dv)):
                pairs[name] = (bhtd(a), b.to(dtype))
            errs = {n: max_err(p[0], p[1]) for n, p in pairs.items()}
            ratios = {n: err_ratio(*p) for n, p in pairs.items()}
            n_hops = S * (S + 1) // 2 if causal else S * S
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
            ring = lambda: torch.autograd.grad(  # noqa: E731
                ring_attention_loopback(*leaves, S, causal=causal, impl="kernel"), leaves, do)
            fl = [t.detach().requires_grad_(True) for t in (qf, kf, vf)]
            ring_ms = time_ms(ring, reps=RING_TIME_REPS)
            full_ms = time_ms(lambda: torch.autograd.grad(
                fa._FlashAttention.apply(*fl, causal, scale), fl, dof), reps=RING_TIME_REPS)
            case = {"dtype": str(dtype).split(".")[-1], "causal": causal, "shape": list(RING_SHAPE),
                    "shards": S, "hops": n_hops, "launches": hops, "max_abs_err": errs,
                    "err_to_limit": ratios, "ring_fwd_bwd_ms": ring_ms,
                    "full_kernel_fwd_bwd_ms": full_ms}
            emit({"phase": "mesh", "part": "ring_loopback", "case": case})
            check_ratios(ratios, {"ring": case})
            if dtype == torch.bfloat16 and causal:
                ring_host_checks(ring)
            check(all(hops[key] == n_hops for key in ("fwd_lse", "bwd_dq", "bwd_dkv"))
                  and hops["fwd"] == 0, f"the ring launched {hops}, not {n_hops} hops of each")
            del q, k, v, do, leaves, got, o, fl, qf, kf, vf, dof, o_ref, lse, dq, dk, dv, slack, pairs
    emit({"phase": "mesh", "part": "kernel_templates", **template_times(fa, dev, gen)})
    return launches


def template_times(fa, dev, gen) -> dict:
    """Each kernel (bf16) at the slice's full shape [B*H, T, D] without the
    causal mask, and at one ring hop's [B*H, T/RING_SHARDS, D] without it
    (a hop below the diagonal) and with it (the diagonal hop): ms, bound."""
    B, T, H, D = RING_SHAPE
    BH, scale = B * H, D ** -0.5
    out = {}
    for t, causal in ((T, False), (T // RING_SHARDS, False), (T // RING_SHARDS, True)):
        q, k, v, do = (torch.randn(BH, t, D, device=dev, generator=gen).to(torch.bfloat16)
                       for _ in range(4))
        o, lse = fa.flash_fwd(q, k, v, causal=causal, scale=scale, with_lse=True)
        delta = (do.float() * o.float()).sum(-1)
        fns = {
            "fwd": lambda: fa.flash_fwd(q, k, v, causal=causal, scale=scale),
            "fwd_lse": lambda: fa.flash_fwd(q, k, v, causal=causal, scale=scale, with_lse=True),
            "bwd_dq": lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, causal=causal, scale=scale),
            "bwd_dkv": lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal=causal, scale=scale),
        }
        pairs = BH * t * (t + 1) / 2 if causal else BH * t * t
        mat, elt = BH * t * D, 2
        work = {"fwd": (4 * D * pairs, 4 * mat * elt),
                "fwd_lse": (4 * D * pairs, 4 * mat * elt + BH * t * 4),
                "bwd_dq": (6 * D * pairs, 4 * mat * elt + 2 * BH * t * 4 + mat * 4),
                "bwd_dkv": (8 * D * pairs, 4 * mat * elt + 2 * BH * t * 4 + 2 * mat * 4)}
        rows = {}
        for key, fn in fns.items():
            least = bound(*work[key], pairs)
            ms = time_ms(fn)
            rows[key] = {"ms": ms, **least, "bound_share": least["bound_ms"] / ms}
        out[f"{'causal' if causal else 'noncausal'}_{BH}x{t}x{D}"] = rows
    return out


def mesh_trainer_loop(config) -> None:
    """The runtime worker's loop of 9c: the sharded step of 9a (its weights,
    batch and mesh, a world of one started in this worker) for
    MESH_TRAINER_STEPS steps, one report each, then the process group
    destroyed."""
    import torch.distributed as dist

    from ray_tpu_torch import train
    from ray_tpu_torch.train.torch import get_device

    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    dev = get_device()
    model, batch = mesh_inputs(config["cfg"], dev)
    state, step = mesh_step(config["cfg"], dev, model)
    world, backend = dist.get_world_size(), dist.get_backend()
    fa.reset_launches()
    try:
        for k in range(MESH_TRAINER_STEPS):
            _, m = step(state, batch)
            train.report({"step": k, "loss": float(m["loss"]), "device": str(dev),
                          "world": world, "backend": backend, "launches": dict(fa.launches)})
    finally:
        dist.destroy_process_group()


def mesh_trainer_phase(cfg, sharded_losses) -> dict:
    """9c: a one-worker GPU TorchTrainer running 9a's sharded step; its
    losses within LOSS_BOUND of 9a's first MESH_TRAINER_STEPS. Returns the
    worker's launches."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.air import RunConfig, ScalingConfig
    from ray_tpu_torch.train.torch import TorchTrainer

    storage = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_mesh")
    shutil.rmtree(storage, ignore_errors=True)
    t0 = time.time()
    rt.init(num_cpus=2)
    try:
        result = TorchTrainer(
            mesh_trainer_loop, train_loop_config={"cfg": cfg},
            scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
            run_config=RunConfig(name="mesh", storage_path=storage),
        ).fit()
    finally:
        rt.shutdown()
        shutil.rmtree(storage, ignore_errors=True)
    rows = result.metrics_history
    losses = [r["loss"] for r in rows]
    diffs = [abs(a - b) for a, b in zip(losses, sharded_losses)]
    emit({"phase": "mesh", "part": "trainer", "losses": losses,
          "sharded_losses": sharded_losses[:MESH_TRAINER_STEPS], "max_diff": max(diffs, default=None),
          "loss_bound": LOSS_BOUND, "device": rows[-1]["device"] if rows else None,
          "world": rows[-1]["world"] if rows else None,
          "backend": rows[-1]["backend"] if rows else None,
          "launches": rows[-1]["launches"] if rows else None, "fit_s": time.time() - t0})
    check(len(losses) == MESH_TRAINER_STEPS, f"the mesh trainer reported {len(losses)} steps")
    check(rows[-1]["device"].startswith("cuda") and rows[-1]["backend"] == "nccl"
          and rows[-1]["world"] == 1, f"the mesh trainer ran on {rows[-1]}")
    check(all(d <= LOSS_BOUND for d in diffs), f"the mesh trainer's losses are off 9a's: {diffs}")
    return rows[-1]["launches"]


def mesh_phase(tr, fa, cfg, dev, gen) -> dict:
    """Phase 9 (9a, 9b, 9c); destroys this process's group before it ends.
    Returns the kernels' launches in its paths."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    try:
        sharded = sharded_phase(tr, fa, cfg, dev)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    ring = ring_phase(fa, dev, gen)
    gc.collect()
    torch.cuda.empty_cache()
    worker = mesh_trainer_phase(cfg, sharded["losses"])
    launches = {key: sharded["launches"][key] + ring[key] + worker[key] for _, key, _ in KERNELS}
    launches.update({f"{key}_f32": ring[f"{key}_f32"] for key in ("fwd_lse", "bwd_dq", "bwd_dkv", "split")})
    emit({"phase": "mesh", "seconds": time.perf_counter() - t0, "launches": launches})
    return launches


# ---------------------------------------------------------------- phase 10

def dag_tensor(seed: int):
    """10c's payload: DAG_EDGE_ELEMS bf16 on this process's card, the same
    bits in every process on one card for one seed."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(DAG_EDGE_ELEMS, device="cuda", generator=gen).to(torch.bfloat16)


class GroupRank:
    """A GPU actor of phase 10: the NCCL group at world 1 and attention on
    it (10a, 10b), then one end of 10c's compiled DAG on a 2-rank gloo
    group. Returns what it measured; the checks run in the driver."""

    def __init__(self):
        import threading

        self.last = None
        self.profiling = False
        self.stop = threading.Event()

    def ready(self) -> str:
        return torch.cuda.get_device_name(torch.cuda.current_device())

    def collective_ops(self) -> dict:
        """10a: every op on the NCCL group and on a store group of one, bf16
        and f32, 16 MiB; the allreduce rates of both."""
        import numpy as np

        from ray_tpu_torch.util import collective as col

        dev = torch.device("cuda", torch.cuda.current_device())
        col.init_collective_group(1, 0, backend="nccl", group_name=NCCL_GROUP)
        col.init_collective_group(1, 0, backend="store", group_name=STORE_GROUP)
        gen = torch.Generator(device=dev).manual_seed(SEED + 10)
        equal, kinds = {}, set()
        for dtype in (torch.bfloat16, torch.float32):
            n = COLL_BYTES // torch.tensor([], dtype=dtype).element_size()
            x = torch.randn(n // 1024, 1024, device=dev, generator=gen).to(dtype)
            ops = {f"allreduce_{op}": functools.partial(col.allreduce, x, op=op)
                   for op in ("sum", "product", "min", "max")}
            ops.update({
                "allgather": lambda g: col.allgather(x, g)[0],
                "reducescatter": lambda g: col.reducescatter(x, g),
                "broadcast": lambda g: col.broadcast(x, 0, g),
                "send_recv": lambda g: (col.send(x, 0, g, tag=7), col.recv(0, g, tag=7))[1],
            })
            for name, fn in ops.items():
                got, want = fn(NCCL_GROUP), fn(STORE_GROUP)
                kinds.add((type(got).__name__, got.device.type, str(got.dtype)))
                equal[f"{name}_{str(dtype).split('.')[-1]}"] = bool(
                    got.dtype == dtype and torch.equal(got.float().cpu(),
                                                       torch.from_numpy(np.asarray(want)).float()))
            col.barrier(NCCL_GROUP)
            col.barrier(STORE_GROUP)
        x = torch.randn(COLL_BYTES // 4, device=dev, generator=gen)
        rates = {}
        for backend, group in (("nccl", NCCL_GROUP), ("store", STORE_GROUP)):
            col.allreduce(x, group)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(COLL_RATE_REPS[backend]):
                col.allreduce(x, group)
            torch.cuda.synchronize()
            rates[backend] = (COLL_BYTES / 2**20) * COLL_RATE_REPS[backend] / (time.perf_counter() - t0)
        col.destroy_collective_group(STORE_GROUP)
        return {"equal": equal, "kinds": sorted(kinds), "mb_per_s": rates,
                "mesh": str(col.get_group_mesh(NCCL_GROUP)),
                "backend": col.get_group_collectives(NCCL_GROUP).backend}

    def group_attention(self) -> dict:
        """10b: ring_attention_on_group and ulysses_attention_on_group on
        the NCCL group at RING_SHAPE, bf16 and f32, causal and not: output
        and dq, dk, dv against the kernels' plain versions on the whole
        sequence (errors and error-to-limit ratios), the launches of each
        checked run, and the fwd+bwd device ms of each against one
        full-sequence kernel call's. Then leaves the group."""
        from ray_tpu_torch.parallel import ring_attention_on_group, ulysses_attention_on_group
        from ray_tpu_torch.util import collective as col

        fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
        dev = torch.device("cuda", torch.cuda.current_device())
        gen = torch.Generator(device=dev).manual_seed(SEED + 11)
        B, T, H, D = RING_SHAPE
        scale = D ** -0.5
        launches = {key: 0 for _, key, _ in KERNELS}
        cases = []

        def bhtd(x):
            return x.transpose(1, 2).reshape(B * H, T, D)

        fns = {"ring": ring_attention_on_group, "ulysses": ulysses_attention_on_group}
        for dtype in (torch.bfloat16, torch.float32):
            for causal in (True, False):
                q, k, v, do = (torch.randn(B, T, H, D, device=dev, generator=gen).to(dtype)
                               for _ in range(4))
                qf, kf, vf, dof = (bhtd(t) for t in (q, k, v, do))
                o_ref, lse = fa._flash_fwd_ref(qf, kf, vf, causal, scale, True)
                fl = [t.detach().requires_grad_(True) for t in (qf, kf, vf)]
                full_ms = time_ms(lambda: torch.autograd.grad(
                    fa._FlashAttention.apply(*fl, causal, scale), fl, dof), reps=RING_TIME_REPS)
                for name, f in fns.items():
                    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
                    fa.reset_launches()
                    o = f(*leaves, causal=causal, group_name=NCCL_GROUP)
                    got = [o, *torch.autograd.grad(o, leaves, do)]
                    torch.cuda.synchronize()
                    run = dict(fa.launches)
                    for key in launches:
                        launches[key] += run[key]
                    o_got = bhtd(got[0].detach())
                    # bf16: delta from the kernel's rounded o, as its backward takes it.
                    delta = (dof.float() * (o_got if dtype == torch.bfloat16 else o_ref).float()).sum(-1)
                    dq = fa._flash_bwd_dq_ref(qf, kf, vf, dof, lse, delta, causal, scale)
                    dk, dv = fa._flash_bwd_dkv_ref(qf, kf, vf, dof, lse, delta, causal, scale)
                    pairs = {"o": (o_got, o_ref.to(dtype))}
                    for key, a, b in zip(("dq", "dk", "dv"), got[1:], (dq, dk, dv)):
                        pairs[key] = (bhtd(a), b.to(dtype))
                    errs, ratios = compare({key: [p] for key, p in pairs.items()})
                    timed = [t.detach().requires_grad_(True) for t in (q, k, v)]
                    group_ms = time_ms(lambda: torch.autograd.grad(
                        f(*timed, causal=causal, group_name=NCCL_GROUP), timed, do),
                        reps=RING_TIME_REPS)
                    cases.append({"fn": name, "dtype": str(dtype).split(".")[-1], "causal": causal,
                                  "shape": list(RING_SHAPE), "launches": run, "max_abs_err": errs,
                                  "err_to_limit": ratios, "group_fwd_bwd_ms": group_ms,
                                  "full_kernel_fwd_bwd_ms": full_ms})
                    del leaves, got, o, o_got, dq, dk, dv, pairs, timed
                del q, k, v, do, qf, kf, vf, dof, o_ref, lse, fl
        col.destroy_collective_group(NCCL_GROUP)
        return {"cases": cases, "launches": launches}

    # -- 10c ---------------------------------------------------------------

    def join(self, rank: int) -> None:
        from ray_tpu_torch.util import collective as col

        col.init_collective_group(2, rank, backend="gloo", group_name=DAG_GROUP)

    def make(self, seed: int):
        return dag_tensor(seed)

    def take(self, x) -> tuple:
        self.last = x
        return x.device.type, str(x.dtype), tuple(x.shape)

    def bitwise_equal(self, seed: int) -> bool:
        return torch.equal(self.last.view(torch.int16), dag_tensor(seed).view(torch.int16))

    def routes(self) -> dict:
        from ray_tpu_torch.dag import tensor_channel

        return dict(tensor_channel.routes)

    def profile(self) -> dict:
        """Profile this process (the card's activity, whichever thread
        queues it) until stop_profile; the count of each memcpy kind."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            self.profiling = True
            self.stop.wait(120)
            torch.cuda.synchronize()
        self.profiling = False
        kinds = {}
        for e in prof.events():
            if e.name.startswith("Memcpy"):
                kinds[e.name] = kinds.get(e.name, 0) + 1
        return kinds

    def is_profiling(self) -> bool:
        return self.profiling

    def stop_profile(self) -> None:
        self.stop.set()


def gcs_collective_telemetry(groups, timeout: float = 20.0) -> dict:
    """{family: {group: (kind, allreduce observations, allreduce bytes)}} of
    the collective families in the GCS's telemetry aggregate, where a
    process flushes its deltas every telemetry_flush_interval_s; polled
    until each group of `groups` has its allreduces in both families."""
    from ray_tpu_torch._private import worker as worker_mod

    deadline = time.monotonic() + timeout
    while True:
        agg = worker_mod.global_worker.run_async(
            worker_mod._core().gcs.call("GetTelemetry", {}))["telemetry"]
        out = {}
        for fam, table in (("op_latency_s", "hists"), ("bytes", "counters")):
            kind = agg["meta"].get(f"collective.{fam}", {}).get("kind")
            rows = out.setdefault(fam, {})
            for skey, v in agg[table].get(f"collective.{fam}", {}).items():
                labels = dict(json.loads(skey.split("|", 1)[1]))
                if labels["op"] == "allreduce":
                    _, n, b = rows.get(labels["group"], (kind, 0, 0.0))
                    rows[labels["group"]] = (kind, n + (v["total"] if fam == "op_latency_s" else 0),
                                             b + (v if fam == "bytes" else 0.0))
        if all(g in out[fam] for g in groups for fam in out) or time.monotonic() > deadline:
            return out
        time.sleep(0.5)


def dag_rate(compiled, reps: int) -> float:
    """Executes per second of a warm compiled graph, each one read back."""
    compiled.execute(0).get(timeout=60)
    t0 = time.perf_counter()
    for i in range(reps):
        compiled.execute(100 + i).get(timeout=60)
    return reps / (time.perf_counter() - t0)


def dag_phase(rt, producer, consumer) -> dict:
    """10c: the producer's bf16 CUDA tensor to the consumer over a device
    edge of a compiled DAG on a 2-rank gloo group (two actors on one card),
    with the producer profiled; then the edge's rate against the same
    graph on a "tensor" (shm) edge. Returns what the checks read."""
    from ray_tpu_torch import dag

    rt.get([producer.join.remote(0), consumer.join.remote(1)], timeout=120)

    def compiled(transport: str):
        with dag.InputNode() as inp:
            made = producer.make.bind(inp)
            if transport == "device":
                made = made.with_tensor_transport("device", group_name=DAG_GROUP, src=0, dst=1)
            else:
                made = made.with_tensor_transport("tensor")
            graph = consumer.take.bind(made)
        return graph.experimental_compile(max_buf_size=2 * DAG_EDGE_ELEMS + (1 << 20))

    out = {}
    graph = compiled("device")
    loops = graph._loop_refs
    try:
        profiled = producer.profile.remote()
        deadline = time.monotonic() + 60
        while not rt.get(producer.is_profiling.remote(), timeout=30):
            check(time.monotonic() < deadline, "the producer's profiler did not start")
            time.sleep(0.1)
        out["received"], out["bitwise"] = [], []
        for seed in DAG_SEEDS:
            out["received"].append(graph.execute(seed).get(timeout=60))
            out["bitwise"].append(rt.get(consumer.bitwise_equal.remote(seed), timeout=60))
        rt.get(producer.stop_profile.remote(), timeout=30)
        out["producer_memcpy"] = rt.get(profiled, timeout=180)
        out["device_per_s"] = dag_rate(graph, DAG_RATE_REPS)
    finally:
        graph.teardown()
    # Each loop returns its count of executes once STOP has crossed its
    # input channel: the consumer's is the device edge.
    out["loop_iterations"] = rt.get(loops, timeout=60)
    out["routes"] = rt.get([producer.routes.remote(), consumer.routes.remote()], timeout=30)
    graph = compiled("tensor")
    try:
        out["shm_per_s"] = dag_rate(graph, DAG_RATE_REPS)
    finally:
        graph.teardown()
    return out


def collective_phase() -> dict:
    """Phase 10 (10a, 10b, 10c) in two GPU actors sharing the card (GPU 0.5
    each). Returns 10b's launches."""
    import ray_tpu_torch as rt

    t0 = time.perf_counter()
    rt.init(num_cpus=4)
    try:
        gpus = rt.cluster_resources().get("GPU")
        actor = rt.remote(num_gpus=0.5, max_concurrency=4)(GroupRank)
        producer, consumer = actor.remote(), actor.remote()
        names = rt.get([producer.ready.remote(), consumer.ready.remote()], timeout=180)
        free = rt.available_resources().get("GPU", 0.0)
        emit({"phase": "collective", "part": "actors", "gpu": gpus, "gpu_free_with_both": free,
              "cards": names, "start_s": time.perf_counter() - t0})
        check(gpus == torch.cuda.device_count() and free == gpus - 1.0,
              f"two actors of GPU 0.5 left {free} of {gpus} GPU free")
        ops = rt.get(producer.collective_ops.remote(), timeout=180)
        ops["telemetry"] = gcs_collective_telemetry((NCCL_GROUP, STORE_GROUP))
        emit({"phase": "collective", "part": "ops", **ops})
        check(ops["backend"] == "nccl", f"the group runs on {ops['backend']}")
        check(all(ops["equal"].values()), f"the NCCL group's ops differ from the store's: {ops['equal']}")
        check(all(tuple(kind[:2]) == ("Tensor", "cuda") for kind in ops["kinds"]),
              f"the NCCL group returned {ops['kinds']}")
        for fam, kind in (("op_latency_s", "histogram"), ("bytes", "counter")):
            rows = ops["telemetry"][fam]
            check(all(g in rows and rows[g][0] == kind for g in (NCCL_GROUP, STORE_GROUP)),
                  f"collective/{fam} in the GCS: {rows}")
        attn = rt.get(producer.group_attention.remote(), timeout=600)
        for case in attn["cases"]:
            emit({"phase": "collective", "part": "attention", "case": case})
            check_ratios(case["err_to_limit"], {"group_attention": case})
            check(all(case["launches"][key] == 1 for key in ("fwd_lse", "bwd_dq", "bwd_dkv"))
                  and case["launches"]["fwd"] == 0,
                  f"{case['fn']} on the group launched {case['launches']}, not one of each")
        t1 = time.perf_counter()
        edge = dag_phase(rt, producer, consumer)
        emit({"phase": "collective", "part": "dag", "seconds": time.perf_counter() - t1, **edge,
              "dag_channel_tensor_per_s": edge["device_per_s"],
              "dag_channel_tensor_shm_per_s": edge["shm_per_s"]})
        n = len(DAG_SEEDS)
        check(edge["received"] == [("cuda", "torch.bfloat16", (DAG_EDGE_ELEMS,))] * n,
              f"the consumer received {edge['received']}")
        check(all(edge["bitwise"]), f"the device edge changed the tensor: {edge['bitwise']}")
        check(edge["routes"][0].get("ipc", 0) >= n and edge["routes"][1].get("ipc", 0) >= n,
              f"the device edge did not go by CUDA IPC: {edge['routes']}")
        kinds = edge["producer_memcpy"]
        check(any("DtoD" in k for k in kinds), f"the producer's profile shows no device copy: {kinds}")
        check(not any("DtoH" in k for k in kinds), f"the producer copied to the host: {kinds}")
        check(edge["loop_iterations"] == [n + 1 + DAG_RATE_REPS] * 2,
              f"the loops ended after {edge['loop_iterations']} executes")
    finally:
        rt.shutdown()
    emit({"phase": "collective", "seconds": time.perf_counter() - t0,
          "collective_allreduce_mb_per_s": ops["mb_per_s"]["nccl"],
          "collective_allreduce_store_mb_per_s": ops["mb_per_s"]["store"],
          "dag_channel_tensor_per_s": edge["device_per_s"],
          "dag_channel_tensor_shm_per_s": edge["shm_per_s"], "launches": attn["launches"]})
    return attn["launches"]


# ---------------------------------------------------------------- phase 11

def rl_tree_err(got, want) -> tuple:
    """(max abs difference, worst leaf's relative L2 difference) between two
    numpy trees of one structure."""
    import numpy as np

    if isinstance(want, dict):
        pairs = [rl_tree_err(got[k], want[k]) for k in want]
    elif isinstance(want, (list, tuple)):
        pairs = [rl_tree_err(g, w) for g, w in zip(got, want)]
    else:
        g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
        d = float(np.abs(g - w).max()) if g.size else 0.0
        return d, float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))
    return max(p[0] for p in pairs), max(p[1] for p in pairs)


def rl_metric_err(got: dict, want: dict) -> float:
    """Worst |got - want| / max(1, |want|) over want's metrics."""
    return max(abs(got[k] - v) / max(1.0, abs(v)) for k, v in want.items())


def rl_inputs(name, learner, batch, noise):
    """The case's batch on the learner's device with what its update adds:
    the target net (DQN, CQL, SAC), SAC's noise (`noise`, numpy, the same on
    both devices) and MARWIL's moving average."""
    import numpy as np

    b = learner.to_device(batch)
    if hasattr(learner, "target_params"):
        b["_target_params"] = learner.target_params
    if name == "sac":
        b["_eps_next"], b["_eps_pi"] = (torch.from_numpy(x).to(learner.device) for x in noise)
    if name == "marwil":
        b["_ma_sq_adv"] = torch.tensor(np.float32(learner.ma_sq_adv), device=learner.device)
    return b


def rl_learner_parity() -> dict:
    """11a: every learner on cuda (TF32 off) against the same learner on the
    CPU in f64, same seed, weights and batch: loss, metrics and gradients of
    one backward, then RL_UPDATES update_from_batch steps (metrics and every
    parameter after each). Returns {case: errors}."""
    import numpy as np

    from ray_tpu_torch.rllib.core.rl_module import RLModuleSpec, tree_of
    from ray_tpu_torch.testing import rl_learner_cases

    def f64(arrays):
        return {k: v.astype(np.float64) if v.dtype.kind == "f" else v
                for k, v in ((k, np.asarray(v)) for k, v in arrays.items())}

    out = {}
    cases = rl_learner_cases(seed=SEED, n=RL_CHECK_ROWS, T=RL_FRAGMENT, envs=RL_ENVS,
                             hidden=RL_HIDDEN, sac_hidden=RL_SAC_HIDDEN)
    for name, case in cases.items():
        cls = getattr(importlib.import_module(f"ray_tpu_torch.rllib.algorithms.{case['module']}"),
                      case["cls"])
        args = (case["cfg"],) if case["cfg"] is not None else ()
        # The spec's dtype casts the module's f32 draws, so both start equal.
        pair = [cls(RLModuleSpec(**case["spec"], dtype=dtype), *args, lr=RL_CHECK_LR, seed=SEED,
                    device=d) for d, dtype in (("cuda", torch.float32), ("cpu", torch.float64))]
        gpu, cpu = pair
        check(all(p.is_cuda for p in gpu.module.parameters()), f"{name}'s learner is not on cuda")
        check(all(p.dtype == torch.float64 for p in cpu.module.parameters()),
              f"{name}'s CPU learner is not in f64")
        start = rl_tree_err(gpu.get_weights(), cpu.get_weights())
        rng = np.random.RandomState(SEED)
        n, act_dim = len(case["batch"]["obs"]), case["spec"].get("act_dim", 0)
        noise = [rng.randn(n, max(act_dim, 1)).astype(np.float32) for _ in range(2)]
        batches = [case["batch"], f64(case["batch"])]
        noises = [noise, [x.astype(np.float64) for x in noise]]
        t0 = time.perf_counter()
        metrics = [learner._to_host(learner._backward(rl_inputs(name, learner, b, z)))
                   for learner, b, z in zip(pair, batches, noises)]
        grads = rl_tree_err(*(tree_of(l.module, lambda p: p.grad) for l in pair))
        row = {"init_max_abs": start[0], "metric_err": rl_metric_err(*metrics),
               "loss": [metrics[0]["total_loss"], metrics[1]["total_loss"]],
               "grad_max_abs": grads[0], "grad_rel_l2": grads[1], "update_metric_err": [],
               "update_max_abs": []}
        for _ in range(RL_UPDATES):
            m = [learner.update_from_batch(b) for learner, b in zip(pair, batches)]
            row["update_metric_err"].append(rl_metric_err(*m))
            row["update_max_abs"].append(rl_tree_err(gpu.get_weights(), cpu.get_weights())[0])
        row["seconds"] = time.perf_counter() - t0
        out[name] = row
        emit({"phase": "rllib", "part": "learner", "case": name, **row})
        check(start[0] == 0.0, f"{name}: the cuda and CPU learners start from other weights")
        check(row["metric_err"] <= RL_METRIC_TOL and grads[1] <= RL_GRAD_REL,
              f"{name}'s loss, metrics or gradients on cuda are off the CPU's: {row}")
        check(max(row["update_metric_err"]) <= RL_METRIC_TOL
              and max(row["update_max_abs"]) <= RL_UPDATE_ATOL,
              f"{name}'s updates on cuda are off the CPU's: {row}")
    return out


def rl_timed(obj, attr: str, log: list) -> None:
    """Wrap obj.attr so each call's host seconds go to `log`."""
    fn = getattr(obj, attr)

    @functools.wraps(fn)
    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            log.append(time.perf_counter() - t0)

    setattr(obj, attr, timed)


def rl_ppo_config(device=None):
    from ray_tpu_torch.rllib import PPOConfig
    from ray_tpu_torch.testing import cartpole_env

    return (PPOConfig().environment(cartpole_env)
            .env_runners(num_env_runners=RL_RUNNERS, num_envs_per_env_runner=RL_ENVS // RL_RUNNERS)
            .training(**RL_PPO).learners(device=device).debugging(seed=SEED))


def rl_learn_cartpole(rt) -> tuple:
    """11b: PPO learns CartPole with two CPU runner actors and its learner
    on cuda, until RL_THRESHOLD or RL_MAX_ITERS; then one more iteration
    under the profiler for the learner's device time. Returns the
    algorithm and the phase's numbers."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    algo = rl_ppo_config().build_algo()
    start_s = time.perf_counter() - t0
    sample_s, learn_s = [], []
    rl_timed(algo.env_runner_group, "sample", sample_s)
    rl_timed(algo.learner_group, "update_from_batch", learn_s)
    iters, returns = [], []
    t1 = time.perf_counter()
    while len(iters) < RL_MAX_ITERS:
        n_s, n_l = len(sample_s), len(learn_s)
        result = algo.train()
        iters.append({"return_mean": result["episode_return_mean"],
                      "seconds": result["time_this_iter_s"], "sample_s": sum(sample_s[n_s:]),
                      "learn_s": sum(learn_s[n_l:]), "updates": len(learn_s) - n_l})
        returns.append(result["episode_return_mean"])
        if result["episode_return_mean"] >= RL_THRESHOLD:
            break
    train_s = time.perf_counter() - t1
    env_steps = result["num_env_steps_sampled_lifetime"]
    last = iters[-1]
    n_l = len(learn_s)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        algo.train()
        torch.cuda.synchronize()
    device = [e for e in prof.events()
              if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    device_ms = sum(e.time_range.elapsed_us() / 1e3 for e in device)
    profiled_updates = len(learn_s) - n_l
    by_name = {}
    for e in device:
        by_name[e.name[:60]] = by_name.get(e.name[:60], 0) + 1
    infos = rt.get([a.process_info.remote() for a in algo.env_runner_group._manager.actors],
                   timeout=60)
    module = algo.learner_group._local.module
    numbers = {
        "iterations": len(iters), "reached": returns[-1] >= RL_THRESHOLD,
        "return_mean_last": returns[-1], "returns": returns,
        "env_steps": env_steps, "env_steps_per_s": env_steps / train_s,
        "sample_env_steps_per_s": env_steps / sum(i["sample_s"] for i in iters),
        "build_s": start_s, "train_s": train_s,
        "update_ms_host": 1e3 * last["learn_s"] / last["updates"],
        "updates_per_iteration": last["updates"],
        "iteration_split_s": [[i["sample_s"], i["learn_s"]] for i in iters],
        "device_ms_per_update": device_ms / profiled_updates,
        "device_launches_per_update": len(device) / profiled_updates,
        "launches_per_update_by_name": sorted(
            ([name, n / profiled_updates] for name, n in by_name.items()),
            key=lambda x: -x[1])[:15],
        "learner_idle_share": 1 - device_ms / (1e3 * last["learn_s"]),
        "learner_device": str(next(module.parameters()).device),
        "runner_processes": infos,
    }
    emit({"phase": "rllib", "part": "ppo_cartpole", **numbers})
    check(numbers["reached"], f"PPO did not reach {RL_THRESHOLD} on CartPole in "
                              f"{RL_MAX_ITERS} iterations: {returns}")
    check(all(p.is_cuda for p in module.parameters()), "the PPO learner's params are not on cuda")
    check(all(not i["cuda_initialized"] and not i["forbidden_modules"] for i in infos),
          f"a runner process made a CUDA context or holds jax/ray_tpu: {infos}")
    return algo, numbers


def rl_checkpoint(algo, storage: str) -> dict:
    """11d: 11b's algorithm saved from the card, restored into a fresh
    algorithm whose learner is on the CPU: weights and Adam's state equal,
    then one update of each on one batch within 11a's bound."""
    from ray_tpu_torch.testing import rl_batch
    import numpy as np

    path = algo.save(os.path.join(storage, "rllib_ckpt"))
    fresh = rl_ppo_config(device="cpu").env_runners(num_env_runners=0).build_algo()
    try:
        fresh.restore(path)
        card, host = algo.learner_group._local, fresh.learner_group._local
        a, b = card.get_state(), host.get_state()
        weights = rl_tree_err(b["params"], a["params"])[0]
        adam = rl_tree_err(b["opt_state"], a["opt_state"])[0]
        batch = rl_batch("ppo", np.random.RandomState(SEED + 11), n=RL_PPO["minibatch_size"],
                         obs_dim=4)
        m = [learner.update_from_batch(batch) for learner in (card, host)]
        after = rl_tree_err(host.get_weights(), card.get_weights())[0]
        out = {"learner_devices": [str(card.device), str(host.device)],
               "weights_max_abs": weights, "adam_state_max_abs": adam,
               "steps": [a["opt_state"]["step"], b["opt_state"]["step"]],
               "iteration": fresh.iteration, "update_metric_err": rl_metric_err(*m),
               "update_max_abs": after}
    finally:
        fresh.stop()
    emit({"phase": "rllib", "part": "checkpoint", **out})
    check(out["learner_devices"][0].startswith("cuda") and out["learner_devices"][1] == "cpu",
          f"11d's learners are on {out['learner_devices']}")
    check(weights == 0.0 and adam <= RL_STATE_ATOL and out["steps"][0] == out["steps"][1],
          f"the checkpoint did not restore on the CPU: {out}")
    check(out["update_metric_err"] <= RL_METRIC_TOL and after <= RL_UPDATE_ATOL,
          f"the restored CPU learner's update is off the card's: {out}")
    return out


def rl_learner_group(rt) -> dict:
    """11c: two learner actors sharing the card (GPU 0.5 each) take one
    averaged PPO update: bitwise in sync, and within 11a's bound of a local
    cuda learner that applied the mean of their gradients."""
    import numpy as np

    from ray_tpu_torch.rllib import LearnerGroup, RLModuleSpec
    from ray_tpu_torch.rllib.algorithms.ppo import PPOLearner
    from ray_tpu_torch.rllib.core.learner_group import _mean_tree, _shard_batch
    from ray_tpu_torch.testing import PPO_LOSS, rl_batch

    spec = RLModuleSpec(obs_dim=4, num_actions=2, hidden=RL_HIDDEN)
    lr, clip = RL_PPO["lr"], 0.5

    def build(device):
        return PPOLearner(spec, PPO_LOSS, lr=lr, grad_clip=clip, seed=SEED, device=device)

    batch = rl_batch("ppo", np.random.RandomState(SEED + 12), n=2 * RL_PPO["minibatch_size"],
                     obs_dim=4)
    t0 = time.perf_counter()
    group = LearnerGroup(build, num_learners=2, num_gpus_per_learner=0.5)
    try:
        actors = group._manager.actors
        devices = rt.get([a.get_device.remote() for a in actors], timeout=180)
        start_s = time.perf_counter() - t0
        metrics = group.update_from_batch(batch)
        w = rt.get([a.get_weights.remote() for a in actors], timeout=60)
    finally:
        group.shutdown()
    local = build("cuda")
    local.apply_gradients(_mean_tree([local.compute_gradients(shard)[0]
                                      for shard in _shard_batch(batch, 2)]))
    out = {"devices": devices, "start_s": start_s, "total_loss": metrics["total_loss"],
           "actors_max_abs": rl_tree_err(w[1], w[0])[0],
           "vs_local_max_abs": rl_tree_err(w[0], local.get_weights())[0]}
    emit({"phase": "rllib", "part": "learner_group", **out})
    check(all(d.startswith("cuda") for d in devices), f"the learner actors are on {devices}")
    check(out["actors_max_abs"] == 0.0, f"the two learner actors differ: {out}")
    check(out["vs_local_max_abs"] <= RL_UPDATE_ATOL,
          f"the averaged update is off a local learner's on the mean gradients: {out}")
    return out


def rllib_phase(fa) -> dict:
    """Phase 11 (11a-d). Returns the flash launches it made (none: RLlib's
    modules are MLPs)."""
    import tempfile

    import ray_tpu_torch as rt

    t0 = time.perf_counter()
    before = dict(fa.launches)
    parity = rl_learner_parity()
    storage = tempfile.mkdtemp(prefix="ray_tpu_torch_smoke_rl_")
    rt.init(num_cpus=4)
    try:
        algo, learn = rl_learn_cartpole(rt)
        try:
            ckpt = rl_checkpoint(algo, storage)
        finally:
            algo.stop()
        group = rl_learner_group(rt)
    finally:
        rt.shutdown()
        shutil.rmtree(storage, ignore_errors=True)
    launches = {k: fa.launches[k] - before[k] for k in before}
    worst = {"metric_err": max(max(r["metric_err"], *r["update_metric_err"])
                               for r in parity.values()),
             "grad_rel_l2": max(r["grad_rel_l2"] for r in parity.values()),
             "update_max_abs": max(max(r["update_max_abs"]) for r in parity.values())}
    emit({"phase": "rllib", "seconds": time.perf_counter() - t0, "learner_worst": worst,
          "iterations_to_threshold": learn["iterations"],
          "env_steps_per_s": learn["env_steps_per_s"],
          "update_ms_host": learn["update_ms_host"],
          "device_ms_per_update": learn["device_ms_per_update"],
          "learner_idle_share": learn["learner_idle_share"],
          "group_in_sync": group["actors_max_abs"] == 0.0,
          "checkpoint_weights_equal": ckpt["weights_max_abs"] == 0.0, "launches": launches})
    check(not any(launches.values()), f"RLlib launched flash kernels: {launches}")
    return launches


# ---------------------------------------------------------------- phase 12

def serving_config(tr):
    """Phase 12's model: GPT2_SMALL for inference (no remat)."""
    return tr.TransformerConfig(**{**GPT2_SMALL, "remat": False})


def serve_prompts(n: int, seed: int, vocab: int) -> list:
    """n prompts of int32 token ids, their lengths drawn in SERVE_PROMPT_LENS."""
    import numpy as np

    rng = np.random.RandomState(seed)
    lo, hi = SERVE_PROMPT_LENS
    return [rng.randint(0, vocab, rng.randint(lo, hi + 1)).astype(np.int32) for _ in range(n)]


def serve_batch(tr, model, prompts, dev) -> tuple:
    """What a replica computes for a batch: the prompts right-padded to the
    longest, transformer_apply under inference_mode, and for each prompt the
    f32 log-probs at its last real position (causal: padding never reaches
    it) and the greedy token. Returns (log-probs [n, V] numpy, tokens)."""
    lengths = [len(p) for p in prompts]
    tokens = torch.zeros((len(prompts), max(lengths)), dtype=torch.long)
    for i, p in enumerate(prompts):
        tokens[i, :len(p)] = torch.from_numpy(p)
    with torch.inference_mode():
        logits = tr.transformer_apply(model, tokens.to(dev))
        last = logits[torch.arange(len(prompts), device=dev),
                      torch.tensor(lengths, device=dev) - 1]
        logp = torch.log_softmax(last.float(), dim=-1)
        return logp.cpu().numpy(), logp.argmax(dim=-1).cpu().tolist()


def batch_times(tr, model, prompts, dev, reps: int = 3) -> dict:
    """One batch's time on the host's clock (mean of `reps` unprofiled runs,
    synchronised at the ends), its device time and launches (one profiled
    run: kernels and copies), and the idle share, 1 - device / host."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    serve_batch(tr, model, prompts, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        serve_batch(tr, model, prompts, dev)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / reps * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        serve_batch(tr, model, prompts, dev)
        torch.cuda.synchronize()
    device = [e for e in prof.events()
              if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    device_ms = sum(e.time_range.elapsed_us() / 1e3 for e in device)
    return {"batch": len(prompts), "padded_to": max(len(p) for p in prompts), "host_ms": host_ms,
            "device_ms": device_ms, "device_launches": len(device),
            "idle_share": 1 - device_ms / host_ms}


class GPT2Server:
    """Phase 12's deployment: GPT-2 small on this replica's card, weights
    from `seed`. A call gets a batch (the replica's continuous batching,
    max_batch_size SERVE_MAX_BATCH) of prompts, each an int32 array or an
    HTTP request whose body is one, and answers each with its last
    position's f32 log-probs and greedy token (bytes for HTTP: the log-probs
    then the token, little-endian). One batch runs on the card at a time,
    so each batch's flash launches are read exactly."""

    def __init__(self, seed: int):
        import collections
        import threading

        from ray_tpu_torch.models import transformer as tr

        if not torch.cuda.is_available():
            raise RuntimeError("a GPT2Server replica needs a CUDA card")
        self.tr = tr
        self.fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
        self.dev = torch.device("cuda", torch.cuda.current_device())
        gen = torch.Generator(device=self.dev).manual_seed(seed)
        self.model = tr.transformer_init(serving_config(tr), gen, device=self.dev)
        self.lock = threading.Lock()
        self.sizes = collections.Counter()
        self.launches = []  # per batch: {kernel key: launches}

    def __call__(self, batch):
        import numpy as np

        prompts = [np.frombuffer(x.body, dtype=np.int32).copy() if hasattr(x, "body") else x
                   for x in batch]
        with self.lock:
            before = dict(self.fa.launches)
            logp, greedy = serve_batch(self.tr, self.model, prompts, self.dev)
            self.launches.append({k: self.fa.launches[k] - before[k] for k in before})
            self.sizes[len(batch)] += 1
        return [row.tobytes() + np.int32(g).tobytes() if hasattr(x, "body") else (row, g)
                for x, row, g in zip(batch, logp, greedy)]

    def stats(self) -> dict:
        return {"device": str(self.dev), "device_name": torch.cuda.get_device_name(self.dev),
                "pid": os.getpid(), "sizes": dict(sorted(self.sizes.items())),
                "launches": self.launches, "forbidden_modules": forbidden_modules()}

    def profile_batch(self, prompts) -> dict:
        with self.lock:
            return batch_times(self.tr, self.model, prompts, self.dev)


def mux_server_class(serve):
    """12d's deployment: one replica holding at most one GPT-2 small model,
    loaded by @serve.multiplexed from the request's model id (a seed).
    Each answer carries the card's allocated bytes after the request."""

    class MuxServer:
        def __init__(self):
            from ray_tpu_torch.models import transformer as tr

            if not torch.cuda.is_available():
                raise RuntimeError("a MuxServer replica needs a CUDA card")
            self.tr = tr
            self.dev = torch.device("cuda", torch.cuda.current_device())
            self.base = torch.cuda.memory_allocated(self.dev)
            self.loads = []

        @serve.multiplexed(max_num_models_per_replica=1)
        async def get_model(self, model_id: str):
            self.loads.append(model_id)
            gen = torch.Generator(device=self.dev).manual_seed(int(model_id))
            return self.tr.transformer_init(serving_config(self.tr), gen, device=self.dev)

        async def __call__(self, prompt):
            torch.cuda.reset_peak_memory_stats(self.dev)
            model = await self.get_model(serve.get_multiplexed_model_id())
            logp, greedy = serve_batch(self.tr, model, [prompt], self.dev)
            del model
            return {"logp": logp[0], "greedy": greedy[0], "loads": list(self.loads),
                    "allocated": torch.cuda.memory_allocated(self.dev) - self.base,
                    "peak": torch.cuda.max_memory_allocated(self.dev) - self.base}

    return MuxServer


class PromptRouter:
    """The router loadgen drives, handing each request the next of the
    seeded prompts in turn (loadgen sends one payload for all), and counting
    the prompt tokens of the requests that were answered."""

    def __init__(self, router, prompts):
        self.router, self.prompts = router, prompts
        self.sent = 0
        self.answered_tokens = 0

    async def assign_request(self, dep, meta, args, kwargs, timeout_s=None):
        prompt = self.prompts[self.sent % len(self.prompts)]
        self.sent += 1
        out = await self.router.assign_request(dep, meta, (prompt,), kwargs, timeout_s=timeout_s)
        self.answered_tokens += len(prompt)
        return out


def replica_actors(rt, worker_mod, app: str) -> list:
    """The replica actors of an application, by their registered names."""
    reply = worker_mod.global_worker.run_async(
        worker_mod._core().gcs.call("ListNamedActors", {"namespace": "serve"}))
    names = sorted(n for n in reply.get("names", []) if n.startswith(f"SERVE_REPLICA::{app}#"))
    return [rt.get_actor(n, namespace="serve") for n in names]


def call_replica(rt, actor, method: str, timeout: float = 300, **kwargs):
    """A user method of a replica, called on that replica (keyword
    arguments: never batched)."""
    return rt.get(actor.handle_request.remote({"call_method": method}, (), kwargs),
                  timeout=timeout)


def served_vs_f32(tr, model, prompts, served, dev) -> dict:
    """12a's rule, phase 3's: each prompt alone through the same weights on
    the plain path in f32 (TF32 off, the truth) and in bf16; the served
    log-probs no further from f32 than bf16's, mean and max abs error over
    all prompts within LOGITS_MEAN_RATIO and LOGITS_MAX_RATIO. The greedy
    token must be f32's wherever f32's top-2 margin is above
    GREEDY_MARGIN_RATIO times the bf16 plain path's max abs error on that
    prompt."""
    import numpy as np

    cfg = serving_config(tr)
    refs = {}
    for name, c in (("plain_bf16", dataclasses.replace(cfg, attention_impl="torch")),
                    ("f32", dataclasses.replace(cfg, attention_impl="torch", dtype=torch.float32))):
        m = tr.Transformer(c, dev)
        m.load_state_dict(model.state_dict())
        refs[name] = [serve_batch(tr, m, [p], dev) for p in prompts]
        del m
    truth = np.stack([r[0][0] for r in refs["f32"]])
    plain = np.stack([r[0][0] for r in refs["plain_bf16"]])
    got = np.stack([s[0] for s in served])
    err = {"served_bf16": np.abs(got - truth), "plain_bf16": np.abs(plain - truth)}
    stats = {k: {"mean_abs_err": float(e.mean()), "max_abs_err": float(e.max())}
             for k, e in err.items()}
    top2 = np.sort(truth, axis=1)[:, -2:]
    margin = top2[:, 1] - top2[:, 0]
    limit = GREEDY_MARGIN_RATIO * err["plain_bf16"].max(axis=1)
    decided = margin > limit
    f32_greedy = truth.argmax(axis=1)
    served_greedy = np.array([s[1] for s in served])
    return {"prompts": len(prompts), "vs_f32": stats,
            "ratios": {"mean": stats["served_bf16"]["mean_abs_err"] / stats["plain_bf16"]["mean_abs_err"],
                       "max": stats["served_bf16"]["max_abs_err"] / stats["plain_bf16"]["max_abs_err"]},
            "worst_prompt_max_ratio": float((err["served_bf16"].max(axis=1)
                                             / err["plain_bf16"].max(axis=1)).max()),
            "greedy_decided": int(decided.sum()),
            "greedy_mismatch_where_decided": int((served_greedy != f32_greedy)[decided].sum()),
            "greedy_equal_all": int((served_greedy == f32_greedy).sum()),
            "finite": bool(np.isfinite(got).all()), "shape": list(got.shape)}


def http_answers(base: str, prompts) -> list:
    """The prompts through the HTTP proxy, SERVE_CONCURRENCY at a time:
    (log-probs, greedy token) from each answer's bytes."""
    import concurrent.futures
    import urllib.request

    import numpy as np

    def one(p):
        body = urllib.request.urlopen(urllib.request.Request(f"{base}/gpt2", data=p.tobytes()),
                                      timeout=120).read()
        return np.frombuffer(body[:-4], dtype=np.float32), int(np.frombuffer(body[-4:], np.int32)[0])

    with concurrent.futures.ThreadPoolExecutor(SERVE_CONCURRENCY) as pool:
        return list(pool.map(one, prompts))


def handle_answers(handle, prompts) -> list:
    """The prompts through the DeploymentHandle, SERVE_CONCURRENCY in flight."""
    out = []
    for i in range(0, len(prompts), SERVE_CONCURRENCY):
        responses = [handle.remote(p) for p in prompts[i:i + SERVE_CONCURRENCY]]
        out.extend(r.result(timeout_s=300) for r in responses)
    return out


def serve_load(worker_mod, loadgen, handle_mod, prompts, dep: str) -> tuple:
    """12b: loadgen's closed loop at SERVE_CONCURRENCY for SERVE_CLOSED_S,
    then its open loop at SERVE_OVERLOAD times the calibrated rate for
    SERVE_OPEN_S, deadline SERVE_TIMEOUT_S each, as loadgen.run_smoke runs
    them. Returns (to_gate_json's dict, closed-loop prompt tokens/s)."""

    async def phases():
        router = await handle_mod._get_router()
        closed_router = PromptRouter(router, prompts)
        closed = await loadgen.closed_loop(closed_router, dep, concurrency=SERVE_CONCURRENCY,
                                           duration_s=SERVE_CLOSED_S, timeout_s=SERVE_TIMEOUT_S)
        rate = closed.ok / max(closed.duration_s, 1e-9)
        opened = await loadgen.open_loop(PromptRouter(router, prompts), dep,
                                         rps=rate * SERVE_OVERLOAD, duration_s=SERVE_OPEN_S,
                                         timeout_s=SERVE_TIMEOUT_S)
        return closed, opened, closed_router.answered_tokens / closed.duration_s, \
            router.stats().get(dep, {})

    closed, opened, tokens_per_s, router_stats = worker_mod.global_worker.run_async(
        phases(), timeout=SERVE_CLOSED_S + SERVE_OPEN_S + 300)
    out = loadgen.to_gate_json(closed, opened)
    out["router"] = router_stats
    return out, tokens_per_s


def serve_multiplexed(rt, serve, tr, dev, prompts) -> dict:
    """12d: MuxServer at GPU SERVE_GPU, the model ids SERVE_MUX_SEEDS asked
    for in turns, one prompt each: after every eviction the replica's
    allocated memory is within one model's bytes plus SERVE_MUX_SLACK, and
    each answer equals a bare run of that seed's model on the same prompt."""
    import numpy as np

    app = serve.deployment(num_replicas=1, ray_actor_options={"num_gpus": SERVE_GPU},
                           health_check_timeout_s=300.0)(mux_server_class(serve))
    handle = serve.run(app.bind(), name="mux", route_prefix=None, _timeout_s=300)
    order = [SERVE_MUX_SEEDS[i % 2] for i in range(2 * len(SERVE_MUX_SEEDS))]
    answers = [handle.options(multiplexed_model_id=str(seed)).remote(prompts[i]).result(timeout_s=300)
               for i, seed in enumerate(order)]
    serve.delete("mux")
    cfg = serving_config(tr)
    diffs = []
    for i, seed in enumerate(order):
        model = tr.transformer_init(cfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
        if i == 0:
            model_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
        logp, greedy = serve_batch(tr, model, [prompts[i]], dev)
        diffs.append(float(np.abs(answers[i]["logp"] - logp[0]).max())
                     + float(answers[i]["greedy"] != greedy[0]))
        del model
    return {"order": order, "loads": answers[-1]["loads"], "model_bytes": model_bytes,
            "slack_bytes": SERVE_MUX_SLACK,
            "allocated_after": [a["allocated"] for a in answers],
            "peak_during": [a["peak"] for a in answers],
            "max_abs_vs_bare": diffs}


def serve_phase(tr, fa, dev) -> dict:
    """Phase 12 (12a-12d): GPT-2 small served by SERVE_REPLICAS GPU replicas
    sharing the card, then a multiplexed replica. Returns the flash launches
    of every replica (the main path's: the reference runs made here are not
    counted)."""
    import numpy as np

    import ray_tpu_torch as rt
    from ray_tpu_torch import loadgen, serve
    from ray_tpu_torch._private import worker as worker_mod
    from ray_tpu_torch.serve import handle as handle_mod

    t0 = time.perf_counter()
    cfg = serving_config(tr)
    prompts = serve_prompts(SERVE_PROMPTS, SEED + 12, cfg.vocab_size)
    rt.init(num_cpus=4)
    try:
        serve.start(http_options={"host": "127.0.0.1", "port": 0} if SERVE_HTTP
                    else {"enabled": False})
        app = serve.deployment(num_replicas=SERVE_REPLICAS, max_batch_size=SERVE_MAX_BATCH,
                               batch_wait_timeout_s=SERVE_BATCH_WAIT_S,
                               ray_actor_options={"num_gpus": SERVE_GPU},
                               health_check_timeout_s=300.0)(GPT2Server)
        handle = serve.run(app.bind(SEED + 12), name="gpt2", route_prefix="/gpt2",
                           _timeout_s=300)
        start_s = time.perf_counter() - t0
        gpu_free = rt.available_resources().get("GPU", 0.0)
        # 12a: every prompt through the handle (and the HTTP proxy), each
        # answer against f32.
        served = handle_answers(handle, prompts)
        received = [(row.copy(), g) for row, g in served]  # the answers as they came
        via_http = None
        if SERVE_HTTP:
            controller = rt.get_actor("SERVE_CONTROLLER", namespace="serve")
            http = rt.get(controller.get_http_config.remote())
            via_http = http_answers(f"http://{http['host']}:{http['port']}", prompts)
        # 12b: load.
        gate, tokens_per_s = serve_load(worker_mod, loadgen, handle_mod, prompts, f"gpt2#{app.name}")
        # 12c: one batch profiled in a replica.
        replicas = replica_actors(rt, worker_mod, "gpt2")
        batch = prompts[:SERVE_MAX_BATCH]
        in_replica = call_replica(rt, replicas[0], "profile_batch", prompts=batch)
        t1 = time.perf_counter()
        one = [handle.remote(p) for p in batch]
        [r.result(timeout_s=300) for r in one]
        batch_round_trip_ms = (time.perf_counter() - t1) * 1e3
        stats = [call_replica(rt, a, "stats") for a in replicas]
        metrics = [rt.get(a.get_metrics.remote(), timeout=60) for a in replicas]
        serve.delete("gpt2")  # frees the card for 12d's replica
        mux = serve_multiplexed(rt, serve, tr, dev, prompts)
    finally:
        serve.shutdown()
        rt.shutdown()

    model = tr.transformer_init(cfg, torch.Generator(device=dev).manual_seed(SEED + 12), device=dev)
    accuracy = served_vs_f32(tr, model, prompts, received, dev)
    http_equal = None if via_http is None else all(
        np.array_equal(a[0], b[0]) and a[1] == b[1] for a, b in zip(via_http, received))
    # An answer held since 12a (a zero-copy view where the object store
    # allows one) must still read what it read then.
    held_changed = [i for i, (a, b) in enumerate(zip(served, received))
                    if not np.array_equal(a[0], b[0], equal_nan=True)]
    bare = batch_times(tr, model, batch, dev)
    del model
    per_batch = [b for s in stats for b in s["launches"]]
    launches = {key: sum(b[key] for b in per_batch) for _, key, _ in KERNELS}
    line = {
        "phase": "serve", "replicas": SERVE_REPLICAS, "gpu_per_replica": SERVE_GPU,
        "gpu_free_with_replicas": gpu_free, "start_s": start_s, "http": SERVE_HTTP,
        "max_batch_size": SERVE_MAX_BATCH, "prompt_lens": list(SERVE_PROMPT_LENS),
        "accuracy": accuracy, "bounds": {"mean": LOGITS_MEAN_RATIO, "max": LOGITS_MAX_RATIO,
                                         "greedy_margin_ratio": GREEDY_MARGIN_RATIO},
        "http_equal_to_handle": http_equal, "held_answers_changed": held_changed,
        **{k: gate[k] for k in ("serve_rps", "serve_p50_ms", "serve_p99_ms", "serve_p999_ms",
                                "serve_goodput_rps", "serve_offered_rps", "serve_shed",
                                "serve_deadline_cut", "serve_overruns", "serve_errors")},
        "prompt_tokens_per_s": tokens_per_s,
        "load_phases": gate["phases"], "router": gate["router"],
        "batch_sizes": [s["sizes"] for s in stats],
        "batch_metrics": [m["batch"] for m in metrics],
        "b1_launches_per_batch": sorted({b["fwd"] for b in per_batch}),
        "batches": len(per_batch), "launches": launches,
        "replica_batch": in_replica, "bare_batch": bare,
        "batch_round_trip_ms": batch_round_trip_ms,
        "replica_devices": [s["device"] for s in stats],
        "multiplexed": mux, "seconds": time.perf_counter() - t0,
    }
    emit(line)
    check(accuracy["finite"] and accuracy["shape"] == [SERVE_PROMPTS, cfg.vocab_size],
          f"served answers: {accuracy['shape']}, finite {accuracy['finite']}")
    check(accuracy["ratios"]["mean"] <= LOGITS_MEAN_RATIO
          and accuracy["ratios"]["max"] <= LOGITS_MAX_RATIO,
          f"served log-probs further from f32 than the plain bf16 path's: {accuracy}")
    check(accuracy["greedy_mismatch_where_decided"] == 0,
          f"a served greedy token differs from f32's where the margin decides it: {accuracy}")
    check(http_equal in (None, True), "the HTTP proxy's answers differ from the handle's")
    check(not held_changed, f"answers held since 12a changed under later traffic: {held_changed}")
    check(gate["serve_overruns"] == 0 and gate["serve_errors"] == 0,
          f"overload gave overruns or errors: {gate['phases']}")
    check(gate["serve_shed"] + gate["serve_deadline_cut"] > 0,
          f"the open loop at {SERVE_OVERLOAD}x shed nothing: {gate['phases']['open']}")
    check(all(s["device"].startswith("cuda") for s in stats) and len(stats) == SERVE_REPLICAS,
          f"replicas on {[s['device'] for s in stats]}")
    check(gpu_free == torch.cuda.device_count() - SERVE_REPLICAS * SERVE_GPU,
          f"{gpu_free} GPU free with the replicas up")
    check(all(not s["forbidden_modules"] for s in stats),
          f"a replica imported {[s['forbidden_modules'] for s in stats]}")
    check(per_batch and all(b["fwd"] == GPT2_SMALL["n_layers"] and b["fwd_lse"] == 0
                            and b["bwd_dq"] == 0 and b["bwd_dkv"] == 0 for b in per_batch),
          f"a served batch launched {sorted({tuple(b.values()) for b in per_batch})}, "
          f"not {GPT2_SMALL['n_layers']} B1 and no B2-B4")
    check(all(a <= mux["model_bytes"] + SERVE_MUX_SLACK for a in mux["allocated_after"]),
          f"the multiplexed replica kept more than one model after an eviction: {mux}")
    check(mux["loads"] == [str(s) for s in mux["order"]],
          f"the multiplexed replica loaded {mux['loads']} for {mux['order']}")
    check(all(d == 0.0 for d in mux["max_abs_vs_bare"]),
          f"multiplexed answers differ from bare runs of their models: {mux['max_abs_vs_bare']}")
    return launches


# ---------------------------------------------------------------- phase 13

def tune_steps(cfg, dev, lr: float) -> dict:
    """Phase 13's run on `dev`, in a trial's worker or bare in this process: a
    batch (TUNE_BATCH x SEQ) and the weights drawn in that order from
    SEED + 13, then TUNE_STEPS AdamW(lr) steps. Each step's loss, the mean
    step time and the flash launches."""
    from ray_tpu_torch.models import transformer as tr

    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    raw = torch.randint(0, cfg.vocab_size, (TUNE_BATCH, SEQ + 1), device=dev, generator=gen)
    batch = {"tokens": raw[:, :-1].contiguous(), "targets": raw[:, 1:].contiguous()}
    init_state, step = tr.make_train_step(cfg, dev, optimizer=functools.partial(tr.adamw, lr=lr))
    state = init_state(gen)
    fa.reset_launches()
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TUNE_STEPS):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    return {"losses": losses, "step_ms": (time.perf_counter() - t0) / TUNE_STEPS * 1e3,
            "launches": dict(fa.launches)}


def tune_trial_loop(config) -> None:
    """A Tune trial's TorchTrainer worker: tune_steps at the trial's lr,
    each step's loss reported as it comes, then a summary report."""
    from ray_tpu_torch import train
    from ray_tpu_torch.train.torch import get_device

    started = time.time()
    dev = get_device()
    run = tune_steps(config["cfg"], dev, config["lr"])
    for k, loss in enumerate(run["losses"]):
        train.report({"step": k, "loss": loss})
    train.report({"loss": run["losses"][-1], "summary": {
        "lr": config["lr"], "device": str(dev), "pid": os.getpid(),
        "loop_started_at": started, "loop_ended_at": time.time(),
        "step_ms": run["step_ms"], "launches": run["launches"],
        "forbidden_modules": forbidden_modules()}})


def tune_phase(tr, dev) -> dict:
    """Phase 13: a Tuner over TUNE_LRS, each trial TorchTrainer(...)
    .as_trainable() with one GPU worker at GPU TUNE_GPU, both trials on the
    card at once; each trial's losses against a bare run here. Returns the
    trials' flash launches."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import tune
    from ray_tpu_torch.air import RunConfig, ScalingConfig
    from ray_tpu_torch.train.torch import TorchTrainer

    t0 = time.perf_counter()
    cfg = tr.TransformerConfig(**GPT2_SMALL)
    bare = {}
    for lr in TUNE_LRS:
        t1 = time.perf_counter()
        bare[lr] = tune_steps(cfg, dev, lr)
        torch.cuda.synchronize()
        bare[lr]["seconds"] = time.perf_counter() - t1
    gc.collect()
    torch.cuda.empty_cache()
    storage = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_tune")
    shutil.rmtree(storage, ignore_errors=True)
    rt.init(num_cpus=6)  # two trial actors and their two workers, one CPU each
    try:
        trainer = TorchTrainer(
            tune_trial_loop, train_loop_config={"cfg": cfg},
            scaling_config=ScalingConfig(num_workers=1, use_gpu=True,
                                         resources_per_worker={"GPU": TUNE_GPU}),
            run_config=RunConfig(storage_path=storage))
        fit_start = time.time()
        grid = tune.Tuner(
            trainer,
            param_space={"train_loop_config": {"lr": tune.grid_search(list(TUNE_LRS))}},
            tune_config=tune.TuneConfig(metric="loss", mode="min",
                                        max_concurrent_trials=len(TUNE_LRS)),
            run_config=RunConfig(name="tune", storage_path=storage),
        ).fit()
        fit_end = time.time()
        best = grid.get_best_result()
    finally:
        rt.shutdown()
        shutil.rmtree(storage, ignore_errors=True)
    trials = {}
    for trial in grid._trials:
        steps = {m["step"]: m["loss"] for m in trial.history if "step" in m}
        summary = next(m["summary"] for m in trial.history if "summary" in m)
        lr = summary["lr"]
        trials[lr] = {"losses": [steps[k] for k in sorted(steps)], **summary,
                      "worker_start_s": summary["loop_started_at"] - fit_start,
                      "loop_s": summary["loop_ended_at"] - summary["loop_started_at"],
                      "fit_s": summary["loop_ended_at"] - fit_start,
                      "error": trial.error}
    diffs = {lr: max(abs(a - b) for a, b in zip(t["losses"], bare[lr]["losses"]))
             for lr, t in trials.items()}
    last = {lr: t["losses"][-1] for lr, t in trials.items()}
    launches = {key: sum(t["launches"][key] for t in trials.values()) for _, key, _ in KERNELS}
    spans = sorted((t["loop_started_at"], t["loop_ended_at"]) for t in trials.values())
    line = {"phase": "tune", "lrs": list(TUNE_LRS), "batch": TUNE_BATCH, "seq": SEQ,
            "steps": TUNE_STEPS, "gpu_per_trial": TUNE_GPU,
            "trials": {str(lr): t for lr, t in trials.items()},
            "bare": {str(lr): {"losses": b["losses"], "step_ms": b["step_ms"],
                               "seconds": b["seconds"]} for lr, b in bare.items()},
            "max_loss_diff_vs_bare": {str(lr): d for lr, d in diffs.items()},
            "loss_bound": LOSS_BOUND, "best_lr": best.metrics["summary"]["lr"],
            "best_loss": best.metrics["loss"], "tuner_fit_s": fit_end - fit_start,
            "loops_overlapped": spans[1][0] < spans[0][1],
            "tail_after_last_loop_s": fit_end - max(t["loop_ended_at"] for t in trials.values()),
            "launches": launches, "seconds": time.perf_counter() - t0}
    emit(line)
    check(sorted(trials) == sorted(TUNE_LRS) and all(t["error"] is None for t in trials.values()),
          f"the Tuner ran trials {sorted(trials)}: {[t['error'] for t in trials.values()]}")
    check(all(t["device"].startswith("cuda") for t in trials.values()),
          f"trials trained on {[t['device'] for t in trials.values()]}")
    check(all(len(t["losses"]) == TUNE_STEPS for t in trials.values()),
          "a trial did not report every step's loss")
    check(all(d <= LOSS_BOUND for d in diffs.values()), f"trials' losses off the bare runs': {diffs}")
    check(best.metrics["loss"] == min(last.values()) and last[line["best_lr"]] == min(last.values()),
          f"the best result (lr {line['best_lr']}, loss {best.metrics['loss']}) is not the trial "
          f"with the lower last loss: {last}")
    check(all(not t["forbidden_modules"] for t in trials.values()),
          f"a trial's worker imported {[t['forbidden_modules'] for t in trials.values()]}")
    for key in ("fwd_lse", "bwd_dq", "bwd_dkv"):
        check(all(t["launches"][key] > 0 for t in trials.values()),
              f"{key} was not launched in every trial's worker")
    return launches


# ---------------------------------------------------------------- phase 14

ROOT = os.path.dirname(os.path.abspath(__file__))


def cuda_here() -> torch.device:
    """The card of a GPU task's process. A GPU task placed on a process that
    has no card raises here: nothing falls back to the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError(f"a GPU task ran without a CUDA card (pid {os.getpid()}, node "
                           f"{os.environ.get('RAY_TPU_NODE_ID')})")
    return torch.device("cuda", torch.cuda.current_device())


def digest(t) -> str:
    """sha256 of a tensor's dtype, shape and bytes: equal digests, equal tensors."""
    import hashlib

    t = t.detach().cpu().contiguous()
    body = t.view(torch.uint8) if t.dtype != torch.bool else t.to(torch.uint8)
    return hashlib.sha256(f"{t.dtype}{tuple(t.shape)}".encode()
                          + body.numpy().tobytes()).hexdigest()


def forward_inputs(seed: int) -> tuple:
    """GPT-2 small's weights and then CLUSTER_BATCH x SEQ tokens, drawn from
    `seed` on this process's card."""
    from ray_tpu_torch.models import transformer as tr

    dev = cuda_here()
    cfg = tr.TransformerConfig(**GPT2_SMALL)
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = tr.transformer_init(cfg, gen, device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (CLUSTER_BATCH, SEQ), device=dev, generator=gen)
    return model, tokens


def last_logp(model, tokens):
    """The f32 log-probs at each prompt's last position (B1 under
    inference_mode), the card synchronised."""
    from ray_tpu_torch.models import transformer as tr

    with torch.inference_mode():
        logits = tr.transformer_apply(model, tokens)
        logp = torch.log_softmax(logits[:, -1].float(), dim=-1)
    torch.cuda.synchronize(tokens.device)
    return logp


def cluster_forward(seed: int) -> dict:
    """14a's forward, in a GPU task or bare here: forward_inputs(seed)'s
    last-position log-probs, the flash launches and where it ran."""
    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    model, tokens = forward_inputs(seed)
    fa.reset_launches()
    logp = last_logp(model, tokens)
    return {"logp": logp, "launches": dict(fa.launches), "device": str(tokens.device),
            "pid": os.getpid(), "node": os.environ.get("RAY_TPU_NODE_ID")}


def client_train(seed: int) -> dict:
    """14c's task, in a GPU task or bare here: a batch (TUNE_BATCH x SEQ)
    and GPT-2 small's weights drawn from `seed` on the card, TUNE_STEPS AdamW
    steps (B2-B4), then one more forward and backward whose gradient of
    blocks.0.wq comes back as a CUDA tensor. Its step ms are on the host's
    clock, the card synchronised at the ends."""
    from ray_tpu_torch.models import transformer as tr

    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    dev = cuda_here()
    cfg = tr.TransformerConfig(**GPT2_SMALL)
    gen = torch.Generator(device=dev).manual_seed(seed)
    raw = torch.randint(0, cfg.vocab_size, (TUNE_BATCH, SEQ + 1), device=dev, generator=gen)
    batch = {"tokens": raw[:, :-1].contiguous(), "targets": raw[:, 1:].contiguous()}
    init_state, step = tr.make_train_step(cfg, dev)
    state = init_state(gen)
    fa.reset_launches()
    losses = []
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(TUNE_STEPS):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    step_ms = (time.perf_counter() - t0) / TUNE_STEPS * 1e3
    state["loss_fn"](batch).backward()
    grad = dict(state["model"].named_parameters())["blocks.0.wq"].grad.detach().clone()
    return {"losses": losses, "grad": grad, "step_ms": step_ms, "launches": dict(fa.launches),
            "device": str(dev), "node": os.environ.get("RAY_TPU_NODE_ID")}


def client_ping() -> int:
    return os.getpid()


def job_main() -> None:
    """14b's job entrypoint: attaches with address="auto" (the job manager
    hands the job RAY_TPU_TORCH_ADDRESS), runs 14a's forward as a GPU task
    and prints the log-probs' digest, on a line of its own."""
    import ray_tpu_torch as rt

    rt.init(address="auto")
    try:
        out = rt.get(rt.remote(num_gpus=1)(cluster_forward).remote(SEED + 14), timeout=600)
        nodes = sorted(n["node_id"] for n in rt.nodes())
    finally:
        rt.shutdown()
    print("JOB_RESULT " + json.dumps({
        "digest": digest(out["logp"]), "logp_device": str(out["logp"].device),
        "launches": out["launches"], "device": out["device"], "node": out["node"],
        "cluster_nodes": nodes, "address": os.environ.get("RAY_TPU_TORCH_ADDRESS"),
        "forbidden_modules": forbidden_modules()}), flush=True)


def client_main(address: str) -> None:
    """14c's client-mode driver (run with CUDA_VISIBLE_DEVICES=""): a GPU
    task through the client server, its tensor back as a CPU tensor, and
    the proxy's round trip for a task that does nothing; prints one line."""
    import ray_tpu_torch as rt

    t0 = time.perf_counter()
    rt.init(address=address)
    connect_s = time.perf_counter() - t0
    try:
        ping = rt.remote(num_cpus=0)(client_ping)
        rt.get(ping.remote(), timeout=120)  # its worker started
        t0 = time.perf_counter()
        for _ in range(CLIENT_PINGS):
            rt.get(ping.remote(), timeout=120)
        ping_ms = (time.perf_counter() - t0) / CLIENT_PINGS * 1e3
        t0 = time.perf_counter()
        out = rt.get(rt.remote(num_gpus=1)(client_train).remote(SEED + 15), timeout=600)
        task_s = time.perf_counter() - t0
    finally:
        rt.shutdown()
    grad = out["grad"]
    print("CLIENT_RESULT " + json.dumps({
        "losses": out["losses"], "grad_digest": digest(grad), "grad_type": type(grad).__name__,
        "grad_device": str(grad.device), "grad_dtype": str(grad.dtype),
        "task_device": out["device"], "worker_step_ms": out["step_ms"],
        "launches": out["launches"], "connect_s": connect_s, "task_s": task_s,
        "ping_ms": ping_ms, "cuda_initialized": torch.cuda.is_initialized(),
        "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
        "forbidden_modules": forbidden_modules()}), flush=True)


def wf_init(seed: int, counter: str) -> dict:
    """14d's first step: GPT-2 small's weights from `seed`, on the card."""
    from ray_tpu_torch.models import transformer as tr

    with open(counter, "a") as f:
        f.write("x")
    dev = cuda_here()
    model = tr.transformer_init(tr.TransformerConfig(**GPT2_SMALL),
                                torch.Generator(device=dev).manual_seed(seed), device=dev)
    return {"params": model.state_dict()}


def wf_model(params: dict, dev):
    from ray_tpu_torch.models import transformer as tr

    model = tr.Transformer(tr.TransformerConfig(**GPT2_SMALL), dev)
    model.load_state_dict(params)
    return model


def wf_train(init: dict, seed: int, fail_marker) -> dict:
    """14d's second step: WORKFLOW_STEPS AdamW steps from init's weights on
    a batch from `seed` (B2-B4). While `fail_marker` exists it removes it
    and fails, before any work."""
    from ray_tpu_torch.models import transformer as tr

    if fail_marker and os.path.exists(fail_marker):
        os.unlink(fail_marker)
        raise RuntimeError("train fails once (marker file)")
    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    dev = cuda_here()
    cfg = tr.TransformerConfig(**GPT2_SMALL)
    init_state, step = tr.make_train_step(cfg, dev)
    state = init_state(model=wf_model(init["params"], dev))
    gen = torch.Generator(device=dev).manual_seed(seed)
    raw = torch.randint(0, cfg.vocab_size, (TUNE_BATCH, SEQ + 1), device=dev, generator=gen)
    batch = {"tokens": raw[:, :-1].contiguous(), "targets": raw[:, 1:].contiguous()}
    fa.reset_launches()
    losses = [float(step(state, batch)[1]["loss"]) for _ in range(WORKFLOW_STEPS)]
    return {"params": state["model"].state_dict(), "losses": losses,
            "launches": dict(fa.launches)}


def wf_eval(trained: dict, seed: int) -> dict:
    """14d's last step: the trained weights' last-position log-probs on
    CLUSTER_BATCH x SEQ tokens from `seed` (B1), a CUDA tensor."""
    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    from ray_tpu_torch.models import transformer as tr

    dev = cuda_here()
    model = wf_model(trained["params"], dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    tokens = torch.randint(0, model.cfg.vocab_size, (CLUSTER_BATCH, SEQ), device=dev,
                           generator=gen)
    fa.reset_launches()
    with torch.inference_mode():
        logp = torch.log_softmax(tr.transformer_apply(model, tokens)[:, -1].float(), dim=-1)
    torch.cuda.synchronize(dev)
    return {"logp": logp, "train_losses": trained["losses"],
            "train_launches": trained["launches"], "eval_launches": dict(fa.launches)}


def wf_graph(rt, counter: str, fail_marker):
    gpu = rt.remote(num_gpus=1)
    p = gpu(wf_init).bind(SEED + 16, counter)
    p = gpu(wf_train).bind(p, SEED + 17, fail_marker)
    return gpu(wf_eval).bind(p, SEED + 18)


def port_processes() -> set:
    """Pids of this machine's processes whose command line names the port or
    this script (heads, workers and zygotes, job and client drivers), this
    one excluded."""
    pids = set()
    for entry in os.listdir("/proc"):
        if entry.isdigit() and int(entry) != os.getpid():
            try:
                with open(f"/proc/{entry}/cmdline", "rb") as f:
                    cmdline = f.read()
                if b"ray_tpu_torch" in cmdline or b"chip_smoke" in cmdline:
                        pids.add(int(entry))
            except OSError:
                pass
    return pids


def cli(*argv, timeout: float = 120) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-m", "ray_tpu_torch.scripts.cli", *argv], cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout)


def head_line(log: str, prefix: str, proc, timeout: float = 120) -> str:
    """The first line of the head's log that starts with `prefix`."""
    deadline = time.monotonic() + timeout
    while True:
        with open(log) as f:
            text = f.read()
        found = [x.strip() for x in text.splitlines() if x.startswith(prefix)]
        if found:
            return found[0]
        check(proc.poll() is None, f"the head exited {proc.returncode}: {text[-3000:]}")
        check(time.monotonic() < deadline, f"the head printed no {prefix!r} line: {text[-3000:]}")
        time.sleep(0.1)


def http_get(url: str) -> str:
    import urllib.request

    with urllib.request.urlopen(url, timeout=30) as r:
        return r.read().decode()


def cluster_utils_run(bare: dict) -> dict:
    """14a: a Cluster whose head has no GPU and one added node has one; the
    GPU task must run on that node and give the bare forward's log-probs."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.cluster_utils import Cluster

    t0 = time.perf_counter()
    cluster = Cluster(head_node_args={"num_cpus": 2, "num_gpus": 0})
    try:
        gpu_node = cluster.add_node(num_cpus=2, num_gpus=1)
        cluster.connect()
        resources = rt.cluster_resources()
        t1 = time.perf_counter()
        out = rt.get(rt.remote(num_gpus=1)(cluster_forward).remote(SEED + 14), timeout=600)
        task_s = time.perf_counter() - t1
    finally:
        cluster.shutdown()
    line = {"gpu_node": gpu_node.node_id, "head_node": cluster.head_node.raylet.node_id,
            "task_node": out["node"], "task_device": out["device"],
            "cluster_gpu": resources.get("GPU"), "logp_shape": list(out["logp"].shape),
            "logp_device": str(out["logp"].device),
            "bitwise_equal_to_bare": bool(torch.equal(out["logp"], bare["logp"].cpu())),
            "max_abs_diff_vs_bare": max_err(out["logp"], bare["logp"].cpu()),
            "launches": out["launches"], "task_s": task_s,
            "seconds": time.perf_counter() - t0}
    check(line["cluster_gpu"] == 1.0, f"the cluster advertises GPU {line['cluster_gpu']}, not 1")
    check(out["node"] == gpu_node.node_id,
          f"the GPU task ran on node {out['node']}, not the GPU node {gpu_node.node_id}")
    check(out["device"].startswith("cuda") and line["logp_device"] == "cpu",
          f"the task ran on {out['device']} and its log-probs reached the driver on "
          f"{line['logp_device']}")
    check(line["logp_shape"] == [CLUSTER_BATCH, GPT2_SMALL["vocab_size"]]
          and bool(torch.isfinite(out["logp"]).all()), "the task's log-probs are not finite")
    check(line["bitwise_equal_to_bare"], f"the GPU node's log-probs differ from the bare "
                                         f"forward's by {line['max_abs_diff_vs_bare']}")
    check(out["launches"]["fwd"] == GPT2_SMALL["n_layers"],
          f"the GPU task launched B1 {out['launches']['fwd']} times, not once a layer")
    return line


def cli_job_run(rt, address: str, dashboard: str, bare: dict) -> dict:
    """14b on the head the CLI started: `cli status`, a job whose driver
    attaches with address="auto" and runs 14a's forward, the task in `cli
    list tasks` and util.state with its GPU, the dashboard's endpoints."""
    from ray_tpu_torch.job import JobStatus, JobSubmissionClient
    from ray_tpu_torch.util import state

    status = cli("status")
    check(status.returncode == 0, f"cli status exited {status.returncode}: {status.stderr[-2000:]}")
    gpu_line = [x.strip() for x in status.stdout.splitlines() if x.strip().startswith("GPU:")]
    check(len(gpu_line) == 1 and gpu_line[0].endswith("/ 1 available"),
          f"cli status shows no GPU 1: {status.stdout}")

    t0 = time.perf_counter()
    jobs = JobSubmissionClient()
    sid = jobs.submit_job(entrypoint=f"{sys.executable} -c \"import sys; sys.path.insert(0, "
                                     f"{ROOT!r}); import chip_smoke; chip_smoke.job_main()\"")
    job_status = jobs.wait_until_finish(sid, timeout_s=600, poll_s=0.2)
    job_s = time.perf_counter() - t0
    logs = jobs.get_job_logs(sid)
    check(job_status == JobStatus.SUCCEEDED, f"the job ended {job_status}: {logs[-3000:]}")
    job = json.loads([x for x in logs.splitlines() if x.startswith("JOB_RESULT ")][-1][11:])
    head_nodes = sorted(n["node_id"] for n in rt.nodes())

    listed = cli("list", "tasks", "--limit", "10000")
    check(listed.returncode == 0, f"cli list tasks exited {listed.returncode}: "
                                  f"{listed.stderr[-2000:]}")
    rows = [t for t in json.loads(listed.stdout) if t["name"] == "cluster_forward"]
    api_rows = [t for t in state.list_tasks() if t["name"] == "cluster_forward"]
    pages = {p: json.loads(http_get(dashboard + p)) for p in (
        "/api/nodes", "/api/jobs", "/api/tasks/summary", "/api/cluster_status",
        "/api/events?limit=50")}
    healthz, metrics = http_get(dashboard + "/-/healthz"), http_get(dashboard + "/metrics")
    line = {"status_gpu": gpu_line[0], "job_submit_to_succeeded_s": job_s, "job": job,
            "job_digest_equal_to_bare": job["digest"] == digest(bare["logp"]),
            "job_attached_to_head": job["cluster_nodes"] == head_nodes,
            "list_tasks": rows, "state_list_tasks": api_rows,
            "dashboard_nodes": len(pages["/api/nodes"]["nodes"]),
            "dashboard_jobs": {j["submission_id"]: j["status"] for j in pages["/api/jobs"]["jobs"]},
            "dashboard_task_summary": pages["/api/tasks/summary"]["summary"].get("cluster_forward"),
            "dashboard_healthz": healthz, "metrics_bytes": len(metrics)}
    check(job["device"].startswith("cuda") and job["logp_device"] == "cpu",
          f"the job's task ran on {job['device']}")
    check(line["job_digest_equal_to_bare"], "the job's log-probs differ from the bare forward's")
    check(line["job_attached_to_head"] and job["address"] == address,
          f"the job attached to {job['address']} ({job['cluster_nodes']}), not the head "
          f"{address} ({head_nodes})")
    check(not job["forbidden_modules"], f"the job's driver imported {job['forbidden_modules']}")
    for where, found in (("cli list tasks", rows), ("util.state.list_tasks", api_rows)):
        check(any(t["state"] == "FINISHED" and t["resources"].get("GPU") == 1.0 for t in found),
              f"{where} shows no finished GPU task: {found}")
    check(healthz == "success" and line["dashboard_nodes"] == 1
          and line["dashboard_jobs"].get(sid) == JobStatus.SUCCEEDED
          and (line["dashboard_task_summary"] or {}).get("FINISHED", 0) >= 1
          and "nodes" in pages["/api/cluster_status"]
          and any(e["label"] == "NODE_ADDED" for e in pages["/api/events?limit=50"]["events"]),
          f"the dashboard's JSON endpoints: {line}")
    return line


def client_run(rt, client_addr: str, work: str, bare: dict) -> dict:
    """14c: a client-mode driver without a card (client_main, in a
    subprocess) against the bare run of its task; the proxy's round trip
    beside this driver's."""
    t0 = time.perf_counter()
    for _ in range(CLIENT_PINGS + 1):
        rt.get(rt.remote(num_cpus=0)(client_ping).remote(), timeout=120)
    driver_ping_ms = (time.perf_counter() - t0) / (CLIENT_PINGS + 1) * 1e3
    t0 = time.perf_counter()
    client = subprocess.run(
        [sys.executable, "-c", f"import sys; sys.path.insert(0, {ROOT!r}); import chip_smoke; "
                               f"chip_smoke.client_main({client_addr!r})"],
        cwd=work, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""}, capture_output=True, text=True,
        timeout=900)
    client_s = time.perf_counter() - t0
    check(client.returncode == 0, f"the client exited {client.returncode}: "
                                  f"{client.stdout[-2000:]}\n{client.stderr[-4000:]}")
    got = json.loads([x for x in client.stdout.splitlines()
                      if x.startswith("CLIENT_RESULT ")][-1][14:])
    diffs = [abs(a - b) for a, b in zip(got["losses"], bare["losses"])]
    line = {**got, "process_s": client_s, "bare_losses": bare["losses"],
            "bare_step_ms": bare["step_ms"], "driver_ping_ms": driver_ping_ms,
            "max_loss_diff_vs_bare": max(diffs),
            "grad_equal_to_bare": got["grad_digest"] == digest(bare["grad"])}
    check(got["task_device"].startswith("cuda"), f"the client's task ran on {got['task_device']}")
    check(len(diffs) == TUNE_STEPS and max(diffs) <= LOSS_BOUND,
          f"the client's losses off the bare run's: {diffs}")
    check(got["grad_type"] == "Tensor" and got["grad_device"] == "cpu"
          and line["grad_equal_to_bare"],
          f"the gradient reached the client as a {got['grad_device']} {got['grad_type']} "
          f"unequal to the bare run's")
    check(got["cuda_initialized"] is False and got["cuda_visible_devices"] == "",
          "the client process made CUDA state")
    check(not got["forbidden_modules"], f"the client imported {got['forbidden_modules']}")
    return line


def workflow_run(rt, work: str) -> dict:
    """14d: the workflow of GPU steps, its train failing once (a marker
    file): run raises, resume finishes; an uninterrupted run beside it."""
    import pickle

    from ray_tpu_torch import workflow

    store = os.path.join(work, "workflows")
    marker = os.path.join(work, "train_fails_once")
    counters = {wid: os.path.join(work, f"{wid}.init_runs") for wid in ("wf-resumed", "wf-whole")}
    with open(marker, "w") as f:
        f.write("1")
    t0 = time.perf_counter()
    try:
        workflow.run(wf_graph(rt, counters["wf-resumed"], marker), workflow_id="wf-resumed",
                     storage=store)
        first_run = "finished"
    except Exception as exc:  # the train step's failure, as planned
        first_run = f"{type(exc).__name__}: {str(exc)[:200]}"
    failed_s = time.perf_counter() - t0
    failed_meta = workflow.get_metadata("wf-resumed", storage=store)["status"]
    t0 = time.perf_counter()
    resumed = workflow.resume("wf-resumed", storage=store)
    resume_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    whole = workflow.run(wf_graph(rt, counters["wf-whole"], None), workflow_id="wf-whole",
                         storage=store)
    whole_s = time.perf_counter() - t0
    steps = workflow.get_step_metadata("wf-resumed", storage=store)
    steps_dir = os.path.join(store, "wf-resumed", "steps")
    init_pkl = [s for s in os.listdir(steps_dir) if "_wf_init_" in s and s.endswith(".pkl")]
    with open(os.path.join(steps_dir, init_pkl[0]), "rb") as f:
        saved = pickle.load(f)["params"]
    init_runs = {}
    for wid, path in counters.items():
        with open(path) as f:
            init_runs[wid] = f.read().count("x")
    line = {
        "first_run": first_run, "status_after_failure": failed_meta,
        "failed_run_s": failed_s, "resume_s": resume_s, "uninterrupted_s": whole_s,
        "init_runs": init_runs,
        "steps": {sid: {k: m.get(k) for k in ("name", "status", "attempts")}
                  for sid, m in steps.items()},
        "train_losses": resumed["train_losses"],
        "logp_bitwise_equal": bool(torch.equal(resumed["logp"], whole["logp"])),
        "losses_equal": resumed["train_losses"] == whole["train_losses"],
        "checkpoint_devices": sorted({str(t.device) for t in saved.values()}),
        "checkpoint_tensors": len(saved), "output_device": str(resumed["logp"].device),
        "launches": [resumed["train_launches"], resumed["eval_launches"],
                     whole["train_launches"], whole["eval_launches"]]}
    check(first_run.startswith(("TaskError", "RuntimeError")) and failed_meta == "FAILED",
          f"the interrupted workflow did not fail at train: {first_run}")
    check(line["logp_bitwise_equal"] and line["losses_equal"],
          "the resumed workflow's output differs from the uninterrupted one's")
    check(init_runs == {"wf-resumed": 1, "wf-whole": 1}, f"init ran {init_runs} times")
    check(line["checkpoint_devices"] == ["cpu"] and line["output_device"] == "cpu",
          f"checkpointed tensors on {line['checkpoint_devices']}")
    check(all(math.isfinite(x) for x in line["train_losses"]), "a workflow loss is not finite")
    return line


def cluster_phase(dev) -> dict:
    """Phase 14: the port as a GPU cluster. 14a on a cluster_utils Cluster;
    14b-14d on a head started by the CLI, which `cli stop` ends, leaving no
    process of the port. Returns the flash launches of every GPU task it
    ran, summed (the bare runs here are not counted)."""
    import signal

    import ray_tpu_torch as rt

    t_phase = time.perf_counter()
    work = os.path.join(ROOT, "build", "chip_smoke_cluster")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    bare_fwd = cluster_forward(SEED + 14)
    bare_train = client_train(SEED + 15)
    line = {"phase": "cluster", "14a": cluster_utils_run(bare_fwd)}

    before = port_processes()
    log = os.path.join(work, "head.log")
    head = None
    try:
        t0 = time.perf_counter()
        with open(log, "w") as f:
            head = subprocess.Popen(
                [sys.executable, "-m", "ray_tpu_torch.scripts.cli", "start", "--head",
                 "--num-gpus", "1", "--num-cpus", str(CLUSTER_HEAD_CPUS), "--dashboard-port", "0",
                 "--client-server-port", "0"],
                cwd=ROOT, stdout=f, stderr=subprocess.STDOUT, start_new_session=True,
                env={**os.environ, "PYTHONUNBUFFERED": "1"})
        client_addr = head_line(log, "remote drivers:", head).split("address='")[1].rstrip("')")
        head_start_s = time.perf_counter() - t0
        address = head_line(log, "ray_tpu_torch head started at", head).rsplit(" ", 1)[1]
        dashboard = head_line(log, "dashboard:", head).split(" ", 1)[1]
        rt.init(address=address)
        line["14b"] = {"head_start_s": head_start_s, "address": address, "dashboard": dashboard,
                       "client_server": client_addr,
                       **cli_job_run(rt, address, dashboard, bare_fwd)}
        line["14c"] = client_run(rt, client_addr, work, bare_train)
        line["14d"] = workflow_run(rt, work)
        rt.shutdown()

        stopped = cli("stop")
        check(stopped.returncode == 0 and "SIGTERM" in stopped.stdout,
              f"cli stop: {stopped.stdout} {stopped.stderr[-2000:]}")
        head.wait(timeout=60)
        deadline = time.monotonic() + 30
        while port_processes() - before and time.monotonic() < deadline:
            time.sleep(0.2)
        left = sorted(port_processes() - before)
        check(not left, f"port processes left after cli stop: {left}")
    finally:
        rt.shutdown()
        if head is not None and head.poll() is None:
            try:
                os.killpg(head.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            head.wait(timeout=30)
        shutil.rmtree(work, ignore_errors=True)

    task_launches = [line["14a"]["launches"], line["14b"]["job"]["launches"],
                     line["14c"]["launches"], *line["14d"]["launches"]]
    launches = {key: sum(t[key] for t in task_launches) for _, key, _ in KERNELS}
    line.update({"head_exit": head.returncode, "left_processes": left, "launches": launches,
                 "nvidia_smi": card()["nvidia_smi"], "seconds": time.perf_counter() - t_phase})
    emit(line)
    for key in ("fwd", "fwd_lse", "bwd_dq", "bwd_dkv"):
        check(launches[key] > 0, f"{key} was not launched in phase 14")
    return launches


# ---------------------------------------------------------------- phase 15

NATIVE_MODULES = ("_fastpath", "_shm", "_store")


def native_state() -> dict:
    """Which native paths this process's runtime took (the wire codec, the
    store core, the shm segments), and the library each native module was
    loaded from beside the one built from the checkout's sources."""
    from ray_tpu_torch import _native
    from ray_tpu_torch._private import rpc, shm, store_core

    loaded = {n: getattr(sys.modules.get(f"ray_tpu_torch._native.{n}"), "__file__", None)
              for n in NATIVE_MODULES}
    return {"wire": rpc.native_wire_active(), "store_core": store_core.NATIVE,
            "shm": shm.NATIVE, "loaded": loaded,
            "built": {n: str(_native.library_path(n)) for n in NATIVE_MODULES},
            "node": os.environ.get("RAY_TPU_NODE_ID"), "pid": os.getpid()}


def native_ok(state: dict) -> bool:
    return (state["wire"] and state["store_core"] and state["shm"]
            and all(state["loaded"][n] and os.path.samefile(state["loaded"][n], state["built"][n])
                    for n in NATIVE_MODULES))


def native_run(work: str) -> dict:
    """15a: the extensions this process built at its first import of the
    runtime, from ray_tpu_torch/_native/csrc/; the native paths taken here
    and in a num_gpus=1 worker; native_ab's two legs on this host, whose
    threshold misses are data: their single runs swing across both sides
    of the thresholds on this shared host."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import _native

    here = native_state()
    rt.init(num_cpus=2)
    try:
        worker = rt.get(rt.remote(num_gpus=1)(native_state).remote(), timeout=300)
    finally:
        rt.shutdown()
    ab_json = os.path.join(work, "native_ab.json")
    t0 = time.perf_counter()
    ab = subprocess.run([sys.executable, "-m", "ray_tpu_torch._native.native_ab", "--json", ab_json],
                        cwd=ROOT, capture_output=True, text=True, timeout=600)
    ab_s = time.perf_counter() - t0
    report = None
    if os.path.exists(ab_json):
        with open(ab_json) as f:
            report = json.load(f)
    check(ab.returncode in (0, 1) and report is not None and "e2e" in report,
          f"native_ab exited {ab.returncode}: {ab.stdout[-2000:]} {ab.stderr[-3000:]}")
    line = {"build_s": dict(_native.BUILD_SECONDS), "sources": str(_native.CSRC),
            "driver": here, "gpu_worker": worker, "native_ab": report,
            "native_ab_misses": report["failures"], "native_ab_s": ab_s}
    check(sorted(_native.BUILD_SECONDS) == sorted(NATIVE_MODULES),
          f"this process built {sorted(_native.BUILD_SECONDS)}, not all of {NATIVE_MODULES}")
    check(native_ok(here), f"the driver's runtime is not on the native path: {here}")
    check(native_ok(worker), f"the GPU worker's runtime is not on the native path: {worker}")
    rates = [*report["codec"].values(), *report["e2e"].values()]
    check(all(v > 0 for v in rates), f"native_ab measured nothing: {report}")
    check((ab.returncode == 0) == (not report["failures"]),
          f"native_ab's exit {ab.returncode} against its misses {report['failures']}")
    return line


def autoscale_config(state_dir: str):
    from ray_tpu_torch.autoscaler import launcher as launcher_mod
    from ray_tpu_torch.autoscaler.launcher import ClusterConfig

    launcher_mod._STATE_DIR = state_dir  # inside the checkout's build/
    return ClusterConfig.from_dict({
        "cluster_name": "smoke15", "provider": {"type": "fake"}, "head_node_type": "head",
        "idle_timeout_minutes": AUTOSCALE_IDLE_S / 60,
        "available_node_types": {
            "head": {"resources": {"CPU": 0}, "min_workers": 0, "max_workers": 0},
            "gpu": {"resources": {"CPU": 2, "GPU": 1}, "min_workers": 0, "max_workers": 1}}})


def scale_until(launcher, done, what: str, timeout: float) -> dict:
    """Autoscaler rounds every 0.25 s until done() holds: the rounds'
    launches and terminations, and the seconds it took."""
    t0 = time.perf_counter()
    launched = terminated = rounds = 0
    while not done():
        check(time.perf_counter() - t0 < timeout,
              f"{what}: not within {timeout} s ({launched} launched, {terminated} terminated)")
        out = launcher.update()
        launched, terminated, rounds = (launched + out["launched"],
                                        terminated + out["terminated"], rounds + 1)
        time.sleep(0.25)
    return {"s": time.perf_counter() - t0, "rounds": rounds, "launched": launched,
            "terminated": terminated}


def autoscale_run(work: str, bare: dict) -> dict:
    """15b: a fake-provider cluster whose head has no CPU and no GPU and whose
    one worker type has both. A num_gpus=1 task runs 14a's forward: it waits
    on the head alone until the autoscaler launches the GPU node, then runs
    there, bitwise the bare forward. A job submitted then (its supervisor can
    only land on the GPU node) runs the same forward there; its supervisor
    ends with it, and the idle node goes."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.autoscaler.launcher import ClusterLauncher
    from ray_tpu_torch.job import JobSubmissionClient
    from ray_tpu_torch.util.state import list_actors

    before = port_processes()
    launcher = ClusterLauncher(autoscale_config(os.path.join(work, "state")))
    line = {}
    try:
        address = launcher.up()
        launcher.autoscaler.config.upscale_delay_s = AUTOSCALE_UPSCALE_S
        provider = launcher.provider
        rt.init(address=address)
        line["head_gpu"] = rt.cluster_resources().get("GPU", 0.0)
        jobs = JobSubmissionClient(address)

        def gpu_node_alive() -> bool:
            ids = {provider.raylet_node_id(p) for p in provider.non_terminated_nodes()}
            return any(n["node_id"] in ids and n["state"] == "ALIVE" for n in rt.nodes())

        def job_done() -> bool:
            return jobs.get_job_status(sid) in ("SUCCEEDED", "FAILED", "STOPPED")

        t0 = time.perf_counter()
        ref = rt.remote(num_gpus=1)(cluster_forward).remote(SEED + 14)
        time.sleep(2 * AUTOSCALE_UPSCALE_S)
        line["pending_on_head"] = (not provider.non_terminated_nodes()
                                   and not rt.wait([ref], num_returns=1, timeout=0)[0])
        line["scale_up"] = scale_until(launcher, gpu_node_alive, "GPU node up", 120)
        (pid,) = provider.non_terminated_nodes()
        node_id = provider.raylet_node_id(pid)
        line["demand_to_registered_s"] = time.perf_counter() - t0
        out = rt.get(ref, timeout=600)
        line["task_s"] = time.perf_counter() - t0
        t_job = time.perf_counter()
        sid, _ = launcher.submit(f"{sys.executable} -c \"import sys; sys.path.insert(0, "
                                 f"{ROOT!r}); import chip_smoke; chip_smoke.job_main()\"",
                                 wait=False)
        line["while_job_runs"] = scale_until(launcher, job_done, "job finished", 600)
        line["job_s"] = time.perf_counter() - t_job
        logs = jobs.get_job_logs(sid)
        status = jobs.get_job_status(sid)
        check(status == "SUCCEEDED", f"the job ended {status}: {logs[-3000:]}")
        job = json.loads([x for x in logs.splitlines() if x.startswith("JOB_RESULT ")][-1][11:])
        t_end = time.perf_counter()
        supervisor = {}
        while time.perf_counter() - t_end < 30:
            supervisor = [a for a in list_actors()
                          if a.get("name") == f"_job_supervisor:{sid}"][0]
            if supervisor["state"] == "DEAD":
                break
            time.sleep(0.1)
        line["supervisor"] = {"state": supervisor["state"], "node": supervisor.get("node_id"),
                              "dead_after_s": time.perf_counter() - t_end}
        line["stop_finished_job"] = jobs.stop_job(sid)
        line["scale_down"] = scale_until(launcher, lambda: not provider.non_terminated_nodes(),
                                         "idle GPU node down", AUTOSCALE_IDLE_S + 60)
        line["idle_to_terminated_s"] = line["scale_down"]["s"]
        line.update({"gpu_node": node_id, "task_node": out["node"], "task_device": out["device"],
                     "bitwise_equal_to_bare": bool(torch.equal(out["logp"], bare["logp"].cpu())),
                     "max_abs_diff_vs_bare": max_err(out["logp"], bare["logp"].cpu()),
                     "task_launches": out["launches"], "job_node": job["node"],
                     "job_launches": job["launches"],
                     "job_digest_equal_to_bare": job["digest"] == digest(bare["logp"]),
                     "job_forbidden_modules": job["forbidden_modules"]})
    finally:
        launcher.down()
        rt.shutdown()
    deadline = time.monotonic() + 30
    while port_processes() - before and time.monotonic() < deadline:
        time.sleep(0.2)
    line["left_processes"] = sorted(port_processes() - before)
    check(line["head_gpu"] == 0.0 and line["pending_on_head"],
          f"the GPU task did not wait on the head alone: {line}")
    check(out["node"] == node_id and job["node"] == node_id,
          f"the GPU work ran on {out['node']} and {job['node']}, not the launched node {node_id}")
    check(line["supervisor"]["state"] == "DEAD" and line["supervisor"]["node"] == node_id,
          f"the job's supervisor is {line['supervisor']}, not DEAD on the GPU node {node_id}")
    check(line["stop_finished_job"] is False, "stop_job on the finished job did not return False")
    check(line["bitwise_equal_to_bare"], f"the autoscaled node's log-probs differ from the bare "
                                         f"forward's by {line['max_abs_diff_vs_bare']}")
    check(line["job_digest_equal_to_bare"], "the job's log-probs differ from the bare forward's")
    check(not job["forbidden_modules"], f"the job's driver imported {job['forbidden_modules']}")
    check(out["launches"]["fwd"] == GPT2_SMALL["n_layers"],
          f"the task launched B1 {out['launches']['fwd']} times, not once a layer")
    got = [(line[k]["launched"], line[k]["terminated"])
           for k in ("scale_up", "while_job_runs", "scale_down")]
    check(got == [(1, 0), (0, 0), (0, 1)], f"launched, terminated per stage: {got}")
    check(not line["left_processes"], f"port processes left after down: {line['left_processes']}")
    return line


def ray_perf_run(work: str, name: str, *argv) -> tuple:
    """`python -m ray_tpu_torch._private.ray_perf --json <work>/<name>.json
    *argv`: (its results, its seconds)."""
    perf_json = os.path.join(work, f"{name}.json")
    t0 = time.perf_counter()
    perf = subprocess.run([sys.executable, "-m", "ray_tpu_torch._private.ray_perf", "--json",
                           perf_json, *argv], cwd=ROOT, capture_output=True, text=True,
                          timeout=900, env={**os.environ, "RAY_TPU_OBJECT_STORE_EVICTION_GRACE_S":
                                            str(PERF_EVICTION_GRACE_S)})
    seconds = time.perf_counter() - t0
    check(perf.returncode == 0 and os.path.exists(perf_json),
          f"ray_perf {argv} exited {perf.returncode}: {perf.stdout[-2000:]} {perf.stderr[-3000:]}")
    with open(perf_json) as f:
        return json.load(f), seconds


def perf_run(work: str, host: tuple) -> dict:
    """15c: ray_perf on the card, every key of the reference's main and the
    CUDA keys above 0, as one `--device cuda` run gives them: `host` is the
    host benches' (results, seconds) from host_checks (`--device cpu`), and
    the device suites run here (`--device-only`). Then those keys and
    loadgen's smoke through benchmarks/perf_gate.py against its floors,
    whose misses are data (the floors are a 1-core Xeon's)."""
    from ray_tpu_torch._private import ray_perf

    device, device_s = ray_perf_run(work, "perf_device", "--device-only")
    results = {**host[0], **device}
    perf_json, serve_json = os.path.join(work, "perf.json"), os.path.join(work, "serve.json")
    with open(perf_json, "w") as f:
        json.dump(results, f, indent=2)
    want = ray_perf.result_keys(os.path.join(ROOT, "ray_tpu_torch", "_private", "ray_perf.py"))
    want |= set(ray_perf.CUDA_KEYS)
    t1 = time.perf_counter()
    serve = subprocess.run([sys.executable, "-m", "ray_tpu_torch.loadgen", "--smoke", "--json",
                            serve_json], cwd=ROOT, capture_output=True, text=True, timeout=600)
    check(serve.returncode == 0, f"loadgen --smoke exited {serve.returncode}: "
                                 f"{serve.stderr[-3000:]}")
    loadgen_s = time.perf_counter() - t1
    gate = subprocess.run([sys.executable, os.path.join("benchmarks", "perf_gate.py"), perf_json,
                           serve_json], cwd=ROOT, capture_output=True, text=True, timeout=120)
    misses = [x.strip() for x in gate.stderr.splitlines() if x.startswith("  ")]
    line = {"ray_perf_host_s": host[1], "ray_perf_device_s": device_s, "loadgen_s": loadgen_s,
            "results": results,
            "gate_rc": gate.returncode, "gate_misses": misses, "gate_table": gate.stdout,
            "host_cpus": os.cpu_count(), "host_cpu": cpu_model()}
    check(set(host[0]).isdisjoint(device), f"ray_perf's host and device keys overlap: {results}")
    check(want <= set(results), f"ray_perf lacks {sorted(want - set(results))}")
    check(all(v > 0 for k, v in results.items()), f"ray_perf values not above 0: "
          f"{ {k: v for k, v in results.items() if not v > 0} }")
    check(not any("error" in k for k in results), f"ray_perf error keys: {results}")
    check(gate.returncode in (0, 1) and (gate.returncode == 0) == (not misses),
          f"perf_gate exited {gate.returncode}: {gate.stdout[-2000:]} {gate.stderr[-2000:]}")
    return line


def cpu_model() -> str:
    with open("/proc/cpuinfo") as f:
        names = [x.split(":", 1)[1].strip() for x in f if x.startswith("model name")]
    return names[0] if names else "unknown"


def scale_out_phase(host: dict) -> dict:
    """Phase 15: the runtime's native extensions (15a), an autoscaled GPU
    node (15b) and ray_perf with its gate (15c; its host benches ran in
    host_checks). Returns the flash launches of 15b's task and job (the
    bare run here is not counted)."""
    t_phase = time.perf_counter()
    work = os.path.join(ROOT, "build", "chip_smoke_scale_out")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        line = {"phase": "scale_out", "15a": native_run(work)}
        emit({"phase": "scale_out", "part": "15a", **line["15a"]})
        bare = cluster_forward(SEED + 14)
        line["15b"] = autoscale_run(work, bare)
        emit({"phase": "scale_out", "part": "15b", **line["15b"]})
        line["15c"] = perf_run(work, host["15c"])
    finally:
        shutil.rmtree(work, ignore_errors=True)
    launches = {key: line["15b"]["task_launches"][key] + line["15b"]["job_launches"][key]
                for _, key, _ in KERNELS}
    emit({"phase": "scale_out", "part": "15c", **line["15c"]})
    emit({"phase": "scale_out", "launches": launches, "nvidia_smi": card()["nvidia_smi"],
          "15a_build_s": line["15a"]["build_s"],
          "15a_native_ab_misses": line["15a"]["native_ab_misses"], "15b_times_s": {
              k: line["15b"][k] for k in ("demand_to_registered_s", "task_s", "job_s",
                                          "idle_to_terminated_s")},
          "15c_gate_misses": line["15c"]["gate_misses"],
          "seconds": time.perf_counter() - t_phase})
    check(launches["fwd"] > 0, "B1 was not launched in phase 15")
    return launches


def lint_run() -> dict:
    """16a: `python -m ray_tpu_torch.devtools.lint`, the port's static gate
    over its own tree: clean, within the gate's budget, each pass's seconds."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "ray_tpu_torch.devtools.lint"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    timing = [x for x in out.stdout.splitlines() if re.match(r"lint: [0-9.]+s wall", x)]
    passes = dict(re.findall(r"([a-z-]+) ([0-9.]+)s", timing[-1].split("(", 1)[1])) \
        if timing else {}
    check(out.returncode == 0 and "lint: clean" in out.stdout,
          f"the lint gate exited {out.returncode}: {out.stdout[-3000:]} {out.stderr[-2000:]}")
    check(len(passes) == 8, f"the gate's timing line names {sorted(passes)}, not its 8 passes")
    return {"rc": out.returncode, "wall_s": wall,
            "gate_s": float(timing[-1].split()[1].rstrip("s")),
            "pass_s": {k: float(v) for k, v in passes.items()}}


def chaos_cli(work: str, *argv, timeout: float = 300) -> list:
    """`python -m ray_tpu_torch.chaos` with `argv`: its exit code and its
    output lines, each with the seconds since the line before it; the
    runtime's own log (stderr) goes to a file under `work`."""
    with open(os.path.join(work, "chaos_stderr.log"), "a") as err:
        proc = subprocess.Popen([sys.executable, "-u", "-m", "ray_tpu_torch.chaos", *argv],
                                cwd=ROOT, stdout=subprocess.PIPE, stderr=err, text=True,
                                start_new_session=True)
        lines, last, t0 = [], time.perf_counter(), time.perf_counter()
        try:
            for raw in proc.stdout:
                now = time.perf_counter()
                lines.append((raw.rstrip("\n"), now - last))
                last = now
                check(now - t0 < timeout, f"chaos {argv} ran past {timeout} s")
            rc = proc.wait(timeout=max(1.0, timeout - (time.perf_counter() - t0)))
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, 9)
                proc.wait()
    return [rc, lines]


def chaos_run(work: str) -> dict:
    """16b: the chaos CLI's smoke suite over CHAOS_SEEDS seeds (every
    invariant must hold on every seed: each seed's fault count and the
    seconds from the line before its own to it), then its determinism
    check on one scenario, whose digests must be the ones that run used."""
    rc, lines = chaos_cli(work, "--suite", "smoke", "--seeds", str(CHAOS_SEEDS), "--no-corpus")
    seeds, scenario = [], None
    for text, dt in lines:
        head = re.match(r"chaos scenario (\w+):", text)
        if head:
            scenario = head.group(1)
        seed = re.match(r"\s+seed\s+(\d+) (ok|FAIL)\s+faults=(\d+)\s+schedule=(\w+)", text)
        if seed:
            seeds.append({"scenario": scenario, "seed": int(seed.group(1)),
                          "ok": seed.group(2) == "ok", "faults": int(seed.group(3)),
                          "schedule": seed.group(4), "s": dt})
    out = "\n".join(text for text, _ in lines)
    check(rc == 0 and "every invariant held" in out, f"chaos smoke exited {rc}: {out[-3000:]}")
    from ray_tpu_torch.chaos.runner import SUITES

    check(len(seeds) == len(SUITES["smoke"]) * CHAOS_SEEDS and all(s["ok"] for s in seeds),
          f"chaos smoke seeds: {seeds}")
    drc, dlines = chaos_cli(work, "--check-determinism", "--scenario",
                            CHAOS_DETERMINISM_SCENARIO, "--seeds", str(CHAOS_SEEDS), timeout=60)
    again = {int(m.group(1)): m.group(2) for m in (
        re.match(r"\s+\w+ seed (\d+): (\w+) deterministic", text) for text, _ in dlines) if m}
    ran = {s["seed"]: s["schedule"] for s in seeds if s["scenario"] == CHAOS_DETERMINISM_SCENARIO}
    same = sorted(ran) == sorted(again) and all(again[k].startswith(ran[k]) for k in ran)
    check(drc == 0 and same, f"the determinism check gave {again} (rc {drc}), the run {ran}")
    return {"seeds": seeds, "determinism": {"scenario": CHAOS_DETERMINISM_SCENARIO,
                                            "digests": again, "same_as_run": same}}


def nemesis_forward(seed: int, log_path: str, hold_path=None) -> bytes:
    """16c's task: 14a's forward on `seed`, its last-position log-probs as
    bytes. Each forward that returns appends its launches, process and node
    to `log_path`. With `hold_path`, an attempt that finds no such file
    writes its pid there once it is inside its forward and forwards on until
    it is killed (NEMESIS_HOLD_S at most, then it raises)."""
    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    model, tokens = forward_inputs(seed)
    if hold_path is not None and not os.path.exists(hold_path):
        with open(hold_path + ".tmp", "w") as f:
            f.write(str(os.getpid()))
        os.replace(hold_path + ".tmp", hold_path)
        deadline = time.monotonic() + NEMESIS_HOLD_S
        while time.monotonic() < deadline:
            last_logp(model, tokens)
        raise RuntimeError(f"no nemesis killed pid {os.getpid()} in {NEMESIS_HOLD_S} s")
    fa.reset_launches()
    logp = last_logp(model, tokens)
    with open(log_path, "a") as f:
        f.write(json.dumps({"seed": seed, "pid": os.getpid(), "launches": dict(fa.launches),
                            "node": os.environ.get("RAY_TPU_NODE_ID")}) + "\n")
    return logp.cpu().numpy().tobytes()


def worker_pick(cluster, pid: int):
    """The pick with which the Nemesis's kill_worker hits the worker of
    process `pid`: its index among the live workers in the order kill_worker
    takes them (by node id, then worker id); None if it is not there."""
    live = [h.proc.pid for nid in sorted(cluster.raylets)
            for _, h in sorted(cluster.raylets[nid].workers.items())
            if h.proc is not None and h.proc.returncode is None]
    return live.index(pid) if pid in live else None


def nemesis_run(work: str) -> dict:
    """16c: the port's Nemesis against GPU work. A Cluster whose head has no
    GPU and one added {GPU: 1} node; 14a's forward as num_gpus=1 tasks with
    NEMESIS_RETRIES retries. (1) kill_worker on the first task's worker while
    it is inside its forward: the retry's answer is the bare forward's,
    bitwise. (2) A second task's answer is left on the GPU node unfetched,
    kill_raylet takes that node, a replacement {GPU: 1} node joins, and the
    get rebuilds the answer by lineage, bitwise the bare forward's. (3) Then
    every raylet's leases and store settle, no acknowledged answer is lost,
    and the replacement shows GPU available 1.0."""
    import hashlib

    import ray_tpu_torch as rt
    from ray_tpu_torch.chaos import invariants
    from ray_tpu_torch.chaos.nemesis import Nemesis
    from ray_tpu_torch.cluster_utils import Cluster

    bare = {s: last_logp(*forward_inputs(s)).cpu().numpy().tobytes() for s in NEMESIS_SEEDS}
    log_path, hold_path = os.path.join(work, "forwards.jsonl"), os.path.join(work, "hold.pid")
    line, before = {}, port_processes()
    t0 = time.perf_counter()
    cluster = Cluster(head_node_args={"num_cpus": 2, "num_gpus": 0})
    try:
        gpu_node = cluster.add_node(num_cpus=2, num_gpus=1)
        cluster.connect()
        nemesis = Nemesis(cluster)
        task = rt.remote(num_gpus=1, max_retries=NEMESIS_RETRIES)(nemesis_forward)

        ref1 = task.remote(NEMESIS_SEEDS[0], log_path, hold_path)
        while not os.path.exists(hold_path):
            check(time.perf_counter() - t0 < 300, "the first task never reached its forward")
            time.sleep(0.05)
        with open(hold_path) as f:
            victim = int(f.read())
        time.sleep(NEMESIS_IN_FORWARD_S)
        pick = worker_pick(cluster, victim)
        check(pick is not None, f"the first task's process {victim} is no live worker")
        t_kill = time.perf_counter()
        fired = cluster._run(nemesis.fire("kill_worker", pick))
        answer1 = rt.get(ref1, timeout=600)
        line["kill_worker"] = {"fired": fired, "victim_pid": victim,
                               "kill_to_answer_s": time.perf_counter() - t_kill,
                               "bitwise_equal_to_bare": answer1 == bare[NEMESIS_SEEDS[0]]}

        ref2 = task.remote(NEMESIS_SEEDS[1], log_path)
        ready, _ = rt.wait([ref2], num_returns=1, timeout=600)  # located, not fetched
        check(bool(ready), "the second task did not finish")
        t_kill = time.perf_counter()
        fired = cluster._run(nemesis.fire("kill_raylet", 0))  # the head is protected
        replacement = cluster.add_node(num_cpus=2, num_gpus=1)
        answer2 = rt.get(ref2, timeout=600)
        line["kill_raylet"] = {"fired": fired, "killed_node": gpu_node.node_id,
                               "replacement_node": replacement.node_id,
                               "kill_to_answer_s": time.perf_counter() - t_kill,
                               "bitwise_equal_to_bare": answer2 == bare[NEMESIS_SEEDS[1]]}

        cluster._run(invariants.quiesce(cluster, timeout=60))
        violations = [str(v) for r in cluster.raylets.values()
                      for v in invariants.check_leases(r) + invariants.check_store(r)]
        ledger = [(ref, hashlib.sha256(bare[s]).hexdigest(), "task")
                  for ref, s in zip((ref1, ref2), NEMESIS_SEEDS)]
        violations += [str(v) for v in invariants.check_no_data_loss(rt, ledger, timeout_s=300)]
        line["violations"] = violations
        line["replacement_gpu_available"] = replacement.available.to_dict().get("GPU")
        line["actions_fired"] = list(nemesis.actions_fired)
    finally:
        cluster.shutdown()
    deadline = time.monotonic() + 30
    while port_processes() - before and time.monotonic() < deadline:
        time.sleep(0.2)
    line["left_processes"] = sorted(port_processes() - before)
    with open(log_path) as f:
        forwards = [json.loads(x) for x in f]
    line["forwards"] = [(f["seed"], f["node"][:8], f["launches"]["fwd"]) for f in forwards]
    line["launches"] = {key: sum(f["launches"][key] for f in forwards) for _, key, _ in KERNELS}
    line["seconds"] = time.perf_counter() - t0
    check(line["actions_fired"] == ["kill_worker", "kill_raylet"]
          and line["kill_worker"]["fired"] is not None and line["kill_raylet"]["fired"]
          == f"kill_raylet {gpu_node.node_id[:8]}", f"the nemesis fired {line}")
    check(line["kill_worker"]["bitwise_equal_to_bare"],
          "the retried answer differs from the bare forward's")
    check(line["kill_raylet"]["bitwise_equal_to_bare"],
          "the answer rebuilt by lineage differs from the bare forward's")
    check(not violations, f"invariants violated after the nemesis: {violations}")
    check(line["replacement_gpu_available"] == 1.0,
          f"the surviving GPU node has GPU {line['replacement_gpu_available']} available")
    # The retry and the second task on the GPU node; then rebuilds on the
    # replacement: the second answer's, and any other whose only copy went
    # with the killed node (the data-loss check's get rebuilds it).
    ran = [f[:2] for f in line["forwards"]]
    want = [(NEMESIS_SEEDS[0], gpu_node.node_id[:8]), (NEMESIS_SEEDS[1], gpu_node.node_id[:8])]
    check(ran[:2] == want and (NEMESIS_SEEDS[1], replacement.node_id[:8]) in ran[2:]
          and all(f[1] == replacement.node_id[:8] for f in ran[2:]),
          f"the forwards that returned ran as {line['forwards']}: not {want}, then rebuilds on "
          f"the replacement node {replacement.node_id[:8]}, the second answer's among them")
    check(all(f[2] == GPT2_SMALL["n_layers"] for f in line["forwards"]),
          f"a forward launched B1 other than once a layer: {line['forwards']}")
    check(not line["left_processes"], f"port processes left: {line['left_processes']}")
    return line


def host_checks() -> dict:
    """The checks that touch no card: 16a, 16b and 15c's host benches
    (`ray_perf --device cpu`: its results and seconds), one after another.
    main runs them on a thread of their own under phases 1-7 (the build,
    and work whose numbers the card sets: phase 2 holds the stream while it
    queues) and reads them in phases 15 and 16. The device suites of 15c
    and 16c run there, with the host to themselves."""
    t0 = time.perf_counter()
    work = os.path.join(ROOT, "build", "chip_smoke_host")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        out = {"16a": lint_run(), "16b": chaos_run(work),
               "15c": ray_perf_run(work, "perf_host", "--device", "cpu")}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {**out, "seconds": time.perf_counter() - t0}


def chaos_phase(host: dict) -> dict:
    """Phase 16: the port's lint gate (16a), the chaos CLI's smoke suite and
    determinism check (16b), both run in host_checks, and the Nemesis
    against GPU work (16c). Returns the flash launches of 16c's forwards
    that returned (the killed attempt's and the bare runs here are not
    counted)."""
    t_phase = time.perf_counter()
    work = os.path.join(ROOT, "build", "chip_smoke_chaos")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        lint, chaos = host["16a"], host["16b"]
        emit({"phase": "chaos", "part": "16a", **lint})
        emit({"phase": "chaos", "part": "16b", **chaos})
        nemesis = nemesis_run(work)
        emit({"phase": "chaos", "part": "16c", **nemesis})
    finally:
        shutil.rmtree(work, ignore_errors=True)
    emit({"phase": "chaos", "launches": nemesis["launches"], "nvidia_smi": card()["nvidia_smi"],
          "16a_gate_s": lint["gate_s"],
          "16b_seed_s": [round(s["s"], 2) for s in chaos["seeds"]],
          "16c_kill_to_answer_s": {k: nemesis[k]["kill_to_answer_s"]
                                   for k in ("kill_worker", "kill_raylet")},
          "seconds": time.perf_counter() - t_phase})
    check(nemesis["launches"]["fwd"] > 0, "B1 was not launched in phase 16")
    return nemesis["launches"]


# ---------------------------------------------------------------- phase 17

@contextlib.contextmanager
def pad_copies(fa):
    """{"pad": n, "cut": n}: the copies the padded route (fa._pad, fa._cut)
    makes while the block runs, each call's outputs that are not its
    inputs."""
    counts = {"pad": 0, "cut": 0}
    pad, cut = fa._pad, fa._cut

    def counting_pad(width, *xs):
        out = pad(width, *xs)
        counts["pad"] += sum(o is not x for o, x in zip(out, xs))
        return out

    def counting_cut(x, head_dim):
        out = cut(x, head_dim)
        counts["cut"] += out is not x
        return out

    fa._pad, fa._cut = counting_pad, counting_cut
    try:
        yield counts
    finally:
        fa._pad, fa._cut = pad, cut


def example_steps(dev, profiled: bool = False) -> dict:
    """17a's run on `dev`: examples/train_transformer.py's loop, ported:
    EXAMPLE's weights and then a new batch of EXAMPLE_BATCH sequences each
    step, all drawn from one generator (SEED + 31), EXAMPLE_STEPS AdamW(3e-4)
    steps, then the loss of one more batch without gradients (an eval: B1
    once a layer). Returns the losses, the eval loss, the mean step ms and
    the flash launches, by kernel and by the width each ran at;
    `profiled`, also one more step's flash kernels by the profiler's names
    and the padded route's copies in it (pad_copies), after the counts are
    read."""
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.models import transformer as tr

    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    cfg = tr.TransformerConfig(**EXAMPLE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 31)
    init_state, step = tr.make_train_step(cfg, dev)
    state = init_state(gen)
    fa.reset_launches()
    losses = []

    def batch():
        raw = torch.randint(0, cfg.vocab_size, (EXAMPLE_BATCH, cfg.max_seq_len + 1), device=dev,
                            generator=gen)
        return {"tokens": raw[:, :-1].contiguous(), "targets": raw[:, 1:].contiguous()}

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(EXAMPLE_STEPS):
        state, m = step(state, batch())
        losses.append(m["loss"])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / EXAMPLE_STEPS * 1e3
    with torch.no_grad():
        eval_loss = float(tr.transformer_loss(state["model"], batch()))
    out = {"losses": [float(x) for x in losses], "eval_loss": eval_loss, "step_ms": step_ms,
           "launches": dict(fa.launches), "launches_by_width": dict(fa.launches_by_width)}
    if profiled:
        with pad_copies(fa) as copies, profile(activities=[ProfilerActivity.CUDA]) as prof:
            step(state, batch())
            torch.cuda.synchronize()
        out.update(flash_kernels=flash_kernel_names(prof), pad_copies=copies)
    return out


def example_loop(config) -> None:
    """17a's train loop in a runtime worker: example_steps on get_device()."""
    from ray_tpu_torch import train
    from ray_tpu_torch.train.torch import get_device

    dev = get_device()
    run = example_steps(dev)
    train.report({"summary": {**run, "device": str(dev), "forbidden_modules": forbidden_modules()}})


def example_run(dev) -> dict:
    """17a: the JAX package's example through a one-worker GPU TorchTrainer,
    its losses bitwise those of the same run bare here."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.air import RunConfig, ScalingConfig
    from ray_tpu_torch.train.torch import TorchTrainer

    bare = example_steps(dev, profiled=True)
    storage = os.path.join(ROOT, "build", "chip_smoke_example")
    shutil.rmtree(storage, ignore_errors=True)
    t0 = time.time()
    rt.init(num_cpus=2)
    try:
        result = TorchTrainer(
            example_loop, train_loop_config={},
            scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
            run_config=RunConfig(name="example", storage_path=storage)).fit()
    finally:
        rt.shutdown()
        shutil.rmtree(storage, ignore_errors=True)
    worker = result.metrics_history[-1]["summary"]
    line = {"config": {k: str(v) for k, v in EXAMPLE.items()},
            "head_dim": EXAMPLE["d_model"] // EXAMPLE["n_heads"], "batch": EXAMPLE_BATCH, "steps": EXAMPLE_STEPS, "bare": bare,
            "worker": worker, "fit_s": time.time() - t0,
            "loss_bitwise_equal_to_bare": (worker["losses"] == bare["losses"]
                                           and worker["eval_loss"] == bare["eval_loss"]),
            # a new batch of uniform tokens each step: the loss only nears ln(vocab)
            "mean_loss_first_last_5": [sum(bare["losses"][:5]) / 5, sum(bare["losses"][-5:]) / 5]}
    emit({"phase": "head_dims", "part": "17a", **line})
    check(worker["device"].startswith("cuda") and not worker["forbidden_modules"],
          f"17a's worker ran on {worker['device']} with {worker['forbidden_modules']}")
    check(all(math.isfinite(x) for x in bare["losses"] + [bare["eval_loss"]]), "17a: a loss is not finite")
    check(line["loss_bitwise_equal_to_bare"], f"17a: the worker's losses are not the bare run's: "
                                              f"{worker['losses']} against {bare['losses']}")
    check(worker["launches"] == bare["launches"] and worker["launches"]["bwd_dkv"] > 0,
          f"17a: launches {worker['launches']} against the bare run's {bare['launches']}")
    # Head dim 32 runs natively: every launch at 32, the profiled step's
    # flash kernels all *_sm90<32, ...> ones, and no pad or cut copy in it.
    width = line["head_dim"]
    check(all(key.endswith(f"@{width}") for key in worker["launches_by_width"])
          and bare["flash_kernels"] and all(f"_sm90<{width}," in n for n in bare["flash_kernels"])
          and not any(bare["pad_copies"].values()),
          f"17a: not every flash kernel ran at head dim {width} without a pad: {worker['launches_by_width']}, "
          f"{bare['flash_kernels']}, {bare['pad_copies']}")
    return worker["launches_by_width"]


def wide_model_run(tr, fa, part: str, widths: dict, dev, gen, phase: str = "head_dims") -> dict:
    """17b, 17c, 18a or 18d: a model of `widths` (cut to WIDE_LAYERS layers) at
    WIDE_BATCH x WIDE_SEQ: the bf16 logits and the first step's gradients
    through the kernels and through the plain attention, each against the
    same weights in f32 (phases 3 and 4's bounds); then a warm-up and
    WIDE_STEPS make_train_step steps on one batch, tokens/s and MFU, and
    two more profiled (profile_phase). Returns the flash launches of all
    but the profiled steps (the logits' B1 too) by width."""
    from ray_tpu_torch.device import peak_bf16_flops

    cfg = tr.TransformerConfig(**widths, n_layers=WIDE_LAYERS, max_seq_len=WIDE_SEQ,
                               dtype=torch.bfloat16, remat=True)
    raw = torch.randint(0, cfg.vocab_size, (WIDE_BATCH, WIDE_SEQ + 1), device=dev, generator=gen)
    batch = {"tokens": raw[:, :-1].contiguous(), "targets": raw[:, 1:].contiguous()}
    model = tr.transformer_init(cfg, gen, device=dev)
    head = {"phase": phase, "part": part, "head_dim": cfg.head_dim,
            "reduced": {"n_layers": WIDE_LAYERS, "seq": WIDE_SEQ, "batch": WIDE_BATCH}}
    logits_check(tr, fa, cfg, dev, model, batch["tokens"], {**head, "check": "logits"})
    grads_check(tr, cfg, dev, model, batch, {**head, "check": "grads"})
    init_state, step = tr.make_train_step(cfg, dev)
    state = init_state(model=model)
    torch.cuda.reset_peak_memory_stats()
    before = dict(fa.launches_by_width)  # the logits' and the first gradients' (logits_check reset them)
    state, m = step(state, batch)  # warm-up
    losses = [m["loss"]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(WIDE_STEPS):
        state, m = step(state, batch)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / WIDE_STEPS * 1e3
    losses = [float(x) for x in losses]
    launches = dict(fa.launches_by_width)
    per_step = {k: (n - before.get(k, 0)) / (WIDE_STEPS + 1) for k, n in launches.items()}
    tokens_per_s = WIDE_BATCH * WIDE_SEQ / step_ms * 1e3
    peak = peak_bf16_flops(torch.cuda.get_device_name(0))
    line = {**head, "params": sum(p.numel() for p in state["model"].parameters()),
            "losses": losses, "step_ms": step_ms, "tokens_per_s": tokens_per_s,
            "useful_mfu": tr.flops_per_token(cfg, WIDE_SEQ) * tokens_per_s / peak,
            "hardware_mfu": tr.hardware_flops_per_token(cfg, WIDE_SEQ) * tokens_per_s / peak,
            "peak_flops": peak, "max_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
            "launches_per_step": per_step, "launches": launches}
    emit(line)
    profile_phase(lambda: step(state, batch), step_ms, phase=f"{phase}_{part}_profile")
    del state, model
    gc.collect()
    torch.cuda.empty_cache()
    check(all(math.isfinite(x) for x in losses), f"{part}: a loss is not finite")
    check(losses[-1] < losses[0], f"{part}: the loss did not fall: {losses}")
    check(line["hardware_mfu"] < 1.0, f"{part}: hardware-MFU is not below 1")
    check(launches.get(f"bwd_dkv@{fa.kernel_width(cfg.head_dim)}", 0) > 0,
          f"{part}: the kernels at head dim {cfg.head_dim} were not launched: {launches}")
    return launches


def served_wide_batch(tr, fa, dev) -> dict:
    """17d: one served batch (SERVE_MAX_BATCH prompts of SERVE_PROMPT_LENS
    tokens, right-padded, inference_mode) at 17b's widths: its device ms
    and the B1 launches it makes. Returns the launches by width."""
    cfg = tr.TransformerConfig(**PHI3_MINI, n_layers=WIDE_LAYERS, max_seq_len=WIDE_SEQ,
                               dtype=torch.bfloat16)
    model = tr.transformer_init(cfg, torch.Generator(device=dev).manual_seed(SEED + 33), device=dev)
    prompts = serve_prompts(SERVE_MAX_BATCH, SEED + 33, cfg.vocab_size)
    times = batch_times(tr, model, prompts, dev)
    fa.reset_launches()
    logp, _ = serve_batch(tr, model, prompts, dev)
    launches = dict(fa.launches_by_width)
    emit({"phase": "head_dims", "part": "17d", "head_dim": cfg.head_dim, **times,
          "launches": dict(fa.launches), "launches_by_width": launches})
    del model
    check(logp.shape == (len(prompts), cfg.vocab_size) and bool(torch.isfinite(torch.from_numpy(logp)).all()),
          "17d: the served log-probs are not finite")
    check(fa.launches["fwd"] == cfg.n_layers and launches.get(f"fwd@{cfg.head_dim}") == cfg.n_layers,
          f"17d: B1 at head dim {cfg.head_dim} was not launched once a layer: {launches}")
    return launches


def head_dims_phase(tr, fa, dev) -> dict:
    """Phase 17: the kernels at the JAX package's example's, Phi-3-mini's and
    Gemma-2B's head dims (32, 96, 256). Returns the flash launches of
    17a's worker, 17b-17c's steps and 17d's batch, by width."""
    t0 = time.perf_counter()
    parts = {"17a": example_run(dev)}
    gen = torch.Generator(device=dev).manual_seed(SEED + 32)
    parts["17b"] = wide_model_run(tr, fa, "17b", PHI3_MINI, dev, gen)
    parts["17c"] = wide_model_run(tr, fa, "17c", GEMMA_2B, dev, gen)
    parts["17d"] = served_wide_batch(tr, fa, dev)
    launches = {}
    for counts in parts.values():
        for key, n in counts.items():
            launches[key] = launches.get(key, 0) + n
    emit({"phase": "head_dims", "launches_by_width": launches, "nvidia_smi": card()["nvidia_smi"],
          "seconds": time.perf_counter() - t0})
    return launches


# ---------------------------------------------------------------- phase 18

def forward_times(run) -> dict:
    """A no-grad forward `run()` (18b, 18c): its host ms (the mean of two
    runs after a warm-up, the card synchronised at the ends), and from one
    profiled run its device ms and launches, the flash kernels' device ms
    and names, and the device's idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2):
        run()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / 2 * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    device_ms = sum(e.time_range.elapsed_us() / 1e3 for e in device)
    return {"host_ms": host_ms, "device_ms": device_ms, "idle_share": 1 - device_ms / host_ms,
            "device_launches": len(device),
            "flash_device_ms": sum(e.time_range.elapsed_us() / 1e3 for e in device
                                   if kernel_family(e.name).startswith("flash")),
            "flash_kernels": flash_kernel_names(prof)}


def scoring_batch(tr, fa, dev) -> dict:
    """18b: one no-grad forward of SCORE_BATCH x SCORE_SEQ tokens at 17b's
    widths through transformer_apply, B * H = 66,560 heads in one B1 call
    a layer: its host ms (mean of two runs, synchronised), device ms and
    launches (one profiled run), and its f32 logits held by phase 3's
    ratios: no further from the same weights in f32 than the plain
    attention in bf16 is. The references run in SCORE_CHUNKS chunks of the
    batch (each sequence's attention is its own). Returns the launches by
    width."""
    cfg = tr.TransformerConfig(**PHI3_MINI, n_layers=WIDE_LAYERS, max_seq_len=SCORE_SEQ,
                               dtype=torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(SEED + 41)
    model = tr.transformer_init(cfg, gen, device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (SCORE_BATCH, SCORE_SEQ), device=dev, generator=gen)

    def score():
        with torch.no_grad():
            return tr.transformer_apply(model, tokens)

    times = forward_times(score)  # each run's logits are dropped at once: one is 17 GB
    fa.reset_launches()
    logits = score()
    torch.cuda.synchronize()
    launches, by_width = dict(fa.launches), dict(fa.launches_by_width)

    refs = {}
    for name, c in (("plain_bf16", dataclasses.replace(cfg, attention_impl="torch")),
                    ("f32", dataclasses.replace(cfg, attention_impl="torch", dtype=torch.float32))):
        refs[name] = tr.Transformer(c, dev)
        refs[name].load_state_dict(model.state_dict())
    err = {name: {"max": 0.0, "sum": 0.0} for name in ("kernel_bf16", "plain_bf16")}
    f32_max = 0.0
    with torch.no_grad():
        for rows in torch.arange(SCORE_BATCH, device=dev).chunk(SCORE_CHUNKS):
            truth = tr.transformer_apply(refs["f32"], tokens[rows])
            f32_max = max(f32_max, float(truth.abs().max()))
            for name, x in (("kernel_bf16", logits[rows]),
                            ("plain_bf16", tr.transformer_apply(refs["plain_bf16"], tokens[rows]))):
                e = (x - truth).abs()
                err[name]["max"] = max(err[name]["max"], float(e.max()))
                err[name]["sum"] += float(e.sum(dtype=torch.float64))
                del e
            del truth
    n = logits.numel()
    errs = {name: {"max_abs_err": e["max"], "mean_abs_err": e["sum"] / n} for name, e in err.items()}
    heads = SCORE_BATCH * cfg.n_heads
    line = {"phase": "wide", "part": "18b", "head_dim": cfg.head_dim, "batch": SCORE_BATCH,
            "seq": SCORE_SEQ, "heads_per_call": heads, "shape": list(logits.shape), **times,
            "vs_f32": errs, "f32_max_abs": f32_max, "ratio_bounds": [LOGITS_MEAN_RATIO, LOGITS_MAX_RATIO],
            "launches": launches, "launches_by_width": by_width,
            "max_memory_gib": torch.cuda.max_memory_allocated() / 2**30}
    emit(line)
    finite = bool(torch.isfinite(logits).all())
    del logits, refs, model
    gc.collect()
    torch.cuda.empty_cache()
    check(finite, "18b: logits are not finite")
    k, p = errs["kernel_bf16"], errs["plain_bf16"]
    check(k["mean_abs_err"] <= LOGITS_MEAN_RATIO * p["mean_abs_err"]
          and k["max_abs_err"] <= LOGITS_MAX_RATIO * p["max_abs_err"],
          f"18b: kernel-path logits further from f32 than the plain path's: {errs}")
    check(launches == {"fwd": cfg.n_layers, "fwd_lse": 0, "bwd_dq": 0, "bwd_dkv": 0}
          and by_width == {f"fwd@{cfg.head_dim}": cfg.n_layers} and heads > 65535,
          f"18b: B1 was not launched once a layer on {heads} heads: {launches}, {by_width}")
    return by_width


def stream_phase(tr, fa, dev) -> dict:
    """18c: the streamed forward on the model's paths. (a) WIDE_1024 (head
    dim 1024, bf16): a no-grad forward's logits held by phase 3's ratios
    against the plain attention's (logits_check), B1 at 1024 once a layer;
    (b) WIDE_512 built in f32: a no-grad forward through the split pass and
    the streamed forward at P = 2 within F32_LOGITS_ATOL of the plain f32
    path (f32_forward_check), by kernel name no CUDA-core forward; then the
    first step's f32 gradients (f32_grads_check: B2-B4 on the streamed
    kernels, by kernel name none on the CUDA cores). Each prints its host
    and device ms and launches. Returns {"a": launches by width, "b": f32 launches of the
    forward, "b_step": f32 launches of the step, "b_step_by_width": the
    step's launches by width}."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 43)
    reduced = {"n_layers": WIDE_LAYERS, "seq": WIDE_SEQ, "batch": WIDE_BATCH}
    out = {}
    cfg = tr.TransformerConfig(**WIDE_1024, n_layers=WIDE_LAYERS, max_seq_len=WIDE_SEQ, dtype=torch.bfloat16)
    n = cfg.n_layers
    model = tr.transformer_init(cfg, gen, device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (WIDE_BATCH, WIDE_SEQ), device=dev, generator=gen)
    head = {"phase": "wide", "part": "18c_a", "head_dim": cfg.head_dim, "reduced": reduced}
    launches = logits_check(tr, fa, cfg, dev, model, tokens, {**head, "check": "logits"})
    out["a"] = dict(fa.launches_by_width)
    with torch.no_grad():
        times = forward_times(lambda: tr.transformer_apply(model, tokens))
    emit({**head, **times, "launches": launches, "launches_by_width": out["a"]})
    check(launches == {"fwd": n, "fwd_lse": 0, "bwd_dq": 0, "bwd_dkv": 0} and out["a"] == {f"fwd@{cfg.head_dim}": n},
          f"18c(a): B1 at head dim {cfg.head_dim} was not launched once a layer: {launches}, {out['a']}")
    check(times["flash_kernels"] == ["fwd_kernel_sm90_stream<1, true, false>"],
          f"18c(a) ran {times['flash_kernels']}")
    del model
    gc.collect()
    torch.cuda.empty_cache()

    cfg = tr.TransformerConfig(**WIDE_512, n_layers=WIDE_LAYERS, max_seq_len=WIDE_SEQ, dtype=torch.bfloat16)
    model = tr.transformer_init(cfg, gen, device=dev)
    raw = torch.randint(0, cfg.vocab_size, (WIDE_BATCH, WIDE_SEQ + 1), device=dev, generator=gen)
    batch = {"tokens": raw[:, :-1].contiguous(), "targets": raw[:, 1:].contiguous()}
    head = {"phase": "wide", "part": "18c_b", "head_dim": cfg.head_dim, "reduced": reduced}
    out["b"] = f32_forward_check(tr, fa, cfg, dev, model, batch["tokens"], {**head, "check": "f32_logits"})
    f32_cfg = dataclasses.replace(cfg, attention_impl="kernel", dtype=torch.float32)
    kernel = tr.Transformer(f32_cfg, dev)
    kernel.load_state_dict(model.state_dict())
    with torch.no_grad():
        times = forward_times(lambda: tr.transformer_apply(kernel, batch["tokens"]))
    del kernel
    emit({**head, **times, "f32_launches": out["b"]})
    check(sorted(times["flash_kernels"]) == ["fwd_kernel_sm90_stream<2, true, false>", "split_kernel"],
          f"18c(b)'s f32 forward ran {times['flash_kernels']}")
    plain = tr.Transformer(dataclasses.replace(f32_cfg, attention_impl="torch"), dev)
    plain.load_state_dict(model.state_dict())
    truth = first_grads(tr, plain, batch)
    del plain
    out["b_step"] = f32_grads_check(tr, cfg, dev, model, batch, truth, {**head, "check": "f32_grads"})
    out["b_step_by_width"] = dict(fa.launches_by_width)
    del model, truth
    gc.collect()
    torch.cuda.empty_cache()
    return out


def wide_phase(tr, fa, dev) -> tuple:
    """Phase 18: head dim 512 through a train step (18a), 66,560 heads in
    one call through a scoring forward (18b), the streamed kernels on the
    model's paths (18c: head dim 1024 without gradients, and f32 at 512)
    and head dim 1024 through a train step (18d). Returns the flash launches
    of each, by width (18c's as stream_phase returns them)."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 42)
    train = wide_model_run(tr, fa, "18a", WIDE_512, dev, gen, phase="wide")
    scoring = scoring_batch(tr, fa, dev)
    t_stream = time.perf_counter()
    stream = stream_phase(tr, fa, dev)
    t_train_1024 = time.perf_counter()
    train_1024 = wide_model_run(tr, fa, "18d", WIDE_1024, dev, torch.Generator(device=dev).manual_seed(SEED + 44),
                                phase="wide")
    emit({"phase": "wide", "launches_by_width": {"18a": train, "18b": scoring, "18c": stream, "18d": train_1024},
          "nvidia_smi": card()["nvidia_smi"], "seconds": time.perf_counter() - t0,
          "18c_seconds": t_train_1024 - t_stream, "18d_seconds": time.perf_counter() - t_train_1024})
    return train, scoring, stream, train_1024


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    started = time.perf_counter()
    # The package comes from the checkout this script sits in, and nowhere else.
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ray_tpu_torch.ops import _build

    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    tr = importlib.import_module("ray_tpu_torch.models.transformer")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)

    info = card()
    emit({"phase": "card", **info})

    # The checks that touch no card go on under phases 1-7 (this process
    # built the runtime's native extensions at its import above, as 15a
    # wants, before any of them starts).
    host_lane = ThreadPoolExecutor(max_workers=1)
    host_done = host_lane.submit(host_checks)
    host_lane.shutdown(wait=False)

    t0 = time.perf_counter()
    kernel_ab = importlib.import_module("ray_tpu_torch.ops.kernel_ab")
    # One nvcc a library, all at once; the stamped build, which only phase
    # 2's last step loads, goes on compiling under phase 2's cases.
    pool = ThreadPoolExecutor()
    timeline_built = pool.submit(kernel_ab.timeline_library)
    for built in [pool.submit(_build.build, name) for name in _build.sources()]:
        built.result()
    pool.shutdown(wait=False)
    emit({"phase": "build", "sources": _build.sources(), "seconds": time.perf_counter() - t0,
          "kernels": build_report(_build)})

    cfg = tr.TransformerConfig(**GPT2_SMALL)
    # Phase 2's cases beyond its first ones draw from their own generators.
    gen_more = torch.Generator(device=dev).manual_seed(SEED + 2)
    gen_widths = torch.Generator(device=dev).manual_seed(SEED + 30)
    gen_wider = torch.Generator(device=dev).manual_seed(SEED + 40)
    gen_stream = torch.Generator(device=dev).manual_seed(SEED + 50)
    gen_scale = torch.Generator(device=dev).manual_seed(SEED + 60)
    gen_narrow = torch.Generator(device=dev).manual_seed(SEED + 70)
    t_kernels = time.perf_counter()
    kernel_cases(fa, dev, gen, gen_more, gen_widths, gen_wider, gen_stream, gen_scale, gen_narrow)
    heads_cases(fa, dev, gen_wider)
    rows = {64: kernel_timings(fa, dev, gen, cfg)}
    kernel_timings(fa, dev, gen_more, cfg, batch=4 * BATCH)  # the bench's batch: emitted, not in the line
    # Phase 17's shapes at batch 4 (the example's at its batch 8), bf16.
    for widths, batch, seq in ((PHI3_MINI, 4, WIDE_SEQ), (GEMMA_2B, 4, WIDE_SEQ),
                               (EXAMPLE, EXAMPLE_BATCH, EXAMPLE["max_seq_len"])):
        wide = tr.TransformerConfig(**{**widths, "dtype": torch.bfloat16})
        rows[wide.head_dim] = kernel_timings(fa, dev, gen_widths, wide, batch=batch, seq=seq)
    # The example's widths at batch 16 and T 2048 ([128, 2048, 32]), where
    # the kernels at 32, not the launch, set the time.
    kernel_timings(fa, dev, gen_narrow, tr.TransformerConfig(**EXAMPLE), batch=16, seq=WIDE_SEQ)
    # Phase 18's: 18a's at batch 4 ([16, 2048, 512]), the same at head dim
    # 320 (padded to 512), and 18b's call of 66,560 heads, bf16.
    rows[512] = kernel_timings(fa, dev, gen_wider, tr.TransformerConfig(**WIDE_512), batch=4, seq=WIDE_SEQ)
    kernel_timings(fa, dev, gen_wider, tr.TransformerConfig(**{**WIDE_512, "d_model": 1280}),
                   batch=4, seq=WIDE_SEQ)
    rows["bh"] = kernel_timings(fa, dev, gen_wider, tr.TransformerConfig(**PHI3_MINI),
                                batch=SCORE_BATCH, seq=SCORE_SEQ)
    # The f32 kernels (TF32 off for SDPA too; B1-B4 on the tensor cores
    # through the split passes, at 512 on the streamed kernels) at
    # GPT-2 small's shape (phase 3's f32 forward: its row goes in the line),
    # 17c's and 18a's, then at head dim 128 ([96, 1024, 128], GPT-2 small's
    # batch and heads at d_model 1536; bf16 too) and 17b's ([128, 2048, 96]).
    f32_rows = {}
    for widths, batch in ((GPT2_SMALL, BATCH), (GEMMA_2B, 4), (WIDE_512, 4)):
        f32 = tr.TransformerConfig(**{**widths, "dtype": torch.float32})
        f32_rows[f32.head_dim] = kernel_timings(fa, dev, gen_widths if widths is not WIDE_512 else gen_wider, f32,
                                                batch=batch, seq=SEQ if widths is GPT2_SMALL else WIDE_SEQ)
    for dtype in (torch.float32, torch.bfloat16):
        kernel_timings(fa, dev, gen_wider, tr.TransformerConfig(**{**GPT2_SMALL, "d_model": 1536,
                                                                    "dtype": dtype}))
    kernel_timings(fa, dev, gen_wider, tr.TransformerConfig(**{**PHI3_MINI, "dtype": torch.float32}),
                   batch=4, seq=WIDE_SEQ)
    # The streamed kernels past 512: 18c(a)'s and 18d's [8, 2048, 1024] and
    # [4, 2048, 2048] (WIDE_512's d_model on one head), bf16 and f32.
    stream_rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        for heads in (2, 1):
            stream = tr.TransformerConfig(**{**WIDE_1024, "n_heads": heads, "n_kv_heads": heads, "dtype": dtype})
            stream_rows[stream.head_dim, dtype] = kernel_timings(fa, dev, gen_stream, stream, batch=4, seq=WIDE_SEQ)
    f32_route(fa, dev)
    # Where B1, B3 and B4 (bf16) and B1 (f32) spend a streamed tile, in SM
    # cycles (the stamped build).
    emit({"phase": "kernels", "timeline_build_wait_s": timed(timeline_built.result)})
    emit({"phase": "kernels", "timeline_cycles": kernel_ab.timeline(dev)})
    emit({"phase": "kernels", "dtype": "float32", "timeline_cycles": kernel_ab.timeline(dev, torch.float32)})
    emit({"phase": "kernels", "seconds": time.perf_counter() - t_kernels})

    tokens = torch.randint(0, cfg.vocab_size, (BATCH, SEQ), device=dev, generator=gen)
    fwd_launches, f32_fwd_launches = forward_phase(tr, fa, cfg, dev, gen, tokens)
    train_launches, run_step, step_ms, f32_step_launches = train_phase(tr, fa, cfg, dev, gen)
    profile_phase(run_step, step_ms)
    del run_step  # phase 4's model and optimizer
    gc.collect()
    torch.cuda.empty_cache()
    trainer_launches = trainer_phase(cfg, dev, _build)
    resnet_phase(dev, gen)
    # The bench's rates and phases 9-16 want the host to themselves.
    host_wait_s = timed(host_done.result)
    host = host_done.result()
    emit({"phase": "host_checks", "seconds": host["seconds"], "wait_s": host_wait_s,
          "16a_s": host["16a"]["wall_s"], "16b_seed_s": [s["s"] for s in host["16b"]["seeds"]],
          "15c_ray_perf_host_s": host["15c"][1]})
    gc.collect()
    torch.cuda.empty_cache()  # the bench's processes need the card's memory
    bench_launches = bench_phase()
    gc.collect()
    torch.cuda.empty_cache()
    mesh_launches = mesh_phase(tr, fa, cfg, dev, gen)
    gc.collect()
    torch.cuda.empty_cache()
    collective_launches = collective_phase()
    rllib_launches = rllib_phase(fa)
    gc.collect()
    torch.cuda.empty_cache()  # the replicas and the trials' workers need the card's memory
    serve_launches = serve_phase(tr, fa, dev)
    gc.collect()
    torch.cuda.empty_cache()
    tune_launches = tune_phase(tr, dev)
    gc.collect()
    torch.cuda.empty_cache()
    cluster_launches = cluster_phase(dev)
    scale_out_launches = scale_out_phase(host)
    chaos_launches = chaos_phase(host)
    gc.collect()
    torch.cuda.empty_cache()
    wide_launches = head_dims_phase(tr, fa, dev)
    gc.collect()
    torch.cuda.empty_cache()
    wide512_launches, scoring_launches, stream_launches, wide1024_launches = wide_phase(tr, fa, dev)
    for key, n in wide512_launches.items():
        wide_launches[key] = wide_launches.get(key, 0) + n

    # One entry a kernel and width the main path launched: phases 3-16 run
    # GPT-2 small's 64 only; phase 17 runs 32 (17a, the example's, with its
    # launches a step), 96 and 256; 18a 512. Each width's numbers are phase
    # 2's at its shape (64: GPT-2 small at batch 8; 32: the example's
    # [64, 256, 32]; 96, 256 and 512: 17b's, 17c's and 18a's at batch 4).
    # B1 at 66,560 heads (18b) has an entry of its own, with phase 2's
    # numbers at [66560, 64, 96].
    kernels = []
    for name, key, replaces in KERNELS:
        n = (fwd_launches[key] + train_launches[key] + trainer_launches[key] + bench_launches[key]
             + mesh_launches[key] + collective_launches[key] + rllib_launches[key]
             + serve_launches[key] + tune_launches[key] + cluster_launches[key]
             + scale_out_launches[key] + chaos_launches[key])
        for width in (32, 64, 96, 256, 512):
            launched = wide_launches.get(f"{key}@{width}", 0) + (n if width == 64 else 0)
            kernels.append({"name": name if width == 64 else f"{name}_d{width}", "route": "cuda",
                            "source": SOURCE, "replaces": replaces, "head_dim": width,
                            "launches": launched, **rows[width][key]})
            if width == 32:  # 17a's alone: B2-B4 in its steps, B1 in its eval
                kernels[-1].update({"launches_per_eval": launched} if key == "fwd"
                                   else {"launches_per_step": launched / EXAMPLE_STEPS})
            check(launched > 0, f"{name} at head dim {width} was not launched on the main path")
        check(n > 0, f"{name} was not launched on the main path")
    launched = scoring_launches.get("fwd@96", 0)
    kernels.append({"name": "flash_fwd_d96_bh66560", "route": "cuda", "source": SOURCE,
                    "replaces": KERNELS[0][2], "head_dim": 96, "heads_per_call": SCORE_BATCH * 32,
                    "launches": launched, **rows["bh"]["fwd"]})
    check(launched > 0, "flash_fwd at 66,560 heads was not launched on the main path")
    # f32 at head dim 64: B1 in phase 3's f32 forward, B2-B4 in 9b's f32
    # ring hops and phase 4's f32 first step, the split pass in all three;
    # phase 2's numbers at [96, 1024, 64] f32 (B3 and B4 on their parts).
    f32_step, f32_64, f32_512 = f32_step_launches, f32_rows[64], f32_rows[512]
    split = f"none: the f32 route's operand split ({KERNELS[0][2]}, :109, :289, :328 at f32)"
    for name, launched, replaces, row in (
            ("flash_fwd_f32", f32_fwd_launches["fwd"], KERNELS[0][2], f32_64["fwd"]),
            ("flash_fwd_lse_f32", mesh_launches["fwd_lse_f32"] + f32_step["fwd_lse"], KERNELS[1][2],
             f32_64["fwd_lse"]),
            ("flash_bwd_dq_f32", mesh_launches["bwd_dq_f32"] + f32_step["bwd_dq"], KERNELS[2][2],
             f32_64["bwd_dq"]),
            ("flash_bwd_dkv_f32", mesh_launches["bwd_dkv_f32"] + f32_step["bwd_dkv"], KERNELS[3][2],
             f32_64["bwd_dkv"]),
            ("split_f32", f32_fwd_launches["split"] + mesh_launches["split_f32"] + f32_step["split"],
             split, f32_64["split"])):
        kernels.append({"name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
                        "head_dim": 64, "dtype": "float32", "launches": launched, **row})
        check(launched > 0, f"{name} was not launched on the main path")
    # The streamed kernels: B1 at head dim 1024 in bf16 (18c(a); phase 2's
    # numbers at [8, 2048, 1024]) and B2-B4 there (18d's train steps), and
    # f32 at 512 (18c(b): B1 in its forward, B2-B4 in its first step, the
    # split pass in both; phase 2's numbers at [16, 2048, 512] f32).
    b, b_step, b_width = stream_launches["b"], stream_launches["b_step"], stream_launches["b_step_by_width"]
    d1024 = stream_rows[1024, torch.bfloat16]
    for name, launched, replaces, head_dim, dtype, row in (
            ("flash_fwd_d1024", stream_launches["a"].get("fwd@1024", 0), KERNELS[0][2], 1024, "bfloat16",
             d1024["fwd"]),
            *((f"{name}_d1024", wide1024_launches.get(f"{key}@1024", 0), replaces, 1024, "bfloat16", d1024[key])
              for name, key, replaces in KERNELS[1:]),
            ("flash_fwd_f32_d512", b["fwd"], KERNELS[0][2], 512, "float32", f32_512["fwd"]),
            ("flash_fwd_lse_f32_d512", b_step["fwd_lse"], KERNELS[1][2], 512, "float32", f32_512["fwd_lse"]),
            ("flash_bwd_dq_f32_d512", b_width.get("bwd_dq@512", 0), KERNELS[2][2], 512, "float32",
             f32_512["bwd_dq"]),
            ("flash_bwd_dkv_f32_d512", b_width.get("bwd_dkv@512", 0), KERNELS[3][2], 512, "float32",
             f32_512["bwd_dkv"]),
            ("split_f32_d512", b["split"] + b_step["split"], split, 512, "float32", f32_512["split"])):
        kernels.append({"name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
                        "head_dim": head_dim, "dtype": dtype, "launches": launched, **row})
        check(launched > 0, f"{name} was not launched on the main path")
    emit({"phase": "total", "seconds": time.perf_counter() - started})
    print(info["nvidia_smi"], flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["name"], "count": info["count"]}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
