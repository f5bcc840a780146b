"""Smoke run of the PyTorch port on one NVIDIA GPU: build, check and time its kernels, serve and train the bundles.

Run from the repository root:

    python3 chip_smoke.py             # one card: every phase below
    python3 chip_smoke.py --cards 4   # a host with 4 cards: phases 1, 2, 31 (on 3 of them), 20, 21, 25 and 32 alone,
                                      # one process per card (NCCL)
    python3 chip_smoke.py --cards 3   # 3 cards: phases 1, 2, 31 and 21 (20 and 25 need a count that divides 128)
    python3 chip_smoke.py --cards 4 --phases spatial,dp,tp --start spawn   # some of them, their workers spawned

Phases, one or more result lines each:
  1. environment: the card (name, power limit), torch / CUDA / nvcc versions; TF32 off.
  2. build: one nvcc per csrc/*.cu for sm_90a, started together, into factorizer_tpu_torch/build/.
  3. K1 (windowed NMF) against its plain PyTorch version at the five stage shapes
     of a batch-2 128^3 forward, f32 and bf16, plus MU, a single zero shift, and the
     factorizer_isles22 shapes (8,64^3,32) and (8,8^3,256) with patches of 4^3: the
     whole forward, and each of its two kernels (the factors pass, the reconstruct
     pass) against its own plain version on the same inputs.
  4. K2 (fused pre-norm MLP) against its plain version at the five block-tail shapes,
     f32 and bf16; twice on one input, bit for bit.
  5. the serving slice: the full-width factorizer_brats23 network (random weights
     from a seed) serves 2 synthetic BraTS-native (1, 4, 240, 240, 155) volumes
     through ensemble_predict, in f32 and in bf16; the launch counters show every
     mixer (two K1 launches: factors, reconstruct) and every block tail on a kernel;
     the first request's logits are
     compared with the same call on the plain versions.
  6. K1 backward against autograd through the plain version: the five stage shapes,
     f32 and bf16, plus MU, a single zero shift, num_grad_steps=2, an input
     with whole windows set to zero, and the two factorizer_isles22 shapes.
  7. K2 backward (dx and the six parameter gradients) against autograd through the
     plain version at the five shapes, f32 and bf16; twice on one input, bit for bit.
  8. the training slice: brats23_network() -> create_train_state -> make_train_step
     takes 1 warm-up and 3 timed steps on a synthetic batch 2 x 128^3, in f32 and in
     bf16; the launch counters show 9 K1 factors, 9 K1 reconstruct, 36 K1 backward, 9 K2
     forward and 9 K2 backward launches per step; the first step's loss and gradients are
     compared with the same step on the plain versions.  Then the same step with the
     bundle's remat: true (brats23_network(remat=True)), f32: 18 K1 factors, 18 K1
     reconstruct and 18 K2 forward launches per step (each stage's forward runs again in
     the backward), 36 K1 backward and 9 K2 backward; its first step's loss, gradient norm
     and every gradient equal bit for bit to those of the step without remat from the same
     seed (the recompute repeats the same launches on the same inputs); s/step and peak
     memory beside the step without it.
  9. K3 (per-sample depthwise convolution) against its plain version, a grouped F.conv{2,3}d: the five
     stage shapes of a batch-2 128^3 Deconver forward (kernel 3^3), f32 and bf16, the FIVES shapes
     (16,512^2,32) and (16,128^2,128) with kernel 7^2, the non-cubic kernels (1,3,5) and (3,1,9), C = 48, an input
     with a quarter all zero, the deconver_isles22 train shape (8,64^3,32), tiles that (2,5x7x9,12) does not
     divide, and the run kernels' shapes: C = 30 f32, C = 20 bf16 and the (3,5,5) weight gradient, each also
     through the per-output kernel; every case asserts the route that conv_plan gives it in both directions, every
     route is reached, and each tiled plan's constants and shared memory agree with csrc/depthwise_conv.cuh
     (ftt_depthwise_conv_tile_query); beside the kernel's time the one
     library call that computes the same function, kernel / library, both also as device time from a CUDA graph of 20
     calls (without the host's launch cost, which dominates at the deep stages), and the launch plan (conv_plan: the
     route, the tile, channels, planes a block, threads, blocks, waves on the card, shared memory); then one line
     naming the cases where the kernel is slower than its library call, per call or on the device (K3 and K3 dw).
 10. K3 dw (the weight gradient) against autograd through the plain version at the same shapes, twice
     on one input bit for bit, and dx and dw through the autograd function (the first case also the summing
     pass's share of the time, from torch.profiler); then the Deconv layer, forward and backward, on an input
     with a quarter all zero, kernels against plain versions.
 11. the Deconver serving slice: deconver_brats23_network() serves 2 synthetic BraTS-native volumes, f32
     and bf16: 27 K3 launches per forward, none of K1 and K2 (the bundle's InstanceNorm tails are stock torch).
 12. the FIVES forward: deconver_fives_network() on (16, 3, 512, 512) f32, 27 K3 launches, logits against
     the plain versions.
 13. the Deconver training slice: 1 warm-up and 3 timed steps, f32 and bf16: 54 forward-kernel launches
     (27 forward, 27 dx) and 27 dw launches per step; the first step against the plain versions.
 14. K4 (NMF of a flat batch of small matrices, rank 1 to 4) against its plain version: the five folded stage
     shapes of the flat factorizer_brats23 forward at batch 2, (n, 8, 512) with n = 131072 ... 512, and the 2-D
     shapes (524288, 8, 64) and (32768, 8, 64), f32 and bf16; MU; ranks 2, 3, 4; (1000, 5, 37) at rank 3;
     (2048, 8, 4096); an input with a quarter of its matrices all zero.  Every case asserts the route that
     nmf_plan gives it (the register kernels at (8, 512) and (8, 64), else the shared-memory kernel) and that
     the library's ftt_nmf_plan_query agrees with the Python mirror, runs twice bit for bit, and is timed per
     call and as device time from a CUDA graph of 20 calls, beside the plan; a register case also runs through
     the shared-memory kernel, against the plain version and timed beside.  Then K4 on the folded windows of a
     (2, 32^3, 32) volume against K1's single-shift windowed_nmf, bit for bit.
 15. K4 backward at rank 1 against autograd through the plain version at the same shapes, with MU,
     num_grad_steps=2 and the zero matrices, with the same checks (the register cases also through the
     shared-memory kernel); rank 2 through the autograd function, whose backward is a recompute in torch
     operations (counted, not a kernel launch).
 16. the flat-route serving slices: brats23_network(factorize_options={"use_windowed": False}) serves a
     2 BraTS-native volumes in f32 and bf16 (9 K4 launches per forward, all on the register route, none of
     K1; logits against the plain versions and against the windowed route from the same seed); a 2-D
     Swin-Factorizer at the FIVES data
     shape, one forward of (16, 3, 512, 512); brats23_network(rank=2), one forward of a window pair;
     factorizer_isles22_network() and deconver_isles22_network() each serve 2 (1, 2, 112, 112, 73) volumes.
 17. the flat-route training slices: the flat factorizer_brats23 step at batch 2 x 128^3, f32 and bf16 (9 K4
     forward and 9 K4 backward launches per step beside K2's, all on the register route), the 2-D step, the
     rank-2 step (9 K4 backward recomputes in torch operations) and the factorizer_isles22 step at batch
     8 x 64^3, f32; each first step against the plain versions.
 18. K5 (K1's two passes on a volume cut into slabs along S1: a halo and the routed factors exchanged) in one
     process, all slabs of a ring held as a list: (2,128^3,32) f32 and bf16 as 4 slabs of 32 rows and as 2 of
     64, the stage shapes (2,64^3,64) and (2,32^3,128), the factorizer_isles22 shape (8,64^3,32) with patches of
     4^3 in 4 slabs, head_dim 4 (the shared-memory solve), MU, a shift list whose first entry moves rows, one that
     moves none (no byte sent), ten shifts, a ring of one, f16; the joined output against the plain version and,
     bit for bit, against K1 on the whole volume; launches, exchanges and bytes sent per ring; a slab of rows that
     the patch does not divide must raise.
 19. K5 backward at the same cases and with num_grad_steps=2: autograd through the slab kernels against
     autograd through the plain version and, bit for bit, against K1's backward on the whole volume.
 20. the spatial slice: two processes on the one card (gloo, halos staged through the host) run stage 0 of
     brats23_network (a FactorizerStage of 32 channels on 128^3, batch 2) with spatial_mesh on slabs of 64
     rows, forward and backward of a sum of squares; the first process gathers the output, the input gradient
     and the summed parameter gradients and holds them against the one-process stage; launches per process.
 21. the data-parallel training slice: two processes on the one card take 1 warm-up and 3 timed steps of
     make_train_step(model, mesh=data_parallel_mesh()) on brats23_network() at global batch 2, f32; loss,
     gradient norm and every parameter against the one-process steps on the whole batch.
     Two processes share one card in 20 and 21: their times show that the path runs, not how it scales.
 22. the training workflow: 5 synthetic BraTS-native cases (4 x (240, 240, 155) float32 and a label {0, 1, 2, 3})
     written as NIfTI files (.nii.gz where that takes under ~10 s, else .nii; timed apart), a datalist of 4 training
     cases (batch 2) and 1 validation case, the bundle's transforms (brats23_transforms) in DataLoaders of
     min(8, cpu_count) threads, and SegmentationTrainer on brats23_network() (full width, float32, the bundle's lr,
     weight decay and warm-up): 3 epochs with a validation at the third and a checkpoint after each, then a second
     trainer on the directory resumes at epoch 3 (state_dict and AdamW state equal bit for bit) and ends at step 8.
     Checked: 9/9/36/9/9 launches per step, the validation volume's launches equal a [slice] volume's, the loop's
     first loss against make_train_step on the same batch from the same weights (bit for bit, else 1e-6), a finite
     mean Dice in [0, 1].  Printed: s/epoch against steps x s/step (CUDA events), the loader's wait per step, the
     validation's s/volume, checkpoint seconds (blocking, background) and restore seconds, peak memory.  The launch
     counters are set to 0 before and after it, so the kernels line leaves it out.
 23. the bundles' YAML programs, unedited, through the port's config parser and CLI: 5 synthetic BraTS-native cases
     (4 train, 1 validation; 2 in the test section); factorizer_brats23's train.yaml for 2 epochs as a
     `python -m factorizer_tpu_torch.bundle run` subprocess (exit 0, step_2.pt, finite losses, Dice in [0, 1]) and
     evaluate.yaml in this process (the metrics files, a native-shape prediction, and Dice equal to Evaluator's on the
     same weights),
     then inference.yaml and inference_aot.yaml in this process over 2 folds: the CUDA graph's files equal the eager
     run's voxel for voxel, eager launches and graph replays asserted, s/volume file to file; deconver_brats23's
     train.yaml for 1 epoch, then the same two inference programs, equal; nnunet_brats23's train.yaml for 1 epoch
     and its inference.yaml in this process (native-shape files, no kernel launch).  Left out of
     the kernels line too.
 24. the baselines, stock PyTorch (cuDNN, cuBLAS): the seven baseline bundles' network_def (nnunet_*: DynUNet,
     segresnet_*: SegResNet, swinunetr_isles22: SwinUNETR), built from the unedited train.yaml through the port's
     ConfigParser with the bundle's seed, each serve 2 requests through ensemble_predict after a warm-up (BraTS-native
     (1, 4, 240, 240, 155) at roi 128^3, ISLES (1, 2, 112, 112, 73) at 64^3; FIVES one forward of (16, 3, 512, 512)),
     take 1 warm-up and 3 timed steps at the bundle's batch x roi in f32 (and in bf16, amp: true, for nnunet_brats23,
     segresnet_brats23 and swinunetr_isles22), and hold their f32 logits on one window against the CPU forward of the
     same weights; UNETR at its canonical configuration takes a forward and the steps at batch 2.  cuDNN's heuristics
     choose the CNNs' convolutions, its timing search (benchmark mode, as SegmentationTrainer runs) SwinUNETR's and
     UNETR's.  s/volume, s/step, peak memory; every launch counter stays 0.
 25. (run after 21) the spatial train step, train_tp.yaml's: two processes on the one card, make_train_step(model,
     mesh=model_parallel_mesh(), spatial_axis="model") on a train state sharded over the model axis as train_tp.yaml's
     trainer holds it (create_train_state(mesh=, model_axis="model"): JAX's param_leaf_rule at 2**14, the weights
     gathered for each step, AdamW on this process's part): factorizer_brats23's network at batch 2 x 128^3 on slabs of 64
     rows and factorizer_isles22's at 8 x 64^3 on slabs of 32 (1 warm-up and 2 steps each), f32;
     launches per step and process by kernel (K5 on the mixers on slabs, K1 on the gathered ones, K2 in every tail;
     K5's tails, exchanges and bytes sent), loss, gradient norm and parameters against the one-process steps on the whole volume as in 21;
     one more step with each exchange timed; then a forward's loss under each gather rule from the same weights (the
     rule, and the slabs thinner than a patch alone gathered) and a step of each, timed.  Then the other
     families' bundles at full width from their unedited network_def, f32, 1 warm-up and 1 step each:
     deconver_brats23, nnunet_brats23 and segresnet_brats23 at 2 x 128^3, swinunetr_isles22 at 8 x 64^3 (cuDNN's
     timing search) and deconver_fives at 16 x 512^2 (slabs of H): loss and gradient norm against the one-process
     step on the same batch, s/step and peak memory per process beside the one-process step's, launches per step and
     process equal to the one-process step's (54 K3 forward and dx, 27 K3 dw for a Deconver), one more step with each
     exchange timed (the convolutions' halos, the norms' slab sums, the gathers, the loss's sums, the gradient
     all-reduce, the weight all-gather and the gradient reduce-scatter, with their bytes).  Each cell prints the
     leaves sharded and the bytes of parameters and AdamW state held between steps per process; factorizer_brats23 and
     deconver_brats23 run their steps in turns in the same worker, sharded, with nothing sharded, sharded again:
     s/step, peak memory, bytes held, the instrumented step's collectives, and the losses and gradient norms (the
     Factorizer's parameters too) of the sharded run against the other (the f32 band of 21).  Then factorizer_brats23
     with model_axis and no spatial step (1 warm-up and 1 step, every process the whole batch on gathered weights):
     launches as one process's, loss against the one-process steps.  Its launches are in the kernels line.
 26. the data-parallel bundle programs: factorizer_brats23's and deconver_brats23's train.yaml + train_multidevice.yaml
     for 1 epoch each through `python -m torch.distributed.run --nproc_per_node 2 -m factorizer_tpu_torch.bundle run`
     on phase 23's cases (each process its 2 of the 4 training cases): exit 0, each process's epoch loss equal, one
     checkpoint, written by the primary; s/epoch beside train.yaml's first epoch in one process.  deconver_brats23's
     runs alone, factorizer_brats23's beside 27 and 32.
 27. the spatial bundle programs: deconver_brats23's train.yaml + train_tp.yaml for 1 epoch the same way (2 spatial
     steps on the 4 cases, no validation), beside factorizer_brats23's, which runs as phase 32; each process reports
     the parameters its state holds sharded (at least one under train_tp.yaml, none under train_multidevice.yaml).
     Both spatial programs' checkpoints are whole, in the one-process format (every model entry and AdamW moment at
     its whole shape), and load through zoo_scripts.load_model_checkpoint; deconver_brats23's inference.yaml runs
     over its checkpoint.  26 and 27 run inside 23's directory and are left out of the kernels line.
 28. (run after 17) the rest of the factorization engine, selected by network_def keys: factorizer_brats23's unedited
     train.yaml network_def through the port's ConfigParser with the bundle's seed (full width, 128^3, f32) under one
     override set at a time: (a) init_method: nndsvd, (b) solver: nnls, (c) solver: [hals-0, mu-1], (d) factorize:
     $ftx.SVD, (e) rank: null and compression: 10 (rank 1 at 8 x 512), (f) pos_embed: each of the sinusoidal, rotary
     and axial embeddings, (g) factorize_options: {eps: 1e-8}.  Each serves 1 BraTS-native volume through
     ensemble_predict after a warm-up (one sliding-window batch instead where a volume would take over 30 s) and takes
     1 warm-up and 2 steps at 2 x 128^3: s/volume, s/step, peak memory; launches per forward and per step asserted
     ((a)-(d) the flat route on stock torch: 9 K2 forward, 9 K2 backward, no K1 and no K4; (e)-(g) the default's
     9 + 9 K1, 9 K2, 36 K1 backward); logits on one window against reference_kernels() ((e)-(g)) or against the CPU
     forward of the same weights ((a)-(d)).  One bf16 step of (a), its solve in f32.  Then the engine's calls at stage
     0's batch of 131072 matrices of 8 x 512 (the randomized SVD, NNDSVD, an nnls iteration; torch.linalg's QR and SVD
     at 2048 for scale), and KMeans, FuzzyCMeans and EntropyKMeans (4 centers) on stage 0's windows of a
     (2, 128^3, 32) activation as points (32768, 512, 8), card against CPU: differing assignments (near ties counted),
     the centers' max relative error, the times.  Its launches are in the kernels line.
 29. (run after 28) the models' remaining options at full width, f32, 2 x 128^3: factorizer_brats23's network_def with
     num_deep_supr: 3 and dropout: 0.1 beside the unedited one, 1 warm-up and 3 steps each (s/step, peak memory;
     launches per step: K1 as the default's, no K2 forward or backward under active dropout), one eval forward of a
     window (9 K2 launches, the three heads' shapes, logits equal bit for bit to the same weights with dropout 0) and one
     BraTS-native volume through ensemble_predict, equal bit for bit to the same weights in a one-head model; the flat
     route with factorize_options {use_windowed: False} against {use_windowed: False, split_shifts: True} (K4 9 and 36
     launches a forward and a step, logits and the first loss against each other, peak memory, the split step against
     reference_kernels()); the generic UNet (DoubleConv blocks, a k3 stem, widths 32...512) plain and with three heads (no
     launch of the port); deconver_brats23's network_def with num_deep_supr: 2 and dropout: 0.1 (54 + 27 K3 a step);
     the unedited network_def under factorize_options {use_pallas: False} (the JAX package's pure-XLA mode: every mixer
     on the stock decompose chain): one eval forward of a window (no K1 and no K4 launch, 9 K2, the logits in the f32
     band of the same weights on the default route, the explain log lines of one forward counted: none for the explicit
     opt-out, 9 under explain), one BraTS-native volume through ensemble_predict, 1 warm-up and 2 steps (no K1 and no K4,
     9 + 9 K2, s/step, peak memory).  Its launches are in the kernels line;
     chip_smoke.options_slice(chip_smoke.kernel_counters()) runs it alone.
 30. (run after 25) the spatial step where the slab paths stop, each cell's processes sharing the one card over gloo,
     the bundle's unedited network_def (with the one override named) at full width, batch and roi, f32, 1 warm-up and 1
     step: deconver_brats23 with update_filter: true at 2 x 128^3 on 2 processes (the filter update's correlations
     summed over the slabs), swinunetr_isles22 with use_v2: true at 8 x 64^3 on 2, swinunetr_isles22 at 8 x 64^3 on 4
     (slabs of 16 rows: its level 5 gathered), factorizer_isles22 at 8 x 64^3 on 8 (slabs of 8 rows: the deepest level
     gathered, K1 on its mixers; an 8-card node's layout).  Each prints the route (parallel.slabs.slab_route), s/step
     and peak memory per process beside the one-process step's, launches per step and process by kernel, loss and
     gradient norm against the one-process step on the same batch (the f32 band of 21 and 25), and for the Deconver
     the first stage's filter fitted on slabs, equal bit for bit on every process.  Then K2 forward and backward at
     the slab shape (2, 64 x 128^2, 32) with their bounds.  Its launches are in the kernels line;
     chip_smoke.slab_gaps_slice() runs it alone after build.library().
 31. (run after 30) the spatial step on slabs of unequal rows: 3 processes sharing the one card over gloo (with
     --cards N, a process a card over NCCL: N of them where N does not divide 128, else 3), the unedited network_def of factorizer_brats23 and of
     deconver_brats23 at 2 x 128^3, f32, 1 warm-up and 2 steps each, on slabs of 48 / 48 / 32 rows (parallel.slabs'
     cut: a grid of 16 rows, its bottleneck's 8).  Each prints the route and the slab rows, s/step and peak memory per
     process by slab rows beside the one-process step's, launches per step and process (K5, K1, K2 for the Factorizer;
     K3 and K3 dw for the Deconver, as in one process), loss and gradient norm against the one-process step on the
     same batch (the f32 band of 30).  Two cells more in the same processes: nnunet_brats23's network_def with
     anisotropic strides (stride 1 along the cut axis) and a deep-supervision head at 2 x 2 x 128^2, more slabs than
     rows (1 / 1 / 0: the whole model gathered, the empty slab in every collective), and the same network_def with
     its three deep-supervision heads at 2 x 16 x 128^2 on 8 / 4 / 4 rows (the third head reads 2 rows, below the
     cut's grid: its output whole on every process); each its route, which outputs are whole, s/step, peak memory and
     the loss against one process.  Then K5 on a ring of (2,128^3,32) cut 48 / 48 / 32 against K1 on the whole
     volume bit for bit, forward and dx, K2 forward and backward at the slab shapes (2,48x128^2,32) and
     (2,32x128^2,32), and K3 and K3 dw at the thinnest haloed slab (2,34x128^2,32), each against its plain version.  Its launches are in the kernels line (launches_uneven); chip_smoke.uneven_slabs_slice() runs it
     alone after build.library(), under a __main__ guard (it spawns processes).
 32. (inside 23, beside 27) [hosts]: factorizer_brats23's train.yaml + train_tp.yaml for 1 epoch under two
     `torch.distributed.run --nnodes 2 --node_rank 0|1 --nproc_per_node 1` agents, two simulated hosts of one process
     sharing the one card: the processes agree on gloo (each host alone has a card for its process), which the
     primary's [distributed] line names with the 2 hosts; exit 0, equal epoch losses, one checkpoint from the primary,
     mean Dice in [0, 1] after a validation of whole volumes on each process; each process's launches, checked per step
     (K5 forward and backward, K1 backward, K2 backward as in 25) and in the kernels line (launches_hosts).  With
     --cards N (N even, dividing 128): 25's factorizer_brats23 and deconver_brats23 cells on 2 simulated hosts of N / 2
     cards (run_processes(hosts=2), each host seeing its own cards) over NCCL, with its default transports and with
     NCCL_P2P_DISABLE=1 NCCL_SHM_DISABLE=1 (the sockets a link between hosts takes): s/step, peak memory and one
     instrumented step's exchanges per process beside 25's one-host numbers of the same run.
The float16 instance of every kernel is checked beside f32 and bf16 at one stage shape each (K1, K1 bwd with and
without all-zero windows, K2, K2 bwd, K3, K3 dw, K4, K4 bwd, K5), with one float16 forward of brats23_network
(`[slice f16]`); MatrixFactorization serves a float16 tensor through K4, and a float64 one raises.
Then a check that no process started here is still alive, the card's line, a JSON line with every kernel, and as the last line
{"ok": true, "device": {...}}.  Any failed check raises, so the exit code is
non-zero and no result line is printed.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import functools
import gc
import json
import math
import re
import statistics
import subprocess
import sys
import time


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_time_ms(fn, warmup: int = 3, runs: int = 15) -> float:
    """Median device time of ``fn()`` over ``runs`` launches, CUDA events, after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_time_ms(fn, calls: int = 20, replays: int = 7) -> float:
    """Median device time of one ``fn()`` from replays of a CUDA graph of ``calls`` calls: the host's launch cost,
    which CUDA events around one call also count, drops out."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    return statistics.median(times)


def dw_sum_share(fn) -> str:
    """K3 dw's device time by kernel over 5 calls of ``fn`` (torch.profiler): the tiled walk and the pass that adds
    the partial sets."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
    walk = adds = 0.0
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0.0)
        if "sum_dw_partials" in ev.key:
            adds += us
        elif "depthwise_conv_dw" in ev.key:
            walk += us
    if walk + adds == 0:
        return "the summing pass: not measured (the profiler saw no device time)"
    return f"the summing pass {adds / 5e3:.4f} ms of {(walk + adds) / 5e3:.4f} ms (torch.profiler, 5 calls)"


def kernel_label(mangled: str) -> str:
    """``prenorm_mlp_bwd_kernel<f32,512,16,16,16>`` from the mangled name ptxas reports."""
    found = re.search(r"\d+((?:windowed_nmf|nmf_reconstruct|prenorm_mlp|sum_partials|depthwise_conv|sum_dw_partials|slab_tail)\w*?_kernel)(?:I(.+?)EEv)?", mangled)
    if not found:
        return mangled
    name, targs = found.groups()
    if not targs:
        return name
    dtype = "bf16" if "bfloat16" in targs else "f16" if "__half" in targs else "f32"
    return f"{name}<{','.join([dtype, *re.findall(r'L[ib](\d+)', targs)])}>"


def dname(dtype) -> str:
    return str(dtype).split(".")[1]


def compare(out, ref) -> tuple[float, float]:
    """(max |out - ref|, that over max |ref|)."""
    diff = (out.float() - ref.float()).abs().max().item()
    return diff, diff / max(ref.float().abs().max().item(), 1e-30)


# Relative tolerances (max |kernel - plain| / max |plain|).  f32: the kernels
# sum in another order than the plain versions' library calls (the NMF solve
# repeats 5 times, the MLP sums over C and 4C terms).  bf16 and f16: both
# compute in f32 and round the output once, so they differ by at most one ulp
# (2^-7 of the largest value in bf16, 2^-10 in f16) where the roundings fall apart.
KERNEL_RTOL = {"float32": 1e-4, "bfloat16": 2.0**-7, "float16": 2.0**-10}
# K1 backward: the reverse sweep repeats the forward's sums and divides by
# the same small denominators, so f32 gets ten times the forward's band; bf16
# and f16 round dx once, as the forward rounds y.
K1_BWD_RTOL = {"float32": 1e-3, "bfloat16": 2.0**-7, "float16": 2.0**-10}
# K2 backward parameter gradients, relative to the gradient's largest entry:
# each entry sums one f32 term per token (4.2 M at stage 0) in the kernel's
# fixed tile order and in the library's own order; either order's rounding
# grows like sqrt(tokens) * 2^-24 of the terms' size, and cancellation leaves
# entries far below that size, so the band is stated against the largest entry.
# Both dtypes sum in f32 from the same inputs.
K2_PARAM_RTOL = 1e-3
# Whole-network logits, kernels against plain versions: the per-layer
# differences above pass through 9 blocks and 9 convolutions.  f16 rounds each
# layer at an eighth of bf16's ulp; its band is under half of bf16's.
SLICE_RTOL = {"float32": 1e-3, "bfloat16": 5e-2, "float16": 2e-2}
# One train step, kernels against plain versions: the loss, the global
# gradient norm and three gradient leaves (relative to each leaf's largest
# entry).  The forward differences above pass back through every layer; in
# bf16 a rounding that falls the other way changes a whole activation by 2^-8.
TRAIN_RTOL = {"float32": {"loss": 1e-4, "grad": 1e-2}, "bfloat16": {"loss": 1e-2, "grad": 1e-1}}

# K3 dw: each entry sums one f32 product per voxel (2.1 M at stage 0) in the kernel's fixed order and in the
# library's; stated against the gradient's largest entry, as K2's parameter gradients are.  The Deconv layer
# with a quarter of its input zero: the update's quotient is eps / eps there and the cotangents pass through
# 1 / (den + eps) ~ 1e16, in kernels and plain versions alike, so f32 gets ten times the kernels' band.
K3_DW_RTOL = 1e-4
DECONV_RTOL = 1e-3

# K4 at rank 2 to 4: HALS sweeps column by column and subtracts sums of nearly equal size
# (a[:, r] - sum_j u[:, j] b[j, r]) before each division, so the order of summation moves the f32 result
# more than at rank 1, where the update is one quotient.  Measured 9e-7, 3e-6 and 2e-5 to 6e-5 at ranks 2, 3
# and 4 (the difference grows with the rank and moves with the input); the band is that of the backward kernels.
K4_RANK_RTOL = 1e-3
# The flat route against the windowed route, whole-network logits from the same weights: the same function.
# f32: two summation orders per mixer, as kernels against plain versions.  bf16: K1 sums the shifts in f32 and
# rounds once, the flat route rounds each shift's reconstruction to bf16 before the mean.
ROUTE_RTOL = {"float32": 1e-3, "bfloat16": 5e-2}

STAGES = [(128, 32), (64, 64), (32, 128), (16, 256), (8, 512)]  # (S, C) at batch 2, roi 128^3
FLAT_STAGES = [131072, 32768, 8192, 2048, 512]  # matrices of (8, 512) per stage: 4 shifts x B*heads x windows
NUM_ITERS = 5
N_BLOCKS, N_SHIFTS = 9, 4  # blocks of the bundles' networks, shifts per mixer

# Published peaks of one H100 SXM at 700 W: HBM bytes/s, and FLOP/s of the
# units a kernel's operations run on: f32 outside the tensor cores, dense TF32,
# bf16 and f16 in them.  A bound takes the peak of the units its kernel runs on.
PEAK_BYTES, PEAK_FLOPS = 3.35e12, {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12, "float16": 989e12}


def bound_ms(n_bytes: float, flops: float, dtype, units: str | None = None) -> tuple[float, str]:
    """The least time the card could take: each input read and output written once, or the operations at the
    peak of ``units`` (default: the activations' dtype)."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES, flops / PEAK_FLOPS[units or dname(dtype)]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def k1_work(x, n_shifts: int, backward: bool, grad_steps: int = NUM_ITERS, mu: bool = False) -> tuple[float, float]:
    """(bytes, flops) of K1 on ``x``, whose solve runs on the f32 CUDA cores whatever the dtype.  Per element
    and shift the solve does two mat-vecs (4 flops) per iteration and the rank-1 product and the shift sum
    (2); the backward adds the seed's two mat-vecs (4) and, per differentiated iteration, two mat-vecs and two
    rank-1 updates of dX (8; MU recomputes one more mat-vec, 10).  Forward: x read once, y written once (the
    kernels read x once per shift and write and read the f32 factors, (d + p^3) / (d p^3) of the volume per
    shift, between their two passes; the bound counts neither).  Backward: x and g read, dx written."""
    n = x.numel()
    flops = 4 * NUM_ITERS + 2
    if backward:
        flops += 4 + (10 if mu else 8) * grad_steps
    return (3 if backward else 2) * n * x.element_size(), float(n_shifts * n * flops)


def k1_pass_work(x, U, V, n_shifts: int, factors: bool) -> tuple[float, float]:
    """(bytes, flops) of one of K1's forward passes.  Factors pass: x read, the factors written, the solve's
    4 flops per element, shift and iteration.  Reconstruct pass: the factors read, y written, the product and
    the shift sum (2 flops per element and shift)."""
    n, f_bytes = x.numel(), 4 * (U.numel() + V.numel())
    if factors:
        return n * x.element_size() + f_bytes, float(n_shifts * n * 4 * NUM_ITERS)
    return f_bytes + n * x.element_size(), float(n_shifts * n * 2)


def k4_work(x, rank: int, backward: bool, grad_steps: int = NUM_ITERS, mu: bool = False) -> tuple[float, float]:
    """(bytes, flops) of K4 on ``x (..., M, N)``.  Per element the solve does two products with the factors
    (4 R flops) per iteration and the reconstruction (2 R); the R x R Gram matrices and the sweeps over a row's
    R columns add 2 R^2 (M + N + 2) / (M N) per element, left out.  The rank-1 backward adds the seed's two
    products (4) and, per differentiated iteration, two products and two rank-1 updates of dX (8; MU 10).
    Forward: x read, y written.  Backward: x and g read, dx written."""
    n = x.numel()
    flops = (4 * NUM_ITERS + 2) * rank
    if backward:
        flops += 4 + (10 if mu else 8) * grad_steps
    return (3 if backward else 2) * n * x.element_size(), float(n * flops)


def k2_work(x, hidden: int, backward: bool) -> tuple[float, float, str]:
    """(bytes, flops, units) of K2 on ``x (..., C)``: two products of 2 C H flops per token forward, five
    backward; x read and y written (backward: x and g read, dx written), the f32 parameters read (and their
    gradients written) once.  The operations are counted at the tensor cores' peak for the activations' type,
    TF32's for f32 and bf16's (f16's) for bf16 (f16), in both directions: the function's products take
    16-bit operands for 16-bit activations, as the JAX kernels' do.  The kernels' three-pass TF32 split
    (which the backward also takes for bf16 and f16, to hold its parameter gradients' band) is their own cost, not work the function needs, so
    it is not counted."""
    import torch

    c = x.shape[-1]
    tokens = x.numel() // c
    n_params = 3 * c + hidden + 2 * c * hidden
    n_bytes = (3 if backward else 2) * x.numel() * x.element_size() + (2 if backward else 1) * 4 * n_params
    flops = float(tokens * (10 if backward else 4) * c * hidden)
    return n_bytes, flops, "tf32" if x.dtype == torch.float32 else dname(x.dtype)


def k3_work(x, taps: int, dw: bool) -> tuple[float, float]:
    """(bytes, flops) of K3 on ``x (B, *S, C)``: one multiply-add per tap and element.  Forward: x read, y
    written, the f32 taps read.  dw: x and g read, the f32 taps' gradient written."""
    n_taps = x.shape[0] * taps * x.shape[-1]
    return 2 * x.numel() * x.element_size() + 4 * n_taps, float(2 * taps * x.numel())

BRATS_SHIFTS = (None, 2, 4, 6)
# Published NVLink rate of an H100 SXM to one neighbour, each way; the halo's time at it is computed, not measured.
NVLINK_BYTES = 450e9


def kernel_counters() -> dict:
    """Kernel name -> (the wrapper that counts its launches, the attribute that holds the count)."""
    from factorizer_tpu_torch.ops.kernels import (
        depthwise_conv, depthwise_conv_dw, nmf_reconstruct, nmf_reconstruct_backward, prenorm_mlp,
        prenorm_mlp_backward, windowed_nmf_backward, windowed_nmf_factors, windowed_nmf_multi_spatial,
        windowed_nmf_reconstruct,
    )

    return {"windowed_nmf_factors": (windowed_nmf_factors, "launches"),
            "windowed_nmf_reconstruct": (windowed_nmf_reconstruct, "launches"),
            "windowed_nmf_bwd": (windowed_nmf_backward, "launches"),
            "prenorm_mlp": (prenorm_mlp, "launches"), "prenorm_mlp_bwd": (prenorm_mlp_backward, "launches"),
            "depthwise_conv": (depthwise_conv, "launches"), "depthwise_conv_dw": (depthwise_conv_dw, "launches"),
            "nmf_reconstruct": (nmf_reconstruct, "launches"), "nmf_reconstruct_bwd": (nmf_reconstruct_backward, "launches"),
            # K4's kernels by route: the register instances at (8, 512) and (8, 64), the shared-memory kernels at any
            # other size
            "nmf_reconstruct_registers": (nmf_reconstruct, "registers_launches"),
            "nmf_reconstruct_shared": (nmf_reconstruct, "shared_launches"),
            "nmf_reconstruct_bwd_registers": (nmf_reconstruct_backward, "registers_launches"),
            "nmf_reconstruct_bwd_shared": (nmf_reconstruct_backward, "shared_launches"),
            "windowed_nmf_slab": (windowed_nmf_multi_spatial, "launches"),
            "windowed_nmf_slab_bwd": (windowed_nmf_multi_spatial, "backward_launches")}


def reset_counters(counters: dict) -> None:
    for wrapper, attr in counters.values():
        setattr(wrapper, attr, 0)


def read_counters(counters: dict) -> dict:
    return {name: getattr(wrapper, attr) for name, (wrapper, attr) in counters.items()}


def synthetic_batch(b: int, c_in: int, c_out: int, size: int, seed: int) -> dict:
    """A ``randn`` image and the labels of a thresholded smooth random field, made on the card from ``seed``."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(seed)
    image = torch.randn(b, c_in, size, size, size, device="cuda", generator=gen)
    field = F.interpolate(torch.randn(b, c_out, 8, 8, 8, device="cuda", generator=gen), size=(size,) * 3,
                          mode="trilinear", align_corners=False)
    return {"image": image, "label": (field > 0.3).float()}


def roi_batch(b: int, c_in: int, c_out: int, roi: tuple, seed: int) -> dict:
    """:func:`synthetic_batch` at a cubic 3-D roi; at any other roi a ``randn`` image and a thresholded smooth field."""
    import torch
    import torch.nn.functional as F

    if len(roi) == 3 and len(set(roi)) == 1:
        return synthetic_batch(b, c_in, c_out, roi[0], seed)
    g = torch.Generator(device="cuda").manual_seed(seed)
    if len(roi) == 2:
        field = F.interpolate(torch.randn(b, c_out, 16, 16, device="cuda", generator=g), size=roi, mode="bilinear")
    else:
        coarse = torch.randn(b, c_out, *(min(8, s) for s in roi), device="cuda", generator=g)
        field = F.interpolate(coarse, size=roi, mode="trilinear", align_corners=False)
    return {"image": torch.randn(b, c_in, *roi, device="cuda", generator=g), "label": (field > 0.3).float()}


def bundle_network(bundle: str, amp: bool = False, overrides: dict | None = None) -> tuple:
    """The bundle's ``network_def`` from its unedited ``train.yaml`` (with ``overrides`` of ``network_def`` keys)
    through the port's ConfigParser, weights from the bundle's seed, built on the card for its roi's rank; and the
    config."""
    from pathlib import Path

    from factorizer_tpu_torch.config import ConfigParser, load_config_files, merge_config
    from factorizer_tpu_torch.utils.helpers import materialize

    configs = Path(__file__).resolve().parent / "zoo" / bundle / "configs"
    cfg = merge_config(load_config_files([configs / "train.yaml"]), {"bundle_root": str(configs.parent), "amp": amp})
    cfg["network_def"].update(overrides or {})
    parser = ConfigParser(cfg)
    parser.seed(cfg["seed"])
    model = materialize(parser["network_def"], len(cfg["roi_size"]))
    check(next(model.parameters()).is_cuda, f"{bundle}: the network did not build on the card")
    return model, cfg


def brats23_stage0(factorize_options=None):
    """Stage 0 of ``brats23_network()`` on its own: one block of 32 channels on 128^3, weights from seed 0."""
    import torch

    from factorizer_tpu_torch.models.factorizer import FactorizerStage
    from factorizer_tpu_torch.ops.reshape import SWMatricize

    return FactorizerStage(
        32, 32, (128, 128, 128), depth=1, pos_embed=False, mlp_ratio=4,
        reshape=(SWMatricize, {"head_dim": 8, "patch_size": 8, "shifts": list(BRATS_SHIFTS)}), act="relu",
        factorize_kwargs=dict(rank=1, num_iters=NUM_ITERS, init_method="uniform", solver="hals"),
        factorize_options=factorize_options, device="cuda", generator=torch.Generator().manual_seed(0),
    )


# The multi-process phases fork their workers from a server that imported torch and the port once: a spawned
# worker would import them itself, ~9 s a process on the card's host.  `--start spawn` spawns them instead.
WORKERS_START = "forkserver"
# The phases that `--cards N` runs, by name: 31, 20, 21, 25, 32.
CARDS_PHASES = ("uneven", "spatial", "dp", "tp", "hosts")
FORKSERVER_PRELOAD = ["torch", "factorizer_tpu_torch", "factorizer_tpu_torch.config", "factorizer_tpu_torch.parallel",
                      "factorizer_tpu_torch.train.trainer", "factorizer_tpu_torch.zoo_scripts"]


def set_workers_start(method: str) -> None:
    """How ``run_processes`` starts the multi-process phases' workers; ``"forkserver"`` starts the server."""
    global WORKERS_START
    WORKERS_START = method
    if method == "forkserver":
        start_forkserver()


def start_forkserver() -> None:
    """Start the server that forks the workers of ``run_processes``: it imports ``FORKSERVER_PRELOAD`` (and never
    touches the card, so its children may) while this process builds the kernels."""
    import multiprocessing
    from multiprocessing import forkserver

    multiprocessing.set_forkserver_preload(FORKSERVER_PRELOAD)
    forkserver.ensure_running()


def stop_forkserver() -> None:
    """Stop the fork server and the resource tracker that it started beside it (none where the workers spawn)."""
    from multiprocessing import forkserver, resource_tracker

    if WORKERS_START == "forkserver":
        forkserver._forkserver._stop()
        resource_tracker._resource_tracker._stop()


def join_group_on_the_card(rank: int, world: int, init_method: str) -> str:
    """A worker's start: TF32 off, and the process group with this process's place on its (simulated) host from
    ``run_processes``.  Where its host has a card for each of its processes each takes its own and the group is
    NCCL's; else all share card 0 and the group is gloo's."""
    import os

    import torch

    from factorizer_tpu_torch.parallel import initialize_distributed

    local_rank, local_world = int(os.environ["LOCAL_RANK"]), int(os.environ["LOCAL_WORLD_SIZE"])
    own_card = torch.cuda.device_count() >= local_world
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    backend = initialize_distributed(init_method, world, rank, local_rank=local_rank, local_world_size=local_world)
    check(backend == ("nccl" if own_card else "gloo") and torch.cuda.current_device() == (local_rank if own_card else 0),
          f"{world} processes, {local_world} a host, on {torch.cuda.device_count()} card(s) a host took {backend} on card "
          f"{torch.cuda.current_device()}")
    return f"{backend}, {'a card per process' if own_card else 'halos and shards staged through the host'}"


def spatial_worker(rank: int, world: int, init_method: str) -> dict:
    """Stage 0 of the bundle with ``spatial_mesh`` on this process's slab: forward and backward of a sum of squares,
    once to warm up and once timed; the first process holds the gathered results against the one-process stage."""
    import torch

    from factorizer_tpu_torch.ops.kernels import windowed_nmf_multi_spatial
    from factorizer_tpu_torch.parallel import all_gather_cat, make_mesh

    backend = join_group_on_the_card(rank, world, init_method)
    mesh = make_mesh({"model": world})
    counters = kernel_counters()
    stage = brats23_stage0({"spatial_mesh": mesh, "spatial_axis": "model"})
    x = torch.randn(2, 128, 128, 128, 32, device="cuda", generator=torch.Generator(device="cuda").manual_seed(41))
    mine = x.chunk(world, 1)[rank].contiguous().requires_grad_(True)
    seconds = []
    for _ in range(2):
        stage.zero_grad(set_to_none=True)
        mine.grad = None
        reset_counters(counters)
        windowed_nmf_multi_spatial.tail_launches = windowed_nmf_multi_spatial.bytes_sent = 0
        windowed_nmf_multi_spatial.exchanges = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = stage(mine)
        (y.float() ** 2).sum().backward()
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    report = {"backend": backend, "seconds": seconds[1], "warmup_seconds": seconds[0], "counts": read_counters(counters),
              "tail_launches": windowed_nmf_multi_spatial.tail_launches, "bytes_sent": windowed_nmf_multi_spatial.bytes_sent,
              "exchanges": windowed_nmf_multi_spatial.exchanges,
              "finite": bool(torch.isfinite(y).all()) and bool(torch.isfinite(mine.grad).all())}
    # Every process takes part in the gathers; the first one alone compares.
    y_all, dx_all = all_gather_cat(y.detach(), mesh, "model", 1), all_gather_cat(mine.grad, mesh, "model", 1)
    grads = {k: p.grad.clone() for k, p in stage.named_parameters()}
    for g in grads.values():
        torch.distributed.all_reduce(g, group=mesh.group("model"))
    if rank == 0:
        whole = brats23_stage0()
        xw = x.clone().requires_grad_(True)
        for _ in range(2):  # warm-up, then timed, as above
            whole.zero_grad(set_to_none=True)
            xw.grad = None
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref = whole(xw)
            (ref.float() ** 2).sum().backward()
            torch.cuda.synchronize()
            report["whole_seconds"] = time.perf_counter() - t0
        report["y"], report["dx"] = compare(y_all, ref.detach()), compare(dx_all, xw.grad)
        report["params"] = {k: compare(grads[k], p.grad)[1] for k, p in whole.named_parameters()}
    return report


def train_dp_worker(rank: int, world: int, init_method: str, settings: dict, n_steps: int, global_batch: int) -> dict:
    """``n_steps`` data-parallel steps of the bundle's network on the whole synthetic batch, one shard per process."""
    import torch

    from factorizer_tpu_torch.parallel import data_parallel_mesh
    from factorizer_tpu_torch.train.trainer import create_train_state, make_train_step
    from factorizer_tpu_torch.zoo_scripts import brats23_network

    backend = join_group_on_the_card(rank, world, init_method)
    torch.backends.cudnn.benchmark = True
    mesh = data_parallel_mesh()
    counters = kernel_counters()
    state = create_train_state(brats23_network(generator=torch.Generator().manual_seed(0)), **settings)
    step = make_train_step(state.model, mesh=mesh)
    batch = synthetic_batch(global_batch, 4, 3, 128, seed=7)
    losses, norms, seconds, counts = [], [], [], []
    for i in range(n_steps):
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
        reset_counters(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        counts.append(read_counters(counters))
        losses.append(metrics["loss"].item())
        norms.append(metrics["grad_norm"].item())
    report = {"backend": backend, "losses": losses, "norms": norms, "seconds": seconds, "counts": counts,
              "peak_memory": torch.cuda.max_memory_allocated()}
    if rank == 0:
        report["params"] = {k: p.detach().cpu() for k, p in state.model.named_parameters()}
    else:  # a digest is enough to show that both processes made the same update
        report["param_sum"] = sum(p.detach().double().sum().item() for p in state.model.parameters())
    return report

def shared_card_note(world: int) -> str:
    import torch

    if torch.cuda.device_count() >= world:
        return f"{world} processes, one card each"
    return f"{world} processes share one card: the time shows that the path runs, not how it scales"


def spatial_slice(world: int) -> dict:
    """Phase 20: ``world`` processes run stage 0 of the bundle on slabs of ``128 / world`` rows; the launches of
    all processes, by kernel."""
    import torch

    from factorizer_tpu_torch.ops.kernels.windowed_sharded import exchange_bytes
    from factorizer_tpu_torch.parallel import run_processes
    from factorizer_tpu_torch.zoo_scripts import brats23_network

    stage_ref, bundle_stage = brats23_stage0(), brats23_network(device="meta").encoder.blocks[0].block
    check({k: v.shape for k, v in stage_ref.state_dict().items()} == {k: v.shape for k, v in bundle_stage.state_dict().items()}
          and stage_ref.blocks[0].fact.windowed == bundle_stage.blocks[0].fact.windowed,
          "spatial: the stage built here is not stage 0 of brats23_network()")
    del stage_ref, bundle_stage
    t0 = time.perf_counter()
    reports = run_processes(spatial_worker, world, timeout=300, start_method=WORKERS_START)
    # per process and mixer: pass A and pass B, a backward pass per shift and one tail; 4 exchanges (forward a halo
    # and the routed factors back, backward two halos and the routed rows back)
    expected = {"windowed_nmf_slab": 2, "windowed_nmf_slab_bwd": N_SHIFTS, "prenorm_mlp": 1, "prenorm_mlp_bwd": 1}
    sent = exchange_bytes((2, 128 // world, 128, 128, 32), 4, 8, 8, BRATS_SHIFTS)
    launches = dict.fromkeys(kernel_counters(), 0)
    for rank, r in enumerate(reports):
        made = {k: v for k, v in r["counts"].items() if v}
        check(r["finite"], f"spatial rank {rank}: non-finite output or gradient")
        check(made == expected and r["tail_launches"] == 1 and r["exchanges"] == 4,
              f"spatial rank {rank}: launches {made}, tails {r['tail_launches']}, exchanges {r['exchanges']}")
        check(r["bytes_sent"] == sent, f"spatial rank {rank}: {r['bytes_sent']} bytes sent, expected {sent}")
        for k, v in r["counts"].items():
            launches[k] += v
    r = reports[0]
    worst = max(r["params"], key=r["params"].get)
    print(f"[spatial] stage 0 of brats23_network() on {world} slabs of {128 // world} rows ({r['backend']}), float32: forward+backward "
          f"{' / '.join(f'{q['seconds']:.4f}' for q in reports)} s per process, one-process stage on the whole volume "
          f"{r['whole_seconds']:.4f} s (warm-up {r['warmup_seconds']:.2f} s; {time.perf_counter() - t0:.1f} s with start-up), "
          f"{sent / 1e6:.1f} MB sent per process in 4 exchanges, launches per process {expected} + 1 tail; gathered against the one-process stage: "
          f"y max_rel={r['y'][1]:.3e} (tol {KERNEL_RTOL['float32']:.1e}) dx max_rel={r['dx'][1]:.3e} (tol {K1_BWD_RTOL['float32']:.1e}) "
          f"parameter gradients summed over processes max_rel={r['params'][worst]:.3e} at {worst} (tol {K2_PARAM_RTOL:.1e}). "
          + shared_card_note(world))
    check(r["y"][1] <= KERNEL_RTOL["float32"] and r["dx"][1] <= K1_BWD_RTOL["float32"] and r["params"][worst] <= K2_PARAM_RTOL,
          f"spatial: differs from the one-process stage: y {r['y']}, dx {r['dx']}, parameters {r['params']}")
    return launches


def train_dp_slice(world: int, settings: dict, n_steps: int) -> dict:
    """Phase 21: ``world`` processes take ``n_steps`` data-parallel steps on a global batch of ``max(2, world)``,
    held against the one-process steps on the whole batch; the launches of all processes and steps, by kernel."""
    import torch

    from factorizer_tpu_torch.parallel import run_processes
    from factorizer_tpu_torch.train.trainer import create_train_state, make_train_step
    from factorizer_tpu_torch.zoo_scripts import brats23_network

    dev = torch.device("cuda", torch.cuda.current_device())
    global_batch = max(2, world)
    t0 = time.perf_counter()
    reports = run_processes(train_dp_worker, world, settings, n_steps, global_batch, timeout=400,
                            start_method=WORKERS_START)
    started = time.perf_counter() - t0
    state = create_train_state(brats23_network(generator=torch.Generator().manual_seed(0)), **settings)
    step = make_train_step(state.model)
    batch = synthetic_batch(global_batch, 4, 3, 128, seed=7)
    ref_losses, ref_norms, ref_seconds = [], [], []
    for _ in range(n_steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        ref_seconds.append(time.perf_counter() - t0)
        ref_losses.append(metrics["loss"].item())
        ref_norms.append(metrics["grad_norm"].item())
    per_step = {"windowed_nmf_factors": N_BLOCKS, "windowed_nmf_reconstruct": N_BLOCKS,
                "windowed_nmf_bwd": N_BLOCKS * N_SHIFTS, "prenorm_mlp": N_BLOCKS, "prenorm_mlp_bwd": N_BLOCKS}
    launches = dict.fromkeys(kernel_counters(), 0)
    for rank, r in enumerate(reports):
        for counts in r["counts"]:
            check({k: v for k, v in counts.items() if v} == per_step, f"train dp rank {rank}: launches {counts}")
            for k, v in counts.items():
                launches[k] += v
        check(r["losses"] == reports[0]["losses"] and r["norms"] == reports[0]["norms"],
              f"train dp: the processes report different metrics: {r['losses']} / {reports[0]['losses']}")
    r = reports[0]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(r["losses"], ref_losses))
    norm_rel = max(abs(a - b) / b for a, b in zip(r["norms"], ref_norms))
    # Each AdamW update moves an entry by about lr whatever the gradient's size, so where a gradient is within
    # rounding of zero the two summation orders may step apart by up to 2 lr per step; elsewhere they agree closely.
    lr = settings["lr"]
    diffs = {k: (r["params"][k].to(dev) - p.detach()).abs() for k, p in state.model.named_parameters()}
    worst = max(diffs, key=lambda k: diffs[k].max().item())
    far = sum((d > 0.1 * lr).sum().item() for d in diffs.values()) / sum(d.numel() for d in diffs.values())
    digest = sum(p.double().sum().item() for p in r["params"].values())
    print(f"[train dp] make_train_step(brats23_network(), mesh=data_parallel_mesh()) ({r['backend']}), global batch {global_batch} x "
          f"128^3, float32: {' / '.join(f'{statistics.mean(q['seconds'][1:]):.4f}' for q in reports)} s/step per process, "
          f"one-process step on the whole batch {statistics.mean(ref_seconds[1:]):.4f} s (after a {r['seconds'][0]:.2f} s warm-up step; "
          f"{started:.1f} s with start-up), peak memory per process {r['peak_memory'] / 2**30:.2f} GiB, loss "
          f"{' -> '.join(f'{v:.6f}' for v in r['losses'])}, launches per step and process {per_step}; against the one-process "
          f"steps on the whole batch: loss rel {loss_rel:.2e} (tol {TRAIN_RTOL['float32']['loss']:.0e}), grad norm rel {norm_rel:.2e} "
          f"(tol {TRAIN_RTOL['float32']['grad']:.0e}), parameters after {n_steps} steps max |diff| {diffs[worst].max().item():.2e} at "
          f"{worst} (tol 2 lr per step = {2 * lr * n_steps:.1e}), share of entries off by more than lr / 10: {far:.2e} (tol 1e-3). "
          + shared_card_note(world))
    check(loss_rel <= TRAIN_RTOL["float32"]["loss"] and norm_rel <= TRAIN_RTOL["float32"]["grad"],
          f"train dp: loss {r['losses']} / {ref_losses}, grad norm {r['norms']} / {ref_norms}")
    check(diffs[worst].max().item() <= 2 * lr * n_steps and far <= 1e-3, f"train dp: parameters differ from the one-process steps: {worst}")
    check(all(abs(q["param_sum"] - digest) <= 1e-9 * abs(digest) for q in reports[1:]),
          "train dp: the processes hold different parameters")
    check(r["losses"][-1] < r["losses"][0], f"train dp: loss did not fall: {r['losses']}")
    return launches


# The spatial step's cases (`[train tp]`): name -> (network factory, global batch, input channels, output channels,
# volume side, patch, shifts, steps after the warm-up).
TP_CASES = {"factorizer_brats23": ("brats23_network", 2, 4, 3, 128, 8, BRATS_SHIFTS, 2),
            "factorizer_isles22": ("factorizer_isles22_network", 8, 2, 1, 64, 4, (None, 1, 2, 3), 2)}
FACTORIZER_WIDTHS = (32, 64, 128, 256, 512)  # encoder_width of both Factorizer bundles, stage by stage
# K5's counters besides its launches, read per step.
K5_IO = ("tail_launches", "exchanges", "bytes_sent")
# The other model families' spatial step: bundle -> (its batch, its roi, steps after the warm-up, cuDNN's
# timing search), each bundle's unedited network_def at full width in f32.  The CNNs take cuDNN's heuristics (its
# search takes minutes for full-width 3-D f32 convolutions with TF32 off), SwinUNETR its search, as in [baselines].
TP_BUNDLES = {"deconver_brats23": (2, (128, 128, 128), 1, False), "nnunet_brats23": (2, (128, 128, 128), 1, False),
              "segresnet_brats23": (2, (128, 128, 128), 1, False), "swinunetr_isles22": (8, (64, 64, 64), 1, True),
              "deconver_fives": (16, (512, 512), 1, False)}


def tp_routes(batch: int, side: int, patch: int, shifts, world: int, itemsize: int = 4) -> tuple[dict, dict]:
    """Per train step and process, the launches of the spatial step of a bundle's Factorizer on ``world`` slabs and
    K5's other counters (``K5_IO``).  Each of the 9 mixers (stages of side 1, 1/2 ... 1/16 and back up, widths
    ``FACTORIZER_WIDTHS``) runs K5, or K1 on the gathered tensor where its slab of ``L`` rows holds no whole number
    of patches or where the all-gather sends fewer bytes, 2 (world - 1) L rows, than K5's exchanges would
    (``exchange_bytes``, the rule of ``FactMixer.gathers``); K2 in every block tail either way.  A K5 mixer launches
    pass A and pass B, a backward pass per shift and one tail, and enters 4 exchanges."""
    from factorizer_tpu_torch.ops.kernels.windowed_sharded import exchange_bytes

    levels = [(side >> i, FACTORIZER_WIDTHS[i]) for i in range(5)]
    levels += [(side >> i, FACTORIZER_WIDTHS[i]) for i in range(3, -1, -1)]
    k5 = sent = 0
    for s, c in levels:
        slab = (batch, s // world, s, s, c)
        k5_bytes = exchange_bytes(slab, itemsize, 8, patch, shifts)
        if slab[1] % patch == 0 and 2 * (world - 1) * s * batch * s * s * c * itemsize >= world * k5_bytes:
            k5 += 1
            sent += k5_bytes
    k1 = len(levels) - k5
    return ({"windowed_nmf_factors": k1, "windowed_nmf_reconstruct": k1, "windowed_nmf_bwd": k1 * N_SHIFTS,
             "prenorm_mlp": N_BLOCKS, "prenorm_mlp_bwd": N_BLOCKS, "windowed_nmf_slab": 2 * k5,
             "windowed_nmf_slab_bwd": k5 * N_SHIFTS},
            {"tail_launches": k5, "exchanges": 4 * k5, "bytes_sent": sent})


def gather_thinner_than_patch(self, x) -> bool:
    """The other gather rule that the spatial step is timed against: gather only a slab that holds no whole number of
    patches, and run K5 everywhere else."""
    return x.shape[1] % self.windowed[1] != 0


def _grad_bytes(params, *_, **__) -> int:
    return sum(p.grad.numel() * p.grad.element_size() for p in params if p.grad is not None)


def _flat_bytes(flat, mesh, axis) -> int:
    return flat.numel() * flat.element_size() * mesh.axis_size(axis)


def _flat_bytes_in(flat, *_) -> int:
    return flat.numel() * flat.element_size()


@contextlib.contextmanager
def exchange_timer(spent: dict):
    """Within the block, each exchange of the spatial step is timed (a synchronize before and after it) into
    ``spent[label] = [seconds, calls, bytes]``: K5's exchanges (halos, routed factors and rows), the convolutions'
    halos (the stem's, every k3's, Deconv's, the resize's), the norms' statistics (``slab_sum``, forward and
    backward), the gathered stages, the loss's sums, the gradient all-reduce, the batch broadcast, and a sharded
    state's weight all-gather and gradient reduce-scatter.  Bytes are counted for the gradient all-reduce, the
    all-gather and the reduce-scatter: the buffer each call reduces or assembles (``n`` times a flat shard buffer
    for the all-gather)."""
    import inspect

    import torch

    import factorizer_tpu_torch.ops.kernels.windowed_sharded as k5
    import factorizer_tpu_torch.parallel.collectives as collectives
    import factorizer_tpu_torch.parallel.sharding as sharding
    import factorizer_tpu_torch.train.losses as losses
    import factorizer_tpu_torch.train.trainer as trainer

    targets = [(k5, "ring_exchange", "K5 exchanges", None), (collectives, "_line_shift", "conv halos", None),
               (collectives._SlabSum, "forward", "norm sums", None), (collectives._SlabSum, "backward", "norm sums", None),
               (collectives, "all_gather_cat", "gathers", None), (losses, "all_reduce_sum", "loss sums", None),
               (trainer, "_sum_grads", "gradient all-reduce", _grad_bytes),
               (trainer, "broadcast_from_first", "batch broadcast", None),
               (sharding, "_all_gather_flat", "weight all-gather", _flat_bytes),
               (sharding, "_reduce_scatter_flat", "gradient reduce-scatter", _flat_bytes_in)]
    saved = []
    for owner, name, label, size in targets:
        fn = getattr(owner, name)
        spent[label] = [0.0, 0, 0]

        def timed(*args, _fn=fn, _label=label, _size=size, **kwargs):
            if _size is not None:
                spent[_label][2] += _size(*args, **kwargs)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(*args, **kwargs)
            torch.cuda.synchronize()
            spent[_label][0] += time.perf_counter() - t0
            spent[_label][1] += 1
            return out

        saved.append((owner, name, inspect.getattr_static(owner, name)))
        setattr(owner, name, staticmethod(timed) if isinstance(owner, type) else timed)
    try:
        yield spent
    finally:
        for owner, name, raw in saved:
            setattr(owner, name, raw)


def gathered(state):
    """A block in which a sharded state's model holds its whole weights (collective on entry); else nothing."""
    return state.shards.gathered() if state.shards is not None else contextlib.nullcontext()


def whole_parameters(state) -> dict:
    """The state's parameters, whole, on the host (collective where the state is sharded)."""
    with gathered(state):
        return {k: p.detach().cpu() for k, p in state.model.named_parameters()}


# The cells that `[train tp]` also runs with nothing sharded, in the same worker after the sharded run, and the
# rule's threshold that shards nothing (above every leaf).
WHOLE_TURNS = ("factorizer_brats23", "deconver_brats23")
NOTHING_SHARDED = 2**62


def train_tp_worker(rank: int, world: int, init_method: str, settings: dict, cells=None, environ=None) -> dict:
    """The spatial step (``make_train_step(model, mesh=model_parallel_mesh(), spatial_axis="model")``) on this
    process's slabs, with the train state sharded over ``model`` as ``train_tp.yaml``'s trainer holds it
    (``create_train_state(mesh=, model_axis="model")``, JAX's rule at 2**14): ``TP_CASES`` in turn, 1 warm-up and
    the case's steps each; launches per step, losses, norms, seconds, peak memory, the bytes of parameters and AdamW
    state held between steps.  After factorizer_brats23's steps: one more step with its exchanges timed, the loss of a
    forward under each gather rule, and a step under each, :func:`gather_thinner_than_patch` then the rule.  Then
    ``TP_BUNDLES`` the same way, each with one more step with its exchanges timed.  ``WHOLE_TURNS``: in turns, the
    same steps once more with nothing sharded (then an instrumented step), then the sharded state's steps again.
    Then factorizer_brats23 with ``model_axis`` and no spatial step: every process the whole batch, 1 warm-up and 1
    step.  ``cells``: only the cases and bundles named, without the gather rules, the turns with nothing sharded and
    the model-axis case; ``environ``: set before the join (NCCL reads it then)."""
    import os

    import torch

    from factorizer_tpu_torch import zoo_scripts
    from factorizer_tpu_torch.models.factorizer import FactMixer
    from factorizer_tpu_torch.ops.kernels import windowed_nmf_multi_spatial
    from factorizer_tpu_torch.parallel import Slabs, model_parallel_mesh, on_slabs, shard_batch
    from factorizer_tpu_torch.train.losses import dice_ce_loss
    from factorizer_tpu_torch.train.trainer import create_train_state, make_train_step, state_bytes

    os.environ.update(environ or {})
    backend = join_group_on_the_card(rank, world, init_method)
    torch.backends.cudnn.benchmark = True
    mesh = model_parallel_mesh()
    counters = kernel_counters()
    report = {"backend": backend, "mesh": dict(mesh.shape)}
    rules = {"rule": FactMixer.gathers, "other": gather_thinner_than_patch}

    def timed_step(state, step, batch):
        reset_counters(counters)
        for attr in K5_IO:
            setattr(windowed_nmf_multi_spatial, attr, 0)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        return (state, metrics, time.perf_counter() - t0, read_counters(counters),
                {attr: getattr(windowed_nmf_multi_spatial, attr) for attr in K5_IO})

    def steps(state, step, batch, n_steps: int, run: dict) -> dict:
        """1 warm-up and ``n_steps`` timed steps into ``run``; the state bytes held after them."""
        for i in range(1 + n_steps):
            state, metrics, seconds, counts, k5_io = timed_step(state, step, batch)
            for key, value in zip(("seconds", "counts", "k5_io", "losses", "norms"),
                                  (seconds, counts, k5_io, metrics["loss"].item(), metrics["grad_norm"].item())):
                run[key].append(value)
            if i:
                run["peak_memory"] = max(run["peak_memory"], torch.cuda.max_memory_allocated())
        torch.cuda.synchronize()
        run["state_bytes"] = state_bytes(state)
        run["sharded"] = 0 if state.shards is None else len(state.shards.names)
        return run

    def instrumented(state, step, batch) -> tuple:
        """One more step with each exchange timed: its seconds and the exchanges' seconds, calls and bytes."""
        spent = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with exchange_timer(spent):
            step(state, batch)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, spent

    def new_run() -> dict:
        return {"losses": [], "norms": [], "seconds": [], "counts": [], "k5_io": [], "peak_memory": 0}

    def whole_turn(make, opt: dict, batch, n_steps: int) -> dict:
        """The same steps from the same weights with nothing sharded, then an instrumented step."""
        gc.collect()
        torch.cuda.empty_cache()
        state = create_train_state(make(), mesh=mesh, model_axis="model", min_weight_size=NOTHING_SHARDED, **opt)
        step = make_train_step(state.model, mesh=mesh, spatial_axis="model")
        run = steps(state, step, batch, n_steps, new_run())
        params = whole_parameters(state)
        run["params" if rank == 0 else "param_sum"] = (
            params if rank == 0 else sum(p.double().sum().item() for p in params.values()))
        run["instrumented"] = instrumented(state, step, batch)
        del state, step
        gc.collect()
        torch.cuda.empty_cache()
        return run

    for name, (factory, b, c_in, c_out, side, _, _, n_steps) in TP_CASES.items():
        if cells is not None and name not in cells:
            continue

        def make(factory=factory):
            return getattr(zoo_scripts, factory)(generator=torch.Generator().manual_seed(0))

        state = create_train_state(make(), mesh=mesh, model_axis="model", **settings)
        step = make_train_step(state.model, mesh=mesh, spatial_axis="model")
        batch = synthetic_batch(b, c_in, c_out, side, seed=7)
        run = steps(state, step, batch, n_steps, new_run())
        params = whole_parameters(state)
        if rank == 0:
            run["params"] = params
        else:  # a digest is enough to show that the processes made the same update
            run["param_sum"] = sum(p.double().sum().item() for p in params.values())
        del params
        if name == "factorizer_brats23":
            run["instrumented"] = instrumented(state, step, batch)
        if name == "factorizer_brats23" and cells is None:
            # The two gather rules: one forward's loss each from the same weights, then steps in turns.
            mine = shard_batch(batch, mesh, data_axis=None, spatial_axis="model")
            run["rule_losses"], run["turns"] = {}, {label: [] for label in rules}
            try:
                for label, rule in rules.items():
                    FactMixer.gathers = rule
                    with torch.no_grad(), gathered(state), on_slabs(state.model, Slabs(mesh, "model")) as model:
                        loss = dice_ce_loss(model(mine["image"]), mine["label"], slabs=Slabs(mesh, "model"))
                    run["rule_losses"][label] = loss.item()
                for label in ("other", "rule"):
                    FactMixer.gathers = rules[label]
                    state, _, seconds, counts, _ = timed_step(state, step, batch)
                    run["turns"][label].append((seconds, torch.cuda.max_memory_allocated(), counts))
            finally:
                FactMixer.gathers = rules["rule"]
        if name in WHOLE_TURNS and cells is None:  # in turns: sharded, whole, sharded again
            run["whole"] = whole_turn(make, settings, batch, n_steps)
            run["again"] = steps(state, step, batch, n_steps, new_run())
        del state, step
        report[name] = run
        del batch
        gc.collect()
        torch.cuda.empty_cache()
    for bundle, (b, roi, n_steps, search) in TP_BUNDLES.items():
        if cells is not None and bundle not in cells:
            continue
        torch.backends.cudnn.benchmark = search
        model, cfg = bundle_network(bundle)
        opt = {"lr": cfg["learning_rate"], "weight_decay": cfg["weight_decay"]}
        state = create_train_state(model, mesh=mesh, model_axis="model", **opt)
        step = make_train_step(state.model, mesh=mesh, spatial_axis="model")
        net = cfg["network_def"]
        batch = roi_batch(b, net["in_channels"], net["out_channels"], roi, seed=7)
        run = steps(state, step, batch, n_steps, new_run())
        params = whole_parameters(state)
        run["param_sum"] = sum(p.double().sum().item() for p in params.values())
        if rank == 0 and bundle in WHOLE_TURNS:
            run["params"] = params
        del params
        run["instrumented"] = instrumented(state, step, batch)
        del model
        if bundle in WHOLE_TURNS and cells is None:  # in turns: sharded, whole, sharded again
            run["whole"] = whole_turn(lambda bundle=bundle: bundle_network(bundle)[0], opt, batch, n_steps)
            run["again"] = steps(state, step, batch, n_steps, new_run())
        del state, step
        report[bundle] = run
        del batch
        gc.collect()
        torch.cuda.empty_cache()
    torch.backends.cudnn.benchmark = True
    if cells is None:
        # model_axis without the spatial step: each process the whole batch (the line's first process's) on the
        # gathered weights, keeping its own part of the same gradient.  cuDNN's heuristics: its timing search of the
        # whole volume's convolutions would take ~20 s of a 2-step case.
        torch.backends.cudnn.benchmark = False
        factory, b, c_in, c_out, side = TP_CASES["factorizer_brats23"][:5]
        state = create_train_state(getattr(zoo_scripts, factory)(generator=torch.Generator().manual_seed(0)),
                                   mesh=mesh, model_axis="model", **settings)
        step = make_train_step(state.model, mesh=mesh, model_axis="model")
        report["model_axis"] = steps(state, step, synthetic_batch(b, c_in, c_out, side, seed=7), 1, new_run())
        del state, step
        gc.collect()
        torch.cuda.empty_cache()
        torch.backends.cudnn.benchmark = True
    return report


def sharded_report(name: str, reports: list, lr: float, n_steps: int) -> None:
    """``[train tp]``'s lines on the sharded state of cell ``name``: the leaves that JAX's rule sharded and the bytes of
    parameters and AdamW state held between steps per process, one instrumented step's weight all-gather and
    gradient reduce-scatter (seconds, calls, MB); for ``WHOLE_TURNS`` the turn with nothing sharded in the same
    worker between two sharded ones: s/step, peak GiB, bytes held and its gradient all-reduce, and the sharded
    run's losses, gradient norms and (``TP_CASES``) parameters after ``n_steps`` steps against it within the f32
    band of 21 (``TRAIN_RTOL``; parameters within 2 lr per step, at most 1e-3 of the entries off by more than
    lr / 10)."""
    r = reports[0][name]
    counts = [q[name]["sharded"] for q in reports]
    check(counts == [r["sharded"]] * len(reports) and r["sharded"] >= 1, f"train tp {name}: sharded leaves {counts}")

    def exchanges(run: dict) -> str:
        total, spent = run["instrumented"]
        return ", ".join(f"{label} {spent[label][0]:.4f} s ({spent[label][1]} calls, {spent[label][2] / 1e6:.1f} MB)"
                         for label in ("weight all-gather", "gradient reduce-scatter", "gradient all-reduce")
                         if spent[label][1]) + f" of {total:.4f} s"

    held = " / ".join(f"{q[name]['state_bytes'] / 1e6:.2f}" for q in reports)
    print(f"[train tp] {name}: sharded state (create_train_state(mesh=, model_axis='model'), JAX's param_leaf_rule "
          f"at 2**14): {r['sharded']} leaves; parameters and AdamW state held between steps per process {held} MB"
          + (f"; process 0's instrumented step: {exchanges(r)}" if "instrumented" in r else ""))
    if "whole" not in r:
        return
    w = r["whole"]
    loss_rel = max(abs(a - c) / abs(c) for a, c in zip(r["losses"], w["losses"]))
    norm_rel = max(abs(a - c) / c for a, c in zip(r["norms"], w["norms"]))
    diffs = {k: (r["params"][k] - p).abs() for k, p in w["params"].items()}
    worst = max(diffs, key=lambda k: diffs[k].max().item())
    far = sum((d > 0.1 * lr).sum().item() for d in diffs.values()) / sum(d.numel() for d in diffs.values())
    digest = sum(p.double().sum().item() for p in w["params"].values())
    print(f"[train tp] {name}: sharded against whole weights ({r['sharded']} leaves against none, the same worker, "
          f"in turns: sharded, whole, sharded again, {n_steps} steps each): s/step per process "
          f"{' / '.join(f'{statistics.mean(q[name]['seconds'][1:]):.4f}' for q in reports)}, whole "
          f"{' / '.join(f'{statistics.mean(q[name]['whole']['seconds'][1:]):.4f}' for q in reports)}, sharded again "
          f"{' / '.join(f'{statistics.mean(q[name]['again']['seconds'][1:]):.4f}' for q in reports)}; peak GiB "
          f"{' / '.join(f'{q[name]['peak_memory'] / 2**30:.2f}' for q in reports)} against "
          f"{' / '.join(f'{q[name]['whole']['peak_memory'] / 2**30:.2f}' for q in reports)}; parameters and AdamW "
          f"state held between steps {held} MB against "
          f"{' / '.join(f'{q[name]['whole']['state_bytes'] / 1e6:.2f}' for q in reports)} MB; process 0's "
          f"instrumented step whole: {exchanges(w)}; loss rel {loss_rel:.2e} (tol {TRAIN_RTOL['float32']['loss']:.0e}), "
          f"grad norm rel {norm_rel:.2e} (tol {TRAIN_RTOL['float32']['grad']:.0e}), parameters max |diff| "
          f"{diffs[worst].max().item():.2e} at {worst} ({'' if name in TP_CASES else 'not checked, as against one process; '}"
          f"tol 2 lr per step = {2 * lr * n_steps:.1e}), share of entries off by more than lr / 10: {far:.2e} (tol 1e-3)")
    check(loss_rel <= TRAIN_RTOL["float32"]["loss"] and norm_rel <= TRAIN_RTOL["float32"]["grad"],
          f"train tp {name}: sharded losses {r['losses']}, norms {r['norms']}, whole {w['losses']}, {w['norms']}")
    # The parameters as the cell's own check against one process holds them (the Factorizer's; a bundle's, loss and
    # norm alone: AdamW turns a sum's last bits into lr-sized steps where a gradient is near zero).
    check(name not in TP_CASES or (diffs[worst].max().item() <= 2 * lr * n_steps and far <= 1e-3),
          f"train tp {name}: sharded parameters differ from the whole-weight turn's at {worst}")
    check(all(q[name]["whole"]["state_bytes"] > q[name]["state_bytes"] for q in reports)
          and all(abs(q[name]["whole"]["param_sum"] - digest) <= 1e-9 * abs(digest) for q in reports[1:]),
          f"train tp {name}: the whole-weight turn's bytes or parameters")


def train_tp_slice(world: int, settings: dict, keep: dict | None = None) -> dict:
    """Phase 25: ``world`` processes take the spatial step of factorizer_brats23 (2 x 128^3) and factorizer_isles22
    (8 x 64^3) on slabs of the volumes' first axis, held against the one-process steps on the whole volumes as
    ``[train dp]`` is; then the two gather rules in turns; then ``TP_BUNDLES`` (the Deconver, DynUNet, SegResNet and
    SwinUNETR bundles), each held against the one-process step on the same batch: loss and gradient norm, the same
    launches per step on every process as in one.  Returns the launches of all processes, by kernel; ``keep``
    receives the processes' reports (``keep["reports"]``) and the one-process steps' losses, seconds and peak
    memory by cell (``keep["one_process"]``)."""
    import torch

    from factorizer_tpu_torch import zoo_scripts
    from factorizer_tpu_torch.parallel import run_processes
    from factorizer_tpu_torch.train.trainer import create_train_state, make_train_step

    dev = torch.device("cuda", torch.cuda.current_device())
    t0 = time.perf_counter()
    reports = run_processes(train_tp_worker, world, settings, timeout=900, start_method=WORKERS_START)
    started = time.perf_counter() - t0
    keep = {} if keep is None else keep
    keep["reports"], keep["one_process"] = reports, {}
    launches = dict.fromkeys(kernel_counters(), 0)
    lr = settings["lr"]
    for name, (factory, b, c_in, c_out, side, patch, shifts, n_steps) in TP_CASES.items():
        state = create_train_state(getattr(zoo_scripts, factory)(generator=torch.Generator().manual_seed(0)), **settings)
        step = make_train_step(state.model)
        batch = synthetic_batch(b, c_in, c_out, side, seed=7)
        ref_losses, ref_norms, ref_seconds = [], [], []
        for i in range(1 + n_steps):
            if i == 1:
                torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            ref_seconds.append(time.perf_counter() - t1)
            ref_losses.append(metrics["loss"].item())
            ref_norms.append(metrics["grad_norm"].item())
        ref_peak = torch.cuda.max_memory_allocated()
        keep["one_process"][name] = {"losses": ref_losses, "seconds": ref_seconds[1:], "peak": ref_peak}
        per_step, k5_io = tp_routes(b, side, patch, shifts, world)
        for rank, report in enumerate(reports):
            r = report[name]
            for counts in r["counts"]:
                check({k: v for k, v in counts.items() if v} == {k: v for k, v in per_step.items() if v},
                      f"train tp {name} rank {rank}: launches {counts}, expected {per_step}")
                for k, v in counts.items():
                    launches[k] += v
            # per K5 mixer and step: one tail, 4 exchanges and exchange_bytes of its slab
            check(all(io == k5_io for io in r["k5_io"]), f"train tp {name} rank {rank}: K5 {r['k5_io']}, expected {k5_io}")
            check(r["losses"] == reports[0][name]["losses"] and r["norms"] == reports[0][name]["norms"],
                  f"train tp {name}: the processes report different metrics: {r['losses']} / {reports[0][name]['losses']}")
        r = reports[0][name]
        loss_rel = max(abs(a - c) / abs(c) for a, c in zip(r["losses"], ref_losses))
        norm_rel = max(abs(a - c) / c for a, c in zip(r["norms"], ref_norms))
        diffs = {k: (r["params"][k].to(dev) - p.detach()).abs() for k, p in state.model.named_parameters()}
        worst = max(diffs, key=lambda k: diffs[k].max().item())
        far = sum((d > 0.1 * lr).sum().item() for d in diffs.values()) / sum(d.numel() for d in diffs.values())
        digest = sum(p.double().sum().item() for p in r["params"].values())
        n_timed = len(r["seconds"]) - 1
        print(f"[train tp] {name}: make_train_step({factory}(), mesh=model_parallel_mesh() {reports[0]['mesh']}, "
              f"spatial_axis='model') ({reports[0]['backend']}), batch {b} x {side}^3 on {world} slabs of {side // world} "
              f"rows, float32: {' / '.join(f'{statistics.mean(q[name]['seconds'][1:]):.4f}' for q in reports)} s/step per "
              f"process, one-process step {statistics.mean(ref_seconds[1:]):.4f} s (after a {r['seconds'][0]:.2f} s warm-up "
              f"step); peak memory per process {' / '.join(f'{q[name]['peak_memory'] / 2**30:.2f}' for q in reports)} GiB, "
              f"one process {ref_peak / 2**30:.2f} GiB; loss {' -> '.join(f'{v:.6f}' for v in r['losses'])}; launches per "
              f"step and process { {k: v for k, v in per_step.items() if v} } + {k5_io['tail_launches']} K5 tails, "
              f"{k5_io['exchanges']} K5 exchanges handed {k5_io['bytes_sent'] / 1e6:.1f} MB; against the "
              f"one-process steps: loss rel {loss_rel:.2e} (tol {TRAIN_RTOL['float32']['loss']:.0e}), grad norm rel "
              f"{norm_rel:.2e} (tol {TRAIN_RTOL['float32']['grad']:.0e}), parameters after {n_timed + 1} steps max |diff| "
              f"{diffs[worst].max().item():.2e} at {worst} (tol 2 lr per step = {2 * lr * (n_timed + 1):.1e}), share of "
              f"entries off by more than lr / 10: {far:.2e} (tol 1e-3). " + shared_card_note(world))
        check(loss_rel <= TRAIN_RTOL["float32"]["loss"] and norm_rel <= TRAIN_RTOL["float32"]["grad"],
              f"train tp {name}: loss {r['losses']} / {ref_losses}, grad norm {r['norms']} / {ref_norms}")
        check(diffs[worst].max().item() <= 2 * lr * (n_timed + 1) and far <= 1e-3,
              f"train tp {name}: parameters differ from the one-process steps: {worst}")
        check(all(abs(q[name]["param_sum"] - digest) <= 1e-9 * abs(digest) for q in reports[1:]),
              f"train tp {name}: the processes hold different parameters")
        sharded_report(name, reports, lr, n_timed + 1)
        del state, step, batch, diffs
        gc.collect()
        torch.cuda.empty_cache()
    total, spent = reports[0]["factorizer_brats23"]["instrumented"]
    print(f"[train tp] where a factorizer_brats23 step goes on process 0 (one more step, {total:.4f} s, a synchronize "
          f"around each exchange): " + ", ".join(f"{k} {v[0]:.4f} s ({v[1]} calls)" for k, v in spent.items())
          + f", the rest (the kernels and stock operations of the slab) {total - sum(v[0] for v in spent.values()):.4f} s")
    turns, rule_losses = reports[0]["factorizer_brats23"]["turns"], reports[0]["factorizer_brats23"]["rule_losses"]

    def mean_s(label: str) -> str:
        return " / ".join(f"{statistics.mean(t[0] for t in q['factorizer_brats23']['turns'][label]):.4f}" for q in reports)

    print(f"[train tp] gather rule, factorizer_brats23 on {world} slabs, a step each (other, then rule): gathered "
          f"where the slab holds no whole number of patches or the all-gather sends fewer bytes than K5 (the rule) "
          f"{mean_s('rule')} s/step, peak {max(t[1] for t in turns['rule']) / 2**30:.2f} GiB; "
          f"gathered only where the slab holds no whole number of patches {mean_s('other')} s/step, peak "
          f"{max(t[1] for t in turns['other']) / 2**30:.2f} GiB, launches per step "
          f"{ {k: v for k, v in turns['other'][-1][2].items() if v} }; a forward's loss under each from the same "
          f"weights: " + ("equal bit for bit" if rule_losses["rule"] == rule_losses["other"] else f"{rule_losses}")
          + f" ({started:.1f} s with start-up)")
    check(abs(rule_losses["rule"] - rule_losses["other"]) <= TRAIN_RTOL["float32"]["loss"] * abs(rule_losses["rule"]),
          f"train tp: the two gather rules give different losses: {rule_losses}")
    counters = kernel_counters()
    for bundle, (b, roi, n_steps, search) in TP_BUNDLES.items():
        torch.backends.cudnn.benchmark = search
        model, cfg = bundle_network(bundle)
        n_params = sum(p.numel() for p in model.parameters())
        state = create_train_state(model, lr=cfg["learning_rate"], weight_decay=cfg["weight_decay"])
        step = make_train_step(state.model)
        net = cfg["network_def"]
        batch = roi_batch(b, net["in_channels"], net["out_channels"], roi, seed=7)
        ref_losses, ref_norms, ref_seconds, ref_counts = [], [], [], []
        for i in range(1 + n_steps):
            if i == 1:
                torch.cuda.reset_peak_memory_stats()
            reset_counters(counters)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            ref_seconds.append(time.perf_counter() - t1)
            ref_counts.append({k: v for k, v in read_counters(counters).items() if v})
            ref_losses.append(metrics["loss"].item())
            ref_norms.append(metrics["grad_norm"].item())
        ref_peak = torch.cuda.max_memory_allocated()
        keep["one_process"][bundle] = {"losses": ref_losses, "seconds": ref_seconds[1:], "peak": ref_peak}
        for rank, report in enumerate(reports):
            r = report[bundle]
            for counts, want in zip(r["counts"], ref_counts):
                check({k: v for k, v in counts.items() if v} == want,
                      f"train tp {bundle} rank {rank}: launches {counts}, the one-process step's {want}")
                for k, v in counts.items():
                    launches[k] += v
            check(r["losses"] == reports[0][bundle]["losses"] and r["norms"] == reports[0][bundle]["norms"]
                  and abs(r["param_sum"] - reports[0][bundle]["param_sum"]) <= 1e-9 * abs(r["param_sum"]),
                  f"train tp {bundle}: the processes report different metrics or parameters: {r['losses']} / "
                  f"{reports[0][bundle]['losses']}")
        r = reports[0][bundle]
        check(all(map(math.isfinite, r["losses"] + r["norms"])), f"train tp {bundle}: {r['losses']}, {r['norms']}")
        loss_rel = max(abs(a - c) / abs(c) for a, c in zip(r["losses"], ref_losses))
        norm_rel = max(abs(a - c) / c for a, c in zip(r["norms"], ref_norms))
        total, spent = r["instrumented"]
        side = "x".join(map(str, roi))
        print(f"[train tp] {bundle}: the unedited network_def ({type(model).__name__}, {n_params / 1e6:.2f}M parameters) "
              f"through make_train_step(mesh=model_parallel_mesh(), spatial_axis='model') ({reports[0]['backend']}), "
              f"batch {b} x {side} on {world} slabs of {roi[0] // world} rows, float32, cuDNN's "
              f"{'timing search' if search else 'heuristics'}: "
              f"{' / '.join(f'{statistics.mean(q[bundle]['seconds'][1:]):.4f}' for q in reports)} s/step per process, "
              f"one-process step {statistics.mean(ref_seconds[1:]):.4f} s (warm-up {r['seconds'][0]:.2f} s / "
              f"{ref_seconds[0]:.2f} s); peak memory per process "
              f"{' / '.join(f'{q[bundle]['peak_memory'] / 2**30:.2f}' for q in reports)} GiB, one process "
              f"{ref_peak / 2**30:.2f} GiB; loss {' -> '.join(f'{v:.6f}' for v in r['losses'])}; launches per step and "
              f"process {ref_counts[-1] or 'none of the port'} as in one process; against the one-process steps: loss "
              f"rel {loss_rel:.2e} (tol {TRAIN_RTOL['float32']['loss']:.0e}), grad norm rel {norm_rel:.2e} (tol "
              f"{TRAIN_RTOL['float32']['grad']:.0e}). One more step on process 0, {total:.4f} s with a synchronize "
              f"around each exchange: " + ", ".join(f"{k} {v[0]:.4f} s ({v[1]} calls)" for k, v in spent.items() if v[1])
              + f", the rest {total - sum(v[0] for v in spent.values()):.4f} s. " + shared_card_note(world))
        check(loss_rel <= TRAIN_RTOL["float32"]["loss"] and norm_rel <= TRAIN_RTOL["float32"]["grad"],
              f"train tp {bundle}: loss {r['losses']} / {ref_losses}, grad norm {r['norms']} / {ref_norms}")
        sharded_report(bundle, reports, cfg["learning_rate"], 1 + n_steps)
        del model, state, step, batch
        gc.collect()
        torch.cuda.empty_cache()
    torch.backends.cudnn.benchmark = True
    # model_axis without the spatial step: every process the whole batch on gathered weights, as one process.
    factory, b, _, _, side, patch, shifts = TP_CASES["factorizer_brats23"][:7]
    ref, per_step = keep["one_process"]["factorizer_brats23"], tp_routes(b, side, patch, shifts, 1)[0]
    axis = [q["model_axis"] for q in reports]
    for rank, m in enumerate(axis):
        for counts in m["counts"]:
            check({k: v for k, v in counts.items() if v} == {k: v for k, v in per_step.items() if v},
                  f"train tp model_axis rank {rank}: launches {counts}, the one-process step's {per_step}")
            for k, v in counts.items():
                launches[k] += v
        check(m["losses"] == axis[0]["losses"] and m["sharded"] == axis[0]["sharded"] >= 1,
              f"train tp model_axis: the processes report {m['losses']} / {axis[0]['losses']}")
    loss_rel = max(abs(a - c) / abs(c) for a, c in zip(axis[0]["losses"], ref["losses"]))
    print(f"[train tp] model_axis without shard_spatial: make_train_step({factory}(), mesh=model_parallel_mesh(), "
          f"model_axis='model') ({reports[0]['backend']}), every process the whole batch {b} x {side}^3 on gathered "
          f"weights ({axis[0]['sharded']} leaves sharded), float32: "
          f"{' / '.join(f'{statistics.mean(m['seconds'][1:]):.4f}' for m in axis)} s/step per process (after a "
          f"{axis[0]['seconds'][0]:.2f} s warm-up), one-process step {statistics.mean(ref['seconds']):.4f} s; peak "
          f"{' / '.join(f'{m['peak_memory'] / 2**30:.2f}' for m in axis)} GiB (one process {ref['peak'] / 2**30:.2f}); "
          f"state held {' / '.join(f'{m['state_bytes'] / 1e6:.2f}' for m in axis)} MB; launches per step and process "
          f"{ {k: v for k, v in per_step.items() if v} } as in one process; loss "
          f"{' -> '.join(f'{v:.6f}' for v in axis[0]['losses'])} against the one-process steps' rel {loss_rel:.2e} (tol "
          f"{TRAIN_RTOL['float32']['loss']:.0e}). " + shared_card_note(world))
    check(loss_rel <= TRAIN_RTOL["float32"]["loss"], f"train tp model_axis: {axis[0]['losses']} / {ref['losses']}")
    return launches


# `--cards N` ([hosts] across cards): the `[train tp]` cells run on 2 simulated hosts of N / 2 cards, under NCCL's
# default transports (NVLink and shared memory inside this host) and under the sockets that a link between hosts
# takes (peer-to-peer and shared-memory transports off).
HOSTS_CELLS = ("factorizer_brats23", "deconver_brats23")
HOSTS_TRANSPORTS = {"default transports": {},
                    "sockets (NCCL_P2P_DISABLE=1 NCCL_SHM_DISABLE=1)": {"NCCL_P2P_DISABLE": "1", "NCCL_SHM_DISABLE": "1"}}


def hosts_cards_slice(world: int, settings: dict, one_host: dict | None = None) -> None:
    """Phase 32 across cards: ``HOSTS_CELLS`` of ``[train tp]`` on ``world`` cards as 2 hosts of ``world / 2``
    (``run_processes(hosts=2)``: each host sees its own cards), over NCCL under each of ``HOSTS_TRANSPORTS``: s/step,
    peak GiB and one instrumented step's exchanges per process, equal losses and gradient norms on every process, and
    the loss against the one-process step of ``[train tp]`` in this run (``one_host``, from :func:`train_tp_slice`),
    beside its one-host numbers."""
    from factorizer_tpu_torch.parallel import run_processes

    for label, environ in HOSTS_TRANSPORTS.items():
        t0 = time.perf_counter()
        reports = run_processes(train_tp_worker, world, settings, HOSTS_CELLS, environ, hosts=2, timeout=600,
                                start_method=WORKERS_START)
        started = time.perf_counter() - t0
        for name in HOSTS_CELLS:
            runs = [q[name] for q in reports]
            r = runs[0]
            check(all(q["losses"] == r["losses"] and q["norms"] == r["norms"] for q in runs)
                  and all(map(math.isfinite, r["losses"] + r["norms"])),
                  f"hosts {name} ({label}): the processes report {[q['losses'] for q in runs]}")
            total, spent = r["instrumented"]
            k5_line = ""
            if name in TP_CASES:
                _, b, _, _, side, patch, shifts, _ = TP_CASES[name]
                io = r["k5_io"][-1]
                check(all(q["k5_io"][-1] == tp_routes(b, side, patch, shifts, world)[1] for q in runs),
                      f"hosts {name} ({label}): K5 {[q['k5_io'][-1] for q in runs]}")
                k5_line = f"K5 per step and process {io['exchanges']} exchanges handed {io['bytes_sent'] / 1e6:.1f} MB; "
            against = ""
            if one_host:
                ref = one_host["one_process"][name]
                loss_rel = max(abs(a - c) / abs(c) for a, c in zip(r["losses"], ref["losses"]))
                check(loss_rel <= TRAIN_RTOL["float32"]["loss"], f"hosts {name} ({label}): loss {r['losses']} / {ref['losses']}")
                mine = [q[name] for q in one_host["reports"]]
                against = (f"; one host of {world} cards in this run ([train tp]) "
                           f"{' / '.join(f'{statistics.mean(q['seconds'][1:]):.4f}' for q in mine)} s/step, peak "
                           f"{' / '.join(f'{q['peak_memory'] / 2**30:.2f}' for q in mine)} GiB, one process "
                           f"{statistics.mean(ref['seconds']):.4f} s/step, {ref['peak'] / 2**30:.2f} GiB; loss against "
                           f"the one-process step rel {loss_rel:.2e} (tol {TRAIN_RTOL['float32']['loss']:.0e})")
            print(f"[hosts] {name}: the [train tp] step on {world} cards as 2 hosts of {world // 2} "
                  f"(run_processes(hosts=2), {reports[0]['backend']}, {label}): "
                  f"{' / '.join(f'{statistics.mean(q['seconds'][1:]):.4f}' for q in runs)} s/step per process "
                  f"(warm-up {r['seconds'][0]:.2f} s), peak {' / '.join(f'{q['peak_memory'] / 2**30:.2f}' for q in runs)} "
                  f"GiB; loss {' -> '.join(f'{v:.6f}' for v in r['losses'])} on every process; {k5_line}one more step on process "
                  f"0, {total:.4f} s with a synchronize around each exchange: "
                  + ", ".join(f"{k} {v[0]:.4f} s ({v[1]} calls)" for k, v in spent.items() if v[1])
                  + f", the rest {total - sum(v[0] for v in spent.values()):.4f} s" + against
                  + f" ({started:.1f} s with start-up)")
        del reports
        gc.collect()


# Phase 30's cells: (label, bundle, network_def overrides, processes, batch, roi, cuDNN's timing search).
SLAB_GAP_CELLS = (
    ("deconver_brats23 update_filter", "deconver_brats23", {"update_filter": True}, 2, 2, (128, 128, 128), False),
    ("swinunetr_isles22 use_v2", "swinunetr_isles22", {"use_v2": True}, 2, 8, (64, 64, 64), True),
    ("swinunetr_isles22", "swinunetr_isles22", {}, 4, 8, (64, 64, 64), True),
    ("factorizer_isles22", "factorizer_isles22", {}, 8, 8, (64, 64, 64), True),
)
SLAB_GAP_STEPS = 1  # timed steps after one warm-up step


def slab_gaps_worker(rank: int, world: int, init_method: str, labels: list) -> dict:
    """The spatial step on this process's slabs for each of ``labels`` (``SLAB_GAP_CELLS`` of ``world`` processes):
    the route, 1 warm-up and ``SLAB_GAP_STEPS`` steps with their seconds, launches, losses, norms and peak memory; for
    a Deconver the first stage's filter fitted on slabs after the steps."""
    import torch

    from factorizer_tpu_torch.factorization.deconv import Deconv
    from factorizer_tpu_torch.parallel import Slabs, model_parallel_mesh, on_slabs
    from factorizer_tpu_torch.parallel.slabs import Cut, slab_route
    from factorizer_tpu_torch.train.trainer import create_train_state, make_train_step

    backend = join_group_on_the_card(rank, world, init_method)
    mesh = model_parallel_mesh()
    slabs = Slabs(mesh, "model")
    counters = kernel_counters()
    report = {"backend": backend}
    for label, bundle, overrides, _, b, roi, search in SLAB_GAP_CELLS:
        if label not in labels:
            continue
        torch.backends.cudnn.benchmark = search
        model, cfg = bundle_network(bundle, overrides=overrides)
        state = create_train_state(model, lr=cfg["learning_rate"], weight_decay=cfg["weight_decay"])
        step = make_train_step(state.model, mesh=mesh, spatial_axis="model")
        net = cfg["network_def"]
        batch = roi_batch(b, net["in_channels"], net["out_channels"], roi, seed=7)
        deconv = next((m for m in model.modules() if isinstance(m, Deconv)), None)
        seen = []

        def keep(module, args):
            seen[:] = [args[0].detach()]

        hook = None if deconv is None else deconv.register_forward_pre_hook(keep)
        run = {"route": str(slab_route(model, Cut.equal(roi[0], world))), "losses": [], "norms": [], "seconds": [],
               "counts": [], "peak_memory": 0}
        for i in range(1 + SLAB_GAP_STEPS):
            reset_counters(counters)
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            run["seconds"].append(time.perf_counter() - t0)
            run["counts"].append({k: v for k, v in read_counters(counters).items() if v})
            run["losses"].append(metrics["loss"].item())
            run["norms"].append(metrics["grad_norm"].item())
            if i:
                run["peak_memory"] = max(run["peak_memory"], torch.cuda.max_memory_allocated())
        run["param_sum"] = sum(p.detach().double().sum().item() for p in state.model.parameters())
        if deconv is not None:
            hook.remove()
            with torch.no_grad(), on_slabs(state.model, slabs):
                run["h"] = deconv.fit(seen[0])[1].cpu()
        report[label] = run
        del model, state, step, batch, seen
        gc.collect()
        torch.cuda.empty_cache()
    return report


def slab_gaps_slice() -> dict:
    """Phase 30: the spatial step where the layers' slab paths stop (``SLAB_GAP_CELLS``): the Deconver's filter
    update on slabs, SwinUNETR V2, SwinUNETR on slabs of 16 rows and factorizer_isles22 on 8 slabs of 8 rows, each in
    ``world`` processes sharing the card (gloo), held against the one-process step on the same batch; then K2 at the
    slab shape of ``[train tp]``'s first cell.  Returns the launches of all processes' steps, by kernel."""
    import torch

    from factorizer_tpu_torch.ops.kernels import prenorm_mlp, prenorm_mlp_backward
    from factorizer_tpu_torch.parallel import run_processes
    from factorizer_tpu_torch.train.trainer import create_train_state, make_train_step

    t_phase = time.perf_counter()
    launches = dict.fromkeys(kernel_counters(), 0)
    worlds = {}
    for cell in SLAB_GAP_CELLS:
        worlds.setdefault(cell[3], []).append(cell[0])
    reports, started = {}, {}
    for world, labels in worlds.items():
        t0 = time.perf_counter()
        reports[world] = run_processes(slab_gaps_worker, world, labels, timeout=600, start_method=WORKERS_START)
        started[world] = time.perf_counter() - t0
    counters = kernel_counters()
    tol = TRAIN_RTOL["float32"]
    for label, bundle, overrides, world, b, roi, search in SLAB_GAP_CELLS:
        torch.backends.cudnn.benchmark = search
        model, cfg = bundle_network(bundle, overrides=overrides)
        state = create_train_state(model, lr=cfg["learning_rate"], weight_decay=cfg["weight_decay"])
        step = make_train_step(state.model)
        net = cfg["network_def"]
        batch = roi_batch(b, net["in_channels"], net["out_channels"], roi, seed=7)
        ref = {"losses": [], "norms": [], "seconds": [], "counts": []}
        for i in range(1 + SLAB_GAP_STEPS):
            if i == 1:
                torch.cuda.reset_peak_memory_stats()
            reset_counters(counters)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            ref["seconds"].append(time.perf_counter() - t0)
            ref["counts"].append({k: v for k, v in read_counters(counters).items() if v})
            ref["losses"].append(metrics["loss"].item())
            ref["norms"].append(metrics["grad_norm"].item())
        ref_peak = torch.cuda.max_memory_allocated()
        runs = [rep[label] for rep in reports[world]]
        r = runs[0]
        for rank, q in enumerate(runs):
            check(q["losses"] == r["losses"] and q["norms"] == r["norms"]
                  and abs(q["param_sum"] - r["param_sum"]) <= 1e-9 * abs(r["param_sum"]),
                  f"slab gaps {label}: the processes report different metrics or parameters: {q['losses']} / {r['losses']}")
            check(q["counts"] == r["counts"], f"slab gaps {label} rank {rank}: launches {q['counts']} / {r['counts']}")
            for counts in q["counts"]:
                for k, v in counts.items():
                    launches[k] += v
        check(all(map(math.isfinite, r["losses"] + r["norms"])), f"slab gaps {label}: {r['losses']}, {r['norms']}")
        loss_rel = max(abs(a - c) / abs(c) for a, c in zip(r["losses"], ref["losses"]))
        norm_rel = max(abs(a - c) / c for a, c in zip(r["norms"], ref["norms"]))
        check(loss_rel <= tol["loss"] and norm_rel <= tol["grad"],
              f"slab gaps {label}: loss {r['losses']} / {ref['losses']}, grad norm {r['norms']} / {ref['norms']}")
        extra = ""
        if bundle.startswith("deconver"):  # no gather: the same K3 launches a process as in one process
            check(r["counts"] == ref["counts"], f"slab gaps {label}: launches {r['counts']}, one process {ref['counts']}")
            hs = [q["h"] for q in runs]
            check(all(torch.equal(h, hs[0]) for h in hs) and bool(torch.isfinite(hs[0]).all()),
                  f"slab gaps {label}: the fitted filter differs between the processes")
            extra = f"; the first stage's filter fitted on slabs after the steps {tuple(hs[0].shape)} equal bit for bit on every process"
        if bundle.startswith("factorizer"):
            check(all(counts.get(k) for counts in r["counts"] for k in ("windowed_nmf_factors", "prenorm_mlp",
                                                                        "prenorm_mlp_bwd", "windowed_nmf_bwd")),
                  f"slab gaps {label}: K1 or K2 did not launch on the gathered levels: {r['counts']}")
        side = "x".join(map(str, roi))
        print(f"[slab gaps] {label}: the network_def with {overrides or 'no override'} through "
              f"make_train_step(mesh=model_parallel_mesh(), spatial_axis='model') ({reports[world][0]['backend']}), batch "
              f"{b} x {side} on {world} slabs of {roi[0] // world} rows, float32, cuDNN's "
              f"{'timing search' if search else 'heuristics'}; route: {r['route']}; "
              f"{' / '.join(f'{statistics.mean(q['seconds'][1:]):.4f}' for q in runs)} s/step per process, one-process "
              f"step {statistics.mean(ref['seconds'][1:]):.4f} s (warm-up {r['seconds'][0]:.2f} s / {ref['seconds'][0]:.2f} "
              f"s); peak memory per process {' / '.join(f'{q['peak_memory'] / 2**30:.2f}' for q in runs)} GiB, one "
              f"process {ref_peak / 2**30:.2f} GiB; loss {' -> '.join(f'{v:.6f}' for v in r['losses'])}; launches per "
              f"step and process {r['counts'][-1] or 'none of the port'} (one process {ref['counts'][-1] or 'none'}); "
              f"against the one-process steps: loss rel {loss_rel:.2e} (tol {tol['loss']:.0e}), grad norm rel "
              f"{norm_rel:.2e} (tol {tol['grad']:.0e}){extra}. " + shared_card_note(world))
        del model, state, step, batch
        gc.collect()
        torch.cuda.empty_cache()
    # K2's slab kernels are K2's: at the slab shape of [train tp]'s factorizer_brats23 cell on 2 slabs.
    gen = torch.Generator(device="cuda").manual_seed(0)
    c = 32
    x = torch.randn(2, 64, 128, 128, c, device="cuda", generator=gen)
    params = (torch.ones(c, device="cuda"), torch.zeros(c, device="cuda"),
              torch.randn(4 * c, c, device="cuda", generator=gen) / c**0.5, torch.zeros(4 * c, device="cuda"),
              torch.randn(c, 4 * c, device="cuda", generator=gen) / (4 * c)**0.5, torch.zeros(c, device="cuda"))
    with torch.inference_mode():
        fwd_ms = cuda_time_ms(lambda: prenorm_mlp(x, *params))
        bwd_ms = cuda_time_ms(lambda: prenorm_mlp_backward(x, x, *params))
    fwd = bound_ms(*k2_work(x, 4 * c, backward=False)[:2], x.dtype, "tf32")
    bwd = bound_ms(*k2_work(x, 4 * c, backward=True)[:2], x.dtype, "tf32")
    print(f"[slab gaps] K2 at the slab shape (2,64x128^2,32) H=128 float32 (the JAX slab kernels' work, which K2 does on "
          f"the slab's tokens): forward {fwd_ms:.3f} ms bound {fwd[0]:.3f} ms ({fwd[1]}), backward {bwd_ms:.3f} ms bound "
          f"{bwd[0]:.3f} ms ({bwd[1]}); phase {time.perf_counter() - t_phase:.1f} s ("
          + ", ".join(f"{w} processes {t:.1f} s with start-up" for w, t in started.items()) + ")")
    del x, params
    # The filter update's correlation at stage 0 of deconver_brats23 (group-split: 64 one-channel volumes), whole
    # and on a slab of 64 rows with its halo: cuDNN's grouped convolution whose kernel is the whole second operand.
    from factorizer_tpu_torch.factorization.deconv import sconv

    a, b_ = (torch.rand(64, 128, 128, 128, 1, device="cuda", generator=gen) for _ in range(2))
    whole_ms = cuda_time_ms(lambda: sconv(a, b_, ((1, 1),) * 3), warmup=1, runs=3)
    slab_ms = cuda_time_ms(lambda: sconv(a[:, :66], b_[:, :64], ((0, 0), (1, 1), (1, 1))), warmup=1, runs=3)
    bound = bound_ms(2 * a.numel() * 4 + 64 * 27 * 4, 2.0 * 27 * a.numel(), torch.float32)
    print(f"[slab gaps] sconv (the filter update's correlation, Deconv.update_h) at stage 0 of deconver_brats23, "
          f"(64,128^3,1) with (64,128^3,1) -> (64,1,1,3,3,3) float32: {whole_ms:.3f} ms, bound {bound[0]:.3f} ms "
          f"({bound[1]}); on a slab, (64,66x128^2,1) with (64,64x128^2,1): {slab_ms:.3f} ms; two a block and iteration")
    del a, b_
    torch.cuda.empty_cache()
    return launches


# Phase 31's cells: (label, bundle, batch, roi, network_def overrides); each on UNEVEN_WORLD slabs, whose count does not
# divide the rows.  The last two: more slabs than rows (nnU-Net's anisotropic strides, stride 1 along the cut axis, on
# a volume of 2 slices: slabs of 1 / 1 / 0 rows, the whole model gathered) and a deep-supervision head below the cut's
# grid (nnU-Net's three deep-supervision heads on 16 rows: 8 / 4 / 4, the third reads 2 rows).
UNEVEN_CELLS = (
    ("factorizer_brats23", "factorizer_brats23", 2, (128, 128, 128), {}),
    ("deconver_brats23", "deconver_brats23", 2, (128, 128, 128), {}),
    ("nnunet_brats23 more slabs than rows", "nnunet_brats23", 2, (2, 128, 128),
     {"strides": [[1, 1, 1], [1, 2, 2], [1, 2, 2], [1, 2, 2], [1, 2, 2]], "deep_supervision": True, "deep_supr_num": 1}),
    ("nnunet_brats23 head below the grid", "nnunet_brats23", 2, (16, 128, 128),
     {"deep_supervision": True, "deep_supr_num": 3}),
)
UNEVEN_WORLD = 3
UNEVEN_STEPS = 2  # timed steps after one warm-up step


def uneven_slabs_worker(rank: int, world: int, init_method: str) -> dict:
    """The spatial step on this process's slab of the line's cut for each of ``UNEVEN_CELLS``: the cut and the route,
    which training outputs every process holds whole (one forward), 1 warm-up and ``UNEVEN_STEPS`` steps with their
    seconds, launches, losses, norms and peak memory."""
    import torch

    from factorizer_tpu_torch.parallel import Slabs, model_parallel_mesh, on_slabs, shard_batch
    from factorizer_tpu_torch.parallel.slabs import is_whole, slab_cut, slab_route
    from factorizer_tpu_torch.train.trainer import create_train_state, make_train_step

    backend = join_group_on_the_card(rank, world, init_method)
    mesh = model_parallel_mesh()
    counters = kernel_counters()
    report = {"backend": backend}
    torch.backends.cudnn.benchmark = False
    for label, bundle, b, roi, overrides in UNEVEN_CELLS:
        model, cfg = bundle_network(bundle, overrides=overrides)
        state = create_train_state(model, lr=cfg["learning_rate"], weight_decay=cfg["weight_decay"])
        step = make_train_step(state.model, mesh=mesh, spatial_axis="model")
        net = cfg["network_def"]
        batch = roi_batch(b, net["in_channels"], net["out_channels"], roi, seed=7)
        cut = slab_cut(model, roi[0], world)
        run = {"route": str(slab_route(model, cut)), "rows": cut.sizes(roi[0]), "losses": [], "norms": [],
               "seconds": [], "counts": [], "peak_memory": 0}
        if overrides:  # the outputs of one training forward on this slab, whole or not
            x = shard_batch(batch["image"], mesh, data_axis=None, spatial_axis="model", sizes=cut.sizes(roi[0]))
            with torch.no_grad(), on_slabs(model.train(), Slabs(mesh, "model", cut)):
                outs = model(x)
            run["whole"] = [is_whole(t) for t in outs]
            run["slab_shapes"] = [tuple(t.shape) for t in outs]
            del x, outs
            reset_counters(counters)
        for i in range(1 + UNEVEN_STEPS):
            reset_counters(counters)
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            run["seconds"].append(time.perf_counter() - t0)
            run["counts"].append({k: v for k, v in read_counters(counters).items() if v})
            run["losses"].append(metrics["loss"].item())
            run["norms"].append(metrics["grad_norm"].item())
            if i:
                run["peak_memory"] = max(run["peak_memory"], torch.cuda.max_memory_allocated())
        run["param_sum"] = sum(p.detach().double().sum().item() for p in state.model.parameters())
        report[label] = run
        del model, state, step, batch
        gc.collect()
        torch.cuda.empty_cache()
    return report


def uneven_slabs_slice(world: int = UNEVEN_WORLD) -> dict:
    """Phase 31: the spatial step on slabs of unequal rows (``UNEVEN_CELLS`` on ``world`` processes, sharing the card
    over gloo or one card each over NCCL), held against the one-process step on the same batch; then K5 on an unequal
    ring against K1 bit for bit, K2 and K2 bwd at the two slab shapes and K3 and K3 dw at the thinnest haloed slab
    against their plain versions.  Returns the launches of all processes' steps, by kernel."""
    import torch

    from factorizer_tpu_torch.ops.kernels import (
        depthwise_conv, depthwise_conv_dw, depthwise_conv_dw_plain, depthwise_conv_plain, prenorm_mlp,
        prenorm_mlp_backward, prenorm_mlp_backward_plain, prenorm_mlp_plain, windowed_nmf, windowed_nmf_backward,
        windowed_nmf_multi_spatial, windowed_nmf_multi_spatial_local,
    )
    from factorizer_tpu_torch.ops.kernels.windowed_sharded import exchange_bytes
    from factorizer_tpu_torch.parallel import run_processes
    from factorizer_tpu_torch.train.trainer import create_train_state, make_train_step

    t_phase = time.perf_counter()
    launches = dict.fromkeys(kernel_counters(), 0)
    t0 = time.perf_counter()
    reports = run_processes(uneven_slabs_worker, world, timeout=600, start_method=WORKERS_START)
    started = time.perf_counter() - t0
    counters = kernel_counters()
    tol = TRAIN_RTOL["float32"]
    torch.backends.cudnn.benchmark = False
    for label, bundle, b, roi, overrides in UNEVEN_CELLS:
        model, cfg = bundle_network(bundle, overrides=overrides)
        state = create_train_state(model, lr=cfg["learning_rate"], weight_decay=cfg["weight_decay"])
        step = make_train_step(state.model)
        net = cfg["network_def"]
        batch = roi_batch(b, net["in_channels"], net["out_channels"], roi, seed=7)
        ref = {"losses": [], "norms": [], "seconds": [], "counts": []}
        for i in range(1 + UNEVEN_STEPS):
            if i == 1:
                torch.cuda.reset_peak_memory_stats()
            reset_counters(counters)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            ref["seconds"].append(time.perf_counter() - t0)
            ref["counts"].append({k: v for k, v in read_counters(counters).items() if v})
            ref["losses"].append(metrics["loss"].item())
            ref["norms"].append(metrics["grad_norm"].item())
        ref_peak = torch.cuda.max_memory_allocated()
        runs = [rep[label] for rep in reports]
        r = runs[0]
        check(len(set(r["rows"])) > 1 and sum(r["rows"]) == roi[0], f"uneven slabs {label}: the cut {r['rows']} is not uneven")
        for rank, q in enumerate(runs):
            check(q["losses"] == r["losses"] and q["norms"] == r["norms"] and q["route"] == r["route"]
                  and abs(q["param_sum"] - r["param_sum"]) <= 1e-9 * abs(r["param_sum"]),
                  f"uneven slabs {label}: the processes report different metrics or parameters: {q['losses']} / {r['losses']}")
            check(q["counts"] == r["counts"], f"uneven slabs {label} rank {rank}: launches {q['counts']} / {r['counts']}")
            for counts in q["counts"]:
                for k, v in counts.items():
                    launches[k] += v
        check(all(map(math.isfinite, r["losses"] + r["norms"])), f"uneven slabs {label}: {r['losses']}, {r['norms']}")
        loss_rel = max(abs(a - c) / abs(c) for a, c in zip(r["losses"], ref["losses"]))
        norm_rel = max(abs(a - c) / c for a, c in zip(r["norms"], ref["norms"]))
        check(loss_rel <= tol["loss"] and norm_rel <= tol["grad"],
              f"uneven slabs {label}: loss {r['losses']} / {ref['losses']}, grad norm {r['norms']} / {ref['norms']}")
        wanted = (("windowed_nmf_slab", "windowed_nmf_slab_bwd", "windowed_nmf_factors", "windowed_nmf_bwd",
                   "prenorm_mlp", "prenorm_mlp_bwd") if bundle.startswith("factorizer")
                  else ("depthwise_conv", "depthwise_conv_dw") if bundle.startswith("deconver") else ())
        check(all(r["counts"][-1].get(k) for k in wanted), f"uneven slabs {label}: a kernel of {wanted} did not launch: "
                                                             f"{r['counts'][-1]}")
        check(wanted or not any(r["counts"]) and not any(ref["counts"]),
              f"uneven slabs {label}: a kernel of the port launched: {r['counts']} / {ref['counts']}")
        whole = ""
        if overrides:  # more slabs than rows: the whole model gathered; a head below the grid: its output whole
            empty = 0 in r["rows"]
            want_whole = [False] * len(r["whole"]) if empty else [False] * (len(r["whole"]) - 1) + [True]
            check(all(q["whole"] == want_whole for q in runs)
                  and r["route"].startswith("whole model gathered" if empty else "levels"),
                  f"uneven slabs {label}: route {r['route']!r}, outputs whole {r['whole']}, expected {want_whole}")
            whole = (f"training outputs' rows on each slab {[[t[2] for t in q['slab_shapes']] for q in runs]}, whole on "
                     f"every process: {r['whole']}; ")
        check(all(N_SHIFTS * c.get("windowed_nmf_slab", 0) == 2 * c.get("windowed_nmf_slab_bwd", 0) for c in r["counts"]),
              f"uneven slabs {label}: K5 launches {r['counts']} are not pass A and pass B and a backward pass per shift")
        if bundle.startswith("deconver"):  # no gather: the same K3 launches a process as in one process
            check(r["counts"] == ref["counts"], f"uneven slabs {label}: launches {r['counts']}, one process {ref['counts']}")
        side = "x".join(map(str, roi))
        print(f"[uneven slabs] {label}: the network_def ({overrides or 'unedited'}) through make_train_step(mesh=model_parallel_mesh(), "
              f"spatial_axis='model') ({reports[0]['backend']}), batch {b} x {side} on {world} slabs of "
              f"{' / '.join(map(str, r['rows']))} rows, float32, cuDNN's heuristics; route: {r['route']}; s/step per "
              f"process (by slab rows) {' / '.join(f'{statistics.mean(q['seconds'][1:]):.4f}' for q in runs)}, "
              f"one-process step {statistics.mean(ref['seconds'][1:]):.4f} s (warm-up {r['seconds'][0]:.2f} s / "
              f"{ref['seconds'][0]:.2f} s); peak memory per process {' / '.join(f'{q['peak_memory'] / 2**30:.2f}' for q in runs)} "
              f"GiB, one process {ref_peak / 2**30:.2f} GiB; {whole}loss {' -> '.join(f'{v:.6f}' for v in r['losses'])}; launches "
              f"per step and process {r['counts'][-1]} (one process {ref['counts'][-1]}); against the one-process steps: loss "
              f"rel {loss_rel:.2e} (tol {tol['loss']:.0e}), grad norm rel {norm_rel:.2e} (tol {tol['grad']:.0e}). "
              + shared_card_note(world))
        del model, state, step, batch
        gc.collect()
        torch.cuda.empty_cache()

    # K5 on a ring of unequal slabs: (2,128^3,32) cut 48 / 48 / 32, as [uneven slabs]' Factorizer stage 0, against K1 on
    # the whole volume bit for bit, forward and backward.
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(31)
    u0, v0 = torch.rand(8, 1, device=dev, generator=gen), torch.rand(512, 1, device=dev, generator=gen)
    rows = (48, 48, 32)
    x = torch.relu(torch.randn(2, 128, 128, 128, 32, device=dev, generator=gen))
    g = torch.randn(x.shape, device=dev, generator=gen)
    args = (u0, v0, 8, 8, BRATS_SHIFTS, "hals", NUM_ITERS)
    leaves = [t.contiguous().requires_grad_(True) for t in x.split(rows, 1)]
    k5 = windowed_nmf_multi_spatial
    before = (k5.launches, k5.backward_launches, k5.tail_launches, k5.exchanges, k5.bytes_sent)
    ys = windowed_nmf_multi_spatial_local(leaves, *args)
    dxs = torch.autograd.grad(ys, leaves, list(g.split(rows, 1)))
    made = tuple(now - then for now, then in zip((k5.launches, k5.backward_launches, k5.tail_launches, k5.exchanges,
                                                  k5.bytes_sent), before))
    want = (2 * len(rows), len(BRATS_SHIFTS) * len(rows), len(rows), 4,
            len(rows) * exchange_bytes((2, 32, 128, 128, 32), 4, 8, 8, BRATS_SHIFTS))
    check(made == want, f"uneven slabs: K5 launches, backward launches, tails, exchanges, bytes {made}, expected {want}")
    y, dx = torch.cat([t.detach() for t in ys], 1), torch.cat(dxs, 1)
    with torch.inference_mode():
        whole, whole_dx = windowed_nmf(x, *args), windowed_nmf_backward(x, g, *args)
    torch.cuda.synchronize()
    check(torch.equal(y, whole), f"uneven slabs: K5 on 48 / 48 / 32 differs from K1 by {compare(y, whole)[0]:.3e}")
    check(torch.equal(dx, whole_dx), f"uneven slabs: K5 bwd on 48 / 48 / 32 differs from K1 bwd by {compare(dx, whole_dx)[0]:.3e}")
    ring_ms = cuda_time_ms(lambda: windowed_nmf_multi_spatial_local([t.detach() for t in leaves], *args), warmup=1, runs=5)
    k1_ms = cuda_time_ms(lambda: windowed_nmf(x, *args), warmup=1, runs=5)
    print(f"[uneven slabs] K5 on a ring of 3 slabs of 48 / 48 / 32 rows of (2,128^3,32) float32, {len(BRATS_SHIFTS)} "
          f"shifts: forward and dx equal to K1 on the whole volume bit for bit; ring {ring_ms:.3f} ms, K1 {k1_ms:.3f} ms; "
          f"launches (pass A and B, backward, tails) {made[:3]}, {made[3]} exchanges handed {made[4] / 1e6:.1f} MB")
    del x, g, leaves, ys, dxs, y, dx, whole, whole_dx
    # K2 forward and backward at the block tails' slab shapes of the Factorizer's stage 0 on 48 / 48 / 32: (2,48x128^2,32)
    # and (2,32x128^2,32), H = 128, against their plain versions (dx at K2's f32 tolerance, the parameter gradients,
    # sums over every token, at K2_PARAM_RTOL as in phase 7).
    c = 32
    mlp = (1 + 0.1 * torch.randn(c, device=dev, generator=gen), 0.1 * torch.randn(c, device=dev, generator=gen),
           torch.randn(4 * c, c, device=dev, generator=gen) / c**0.5, 0.1 * torch.randn(4 * c, device=dev, generator=gen),
           torch.randn(c, 4 * c, device=dev, generator=gen) / (4 * c)**0.5, 0.1 * torch.randn(c, device=dev, generator=gen))
    k2_lines = []
    for slab_rows in sorted(set(rows), reverse=True):
        xm = torch.randn(2, slab_rows, 128, 128, c, device=dev, generator=gen)
        gm = torch.randn(xm.shape, device=dev, generator=gen)
        before = (prenorm_mlp.launches, prenorm_mlp_backward.launches)
        with torch.inference_mode():
            err, rel = compare(prenorm_mlp(xm, *mlp), prenorm_mlp_plain(xm, *mlp))
            outs = prenorm_mlp_backward(xm, gm, *mlp)
        rels = [compare(out, ref)[1] for out, ref in zip(outs, prenorm_mlp_backward_plain(xm, gm, *mlp))]
        label = f"(2,{slab_rows}x128^2,32)"
        check((prenorm_mlp.launches - before[0], prenorm_mlp_backward.launches - before[1]) == (1, 1),
              f"uneven slabs: K2 or K2 bwd did not launch at {label}")
        check(rel <= KERNEL_RTOL["float32"] and rels[0] <= KERNEL_RTOL["float32"] and max(rels[1:]) <= K2_PARAM_RTOL,
              f"uneven slabs: K2 at {label} max_rel {rel:.3e}, K2 bwd dx {rels[0]:.3e}, parameters {max(rels[1:]):.3e}")
        k2_lines.append(f"{label} forward max_abs={err:.3e} max_rel={rel:.3e}, backward dx max_rel={rels[0]:.3e} "
                        f"parameters max_rel={max(rels[1:]):.1e}")
        del xm, gm, outs
        torch.cuda.empty_cache()
    print(f"[uneven slabs] K2 at the block tails' slab shapes, H=128 float32: {'; '.join(k2_lines)} (tol "
          f"{KERNEL_RTOL['float32']:.1e}, parameters {K2_PARAM_RTOL:.1e})")
    # K3 and K3 dw at the thinnest slab with its halo: deconver_brats23's stage 0, 32 + 2 rows.
    shape, ks = (2, 34, 128, 128, 32), (3, 3, 3)
    xk = torch.randn(shape, device=dev, generator=gen)
    gk = torch.randn(shape, device=dev, generator=gen)
    wk = torch.randn(shape[0], math.prod(ks), shape[-1], device=dev, generator=gen)
    before = (depthwise_conv.launches, depthwise_conv_dw.launches)
    with torch.inference_mode():
        err, rel = compare(depthwise_conv(xk, wk, ks), depthwise_conv_plain(xk, wk, ks))
        dw = depthwise_conv_dw(xk, gk, ks)
    err_dw, rel_dw = compare(dw, depthwise_conv_dw_plain(xk, gk, ks))  # the plain version runs autograd
    check((depthwise_conv.launches - before[0], depthwise_conv_dw.launches - before[1]) == (1, 1),
          "uneven slabs: K3 or K3 dw did not launch at (2,34x128^2,32)")
    check(rel <= KERNEL_RTOL["float32"] and rel_dw <= K3_DW_RTOL,
          f"uneven slabs: K3 at (2,34x128^2,32) max_rel {rel:.3e}, K3 dw max_rel {rel_dw:.3e}")
    print(f"[uneven slabs] K3 at the thinnest haloed slab (2,34x128^2,32) k3 float32: max_abs={err:.3e} max_rel={rel:.3e} "
          f"(tol {KERNEL_RTOL['float32']:.1e}); K3 dw max_abs={err_dw:.3e} max_rel={rel_dw:.3e} (tol {K3_DW_RTOL:.1e}); "
          f"phase {time.perf_counter() - t_phase:.1f} s ({world} processes {started:.1f} s with start-up)")
    del xk, gk, wk, dw
    torch.cuda.empty_cache()
    return launches


WORKFLOW_SHAPE = (240, 240, 155)  # a BraTS-native volume at 1 mm
WORKFLOW_AFFINE = ((-1.0, 0.0, 0.0, 0.0), (0.0, -1.0, 0.0, 239.0), (0.0, 0.0, 1.0, 0.0), (0.0, 0.0, 0.0, 1.0))  # BraTS's LPS


def brats_native_case(rng, shape=WORKFLOW_SHAPE) -> tuple:
    """Four float32 modalities and a uint8 label {0, 1, 2, 3} of a synthetic BraTS-native case: a head ellipsoid
    over 85 % of each axis on a zero background (so the foreground crop keeps the 3 x 3 x 2 windows of a native
    volume at roi 128^3), nested tumour regions (edema 2 around necrosis 1 around enhancing tumour 3), intensities of
    a few hundred with 10 % noise and brighter tumour."""
    import numpy as np

    x, y, z = np.meshgrid(*[np.linspace(-1, 1, s, dtype=np.float32) for s in shape], indexing="ij", sparse=True)
    head = x * x + y * y + z * z < 0.85**2
    cx, cy, cz = rng.uniform(-0.3, 0.3, size=3).astype(np.float32)
    r2 = (x - cx) ** 2 + (y - cy) ** 2 + (z - cz) ** 2
    label = np.zeros(shape, np.uint8)
    label[(r2 < 0.35**2) & head] = 2
    label[r2 < 0.22**2] = 1
    label[r2 < 0.12**2] = 3
    images = []
    for m in range(4):
        img = rng.standard_normal(shape, dtype=np.float32)
        img *= 0.1 * (300 + 100 * m)
        img += 300 + 100 * m
        img += 150 * label
        img[~head] = 0
        images.append(img)
    return images, label


def write_native_cases(root, n_cases: int, seed: int, shape, workers: int, tag: str) -> tuple:
    """``n_cases`` synthetic BraTS-native cases (``brats_native_case``, seeds ``seed + i``) written under ``root`` and a
    Decathlon datalist ``root/datalist.json`` whose fold 0 is the first case (validation) and fold 1 the rest.  The
    files are .nii.gz where writing all of them takes under ~10 s (projected from the first), else .nii.  Returns
    ``(items, suffix, seconds making the arrays, seconds writing them, MB written)``."""
    import json
    from concurrent.futures import ThreadPoolExecutor
    from pathlib import Path

    import numpy as np

    from factorizer_tpu_torch.data import save_nifti

    root = Path(root)

    def write_case(i: int, suffix: str, pool) -> tuple[float, float, dict]:
        t0 = time.perf_counter()
        images, label = brats_native_case(np.random.default_rng(seed + i), shape)
        t1 = time.perf_counter()
        (root / f"case{i}").mkdir(exist_ok=True)
        names = [f"case{i}/{m}{suffix}" for m in ("t1n", "t1c", "t2w", "t2f")]
        arrays = dict(zip(names, images), **{f"case{i}/seg{suffix}": label})
        for job in [pool.submit(save_nifti, root / n, a, np.asarray(WORKFLOW_AFFINE)) for n, a in arrays.items()]:
            job.result()
        item = {"id": f"case{i}", "image": names, "label": f"case{i}/seg{suffix}", "fold": 0 if i == 0 else 1}
        return t1 - t0, time.perf_counter() - t1, item

    suffix = ".nii.gz"
    with ThreadPoolExecutor(workers) as pool:  # zlib and the file writes release the GIL
        made = [write_case(0, suffix, pool)]
        if made[0][1] * n_cases > 10.0:
            print(f"[{tag}] .nii.gz: the first case took {made[0][1]:.2f} s to write, {made[0][1] * n_cases:.1f} s "
                  "projected for all: writing .nii instead")
            for p in (root / "case0").iterdir():
                p.unlink()
            suffix = ".nii"
            made = [write_case(0, suffix, pool)]
        made += [write_case(i, suffix, pool) for i in range(1, n_cases)]
    items = [m[2] for m in made]
    size_mb = sum(p.stat().st_size for p in root.rglob(f"*{suffix}")) / 1e6
    (root / "datalist.json").write_text(json.dumps({"training": items}))
    return items, suffix, sum(m[0] for m in made), sum(m[1] for m in made), size_mb


def workflow_slice(counters: dict, n_cases: int = 5, seed: int = 123, shape=WORKFLOW_SHAPE, roi=(128, 128, 128)) -> None:
    """Phase 22: the training workflow from NIfTI files.  ``n_cases`` synthetic BraTS-native cases are written to a
    temporary directory, a datalist sends all but the first to training (batch 2) and the first to validation, the
    bundle's transforms (``brats23_transforms``) feed ``DataLoader``s of ``min(8, cpu_count)`` worker threads, and
    ``SegmentationTrainer`` trains ``brats23_network()`` (full width, float32) for 3 epochs with a validation at the
    third and a checkpoint each epoch; a second trainer on the same directory resumes at epoch 3 and ends at step 8.
    The launch counters are set to 0 before and after, so the kernels line's counts leave this phase out."""
    import os
    import tempfile
    from pathlib import Path

    import torch

    from factorizer_tpu_torch.data import DataLoader, Dataset, load_decathlon_datalist
    from factorizer_tpu_torch.data.native import native_available
    from factorizer_tpu_torch.data.transforms import Compose
    from factorizer_tpu_torch.train.loop import SegmentationTrainer
    from factorizer_tpu_torch.train.sliding_window import sliding_window_positions
    from factorizer_tpu_torch.train.trainer import create_train_state, make_train_step
    from factorizer_tpu_torch.zoo_scripts import brats23_network, brats23_transforms

    dev = torch.device("cuda", torch.cuda.current_device())
    reset_counters(counters)
    torch.cuda.reset_peak_memory_stats(dev)
    settings = dict(lr=1e-4, weight_decay=1e-5, warmup_epochs=5)  # the bundle's (train.yaml:10-14)
    per_step = {"windowed_nmf_factors": N_BLOCKS, "windowed_nmf_reconstruct": N_BLOCKS,
                "windowed_nmf_bwd": N_BLOCKS * N_SHIFTS, "prenorm_mlp": N_BLOCKS, "prenorm_mlp_bwd": N_BLOCKS}
    per_step = {k: per_step.get(k, 0) for k in counters}
    workers = min(8, os.cpu_count() or 1)
    with tempfile.TemporaryDirectory(prefix="workflow_") as tmp:
        root = Path(tmp)
        _, suffix, gen_s, write_s, size_mb = write_native_cases(root, n_cases, seed, shape, workers, "workflow")
        print(f"[workflow] data: {n_cases} synthetic BraTS-native cases, 4 x {shape} float32 + a uint8 label each, "
              f"{suffix} ({size_mb:.1f} MB), made in {gen_s:.2f} s and written in {write_s:.2f} s (timed apart from the epochs); "
              f"native NIfTI decoder: {native_available()}; cpu count {os.cpu_count()}, loader workers {workers} (threads)")

        train_items = load_decathlon_datalist(root / "datalist.json", "training", fold=0, base_dir=root)
        val_items = load_decathlon_datalist(root / "datalist.json", "validation", fold=0, base_dir=root)
        deterministic, augment = brats23_transforms(roi)
        augment.set_random_state(seed)
        train_loader = DataLoader(Dataset(train_items, Compose(deterministic.transforms + augment.transforms)),
                                  batch_size=2, shuffle=True, num_workers=workers, drop_last=True, seed=seed)
        val_loader = DataLoader(Dataset(val_items, deterministic), batch_size=1, num_workers=workers)
        ckpt_dir = str(root / "ckpt")

        def counted(trainer, record: list) -> None:
            """Check each step's launches, and keep the first step's batch and loss."""
            step = trainer.train_step

            def counted_step(state, batch):
                before = read_counters(counters)
                state, metrics = step(state, batch)
                made = {k: v - before[k] for k, v in read_counters(counters).items()}
                check(made == per_step, f"workflow step {state.step}: launches {made}, expected {per_step}")
                if not record:
                    record.append(({k: v.clone() for k, v in batch.items()}, metrics["loss"].clone()))
                return state, metrics

            trainer.train_step = counted_step

        validation = {}

        def timed_validation(trainer) -> None:
            """Launches of the validation, and the sliding window's own seconds and volume shape."""
            validate, inferer = trainer.validate, trainer._inferer

            def timed_inferer(images, predictor, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = inferer(images, predictor, **kw)
                torch.cuda.synchronize()
                validation.setdefault("infer_s", []).append(time.perf_counter() - t0)
                validation["shape"] = tuple(images.shape)
                return out

            def counted_validate():
                before = read_counters(counters)
                out = validate()
                validation["launches"] = {k: v - before[k] for k, v in read_counters(counters).items()}
                return out

            trainer._inferer, trainer.validate = timed_inferer, counted_validate

        model = brats23_network(generator=torch.Generator().manual_seed(0))
        initial = {k: v.clone() for k, v in model.state_dict().items()}
        trainer = SegmentationTrainer(model, train_loader, val_loader, max_epochs=3, val_interval=3, roi_size=roi,
                                      sw_batch_size=2, overlap=0.5, ckpt_dir=ckpt_dir, seed=seed, **settings)
        first: list = []
        counted(trainer, first)
        timed_validation(trainer)
        t0 = time.perf_counter()
        state = trainer.run()
        run_s = time.perf_counter() - t0
        check(state.step == 6 and [r["epoch"] for r in trainer.history] == [0, 1, 2],
              f"workflow: {state.step} steps, epochs {[r['epoch'] for r in trainer.history]}")
        check(trainer.ckpt.latest_step() == 3, f"workflow: latest checkpoint {trainer.ckpt.latest_step()}")
        losses = [r["loss"] for r in trainer.history]
        dice = trainer.history[-1]["mean_dice"]
        check(all(map(math.isfinite, losses)) and math.isfinite(dice) and 0.0 <= dice <= 1.0,
              f"workflow: losses {losses}, mean dice {dice}")

        # The validation volume: its windows, launches and seconds.
        n_windows = len(sliding_window_positions(validation["shape"][2:], roi, 0.5))
        forwards = -(-n_windows // 2)
        expected_val = {k: forwards * v for k, v in {"windowed_nmf_factors": N_BLOCKS, "windowed_nmf_reconstruct": N_BLOCKS,
                                                     "prenorm_mlp": N_BLOCKS}.items()}
        expected_val = {k: expected_val.get(k, 0) for k in counters}
        slice_volume = -(-len(sliding_window_positions(shape, roi, 0.5)) // 2) * N_BLOCKS
        check(validation["launches"] == expected_val, f"workflow validation: launches {validation['launches']}, expected {expected_val}")
        check(expected_val["windowed_nmf_factors"] == slice_volume,
              f"workflow validation: {expected_val['windowed_nmf_factors']} K1 launches, a [slice] volume has {slice_volume}")

        # The loop's first step against make_train_step on the same batch from a copy of the same initial weights.
        batch, loop_loss = first[0]
        ref_model = brats23_network(generator=torch.Generator().manual_seed(0))
        ref_model.load_state_dict(initial)
        ref_state = create_train_state(ref_model, lr=settings["lr"], weight_decay=settings["weight_decay"])
        _, ref_metrics = make_train_step(ref_model)(ref_state, batch)
        ref_loss, got_loss = ref_metrics["loss"].item(), loop_loss.item()
        loss_rel = abs(got_loss - ref_loss) / abs(ref_loss)
        same_bits = got_loss == ref_loss
        check(same_bits or loss_rel <= 1e-6, f"workflow: the loop's first loss {got_loss!r} differs from make_train_step's {ref_loss!r}")
        check(batch["label"].dtype == torch.uint8 and batch["image"].dtype == torch.float32,
              f"workflow: the batch reached the card as {batch['image'].dtype} / {batch['label'].dtype}")
        del ref_model, ref_state, ref_metrics, batch, first

        saved_model = {k: v.clone() for k, v in trainer.model.state_dict().items()}
        saved_opt = [(k, v.clone()) for s in trainer.state.optimizer.state_dict()["state"].values() for k, v in s.items()]
        timings, history, ckpt_timings = trainer.timings, trainer.history, trainer.ckpt.timings
        del trainer, state, model
        gc.collect()
        torch.cuda.empty_cache()

        # The resume: another model from another seed, the same directory, one more epoch.
        resumed = SegmentationTrainer(brats23_network(generator=torch.Generator().manual_seed(1)), train_loader, val_loader,
                                      max_epochs=4, val_interval=3, roi_size=roi, sw_batch_size=2, overlap=0.5,
                                      ckpt_dir=ckpt_dir, seed=seed, **settings)
        t0 = time.perf_counter()
        resumed.initialize()
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        check(resumed.state.step == 6, f"workflow resume: restored step {resumed.state.step}, expected 6")
        unequal = [k for k, v in resumed.model.state_dict().items() if not torch.equal(v, saved_model[k])]
        restored_opt = [(k, v) for s in resumed.state.optimizer.state_dict()["state"].values() for k, v in s.items()]
        opt_equal = len(restored_opt) == len(saved_opt) and all(
            k == k2 and torch.equal(v.to(v2.device), v2) for (k, v), (k2, v2) in zip(restored_opt, saved_opt))
        check(not unequal and opt_equal, f"workflow resume: restored state differs: {unequal[:5]}, optimizer equal {opt_equal}")
        check(resumed.best_metric == dice, f"workflow resume: best mean dice {resumed.best_metric}, saved {dice}")
        counted(resumed, [])
        resumed.run()
        check(resumed.state.step == 8 and [r["epoch"] for r in resumed.history] == [3],
              f"workflow resume: ended at step {resumed.state.step}, epochs {[r['epoch'] for r in resumed.history]}")
        timings, history = timings + resumed.timings, history + resumed.history
        ckpt_timings = ckpt_timings + resumed.ckpt.timings
        peak = torch.cuda.max_memory_allocated(dev)
        del resumed, saved_model, saved_opt, restored_opt
        train_loader.close()
        val_loader.close()
    gc.collect()
    torch.cuda.empty_cache()

    for t, h in zip(timings, history):
        steps = t["steps"]
        ckpt = next(c for c in ckpt_timings if c["step"] == t["epoch"] + 1)
        line = (f"[workflow] epoch {t['epoch'] + 1}: {h['time_s']:.3f} s (loss {h['loss']:.6f}), {steps} steps x "
                f"{t['step_device_s'] / steps:.4f} s/step on the card (CUDA events) = {t['step_device_s']:.3f} s; loader wait "
                f"{t['loader_wait_s']:.3f} s = {t['loader_wait_s'] / steps:.3f} s per step; checkpoint {ckpt['blocking_s']:.3f} s "
                f"blocking + {ckpt['background_s']:.3f} s in the background")
        if "val_s" in t:
            line += f"; validation {t['val_s']:.3f} s"
        print(line + (" (the first epoch: cuDNN's algorithm search and the first loads)" if t["epoch"] == 0 else ""))
    later = [h["time_s"] for t, h in zip(timings, history) if t["epoch"] > 0]
    later_steps = sum(t["step_device_s"] for t in timings if t["epoch"] > 0) / len(later)
    print(f"[workflow] s/epoch after the first {statistics.mean(later):.3f} against steps x s/step {later_steps:.3f} "
          f"(loader wait {statistics.mean(t['loader_wait_s'] for t in timings if t['epoch'] > 0):.3f} s an epoch); "
          f"3-epoch run {run_s:.1f} s")
    print(f"[workflow] validation: volume {validation['shape']} after the deterministic transforms, {n_windows} windows, "
          f"{validation['infer_s'][0]:.3f} s/volume in the sliding window, mean Dice {dice:.4f}, launches "
          f"{ {k: v for k, v in expected_val.items() if v} } (a [slice] volume's: {slice_volume} each)")
    print(f"[workflow] first step: the loop's loss {got_loss!r}, make_train_step's on the same batch from the same weights "
          f"{ref_loss!r}: " + ("equal bit for bit" if same_bits else f"rel {loss_rel:.2e} (tol 1e-6; cuDNN chose another algorithm)"))
    print(f"[workflow] resume: restored step 6 in {restore_s:.3f} s, epoch 4 from epoch 3, state_dict and AdamW state equal bit "
          f"for bit, best mean Dice recovered, ended at step 8; launches per step { {k: v for k, v in per_step.items() if v} }; "
          f"peak memory {peak / 2**30:.2f} GiB")
    reset_counters(counters)


# What a fresh interpreter spends before a bundle program's first step, in steps (`[bundle]`).
STARTUP_PROBE = """
import json, time
t = [time.perf_counter()]
import torch
t.append(time.perf_counter())
import factorizer_tpu_torch.config.bundle, factorizer_tpu_torch.zoo_scripts
t.append(time.perf_counter())
torch.zeros(1, device="cuda")
torch.cuda.synchronize()
t.append(time.perf_counter())
from factorizer_tpu_torch.ops.kernels import build
build.library()
t.append(time.perf_counter())
try:
    import torch.utils.tensorboard
    tensorboard = True
except ImportError:
    tensorboard = False
t.append(time.perf_counter())
print(json.dumps({"steps": [b - a for a, b in zip(t, t[1:])], "tensorboard": tensorboard}))
"""


def bundle_slice(counters: dict, seed: int = 123, shape=WORKFLOW_SHAPE, roi=(128, 128, 128)) -> dict:
    """Phase 23: the bundles' YAML programs, unedited, through the port's config parser and CLI.  5 synthetic
    BraTS-native cases (4 training, 1 validation; the first 2 also the inference datalist's ``test`` section) are
    written to a temporary directory.  ``factorizer_brats23``: ``train.yaml`` for 2 epochs with a validation as a
    ``python -m factorizer_tpu_torch.bundle run`` subprocess, ``evaluate.yaml`` over its checkpoint in this process, its
    Dice against ``Evaluator`` on the same weights; then ``inference.yaml`` and ``inference_aot.yaml``
    in this process (``config.bundle.run``), over 2 folds (the trained checkpoint and one of other weights): the two
    runs' NIfTI files equal voxel for voxel, eager launches per forward and CUDA-graph replays asserted.
    ``deconver_brats23``: ``train.yaml`` for 1 epoch without validation, then ``inference.yaml`` and
    ``inference_aot.yaml``, their files equal.  ``nnunet_brats23``: ``train.yaml`` for 1 epoch and ``inference.yaml``,
    in this process.  The launch counters are set to 0 before and after, so the kernels
    line's counts leave this phase out, but for ``[hosts]``' processes, whose launches it returns with their
    seconds (:func:`multidevice_programs`)."""
    import io
    import logging
    import os
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch

    from factorizer_tpu_torch import zoo_scripts
    from factorizer_tpu_torch.config import run as bundle_run
    from factorizer_tpu_torch.data import DataLoader, Dataset, load_decathlon_datalist, load_nifti
    from factorizer_tpu_torch.parallel import child_processes
    from factorizer_tpu_torch.train.checkpoint import save_checkpoint
    from factorizer_tpu_torch.train.loop import Evaluator
    from factorizer_tpu_torch.train.metrics import dice_metric
    from factorizer_tpu_torch.train.sliding_window import sliding_window_positions

    repo = Path(__file__).resolve().parent
    workers = min(8, os.cpu_count() or 1)
    forwards = -(-len(sliding_window_positions(shape, roi, 0.5)) // 2)  # window pairs of a native volume
    k1k2 = {"windowed_nmf_factors": N_BLOCKS, "windowed_nmf_reconstruct": N_BLOCKS, "prenorm_mlp": N_BLOCKS}
    k3 = {"depthwise_conv": 3 * N_BLOCKS}
    reset_counters(counters)
    # cuDNN's heuristics, not its timing runs, choose the convolutions here: one choice per shape in every run.
    torch.backends.cudnn.benchmark = False

    def cli(configs: list, overrides: dict, tag: str) -> tuple[float, str]:
        """``python -m factorizer_tpu_torch.bundle run`` with ``configs`` and ``--key value`` overrides, from the
        repository root; its exit code checked.  Returns its seconds and its standard output."""
        cmd = [sys.executable, "-m", "factorizer_tpu_torch.bundle", "run"]
        for c in configs:
            cmd += ["--config_file", str(c)]
        for k, v in overrides.items():
            cmd += [f"--{k}", json.dumps(v) if not isinstance(v, str) else v]
        t0 = time.perf_counter()
        done = subprocess.run(cmd, cwd=repo, capture_output=True, text=True, timeout=600)
        seconds = time.perf_counter() - t0
        check(done.returncode == 0, f"bundle {tag}: exit code {done.returncode}\n{done.stdout[-3000:]}\n{done.stderr[-3000:]}")
        return seconds, done.stdout

    saved_at: list = []

    class SavedTimes(logging.Handler):
        def emit(self, record):
            if record.getMessage().startswith("saved "):
                saved_at.append(time.perf_counter())

    def infer(bundle: str, overrides: dict, aot: bool, per_forward: dict, n_volumes: int, n_folds: int) -> tuple:
        """``inference.yaml`` (with ``inference_aot.yaml`` when ``aot``) in this process: the saved files, launches,
        graph replays, seconds per volume file to file and the sliding window's seconds per volume."""
        configs = repo / "zoo" / bundle / "configs"
        files = [configs / "train.yaml", configs / "inference.yaml"] + ([configs / "inference_aot.yaml"] if aot else [])
        zoo_scripts.ensemble_inference.graph_captures = zoo_scripts.ensemble_inference.graph_replays = 0
        predict_s, sliding = [], zoo_scripts.sliding_window_inference

        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = sliding(*a, **kw)
            torch.cuda.synchronize()
            predict_s.append(time.perf_counter() - t0)
            return out

        handler, logger = SavedTimes(), logging.getLogger("factorizer_tpu_torch")
        logger.addHandler(handler)
        level = logger.level
        logger.setLevel(logging.INFO)
        zoo_scripts.sliding_window_inference = timed
        reset_counters(counters)
        saved_at.clear()
        try:
            t0 = time.perf_counter()
            paths = bundle_run([str(f) for f in files], **overrides)["inferencer"]
        finally:
            zoo_scripts.sliding_window_inference = sliding
            logger.removeHandler(handler)
            logger.setLevel(level)
        made = read_counters(counters)
        replays, captures = zoo_scripts.ensemble_inference.graph_replays, zoo_scripts.ensemble_inference.graph_captures
        check(len(paths) == n_volumes and len(saved_at) == n_volumes, f"bundle {bundle} inference: saved {paths}")
        n_forwards = n_volumes * n_folds * forwards
        if aot:
            warm = zoo_scripts._GraphedForward.WARMUP + 1  # the warm-up forwards launch, the captured one only counts
            expected = {k: warm * per_forward.get(k, 0) for k in counters}
            check(captures == 1 and replays == n_forwards, f"bundle {bundle} graph: {captures} captures, {replays} replays, "
                                                           f"expected 1 and {n_forwards}")
        else:
            expected = {k: n_forwards * per_forward.get(k, 0) for k in counters}
            check(captures == replays == 0, f"bundle {bundle} eager inference replayed a graph")
        check(made == expected, f"bundle {bundle} inference{' aot' if aot else ''}: launches {made}, expected {expected}")
        per_volume = [saved_at[0] - t0] + [b - a for a, b in zip(saved_at, saved_at[1:])]
        return paths, made, replays, per_volume, predict_s

    def equal_files(paths_a, paths_b, tag: str) -> str:
        shapes = []
        for a, b in zip(paths_a, paths_b):
            va, vb = load_nifti(a).data, load_nifti(b).data
            check(va.shape == vb.shape and np.array_equal(va, vb), f"bundle {tag}: {a} and {b} differ in "
                                                                   f"{int((va != vb).sum()) if va.shape == vb.shape else 'shape'} voxels")
            check(tuple(va.shape[-3:]) == tuple(shape), f"bundle {tag}: prediction of shape {va.shape}")
            shapes.append(tuple(va.shape))
        return f"{len(paths_a)} files {shapes[0]} equal voxel for voxel"

    with tempfile.TemporaryDirectory(prefix="bundle_") as tmp:
        root = Path(tmp)
        items, suffix, _, write_s, size_mb = write_native_cases(root, 5, seed, shape, workers, "bundle")
        datalist = root / "datalist.json"
        datalist.write_text(json.dumps({"training": items, "test": items[:2]}))
        data = {"data_dir": str(root), "datalist_path": str(datalist), "num_workers": workers}
        print(f"[bundle] data: 5 synthetic BraTS-native cases {suffix} ({size_mb:.1f} MB, written in {write_s:.2f} s), "
              f"training 4, validation 1, test 2; loader workers {workers} (threads)")
        t0 = time.perf_counter()
        probe = subprocess.run([sys.executable, "-c", STARTUP_PROBE], cwd=repo, capture_output=True, text=True, timeout=300)
        wall = time.perf_counter() - t0
        check(probe.returncode == 0, f"bundle: the start-up probe failed\n{probe.stderr[-2000:]}")
        startup = json.loads(probe.stdout.strip().splitlines()[-1])
        steps = dict(zip(("import torch", "import the port's config and zoo_scripts", "CUDA context",
                          "load the kernel library (built)", "import torch.utils.tensorboard"), startup["steps"]))
        print(f"[bundle] a fresh interpreter's fixed cost: {wall:.2f} s, of it the interpreter's own start and exit "
              f"{wall - sum(steps.values()):.2f} s, " + ", ".join(f"{k} {v:.2f} s" for k, v in steps.items())
              + f" (tensorboard {'present' if startup['tensorboard'] else 'absent'})")

        # factorizer_brats23: train.yaml through the CLI.
        fz = repo / "zoo" / "factorizer_brats23" / "configs"
        out = root / "factorizer"
        train_s, _ = cli([fz / "train.yaml"], {**data, "output_dir": str(out), "max_epochs": 2, "val_interval": 2}, "train")
        history = [json.loads(line) for line in (out / "history.jsonl").read_text().splitlines()]
        train_epoch_s = history[0]["time_s"]
        ckpt_dir = out / "ckpt"
        check((ckpt_dir / "step_2.pt").is_file(), f"bundle train: no step_2.pt in {sorted(p.name for p in ckpt_dir.iterdir())}")
        losses = [h["loss"] for h in history]
        dice = history[-1].get("mean_dice", float("nan"))
        check(len(history) == 2 and all(map(math.isfinite, losses)) and 0.0 <= dice <= 1.0,
              f"bundle train: history {history}")
        print(f"[bundle] factorizer_brats23 train.yaml (CLI, subprocess): {train_s:.1f} s end to end, epochs "
              + ", ".join(f"{h['time_s']:.3f} s (loss {h['loss']:.6f})" for h in history)
              + f"; validation mean Dice {dice:.4f}; checkpoint step_2.pt (numbered by epoch); 2 x 2 steps")

        # evaluate.yaml over the trainer's ckpt_dir, in this process with the CLI's default TF32 setting for cuDNN.
        ev = root / "evaluate"
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True
        t0 = time.perf_counter()
        try:  # the program prints its metrics as the CLI's last line; here they go into this phase's line
            with contextlib.redirect_stdout(io.StringIO()):
                metrics = bundle_run([str(fz / "train.yaml"), str(fz / "evaluate.yaml")], **data, output_dir=str(ev),
                                     ckpt_path=str(ckpt_dir))["evaluator"]
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        eval_s = time.perf_counter() - t0
        cases = json.loads((ev / "case_metrics.json").read_text())["cases"]
        csvs = sorted(p.name for p in (ev / "metrics").iterdir())
        preds = sorted((ev / "preds").glob("*.nii.gz"))
        check(len(cases) == 1 and {"mean_dice_raw.csv", "hd95_raw.csv", "metrics.csv"} <= set(csvs) and len(preds) == 1,
              f"bundle evaluate: cases {cases}, CSVs {csvs}, predictions {preds}")
        pred_shape = load_nifti(preds[0]).data.shape
        check(tuple(pred_shape[-3:]) == tuple(shape), f"bundle evaluate: prediction of shape {pred_shape}")
        # The same weights through Evaluator, with the same TF32 setting.
        model = zoo_scripts.brats23_network(generator=torch.Generator().manual_seed(0))
        variables = zoo_scripts.load_model_checkpoint(model, ckpt_dir)
        val_items = load_decathlon_datalist(datalist, "validation", fold=0, base_dir=root)
        deterministic, _ = zoo_scripts.brats23_transforms(roi)
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True
        try:
            batch = next(iter(DataLoader(Dataset(val_items, deterministic), batch_size=1, num_workers=0)))
            preds_in = Evaluator(model, variables, roi, 2, 0.5, compute_hd95=False).predict_mask(batch["image"])
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        dice_in = float(np.nanmean(np.asarray(dice_metric(preds_in, np.asarray(batch["label"])))))
        check(dice_in == metrics["mean_dice"], f"bundle evaluate: mean Dice {metrics['mean_dice']!r}, Evaluator "
                                               f"{dice_in!r}")
        print(f"[bundle] factorizer_brats23 evaluate.yaml (in this process): {eval_s:.1f} s end to end for 1 case; metrics "
              f"{metrics}; case_metrics.json, {csvs}, {preds[0].name} {pred_shape}; mean Dice equal to Evaluator's in this "
              f"process on the same weights ({dice_in!r})")
        del model, variables, batch, preds_in

        # inference.yaml, then inference_aot.yaml, in this process over 2 folds.
        fold1 = root / "fold1.pt"
        save_checkpoint(fold1, zoo_scripts.brats23_network(generator=torch.Generator().manual_seed(1)))
        common = {**data, "ckpt_paths": [str(ckpt_dir), str(fold1)]}
        runs = {}
        for aot in (False, True):
            runs[aot] = infer("factorizer_brats23", {**common, "output_dir": str(root / f"infer_{int(aot)}")}, aot, k1k2, 2, 2)
            gc.collect()
            torch.cuda.empty_cache()
        same = equal_files(runs[False][0], runs[True][0], "factorizer inference")
        for aot, (_, made, replays, per_volume, predict_s) in runs.items():
            how = (f"CUDA graph: {replays} replays x {N_BLOCKS} K1 factors / {N_BLOCKS} K1 reconstruct / {N_BLOCKS} K2 per "
                   f"captured forward (launches counted at capture: {made['windowed_nmf_factors']} each, the warm-up and "
                   f"the capture)") if aot else (f"eager: {made['windowed_nmf_factors']} K1 factors, "
                                                 f"{made['windowed_nmf_reconstruct']} K1 reconstruct, {made['prenorm_mlp']} K2 "
                                                 f"launches = 2 volumes x 2 folds x {forwards} forwards x {N_BLOCKS}")
            print(f"[bundle] factorizer_brats23 inference{'_aot' if aot else ''}.yaml: s/volume file to file "
                  + ", ".join(f"{t:.3f}" for t in per_volume) + " (the first with the run's set-up"
                  + (", warm-up and capture" if aot else "") + "); sliding window per volume and fold "
                  + ", ".join(f"{t:.3f}" for t in predict_s) + f" s; {how}")
        print(f"[bundle] factorizer_brats23 inference eager against CUDA graph: {same}; predict per fold after the first "
              f"volume: eager {statistics.mean(runs[False][4][2:]):.4f} s, graph {statistics.mean(runs[True][4][2:]):.4f} s "
              f"(graph / eager {statistics.mean(runs[True][4][2:]) / statistics.mean(runs[False][4][2:]):.3f})")

        # deconver_brats23: train.yaml for 1 epoch without validation, then inference eager and as a CUDA graph.
        dz = repo / "zoo" / "deconver_brats23" / "configs"
        dout = root / "deconver"
        t0 = time.perf_counter()
        trainer = bundle_run(str(dz / "train.yaml"), **data, output_dir=str(dout), max_epochs=1, val_interval=0)["trainer"]
        torch.backends.cudnn.benchmark = False  # the trainer turned it on
        d_train_s = time.perf_counter() - t0
        check(trainer.state.step == 2 and (dout / "ckpt" / "step_1.pt").is_file() and math.isfinite(trainer.history[0]["loss"]),
              f"bundle deconver train: step {trainer.state.step}, history {trainer.history}")
        print(f"[bundle] deconver_brats23 train.yaml (in this process): {d_train_s:.1f} s, 1 epoch of 2 steps "
              f"{trainer.history[0]['time_s']:.3f} s, loss {trainer.history[0]['loss']:.6f}, no validation")
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        druns = {}
        for aot in (False, True):
            druns[aot] = infer("deconver_brats23", {**data, "ckpt_paths": [str(dout / "ckpt")],
                                                    "output_dir": str(root / f"dinfer_{int(aot)}")}, aot, k3, 2, 1)
            gc.collect()
            torch.cuda.empty_cache()
        same = equal_files(druns[False][0], druns[True][0], "deconver inference")
        print(f"[bundle] deconver_brats23 inference eager against CUDA graph: {same}; s/volume file to file eager "
              + ", ".join(f"{t:.3f}" for t in druns[False][3]) + ", graph " + ", ".join(f"{t:.3f}" for t in druns[True][3])
              + f"; sliding window per volume eager {', '.join(f'{t:.3f}' for t in druns[False][4])} s, graph "
              + f"{', '.join(f'{t:.3f}' for t in druns[True][4])} s; graph {druns[True][2]} replays x {3 * N_BLOCKS} K3 per "
              + f"captured forward, eager {druns[False][1]['depthwise_conv']} K3 launches")

        # nnunet_brats23 (a baseline, stock PyTorch): train.yaml for 1 epoch in this process (the CLI's own start-up is
        # factorizer_brats23's above), then inference.yaml here.
        del druns
        gc.collect()
        torch.cuda.empty_cache()
        nz = repo / "zoo" / "nnunet_brats23" / "configs"
        nout = root / "nnunet"
        t0 = time.perf_counter()
        trainer = bundle_run(str(nz / "train.yaml"), **data, output_dir=str(nout), max_epochs=1, val_interval=0)["trainer"]
        torch.backends.cudnn.benchmark = False  # the trainer turned it on
        n_train_s = time.perf_counter() - t0
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        history = [json.loads(line) for line in (nout / "history.jsonl").read_text().splitlines()]
        check(len(history) == 1 and math.isfinite(history[0]["loss"]) and (nout / "ckpt" / "step_1.pt").is_file(),
              f"bundle nnunet train: history {history}, checkpoints {sorted(p.name for p in (nout / 'ckpt').iterdir())}")
        print(f"[bundle] nnunet_brats23 train.yaml (in this process): {n_train_s:.1f} s, 1 epoch of 2 steps "
              f"{history[0]['time_s']:.3f} s, loss {history[0]['loss']:.6f}, checkpoint step_1.pt, no validation")
        npaths, nmade, _, nper_volume, npredict_s = infer("nnunet_brats23", {**data, "ckpt_paths": [str(nout / "ckpt")],
                                                                             "output_dir": str(root / "ninfer")}, False, {}, 2, 1)
        nshapes = [tuple(load_nifti(path).data.shape) for path in npaths]
        check(all(s[-3:] == tuple(shape) for s in nshapes), f"bundle nnunet inference: predictions of shapes {nshapes}")
        print(f"[bundle] nnunet_brats23 inference.yaml (in this process, 1 fold): {len(npaths)} predictions {nshapes} at "
              f"the native shape; s/volume file to file " + ", ".join(f"{t:.3f}" for t in nper_volume)
              + "; sliding window per volume " + ", ".join(f"{t:.3f}" for t in npredict_s)
              + f" s; launches of the port's kernels {sum(nmade.values())}")

        # 26., 27., 32. the multi-device programs under torchrun: two processes on this card (gloo).
        hosts = multidevice_programs(repo, root, {**data, "num_workers": max(1, workers // 2)}, train_epoch_s)
        # The spatial programs' sharded states were written whole: the one-process format, which the inference
        # program loads.
        for bundle, out in (("factorizer_brats23", "factorizer_tp"), ("deconver_brats23", "deconver_tp")):
            model = bundle_network(bundle)[0]
            path = root / out / "ckpt" / "step_1.pt"
            payload = torch.load(path, map_location="cpu", weights_only=True)
            weights = zoo_scripts.load_model_checkpoint(model, path)  # every entry of the model with its shape
            shapes = [tuple(p.shape) for p in model.parameters()]
            moments = payload["optimizer"]["state"]
            whole = (sorted(payload) == ["model", "optimizer", "step"] and sorted(moments) == list(range(len(shapes)))
                     and all(tuple(moments[i][m].shape) == shape for i, shape in enumerate(shapes)
                             for m in ("exp_avg", "exp_avg_sq")))
            check(whole, f"bundle tp {bundle}: {path.name} is not a whole one-process checkpoint")
            print(f"[bundle tp] {bundle} train_tp.yaml's checkpoint {path.name} (a state sharded over the model axis, "
                  f"gathered on both processes, written by the primary): whole, the one-process format ({len(weights)} "
                  f"model entries, AdamW's moments of all {len(shapes)} parameters at their whole shapes, step "
                  f"{payload['step']}); zoo_scripts.load_model_checkpoint loads it")
            del model, payload, weights
        druns = infer("deconver_brats23", {**data, "ckpt_paths": [str(root / "deconver_tp" / "ckpt")],
                                           "output_dir": str(root / "dinfer_tp")}, False, k3, 2, 1)
        print(f"[bundle tp] deconver_brats23 inference.yaml over train_tp.yaml's checkpoint (in this process): "
              f"{len(druns[0])} predictions, s/volume file to file {', '.join(f'{t:.3f}' for t in druns[3])}, "
              f"{druns[1]['depthwise_conv']} K3 launches")
        del druns
    left = child_processes()
    check(not left, f"bundle: processes still alive: {left}")
    reset_counters(counters)
    gc.collect()
    torch.cuda.empty_cache()
    return hosts


# A program the bundle CLI runs after `run` in `[bundle multidevice]` / `[bundle tp]` / `[hosts]`: each process prints its
# epoch losses.
REPORT_LOSSES = "$print('[losses] %d %s' % (jax.process_index(), [h['loss'] for h in @trainer.history]), flush=True)"
# ... and the count of parameters its train state holds sharded over the model axis.
REPORT_SHARDS = ("$print('[shards] %d %d' % (jax.process_index(), 0 if @trainer.state.shards is None else "
                 "len(@trainer.state.shards.names)), flush=True)")


def report_launches() -> str:
    """The program that the bundle CLI runs after ``REPORT_LOSSES``: each process prints the train steps it took and
    its launches since it started, by kernel in :func:`kernel_counters`' order."""
    pairs = [(wrapper.__name__, attr) for wrapper, attr in kernel_counters().values()]
    return ("$print('[launches] %d %d %s' % (jax.process_index(), sum(t['steps'] for t in @trainer.timings), "
            f"[getattr(getattr(ftx.ops.kernels, w), a) for w, a in {pairs!r}]), flush=True)")


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def multidevice_programs(repo, root, data: dict, train_epoch_s: float) -> dict:
    """Phases 26, 27 and 32, on ``[bundle]``'s cases: ``train.yaml`` + ``train_multidevice.yaml`` of
    factorizer_brats23 and deconver_brats23, then ``train.yaml`` + ``train_tp.yaml`` of both at the same time, 1
    epoch each, through ``python -m torch.distributed.run ... -m factorizer_tpu_torch.bundle run``: 2 processes under
    one agent (``--nproc_per_node 2``), factorizer_brats23's ``train_tp.yaml`` under two node agents of one process
    each (``--nnodes 2``, ``[hosts]``).  Exit 0, each process's epoch losses equal, one checkpoint, written by the
    primary; s/epoch beside ``train.yaml``'s.  Returns ``[hosts]``' seconds and launches (both processes, by
    kernel)."""
    from pathlib import Path

    started: list = []  # the launchers, stopped on the way out if a check fails

    def torchrun(bundle: str, overlay: str, overrides: dict, port: int, nodes: int = 1):
        """Start the program, 2 processes under one agent or one under each of ``nodes`` agents; returns a function
        that waits for it, checks it and returns its seconds, its epoch's record, each process's losses and
        ``(steps, launches by kernel)``, and the ``[distributed]`` line it printed."""
        configs = repo / "zoo" / bundle / "configs"
        program = ["--master_addr", "127.0.0.1", "--master_port", str(port), "-m", "factorizer_tpu_torch.bundle", "run",
                   "--config_file", str(configs / "train.yaml"), "--config_file", str(configs / overlay),
                   "--run_id", "run", "--run_id", "report_losses", "--run_id", "report_launches",
                   "--run_id", "report_shards", "--report_losses", REPORT_LOSSES, "--report_launches",
                   report_launches(), "--report_shards", REPORT_SHARDS]
        for k, v in overrides.items():
            program += [f"--{k}", json.dumps(v) if not isinstance(v, str) else v]
        out = Path(overrides["output_dir"])
        t0 = time.perf_counter()
        agents = []
        for node in range(nodes):
            layout = (["--nproc_per_node", "2"] if nodes == 1 else
                      ["--nnodes", str(nodes), "--node_rank", str(node), "--nproc_per_node", "1"])
            logs = root / f"{out.name}.{node}.stdout.txt", root / f"{out.name}.{node}.stderr.txt"
            with open(logs[0], "w") as stdout, open(logs[1], "w") as stderr:
                proc = subprocess.Popen([sys.executable, "-m", "torch.distributed.run", *layout, *program], cwd=repo,
                                        stdout=stdout, stderr=stderr, text=True)
            started.append(proc)
            agents.append((proc, logs))

        def finish() -> dict:
            codes = []
            for proc, _ in agents:
                try:
                    codes.append(proc.wait(timeout=max(1.0, t0 + 600 - time.perf_counter())))
                except subprocess.TimeoutExpired:
                    proc.kill()
                    codes.append(proc.wait())
            seconds = time.perf_counter() - t0
            printed = "".join(logs[0].read_text() for _, logs in agents)
            errors = "".join(logs[1].read_text() for _, logs in agents)
            tag = f"{bundle} {overlay}" + (f" ({nodes} node agents)" if nodes > 1 else "")
            check(codes == [0] * nodes, f"bundle {tag}: exit codes {codes}\n{printed[-3000:]}\n{errors[-3000:]}")
            losses = {int(rank): json.loads(values)
                      for rank, values in re.findall(r"\[losses\] (\d+) (\[[^\]]*\])", printed)}
            launches = {int(rank): (int(steps), dict(zip(kernel_counters(), json.loads(counts))))
                        for rank, steps, counts in re.findall(r"\[launches\] (\d+) (\d+) (\[[^\]]*\])", printed)}
            shards = {int(rank): int(n) for rank, n in re.findall(r"\[shards\] (\d+) (\d+)", printed)}
            history = [json.loads(line) for line in (out / "history.jsonl").read_text().splitlines()]
            saved = sorted(p.name for p in (out / "ckpt").glob("*.pt"))
            check(sorted(losses) == [0, 1] and losses[0] == losses[1] and all(map(math.isfinite, losses[0]))
                  and sorted(launches) == [0, 1],
                  f"bundle {tag}: the processes' epoch losses {losses}, launches {launches}\n{printed[-3000:]}")
            check(saved == ["step_1.pt"] and len(history) == 1 and history[0]["loss"] == losses[0][0],
                  f"bundle {tag}: checkpoints {saved}, history {history}")
            joined = re.search(r"\[distributed\] (.*)", printed)
            check(sorted(shards) == [0, 1] and shards[0] == shards[1]
                  and (shards[0] >= 1) == overlay.endswith("_tp.yaml"),
                  f"bundle {tag}: parameters sharded by process {shards}")
            return {"seconds": seconds, "record": history[0], "losses": losses, "launches": launches,
                    "distributed": joined.group(1) if joined else "backend not printed", "sharded": shards[0]}

        return finish

    try:
        return bundle_programs(root, data, train_epoch_s, torchrun)
    finally:
        for proc in started:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def backend_of(run: dict) -> str:
    """``backend <name>`` from a program's ``[distributed]`` line."""
    return run["distributed"].split(" (")[0]


def bundle_programs(root, data: dict, train_epoch_s: float, torchrun) -> dict:
    """The body of :func:`multidevice_programs`: deconver_brats23's data-parallel program alone (its two processes
    take most of the card), then factorizer_brats23's data-parallel program and the two spatial ones at the same time,
    6 processes on the card (one start-up's wait instead of two); factorizer_brats23's spatial program under two node
    agents.  Returns ``[hosts]``' seconds and launches."""

    def multidevice_line(bundle: str, r: dict, beside: str = "") -> None:
        print(f"[bundle multidevice] {bundle} train.yaml + train_multidevice.yaml (torchrun, 2 processes, "
              f"{backend_of(r)}, one card{beside}): {r['seconds']:.1f} s end to end, epoch {r['record']['time_s']:.3f} s "
              f"of 1 step a process on its 2 cases (train.yaml's first epoch in one process, 2 steps on 4 cases: "
              f"{train_epoch_s:.3f} s), loss {r['losses'][0][0]:.6f} on both processes, one checkpoint step_1.pt "
              "written by the primary. " + shared_card_note(2))

    def multidevice(bundle: str, port: int):
        return torchrun(bundle, "train_multidevice.yaml", {**data, "output_dir": str(root / f"{bundle}_multidevice"),
                                                            "max_epochs": 1, "val_interval": 0}, port)

    multidevice_line("deconver_brats23", multidevice("deconver_brats23", free_port())())
    ports: list = []
    while len(ports) < 3:
        port = free_port()
        if port not in ports:
            ports.append(port)
    factorizer_dp = multidevice("factorizer_brats23", ports[2])
    # 32. [hosts]: two node agents of one process each stand in for two hosts; they share this card, so every process
    # must take gloo (a host alone, with a card for its one process, would take NCCL, which refuses two ranks on one
    # device).
    factorizer_tp = torchrun("factorizer_brats23", "train_tp.yaml", {**data, "output_dir": str(root / "factorizer_tp"),
                                                                    "max_epochs": 1, "val_interval": 1}, ports[0], nodes=2)
    deconver_tp = torchrun("deconver_brats23", "train_tp.yaml", {**data, "output_dir": str(root / "deconver_tp"),
                                                                "max_epochs": 1, "val_interval": 0}, ports[1])
    hosts = factorizer_tp()
    record, per_step = hosts["record"], tp_routes(2, 128, 8, BRATS_SHIFTS, 2)[0]
    check(re.fullmatch(r"backend gloo \(1 CUDA device\(s\) for 2 process\(es\)\), world size 2, 2 host\(s\): "
                       r"\S+/node 0 1 process\(es\), \S+/node 1 1 process\(es\)", hosts["distributed"]) is not None,
          f"hosts: the processes joined as {hosts['distributed']!r}")
    launches = dict.fromkeys(kernel_counters(), 0)
    for rank, (steps, made) in hosts["launches"].items():
        # Training runs on slabs (K5, K1 on the gathered levels, K2), validation on whole volumes (K1 and K2 forward).
        check(steps == 2 and all(made[k] == steps * per_step[k] for k in ("windowed_nmf_slab", "windowed_nmf_slab_bwd",
                                                                          "windowed_nmf_bwd", "prenorm_mlp_bwd"))
              and all(made[k] > steps * per_step[k] for k in ("windowed_nmf_factors", "windowed_nmf_reconstruct",
                                                               "prenorm_mlp")),
              f"hosts rank {rank}: {steps} steps, launches {made}, per step on slabs {per_step}")
        for k, v in made.items():
            launches[k] += v
    made = hosts["launches"][0][1]
    print(f"[hosts] factorizer_brats23 train.yaml + train_tp.yaml under two torchrun node agents (--nnodes 2, "
          f"--node_rank 0 / 1, one process each: two hosts on this card, run beside deconver_brats23's [bundle tp] and "
          f"factorizer_brats23's [bundle multidevice]): "
          f"[distributed] {hosts['distributed']}; {hosts['seconds']:.1f} s end to end, epoch {record['time_s']:.3f} s of 2 "
          f"spatial steps on 4 cases (train.yaml's first epoch in one process: {train_epoch_s:.3f} s), loss "
          f"{hosts['losses'][0][0]:.6f} on both processes, validation of whole volumes on each process, mean Dice "
          f"{record['mean_dice']:.4f}; one checkpoint step_1.pt written by the primary; per step and process K5 "
          f"{per_step['windowed_nmf_slab']} + {per_step['windowed_nmf_slab_bwd']} bwd, K1 bwd "
          f"{per_step['windowed_nmf_bwd']}, K2 bwd {per_step['prenorm_mlp_bwd']}; {hosts['sharded']} parameters sharded "
          f"over the model axis on each process; process 0 in all (training and "
          f"validation) {({k: v for k, v in made.items() if v})}. " + shared_card_note(2))
    check(0.0 <= record["mean_dice"] <= 1.0, f"hosts: mean Dice {record['mean_dice']}")
    r = deconver_tp()
    print(f"[bundle tp] deconver_brats23 train.yaml + train_tp.yaml (torchrun, 2 processes, {backend_of(r)}, one card, "
          f"a model axis of 2, run beside [hosts] and factorizer_brats23's [bundle multidevice]): {r['seconds']:.1f} s "
          f"end to end, epoch "
          f"{r['record']['time_s']:.3f} s of 2 spatial steps on 4 cases, K3 on haloed slabs (the epoch of train.yaml "
          f"in one process: [bundle]'s line), loss {r['losses'][0][0]:.6f} on both processes, {r['sharded']} parameters "
          f"sharded over the model axis on each; one checkpoint step_1.pt written by the primary. " + shared_card_note(2))
    multidevice_line("factorizer_brats23", factorizer_dp(), ", run beside [hosts] and [bundle tp]")
    return {"seconds": hosts["seconds"], "launches": launches}


# The baseline bundles on the card (`[baselines]`): name -> (served input, roi, the training batch), from their
# train.yaml (roi_size, batch_size) and the data each bundle reads: BraTS-native volumes, ISLES'22 volumes at
# 2 mm, FIVES fundus images.
BASELINE_BUNDLES = {
    "nnunet_brats23": ((1, 4, 240, 240, 155), (128, 128, 128), 2),
    "segresnet_brats23": ((1, 4, 240, 240, 155), (128, 128, 128), 2),
    "nnunet_isles22": ((1, 2, 112, 112, 73), (64, 64, 64), 8),
    "segresnet_isles22": ((1, 2, 112, 112, 73), (64, 64, 64), 8),
    "swinunetr_isles22": ((1, 2, 112, 112, 73), (64, 64, 64), 8),
    "nnunet_fives": ((16, 3, 512, 512), (512, 512), 16),
    "segresnet_fives": ((16, 3, 512, 512), (512, 512), 16),
}
BASELINE_AMP = ("nnunet_brats23", "segresnet_brats23", "swinunetr_isles22")
# The networks that run under cuDNN's timing search (benchmark mode, as SegmentationTrainer runs): the transformers'
# steps are several times slower on its heuristics' choices, and their search takes seconds; the CNNs' search takes
# minutes with TF32 off (dozens of full-width 3-D f32 convolution shapes), so they run on the heuristics' choices.
# A plan, once chosen for a shape, is reused in the process whichever way it was chosen: the CNNs run first.
BASELINE_BENCHMARK = ("swinunetr_isles22", "UNETR")
# The card's float32 logits (TF32 off) against the CPU's from the same weights on one window: cuDNN and oneDNN
# sum each convolution in their own orders (2^-24 relative each), and the instance / group norms and up to 22
# layers carry the differences to the head.
CPU_RTOL = 1e-3


def baselines_slice(counters: dict) -> None:
    """Phase 24: the seven baseline bundles and UNETR at full width on the card, stock PyTorch (cuDNN, cuBLAS) with no
    kernel of the port.  Each bundle's ``network_def`` is built from its unedited ``train.yaml`` through the port's
    ``ConfigParser`` (weights from the bundle's seed); it serves 2 requests through ``ensemble_predict`` after a warm-up
    request (BraTS-native and ISLES'22 volumes; FIVES: one forward of 16 images), takes 1 warm-up and 3 timed steps of
    ``make_train_step`` at its batch x roi in float32 (and in bfloat16, ``amp: true``, for three), and its float32
    logits on one window (64^3 or one 512^2 image) are held against the CPU forward of the same weights.  UNETR at its
    canonical configuration takes a forward and the same steps at batch 2.  cuDNN's heuristics choose the CNNs'
    convolutions, its timing search the transformers' (``BASELINE_BENCHMARK``).  The launch counters must read 0
    throughout."""
    import copy

    import torch

    import factorizer_tpu_torch as ftt
    from factorizer_tpu_torch.train.sliding_window import sliding_window_positions
    from factorizer_tpu_torch.train.trainer import create_train_state, make_train_step
    from factorizer_tpu_torch.zoo_scripts import ensemble_predict

    dev = torch.device("cuda", torch.cuda.current_device())
    t_phase = time.perf_counter()
    reset_counters(counters)
    gen = torch.Generator(device=dev)

    def steps(model, batch: dict, cfg: dict, tag: str) -> tuple:
        state = create_train_state(model, lr=cfg["learning_rate"], weight_decay=cfg["weight_decay"])
        step = make_train_step(state.model)
        losses, seconds = [], []
        for i in range(4):
            if i == 1:
                torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            losses.append(metrics["loss"].item())
            check(math.isfinite(losses[-1]) and math.isfinite(metrics["grad_norm"].item()),
                  f"{tag}: step {i + 1} loss {losses[-1]}, grad norm {metrics['grad_norm'].item()}")
        mem = torch.cuda.max_memory_allocated(dev) / 2**30
        del state, step, metrics
        return statistics.mean(seconds[1:]), seconds, mem, losses

    def cudnn_choice(name: str) -> str:
        torch.backends.cudnn.benchmark = name in BASELINE_BENCHMARK
        return "cuDNN's timing search" if torch.backends.cudnn.benchmark else "cuDNN's heuristics"

    for bundle, (volume, roi, b) in BASELINE_BUNDLES.items():
        t_bundle = time.perf_counter()
        choice = cudnn_choice(bundle)
        model, cfg = bundle_network(bundle, amp=False)
        name = type(model).__name__
        n_params = sum(p.numel() for p in model.parameters())
        c_in, c_out = volume[1], 3 if bundle.endswith("brats23") else 1
        model.eval()
        # serve: 2 requests after a warm-up one (FIVES: 16 images a forward, as the Deconver FIVES phase runs them)
        requests = [torch.randn(volume, device=dev, generator=gen.manual_seed(300 + i)) for i in range(3)]
        n_windows = len(sliding_window_positions(volume[2:], roi, 0.5))
        served = []
        with torch.inference_mode():
            for i, image in enumerate(requests):
                if i == 1:
                    torch.cuda.reset_peak_memory_stats(dev)
                t0 = time.perf_counter()
                if len(roi) == 3:
                    mask, probs = ensemble_predict([model], image, roi, 2, 0.5)
                else:
                    probs = torch.sigmoid(model(image))
                torch.cuda.synchronize()
                served.append(time.perf_counter() - t0)
                check(tuple(probs.shape) == (volume[0], c_out, *volume[2:]) and bool(torch.isfinite(probs).all()),
                      f"baselines {bundle}: served {tuple(probs.shape)} or non-finite probabilities")
        serve_mem = torch.cuda.max_memory_allocated(dev) / 2**30
        # the card's float32 logits against the CPU's on one window, TF32 off
        window = (1, c_in, *((64, 64, 64) if len(roi) == 3 else roi))
        x = torch.randn(window, generator=torch.Generator().manual_seed(400))
        with torch.inference_mode():
            got = model(x.to(dev)).cpu()
            ref = copy.deepcopy(model).cpu()(x)
        err, rel = compare(got, ref)
        check(bool(torch.isfinite(got).all()) and rel <= CPU_RTOL, f"baselines {bundle}: card vs CPU logits {rel:.3e}")
        del requests, probs, got, ref
        # train, float32
        batch = roi_batch(b, c_in, c_out, roi, seed=500)
        s_step, seconds, mem, losses = steps(model.train(), batch, cfg, f"baselines {bundle} float32")
        what = "s/volume" if len(roi) == 3 else "s per forward of 16 images"
        line = (f"[baselines] {bundle}: {name} ({n_params / 1e6:.2f}M parameters) float32, {choice}; serve {tuple(volume)} at roi "
                f"{tuple(roi)} ({n_windows} windows, sw_batch 2): {statistics.mean(served[1:]):.4f} {what} (requests "
                + ", ".join(f"{t:.4f}" for t in served[1:]) + f" s after a {served[0]:.2f} s warm-up), peak "
                f"{serve_mem:.2f} GiB; train batch {b} x {tuple(roi)}: {s_step:.4f} s/step (steps "
                + ", ".join(f"{t:.4f}" for t in seconds[1:]) + f" s after a {seconds[0]:.2f} s warm-up), peak {mem:.2f} GiB, "
                f"loss {' -> '.join(f'{v:.5f}' for v in losses)}; card vs CPU logits on {window}: max_abs={err:.3e} "
                f"max_rel={rel:.3e} (tol {CPU_RTOL:.0e})")
        del model, batch
        gc.collect()
        torch.cuda.empty_cache()
        if bundle in BASELINE_AMP:
            model, cfg = bundle_network(bundle, amp=True)
            batch = roi_batch(b, c_in, c_out, roi, seed=500)
            s16, seconds, mem16, losses = steps(model.train(), batch, cfg, f"baselines {bundle} bfloat16")
            line += (f"; bfloat16 (amp: true) train: {s16:.4f} s/step (steps " + ", ".join(f"{t:.4f}" for t in seconds[1:])
                     + f" s), peak {mem16:.2f} GiB, loss {' -> '.join(f'{v:.5f}' for v in losses)}")
            del model, batch
            gc.collect()
            torch.cuda.empty_cache()
        print(line + f"; {time.perf_counter() - t_bundle:.1f} s")

    # UNETR, which no bundle ships, at its canonical configuration: a forward of 2 x 2 x 128^3 and the steps.
    t_unetr = time.perf_counter()
    choice = cudnn_choice("UNETR")
    unetr = ftt.UNETR(in_channels=2, out_channels=1, img_size=(128, 128, 128), feature_size=16,
                      generator=torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in unetr.parameters())
    batch = synthetic_batch(2, 2, 1, 128, seed=600)
    with torch.inference_mode():
        unetr.eval()(batch["image"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = unetr(batch["image"])
        torch.cuda.synchronize()
        s_forward = time.perf_counter() - t0
        check(tuple(logits.shape) == (2, 1, 128, 128, 128) and bool(torch.isfinite(logits).all()),
              f"baselines UNETR: logits {tuple(logits.shape)} or non-finite")
        x = torch.randn(1, 2, 128, 128, 128, generator=torch.Generator().manual_seed(400))
        got = unetr(x.to(dev)).cpu()
        ref = copy.deepcopy(unetr).cpu()(x)
    err, rel = compare(got, ref)
    check(rel <= CPU_RTOL, f"baselines UNETR: card vs CPU logits {rel:.3e}")
    s_step, seconds, mem, losses = steps(unetr.train(), batch, {"learning_rate": 1e-4, "weight_decay": 1e-5},
                                         "baselines UNETR")
    print(f"[baselines] UNETR ({n_params / 1e6:.2f}M parameters, in 2, out 1, img_size 128^3, feature_size 16) float32, "
          f"{choice}: "
          f"{s_forward:.4f} s per forward of (2, 2, 128, 128, 128); train batch 2 x 128^3: {s_step:.4f} s/step (steps "
          + ", ".join(f"{t:.4f}" for t in seconds[1:]) + f" s after a {seconds[0]:.2f} s warm-up), peak {mem:.2f} GiB, loss "
          f"{' -> '.join(f'{v:.5f}' for v in losses)}; card vs CPU logits on (1, 2, 128, 128, 128): max_abs={err:.3e} "
          f"max_rel={rel:.3e} (tol {CPU_RTOL:.0e}); {time.perf_counter() - t_unetr:.1f} s")
    del unetr, batch, logits, got, ref
    torch.backends.cudnn.benchmark = False
    made = read_counters(counters)
    check(not any(made.values()), f"baselines: the port's kernels launched: { {k: v for k, v in made.items() if v} }")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[baselines] no launch of K1-K5 across the phase (every counter 0); phase wall time "
          f"{time.perf_counter() - t_phase:.1f} s")


# Phase 28 (`[engine]`): the override sets applied one at a time to factorizer_brats23's unedited train.yaml
# network_def (full width, 128^3, f32): name -> network_def keys.  (a)-(d) leave the kernels' rules (an NNDSVD init,
# a projected least-squares solver, a composed solver, the SVD factorizer) and take the flat route on the stock
# decompose chain; (e)-(g) stay on K1.
ENGINE_SETS = {
    "a init_method=nndsvd": {"init_method": "nndsvd"},
    "b solver=nnls": {"solver": "nnls"},
    "c solver=[hals-0, mu-1]": {"solver": ["hals-0", "mu-1"]},
    "d factorize=SVD": {"factorize": "$ftx.SVD"},
    "e rank=null compression=10": {"rank": None, "compression": 10},
    "f pos_embed=Sinusoidal": {"pos_embed": "$ftx.SinusoidalPositionalEmbedding"},
    "f pos_embed=Rotary": {"pos_embed": "$ftx.RotaryPositionalEmbedding"},
    "f pos_embed=Axial": {"pos_embed": "$ftx.AxialPositionalEmbedding"},
    "g factorize_options={eps: 1e-8}": {"factorize_options": {"eps": 1.0e-8}},
}
# The card's f32 logits (TF32 off) against the CPU's from the same weights on one window, for the flat sets: the
# convolutions and products sum in other orders (2^-24 relative each), the randomized SVD's normalisations and
# NNDSVD's sign choices pass them through 5 solver iterations a mixer and 9 mixers.
ENGINE_CPU_RTOL = 1e-3
# A served volume above this many seconds is served as one sliding-window batch instead (a window pair).
ENGINE_VOLUME_S = 30.0
# Clustering on the card against the CPU (the first CLUSTER_CPU_WINDOWS windows; each window is clustered on its
# own): a point's assignment may differ where the distances to the two centers are within CLUSTER_TIE_RTOL of the
# point's largest distance (the distances are differences of sums of squares, exact to float32 rounding of those),
# and where a flip in an earlier iteration moved its window's centers; at most CLUSTER_DIFFER_SHARE of the points
# may differ.  The centers of the windows whose assignments agree within CLUSTER_CENTER_RTOL (relative): EntropyKMeans's
# softmax at its default temperature alpha = 1e-3 multiplies the distances' float32 rounding (~1e-6 at distances near
# 16) by 1000 before the exponential, so its soft memberships, and the centers they weight, agree to ~1e-3 only.
CLUSTER_CPU_WINDOWS, CLUSTER_TIE_RTOL, CLUSTER_DIFFER_SHARE = 4096, 1e-4, 1e-4
CLUSTER_CENTER_RTOL = {"KMeans": 1e-4, "FuzzyCMeans": 1e-4, "EntropyKMeans": 1e-2}


def engine_slice(counters: dict) -> dict:
    """Phase 28: the rest of the factorization engine (stock torch) on the card, selected by ``network_def`` keys.

    For each set of ``ENGINE_SETS`` the network is built from ``zoo/factorizer_brats23/configs/train.yaml`` with the
    keys merged in, through the port's ``ConfigParser`` with the bundle's seed; it serves 1 BraTS-native volume
    through ``ensemble_predict`` after a warm-up (one sliding-window batch where a volume would take over
    ``ENGINE_VOLUME_S``), takes 1 warm-up and 2 steps of ``make_train_step`` at 2 x 128^3, and its launches per
    forward and per step are asserted (the flat sets: K2 alone; the K1 sets: the default's).  Logits: the K1 sets
    against the same call under ``reference_kernels()``, the flat sets on one window against the CPU forward of the
    same weights.  One bfloat16 step of (a) checks that the solve runs in float32.  Then the engine's calls at stage
    0's batch of 131072 matrices (8 x 512) are timed, and KMeans, FuzzyCMeans and EntropyKMeans (4 centers) run on
    stage 0's windows of a (2, 128^3, 32) activation as points (32768, 512, 8), on the card against the CPU.
    Returns the launches made in the served and trained sets."""
    import copy
    from pathlib import Path

    import torch

    import factorizer_tpu_torch as ftt
    from factorizer_tpu_torch.config import ConfigParser, load_config_files, merge_config
    from factorizer_tpu_torch.factorization import svd as svd_module
    from factorizer_tpu_torch.factorization.solvers import LeastSquares
    from factorizer_tpu_torch.ops.kernels import reference_kernels
    from factorizer_tpu_torch.train.sliding_window import sliding_window_positions
    from factorizer_tpu_torch.train.trainer import create_train_state, make_train_step
    from factorizer_tpu_torch.zoo_scripts import ensemble_predict

    repo = Path(__file__).resolve().parent
    dev = torch.device("cuda", torch.cuda.current_device())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev)
    configs = repo / "zoo" / "factorizer_brats23" / "configs"
    base = load_config_files([configs / "train.yaml"])
    volume, roi, sw_batch, overlap = (1, 4, 240, 240, 155), tuple(base["roi_size"]), 2, 0.5
    forwards = -(-len(sliding_window_positions(volume[2:], roi, overlap)) // sw_batch)
    settings = {"lr": base["learning_rate"], "weight_decay": base["weight_decay"]}  # the bundle's AdamW, constant lr
    k1_forward = {"windowed_nmf_factors": N_BLOCKS, "windowed_nmf_reconstruct": N_BLOCKS, "prenorm_mlp": N_BLOCKS}
    made_total = dict.fromkeys(counters, 0)

    def network(keys: dict, amp: bool = False):
        cfg = merge_config(base, {"bundle_root": str(configs.parent), "amp": amp,
                                  **{f"network_def#{k}": v for k, v in keys.items()}})
        parser = ConfigParser(cfg)
        parser.seed(cfg["seed"])
        model = parser["network_def"]
        check(type(model) is ftt.Factorizer and next(model.parameters()).is_cuda,
              f"engine: network_def {keys} did not build a Factorizer on the card")
        return model

    def counted(expected: dict, tag: str):
        made = read_counters(counters)
        want = {k: expected.get(k, 0) for k in counters}
        check(made == want, f"engine {tag}: launches {made}, expected {want}")
        for k, v in made.items():
            made_total[k] += v
        reset_counters(counters)

    requests = [torch.randn(volume, device=dev, generator=gen.manual_seed(700 + i)) for i in range(2)]
    window = torch.randn((1, 4, *roi), generator=torch.Generator().manual_seed(710))
    batch = synthetic_batch(2, 4, 3, roi[0], seed=720)
    for name, keys in ENGINE_SETS.items():
        t_set = time.perf_counter()
        flat = name[0] in "abcd"
        per_forward = {"prenorm_mlp": N_BLOCKS} if flat else k1_forward
        per_step = {**per_forward, "prenorm_mlp_bwd": N_BLOCKS,
                    **({} if flat else {"windowed_nmf_bwd": N_BLOCKS * N_SHIFTS})}
        model = network(keys).eval()
        mixers = [m for m in model.modules() if isinstance(m, ftt.FactMixer)]
        check(len(mixers) == N_BLOCKS and all((m.windowed is None) == flat for m in mixers),
              f"engine {name}: mixers on K1 {[m.windowed is not None for m in mixers]}, expected {not flat}")
        check(not flat or not any(isinstance(m.factorize, ftt.MatrixFactorization) and m.factorize.supports()
                                  for m in mixers), f"engine {name}: a flat mixer would take K4")
        reset_counters(counters)
        # serve (cuDNN's heuristics, as the serving phases run): a forward of a window pair after a warm-up one decides
        # between whole volumes and window pairs (where a volume would take over ENGINE_VOLUME_S)
        torch.backends.cudnn.benchmark = False
        with torch.inference_mode():
            pair = requests[0][:, :, : roi[0], : roi[1], : roi[2]].expand(sw_batch, -1, -1, -1, -1).contiguous()
            model(pair)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model(pair)
            torch.cuda.synchronize()
            pair_s = time.perf_counter() - t0
            counted({k: 2 * v for k, v in per_forward.items()}, f"{name} two forwards of a window pair")
            whole = pair_s * forwards <= ENGINE_VOLUME_S
            served, served_mem = [], 0.0
            torch.cuda.reset_peak_memory_stats(dev)
            for i, image in enumerate(requests):
                if not whole:
                    image = image[:, :, : roi[0], : roi[1], : roi[2]].expand(sw_batch, -1, -1, -1, -1).contiguous()
                t0 = time.perf_counter()
                if whole:
                    mask, probs = ensemble_predict([model], image, roi, sw_batch, overlap)
                else:
                    probs = torch.sigmoid(model(image))
                torch.cuda.synchronize()
                served.append(time.perf_counter() - t0)
                check(bool(torch.isfinite(probs).all()), f"engine {name}: non-finite probabilities")
                counted({k: v * (forwards if whole else 1) for k, v in per_forward.items()}, f"{name} request {i}")
            served_mem = torch.cuda.max_memory_allocated(dev) / 2**30
            what = (f"{statistics.mean(served[1:]):.4f} s/volume {volume} ({forwards} forwards of a window pair)" if whole
                    else f"{statistics.mean(served[1:]):.4f} s per window pair (2, 4, 128^3): a volume would take "
                         f"~{pair_s * forwards:.1f} s ({forwards} forwards)")
            # logits: K1 sets against the plain versions on the card, flat sets against the CPU
            if flat:
                got = model(window.to(dev)).cpu()
                ref = copy.deepcopy(model).cpu()(window)
                tol, against = ENGINE_CPU_RTOL, "the CPU forward of the same weights"
            else:
                got = model(window.to(dev))
                with reference_kernels():
                    ref = model(window.to(dev))
                tol, against = SLICE_RTOL["float32"], "reference_kernels()"
            torch.cuda.synchronize()
            reset_counters(counters)
        err, rel = compare(got, ref)
        check(bool(torch.isfinite(got).all()) and rel <= tol,
              f"engine {name}: logits on one window differ from {against} by {rel:.3e} (tol {tol:.0e})")
        del got, ref
        # train: 1 warm-up and 2 steps, under cuDNN's timing search as the training phases run
        torch.backends.cudnn.benchmark = True
        state = create_train_state(model.train(), **settings)
        step = make_train_step(state.model)
        losses, seconds = [], []
        for i in range(3):
            if i == 1:
                torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            losses.append(metrics["loss"].item())
            check(math.isfinite(losses[-1]) and math.isfinite(metrics["grad_norm"].item()),
                  f"engine {name}: step {i + 1} loss {losses[-1]}, grad norm {metrics['grad_norm'].item()}")
            counted(per_step, f"{name} step {i + 1}")
        mem = torch.cuda.max_memory_allocated(dev) / 2**30
        print(f"[engine] {name}: {'flat route' if flat else 'K1'}; serve {what} (requests "
              + ", ".join(f"{t:.4f}" for t in served[1:]) + f" s after a {served[0]:.2f} s warm-up), peak {served_mem:.2f} "
              f"GiB; launches per forward { {k: v for k, v in per_forward.items()} }; logits on (1, 4, 128^3) vs {against}: "
              f"max_abs={err:.3e} max_rel={rel:.3e} (tol {tol:.0e}); train 2 x 128^3 f32: {statistics.mean(seconds[1:]):.4f} "
              "s/step (steps " + ", ".join(f"{t:.4f}" for t in seconds[1:]) + f" s after a {seconds[0]:.2f} s warm-up), "
              f"peak {mem:.2f} GiB, loss {' -> '.join(f'{v:.5f}' for v in losses)}, launches per step "
              f"{ {k: v for k, v in per_step.items()} }; {time.perf_counter() - t_set:.1f} s ({smi})")
        del model, state, step, metrics, mixers
        gc.collect()
        torch.cuda.empty_cache()

    # One bfloat16 step of (a): the NNDSVD init and HALS run in float32 on the bf16 activations' fold.
    model = network(ENGINE_SETS["a init_method=nndsvd"], amp=True)
    check(model.stem.dtype == torch.bfloat16, "engine a bf16: amp: true did not give a bfloat16 network")
    solved = set()
    fact = next(m for m in model.modules() if isinstance(m, ftt.FactMixer)).factorize
    decompose = fact.decompose
    fact.decompose = lambda x, *a, **k: (solved.add(x.dtype), decompose(x, *a, **k))[1]
    state = create_train_state(model.train(), **settings)
    step = make_train_step(state.model)
    seconds = []
    for i in range(2):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        counted({"prenorm_mlp": N_BLOCKS, "prenorm_mlp_bwd": N_BLOCKS}, f"a bf16 step {i + 1}")
    loss = metrics["loss"].item()
    check(solved == {torch.float32} and math.isfinite(loss), f"engine a bf16: solved in {solved}, loss {loss}")
    print(f"[engine] a init_method=nndsvd bfloat16 (amp: true): the mixers' solve ran in {sorted(map(str, solved))} on "
          f"the bf16 fold; step {seconds[1]:.4f} s after a {seconds[0]:.2f} s warm-up, loss {loss:.5f} ({smi})")
    del model, state, step, metrics, fact
    gc.collect()
    torch.cuda.empty_cache()

    # The engine's calls at stage 0's batch: 131072 matrices of 8 x 512 (2 x 4 heads x 4096 windows x 4 shifts).
    x = torch.rand(131072, 8, 512, device=dev, generator=gen.manual_seed(730))
    u = torch.rand(131072, 8, 1, device=dev, generator=gen)
    v = torch.rand(131072, 512, 1, device=dev, generator=gen)
    calls = {
        "randomized_svd rank 1 (5 one-column QRs, a one-row SVD)": lambda: ftt.randomized_svd(x, 1),
        "NNDSVDInit rank 1": lambda: ftt.NNDSVDInit((8, 512), rank=1)(x),
        "one nnls iteration (LeastSquares: a solve for U, a pinv for V)": lambda: LeastSquares(project=torch.relu)(x, (u, v)),
        "torch.linalg.qr (2048, 512, 1)": lambda: torch.linalg.qr(v[:2048]),
        "torch.linalg.svd (2048, 1, 512)": lambda: torch.linalg.svd(x[:2048, :1], full_matrices=False),
    }
    timings = {k: cuda_time_ms(fn, warmup=1, runs=3) for k, fn in calls.items()}
    print("[engine] at stage 0's batch (131072, 8, 512) f32: " + "; ".join(f"{k} {ms:.3f} ms" for k, ms in timings.items())
          + f" ({smi})")
    del x, u, v

    # Clustering on stage 0's windows: points (32768, 512, 8) of a (2, 128^3, 32) activation, card against CPU.
    activation = torch.relu(torch.randn(2, 128, 128, 128, 32, device=dev, generator=gen.manual_seed(740)))
    points = ftt.Matricize(tuple(activation.shape), head_dim=8, patch_size=8)(activation).flatten(0, 1).transpose(-1, -2)
    points = points.contiguous()
    points_cpu = points[:CLUSTER_CPU_WINDOWS].cpu()
    del activation
    for cls in (ftt.KMeans, ftt.FuzzyCMeans, ftt.EntropyKMeans):
        layer = cls(num_centers=4)
        layer(points[:64])  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        u_card, v_card = layer(points)
        torch.cuda.synchronize()
        card_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        u_cpu, v_cpu = layer(points_cpu)
        cpu_ms = (time.perf_counter() - t0) * 1e3
        check(bool(torch.isfinite(u_card).all()) and bool(torch.isfinite(v_card).all()),
              f"engine {cls.__name__}: non-finite memberships or centers")
        u_card, v_card = u_card[:CLUSTER_CPU_WINDOWS].cpu(), v_card[:CLUSTER_CPU_WINDOWS].cpu()
        a_card, a_cpu = u_card.argmax(-1), u_cpu.argmax(-1)
        differ = a_card != a_cpu
        d = layer.get_dist(points_cpu, v_cpu)
        gap = d.gather(-1, a_card[..., None])[..., 0] - d.gather(-1, a_cpu[..., None])[..., 0]
        ties = differ & (gap.abs() <= CLUSTER_TIE_RTOL * d.amax(-1))
        windows_differ = differ.any(-1)
        same = ~windows_differ
        center_rel = compare(v_card[same], v_cpu[same])[1] if bool(same.any()) else 0.0
        center_tol = CLUSTER_CENTER_RTOL[cls.__name__]
        center_rel_all = compare(v_card, v_cpu)[1]
        print(f"[engine] {cls.__name__} (4 centers, 10 iterations) on {tuple(points.shape)} f32: card {card_ms:.2f} ms, "
              f"CPU {cpu_ms:.1f} ms on the first {CLUSTER_CPU_WINDOWS} windows {tuple(points_cpu.shape)}; there the "
              f"assignments differ at {int(differ.sum())} of {differ.numel()} points ({int(ties.sum())} near ties, "
              f"within {CLUSTER_TIE_RTOL:.0e} of the point's largest distance), in {int(windows_differ.sum())} of {windows_differ.numel()} windows; centers "
              f"max_rel {center_rel:.3e} in the windows that agree (tol {center_tol:.0e}), {center_rel_all:.3e} "
              f"over all ({smi})")
        check(int(differ.sum()) <= CLUSTER_DIFFER_SHARE * differ.numel() and center_rel <= center_tol,
              f"engine {cls.__name__}: card and CPU disagree: {int(differ.sum())} points in {int(windows_differ.sum())} "
              f"windows, centers {center_rel:.3e}")
        del u_card, v_card, u_cpu, v_cpu, d
    del points, points_cpu
    svd_module.gaussian.cache_clear()  # the randomized SVD's test matrices, kept on the card
    torch.backends.cudnn.benchmark = False
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[engine] phase wall time {time.perf_counter() - t_phase:.1f} s; launches {made_total}")
    return made_total


# Phase 29: factorizer_brats23's network_def with the skeleton's and the blocks' remaining options.
OPTION_KEYS = {"num_deep_supr": 3, "dropout": 0.1}
DECONVER_OPTION_KEYS = {"num_deep_supr": 2, "dropout": 0.1}
FLAT_ROUTES = {"concat": {"use_windowed": False}, "split": {"use_windowed": False, "split_shifts": True}}
PURE_XLA = {"use_pallas": False}


def options_slice(counters: dict) -> dict:
    """Phase 29: the models' remaining options on the card, at full width, f32, 2 x 128^3.

    1. ``factorizer_brats23``'s ``network_def`` with ``num_deep_supr: 3, dropout: 0.1`` beside the unedited one: 1
       warm-up and 3 steps each (s/step, peak GiB, launches per step: K1 as the default's, no K2 forward or backward
       under active dropout, the loss the heads' pyramid); one eval forward of a window (9 K2 launches, the three
       heads' shapes, logits equal bit for bit to the same weights with ``dropout: 0``); one BraTS-native volume
       through ``ensemble_predict`` equal bit for bit to the same weights in a one-head model (``head0`` as
       ``head``).
    2. The flat route, ``factorize_options={"use_windowed": False}`` against ``{..., "split_shifts": True}`` on the
       unedited ``network_def``: an eval forward of a window each (logits against each other), 1 warm-up and 2 steps
       each (the first step's loss against each other, s/step, peak GiB, K4 launches per step: 9 and 9 x 4 shifts
       each way), and the split route's loss and gradient norm under ``reference_kernels()`` within K4's band.
    3. The generic ``UNet`` (DoubleConv blocks, a k3 stem, widths 32 ... 512, 4 -> 3 channels), plain and with
       ``num_deep_supr: True``: 1 warm-up and 3 steps each, s/step, peak GiB, no kernel of the port launched.
    4. ``deconver_brats23``'s ``network_def`` with ``num_deep_supr: 2, dropout: 0.1``: 1 warm-up and 1 step, K3
       launches per step as the default's (54 forward and dx, 27 dw), the loss finite.
    5. The unedited ``network_def`` under ``factorize_options={"use_pallas": False}`` (JAX's pure-XLA mode): an eval
       forward of a window with no K1 and no K4 launch and K2's 9, its logits within the f32 band of the same weights
       on the default route, the ``explain`` lines one forward logs (none for the explicit opt-out, one a mixer under
       ``explain``); a BraTS-native volume through ``ensemble_predict`` (s/volume); 1 warm-up and 2 steps (s/step,
       peak GiB, no K1 and no K4, K2's 9 + 9).

    Returns the launches made (they are in the kernels line)."""
    from pathlib import Path

    import torch

    import factorizer_tpu_torch as ftt
    from factorizer_tpu_torch.config import ConfigParser, load_config_files, merge_config
    from factorizer_tpu_torch.ops.kernels import reference_kernels
    from factorizer_tpu_torch.train.trainer import create_train_state, make_train_step
    from factorizer_tpu_torch.zoo_scripts import ensemble_predict

    repo = Path(__file__).resolve().parent
    dev = torch.device("cuda", torch.cuda.current_device())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    t_phase = time.perf_counter()
    made_total = dict.fromkeys(counters, 0)
    gen = torch.Generator(device=dev)

    def network(bundle: str, keys: dict):
        configs = repo / "zoo" / bundle / "configs"
        cfg = merge_config(load_config_files([configs / "train.yaml"]),
                           {"bundle_root": str(configs.parent), "amp": False,
                            **{f"network_def#{k}": v for k, v in keys.items()}})
        parser = ConfigParser(cfg)
        parser.seed(cfg["seed"])
        model = parser["network_def"]
        check(next(model.parameters()).is_cuda, f"options: {bundle} {keys} did not build on the card")
        return model, {"lr": cfg["learning_rate"], "weight_decay": cfg["weight_decay"]}

    def take() -> dict:
        made = read_counters(counters)
        for k, v in made.items():
            made_total[k] += v
        reset_counters(counters)
        return made

    def steps(model, settings: dict, batch: dict, n: int, tag: str) -> dict:
        """1 warm-up and ``n`` timed steps: mean s/step, peak GiB, the losses, launches per step."""
        state = create_train_state(model.train(), **settings)
        step = make_train_step(state.model)
        reset_counters(counters)
        seconds, losses = [], []
        for i in range(n + 1):
            if i == 1:
                take()
                torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            losses.append(metrics["loss"].item())
            check(math.isfinite(losses[-1]) and math.isfinite(metrics["grad_norm"].item()),
                  f"options {tag}: step {i + 1} loss {losses[-1]}, grad norm {metrics['grad_norm'].item()}")
        made = take()
        check(all(v % n == 0 for v in made.values()), f"options {tag}: launches {made} over {n} steps")
        return {"s": statistics.mean(seconds[1:]), "warm": seconds[0], "peak": torch.cuda.max_memory_allocated(dev) / 2**30,
                "losses": losses, "per_step": {k: v // n for k, v in made.items() if v}}

    def line(tag: str, r: dict) -> str:
        return (f"{tag}: {r['s']:.4f} s/step (after a {r['warm']:.2f} s warm-up), peak {r['peak']:.2f} GiB, loss "
                + " -> ".join(f"{v:.5f}" for v in r["losses"]) + f", launches per step {r['per_step']}")

    k1_step = {"windowed_nmf_factors": N_BLOCKS, "windowed_nmf_reconstruct": N_BLOCKS,
               "windowed_nmf_bwd": N_BLOCKS * N_SHIFTS}
    batch = synthetic_batch(2, 4, 3, 128, seed=800)
    window = torch.randn((1, 4, 128, 128, 128), device=dev, generator=gen.manual_seed(801))

    # 1. deep supervision and dropout
    torch.backends.cudnn.benchmark = True  # the training phases' setting
    default, settings = network("factorizer_brats23", {})
    base = steps(default, settings, batch, 3, "default")
    check(base["per_step"] == {**k1_step, "prenorm_mlp": N_BLOCKS, "prenorm_mlp_bwd": N_BLOCKS},
          f"options default: launches per step {base['per_step']}")
    del default
    model, settings = network("factorizer_brats23", OPTION_KEYS)
    check(model.head_names() == ["head0", "head1", "head2"], f"options: heads {model.head_names()}")
    opt = steps(model, settings, batch, 3, "num_deep_supr 3, dropout 0.1")
    check(opt["per_step"] == k1_step, f"options: launches per step under active dropout {opt['per_step']}, "
          f"expected K1's {k1_step} and no K2")
    print(f"[options] factorizer_brats23 network_def, train 2 x 128^3 f32: {line('unedited', base)}; "
          f"{line(str(OPTION_KEYS), opt)} (the loss is the three heads' DiceCE pyramid; no K2 under active dropout) "
          f"({smi})")
    torch.backends.cudnn.benchmark = False  # the serving phases' setting
    model.eval()
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = model(window)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
    made = {k: v for k, v in take().items() if v}
    check(made == {"windowed_nmf_factors": N_BLOCKS, "windowed_nmf_reconstruct": N_BLOCKS, "prenorm_mlp": N_BLOCKS},
          f"options: eval forward launches {made}")
    shapes = [tuple(t.shape) for t in logits]
    check(shapes == [(1, 3, 128, 128, 128), (1, 3, 64, 64, 64), (1, 3, 32, 32, 32)], f"options: pyramid {shapes}")
    zero, _ = network("factorizer_brats23", {**OPTION_KEYS, "dropout": 0.0})
    zero.load_state_dict(model.state_dict())
    with torch.inference_mode():
        logits0 = zero.eval()(window)
    take()
    equal = all(torch.equal(a, b) for a, b in zip(logits, logits0))
    diff = max(compare(a, b)[0] for a, b in zip(logits, logits0))
    check(equal, f"options: eval logits with dropout 0.1 differ from dropout 0 by {diff:.3e}")
    del zero, logits0
    single, _ = network("factorizer_brats23", {})
    single.load_state_dict({k.replace("head0.", "head."): v for k, v in model.state_dict().items()
                            if not k.startswith(("head1.", "head2."))})
    volume = torch.randn((1, 4, 240, 240, 155), device=dev, generator=gen.manual_seed(802))
    served = []
    for m in (model, single):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        served.append(ensemble_predict([m], volume, (128, 128, 128), sw_batch_size=2, overlap=0.5))
        torch.cuda.synchronize()
        served.append(time.perf_counter() - t0)
    take()
    (mask, probs), deep_s, (mask1, probs1), single_s = served
    check(torch.equal(probs, probs1) and torch.equal(mask, mask1),
          f"options: ensemble_predict of the deep-supervised model differs from head0's: {compare(probs, probs1)[0]:.3e}")
    print(f"[options] eval forward of (1, 4, 128^3): {eval_s:.4f} s, launches {made}, pyramid {shapes}, logits equal "
          f"bit for bit to dropout 0's (max abs diff {diff:.1e}); a (1, 4, 240, 240, 155) volume through ensemble_predict: "
          f"{deep_s:.4f} s (one-head model {single_s:.4f} s), probabilities equal bit for bit to the one-head model's "
          f"({smi})")
    del model, single, logits, served, mask, probs, mask1, probs1, volume
    gc.collect()
    torch.cuda.empty_cache()

    # 2. the flat route, concatenated against split shifts
    routes = {}
    for name, options in FLAT_ROUTES.items():
        model, settings = network("factorizer_brats23", {"factorize_options": options})
        mixers = [m for m in model.modules() if isinstance(m, ftt.FactMixer)]
        check(all(m.windowed is None and m.splits_shifts == (name == "split") for m in mixers),
              f"options {name}: mixers not all on the {name} flat route")
        with torch.inference_mode():
            logits = model.eval()(window)
        fwd = {k: v for k, v in take().items() if v}
        torch.backends.cudnn.benchmark = True
        run = steps(model, settings, batch, 2, name)
        torch.backends.cudnn.benchmark = False
        k4 = N_BLOCKS * (N_SHIFTS if name == "split" else 1)
        check(fwd.get("nmf_reconstruct") == k4 and run["per_step"].get("nmf_reconstruct") == k4
              and run["per_step"].get("nmf_reconstruct_bwd") == k4 and not fwd.get("windowed_nmf_factors"),
              f"options {name}: K4 launches forward {fwd}, per step {run['per_step']}, expected {k4} each")
        routes[name] = (logits, run, fwd)
        del model, mixers
        gc.collect()
        torch.cuda.empty_cache()
    (l_c, r_c, f_c), (l_s, r_s, f_s) = routes["concat"], routes["split"]
    logit_diff, logit_rel = compare(l_s, l_c)
    loss_diff = abs(r_s["losses"][0] - r_c["losses"][0])
    check(logit_rel <= SLICE_RTOL["float32"] and loss_diff <= TRAIN_RTOL["float32"]["loss"] * abs(r_c["losses"][0]),
          f"options: split against concat logits {logit_rel:.3e}, first loss {loss_diff:.3e}")
    model, settings = network("factorizer_brats23", {"factorize_options": FLAT_ROUTES["split"]})
    model.train()
    checks = []
    for ref in (False, True):
        with reference_kernels() if ref else contextlib.nullcontext():
            model.zero_grad(set_to_none=True)
            loss = ftt.dice_ce_loss(model(batch["image"]), batch["label"])
            loss.backward()
            norm = torch.linalg.vector_norm(torch.stack([p.grad.norm() for p in model.parameters()])).item()
        checks.append((loss.item(), norm))
        take()
    (loss_k, norm_k), (loss_p, norm_p) = checks
    loss_rel, norm_rel = abs(loss_k - loss_p) / abs(loss_p), abs(norm_k - norm_p) / abs(norm_p)
    check(loss_rel <= TRAIN_RTOL["float32"]["loss"] and norm_rel <= TRAIN_RTOL["float32"]["grad"],
          f"options split: against reference_kernels() loss {loss_rel:.3e}, grad norm {norm_rel:.3e}")
    print(f"[options] flat route, factorize_options {FLAT_ROUTES['concat']} (concat) vs {FLAT_ROUTES['split']} (split), "
          f"train 2 x 128^3 f32: {line('concat', r_c)}; {line('split', r_s)}; eval forward launches concat {f_c}, split "
          f"{f_s}; logits split vs concat max_abs={logit_diff:.3e} (bit for bit: {bool(torch.equal(l_s, l_c))}), first "
          f"loss {r_s['losses'][0]!r} vs {r_c['losses'][0]!r} (bit for bit: {r_s['losses'][0] == r_c['losses'][0]}); "
          f"split step vs reference_kernels(): loss {loss_rel:.3e}, grad norm {norm_rel:.3e} (tol "
          f"{TRAIN_RTOL['float32']['loss']:.0e} / {TRAIN_RTOL['float32']['grad']:.0e}) ({smi})")
    del model, routes, l_c, l_s, loss
    gc.collect()
    torch.cuda.empty_cache()

    # 3. the generic UNet: stock torch (cuDNN's heuristics, as the baselines' CNNs run)
    unets = {}
    for deep in (False, True):
        model = ftt.UNet(4, 3, stem=(ftt.Conv, {"kernel_size": 3, "padding": 1}), num_deep_supr=deep, device=dev,
                         generator=torch.Generator().manual_seed(0))
        unets[deep] = steps(model, {"lr": 1e-4, "weight_decay": 1e-5}, batch, 3, f"UNet num_deep_supr={deep}")
        check(not unets[deep]["per_step"], f"options UNet: kernels launched {unets[deep]['per_step']}")
        params = sum(p.numel() for p in model.parameters())
        del model
        gc.collect()
        torch.cuda.empty_cache()
    print(f"[options] generic UNet (DoubleConv blocks, k3 stem, widths 32..512, 4 -> 3, {params / 1e6:.2f}M parameters "
          f"with 3 heads), train 2 x 128^3 f32: {line('plain', unets[False])}; {line('num_deep_supr True', unets[True])}; "
          f"no kernel of the port launched ({smi})")

    # 4. the Deconver with the options
    torch.backends.cudnn.benchmark = True
    model, settings = network("deconver_brats23", DECONVER_OPTION_KEYS)
    run = steps(model, settings, batch, 1, "deconver")
    check(run["per_step"] == {"depthwise_conv": 54, "depthwise_conv_dw": 27},
          f"options deconver: launches per step {run['per_step']}, expected 54 depthwise_conv and 27 dw")
    print(f"[options] deconver_brats23 network_def with {DECONVER_OPTION_KEYS}, train 2 x 128^3 f32: "
          f"{line('deconver', run)} (the default's 54 + 27) ({smi})")
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # 5. JAX's pure-XLA mode: no K1, no K4
    import logging

    from factorizer_tpu_torch.models import factorizer as factorizer_module

    torch.backends.cudnn.benchmark = False
    default, _ = network("factorizer_brats23", {})
    model, settings = network("factorizer_brats23", {"factorize_options": PURE_XLA})
    model.load_state_dict(default.state_dict())
    mixers = [m for m in model.modules() if isinstance(m, ftt.FactMixer)]
    check(len(mixers) == N_BLOCKS and all(m.windowed is None and not m.factorize.supports() for m in mixers),
          "options use_pallas False: a mixer on K1 or its factorizer on K4")
    take()
    with torch.inference_mode():
        ref = default.eval()(window)
    take()
    lines = []
    handler = logging.Handler(logging.INFO)
    handler.emit = lines.append
    factorizer_module.logger.addHandler(handler)
    factorizer_module.logger.setLevel(logging.INFO)
    try:
        counted = {}
        for explain in (False, True):
            for m in mixers:
                m.explain = explain
            lines.clear()
            with torch.inference_mode():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits = model.eval()(window)
                torch.cuda.synchronize()
                fwd_s = time.perf_counter() - t0
            counted[explain] = len(lines)
            fwd = {k: v for k, v in take().items() if v}
            check(fwd == {"prenorm_mlp": N_BLOCKS}, f"options use_pallas False: eval forward launches {fwd}")
    finally:
        factorizer_module.logger.removeHandler(handler)
        factorizer_module.logger.setLevel(logging.NOTSET)
        for m in mixers:
            m.explain = False
    check(counted == {False: 0, True: N_BLOCKS}, f"options use_pallas False: explain lines of one forward {counted}, "
          f"expected 0 for the explicit opt-out and {N_BLOCKS} under explain")
    logit_diff, logit_rel = compare(logits, ref)
    check(logit_rel <= SLICE_RTOL["float32"], f"options use_pallas False: logits against the default route {logit_rel:.3e}")
    del default, ref, logits
    volume = torch.randn((1, 4, 240, 240, 155), device=dev, generator=gen.manual_seed(803))
    for _ in range(2):  # a warm-up, then the timed volume
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mask, probs = ensemble_predict([model], volume, (128, 128, 128), sw_batch_size=2, overlap=0.5)
        torch.cuda.synchronize()
        volume_s = time.perf_counter() - t0
    served = {k: v for k, v in take().items() if v}
    check(not served.get("windowed_nmf_factors") and not served.get("nmf_reconstruct") and torch.isfinite(probs).all(),
          f"options use_pallas False: a served volume launched {served}")
    del volume, mask, probs
    torch.backends.cudnn.benchmark = True
    pure = steps(model, settings, batch, 2, "use_pallas False")
    torch.backends.cudnn.benchmark = False
    check(pure["per_step"] == {"prenorm_mlp": N_BLOCKS, "prenorm_mlp_bwd": N_BLOCKS},
          f"options use_pallas False: launches per step {pure['per_step']}, expected K2's {N_BLOCKS} + {N_BLOCKS} alone")
    print(f"[options] factorize_options {PURE_XLA} (the JAX package's pure-XLA mode: every mixer on the decompose chain), "
          f"the unedited network_def f32: eval forward of (1, 4, 128^3) {fwd_s:.4f} s, launches {fwd}, logits against the "
          f"default route (K1) on the same weights max_abs={logit_diff:.3e} max_rel={logit_rel:.3e} (tol "
          f"{SLICE_RTOL['float32']:.0e}); explain lines in one forward: {counted[False]} (explicit opt-out), "
          f"{counted[True]} under explain; a (1, 4, 240, 240, 155) volume through ensemble_predict {volume_s:.4f} s "
          f"(after a warm-up), launches {served}; train 2 x 128^3: {line('use_pallas False', pure)} ({smi})")
    del model, mixers
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[options] phase {time.perf_counter() - t_phase:.1f} s")
    return made_total


def main() -> None:
    t_run = time.perf_counter()
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cards", type=int, default=1,
                        help="above 1: run the multi-process phases alone (31, 20, 21, 25 and 32 as the count "
                             "allows), one process per card over NCCL")
    parser.add_argument("--phases", default=",".join(CARDS_PHASES),
                        help=f"with --cards: the phases to run, a comma-separated subset of {','.join(CARDS_PHASES)}")
    parser.add_argument("--start", choices=("forkserver", "spawn"), default=WORKERS_START,
                        help="how run_processes starts the multi-process phases' workers")
    args = parser.parse_args()
    cards, phases = args.cards, args.phases.split(",")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        sys.exit(1)
    if not 1 <= cards <= torch.cuda.device_count():
        fail(f"--cards {cards}, but the host has {torch.cuda.device_count()} CUDA device(s)")
    if not set(phases) <= set(CARDS_PHASES):
        fail(f"--phases {args.phases}: not a subset of {','.join(CARDS_PHASES)}")
    set_workers_start(args.start)

    # The port: imported only once a card is known to be there.
    import torch.nn.functional as F

    from factorizer_tpu_torch.factorization.deconv import Deconv
    from factorizer_tpu_torch.factorization.nmf import MatrixFactorization
    from factorizer_tpu_torch.ops.kernels import (
        build, depthwise_conv, depthwise_conv_dw, depthwise_conv_dw_plain, depthwise_conv_plain,
        nmf_reconstruct, nmf_reconstruct_backward, nmf_reconstruct_backward_plain, nmf_reconstruct_plain, prenorm_mlp, prenorm_mlp_backward, prenorm_mlp_backward_plain, prenorm_mlp_plain,
        reference_kernels, windowed_nmf, windowed_nmf_backward, windowed_nmf_backward_plain, windowed_nmf_factors,
        windowed_nmf_factors_plain, windowed_nmf_multi_spatial, windowed_nmf_multi_spatial_local,
        windowed_nmf_multi_spatial_plain, windowed_nmf_plain, windowed_nmf_reconstruct, windowed_nmf_reconstruct_plain,
    )
    from factorizer_tpu_torch.models.factorizer import Factorizer
    from factorizer_tpu_torch.ops.kernels.windowed_sharded import exchange_sizes
    from factorizer_tpu_torch.ops.kernels.depthwise_conv import (
        ROUTES, TILE, _launch_dw, _launch_forward, conv_plan, tile_min_blocks,
    )
    from factorizer_tpu_torch.ops.kernels.mlp_block import forward_shares
    from factorizer_tpu_torch.ops.kernels.nmf import ROUTES as NMF_ROUTES
    from factorizer_tpu_torch.ops.kernels.nmf import _launch_backward as k4_launch_backward
    from factorizer_tpu_torch.ops.kernels.nmf import _launch_forward as k4_launch_forward
    from factorizer_tpu_torch.ops.kernels.nmf import nmf_plan
    from factorizer_tpu_torch.ops.reshape import SWMatricize
    from factorizer_tpu_torch.train.sliding_window import sliding_window_inference, sliding_window_positions
    from factorizer_tpu_torch.train.trainer import create_train_state, make_train_step
    from factorizer_tpu_torch.zoo_scripts import (
        brats23_network, brats23_optimizer_settings, deconver_brats23_network, deconver_fives_network,
        deconver_isles22_network, ensemble_predict, factorizer_isles22_network,
    )

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    wrappers = kernel_counters()

    def reset_counts() -> None:
        reset_counters(wrappers)

    def read_counts() -> dict:
        return read_counters(wrappers)

    phase_seconds: list = []  # (phases, wall seconds) since the previous mark; printed before the last lines

    def phase_done(name: str) -> None:
        phase_seconds.append((name, time.perf_counter() - t_run - sum(s for _, s in phase_seconds)))

    # 1. environment
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    nvcc = subprocess.run([build.nvcc_path(), "--version"], capture_output=True, text=True, check=True, timeout=60)
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"nvcc {nvcc.stdout.strip().splitlines()[-1]} python {sys.version.split()[0]}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("[env] torch.backends.cudnn.allow_tf32=False torch.backends.cuda.matmul.allow_tf32=False")

    # 2. build
    t0 = time.perf_counter()
    build.library()
    seconds, log = build.build_info()
    print(f"[build] {time.perf_counter() - t0:.1f} s (nvcc {'reused an identical build' if seconds is None else f'{seconds:.1f} s'})")
    kernel = ""
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            kernel = kernel_label(entry.group(1))
        if "registers" in line or ("spill" in line and " 0 bytes spill stores" not in line):
            print(f"[build] {kernel}: {line.strip()}")

    def last_lines(kernels=None) -> None:
        from factorizer_tpu_torch.parallel import child_processes

        left = child_processes()
        check(not left, f"processes that this run started are still alive: {left}")
        print(smi)
        if kernels is not None:
            print(json.dumps({"kernels": kernels}))
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}))

    if cards > 1:  # the multi-process phases across cards, and nothing else
        print(f"[cards] {cards} cards, phases {','.join(phases)}, workers started by {WORKERS_START}")
        settings = brats23_optimizer_settings(steps_per_epoch=1)
        settings = {k: settings[k] for k in ("lr", "weight_decay")}
        equal = 128 % cards == 0  # phases 20 and 25 hold equal slabs to their own expectations
        if cards >= UNEVEN_WORLD and "uneven" in phases:  # phase 31 where the count does not divide 128, else on 3
            uneven_slabs_slice(UNEVEN_WORLD if equal else cards)
        if equal and "spatial" in phases:
            spatial_slice(cards)
        torch.backends.cudnn.benchmark = True
        if "dp" in phases:
            train_dp_slice(cards, settings, 4)
        one_host = {}
        if equal and "tp" in phases:
            train_tp_slice(cards, settings, one_host)
        if equal and cards % 2 == 0 and "hosts" in phases:  # 2 hosts of cards / 2
            hosts_cards_slice(cards, settings, one_host)
        stop_forkserver()
        last_lines()
        return

    # Per kernel: the errors of every comparison, and the times at the first case, (2,128^3,32) f32.
    results = {name: {"errs": [], "times": None} for name in wrappers}

    def record(name: str, err: float, label: str, ms: float, plain_ms: float, bound: tuple[float, str],
               library_ms: float | None = None) -> None:
        check(ms >= bound[0], f"{name} {label}: {ms:.4f} ms is below its bound {bound[0]:.4f} ms: the bound is wrong")
        results[name]["errs"].append(err)
        if results[name]["times"] is None:
            results[name]["times"] = (label, ms, plain_ms, *bound, library_ms)

    gen = torch.Generator(device=dev)
    four, zero_shift, isles_shifts = (None, 2, 4, 6), ((0, 0, 0),), (None, 1, 2, 3)
    # More shifts than one K1 forward launch takes: each pass launches once per group of eight.
    ten = (None, 1, 2, 3, 4, 5, 6, 7, (1, 2, 3), (3, 2, 1))
    # factorizer_isles22 at batch 8, roi 64^3: patches of 4^3, so K1's run-time-size instance; stages 0 and 3.
    isles_shapes = [(8, 64, 32), (8, 8, 256)]

    phase_done("1-2 env, build")
    # 3. K1 against its plain version
    u0 = torch.rand(8, 1, device=dev, generator=gen.manual_seed(1))
    v0 = {8: torch.rand(512, 1, device=dev, generator=gen), 4: torch.rand(64, 1, device=dev, generator=gen)}
    cases = [(2, s, c, 8, dt, "hals", four) for s, c in STAGES for dt in (torch.float32, torch.bfloat16)]
    cases += [(2, 32, 128, 8, torch.float32, "mu", four), (2, 32, 128, 8, torch.float32, "hals", zero_shift)]
    cases += [(2, 32, 128, 8, dt, "hals", ten) for dt in (torch.float32, torch.bfloat16)]
    cases += [(b, s, c, 4, dt, "hals", isles_shifts) for b, s, c in isles_shapes for dt in (torch.float32, torch.bfloat16)]
    cases += [(2, 64, 64, 8, torch.float16, "hals", four)]  # the f16 instance at one stage shape
    with torch.inference_mode():
        for b, s, c, p, dt, solver, shifts in cases:
            x = torch.relu(torch.randn(b, s, s, s, c, device=dev, generator=gen.manual_seed(s + c))).to(dt)
            args = (x, u0, v0[p], 8, p, shifts, solver, NUM_ITERS)
            out, ref = windowed_nmf(*args), windowed_nmf_plain(*args)
            # Each pass against its plain version on the same inputs: the factors pass on x, the reconstruct
            # pass on the kernel's factors.
            (U, V), (U_ref, V_ref) = windowed_nmf_factors(*args), windowed_nmf_factors_plain(*args)
            rest = (x.shape, dt, 8, p, shifts)
            y_b, y_b_ref = windowed_nmf_reconstruct(U, V, *rest), windowed_nmf_reconstruct_plain(U, V, *rest)
            torch.cuda.synchronize()
            err, rel = compare(out, ref)
            err_u, rel_u = compare(U, U_ref)
            err_v, rel_v = compare(V, V_ref)
            err_b, rel_b = compare(y_b, y_b_ref)
            tol = KERNEL_RTOL[dname(dt)]
            label = f"({b},{s}^3,{c}){'' if p == 8 else f' p={p}'} {dname(dt)} {solver} shifts={len(shifts)}"
            check(out.dtype == dt and out.shape == x.shape, f"K1 {label}: wrong output")
            check(rel <= tol, f"K1 {label}: max_abs {err:.3e} max_rel {rel:.3e} above {tol:.1e}")
            check(max(rel_u, rel_v) <= KERNEL_RTOL["float32"], f"K1 factors {label}: U max_rel {rel_u:.3e}, V {rel_v:.3e}")
            check(rel_b <= tol, f"K1 reconstruct {label}: max_abs {err_b:.3e} max_rel {rel_b:.3e} above {tol:.1e}")
            ms = cuda_time_ms(lambda: windowed_nmf(*args))
            ms_a = cuda_time_ms(lambda: windowed_nmf_factors(*args))
            ms_b = cuda_time_ms(lambda: windowed_nmf_reconstruct(U, V, *rest))
            plain_ms = cuda_time_ms(lambda: windowed_nmf_plain(*args), warmup=1, runs=5)
            plain_a = cuda_time_ms(lambda: windowed_nmf_factors_plain(*args), warmup=1, runs=5)
            plain_b = cuda_time_ms(lambda: windowed_nmf_reconstruct_plain(U, V, *rest), warmup=1, runs=5)
            bound = bound_ms(*k1_work(x, len(shifts), backward=False), dt, "float32")
            bound_a = bound_ms(*k1_pass_work(x, U, V, len(shifts), factors=True), dt, "float32")
            bound_b = bound_ms(*k1_pass_work(x, U, V, len(shifts), factors=False), dt, "float32")
            check(ms >= bound[0], f"K1 {label}: {ms:.4f} ms is below its bound {bound[0]:.4f} ms")
            print(f"[K1] {label}: max_abs={err:.3e} max_rel={rel:.3e} (tol {tol:.1e}) "
                  f"kernels {ms:.3f} ms plain {plain_ms:.3f} ms bound {bound[0]:.3f} ms ({bound[1]}); "
                  f"factors pass U max_rel={rel_u:.2e} V max_rel={rel_v:.2e} {ms_a:.3f} ms plain {plain_a:.3f} bound "
                  f"{bound_a[0]:.3f} ({bound_a[1]}); reconstruct pass max_rel={rel_b:.2e} {ms_b:.3f} ms plain {plain_b:.3f} "
                  f"bound {bound_b[0]:.3f} ({bound_b[1]}); factors {4 * (U.numel() + V.numel()) / 1e6:.1f} MB")
            record("windowed_nmf_factors", max(err_u, err_v), label, ms_a, plain_a, bound_a)
            record("windowed_nmf_reconstruct", err_b, label, ms_b, plain_b, bound_b)
            del x, out, ref, U, V, U_ref, V_ref, y_b, y_b_ref

    phase_done("3 K1")
    # 4. K2 against its plain version
    def mlp_params(c: int) -> tuple:
        h = 4 * c
        return (
            1 + 0.1 * torch.randn(c, device=dev, generator=gen.manual_seed(c)),
            0.1 * torch.randn(c, device=dev, generator=gen),
            torch.randn(h, c, device=dev, generator=gen) / c**0.5,
            0.1 * torch.randn(h, device=dev, generator=gen),
            torch.randn(c, h, device=dev, generator=gen) / h**0.5,
            0.1 * torch.randn(c, device=dev, generator=gen),
        )

    with torch.inference_mode():
        for s, c in STAGES:
            params = mlp_params(c)
            for dt in (torch.float32, torch.bfloat16) + ((torch.float16,) if c == 64 else ()):  # f16 at one stage
                x = torch.randn(2, s, s, s, c, device=dev, generator=gen).to(dt)
                args = (x, *params)
                out, again, ref = prenorm_mlp(*args), prenorm_mlp(*args), prenorm_mlp_plain(*args)
                torch.cuda.synchronize()
                err, rel = compare(out, ref)
                tol = KERNEL_RTOL[dname(dt)]
                label = f"(2,{s}^3,{c}) H={4 * c} {dname(dt)}"
                check(out.dtype == dt and out.shape == x.shape, f"K2 {label}: wrong output")
                check(rel <= tol, f"K2 {label}: max_abs {err:.3e} max_rel {rel:.3e} above {tol:.1e}")
                check(torch.equal(out, again), f"K2 {label}: two calls on one input differ")
                ms = cuda_time_ms(lambda: prenorm_mlp(*args))
                plain_ms = cuda_time_ms(lambda: prenorm_mlp_plain(*args), warmup=1, runs=5)
                n_bytes, flops, units = k2_work(x, 4 * c, backward=False)
                bound = bound_ms(n_bytes, flops, dt, units)
                print(f"[K2] {label}: max_abs={err:.3e} max_rel={rel:.3e} (tol {tol:.1e}), equal to itself bit for bit "
                      f"on a second call; kernel {ms:.3f} ms plain {plain_ms:.3f} ms bound {bound[0]:.3f} ms ({bound[1]}, "
                      f"{units}); {forward_shares(x.numel() // c, c, 4 * c)} share(s) of the hidden width")
                record("prenorm_mlp", err, label, ms, plain_ms, bound)
                del x, out, again, ref

    phase_done("4 K2")
    # 5. the serving slice
    sw_batch, overlap, n_requests = 2, 0.5, 2
    n_blocks, n_shifts = N_BLOCKS, N_SHIFTS
    serve_launches = dict.fromkeys(wrappers, 0)
    brats = dict(volume=(1, 4, 240, 240, 155), roi=(128, 128, 128), out_channels=3)
    isles = dict(volume=(1, 2, 112, 112, 73), roi=(64, 64, 64), out_channels=1)

    def serve_slice(tag: str, network, per_forward: dict, volume=brats["volume"], roi=brats["roi"],
                    out_channels=brats["out_channels"], dtypes=("float32", "bfloat16"), same_function_as=None) -> None:
        """Serve ``n_requests`` synthetic volumes after a warm-up request, per dtype; check the launches per request
        and the first request's logits against the plain versions and, where ``same_function_as`` builds a network
        that computes the same function by another route, against that network from the same seed."""
        n_windows = len(sliding_window_positions(volume[2:], roi, overlap))
        forwards = -(-n_windows // sw_batch)
        expected = {name: forwards * per_forward.get(name, 0) for name in wrappers}
        volumes = [torch.randn(volume, device=dev, generator=gen.manual_seed(100 + i)) for i in range(n_requests + 1)]

        def build_models(factory) -> dict:
            kw = {"float32": {}, "bfloat16": {"dtype": torch.bfloat16}}
            return {name: factory(device=dev, generator=torch.Generator().manual_seed(0), **kw[name]).eval() for name in dtypes}

        models = build_models(network)
        out_shape = (1, out_channels, *volume[2:])
        reset_counts()
        for name, model in models.items():
            ensemble_predict([model], volumes[-1], roi, sw_batch, overlap)  # warm-up request
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            seconds = []
            for i in range(n_requests):
                before = read_counts()
                t0 = time.perf_counter()
                mask, probs = ensemble_predict([model], volumes[i], roi, sw_batch, overlap)
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t0)
                check(tuple(mask.shape) == out_shape and tuple(probs.shape) == out_shape, f"{tag} {name}: output shape {tuple(mask.shape)}")
                check(bool(torch.isfinite(probs).all()), f"{tag} {name}: non-finite probabilities")
                made = {k: v - before[k] for k, v in read_counts().items()}
                check(made == expected, f"{tag} {name}: launches {made} for {forwards} forwards, expected {expected}")
            mem = torch.cuda.max_memory_allocated(dev)
            mean_s = statistics.mean(seconds)
            print(f"[{tag}] {name}: {mean_s:.3f} s/volume {tuple(volume)} (requests {', '.join(f'{t:.3f}' for t in seconds)} s), "
                  f"{n_windows / mean_s:.2f} windows/s, peak memory {mem / 2**30:.2f} GiB, "
                  f"foreground share {mask.float().mean().item():.4f}, "
                  f"launches per request { {k: v for k, v in expected.items() if v} }")
        for k, v in read_counts().items():
            serve_launches[k] += v
            check(v > 0 or not per_forward.get(k), f"{tag}: kernel {k} of the serving path never launched")

        others = build_models(same_function_as) if same_function_as is not None else {}
        with torch.inference_mode():
            for name, model in models.items():
                logits = sliding_window_inference(volumes[0], roi, model, sw_batch, overlap)
                with reference_kernels():
                    ref = sliding_window_inference(volumes[0], roi, model, sw_batch, overlap)
                torch.cuda.synchronize()
                err, rel = compare(logits, ref)
                print(f"[{tag}] {name} logits vs plain versions: max_abs={err:.3e} max_rel={rel:.3e} "
                      f"(tol {SLICE_RTOL[name]:.1e})")
                check(bool(torch.isfinite(logits).all()), f"{tag} {name}: non-finite logits")
                check(rel <= SLICE_RTOL[name], f"{tag} {name}: logits differ from the plain versions by {rel:.3e}")
                if name in others:
                    ref = sliding_window_inference(volumes[0], roi, others[name], sw_batch, overlap)
                    torch.cuda.synchronize()
                    err, rel = compare(logits, ref)
                    print(f"[{tag}] {name} logits vs {same_function_as.__name__}() from the same seed: max_abs={err:.3e} "
                          f"max_rel={rel:.3e} (tol {ROUTE_RTOL[name]:.1e})")
                    check(rel <= ROUTE_RTOL[name], f"{tag} {name}: the two routes differ by {rel:.3e}")
        del models, others, volumes, mask, probs, logits, ref
        gc.collect()
        torch.cuda.empty_cache()

    def forward_slice(tag: str, model, inputs, expected_launches: dict, out_shape: tuple, what: str) -> None:
        """One timed forward of ``inputs`` after a warm-up: launches, finite logits of ``out_shape``, and the
        logits against the plain versions, at the band of the model's compute dtype."""
        check(next(model.parameters()).is_cuda, f"{tag}: the network did not build on the card")
        name = dname(model.stem.dtype or torch.float32)
        with torch.inference_mode():
            model(inputs)  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            reset_counts()
            t0 = time.perf_counter()
            logits = model(inputs)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            made = read_counts()
            mem = torch.cuda.max_memory_allocated(dev)
            with reference_kernels():
                ref = model(inputs)
            torch.cuda.synchronize()
        expected = {name: expected_launches.get(name, 0) for name in wrappers}
        check(made == expected, f"{tag}: launches {made}, expected {expected}")
        check(tuple(logits.shape) == out_shape and bool(torch.isfinite(logits).all()), f"{tag}: wrong or non-finite logits")
        err, rel = compare(logits, ref)
        print(f"[{tag}] {name}: {seconds:.4f} s per forward of {tuple(inputs.shape)} ({what}), peak memory {mem / 2**30:.2f} GiB, "
              f"launches { {k: v for k, v in expected.items() if v} }; logits vs plain versions: max_abs={err:.3e} "
              f"max_rel={rel:.3e} (tol {SLICE_RTOL[name]:.1e})")
        check(rel <= SLICE_RTOL[name], f"{tag}: logits differ from the plain versions by {rel:.3e}")
        for k, v in made.items():
            serve_launches[k] += v

    k1_forward = {"windowed_nmf_factors": n_blocks, "windowed_nmf_reconstruct": n_blocks}
    serve_slice("slice", brats23_network, {**k1_forward, "prenorm_mlp": n_blocks})
    # The f16 instances on the serving path: one forward of a window pair through brats23_network(dtype=float16).
    forward_slice("slice f16", brats23_network(dtype=torch.float16, device=dev, generator=torch.Generator().manual_seed(0)).eval(),
                  torch.randn((2, 4, 128, 128, 128), device=dev, generator=gen.manual_seed(7)),
                  {**k1_forward, "prenorm_mlp": n_blocks}, (2, 3, 128, 128, 128), "a window pair of brats23_network(dtype=torch.float16)")

    phase_done("5 slice")
    # 6. K1 backward against autograd through the plain version
    # MU runs on a strictly positive input: where a whole row of a window is zero its factor decays to
    # ~eps and 1 / (v b + eps) ~ 1e16 makes the gradient so ill-conditioned that f32 keeps no digit of it,
    # in the kernel and in the plain version alike.
    cases = [(2, s, c, 8, dt, "hals", four, None, False) for s, c in STAGES for dt in (torch.float32, torch.bfloat16)]
    cases += [
        (2, 32, 128, 8, torch.float32, "mu", four, None, False),
        (2, 32, 128, 8, torch.float32, "hals", zero_shift, None, False),
        (2, 32, 128, 8, torch.float32, "hals", four, 2, False),
        (2, 64, 64, 8, torch.float32, "hals", four, None, True),  # a quarter of the volume all zero, as BraTS background
        (2, 64, 64, 8, torch.float16, "hals", four, None, False),  # the f16 instance
        (2, 64, 64, 8, torch.float16, "hals", four, None, True),   # f16 at all-zero windows: f32 cotangents, dx rounded
    ]
    cases += [(b, s, c, 4, dt, "hals", isles_shifts, None, False) for b, s, c in isles_shapes for dt in (torch.float32, torch.bfloat16)]
    for b, s, c, p, dt, solver, shifts, grad_steps, zero_windows in cases:
        x = torch.relu(torch.randn(b, s, s, s, c, device=dev, generator=gen.manual_seed(s + c)))
        if solver == "mu":
            x = torch.rand(b, s, s, s, c, device=dev, generator=gen) + 0.05
        if zero_windows:
            x[:, : s // 2, : s // 2] = 0
        x = x.to(dt)
        g = torch.randn(x.shape, device=dev, generator=gen).to(dt)
        args = (x, g, u0, v0[p], 8, p, shifts, solver, NUM_ITERS, 1e-16, grad_steps)
        out, ref = windowed_nmf_backward(*args), windowed_nmf_backward_plain(*args)
        torch.cuda.synchronize()
        err, rel = compare(out, ref)
        tol = K1_BWD_RTOL[dname(dt)]
        label = (f"({b},{s}^3,{c}){'' if p == 8 else f' p={p}'} {dname(dt)} {solver} shifts={len(shifts)}"
                 + (f" num_grad_steps={grad_steps}" if grad_steps is not None else "")
                 + (" zero windows" if zero_windows else "") + (" positive x" if solver == "mu" else ""))
        check(out.dtype == dt and out.shape == x.shape, f"K1 bwd {label}: wrong output")
        check(bool(torch.isfinite(out).all()), f"K1 bwd {label}: non-finite dx")
        check(rel <= tol, f"K1 bwd {label}: max_abs {err:.3e} max_rel {rel:.3e} above {tol:.1e}")
        del out, ref
        ms = cuda_time_ms(lambda: windowed_nmf_backward(*args))
        plain_ms = cuda_time_ms(lambda: windowed_nmf_backward_plain(*args), warmup=1, runs=3)
        bound = bound_ms(*k1_work(x, len(shifts), True, grad_steps or NUM_ITERS, solver == "mu"), dt, "float32")
        print(f"[K1 bwd] {label}: max_abs={err:.3e} max_rel={rel:.3e} (tol {tol:.1e}) "
              f"kernel {ms:.3f} ms plain forward+backward {plain_ms:.3f} ms bound {bound[0]:.3f} ms ({bound[1]})")
        record("windowed_nmf_bwd", err, label, ms, plain_ms, bound)
        del x, g, args
        torch.cuda.empty_cache()  # the plain version's graph holds several GB at 128^3 x 32

    phase_done("6 K1 bwd")
    # 7. K2 backward against autograd through the plain version
    grad_names = ("dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2")
    for s, c in STAGES:
        params = mlp_params(c)
        for dt in (torch.float32, torch.bfloat16) + ((torch.float16,) if c == 64 else ()):  # f16 at one stage
            x = torch.randn(2, s, s, s, c, device=dev, generator=gen).to(dt)
            g = torch.randn(x.shape, device=dev, generator=gen).to(dt)
            args = (x, g, *params)
            outs, again, refs = prenorm_mlp_backward(*args), prenorm_mlp_backward(*args), prenorm_mlp_backward_plain(*args)
            torch.cuda.synchronize()
            label = f"(2,{s}^3,{c}) H={4 * c} {dname(dt)}"
            check(all(torch.equal(a, b) for a, b in zip(outs, again)), f"K2 bwd {label}: two calls on one input differ")
            rels = {}
            for name, out, ref in zip(grad_names, outs, refs):
                err, rels[name] = compare(out, ref)
                tol = KERNEL_RTOL[dname(dt)] if name == "dx" else K2_PARAM_RTOL
                check(out.dtype == ref.dtype and out.shape == ref.shape, f"K2 bwd {label}: wrong {name}")
                check(rels[name] <= tol, f"K2 bwd {label}: {name} max_abs {err:.3e} max_rel {rels[name]:.3e} above {tol:.1e}")
                if name == "dx":
                    dx_err = err
            del outs, again, refs
            ms = cuda_time_ms(lambda: prenorm_mlp_backward(*args))
            plain_ms = cuda_time_ms(lambda: prenorm_mlp_backward_plain(*args), warmup=1, runs=3)
            n_bytes, flops, units = k2_work(x, 4 * c, backward=True)
            bound = bound_ms(n_bytes, flops, dt, units)
            print(f"[K2 bwd] {label}: dx max_abs={dx_err:.3e} max_rel={rels['dx']:.3e} (tol {KERNEL_RTOL[dname(dt)]:.1e}) "
                  f"params max_rel " + " ".join(f"{n}={rels[n]:.1e}" for n in grad_names[1:]) + f" (tol {K2_PARAM_RTOL:.1e}) "
                  f"kernel {ms:.3f} ms plain forward+backward {plain_ms:.3f} ms bound {bound[0]:.3f} ms ({bound[1]}, {units}); "
                  "equal to itself bit for bit on a second call")
            record("prenorm_mlp_bwd", dx_err, label, ms, plain_ms, bound)
            del x, g, args
            torch.cuda.empty_cache()

    phase_done("7 K2 bwd")
    # 8. the training slice.  The optimiser is the bundle's AdamW (lr 1e-4, weight decay 1e-5) at a
    # constant lr: the bundle's warm-up-cosine schedule starts at lr 0, so its first steps would not move.
    # cuDNN times its algorithms per shape from here on, as a training run with fixed shapes would have it:
    # without it the stem's f32 weight gradient alone takes 92 ms of a step.
    settings = brats23_optimizer_settings(steps_per_epoch=1)
    settings = {k: settings[k] for k in ("lr", "weight_decay")}
    torch.backends.cudnn.benchmark = True
    print(f"[train] AdamW {settings}, constant lr (the bundle's schedule warms up from lr 0), batch 2 x 128^3, DiceCE, "
          "torch.backends.cudnn.benchmark=True")

    batch = synthetic_batch(2, 4, 3, 128, seed=7)
    print(f"[train] label foreground share {batch['label'].mean().item():.4f}")
    train_launches = dict.fromkeys(wrappers, 0)
    n_steps = 4

    def train_slice(tag: str, network, launches_per_step: dict, leaves: dict, batch=batch,
                    dtypes=(torch.float32, torch.bfloat16), recomputes_per_step: int = 0, same_step_as=None) -> dict:
        """1 warm-up and 3 timed steps on ``batch``, per dtype: launches per step (and K4's rank > 1 backward
        recomputes, which are no launches), a falling loss, and the first step's loss and gradients (the norm and
        the ``leaves``) against the same step on the plain versions within ``TRAIN_RTOL``; or, where
        ``same_step_as`` builds a network that takes the same step by another way on the same kernels, the loss,
        the norm and every gradient equal bit for bit to that network's step from the same seed.
        Returns per dtype name (s/step, peak GiB)."""
        per_step = {name: launches_per_step.get(name, 0) for name in wrappers}
        out = {}
        for dt in dtypes:
            name = dname(dt)

            def new_state(factory=network):
                # No device argument: the entry points' default, the card, is what runs.
                model = factory(dtype=None if dt == torch.float32 else dt, generator=torch.Generator().manual_seed(0))
                check(next(model.parameters()).is_cuda, f"{tag}: the network did not build on the card")
                return create_train_state(model, **settings)

            # The first step on the plain versions (or on same_step_as), from the same weights.
            state = new_state(network if same_step_as is None else same_step_as)
            torch.cuda.reset_peak_memory_stats(dev)
            with contextlib.nullcontext() if same_step_as is not None else reference_kernels():
                _, metrics = make_train_step(state.model)(state, batch)
            torch.cuda.synchronize()
            ref_loss, ref_norm = metrics["loss"].item(), metrics["grad_norm"].item()
            ref_grads = {k: p.grad.clone() for k, p in state.model.named_parameters()
                         if k in leaves or same_step_as is not None}
            ref_mem = torch.cuda.max_memory_allocated(dev)
            del state, metrics
            gc.collect()
            torch.cuda.empty_cache()

            state = new_state()
            step = make_train_step(state.model)
            losses, seconds = [], []
            for i in range(n_steps):
                if i == 1:
                    torch.cuda.reset_peak_memory_stats(dev)
                reset_counts()
                nmf_reconstruct_backward.recomputes = 0
                t0 = time.perf_counter()
                state, metrics = step(state, batch)
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t0)
                counts = read_counts()
                check(counts == per_step, f"{tag} {name} step {i + 1}: launches {counts}, expected {per_step}")
                check(nmf_reconstruct_backward.recomputes == recomputes_per_step,
                      f"{tag} {name} step {i + 1}: {nmf_reconstruct_backward.recomputes} backward recomputes, expected {recomputes_per_step}")
                for k, v in counts.items():
                    train_launches[k] += v
                losses.append(metrics["loss"].item())
                grads = dict(state.model.named_parameters())
                bad = [k for k, p in grads.items() if p.grad is None or not bool(torch.isfinite(p.grad).all())]
                check(not bad, f"{tag} {name} step {i + 1}: no finite gradient for {bad[:5]}")
                if i == 0 and same_step_as is not None:
                    norm = metrics["grad_norm"].item()
                    unequal = [k for k, ref in ref_grads.items() if not torch.equal(grads[k].grad, ref)]
                    worst = max((float((grads[k].grad - ref_grads[k]).abs().max()) for k in unequal), default=0.0)
                    print(f"[{tag}] {name} step 1 vs the step of {same_step_as.__name__}: loss {losses[0]!r} / {ref_loss!r}, "
                          f"grad norm {norm!r} / {ref_norm!r}, {len(ref_grads) - len(unequal)} of {len(ref_grads)} "
                          f"gradients equal bit for bit (largest difference {worst:.3e}); reference step peak memory "
                          f"{ref_mem / 2**30:.2f} GiB")
                    check(losses[0] == ref_loss and norm == ref_norm and not unequal and grads.keys() == ref_grads.keys(),
                          f"{tag} {name}: the step differs from the step of {same_step_as.__name__}: loss {losses[0]!r} / "
                          f"{ref_loss!r}, grad norm {norm!r} / {ref_norm!r}, unequal gradients {unequal[:5]}")
                    ref_grads.clear()  # not held through the timed steps, whose peak memory is read
                elif i == 0:
                    tol = TRAIN_RTOL[name]
                    loss_rel = abs(losses[0] - ref_loss) / abs(ref_loss)
                    norm_rel = abs(metrics["grad_norm"].item() - ref_norm) / ref_norm
                    leaf_rel = {short: compare(grads[k].grad, ref_grads[k])[1] for k, short in leaves.items()}
                    print(f"[{tag}] {name} step 1 vs plain versions: loss {losses[0]:.6f} / {ref_loss:.6f} (rel {loss_rel:.2e}, "
                          f"tol {tol['loss']:.0e}), grad norm rel {norm_rel:.2e}, leaves max_rel "
                          + " ".join(f"{k}={v:.2e}" for k, v in leaf_rel.items()) + f" (tol {tol['grad']:.0e}); "
                          f"reference step peak memory {ref_mem / 2**30:.2f} GiB")
                    check(loss_rel <= tol["loss"], f"{tag} {name}: loss differs from the plain versions by {loss_rel:.2e}")
                    check(norm_rel <= tol["grad"] and max(leaf_rel.values()) <= tol["grad"],
                          f"{tag} {name}: gradients differ from the plain versions: norm {norm_rel:.2e}, leaves {leaf_rel}")
            mem = torch.cuda.max_memory_allocated(dev)
            check(all(map(math.isfinite, losses)), f"{tag} {name}: non-finite loss {losses}")
            check(losses[-1] < losses[0], f"{tag} {name}: loss did not fall: {losses}")
            timed = seconds[1:]
            print(f"[{tag}] {name}: {statistics.mean(timed):.4f} s/step (steps {', '.join(f'{s:.4f}' for s in timed)} s after a "
                  f"{seconds[0]:.2f} s warm-up step), peak memory {mem / 2**30:.2f} GiB, loss {' -> '.join(f'{v:.6f}' for v in losses)}, "
                  f"launches per step { {k: v for k, v in per_step.items() if v} }"
                  + (f", K4 backward recomputes in torch operations per step {recomputes_per_step}" if recomputes_per_step else ""))
            out[name] = (statistics.mean(timed), mem / 2**30)
            del state, step, metrics, grads, ref_grads
            gc.collect()
            torch.cuda.empty_cache()
        check(all(train_launches[k] > 0 for k, v in per_step.items() if v), f"{tag}: a kernel of the training path never launched: {train_launches}")
        return out

    brats_leaves = {"stem.weight": "stem", "encoder.blocks.0.block.blocks.0.mlp.block.0.linear.weight": "enc0.fc1",
                    "encoder.blocks.4.block.blocks.0.fact.out_proj.linear.weight": "bottleneck.out_proj"}
    plain_step = train_slice(
        "train", brats23_network,
        {**k1_forward, "windowed_nmf_bwd": n_blocks * n_shifts, "prenorm_mlp": n_blocks, "prenorm_mlp_bwd": n_blocks},
        brats_leaves,
    )
    # The bundle's remat: true.  Each stage block runs under torch.utils.checkpoint, so its forward runs again in
    # the backward: twice the K1 and K2 forward launches, the backward launches unchanged.
    remat_step = train_slice(
        "train remat", functools.partial(brats23_network, remat=True),
        {"windowed_nmf_factors": 2 * n_blocks, "windowed_nmf_reconstruct": 2 * n_blocks,
         "windowed_nmf_bwd": n_blocks * n_shifts, "prenorm_mlp": 2 * n_blocks, "prenorm_mlp_bwd": n_blocks},
        brats_leaves, dtypes=(torch.float32,), same_step_as=brats23_network,
    )
    (s_plain, mem_plain), (s_remat, mem_remat) = plain_step["float32"], remat_step["float32"]
    print(f"[train remat] float32: {s_remat:.4f} s/step and {mem_remat:.2f} GiB peak beside {s_plain:.4f} s/step and "
          f"{mem_plain:.2f} GiB without remat ({s_remat / s_plain:.3f}x the time, {mem_remat / mem_plain:.3f}x the memory)")

    phase_done("8 train")
    # 9. K3 against its plain version, and beside it the one library call that computes the same function:
    # F.conv{2,3}d with groups = B * C on tensors already laid out as (1, B*C, *S), so that the call is timed
    # without the plain version's two layout transposes.  cuDNN's benchmark mode is off in this phase and the
    # two serving phases below, as in the Factorizer's; the first case times the library call under both modes.
    torch.backends.cudnn.benchmark = False
    k3 = (3, 3, 3)
    # (x shape, kernel size, dtype, a quarter zero, the routes that conv_plan must give forward and dw)
    k3_cases = [((2, s, s, s, c), k3, dt, False, ("tile", "tile")) for s, c in STAGES for dt in (torch.float32, torch.bfloat16)]
    k3_cases += [
        ((16, 512, 512, 32), (7, 7), torch.float32, False, ("tile", "tile")),    # FIVES stage 0
        ((16, 128, 128, 128), (7, 7), torch.float32, False, ("tile", "tile")),   # FIVES stage 2
        ((2, 32, 32, 32, 128), (1, 3, 5), torch.float32, False, ("tile", "tile")),
        ((2, 32, 32, 32, 128), (3, 1, 9), torch.float32, False, ("any", "any")),  # k3 above 7: the per-output kernels
        ((2, 64, 64, 64, 48), k3, torch.float32, False, ("tile", "tile")),       # a width the TPU's packed kernel refuses
        ((2, 64, 64, 64, 64), k3, torch.float32, True, ("tile", "tile")),        # a quarter of the volume all zero
        ((8, 64, 64, 64, 32), k3, torch.float32, False, ("tile", "tile")),       # deconver_isles22's train batch, stage 0
        ((2, 5, 7, 9, 12), k3, torch.float32, False, ("tile", "tile")),          # tiles that the volume does not divide
        # The run kernels: widths that no 16-byte vector divides, and a weight gradient of more accumulators than
        # the tiled kernel holds; each also timed through the per-output kernel, the route it would take otherwise.
        ((2, 32, 32, 32, 30), k3, torch.float32, False, ("run", "run")),
        ((2, 32, 32, 32, 20), k3, torch.bfloat16, False, ("run", "run")),
        ((2, 32, 32, 32, 32), (3, 5, 5), torch.float32, False, ("tile", "run")),
        ((2, 64, 64, 64, 64), k3, torch.float16, False, ("tile", "tile")),       # the f16 instance
        # The spatial step's slabs with their halos (train_tp.yaml on 2 slabs): deconver_brats23's stage 0, 64 + 2
        # rows, and deconver_fives' stage 0, 256 + 6 rows of H.
        ((2, 66, 128, 128, 32), k3, torch.float32, False, ("tile", "tile")),
        ((16, 262, 512, 32), (7, 7), torch.float32, False, ("tile", "tile")),
    ]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    slower_than_library = []  # (line tag, label, per call or device, kernel / library)
    routes_seen = {False: set(), True: set()}

    def k3_plan(shape, ks, dt, routes, dw: bool, label: str):
        """The case's plan, checked: the route the case names, and for a tiled plan the mirror of
        csrc/depthwise_conv.cuh against the library (its constants, the plan's shared memory, tile_plan_ok)."""
        plan = conv_plan(shape, ks, dt, sms, dw=dw)
        tag = "K3 dw" if dw else "K3"
        check(plan.route == routes[dw], f"{tag} {label}: conv_plan chose the {plan.route} route, not {routes[dw]}")
        routes_seen[dw].add(plan.route)
        if plan.route == "tile":
            k1, k2, k3_ = plan.ks
            query = (ctypes.c_int * 7)()
            build.library().ftt_depthwise_conv_tile_query(*plan.shape[1:], k1, k2, k3_, dt.itemsize, int(dw), plan.t2,
                                                           plan.t3, plan.cb, plan.planes, query)
            mirror = (*TILE, tile_min_blocks(k2, k3_, dw), plan.smem)
            check(tuple(query) == mirror, f"{tag} {label}: the plan's constants and shared memory {mirror} differ "
                                          f"from the header's {tuple(query)}")
        return plan

    def k3_inputs(shape, ks, dt, zero_quarter):
        x = torch.randn(shape, device=dev, generator=gen.manual_seed(sum(shape))).to(dt)
        if zero_quarter:
            x[:, : shape[1] // 2, : shape[2] // 2] = 0
        g = torch.randn(shape, device=dev, generator=gen).to(dt)
        w = torch.randn(shape[0], math.prod(ks), shape[-1], device=dev, generator=gen)
        return x, g, w

    def k3_label(shape, ks, dt, zero_quarter) -> str:
        cube = len(shape) == 5 and len(set(shape[1:4])) == 1
        size = f"{shape[1]}^3" if cube else "x".join(map(str, shape[1:-1]))
        return (f"({shape[0]},{size},{shape[-1]}) k={'x'.join(map(str, ks))} {dname(dt)}"
                + (" zero quarter" if zero_quarter else ""))

    def channels_first(t):
        """``(1, B*C, *S)``, contiguous and f32: the layout the library call takes."""
        b, c = t.shape[0], t.shape[-1]
        return t.float().movedim(-1, 1).reshape(1, b * c, *t.shape[1:-1]).contiguous()

    def library_weight(w, ks):
        return w.transpose(1, 2).reshape(-1, 1, *ks).contiguous()

    def against_any(plan, shape, ks, dt, dw: bool, launch, ref, tol: float, label: str, ms: float) -> str:
        """For a run-route case: the per-output kernel (the route the shape would take without the run kernels)
        on the same inputs, held against the plain version and timed beside the run kernel."""
        if plan.route != "run":
            return ""
        tag, other = ("K3 dw" if dw else "K3"), conv_plan(shape, ks, dt, sms, dw=dw, route="any")
        out = launch(other)
        torch.cuda.synchronize()
        _, rel = compare(out, ref)
        check(rel <= tol, f"{tag} {label}: the per-output kernel's max_rel {rel:.3e} above {tol:.1e}")
        any_ms = cuda_time_ms(lambda: launch(other))
        return f"; per-output kernel {any_ms:.3f} ms (max_rel={rel:.3e}; run / per-output {ms / any_ms:.2f})"

    with torch.inference_mode():
        for i, (shape, ks, dt, zero_quarter, routes) in enumerate(k3_cases):
            x, _, w = k3_inputs(shape, ks, dt, zero_quarter)
            label = k3_label(shape, ks, dt, zero_quarter)
            plan = k3_plan(shape, ks, dt, routes, False, label)
            out, ref = depthwise_conv(x, w, ks), depthwise_conv_plain(x, w, ks)
            torch.cuda.synchronize()
            err, rel = compare(out, ref)
            tol = KERNEL_RTOL[dname(dt)]
            check(out.dtype == dt and out.shape == x.shape, f"K3 {label}: wrong output")
            check(rel <= tol, f"K3 {label}: max_abs {err:.3e} max_rel {rel:.3e} above {tol:.1e}")
            ms = cuda_time_ms(lambda: depthwise_conv(x, w, ks))
            plain_ms = cuda_time_ms(lambda: depthwise_conv_plain(x, w, ks), warmup=1, runs=5)
            conv = F.conv2d if len(ks) == 2 else F.conv3d
            xc, wc, pad, groups = channels_first(x), library_weight(w, ks), tuple(k // 2 for k in ks), shape[0] * shape[-1]
            library_ms = cuda_time_ms(lambda: conv(xc, wc, None, 1, pad, 1, groups), warmup=1, runs=5)
            bound = bound_ms(*k3_work(x, math.prod(ks), dw=False), dt)
            dev_ms = graph_time_ms(lambda: depthwise_conv(x, w, ks))
            dev_library_ms = graph_time_ms(lambda: conv(xc, wc, None, 1, pad, 1, groups))
            slower_than_library += [("K3", label, "per call", ms / library_ms)] if ms > library_ms else []
            slower_than_library += [("K3", label, "device", dev_ms / dev_library_ms)] if dev_ms > dev_library_ms else []
            line = (f"[K3] {label}: max_abs={err:.3e} max_rel={rel:.3e} (tol {tol:.1e}) kernel {ms:.3f} ms "
                    f"plain {plain_ms:.3f} ms library {library_ms:.3f} ms (kernel / library {ms / library_ms:.2f}); "
                    f"device (CUDA graph) kernel {dev_ms:.4f} ms library {dev_library_ms:.4f} ms "
                    f"({dev_ms / dev_library_ms:.2f}); bound {bound[0]:.3f} ms ({bound[1]}); "
                    f"plan: {plan.describe()}")
            line += against_any(plan, shape, ks, dt, False, lambda p: _launch_forward(x, w, ks, p), ref, tol, label, ms)
            if i == 0:
                torch.backends.cudnn.benchmark = True
                tuned_ms = cuda_time_ms(lambda: conv(xc, wc, None, 1, pad, 1, groups), warmup=2, runs=5)
                torch.backends.cudnn.benchmark = False
                line += f" library with cudnn.benchmark {tuned_ms:.3f} ms"
            print(line)
            record("depthwise_conv", err, label, ms, plain_ms, bound, library_ms)
            del x, w, out, ref, xc, wc
            torch.cuda.empty_cache()

    phase_done("9 K3")
    # 10. K3 dw against autograd through the plain version; the library call is the grouped convolution's
    # weight gradient alone (aten::convolution_backward with only that output asked for).
    for i, (shape, ks, dt, zero_quarter, routes) in enumerate(k3_cases):
        x, g, w = k3_inputs(shape, ks, dt, zero_quarter)
        label = k3_label(shape, ks, dt, zero_quarter)
        plan = k3_plan(shape, ks, dt, routes, True, label)
        out, again, ref = depthwise_conv_dw(x, g, ks), depthwise_conv_dw(x, g, ks), depthwise_conv_dw_plain(x, g, ks)
        torch.cuda.synchronize()
        err, rel = compare(out, ref)
        check(out.dtype == torch.float32 and out.shape == w.shape, f"K3 dw {label}: wrong output")
        check(rel <= K3_DW_RTOL, f"K3 dw {label}: max_abs {err:.3e} max_rel {rel:.3e} above {K3_DW_RTOL:.1e}")
        check(torch.equal(out, again), f"K3 dw {label}: two runs on one input differ")
        # dx and dw through the autograd function against autograd through the plain version
        xg, wg = x.detach().requires_grad_(True), w.detach().requires_grad_(True)
        before = depthwise_conv.launches, depthwise_conv_dw.launches
        dx, dw = torch.autograd.grad(depthwise_conv(xg, wg, ks), (xg, wg), g)
        check((depthwise_conv.launches - before[0], depthwise_conv_dw.launches - before[1]) == (2, 1),
              f"K3 dw {label}: the autograd function did not launch forward, dx and dw kernels")
        dx_ref, dw_ref = torch.autograd.grad(depthwise_conv_plain(xg, wg, ks), (xg, wg), g)
        torch.cuda.synchronize()
        (_, dx_rel), (_, dw_rel) = compare(dx, dx_ref), compare(dw, dw_ref)
        check(dx.dtype == dt and dx_rel <= KERNEL_RTOL[dname(dt)] and dw_rel <= K3_DW_RTOL,
              f"K3 dw {label}: autograd dx max_rel {dx_rel:.3e}, dw max_rel {dw_rel:.3e}")
        del out, again, xg, wg, dx, dw, dx_ref, dw_ref
        ms = cuda_time_ms(lambda: depthwise_conv_dw(x, g, ks))
        plain_ms = cuda_time_ms(lambda: depthwise_conv_dw_plain(x, g, ks), warmup=1, runs=3)
        nd, groups = len(ks), shape[0] * shape[-1]
        xc, gc_, wc = channels_first(x), channels_first(g), library_weight(w, ks)

        def library_dw():
            return torch.ops.aten.convolution_backward(gc_, xc, wc, None, [1] * nd, [k // 2 for k in ks], [1] * nd,
                                                       False, [0] * nd, groups, [False, True, False])[1]

        lib_err = compare(library_dw().reshape(shape[0], shape[-1], -1).transpose(1, 2), depthwise_conv_dw(x, g, ks))[1]
        check(lib_err <= K3_DW_RTOL, f"K3 dw {label}: the library call computes another function ({lib_err:.3e})")
        library_ms = cuda_time_ms(library_dw, warmup=1, runs=3)
        bound = bound_ms(*k3_work(x, math.prod(ks), dw=True), dt)
        dev_ms, dev_library_ms = graph_time_ms(lambda: depthwise_conv_dw(x, g, ks)), graph_time_ms(library_dw)
        slower_than_library += [("K3 dw", label, "per call", ms / library_ms)] if ms > library_ms else []
        slower_than_library += [("K3 dw", label, "device", dev_ms / dev_library_ms)] if dev_ms > dev_library_ms else []
        line = (f"[K3 dw] {label}: max_abs={err:.3e} max_rel={rel:.3e} (tol {K3_DW_RTOL:.1e}) bit-identical twice; autograd "
                f"dx max_rel={dx_rel:.3e} dw max_rel={dw_rel:.3e}; kernel {ms:.3f} ms plain forward+backward {plain_ms:.3f} ms "
                f"library {library_ms:.3f} ms (kernel / library {ms / library_ms:.2f}); device (CUDA graph) kernel "
                f"{dev_ms:.4f} ms library {dev_library_ms:.4f} ms ({dev_ms / dev_library_ms:.2f}); bound {bound[0]:.3f} ms "
                f"({bound[1]}); plan: {plan.describe()}")
        line += against_any(plan, shape, ks, dt, True, lambda p: _launch_dw(x, g, ks, p), ref, K3_DW_RTOL, label, ms)
        if i == 0:
            torch.backends.cudnn.benchmark = True
            tuned_ms = cuda_time_ms(library_dw, warmup=2, runs=3)
            torch.backends.cudnn.benchmark = False
            line += f" library with cudnn.benchmark {tuned_ms:.3f} ms; {dw_sum_share(lambda: depthwise_conv_dw(x, g, ks))}"
        print(line)
        record("depthwise_conv_dw", err, label, ms, plain_ms, bound, library_ms)
        del x, g, w, xc, gc_, wc, ref
        torch.cuda.empty_cache()

    check(routes_seen == {False: set(ROUTES), True: set(ROUTES)},
          f"K3: the cases do not reach every route in both directions: {routes_seen}")
    # What a slab's K3 call costs beyond K3 on the slab's own rows (Deconv on slabs): the halo rows' concatenation,
    # K3 on the slab and its halo, the crop back to the slab, forward, dx and dw; a K3 mode "valid" along S1 would
    # read the halo in place and approach the second time.  The neighbours' rows are random stand-ins here.
    for shape, ks in (((2, 64, 128, 128, 32), k3), ((16, 256, 512, 32), (7, 7))):
        width = ks[0] // 2
        x, g, w = k3_inputs(shape, ks, torch.float32, False)
        x.requires_grad_(True)
        w.requires_grad_(True)
        edges = [torch.randn(shape[0], width, *shape[2:], device=dev, generator=gen) for _ in range(2)]

        def on_slab():
            y = depthwise_conv(torch.cat([edges[0], x, edges[1]], 1), w, ks).narrow(1, width, shape[1])
            return torch.autograd.grad(y, (x, w), g)

        def alone():
            return torch.autograd.grad(depthwise_conv(x, w, ks), (x, w), g)

        slab_ms, alone_ms = cuda_time_ms(on_slab), cuda_time_ms(alone)
        cat_ms = cuda_time_ms(lambda: torch.cat([edges[0], x.detach(), edges[1]], 1))
        print(f"[K3 slab] {k3_label(shape, ks, torch.float32, False)}, a slab of {shape[1]} rows and a halo of {width} "
              f"each side, forward + dx + dw through the autograd function: concatenation, K3 and crop {slab_ms:.3f} ms "
              f"against K3 on the slab's rows alone {alone_ms:.3f} ms (+{slab_ms - alone_ms:.3f} ms, "
              f"{slab_ms / alone_ms:.3f}x); the concatenation alone {cat_ms:.3f} ms")
        del x, g, w, edges
        torch.cuda.empty_cache()
    print("[K3] kernel slower than its library call at: "
          + ("; ".join(f"{tag} {label}, {how} ({r:.2f}x)" for tag, label, how, r in slower_than_library) or "no case"))

    # The Deconv layer on an input with a quarter all zero (BraTS background after the ReLU): numerator and
    # denominator of the update are both eps there.  Source and gradients, kernels against plain versions.
    layer = Deconv(64, kernel_size=k3, groups=-1, ratio=1, num_iters=1, device=dev, generator=torch.Generator().manual_seed(3))
    x = torch.relu(torch.randn(2, 64, 64, 64, 64, device=dev, generator=gen.manual_seed(11)))
    x[:, :32, :32] = 0
    g = torch.randn(x.shape, device=dev, generator=gen)
    outs = []
    for plain in (False, True):
        xg = x.detach().requires_grad_(True)
        with reference_kernels() if plain else torch.enable_grad():
            y = layer(xg)
            outs.append((y.detach(), *torch.autograd.grad(y, (xg, layer.init.h0, layer.init.linear.linear.weight), g)))
    torch.cuda.synchronize()
    rels = [compare(a, b)[1] for a, b in zip(*outs)]
    check(all(bool(torch.isfinite(t).all()) for t in outs[0]), "Deconv layer, zero quarter: non-finite source or gradient")
    print("[K3 dw] Deconv layer (2,64^3,64) float32, a quarter of the input zero, kernels vs plain versions: max_rel "
          + " ".join(f"{n}={r:.2e}" for n, r in zip(("s", "dx", "dh0", "dlinear"), rels)) + f" (tol {DECONV_RTOL:.1e})")
    check(max(rels) <= DECONV_RTOL, f"Deconv layer, zero quarter: differs from the plain versions: {rels}")
    del layer, x, g, outs, xg, y
    gc.collect()
    torch.cuda.empty_cache()

    phase_done("10 K3 dw")
    # 11. the Deconver serving slice: three depthwise convolutions in each of nine blocks.
    k3_per_forward = 3 * n_blocks
    serve_slice("slice deconver", deconver_brats23_network, {"depthwise_conv": k3_per_forward})

    # 12. the FIVES forward at full width: batch 16 x 3 x 512^2, kernel 7x7 (its serving loop and train step
    # at full width are not driven here).
    fives = deconver_fives_network(generator=torch.Generator().manual_seed(0)).eval()
    images = torch.randn(16, 3, 512, 512, device=dev, generator=gen.manual_seed(21))
    forward_slice("slice fives", fives, images, {"depthwise_conv": k3_per_forward}, (16, 1, 512, 512),
                  "deconver_fives_network(), 16 images")
    del fives, images
    gc.collect()
    torch.cuda.empty_cache()

    # 13. the Deconver training slice: each depthwise convolution's backward is the forward kernel on flipped
    # taps (dx) and the dw kernel, since the input, the source and the taps (through h0) all carry gradients.
    torch.backends.cudnn.benchmark = True
    train_slice(
        "train deconver", deconver_brats23_network,
        {"depthwise_conv": 2 * k3_per_forward, "depthwise_conv_dw": k3_per_forward},
        {"stem.weight": "stem", "encoder.blocks.0.block.blocks.0.dcm.deconv.init.h0": "enc0.h0",
         "encoder.blocks.4.block.blocks.0.dcm.out_proj.linear.weight": "bottleneck.out_proj"},
    )

    phase_done("11-13 Deconver, FIVES")
    # 14. K4 against its plain version.  No single library call computes it: the plain version is a chain of
    # batched products and elementwise passes.  Every case asserts the route that nmf_plan gives it (and that the
    # library's ftt_nmf_plan_query agrees with the Python mirror), runs twice bit for bit, and is timed per call and
    # on the device (a CUDA graph of 20 calls); a case on the register route also runs through the shared-memory
    # kernel, against the plain version and timed beside.
    torch.backends.cudnn.benchmark = False
    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    k4_cases = [((n, 8, 512), 1, "hals", dt, False) for n in FLAT_STAGES for dt in (f32, bf16)]
    # the 2-D model's stages 0 and 2: 2 shifts x 16 x 4 heads x 64^2 windows, and 2 x 16 x 16 heads x 16^2
    k4_cases += [(shape, 1, "hals", dt, False) for shape in ((524288, 8, 64), (32768, 8, 64)) for dt in (f32, bf16)]
    k4_cases += [
        ((32768, 8, 512), 1, "mu", f32, False),
        ((32768, 8, 512), 2, "hals", f32, False),
        ((32768, 8, 512), 3, "hals", f32, False),
        ((32768, 8, 512), 4, "hals", f32, False),
        ((32768, 8, 512), 2, "mu", f32, False),
        ((32768, 8, 512), 4, "mu", f32, False),
        ((32768, 8, 64), 3, "hals", bf16, False),
        ((131072, 8, 512), 2, "hals", f32, False),  # stage 0 of brats23_network(rank=2)
        ((1000, 5, 37), 3, "hals", f32, False),     # no size a multiple of anything: the shared-memory kernel
        ((2048, 8, 4096), 1, "hals", f32, False),   # patches of 16^3: fits the forward kernel alone
        ((32768, 8, 512), 1, "hals", f32, True),    # a quarter of the matrices all zero
        ((32768, 8, 512), 1, "hals", f16, False),   # the f16 instance
    ]
    register_sizes = ((8, 512), (8, 64))  # the sizes the register kernels are compiled for
    nmf_query = (ctypes.c_longlong * 8)()
    k4_routes_seen = {False: set(), True: set()}

    def k4_inputs(shape, rank, dt, zero_quarter, positive=False):
        if positive:
            x = torch.rand(shape, device=dev, generator=gen.manual_seed(sum(shape) + rank)) + 0.05
        else:
            x = torch.relu(torch.randn(shape, device=dev, generator=gen.manual_seed(sum(shape) + rank)))
        if zero_quarter:
            x[: shape[0] // 4] = 0
        g = torch.randn(shape, device=dev, generator=gen)
        return (x.to(dt), g.to(dt), torch.rand(shape[-2], rank, device=dev, generator=gen),
                torch.rand(shape[-1], rank, device=dev, generator=gen))

    def k4_label(shape, rank, solver, dt, zero_quarter) -> str:
        return f"({','.join(map(str, shape))}) rank {rank} {solver} {dname(dt)}" + (" zero quarter" if zero_quarter else "")

    def k4_plan(shape, rank, solver, dt, backward: bool, label: str, route=None):
        """The case's plan, checked: the register route at the sizes the register kernels are compiled for, else
        the shared-memory route (or the route asked for), and the library's plan equal to the Python mirror's."""
        plan = nmf_plan(solver, rank, shape[1:], dt, NUM_ITERS, shape[0], backward, route=route)
        expect = route or ("registers" if tuple(shape[1:]) in register_sizes else "shared")
        tag = "K4 bwd" if backward else "K4"
        check(plan is not None and plan.route == expect, f"{tag} {label}: nmf_plan gave {plan}, not the {expect} route")
        build.library().ftt_nmf_plan_query(rank, *shape[1:], dt.itemsize, NUM_ITERS, shape[0], int(backward),
                                           NMF_ROUTES.index(route) if route else -1, nmf_query)
        check(tuple(nmf_query) == plan.query(), f"{tag} {label}: the plan {plan.query()} differs from the library's "
                                                f"{tuple(nmf_query)} (csrc/nmf_plan.cuh)")
        k4_routes_seen[backward].add(plan.route)
        return plan

    def k4_shared(name, launch, ref, tol, label, bound, plain_ms, dev_ms) -> str:
        """A register-route case through the shared-memory kernel: against the plain version, timed per call and
        on the device beside."""
        out = launch()
        torch.cuda.synchronize()
        err, rel = compare(out, ref)
        check(rel <= tol, f"{name} {label}: the shared-memory kernel's max_rel {rel:.3e} above {tol:.1e}")
        ms, o_dev = cuda_time_ms(launch), graph_time_ms(launch)
        record(f"{name}_shared", err, label, ms, plain_ms, bound)
        return (f"; shared kernel {ms:.3f} ms device {o_dev:.4f} ms (max_rel={rel:.2e}; registers / shared on the "
                f"device {dev_ms / o_dev:.2f})")

    with torch.inference_mode():
        for shape, rank, solver, dt, zero_quarter in k4_cases:
            x, _, tu, tv = k4_inputs(shape, rank, dt, zero_quarter)
            label = k4_label(shape, rank, solver, dt, zero_quarter)
            plan = k4_plan(shape, rank, solver, dt, False, label)
            args = (x, tu, tv, solver, NUM_ITERS)
            out, again, ref = nmf_reconstruct(*args), nmf_reconstruct(*args), nmf_reconstruct_plain(*args)
            torch.cuda.synchronize()
            err, rel = compare(out, ref)
            # bf16 rounds the output once, which outweighs the f32 band of the ranks above 1
            tol = max(KERNEL_RTOL[dname(dt)], K4_RANK_RTOL if rank > 1 else 0.0)
            check(out.dtype == dt and out.shape == x.shape, f"K4 {label}: wrong output")
            check(bool(torch.isfinite(out).all()), f"K4 {label}: non-finite output")
            check(rel <= tol, f"K4 {label}: max_abs {err:.3e} max_rel {rel:.3e} above {tol:.1e}")
            check(torch.equal(out, again), f"K4 {label}: two runs on one input differ")
            ms, dev_ms = cuda_time_ms(lambda: nmf_reconstruct(*args)), graph_time_ms(lambda: nmf_reconstruct(*args))
            plain_ms = cuda_time_ms(lambda: nmf_reconstruct_plain(*args), warmup=1, runs=5)
            n_bytes, flops = k4_work(x, rank, backward=False)
            bound = bound_ms(n_bytes, flops, dt)
            line = (f"[K4] {label}: max_abs={err:.3e} max_rel={rel:.3e} (tol {tol:.1e}) bit-identical twice; kernel {ms:.3f} ms "
                    f"device {dev_ms:.4f} ms plain {plain_ms:.3f} ms library none bound {bound[0]:.3f} ms ({bound[1]}; "
                    f"{n_bytes / 1e9:.3f} GB, {flops / 1e9:.2f} GFLOP); plan: {plan.describe()}")
            record(f"nmf_reconstruct_{plan.route}", err, label, ms, plain_ms, bound)
            if plan.route == "registers":
                k4_plan(shape, rank, solver, dt, False, label, route="shared")
                line += k4_shared("nmf_reconstruct", lambda: k4_launch_forward(x, tu, tv, solver, NUM_ITERS, 1e-16, "shared"),
                                  ref, tol, label, bound, plain_ms, dev_ms)
            print(line)
            del x, out, again, ref, args
            torch.cuda.empty_cache()

        # K4 on the folded windows of a volume against K1 at one zero shift: both run K1's rank-1 solve
        # (rank1_group_iterate) on the same values in the same order and round the product alike, so the outputs
        # are equal bit for bit.
        x = torch.relu(torch.randn(2, 32, 32, 32, 32, device=dev, generator=gen.manual_seed(41)))
        tu, tv = torch.rand(8, 1, device=dev, generator=gen), torch.rand(512, 1, device=dev, generator=gen)
        y_k1 = windowed_nmf(x, tu, tv, 8, 8, zero_shift, "hals", NUM_ITERS)
        # (b, window, head) matrices of (channel, position in the window), positions a1-major as K1 numbers them
        folded = x.view(2, 4, 8, 4, 8, 4, 8, 4, 8).permute(0, 1, 3, 5, 7, 8, 2, 4, 6).reshape(-1, 8, 512).contiguous()
        y_k4 = nmf_reconstruct(folded, tu, tv, "hals", NUM_ITERS)
        y_k4 = y_k4.view(2, 4, 4, 4, 4, 8, 8, 8, 8).permute(0, 1, 6, 2, 7, 3, 8, 4, 5).reshape(x.shape)
        torch.cuda.synchronize()
        check(torch.equal(y_k4, y_k1), f"K4 on fold(x) differs from K1 at one zero shift: max_rel {compare(y_k4, y_k1)[1]:.3e}")
        print("[K4] (2,32^3,32) f32 folded into (2048,8,512): K4 equals K1's single-shift windowed_nmf bit for bit")
        del x, y_k1, y_k4, folded

    phase_done("14 K4")
    # 15. K4 backward, rank 1, against autograd through the plain version.  MU runs on a strictly positive
    # input, as K1's backward does (its gradient at all-zero rows keeps no digit in f32 on either side).  The same
    # checks as phase 14: the plan, two runs bit for bit, device time, the register cases also through the
    # shared-memory kernel.
    k4_bwd_cases = [((n, 8, 512), "hals", dt, None, False) for n in FLAT_STAGES for dt in (f32, bf16)]
    k4_bwd_cases += [(shape, "hals", dt, None, False) for shape in ((524288, 8, 64), (32768, 8, 64)) for dt in (f32, bf16)]
    k4_bwd_cases += [
        ((32768, 8, 512), "mu", f32, None, False),
        ((32768, 8, 512), "hals", f32, 2, False),
        ((1000, 5, 37), "hals", f32, None, False),
        ((32768, 8, 512), "hals", f32, None, True),
        ((32768, 8, 512), "hals", f16, None, False),  # the f16 instance
    ]
    for shape, solver, dt, grad_steps, zero_quarter in k4_bwd_cases:
        x, g, tu, tv = k4_inputs(shape, 1, dt, zero_quarter, positive=solver == "mu")
        label = (k4_label(shape, 1, solver, dt, zero_quarter) + (f" num_grad_steps={grad_steps}" if grad_steps is not None else "")
                 + (" positive x" if solver == "mu" else ""))
        plan = k4_plan(shape, 1, solver, dt, True, label)
        args = (x, g, tu, tv, solver, NUM_ITERS, 1e-16, grad_steps)
        out, again = nmf_reconstruct_backward(*args), nmf_reconstruct_backward(*args)
        ref = nmf_reconstruct_backward_plain(*args)
        torch.cuda.synchronize()
        err, rel = compare(out, ref)
        tol = K1_BWD_RTOL[dname(dt)]
        check(out.dtype == dt and out.shape == x.shape, f"K4 bwd {label}: wrong output")
        check(bool(torch.isfinite(out).all()), f"K4 bwd {label}: non-finite dx")
        check(rel <= tol, f"K4 bwd {label}: max_abs {err:.3e} max_rel {rel:.3e} above {tol:.1e}")
        check(torch.equal(out, again), f"K4 bwd {label}: two runs on one input differ")
        del again
        ms = cuda_time_ms(lambda: nmf_reconstruct_backward(*args))
        dev_ms = graph_time_ms(lambda: nmf_reconstruct_backward(*args))
        plain_ms = cuda_time_ms(lambda: nmf_reconstruct_backward_plain(*args), warmup=1, runs=3)
        bound = bound_ms(*k4_work(x, 1, True, grad_steps or NUM_ITERS, solver == "mu"), dt)
        line = (f"[K4 bwd] {label}: max_abs={err:.3e} max_rel={rel:.3e} (tol {tol:.1e}) bit-identical twice; "
                f"kernel {ms:.3f} ms device {dev_ms:.4f} ms plain forward+backward {plain_ms:.3f} ms library none "
                f"bound {bound[0]:.3f} ms ({bound[1]}); plan: {plan.describe()}")
        record(f"nmf_reconstruct_bwd_{plan.route}", err, label, ms, plain_ms, bound)
        if plan.route == "registers":
            k4_plan(shape, 1, solver, dt, True, label, route="shared")
            line += k4_shared("nmf_reconstruct_bwd",
                              lambda: k4_launch_backward(x, g, tu, tv, solver, NUM_ITERS, grad_steps or NUM_ITERS, 1e-16, "shared"),
                              ref, tol, label, bound, plain_ms, dev_ms)
        print(line)
        del x, g, args, out, ref
        torch.cuda.empty_cache()
    check(k4_routes_seen == {False: set(NMF_ROUTES), True: set(NMF_ROUTES)},
          f"K4: the cases do not reach every route: {k4_routes_seen}")

    # Through the autograd function: rank 1 launches the backward kernel, rank 2 reruns the solve in torch
    # operations and differentiates that (counted in .recomputes, never in .launches); num_grad_steps=0 is zero.
    for rank in (1, 2):
        x, g, tu, tv = k4_inputs((32768, 8, 512), rank, torch.float32, False)
        xg = x.requires_grad_(True)
        before = nmf_reconstruct.launches, nmf_reconstruct_backward.launches, nmf_reconstruct_backward.recomputes
        (dx,) = torch.autograd.grad(nmf_reconstruct(xg, tu, tv), xg, g)
        made = (nmf_reconstruct.launches - before[0], nmf_reconstruct_backward.launches - before[1],
                nmf_reconstruct_backward.recomputes - before[2])
        check(made == ((1, 1, 0) if rank == 1 else (1, 0, 1)), f"K4 bwd rank {rank}: the autograd function made {made}")
        (dx_ref,) = torch.autograd.grad(nmf_reconstruct_plain(xg, tu, tv), xg, g)
        torch.cuda.synchronize()
        err, rel = compare(dx, dx_ref)
        check(rel <= K1_BWD_RTOL["float32"], f"K4 bwd rank {rank}: autograd dx max_rel {rel:.3e}")
        (zero,) = torch.autograd.grad(nmf_reconstruct(xg, tu, tv, "hals", NUM_ITERS, 1e-16, 0), xg, g)
        check(not bool(zero.any()), f"K4 bwd rank {rank}: num_grad_steps=0 gave a non-zero gradient")
        ms = cuda_time_ms(lambda: torch.autograd.grad(nmf_reconstruct(xg, tu, tv), xg, g), warmup=1, runs=5)
        how = "kernel" if rank == 1 else "recompute in torch operations"
        print(f"[K4 bwd] (32768,8,512) rank {rank} hals float32 through the autograd function ({how}): dx max_abs={err:.3e} "
              f"max_rel={rel:.3e} (tol {K1_BWD_RTOL['float32']:.1e}), forward+backward {ms:.3f} ms, num_grad_steps=0 exactly zero")
        del x, g, xg, dx, dx_ref, zero
        torch.cuda.empty_cache()

    # Through the module, whose route never looks at the dtype: float16 is served through K4 and held against the
    # plain version; float64, which no kernel reads, raises on the card instead of giving way to a plain version.
    before = read_counts()
    layer = MatrixFactorization((8, 512), rank=1, init_method="uniform", solver="hals", device=dev)
    xh = torch.rand(64, 8, 512, device=dev, generator=gen.manual_seed(16)).to(torch.float16)
    with torch.no_grad():
        served = layer(xh)
        with reference_kernels():
            plain = layer(xh)
    made = {k: v - before[k] for k, v in read_counts().items() if v != before[k]}
    check(made == {"nmf_reconstruct": 1, "nmf_reconstruct_registers": 1}, f"K4: the float16 module call launched {made}")
    err, rel = compare(served, plain)
    check(served.dtype == torch.float16 and rel <= KERNEL_RTOL["float16"],
          f"K4: MatrixFactorization on a float16 CUDA tensor: {served.dtype}, max_rel {rel:.3e}")
    print(f"[K4] MatrixFactorization on a float16 CUDA tensor (64,8,512): served through the register kernel, max_abs={err:.3e} "
          f"max_rel={rel:.3e} from the plain version (tol {KERNEL_RTOL['float16']:.1e})")
    try:
        layer(torch.rand(64, 8, 512, device=dev).double())
    except TypeError as e:
        print(f"[K4] MatrixFactorization on a float64 CUDA tensor raises: {e}")
    else:
        check(False, "K4: a float64 CUDA tensor did not raise")
    del xh, served, plain
    before = read_counts()
    big = MatrixFactorization((8, 4096), rank=1, init_method="uniform", solver="hals", device=dev)
    xb = torch.rand(64, 8, 4096, device=dev)
    with torch.no_grad():
        served = big(xb)
    check(nmf_reconstruct.launches == before["nmf_reconstruct"] + 1, "K4: an (8,4096) batch was not served through the kernel")
    try:
        nmf_reconstruct_backward(xb, torch.ones_like(xb), big.init.u0, big.init.v0)
    except ValueError as e:
        print(f"[K4 bwd] (64,8,4096) rank 1 raises: {e}")
    else:
        check(False, "K4 bwd: a size the backward kernel cannot hold did not raise")
    xg = xb.clone().requires_grad_(True)
    (dx,) = torch.autograd.grad(big(xg), xg, torch.ones_like(xb))
    torch.cuda.synchronize()
    made = {k: v - before[k] for k, v in read_counts().items() if v != before[k]}
    check(made == {"nmf_reconstruct": 1, "nmf_reconstruct_shared": 1}, f"K4: the (8,4096) checks launched {made}")
    err, rel = compare(big(xg).detach(), served)
    check(rel <= KERNEL_RTOL["float32"] and bool(torch.isfinite(dx).all()), f"K4: the decompose chain at (8,4096) differs from the kernel by {rel:.3e}")
    print(f"[K4] (64,8,4096) rank 1: served through the kernel; with a gradient recorded the module takes its decompose chain "
          f"(no launch), output max_rel={rel:.2e} from the kernel's (tol {KERNEL_RTOL['float32']:.1e})")
    del layer, big, xb, xg, dx, served
    torch.cuda.empty_cache()

    phase_done("15 K4 bwd")
    # 16. the flat-route serving slices.
    def brats23_flat_network(**kw):
        return brats23_network(factorize_options={"use_windowed": False}, **kw)

    k4_forward = {"nmf_reconstruct": n_blocks, "nmf_reconstruct_registers": n_blocks, "prenorm_mlp": n_blocks}
    serve_slice("slice flat", brats23_flat_network, k4_forward, same_function_as=brats23_network)

    # A 2-D Swin-Factorizer at the FIVES data shape (RGB in, one mask out, 512^2, batch 16) and the 3-D bundles'
    # widths: 2-D mixers take the flat route, two shifts (0 and half a patch).
    def swin2d_network(**kw):
        kw.setdefault("device", dev)  # the class builds where it is told; only the bundles' factories default to the card
        return Factorizer(
            in_channels=3, out_channels=1, spatial_size=(512, 512), encoder_depth=(1, 1, 1, 1, 1),
            encoder_width=(32, 64, 128, 256, 512), strides=(1, 2, 2, 2, 2), decoder_depth=(1, 1, 1, 1), mlp_ratio=4,
            reshape=(SWMatricize, {"head_dim": 8, "patch_size": 8}), act="relu", rank=1, num_iters=NUM_ITERS,
            init_method="uniform", solver="hals", **kw,
        )

    swin2d = swin2d_network(device=dev, generator=torch.Generator().manual_seed(0)).eval()
    images = torch.randn(16, 3, 512, 512, device=dev, generator=gen.manual_seed(31))
    forward_slice("slice 2d", swin2d, images, k4_forward, (16, 1, 512, 512), "a 2-D Swin-Factorizer, 16 images")
    del swin2d, images

    def brats23_rank2_network(**kw):
        return brats23_network(rank=2, **kw)

    rank2 = brats23_rank2_network(generator=torch.Generator().manual_seed(0)).eval()
    windows = torch.randn(2, 4, 128, 128, 128, device=dev, generator=gen.manual_seed(32))
    forward_slice("slice rank2", rank2, windows, k4_forward, (2, 3, 128, 128, 128), "brats23_network(rank=2), a window pair")
    del rank2, windows
    gc.collect()
    torch.cuda.empty_cache()

    f32_only = ("float32",)
    serve_slice("slice isles", factorizer_isles22_network, {**k1_forward, "prenorm_mlp": n_blocks},
                dtypes=f32_only, **isles)
    serve_slice("slice isles deconver", deconver_isles22_network, {"depthwise_conv": k3_per_forward}, dtypes=f32_only, **isles)

    phase_done("16 flat serving")
    # 17. the flat-route training slices.
    torch.backends.cudnn.benchmark = True
    factorizer_leaves = {"stem.weight": "stem", "encoder.blocks.0.block.blocks.0.mlp.block.0.linear.weight": "enc0.fc1",
                         "encoder.blocks.4.block.blocks.0.fact.out_proj.linear.weight": "bottleneck.out_proj"}
    k4_step = {**k4_forward, "nmf_reconstruct_bwd": n_blocks, "nmf_reconstruct_bwd_registers": n_blocks,
               "prenorm_mlp_bwd": n_blocks}
    train_slice("train flat", brats23_flat_network, k4_step, factorizer_leaves)
    # A 2-D step: every mixer's matrices are 8 x 64, which the backward kernel takes in its 64-thread instance.
    images = torch.randn(16, 3, 512, 512, device=dev, generator=gen.manual_seed(33))
    field = F.interpolate(torch.randn(16, 1, 8, 8, device=dev, generator=gen), size=(512, 512), mode="bilinear", align_corners=False)
    train_slice(
        "train 2d", swin2d_network, k4_step, factorizer_leaves, batch={"image": images, "label": (field > 0.3).float()},
        dtypes=(torch.float32,),
    )
    del images, field
    # A rank-2 step: K4 forward, and its backward as the recompute in torch operations, counted but no launch.
    train_slice(
        "train rank2", brats23_rank2_network, {**k4_forward, "prenorm_mlp_bwd": n_blocks},
        factorizer_leaves, dtypes=(torch.float32,), recomputes_per_step=n_blocks,
    )
    isles_batch = synthetic_batch(8, 2, 1, 64, seed=9)
    print(f"[train isles] batch 8 x 64^3, label foreground share {isles_batch['label'].mean().item():.4f}")
    train_slice(
        "train isles", factorizer_isles22_network,
        {**k1_forward, "windowed_nmf_bwd": n_blocks * n_shifts, "prenorm_mlp": n_blocks, "prenorm_mlp_bwd": n_blocks},
        factorizer_leaves, batch=isles_batch, dtypes=(torch.float32,),
    )

    # 28. the rest of the factorization engine, selected by network_def keys: the flat sets on stock torch, the K1
    # sets on the kernels; its launches are in the kernels line.
    phase_done("17 flat training")
    engine_launches = engine_slice(wrappers)
    phase_done("engine")
    # 29. the models' remaining options (deep supervision, dropout, split_shifts, the generic UNet); in the kernels
    # line too.
    options_launches = options_slice(wrappers)
    torch.backends.cudnn.benchmark = True

    phase_done("29 options")
    # 18. K5 in one process: every slab of a ring held as a list, the exchanges wired by hand.  The plain version is
    # the whole ring in torch operations; K1 on the gathered volume is the second reference, bit for bit: the slab
    # passes are K1's passes on the slab, the routed factors and rows are f32 and the passes sum in K1's order.
    torch.backends.cudnn.benchmark = False
    s1_first, s1_none = ((2, 3, 1), None, 6), ((0, 2, 4), (0, 6, 2))
    k5_cases = [(2, 128, 32, 8, dt, "hals", four, n, None, 8) for dt in (torch.float32, torch.bfloat16) for n in (4, 2)]
    k5_cases += [
        (2, 64, 64, 8, torch.float32, "hals", four, 4, None, 8),
        (2, 32, 128, 8, torch.float32, "hals", four, 4, None, 8),
        (8, 64, 32, 4, torch.float32, "hals", isles_shifts, 4, None, 8),  # factorizer_isles22: the (8, 4) instance
        (2, 32, 64, 4, torch.float32, "hals", isles_shifts, 4, None, 4),  # head_dim 4: the shared-memory solve
        (2, 32, 128, 8, torch.float32, "mu", four, 4, None, 8),
        (2, 32, 128, 8, torch.float32, "hals", s1_first, 4, None, 8),     # the first pass already routes rows
        (2, 32, 128, 8, torch.float32, "hals", s1_none, 4, None, 8),      # dims 2 and 3 alone: no byte leaves a slab
        (2, 32, 128, 8, torch.float32, "hals", ten, 2, None, 8),          # more shifts than one launch takes
        (2, 32, 128, 8, torch.float32, "hals", four, 1, None, 8),         # a ring of one
        (2, 32, 128, 8, torch.float32, "hals", four, 4, 2, 8),            # num_grad_steps: the backward alone differs
        (2, 64, 64, 8, torch.float16, "hals", four, 4, None, 8),          # the f16 instance, one ring
    ]
    k5 = windowed_nmf_multi_spatial
    u0_by_d = {8: u0, 4: torch.rand(4, 1, device=dev, generator=gen.manual_seed(4))}

    def k5_inputs(b, s, c, p, dt, solver, n):
        x = torch.relu(torch.randn(b, s, s, s, c, device=dev, generator=gen.manual_seed(s + c + n)))
        if solver == "mu":  # strictly positive, as K1's backward check
            x = torch.rand(b, s, s, s, c, device=dev, generator=gen) + 0.05
        x = x.to(dt)
        g = torch.randn(x.shape, device=dev, generator=gen).to(dt)
        return x, g, [t.contiguous() for t in x.chunk(n, 1)], [t.contiguous() for t in g.chunk(n, 1)]

    def k5_label(b, s, c, p, dt, solver, shifts, n, grad_steps, d) -> str:
        return (f"({b},{s}^3,{c}){'' if p == 8 else f' p={p}'}{'' if d == 8 else f' d={d}'} {dname(dt)} {solver} "
                f"shifts={list(shifts)} as {n} slab(s) of {s // n} rows"
                + (f" num_grad_steps={grad_steps}" if grad_steps is not None else ""))

    def k5_io(x, n, d, p, shifts, backward) -> tuple[int, int, int]:
        """Per ring: the exchanges, the bytes handed to them (exchange_sizes per slab: the forward's halo and routed
        factors, or the backward's two halos and routed rows) and the f32 words of the routed data."""
        halo, factors, rows = exchange_sizes(x.shape, d, p, shifts)
        routed = rows if backward else factors
        return 2 * bool(halo), n * ((2 if backward else 1) * halo * x.element_size() + 4 * routed), n * routed

    def k5_work(x, n, d, p, shifts, backward, grad_steps=NUM_ITERS, mu=False):
        """K1's work on the whole volume, and per slab the halo read (x's dtype; the backward reads two) and the
        routed factors or rows written in f32 and read again by the neighbour."""
        n_bytes, flops = k1_work(x, len(shifts), backward, grad_steps, mu)
        halo = exchange_sizes(x.shape, d, p, shifts)[0]
        return n_bytes + n * (2 if backward else 1) * halo * x.element_size() + 8 * k5_io(x, n, d, p, shifts, backward)[2], flops

    with torch.inference_mode():
        for case in (c for c in k5_cases if c[-2] is None):
            b, s, c, p, dt, solver, shifts, n, _, d = case
            x, _, xs, _ = k5_inputs(b, s, c, p, dt, solver, n)
            args = (u0_by_d[d], v0[p], d, p, shifts, solver, NUM_ITERS)
            before = (k5.launches, k5.tail_launches, k5.exchanges, k5.bytes_sent)
            out = torch.cat(windowed_nmf_multi_spatial_local(xs, *args), 1)
            made = (k5.launches - before[0], k5.tail_launches - before[1], k5.exchanges - before[2],
                    k5.bytes_sent - before[3])
            ref = torch.cat(windowed_nmf_multi_spatial_plain(xs, *args), 1)
            whole = windowed_nmf(x, *args)
            torch.cuda.synchronize()
            err, rel = compare(out, ref)
            tol = KERNEL_RTOL[dname(dt)]
            label = k5_label(*case)
            exchanges, sent, _ = k5_io(x, n, d, p, shifts, backward=False)
            check(out.dtype == dt and out.shape == x.shape, f"K5 {label}: wrong output")
            check(rel <= tol, f"K5 {label}: max_abs {err:.3e} max_rel {rel:.3e} above {tol:.1e}")
            check(torch.equal(out, whole), f"K5 {label}: differs from K1 on the whole volume by {compare(out, whole)[0]:.3e}")
            check(made == (2 * n, 0, exchanges, sent),
                  f"K5 {label}: launches, tail launches, exchanges, bytes sent {made}, expected {(2 * n, 0, exchanges, sent)}")
            ms = cuda_time_ms(lambda: windowed_nmf_multi_spatial_local(xs, *args))
            k1_ms = cuda_time_ms(lambda: windowed_nmf(x, *args))
            plain_ms = cuda_time_ms(lambda: windowed_nmf_multi_spatial_plain(xs, *args), warmup=1, runs=5)
            n_bytes, flops = k5_work(x, n, d, p, shifts, backward=False)
            bound = bound_ms(n_bytes, flops, dt, "float32")
            print(f"[K5] {label}: max_abs={err:.3e} max_rel={rel:.3e} (tol {tol:.1e}), equal to K1 on the whole volume bit for bit; "
                  f"ring {ms:.3f} ms = {ms / k1_ms:.2f}x K1's {k1_ms:.3f} ms, {made[0]} launches (pass A and pass B a slab), "
                  f"plain {plain_ms:.3f} ms bound {bound[0]:.3f} ms ({bound[1]}); sent per slab {sent / n / 1e6:.3f} MB in "
                  f"{exchanges} exchanges (= {1e3 * sent / n / NVLINK_BYTES:.4f} ms at NVLink's published 450 GB/s each way, "
                  f"not measured)")
            record("windowed_nmf_slab", err, label, ms, plain_ms, bound)
            del x, xs, out, ref, whole
            torch.cuda.empty_cache()

    # A slab of rows that the patch does not divide raises, on the card as on the CPU.
    bad = [torch.rand(2, 20, 32, 32, 128, device=dev) for _ in range(2)]
    try:
        windowed_nmf_multi_spatial_local(bad, u0, v0[8], 8, 8, four)
    except ValueError as e:
        print(f"[K5] two slabs of 20 rows, patch 8, raise: {e}")
    else:
        check(False, "K5: a slab of rows that the patch does not divide did not raise")
    del bad

    phase_done("18 K5")
    # 19. K5 backward: autograd through the slab kernels against autograd through the plain version, and against
    # K1's backward kernel on the whole volume, bit for bit.
    for case in k5_cases:
        b, s, c, p, dt, solver, shifts, n, grad_steps, d = case
        x, g, xs, gs = k5_inputs(b, s, c, p, dt, solver, n)
        args = (u0_by_d[d], v0[p], d, p, shifts, solver, NUM_ITERS, 1e-16, grad_steps)
        leaves = [t.requires_grad_(True) for t in xs]
        ys = windowed_nmf_multi_spatial_local(leaves, *args)
        before = (k5.backward_launches, k5.tail_launches, k5.exchanges, k5.bytes_sent)
        out = torch.cat(torch.autograd.grad(ys, leaves, gs, retain_graph=True), 1)
        made = (k5.backward_launches - before[0], k5.tail_launches - before[1], k5.exchanges - before[2],
                k5.bytes_sent - before[3])
        exchanges, sent, _ = k5_io(x, n, d, p, shifts, backward=True)
        want = (n * len(shifts), n * (exchanges > 0), exchanges, sent)
        check(made == want, f"K5 bwd {k5_label(*case)}: launches, tail launches, exchanges, bytes sent {made}, "
                            f"expected {want}")
        ref = torch.cat(torch.autograd.grad(windowed_nmf_multi_spatial_plain(leaves, *args), leaves, gs), 1)
        whole = windowed_nmf_backward(x, g, *args)
        torch.cuda.synchronize()
        err, rel = compare(out, ref)
        tol = K1_BWD_RTOL[dname(dt)]
        label = k5_label(*case)
        check(out.dtype == dt and bool(torch.isfinite(out).all()), f"K5 bwd {label}: wrong or non-finite dx")
        check(rel <= tol, f"K5 bwd {label}: max_abs {err:.3e} max_rel {rel:.3e} above {tol:.1e}")
        check(torch.equal(out, whole), f"K5 bwd {label}: differs from K1 bwd on the whole volume by {compare(out, whole)[0]:.3e}")
        del out, ref, whole
        ms = cuda_time_ms(lambda: torch.autograd.grad(ys, leaves, gs, retain_graph=True))
        k1_ms = cuda_time_ms(lambda: windowed_nmf_backward(x, g, *args))

        def plain_forward_backward():
            torch.autograd.grad(windowed_nmf_multi_spatial_plain(leaves, *args), leaves, gs)

        plain_ms = cuda_time_ms(plain_forward_backward, warmup=1, runs=3)
        n_bytes, flops = k5_work(x, n, d, p, shifts, True, grad_steps or NUM_ITERS, solver == "mu")
        bound = bound_ms(n_bytes, flops, dt, "float32")
        print(f"[K5 bwd] {label}: max_abs={err:.3e} max_rel={rel:.3e} (tol {tol:.1e}), equal to K1 bwd on the whole volume bit for "
              f"bit; ring {ms:.3f} ms = {ms / k1_ms:.2f}x K1 bwd's {k1_ms:.3f} ms, {made[0]} pass and {made[1]} tail launches, "
              f"plain forward+backward {plain_ms:.3f} ms bound {bound[0]:.3f} ms ({bound[1]}); sent per slab "
              f"{sent / n / 1e6:.3f} MB in {exchanges} exchanges")
        record("windowed_nmf_slab_bwd", err, label, ms, plain_ms, bound)
        del x, g, xs, gs, leaves, ys, args
        torch.cuda.empty_cache()

    phase_done("19 K5 bwd")
    # 20., 21. the two multi-process slices, on this one card: gloo, device tensors staged through the host.
    spatial_launches = spatial_slice(2)
    torch.backends.cudnn.benchmark = True
    for k, v in train_dp_slice(2, settings, n_steps).items():
        train_launches[k] += v
    gc.collect()
    torch.cuda.empty_cache()
    phase_done("20-21 spatial, train dp")
    # 25. the spatial train step (train_tp.yaml's), two processes on this card; its launches are in the kernels line.
    tp_launches = train_tp_slice(2, settings)
    gc.collect()
    torch.cuda.empty_cache()
    phase_done("25 train tp")
    # 30. the spatial step's former refusals; its launches are in the kernels line.
    gap_launches = slab_gaps_slice()
    torch.backends.cudnn.benchmark = True
    gc.collect()
    torch.cuda.empty_cache()
    phase_done("30 slab gaps")
    # 31. the spatial step on slabs of unequal rows; its launches are in the kernels line.
    uneven_launches = uneven_slabs_slice()
    stop_forkserver()  # the last phase of run_processes' workers
    torch.backends.cudnn.benchmark = True
    gc.collect()
    torch.cuda.empty_cache()
    phase_done("31 uneven slabs")
    # 22. the training workflow from NIfTI files; its launches are checked there and left out of the kernels line.
    workflow_slice(wrappers)
    phase_done("22 workflow")
    # 23. the bundles' YAML programs through the config parser and the CLI; left out of the kernels line too, but for
    # 32. [hosts]' processes (launches_hosts).
    hosts = bundle_slice(wrappers)
    phase_done("23 bundle")
    # 24. the baseline bundles and UNETR, stock PyTorch: no kernel of the port launches.
    baselines_slice(wrappers)
    phase_done("24 baselines")
    print(f"[time] wall seconds by phase: {', '.join(f'{n} {t:.1f}' for n, t in phase_seconds)}; "
          f"{sum(t for _, t in phase_seconds):.1f} s in all; of 23 bundle, 32 [hosts] {hosts['seconds']:.1f} s end to "
          f"end beside [bundle tp]'s deconver_brats23 and [bundle multidevice]'s factorizer_brats23")

    sources = {
        "windowed_nmf_factors": ("factorizer_tpu_torch/csrc/windowed_nmf.cu",
                                 "factorizer_tpu/ops/pallas/windowed_nmf_kernel.py:379"),
        "windowed_nmf_reconstruct": ("factorizer_tpu_torch/csrc/windowed_nmf.cu",
                                     "factorizer_tpu/ops/pallas/windowed_nmf_kernel.py:379"),
        "windowed_nmf_bwd": ("factorizer_tpu_torch/csrc/windowed_nmf_bwd.cu",
                             "factorizer_tpu/ops/pallas/windowed_nmf_kernel.py:411"),
        "prenorm_mlp": ("factorizer_tpu_torch/csrc/mlp_block.cu", "factorizer_tpu/ops/pallas/mlp_block.py:183"),
        "prenorm_mlp_bwd": ("factorizer_tpu_torch/csrc/mlp_block_bwd.cu", "factorizer_tpu/ops/pallas/mlp_block.py:197"),
        "depthwise_conv": ("factorizer_tpu_torch/csrc/depthwise_conv.cu", "factorizer_tpu/ops/pallas/depthwise_packed.py:131"),
        "depthwise_conv_dw": ("factorizer_tpu_torch/csrc/depthwise_conv_dw.cu", "factorizer_tpu/ops/pallas/depthwise_packed.py:147"),
        "nmf_reconstruct_registers": ("factorizer_tpu_torch/csrc/nmf.cu", "factorizer_tpu/ops/pallas/nmf_kernel.py:142"),
        "nmf_reconstruct_shared": ("factorizer_tpu_torch/csrc/nmf.cu", "factorizer_tpu/ops/pallas/nmf_kernel.py:142"),
        "nmf_reconstruct_bwd_registers": ("factorizer_tpu_torch/csrc/nmf_bwd.cu", "factorizer_tpu/ops/pallas/nmf_kernel.py:142"),
        "nmf_reconstruct_bwd_shared": ("factorizer_tpu_torch/csrc/nmf_bwd.cu", "factorizer_tpu/ops/pallas/nmf_kernel.py:142"),
        "windowed_nmf_slab": ("factorizer_tpu_torch/csrc/windowed_nmf_slab.cu",
                              "factorizer_tpu/ops/pallas/windowed_sharded.py:112"),
        "windowed_nmf_slab_bwd": ("factorizer_tpu_torch/csrc/windowed_nmf_slab_bwd.cu",
                                  "factorizer_tpu/ops/pallas/windowed_sharded.py:90"),
    }
    kernels = []
    for name, (source, replaces) in sources.items():
        label, ms, plain_ms, b_ms, b_by, library_ms = results[name]["times"]
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": serve_launches[name] + train_launches[name] + spatial_launches[name]
                        + tp_launches[name] + engine_launches[name] + options_launches[name] + gap_launches[name]
                        + uneven_launches[name] + hosts["launches"][name],
                        "launches_serving": serve_launches[name], "launches_training": train_launches[name],
                        "launches_spatial": spatial_launches[name], "launches_train_tp": tp_launches[name],
                        "launches_slab_gaps": gap_launches[name], "launches_uneven": uneven_launches[name],
                        "launches_hosts": hosts["launches"][name],
                        "launches_engine": engine_launches[name], "launches_options": options_launches[name],
                        "max_abs_err": max(results[name]["errs"]),
                        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                        "library_ms": library_ms, "timed_at": label})
    last_lines(kernels)


if __name__ == "__main__":
    main()
