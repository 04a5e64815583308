#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``horovod_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``horovod_tpu_torch/csrc`` (nvcc)
and, beside them, its C++ negotiation core from
``horovod_tpu_torch/native/src`` (g++), and then:

1. prints the card's name and power limit (``nvidia-smi``); runs the
   port's launcher (``python -m horovod_tpu_torch.runner``) with
   ``--check-build`` (the native C++ core, NCCL, gloo, CUDA and every
   kernel of ``csrc`` marked built), with ``--autotune`` and its four
   settings (accepted, in the worker's env) and with one rank a host
   more than the cards
   (``-np 2`` on one card): it exits non-zero within the start timeout,
   its output names the local rank that has no card and the card count,
   and no worker is left behind; then, before ``init()``, runs the
   port's fabric simulator (``horovod_tpu_torch.sim``): the 15 scenarios
   at 64 virtual ranks, seed 7, in this process (the controller
   scenarios' payloads and controllers on cuda:0),
   ``compression-negotiation`` at 256 on the card, and ``python -m
   horovod_tpu_torch.sim run steady-drain --ranks 256 --seed 7`` twice as
   subprocesses beside them: every event log's and ``stats``' sha256
   equal to the reference's pinned in ``SIM_DIGESTS``, every controller
   on cuda:0, the phase within 120 s;
2. holds kernel A1 bitwise against its plain PyTorch versions: one
   tensor (``fused_scale_cast``, a table of one entry) over all 9 dtype
   pairs, lengths 1..2^20+3, aligned and unaligned buffers and every
   ResNet-50 gradient shape; the grouped passes (``scale_cast_pack``,
   ``unpack_cast_scale``, any NaN equal to any NaN) over the 161
   ResNet-50 gradients in both directions, the 9 (in, out) dtype pairs
   with each own dtype, scale 1 among the scales, sources and destinations at odd element
   offsets, a zero-length entry, NaN/inf/subnormal/-0 values, and a
   group larger than one table (more than one launch); then times the
   two passes over the 161 gradients against their bound,
   ``_foreach_mul`` and the per-tensor composition they replace, and one
   25.56 M buffer against ``torch.mul``;
3. trains full-width ResNet-50 (bf16, NHWC 224x224, batch 64, synthetic
   data from a seed) through ``hvd.DistributedOptimizer`` (SGD momentum
   0.9, ``Compression.fp16``, ``gradient_predivide_factor=2.0``) in a
   one-rank NCCL world: 2 warm-up and 5 timed steps, finite loss, and
   exactly 2 A1 launches per multi-tensor bucket a step;
4. reduces one batch's gradients through the optimizer's group reduction
   with the kernel and with the plain versions: bitwise equal; then
   times the group reduction over the real buckets, grouped and tensor
   by tensor; both in the training's configuration and in the
   optimizer's default (Average, no predivide: both scales 1);
5. holds kernels A2/A3, ``quantize_int8_blocks`` (both rounding modes)
   and ``dequantize_int8_blocks``, bitwise against their plain versions
   (any NaN equal to any NaN) over float32/bfloat16/float16 in and out,
   lengths 1..2^20+3 (at the edges of the kernels' words and blocks),
   aligned and offset views, codes at an odd address, the NaN/inf/zero/
   subnormal blocks, every ResNet-50 gradient shape and one 25.56 M
   buffer, and times them;
6. drives the int8 path at full width: one backward of the ResNet-50 of
   phase 3, its 161 gradients and their packed buffer through the
   engine's ``Compression.int8`` and ``int8_stochastic`` (161 + 1 A2 and
   A3 launches a codec), error bounds per block, stochastic rounding
   unbiased and moving the expected share of codes off ``rint``, the
   world-of-one ``allreduce(compression=int8)`` rule, and
   ``quantized_allreduce`` over the one-rank NCCL group bitwise equal to
   the same call on the CPU, then times it and its two codec phases on
   the bucket beside A2 and A3; then the torch surface's allreduce and
   allgather on card tensors that require grad carry their gradient;
   then the async controller: phase 3's 161 gradients (float32, in hook
   order) as a burst of ``allreduce_async_`` with the optimizer's
   arguments (Sum, prescale 1/2, postscale 2/1, fp16) and as one
   ``grouped_allreduce_async``, both again under ``none``: every result
   bitwise the plain composition of the group the controller's responses
   name (and ``GroupReduction``'s under ``none``), two A1 launches a
   fused group of several tensors and none a tensor, the host ms and
   controller cycles of each burst beside ``GroupReduction.reduce``'s ms
   on the same gradients; the fp16 and none bursts on the C++
   negotiation core (the default) and on ``PyController`` (a second
   controller) in turns, 4 pairs a codec after an untimed burst each:
   results bitwise equal across the cores and the plain composition,
   the same groups and A1 launches, each burst's host ms and its
   negotiation split (the core's drain, the exchange, the core's apply);
   a third controller with an ``Autotuner`` (grid mode, 2 candidates,
   one step a sample) over 4 fp16 bursts: the tuned threshold and cycle
   time reach the controller, no prediction once tuned, every result
   the plain composition of its group, and each compute's groups the
   greedy split at the threshold in force; a
   process set {0} with its own NCCL groups; the BERT-base word
   embedding's sparse gradient through ``sparse_allreduce_async`` and a
   ``sparse_as_dense`` step; the other async ops against the sync ones;
   then the controller's zero-copy route: the 161 gradients as
   ``allreduce_async_`` with the optimizer's default arguments (Average,
   no codec, scales 1), values changed from burst to burst, 3 untimed
   bursts that learn the pack plan, then 10 timed bursts with the route
   on and off in turns: every result bitwise the staged route's and in
   the caller's tensor, 161 zero-copy ops and one A1 launch a fused group
   with the route on, 161 staged copies and two with it off, the plane
   (lockstep at one rank) and the predicted bursts (none);
   Adasum: ``pairwise_adasum`` over two batches' 161 gradients (float32,
   a segment a tensor) against the float64 reference, and a ResNet-50
   step with ``op=Adasum`` bitwise the ``op=Sum`` step;
   the meshes and the collectives over a mesh axis: ``world_mesh()``,
   ``hierarchical_mesh()`` (1 x 1), the proc mesh and ``mesh(("dp",
   "tp"), (1, 1))`` on the card; every ``comm/spmd.py`` function over the
   one-rank world axis on card tensors (float32, bfloat16, int32; pre-
   and postscale, Average, Min/Max/Product, Adasum, the fp16, int8 and
   int8_stochastic codecs) bitwise the same call over a one-rank gloo
   mesh on CPU copies; phase 3's 161 gradients, a dict keyed by
   parameter name, through ``allreduce_gradients`` on the eager plan, on
   the eager plan under an ``Autotuner`` (its threshold in force,
   ``record_step`` seen) and along the world axis, all bitwise the
   optimizer's ``GroupReduction.reduce`` (Average, no codec), with each
   path's host ms, 4 turns; ``ShardedDistributedOptimizer(SGD, momentum
   0.9)`` bitwise ``torch.optim.SGD`` over 3 steps, its state's bytes and
   ms a step; ``_SyncBatchNormFn`` on ResNet-50's first BatchNorm shape
   (64, 64, 112, 112) bfloat16, forward and backward, within 2^-7 of
   ``F.batch_norm`` on the float32 input, and a ResNet-50 training step
   with ``SyncBatchNorm`` in place of every BatchNorm;
   the hybrid-parallel transformer (``parallel/*``,
   ``models/transformer.py``) at the full width of the reference's
   ``TransformerConfig()`` (vocab 32000, d_model 512, 8 heads, 8 layers,
   d_ff 2048, max_seq 2048, bfloat16, ``megatron_sp``; 42,627,584
   parameters from seed 0) over ``make_layout()`` (every axis of size 1):
   ``make_train_step`` with ``torch.optim.Adam(lr=3e-3)`` on one fixed
   batch of 8 x 2049 tokens, 2 warm-up and 5 timed steps, the loss
   finite at every step and lower at the last than at the first; one
   step's FLOPs by ``FlopCounterMode`` against the card's peak (where its
   time goes: ``torch_port_profile.py --model transformer``); one step
   each, finite, of ring and Ulysses attention (a dedicated sp axis of
   1) and of the Switch MoE (8 experts, capacity factor 2.0) on the same
   batch; then, at 2 layers in float32 with TF32 off and a batch of 2,
   each of the four modes' loss and gradients on the card against the
   same call on the CPU: the loss within 1e-5 relative, each gradient's
   largest difference within 1e-3 of its largest magnitude.  No TPU
   kernel lies on this path (the reference computes it in XLA);
   the reference's benchmark trio at full width, uncut (``bench.py:46-48``,
   lr ``:297``): ResNet-101 224x224 batch 128, Inception V3 299x299 batch
   128, VGG-16 224x224 batch 64 (lr 0.01), bf16, synthetic data from the
   seed, through ``hvd.DistributedOptimizer(SGD momentum 0.9,
   Compression.fp16, gradient_predivide_factor=2.0)``, 2 warm-up and 5
   timed steps: step ms, images/s, FLOPs by ``FlopCounterMode`` and their
   share of the card's peak, peak memory, buckets and A1 launches a step
   (2 a multi-tensor bucket, counted from 0 over each model's run), the
   loss finite and falling (a batch that does not fit is halved and the
   cut printed); one finite step each of ResNet-18/34/152, the MLP and
   ResNet-50 with ``stem="s2d"`` and with ``remat=True``; ResNet-50's peak
   memory with and without ``remat`` at batch 64, in turns (remat lower,
   the first loss equal); then, with TF32 off and cuDNN's deterministic
   heuristics, ResNet-18, ResNet-101, ResNet-50 (s2d, remat) and the MLP
   trained one step at a small batch in float32, VGG-16 in float64 (its
   float32 errors printed beside, not gated), Inception V3 through its
   running stats at 75x75 and its train-mode logits at 299x299, on the
   card against the CPU: the loss within 1e-4 relative (the logits 1e-3),
   each gradient within 1e-2 of its largest magnitude; and the input
   gradient of the port's 3x3/1 ``SAME`` average pool on a channels-last
   tensor within 1e-6 (``avg_pool2d``'s own ``padding`` printed beside:
   its CUDA backward is wrong there);
   the sharded checkpoint: ``TransformerConfig()`` uncut with its Adam
   state after one step, as DTensors over ``make_layout()`` at one rank
   (``models.transformer.global_params``): ``ShardedTorchState.commit``
   (ms on the training thread, bytes on disk), ``verify_step``, a fresh
   state's ``sync`` (every leaf bitwise, on the card), and
   ``ShardedCheckpointer.save`` / ``restore`` alone; then 2 processes on
   cuda:0 (``--sharded-ckpt-child``, gloo over a ``TCPStore``) save the
   transformer at tp=2, each writing only its shards (its files and bytes
   printed; the pieces hold each array once), and this process restores
   their step onto its own layout, bitwise the global arrays;
   the stall watchdog: two of the port's amortized inspectors over one
   ``HashStore`` (ranks 0 and 1 of a set {0, 1}; heartbeat 0.05 s, warn
   0.3 s, abort 1.0 s), rank 0 running the optimizer's group reduction
   over phase 3's 161 gradients (A1's grouped passes and the one-rank NCCL
   allreduce) through ``dispatch`` / ``wait_ready``: 20 healthy ops with
   rank 1 mirroring each descriptor (no warning, bitwise the unguarded
   reduction, 2 A1 launches a multi-tensor bucket, the host µs
   ``pre_op`` adds and ``wait_ready``'s overshoot past the event's
   completion), a diverged op (the error names both ops; its detection
   latency), and a dead peer mid-op (the card sleeps 3 s before the
   reduction, rank 1's beats stop: the abort names rank 1 while the
   op's CUDA event is still pending; then one more reduction is bitwise
   the healthy one); which stores have ``list_keys`` and delete, and
   ``core.state.abort_group`` on a one-rank NCCL group;
   fault injection: phase 6b's fp16 burst clean, then under
   ``collective.pre:corrupt(nan)@count=K,times=1`` and
   ``corrupt(bitflip)``: one result differs from the clean composition,
   every result is the plain composition of its group over the
   poisoned input, 2 A1 launches a fused group, and the poisoning runs
   on the card under CUDA's sync-debug mode "error"; the dead-peer abort
   leaves a postmortem naming the op (the flight recorder writes into
   this run's temporary directory) and counts in the abort family;
   the observability planes: phase 3's training step in three modes in
   turns (every plane off; the reference's defaults: flight, stepprof,
   anomaly; defaults plus timeline and trace), each mode twice: the
   optimizer's reduction of one fixed backward bitwise across modes, 4
   A1 launches a step in each, the timeline's 161 gradient and 2 bucket
   spans a step, the trace merged by ``tools/hvtputrace``, images/s and
   the host µs of a hooked ``hvd.allreduce`` a mode, the host µs of one
   timeline event; ``GET /metrics`` and ``/debug`` on localhost (the op
   counters; the job, stall, flight, anomaly, stepprof and controller
   providers); stepprof's profile window over 3 steps (idle share within
   0.05 of the same trace read as ``torch_port_profile.py`` reads it,
   exposed comm, MFU from ``FlopCounterMode`` against the card's peak),
   its clock alignment held to a 20 ms sleep kernel within 2 ms; the
   async fp16 burst of 161 ``allreduce_async_`` with tracing on and off
   in turns, bitwise, every op's trace chain complete;
7. runs the ring collectives at full width: phase 3's batch as 8 virtual
   ranks of 8 images, each rank's 161 gradients packed (25.56 M float32),
   reduced on the card by ``ring_allreduce`` (A5 Sum and Average, A6
   quantized, all on the cluster kernels) and gathered by
   ``ring_allgather_2d`` (A4 on the cluster kernel, each rank's 1/8):
   one launch a call, outputs identical on every rank and bitwise the
   plain versions, A5 within ``n * 2^-23 * sum|x|`` of the float64 sum,
   A6 within ``2(n-1) * max sum|x| / 127``, A4 bitwise ``torch.cat``;
   then rings of 2 and 3 ranks, and of 3 ranks of NaN/inf/subnormal
   values, bitwise the plain versions; a ring of 12 ranks of 1,000,003
   elements on the global-slot A4/A5/A6 kernels, its own path, with the
   same checks; timing against the plain versions and the library calls
   that fill one output and every rank's (the 12-rank kernels at half a
   bucket a rank, and a call's time at 1,000,003), and the last timed
   call checked again;
   then the rings with one rank a process (``--ring-ipc-child``): 2,
   then 3 processes on cuda:0 in a gloo group over a ``TCPStore`` on
   localhost, each rank's ``ProcessRing`` (its slots and flags a
   ``cudaMalloc`` of its own, its neighbours' mapped through CUDA IPC
   handles, epoch flags at system scope) running A5 Sum and Average,
   A6 and A4 three times each in a row on new inputs with no host
   barrier in between, at 2 x 25,557,032 (the packed ResNet-50
   gradients a rank) and at 2 and 3 x 1,000,003, every result bitwise
   the plain version over every rank's inputs, then
   ``quantized_allreduce`` and ``spmd.allreduce(compression=int8)`` along
   the axis of a ``DeviceMesh`` over the children's gloo world, both
   under ``HVTPU_QUANTIZED_RING=1`` and bitwise the plain A6; the
   launches counted in each child (A5 7, A6 5, A4 3 a size; one A6 the
   spmd call); the times are time-sliced unless an MPS daemon serves the
   card;
8. checks a narrow float32 ResNet trained 2 steps on the card against the
   same steps computed on the CPU with plain PyTorch;
9. drives the elastic path in child processes (``chip_smoke.py
   --elastic-child``), each started by the port's launcher and
   rendezvoused on its coordinator (their env names no
   ``MASTER_ADDR``): the training of phase 3 at full width (ResNet-50
   bf16 NHWC 224x224, batch 64, the same optimizer) under
   ``hvd.elastic.run`` with ``TorchState(model, optimizer,
   data=loader.state)`` over an ``ElasticDataLoader`` of 512 float32
   images from seed 0 (8 steps an epoch), 2 epochs, a commit a step,
   deterministic cuDNN and ``torch.use_deterministic_algorithms``: once
   uninterrupted (a static ``-np 1`` launch), then incarnations 0-3 on
   one state dir (``HVTPU_CKPT_KEEP=2``) under one elastic driver
   (``--host-discovery-script`` printing ``localhost:1``, a 0.1 s poll),
   each incarnation picking its interruption by
   ``HVTPU_ELASTIC_GENERATION``: a ``worker.step`` kill
   at the 4th commit (exit 1), SIGUSR1 after 6 commits so the next
   commit raises ``HostsUpdatedInterrupt`` (exit 73), a preemption
   notice by SIGTERM, which the child sends itself before its first
   step, drained at the next commit but one (exit 79), and the rest
   (exit 0); the driver relaunches after each, charges the restart
   budget for the kill only, and exits 0.  Gates: the driver's outcomes
   and charge, the final model and optimizer state bitwise the
   uninterrupted run's, the committed steps' samples each epoch's
   permutation once, every incarnation starting at the last verified
   commit (so the drain loses no step), every snapshot on disk
   verifying within the retention, 4 A1 launches every step of every
   child, every batch on the card;
10. drives the fleet (``python -m horovod_tpu_torch.fleet``): ``submit``
   ``lo`` (priority 0) and ``hi`` (priority 10), each a job of one rank
   running ``--elastic-child`` as the uninterrupted run (its own
   ``HVT_LOG`` and ``HVT_OUT``, the runner's job-scoped state dir,
   ``HVTPU_HEALTH_INTERVAL_S=1``), then ``serve --until-idle`` over a
   discovery script printing ``localhost:1``: the arbiter's
   ``ElasticJobRunner`` starts each under the port's elastic driver on
   cuda:0.  Gates: hi starts first and lo waits PENDING while hi runs
   (``state.json``), both end DONE with no charged restart, serve exits 0,
   each job's final model and momentum bitwise the elastic phase's
   uninterrupted run, 4 A1 launches every step, every batch on the card,
   and each job's health rollup in ``state.json`` from rank 0's
   ``HealthReporter`` (steps > 0, generation 0, no incident).  Then a job
   ``gone`` under a serve of its own (2 s of sleep after each commit, so
   that the cancel lands mid-run), and ``cancel gone`` once it has 2
   verified commits: its worker drains at a commit (exit 79, the driver's
   ``term``), the job ends FAILED ``cancelled`` with no charged restart
   (serve exits 1 naming it).  Then the planned shrink past one rank on
   CPU workers (``tests/torch_port_fleet_data_script.py``, gloo; NCCL takes
   one rank of a communicator a card), a ``FleetArbiter`` over
   ``localhost:4`` in this process: ``lo`` at 2-4 ranks holds the pool,
   ``hi`` at 2 (priority 10) arrives once lo delivered a batch, lo's ranks
   2 and 3 are drained through their notice files (exit 79) and lo
   relaunches at 2; both ``max_restarts=0``, both DONE, no charged
   restart, every sample of every epoch delivered exactly once.
11. drives the Spark estimator (``horovod_tpu_torch.spark``): a dict
   frame of 160 seeded 224x224x3 float32 images and labels, no pandas,
   through ``TorchEstimator`` on ResNet-50 (float32, 1000 classes, SGD
   0.01 momentum 0.9, ``gradient_compression="fp16"``, batch 32, 2
   epochs, ``validation=0.25``, seed 7) with ``LocalBackend(num_proc=1)``,
   the port's default device: its worker trains on cuda:0 beside this
   process's own world; the loss is ``nn.CrossEntropyLoss()``'s function
   noting the first step's time, and a metric reads A1's launches in the
   worker at each epoch's end (both module-level functions of this file,
   pickled by reference).  Gates: ``loss`` and ``val_loss`` finite for
   both epochs, 4 A1 launches a step, ``checkpoint.pt`` in the Store with
   CPU tensors only, the trained module back on cuda:0 and
   ``TorchModel.transform`` bitwise its own forward there at the same
   batching (deterministic cuDNN); then ``spark.run`` and
   ``RayExecutor(num_workers=1, use_gpu=True)`` (local mode, no Ray
   cluster) run a probe that allreduces a tensor on its rank's device:
   both on cuda:0.  Where keras and tensorflow import, a seeded keras MLP
   also fits through ``KerasEstimator`` at one rank.
12. the TensorFlow and Keras frontends (``horovod_tpu_torch.tensorflow``,
   ``.keras``), where ``tensorflow`` and ``keras`` are both
   installed: a seeded tf.keras MLP trained ``FRONTEND_STEPS`` steps
   through the port's keras ``DistributedOptimizer`` (SGD momentum 0.9,
   ``gradient_predivide_factor=2.0``) with the port on cuda:0, every
   gradient the bridge hands to the engine on cuda:0 (counted by
   ``tensorflow.mpi_ops.bridged``), then the same steps with the port
   re-initialized on the CPU (``init(device="cpu")``, the world the
   smoke ends in): the weights bitwise equal.  Without either module the
   phase only prints what it found.

Prints one ``sim {...}`` line (each scenario's wall seconds, events,
virtual seconds, digest match and A1 launches, the card's name and
power limit), one ``int8_quantized_allreduce {...}`` line, one ``async_path
{...}`` line (its ``cores`` part the bursts on each negotiation core,
its ``autotune`` part the tuned bursts, its ``zero_copy`` part the
route's bursts), one ``adasum
{...}`` line, one ``spmd {...}`` line (the functions held, the gradient
paths' host ms, the sharded optimizer's state bytes and ms a step,
``SyncBatchNorm``'s errors and ms, the card's name and power limit),
one ``transformer {...}`` line (the step's ms, tokens/s, FLOPs and their
share of the card's peak, peak memory and the losses; each other mode's
loss, ms and peak memory; the card-against-CPU errors), one ``models
{...}`` line (each trio model's step ms, images/s, FLOPs, FLOP share,
peak memory, buckets, A1 launches and losses; the small models' steps;
remat's turns; the card-against-CPU errors), one ``sharded_ckpt {...}``
line (commit, verify, sync, save and restore ms and bytes; each child's
files and bytes),
one ``stall {...}`` line, one ``faults {...}`` line, one
``obs {...}`` line, one ``ring_path {...}`` line, one ``ring_ipc {...}``
line (the launches, each rank's ms a call, B, the bytes a rank holds
and maps, the epochs, the slice policy), one ``elastic {...}``
line (the exits, the commits' ms in memory, on the training thread and
on the writer, a snapshot's bytes, ``sync``'s ms, each child's seconds
to its first step), one ``fleet {...}`` line (each card job's wall
seconds, queue wait, seconds from spawn to first step, images/s over its
steps after 2 and A1 launches, beside the elastic phase's uninterrupted
run's images/s; the cancel's seconds to the worker's exit; the shrink's
seconds from hi's submit to lo's relaunch at 2), one ``launcher {...}`` line (the ``--check-build``
flags, the worker's ``HVTPU_AUTOTUNE*`` env, the static launch's rendezvous seconds, each relaunch's seconds
from the driver seeing the exit to the next incarnation's first step,
the driver's exits, outcomes and charged restarts, the negative gate),
one ``spark {...}`` line (the card, the rows and npz bytes, the fit's
wall seconds and its seconds to the worker's first step, the history,
transform's ms, A1 a step, the devices of the worker, ``spark.run`` and
``RayExecutor``, ``find_spec`` of cloudpickle, pandas, pyspark, ray,
keras and tensorflow, the pickler, ``keras_estimator`` "ran" or null),
one ``frontends {...}`` line (``{"tensorflow": null, "keras": null,
"ran": false}`` with the versions found when either module is missing;
else the steps, the bridged tensors by device, the weights' match and
the phase's seconds),
one ``{"kernels": [...]}`` line of 13 entries (the last three the
ring kernels with one rank a process, ``time_sliced`` beside their ms,
A6's with ``spmd_launches``)
(A1's with ``core_launches``, ``autotune_launches``,
``stall_launches``, ``obs_launches_per_step``,
``models_launches_per_step``,
``elastic_launches`` and ``launcher_launches``, the last by the
launcher's entry point, ``fleet_launches`` and
``spark_launches_per_step``) and, last,
``{"ok": true,
"device": {...}}``.  Exits non-zero, printing no result, when CUDA is
absent, when the package is not beside this script, or when any phase
fails.  Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet: HBM3 rate and the float32 rate outside the
# tensor cores (the kernel multiplies in float32 on the CUDA cores)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

SEED = 0
BATCH = 64
IMAGE = 224
WARMUP_STEPS = 2
TIMED_STEPS = 5
PREDIVIDE = 2.0
RESNET50_GRADS = 161
LENGTHS = [1, 127, 1024, 1025, 2 ** 20 + 3]
# the int8 kernels' layout: a warp a 1024-element block, 16-byte words
# of 4 float32 or 8 16-bit elements, word w on lane w % 32
INT8_LENGTHS = [1, 8, 9, 128, 511, 512, 1023, 1024, 1025, 1032, 2047,
                2 ** 20 + 3]
FLT_MIN = 2.0 ** -126
# stochastic rounding over the 25.56 M buffer: |mean((x_hat - x) /
# scale)|, and the share of codes moved off rint against its expectation;
# each term is independent given the data and spans at most 1, so either
# mean's standard deviation is below 0.5 / sqrt(25.56e6) = 1e-4
UNBIASED_BOUND = 1e-3
RING_RANKS = 8            # phase 3's batch of 64 as 8 ranks of 8 images
RING_SMALL = 1_000_003    # elements a rank of the 2-, 3- and 12-rank rings
RING_WIDE = 12            # ranks of the ring past a cluster's 8 CTAs


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(msg: str) -> None:
    print(msg, flush=True)


def _bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nvidia_smi_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]


def time_cuda(fn, reps: int, warmup: int = 3) -> float:
    """Mean ms of ``fn()`` over ``reps`` calls, by CUDA events."""
    import torch

    for _ in range(warmup):
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


def spread_values(n: int, dtype, device, gen):
    """float32 values over 12 decades, cast to ``dtype``: the narrow
    outputs see overflow, subnormals and ties."""
    import torch

    mag = 10.0 ** (torch.rand(n, generator=gen, device=device) * 12 - 8)
    return (torch.randn(n, generator=gen, device=device) * mag).to(dtype)


def resnet50_grad_shapes():
    from horovod_tpu_torch.models import ResNet50

    model = ResNet50(device="meta")
    return [tuple(p.shape) for p in model.parameters()]


# -- phase 2: kernel A1 against its plain versions ----------------------------

def special_values(dtype, device):
    """NaN, +-inf, +-0, float32/bfloat16/float16 subnormals, the edges of
    float16's range and ties of the narrow roundings, in ``dtype``."""
    import torch

    vals = [math.nan, math.inf, -math.inf, 0.0, -0.0, 1e-40, -3e-39,
            FLT_MIN, 6e-8, -3e-5, 65504.0, 65520.0, -7e4, 3.0e38, 1e-38,
            1.0 + 2.0 ** -8, 1.0 + 2.0 ** -11, -(1.0 + 3 * 2.0 ** -9)]
    return torch.tensor(vals, dtype=torch.float32, device=device).to(dtype)


def _group_compare(tensors, scale: float, codec, what: str, outs=None):
    """``scale_cast_pack`` and ``unpack_cast_scale`` (into ``outs`` when
    given) bitwise their plain versions on one group; the unpack reads
    the packed buffer back, then a flat buffer of new values.  Returns
    the largest difference (0.0)."""
    import torch

    from horovod_tpu_torch.comm.compression import Compression
    from horovod_tpu_torch.ops import (
        scale_cast_pack,
        scale_cast_pack_plain,
        unpack_cast_scale,
        unpack_cast_scale_plain,
    )

    flat, specs = scale_cast_pack(tensors, scale, codec)
    pflat, pspecs = scale_cast_pack_plain(tensors, scale, codec)
    check(specs == pspecs, f"scale_cast_pack {what}: specs")
    check(same_bits(flat, pflat), f"scale_cast_pack {what}: differs from "
          "the plain version")
    err = max_abs_diff(flat, pflat)
    gen = torch.Generator(device=flat.device).manual_seed(SEED + 5)
    # the contexts the codec's compress returns: None under none
    ctxs = [None if codec is Compression.none else t.dtype for t in tensors]
    for reduced in (flat, wide_values(flat.numel(), flat.dtype, flat.device,
                                      gen)):
        got = unpack_cast_scale(reduced, specs, ctxs, 1.0 / scale, outs)
        want = unpack_cast_scale_plain(reduced, specs, ctxs, 1.0 / scale)
        check(outs is None or all(g is o for g, o in zip(got, outs)),
              f"unpack_cast_scale {what}: did not write into outs")
        for i, (g, w) in enumerate(zip(got, want)):
            check(same_bits(g, w), f"unpack_cast_scale {what}: tensor {i} "
                  "differs from the plain version")
            err = max(err, max_abs_diff(g, w))
    return err


def _offset_views(tensors):
    """Each tensor again as a contiguous view one element into a larger
    buffer: a pointer 16-byte aligned in no dtype."""
    import torch

    out = []
    for t in tensors:
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        view = buf[1:].view(t.shape)
        out.append(view.copy_(t))
    return out


def grouped_checks(device, grad_shapes, gen):
    """The grouped passes bitwise their plain versions: returns (max
    difference, groups compared, launches of the group larger than one
    table)."""
    import torch

    from horovod_tpu_torch.comm.compression import Compression
    from horovod_tpu_torch.ops import fused_scale_cast
    from horovod_tpu_torch.ops.scale_cast import max_entries

    dtypes = [torch.float32, torch.bfloat16, torch.float16]
    err, groups = 0.0, 0

    # the main path: 161 float32 gradients, prescale 1/2 into the fp16
    # wire, postscale 2 back into float32 (spread and 50-decade values);
    # and the optimizer's default (Average, no predivide): scale 1 both
    # ways
    for values in (spread_values, wide_values):
        grads = [values(math.prod(s), torch.float32, device, gen).view(s)
                 for s in grad_shapes]
        outs = [torch.empty_like(g) for g in grads]
        for scale in (1.0 / PREDIVIDE, 1.0):
            err = max(err, _group_compare(grads, scale, Compression.fp16,
                                          f"ResNet-50 scale {scale}", outs))
            groups += 1

    # every (in, out) pair with each own dtype: a group of all three
    # dtypes under the none (flat float32), bf16 and fp16 wires; sizes
    # that put pieces at odd offsets, a zero-length entry, the special
    # values; then every tensor and out one element off alignment
    for codec in (Compression.none, Compression.bf16, Compression.fp16):
        group = []
        for n in LENGTHS:
            group += [spread_values(n, dt, device, gen) for dt in dtypes]
        group.insert(4, torch.empty(0, device=device))
        group += [special_values(dt, device) for dt in dtypes]
        for scale in (0.5, 2.0, 1.0 / 3.0, 1.0):
            what = f"{codec.__name__} scale {scale}"
            err = max(err, _group_compare(group, scale, codec, what))
            err = max(err, _group_compare(
                _offset_views(group), scale, codec, f"{what} offset 1",
                _offset_views([torch.empty_like(t) for t in group])))
            groups += 2

    # a group larger than one table: several launches, each counted
    m = max_entries()
    many = [spread_values(i % 7 + 1, dtypes[i % 3], device, gen)
            for i in range(m + 5)]
    before = fused_scale_cast.launches
    err = max(err, _group_compare(many, 0.5, Compression.none,
                                  f"{m + 5} tensors"))
    launches = fused_scale_cast.launches - before
    # one pack and two unpacks, each a launch a table
    check(launches == 3 * -(-len(many) // m),
          f"a group of {len(many)} tensors took {launches} launches, "
          f"{m} a table")
    torch.cuda.synchronize()
    return err, groups + 1, dict(tensors=len(many), max_entries=m,
                                 launches=launches)


def kernel_phase(device, grad_shapes, big_n: int, reps: int):
    import torch

    from horovod_tpu_torch.comm.compression import Compression
    from horovod_tpu_torch.comm.packing import pack_flat, unpack_flat
    from horovod_tpu_torch.ops import (
        fused_scale_cast,
        fused_scale_cast_plain,
        scale_cast_pack,
        scale_cast_pack_plain,
        unpack_cast_scale,
        unpack_cast_scale_plain,
    )

    dtypes = [torch.float32, torch.bfloat16, torch.float16]
    scales = [0.5, 2.0, 1.0 / 3.0]
    gen = torch.Generator(device=device).manual_seed(SEED)
    max_err = 0.0
    compared = 0

    def compare(x, scale, out_dtype, what):
        nonlocal max_err, compared
        got = fused_scale_cast(x, scale, out_dtype)
        want = fused_scale_cast_plain(x, scale, out_dtype)
        check(got.dtype == out_dtype and got.shape == x.shape,
              f"fused_scale_cast {what}: dtype/shape")
        check(torch.equal(got, want), f"fused_scale_cast {what}: differs "
              "from the plain version")
        both = torch.isfinite(got) & torch.isfinite(want)
        if both.any():
            err = (got[both].double() - want[both].double()).abs().max()
            max_err = max(max_err, float(err))
        compared += 1

    for in_dt in dtypes:
        for out_dt in dtypes:
            for n in LENGTHS:
                x = spread_values(n + 1, in_dt, device, gen)
                for scale in scales:
                    # offset 0: 16-byte aligned, vector loop; offset 1:
                    # unaligned view, scalar head and tail
                    compare(x[:n], scale, out_dt, f"{in_dt}->{out_dt} n={n}")
                    compare(x[1:], scale, out_dt,
                            f"{in_dt}->{out_dt} n={n} unaligned")
            for shape in grad_shapes:
                n = math.prod(shape)
                x = spread_values(n, in_dt, device, gen)
                for scale in scales:
                    compare(x, scale, out_dt, f"{in_dt}->{out_dt} {shape}")
    torch.cuda.synchronize()
    log(f"kernel: fused_scale_cast bitwise equal to the plain version in "
        f"{compared} comparisons (9 dtype pairs, lengths {LENGTHS}, "
        f"{len(grad_shapes)} ResNet-50 gradient shapes, scales {scales})")
    g_err, groups, many = grouped_checks(device, grad_shapes, gen)
    max_err = max(max_err, g_err)
    log(f"kernel: scale_cast_pack and unpack_cast_scale bitwise equal to "
        f"the plain versions over {groups} groups (the 161 ResNet-50 "
        f"gradients at scales 1/2 and 1, 9 (in, out) pairs x 3 own dtypes "
        f"x 4 scales, offset 1, a zero-length entry, NaN/inf/subnormal/-0); "
        f"{many}")

    # Timing 1: the two passes over the main path's shapes (161 float32
    # gradients, prescale 1/2 into the fp16 wire, postscale 2 back), as
    # the optimizer issues them, against the per-tensor composition they
    # replace (kernel per tensor, codec, pack / unpack, codec, kernel per
    # tensor and the copy into the gradient).
    launches_before = fused_scale_cast.launches
    grads = [torch.randn(s, generator=gen, device=device) for s in grad_shapes]
    flats = [g.reshape(-1) for g in grads]
    outs = [torch.empty_like(g) for g in grads]
    total = sum(f.numel() for f in flats)
    pre, post, codec = 1.0 / PREDIVIDE, PREDIVIDE, Compression.fp16
    flat, specs = scale_cast_pack(grads, pre, codec)
    ctxs = [torch.float32] * len(grads)

    def per_tensor_pre():
        wires = [codec.compress(fused_scale_cast(f, pre).reshape(g.shape))[0]
                 for f, g in zip(flats, grads)]
        return pack_flat(wires)

    def per_tensor_post():
        for piece, ctx, o in zip(unpack_flat(flat, specs), ctxs, outs):
            g = codec.decompress(piece, ctx)
            o.copy_(fused_scale_cast(g.reshape(-1), post).reshape(g.shape))

    bound_ms, bound_by = _bound_ms(total * (4 + 2), total)
    passes = {}
    for name, fn, plain, library, per_tensor in (
            ("pre", lambda: scale_cast_pack(grads, pre, codec),
             lambda: scale_cast_pack_plain(grads, pre, codec),
             lambda: torch._foreach_mul(flats, pre), per_tensor_pre),
            ("post", lambda: unpack_cast_scale(flat, specs, ctxs, post, outs),
             lambda: unpack_cast_scale_plain(flat, specs, ctxs, post, outs),
             lambda: torch._foreach_mul(outs, post), per_tensor_post)):
        passes[name] = dict(
            elements=total, tensors=len(grads), ms=time_cuda(fn, reps),
            plain_ms=time_cuda(plain, reps), bound_ms=bound_ms,
            bound_by=bound_by, library_ms=time_cuda(library, reps),
            per_tensor_ms=time_cuda(per_tensor, reps))
        log(f"kernel_path_pass {name} " + json.dumps(passes[name]))
    # the last timed calls, checked again
    check(same_bits(scale_cast_pack(grads, pre, codec)[0],
                    per_tensor_pre()[0]), "the pre pass after timing is "
          "not the per-tensor composition")
    unpack_cast_scale(flat, specs, ctxs, post, outs)
    got = [o.clone() for o in outs]
    per_tensor_post()
    check(all(same_bits(g, o) for g, o in zip(got, outs)),
          "the post pass after timing is not the per-tensor composition")
    del flat, outs, got

    # Timing 2: one buffer of every ResNet-50 gradient (25.56 M elements),
    # the bandwidth-bound case, through the table of one entry.
    big = torch.randn(big_n, generator=gen, device=device)
    rows = []
    for out_dt in (torch.float32, torch.bfloat16):
        out = torch.empty(big_n, dtype=out_dt, device=device)
        k_ms = time_cuda(lambda: fused_scale_cast(big, pre, out_dt), reps)
        p_ms = time_cuda(lambda: fused_scale_cast_plain(big, pre, out_dt),
                         reps)
        l_ms = time_cuda(lambda: torch.mul(big, pre, out=out), reps)
        b_ms, b_by = _bound_ms(big_n * (4 + out.element_size()), big_n)
        rows.append(dict(n=big_n, out=str(out_dt).replace("torch.", ""),
                         ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                         bound_ms=b_ms, bound_by=b_by))
        log("kernel_big_buffer " + json.dumps(rows[-1]))
    fused_scale_cast.launches = launches_before  # timing launches not counted
    return dict(max_abs_err=max_err, compared=compared, groups=groups,
                many=many, passes=passes, big_buffer=rows)


# -- phase 3: the training path -----------------------------------------------

def make_optimizer(hvd, model, compression):
    import torch

    return hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
        named_parameters=model.named_parameters(),
        compression=compression,
        gradient_predivide_factor=PREDIVIDE)


def train_phase(hvd, device, batch: int, image: int, stage_sizes):
    import torch
    import torch.nn.functional as F

    from horovod_tpu_torch.models import ResNet
    from horovod_tpu_torch.ops import fused_scale_cast

    gen = torch.Generator().manual_seed(SEED)
    model = ResNet(stage_sizes, dtype=torch.bfloat16, device=device,
                   generator=gen)
    n_grads = sum(1 for p in model.parameters() if p.requires_grad)
    dgen = torch.Generator(device=device).manual_seed(SEED)
    x = torch.randn(batch, image, image, 3, generator=dgen, device=device)
    y = torch.randint(0, 1000, (batch,), generator=dgen, device=device)
    opt = make_optimizer(hvd, model, hvd.Compression.fp16)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    # one pre and one post pass of A1 a multi-tensor bucket; a bucket of
    # one tensor goes through comm/eager.allreduce
    multi = sum(len(b) > 1 for b in opt.buckets)

    losses, step_s = [], []
    fused_scale_cast.launches = 0      # the main path's run starts here
    for step in range(WARMUP_STEPS + TIMED_STEPS):
        before = fused_scale_cast.launches
        t0 = time.perf_counter()
        opt.zero_grad()
        loss = F.cross_entropy(model(x), y)
        loss.backward()
        opt.step()
        torch.cuda.synchronize(device)
        step_s.append(time.perf_counter() - t0)
        losses.append(float(loss.detach()))
        delta = fused_scale_cast.launches - before
        check(delta == 2 * multi,
              f"step {step}: {delta} fused_scale_cast launches, expected "
              f"{2 * multi}")
        check(math.isfinite(losses[-1]), f"step {step}: loss {losses[-1]}")
    launches = fused_scale_cast.launches  # read just after the main path
    timed = step_s[WARMUP_STEPS:]

    # the same step with the group reduction tensor by tensor (as before
    # the grouped passes), in turns with the grouped one: 1 warm-up and
    # TIMED_STEPS timed steps a turn; launches not counted
    def turn(reduction):
        opt.reduction = reduction
        secs = []
        for _ in range(1 + TIMED_STEPS):
            t0 = time.perf_counter()
            opt.zero_grad()
            F.cross_entropy(model(x), y).backward()
            opt.step()
            torch.cuda.synchronize(device)
            secs.append(time.perf_counter() - t0)
        return batch * TIMED_STEPS / sum(secs[1:])

    grouped, per_tensor = opt.reduction, per_tensor_reduction(opt.reduction)
    turns = {"per_tensor": [], "grouped": []}
    for name, reduction in (("per_tensor", per_tensor), ("grouped", grouped),
                            ("grouped", grouped), ("per_tensor", per_tensor)):
        turns[name].append(turn(reduction))
    opt.reduction = grouped
    fused_scale_cast.launches = launches
    result = dict(
        batch=batch, image=image, grads=n_grads, losses=losses,
        step_ms=[t * 1e3 for t in step_s],
        images_per_s=batch * len(timed) / sum(timed),
        images_per_s_turns=turns,
        launches=launches, launches_per_step=launches // len(step_s),
        buckets=len(opt.buckets), multi_tensor_buckets=multi,
        peak_mem_gib=torch.cuda.max_memory_allocated(device) / 2 ** 30)
    log("train " + json.dumps(result))
    return model, opt, x, y, result


# -- phase 4: the group reduction with the kernel and with the plain version --

def per_tensor_reduction(reduction):
    """``reduction`` with the grouped passes turned off: every group takes
    the reference's steps tensor by tensor (``fused_scale_cast`` a
    tensor), as the optimizer did before the grouped passes."""
    from horovod_tpu_torch.torch.optimizer import GroupReduction

    @dataclasses.dataclass(frozen=True)
    class PerTensor(GroupReduction):
        def grouped(self, tensors) -> bool:
            return False

    fields = {f.name: getattr(reduction, f.name)
              for f in dataclasses.fields(reduction)}
    return PerTensor(**fields)


def parity_phase(model, opt, x, y, reps: int):
    """The optimizer's group reduction over one batch's real buckets,
    kernel against plain, bitwise, then timed grouped and tensor by
    tensor: in the main path's configuration (predivide 2: prescale
    1/2, postscale 1/2 for one rank) and in the optimizer's default
    (Average, no predivide: both scales 1)."""
    import torch
    import torch.nn.functional as F

    from horovod_tpu_torch.comm.reduce_ops import ReduceOp
    from horovod_tpu_torch.ops import (
        fused_scale_cast,
        fused_scale_cast_plain,
        scale_cast_pack,
        scale_cast_pack_plain,
        unpack_cast_scale,
        unpack_cast_scale_plain,
    )

    params = [p for p in model.parameters() if p.requires_grad]
    loss = F.cross_entropy(model(x), y)
    # autograd.grad leaves .grad alone, so the optimizer's hooks stay
    # quiet; its results keep the layout the backward gave them, so they
    # are made contiguous, as AccumulateGrad lays out p.grad
    grads = {p: g.contiguous()
             for p, g in zip(params, torch.autograd.grad(loss, params))}
    red = opt.reduction
    check(red.pack is scale_cast_pack and red.unpack is unpack_cast_scale
          and red.scale is fused_scale_cast,
          "the optimizer's reduction does not use the kernel")
    # {name: (reduction, prefix of its timing keys)}
    configs = {"predivide": (red, ""), "default": (dataclasses.replace(
        red, op=ReduceOp.AVERAGE, prescale=1.0, postscale=1.0), "default_")}
    launches_before = fused_scale_cast.launches
    buckets = [[grads[p] for p in bucket] for bucket in opt.buckets]
    multi = sum(len(b) > 1 for b in buckets)
    n = 0
    for name, (cfg, _) in configs.items():
        plain = dataclasses.replace(cfg, scale=fused_scale_cast_plain,
                                    pack=scale_cast_pack_plain,
                                    unpack=unpack_cast_scale_plain)
        before = fused_scale_cast.launches
        for bucket_grads in buckets:
            got = cfg.reduce(bucket_grads)
            want = plain.reduce(bucket_grads)
            for g, w in zip(got, want):
                check(torch.equal(g, w), f"group reduction {name}: kernel "
                      "and plain versions differ")
                n += 1
        check(fused_scale_cast.launches - before == 2 * multi,
              f"the group reduction {name} did not launch the kernel once a "
              "direction a multi-tensor bucket")
    torch.cuda.synchronize()
    log(f"parity: {n} reduced gradients bitwise equal, kernel vs plain, "
        f"over {len(opt.buckets)} buckets, predivide {PREDIVIDE} and the "
        "default configuration")

    # the optimizer's reduction over the real buckets, launch + finish
    # into the gradients, grouped and tensor by tensor (one rank: NCCL
    # moves nothing; host-bound, so the events read the host's time)
    outs = [[torch.empty_like(g) for g in b] for b in buckets]

    def reduce_all(reduction):
        def run():
            for b, o in zip(buckets, outs):
                reduction.finish(reduction.launch(b), o)
        return run

    timing = {}
    for name, (cfg, key) in configs.items():
        per_tensor = per_tensor_reduction(cfg)
        timing[f"{key}group_reduce_ms"] = time_cuda(reduce_all(cfg), reps)
        timing[f"{key}per_tensor_reduce_ms"] = time_cuda(
            reduce_all(per_tensor), reps)
        by_tensor = [o.clone() for b in outs for o in b]  # last timed run
        reduce_all(cfg)()
        check(all(same_bits(w, o) for w, o in zip(
            by_tensor, [o for b in outs for o in b])),
            f"the grouped reduction {name} after timing is not the "
            "per-tensor one")
    fused_scale_cast.launches = launches_before
    log("reduction " + json.dumps(timing))
    return timing


# -- phase 5: kernels A2/A3 against their plain versions ----------------------

def same_bits(a, b) -> bool:
    """Equal dtype, shape and bits, with any NaN equal to any NaN (the
    kernel and PyTorch narrow a NaN to other bits)."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    na, nb = torch.isnan(a), torch.isnan(b)
    if not torch.equal(na, nb):
        return False
    as_int = {4: torch.int32, 2: torch.int16}[a.element_size()]
    return torch.equal(a.view(as_int)[~na], b.view(as_int)[~na])


def max_abs_diff(a, b) -> float:
    import torch

    both = torch.isfinite(a) & torch.isfinite(b)
    if not both.any():
        return 0.0
    return float((a[both].double() - b[both].double()).abs().max())


def wide_values(n: int, dtype, device, gen):
    """float32 values over 50 decades, subnormals included, cast to
    ``dtype``."""
    import torch

    mag = 10.0 ** (torch.rand(n, generator=gen, device=device) * 50 - 40)
    return (torch.randn(n, generator=gen, device=device) * mag).to(dtype)


def special_blocks(device, gen):
    """Blocks of 1024 that the TPU's float32 semantics decide: NaN, inf,
    -inf, zero, a subnormal absmax, scale FLT_MIN with a subnormal
    element, a scale below FLT_MIN, and rounding ties, between ordinary
    blocks, then a ragged tail."""
    import torch

    rows = [
        [1.0, math.nan, 2.0, -3.0],
        [1.0, math.inf, 2.0],
        [1.0, -math.inf, 2.0],
        [],
        [3e-39, -2e-39, 1e-39],
        [FLT_MIN * 127.0, 1.1e-38, 1e-37],
        [1e-37, -5e-38],
        [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5],
    ]
    parts = []
    for vals in rows:
        parts.append(torch.randn(1024, generator=gen, device=device))
        block = torch.zeros(1024, device=device)
        block[:len(vals)] = torch.tensor(vals, dtype=torch.float32)
        parts.append(block)
    parts.append(torch.randn(700, generator=gen, device=device))
    return torch.cat(parts)


def _int8_bytes(n: int, in_size: int, out_size: int, quantize: bool):
    """Bytes the function must move: the input once, the output once.
    Quantize writes whole blocks of codes and one f32 scale a block;
    dequantize reads the n codes it needs and the scales."""
    blocks = -(-n // 1024)
    if quantize:
        return n * in_size + blocks * 1024 + 4 * blocks
    return n + 4 * blocks + n * out_size


def int8_kernel_phase(device, grad_shapes, big_n: int, reps: int):
    import torch

    from horovod_tpu_torch.ops import (
        dequantize_int8_blocks,
        dequantize_int8_blocks_plain,
        quantize_int8_blocks,
        quantize_int8_blocks_plain,
    )

    dtypes = [torch.float32, torch.bfloat16, torch.float16]
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    seed = torch.tensor(1234567, dtype=torch.int32, device=device)
    err = {"q": 0.0, "s": 0.0, "d": 0.0}
    compared = 0

    def compare(x, what):
        nonlocal compared
        for stochastic in (False, True):
            tag = f"{what} stochastic={stochastic}"
            q, s, n = quantize_int8_blocks(x, stochastic=stochastic,
                                           seed=seed)
            pq, ps, pn = quantize_int8_blocks_plain(x, stochastic=stochastic,
                                                    seed=seed)
            check(n == pn and torch.equal(q, pq), f"A2 codes {tag}")
            check(same_bits(s, ps), f"A2 scales {tag}")
            err["q"] = max(err["q"], max_abs_diff(q.float(), pq.float()))
            err["s"] = max(err["s"], max_abs_diff(s, ps))
            # the codes at an odd address too: A3's byte-by-byte loads
            odd = torch.empty(q.numel() + 1, dtype=torch.int8,
                              device=device)[1:]
            odd.copy_(q.reshape(-1))
            for out_dt in dtypes:
                dp = dequantize_int8_blocks_plain(q, s, n, out_dt)
                for codes in (q, odd.view(q.shape)):
                    d = dequantize_int8_blocks(codes, s, n, out_dt)
                    check(same_bits(d, dp), f"A3 -> {out_dt} {tag} codes "
                          f"at {codes.data_ptr() % 16} mod 16")
                    err["d"] = max(err["d"], max_abs_diff(d, dp))
            compared += 1

    for in_dt in dtypes:
        for n in INT8_LENGTHS:
            x = wide_values(n + 1, in_dt, device, gen)
            # offset 0: 16-byte aligned, vector loads; offset 1: scalar
            compare(x[:n], f"{in_dt} n={n}")
            compare(x[1:], f"{in_dt} n={n} offset 1")
        blocks = special_blocks(device, gen).to(in_dt)
        compare(blocks, f"{in_dt} special blocks")
        compare(blocks[1:], f"{in_dt} special blocks offset 1")
    for shape in grad_shapes:
        compare(wide_values(math.prod(shape), torch.float32, device, gen),
                f"gradient {shape}")
    # the main path's buffer: 24,958 blocks, more CTAs than an SM wave
    compare(wide_values(big_n, torch.float32, device, gen),
            f"buffer of {big_n}")
    torch.cuda.synchronize()
    log(f"int8 kernels: A2 (both modes) and A3 (3 output dtypes, codes "
        f"aligned and at an odd address) bitwise equal to the plain versions "
        f"in {compared} x 2 comparisons (inputs f32/bf16/f16, lengths "
        f"{INT8_LENGTHS} aligned and offset, the special blocks, "
        f"{len(grad_shapes)} ResNet-50 gradient shapes, one {big_n}-element "
        "buffer)")

    # Timing 1: one pass over the main path's shapes, as the int8 codec
    # issues it: 161 float32 gradients (ResNet-50's parameters are
    # float32), one launch each, A3 writing float32.
    grads = [torch.randn(s, generator=gen, device=device).reshape(-1)
             for s in grad_shapes]
    coded = [quantize_int8_blocks(g) for g in grads]
    before = (quantize_int8_blocks.launches, dequantize_int8_blocks.launches)

    def pass_of(fn):
        return lambda: [fn(g) for g in grads]

    def deq_pass(fn):
        return lambda: [fn(q, s, n, torch.float32) for q, s, n in coded]

    def library_deq_pass():
        # int8 x float32 promotes to float32: one call dequantizes a
        # block-padded tensor; the trim to n is a view
        return [torch.mul(q.view(-1, 1024), s) for q, s, _ in coded]

    for (q, s, n), lib in zip(coded, library_deq_pass()):
        check(same_bits(lib.reshape(-1)[:n],
                        dequantize_int8_blocks_plain(q, s, n)),
              "A3's library call computes another function")
    q_bytes = sum(_int8_bytes(g.numel(), 4, 0, True) for g in grads)
    d_bytes = sum(_int8_bytes(g.numel(), 0, 4, False) for g in grads)
    total = sum(g.numel() for g in grads)
    cases = (
        ("quantize_deterministic",
         pass_of(quantize_int8_blocks),
         pass_of(quantize_int8_blocks_plain), None, q_bytes, 4 * total),
        ("quantize_stochastic",
         pass_of(lambda g: quantize_int8_blocks(g, stochastic=True,
                                                seed=seed)),
         pass_of(lambda g: quantize_int8_blocks_plain(g, stochastic=True,
                                                      seed=seed)),
         None, q_bytes, 5 * total),
        ("dequantize", deq_pass(dequantize_int8_blocks),
         deq_pass(dequantize_int8_blocks_plain), library_deq_pass,
         d_bytes, total),
    )
    # the passes are host-bound, and the host's speed drifts: the kernels'
    # passes and the library's are timed in 4 turns, forwards and
    # backwards, and each reports the median
    timed = [(name, fn) for name, fn, *_ in cases] + [
        ("library", library_deq_pass)]
    turns = {}
    for order in (timed, timed[::-1]) * 2:
        for key, fn in order:
            turns.setdefault(key, []).append(time_cuda(fn, reps))
    path = {}
    for name, fn, plain, library, nbytes, flops in cases:
        b_ms, b_by = _bound_ms(nbytes, flops)
        lib = turns["library"] if library else None
        path[name] = dict(
            tensors=len(grads), elements=total,
            ms=statistics.median(turns[name]), ms_turns=turns[name],
            plain_ms=time_cuda(plain, max(2, reps // 4)),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=statistics.median(lib) if lib else None,
            library_ms_turns=lib)
        log(f"int8_path_pass {name} " + json.dumps(path[name]))

    # Timing 2: one buffer of every ResNet-50 gradient (25.56 M
    # elements), the bandwidth-bound case.
    big = {}
    for in_dt in (torch.float32, torch.bfloat16):
        x = torch.randn(big_n, generator=gen, device=device).to(in_dt)
        size = x.element_size()
        cases = [("quantize_deterministic",
                  lambda: quantize_int8_blocks(x),
                  lambda: quantize_int8_blocks_plain(x), None,
                  _int8_bytes(big_n, size, 0, True), 4 * big_n)]
        if in_dt == torch.float32:
            q, s, n = quantize_int8_blocks(x)
            cases += [
                ("quantize_stochastic",
                 lambda: quantize_int8_blocks(x, stochastic=True, seed=seed),
                 lambda: quantize_int8_blocks_plain(x, stochastic=True,
                                                    seed=seed), None,
                 _int8_bytes(big_n, 4, 0, True), 5 * big_n)]
            for out_dt in (torch.float32, torch.bfloat16):
                padded = torch.empty((s.shape[0], 1024), dtype=out_dt,
                                     device=device)
                torch.mul(q.view(-1, 1024), s, out=padded)
                check(same_bits(padded.reshape(-1)[:n],
                                dequantize_int8_blocks_plain(q, s, n, out_dt)),
                      f"A3's library call to {out_dt} computes another "
                      "function")
                cases.append((
                    f"dequantize_to_{str(out_dt)[6:]}",
                    lambda o=out_dt: dequantize_int8_blocks(q, s, n, o),
                    lambda o=out_dt: dequantize_int8_blocks_plain(q, s, n, o),
                    lambda p=padded: torch.mul(q.view(-1, 1024), s, out=p),
                    _int8_bytes(big_n, 0, padded.element_size(), False),
                    big_n))
        for name, fn, plain, library, nbytes, flops in cases:
            b_ms, b_by = _bound_ms(nbytes, flops)
            row = dict(n=big_n, input=str(in_dt)[6:], ms=time_cuda(fn, reps),
                       plain_ms=time_cuda(plain, max(2, reps // 4)),
                       bound_ms=b_ms, bound_by=b_by,
                       library_ms=(time_cuda(library, reps) if library
                                   else None))
            big[f"{name}_{row['input']}"] = row
            log(f"int8_big_buffer {name} " + json.dumps(row))
        del x
    quantize_int8_blocks.launches, dequantize_int8_blocks.launches = before
    return dict(compared=compared, err=err, path_pass=path, big_buffer=big)


# -- phase 6: the int8 path at full width ----------------------------------

def int8_path_phase(model, x, y):
    """One backward of the training phase's ResNet-50 (bfloat16 compute,
    float32 parameters, so float32 gradients), its gradients and their
    packed buffer through the engine's int8 codecs,
    then the world-of-one allreduce and the quantized allreduce."""
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F

    from horovod_tpu_torch.comm import eager, quantized
    from horovod_tpu_torch.comm.compression import Compression
    from horovod_tpu_torch.comm.packing import pack_flat
    from horovod_tpu_torch.ops import (
        dequantize_int8_blocks,
        dequantize_int8_blocks_plain,
        quantize_int8_blocks,
    )

    params = [p for p in model.parameters() if p.requires_grad]
    loss = F.cross_entropy(model(x), y)
    grads = list(torch.autograd.grad(loss, params))
    bucket, _ = pack_flat(grads)
    tensors = grads + [bucket]

    quantize_int8_blocks.launches = 0      # the int8 path's run starts here
    dequantize_int8_blocks.launches = 0
    runs, launches = {}, {}
    for mode, codec in (("deterministic", Compression.int8),
                        ("stochastic", Compression.int8_stochastic)):
        before = quantize_int8_blocks.launches
        runs[mode] = []
        for t in tensors:
            wire, ctx = codec.compress(t)
            runs[mode].append((wire, ctx, codec.decompress(wire, ctx)))
        launches[mode] = quantize_int8_blocks.launches - before
    torch.cuda.synchronize()
    a2, a3 = quantize_int8_blocks.launches, dequantize_int8_blocks.launches
    per_codec = len(tensors)
    check(launches == {"deterministic": per_codec, "stochastic": per_codec}
          and a3 == 2 * per_codec,
          f"int8 path: {launches} A2 and {a3} A3 launches, expected "
          f"{per_codec} of each a codec")

    worst = {"deterministic": 0.0, "stochastic": 0.0}
    for i, t in enumerate(tensors):
        x32 = t.float().reshape(-1)
        (dw, dctx, dback), (sw, sctx, sback) = (runs["deterministic"][i],
                                                runs["stochastic"][i])
        check(int((sw.int() - dw.int()).abs().max()) <= 1,
              f"tensor {i}: stochastic codes more than 1 from deterministic")
        for mode, wire, ctx, back, slack in (
                ("deterministic", dw, dctx, dback, 0.5),
                ("stochastic", sw, sctx, sback, 1.0)):
            _, shape, n, scale = ctx
            deq = dequantize_int8_blocks_plain(wire.reshape(-1, 128), scale,
                                               n)
            check(back.dtype == t.dtype and tuple(back.shape) == shape,
                  f"tensor {i} {mode}: dtype/shape")
            check(same_bits(back.reshape(-1), deq.to(t.dtype)),
                  f"tensor {i} {mode}: decompress is not the cast of q*s")
            per_elem = scale.reshape(-1).repeat_interleave(1024)[:n]
            # float32 rounding of x*inv and q*s adds < 3e-5 scale;
            # a flushed subnormal adds < FLT_MIN
            excess = ((deq - x32).abs()
                      - (per_elem * slack * (1 + 1e-4) + FLT_MIN))
            check(float(excess.max()) <= 0.0,
                  f"tensor {i} {mode}: error beyond {slack} scale")
            rel = ((deq - x32).abs() / per_elem.clamp_min(FLT_MIN)).max()
            worst[mode] = max(worst[mode], float(rel))
            if i == len(tensors) - 1:
                pos = per_elem > 0
                bias = float(((deq - x32)[pos] / per_elem[pos])
                             .double().mean())
                if mode == "stochastic":
                    check(abs(bias) <= UNBIASED_BOUND,
                          f"stochastic rounding biased: {bias}")
                    # deterministic rounding passes the checks above too;
                    # a dither moves an element off rint(t) with
                    # probability |t - rint(t)|, t = x / scale
                    t = x32[pos] / per_elem[pos]
                    expected = float((t - t.round()).abs().double().mean())
                    moved = float((sw.reshape(-1)[:n][pos]
                                   != dw.reshape(-1)[:n][pos])
                                  .double().mean())
                    check(expected > 10 * UNBIASED_BOUND
                          and abs(moved - expected) <= UNBIASED_BOUND,
                          f"stochastic codes differ from deterministic in "
                          f"{moved} of the elements, expected {expected}")
                    worst["dithered_share"] = [moved, expected]
                worst[f"bias_{mode}"] = bias
    check(worst["stochastic"] > 0.5 + 1e-3,
          f"stochastic error never exceeds 0.5 scale ({worst['stochastic']})")

    # world of one: no wire compression, one multiply by pre * post
    before = quantize_int8_blocks.launches
    got = eager.allreduce(bucket, compression=Compression.int8,
                          prescale_factor=0.5, postscale_factor=3.0)
    check(quantize_int8_blocks.launches == before,
          "allreduce at world size 1 compressed the wire")
    check(same_bits(got, bucket * torch.tensor(1.5, dtype=bucket.dtype,
                                               device=bucket.device)),
          "allreduce(compression=int8) at world size 1 is not bucket * 1.5")

    # the two-phase quantized allreduce over the one-rank NCCL group,
    # against the same call on the CPU over gloo
    cpu_group = dist.new_group(backend="gloo")
    try:
        for stochastic in (False, True):
            on_card = quantized.quantized_allreduce(bucket,
                                                    stochastic=stochastic)
            on_cpu = quantized.quantized_allreduce(
                bucket.cpu(), group=cpu_group, stochastic=stochastic)
            check(same_bits(on_card.cpu(), on_cpu),
                  f"quantized_allreduce(stochastic={stochastic}): card and "
                  "CPU differ")
    finally:
        dist.destroy_process_group(cpu_group)
    result = dict(tensors=len(grads), elements=bucket.numel(),
                  a2_launches=launches, a3_launches=a3,
                  worst_error_in_scales=worst)
    log("int8_path " + json.dumps(result))
    quantized_allreduce_timing(bucket, reps=5)
    return result


def quantized_allreduce_timing(bucket, reps: int):
    """The two-phase ``quantized_allreduce`` (plain torch ops, as the
    reference is XLA) on the packed bucket at one rank, and its two codec
    phases apart: ``_quantize`` of the bucket and ``_dequantize_sum`` of
    one rank's codes; beside A2 and A3 on the same buffer."""
    import torch

    from horovod_tpu_torch.comm import quantized
    from horovod_tpu_torch.ops import (
        dequantize_int8_blocks,
        quantize_int8_blocks,
    )

    before = (quantize_int8_blocks.launches, dequantize_int8_blocks.launches)
    n = bucket.numel()
    rows = bucket.reshape(1, n)
    q, s = quantized._quantize(rows)
    coded = quantize_int8_blocks(bucket)
    b_ms, b_by = _bound_ms(_int8_bytes(n, 4, 0, True)
                           + _int8_bytes(n, 0, 4, False), 5 * n)
    row = dict(
        elements=n, ranks=1,
        ms=time_cuda(lambda: quantized.quantized_allreduce(bucket), reps),
        stochastic_ms=time_cuda(lambda: quantized.quantized_allreduce(
            bucket, stochastic=True), reps),
        quantize_ms=time_cuda(lambda: quantized._quantize(rows), reps),
        dequantize_sum_ms=time_cuda(lambda: quantized._dequantize_sum(q, s),
                                    reps),
        a2_ms=time_cuda(lambda: quantize_int8_blocks(bucket), reps),
        a3_ms=time_cuda(lambda: dequantize_int8_blocks(*coded), reps),
        codec_bound_ms=b_ms, codec_bound_by=b_by)
    quantize_int8_blocks.launches, dequantize_int8_blocks.launches = before
    log("int8_quantized_allreduce " + json.dumps(row))


def surface_autograd_phase(hvd, device):
    """The torch surface's collectives on card tensors that require grad,
    in the one-rank world: the gradient of ``sum(y * w)`` is ``w``."""
    import torch

    gen = torch.Generator(device=device).manual_seed(SEED + 4)
    cases = [
        ("allreduce Sum", torch.float32, (1000,),
         lambda x: hvd.allreduce(x, op=hvd.Sum)),
        ("allreduce Average, fp16 codec", torch.bfloat16, (1000,),
         lambda x: hvd.allreduce(x, None, "g", hvd.Compression.fp16)),
        ("allgather", torch.float32, (33, 4), hvd.allgather),
    ]
    for what, dtype, shape, fn in cases:
        x = torch.randn(shape, generator=gen, device=device).to(dtype)
        w = torch.randn(shape, generator=gen, device=device).to(dtype)
        x.requires_grad_()
        y = fn(x)
        check(y.requires_grad and y.device == x.device
              and same_bits(y.detach(), x.detach()),
              f"surface {what}: forward")
        (y * w).sum().backward()
        check(x.grad is not None and same_bits(x.grad, w),
              f"surface {what}: gradient")
    log(f"surface_autograd: {len(cases)} collectives on {device} carry "
        "their gradient (world of one: x.grad == w)")


# -- phase 6b: the async controller ------------------------------------------

BERT_VOCAB, BERT_HIDDEN = 30522, 768     # BERT-Base, Uncased bert_config.json
SPARSE_BATCH, SPARSE_SEQ = 64, 128
ASYNC_REPS = 5


def hook_order_grads(model, opt, x, y):
    """The model's float32 gradients in the order its hooks fire in one
    backward, with their parameter names; the optimizer's own reduction
    of that backward is flushed and its gradients zeroed."""
    import torch
    import torch.nn.functional as F

    name_of = {p: n for n, p in model.named_parameters()}
    order = []
    handles = [p.register_post_accumulate_grad_hook(
        lambda p: order.append((name_of[p], p.grad.float().clone())))
        for p in model.parameters() if p.requires_grad]
    try:
        opt.zero_grad()
        F.cross_entropy(model(x), y).backward()
    finally:
        for h in handles:
            h.remove()
    opt.synchronize()
    opt.zero_grad()
    torch.cuda.synchronize()
    return order


def _record_responses(ctrl):
    """Record the tensor names of every allreduce response the
    controller executes (a wrapper on the instance, not on the class)."""
    groups = []
    orig = ctrl._execute_allreduce

    def recorded(rs, payloads):
        groups.append(list(rs.tensor_names))
        return orig(rs, payloads)

    ctrl._execute_allreduce = recorded
    return groups


def _time_controller(ctrl):
    """Host seconds the controller spends negotiating (its core's drain,
    the transport's exchange, the core's apply; idle cycles included;
    each also apart) and executing (the inputs' stream waits and each
    response's work, both done before its futures resolve), summed into
    the returned dict (wrappers on the instances)."""
    spent = dict.fromkeys(("negotiate", "drain", "exchange", "apply",
                           "execute"), 0.0)

    def timed(obj, attr, *keys):
        orig = getattr(obj, attr)

        def run(*args):
            t0 = time.perf_counter()
            try:
                return orig(*args)
            finally:
                for key in keys:
                    spent[key] += time.perf_counter() - t0
        setattr(obj, attr, run)

    timed(ctrl._ctrl, "drain_requests", "negotiate", "drain")
    timed(ctrl._transport, "exchange", "negotiate", "exchange")
    timed(ctrl._ctrl, "apply_responses", "negotiate", "apply")
    timed(ctrl, "_await_inputs", "execute")
    timed(ctrl, "_execute_one", "execute")
    return spent


def _plain_group(tensors, codec, pre: float, post: float):
    """The plain composition of one agreed group at one rank: a group of
    several tensors is prescale, compress and pack, the (identity) wire,
    unpack, decompress and postscale; a group of one is
    ``comm/eager.allreduce``'s rule, one multiply by ``pre * post``."""
    import torch

    from horovod_tpu_torch.ops import (
        scale_cast_pack_plain,
        unpack_cast_scale_plain,
    )

    if len(tensors) == 1:
        t = tensors[0]
        return [t * torch.tensor(pre * post, dtype=t.dtype, device=t.device)]
    flat, specs = scale_cast_pack_plain(tensors, pre, codec)
    return unpack_cast_scale_plain(flat, specs, [t.dtype for t in tensors],
                                   post)


def _check_burst(outs, groups, launches, by_name, codec, pre, post,
                 what: str) -> int:
    """Every result of a burst bitwise the plain composition of the group
    the controller's responses name, the responses covering the burst
    once, and two A1 launches a fused group of several tensors; returns
    the count of such groups."""
    check(sorted(n for g in groups for n in g) == sorted(by_name),
          f"{what}: the responses do not cover the burst")
    multi = sum(len(g) > 1 for g in groups)
    check(launches == 2 * multi,
          f"{what}: {launches} A1 launches for {multi} fused groups of "
          "several tensors (want two a group)")
    for g in groups:
        want = _plain_group([by_name[t] for t in g], codec, pre, post)
        for t, w in zip(g, want):
            check(same_bits(outs[t], w), f"{what}: {t} is not the plain "
                  "composition of its group")
    return multi


def _new_controller(python_core: bool, autotuner=None):
    """A second controller of this process, made by ``get_controller``
    as the first was (same config, process sets, timeline, device), on
    the C++ core or on ``PyController``, with ``autotuner``; the state's
    own controller and autotuner are left as they were."""
    from horovod_tpu_torch.core import state as core_state
    from horovod_tpu_torch.eager import get_controller

    st = core_state.global_state()
    saved = (st.controller, st.autotuner,
             os.environ.pop("HVTPU_FORCE_PY_CONTROLLER", None))
    if python_core:
        os.environ["HVTPU_FORCE_PY_CONTROLLER"] = "1"
    st.controller, st.autotuner = None, autotuner
    try:
        return get_controller()
    finally:
        st.controller, st.autotuner = saved[:2]
        os.environ.pop("HVTPU_FORCE_PY_CONTROLLER", None)
        if saved[2] is not None:
            os.environ["HVTPU_FORCE_PY_CONTROLLER"] = saved[2]


CORE_PAIRS = 4    # bursts a codec on each negotiation core, in turns
CORE_ALONE_REPS = 20
CORE_ALONE_OPS = (40, 80, 161)


def _core_alone(by_name, python_core: bool) -> dict:
    """One negotiation of the burst's float32 allreduces on a core alone
    (rank 0 of a world of one, no controller, no other thread): the
    enqueues, the drain, the exchange (ingest and compute) and the
    apply, after 2 untimed rounds (the cache steady); host ms, medians
    of ``CORE_ALONE_REPS``, at each count of ``CORE_ALONE_OPS`` (the
    burst's first ops)."""
    return {str(n): _core_alone_at(dict(list(by_name.items())[:n]),
                                   python_core)
            for n in CORE_ALONE_OPS}


def _core_alone_at(by_name, python_core: bool) -> dict:
    from horovod_tpu_torch.native import core as native_core
    from horovod_tpu_torch.native import fallback, wire

    cls = fallback.PyController if python_core else native_core.NativeController
    c = cls(0, 1, 64 << 20)
    f32 = wire.DTYPE_IDS["float32"]
    parts = {k: [] for k in ("enqueue", "drain", "exchange", "apply")}
    seq = 0
    for rep in range(CORE_ALONE_REPS + 2):
        t0 = time.perf_counter()
        for n, g in by_name.items():
            seq += 1
            c.enqueue(seq, n, wire.ALLREDUCE, wire.RED_SUM, f32,
                      tuple(g.shape))
        t1 = time.perf_counter()
        blob = c.drain_requests()
        t2 = time.perf_counter()
        c.ingest(blob)
        resp = c.compute_responses()
        t3 = time.perf_counter()
        done = c.apply_responses(resp)
        t4 = time.perf_counter()
        check(len(done) == len(by_name), "cores alone: not every op done")
        if rep >= 2:
            for k, a, b in (("enqueue", t0, t1), ("drain", t1, t2),
                            ("exchange", t2, t3), ("apply", t3, t4)):
                parts[k].append((b - a) * 1e3)
    c.close()
    return {f"{k}_ms": statistics.median(v) for k, v in parts.items()}


def core_turns(hvd, burst, by_name, groups, spent, surface, engine, pre,
               post):
    """The burst of ``allreduce_async_`` (fp16, then none) on the C++
    core (the state's controller) and on a second controller on
    ``PyController``, in turns (native first, then Python first), after
    an untimed burst each: the results bitwise equal across the cores
    and bitwise the plain composition, the same groups, the same A1
    launches; each burst's host ms and its negotiation split; then one
    negotiation of the same 161 ops on each core alone (``alone``)."""
    from horovod_tpu_torch.core import state as core_state
    from horovod_tpu_torch.native import core as native_core
    from horovod_tpu_torch.native import fallback
    from horovod_tpu_torch.obs import metrics as obs_metrics
    from horovod_tpu_torch.ops import fused_scale_cast

    st = core_state.global_state()
    native = st.controller
    py = _new_controller(python_core=True)
    check(isinstance(native._ctrl, native_core.NativeController)
          and isinstance(py._ctrl, fallback.PyController),
          f"cores: {type(native._ctrl)} and {type(py._ctrl)}")
    turns = {"native": (native, groups, spent),
             "python": (py, _record_responses(py), _time_controller(py))}
    out = {}
    try:
        for codec in ("fp16", "none"):
            ref = None
            rec = {k: [] for k in turns}
            launches = {k: [] for k in turns}
            for pair in range(-1, CORE_PAIRS):
                order = (("native", "python") if pair % 2 == 0
                         else ("python", "native"))
                for k in order:
                    ctrl, grp, spent = turns[k]
                    st.controller = ctrl
                    grp.clear()
                    fused_scale_cast.launches = 0   # the path starts here
                    outs, ms = burst(surface[codec], False, ctrl=ctrl,
                                     groups=grp, spent=spent)
                    n = fused_scale_cast.launches   # read just after it
                    got = list(grp)
                    _check_burst(outs, got, n, by_name, engine[codec], pre,
                                 post, f"cores {codec} {k}")
                    if ref is None:
                        ref = (outs, got, n)
                    check(got == ref[1] and n == ref[2],
                          f"cores {codec}: {k} grouped or launched "
                          "otherwise")
                    check(all(same_bits(outs[t], ref[0][t]) for t in outs),
                          f"cores {codec}: {k} differs from the first run")
                    if pair >= 0:                   # the untimed one first
                        rec[k].append(ms)
                        launches[k].append(n)
            out[codec] = {k: {
                "timed": rec[k], "a1_launches": launches[k],
                "fused_groups": len(ref[1]),
                **{f"median_{m}": statistics.median(r[m] for r in rec[k])
                   for m in ("ms", "negotiate_ms", "drain_ms",
                             "exchange_ms", "apply_ms", "execute_ms")},
                "negotiate_share": statistics.median(
                    r["negotiate_ms"] / r["ms"] for r in rec[k])}
                for k in turns}
    finally:
        st.controller = native
        py.stop()
        # the last controller stopped took the /debug provider with it
        obs_metrics.register_debug_provider("controller", native.debug_state)
    out["alone"] = {k: _core_alone(by_name, k == "python") for k in turns}
    return out


# (fusion threshold bytes, cycle ms): the first is the default threshold,
# the second is applied from the first scored step on
AUTOTUNE_GRID = ((64 << 20, 1.0), (8 << 20, 2.0))
AUTOTUNE_BURSTS = 4


def autotune_part(hvd, burst, by_name, surface, engine, pre, post):
    """A third controller (C++ core) with an ``Autotuner`` in grid mode
    over ``AUTOTUNE_GRID``, one step a sample, no warm-up, driven by the
    fp16 burst: the tuned threshold and cycle time reach the controller
    and prediction stays off; every result bitwise the plain composition
    of its group; each compute's fused groups exactly the greedy split
    of its (name-ordered) tensors at the threshold in force."""
    from horovod_tpu_torch.core import state as core_state
    from horovod_tpu_torch.core.config import Config
    from horovod_tpu_torch.native import wire
    from horovod_tpu_torch.obs import Autotuner
    from horovod_tpu_torch.obs import metrics as obs_metrics
    from horovod_tpu_torch.ops import fused_scale_cast

    st = core_state.global_state()
    native = st.controller
    tuner = Autotuner(Config(autotune=True, autotune_warmup_samples=0,
                             autotune_steps_per_sample=1),
                      grid=list(AUTOTUNE_GRID))
    ctrl = _new_controller(python_core=False, autotuner=tuner)
    groups, spent = _record_responses(ctrl), _time_controller(ctrl)
    computes = []
    compute = ctrl._ctrl.compute_responses

    def recorded():
        thr = ctrl._ctrl.fusion_threshold
        blob = compute()
        rl = wire.parse_response_list(blob)
        for r in rl.responses:     # bytes on the wire, as the core counts
            nbytes.update({n: math.prod(s) * wire.DTYPE_SIZES[r.dtype]
                           for n, s in zip(r.tensor_names, r.tensor_shapes)})
        if rl.responses:
            computes.append((thr, [(list(r.tensor_names), r.total_bytes)
                                   for r in rl.responses]))
        return blob

    ctrl._ctrl.compute_responses = recorded
    nbytes = {}
    bursts = []
    try:
        st.controller = ctrl
        for _ in range(AUTOTUNE_BURSTS):
            groups.clear()
            computes.clear()
            fused_scale_cast.launches = 0       # the path starts here
            outs, ms = burst(surface["fp16"], False, ctrl=ctrl,
                             groups=groups, spent=spent)
            launches = fused_scale_cast.launches  # read just after it
            _check_burst(outs, list(groups), launches, by_name,
                         engine["fp16"], pre, post, "autotune")
            greedy = 0
            for thr, rs in computes:
                names = [n for ns, _ in rs for n in ns]
                for ns, total in rs:
                    check(total == sum(nbytes[n] for n in ns)
                          and all(nbytes[n] == 2 * by_name[n].numel()
                                  for n in ns)
                          and (len(ns) == 1 or total <= thr),
                          f"autotune: a group of {total} bytes at a "
                          f"threshold of {thr}")
                if names == sorted(names):      # one burst unit: greedy
                    greedy += 1
                    for (_, a), (ns, _) in zip(rs, rs[1:]):
                        check(a + nbytes[ns[0]] > thr, "autotune: a group "
                              f"closed at {a} bytes below {thr}")
            check(greedy > 0, "autotune: no compute held one burst unit")
            bursts.append({"thresholds": sorted({c[0] for c in computes}),
                           "group_sizes": [len(ns) for _, rs in computes
                                           for ns, _ in rs],
                           "a1_launches": launches, "ms": ms["ms"],
                           "greedy_checked": greedy,
                           "cycle_ms": ctrl.cycle_time_s * 1e3,
                           "tuner_done": tuner.done})
        thr, cyc_ms = tuner.current
        check(tuner.done and ctrl._ctrl.fusion_threshold == thr
              and ctrl.cycle_time_s == cyc_ms / 1e3,
              f"autotune: tuner {tuner.current} done {tuner.done}, the "
              f"controller at {ctrl._ctrl.fusion_threshold} bytes and "
              f"{ctrl.cycle_time_s * 1e3} ms")
        seen = {t for b in bursts for t in b["thresholds"]}
        check(seen >= {g[0] for g in AUTOTUNE_GRID},
              f"autotune: thresholds in force {sorted(seen)}")
        check(ctrl._tuned_seen and ctrl.predicted_bursts == 0,
              "autotune: prediction after tuning")
    finally:
        st.controller = native
        ctrl.stop()
        obs_metrics.register_debug_provider("controller", native.debug_state)
    return {"grid": [list(g) for g in AUTOTUNE_GRID],
            "pinned": list(tuner.current), "bursts": bursts,
            "plane": "streamed" if ctrl._stream else "lockstep",
            "predicted_bursts": ctrl.predicted_bursts}


ZC_LEARN = 3       # untimed bursts that learn the pack plan
# the timed bursts, zero-copy on (True) and off in turns
ZC_ORDER = (True, False, False, True, True, False, False, True, True, False)
ZC_WHY_LOCKSTEP = ("a world of one takes the lockstep plane: the streamed "
                   "plane and prediction start only past one rank, and "
                   "NCCL refuses two ranks of one communicator on one "
                   "device")


def _set_zero_copy(ctrl, on: bool, saved: dict) -> None:
    """Turn the controller's zero-copy route on or off between bursts:
    off sets the learned pack plan aside (and stops learning), on puts
    it back, so an on burst needs no new learning."""
    with ctrl._lock:
        if on and "plan" in saved:
            ctrl._pack_plan, specs = saved.pop("plan")
            ctrl._pack_group_specs.update(specs)
        elif not on and ctrl._pack_plan is not None:
            saved["plan"] = (ctrl._pack_plan, dict(ctrl._pack_group_specs))
            ctrl._release_open_packs()
            ctrl._pack_plan = None
            ctrl._pack_group_specs.clear()
        ctrl._zero_copy_on = on


def zero_copy_phase(hvd, ctrl, by_name, groups, spent, staged):
    """The controller's zero-copy route on the optimizer's default
    traffic: the 161 gradients as ``allreduce_async_`` (Average, no
    codec, scales 1) under names of their own, their values changed from
    burst to burst (an exchange buffer reused while a collective or an
    unpack still reads it would show).  ``ZC_LEARN`` untimed bursts learn
    the pack plan, then ``ZC_ORDER``'s timed bursts run with the route on
    and off in turns.  In every burst each result is bitwise the staged
    route's (``staged``, the controller's ``GroupReduction``, on the
    burst's inputs) and lands in the caller's tensor; with the route on
    every op of a fused group is a zero-copy op (all 161 at full width,
    two groups) and each fused group one A1 launch (its unpack), with it
    off they are staged copies and two launches a group."""
    import torch

    from horovod_tpu_torch.ops import fused_scale_cast

    names = {f"zc.{n}": g for n, g in by_name.items()}
    saved = {}

    def burst(k: int):
        inputs = {n: g * (1.0 + 0.125 * k) for n, g in names.items()}
        tensors = {n: t.clone() for n, t in inputs.items()}
        torch.cuda.synchronize()
        spent.update(dict.fromkeys(spent, 0.0))
        zc0, st0 = ctrl.zero_copy_ops, ctrl.staged_copies
        pr0, cy0 = ctrl.predicted_bursts, ctrl._cycle
        groups.clear()
        fused_scale_cast.launches = 0       # the burst starts here
        t0 = time.perf_counter()
        ctrl.hint_burst(len(tensors))
        handles = {n: hvd.allreduce_async_(t, name=n)
                   for n, t in tensors.items()}
        t_enq = time.perf_counter()
        outs = {n: hvd.synchronize(h) for n, h in handles.items()}
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        launches = fused_scale_cast.launches   # read just after it
        agreed = list(groups)
        check(sorted(n for g in agreed for n in g) == sorted(names),
              f"zero-copy burst {k}: the responses do not cover it")
        for g in agreed:
            for n, w in zip(g, staged.reduce([inputs[n] for n in g])):
                check(outs[n] is tensors[n] and same_bits(outs[n], w),
                      f"zero-copy burst {k}: {n} is not the staged "
                      "route's result, in the caller's tensor")
        return {"ms": (t1 - t0) * 1e3, "enqueue_ms": (t_enq - t0) * 1e3,
                "negotiate_ms": spent["negotiate"] * 1e3,
                "execute_ms": spent["execute"] * 1e3,
                "zero_copy_ops": ctrl.zero_copy_ops - zc0,
                "staged_copies": ctrl.staged_copies - st0,
                "predicted": ctrl.predicted_bursts - pr0,
                "cycles": ctrl._cycle - cy0,
                "group_sizes": [len(g) for g in agreed],
                "a1_launches": launches}

    def fused(r):
        # ops in fused groups (a group of one tensor takes neither route)
        return sum(n for n in r["group_sizes"] if n > 1)

    learn = [burst(k) for k in range(ZC_LEARN)]
    check(learn[-1]["zero_copy_ops"] == fused(learn[-1]) > 0,
          f"zero-copy: no plan learned in {ZC_LEARN} bursts ({learn})")
    timed = {True: [], False: []}
    for k, on in enumerate(ZC_ORDER, start=ZC_LEARN):
        _set_zero_copy(ctrl, on, saved)
        r = burst(k)
        multi = sum(n > 1 for n in r["group_sizes"])
        check(r["zero_copy_ops"] == (fused(r) if on else 0)
              and r["staged_copies"] == (0 if on else fused(r))
              and r["a1_launches"] == (1 if on else 2) * multi,
              f"zero-copy {'on' if on else 'off'}, burst {k}: {r}")
        timed[on].append(r)
    _set_zero_copy(ctrl, True, saved)

    # what the route adds to the enqueue, apart: the 161 copy_ calls
    # alone into one exchange buffer's slots, and ExchangeBuffer.write
    # (host clock, 5 turns each)
    from horovod_tpu_torch.comm.packing import ExchangeBuffer

    grads = list(names.values())
    xb = ExchangeBuffer([(tuple(g.shape), g.dtype,
                          g.numel() * g.element_size()) for g in grads],
                        grads[0].device)

    def host_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        xb.reset()
        return (t1 - t0) * 1e3

    def copies():
        for v, g in zip(xb.views(), grads):
            v.copy_(g)

    def writes():
        for i, g in enumerate(grads):
            xb.write(i, g)

    copy_ms = [host_ms(copies) for _ in range(5)]
    write_ms = [host_ms(writes) for _ in range(5)]
    state = ctrl.debug_state()
    predicted = sum(r["predicted"] for r in learn + timed[True]
                    + timed[False])
    check(state["plane"] == "lockstep" and predicted == 0,
          "zero-copy: a world of one on another plane or predicting")
    return {
        "grads": len(names), "learn": learn,
        "timed_on": timed[True], "timed_off": timed[False],
        "median_ms_on": statistics.median(r["ms"] for r in timed[True]),
        "median_ms_off": statistics.median(r["ms"] for r in timed[False]),
        "a1_launches_on": timed[True][0]["a1_launches"],
        "a1_launches_off": timed[False][0]["a1_launches"],
        "copy_ms": copy_ms, "write_ms": write_ms,
        "plane": state["plane"], "predicted": predicted,
        "why": ZC_WHY_LOCKSTEP, "fusion_pool": state["fusion_pool"]}


def async_phase(hvd, device, model, opt, x, y, smi: str):
    """The async plane at full width in the one-rank NCCL world: the
    optimizer's 161 ResNet-50 gradients (float32) as a burst of
    ``allreduce_async_`` calls in hook order and as one
    ``grouped_allreduce_async``, under fp16 and none with the predivide
    scales; a process set {0}; the BERT-base word embedding's sparse
    gradient; the other async ops once each."""
    import torch
    import torch.nn.functional as F

    from horovod_tpu_torch.comm.compression import Compression as Engine
    from horovod_tpu_torch.eager import get_controller
    from horovod_tpu_torch.ops import fused_scale_cast

    model_names = {p: n for n, p in model.named_parameters()}
    grads = hook_order_grads(model, opt, x, y)
    check(len(grads) == RESNET50_GRADS, "async: hook order")
    n_elems = sum(g.numel() for _, g in grads)
    pre, post = 1.0 / PREDIVIDE, PREDIVIDE / hvd.size()
    ctrl = get_controller()
    groups = _record_responses(ctrl)
    spent = _time_controller(ctrl)
    by_name = {f"allreduce.{n}": g for n, g in grads}
    result = {"card": smi, "grads": len(grads), "elements": n_elems}

    def burst(codec, grouped: bool, ctrl=ctrl, groups=groups, spent=spent):
        """One pass of the traffic through ``ctrl`` (the controller the
        ops reach); returns {name: result} and its host ms: from the
        first enqueue to the last synchronize, to the last enqueue, and
        the controller's negotiation (its drain, exchange and apply
        apart) and execution; with the controller cycles and the
        allreduce responses of the pass."""
        tensors = {n: g.clone() for n, g in by_name.items()}
        torch.cuda.synchronize()
        spent.update(dict.fromkeys(spent, 0.0))
        cycles0, groups0 = ctrl._cycle, len(groups)
        t0 = time.perf_counter()
        if grouped:
            names = list(tensors)
            handles = dict(zip(names, hvd.grouped_allreduce_async(
                [tensors[n] for n in names], names=names, op=hvd.Sum,
                compression=codec, prescale_factor=pre,
                postscale_factor=post)))
        else:
            # the reference optimizer's hint and per-hook calls
            ctrl.hint_burst(len(tensors))
            handles = {n: hvd.allreduce_async_(
                t, name=n, op=hvd.Sum, compression=codec,
                prescale_factor=pre, postscale_factor=post)
                for n, t in tensors.items()}
        t_enq = time.perf_counter()
        outs = {n: hvd.synchronize(h) for n, h in handles.items()}
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        return outs, {"ms": (t1 - t0) * 1e3, "enqueue_ms": (t_enq - t0) * 1e3,
                      **{f"{k}_ms": v * 1e3 for k, v in spent.items()},
                      "cycles": ctrl._cycle - cycles0,
                      "groups": len(groups) - groups0}

    surface = {"fp16": hvd.Compression.fp16, "none": hvd.Compression.none}
    engine = {"fp16": Engine.fp16, "none": Engine.none}
    none_red = dataclasses.replace(opt.reduction, compression=Engine.none)
    runs = {}
    for codec in ("fp16", "none"):
        for grouped in (False, True):
            key = f"{codec}_{'grouped' if grouped else 'burst'}"
            groups.clear()
            fused_scale_cast.launches = 0     # the async path starts here
            outs, first_ms = burst(surface[codec], grouped)
            launches = fused_scale_cast.launches   # read just after it
            first = list(groups)
            multi = _check_burst(outs, first, launches, by_name,
                                 engine[codec], pre, post, f"async {key}")
            n = len(by_name)
            if codec == "none":
                # the optimizer's GroupReduction over its bucket plan
                for bucket in opt.buckets:
                    bn = [f"allreduce.{model_names[p]}" for p in bucket]
                    got = none_red.reduce([by_name[t] for t in bn])
                    for t, w in zip(bn, got):
                        check(same_bits(outs[t], w), f"async {key}: {t} "
                              "is not GroupReduction's result")
            timed = [burst(surface[codec], grouped)[1]
                     for _ in range(ASYNC_REPS)]
            runs[key] = {
                **first_ms, "timed": timed,
                "median_ms": statistics.median(t["ms"] for t in timed),
                "median_cycles": statistics.median(t["cycles"]
                                                   for t in timed),
                "fused_groups": len(first), "multi_tensor_groups": multi,
                "group_sizes": [len(g) for g in first],
                "a1_launches": launches, "checked": n}
    result["runs"] = runs
    result["a1_launches"] = runs["fp16_burst"]["a1_launches"]
    result["cores"] = core_turns(hvd, burst, by_name, groups, spent,
                                 surface, engine, pre, post)
    result["autotune"] = autotune_part(hvd, burst, by_name, surface,
                                       engine, pre, post)
    result["zero_copy"] = zero_copy_phase(
        hvd, ctrl, by_name, groups, spent,
        dataclasses.replace(none_red, op=hvd.Average, prescale=1.0,
                            postscale=1.0))

    # GroupReduction.reduce over the same gradients, its bucket plan,
    # in the same call (host clock, synchronized)
    bucket_grads = [[by_name[f"allreduce.{model_names[p]}"] for p in b]
                    for b in opt.buckets]
    saved = fused_scale_cast.launches

    def group_reduce_ms(red):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in bucket_grads:
            red.reduce(b)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    for red, key in ((opt.reduction, "fp16"), (none_red, "none")):
        group_reduce_ms(red)
        times = [group_reduce_ms(red) for _ in range(ASYNC_REPS)]
        result[f"group_reduce_{key}_ms"] = times
        result[f"group_reduce_{key}_median_ms"] = statistics.median(times)
    fused_scale_cast.launches = saved

    # a process set {0}: its own groups; its allreduce is the global one's
    gen = torch.Generator(device=device).manual_seed(SEED + 6)
    t = torch.randn(4097, generator=gen, device=device)
    ps = hvd.add_process_set([0])
    psid = ps.process_set_id
    got = hvd.synchronize(hvd.allreduce_async(t, op=hvd.Sum, name="ps0",
                                              process_set=ps))
    want = hvd.synchronize(hvd.allreduce_async(t, op=hvd.Sum, name="glob"))
    check(same_bits(got, want), "async: process set {0} differs from the "
          "global set")
    hvd.barrier(process_set=ps)       # the set's own NCCL group
    check(hvd.remove_process_set(ps) and not hvd.remove_process_set(ps),
          "async: remove_process_set")
    result["process_set"] = {"id": psid, "bitwise": True}

    # the BERT-base word embedding's sparse gradient
    egen = torch.Generator().manual_seed(SEED + 7)
    emb = torch.nn.Embedding(BERT_VOCAB, BERT_HIDDEN, sparse=True,
                             device=device)
    with torch.no_grad():
        emb.weight.copy_(torch.randn(BERT_VOCAB, BERT_HIDDEN,
                                     generator=egen).to(device))
    ids = torch.randint(0, BERT_VOCAB, (SPARSE_BATCH, SPARSE_SEQ),
                        generator=egen).to(device)
    v = torch.randn(SPARSE_BATCH, SPARSE_SEQ, BERT_HIDDEN,
                    generator=egen).to(device)
    (emb(ids) * v).sum().backward()
    g = emb.weight.grad
    check(g.is_sparse, "async: the embedding's gradient is not sparse")
    out = hvd.synchronize(hvd.sparse_allreduce_async(g, name="emb",
                                                     op=hvd.Sum))
    want = g.coalesce()
    check(out.is_coalesced() and torch.equal(out.indices(), want.indices())
          and same_bits(out.values(), want.values()),
          "async: sparse_allreduce_async is not the coalesced gradient")
    # sparse_as_dense: the optimizer's step is the dense route's
    w0 = emb.weight.detach().clone()
    sparse_opt = hvd.DistributedOptimizer(
        torch.optim.SGD(emb.parameters(), lr=0.1),
        named_parameters=emb.named_parameters(), sparse_as_dense=True)
    dense_w = torch.nn.Parameter(w0.clone())
    dense_opt = hvd.DistributedOptimizer(
        torch.optim.SGD([dense_w], lr=0.1),
        named_parameters=[("weight", dense_w)])
    sparse_opt.zero_grad()
    (emb(ids) * v).sum().backward()
    check(not emb.weight.grad.is_sparse, "async: sparse_as_dense left the "
          "gradient sparse")
    dense_w.grad = emb.weight.grad.clone()
    sparse_opt.step()
    dense_opt.step()
    check(same_bits(emb.weight.detach(), dense_w.detach())
          and not torch.equal(emb.weight.detach(), w0),
          "async: sparse_as_dense differs from the dense route")
    result["sparse"] = {"vocab": BERT_VOCAB, "hidden": BERT_HIDDEN,
                        "ids": SPARSE_BATCH * SPARSE_SEQ,
                        "nnz_coalesced": int(out.values().shape[0])}
    del emb, v, sparse_opt, dense_opt, dense_w

    # the other async ops once each, against the sync ops
    a = torch.randn(64, 33, generator=gen, device=device)
    h = hvd.allgather_async(a, name="ag")
    polled_before = hvd.poll(h)
    check(same_bits(hvd.synchronize(h), hvd.allgather(a)), "allgather_async")
    check(hvd.poll(h), "poll after synchronize")
    check(same_bits(hvd.synchronize(hvd.broadcast_async(a, 0, "bc")),
                    hvd.broadcast(a, 0)), "broadcast_async")
    check(same_bits(hvd.synchronize(hvd.alltoall_async(a, name="a2a")),
                    hvd.alltoall(a)), "alltoall_async")
    check(same_bits(hvd.synchronize(hvd.reducescatter_async(
        a, hvd.Sum, "rs")), hvd.reducescatter(a, hvd.Sum)),
        "reducescatter_async")
    check(hvd.join() == 0, "join")
    result["others"] = {"polled_before": bool(polled_before), "join": 0}
    log("async_path " + json.dumps(result))
    return result


# -- Adasum -------------------------------------------------------------------

# pairwise_adasum in float32 against float64, per segment: |got - ref| at
# most ADASUM_RTOL times the segment's largest |ref|.  The coefficients'
# dot products sum up to 2.36 M float32 products in cuBLAS's order (an
# error of some log2(n) float32 roundings of sum |a_i b_i|), and each
# output rounds once more.
ADASUM_RTOL = 1e-4


def adasum_phase(hvd, device, model, x, y):
    """Adasum on the card: ``pairwise_adasum`` over two backward passes'
    161 ResNet-50 gradients (phase 3's batch and a second one, float32,
    a segment a tensor) against the float64 reference on the CPU, with
    its time; then a full-width ResNet-50 step with ``op=Adasum`` at a
    world of one, bitwise the ``op=Sum`` step on the same gradients (at
    one rank Adasum returns the tensor itself)."""
    import itertools

    import numpy as np
    import torch
    import torch.nn.functional as F

    from horovod_tpu_torch.comm.adasum import (
        adasum_reduce_reference,
        pairwise_adasum,
    )
    from horovod_tpu_torch.models import ResNet
    from horovod_tpu_torch.ops import fused_scale_cast

    params = [p for p in model.parameters() if p.requires_grad]
    dgen = torch.Generator(device=device).manual_seed(SEED + 8)
    x2 = torch.randn(x.shape, generator=dgen, device=device)
    y2 = y.flip(0)
    a, b = (torch.cat([g.float().reshape(-1) for g in torch.autograd.grad(
        F.cross_entropy(model(xb), yb), params)]) for xb, yb in
        ((x, y), (x2, y2)))
    sizes = [p.numel() for p in params]
    segs = list(zip(itertools.accumulate([0] + sizes[:-1]), sizes))
    got = pairwise_adasum(a, b, segs)
    ms = time_cuda(lambda: pairwise_adasum(a, b, segs), reps=5)
    a64, b64 = a.double().cpu().numpy(), b.double().cpu().numpy()
    out = got.double().cpu().numpy()
    worst = 0.0
    for off, n in segs:
        ref = adasum_reduce_reference([a64[off:off + n], b64[off:off + n]])
        err = float(np.abs(out[off:off + n] - ref).max())
        top = float(np.abs(ref).max())
        worst = max(worst, err / top if top > 0
                    else (0.0 if err == 0 else math.inf))
    check(got.dtype == torch.float32 and torch.isfinite(got).all()
          and worst <= ADASUM_RTOL,
          f"adasum: pairwise_adasum off the float64 reference ({worst})")

    # one step with op=Adasum and one with op=Sum from the same weights
    # on the same gradients: bitwise the same weights and momenta
    models = [ResNet([3, 4, 6, 3], dtype=torch.bfloat16, device=device,
                     generator=torch.Generator().manual_seed(SEED))
              for _ in range(2)]
    opts = [hvd.DistributedOptimizer(
        torch.optim.SGD(m.parameters(), lr=0.1, momentum=0.9),
        named_parameters=m.named_parameters(), op=op)
        for m, op in zip(models, (hvd.Sum, hvd.Adasum))]
    saved = fused_scale_cast.launches
    w0 = [p.detach().clone() for p in models[0].parameters()]
    F.cross_entropy(models[0](x), y).backward()
    for p, q in zip(models[0].parameters(), models[1].parameters()):
        q.grad = p.grad.detach().clone()
    for opt in opts:
        opt.step()
    torch.cuda.synchronize()
    fused_scale_cast.launches = saved
    moved = 0
    for (name, p), q, w in zip(models[0].named_parameters(),
                               models[1].parameters(), w0):
        check(same_bits(p, q) and same_bits(
            opts[0].state[p]["momentum_buffer"],
            opts[1].state[q]["momentum_buffer"]),
            f"adasum: the op=Adasum step differs from op=Sum at {name}")
        moved += not torch.equal(p, w)
    check(moved > 0, "adasum: the step moved no weight")
    n = a.numel()
    result = {"elements": n, "segments": len(segs), "ms": ms,
              # a and b read once, the result written once; 3 dot
              # products and the combination, 10 operations an element
              "bound_ms": _bound_ms(3 * 4 * n, 10 * n)[0],
              "max_rel_err": worst, "rtol": ADASUM_RTOL,
              "step_bitwise_sum": True, "params_moved": moved}
    log("adasum " + json.dumps(result))
    del models, opts
    return result


# -- the stall watchdog and fault injection on the card -----------------------

STALL_HB_S, STALL_WARN_S, STALL_ABORT_S = 0.05, 0.3, 1.0
# a peer whose beats stop is stale after 10 heartbeats, so the dead-peer
# run's abort comes at the abort time, within the card's sleep
STALL_STALE_S = 0.5
STALL_OPS = 20
STALL_SLEEP_S = 3.0


def _store_features():
    """Which stores of this torch have ``list_keys``, and whether a
    ``FileStore`` deletes: what ``KVTransport``'s docstring states."""
    import datetime
    import tempfile

    import torch.distributed as dist

    tmp = tempfile.mkdtemp(prefix="hvt_smoke_store_")
    tcp = dist.TCPStore("127.0.0.1", 0, 1, True,
                        timeout=datetime.timedelta(seconds=30))
    stores = {"HashStore": dist.HashStore(), "TCPStore": tcp,
              "FileStore": dist.FileStore(f"{tmp}/f", 1)}
    stores["PrefixStore"] = dist.PrefixStore("p", stores["HashStore"])
    features = {}
    for name, store in stores.items():
        store.set("probe", "1")
        try:
            keys = store.list_keys()
            features[f"{name}.list_keys"] = "probe" in keys
        except Exception as e:  # noqa: BLE001 — a feature probe
            features[f"{name}.list_keys"] = f"{type(e).__name__}: {e}"[:120]
        try:
            features[f"{name}.delete_key"] = bool(
                store.delete_key("probe")) and not store.check(["probe"])
        except Exception as e:  # noqa: BLE001 — a feature probe
            features[f"{name}.delete_key"] = f"{type(e).__name__}: {e}"[:120]
    del tcp
    return features


def _dead_peer_postmortem(tmp: Path, desc: str) -> dict:
    """The postmortem the dead-peer abort wrote (the inspector's
    heartbeat thread writes it as it latches the failure): its reason and
    the abort event naming ``desc``."""
    path = tmp / "postmortem-0-0.json"
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        if path.exists():
            with open(path) as f:
                doc = json.load(f)
            events = [e for e in doc["events"] if e["kind"] == "stall_abort"
                      and desc in e.get("detail", "")]
            if events:
                return {"file": path.name, "reason": doc["reason"],
                        "reasons": doc["reasons"],
                        "event": events[-1]["detail"][:200]}
        time.sleep(0.05)
    raise SmokeFailure(f"stall: no postmortem naming {desc!r} in {tmp}")


def _sleep_cycles(seconds: float) -> int:
    """``torch.cuda._sleep`` cycles that keep the card busy ``seconds``,
    from a short calibration run."""
    import torch

    cycles = 50_000_000
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    end.synchronize()
    return int(cycles * seconds * 1e3 / start.elapsed_time(end))


def stall_phase(hvd, device, model, opt, x, y, smi: str, tmp: Path):
    """The watchdog on the card, two of the port's inspectors over one
    ``HashStore`` (ranks 0 and 1 of a set {0, 1}; neither installed, so
    no poison latch): rank 0 runs the optimizer's ``GroupReduction``
    over phase 3's 161 gradients (A1's grouped passes and the one-rank
    NCCL allreduce) through ``dispatch`` / ``wait_ready``.  Healthy: 20
    ops, rank 1 mirroring each descriptor; diverged: rank 1 posts
    another descriptor; dead peer mid-op: the card sleeps before the
    reduction and rank 1 stops beating; the flight recorder (installed by
    ``init()``, into ``tmp``) then holds a postmortem naming the op, and
    the abort family counted it."""
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F

    from horovod_tpu_torch.comm import stall
    from horovod_tpu_torch.core import state as core_state
    from horovod_tpu_torch.core.exceptions import HorovodInternalError
    from horovod_tpu_torch.core.kv import StoreKV
    from horovod_tpu_torch.core.retry import fenced_kv
    from horovod_tpu_torch.ops import fused_scale_cast

    params = [p for p in model.parameters() if p.requires_grad]
    grads = {p: g.contiguous() for p, g in zip(params, torch.autograd.grad(
        F.cross_entropy(model(x), y), params))}
    buckets = [[grads[p] for p in b] for b in opt.buckets]
    multi = sum(len(b) > 1 for b in buckets)
    red = opt.reduction
    want = [o for b in buckets for o in red.reduce(b)]     # unguarded
    outs = [[torch.empty_like(g) for g in b] for b in buckets]

    def launch(pre_sleep: int = 0, events=None):
        """The reduction of every bucket into ``outs``, then a timing
        event behind it: the event is what rank 0 waits on."""
        def run():
            if pre_sleep:
                torch.cuda._sleep(pre_sleep)
            for b, o in zip(buckets, outs):
                red.finish(red.launch(b), o)
            done = torch.cuda.Event(enable_timing=True)
            done.record()
            if events is not None:
                events.append(done)
            return done
        return run

    def got():
        return [o for b in outs for o in b]

    store = dist.HashStore()

    def pair(generation: int):
        return [stall.AmortizedStallInspector(
            fenced_kv(StoreKV(store, 2), rank=r), r, warn_s=STALL_WARN_S,
            abort_s=STALL_ABORT_S, heartbeat_s=STALL_HB_S,
            generation=generation, stale_s=STALL_STALE_S) for r in (0, 1)]

    members = [0, 1]
    result = {"card": smi, "heartbeat_s": STALL_HB_S, "warn_s": STALL_WARN_S,
              "abort_s": STALL_ABORT_S, "stale_s": STALL_STALE_S,
              "grads": len(params), "buckets": len(buckets),
              "multi_tensor_buckets": multi,
              "mode": core_state.global_state().config.stall_check_mode}

    # 1. healthy: 20 ops, rank 1 mirroring each descriptor
    r0, r1 = pair(1)
    warnings0 = stall.counters()["stall_warnings"]
    pre_us, overshoot_us, wait_us, done_to_return_us = [], [], [], []
    try:
        fused_scale_cast.launches = 0   # the guarded reduction starts here
        for i in range(STALL_OPS):
            desc = f"bucket_reduce:{i}:{len(buckets)}"
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r0.pre_op(0, members, desc)
            pre_us.append((time.perf_counter() - t0) * 1e6)
            r1.pre_op(0, members, desc)
            r1.wait_ready(0, None, desc)
            start = torch.cuda.Event(enable_timing=True)
            t_start = time.perf_counter()
            start.record()
            done, _pending = r0.dispatch(0, launch(), (), desc)
            t_w0 = time.perf_counter()
            r0.wait_ready(0, done, desc)
            t_w1 = time.perf_counter()
            check(done.query(), "stall: wait_ready returned before the "
                  "event completed")
            # the event completed at about t_start + its device time:
            # wait_ready's overshoot past that (or past its own call, when
            # the event was done before), and dispatch's handoff with it
            t_done = t_start + start.elapsed_time(done) / 1e3
            overshoot_us.append((t_w1 - max(t_w0, t_done)) * 1e6)
            done_to_return_us.append((t_w1 - t_done) * 1e6)
            wait_us.append((t_w1 - t_w0) * 1e6)
            check(all(same_bits(g, w) for g, w in zip(got(), want)),
                  f"stall: guarded op {i} is not the unguarded reduction")
        stall_launches = fused_scale_cast.launches   # read just after it
        check(stall_launches == 2 * multi * STALL_OPS,
              f"stall: {stall_launches} A1 launches in {STALL_OPS} guarded "
              f"reductions (want {2 * multi} an op)")
        time.sleep(3 * STALL_HB_S)
        check(r0.failure is None and r1.failure is None
              and stall.counters()["stall_warnings"] == warnings0,
              f"stall: the healthy run warned or failed ({r0.failure})")
    finally:
        r0.stop()
        r1.stop()
    result.update(
        ops=STALL_OPS, stall_launches=stall_launches,
        pre_op_us=pre_us, pre_op_median_us=statistics.median(pre_us),
        wait_ready_us=wait_us,
        wait_overshoot_us=overshoot_us,
        wait_overshoot_median_us=statistics.median(overshoot_us),
        done_to_return_us=done_to_return_us,
        done_to_return_median_us=statistics.median(done_to_return_us),
        healthy_bitwise=True, healthy_warnings=0)

    # 2. diverged: rank 1 posts another descriptor at the same seq
    r0, r1 = pair(2)
    try:
        mine, theirs = "bucket_reduce:grads", "broadcast:weights"
        t0 = time.perf_counter()
        r0.pre_op(0, members, mine)
        r1.pre_op(0, members, theirs)
        done, _pending = r0.dispatch(0, launch(), (), mine)
        try:
            r0.wait_ready(0, done, mine)
        except HorovodInternalError:
            pass            # the latch may already have landed
        while r0.failure is None and time.perf_counter() - t0 < 10.0:
            time.sleep(0.001)
        detect_s = time.perf_counter() - t0
        try:
            r0.pre_op(0, members, "next")
            raise SmokeFailure("stall: the diverged op was not diagnosed")
        except HorovodInternalError as e:
            msg = str(e)
        check("diverged" in msg and mine in msg and theirs in msg,
              f"stall: the divergence diagnosis does not name both ops: "
              f"{msg}")
    finally:
        r0.stop()
        r1.stop()
    result.update(diverged_detect_s=detect_s, diverged_message=msg[:240])

    # 3. dead peer mid-op: both ranks enter the op, rank 1's beats stop,
    # rank 0's card sleeps STALL_SLEEP_S before the reduction
    cycles = _sleep_cycles(STALL_SLEEP_S)
    r0, r1 = pair(3)
    try:
        desc = "bucket_reduce:dead_peer"
        r0.pre_op(0, members, desc)
        r1.pre_op(0, members, desc)
        time.sleep(2 * STALL_HB_S)     # both post caught-up beats
        r1._stopped.set()              # then rank 1 dies: no tombstone
        torch.cuda.synchronize()
        events = []
        raised_in = "dispatch"
        aborts = stall.counters()["stall_aborts"]
        t0 = time.perf_counter()
        try:
            done, _pending = r0.dispatch(0, launch(cycles, events), (), desc)
            raised_in = "wait_ready"
            r0.wait_ready(0, done, desc)
            raise SmokeFailure("stall: the dead peer was not diagnosed")
        except HorovodInternalError as e:
            raised_s = time.perf_counter() - t0
            # the launch may still be on the executor thread when the
            # abort comes from dispatch: no event recorded yet
            event_done = bool(events) and events[0].query()
            msg = str(e)
        check(not event_done, "stall: the abort came after the card's event "
              "completed")
        check("stalled collective" in msg and "[1]" in msg,
              f"stall: the abort does not name rank 1: {msg}")
        check(not stall.poisoned(), "stall: a standalone inspector latched "
              "the process-wide poison")
        postmortem = _dead_peer_postmortem(tmp, desc)
        check(stall.counters()["stall_aborts"] > aborts,
              "stall: the abort family did not count the dead peer")
        torch.cuda.synchronize()
        after_sleep_s = time.perf_counter() - t0
        for b, o in zip(buckets, outs):
            red.finish(red.launch(b), o)
        torch.cuda.synchronize()
        check(all(same_bits(g, w) for g, w in zip(got(), want)),
              "stall: the reduction after the abort is not the healthy one")
    finally:
        r0.stop()
        r1.stop()
    fused_scale_cast.launches = 0
    result.update(dead_peer_abort_s=raised_s, dead_peer_event_done=event_done,
                  dead_peer_raised_in=raised_in,
                  dead_peer_sleep_s=after_sleep_s,
                  dead_peer_message=msg[:240], after_abort_bitwise=True,
                  dead_peer_postmortem=postmortem)

    # the features the store adapter and the teardown rely on
    result["store"] = _store_features()
    group = dist.new_group([0])
    probe = torch.ones(8, device=device)
    dist.all_reduce(probe, group=group)
    torch.cuda.synchronize()
    core_state.abort_group(group)
    result["abort_group"] = "torch.distributed.distributed_c10d." \
        "_abort_process_group"
    result["counters"] = stall.counters()
    log("stall " + json.dumps(result))
    return result


FAULT_MODES = ("nan", "bitflip")


def faults_phase(hvd, device, model, opt, x, y, smi: str):
    """Fault injection on device tensors: phase 6b's async burst (the 161
    gradients as ``allreduce_async_`` with the optimizer's arguments:
    Sum, prescale 1/2, postscale 2/1, fp16) clean, then under
    ``collective.pre:corrupt(nan)@count=K,times=1`` and
    ``corrupt(bitflip)``: one result differs from the clean burst, it
    and its group are bitwise the plain composition over the poisoned
    input, 2 A1 launches a fused group, and the poisoning made no host
    round trip (it runs under CUDA's sync-debug mode "error")."""
    import torch

    from horovod_tpu_torch.comm.compression import Compression as Engine
    from horovod_tpu_torch.core import faults
    from horovod_tpu_torch.eager import get_controller
    from horovod_tpu_torch.ops import fused_scale_cast

    grads = hook_order_grads(model, opt, x, y)
    by_name = {f"allreduce.{n}": g for n, g in grads}
    order = list(by_name)
    pre, post = 1.0 / PREDIVIDE, PREDIVIDE / hvd.size()
    ctrl = get_controller()
    groups = _record_responses(ctrl)

    def burst():
        groups.clear()
        tensors = {n: g.clone() for n, g in by_name.items()}
        torch.cuda.synchronize()
        fused_scale_cast.launches = 0
        ctrl.hint_burst(len(tensors))
        handles = {n: hvd.allreduce_async_(
            t, name=n, op=hvd.Sum, compression=hvd.Compression.fp16,
            prescale_factor=pre, postscale_factor=post)
            for n, t in tensors.items()}
        outs = {n: hvd.synchronize(h) for n, h in handles.items()}
        torch.cuda.synchronize()
        return outs, [list(g) for g in groups], fused_scale_cast.launches

    clean, clean_groups, _ = burst()
    # K: the middle gradient of the largest fused group (1-based: the
    # Kth enqueue of the burst fires the clause)
    biggest = max(clean_groups, key=len)
    target = biggest[len(biggest) // 2]
    k = order.index(target) + 1

    seen = []
    orig_poison = faults._poison

    def watched(tensor, mode):
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = orig_poison(tensor, mode)
        finally:
            torch.cuda.set_sync_debug_mode(prev)
        seen.append((tensor.device.type, out.device.type, out.clone()))
        return out

    result = {"card": smi, "grads": len(order), "k": k, "target": target,
              "target_group_size": len(biggest), "runs": {}}
    faults._poison = watched
    try:
        for mode in FAULT_MODES:
            seen.clear()
            faults.install(f"collective.pre:corrupt({mode})@count={k},"
                           "times=1", rank=hvd.rank())
            try:
                outs, fgroups, launches = burst()
            finally:
                faults.uninstall()
            check(len(seen) == 1
                  and seen[0][:2] == (device.type, device.type),
                  f"faults {mode}: the poison did not run once on the card "
                  f"({[s[:2] for s in seen]})")
            poisoned = seen[0][2]
            # the controller fuses by arrival, so a burst's groups may
            # differ from the clean burst's: each burst is held against
            # the plain composition of its own groups, over the poisoned
            # input and over the clean one
            want_poisoned, want_clean = {}, {}
            for g in fgroups:
                clean_in = [by_name[t] for t in g]
                poisoned_in = [poisoned if t == target else by_name[t]
                               for t in g]
                want_clean.update(zip(g, _plain_group(
                    clean_in, Engine.fp16, pre, post)))
                want_poisoned.update(zip(g, _plain_group(
                    poisoned_in, Engine.fp16, pre, post)))
            check(all(same_bits(outs[t], want_poisoned[t]) for t in order),
                  f"faults {mode}: the burst is not the plain composition "
                  "of its groups over the poisoned input")
            differ = [n for n in order
                      if not same_bits(outs[n], want_clean[n])]
            check(differ == [target], f"faults {mode}: results differing "
                  f"from the clean composition: {differ[:5]} (want "
                  f"[{target}])")
            same_groups = fgroups == clean_groups
            if same_groups:
                check([n for n in order if not same_bits(outs[n], clean[n])]
                      == [target], f"faults {mode}: results differing from "
                      "the clean burst")
            multi = sum(len(g) > 1 for g in fgroups)
            check(launches == 2 * multi, f"faults {mode}: {launches} A1 "
                  f"launches for {multi} fused groups of several tensors")
            group = next(g for g in fgroups if target in g)
            result["runs"][mode] = {
                "differing": differ, "group_size": len(group),
                "groups_as_clean_burst": same_groups,
                "a1_launches": launches, "fused_groups": len(fgroups),
                "multi_tensor_groups": multi,
                "poisoned_on": seen[0][1], "sync_debug": "error",
                "poisoned_finite": bool(torch.isfinite(poisoned).all()),
                "result_finite": bool(torch.isfinite(outs[target]).all())}
    finally:
        faults._poison = orig_poison
        faults.uninstall()
    check(not faults.ACTIVE, "faults: the registry is still armed")
    log("faults " + json.dumps(result))
    return result


# -- phase 6c: the meshes and the collectives over a mesh axis --------------

SPMD_N = 17 * 241        # a card tensor of the one-rank axis checks
SPMD_TURNS = 4            # timed turns of each gradient path
SBN_SHAPE = (BATCH, 64, IMAGE // 2, IMAGE // 2)   # ResNet-50's first BN
# _SyncBatchNormFn against F.batch_norm on the float32 input: both compute
# in float32 and the port rounds to bfloat16 once, so each element is
# within a bfloat16 rounding (2^-9 relative) of the other plus their
# float32 statistics' difference; checked at 2^-7 of each element plus
# 2^-7 of the largest magnitude
SBN_RTOL = SBN_ATOL = 2.0 ** -7


def _host_ms(fn) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _spmd_cases(spmd, R, Compression, x, b, i, bools):
    """Every ``spmd`` function of the one-rank axis checks on inputs
    ``x`` (float32), ``b`` (bfloat16), ``i`` (int32): name -> call of a
    mesh."""
    W = dict(axis_name="world")
    return {
        "sum_f32": lambda m: spmd.allreduce(x, op=R.SUM, mesh=m, **W),
        "avg_bf16": lambda m: spmd.allreduce(b, op=R.AVERAGE, mesh=m, **W),
        "avg_i32": lambda m: spmd.allreduce(i, op=R.AVERAGE, mesh=m, **W),
        "scaled_f32": lambda m: spmd.allreduce(
            x, op=R.SUM, prescale_factor=0.5, postscale_factor=3.0, mesh=m,
            **W),
        "scaled_bf16": lambda m: spmd.allreduce(
            b, op=R.AVERAGE, prescale_factor=1 / 3, postscale_factor=7.0,
            mesh=m, **W),
        "min": lambda m: spmd.allreduce(x, op=R.MIN, mesh=m, **W),
        "max_i32": lambda m: spmd.allreduce(i, op=R.MAX, mesh=m, **W),
        "prod": lambda m: spmd.allreduce(b, op=R.PRODUCT, mesh=m, **W),
        "adasum": lambda m: spmd.allreduce(x, op=R.ADASUM, mesh=m, **W),
        "fp16_wire": lambda m: spmd.allreduce(
            x, op=R.SUM, compression=Compression.fp16, mesh=m, **W),
        "int8_sum": lambda m: spmd.allreduce(
            x, op=R.SUM, compression=Compression.int8, mesh=m, **W),
        "int8_avg_bf16": lambda m: spmd.allreduce(
            b, op=R.AVERAGE, compression=Compression.int8, mesh=m, **W),
        "int8_stochastic": lambda m: spmd.allreduce(
            x, op=R.SUM, compression=Compression.int8_stochastic, mesh=m,
            **W),
        "grouped_0": lambda m: spmd.grouped_allreduce(
            [x, b], op=R.AVERAGE, mesh=m, **W)[0],
        "grouped_1": lambda m: spmd.grouped_allreduce(
            [x, b], op=R.AVERAGE, mesh=m, **W)[1],
        "allgather": lambda m: spmd.allgather(b, mesh=m, **W),
        "broadcast": lambda m: spmd.broadcast(i, root_rank=0, mesh=m, **W),
        "broadcast_bool": lambda m: spmd.broadcast(bools, root_rank=0,
                                                   mesh=m, **W),
        "alltoall": lambda m: spmd.alltoall(x.reshape(-1, 17), mesh=m, **W),
        "reducescatter": lambda m: spmd.reducescatter(
            b.reshape(-1, 17), op=R.AVERAGE, mesh=m, **W),
        "barrier": lambda m: spmd.barrier("world", mesh=m),
    }


def spmd_phase(hvd, device, model, opt, x, y, smi: str) -> dict:
    """The meshes, the collectives over a one-rank mesh axis on card
    tensors against the same calls over a one-rank gloo mesh on CPU
    copies, ``allreduce_gradients`` over the 161 gradients (the eager
    plan, the eager plan under an autotuner, the world axis) against the
    optimizer's ``GroupReduction``, ``ShardedDistributedOptimizer``
    against ``torch.optim.SGD``, and ``SyncBatchNorm``."""
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F
    from torch.distributed.device_mesh import DeviceMesh

    from horovod_tpu_torch.comm import spmd
    from horovod_tpu_torch.comm.compression import Compression, NoneCompressor
    from horovod_tpu_torch.comm.reduce_ops import ReduceOp as R
    from horovod_tpu_torch.core import state as core_state
    from horovod_tpu_torch.obs.autotune import Autotuner
    from horovod_tpu_torch.torch.sync_batch_norm import _SyncBatchNormFn

    t_phase = time.perf_counter()
    out = {"card": smi}
    # the meshes, on the card
    wm = hvd.world_mesh()
    hm = hvd.hierarchical_mesh()
    pm = core_state.global_state().meshes.proc_mesh()
    nd = hvd.mesh(("dp", "tp"), (1, 1))
    for m, names in ((wm, ("world",)), (hm, ("dcn", "ici")),
                     (pm, ("proc",)), (nd, ("dp", "tp"))):
        check(m.device_type == "cuda" and m.mesh_dim_names == names,
              f"spmd: mesh {names} is {m.device_type} {m.mesh_dim_names}")
    check(hvd.num_devices() == 1 and hvd.local_devices() == [device],
          f"spmd: {hvd.num_devices()} devices, {hvd.local_devices()}")
    check(wm is hvd.world_mesh(), "spmd: the world mesh was made twice")

    # the collectives over the one-rank axis: card against CPU copies
    gen = torch.Generator(device=device).manual_seed(SEED + 16)
    xs = spread_values(SPMD_N, torch.float32, device, gen)
    bs = torch.randn(xs.numel(), generator=gen, device=device).to(
        torch.bfloat16)
    ints = torch.randint(-1000, 1000, (xs.numel(),), generator=gen,
                         device=device, dtype=torch.int32)
    bools = torch.rand(33, generator=gen, device=device) < 0.5
    cpu_group = dist.new_group([0], backend="gloo")
    cpu_mesh = DeviceMesh.from_group(cpu_group, "cpu",
                                     mesh_dim_names=("world",))
    card = _spmd_cases(spmd, R, Compression, xs, bs, ints, bools)
    host = _spmd_cases(spmd, R, Compression, xs.cpu(), bs.cpu(), ints.cpu(),
                       bools.cpu())
    held = []
    for name, call in card.items():
        got = call(wm)
        want = host[name](cpu_mesh)
        check(got.device == device, f"spmd {name}: result on {got.device}")
        check(same_bits(got.cpu(), want),
              f"spmd {name}: the card's result is not the CPU's")
        held.append(name)
    for axis, m in (("dcn", hm), ("ici", hm), ("tp", nd), ("dp", nd)):
        check(same_bits(spmd.allreduce(xs, axis_name=axis, mesh=m),
                        card["sum_f32"](wm)),
              f"spmd: the sum over axis {axis} is not the world's")
    dist.destroy_process_group(cpu_group)
    out["held_bitwise"] = held

    # allreduce_gradients over the 161 gradients of one backward
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    loss = F.cross_entropy(model(x), y)
    gs = torch.autograd.grad(loss, [p for _, p in named])
    grads = {n: g.contiguous() for (n, _), g in zip(named, gs)}
    by_param = {p: grads[n] for n, p in named}
    buckets = [[by_param[p] for p in bucket] for bucket in opt.buckets]
    red = dataclasses.replace(opt.reduction, op=R.AVERAGE, prescale=1.0,
                              postscale=1.0, compression=NoneCompressor)
    names_of = {id(by_param[p]): n for n, p in named}
    st = core_state.global_state()
    tuner = Autotuner(st.config)
    recorded = []

    def with_tuner():
        st.autotuner = tuner
        real = tuner.record_step
        tuner.record_step = lambda n: (recorded.append(n), real(n))[1]
        try:
            return hvd.allreduce_gradients(grads, op=R.AVERAGE)
        finally:
            tuner.record_step = real
            st.autotuner = None

    paths = {
        "eager": lambda: hvd.allreduce_gradients(grads, op=R.AVERAGE),
        "eager_autotune": with_tuner,
        "axis": lambda: hvd.allreduce_gradients(grads, axis_name="world",
                                                op=R.AVERAGE),
        "group_reduction": lambda: {
            names_of[id(g)]: o for b in buckets
            for g, o in zip(b, red.reduce(b))},
    }
    results = {k: fn() for k, fn in paths.items()}
    check(recorded == [sum(g.numel() * g.element_size()
                           for g in grads.values())],
          f"spmd: the autotuner recorded {recorded}")
    for k, res in results.items():
        check(list(res) == list(grads) if k != "group_reduction"
              else set(res) == set(grads), f"spmd: {k} lost the structure")
        for n in grads:
            check(same_bits(res[n], results["group_reduction"][n]),
                  f"spmd: {k} differs from GroupReduction.reduce at {n}")
    ms = {k: [] for k in paths}
    for turn in range(SPMD_TURNS):
        order = list(paths) if turn % 2 == 0 else list(paths)[::-1]
        for k in order:
            ms[k].append(_host_ms(paths[k]))
    out["gradients"] = {
        "tensors": len(grads), "bytes": recorded[0],
        "autotune_threshold": tuner.current[0],
        "host_ms_median": {k: statistics.median(v) for k, v in ms.items()},
        "host_ms": ms}

    # ShardedDistributedOptimizer against torch.optim.SGD, 3 steps
    gen2 = torch.Generator().manual_seed(SEED + 17)
    ps = [p for _, p in named]
    a = [torch.nn.Parameter(p.detach().clone()) for p in ps]
    b2 = [torch.nn.Parameter(p.detach().clone()) for p in ps]
    sharded = hvd.ShardedDistributedOptimizer(
        torch.optim.SGD, a, axis_name="world", lr=0.1, momentum=0.9)
    plain = torch.optim.SGD(b2, lr=0.1, momentum=0.9)
    step_ms = []
    for step in range(3):
        scale = float(torch.rand((), generator=gen2)) + 0.5
        for pa, pb, g in zip(a, b2, gs):
            pa.grad = g * scale
            pb.grad = pa.grad.clone()
        step_ms.append(_host_ms(sharded.step))
        plain.step()
        for pa, pb in zip(a, b2):
            check(same_bits(pa.detach(), pb.detach()),
                  f"spmd: ShardedDistributedOptimizer step {step} differs "
                  "from torch.optim.SGD")
    inner = sharded.inner.state[sharded.shard]["momentum_buffer"]
    out["sharded"] = {
        "steps": 3, "step_ms": step_ms,
        "state_bytes": inner.numel() * inner.element_size(),
        "params": sum(p.numel() for p in ps)}
    del a, b2, sharded, plain

    # SyncBatchNorm: the function on ResNet-50's first BN shape, then a
    # training step with SyncBatchNorm in place of every BatchNorm
    xb = torch.randn(SBN_SHAPE, generator=gen, device=device).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    wb = torch.randn(SBN_SHAPE[1], generator=gen, device=device)
    bb = torch.randn(SBN_SHAPE[1], generator=gen, device=device)
    dy = torch.randn(SBN_SHAPE, generator=gen, device=device).to(
        torch.bfloat16)
    errs = {}
    for tag, fn in (
            ("port", lambda xi, w, bi: _SyncBatchNormFn.apply(
                xi, w, bi, None, None, 1e-5, 0.1, None)),
            ("plain", lambda xi, w, bi: F.batch_norm(
                xi.float(), None, None, w, bi, True, 0.1, 1e-5))):
        def fwd_bwd():
            xi = xb.detach().clone().requires_grad_(True)
            w = wb.clone().requires_grad_(True)
            bi = bb.clone().requires_grad_(True)
            yo = fn(xi, w, bi)
            yo.backward(dy.to(yo.dtype))
            return yo, xi, w, bi

        fwd_bwd()                                  # warm-up
        times = [_host_ms(fwd_bwd) for _ in range(3)]
        yo, xi, w, bi = fwd_bwd()
        errs[tag] = (yo.detach().float(), xi.grad.float(), w.grad, bi.grad,
                     statistics.median(times))
    sbn = {}
    for k, (got, want) in zip(("out", "dx", "dw", "db"),
                              zip(errs["port"][:4], errs["plain"][:4])):
        diff = (got - want).abs()
        bound = SBN_RTOL * want.abs() + SBN_ATOL * want.abs().max()
        check(bool((diff <= bound).all()),
              f"spmd: _SyncBatchNormFn {k} off F.batch_norm by "
              f"{float(diff.max())}")
        sbn[f"max_abs_err_{k}"] = float(diff.max())
    sbn["ms"] = errs["port"][4]
    sbn["plain_ms"] = errs["plain"][4]
    sbn["shape"] = list(SBN_SHAPE)
    from horovod_tpu_torch.models import ResNet
    from horovod_tpu_torch.models.resnet import BatchNorm

    net = ResNet([3, 4, 6, 3], dtype=torch.bfloat16, device=device,
                 generator=torch.Generator().manual_seed(SEED))
    swapped = 0
    for parent in list(net.modules()):
        for cname, child in list(parent.named_children()):
            if isinstance(child, BatchNorm):
                new = hvd.SyncBatchNorm(child.scale.numel()).to(device)
                with torch.no_grad():
                    new.weight.copy_(child.scale)
                    new.bias.copy_(child.bias)
                setattr(parent, cname, new)
                swapped += 1
    net_opt = make_optimizer(hvd, net, hvd.Compression.fp16)
    net_opt.zero_grad()
    sloss = F.cross_entropy(net(x), y)
    sloss.backward()
    net_opt.step()
    torch.cuda.synchronize()
    loss_value = float(sloss.detach())
    check(math.isfinite(loss_value), f"spmd: SyncBatchNorm loss {loss_value}")
    sbn.update(swapped=swapped, loss=loss_value)
    out["sync_batch_norm"] = sbn
    del net, net_opt, xb, dy
    out["seconds"] = time.perf_counter() - t_phase
    log("spmd " + json.dumps(out))
    return out


# -- the hybrid-parallel transformer (parallel/*, models/transformer.py) ---

TFM_BATCH = 8             # sequences of max_seq + 1 = 2049 tokens a step
TFM_LR = 3e-3
TFM_CHECK_LAYERS = 2      # card against CPU: 2 layers, full width, float32
TFM_CHECK_BATCH = 2
TFM_LOSS_RTOL = 1e-5      # |card - cpu| / |cpu| of the loss
TFM_GRAD_RTOL = 1e-3      # max |card - cpu| / max |cpu|, each gradient
TFM_MODES = (
    # name, config keywords, make_layout keywords (sp 1: a dedicated axis)
    ("megatron_sp", {}, {}),
    ("ring", {"attn_mode": "ring"}, {"sp": 1}),
    ("ulysses", {"attn_mode": "ulysses"}, {"sp": 1}),
    ("moe", {"n_experts": 8, "capacity_factor": 2.0}, {}),
)


def _seeded(seed: int):
    import torch

    return torch.Generator().manual_seed(seed)


def _tfm_tokens(cfg, batch: int, device):
    import torch

    return torch.randint(0, cfg.vocab_size, (batch, cfg.max_seq + 1),
                         generator=_seeded(SEED + 17)).to(device)


def _tfm_relative_errors(card, cpu) -> dict:
    """max |card - cpu| / max |cpu| of every parameter's gradient."""
    cpu_grads = dict(cpu.named_parameters())
    out = {}
    for name, p in card.named_parameters():
        want = cpu_grads[name].grad
        got = p.grad.cpu()
        scale = float(want.abs().max())
        out[name] = float((got - want).abs().max()) / max(scale, 1e-30)
    return out


def transformer_phase(hvd, device, smi: str) -> dict:
    """The hybrid-parallel transformer at the full width of the
    reference's ``TransformerConfig()`` in the one-rank world: the dense
    ``megatron_sp`` model trained ``WARMUP_STEPS + TIMED_STEPS`` steps on
    one fixed batch by ``make_train_step`` (Adam), its loss finite and
    falling; one step's FLOPs by ``FlopCounterMode``; one step each of
    ring and Ulysses attention (a dedicated sp axis of 1) and of the
    Switch MoE; then, at 2 layers in float32 with TF32 off, each mode's
    loss and gradients on the card against the same call on the CPU."""
    import dataclasses as dc

    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from horovod_tpu_torch import parallel as par
    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.obs import stepprof

    t_phase = time.perf_counter()
    out = {"card": smi, "tpu_kernels_on_path": []}
    cfg = tfm.TransformerConfig()
    layout = par.make_layout()
    check(layout.mesh.device_type == device.type
          and layout.shape == {"pp": 1, "dp": 1, "tp": 1},
          f"transformer: layout {layout.mesh.device_type} {layout.shape}")
    model = tfm.Transformer(cfg, layout, generator=_seeded(SEED),
                            device=device)
    check(all(p.device == device for p in model.parameters()),
          "transformer: a parameter is off the card")
    n_params = sum(p.numel() for p in model.parameters())
    opt = torch.optim.Adam(model.parameters(), lr=TFM_LR)
    step = tfm.make_train_step(cfg, layout, opt)
    toks = _tfm_tokens(cfg, TFM_BATCH, device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for _ in range(WARMUP_STEPS + TIMED_STEPS):
        t = time.perf_counter()
        loss = step(model, toks)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        losses.append(float(loss))
    peak = torch.cuda.max_memory_allocated()
    check(all(math.isfinite(v) for v in losses),
          f"transformer: loss {losses}")
    check(losses[-1] < losses[0], f"transformer: loss did not fall {losses}")
    step_ms = statistics.median(times[WARMUP_STEPS:])
    tokens = TFM_BATCH * cfg.max_seq
    with FlopCounterMode(display=False) as counter:
        step(model, toks)
        torch.cuda.synchronize()
    flops = counter.get_total_flops()
    peak_flops = stepprof.peak_flops()
    out["dense"] = {
        "config": {k: str(v) if k == "dtype" else v
                   for k, v in dc.asdict(cfg).items()},
        "params": n_params, "batch": TFM_BATCH,
        "tokens_per_step": tokens, "losses": losses,
        "step_ms": times, "step_ms_median": step_ms,
        "tokens_per_s": tokens / (step_ms / 1e3),
        "flops_per_step": flops, "peak_tflops": peak_flops / 1e12,
        "flop_share": flops / (step_ms / 1e3) / peak_flops,
        "bound_ms": flops / peak_flops * 1e3,
        "peak_memory_bytes": peak,
    }
    del model, opt, step, loss
    torch.cuda.empty_cache()

    # the other modes at full width, one step each
    out["modes"] = {}
    for name, cfg_kw, lay_kw in TFM_MODES[1:]:
        mcfg = dc.replace(cfg, **cfg_kw)
        lay = par.make_layout(**lay_kw)
        m = tfm.Transformer(mcfg, lay, generator=_seeded(SEED),
                            device=device)
        mopt = torch.optim.Adam(m.parameters(), lr=TFM_LR)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        loss = float(tfm.make_train_step(mcfg, lay, mopt)(m, toks))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        check(math.isfinite(loss), f"transformer: {name} loss {loss}")
        out["modes"][name] = {"loss": loss, "step_ms": ms,
                              "layout": lay.shape,
                              "peak_memory_bytes":
                                  torch.cuda.max_memory_allocated()}
        del m, mopt
        torch.cuda.empty_cache()

    # card against CPU: 2 layers, full width otherwise, float32, no TF32
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out["card_vs_cpu"] = {"layers": TFM_CHECK_LAYERS,
                          "batch": TFM_CHECK_BATCH,
                          "loss_rtol": TFM_LOSS_RTOL,
                          "grad_rtol": TFM_GRAD_RTOL}
    try:
        for name, cfg_kw, lay_kw in TFM_MODES:
            ccfg = dc.replace(cfg, n_layers=TFM_CHECK_LAYERS,
                              dtype=torch.float32, **cfg_kw)
            lay = par.make_layout(**lay_kw)
            params = tfm.init_params(ccfg, _seeded(SEED + 1))
            ctoks = toks[:TFM_CHECK_BATCH]
            runs = []
            for dev in (device, torch.device("cpu")):
                m = tfm.Transformer(ccfg, lay, params=params, device=dev)
                loss = m(ctoks.to(dev))
                loss.backward()
                tfm.reduce_gradients(m)
                runs.append((m, float(loss.detach())))
            (card, card_loss), (cpu, cpu_loss) = runs
            errs = _tfm_relative_errors(card, cpu)
            loss_err = abs(card_loss - cpu_loss) / abs(cpu_loss)
            worst = max(errs, key=errs.get)
            out["card_vs_cpu"][name] = {
                "loss": card_loss, "cpu_loss": cpu_loss,
                "loss_rel_err": loss_err, "grad_rel_err": errs[worst],
                "worst_grad": worst}
            check(loss_err <= TFM_LOSS_RTOL,
                  f"transformer: {name} loss on the card {card_loss} vs "
                  f"CPU {cpu_loss} (rel {loss_err:.3g})")
            check(errs[worst] <= TFM_GRAD_RTOL,
                  f"transformer: {name} gradient {worst} rel err "
                  f"{errs[worst]:.3g} on the card vs the CPU")
            del card, cpu, runs
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    log("transformer " + json.dumps(out))
    return out


# -- the reference's other models: the benchmark trio at full width ----------

# name, input side, batch, SGD lr: bench.py:46-48 (the BENCH_MODELS trio)
# and :297 (VGG's lr)
MODEL_TRIO = (
    ("ResNet101", 224, 128, 0.1),
    ("InceptionV3", 299, 128, 0.1),
    ("VGG16", 224, 64, 0.01),
)
# one finite step each at a small batch: name, constructor keywords, side
MODEL_SMALL = (
    ("ResNet18", "ResNet18", {}, 224),
    ("ResNet34", "ResNet34", {}, 224),
    ("ResNet152", "ResNet152", {}, 224),
    ("MLP", "MLP", {}, 28),
    ("ResNet50_s2d", "ResNet50", {"stem": "s2d"}, 224),
    ("ResNet50_remat", "ResNet50", {"remat": True}, 224),
)
MODEL_SMALL_BATCH = 8
REMAT_BATCH = 64          # ResNet-50's peak memory with and without remat
# card against CPU, TF32 off: label, keywords, side, batch, mode, dtype
MODEL_CHECKS = (
    ("ResNet18", {}, 64, 4, "train", "float32"),
    ("ResNet101", {}, 64, 4, "train", "float32"),
    ("ResNet50_s2d_remat", {"stem": "s2d", "remat": True}, 64, 4, "train",
     "float32"),
    # VGG-16 at init passes a vanishing signal: its float32 gradients are
    # 4% off float64's even on the CPU, so it is held in float64
    ("VGG16", {"image_size": 64}, 64, 2, "train", "float64"),
    ("MLP", {}, 28, 8, "train", "float32"),
    # train-mode gradients of Inception are no function of the inputs in
    # float32 (tests/test_torch_port_models_inception.py): its gradients
    # are held through the running stats at 75x75, its train-mode logits
    # at 299x299 (at 75x75 its last norms see 2 values a channel)
    ("InceptionV3", {}, 75, 2, "eval", "float32"),
    ("InceptionV3", {}, 299, 2, "train_forward", "float32"),
)
MODEL_LOSS_RTOL = 1e-4    # |card - cpu| / |cpu| of the loss
MODEL_LOGITS_RTOL = 1e-3  # max |card - cpu| / max |cpu| of the logits
# max |card - cpu| / max |cpu| of each gradient: two float32 runs of a
# ReLU net differ where an activation within rounding of zero takes the
# other side of the kink (ResNet-50 s2d: 1.6e-3, block 0's projection);
# a wrong op shows at ~1 (PyTorch's channels-last avg_pool2d backward,
# models/_layers.py avg_pool_same)
MODEL_GRAD_RTOL = 1e-2
POOL_SHAPE = (2, 64, 9, 9)   # an Inception branch pool's input, NCHW


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _peak_reset(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def _peak(device) -> int:
    import torch

    return (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)


def _make_model(name: str, dtype, device, gen, **kw):
    from horovod_tpu_torch import models

    if name == "MLP":
        return models.MLP(device=device, generator=gen)
    return getattr(models, name)(dtype=dtype, device=device, generator=gen,
                                 **kw)


def _model_batch(name: str, side: int, batch: int, device, seed: int):
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    ch = 1 if name == "MLP" else 3
    classes = 10 if name == "MLP" else 1000
    x = torch.randn(batch, side, side, ch, generator=gen, device=device)
    y = torch.randint(0, classes, (batch,), generator=gen, device=device)
    return x, y


def model_step(hvd, device, name: str, side: int, batch: int, lr: float,
               ctor_kw=None):
    """(step, model, optimizer): one training step of the model in bf16
    on one fixed synthetic batch through ``hvd.DistributedOptimizer(SGD
    momentum 0.9, Compression.fp16, gradient_predivide_factor=2.0)``;
    ``step()`` returns the loss."""
    import torch
    import torch.nn.functional as F

    kw = dict(ctor_kw or {})
    if name.startswith("VGG"):
        kw["image_size"] = side
    model = _make_model(name, torch.bfloat16, device, _seeded(SEED), **kw)
    x, y = _model_batch(name, side, batch, device, SEED)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=lr, momentum=0.9),
        named_parameters=model.named_parameters(),
        compression=hvd.Compression.fp16,
        gradient_predivide_factor=PREDIVIDE)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    model.train()

    def step():
        opt.zero_grad()
        loss = F.cross_entropy(model(x), y)
        loss.backward()
        opt.step()
        return loss

    return step, model, opt


def _train_model(hvd, device, name: str, side: int, batch: int, lr: float,
                 steps: int, ctor_kw=None, flops: bool = True) -> dict:
    """``steps`` steps of ``model_step``, each synchronized; A1's launches
    counted from 0 over those steps, then one more step under
    ``FlopCounterMode``."""
    from torch.utils.flop_counter import FlopCounterMode

    from horovod_tpu_torch.ops import fused_scale_cast

    step, model, opt = model_step(hvd, device, name, side, batch, lr,
                                  ctor_kw)
    multi = sum(len(b) > 1 for b in opt.buckets)

    _peak_reset(device)
    losses, times = [], []
    fused_scale_cast.launches = 0         # the model's run starts here
    for _ in range(steps):
        t = time.perf_counter()
        loss = step()
        _sync(device)
        times.append((time.perf_counter() - t) * 1e3)
        losses.append(float(loss.detach()))
    launches = fused_scale_cast.launches  # read just after it
    peak = _peak(device)
    check(all(math.isfinite(v) for v in losses),
          f"models: {name} loss {losses}")
    check(launches == steps * 2 * multi,
          f"models: {name} {launches} A1 launches in {steps} steps, "
          f"expected {2 * multi} a step")
    out = {"batch": batch, "image": side, "lr": lr,
           "params": sum(p.numel() for p in model.parameters()),
           "losses": losses, "step_ms": times,
           "buckets": len(opt.buckets), "multi_tensor_buckets": multi,
           "a1_launches": launches, "a1_launches_per_step": launches // steps,
           "peak_memory_bytes": peak}
    if flops:
        with FlopCounterMode(display=False) as counter:
            step()
            _sync(device)
        out["flops_per_step"] = counter.get_total_flops()
    del model, opt, step
    return out


def _trio_model(hvd, device, name, side, batch, lr) -> dict:
    """The model at its benchmark batch, halved while it does not fit."""
    import torch

    from horovod_tpu_torch.obs import stepprof

    cuts = []
    while True:
        try:
            r = _train_model(hvd, device, name, side, batch, lr,
                             WARMUP_STEPS + TIMED_STEPS)
            break
        except torch.cuda.OutOfMemoryError:
            check(batch > 1, f"models: {name} does not fit at batch 1")
            cuts.append(batch)
            log(f"models: {name} batch {batch} does not fit; halved")
            batch //= 2
            _peak_reset(device)
    check(r["losses"][-1] < r["losses"][0],
          f"models: {name} loss did not fall {r['losses']}")
    step_ms = statistics.median(r["step_ms"][WARMUP_STEPS:])
    peak_flops = stepprof.peak_flops()
    r.update(cut_from=cuts, step_ms_median=step_ms,
             images_per_s=batch * len(r["step_ms"][WARMUP_STEPS:])
             / (sum(r["step_ms"][WARMUP_STEPS:]) / 1e3),
             peak_tflops=peak_flops / 1e12,
             flop_share=r["flops_per_step"] / (step_ms / 1e3) / peak_flops,
             bound_ms=r["flops_per_step"] / peak_flops * 1e3)
    return r


def _model_grads(model, x, y, mode: str):
    """(loss or logits, {name: gradient}) of one call on ``model``."""
    import torch
    import torch.nn.functional as F

    model.zero_grad()
    if mode == "train_forward":
        model.train()
        with torch.no_grad():
            return model(x).float(), {}
    model.train(mode == "train")
    loss = F.cross_entropy(model(x), y)
    loss.backward()
    return loss.detach(), {n: p.grad.detach().cpu()
                           for n, p in model.named_parameters()}


def _card_vs_cpu_errors(device, checks) -> dict:
    """Each of ``checks`` in float32 from the same seeded weights on the
    card and on the CPU: the loss (or the logits) and every gradient, as
    max |card - cpu| / max |cpu|."""
    import torch

    out = {}
    for label, kw, side, batch, mode, dtype in checks:
        name = label.split("_")[0]
        x, y = _model_batch(name, side, batch, torch.device("cpu"), SEED + 1)
        runs = []
        for dev in (device, torch.device("cpu")):
            m = _make_model(name, getattr(torch, dtype), dev,
                            _seeded(SEED + 1), **kw)
            runs.append(_model_grads(m, x.to(dev), y.to(dev), mode))
            del m
        (card, card_g), (cpu, cpu_g) = runs
        card = card.cpu()
        errs = {n: float((card_g[n] - g).abs().max()
                         / g.abs().max().clamp_min(1e-30))
                for n, g in cpu_g.items()}
        worst = max(errs, key=errs.get) if errs else None
        out[f"{label}_{mode}"] = {
            "side": side, "batch": batch, "mode": mode, "dtype": dtype,
            "loss_rel_err": float((card - cpu).abs().max()
                                  / cpu.abs().max().clamp_min(1e-30)),
            "grad_rel_err": errs.get(worst, 0.0), "worst_grad": worst}
    return out


def _card_vs_cpu(device) -> dict:
    """The gate: ``MODEL_CHECKS`` with TF32 off and cuDNN's heuristics
    picking deterministic algorithms; beside it, VGG-16's float32 errors,
    not gated."""
    import torch

    cudnn = torch.backends.cudnn
    saved = (torch.backends.cuda.matmul.allow_tf32, cudnn.allow_tf32,
             cudnn.benchmark, cudnn.deterministic)
    torch.backends.cuda.matmul.allow_tf32 = False
    cudnn.allow_tf32 = False
    cudnn.benchmark, cudnn.deterministic = False, True
    out = {"loss_rtol": MODEL_LOSS_RTOL, "logits_rtol": MODEL_LOGITS_RTOL,
           "grad_rtol": MODEL_GRAD_RTOL}
    try:
        out["gate"] = _card_vs_cpu_errors(device, MODEL_CHECKS)
        out["channels_last_pool_grad"] = _pool_errors(device)
        out["vgg_float32"] = _card_vs_cpu_errors(
            device, [c[:5] + ("float32",) for c in MODEL_CHECKS
                     if c[0] == "VGG16"])
    finally:
        (torch.backends.cuda.matmul.allow_tf32, cudnn.allow_tf32,
         cudnn.benchmark, cudnn.deterministic) = saved
    return out


def _pool_errors(device) -> dict:
    """The input gradient of a 3x3/1 ``SAME`` average pool on a
    channels-last tensor, card against CPU: PyTorch's ``avg_pool2d`` with
    ``padding=1`` (not gated; wrong on the card in torch 2.11) and the
    port's ``avg_pool_same`` (explicit ``F.pad``; gated bitwise-close)."""
    import torch
    import torch.nn.functional as F

    from horovod_tpu_torch.models import _layers

    x = torch.randn(POOL_SHAPE, generator=_seeded(SEED))
    w = torch.randn(POOL_SHAPE, generator=_seeded(SEED + 1))
    out = {}
    for label, fn in (
            ("torch_padding", lambda t: F.avg_pool2d(
                t, 3, 1, padding=1, count_include_pad=True)),
            ("avg_pool_same", _layers.avg_pool_same)):
        grads = []
        for dev in (device, torch.device("cpu")):
            t = x.to(dev).contiguous(memory_format=torch.channels_last)
            t.requires_grad_(True)
            (fn(t) * w.to(dev)).sum().backward()
            grads.append(t.grad.cpu())
        out[label] = float((grads[0] - grads[1]).abs().max()
                           / grads[1].abs().max())
    return out


def _check_card_vs_cpu(gate: dict) -> None:
    for key, r in gate.items():
        bound = (MODEL_LOGITS_RTOL if r["mode"] == "train_forward"
                 else MODEL_LOSS_RTOL)
        check(r["loss_rel_err"] <= bound,
              f"models: {key} loss/logits on the card off the CPU's by "
              f"{r['loss_rel_err']:.3g}")
        check(r["grad_rel_err"] <= MODEL_GRAD_RTOL,
              f"models: {key} gradient {r['worst_grad']} rel err "
              f"{r['grad_rel_err']:.3g} on the card vs the CPU")


def models_phase(hvd, device, smi: str) -> dict:
    """The reference's benchmark trio at full width, uncut, one card
    (``bench.py:46-48``, lr ``:297``): ResNet-101 224x224 batch 128,
    Inception V3 299x299 batch 128, VGG-16 224x224 batch 64, bf16,
    synthetic data from the seed, ``WARMUP_STEPS + TIMED_STEPS`` steps
    through ``hvd.DistributedOptimizer`` (A1 on every multi-tensor
    bucket); then one finite step of each ``MODEL_SMALL``, ResNet-50's
    peak memory with and without ``remat`` at batch 64, and the
    card-against-CPU gate."""
    import torch

    t_phase = time.perf_counter()
    out = {"card": smi, "trio": {}, "small": {}}
    for name, side, batch, lr in MODEL_TRIO:
        out["trio"][name] = _trio_model(hvd, device, name, side, batch, lr)
        _peak_reset(device)
    for label, name, kw, side in MODEL_SMALL:
        r = _train_model(hvd, device, name, side,
                         64 if name == "MLP" else MODEL_SMALL_BATCH, 0.1, 1,
                         ctor_kw=kw, flops=False)
        out["small"][label] = {k: r[k] for k in (
            "batch", "image", "params", "losses", "step_ms",
            "a1_launches", "a1_launches_per_step", "peak_memory_bytes")}
        _peak_reset(device)
    remat = {}
    for on in (False, True, False, True):
        r = _train_model(hvd, device, "ResNet50", 224, REMAT_BATCH, 0.1, 2,
                         ctor_kw={"remat": on}, flops=False)
        remat.setdefault(str(on).lower(), []).append(
            {"peak_memory_bytes": r["peak_memory_bytes"],
             "step_ms": r["step_ms"][-1], "losses": r["losses"]})
        _peak_reset(device)
    out["remat"] = {"batch": REMAT_BATCH, "turns": remat}
    check(all(t["peak_memory_bytes"] < f["peak_memory_bytes"]
              for t, f in zip(remat["true"], remat["false"])),
          f"models: remat did not lower the peak memory {remat}")
    # bitwise on the CPU (tests/test_torch_port_models.py); here cuDNN's
    # weight-gradient algorithms need not be deterministic, so the first
    # step's loss is held exact and the second within 1e-3
    check(all(t["losses"][0] == f["losses"][0]
              and abs(t["losses"][1] - f["losses"][1])
              <= 1e-3 * abs(f["losses"][1])
              for t, f in zip(remat["true"], remat["false"])),
          f"models: remat changed the losses {remat}")
    out["card_vs_cpu"] = _card_vs_cpu(device)
    out["seconds"] = time.perf_counter() - t_phase
    log("models " + json.dumps(out))
    _check_card_vs_cpu(out["card_vs_cpu"]["gate"])
    pool = out["card_vs_cpu"]["channels_last_pool_grad"]["avg_pool_same"]
    check(pool <= 1e-6, f"models: avg_pool_same's gradient on the card off "
          f"the CPU's by {pool:.3g}")
    return out


# -- the sharded checkpoint: the transformer's shards and Adam's state --------

SHARDED_CHILD_WORLD = 2
SHARDED_TIMEOUT_S = 180


def _dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*")
               if f.is_file())


def _tree_same_bits(got, want) -> bool:
    from horovod_tpu_torch.api.sharded_checkpoint import (
        _is_dtensor,
        leaves_with_path,
    )

    g, w = dict(leaves_with_path(got)), dict(leaves_with_path(want))
    if g.keys() != w.keys():
        return False
    local = lambda t: t.to_local() if _is_dtensor(t) else t  # noqa: E731
    return all(same_bits(local(g[k]).cpu(), local(w[k]).cpu()) for k in w)


def _tfm_state(cfg, layout, model, opt):
    """The model's parameters and Adam's state as trees of DTensors (the
    step counts as host leaves)."""
    from horovod_tpu_torch.models import transformer as tfm

    named = dict(model.named_parameters())
    moments = {k: tfm.global_params(
        {n: opt.state[p][k] for n, p in named.items()}, cfg, layout)
        for k in ("exp_avg", "exp_avg_sq")}
    moments["step"] = {n: opt.state[p]["step"] for n, p in named.items()}
    return tfm.global_params(model.state_dict(), cfg, layout), moments


def _zeros_like_tree(tree):
    import torch
    from torch.distributed.tensor import DTensor

    from horovod_tpu_torch.api.sharded_checkpoint import (
        _is_dtensor,
        map_with_path,
    )

    def leaf(_p, x):
        if _is_dtensor(x):
            return DTensor.from_local(torch.zeros_like(x.to_local()),
                                      x.device_mesh, x.placements,
                                      run_check=False, shape=x.shape,
                                      stride=x.stride())
        return torch.zeros_like(x)

    return map_with_path(leaf, tree)


def sharded_rank_save(world: int, rank: int, directory: str,
                      device) -> dict:
    """This rank's part of the multi-process save: the transformer's
    global init from the seed, this rank's shards at ``tp=world`` on
    ``device`` wrapped as DTensors, saved by ``ShardedCheckpointer``; the
    files and bytes this rank wrote."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import parallel as par
    from horovod_tpu_torch.models import transformer as tfm

    cfg = tfm.TransformerConfig()
    layout = par.make_layout(tp=world)
    glob = tfm.init_params(cfg, _seeded(SEED))
    local = {n: t.to(device) for n, t in
             tfm.shard_params(glob, cfg, layout).items()}
    tree = {"params": tfm.global_params(local, cfg, layout)}
    ckpt = hvd.ShardedCheckpointer(directory)
    t = time.perf_counter()
    ckpt.save(1, tree)
    save_ms = (time.perf_counter() - t) * 1e3
    mpath = Path(ckpt._step_dir(1)) / f"manifest_p{rank}.json"
    manifest = json.loads(mpath.read_text())
    return {"rank": rank, "save_ms": save_ms,
            "files": sum(len(es) for es in manifest.values()),
            "piece_bytes": sum(e["bytes"] for es in manifest.values()
                               for e in es),
            "manifest_bytes": mpath.stat().st_size,
            "device": str(tfm.flatten(tree["params"])["embed"].device)}


def sharded_child(argv) -> int:
    """``chip_smoke.py --sharded-ckpt-child WORLD RANK PORT DIR OUT``: one
    rank of the multi-process save on cuda:0, in a gloo group over a
    TCPStore on localhost (``sharded_rank_save``); its JSON to OUT."""
    import datetime

    import torch
    import torch.distributed as dist

    import horovod_tpu_torch as hvd

    world, rank, port = (int(a) for a in argv[:3])
    torch.cuda.set_device(0)
    store = dist.TCPStore("127.0.0.1", port, world, rank == 0,
                          timeout=datetime.timedelta(seconds=60))
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    hvd.init(device="cuda:0")
    try:
        result = sharded_rank_save(world, rank, argv[3],
                                   torch.device("cuda", 0))
    finally:
        hvd.shutdown()
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(argv[4], "w") as f:
        json.dump(result, f)
    return 0


def _sharded_children(tmp: Path) -> dict:
    """The 2-process save at tp=2 on cuda:0; each child's JSON."""
    directory = tmp / "sharded_tp2"
    port = _free_port()
    outs = [tmp / f"sharded_{r}.json" for r in range(SHARDED_CHILD_WORLD)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "chip_smoke.py"), "--sharded-ckpt-child",
         str(SHARDED_CHILD_WORLD), str(r), str(port), str(directory),
         str(outs[r])], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(SHARDED_CHILD_WORLD)]
    logs = []
    try:
        for r, p in enumerate(procs):
            left = SHARDED_TIMEOUT_S - (time.perf_counter() - t0)
            try:
                logs.append(p.communicate(timeout=max(left, 1))[0])
            except subprocess.TimeoutExpired:
                raise SmokeFailure(f"sharded_ckpt: child {r} timed out")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        check(p.returncode == 0, f"sharded_ckpt: child {r} exited "
              f"{p.returncode}:\n{logs[r][-3000:]}")
    return {"dir": directory, "seconds": time.perf_counter() - t0,
            "ranks": [json.loads(o.read_text()) for o in outs]}


def sharded_ckpt_phase(hvd, device, smi: str, tmp: Path) -> dict:
    """``TransformerConfig()`` uncut (bf16) with its Adam state after one
    step, as DTensors over ``make_layout()`` at one rank:
    ``ShardedTorchState.commit`` (ms, bytes), ``verify_step``, a fresh
    state's ``sync`` (every leaf bitwise), ``ShardedCheckpointer.save`` /
    ``restore`` alone; then 2 processes on cuda:0 save the transformer at
    tp=2, each writing only its shards, and this process restores their
    step onto its own layout, bitwise the global arrays."""
    import torch

    from horovod_tpu_torch import parallel as par
    from horovod_tpu_torch.models import transformer as tfm

    t_phase = time.perf_counter()
    out = {"card": smi}
    cfg = tfm.TransformerConfig()
    layout = par.make_layout()
    model = tfm.Transformer(cfg, layout, generator=_seeded(SEED),
                            device=device)
    opt = torch.optim.Adam(model.parameters(), lr=TFM_LR)
    step = tfm.make_train_step(cfg, layout, opt)
    float(step(model, _tfm_tokens(cfg, 2, device)))
    params, adam = _tfm_state(cfg, layout, model, opt)
    out["params"] = sum(p.numel() for p in model.parameters())

    saved_env = os.environ.get("HVTPU_ELASTIC_STATE_DIR")
    state_dir = tmp / "sharded_state"
    os.environ["HVTPU_ELASTIC_STATE_DIR"] = str(state_dir)
    try:
        state = hvd.elastic.ShardedTorchState(params=params, adam=adam,
                                              epoch=1)
        _sync(device)
        t = time.perf_counter()
        state.commit()
        out["commit_ms"] = (time.perf_counter() - t) * 1e3
        out["commit_bytes"] = _dir_bytes(state_dir)
        ckpt = hvd.ShardedCheckpointer(str(state_dir / "sharded"))
        t = time.perf_counter()
        ok = ckpt.verify_step(1)
        out["verify_ms"] = (time.perf_counter() - t) * 1e3
        check(ok, "sharded_ckpt: the commit does not verify")
        fresh = hvd.elastic.ShardedTorchState(
            params=_zeros_like_tree(params), adam=_zeros_like_tree(adam),
            epoch=0)
        _sync(device)
        t = time.perf_counter()
        fresh.sync()
        _sync(device)
        out["sync_ms"] = (time.perf_counter() - t) * 1e3
        check(fresh.epoch == 1 and _tree_same_bits(fresh.params, params)
              and _tree_same_bits(fresh.adam, adam),
              "sharded_ckpt: sync did not restore every leaf bitwise")
        check(all(t.to_local().device == device
                  for t in tfm.flatten(fresh.params).values()),
              "sharded_ckpt: a restored shard is off the card")
    finally:
        if saved_env is None:
            os.environ.pop("HVTPU_ELASTIC_STATE_DIR", None)
        else:
            os.environ["HVTPU_ELASTIC_STATE_DIR"] = saved_env

    tree = {"params": params, "adam": adam}
    alone = hvd.ShardedCheckpointer(str(tmp / "sharded_alone"))
    _sync(device)
    t = time.perf_counter()
    alone.save(1, tree)
    out["save_ms"] = (time.perf_counter() - t) * 1e3
    out["save_bytes"] = _dir_bytes(tmp / "sharded_alone")
    template = _zeros_like_tree(tree)
    _sync(device)
    t = time.perf_counter()
    got = alone.restore(template, step=1)
    _sync(device)
    out["restore_ms"] = (time.perf_counter() - t) * 1e3
    check(_tree_same_bits(got, tree),
          "sharded_ckpt: restore is not bitwise the saved tree")
    del model, opt, step, state, fresh, got, template, tree, params, adam
    torch.cuda.empty_cache()

    children = _sharded_children(tmp)
    ranks = children["ranks"]
    check(all(r["device"].startswith("cuda") for r in ranks),
          f"sharded_ckpt: a child's shards are off the card {ranks}")
    glob = tfm.init_params(cfg, _seeded(SEED))
    like = tfm.global_params({n: torch.zeros_like(t, device=device)
                              for n, t in tfm.flatten(glob).items()},
                             cfg, layout)
    t = time.perf_counter()
    back = hvd.ShardedCheckpointer(str(children["dir"])).restore(
        {"params": like}, step=1)["params"]
    _sync(device)
    restore_ms = (time.perf_counter() - t) * 1e3
    got = tfm.local_params(back)
    check(all(same_bits(got[n].cpu(), t)
              for n, t in tfm.flatten(glob).items()),
          "sharded_ckpt: the tp=2 step restored at one rank is not the "
          "global arrays")
    total = sum(r["piece_bytes"] for r in ranks)
    want = sum(t.numel() * t.element_size()
               for t in tfm.flatten(glob).values())
    out["tp2"] = {"ranks": ranks, "seconds": children["seconds"],
                  "piece_bytes_total": total, "array_bytes": want,
                  "restore_one_rank_ms": restore_ms}
    # each replica once: the pieces hold the arrays and .npy headers alone
    check(want <= total < want + 256 * sum(r["files"] for r in ranks),
          f"sharded_ckpt: the ranks wrote {total} bytes of pieces for "
          f"{want} bytes of arrays")
    out["seconds"] = time.perf_counter() - t_phase
    log("sharded_ckpt " + json.dumps(out))
    return out


# -- phase 7: the ring collectives A4/A5/A6 over 8 virtual ranks -----------

# -- the observability planes on the training step --------------------------

OBS_MODES = ("off", "defaults", "full")
# each mode twice, in turns
OBS_ORDER = ("off", "defaults", "full", "full", "defaults", "off")
OBS_STEPS = 3          # timed steps a turn, after one warm-up step
OBS_PROBE_OPS = 200    # hooked hvd.allreduce calls a turn (host µs an op)
OBS_PROFILE_STEPS = 3  # steps in stepprof's profile window
OBS_SLEEP_S = 0.02     # the known sleep the clock alignment is held to
OBS_ALIGN_TOL_US = 2000.0
OBS_IDLE_TOL = 0.05
# tracing off/on in turns
OBS_BURST_ORDER = (False, True, True, False, False, True, True, False)
OBS_EVENTS = 2000      # timeline begin/end pairs timed alone


def _obs_mode(hvd, mode: str, tmp: Path, k: int) -> dict:
    """Put the planes in ``mode``: ``off`` (none), ``defaults`` (the
    reference's init defaults: flight, stepprof, anomaly) or ``full``
    (defaults, timeline and trace); fails unless each plane asked for is
    active.  Returns the timeline and trace paths of a full turn."""
    from horovod_tpu_torch.core import state as core_state
    from horovod_tpu_torch.obs import anomaly, flight, stepprof, tracing

    hvd.stop_timeline()
    tracing.uninstall()
    flight.uninstall()
    anomaly.uninstall()
    stepprof.uninstall()
    stepprof.ACTIVE = False
    paths = {}
    if mode != "off":
        flight.install(rank=0, size=1, out_dir=str(tmp), sigusr2=False)
        anomaly.install(rank=0, size=1)
        stepprof.ACTIVE = True
        stepprof.install()
    if mode == "full":
        paths["timeline"] = tmp / f"timeline_{k}.json"
        paths["trace"] = tmp / f"trace_{k}"
        hvd.start_timeline(str(paths["timeline"]))
        tracing.install(str(paths["trace"]), rank=0, size=1)
    on = mode != "off"
    active = {"flight": flight.ACTIVE, "anomaly": anomaly.ACTIVE,
              "stepprof": stepprof.ACTIVE,
              "timeline": core_state.global_state().timeline is not None,
              "tracing": tracing.ACTIVE}
    want = {"flight": on, "anomaly": on, "stepprof": on,
            "timeline": mode == "full", "tracing": mode == "full"}
    check(active == want, f"obs {mode}: planes {active}, asked {want}")
    return paths


def _trace_chains(trace_dir: Path) -> dict:
    """name -> [phases of its spans..., "DONE" when its instant came] in
    the rank-0 trace file; fails unless every B has its E."""
    with open(trace_dir / "rank0.trace.json") as f:
        events = json.load(f)
    chains, depth = {}, {}
    for e in events:
        args = e.get("args") or {}
        if e.get("ph") == "B":
            chains.setdefault(args["tensor"], []).append(e["name"])
            depth[e["tid"]] = depth.get(e["tid"], 0) + 1
        elif e.get("ph") == "E":
            depth[e["tid"]] -= 1
        elif e.get("name") == "DONE":
            chains.setdefault(args["tensor"], []).append("DONE")
    check(all(v == 0 for v in depth.values()),
          f"obs: unmatched trace spans in {trace_dir}")
    return chains


def _timeline_event_us(tmp: Path) -> float:
    """Host µs one timeline event costs (a ``json.dump`` and a ``flush``
    into a file on this host's disk): OBS_EVENTS begin/end pairs."""
    from horovod_tpu_torch.obs.timeline import Timeline

    tl = Timeline(str(tmp / "events.json"))
    t0 = time.perf_counter()
    for i in range(OBS_EVENTS):
        tl.begin("probe", "NEGOTIATE_ALLREDUCE")
        tl.end("probe")
    secs = time.perf_counter() - t0
    tl.close()
    return secs / (2 * OBS_EVENTS) * 1e6


def _union_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for t0, t1 in sorted(intervals):
        if t1 <= end:
            continue
        total += t1 - max(t0, end)
        end = t1
    return total


def obs_phase(hvd, device, model, opt, x, y, smi: str, tmp: Path):
    """The observability planes on the training step of phase 3, in three
    modes in turns (every plane off; the reference's defaults; defaults
    plus timeline and trace): the optimizer's reduction of one fixed
    backward bitwise across modes, A1's launches a step, the timeline's
    spans a step, the trace merged by ``tools/hvtputrace``, images/s and
    the host µs of a hooked op; the metrics endpoint; stepprof's profile
    window (idle share, exposed comm, MFU) against the same trace read as
    ``torch_port_profile.py`` reads it, and its clock alignment against a
    known sleep; the async fp16 burst of 161 ``allreduce_async_`` with
    tracing on and off in turns."""
    import urllib.request

    import torch
    import torch.nn.functional as F
    from torch.profiler import record_function

    from horovod_tpu_torch.comm import stall
    from horovod_tpu_torch.core import state as core_state
    from horovod_tpu_torch.eager import get_controller
    from horovod_tpu_torch.models import ResNet
    from horovod_tpu_torch.obs import metrics, profile, stepprof, tracing
    from horovod_tpu_torch.ops import fused_scale_cast

    params = [p for p in model.parameters() if p.requires_grad]
    raw = [g.contiguous() for g in torch.autograd.grad(
        F.cross_entropy(model(x), y), params)]
    multi = sum(len(b) > 1 for b in opt.buckets)
    result = {"card": smi, "steps_a_turn": OBS_STEPS, "order": OBS_ORDER}

    def reduce_once():
        """The optimizer's reduction of the fixed gradients (every hook
        unfired: ``synchronize`` launches each bucket)."""
        for p, g in zip(params, raw):
            p.grad = g.clone()
        opt.synchronize()
        out = [p.grad.clone() for p in params]
        opt.zero_grad()
        # the next step() synchronizes its own backward without warning
        opt._synchronized = False
        return out

    def train_step():
        opt.zero_grad()
        F.cross_entropy(model(x), y).backward()
        opt.step()
        metrics.note_step(examples=BATCH)

    per_mode = {m: {"images_per_s": [], "launches_per_step": [],
                    "probe_us": []} for m in OBS_MODES}
    reduced, spans, merged = {}, [], []
    probe = torch.ones(1024, device=device)
    for k, mode in enumerate(OBS_ORDER):
        paths = _obs_mode(hvd, mode, tmp, k)
        reductions = 0
        if mode not in reduced:
            reduced[mode] = reduce_once()
            reductions = 1
        torch.cuda.synchronize()
        secs = []
        fused_scale_cast.launches = 0
        for step in range(1 + OBS_STEPS):
            before = fused_scale_cast.launches
            t0 = time.perf_counter()
            train_step()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            delta = fused_scale_cast.launches - before
            check(delta == 2 * multi, f"obs {mode}: {delta} A1 launches in "
                  f"step {step}, expected {2 * multi}")
        per_mode[mode]["launches_per_step"].append(delta)
        per_mode[mode]["images_per_s"].append(
            BATCH * OBS_STEPS / sum(secs[1:]))
        t0 = time.perf_counter()
        for _ in range(OBS_PROBE_OPS):
            hvd.allreduce(probe, name="obs.probe")
        torch.cuda.synchronize()
        per_mode[mode]["probe_us"].append(
            (time.perf_counter() - t0) / OBS_PROBE_OPS * 1e6)
        if mode == "full":
            hvd.stop_timeline()
            with open(paths["timeline"]) as f:
                events = json.load(f)       # parses: the file is closed
            steps = 1 + OBS_STEPS + reductions
            neg = sum(1 for e in events if e.get("ph") == "B"
                      and e["name"] == "NEGOTIATE_ALLREDUCE")
            fused = sum(1 for e in events if e.get("ph") == "B"
                        and e["name"] == "NCCL_ALLREDUCE"
                        and e["args"]["tensor"].startswith("fused."))
            spans.append({"gradient_spans": neg / steps,
                          "bucket_spans": fused / steps})
            check(neg == RESNET50_GRADS * steps and fused == multi * steps,
                  f"obs: timeline holds {neg} gradient and {fused} bucket "
                  f"spans in {steps} steps")
            tracing.uninstall()
            chains = _trace_chains(paths["trace"])
            check(all(c[-1] == "DONE" for n, c in chains.items()
                      if n.startswith("allreduce.")),
                  "obs: a gradient's trace chain has no DONE")
            run = subprocess.run(
                [sys.executable, "-m", "tools.hvtputrace", "merge",
                 str(paths["trace"])], cwd=REPO, capture_output=True,
                text=True, timeout=120)
            check(run.returncode == 0,
                  f"obs: hvtputrace merge failed: {run.stderr[-400:]}")
            with open(paths["trace"] / "merged.trace.json") as f:
                merged.append(len(json.load(f)))
    for mode in OBS_MODES[1:]:
        check(all(same_bits(a, b) for a, b in
                  zip(reduced[mode], reduced["off"])),
              f"obs {mode}: the reduced gradients differ from the "
              "planes-off ones")
    for mode, d in per_mode.items():
        d["images_per_s_median"] = statistics.median(d["images_per_s"])
        d["probe_us_median"] = statistics.median(d["probe_us"])
    result.update(modes=per_mode, reduced_bitwise=True,
                  timeline_spans_per_step=spans,
                  merged_trace_events=merged,
                  event_us=_timeline_event_us(tmp))

    # the endpoints, in the defaults mode with the watchdog armed
    _obs_mode(hvd, "defaults", tmp, len(OBS_ORDER))
    st = core_state.global_state()
    stall._make_inspector(st, st.config)
    port = metrics.start_http_server(0, addr="127.0.0.1")
    try:
        base = f"http://127.0.0.1:{port}"
        text = urllib.request.urlopen(base + "/metrics",
                                      timeout=30).read().decode()
        debug = json.loads(urllib.request.urlopen(base + "/debug",
                                                  timeout=30).read())
    finally:
        metrics.stop_http_server()
        stall.stop(st)
    for family in ("hvtpu_allreduce_total", "hvtpu_optimizer_steps_total",
                   "hvtpu_allreduce_latency_seconds_bucket"):
        check(family in text, f"obs: /metrics lacks {family}")
    check({"job", "stall", "flight", "anomaly", "stepprof",
           "controller"} <= set(debug),
          f"obs: /debug providers {sorted(debug)}")
    result["endpoints"] = {"metrics_bytes": len(text),
                           "debug": sorted(debug)}

    # stepprof: one profile window over OBS_PROFILE_STEPS steps
    flop_model = ResNet([3, 4, 6, 3], dtype=torch.bfloat16, device=device,
                        generator=torch.Generator().manual_seed(SEED))
    flops = stepprof.measured_flops(
        lambda: F.cross_entropy(flop_model(x), y).backward())
    del flop_model
    check(flops is not None and flops > 0, "obs: no FLOPs counted")
    stepprof.set_step_flops(flops)
    logdir = tmp / "stepprof"
    with stepprof.profile_window(str(logdir)) as joined:
        for _ in range(OBS_PROFILE_STEPS):
            with record_function("train_step"):
                train_step()
                torch.cuda.synchronize()
    check(joined["status"] == "ok", f"obs: stepprof join {joined}")
    events = profile.read_trace(profile.newest(str(logdir)))["traceEvents"]
    kernels = [(e["ts"], e["ts"] + e["dur"]) for e in events
               if e.get("cat") == "kernel" and "dur" in e]
    steps_us = sum(e["dur"] for e in events if e.get("name") == "train_step"
                   and e.get("cat") == "user_annotation")
    idle_tpp = 1 - _union_us(kernels) / steps_us
    step_s = joined["window_s"] / OBS_PROFILE_STEPS
    mfu = stepprof.mfu(flops, step_s)
    check(abs(joined["idle_share"] - idle_tpp) <= OBS_IDLE_TOL,
          f"obs: stepprof's idle share {joined['idle_share']:.4f} against "
          f"{idle_tpp:.4f} read as torch_port_profile.py reads it")
    check(mfu is not None, "obs: no MFU on this card")

    # the clock alignment, against a known sleep of the card
    cycles = _sleep_cycles(OBS_SLEEP_S)
    aligndir = tmp / "align"
    with stepprof.profile_window(str(aligndir)) as joined2:
        time.sleep(0.005)
        ta = time.time()
        torch.cuda._sleep(cycles)
        torch.cuda.synchronize()
        tb = time.time()
    prof = profile.load_profile(str(aligndir))
    origin = profile.marker_us(prof["doc"], stepprof.WINDOW_MARKER)
    ivs = [iv for lane in prof["planes"].values() for iv in lane]
    aligned, _shift = stepprof.align_device_intervals(
        ivs, joined2["window"][0] * 1e6, origin)
    spin = max(aligned, key=lambda iv: iv["t1_us"] - iv["t0_us"])
    lead_us, lag_us = spin["t0_us"] - ta * 1e6, tb * 1e6 - spin["t1_us"]
    check(lead_us >= -OBS_ALIGN_TOL_US and lag_us >= -OBS_ALIGN_TOL_US,
          f"obs: the sleep kernel aligned {lead_us:.0f} µs after its "
          f"launch and {lag_us:.0f} µs before its wait returned")
    result["stepprof"] = {
        "steps": OBS_PROFILE_STEPS, "window_s": joined["window_s"],
        "idle_share": joined["idle_share"],
        "idle_share_torch_port_profile": idle_tpp,
        "exposed_comm_ms_per_step":
            joined["exposed_comm_s"] / OBS_PROFILE_STEPS * 1e3,
        "overlap_fraction": joined["overlap_fraction"],
        "flops_per_step": flops, "peak_tflops": stepprof.peak_flops() / 1e12,
        "mfu": mfu, "device_planes": joined["device_planes"],
        "align": {"sleep_ms": (spin["t1_us"] - spin["t0_us"]) / 1e3,
                  "kernel": spin["op"][:60], "lead_us": lead_us,
                  "lag_us": lag_us}}

    # the async fp16 burst with tracing on and off in turns
    _obs_mode(hvd, "defaults", tmp, len(OBS_ORDER) + 1)
    grads = hook_order_grads(model, opt, x, y)
    by_name = {f"allreduce.{n}": g for n, g in grads}
    pre, post = 1.0 / PREDIVIDE, PREDIVIDE / hvd.size()
    ctrl = get_controller()
    bursts = {"off": [], "on": []}
    cycles = {"off": [], "on": []}
    outs0 = None
    for k, on in enumerate(OBS_BURST_ORDER):
        trace_dir = tmp / f"burst_trace_{k}"
        if on:
            tracing.install(str(trace_dir), rank=0, size=1)
        tensors = {n: g.clone() for n, g in by_name.items()}
        torch.cuda.synchronize()
        cycle0 = ctrl._cycle
        t0 = time.perf_counter()
        ctrl.hint_burst(len(tensors))
        handles = {n: hvd.allreduce_async_(
            t, name=n, op=hvd.Sum, compression=hvd.Compression.fp16,
            prescale_factor=pre, postscale_factor=post)
            for n, t in tensors.items()}
        outs = {n: hvd.synchronize(h) for n, h in handles.items()}
        torch.cuda.synchronize()
        bursts["on" if on else "off"].append(
            (time.perf_counter() - t0) * 1e3)
        cycles["on" if on else "off"].append(ctrl._cycle - cycle0)
        if outs0 is None:
            outs0 = outs
        check(all(same_bits(outs[n], outs0[n]) for n in by_name),
              f"obs: burst {k} (tracing {on}) differs from burst 0")
        if on:
            tracing.uninstall()
            chains = _trace_chains(trace_dir)
            for n in by_name:
                c = chains.get(n, [])
                check(c[:2] == ["NEGOTIATE", "QUEUE"] and "EXEC" in c
                      and c[-1] == "DONE",
                      f"obs: {n} traced as {c}")
    result["burst_ms"] = {m: {"runs": v, "median": statistics.median(v),
                              "cycles": cycles[m]}
                          for m, v in bursts.items()}
    _obs_mode(hvd, "off", tmp, len(OBS_ORDER) + 2)
    log("obs " + json.dumps(result))
    return result


def ring_buckets(model, x, y, ranks: int):
    """Data-parallel ResNet-50 over ``ranks`` virtual ranks: the batch in
    ``ranks`` shards, one backward each, each rank's 161 float32 gradients
    packed into one buffer."""
    import torch
    import torch.nn.functional as F

    from horovod_tpu_torch.comm.packing import pack_flat

    params = [p for p in model.parameters() if p.requires_grad]
    buckets = []
    for xs, ys in zip(x.chunk(ranks), y.chunk(ranks)):
        grads = torch.autograd.grad(F.cross_entropy(model(xs), ys), params)
        check(len(grads) == RESNET50_GRADS, "ring: ResNet-50 gradients")
        buckets.append(pack_flat(list(grads))[0])
    for b in buckets:
        check(b.dtype == torch.float32 and bool(torch.isfinite(b).all()),
              "ring: a rank's gradients are not finite float32")
    check(not torch.equal(buckets[0], buckets[1]),
          "ring: the ranks' gradients are equal")
    return buckets


RING_KERNELS = ("A4_cluster", "A5_cluster", "A6_cluster", "A4_global",
                "A5_global", "A6_global", "A4_ipc", "A5_ipc", "A6_ipc")


def _ring_counts():
    from horovod_tpu_torch.ops import ring_allgather_2d, ring_allreduce

    return {"A4_cluster": ring_allgather_2d.cluster_launches,
            "A5_cluster": ring_allreduce.cluster_launches,
            "A6_cluster": ring_allreduce.quantized_cluster_launches,
            "A4_global": ring_allgather_2d.launches,
            "A5_global": ring_allreduce.launches,
            "A6_global": ring_allreduce.quantized_launches,
            "A4_ipc": ring_allgather_2d.ipc_launches,
            "A5_ipc": ring_allreduce.ipc_launches,
            "A6_ipc": ring_allreduce.quantized_ipc_launches}


def _set_ring_counts(counts) -> None:
    from horovod_tpu_torch.ops import ring_allgather_2d, ring_allreduce

    ring_allgather_2d.cluster_launches = counts["A4_cluster"]
    ring_allreduce.cluster_launches = counts["A5_cluster"]
    ring_allreduce.quantized_cluster_launches = counts["A6_cluster"]
    ring_allgather_2d.launches = counts["A4_global"]
    ring_allreduce.launches = counts["A5_global"]
    ring_allreduce.quantized_launches = counts["A6_global"]
    ring_allgather_2d.ipc_launches = counts["A4_ipc"]
    ring_allreduce.ipc_launches = counts["A5_ipc"]
    ring_allreduce.quantized_ipc_launches = counts["A6_ipc"]


def _ring_key(kind: str, n: int) -> str:
    """The counter of the kernel that serves ``kind`` (A4, A5, A6) at
    ``n`` ranks: the wrapper's own dispatch."""
    from horovod_tpu_torch.ops.ring import kernel_route

    return f"{kind}_{kernel_route(n, kind == 'A6')}"


def _one_launch(kernel: str, fn):
    """``fn()``, checked to launch ``kernel`` once and nothing else."""
    before = _ring_counts()
    out = fn()
    after = _ring_counts()
    want = dict(before, **{kernel: before[kernel] + 1})
    check(after == want, f"ring: {kernel} call launched {after} from {before}")
    return out


def _held(outs, want, what: str) -> float:
    """Every rank's output bitwise equal to every other's and to the
    plain version's; returns the largest difference (0.0)."""
    for r, o in enumerate(outs):
        check(same_bits(o, outs[0]), f"ring: {what}: rank {r} differs "
              "from rank 0")
    check(len(outs) == len(want) and same_bits(outs[0], want[0]),
          f"ring: {what}: kernel and plain version differ")
    return max_abs_diff(outs[0], want[0])


def _ring_path(buckets, blocks, quantized: bool):
    """One path of the ring: Sum, Average, A6 when ``quantized`` and the
    all-gather, through the user's entry points, with every count set to
    0 just before and read just after."""
    import torch

    from horovod_tpu_torch.ops import ring_allgather_2d, ring_allreduce

    _set_ring_counts(dict.fromkeys(RING_KERNELS, 0))
    sums = ring_allreduce(buckets)
    avgs = ring_allreduce(buckets, average=True)
    quant = ring_allreduce(buckets, quantized=True) if quantized else None
    gathered = ring_allgather_2d(blocks)
    torch.cuda.synchronize()
    launches = _ring_counts()
    n = len(buckets)
    want = dict.fromkeys(RING_KERNELS, 0)
    want[_ring_key("A5", n)] = 2
    want[_ring_key("A4", n)] = 1
    if quantized:
        want[_ring_key("A6", n)] = 1
    check(launches == want, f"ring: {n}-rank path launched {launches}, "
          f"expected {want}")
    return sums, avgs, quant, gathered, launches


def _quantized_checks(quant, buckets, what: str):
    """A6 identical on every rank, bitwise the plain version and within
    ``2(n-1) max sum|x| / 127`` of the float64 sum; returns the largest
    difference to the plain version (0.0), the largest and mean error
    and the bound."""
    import torch

    from horovod_tpu_torch.ops import ring_allreduce_plain

    n = len(buckets)
    held = _held(quant, ring_allreduce_plain(buckets, quantized=True),
                 f"{what} A6")
    stacked = torch.stack(buckets)
    q_err = (quant[0].double() - stacked.double().sum(0)).abs()
    q_bound = 2 * (n - 1) * float(stacked.abs().double().sum(0).max()) / 127
    check(float(q_err.max()) <= q_bound,
          f"ring: {what}: A6 error {float(q_err.max())} beyond {q_bound}")
    return held, float(q_err.max()), float(q_err.mean()), q_bound


def _sum_checks(sums, avgs, buckets, what: str) -> float:
    """A5 Sum and Average bitwise the plain versions, Average bitwise
    ``sum * f32(1/n)``, the sum within ``n 2^-23 sum|x|`` of float64."""
    import torch

    from horovod_tpu_torch.ops import ring_allreduce_plain
    from horovod_tpu_torch.ops.quantize import flush

    n = len(buckets)
    err = max(_held(sums, ring_allreduce_plain(buckets), f"{what} sum"),
              _held(avgs, ring_allreduce_plain(buckets, average=True),
                    f"{what} average"))
    check(same_bits(avgs[0], flush(sums[0] * torch.tensor(
        1.0 / n, dtype=torch.float32))),
        f"ring: {what}: Average is not sum * f32(1/n)")
    stacked = torch.stack(buckets)
    exact = stacked.double().sum(0)
    magnitude = stacked.abs().double().sum(0)
    check(bool(((sums[0].double() - exact).abs()
                <= n * 2.0 ** -23 * magnitude).all()),
          f"ring: {what}: A5 beyond n * 2^-23 * sum|x| of the float64 sum")
    return err


def _rank_blocks(buckets):
    """Rank r's 1/n of its bucket as ``(CH, 128)``, zero-padded as the
    allreduce pads it."""
    import torch

    from horovod_tpu_torch.ops.ring import chunk_elems

    n, size = len(buckets), buckets[0].numel()
    e = chunk_elems(size, n)
    return [torch.nn.functional.pad(b, (0, n * e - size))[r * e:(r + 1) * e]
            .reshape(-1, 128) for r, b in enumerate(buckets)]


def _time_ring(buckets, blocks, reps: int, plain_reps: int = 2):
    """ms of A5 (Sum) and A4 through the wrappers, their plain versions,
    one library call that fills one output and the library calls that
    fill every rank's output; the last timed call of each is checked
    again."""
    import torch

    from horovod_tpu_torch.ops import (
        ring_allgather_2d,
        ring_allgather_2d_plain,
        ring_allreduce,
        ring_allreduce_plain,
    )

    n = len(buckets)
    stacked = torch.stack(buckets)
    total = torch.empty_like(buckets[0])
    sum_outs = [torch.empty_like(b) for b in buckets]
    whole = torch.cat(blocks)
    cat_outs = [torch.empty_like(whole) for _ in range(n)]

    def sum_all_ranks():
        torch.sum(stacked, 0, out=total)
        for o in sum_outs:
            o.copy_(total)

    def cat_all_ranks():
        for o in cat_outs:
            torch.cat(blocks, out=o)

    last = {}

    def timed(key, fn):
        return lambda: last.__setitem__(key, fn())

    a5 = dict(ms=time_cuda(timed("A5", lambda: ring_allreduce(buckets)),
                           reps),
              plain_ms=time_cuda(lambda: ring_allreduce_plain(buckets),
                                 plain_reps, 1),
              library_ms=time_cuda(lambda: stacked.sum(0), reps),
              library_all_ranks_ms=time_cuda(sum_all_ranks, reps))
    _held(last["A5"], ring_allreduce_plain(buckets), f"A5 n={n} after timing")
    check(same_bits(sum_outs[-1], stacked.sum(0)),
          "ring: the all-ranks library call of A5 computes another sum")
    a4 = dict(ms=time_cuda(timed("A4", lambda: ring_allgather_2d(blocks)),
                           reps),
              plain_ms=time_cuda(lambda: ring_allgather_2d_plain(blocks),
                                 plain_reps, 1),
              library_ms=time_cuda(lambda: torch.cat(blocks), reps),
              library_all_ranks_ms=time_cuda(cat_all_ranks, reps))
    _held(last["A4"], ring_allgather_2d_plain(blocks),
          f"A4 n={n} after timing")
    check(same_bits(cat_outs[-1], whole),
          "ring: the all-ranks library call of A4 is not torch.cat")
    return a4, a5


def _a6_bound(n: int, size: int):
    """A6's least bytes (each rank's input read once, its output written
    once) and its operations: a quantize (~6) and an FMA a hop and
    element, the owner's quantize and every rank's dequantize."""
    return dict(zip(("bound_ms", "bound_by"), _bound_ms(
        2 * n * size * 4, size * (6 * (n - 1) + 4) + n * size)))


def _time_a6(buckets, reps: int, plain_reps: int = 2):
    """ms of A6 through the wrapper and its plain version; the last
    timed call is checked again."""
    from horovod_tpu_torch.ops import ring_allreduce, ring_allreduce_plain

    last = {}
    a6 = dict(ms=time_cuda(lambda: last.__setitem__(
        "A6", ring_allreduce(buckets, quantized=True)), reps),
              plain_ms=time_cuda(lambda: ring_allreduce_plain(
                  buckets, quantized=True), plain_reps, 1),
              library_ms=None, library_all_ranks_ms=None)
    _held(last["A6"], ring_allreduce_plain(buckets, quantized=True),
          f"A6 n={len(buckets)} after timing")
    return dict(a6, **_a6_bound(len(buckets), buckets[0].numel()))


def _ring_bounds(n: int, size: int, e: int):
    """The least bytes of A4 and A5 (each rank's input read once, its
    output written once) and A5's float32 additions."""
    a5 = _bound_ms(2 * n * size * 4, (n - 1) * size)
    a4 = _bound_ms(n * e * 4 + n * n * e * 4, 0)
    return dict(zip(("bound_ms", "bound_by"), a4)), dict(
        zip(("bound_ms", "bound_by"), a5))


def _wide_ranks(buckets, m: int, elements: int):
    """``m`` ranks of ``elements`` gradients each, distinct slices of the
    ``n`` buckets (rank r: bucket r mod n, slice r // n), each slice at a
    16-byte aligned offset so that no wrapper copies it."""
    n = len(buckets)
    stride = -(-elements // 4) * 4
    check(-(-m // n) * stride <= buckets[0].numel(),
          f"ring: {m} ranks of {elements} do not fit the buckets")
    return [buckets[r % n][(r // n) * stride:(r // n) * stride + elements]
            for r in range(m)]


def ring_phase(buckets, reps: int):
    """The ring collectives at full width (8 ranks x 25.56 M float32
    gradients, the main path: A4, A5 and A6 on the cluster kernels),
    rings of 2 and 3 ranks, the 12-rank ring on the global-slot A4/A5/A6
    kernels (a path of its own), timing (the 12-rank kernels at half a
    bucket a rank, where the kernel and not the call around it takes the
    time), and calls back to back."""
    import torch

    from horovod_tpu_torch.ops import (
        ring_allgather_2d,
        ring_allgather_2d_plain,
        ring_allreduce,
        ring_allreduce_plain,
    )
    from horovod_tpu_torch.ops.ring import chunk_elems, cluster_info

    n, size = len(buckets), buckets[0].numel()
    e = chunk_elems(size, n)
    blocks = _rank_blocks(buckets)

    # the main path
    sums, avgs, quant, gathered, launches = _ring_path(buckets, blocks, True)
    check(all(_ring_key(k, n).endswith("_cluster")
              for k in ("A4", "A5", "A6")),
          f"ring: {n} ranks not on the cluster kernels")
    err = dict.fromkeys(RING_KERNELS, 0.0)
    err["A5_cluster"] = _sum_checks(sums, avgs, buckets, f"n={n}")
    err["A6_cluster"], a6_max, a6_mean, q_bound = _quantized_checks(
        quant, buckets, f"n={n}")
    err["A4_cluster"] = _held(gathered, ring_allgather_2d_plain(blocks), "A4")
    check(same_bits(gathered[0], torch.cat(blocks)),
          "ring: A4 is not torch.cat")
    del sums, avgs, quant, gathered
    log(f"ring: {n} ranks x {size} elements, A5 Sum/Average and A6 "
        "(cluster) identical on every rank and bitwise the plain "
        "versions, A4 (cluster) bitwise torch.cat")

    # smaller rings: n = 2 and n = 3 (not a power of two: the reciprocal
    # Average), then 3 ranks of values over 50 decades with subnormals,
    # NaN, inf and -inf; comparisons, not a path
    gen = torch.Generator(device=buckets[0].device).manual_seed(SEED + 4)
    special = [wide_values(RING_SMALL, torch.float32, buckets[0].device, gen)
               for _ in range(3)]
    special[0][5], special[1][1030], special[2][2100] = (
        math.nan, math.inf, -math.inf)
    rings = [(f"n={m}", [b[:RING_SMALL] for b in buckets[:m]])
             for m in (2, 3)] + [("special n=3", special)]
    for what, xs in rings:
        m = len(xs)
        for kind, kw in (("A5", {}), ("A5", {"average": True}),
                         ("A6", {"quantized": True})):
            key = _ring_key(kind, m)
            outs = _one_launch(key, lambda: ring_allreduce(xs, **kw))
            err[key] = max(err[key], _held(
                outs, ring_allreduce_plain(xs, **kw), f"{what} {kw}"))
        rows = RING_SMALL // 128
        bl = [x[:rows * 128].reshape(rows, 128) for x in xs]
        key = _ring_key("A4", m)
        outs = _one_launch(key, lambda: ring_allgather_2d(bl))
        err[key] = max(err[key], _held(outs, ring_allgather_2d_plain(bl),
                                       f"A4 {what}"))
        check(same_bits(outs[0], torch.cat(bl)), f"ring: A4 {what} cat")

    # the 12-rank ring: past a cluster's 8 CTAs, so A4, A5 and A6 take
    # the global-slot kernels; each rank a distinct RING_SMALL slice of
    # the gradients
    m = RING_WIDE
    wide = _wide_ranks(buckets, m, RING_SMALL)
    wide_blocks = _rank_blocks(wide)
    wsums, wavgs, wquant, wgathered, wide_launches = _ring_path(
        wide, wide_blocks, True)
    check(all(_ring_key(k, m).endswith("_global")
              for k in ("A4", "A5", "A6")),
          f"ring: {m} ranks not on the global-slot kernels")
    err["A5_global"] = _sum_checks(wsums, wavgs, wide, f"n={m}")
    err["A6_global"], wide_a6_max, _, wide_q_bound = _quantized_checks(
        wquant, wide, f"n={m}")
    err["A4_global"] = _held(wgathered, ring_allgather_2d_plain(wide_blocks),
                             f"A4 n={m}")
    check(same_bits(wgathered[0], torch.cat(wide_blocks)),
          f"ring: A4 n={m} is not torch.cat")
    del wsums, wavgs, wquant, wgathered
    log(f"ring: {m} ranks x {RING_SMALL} elements on the global-slot "
        "A4/A5/A6 kernels, identical on every rank and bitwise the plain "
        "versions")

    # timing; the last timed call of each is checked again
    saved = _ring_counts()
    a4c, a5c = _time_ring(buckets, blocks, reps)
    a6c = _time_a6(buckets, reps)
    # the 12-rank kernels: per call at RING_SMALL (launch, flag memset,
    # slot allocation and 22 handshakes a slice outweigh the bytes), then
    # at half a bucket a rank, the size the kernel's rate is read at
    wide_small_ms = {
        "A5_global": time_cuda(lambda: ring_allreduce(wide), reps),
        "A4_global": time_cuda(lambda: ring_allgather_2d(wide_blocks), reps),
        "A6_global": time_cuda(
            lambda: ring_allreduce(wide, quantized=True), reps)}
    wide_elements = size // 2 // 4 * 4
    big = _wide_ranks(buckets, m, wide_elements)
    big_blocks = _rank_blocks(big)
    a4g, a5g = _time_ring(big, big_blocks, reps)
    a6g = _time_a6(big, reps)
    del big, big_blocks
    _set_ring_counts(saved)

    we = chunk_elems(wide_elements, m)
    b4, b5 = _ring_bounds(n, size, e)
    a4c.update(b4)
    a5c.update(b5)
    wb4, wb5 = _ring_bounds(m, wide_elements, we)
    a4g.update(wb4)
    a5g.update(wb5)
    # what each ring moves besides the bound: the cluster kernels' hops
    # through distributed shared memory; the global-slot kernels' hops
    # through HBM (payload into the neighbour's slot and back out, the
    # local chunk again each reduce-scatter hop)
    dsmem_bytes = {"A5_cluster": n * 4 * e * (2 * n - 2),
                   "A4_cluster": n * 4 * e * (n - 1),
                   "A6_cluster": n * (2 * n - 2) * (e + 4 * e // 1024)}
    hbm_ring_bytes = {
        "A6_global": m * we * (8 + 2 * (m - 1) * (6 + 1 / 128)),
        "A5_global": m * 4 * we * (6 * m - 4),
        "A4_global": m * 4 * we * (2 + 3 * (m - 1))}
    config = {f"{kind}_cluster": cluster_info(kind, n)
              for kind in ("A4", "A5", "A6")}
    result = dict(ranks=n, elements=size, chunk=e, launches=launches,
                  wide_ranks=m, wide_elements=RING_SMALL,
                  wide_launches=wide_launches,
                  wide_small_ms=wide_small_ms,
                  wide_timed_elements=wide_elements, small_rings=[2, 3],
                  small_elements=RING_SMALL,
                  a6_max_err=a6_max, a6_mean_err=a6_mean,
                  a6_bound=q_bound, wide_a6_max_err=wide_a6_max,
                  wide_a6_bound=wide_q_bound, max_abs_err=err,
                  cluster_config=config, dsmem_bytes=dsmem_bytes,
                  hbm_ring_bytes=hbm_ring_bytes,
                  hbm_ring_ms={k: v / HBM_BYTES_PER_S * 1e3
                               for k, v in hbm_ring_bytes.items()},
                  A4_cluster=a4c, A5_cluster=a5c, A6_cluster=a6c,
                  A4_global=a4g, A5_global=a5g, A6_global=a6g)
    log("ring_path " + json.dumps(result))
    return result


# -- phase 7b: the rings one rank a process, processes sharing the card ------

RING_IPC_FULL = 25_557_032   # the packed ResNet-50 gradients a rank
RING_IPC_SIZES = {2: (RING_IPC_FULL, RING_SMALL), 3: (RING_SMALL,)}
RING_IPC_REPS = 3            # back-to-back calls a kind, new inputs each
RING_IPC_TIMEOUT_S = 150
RING_IPC_KINDS = ("A5_sum", "A5_average", "A6", "A4")


def _ipc_size(ring, world: int, rank: int, size: int, dev) -> dict:
    """One size of the child: each kind RING_IPC_REPS times in a row on
    this rank's card tensor (new inputs each call, no host barrier in
    between), every result held bitwise against the plain version over
    every rank's inputs, then the HVTPU_QUANTIZED_RING route; the ms of
    a call (CUDA events over the calls in a row), the plain version's
    and the library call's."""
    import torch

    from horovod_tpu_torch.comm.quantized import quantized_allreduce
    from horovod_tpu_torch.ops import (
        ring_allgather_2d_plain,
        ring_allreduce_plain,
    )
    from horovod_tpu_torch.ops.ring import chunk_elems

    gen = torch.Generator(device=dev)
    e = chunk_elems(size, world)
    rows = e // 128

    def every_rank(rep):
        """Every rank's input of call ``rep``, the same in every child."""
        gen.manual_seed(SEED + 1000 * world + 100 * rep + size % 97)
        return [spread_values(size, torch.float32, dev, gen)
                for _ in range(world)]

    xs = [every_rank(rep) for rep in range(RING_IPC_REPS)]
    blocks = [[torch.nn.functional.pad(x, (0, world * e - size))[
        r * e:(r + 1) * e].reshape(rows, 128) for r, x in enumerate(per)]
        for per in xs]
    calls = {"A5_sum": lambda k: ring.allreduce(xs[k][rank]),
             "A5_average": lambda k: ring.allreduce(xs[k][rank],
                                                    average=True),
             "A6": lambda k: ring.allreduce(xs[k][rank], quantized=True),
             "A4": lambda k: ring.allgather_2d(blocks[k][rank])}
    plains = {"A5_sum": lambda k: ring_allreduce_plain(xs[k]),
              "A5_average": lambda k: ring_allreduce_plain(
                  xs[k], average=True),
              "A6": lambda k: ring_allreduce_plain(xs[k], quantized=True),
              "A4": lambda k: ring_allgather_2d_plain(blocks[k])}
    # the buffers grow at the first call of the largest size (a device
    # sync and a barrier): one call outside the timed calls
    ring.allreduce(xs[0][rank])
    torch.cuda.synchronize()
    out = {"ms": {}, "max_abs_err": {}}
    for kind in RING_IPC_KINDS:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        got = [calls[kind](k) for k in range(RING_IPC_REPS)]
        end.record()
        end.synchronize()
        out["ms"][kind] = start.elapsed_time(end) / RING_IPC_REPS
        err = 0.0
        for k, g in enumerate(got):
            want = plains[kind](k)[rank]
            check(same_bits(g, want),
                  f"ring_ipc: {world} processes, {size} elements, {kind} "
                  f"call {k}: rank {rank} differs from the plain version")
            err = max(err, max_abs_diff(g, want))
        out["max_abs_err"][kind] = err
        del got
    # the route: quantized_allreduce over the gloo group on card tensors
    os.environ["HVTPU_QUANTIZED_RING"] = "1"
    try:
        routed = quantized_allreduce(xs[1][rank])
    finally:
        del os.environ["HVTPU_QUANTIZED_RING"]
    check(same_bits(routed, ring_allreduce_plain(xs[1], quantized=True)[0]),
          f"ring_ipc: {world} processes, {size} elements: rank {rank}'s "
          "HVTPU_QUANTIZED_RING route differs from the plain A6")
    # the same route through the collectives over a mesh axis: int8 over
    # the axis of a mesh over this gloo world, on card tensors
    out["spmd"] = _spmd_route(xs[1], rank, dev)
    if rank == 0:
        stacked = torch.stack(xs[0])
        out["plain_ms"] = {k: time_cuda(lambda: plains[k](0), 2, 1)
                           for k in RING_IPC_KINDS}
        out["library_ms"] = {"A5_sum": time_cuda(lambda: stacked.sum(0), 5),
                             "A4": time_cuda(lambda: torch.cat(blocks[0]),
                                             5)}
    return out


def _spmd_route(xs, rank: int, dev) -> dict:
    """``spmd.allreduce(compression=int8)`` along the axis of a
    ``DeviceMesh`` over this process's gloo world under
    ``HVTPU_QUANTIZED_RING=1``: bitwise the plain A6 over every rank's
    inputs; the A6 launches it made."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from horovod_tpu_torch.comm import spmd
    from horovod_tpu_torch.comm.compression import Compression
    from horovod_tpu_torch.comm.reduce_ops import ReduceOp
    from horovod_tpu_torch.ops import ring_allreduce_plain

    mesh = DeviceMesh.from_group(dist.group.WORLD, dev.type,
                                 mesh_dim_names=("world",))
    before = _ring_counts()["A6_ipc"]
    os.environ["HVTPU_QUANTIZED_RING"] = "1"
    try:
        got = spmd.allreduce(xs[rank], axis_name="world", mesh=mesh,
                             op=ReduceOp.SUM, compression=Compression.int8)
    finally:
        del os.environ["HVTPU_QUANTIZED_RING"]
    check(same_bits(got, ring_allreduce_plain(xs, quantized=True)[rank]),
          f"ring_ipc: rank {rank}'s spmd.allreduce(int8) over the mesh "
          "differs from the plain A6")
    return {"a6_launches": _ring_counts()["A6_ipc"] - before,
            "mesh": [mesh.device_type, list(mesh.mesh_dim_names)]}


def ring_ipc_child(argv) -> int:
    """``chip_smoke.py --ring-ipc-child WORLD RANK PORT OUT``: one rank of
    the ring_ipc phase on cuda:0, in a gloo group over a TCPStore on
    localhost; writes its result as JSON to OUT."""
    import datetime

    import torch
    import torch.distributed as dist

    from horovod_tpu_torch.core import state as core_state

    world, rank, port = (int(a) for a in argv[:3])
    torch.cuda.set_device(0)
    store = dist.TCPStore("127.0.0.1", port, world, rank == 0,
                          timeout=datetime.timedelta(seconds=60))
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    result = {"sizes": {}}
    try:
        ring = core_state.process_ring(None)
        for size in RING_IPC_SIZES[world]:
            _set_ring_counts(dict.fromkeys(RING_KERNELS, 0))
            part = _ipc_size(ring, world, rank, size,
                             torch.device("cuda", 0))
            torch.cuda.synchronize()
            part["launches"] = {k: v for k, v in _ring_counts().items()
                                if v}
            result["sizes"][str(size)] = part
        result.update(blocks=ring.blocks, nbytes=ring.nbytes,
                      mapped_bytes=ring.mapped_bytes, epoch=ring.epoch,
                      nslices=ring.nslices)
        core_state.close_rings()
    finally:
        dist.destroy_process_group()
    with open(argv[3], "w") as f:
        json.dump(result, f)
    return 0


def _slice_policy() -> dict:
    """How processes share the card: its compute mode and whether an MPS
    daemon serves it (its control pipe)."""
    q = subprocess.run(["nvidia-smi", "-q", "-d", "COMPUTE"],
                       capture_output=True, text=True, timeout=60).stdout
    mode = re.search(r"Compute Mode\s*:\s*(.+)", q)
    pipe = Path(os.environ.get("CUDA_MPS_PIPE_DIRECTORY", "/tmp/nvidia-mps"))
    return {"compute_mode": mode.group(1).strip() if mode else None,
            "mps_control": shutil.which("nvidia-cuda-mps-control"),
            "mps_served": (pipe / "control").exists()}


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def ring_ipc_phase(smi: str, tmp: Path) -> dict:
    """A4, A5 and A6 with one rank a process: 2, then 3 processes on
    cuda:0 (``--ring-ipc-child``), each rank's card tensors through its
    ``ProcessRing`` over a gloo group.  A child that fails, traps or
    times out fails the smoke, naming its rank."""
    policy = _slice_policy()
    worlds = {}
    for world in sorted(RING_IPC_SIZES):
        port = _free_port()
        outs = [tmp / f"ring_ipc_{world}_{r}.json" for r in range(world)]
        env = dict(os.environ)
        env.pop("HVTPU_QUANTIZED_RING", None)
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, str(REPO / "chip_smoke.py"), "--ring-ipc-child",
             str(world), str(r), str(port), str(outs[r])], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]
        logs = []
        try:
            for r, p in enumerate(procs):
                left = RING_IPC_TIMEOUT_S - (time.perf_counter() - t0)
                try:
                    logs.append(p.communicate(timeout=max(left, 1))[0])
                except subprocess.TimeoutExpired:
                    raise SmokeFailure(
                        f"ring_ipc: rank {r} of {world} processes timed out "
                        f"after {RING_IPC_TIMEOUT_S} s")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, p in enumerate(procs):
            if p.returncode != 0:
                raise SmokeFailure(
                    f"ring_ipc: rank {r} of {world} processes exited "
                    f"{p.returncode}:\n{logs[r][-3000:]}")
        worlds[world] = dict(
            seconds=time.perf_counter() - t0,
            ranks=[json.loads(o.read_text()) for o in outs])
    # every rank launched each kernel once a call of its size
    want = {"A5_ipc": 2 * RING_IPC_REPS + 1, "A6_ipc": RING_IPC_REPS + 2,
            "A4_ipc": RING_IPC_REPS}
    launches = {}
    for world, w in worlds.items():
        for r, res in enumerate(w["ranks"]):
            for size, part in res["sizes"].items():
                check(part["launches"] == want,
                      f"ring_ipc: {world} processes, {size} elements, rank "
                      f"{r} launched {part['launches']}, expected {want}")
                check(part["spmd"]["a6_launches"] == 1,
                      f"ring_ipc: {world} processes, {size} elements, rank "
                      f"{r}: spmd.allreduce(int8) launched A6 "
                      f"{part['spmd']['a6_launches']} times")
        launches[world] = {size: part["launches"] for size, part
                           in w["ranks"][0]["sizes"].items()}
    full = worlds[2]["ranks"][0]["sizes"][str(RING_IPC_FULL)]
    result = {
        "card": smi, "policy": policy,
        "time_sliced": not policy["mps_served"],
        "sizes": {w: list(RING_IPC_SIZES[w]) for w in RING_IPC_SIZES},
        "reps": RING_IPC_REPS, "launches": launches,
        "blocks": {w: [r["blocks"] for r in v["ranks"]]
                   for w, v in worlds.items()},
        "nbytes": {w: [r["nbytes"] for r in v["ranks"]]
                   for w, v in worlds.items()},
        "mapped_bytes": {w: [r["mapped_bytes"] for r in v["ranks"]]
                         for w, v in worlds.items()},
        "epoch": {w: [r["epoch"] for r in v["ranks"]]
                  for w, v in worlds.items()},
        "ms": {w: {size: [r["sizes"][size]["ms"] for r in v["ranks"]]
                   for size in v["ranks"][0]["sizes"]}
               for w, v in worlds.items()},
        "max_abs_err": {w: max(max(p["max_abs_err"].values())
                               for r in v["ranks"]
                               for p in r["sizes"].values())
                        for w, v in worlds.items()},
        "seconds": {w: v["seconds"] for w, v in worlds.items()},
        "full": full}
    log("ring_ipc " + json.dumps(result))
    return result


# -- phase 8: a small run against plain PyTorch on the CPU --------------------

def reference_phase(hvd, device):
    """2 steps of a narrow float32 ResNet through the port on the card,
    against the same steps on the CPU with the reduction written out in
    plain PyTorch (world of one: g * 1/2 -> fp16 -> float32 * 2/1)."""
    import torch
    import torch.nn.functional as F

    from horovod_tpu_torch.models import ResNet

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        gen = torch.Generator().manual_seed(SEED + 1)
        ref = ResNet([1, 1, 1, 1], num_classes=10, num_filters=8,
                     dtype=torch.float32, generator=gen)
        card = ResNet([1, 1, 1, 1], num_classes=10, num_filters=8,
                      dtype=torch.float32, device=device)
        card.load_state_dict(ref.state_dict())
        opt = make_optimizer(hvd, card, hvd.Compression.fp16)
        ref_opt = torch.optim.SGD(ref.parameters(), lr=0.1, momentum=0.9)
        dgen = torch.Generator().manual_seed(SEED + 2)
        losses = []
        for _ in range(2):
            xb = torch.randn(16, 32, 32, 3, generator=dgen)
            yb = torch.randint(0, 10, (16,), generator=dgen)
            opt.zero_grad()
            loss = F.cross_entropy(card(xb.to(device)), yb.to(device))
            loss.backward()
            opt.step()
            ref_opt.zero_grad()
            ref_loss = F.cross_entropy(ref(xb), yb)
            ref_loss.backward()
            with torch.no_grad():
                for p in ref.parameters():
                    w = (p.grad * (1.0 / PREDIVIDE)).to(torch.float16)
                    p.grad.copy_(w.to(torch.float32) * PREDIVIDE)
            ref_opt.step()
            losses.append((float(loss.detach()), float(ref_loss.detach())))
        worst = 0.0
        card_state = card.state_dict()
        for name, t in ref.state_dict().items():
            got = card_state[name].cpu()
            check(got.shape == t.shape and torch.isfinite(got).all(),
                  f"reference: {name} shape or finiteness")
            check(torch.allclose(got, t, rtol=1e-3, atol=1e-4),
                  f"reference: {name} differs from the CPU run")
            worst = max(worst, float((got - t).abs().max()))
        for got, want in losses:
            check(abs(got - want) <= 1e-3 * abs(want), "reference: loss")
        log(f"reference: narrow ResNet on the card agrees with the CPU run "
            f"(losses {losses}, max abs param diff {worst:.3g}, rtol 1e-3)")
    finally:
        torch.backends.cudnn.allow_tf32 = True


# -- the elastic phase: incarnations in child processes -----------------------

ELASTIC_IMAGES = 512      # 8 steps an epoch at batch 64
ELASTIC_EPOCHS = 2
ELASTIC_KEEP = 2          # HVTPU_CKPT_KEEP of the incarnations
# the incarnations after the uninterrupted reference: (what it does, its
# env, the exit expected); a signal named here is sent by the child to
# itself at the start of a step, after the given number of its commits
ELASTIC_GENS = (
    ("kill at the 4th commit", {"HVTPU_FAULT_SPEC": "worker.step:kill@count=4"},
     1, "hvtpu fault injection: killing rank 0"),
    ("SIGUSR1 after 6 commits", {"HVT_USR1_AFTER": "6"}, 73,
     "requesting world reset (hosts updated)"),
    ("SIGTERM notice before its first step", {"HVT_TERM_AFTER": "0"}, 79,
     "exiting 79 for a planned departure"),
    ("to the end", {}, 0, ""),
)
ELASTIC_TIMEOUT_S = 300


def _elastic_record(path: str, rec: dict, _lock=[]) -> None:
    import threading

    if not _lock:
        _lock.append(threading.Lock())
    with _lock[0]:
        with open(path, "a") as f:
            f.write(json.dumps(rec) + "\n")


def elastic_child() -> int:
    """One incarnation of the elastic phase (``chip_smoke.py
    --elastic-child``, started by :func:`elastic_phase`): full-width
    ResNet-50 (bf16, NHWC 224x224, batch 64) through
    ``DistributedOptimizer(SGD momentum 0.9, Compression.fp16,
    gradient_predivide_factor=2.0)`` under ``hvd.elastic.run``, with
    ``TorchState(model, optimizer, data=loader.state)`` over an
    ``ElasticDataLoader`` of 512 float32 images from seed 0 and a commit
    a step, deterministic.  One JSON line a step, a commit phase and a
    durable write in ``HVT_LOG``; the final state_dicts in ``HVT_OUT``."""
    import signal

    import numpy as np
    import torch
    import torch.nn.functional as F

    t_import = time.time()
    gen = int(os.environ["HVTPU_ELASTIC_GENERATION"])
    if os.environ.get("HVT_BY_GENERATION") == "1":
        # under the driver every incarnation gets the same env: this
        # generation's interruption comes from ELASTIC_GENS
        os.environ.update(ELASTIC_GENS[gen][1])
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core import durable
    from horovod_tpu_torch.data import ArraySource, ElasticDataLoader
    from horovod_tpu_torch.models import ResNet
    from horovod_tpu_torch.ops import _build, fused_scale_cast

    from horovod_tpu_torch.obs import metrics as obs_metrics

    log_path = os.environ["HVT_LOG"]
    # the last verified commit on disk before this incarnation restores
    resume = committed_step(Path(os.environ["HVTPU_ELASTIC_STATE_DIR"]))

    def record(**rec):
        _elastic_record(log_path, dict(gen=gen, **rec))

    _build.build_all()
    # a one-rank NCCL world on cuda:0, rendezvoused on the launcher's
    # coordinator (the launcher's env names no MASTER_ADDR)
    check("MASTER_ADDR" not in os.environ
          and "HVTPU_COORDINATOR_PORT" in os.environ,
          "elastic child: not started by the port's launcher")
    hvd.init()
    rdv = obs_metrics.snapshot()["hvtpu_rendezvous_seconds"]["values"][""]
    device = hvd.device()
    check(device.type == "cuda", f"elastic child on {device}")
    model = ResNet([3, 4, 6, 3], dtype=torch.bfloat16, device=device,
                   generator=torch.Generator().manual_seed(SEED))
    opt = make_optimizer(hvd, model, hvd.Compression.fp16)
    rng = np.random.default_rng(SEED)
    source = ArraySource({
        "x": rng.standard_normal((ELASTIC_IMAGES, IMAGE, IMAGE, 3),
                                 dtype=np.float32),
        "y": rng.integers(0, 1000, size=(ELASTIC_IMAGES,))})
    loader = ElasticDataLoader(source, BATCH, seed=SEED, with_indices=True)
    state = hvd.elastic.TorchState(model, opt, data=loader.state)

    inner = {}

    def timed(name, fn):
        def wrapper(*a, **kw):
            torch.cuda.synchronize(device)
            t = time.perf_counter()
            if name not in ("memory", "submit"):
                inner.clear()
            out = fn(*a, **kw)
            torch.cuda.synchronize(device)
            ms = (time.perf_counter() - t) * 1e3
            if name in ("memory", "submit"):
                inner[name] = ms
            else:
                record(kind=name, ms=ms, memory_ms=inner.get("memory"),
                       submit_ms=inner.get("submit", 0.0))
            return out
        return wrapper

    # the commit's parts on the training thread: save() is the in-memory
    # snapshot (the state_dicts copied on the card), the copy to the host
    # and torch.save, then the hand-over to the writer (which waits while
    # its queue is full); the write itself runs on the writer thread
    state.save_to_memory = timed("memory", state.save_to_memory)
    state.save = timed("save", state.save)
    state.sync = timed("sync", state.sync)
    durable.DurableWriter.submit = timed("submit",
                                         durable.DurableWriter.submit)
    write = durable.write_snapshot

    def timed_write(root, seq, files, **kw):
        t = time.perf_counter()
        out = write(root, seq, files, **kw)
        record(kind="write", seq=seq, ms=(time.perf_counter() - t) * 1e3,
               bytes=sum(len(v) for v in files.values()))
        return out

    durable.write_snapshot = timed_write
    signals = {int(os.environ.get(f"HVT_{name}_AFTER", "-1")): sig
               for name, sig in (("USR1", signal.SIGUSR1),
                                 ("TERM", signal.SIGTERM))}
    spe = ELASTIC_IMAGES // BATCH
    commits = [0]
    # a slower job (the fleet's cancelled one): seconds after each commit
    step_sleep = float(os.environ.get("HVT_STEP_SLEEP", "0"))
    record(kind="start", t_import=t_import, resume=resume,
           rendezvous_s=rdv["sum"])

    @hvd.elastic.run
    def train(state):
        while loader.state.epoch < ELASTIC_EPOCHS:
            start = loader.state.state_dict()
            for idx, batch in loader:
                if commits[0] in signals:
                    os.kill(os.getpid(), signals.pop(commits[0]))
                if not commits[0]:
                    record(kind="first_step", t=time.time())
                x, y = batch["x"], batch["y"]
                before = fused_scale_cast.launches
                opt.zero_grad()
                loss = F.cross_entropy(model(x), y)
                loss.backward()
                opt.step()
                torch.cuda.synchronize(device)
                # the training loop's progress for the metrics (and a
                # fleet job's health summary: its steps and step rate)
                obs_metrics.note_step(examples=BATCH)
                record(kind="step", step=loader.state.epoch * spe
                       + loader.state.cursor // BATCH,
                       epoch=loader.state.epoch,
                       idx=[int(i) for i in idx], start=start,
                       a1=fused_scale_cast.launches - before,
                       device=[str(x.device), str(y.device)],
                       loss=float(loss.detach()), t=time.time())
                start = None
                state.commit()
                commits[0] += 1
                time.sleep(step_sleep)

    fused_scale_cast.launches = 0       # this incarnation's path starts here
    train(state)
    torch.save({"model": {k: v.cpu() for k, v in model.state_dict().items()},
                "momentum": [opt.state[p]["momentum_buffer"].cpu()
                             for p in model.parameters()]},
               os.environ["HVT_OUT"])
    state.wait_durable()
    hvd.shutdown()
    return 0


LAUNCHER = ("-m", "horovod_tpu_torch.runner")
ELASTIC_POLL_S = 0.1      # the driver's discovery interval


def _launch(argv, extra_env: dict, cwd: Path, timeout: float):
    """``python -m horovod_tpu_torch.runner ARGV`` with this process's
    env less ``MASTER_ADDR`` / ``MASTER_PORT`` (so the rendezvous can
    only be the launcher's) plus ``extra_env``; returns the finished
    process and its wall start."""
    env = dict(os.environ)
    for k in ("MASTER_ADDR", "MASTER_PORT", "HVTPU_FAULT_SPEC",
              "HVT_USR1_AFTER", "HVT_TERM_AFTER"):
        env.pop(k, None)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    env.update(extra_env)
    t0 = time.time()
    proc = subprocess.run([sys.executable, *LAUNCHER, *argv], env=env,
                          cwd=str(cwd), capture_output=True, text=True,
                          timeout=timeout)
    return proc, t0


def _child_env(tmp: Path, name: str) -> dict:
    return {"HVTPU_ELASTIC_STATE_DIR": str(tmp / f"state_{name}"),
            "HVTPU_CKPT_KEEP": str(ELASTIC_KEEP),
            "CUBLAS_WORKSPACE_CONFIG": ":4096:8",
            "HVTPU_FLIGHT_DIR": str(tmp),
            "HVT_LOG": str(tmp / f"{name}.jsonl"),
            "HVT_OUT": str(tmp / f"{name}.pt")}


def _driver_ends(stderr: str) -> list:
    """(outcome, exits, wall time) of every incarnation, from the
    driver's ``--verbose`` lines."""
    return [(m.group(1), json.loads(m.group(2)), float(m.group(3)))
            for m in re.finditer(
                r"generation \d+ ended: (\w+), exits (\[[^\]]*\]), at "
                r"wall ([\d.]+)", stderr)]


def committed_step(state_dir: Path) -> int:
    """The step of the last verified commit under ``state_dir`` (0 when
    none), read from the loader state it holds.  A commit's seq is not
    its step: a commit torn by a kill leaves its seq behind."""
    import io

    import torch

    from horovod_tpu_torch.core import durable
    from horovod_tpu_torch.elastic.state import STATE_FILE

    seq = durable.latest_verified(str(state_dir))
    if seq is None:
        return 0
    payload = torch.load(
        io.BytesIO(durable.read_snapshot(str(state_dir), seq)[STATE_FILE]),
        map_location="cpu", weights_only=False)
    data = payload["__sd__data"]
    return data["epoch"] * (ELASTIC_IMAGES // BATCH) + data["cursor"] // BATCH


def _median(xs):
    return statistics.median(xs) if xs else None


def elastic_phase(smi: str, tmp: Path) -> dict:
    """The elastic path on the card, every child started by the port's
    launcher: one uninterrupted run of the 16 steps (a static ``-np 1``
    launch), then incarnations 0-3 of the same run (a kill, a host
    update, a preemption drain, the end) on one state dir under one
    elastic driver (``--host-discovery-script`` printing
    ``localhost:1``), which relaunches after each; the gates of the
    module's docstring, and one ``elastic {...}`` line.  Returns it with
    the driver's facts for the ``launcher`` line."""
    import torch

    from horovod_tpu_torch.core import durable
    from horovod_tpu_torch.data import epoch_permutation

    torch.cuda.empty_cache()
    tmp = tmp / "elastic"
    tmp.mkdir()
    child = ["--", sys.executable, str(Path(__file__).resolve()),
             "--elastic-child"]
    plain, plain_t0 = _launch(
        ["-np", "1", *child],
        dict(_child_env(tmp, "plain"), HVTPU_ELASTIC="1",
             HVTPU_ELASTIC_GENERATION="0"), tmp, ELASTIC_TIMEOUT_S)
    check(plain.returncode == 0, f"elastic: the uninterrupted run exited "
          f"{plain.returncode}:\n{plain.stderr[-3000:]}")
    discover = tmp / "discover.sh"
    discover.write_text("#!/bin/sh\necho localhost:1\n")
    discover.chmod(0o755)
    driver, driver_t0 = _launch(
        ["--host-discovery-script", str(discover), "--min-np", "1",
         "--max-np", "1", "--verbose", *child],
        dict(_child_env(tmp, "elastic"), HVT_BY_GENERATION="1",
             HVTPU_ELASTIC_DISCOVERY_INTERVAL=str(ELASTIC_POLL_S)),
        tmp, ELASTIC_TIMEOUT_S * len(ELASTIC_GENS))
    ends = _driver_ends(driver.stderr)
    want_ends = [("restart", [1]), ("reset", [73]), ("drain", [79]),
                 ("done", [0])]
    check(driver.returncode == 0 and [e[:2] for e in ends] == want_ends,
          f"elastic: the driver exited {driver.returncode} after "
          f"{[e[:2] for e in ends]}, expected 0 after {want_ends}:\n"
          f"{driver.stderr[-4000:]}")
    for gen, (what, _env, _code, says) in enumerate(ELASTIC_GENS):
        check(says in driver.stderr, f"elastic: incarnation {gen} "
              f"({what}) did not say {says!r}:\n{driver.stderr[-4000:]}")
    charged = [int(n) for n in re.findall(
        r"relaunch charged to the restart budget \((\d+) charged\)",
        driver.stderr)]
    # the kill is charged; the reset (exit 73, no crash beside it) and the
    # drain (exit 79) are not
    check(charged == [1], f"elastic: the driver charged {charged}")

    def records(path):
        with open(path) as f:
            return [json.loads(line) for line in f]

    spe = ELASTIC_IMAGES // BATCH
    total = spe * ELASTIC_EPOCHS
    ref_recs = records(tmp / "plain.jsonl")
    recs = records(tmp / "elastic.jsonl")
    ref_final = torch.load(tmp / "plain.pt")
    final = torch.load(tmp / "elastic.pt")
    # final state bitwise the uninterrupted run's
    for k, t in ref_final["model"].items():
        check(torch.equal(final["model"][k], t),
              f"elastic: {k} differs from the uninterrupted run")
    check(len(final["momentum"]) == len(ref_final["momentum"]) and all(
        torch.equal(a, b) for a, b in zip(final["momentum"],
                                          ref_final["momentum"])),
        "elastic: momentum buffers differ from the uninterrupted run")
    for r in ref_recs + recs:
        if r["kind"] == "step":
            check(r["a1"] == 4, f"elastic: gen {r['gen']} step {r['step']} "
                  f"ran {r['a1']} A1 launches, expected 4")
            check(r["device"] == ["cuda:0", "cuda:0"],
                  f"elastic: a batch on {r['device']}")
    starts = {r["gen"]: r for r in recs if r["kind"] == "start"}
    check(sorted(starts) == list(range(len(ELASTIC_GENS))),
          f"elastic: incarnations {sorted(starts)} started")
    # each incarnation starts at the last verified commit
    resumes = [starts[g]["resume"] for g in range(len(ELASTIC_GENS))]
    steps = {g: [r for r in recs if r["kind"] == "step" and r["gen"] == g]
             for g in range(len(ELASTIC_GENS))}
    for g, resume in enumerate(resumes):
        check(steps[g] and steps[g][0]["step"] == resume + 1,
              f"elastic: incarnation {g} started at step "
              f"{steps[g][0]['step'] if steps[g] else None}, its last "
              f"verified commit is {resume}")
        check(steps[g][0]["start"] == {
            "epoch": resume // spe, "cursor": resume % spe * BATCH,
            "seed": SEED}, f"elastic: incarnation {g} loader state "
            f"{steps[g][0]['start']}")
    # the drain lost no step: the next incarnation resumed at the commit
    drained = steps[2][-1]["step"]
    check(resumes[3] == drained, f"elastic: drained at step {drained}, "
          f"relaunched from {resumes[3]}")
    # the committed steps' samples cover each epoch's permutation once
    committed = {}
    for g, recs_g in steps.items():
        upto = resumes[g + 1] if g + 1 < len(resumes) else total
        for r in recs_g:
            if r["step"] <= upto:
                check(committed.setdefault(r["step"], r["idx"]) == r["idx"],
                      f"elastic: step {r['step']} drew other samples again")
    check(sorted(committed) == list(range(1, total + 1)),
          f"elastic: committed steps {sorted(committed)}")
    for e in range(ELASTIC_EPOCHS):
        ids = [i for s in range(e * spe + 1, (e + 1) * spe + 1)
               for i in committed[s]]
        check(ids == epoch_permutation(ELASTIC_IMAGES, SEED, e).tolist(),
              f"elastic: epoch {e} samples are not its permutation once")
    # every snapshot on disk verifies; the retention holds
    for name in ("plain", "elastic"):
        d = tmp / f"state_{name}"
        seqs = durable.list_snapshots(str(d))
        check(0 < len(seqs) <= ELASTIC_KEEP and committed_step(d) == total,
              f"elastic: snapshots {seqs} under {d.name}")
        for s in seqs:
            check(durable.verify_snapshot(durable.snapshot_path(str(d), s)),
                  f"elastic: snapshot {s} under {d.name} fails verification")

    def kind(rs, k, key="ms"):
        return [r[key] for r in rs if r["kind"] == k]

    def first(rs, k):
        return next(r for r in rs if r["kind"] == k)

    # a child's seconds to its first step and to its imports, counted
    # from its launcher's start (the uninterrupted run, incarnation 0)
    # or from the wall time the driver saw the previous incarnation end
    # (incarnations 1-3: the relaunch, at most one poll after the exit)
    since = [plain_t0, driver_t0] + [e[2] for e in ends[:-1]]
    children = [ref_recs] + [[r for r in recs if r["gen"] == g]
                             for g in range(len(ELASTIC_GENS))]
    first_step_s = [first(c, "first_step")["t"] - t0
                    for c, t0 in zip(children, since)]
    import_s = [first(c, "start")["t_import"] - t0
                for c, t0 in zip(children, since)]
    every = ref_recs + recs
    saves = [r for r in every if r["kind"] == "save"]
    writes = kind(every, "write")
    result = {
        "card": smi,
        "exits": [plain.returncode] + [e[1][0] for e in ends],
        "resumed_from": resumes,
        "steps_per_incarnation": [len(steps[g]) for g in steps],
        "notice": "SIGTERM sent by the child to itself before its first "
                  "step (handler on the main thread)",
        "a1_launches_per_step": sorted({r["a1"] for r in every
                                        if r["kind"] == "step"}),
        "a1_launches": sum(kind(every, "step", "a1")),
        # by entry point: the static launch (the uninterrupted run) and
        # the elastic driver (incarnations 0-3)
        "a1_launches_by_launcher": {
            "static": sum(kind(ref_recs, "step", "a1")),
            "driver": sum(kind(recs, "step", "a1"))},
        "memory_commit_ms": _median([r["memory_ms"] for r in saves]),
        # save() minus its in-memory snapshot: the copy to the host,
        # torch.save and the hand-over on the training thread; the last
        # alone (submit_ms: waiting for room in the writer's queue)
        "durable_thread_ms": _median([r["ms"] - r["memory_ms"]
                                      for r in saves]),
        "serialize_ms": _median([r["ms"] - r["memory_ms"] - r["submit_ms"]
                                 for r in saves]),
        "submit_ms": _median([r["submit_ms"] for r in saves]),
        "writer_ms": _median(writes),
        "commits": len(saves),
        "snapshot_bytes": _median(kind(every, "write", "bytes")),
        "sync_ms": kind([r for r in recs if r["gen"] > 0], "sync"),
        "first_step_s": first_step_s,
        "import_s": import_s,
        "losses": [r["loss"] for r in ref_recs if r["kind"] == "step"],
    }
    log("elastic " + json.dumps(result))
    return dict(result, launcher={
        "rendezvous_s": first(ref_recs, "start")["rendezvous_s"],
        "rendezvous_s_by_incarnation": [
            first(c, "start")["rendezvous_s"] for c in children[1:]],
        "relaunch_s": first_step_s[2:],
        "driver_exits": [e[1] for e in ends],
        "driver_outcomes": [e[0] for e in ends],
        "charged_restarts": charged[-1],
        "poll_s": ELASTIC_POLL_S})


# -- the fleet phase: jobs of the port's fleet arbiter ---------------------------

FLEET_CLI = ("-m", "horovod_tpu_torch.fleet")
FLEET_TICK_S = 0.2
FLEET_TIMEOUT_S = 300     # a serve of card jobs, and the CPU shrink
FLEET_CANCEL_AFTER = 2    # gone's verified commits before its cancel
# gone sleeps this long after each commit, so that the cancel (a CLI
# process: its torch import alone takes seconds) lands mid-run
FLEET_GONE_SLEEP_S = 2.0
FLEET_WARMUP = 2          # steps of a job left out of its images/s
# the planned shrink on CPU workers (tests/torch_port_fleet_data_script.py):
# lo at 2-4 ranks, 2 epochs of 32 samples, 2 a rank a step; hi at 2 ranks,
# one epoch of 8
SHRINK_LO = {"ELASTIC_EPOCHS": "2", "DATA_SAMPLES": "32", "DATA_BATCH": "2",
             "EPOCH_SLEEP": "0.4"}
SHRINK_HI = {"ELASTIC_EPOCHS": "1", "DATA_SAMPLES": "8", "DATA_BATCH": "2",
             "EPOCH_SLEEP": "0.1"}


def _fleet_env() -> dict:
    """This process's env less the rendezvous and the elastic phase's
    interruptions, with the repo on ``PYTHONPATH``."""
    env = dict(os.environ)
    for k in ("MASTER_ADDR", "MASTER_PORT", "HVTPU_FAULT_SPEC",
              "HVT_USR1_AFTER", "HVT_TERM_AFTER", "HVT_BY_GENERATION"):
        env.pop(k, None)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    return env


def _fleet_cli(fleet_dir: Path, *argv: str):
    return subprocess.run(
        [sys.executable, *FLEET_CLI, "--fleet-dir", str(fleet_dir), *argv],
        env=_fleet_env(), cwd=str(REPO), capture_output=True, text=True,
        timeout=120)


def _card_job(tmp: Path, name: str, priority: int) -> dict:
    """A fleet job of one rank running ``chip_smoke.py --elastic-child``
    (the elastic phase's uninterrupted run); its state dir is the
    runner's own (``jobs/<name>/state``), so the child's env names none."""
    env = {k: v for k, v in _child_env(tmp, name).items()
           if k != "HVTPU_ELASTIC_STATE_DIR"}
    env["HVTPU_HEALTH_INTERVAL_S"] = "1"
    return {"name": name, "priority": priority, "min_np": 1, "max_np": 1,
            "max_restarts": 0, "env": env,
            "command": [sys.executable, str(Path(__file__).resolve()),
                        "--elastic-child"]}


def _submit(fleet_dir: Path, spec: dict) -> float:
    """``submit --spec``; returns the wall time it was called."""
    path = fleet_dir.parent / f"{spec['name']}.spec.json"
    path.write_text(json.dumps(spec))
    t = time.time()
    proc = _fleet_cli(fleet_dir, "submit", "--spec", str(path))
    check(proc.returncode == 0
          and f"submitted {spec['name']!r}" in proc.stdout,
          f"fleet: submit {spec['name']} exited {proc.returncode}:\n"
          f"{proc.stdout}{proc.stderr[-2000:]}")
    return t


class _Serve:
    """``python -m horovod_tpu_torch.fleet serve --until-idle`` over a
    discovery script, each line of its output stamped with the wall time
    it arrived (the arbiter's events on stdout, the drivers' on
    stderr)."""

    def __init__(self, fleet_dir: Path, discover: Path):
        import threading

        self.fleet_dir = fleet_dir
        self.proc = subprocess.Popen(
            [sys.executable, *FLEET_CLI, "--fleet-dir", str(fleet_dir),
             "serve", "--host-discovery-script", str(discover), "--tick",
             str(FLEET_TICK_S), "--until-idle"],
            env=_fleet_env(), cwd=str(REPO), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, start_new_session=True)
        self.out, self.err = [], []
        self._pumps = [threading.Thread(target=self._pump, args=a,
                                        daemon=True)
                       for a in ((self.proc.stdout, self.out),
                                 (self.proc.stderr, self.err))]
        for t in self._pumps:
            t.start()
        self.deadline = time.time() + FLEET_TIMEOUT_S

    @staticmethod
    def _pump(stream, lines):
        for line in stream:
            lines.append((time.time(), line.rstrip("\n")))

    def running(self) -> bool:
        if self.proc.poll() is not None:
            return False
        if time.time() > self.deadline:
            import signal

            os.killpg(self.proc.pid, signal.SIGKILL)
            self.proc.wait()
            raise SmokeFailure(f"fleet: serve ran past {FLEET_TIMEOUT_S} s:"
                               f"\n{self.stderr()[-4000:]}")
        return True

    def finish(self) -> int:
        rc = self.proc.wait()
        for t in self._pumps:
            t.join(10)
        return rc

    def state(self):
        try:
            with open(self.fleet_dir / "state.json") as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def events(self, kind: str) -> list:
        """(wall time, fields) of each ``hvtpu.fleet: <kind> k=v ...``"""
        out = []
        for t, line in self.out:
            m = re.match(r"hvtpu\.fleet: (\w+)(.*)", line)
            if m and m.group(1) == kind:
                out.append((t, dict(kv.partition("=")[::2]
                                    for kv in m.group(2).split())))
        return out

    def stderr(self) -> str:
        return "\n".join(line for _, line in self.err)


def _job_rows(state) -> dict:
    return {j["name"]: j for j in (state or {}).get("jobs", [])}


def _card_run(tmp: Path, discover: Path) -> dict:
    """``lo`` (priority 0) then ``hi`` (priority 10) submitted, one
    ``serve`` over ``localhost:1``: hi runs first, lo waits PENDING."""
    fleet_dir = tmp / "fleet_card"
    submitted = {name: _submit(fleet_dir, _card_job(tmp, name, pri))
                 for name, pri in (("lo", 0), ("hi", 10))}
    serve = _Serve(fleet_dir, discover)
    seen = []                   # (wall, {job: state}) of every state.json
    while serve.running():
        rows = _job_rows(serve.state())
        if rows and (not seen or seen[-1][1] != {
                n: r["state"] for n, r in rows.items()}):
            seen.append((time.time(), {n: r["state"]
                                       for n, r in rows.items()}))
        time.sleep(0.1)
    rc = serve.finish()
    return {"rc": rc, "serve": serve, "seen": seen, "submitted": submitted,
            "rows": _job_rows(serve.state())}


def _cancel_run(tmp: Path, discover: Path) -> dict:
    """``gone`` alone under a serve of its own; ``cancel gone`` once it
    has ``FLEET_CANCEL_AFTER`` verified commits."""
    fleet_dir = tmp / "fleet_cancel"
    spec = _card_job(tmp, "gone", 0)
    spec["env"]["HVT_STEP_SLEEP"] = str(FLEET_GONE_SLEEP_S)
    _submit(fleet_dir, spec)
    serve = _Serve(fleet_dir, discover)
    state_dir = fleet_dir / "jobs" / "gone" / "state"
    log_path = tmp / "gone.jsonl"
    cancel_t = cancel_cli_s = committed_at_cancel = None
    while serve.running():
        if cancel_t is None and log_path.exists():
            writes = sum(1 for line in log_path.read_text().splitlines()
                         if json.loads(line)["kind"] == "write")
            if writes >= FLEET_CANCEL_AFTER:
                committed_at_cancel = committed_step(state_dir)
                if committed_at_cancel >= FLEET_CANCEL_AFTER:
                    t = time.time()
                    proc = _fleet_cli(fleet_dir, "cancel", "gone")
                    check(proc.returncode == 0, f"fleet: cancel exited "
                          f"{proc.returncode}: {proc.stderr[-2000:]}")
                    # the record is in the journal when the CLI returns
                    cancel_t = time.time()
                    cancel_cli_s = cancel_t - t
        time.sleep(0.1)
    rc = serve.finish()
    return {"rc": rc, "serve": serve, "cancel_t": cancel_t,
            "cancel_cli_s": cancel_cli_s,
            "committed_at_cancel": committed_at_cancel,
            "committed_final": committed_step(state_dir),
            "rows": _job_rows(serve.state())}


class _StaticPool:
    def __init__(self, hosts: dict):
        self.hosts = dict(hosts)

    def find_available_hosts_and_slots(self) -> dict:
        return dict(self.hosts)


def _deliveries(path: Path, epochs: int, samples: int, what: str) -> list:
    """The world sizes of a job's DELIVER lines; fails unless every
    sample of every epoch was delivered exactly once."""
    per_epoch = {e: [] for e in range(epochs)}
    sizes = set()
    for m in re.finditer(r"DELIVER rank=\d+ size=(\d+) gen=\d+ epoch=(\d+) "
                         r"idx=\[([0-9, ]*)\]", path.read_text()):
        sizes.add(int(m.group(1)))
        per_epoch[int(m.group(2))].extend(
            int(v) for v in m.group(3).split(",") if v.strip())
    for e in range(epochs):
        check(sorted(per_epoch[e]) == list(range(samples)),
              f"fleet shrink: {what} epoch {e} delivered "
              f"{sorted(per_epoch[e])}, not each of {samples} once")
    return sorted(sizes)


def _shrink_run(tmp: Path) -> dict:
    """The planned shrink past one rank, on CPU workers (NCCL takes one
    rank of a communicator a card): ``lo`` (2-4 ranks) holds the whole
    ``localhost:4`` pool, ``hi`` (2 ranks, priority 10) arrives once lo
    delivered a batch, and the arbiter drains lo's ranks 2 and 3
    through their notice files; ``max_restarts=0`` in both."""
    import signal

    from horovod_tpu_torch import fleet

    script = REPO / "tests" / "torch_port_fleet_data_script.py"
    check(script.is_file(), f"fleet shrink: {script} is missing")
    tmp = tmp / "shrink"
    tmp.mkdir()
    ends, launches, events = [], [], []

    def factory(job):
        h = fleet.ElasticJobRunner(job, str(tmp / "jobs"))
        drv, inner = h._driver, h._driver.listener

        def spy(event, info):
            if event == "launch":
                launches.append((job.name, info["size"], time.time()))
            elif event == "incarnation_end":
                ends.append((job.name, info["outcome"],
                             {w.rank: w.poll() for w in drv._workers}))
            inner(event, info)

        drv.listener = spy
        return h

    def job_env(name, extra):
        return dict(extra, HVTPU_CPU_DEVICES="1", PYTHONPATH=str(REPO),
                    FLEET_DELIVER_LOG=str(tmp / f"{name}.deliver"),
                    HVTPU_ELASTIC_DISCOVERY_INTERVAL="0.2")

    arb = fleet.FleetArbiter(
        _StaticPool({"localhost": 4}), fleet_dir=str(tmp / "fleet"),
        tick_s=FLEET_TICK_S, drain_grace_s=60.0, runner_factory=factory,
        event_fn=lambda kind, **f: events.append((kind, f, time.time())),
        register_debug=False)
    lo = arb.submit(fleet.JobSpec(
        "lo", [sys.executable, str(script)], priority=0, min_np=2,
        max_np=4, max_restarts=0, env=job_env("lo", SHRINK_LO)))
    hi = hi_t = None
    deadline = time.time() + FLEET_TIMEOUT_S
    try:
        while time.time() < deadline and not arb.all_terminal():
            arb.tick()
            lo_log = tmp / "lo.deliver"
            if hi is None and lo_log.exists() and lo_log.stat().st_size:
                hi_t = time.time()
                hi = arb.submit(fleet.JobSpec(
                    "hi", [sys.executable, str(script)], priority=10,
                    min_np=2, max_np=2, max_restarts=0,
                    env=job_env("hi", SHRINK_HI)))
            time.sleep(FLEET_TICK_S)
    finally:
        arb.close()
        for j in arb.jobs.values():
            if j.handle is not None and j.handle.poll() is None:
                j.handle._driver.signal_ranks(range(8), signal.SIGKILL)
    check(hi is not None, "fleet shrink: lo never delivered a batch")
    check(lo.state == "DONE" and hi.state == "DONE",
          f"fleet shrink: lo {lo.state} ({lo.reason}), hi {hi.state} "
          f"({hi.reason}); events {[e[:2] for e in events]}")
    preempts = [f for k, f, _ in events if k == "fleet.preempt"]
    lo_ends = [e for e in ends if e[0] == "lo"]
    check(lo.preemptions == 1 and lo.handle.drains >= 1
          and lo.charged_restarts == 0 and hi.charged_restarts == 0
          and [f["to_np"] for f in preempts] == [2],
          f"fleet shrink: preemptions {lo.preemptions}, drains "
          f"{lo.handle.drains}, charged {lo.charged_restarts} / "
          f"{hi.charged_restarts}, preempts {preempts}")
    check(lo_ends[0][1] == "drain" and lo_ends[0][2][2] == 79
          and lo_ends[0][2][3] == 79 and lo_ends[-1][1] == "done",
          f"fleet shrink: lo's incarnations ended {lo_ends}")
    lo_sizes = _deliveries(tmp / "lo.deliver", 2, 32, "lo")
    hi_sizes = _deliveries(tmp / "hi.deliver", 1, 8, "hi")
    check(lo_sizes == [2, 4] and hi_sizes == [2],
          f"fleet shrink: lo ran at {lo_sizes}, hi at {hi_sizes}")
    relaunch = [t for name, size, t in launches
                if name == "lo" and size == 2]
    resized = [f for k, f, _ in events if k == "fleet.resized"]
    return {"lo_incarnations": [[o, e] for _, o, e in lo_ends],
            "lo_world_sizes": lo_sizes, "hi_world_sizes": hi_sizes,
            "preemptions": lo.preemptions, "drains": lo.handle.drains,
            "charged_restarts": [lo.charged_restarts, hi.charged_restarts],
            "hi_queue_wait_s": hi.queue_wait_s,
            "submit_to_relaunch_s": relaunch[0] - hi_t,
            "arbiter_resize_s": resized[0]["resize_s"] if resized else None}


def fleet_phase(smi: str, tmp: Path) -> dict:
    """The fleet on the card, through ``python -m horovod_tpu_torch.fleet``
    (submit, serve, cancel): card jobs of the elastic phase's
    uninterrupted run under the port's runner and driver, a cancel, and
    the planned shrink on CPU workers; the gates of the module's
    docstring, and one ``fleet {...}`` line."""
    import torch

    elastic = tmp / "elastic"
    tmp = tmp / "fleet"
    tmp.mkdir()
    discover = tmp / "discover.sh"
    discover.write_text("#!/bin/sh\necho localhost:1\n")
    discover.chmod(0o755)
    t0 = time.time()
    card = _card_run(tmp, discover)
    serve = card["serve"]
    check(card["rc"] == 0, f"fleet: serve exited {card['rc']}:\n"
          f"{serve.stderr()[-4000:]}")
    starts = serve.events("job_start")
    ends = serve.events("job_end")
    check([f["job"] for _, f in starts] == ["hi", "lo"]
          and [f["job"] for _, f in ends] == ["hi", "lo"]
          and starts[1][0] >= ends[0][0],
          f"fleet: started {[f for _, f in starts]}, ended "
          f"{[f for _, f in ends]}; hi must run first, lo after it")
    check(all(s.get("lo") == "PENDING" for _, s in card["seen"]
              if s.get("hi") == "RUNNING") and card["seen"],
          f"fleet: lo was not PENDING while hi ran: {card['seen']}")
    ref_final = torch.load(elastic / "plain.pt")
    ref_recs = [json.loads(line) for line
                in (elastic / "plain.jsonl").read_text().splitlines()]

    def images_per_s(steps):
        timed = steps[FLEET_WARMUP:]
        return (BATCH * (len(timed) - 1) / (timed[-1]["t"] - timed[0]["t"])
                if len(timed) > 1 else None)

    jobs = {}
    for name in ("hi", "lo"):
        row = card["rows"][name]
        h = row["health"] or {}
        check(row["state"] == "DONE" and row["exit_code"] == 0
              and row["charged_restarts"] == 0,
              f"fleet: {name} {row['state']} exit {row['exit_code']}, "
              f"{row['charged_restarts']} charged restarts")
        check(h.get("job") == name and h.get("rank") == 0
              and h.get("steps", 0) > 0 and h.get("generation") == 0
              and h.get("incidents_total") == 0,
              f"fleet: {name}'s health rollup {h}")
        final = torch.load(tmp / f"{name}.pt")
        for k, t in ref_final["model"].items():
            check(torch.equal(final["model"][k], t),
                  f"fleet: {name}'s {k} differs from the uninterrupted run")
        check(len(final["momentum"]) == len(ref_final["momentum"]) and all(
            torch.equal(a, b) for a, b in zip(final["momentum"],
                                              ref_final["momentum"])),
            f"fleet: {name}'s momentum differs from the uninterrupted run")
        recs = [json.loads(line) for line
                in (tmp / f"{name}.jsonl").read_text().splitlines()]
        steps = [r for r in recs if r["kind"] == "step"]
        check(len(steps) == ELASTIC_EPOCHS * ELASTIC_IMAGES // BATCH
              and all(r["a1"] == 4 and r["device"] == ["cuda:0", "cuda:0"]
                      for r in steps),
              f"fleet: {name} ran {len(steps)} steps, A1 "
              f"{sorted({r['a1'] for r in steps})} a step, on "
              f"{sorted({tuple(r['device']) for r in steps})}")
        start = next(t for t, f in starts if f["job"] == name)
        end = next(t for t, f in ends if f["job"] == name)
        first = next(r for r in recs if r["kind"] == "first_step")
        jobs[name] = {
            "wall_s": end - start,
            "queue_wait_s": row["queue_wait_s"],
            "spawn_to_first_step_s": first["t"] - start,
            "images_per_s": images_per_s(steps),
            "a1_launches_per_step": sorted({r["a1"] for r in steps}),
            "a1_launches": sum(r["a1"] for r in steps),
            "health": {k: h.get(k) for k in ("steps", "step_rate",
                                             "generation",
                                             "incidents_total", "stale")}}
    cancel = _cancel_run(tmp, discover)
    serve = cancel["serve"]
    row = cancel["rows"]["gone"]
    gone_ends = _driver_ends(serve.stderr())
    check(cancel["cancel_t"] is not None,
          f"fleet: gone never reached {FLEET_CANCEL_AFTER} verified commits")
    check(cancel["rc"] == 1 and "jobs failed: gone" in serve.stderr()
          and row["state"] == "FAILED" and row["reason"] == "cancelled"
          and row["charged_restarts"] == 0
          and [e[:2] for e in gone_ends] == [("term", [79])],
          f"fleet: the cancel: serve exited {cancel['rc']}, gone "
          f"{row['state']} ({row['reason']}), "
          f"{row['charged_restarts']} charged, the driver ended "
          f"{[e[:2] for e in gone_ends]}:\n{serve.stderr()[-3000:]}")
    total = ELASTIC_EPOCHS * ELASTIC_IMAGES // BATCH
    check(FLEET_CANCEL_AFTER <= cancel["committed_final"] < total,
          f"fleet: gone's last verified commit {cancel['committed_final']}")
    shrink = _shrink_run(tmp)
    plain_steps = [r for r in ref_recs if r["kind"] == "step"]
    result = {
        "card": smi,
        "jobs": jobs,
        "elastic_plain_images_per_s": (images_per_s(plain_steps)
                                       if "t" in plain_steps[0] else None),
        "cancel": {"committed_at_cancel": cancel["committed_at_cancel"],
                   "committed_final": cancel["committed_final"],
                   "exit": gone_ends[0][1], "outcome": gone_ends[0][0],
                   "cli_s": cancel["cancel_cli_s"],
                   "seconds_to_exit": gone_ends[0][2] - cancel["cancel_t"],
                   "state": row["state"], "reason": row["reason"]},
        "shrink": shrink,
        "phase_s": time.time() - t0,
        "a1_launches": sum(j["a1_launches"] for j in jobs.values()),
    }
    log("fleet " + json.dumps(result))
    return result


def launcher_check_build() -> dict:
    """``python -m horovod_tpu_torch.runner --check-build`` after the
    build: the native C++ core, NCCL, gloo, CUDA and every kernel of
    ``csrc`` marked built."""
    from horovod_tpu_torch.ops import _build

    proc, _ = _launch(["--check-build"], {}, REPO, 120)
    check(proc.returncode == 0, f"--check-build exited {proc.returncode}:"
          f"\n{proc.stderr[-2000:]}")
    flags = {m.group(2): m.group(1) == "X"
             for m in re.finditer(r"\[([X ])\] (.+)", proc.stdout)}
    want = (["native C++ core", "NCCL", "gloo", "CUDA"]
            + [s.stem for s in _build.sources()])
    check(all(flags.get(k) for k in want),
          f"--check-build: {flags}, expected {want} built:\n{proc.stdout}")
    return flags


def launcher_autotune() -> dict:
    """``--autotune`` and its settings are accepted by the launcher and
    reach the worker's env (the worker prints its ``HVTPU_AUTOTUNE*``)."""
    code = ("import json, os; print('ENV ' + json.dumps({k: v for k, v in "
            "os.environ.items() if k.startswith('HVTPU_AUTOTUNE')}))")
    proc, _ = _launch(["-np", "1", "--autotune", "--autotune-log",
                       "/dev/null", "--autotune-warmup-samples", "0",
                       "--autotune-steps-per-sample", "2",
                       "--autotune-bayes-opt-max-samples", "6", "--",
                       sys.executable, "-c", code], {}, REPO, 120)
    env = [json.loads(line.split("ENV ", 1)[1])
           for line in proc.stdout.splitlines() if "ENV {" in line]
    want = {"HVTPU_AUTOTUNE": "1", "HVTPU_AUTOTUNE_LOG": "/dev/null",
            "HVTPU_AUTOTUNE_WARMUP_SAMPLES": "0",
            "HVTPU_AUTOTUNE_STEPS_PER_SAMPLE": "2",
            "HVTPU_AUTOTUNE_GP_SAMPLES": "6"}
    check(proc.returncode == 0 and env == [want],
          f"--autotune: exit {proc.returncode}, worker env {env}:\n"
          f"{proc.stderr[-2000:]}")
    return env[0]


def launcher_negative_gate() -> dict:
    """One more rank a host than cards: the launcher exits non-zero
    within the start timeout, its output names the local rank that has
    no card and the card count, and no worker is left behind."""
    import torch

    cards = torch.cuda.device_count()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_np_") as d:
        code = ("import os, sys; open(os.path.join(sys.argv[1], "
                "os.environ['HVTPU_RANK']), 'w').write(str(os.getpid())); "
                "import horovod_tpu_torch as hvd; hvd.init()")
        proc, t0 = _launch(["-np", str(cards + 1), "--start-timeout", "120",
                            "--", sys.executable, "-c", code, d],
                           {"HVTPU_TERM_GRACE_SECONDS": "5"}, REPO, 300)
        seconds = time.time() - t0
        pids = [int(Path(d, f).read_text()) for f in os.listdir(d)]
    alive = []
    for pid in pids:
        try:
            os.kill(pid, 0)
            alive.append(pid)
        except ProcessLookupError:
            pass
    names = (f"local rank {cards})" in proc.stderr
             and f"sees {cards} CUDA device" in proc.stderr)
    check(proc.returncode != 0 and seconds < 120 and names and not alive
          and len(pids) == cards + 1,
          f"launcher: -np {cards + 1} on {cards} card(s) exited "
          f"{proc.returncode} in {seconds:.1f} s, names the rank: {names}, "
          f"workers {pids} left alive {alive}:\n{proc.stderr[-3000:]}")
    return {"np": cards + 1, "cards": cards, "exit": proc.returncode,
            "seconds": seconds, "names_rank_and_cards": names,
            "left_alive": alive}


# -- the fabric simulator -----------------------------------------------------

SIM_SEED = 7
SIM_RANKS = 64
SIM_BUDGET_S = 120.0
#: The reference simulator's digests (``horovod_tpu/sim`` under
#: ``PYTHONHASHSEED=0``, seed 7): "scenario@ranks" -> (sha256 of the event
#: log's canonical JSONL, sha256 of the canonical JSON of ``stats``).
#: ``tests/test_torch_port_sim_digests.py`` and
#: ``tests/test_torch_port_sim_cli.py`` recompute every row from the
#: reference and from the port on the CPU and hold them to this table.
SIM_DIGESTS = {
    "thundering-rendezvous@64": (
        "117ff2d27a83550f5574046d13866e4a75d7788b4ccae9a7a86a5db4a7f6ee5f",
        "8efb7faef34f6a32155ceb282f01145f823efeda1a3da6b5f02e19981e70d7fd"),
    "steady-drain@64": (
        "67e2b0a6052f97f0140963c7b36a6a8fe9aac8b1b9df52b93b30fb6b8535689c",
        "7097a4774a1e12011d1f7f82c91b0a8e2b2bd55391e35959476e95a087eaa08f"),
    "rolling-preemption@64": (
        "afb048220d17a1b416847ed11abf4a9fe92dd1deda47c691480cdf8e91e529b7",
        "b6751294eca7bd16086376edcb271d5ffcaa842ec6e742dcfe3df3e4f4b8112b"),
    "kill-blacklist@64": (
        "77e6581704291c00cc65ebff4f0ff459c1319ebdc088a0a28901eaa2ee9a55d1",
        "d4c72f468f190b6597846c9ad39cde8f76b5e71db3b336d98d116f31248ea4f2"),
    "kv-brownout@64": (
        "9ae0293ea6c1d43992d6818b4736c3180b135ecea9f0aa9bfc69425c0260c8bb",
        "e1cb31bb04b2001b44620f9c03bc39ea7c3d58e7d90bed888d785f39167dc0c1"),
    "straggler-tail@64": (
        "e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855",
        "2bc634abb14b9e598d5a690a1a5c2394a3719e91875798106ca4a890a1a0fdbb"),
    "stream-matrix@64": (
        "e9d73aa7082b2fc7f2471aaf8949e7377efcb849fa92842ccdbcb7c3c029d77a",
        "afd2c6c8b855d0d0630072408676ce750722d24471b45aacd98469e954d83b15"),
    "compression-negotiation@64": (
        "59a93b4f492d864a6ac5ad17459c97b87eb9e608696023c13ee3b30772a91377",
        "44f46514cb6d6aa57358d9f3b6f5d87ab6878ad2e538e58a6992ec42ce07bc33"),
    "checkpoint-storm@64": (
        "802576fd2155f527df469c3dc352d87efc84da16a64d3bf8e8be82152f8dc8cd",
        "e11d6184f3edc33237009da95b0e12cebe16374f5a4c6533578344107347d538"),
    "anomaly-detection@64": (
        "bbf20dafb1fc48d45422f3cc0f8e4e7754aded867f394b65a31c78f53676b52f",
        "4a75b7d7d289b546ae01213121265064cfeb0163488edf52ccc85936a85234fa"),
    "coordinator-loss@64": (
        "fb19418a569e7d15d9c58172f87382fac2ca2ff7efbc02bdc3608c1e79c9c091",
        "c6542e19ed6cd61848e8382f0ac87d71d975139c133a3ba3277ed3aad092da4a"),
    "partition-storm@64": (
        "659e5a68c8add3ab179beaced0f90bd57ab93d47a62d37c7644aa49d841de8a4",
        "c1153fe1dbbfa7a41924b57dda7714c28d8abe9e37999e77e0c9e15c41c8a493"),
    "lossy-link@64": (
        "97c3df78ee9868133f8726f57475b4f5b65a90b62e6356b9f617b99916e1c383",
        "2bfb130d6adc96cbf4b43defd3133c97248c3535bba3312df0f4b4e05481d7a7"),
    "multi-job-arbiter@64": (
        "62f22fb36bbe6ab06d8cb0ea6943d1d3d73712d36e715cbf748176c1fd320b37",
        "8273e68cf060a4aecf016fa5862e60a348c21dc98ef17e6d046f1e5bb6e4e492"),
    "fleet-service@64": (
        "c6c793a759719c41644b67043f260abfaf2dad592b7010be9b3631b2364897dc",
        "9b7c703cd3e9d77172744dbd218e7d92585980f1cd1285b9bb18b36667504723"),
    "steady-drain@256": (
        "3b2307db083738649b4ab741a8b7959ec840e73ce62f96c307c60ff9da0c4ca8",
        "8ee565caf9fca18f699cbe52708225f6418fca3d545b5113606c8597bb8d7b01"),
    "compression-negotiation@256": (
        "1b95617373f299f776e612691f5091917bbe522751408e4bd3dce35ae7793a8d",
        "fe75f49de062865f44d6b2e07cbd67076d5215caf5ed6b1a3c22120124c375bc"),
}


def sim_digests(events, stats) -> tuple:
    """(sha256 of the canonical JSONL of ``events``, sha256 of the
    canonical JSON of ``stats``): what ``SIM_DIGESTS`` pins."""
    import hashlib

    log_text = "".join(json.dumps(e, sort_keys=True) + "\n" for e in events)
    return (hashlib.sha256(log_text.encode()).hexdigest(),
            hashlib.sha256(json.dumps(stats, sort_keys=True).encode())
            .hexdigest())


def sim_phase(smi: str, device=None) -> dict:
    """The port's fabric simulator on the card's machine: the 15
    scenarios at 64 virtual ranks, seed 7, in this process (the
    controller scenarios' payloads and controllers on cuda:0),
    ``compression-negotiation`` at 256 on the card, and
    ``python -m horovod_tpu_torch.sim run steady-drain --ranks 256``
    twice as subprocesses (started first, running beside the rest).
    Every event log and ``stats`` digest must equal its row of
    ``SIM_DIGESTS``, every controller's device must be cuda:0, and the
    phase must end within ``SIM_BUDGET_S``.  One ``sim {...}`` line.
    ``device`` (default cuda:0) lets the CPU rehearse the phase."""
    import torch

    from horovod_tpu_torch.ops import fused_scale_cast
    from horovod_tpu_torch.sim import scenarios

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    # A1's launches a scenario (the zero-copy route's grouped unpack on
    # card payloads); the counter is put back after the phase
    a1_saved = fused_scale_cast.launches
    # the CLI re-execs itself under PYTHONHASHSEED=0; its report goes to
    # stdout, the ranks' warnings are dropped
    env = {k: v for k, v in os.environ.items() if k != "PYTHONHASHSEED"}
    cli = [sys.executable, "-m", "horovod_tpu_torch.sim", "run",
           "steady-drain", "--ranks", "256", "--seed", str(SIM_SEED)]
    procs = [subprocess.Popen(cli, cwd=REPO, env=env, text=True,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.DEVNULL) for _ in range(2)]
    rows, mismatched = {}, []
    try:
        runs = [(name, SIM_RANKS) for name in scenarios.SCENARIOS]
        runs.append(("compression-negotiation", 256))
        for name, ranks in runs:
            key = f"{name}@{ranks}"
            fused_scale_cast.launches = 0
            t = time.perf_counter()
            r = scenarios.run_scenario(name, ranks, SIM_SEED, device=dev)
            wall = time.perf_counter() - t
            got = sim_digests(r["events"], r["stats"])
            match = got == SIM_DIGESTS[key]
            if not match:
                mismatched.append((key, got))
            rows[key] = {"wall_s": wall, "events": len(r["events"]),
                         "virtual_s": r["virtual_s"], "digest_match": match,
                         "a1_launches": fused_scale_cast.launches}
            if name in scenarios.CONTROLLER_SCENARIOS:
                rows[key]["devices"] = r["devices"]
                check(r["devices"] == [str(dev)],
                      f"sim: {key} controllers on {r['devices']}, "
                      f"expected ['{dev}']")
        remaining = max(1.0, SIM_BUDGET_S - (time.perf_counter() - t_phase))
        for i, proc in enumerate(procs):
            out, _ = proc.communicate(timeout=remaining)
            check(proc.returncode == 0,
                  f"sim: CLI run {i} of steady-drain@256 exited "
                  f"{proc.returncode}")
            rep = json.loads(out)
            got = (rep["event_log_sha256"],
                   sim_digests([], rep["stats"])[1])
            match = got == SIM_DIGESTS["steady-drain@256"]
            if not match:
                mismatched.append((f"steady-drain@256 (CLI run {i})", got))
            rows[f"steady-drain@256 (CLI run {i})"] = {
                "events": rep["events"], "digest_match": match,
                "virtual_s": rep["stats"]["phases"]["drain"]["virtual_s"]}
    finally:
        fused_scale_cast.launches = a1_saved
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    phase_s = time.perf_counter() - t_phase
    check(not mismatched,
          f"sim: digests differ from the reference's table: {mismatched}")
    check(phase_s <= SIM_BUDGET_S,
          f"sim: the phase took {phase_s:.1f} s, over its "
          f"{SIM_BUDGET_S:.0f} s budget")
    line = {"card": smi, "seed": SIM_SEED, "phase_s": phase_s,
            "scenarios": rows}
    log("sim " + json.dumps(line))
    return line


SPARK_SEED = 7
SPARK_ROWS = 160           # 224x224x3 float32 images: ~96 MB of npz
SPARK_IMAGE = 224
SPARK_STAGES = (3, 4, 6, 3)   # ResNet-50
SPARK_FILTERS = 64
SPARK_CLASSES = 1000
SPARK_BATCH = 32
SPARK_EPOCHS = 2
SPARK_VALIDATION = 0.25
SPARK_KERAS_ROWS = 256     # the keras MLP's frame (16 features, 4 classes)
SPARK_MARK_ENV = "CHIP_SMOKE_SPARK_MARK"


def spark_a1_launches(outputs, labels) -> float:
    """A metric of the estimator's workers: A1's launches in the worker
    so far (``fused_scale_cast.launches``), read at each epoch's end.
    The workers import this module, so it is pickled by reference."""
    from horovod_tpu_torch.ops import fused_scale_cast

    return float(fused_scale_cast.launches)


def spark_cross_entropy(output, label):
    """``nn.CrossEntropyLoss()``'s function, which also notes in the file
    named by ``CHIP_SMOKE_SPARK_MARK`` the wall time of its first call in
    the worker: the first step's forward."""
    import torch.nn.functional as F

    mark = os.environ.get(SPARK_MARK_ENV)
    if mark and not os.path.exists(mark):
        with open(mark, "w") as f:
            f.write(repr(time.time()))
    return F.cross_entropy(output, label)


def spark_device_probe() -> str:
    """``spark.run``'s and ``RayExecutor``'s function: ``init()``, an
    allreduce of a tensor on the rank's device, that device."""
    import torch

    import horovod_tpu_torch.torch as hvd

    hvd.init()
    try:
        t = hvd.allreduce(torch.ones(4, device=hvd.device()), name="probe")
        if not bool((t == 1).all()):
            raise RuntimeError(f"probe: allreduce gave {t}")
        return str(t.device)
    finally:
        hvd.shutdown()


def _spark_keras(spark, tmp: Path, cpu_devices) -> dict:
    """A seeded keras MLP through the port's ``KerasEstimator`` at one
    rank: the history finite, transform's column the trained model's own
    ``predict`` at the same batching, bitwise."""
    import keras
    import numpy as np

    rng = np.random.RandomState(SPARK_SEED)
    x = rng.rand(SPARK_KERAS_ROWS, 16).astype(np.float32)
    y = rng.randint(0, 4, SPARK_KERAS_ROWS)
    keras.utils.set_random_seed(SPARK_SEED)
    model = keras.Sequential([keras.layers.Input((16,)),
                              keras.layers.Dense(32, activation="relu"),
                              keras.layers.Dense(4, activation="softmax")])
    est = spark.KerasEstimator(
        model=model, optimizer=keras.optimizers.SGD(0.1),
        loss="sparse_categorical_crossentropy", feature_cols=["features"],
        label_cols=["label"], batch_size=SPARK_BATCH, epochs=SPARK_EPOCHS,
        verbose=0, random_seed=SPARK_SEED,
        store=spark.LocalStore(str(tmp / "keras")),
        backend=spark.LocalBackend(num_proc=1, cpu_devices=cpu_devices))
    t = time.perf_counter()
    km = est.fit({"features": x, "label": y})
    fit_s = time.perf_counter() - t
    hist = km.getHistory()
    check(len(hist["loss"]) == SPARK_EPOCHS
          and all(math.isfinite(v) for v in hist["loss"]),
          f"spark: the keras history {hist}")
    pred = np.stack(km.transform({"features": x})["label__output"])
    direct = km.getModel().predict(x, batch_size=SPARK_BATCH, verbose=0)
    check(pred.shape == (SPARK_KERAS_ROWS, 4)
          and pred.tobytes() == np.asarray(direct).tobytes(),
          "spark: the keras transform differs from the model's predict")
    return {"fit_s": fit_s, "history": hist}


def spark_phase(smi: str, tmp: Path, device: str = "cuda:0") -> dict:
    """The Spark estimator and the Ray executor on the card: the port's
    ``TorchEstimator`` fits ResNet-50 through ``LocalBackend(num_proc=1)``
    (the port's default device), then ``spark.run`` and
    ``RayExecutor(use_gpu=True)`` (local mode) run a probe; the gates of
    the module's docstring, and one ``spark {...}`` line.  This process
    holds its own one-rank world on the card meanwhile, as the elastic
    and fleet children's parent does.  ``device="cpu"`` rehearses the
    phase on the CPU: every rank asks for the CPU (``cpu_devices=1``,
    ``use_gpu=False``) and A1 launches nothing there."""
    import importlib.util

    import numpy as np
    import torch

    import chip_smoke as this   # what the workers import: by reference
    from horovod_tpu_torch import spark
    from horovod_tpu_torch.models import ResNet
    from horovod_tpu_torch.ray import RayExecutor
    from horovod_tpu_torch.runner import pickler

    on_card = device != "cpu"
    cpu_devices = None if on_card else 1
    t0 = time.perf_counter()
    probes = {m: importlib.util.find_spec(m) is not None
              for m in ("cloudpickle", "pandas", "pyspark", "ray", "keras",
                        "tensorflow")}
    tmp = tmp / "spark"
    tmp.mkdir()
    rng = np.random.RandomState(SPARK_SEED)
    frame = {"features": rng.rand(SPARK_ROWS, SPARK_IMAGE, SPARK_IMAGE, 3)
             .astype(np.float32),
             "label": rng.randint(0, SPARK_CLASSES, SPARK_ROWS)}
    model = ResNet(list(SPARK_STAGES), num_classes=SPARK_CLASSES,
                   num_filters=SPARK_FILTERS, dtype=torch.float32,
                   generator=torch.Generator().manual_seed(SEED))
    store = spark.LocalStore(str(tmp / "store"))
    est = spark.TorchEstimator(
        model=model,
        optimizer=torch.optim.SGD(model.parameters(), lr=0.01,
                                  momentum=0.9),
        loss=this.spark_cross_entropy, metrics=[this.spark_a1_launches],
        feature_cols=["features"], label_cols=["label"],
        gradient_compression="fp16", batch_size=SPARK_BATCH,
        epochs=SPARK_EPOCHS, validation=SPARK_VALIDATION,
        random_seed=SPARK_SEED, verbose=0, run_id="smoke", store=store,
        backend=spark.LocalBackend(num_proc=1, cpu_devices=cpu_devices))
    mark = tmp / "first_step"
    os.environ[SPARK_MARK_ENV] = str(mark)
    if on_card:
        torch.cuda.empty_cache()
    t = time.time()
    try:
        tm = est.fit(frame)
    finally:
        os.environ.pop(SPARK_MARK_ENV, None)
    fit_s = time.time() - t
    first_step_s = float(mark.read_text()) - t
    meta = store.read_json(store.get_data_metadata_path())
    npz_bytes = sum(os.path.getsize(os.path.join(d, f)) for d, f in (
        (store.get_train_data_path(), "train.npz"),
        (store.get_val_data_path(), "val.npz")))
    hist = tm.getHistory()
    check(all(len(hist.get(k, [])) == SPARK_EPOCHS
              and all(math.isfinite(v) for v in hist[k])
              for k in ("loss", "val_loss")),
          f"spark: the history {hist}")
    steps = -(-meta["n_train"] // SPARK_BATCH)
    launches = hist["spark_a1_launches"]
    per_step = sorted({(b - a) / steps
                       for a, b in zip([0.0] + launches[:-1], launches)})
    want = 4 if on_card else 0
    check(per_step == [want],
          f"spark: A1 launched {launches} by the epochs' ends over "
          f"{steps} steps an epoch, expected {want} a step")
    check(store.get_checkpoints("smoke") == ["checkpoint.pt"],
          f"spark: checkpoints {store.get_checkpoints('smoke')}")
    ckpt = torch.load(os.path.join(store.get_checkpoint_path("smoke"),
                                   "checkpoint.pt"), weights_only=True)
    check(all(v.device.type == "cpu" for v in ckpt["model"].values()),
          "spark: the checkpoint holds tensors off the CPU")
    trained = tm.getModel()
    on = next(trained.parameters()).device
    check(str(on) == device, f"spark: the trained module is on {on}")
    # transform and the module's own forward at the same batching, with
    # deterministic cuDNN
    saved = (torch.backends.cudnn.benchmark,
             torch.backends.cudnn.deterministic)
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    try:
        t = time.perf_counter()
        out = np.stack(tm.transform(frame)["label__output"])
        transform_ms = (time.perf_counter() - t) * 1e3
        x = torch.from_numpy(frame["features"]).to(on)
        with torch.no_grad():
            direct = torch.cat([trained(x[lo:lo + SPARK_BATCH]) for lo in
                                range(0, SPARK_ROWS, SPARK_BATCH)])
        direct = direct.cpu().numpy()
    finally:
        (torch.backends.cudnn.benchmark,
         torch.backends.cudnn.deterministic) = saved
    same_shape = out.shape == direct.shape == (SPARK_ROWS, SPARK_CLASSES)
    check(same_shape and np.isfinite(out).all()
          and out.tobytes() == direct.tobytes(),
          f"spark: transform ({out.shape}) differs from the trained "
          f"module's forward on {on}, max "
          f"{float(np.abs(out - direct).max()) if same_shape else None}")
    del x, trained, tm
    run_devices = spark.run(this.spark_device_probe, num_proc=1,
                            cpu_devices=cpu_devices)
    ray = RayExecutor(num_workers=1, use_gpu=on_card)
    ray.start()
    try:
        ray_devices = ray.run(this.spark_device_probe)
    finally:
        ray.shutdown()
    check(run_devices == [device] and ray_devices == [device],
          f"spark: spark.run ran on {run_devices}, RayExecutor on "
          f"{ray_devices}, expected {device}")
    keras_run = None
    if probes["keras"] and probes["tensorflow"]:
        keras_run = _spark_keras(spark, tmp, cpu_devices)
    line = {
        "card": smi, "rows": SPARK_ROWS, "image": SPARK_IMAGE,
        "npz_bytes": npz_bytes, "n_train": meta["n_train"],
        "n_val": meta["n_val"], "fit_s": fit_s,
        "first_step_s": first_step_s, "history": hist,
        "transform_ms": transform_ms,
        "a1_launches_per_step": per_step[0], "steps_per_epoch": steps,
        "worker_device": device, "run_devices": run_devices,
        "ray_devices": ray_devices, "find_spec": probes,
        "pickler": pickler().__name__,
        "keras_estimator": "ran" if keras_run else None,
        "keras": keras_run, "phase_s": time.perf_counter() - t0,
    }
    log("spark " + json.dumps(line))
    return line


FRONTEND_SEED = 0
FRONTEND_STEPS = 4
FRONTEND_BATCH = 64
FRONTEND_WIDTHS = (784, 256, 10)   # an MNIST-sized MLP


def _module_version(name: str):
    """The installed version of module ``name``, None when it is not
    installed; read from its distribution without importing it."""
    import importlib.util
    from importlib import metadata

    if importlib.util.find_spec(name) is None:
        return None
    for dist in metadata.packages_distributions().get(name) or [name]:
        try:
            return metadata.version(dist)
        except metadata.PackageNotFoundError:
            continue
    return __import__(name).__version__


def _frontend_run(hvd) -> tuple:
    """FRONTEND_STEPS steps of the seeded MLP through the port's keras
    ``DistributedOptimizer`` on the world ``hvd`` is initialized on:
    (weights, the bridge's tensors by device, losses)."""
    import keras
    import numpy as np

    import horovod_tpu_torch.keras as hvd_keras
    from horovod_tpu_torch.tensorflow import mpi_ops as tf_ops

    d_in, d_hidden, d_out = FRONTEND_WIDTHS
    keras.utils.set_random_seed(FRONTEND_SEED)
    rng = np.random.RandomState(FRONTEND_SEED)
    n = FRONTEND_BATCH * FRONTEND_STEPS
    x = rng.rand(n, d_in).astype(np.float32)
    y = rng.randint(0, d_out, size=n).astype(np.int32)
    model = keras.Sequential([
        keras.layers.Input((d_in,)),
        keras.layers.Dense(d_hidden, activation="relu"),
        keras.layers.Dense(d_out)])
    opt = hvd_keras.DistributedOptimizer(
        keras.optimizers.SGD(0.05, momentum=0.9),
        gradient_predivide_factor=PREDIVIDE)
    model.compile(optimizer=opt, loss=keras.losses.
                  SparseCategoricalCrossentropy(from_logits=True))
    tf_ops.bridged.clear()
    hist = model.fit(x, y, batch_size=FRONTEND_BATCH, epochs=1,
                     shuffle=False, verbose=0)
    return (model.get_weights(), dict(tf_ops.bridged),
            hist.history["loss"])


def frontends_phase(hvd, smi: str, device: str = "cuda:0") -> dict:
    """The tf/keras frontends where ``tensorflow`` and ``keras`` are
    installed (see the module docstring, step 12); one ``frontends
    {...}`` line.  Only a missing module skips the run; any other error
    fails the smoke.  ``hvd`` is initialized on ``device`` when this is
    called, and on the CPU when it returns from a run.  ``device="cpu"``
    lets the CPU rehearse the phase."""
    t0 = time.perf_counter()
    line = {"tensorflow": _module_version("tensorflow"),
            "keras": _module_version("keras"), "ran": False}
    if line["tensorflow"] is None or line["keras"] is None:
        log("frontends " + json.dumps(line))
        return line
    import numpy as np
    import tensorflow as tf

    # tf would otherwise reserve the card's memory for itself
    for gpu in tf.config.list_physical_devices("GPU"):
        tf.config.experimental.set_memory_growth(gpu, True)
    check(str(hvd.device()) == device,
          f"frontends: the port is on {hvd.device()}, not {device}")
    weights, bridged, losses = _frontend_run(hvd)
    grads = 2 * (len(FRONTEND_WIDTHS) - 1)
    check(bridged == {device: grads * FRONTEND_STEPS},
          f"frontends: bridged {bridged}, expected {grads} gradients a "
          f"step on {device}")
    check(all(np.isfinite(v) for v in losses),
          f"frontends: losses {losses}")
    hvd.shutdown()
    hvd.init(device="cpu")
    cpu_weights, cpu_bridged, cpu_losses = _frontend_run(hvd)
    same = all(a.dtype == b.dtype and a.tobytes() == b.tobytes()
               for a, b in zip(weights, cpu_weights))
    check(same and losses == cpu_losses,
          "frontends: the weights after the steps differ between the "
          f"port on {device} and on the CPU")
    line.update(ran=True, card=smi, steps=FRONTEND_STEPS,
                bridged=bridged, cpu_bridged=cpu_bridged,
                weights_equal_cpu=same, losses=losses,
                tf_devices=[d.name for d in
                            tf.config.list_logical_devices()],
                phase_s=time.perf_counter() - t0)
    log("frontends " + json.dumps(line))
    return line


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (REPO / "horovod_tpu_torch" / "__init__.py").is_file():
        print("chip_smoke: the horovod_tpu_torch package is not beside "
              "this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    if sys.argv[1:] == ["--elastic-child"]:
        return elastic_child()
    if sys.argv[1:2] == ["--ring-ipc-child"]:
        return ring_ipc_child(sys.argv[2:])
    if sys.argv[1:2] == ["--sharded-ckpt-child"]:
        return sharded_child(sys.argv[2:])
    import threading

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.native import core as native_core
    from horovod_tpu_torch.ops import _build

    # the C++ negotiation core (g++) builds beside the kernels (nvcc)
    core_build = {}

    def build_core():
        t = time.perf_counter()
        try:
            core_build["path"] = native_core.build()
        except RuntimeError as e:
            core_build["error"] = e
        core_build["s"] = time.perf_counter() - t

    builder = threading.Thread(target=build_core)
    t0 = time.perf_counter()
    builder.start()
    libs = _build.build_all()
    t_kernels = time.perf_counter() - t0
    builder.join()
    if "error" in core_build:
        raise SmokeFailure(f"native core: {core_build['error']}")
    log(f"build: {', '.join(p.name for p in libs.values())} in "
        f"{t_kernels:.1f} s (sm_90a); {Path(core_build['path']).name} in "
        f"{core_build['s']:.1f} s (g++)")
    smi = nvidia_smi_line()
    log(smi)
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    check_build = launcher_check_build()
    autotune_env = launcher_autotune()
    negative = launcher_negative_gate()
    log(f"launcher: --check-build {check_build}; -np {negative['np']} on "
        f"{negative['cards']} card(s) exited {negative['exit']} in "
        f"{negative['seconds']:.1f} s")
    # before init: the simulator's virtual ranks share nothing with the
    # one-rank world the phases below use
    sim_phase(smi)

    # the flight recorder's postmortems go to a directory of this run
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    os.environ["HVTPU_FLIGHT_DIR"] = str(tmp)
    hvd.init()                            # one-rank NCCL world on cuda:0
    device = hvd.device()
    try:
        grad_shapes = resnet50_grad_shapes()
        check(len(grad_shapes) == RESNET50_GRADS, "ResNet-50 inventory")
        big_n = sum(math.prod(s) for s in grad_shapes)
        kern = kernel_phase(device, grad_shapes, big_n, reps=20)
        int8_kern = int8_kernel_phase(device, grad_shapes, big_n, reps=20)

        torch.backends.cudnn.benchmark = True
        model, opt, x, y, train = train_phase(hvd, device, BATCH, IMAGE,
                                              [3, 4, 6, 3])
        check(train["grads"] == RESNET50_GRADS, "ResNet-50 gradients")
        reduction = parity_phase(model, opt, x, y, reps=20)
        int8_path = int8_path_phase(model, x, y)
        surface_autograd_phase(hvd, device)
        async_path = async_phase(hvd, device, model, opt, x, y, smi)
        adasum_phase(hvd, device, model, x, y)
        spmd_phase(hvd, device, model, opt, x, y, smi)
        transformer_phase(hvd, device, smi)
        models = models_phase(hvd, device, smi)
        sharded_ckpt_phase(hvd, device, smi, tmp)
        stall_line = stall_phase(hvd, device, model, opt, x, y, smi, tmp)
        faults_phase(hvd, device, model, opt, x, y, smi)
        obs = obs_phase(hvd, device, model, opt, x, y, smi, tmp)
        ring = ring_phase(ring_buckets(model, x, y, RING_RANKS), reps=10)
        ring_ipc = ring_ipc_phase(smi, tmp)
        del model, opt, x, y
        reference_phase(hvd, device)
        elastic = elastic_phase(smi, tmp)
        fleet = fleet_phase(smi, tmp)
        spark = spark_phase(smi, tmp, str(device))
        # last: a run re-initializes the port on the CPU
        frontends_phase(hvd, smi, str(device))
    finally:
        hvd.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)

    log(f"{smi} | ResNet-50 bf16 batch {BATCH} {IMAGE}x{IMAGE}: "
        f"{train['images_per_s']:.1f} images/s")
    log("launcher " + json.dumps({
        "card": smi, "check_build": check_build,
        "autotune_env": autotune_env,
        **elastic["launcher"], "negative": negative,
        "a1_launches": elastic["a1_launches"],
        "a1_launches_per_step": elastic["a1_launches_per_step"]}))
    pre, post = kern["passes"]["pre"], kern["passes"]["post"]
    # A1: the grouped pre pass (scale_cast_pack) over the 161 gradients;
    # the post pass (unpack_cast_scale) beside it; library_ms is
    # _foreach_mul over the same tensors, per_tensor_ms the per-tensor
    # composition the passes replace
    kernels = [{
        "name": "fused_scale_cast (grouped: scale_cast_pack / "
                "unpack_cast_scale)",
        "route": "cuda",
        "source": "horovod_tpu_torch/csrc/scale_cast.cu",
        "replaces": "horovod_tpu/ops/pallas_ops.py:101",
        "launches": train["launches"],
        "async_launches": async_path["a1_launches"],
        # the fp16 burst on each negotiation core (the first timed burst),
        # and under the autotuner (each burst)
        "core_launches": {k: v["a1_launches"][0] for k, v
                          in async_path["cores"]["fp16"].items()},
        "autotune_launches": [b["a1_launches"] for b
                              in async_path["autotune"]["bursts"]],
        "zero_copy_launches": async_path["zero_copy"]["a1_launches_on"],
        "stall_launches": stall_line["stall_launches"],
        "obs_launches_per_step": {m: d["launches_per_step"]
                                  for m, d in obs["modes"].items()},
        "elastic_launches": elastic["a1_launches"],
        # the elastic children by the launcher's entry point that
        # started them
        "launcher_launches": elastic["a1_launches_by_launcher"],
        "elastic_launches_per_step": elastic["a1_launches_per_step"],
        # the fleet phase's card jobs (hi, lo), started by the fleet's
        # runner through the port's elastic driver
        "fleet_launches": fleet["a1_launches"],
        "fleet_launches_per_step": sorted({
            n for j in fleet["jobs"].values()
            for n in j["a1_launches_per_step"]}),
        # the spark phase's estimator worker (TorchEstimator's
        # DistributedOptimizer), counted in the worker
        "spark_launches_per_step": spark["a1_launches_per_step"],
        # the models phase: each model's A1 launches a step
        "models_launches_per_step": {
            name: r["a1_launches_per_step"] for name, r in
            list(models["trio"].items()) + list(models["small"].items())
            if "a1_launches_per_step" in r},
        "max_abs_err": kern["max_abs_err"],
        "ms": pre["ms"],
        "plain_ms": pre["plain_ms"],
        "bound_ms": pre["bound_ms"],
        "bound_by": pre["bound_by"],
        "library_ms": pre["library_ms"],
        "per_tensor_ms": pre["per_tensor_ms"],
        "post": {k: post[k] for k in ("ms", "plain_ms", "bound_ms",
                                      "library_ms", "per_tensor_ms")},
        "big_buffer": kern["big_buffer"],
        **reduction,
    }]
    ipp, err = int8_kern["path_pass"], int8_kern["err"]
    big = int8_kern["big_buffer"]
    for name, key, line, launches, max_err, buffers in (
            ("quantize_int8_blocks (deterministic)", "quantize_deterministic",
             185, int8_path["a2_launches"]["deterministic"],
             max(err["q"], err["s"]),
             ("quantize_deterministic_float32",
              "quantize_deterministic_bfloat16")),
            ("quantize_int8_blocks (stochastic)", "quantize_stochastic", 185,
             int8_path["a2_launches"]["stochastic"],
             max(err["q"], err["s"]), ("quantize_stochastic_float32",)),
            ("dequantize_int8_blocks", "dequantize", 214,
             int8_path["a3_launches"], err["d"],
             ("dequantize_to_float32_float32",
              "dequantize_to_bfloat16_float32"))):
        # ms: the pass over the 161 gradients, host included; A3's
        # library call is one torch.mul of the codes by the scales, A2
        # has none; big_buffer: the 25.56 M buffer
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "horovod_tpu_torch/csrc/quantize_int8.cu",
            "replaces": f"horovod_tpu/ops/pallas_ops.py:{line}",
            "launches": launches,
            "max_abs_err": max_err,
            "ms": ipp[key]["ms"],
            "plain_ms": ipp[key]["plain_ms"],
            "bound_ms": ipp[key]["bound_ms"],
            "bound_by": ipp[key]["bound_by"],
            "library_ms": ipp[key]["library_ms"],
            "big_buffer": {b: big[b] for b in buffers},
        })
    for key, name, line, source, path in (
            ("A4_cluster", "ring_allgather_2d (cluster, n <= 8)", 94,
             "ring_cluster.cu", "launches"),
            ("A5_cluster", "ring_allreduce (cluster, n <= 8)", 180,
             "ring_cluster.cu", "launches"),
            ("A4_global", "ring_allgather_2d (global slots, n > 8)", 94,
             "ring.cu", "wide_launches"),
            ("A5_global", "ring_allreduce (global slots, n > 8)", 180,
             "ring.cu", "wide_launches"),
            ("A6_cluster", "ring_allreduce (quantized, cluster, n <= 8)",
             296, "ring_cluster.cu", "launches"),
            ("A6_global", "ring_allreduce (quantized, global slots, n > 8)",
             296, "ring.cu", "wide_launches")):
        # A5's library call is x.sum(0) on the stacked ranks, A4's
        # torch.cat, each filling one output; library_all_ranks_ms fills
        # every rank's; A6 has none
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"horovod_tpu_torch/csrc/{source}",
            "replaces": f"horovod_tpu/ops/ring.py:{line}",
            "launches": ring[path][key],
            "max_abs_err": ring["max_abs_err"][key],
            "ms": ring[key]["ms"],
            "plain_ms": ring[key]["plain_ms"],
            "bound_ms": ring[key]["bound_ms"],
            "bound_by": ring[key]["bound_by"],
            "library_ms": ring[key]["library_ms"],
            "library_all_ranks_ms": ring[key]["library_all_ranks_ms"],
        })
    # the same kernels with one rank a process: 2 processes time-sliced
    # on this card at full width (ring_ipc phase); ms a call of a rank,
    # plain_ms the plain version over both ranks' inputs, library_ms
    # x.sum(0) / torch.cat of both ranks' inputs, the bound the card's
    # least time for both ranks' work
    from horovod_tpu_torch.ops.ring import chunk_elems

    full = ring_ipc["full"]
    b4, b5 = _ring_bounds(2, RING_IPC_FULL, chunk_elems(RING_IPC_FULL, 2))
    bounds = {"A4": b4, "A5_sum": b5, "A6": _a6_bound(2, RING_IPC_FULL)}
    for key, call, name, line in (
            ("A4_ipc", "A4", "ring_allgather_2d (a rank a process)", 94),
            ("A5_ipc", "A5_sum", "ring_allreduce (a rank a process)", 180),
            ("A6_ipc", "A6", "ring_allreduce (quantized, a rank a process)",
             296)):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "horovod_tpu_torch/csrc/ring.cu",
            "replaces": f"horovod_tpu/ops/ring.py:{line}",
            "launches": full["launches"][key],
            "max_abs_err": max(full["max_abs_err"][k] for k in full[
                "max_abs_err"] if k.startswith(call[:2])),
            "ms": full["ms"][call],
            "plain_ms": full["plain_ms"][call],
            "bound_ms": bounds[call]["bound_ms"],
            "bound_by": bounds[call]["bound_by"],
            "library_ms": full["library_ms"].get(call),
            "time_sliced": ring_ipc["time_sliced"],
        })
    # A6's launches through spmd.allreduce(compression=int8) over a mesh
    # axis (the ring_ipc children, one a size a rank)
    kernels[-1]["spmd_launches"] = full["spmd"]["a6_launches"]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
