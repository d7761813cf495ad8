#!/usr/bin/env python3
"""Drive the PyTorch port (``consensusml_tpu_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, each printed as one JSON line:

1. ``device``: the card (``nvidia-smi`` name and power limit), torch and
   CUDA versions.
2. ``build``: compiles every CUDA kernel of ``consensusml_tpu_torch/csrc``
   with ``nvcc`` (all sources at once) and reports each build's time and
   ptxas register/spill lines.
3. ``check``: each kernel at its main path's shapes against its plain
   PyTorch version on the card (element-wise tolerance, zero for the
   CHOCO encode), timed beside the plain version (by CUDA events; the
   int8, int4, BN and LN kernels, which run faster than the host calls
   their wrappers, by profiler device time, and the paged attention by
   CUDA events over calls queued behind a sleep kernel) and, where one
   PyTorch call computes the same function, that call: paged
   attention (W=1 and W=4, with its launch plan and its time over the
   byte bound) and the flash forward at the serving shapes, the flash
   forward and backward (dq and dk/dv) at the training shape B=8, S=1024
   (and 600), H=16, D=64, causal (the forward, dq and dk/dv also report
   the function's TFLOP/s and their time over the library call's and over
   the bound: ``tflops``, ``x_library``, ``x_bound``; dq + dk/dv against
   SDPA's whole backward: ``bwd_ms``, ``bwd_x_library``), the fused CHOCO encode on a
   (4*8192, 512) f32 pair, and the top-k codec's four kernels at the
   shapes of ``gpt2_topk``'s bucket plan (chunked top-k and chunk scatter
   on the largest bucket, 4 workers x 100,514 rows of 512, and on the
   median one; int8 quantize/dequantize on the largest bucket's value
   rows), all four held bit for bit; the int4 quantize/dequantize at the
   value rows of ``--codec topk_int4``'s largest and median buckets, bit
   for bit; the fused LayerNorm's forward and backward at GPT-2-medium's
   (8192, 1024) bf16 view and a (2048, 1024) f32 one; the fp8
   quantize/dequantize at the rows of ``--codec fp8``'s largest and median
   buckets (4 x 100,514 and 4 x 6,160 rows of 512), the fused encode's
   int4 and fp8 formats at the largest bucket's rows, and the fused
   decode (``fused_dequantize_accumulate``, the collective round's receive,
   which ``train_collective`` runs) in all three formats with the ring's
   three sources at 1/3, bit for bit. Every codec check appends rows of
   f32 subnormals (which the kernels flush as the reference's compiled
   program does), NaN and inf.
4. ``serve``: GPT-2-medium at full width (numpy-seeded parameters through
   ``gpt2_from_flax``) in ``Engine(ServeConfig(num_slots=8, block_size=16,
   attn_impl="auto"))``: one prefill's and one decode step's logits held
   against the same stages on the plain versions (``attn_impl="torch"``),
   then requests of 700 (the 1024 bucket: flash kernel), 5, 37 and 300
   tokens, greedy and sampled, two of them through ``ServeServer`` over a
   localhost socket, with the kernels' launch counters zeroed just before
   and read just after.
5. ``train``: consensus-SGD training of ``gpt2_topk`` at full width and
   depth (GPT-2-medium) with ``--workers 4 --codec int8 --codec-warmup
   1``: four workers stacked on the card, ring gossip, CHOCO through the
   fused int8 wire. First one worker step's gradients through the kernels
   against the same step on the plain versions (``attn_impl="torch"``);
   then one warm-up round, two counted rounds (launch counters zeroed
   just before, read just after; loss, consensus error, round ms with the
   host's garbage-collection pauses in each, tokens/s, wire bytes, peak
   memory) and one more round under ``torch.profiler`` for the
   device-busy share.
6. ``train_topk``: the same model and workers on the config's own codec
   (``--workers 4 --codec-warmup 1``, no ``--codec``): chunked top-k (8
   of 512) + int8 values on the two-step bucketed wire, 25 buckets, each
   exchange launching the top-k, quantize, dequantize and scatter kernels
   once a bucket. The same initial parameters as ``train`` (drawn once),
   one warm-up round, two counted rounds (launch counts gated against
   the code's prediction, buckets and wire bytes against the plan's) and
   one profiled round, which reads each of the port's kernels' device
   time by its CUDA symbol.
7. ``train_resnet``: consensus-SGD training of ``cifar_resnet50`` at full
   width and depth (ResNet-50, CIFAR stem, bf16 compute, 8 workers on a
   ring, exact bucketed gossip of the weights and BN statistics, SGD
   with momentum, batch 128 of 32x32x3) with ``--norm-impl pallas``:
   every BN through the three fused-BN kernels (stats, normalize, and the
   one-launch backward). One warm round, then one worker step's gradients
   through the kernels against the same step on their plain versions,
   three counted rounds (launch counters zeroed just before and gated at
   53 BN layers x 8 workers x 3 rounds = 1272 a BN kernel, the other
   kernels at 0; loss, consensus error, round ms, images/s, peak memory,
   23 buckets; the host's wall time of each BN backward call, its median
   and how many calls had to copy dy) and one profiled round (device-busy
   share, each BN kernel's device time by CUDA symbol, the BN forward's
   and backward's apart).
8. ``train_resnet_flax``: the config's default BN (PyTorch's batch norm)
   on the same initial parameters: one warm round, two counted rounds,
   one profiled round with the BN kernels' device time, the forward's and
   backward's apart: the yardstick, end to end.
9. ``train_topk_int4_ln``: ``gpt2_topk`` full ``--workers 4 --codec
   topk_int4 --norm-impl pallas --codec-warmup 1``: the same initial
   parameters as ``train``; every one of the 49 LayerNorms through the
   fused-LN kernels, the gossip through chunked top-k (8 of 512) + int4
   values on the two-step wire (14 buckets, 27,809,088 wire bytes). One
   worker step's gradients (flash + LN kernels) against the same step on
   the plain versions (``attn_impl="torch"``, ``norm_impl="jnp"``), then
   one warm round, two counted rounds (launches gated: 784 a LN
   kernel, 28 each codec kernel, 384 each flash kernel) and one profiled
   round (the LN and codec kernels' device time).

10. ``train_int4`` and ``train_fp8``: ``gpt2_topk`` full ``--workers 4
    --codec-warmup 1 --codec int4|fp8``: the same initial parameters as
    ``train``, the fused one-pass wire in its int4 format (50 buckets,
    360,367,280 wire bytes) or fp8 format (123 buckets, 715,190,448). One
    warm round, two counted rounds (launches gated: 384 each flash
    kernel, the fused encode once a bucket a round, nothing else) and one
    profiled round. No gradient check: the model path is ``train``'s.
11. ``gossip_fp8_two_step``: from ``train_fp8``'s final state (its
    optimizer state freed), one compressed CHOCO round on the fp8
    two-step wire (``fused_wire=False``: ``quantize_fp8`` and
    ``dequantize_fp8`` once a bucket, launches gated) and the same round
    on the fused wire; their codes and scales bucket by bucket bit-equal,
    xhat' within one f32 ulp (the fused encode rounds it once, the
    two-step wire twice), the parameters finite.

12. ``train_resnet_topologies``: ``cifar_resnet50`` full ``--norm-impl
    pallas`` (8 workers, the fused-BN kernels) from ``train_resnet``'s
    initial variables on ``--topology torus:rows=2`` (2x4), ``exp``,
    ``onepeer-exp`` (period 3) and ``hierarchical:slices=2,outer_every=2``
    (period 2), one full period plus one round each: every round's gossip
    held to ``W_{step % period} @ x`` computed apart on the card in f32
    (``GOSSIP_RTOL``), the BN kernels' launches gated (53 x 8 a round),
    and, gossip only, onepeer-exp at 8 workers on random stacked
    parameters reaching 1e-6 of its starting consensus error after one
    period (the reference's finite-time guarantee).
Before ``serve``, while this process holds the least of the card, the
collective backend (``--backend collective --dist-backend gloo``): every
worker a process of its own on the one card, the wire between them staged
through pinned host memory (so these round times are not a multi-card
run's: the ranks' kernels are time-sliced on the card and their bytes
cross host memory). Each phase's ranks train through the train CLI's
rank function (one warm round, then one counted round for GPT-2 and two for
ResNet-50 (one for its resumed run), launch counts zeroed
before and read after each), then run one gossip round from seeded
per-worker inputs, which this process holds against the simulated round
on the same stacked inputs (``COLLECTIVE_RTOL``; ``xhat'`` bit-equal):

- ``train_resnet_collective``: ``cifar_resnet50`` full ``--norm-impl
  pallas``, 8 ranks on a ring (no cut), exact bucketed gossip of the
  weights and BN statistics (23 buckets): ``bn_stats``, ``bn_norm``,
  ``bn_bwd`` 53 times a rank a round;
- ``train_resnet_collective_resume`` (the same spawn): ``train_resnet_resume``'s
  round-2 checkpoint resumed on this backend for its last two rounds
  (each rank reads its own worker's file), the update those rounds make
  held against the simulated continuation's within ``COLLECTIVE_RTOL``,
  for the parameters and for the BN statistics apart;
- ``train_collective`` and ``train_collective_topk`` (one spawn of 4
  ranks): ``gpt2_topk`` full ``--workers 4 --codec-warmup 1`` on the
  fused int8 wire (``--codec int8``: 123 encodes and 123 three-source
  ``fused_dequantize_accumulate`` launches a rank a round, 715,190,448
  wire bytes) and on the config's top-k + int8 two-step wire (25 buckets:
  a top-k, a quantize, three dequantizes and three ``chunk_scatter``
  launches a bucket, two of them its accumulating form; 33,366,424 wire
  bytes), the flash forward, dq and dk/dv 48 times a rank a round. Their
  check round covers the first ``GPT2_CHECK_LEAVES`` leaves;
- ``train_collective_overlap`` (the same spawn): ``gpt2_topk`` full
  ``--workers 4 --codec int8 --codec-warmup 0 --codec-refresh 0
  --overlap-gossip``: each round's correction (one CHOCO exchange on the
  fused int8 wire from the params before the local steps) posted before
  the local steps and finished after them, on a process group of its own;
  its line splits ``gossip_ms`` into ``gossip_issue_ms`` and the exposed
  ``gossip_wait_ms``, with ``train_collective``'s ``gossip_ms`` beside;
  its check round is the seeded correction applied and the next one
  computed, against ``apply_correction`` and ``correction_simulated``.

Gates: every rank exits within the timeout; launches and the transport's
bytes a rank a counted round as the code and ``wire_bytes_per_round``
predict; the loss and consensus error all-reduced to one value on every
rank, finite (and the error non-zero on the compressed wires); the check
round within tolerance.

13. ``train_mnist``: ``mnist_mlp`` full (MLP hidden 256, f32, 4 workers,
    dense exact gossip, Adam 1e-3, batch 64) on the card: one warm round,
    50 counted rounds (round time median and spread, images/s, gossip ms,
    the consensus error after each round, wire bytes), one profiled round
    (the device-busy share) and the held-out top-1 of the mean model and
    of each worker on 8 batches. Gates: finite falling losses, the
    consensus error after each dense round within ``DENSE_ERR_RTOL`` of
    the mean parameters' RMS norm, the wire bytes 4 a parameter (one
    send), no port kernel launched, top-1 above 0.5.
14. ``bert_long_padded``: BERT-base at ``max_len`` 1024
    (``bert_base(max_len=1024)``, random numpy-seeded weights), one
    ``bert_mlm_loss_fn`` forward and backward on 8 x 1024 corrupted tokens
    with a ragged attention mask (lengths 1024, 1000, 777, 513, 512, 129,
    1, 0): every layer's attention through the flash kernels' masked form,
    held against the same step on their plain versions (same weights,
    batch and dropout generator) at GPT-2's gradient tolerances. Gates: 12
    launches of each flash kernel, all masked, nothing else.
15. ``train_bert``: ``bert_mlm`` full (BERT-base, bf16, 32 workers on a
    ring, 8 local Adam(1e-4) steps a round, exact bucketed gossip, batch
    32 x 128), the parameters drawn and uploaded a worker at a time: one
    counted round and no warm one (round ms, tokens/s, loss, consensus
    error, peak memory), then 2 held-out MLM batches (masked top-1 and
    nll of the mean model and the workers). Gates: finite losses, finite
    non-zero consensus errors, 75 buckets and 2 x 4 bytes a parameter on
    the wire, the first counted round's gossip equal to ``W @ x``, no port
    kernel launched (seq 128: dense attention, as the reference's).

16. ``train_llama``: ``llama_lora`` full (Llama-2-7B with rank-16 LoRA
    adapters on q, k, v and o, bf16, 16 workers on a 4x4 torus, one
    Adam(1e-3) step on the adapters a round, exact gossip of the adapters
    only, batch 8 x 2048 in micro-batches of 4), world 16 on the one card
    without tensor parallelism (the reference's cut-free run is 16 workers
    x tp 4): the 6.7 B-parameter base drawn and uploaded a leaf at a time
    and held ONCE in bf16 beside the stacked adapters. One worker step's
    adapter gradients through the kernels against their plain versions
    (GPT-2's gates), one counted round and no warm one (round ms against
    the bound of the round's products at the bf16 peak, tokens/s, loss,
    consensus error, peak memory), one held-out batch (nll of the mean
    model and the workers). Gates: 6,738,415,616 base and 16,777,216
    adapter parameters, 16 buckets and 4 shifts x 4 bytes an adapter
    parameter on the wire (the LoRA filter applied to the whole tree),
    every counted round's gossip equal to ``W @ x``, finite losses and
    errors, each flash kernel launched in its head-dim-128 form 32 x 16 x
    2 times a round (layers, workers, micro-batches) and nothing else
    launched.

17. ``train_topk_overlap`` (after ``gossip_fp8_two_step``, from the same
    initial parameters as ``train``): ``gpt2_topk`` full ``--workers 4
    --codec-warmup 0 --codec-refresh 0 --overlap-gossip --gossip-pipeline
    2``: a warm round and two counted rounds, each correction one CHOCO
    exchange on the config's top-k + int8 two-step wire (launches gated:
    25 of each codec kernel a round, the flash kernels 192 a round), every
    correction's queue summing to zero over the workers
    (``CORRECTION_SUM_RTOL``), then two corrections of the first
    ``GPT2_CHECK_LEAVES`` leaves through the kernels and through their
    plain versions, bit for bit.
18. ``train_fused_codec``: ``gpt2_topk`` full ``--workers 4 --codec-warmup
    1`` with ``GossipConfig.fused_codec=True``: the codec once over each
    worker's whole tree (354,823,168 f32 elements laid end to end; one
    call of each codec kernel a round over the four workers' rows), a warm
    round and two counted rounds, the peak memory, then one whole-tree
    round through the kernels (its outputs copied to host memory) and
    through their plain versions, bit for bit.
19. ``train_resnet_overlap`` (after ``train_resnet_pushsum``):
    ``cifar_resnet50`` full ``--norm-impl pallas --overlap-gossip
    --gossip-pipeline 2``: a warm round, three counted rounds (53 x 8
    launches of each BN kernel a round), every correction's queue summing
    to zero, and one round from a copy of the state through the BN kernels
    and through their plain versions: the correction queue and ``z``'s
    consensus error bit-equal (no kernel computes them), the round's
    update within ``RESNET_GRAD_REL_TOL`` (the statistics sum in another
    order).

20. ``train_resnet_resume`` (before the collective spawn, which resumes
    its checkpoint): ``cifar_resnet50`` full ``--norm-impl pallas
    --lr-schedule cosine --warmup-rounds 1 --grad-clip 1.0 --slowmo-beta
    0.2 --eval-batches 2 --eval-every 2``: four rounds straight, then from
    the same start two rounds, a save through ``AsyncSaver``, a restore into
    a freshly built state and two more (cuDNN held to its deterministic
    algorithms for the phase). Each round's learning rate, largest
    pre-clip norm and clip factor, the checkpoint's bytes and its save and
    restore ms, the peak memory; one clipped round through the BN kernels
    against their plain versions. Gates: the two final states equal to the
    bit (every tensor, the generators, the round), the rounds and evals
    equal, the clip fired, 53 x 8 launches of each BN kernel a round.
21. ``train_topk_sched`` (after ``train_perleaf_topk``, from ``train``'s
    initial parameters): ``gpt2_topk`` full ``--workers 4 --codec-warmup
    1 --lr-schedule linear --warmup-rounds 1 --grad-clip 1.0``: a warm
    round and two counted ones with their learning rates, pre-clip norms
    and clip factors (launches gated: the flash kernels 192 a round, each
    codec kernel 25), then one clipped Adam update of worker 0 through the
    flash kernels against their plain versions, with the run's clip and
    with one at half the norm (both sides clip), each within
    ``GRAD_REL_TOL``. No GPT-2 checkpoint is written (its state is about
    28.5 GB); GPT-2's resume is held on the CPU.

The ``check`` line's ``flash_d128`` holds the three flash kernels'
head-dim-128 form at ``llama_lora``'s attention shape (B=4, S=2048, H=32,
causal) to their plain versions at the head-dim-64 gates, timed by
``queued_ms`` beside SDPA; the ``kernels`` line lists each of those forms
as an entry of its own (``form_of``), its launches from ``train_llama``.

The ``check`` line's ``flash_kv_mask`` holds the three flash kernels'
masked form (``kv_mask``) at BERT-base's heads (B=8, S=1024, H=12) with
the same ragged lengths, and gate only at B=4, S=600 (lengths 600, 513,
100, 0), non-causal and causal, against their plain versions at the flash tolerances (a row that attends to no key: the
reference's sum over its visited count, no gradient), timed by
``queued_ms`` beside SDPA with the mask as a boolean (B, 1, 1, T).

The ``check`` line's ``subnormals.operand_probe`` holds the flash
forward, dq and dk/dv kernels on bf16 subnormal operands whose products
are normal (q at 1e-39 against k at 1e38; dO at 1e-38 against V at 2e36)
to their plain versions, which read the subnormal operand as 0 as the
reference does, at the flash tolerances: the kernels flush every tile
they stage.

The ``check`` phase also holds the three fused-BN kernels against their
plain versions at ResNet-50's (131072, 256), (131072, 64), (2048, 2048),
(8192, 1024) and (32768, 512) BN views in bf16, relu on and off, beside
one ``F.batch_norm`` training forward (and its autograd backward) as the
library yardstick; the backward's ``dx`` must equal its plain version fed
the kernel's own sums, the sums must rerun to the same bits.

Then the ``kernels`` line (per kernel: route, source, the TPU kernel it
replaces, launches on its main paths, error, times and bound; the flash
kernels' masked form beside, ``masked_form`` and ``launches_by_form``), the
card's ``nvidia-smi`` name/power-limit line, and last
``{"ok": true, "device": {...}}``. Any failed check raises: the script
exits non-zero without the last line. Without a CUDA device, or outside
the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import gc
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores (the codec kernels' compares and products)

# Kernel against plain version, element by element:
# |kernel - plain| <= ATOL + RTOL * |plain|. Both sides sum in f32 in
# different orders and round to bf16, so an element may land one bf16 ulp
# (at most 2**-7 of its value) away. A dropped 16-key block on a
# 1024-key row moves outputs by ~10% of their size.
PAGED_ATOL, PAGED_RTOL = 1e-5, 2.0**-7
# the flash forward sums over key tiles against a running max the plain
# version does not have, and multiplies P V on the tensor cores with P in
# two bf16 halves (hi = bf16(p), lo = bf16(p - hi): p to ~2**-16); with
# both sides' bf16 rounding of the output, two ulps. One bf16 rounding of
# P would miss this gate by 7-13x (tests/test_torch_flash_attention.py).
FLASH_ATOL, FLASH_RTOL = 1e-4, 2.0**-6
LSE_TOL = 1e-5  # f32 logsumexp (~7 in size), different summation order
LOGITS_REL_TOL = 2.5e-2  # |kernel - plain| / max|plain| after 24 bf16 layers
# flash backward against its plain version, element by element. Both sum
# in f32 in different orders (the kernels on the tensor cores, with p and
# ds as two bf16 halves, the plain version by einsum) and round dq, dk, dv
# to bf16; dk and dq sum ds terms of both signs over up to 1024 rows, so
# an element small next to its row's terms carries the absolute error of
# the large ones.
# Readings at atol 1e-2: max error 3.9e-3 (one bf16 ulp in [0.5, 1)),
# worst err/tolerance 0.2, so small elements erred by at most ~2e-3. At
# atol 3e-3 (S=1024): worst err/tolerance 0.41, against median |dq| 0.050,
# |dk| 0.029, |dv| 0.030 (printed beside the errors).
FLASH_BWD_ATOL, FLASH_BWD_RTOL = 3e-3, 2.0**-6
# one worker step's gradients, kernels against plain versions (same
# weights, batch and dropout masks): ||g_k - g_p|| / ||g_p||, over the
# whole tree and per leaf. bf16 attention outputs differ by an ulp or two
# between the two, and 24 layers of bf16 backward carry that on: the
# first reading was 1.5e-2 (tree) and 1.7e-2 (worst leaf); a backward
# that dropped attention's gradient reads ~1.
GRAD_REL_TOL, LEAF_REL_TOL = 3e-2, 4e-2
# fused BN kernels against their plain versions, fed the same per-channel
# vectors: the normalize pass and the backward's dx round every step as
# the plain versions do, in the same order, so they must be equal (error
# 0; dx given the kernel's own sums); the statistics and the backward's
# two sums are taken in f32 in another order, so each per-channel sum is
# held to BN_SUM_RTOL times the sum of its terms' magnitudes (a dropped
# row of (131072, C) moves a sum by ~7.6e-6 of it). Readings: at most
# 3.5e-7, and norm and dx equal.
BN_SUM_RTOL = 2e-6
# one ResNet-50 worker step (bf16) through the fused-BN kernels against
# the same step on their plain versions: ||g_k - g_p|| / ||g_p|| over the
# tree and per leaf. The reductions' other summation order moves a BN's
# f32 scale and shift by an ulp or so, which flips the bf16 rounding of a
# few outputs, and 53 bf16 layers carry that on. First readings: 2.4e-3
# (tree) and 3.1e-2 (worst leaf: the last block's first BN bias, a sum
# over only 2048 rows of gradients of both signs); a BN backward that
# dropped the statistics' terms reads ~1.
RESNET_GRAD_REL_TOL, RESNET_LEAF_REL_TOL = 1e-2, 5e-2
# fused LayerNorm kernels against their plain versions, fed the same
# values: each row's mean and variance (and the backward's two row means)
# are sums in another order than torch.mean, and rsqrtf is within 2 ulp,
# so y and dx are held to LN_ROW_RTOL of their row's largest element plus,
# for a bf16 output, one bf16 ulp of the element (a rounding the f32
# difference flips); dgamma and dbeta, column sums over M rows in another
# order, to LN_SUM_RTOL of the sum of their terms' magnitudes. Readings at
# (8192, 1024) bf16: y and dx at 0.97 and 0.99 of their tolerance (one
# flipped rounding at a power of two reaches 2**-7 of the value exactly;
# the row term keeps it below 1, and two flips cannot come from an f32
# difference ~1e-6 of the row), the sums at 1.6e-8; f32: 0.03, 0.02, 5.8e-8.
LN_ROW_RTOL, LN_SUM_RTOL = 1e-5, 2e-6
# the fp8 two-step wire's xhat' (q * scale rounded, then xhat + it rounded)
# against the fused wire's (one fused multiply-add), in ulps of the larger
# of |xhat| and |xhat'|: two roundings against one differ by at most 2 of
# them (gossip_two_step_phase); a code or scale off by one moves xhat' by
# a whole quantization step, ~2^20 ulps and more
XHAT_ULPS = 2.0


# each kernel's CUDA symbol in csrc/*.cu, to find its device time in a
# profiler trace
KERNEL_SYMBOLS = {
    "paged_attention": "paged_attention_kernel",
    "flash_attention_fwd": "flash_fwd_kernel",
    "flash_attention_bwd_dq": "flash_bwd_dq_kernel",
    "flash_attention_bwd_dkv": "flash_bwd_dkv_kernel",
    "fused_choco_encode": "choco_encode_(?:int8|int4|fp8)_kernel",
    "fused_dequantize_accumulate": "choco_decode_(?:int8|int4|fp8)_kernel",
    "chunked_topk": "chunked_topk_kernel",
    "quantize_int8": "quantize_int8_kernel",
    "dequantize_int8": "dequantize_int8_kernel",
    "chunk_scatter": "chunk_scatter_kernel",
    "bn_stats": "bn_stats_kernel",
    "bn_norm": "bn_norm_kernel",
    "bn_bwd": "bn_bwd_kernel",
    "quantize_fp8": "quantize_fp8_kernel",
    "dequantize_fp8": "dequantize_fp8_kernel",
    "quantize_int4": "quantize_int4_kernel",
    "dequantize_int4": "dequantize_int4_kernel",
    "ln_fwd": "ln_fwd_kernel",
    "ln_bwd": "ln_bwd_kernel",
}
BN_KERNELS = ("bn_stats", "bn_norm", "bn_bwd")
BN_FWD_KERNELS = ("bn_stats", "bn_norm")
LN_KERNELS = ("ln_fwd", "ln_bwd")
# PyTorch's own batch-norm kernels (cuDNN's or its native ones) in a trace,
# and those of them that belong to the backward
LIBRARY_BN = re.compile(r"batch_?norm|(?<![A-Za-z0-9_])bn_(?:fw|bw)_", re.IGNORECASE)
LIBRARY_BN_BWD = re.compile(r"backward|(?<![A-Za-z0-9_])bn_bw_", re.IGNORECASE)

_T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; phase lines carry the seconds since the script began."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - _T0}
    print(json.dumps(obj), flush=True)


def cuda_ms(torch, fn, iters: int, warm: int = 3) -> float:
    """Mean milliseconds per call of ``fn(i)`` by CUDA events."""
    for i in range(warm):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters: int, warm: int = 3) -> float:
    """Mean device milliseconds per call of ``fn(i)``: the kernels' own time
    under ``torch.profiler`` (CUPTI), summed over every kernel the call
    launches. Unlike :func:`cuda_ms`, the host's time between launches is
    not counted, so a small kernel whose wrapper the host cannot call fast
    enough to keep the card busy still reads its own time."""
    from torch.profiler import ProfilerActivity, profile

    for i in range(warm):
        fn(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(i)
        torch.cuda.synchronize()
    return sum(
        getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)
        for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
    ) / 1e3 / iters


def device_split_ms(torch, fn, iters: int, warm: int = 3) -> dict:
    """Mean device milliseconds per call of ``fn(i)`` for each CUDA kernel
    the call launches, by kernel name (as :func:`device_ms`, not summed):
    which of a wrapper's launches takes the time."""
    from torch.profiler import ProfilerActivity, profile

    for i in range(warm):
        fn(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(i)
        torch.cuda.synchronize()
    return {
        e.key: (getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)) / 1e3 / iters
        for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
    }


def queued_ms(torch, fn, iters: int, warm: int = 3) -> tuple[float, float]:
    """``(ms, enqueue_ms)``: mean device milliseconds per call of ``fn(i)``
    by CUDA events, with the calls queued behind a sleep kernel so that the
    card runs them back to back: the host's time per call, which exceeds a
    small kernel's, stays out of the reading (unlike :func:`cuda_ms`), and
    no profiler record is needed (unlike :func:`device_ms`); and the host's
    milliseconds to enqueue the ``iters`` calls. The sleep starts at ~25
    ms; if the host took longer than the sleep, the run is made once more
    behind a sleep sized to twice the host's time, and raises only if that
    too is overtaken."""
    for i in range(warm):
        fn(i)
    torch.cuda.synchronize()
    cycles = 50_000_000  # ~25 ms at the H100's clocks
    for _attempt in range(2):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(cycles)
        ev[1].record()
        t0 = time.perf_counter()
        for i in range(iters):
            fn(i)
        host_ms = 1e3 * (time.perf_counter() - t0)
        ev[2].record()
        ev[2].synchronize()
        sleep_ms = ev[0].elapsed_time(ev[1])
        if host_ms < sleep_ms:
            return ev[1].elapsed_time(ev[2]) / iters, host_ms
        cycles = int(cycles * 2 * host_ms / sleep_ms) + 1
    raise AssertionError(f"queued_ms: enqueueing took {host_ms} ms, longer than the {sleep_ms} ms sleep")


def tol_check(name, got, want, atol, rtol) -> dict:
    """Hold ``got`` to ``want`` element by element: every
    ``|got - want| <= atol + rtol * |want|``; raises otherwise."""
    err = (got.float() - want.float()).abs()
    ratio = (err / (atol + rtol * want.float().abs())).max().item()
    out = {"max_abs_err": err.max().item(), "atol": atol, "rtol": rtol, "worst_err_over_tol": ratio}
    if not ratio <= 1.0:
        raise AssertionError(f"{name}: outside tolerance {out}")
    return out


def bound_ms(nbytes: float, flops: float, peak: float = BF16_FLOPS) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / peak
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def rates(ms: float, flops: float, library_ms: float, bound: float) -> dict:
    """The function's work over the kernel's time (TFLOP/s), and the time as
    a multiple of the library call's and of the bound's."""
    return {"tflops": flops / ms / 1e9, "x_library": ms / library_ms, "x_bound": ms / bound}


def check_paged(torch, tpa, dev):
    """Decode-step shapes of the serving path: 8 slots, 16 heads, head dim
    64, 16-token blocks, 64 blocks per slot; W=1 (decode) and W=4. ``ms``
    is CUDA events over 100 calls queued behind a sleep kernel
    (:func:`queued_ms`: the kernel runs faster than the host calls its
    wrapper), ``enqueue_ms`` the host's time to enqueue those calls
    (the sleep's margin), ``profiler_ms`` profiler device time, ``event_ms`` and
    ``plain_ms`` CUDA events over calls as the host issues them; ``plan``
    is the launch plan (``paged_plan``)."""
    s, h, d, bs, nb = 8, 16, 64, 16, 64
    n = s * nb + 1
    gen = torch.Generator(device=dev).manual_seed(0)
    # four page sets (~134 MB in all, above the 50 MB L2) so timed launches
    # read K/V from device memory, as 24 layers of real pages do
    sets = [
        tuple(torch.randn(n, bs, h, d, generator=gen, device=dev, dtype=torch.bfloat16)
              for _ in range(2))
        for _ in range(4)
    ]
    table = (torch.randperm(n - 1, generator=gen, device=dev)[: s * nb] + 1).view(s, nb)
    table = table.to(torch.int32).contiguous()
    lengths = torch.tensor([1, 17, 511, 1024, 100, 300, 700, 64], dtype=torch.int32, device=dev)
    out = {}
    for w in (1, 4):
        pos = torch.clamp(lengths[:, None] - w + torch.arange(w, device=dev)[None, :], min=0)
        pos = pos.to(torch.int32).contiguous()
        q = torch.randn(s, w, h, d, generator=gen, device=dev, dtype=torch.bfloat16)
        k, v = sets[0]
        got = tpa.paged_attention(q, k, v, table, pos)
        want = tpa.paged_attention_plain(q, k, v, table, pos)
        torch.cuda.synchronize()
        errs = tol_check(f"paged_attention W={w}", got, want, PAGED_ATOL, PAGED_RTOL)
        keys = int(lengths.sum())  # keys each head must read once (union over W)
        pairs = int((pos.long() + 1).sum())  # (query row, key) pairs computed, per head
        nbytes = 2 * keys * h * d * 2 + 2 * q.numel() * 2 + table.numel() * 4 + pos.numel() * 4
        bms, by = bound_ms(nbytes, 4 * pairs * h * d)
        plan = tpa.paged_plan(nb, bs, h, d, w, h)
        ms, enqueue_ms = queued_ms(torch, lambda i: tpa.paged_attention(q, *sets[i % 4], table, pos), 100)
        times = {
            "ms": ms,
            "enqueue_ms": enqueue_ms,
            "plain_ms": cuda_ms(torch, lambda i: tpa.paged_attention_plain(q, *sets[i % 4], table, pos), 10),
            "profiler_ms": device_ms(torch, lambda i: tpa.paged_attention(q, *sets[i % 4], table, pos), 100),
            "event_ms": cuda_ms(torch, lambda i: tpa.paged_attention(q, *sets[i % 4], table, pos), 100),
        }
        out[w] = {
            **errs, **times, "x_bound": times["ms"] / bms, "plan": plan._asdict(),
            "library_ms": None, "bound_ms": bms, "bound_by": by,
        }
    return out


# Llama-2-7B's decode shapes (llama_lora full, max_len 4096): 8 slots of
# 256 16-token pages, one slot a length from 1 to all 4096 (so one slot's
# cluster reads from all 16 blocks), W 1, 4 and 8, and a GQA case
PAGED_LLAMA_LENGTHS = (4096, 1, 17, 2048, 3000, 100, 1234, 4000)
PAGED_LLAMA_CASES = (("W=1", 1, 32), ("W=4", 4, 32), ("W=8", 8, 32), ("W=1 Hkv=8", 1, 8))


def check_paged_llama(torch, tpa, dev):
    """The paged kernel at Llama-2-7B's heads (32 query heads of dim 128:
    H * D 4096, so a cluster a head group of 8) on 32 kv heads at W 1, 4
    and 8, and on 8 (GQA rep 4, 2 kv heads a block) at W 1: 8 slots of
    256 pages of 16 (4096 tokens), ``PAGED_LLAMA_LENGTHS``. Each case held
    to ``paged_attention_plain`` at the paged gate, and timed as
    :func:`check_paged` times GPT-2's, over four page sets (2.1 GB at 32
    kv heads, above the 50 MB L2) so timed launches read K/V from device
    memory; ``plan`` is the launch plan."""
    s, h, d, bs, nb = 8, 32, 128, 16, 256
    n = s * nb + 1
    gen = torch.Generator(device=dev).manual_seed(1)
    lengths = torch.tensor(PAGED_LLAMA_LENGTHS, dtype=torch.int32, device=dev)
    table = (torch.randperm(n - 1, generator=gen, device=dev)[: s * nb] + 1).view(s, nb).to(torch.int32).contiguous()
    out = {}
    for hkv in (32, 8):
        sets = [tuple(torch.randn(n, bs, hkv, d, generator=gen, device=dev, dtype=torch.bfloat16) for _ in range(2))
                for _ in range(4)]
        for name, w, case_hkv in PAGED_LLAMA_CASES:
            if case_hkv != hkv:
                continue
            pos = torch.clamp(lengths[:, None] - w + torch.arange(w, device=dev)[None, :], min=0)
            pos = pos.to(torch.int32).contiguous()
            q = torch.randn(s, w, h, d, generator=gen, device=dev, dtype=torch.bfloat16)
            k, v = sets[0]
            grouped = tpa.paged_attention.grouped_launches
            got = tpa.paged_attention(q, k, v, table, pos)
            want = tpa.paged_attention_plain(q, k, v, table, pos)
            torch.cuda.synchronize()
            if tpa.paged_attention.grouped_launches != grouped + 1:
                raise AssertionError(f"paged_attention {name} at Llama's heads did not take head groups")
            errs = tol_check(f"paged_attention Llama {name}", got, want, PAGED_ATOL, PAGED_RTOL)
            keys = int(lengths.sum())  # keys each kv head must read once (union over W)
            pairs = int((pos.long() + 1).sum())
            nbytes = 2 * keys * hkv * d * 2 + 2 * q.numel() * 2 + table.numel() * 4 + pos.numel() * 4
            bms, by = bound_ms(nbytes, 4 * pairs * h * d)
            plan = tpa.paged_plan(nb, bs, hkv, d, w, h)
            call = lambda i: tpa.paged_attention(q, *sets[i % 4], table, pos)  # noqa: E731
            ms, enqueue_ms = queued_ms(torch, call, 100)
            times = {
                "ms": ms, "enqueue_ms": enqueue_ms,
                "plain_ms": cuda_ms(torch, lambda i: tpa.paged_attention_plain(q, *sets[i % 4], table, pos), 10),
                "profiler_ms": device_ms(torch, call, 100), "event_ms": cuda_ms(torch, call, 100),
            }
            out[name] = {
                **errs, **times, "x_bound": ms / bms, "plan": plan._asdict(), "library_ms": None,
                "bound_ms": bms, "bound_by": by, "shape": f"S={s} W={w} H={h} Hkv={hkv} D={d} bs={bs} nb={nb}",
                "kv_bytes": 2 * keys * hkv * d * 2,
            }
        del sets
        torch.cuda.empty_cache()
    return out


def check_flash(torch, tfa, dev):
    """Prefill shapes: batch 1, 16 heads, head dim 64, causal; S = 600
    (a ragged real length) and 1024 (the bucket the engine pads to)."""
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(1)
    out = {}
    for s in (600, 1024):
        q, k, v = (
            torch.randn(1, s, 16, 64, generator=gen, device=dev, dtype=torch.bfloat16)
            for _ in range(3)
        )
        got, lse = tfa.flash_attention(q, k, v, causal=True, return_lse=True)
        want, want_lse = tfa.flash_attention_plain(q, k, v, causal=True, return_lse=True)
        torch.cuda.synchronize()
        errs = tol_check(f"flash_attention S={s}", got, want, FLASH_ATOL, FLASH_RTOL)
        lse_err = (lse - want_lse).abs().max().item()
        if not lse_err <= LSE_TOL:
            raise AssertionError(f"flash_attention S={s}: lse err {lse_err} > {LSE_TOL}")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        kernel_ms = cuda_ms(torch, lambda i: tfa.flash_attention(q, k, v, causal=True), 50)
        plain_ms = cuda_ms(torch, lambda i: tfa.flash_attention_plain(q, k, v, causal=True), 10)
        library_ms = cuda_ms(
            torch, lambda i: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True), 50
        )
        flops = 4 * 16 * 64 * s * (s + 1) // 2
        bms, by = bound_ms(4 * q.numel() * 2, flops)
        out[s] = {
            **errs, "lse_max_abs_err": lse_err, "lse_tol": LSE_TOL, "ms": kernel_ms,
            "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bms, "bound_by": by,
            **rates(kernel_ms, flops, library_ms, bms),
        }
    return out


def check_subnormals(torch, tfa, tpa, tln, dev):
    """The reference's compiled program flushes f32 subnormals; so must the
    kernels where they produce a result. Gates: with head 1's V at 1e-39
    (bf16 subnormals; B=1, S=1024, 2 heads, causal) the flash forward, dq
    and dk/dv kernels give that head out, dq and dk of 0, as their plain
    versions do; paged attention with kv head 1's V at 1e-39 (W = 1, 8
    slots, GQA rep 2) gives its query heads 0; the LN kernels give y = 0
    for a row of x at 1e-39 (beta 0) and dx = 0 for a row of dy at 1e-39.
    And ``operand_probe``: subnormal operands whose products are normal,
    which the reference reads as 0 (:func:`operand_probe`)."""
    gen = torch.Generator(device=dev).manual_seed(11)
    q, k, v, do = (torch.randn(1, 1024, 2, 64, generator=gen, device=dev, dtype=torch.bfloat16) for _ in range(4))
    v[:, :, 1] = (v[:, :, 1].float() * 1e-39).to(torch.bfloat16)
    out, lse = tfa.flash_attention(q, k, v, causal=True, return_lse=True)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dq = tfa.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal=True)
    dk, dv = tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal=True)
    want = tfa._bwd_plain_parts(q, k, v, do, lse, delta, True)
    torch.cuda.synchronize()
    flash = {name: float(t[:, :, 1].float().abs().max()) for name, t in (("out", out), ("dq", dq), ("dk", dk))}
    flash.update({f"plain_{name}": float(t[:, :, 1].float().abs().max()) for name, t in (("dq", want[0]),
                                                                                         ("dk", want[1]))})
    flash["dv_err_over_tol"] = tol_check("flash dv, subnormal head", dv, want[2], FLASH_BWD_ATOL,
                                         FLASH_BWD_RTOL)["worst_err_over_tol"]
    probe = operand_probe(torch, tfa, dev)
    # paged attention, W = 1, kv head 1 of 8 subnormal
    s_, h, bs, nb = 8, 16, 16, 64
    n = s_ * nb + 1
    kk, vv = (torch.randn(n, bs, 8, 64, generator=gen, device=dev, dtype=torch.bfloat16) for _ in range(2))
    vv[:, :, 1] = (vv[:, :, 1].float() * 1e-39).to(torch.bfloat16)
    table = (torch.randperm(n - 1, generator=gen, device=dev)[: s_ * nb] + 1).view(s_, nb).to(torch.int32)
    pos = torch.tensor([[1], [17], [511], [1023], [100], [300], [700], [64]], dtype=torch.int32, device=dev)
    qq = torch.randn(s_, 1, h, 64, generator=gen, device=dev, dtype=torch.bfloat16)
    po = tpa.paged_attention(qq, kk, vv, table.contiguous(), pos)
    pp = tpa.paged_attention_plain(qq, kk, vv, table, pos)
    # LayerNorm, (64, 1024) f32
    x = torch.randn(64, 1024, generator=gen, device=dev)
    dyl = torch.randn(64, 1024, generator=gen, device=dev)
    x[5] *= 1e-39
    dyl[9] *= 1e-39
    gamma, beta = 1 + 0.1 * torch.randn(1024, generator=gen, device=dev), torch.zeros(1024, device=dev)
    y = tln.ln_fwd(x, gamma, beta, 1e-6)
    dx = tln.ln_bwd(dyl, x, gamma, 1e-6)[0]
    torch.cuda.synchronize()
    out = {
        "flash_head1_max_abs": flash, "operand_probe": probe,
        "paged_heads_2_3_max_abs": float(po[:, :, 2:4].float().abs().max()),
        "paged_plain_heads_2_3_max_abs": float(pp[:, :, 2:4].float().abs().max()),
        "ln_y_row_max_abs": float(y[5].abs().max()), "ln_dx_row_max_abs": float(dx[9].abs().max()),
    }
    if (any(flash[key] for key in ("out", "dq", "dk", "plain_dq", "plain_dk")) or out["paged_heads_2_3_max_abs"]
            or out["paged_plain_heads_2_3_max_abs"] or out["ln_y_row_max_abs"] or out["ln_dx_row_max_abs"]):
        raise AssertionError(f"a subnormal head or row was not flushed: {out}")
    return out


def operand_probe(torch, tfa, dev, s=256, h=2):
    """The flash kernels on bf16 subnormal operands whose products are
    normal, against their plain versions, which read a subnormal operand as
    0 as the reference does (B=1, S=256, H=2, causal). Probe ``q``: q at
    +-1e-39 against k at +-1e38 (logits +-0.1 unflushed; flushed, uniform
    probabilities): the forward's out and lse, and dk/dv. Probe ``do``: dO
    at +-1e-38 against V at +-2e36 (dp ~0.16 unflushed; flushed, dq = dk =
    dv = 0): dq and dk/dv. The backward kernels take the plain forward's
    lse and delta; dq is not taken in probe ``q``, where dS K overflows.
    Each is gated at the flash tolerances; ``unflushed_vs_plain`` is the
    distance of the same math on the unflushed q from the plain forward,
    for scale."""
    gen = torch.Generator(device=dev).manual_seed(13)
    sign = lambda: torch.where(torch.randn(1, s, h, 64, generator=gen, device=dev) >= 0, 1.0, -1.0)  # noqa: E731
    rnd = lambda: torch.randn(1, s, h, 64, generator=gen, device=dev, dtype=torch.bfloat16)  # noqa: E731
    out = {}
    for name in ("q", "do"):
        q, k, v, do = rnd(), rnd(), rnd(), rnd()
        if name == "q":
            q, k = (sign() * 1e-39).to(torch.bfloat16), (sign() * 1e38).to(torch.bfloat16)
        else:
            do, v = (sign() * 1e-38).to(torch.bfloat16), (sign() * 2e36).to(torch.bfloat16)
        ref, ref_lse = tfa.flash_attention_plain(q, k, v, causal=True, return_lse=True)
        delta = tfa._delta(ref, do)
        want = tfa._bwd_plain_parts(q, k, v, do, ref_lse, delta, True)
        dk, dv = tfa.flash_attention_bwd_dkv(q, k, v, do, ref_lse, delta, causal=True)
        checks = {"dk": (dk, want[1]), "dv": (dv, want[2])}
        if name == "q":
            o, lse = tfa.flash_attention(q, k, v, causal=True, return_lse=True)
            torch.cuda.synchronize()
            row = {"out": tol_check("flash forward, subnormal q", o, ref, FLASH_ATOL, FLASH_RTOL),
                   "lse_max_abs_err": float((lse - ref_lse).abs().max())}
            if not row["lse_max_abs_err"] <= LSE_TOL:
                raise AssertionError(f"flash forward, subnormal q: lse {row}")
            logits = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) / 8.0
            logits = logits.masked_fill(~torch.ones(s, s, dtype=torch.bool, device=dev).tril(), -torch.inf)
            kept = torch.einsum("bhst,bthd->bshd", torch.softmax(logits, -1), v.float())
            row["unflushed_vs_plain"] = float((kept - ref.float()).abs().max())
        else:
            dq = tfa.flash_attention_bwd_dq(q, k, v, do, ref_lse, delta, causal=True)
            checks["dq"] = (dq, want[0])
            row = {"plain_max_abs": max(float(w.float().abs().max()) for w in want)}
        torch.cuda.synchronize()
        for key, (g, w) in checks.items():
            row[key] = tol_check(f"flash {key}, subnormal {name}", g, w, FLASH_BWD_ATOL, FLASH_BWD_RTOL)
        out[name] = row
    return out


def check_flash_bwd(torch, tfa, dev):
    """Training shapes: batch 8, 16 heads, head dim 64, causal; S = 1024
    (the training sequence) and 600 (ragged). The forward kernel's
    ``out`` and ``lse`` are held against ``flash_attention_plain`` (at
    b > 0 the kernel offsets its rows by the batch index, which batch 1
    never does); dq, dk, dv of both backward kernels, fed the kernel's
    forward, are held against ``flash_attention_bwd_plain`` fed the
    plain forward, so a fault in either pass shows. Returns the backward's
    readings and the forward's at these shapes."""
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(2)
    out, fwd = {}, {}
    for s in (600, 1024):
        b, h, d = 8, 16, 64
        q, k, v, do = (
            torch.randn(b, s, h, d, generator=gen, device=dev, dtype=torch.bfloat16)
            for _ in range(4)
        )
        o, lse = tfa.flash_attention(q, k, v, causal=True, return_lse=True)
        want_o, want_lse = tfa.flash_attention_plain(q, k, v, causal=True, return_lse=True)
        torch.cuda.synchronize()
        fwd_errs = tol_check(f"flash_attention B={b} S={s}", o, want_o, FLASH_ATOL, FLASH_RTOL)
        lse_err = (lse - want_lse).abs().max().item()
        if not lse_err <= LSE_TOL:
            raise AssertionError(f"flash_attention B={b} S={s}: lse err {lse_err} > {LSE_TOL}")
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        dq = tfa.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal=True)
        dk, dv = tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal=True)
        want = tfa.flash_attention_bwd_plain(q, k, v, want_o, do, want_lse, causal=True)
        torch.cuda.synchronize()
        errs = {
            name: {
                **tol_check(f"flash_attention_bwd {name} S={s}", g, w, FLASH_BWD_ATOL, FLASH_BWD_RTOL),
                "median_abs": w.float().abs().median().item(),
            }
            for name, g, w in (("dq", dq, want[0]), ("dk", dk, want[1]), ("dv", dv, want[2]))
        }
        del want, want_o, want_lse
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        pairs = b * h * s * (s + 1) // 2  # (query, key) pairs of the causal mask
        fwd_bound = bound_ms(4 * q.numel() * 2 + b * h * s * 4, 4 * d * pairs)  # q k v read, out lse written
        fwd[s] = {
            **fwd_errs, "lse_max_abs_err": lse_err, "lse_tol": LSE_TOL,
            "ms": cuda_ms(torch, lambda i: tfa.flash_attention(q, k, v, causal=True, return_lse=True), 20),
            "plain_ms": cuda_ms(torch, lambda i: tfa.flash_attention_plain(q, k, v, causal=True), 5),
            "library_ms": cuda_ms(torch, lambda i: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True), 20),
            "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1],
        }
        fwd[s].update(rates(fwd[s]["ms"], 4 * d * pairs, fwd[s]["library_ms"], fwd_bound[0]))
        dq_ms = cuda_ms(torch, lambda i: tfa.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal=True), 20)
        dkv_ms = cuda_ms(torch, lambda i: tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal=True), 20)
        plain_ms = cuda_ms(torch, lambda i: tfa.flash_attention_bwd_plain(q, k, v, o, do, lse, causal=True), 5)
        # the library yardstick: SDPA's backward, as (forward + backward) - forward
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        dot = do.transpose(1, 2)

        def sdpa_fwd_bwd(i):
            y = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
            torch.autograd.grad(y, (qt, kt, vt), dot)

        with torch.no_grad():
            sdpa_fwd = cuda_ms(torch, lambda i: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True), 20)
        library_ms = cuda_ms(torch, sdpa_fwd_bwd, 20) - sdpa_fwd
        elems = b * s * h * d
        rows = b * h * s
        dq_bound = bound_ms(5 * elems * 2 + 2 * rows * 4, 6 * d * pairs)  # read q k v do lse delta, write dq
        dkv_bound = bound_ms(6 * elems * 2 + 2 * rows * 4, 8 * d * pairs)  # ... write dk dv
        out[s] = {
            **{f"{n}_{key}": val for n, e in errs.items() for key, val in e.items()},
            "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
            "dq_ms": dq_ms, "dkv_ms": dkv_ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "dq_bound_ms": dq_bound[0], "dq_bound_by": dq_bound[1],
            "dkv_bound_ms": dkv_bound[0], "dkv_bound_by": dkv_bound[1],
            # each kernel, and the two together, against SDPA's whole
            # backward (it has no dq-only or dk/dv-only call)
            **{f"dq_{key}": val for key, val in rates(dq_ms, 6 * d * pairs, library_ms, dq_bound[0]).items()},
            **{f"dkv_{key}": val for key, val in rates(dkv_ms, 8 * d * pairs, library_ms, dkv_bound[0]).items()},
            "bwd_ms": dq_ms + dkv_ms, "bwd_x_library": (dq_ms + dkv_ms) / library_ms,
        }
    return out, fwd


def hazard_rows(torch, dev, chunk):
    """Rows appended to every codec check: f32 subnormals only (scale 0,
    codes 0), an absmax whose scale would be subnormal (scale 0),
    subnormal elements beside a tiny normal absmax (read as zeros), a
    NaN, a +inf and a -inf element."""
    tiny = 2.0**-126
    sign = torch.where(torch.arange(chunk, device=dev) % 2 == 1, 1.0, -1.0)
    rows = torch.stack([1e-39 * sign, 5e-38 * sign, 0.9 * tiny * sign,
                        sign, sign, sign])
    rows[2, 0] = 448 * 1.5 * tiny
    rows[3, 3], rows[4, 4], rows[5, 5] = float("nan"), float("inf"), float("-inf")
    return rows


def encode_case(torch, dev, gen, rows, chunk):
    """(x, xhat) for the fused encode: the zero-delta, +0/-0 and
    round-half rows of the int8 quantizer first, the hazard rows (and
    a subnormal xhat under a zero x) appended."""
    x = torch.randn(rows, chunk, generator=gen, device=dev)
    xhat = x + 0.1 * torch.randn(rows, chunk, generator=gen, device=dev)
    x[0] = xhat[0]
    x[1] = 0.0
    xhat[1] = torch.where(torch.arange(chunk, device=dev) % 2 == 1, -0.0, 0.0)
    half = torch.randint(-126, 127, (chunk,), generator=gen, device=dev).float() + 0.5
    x[2] = xhat[2] + half
    x[2, 0] = xhat[2, 0] + 127.0
    hz = hazard_rows(torch, dev, chunk)
    x = torch.cat([x, hz, torch.zeros(1, chunk, device=dev)])
    xhat = torch.cat([xhat, torch.zeros_like(hz), torch.full((1, chunk), -2e-39, device=dev)])
    return x, xhat


def check_encode(torch, tck, dev, largest_rows):
    """The fused CHOCO encode, held BIT FOR BIT against its plain version
    (q, scales and xhat'; NaN payload bits aside): int8 on a (4 * 8192,
    512) f32 pair (4 workers' copies of a 4 MiB-wire bucket), int4 and fp8
    at ``--codec int4|fp8``'s largest bucket's rows (4 x 100,514 rows of
    512). Row 0 has a zero delta (scale 0), row 1 x = 0 over an xhat of
    mixed +0/-0 (xhat' must be +0), row 2 deltas on the round-half points
    of the int8 quantizer; the hazard rows follow. No library yardstick:
    no one PyTorch call quantizes and tracks."""
    gen = torch.Generator(device=dev).manual_seed(3)
    out = {}
    for fmt, rows in (("int8", 4 * 8192), ("int4", largest_rows), ("fp8", largest_rows)):
        chunk = 512
        x, xhat = encode_case(torch, dev, gen, rows, chunk)
        got = tck.fused_pack_quantize(x, xhat, fmt=fmt)
        want = tck.fused_pack_quantize_plain(x, xhat, fmt)
        torch.cuda.synchronize()
        mismatched = {n: mismatches(torch, g, w) for n, g, w in zip(("q", "scales", "xhat"), got, want)}
        if any(mismatched.values()):
            raise AssertionError(f"fused_choco_encode {fmt} differs from its plain version: {mismatched}")
        r0 = rows  # the first hazard row
        if not (got[1][0] == 0 and not torch.signbit(got[2][1]).any() and got[1][r0] == 0 and got[1][r0 + 1] == 0
                and torch.isnan(got[1][r0 + 3]) and not got[2][-1].any() and (fmt != "int8" or got[1][2] == 1.0)):
            raise AssertionError(f"fused_choco_encode {fmt}: zero, -0, round-half or hazard rows wrong")
        fin = torch.isfinite(want[1])
        err = max_abs_err(torch, (got[0].view(torch.uint8), want[0].view(torch.uint8)), (got[1][fin], want[1][fin]),
                          (got[2][fin], want[2][fin]))
        del got, want
        sets = [(torch.randn(rows, chunk, generator=gen, device=dev), xhat[:rows]) for _ in range(3)]
        kernel_ms = cuda_ms(torch, lambda i: tck.fused_pack_quantize(*sets[i % 3], fmt=fmt), 30)
        plain_ms = cuda_ms(torch, lambda i: tck.fused_pack_quantize_plain(*sets[i % 3], fmt), 5)
        n = rows * chunk
        wire = n // 2 if fmt == "int4" else n
        bms, by = bound_ms(2 * 4 * n + wire + 4 * rows + 4 * n, 5 * n, F32_FLOPS)
        out[fmt] = {
            "rows": rows, "hazard_rows": x.shape[0] - rows, "chunk": chunk, "mismatched": mismatched,
            "max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": bms, "bound_by": by,
        }
        del x, xhat, sets
        torch.cuda.empty_cache()
    return out


def check_fp8(torch, tck, dev, totals, world=4, chunk=512):
    """The fp8 quantize and dequantize at ``--codec fp8``'s shapes on the
    two-step wire (``fused_wire=False``): the rows of its largest and
    median buckets (per worker ``total / 512``, all workers' copies in one
    launch), the hazard rows appended, held BIT FOR BIT against their
    plain versions (NaN payload bits aside). ``ms`` is profiler device
    time. No library yardstick: no PyTorch call computes per-row scales
    and casts, and the dequantize is a cast and a product."""
    gen = torch.Generator(device=dev).manual_seed(10)
    out = {}
    for label, total in (("largest", max(totals)), ("median", sorted(totals)[len(totals) // 2])):
        rows = world * total // chunk
        x = 3 * torch.randn(rows, chunk, generator=gen, device=dev)
        x *= 10.0 ** torch.randint(-30, 30, (rows, 1), generator=gen, device=dev)
        x = torch.cat([x, hazard_rows(torch, dev, chunk)])
        q, sc = tck.quantize_fp8(x)
        qp, scp = tck.quantize_fp8_plain(x)
        d = tck.dequantize_fp8(q, sc)
        dp = tck.dequantize_fp8_plain(q, sc)
        torch.cuda.synchronize()
        bad_q = {"q": mismatches(torch, q, qp), "scales": mismatches(torch, sc, scp)}
        bad_d = mismatches(torch, d, dp)
        codes = q.view(torch.uint8)
        hazards_ok = (sc[rows] == 0 and sc[rows + 1] == 0 and not (codes[rows:rows + 2] & 0x7F).any()
                      and torch.isnan(sc[rows + 3]) and codes[rows + 3, 3] == 0x7F and torch.isinf(sc[rows + 4]))
        if any(bad_q.values()) or bad_d or not hazards_ok:
            raise AssertionError(f"fp8 kernels ({label}) differ from their plain versions: {bad_q}, "
                                 f"dequantize {bad_d}, hazard rows ok: {hazards_ok}")
        r, m = x.shape[0], x.numel()
        qb, qby = bound_ms(4 * m + m + 4 * r, 3 * m, F32_FLOPS)
        db, dby = bound_ms(m + 4 * r + 4 * m, m, F32_FLOPS)
        fin = torch.isfinite(sc)
        out[label] = {
            "quantize_fp8": {
                "rows": r, "chunk": chunk, "mismatched": bad_q,
                "max_abs_err": max_abs_err(torch, (codes, qp.view(torch.uint8)), (sc[fin], scp[fin])),
                **small_kernel_times(torch, lambda _: tck.quantize_fp8(x), lambda _: tck.quantize_fp8_plain(x)),
                "library_ms": None, "library": "none: no PyTorch call computes per-row scales and casts",
                "bound_ms": qb, "bound_by": qby,
            },
            "dequantize_fp8": {
                "rows": r, "chunk": chunk, "mismatched": bad_d,
                "max_abs_err": max_abs_err(torch, (d[fin], dp[fin])),
                **small_kernel_times(torch, lambda _: tck.dequantize_fp8(q, sc),
                                     lambda _: tck.dequantize_fp8_plain(q, sc)),
                "library_ms": None, "library": "none: a cast and a product are two calls",
                "bound_ms": db, "bound_by": dby,
            },
        }
        del x, q, qp, d, dp
        torch.cuda.empty_cache()
    return out


def check_decode(torch, tck, dev, rows, chunk=512, weights=(1 / 3, 1 / 3, 1 / 3)):
    """``fused_dequantize_accumulate`` (the fused wire's receive, which
    only the collective round calls: ``train_collective``) in all
    three formats at the largest bucket's rows with the ring's three
    sources at 1/3, held BIT FOR BIT against its plain version (NaN
    payload bits aside). The sources are fused encodes of random rows
    with the hazard rows appended; ``s`` carries a subnormal, a -0, an
    inf and a NaN. No library yardstick: no one PyTorch call decodes and
    accumulates."""
    gen = torch.Generator(device=dev).manual_seed(12)
    out = {}
    for fmt in ("int8", "int4", "fp8"):
        hz = hazard_rows(torch, dev, chunk)
        s = torch.cat([torch.randn(rows, chunk, generator=gen, device=dev), hz])
        s[0, :4] = torch.tensor([1e-39, -0.0, float("inf"), float("nan")], device=dev)
        sources = []
        for j in range(len(weights)):
            x = torch.cat([torch.randn(rows, chunk, generator=gen, device=dev) * 10.0 ** (-j), hz])
            data, scales, _ = tck.fused_pack_quantize(x, torch.zeros_like(x), fmt=fmt)
            sources.append((data, scales))
            del x
        got = tck.fused_dequantize_accumulate(s, sources, fmt=fmt, weights=weights)
        want = tck.fused_dequantize_accumulate_plain(s, sources, fmt=fmt, weights=weights)
        torch.cuda.synchronize()
        bad = mismatches(torch, got, want)
        if bad:
            raise AssertionError(f"fused_dequantize_accumulate {fmt} differs from its plain version: {bad} elements")
        fin = torch.isfinite(want)
        err = max_abs_err(torch, (got[fin], want[fin]))
        del got, want
        n, r = s.numel(), s.shape[0]
        wire = n // 2 if fmt == "int4" else n
        j = len(weights)
        bms, by = bound_ms(4 * n + j * (wire + 4 * r) + 4 * n, (3 * j + 1) * n, F32_FLOPS)
        out[fmt] = {
            "rows": r, "chunk": chunk, "sources": j, "weights": list(weights), "mismatched": bad,
            "max_abs_err": err,
            "ms": cuda_ms(torch, lambda _: tck.fused_dequantize_accumulate(s, sources, fmt=fmt, weights=weights), 30),
            "plain_ms": cuda_ms(torch, lambda _: tck.fused_dequantize_accumulate_plain(
                s, sources, fmt=fmt, weights=weights), 5),
            "library_ms": None, "bound_ms": bms, "bound_by": by,
        }
        del s, sources
        torch.cuda.empty_cache()
    return out


def topk_bucket_totals(torch, dev, codec=None) -> list[int]:
    """Per-worker lengths of the buckets of ``gpt2_topk`` full on ``codec``
    (None: its own; the engine's plan over GPT-2-medium's shapes)."""
    from consensusml_tpu_torch import configs
    from consensusml_tpu_torch.models.gpt2 import GPT2LM

    bundle = configs.build("gpt2_topk", "full", world=4, codec=codec, device=dev)
    meta = GPT2LM(configs.gpt2_config("full"), device="meta")
    plan = bundle.cfg.engine().bucket_plan({"params": dict(meta.named_parameters()), "model_state": {}})
    return [b.total for b in plan.buckets]


def mismatches(torch, got, want) -> int:
    """Elements whose bits differ (shapes and dtypes must agree); two NaNs
    count as equal whatever their payload bits."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"shape/dtype {tuple(got.shape)} {got.dtype} vs {tuple(want.shape)} {want.dtype}")
    view = torch.int8 if got.element_size() == 1 else torch.int32
    differ = got.view(view) != want.view(view)
    if got.dtype == torch.float32:
        differ &= ~(torch.isnan(got) & torch.isnan(want))
    return int(differ.sum())


def max_abs_err(torch, *pairs) -> float:
    """max |got - want| over (got, want) pairs, in f32 (int8 codes as
    their values)."""
    return max(float((g.float() - w.float()).abs().max()) if g.numel() else 0.0 for g, w in pairs)


def seed_codec_rows(torch, x, gen) -> None:
    """The codec kernels' hazards in the first rows of an (R, C) f32
    tensor: a zero row, a row of +0/-0, round-half points of the int8
    quantizer (scale 1), a tie of opposite signs among fewer non-zeros
    than k, a row of equal magnitudes."""
    c = x.shape[1]
    col = torch.arange(c, device=x.device)
    x[0] = 0.0
    x[1] = torch.where(col % 2 == 1, -0.0, 0.0)
    x[2] = torch.randint(-126, 127, (c,), generator=gen, device=x.device).float() + 0.5
    x[2, 0] = 127.0
    x[3] = 0.0
    x[3, 5], x[3, 9], x[3, 40] = -3.0, 3.0, -0.0
    x[4] = torch.where(col % 3 == 0, 2.0, -2.0)


def check_codec(torch, tck, dev, totals, world=4, chunk=512, k=8):
    """The top-k codec's four kernels at the main path's shapes, each held
    BIT FOR BIT against its plain version (zero mismatched elements) and
    timed beside it:

    - chunked top-k and the no-acc chunk scatter on the largest bucket
      (the ``wte`` leaf: 4 workers x 100,514 rows of 512) and the median
      one, the scatter fed the top-k's own winners; the acc form (the
      collective receive, weight 1/3) on the largest;
    - int8 quantize and dequantize on the largest bucket's value rows (per
      worker 100,514 x 8 values, zero-padded to rows of 512; the hazard
      rows appended), timed by :func:`small_kernel_times`.

    Library yardsticks (timed, never used by the port): ``abs``, then
    ``torch.topk`` then ``gather`` for the selection (three calls);
    ``torch.scatter`` onto zeros for the no-acc scatter and
    ``torch.scatter_add`` of pre-scaled values for the acc form; none for
    the int8 pair (``quantize_per_channel`` takes its scales as input; the
    dequantize is a cast and a product)."""
    gen = torch.Generator(device=dev).manual_seed(4)
    largest, median = max(totals), sorted(totals)[len(totals) // 2]
    out = {"topk": {}, "scatter": {}, "buckets": len(totals)}
    for label, total in (("largest", largest), ("median", median)):
        rows = world * total // chunk
        x = torch.randn(rows, chunk, generator=gen, device=dev)
        seed_codec_rows(torch, x, gen)
        v, i = tck.chunked_topk(x, k)
        vp, ip = tck.chunked_topk_plain(x, k)
        torch.cuda.synchronize()
        bad = {"values": mismatches(torch, v, vp), "indices": mismatches(torch, i, ip)}
        if any(bad.values()) or i[3, :2].tolist() != [5, 9]:
            raise AssertionError(f"chunked_topk {label} differs from its plain version: {bad}")
        err = max_abs_err(torch, (v, vp))
        del vp, ip
        bms, by = bound_ms(rows * chunk * 4 + rows * k * 8, k * rows * chunk, F32_FLOPS)
        out["topk"][label] = {
            "rows": rows, "chunk": chunk, "k": k, "mismatched": bad, "max_abs_err": err,
            "ms": cuda_ms(torch, lambda _: tck.chunked_topk(x, k), 20),
            "plain_ms": cuda_ms(torch, lambda _: tck.chunked_topk_plain(x, k), 5),
            "library_ms": cuda_ms(torch, lambda _: torch.gather(x, 1, torch.topk(x.abs(), k, dim=1).indices), 10),
            "library": "abs + torch.topk + gather (three calls)", "bound_ms": bms, "bound_by": by,
        }
        out["topk"][label]["x_bound"] = out["topk"][label]["ms"] / bms
        zeros = torch.zeros(rows, chunk, device=dev)
        i64 = i.long()
        forms = [("no_acc", None, 1.0)] + ([("acc", x, 1 / 3)] if label == "largest" else [])
        for form, acc, w in forms:
            got = tck.chunk_scatter(v, i, chunk, acc, weight=w)
            want = tck.chunk_scatter_plain(v, i, chunk, acc, weight=w)
            torch.cuda.synchronize()
            bad = mismatches(torch, got, want)
            if bad or torch.signbit(got[got == 0]).any():
                raise AssertionError(f"chunk_scatter {label} {form}: {bad} elements differ, or a -0.0 survived")
            err = max_abs_err(torch, (got, want))
            del got, want
            if acc is None:
                lib = lambda _: torch.scatter(zeros, 1, i64, v)
                nbytes = rows * chunk * 4 + rows * k * 8
            else:
                wv = v * w
                lib = lambda _: torch.scatter_add(acc, 1, i64, wv)
                nbytes = 2 * rows * chunk * 4 + rows * k * 8
            bms, by = bound_ms(nbytes, 2 * rows * k, F32_FLOPS)
            out["scatter"][f"{label} {form}"] = {
                "rows": rows, "chunk": chunk, "k": k, "weight": w, "mismatched": bad, "max_abs_err": err,
                "ms": cuda_ms(torch, lambda _: tck.chunk_scatter(v, i, chunk, acc, weight=w), 20),
                "plain_ms": cuda_ms(torch, lambda _: tck.chunk_scatter_plain(v, i, chunk, acc, weight=w), 5),
                "library_ms": cuda_ms(torch, lib, 20),
                "library": "torch.scatter onto zeros" if acc is None else "torch.scatter_add of pre-scaled values",
                "bound_ms": bms, "bound_by": by,
            }
        if label == "largest":
            # the value vectors: each worker's (rows/world) x k winners, padded to whole rows
            vals = v.reshape(world, -1)
            vrows = -(-vals.shape[1] // chunk)
            vals = torch.nn.functional.pad(vals, (0, vrows * chunk - vals.shape[1])).reshape(-1, chunk)
            seed_codec_rows(torch, vals, gen)
            vals = torch.cat([vals, hazard_rows(torch, dev, chunk)])
        del x, v, i, i64, zeros
    q, sc = tck.quantize_int8(vals)
    qp, scp = tck.quantize_int8_plain(vals)
    d = tck.dequantize_int8(q, sc)
    dp = tck.dequantize_int8_plain(q, sc)
    torch.cuda.synchronize()
    bad_q = {"q": mismatches(torch, q, qp), "scales": mismatches(torch, sc, scp)}
    bad_d = mismatches(torch, d, dp)
    h0 = vals.shape[0] - 6  # the first hazard row
    if any(bad_q.values()) or bad_d or not (sc[0] == 0 and sc[2] == 1.0 and sc[h0] == 0 and sc[h0 + 1] == 0):
        raise AssertionError(f"int8 kernels differ from their plain versions: {bad_q}, dequantize {bad_d}")
    fin = torch.isfinite(sc)  # the NaN and inf rows' scales (and decodes) carry no error value
    r, n = vals.shape[0], vals.numel()
    qb, qby = bound_ms(4 * n + n + 4 * r, 3 * n, F32_FLOPS)
    db, dby = bound_ms(n + 4 * r + 4 * n, n, F32_FLOPS)
    out["quantize_int8"] = {
        "rows": r, "chunk": chunk, "mismatched": bad_q,
        "max_abs_err": max_abs_err(torch, (q, qp), (sc[fin], scp[fin])),
        **small_kernel_times(torch, lambda _: tck.quantize_int8(vals), lambda _: tck.quantize_int8_plain(vals)),
        "library_ms": None, "library": "none: quantize_per_channel takes the scales as input",
        "bound_ms": qb, "bound_by": qby,
    }
    out["dequantize_int8"] = {
        "rows": r, "chunk": chunk, "mismatched": bad_d, "max_abs_err": max_abs_err(torch, (d[fin], dp[fin])),
        **small_kernel_times(torch, lambda _: tck.dequantize_int8(q, sc), lambda _: tck.dequantize_int8_plain(q, sc)),
        "library_ms": None, "library": "none: a cast and a product are two calls",
        "bound_ms": db, "bound_by": dby,
    }
    return out


def small_kernel_times(torch, kern, plain) -> dict:
    """``ms``/``plain_ms`` by profiler device time (:func:`device_ms`) and
    ``event_ms``/``plain_event_ms`` by CUDA events: a kernel of a few
    microseconds runs faster than the host can call its wrapper, so
    back-to-back events read the host's time per call instead."""
    return {
        "ms": device_ms(torch, kern, 50), "plain_ms": device_ms(torch, plain, 10),
        "event_ms": cuda_ms(torch, kern, 50), "plain_event_ms": cuda_ms(torch, plain, 10),
    }


def check_int4(torch, tck, dev, totals, world=4, chunk=512, k=8):
    """The int4 quantize and dequantize at ``--codec topk_int4``'s main-path
    shapes: the value rows of the largest and the median bucket of its
    14-bucket plan (per worker ``total / 512 * 8`` values, zero-padded to
    rows of 512, the int4 chunk), held BIT FOR BIT against their plain
    versions. The first rows carry ``seed_codec_rows``' hazards, then a
    NaN row, int4's round-half points at scale 1 and an inf row; the
    hazard rows (:func:`hazard_rows`) are appended. No
    library yardstick: ``quantize_per_channel`` takes its scales as
    input and packs no nibbles, and the unpack is several calls."""
    gen = torch.Generator(device=dev).manual_seed(7)
    out = {}
    for label, total in (("largest", max(totals)), ("median", sorted(totals)[len(totals) // 2])):
        n = total // chunk * k
        rows = -(-n // chunk)
        vals = torch.zeros(world, rows * chunk, device=dev)
        vals[:, :n] = 3 * torch.randn(world, n, generator=gen, device=dev)
        vals = vals.reshape(-1, chunk)
        seed_codec_rows(torch, vals, gen)
        vals[5, 3] = float("nan")
        vals[6] = torch.randint(-7, 7, (chunk,), generator=gen, device=dev).float() + 0.5
        vals[6, :5] = torch.tensor([7.0, 3.5, -3.5, 0.5, 1.5], device=dev)
        vals[7, 4] = float("inf")
        vals = torch.cat([vals, hazard_rows(torch, dev, chunk)])
        p, sc = tck.quantize_int4(vals)
        pp, scp = tck.quantize_int4_plain(vals)
        d = tck.dequantize_int4(p, sc)
        dp = tck.dequantize_int4_plain(p, sc)
        torch.cuda.synchronize()
        bad_q = {"packed": mismatches(torch, p, pp), "scales": mismatches(torch, sc, scp)}
        bad_d = mismatches(torch, d, dp)
        h0 = vals.shape[0] - 6  # the first hazard row
        hazards_ok = (sc[0] == 0 and torch.isnan(sc[5]) and sc[6] == 1.0 and not p[[0, 1, 5, 7]].any()
                      and d[6, :5].tolist() == [7.0, 4.0, -4.0, 0.0, 2.0]
                      and sc[h0] == 0 and sc[h0 + 1] == 0 and not p[[h0, h0 + 1]].any())
        if any(bad_q.values()) or bad_d or not hazards_ok:
            raise AssertionError(f"int4 kernels ({label}) differ from their plain versions: {bad_q}, "
                                 f"dequantize {bad_d}, hazard rows ok: {hazards_ok}")
        r, m = vals.shape[0], vals.numel()
        qb, qby = bound_ms(4 * m + m // 2 + 4 * r, 3 * m, F32_FLOPS)
        db, dby = bound_ms(m // 2 + 4 * r + 4 * m, m, F32_FLOPS)
        fin = torch.isfinite(sc)  # the NaN and inf rows' scales (and decodes) carry no error value
        out[label] = {
            "quantize_int4": {
                "rows": r, "chunk": chunk, "mismatched": bad_q,
                "max_abs_err": max_abs_err(torch, (p, pp), (sc[fin], scp[fin])),
                **small_kernel_times(torch, lambda _: tck.quantize_int4(vals), lambda _: tck.quantize_int4_plain(vals)),
                "library_ms": None, "library": "none: quantize_per_channel takes the scales as input, packs no nibbles",
                "bound_ms": qb, "bound_by": qby,
            },
            "dequantize_int4": {
                "rows": r, "chunk": chunk, "mismatched": bad_d,
                "max_abs_err": max_abs_err(torch, (d[fin], dp[fin])),
                **small_kernel_times(torch, lambda _: tck.dequantize_int4(p, sc),
                                     lambda _: tck.dequantize_int4_plain(p, sc)),
                "library_ms": None, "library": "none: unpacking nibbles, a cast and a product are several calls",
                "bound_ms": db, "bound_by": dby,
            },
        }
        del vals, p, pp, d, dp
    return out


def ln_case(torch, dev, gen, m, h, dtype):
    """x with the LayerNorm's hazards in its first rows (a constant row: its
    variance is 0, and 0.375 sums exactly, so both sides see xc = 0; a row
    of large magnitude; a row at 1e-3 scale, variance near eps), dy, f32
    gamma and beta."""
    x = 2 * torch.randn(m, h, generator=gen, device=dev) + 0.5
    x[0] = 0.375
    x[1] *= 1e3
    x[2] *= 1e-3
    dy = torch.randn(m, h, generator=gen, device=dev)
    gamma = 1 + 0.1 * torch.randn(h, generator=gen, device=dev)
    beta = 0.1 * torch.randn(h, generator=gen, device=dev)
    return x.to(dtype), dy.to(dtype), gamma, beta


def ln_row_err(torch, got, want) -> float:
    """Worst |got - want| over its tolerance: LN_ROW_RTOL of the row's
    largest |want|, plus one bf16 ulp of the element for a bf16 output."""
    ulp = 2.0**-7 if got.dtype == torch.bfloat16 else 0.0
    g, w = got.float(), want.float()
    tol = LN_ROW_RTOL * w.abs().amax(dim=1, keepdim=True) + ulp * w.abs()
    return float(((g - w).abs() / tol.clamp_min(1e-30)).max())


def check_ln(torch, tln, dev):
    """The fused LayerNorm's two kernels at GPT-2-medium's LayerNorm view,
    (8192, 1024) bf16 in and out (batch 8 x seq 1024), and at (2048, 1024)
    f32, each against its plain version on the same values: y and dx
    within ``LN_ROW_RTOL`` (+ one bf16 ulp), dgamma and dbeta within
    ``LN_SUM_RTOL`` of their terms' magnitudes, the backward's outputs the
    same bits over three reruns. ``ms`` is CUDA events over calls queued
    behind a sleep kernel (:func:`queued_ms`), ``profiler_ms`` device time
    by the profiler, ``kernel_split_ms`` that time by CUDA kernel (one
    kernel a call), ``event_ms`` CUDA events over back-to-back calls; the
    library yardstick is one ``F.layer_norm`` forward and its autograd
    backward ((forward + backward) - forward) on the same values, its
    weight and bias cast to x's dtype, timed the same ways."""
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(8)
    out = {}
    for m, h, dtype in ((8192, 1024, torch.bfloat16), (2048, 1024, torch.float32)):
        x, dy, gamma, beta = ln_case(torch, dev, gen, m, h, dtype)
        y, yp = tln.ln_fwd(x, gamma, beta, 1e-6, dtype), tln.ln_fwd_plain(x, gamma, beta, 1e-6, dtype)
        dx, dg, db = tln.ln_bwd(dy, x, gamma, 1e-6)
        dxp, dgp, dbp = tln.ln_bwd_plain(dy, x, gamma, 1e-6)
        reruns_equal = all(torch.equal(u, v) for _ in range(2) for u, v in zip(tln.ln_bwd(dy, x, gamma, 1e-6),
                                                                                (dx, dg, db)))
        torch.cuda.synchronize()
        xf, dyf = x.float(), dy.float()
        xc = xf - xf.mean(1, keepdim=True)
        xhat = xc * torch.rsqrt((xc * xc).mean(1, keepdim=True) + 1e-6)
        errs = {
            "y": ln_row_err(torch, y, yp), "dx": ln_row_err(torch, dx, dxp),
            "dgamma": sum_err(torch, dg, dgp, (dyf * xhat).abs().sum(0)),
            "dbeta": sum_err(torch, db, dbp, dyf.abs().sum(0)),
        }
        abs_errs = {name: max_abs_err(torch, (a, b)) for name, a, b in
                    (("y", y, yp), ("dx", dx, dxp), ("dgamma", dg, dgp), ("dbeta", db, dbp))}
        if not (errs["y"] <= 1 and errs["dx"] <= 1 and errs["dgamma"] <= LN_SUM_RTOL and errs["dbeta"] <= LN_SUM_RTOL
                and reruns_equal):
            raise AssertionError(f"fused LN kernels at ({m}, {h}) {dtype} differ from their plain versions: "
                                 f"{errs} (y, dx: over their tolerance; sums: rel), {abs_errs} (max abs), "
                                 f"backward reruns equal {reruns_equal}")
        del y, yp, dx, dxp, xf, xc, xhat, dyf
        w, b = gamma.to(dtype), beta.to(dtype)
        xr, wr, br = (t.detach().requires_grad_() for t in (x, w, b))

        def lib_fwd_bwd(_):
            torch.autograd.grad(F.layer_norm(xr, (h,), wr, br, 1e-6), (xr, wr, br), dy)

        with torch.no_grad():
            lib_fwd = queued_ms(torch, lambda _: F.layer_norm(x, (h,), w, b, 1e-6), 100)[0]
            lib_fwd_prof = device_ms(torch, lambda _: F.layer_norm(x, (h,), w, b, 1e-6), 50)
            lib_fwd_ev = cuda_ms(torch, lambda _: F.layer_norm(x, (h,), w, b, 1e-6), 50)
        lib_bwd = queued_ms(torch, lib_fwd_bwd, 100)[0] - lib_fwd
        lib_bwd_prof = device_ms(torch, lib_fwd_bwd, 50) - lib_fwd_prof
        lib_bwd_ev = cuda_ms(torch, lib_fwd_bwd, 50) - lib_fwd_ev
        n, eb = m * h, x.element_size()
        bounds = {  # bytes: (M, H) operands once each; flops at the f32 rate (no tensor cores)
            "ln_fwd": bound_ms(2 * eb * n + 8 * h, 8 * n, F32_FLOPS),
            "ln_bwd": bound_ms(3 * eb * n + 12 * h, 16 * n, F32_FLOPS),
        }
        times = {
            "ln_fwd": (lambda _: tln.ln_fwd(x, gamma, beta, 1e-6, dtype),
                       lambda _: tln.ln_fwd_plain(x, gamma, beta, 1e-6, dtype)),
            "ln_bwd": (lambda _: tln.ln_bwd(dy, x, gamma, 1e-6), lambda _: tln.ln_bwd_plain(dy, x, gamma, 1e-6)),
        }
        out[(m, h, str(dtype).split(".")[-1])] = {
            name: {
                "m": m, "h": h, "dtype": str(dtype).split(".")[-1],
                "max_abs_err": max(abs_errs[k] for k in (("y",) if name == "ln_fwd" else ("dx", "dgamma", "dbeta"))),
                "errs_over_tol": ({"y": errs["y"]} if name == "ln_fwd" else {"dx": errs["dx"]}),
                **({} if name == "ln_fwd" else {"sum_rel_err": max(errs["dgamma"], errs["dbeta"]),
                                                 "reruns_equal": reruns_equal,
                                                 "plan": tln.ln_bwd_plan(m, h, eb, eb, tln._sms(x.device))._asdict()}),
                "abs_errs": abs_errs,
                "ms": queued_ms(torch, kern, 100)[0], "profiler_ms": device_ms(torch, kern, 50),
                "kernel_split_ms": device_split_ms(torch, kern, 50),
                "plain_ms": device_ms(torch, plain, 10),
                "event_ms": cuda_ms(torch, kern, 50), "plain_event_ms": cuda_ms(torch, plain, 10),
                "library_ms": lib_fwd if name == "ln_fwd" else lib_bwd,
                "library_profiler_ms": lib_fwd_prof if name == "ln_fwd" else lib_bwd_prof,
                "library_event_ms": lib_fwd_ev if name == "ln_fwd" else lib_bwd_ev,
                "library": ("F.layer_norm forward" if name == "ln_fwd" else "F.layer_norm autograd backward"),
                "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
            }
            for name, (kern, plain) in times.items()
        }
        for r in out[(m, h, str(dtype).split(".")[-1])].values():
            r.update(x_bound=r["ms"] / r["bound_ms"], x_library=r["ms"] / r["library_ms"])
        del x, dy, xr
        torch.cuda.empty_cache()
    return out


def gpt2_medium_flax_tree(cfg, seed: int) -> dict:
    """A flax-layout GPT2LM parameter tree (numpy, f32) at ``cfg``'s widths:
    N(0, 0.02) weights and biases, LayerNorm scales 1 + N(0, 0.02)."""
    rng = np.random.default_rng(seed)
    hd, nh, dh = cfg.hidden, cfg.heads, cfg.head_dim

    def w(*shape):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02)

    def ln():
        return {"scale": 1.0 + w(hd), "bias": w(hd)}

    tree = {
        "wte": {"embedding": w(cfg.vocab_size, hd)},
        "wpe": {"embedding": w(cfg.max_len, hd)},
        "ln_f": ln(),
    }
    for i in range(cfg.layers):
        tree[f"h_{i}"] = {
            "ln_1": ln(), "ln_2": ln(),
            "qkv": {"kernel": w(hd, nh, 3 * dh), "bias": w(nh, 3 * dh)},
            "out": {"kernel": w(nh, dh, hd), "bias": w(hd)},
            "mlp_in": {"kernel": w(hd, cfg.mlp_dim), "bias": w(cfg.mlp_dim)},
            "mlp_out": {"kernel": w(cfg.mlp_dim, hd), "bias": w(hd)},
        }
    return tree


def stage_logits(torch, P, dm, impl, prompt, bs, bucket=1024):
    """One prefill of ``prompt`` (padded to ``bucket``) through the ``impl``
    tier's stages on private pages (slot 0 owns blocks 1..nb). Returns the
    last real token's logits, the pages, the block table and the tier's
    decode stage, for one decode step on top."""
    dev = dm.device
    nb = dm.max_len // bs
    pages = P.init_pages(dm, nb + 1, bs)
    table = torch.zeros((8, nb), dtype=torch.int32, device=dev)
    table[0] = torch.arange(1, nb + 1, dtype=torch.int32, device=dev)
    ids = torch.zeros((1, bucket), dtype=torch.int64, device=dev)
    ids[0, : len(prompt)] = torch.tensor(prompt, device=dev)
    prefill = P.make_paged_prefill_fn(dm, attn_impl=impl)
    decode = P.make_paged_decode_fn(dm, attn_impl=impl)
    _tok, last = prefill(pages, ids, len(prompt), table[0, : bucket // bs].long(), 0.0, 1.0, 0)
    return last, pages, table, decode


def profile_decode(torch, decode, pages, table, tokens, positions, samp, steps=10):
    """Where one decode step's time goes (8 lanes, slot 0 at its prompt's
    length and one token more each step, ``3 * steps`` in all):
    host wall per step without the profiler, then the device time of the
    kernels a step launches under ``torch.profiler`` (CUPTI). ``None``
    where the profiler recorded no device time."""
    from torch.profiler import ProfilerActivity, profile

    def run():
        for _ in range(steps):
            positions[0] += 1
            decode(pages, table, tokens, positions, *samp)
        torch.cuda.synchronize()

    with torch.inference_mode():
        run()  # warm
        t0 = time.perf_counter()
        run()
        wall_ms = 1e3 * (time.perf_counter() - t0) / steps
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
    cuda = [
        e for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
    ]

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)

    device_ms = sum(dev_us(e) for e in cuda) / 1e3 / steps
    top = sorted(cuda, key=dev_us, reverse=True)[:6]
    paged = [e for e in cuda if re.search(KERNEL_SYMBOLS["paged_attention"], e.key)]
    return {
        "steps": steps, "wall_ms_per_step": wall_ms,
        "device_kernel_ms_per_step": device_ms if device_ms > 0 else None,
        "device_busy_share": device_ms / wall_ms if device_ms > 0 else None,
        "paged_attention_ms_per_step": sum(dev_us(e) for e in paged) / 1e3 / steps if paged else None,
        "paged_attention_calls_per_step": sum(e.count for e in paged) / steps,
        "kernels_per_step": sum(e.count for e in cuda) / steps,
        "top_kernels": [
            {"name": e.key[:80], "ms_per_step": dev_us(e) / 1e3 / steps, "calls_per_step": e.count / steps}
            for e in top
        ],
    }


def tier_logits(torch, P, eng, prompt, bs, gate_argmax: bool):
    """One prefill of ``prompt`` (its bucket) and one decode step on it
    through the kernel tier's stages and the plain tier's, same weights,
    private pages. Gates both logits finite, of the vocabulary's shape and
    within ``LOGITS_REL_TOL`` of max|logit|, and, if ``gate_argmax``,
    their argmax equal. Returns the checks and the kernel tier's pages,
    table, decode stage and step inputs (for :func:`profile_decode`)."""
    dm, dev = eng._dm, eng.device
    bucket = eng._bucket(len(prompt))
    with torch.inference_mode():
        got_last, gpages, table, gdecode = stage_logits(torch, P, dm, "cuda", prompt, bs, bucket)
        want_last, wpages, _, wdecode = stage_logits(torch, P, dm, "torch", prompt, bs, bucket)
        tokens = torch.zeros(8, dtype=torch.int32, device=dev)
        tokens[0] = int(want_last.argmax())
        positions = torch.zeros(8, dtype=torch.int32, device=dev)
        positions[0] = len(prompt)
        samp = (torch.zeros(8, device=dev), torch.ones(8, device=dev), torch.zeros(8, dtype=torch.int64, device=dev))
        _, got_dec = gdecode(gpages, table, tokens, positions, *samp)
        _, want_dec = wdecode(wpages, table, tokens, positions, *samp)
    torch.cuda.synchronize()
    vocab = dm.vocab_size
    checks = {}
    for name, g, wnt in (("prefill", got_last, want_last), ("decode", got_dec[0], want_dec[0])):
        if not (torch.isfinite(g).all() and g.shape == (vocab,)):
            raise AssertionError(f"{name} logits not finite of shape ({vocab},)")
        rel = ((g - wnt).abs().max() / wnt.abs().max()).item()
        top2 = wnt.topk(2).values
        checks[name] = {"max_rel_err": rel, "tol": LOGITS_REL_TOL, "argmax_equal": int(g.argmax()) == int(wnt.argmax()),
                        "plain_top2_gap_rel": ((top2[0] - top2[1]) / wnt.abs().max()).item()}
        if not rel <= LOGITS_REL_TOL:
            raise AssertionError(f"{name} logits: rel err {rel} > {LOGITS_REL_TOL}")
        if gate_argmax and not checks[name]["argmax_equal"]:
            raise AssertionError(f"{name} logits: the kernels' argmax differs from the plain tier's")
    return checks, (gpages, table, gdecode, tokens, positions, samp)


def serve_traffic(eng, server, reqs, max_new=32) -> tuple[list, float]:
    """Serve ``reqs`` (``(route, ids, sampling)``; route ``"direct"`` through
    ``eng.submit``, ``"socket"`` through ``server``'s line-JSON socket,
    from threads), all submitted before any is awaited. Gates every stream
    finished with ``max_new`` tokens in the vocabulary. Returns a record a
    request and the seconds from the first submit to the last answer."""
    t0 = time.perf_counter()
    results = [None] * len(reqs)

    def via_socket(i, ids, extra):
        results[i] = socket_request(server.address, {"ids": ids, "max_new_tokens": max_new, **extra})

    threads = []
    for i, (route, ids, extra) in enumerate(reqs):
        if route == "socket":
            t = threading.Thread(target=via_socket, args=(i, ids, extra))
            t.start()
            threads.append(t)
        else:
            results[i] = eng.submit(ids, max_new, **extra)
    out = []
    for i, (route, ids, extra) in enumerate(reqs):
        if route == "direct":
            r = results[i].result(timeout=600)
            rec = {"tokens": r.tokens, "finish_reason": r.finish_reason,
                   "ttft_ms": 1e3 * r.ttft_s, "latency_ms": 1e3 * r.latency_s}
        else:
            threads.pop(0).join(timeout=600)
            rec = results[i]
            if rec is None:
                raise AssertionError(f"socket request {i} got no answer")
        toks = rec["tokens"]
        if rec["finish_reason"] != "max_tokens" or len(toks) != max_new:
            raise AssertionError(f"request {i} ended {rec['finish_reason']} with {len(toks)} tokens")
        if not all(0 <= t < eng._dm.vocab_size for t in toks):
            raise AssertionError(f"request {i} produced a token outside the vocabulary")
        out.append({"route": route, "prompt_len": len(ids), "bucket": eng._bucket(len(ids)),
                    "sampled": "temperature" in extra, "ttft_ms": rec["ttft_ms"], "latency_ms": rec["latency_ms"]})
    return out, time.perf_counter() - t0


def serve_phase(torch, dev):
    from consensusml_tpu_torch import kernels
    from consensusml_tpu_torch.configs import gpt2_config
    from consensusml_tpu_torch.models.convert import gpt2_from_flax
    from consensusml_tpu_torch.models.gpt2 import GPT2LM
    from consensusml_tpu_torch.serve import Engine, ServeConfig, ServeServer
    from consensusml_tpu_torch.serve import pool as P

    t0 = time.perf_counter()
    cfg = gpt2_config("full")
    model = GPT2LM(cfg, device=dev)
    model.load_state_dict(gpt2_from_flax(gpt2_medium_flax_tree(cfg, seed=0)))
    model.eval()
    n_params = sum(p.numel() for p in model.parameters())
    build_s = time.perf_counter() - t0

    bs = 16
    eng = Engine(model, ServeConfig(num_slots=8, block_size=bs, attn_impl="auto",
                                    max_new_tokens=32), device=dev)
    server = None
    try:
        if eng.stats()["attn_impl"] != "cuda":
            raise AssertionError(f"attn_impl resolved to {eng.stats()['attn_impl']!r}, not cuda")
        t0 = time.perf_counter()
        warmed = eng.warmup()
        warmup_s = time.perf_counter() - t0

        # logits of the kernel tier against the plain tier, same weights
        rng = np.random.default_rng(7)
        prompt = rng.integers(0, cfg.vocab_size, size=700).tolist()
        logit_checks, (gpages, table, gdecode, tokens, positions, samp) = tier_logits(
            torch, P, eng, prompt, bs, gate_argmax=True)
        step_profile = profile_decode(torch, gdecode, gpages, table, tokens, positions, samp)
        del gpages

        # the served traffic: counters zeroed just before, read just after
        server = ServeServer(eng)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launch_counts()
        steps0 = eng.stats()["decode_steps"]
        reqs = [
            ("direct", prompt, {}),
            ("direct", rng.integers(0, cfg.vocab_size, size=5).tolist(), {}),
            ("direct", rng.integers(0, cfg.vocab_size, size=37).tolist(),
             {"temperature": 0.8, "top_p": 0.9, "seed": 1234}),
            ("direct", rng.integers(0, cfg.vocab_size, size=300).tolist(), {}),
            ("socket", rng.integers(0, cfg.vocab_size, size=5).tolist(), {}),
            ("socket", rng.integers(0, cfg.vocab_size, size=37).tolist(), {"seed": 9}),
        ]
        out, wall_s = serve_traffic(eng, server, reqs)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        stats = eng.stats()
        steps = stats["decode_steps"] - steps0
        if counts["paged_attention"] < cfg.layers * steps or steps < 1:
            raise AssertionError(f"paged launches {counts['paged_attention']} < 24 x {steps} steps")
        if counts["flash_attention_fwd"] < cfg.layers:
            raise AssertionError(f"flash launches {counts['flash_attention_fwd']} < 24")
        stray = {n: c for n, c in counts.items() if c and n not in ("paged_attention", "flash_attention_fwd")}
        if stray:
            raise AssertionError(f"serving launched kernels off its path: {stray}")
        grouped = kernels.form_counts()["paged_attention"]["grouped"]
        if grouped:  # GPT-2-medium's 16 heads of 64: a block holds whole pages
            raise AssertionError(f"GPT-2 serving launched the paged kernel with head groups {grouped} times")
        serve = {
            "phase": "serve", "model": "gpt2_topk full (GPT-2-medium)", "params": n_params,
            "layers": cfg.layers, "model_build_s": build_s, "warmup": warmed, "warmup_s": warmup_s,
            "attn_impl": stats["attn_impl"], "logits_vs_plain": logit_checks,
            "decode_step_profile": step_profile,
            "requests": out, "wall_s": wall_s, "decode_steps": steps, "launches": counts,
            "paged_grouped_launches": grouped,
            "ttft_p50_ms": stats["ttft_p50_ms"], "intertoken_p50_ms": stats["intertoken_p50_ms"],
            "decode_tokens_per_sec": stats["decode_tokens_per_sec"],
            "peak_memory_bytes": peak, "evictions": stats["evictions"],
        }
    finally:
        if server is not None:
            server.shutdown()
        else:
            eng.shutdown()
    return serve, counts


# the served Llama traffic: (route, prompt length, sampling); the 4000-token
# prompt pads to the 4096 bucket, so its slot's cache spans all 16 blocks of
# its clusters, and three prompts take buckets of 1024 and more (flash)
SERVE_LLAMA_REQUESTS = (("direct", 4000, {}), ("direct", 5, {}),
                        ("direct", 37, {"temperature": 0.8, "top_p": 0.9, "seed": 1234}),
                        ("direct", 1500, {}), ("socket", 5, {}), ("socket", 700, {"seed": 9}))


def serve_llama_phase(torch, dev, weights):
    """``llama_lora`` full served: Llama-2-7B (hidden 4096, 32 layers, 32
    heads of dim 128, vocab 32000, bf16) with the rank-16 adapters, from
    ``weights`` (train_llama's frozen base and the mean of its workers'
    final adapters, the consensus model), through ``Engine(model,
    ServeConfig(num_slots=8, block_size=16, max_new_tokens=32))`` and
    ``ServeServer``: paged KV at the reference's max_len 4096 (8 slots x
    256 pages of 16 a layer). Kernel-tier logits against the plain tier's
    from the same weights (a 4000-token prefill, bucket 4096, and one
    decode step on it); one profiled decode step at that slot; then
    ``SERVE_LLAMA_REQUESTS`` (launch counters zeroed just before, read
    just after). Gates: the kernel tier resolved, the logits within
    ``LOGITS_REL_TOL`` of max|logit|, every stream finished with 32 tokens
    in the vocabulary, no eviction, the pool free at the end, the paged
    kernel launched 32 times a decode step (every launch with head
    groups), the flash forward 32 times a prompt of a bucket of 1024 and
    more, and nothing else."""
    from consensusml_tpu_torch import configs, kernels
    from consensusml_tpu_torch.models.llama import LlamaLM
    from consensusml_tpu_torch.models.paged_attention import paged_plan
    from consensusml_tpu_torch.serve import Engine, ServeConfig, ServeServer
    from consensusml_tpu_torch.serve import pool as P

    t0 = time.perf_counter()
    cfg = configs.llama_config("full")
    model = LlamaLM(cfg, device="meta")
    model.load_state_dict(weights, strict=True, assign=True)
    n_params = sum(p.numel() for p in model.parameters())
    build_s = time.perf_counter() - t0
    bs = 16
    eng = Engine(model, ServeConfig(num_slots=8, block_size=bs, max_new_tokens=32), device=dev)
    server = None
    try:
        if eng.stats()["attn_impl"] != "cuda":
            raise AssertionError(f"attn_impl resolved to {eng.stats()['attn_impl']!r}, not cuda")
        weight_bytes = sum(p.numel() * p.element_size() for n, p in model.named_parameters()
                           if n != "tok_emb.embedding")  # the embedding is a lookup of 8 rows
        kv_token_bytes = cfg.layers * 2 * cfg.kv_heads * cfg.head_dim * 2  # K and V, bf16: 512 KB at 7B
        t0 = time.perf_counter()
        warmed = eng.warmup()
        warmup_s = time.perf_counter() - t0

        rng = np.random.default_rng(11)
        reqs = [(route, rng.integers(0, cfg.vocab_size, size=n).tolist(), extra)
                for route, n, extra in SERVE_LLAMA_REQUESTS]
        prompt = reqs[0][1]
        t0 = time.perf_counter()
        # the argmax is reported, not gated: a random base's top two logits
        # may lie closer than the tolerance, or tie
        logit_checks, (gpages, table, gdecode, tokens, positions, samp) = tier_logits(
            torch, P, eng, prompt, bs, gate_argmax=False)
        logit_check_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        step_profile = profile_decode(torch, gdecode, gpages, table, tokens, positions, samp)
        # a step of the profile: every weight read once, the live slot's
        # K/V (its prompt and ~15 of the profile's tokens, on average)
        step_bytes = weight_bytes + (len(prompt) + 16) * kv_token_bytes
        step_bound_ms, _ = bound_ms(step_bytes, 0.0)
        paged_bound_ms, _ = bound_ms((len(prompt) + 16) * kv_token_bytes, 0.0)
        del gpages
        torch.cuda.empty_cache()

        server = ServeServer(eng)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launch_counts()
        steps0 = eng.stats()["decode_steps"]
        out, wall_s = serve_traffic(eng, server, reqs)
        torch.cuda.synchronize()
        counts, forms = kernels.launch_counts(), kernels.form_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        stats = eng.stats()
        steps = stats["decode_steps"] - steps0
        long_prompts = sum(eng._bucket(n) ** 2 > 512 ** 2 for _r, n, _x in SERVE_LLAMA_REQUESTS)
        want = {name: 0 for name in counts}
        want.update(paged_attention=cfg.layers * steps, flash_attention_fwd=cfg.layers * long_prompts)
        grouped = forms["paged_attention"]["grouped"]
        flash_forms = forms["flash_attention_fwd"]
        if (steps < 1 or counts != want or grouped != counts["paged_attention"]
                or flash_forms["d128"] != counts["flash_attention_fwd"] or flash_forms["masked"]):
            raise AssertionError(f"serve_llama launches {counts} (forms {forms}) over {steps} decode steps, "
                                 f"expected {want}, every paged launch grouped, every flash one head dim 128")
        if stats["evictions"] or stats["pool"]["free_blocks"] != stats["pool"]["usable_blocks"]:
            raise AssertionError(f"serve_llama: {stats['evictions']} evictions, pool {stats['pool']}")
        line = {
            "phase": "serve_llama",
            "model": "llama_lora full (Llama-2-7B: hidden 4096, 32 layers, 32 heads of dim 128, MLP 11008, vocab "
                     "32000, bf16; rank-16 adapters on q, k, v, o, the mean of train_llama's 16 workers)",
            "params": n_params, "weight_bytes": weight_bytes, "layers": cfg.layers, "max_len": eng.max_len,
            "pool": stats["pool"], "model_build_s": build_s, "warmup": warmed, "warmup_s": warmup_s,
            "attn_impl": stats["attn_impl"], "logits_vs_plain": logit_checks, "logit_check_s": logit_check_s,
            "paged_plan_decode": paged_plan(eng.max_len // bs, bs, cfg.kv_heads, cfg.head_dim, 1, cfg.heads)._asdict(),
            "decode_step_profile": step_profile, "decode_step_bytes": step_bytes,
            "decode_step_bound_ms": step_bound_ms, "paged_bound_ms_per_step": paged_bound_ms,
            "requests": out, "wall_s": wall_s, "decode_steps": steps, "launches": counts,
            "paged_grouped_launches": grouped,
            "ttft_p50_ms": stats["ttft_p50_ms"], "intertoken_p50_ms": stats["intertoken_p50_ms"],
            "decode_tokens_per_sec": stats["decode_tokens_per_sec"],
            "peak_memory_bytes": peak, "evictions": stats["evictions"],
        }
    finally:
        if server is not None:
            server.shutdown()
        else:
            eng.shutdown()
    del eng, model, weights
    gc.collect()
    torch.cuda.empty_cache()
    return line, counts, grouped


class BnBackwardCalls:
    """Times the host's wall clock around each fused BN backward call
    (``_FusedBatchNorm.backward``: the wrapper's checks, its one ctypes
    call and the allocation of dx and the sums; no synchronisation, so no
    device time) while installed, and counts the calls whose ``dy`` had
    to be copied (not contiguous, or not in x's dtype) before the kernel."""

    def __init__(self):
        from consensusml_tpu_torch.models import fused_bn as tbn

        self._cls, self._orig = tbn._FusedBatchNorm, tbn._FusedBatchNorm.backward
        self.ms: list[float] = []
        self.dy_copies = 0
        orig = self._orig

        def timed(ctx, dy, dmean, dvar):
            x2 = ctx.saved_tensors[0]
            self.dy_copies += not dy.is_contiguous() or dy.dtype != x2.dtype
            t0 = time.perf_counter()
            out = orig(ctx, dy, dmean, dvar)
            self.ms.append(1e3 * (time.perf_counter() - t0))
            return out

        self._cls.backward = staticmethod(timed)

    def close(self) -> None:
        self._cls.backward = staticmethod(self._orig)

    def summary(self) -> dict:
        ms = sorted(self.ms)
        return {"calls": len(ms), "median_ms": ms[len(ms) // 2] if ms else None,
                "mean_ms": sum(ms) / len(ms) if ms else None, "dy_copies": self.dy_copies}


def grad_check(torch, model, plain_model, params0, batch, dev):
    """One worker step's gradients through the kernels (``model`` with
    ``attn_impl="cuda"``) against the same step on the plain versions
    (``plain_model``, ``attn_impl="torch"``): same weights, batch and
    dropout masks."""
    from consensusml_tpu_torch.models.gpt2 import gpt2_loss_fn

    grads = {}
    for impl, m in (("cuda", model), ("torch", plain_model)):
        leaves = {n: p.detach().requires_grad_(True) for n, p in params0.items()}
        gen = torch.Generator(device=dev).manual_seed(11)
        loss, _ = gpt2_loss_fn(m, attn_impl=impl)(leaves, {}, batch, gen)
        grads[impl] = (float(loss.detach()), torch.autograd.grad(loss, list(leaves.values())))
        del leaves, loss
    (lk, gk), (lp, gp) = grads["cuda"], grads["torch"]
    diff2 = sum(float(((a.float() - b.float()) ** 2).sum()) for a, b in zip(gk, gp))
    ref2 = sum(float((b.float() ** 2).sum()) for b in gp)
    leaf = [
        (float((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30)), n)
        for n, a, b in zip(params0, gk, gp)
    ]
    worst, worst_name = max(leaf)
    qkv_none = sum(g is None for n, g in zip(params0, gk) if n.endswith("qkv.kernel"))
    out = {
        "loss_kernels": lk, "loss_plain": lp, "grad_rel_err": (diff2 / ref2) ** 0.5,
        "grad_rel_tol": GRAD_REL_TOL, "worst_leaf": worst_name, "worst_leaf_rel_err": worst,
        "leaf_rel_tol": LEAF_REL_TOL, "qkv_grads_missing": qkv_none,
    }
    if qkv_none or not out["grad_rel_err"] <= GRAD_REL_TOL or not worst <= LEAF_REL_TOL:
        raise AssertionError(f"gradients through the kernels disagree with the plain versions: {out}")
    return out


def profile_round(torch, step, state, batch):
    """Device-busy share of one training round: device kernel time under
    ``torch.profiler`` (CUPTI) over the round's host wall time. Device
    activity only: recording the round's ~10^5 host-side ops as well made
    the trace's processing take tens of seconds."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _m = step(state, batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    t1 = time.perf_counter()
    cuda = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)

    device_ms = sum(dev_us(e) for e in cuda) / 1e3
    top = sorted(cuda, key=dev_us, reverse=True)[:8]
    port = {}  # the port's kernels in this round, by name (templates summed)
    for name, sym in KERNEL_SYMBOLS.items():
        pat = re.compile(rf"(?<![A-Za-z0-9_]){sym}(?![A-Za-z0-9_])")
        hits = [e for e in cuda if pat.search(e.key)]
        if hits:
            port[name] = {"ms": sum(dev_us(e) for e in hits) / 1e3, "calls": sum(e.count for e in hits)}
    library_bn = [e for e in cuda if LIBRARY_BN.search(e.key)]
    library_bn_bwd = [e for e in library_bn if LIBRARY_BN_BWD.search(e.key)]
    return state, {
        "trace_processing_s": time.perf_counter() - t1,
        "wall_ms": wall_ms, "device_kernel_ms": device_ms if device_ms > 0 else None,
        "device_busy_share": device_ms / wall_ms if device_ms > 0 else None,
        "kernels": sum(e.count for e in cuda),
        "top_kernels": [
            {"name": e.key[:80], "ms": dev_us(e) / 1e3, "calls": e.count} for e in top
        ],
        "port_kernels": port,
        "library_bn_kernels": {
            "ms": sum(dev_us(e) for e in library_bn) / 1e3, "calls": sum(e.count for e in library_bn),
            "bwd_ms": sum(dev_us(e) for e in library_bn_bwd) / 1e3,
            "bwd_calls": sum(e.count for e in library_bn_bwd),
            "names": sorted({e.key[:80] for e in library_bn}),
        },
    }


class GcPauses:
    """A ``gc.callbacks`` hook: the host's time inside Python's garbage
    collector, in all and in full (generation 2) collections."""

    def __init__(self):
        self.ms = self.gen2_ms = 0.0
        self.gen2 = 0
        self._t = 0.0

    def __call__(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
            return
        ms = 1e3 * (time.perf_counter() - self._t)
        self.ms += ms
        if info["generation"] == 2:
            self.gen2 += 1
            self.gen2_ms += ms

    def snapshot(self) -> tuple:
        return self.ms, self.gen2, self.gen2_ms

    def since(self, snap: tuple) -> dict:
        return {"gc_ms": self.ms - snap[0], "gc_full_collections": self.gen2 - snap[1],
                "gc_full_ms": self.gen2_ms - snap[2]}


# the two-step wire's four kernels a bucket an exchange, by codec
CODEC_KERNELS = {
    None: ("chunked_topk", "quantize_int8", "dequantize_int8", "chunk_scatter"),
    "topk_int4": ("chunked_topk", "quantize_int4", "dequantize_int4", "chunk_scatter"),
}
# the bucket plans at GPT-2-medium, 4 MiB buckets: (buckets, wire bytes a worker a round)
PLANS = {
    None: (25, 33_366_424), "topk_int4": (14, 27_809_088),
    "int8": (123, 715_190_448), "int4": (50, 360_367_280), "fp8": (123, 715_190_448),
}
FUSED_CODECS = ("int8", "int4", "fp8")  # the per-chunk quantizers: the fused one-pass wire
TRAIN_PHASES = {"int8": "train", None: "train_topk", "topk_int4": "train_topk_int4_ln",
                "int4": "train_int4", "fp8": "train_fp8"}


def train_phase(torch, dev, init, codec, norm_impl="flax", keep_state=False):
    """gpt2_topk full, --workers 4 --codec-warmup 1, on ``codec``: "int8"
    (the fused wire; the ``train`` line, with the gradient check), None
    (the config's own top-k + int8 codec on the two-step wire; the
    ``train_topk`` line), "topk_int4" with ``norm_impl="pallas"`` (top-k
    + int4 on the two-step wire, every LayerNorm through the fused-LN
    kernels; the ``train_topk_int4_ln`` line, with the gradient check
    through the flash and LN kernels), "int4" or "fp8" (the fused wire's
    other formats; the ``train_int4`` and ``train_fp8`` lines). ``init``
    is the stacked numpy initial parameters (``bundle.init_params(0)``),
    drawn once for all. Returns the line, the launch counts and, with
    ``keep_state``, the final train state and bundle."""
    from consensusml_tpu_torch import configs, kernels
    from consensusml_tpu_torch.models.convert import gpt2_from_flax
    from consensusml_tpu_torch.models.gpt2 import GPT2LM
    from consensusml_tpu_torch.train.local_sgd import init_stacked_state, make_simulated_train_step

    world, counted = 4, 2
    bundle = configs.build("gpt2_topk", "full", world=world, codec=codec, codec_warmup=1, norm_impl=norm_impl,
                           device=dev)
    cfg, mcfg = bundle.cfg, bundle.model.config
    engine = cfg.engine()
    fused = codec in FUSED_CODECS
    fused_ln = norm_impl == "pallas"
    if engine.fused_wire_active != fused:
        raise AssertionError(f"codec path is not the expected wire: {bundle.codec_path}")
    marks = [("start", time.perf_counter())]
    batches = list(bundle.batches(2 + counted, 0))
    marks.append(("batches", time.perf_counter()))
    ids = batches[0]["input_ids"]
    grads = None
    if codec == "int8" or fused_ln:  # the model-level gradient check: flash kernels (and the LN ones)
        params0 = {n: torch.from_numpy(a[0]).to(dev) for n, a in init.items()}
        plain = GPT2LM(configs.gpt2_config("full", norm_impl="jnp"), device="meta") if fused_ln else bundle.model
        grads = grad_check(torch, bundle.model, plain, params0, {"input_ids": ids[0, 0].to(dev)}, dev)
        del params0
        torch.cuda.empty_cache()
        marks.append(("grad_check", time.perf_counter()))

    params = {n: t.to(dev) for n, t in gpt2_from_flax(init).items()}
    state = init_stacked_state(cfg, params, world, seed=0)
    del params
    marks.append(("state_on_device", time.perf_counter()))
    step = make_simulated_train_step(cfg, bundle.loss_fn)
    n_buckets = len(state.gossip.xhat)
    per_worker = {n: p[0] for n, p in state.params.items()}
    wire = engine.wire_bytes_per_round({"params": per_worker, "model_state": {}})
    n_params = sum(p.numel() for p in per_worker.values())
    del per_worker
    if (n_buckets, wire) != PLANS[codec]:
        raise AssertionError(f"{codec} plan: {n_buckets} buckets, {wire} wire bytes; expected {PLANS[codec]}")

    t0 = time.perf_counter()
    state, m = step(state, batches[0])  # round 0: warm (dense mixing), not counted
    warm = {"loss": float(m["loss"]), "consensus_error": float(m["consensus_error"]),
            "round_ms": 1e3 * (time.perf_counter() - t0)}

    # the earlier phases leave garbage in reference cycles (the serve
    # phase's profiler trace): its full collection took ~0.7 s of the first
    # counted round until it was collected here, before the timed rounds
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    gc_pauses = GcPauses()
    gc.callbacks.append(gc_pauses)
    bwd_calls = BnBackwardCalls() if norm_impl == "pallas" else None
    kernels.reset_launch_counts()
    rounds = []
    try:
        for batch in batches[1:1 + counted]:
            gc0 = gc_pauses.snapshot()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            loss, err = float(m["loss"]), float(m["consensus_error"])  # both synchronise
            ms = 1e3 * (time.perf_counter() - t0)
            rounds.append({
                "step": state.step - 1, "loss": loss, "consensus_error": err, "round_ms": ms,
                "inner_ms": m["inner_ms"], "gossip_ms": m["gossip_ms"],
                "tokens_per_s_per_chip": world * cfg.h * ids.shape[2] * ids.shape[3] / (ms / 1e3),
                **gc_pauses.since(gc0),
            })
    finally:
        gc.callbacks.remove(gc_pauses)
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    marks.append(("rounds", time.perf_counter()))
    state, prof = profile_round(torch, step, state, batches[1 + counted])
    marks.append(("profiled_round", time.perf_counter()))

    for r in rounds:
        if not (np.isfinite(r["loss"]) and np.isfinite(r["consensus_error"]) and r["consensus_error"] > 0):
            raise AssertionError(f"round {r['step']}: loss or consensus error not finite and positive: {r}")
    worker_steps = world * cfg.h * counted
    exchanges = counted * cfg.gossip.gossip_steps  # CHOCO rounds: one exchange a gossip step
    expect = dict.fromkeys(kernels.KERNELS, 0)
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        expect[name] = mcfg.layers * worker_steps
    for name in ("fused_choco_encode",) if fused else CODEC_KERNELS[codec]:
        expect[name] = n_buckets * exchanges
    if fused_ln:  # ln_1 and ln_2 of every block, and ln_f
        for name in LN_KERNELS:
            expect[name] = (2 * mcfg.layers + 1) * worker_steps
    if counts != expect:
        raise AssertionError(f"launches {counts} differ from the counts the code predicts {expect}")
    round_ms_mean = sum(r["round_ms"] for r in rounds) / counted
    if prof["device_kernel_ms"] is not None:
        # the profiler slows the host; against an unprofiled round's wall
        prof["device_busy_share_of_unprofiled_round"] = prof["device_kernel_ms"] / round_ms_mean
    # the codec and LN kernels' device time in the profiled round, read from the trace
    kernel_ms = lambda names: sum(prof["port_kernels"].get(n, {}).get("ms", 0.0) for n in names)  # noqa: E731
    extra = {}
    if not fused:
        extra["codec_kernels_ms"] = kernel_ms(CODEC_KERNELS[codec])
    else:
        extra["encode_kernel_ms"] = kernel_ms(("fused_choco_encode",))
    if fused_ln:
        extra["ln_kernels_ms"] = kernel_ms(LN_KERNELS)
    flags = "--workers 4 --codec-warmup 1" + (f" --codec {codec}" if codec else "") + (
        f" --norm-impl {norm_impl}" if fused_ln else "")
    out = {
        "phase": TRAIN_PHASES[codec], "config": f"gpt2_topk full (GPT-2-medium), {flags}",
        "codec_path": bundle.codec_path, "norm_path": bundle.norm_path,
        "wire": "fused one-pass" if fused else "two-step",
        "workers": world, "h": cfg.h, "batch": ids.shape[2],
        "seq": ids.shape[3], "layers": mcfg.layers, "params_per_worker": n_params,
        "buckets": n_buckets, "wire_bytes_per_round": wire,
        "setup_s": {name: t - marks[i][1] for i, (name, t) in enumerate(marks[1:])},
        **({"grad_check": grads} if grads is not None else {}),
        "warmup_round": warm, "rounds": rounds,
        "round_ms_mean": round_ms_mean,
        "gossip_ms_mean": sum(r["gossip_ms"] for r in rounds) / counted,
        "tokens_per_s_per_chip_mean": sum(r["tokens_per_s_per_chip"] for r in rounds) / counted,
        "peak_memory_bytes": peak, "launches": counts, "launches_expected": expect,
        **extra, "profiled_round": prof,
    }
    if keep_state:
        return out, counts, state, bundle
    del state
    torch.cuda.empty_cache()
    return out, counts, None, None


def gossip_two_step_phase(torch, dev, state, bundle):
    """``train_fp8``'s final state, its optimizer state freed: one
    compressed CHOCO round on the fp8 two-step wire (``fused_wire=False``:
    per bucket ``quantize_fp8`` then ``dequantize_fp8``, launches gated)
    and the same round on the fused wire, from the same state. Bucket by
    bucket, the two wires' codes and scales must be bit-equal and their
    xhat' within one f32 ulp (the fused encode rounds xhat + q * scale
    once, the two-step wire twice); both rounds' parameters finite."""
    import dataclasses

    from consensusml_tpu_torch import kernels
    from consensusml_tpu_torch.comm import simulated
    from consensusml_tpu_torch.consensus import ConsensusEngine
    from consensusml_tpu_torch.consensus.bucketing import build_fused_plan
    from consensusml_tpu_torch.utils import tree as T

    state.opt_state = None  # Adam's moments: 11 GB the gossip rounds do not read
    gc.collect()
    torch.cuda.empty_cache()
    gossip = bundle.cfg.gossip
    fused_eng = ConsensusEngine(gossip)
    two_eng = ConsensusEngine(dataclasses.replace(gossip, fused_wire=False))
    if not fused_eng.fused_wire_active or two_eng.fused_wire_active:
        raise AssertionError("the fp8 codec must ride the fused wire, and not with fused_wire=False")
    w = simulated.mixing_matrix(gossip.topology).to(dev)
    tree = {"params": state.params, "model_state": {}}
    step = state.step  # past the warm-up round, not a refresh round
    refresh = gossip.codec_refresh_every
    if step < gossip.codec_warmup_rounds or (refresh and step % refresh == 0):
        raise AssertionError(f"round {step} is not a compressed CHOCO round")
    n_buckets = len(state.gossip.xhat)

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    two_tree, two_state = two_eng.round_simulated(tree, state.gossip, w, step=step)
    torch.cuda.synchronize()
    two_ms = 1e3 * (time.perf_counter() - t0)
    counts = kernels.launch_counts()
    expect = {name: n_buckets if name in ("quantize_fp8", "dequantize_fp8") else 0 for name in kernels.KERNELS}
    if counts != expect:
        raise AssertionError(f"two-step launches {counts} differ from the prediction {expect}")
    two_finite = all(bool(torch.isfinite(p).all()) for p in two_tree["params"].values())
    two_hat = two_state.xhat
    del two_tree, two_state
    t0 = time.perf_counter()
    fused_tree, fused_state = fused_eng.round_simulated(tree, state.gossip, w, step=step)
    torch.cuda.synchronize()
    fused_ms = 1e3 * (time.perf_counter() - t0)
    fused_finite = all(bool(torch.isfinite(p).all()) for p in fused_tree["params"].values())
    fused_hat = fused_state.xhat
    del fused_tree, fused_state
    # two roundings (q * scale, then the sum) against one: they differ by at
    # most half an ulp of each rounded value, q * scale being at most twice
    # the larger of |xhat| and |xhat'| (M), so by at most 2 ulp(M)
    ulps = 0.0
    for a, b, h in zip(two_hat, fused_hat, state.gossip.xhat):
        m = torch.maximum(torch.maximum(a.abs(), b.abs()), h.abs())
        ulp = torch.nextafter(m, torch.full_like(m, float("inf"))) - m
        ulps = max(ulps, float(((a - b).abs() / ulp).max()))
    del two_hat, fused_hat

    # the payloads of the two wires, bucket by bucket (outside the counted round)
    plan = fused_eng.bucket_plan(tree, stacked=True)
    fused = build_fused_plan(plan, gossip.compressor)
    x = plan.pack([p.to(torch.float32) for p in T.leaves(tree)], stacked=True)
    bad = {"codes": 0, "scales": 0}
    for xb, hb in zip(x, state.gossip.xhat):
        p2 = gossip.compressor.compress(xb - hb, stacked=True)
        pf, _ = fused.codec.encode(xb, hb)
        bad["codes"] += mismatches(torch, p2.data, pf.data)
        bad["scales"] += mismatches(torch, p2.scales, pf.scales)
        del p2, pf
    del x
    if any(bad.values()) or not ulps <= XHAT_ULPS or not (two_finite and fused_finite):
        raise AssertionError(f"fp8 two-step vs fused round: mismatched {bad}, xhat' {ulps} ulps of "
                             f"max(|xhat|, |xhat'|) apart (bound {XHAT_ULPS}), finite {two_finite} {fused_finite}")
    out = {
        "phase": "gossip_fp8_two_step",
        "config": "gpt2_topk full (GPT-2-medium), --workers 4 --codec fp8, one CHOCO round with "
                  "fused_wire=False and one with the fused wire, from train_fp8's final state",
        "round": step, "buckets": n_buckets, "wire_bytes_per_round": two_eng.wire_bytes_per_round(
            {"params": {n: p[0] for n, p in state.params.items()}, "model_state": {}}),
        "launches": counts, "launches_expected": expect,
        "two_step_round_ms": two_ms, "fused_round_ms": fused_ms,
        "payload_mismatches": bad, "xhat_max_ulps_apart": ulps, "xhat_ulps_bound": XHAT_ULPS,
        "params_finite": {"two_step": two_finite, "fused": fused_finite},
    }
    return out, counts


def bn_case(torch, dev, gen, m, c):
    """bf16 (M, C) x and dy, f32 gamma and beta, as a BN layer of ResNet-50
    sees them."""
    x = (2 * torch.randn(m, c, generator=gen, device=dev) + 0.3).to(torch.bfloat16)
    dy = torch.randn(m, c, generator=gen, device=dev).to(torch.bfloat16)
    gamma = 1 + 0.5 * torch.randn(c, generator=gen, device=dev)
    beta = 0.1 * torch.randn(c, generator=gen, device=dev)
    return x, dy, gamma, beta


def sum_err(torch, got, want, terms) -> float:
    """Worst per-channel |got - want| over the sum of its terms' magnitudes."""
    return float(((got - want).abs() / terms.clamp_min(1e-30)).max())


BN_CHECK_VIEWS = ((131072, 256), (131072, 64), (2048, 2048), (8192, 1024), (32768, 512))


def check_bn(torch, tbn, dev):
    """The three fused-BN kernels at five of ResNet-50's BN views (batch 128
    at 32x32, 32x32, 4x4, 8x8 and 16x16), bf16, relu off and on, each
    against its plain version fed the same per-channel vectors: normalize
    equal (error 0); the forward's five per-channel vectors from the
    statistics' fold equal to ``batch_moments`` and ``fold_params`` fed
    the kernel's own sums; the backward's dx equal to ``bn_bwd_dx_plain`` fed the
    kernel's own sums times f32(1/M), its sums and the statistics within
    ``BN_SUM_RTOL`` of their terms' magnitudes, the backward's outputs the
    same bits over three reruns, and the statistics' seven rows too. Timed
    (relu on) beside the plain versions and, as the library yardsticks,
    ``torch.var_mean(x, 0, correction=0)`` for the statistics (the same
    per-channel moments in one call), one ``F.batch_norm`` training forward
    (stats + normalize) for the normalize pass, and its autograd backward
    ((forward + backward) - forward) on the same values as a
    channels_last (128, C, H, W) tensor for the backward: ``ms`` is CUDA
    events over calls queued behind a sleep kernel (:func:`queued_ms`),
    ``profiler_ms`` device time by the profiler (the statistics' by CUDA
    kernel too: ``kernel_split_ms``), ``event_ms`` CUDA events over
    back-to-back calls, which at the small shapes reads the host's time
    per wrapper call instead. The backward's
    ``bound_ms`` counts dy and x read once and dx written once; its
    ``x_pass_bound`` holds it to the passes its plan makes (3 on chip, 5
    where it streams and reads dy and x again)."""
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(6)
    out = {}
    for m, c in BN_CHECK_VIEWS:
        x, dy, gamma, beta = bn_case(torch, dev, gen, m, c)
        xf = x.float()
        s, sq = tbn.bn_stats(x)
        sp, sqp = tbn.bn_stats_plain(x)
        torch.cuda.synchronize()
        errs = {"stats": max(sum_err(torch, s, sp, xf.abs().sum(0)), sum_err(torch, sq, sqp, (xf * xf).sum(0)))}
        abs_errs = {"stats": max(float((s - sp).abs().max()), float((sq - sqp).abs().max()))}
        mean, var = tbn.batch_moments(sp, sqp, m)
        scale, shift, rsqrt = tbn.fold_params(gamma, beta, mean, var, 1e-5)
        vecs = (scale, shift, mean, rsqrt)
        # the forward's per-channel vectors from the statistics' fold, against
        # their plain version fed the kernel's own sums (the same fold order)
        mk, vk = tbn.batch_moments(s, sq, m)
        fwd_bad = sum(mismatches(torch, u, v) for u, v in zip(
            tbn.bn_forward_stats(x, gamma, beta, 1e-5), (mk, vk, *tbn.fold_params(gamma, beta, mk, vk, 1e-5))))
        stats_runs = [tbn._stats_launch(x, gamma, beta, 1e-5) for _ in range(3)]
        stats_reruns_equal = all(torch.equal(r, stats_runs[0]) for r in stats_runs[1:])
        xhat = (xf - mean) * rsqrt
        inv = tbn.inv_rows(m)
        reruns_equal = True
        for relu in (False, True):
            y, yp = tbn.bn_norm(x, scale, shift, relu), tbn.bn_norm_plain(x, scale, shift, relu)
            runs = [tbn.bn_bwd(dy, x, *vecs, relu) for _ in range(3)]
            dx, db, dg = runs[0]
            reruns_equal &= all(torch.equal(u, v) for r in runs[1:] for u, v in zip(r, runs[0]))
            dbp, dgp = tbn.bn_bwd_reduce_plain(dy, x, *vecs, relu)
            dxp = tbn.bn_bwd_dx_plain(dy, x, *vecs, db * inv, dg * inv, relu)
            torch.cuda.synchronize()
            g = dy.float() * ((xf * scale + shift > 0) if relu else 1.0)
            for name, e, a in (
                ("norm", 0.0, float((y.float() - yp.float()).abs().max())),
                ("bwd_sums", max(sum_err(torch, db, dbp, g.abs().sum(0)),
                                 sum_err(torch, dg, dgp, (g * xhat).abs().sum(0))),
                 max(float((db - dbp).abs().max()), float((dg - dgp).abs().max()))),
                ("bwd_dx", 0.0, float((dx.float() - dxp.float()).abs().max())),
            ):
                errs[name] = max(errs.get(name, 0.0), e)
                abs_errs[name] = max(abs_errs.get(name, 0.0), a)
            del y, yp, dx, dxp, g, runs
        if (errs["stats"] > BN_SUM_RTOL or errs["bwd_sums"] > BN_SUM_RTOL or abs_errs["norm"]
                or abs_errs["bwd_dx"] or not reruns_equal or not stats_reruns_equal or fwd_bad):
            raise AssertionError(f"fused BN kernels at ({m}, {c}) differ from their plain versions: "
                                 f"{errs} (sums, rtol {BN_SUM_RTOL}), {abs_errs} (max abs), "
                                 f"reruns equal {reruns_equal} (statistics {stats_reruns_equal}), "
                                 f"forward vectors {fwd_bad} elements off")
        del xhat
        times = {
            # the forward's call: the statistics with the per-channel vectors
            "bn_stats": (lambda _: tbn.bn_forward_stats(x, gamma, beta, 1e-5),
                         lambda _: tbn.bn_forward_stats_plain(x, gamma, beta, 1e-5)),
            "bn_norm": (lambda _: tbn.bn_norm(x, scale, shift, True),
                        lambda _: tbn.bn_norm_plain(x, scale, shift, True)),
            "bn_bwd": (lambda _: tbn.bn_bwd(dy, x, *vecs, True), lambda _: tbn.bn_bwd_plain(dy, x, *vecs, True)),
        }
        hw = m // 128
        side = int(round(hw ** 0.5))
        x4 = x.view(128, side, side, c).permute(0, 3, 1, 2).detach().requires_grad_()
        dy4 = dy.view(128, side, side, c).permute(0, 3, 1, 2)
        g32, b32 = gamma.detach().requires_grad_(), beta.detach().requires_grad_()

        def lib_fwd_bwd(_):
            yl = F.batch_norm(x4, None, None, g32, b32, training=True)
            torch.autograd.grad(yl, (x4, g32, b32), dy4)

        with torch.no_grad():
            fwd_call = lambda _: F.batch_norm(x4, None, None, g32, b32, training=True)  # noqa: E731
            moments = lambda _: torch.var_mean(x, 0, correction=0)  # noqa: E731
            lib_fwd, lib_fwd_prof, lib_fwd_ev = (queued_ms(torch, fwd_call, 100)[0], device_ms(torch, fwd_call, 50),
                                                 cuda_ms(torch, fwd_call, 50))
            lib_mom, lib_mom_prof, lib_mom_ev = (queued_ms(torch, moments, 100)[0], device_ms(torch, moments, 50),
                                                 cuda_ms(torch, moments, 50))
        lib_bwd = queued_ms(torch, lib_fwd_bwd, 100)[0] - lib_fwd
        lib_bwd_prof = device_ms(torch, lib_fwd_bwd, 50) - lib_fwd_prof
        lib_bwd_ev = cuda_ms(torch, lib_fwd_bwd, 50) - lib_fwd_ev
        n = m * c
        vec = 4 * c  # one f32 per-channel vector
        plan = tbn.bn_bwd_plan(m, c, 2, 8)
        passes = 3 if plan.onchip else 5
        bounds = {  # bytes: bf16 (M, C) operands once each; flops at the f32 rate (no tensor cores)
            "bn_stats": bound_ms(2 * n + 2 * vec, 3 * n, F32_FLOPS),
            "bn_norm": bound_ms(4 * n + 2 * vec, 3 * n, F32_FLOPS),
            # mask 2, xhat 2, the two sums 3, dx 4 flops an element
            "bn_bwd": bound_ms(6 * n + 6 * vec, 11 * n, F32_FLOPS),
        }
        err_of = {"bn_stats": "stats", "bn_norm": "norm", "bn_bwd": "bwd_dx"}
        library = {
            "bn_stats": (lib_mom, lib_mom_prof, lib_mom_ev, "torch.var_mean(x, 0, correction=0)"),
            "bn_norm": (lib_fwd, lib_fwd_prof, lib_fwd_ev,
                        "F.batch_norm training forward (stats + normalize together: not the same function)"),
            "bn_bwd": (lib_bwd, lib_bwd_prof, lib_bwd_ev, "F.batch_norm autograd backward"),
        }
        view = {}
        for name, (kern, plain) in times.items():
            lib, lib_prof, lib_ev, lib_name = library[name]
            ms = queued_ms(torch, kern, 100)[0]
            view[name] = {
                "m": m, "c": c, "max_abs_err": abs_errs[err_of[name]],
                "sum_rel_err": errs["stats"] if name == "bn_stats" else errs["bwd_sums"] if name == "bn_bwd" else None,
                "ms": ms, "profiler_ms": device_ms(torch, kern, 50), "plain_ms": device_ms(torch, plain, 10),
                "event_ms": cuda_ms(torch, kern, 50), "plain_event_ms": cuda_ms(torch, plain, 10),
                "library_ms": lib, "library_profiler_ms": lib_prof, "library_event_ms": lib_ev, "library": lib_name,
                "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
                "x_library": ms / lib, "x_bound": ms / bounds[name][0],
            }
        view["bn_stats"].update({
            "plan": tbn.bn_stats_plan(m, c, 2, 8)._asdict(), "reruns_equal": stats_reruns_equal,
            "kernel_split_ms": device_split_ms(torch, times["bn_stats"][0], 50),
        })
        view["bn_bwd"].update({
            "plan": plan._asdict(), "passes": passes, "max_abs_err_sums": abs_errs["bwd_sums"],
            "x_pass_bound": view["bn_bwd"]["ms"] / bound_ms(passes * 2 * n + 6 * vec, 11 * n, F32_FLOPS)[0],
            "reruns_equal": reruns_equal,
        })
        out[(m, c)] = view
        del x, dy, x4, dy4, xf
        torch.cuda.empty_cache()
    return out


def resnet_grad_check(torch, state, batch, dev):
    """One worker step of ResNet-50 (worker 0's parameters and statistics,
    its microbatch) through the fused-BN kernels (``norm_impl="pallas"``)
    against the same step on their plain versions (``"jnp"``)."""
    from consensusml_tpu_torch import configs
    from consensusml_tpu_torch.models.resnet import resnet_loss_fn

    grads = {}
    stats = {"batch_stats": {n: t[0] for n, t in state.model_state["batch_stats"].items()}}
    micro = {k: v[0, 0].to(dev) for k, v in batch.items()}
    for impl in ("pallas", "jnp"):
        leaves = {n: p[0].detach().requires_grad_(True) for n, p in state.params.items()}
        loss, new = resnet_loss_fn(configs.resnet_model("full", impl))(leaves, stats, micro, None)
        grads[impl] = (float(loss.detach()), torch.autograd.grad(loss, list(leaves.values())), new)
        del leaves, loss
    (lk, gk, sk), (lp, gp, sp) = grads["pallas"], grads["jnp"]
    names = list(state.params)
    diff2 = sum(float(((a.float() - b.float()) ** 2).sum()) for a, b in zip(gk, gp))
    ref2 = sum(float((b.float() ** 2).sum()) for b in gp)
    worst, worst_name = max(
        (float((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30)), n)
        for n, a, b in zip(names, gk, gp)
    )
    stats_err = max(float((sk["batch_stats"][n] - sp["batch_stats"][n]).abs().max()) for n in sk["batch_stats"])
    out = {
        "loss_kernels": lk, "loss_plain": lp, "grad_rel_err": (diff2 / ref2) ** 0.5,
        "grad_rel_tol": RESNET_GRAD_REL_TOL, "worst_leaf": worst_name, "worst_leaf_rel_err": worst,
        "leaf_rel_tol": RESNET_LEAF_REL_TOL, "batch_stats_max_abs_err": stats_err,
        "zero_grad_leaves": sum(float(b.abs().max()) == 0.0 for b in gp),
    }
    if not out["grad_rel_err"] <= RESNET_GRAD_REL_TOL or not worst <= RESNET_LEAF_REL_TOL:
        raise AssertionError(f"ResNet gradients through the BN kernels disagree with the plain versions: {out}")
    return out


def resnet_init_named(init: dict, norm_impl: str) -> dict:
    """``norm_impl="flax"`` initial variables under the names of
    ``norm_impl``'s BN layers (``FusedBatchNorm_N`` for the fused path; the
    values do not depend on the BN kind)."""
    if norm_impl == "flax":
        return init
    rename = lambda k: re.sub(r"(^|\.)BatchNorm_", r"\1FusedBatchNorm_", k)  # noqa: E731
    return {col: {rename(k): v for k, v in leaves.items()} for col, leaves in init.items()}


def train_resnet_phase(torch, dev, init, norm_impl, counted):
    """cifar_resnet50 full (8 workers) with ``norm_impl``: "pallas" (the
    ``train_resnet`` line: the fused-BN kernels, with the gradient check)
    or "flax" (``train_resnet_flax``: PyTorch's batch norm). ``init`` is
    the stacked numpy initial variables, drawn once for both."""
    from consensusml_tpu_torch import configs, kernels
    from consensusml_tpu_torch.train.local_sgd import init_stacked_state, make_simulated_train_step
    from consensusml_tpu_torch.utils import tree as T

    bundle = configs.build("cifar_resnet50", "full", norm_impl=norm_impl, device=dev)
    cfg, world = bundle.cfg, bundle.world_size
    marks = [("start", time.perf_counter())]
    batches = list(bundle.batches(2 + counted, 0))
    marks.append(("batches", time.perf_counter()))
    params, model_state = bundle.convert(init)
    state = init_stacked_state(cfg, {n: t.to(dev) for n, t in params.items()}, world, seed=0,
                               model_state=T.tree_map(lambda t: t.to(dev), model_state))
    del params, model_state
    marks.append(("state_on_device", time.perf_counter()))
    step = make_simulated_train_step(cfg, bundle.loss_fn)
    engine = cfg.engine()
    n_buckets = engine.bucket_plan({"params": state.params, "model_state": state.model_state},
                                   stacked=True).num_buckets
    n_params = sum(p[0].numel() for p in state.params.values())
    if (n_buckets, n_params) != (23, 23_520_842):
        raise AssertionError(f"ResNet-50 plan: {n_buckets} buckets, {n_params} params; expected 23, 23520842")

    t0 = time.perf_counter()
    state, m = step(state, batches[0])  # warm: first calls, cuDNN's algorithm choices
    warm = {"loss": float(m["loss"]), "consensus_error": float(m["consensus_error"]),
            "round_ms": 1e3 * (time.perf_counter() - t0)}
    marks.append(("warm_round", time.perf_counter()))
    grads = None
    if norm_impl == "pallas":
        grads = resnet_grad_check(torch, state, batches[1], dev)
        torch.cuda.empty_cache()
        marks.append(("grad_check", time.perf_counter()))

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    gc_pauses = GcPauses()
    gc.callbacks.append(gc_pauses)
    bwd_calls = BnBackwardCalls() if norm_impl == "pallas" else None
    kernels.reset_launch_counts()
    rounds = []
    try:
        for batch in batches[1:1 + counted]:
            gc0 = gc_pauses.snapshot()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            loss, err = float(m["loss"]), float(m["consensus_error"])
            ms = 1e3 * (time.perf_counter() - t0)
            rounds.append({
                "step": state.step - 1, "loss": loss, "consensus_error": err, "round_ms": ms,
                "inner_ms": m["inner_ms"], "gossip_ms": m["gossip_ms"],
                "imgs_per_s_per_chip": m["imgs_per_s"], "buckets": n_buckets,
                "peak_memory_bytes": torch.cuda.max_memory_allocated(dev), **gc_pauses.since(gc0),
            })
    finally:
        gc.callbacks.remove(gc_pauses)
        if bwd_calls is not None:
            bwd_calls.close()
    counts = kernels.launch_counts()
    marks.append(("rounds", time.perf_counter()))
    state, prof = profile_round(torch, step, state, batches[1 + counted])
    marks.append(("profiled_round", time.perf_counter()))

    for r in rounds:
        if not (np.isfinite(r["loss"]) and np.isfinite(r["consensus_error"]) and r["consensus_error"] > 0):
            raise AssertionError(f"round {r['step']}: loss or consensus error not finite and positive: {r}")
    if not rounds[-1]["consensus_error"] < rounds[0]["consensus_error"]:
        raise AssertionError(f"the consensus error did not fall over the counted rounds: {rounds}")
    n_bn = sum(1 for n in state.model_state["batch_stats"] if n.endswith(".mean"))
    per_kernel = n_bn * world * cfg.h * counted if norm_impl == "pallas" else 0
    expect = {name: per_kernel if name in BN_KERNELS else 0 for name in kernels.KERNELS}
    if n_bn != 53 or counts != expect:
        raise AssertionError(f"launches {counts} differ from the counts the code predicts {expect} ({n_bn} BN layers)")
    round_ms_mean = sum(r["round_ms"] for r in rounds) / counted
    if norm_impl == "pallas":
        bn_ms = sum(prof["port_kernels"].get(n, {}).get("ms", 0.0) for n in BN_KERNELS)
        bn_fwd_ms = sum(prof["port_kernels"].get(n, {}).get("ms", 0.0) for n in BN_FWD_KERNELS)
    else:
        bn_ms = prof["library_bn_kernels"]["ms"]
        bn_fwd_ms = bn_ms - prof["library_bn_kernels"]["bwd_ms"]
    if prof["device_kernel_ms"] is not None:
        prof["device_busy_share_of_unprofiled_round"] = prof["device_kernel_ms"] / round_ms_mean
    out = {
        "phase": "train_resnet" if norm_impl == "pallas" else "train_resnet_flax",
        "config": f"cifar_resnet50 full (ResNet-50, CIFAR stem), --norm-impl {norm_impl}",
        "norm_path": bundle.norm_path, "workers": world, "h": cfg.h, "batch": batches[0]["image"].shape[2],
        "image": list(batches[0]["image"].shape[3:]), "bn_layers": n_bn, "params_per_worker": n_params,
        "buckets": n_buckets, "setup_s": {name: t - marks[i][1] for i, (name, t) in enumerate(marks[1:])},
        **({"grad_check": grads} if grads is not None else {}),
        "warmup_round": warm, "rounds": rounds, "round_ms_mean": round_ms_mean,
        "gossip_ms_mean": sum(r["gossip_ms"] for r in rounds) / counted,
        "imgs_per_s_per_chip_mean": sum(r["imgs_per_s_per_chip"] for r in rounds) / counted,
        "peak_memory_bytes": max(r["peak_memory_bytes"] for r in rounds),
        "launches": counts, "launches_expected": expect,
        "bn_device_ms_in_profiled_round": bn_ms,
        "bn_device_ms_in_profiled_round_by_pass": {"forward": bn_fwd_ms, "backward": bn_ms - bn_fwd_ms},
        **({"bn_backward_host": bwd_calls.summary()} if bwd_calls is not None else {}),
        "profiled_round": prof,
    }
    del state
    torch.cuda.empty_cache()
    return out, counts


# consensus error after a dense round (W = 11^T/n: every row of W @ x is
# the same f32 dot product) over the RMS norm of the mean parameters: the
# rows may differ by a few f32 roundings of that product (a few 2^-24 of
# it), a missed worker or a wrong weight by ~1/n of the parameters
DENSE_ERR_RTOL = 1e-6
# the gossip's output against W_{step % period} @ x computed apart in f32,
# element by element: |got - want| <= GOSSIP_RTOL * (|W| @ |x|); both sum
# the same few terms in f32, perhaps in another order (a few 2^-24 of the
# magnitudes), a wrong phase or a dropped term by a whole term
GOSSIP_RTOL = 1e-6


def train_mnist_phase(torch, dev, counted=50, eval_batches=8):
    """mnist_mlp full (the reference's ``_mnist_mlp``: MLP hidden 256, f32,
    4 workers, dense exact gossip, Adam 1e-3, h = 1, batch 64, n = 8192
    28x28x1) on the card: one warm round, ``counted`` rounds (launch
    counters zeroed just before, read just after: the path runs cuBLAS and
    plain ops, none of the port's kernels), then the held-out eval of the
    mean model and of each worker on ``eval_batches`` batches of 64 (one
    profiled round before it: the device-busy share). Gates:
    finite losses, the last below the first; after every (dense) round the
    consensus error within ``DENSE_ERR_RTOL`` of the mean parameters' RMS
    norm; ``wire_bytes_per_round`` equal to 4 bytes a parameter times one
    send (dense: one all-reduce); no port kernel launched; the mean model's
    top-1 above 0.5 (ten classes)."""
    from consensusml_tpu_torch import configs, kernels
    from consensusml_tpu_torch.train.evaluate import evaluate
    from consensusml_tpu_torch.train.local_sgd import init_stacked_state, make_simulated_train_step
    from consensusml_tpu_torch.utils import tree as T

    bundle = configs.build("mnist_mlp", "full", device=dev)
    cfg, world = bundle.cfg, bundle.world_size
    batches = list(bundle.batches(2 + counted, 0))
    params, model_state = bundle.convert(bundle.init_params(0))
    state = init_stacked_state(cfg, {n: t.to(dev) for n, t in params.items()}, world, seed=0,
                               model_state=model_state)
    step = make_simulated_train_step(cfg, bundle.loss_fn)
    engine = cfg.engine()
    n_params = sum(p[0].numel() for p in state.params.values())
    wire = engine.wire_bytes_per_round({"params": {n: p[0] for n, p in state.params.items()}, "model_state": {}})
    state, m = step(state, batches[0])
    warm = {"loss": float(m["loss"]), "consensus_error": float(m["consensus_error"])}
    kernels.reset_launch_counts()
    rounds = []
    for batch in batches[1:1 + counted]:
        t0 = time.perf_counter()
        state, m = step(state, batch)
        loss, err = float(m["loss"]), float(m["consensus_error"])
        ms = 1e3 * (time.perf_counter() - t0)
        rms = float(torch.sqrt(sum((p.mean(dim=0) ** 2).sum() for p in state.params.values())))
        rounds.append({"loss": loss, "consensus_error": err, "mean_params_rms": rms, "round_ms": ms,
                       "inner_ms": m["inner_ms"], "gossip_ms": m["gossip_ms"], "imgs_per_s": m["imgs_per_s"]})
    counts = kernels.launch_counts()
    state, prof = profile_round(torch, step, state, batches[-1])
    t0 = time.perf_counter()
    result = evaluate(bundle.eval_fn, state, bundle.eval_batches(eval_batches, 0))
    eval_s = time.perf_counter() - t0
    losses = [r["loss"] for r in rounds]
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"train_mnist: losses not finite and falling: {losses}")
    worst = max(r["consensus_error"] / r["mean_params_rms"] for r in rounds)
    if not worst <= DENSE_ERR_RTOL:
        raise AssertionError(f"train_mnist: consensus error after a dense round {worst} x the RMS norm "
                             f"> {DENSE_ERR_RTOL}: {[r['consensus_error'] for r in rounds]}")
    if wire != 4 * n_params or engine._sends_per_round() != 1:
        raise AssertionError(f"train_mnist: wire bytes {wire} != 4 x {n_params} params x 1 send")
    if any(counts.values()):
        raise AssertionError(f"train_mnist: the path launched port kernels: {counts}")
    top1 = float(result["mean_model"]["top1"])
    if not top1 > 0.5:
        raise AssertionError(f"train_mnist: mean-model top-1 {top1} <= 0.5")
    ms_sorted = sorted(r["round_ms"] for r in rounds)
    out = {
        "phase": "train_mnist",
        "config": "mnist_mlp full (MLP hidden 256, f32), 4 workers, dense exact gossip, Adam 1e-3, h 1, batch 64",
        "workers": world, "params_per_worker": n_params, "topology": cfg.gossip.topology.name,
        "counted_rounds": counted, "warmup_round": warm,
        "round_ms": {"median": float(np.median(ms_sorted)), "min": ms_sorted[0], "max": ms_sorted[-1],
                     "p10": float(np.percentile(ms_sorted, 10)), "p90": float(np.percentile(ms_sorted, 90))},
        "imgs_per_s_median": float(np.median([r["imgs_per_s"] for r in rounds])),
        "gossip_ms_median": float(np.median([r["gossip_ms"] for r in rounds])),
        "inner_ms_median": float(np.median([r["inner_ms"] for r in rounds])),
        "loss_first": losses[0], "loss_last": losses[-1],
        "consensus_error_after_each_round": [r["consensus_error"] for r in rounds],
        "consensus_error_over_rms_worst": worst, "dense_err_rtol": DENSE_ERR_RTOL,
        "wire_bytes_per_round": wire, "eval_batches": eval_batches, "eval_s": eval_s,
        "top1_mean_model": top1, "top1_workers": [float(x) for x in result["per_worker"]["top1"]],
        "top1_worker_mean": result["worker_mean"]["top1"], "launches": counts,
        "profiled_round": {k: prof[k] for k in ("wall_ms", "device_kernel_ms", "device_busy_share", "kernels",
                                                 "top_kernels")},
    }
    del state
    torch.cuda.empty_cache()
    return out, counts


class GossipCheck:
    """For the rounds it is open, holds every exact gossip round of the
    simulated engine to ``W_{step % period} @ x``: the matrix the round was
    given must be the topology's own phase (built here from its numpy
    matrices), and each output leaf must equal that matrix times the input
    leaf, computed apart on the card in f32, to ``GOSSIP_RTOL``."""

    COLUMNS = 1 << 20  # columns of a leaf's (workers, elements) view held at once

    def __init__(self, torch, topology, dev):
        from consensusml_tpu_torch.consensus.engine import ConsensusEngine

        self.torch, self.cls, self.orig = torch, ConsensusEngine, ConsensusEngine.round_simulated
        mats = topology.phase_matrices() if topology.is_time_varying else topology.mixing_matrix()[None]
        self.w = torch.as_tensor(np.asarray(mats), dtype=torch.float32, device=dev)
        self.rounds, self.worst = [], 0.0
        check = self

        def round_simulated(engine, params, state, w, step=None, alive=None):
            if alive is not None:
                raise AssertionError("GossipCheck holds unmasked rounds to W @ x; this round was masked")
            out = check.orig(engine, params, state, w, step=step)
            check.check(params, w, step, out[0])
            return out

        ConsensusEngine.round_simulated = round_simulated

    def check(self, params, w, step, mixed) -> None:
        from consensusml_tpu_torch.utils import tree as T

        torch = self.torch
        want_w = self.w[step % self.w.shape[0]]
        if not torch.equal(w, want_w):
            raise AssertionError(f"gossip round {step}: the engine got another matrix than phase {step % self.w.shape[0]}")
        worst = 0.0
        for x, got in zip(T.leaves(params), T.leaves(mixed)):
            flat, got_flat = x.reshape(x.shape[0], -1), got.reshape(got.shape[0], -1)
            # a slice of columns at a time: BERT-base's token embedding at 32
            # workers is 3 GB a copy, several copies on top of the round's own
            for c0 in range(0, flat.shape[1], self.COLUMNS):
                cols = flat[:, c0:c0 + self.COLUMNS].to(torch.float32)
                want = (want_w @ cols).to(x.dtype)
                scale = want_w.abs() @ cols.abs()
                err = (got_flat[:, c0:c0 + self.COLUMNS].float() - want.float()).abs()
                worst = max(worst, (err / (GOSSIP_RTOL * scale + 1e-30)).max().item())
        if not worst <= 1.0:
            raise AssertionError(f"gossip round {step}: output off W @ x by {worst} x the tolerance")
        self.rounds.append(step)
        self.worst = max(self.worst, worst)

    def close(self) -> None:
        self.cls.round_simulated = self.orig


RESNET_TOPOLOGIES = ("torus:rows=2", "exp", "onepeer-exp", "hierarchical:slices=2,outer_every=2")


def onepeer_finite_time_check(torch, dev, world=8):
    """The reference's finite-time guarantee through the port's engine on
    the card: onepeer-exp at 8 = 2^3 workers, random stacked parameters,
    one period of exact gossip rounds; the consensus error must fall to
    1e-6 of its start (one period is exactly 11^T/8; f32 rounding is left)."""
    from consensusml_tpu_torch.comm import simulated
    from consensusml_tpu_torch.consensus import ConsensusEngine, GossipConfig
    from consensusml_tpu_torch.topology import topology_from_name

    topo = topology_from_name("onepeer-exp", world)
    engine = ConsensusEngine(GossipConfig(topology=topo))
    gen = torch.Generator(device=dev).manual_seed(17)
    params = {"a": torch.randn(world, 1 << 20, generator=gen, device=dev),
              "b": torch.randn(world, 3, 1000, generator=gen, device=dev)}
    e0 = float(engine.consensus_error_simulated(params))
    errs = []
    for t, w in enumerate(simulated.phase_matrices(topo, device=dev)):
        params, _ = engine.round_simulated(params, None, w, step=t)
        errs.append(float(engine.consensus_error_simulated(params)))
    if not errs[-1] <= 1e-6 * e0:
        raise AssertionError(f"onepeer-exp, {world} workers: error {errs[-1]} after one period > 1e-6 x {e0}")
    return {"workers": world, "period": topo.period, "start": e0, "after_each_round": errs,
            "ratio": errs[-1] / e0}


def train_resnet_topologies_phase(torch, dev, init):
    """cifar_resnet50 full (8 workers, ``--norm-impl pallas``: every BN
    through the fused-BN kernels) on each of ``RESNET_TOPOLOGIES``, one
    full period plus one round each, from ``init``. Every round's gossip is
    held to ``W_{step % period} @ x`` (:class:`GossipCheck`); the BN
    kernels must launch 53 x 8 a round, nothing else; losses and consensus
    errors finite. Then :func:`onepeer_finite_time_check`."""
    from consensusml_tpu_torch import configs, kernels
    from consensusml_tpu_torch.train.local_sgd import init_stacked_state, make_simulated_train_step
    from consensusml_tpu_torch.utils import tree as T

    lines, total = {}, {name: 0 for name in kernels.KERNELS}
    for spec in RESNET_TOPOLOGIES:
        bundle = configs.build("cifar_resnet50", "full", norm_impl="pallas", topology=spec, device=dev)
        cfg, world, topo = bundle.cfg, bundle.world_size, bundle.cfg.gossip.topology
        period = topo.period if topo.is_time_varying else 1
        n_rounds = period + 1
        params, model_state = bundle.convert(init)
        state = init_stacked_state(cfg, {n: t.to(dev) for n, t in params.items()}, world, seed=0,
                                   model_state=T.tree_map(lambda t: t.to(dev), model_state))
        del params, model_state
        step = make_simulated_train_step(cfg, bundle.loss_fn)
        check = GossipCheck(torch, topo, dev)
        kernels.reset_launch_counts()
        rounds = []
        try:
            for batch in bundle.batches(n_rounds, 0):
                t0 = time.perf_counter()
                state, m = step(state, batch)
                loss, err = float(m["loss"]), float(m["consensus_error"])
                rounds.append({"step": state.step - 1, "phase": (state.step - 1) % period, "loss": loss,
                               "consensus_error": err, "round_ms": 1e3 * (time.perf_counter() - t0),
                               "gossip_ms": m["gossip_ms"]})
        finally:
            check.close()
        counts = kernels.launch_counts()
        n_bn = sum(1 for n in state.model_state["batch_stats"] if n.endswith(".mean"))
        expect = {name: n_bn * world * n_rounds if name in BN_KERNELS else 0 for name in kernels.KERNELS}
        if counts != expect or check.rounds != list(range(n_rounds)):
            raise AssertionError(f"{spec}: launches {counts} (expected {expect}), gossip checked at {check.rounds}")
        if not all(np.isfinite(r["loss"]) and np.isfinite(r["consensus_error"]) for r in rounds):
            raise AssertionError(f"{spec}: loss or consensus error not finite: {rounds}")
        for name, n in counts.items():
            total[name] += n
        lines[spec] = {
            "topology": topo.name, "mesh": list(topo.mesh_shape), "period": period,
            "sends_per_round": cfg.engine()._sends_per_round(), "spectral_gap": topo.spectral_gap(),
            "wire_bytes_per_round": cfg.engine().wire_bytes_per_round(
                {"params": {n: p[0] for n, p in state.params.items()},
                 "model_state": T.tree_map(lambda t: t[0], state.model_state)}),
            "rounds": rounds, "gossip_worst_err_over_tol": check.worst, "launches": counts,
        }
        del state, step
        torch.cuda.empty_cache()
    finite = onepeer_finite_time_check(torch, dev)
    out = {"phase": "train_resnet_topologies",
           "config": "cifar_resnet50 full (ResNet-50, CIFAR stem), 8 workers, --norm-impl pallas, --topology ...",
           "gossip_rtol": GOSSIP_RTOL, "topologies": lines, "onepeer_exp_finite_time": finite, "launches": total}
    return out, total


# ---------------------------------------------------------------------------
# fault-tolerant and directed gossip (worker drop-outs, non-finite
# rollback, push-sum) and the per-leaf wire
# ---------------------------------------------------------------------------

# what a masked or push-sum round must keep, element by element of every
# gossiped leaf: the workers' mean (masked mixing on a symmetric graph is
# doubly stochastic), or sum_i w_i z_i and sum_i w_i (push-sum's operator
# is column-stochastic): |after - before| <= FAULT_RTOL * (sum_i |terms|),
# f32 sums of a few terms in another order being a few 2^-24 of them, a
# lost or doubled worker a whole term
FAULT_RTOL = 1e-5
FAULT_DROP_PROB = 0.1
FAULT_DEAD = (2, 5)  # the alive= round's masked workers
FAULT_NAN_WORKER = 3  # and the worker whose batch is NaN in that round


class FaultRoundCheck:
    """While open, holds every simulated gossip round to what it must
    keep (``FAULT_RTOL``): nothing non-finite comes out; an exact masked
    round gives a worker the mask kills its input rows back bit for bit
    and keeps the workers' mean of every leaf; a push-sum round keeps
    ``sum_i w_i`` (= the world size) and ``sum_i w_i z_i`` of every leaf.
    The sums are taken in f64 on the card, a leaf at a time."""

    def __init__(self, torch):
        from consensusml_tpu_torch.consensus.engine import ConsensusEngine

        self.torch, self.cls, self.orig = torch, ConsensusEngine, ConsensusEngine.round_simulated
        self.rounds = []
        check = self

        def round_simulated(engine, params, state, w, step=None, alive=None):
            before = check.before(engine, params, state, alive)
            out = check.orig(engine, params, state, w, step=step, alive=alive)
            check.check(engine, state, alive, out, before, step)
            return out

        ConsensusEngine.round_simulated = round_simulated

    def _sums(self, leaves, w):
        torch = self.torch
        out = []
        for x in leaves:
            x64 = x.to(torch.float64).reshape(x.shape[0], -1)
            if w is not None:
                x64 = x64 * w.to(torch.float64)[:, None]
            out.append((x64.sum(0), x64.abs().sum(0)))
        return out

    def before(self, engine, params, state, alive):
        from consensusml_tpu_torch.utils import tree as T

        leaves = T.leaves(params)
        dead = [] if alive is None else [i for i, a in enumerate(alive.tolist()) if a == 0]
        push = engine.config.push_sum_enabled
        return {"sums": self._sums(leaves, state.w if push else None), "dead": dead,
                "dead_rows": [x[dead].clone() for x in leaves] if dead and not push else []}

    def check(self, engine, state, alive, out, before, step) -> None:
        from consensusml_tpu_torch.utils import tree as T

        torch = self.torch
        mixed, new_state = out
        leaves = T.leaves(mixed)
        push = engine.config.push_sum_enabled
        sums = self._sums(leaves, new_state.w if push else None)
        worst = 0.0
        for (b, scale), (a, _s) in zip(before["sums"], sums):
            worst = max(worst, float(((a - b).abs() / (FAULT_RTOL * scale + 1e-30)).max()))
        finite = all(bool(torch.isfinite(x).all()) for x in leaves)
        # masked mixing gives a dead row back as it came; push-sum gives its
        # mass back and (z w) / w, within a rounding of z
        dead_kept = push or all(torch.equal(x[before["dead"]], rows) for x, rows in zip(leaves, before["dead_rows"]))
        rec = {"step": step, "alive": None if alive is None else alive.tolist(), "dead": before["dead"],
               "kept_sums_worst_over_tol": worst, "finite": finite, "dead_rows_kept_bitwise": dead_kept}
        if push:
            w_sum = float(new_state.w.to(torch.float64).sum())
            rec["mass"] = new_state.w.tolist()
            rec["mass_sum"] = w_sum
            if abs(w_sum - len(rec["mass"])) > FAULT_RTOL * len(rec["mass"]):
                raise AssertionError(f"push-sum round {step}: the masses sum to {w_sum}: {rec}")
        if not (worst <= 1.0 and finite and dead_kept):
            raise AssertionError(f"gossip round {step} did not keep what it must: {rec}")
        self.rounds.append(rec)

    def close(self) -> None:
        self.cls.round_simulated = self.orig


def train_resnet_faults_phase(torch, dev, init, push_sum: bool, counted=3):
    """``train_resnet_faults`` (``push_sum`` False: the ring, masked
    mixing) or ``train_resnet_pushsum`` (True: onepeer-exp, push-sum): a
    warm round, then ``counted`` rounds with every worker's drawn flags,
    each gossip round held by :class:`FaultRoundCheck`, 53 x 8 launches a
    round of each BN kernel. The faults phase then runs one round with
    ``alive=`` masking workers 2 and 5 and a NaN batch for worker 3:
    worker 3 must roll back (its parameters and statistics as before the
    round, bit for bit) and be dead, workers 2, 3 and 5 must leave the
    gossip with their pre-gossip rows, and no NaN may reach any worker."""
    from consensusml_tpu_torch import configs, kernels
    from consensusml_tpu_torch.train.local_sgd import init_stacked_state, make_simulated_train_step
    from consensusml_tpu_torch.utils import tree as T

    bundle = configs.build("cifar_resnet50", "full", norm_impl="pallas",
                           topology="onepeer-exp" if push_sum else None, device=dev)
    configs.with_gossip_flags(bundle, drop_prob=FAULT_DROP_PROB, push_sum=push_sum)
    cfg, world = bundle.cfg, bundle.world_size
    engine = cfg.engine()
    if engine.config.push_sum_enabled != push_sum or engine.config.faults is None:
        raise AssertionError(f"fault config not as asked: {engine.config}")
    marks = [("start", time.perf_counter())]
    extra = 0 if push_sum else 1
    batches = list(bundle.batches(1 + counted + extra, 0))
    params, model_state = bundle.convert(init)
    state = init_stacked_state(cfg, {n: t.to(dev) for n, t in params.items()}, world, seed=0,
                               model_state=T.tree_map(lambda t: t.to(dev), model_state))
    del params, model_state
    marks.append(("state_on_device", time.perf_counter()))
    step = make_simulated_train_step(cfg, bundle.loss_fn)
    check = FaultRoundCheck(torch)
    rounds = []
    try:
        t0 = time.perf_counter()
        state, m = step(state, batches[0])
        warm = {"loss": float(m["loss"]), "consensus_error": float(m["consensus_error"]),
                "alive_mask": m["alive_mask"].tolist(), "round_ms": 1e3 * (time.perf_counter() - t0)}
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launch_counts()
        for batch in batches[1:1 + counted]:
            t0 = time.perf_counter()
            state, m = step(state, batch)
            loss, err = float(m["loss"]), float(m["consensus_error"])
            rounds.append({"step": state.step - 1, "loss": loss, "consensus_error": err,
                           "round_ms": 1e3 * (time.perf_counter() - t0), "inner_ms": m["inner_ms"],
                           "gossip_ms": m["gossip_ms"], "imgs_per_s_per_chip": m["imgs_per_s"],
                           "alive_frac": float(m["alive_frac"]), "alive_mask": m["alive_mask"].tolist(),
                           **({"mass": state.gossip.w.tolist()} if push_sum else {})})
        counts = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        marks.append(("rounds", time.perf_counter()))
        masked = None
        if not push_sum:
            masked, masked_counts = masked_nan_round(torch, step, state, batches[1 + counted], world)
            state = masked.pop("state")
            marks.append(("masked_round", time.perf_counter()))
    finally:
        check.close()
    for r in rounds:
        if not (np.isfinite(r["loss"]) and np.isfinite(r["consensus_error"])):
            raise AssertionError(f"round {r['step']}: loss or consensus error not finite: {r}")
    n_bn = sum(1 for n in state.model_state["batch_stats"] if n.endswith(".mean"))
    expect = {name: n_bn * world * cfg.h * counted if name in BN_KERNELS else 0 for name in kernels.KERNELS}
    if n_bn != 53 or counts != expect:
        raise AssertionError(f"launches {counts} differ from the counts the code predicts {expect}")
    if len(check.rounds) != 1 + counted + extra:
        raise AssertionError(f"{len(check.rounds)} gossip rounds were checked, not {1 + counted + extra}")
    total = dict(counts)
    if masked is not None:
        m_expect = {name: n_bn * world * cfg.h if name in BN_KERNELS else 0 for name in kernels.KERNELS}
        if masked_counts != m_expect:
            raise AssertionError(f"the masked round's launches {masked_counts} differ from {m_expect}")
        total = {k: v + masked_counts[k] for k, v in counts.items()}
    counted_ms = [r["round_ms"] for r in rounds]
    flags = "--norm-impl pallas --drop-prob 0.1" + (" --topology onepeer-exp --push-sum" if push_sum else "")
    out = {
        "phase": "train_resnet_pushsum" if push_sum else "train_resnet_faults",
        "config": f"cifar_resnet50 full (ResNet-50, CIFAR stem), 8 workers, {flags}",
        "topology": engine.topology.name, "push_sum": push_sum, "drop_prob": FAULT_DROP_PROB,
        "wire": "per-leaf (push-sum)" if push_sum else "dense bucketed",
        "wire_bytes_per_round": engine.wire_bytes_per_round(
            {"params": {n: p[0] for n, p in state.params.items()},
             "model_state": T.tree_map(lambda t: t[0], state.model_state)}),
        "setup_s": {name: t - marks[i][1] for i, (name, t) in enumerate(marks[1:])},
        "warmup_round": warm, "rounds": rounds, "round_ms_mean": sum(counted_ms) / counted,
        "gossip_ms_mean": sum(r["gossip_ms"] for r in rounds) / counted,
        "peak_memory_bytes": peak, "launches": total, "launches_expected_counted": expect,
        "gossip_checks": check.rounds, "kept_sums_rtol": FAULT_RTOL,
        **({"masked_nan_round": masked} if masked is not None else {}),
    }
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    return out, total


def masked_nan_round(torch, step, state, batch, world):
    """The faults phase's last round: ``alive=`` with workers 2 and 5
    masked, and worker 3's batch NaN (module constants). Returns the gated
    record (with the new ``state``) and the round's launches."""
    from consensusml_tpu_torch import kernels

    batch = dict(batch)
    batch["image"] = batch["image"].clone()
    batch["image"][FAULT_NAN_WORKER] = float("nan")
    w = FAULT_NAN_WORKER
    rows = {n: p[w].clone() for n, p in state.params.items()}
    stats = {n: t[w].clone() for n, t in state.model_state["batch_stats"].items()}
    mask = torch.ones(world, dtype=torch.float32)
    mask[list(FAULT_DEAD)] = 0.0
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    state, m = step(state, batch, alive=mask)
    ms = 1e3 * (time.perf_counter() - t0)
    counts = kernels.launch_counts()
    alive = m["alive_mask"].tolist()
    rolled_back = (all(torch.equal(state.params[n][w], r) for n, r in rows.items())
                   and all(torch.equal(state.model_state["batch_stats"][n][w], t) for n, t in stats.items()))
    finite = (all(bool(torch.isfinite(p).all()) for p in state.params.values())
              and all(bool(torch.isfinite(t).all()) for t in state.model_state["batch_stats"].values()))
    want_alive = [0.0 if i in FAULT_DEAD or i == w else 1.0 for i in range(world)]
    rec = {"alive_given": mask.tolist(), "nan_worker": w, "alive_mask": alive, "alive_mask_expected": want_alive,
           "loss": float(m["loss"]), "consensus_error": float(m["consensus_error"]), "round_ms": ms,
           "nan_worker_rolled_back_bitwise": rolled_back, "every_worker_finite": finite, "launches": counts}
    if alive != want_alive or not rolled_back or not finite:
        raise AssertionError(f"the masked NaN round: {rec}")
    rec["state"] = state
    return rec, counts


class PayloadBytes:
    """While open, adds up the wire bytes of every payload a codec's
    ``compress`` returns (stacked payloads counted a worker's share)."""

    def __init__(self, cls, world):
        self.cls, self.orig, self.bytes, self.calls = cls, cls.compress, 0, 0
        counter = self

        def compress(codec, x, stacked=False):
            p = counter.orig(codec, x, stacked=stacked)
            n = sum(t.numel() * t.element_size() for t in p.wire_tensors())
            counter.bytes += n // world if stacked else n
            counter.calls += 1
            return p

        cls.compress = compress

    def close(self):
        self.cls.compress = self.orig


def train_perleaf_phase(torch, tck, dev, init, counted=2):
    """``train_perleaf_topk``: gpt2_topk full, --workers 4 --codec-warmup 1
    --bucket-bytes 0 (the config's top-k + int8 codec on the per-leaf
    wire: every leaf compressed, decoded and mixed on its own). Gates: the
    four codec kernels launch once a leaf an exchange; the payload bytes a
    worker's exchange produces, times the ring's two sends, equal
    ``wire_bytes_per_round`` (printed beside the bucketed wire's); one
    round of the first ``GPT2_CHECK_LEAVES`` leaves through the kernels
    equals the same round through their plain versions bit for bit
    (parameters, xhat and s)."""
    from consensusml_tpu_torch import configs, kernels
    from consensusml_tpu_torch.compress.base import ComposedCompressor
    from consensusml_tpu_torch.models.convert import gpt2_from_flax
    from consensusml_tpu_torch.train.local_sgd import init_stacked_state, make_simulated_train_step

    world = 4
    bundle = configs.build("gpt2_topk", "full", world=world, codec_warmup=1, device=dev)
    configs.with_gossip_flags(bundle, bucket_bytes=0)
    cfg, mcfg = bundle.cfg, bundle.model.config
    engine = cfg.engine()
    if engine.bucketed or engine.fused_wire_active:
        raise AssertionError("--bucket-bytes 0 must take the per-leaf wire")
    marks = [("start", time.perf_counter())]
    batches = list(bundle.batches(1 + counted, 0))
    state = init_stacked_state(cfg, {n: t.to(dev) for n, t in gpt2_from_flax(init).items()}, world, seed=0)
    marks.append(("state_on_device", time.perf_counter()))
    step = make_simulated_train_step(cfg, bundle.loss_fn)
    n_leaves = len(state.params)
    per_worker = {"params": {n: p[0] for n, p in state.params.items()}, "model_state": {}}
    wire = engine.wire_bytes_per_round(per_worker)
    del per_worker
    ids = batches[0]["input_ids"]
    t0 = time.perf_counter()
    state, m = step(state, batches[0])  # round 0: warm (dense mixing), not counted
    warm = {"loss": float(m["loss"]), "consensus_error": float(m["consensus_error"]),
            "round_ms": 1e3 * (time.perf_counter() - t0)}
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    payload = PayloadBytes(ComposedCompressor, world)
    rounds = []
    try:
        for batch in batches[1:]:
            b0 = payload.bytes
            t0 = time.perf_counter()
            state, m = step(state, batch)
            loss, err = float(m["loss"]), float(m["consensus_error"])
            ms = 1e3 * (time.perf_counter() - t0)
            sends = engine._sends_per_round()
            rounds.append({"step": state.step - 1, "loss": loss, "consensus_error": err, "round_ms": ms,
                           "inner_ms": m["inner_ms"], "gossip_ms": m["gossip_ms"],
                           "tokens_per_s_per_chip": world * cfg.h * ids.shape[2] * ids.shape[3] / (ms / 1e3),
                           "wire_bytes": int((payload.bytes - b0) * sends)})
    finally:
        payload.close()
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    marks.append(("rounds", time.perf_counter()))
    exchanges = counted * cfg.gossip.gossip_steps
    expect = dict.fromkeys(kernels.KERNELS, 0)
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        expect[name] = mcfg.layers * world * cfg.h * counted
    for name in CODEC_KERNELS[None]:
        expect[name] = n_leaves * exchanges
    problems = []
    if counts != expect:
        problems.append(f"launches {counts} differ from the per-leaf plan's {expect}")
    for r in rounds:
        if not (np.isfinite(r["loss"]) and np.isfinite(r["consensus_error"]) and r["consensus_error"] > 0):
            problems.append(f"round {r['step']}: loss or consensus error not finite and positive")
        if r["wire_bytes"] != wire:
            problems.append(f"round {r['step']}: {r['wire_bytes']} payload bytes, wire_bytes_per_round {wire}")
    if problems:
        raise AssertionError("train_perleaf_topk: " + "; ".join(problems))
    state.opt_state = None  # Adam's moments: the check round does not read them
    gc.collect()
    torch.cuda.empty_cache()
    check = perleaf_plain_check(torch, tck, dev, engine, state)
    out = {
        "phase": "train_perleaf_topk",
        "config": "gpt2_topk full (GPT-2-medium), --workers 4 --codec-warmup 1 --bucket-bytes 0",
        "codec_path": bundle.codec_path, "wire": "per-leaf", "workers": world, "h": cfg.h,
        "leaves": n_leaves, "wire_bytes_per_round": wire,
        "bucketed_wire_bytes_per_round": PLANS[None][1], "bucketed_buckets": PLANS[None][0],
        "setup_s": {name: t - marks[i][1] for i, (name, t) in enumerate(marks[1:])},
        "warmup_round": warm, "rounds": rounds, "round_ms_mean": sum(r["round_ms"] for r in rounds) / counted,
        "gossip_ms_mean": sum(r["gossip_ms"] for r in rounds) / counted,
        "peak_memory_bytes": peak, "launches": counts, "launches_expected": expect,
        "kernels_vs_plain_round": check,
    }
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    return out, counts


def perleaf_plain_check(torch, tck, dev, engine, state):
    """One per-leaf CHOCO round of the first ``GPT2_CHECK_LEAVES`` leaves
    (their CHOCO state with them) through the codec kernels, then through
    their plain versions (the wrappers swapped for them for that round, so
    nothing counts): parameters, xhat and s bit-equal."""
    from consensusml_tpu_torch.comm import simulated
    from consensusml_tpu_torch.consensus import ChocoState

    names = sorted(state.params)[:GPT2_CHECK_LEAVES]
    tree = {"params": {n: state.params[n] for n in names}, "model_state": {}}
    sub = ChocoState(xhat=list(state.gossip.xhat[:len(names)]), s=list(state.gossip.s[:len(names)]))
    w = simulated.mixing_matrix(engine.topology, device=dev)
    step = state.step
    got_tree, got_state = engine.round_simulated(tree, sub, w, step=step)
    swapped = {name: getattr(tck, name) for name in CODEC_KERNELS[None]}
    try:
        for name in swapped:
            setattr(tck, name, getattr(tck, f"{name}_plain"))
        want_tree, want_state = engine.round_simulated(tree, sub, w, step=step)
    finally:
        for name, fn in swapped.items():
            setattr(tck, name, fn)
    torch.cuda.synchronize()
    bad = {"params": sum(mismatches(torch, got_tree["params"][n], want_tree["params"][n]) for n in names),
           "xhat": sum(mismatches(torch, a, b) for a, b in zip(got_state.xhat, want_state.xhat)),
           "s": sum(mismatches(torch, a, b) for a, b in zip(got_state.s, want_state.s))}
    out = {"leaves": len(names), "elements_per_worker": sum(state.params[n][0].numel() for n in names),
           "round": step, "bits_differing": bad}
    if any(bad.values()):
        raise AssertionError(f"the per-leaf round through the kernels differs from the plain versions': {out}")
    return out


# ---------------------------------------------------------------------------
# overlap gossip (combine-then-adapt, pipelined to depth D) and the fused codec
# ---------------------------------------------------------------------------

OVERLAP_DEPTH = 2  # --gossip-pipeline of the simulated overlap phases
RESNET50_BN_LAYERS = 53
# every queued correction sums to zero over the workers (doubly stochastic
# W; CHOCO's sum_i s_i = sum_i xhat_i), element by element of every leaf:
# |sum_i c_i| <= CORRECTION_SUM_RTOL * sum_i (|c_i| + |z_i|), the sums in
# f64 on the card: each c_i is an f32 difference of values of z's size, so
# its rounding is a few 2^-24 of |z|; a lost or doubled worker's term is a
# whole |c_i|
CORRECTION_SUM_RTOL = 1e-5


class CorrectionSums:
    """While open, holds every simulated overlap correction's queue to
    ``CORRECTION_SUM_RTOL`` (its sums over the workers in f64 on the card,
    a leaf at a time) and records the worst reading."""

    def __init__(self, torch):
        from consensusml_tpu_torch.consensus.engine import ConsensusEngine

        self.torch, self.cls, self.orig = torch, ConsensusEngine, ConsensusEngine.correction_simulated
        self.rounds: list = []
        check = self

        def correction_simulated(engine, tree, w, state=None):
            out = check.orig(engine, tree, w, state)
            check.check(tree, out)
            return out

        ConsensusEngine.correction_simulated = correction_simulated

    def check(self, tree, out) -> None:
        from consensusml_tpu_torch.utils import tree as T

        torch = self.torch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        z = T.leaves(tree)
        worst, finite = 0.0, True
        for corr in (out.correction,) + tuple(out.pending):
            for c, x in zip(T.leaves(corr), z):
                c64 = c.to(torch.float64).reshape(c.shape[0], -1)
                scale = c64.abs().sum(0) + x.to(torch.float64).reshape(x.shape[0], -1).abs().sum(0)
                worst = max(worst, float((c64.sum(0).abs() / (CORRECTION_SUM_RTOL * scale + 1e-30)).max()))
                finite = finite and bool(torch.isfinite(c).all())
        torch.cuda.synchronize()
        # the check's own time, inside the round's gossip_ms
        rec = {"queued": 1 + len(out.pending), "sum_worst_over_tol": worst, "finite": finite,
               "check_ms": 1e3 * (time.perf_counter() - t0)}
        if not (worst <= 1.0 and finite):
            raise AssertionError(f"the queued corrections do not sum to zero over the workers: {rec}")
        self.rounds.append(rec)

    def close(self) -> None:
        self.cls.correction_simulated = self.orig


def counted_rounds(torch, dev, step, state, batches, tokens_or_images):
    """A warm round, then the counted ones (launch counters zeroed just
    before; each round's loss, consensus error, round, gossip and inner ms
    and its rate). Returns ``(state, warm, rounds, counts, peak)``."""
    from consensusml_tpu_torch import kernels

    t0 = time.perf_counter()
    state, m = step(state, batches[0])
    warm = {"loss": float(m["loss"]), "consensus_error": float(m["consensus_error"]),
            "round_ms": 1e3 * (time.perf_counter() - t0)}
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    rounds = []
    for batch in batches[1:]:
        t0 = time.perf_counter()
        state, m = step(state, batch)
        loss, err = float(m["loss"]), float(m["consensus_error"])
        ms = 1e3 * (time.perf_counter() - t0)
        rounds.append({"step": state.step - 1, "loss": loss, "consensus_error": err, "round_ms": ms,
                       "inner_ms": m["inner_ms"], "gossip_ms": m["gossip_ms"],
                       "per_s_per_chip": tokens_or_images / (ms / 1e3)})
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    for r in rounds:
        if not (np.isfinite(r["loss"]) and np.isfinite(r["consensus_error"]) and r["consensus_error"] > 0):
            raise AssertionError(f"round {r['step']}: loss or consensus error not finite and positive: {r}")
    return state, warm, rounds, counts, peak


def resnet_overlap_plain_check(torch, dev, cfg, state, batch):
    """One overlap round of ResNet-50 from a copy of ``state`` through the
    fused-BN kernels and through their plain versions (``norm_impl="jnp"``,
    the same leaves): the round's gossip, computed from ``z`` before the
    local steps, runs no kernel and must be bit-equal (``z``'s consensus
    error, the correction queue); the local steps' BN statistics sum in
    another order on the two sides, so their update to the parameters and
    statistics is held to the ResNet gradient check's tolerance,
    ``||u_k - u_p|| / ||u_p||`` with ``u`` the round's change."""
    from consensusml_tpu_torch import configs
    from consensusml_tpu_torch.train.local_sgd import make_simulated_train_step
    from consensusml_tpu_torch.utils import tree as T

    before = {n: p.clone() for n, p in state.params.items()}
    out = {}
    for impl in ("pallas", "jnp"):
        loss_fn = configs.build("cifar_resnet50", "full", norm_impl=impl, device=dev).loss_fn
        st, m = make_simulated_train_step(cfg, loss_fn)(copy_tree(torch, state), batch)
        out[impl] = (st, float(m["consensus_error"]), float(m["loss"]))
        del st
    (sk, ek, lk), (sp, ep, lp) = out["pallas"], out["jnp"]
    queue = [(a, b) for ca, cb in [(sk.gossip.correction, sp.gossip.correction)] + list(
        zip(sk.gossip.pending, sp.gossip.pending)) for a, b in zip(T.leaves(ca), T.leaves(cb))]
    bits = sum(mismatches(torch, a, b) for a, b in queue)
    diff2 = sum(float(((sk.params[n] - sp.params[n]).double() ** 2).sum()) for n in before)
    upd2 = sum(float(((sp.params[n] - before[n]).double() ** 2).sum()) for n in before)
    stats_err = max(float((a - b).abs().max()) for a, b in zip(T.leaves(sk.model_state), T.leaves(sp.model_state)))
    rec = {"correction_bits_differing": bits, "consensus_error_kernels": ek, "consensus_error_plain": ep,
           "loss_kernels": lk, "loss_plain": lp, "update_rel_err": (diff2 / max(upd2, 1e-300)) ** 0.5,
           "update_rel_tol": RESNET_GRAD_REL_TOL, "batch_stats_max_abs_err": stats_err}
    if bits or ek != ep or not rec["update_rel_err"] <= RESNET_GRAD_REL_TOL:
        raise AssertionError(f"the overlap round through the BN kernels differs from the plain versions': {rec}")
    return rec


def train_resnet_overlap_phase(torch, dev, init, counted=3):
    """``train_resnet_overlap``: ``cifar_resnet50`` full (8 workers, ring)
    ``--norm-impl pallas --overlap-gossip --gossip-pipeline 2``: a warm
    round and ``counted`` rounds, every correction's queue summing to zero
    over the workers (:class:`CorrectionSums`), 53 x 8 launches of each BN
    kernel a round, and one round through the kernels against their plain
    versions (:func:`resnet_overlap_plain_check`)."""
    from consensusml_tpu_torch import configs, kernels
    from consensusml_tpu_torch.train.local_sgd import init_stacked_state, make_simulated_train_step
    from consensusml_tpu_torch.utils import tree as T

    bundle = configs.build("cifar_resnet50", "full", norm_impl="pallas", device=dev)
    configs.with_gossip_flags(bundle, overlap=True, pipeline=OVERLAP_DEPTH)
    cfg, world = bundle.cfg, bundle.world_size
    marks = [("start", time.perf_counter())]
    batches = list(bundle.batches(2 + counted, 0))
    params, model_state = bundle.convert(init)
    state = init_stacked_state(cfg, {n: t.to(dev) for n, t in params.items()}, world, seed=0,
                               model_state=T.tree_map(lambda t: t.to(dev), model_state))
    del params, model_state
    marks.append(("state_on_device", time.perf_counter()))
    step = make_simulated_train_step(cfg, bundle.loss_fn)
    images = world * cfg.h * batches[0]["image"].shape[2]
    sums = CorrectionSums(torch)
    try:
        state, warm, rounds, counts, peak = counted_rounds(torch, dev, step, state, batches[:1 + counted], images)
    finally:
        sums.close()
    marks.append(("rounds", time.perf_counter()))
    n_bn = sum(1 for n in state.model_state["batch_stats"] if n.endswith(".mean"))
    expect = {name: n_bn * world * cfg.h * counted if name in BN_KERNELS else 0 for name in kernels.KERNELS}
    if n_bn != RESNET50_BN_LAYERS or counts != expect:
        raise AssertionError(f"launches {counts} differ from the counts the code predicts {expect}")
    if len(sums.rounds) != 1 + counted or len(state.gossip.pending) != OVERLAP_DEPTH - 1:
        raise AssertionError(f"{len(sums.rounds)} corrections checked; queue {len(state.gossip.pending)}")
    plain = resnet_overlap_plain_check(torch, dev, cfg, state, batches[1 + counted])
    marks.append(("plain_check", time.perf_counter()))
    out = {
        "phase": "train_resnet_overlap",
        "config": "cifar_resnet50 full (ResNet-50, CIFAR stem), 8 workers, --norm-impl pallas --overlap-gossip "
                  f"--gossip-pipeline {OVERLAP_DEPTH}",
        "topology": bundle.cfg.gossip.topology.name, "pipeline_depth": OVERLAP_DEPTH,
        "setup_s": {name: t - marks[i][1] for i, (name, t) in enumerate(marks[1:])},
        "warmup_round": warm, "rounds": rounds, "round_ms_mean": sum(r["round_ms"] for r in rounds) / counted,
        "gossip_ms_mean": sum(r["gossip_ms"] for r in rounds) / counted,
        "imgs_per_s_per_chip_mean": sum(r["per_s_per_chip"] for r in rounds) / counted,
        "peak_memory_bytes": peak, "launches": counts, "launches_expected": expect,
        "gossip_ms_mean_without_sum_check": sum(r["gossip_ms"] for r in rounds) / counted - sum(
            c["check_ms"] for c in sums.rounds[1:]) / counted,
        "correction_sums": sums.rounds, "correction_sum_rtol": CORRECTION_SUM_RTOL,
        "kernels_vs_plain_round": plain,
    }
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    return out, counts


def topk_overlap_plain_check(torch, tck, dev, engine, state):
    """Two compressed overlap corrections of the first
    ``GPT2_CHECK_LEAVES`` leaves (from a zero queue and CHOCO state of
    their own, the second from the first's) through the codec kernels,
    then through their plain versions (the wrappers swapped for them, so
    nothing counts): the queue, ``xhat`` and ``s`` bit-equal."""
    from consensusml_tpu_torch.comm import simulated
    from consensusml_tpu_torch.utils import tree as T

    names = sorted(state.params)[:GPT2_CHECK_LEAVES]
    tree = {"params": {n: state.params[n] for n in names}, "model_state": {}}
    w = simulated.mixing_matrix(engine.topology, device=dev)
    world = w.shape[0]

    def two(tree):
        st = engine.init_state(tree, world_size=world)
        for _ in range(2):
            z = engine.apply_correction(tree, st)
            st = engine.correction_simulated(z, w, st)
        return st

    got = two(tree)
    swapped = {name: getattr(tck, name) for name in CODEC_KERNELS[None]}
    try:
        for name in swapped:
            setattr(tck, name, getattr(tck, f"{name}_plain"))
        want = two(tree)
    finally:
        for name, fn in swapped.items():
            setattr(tck, name, fn)
    torch.cuda.synchronize()

    def pairs(st):
        return T.leaves(st.correction) + T.leaves(list(st.pending)) + st.choco.xhat + st.choco.s

    bad = sum(mismatches(torch, a, b) for a, b in zip(pairs(got), pairs(want)))
    out = {"leaves": len(names), "elements_per_worker": sum(state.params[n][0].numel() for n in names),
           "corrections": 2, "buckets": len(got.choco.xhat), "bits_differing": bad}
    if bad:
        raise AssertionError(f"the overlap correction through the kernels differs from the plain versions': {out}")
    return out


def train_topk_overlap_phase(torch, tck, dev, init, counted=2):
    """``train_topk_overlap``: ``gpt2_topk`` full ``--workers 4
    --codec-warmup 0 --codec-refresh 0 --overlap-gossip --gossip-pipeline
    2`` (the config's top-k + int8 on the two-step wire, each correction
    one CHOCO exchange): a warm round and ``counted`` rounds, every
    correction's queue summing to zero (:class:`CorrectionSums`), the four
    codec kernels once a bucket a round and the flash kernels once a
    layer a worker step; then :func:`topk_overlap_plain_check`."""
    from consensusml_tpu_torch import configs, kernels
    from consensusml_tpu_torch.models.convert import gpt2_from_flax
    from consensusml_tpu_torch.train.local_sgd import init_stacked_state, make_simulated_train_step

    world = 4
    bundle = configs.build("gpt2_topk", "full", world=world, codec_warmup=0, device=dev)
    configs.with_gossip_flags(bundle, codec_refresh=0, overlap=True, pipeline=OVERLAP_DEPTH)
    cfg, mcfg = bundle.cfg, bundle.model.config
    engine = cfg.engine()
    if engine.fused_wire_active or not engine.bucketed:
        raise AssertionError("the config's codec must take the two-step bucketed wire")
    marks = [("start", time.perf_counter())]
    batches = list(bundle.batches(1 + counted, 0))
    state = init_stacked_state(cfg, {n: t.to(dev) for n, t in gpt2_from_flax(init).items()}, world, seed=0)
    marks.append(("state_on_device", time.perf_counter()))
    step = make_simulated_train_step(cfg, bundle.loss_fn)
    n_buckets = len(state.gossip.choco.xhat)
    ids = batches[0]["input_ids"]
    sums = CorrectionSums(torch)
    try:
        state, warm, rounds, counts, peak = counted_rounds(torch, dev, step, state, batches,
                                                           world * cfg.h * ids.shape[2] * ids.shape[3])
    finally:
        sums.close()
    marks.append(("rounds", time.perf_counter()))
    expect = dict.fromkeys(kernels.KERNELS, 0)
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        expect[name] = mcfg.layers * world * cfg.h * counted
    for name in CODEC_KERNELS[None]:
        expect[name] = n_buckets * counted
    if counts != expect or n_buckets != PLANS[None][0]:
        raise AssertionError(f"launches {counts} ({n_buckets} buckets) differ from the code's prediction {expect}")
    state.opt_state = None  # Adam's moments: the check does not read them
    gc.collect()
    torch.cuda.empty_cache()
    plain = topk_overlap_plain_check(torch, tck, dev, engine, state)
    out = {
        "phase": "train_topk_overlap",
        "config": "gpt2_topk full (GPT-2-medium), --workers 4 --codec-warmup 0 --codec-refresh 0 --overlap-gossip "
                  f"--gossip-pipeline {OVERLAP_DEPTH}",
        "codec_path": bundle.codec_path, "wire": "two-step", "workers": world, "h": cfg.h,
        "buckets": n_buckets, "pipeline_depth": OVERLAP_DEPTH,
        "setup_s": {name: t - marks[i][1] for i, (name, t) in enumerate(marks[1:])},
        "warmup_round": warm, "rounds": rounds, "round_ms_mean": sum(r["round_ms"] for r in rounds) / counted,
        "gossip_ms_mean": sum(r["gossip_ms"] for r in rounds) / counted,
        "tokens_per_s_per_chip_mean": sum(r["per_s_per_chip"] for r in rounds) / counted,
        "peak_memory_bytes": peak, "launches": counts, "launches_expected": expect,
        "gossip_ms_mean_without_sum_check": sum(r["gossip_ms"] for r in rounds) / counted - sum(
            c["check_ms"] for c in sums.rounds[1:]) / counted,
        "correction_sums": sums.rounds, "correction_sum_rtol": CORRECTION_SUM_RTOL,
        "kernels_vs_plain_corrections": plain,
    }
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    return out, counts


# host bytes a slice of the fused codec's bit comparison moves back to the card
FUSED_CHECK_SLICE = 1 << 26


def fused_codec_plain_check(torch, tck, dev, engine, state, w):
    """One fused-codec CHOCO round of the whole tree (every worker's one
    vector) through the codec kernels, its parameters, ``xhat`` and ``s``
    copied to host memory, then the same round through the kernels' plain
    versions (the wrappers swapped for them, so nothing counts), held to
    the host copy bit for bit in slices on the card: both rounds' outputs
    would not fit the card beside the state at once."""
    from consensusml_tpu_torch.utils import tree as T

    tree = {"params": state.params, "model_state": {}}

    def round_outputs():
        new, st = engine.round_simulated(tree, state.gossip, w, step=state.step)
        return T.leaves(new) + st.xhat + st.s

    host = [t.to("cpu") for t in round_outputs()]
    gc.collect()
    torch.cuda.empty_cache()
    swapped = {name: getattr(tck, name) for name in CODEC_KERNELS[None]}
    try:
        for name in swapped:
            setattr(tck, name, getattr(tck, f"{name}_plain"))
        want = round_outputs()
    finally:
        for name, fn in swapped.items():
            setattr(tck, name, fn)
    bad = 0
    for h, t in zip(host, want):
        hf, tf = h.reshape(-1), t.reshape(-1)
        for lo in range(0, tf.numel(), FUSED_CHECK_SLICE):
            bad += mismatches(torch, hf[lo: lo + FUSED_CHECK_SLICE].to(dev), tf[lo: lo + FUSED_CHECK_SLICE])
    out = {"round": state.step, "elements_per_worker": int(state.gossip.xhat[0].shape[1]), "bits_differing": bad,
           "tensors": len(want)}
    del want, host
    if bad:
        raise AssertionError(f"the fused-codec round through the kernels differs from the plain versions': {out}")
    return out


def fused_codec_kernel_times(torch, tck, vec, k: int, chunk: int) -> dict:
    """The top-k codec's four kernels at the fused codec's shapes (every
    worker's whole vector in one call; ``vec`` is ``(W, n)``), timed by
    CUDA events, with the bounds of :func:`check_codec`; their plain
    versions are held to them at the bucket plan's shapes there."""
    world = vec.shape[0]
    rows = vec.numel() // chunk
    x = vec.reshape(rows, chunk)
    v, i = tck.chunked_topk(x, k)
    vals = v.reshape(world, -1)
    vrows = -(-vals.shape[1] // chunk)
    vals = torch.nn.functional.pad(vals, (0, vrows * chunk - vals.shape[1])).reshape(-1, chunk)
    q, sc = tck.quantize_int8(vals)
    r, n = vals.shape[0], vals.numel()
    cases = {
        "chunked_topk": (lambda _: tck.chunked_topk(x, k), rows * chunk * 4 + rows * k * 8, k * rows * chunk, rows),
        "chunk_scatter": (lambda _: tck.chunk_scatter(v, i, chunk), rows * chunk * 4 + rows * k * 8, 2 * rows * k,
                          rows),
        "quantize_int8": (lambda _: tck.quantize_int8(vals), 4 * n + n + 4 * r, 3 * n, r),
        "dequantize_int8": (lambda _: tck.dequantize_int8(q, sc), n + 4 * r + 4 * n, n, r),
    }
    out = {}
    for name, (fn, nbytes, flops, nrows) in cases.items():
        bms, by = bound_ms(nbytes, flops, F32_FLOPS)
        ms = cuda_ms(torch, fn, 5)
        out[name] = {"rows": nrows, "chunk": chunk, "k": k, "ms": ms, "bound_ms": bms, "bound_by": by,
                     "x_bound": ms / bms}
    return out


def train_fused_codec_phase(torch, tck, dev, init, counted=2):
    """``train_fused_codec``: ``gpt2_topk`` full ``--workers 4
    --codec-warmup 1`` on the config's top-k + int8 with ``fused_codec=True``
    (``dataclasses.replace`` on the bundle's ``GossipConfig``: the codec
    runs once over each worker's whole tree laid end to end, ~355 M f32
    elements): a warm (dense) round and ``counted`` CHOCO rounds, each
    launching the four codec kernels once (one call over the stacked
    vectors) and the flash kernels once a layer a worker step; the peak
    memory; then :func:`fused_codec_plain_check`."""
    import dataclasses as dc

    from consensusml_tpu_torch import configs, kernels
    from consensusml_tpu_torch.comm import simulated
    from consensusml_tpu_torch.models.convert import gpt2_from_flax
    from consensusml_tpu_torch.train.local_sgd import init_stacked_state, make_simulated_train_step

    world = 4
    bundle = configs.build("gpt2_topk", "full", world=world, codec_warmup=1, device=dev)
    bundle.cfg = dc.replace(bundle.cfg, gossip=dc.replace(bundle.cfg.gossip, fused_codec=True))
    cfg, mcfg = bundle.cfg, bundle.model.config
    engine = cfg.engine()
    if engine.bucketed or engine.fused_wire_active:
        raise AssertionError("fused_codec must take neither the bucketed nor the fused wire")
    marks = [("start", time.perf_counter())]
    batches = list(bundle.batches(1 + counted, 0))
    state = init_stacked_state(cfg, {n: t.to(dev) for n, t in gpt2_from_flax(init).items()}, world, seed=0)
    marks.append(("state_on_device", time.perf_counter()))
    step = make_simulated_train_step(cfg, bundle.loss_fn)
    n = sum(p[0].numel() for p in state.params.values())
    per_worker = {"params": {k: p[0] for k, p in state.params.items()}, "model_state": {}}
    wire = engine.wire_bytes_per_round(per_worker)
    del per_worker
    if tuple(state.gossip.xhat[0].shape) != (world, n) or len(state.gossip.xhat) != 1:
        raise AssertionError(f"fused-codec state {tuple(state.gossip.xhat[0].shape)}, expected ({world}, {n})")
    ids = batches[0]["input_ids"]
    state, warm, rounds, counts, peak = counted_rounds(torch, dev, step, state, batches,
                                                       world * cfg.h * ids.shape[2] * ids.shape[3])
    marks.append(("rounds", time.perf_counter()))
    expect = dict.fromkeys(kernels.KERNELS, 0)
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        expect[name] = mcfg.layers * world * cfg.h * counted
    for name in CODEC_KERNELS[None]:
        expect[name] = counted  # one call over the stacked vectors a round
    if counts != expect:
        raise AssertionError(f"launches {counts} differ from the counts the code predicts {expect}")
    state.opt_state = None
    gc.collect()
    torch.cuda.empty_cache()
    inner = cfg.gossip.compressor.inner
    times = fused_codec_kernel_times(torch, tck, state.gossip.xhat[0], inner.k_per_chunk, inner.chunk)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    plain = fused_codec_plain_check(torch, tck, dev, engine, state, simulated.mixing_matrix(engine.topology,
                                                                                           device=dev))
    plain["peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev)
    marks.append(("plain_check", time.perf_counter()))
    out = {
        "phase": "train_fused_codec",
        "config": "gpt2_topk full (GPT-2-medium), --workers 4 --codec-warmup 1, GossipConfig.fused_codec=True",
        "codec_path": bundle.codec_path, "wire": "fused codec (one payload a worker over the whole tree)",
        "workers": world, "h": cfg.h, "elements_per_worker": n,
        "codec_rows_per_call": world * -(-n // inner.chunk),
        "wire_bytes_per_round": wire, "bucketed_wire_bytes_per_round": PLANS[None][1],
        "setup_s": {name: t - marks[i][1] for i, (name, t) in enumerate(marks[1:])},
        "warmup_round": warm, "rounds": rounds, "round_ms_mean": sum(r["round_ms"] for r in rounds) / counted,
        "gossip_ms_mean": sum(r["gossip_ms"] for r in rounds) / counted,
        "tokens_per_s_per_chip_mean": sum(r["per_s_per_chip"] for r in rounds) / counted,
        "peak_memory_bytes": peak, "launches": counts, "launches_expected": expect,
        "kernel_times": times, "kernels_vs_plain_round": plain,
    }
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    return out, counts


# ---------------------------------------------------------------------------
# runs that last: LR schedules and clipping, SlowMo, checkpoint and resume
# ---------------------------------------------------------------------------

# train_resnet_resume's flags: --lr-schedule cosine --warmup-rounds 1
# --grad-clip 1.0 --slowmo-beta 0.2, over RESUME_ROUNDS rounds; the resumed
# leg saves after RESUME_SAVE_AT of them
RESUME_FLAGS = {"lr_schedule": "cosine", "warmup_rounds": 1, "grad_clip": 1.0, "slowmo_beta": 0.2}
RESUME_ROUNDS, RESUME_SAVE_AT = 4, 2
RESUME_EVAL_BATCHES, RESUME_EVAL_EVERY = 2, 2
# train_topk_sched's: --lr-schedule linear --warmup-rounds 1 --grad-clip 1.0
TOPK_SCHED_FLAGS = {"lr_schedule": "linear", "warmup_rounds": 1, "grad_clip": 1.0}


def copy_tree(torch, obj):
    """A deep copy of a train state or any part of it: tensors cloned,
    generators' states copied, dataclasses, NamedTuples, dicts and
    sequences rebuilt."""
    import dataclasses as dc

    if isinstance(obj, torch.Tensor):
        return obj.clone()
    if isinstance(obj, torch.Generator):
        gen = torch.Generator(device=obj.device)
        gen.set_state(obj.get_state())
        return gen
    if dc.is_dataclass(obj) and not isinstance(obj, type):
        return dc.replace(obj, **{f.name: copy_tree(torch, getattr(obj, f.name)) for f in dc.fields(obj) if f.init})
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*[copy_tree(torch, x) for x in obj])
    if isinstance(obj, dict):
        return {k: copy_tree(torch, v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(copy_tree(torch, x) for x in obj)
    return obj


def worker_slice(torch, obj, w: int):
    """A one-worker copy of a stacked optimizer state: every tensor's row
    ``w`` as a stack of one."""
    import dataclasses as dc

    if isinstance(obj, torch.Tensor):
        return obj[w: w + 1].clone()
    if dc.is_dataclass(obj) and not isinstance(obj, type):
        return dc.replace(obj, **{f.name: worker_slice(torch, getattr(obj, f.name), w) for f in dc.fields(obj)})
    if isinstance(obj, dict):
        return {k: worker_slice(torch, v, w) for k, v in obj.items()}
    return obj


def states_differ(torch, a, b) -> dict:
    """Every tensor of two train states compared bit for bit (the frozen
    base aside: it is none here), with their rounds and the dropout
    generators' states."""
    from consensusml_tpu_torch.utils import tree as T

    ta, tb = T.named_tensors(a), T.named_tensors(b)
    if [p for p, _ in ta] != [p for p, _ in tb]:
        raise AssertionError("the two states have different structures")
    bits = {p: mismatches(torch, x, y) for (p, x), (_, y) in zip(ta, tb)}
    gens = sum(not torch.equal(x.get_state(), y.get_state()) for x, y in zip(a.generators, b.generators))
    return {"tensors": len(ta), "elements": sum(int(x.numel()) for _, x in ta),
            "elements_differing": sum(bits.values()), "tensors_differing": sorted(p for p, n in bits.items() if n),
            "generators_differing": gens, "rounds": [a.step, b.step]}


def sched_round(torch, step, state, batch, spec, optimizer):
    """One round and its record: loss, consensus error, times, the
    learning rate of its last step, the largest pre-clip norm over the
    workers, how many workers' last step the clip scaled, and the smallest
    clip factor ``min(1, clip / norm)``."""
    from consensusml_tpu_torch.train.run import train_extras

    t0 = time.perf_counter()
    state, m = step(state, batch)
    loss, err = float(m["loss"]), float(m["consensus_error"])
    ms = 1e3 * (time.perf_counter() - t0)
    ex = train_extras(spec, optimizer, state.opt_state)
    return state, {"step": state.step - 1, "loss": loss, "consensus_error": err, "round_ms": ms,
                   "inner_ms": m["inner_ms"], "gossip_ms": m["gossip_ms"], "lr": ex["lr"],
                   "grad_norm_max": ex["grad_norm"], "workers_clipped": ex["clipped"],
                   "clip_factor_min": min(1.0, spec["grad_clip"] / ex["grad_norm"])}


def add_counts(total: dict, counts: dict) -> dict:
    return {k: total.get(k, 0) + counts.get(k, 0) for k in set(total) | set(counts)}


def resnet_clipped_plain_check(torch, dev, cfg, state, batch):
    """One round of the clipped, scheduled SGD with SlowMo from a copy of
    ``state`` through the fused-BN kernels and through their plain versions
    (``norm_impl="jnp"``, the same leaves): the round's update to the
    parameters within ``RESNET_GRAD_REL_TOL`` (``||u_k - u_p|| /
    ||u_p||``, as ``train_resnet_overlap``'s check), each side's pre-clip
    norms and which workers the clip scaled."""
    from consensusml_tpu_torch import configs
    from consensusml_tpu_torch.train.local_sgd import make_simulated_train_step
    from consensusml_tpu_torch.train.optim import clip_norms

    clip = RESUME_FLAGS["grad_clip"]
    out = {}
    for impl in ("pallas", "jnp"):
        loss_fn = configs.build("cifar_resnet50", "full", norm_impl=impl, device=dev).loss_fn
        st, m = make_simulated_train_step(cfg, loss_fn)(copy_tree(torch, state), batch)
        norms = clip_norms(cfg.optimizer, st.opt_state).cpu().numpy()
        out[impl] = (st, float(m["loss"]), norms)
        del st
    (sk, lk, nk), (sp, lp, np_) = out["pallas"], out["jnp"]
    diff2 = sum(float(((sk.params[n] - sp.params[n]).double() ** 2).sum()) for n in state.params)
    upd2 = sum(float(((sp.params[n] - state.params[n]).double() ** 2).sum()) for n in state.params)
    rec = {"loss_kernels": lk, "loss_plain": lp, "grad_norms_kernels": nk.tolist(), "grad_norms_plain": np_.tolist(),
           "grad_norm_rel_err": float(np.max(np.abs(nk - np_) / np_)),
           "workers_clipped_kernels": int((nk >= clip).sum()), "workers_clipped_plain": int((np_ >= clip).sum()),
           "update_rel_err": (diff2 / max(upd2, 1e-300)) ** 0.5, "update_rel_tol": RESNET_GRAD_REL_TOL}
    if not rec["update_rel_err"] <= RESNET_GRAD_REL_TOL or not rec["workers_clipped_plain"]:
        raise AssertionError(f"the clipped round through the BN kernels differs from the plain versions' "
                             f"(or clipped nothing): {rec}")
    return rec


def train_resnet_resume_phase(torch, dev, init):
    """``train_resnet_resume``: ``cifar_resnet50`` full (8 workers, ring,
    the fused-BN kernels) ``--lr-schedule cosine --warmup-rounds 1
    --grad-clip 1.0 --slowmo-beta 0.2 --eval-batches 2 --eval-every 2``:
    four rounds straight, then from the same start two rounds, a save
    through ``AsyncSaver``, a restore into a freshly built state and two
    more. Gates: the two final states equal to the bit (every tensor, the
    generators, the round), the rounds' losses, errors, learning rates and
    norms and the evals equal, the clip fired, 53 x 8 launches of each BN
    kernel a round, and one clipped round through the kernels against their
    plain versions. cuDNN is held to its deterministic algorithms for the
    phase (the comparison is of two runs' bits). Returns the line, the
    launches, the checkpoint's directory (removed by the caller) and the
    straight run's final parameters and statistics as numpy."""
    import tempfile

    from consensusml_tpu_torch import configs, kernels
    from consensusml_tpu_torch.comm.check import to_numpy
    from consensusml_tpu_torch.train.evaluate import evaluate
    from consensusml_tpu_torch.train.local_sgd import init_stacked_state, make_simulated_train_step
    from consensusml_tpu_torch.train.run import due
    from consensusml_tpu_torch.utils import tree as T
    from consensusml_tpu_torch.utils.checkpoint import AsyncSaver, restore_state

    bundle = configs.build("cifar_resnet50", "full", norm_impl="pallas", device=dev)
    configs.with_train_flags(bundle, **RESUME_FLAGS, rounds=RESUME_ROUNDS)
    cfg, world = bundle.cfg, bundle.world_size
    batches = list(bundle.batches(RESUME_ROUNDS, 0))

    def fresh():
        params, model_state = bundle.convert(init)  # may share init's memory: copied
        return init_stacked_state(cfg, {n: t.to(dev, copy=True) for n, t in params.items()}, world, seed=0,
                                  model_state=T.tree_map(lambda t: t.to(dev, copy=True), model_state))

    def run_eval(state):
        got = evaluate(bundle.eval_fn, state, bundle.eval_batches(RESUME_EVAL_BATCHES, 0))
        return {"mean_model": {k: float(v) for k, v in got["mean_model"].items()},
                "worker_mean": got["worker_mean"]}

    step = make_simulated_train_step(cfg, bundle.loss_fn)
    counts: dict = {}

    def counted(state, batch):
        kernels.reset_launch_counts()
        state, rec = sched_round(torch, step, state, batch, RESUME_FLAGS, cfg.optimizer)
        nonlocal counts
        counts = add_counts(counts, kernels.launch_counts())
        return state, rec

    cudnn = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    tmp = tempfile.mkdtemp(prefix="cml-resume-")
    try:
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        a, straight, evals_a = fresh(), [], {}
        for r in range(RESUME_ROUNDS):
            a, rec = counted(a, batches[r])
            straight.append(rec)
            if due(RESUME_EVAL_EVERY, r) and r + 1 != RESUME_ROUNDS:
                evals_a[r] = run_eval(a)
        evals_a[None] = run_eval(a)
        straight_s = time.perf_counter() - t0
        b, resumed, evals_b = fresh(), [], {}
        for r in range(RESUME_SAVE_AT):
            b, rec = counted(b, batches[r])
            resumed.append(rec)
            if due(RESUME_EVAL_EVERY, r):
                evals_b[r] = run_eval(b)
        plain = resnet_clipped_plain_check(torch, dev, cfg, b, batches[RESUME_SAVE_AT])
        saver = AsyncSaver()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        saver.submit(tmp, b, step=RESUME_SAVE_AT)
        t1 = time.perf_counter()
        saver.wait()  # raises if the write failed
        t2 = time.perf_counter()
        ckpt = saver.last_path
        del b
        gc.collect()
        torch.cuda.empty_cache()
        c = fresh()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        c = restore_state(ckpt, c)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        for r in range(RESUME_SAVE_AT, RESUME_ROUNDS):
            c, rec = counted(c, batches[r])
            resumed.append(rec)
        evals_b[None] = run_eval(c)
        peak = torch.cuda.max_memory_allocated(dev)
        diff = states_differ(torch, a, c)
        final = {"params": to_numpy(a.params), "model_state": to_numpy(a.model_state)}
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = cudnn
    keys = ("loss", "consensus_error", "lr", "grad_norm_max", "workers_clipped")
    rounds_differ = [r for r, (x, y) in enumerate(zip(straight, resumed)) if any(x[k] != y[k] for k in keys)]
    evals_differ = sorted(str(k) for k in evals_a if evals_a[k] != evals_b.get(k))
    n_bn = sum(1 for n in a.model_state["batch_stats"] if n.endswith(".mean"))
    legs = 2 * RESUME_ROUNDS
    expect = {name: n_bn * world * cfg.h * legs if name in BN_KERNELS else 0 for name in kernels.KERNELS}
    counts = {name: counts.get(name, 0) for name in kernels.KERNELS}
    del a, c
    gc.collect()
    torch.cuda.empty_cache()
    out = {
        "phase": "train_resnet_resume",
        "config": "cifar_resnet50 full (ResNet-50, CIFAR stem), 8 workers, --norm-impl pallas --lr-schedule cosine "
                  "--warmup-rounds 1 --grad-clip 1.0 --slowmo-beta 0.2 --eval-batches 2 --eval-every 2",
        "norm_path": bundle.norm_path, "cudnn_deterministic": True, "workers": world, "h": cfg.h,
        "rounds_straight": straight, "rounds_resumed": resumed, "straight_leg_s": straight_s,
        "evals_straight": {str(k): v for k, v in evals_a.items()}, "evals_resumed": {str(k): v for k, v in evals_b.items()},
        "checkpoint": {"round": RESUME_SAVE_AT, "files": len(os.listdir(ckpt)),
                       "bytes": sum(os.path.getsize(os.path.join(ckpt, f)) for f in os.listdir(ckpt)),
                       "submit_ms": 1e3 * (t1 - t0), "write_wait_ms": 1e3 * (t2 - t1), "save_ms": 1e3 * (t2 - t0),
                       "restore_ms": 1e3 * (t4 - t3)},
        "final_states": diff, "rounds_differing": rounds_differ, "evals_differing": evals_differ,
        "clip_fired_rounds": [r["step"] for r in straight if r["workers_clipped"]],
        "peak_memory_bytes": peak, "launches": counts, "launches_expected": expect,
        "kernels_vs_plain_clipped_round": plain,
    }
    problems = []
    if diff["elements_differing"] or diff["generators_differing"] or diff["rounds"] != [RESUME_ROUNDS] * 2:
        problems.append(f"the resumed state differs from the straight one: {diff}")
    if rounds_differ or evals_differ:
        problems.append(f"rounds {rounds_differ} or evals {evals_differ} differ between the legs")
    if not out["clip_fired_rounds"]:
        problems.append("the clip fired in no round")
    if n_bn != RESNET50_BN_LAYERS or counts != expect:
        problems.append(f"launches {counts} differ from the counts the code predicts {expect}")
    for r in straight + resumed:
        if not (np.isfinite(r["loss"]) and np.isfinite(r["consensus_error"])):
            problems.append(f"round {r['step']}: loss or consensus error not finite: {r}")
    if problems:
        shutil.rmtree(tmp, ignore_errors=True)
        raise AssertionError("train_resnet_resume: " + "; ".join(problems))
    return out, counts, tmp, ckpt, final


def collective_resume_spec(ckpt: str) -> dict:
    """``train_resnet_collective_resume``'s flags: ``train_resnet_resume``'s
    on the collective backend, resuming its round-2 checkpoint for the
    remaining rounds, the final parameters returned."""
    spec = collective_spec("cifar_resnet50", "full", 8, RESUME_ROUNDS - RESUME_SAVE_AT, norm_impl="pallas")
    # no seeded check round: train_resnet_collective's, in the same spawn, holds that round
    return {**spec, **RESUME_FLAGS, "resume": ckpt, "sched_start": RESUME_SAVE_AT, "return_params": True,
            "check": None}


def collective_resume_compare(torch, results, final, ckpt: str) -> dict:
    """The ranks' final parameters and statistics against the simulated
    continuation's (``train_resnet_resume``'s straight run), each rank its
    row. Gate: for the parameters and for the statistics apart, the two
    resumed rounds' update from the checkpoint, ``u = final - saved``,
    within ``COLLECTIVE_RTOL`` (``||u_c - u_s|| / ||u_s||`` over the part),
    so that a wrong worker's statistics cannot hide under the parameters'
    larger update. The element-wise reading against ``COLLECTIVE_ATOL +
    COLLECTIVE_RTOL * |simulated|`` is reported by part: the BN running
    means, which sit near 0, drift past an element's ``COLLECTIVE_ATOL``.
    The ranks' bits are the same with cuDNN held to its deterministic
    algorithms, so that drift is not cuDNN's (PERF.md, PR 19)."""
    from consensusml_tpu_torch.utils import tree as T

    n, diff2, upd2, worst, leaf_worst = {}, {}, {}, {}, {}
    for rank, res in enumerate(results):
        saved = torch.load(os.path.join(ckpt, f"worker_{rank:05d}.pt"), map_location="cpu", weights_only=True)
        saved = dict(zip(saved["paths"], saved["tensors"]))
        for part in ("params", "model_state"):
            for (path, g), (_, w) in zip(T.flatten_with_paths(res[part]), T.flatten_with_paths(final[part])):
                name = part + "." + ".".join(map(str, path))
                w = w[rank]
                over = float((np.abs(g - w) / (COLLECTIVE_ATOL + COLLECTIVE_RTOL * np.abs(w))).max())
                worst[part] = max(worst.get(part, 0.0), over)
                leaf_worst[name] = max(leaf_worst.get(name, 0.0), over)
                diff2[part] = diff2.get(part, 0.0) + float(((g.astype(np.float64) - w) ** 2).sum())
                upd2[part] = upd2.get(part, 0.0) + float(((w.astype(np.float64) - saved[name].numpy()) ** 2).sum())
                n[part] = n.get(part, 0) + g.size
    rel = {part: (diff2[part] / max(upd2[part], 1e-300)) ** 0.5 for part in diff2}
    rec = {"elements_by_part": n, "update_rel_err_by_part": rel, "update_rel_tol": COLLECTIVE_RTOL,
           "elementwise_worst_over_tol_by_part": worst,
           "elementwise_worst_leaves": sorted(leaf_worst.items(), key=lambda kv: -kv[1])[:3],
           "elementwise_rtol": COLLECTIVE_RTOL, "elementwise_atol": COLLECTIVE_ATOL}
    if sorted(rel) != ["model_state", "params"] or not all(r <= COLLECTIVE_RTOL for r in rel.values()):
        raise AssertionError(f"the collective continuation differs from the simulated one: {rec}")
    return rec


def clipped_adam_check(torch, dev, bundle, state, batch):
    """One clipped Adam update of worker 0 (its parameters, moments and
    step count, its first micro-batch, dropout from a generator seeded 11)
    through the flash kernels (``attn_impl="cuda"``) and through their
    plain versions (``"torch"``), the update within ``GRAD_REL_TOL`` of the
    plain one (``||u_k - u_p|| / ||u_p||``): with the run's clip
    (``--grad-clip 1.0``; whether it fires is reported), and with a clip at
    half the plain side's norm, where both sides take the clipped branch.
    The schedule's count is set back to the warmup's end, where the rate
    is the peak: at the run's end the linear schedule is 0 and every
    update would be 0."""
    import dataclasses as dc

    from consensusml_tpu_torch.models.gpt2 import gpt2_loss_fn
    from consensusml_tpu_torch.train.optim import clip_norms

    row = {k: v[0, 0].to(dev) for k, v in batch.items()}
    grads, losses = {}, {}
    for impl in ("cuda", "torch"):
        leaves = {n: p[0].detach().requires_grad_(True) for n, p in state.params.items()}
        gen = torch.Generator(device=dev).manual_seed(11)
        loss, _ = gpt2_loss_fn(bundle.model, attn_impl=impl)(leaves, {}, row, gen)
        grads[impl] = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        losses[impl] = float(loss.detach())
        del leaves, loss

    peak_count = TOPK_SCHED_FLAGS["warmup_rounds"] * bundle.cfg.h

    def update(opt, impl):
        params = {n: p[0:1].clone() for n, p in state.params.items()}
        st = worker_slice(torch, state.opt_state, 0)
        st.inner.sched_count.fill_(peak_count)  # ClipState(inner=AdamState)
        opt.update_({n: p[0] for n, p in params.items()}, grads[impl], st, 0)
        return float(clip_norms(opt, st)[0]), {n: params[n][0] - state.params[n][0] for n in params}

    opt = bundle.cfg.optimizer
    out = {"loss_kernels": losses["cuda"], "loss_plain": losses["torch"], "lr": opt.lr(peak_count)}
    for label in ("run_clip", "half_norm_clip"):
        nk, uk = update(opt, "cuda")
        np_, up = update(opt, "torch")
        diff2 = sum(float(((uk[n] - up[n]).double() ** 2).sum()) for n in up)
        ref2 = sum(float((up[n].double() ** 2).sum()) for n in up)
        del uk, up
        out[label] = {"max_norm": opt.max_norm, "grad_norm_kernels": nk, "grad_norm_plain": np_,
                      "clip_factor_kernels": min(1.0, opt.max_norm / nk),
                      "clip_factor_plain": min(1.0, opt.max_norm / np_),
                      "update_rel_err": (diff2 / max(ref2, 1e-300)) ** 0.5, "update_rel_tol": GRAD_REL_TOL}
        if not out[label]["update_rel_err"] <= GRAD_REL_TOL:
            raise AssertionError(f"the clipped Adam update through the kernels differs from the plain versions': {out}")
        opt = dc.replace(opt, max_norm=0.5 * np_)
    if not max(out["half_norm_clip"]["clip_factor_kernels"], out["half_norm_clip"]["clip_factor_plain"]) < 1.0:
        raise AssertionError(f"the half-norm clip did not fire: {out}")
    del grads
    torch.cuda.empty_cache()
    return out


def train_topk_sched_phase(torch, dev, init, counted=2):
    """``train_topk_sched``: ``gpt2_topk`` full ``--workers 4 --codec-warmup
    1 --lr-schedule linear --warmup-rounds 1 --grad-clip 1.0`` on the
    config's top-k + int8 two-step wire: a warm round (the warmup's steps,
    dense gossip), ``counted`` rounds with their learning rates, pre-clip
    norms and clip factors (launches gated: the flash kernels once a layer
    a worker step, each codec kernel as ``train_topk``), then one clipped
    Adam update through the kernels against their plain versions
    (:func:`clipped_adam_check`). No checkpoint is written: the state is
    about 28.5 GB."""
    from consensusml_tpu_torch import configs, kernels
    from consensusml_tpu_torch.models.convert import gpt2_from_flax
    from consensusml_tpu_torch.train.local_sgd import init_stacked_state, make_simulated_train_step

    world = 4
    bundle = configs.build("gpt2_topk", "full", world=world, codec_warmup=1, device=dev)
    configs.with_train_flags(bundle, **TOPK_SCHED_FLAGS, rounds=1 + counted)
    cfg, mcfg = bundle.cfg, bundle.model.config
    batches = list(bundle.batches(1 + counted, 0))
    state = init_stacked_state(cfg, {n: t.to(dev) for n, t in gpt2_from_flax(init).items()}, world, seed=0)
    step = make_simulated_train_step(cfg, bundle.loss_fn)
    n_buckets = len(state.gossip.xhat)
    state, warm = sched_round(torch, step, state, batches[0], TOPK_SCHED_FLAGS, cfg.optimizer)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    rounds = []
    for batch in batches[1:]:
        state, rec = sched_round(torch, step, state, batch, TOPK_SCHED_FLAGS, cfg.optimizer)
        rec["tokens_per_s_per_chip"] = world * cfg.h * batch["input_ids"].shape[2] * batch["input_ids"].shape[3] / (
            rec["round_ms"] / 1e3)
        rounds.append(rec)
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    expect = dict.fromkeys(kernels.KERNELS, 0)
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        expect[name] = mcfg.layers * world * cfg.h * counted
    for name in CODEC_KERNELS[None]:
        expect[name] = n_buckets * counted
    check = clipped_adam_check(torch, dev, bundle, state, batches[-1])
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    problems = []
    if counts != expect or n_buckets != PLANS[None][0]:
        problems.append(f"launches {counts} ({n_buckets} buckets) differ from the counts the code predicts {expect}")
    for r in [warm] + rounds:
        if not (np.isfinite(r["loss"]) and np.isfinite(r["consensus_error"]) and np.isfinite(r["grad_norm_max"])):
            problems.append(f"round {r['step']}: not finite: {r}")
    if problems:
        raise AssertionError("train_topk_sched: " + "; ".join(problems))
    return {
        "phase": "train_topk_sched",
        "config": "gpt2_topk full (GPT-2-medium), --workers 4 --codec-warmup 1 --lr-schedule linear "
                  "--warmup-rounds 1 --grad-clip 1.0",
        "codec_path": bundle.codec_path, "workers": world, "h": cfg.h, "buckets": n_buckets,
        "schedule": {"total_steps": (1 + counted) * cfg.h, "warmup_steps": cfg.h},
        "warmup_round": warm, "rounds": rounds, "round_ms_mean": sum(r["round_ms"] for r in rounds) / counted,
        "peak_memory_bytes": peak, "launches": counts, "launches_expected": expect,
        "kernels_vs_plain_clipped_update": check,
    }, counts


# ---------------------------------------------------------------------------
# the collective backend: one process per worker, all on the one card,
# gloo ranks whose wire is staged through pinned host memory
# ---------------------------------------------------------------------------

# collective against simulated, one gossip round from the same seeded
# per-worker inputs: |collective - simulated| <= ATOL + RTOL * |simulated|
# (the reference's own cross-backend tolerance, tests/test_fused_wire.py),
# for exact mixing ATOL + RTOL * (|W| @ |x|): the simulated round sums W @ x
# as a matrix product, the collective one as a chain of multiply-adds
COLLECTIVE_RTOL, COLLECTIVE_ATOL = 1e-5, 1e-6
COLLECTIVE_CHECK_SEED = 7
# GPT-2's check round covers the first 36 leaves of the gossiped tree in
# flatten order (three transformer blocks): the full tree would send the
# parent 4.3 GB a rank (parameters, xhat and s as f32) through host memory
GPT2_CHECK_LEAVES = 36
COLLECTIVE_TIMEOUT_S = 540.0


def collective_spec(config, scale, world, rounds, codec=None, norm_impl="flax", check_leaves=None, device="cuda",
                    topology=None, push_sum=False, drop_prob=0.0, check_alive=None, overlap=False):
    """The train CLI's flags (``--backend collective --dist-backend gloo``)
    as :func:`consensusml_tpu_torch.train.collective.train_rank` reads
    them, plus the seeded gossip check after the rounds (under the mask
    ``check_alive`` when given). ``overlap``: ``--overlap-gossip`` with
    ``--codec-warmup 0 --codec-refresh 0`` (what compressed overlap
    needs)."""
    warm = (0 if overlap else 1) if config == "gpt2_topk" else None
    return {"config": config, "scale": scale, "workers": world, "codec": codec, "gamma": None,
            "codec_warmup": warm, "norm_impl": norm_impl, "topology": topology,
            "push_sum": push_sum, "drop_prob": drop_prob, "overlap_gossip": overlap,
            "codec_refresh": 0 if overlap and config == "gpt2_topk" else None,
            "seed": 0, "device": device, "dist_backend": "gloo", "rounds": rounds, "log_every": 0,
            "check": {"seed": COLLECTIVE_CHECK_SEED, "step": 1,
                      "leaves": check_leaves, "alive": check_alive}}


def flag_bytes(engine, step: int) -> int:
    """The fault flags a rank sends in a round beside the payload (none
    without faults): 4 bytes a shift of the round's phase, twice for
    push-sum (its in- and out-neighbours'), or the alive count beside a
    dense graph's all-reduce."""
    if engine.config.faults is None:
        return 0
    topo = engine.topology
    phase = topo.phases[step % topo.period] if topo.is_time_varying else topo
    if phase.uses_psum:
        return 4
    return 4 * len(phase.shifts) * (2 if engine.config.push_sum_enabled else 1)


def collective_launches_expected(bundle, buckets):
    """Each kernel's launches a rank a round, as the code predicts: flash
    forward, dq and dk/dv once a layer a local step (GPT-2); the three BN
    kernels once a BN layer a local step (ResNet, fused BN); the fused
    wire's encode and three-source decode once a bucket; the two-step
    wire's top-k, quantize, own dequantize and scatter once a bucket, plus
    a dequantize and an accumulating scatter a bucket a shift."""
    from consensusml_tpu_torch.models.fused_bn import FusedBatchNorm

    cfg = bundle.cfg
    engine = cfg.engine()
    shifts = len(engine.topology.shifts)
    out, forms = {}, {}
    if bundle.name == "gpt2_topk":
        for name in ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
            out[name] = bundle.model.config.layers * cfg.h
    else:
        n_bn = sum(1 for m in bundle.model.modules() if isinstance(m, FusedBatchNorm))
        for name in BN_KERNELS:
            out[name] = n_bn * cfg.h
    if engine.compressed and engine.fused_wire_active:
        out["fused_choco_encode"] = out["fused_dequantize_accumulate"] = buckets
    elif engine.compressed:
        out["chunked_topk"] = out["quantize_int8"] = buckets
        out["dequantize_int8"] = out["chunk_scatter"] = buckets * (1 + shifts)
        forms = {"chunk_scatter": {"acc": buckets * shifts}}
    return out, forms


def collective_check(torch, dev, bundle, results, spec_check):
    """Gate 2: the ranks' seeded gossip round against the simulated round
    on the same stacked inputs (and mask), computed here after the ranks
    exited."""
    from consensusml_tpu_torch.comm import simulated
    from consensusml_tpu_torch.comm.check import seeded_state, seeded_tree
    from consensusml_tpu_torch.consensus import ChocoState, PushSumState
    from consensusml_tpu_torch.utils import tree as T

    engine = bundle.cfg.engine()
    world = len(results)
    leaves = [(tuple(p), tuple(sh)) for p, sh in results[0]["check"]["leaves"]]
    alive = spec_check.get("alive")
    rows, states = [], []
    for r in range(world):
        tree, gen = seeded_tree(leaves, COLLECTIVE_CHECK_SEED, r, dev)
        rows.append(tree)
        states.append(seeded_state(engine, tree, gen))
    stacked = T.tree_map(lambda *xs: torch.stack(xs), *rows)
    if engine.config.overlap:
        return overlap_collective_check(torch, dev, engine, results, spec_check, leaves, stacked, states)
    if states[0] is None:
        state = None
    elif isinstance(states[0], PushSumState):
        state = PushSumState(w=torch.stack([st.w for st in states]))
    else:
        state = ChocoState(xhat=[torch.stack(xs) for xs in zip(*[st.xhat for st in states])],
                           s=[torch.stack(xs) for xs in zip(*[st.s for st in states])])
    x_abs = T.tree_map(torch.abs, stacked)
    topo = engine.topology
    step = spec_check["step"]
    w = (simulated.phase_matrices(topo, device=dev)[step % topo.period] if topo.is_time_varying
         else simulated.mixing_matrix(topo, device=dev))
    del rows, states
    mask = None if alive is None else torch.tensor(alive, dtype=torch.float32, device=dev)
    want, want_state = engine.round_simulated(stacked, state, w, step=step, alive=mask)
    bound = None
    if not engine.compressed:
        # the scale of what a row sums: |W'| @ |x| with the round's own
        # operator (masked, or push-sum's on x w, de-biased)
        if engine.config.push_sum_enabled:
            from consensusml_tpu_torch.consensus import pushsum_matrix

            c = pushsum_matrix(w, mask).abs()
            wi = state.w.reshape(-1)
            bound = T.tree_map(lambda a: simulated.mix_stacked(a * wi.reshape((-1,) + (1,) * (a.dim() - 1)), c)
                               / want_state.w.reshape((-1,) + (1,) * (a.dim() - 1)), x_abs)
        else:
            from consensusml_tpu_torch.consensus import masked_mixing_matrix

            wm = w if mask is None else masked_mixing_matrix(w, mask)
            bound = T.tree_map(lambda a: simulated.mix_stacked(a, wm.abs()), x_abs)
    del stacked, state, x_abs
    worst, xhat_mismatches = 0.0, 0

    def held(g, wnt, b):
        nonlocal worst
        g = g.to(dev)
        tol = COLLECTIVE_ATOL + COLLECTIVE_RTOL * (b if b is not None else wnt.abs())
        worst = max(worst, float(((g - wnt).abs() / tol).max()))

    mine = T.tree_map(lambda *xs: torch.stack(xs), *[T.tree_map(torch.from_numpy, r["check"]["tree"])
                                                      for r in results])
    for (path, g), (_p, wnt) in zip(T.flatten_with_paths(mine), T.flatten_with_paths(want)):
        b = None if bound is None else dict(T.flatten_with_paths(bound))[path]
        held(g, wnt, b)
    n_buckets = None
    if isinstance(want_state, PushSumState):
        g = torch.stack([torch.as_tensor(r["check"]["state"]["w"]) for r in results]).reshape(-1)
        held(g, want_state.w, None)
    elif want_state is not None:
        n_buckets = len(want_state.xhat)
        for b in range(n_buckets):
            xh = torch.stack([torch.from_numpy(r["check"]["state"]["xhat"][b]) for r in results]).to(dev)
            xhat_mismatches += int((xh.view(torch.int32) != want_state.xhat[b].view(torch.int32)).sum())
            held(torch.stack([torch.from_numpy(r["check"]["state"]["s"][b]) for r in results]), want_state.s[b], None)
    out = {"leaves": len(leaves), "elements_per_worker": sum(int(np.prod(s)) for _p, s in leaves),
           "buckets": n_buckets, "max_err_over_tolerance": worst, "xhat_bits_differing": xhat_mismatches,
           "rtol": COLLECTIVE_RTOL, "atol": COLLECTIVE_ATOL,
           "tolerance_scale": "|W| @ |x|" if bound is not None else "|simulated|",
           "launches": results[0]["check"]["launches"], "forms": results[0]["check"]["forms"],
           "bytes_sent_per_rank": [r["check"]["transport"]["bytes_sent"] for r in results],
           "wire_bytes_per_round": results[0]["check"]["wire_bytes_per_round"],
           "alive": alive, "flag_bytes": flag_bytes(engine, step) if alive is not None else 0}
    if worst > 1.0 or xhat_mismatches:
        raise AssertionError(f"collective round differs from the simulated one: {out}")
    if any(b != out["wire_bytes_per_round"] + out["flag_bytes"] for b in out["bytes_sent_per_rank"]):
        raise AssertionError(f"the check round's transport bytes differ from wire_bytes_per_round: {out}")
    return out


def overlap_collective_check(torch, dev, engine, results, spec_check, leaves, stacked, states):
    """:func:`collective_check` for overlap gossip: the ranks' seeded round
    (the seeded correction applied, the next one computed through the
    in-flight exchange) against ``apply_correction`` and
    ``correction_simulated`` on the same stacked inputs: ``z`` and the
    queue within ``COLLECTIVE_RTOL``, ``xhat`` bit-equal, ``s`` within
    ``COLLECTIVE_RTOL``; the transport's bytes ``wire_bytes_per_round``."""
    from consensusml_tpu_torch.comm import simulated
    from consensusml_tpu_torch.consensus import ChocoState, OverlapState
    from consensusml_tpu_torch.utils import tree as T

    stack = lambda *xs: torch.stack(xs)  # noqa: E731
    choco = None
    if states[0].choco is not None:
        choco = ChocoState(xhat=[stack(*xs) for xs in zip(*[st.choco.xhat for st in states])],
                           s=[stack(*xs) for xs in zip(*[st.choco.s for st in states])])
    state = OverlapState(correction=T.tree_map(stack, *[st.correction for st in states]), choco=choco,
                         pending=tuple(T.tree_map(stack, *ps) for ps in zip(*[st.pending for st in states])))
    del states
    topo = engine.topology
    step = spec_check["step"]
    w = (simulated.phase_matrices(topo, device=dev)[step % topo.period] if topo.is_time_varying
         else simulated.mixing_matrix(topo, device=dev))
    z = engine.apply_correction(stacked, state)
    want = engine.correction_simulated(z, w, state)
    worst, xhat_bits = 0.0, 0

    def held(g, wnt):
        nonlocal worst
        g = torch.as_tensor(g).to(dev)
        worst = max(worst, float(((g - wnt).abs() / (COLLECTIVE_ATOL + COLLECTIVE_RTOL * wnt.abs())).max()))

    mine = lambda get: T.tree_map(lambda *xs: np.stack(xs), *[get(r["check"]) for r in results])  # noqa: E731
    for g, wnt in zip(T.leaves(mine(lambda c: c["tree"])), T.leaves(z)):
        held(g, wnt)
    got_state = mine(lambda c: c["state"])
    for g, wnt in zip(T.leaves(got_state["correction"]) + T.leaves(list(got_state["pending"])),
                      T.leaves(want.correction) + T.leaves(list(want.pending))):
        held(g, wnt)
    if want.choco is not None:
        for g, wnt in zip(got_state["choco"]["xhat"], want.choco.xhat):
            xhat_bits += mismatches(torch, torch.from_numpy(g).to(dev), wnt)
        for g, wnt in zip(got_state["choco"]["s"], want.choco.s):
            held(g, wnt)
    out = {"leaves": len(leaves), "elements_per_worker": sum(int(np.prod(s)) for _p, s in leaves),
           "buckets": None if want.choco is None else len(want.choco.xhat), "max_err_over_tolerance": worst,
           "xhat_bits_differing": xhat_bits, "rtol": COLLECTIVE_RTOL, "atol": COLLECTIVE_ATOL,
           "tolerance_scale": "|simulated|", "compared": "z, the correction queue, xhat and s",
           "launches": results[0]["check"]["launches"], "forms": results[0]["check"]["forms"],
           "bytes_sent_per_rank": [r["check"]["transport"]["bytes_sent"] for r in results],
           "wire_bytes_per_round": results[0]["check"]["wire_bytes_per_round"]}
    if worst > 1.0 or xhat_bits:
        raise AssertionError(f"collective overlap round differs from the simulated one: {out}")
    if any(b != out["wire_bytes_per_round"] for b in out["bytes_sent_per_rank"]):
        raise AssertionError(f"the check round's transport bytes differ from wire_bytes_per_round: {out}")
    return out


def collective_line(torch, dev, phase, spec, results, flags, expect_wire=None):
    """One collective phase's line from its ranks' results, with gates 1-5
    (every rank returned, which ``launch`` already enforces; the seeded
    round against the simulated one; launches; transport bytes; sound
    training values)."""
    from consensusml_tpu_torch.train.collective import spec_bundle

    bundle = spec_bundle(spec, dev)
    engine = bundle.cfg.engine()
    world = len(results)
    buckets = results[0]["buckets"]
    counted = list(range(1, spec["rounds"]))  # round 0 warms (and, for GPT-2, is the codec's warm-up)
    expect, forms = collective_launches_expected(bundle, buckets)
    wire = results[0]["wire_bytes_per_round"]
    problems = []
    if expect_wire is not None and wire != expect_wire:
        problems.append(f"wire_bytes_per_round {wire} != {expect_wire}")
    for r, res in enumerate(results):
        for i in counted:
            rd = res["rounds"][i]
            if rd["launches"] != expect or {k: v for k, v in rd["forms"].items() if any(v.values())} != forms:
                problems.append(f"rank {r} round {i}: launches {rd['launches']} {rd['forms']} != {expect} {forms}")
            if rd["wire_bytes"] != wire + flag_bytes(engine, i):
                problems.append(f"rank {r} round {i}: the transport sent {rd['wire_bytes']} bytes, not {wire} "
                                f"and {flag_bytes(engine, i)} of flags")
    for i in range(spec["rounds"]):
        losses = {res["rounds"][i]["loss"] for res in results}
        errs = {res["rounds"][i]["consensus_error"] for res in results}
        if len(losses) != 1 or len(errs) != 1:
            problems.append(f"round {i}: the ranks disagree on the all-reduced loss {losses} or error {errs}")
        loss, err = losses.pop(), errs.pop()
        if not (np.isfinite(loss) and np.isfinite(err)) or (engine.compressed and not err > 0):
            problems.append(f"round {i}: loss {loss} or consensus error {err} not finite (and non-zero)")
    if problems:
        raise AssertionError(f"{phase}: " + "; ".join(problems))
    check = collective_check(torch, dev, bundle, results, spec["check"]) if spec["check"] else None
    keys = ("round_ms", "inner_ms", "gossip_ms", "metrics_ms", "staging_ms", "wire_ms")
    if engine.config.overlap:
        # the correction's issue before the local steps and the wait left after them
        keys += ("gossip_issue_ms", "gossip_wait_ms")
    per_round = {key: [[res["rounds"][i][key] for i in counted] for res in results] for key in keys + ("bytes_staged",)}
    med = lambda key: float(np.median(per_round[key]))  # noqa: E731
    # the kernels line's launches: what every rank counted in the counted rounds
    launches: dict = {}
    by_form: dict = {}
    for res in results:
        for i in counted:
            rd = res["rounds"][i]
            for k, v in rd["launches"].items():
                launches[k] = launches.get(k, 0) + v
            for k, f in rd["forms"].items():
                for form, n in f.items():
                    if n:
                        by_form.setdefault(k, {})
                        by_form[k][form] = by_form[k].get(form, 0) + n
    return {
        "phase": phase, "config": flags, "ranks": world, "transport": "gloo, staged through pinned host memory",
        "device_of_every_rank": str(dev), "buckets": buckets, "wire_bytes_per_round": wire,
        "rounds": [{"step": i, "loss": results[0]["rounds"][i]["loss"],
                    "consensus_error": results[0]["rounds"][i]["consensus_error"],
                    **{k: results[0]["rounds"][i][k] for k in ("alive_frac", "alive_mask")
                       if k in results[0]["rounds"][i]},
                    "wire_bytes_per_rank": [res["rounds"][i]["wire_bytes"] for res in results],
                    **{key: [res["rounds"][i][key] for res in results] for key in keys + ("bytes_staged",)}}
                   for i in range(spec["rounds"])],
        "counted_rounds": counted,
        # a rank's seconds from its spec's start: the state built (and restored), and
        # the rounds done (before the check round)
        "rank_setup_s_max": max(res["setup_s"] for res in results),
        "rank_seconds_max": max(res["seconds"] for res in results),
        # inner: the local steps (the ranks take turns on the card); gossip:
        # the round (its staging and gloo waits inside it); metrics: the
        # consensus error's and the loss's all-reduces
        "median_ms": {key: med(key) for key in keys},
        "median_bytes_staged": med("bytes_staged"),
        "launches_per_rank_per_round": expect, "forms_per_rank_per_round": forms,
        "peak_allocated_bytes_per_rank": [res.get("peak_allocated_bytes") for res in results],
        "device_used_bytes": max(res.get("device_used_bytes") or 0 for res in results),
        "collective_vs_simulated": check,
    }, launches, by_form


def collective_phases(torch, dev, resume):
    """``train_resnet_collective``, ``train_resnet_collective_pushsum`` and
    ``train_resnet_collective_resume`` (one spawn of 8 ranks for the three;
    ``resume`` is ``train_resnet_resume``'s round-2 checkpoint and its
    straight run's final parameters and statistics) then
    ``train_collective`` and ``train_collective_topk`` (one spawn of 4
    ranks for both): each rank its own process and worker on the one card.
    Returns the lines and the launches by phase."""
    from consensusml_tpu_torch.comm.launch import launch
    from consensusml_tpu_torch.train import collective

    out = []
    runs = (
        ("cifar_resnet50", 8, [("train_resnet_collective",
                                collective_spec("cifar_resnet50", "full", 8, 3, norm_impl="pallas"),
                                "cifar_resnet50 full --norm-impl pallas --backend collective --dist-backend gloo",
                                None),
                               # push-sum under drawn faults on the directed one-peer graph;
                               # its check round masks workers 2 and 5 (step 1: phase 1)
                               ("train_resnet_collective_pushsum",
                                collective_spec("cifar_resnet50", "full", 8, 2, norm_impl="pallas",
                                                topology="onepeer-exp", push_sum=True, drop_prob=FAULT_DROP_PROB,
                                                check_alive=[0.0 if i in FAULT_DEAD else 1.0 for i in range(8)]),
                                "cifar_resnet50 full --norm-impl pallas --topology onepeer-exp --push-sum "
                                "--drop-prob 0.1 --backend collective --dist-backend gloo",
                                None),
                               # train_resnet_resume's round-2 checkpoint, its last two rounds on this backend
                               ("train_resnet_collective_resume", collective_resume_spec(resume[0]),
                                "cifar_resnet50 full --norm-impl pallas --lr-schedule cosine --warmup-rounds 1 "
                                "--grad-clip 1.0 --slowmo-beta 0.2 --resume step_2 --rounds 2 --backend collective "
                                "--dist-backend gloo",
                                None)]),
        ("gpt2_topk", 4, [
            ("train_collective", collective_spec("gpt2_topk", "full", 4, 2, codec="int8",
                                                 check_leaves=GPT2_CHECK_LEAVES),
             "gpt2_topk full --workers 4 --codec int8 --codec-warmup 1 --backend collective --dist-backend gloo",
             715_190_448),
            ("train_collective_topk", collective_spec("gpt2_topk", "full", 4, 2, check_leaves=GPT2_CHECK_LEAVES),
             "gpt2_topk full --workers 4 --codec-warmup 1 --backend collective --dist-backend gloo",
             33_366_424),
            # the fused int8 wire's correction in flight under the local steps
            ("train_collective_overlap", collective_spec("gpt2_topk", "full", 4, 2, codec="int8",
                                                         check_leaves=GPT2_CHECK_LEAVES, overlap=True),
             "gpt2_topk full --workers 4 --codec int8 --codec-warmup 0 --codec-refresh 0 --overlap-gossip "
             "--backend collective --dist-backend gloo",
             715_190_448),
        ]),
    )
    for _config, world, phases in runs:
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        per_rank = launch(collective.train_runs, world, [spec for _n, spec, _f, _w in phases],
                          dist_backend="gloo", timeout=COLLECTIVE_TIMEOUT_S)
        spawn_s = time.perf_counter() - t0
        lines = {}
        for i, (name, spec, flags, expect_wire) in enumerate(phases):
            line, launches, forms = collective_line(torch, dev, name, spec, [r[i] for r in per_rank], flags,
                                                    expect_wire)
            line["spawn_to_exit_s"] = spawn_s
            if name == "train_resnet_collective_resume":
                results = [r[i] for r in per_rank]
                line["lr"] = [rd["lr"] for rd in results[0]["rounds"]]
                line["grad_norm_per_rank"] = [[res["rounds"][j]["grad_norm"] for res in results]
                                              for j in range(spec["rounds"])]
                line["vs_simulated_continuation"] = collective_resume_compare(torch, results, resume[1], resume[0])
                for res in results:
                    res.pop("params"), res.pop("model_state")
            lines[name] = line
            out.append((line, launches, forms))
        if "train_collective_overlap" in lines:
            # the exposed wait beside the same wire's whole gossip round, same spawn
            lines["train_collective_overlap"]["train_collective_median_gossip_ms"] = (
                lines["train_collective"]["median_ms"]["gossip_ms"])
        del per_rank
        gc.collect()
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# bert_mlm, and the flash kernels' per-key padding mask (kv_mask)
# ---------------------------------------------------------------------------

# the ragged real lengths of the masked checks and of bert_long_padded: a
# full row, rows past a 512-key block and inside one, one of a single key
# and one of none (every row of that example attends to no key)
KV_MASK_LENGTHS = (1024, 1000, 777, 513, 512, 129, 1, 0)
# the gate-only masked check at S=600 (not a multiple of 512 or of 64)
KV_MASK_LENGTHS_600 = (600, 513, 100, 0)
# bert_mlm full's bucket plan (tests/test_torch_bert.py): BERT-base's
# 109,514,298 f32 parameters in 4 MiB buckets; a ring sends them twice
BERT_PARAMS, BERT_BUCKETS = 109_514_298, 75


def kv_mask_of(torch, dev, lengths, s):
    """(len(lengths), s) f32 key mask: 1 for the first ``lengths[b]`` keys."""
    return (torch.arange(s, device=dev)[None, :] < torch.tensor(lengths, device=dev)[:, None]).float()


def attended_pairs(torch, kv_mask, causal: bool) -> int:
    """(query, key) pairs a head attends to under ``kv_mask`` (and causal):
    the work this run's masks need (a row that attends to no key needs
    none but a sum of values, left out)."""
    m = (kv_mask > 0).to(torch.int64)
    if causal:
        return int(torch.cumsum(m, dim=1).sum())
    return int(m.sum() * kv_mask.shape[1])


def masked_gate(torch, tfa, q, k, v, do, kv_mask, causal: bool, name: str):
    """The three flash kernels' masked form on ``q, k, v, do`` against their
    plain versions at the flash gates: out and lse against
    ``flash_attention_plain``, dq, dk, dv (fed the kernel's forward)
    against ``flash_attention_bwd_plain`` (fed the plain forward); an
    example whose mask is all 0 must get no dq. Returns ``(fwd_errs,
    lse_err, bwd_errs, o, lse, delta, dq, dk, dv)``."""
    o, lse = tfa.flash_attention(q, k, v, causal=causal, kv_mask=kv_mask, return_lse=True)
    want_o, want_lse = tfa.flash_attention_plain(q, k, v, causal=causal, kv_mask=kv_mask, return_lse=True)
    torch.cuda.synchronize()
    fwd_errs = tol_check(name, o, want_o, FLASH_ATOL, FLASH_RTOL)
    lse_err = (lse - want_lse).abs().max().item()
    if not lse_err <= LSE_TOL or not torch.isfinite(o.float()).all():
        raise AssertionError(f"{name}: lse err {lse_err} > {LSE_TOL}, or out not finite")
    delta = tfa._delta(o, do)
    dq = tfa.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal=causal, kv_mask=kv_mask)
    dk, dv = tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal=causal, kv_mask=kv_mask)
    want = tfa.flash_attention_bwd_plain(q, k, v, want_o, do, want_lse, causal=causal, kv_mask=kv_mask)
    torch.cuda.synchronize()
    bwd_errs = {n: tol_check(f"{name} {n}", g, w, FLASH_BWD_ATOL, FLASH_BWD_RTOL)
                for n, g, w in (("dq", dq, want[0]), ("dk", dk, want[1]), ("dv", dv, want[2]))}
    empty = ~(kv_mask > 0).any(dim=1)
    if want[0][empty].any() or dq[empty].any():
        raise AssertionError(f"{name}: an example that attends to no key got a dq")
    return fwd_errs, lse_err, bwd_errs, o, lse, delta, dq, dk, dv


def check_flash_kv_mask(torch, tfa, dev, b=8, s=1024, h=12, d=64):
    """The masked form of the three flash kernels at BERT-base's heads (B=8,
    S=1024, H=12, D=64) with the ragged ``KV_MASK_LENGTHS``, non-causal (the
    encoder's) and causal, held to their plain versions by
    :func:`masked_gate`; first, gate only, at S=600 (B=4,
    ``KV_MASK_LENGTHS_600``), where a row that attends to no key has a
    visited count that tells the reference's 512-key blocks from the
    kernels' 64-key tiles. Times by :func:`queued_ms`; the bounds count this run's
    attended pairs (:func:`attended_pairs`) and bytes (q, k, v, do, the
    mask and the row statistics read once, the outputs written once); the
    library yardstick is SDPA with the mask as a (B, 1, 1, T) boolean
    (causal: combined with the diagonal into (B, 1, S, T)), forward, and
    forward + backward minus forward, timed and never called by the
    port."""
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(14)
    out, gate600 = {}, {}
    # gate only, at S=600: there the reference's visited count for a row
    # that attends to no key (two 512-key blocks, 1024) differs from the
    # kernels' own 64-key tiles (640), which S=1024 cannot tell apart
    short_mask = kv_mask_of(torch, dev, KV_MASK_LENGTHS_600, 600)
    for causal in (False, True):
        q, k, v, do = (torch.randn(len(KV_MASK_LENGTHS_600), 600, h, d, generator=gen, device=dev,
                                   dtype=torch.bfloat16) for _ in range(4))
        fwd_errs, lse_err, bwd_errs, *_ = masked_gate(torch, tfa, q, k, v, do, short_mask, causal,
                                                      f"flash kv_mask S=600 causal={causal}")
        gate600[f"causal={causal}"] = {"lengths": list(KV_MASK_LENGTHS_600), "fwd": fwd_errs,
                                       "lse_max_abs_err": lse_err, **bwd_errs}
        del q, k, v, do
    kv_mask = kv_mask_of(torch, dev, KV_MASK_LENGTHS, s)
    for causal in (False, True):
        q, k, v, do = (torch.randn(b, s, h, d, generator=gen, device=dev, dtype=torch.bfloat16) for _ in range(4))
        fwd_errs, lse_err, bwd_errs, o, lse, delta, dq, dk, dv = masked_gate(
            torch, tfa, q, k, v, do, kv_mask, causal, f"flash kv_mask causal={causal}")
        pairs = h * attended_pairs(torch, kv_mask, causal)
        elems, rows = b * s * h * d, b * h * s
        mask_bytes = b * s * 4
        fwd_bound = bound_ms(4 * elems * 2 + rows * 4 + mask_bytes, 4 * d * pairs)
        dq_bound = bound_ms(5 * elems * 2 + 2 * rows * 4 + mask_bytes, 6 * d * pairs)
        dkv_bound = bound_ms(6 * elems * 2 + 2 * rows * 4 + mask_bytes, 8 * d * pairs)
        fwd_ms, fwd_enq = queued_ms(torch, lambda i: tfa.flash_attention(q, k, v, causal=causal, kv_mask=kv_mask,
                                                                         return_lse=True), 20)
        dq_ms, dq_enq = queued_ms(torch, lambda i: tfa.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal=causal,
                                                                              kv_mask=kv_mask), 20)
        dkv_ms, dkv_enq = queued_ms(torch, lambda i: tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                                                 causal=causal, kv_mask=kv_mask), 20)
        plain_fwd_ms = cuda_ms(torch, lambda i: tfa.flash_attention_plain(q, k, v, causal=causal, kv_mask=kv_mask), 5)
        plain_bwd_ms = cuda_ms(torch, lambda i: tfa.flash_attention_bwd_plain(q, k, v, o, do, lse, causal=causal,
                                                                              kv_mask=kv_mask), 5)
        lib_mask = (kv_mask > 0)[:, None, None, :]
        if causal:
            lib_mask = lib_mask & torch.ones(s, s, dtype=torch.bool, device=dev).tril()[None, None]
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        dot = do.transpose(1, 2)

        def sdpa_fwd_bwd(i):
            y = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=lib_mask)
            torch.autograd.grad(y, (qt, kt, vt), dot)

        with torch.no_grad():
            lib_fwd, _ = queued_ms(torch, lambda i: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=lib_mask), 20)
        lib_bwd = queued_ms(torch, sdpa_fwd_bwd, 20)[0] - lib_fwd
        out[f"causal={causal}"] = {
            "lengths": list(KV_MASK_LENGTHS), "attended_pairs": pairs,
            "fwd": {**fwd_errs, "lse_max_abs_err": lse_err, "ms": fwd_ms, "enqueue_ms": fwd_enq,
                    "plain_ms": plain_fwd_ms, "library_ms": lib_fwd, "bound_ms": fwd_bound[0],
                    "bound_by": fwd_bound[1], **rates(fwd_ms, 4 * d * pairs, lib_fwd, fwd_bound[0])},
            "dq": {**bwd_errs["dq"], "ms": dq_ms, "enqueue_ms": dq_enq, "plain_ms": plain_bwd_ms,
                   "library_ms": lib_bwd, "bound_ms": dq_bound[0], "bound_by": dq_bound[1],
                   **rates(dq_ms, 6 * d * pairs, lib_bwd, dq_bound[0])},
            "dkv": {**bwd_errs["dk"], "dv_max_abs_err": bwd_errs["dv"]["max_abs_err"],
                    "max_abs_err": max(bwd_errs["dk"]["max_abs_err"], bwd_errs["dv"]["max_abs_err"]),
                    "ms": dkv_ms, "enqueue_ms": dkv_enq, "plain_ms": plain_bwd_ms, "library_ms": lib_bwd,
                    "bound_ms": dkv_bound[0], "bound_by": dkv_bound[1],
                    **rates(dkv_ms, 8 * d * pairs, lib_bwd, dkv_bound[0]),
                    "bwd_ms": dq_ms + dkv_ms, "bwd_x_library": (dq_ms + dkv_ms) / lib_bwd},
        }
        del q, k, v, do, o, lse, delta, dq, dk, dv, qt, kt, vt
        torch.cuda.empty_cache()
    return out, gate600


def check_flash_d128(torch, tfa, dev, b=None, s=2048, h=32, d=128):
    """The three flash kernels' head-dim-128 form at ``llama_lora``'s
    attention shape (B = its micro-batch, S = 2048, H = 32, D = 128,
    causal, no mask), held against their plain versions at the head-dim-64
    gates (forward ``FLASH_ATOL``/``FLASH_RTOL`` and ``LSE_TOL``, backward
    ``FLASH_BWD_ATOL``/``FLASH_BWD_RTOL``; the backward kernels fed the
    plain forward's lse and delta), then timed by :func:`queued_ms` beside
    their plain versions (CUDA events) and SDPA (the library yardstick,
    never called by the port; its backward as forward + backward minus
    forward). Bounds by operations: 4 d a (query, key) pair for the
    forward, 6 d for dq (S, dP, dQ), 8 d for dk/dv (S^T, dP^T, dK, dV)."""
    import torch.nn.functional as F

    from consensusml_tpu_torch import configs

    b = configs.LLAMA_MICRO_BATCH if b is None else b
    gen = torch.Generator(device=dev).manual_seed(128)
    q, k, v, do = (torch.randn(b, s, h, d, generator=gen, device=dev, dtype=torch.bfloat16) for _ in range(4))
    before = {f: f.d128_launches for f in (tfa.flash_attention, tfa.flash_attention_bwd_dq, tfa.flash_attention_bwd_dkv)}
    o, lse = tfa.flash_attention(q, k, v, causal=True, return_lse=True)
    want_o, want_lse = tfa.flash_attention_plain(q, k, v, causal=True, return_lse=True)
    delta = tfa._delta(want_o, do)
    dq = tfa.flash_attention_bwd_dq(q, k, v, do, want_lse, delta, causal=True)
    dk, dv = tfa.flash_attention_bwd_dkv(q, k, v, do, want_lse, delta, causal=True)
    want = tfa._bwd_plain_parts(q, k, v, do, want_lse, delta, True)
    torch.cuda.synchronize()
    if any(f.d128_launches != n + 1 for f, n in before.items()):
        raise AssertionError("check.flash_d128: a kernel did not launch its head-dim-128 form once")
    shape = f"B={b} S={s} H={h} D={d}"
    fwd_err = tol_check(f"flash_attention {shape}", o, want_o, FLASH_ATOL, FLASH_RTOL)
    lse_err = (lse - want_lse).abs().max().item()
    if not lse_err <= LSE_TOL:
        raise AssertionError(f"flash_attention {shape}: lse err {lse_err} > {LSE_TOL}")
    errs = {name: tol_check(f"flash_attention_bwd {name} {shape}", g, w, FLASH_BWD_ATOL, FLASH_BWD_RTOL)
            for name, g, w in (("dq", dq, want[0]), ("dk", dk, want[1]), ("dv", dv, want[2]))}
    del want, want_o, dq, dk, dv
    pairs = b * h * s * (s + 1) // 2
    elems, rows = b * s * h * d, b * h * s
    bounds = {"fwd": bound_ms(4 * elems * 2 + rows * 4, 4 * d * pairs),  # q k v read, out lse written
              "dq": bound_ms(5 * elems * 2 + 2 * rows * 4, 6 * d * pairs),  # q k v do lse delta, dq
              "dkv": bound_ms(6 * elems * 2 + 2 * rows * 4, 8 * d * pairs)}  # ..., dk dv
    flops = {"fwd": 4 * d * pairs, "dq": 6 * d * pairs, "dkv": 8 * d * pairs}
    ms = {
        "fwd": queued_ms(torch, lambda i: tfa.flash_attention(q, k, v, causal=True, return_lse=True), 20)[0],
        "dq": queued_ms(torch, lambda i: tfa.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal=True), 20)[0],
        "dkv": queued_ms(torch, lambda i: tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal=True), 20)[0],
    }
    plain = {"fwd": cuda_ms(torch, lambda i: tfa.flash_attention_plain(q, k, v, causal=True), 3, warm=1),
             "bwd": cuda_ms(torch, lambda i: tfa._bwd_plain_parts(q, k, v, do, lse, delta, True), 3, warm=1)}
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    dot = do.transpose(1, 2)

    def sdpa_fwd_bwd(i):
        y = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        torch.autograd.grad(y, (qt, kt, vt), dot)

    with torch.no_grad():
        sdpa_fwd = queued_ms(torch, lambda i: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True), 20)[0]
    sdpa_bwd = queued_ms(torch, sdpa_fwd_bwd, 20)[0] - sdpa_fwd
    library = {"fwd": sdpa_fwd, "dq": sdpa_bwd, "dkv": sdpa_bwd}
    out = {}
    for key in ("fwd", "dq", "dkv"):
        err = fwd_err if key == "fwd" else (errs["dq"] if key == "dq" else
                                           max(errs["dk"], errs["dv"], key=lambda e: e["worst_err_over_tol"]))
        out[key] = {
            "shape": shape + " causal", **err, "ms": ms[key], "plain_ms": plain["fwd" if key == "fwd" else "bwd"],
            "bound_ms": bounds[key][0], "bound_by": bounds[key][1], "library_ms": library[key],
            "library": "SDPA forward" if key == "fwd" else "SDPA backward (forward + backward - forward)",
            **rates(ms[key], flops[key], library[key], bounds[key][0]),
        }
    out["fwd"].update({"lse_max_abs_err": lse_err, "lse_tol": LSE_TOL})
    out["bwd_ms"] = ms["dq"] + ms["dkv"]
    out["bwd_x_library"] = out["bwd_ms"] / sdpa_bwd
    out["dk_worst_err_over_tol"] = errs["dk"]["worst_err_over_tol"]
    out["dv_worst_err_over_tol"] = errs["dv"]["worst_err_over_tol"]
    return out


def bert_long_padded_phase(torch, dev):
    """``bert_base(max_len=1024)`` at full width (BERT-base, random
    numpy-seeded weights), one ``bert_mlm_loss_fn`` forward and backward on
    a batch of 8 x 1024 corrupted Markov tokens with the ragged
    ``KV_MASK_LENGTHS`` attention mask: S*T > 512^2, so every layer's
    attention takes the flash kernels in their masked form. Held against
    the same step on their plain versions (``attn_impl="torch"``), same
    weights, batch and dropout generator, at GPT-2's ``grad_check``
    tolerances. Gates: 12 launches of each flash kernel, all 12 masked, no
    other kernel; finite losses. ``step_ms_*``: host wall time of each
    step (forward and backward, synchronised), after one untimed warm-up
    step through the kernels."""
    from consensusml_tpu_torch import kernels
    from consensusml_tpu_torch.data import SyntheticLM, mlm_corrupt
    from consensusml_tpu_torch.models import flash_attention as tfa
    from consensusml_tpu_torch.models.bert import bert_base, bert_mlm_loss_fn
    from consensusml_tpu_torch.models.convert import normal_init_params

    model = bert_base(device="meta", max_len=1024)
    cfg = model.config
    params0 = {n: torch.from_numpy(a[0]).to(dev) for n, a in normal_init_params(model, 0, 1).items()}
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=1024)
    batch = mlm_corrupt(data.sample(np.random.default_rng((0, 14)), (8,)), data, 0, 14, 0.15)
    batch = {k: t.to(dev) for k, t in batch.items()}
    batch["attention_mask"] = kv_mask_of(torch, dev, KV_MASK_LENGTHS, 1024).to(torch.int32)
    runs = {}
    for impl in ("cuda", "cuda", "torch"):  # the first run warms up (cuBLAS, the allocator), untimed
        leaves = {n: p.detach().requires_grad_(True) for n, p in params0.items()}
        gen = torch.Generator(device=dev).manual_seed(11)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        loss, _ = bert_mlm_loss_fn(model, attn_impl=impl)(leaves, {}, batch, gen)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        torch.cuda.synchronize()
        runs[impl] = {"loss": float(loss.detach()), "grads": grads, "ms": 1e3 * (time.perf_counter() - t0),
                      "launches": kernels.launch_counts(), "forms": kernels.form_counts()}
        del leaves, loss
    gk, gp = runs["cuda"]["grads"], runs["torch"]["grads"]
    diff2 = sum(float(((a.float() - b.float()) ** 2).sum()) for a, b in zip(gk, gp))
    ref2 = sum(float((b.float() ** 2).sum()) for b in gp)
    worst, worst_name = max(
        (float((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30)), n)
        for n, a, b in zip(params0, gk, gp)
    )
    flash = ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv")
    counts = runs["cuda"]["launches"]
    expect = {name: cfg.layers if name in flash else 0 for name in kernels.KERNELS}
    masked = {name: runs["cuda"]["forms"][name]["masked"] for name in flash}
    out = {
        "phase": "bert_long_padded",
        "config": "bert_base(max_len=1024): BERT-base, 12 layers, hidden 768, 12 heads; batch 8 x 1024, "
                  "ragged attention_mask, dropout 0.1, flash kernels with kv_mask against their plain versions",
        "lengths": list(KV_MASK_LENGTHS), "loss_kernels": runs["cuda"]["loss"], "loss_plain": runs["torch"]["loss"],
        "grad_rel_err": (diff2 / ref2) ** 0.5, "grad_rel_tol": GRAD_REL_TOL, "worst_leaf": worst_name,
        "worst_leaf_rel_err": worst, "leaf_rel_tol": LEAF_REL_TOL,
        "step_ms_kernels": runs["cuda"]["ms"], "step_ms_plain": runs["torch"]["ms"],
        "launches": counts, "masked_launches": masked, "plain_path_launches": runs["torch"]["launches"],
    }
    if counts != expect or masked != {name: cfg.layers for name in flash} or any(runs["torch"]["launches"].values()):
        raise AssertionError(f"bert_long_padded: launches {counts} masked {masked} (expected {expect}, all masked)")
    if not (np.isfinite(out["loss_kernels"]) and np.isfinite(out["loss_plain"])
            and out["grad_rel_err"] <= GRAD_REL_TOL and worst <= LEAF_REL_TOL):
        raise AssertionError(f"bert_long_padded: the kernels' step disagrees with the plain versions': {out}")
    del runs, gk, gp, params0
    torch.cuda.empty_cache()
    return out, counts


def train_bert_phase(torch, dev, counted=2, eval_batches=8):
    """bert_mlm full (BERT-base, bf16 compute, 32 workers on a ring, 8 local
    Adam(1e-4) steps a round, exact bucketed gossip, batch 32 x 128) on
    the simulated backend: the initial parameters drawn and uploaded a
    worker at a time (``configs.init_on_device``), no warm round (a round
    reads the same without one, 28.8 s against 28.4 on an H100 at 700 W),
    ``counted`` rounds (launch counters zeroed just before, read just
    after), then ``eval_batches`` held-out MLM batches for the mean model
    and every worker. Gates: finite losses, finite non-zero consensus
    errors, the bucket plan and wire bytes of ``tests/test_torch_bert.py``
    (75 buckets; 2 sends of 4 bytes a parameter), the first counted
    round's gossip equal to ``W @ x`` (:class:`GossipCheck`), no port
    kernel launched (seq 128: dense attention, as the reference's)."""
    from consensusml_tpu_torch import configs, kernels
    from consensusml_tpu_torch.train.evaluate import evaluate
    from consensusml_tpu_torch.train.local_sgd import init_stacked_state, make_simulated_train_step

    bundle = configs.build("bert_mlm", "full", device=dev)
    cfg, world = bundle.cfg, bundle.world_size
    engine = cfg.engine()
    marks = [("start", time.perf_counter())]
    batches = list(bundle.batches(counted, 0))
    marks.append(("batches", time.perf_counter()))
    params, _ = configs.init_on_device(bundle, 0, dev)
    marks.append(("init_on_device", time.perf_counter()))
    state = init_stacked_state(cfg, params, world, seed=0)
    del params
    marks.append(("state", time.perf_counter()))
    step = make_simulated_train_step(cfg, bundle.loss_fn)
    per_worker = {"params": {n: p[0] for n, p in state.params.items()}, "model_state": {}}
    n_params = sum(p.numel() for p in per_worker["params"].values())
    n_buckets = engine.bucket_plan(per_worker).num_buckets
    wire = engine.wire_bytes_per_round(per_worker)
    del per_worker
    if (n_params, n_buckets, wire) != (BERT_PARAMS, BERT_BUCKETS, 2 * 4 * BERT_PARAMS):
        raise AssertionError(f"bert_mlm plan: {n_params} params, {n_buckets} buckets, {wire} wire bytes")
    ids = batches[0]["input_ids"]
    tokens = world * cfg.h * ids.shape[2] * ids.shape[3]
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    rounds, check = [], GossipCheck(torch, cfg.gossip.topology, dev)
    try:
        for i, batch in enumerate(batches):
            t0 = time.perf_counter()
            state, m = step(state, batch)
            loss, err = float(m["loss"]), float(m["consensus_error"])
            ms = 1e3 * (time.perf_counter() - t0)
            if i == 0:
                check.close()  # the first counted round's gossip is held to W @ x
            rounds.append({"step": state.step - 1, "loss": loss, "consensus_error": err, "round_ms": ms,
                           "inner_ms": m["inner_ms"], "gossip_ms": m["gossip_ms"],
                           "tokens_per_s_per_chip": tokens / (ms / 1e3)})
    finally:
        check.close()
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    marks.append(("rounds", time.perf_counter()))
    result = evaluate(bundle.eval_fn, state, bundle.eval_batches(eval_batches, 0))
    marks.append(("eval", time.perf_counter()))
    for r in rounds:
        if not (np.isfinite(r["loss"]) and np.isfinite(r["consensus_error"]) and r["consensus_error"] > 0):
            raise AssertionError(f"train_bert round {r['step']}: loss or consensus error not finite and positive")
    if check.rounds != [rounds[0]["step"]] or any(counts.values()):
        raise AssertionError(f"train_bert: gossip checked at {check.rounds}, launches {counts} (expected none)")
    mean_model, workers = result["mean_model"], result["worker_mean"]
    out = {
        "phase": "train_bert",
        "config": "bert_mlm full (BERT-base, bf16), 32 workers, ring, exact bucketed gossip, Adam 1e-4, h 8, "
                  "batch 32 x 128, mlm_rate 0.15",
        "workers": world, "h": cfg.h, "batch": ids.shape[2], "seq": ids.shape[3], "params_per_worker": n_params,
        "buckets": n_buckets, "wire_bytes_per_round": wire, "attention": "dense (S*T <= 512^2)",
        "setup_s": {name: t - marks[i][1] for i, (name, t) in enumerate(marks[1:])},
        "rounds": rounds,
        "round_ms_mean": sum(r["round_ms"] for r in rounds) / counted,
        "tokens_per_s_per_chip_mean": sum(r["tokens_per_s_per_chip"] for r in rounds) / counted,
        "gossip_rtol": GOSSIP_RTOL, "gossip_worst_err_over_tol": check.worst,
        "eval_batches": eval_batches,
        "eval_mean_model": {k: float(v) for k, v in mean_model.items()},
        "eval_worker_mean": {k: float(v) for k, v in workers.items()},
        "peak_memory_bytes": peak, "launches": counts,
    }
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    return out, counts


LLAMA_BASE_PARAMS, LLAMA_ADAPTER_PARAMS, LLAMA_BUCKETS = 6_738_415_616, 16_777_216, 16


def llama_round_flops(cfg, sequences: int, seq: int) -> float:
    """The least work of one ``llama_lora`` round: every Dense product of
    the forward and its input gradient (2 + 2 flops a kernel parameter a
    token; the embedding is a lookup), and causal attention's two forward
    and four backward products (4 d + 8 d a (query, key) pair a head a
    layer). The adapters' own products and the recomputation in the
    backward kernels are left out."""
    d = cfg.head_dim
    dense = cfg.layers * (cfg.hidden * (cfg.heads + 2 * cfg.kv_heads) * d + cfg.heads * d * cfg.hidden
                          + 3 * cfg.hidden * cfg.mlp_dim) + cfg.hidden * cfg.vocab_size
    pairs = seq * (seq + 1) // 2
    return sequences * (4.0 * dense * seq + cfg.layers * cfg.heads * 12.0 * d * pairs)


def train_llama_phase(torch, dev, counted=2, eval_batches=1):
    """llama_lora full (Llama-2-7B with rank-16 adapters on q, k, v and o,
    bf16 compute, 16 workers on a 4x4 torus, one Adam(1e-3) step on the
    adapters a round, exact gossip of the adapters only, batch 8 x 2048 in
    micro-batches of ``configs.LLAMA_MICRO_BATCH``) on the simulated
    backend, world 16 on one card: the base (6.7 B parameters) drawn and
    uploaded a leaf at a time and held ONCE in bf16, beside the stacked
    adapters (drawn a worker at a time). One worker step's adapter
    gradients through the kernels against the same step on their plain
    versions (``attn_impl="torch"``); no warm round (the gradient check
    has already run every kernel, and a warm round read as the counted
    ones, 28.2 s against 28.3-28.5 on an H100 at 700 W); ``counted`` rounds (launch counters zeroed just before, read just
    after); then
    ``eval_batches`` held-out batches for the mean model and every worker.
    Gates: the parameter counts, 16 buckets holding the adapters alone
    and 4 x 4 bytes an adapter parameter on the wire (the plan and the
    bytes of the whole tree, base included, through the LoRA filter), the
    gradients at GPT-2's and BERT's tolerances, every counted round's
    gossip equal to ``W @ x`` on the adapters, finite losses and consensus
    errors, and each flash kernel launched in its head-dim-128 form
    exactly 32 layers x 16 workers x 4 micro-batches a round, nothing else."""
    from consensusml_tpu_torch import configs, kernels
    from consensusml_tpu_torch.models.llama import llama_loss_fn
    from consensusml_tpu_torch.train.evaluate import evaluate
    from consensusml_tpu_torch.train.local_sgd import init_stacked_state, make_simulated_train_step, worker_grads

    bundle = configs.build("llama_lora", "full", device=dev)
    cfg, world, mcfg = bundle.cfg, bundle.world_size, bundle.model.config
    engine = cfg.engine()
    marks = [("start", time.perf_counter())]
    batches = list(bundle.batches(counted, 0))
    marks.append(("batches", time.perf_counter()))
    params, _ = configs.init_on_device(bundle, 0, dev)
    marks.append(("adapters", time.perf_counter()))
    frozen = configs.frozen_on_device(bundle, dev)
    marks.append(("base", time.perf_counter()))
    state = init_stacked_state(cfg, params, world, seed=0, frozen=frozen)
    del params
    base_bytes = sum(t.numel() * t.element_size() for t in frozen.values())
    # the plan and the wire of the whole per-worker tree: the LoRA filter
    # selects the adapters
    whole = {"params": {**frozen, **{n: p[0] for n, p in state.params.items()}}, "model_state": {}}
    plan = engine.bucket_plan(whole)
    wire = engine.wire_bytes_per_round(whole)
    del whole, frozen
    n_base = sum(t.numel() for t in state.frozen.values())
    n_adapters = sum(p[0].numel() for p in state.params.values())
    sends = engine._sends_per_round()
    if ((n_base, n_adapters, plan.num_buckets, sum(b.total for b in plan.buckets), wire)
            != (LLAMA_BASE_PARAMS, LLAMA_ADAPTER_PARAMS, LLAMA_BUCKETS, LLAMA_ADAPTER_PARAMS,
                4 * LLAMA_ADAPTER_PARAMS * sends)):
        raise AssertionError(f"llama_lora plan: base {n_base}, adapters {n_adapters}, {plan.num_buckets} buckets "
                             f"of {sum(b.total for b in plan.buckets)}, {wire} wire bytes")
    marks.append(("state", time.perf_counter()))

    # one worker step's adapter gradients, kernels against plain versions
    one = {k: v[0, 0].to(dev) for k, v in batches[0].items()}
    grads = {}
    for impl in ("cuda", "torch"):
        loss, g, _ = worker_grads(cfg, llama_loss_fn(bundle.model, attn_impl=impl), state, 0, one)
        grads[impl] = (float(loss), g)
        del loss, g
        torch.cuda.empty_cache()
    (lk, gk), (lp, gp) = grads["cuda"], grads["torch"]
    diff2 = sum(float(((gk[n].float() - gp[n].float()) ** 2).sum()) for n in gp)
    ref2 = sum(float((gp[n].float() ** 2).sum()) for n in gp)
    worst, worst_name = max((float((gk[n].float() - gp[n].float()).norm() / gp[n].float().norm().clamp_min(1e-30)), n)
                            for n in gp)
    grad_check = {"loss_kernels": lk, "loss_plain": lp, "grad_rel_err": (diff2 / ref2) ** 0.5,
                  "grad_rel_tol": GRAD_REL_TOL, "worst_leaf": worst_name, "worst_leaf_rel_err": worst,
                  "leaf_rel_tol": LEAF_REL_TOL, "leaves": len(gp)}
    del grads, gk, gp, one
    if grad_check["leaves"] != len(state.params) or not (
            grad_check["grad_rel_err"] <= GRAD_REL_TOL and worst <= LEAF_REL_TOL):
        raise AssertionError(f"llama_lora: gradients through the kernels disagree with the plain versions: {grad_check}")
    marks.append(("grad_check", time.perf_counter()))

    step = make_simulated_train_step(cfg, bundle.loss_fn)
    ids = batches[0]["input_ids"]
    tokens = world * cfg.h * ids.shape[2] * ids.shape[3]
    flops = llama_round_flops(mcfg, world * cfg.h * ids.shape[2], ids.shape[3])
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    rounds, check = [], GossipCheck(torch, cfg.gossip.topology, dev)
    try:
        for batch in batches:
            t0 = time.perf_counter()
            state, m = step(state, batch)
            loss, err = float(m["loss"]), float(m["consensus_error"])
            ms = 1e3 * (time.perf_counter() - t0)
            rounds.append({"step": state.step - 1, "loss": loss, "consensus_error": err, "round_ms": ms,
                           "inner_ms": m["inner_ms"], "gossip_ms": m["gossip_ms"],
                           "tokens_per_s_per_chip": tokens / (ms / 1e3)})
    finally:
        check.close()
    counts, forms = kernels.launch_counts(), kernels.form_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    marks.append(("rounds", time.perf_counter()))
    result = evaluate(bundle.eval_fn, state, bundle.eval_batches(eval_batches, 0))
    marks.append(("eval", time.perf_counter()))
    for r in rounds:
        if not (np.isfinite(r["loss"]) and np.isfinite(r["consensus_error"]) and r["consensus_error"] > 0):
            raise AssertionError(f"train_llama round {r['step']}: loss or consensus error not finite and positive")
    per_kernel = mcfg.layers * world * (ids.shape[2] // cfg.micro_batch) * counted
    flash = ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv")
    want = {name: (per_kernel if name in flash else 0) for name in counts}
    d128 = {name: forms[name]["d128"] for name in flash}
    if counts != want or d128 != {name: per_kernel for name in flash} or any(forms[n]["masked"] for n in flash):
        raise AssertionError(f"train_llama launches {counts}, head-dim-128 {d128}, expected {per_kernel} each flash")
    if check.rounds != [r["step"] for r in rounds]:
        raise AssertionError(f"train_llama: gossip checked at {check.rounds}")
    bound_s = flops / BF16_FLOPS
    out = {
        "phase": "train_llama",
        "config": "llama_lora full (Llama-2-7B: hidden 4096, 32 layers, 32 heads of dim 128, MLP 11008, vocab 32000, "
                  "bf16; LoRA rank 16 on q, k, v, o), 16 workers, 4x4 torus, exact gossip of the adapters only, "
                  "Adam 1e-3 on the adapters, h 1, batch 8 x 2048",
        "cut": "world 16 on one card without tp (the reference: tp 4 a worker, 64 chips); the base held once",
        "workers": world, "batch": ids.shape[2], "seq": ids.shape[3], "micro_batch": cfg.micro_batch,
        "base_params": n_base, "base_bytes_held_once": base_bytes, "adapter_params_per_worker": n_adapters,
        "buckets": plan.num_buckets, "wire_bytes_per_round": wire, "attention": "flash kernels, head dim 128",
        "grad_check": grad_check,
        "setup_s": {name: t - marks[i][1] for i, (name, t) in enumerate(marks[1:])},
        "rounds": rounds,
        "round_ms_mean": sum(r["round_ms"] for r in rounds) / counted,
        "tokens_per_s_per_chip_mean": sum(r["tokens_per_s_per_chip"] for r in rounds) / counted,
        "round_flops": flops, "round_bound_s_at_bf16_peak": bound_s,
        "x_bound": sum(r["round_ms"] for r in rounds) / counted / 1e3 / bound_s,
        "gossip_rtol": GOSSIP_RTOL, "gossip_checked_rounds": check.rounds, "gossip_worst_err_over_tol": check.worst,
        "eval_batches": eval_batches,
        "eval_mean_model": {k: float(v) for k, v in result["mean_model"].items()},
        "eval_worker_mean": {k: float(v) for k, v in result["worker_mean"].items()},
        "peak_memory_bytes": peak, "launches": counts, "d128_launches": d128,
    }
    # what serve_llama serves: the frozen base and the workers' mean adapters
    weights = {**state.frozen, **{n: p.mean(0) for n, p in state.params.items()}}
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    return out, counts, d128, weights


def socket_request(address, payload) -> dict:
    import socket

    with socket.create_connection(address, timeout=600) as s:
        s.sendall(json.dumps(payload).encode() + b"\n")
        data = b""
        while chunk := s.recv(65536):
            data += chunk
    last = json.loads(data.decode().strip().splitlines()[-1])
    if "error" in last:
        raise AssertionError(f"server error: {last['error']}")
    return last


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing to run", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from consensusml_tpu_torch import kernels
    from consensusml_tpu_torch.compress import kernels as tck
    from consensusml_tpu_torch.models import flash_attention as tfa
    from consensusml_tpu_torch.models import fused_bn as tbn
    from consensusml_tpu_torch.models import fused_ln as tln
    from consensusml_tpu_torch.models import paged_attention as tpa

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    # stated, not assumed: f32 products in full f32 (the gossip's W @ x)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind, "torch": torch.__version__,
          "cuda": torch.version.cuda, "count": torch.cuda.device_count()})

    t0 = time.perf_counter()
    built = kernels.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "kernels": built})

    paged = check_paged(torch, tpa, dev)
    flash = check_flash(torch, tfa, dev)
    bwd, flash_b8 = check_flash_bwd(torch, tfa, dev)
    fp8_totals = topk_bucket_totals(torch, dev, "fp8")
    largest_rows = 4 * max(fp8_totals) // 512
    enc = check_encode(torch, tck, dev, largest_rows)
    codec = check_codec(torch, tck, dev, topk_bucket_totals(torch, dev))
    int4 = check_int4(torch, tck, dev, topk_bucket_totals(torch, dev, "topk_int4"))
    fp8 = check_fp8(torch, tck, dev, fp8_totals)
    dec = check_decode(torch, tck, dev, largest_rows)
    bn = check_bn(torch, tbn, dev)
    ln = check_ln(torch, tln, dev)
    subnormals = check_subnormals(torch, tfa, tpa, tln, dev)
    kv_masked, kv_masked_600 = check_flash_kv_mask(torch, tfa, dev)
    d128 = check_flash_d128(torch, tfa, dev)
    paged_llama = check_paged_llama(torch, tpa, dev)
    emit({"phase": "check", "paged_attention": {f"W={w}": r for w, r in paged.items()},
          "paged_attention_llama": paged_llama,
          "flash_attention_fwd": {**{f"B=1 S={s}": r for s, r in flash.items()},
                                  **{f"B=8 S={s}": r for s, r in flash_b8.items()}},
          "flash_attention_bwd": {f"B=8 S={s}": r for s, r in bwd.items()},
          "fused_choco_encode": enc, "fused_dequantize_accumulate": dec, "topk_codec": codec,
          "int4_codec": int4, "fp8_codec": fp8,
          "fused_bn": {f"({m}, {c})": r for (m, c), r in bn.items()}, "bn_sum_rtol": BN_SUM_RTOL,
          "fused_ln": {f"({m}, {h}) {dt}": r for (m, h, dt), r in ln.items()},
          "ln_row_rtol": LN_ROW_RTOL, "ln_sum_rtol": LN_SUM_RTOL, "subnormals": subnormals,
          "flash_kv_mask": {"B=8 S=1024 H=12": kv_masked, "B=4 S=600 H=12": kv_masked_600},
          "flash_d128": d128})
    torch.cuda.empty_cache()
    b = bwd[1024]
    # the masked form (BERT's encoder, non-causal) beside each flash kernel's readings
    masked_form = {key: {f"B=8 S=1024 H=12 {c}": kv_masked[c][key] for c in kv_masked} for key in ("fwd", "dq", "dkv")}
    rows = [
        ("paged_attention", "consensusml_tpu_torch/csrc/paged_attention.cu",
         "consensusml_tpu/models/paged_attention.py:191", paged[1]),
        # the training shape carries most of the forward's launches; the
        # serving shape's readings stand beside it
        ("flash_attention_fwd", "consensusml_tpu_torch/csrc/flash_attention_fwd.cu",
         "consensusml_tpu/models/flash_attention.py:193",
         {**flash_b8[1024], "by_shape": {"train B=8 S=1024": flash_b8[1024],
                                         "serve B=1 S=1024": flash[1024]},
          "masked_form": masked_form["fwd"]}),
        ("flash_attention_bwd_dq", "consensusml_tpu_torch/csrc/flash_attention_bwd.cu",
         "consensusml_tpu/models/flash_attention.py:362",
         {"max_abs_err": b["dq_max_abs_err"], "ms": b["dq_ms"], "plain_ms": b["plain_ms"],
          "bound_ms": b["dq_bound_ms"], "bound_by": b["dq_bound_by"], "library_ms": b["library_ms"],
          **{key: b[f"dq_{key}"] for key in ("tflops", "x_library", "x_bound")},
          "masked_form": masked_form["dq"]}),
        ("flash_attention_bwd_dkv", "consensusml_tpu_torch/csrc/flash_attention_bwd.cu",
         "consensusml_tpu/models/flash_attention.py:400",
         {"max_abs_err": max(b["dk_max_abs_err"], b["dv_max_abs_err"]), "ms": b["dkv_ms"],
          "plain_ms": b["plain_ms"], "bound_ms": b["dkv_bound_ms"], "bound_by": b["dkv_bound_by"],
          "library_ms": b["library_ms"], **{key: b[f"dkv_{key}"] for key in ("tflops", "x_library", "x_bound")},
          "bwd_ms": b["bwd_ms"], "bwd_x_library": b["bwd_x_library"], "masked_form": masked_form["dkv"]}),
        # int8 at its (4 * 8192, 512) shape carries the readings (the train
        # line's format); int4 and fp8 at the largest bucket's rows beside
        ("fused_choco_encode", "consensusml_tpu_torch/csrc/fused_choco_encode.cu",
         "consensusml_tpu/compress/kernels.py:953", {**enc["int8"], "by_format": enc}),
        # fp8 carries the readings (its byte bound is the largest); the
        # collective round's receive (train_collective) launches it
        ("fused_dequantize_accumulate", "consensusml_tpu_torch/csrc/fused_choco_decode.cu",
         "consensusml_tpu/compress/kernels.py:1016", {**dec["fp8"], "by_format": dec}),
        # the largest bucket's shapes carry the top-k phase's time; the
        # median bucket's and the acc form's readings stand beside them
        ("chunked_topk", "consensusml_tpu_torch/csrc/chunked_topk.cu",
         "consensusml_tpu/compress/kernels.py:374",
         {**codec["topk"]["largest"], "by_shape": codec["topk"]}),
        ("quantize_int8", "consensusml_tpu_torch/csrc/int8_codec.cu",
         "consensusml_tpu/compress/kernels.py:123", codec["quantize_int8"]),
        ("dequantize_int8", "consensusml_tpu_torch/csrc/int8_codec.cu",
         "consensusml_tpu/compress/kernels.py:156", codec["dequantize_int8"]),
        ("chunk_scatter", "consensusml_tpu_torch/csrc/chunk_scatter.cu",
         "consensusml_tpu/compress/kernels.py:481",
         {**codec["scatter"]["largest no_acc"], "by_shape": codec["scatter"]}),
    ]
    # the fused-BN kernels: the largest BN view's readings, the other four
    # shapes beside them. All four TPU kernels reach pl.pallas_call through
    # _grid_call (fused_bn.py:175); each is named by its kernel body's line,
    # and bn_bwd replaces two: _bwd_reduce_kernel (:145) and _bwd_dx_kernel
    # (:159)
    for name, line in (("bn_stats", 118), ("bn_norm", 130), ("bn_bwd", 145)):
        by_shape = {f"({m}, {c})": r[name] for (m, c), r in bn.items()}
        worst = max(r[name]["max_abs_err"] for r in bn.values())
        extra = {"also_replaces": "consensusml_tpu/models/fused_bn.py:159"} if name == "bn_bwd" else {}
        rows.append((name, "consensusml_tpu_torch/csrc/fused_bn.cu", f"consensusml_tpu/models/fused_bn.py:{line}",
                     {**bn[(131072, 256)][name], "max_abs_err": worst, "by_shape": by_shape, **extra}))
    # the fp8 pair at the largest fp8 bucket's rows, the median's beside;
    # dequantize_fp8 is the int8 dequantize's pallas_call fed e4m3 rows
    for name, line in (("quantize_fp8", 282), ("dequantize_fp8", 156)):
        rows.append((name, "consensusml_tpu_torch/csrc/int8_codec.cu", f"consensusml_tpu/compress/kernels.py:{line}",
                     {**fp8["largest"][name], "by_shape": {k: v[name] for k, v in fp8.items()}}))
    # the int4 pair at the largest bucket's value rows, the median's beside
    for name, line in (("quantize_int4", 205), ("dequantize_int4", 242)):
        rows.append((name, "consensusml_tpu_torch/csrc/int4_codec.cu", f"consensusml_tpu/compress/kernels.py:{line}",
                     {**int4["largest"][name], "by_shape": {k: v[name] for k, v in int4.items()}}))
    # the LN pair at GPT-2-medium's (8192, 1024) bf16 view, the f32 shape beside
    for name, line in (("ln_fwd", 150), ("ln_bwd", 181)):
        by_shape = {f"({m}, {h}) {dt}": r[name] for (m, h, dt), r in ln.items()}
        rows.append((name, "consensusml_tpu_torch/csrc/fused_ln.cu", f"consensusml_tpu/models/fused_ln.py:{line}",
                     {**ln[(8192, 1024, "bfloat16")][name], "max_abs_err": max(r[name]["max_abs_err"] for r in ln.values()),
                      "by_shape": by_shape}))
    if sorted(r[0] for r in rows) != sorted(kernels.KERNELS):
        raise AssertionError(f"the kernels line must list every kernel of {list(kernels.KERNELS)}")
    launches: dict[str, dict] = {name: {} for name in kernels.KERNELS}
    forms: dict[str, dict] = {}
    from consensusml_tpu_torch import configs

    # ResNet-50's stacked initial variables, drawn once for every ResNet phase
    t0 = time.perf_counter()
    resnet_init = configs.build("cifar_resnet50", "full", device=dev).init_params(0)
    resnet_init_s = time.perf_counter() - t0
    # checkpoint and resume first: the collective spawn below resumes its checkpoint
    line, counts, ckpt_tmp, ckpt, final = train_resnet_resume_phase(torch, dev, resnet_init_named(resnet_init, "pallas"))
    emit(line)
    for name, n in counts.items():
        launches[name]["train_resnet_resume"] = n
    gc.collect()
    torch.cuda.empty_cache()
    # the collective phases next, while this process holds the least of
    # the card: every rank is a process of its own on it
    try:
        collective = collective_phases(torch, dev, (ckpt, final))
    finally:
        shutil.rmtree(ckpt_tmp, ignore_errors=True)
    del final
    for line, counts, by_form in collective:
        emit(line)
        for name, n in counts.items():
            launches[name][line["phase"]] = n
        for name, per in by_form.items():
            for form, n in per.items():
                forms.setdefault(name, {}).setdefault(form, {})[line["phase"]] = n
    serve, counts = serve_phase(torch, dev)
    emit(serve)
    for name, n in counts.items():
        launches[name]["serve"] = n
    forms.setdefault("paged_attention", {}).setdefault("grouped", {})["serve"] = serve["paged_grouped_launches"]
    torch.cuda.empty_cache()
    # the stacked numpy initial parameters, drawn once for the five GPT-2 train phases
    t0 = time.perf_counter()
    init = configs.build("gpt2_topk", "full", world=4, device=dev).init_params(0)
    init_s = time.perf_counter() - t0
    for path, codec_name, norm_impl in (("train", "int8", "flax"), ("train_topk", None, "flax"),
                                        ("train_topk_int4_ln", "topk_int4", "pallas"),
                                        ("train_int4", "int4", "flax"), ("train_fp8", "fp8", "flax")):
        line, counts, state, bundle = train_phase(torch, dev, init, codec_name, norm_impl,
                                                  keep_state=path == "train_fp8")
        if path == "train":
            line["setup_s"] = {"init_params": init_s, **line["setup_s"]}
        emit(line)
        for name, n in counts.items():
            launches[name][path] = n
        if path == "train_topk":
            # the same codec on the per-leaf wire (--bucket-bytes 0), then
            # with a linear LR schedule and gradient clipping
            line, counts = train_perleaf_phase(torch, tck, dev, init)
            emit(line)
            for name, n in counts.items():
                launches[name]["train_perleaf_topk"] = n
            line, counts = train_topk_sched_phase(torch, dev, init)
            emit(line)
            for name, n in counts.items():
                launches[name]["train_topk_sched"] = n
    line, counts = gossip_two_step_phase(torch, dev, state, bundle)
    emit(line)
    for name, n in counts.items():
        launches[name]["gossip_fp8_two_step"] = n
    del state, bundle
    gc.collect()
    torch.cuda.empty_cache()
    # overlap gossip on the config's own codec, then the fused codec (one payload over the whole tree)
    for path, phase in (("train_topk_overlap", train_topk_overlap_phase),
                        ("train_fused_codec", train_fused_codec_phase)):
        line, counts = phase(torch, tck, dev, init)
        emit(line)
        for name, n in counts.items():
            launches[name][path] = n
    fused_codec_times = line["kernel_times"]  # the four codec kernels at the whole-tree shape
    del init
    gc.collect()
    torch.cuda.empty_cache()

    init, init_s = resnet_init, resnet_init_s
    del resnet_init
    for path, norm_impl, counted in (("train_resnet", "pallas", 3), ("train_resnet_flax", "flax", 2)):
        line, counts = train_resnet_phase(torch, dev, resnet_init_named(init, norm_impl), norm_impl, counted)
        line["setup_s"] = {"init_params": init_s, **line["setup_s"]}
        emit(line)
        for name, n in counts.items():
            launches[name][path] = n
    line, counts = train_resnet_topologies_phase(torch, dev, resnet_init_named(init, "pallas"))
    emit(line)
    for name, n in counts.items():
        launches[name]["train_resnet_topologies"] = n
    # worker drop-outs with rollback on the ring, then push-sum on the directed one-peer graph
    for push_sum in (False, True):
        line, counts = train_resnet_faults_phase(torch, dev, resnet_init_named(init, "pallas"), push_sum)
        line["setup_s"] = {"init_params": init_s, **line["setup_s"]}
        emit(line)
        for name, n in counts.items():
            launches[name][line["phase"]] = n
    line, counts = train_resnet_overlap_phase(torch, dev, resnet_init_named(init, "pallas"))
    line["setup_s"] = {"init_params": init_s, **line["setup_s"]}
    emit(line)
    for name, n in counts.items():
        launches[name]["train_resnet_overlap"] = n
    del init
    gc.collect()
    torch.cuda.empty_cache()
    line, counts = train_mnist_phase(torch, dev)
    emit(line)
    for name, n in counts.items():
        launches[name]["train_mnist"] = n
    # bert_mlm: the encoder at a long max_len through the masked flash
    # kernels, then the config itself (dense attention at seq 128)
    line, counts = bert_long_padded_phase(torch, dev)
    emit(line)
    for name, n in counts.items():
        launches[name]["bert_long_padded"] = n
    for name, n in line["masked_launches"].items():
        forms.setdefault(name, {}).setdefault("masked", {})["bert_long_padded"] = n
    # one counted round, no warm one, and two held-out batches (two counted
    # rounds and eight batches until train_llama joined the script's time,
    # a warm round until train_resnet_resume and train_topk_sched did)
    line, counts = train_bert_phase(torch, dev, counted=1, eval_batches=2)
    emit(line)
    for name, n in counts.items():
        launches[name]["train_bert"] = n
    # llama_lora: Llama-2-7B's adapters on 16 workers, the flash kernels at head dim 128
    line, counts, d128_counts, weights = train_llama_phase(torch, dev, counted=1)
    emit(line)
    for name, n in counts.items():
        launches[name]["train_llama"] = n
    for name, n in d128_counts.items():
        forms.setdefault(name, {}).setdefault("d128", {})["train_llama"] = n
    # and served: train_llama's base and consensus adapters, paged decode at
    # max_len 4096 through the paged kernel's head groups
    line, counts, grouped = serve_llama_phase(torch, dev, weights)
    del weights
    emit(line)
    for name, n in counts.items():
        launches[name]["serve_llama"] = n
    forms["paged_attention"]["grouped"]["serve_llama"] = grouped
    for name, n in line["launches"].items():
        if name == "flash_attention_fwd":
            forms[name]["d128"]["serve_llama"] = n

    # the head-dim-128 forms (llama_lora's) as entries of their own beside
    # their kernels: readings from check.flash_d128, launches from train_llama
    # (each kernel's own entry counts every form's launches)
    d128_rows = [(f"{name} (head dim 128)", src, rep, {**d128[key], "form_of": name,
                                                       "launches_by_path": forms[name]["d128"]})
                 for key, (name, src, rep, _r) in zip(("fwd", "dq", "dkv"), rows[1:4])]
    # the paged kernel's head-group form (Llama-2-7B's heads): readings from
    # check.paged_attention_llama (W=1, 32 kv heads), launches from serve_llama
    name, src, rep, _r = rows[0]
    d128_rows.append((f"{name} (head groups)", src, rep,
                      {**paged_llama["W=1"], "form_of": name, "launches_by_path": forms[name]["grouped"]}))
    entries = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": sum(launches[name].values()), "launches_by_path": launches[name],
         **({"launches_by_form": forms[name]} if name in forms else {}),
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": r["library_ms"], **({"library": r["library"]} if "library" in r else {}),
         **{k: r[k] for k in ("tflops", "x_library", "x_bound", "bwd_ms", "bwd_x_library", "by_shape", "by_format",
                              "also_replaces", "masked_form") if k in r},
         **({"at_fused_codec_shape": fused_codec_times[name]} if name in fused_codec_times else {})}
        for name, src, rep, r in rows
    ]
    entries += [
        {"name": name, "route": "cuda", "source": src, "replaces": rep, "form_of": r["form_of"],
         "launches": sum(r["launches_by_path"].values()), "launches_by_path": r["launches_by_path"],
         **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
         **{k: r[k] for k in ("library", "tflops", "x_library", "x_bound", "shape", "plan") if k in r}}
        for name, src, rep, r in d128_rows
    ]
    emit({"kernels": entries})
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
