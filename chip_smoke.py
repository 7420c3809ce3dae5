#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``ccst_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout; it needs one CUDA card and exits non-zero
without one. It imports nothing of JAX. Phases, each of which fails the run:

  1. device: the card's name and power limit (nvidia-smi), TF32 off so the
     float32 plain references are true float32;
  2. build: the CUDA kernel library from ``ccst_tpu_torch/csrc`` (one nvcc
     per source, in parallel);
  3. each kernel against its plain PyTorch version on the card at the shapes
     of the 512 px path, with the median time of both and the kernel's bound
     (the larger of its operations over the card's dense peak and its bytes,
     each input read and each output written once, over 3.35 TB/s): K3 conv at
     every distinct shape of the ``ref`` engine at 512 px, batch 4, cuDNN's
     bf16 conv timed beside it for comparison only (and at the two 512 -> 512
     shapes only WCT launches, at batch 32), and its exact float32
     route (TF32 off everywhere, rtol = atol = 1e-4) at every shape of the
     path and three ragged ones, cuDNN's float32 conv timed beside each; a
     K3 or K0 row under 0.1 ms is also timed from a replayed CUDA graph
     (``graph_ms``); K4 AdaIN for one and three style banks
     (bf16 and float32, alpha 1.0 and 0.6, the resident and the streamed
     variant, batch 32 and the 256 px map); K5 moments (bf16 and float32,
     C = 512 and 500, batch 32; the same bits from two runs; ``torch.var_mean``
     timed beside it for comparison only), each beside the
     time of an empty kernel launched the same way; K0 int8 conv at every shape of the int8 engines, K1
     fused level-1 encoder and K2 fused level-1 decoder bit for bit, K2 and
     the two K0 launches it replaces timed on the device from a replayed
     CUDA graph at batch 4 and 32, its plain version at both; the int8 A/B
     kernels bit for bit at the harnesses' full-width shapes: B1 tiled GEMM
     (int8 -> int32, int8 -> float32, bf16 -> float32, M = 2^18, the five
     (K, N) of the sweep; beside it, for comparison only, the one library call
     that computes the same function: ``torch._int_mm`` for int8 -> int32 and
     ``torch.mm(x, w, out_dtype=torch.float32)`` for bf16 -> float32; the
     bf16-output ``torch.matmul`` is timed under its own name, since it writes
     half the output bytes), B2 direct (K0's kernel with the reference's row
     offset) and Winograd conv (full, dots, tf) at (8, 256, 256, 256 -> 256),
     each and K0 at the same shape (``k0_ms``) from a replayed CUDA graph,
     B3 fused pool1 + conv2_1 (F9, F3) at (128, 256, 256, 256), the unfused
     chain (phase max + K0) timed beside it; then ragged
     shapes (odd planes, Cout = 12, one-row tiles, M and N off the tiles);
     and the modes of the packed and dynamic int8 engines: K3 with edge
     padding at the packed level-1 shapes (bf16 and float32, cuDNN on an
     edge-padded input beside it), K0 dequantizing with k = w_scale * a_scale
     formed on the device at every shape of the int8 engine (bit for bit);
     W1, WCT's centring pass, bit for bit in bfloat16 and float32 at the
     five levels' shapes of the benchmark's WCT cell, timed beside its plain
     version with its bound;
  4. the main paths through the CLI entry point, in this process, each with
     every launch count zeroed before it and read after it: ``style-bank``
     for four synthetic PACS domains, ``stylize --target photo --mode
     overall`` (bf16 ``ref`` engine), ``calibrate --target photo``,
     ``stylize --engine int8-fused`` at 512 px in bfloat16 with seeded random
     weights, then ``style-bank`` and ``stylize --engine ref`` once more with
     ``--dtype float32`` (the parity mode); ``stylize --mode single`` with
     ``ref`` and ``int8-fused``, ``--engine packed`` (bf16 and float32),
     ``--engine int8``, ``--output-size 96`` (96 px PNGs) and ``ref`` for the
     other three content domains; a ``--skip-existing`` rerun that launches
     and writes nothing, and one after an output a style is deleted that
     rewrites exactly those; ``style-bank --model wct`` and ``stylize --model
     wct --mode overall`` (WCT's five-level cascade, its centring kernel
     counted beside K3); outputs must exist, spread and be finite, and
     every kernel's launch count must be exactly what the path implies; then
     ``reorganize``, ``gen-lists``, ``filter-blank`` and ``split-data`` on the
     same tree, each exiting 0 and writing its lists;
  5. on one 512 px batch: the ``ref`` path against the same path composed
     from the plain versions (MAE <= 1e-3), and the same in float32 (MAE <=
     1e-4); ``int8-fused`` against its plain
     composition (MAE <= 1e-3), against ``int8-static`` (bit for bit) and
     against ``ref`` (PSNR > 20 dB); ``apply_decoder_q8s_fused`` (K2) against
     ``apply_decoder_q8s`` (bit for bit) on one AdaIN output, one style's
     decode timed both ways; ``packed`` against its plain composition (MAE
     <= 1e-3; float32 <= 1e-4) and in float32 against the float32 ``ref``
     (max 5e-5); ``int8`` against its plain composition (MAE <= 1e-3) and
     against ``ref`` (PSNR > 20 dB); device-only ``stylize_multi`` times of
     every engine and of the float32 ``ref`` and ``packed`` engines, as a loop
     of calls and as one replayed CUDA graph (the card's own time: the
     difference is the host's);
  6. the three int8 A/B harnesses (``ccst_tpu_torch.benchmarks.int8_mm``,
     ``winograd_ab``, ``fused_pool_conv_ab --batch 32``) through their
     ``main()`` in this process, each with every launch count zeroed before it
     and read after it; the counts must be the ones its arguments imply.
  7. the training stage, on phase 4's tree after its ``stylize``,
     ``reorganize`` and ``gen-lists`` runs (it runs there, before phase 5):
     ``gen-lists --k 3`` (the README quick start's ``adain-overall-K3``
     lists; the tree's labels spread over PACS's 7 classes), then through the
     CLI, each run a process of its own with ``--device cuda``: ``amp-bank``
     for the three sources, ``fed-train --network resnet50 --mode fedavg
     --rounds 2 --save-freq 1`` at ``FedConfig``'s widths (222 px, batch 32,
     lr 1e-2, 7 classes, 3 clients in sequence, at least two local steps
     each), one round each of fedbn, fedprox, adafea and deepall and of RSC,
     Jigsaw, MixStyle and feddg (four processes at a time), ``--resume`` to round 3 (it must start at
     round 2), ``fed-test --checkpoint best`` (it must print exactly the
     ``test_acc`` the log recorded for the best round), ``--in-test`` and
     ``--tent``; every run must exit 0 and every logged loss be finite. Then
     one local step on the card against the port's CPU path from the same
     state with the same drawn crops and flips, float32 with TF32 off:
     ResNet-50 with fedavg and fedprox (step 1), RSC, Jigsaw, MixStyle and
     FedDG at ResNet-18 width, with the CPU's float64 step as the reference
     of both; the loss within 1e-4 relative of the CPU's, ResNet-50's
     train-mode logits within ``FED_LOGITS_ATOL`` of float64, every updated
     leaf with median |d_card - d_64| at most 1e-3 max |d_64| (the ReLU-tie
     rule of ``tests/test_train_equivalence.py``) or twice the CPU float32
     step's own median distance, where float32 cannot meet that rule (BN
     leaves, whose gradients cancel). Last the card's times: ms a local
     step of ResNet-50 at batch 32 in the runner's mode (cuDNN deterministic;
     CUDA events, median of runs after a warm-up) and training img/s, eval img/s, the CLI run's seconds a round
     and the share of it the host waited on the loader, and
     ``torch.cuda.max_memory_allocated`` over the timed steps, all on a
     ``fed`` JSON line with the card's name and power limit. No TPU kernel
     lies on this path: the classifiers run cuDNN / cuBLAS / cuFFT through
     ``torch.nn.functional`` and ``torch.fft``, as ``ccst_tpu`` runs XLA.
     Then ROADMAP's F3: one ResNet-50 step twice in this process and once in
     a second one (``benchmarks/fed_bits.py``), bit for bit, with cuDNN as
     the runner leaves it and in its deterministic mode, each mode's step
     timed (the deterministic mode must give the same bits);
  8. decoder training and the privacy inversion, on the same tree, at 256 px
     with seeded random weights: the kernel wrappers K3 (bf16 and float32),
     K4 and K5 must raise on a CUDA tensor that requires grad; then through
     the CLI in this process, each with every launch count zeroed before it
     and read after it: ``train-decoder`` (batch 8, 3 Adam steps,
     ``--init-decoder`` the smoke's decoder: 18 K3 a step, the frozen
     encoder's float32 passes), ``invert-train --loss mse+perceptual`` (batch
     16, 3 steps, on a list that pools the four domains: 18 K3 a step and 9 a
     val batch), ``invert-eval`` plain, ``--overall`` (phase 4's bank),
     ``--holdout`` and with ``--lpips-vgg/--lpips-lin`` (state dicts the
     smoke builds and saves; 27 K3 a batch, 18 with ``--overall``),
     ``gan-train`` (batch 8, 3 steps, ``--gp-weight 10 --attn-res 32
     --fid-samples 16``: 18 K3); every printed number finite, the decoder's
     ``.npz`` of the decoder's tree and moved by at most 2 lr a step, the
     reconstructions and samples written, the penalty on at step 0. Then one
     ``train-decoder`` step and one inverter step (``mse+perceptual``, the
     style vectors from the card) on the card against the CPU's float32 and
     float64 steps by phase 7's rule (loss within 1e-4; per leaf median
     |d_card - d_64| at most max(1e-3, 2 x the CPU float32 step's own) of max
     |d_64|), the style vector against its plain version on the CPU (1e-2 of
     each vector's max). Steps a second, img/s and peak device memory of each
     run go on the ``privacy`` line with the card's name and power limit. The
     trainable passes run cuDNN through the autograd route, as ``ccst_tpu``
     trains through XLA's convs; every grad-free VGG pass runs K3.
  9. parallel clients and multi-process runs, on the same tree, ResNet-50 at
     ``FedConfig``'s widths (float32, TF32 off, cuDNN deterministic): (a) one
     vmapped step of the three clients against their three sequential steps
     from the same states and draws (the same bits over two calls; each loss
     within 1e-4; per leaf phase 7's rule against float64 steps on the card,
     the sequential step as float32's resolution), both timed in both cuDNN
     modes with the peak device memory; (b) ``fed-train --parallel-clients``
     for 2 rounds; (c) the same run as 3 ranks of ``--coordinator
     127.0.0.1:PORT --num-procs 3`` on the one card (gloo, printed): one
     server sha256 on every rank; each CLI run's final server bit-equal to
     this process's replay of its steps; then over the 2 rounds, on the CLI
     runs' data and on one full batch a client a round, the two paths
     replayed in float64 within 1e-6 of the update of each other, and each
     float32 run against float64 by phase 7's rule with the other float32
     run as its float32 reference;
     (d) ``invert-train`` on 2 ranks (each its strided shard, ``--rank-worker``
     processes of this script) and (e) ``train-decoder`` on a mesh of 2 ranks:
     each rank's K3 launches (18 a step), then one step over the two ranks on
     phase 8's batch, bit-equal on both and within phase 8's rule of its
     float64 step. A ``parallel`` JSON line reports them.
 10. the sharded paths (``parallel/spatial.py``, ``parallel/tensor.py``),
     after phase 6, on phase 4's images, banks and calibration: (c) K4's
     given-statistics entry against its plain version at relu4_1 of a 512 px
     batch with the three banks (bf16 rtol = atol = 1e-2, float32 1e-5),
     its device time from a replayed CUDA graph beside its byte bound; then
     four ranks of this script's ``--rank-worker shard`` on the one card
     (gloo, collectives through the host), every launch count zeroed before
     each call and read after it on every rank: (a) the row-sharded stylize
     over the four ranks, ``ref`` in bf16 and float32 and ``int8-static``,
     one call a bank, each against the single-rank engine on the same images
     and bank (bf16 and int8 MAE <= 1e-3, float32 rtol 1e-4 atol 1e-5), the
     same bits gathered on every rank, the relu4_1 features beside the single
     rank's (int8: bit for bit, the halo check), exactly 18 K3 / K0, one K5
     an image and one given-statistics K4 a call on every rank; (b) the
     batch-sharded int8-static stylize (an image a rank) bit for bit, 18 K0
     and one K4 a call; (d) ResNet-50 at ``FedConfig``'s widths over a
     (data 2, model 2) mesh, eval mode, float32 with TF32 off, a batch of 8
     at 222 px, against the unsharded float32 step (loss rtol 2e-5, logits
     atol 2e-4) and every gradient leaf by phase 7's rule against the
     float64 step. A ``sharding`` JSON line reports them with their seconds.
 11. the end-to-end validation experiments of ``ccst_tpu_torch/experiments/``
     at their ``--quick`` sizes on the card, in a temporary directory: the
     semantic validation (all four arms, seed 1: LSUV + autoencoder
     pretraining, decoder training, bf16 banks, the float32 ``ref``,
     ``int8-static`` and Single-mode chains, ``fed-train``) and the privacy
     finding (float32 banks, the inverter, its held-out evaluation) from the
     port's default initial weights and from two more of its draws
     (``initial_weights(1000)``, ``(2000)``); every stage's launches read
     around it and held to phase 4's and phase 8's formulas at 3 styles, and
     nothing launched outside the stages; (a) ``tests/test_privacy_leakage.py``'s
     bars over the three draws: the median leakage gap > 2 dB (at these sizes
     the gap depends on the draw, on the JAX side too: 2.91-8.04 dB over six
     of its keys on the CPU) and Overall at most the mean image + 0.5 dB on
     every draw; (b) on the chain's own 32 px images, banks and weights, the
     float32 ``ref`` stylize against its plain composition (MAE <= 1e-4),
     Single mode's style statistics (K3 float32 + K5 on a 4 x 4 map),
     ``int8-static`` (MAE <= 1e-3, relu4_1 bit for bit), both outputs
     spanning at least 0.5, the bf16 encoder of the banks against its plain
     version (each image within 1e-2 of its largest relu4_1 value) and K5 on
     each domain's first bank batch (8, 4, 4, 512) (mean rtol 1e-5, M2 1e-4),
     then K3 float32 timed at every conv shape of the ``ref`` stylize beside
     cuDNN's float32 conv, its plain version and its bound, and K4, K5 and the
     ``int8-static`` batch at these shapes beside their plain versions, K5
     beside ``torch.var_mean``, the batch beside the sum of its K0 and K4
     launches' bounds; (d) both artifacts
     carry the JAX scripts' keys and the card. An ``experiments`` JSON line
     reports each stage's seconds, the accuracies, the gaps and the launches.

The random decoder's last conv is rescaled (x12, bias +0.5) so that stylized
outputs spread over [0, 1] as real ones do: the MAE bar is then 0.1% of the
output's range, as it is for a real image, and the PNGs the CLI writes are not
near-constant.

    python3 chip_smoke.py --images-per-domain 32 --batch-size 32

runs the same phases on a larger synthetic tree and batch, for the device
rates at batch 32 and a disk-to-disk rate over more than the first batches.

Before the last two lines come the ``fed`` JSON line of phase 7 (with F3's
``step_bits``), the ``privacy`` line of phase 8, the ``parallel`` line of
phase 9, the ``sharding`` line of phase 10 and the ``experiments`` line of
phase 11. The line
before the last is a JSON object with one entry per kernel (K4's
given-statistics entry its own, ``fused_adain_given``), whose
``launches`` are the counts of the main paths of phases 4, 8, 9, 10 and 11 (K2 decodes ``int8-fused``:
on this card it is faster than the two K0 launches it replaces,
``replaces_chain_ms``) and,
for B1-B3, the phase-6 harnesses' counts, and whose ``bound_ms`` / ``bound_by``
/ ``library_ms`` are those of its ``timed_shape``, the one the main paths
launch it at (K4's and K5's is relu4_1 of a ``--batch-size`` batch, K4's with
all three banks in the launch, ``timed_styles``; their ``ms`` is the card's
own time, from a replayed CUDA graph; ``call_ms`` under ``shapes`` is the
host's rate of calls; K2's ``ms`` is device time from a graph too. K3, K0 and
B1 list every main-path shape, K3 also its float32 rows, B1 every variant, K4,
K5, K2, B2 and B3 every timed case, under ``shapes``; B2's rows carry ``k0_ms``);
the last line is ``{"ok": true, "device":
{...}}``.
"""
import argparse
import contextlib
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
BF16_TOL = dict(rtol=1e-2, atol=1e-2)  # same bf16 operands, f32 sums in another order
F32_TOL = dict(rtol=1e-5, atol=1e-5)   # K4 in float32: the same maths, sums in another order
# K3 in float32: float32 sums of up to 9 x 512 products in another order than
# cuDNN's (TF32 off on both sides)
K3_F32_TOL = dict(rtol=1e-4, atol=1e-4)
F32_MAE_BAR = 1e-4                     # float32 whole path against its plain path
MAE_BAR = 1e-3                         # ROADMAP.md / BASELINE stylize bar
MIN_SPREAD = 0.5                       # the bar above assumes outputs spread over [0, 1]
PSNR_BAR = 20.0                        # int8 vs bf16 ref, ccst_tpu's tests/test_vgg_fast.py bar
PACKED_F32_ATOL = 5e-5                 # packed vs ref in float32, ccst_tpu's tests/test_vgg_fast.py bar
INT8_PEAK_TOPS = 1979.0                # H100 SXM dense int8, NVIDIA data sheet
BF16_PEAK_TFLOPS = 989.0               # H100 SXM dense bf16, NVIDIA data sheet
F32_PEAK_TFLOPS = 67.0                 # H100 SXM float32 outside the tensor cores
HBM_TB_S = 3.35                        # H100 SXM device memory rate
DOMAINS = ("art_painting", "cartoon", "photo", "sketch")
SIZE = 512
DEC_SCALE, DEC_SHIFT = 12.0, 0.5       # last decoder conv: outputs spread over [0, 1]

# K3 at every distinct shape the ``ref`` engine launches at batch 4, 512 px
# (encoder conv1_1..conv4_1, decoder dconv4_1..dconv1_1; 256->256 at 128 px,
# 128->128 at 256 px and 64->64 at 512 px serve both), then a ragged one
K3_SHAPES = [
    ("conv1_1", (4, 512, 512, 3, 64)),
    ("conv1_2, dconv1_2", (4, 512, 512, 64, 64)),
    ("conv2_1", (4, 256, 256, 64, 128)),
    ("conv2_2, dconv2_2", (4, 256, 256, 128, 128)),
    ("conv3_1", (4, 128, 128, 128, 256)),
    ("conv3_2..3_4, dconv3_4..3_2", (4, 128, 128, 256, 256)),
    ("conv4_1", (4, 64, 64, 256, 512)),
    ("dconv4_1", (4, 64, 64, 512, 256)),
    ("dconv3_1", (4, 128, 128, 256, 128)),
    ("dconv2_1", (4, 256, 256, 128, 64)),
    ("dconv1_1", (4, 512, 512, 64, 3)),
    ("ragged", (2, 37, 53, 64, 128)),
]
# K3 at the shapes only WCT's path launches (``--model wct``), at the batch of
# the benchmark's WCT cell: 512 -> 512 at 64 x 64 (conv4_2..4_4 and their
# mirrors dconv4_4..4_2) and at 32 x 32 (conv5_1 and dconv5_1)
K3_WCT_SHAPES = [
    ("conv4_2..4_4, dconv4_4..4_2 (WCT)", (32, 64, 64, 512, 512)),
    ("conv5_1, dconv5_1 (WCT)", (32, 32, 32, 512, 512)),
]
K3_MAIN = (4, 512, 512, 64, 64)
# W1, WCT's centring pass, at the (B, P, C) of each level of the benchmark's
# WCT cell (batch 32 at 512 px)
W1_SHAPES = [("relu5_1", (32, 1024, 512)), ("relu4_1", (32, 4096, 512)),
             ("relu3_1", (32, 16384, 256)), ("relu2_1", (32, 65536, 128)),
             ("relu1_1", (32, 262144, 64))]
W1_MAIN = W1_SHAPES[-1][1]
# K3's float32 route (``--dtype float32``) at every shape of the 512 px path,
# then ragged planes: Cin and Cout off every vector width (the scalar gather),
# Cout = 3 (the narrow tile) on a plane that is no multiple of its 32 x 64 tile
K3_F32_SHAPES = [*((layer, shape) for layer, shape in K3_SHAPES if layer != "ragged"),
                 ("ragged", (2, 37, 53, 64, 128)), ("ragged", (3, 17, 9, 5, 7)),
                 ("ragged Cout = 3", (3, 45, 70, 64, 3))]
GRAPH_BELOW_MS = 0.1  # a kernel row under this also gets its time from a replayed CUDA graph
def relu4_1_shape(batch):
    """What K4 and K5 are given on the 512 px main paths: a batch's relu4_1."""
    return (batch, SIZE // 8, SIZE // 8, 512)


# K4: (shape, dtype name, alpha), each for S = 1 and S = 3 style banks, after
# the main paths' own shape ``relu4_1_shape(--batch-size)`` in both types and
# blends: relu4_1 of the 512 px path at batch 4 and 32, of the 256 px path, and
# maps above 119 x 119, which the kernel streams
K4_CASES = [
    ((4, 64, 64, 512), "bfloat16", 1.0), ((32, 64, 64, 512), "bfloat16", 1.0),
    ((4, 32, 32, 512), "bfloat16", 1.0),
    ((2, 128, 128, 64), "bfloat16", 0.6), ((1, 128, 128, 48), "float32", 1.0),
]
# K5: (shape, dtype name), after the main paths' own shape in both types: the
# bank's batch of 3 (also with rows that are not 16-byte aligned) and of 32
K5_CASES = [
    ((3, 64, 64, 512), "bfloat16"), ((3, 64, 64, 500), "bfloat16"), ((3, 64, 64, 512), "float32"),
    ((3, 64, 64, 500), "float32"), ((32, 64, 64, 512), "bfloat16"), ((32, 64, 64, 512), "float32"),
]
SMALL_REPS = 200  # launches a timing run of the sub-0.1 ms kernels (K4: 50 of S banks)
# K0 at the shapes the int8 engines launch at batch 4, 512 px:
# (layer, (N, H, W, Cin, Cout), pad, requant, relu)
K0_SHAPES = [
    ("conv1_1 packed (int8-static)", (4, 256, 256, 12, 256), "edge", True, True),
    ("conv1_2 packed (int8-static)", (4, 256, 256, 256, 256), "edge", True, True),
    ("conv2_1", (4, 256, 256, 64, 128), "reflect", True, True),
    ("conv2_2", (4, 256, 256, 128, 128), "reflect", True, True),
    ("conv3_1", (4, 128, 128, 128, 256), "reflect", True, True),
    ("conv3_2..3_4, dconv3_4..3_2", (4, 128, 128, 256, 256), "reflect", True, True),
    ("conv4_1 (dequant)", (4, 64, 64, 256, 512), "reflect", False, True),
    ("dconv4_1", (4, 64, 64, 512, 256), "reflect", True, True),
    ("dconv3_1", (4, 128, 128, 256, 128), "reflect", True, True),
    ("dconv2_1", (4, 256, 256, 128, 64), "reflect", True, True),
    ("dconv1_2 folded", (4, 256, 256, 64, 256), "edge", True, True),
    ("dconv1_1 packed (dequant)", (4, 256, 256, 256, 12), "edge", False, False),
]
K0_MAIN = (4, 128, 128, 256, 256)
# K3 with edge padding at the packed engine's level-1 shapes at batch 4, 512 px
# (the packed plane is 256 x 256): (layer, (N, H, W, Cin, Cout), relu). conv1_1
# takes its 12 channels padded to 16 (vgg_fast.PACKED_CIN)
K3_EDGE_SHAPES = [
    ("conv1_1 packed, Cin padded to 16", (4, 256, 256, 16, 256), True),
    ("conv1_2 packed", (4, 256, 256, 256, 256), True),
    ("dconv1_2 packed, upsample folded", (4, 256, 256, 64, 256), True),
    ("dconv1_1 packed", (4, 256, 256, 256, 12), False),
]
# K0 as the dynamic int8 engine launches it at batch 4, 512 px: dequant to
# bf16 at every layer, k = w_scale * a_scale formed on the device;
# (layer, (N, H, W, Cin, Cout), pad, relu)
K0_DYNAMIC_SHAPES = [(layer.split(" (")[0], shape, pad, relu)
                     for layer, shape, pad, _, relu in K0_SHAPES]
# ragged K0 shapes, correctness only: odd plane and no ReLU (clip at -127),
# Cout = 12 on an odd plane, the Cin = 12 gather on one row, the smallest
# reflectable plane
K0_EDGE = [
    ((2, 37, 53, 64, 128), "reflect", True, False),
    ((3, 17, 9, 256, 12), "edge", False, False),
    ((1, 1, 5, 12, 256), "edge", True, True),
    ((1, 2, 2, 64, 64), "reflect", True, True),
]
# ragged K1 / K2 planes (packed pixels): not multiples of the 8 x 16 tile,
# 18 rows (which ccst_tpu's row-tile rule rejects), one row; several tiles
# each way with both edges ragged, exactly one tile, one column of tiles; then
# planes that put a tile border on every side of K2's edge-replica fix-up: one
# past a tile each way, exact tiles, 2 x 2
LEVEL1_EDGE = [(1, 18, 10), (2, 7, 33), (1, 1, 3), (2, 19, 37), (1, 8, 16), (1, 250, 6),
               (1, 9, 17), (2, 16, 32), (1, 2, 2)]
K2_BATCHES = (4, 32)  # K2 against the chain it replaces: (batch, 256, 256, 64)
# B1 at the sweep of benchmarks/pallas_int8_mxu.py: (M, K, N); ragged: M not
# a multiple of the 192-row tile, N not of the 128-column tile, K ending
# inside a 128-byte stage in both element types, fewer rows than one wgmma
B1_M = 1 << 18
B1_SHAPES = [(256, 256), (512, 512), (2304, 256), (576, 256), (1152, 128)]
B1_MAIN = [B1_M, 2304, 256]
B1_EDGE = [(1000, 48, 24), (77, 2304, 136), (300, 80, 40), (5, 256, 128)]
# B2 at the packed conv1_2 shape of benchmarks/winograd_ab.py; ragged: odd
# planes (partial 2x2 tiles and 16 x 16 blocks), one row, four chunks with a
# second 128-channel tile half past Cout
B2_MAIN = (8, 256, 256, 256, 256)
B2_EDGE = [(1, 17, 37, 64, 64), (2, 9, 20, 128, 64), (1, 1, 3, 64, 128), (2, 40, 33, 256, 192)]
# B3 at benchmarks/fused_pool_conv_ab.py's B = 128; ragged: odd planes, 2x2
B3_MAIN = (128, 256, 256)
B3_EDGE = [(1, 7, 13), (2, 2, 2), (3, 33, 5)]
# B3's other output-channel tiles: BN = 64, the narrow BN = 16 (nine taps a stage), two n tiles
B3_EDGE_COUT = [(1, 7, 13, 64), (2, 2, 2, 12), (3, 33, 5, 136), (2, 17, 35, 64)]
HARNESS_REPS = ["--reps", "5", "--runs", "3"]
B3_HARNESS_BATCH = 32


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def bound(ops, peak_tera, nbytes):
    """The least time in ms the card could take: ``ops`` operations at
    ``peak_tera`` (1e12 per second) or ``nbytes`` at the device memory rate,
    whichever is larger, and which of the two it is."""
    t_ops, t_bytes = ops / (peak_tera * 1e12) * 1e3, nbytes / (HBM_TB_S * 1e12) * 1e3
    return dict(bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes")


def conv_bound(shape, peak_tera, in_bytes, out_bytes):
    """Bound of a 3x3 conv (N, H, W, Cin -> Cout): 2 * 9 * Cin * Cout
    operations a pixel; the input, the weights, the per-channel f32 terms
    and the output each moved once."""
    n, h, w, cin, cout = shape
    nbytes = n * h * w * (cin * in_bytes + cout * out_bytes) + 9 * cin * cout * in_bytes + 8 * cout
    return bound(2 * n * h * w * 9 * cin * cout, peak_tera, nbytes)


def check_close(name, got, want, rtol, atol):
    """Elementwise |got - want| <= atol + rtol * |want| in float32; returns
    (max abs err, mean abs err)."""
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        fail(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not bool(got.isfinite().all()):
        fail(f"{name}: non-finite output")
    err = (got - want).abs()
    if not bool((err <= atol + rtol * want.abs()).all()):
        fail(f"{name}: max abs err {err.max().item():.3e} exceeds rtol={rtol} atol={atol}")
    return err.max().item(), err.mean().item()


def check_equal(torch, name, got, want):
    """Bit for bit: same shape, dtype and values; returns the max abs err (0)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{name}: {tuple(got.shape)} {got.dtype} != {tuple(want.shape)} {want.dtype}")
    if not torch.equal(got, want):
        diff = (got.float() - want.float()).abs()
        fail(f"{name}: differs from its plain version at {int((diff > 0).sum())} elements, "
             f"max abs err {diff.max().item():.3e}")
    return 0.0


def time_ms(torch, fn, reps=10, runs=5):
    """Median over ``runs`` of the mean device time of ``reps`` calls (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return sorted(times)[len(times) // 2]


def read_images(paths):
    """(N, H, W, 3) uint8 from PNGs of one size."""
    import numpy as np
    from PIL import Image

    return np.stack([np.asarray(Image.open(p).convert("RGB"), dtype=np.uint8) for p in paths])


def cudnn_bf16_conv(torch, x, cw, pad_mode="reflect"):
    """A timing reference only, on no path: cuDNN's conv in x's dtype
    (channels_last) on an input reflect- (or edge-) padded beforehand, bias in
    the conv, no ReLU."""
    from ccst_tpu_torch.kernels.conv import _TORCH_PAD

    F = torch.nn.functional
    xp = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode=_TORCH_PAD[pad_mode])
    xp = xp.contiguous(memory_format=torch.channels_last)
    w = cw.w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    b = cw.b.to(x.dtype)
    return lambda: F.conv2d(xp, w, b)


def k3_bf16_rows(torch, dev, gen, layer, shape):
    """K3 in bf16 at one shape against its plain version, with and without
    ReLU; the ReLU row timed beside cuDNN's bf16 conv and the plain version,
    with its bound. Returns the rows."""
    from ccst_tpu_torch.benchmarks.small_kernels import graph_ms
    from ccst_tpu_torch.kernels.conv import (
        prepare_conv,
        reflect_conv3x3,
        reflect_conv3x3_reference,
    )

    n, h, w, cin, cout = shape
    rows = []
    x = torch.randn((n, h, w, cin), generator=gen).to(dev, torch.bfloat16)
    spread = (1.0 / (9 * cin)) ** 0.5
    wt = (torch.rand((3, 3, cin, cout), generator=gen) * 2 - 1) * spread
    b = (torch.rand((cout,), generator=gen) * 2 - 1) * spread
    cw = prepare_conv(wt, b, torch.bfloat16, dev)
    bd = conv_bound((n, h, w, cin, cout), BF16_PEAK_TFLOPS, 2, 2)
    flop = 2 * n * h * w * 9 * cin * cout
    for relu in (True, False):
        got = reflect_conv3x3(x, cw, relu)
        torch.cuda.synchronize()
        want = reflect_conv3x3_reference(x, cw.w, cw.b, relu)
        mx, mean = check_close(f"K3 {(n, h, w, cin, cout)} relu={relu}", got, want, **BF16_TOL)
        row = dict(layer=layer, shape=[n, h, w, cin, cout], relu=relu, max_abs_err=mx,
                   mean_abs_err=mean)
        if relu:  # timed once a shape; ReLU is one max in the epilogue
            ms = time_ms(torch, lambda: reflect_conv3x3(x, cw, True))
            plain = time_ms(torch, lambda: reflect_conv3x3_reference(x, cw.w, cw.b, True),
                            reps=3, runs=3)
            torch.backends.cudnn.benchmark = True
            lib = time_ms(torch, cudnn_bf16_conv(torch, x, cw))
            torch.backends.cudnn.benchmark = False
            row.update(ms=ms, plain_ms=plain, cudnn_bf16_ms=lib, **bd)
            line = (f"K3 conv {layer} {(n, h, w, cin, cout)}: max {mx:.3e} mean {mean:.3e} "
                    f"| kernel {ms:.4f} ms ({flop / (ms * 1e-3) / 1e12:.1f} TFLOP/s) bound "
                    f"{bd['bound_ms']:.4f} ms by {bd['bound_by']} "
                    f"({100 * bd['bound_ms'] / ms:.1f}% reached) cuDNN bf16 {lib:.4f} ms "
                    f"({flop / (lib * 1e-3) / 1e12:.1f} TFLOP/s) plain f32 {plain:.4f} ms")
            if ms < GRAPH_BELOW_MS:
                row["graph_ms"] = graph_ms(torch, lambda: reflect_conv3x3(x, cw, True), 20,
                                           5)["median"]
                line += f"; graph {row['graph_ms']:.4f} ms"
            print(line)
        else:
            print(f"K3 conv {layer} {(n, h, w, cin, cout)} relu=False: max {mx:.3e} mean {mean:.3e}")
        rows.append(row)
    return rows


def check_wct_centre(torch, dev):
    """Phase 3, W1: WCT's centring pass (``kernels/wct.py::centre_split``)
    against its plain version on the card, ``hi`` and ``lo`` bit for bit, in
    bfloat16 and float32 at every level's shape; each timed beside the plain
    version, with its bound (the features read, ``hi`` and ``lo`` written and
    the means read once: ``gpubench/flops/wct.py::centre_split_bytes``'s
    count). Returns the rows."""
    from ccst_tpu_torch.kernels.wct import PAD, centre_split, centre_split_reference

    gen = torch.Generator(device=dev).manual_seed(7)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for level, (b, p, c) in W1_SHAPES:
            # features on VGG's scale with a channel offset, as the levels' are
            x = (torch.randn((b, p, c), generator=gen, device=dev) * 60.0
                 + torch.rand((1, 1, c), generator=gen, device=dev) * 200.0).to(dtype)
            mean = x.mean(dim=1, dtype=torch.float32)
            hi, lo = centre_split(x, mean)
            want_hi, want_lo = centre_split_reference(x, mean)
            torch.cuda.synchronize()
            name = f"W1 {level} {(b, p, c)} {dtype}"
            check_equal(torch, f"{name} hi", hi, want_hi)
            if (lo is None) != (want_lo is None):
                fail(f"{name}: lo {lo is not None} against the plain version's "
                     f"{want_lo is not None}")
            if lo is not None:
                check_equal(torch, f"{name} lo", lo, want_lo)
            del hi, lo, want_hi, want_lo
            ms = time_ms(torch, lambda: centre_split(x, mean))
            plain = time_ms(torch, lambda: centre_split_reference(x, mean), reps=3, runs=3)
            size = x.element_size()
            lo_bytes = 2 * c if dtype == torch.bfloat16 else 0
            nbytes = b * p * (c * size + (c + PAD) * size + lo_bytes) + 4 * b * c
            bd = bound(0, BF16_PEAK_TFLOPS, nbytes)
            rows.append(dict(level=level, shape=[b, p, c], dtype=str(dtype), max_abs_err=0.0,
                             ms=ms, plain_ms=plain, bytes=nbytes, **bd))
            print(f"{name}: hi, lo bit-equal to the plain version | kernel {ms:.4f} ms "
                  f"({nbytes / (ms * 1e-3) / 1e12:.2f} TB/s) bound {bd['bound_ms']:.4f} ms by "
                  f"{bd['bound_by']} ({100 * bd['bound_ms'] / ms:.1f}% reached) plain {plain:.4f} ms")
            del x, mean
    return rows


def check_small_kernels(torch, dev, gen, results, batch):
    """Phase 3, K4 and K5: the fused AdaIN for one and three style banks and
    the channel moments against their plain versions, first at the shape the
    main paths launch them at with ``batch`` images a batch, with times beside the
    bound and beside an empty kernel launched through the same ctypes route.
    Both kernels take less time on the card than the host needs to make a
    call, so each gets two times: ``ms``, the card's own, from calls captured
    into one CUDA graph and replayed, and ``call_ms``, back-to-back calls of
    the wrapper between two events, which is the host's rate."""
    from ccst_tpu_torch.benchmarks.small_kernels import graph_ms
    from ccst_tpu_torch.kernels import _build
    from ccst_tpu_torch.kernels.adain import (
        fused_adain,
        fused_adain_multi,
        fused_adain_multi_reference,
        fused_adain_reference,
        plan_adain,
    )
    from ccst_tpu_torch.kernels.moments import channel_moments, channel_moments_reference

    lib = _build.library()

    def device_ms(fn, reps):
        return graph_ms(torch, fn, reps, 5)["median"]

    def empty_launch():  # the stream is read at every call: a graph is captured on its own
        if lib.ccst_empty_launch(torch.cuda.current_stream(dev).cuda_stream):
            fail("the empty kernel did not launch")

    empty_ms = device_ms(empty_launch, SMALL_REPS)
    empty_call_ms = time_ms(torch, empty_launch, reps=SMALL_REPS)
    print(f"empty kernel through the same ctypes route: {empty_ms:.4f} ms on the device (CUDA "
          f"graph of {SMALL_REPS}), {empty_call_ms:.4f} ms a call from the host: the floors "
          f"under K4's and K5's times")

    path_shape = relu4_1_shape(batch)
    k4_cases = [(path_shape, t, alpha) for t in ("bfloat16", "float32") for alpha in (1.0, 0.6)]
    for shape, dtype_name, alpha in dict.fromkeys(k4_cases + K4_CASES):
        dtype = getattr(torch, dtype_name)
        tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
        feat = (torch.randn(shape, generator=gen) * 2 + 1).to(dev, dtype)
        s_means = torch.randn((3, shape[-1]), generator=gen).to(dev)
        s_stds = (torch.rand((3, shape[-1]), generator=gen) + 0.1).to(dev)
        plan = plan_adain(shape[1] * shape[2])
        variant = "resident" if plan.resident else "streamed"
        single_ms = None
        for s in (1, 3):
            kernel = lambda: fused_adain_multi(feat, s_means[:s], s_stds[:s], alpha)
            plain = lambda: fused_adain_multi_reference(feat, s_means[:s], s_stds[:s], alpha)
            got = kernel()
            torch.cuda.synchronize()
            label = f"{shape} {dtype} alpha={alpha}" + (f" S={s}" if s > 1 else "")
            mx, mean = check_close(f"K4 {label}", got, plain(), **tol)
            if s == 1:  # the single-style wrapper is the S = 1 case of the same kernel
                check_equal(torch, f"K4 fused_adain {label}",
                            fused_adain(feat, s_means[0], s_stds[0], alpha), got[0])
            ms, call_ms = device_ms(kernel, 50), time_ms(torch, kernel, reps=50)
            plain_ms = time_ms(torch, plain, reps=5, runs=3)
            # a few float32 operations an element and style; the tensor in once, out s times
            bd = bound((4 + 6 * s) * feat.numel(), F32_PEAK_TFLOPS,
                       (1 + s) * feat.numel() * feat.element_size())
            row = dict(shape=list(shape), dtype=str(dtype), alpha=alpha, styles=s, kernel_variant=variant,
                       cluster=plan.cluster, max_abs_err=mx, mean_abs_err=mean, ms=ms,
                       call_ms=call_ms, plain_ms=plain_ms, empty_launch_ms=empty_ms, **bd)
            line = (f"K4 adain {label}: max {mx:.3e} mean {mean:.3e} ({variant}, cluster of "
                    f"{plan.cluster}) | kernel {ms:.4f} ms on the device, {call_ms:.4f} ms a call; "
                    f"bound {bd['bound_ms']:.4f} ms by {bd['bound_by']} "
                    f"({100 * bd['bound_ms'] / ms:.1f}% reached; empty launch "
                    f"{100 * empty_ms / ms:.1f}% of it) plain {plain_ms:.4f} ms")
            if s == 1:
                single_ms = ms
            else:  # what S launches of the single-style kernel cost, as the path ran before
                row["single_launches_ms"] = s * single_ms
                line += f" {s} single-style launches {s * single_ms:.4f} ms"
            results["K4"].append(row)
            print(line)
        del feat, got

    k5_cases = [(path_shape, "bfloat16"), (path_shape, "float32")]
    for shape, dtype_name in dict.fromkeys(k5_cases + K5_CASES):
        dtype = getattr(torch, dtype_name)
        feat = (torch.randn(shape, generator=gen) * 3 + 10).to(dev, dtype)
        mean, m2, count = channel_moments(feat)
        torch.cuda.synchronize()
        r_mean, r_m2, r_count = channel_moments_reference(feat)
        if count.item() != r_count.item():
            fail(f"K5 {shape}: count {count.item()} != {r_count.item()}")
        mx1, av1 = check_close(f"K5 mean {shape} {dtype}", mean, r_mean, rtol=1e-5, atol=0.0)
        mx2, av2 = check_close(f"K5 m2 {shape} {dtype}", m2, r_m2, rtol=1e-4, atol=0.0)
        # a second and third launch: the ticket was reset, and no sum depends on
        # which block merged, so the bits are the same
        for run in (2, 3):
            for name, a, b in zip(("mean", "m2", "count"), channel_moments(feat), (mean, m2, count)):
                check_equal(torch, f"K5 {name} {shape} {dtype}, run {run} against run 1", a, b)
        ms = device_ms(lambda: channel_moments(feat), SMALL_REPS)
        call_ms = time_ms(torch, lambda: channel_moments(feat), reps=SMALL_REPS)
        plain = time_ms(torch, lambda: channel_moments_reference(feat), reps=20, runs=3)
        # the one PyTorch call with K5's function (mean and M2 / count), timed
        # like K5 from a replayed graph; for comparison only
        library = device_ms(lambda: torch.var_mean(feat, dim=(0, 1, 2), correction=0),
                            SMALL_REPS)
        # one read of the tensor, a few float32 operations an element
        bd = bound(6 * feat.numel(), F32_PEAK_TFLOPS, feat.numel() * feat.element_size())
        results["K5"].append(dict(shape=list(shape), dtype=str(dtype), max_abs_err=max(mx1, mx2),
                                  mean_max_abs_err=mx1, m2_max_abs_err=mx2, ms=ms, call_ms=call_ms,
                                  plain_ms=plain, library_ms=library, empty_launch_ms=empty_ms,
                                  **bd))
        print(f"K5 moments {shape} {dtype}: mean max {mx1:.3e} avg {av1:.3e}, "
              f"m2 max {mx2:.3e} avg {av2:.3e}, three runs the same bits "
              f"| kernel {ms:.4f} ms on the device (CUDA graph of {SMALL_REPS} launches), "
              f"{call_ms:.4f} ms a call; bound {bd['bound_ms']:.4f} ms by {bd['bound_by']} "
              f"({100 * bd['bound_ms'] / ms:.1f}% reached; empty launch "
              f"{100 * empty_ms / ms:.1f}% of it) plain {plain:.4f} ms; torch.var_mean "
              f"{library:.4f} ms ({library / ms:.2f}x the kernel)")

    # ragged edges, correctness only: channels off the 128-byte group, one
    # pixel (K5 only: its variance is 0 / max(1 - ddof, 1)), bf16 rows that are
    # not 16-byte aligned (C = 500 and 100), two banks, the population variance
    for shape, dtype in (((2, 7, 9, 100), torch.float32), ((1, 1, 1, 16), torch.float32),
                         ((2, 5, 11, 500), torch.bfloat16), ((1, 33, 35, 100), torch.bfloat16)):
        feat = (torch.randn(shape, generator=gen) + 3).to(dev, dtype)
        s_means = torch.randn((2, shape[-1]), generator=gen).to(dev)
        s_stds = (torch.rand((2, shape[-1]), generator=gen) + 0.5).to(dev)
        tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
        if shape[1] * shape[2] > 1:
            check_close(f"K4 edge {shape}", fused_adain(feat, s_means[0], s_stds[0], 0.6),
                        fused_adain_reference(feat, s_means[0], s_stds[0], 0.6), **tol)
            check_close(f"K4 edge {shape} S=2 ddof=0",
                        fused_adain_multi(feat, s_means, s_stds, 0.6, ddof=0),
                        fused_adain_multi_reference(feat, s_means, s_stds, 0.6, ddof=0), **tol)
        for got, want in zip(channel_moments(feat), channel_moments_reference(feat)):
            check_close(f"K5 edge {shape}", got, want, rtol=1e-4, atol=1e-5)
    torch.cuda.synchronize()
    print("edge shapes: K4, K5 agree with their plain versions")


def int8_layer(torch, gen, cin, cout, requant, dev):
    """Seeded random int8 weights and epilogue terms that spread y over about
    +-100, as a QConvS on ``dev``."""
    from ccst_tpu_torch.kernels.qconv import make_qconv

    wq = torch.randint(-127, 128, (3, 3, cin, cout), generator=gen, dtype=torch.int8)
    acc_std = 127 * 73 * math.sqrt(9 * cin)
    k = (torch.rand((cout,), generator=gen) + 0.5) * 40 / acc_std
    kb = torch.randn((cout,), generator=gen) * 10
    return make_qconv(wq.numpy(), k.numpy(), kb.numpy(), False, requant, dev)


def int8_input(torch, gen, shape, dev):
    """Seeded int8 in [-127, 127], drawn where ``gen`` lives."""
    x = torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8, device=gen.device)
    return x.to(dev)


def check_int8_kernels(torch, dev, gen, results):
    """Phase 3, int8 part: K0, K1, K2 bit for bit against their plain
    versions at the 512 px shapes, with times; then the ragged shapes."""
    from ccst_tpu_torch.benchmarks.small_kernels import graph_ms
    from ccst_tpu_torch.kernels.level1 import (
        decoder_level1,
        decoder_level1_reference,
        encoder_level1,
        encoder_level1_reference,
        prepare_decoder_level1,
        prepare_encoder_level1,
    )
    from ccst_tpu_torch.kernels.qconv import qconv3x3_s8, qconv3x3_s8_reference

    def k0_pair(x, q, relu, pad):
        kernel = lambda: qconv3x3_s8(x, q, relu, torch.bfloat16, pad)
        plain = lambda: qconv3x3_s8_reference(x, q.wq, q.k, q.kb, relu, q.requant,
                                              torch.bfloat16, pad)
        return kernel, plain

    for layer, (n, h, w, cin, cout), pad, requant, relu in K0_SHAPES:
        x = int8_input(torch, gen, (n, h, w, cin), dev)
        q = int8_layer(torch, gen, cin, cout, requant, dev)
        kernel, plain = k0_pair(x, q, relu, pad)
        got = kernel()
        torch.cuda.synchronize()
        want = plain()
        check_equal(torch, f"K0 {layer} {(n, h, w, cin, cout)}", got, want)
        if requant and len(torch.unique(got)) < 20:
            fail(f"K0 {layer}: outputs do not spread, the comparison would say little")
        ms = time_ms(torch, kernel)
        plain_ms = time_ms(torch, plain, reps=2, runs=3)
        tops = 2 * n * h * w * 9 * cin * cout / (ms * 1e-3) / 1e12
        bd = conv_bound((n, h, w, cin, cout), INT8_PEAK_TOPS, 1, 1 if requant else 2)
        row = dict(layer=layer, shape=[n, h, w, cin, cout], pad=pad, requant=requant, relu=relu,
                   max_abs_err=0.0, ms=ms, plain_ms=plain_ms, tops=tops,
                   peak_share=tops / INT8_PEAK_TOPS, **bd)
        line = (f"K0 qconv {layer} {(n, h, w, cin, cout)} {pad} "
                f"{'requant' if requant else 'dequant bf16'} relu={relu}: bit-exact "
                f"| kernel {ms:.4f} ms ({tops:.1f} TOPS, {100 * tops / INT8_PEAK_TOPS:.1f}% "
                f"of {INT8_PEAK_TOPS:.0f}) bound {bd['bound_ms']:.4f} ms by {bd['bound_by']} "
                f"({100 * bd['bound_ms'] / ms:.1f}% reached) plain f64 {plain_ms:.4f} ms")
        if ms < GRAPH_BELOW_MS:
            row["graph_ms"] = graph_ms(torch, kernel, 20, 5)["median"]
            line += f"; graph {row['graph_ms']:.4f} ms"
        results["K0"].append(row)
        print(line)

    for (n, h, w, cin, cout), pad, requant, relu in K0_EDGE:
        x = int8_input(torch, gen, (n, h, w, cin), dev)
        q = int8_layer(torch, gen, cin, cout, requant, dev)
        kernel, plain = k0_pair(x, q, relu, pad)
        got = kernel()
        torch.cuda.synchronize()
        check_equal(torch, f"K0 edge {(n, h, w, cin, cout)} {pad}", got, plain())

    for tag, (n, hb, wb) in (("main", (4, 256, 256)), *(("edge", s) for s in LEVEL1_EDGE)):
        c1, c2 = int8_layer(torch, gen, 12, 256, True, dev), int8_layer(torch, gen, 256, 256, True, dev)
        x = int8_input(torch, gen, (n, hb, wb, 12), dev)
        lw = prepare_encoder_level1(c1, c2)  # packed once, as the engine keeps it
        got = encoder_level1(x, c1, c2, lw)
        torch.cuda.synchronize()
        check_equal(torch, f"K1 {tag} {(n, hb, wb, 12)}", got, encoder_level1_reference(x, c1, c2))
        d2, d1 = int8_layer(torch, gen, 64, 256, True, dev), int8_layer(torch, gen, 256, 12, False, dev)
        y = int8_input(torch, gen, (n, hb, wb, 64), dev)
        dw = prepare_decoder_level1(d2, d1)  # packed once, as the decoder's prep keeps it
        got2 = decoder_level1(y, d2, d1, torch.bfloat16, dw)
        torch.cuda.synchronize()
        check_equal(torch, f"K2 {tag} {(n, hb, wb, 64)}", got2,
                    decoder_level1_reference(y, d2, d1, torch.bfloat16))
        if tag != "main":
            continue
        if len(torch.unique(got)) < 20:
            fail("K1: outputs do not spread, the comparison would say little")
        # per packed pixel: the chain's MACs, the bytes in and out, the weights' bytes
        k1_macs, k2_macs = 108 * 256 + 2304 * 256, 576 * 256 + 2304 * 12
        ms = time_ms(torch, lambda: encoder_level1(x, c1, c2, lw))
        plain_ms = time_ms(torch, lambda: encoder_level1_reference(x, c1, c2), reps=2, runs=3)
        tops = 2 * n * hb * wb * k1_macs / (ms * 1e-3) / 1e12
        bd = bound(2 * n * hb * wb * k1_macs, INT8_PEAK_TOPS, n * hb * wb * (12 + 64) + k1_macs)
        results["K1"].append(dict(shape=[n, hb, wb, 12], max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                                  tops=tops, **bd))
        print(f"K1 level1 {(n, hb, wb)} packed: bit-exact | kernel {ms:.4f} ms "
              f"({tops:.1f} TOPS of the unfused chain's MACs) bound {bd['bound_ms']:.4f} ms by "
              f"{bd['bound_by']} ({100 * bd['bound_ms'] / ms:.1f}% reached) "
              f"plain f64 chain {plain_ms:.4f} ms")
        del x, got

        # K2 and the two K0 launches it replaces in int8-fused (folded dconv1_2 with
        # requant, packed dconv1_1 with dequant, the int8 intermediate between
        # them), both on the device from a replayed CUDA graph, at each batch
        def k0_chain(t):
            z = qconv3x3_s8(t, d2, True, torch.bfloat16, "edge")
            return qconv3x3_s8(z, d1, False, torch.bfloat16, "edge")

        for nb in K2_BATCHES:
            yb = y if nb == n else int8_input(torch, gen, (nb, hb, wb, 64), dev)
            kernel = lambda: decoder_level1(yb, d2, d1, torch.bfloat16, dw)
            if nb != n:
                got_b = kernel()
                check_equal(torch, f"K2 {(nb, hb, wb, 64)} vs the K0 chain", got_b, k0_chain(yb))
                # the K0 chain is a kernel too: the last images also against the plain version
                check_equal(torch, f"K2 {(nb, hb, wb, 64)} images {nb - n}..{nb - 1}", got_b[nb - n:],
                            decoder_level1_reference(yb[nb - n:], d2, d1, torch.bfloat16))
                del got_b
            reps, runs = (20, 5) if nb <= 4 else (5, 3)
            ms = graph_ms(torch, kernel, reps, runs)["median"]
            chain_ms = graph_ms(torch, lambda: k0_chain(yb), reps, runs)["median"]
            row = dict(shape=[nb, hb, wb, 64], max_abs_err=0.0, ms=ms, replaces_chain_ms=chain_ms,
                       library_ms=None,
                       **bound(2 * nb * hb * wb * k2_macs, INT8_PEAK_TOPS,
                               nb * hb * wb * (64 + 2 * 12) + k2_macs))
            row["tops"] = 2 * nb * hb * wb * k2_macs / (ms * 1e-3) / 1e12
            row["plain_ms"] = time_ms(
                torch, lambda: decoder_level1_reference(yb, d2, d1, torch.bfloat16), reps=2, runs=3)
            line = f"; plain f64 chain {row['plain_ms']:.4f} ms"
            if nb == n:
                row["call_ms"] = time_ms(torch, kernel)
                line = f", {row['call_ms']:.4f} ms a call from the host" + line
            results["K2"].append(row)
            print(f"K2 level1 {(nb, hb, wb)} packed: bit-exact | kernel {ms:.4f} ms on the device "
                  f"(CUDA graph of {reps}; {row['tops']:.1f} TOPS of the unfused chain's MACs) bound "
                  f"{row['bound_ms']:.4f} ms by {row['bound_by']} "
                  f"({100 * row['bound_ms'] / ms:.1f}% reached); the two K0 launches it "
                  f"replaces {chain_ms:.4f} ms (K2 is {chain_ms / ms:.2f}x)" + line)
            del yb
    torch.cuda.synchronize()
    print("edge shapes: K0, K1, K2 equal their plain versions")


def check_new_modes(torch, dev, gen, results):
    """Phase 3, the modes the packed and dynamic int8 engines add: K3 with
    edge padding at the packed level-1 shapes, bf16 (rtol = atol = 1e-2) and
    float32 (1e-4, TF32 off), each timed beside cuDNN's conv on an input
    edge-padded beforehand; K0 dequantizing with k = w_scale * a_scale, the
    product formed on the device as vgg_fast._qconv_apply forms it, at every
    shape of the int8 engine, bit for bit; each with its bound; then ragged
    shapes."""
    from ccst_tpu_torch.benchmarks.small_kernels import graph_ms
    from ccst_tpu_torch.kernels.conv import prepare_conv, reflect_conv3x3, reflect_conv3x3_reference
    from ccst_tpu_torch.kernels.qconv import make_qconv, qconv3x3_s8, qconv3x3_s8_reference

    for dtype, tol, peak, reps in ((torch.bfloat16, BF16_TOL, BF16_PEAK_TFLOPS, (10, 5)),
                                   (torch.float32, K3_F32_TOL, F32_PEAK_TFLOPS, (3, 3))):
        esize = 2 if dtype == torch.bfloat16 else 4
        for layer, (n, h, w, cin, cout), relu in K3_EDGE_SHAPES:
            x = torch.randn((n, h, w, cin), generator=gen).to(dev, dtype)
            spread = (1.0 / (9 * cin)) ** 0.5
            wt = (torch.rand((3, 3, cin, cout), generator=gen) * 2 - 1) * spread
            b = (torch.rand((cout,), generator=gen) * 2 - 1) * spread
            cw = prepare_conv(wt, b, dtype, dev)
            kernel = lambda: reflect_conv3x3(x, cw, relu, "edge")
            plain = lambda: reflect_conv3x3_reference(x, cw.w, cw.b, relu, "edge")
            got = kernel()
            torch.cuda.synchronize()
            mx, mean = check_close(f"K3 edge {dtype} {(n, h, w, cin, cout)}", got, plain(), **tol)
            ms = time_ms(torch, kernel, *reps)
            plain_ms = time_ms(torch, plain, reps=2, runs=3)
            torch.backends.cudnn.benchmark = dtype == torch.bfloat16
            lib = time_ms(torch, cudnn_bf16_conv(torch, x, cw, "edge"), *reps)
            torch.backends.cudnn.benchmark = False
            bd = conv_bound((n, h, w, cin, cout), peak, esize, esize)
            flop = 2 * n * h * w * 9 * cin * cout
            cudnn_key = "cudnn_bf16_ms" if dtype == torch.bfloat16 else "cudnn_f32_ms"
            row = dict(layer=layer, shape=[n, h, w, cin, cout], pad="edge", relu=relu,
                       dtype=str(dtype), max_abs_err=mx, mean_abs_err=mean, ms=ms,
                       plain_ms=plain_ms, **{cudnn_key: lib}, **bd)
            line = (f"K3 conv edge {dtype} {layer} {(n, h, w, cin, cout)}: max {mx:.3e} mean "
                    f"{mean:.3e} | kernel {ms:.4f} ms ({flop / (ms * 1e-3) / 1e12:.1f} TFLOP/s) "
                    f"bound {bd['bound_ms']:.4f} ms by {bd['bound_by']} "
                    f"({100 * bd['bound_ms'] / ms:.1f}% reached) cuDNN on an edge-padded input "
                    f"{lib:.4f} ms plain {plain_ms:.4f} ms")
            if ms < GRAPH_BELOW_MS:
                row["graph_ms"] = graph_ms(torch, kernel, 20, 5)["median"]
                line += f"; graph {row['graph_ms']:.4f} ms"
            results["K3"].append(row)
            print(line)
            del x, got

    for layer, (n, h, w, cin, cout), pad, relu in K0_DYNAMIC_SHAPES:
        x = int8_input(torch, gen, (n, h, w, cin), dev)
        wq = torch.randint(-127, 128, (3, 3, cin, cout), generator=gen, dtype=torch.int8)
        w_scale = (torch.rand((cout,), generator=gen) + 0.5) / 127.0
        q = make_qconv(wq.numpy(), w_scale.numpy(), (torch.randn((cout,), generator=gen)).numpy(),
                       False, False, dev)
        # a 0-d float32 scale on the device, as _quantize_act leaves it: with
        # |acc| ~ 73 * sqrt(9 Cin) * 127 it puts y over about +-10
        a_scale = torch.tensor(10.0 / (73 * math.sqrt(9 * cin)), device=dev)
        q = q._replace(k=q.k * a_scale)
        kernel = lambda: qconv3x3_s8(x, q, relu, torch.bfloat16, pad)
        plain = lambda: qconv3x3_s8_reference(x, q.wq, q.k, q.kb, relu, False, torch.bfloat16,
                                              pad)
        got = kernel()
        torch.cuda.synchronize()
        check_equal(torch, f"K0 dynamic {layer} {(n, h, w, cin, cout)}", got, plain())
        if len(torch.unique(got)) < 20:
            fail(f"K0 dynamic {layer}: outputs do not spread, the comparison would say little")
        ms = time_ms(torch, kernel)
        plain_ms = time_ms(torch, plain, reps=2, runs=3)
        tops = 2 * n * h * w * 9 * cin * cout / (ms * 1e-3) / 1e12
        bd = conv_bound((n, h, w, cin, cout), INT8_PEAK_TOPS, 1, 2)
        row = dict(layer=layer, shape=[n, h, w, cin, cout], pad=pad, requant=False, relu=relu,
                   scale="dynamic", max_abs_err=0.0, ms=ms, plain_ms=plain_ms, tops=tops,
                   peak_share=tops / INT8_PEAK_TOPS, **bd)
        line = (f"K0 qconv dynamic {layer} {(n, h, w, cin, cout)} {pad} dequant bf16 relu={relu}, "
                f"k = w_scale * a_scale on the device: bit-exact | kernel {ms:.4f} ms "
                f"({tops:.1f} TOPS) bound "
                f"{bd['bound_ms']:.4f} ms by {bd['bound_by']} "
                f"({100 * bd['bound_ms'] / ms:.1f}% reached) plain f64 {plain_ms:.4f} ms")
        if ms < GRAPH_BELOW_MS:
            row["graph_ms"] = graph_ms(torch, kernel, 20, 5)["median"]
            line += f"; graph {row['graph_ms']:.4f} ms"
        results["K0"].append(row)
        print(line)
        del x, got

    # ragged edges, correctness only: K3 edge mode on one row and one column
    # (no reflect there), an odd plane with Cout = 12 and the Cin = 12 gather, in
    # both types; K0 with a dynamic k on the Cin = 12 gather route and the
    # narrow tile, float32 output
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, K3_F32_TOL)):
        for (n, h, w, cin, cout) in ((1, 1, 19, 16, 64), (2, 9, 1, 64, 12), (3, 17, 9, 256, 12),
                                     (2, 7, 33, 12, 256)):
            x = torch.randn((n, h, w, cin), generator=gen).to(dev, dtype)
            cw = prepare_conv(torch.randn((3, 3, cin, cout), generator=gen) * 0.1,
                              torch.randn((cout,), generator=gen), dtype, dev)
            got = reflect_conv3x3(x, cw, True, "edge")
            torch.cuda.synchronize()
            check_close(f"K3 edge {dtype} {(n, h, w, cin, cout)}", got,
                        reflect_conv3x3_reference(x, cw.w, cw.b, True, "edge"), **tol)
    for (n, h, w, cin, cout), pad in (((2, 7, 9, 12, 256), "edge"), ((3, 17, 9, 256, 12), "edge"),
                                      ((2, 37, 53, 64, 128), "reflect")):
        x = int8_input(torch, gen, (n, h, w, cin), dev)
        q = make_qconv(torch.randint(-127, 128, (3, 3, cin, cout), generator=gen,
                                     dtype=torch.int8).numpy(),
                       ((torch.rand((cout,), generator=gen) + 0.5) / 127.0).numpy(),
                       torch.randn((cout,), generator=gen).numpy(), False, False, dev)
        q = q._replace(k=q.k * torch.tensor(0.003, device=dev))
        got = qconv3x3_s8(x, q, False, torch.float32, pad)
        torch.cuda.synchronize()
        check_equal(torch, f"K0 dynamic edge {(n, h, w, cin, cout)} {pad}", got,
                    qconv3x3_s8_reference(x, q.wq, q.k, q.kb, False, False, torch.float32, pad))
    torch.cuda.synchronize()
    print("edge shapes: K3 edge mode and K0 with a dynamic k agree with their plain versions")


def check_ab_kernels(torch, dev, cpu_gen, results):
    """Phase 3, A/B part: B1, B2 (direct, Winograd in its three modes) and B3
    (F9, F3) bit for bit against their plain versions at the harnesses'
    full-width shapes, with times; then ragged shapes."""
    import numpy as np

    from ccst_tpu_torch import benchmarks as bm
    from ccst_tpu_torch.benchmarks.int8_mm import VARIANTS
    from ccst_tpu_torch.benchmarks.small_kernels import graph_ms
    from ccst_tpu_torch.kernels import winograd as wg
    from ccst_tpu_torch.kernels.int8_mm import prepare_mm_weight, tiled_mm, tiled_mm_reference
    from ccst_tpu_torch.kernels.level1 import phase_max
    from ccst_tpu_torch.kernels.pool_conv import (
        pool_conv_fused,
        pool_conv_reference,
        prepare_pool_conv,
    )
    from ccst_tpu_torch.kernels.qconv import qconv3x3_s8

    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev).manual_seed(1)  # the big inputs are drawn on the card
    for m, k, n in [*((B1_M, k, n) for k, n in B1_SHAPES), *B1_EDGE]:
        xi = int8_input(torch, gen, (m, k), dev)
        wi = int8_input(torch, gen, (k, n), dev)
        for name, in_dtype, out_dtype in VARIANTS:
            x, w = xi.to(in_dtype), wi.to(in_dtype)
            mw = prepare_mm_weight(w)
            got = tiled_mm(x, mw, out_dtype)
            torch.cuda.synchronize()
            check_equal(torch, f"B1 {name} {(m, k, n)}", got, tiled_mm_reference(x, w, out_dtype))
            if m != B1_M:
                continue
            ms = time_ms(torch, lambda: tiled_mm(x, mw, out_dtype))
            plain_ms = time_ms(torch, lambda: tiled_mm_reference(x, w, out_dtype), reps=2, runs=3)
            tops = 2 * m * k * n / (ms * 1e-3) / 1e12
            peak = bm.BF16_PEAK_TFLOPS if name == "bf16" else bm.INT8_PEAK_TOPS
            row = dict(shape=[m, k, n], variant=name, max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                       tops=tops, peak_share=tops / peak,
                       **bound(2 * m * k * n, peak, (m * k + k * n) * x.element_size() + 4 * m * n))
            line = (f"B1 tiled_mm {name} {(m, k, n)}: bit-exact | kernel {ms:.4f} ms "
                    f"({tops:.1f} TOPS, {100 * row['peak_share']:.1f}% of peak) bound "
                    f"{row['bound_ms']:.4f} ms by {row['bound_by']} "
                    f"({100 * row['bound_ms'] / ms:.1f}% reached) plain f64 {plain_ms:.4f} ms")
            # the library's call for the same function, for comparison only: not the port
            if name == "i8i32":
                row["library_ms"] = time_ms(torch, lambda: torch._int_mm(x, w))
                line += f" torch._int_mm {row['library_ms']:.4f} ms"
            elif name == "bf16":
                row["library_ms"] = time_ms(torch, lambda: torch.mm(x, w, out_dtype=torch.float32))
                # writes bf16, half the kernel's output bytes: not the same function
                row["cublas_bf16_out_ms"] = time_ms(torch, lambda: torch.matmul(x, w))
                line += (f" torch.mm f32 out {row['library_ms']:.4f} ms "
                         f"(bf16 out {row['cublas_bf16_out_ms']:.4f} ms)")
            results["B1"].append(row)
            print(line)

    for (n, h, w, cin, cout) in (B2_MAIN, *B2_EDGE):
        x = int8_input(torch, gen, (n, h, w, cin), dev)
        wq = rng.integers(-127, 128, (3, 3, cin, cout)).astype(np.int8)
        uq, _ = wg.wino_weights(wq)
        k_dir = (rng.uniform(0.5, 1.5, cout) * 40 / (127 * 73 * math.sqrt(9 * cin))).astype(np.float32)
        k_wino = (rng.uniform(0.5, 1.5, cout) * 40 / (127 * 73 * math.sqrt(16 * cin))).astype(np.float32)
        kb = (rng.standard_normal(cout) * 10 + 40).astype(np.float32)
        c = wg.make_wino_conv(wq, uq, k_dir, k_wino, kb, dev)
        cases = [("B2-direct", "direct", lambda: wg.conv_direct(x, c),
                  lambda: wg.conv_direct_reference(x, c))]
        cases += [("B2-wino", mode, lambda m=mode: wg.conv_wino(x, c, m),
                   lambda m=mode: wg.conv_wino_reference(x, c, m))
                  for mode in wg.MODES if mode != "tf" or cout <= cin]
        main = (n, h, w, cin, cout) == B2_MAIN
        if main:  # the production conv at the same shape: the A/B's yardstick
            k0_ms = graph_ms(torch, lambda: qconv3x3_s8(x, c.direct, True, torch.int8, "edge"),
                             10, 5)["median"]
        for kid, mode, kernel, plain in cases:
            got = kernel()
            torch.cuda.synchronize()
            check_equal(torch, f"{kid} {mode} {(n, h, w, cin, cout)}", got, plain())
            if not main:
                continue
            if mode in ("direct", "full") and len(torch.unique(got)) < 20:
                fail(f"{kid} {mode}: outputs do not spread, the comparison would say little")
            ms = graph_ms(torch, kernel, 10, 5)["median"]
            plain_ms = time_ms(torch, plain, reps=2, runs=3)
            tops = 2 * n * h * w * 9 * cin * cout / (ms * 1e-3) / 1e12
            results[kid].append(dict(shape=[n, h, w, cin, cout], mode=mode, max_abs_err=0.0,
                                     ms=ms, plain_ms=plain_ms, tops=tops, k0_ms=k0_ms))
            # Winograd F(2x2, 3x3) multiplies 16 positions per 2 x 2 outputs, not 36
            bd = conv_bound((n, h, w, cin, cout), INT8_PEAK_TOPS, 1, 1)
            if kid == "B2-wino":
                bd = bound(2 * n * h * w * 4 * cin * cout, INT8_PEAK_TOPS,
                           n * h * w * (cin + cout) + 16 * cin * cout)
            results[kid][-1].update(bd)
            print(f"{kid} {mode} {(n, h, w, cin, cout)}: bit-exact | kernel {ms:.4f} ms on the "
                  f"device (CUDA graph of 10; {tops:.1f} direct-conv TOPS) bound "
                  f"{bd['bound_ms']:.4f} ms by {bd['bound_by']} "
                  f"({100 * bd['bound_ms'] / ms:.1f}% reached); K0 at the same shape {k0_ms:.4f} "
                  f"ms ({k0_ms / ms:.2f}x the kernel); plain f64 {plain_ms:.4f} ms")

    for (n, hb, wb) in (B3_MAIN, *B3_EDGE):
        xp = torch.randint(-5, 120, (n, hb, wb, 256), generator=gen, dtype=torch.int8, device=dev)
        q = int8_layer(torch, cpu_gen, 64, 128, True, dev)
        wp = prepare_pool_conv(q)  # packed once, as the harness keeps it
        plain = lambda: torch.cat([pool_conv_reference(xp[i:i + 16], q) for i in range(0, n, 16)])
        want = plain()
        if (n, hb, wb) == B3_MAIN:  # the unfused chain the fused kernel stands against
            chain = lambda: qconv3x3_s8(phase_max(xp, 64), q, True, torch.int8, "reflect")
            check_equal(torch, f"B3 unfused chain {(n, hb, wb, 256)}", chain(), want)
            chain_ms = time_ms(torch, chain, reps=5, runs=3)
        for tag, cat in (("F9", False), ("F3", True)):
            got = pool_conv_fused(xp, q, cat, wp)
            torch.cuda.synchronize()
            check_equal(torch, f"B3 {tag} {(n, hb, wb, 256)}", got, want)
            if (n, hb, wb) != B3_MAIN:
                continue
            if len(torch.unique(got)) < 20:
                fail(f"B3 {tag}: outputs do not spread, the comparison would say little")
            ms = time_ms(torch, lambda c=cat: pool_conv_fused(xp, q, c, wp))
            plain_ms = time_ms(torch, plain, reps=1, runs=3)
            tops = 2 * n * hb * wb * 576 * 128 / (ms * 1e-3) / 1e12
            bd = bound(2 * n * hb * wb * 576 * 128, INT8_PEAK_TOPS,
                       n * hb * wb * (256 + 128) + 576 * 128)
            results["B3"].append(dict(shape=[n, hb, wb, 256], variant=tag, cat=cat, max_abs_err=0.0,
                                      ms=ms, plain_ms=plain_ms, tops=tops,
                                      replaces_chain_ms=chain_ms, **bd))
            print(f"B3 pool_conv {tag} {(n, hb, wb, 256)}: bit-exact | kernel {ms:.4f} ms "
                  f"({tops:.1f} TOPS) bound {bd['bound_ms']:.4f} ms by {bd['bound_by']} "
                  f"({100 * bd['bound_ms'] / ms:.1f}% reached); the unfused chain (phase max + K0) "
                  f"{chain_ms:.4f} ms ({chain_ms / ms:.2f}x); plain (phase max + f64 conv) "
                  f"{plain_ms:.4f} ms")
        del want
    for (n, hb, wb, cout) in B3_EDGE_COUT:
        xp = torch.randint(-5, 120, (n, hb, wb, 256), generator=gen, dtype=torch.int8, device=dev)
        q = int8_layer(torch, cpu_gen, 64, cout, True, dev)
        want = pool_conv_reference(xp, q)
        for tag, cat in (("F9", False), ("F3", True)):
            got = pool_conv_fused(xp, q, cat)
            torch.cuda.synchronize()
            check_equal(torch, f"B3 {tag} {(n, hb, wb, 256)} -> Cout {cout}", got, want)
    torch.cuda.synchronize()
    print("edge shapes: B1, B2, B3 (every output-channel tile) equal their plain versions")


# -- the training stage (phase 7) ----------------------------------------------

FED_NET, FED_BATCH, FED_SIZE, FED_CLASSES = "resnet50", 32, 222, 7  # FedConfig's widths, PACS
FED_FUSION = "adain-overall-K3"
FED_CONCURRENT = 4          # phase 7's one-round CLI runs at a time on the card
FED_LOSS_RTOL = 1e-4        # one local step's loss, card against CPU
# a leaf's update on the card against the CPU's float64 step: median |d_card - d_64| at most
# max(FED_DELTA_MEDIAN, FED_F32_FACTOR x the CPU float32 step's own distance) of max |d_64|.
# The ReLU-tie rule alone (1e-3 of max |d|) is below float32's resolution for ResNet-50's BN
# leaves at batch 32, whose gradients cancel: on this script's batch the CPU's own float32 step
# misses it against its float64 step on 156 of 267 leaves (the card's step on the same 156)
FED_DELTA_MEDIAN = 1e-3
FED_F32_FACTOR = 2.0
FED_LOGITS_ATOL = 5e-4      # train-mode logits of ResNet-50 against the CPU's float64 (seen 3.0e-5)
# one local step on the card against the port's CPU path: ResNet-50 with
# fedavg and fedprox, each DG plugin at ResNet-18 width (fedavg)
FED_STEP_CASES = (("resnet50", "no_DG", "fedavg"), ("resnet50", "no_DG", "fedprox"),
                  ("resnet18", "RSC", "fedavg"), ("resnet18", "Jigsaw", "fedavg"),
                  ("resnet18", "MixStyle", "fedavg"), ("resnet18", "feddg", "fedavg"))


def fed_batch(torch, root, dev, dtype):
    """The first FED_BATCH entries of cartoon's K3 list at FED_SIZE (uint8), as
    the runner hands them to a step on ``dev``, in ``dtype``."""
    from ccst_tpu_torch.data.lists import parse_list, train_list_path
    from ccst_tpu_torch.data.loader import ImageBatchLoader

    names, labels = parse_list(train_list_path(root, "pacs", "cartoon", fusion_dir=FED_FUSION,
                                               target="photo"))
    loader = ImageBatchLoader([os.path.join(root, n) for n in names[:FED_BATCH]],
                              labels[:FED_BATCH], batch_size=FED_BATCH, image_size=FED_SIZE,
                              out_dtype="uint8")
    batch = next(iter(loader))
    images = (torch.from_numpy(batch.images).to(dev).to(dtype)
              / torch.full((), 255.0, device=dev, dtype=dtype))
    return {"images": images, "labels": torch.from_numpy(batch.labels.astype("int64")).to(dev),
            "mask": torch.ones(FED_BATCH, device=dev, dtype=dtype)}


def check_fed_steps(torch, dev, root, bank):
    """Tentpole C.1: one local step on the card against the port's CPU path
    (float32, and float64 as the reference of both), from the same state with
    the same drawn crops and flips (the draws come from a host generator
    seeded alike)."""
    from ccst_tpu_torch.federated.train_ops import forward, make_train_step
    from ccst_tpu_torch.models.classifiers import get_network, init_weights
    from ccst_tpu_torch.ops.image import train_transform

    cpu, f32, f64 = torch.device("cpu"), torch.float32, torch.float64
    runs = ((dev, f32), (cpu, f32), (cpu, f64))
    batches = {run: fed_batch(torch, root, *run) for run in runs}
    report, failures = {}, []
    for net, dg, mode in FED_STEP_CASES:
        tag = f"{net} {dg} {mode}"
        model = init_weights(get_network(net, FED_CLASSES, dg), torch.Generator().manual_seed(0))
        state = {k: v.detach().clone() for k, v in model.state_dict().items()}
        noise = torch.Generator().manual_seed(1)
        server = {k: (v + 0.01 * torch.randn(v.shape, generator=noise)) if v.is_floating_point()
                  else v.clone() for k, v in state.items()}
        step = make_train_step(model, n_classes=FED_CLASSES, image_size=FED_SIZE, lr=1e-2,
                               dg_method=dg, mode=mode)
        out = {}
        for d, dt in runs:
            model.to(d, dt)
            cast = lambda t: t.to(d, dt) if t.is_floating_point() else t.to(d)
            bd = dict(batches[d, dt])
            if dg == "feddg":
                bd["amp_bank"] = torch.from_numpy(bank).to(d, dt)
            new, m = step({k: cast(v) for k, v in state.items()},
                          {k: cast(v) for k, v in server.items()}, bd,
                          torch.Generator().manual_seed(7), 1)
            logits = None
            if (net, dg, mode) == FED_STEP_CASES[0]:
                with torch.no_grad():
                    crop = step.draw(torch.Generator().manual_seed(7), bd)["crop"]
                    x = train_transform(crop, bd["images"], FED_SIZE)
                    # copies: the train-mode forward updates the running statistics in place
                    logits = forward(model, {k: cast(v).clone() for k, v in state.items()}, x,
                                     True).double().cpu()
            out[d, dt] = ({k: v.double().cpu() for k, v in new.items()}, float(m.loss), logits)
        (card, l_card, g_card), (c32, l_32, g_32), (c64, l_64, g_64) = (out[r] for r in runs)
        row = {"loss_card": l_card, "loss_cpu32": l_32, "loss_cpu64": l_64,
               "loss_rel_err": abs(l_card - l_32) / abs(l_32)}
        if not math.isfinite(l_card) or row["loss_rel_err"] > FED_LOSS_RTOL:
            failures.append(f"{tag}: loss {l_card} on the card, {l_32} on the CPU")
        leaves = []
        for k, old in state.items():
            if not old.is_floating_point():
                if not torch.equal(card[k], c32[k]):
                    failures.append(f"{tag}: {k} {int(card[k])} != {int(c32[k])}")
                continue
            d64 = c64[k] - old.double()
            scale = d64.abs().max().item()
            if scale == 0.0:
                if (card[k] - old.double()).abs().max().item() != 0.0:
                    failures.append(f"{tag}: {k} moved on the card only")
                continue
            e_card = ((card[k] - c64[k]).abs().median().item()) / scale
            e_cpu = ((c32[k] - c64[k]).abs().median().item()) / scale
            e_pair = ((card[k] - c32[k]).abs().median().item()) / scale
            leaves.append((e_card / max(e_cpu, 1e-30), k, e_card, e_cpu, e_pair))
            if not e_card <= max(FED_DELTA_MEDIAN, FED_F32_FACTOR * e_cpu):
                failures.append(f"{tag}: {k} median |d_card - d_64| {e_card:.3e} of max |d_64| "
                                f"(the CPU's float32 {e_cpu:.3e})")
        leaves.sort(reverse=True)
        row.update(leaves=len(leaves),
                   worst_card_vs_64=max(e for _, _, e, _, _ in leaves),
                   worst_cpu32_vs_64=max(e for _, _, _, e, _ in leaves),
                   worst_card_vs_cpu32=max(e for _, _, _, _, e in leaves),
                   card_vs_cpu32_over_1e3=sum(e > 1e-3 for _, _, _, _, e in leaves),
                   cpu32_vs_64_over_1e3=sum(e > 1e-3 for _, _, _, e, _ in leaves),
                   worst_leaves=[(k, e_card, e_cpu) for _, k, e_card, e_cpu, _ in leaves[:3]])
        if g_card is not None:
            row.update(logits_card_vs_64=(g_card - g_64).abs().max().item(),
                       logits_card_vs_cpu32=(g_card - g_32).abs().max().item(),
                       logits_cpu32_vs_64=(g_32 - g_64).abs().max().item())
            if not row["logits_card_vs_64"] <= FED_LOGITS_ATOL:
                failures.append(f"{tag}: logits {row['logits_card_vs_64']:.3e} off the CPU's "
                                f"float64 > {FED_LOGITS_ATOL}")
        report[tag] = row
        print(f"fed step {tag} ({FED_BATCH} x {FED_SIZE}px, TF32 off): loss card {l_card:.6f} cpu "
              f"float32 {l_32:.6f} float64 {l_64:.6f}; worst leaf median |d - d_64| / max |d_64|: "
              f"card {row['worst_card_vs_64']:.2e}, CPU float32 {row['worst_cpu32_vs_64']:.2e}; "
              f"card vs CPU float32 over 1e-3 on {row['card_vs_cpu32_over_1e3']} of {len(leaves)} "
              f"leaves (CPU float32 vs float64: {row['cpu32_vs_64_over_1e3']}); worst by ratio "
              f"{row['worst_leaves']}"
              + (f"; logits card - float64 {row['logits_card_vs_64']:.2e}, CPU float32 - float64 "
                 f"{row['logits_cpu32_vs_64']:.2e}" if g_card is not None else ""))
    if failures:
        fail("fed steps:\n  " + "\n  ".join(failures[:40]))
    return report


def time_fed_step(torch, dev, root):
    """Tentpole C.3, in this process: one fedavg local step of ResNet-50 at
    batch 32 and 222 px (CUDA events, median of runs after a warm-up) and one
    eval step, and the peak of device memory over them."""
    from ccst_tpu_torch.federated.train_ops import make_eval_step, make_train_step
    from ccst_tpu_torch.models.classifiers import get_network, init_weights
    from ccst_tpu_torch.utils.precision import no_tf32

    model = init_weights(get_network(FED_NET, FED_CLASSES), torch.Generator().manual_seed(0)).to(dev)
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    bd = fed_batch(torch, root, dev, torch.float32)
    step = make_train_step(model, n_classes=FED_CLASSES, image_size=FED_SIZE, lr=1e-2)
    evaluate = make_eval_step(model, image_size=FED_SIZE)
    gen = torch.Generator().manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    holder = [state]

    def one_step():
        holder[0], _ = step(holder[0], state, bd, gen, 0)

    with no_tf32(deterministic=True):  # the runner's mode (F3)
        step_ms = time_ms(torch, one_step, reps=5, runs=5)
        eval_ms = time_ms(torch, lambda: evaluate(holder[0], bd), reps=5, runs=5)
    peak = torch.cuda.max_memory_allocated()
    return {"step_ms": step_ms, "train_img_s": FED_BATCH / (step_ms * 1e-3), "eval_ms": eval_ms,
            "eval_img_s": FED_BATCH / (eval_ms * 1e-3), "max_memory_allocated_bytes": peak}


def run_fed_cli(root, images_per_domain):
    """Tentpole C.2: the chain's training end through the CLI, each run a
    process of its own on the card; returns the fedavg run's round records and
    each run's wall seconds."""
    from ccst_tpu_torch.data.lists import parse_list, test_list_path, train_list_path
    from ccst_tpu_torch.utils.metrics import read_rounds

    # the target's test list: the photo domain's originals
    names, labels = parse_list(train_list_path(root, "pacs", "photo"))
    with open(test_list_path(root, "pacs", "photo"), "w") as f:
        f.writelines(f"{n} {l}\n" for n, l in zip(names, labels))
    out = os.path.join(root, "fed")
    common = ["--dataset", "pacs", "--target", "photo", "--fusion-mode", FED_FUSION,
              "--network", FED_NET, "--list-root", root, "--data-root", root,
              "--save-path", os.path.join(out, "ckpt"), "--log-path", os.path.join(out, "logs"),
              "--device", "cuda"]
    seconds = {}

    def cli(name, *argv):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "ccst_tpu_torch.cli", *argv], cwd=HERE,
                              capture_output=True, text=True, timeout=900)
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"{name} exited {proc.returncode}:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        print(f"{name}: exit 0 in {seconds[name]:.1f} s; {proc.stdout.strip().splitlines()[-1]}")
        return proc.stdout

    def rounds_of(mode, dg="no_DG"):
        log = os.path.join(out, "logs", f"pacs_photo_{mode}_{FED_FUSION}_{dg}_{FED_NET}_seed1.jsonl")
        recs = read_rounds(log)
        for r in recs:
            if r["event"] == "round" and not all(math.isfinite(v) for k, v in r.items()
                                                 if k.startswith("train_loss/")):
                fail(f"fed-train {mode} {dg}: a non-finite loss in {r}")
        return recs

    for d in DOMAINS:
        if d != "photo":
            cli(f"amp-bank {d}", "amp-bank", "--dataset", "pacs", "--domain", d, "--list-root",
                root, "--data-root", root, "--image-size", str(FED_SIZE))
    cli("fed-train fedavg", "fed-train", *common, "--mode", "fedavg", "--rounds", "2",
        "--save-freq", "1")
    # the one-round runs of the other modes and plugins, FED_CONCURRENT at a time on
    # the card: each process spends most of its 17-21 s starting (an H100, one at a time)
    runs = [(f"fed-train {m}", ["--mode", m], (m,)) for m in ("fedbn", "fedprox", "adafea",
                                                               "deepall")]
    runs += [(f"fed-train {dg}", ["--dg-method", dg], ("fedavg", dg))
             for dg in ("RSC", "Jigsaw", "MixStyle", "feddg")]
    for i in range(0, len(runs), FED_CONCURRENT):
        batch = runs[i:i + FED_CONCURRENT]
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, "-m", "ccst_tpu_torch.cli", "fed-train",
                                   *common, *extra, "--rounds", "1"], cwd=HERE, text=True,
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE)
                 for _, extra, _ in batch]
        for (name, _, log), proc in zip(batch, procs):
            out_, err = proc.communicate(timeout=900)
            seconds[name] = time.perf_counter() - t0
            if proc.returncode != 0:
                fail(f"{name} exited {proc.returncode}:\n{out_[-3000:]}\n{err[-3000:]}")
            print(f"{name}: exit 0 in {seconds[name]:.1f} s ({len(batch)} at a time); "
                  f"{out_.strip().splitlines()[-1]}")
            rounds_of(*log)
    printed = cli("fed-train fedavg --resume", "fed-train", *common, "--mode", "fedavg",
                  "--rounds", "3", "--save-freq", "1", "--resume")
    if "[resume] round=2" not in printed:
        fail("fed-train --resume did not start at round 2")
    recs = rounds_of("fedavg")
    rounds = [r for r in recs if r["event"] == "round"]
    if [r["round"] for r in rounds] != [0, 1, 2]:
        fail(f"fed-train fedavg logged rounds {[r['round'] for r in rounds]}, expected 0, 1, 2")
    best = [r for r in recs if r["event"] == "done"][-1]
    tested = json.loads(cli("fed-test best", "fed-test", *common, "--checkpoint", "best")
                        .strip().splitlines()[-1])
    if tested["test_acc"] != best["test_acc"]:
        fail(f"fed-test --checkpoint best printed test_acc {tested['test_acc']}, the log's best "
             f"round {best['round']} recorded {best['test_acc']}")
    print(f"fed-test --checkpoint best: test_acc {tested['test_acc']} = the log's best round "
          f"{best['round']}")
    cli("fed-test --in-test", "fed-test", *common, "--in-test")
    cli("fed-test --tent", "fed-test", *common, "--tent")
    # at least two local steps a client at batch 32 (the K3 lists hold 3 entries an image)
    n_list = 3 * images_per_domain
    if -(-(n_list - int(n_list * 0.1)) // FED_BATCH) < 2:
        fail(f"{images_per_domain} images a domain give each client one local step")
    return rounds, seconds


def run_fed_phase(torch, dev, root, smi, images_per_domain):
    """Phase 7 on phase 4's tree, after its stylize, reorganize and gen-lists
    --k 3 runs: C.2 the CLI chain (``amp-bank`` first), C.1 the local step on
    the card against the CPU, C.3 the card's times. Returns the ``fed`` line."""
    from ccst_tpu_torch.pipeline.amp_bank import load_amp_bank

    t0 = time.perf_counter()
    rounds, seconds = run_fed_cli(root, images_per_domain)
    bank = load_amp_bank(root, "pacs", [d for d in DOMAINS if d != "photo"], max_per_domain=64)
    steps = check_fed_steps(torch, dev, root, bank)
    times = time_fed_step(torch, dev, root)
    print(f"fed step on the card (ResNet-50, {FED_BATCH} x {FED_SIZE}px, float32, TF32 off, "
          "cuDNN deterministic): "
          f"{times['step_ms']:.2f} ms = {times['train_img_s']:.1f} img/s; eval "
          f"{times['eval_ms']:.2f} ms = {times['eval_img_s']:.1f} img/s; peak device memory "
          f"{times['max_memory_allocated_bytes'] / 2**30:.2f} GiB")
    return {"card": smi, "network": FED_NET, "batch": FED_BATCH, "image_size": FED_SIZE,
            "classes": FED_CLASSES, "fusion_mode": FED_FUSION,
            "precision": "float32, TF32 off, cuDNN deterministic",
            **times,
            "round_seconds": [r["seconds"] for r in rounds],
            "round_loader_wait_seconds": [r["loader_wait_seconds"] for r in rounds],
            "loader_wait_share": [r["loader_wait_seconds"] / r["seconds"] for r in rounds],
            "cli_seconds": seconds, "step_checks": steps,
            "phase_seconds": time.perf_counter() - t0}


# -- decoder training and the privacy inversion (phase 8) ----------------------

PRIV_SIZE, PRIV_STEPS = 256, 3          # ccst-tpu's defaults: 256 px
DEC_BATCH, INV_BATCH, GAN_BATCH = 8, 16, 8
FID_SAMPLES = 16
PRIV_SOURCE = "art_painting"
# one train-decoder / inverter step on the card against the CPU's float32 and
# float64 steps: phase 7's rule, as FED_* above
STEP_LOSS_RTOL, STEP_DELTA_MEDIAN, STEP_F32_FACTOR = 1e-4, 1e-3, 2.0
# the style vector (K3 bf16) on the card against the CPU's plain version: bf16's
# 8 bits, sums in another order before the one rounding
Z_REL_TOL = 1e-2
LPIPS_PLAN = ((0, 64), (2, 64), "M", (5, 128), (7, 128), "M", (10, 256), (12, 256), (14, 256),
              "M", (17, 512), (19, 512), (21, 512), "M", (24, 512), (26, 512), (28, 512))


def check_grad_guard(torch, dev):
    """Every kernel wrapper without a backward refuses a CUDA tensor that
    requires grad under grad mode, and runs under no_grad."""
    from ccst_tpu_torch.kernels.adain import fused_adain_multi
    from ccst_tpu_torch.kernels.conv import prepare_conv, reflect_conv3x3
    from ccst_tpu_torch.kernels.moments import channel_moments

    gen = torch.Generator().manual_seed(5)
    cases = []
    for dt in (torch.bfloat16, torch.float32):
        cw = prepare_conv(torch.randn((3, 3, 64, 64), generator=gen) * 0.05,
                          torch.zeros(64), dt, dev)
        cases.append((f"reflect_conv3x3 {dt}", lambda x, cw=cw: reflect_conv3x3(x, cw),
                      (2, 16, 16, 64), dt))
    stats = (torch.zeros((1, 64), device=dev), torch.ones((1, 64), device=dev))
    cases += [("fused_adain_multi", lambda x: fused_adain_multi(x, *stats), (2, 8, 8, 64),
               torch.float32),
              ("channel_moments", channel_moments, (2, 8, 8, 64), torch.float32)]
    for name, fn, shape, dt in cases:
        x = torch.randn(shape, generator=gen).to(dev, dt).requires_grad_()
        try:
            fn(x)
        except RuntimeError as e:
            if "no backward" not in str(e):
                raise
        else:
            fail(f"{name} took a CUDA tensor that requires grad")
        with torch.no_grad():
            fn(x)
    torch.cuda.synchronize()
    print(f"grad guard: {', '.join(n for n, *_ in cases)} raise on a CUDA tensor that requires "
          "grad and run under no_grad")


def privacy_lists(root, images_per_domain):
    """A list root whose ``PRIV_SOURCE`` list pools every domain's images, so
    that the inverter's train split fills batches of ``INV_BATCH``."""
    from ccst_tpu_torch.data.lists import parse_list, train_list_path, write_list

    names, labels = [], []
    for d in DOMAINS:
        n, l = parse_list(train_list_path(root, "pacs", d))
        names += n
        labels += l
    list_root = os.path.join(root, "privacy")
    write_list(train_list_path(list_root, "pacs", PRIV_SOURCE), names, labels)
    if len(names) != len(DOMAINS) * images_per_domain:
        fail(f"privacy list: {len(names)} images")
    return list_root, names


def lpips_files(torch, root):
    """torchvision-layout VGG16 features and LPIPS lin heads, seeded random
    (the published files need the network), saved as the CLI reads them."""
    g = torch.Generator().manual_seed(11)
    vgg16, cin = {}, 3
    for item in LPIPS_PLAN:
        if item == "M":
            continue
        idx, cout = item
        vgg16[f"features.{idx}.weight"] = torch.randn((cout, cin, 3, 3), generator=g) * (
            2.0 / (9 * cin)) ** 0.5
        vgg16[f"features.{idx}.bias"] = torch.randn((cout,), generator=g) * 0.01
        cin = cout
    lin = {f"lin{i}.model.1.weight": torch.rand((1, c, 1, 1), generator=g)
           for i, c in enumerate((64, 128, 256, 512, 512))}
    paths = (os.path.join(root, "lpips_vgg16.pth"), os.path.join(root, "lpips_lin.pth"))
    torch.save(vgg16, paths[0])
    torch.save(lin, paths[1])
    return paths


def priv_images(torch, root, names, n):
    """The first ``n`` listed images at PRIV_SIZE, float32 in [0, 1] (CPU)."""
    from ccst_tpu_torch.data.loader import ImageBatchLoader

    loader = ImageBatchLoader([os.path.join(root, p) for p in names[:n]], batch_size=n,
                              image_size=PRIV_SIZE)
    return torch.from_numpy(next(iter(loader)).images)


def median_rule(tag, start, got, c32, c64, floor, factor):
    """Phase 7's rule for one update: per leaf, median |d_got - d_64| at most
    max(floor, factor x median |d_32 - d_64|) of max |d_64|. Returns
    (failures, {leaf: (e_got, e_32)})."""
    failures, errs = [], {}
    for k, old in start.items():
        if not old.is_floating_point():
            if not bool((got[k] == c32[k]).all()):
                failures.append(f"{tag}: {k} differs")
            continue
        old = old.double()
        d64 = c64[k].double() - old
        scale = d64.abs().max().item()
        if scale == 0.0:
            if (got[k].double() - old).abs().max().item() != 0.0:
                failures.append(f"{tag}: {k} moved where float64 did not")
            continue
        e_got = (got[k].double() - c64[k].double()).abs().median().item() / scale
        e_32 = (c32[k].double() - c64[k].double()).abs().median().item() / scale
        errs[k] = (e_got, e_32)
        if not e_got <= max(floor, factor * e_32):
            failures.append(f"{tag}: {k} median |d - d_64| {e_got:.3e} of max |d_64| (the "
                            f"float32 reference's {e_32:.3e})")
    return failures, errs


def compare_steps(torch, tag, start, outs):
    """Phase 7's rule on one step's ``outs`` = {run: (leaves, loss)} for the runs
    "card", "cpu32", "cpu64" from the float64 ``start`` leaves: the loss within
    STEP_LOSS_RTOL, each leaf's median |d_card - d_64| at most
    max(STEP_DELTA_MEDIAN, STEP_F32_FACTOR x the CPU float32 step's own) of max |d_64|."""
    (card, l_card), (c32, l_32), (c64, l_64) = outs["card"], outs["cpu32"], outs["cpu64"]
    failures = []
    rel = abs(l_card - l_64) / abs(l_64)
    if not math.isfinite(l_card) or rel > STEP_LOSS_RTOL or abs(l_32 - l_64) / abs(l_64) > STEP_LOSS_RTOL:
        failures.append(f"{tag}: loss card {l_card}, CPU float32 {l_32}, float64 {l_64}")
    bad, errs = median_rule(tag, start, card, c32, c64, STEP_DELTA_MEDIAN, STEP_F32_FACTOR)
    failures += bad
    worst = sorted(((e, k, e32) for k, (e, e32) in errs.items()), reverse=True)
    pair = max((card[k] - c32[k]).abs().max().item() / max((c64[k] - old).abs().max().item(),
                                                           1e-30) for k, old in start.items())
    row = {"loss_card": l_card, "loss_cpu32": l_32, "loss_cpu64": l_64, "loss_rel_err": rel,
           "max_card_vs_cpu32": pair,
           "leaves": len(worst), "worst_card_vs_64": worst[0][0],
           "worst_cpu32_vs_64": max(e for _, _, e in worst),
           "worst_leaves": [(k, e, c) for e, k, c in worst[:3]]}
    print(f"{tag} step ({PRIV_SIZE}px, float32, TF32 off): loss card {l_card:.6f} CPU float32 "
          f"{l_32:.6f} float64 {l_64:.6f}; worst leaf median |d - d_64| / max |d_64|: card "
          f"{row['worst_card_vs_64']:.2e}, CPU float32 {row['worst_cpu32_vs_64']:.2e} over "
          f"{len(worst)} leaves; largest |d_card - d_cpu32| {pair:.2e} of max |d_64|")
    return row, failures


def check_privacy_steps(torch, dev, root, names, enc, dec):
    """One train-decoder step and one inverter step (``mse+perceptual``) on the
    card against the same step on the CPU in float32 and float64. The
    inverter's style vectors come from the card (K3 bf16) and feed all three;
    they are held against the CPU's plain version first."""
    from ccst_tpu_torch.models import vgg
    from ccst_tpu_torch.pipeline.train_decoder import DecoderTrainConfig, DecoderTrainer
    from ccst_tpu_torch.privacy.generator import StyleInverter
    from ccst_tpu_torch.privacy.invert import InvertConfig, InverterTrainer, style_vector

    cpu, f32, f64 = torch.device("cpu"), torch.float32, torch.float64
    runs = {"card": (dev, f32, True), "cpu32": (cpu, f32, True), "cpu64": (cpu, f64, False)}
    report, failures = {}, []

    content = priv_images(torch, root, [n for n in names if "/photo/" in n], DEC_BATCH)
    style = priv_images(torch, root, [n for n in names if f"/{PRIV_SOURCE}/" in n], DEC_BATCH)
    cfg = DecoderTrainConfig(lr=1e-4)
    start = {f"{n}/{k}": p.detach() for n, l in vgg.trainable_params(dec, cpu, f64).items()
             for k, p in l.items()}
    outs = {}
    for run, (d, dt, kernel) in runs.items():
        t = DecoderTrainer(cfg, enc, dec, d, dt, kernel=kernel)
        lc, ls = t.step(content.to(d, dt), style.to(d, dt))
        outs[run] = ({f"{n}/{k}": p.detach().double().cpu() for n, l in t.decoder.items()
                      for k, p in l.items()},
                     float(cfg.content_weight * lc + cfg.style_weight * ls))
    report["train-decoder"], bad = compare_steps(torch, "train-decoder", start, outs)
    refs = {"train-decoder": {"start": start, "outs": outs, "content": content, "style": style}}
    failures += bad

    images = priv_images(torch, root, names, INV_BATCH)
    with torch.no_grad():
        z = style_vector(vgg.prepare_params(enc, torch.bfloat16, dev), images.to(dev)).cpu()
        z_cpu = style_vector(vgg.prepare_params(enc, torch.bfloat16, cpu), images)
    torch.cuda.synchronize()
    z_err = ((z - z_cpu).abs().amax(dim=1) / z_cpu.abs().amax(dim=1)).max().item()
    print(f"style vector (K3 bf16, {INV_BATCH} x {PRIV_SIZE}px): card vs CPU plain version "
          f"{z_err:.2e} of each vector's max")
    if not z_err <= Z_REL_TOL:
        failures.append(f"style vector: {z_err:.3e} > {Z_REL_TOL}")
    icfg = InvertConfig(image_size=PRIV_SIZE, loss="mse+perceptual")
    init = StyleInverter(image_size=PRIV_SIZE,
                         generator=torch.Generator().manual_seed(1)).state_dict()
    start = {k: v.double() for k, v in init.items()}
    outs = {}
    for run, (d, dt, kernel) in runs.items():
        model = StyleInverter(image_size=PRIV_SIZE)
        model.load_state_dict(init)
        t = InverterTrainer(icfg, enc, d, dt, kernel=kernel, model=model)
        loss = t.step(images.to(d, dt), z.to(d, dt))
        outs[run] = ({k: v.detach().double().cpu() for k, v in t.model.state_dict().items()},
                     float(loss))
    report["invert-train"], bad = compare_steps(torch, "invert-train", start, outs)
    refs["invert-train"] = {"start": start, "outs": outs, "images": images, "z": z, "init": init}
    report["style_vector_rel_err"] = z_err
    failures += bad
    if failures:
        fail("privacy steps:\n  " + "\n  ".join(failures[:40]))
    return report, refs


def run_privacy_phase(torch, root, run_step, smi, images_per_domain, enc_path, dec_path,
                      stats_dir, enc, dec, dev):
    """Phase 8 on phase 4's tree: the four subcommands through the CLI at
    256 px with exact K3 counts, the grad guard, then the card's steps
    against the CPU's. Returns the ``privacy`` line."""
    t0 = time.perf_counter()
    check_grad_guard(torch, dev)
    list_root, names = privacy_lists(root, images_per_domain)
    lpips_vgg, lpips_lin = lpips_files(torch, root)
    out = os.path.join(root, "privacy_out")
    n_val = max(1, int(len(names) * 0.1))
    n_eval = min(64, len(names))
    batches = lambda n, b: -(-n // b)  # noqa: E731
    common = ["--dataset", "pacs", "--data-root", root, "--image-size", str(PRIV_SIZE),
              "--vgg-weights", enc_path, "--device", "cuda"]
    inv = [*common, "--source", PRIV_SOURCE, "--list-root", list_root, "--out-dir",
           os.path.join(out, "inverter"), "--batch-size", str(INV_BATCH)]
    # K3 a step: train-decoder 9 for the style image's taps + 9 for the
    # content's relu4_1 (float32); invert-train 9 for the style vector (bf16) +
    # 9 for the images' perceptual taps (float32), and 9 a val batch; invert-eval
    # 9 + 18 a batch (style vector, both perceptual sides), --overall 18 a batch;
    # gan-train 9 for each of the real and the fake --fid-samples batch
    steps = (
        ("train-decoder", ["train-decoder", *common, "--list-root", root, "--batch-size",
                           str(DEC_BATCH), "--steps", str(PRIV_STEPS), "--init-decoder", dec_path,
                           "--out-path", os.path.join(out, "decoder.npz")],
         {"K3": 18 * PRIV_STEPS}, DEC_BATCH * PRIV_STEPS),
        ("invert-train", ["invert-train", *inv, "--steps", str(PRIV_STEPS), "--loss",
                          "mse+perceptual"],
         {"K3": 18 * PRIV_STEPS + 9 * batches(n_val, INV_BATCH)}, INV_BATCH * PRIV_STEPS),
        ("invert-eval", ["invert-eval", *inv], {"K3": 27 * batches(n_eval, INV_BATCH)}, n_eval),
        ("invert-eval --overall", ["invert-eval", *inv, "--overall", "--style-stats-dir",
                                   stats_dir], {"K3": 18 * batches(n_eval, INV_BATCH)}, n_eval),
        ("invert-eval --holdout", ["invert-eval", *inv, "--holdout"],
         {"K3": 27 * batches(n_val, INV_BATCH)}, n_val),
        ("invert-eval --lpips", ["invert-eval", *inv, "--lpips-vgg", lpips_vgg, "--lpips-lin",
                                 lpips_lin], {"K3": 27 * batches(n_eval, INV_BATCH)}, n_eval),
        ("gan-train", ["gan-train", *common, "--source", PRIV_SOURCE, "--list-root", list_root,
                       "--out-dir", os.path.join(out, "gan"), "--batch-size", str(GAN_BATCH),
                       "--steps", str(PRIV_STEPS), "--gp-weight", "10", "--attn-res", "32",
                       "--fid-samples", str(FID_SAMPLES), "--log-every", "1"],
         {"K3": 18}, GAN_BATCH * PRIV_STEPS),
    )
    rows = {}
    for name, argv, expect, images in steps:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        printed = json.loads(run_step(name, argv, expect).strip().splitlines()[-1])
        wall = time.perf_counter() - t1
        row = {"seconds": wall, "images": images,
               "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
        if "steps_per_sec" in printed:
            row.update(steps_per_sec=printed["steps_per_sec"], img_per_sec=printed["img_per_sec"])
        else:
            row["img_per_sec"] = images / wall  # the whole CLI call, model setup included
        numbers = [v for k, v in printed.items() if isinstance(v, float)]
        if not numbers or not all(math.isfinite(v) for v in numbers):
            fail(f"{name}: non-finite numbers in {printed}")
        row["printed"] = printed
        rows[name] = row
    # what each wrote
    from ccst_tpu_torch.models.convert import load_decoder

    trained = load_decoder(os.path.join(out, "decoder.npz"))
    if sorted(trained) != sorted(dec) or not all(
            bool(torch.isfinite(p[k]).all()) for p in trained.values() for k in p):
        fail("train-decoder wrote a decoder of another tree or with non-finite values")
    moved = max((trained[n][k] - torch.as_tensor(dec[n][k])).abs().max().item()
                for n in dec for k in ("w", "b"))
    if not 0 < moved <= 2 * 1e-4 * PRIV_STEPS:
        fail(f"train-decoder moved a weight by {moved:.3e} in {PRIV_STEPS} Adam steps of lr 1e-4")
    ev = rows["invert-eval --lpips"]["printed"]
    recon = read_images([os.path.join(ev["recon_dir"], f"recon_{i}.png") for i in range(2)])
    if recon.shape != (2, PRIV_SIZE, PRIV_SIZE, 3) or not 0 < ev["lpips_mean"] < 10:
        fail(f"invert-eval --lpips: {recon.shape} PNGs, lpips {ev.get('lpips_mean')}")
    if rows["invert-eval --holdout"]["printed"]["images"] != n_val:
        fail("invert-eval --holdout scored another count than the val split")
    gan = os.path.join(out, "gan")
    if not all(os.path.exists(os.path.join(gan, f"sample_{i}.png")) for i in range(4)):
        fail("gan-train wrote no samples")
    gp = [json.loads(l)["gp"] for l in open(os.path.join(gan, "gan_pacs_art_painting.jsonl"))]
    if not gp[0] > 0:
        fail(f"gan-train: the penalty did not run at step 0 ({gp})")
    steps_report, refs = check_privacy_steps(torch, dev, root, names, enc, dec)
    line = {"card": smi, "image_size": PRIV_SIZE, "precision": "float32, TF32 off; K3 bf16 "
            "for the style vector", "steps": PRIV_STEPS,
            "runs": {k: {kk: vv for kk, vv in v.items() if kk != "printed"}
                     for k, v in rows.items()},
            "step_checks": steps_report, "phase_seconds": time.perf_counter() - t0}
    for k, v in rows.items():
        print(f"{k}: {v['seconds']:.1f} s, " + (f"{v['steps_per_sec']:.2f} steps/s, "
              if "steps_per_sec" in v else "") + f"{v['img_per_sec']:.1f} img/s, peak device "
              f"memory {v['max_memory_allocated_bytes'] / 2**30:.2f} GiB ({smi})")
    return line, refs


# -- parallel clients and multi-process runs (phase 9) -------------------------

PAR_SOURCES = ("art_painting", "cartoon", "sketch")  # PACS's source clients, target photo
PAR_ROUNDS = 2
PAR_WORLD = 3                                        # (c): one rank a client
# (c): the ranks' arithmetic (one client a vmap) and the stacked run's (three
# clients a vmap), replayed in float64 over the CLI's rounds, as one function:
# per leaf max |d_ranks - d_stacked| at most this of max |d| of the update
PAR_F64_PATHS = 1e-6
PRIV_WORLD = 2                                       # (d), (e): two ranks split the batch


def par_batches(torch, root, dev):
    """The first FED_BATCH entries of each source client's K3 list at FED_SIZE,
    stacked (C, B, ...) as the parallel runner hands them to the step."""
    from ccst_tpu_torch.data.lists import parse_list, train_list_path
    from ccst_tpu_torch.data.loader import ImageBatchLoader
    from ccst_tpu_torch.parallel.fed_mesh import stack_trees

    out = []
    for d in PAR_SOURCES:
        names, labels = parse_list(train_list_path(root, "pacs", d, fusion_dir=FED_FUSION,
                                                   target="photo"))
        loader = ImageBatchLoader([os.path.join(root, n) for n in names[:FED_BATCH]],
                                  labels[:FED_BATCH], batch_size=FED_BATCH, image_size=FED_SIZE,
                                  out_dtype="uint8")
        b = next(iter(loader))
        out.append({"images": torch.from_numpy(b.images).to(dev).float()
                    / torch.full((), 255.0, device=dev),
                    "labels": torch.from_numpy(b.labels.astype("int64")).to(dev),
                    "mask": torch.ones(FED_BATCH, device=dev)})
    return stack_trees(out)


def check_stacked_step(torch, dev, root):
    """(a) One vmapped ResNet-50 step of the three clients against their three
    sequential steps, from the same states with the same draws; float64 steps
    on the card as the reference of both. Times in both cuDNN modes."""
    from ccst_tpu_torch.federated.train_ops import make_train_step
    from ccst_tpu_torch.models.classifiers import get_network, init_weights
    from ccst_tpu_torch.parallel.fed_mesh import (ParallelFedTrainer, client_generators,
                                                  map_tree, stack_trees)
    from ccst_tpu_torch.utils.precision import no_tf32

    n = len(PAR_SOURCES)
    model = init_weights(get_network(FED_NET, FED_CLASSES), torch.Generator().manual_seed(0))
    model = model.to(dev)
    base = {k: v.detach().clone() for k, v in model.state_dict().items()}
    noise = torch.Generator().manual_seed(2)
    states = [{k: (v + 1e-3 * torch.randn(v.shape, generator=noise).to(dev))
               if v.is_floating_point() else v.clone() for k, v in base.items()}
              for _ in range(n)]
    batch = par_batches(torch, root, dev)
    step = make_train_step(model, n_classes=FED_CLASSES, image_size=FED_SIZE, lr=1e-2)
    trainer = ParallelFedTrainer(step, "fedavg", [1.0 / n] * n)
    draws = trainer.draw(client_generators(1, 0, range(n)), batch, dev)
    stacked = stack_trees(states)

    def one(tree, ci, cast=lambda t: t):
        return map_tree(lambda t: cast(t[ci]), tree)

    def run_seq():
        return [step.apply(states[ci], base, one(batch, ci), one(draws, ci), 0)
                for ci in range(n)]

    failures = []
    with no_tf32(deterministic=True):
        t0 = time.perf_counter()
        got, m = trainer.step(stacked, base, batch, draws, 0)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        again, _ = trainer.step(stacked, base, batch, draws, 0)
        if not all(torch.equal(got[k], again[k]) for k in got):
            failures.append("the stacked step gave other bits on a second call")
        seq = run_seq()
        f64 = lambda t: t.double() if t.is_floating_point() else t  # noqa: E731
        model.double()
        ref = [step.apply({k: f64(v) for k, v in states[ci].items()},
                          {k: f64(v) for k, v in base.items()}, one(batch, ci, f64),
                          one(draws, ci, f64), 0) for ci in range(n)]
        model.float()
    worst = []
    for ci in range(n):
        l_got, l_seq, l_64 = float(m.loss[ci]), float(seq[ci][1].loss), float(ref[ci][1].loss)
        if not math.isfinite(l_got) or abs(l_got - l_seq) / abs(l_seq) > FED_LOSS_RTOL:
            failures.append(f"client {ci}: loss {l_got} stacked, {l_seq} in sequence")
        bad, errs = median_rule(f"client {ci}", states[ci], {k: v[ci] for k, v in got.items()},
                                seq[ci][0], ref[ci][0], FED_DELTA_MEDIAN, FED_F32_FACTOR)
        failures += bad
        for k, (e_got, e_32) in errs.items():
            worst.append((e_got, ci, k, e_32))
        print(f"stacked step client {ci} ({PAR_SOURCES[ci]}): loss stacked {l_got:.6f}, "
              f"sequential {l_seq:.6f}, float64 {l_64:.6f}")
    worst.sort(reverse=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = {}
    with no_tf32(deterministic=True):  # the runner's mode
        times["stacked_ms"] = time_ms(torch, lambda: trainer.step(stacked, base, batch, draws, 0),
                                      reps=3, runs=3)
        times["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
        times["sequential_ms"] = time_ms(torch, run_seq, reps=1, runs=3)
    with no_tf32(deterministic=False):  # cuDNN's default algorithms, for comparison
        times["stacked_default_ms"] = time_ms(
            torch, lambda: trainer.step(stacked, base, batch, draws, 0), reps=2, runs=3)
        times["sequential_default_ms"] = time_ms(torch, run_seq, reps=1, runs=3)
    images = n * FED_BATCH
    for k in ("stacked", "sequential", "stacked_default", "sequential_default"):
        times[f"{k}_img_s"] = images / (times[f"{k}_ms"] * 1e-3)
    print(f"stacked step ({n} clients x {FED_BATCH} x {FED_SIZE}px, ResNet-50, float32, TF32 off, "
          f"cuDNN deterministic): {times['stacked_ms']:.2f} ms = {times['stacked_img_s']:.1f} "
          f"img/s against {times['sequential_ms']:.2f} ms = {times['sequential_img_s']:.1f} img/s "
          f"for the {n} sequential steps (default cuDNN: {times['stacked_default_ms']:.2f} / "
          f"{times['sequential_default_ms']:.2f} ms); first call {first_s:.1f} s; peak device "
          f"memory {times['max_memory_allocated_bytes'] / 2**30:.2f} GiB; worst leaf median "
          f"|d - d_64| / max |d_64| stacked {worst[0][0]:.2e} (client {worst[0][1]}, "
          f"{worst[0][2]}; the sequential step's {worst[0][3]:.2e})")
    if failures:
        fail("stacked step:\n  " + "\n  ".join(failures[:40]))
    return {**times, "first_call_s": first_s, "bits_equal_over_two_calls": True,
            "worst_leaves": [(k, ci, e, e32) for e, ci, k, e32 in worst[:3]],
            "losses": [float(v) for v in m.loss]}


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def wait_all(procs, tag, timeout=600):
    """(stdout, stderr) of each process; fails on a nonzero exit."""
    outs = []
    for i, p in enumerate(procs):
        try:
            out, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            fail(f"{tag}: rank {i} ran past {timeout} s")
        if p.returncode != 0:
            for q in procs:
                q.kill()
            fail(f"{tag}: rank {i} exited {p.returncode}:\n{out[-2000:]}\n{err[-3000:]}")
        outs.append((out, err))
    return outs


def update_drift(start, got, want):
    """Per leaf, median |d_got - d_want| / max |d_want| of two runs' updates
    from ``start``, worst first."""
    worst = []
    for k, old in start.items():
        if not old.is_floating_point():
            continue
        old, w, g = old.double().cpu(), want[k].double().cpu(), got[k].double().cpu()
        scale = (w - old).abs().max().item()
        if scale > 0.0:
            worst.append(((g - w).abs().median().item() / scale, k))
    return sorted(worst, reverse=True)


def run_par_cli(torch, root):
    """(b) ``fed-train --parallel-clients`` for PAR_ROUNDS rounds, then (c) the
    same run as PAR_WORLD ranks on the one card; returns their reports."""
    from ccst_tpu_torch.models.classifiers import get_network, init_weights
    from ccst_tpu_torch.utils.checkpoint import load_checkpoint
    from ccst_tpu_torch.utils.metrics import read_rounds

    run = f"pacs_photo_fedavg_{FED_FUSION}_no_DG_{FED_NET}_seed1"

    def argv(out):
        return [sys.executable, "-m", "ccst_tpu_torch.cli", "fed-train", "--dataset", "pacs",
                "--target", "photo", "--fusion-mode", FED_FUSION, "--network", FED_NET,
                "--list-root", root, "--data-root", root, "--mode", "fedavg", "--rounds",
                str(PAR_ROUNDS), "--save-freq", "1", "--save-path", os.path.join(out, "ckpt"),
                "--log-path", os.path.join(out, "logs"), "--device", "cuda"]

    def rounds_of(out, tag):
        recs = [r for r in read_rounds(os.path.join(out, "logs", run + ".jsonl"))
                if r["event"] == "round"]
        if [r["round"] for r in recs] != list(range(PAR_ROUNDS)):
            fail(f"{tag} logged rounds {[r['round'] for r in recs]}")
        for r in recs:
            if not all(math.isfinite(v) for k, v in r.items() if k.startswith("train_loss/")):
                fail(f"{tag}: a non-finite loss in {r}")
        return recs

    single = os.path.join(root, "parallel", "single")
    t0 = time.perf_counter()
    proc = subprocess.run([*argv(single), "--parallel-clients"], cwd=HERE, capture_output=True,
                          text=True, timeout=600)
    single_s = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"fed-train --parallel-clients exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    recs_b = rounds_of(single, "fed-train --parallel-clients")
    print(f"fed-train --parallel-clients: exit 0 in {single_s:.1f} s; rounds "
          + "; ".join(f"{r['round']}: {r['seconds']:.2f} s (loader {r['loader_wait_seconds']:.2f})"
                      for r in recs_b))

    ranks = os.path.join(root, "parallel", "ranks")
    port = free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen([*argv(ranks), "--coordinator", f"127.0.0.1:{port}", "--num-procs",
                               str(PAR_WORLD), "--proc-id", str(r)], cwd=HERE,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(PAR_WORLD)]
    outs = wait_all(procs, f"fed-train --num-procs {PAR_WORLD}")
    ranks_s = time.perf_counter() - t0
    backends, digests = [], []
    for out, _ in outs:
        line = next((l for l in out.splitlines() if l.startswith("[multihost]")), "")
        backends.append(line)
        digests.append(json.loads(out.strip().splitlines()[-1])["server_sha256"])
    for line in backends:
        print(line)
    if len(set(digests)) != 1 or not all("backend gloo" in b for b in backends):
        fail(f"fed-train --num-procs {PAR_WORLD}: server digests {digests}, backends {backends}")
    recs_c = rounds_of(ranks, f"fed-train --num-procs {PAR_WORLD}")
    print(f"fed-train --num-procs {PAR_WORLD} on one card: exit 0 on every rank in {ranks_s:.1f} s; "
          f"one server sha256 on all ranks ({digests[0][:16]}...); rounds "
          + "; ".join(f"{r['round']}: {r['seconds']:.2f} s" for r in recs_c))

    got = load_checkpoint(os.path.join(ranks, "ckpt", run + "_latest.ckpt"))["server"]
    want = load_checkpoint(os.path.join(single, "ckpt", run + "_latest.ckpt"))["server"]
    t0 = time.perf_counter()
    replay = {how: replay_rounds(torch, root, how, PAR_ROUNDS) for how in ("ranks", "stacked")}
    start = replay["ranks"][1]
    for tag, cli, how in (("--num-procs", got, "ranks"), ("--parallel-clients", want, "stacked")):
        differ = [k for k in cli if not torch.equal(cli[k], replay[how][0][-1][k])]
        if differ:
            fail(f"fed-train {tag}: the server differs from this process's replay of its steps "
                 f"in {len(differ)} leaves ({differ[:5]})")
    print(f"both CLI runs' servers after {PAR_ROUNDS} rounds equal, bit for bit, this process's "
          "replay of their steps (the ranks': one client a vmap, the epoch held to the longest "
          "client's; the stacked run's: three a vmap; the same draws and aggregation)")
    witness, bad = float64_witness(torch, root, start, {how: replay[how][0] for how in replay})
    replay_s = time.perf_counter() - t0
    bad = [f"fed-train --num-procs {PAR_WORLD} against --parallel-clients: {b}" for b in bad]
    return ({"cli_seconds": single_s, "round_seconds": [r["seconds"] for r in recs_b],
             "round_loader_wait_seconds": [r["loader_wait_seconds"] for r in recs_b]},
            {"ranks": PAR_WORLD, "backend": backends[0].split("backend ")[-1],
             "cli_seconds": ranks_s, "round_seconds": [r["seconds"] for r in recs_c],
             "server_sha256": digests[0], "bit_equal_to_replay": True,
             "float64_witness": witness, "replay_seconds": replay_s}, bad)


def largest_gap(start, got, want):
    """Per leaf max |got - want| / max |want - start|, worst first."""
    gaps = []
    for k, old in start.items():
        if old.is_floating_point():
            scale = (want[k].double() - old.double()).abs().max().item()
            gap = (got[k].double() - want[k].double()).abs().max().item()
            gaps.append((gap / max(scale, 1e-300), k))
    return sorted(gaps, reverse=True)


def float64_witness(torch, root, start, cli):
    """(c)'s two float32 paths against float64, first on the CLI runs' data
    (``cli``: their replayed servers after each round; 33 train images a
    client, so a round's second step is one image padded by 31 copies of
    itself), then on one full batch a client a round (replayed here):

    - the two paths replayed in float64 compute one function over the
      PAR_ROUNDS rounds: per leaf at most PAR_F64_PATHS of the update apart
      at any element. Both run cuDNN's deterministic algorithms: with its
      default ones float64 on the CLI's data does not repeat its own result
      (reported);
      A fault in either path, or in the state it carries between rounds,
      would part them here;
    - each float32 path sits as far from float64 as the other: phase 7's rule
      (max(FED_DELTA_MEDIAN, FED_F32_FACTOR x the other path's distance)) on
      the median over leaves of each leaf's median |d - d_64| / max |d_64|,
      both ways, after PAR_ROUNDS rounds. Per leaf the rule is a coin toss
      where float32 is ill-conditioned (a BatchNorm channel of near-zero batch
      variance turns the paths' last-bit differences into differences of the
      order of the update, each path's its own), so the leaves that miss it
      are counted and reported, and a side that is nearer float64 throughout
      fails here;
    - on full batches, after the first round, per leaf phase 7's rule, both
      ways.

    Returns (readings, failures)."""
    import numpy as np

    def on_host(state):
        return {k: v.cpu() for k, v in state.items()}

    start, witness, bad = on_host(start), {}, []
    for data, full, runs in (("cli", False, cli), ("full", True, None)):
        runs = runs or {how: replay_rounds(torch, root, how, PAR_ROUNDS, full_batches=True)[0]
                        for how in ("ranks", "stacked")}
        ref = {how: replay_rounds(torch, root, how, PAR_ROUNDS, full_batches=full,
                                  dtype=torch.float64)[0] for how in ("ranks", "stacked")}
        paths = largest_gap(start, ref["stacked"][-1], ref["ranks"][-1])
        # float64's own conditioning on this data: the ranks' path once more in
        # float64 with cuDNN's default algorithms (atomics in their sums),
        # against the deterministic run (reported, no bar)
        loose = largest_gap(start, replay_rounds(torch, root, "ranks", PAR_ROUNDS,
                                                 full_batches=full, dtype=torch.float64,
                                                 deterministic=False)[0][-1], ref["ranks"][-1])
        if not paths[0][0] <= PAR_F64_PATHS:
            bad.append(f"{data}: in float64 the stacked path leaves the ranks' by "
                       f"{paths[0][0]:.3e} of the update ({paths[0][1]})")
        last, first = {}, {}
        for how, other in (("ranks", "stacked"), ("stacked", "ranks")):
            missed, last[how] = median_rule(how, start, runs[how][-1], runs[other][-1],
                                            ref["ranks"][-1], FED_DELTA_MEDIAN, FED_F32_FACTOR)
            if full:
                b_, first[how] = median_rule(f"{data} round 0 {how} against float64", start,
                                             runs[how][0], runs[other][0], ref["ranks"][0],
                                             FED_DELTA_MEDIAN, FED_F32_FACTOR)
                bad += b_
            last[how + "_missed"] = len(missed)
        e_r = np.array([e for e, _ in last["ranks"].values()])
        e_s = np.array([e for e, _ in last["stacked"].values()])
        m_r, m_s = float(np.median(e_r)), float(np.median(e_s))
        for how, m, m_other in (("ranks", m_r, m_s), ("stacked", m_s, m_r)):
            if not m <= max(FED_DELTA_MEDIAN, FED_F32_FACTOR * m_other):
                bad.append(f"{data}: the {how} path's median leaf {m:.3e} of the update from "
                           f"float64, the other's {m_other:.3e}")
        worst = {how: max((e[0], k) for k, e in last[how].items()) for how in ("ranks", "stacked")}
        w = witness[data] = {
            "float64_paths_worst": paths[0], "float64_default_cudnn_worst": loose[0],
            "leaves": int(e_r.size),
            "median_leaf_ranks": m_r, "median_leaf_stacked": m_s,
            "worst_leaf_ranks": worst["ranks"], "worst_leaf_stacked": worst["stacked"],
            "ranks_nearer_leaves": int((e_r < e_s).sum()),
            "leaves_missing_the_per_leaf_rule": [last["ranks_missed"], last["stacked_missed"]],
            "float32_paths_worst": update_drift(start, runs["ranks"][-1],
                                                runs["stacked"][-1])[0]}
        if full:
            w["round0_worst_leaf"] = {how: max((e[0], k) for k, e in first[how].items())
                                      for how in first}
        what = "one full batch a client a round" if full else "the CLI runs' data"
        print(f"{PAR_ROUNDS} rounds ({what}) against float64: the two paths in float64 at most "
              f"{paths[0][0]:.2e} of the update apart at any element ({paths[0][1]}), float64 "
              f"with cuDNN's default algorithms {loose[0][0]:.2e} from itself ({loose[0][1]}); per leaf median "
              f"|d - d_64| / max |d_64|, median over {w['leaves']} leaves: ranks {m_r:.2e}, "
              f"stacked {m_s:.2e}; worst ranks {worst['ranks'][0]:.2e} ({worst['ranks'][1]}), "
              f"stacked {worst['stacked'][0]:.2e} ({worst['stacked'][1]}); ranks nearer on "
              f"{w['ranks_nearer_leaves']} leaves; per leaf rule missed on "
              f"{w['leaves_missing_the_per_leaf_rule']} leaves (ranks, stacked); the float32 "
              f"paths {w['float32_paths_worst'][0]:.2e} apart ({w['float32_paths_worst'][1]})"
              + (f"; after round 0, worst leaf ranks {w['round0_worst_leaf']['ranks'][0]:.2e}, "
                 f"stacked {w['round0_worst_leaf']['stacked'][0]:.2e}" if full else ""))
    return witness, bad


def replay_rounds(torch, root, how, rounds, full_batches=False, dtype=None, deterministic=True):
    """The CLI runs' arithmetic in this process from their initial state: ``how``
    = "ranks" steps each client alone (a vmap of one client, the epoch held to
    the longest client's, as ``MultihostFedRunner`` does), "stacked" all three
    at once (``--parallel-clients``); then the runner's aggregation. ``dtype``
    float64 runs it in float64 (images, states and the model). cuDNN runs its
    deterministic algorithms, as the runner does, unless ``deterministic`` is
    False. ``full_batches`` keeps FED_BATCH train images a client
    (``limit_data``): one full batch a round. Returns (the server after each
    round, the initial server), on the host."""
    from ccst_tpu_torch.data.lists import parse_list, train_list_path

    from ccst_tpu_torch.config import FedConfig
    from ccst_tpu_torch.federated.aggregate import aggregate
    from ccst_tpu_torch.federated.runtime import FederatedRunner
    from ccst_tpu_torch.parallel.fed_mesh import (ParallelFedTrainer, client_generators,
                                                  stack_step_batches, stack_trees,
                                                  unstack_states)
    from ccst_tpu_torch.utils.metrics import MetricsLogger
    from ccst_tpu_torch.utils.precision import no_tf32

    limit = 1.0
    if full_batches:
        n = len(parse_list(train_list_path(root, "pacs", PAR_SOURCES[0], fusion_dir=FED_FUSION,
                                           target="photo"))[0])
        limit = (FED_BATCH + 0.5) / (n - int(n * 0.1))  # int(train * limit) == FED_BATCH
    cfg = FedConfig(dataset="pacs", target="photo", fusion_mode=FED_FUSION, network=FED_NET,
                    list_root=root, data_root=root, mode="fedavg", rounds=rounds,
                    parallel_clients=how == "stacked", limit_data=limit)
    runner = FederatedRunner(cfg, device="cuda", logger=MetricsLogger(None, echo=False))
    host = lambda state: {k: v.cpu() for k, v in state.items()}  # noqa: E731
    start = host(runner.server)
    f64 = dtype == torch.float64
    if f64:
        wide = lambda t: t.double() if t.is_floating_point() else t  # noqa: E731
        runner.model.double()
        runner.server = {k: wide(v) for k, v in runner.server.items()}
        runner.client_states = [dict(runner.server) for _ in runner.client_states]
        batch_dict = runner.batch_dict
        runner.batch_dict = lambda b: {k: wide(v) for k, v in batch_dict(b).items()}
    steps = max(len(c.train) for c in runner.clients)
    alone = ParallelFedTrainer(runner._train_step, cfg.mode, runner.weights, n_clients=1)
    servers = []
    with no_tf32(deterministic=deterministic):
        for r in range(rounds):
            if how == "stacked":
                runner.train_parallel(r)
            else:
                states = []
                for ci in range(runner.n_clients):
                    batches = stack_step_batches([runner.clients[ci].train], runner.batch_dict,
                                                 steps)
                    st, _ = alone.run_epoch(stack_trees([runner.client_states[ci]]),
                                            runner.server, batches,
                                            client_generators(cfg.seed, r, [ci]), n_steps=steps)
                    states += unstack_states(st, 1)
                runner.server, runner.client_states = aggregate(cfg.mode, states, runner.weights)
            servers.append(host(runner.server))
    return servers, start


def run_priv_ranks(torch, kind, root, work, inputs):
    """(d) / (e): PRIV_WORLD ranks of this script's rank worker on the one card;
    returns each rank's saved result."""
    os.makedirs(work, exist_ok=True)
    torch.save(inputs, os.path.join(work, "inputs.pt"))
    init = f"tcp://127.0.0.1:{free_port()}"
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "chip_smoke.py"), "--rank-worker",
                               kind, "--rank", str(r), "--world", str(PRIV_WORLD), "--init", init,
                               "--work-dir", work], cwd=HERE, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(PRIV_WORLD)]
    outs = wait_all(procs, kind)
    seconds = time.perf_counter() - t0
    for out, _ in outs:
        print("\n".join(l for l in out.splitlines() if l.startswith(("[multihost]", "rank "))))
    results = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
               for r in range(PRIV_WORLD)]
    return results, seconds


def check_priv_ranks(torch, tag, results, ref, expect_train_k3):
    """Both ranks' step bit for bit, 18 K3 launches a step on each, and the
    step against phase 8's float64 step on the joined batch by phase 8's rule
    (the CPU's float32 step as float32's resolution)."""
    failures = []
    a, b = results
    if a["loss"] != b["loss"] or any(not torch.equal(a["params"][k], b["params"][k])
                                     for k in a["params"]):
        failures.append(f"{tag}: the two ranks hold other bits after the step")
    for r, res in enumerate(results):
        if res["step_k3"] != 18 or res["train_k3"] != expect_train_k3[r]:
            failures.append(f"{tag}: rank {r} launched K3 {res['step_k3']} times in the step "
                            f"(18 expected), {res['train_k3']} in the run "
                            f"({expect_train_k3[r]} expected)")
    (c32, l_32), (c64, l_64) = ref["outs"]["cpu32"], ref["outs"]["cpu64"]
    rel = abs(a["loss"] - l_64) / abs(l_64)
    if not math.isfinite(a["loss"]) or rel > STEP_LOSS_RTOL:
        failures.append(f"{tag}: loss {a['loss']} on the ranks, {l_64} float64")
    bad, errs = median_rule(tag, ref["start"], a["params"], c32, c64, STEP_DELTA_MEDIAN,
                            STEP_F32_FACTOR)
    failures += bad
    worst = max((e, k, e32) for k, (e, e32) in errs.items())
    print(f"{tag} on {PRIV_WORLD} ranks: one step bit-equal on both; loss {a['loss']:.6f} (float64 "
          f"{l_64:.6f}); worst leaf median |d - d_64| / max |d_64| {worst[0]:.2e} ({worst[1]}; the "
          f"CPU float32 step's {worst[2]:.2e}); K3 a rank: {[r['step_k3'] for r in results]} in "
          f"the step, {[r['train_k3'] for r in results]} in the run")
    if failures:
        fail("\n  ".join(failures))
    return {"loss": a["loss"], "loss_rel_err": rel, "worst_leaf": worst,
            "k3_step": [r["step_k3"] for r in results], "k3_run": [r["train_k3"] for r in results],
            "run": results[0]["report"]}


def run_parallel_phase(torch, dev, root, smi, refs, enc_path, dec_path, images_per_domain):
    """Phase 9 on phase 4's tree: (a) the stacked step, (b) the single-process
    parallel CLI, (c) its multi-process launch on the one card, (d) the
    two-rank inverter, (e) the decoder trainer on a two-rank mesh. Returns the
    ``parallel`` line."""
    from ccst_tpu_torch.privacy.invert import _split_indices, InvertConfig

    t0 = time.perf_counter()
    stacked = check_stacked_step(torch, dev, root)
    single, ranks, failures = run_par_cli(torch, root)
    list_root, names = privacy_lists(root, images_per_domain)
    inv = refs["invert-train"]
    val_idx, _ = _split_indices(InvertConfig(), len(names))
    val_batches = [-(-len(val_idx[r::PRIV_WORLD]) // (INV_BATCH // PRIV_WORLD))
                   for r in range(PRIV_WORLD)]
    res, inv_s = run_priv_ranks(torch, "invert", root, os.path.join(root, "parallel", "invert"),
                                {"root": root, "list_root": list_root, "enc_path": enc_path,
                                 "images": inv["images"], "init": inv["init"]})
    invert = check_priv_ranks(torch, "invert-train", res, inv,
                              [18 * PRIV_STEPS + 9 * v for v in val_batches])
    dec = refs["train-decoder"]
    res, dec_s = run_priv_ranks(torch, "decoder", root, os.path.join(root, "parallel", "decoder"),
                                {"root": root, "enc_path": enc_path, "dec_path": dec_path,
                                 "content": dec["content"], "style": dec["style"]})
    decoder = check_priv_ranks(torch, "train-decoder mesh", res, dec,
                               [18 * PRIV_STEPS] * PRIV_WORLD)
    if failures:
        fail("\n  ".join(failures[:40]))
    k3 = sum(invert["k3_step"]) + sum(invert["k3_run"]) + sum(decoder["k3_step"]) + sum(
        decoder["k3_run"])
    return {"card": smi, "network": FED_NET, "clients": len(PAR_SOURCES), "batch": FED_BATCH,
            "image_size": FED_SIZE, "precision": "float32, TF32 off, cuDNN deterministic",
            "stacked_step": stacked, "parallel_clients_cli": single, "ranks_cli": ranks,
            "invert_ranks": {**invert, "seconds": inv_s}, "decoder_mesh": {**decoder,
                                                                           "seconds": dec_s},
            "k3_launches": k3, "phase_seconds": time.perf_counter() - t0}


def rank_worker(args):
    """One rank of (d) or (e), started by ``run_priv_ranks``: joins the group,
    runs the trainer for PRIV_STEPS steps (the inverter in the launch form, each
    rank its strided shard; the decoder on a mesh of the ranks, each its rows),
    then one step over the group on its rows of phase 8's batch; saves the
    step's parameters, loss and K3 counts."""
    import torch
    import torch.distributed as dist

    from ccst_tpu_torch.kernels.conv import reflect_conv3x3
    from ccst_tpu_torch.models import vgg
    from ccst_tpu_torch.models.convert import load_decoder, load_encoder
    from ccst_tpu_torch.parallel import multihost

    dev = multihost.initialize(args.init, args.world, args.rank, device="cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    inp = torch.load(os.path.join(args.work_dir, "inputs.pt"), weights_only=False)
    enc = load_encoder(inp["enc_path"])
    out = {}
    if args.rank_worker == "invert":
        from ccst_tpu_torch.privacy.generator import StyleInverter
        from ccst_tpu_torch.privacy.invert import (InvertConfig, InverterTrainer, style_vector,
                                                   train_inverter)

        cfg = InvertConfig(dataset="pacs", source=PRIV_SOURCE, list_root=inp["list_root"],
                           data_root=inp["root"], image_size=PRIV_SIZE,
                           batch_size=INV_BATCH // args.world, steps=PRIV_STEPS,
                           loss="mse+perceptual", vgg_weights=inp["enc_path"],
                           out_dir=os.path.join(args.work_dir, "inverter"))
        reflect_conv3x3.launches = 0
        out["report"] = train_inverter(cfg, device="cuda")
        torch.cuda.synchronize()
        out["train_k3"] = reflect_conv3x3.launches
        model = StyleInverter(image_size=PRIV_SIZE)
        model.load_state_dict(inp["init"])
        trainer = InverterTrainer(InvertConfig(image_size=PRIV_SIZE, loss="mse+perceptual"), enc,
                                  dev, model=model, group=dist.group.WORLD)
        images = inp["images"][multihost.group_rows(INV_BATCH)].to(dev)
        reflect_conv3x3.launches = 0
        with torch.no_grad():
            z = style_vector(vgg.prepare_params(enc, torch.bfloat16, dev), images)
        loss = trainer.step(images, z)
        params = {k: v.detach().double().cpu() for k, v in trainer.model.state_dict().items()}
    else:
        from ccst_tpu_torch.pipeline.train_decoder import (DecoderTrainConfig, DecoderTrainer,
                                                           train_decoder)

        cfg = DecoderTrainConfig(dataset="pacs", list_root=inp["root"], data_root=inp["root"],
                                 image_size=PRIV_SIZE, batch_size=DEC_BATCH, steps=PRIV_STEPS,
                                 vgg_weights=inp["enc_path"], init_decoder=inp["dec_path"],
                                 out_path=os.path.join(args.work_dir, "decoder.npz"))
        reflect_conv3x3.launches = 0
        out["report"] = train_decoder(cfg, mesh=dist.group.WORLD, device="cuda")
        torch.cuda.synchronize()
        out["train_k3"] = reflect_conv3x3.launches
        dcfg = DecoderTrainConfig(lr=1e-4)
        trainer = DecoderTrainer(dcfg, enc, load_decoder(inp["dec_path"]), dev,
                                 group=dist.group.WORLD)
        rows = multihost.group_rows(DEC_BATCH)
        reflect_conv3x3.launches = 0
        lc, ls = trainer.step(inp["content"][rows].to(dev), inp["style"][rows].to(dev))
        loss = dcfg.content_weight * lc + dcfg.style_weight * ls
        params = {f"{n}/{k}": p.detach().double().cpu() for n, l in trainer.decoder.items()
                  for k, p in l.items()}
    torch.cuda.synchronize()
    out.update(step_k3=reflect_conv3x3.launches, loss=float(loss), params=params)
    torch.save(out, os.path.join(args.work_dir, f"rank{args.rank}.pt"))
    print(f"rank {args.rank}: K3 {out['train_k3']} in {PRIV_STEPS} steps, {out['step_k3']} in the "
          f"step; loss {float(loss):.6f}", flush=True)
    dist.destroy_process_group()
    return 0


# -- row-sharded stylize and the channel-split ResNet-50 (phase 10) ------------

SHARD_WORLD = 4                 # ranks on the one card: (a), (b) a spatial group, (d) a 2 x 2 mesh
SHARD_F32_TOL = dict(rtol=1e-4, atol=1e-5)   # ccst_tpu's tests/test_parallel.py bar
SHARD_ROUTES = ("ref bf16", "ref float32", "int8-static")
GIVEN_STYLES = 3                # (c): K4's given-statistics entry with all of phase 4's banks
TP_BATCH, TP_MIN_DIM = 8, 128   # (d): the global batch (4 rows a data rank); ccst_tpu's policy
TP_LOSS_RTOL, TP_LOGITS_ATOL = 2e-5, 2e-4    # ccst_tpu's tests/test_parallel.py bars


def check_given_adain(torch, dev, gen, results, batch):
    """(c): K4's given-statistics entry against its plain version at relu4_1
    of a 512 px batch with all three banks (bf16 and float32), timed on the
    device from a replayed CUDA graph beside its byte bound, the host's call
    rate and the plain version's time; no one PyTorch call computes it."""
    from ccst_tpu_torch.benchmarks.small_kernels import graph_ms
    from ccst_tpu_torch.kernels.adain import fused_adain_given, fused_adain_multi_reference

    shape = relu4_1_shape(batch)
    for dtype in (torch.bfloat16, torch.float32):
        feat = (torch.randn(shape, generator=gen) * 2 + 1).to(dev, dtype)
        x = feat.float()
        mean = x.mean(dim=(1, 2))
        var = torch.square(x - mean[:, None, None]).sum(dim=(1, 2)) / (shape[1] * shape[2] - 1)
        inv_std = torch.rsqrt(var + 1e-5)
        s_means = torch.randn((GIVEN_STYLES, shape[-1]), generator=gen).to(dev)
        s_stds = (torch.rand((GIVEN_STYLES, shape[-1]), generator=gen) + 0.1).to(dev)
        for alpha in (1.0, 0.6):
            kernel = lambda: fused_adain_given(feat, mean, inv_std, s_means, s_stds, alpha)
            plain = lambda: fused_adain_multi_reference(feat, s_means, s_stds, alpha, mean=mean,
                                                        inv_std=inv_std)
            got = kernel()
            torch.cuda.synchronize()
            label = f"{shape} {dtype} alpha={alpha} S={GIVEN_STYLES}"
            mx, mae = check_close(f"K4 given {label}", got, plain(),
                                  **(BF16_TOL if dtype == torch.bfloat16 else F32_TOL))
            ms = graph_ms(torch, kernel, 50, 5)["median"]
            call_ms = time_ms(torch, kernel, reps=50)
            plain_ms = time_ms(torch, plain, reps=5, runs=3)
            # the features in once, S outputs out, the (N, C) statistics and (S, C) banks in
            nbytes = ((1 + GIVEN_STYLES) * feat.numel() * feat.element_size()
                      + 8 * shape[0] * shape[-1] + 8 * GIVEN_STYLES * shape[-1])
            bd = bound((4 + 6 * GIVEN_STYLES) * feat.numel(), F32_PEAK_TFLOPS, nbytes)
            results["K4-given"].append(dict(
                shape=list(shape), dtype=str(dtype), alpha=alpha, styles=GIVEN_STYLES,
                max_abs_err=mx, mean_abs_err=mae, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                library_ms=None, **bd))
            print(f"K4 given statistics {label}: max {mx:.3e} mean {mae:.3e} | kernel {ms:.4f} ms "
                  f"on the device, {call_ms:.4f} ms a call; bound {bd['bound_ms']:.4f} ms by "
                  f"{bd['bound_by']} ({100 * bd['bound_ms'] / ms:.1f}% reached) plain "
                  f"{plain_ms:.4f} ms")
        del feat, got


def shard_counters():
    """The launch counters of the kernels the sharded paths may launch."""
    from ccst_tpu_torch.kernels.adain import fused_adain_given, fused_adain_multi
    from ccst_tpu_torch.kernels.conv import reflect_conv3x3
    from ccst_tpu_torch.kernels.level1 import decoder_level1, encoder_level1
    from ccst_tpu_torch.kernels.moments import channel_moments
    from ccst_tpu_torch.kernels.qconv import qconv3x3_s8

    return {"K3": reflect_conv3x3, "K0": qconv3x3_s8, "K5": channel_moments,
            "K4": fused_adain_multi, "K4-given": fused_adain_given, "K1": encoder_level1,
            "K2": decoder_level1}


def expected_shard_launches(route, images):
    """One sharded call's launches on each rank: 18 convs, a K5 an image of
    the rank's rows and one given-statistics K4; the batch variant runs the
    single-rank path on its images (18 K0, one K4)."""
    out = {k: 0 for k in shard_counters()}
    if route == "batch int8-static":
        out.update(K0=18, K4=1)
    else:
        out.update({"K3" if route.startswith("ref") else "K0": 18, "K5": images, "K4-given": 1})
    return out


def shard_worker(args):
    """One rank of phase 10, started by ``run_sharding_phase``: (a) each route
    of ``parallel/spatial.py`` over the SHARD_WORLD ranks for each bank, every
    launch count zeroed before a call and read after it, the output and the
    relu4_1 features gathered; (b) the batch variant; (d) ResNet-50 over a
    (data 2, model 2) mesh, the loss, the logits and the gradients of one
    batch gathered whole. Saves them, with a digest of each gathered tensor."""
    import hashlib

    import torch

    from ccst_tpu_torch.federated.train_ops import cross_entropy
    from ccst_tpu_torch.models import vgg, vgg_fast
    from ccst_tpu_torch.models.classifiers import get_network
    from ccst_tpu_torch.models.convert import load_decoder, load_encoder
    from ccst_tpu_torch.parallel import multihost, spatial, tensor
    from ccst_tpu_torch.utils.precision import no_tf32

    dev = multihost.initialize(args.init, args.world, args.rank, device="cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    inp = torch.load(os.path.join(args.work_dir, "inputs.pt"), weights_only=False)
    enc, dec = load_encoder(inp["enc_path"]), load_decoder(inp["dec_path"])
    counters = shard_counters()
    group = spatial.make_spatial_mesh(args.world)
    images, s_means, s_stds = inp["images"], inp["s_means"], inp["s_stds"]
    n_img = images.shape[0]

    def counted(fn):
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, {k: c.launches for k, c in counters.items()}, time.perf_counter() - t0

    def digest(t):
        return hashlib.sha256(t.detach().cpu().contiguous().view(torch.uint8).numpy()).hexdigest()

    enc_w, dec_w = (vgg_fast.cast_params(p, torch.bfloat16) for p in (enc, dec))
    eq = vgg_fast.prepare_encoder_q8s(enc_w, inp["scales"], torch.bfloat16, dev)
    dq = vgg_fast.prepare_decoder_q8s(dec_w, inp["scales"], torch.bfloat16, dev)
    out = {"routes": {}}
    for route in SHARD_ROUTES:
        if route == "int8-static":
            run = spatial.make_spatial_stylize_q8s(group, eq, dq, torch.bfloat16)
            call = lambda m, s: run(images, m, s)
            encode = lambda: run.encode(images)
        else:
            dtype = torch.float32 if route.endswith("float32") else torch.bfloat16
            run = spatial.make_spatial_stylize(group, dtype, dev)
            ep, dp = vgg.prepare_params(enc, dtype, dev), vgg.prepare_params(dec, dtype, dev)
            call = lambda m, s: run(ep, dp, images, m, s)
            encode = lambda: run.encode(ep, images)
        outs, counts, seconds = [], [], []
        for m, s in zip(s_means, s_stds):
            y, c, t = counted(lambda: call(m, s))
            outs.append(spatial.gather_rows(y, group))
            counts.append(c)
            seconds.append(t)
        feat = spatial.gather_rows(encode(), group)
        out["routes"][route] = {"counts": counts, "seconds": seconds,
                                "digests": [digest(o) for o in outs + [feat]],
                                **({"outputs": torch.stack(outs).cpu(), "feat": feat.cpu()}
                                   if args.rank == 0 else {})}
    run = spatial.make_batch_stylize_q8s(group, eq, dq, torch.bfloat16)
    outs, counts, seconds = [], [], []
    for m, s in zip(s_means, s_stds):
        y, c, t = counted(lambda: run(images, m, s))
        outs.append(spatial.gather_rows(y, group, dim=0))
        counts.append(c)
        seconds.append(t)
    out["routes"]["batch int8-static"] = {
        "counts": counts, "seconds": seconds, "digests": [digest(o) for o in outs],
        **({"outputs": torch.stack(outs).cpu()} if args.rank == 0 else {})}

    # (d) the channel-split ResNet-50, eval mode as ccst_tpu's test
    model = get_network(FED_NET, FED_CLASSES)
    model.load_state_dict(inp["tp_state"])
    model.to(dev).eval()
    mesh = tensor.make_dp_tp_mesh(2, 2)
    tp = tensor.with_tensor_parallel(model, mesh, TP_MIN_DIM)
    batch = tensor.shard_batch({"x": inp["tp_x"], "labels": inp["tp_labels"]}, mesh)
    names, params = zip(*tp.named_parameters())
    with no_tf32(deterministic=True):
        t0 = time.perf_counter()
        logits = tp(batch["x"].to(dev).permute(0, 3, 1, 2))
        loss = cross_entropy(logits, batch["labels"].to(dev)).mean()
        grads = tensor.data_mean(torch.autograd.grad(loss, params), mesh)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
    full = {k: v for k, v in model.state_dict().items()}
    grads = tensor.unshard_params(dict(zip(names, grads)), full, mesh, TP_MIN_DIM)
    out["tp"] = {"loss": float(tensor.data_mean([loss.detach()], mesh)[0]), "seconds": step_s,
                 "split": sorted(k for k, v in tp.state_dict().items() if v.shape != full[k].shape),
                 "digest": digest(torch.cat([g.reshape(-1) for g in grads.values()]))}
    if args.rank == 0:
        out["tp"].update(logits=torch.cat(multihost.all_gather(logits.detach(), mesh.data_group)
                                          ).cpu(),
                         grads={k: g.double().cpu() for k, g in grads.items()})
    else:
        multihost.all_gather(logits.detach(), mesh.data_group)
    torch.save(out, os.path.join(args.work_dir, f"rank{args.rank}.pt"))
    print(f"rank {args.rank}: sharded stylize and the (data 2, model 2) ResNet-50 step done, "
          f"{len(out['tp']['split'])} leaves split", flush=True)
    import torch.distributed as dist

    dist.destroy_process_group()
    return 0


def run_sharding_phase(torch, dev, smi, enc, dec, scales, images_u8, s_means, s_stds, singles,
                       results):
    """Phase 10: (c) K4's given-statistics entry; then SHARD_WORLD ranks of
    ``shard_worker`` on the one card (gloo, collectives through the host):
    (a) the sharded stylize routes against the single-rank engines
    ``singles`` on the same images and banks, with each rank's launch counts;
    (b) the batch variant bit for bit; (d) the (data 2, model 2) ResNet-50
    against the unsharded float32 and float64 steps on the card. Returns the
    ``sharding`` line and the launches of the sharded paths by kernel."""
    import copy

    from ccst_tpu_torch.federated.train_ops import cross_entropy
    from ccst_tpu_torch.models import convert
    from ccst_tpu_torch.models.classifiers import get_network, init_weights
    from ccst_tpu_torch.utils.precision import no_tf32

    t_phase = time.perf_counter()
    n_img = images_u8.shape[0]
    check_given_adain(torch, dev, torch.Generator().manual_seed(10), results, n_img)
    model = init_weights(get_network(FED_NET, FED_CLASSES), torch.Generator().manual_seed(11))
    gen = torch.Generator().manual_seed(12)
    tp_x = torch.rand((TP_BATCH, FED_SIZE, FED_SIZE, 3), generator=gen)
    tp_labels = torch.randint(0, FED_CLASSES, (TP_BATCH,), generator=gen)
    with tempfile.TemporaryDirectory(prefix="ccst_shard_") as work:
        enc_path, dec_path = os.path.join(work, "vgg.npz"), os.path.join(work, "decoder.npz")
        convert.save_npz(enc_path, enc)
        convert.save_npz(dec_path, dec)
        torch.save({"enc_path": enc_path, "dec_path": dec_path, "scales": scales,
                    "images": images_u8.cpu(), "s_means": s_means.cpu(), "s_stds": s_stds.cpu(),
                    "tp_state": model.state_dict(), "tp_x": tp_x, "tp_labels": tp_labels},
                   os.path.join(work, "inputs.pt"))
        init = f"tcp://127.0.0.1:{free_port()}"
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "chip_smoke.py"),
                                   "--rank-worker", "shard", "--rank", str(r), "--world",
                                   str(SHARD_WORLD), "--init", init, "--work-dir", work],
                                  cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                  text=True) for r in range(SHARD_WORLD)]
        outs = wait_all(procs, "phase 10", timeout=600)
        ranks_seconds = time.perf_counter() - t0
        for out, _ in outs:
            print("\n".join(l for l in out.splitlines() if l.startswith(("[multihost]", "rank "))))
        res = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
               for r in range(SHARD_WORLD)]

    failures, routes, launches = [], {}, {k: 0 for k in shard_counters()}
    bars = {"ref bf16": ("mae", MAE_BAR), "ref float32": ("close", SHARD_F32_TOL),
            "int8-static": ("mae", MAE_BAR), "batch int8-static": ("equal", None)}
    for route, (kind, bar) in bars.items():
        got = res[0]["routes"][route]
        if any(r["routes"][route]["digests"] != got["digests"] for r in res[1:]):
            failures.append(f"{route}: the ranks gathered other bits")
        images_a_rank = n_img // SHARD_WORLD if route.startswith("batch") else n_img
        expect = expected_shard_launches(route, images_a_rank)
        for r, rank_res in enumerate(res):
            for c in rank_res["routes"][route]["counts"]:
                if c != expect:
                    failures.append(f"{route}: rank {r} launched {c}, expected {expect}")
                for k, v in c.items():
                    launches[k] += v
        engine = singles["int8-static" if "int8" in route else route]
        with torch.no_grad():
            want = torch.stack([engine.stylize(images_u8, m, s, 1.0) for m, s in
                                zip(s_means, s_stds)]).cpu()
        err = (got["outputs"] - want).abs()
        row = {"mae": err.mean().item(), "max_abs_err": err.max().item(),
               "seconds_a_call": max(sorted(r["routes"][route]["seconds"])[len(s_means) // 2]
                                     for r in res),
               "first_call_seconds": max(r["routes"][route]["seconds"][0] for r in res),
               "launches_a_call_a_rank": expect}
        if got["outputs"].shape != want.shape or not bool(got["outputs"].isfinite().all()):
            failures.append(f"{route}: shape {tuple(got['outputs'].shape)} or non-finite values")
        elif kind == "mae" and not row["mae"] <= bar:
            failures.append(f"{route}: MAE {row['mae']:.3e} against the single rank > {bar}")
        elif kind == "close" and not bool((err <= bar["atol"] + bar["rtol"] * want.abs()).all()):
            failures.append(f"{route}: max abs err {row['max_abs_err']:.3e} against the single "
                            f"rank exceeds rtol {bar['rtol']} atol {bar['atol']}")
        elif kind == "equal" and not torch.equal(got["outputs"], want):
            failures.append(f"{route}: not bit-equal to the single rank")
        if "feat" in got:  # relu4_1: a difference here is a halo fault, not the statistics
            with torch.no_grad():
                feat = engine._encode(engine._as_input(images_u8)).cpu()
            d = (got["feat"].float() - feat.float()).abs().max().item()
            row.update(features_bit_equal=bool(torch.equal(got["feat"], feat)), features_max_abs=d)
            if "int8" in route and not row["features_bit_equal"]:
                failures.append(f"{route}: the sharded relu4_1 features differ from the single "
                                f"rank's by {d:.3e}: the integer convs are exact, so a halo fault")
            elif not d <= 1e-2 * max(feat.float().abs().max().item(), 1.0):
                failures.append(f"{route}: the sharded relu4_1 features are {d:.3e} off")
        routes[route] = row
        print(f"{route} over {SHARD_WORLD} ranks ({n_img} x {images_u8.shape[1]}px, "
              f"{len(s_means)} banks): "
              f"MAE {row['mae']:.3e} max {row['max_abs_err']:.3e} against the single rank; "
              + (f"relu4_1 bit-equal {row['features_bit_equal']} (max {row['features_max_abs']:.3e}); "
                 if "feat" in got else "")
              + f"launches a call on every rank {expect}; {row['seconds_a_call']:.3f} s a call "
              f"(first {row['first_call_seconds']:.3f} s)")

    # (d) against the unsharded step on the card, float32 and float64
    tp = res[0]["tp"]
    x = tp_x.to(dev).permute(0, 3, 1, 2)
    ref = {}
    for name, dtype in (("float32", torch.float32), ("float64", torch.float64)):
        m = copy.deepcopy(model).to(dev, dtype).eval()
        with no_tf32(deterministic=True):
            t0 = time.perf_counter()
            logits = m(x.to(dtype))
            loss = cross_entropy(logits, tp_labels.to(dev)).mean()
            names, params = zip(*m.named_parameters())
            grads = torch.autograd.grad(loss, params)
            torch.cuda.synchronize()
            ref[name] = (loss.item(), logits.detach().double().cpu(),
                         {k: g.double().cpu() for k, g in zip(names, grads)},
                         time.perf_counter() - t0)
    (l32, lg32, g32, s32), (l64, lg64, g64, _) = ref["float32"], ref["float64"]
    if any(r["tp"]["digest"] != tp["digest"] for r in res[1:]):
        failures.append("tensor parallel: the ranks hold other gradient bits")
    if abs(tp["loss"] - l32) > TP_LOSS_RTOL * abs(l32):
        failures.append(f"tensor parallel: loss {tp['loss']} against {l32} unsharded")
    logit_err = (tp["logits"].double() - lg32).abs().max().item()
    if not logit_err <= TP_LOGITS_ATOL:
        failures.append(f"tensor parallel: logits {logit_err:.3e} off the unsharded > "
                        f"{TP_LOGITS_ATOL}")
    zeros = {k: torch.zeros_like(g) for k, g in g64.items()}
    bad, errs = median_rule("tensor parallel", zeros, tp["grads"], g32, g64, FED_DELTA_MEDIAN,
                            FED_F32_FACTOR)
    failures += bad
    worst = max((e, k, e32) for k, (e, e32) in errs.items())
    print(f"ResNet-50 over (data 2, model 2) ({TP_BATCH} x {FED_SIZE}px, float32, TF32 off, eval "
          f"mode): {len(tp['split'])} of {len(g64)} leaves split; loss {tp['loss']:.6f} "
          f"(unsharded {l32:.6f}, float64 {l64:.6f}); logits {logit_err:.3e} off the unsharded; "
          f"worst gradient leaf median |g - g_64| / max |g_64| {worst[0]:.2e} ({worst[1]}; the "
          f"unsharded float32's {worst[2]:.2e}); step {tp['seconds']:.2f} s on the ranks, "
          f"{s32:.3f} s unsharded")
    if failures:
        fail("\n  ".join(failures[:40]))
    return {"card": smi, "ranks": SHARD_WORLD, "backend": "gloo (ranks share the card)",
            "images": n_img, "image_size": images_u8.shape[1], "styles": len(s_means),
            "routes": routes,
            "tensor_parallel": {
                "network": FED_NET, "mesh": {"data": 2, "model": 2}, "batch": TP_BATCH,
                "image_size": FED_SIZE, "precision": "float32, TF32 off, cuDNN deterministic",
                "min_dim": TP_MIN_DIM, "split_leaves": len(tp["split"]), "leaves": len(g64),
                "loss": tp["loss"], "loss_unsharded": l32, "loss_float64": l64,
                "logits_max_abs_err": logit_err, "worst_leaf": worst,
                "step_seconds": tp["seconds"], "unsharded_step_seconds": s32},
            "ranks_seconds": ranks_seconds, "phase_seconds": time.perf_counter() - t_phase,
            "launches": launches}


# -- the end-to-end validation experiments (phase 11) ---------------------------

EXP_STYLES = 3               # shapes4: every content domain is stylized under the 3 others
# tests/test_privacy_leakage.py's bars: the leakage gap (here the median over
# EXP_DRAWS, the seeds of the privacy run's initial_weights; 0 the default),
# and Overall at most the mean image + the slack on every draw
EXP_PRIVACY_GAP_DB, EXP_OVERALL_SLACK_DB = 2.0, 0.5
EXP_DRAWS = (0, 1000, 2000)
EXP_SEMANTIC_KEYS = {        # the JAX scripts' artifact keys (EXPERIMENT_*.json)
    "benchmark", "seeds", "rounds", "n_train_per_domain", "per_arm", "mean_test_acc",
    "sd_test_acc", "n_seeds_per_arm", "ccst_gain_bf16_vs_no_fusion", "int8_vs_bf16_gap",
    "ccst_gain_single_vs_no_fusion", "per_seed_gain", "paired_orderings"}
EXP_PRIVACY_KEYS = {"benchmark", "image_size", "n_train_per_domain", "steps", "per_source",
                    "finding", "min_leakage_gap_db"}


def plain_apply(params, x, arch, stop_at=""):
    """A VGG spec walked with K3's plain version at every 3x3 conv (``params``
    prepared for the kernel route)."""
    from ccst_tpu_torch.kernels.conv import reflect_conv3x3_reference
    from ccst_tpu_torch.models import vgg

    for layer in arch:
        if isinstance(layer, vgg.Conv):
            cw = params[layer.name]
            if layer.ksize == 3:
                x = reflect_conv3x3_reference(x, cw.w, cw.b, layer.relu)
            else:
                x = vgg.conv1x1(x, cw)
        elif isinstance(layer, vgg.Pool):
            x = vgg.maxpool_ceil(x)
        elif isinstance(layer, vgg.Upsample):
            x = vgg.upsample_nearest2x(x)
        elif isinstance(layer, vgg.Tap) and layer.name == stop_at:
            return x
    return x


def experiment_launches(stage, args, kw):
    """The kernel launches a stage of the experiments must make: phase 4's
    formulas (a bank batch 9 K3 + 1 K5; a stylize batch ``ref`` 9 + 9 S K3 and
    one K4 for the S banks, ``int8-static`` 9 + 9 S K0 and one K4; Single mode
    27 K3 + 1 K5 + 1 K4 a batch and style) and phase 8's (a decoder step 18
    K3; an inverter step 9 K3 for its style vectors, a val batch 9; an
    evaluation batch 27, Overall 18), at the experiments' sizes."""
    from ccst_tpu_torch.data.lists import parse_list, train_list_path
    from ccst_tpu_torch.privacy.invert import _split_indices

    def batches(cfg, domain):
        n = len(parse_list(train_list_path(cfg.list_root, cfg.dataset, domain))[0])
        return -(-n // cfg.batch_size)

    def held_out(cfg):
        n = len(parse_list(train_list_path(cfg.list_root, cfg.dataset, cfg.source))[0])
        return len(_split_indices(cfg, n)[0])

    cfg = args[0] if args else None
    if stage == "make_experiment_encoder":
        return {"K3": 9}  # the LSUV pass: conv1_1 .. conv4_1
    if stage == "compute_style_bank":
        nb = batches(cfg, args[1])
        return {"K3": 9 * nb, "K5": nb}
    if stage == "run_overall_transfer":
        nb, conv = batches(cfg, cfg.target), "K3" if args[1].engine == "ref" else "K0"
        return {conv: (9 + 9 * EXP_STYLES) * nb, "K4": nb}
    if stage == "run_single_transfer":
        n = batches(cfg, cfg.target) * EXP_STYLES
        return {"K3": 27 * n, "K5": n, "K4": n}
    if stage == "train_decoder":
        return {"K3": 18 * cfg.steps}
    if stage == "train_inverter":
        evals = sum((i + 1) % max(50, cfg.steps // 20) == 0 or i == cfg.steps - 1
                    for i in range(cfg.steps))
        return {"K3": 9 * cfg.steps + 9 * -(-held_out(cfg) // cfg.batch_size) * evals}
    if stage == "evaluate_inverter":
        nb = -(-min(cfg.eval_limit, held_out(cfg)) // cfg.batch_size)
        return {"K3": (18 if kw.get("overall") else 27) * nb}
    return {}  # pretraining, calibration, federated training: no TPU kernel


def spread_of(tag, out):
    """The span of a stylized output; fails below MIN_SPREAD, where an MAE bar
    would say little."""
    span = (out.max() - out.min()).item()
    if not span >= MIN_SPREAD:
        fail(f"phase 11 {tag}: outputs span {span:.3f} < {MIN_SPREAD}: the MAE bar would say "
             "little")
    return span


def time_k3_layers(torch, engine, x, mean, std):
    """K3 float32 at every distinct conv shape of the ``ref`` stylize of ``x``
    under one style (the encoder to relu4_1, then the decoder of its AdaIN
    output), on the layer's own input and weights: the kernel, cuDNN's float32
    conv (TF32 off) and K3's plain version, each from a replayed CUDA graph,
    beside the bound and the launches a stylize batch of EXP_STYLES styles."""
    from ccst_tpu_torch.benchmarks.small_kernels import graph_ms
    from ccst_tpu_torch.kernels.adain import fused_adain_reference
    from ccst_tpu_torch.kernels.conv import reflect_conv3x3, reflect_conv3x3_reference
    from ccst_tpu_torch.models import vgg
    from ccst_tpu_torch.utils.precision import no_tf32

    layers = {}  # shape -> (names, input, weights, relu, launches a batch)

    def walk(params, h, arch, styles, stop_at=""):
        for layer in arch:
            if isinstance(layer, vgg.Conv):
                cw = params[layer.name]
                if layer.ksize == 3:
                    shape = (*h.shape, cw.w.shape[-1])
                    names, _, _, _, n = layers.get(shape, ([], h, cw, layer.relu, 0))
                    layers[shape] = ([*names, layer.name], h, cw, layer.relu, n + styles)
                    h = reflect_conv3x3_reference(h, cw.w, cw.b, layer.relu)
                else:
                    h = vgg.conv1x1(h, cw)
            elif isinstance(layer, vgg.Pool):
                h = vgg.maxpool_ceil(h)
            elif isinstance(layer, vgg.Upsample):
                h = vgg.upsample_nearest2x(h)
            elif isinstance(layer, vgg.Tap) and layer.name == stop_at:
                return h
        return h

    out = {}
    with torch.no_grad(), no_tf32():
        feat = walk(engine.enc, x, vgg.ENCODER_ARCH, 1, stop_at="relu4_1")
        walk(engine.dec, fused_adain_reference(feat, mean, std, 1.0), vgg.DECODER_ARCH,
             EXP_STYLES)
        for shape, (names, h, cw, relu, n) in layers.items():
            cudnn = cudnn_bf16_conv(torch, h, cw)
            row = dict(layers=names, launches_a_batch=n,
                       **conv_bound(shape, F32_PEAK_TFLOPS, 4, 4))
            for key, fn in (("ms", lambda: reflect_conv3x3(h, cw, relu)),
                            ("cudnn_f32_ms", cudnn),
                            ("plain_ms", lambda: reflect_conv3x3_reference(h, cw.w, cw.b, relu))):
                row[key] = graph_ms(torch, fn, 20, 5)["median"]
            out[str(list(shape))] = row
    return out


def run_experiments_phase(torch, dev, smi, counters):
    """Phase 11: the port's semantic validation (``--quick``: all four arms,
    seed 1) and privacy finding (``--quick``) on the card, each stage's launches
    read around it; the privacy bars; then the card's kernels against their
    plain versions on the chain's own 32 px images, banks and weights."""
    import numpy as np

    from ccst_tpu_torch.data.lists import parse_list, train_list_path
    from ccst_tpu_torch.experiments import privacy_leakage as tpl
    from ccst_tpu_torch.experiments import semantic_validation as tsv
    from ccst_tpu_torch.kernels.adain import fused_adain_multi_reference, fused_adain_reference
    from ccst_tpu_torch.kernels.moments import channel_moments, channel_moments_reference
    from ccst_tpu_torch.kernels.qconv import qconv3x3_s8_reference
    from ccst_tpu_torch.models import convert, vgg, vgg_fast
    from ccst_tpu_torch.pipeline.style_bank import load_style_stats
    from ccst_tpu_torch.pipeline.stylize import StylizeEngine

    t_phase = time.perf_counter()
    stages = []  # (experiment, stage, launches, expected)
    current = [""]  # the experiment running

    def counted(module, name):
        inner = getattr(module, name)

        def stage(*args, **kw):
            before = {k: fn.launches for k, fn in counters.items()}
            out = inner(*args, **kw)
            torch.cuda.synchronize()
            got = {k: fn.launches - before[k] for k, fn in counters.items()}
            want = experiment_launches(name, args, kw)
            stages.append((current[0], name, got, {k: want.get(k, 0) for k in counters}))
            return out
        setattr(module, name, stage)
        return inner

    wrapped = [(tsv, n) for n in (
        "make_experiment_encoder", "pretrain_encoder", "train_decoder", "compute_style_bank",
        "run_calibration", "run_overall_transfer", "run_single_transfer", "run_fed")]
    wrapped += [(tpl, n) for n in (
        "make_experiment_encoder", "pretrain_encoder", "compute_style_bank", "train_inverter",
        "evaluate_inverter")]
    originals = [(m, n, counted(m, n)) for m, n in wrapped]
    with tempfile.TemporaryDirectory(prefix="ccst_smoke_exp_") as work:
        sem_out = os.path.join(work, "semantic.json")

        def privacy(seed):
            """The privacy finding at ``--quick`` from ``initial_weights(seed)``:
            the default through the CLI's ``main``, the others through ``run``."""
            out = os.path.join(work, f"privacy_{seed}.json")
            dirs = [os.path.join(work, f"grids_{seed}"), os.path.join(work, f"pl_{seed}")]
            if seed == 0:
                return lambda: tpl.main(["--quick", "--device", "cuda", "--out", out,
                                         "--grids", dirs[0], "--workdir", dirs[1]])
            enc0, dec0, head0 = tsv.initial_weights(seed)
            return lambda: tpl.run(dirs[1], out, dirs[0], **tpl.QUICK, device="cuda",
                                   init=enc0, dec=dec0, head=head0)

        totals = {}
        try:
            for experiment, run in (
                    ("semantic", lambda: tsv.main([
                        "--quick", "--device", "cuda", "--seeds", "1", "--out", sem_out,
                        "--workdir", os.path.join(work, "sv")])),
                    *((f"privacy {seed}", privacy(seed)) for seed in EXP_DRAWS)):
                for fn in counters.values():
                    fn.launches = 0
                current[0] = experiment
                t0 = time.perf_counter()
                out = io.StringIO()
                with contextlib.redirect_stdout(out):
                    run()
                torch.cuda.synchronize()
                totals[experiment] = {k: fn.launches for k, fn in counters.items()}
                print(f"{experiment}: {time.perf_counter() - t0:.1f} s; last lines: "
                      + " | ".join(out.getvalue().strip().splitlines()[-3:])[-600:])
        finally:
            for m, n, inner in originals:
                setattr(m, n, inner)

        # (c) every stage's launches, and nothing launched outside the stages
        for experiment, name, got, want in stages:
            if got != want:
                fail(f"phase 11 {experiment} {name}: kernel launches {got}, expected {want}")
        for experiment, total in totals.items():
            want = {k: sum(w[k] for e, _, _, w in stages if e == experiment) for k in counters}
            if total != want:
                fail(f"phase 11 {experiment}: {total} launches in all, its stages {want}")
        by_stage = {}
        for experiment, name, got, _ in stages:
            row = by_stage.setdefault(f"{experiment} {name}", {"calls": 0})
            row["calls"] += 1
            for k, v in got.items():
                if v:
                    row[k] = row.get(k, 0) + v
        print("phase 11 launches by stage (as expected): " + json.dumps(by_stage))

        # (d) the artifacts: the JAX scripts' keys and the device
        with open(sem_out) as f:
            sem = json.load(f)
        privs = {}
        for seed in EXP_DRAWS:
            with open(os.path.join(work, f"privacy_{seed}.json")) as f:
                privs[seed] = json.load(f)
        for tag, art, keys in (("semantic", sem, EXP_SEMANTIC_KEYS),
                               *((f"privacy {seed}", a, EXP_PRIVACY_KEYS)
                                 for seed, a in privs.items())):
            if not keys <= set(art) or art.get("device") != smi:
                fail(f"phase 11 {tag} artifact: keys {sorted(set(art))}, device "
                     f"{art.get('device')!r} (expected {smi!r})")
        if sorted(r["seed"] for rs in sem["per_arm"].values() for r in rs) != [1, 1, 1, 1]:
            fail(f"phase 11: the semantic run measured {sem['per_arm']}")
        for arm, acc in sem["mean_test_acc"].items():
            if not 0.0 <= acc <= 1.0:
                fail(f"phase 11: {arm} accuracy {acc}")

        # (a) the privacy finding at the --quick sizes, over the draws
        draws = {}
        for seed, art in privs.items():
            r = art["per_source"]["rot0"]
            draws[seed] = {"per_image_psnr": r["per_image"]["psnr_mean"],
                           "overall_psnr": r["overall"]["psnr_mean"],
                           "mean_image_psnr": r["mean_image_baseline"]["psnr_mean"],
                           "leakage_gap_db": r["leakage_gap_db"]}
            print(f"privacy (--quick, rot0, initial_weights({seed})): " + json.dumps(draws[seed]))
            if not r["overall"]["psnr_mean"] <= (r["mean_image_baseline"]["psnr_mean"]
                                                 + EXP_OVERALL_SLACK_DB):
                fail(f"phase 11 draw {seed}: overall {r['overall']['psnr_mean']:.2f} dB > mean "
                     f"image {r['mean_image_baseline']['psnr_mean']:.2f} + {EXP_OVERALL_SLACK_DB}")
        gap = float(np.median([d["leakage_gap_db"] for d in draws.values()]))
        if not gap > EXP_PRIVACY_GAP_DB:
            fail(f"phase 11: median leakage gap {gap:.2f} dB <= {EXP_PRIVACY_GAP_DB}")

        # (b) the kernels at the chain's own small shapes against their plain
        # versions on the card (these launches are not the main path's)
        sv_root = os.path.join(work, "sv", "bf16_s1")
        q8_root = os.path.join(work, "sv", "int8_s1")
        enc = convert.load_encoder(os.path.join(sv_root, "encoder_lsuv.npz"))
        dec = convert.load_decoder(os.path.join(sv_root, "decoder_trained.npz"))
        size = tsv.IMAGE_SIZE
        names = parse_list(train_list_path(sv_root, "shapes4", "rot0"))[0][:8]
        images_u8 = torch.from_numpy(read_images(
            [os.path.join(sv_root, n) for n in names])).to(dev)
        small = {}

        def banks(root):
            stats = [load_style_stats(os.path.join(root, "style_stats", "shapes4",
                                                   f"{d}_mean_std.npz"))
                     for d in tsv.DOMAINS if d != "rot0"]
            return (torch.tensor(np.stack([m for m, _ in stats]), device=dev),
                    torch.tensor(np.stack([s for _, s in stats]), device=dev))

        s_means, s_stds = banks(sv_root)
        engine32 = StylizeEngine(enc, dec, dtype=torch.float32, device=dev)
        got = engine32.stylize_multi(images_u8, s_means, s_stds, 1.0)
        with torch.no_grad():
            feat = plain_apply(engine32.enc, images_u8.float() / 255.0, vgg.ENCODER_ARCH,
                               stop_at="relu4_1")
            want = torch.stack([plain_apply(engine32.dec, fused_adain_reference(feat, m, s, 1.0),
                                            vgg.DECODER_ARCH)
                                for m, s in zip(s_means, s_stds)])
        if got.shape != (EXP_STYLES, 8, size, size, 3) or not bool(got.isfinite().all()):
            fail(f"phase 11 ref float32: shape {tuple(got.shape)} or non-finite values")
        small["ref float32 MAE"] = (got - want).abs().mean().item()
        small["ref float32 output span"] = spread_of("ref float32", want)
        if not small["ref float32 MAE"] <= F32_MAE_BAR:
            fail(f"phase 11 ref float32 at {size} px: MAE {small['ref float32 MAE']:.3e} > "
                 f"{F32_MAE_BAR}")
        # Single mode's style statistics: K3 float32 and K5 on one 4 x 4 map
        s_mean, s_std = engine32.style_stats_of(images_u8[:1])
        mean, m2, count = channel_moments_reference(feat[:1])
        small["single stats max err"] = max(
            check_close("phase 11 single mean", s_mean, mean, rtol=1e-5, atol=1e-6)[0],
            check_close("phase 11 single std", s_std, torch.sqrt(m2 / count + 1e-5),
                        rtol=1e-4, atol=1e-6)[0])

        scales = vgg_fast.load_scales(os.path.join(q8_root, "style_stats", "shapes4",
                                                   "rot0_q8_scales.json"))
        q_means, q_stds = banks(q8_root)
        engine8 = StylizeEngine(enc, dec, dtype=torch.bfloat16, device=dev, engine="int8-static",
                                scales=scales)
        got8 = engine8.stylize_multi(images_u8, q_means, q_stds, 1.0)
        ep = vgg_fast.prepare_encoder_q8s(engine8._enc_w, scales, torch.bfloat16, dev)
        dp = vgg_fast.prepare_decoder_q8s(engine8._dec_w, scales, torch.bfloat16, dev)

        def plain_qconv(x, q, relu, dtype, pad):
            return qconv3x3_s8_reference(x, q.wq, q.k, q.kb, relu, q.requant, dtype, pad)

        with torch.no_grad():
            x8 = (images_u8.float() / 255.0).to(torch.bfloat16)
            feat8 = vgg_fast._encode(ep, x8, torch.bfloat16, False, qconv=plain_qconv)
            check_equal(torch, f"phase 11 int8-static relu4_1 {tuple(feat8.shape)}",
                        vgg_fast.apply_encoder_q8s(ep, x8), feat8)
            want8 = torch.stack([
                vgg_fast._decode(dp, fused_adain_reference(feat8, m, s, 1.0), torch.bfloat16,
                                 False, qconv=plain_qconv).float()
                for m, s in zip(q_means, q_stds)])
        small["int8-static MAE"] = (got8 - want8).abs().mean().item()
        small["int8-static output span"] = spread_of("int8-static", want8)
        if got8.shape != want8.shape or not small["int8-static MAE"] <= MAE_BAR:
            fail(f"phase 11 int8-static at {size} px: shape {tuple(got8.shape)}, MAE "
                 f"{small['int8-static MAE']:.3e} > {MAE_BAR}")

        # the banks' moments: K5 on each domain's first bank batch of relu4_1
        # and the bf16 encoder (K3 bf16) that gives them against its plain version,
        # per image within Z_REL_TOL of the image's largest feature (phase 8's rule)
        enc16 = vgg.prepare_params(enc, torch.bfloat16, dev)
        k5_err, z_err = [0.0, 0.0], 0.0
        for d in tsv.DOMAINS:
            paths = parse_list(train_list_path(sv_root, "shapes4", d))[0][:8]
            x = torch.from_numpy(read_images([os.path.join(sv_root, p) for p in paths])).to(dev)
            with torch.no_grad():
                x16 = (x.float() / 255.0).to(torch.bfloat16)
                f = vgg.apply_encoder(enc16, x16)
                f_plain = plain_apply(enc16, x16, vgg.ENCODER_ARCH, stop_at="relu4_1")
            peak = f_plain.float().flatten(1).abs().amax(dim=1)
            z_err = max(z_err, ((f.float() - f_plain.float()).flatten(1).abs().amax(dim=1)
                                / peak).max().item())
            if f.shape != f_plain.shape or not bool(f.isfinite().all()) or not z_err <= Z_REL_TOL:
                fail(f"phase 11 bf16 encoder {d} {tuple(f.shape)}: {z_err:.3e} of the image's "
                     f"largest feature > {Z_REL_TOL}")
            (gm, gm2, gc), (rm, rm2, rc) = channel_moments(f), channel_moments_reference(f)
            if gc.item() != rc.item():
                fail(f"phase 11 K5 {tuple(f.shape)}: count {gc.item()} != {rc.item()}")
            k5_err[0] = max(k5_err[0], check_close(f"phase 11 K5 mean {d} {tuple(f.shape)}",
                                                   gm, rm, rtol=1e-5, atol=0.0)[0])
            k5_err[1] = max(k5_err[1], check_close(f"phase 11 K5 m2 {d} {tuple(f.shape)}",
                                                   gm2, rm2, rtol=1e-4, atol=0.0)[0])
        small["K5 mean max err"], small["K5 m2 max err"] = k5_err
        small["bf16 encoder relu4_1 err (of each image's max)"] = z_err
        print(f"phase 11 at {size} px against the plain versions: " + json.dumps(small))

        # the device times at these shapes (replayed CUDA graphs), beside the bounds
        from ccst_tpu_torch.benchmarks.small_kernels import graph_ms
        from ccst_tpu_torch.kernels.adain import fused_adain_multi

        with torch.no_grad():
            f32 = vgg.apply_encoder(engine32.enc, images_u8.float() / 255.0)
            f16 = vgg_fast.apply_encoder_q8s(ep, x8)
        timed = {}
        for name, fn, plain, t in (
                (f"K5 {tuple(f.shape)} bf16", lambda: channel_moments(f),
                 lambda: channel_moments_reference(f), f),
                (f"K4 {tuple(f32.shape)} float32 S=3",
                 lambda: fused_adain_multi(f32, s_means, s_stds, 1.0),
                 lambda: fused_adain_multi_reference(f32, s_means, s_stds, 1.0), f32),
                (f"K4 {tuple(f16.shape)} bf16 S=3",
                 lambda: fused_adain_multi(f16, q_means, q_stds, 1.0),
                 lambda: fused_adain_multi_reference(f16, q_means, q_stds, 1.0), f16)):
            n, nbytes = t.numel(), t.element_size()
            bd = (bound(6 * n, F32_PEAK_TFLOPS, n * nbytes) if name.startswith("K5") else
                  bound((4 + 6 * EXP_STYLES) * n, F32_PEAK_TFLOPS, (1 + EXP_STYLES) * n * nbytes))
            timed[name] = dict(ms=graph_ms(torch, fn, SMALL_REPS, 5)["median"],
                               plain_ms=time_ms(torch, plain, reps=20, runs=3), **bd)
        timed[f"K5 {tuple(f.shape)} bf16"]["library_ms"] = graph_ms(
            torch, lambda: torch.var_mean(f, dim=(0, 1, 2), correction=0), SMALL_REPS, 5)["median"]

        # the int8-static batch's bound: each K0 launch of one encode and the
        # decodes of every style, and K4, each at its own bound
        k0_shapes = []

        def recorded_qconv(x, q, relu, dtype, pad):
            y = vgg_fast.qconv3x3_s8(x, q, relu, dtype, pad)
            k0_shapes.append((*x.shape, y.shape[-1], y.element_size()))
            return y

        with torch.no_grad():
            f8 = vgg_fast._encode(ep, x8, torch.bfloat16, False, qconv=recorded_qconv)
            for m, sd in zip(q_means, q_stds):
                vgg_fast._decode(dp, fused_adain_reference(f8, m, sd, 1.0), torch.bfloat16,
                                 False, qconv=recorded_qconv)
        q8_bound = sum(conv_bound(shape[:5], INT8_PEAK_TOPS, 1, shape[5])["bound_ms"]
                       for shape in k0_shapes) + timed[f"K4 {tuple(f16.shape)} bf16 S=3"]["bound_ms"]

        def plain_q8():
            with torch.no_grad():
                feat = vgg_fast._encode(ep, x8, torch.bfloat16, False, qconv=plain_qconv)
                return [vgg_fast._decode(dp, fused_adain_reference(feat, m, sd, 1.0),
                                         torch.bfloat16, False, qconv=plain_qconv)
                        for m, sd in zip(q_means, q_stds)]

        for name, eng, m, sd in (("stylize_multi ref float32", engine32, s_means, s_stds),
                                 ("stylize_multi int8-static", engine8, q_means, q_stds)):
            timed[f"{name} (8 x {size} px, 3 styles)"] = dict(ms=graph_ms(
                torch, lambda: eng.stylize_multi(images_u8, m, sd, 1.0), 1, 5)["median"])
        timed[f"stylize_multi int8-static (8 x {size} px, 3 styles)"].update(
            plain_ms=time_ms(torch, plain_q8, reps=2, runs=3), bound_ms=q8_bound,
            bound_by="the sum of the K0 and K4 launches' bounds", k0_launches=len(k0_shapes))
        print(f"phase 11 device times at {size} px: " + json.dumps(timed))
        k3_f32 = time_k3_layers(torch, engine32, images_u8.float() / 255.0, s_means[0],
                                s_stds[0])
        total = sum(r["ms"] * r["launches_a_batch"] for r in k3_f32.values())
        print(f"phase 11 K3 float32 by layer at {size} px (graph replays; the ref stylize's "
              f"{sum(r['launches_a_batch'] for r in k3_f32.values())} launches sum to "
              f"{total:.4f} ms): " + json.dumps(k3_f32))

    launches = {k: sum(t[k] for t in totals.values()) for k in counters}
    stage_seconds = {f"{tag} {t['stage']}" + "".join(f" {t[k]}" for k in ("arm", "source")
                                                      if k in t): t["seconds"]
                     for tag, art in (("semantic", sem),
                                      *((f"privacy {seed}", a) for seed, a in privs.items()))
                     for t in art["timing"]}
    return {"device": smi, "stage_seconds": stage_seconds,
            "mean_test_acc": sem["mean_test_acc"], "median_leakage_gap_db": gap,
            "privacy_draws": draws, "small_shapes": small, "small_shape_ms": timed,
            "k3_float32_by_layer": k3_f32,
            "launches_by_stage": by_stage,
            "launches": {k: v for k, v in launches.items() if v},
            "phase_seconds": time.perf_counter() - t_phase}


def check_step_bits(torch, dev):
    """ROADMAP F3: one ResNet-50 step (fedavg, batch 32, 222 px, TF32 off)
    twice in this process and once in another, bit for bit, with cuDNN as the
    runner leaves it and in its deterministic mode; and the step's time in
    each mode."""
    from ccst_tpu_torch.benchmarks import fed_bits
    from ccst_tpu_torch.utils.precision import no_tf32

    out = {}
    for det in (False, True):
        here = fed_bits.step_digests(dev, 2, deterministic=det)
        proc = subprocess.run([sys.executable, "-m", "ccst_tpu_torch.benchmarks.fed_bits",
                               "--repeats", "1", *(["--deterministic"] if det else [])],
                              cwd=HERE, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            fail(f"fed_bits exited {proc.returncode}: {proc.stderr[-2000:]}")
        there = json.loads(proc.stdout.strip().splitlines()[-1])["digests"]
        with no_tf32(deterministic=det):
            run = fed_bits.make_case(dev)
            ms = time_ms(torch, run, reps=5, runs=5)
        key = "deterministic" if det else "default"
        out[key] = {"same_in_process": here[0] == here[1], "same_across_processes":
                    here[0] == there[0], "step_ms": ms, "digests": [*here, *there]}
        print(f"step bits ({key} cuDNN): same twice in one process {here[0] == here[1]}, "
              f"same in a second process {here[0] == there[0]}; step {ms:.2f} ms")
    out["deterministic_cost"] = out["deterministic"]["step_ms"] / out["default"]["step_ms"] - 1
    if not (out["deterministic"]["same_in_process"] and out["deterministic"]["same_across_processes"]):
        fail("cuDNN's deterministic mode gave different bits for the same step")
    return out


def run_harnesses(torch, counters):
    """Phase 6: the three int8 A/B harnesses in this process, each with every
    launch count zeroed before it and read after it; the counts must be the
    ones its arguments imply. Returns the B kernels' counts."""
    from ccst_tpu_torch.benchmarks import fused_pool_conv_ab, int8_mm, winograd_ab

    ids = {"tiled_mm": "B1", "conv_direct": "B2-direct", "conv_wino": "B2-wino",
           "pool_conv_fused": "B3", "qconv3x3_s8": "K0"}
    launches = {}
    for mod, argv in ((int8_mm, HARNESS_REPS), (winograd_ab, HARNESS_REPS),
                      (fused_pool_conv_ab, ["--batch", str(B3_HARNESS_BATCH), *HARNESS_REPS])):
        name = mod.__name__.rsplit(".", 1)[1]
        expect = {k: 0 for k in counters}
        expect.update({ids[fn]: count for fn, count in mod.planned_launches(mod.parse_args(argv)).items()})
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        mod.main(argv)
        torch.cuda.synchronize()
        got = {k: fn.launches for k, fn in counters.items()}
        if got != expect:
            fail(f"harness {name}: kernel launches {got}, expected {expect}")
        print(f"harness {name} ({time.perf_counter() - t0:.1f} s): kernel launches "
              f"{ {k: v for k, v in got.items() if v} } (as expected)")
        for k, v in got.items():
            if k.startswith("B"):
                launches[k] = launches.get(k, 0) + v
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--images-per-domain", type=int, default=12)
    ap.add_argument("--batch-size", type=int, default=4)
    # one rank of phase 9's (d) / (e) or of phase 10, started by the script itself
    ap.add_argument("--rank-worker", choices=["invert", "decoder", "shard"],
                    help=argparse.SUPPRESS)
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--init", help=argparse.SUPPRESS)
    ap.add_argument("--work-dir", help=argparse.SUPPRESS)
    args = ap.parse_args()
    images_per_domain, batch = args.images_per_domain, args.batch_size
    if images_per_domain < batch:
        raise SystemExit("chip_smoke: --images-per-domain must be at least --batch-size")

    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs only on a GPU", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "ccst_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    if args.rank_worker:
        return shard_worker(args) if args.rank_worker == "shard" else rank_worker(args)

    from ccst_tpu_torch.benchmarks.small_kernels import graph_ms
    from ccst_tpu_torch.kernels import _build
    from ccst_tpu_torch.kernels.adain import (
        fused_adain,
        fused_adain_multi,
        fused_adain_reference,
    )
    from ccst_tpu_torch.kernels.int8_mm import tiled_mm
    from ccst_tpu_torch.kernels.pool_conv import pool_conv_fused
    from ccst_tpu_torch.kernels.winograd import conv_direct, conv_wino
    from ccst_tpu_torch.kernels.conv import (
        prepare_conv,
        reflect_conv3x3,
        reflect_conv3x3_reference,
    )
    from ccst_tpu_torch.kernels.level1 import (
        decoder_level1,
        encoder_level1,
        encoder_level1_reference,
        phase_max,
    )
    from ccst_tpu_torch.kernels.moments import channel_moments
    from ccst_tpu_torch.kernels.qconv import qconv3x3_s8, qconv3x3_s8_reference

    # -- 1. device ---------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}")

    # -- 2. build ----------------------------------------------------------
    cached = _build.library_path().exists()
    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc sm_90a, "
          f"{'reused' if cached else 'compiled'} {_build.library_path().name})")

    # -- 3. kernels vs plain versions --------------------------------------
    gen = torch.Generator().manual_seed(0)
    results = {k: [] for k in ("K3", "K4", "K4-given", "K5", "K0", "K1", "K2", "B1", "B2-direct",
                               "B2-wino", "B3", "W1")}

    for layer, shape in K3_SHAPES + K3_WCT_SHAPES:
        results["K3"] += k3_bf16_rows(torch, dev, gen, layer, shape)

    # K3's exact float32 route (the engines' --dtype float32): FFMA sums, TF32
    # off on both sides, cuDNN's float32 conv timed beside it for comparison only
    for layer, (n, h, w, cin, cout) in K3_F32_SHAPES:
        x = torch.randn((n, h, w, cin), generator=gen).to(dev)
        spread = (1.0 / (9 * cin)) ** 0.5
        wt = (torch.rand((3, 3, cin, cout), generator=gen) * 2 - 1) * spread
        b = (torch.rand((cout,), generator=gen) * 2 - 1) * spread
        cw = prepare_conv(wt, b, torch.float32, dev)
        bd = conv_bound((n, h, w, cin, cout), F32_PEAK_TFLOPS, 4, 4)
        flop = 2 * n * h * w * 9 * cin * cout
        for relu in (True, False):
            got = reflect_conv3x3(x, cw, relu)
            torch.cuda.synchronize()
            want = reflect_conv3x3_reference(x, cw.w, cw.b, relu)
            mx, mean = check_close(f"K3 float32 {(n, h, w, cin, cout)} relu={relu}", got, want,
                                   **K3_F32_TOL)
            row = dict(layer=layer, shape=[n, h, w, cin, cout], relu=relu, dtype="torch.float32",
                       max_abs_err=mx, mean_abs_err=mean)
            if relu:  # every shape timed once, cuDNN's float32 conv (TF32 off) beside it
                ms = time_ms(torch, lambda: reflect_conv3x3(x, cw, True), reps=3, runs=3)
                plain = time_ms(torch, lambda: reflect_conv3x3_reference(x, cw.w, cw.b, True),
                                reps=2, runs=3)
                lib = time_ms(torch, cudnn_bf16_conv(torch, x, cw), reps=2, runs=3)
                row.update(ms=ms, plain_ms=plain, cudnn_f32_ms=lib, **bd)
                line = (f"K3 conv float32 {layer} {(n, h, w, cin, cout)}: max {mx:.3e} mean "
                        f"{mean:.3e} | kernel {ms:.4f} ms ({flop / (ms * 1e-3) / 1e12:.2f} TFLOP/s) "
                        f"bound {bd['bound_ms']:.4f} ms by {bd['bound_by']} "
                        f"({100 * bd['bound_ms'] / ms:.1f}% reached) cuDNN float32, TF32 off "
                        f"{lib:.4f} ms ({lib / ms:.2f}x the kernel) plain {plain:.4f} ms")
                if ms < GRAPH_BELOW_MS:
                    row["graph_ms"] = graph_ms(torch, lambda: reflect_conv3x3(x, cw, True), 20,
                                               5)["median"]
                    line += f"; graph {row['graph_ms']:.4f} ms"
                print(line)
            else:
                print(f"K3 conv float32 {layer} {(n, h, w, cin, cout)} relu={relu}: "
                      f"max {mx:.3e} mean {mean:.3e}")
            results["K3"].append(row)
    del x, got, want

    check_small_kernels(torch, dev, gen, results, batch)
    results["W1"] += check_wct_centre(torch, dev)

    # ragged edges, correctness only: the smallest reflectable plane (below the
    # 8 x 16 tile), planes that are no multiple of it with Cout = 3 and N > 1,
    # the scalar Cin = 3 gather, two rows, Cin ending inside a 64-channel chunk
    # with Cout off the 8-channel store, Cout over two 128-wide tiles
    for (n, h, w, cin, cout) in ((1, 2, 2, 64, 64), (3, 17, 9, 128, 3), (1, 5, 3, 3, 64),
                                 (2, 2, 19, 64, 64), (1, 9, 20, 80, 12), (2, 11, 33, 16, 136)):
        x = torch.randn((n, h, w, cin), generator=gen).to(dev, torch.bfloat16)
        cw = prepare_conv(torch.randn((3, 3, cin, cout), generator=gen) * 0.1,
                          torch.randn((cout,), generator=gen), torch.bfloat16, dev)
        got = reflect_conv3x3(x, cw, True)
        torch.cuda.synchronize()
        check_close(f"K3 edge {(n, h, w, cin, cout)}", got,
                    reflect_conv3x3_reference(x, cw.w, cw.b, True), **BF16_TOL)
    torch.cuda.synchronize()
    print("edge shapes: K3 agrees with its plain version")

    check_int8_kernels(torch, dev, gen, results)
    check_new_modes(torch, dev, gen, results)
    check_ab_kernels(torch, dev, gen, results)

    # -- 4. the main paths through the CLI ---------------------------------
    import numpy as np

    from ccst_tpu_torch import cli
    from ccst_tpu_torch.benchmarks.stylize_profile import write_tree
    from ccst_tpu_torch.models import convert, vgg, vgg_fast
    from ccst_tpu_torch.pipeline.style_bank import load_style_stats
    from ccst_tpu_torch.pipeline.stylize import StylizeEngine

    from ccst_tpu_torch.kernels.wct import centre_split
    from ccst_tpu_torch.pipeline import wct

    counters = {"K3": reflect_conv3x3, "K4": fused_adain_multi, "K5": channel_moments,
                "K0": qconv3x3_s8, "K1": encoder_level1, "K2": decoder_level1,
                "B1": tiled_mm, "B2-direct": conv_direct, "B2-wino": conv_wino,
                "B3": pool_conv_fused, "W1": centre_split}
    launches = {k: 0 for k in counters}
    with tempfile.TemporaryDirectory(prefix="ccst_smoke_") as root:
        t0 = time.perf_counter()
        write_tree(root, images_per_domain, SIZE)
        print(f"synthetic tree: {len(DOMAINS)} x {images_per_domain} PNGs at {SIZE} px "
              f"in {time.perf_counter() - t0:.1f} s")
        enc = vgg.init_params(vgg.ENCODER_ARCH, torch.Generator().manual_seed(42))
        dec = vgg.init_params(vgg.DECODER_ARCH, torch.Generator().manual_seed(43))
        last = dec["dconv1_1"]
        last["w"], last["b"] = last["w"] * DEC_SCALE, last["b"] * DEC_SCALE + DEC_SHIFT
        enc_path = os.path.join(root, "vgg.npz")
        dec_path = os.path.join(root, "decoder.npz")
        convert.save_npz(enc_path, enc)
        convert.save_npz(dec_path, dec)
        # WCT: VGG-19 on to conv5_1 and its five decoders
        wct_enc_path = os.path.join(root, "vgg_wct.npz")
        wct_dec_path = os.path.join(root, "decoders_wct.npz")
        convert.save_npz(wct_enc_path, vgg.init_params(vgg.WCT_ENCODER_ARCH,
                                                       torch.Generator().manual_seed(44)))
        wct.save_decoders(wct_dec_path, wct.init_decoders(torch.Generator().manual_seed(45)))
        wct_root = os.path.join(root, "wct")
        wct_args = ["--model", "wct", "--vgg-weights", wct_enc_path, "--decoder-weights",
                    wct_dec_path, "--style-stats-dir", os.path.join(wct_root, "style_stats")]
        stats_dir = os.path.join(root, "style_stats")
        int8_root = os.path.join(root, "int8")
        f32_root = os.path.join(root, "float32")  # the parity mode's banks and outputs
        f32_stats = os.path.join(f32_root, "style_stats")

        def common(out_root, dtype="bfloat16", stats=stats_dir):
            return [
                "--dataset", "pacs", "--list-root", root, "--data-root", root,
                "--output-root", out_root, "--style-stats-dir", stats,
                "--image-size", str(SIZE), "--batch-size", str(batch), "--dtype", dtype,
                "--vgg-weights", enc_path, "--decoder-weights", dec_path, "--device", "cuda",
            ]

        n_bank_batches = len(DOMAINS) * -(-images_per_domain // batch)
        n_styles = len(DOMAINS) - 1
        n_content_batches = -(-images_per_domain // batch)
        n_single = n_content_batches * n_styles  # one style image drawn a batch and style
        target = ["--target", "photo"]
        outs = {  # output root of each stylize run that is checked below: (root, mode)
            "ref": (root, "overall"), "int8-fused": (int8_root, "overall"),
            "ref float32": (f32_root, "overall"),
            "single ref": (os.path.join(root, "single"), "single"),
            "single int8-fused": (os.path.join(root, "single_int8"), "single"),
            "packed": (os.path.join(root, "packed"), "overall"),
            "packed float32": (os.path.join(f32_root, "packed"), "overall"),
            "int8": (os.path.join(root, "dynamic_int8"), "overall"),
            "output-size 96": (os.path.join(root, "resized"), "overall"),
        }
        per_overall = {"K3": (9 + 9 * n_styles) * n_content_batches, "K4": n_content_batches}
        steps = (
            ("style-bank", ["style-bank", *common(root)],
             {"K3": 9 * n_bank_batches, "K5": n_bank_batches}),
            ("stylize ref", ["stylize", *common(root), *target, "--mode", "overall"],
             {"K3": (9 + 9 * n_styles) * n_content_batches, "K4": n_content_batches}),
            ("calibrate", ["calibrate", *common(root), *target, "--engine", "int8-fused"], {}),
            ("stylize int8-fused", ["stylize", *common(int8_root), *target, "--mode", "overall",
                                    "--engine", "int8-fused"],
             {"K0": (7 + 7 * n_styles) * n_content_batches, "K1": n_content_batches,
              "K2": n_styles * n_content_batches, "K4": n_content_batches}),
            ("style-bank float32", ["style-bank", *common(f32_root, "float32", f32_stats)],
             {"K3": 9 * n_bank_batches, "K5": n_bank_batches}),
            ("stylize ref float32", ["stylize", *common(f32_root, "float32", f32_stats), *target,
                                     "--mode", "overall"], per_overall),
            # single mode: per batch and style, the style image's relu4_1
            # statistics (the ref encoder's 9 K3, one K5), then encode, AdaIN, decode
            ("stylize single ref", ["stylize", *common(outs["single ref"][0]), *target,
                                    "--mode", "single"],
             {"K3": 27 * n_single, "K5": n_single, "K4": n_single}),
            ("stylize single int8-fused", ["stylize", *common(outs["single int8-fused"][0]),
                                           *target, "--mode", "single", "--engine", "int8-fused"],
             {"K3": 9 * n_single, "K5": n_single, "K0": 14 * n_single, "K1": n_single,
              "K2": n_single, "K4": n_single}),
            # packed: 9 K3 a batch and 9 a style, four of them edge-padded on the packed plane
            ("stylize packed", ["stylize", *common(outs["packed"][0]), *target, "--mode", "overall",
                                "--engine", "packed"], per_overall),
            ("stylize packed float32", ["stylize", *common(outs["packed float32"][0], "float32",
                                                           f32_stats), *target, "--mode",
                                        "overall", "--engine", "packed"], per_overall),
            # dynamic int8: every conv is K0 with w_scale * a_scale formed on the device
            ("stylize int8", ["stylize", *common(outs["int8"][0]), *target, "--mode", "overall",
                              "--engine", "int8"],
             {"K0": (9 + 9 * n_styles) * n_content_batches, "K4": n_content_batches}),
            ("stylize output-size 96", ["stylize", *common(outs["output-size 96"][0]), *target,
                                        "--mode", "overall", "--output-size", "96"], per_overall),
            # the other content domains, which reorganize --target photo needs
            *((f"stylize ref --target {d}", ["stylize", *common(root), "--target", d, "--mode",
                                             "overall"], per_overall)
              for d in DOMAINS if d != "photo"),
            # WCT: the encoder on to relu5_1 (13 K3) a bank batch; a content
            # batch encoded to relu5_1 once, then a style decodes relu5_1 (13)
            # and encodes and decodes relu4_1 (9 + 9), relu3_1 (5 + 5), relu2_1
            # (3 + 3) and relu1_1 (1 + 1), one centring a level and style
            # besides relu5_1's one (the last flags win over common's)
            ("style-bank wct", ["style-bank", *common(wct_root), *wct_args],
             {"K3": 13 * n_bank_batches}),
            ("stylize wct", ["stylize", *common(wct_root), *wct_args, *target, "--mode",
                             "overall"],
             {"K3": (13 + 49 * n_styles) * n_content_batches,
              "W1": (1 + 4 * n_styles) * n_content_batches}),
        )

        def run_step(step, argv, expect):
            expect = {k: expect.get(k, 0) for k in counters}
            for fn in counters.values():
                fn.launches = 0
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rc = cli.main(argv)
            torch.cuda.synchronize()
            got = {k: fn.launches for k, fn in counters.items()}
            print(out.getvalue(), end="")
            if rc != 0:
                fail(f"{step} returned {rc}")
            if got != expect:
                fail(f"{step}: kernel launches {got}, expected {expect}")
            print(f"{step}: kernel launches {got} (as expected)")
            if "int8-fused" in step and "loading int8 calibration" not in out.getvalue():
                fail(f"{step} did not load the calibration that calibrate wrote")
            for k in counters:
                launches[k] += got[k]
            return out.getvalue()

        t_steps = {}
        for step, argv, expect in steps:
            t0 = time.perf_counter()
            run_step(step, argv, expect)
            t_steps[step] = time.perf_counter() - t0
        timings = {}  # read now: the --skip-existing reruns below rewrite ref's
        for name, (out_root, mode) in outs.items():
            with open(os.path.join(out_root, f"pacs_photo_{mode}_stylize_time.json")) as f:
                timings[name] = json.load(f)

        # --skip-existing: a rerun of ``stylize ref`` launches and writes
        # nothing; after one output a style is deleted, the rerun writes
        # exactly those, one batch a style, with the bytes they had
        def snapshot(out_root, mode="overall"):
            base = os.path.join(out_root, "PACS", f"all_style_transferred_{mode.capitalize()}",
                                "photo")
            return {os.path.join(dp, f): os.stat(os.path.join(dp, f)).st_mtime_ns
                    for dp, _, fs in os.walk(base) for f in fs}

        rerun = ["stylize", *common(root), *target, "--mode", "overall", "--skip-existing"]
        before = snapshot(root)
        run_step("stylize --skip-existing, nothing missing", rerun, {})
        if snapshot(root) != before:
            fail("stylize --skip-existing rewrote outputs that existed")
        gone = [p for p in sorted(before) if os.path.basename(p).startswith("img1_")]
        if len(gone) != n_styles:
            fail(f"expected one img1 output a style, found {gone}")
        kept_bytes = {p: open(p, "rb").read() for p in gone}
        for p in gone:
            os.remove(p)
        run_step("stylize --skip-existing, one output a style deleted", rerun,
                 {"K3": 18 * n_styles, "K4": n_styles})
        after = snapshot(root)
        rewritten = sorted(p for p in after if after[p] != before.get(p))
        if rewritten != sorted(gone) or set(after) != set(before):
            fail(f"stylize --skip-existing rewrote {rewritten}, expected {sorted(gone)}")
        for p in gone:
            if open(p, "rb").read() != kept_bytes[p]:
                fail(f"{p}: rewritten with other bytes than the first run's")
        print(f"stylize --skip-existing: nothing rewritten when nothing was missing; exactly the "
              f"{len(gone)} deleted outputs rewritten, byte for byte")

        for k in ("K0", "K1", "K2", "K3", "K4", "K5", "W1"):
            if launches[k] == 0:
                fail(f"{k} was never launched on the main paths")

        # the list subcommands on the same tree: no device, each exits 0 and
        # writes its lists
        split_root = os.path.join(root, "split")
        for step, argv, outputs in (
            ("reorganize", ["reorganize", "--dataset", "pacs", "--target", "photo", "--list-root",
                            root, "--data-root", root],
             [os.path.join(root, "PACS", "kfold_adain-overall-multi", "photo")]),
            ("gen-lists", ["gen-lists", "--dataset", "pacs", "--target", "photo", "--list-root",
                           root, "--k", "2"],
             [os.path.join(root, "txt_lists", "pacs_adain-overall-K2", "photo",
                           f"{d}_train.txt") for d in DOMAINS if d != "photo"]),
            ("filter-blank", ["filter-blank", "--dataset", "pacs", "--list-root", root,
                              "--data-root", root],
             [os.path.join(root, "txt_lists", "pacs_discardBlackWhite", f"{d}_train.txt")
              for d in DOMAINS]),
            ("split-data", ["split-data", "--dataset", "pacs", "--data-root", root, "--list-root",
                            split_root, "--tree-subdir", "PACS/kfold"],
             [os.path.join(split_root, "txt_lists", "pacs", f"{d}_{part}.txt")
              for d in DOMAINS for part in ("train", "test")]),
        ):
            printed = run_step(step, [*argv, "--device", "cuda"], {})
            missing = [o for o in outputs if not os.path.exists(o)]
            if missing:
                fail(f"{step} did not write {missing}")
            if step == "reorganize" and f"placed {3 * 3 * images_per_domain} files" not in printed:
                fail(f"reorganize placed another count: {printed.strip()}")

        # -- 7. the training stage on this tree: the K3 lists of the README's
        # quick start, then fed-train / fed-test through the CLI on the card
        run_step("gen-lists --k 3", ["gen-lists", "--dataset", "pacs", "--target", "photo",
                                     "--list-root", root, "--k", "3", "--device", "cuda"], {})
        fed = run_fed_phase(torch, dev, root, smi, images_per_domain)
        fed["step_bits"] = check_step_bits(torch, dev)

        # -- 8. decoder training and the privacy inversion on this tree
        privacy, privacy_refs = run_privacy_phase(torch, root, run_step, smi, images_per_domain,
                                                  enc_path, dec_path, stats_dir, enc, dec, dev)

        # -- 9. parallel clients and multi-process runs on this tree
        parallel = run_parallel_phase(torch, dev, root, smi, privacy_refs, enc_path, dec_path,
                                      images_per_domain)
        launches["K3"] += parallel["k3_launches"]

        for d in DOMAINS:
            mean, std = load_style_stats(os.path.join(stats_dir, "pacs", f"{d}_mean_std.npz"))
            mean32, std32 = load_style_stats(os.path.join(f32_stats, "pacs", f"{d}_mean_std.npz"))
            for m, sd in ((mean, std), (mean32, std32)):
                if m.shape != (512,) or not (np.isfinite(m).all() and np.isfinite(sd).all()):
                    fail(f"bank {d}: bad shape or non-finite values")
            # the bf16 bank against the float32 one: the same images, bf16 features
            if not np.allclose(mean, mean32, rtol=5e-2, atol=5e-3):
                fail(f"bank {d}: the bfloat16 bank is off the float32 bank by "
                     f"{np.abs(mean - mean32).max():.3e}")
            for tag, sdir in (("bfloat16", stats_dir), ("float32", f32_stats)):
                with open(os.path.join(sdir, "pacs", f"{d}_style_comp_time.json")) as f:
                    t = json.load(f)
                print(f"style-bank {d} {tag}: {t['images']} images in {t['seconds']:.3f} s = "
                      f"{t['images_per_sec']:.1f} img/s at {SIZE} px")
        scales_path = os.path.join(stats_dir, "pacs", "photo_q8_scales.json")
        scales = vgg_fast.load_scales(scales_path,
                                      expect_fingerprint=vgg_fast.weights_fingerprint(enc, dec))
        if len(scales) != 18 or not all(math.isfinite(v) and v > 0 for v in scales.values()):
            fail(f"calibrate wrote bad scales: {scales}")
        print(f"calibrate: {len(scales)} scales, {min(scales.values()):.4g}..{max(scales.values()):.4g}")
        for engine_name, (out_root, mode) in outs.items():
            outputs = sorted(snapshot(out_root, mode))
            if len(outputs) != images_per_domain * n_styles:
                fail(f"stylize {engine_name} wrote {len(outputs)} images, "
                     f"expected {images_per_domain * n_styles}")
            print(f"stylize {engine_name} timing: " + json.dumps(timings[engine_name]))
            sample = read_images(outputs[:batch])
            side = 96 if engine_name == "output-size 96" else SIZE
            if sample.shape[1:] != (side, side, 3):
                fail(f"stylize {engine_name} wrote {sample.shape[1:]} PNGs, expected {side} px")
            if int(sample.max()) - int(sample.min()) < 64:
                fail(f"stylize {engine_name}: near-constant PNGs ({sample.min()}..{sample.max()})")
            print(f"stylized PNGs ({engine_name}): {side} px, u8 range {sample.min()}.."
                  f"{sample.max()}, mean {sample.mean():.1f} over {len(sample)} images")
        # disk to disk through the CLI: each run's stylized images over its wall
        # time, the model and kernel setup included
        print("cli seconds: " + json.dumps({k: round(v, 3) for k, v in t_steps.items()}))

        # -- 5. whole paths vs plain paths ------------------------------------
        from ccst_tpu_torch.models.vgg import Conv, Pool, Upsample

        banks = [load_style_stats(os.path.join(stats_dir, "pacs", f"{d}_mean_std.npz"))
                 for d in DOMAINS if d != "photo"]
        s_means = torch.tensor(np.stack([m for m, _ in banks]), device=dev)
        s_stds = torch.tensor(np.stack([s for _, s in banks]), device=dev)
        photo = [os.path.join(root, f"PACS/kfold/photo/dog/img{i}.png") for i in range(batch)]
        images_u8 = torch.from_numpy(read_images(photo))
    images_u8 = images_u8.to(dev)

    engine = StylizeEngine(enc, dec, dtype=torch.bfloat16, device=dev)
    got = engine.stylize_multi(images_u8, s_means, s_stds, 1.0)

    with torch.no_grad():
        x = (images_u8.float() / 255.0).to(torch.bfloat16)
        feat = plain_apply(engine.enc, x, vgg.ENCODER_ARCH, stop_at="relu4_1")
        want = torch.stack([
            plain_apply(engine.dec, fused_adain_reference(feat, m, s, 1.0), vgg.DECODER_ARCH).float()
            for m, s in zip(s_means, s_stds)
        ])
    if got.shape != (n_styles, batch, SIZE, SIZE, 3) or not bool(got.isfinite().all()):
        fail(f"stylize_multi: shape {tuple(got.shape)} or non-finite values")
    err = (got - want).abs()
    mae = err.mean().item()
    spread = (want.max() - want.min()).item()
    print(f"ref: whole path vs plain path ({n_styles} styles x {batch} x {SIZE}px bf16): "
          f"MAE {mae:.3e} ({mae / spread:.3e} of the output range) max {err.max().item():.3e}; "
          f"output range {want.min().item():.3f}..{want.max().item():.3f}")
    if not spread >= MIN_SPREAD:
        fail(f"outputs span {spread:.3f} < {MIN_SPREAD}: the MAE bar would say little")
    if not mae <= MAE_BAR:
        fail(f"whole-path MAE {mae:.3e} > {MAE_BAR}")
    ref_out = got

    # the parity mode: the float32 ``ref`` engine (K3's exact float32 route, K4
    # in float32) against the same path composed from the plain versions
    engine32 = StylizeEngine(enc, dec, dtype=torch.float32, device=dev)
    for fn in counters.values():
        fn.launches = 0
    got32 = engine32.stylize_multi(images_u8, s_means, s_stds, 1.0)
    torch.cuda.synchronize()
    counts = {k: fn.launches for k, fn in counters.items() if fn.launches}
    if counts != {"K3": 9 + 9 * n_styles, "K4": 1}:
        fail(f"float32 ref stylize_multi: launches {counts}, expected K3 {9 + 9 * n_styles}, K4 1")
    with torch.no_grad():
        feat32 = plain_apply(engine32.enc, images_u8.float() / 255.0, vgg.ENCODER_ARCH,
                             stop_at="relu4_1")
        want32 = torch.stack([
            plain_apply(engine32.dec, fused_adain_reference(feat32, m, s, 1.0), vgg.DECODER_ARCH)
            for m, s in zip(s_means, s_stds)
        ])
    if got32.shape != want32.shape or not bool(got32.isfinite().all()):
        fail(f"float32 stylize_multi: shape {tuple(got32.shape)} or non-finite values")
    mae32 = (got32 - want32).abs().mean().item()
    print(f"ref float32: whole path vs plain path: MAE {mae32:.3e} max "
          f"{(got32 - want32).abs().max().item():.3e}; against the bf16 engine MAE "
          f"{(got32 - ref_out).abs().mean().item():.3e}; launches {counts} (as expected)")
    if not mae32 <= F32_MAE_BAR:
        fail(f"float32 whole-path MAE {mae32:.3e} > {F32_MAE_BAR}")
    del want32, feat32

    # packed: the level-1 stage as four edge-padded K3 convs on the packed
    # plane; against the same path composed from the plain versions, and in
    # float32 against the float32 ref engine (ccst_tpu's own bar, atol 5e-5)
    def plain_packed(ep, dp, images, dtype):
        def conv(x, cw, relu, pad):
            return reflect_conv3x3_reference(x, cw.w, cw.b, relu, pad)

        x = vgg.conv1x1((images.float() / 255.0).to(dtype), ep["conv0"])
        xp = vgg_fast.pack_s2d(x)
        xp = torch.nn.functional.pad(xp, (0, ep["conv1_1"].w.shape[2] - xp.shape[3]))
        xp = conv(conv(xp, ep["conv1_1"], True, "edge"), ep["conv1_2"], True, "edge")
        feat = plain_apply(ep, phase_max(xp, 64), vgg_fast._ENC_TAIL)
        outs = []
        for m, sd in zip(s_means, s_stds):
            y = plain_apply(dp, fused_adain_reference(feat, m, sd, 1.0), vgg_fast._DEC_MID)
            y = conv(conv(y, dp["dconv1_2"], True, "edge"), dp["dconv1_1"], False, "edge")
            outs.append(vgg_fast.unpack_d2s(y, 3).float())
        return torch.stack(outs)

    fast = {}
    for name, dtype in (("packed", torch.bfloat16), ("packed-float32", torch.float32)):
        eng = StylizeEngine(enc, dec, dtype=dtype, device=dev, engine="packed")
        for fn in counters.values():
            fn.launches = 0
        got_p = eng.stylize_multi(images_u8, s_means, s_stds, 1.0)
        torch.cuda.synchronize()
        counts = {k: fn.launches for k, fn in counters.items() if fn.launches}
        if counts != {"K3": 9 + 9 * n_styles, "K4": 1}:
            fail(f"{name} stylize_multi: launches {counts}, expected K3 {9 + 9 * n_styles}, K4 1")
        ep = vgg_fast.prepare_encoder(eng._enc_w, dtype, dev)
        dp = vgg_fast.prepare_decoder(eng._dec_w, dtype, dev)
        with torch.no_grad():
            want_p = plain_packed(ep, dp, images_u8, dtype)
        if got_p.shape != want_p.shape or not bool(got_p.isfinite().all()):
            fail(f"{name}: shape {tuple(got_p.shape)} or non-finite values")
        mae_p = (got_p - want_p).abs().mean().item()
        bar = MAE_BAR if dtype == torch.bfloat16 else F32_MAE_BAR
        print(f"{name}: whole path vs plain path: MAE {mae_p:.3e} max "
              f"{(got_p - want_p).abs().max().item():.3e}; launches {counts} (as expected)")
        if not mae_p <= bar:
            fail(f"{name} whole-path MAE {mae_p:.3e} > {bar}")
        if dtype == torch.float32:
            err = (got_p - got32).abs()
            print(f"packed float32 vs ref float32: max abs {err.max().item():.3e}, MAE "
                  f"{err.mean().item():.3e} (bar: max {PACKED_F32_ATOL})")
            if not err.max().item() <= PACKED_F32_ATOL:
                fail(f"packed float32 is {err.max().item():.3e} off ref float32 > {PACKED_F32_ATOL}")
        else:
            print(f"packed vs ref (bf16): MAE {(got_p - ref_out).abs().mean().item():.3e}")
        fast[name] = eng
        del got_p, want_p
    del got32

    # the dynamic int8 engine: every conv quantizes its input on the device
    # and K0 dequantizes with w_scale * a_scale formed there; against its plain
    # composition (the same quantization glue, K0's and K4's plain versions)
    # and against ref
    def plain_q8(ep, dp, images):
        def qref(x, q, relu, pad):
            xq, a_scale = vgg_fast._quantize_act(x)
            return qconv3x3_s8_reference(xq, q.wq, q.k * a_scale, q.kb, relu, False,
                                         torch.bfloat16, pad)

        x = vgg.conv1x1((images.float() / 255.0).to(torch.bfloat16), ep["conv0"])
        xp = qref(qref(vgg_fast.pack_s2d(x), ep["conv1_1"], True, "edge"), ep["conv1_2"], True,
                  "edge")
        feat = vgg_fast._walk(vgg_fast._ENC_TAIL, phase_max(xp, 64),
                              lambda t, layer: qref(t, ep[layer.name], layer.relu, "reflect"))
        outs = []
        for m, sd in zip(s_means, s_stds):
            y = vgg_fast._walk(vgg_fast._DEC_MID, fused_adain_reference(feat, m, sd, 1.0),
                               lambda t, layer: qref(t, dp[layer.name], layer.relu, "reflect"))
            y = qref(qref(y, dp["dconv1_2"], True, "edge"), dp["dconv1_1"], False, "edge")
            outs.append(vgg_fast.unpack_d2s(y, 3).float())
        return torch.stack(outs)

    eng = StylizeEngine(enc, dec, dtype=torch.bfloat16, device=dev, engine="int8")
    for fn in counters.values():
        fn.launches = 0
    got_d = eng.stylize_multi(images_u8, s_means, s_stds, 1.0)
    torch.cuda.synchronize()
    counts = {k: fn.launches for k, fn in counters.items() if fn.launches}
    if counts != {"K0": 9 + 9 * n_styles, "K4": 1}:
        fail(f"int8 stylize_multi: launches {counts}, expected K0 {9 + 9 * n_styles}, K4 1")
    with torch.no_grad():
        want_d = plain_q8(vgg_fast.prepare_encoder_q8(eng._enc_w, torch.bfloat16, dev),
                          vgg_fast.prepare_decoder_q8(eng._dec_w, torch.bfloat16, dev), images_u8)
    if got_d.shape != ref_out.shape or not bool(got_d.isfinite().all()):
        fail(f"int8: shape {tuple(got_d.shape)} or non-finite values")
    mae_d = (got_d - want_d).abs().mean().item()
    psnr_d = 10 * math.log10(spread ** 2 / ((got_d - ref_out) ** 2).mean().item())
    print(f"int8 (dynamic): whole path vs plain path: MAE {mae_d:.3e} max "
          f"{(got_d - want_d).abs().max().item():.3e}; vs bf16 ref: PSNR {psnr_d:.2f} dB; "
          f"launches {counts} (as expected)")
    if not mae_d <= MAE_BAR:
        fail(f"int8 whole-path MAE {mae_d:.3e} > {MAE_BAR}")
    if not psnr_d > PSNR_BAR:
        fail(f"int8 vs ref PSNR {psnr_d:.2f} dB <= {PSNR_BAR}")
    fast["int8"] = eng
    del got_d, want_d

    # int8-fused, from the scales calibrate wrote, against its plain composition
    def plain_q8s(ep, dp, images):
        def qref(x, q, relu, pad):
            return qconv3x3_s8_reference(x, q.wq, q.k, q.kb, relu, q.requant, torch.bfloat16, pad)

        x = vgg.conv1x1((images.float() / 255.0).to(torch.bfloat16), ep["conv0"])
        xq = vgg_fast.pack_s2d(vgg_fast.quantize_static(x, ep["__scales__"]["conv1_1"] / 127.0))
        xq = encoder_level1_reference(xq, ep["conv1_1"], ep["conv1_2"])
        pools = 0
        for layer in vgg.ENCODER_ARCH:
            if isinstance(layer, Conv) and layer.name not in ("conv0", "conv1_1", "conv1_2"):
                xq = qref(xq, ep[layer.name], layer.relu, "reflect")
                if layer.name == "conv4_1":
                    break
            elif isinstance(layer, Pool):
                pools += 1
                if pools > 1:
                    xq = vgg.maxpool_ceil(xq)
        outs = []
        for m, s in zip(s_means, s_stds):
            yq = vgg_fast.quantize_static(fused_adain_reference(xq, m, s, 1.0),
                                          dp["__scales__"]["dconv4_1"] / 127.0)
            for layer in vgg_fast._DEC_MID:
                if isinstance(layer, Conv):
                    yq = qref(yq, dp[layer.name], layer.relu, "reflect")
                elif isinstance(layer, Upsample):
                    yq = vgg.upsample_nearest2x(yq)
            yq = qref(yq, dp["dconv1_2"], True, "edge")
            outs.append(vgg_fast.unpack_d2s(qref(yq, dp["dconv1_1"], False, "edge"), 3).float())
        return torch.stack(outs)

    engines = {name: StylizeEngine(enc, dec, dtype=torch.bfloat16, device=dev, engine=name,
                                   scales=scales)
               for name in ("int8-fused", "int8-static")}
    q8 = {}
    for name, per_batch in (("int8-fused", {"K0": 7 + 7 * n_styles, "K1": 1, "K2": n_styles}),
                            ("int8-static", {"K0": 9 + 9 * n_styles, "K1": 0, "K2": 0})):
        for fn in counters.values():
            fn.launches = 0
        q8[name] = engines[name].stylize_multi(images_u8, s_means, s_stds, 1.0)
        torch.cuda.synchronize()
        counts = {k: counters[k].launches for k in ("K0", "K1", "K2", "K3", "K4")}
        expect = {"K3": 0, "K4": 1, **per_batch}
        if counts != expect:
            fail(f"{name} stylize_multi: launches {counts}, expected {expect}")
        print(f"{name} stylize_multi: launches {counts} per content batch (as expected)")
    fused_out = q8["int8-fused"]
    if fused_out.shape != ref_out.shape or not bool(fused_out.isfinite().all()):
        fail(f"int8-fused: shape {tuple(fused_out.shape)} or non-finite values")
    check_equal(torch, "int8-fused vs int8-static", fused_out, q8["int8-static"])
    print("int8-fused equals int8-static bit for bit")
    ep = vgg_fast.prepare_encoder_q8s(engines["int8-fused"]._enc_w, scales, torch.bfloat16, dev)
    dp = vgg_fast.prepare_decoder_q8s(engines["int8-fused"]._dec_w, scales, torch.bfloat16, dev)
    with torch.no_grad():
        want_q8 = plain_q8s(ep, dp, images_u8)
    err = (fused_out - want_q8).abs()
    mae_q8 = err.mean().item()
    print(f"int8-fused: whole path vs plain path: MAE {mae_q8:.3e} max {err.max().item():.3e}; "
          f"output range {want_q8.min().item():.3f}..{want_q8.max().item():.3f}")
    if not mae_q8 <= MAE_BAR:
        fail(f"int8-fused whole-path MAE {mae_q8:.3e} > {MAE_BAR}")
    mse = ((fused_out - ref_out) ** 2).mean().item()
    psnr = 10 * math.log10(spread ** 2 / mse)
    print(f"int8-fused vs bf16 ref: PSNR {psnr:.2f} dB over the ref's range {spread:.3f} "
          f"(MAE {(fused_out - ref_out).abs().mean().item():.3e})")
    if not psnr > PSNR_BAR:
        fail(f"int8-fused vs ref PSNR {psnr:.2f} dB <= {PSNR_BAR}")

    # K2: the fused decoder path against the unfused one, on one AdaIN output
    with torch.no_grad():
        featq = vgg_fast.apply_encoder_q8s_fused(ep, (images_u8.float() / 255.0).to(torch.bfloat16))
        t = fused_adain(featq, s_means[0], s_stds[0], 1.0)
        for fn in counters.values():
            fn.launches = 0
        dec_fused = vgg_fast.apply_decoder_q8s_fused(dp, t)
        torch.cuda.synchronize()
        if decoder_level1.launches != 1 or qconv3x3_s8.launches != 7:
            fail(f"apply_decoder_q8s_fused: K2 {decoder_level1.launches}, K0 "
                 f"{qconv3x3_s8.launches} launches, expected 1 and 7")
        check_equal(torch, "apply_decoder_q8s_fused vs apply_decoder_q8s", dec_fused,
                    vgg_fast.apply_decoder_q8s(dp, t))
        # one style's whole int8 decode either way, on the device from a replayed graph
        decode_ms = {name: graph_ms(torch, lambda f=fn: f(dp, t), 10, 5)["median"]
                     for name, fn in (("int8-decode-fused", vgg_fast.apply_decoder_q8s_fused),
                                      ("int8-decode-unfused", vgg_fast.apply_decoder_q8s))}
    print("apply_decoder_q8s_fused (K2) equals apply_decoder_q8s bit for bit; one style's decode "
          f"of {batch} x {SIZE}px on the device: fused {decode_ms['int8-decode-fused']:.4f} ms, "
          f"unfused {decode_ms['int8-decode-unfused']:.4f} ms")

    # the bank step on the device: one encode of a batch and its moments (K5)
    from ccst_tpu_torch.ops.welford import welford_init
    from ccst_tpu_torch.pipeline.style_bank import make_bank_step

    bank_step = make_bank_step(enc, torch.bfloat16, dev)
    bank_images = images_u8.float() / 255.0
    bank_state = welford_init(512, dev)
    bank_ms = time_ms(torch, lambda: bank_step(bank_state, bank_images, batch), reps=3, runs=5)
    print(f"bank step on the device ({batch} x {SIZE}px, bf16): {bank_ms:.3f} ms/batch = "
          f"{batch / (bank_ms * 1e-3):.1f} img/s")

    rates = {"bank-step": dict(ms=bank_ms, img_s=batch / (bank_ms * 1e-3)),
             **{name: dict(ms=ms) for name, ms in decode_ms.items()}}
    for name, eng in (("ref", engine), *engines.items(), ("ref-float32", engine32),
                      *fast.items()):
        ms = time_ms(torch, lambda: eng.stylize_multi(images_u8, s_means, s_stds, 1.0),
                     reps=3, runs=5)
        # the same batch captured into one CUDA graph and replayed: the card's own
        # time, with no host between the launches
        dev_ms = graph_ms(torch, lambda: eng.stylize_multi(images_u8, s_means, s_stds, 1.0), 1, 5)
        rates[name] = dict(ms=ms, img_s=batch * n_styles / (ms * 1e-3), graph_ms=dev_ms["median"])
        print(f"stylize_multi {name} on the device ({batch} x {SIZE}px, {n_styles} styles): "
              f"{ms:.2f} ms/batch = {rates[name]['img_s']:.1f} stylized img/s; as one replayed "
              f"CUDA graph {dev_ms['median']:.2f} ms ({100 * (1 - dev_ms['median'] / ms):.1f}% of "
              "the eager time is the host's)")
    print("device rates: " + json.dumps({"batch": batch, **rates}))

    # -- 6. the int8 A/B harnesses -----------------------------------------
    for k, v in run_harnesses(torch, counters).items():
        launches[k] = v

    # -- 10. the row-sharded stylize and the channel-split ResNet-50 --------
    sharding = run_sharding_phase(
        torch, dev, smi, enc, dec, scales, images_u8, s_means, s_stds,
        {"ref bf16": engine, "ref float32": engine32, "int8-static": engines["int8-static"]},
        results)
    for k, v in sharding["launches"].items():
        launches[k] = launches.get(k, 0) + v

    # -- 11. the end-to-end validation experiments -------------------------
    experiments = run_experiments_phase(torch, dev, smi, counters)
    for k, v in experiments["launches"].items():
        launches[k] += v

    sources = {
        "K3": ("reflect_conv3x3", "cuda", "ccst_tpu_torch/csrc/reflect_conv3x3.cu",
               "ccst_tpu/kernels/conv_pallas.py:102", list(K3_MAIN),
               "stylize ref, packed; train-decoder, invert-train, invert-eval, gan-train "
               "--fid-samples (grad-free passes); invert-train on 2 ranks, train-decoder on "
               "a 2-rank mesh (each rank); the row-sharded stylize ref (each rank); the "
               "experiments (LSUV, banks, ref and Single stylize, the trainers' passes)"),
        "K4": ("fused_adain_multi", "cuda", "ccst_tpu_torch/csrc/adain.cu",
               "ccst_tpu/kernels/adain_pallas.py:56", list(relu4_1_shape(batch)),
               "stylize (every engine, both modes); the batch-sharded int8-static stylize "
               "(each rank); the experiments' stylize arms"),
        "K4-given": ("fused_adain_given", "cuda", "ccst_tpu_torch/csrc/adain.cu",
                     "ccst_tpu/kernels/adain_pallas.py:56", list(relu4_1_shape(batch)),
                     "the row-sharded stylize, ref and int8-static (each rank)"),
        "K5": ("channel_moments", "cuda", "ccst_tpu_torch/csrc/moments.cu",
               "ccst_tpu/kernels/welford_pallas.py:52", list(relu4_1_shape(batch)),
               "style-bank, stylize --mode single; the row-sharded stylize (each rank); the "
               "experiments' banks and Single arm"),
        "K0": ("qconv3x3_s8", "cuda", "ccst_tpu_torch/csrc/qconv3x3_s8.cu",
               "ccst_tpu/models/vgg_fast.py:381", list(K0_MAIN),
               "stylize int8-fused, int8; the row- and batch-sharded int8-static stylize "
               "(each rank); the experiments' int8-static arm"),
        "K1": ("encoder_level1", "cuda", "ccst_tpu_torch/csrc/level1_s8.cu",
               "ccst_tpu/kernels/level1_pallas.py:367", [4, 256, 256, 12], "stylize int8-fused"),
        "K2": ("decoder_level1", "cuda", "ccst_tpu_torch/csrc/level1_s8.cu",
               "ccst_tpu/kernels/level1_pallas.py:380", [4, 256, 256, 64],
               "stylize int8-fused"),
        "B1": ("tiled_mm", "cuda", "ccst_tpu_torch/csrc/int8_mm.cu",
               "benchmarks/pallas_int8_mxu.py:22", B1_MAIN,
               "python -m ccst_tpu_torch.benchmarks.int8_mm"),
        "B2-direct": ("conv_direct", "cuda", "ccst_tpu_torch/csrc/qconv3x3_s8.cu",
                      "benchmarks/winograd_ab.py:73", list(B2_MAIN),
                      "python -m ccst_tpu_torch.benchmarks.winograd_ab"),
        "B2-wino": ("conv_wino", "cuda", "ccst_tpu_torch/csrc/winograd_s8.cu",
                    "benchmarks/winograd_ab.py:90", list(B2_MAIN),
                    "python -m ccst_tpu_torch.benchmarks.winograd_ab"),
        "W1": ("centre_split", "cuda", "ccst_tpu_torch/csrc/wct/wct_centre.cu",
               "none (WCT has no JAX counterpart)", list(W1_MAIN),
               "stylize --model wct (one launch a level and style, relu5_1's once a batch)"),
        "B3": ("pool_conv_fused", "cuda", "ccst_tpu_torch/csrc/pool_conv_s8.cu",
               "benchmarks/fused_pool_conv_ab.py:123", [*B3_MAIN, 256],
               f"python -m ccst_tpu_torch.benchmarks.fused_pool_conv_ab --batch {B3_HARNESS_BATCH}"),
    }
    kernels = []
    for k, (name, route, source, replaces, shape, path) in sources.items():
        rows = results[k]
        # the row of the case the main paths launch: K4 restyles all the banks at once
        main_row = next(r for r in rows if r["shape"] == shape and "ms" in r
                        and r.get("styles", n_styles) == n_styles
                        and r.get("relu", True) and r.get("dtype", "torch.bfloat16") == "torch.bfloat16"
                        and r.get("variant", "i8i32") in ("i8i32", "F9")
                        and r.get("mode", "full") in ("direct", "full") and not r.get("cat", False)
                        and r.get("pad", "reflect") == "reflect" and "scale" not in r)
        library_ms = main_row.get("cudnn_bf16_ms", main_row.get("library_ms"))
        per_shape = [
            {key: r.get(key) for key in ("layer", "variant", "mode", "pad", "scale", "dtype",
                                         "alpha", "styles", "kernel_variant", "shape", "ms",
                                         "graph_ms", "plain_ms",
                                         "bound_ms", "bound_by", "cudnn_bf16_ms", "cudnn_f32_ms",
                                         "library_ms", "cublas_bf16_out_ms", "single_launches_ms",
                                         "call_ms", "empty_launch_ms", "replaces_chain_ms", "k0_ms")
             if key in r}
            for r in rows if "ms" in r
        ]
        kernels.append({
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": launches[k], "path": path,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
            "library_ms": library_ms, "timed_shape": shape,
            **({"call_ms": main_row["call_ms"]} if k == "K2" else {}),
            **({"replaces_chain_ms": main_row["replaces_chain_ms"]} if k in ("K2", "B3") else {}),
            **({"k0_ms": main_row["k0_ms"]} if k.startswith("B2") else {}),
            **({"timed_styles": main_row["styles"]} if "styles" in main_row else {}),
            **({"tops": main_row["tops"]} if "tops" in main_row else {}),
            **({"shapes": per_shape} if per_shape else {}),
        })
    print(f"wall: {time.perf_counter() - t_start:.1f} s, the kernels' build included")
    print(json.dumps({"fed": fed}))
    print(json.dumps({"privacy": privacy}))
    print(json.dumps({"parallel": parallel}))
    print(json.dumps({"sharding": sharding}))
    print(json.dumps({"experiments": experiments}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
