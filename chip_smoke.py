#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (deepreduce_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--steps 5]
    python3 chip_smoke.py --compare-encode OLD/qsgd_encode.cu

With --compare-encode only phases 1-2, phase 3's qsgd_encode_rows checks
and phase 6's sweep run, the sweep in turns earlier, this, this, earlier
for an earlier source of csrc/qsgd_encode.cu and this checkout's (which is
also held bitwise to its plain version on every sweep table).

Phases, one line each; any failure raises and exits non-zero:
  1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
  2. build every kernel from the sources in the checkout (nvcc, sm_90a);
  3. each kernel against its plain PyTorch version on the card's inputs:
     qsgd_quantize at every size the per-leaf encode launched it with and at
     an odd size; qsgd_encode_rows on the main path's own 12-segment table and
     on single segments at odd sizes, bucket sizes and alignments. Levels
     and norm bytes bitwise equal, |level| <= q, unbiased over many
     offsets, repeatable for a fixed (seed, offset);
  4. one Embed_0-sized gradient through TensorCodec on the card and on the
     CPU with the same seed: filter words, nsel, every bucket norm, every
     level and the decoded tensor bitwise equal;
  5. the main path: `Trainer.step` of DRQSGD-BF-P0 (top-k 0.1, mod-blocked
     bloom p0 at fpr 0.02, QSGD q=127 / 512, residual memory, SGD lr 0.1
     momentum 0.9) on the full-width WordLSTM (4,050,748 parameters), batch
     64 x 20 synthetic tokens, through a one-rank NCCL group so the real
     all_gather_into_tensor runs. Kernel launch counts are zeroed just
     before and read just after: qsgd_encode_rows once per worker-step,
     qsgd_quantize never (it is no longer on the main path); then the
     flagship's codec-table times (as in phase 7);
  6. device times (torch.profiler) and host times of each kernel and its
     plain version at its path's shapes (qsgd_encode_rows on phase 5's table,
     beside the per-leaf QSGD composition it replaced; qsgd_quantize at the
     qar path's 4,050,944 elements from phase 9), and qsgd_encode_rows's
     sweep: its launch floor (an empty kernel with its parameter block and
     grid), one bucket, the flagship's 12 segments, resnet20_drqsgd's 19,
     the fedavg_mobilenet_drqsgd S2C tree's 57 and one 4,050,944-element
     segment warm and with the L2 flushed, each bitwise its plain version,
     with device us, bytes, bound and share; then the `kernels` JSON line,
     whose launches sum every path's counted run;
  7. the other Table-4 arms of `bench.py` (dense allreduce, Top-r,
     DRQSGD with the delta-bitpacked integer index, with sampled top-k,
     with the sparsifier-free direct bloom encode, and bloom index-only),
     each driven like phase 5 for 3 steps on the same weights and batches
     with its launch and host-sync counts zeroed just before and read just
     after: finite losses, the first within 1e-4 of phase 5's CPU forward,
     the arm's payload bytes, rel_volume, one qsgd_encode_rows launch per
     step exactly in the DRQSGD arms; the arm's own QSGD segment table held
     against the plain version; the Embed_0-sized gradient through the
     arm's TensorCodec on the card and on the CPU with every payload leaf
     bitwise equal; and encode/decode times of one flat d = 4,053,428
     gradient at ratio 0.1 (bench.py's codec table, CUDA events);
  8. the README quick start: `Trainer.step` on the full-width ResNet-20
     (272,282 parameters, BatchNorm, batch 64 x 32x32x3 synthetic images)
     through the same NCCL group, in two arms each with its counts zeroed
     just before and read just after: `resnet20_quickstart` (top-k 0.01,
     classic bloom fpr 0.001 leftmost, PolyFit, residual memory; 5 steps)
     with no qsgd_encode_rows launch and no host sync (torch's sync debug
     mode counts them), and `resnet20_drqsgd` (the same with QSGD; 3 steps)
     with one launch per step and its own 19-segment table held bitwise
     against the plain version; finite losses, the first within 1e-4 of the
     CPU forward, the payload bytes, running statistics finite and moved;
     the largest conv gradient through the quick-start TensorCodec on the
     card and on the CPU (filter, nsel, num_pos and mapping bitwise,
     coefficients and decode within tolerance); encode/decode times of that
     leaf and of a whole ResNet-20 gradient (CUDA events);
  9. the in-collective communicators on the full-width WordLSTM through the
     same NCCL group, 3 steps each on phase 7's weights and batches with the
     counts zeroed just before and read just after: `qar` (the int8 quantized
     allreduce, two qsgd_quantize launches per step) and the sparse_rs
     routes sparse, adaptive (rs_density_threshold 0.05, so the dense int8
     phase-2 row carries the wire; one launch), quantized (one launch against
     the shared norms) and oktopk; no qsgd_encode_rows launch and no host
     sync in any step; finite losses, the first within 1e-4 of phase 5's CPU
     forward; payload bytes, rel_volume and the adaptive and oktopk
     observables; one step's compensated gradient through the route on the
     card and on the CPU under the same stream, the mean, the own-transmitted
     tensor and the quantized levels bitwise equal; and qsgd_quantize on the
     qar path's own 4,050,944-element input bitwise equal to its plain
     version on the card;
 10. the bucketed exchange at bench.py's 4 MiB buckets through the same NCCL
     group, 3 steps each with the counts zeroed just before and read just
     after: `drqsgd_bloom_bucketed` (the flagship in 4 buckets, pipelined:
     one qsgd_encode_rows launch per step for every bucket),
     `drqsgd_bloom_stream` (5 buckets in backward-completion order, streamed
     from the backward pass on a side stream: one launch per bucket) and
     `resnet20_quickstart_bucketed` (the quick start's 61 leaves in one
     bucket: no launch); no host sync; finite losses, the first within 1e-4
     of the CPU forward; payload bytes and rel_volume; one step's exchange
     card = CPU (bitwise with QSGD); the arm's own QSGD segment table held
     against the plain version; and one step from the same weights under
     the barrier schedule bitwise equal to the pipelined and the streamed one.
 11. the codec zoo through the same NCCL group, 3 steps each with the counts
     zeroed just before and read just after, on the full-width WordLSTM
     (the flagship's knobs unless the arm says otherwise): the bloom random
     policy P1 (`drqsgd_bloom_p1`), the approximate P2 (`_p2a`), the
     hash-blocked layout (`_hash`), the run-length index (`drqsgd_rle`),
     value-only PolyFit, Fit-DExp and count sketch on Top-r (`topr_*`),
     random-k with value-only QSGD (`randomk_qsgd`) and the Table-6
     natural-sparsity arm (`threshold_bloom_qsgd`: threshold 0.0 at budget
     0.2, no memory, bloom fpr 0.6 p0, QSGD q = 63); and PolySeg on
     ResNet-20's conv kernels (`resnet20_polyseg`). One qsgd_encode_rows
     launch per step in the QSGD arms, none elsewhere; no host sync;
     finite losses, the first within 1e-4 of the CPU forward; payload
     bytes; one step's exchange card = CPU (bitwise for the integer and
     QSGD arms, within a stated atol for the fits and the sketch); the
     arm's QSGD table against the plain version; Embed_0's natural
     sparsity and threshold overflow (0) in the threshold arm; then the
     encode and decode times of each new codec at d = 4,053,428 and the
     Embed_0 filter's measured false-positive rate under the mod, hash and
     classic layouts (card = CPU).
 12. compressed FedAvg (`FedAvg.run_round`, one process, no group) at full
     width, each arm with the counts zeroed just before its rounds and read
     just after, every round under the sync debug mode: MobileNetV1 (width
     1.0, 32x32x3, 10 of 10 clients, 4 local steps of SGD 0.2 momentum 0.9
     on 24 images) dense for 3 rounds and DRQSGD-BF-P0 both ways for 3
     rounds, and the WordLSTM (56 of 57 clients, 4 local steps of SGD 2.0
     momentum 0.9 on 16 x 20 tokens) DRQSGD-BF-P0 for 2 rounds: finite
     parameters and held-out loss, each round's per-direction index and
     dense bits equal to FEDAVG_WIRE (the JAX package's codec geometry) and
     its value bits within their bounds, qsgd_encode_rows exactly
     rounds x (1 + C) times in the DRQSGD arms and never in the dense one,
     host syncs per round, round times (CUDA events); and for one round of
     each DRQSGD arm the S2C and one client's C2S `compress_tree` on the
     card and on the CPU bitwise, with each tree's grouped QSGD rows
     (`wrappers.encode_group`, the main path's encode) bitwise the plain
     version's on the same segment table;
 13. Table 6 on NeuMF at the ML-20m widths (31,832,577 parameters): budgets
     from the gradient of one batch of 10^6 interactions
     (benchmarks/ncf_table6.py's `batch_at(0)`), each leaf routed and
     encoded on the gradient of `batch_at(1)`: routes equal to
     NCF_TABLE6.json's, the total rel_volume within 1e-3 of its 0.1906,
     overflow 0, one qsgd_encode_rows launch per QSGD leaf, every QSGD
     leaf's rows from the main path's encode bitwise the plain version's,
     every leaf's decode on the card bitwise the CPU's encode and decode of
     the same gradient, encode and decode times of the two user tables.
 14. the paper's remaining models at full width through the same NCCL
     group, 3 steps an arm (SGD lr 0.1 momentum 0.9, batches drawn from
     --seed as benchmarks/train.py's make_batch draws them) with the counts
     zeroed just before and read just after: ResNet-50 in bfloat16 (batch
     128 x 224x224x3, 1000 classes; bench.py's dense allreduce and top-k 1%
     bloom-index arms, its DRQSGD-BF-P0 codec arm at ratio 0.01, and the
     quick start's knobs), DenseNet-40 (64 x 32x32x3) with the quick start's
     knobs and QSGD, VGG16 (64 x 32x32x3) with PolySeg on its 13 convs, and
     BERT-base (64 x 128 tokens, the next-token loss) with top-k 0.001 and
     DRQSGD-BF-P0. Before the first step the card's forward on 8 examples
     (a copy of the model) against the CPU's (1e-4 of the largest logit in
     float32, 1e-2 in bfloat16); finite losses and parameters, the payload
     bytes, no host sync, one qsgd_encode_rows launch per step in the three
     QSGD arms (76, 39 and 88 segments, each table bitwise the plain
     version's, its device time beside its bytes bound) and none elsewhere,
     running statistics finite and moved, step median, images or tokens per
     second and peak memory; and resnet50_topk1_bloom checkpointed after its
     second step, restored into a fresh Trainer (every parameter,
     statistic, momentum buffer and residual and the step bitwise the saved
     ones), and stepped once more.
`--profile` adds one profiled training step after phase 5, after each arm
of phases 7, 8, 9, 10, 11 and 14, and one profiled round after each arm of
phase 12: the device's busy and idle share over the step or round, its
device launches and its largest kernels.
The last line is {"ok": true, "device": {...}}. Without CUDA, or without
the package beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
F64_OPS_PER_S = 34e12  # H100 SXM float64 outside the tensor cores, NVIDIA data sheet
QSGD_BYTES_PER_ELEM = 9  # read value f32 + scale f32, write level int8
QSGD_F32_OPS_PER_ELEM = 8  # abs, mul, floor, sub, cvt+mul (uniform), cmp, add, sign-mul
ENCODE_F64_OPS_PER_ELEM = 2  # the norm: square, add
# the main path's stream coordinates in the tables phase 3 and 6 build
TABLE_STEP, TABLE_WORKER = 3, 0


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


# phase 7: bench.py's Table-4 arms beyond the flagship (bench.py:2505-2543,
# :284-290), as knobs over the flagship's, with their wire bytes on the
# full-width WordLSTM (GradientExchanger.payload_bytes of the JAX package)
ARMS = {
    "dense": dict(compressor="none", deepreduce=None, communicator="allreduce", memory="none"),
    "topr": dict(deepreduce=None),
    "drqsgd_delta": dict(index="integer"),
    "drqsgd_bloom_sampled": dict(compressor="topk_sampled"),
    "drqsgd_bloom_direct": dict(compressor="topk_sampled", bloom_threshold_insert=True),
    "bloom_index": dict(deepreduce="index", fpr=0.001),
}
PAYLOAD_BYTES = {
    "drqsgd_bloom": 1_189_616, "dense": 16_202_992, "topr": 3_240_652, "drqsgd_delta": 1_385_424,
    "drqsgd_bloom_sampled": 1_189_616, "drqsgd_bloom_direct": 1_211_288, "bloom_index": 3_717_936,
}
ARM_STEPS = 3
CODEC_TABLE_D = 4_053_428  # bench.py's LSTM d for the codec table

# phase 8: the README quick start (README.md, benchmarks/train.py's default
# config) on ResNet-20, and the same with QSGD values, with their wire bytes
# (GradientExchanger.payload_bytes of the JAX package)
QUICKSTART = dict(
    compressor="topk", compress_ratio=0.01, memory="residual", communicator="allgather",
    deepreduce="both", index="bloom", value="polyfit", fpr=0.001, policy="leftmost",
)
RESNET_ARMS = {"resnet20_quickstart": ({}, 5), "resnet20_drqsgd": (dict(value="qsgd"), 3)}
RESNET_PAYLOAD_BYTES = {"resnet20_quickstart": 18_756, "resnet20_drqsgd": 15_544}
RESNET_BATCH = 64

# phase 9: the in-collective communicators with the JAX package's defaults
# (ratio 0.1 as in bench.py's rs-sweep): knobs, wire bytes on the full-width
# WordLSTM at W = 1 (the JAX package's qar.wire_bits_per_worker and
# costmodel.rs_payload_bytes) and qsgd_quantize launches per step
RS = dict(communicator="sparse_rs", compressor="topk", memory="residual", deepreduce=None)
IN_COLLECTIVE = {
    "qar": (dict(communicator="qar", compressor="none", memory="none", deepreduce=None), 0, 2),
    "rs_sparse": (dict(RS, rs_mode="sparse"), 9_721_776, 0),
    # below the W = 1 density of 0.1, so the dense int8 row is the one sent
    "rs_adaptive": (dict(RS, rs_mode="adaptive", rs_density_threshold=0.05), 10_595_428, 1),
    "rs_quantized": (dict(RS, rs_mode="quantized"), 7_354_832, 1),
    "rs_oktopk": (dict(RS, rs_mode="oktopk"), 9_738_160, 0),
}
QAR_N = 4_050_944  # qar.pad_len(4,050,748, 1, 512): qsgd_quantize's size on the qar path

# phase 10: the bucketed exchange at bench.py's DEFAULT_BUCKET_BYTES
# (bench.py:64): (model, knobs over the flagship or the quick start, bucket
# count, qsgd_encode_rows launches per step, wire bytes: the JAX package's
# GradientExchanger.payload_bytes)
BUCKET_BYTES = 4_194_304
BUCKETED = {
    "drqsgd_bloom_bucketed": ("wordlstm", dict(bucket_bytes=BUCKET_BYTES), 4, 1, 1_183_968),
    "drqsgd_bloom_stream": ("wordlstm", dict(bucket_bytes=BUCKET_BYTES, bucket_order="reverse", stream_exchange=True),
                            5, 5, 1_183_992),
    "resnet20_quickstart_bucketed": ("resnet20", dict(bucket_bytes=BUCKET_BYTES), 1, 0, 9_592),
}
# phase 11: the codec zoo, every on-device codec, policy, layout, wrapper
# mode and sparsifier: (model, knobs over the flagship or the quick start,
# qsgd_encode_rows launches per step, wire bytes: the JAX package's
# GradientExchanger.payload_bytes, card = CPU: "bitwise" or the atol over
# max |g| of a fitted or sketched value: the card solves its own LU and sums
# in another order, which an H100 puts at 4.0e-8 (PolyFit, Fit-DExp, the
# sketch) and 1.4e-7 (PolySeg) of max |g| (PERF.md); a wrong card path is
# off by a share of max |g| itself)
FIT_CARD_ATOL = 1e-6
ZOO = {
    "drqsgd_bloom_p1": ("wordlstm", dict(policy="random"), 1, 1_109_120, "bitwise"),
    "drqsgd_bloom_p2a": ("wordlstm", dict(policy="conflict_sets_approx"), 1, 1_109_120, "bitwise"),
    "drqsgd_bloom_hash": ("wordlstm", dict(bloom_blocked="hash"), 1, 1_189_572, "bitwise"),
    "drqsgd_rle": ("wordlstm", dict(index="rle"), 1, 2_358_196, "bitwise"),
    "topr_polyfit": ("wordlstm", dict(deepreduce="value", value="polyfit"), 0, 1_627_804, FIT_CARD_ATOL),
    "topr_dexp": ("wordlstm", dict(deepreduce="value", value="doubleexp"), 0, 1_621_660, FIT_CARD_ATOL),
    "topr_countsketch": ("wordlstm", dict(deepreduce="value", value="countsketch"), 0, 4_859_888, FIT_CARD_ATOL),
    "randomk_qsgd": ("wordlstm", dict(compressor="randomk", deepreduce="value", value="qsgd"), 1, 2_031_688, "bitwise"),
    # the Table-6 knobs (benchmarks/ncf_table6.py:113-117): natural sparsity
    "threshold_bloom_qsgd": ("wordlstm", dict(compressor="threshold", threshold_val=0.0, compress_ratio=0.2,
                                              memory="none", fpr=0.6, quantum_num=63), 1, 3_020_240, "bitwise"),
    # the quick start with PolySeg on its conv kernels (the default '(?i)conv')
    "resnet20_polyseg": ("resnet20", dict(deepreduce="value", value="polyseg"), 0, 20_076, FIT_CARD_ATOL),
}
# the codec table's configs (bench.py:159 measure_config's input, d =
# 4,053,428 at ratio 0.1); PolySeg's pattern is opened to the flat tensor
ZOO_CODEC_TABLE = {
    "rle": dict(index="rle"), "doubleexp": dict(deepreduce="value", value="doubleexp"),
    "polyseg": dict(deepreduce="value", value="polyseg", layer_pattern=".*"),
    "countsketch": dict(deepreduce="value", value="countsketch"), "polyfit_value": dict(deepreduce="value", value="polyfit"),
    "bloom_p1": dict(policy="random"), "bloom_p2a": dict(policy="conflict_sets_approx"), "bloom_hash": dict(bloom_blocked="hash"),
}
# phase 12: compressed FedAvg, the paper's federated deployment, at full
# width: MobileNetV1 (Table 5, benchmarks/mobilenet_table5.py:58-101 and
# :138-147, whose width 0.25 and 16x16 images were smoke-scale cuts) and the
# WordLSTM (Table 2, benchmarks/lstm_table2.py:90-95 and :136-149, whose
# vocab 256 / embed 32 / hidden 64 were cuts). DRQSGD-BF-P0 as the scripts
# build it (their tpu_defaults' approx_topk replaced by exact top-k, which
# the port implements), the same config both ways.
FED_DRQSGD = dict(
    compressor="topk", compress_ratio=0.1, deepreduce="both", index="bloom", value="qsgd", policy="p0",
    fpr=0.02, bloom_blocked="mod", approx_topk=False, memory="residual", min_compress_size=500,
)
FEDAVG = {
    "fedavg_mobilenet_dense": dict(model="mobilenet", knobs=dict(compressor="none", deepreduce=None, memory="none"),
                                   clients=(10, 10), local_steps=4, lr=0.2, momentum=0.9, batch=24, rounds=3),
    "fedavg_mobilenet_drqsgd": dict(model="mobilenet", knobs=FED_DRQSGD, clients=(10, 10), local_steps=4, lr=0.2,
                                    momentum=0.9, batch=24, rounds=3),
    "fedavg_lstm_drqsgd": dict(model="wordlstm", knobs=FED_DRQSGD, clients=(57, 56), local_steps=4, lr=2.0,
                               momentum=0.9, batch=16, seq=20, rounds=2),
}
# each arm's wire for one tree in one direction, from the JAX package's codec
# geometry (tests/test_torch_fedavg.py derives them): index bits and dense
# bits as float32 sums in the leaves' order, and the least and the most
# value bits (a p0 bloom leaf sends between k and its budget of values)
FEDAVG_WIRE = {
    "fedavg_mobilenet_dense": (0.0, 102951232.0, 102951232.0, 102951232.0),
    "fedavg_mobilenet_drqsgd": (4435456.0, 102951232.0, 2603504.0, 3122816.0),
    "fedavg_lstm_drqsgd": (5576672.0, 129623936.0, 3266368.0, 3892080.0),
}
# phase 13: the Table-6 per-leaf encode of benchmarks/ncf_table6.py:56-160 on
# NeuMF at the ML-20m widths: threshold 0.0 with the bloom index at fpr 0.6
# p0 and QSGD 7-bit (q 63) / 512 where the leaf is naturally sparse, dense
# QSGD where its calibrated budget saturates
TABLE6_THRESHOLD = dict(
    compressor="threshold", threshold_val=0.0, memory="none", deepreduce="both", index="bloom", value="qsgd",
    policy="p0", fpr=0.6, bloom_blocked="mod", quantum_num=63, bucket_size=512, min_compress_size=1000,
)
TABLE6_DENSE = dict(compressor="none", memory="none", deepreduce="value", value="qsgd", quantum_num=63,
                    bucket_size=512, min_compress_size=1000)
# the JAX package's run of the same encode, beside this script
TABLE6_RECORD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "NCF_TABLE6.json")


def table6_route(sample_grad, safety: float = 1.25):
    """(route, budget ratio, knobs) of one leaf from its sample gradient, as
    benchmarks/ncf_table6.py routes it."""
    from deepreduce_tpu_torch.sparse import calibrate_threshold_budget

    ratio = calibrate_threshold_budget([sample_grad], 0.0, safety=safety)
    if ratio >= 1.0:
        return "dense_qsgd", ratio, TABLE6_DENSE
    return "threshold_bloom_qsgd", ratio, dict(TABLE6_THRESHOLD, compress_ratio=ratio)


def ncf_batch(seed: int, num_users: int, num_items: int, interactions: int = 1_000_000,
              zipf: float = 0.8, negatives: int = 4):
    """benchmarks/ncf_table6.py's `batch_at(seed)`: power-law users and
    positive items, `negatives` uniform negative items per positive
    (numpy arrays: users, items, float32 labels)."""
    import numpy as np

    u_w = np.arange(1, num_users + 1, dtype=np.float64) ** (-zipf)
    u_w /= u_w.sum()
    i_w = np.arange(1, num_items + 1, dtype=np.float64) ** (-zipf)
    i_w /= i_w.sum()
    n_pos = interactions // (1 + negatives)
    r = np.random.default_rng(seed)
    pos_users = r.choice(num_users, size=n_pos, p=u_w)
    pos_items = r.choice(num_items, size=n_pos, p=i_w)
    neg_items = r.integers(0, num_items, n_pos * negatives)
    users = np.concatenate([pos_users, np.repeat(pos_users, negatives)])
    items = np.concatenate([pos_items, neg_items])
    labels = np.concatenate([np.ones(n_pos, np.float32), np.zeros(n_pos * negatives, np.float32)])
    return users, items, labels


LARGEST_CONV = ("BasicBlockV2_8/Conv_1/kernel", (3, 3, 64, 64))
# PolyFit's coefficients are solved by another LU on the card than on the
# CPU; the decode evaluates them (basis rows bounded by 1, six terms)
COEFF_RTOL, COEFF_ATOL, DECODE_ATOL = 1e-4, 1e-6, 1e-5  # the atols times max |g|


def _flagship_cfg(seed: int, **knobs):
    from deepreduce_tpu_torch import DeepReduceConfig

    flagship = dict(
        compressor="topk", compress_ratio=0.1, approx_topk=False, memory="residual",
        communicator="allgather", deepreduce="both", index="bloom", value="qsgd",
        fpr=0.02, policy="p0", bloom_blocked="mod", quantum_num=127, bucket_size=512,
        fused=True, decode_strategy="loop", seed=seed,
    )
    return DeepReduceConfig(**{**flagship, **knobs})


def _host_ms(fn, reps: int) -> float:
    """Host time per call: the wrapper's checks, allocations and launches,
    over `reps` back-to-back calls, without waiting for the card."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return ms


def _device_ms(fn, reps: int, name_part: str = "") -> tuple:
    """(device ms, kernel launches) per call from torch.profiler: the self
    device time and count of the kernels whose name contains `name_part`
    (all kernels when empty) over `reps` calls, divided by `reps`. The time
    is 0.0 if the profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [(cnt, us) for key, cnt, us in _kernel_rows(prof) if name_part in key]
    return sum(us for _, us in rows) / 1e3 / reps, sum(cnt for cnt, _ in rows) / reps


def _kernel_rows(prof):
    """(name, count, device us) of the device-side kernel events only: the
    CPU-side operator rows also carry their kernels' device time, and
    summing both would count it twice."""
    from torch.autograd import DeviceType

    rows = []
    for evt in prof.key_averages():
        # a `record_function` range (FedAvg's "fedavg/s2c", "fedavg/clients")
        # shows as a device row spanning its kernels: not a kernel
        if evt.device_type != DeviceType.CUDA or getattr(evt, "is_user_annotation", False):
            continue
        us = getattr(evt, "self_device_time_total", 0.0) or getattr(evt, "self_cuda_time_total", 0.0)
        rows.append((evt.key, evt.count, us))
    return rows


def _profile_step(step_fn) -> dict:
    """Device busy time of one step and its largest kernels, from
    torch.profiler; the wall time comes from CUDA events around the step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        step_fn()
        end.record()
        end.synchronize()
    wall_ms = start.elapsed_time(end)
    rows = sorted(((us / 1e3, cnt, key[:70]) for key, cnt, us in _kernel_rows(prof)), reverse=True)
    busy_ms = sum(r[0] for r in rows)
    return {
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms) if wall_ms else None,
        "kernel_launches": sum(r[1] for r in rows),
        "top_device_ms": [[round(ms, 4), cnt, key] for ms, cnt, key in rows[:15]],
    }


def _qsgd_inputs(n: int, seed: int, device):
    """f32 values (30% exact zeros) and their bucket scale q/||bucket||."""
    import torch

    from deepreduce_tpu_torch.codecs.qsgd import bucket_scale

    gen = torch.Generator().manual_seed(seed)
    v = torch.randn(n, generator=gen)
    v[torch.rand(n, generator=gen) < 0.3] = 0.0
    padded = torch.zeros(-(-n // 512) * 512)
    padded[:n] = v
    scale, _ = bucket_scale(padded, 127, 512)
    return v.to(device), scale[:n].contiguous().to(device)


def phase_device() -> None:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(smi)
    print(f"phase 1 ok: torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} "
          f"python {sys.version.split()[0]}", flush=True)


def phase_build() -> None:
    from deepreduce_tpu_torch.ops import build

    times = build.build_all()
    for name, log in build.build_logs.items():
        ptxas = " | ".join(l.strip() for l in log.splitlines() if "ptxas info" in l and "Used" in l)
        print(f"  {name}: {ptxas}")
    print(f"phase 2 ok: built {json.dumps({k: round(v, 2) for k, v in times.items()})} s", flush=True)


def phase_kernels(sizes, ex) -> dict:
    """Each kernel vs its plain version on the card's inputs; returns the
    max |difference| per kernel."""
    return {"qsgd_quantize": _check_quantize(sizes), "qsgd_encode_rows": _check_encode(ex)}


def _check_quantize(sizes) -> float:
    import torch

    from deepreduce_tpu_torch.ops import philox_uniforms_plain, quantize_levels, quantize_levels_plain

    dev = torch.device("cuda")
    max_err = 0.0
    for i, n in enumerate(sorted(set(sizes)) + [1_000_003]):
        seed, offset = (0xC0FFEE << 32) | i, (i << 32) | 5
        v, s = _qsgd_inputs(n, 100 + i, dev)
        got = quantize_levels(v, s, seed, offset, device=dev)
        torch.cuda.synchronize()
        ref = quantize_levels_plain(v.cpu(), s.cpu(), philox_uniforms_plain(n, seed, offset))
        err = float((got.cpu().int() - ref.int()).abs().max())
        max_err = max(max_err, err)
        _check(torch.equal(got.cpu(), ref), f"qsgd_quantize != plain at n={n} (max |diff| {err})")
        _check(int(got.int().abs().max()) <= 127, f"|level| > q at n={n}")
        _check(torch.equal(got, quantize_levels(v, s, seed, offset, device=dev)), f"not repeatable at n={n}")
        _check(not torch.equal(got, quantize_levels(v, s, seed, offset + 1, device=dev)) or n < 64,
               f"offset does not change the draw at n={n}")
    # unbiasedness: mean of level * norm / q over many offsets matches v
    n, draws = 8192, 256
    v, s = _qsgd_inputs(n, 7, dev)
    acc = torch.zeros(n, dtype=torch.float64, device=dev)
    for d in range(draws):
        acc += quantize_levels(v, s, 99, d, device=dev).double() / s.double()
    dev_max = float(((acc / draws) - v.double()).abs().max())
    level_size = float((1.0 / s.double()).max())
    # Bernoulli rounding: sd of one draw <= level/2; 6 sd of the mean
    bound = 6 * level_size / 2 / math.sqrt(draws)
    _check(dev_max < bound, f"biased quantizer: max |mean - v| {dev_max} >= {bound}")
    print(f"phase 3 ok: qsgd_quantize bitwise equal to plain at n={sorted(set(sizes)) + [1_000_003]}, "
          f"max_abs_err {max_err}, unbiased (max |mean-v| {dev_max:.3g} < {bound:.3g})", flush=True)
    return max_err


def _main_path_table(ex, seed: int):
    """The main path's segment table on the card: one segment per compressed
    unit of `ex` (leaf, or bucket when bucketed), f32[budget] values (30%
    exact zeros, gradient-sized) made from `seed`, rows at the unit's offset
    in the fused buffer, the unit's own stream at (TABLE_STEP, TABLE_WORKER)."""
    import torch

    from deepreduce_tpu_torch.ops import EncodeSegment
    from deepreduce_tpu_torch.sparse import per_tensor_stream

    gen = torch.Generator().manual_seed(seed)
    segs = []
    for n, codec in ex.codecs.items():
        if codec.rows_leaf is None:
            continue
        k = codec.val_codec.meta.k
        v = torch.randn(k, generator=gen) * 1e-3
        v[torch.rand(k, generator=gen) < 0.3] = 0.0
        rows_lo = ex.offsets[n] + ex.layouts[n].leaf_offsets[codec.rows_leaf]
        st_seed, st_offset = per_tensor_stream(ex.cfg.seed, n, TABLE_STEP, TABLE_WORKER)
        segs.append(EncodeSegment(v.cuda(), rows_lo, st_seed, st_offset))
    return segs


def _plain_rows(segs, nbytes: int, q: int, bs: int):
    """The rows of one segment table from the plain version on the CPU:
    uint8[nbytes]."""
    import dataclasses

    import torch

    from deepreduce_tpu_torch.ops import qsgd_encode_rows

    ref = torch.zeros(nbytes, dtype=torch.uint8)
    cpu_segs = [dataclasses.replace(s, values=s.values.cpu()) for s in segs]
    qsgd_encode_rows(cpu_segs, ref, quantum_num=q, bucket_size=bs, device="cpu")
    return ref


def _encode_on_card_and_cpu(segs, nbytes: int, q: int, bs: int):
    """(rows from the kernel, rows from the plain version on the CPU) of
    one table, both uint8[nbytes] on the CPU."""
    import torch

    from deepreduce_tpu_torch.ops import qsgd_encode_rows

    out = torch.zeros(nbytes, dtype=torch.uint8, device="cuda")
    qsgd_encode_rows(segs, out, quantum_num=q, bucket_size=bs, device="cuda")
    torch.cuda.synchronize()
    return out.cpu(), _plain_rows(segs, nbytes, q, bs)


def _segment_rows(buf, seg, bs: int):
    """(int8 levels [B, bs], f32 norms [B]) of one segment's rows in `buf`."""
    import torch

    from deepreduce_tpu_torch.ops.qsgd_encode import num_buckets

    b = num_buckets(seg.values.shape[0], bs)
    rows = buf[seg.out_offset : seg.out_offset + b * (bs + 4)].view(b, bs + 4)
    return rows[:, :bs].view(torch.int8), rows[:, bs:].contiguous().view(torch.float32).reshape(b)


def _check_rows(got, ref, segs, bs: int, q: int, what: str) -> float:
    """Bitwise equality of every segment's rows and |level| <= q; returns
    the max |difference| over levels and norms."""
    err = 0.0
    for i, seg in enumerate(segs):
        gl, gn = _segment_rows(got, seg, bs)
        rl, rn = _segment_rows(ref, seg, bs)
        err = max(err, float((gl.int() - rl.int()).abs().max()), float((gn - rn).abs().max()))
        _check(int(gl.int().abs().max()) <= q, f"|level| > q in {what} segment {i}")
    _check(bool((got == ref).all()), f"qsgd_encode_rows != plain on {what} (max |diff| {err})")
    return err


def _check_encode(ex) -> float:
    import torch

    from deepreduce_tpu_torch.ops import EncodeSegment, qsgd_encode_rows
    from deepreduce_tpu_torch.ops.qsgd_encode import rows_nbytes

    q, bs = ex.cfg.quantum_num, ex.cfg.bucket_size
    # the main path's own table, at its offsets in the fused buffer
    segs = _main_path_table(ex, seed=11)
    got, ref = _encode_on_card_and_cpu(segs, ex.fused_nbytes, q, bs)
    max_err = _check_rows(got, ref, segs, bs, q, "the main path's table")
    again, _ = _encode_on_card_and_cpu(segs, ex.fused_nbytes, q, bs)
    _check(torch.equal(got, again), "qsgd_encode_rows is not repeatable")
    moved = [EncodeSegment(s.values, s.out_offset, s.seed, s.offset + 1) for s in segs]
    other, _ = _encode_on_card_and_cpu(moved, ex.fused_nbytes, q, bs)
    _check(not torch.equal(got, other), "the offset does not change the draw")
    # single segments: odd sizes, a bucket size that is not a multiple of 4,
    # one above 512, values off a 16-byte boundary, rows off a 4-byte one
    cases = [(1, 512, 0, 0), (5, 512, 0, 0), (513, 512, 0, 0), (1_000_003, 512, 0, 0),
             (5, 100, 0, 0), (513, 100, 0, 0), (1_000_003, 100, 0, 0), (3001, 1024, 0, 0),
             (114_688, 512, 1, 0), (53_760, 512, 0, 1), (513, 512, 3, 2)]
    # bucket sizes 100, 1000, 1024 and 2048 at every value / row shift (the
    # vector kernel, with scalar loads off a 16-byte boundary), and the
    # generic kernel: one above 4,096 (8 elements a thread) and one that is
    # not a multiple of 4
    cases += [(10_007, cbs, vs, os) for cbs in (100, 1000, 1024, 2048) for vs, os in ((0, 0), (1, 0), (0, 1), (3, 2))]
    cases += [(20_001, 8192, 0, 0), (1001, 3, 0, 0)]
    gen = torch.Generator().manual_seed(12)
    for i, (k, cbs, vshift, oshift) in enumerate(cases):
        v = torch.randn(k + vshift, generator=gen)
        v[torch.rand(k + vshift, generator=gen) < 0.3] = 0.0
        seg = [EncodeSegment(v.cuda()[vshift:], oshift, (0xFEED << 32) | i, (i << 32) | 1)]
        got1, ref1 = _encode_on_card_and_cpu(seg, oshift + rows_nbytes(k, cbs), q, cbs)
        max_err = max(max_err, _check_rows(got1, ref1, seg, cbs, q, f"k={k} bucket {cbs} shifts {vshift}/{oshift}"))
    # one launch over segments whose values lie on and off a 16-byte boundary
    mixed, off = [], 0
    for i, (k, vshift) in enumerate(((3001, 0), (2049, 1), (10_007, 0), (700, 3))):
        v = torch.randn(k + vshift, generator=gen)
        mixed.append(EncodeSegment(v.cuda()[vshift:], off, (0xBEEF << 32) | i, i))
        off += rows_nbytes(k, bs)
    got1, ref1 = _encode_on_card_and_cpu(mixed, off, q, bs)
    max_err = max(max_err, _check_rows(got1, ref1, mixed, bs, q, "a table of aligned and shifted values"))
    # unbiasedness: the decoded mean over many offsets matches the values
    k, draws = 8192, 256
    v = torch.randn(k, generator=gen).cuda()
    out = torch.zeros(rows_nbytes(k, bs), dtype=torch.uint8, device="cuda")
    acc = torch.zeros(k, dtype=torch.float64, device="cuda")
    for d in range(draws):
        seg = EncodeSegment(v, 0, 99, d)
        qsgd_encode_rows([seg], out, quantum_num=q, bucket_size=bs, device="cuda")
        levels, norms = _segment_rows(out, seg, bs)
        acc += (levels.double() * (norms.double() / q)[:, None]).reshape(-1)
    dev_max = float(((acc / draws) - v.double()).abs().max())
    bound = 6 * float(norms.double().max()) / q / 2 / math.sqrt(draws)
    _check(dev_max < bound, f"biased encode: max |mean - v| {dev_max} >= {bound}")
    print(f"phase 3 ok: qsgd_encode_rows bitwise equal to plain (levels and norm bytes) on the main path's "
          f"{len(segs)}-segment table, at (k, bucket, value shift, row shift) {cases} and on a 4-segment table of "
          f"aligned and shifted values, max_abs_err {max_err}, "
          f"repeatable, unbiased (max |mean-v| {dev_max:.3g} < {bound:.3g})", flush=True)
    return max_err


EMBED_SHAPE = (10_004, 96)


def _embed_grad(seed: int):
    """An Embed_0-sized gradient: the 1,280 rows one batch's tokens touch."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    g = torch.zeros(EMBED_SHAPE)
    rows = torch.randperm(EMBED_SHAPE[0], generator=gen)[:1280]
    g[rows] = torch.randn(len(rows), EMBED_SHAPE[1], generator=gen)
    return g


def _embed_codec(cfg, seed: int) -> dict:
    """The Embed_0-sized gradient through TensorCodec on the card and on the
    CPU with the same stream: {device: (codec, payload, decoded on the CPU,
    host branches taken)}."""
    from deepreduce_tpu_torch import TensorCodec
    from deepreduce_tpu_torch.sparse import host_branch

    g = _embed_grad(seed)
    out = {}
    for dev in ("cuda", "cpu"):
        codec = TensorCodec(EMBED_SHAPE, cfg, name="Embed_0/embedding", device=dev)
        before = host_branch.syncs
        pay = codec.encode(g.to(dev), step=3, worker=0)
        out[dev] = (codec, pay, codec.decode(pay).cpu(), host_branch.syncs - before)
    return out


def phase_codec(seed: int) -> None:
    import torch

    out = _embed_codec(_flagship_cfg(seed), seed)
    (codec, gp, gdec, _), (_, cp, cdec, _) = out["cuda"], out["cpu"]
    _check(torch.equal(gp.index_payload.words.cpu(), cp.index_payload.words), "bloom words differ")
    _check(int(gp.nsel) == int(cp.nsel), "nsel differs")
    meta = codec.val_codec.meta
    grows = gp.value_payload.data.cpu().view(meta.num_buckets, -1)
    crows = cp.value_payload.data.view(meta.num_buckets, -1)
    gnorm = grows[:, meta.bucket_size:].contiguous().view(torch.float32)
    cnorm = crows[:, meta.bucket_size:].contiguous().view(torch.float32)
    same = int((gnorm == cnorm).sum())
    _check(same == meta.num_buckets, f"bucket norms differ: {same}/{meta.num_buckets} bitwise equal")
    _check(torch.equal(grows, crows), "levels differ")
    # decoded values are level * (norm * fl(1/q)) on both devices
    _check(torch.equal(gdec, cdec), f"decoded tensors differ (max |diff| {float((gdec - cdec).abs().max())})")
    print(f"phase 4 ok: Embed_0 {EMBED_SHAPE} codec cuda == cpu: words, nsel={int(gp.nsel)}, "
          f"{same}/{meta.num_buckets} norms, every level and the decoded tensor bitwise", flush=True)


def _tokens(seed: int, steps: int, batch: int, seq: int, vocab: int):
    import torch

    gen = torch.Generator().manual_seed(seed + 1)
    return torch.randint(0, vocab, (steps, batch, seq + 1), generator=gen)


def _counting_syncs(fn):
    """`fn()` under torch's sync debug mode: (its result, the file:line of
    each host sync it made). Every synchronizing call the mode detects (a
    copy to or from the host, `.item()`, a stream wait) warns once."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # where each sync was called from: the Python line that made the call
    return out, [f"{w.filename}:{w.lineno}" for w in caught if "called a synchronizing" in str(w.message)]


def _step_counting_syncs(trainer, state, batch, **step_kw):
    """One training step under torch's sync debug mode: (state, loss, wire,
    the file:line of each host sync the step made)."""
    (state, loss, wire), syncs = _counting_syncs(lambda: trainer.step(state, batch, **step_kw))
    return state, loss, wire, syncs


def _run_steps(trainer, state, batches, steps: int, collects=None):
    """(state, losses, device ms, host ms, last wire stats, the host syncs
    of each step) of `steps` training steps on `batches(i)`, each timed by
    CUDA events and the host clock. With a list `collects`, each step's
    exchange observables are appended to it."""
    import torch

    losses, dev_ms, host_ms, syncs = [], [], [], []
    wire = None
    for i in range(steps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        kw = {}
        if collects is not None:
            kw["collect"] = {}
            collects.append(kw["collect"])
        state, loss, wire, step_syncs = _step_counting_syncs(trainer, state, batches(i), **kw)
        end.record()
        end.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        dev_ms.append(start.elapsed_time(end))
        losses.append(float(loss))
        syncs.append(step_syncs)
    return state, losses, dev_ms, host_ms, wire, syncs


def _check_trained(state, losses, ref_loss: float, what: str) -> None:
    import torch

    _check(all(math.isfinite(l) for l in losses), f"{what}: non-finite loss {losses}")
    _check(all(bool(torch.isfinite(p).all()) for p in state.params.values()), f"{what}: non-finite parameters")
    _check(abs(losses[0] - ref_loss) <= 1e-4 * abs(ref_loss),
           f"{what}: first-step loss {losses[0]} vs CPU reference {ref_loss}")


def phase_train(seed: int, tokens, group, profile: bool = False) -> dict:
    import torch

    from deepreduce_tpu_torch import Trainer
    from deepreduce_tpu_torch.models import WordLSTM
    from deepreduce_tpu_torch.ops import launch_counts, reset_launch_counts
    from deepreduce_tpu_torch.sparse import host_branch

    steps = tokens.shape[0]
    model = WordLSTM(seed=seed)
    n_params = sum(p.numel() for p in model.parameters())
    _check(n_params == 4_050_748, f"WordLSTM has {n_params} parameters")
    # reference loss of the first batch at the initial weights, on the CPU
    with torch.no_grad():
        logits = model(tokens[0, :, :-1])
        ref_loss = float(torch.nn.functional.cross_entropy(
            logits.reshape(-1, logits.shape[-1]), tokens[0, :, 1:].reshape(-1)))
    trainer = Trainer(model, _flagship_cfg(seed), lr=0.1, momentum=0.9, device="cuda", group=group)
    state = trainer.init_state()
    tokens = tokens.cuda()
    torch.cuda.synchronize()
    reset_launch_counts()
    host_branch.syncs = 0
    state, losses, dev_ms, host_ms, wire, sync_calls = _run_steps(
        trainer, state, lambda i: (tokens[i, :, :-1], tokens[i, :, 1:]), steps)
    launches, syncs = launch_counts(), host_branch.syncs
    ex = trainer.exchanger
    sizes = [c.val_codec.meta.padded_len for c in ex.codecs.values() if c.compressed]
    # one grouped QSGD encode per worker-step; the per-leaf quantizer
    # is no longer on the main path
    expected = {"qsgd_quantize": 0, "qsgd_encode_rows": steps}
    _check(launches == expected, f"kernel launches on the main path {launches}, expected {expected}")
    _check_trained(state, losses, ref_loss, "main path")
    rel_volume = float(wire.rel_volume())
    _check(0.0 < rel_volume < 1.0, f"rel_volume {rel_volume}")
    _check(ex.payload_bytes() == PAYLOAD_BYTES["drqsgd_bloom"], f"payload_bytes {ex.payload_bytes()}")
    res = {
        "losses": losses, "cpu_ref_loss0": ref_loss, "rel_volume": rel_volume,
        "payload_bytes": ex.payload_bytes(), "params": n_params,
        "step_ms_median": statistics.median(dev_ms[1:]) if steps > 1 else dev_ms[0],
        "step_ms_first": dev_ms[0], "step_ms_all": dev_ms, "host_step_ms_all": host_ms,
        "launches": launches, "host_syncs_per_step": syncs / steps,
        "sync_calls_per_step": [len(x) for x in sync_calls],
        "sync_call_sites": sorted({m for x in sync_calls for m in x}), "qsgd_sizes": sizes,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
    }
    res["codec_table"] = _codec_times(_flagship_cfg(seed))
    print("phase 5 ok: " + json.dumps(res), flush=True)
    if profile:
        # one more step, after the counted run, under the profiler
        x, y = tokens[0, :, :-1], tokens[0, :, 1:]
        prof = _profile_step(lambda: trainer.step(state, (x, y)))
        print("phase 5 profile: " + json.dumps(prof), flush=True)
    return res


def _events_ms(fn, reps: int = 10) -> float:
    """ms per call from CUDA events around `reps` calls after a warm-up;
    the events span the host's gaps too."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _codec_times(cfg, reps: int = 10) -> dict:
    """bench.py's codec table on the card: encode and decode of one flat
    gradient of d = 4,053,428 (normal times uniform squared, from a fixed
    seed) at the arm's config, ms per call from CUDA events around `reps`
    calls after a warm-up. The events span the host's gaps too (the sampled
    threshold's host sync), so this is the call's time on the card's clock."""
    import torch

    from deepreduce_tpu_torch import TensorCodec

    gen = torch.Generator().manual_seed(0)
    g = (torch.randn(CODEC_TABLE_D, generator=gen) * torch.rand(CODEC_TABLE_D, generator=gen) ** 2).cuda()
    codec = TensorCodec((CODEC_TABLE_D,), cfg, name="bench", device="cuda")
    payload = codec.encode(g)
    stats = codec.wire_stats(payload)
    return {
        "encode_ms": _events_ms(lambda: codec.encode(g), reps),
        "decode_ms": _events_ms(lambda: codec.decode(payload), reps),
        "rel_volume": float(stats.rel_volume()), "payload_bits": float(stats.total_bits),
    }


def _check_embed_arm(cfg, seed: int, arm: str) -> dict:
    """The Embed_0-sized gradient through the arm's TensorCodec on the card
    and on the CPU: every payload leaf bitwise equal, the same host branch
    (and, for sampled top-k, the same threshold), the decodes bitwise equal."""
    import torch

    from deepreduce_tpu_torch.sparse import sampled_kth_magnitude

    out = _embed_codec(cfg, seed)
    (codec, gp, gdec, gbr), (_, cp, cdec, cbr) = out["cuda"], out["cpu"]
    gl, cl = gp.leaves(), cp.leaves()
    _check(len(gl) == len(cl), f"{arm}: payload leaf counts differ")
    for i, (a, b) in enumerate(zip(gl, cl)):
        _check(torch.equal(a.cpu(), b), f"{arm}: Embed_0 payload leaf {i} differs between card and CPU")
    _check(gbr == cbr, f"{arm}: {gbr} host branches on the card, {cbr} on the CPU")
    res = {"leaves_equal": len(gl), "host_branches": gbr}
    g = _embed_grad(seed).reshape(-1)
    if cfg.compressor == "topk_sampled" and g.numel() > max(4 * codec.k, 2 * cfg.topk_sample_size):
        ts = [sampled_kth_magnitude(x, codec.k, sample_size=cfg.topk_sample_size, undershoot=cfg.topk_undershoot)
              for x in (g.cuda(), g)]
        _check(torch.equal(ts[0].cpu(), ts[1]), f"{arm}: sampled threshold {float(ts[0])} on the card, {float(ts[1])}")
        res["threshold"] = float(ts[1])
        res["branch"] = "sampled" if float(ts[1]) > 0 else "exact (zero threshold)"
    _check(torch.equal(gdec, cdec), f"{arm}: decoded tensors differ")
    if codec.compressed:
        res["nsel"] = int(codec.idx_codec.selected(cp.index_payload if codec.val_codec else cp))
    return res


def phase_arms(seed: int, tokens, group, ref_loss: float, profile: bool = False) -> dict:
    """Phase 7: every other Table-4 arm through `Trainer.step`."""
    import torch

    from deepreduce_tpu_torch import Trainer
    from deepreduce_tpu_torch.models import WordLSTM
    from deepreduce_tpu_torch.ops import launch_counts, reset_launch_counts
    from deepreduce_tpu_torch.sparse import host_branch

    tokens = tokens[:ARM_STEPS].cuda()
    results = {}
    for arm, knobs in ARMS.items():
        cfg = _flagship_cfg(seed, **knobs)
        trainer = Trainer(WordLSTM(seed=seed), cfg, lr=0.1, momentum=0.9, device="cuda", group=group)
        state = trainer.init_state()
        ex = trainer.exchanger
        torch.cuda.synchronize()
        reset_launch_counts()
        host_branch.syncs = 0
        state, losses, dev_ms, host_ms, wire, sync_calls = _run_steps(
            trainer, state, lambda i: (tokens[i, :, :-1], tokens[i, :, 1:]), ARM_STEPS)
        launches, syncs = launch_counts(), host_branch.syncs
        qsgd = any(c.val_codec is not None for c in ex.codecs.values())
        expected = {"qsgd_quantize": 0, "qsgd_encode_rows": ARM_STEPS if qsgd else 0}
        _check(launches == expected, f"{arm}: kernel launches {launches}, expected {expected}")
        _check_trained(state, losses, ref_loss, arm)
        rel_volume = float(wire.rel_volume())
        _check(rel_volume == 1.0 if ex.dense else 0.0 < rel_volume < 1.0, f"{arm}: rel_volume {rel_volume}")
        _check(ex.payload_bytes() == PAYLOAD_BYTES[arm], f"{arm}: payload_bytes {ex.payload_bytes()}")
        res = {
            "losses": losses, "step_ms_all": dev_ms, "step_ms_median": statistics.median(dev_ms),
            "host_step_ms_all": host_ms, "rel_volume": rel_volume, "payload_bytes": ex.payload_bytes(),
            "launches": launches, "host_syncs_per_step": syncs / ARM_STEPS,
            "sync_calls_per_step": [len(x) for x in sync_calls],
            "sync_call_sites": sorted({m for x in sync_calls for m in x}),
            "compressed_leaves": sum(c.compressed for c in ex.codecs.values()),
        }
        if qsgd:
            # the kernel against its plain version on this arm's own table
            q, bs = cfg.quantum_num, cfg.bucket_size
            segs = _main_path_table(ex, seed=17)
            got, ref = _encode_on_card_and_cpu(segs, ex.fused_nbytes, q, bs)
            res["qsgd_table_max_abs_err"] = _check_rows(got, ref, segs, bs, q, f"the {arm} table")
            res["qsgd_segments"] = len(segs)
        if profile:
            x, y = tokens[0, :, :-1], tokens[0, :, 1:]
            prof = _profile_step(lambda: trainer.step(state, (x, y)))
            res["profile"] = {k: prof[k] for k in ("wall_ms", "device_busy_ms", "device_idle_share", "kernel_launches")}
        res["codec_table"] = _codec_times(cfg)
        res["embed_card_vs_cpu"] = _check_embed_arm(cfg, seed, arm)
        print(f"phase 7 ok: {arm} " + json.dumps(res), flush=True)
        results[arm] = res
        del trainer, state
        torch.cuda.empty_cache()
    return results


def _images(seed: int, steps: int):
    """Synthetic CIFAR-shaped batches from `seed`: NHWC images and labels."""
    import torch

    gen = torch.Generator().manual_seed(seed + 2)
    images = torch.randn(steps, RESNET_BATCH, 32, 32, 3, generator=gen)
    labels = torch.randint(0, 10, (steps, RESNET_BATCH), generator=gen)
    return images, labels


def _resnet_codec_card_vs_cpu(cfg, seed: int) -> dict:
    """The largest conv gradient through the quick-start TensorCodec on the
    card and on the CPU with the same input: filter words, nsel, num_pos and
    the mapping bitwise, the coefficients and the decode within tolerance."""
    import torch

    from deepreduce_tpu_torch import TensorCodec

    name, shape = LARGEST_CONV
    gen = torch.Generator().manual_seed(seed + 3)
    g = torch.randn(shape, generator=gen) * 0.05
    out = {}
    for dev in ("cuda", "cpu"):
        codec = TensorCodec(shape, cfg, name=name, device=dev)
        pay = codec.encode(g.to(dev))
        out[dev] = (codec, pay, codec.decode(pay).cpu())
    (codec, gp, gdec), (_, cp, cdec) = out["cuda"], out["cpu"]
    _check(gp.value_payload.coeffs.is_cuda, "the PolyFit solve did not run on the card")
    bitwise = {
        "bloom words": (gp.index_payload.words, cp.index_payload.words),
        "nsel": (gp.nsel, cp.nsel),
        "num_pos": (gp.value_payload.num_pos, cp.value_payload.num_pos),
        "mapping words": (gp.mapping.words, cp.mapping.words),
        "mapping count": (gp.mapping.count, cp.mapping.count),
        "mapping width": (gp.mapping.width, cp.mapping.width),
    }
    for what, (a, b) in bitwise.items():
        _check(torch.equal(a.cpu(), b), f"{name}: {what} differ between the card and the CPU")
    vmax = float(g.abs().max())
    coeff_err = float((gp.value_payload.coeffs.cpu() - cp.value_payload.coeffs).abs().max())
    dec_err = float((gdec - cdec).abs().max())
    _check(torch.allclose(gp.value_payload.coeffs.cpu(), cp.value_payload.coeffs, rtol=COEFF_RTOL,
                          atol=COEFF_ATOL * vmax), f"{name}: coefficients differ by {coeff_err}")
    _check(dec_err <= DECODE_ATOL * vmax, f"{name}: decoded tensors differ by {dec_err}")
    _check(torch.equal(gdec != 0, cdec != 0), f"{name}: the decode places values elsewhere on the card")
    return {
        "leaf": name, "d": codec.d, "k": codec.k, "m_bits": codec.idx_codec.meta.m_bits,
        "num_hash": codec.idx_codec.meta.num_hash, "nsel": int(cp.nsel), "num_pos": int(cp.value_payload.num_pos),
        "map_width": codec.map_width, "coeffs_max_abs_err": coeff_err, "decode_max_abs_err": dec_err,
    }


def _resnet_codec_times(cfg, ex, seed: int) -> dict:
    """Encode and decode times of the largest conv leaf (its TensorCodec)
    and of one whole ResNet-20 gradient (`encode_worker` of every leaf into
    the fused buffer, `decode_aggregate` of it) on the card."""
    import torch

    from deepreduce_tpu_torch import TensorCodec

    gen = torch.Generator().manual_seed(seed + 4)
    grads = {n: (torch.randn(ex.codecs[n].shape, generator=gen) * 0.05).cuda() for n in ex.names}
    residuals = {n: torch.zeros_like(g) for n, g in grads.items()}
    name, shape = LARGEST_CONV
    codec = TensorCodec(shape, cfg, name=name, device="cuda")
    payload = codec.encode(grads[name])
    buf = ex.encode_worker(grads, residuals, step=0, worker=0)[0]
    return {
        "leaf_encode_ms": _events_ms(lambda: codec.encode(grads[name])),
        "leaf_decode_ms": _events_ms(lambda: codec.decode(payload)),
        "tree_encode_ms": _events_ms(lambda: ex.encode_worker(grads, residuals, step=0, worker=0)),
        "tree_decode_ms": _events_ms(lambda: ex.decode_aggregate(buf[None], own=0)),
    }


def phase_resnet(seed: int, group, profile: bool = False) -> dict:
    """Phase 8: the README quick start on ResNet-20, and its QSGD arm."""
    import torch

    from deepreduce_tpu_torch import DeepReduceConfig, Trainer
    from deepreduce_tpu_torch.models import ResNet20
    from deepreduce_tpu_torch.ops import launch_counts, qsgd_encode_rows, reset_launch_counts
    from deepreduce_tpu_torch.ops.qsgd_encode import num_buckets
    from deepreduce_tpu_torch.sparse import host_branch
    from deepreduce_tpu_torch.train import classification_loss

    steps_max = max(steps for _, steps in RESNET_ARMS.values())
    images, labels = _images(seed, steps_max)
    # reference loss of the first batch at the initial weights, on the CPU
    # (BatchNorm in training mode, on a copy so the model's statistics stay)
    with torch.no_grad():
        ref_loss = float(classification_loss(ResNet20(seed=seed))((images[0], labels[0])))
    images, labels = images.cuda(), labels.cuda()
    results = {}
    for arm, (knobs, steps) in RESNET_ARMS.items():
        cfg = DeepReduceConfig(**{**QUICKSTART, **knobs}, seed=seed)
        model = ResNet20(seed=seed)
        n_params = sum(p.numel() for p in model.parameters())
        _check(n_params == 272_282, f"ResNet-20 has {n_params} parameters")
        trainer = Trainer(model, cfg, lr=0.1, momentum=0.9, device="cuda", group=group)
        state = trainer.init_state()
        init_stats = {n: s.clone() for n, s in state.batch_stats.items()}
        ex = trainer.exchanger
        torch.cuda.synchronize()
        reset_launch_counts()
        host_branch.syncs = 0
        state, losses, dev_ms, host_ms, wire, syncs = _run_steps(
            trainer, state, lambda i: (images[i], labels[i]), steps)
        launches = launch_counts()
        qsgd = cfg.value == "qsgd"
        expected = {"qsgd_quantize": 0, "qsgd_encode_rows": steps if qsgd else 0}
        _check(launches == expected, f"{arm}: kernel launches {launches}, expected {expected}")
        _check_trained(state, losses, ref_loss, arm)
        _check(host_branch.syncs == 0, f"{arm}: {host_branch.syncs} host branches")
        if arm == "resnet20_quickstart":
            _check(not any(syncs), f"{arm}: host syncs in the step: {syncs}")
        stats_ok = all(bool(torch.isfinite(s).all()) for s in state.batch_stats.values())
        moved = sum(not torch.equal(s, init_stats[n]) for n, s in state.batch_stats.items())
        _check(stats_ok and moved == len(init_stats) == 38,
               f"{arm}: running statistics finite {stats_ok}, moved {moved} of {len(init_stats)}")
        rel_volume = float(wire.rel_volume())
        _check(0.0 < rel_volume < 1.0, f"{arm}: rel_volume {rel_volume}")
        _check(ex.payload_bytes() == RESNET_PAYLOAD_BYTES[arm], f"{arm}: payload_bytes {ex.payload_bytes()}")
        res = {
            "losses": losses, "cpu_ref_loss0": ref_loss, "params": n_params,
            "step_ms_median": statistics.median(dev_ms[1:]) if steps > 1 else dev_ms[0],
            "step_ms_first": dev_ms[0], "step_ms_all": dev_ms, "host_step_ms_all": host_ms,
            "rel_volume": rel_volume, "payload_bytes": ex.payload_bytes(), "launches": launches,
            "sync_calls_per_step": [len(x) for x in syncs], "sync_call_sites": sorted({m for x in syncs for m in x}),
            "compressed_leaves": sum(c.compressed for c in ex.codecs.values()), "stats_moved": moved,
        }
        if qsgd:
            # the kernel against its plain version on this arm's own table:
            # 19 segments of 20..368 values, every bucket partial
            segs = _main_path_table(ex, seed=19)
            got, ref = _encode_on_card_and_cpu(segs, ex.fused_nbytes, cfg.quantum_num, cfg.bucket_size)
            res["qsgd_table_max_abs_err"] = _check_rows(got, ref, segs, cfg.bucket_size, cfg.quantum_num,
                                                        f"the {arm} table")
            res["qsgd_segments"] = len(segs)
            _check(len(segs) == 19, f"{arm}: {len(segs)} QSGD segments")
            # its device time on this table beside the table's bytes bound
            out = torch.zeros(ex.fused_nbytes, dtype=torch.uint8, device="cuda")
            res["qsgd_table_device_ms"], _ = _device_ms(
                lambda: qsgd_encode_rows(segs, out, quantum_num=cfg.quantum_num, bucket_size=cfg.bucket_size,
                                         device="cuda"), 200, "qsgd_encode_rows_kernel")
            live = sum(seg.values.shape[0] for seg in segs)
            buckets = sum(num_buckets(seg.values.shape[0], cfg.bucket_size) for seg in segs)
            nbytes = 4 * live + buckets * (cfg.bucket_size + 4)  # read each value, write each row byte
            res["qsgd_table_bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
        else:
            res["largest_leaf_card_vs_cpu"] = _resnet_codec_card_vs_cpu(cfg, seed)
        res["codec_times"] = _resnet_codec_times(cfg, ex, seed)
        if profile:
            batch = (images[0], labels[0])
            prof = _profile_step(lambda: trainer.step(state, batch))
            res["profile"] = prof
        print(f"phase 8 ok: {arm} " + json.dumps(res), flush=True)
        results[arm] = res
        del trainer, state
        torch.cuda.empty_cache()
    return results


def _route_card_vs_cpu(trainer, state, batch) -> dict:
    """One step's compensated full-width gradient (a probe copy of the model
    at the trainer's state) through the arm's route on the card (the
    trainer's exchanger, over the NCCL group) and on the CPU (an exchanger
    without a group) under the same Philox streams: the mean, the
    own-transmitted tensor, the observables and the quantized levels bitwise
    equal. Returns the comparison's summary and the qar path's padded input."""
    import copy

    import torch

    from deepreduce_tpu_torch import GradientExchanger, memory, qar, sparse_rs
    from deepreduce_tpu_torch.train import classification_loss

    ex, cfg = trainer.exchanger, trainer.cfg
    probe = copy.deepcopy(trainer.model)
    classification_loss(probe)(batch).backward()
    grads = {n: p.grad for n, p in probe.flax_params().items()}
    comp = grads
    if state.residuals is not None:
        comp = memory.compensate(grads, state.residuals, beta=cfg.beta, gamma=cfg.gamma)
    flat = ex._flatten(comp)
    cpu_ex = GradientExchanger(ex.shapes, cfg, device="cpu")
    outs = {}
    for dev, e in (("cuda", ex), ("cpu", cpu_ex)):
        x = flat.to(dev)
        collect = {}
        mean, own, _ = e.route_flat(x, step=state.step, collect=collect)
        out = {"mean": mean, **collect}
        if own is not None:
            out["own"] = own
        # the route's quantized levels, from its own stream
        if cfg.communicator == "qar":
            padded = torch.zeros(qar.pad_len(e.d, 1, cfg.bucket_size), device=dev)
            padded[: e.d] = x
            out["levels"], out["norms"] = qar.bucket_quantize(
                padded, cfg.quantum_num, cfg.bucket_size, e.stream(qar.STREAM_PHASE1, state.step))
            out["padded"] = padded
        elif cfg.rs_mode == "quantized":
            padded = torch.zeros(sparse_rs.padded_shard(e.d, 1, cfg.rs_block_size), device=dev)
            padded[: e.d] = x
            out["levels"], out["norms"] = qar.bucket_quantize(
                padded, sparse_rs.quantized_levels_budget(1), cfg.rs_block_size,
                e.stream(sparse_rs.STREAM_QUANTIZED, state.step))
        outs[dev] = out
    torch.cuda.synchronize()
    for key, ref in outs["cpu"].items():
        got = outs["cuda"][key].cpu()
        diff = float((got.double() - ref.double()).abs().max()) if got.numel() else 0.0
        _check(torch.equal(got, ref), f"{cfg.communicator}/{cfg.rs_mode}: {key} differs between the card and the "
                                      f"CPU (max |diff| {diff})")
    mean = outs["cpu"]["mean"]
    res = {
        "bitwise_equal": sorted(k for k in outs["cpu"] if k != "padded"), "d": int(mean.numel()),
        "mean_nonzero": int((mean != 0).sum()),
    }
    if "levels" in outs["cpu"]:
        lv = outs["cpu"]["levels"]
        res.update(levels=int(lv.numel()), levels_nonzero=int((lv != 0).sum()), max_abs_level=int(lv.abs().max()))
    return res, outs["cuda"].get("padded")


def _quantize_on_path(padded, cfg, stream) -> dict:
    """qsgd_quantize on the qar path's own input (the padded gradient and its
    bucket scale): bitwise equal to its plain version on the card, and its
    device and host times beside the bytes bound. Its 36 MB of traffic fit
    the 50 MB L2, so back-to-back launches read from the cache; `ms` is
    timed with a 64 MiB write between launches, which evicts them, and
    `warm_ms` without."""
    import torch

    from deepreduce_tpu_torch.ops import (
        bucket_norms_ordered, philox_uniforms_plain, quantize_levels, quantize_levels_plain, scale_from_norms)

    n, bs = padded.numel(), cfg.bucket_size
    _check(n == QAR_N, f"the qar path quantizes {n} elements, expected {QAR_N}")
    scale = scale_from_norms(bucket_norms_ordered(padded, bs), cfg.quantum_num)[:, None].expand(-1, bs).reshape(-1)
    kernel = lambda: quantize_levels(padded, scale, *stream, device=padded.device)
    plain = lambda: quantize_levels_plain(padded, scale, philox_uniforms_plain(n, *stream, device=padded.device))
    got, ref = kernel(), plain()
    torch.cuda.synchronize()
    err = float((got.int() - ref.int()).abs().max())
    _check(torch.equal(got, ref), f"qsgd_quantize != plain on the qar path's input (max |diff| {err})")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=padded.device)
    ms, per_call = _device_ms(lambda: (flush.zero_(), kernel()), 100, "qsgd_quantize_kernel")
    warm_ms, _ = _device_ms(kernel, 200, "qsgd_quantize_kernel")
    plain_ms, plain_launches = _device_ms(plain, 10)
    _check(ms > 0 and plain_ms > 0, "the profiler saw no device time")
    bytes_bound = QSGD_BYTES_PER_ELEM * n / HBM_BYTES_PER_S
    ops_bound = QSGD_F32_OPS_PER_ELEM * n / F32_OPS_PER_S
    return {
        "n": n, "max_abs_err": err, "levels_nonzero": int((got != 0).sum()), "ms": ms, "warm_ms": warm_ms,
        "profiled_kernels_per_call": per_call, "plain_ms": plain_ms, "plain_launches": plain_launches,
        "host_ms": _host_ms(kernel, 200), "plain_host_ms": _host_ms(plain, 10),
        "bound_ms": max(bytes_bound, ops_bound) * 1e3,
        "bound_by": "bytes" if bytes_bound >= ops_bound else "operations",
    }


def phase_in_collective(seed: int, tokens, group, ref_loss: float, profile: bool = False):
    """Phase 9: the in-collective communicators through `Trainer.step`.
    Returns ({arm: result}, qsgd_quantize's measurement on the qar path)."""
    import torch

    from deepreduce_tpu_torch import Trainer, qar
    from deepreduce_tpu_torch.models import WordLSTM
    from deepreduce_tpu_torch.ops import launch_counts, reset_launch_counts

    tokens = tokens[:ARM_STEPS].cuda()
    batches = lambda i: (tokens[i, :, :-1], tokens[i, :, 1:])
    results, quantize = {}, None
    for arm, (knobs, payload, per_step) in IN_COLLECTIVE.items():
        cfg = _flagship_cfg(seed, **knobs)
        trainer = Trainer(WordLSTM(seed=seed), cfg, lr=0.1, momentum=0.9, device="cuda", group=group)
        state = trainer.init_state()
        ex = trainer.exchanger
        torch.cuda.synchronize()
        reset_launch_counts()
        collects = []
        state, losses, dev_ms, host_ms, wire, sync_calls = _run_steps(trainer, state, batches, ARM_STEPS, collects)
        launches = launch_counts()
        expected = {"qsgd_quantize": per_step * ARM_STEPS, "qsgd_encode_rows": 0}
        _check(launches == expected, f"{arm}: kernel launches {launches}, expected {expected}")
        _check_trained(state, losses, ref_loss, arm)
        _check(not any(sync_calls), f"{arm}: host syncs in the step: {sync_calls}")
        rel_volume = float(wire.rel_volume())
        _check(0.0 < rel_volume < 1.0, f"{arm}: rel_volume {rel_volume}")
        _check(ex.payload_bytes() == payload, f"{arm}: payload_bytes {ex.payload_bytes()}, expected {payload}")
        observables = [{k: float(v) for k, v in c.items()} for c in collects]
        if arm == "rs_adaptive":
            _check(all(o["rs_dense_switches"] == 1.0 for o in observables), f"{arm}: {observables}")
        res = {
            "losses": losses, "step_ms_all": dev_ms, "step_ms_median": statistics.median(dev_ms),
            "host_step_ms_all": host_ms, "rel_volume": rel_volume, "payload_bytes": ex.payload_bytes(),
            "launches": launches, "sync_calls_per_step": [len(x) for x in sync_calls],
            "observables": observables, "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        }
        res["card_vs_cpu"], padded = _route_card_vs_cpu(trainer, state, batches(0))
        if arm == "qar":
            quantize = _quantize_on_path(padded, cfg, ex.stream(qar.STREAM_PHASE1, state.step))
            res["qsgd_quantize_on_path"] = quantize
        if profile:
            prof = _profile_step(lambda: trainer.step(state, batches(0)))
            res["profile"] = prof
        print(f"phase 9 ok: {arm} " + json.dumps(res), flush=True)
        results[arm] = res
        del trainer, state
        torch.cuda.empty_cache()
    return results, quantize


def _exchange_card_vs_cpu(trainer, state, batch, exact: bool, atol: float = DECODE_ATOL) -> dict:
    """One step's gradient (a probe copy of the model at the trainer's
    state) through the arm's exchange on the card (the trainer's exchanger,
    over the NCCL group) and on the CPU (an exchanger without a group) from
    the same compensated gradient and Philox streams: the aggregate and the
    new residuals bitwise equal when `exact`, else (a fit solves another LU
    on the card, a sketch adds its columns in another order) within `atol`
    of the largest compensated magnitude, with the same selection: the
    fits' aggregates nonzero at the same places, the count sketch's codecs
    choosing the same indices (its estimate can cancel to exactly 0 in one
    order of adds and not in the other, so its zeros are not its
    selection)."""
    import copy

    import torch

    from deepreduce_tpu_torch import GradientExchanger
    from deepreduce_tpu_torch.train import classification_loss

    ex = trainer.exchanger
    probe = copy.deepcopy(trainer.model)
    classification_loss(probe)(batch).backward()
    grads = {n: p.grad for n, p in probe.flax_params().items()}
    cpu_ex = GradientExchanger(ex.shapes, trainer.cfg, device="cpu")
    outs = {}
    for dev, e in (("cuda", ex), ("cpu", cpu_ex)):
        g = {n: t.to(dev) for n, t in grads.items()}
        r = None if state.residuals is None else {n: t.to(dev) for n, t in state.residuals.items()}
        agg, res, _ = e.exchange(g, r, step=state.step)
        outs[dev] = {**{f"agg/{n}": t for n, t in agg.items()}, **{f"res/{n}": t for n, t in (res or {}).items()}}
    torch.cuda.synchronize()
    comp = {n: grads[n].cpu() + (0.0 if state.residuals is None else state.residuals[n].cpu()) for n in grads}
    vmax = max(float(comp[n].abs().max()) for n in grads)
    sketch = trainer.cfg.value == "countsketch"
    if sketch:
        for n, codec in cpu_ex.codecs.items():
            if codec.compressed:
                on_card = ex.codecs[n].sparsify(comp[n].cuda()).indices.cpu()
                _check(torch.equal(on_card, codec.sparsify(comp[n]).indices), f"{n}: the card selects other indices")
    err, zeros_differ = 0.0, 0
    for key, ref in outs["cpu"].items():
        got = outs["cuda"][key].cpu()
        diff = float((got - ref).abs().max())
        err = max(err, diff)
        zeros_differ += int(((got != 0) != (ref != 0)).sum()) if key.startswith("agg/") else 0
        if exact:
            _check(torch.equal(got, ref), f"{key} differs between the card and the CPU (max |diff| {diff})")
        else:
            _check(sketch or key.startswith("res/") or torch.equal(got != 0, ref != 0), f"{key}: nonzeros differ")
            _check(diff <= atol * vmax, f"{key} differs by {diff} between the card and the CPU")
    return {"tensors": len(outs["cpu"]), "bitwise": exact, "atol_over_max": None if exact else atol, "max_abs_err": err,
            "max_abs_err_over_max": err / vmax if vmax else 0.0, "agg_zeros_differ": zeros_differ,
            "agg_nonzero": sum(int((t != 0).sum()) for k, t in outs["cpu"].items() if k.startswith("agg/"))}


def _schedules_agree(seed: int, cfgs: dict, batch, group) -> dict:
    """One training step from the same weights and batch under each named
    config: the parameters and residuals bitwise equal to the first's."""
    import torch

    from deepreduce_tpu_torch import Trainer
    from deepreduce_tpu_torch.models import WordLSTM

    after = {}
    for name, cfg in cfgs.items():
        trainer = Trainer(WordLSTM(seed=seed), cfg, lr=0.1, momentum=0.9, device="cuda", group=group)
        state, _, _ = trainer.step(trainer.init_state(), batch)
        after[name] = {**{f"param/{n}": p.detach().clone() for n, p in state.params.items()},
                       **{f"res/{n}": r for n, r in state.residuals.items()}}
        del trainer, state
    first, *rest = after
    for name in rest:
        for key, ref in after[first].items():
            diff = float((after[name][key] - ref).abs().max())
            _check(torch.equal(after[name][key], ref), f"{name} != {first} after one step: {key} (max |diff| {diff})")
    return {"bitwise_equal": list(after), "tensors": len(after[first])}


def phase_bucketed(seed: int, tokens, group, ref_loss: float, profile: bool = False) -> dict:
    """Phase 10: the bucketed exchange (pipelined), the streamed one and the
    bucketed quick start through `Trainer.step`."""
    import dataclasses

    import torch

    from deepreduce_tpu_torch import DeepReduceConfig, Trainer
    from deepreduce_tpu_torch.models import ResNet20, WordLSTM
    from deepreduce_tpu_torch.ops import launch_counts, reset_launch_counts
    from deepreduce_tpu_torch.sparse import host_branch
    from deepreduce_tpu_torch.train import classification_loss

    tokens = tokens[:ARM_STEPS].cuda()
    images, labels = _images(seed, ARM_STEPS)
    with torch.no_grad():
        resnet_ref = float(classification_loss(ResNet20(seed=seed))((images[0], labels[0])))
    images, labels = images.cuda(), labels.cuda()
    batches = {"wordlstm": lambda i: (tokens[i, :, :-1], tokens[i, :, 1:]), "resnet20": lambda i: (images[i], labels[i])}
    results = {}
    for arm, (model_name, knobs, num_buckets, per_step, payload) in BUCKETED.items():
        if model_name == "wordlstm":
            cfg, model, ref = _flagship_cfg(seed, **knobs), WordLSTM(seed=seed), ref_loss
        else:
            cfg, model, ref = DeepReduceConfig(**{**QUICKSTART, **knobs}, seed=seed), ResNet20(seed=seed), resnet_ref
        trainer = Trainer(model, cfg, lr=0.1, momentum=0.9, device="cuda", group=group)
        state = trainer.init_state()
        ex = trainer.exchanger
        _check(ex.num_buckets == num_buckets, f"{arm}: {ex.num_buckets} buckets, expected {num_buckets}")
        _check((trainer.streaming is not None) == cfg.stream_exchange, f"{arm}: the streamed branch is not taken")
        torch.cuda.synchronize()
        reset_launch_counts()
        host_branch.syncs = 0
        state, losses, dev_ms, host_ms, wire, sync_calls = _run_steps(trainer, state, batches[model_name], ARM_STEPS)
        launches = launch_counts()
        expected = {"qsgd_quantize": 0, "qsgd_encode_rows": per_step * ARM_STEPS}
        _check(launches == expected, f"{arm}: kernel launches {launches}, expected {expected}")
        _check_trained(state, losses, ref, arm)
        _check(not any(sync_calls) and host_branch.syncs == 0, f"{arm}: host syncs in the step: {sync_calls}")
        rel_volume = float(wire.rel_volume())
        _check(0.0 < rel_volume < 1.0, f"{arm}: rel_volume {rel_volume}")
        _check(ex.payload_bytes() == payload, f"{arm}: payload_bytes {ex.payload_bytes()}, expected {payload}")
        res = {
            "losses": losses, "step_ms_all": dev_ms, "step_ms_median": statistics.median(dev_ms),
            "host_step_ms_all": host_ms, "rel_volume": rel_volume, "payload_bytes": ex.payload_bytes(),
            "buckets": [[s.label, len(s.names), s.total] for s in ex.bucket_specs], "launches": launches,
            "sync_calls_per_step": [len(x) for x in sync_calls], "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        }
        res["card_vs_cpu"] = _exchange_card_vs_cpu(trainer, state, batches[model_name](0), exact=cfg.value == "qsgd")
        if per_step:
            # the kernel against its plain version on this arm's own table
            segs = _main_path_table(ex, seed=23)
            got, ref_rows = _encode_on_card_and_cpu(segs, ex.fused_nbytes, cfg.quantum_num, cfg.bucket_size)
            res["qsgd_table_max_abs_err"] = _check_rows(got, ref_rows, segs, cfg.bucket_size, cfg.quantum_num,
                                                        f"the {arm} table")
            res["qsgd_segments"] = len(segs)
        if model_name == "wordlstm":
            # the schedules: pipelined = barrier; streamed = barrier on the same partition
            other = dataclasses.replace(cfg, bucket_pipeline=False, stream_exchange=False)
            res["schedules"] = _schedules_agree(seed, {arm: cfg, "barrier": other}, batches[model_name](0), group)
        if profile:
            prof = _profile_step(lambda: trainer.step(state, batches[model_name](0)))
            res["profile"] = {k: prof[k] for k in ("wall_ms", "device_busy_ms", "device_idle_share", "kernel_launches")}
        print(f"phase 10 ok: {arm} " + json.dumps(res), flush=True)
        results[arm] = res
        del trainer, state
        torch.cuda.empty_cache()
    return results


def _embed_filters(seed: int) -> dict:
    """The Embed_0-sized gradient's top-k 0.1 filter at fpr 0.02 under the
    mod, hash and classic layouts: `measured_fpr` on the card, equal to the
    CPU's."""
    import torch

    from deepreduce_tpu_torch.codecs import bloom
    from deepreduce_tpu_torch.sparse import topk

    g = _embed_grad(seed).reshape(-1)
    out = {}
    for layout, blocked in (("mod", "mod"), ("hash", "hash"), ("classic", False)):
        fprs = []
        for dev in ("cuda", "cpu"):
            x = g.to(dev)
            sp = topk(x, 0.1)
            meta = bloom.BloomMeta.create(sp.k, x.numel(), fpr=0.02, policy="p0", blocked=blocked)
            payload = bloom.encode(sp, x, meta)
            fprs.append(bloom.measured_fpr(sp, payload.words, meta).cpu())
        _check(torch.equal(fprs[0], fprs[1]), f"{layout}: measured_fpr {float(fprs[0])} on the card, {float(fprs[1])}")
        out[layout] = {"measured_fpr": float(fprs[0]), "m_bits": meta.m_bits, "num_hash": meta.num_hash,
                       "target_fpr": meta.fpr}
    return out


def _natural_sparsity(trainer, batch, cfg) -> dict:
    """Embed_0's natural sparsity and threshold overflow in one step's
    gradient (a probe copy of the model): at most one row per token of the
    batch touched, every nonzero inside the budget."""
    import copy

    from deepreduce_tpu_torch.sparse import natural_sparsity, threshold_overflow
    from deepreduce_tpu_torch.train import classification_loss

    probe = copy.deepcopy(trainer.model)
    classification_loss(probe)(batch).backward()
    g = probe.flax_params()["Embed_0/embedding"].grad
    rows = int((g != 0).any(dim=1).sum())
    sparsity = float(natural_sparsity(g, cfg.threshold_val))
    overflow = int(threshold_overflow(g, cfg.threshold_val, budget_ratio=cfg.compress_ratio))
    _check(rows <= batch[0].numel() and sparsity <= cfg.compress_ratio and overflow == 0,
           f"Embed_0: {rows} rows touched, natural sparsity {sparsity}, overflow {overflow}")
    return {"rows_touched": rows, "rows": g.shape[0], "natural_sparsity": sparsity, "threshold_overflow": overflow}


def phase_zoo(seed: int, tokens, group, ref_loss: float, profile: bool = False) -> dict:
    """Phase 11: the codec zoo through `Trainer.step`, 3 steps per arm."""
    import torch

    from deepreduce_tpu_torch import DeepReduceConfig, Trainer
    from deepreduce_tpu_torch.models import ResNet20, WordLSTM
    from deepreduce_tpu_torch.ops import launch_counts, reset_launch_counts
    from deepreduce_tpu_torch.sparse import host_branch
    from deepreduce_tpu_torch.train import classification_loss

    tokens = tokens[:ARM_STEPS].cuda()
    images, labels = _images(seed, ARM_STEPS)
    with torch.no_grad():
        resnet_ref = float(classification_loss(ResNet20(seed=seed))((images[0], labels[0])))
    images, labels = images.cuda(), labels.cuda()
    batches = {"wordlstm": lambda i: (tokens[i, :, :-1], tokens[i, :, 1:]), "resnet20": lambda i: (images[i], labels[i])}
    results = {}
    for arm, (model_name, knobs, per_step, payload, card_cpu) in ZOO.items():
        if model_name == "wordlstm":
            cfg, model, ref = _flagship_cfg(seed, **knobs), WordLSTM(seed=seed), ref_loss
        else:
            cfg, model, ref = DeepReduceConfig(**{**QUICKSTART, **knobs}, seed=seed), ResNet20(seed=seed), resnet_ref
        trainer = Trainer(model, cfg, lr=0.1, momentum=0.9, device="cuda", group=group)
        state = trainer.init_state()
        ex = trainer.exchanger
        torch.cuda.synchronize()
        reset_launch_counts()
        host_branch.syncs = 0
        state, losses, dev_ms, host_ms, wire, sync_calls = _run_steps(trainer, state, batches[model_name], ARM_STEPS)
        launches = launch_counts()
        expected = {"qsgd_quantize": 0, "qsgd_encode_rows": per_step * ARM_STEPS}
        _check(launches == expected, f"{arm}: kernel launches {launches}, expected {expected}")
        _check_trained(state, losses, ref, arm)
        _check(not any(sync_calls) and host_branch.syncs == 0, f"{arm}: host syncs in the step: {sync_calls}")
        rel_volume = float(wire.rel_volume())
        _check(0.0 < rel_volume < 1.0, f"{arm}: rel_volume {rel_volume}")
        _check(ex.payload_bytes() == payload, f"{arm}: payload_bytes {ex.payload_bytes()}, expected {payload}")
        res = {
            "losses": losses, "step_ms_all": dev_ms, "step_ms_median": statistics.median(dev_ms),
            "host_step_ms_all": host_ms, "rel_volume": rel_volume, "payload_bytes": ex.payload_bytes(),
            "launches": launches, "qsgd_encode_rows_per_step": launches["qsgd_encode_rows"] / ARM_STEPS,
            "host_syncs_per_step": [len(x) for x in sync_calls],
            "compressed_leaves": sum(c.compressed for c in ex.codecs.values()),
            "dense_leaves": sum(c.dense_fallback for c in ex.codecs.values()),
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        }
        exact = card_cpu == "bitwise"
        res["card_vs_cpu"] = _exchange_card_vs_cpu(trainer, state, batches[model_name](0), exact,
                                                   atol=0.0 if exact else card_cpu)
        if per_step:
            # the kernel against its plain version on this arm's own table
            segs = _main_path_table(ex, seed=29)
            got, ref_rows = _encode_on_card_and_cpu(segs, ex.fused_nbytes, cfg.quantum_num, cfg.bucket_size)
            res["qsgd_table_max_abs_err"] = _check_rows(got, ref_rows, segs, cfg.bucket_size, cfg.quantum_num,
                                                        f"the {arm} table")
            res["qsgd_segments"] = len(segs)
        if arm == "threshold_bloom_qsgd":
            res["embed_0"] = _natural_sparsity(trainer, batches[model_name](0), cfg)
        if profile:
            prof = _profile_step(lambda: trainer.step(state, batches[model_name](0)))
            res["profile"] = {k: prof[k] for k in ("wall_ms", "device_busy_ms", "device_idle_share", "kernel_launches")}
        print(f"phase 11 ok: {arm} " + json.dumps(res), flush=True)
        results[arm] = res
        del trainer, state
        torch.cuda.empty_cache()
    table = {name: _codec_times(_flagship_cfg(seed, **knobs)) for name, knobs in ZOO_CODEC_TABLE.items()}
    print("phase 11 ok: codec table " + json.dumps(table), flush=True)
    print("phase 11 ok: Embed_0 filters " + json.dumps(_embed_filters(seed)), flush=True)
    return results


def _f32_sum(x: float, n: int) -> float:
    """x added n times from 0 in float32: the cohort's wire sum."""
    import numpy as np

    acc = np.float32(0)
    for _ in range(n):
        acc = np.float32(acc + np.float32(x))
    return float(acc)


def _check_fed_wire(arm: str, out: dict, clients: int) -> dict:
    """The round's per-direction wire against FEDAVG_WIRE: index and dense
    bits exactly, value bits within [least, most] (C2S: C trees summed)."""
    idx, dense, lo, hi = FEDAVG_WIRE[arm]
    got = {}
    for direction, n in (("s2c", 1), ("c2s", clients)):
        w = out[f"wire_{direction}"]
        bits = {f: float(getattr(w, f)) for f in ("index_bits", "value_bits", "dense_bits", "saturated")}
        want_idx, want_dense = _f32_sum(idx, n), _f32_sum(dense, n)
        _check(bits["index_bits"] == want_idx and bits["dense_bits"] == want_dense,
               f"{arm} {direction}: index / dense bits {bits['index_bits']} / {bits['dense_bits']}, "
               f"expected {want_idx} / {want_dense}")
        _check(n * lo * (1 - 1e-5) <= bits["value_bits"] <= n * hi * (1 + 1e-5),
               f"{arm} {direction}: value bits {bits['value_bits']} outside [{n * lo}, {n * hi}]")
        got[direction] = bits
    rel = float(out["rel_volume"])
    if lo == dense:
        _check(rel == 1.0, f"{arm}: rel_volume {rel}, expected 1.0")
    else:
        _check(0.0 < rel < 1.0, f"{arm}: rel_volume {rel}")
    got["rel_volume"] = rel
    return got


def _fed_model(name: str, seed: int):
    """(model on the card, loss_fn(params, batch), batch maker(rounds, C, E, gen))."""
    import torch
    import torch.nn.functional as F

    from deepreduce_tpu_torch.models import MobileNetV1, WordLSTM

    if name == "mobilenet":
        model = MobileNetV1(seed=seed).cuda().train()

        def loss_fn(p, b):
            return F.cross_entropy(model.functional(p, b[0]), b[1])

        def batches(spec, gen):
            # class prototypes plus noise 2.5, benchmarks/mobilenet_table5.py's task
            c, e, bsz = spec["clients"][1], spec["local_steps"], spec["batch"]
            protos = torch.randn(10, 32, 32, 3, device="cuda", generator=gen)
            out = []
            for _ in range(spec["rounds"] + 1):
                y = torch.randint(0, 10, (c, e, bsz), device="cuda", generator=gen)
                out.append((protos[y] + 2.5 * torch.randn(c, e, bsz, 32, 32, 3, device="cuda", generator=gen), y))
            return out
    else:
        model = WordLSTM(seed=seed).cuda().train()
        vocab = model.vocab_size

        def loss_fn(p, b):
            logits = model.functional(p, b[0])
            return F.cross_entropy(logits.reshape(-1, vocab), b[1].reshape(-1))

        def batches(spec, gen):
            c, e, bsz = spec["clients"][1], spec["local_steps"], spec["batch"]
            out = []
            for _ in range(spec["rounds"] + 1):
                t = torch.randint(0, vocab, (c, e, bsz, spec["seq"] + 1), device="cuda", generator=gen)
                out.append((t[..., :-1], t[..., 1:]))
            return out
    return model, loss_fn, batches


def _fed_round(fa, state, ids, batch):
    """One FedAvg round under torch's sync debug mode: (state, out, device
    ms from CUDA events, host ms, the file:line of each host sync)."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    (state, out), syncs = _counting_syncs(lambda: fa.run_round(state, ids, batch))
    end.record()
    end.synchronize()
    return state, out, start.elapsed_time(end), (time.perf_counter() - t0) * 1e3, syncs


def _group_rows_vs_plain(units, nbytes: int, step: int, worker: int, what: str) -> dict:
    """The main path's grouped encode (`wrappers.encode_group`) of `units` on
    the card, its rows held bitwise against the plain version on the same
    segment table."""
    import torch

    from deepreduce_tpu_torch.wrappers import encode_group

    rows = torch.zeros(nbytes, dtype=torch.uint8, device="cuda")
    _, segs = encode_group(units, rows, step=step, worker=worker)
    torch.cuda.synchronize()
    err = 0.0
    if segs:
        meta = next(codec.val_codec.meta for _, codec, _, _ in units if codec.rows_leaf is not None)
        err = _check_rows(rows.cpu(), _plain_rows(segs, nbytes, meta.quantum_num, meta.bucket_size), segs,
                          meta.bucket_size, meta.quantum_num, what)
    return {"segments": len(segs), "values": sum(s.values.numel() for s in segs), "max_abs_err": err}


def _fed_card_vs_cpu(fa, state, batch, cfg) -> dict:
    """One round's S2C tree (the delta params - w_ref) and client 0's C2S
    tree (its update from w_ref, with its residual) through `compress_tree`
    on the card and on the CPU: decoded trees, residuals and wire bitwise;
    then each tree's grouped QSGD rows against the plain version."""
    import torch

    from deepreduce_tpu_torch import TreeCodec
    from deepreduce_tpu_torch.fedsim.round import index_batch, tree_sub

    delta = tree_sub(state.params, state.w_ref)
    update = tree_sub(fa._local_train(state.w_ref, index_batch(batch, 0)), state.w_ref)
    residual = None if state.c2s_residuals is None else {n: r[0] for n, r in state.c2s_residuals.items()}
    cpu = lambda t: None if t is None else {n: x.cpu() for n, x in t.items()}
    res = {}
    for direction, tree, r, worker in (("s2c", delta, None, 0), ("c2s", update, residual, 0)):
        tc = TreeCodec(direction, cfg, device="cuda")
        card = tc.compress_tree(tree, r, step=state.round, worker=worker)
        host = TreeCodec(direction, cfg, device="cpu").compress_tree(cpu(tree), cpu(r), step=state.round,
                                                                     worker=worker)
        torch.cuda.synchronize()
        for what, a, b in (("decoded", card[0], host[0]), ("residual", card[1], host[1])):
            if a is None:
                continue
            diff = [n for n in a if not torch.equal(a[n].cpu(), b[n])]
            _check(not diff, f"{direction} {what} card != CPU at {diff[:5]}")
        for f in ("index_bits", "value_bits", "dense_bits", "saturated"):
            _check(float(getattr(card[2], f)) == float(getattr(host[2], f)), f"{direction} wire {f}: card != CPU")
        _, _, units, nbytes = tc.group(tree, r)
        rows = _group_rows_vs_plain(units, nbytes, state.round, worker, f"the {direction} tree")
        res[direction] = {"bitwise": True, "moved": sum(int((d != 0).sum()) for d in card[0].values()),
                          "qsgd_rows": rows}
    return res


def phase_fedavg(seed: int, profile: bool = False) -> dict:
    """Phase 12: compressed FedAvg on the card, `FedAvg.run_round` per arm."""
    import torch

    from deepreduce_tpu_torch import DeepReduceConfig, FedAvg, FedConfig
    from deepreduce_tpu_torch.fedsim.round import index_batch
    from deepreduce_tpu_torch.ops import launch_counts, reset_launch_counts

    results = {}
    for arm, spec in FEDAVG.items():
        model, loss_fn, make_batches = _fed_model(spec["model"], seed)
        params = {n: p.detach() for n, p in model.flax_params().items()}
        n_params = sum(p.numel() for p in params.values())
        cfg = DeepReduceConfig(**spec["knobs"], seed=seed)
        n_clients, per_round = spec["clients"]
        fa = FedAvg(loss_fn, cfg, FedConfig(n_clients, per_round, local_steps=spec["local_steps"]),
                    spec["lr"], spec["momentum"], device="cuda")
        state = fa.init(params)
        gen = torch.Generator(device="cuda").manual_seed(seed + 12)
        batches = make_batches(spec, gen)
        id_gen = torch.Generator().manual_seed(seed + 12)
        probe = index_batch(index_batch(batches[-1], 0), 0)  # a batch no round trains on
        with torch.no_grad():
            loss0 = float(loss_fn(state.params, probe))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        rounds, card_cpu = [], None
        for r in range(spec["rounds"]):
            ids = fa.sample_clients(state, id_gen)
            state, out, dev_ms, host_ms, syncs = _fed_round(fa, state, ids, batches[r])
            rounds.append({"ms": dev_ms, "host_ms": host_ms, "syncs": syncs, "wire": _check_fed_wire(arm, out, per_round)})
        launches = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        qsgd = cfg.deepreduce is not None
        expected = {"qsgd_quantize": 0, "qsgd_encode_rows": spec["rounds"] * (1 + per_round) if qsgd else 0}
        _check(launches == expected, f"{arm}: kernel launches {launches}, expected {expected}")
        _check(all(bool(torch.isfinite(p).all()) for p in state.params.values()), f"{arm}: non-finite parameters")
        with torch.no_grad():
            loss_end = float(loss_fn(state.params, probe))
        _check(math.isfinite(loss0) and math.isfinite(loss_end), f"{arm}: loss {loss0} -> {loss_end}")
        res = {
            "params": n_params, "clients": spec["clients"], "rounds": spec["rounds"],
            "round_ms_all": [x["ms"] for x in rounds], "round_ms_median": statistics.median(x["ms"] for x in rounds),
            "host_round_ms_all": [x["host_ms"] for x in rounds], "loss_before": loss0, "loss_after": loss_end,
            "wire_by_round": [x["wire"] for x in rounds], "launches": launches,
            "host_syncs_per_round": [len(x["syncs"]) for x in rounds],
            "sync_call_sites": sorted({m for x in rounds for m in x["syncs"]}), "peak_mem_bytes": peak,
        }
        if qsgd:
            res["card_vs_cpu"] = _fed_card_vs_cpu(fa, state, batches[spec["rounds"]], cfg)
        if profile:
            ids = fa.sample_clients(state, id_gen)
            prof = _profile_step(lambda: fa.run_round(state, ids, batches[spec["rounds"]]))
            res["profile"] = {k: prof[k] for k in ("wall_ms", "device_busy_ms", "device_idle_share",
                                                   "kernel_launches", "top_device_ms")}
        print(f"phase 12 ok: {arm} " + json.dumps(res), flush=True)
        results[arm] = res
        del fa, state, batches, model
        torch.cuda.empty_cache()
    return results


def phase_table6(seed: int) -> dict:
    """Phase 13: the Table-6 per-leaf encode on NeuMF at the ML-20m widths."""
    import torch

    from deepreduce_tpu_torch import DeepReduceConfig, TensorCodec
    from deepreduce_tpu_torch.models import NeuMF
    from deepreduce_tpu_torch.models.ncf import sigmoid_bce_mean
    from deepreduce_tpu_torch.ops import launch_counts, reset_launch_counts
    from deepreduce_tpu_torch.sparse import natural_sparsity, threshold_overflow

    with open(TABLE6_RECORD) as f:
        record = json.load(f)
    model = NeuMF(seed=seed).cuda()
    params = model.flax_params()
    n_params = sum(p.numel() for p in params.values())
    _check(n_params == 31_832_577, f"NeuMF has {n_params} parameters")

    def grads(batch_seed):
        users, items, labels = (torch.from_numpy(a).cuda()
                                for a in ncf_batch(batch_seed, model.num_users, model.num_items))
        for p in params.values():
            p.grad = None
        sigmoid_bce_mean(model(users, items), labels).backward()
        return {n: p.grad.detach().clone() for n, p in params.items()}

    torch.cuda.reset_peak_memory_stats()
    sample, fresh = grads(0), grads(1)
    peak = torch.cuda.max_memory_allocated()
    routed = {n: table6_route(g) for n, g in sample.items()}
    codecs = {n: TensorCodec(tuple(sample[n].shape), DeepReduceConfig(**knobs, seed=seed), name=n, device="cuda")
              for n, (_, _, knobs) in routed.items()}
    torch.cuda.synchronize()
    reset_launch_counts()
    payloads = {n: codecs[n].encode(fresh[n], step=0, worker=0) for n in sorted(fresh)}
    launches = launch_counts()
    qsgd_leaves = sum(c.rows_leaf is not None for c in codecs.values())
    expected = {"qsgd_quantize": 0, "qsgd_encode_rows": qsgd_leaves}
    _check(launches == expected, f"table 6: kernel launches {launches}, expected {expected}")
    per_leaf, total, dense = {}, 0.0, 0.0
    for n in sorted(fresh):
        route, ratio, _ = routed[n]
        stats = codecs[n].wire_stats(payloads[n])
        overflow = 0 if route == "dense_qsgd" else int(threshold_overflow(fresh[n], 0.0, budget_ratio=ratio))
        want = record["per_leaf"][n]
        per_leaf[n] = {"d": fresh[n].numel(), "natural_sparsity": float(natural_sparsity(fresh[n])),
                       "budget_ratio": ratio, "route": route, "overflow_on_fresh_batch": overflow,
                       "rel_volume": float(stats.rel_volume()), "record_rel_volume": want["rel_volume"]}
        _check(route == want["route"], f"table 6 {n}: route {route}, the record's {want['route']}")
        decoded = codecs[n].decode(payloads[n])
        _check(bool(torch.isfinite(decoded).all()), f"table 6 {n}: non-finite decode")
        # the leaf's encode and decode on the CPU, from the same gradient
        host = TensorCodec(tuple(fresh[n].shape), codecs[n].cfg, name=n, device="cpu")
        _check(torch.equal(decoded.cpu(), host.decode(host.encode(fresh[n].cpu(), step=0, worker=0))),
               f"table 6 {n}: decode on the card != CPU")
        per_leaf[n]["decode_card_eq_cpu"] = True
        if codecs[n].rows_leaf is not None:
            # the main path's encode of this leaf, its rows against the plain version
            nbytes = codecs[n].val_codec.meta.payload_len
            per_leaf[n]["qsgd_rows"] = _group_rows_vs_plain([(n, codecs[n], fresh[n], 0)], nbytes, 0, 0,
                                                            f"table 6 {n}")
        total += float(stats.total_bits)
        dense += float(stats.dense_bits)
    rel_volume = total / dense
    total_overflow = sum(v["overflow_on_fresh_batch"] for v in per_leaf.values())
    _check(abs(rel_volume - record["rel_volume"]) <= 1e-3,
           f"table 6: rel_volume {rel_volume}, the record's {record['rel_volume']}")
    _check(total_overflow == 0, f"table 6: overflow {total_overflow}")
    times = {}
    for n in ("mf_user/embedding", "mlp_user/embedding"):
        times[n] = {"encode_ms": _events_ms(lambda: codecs[n].encode(fresh[n])),
                    "decode_ms": _events_ms(lambda: codecs[n].decode(payloads[n]))}
    res = {"params": n_params, "interactions": 1_000_000, "rel_volume": rel_volume,
           "record_rel_volume": record["rel_volume"], "total_overflow": total_overflow, "launches": launches,
           "qsgd_leaves": qsgd_leaves, "per_leaf": per_leaf, "times": times, "peak_mem_bytes": peak}
    print("phase 13 ok: table 6 " + json.dumps(res), flush=True)
    return {"ncf_table6": res}


# phase 14: the paper's remaining models at full width on one card. Each
# model's batch as benchmarks/train.py's `make_batch` draws it (numpy normal
# images and integer labels, or integer tokens, from --seed); SGD lr 0.1
# momentum 0.9 (benchmarks/train.py:402-404), exact top-k (the port rejects
# the tpu_defaults' approx_topk). model -> (constructor keyword arguments,
# batch, input: ("image", hw, classes) or ("lm", seq + 1, vocab), loss,
# forward tolerance over max |logit|, parameters, BatchNorm statistics)
MODELS14 = {
    # bench.py:272 (bf16, batch 128 on 224x224, 1000 classes). The card's
    # bf16 forward on 8 examples is held within 1e-2 of the largest logit
    # of the CPU's (an H100 read 1.7e-3, PERF.md): a bf16 output keeps 8
    # bits (a rounding moves it by up to 0.4%), cuDNN and the CPU sum in
    # other orders, and a last-bit difference compounds over 53
    # convolutions and norms
    "resnet50": (dict(dtype="bfloat16"), 128, ("image", 224, 1000), "classification", 1e-2, 25_557_032, 106),
    # benchmarks/train.py:53-56 and :67-70, batch 64 (:402)
    "densenet40": ({}, 64, ("image", 32, 10), "classification", 1e-4, 1_019_722, 78),
    "vgg16": ({}, 64, ("image", 32, 10), "classification", 1e-4, 14_986_698, 26),
    # benchmarks/train.py:112-116: sequence 128, the lm loss; batch 64
    "bert": ({}, 64, ("lm", 128, 30_522), "next_token", 1e-4, 132_363_066, 0),
}
# DRQSGD-BF-P0 (phase 5's flagship knobs) at another ratio
DRQSGD_BF_P0 = dict(
    compressor="topk", approx_topk=False, memory="residual", communicator="allgather", deepreduce="both",
    index="bloom", value="qsgd", fpr=0.02, policy="p0", bloom_blocked="mod", quantum_num=127, bucket_size=512,
)
# arm -> (model, knobs, qsgd_encode_rows launches per step, payload bytes: the
# JAX package's GradientExchanger.payload_bytes, pinned by
# tests/test_torch_models_zoo.py and tests/test_torch_bert.py, QSGD segments)
PHASE14 = {
    # bench.py:283-285
    "resnet50_dense": ("resnet50", dict(compressor="none", deepreduce=None, communicator="allreduce", memory="none"),
                       0, 102_228_128, 0),
    # bench.py:286-289: the north star, top-k 1% with the bloom index
    "resnet50_topk1_bloom": ("resnet50", dict(compressor="topk", compress_ratio=0.01, memory="residual",
                                              deepreduce="index", index="bloom", bloom_blocked="mod", fpr=0.001),
                             0, 2_335_272, 0),
    # bench.py:2599-2602 on the model's own leaves
    "resnet50_drqsgd_bloom": ("resnet50", dict(DRQSGD_BF_P0, compress_ratio=0.01, memory="none", fpr=0.001),
                              1, 1_622_736, 76),
    # BASELINE.json config 3 (top-k 1%, 'both'), phase 8's quick-start knobs
    "resnet50_quickstart": ("resnet50", QUICKSTART, 0, 943_248, 0),
    # phase 8's resnet20_drqsgd knobs
    "densenet40_drqsgd": ("densenet40", dict(QUICKSTART, value="qsgd"), 1, 40_860, 39),
    # phase 11's resnet20_polyseg knobs: PolySeg on the 13 convs
    "vgg16_polyseg": ("vgg16", dict(QUICKSTART, deepreduce="value", value="polyseg"), 0, 1_694_552, 0),
    # BASELINE.json config 5: top-k 0.1%, DRQSGD-BF-P0, residual memory
    "bert_drqsgd_bloom": ("bert", dict(DRQSGD_BF_P0, compress_ratio=0.001), 1, 3_193_592, 88),
}
CHECKPOINT_ARM = "resnet50_topk1_bloom"  # checkpointed after its second step
MODEL14_STEPS = 3


def _model14(name: str, seed: int):
    import torch

    from deepreduce_tpu_torch import models

    kwargs = {k: getattr(torch, v) if k == "dtype" else v for k, v in MODELS14[name][0].items()}
    ctor = {"resnet50": models.ResNet50, "densenet40": models.DenseNet40, "vgg16": models.VGG16,
            "bert": models.BertEncoder}[name]
    return ctor(seed=seed, **kwargs)


def _model14_batches(name: str, seed: int):
    """MODEL14_STEPS batches of `name` as benchmarks/train.py's `make_batch`
    draws them from `seed`, on the CPU."""
    import numpy as np
    import torch

    _, batch, (kind, size, classes), *_ = MODELS14[name]
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(MODEL14_STEPS):
        if kind == "image":
            x = torch.from_numpy(rng.normal(size=(batch, size, size, 3)).astype(np.float32))
            out.append((x, torch.from_numpy(rng.integers(0, classes, size=batch))))
        else:
            out.append((torch.from_numpy(rng.integers(0, classes, size=(batch, size))),))
    return out


def _loss14(name: str, model):
    from deepreduce_tpu_torch.train import classification_loss, next_token_loss

    return next_token_loss(model) if MODELS14[name][3] == "next_token" else classification_loss(model)


def _forward_card_vs_cpu(name: str, model, batch) -> dict:
    """The forward of copies of `model` (so no running statistic moves) on
    the batch's first 8 examples, on the card and on the CPU: the largest
    logit difference over the largest logit, held to the model's tolerance."""
    import copy

    import torch

    x = batch[0][:8]
    if MODELS14[name][2][0] == "lm":
        x = x[:, :-1]
    with torch.no_grad():
        ref = copy.deepcopy(model)(x)
        got = copy.deepcopy(model).cuda()(x.cuda()).cpu()
    _check(got.shape == ref.shape and bool(torch.isfinite(got).all()), f"{name}: forward on the card {tuple(got.shape)}")
    scale = float(ref.abs().max())
    err = float((got - ref).abs().max()) / scale
    tol = MODELS14[name][4]
    _check(err <= tol, f"{name}: the card's forward differs from the CPU's by {err} of max |logit| (> {tol})")
    return {"max_abs_err_over_max": err, "tolerance": tol, "logit_max": scale}


def _table_bound(segs, bs: int) -> dict:
    """The bytes of one QSGD segment table (each live value read once, each
    row byte written once) and their time at the HBM rate."""
    live, padded, buckets, nbytes = _table_bytes(segs, bs)
    return {"segments": len(segs), "live_values": live, "buckets": buckets, "bytes": nbytes,
            "bound_us": nbytes / HBM_BYTES_PER_S * 1e6}


def _state_snapshot(state) -> dict:
    """Clones of every tensor of a TrainState, by kind and name."""
    snap = {f"param/{n}": p.detach().clone() for n, p in state.params.items()}
    snap.update({f"stat/{n}": s.clone() for n, s in state.batch_stats.items()})
    snap.update({f"residual/{n}": r.clone() for n, r in (state.residuals or {}).items()})
    for i, p in enumerate(state.params.values()):
        buf = state.optimizer.state.get(p, {}).get("momentum_buffer")
        if buf is not None:
            snap[f"momentum/{i}"] = buf.clone()
    return snap


def _save_checkpoint(trainer, state, directory: str) -> dict:
    """`checkpoint.save` of `state` into `directory`, with clones of every
    saved tensor to hold the restore against."""
    from deepreduce_tpu_torch import checkpoint

    path = os.path.join(directory, "state.pt")
    t0 = time.perf_counter()
    checkpoint.save(path, state, config=trainer.cfg)
    return {"path": path, "saved": _state_snapshot(state), "step": state.step,
            "save_s": time.perf_counter() - t0, "file_bytes": os.path.getsize(path)}


def _restore_checkpoint(ckpt: dict, cfg, name: str, seed: int, group, batch) -> dict:
    """Restore `ckpt` into a fresh Trainer (other initial weights) on the
    card: every tensor and the step bitwise the saved ones; then one step
    with a finite loss."""
    import torch

    from deepreduce_tpu_torch import Trainer, checkpoint

    model = _model14(name, seed + 1)
    fresh = Trainer(model, cfg, lr=0.1, momentum=0.9, device="cuda", group=group, loss_fn=_loss14(name, model))
    t0 = time.perf_counter()
    restored = checkpoint.restore(ckpt["path"], fresh, config=cfg)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    saved, got = ckpt["saved"], _state_snapshot(restored)
    _check(got.keys() == saved.keys(), f"checkpoint: restored {len(got)} tensors, saved {len(saved)}")
    differ = [k for k in saved if not (got[k].is_cuda and torch.equal(got[k], saved[k]))]
    _check(not differ, f"checkpoint: {len(differ)} restored tensors differ from the saved ones: {differ[:5]}")
    _check(restored.step == ckpt["step"], f"checkpoint: step {restored.step}, saved {ckpt['step']}")
    restored, loss, _, syncs = _step_counting_syncs(fresh, restored, batch)
    _check(math.isfinite(float(loss)), f"checkpoint: the step after the restore has loss {float(loss)}")
    return {"tensors_bitwise": len(saved), "kinds": sorted({k.split("/")[0] for k in saved}), "step": ckpt["step"],
            "file_bytes": ckpt["file_bytes"], "save_s": ckpt["save_s"], "restore_s": restore_s,
            "loss_after_restore": float(loss), "syncs_after_restore": len(syncs)}


def phase_models(seed: int, group, profile: bool = False) -> dict:
    """Phase 14: ResNet-50 (bf16), DenseNet-40, VGG16 and BERT-base at full
    width through `Trainer.step`, MODEL14_STEPS steps per arm."""
    import torch

    from deepreduce_tpu_torch import DeepReduceConfig, Trainer
    from deepreduce_tpu_torch.ops import launch_counts, qsgd_encode_rows, reset_launch_counts
    from deepreduce_tpu_torch.sparse import host_branch

    results, cpu_batches = {}, {}
    # the checkpoint file lives only as long as the phase
    with tempfile.TemporaryDirectory() as ckpt_dir:
        for arm, (name, knobs, per_step, payload, n_segs) in PHASE14.items():
            _, batch_size, inputs, _, _, n_params, n_stats = MODELS14[name]
            model = _model14(name, seed)
            _check(sum(p.numel() for p in model.parameters()) == n_params, f"{name}: parameter count")
            if name not in cpu_batches:  # the same weights and batches in every arm of the model
                cpu_batches = {name: _model14_batches(name, seed)}
                forward = _forward_card_vs_cpu(name, model, cpu_batches[name][0])
                print(f"phase 14 ok: {name} forward card vs CPU " + json.dumps(forward), flush=True)
            batches = [tuple(t.cuda() for t in b) for b in cpu_batches[name]]
            cfg = DeepReduceConfig(**knobs, seed=seed)
            trainer = Trainer(model, cfg, lr=0.1, momentum=0.9, device="cuda", group=group, loss_fn=_loss14(name, model))
            state = trainer.init_state()
            init_stats = {n: s.clone() for n, s in state.batch_stats.items()}
            ex = trainer.exchanger
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            host_branch.syncs = 0
            if arm == CHECKPOINT_ARM:
                state, losses, dev_ms, host_ms, _, syncs = _run_steps(trainer, state, lambda i: batches[i], 2)
                ckpt = _save_checkpoint(trainer, state, ckpt_dir)
                state, more, dev3, host3, wire, syncs3 = _run_steps(trainer, state, lambda i: batches[2 + i], 1)
                losses, dev_ms, host_ms, syncs = losses + more, dev_ms + dev3, host_ms + host3, syncs + syncs3
            else:
                state, losses, dev_ms, host_ms, wire, syncs = _run_steps(trainer, state, lambda i: batches[i], MODEL14_STEPS)
            launches = launch_counts()
            peak = torch.cuda.max_memory_allocated()
            expected = {"qsgd_quantize": 0, "qsgd_encode_rows": per_step * MODEL14_STEPS}
            _check(launches == expected, f"{arm}: kernel launches {launches}, expected {expected}")
            _check(all(math.isfinite(l) for l in losses), f"{arm}: non-finite loss {losses}")
            _check(all(bool(torch.isfinite(p).all()) for p in state.params.values()), f"{arm}: non-finite parameters")
            _check(not any(syncs) and host_branch.syncs == 0, f"{arm}: host syncs in the steps: {syncs}")
            stats_ok = all(bool(torch.isfinite(s).all()) for s in state.batch_stats.values())
            moved = sum(not torch.equal(s, init_stats[n]) for n, s in state.batch_stats.items())
            _check(stats_ok and moved == len(init_stats) == n_stats,
                   f"{arm}: running statistics finite {stats_ok}, moved {moved} of {len(init_stats)} (expected {n_stats})")
            _check(ex.payload_bytes() == payload, f"{arm}: payload_bytes {ex.payload_bytes()}, expected {payload}")
            rel_volume = float(wire.rel_volume())
            _check(rel_volume == 1.0 if ex.dense else 0.0 < rel_volume < 1.0, f"{arm}: rel_volume {rel_volume}")
            median = statistics.median(dev_ms)
            per_example = batch_size * (inputs[1] - 1 if inputs[0] == "lm" else 1)
            res = {
                "losses": losses, "step_ms_median": median, "step_ms_all": dev_ms, "host_step_ms_all": host_ms,
                ("tokens_per_sec" if inputs[0] == "lm" else "images_per_sec"): per_example / (median / 1e3),
                "rel_volume": rel_volume, "payload_bytes": ex.payload_bytes(), "launches": launches,
                "qsgd_encode_rows_per_step": per_step, "host_syncs_per_step": [len(x) for x in syncs],
                "compressed_leaves": sum(c.compressed for c in ex.codecs.values()), "stats_moved": moved,
                "peak_mem_bytes": peak, "params": n_params,
            }
            if arm == CHECKPOINT_ARM:
                res["checkpoint"] = _restore_checkpoint(ckpt, cfg, name, seed, group, batches[2])
            if per_step:
                # the kernel against its plain version on this arm's own table,
                # and its device time there beside the table's bytes bound
                segs = _main_path_table(ex, seed=37)
                _check(len(segs) == n_segs, f"{arm}: {len(segs)} QSGD segments, expected {n_segs}")
                got, ref_rows = _encode_on_card_and_cpu(segs, ex.fused_nbytes, cfg.quantum_num, cfg.bucket_size)
                res["qsgd_table_max_abs_err"] = _check_rows(got, ref_rows, segs, cfg.bucket_size, cfg.quantum_num,
                                                            f"the {arm} table")
                out = torch.zeros(ex.fused_nbytes, dtype=torch.uint8, device="cuda")
                counted = qsgd_encode_rows.launches
                device_ms, _ = _device_ms(lambda: qsgd_encode_rows(segs, out, quantum_num=cfg.quantum_num,
                                                                   bucket_size=cfg.bucket_size, device="cuda"),
                                          200, "qsgd_encode_rows_kernel")
                _check(qsgd_encode_rows.launches - counted == 201, f"{arm}: {len(segs)} segments took more than one launch")
                res["qsgd_table"] = dict(_table_bound(segs, cfg.bucket_size), device_us=device_ms * 1e3)
            if profile:
                prof = _profile_step(lambda: trainer.step(state, batches[0]))
                res["profile"] = {k: prof[k] for k in ("wall_ms", "device_busy_ms", "device_idle_share", "kernel_launches",
                                                       "top_device_ms")}
            print(f"phase 14 ok: {arm} " + json.dumps(res), flush=True)
            results[arm] = res
            del trainer, state, model, batches, ex
            torch.cuda.empty_cache()
    return results


def _per_leaf_composition(segs, q: int, bs: int):
    """The QSGD encode of a worker-step as the port's first slice composed
    it, leaf by leaf: zero padding, the bucket norm (a float64 `sum`) and
    scale (`q / norm` through torch's reciprocal) broadcast to a scale
    vector, one `quantize_levels` launch, the `cat` of levels and norm bytes
    into rows, then one `cat` of every leaf's rows. The "before" of the
    fused kernel."""
    import torch

    from deepreduce_tpu_torch.ops import quantize_levels

    leaves = []
    for seg in segs:
        k = seg.values.shape[0]
        b = -(-k // bs)
        padded = torch.zeros(b * bs, dtype=torch.float32, device=seg.values.device)
        padded[:k] = seg.values
        buckets = padded.reshape(b, bs)
        norms = buckets.double().square().sum(dim=1).sqrt().float()
        safe = torch.where(norms > 0, norms, torch.ones_like(norms))
        scale = (q / safe)[:, None].expand(buckets.shape).reshape(-1)
        levels = quantize_levels(padded, scale.contiguous(), seg.seed, seg.offset, device=padded.device)
        leaves.append(torch.cat([levels.reshape(b, bs), norms.view(torch.int8).reshape(b, 4)], dim=1).reshape(-1))
    return torch.cat(leaves)


def _quantize_entry(quantize: dict, launches: int, max_err: float) -> dict:
    """qsgd_quantize's `kernels` entry: one launch at the qar path's size
    (phase 9), the kernel's only path (the DRQSGD arms' QSGD encode is the
    fused `qsgd_encode_rows`)."""
    return {
        "name": "qsgd_quantize",
        "route": "cuda",
        "source": "deepreduce_tpu_torch/ops/csrc/qsgd_quantize.cu",
        "replaces": "deepreduce_tpu/ops/qsgd_kernel.py:42",
        "launches": launches,
        "max_abs_err": max(max_err, quantize["max_abs_err"]),
        "ms": quantize["ms"],
        "plain_ms": quantize["plain_ms"],
        "bound_ms": quantize["bound_ms"],
        "bound_by": quantize["bound_by"],
        "library_ms": None,  # no single PyTorch call computes this function
    }


SWEEP_N = 4_050_944  # one segment of the qar path's size: where bytes do bound the kernel
L2_FLUSH_BYTES = 64 << 20  # written between launches of the cold rows: more than the 50 MB L2


def _table_bytes(segs, bs: int) -> tuple:
    """(live values, padded elements, buckets, bytes) of one table: each
    live value read once (4 B), each row byte written once."""
    from deepreduce_tpu_torch.ops.qsgd_encode import num_buckets

    live = sum(s.values.shape[0] for s in segs)
    buckets = sum(num_buckets(s.values.shape[0], bs) for s in segs)
    return live, buckets * bs, buckets, 4 * live + buckets * bs + 4 * buckets


def _sweep_tables(ex, seed: int) -> list:
    """The phase-6 sweep's tables, (name, segments, bucket size, bytes of
    out, cold): one bucket, the flagship's 12 segments, `resnet20_drqsgd`'s
    19, `fedavg_mobilenet_drqsgd`'s S2C tree (57 segments, one launch), and
    one 4,050,944-element segment warm and with the L2 flushed."""
    import dataclasses

    import torch

    from deepreduce_tpu_torch import DeepReduceConfig, GradientExchanger, TreeCodec
    from deepreduce_tpu_torch.models import MobileNetV1, ResNet20
    from deepreduce_tpu_torch.ops import EncodeSegment
    from deepreduce_tpu_torch.ops.qsgd_encode import rows_nbytes
    from deepreduce_tpu_torch.sparse import per_tensor_stream

    bs = ex.cfg.bucket_size
    flagship = _main_path_table(ex, seed)
    one = [dataclasses.replace(flagship[0], values=flagship[0].values[:bs], out_offset=0)]
    shapes = {n: tuple(p.shape) for n, p in ResNet20().flax_params().items()}
    ex_r = GradientExchanger(shapes, DeepReduceConfig(**{**QUICKSTART, "value": "qsgd"}, seed=seed), device="cuda")
    tree = {n: torch.zeros(p.shape, device="cuda") for n, p in MobileNetV1().flax_params().items()}
    _, _, units, tree_nbytes = TreeCodec("s2c", DeepReduceConfig(**FED_DRQSGD, seed=seed), device="cuda").group(tree, None)
    gen = torch.Generator().manual_seed(seed)
    s2c = []
    for path, codec, _, rows_lo in units:
        if codec.rows_leaf is not None:
            v = torch.randn(codec.val_codec.meta.k, generator=gen) * 1e-3
            v[torch.rand(v.shape[0], generator=gen) < 0.3] = 0.0
            s2c.append(EncodeSegment(v.cuda(), rows_lo, *per_tensor_stream(seed, f"s2c/{path}", TABLE_STEP, 0)))
    v = torch.randn(SWEEP_N, generator=gen) * 1e-3
    big = [EncodeSegment(v.cuda(), 0, *per_tensor_stream(seed, "big", TABLE_STEP, 0))]
    return [
        ("one bucket", one, bs, rows_nbytes(bs, bs), False),
        ("flagship, 12 segments", flagship, bs, ex.fused_nbytes, False),
        ("resnet20_drqsgd, 19 segments", _main_path_table(ex_r, seed), bs, ex_r.fused_nbytes, False),
        ("fedavg_mobilenet_drqsgd S2C, 57 segments", s2c, bs, tree_nbytes, False),
        ("4,050,944 elements, warm", big, bs, rows_nbytes(SWEEP_N, bs), False),
        ("4,050,944 elements, L2 flushed", big, bs, rows_nbytes(SWEEP_N, bs), True),
    ]


def _encode_sweep(tables, q: int, lib=None, floor: bool = True) -> list:
    """Device us per launch (torch.profiler over 200 launches, per launch it
    saw) of the encode on each sweep table beside its bytes bound at 3.35
    TB/s, and first, with `floor`, the launch floor (`qsgd_encode_floor`:
    the flagship's parameter block and grid, empty body, and the same on
    one block). `lib` is a loaded build of csrc/qsgd_encode.cu (an earlier
    one, to compare), else the package's."""
    import torch

    from deepreduce_tpu_torch.ops import qsgd_encode

    lib = qsgd_encode.bind(lib) if lib is not None else qsgd_encode.kernel_lib()
    rows = []

    def row(name, segs, bs, fn, kernel):
        ms, per_call = _device_ms(fn, 200, kernel)
        _check(ms > 0 and per_call > 0, f"the profiler saw no {kernel} launch on {name}")
        # per launch the profiler saw: it can drop events of a window (189 of
        # 200 after the profiled phases), and then time and count lack them
        us = ms * 1e3 / per_call
        _, _, buckets, nbytes = _table_bytes(segs, bs)
        bound_us = nbytes / HBM_BYTES_PER_S * 1e6
        rows.append({"table": name, "segments": len(segs), "buckets": buckets, "bytes": nbytes,
                     "device_us": us, "kernels_per_call": per_call, "bound_us": bound_us, "share": bound_us / us})

    if floor:
        name, segs, bs, nbytes, _ = tables[1]
        out = torch.zeros(nbytes, dtype=torch.uint8, device="cuda")
        for label, ss in (("", segs), (", one block", tables[0][1])):
            row(f"floor ({name}{label})", ss, bs,
                lambda ss=ss: qsgd_encode.launch(lib, ss, out, q, bs, floor=True), "qsgd_encode_floor_kernel")
    flush = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
    for name, segs, bs, nbytes, cold in tables:
        out = torch.zeros(nbytes, dtype=torch.uint8, device="cuda")
        enc = lambda segs=segs, out=out, bs=bs: qsgd_encode.launch(lib, segs, out, q, bs)
        row(name, segs, bs, (lambda enc=enc: (flush.zero_(), enc())) if cold else enc, "qsgd_encode_rows_kernel")
    return rows


def _check_sweep_tables(tables, q: int) -> None:
    """The kernel's rows bitwise the plain version's on every sweep table."""
    for name, segs, bs, nbytes, cold in tables:
        if cold:  # the same table as a warm row
            continue
        got, ref = _encode_on_card_and_cpu(segs, nbytes, q, bs)
        _check_rows(got, ref, segs, bs, q, name)


def _time_encode(ex, launches: int, max_err: float) -> dict:
    """qsgd_encode_rows on the sweep's tables (the main path's 12-segment
    table, one launch per worker-step, among them) and its launch floor,
    beside its plain version and the per-leaf composition it replaced."""
    import torch

    from deepreduce_tpu_torch.ops import qsgd_encode_rows, qsgd_encode_rows_plain
    from deepreduce_tpu_torch.ops.qsgd_encode import num_buckets

    q, bs = ex.cfg.quantum_num, ex.cfg.bucket_size
    tables = _sweep_tables(ex, seed=13)
    _check_sweep_tables(tables, q)
    sweep = _encode_sweep(tables, q)
    print("phase 6 ok: qsgd_encode_rows sweep " + json.dumps(sweep), flush=True)
    main = next(r for r in sweep if r["table"] == tables[1][0])
    ms = main["device_us"] / 1e3
    segs = tables[1][1]
    out = torch.zeros(ex.fused_nbytes, dtype=torch.uint8, device="cuda")
    kernel = lambda: qsgd_encode_rows(segs, out, quantum_num=q, bucket_size=bs, device="cuda")
    plain = lambda: qsgd_encode_rows_plain(segs, q, bs, out)
    before = lambda: _per_leaf_composition(segs, q, bs)
    plain_ms, plain_launches = _device_ms(plain, 10)
    before_ms, before_launches = _device_ms(before, 20)
    _check(plain_ms > 0 and before_ms > 0, "the profiler saw no device time")
    # launches per call from the wrapper's own count: the profiler can miss
    # an event of a window (it saw 199 of 200 once, after phase 7's profiled steps)
    counted = qsgd_encode_rows.launches
    kernel()
    launched = qsgd_encode_rows.launches - counted
    _check(launched == 1, f"{launched} qsgd_encode_rows launches per call on the 12-segment table, expected 1")
    # the fused rows against the composition's, bucket by bucket
    kernel()
    composed = before()
    fused = torch.cat([out[s.out_offset : s.out_offset + num_buckets(s.values.shape[0], bs) * (bs + 4)]
                       for s in segs]).view(torch.int8)
    equal_rows = int((fused.view(-1, bs + 4) == composed.view(-1, bs + 4)).all(dim=1).sum())
    live, padded, buckets, nbytes = _table_bytes(segs, bs)
    bytes_bound = nbytes / HBM_BYTES_PER_S
    ops_bound = QSGD_F32_OPS_PER_ELEM * padded / F32_OPS_PER_S + ENCODE_F64_OPS_PER_ELEM * padded / F64_OPS_PER_S
    detail = {
        "segments": len(segs), "live_values": live, "padded_elements": padded, "buckets": buckets,
        "bytes": nbytes, "device_ms": ms, "host_ms": _host_ms(kernel, 200),
        "plain_ms": plain_ms, "plain_launches": plain_launches, "plain_host_ms": _host_ms(plain, 10),
        "before_device_ms": before_ms, "before_launches": before_launches, "before_host_ms": _host_ms(before, 20),
        "rows_equal_to_before": f"{equal_rows}/{buckets}",
    }
    print("phase 6 ok: qsgd_encode_rows per worker-step " + json.dumps(detail), flush=True)
    return {
        "name": "qsgd_encode_rows",
        "route": "cuda",
        "source": "deepreduce_tpu_torch/ops/csrc/qsgd_encode.cu",
        "replaces": "deepreduce_tpu/ops/qsgd_kernel.py:42",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,  # one launch per worker-step
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_bound, ops_bound) * 1e3,
        "bound_by": "bytes" if bytes_bound >= ops_bound else "operations",
        "library_ms": None,  # no single PyTorch call computes this function
    }


def compare_encode(old_source: str, seed: int) -> None:
    """The sweep of this checkout's kernel and of an earlier source of
    csrc/qsgd_encode.cu (built beside it), in turns old, new, new, old in
    one process; this checkout's rows first held bitwise against its plain
    version on every sweep table and phase 3's."""
    import ctypes

    from deepreduce_tpu_torch import GradientExchanger
    from deepreduce_tpu_torch.models import WordLSTM
    from deepreduce_tpu_torch.ops import build

    out = build.BUILD_DIR / "qsgd_encode_earlier.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(out), old_source],
                          capture_output=True, text=True, timeout=300)
    _check(proc.returncode == 0, f"nvcc failed for {old_source}:\n{proc.stdout}{proc.stderr}")
    log = proc.stdout + proc.stderr
    print("  earlier qsgd_encode: " + " | ".join(l.strip() for l in log.splitlines() if "ptxas info" in l and "Used" in l),
          flush=True)
    print("  this qsgd_encode: " + " | ".join(l.strip() for l in build.build_logs.get("qsgd_encode", "").splitlines()
                                              if "Function properties" in l or "spill" in l or "Used" in l), flush=True)
    old = ctypes.CDLL(str(out))
    shapes = {n: tuple(p.shape) for n, p in WordLSTM(embed_dim=96, hidden_dim=670).flax_params().items()}
    ex = GradientExchanger(shapes, _flagship_cfg(seed), device="cuda")
    _check_encode(ex)
    q = ex.cfg.quantum_num
    tables = _sweep_tables(ex, seed=13)
    _check_sweep_tables(tables, q)
    print("compare: rows bitwise the plain version's on every sweep table", flush=True)
    turns = []
    for which in ("earlier", "this", "this", "earlier"):
        this = which == "this"
        sweep = _encode_sweep(tables, q, lib=None if this else old, floor=this)
        print(f"compare {which}: " + json.dumps(sweep), flush=True)
        turns.append((which, {r["table"]: r["device_us"] for r in sweep}))
    summary = {name: {w: [t[name] for ww, t in turns if ww == w] for w in ("earlier", "this")}
               for name, _, _, _, _ in tables}
    print("compare summary (device us per launch, two turns each): " + json.dumps(summary), flush=True)


def phase_timing(ex, errs: dict, by_arm: dict, quantize: dict) -> None:
    # each path's run, counted from 0 just before it (phases 5 and 7-14)
    total = lambda name: sum(counts[name] for counts in by_arm.values())
    kernels = [
        _quantize_entry(quantize, total("qsgd_quantize"), errs["qsgd_quantize"]),
        _time_encode(ex, total("qsgd_encode_rows"), errs["qsgd_encode_rows"]),
    ]
    for k in kernels:
        k["launches_by_arm"] = {arm: counts[k["name"]] for arm, counts in by_arm.items()}
    print(json.dumps({"kernels": kernels}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seq", type=int, default=20)
    ap.add_argument("--profile", action="store_true",
                    help="profile one extra training step: device busy share and top kernels")
    ap.add_argument("--compare-encode", metavar="SOURCE",
                    help="only build, check and time qsgd_encode_rows against an earlier qsgd_encode.cu, in turns")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on the GPU", file=sys.stderr)
        return 2
    try:
        import deepreduce_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the deepreduce_tpu_torch package is missing ({e})", file=sys.stderr)
        return 2

    t0 = time.perf_counter()
    phase_device()
    phase_build()
    if args.compare_encode:
        compare_encode(args.compare_encode, args.seed)
        print(f"chip_smoke total {time.perf_counter() - t0:.1f} s", flush=True)
        return 0
    # the main path's QSGD sizes, from the codec geometry (no card work)
    from deepreduce_tpu_torch import GradientExchanger
    from deepreduce_tpu_torch.models import WordLSTM

    shapes = {n: tuple(p.shape) for n, p in WordLSTM(embed_dim=96, hidden_dim=670).flax_params().items()}
    ex = GradientExchanger(shapes, _flagship_cfg(args.seed), device="cuda")
    sizes = [c.val_codec.meta.padded_len for c in ex.codecs.values() if c.compressed]
    errs = phase_kernels(sizes, ex)
    phase_codec(args.seed)
    import torch.distributed as dist

    tokens = _tokens(args.seed, args.steps, args.batch, args.seq, shapes["Embed_0/embedding"][0])
    # one rank through NCCL, so that the real collectives run
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        res = phase_train(args.seed, tokens, dist.group.WORLD, args.profile)
        _check(res["qsgd_sizes"] == sizes, "main-path QSGD sizes differ from the codec geometry")
        arms = phase_arms(args.seed, tokens, dist.group.WORLD, res["cpu_ref_loss0"], args.profile)
        resnet = phase_resnet(args.seed, dist.group.WORLD, args.profile)
        in_coll, quantize = phase_in_collective(args.seed, tokens, dist.group.WORLD, res["cpu_ref_loss0"],
                                                args.profile)
        bucketed = phase_bucketed(args.seed, tokens, dist.group.WORLD, res["cpu_ref_loss0"], args.profile)
        zoo = phase_zoo(args.seed, tokens, dist.group.WORLD, res["cpu_ref_loss0"], args.profile)
        models14 = phase_models(args.seed, dist.group.WORLD, args.profile)
    finally:
        dist.destroy_process_group()
    fed = phase_fedavg(args.seed, args.profile)
    table6 = phase_table6(args.seed)
    by_arm = {"drqsgd_bloom": res["launches"]}
    for phase in (arms, resnet, in_coll, bucketed, zoo, models14, fed, table6):
        by_arm.update({a: r["launches"] for a, r in phase.items()})
    phase_timing(ex, errs, by_arm, quantize)
    print(f"chip_smoke total {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
