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
  2. build every kernel from the sources in the checkout (nvcc, sm_90a) and
     the C++ host codec library (g++), all at once;
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
     plain version at its path's shapes, taken right after phase 4 for
     qsgd_encode_rows and in phase 9 for qsgd_quantize, before any phase
     runs its workers as threads (qsgd_encode_rows on phase 5's table,
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
     momentum 0.9 on 16 x 20 tokens) DRQSGD-BF-P0 for 1 round: finite
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
 15. the host half of the codec family on the full-width WordLSTM through
     the same NCCL group, 3 steps an arm (1 for the exact P2) on phase 7's
     weights and batches with the counts zeroed just before and read just after: the flagship
     with the Huffman index (`drqsgd_huffman`) and the C++ library's varint
     and pfor indices (`drqsgd_varint`, `drqsgd_pfor`), the library's bloom
     index under the exact P2 policy (`bloom_native_p2`), Deflate and the
     searched-knot PolyFit on Top-r (`topr_gzip`, `topr_polyfit_host`).
     Finite losses, the first within 1e-4 of phase 5's CPU forward; the
     payload bytes; rel_volume below the static budgets' (the live
     lengths); one qsgd_encode_rows launch a step in the three QSGD arms,
     each table bitwise its plain version, none elsewhere; the host syncs
     of every step equal to the copies the code makes (each host leaf's
     encode copies the tensors the JAX package's callback receives, the
     decode each gathered row once), with the file:line of each; one
     step's exchange card = CPU bitwise; `micro_benchmark` on Embed_0 for
     `drqsgd_huffman`; then each host codec's encode and decode at d =
     4,053,428 (ratio 0.1), wall ms from a synchronised start to a
     synchronised end, copies included.
 16. the resilient fused exchange on the full-width WordLSTM: at W = 1
     through the same NCCL group, 3 steps an arm with the counts zeroed just
     before and read just after (`PHASE16`): the flagship with payload
     checksums and nothing firing (bitwise the flagship after every step;
     the seal's and the verify's device ms and launches, and a whole step's
     against the flagship's), with chaos (corrupt, truncate and drop rates;
     each step's checksum failures equal to the units the same draws change
     on the host, every failed unit's mean zero and its residual its
     compensated gradient, bitwise), with the fault plan 0@1:2 (step 1's
     aggregate zero, its residual the compensated gradient), with the vmap,
     ring and unfused decodes (each bitwise the flagship), and the masked
     sparse_rs routes quantized, sparse and oktopk under an all-ones mask
     (each bitwise its mask-free route, the route card = CPU, qsgd_quantize
     counted and bitwise its plain version); one qsgd_encode_rows launch a
     step in the allgather arms on a table bitwise its plain version, no host
     sync, the payload bytes, rel_volume; then four in-process workers on the
     one card (`INPROC16`: worker 2 dropped, byte corruption, the checksum)
     for 2 steps of each of loop, vmap and ring (launches, no host sync,
     live count 3, failures) and one exchange of full-width gradients with
     loop card = CPU bitwise (failures, the masked mean over 3 live), vmap
     bitwise loop and ring within its reordering bound; and
     `python -m deepreduce_tpu_torch.resilience check --steps 12` (8
     in-process workers on the card) with its four checks true. No hop or gather
     crosses between cards: one card.
 17. the sparse_rs sketch and auto routes and the two-tier exchange on the
     full-width WordLSTM: at W = 1 through the same NCCL group, 3 steps an
     arm with the counts zeroed just before and read just after (`PHASE17`):
     `rs_sketch` (5 rows, C = 162,030; its one host sync a step named by
     file:line; the sampled top-k card = CPU bitwise, the sketch table
     within each cell's reordering bound, and given the CPU's table the
     mean and own bitwise), `rs_auto` (resolves to sparse, bitwise
     `rs_sparse` after every step) and `hier_w1` (the group split into
     (ici, dcn) = (1, 1): bitwise the flagship, one qsgd_encode_rows launch a
     step on a table bitwise its plain version); then four in-process
     workers on the one card as `InProcessGrid(2, 2)` (`HIER17`), each on a
     quarter of the batch for 3 steps: `hier_dense_fused`, `hier_qar_quantized`
     (bench.py's qar+quantized), `hier_auto` (its plan `{ici: qar, dcn: fused}`)
     and `stream_hier` (4 MiB buckets, bitwise the same config without
     streaming): `describe()`, the launches a worker-step, no host sync, DCN
     and ICI bytes, every worker's parameters alike and a slice's residuals,
     one exchange of full-width gradients card = CPU bitwise with each
     kernel bitwise its plain version on the arm's inputs, and worker 0's
     step times. No slice mean or cross-slice gather crosses between cards.
 18. the population-scale federated simulator (`FedSim`) through the same NCCL
     group (`PHASE18`): the linear arms at the JAX package's FedSim benchmark
     geometry (dimension 256, 131,072 clients, a cohort of 16,384 in blocks
     of 1,024, top-k 25% + mod bloom, churn and corruption under checksums)
     sync (4 rounds), async (K 16,384, alpha 0.5, latency "0.5,0.3,0.2"; 6
     ticks through `stream()`), two tenants (one leaving for two ticks) and
     a skewed population with the SLO monitor writing health.jsonl; then the
     full-width MobileNetV1 under DRQSGD-BF-P0 over 512 clients (a 6.6 GB
     bank), cohort 32 in blocks of 4, 3 rounds batched and 1 one client at
     a time. Each arm: tick times (CUDA events), host syncs (0), counted
     launches (`qsgd_encode_rows` equal to the packing's count), one
     all_reduce a tick at the byte law, peak bytes, finite parameters,
     w_rel_err falling, checksum failures, a mid-run checkpoint replayed
     bitwise, card = CPU (the linear arms on one tick at 1/8 of the
     population with float64 local training; the MobileNet block in float64
     and on the same client updates), the grouped cross-client encode
     bitwise its plain version and its per-client launches, and the device
     launches of a profiled tick or block.
 19. telemetry, the adaptive controller and the calibrated cost model through
     the same NCCL group: `telemetry_flagship` (DRQSGD-BF-P0 on the full-width
     WordLSTM from phase 5's weights, telemetry every 3 steps, 9 steps, spans
     on) against the same 9 steps with telemetry off: 0 host syncs a step,
     one device-to-host copy a fetch, one qsgd_encode_rows launch a step in
     both, the device launches a step of one profiled step of each, the
     accumulator's steps, wire bits and saturations equal to the float32 sums
     of the steps' WireStats bitwise, step 5's rel_volume phase 5's, the first
     step's err_cos / err_l2 card vs CPU within ERR19_ATOL; `ctrl_flagship`
     (the controller on the ladder 0.05 / 0.1 / 0.2, hysteresis 1, its band
     set from the first window's err_cos so that the first decision moves up,
     written as a tracking run with trace.json and decisions.jsonl): a valid
     trail with a switch, exchangers built == rungs visited, each rung's
     payload bytes the JAX package's (`CTRL19_PAYLOAD`) and its table bitwise
     its plain version, one launch a step on every rung, a checkpoint after
     step 6 restored into a fresh trainer and replayed: trail and parameters
     bitwise; `tracked_run` (the telemetry CLI's summary, trace and calibrate
     over that run's directory in subprocesses; the fitted profile valid;
     `apply_profile` of the static profile a no-op on an rs_mode='auto'
     trainer, of the fitted one a record with exchangers built == plans
     visited, then a step); `fedsim_telemetry_*` (phase 18's four linear arms
     with telemetry at 1/8 size, 2 ticks: 0 host syncs, one all_reduce a
     tick at the byte law, the accumulator's rows, per tenant, equal to the
     tick reports, the summary carrying the JAX package's telemetry keys).
 20. sequence and tensor parallelism on the full-width BERT-base (vocabulary
     30,522, hidden 768, 12 layers of 12 heads, MLP 3,072, 512 positions,
     float32, weights from --seed), every arm's workers in-process threads
     on the one card (`PHASE20`): `bert_ring_sp4` and `bert_ulysses_sp4`
     (four sequence workers on 8 x 512 tokens in chunks of 128, causal;
     logits, loss and every gradient leaf on the card within TWIN20_REL of
     each tensor's largest magnitude against the plain reference, the
     Ulysses local twin, whose attention is one plain softmax, and for the
     ring arm also against its own local twin, seq_axis=None), `bert_tp2` (the dense model over a model group of two, the
     embedding and the head vocabulary-sharded; each rank's logits, loss and
     gradient shards against the single-device model) and
     `bert_dp2_sp2_ring` (`parallel.data_seq.DataSeqStep` on
     factor_devices(4, ('data', 'seq')) = (2, 2), ring attention, 8 x 512
     tokens a data rank, 3 steps of JAX's dry-run config: finite losses,
     0 < rel_volume < 1, the pinned payload bytes, 2 qsgd_encode_rows
     launches a worker-step on a table bitwise its plain version, all four
     replicas' parameters bitwise alike after every step, 0 host syncs on
     steps 2-3, where a worker thread's one `.item()` counts as one sync). Each arm: ms on worker 0's clock, launches counted from 0
     just before, peak memory, the card's name and power limit. No hop,
     all_to_all or all-reduce crosses between cards.
 21. the training driver (`deepreduce_tpu_torch.driver`, the counterpart of
     benchmarks/train.py) through `driver.run` in this process on the same
     NCCL group, each run with the counts zeroed just before and read just
     after and every step under the sync debug mode (`DRIVER21`):
     `driver_flagship` (DRQSGD-BF-P0 on the full-width WordLSTM, batch 64,
     8 steps, --telemetry --track_dir: the payload bytes, rel_volume, one
     qsgd_encode_rows launch a step, 0 host syncs in steps 2-8, the first
     loss within 1e-4 of the CPU's, the tracked run's metrics and trace, and
     the last step's grouped QSGD table bitwise its plain version),
     `driver_quickstart` (the README quick start's --grace_config on the
     full-width ResNet-20, 3 steps: 18,756 B, no launch) and `driver_qar`
     (3 steps: 2 qsgd_quantize launches a step, the last call's output
     bitwise its plain version on its input); `driver_resume` (the flagship
     killed after 4 steps, checkpointed every 2, resumed to 6, against an
     uninterrupted 6: the last loss within rtol 1e-6, the difference
     printed); `driver_stream`: the flagship in 4 MiB buckets under the
     barrier schedule (one launch a step), then streamed from the backward
     pass through `python -m deepreduce_tpu_torch.driver` in a fresh process
     (the loss and rel_volume series bitwise the barrier run's),
     `telemetry trace --overlap`'s fraction on the streamed run, and two
     `telemetry calibrate` fits of the barrier run byte-equal.
`--profile` adds one profiled training step after phase 5, after each arm
of phases 7, 8, 9, 10, 11, 14 and 15, and one profiled round after each arm
of phase 12: the device's busy and idle share over the step or round, its
device launches and its largest kernels, and the host codecs' host spans.
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
                               momentum=0.9, batch=16, seq=20, rounds=1),  # one round: phase 21's time
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
    rows = [(cnt, us) for key, cnt, us in _kernel_rows(prof.key_averages()) if name_part in key]
    return sum(us for _, us in rows) / 1e3 / reps, sum(cnt for cnt, _ in rows) / reps


def _kernel_rows(averages):
    """(name, count, device us) of the device-side kernel events of a
    profile's `key_averages()` only: the CPU-side operator rows also carry
    their kernels' device time, and summing both would count it twice."""
    from torch.autograd import DeviceType

    rows = []
    for evt in averages:
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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        step_fn()
        end.record()
        end.synchronize()
    wall_ms = start.elapsed_time(end)
    averages = prof.key_averages()  # one pass: it walks every event of the trace
    rows = sorted(((us / 1e3, cnt, key[:70]) for key, cnt, us in _kernel_rows(averages)), reverse=True)
    busy_ms = sum(r[0] for r in rows)
    # the host codecs' `record_function` ranges ("host/<codec>.<stage>"):
    # host ms and calls of each
    spans = {evt.key: [evt.cpu_time_total / 1e3, evt.count] for evt in averages
             if evt.key.startswith("host/") and evt.device_type != DeviceType.CUDA}
    return {
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms) if wall_ms else None,
        "kernel_launches": sum(r[1] for r in rows),
        "top_device_ms": [[round(ms, 4), cnt, key] for ms, cnt, key in rows[:15]],
        "host_spans_ms": spans,
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


def _codec_table_input():
    """The codec table's flat gradient on the card: d = 4,053,428 normal
    times uniform squared, from a fixed seed."""
    import torch

    gen = torch.Generator().manual_seed(0)
    return (torch.randn(CODEC_TABLE_D, generator=gen) * torch.rand(CODEC_TABLE_D, generator=gen) ** 2).cuda()


def _codec_times(cfg, reps: int = 10) -> dict:
    """bench.py's codec table on the card: encode and decode of one flat
    gradient of d = 4,053,428 (normal times uniform squared, from a fixed
    seed) at the arm's config, ms per call from CUDA events around `reps`
    calls after a warm-up. The events span the host's gaps too (the sampled
    threshold's host sync), so this is the call's time on the card's clock."""
    from deepreduce_tpu_torch import TensorCodec

    g = _codec_table_input()
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


def _route_card_vs_cpu(trainer, state, batch, mask: bool = False) -> dict:
    """One step's compensated full-width gradient (a probe copy of the model
    at the trainer's state) through the arm's route on the card (the
    trainer's exchanger, over the NCCL group) and on the CPU (an exchanger
    without a group) under the same Philox streams: the mean, the
    own-transmitted tensor, the observables and the quantized levels bitwise
    equal. With `mask`, the route's participation-mask variant under an
    all-ones mask. Returns the comparison's summary and the qar path's
    padded input."""
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
        m = torch.ones(e.num_workers, dtype=torch.bool, device=dev) if mask else None
        mean, own, _ = e.route_flat(x, step=state.step, collect=collect, mask=m)
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


# phase 15: the host half of the codec family on the full-width WordLSTM:
# knobs over the flagship's, the JAX package's GradientExchanger.payload_bytes,
# qsgd_encode_rows launches per step, and the blocking copies to the host one
# host leaf's encode makes (the tensors the JAX package's pure_callback
# receives: the indices; the indices, values and nnz; the dense tensor,
# indices and nnz; the values; the sorted values)
HOST15 = {
    "drqsgd_huffman": (dict(index="huffman"), 3_651_208, 1, 1),
    "drqsgd_varint": (dict(index="integer_native", code="varint"), 3_677_136, 1, 3),
    "drqsgd_pfor": (dict(index="integer_native", code="pfor"), 3_677_136, 1, 3),
    "bloom_native_p2": (dict(deepreduce="index", index="bloom_native", policy="conflict_sets"), 3_652_916, 0, 3),
    "topr_gzip": (dict(deepreduce="value", value="gzip"), 3_241_983, 0, 1),
    "topr_polyfit_host": (dict(deepreduce="value", value="polyfit_host"), 1_625_548, 0, 1),
}
HOST15_STEPS = 3
# the exact P2 takes 5.6-8.4 s a step on the host: its arm runs one step, and
# its codec-table row one timed encode and decode (phase 21's time)
HOST15_P2 = "bloom_native_p2"
# the codec table's host codecs (bench.py's geometry): the six arms' and fbp
HOST15_CODEC_TABLE = {**{arm: knobs for arm, (knobs, *_) in HOST15.items()},
                      "drqsgd_fbp": dict(index="integer_native", code="fbp")}


def _wall_ms(fn, reps: int) -> float:
    """ms per call on the host's clock from a synchronised start to a
    synchronised end over `reps` calls after a warm-up: a host codec's
    copies, host work and launches all fall inside."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def _host_codec_times(cfg, reps: int = 3) -> dict:
    """The codec table's flat gradient (`_codec_table_input`) through a host
    codec: encode and decode wall ms (`_wall_ms`), the host syncs of each
    (their copies), rel_volume and the live payload bits."""
    from deepreduce_tpu_torch import TensorCodec

    g = _codec_table_input()
    codec = TensorCodec((CODEC_TABLE_D,), cfg, name="bench", device="cuda")
    payload, enc_syncs = _counting_syncs(lambda: codec.encode(g))
    _, dec_syncs = _counting_syncs(lambda: codec.decode(payload))
    stats = codec.wire_stats(payload)
    return {
        "encode_ms": _wall_ms(lambda: codec.encode(g), reps), "decode_ms": _wall_ms(lambda: codec.decode(payload), reps),
        "encode_syncs": len(enc_syncs), "decode_syncs": len(dec_syncs),
        "rel_volume": float(stats.rel_volume()), "payload_bits": float(stats.total_bits),
    }


def phase_host_codecs(seed: int, tokens, group, ref_loss: float, profile: bool = False) -> dict:
    """Phase 15: the host codecs through `Trainer.step`, HOST15_STEPS steps
    per arm on phase 7's weights and batches."""
    import warnings

    import numpy as np
    import torch

    tokens = tokens[:HOST15_STEPS].cuda()
    batch = lambda i: (tokens[i, :, :-1], tokens[i, :, 1:])
    results = {}
    with warnings.catch_warnings():
        # np.polyfit's conditioning warning on the host PolyFit's long
        # segments (the JAX package's fit warns alike); the coefficients
        # are what the tests hold
        warnings.simplefilter("ignore", getattr(np, "exceptions", np).RankWarning)
        for arm, (knobs, payload, per_step, copies) in HOST15.items():
            results[arm] = _host_arm(arm, knobs, payload, per_step, copies, seed, batch, group, ref_loss, profile)
            torch.cuda.empty_cache()
        table = {name: _host_codec_times(_flagship_cfg(seed, **knobs), reps=1 if name == HOST15_P2 else 3)
                 for name, knobs in HOST15_CODEC_TABLE.items()}
    print("phase 15 ok: host codec table " + json.dumps(table), flush=True)
    return results


def _host_arm(arm: str, knobs: dict, payload: int, per_step: int, copies: int, seed: int, batch, group,
              ref_loss: float, profile: bool) -> dict:
    """One arm of phase 15: HOST15_STEPS steps (1 for HOST15_P2) from fresh weights, each
    checked for its launches and host syncs, then its exchange card = CPU,
    its QSGD table and (with `profile`) one profiled step."""
    import torch

    from deepreduce_tpu_torch import Trainer, TensorCodec
    from deepreduce_tpu_torch.models import WordLSTM
    from deepreduce_tpu_torch.ops import launch_counts, reset_launch_counts
    from deepreduce_tpu_torch.sparse import host_branch

    cfg = _flagship_cfg(seed, **knobs)
    trainer = Trainer(WordLSTM(seed=seed), cfg, lr=0.1, momentum=0.9, device="cuda", group=group)
    state = trainer.init_state()
    ex = trainer.exchanger
    host_leaves = len(ex.fused.host_units)
    _check(host_leaves == sum(c.compressed for c in ex.codecs.values()) == 12, f"{arm}: {host_leaves} host leaves")
    # each host leaf's encode copies `copies` tensors to the host; the
    # decode copies each gathered row once
    syncs_per_step = copies * host_leaves + ex.num_workers
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    host_branch.syncs = 0
    steps = 1 if arm == HOST15_P2 else HOST15_STEPS
    state, losses, dev_ms, host_ms, wire, sync_calls = _run_steps(trainer, state, batch, steps)
    launches = launch_counts()
    expected = {"qsgd_quantize": 0, "qsgd_encode_rows": per_step * steps}
    _check(launches == expected, f"{arm}: kernel launches {launches}, expected {expected}")
    _check_trained(state, losses, ref_loss, arm)
    sites = sorted({m for x in sync_calls for m in x})
    _check(all(len(x) == syncs_per_step for x in sync_calls) and host_branch.syncs == 0,
           f"{arm}: host syncs per step {[len(x) for x in sync_calls]}, expected {syncs_per_step}, at {sites}")
    _check(ex.payload_bytes() == payload, f"{arm}: payload_bytes {ex.payload_bytes()}, expected {payload}")
    # rel_volume reads the live lengths: below what the static budgets
    # would give
    rel_volume = float(wire.rel_volume())
    budget_volume = ex.payload_bytes() * 8 / float(wire.dense_bits)
    _check(0.0 < rel_volume < budget_volume, f"{arm}: rel_volume {rel_volume}, budgets {budget_volume}")
    res = {
        "losses": losses, "step_ms_all": dev_ms, "step_ms_median": statistics.median(dev_ms),
        "host_step_ms_all": host_ms, "rel_volume": rel_volume, "budget_volume": budget_volume,
        "payload_bytes": ex.payload_bytes(), "launches": launches, "qsgd_encode_rows_per_step": per_step,
        "host_syncs_per_step": [len(x) for x in sync_calls], "expected_syncs_per_step": syncs_per_step,
        "sync_call_sites": sites, "host_leaves": host_leaves, "peak_mem_bytes": torch.cuda.max_memory_allocated(),
    }
    res["card_vs_cpu"] = _exchange_card_vs_cpu(trainer, state, batch(0), exact=True)
    if per_step:
        segs = _main_path_table(ex, seed=41)
        got, ref_rows = _encode_on_card_and_cpu(segs, ex.fused_nbytes, cfg.quantum_num, cfg.bucket_size)
        res["qsgd_table_max_abs_err"] = _check_rows(got, ref_rows, segs, cfg.bucket_size, cfg.quantum_num,
                                                    f"the {arm} table")
        res["qsgd_segments"] = len(segs)
    if arm == "drqsgd_huffman":
        # the reference's 'micro-benchmark' mode on Embed_0's gradient
        mcfg = _flagship_cfg(seed, **knobs, micro_benchmark=True)
        codec = TensorCodec(EMBED_SHAPE, mcfg, name="Embed_0/embedding", device="cuda")
        res["micro_benchmark"] = codec.micro_benchmark(_embed_grad(seed).cuda())
    if profile:
        prof = _profile_step(lambda: trainer.step(state, batch(0)))
        res["profile"] = {k: prof[k] for k in ("wall_ms", "device_busy_ms", "device_idle_share", "kernel_launches",
                                               "host_spans_ms")}
    print(f"phase 15 ok: {arm} " + json.dumps(res), flush=True)
    return res


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


# phase 16: the resilient fused exchange on the full-width WordLSTM, knobs
# over the flagship's. W = 1 through the NCCL group: (knobs, the arm whose
# parameters and residuals it must equal bitwise after every step, or None).
# A fault_plan entry for worker 7 is past W and ignored, as in the JAX
# package: the mask is all ones, so the masked route runs.
RES16 = dict(resilience=True, payload_checksum=True)
PHASE16 = {
    "drqsgd_bloom_checksum": (RES16, "drqsgd_bloom"),
    "drqsgd_bloom_chaos": (dict(RES16, chaos_corrupt_rate=0.5, chaos_truncate_rate=0.3, chaos_drop_rate=0.2), None),
    "drqsgd_bloom_faultplan": (dict(resilience=True, fault_plan="0@1:2"), None),
    "drqsgd_bloom_vmap": (dict(decode_strategy="vmap"), "drqsgd_bloom"),
    "drqsgd_bloom_ring": (dict(decode_strategy="ring"), "drqsgd_bloom"),
    "drqsgd_bloom_unfused": (dict(fused=False), "drqsgd_bloom"),
    "rs_quantized_masked": (dict(RS, rs_mode="quantized", resilience=True, fault_plan="7@0:1000"), "rs_quantized"),
    "rs_sparse_masked": (dict(RS, rs_mode="sparse", resilience=True, fault_plan="7@0:1000"), "rs_sparse"),
    "rs_oktopk_masked": (dict(RS, rs_mode="oktopk", resilience=True, fault_plan="7@0:1000"), "rs_oktopk"),
}
# the references those arms are held to, run in phase 16 from the same weights
REF16 = {"drqsgd_bloom": {}, "rs_quantized": dict(RS, rs_mode="quantized"), "rs_sparse": dict(RS, rs_mode="sparse"),
         "rs_oktopk": dict(RS, rs_mode="oktopk")}
PAYLOAD16 = {  # the JAX package's payload_bytes at W = 1 (test_phase16_wire_constants_match_jax), a
    # 4-byte checksum word for each of the 17 tensors
    "drqsgd_bloom_checksum": 1_189_616 + 4 * 17, "drqsgd_bloom_chaos": 1_189_616 + 4 * 17,
    "drqsgd_bloom_faultplan": 1_189_616, "drqsgd_bloom_vmap": 1_189_616, "drqsgd_bloom_ring": 0,
    "drqsgd_bloom_unfused": 1_189_616, "rs_quantized_masked": 7_354_832 + 4_050_944,  # + the shard all_gather
    "rs_sparse_masked": 9_721_776, "rs_oktopk_masked": 9_738_160,
}
# W = 4 in-process workers on the one card: the flagship with worker 2
# dropped, the checksum and byte corruption, in each decode strategy
W16 = 4
INPROC16 = dict(RES16, fault_plan="2@0:1000", chaos_corrupt_rate=0.6)
INPROC16_STEPS = 2  # steps of each W = 4 in-process strategy (2, not 3: phase 21's time)
STRATEGIES16 = {"loop": {}, "vmap": dict(decode_strategy="vmap"), "ring": dict(decode_strategy="ring")}
EPS32 = 2.0 ** -24


def _snapshot16(state) -> dict:
    return {**{f"param/{n}": p.detach().clone() for n, p in state.params.items()},
            **{f"res/{n}": r.clone() for n, r in (state.residuals or {}).items()}}


def _steps16(trainer, state, batches, steps: int, spy: bool = False):
    """`steps` counted training steps (CUDA events, host clock, host syncs
    under the sync debug mode, each step's `collect`), with the parameters
    and residuals snapshot after each step, outside the timed region. With
    `spy`, the exchanger's wire boundary and its `finish` are recorded: the
    buffer before and after chaos, the compensated gradient, the mean and
    the new residuals of each step."""
    import torch

    ex = trainer.exchanger
    records = {"perturb": [], "finish": []}
    if spy:
        perturb, finish = ex.perturb, ex.finish

        def perturb_spy(buf, **kw):
            out = perturb(buf, **kw)
            records["perturb"].append((buf.clone(), out, kw))
            return out

        def finish_spy(grads, compensated, mean, own):
            agg, new_res = finish(grads, compensated, mean, own)
            records["finish"].append((compensated, mean, new_res))
            return agg, new_res

        ex.perturb, ex.finish = perturb_spy, finish_spy
    out = {"losses": [], "dev_ms": [], "host_ms": [], "syncs": [], "collects": [], "snaps": []}
    try:
        for i in range(steps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            collect = {}
            t0 = time.perf_counter()
            start.record()
            state, loss, wire, sync = _step_counting_syncs(trainer, state, batches(i), collect=collect)
            end.record()
            end.synchronize()
            out["host_ms"].append((time.perf_counter() - t0) * 1e3)
            out["dev_ms"].append(start.elapsed_time(end))
            out["losses"].append(float(loss))
            out["syncs"].append(sync)
            out["collects"].append(collect)
            out["snaps"].append(_snapshot16(state))
    finally:
        if spy:
            del ex.perturb, ex.finish
    out["wire"], out["records"] = wire, records
    return state, out


def _same16(a: dict, b: dict, what: str) -> None:
    import torch

    for key, ref in b.items():
        if not torch.equal(a[key], ref):
            diff = float((a[key].double() - ref.double()).abs().max())
            _check(False, f"{what}: {key} differs (max |diff| {diff})")


def _chaos_expected16(ex, records) -> dict:
    """The chaos arm's failures from the same draws on the host: each step's
    clean buffer perturbed on the CPU from the host stream (bitwise the
    card's perturbed buffer), and a unit fails where its bytes changed.
    Checks that every failed unit's mean is zero and its residual the
    compensated gradient, bitwise."""
    import torch

    per_step, events = [], []
    for (clean, card_out, kw), (comp, mean, new_res) in zip(records["perturb"], records["finish"]):
        host_out = ex.chaos.perturb(clean.cpu(), worker=ex.rank, **kw)
        _check(torch.equal(host_out, card_out.cpu()), "the card's chaos differs from the host's draws")
        events.append({k: bool(v) for k, v in ex.chaos.events(step=kw["step"], worker=ex.rank).items()})
        failed = [u for u in ex.fused.units if not torch.equal(clean[ex.fused.span(u)].cpu(),
                                                               host_out[ex.fused.span(u)])]
        per_step.append(len(failed))
        for u in failed:
            _check(not bool(mean[u].any()), f"chaos: failed unit {u} has a nonzero mean")
            _check(torch.equal(new_res[u], comp[u]), f"chaos: failed unit {u}'s residual is not its compensated "
                                                     "gradient")
    return {"failed_units_per_step": per_step, "events": events}


def _inproc_exchange16(seed: int) -> dict:
    """One W = 4 in-process exchange of full-width random gradients under
    INPROC16 (worker 2 dropped, byte corruption, the checksum): loop on the
    card and on the CPU bitwise equal (aggregates, residuals, the failure
    count; the mean divides by the live count 3); vmap bitwise loop on the
    card; ring with loop's residuals bitwise (the own decode is the same)
    and its aggregate within the reordering bound 2 (W - 1) W eps32 M, M the
    largest |compensated| + |new residual| (a bound on every decode)."""
    import torch

    from deepreduce_tpu_torch import GradientExchanger, InProcessGroup
    from deepreduce_tpu_torch.models import WordLSTM
    from deepreduce_tpu_torch.ops import launch_counts, reset_launch_counts
    from deepreduce_tpu_torch.resilience.faults import participation_mask

    shapes = {n: tuple(p.shape) for n, p in WordLSTM(embed_dim=96, hidden_dim=670).flax_params().items()}
    gen = torch.Generator().manual_seed(seed + 16)
    grads = [{n: torch.randn(s, generator=gen) * 1e-2 for n, s in shapes.items()} for _ in range(W16)]
    res = [{n: torch.randn(s, generator=gen) * 1e-3 for n, s in shapes.items()} for _ in range(W16)]
    out = {}
    for key, dev, knobs in (("loop/cuda", "cuda", {}), ("loop/cpu", "cpu", {}),
                            ("vmap/cuda", "cuda", STRATEGIES16["vmap"]), ("ring/cuda", "cuda", STRATEGIES16["ring"])):
        cfg = _flagship_cfg(seed, **INPROC16, **knobs)

        def work(coll, g, r, dev=dev, cfg=cfg):
            ex = GradientExchanger(shapes, cfg, device=dev, group=coll)
            mask = participation_mask(W16, 1, cfg.seed, fault_plan=cfg.fault_plan, device=dev)
            collect = {}
            agg, new_r, _ = ex.exchange({n: t.to(dev) for n, t in g.items()}, {n: t.to(dev) for n, t in r.items()},
                                        step=1, collect=collect, mask=mask)
            return ({n: t.cpu() for n, t in agg.items()}, {n: t.cpu() for n, t in new_r.items()},
                    float(collect["checksum_failures"]), float(mask.sum()))

        reset_launch_counts()
        out[key] = InProcessGroup(W16).run(work, grads, res)
        if dev == "cuda":
            torch.cuda.synchronize()
            _check(launch_counts()["qsgd_encode_rows"] == W16, f"{key}: launches {launch_counts()}")
    fails, ring_err, ring_bound = [], 0.0, 0.0
    for w in range(W16):
        ref = out["loop/cpu"][w]
        _check(ref[3] == 3.0, f"worker {w}: live count {ref[3]}")
        fails.append(ref[2])
        for key in ("loop/cuda", "vmap/cuda", "ring/cuda"):
            got = out[key][w]
            _check(got[2] == ref[2], f"{key} worker {w}: checksum failures {got[2]} vs {ref[2]}")
            for n in shapes:
                _check(torch.equal(got[1][n], ref[1][n]), f"{key} worker {w}: residual {n} differs from loop/cpu")
                if key != "ring/cuda":
                    _check(torch.equal(got[0][n], ref[0][n]), f"{key} worker {w}: aggregate {n} differs")
        m = max(float((grads[v][n] + res[v][n]).abs().max() + out["loop/cpu"][v][1][n].abs().max())
                for v in range(W16) for n in shapes)
        bound = 2 * (W16 - 1) * W16 * EPS32 * m
        err = max(float((out["ring/cuda"][w][0][n] - ref[0][n]).abs().max()) for n in shapes)
        _check(err <= bound, f"ring worker {w}: aggregate differs from loop by {err} > {bound}")
        ring_err, ring_bound = max(ring_err, err), max(ring_bound, bound)
    for n in shapes:  # the dropped worker kept its compensated gradient
        _check(torch.equal(out["loop/cpu"][2][1][n], grads[2][n] + res[2][n]), f"dropped worker's residual {n}")
    _check(sum(fails) > 0, "no payload failed its checksum")
    return {"bitwise": ["loop card = CPU", "vmap = loop", "ring residuals = loop"], "checksum_failures": fails,
            "live_workers": 3, "ring_vs_loop_max_abs": ring_err, "ring_vs_loop_bound": ring_bound,
            "ring_bitwise_loop": ring_err == 0.0, "tensors": len(shapes)}


def _inproc16(seed: int, tokens) -> dict:
    """The W = 4 in-process arms: INPROC16_STEPS Trainer steps of each decode strategy
    under INPROC16, one thread a worker, each on its quarter of the batch:
    launches, host syncs, losses, failures, live counts and times."""
    import warnings

    import torch

    from deepreduce_tpu_torch import InProcessGroup, Trainer
    from deepreduce_tpu_torch.models import WordLSTM
    from deepreduce_tpu_torch.ops import launch_counts, reset_launch_counts

    shard = tokens.shape[1] // W16
    results = {}
    for name, knobs in STRATEGIES16.items():
        cfg = _flagship_cfg(seed, **INPROC16, **knobs)
        # built before the counted run: moving a model to the card copies it
        group = InProcessGroup(W16)
        trainers = [Trainer(WordLSTM(seed=seed), cfg, lr=0.1, momentum=0.9, device="cuda", group=group.member(r))
                    for r in range(W16)]
        states = [t.init_state() for t in trainers]

        def worker(coll, trainer, state):
            lo = coll.rank * shard
            steps = []
            coll.all_reduce_sum(torch.zeros(1, device="cuda"))  # every worker built before the clock starts
            for i in range(INPROC16_STEPS):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                collect = {}
                start.record()
                state, loss, wire = trainer.step(state, (tokens[i, lo : lo + shard, :-1],
                                                         tokens[i, lo : lo + shard, 1:]), collect=collect)
                end.record()
                steps.append((start, end, loss, collect))
            return state, steps, trainer.exchanger.payload_bytes(), wire

        torch.cuda.synchronize()
        reset_launch_counts()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                t0 = time.perf_counter()
                outs = group.run(worker, trainers, states)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs = sorted({f"{w.filename}:{w.lineno}" for w in caught if "called a synchronizing" in str(w.message)})
        launches = launch_counts()
        expected = {"qsgd_quantize": 0, "qsgd_encode_rows": W16 * INPROC16_STEPS}
        _check(launches == expected, f"inproc_{name}: kernel launches {launches}, expected {expected}")
        _check(not syncs, f"inproc_{name}: host syncs at {syncs}")
        state0, steps0, payload, wire = outs[0]
        losses = [float(s[2]) for s in steps0]
        _check(all(math.isfinite(l) for l in losses), f"inproc_{name}: losses {losses}")
        for w, (st, _, _, _) in enumerate(outs):
            _check(all(bool(torch.isfinite(p).all()) for p in st.params.values()), f"inproc_{name}: worker {w}")
        live = [float(s[3]["live_workers"]) for s in steps0]
        _check(live == [3.0] * INPROC16_STEPS, f"inproc_{name}: live workers {live}")
        dev_ms = [s[0].elapsed_time(s[1]) for s in steps0]
        results[f"inproc_{name}"] = {
            "losses": losses, "worker0_step_ms_all": dev_ms, "step_ms_median": statistics.median(dev_ms),
            "step_ms_spread": max(dev_ms) - min(dev_ms),
            "wall_ms_all_steps": wall, "launches": launches, "host_syncs": 0,
            "checksum_failures_per_step": [float(s[3]["checksum_failures"]) for s in steps0], "live_workers": live,
            "payload_bytes": payload, "rel_volume": float(wire.rel_volume()),
        }
        print(f"phase 16 ok: inproc_{name} " + json.dumps(results[f"inproc_{name}"]), flush=True)
        del outs, trainers, states
        torch.cuda.empty_cache()
    return results


def _checksum_cost16(ex, buf) -> dict:
    """Device ms and launches of what the checksum adds to a W = 1 step: the
    seal of every payload (encode side) and the batched verify of the
    gathered row (decode side)."""
    def seal():
        for u in ex.fused.units:
            ex.layouts[u].seal(buf[ex.fused.span(u)])

    rows = buf[None]
    seal_ms, seal_launches = _device_ms(seal, 20)
    verify_ms, verify_launches = _device_ms(lambda: ex.fused.verify(rows), 20)
    return {"seal_ms": seal_ms, "seal_launches": seal_launches, "verify_ms": verify_ms,
            "verify_launches": verify_launches, "ms": seal_ms + verify_ms, "launches": seal_launches + verify_launches}


def phase_resilience(seed: int, tokens, group, ref_loss: float):
    """Phase 16: the resilient fused exchange. Returns ({arm: result} of the
    arms whose launches the kernels line counts, the other results)."""
    import subprocess as sp

    import torch

    from deepreduce_tpu_torch import Trainer
    from deepreduce_tpu_torch.models import WordLSTM
    from deepreduce_tpu_torch.ops import launch_counts, reset_launch_counts

    tokens3 = tokens[:ARM_STEPS].cuda()
    batches = lambda i: (tokens3[i, :, :-1], tokens3[i, :, 1:])
    arms, extras, refs, timing = {}, {}, {}, {}
    for ref, knobs in REF16.items():
        trainer = Trainer(WordLSTM(seed=seed), _flagship_cfg(seed, **knobs), lr=0.1, momentum=0.9, device="cuda",
                          group=group)
        state, out = _steps16(trainer, trainer.init_state(), batches, ARM_STEPS)
        refs[ref] = out["snaps"]
        if ref == "drqsgd_bloom":
            timing[ref] = _device_ms(lambda: trainer.step(state, batches(0)), 3)
        del trainer, state
    for arm, (knobs, ref) in PHASE16.items():
        cfg = _flagship_cfg(seed, **knobs)
        trainer = Trainer(WordLSTM(seed=seed), cfg, lr=0.1, momentum=0.9, device="cuda", group=group)
        state = trainer.init_state()
        ex = trainer.exchanger
        torch.cuda.synchronize()
        reset_launch_counts()
        spy = arm in ("drqsgd_bloom_chaos", "drqsgd_bloom_faultplan")
        state, out = _steps16(trainer, state, batches, ARM_STEPS, spy=spy)
        launches = launch_counts()
        qsgd = cfg.communicator == "allgather"
        expected = {"qsgd_quantize": ARM_STEPS if cfg.rs_mode == "quantized" else 0,
                    "qsgd_encode_rows": ARM_STEPS if qsgd else 0}
        _check(launches == expected, f"{arm}: kernel launches {launches}, expected {expected}")
        _check_trained(state, out["losses"], ref_loss, arm)
        _check(not any(out["syncs"]), f"{arm}: host syncs in the step: {out['syncs']}")
        _check(ex.payload_bytes() == PAYLOAD16[arm], f"{arm}: payload_bytes {ex.payload_bytes()}, "
                                                     f"expected {PAYLOAD16[arm]}")
        if ref is not None:
            for i in range(ARM_STEPS):
                _same16(out["snaps"][i], refs[ref][i], f"{arm} vs {ref} after step {i}")
        dev_ms = out["dev_ms"]
        res = {
            "losses": out["losses"], "step_ms_all": dev_ms, "step_ms_median": statistics.median(dev_ms),
            "step_ms_spread": max(dev_ms) - min(dev_ms), "host_step_ms_all": out["host_ms"],
            "rel_volume": float(out["wire"].rel_volume()), "payload_bytes": ex.payload_bytes(), "launches": launches,
            "host_syncs_per_step": [len(x) for x in out["syncs"]], "bitwise_equal_to": ref,
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        }
        collects = out["collects"]
        if cfg.payload_checksum:
            res["checksum_failures_per_step"] = [float(c["checksum_failures"]) for c in collects]
        if cfg.resilience:
            res["live_workers_per_step"] = [float(c["live_workers"]) for c in collects]
        if arm == "drqsgd_bloom_checksum":
            _check(res["checksum_failures_per_step"] == [0.0] * ARM_STEPS, f"{arm}: failures with nothing firing")
            buf = ex.encode_worker({n: torch.zeros(s, device="cuda") for n, s in ex.shapes.items()}, None, step=0,
                                   worker=0)[0]
            res["checksum_cost"] = _checksum_cost16(ex, buf)
            res["step_device_ms_and_launches"] = _device_ms(lambda: trainer.step(state, batches(0)), 3)
            res["flagship_step_device_ms_and_launches"] = timing["drqsgd_bloom"]
        if arm == "drqsgd_bloom_chaos":
            expect = _chaos_expected16(ex, out["records"])
            _check(res["checksum_failures_per_step"] == [float(x) for x in expect["failed_units_per_step"]],
                   f"{arm}: failures {res['checksum_failures_per_step']} vs the host's {expect}")
            _check(sum(expect["failed_units_per_step"]) > 0, f"{arm}: no payload failed")
            res["host_expected"] = expect
        if arm == "drqsgd_bloom_faultplan":
            _check(res["live_workers_per_step"] == [1.0, 0.0, 1.0], f"{arm}: live {res['live_workers_per_step']}")
            comp, mean, new_res = out["records"]["finish"][1]
            for n in comp:
                _check(not bool(mean[n].any()), f"{arm}: step 1 aggregate {n} is not zero")
                _check(torch.equal(new_res[n], comp[n]), f"{arm}: step 1 residual {n} is not the compensated one")
        if qsgd:
            segs = _main_path_table(ex, seed=61)
            got, ref_rows = _encode_on_card_and_cpu(segs, ex.fused_nbytes, cfg.quantum_num, cfg.bucket_size)
            res["qsgd_table_max_abs_err"] = _check_rows(got, ref_rows, segs, cfg.bucket_size, cfg.quantum_num,
                                                        f"the {arm} table")
        else:
            res["card_vs_cpu"], _ = _route_card_vs_cpu(trainer, state, batches(0), mask=True)
        print(f"phase 16 ok: {arm} " + json.dumps(res), flush=True)
        arms[arm] = res
        del trainer, state, out
        torch.cuda.empty_cache()
    arms.update(_inproc16(seed, tokens3))
    extras["inproc_exchange"] = _inproc_exchange16(seed)
    print("phase 16 ok: inproc_exchange " + json.dumps(extras["inproc_exchange"]), flush=True)
    # the CLI, as a user runs it: 8 in-process workers on the card, for 12
    # steps (its fault plan drops worker 2 in steps 5 to 8; the default 24
    # took 95-141 s of the script's time limit)
    t0 = time.perf_counter()
    cli = sp.run([sys.executable, "-m", "deepreduce_tpu_torch.resilience", "check", "--steps", "12"],
                 capture_output=True, text=True, timeout=900, cwd=os.path.dirname(os.path.abspath(__file__)))
    _check(cli.returncode == 0, f"resilience check exited {cli.returncode}: {cli.stdout[-2000:]} {cli.stderr[-2000:]}")
    report = json.loads(cli.stdout)
    _check(report["ok"] and all(report["checks"].values()) and report["device"].startswith("cuda"),
           f"resilience check: {report}")
    extras["cli_check"] = dict(report, wall_s=time.perf_counter() - t0)
    print("phase 16 ok: cli_check " + json.dumps(extras["cli_check"]), flush=True)
    print("phase 16 note: W = 1 runs one rank of NCCL and W = 4 runs four threads on one card, so no hop or "
          "all_gather crosses between cards here; the ring's hops over NCCL between cards are not measured",
          flush=True)
    return arms, extras


# phase 17: the in-collective remainders and the two-tier exchange on the
# full-width WordLSTM. At W = 1 through the NCCL group: (knobs over the
# flagship's, the arm whose parameters and residuals it must equal bitwise
# after every step, or None); the payload bytes are the JAX package's
# (test_phase17_wire_constants_match_jax). The count sketch's C is 162,030
# columns (costmodel.sketch_cols: 2k / rows).
PHASE17 = {
    "rs_sketch": (dict(RS, rs_mode="sketch", rs_sketch_rows=5, rs_sketch_cols=0), None),
    "rs_auto": (dict(RS, rs_mode="auto"), "rs_sparse"),  # the cost model picks sparse at W = 1
    "hier_w1": (dict(hier=True, ici_size=1), "drqsgd_bloom"),  # a slice mean of one is the identity
}
REF17 = {"drqsgd_bloom": {}, "rs_sparse": dict(RS, rs_mode="sparse")}
PAYLOAD17 = {"rs_sketch": 6_481_192, "rs_auto": 9_721_776, "hier_w1": 1_189_616}
# four in-process workers on the one card as InProcessGrid(2, 2), each on a
# quarter of the batch: (knobs over the flagship's, (DCN bytes, ICI bytes)
# a worker-step, qsgd_quantize and qsgd_encode_rows launches a worker-step)
GRID17 = (2, 2)
HIER17 = {
    "hier_dense_fused": (dict(hier=True), (1_189_616, 16_202_992), (0, 1)),
    # bench.py:1015-1019's qar+quantized: 2 levels launches for the qar slice leg, 1 for the route
    "hier_qar_quantized": (dict(RS, rs_mode="quantized", memory="none", hier=True, hier_ici="qar"),
                           (5_734_536, 4_082_592), (3, 0)),
    "hier_auto": (dict(deepreduce=None, hier=True, hier_ici="auto", hier_dcn="auto"), (3_240_652, 4_082_592),
                  (2, 0)),
    "stream_hier": (dict(hier=True, bucket_bytes=BUCKET_BYTES, bucket_order="reverse", stream_exchange=True),
                    (1_183_992, 16_202_992), (0, 5)),
}
PLAN17 = {"ici": "qar", "dcn": "fused"}


def sketch_reorder_bound(values, indices, rows: int, cols: int, seed: int):
    """f64 [rows, cols]: per cell of a count sketch, the most two orders of
    its float32 column sum can differ, 2 gamma(n - 1) sum |v| over the cell's
    n nonzero addends (gamma(m) = m u / (1 - m u), u = 2**-24: a sum of n
    terms in any order rounds n - 1 times and errs by at most gamma(n - 1)
    sum |v|; zeros add exactly). The card's `index_add_` adds in atomic
    order, the CPU's in slot order."""
    import torch

    from deepreduce_tpu_torch import u32
    from deepreduce_tpu_torch.codecs import countsketch

    idx = indices.cpu().to(torch.int64) & u32.MASK32
    v = values.cpu().double()
    out = torch.zeros(rows, cols, dtype=torch.float64)
    for r, (a_mult, _) in enumerate(countsketch.row_constants(rows, seed)):
        col = countsketch._bucket(idx, a_mult, cols)
        n = torch.zeros(cols, dtype=torch.float64).index_add_(0, col, (v != 0).double())
        m = torch.clamp(n - 1, min=0) * 2.0 ** -24
        out[r] = 2 * m / (1 - m) * torch.zeros(cols, dtype=torch.float64).index_add_(0, col, v.abs())
    return out


def sketch_route_card_vs_cpu(route, flat) -> dict:
    """`route(x)` -> (mean, own) of the sparse_rs sketch route on `flat`
    (f32 on the card) and on the CPU: the sampled top-k the sketch is built
    from bitwise equal; the card's sketch table within
    `sketch_reorder_bound` of the CPU's, cell by cell; and given the CPU's
    table, the card's mean and own-transmitted tensor bitwise the CPU's
    (what follows the table, the median-of-rows read, the re-selection and
    the unique-index scatters, is order-free)."""
    import torch

    from deepreduce_tpu_torch.codecs import countsketch

    real = countsketch.sketch_from_sparse
    seen = []

    def spy(values, indices, rows, cols, *, seed=0):
        table = real(values, indices, rows, cols, seed=seed)
        seen.append((table, values, indices, rows, cols, seed))
        return table

    def replay(values, indices, rows, cols, *, seed=0):
        return cpu_table.to(values.device)

    out = {}
    try:
        countsketch.sketch_from_sparse = spy
        out["cpu"] = route(flat.cpu())
        out["cuda"] = route(flat)
        cpu_table = seen[0][0]
        countsketch.sketch_from_sparse = replay
        out["cuda_from_cpu_table"] = route(flat)
    finally:
        countsketch.sketch_from_sparse = real
    torch.cuda.synchronize()
    (ct, cv, ci, rows, cols, seed), (gt, gv, gi, *_) = seen[0], seen[1]
    _check(torch.equal(gv.cpu(), cv) and torch.equal(gi.cpu(), ci), "the card's sampled top-k differs from the CPU's")
    bound = sketch_reorder_bound(cv, ci, rows, cols, seed)
    diff = (gt.cpu().double() - ct.double()).abs()
    _check(bool((diff <= bound).all()), f"the card's sketch exceeds its reordering bound in {int((diff > bound).sum())} "
                                        f"cells (max |diff| {float(diff.max())})")
    for name, got, ref in zip(("mean", "own"), out["cuda_from_cpu_table"], out["cpu"]):
        _check(torch.equal(got.cpu(), ref), f"given the CPU's sketch, the card's {name} differs")
    worst = float((diff / bound.clamp(min=1e-300))[bound > 0].max()) if bool((bound > 0).any()) else 0.0
    return {"selected": int((cv != 0).sum()), "bitwise": ["top-k selection", "mean and own given the CPU's table"],
            "table_max_abs_err": float(diff.max()), "table_cells_differing": int((diff > 0).sum()),
            "table_err_over_bound_max": worst,
            "mean_max_abs_err": float((out["cuda"][0].cpu() - out["cpu"][0]).abs().max())}


def _sketch_card_vs_cpu(trainer, state, batch) -> dict:
    """One step's compensated full-width gradient through the sketch route
    on the card (over the NCCL group) and on the CPU (a one-worker group):
    `sketch_route_card_vs_cpu`."""
    import copy

    from deepreduce_tpu_torch import GradientExchanger, memory
    from deepreduce_tpu_torch.collectives import Solo
    from deepreduce_tpu_torch.train import classification_loss

    ex, cfg = trainer.exchanger, trainer.cfg
    probe = copy.deepcopy(trainer.model)
    classification_loss(probe)(batch).backward()
    comp = memory.compensate({n: p.grad for n, p in probe.flax_params().items()}, state.residuals, beta=cfg.beta,
                             gamma=cfg.gamma)
    cpu_ex = GradientExchanger(ex.shapes, cfg, device="cpu", group=Solo())
    route = lambda x: (ex if x.is_cuda else cpu_ex).route_flat(x, step=state.step)[:2]
    return sketch_route_card_vs_cpu(route, ex._flatten(comp))


def _phase17_w1(seed: int, tokens, group, ref_loss: float) -> dict:
    """The W = 1 arms through the NCCL group, each held to its reference."""
    import torch

    from deepreduce_tpu_torch import Trainer
    from deepreduce_tpu_torch.exchange import describe
    from deepreduce_tpu_torch.models import WordLSTM
    from deepreduce_tpu_torch.ops import launch_counts, reset_launch_counts

    batches = lambda i: (tokens[i, :, :-1], tokens[i, :, 1:])
    refs, results = {}, {}
    for ref, knobs in REF17.items():
        trainer = Trainer(WordLSTM(seed=seed), _flagship_cfg(seed, **knobs), lr=0.1, momentum=0.9, device="cuda",
                          group=group)
        _, out = _steps16(trainer, trainer.init_state(), batches, ARM_STEPS)
        refs[ref] = out["snaps"]
        del trainer
    for arm, (knobs, ref) in PHASE17.items():
        cfg = _flagship_cfg(seed, **knobs)
        trainer = Trainer(WordLSTM(seed=seed), cfg, lr=0.1, momentum=0.9, device="cuda", group=group)
        state = trainer.init_state()
        ex = trainer.exchanger
        torch.cuda.synchronize()
        reset_launch_counts()
        state, out = _steps16(trainer, state, batches, ARM_STEPS)
        launches = launch_counts()
        expected = {"qsgd_quantize": 0, "qsgd_encode_rows": ARM_STEPS if arm == "hier_w1" else 0}
        _check(launches == expected, f"{arm}: kernel launches {launches}, expected {expected}")
        _check_trained(state, out["losses"], ref_loss, arm)
        _check(ex.payload_bytes() == PAYLOAD17[arm], f"{arm}: payload_bytes {ex.payload_bytes()}, "
                                                     f"expected {PAYLOAD17[arm]}")
        syncs = out["syncs"]
        if arm == "rs_sketch":
            # topk_sampled reads its threshold's sign on the host, once a step
            _check(all(len(s) == 1 for s in syncs), f"{arm}: host syncs {syncs}, expected one a step")
        else:
            _check(not any(syncs), f"{arm}: host syncs in the step: {syncs}")
        if ref is not None:
            for i in range(ARM_STEPS):
                _same16(out["snaps"][i], refs[ref][i], f"{arm} vs {ref} after step {i}")
        dev_ms = out["dev_ms"]
        res = {
            "describe": describe(ex), "losses": out["losses"], "step_ms_all": dev_ms,
            "step_ms_median": statistics.median(dev_ms), "host_step_ms_all": out["host_ms"],
            "rel_volume": float(out["wire"].rel_volume()), "payload_bytes": ex.payload_bytes(), "launches": launches,
            "host_syncs_per_step": [len(s) for s in syncs], "host_sync_sites": sorted({c for s in syncs for c in s}),
            "bitwise_equal_to": ref, "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        }
        if arm == "rs_sketch":
            res["card_vs_cpu"] = _sketch_card_vs_cpu(trainer, state, batches(0))
        if arm == "rs_auto":
            _check(ex._rs_mode == "sparse", f"{arm}: resolved to {ex._rs_mode}")
            res["resolved"] = ex._rs_mode
        if arm == "hier_w1":
            _check(ex.ici_payload_bytes() == 0.0 and float(out["wire"].ici_bits) == 0.0, f"{arm}: ICI bytes at one")
            res["ici_payload_bytes"] = ex.ici_payload_bytes()
            segs = _main_path_table(ex.exchanger, seed=71)
            got, ref_rows = _encode_on_card_and_cpu(segs, ex.exchanger.fused_nbytes, cfg.quantum_num,
                                                    cfg.bucket_size)
            res["qsgd_table_max_abs_err"] = _check_rows(got, ref_rows, segs, cfg.bucket_size, cfg.quantum_num,
                                                        f"the {arm} table")
        print(f"phase 17 ok: {arm} " + json.dumps(res), flush=True)
        results[arm] = res
        del trainer, state, out
        torch.cuda.empty_cache()
    return results


def _grid_trainers(seed: int, cfg):
    """The four in-process Trainers of an InProcessGrid(2, 2), built before
    any counted run: moving a model to the card is a copy."""
    from deepreduce_tpu_torch import Trainer
    from deepreduce_tpu_torch.collectives import InProcessGrid
    from deepreduce_tpu_torch.models import WordLSTM

    grid = InProcessGrid(*GRID17)
    trainers = [Trainer(WordLSTM(seed=seed), cfg, lr=0.1, momentum=0.9, device="cuda", group=grid.member(r))
                for r in range(grid.world_size)]
    return grid, trainers, [t.init_state() for t in trainers]


def _grid_steps(grid, trainers, states, tokens, steps: int):
    """`steps` Trainer steps of every worker of the grid, one thread a
    worker on its quarter of the batch, under the sync debug mode: (each
    worker's (state, [(start, end, loss, wire)]), the host sync sites)."""
    import warnings

    import torch

    shard = tokens.shape[1] // grid.world_size

    def worker(pair, trainer, state):
        r = pair[1].rank * GRID17[1] + pair[0].rank
        lo = r * shard
        out = []
        for coll in pair:  # every worker built before the clock starts
            coll.all_reduce_sum(torch.zeros(1, device="cuda"))
        for i in range(steps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            state, loss, wire = trainer.step(state, (tokens[i, lo : lo + shard, :-1], tokens[i, lo : lo + shard, 1:]))
            end.record()
            out.append((start, end, loss, wire))
        return state, out

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            outs = grid.run(worker, trainers, states)
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return outs, sorted({f"{w.filename}:{w.lineno}" for w in caught if "called a synchronizing" in str(w.message)})


def _grid_exchange_card_vs_cpu(seed: int, cfg) -> dict:
    """One (2, 2) hierarchical exchange of full-width random gradients (one
    residual a slice) on the card and on the CPU under the same streams:
    every worker's aggregate and residuals bitwise equal, all workers'
    aggregates alike; and each kernel of the arm's legs held bitwise
    against its plain version on this exchange's own inputs. The streamed
    arm's exchanger is its barrier one (the schedule is the Trainer's)."""
    import torch

    from deepreduce_tpu_torch import qar, sparse_rs
    from deepreduce_tpu_torch.collectives import InProcessGrid
    from deepreduce_tpu_torch.exchange import build_exchanger
    from deepreduce_tpu_torch.models import WordLSTM
    from deepreduce_tpu_torch.ops import (
        bucket_norms_ordered, philox_uniforms_plain, quantize_levels, quantize_levels_plain, scale_from_norms)
    from deepreduce_tpu_torch.sparse import per_tensor_stream

    S, P = GRID17
    shapes = {n: tuple(p.shape) for n, p in WordLSTM(embed_dim=96, hidden_dim=670).flax_params().items()}
    gen = torch.Generator().manual_seed(seed + 17)
    grads = [{n: torch.randn(s, generator=gen) * 1e-2 for n, s in shapes.items()} for _ in range(S * P)]
    res = [{n: torch.randn(s, generator=gen) * 1e-3 for n, s in shapes.items()} for _ in range(S)]
    out, exs = {}, {}
    for dev in ("cuda", "cpu"):
        def work(pair, g, dev=dev):
            ex = build_exchanger(shapes, cfg, device=dev, group=pair)
            r = None if cfg.memory == "none" else {n: t.to(dev) for n, t in res[pair[1].rank].items()}
            agg, new_r, _ = ex.exchange({n: t.to(dev) for n, t in g.items()}, r, step=1)
            return ex, {n: t.cpu() for n, t in agg.items()}, {n: t.cpu() for n, t in (new_r or {}).items()}

        got = InProcessGrid(S, P).run(work, grads)
        exs[dev] = got[0][0]
        out[dev] = [o[1:] for o in got]
    for w in range(S * P):
        for k, what in ((0, "aggregate"), (1, "residual")):
            for n, ref in out["cpu"][w][k].items():
                _check(torch.equal(out["cuda"][w][k][n], ref), f"worker {w}: {what} {n} differs between card and CPU")
        for n, ref in out["cuda"][0][0].items():
            _check(torch.equal(out["cuda"][w][0][n], ref), f"worker {w}: aggregate {n} differs from worker 0's")
    ex = exs["cuda"]
    kernels = {}
    flat = ex.exchanger._flatten({n: t.cuda() for n, t in grads[0].items()})
    if ex.ici_leg == "qar":
        padded = torch.zeros(qar.pad_len(ex.d, P, cfg.bucket_size), device="cuda")
        padded[: ex.d] = flat
        kernels["qsgd_quantize/qar_leg"] = (padded, cfg.quantum_num, cfg.bucket_size,
                                            per_tensor_stream(cfg.seed, qar.STREAM_PHASE1, 1, 0))
    if ex.exchanger._rs_mode == "quantized" and ex.inner_cfg.communicator == "sparse_rs":
        bs = cfg.rs_block_size
        padded = torch.zeros(sparse_rs.padded_shard(ex.d, S, bs) * S, device="cuda")
        padded[: ex.d] = flat
        kernels["qsgd_quantize/quantized_route"] = (padded, sparse_rs.quantized_levels_budget(S), bs,
                                                    ex.exchanger.stream(sparse_rs.STREAM_QUANTIZED, 1))
    errs = {}
    for name, (x, q, bs, stream) in kernels.items():
        scale = scale_from_norms(bucket_norms_ordered(x, bs), q)[:, None].expand(-1, bs).reshape(-1)
        got = quantize_levels(x, scale, *stream, device=x.device)
        ref = quantize_levels_plain(x.cpu(), scale.cpu(), philox_uniforms_plain(x.numel(), *stream))
        torch.cuda.synchronize()
        errs[name] = float((got.cpu().int() - ref.int()).abs().max())
        _check(torch.equal(got.cpu(), ref), f"{name}: qsgd_quantize != plain (max |diff| {errs[name]})")
    if any(c.rows_leaf is not None for c in ex.exchanger.codecs.values()):
        segs = _main_path_table(ex.exchanger, seed=seed + 73)
        rows, ref_rows = _encode_on_card_and_cpu(segs, ex.exchanger.fused_nbytes, cfg.quantum_num, cfg.bucket_size)
        errs["qsgd_encode_rows"] = _check_rows(rows, ref_rows, segs, cfg.bucket_size, cfg.quantum_num,
                                               "the DCN leg's table")
    return {"workers": S * P, "bitwise": ["aggregates", "residuals", "card = CPU", "all workers alike"],
            "kernels_vs_plain_max_abs_err": errs}


def _phase17_grid(seed: int, tokens) -> dict:
    """The four in-process (2, 2) arms on the one card."""
    import torch

    from deepreduce_tpu_torch.exchange import describe
    from deepreduce_tpu_torch.ops import launch_counts, reset_launch_counts

    S, P = GRID17
    W = S * P
    results = {}
    for arm, (knobs, (dcn_bytes, ici_bytes), (per_quantize, per_encode)) in HIER17.items():
        cfg = _flagship_cfg(seed, **knobs)
        grid, trainers, states = _grid_trainers(seed, cfg)
        ex = trainers[0].exchanger
        plan = describe(trainers[0].streaming or ex)
        reset_launch_counts()
        t0 = time.perf_counter()
        outs, syncs = _grid_steps(grid, trainers, states, tokens, ARM_STEPS)
        wall = (time.perf_counter() - t0) * 1e3
        launches = launch_counts()
        expected = {"qsgd_quantize": per_quantize * W * ARM_STEPS, "qsgd_encode_rows": per_encode * W * ARM_STEPS}
        _check(launches == expected, f"{arm}: kernel launches {launches}, expected {expected}")
        _check(not syncs, f"{arm}: host syncs at {syncs}")
        _check((ex.payload_bytes(), ex.ici_payload_bytes()) == (dcn_bytes, ici_bytes),
               f"{arm}: DCN / ICI bytes {ex.payload_bytes()} / {ex.ici_payload_bytes()}, expected "
               f"{dcn_bytes} / {ici_bytes}")
        if arm == "hier_auto":
            _check({k: ex.plan[k] for k in PLAN17} == PLAN17, f"{arm}: plan {ex.plan}")
        # the replicas agree: every worker's parameters alike, a slice's residuals alike
        final = [st for st, _ in outs]
        for w in range(W):
            for n, p in final[0].params.items():
                _check(torch.equal(final[w].params[n], p), f"{arm}: worker {w}'s parameter {n} differs")
            for n, r in (final[w - w % P].residuals or {}).items():
                _check(torch.equal(final[w].residuals[n], r), f"{arm}: worker {w}'s residual {n} differs in its slice")
        steps0 = outs[0][1]
        losses = [float(s[2]) for s in steps0]
        _check(all(math.isfinite(l) for l in losses), f"{arm}: losses {losses}")
        _check(all(bool(torch.isfinite(p).all()) for p in final[0].params.values()), f"{arm}: non-finite parameters")
        dev_ms = [s[0].elapsed_time(s[1]) for s in steps0]
        wire = steps0[-1][3]
        res = {
            "describe": plan, "losses": losses, "worker0_step_ms_all": dev_ms,
            "step_ms_median": statistics.median(dev_ms), "step_ms_spread": max(dev_ms) - min(dev_ms),
            "wall_ms_all_steps": wall, "launches": launches,
            "launches_per_worker_step": {k: v / (W * ARM_STEPS) for k, v in launches.items()}, "host_syncs": 0,
            "dcn_payload_bytes": ex.payload_bytes(), "ici_payload_bytes": ex.ici_payload_bytes(),
            "ici_bits": float(wire.ici_bits), "rel_volume": float(wire.rel_volume()),
        }
        if ex.plan is not None:
            res["plan"] = {k: ex.plan[k] for k in ("ici", "dcn", "modeled_step_s")}
        snaps = [_snapshot16(st) for st in final]
        del grid, trainers, states, outs, final
        torch.cuda.empty_cache()
        if cfg.stream_exchange:
            # the same config without streaming, from the same weights: bitwise
            grid, trainers, states = _grid_trainers(seed, _flagship_cfg(seed, **dict(knobs, stream_exchange=False)))
            bouts, _ = _grid_steps(grid, trainers, states, tokens, ARM_STEPS)
            for w in range(W):
                _same16(snaps[w], _snapshot16(bouts[w][0]), f"{arm} worker {w} vs the barrier schedule")
            res["bitwise_equal_to"] = "the same config without streaming"
            del grid, trainers, states, bouts
        del snaps
        res["card_vs_cpu"] = _grid_exchange_card_vs_cpu(seed, cfg)
        print(f"phase 17 ok: {arm} " + json.dumps(res), flush=True)
        results[arm] = res
        torch.cuda.empty_cache()
    return results


def phase_two_tier(seed: int, tokens, group, ref_loss: float) -> dict:
    """Phase 17: the sparse_rs sketch and auto routes and the two-tier
    exchange. Returns {arm: result}."""
    tokens3 = tokens[:ARM_STEPS].cuda()
    results = _phase17_w1(seed, tokens3, group, ref_loss)
    results.update(_phase17_grid(seed, tokens3))
    print("phase 17 note: W = 1 runs one rank of NCCL and the (2, 2) grid runs four threads on one card, so no "
          "slice mean or cross-slice gather crosses between cards here; the two tiers over NCCL between cards and "
          "nodes are not measured", flush=True)
    return results


# phase 18: the population-scale federated simulator. The linear arms are
# the JAX package's FedSim benchmark geometry (BENCH_FED_r13.json `detail`:
# dimension 256, batch 4, 2 local steps, a population of 131,072 with a
# per-client residual bank, a cohort of 16,384 in blocks of 128, top-k 25%
# with a mod-blocked bloom index) under `fedsim check`'s churn and chaos,
# sync, async (BENCH_FEDASYNC_r20.json: K 16,384, alpha 0.5, latency
# "0.5,0.3,0.2"), two tenants (BENCH_FEDMT_r21.json) and BENCH_POP_r25.json's
# mild_skew population with the SLO monitor; the MobileNet arm phase 12's
# DRQSGD-BF-P0 round at full width over a population of 512.
FED18_LINEAR = dict(dim=256, batch=4, local_steps=2, population=131_072, cohort=16_384, chunk=1024, lr=0.1)
# the benchmark record's block (a CPU-mesh memory bound): on the card each
# block pays its launches whatever its size, so a tick of 128 blocks is
# host-bound (2.7 s on an H100 80GB HBM3 at 700 W, PERF.md); the arms run 16
# blocks of 1,024 and the sync arm times one tick at this block too
FED18_BENCH_CHUNK = 128
FED18_BENCH_TICKS = 1  # ticks in blocks of FED18_BENCH_CHUNK (1, not 2: phase 21's time)
FED18_CODEC = dict(deepreduce="index", index="bloom", bloom_blocked="mod", compress_ratio=0.25, fpr=0.01,
                   memory="residual", min_compress_size=8)
FED18_CHURN = dict(resilience=True, fault_plan="3@1,5@2:4", drop_rate=0.05, payload_checksum=True,
                   chaos_corrupt_rate=0.2)
FED18_ASYNC = dict(fed_async=True, fed_async_k=16_384, fed_async_alpha=0.5, fed_async_latency="0.5,0.3,0.2")
POP18_MILD_SKEW = ('{"version": 1, "num_labels": 8, "label_shift": 0.05, "classes": ['
                   '{"name": "bulk", "weight": 3.0, "data_alpha": 4.0}, '
                   '{"name": "tail", "weight": 1.0, "data_alpha": 1.0, "data_bias": 2.0}]}')
PHASE18 = {
    "fedsim_linear_sync": dict(knobs={}, ticks=4),
    "fedsim_linear_async": dict(knobs=FED18_ASYNC, ticks=6, stream=True),
    "fedsim_linear_mt": dict(knobs=dict(FED18_ASYNC, fed_tenants=2), ticks=6, stream=True,
                             masks=[(True, True)] * 2 + [(True, False)] * 2 + [(True, True)] * 2),
    "fedsim_linear_pop_slo": dict(knobs=dict(FED18_ASYNC, pop_spec=POP18_MILD_SKEW), ticks=6, slo=True),
}
FED18_MOBILENET = dict(population=512, cohort=32, chunk=4, local_steps=4, batch=24, lr=0.2, momentum=0.9,
                       rounds=3, scan_rounds=1)
# the MobileNet arm's knobs make its local training chaotic in float32: four
# steps of SGD 0.2 with momentum 0.9 turn two summation orders of one
# gradient (a few percent of its largest entry apart, BatchNorm at batch
# 24) into updates tens of percent apart, so a round batched and the same
# round one client at a time are held together where they are one
# function: local training in float64 (within MOBILENET_F64_RTOL of the
# largest change: the same chaos takes float64's last bits to about 4e-9 of
# it on the card against the CPU), the compression and the aggregation
# given the same client updates (within MOBILENET_ROUND_RTOL of the
# largest update)
MOBILENET_F64_RTOL = 1e-7
# the block's clients also trained alone in float64 against their batched
# rows: one (a float64 client alone takes ~16 s on the card; all four took
# ~64 s of the script's time limit)
MOBILENET_ALONE = 1
# the linear arms' card-vs-CPU tick runs at 1/8 of the population, cohort and K
FED18_CPU_CUT = 8
MOBILENET_ROUND_RTOL = 1e-6


def _fed_law(cfg, n: int, D: int, K: int, T: int) -> int:
    """The fused all_reduce's operand bytes a tick: sync 4(n+6), async
    4(n+7+D), +4K with a K-class population, +4D more with per-class latency
    rows; T tenants T times the single-tenant buffer."""
    if not cfg.fed_async:
        return 4 * T * (n + 6 + K)
    return 4 * T * (n + 7 + D + K + (D if K and "latency" in (cfg.pop_spec or "") else 0))


def _fed_to(state, device):
    """A federated state with every tensor moved to `device` (copied)."""
    import dataclasses

    import torch

    def move(v):
        if torch.is_tensor(v):
            return v.to(device, copy=True)
        if isinstance(v, dict):
            return {k: move(x) for k, x in v.items()}
        if dataclasses.is_dataclass(v):
            return dataclasses.replace(v, **{f.name: move(getattr(v, f.name)) for f in dataclasses.fields(v)})
        return v

    return move(state)


def _fed_max_err(a, b) -> float:
    """Max |a - b| over every tensor of two federated states (b on the CPU)."""
    from deepreduce_tpu_torch.checkpoint import _split_state

    ta, _ = _split_state(a)
    tb, _ = _split_state(b)
    return max(float((ta[k].cpu().double() - tb[k].double()).abs().max()) if ta[k].numel() else 0.0 for k in ta)


def _fed_close(a, b, what: str, rtol: float = 1e-5, atol: float = 1e-6) -> float:
    import torch

    from deepreduce_tpu_torch.checkpoint import _split_state

    ta, ha = _split_state(a)
    tb, hb = _split_state(b)
    _check(ha == hb and ta.keys() == tb.keys(), f"{what}: state structure differs")
    for k in ta:
        x, y = ta[k].cpu(), tb[k].cpu()
        if x.dtype.is_floating_point:
            _check(torch.allclose(x, y, rtol=rtol, atol=atol), f"{what}: {k} differs beyond rtol {rtol} atol {atol}")
        else:
            _check(torch.equal(x, y), f"{what}: {k} differs")
    return _fed_max_err(a, b)


def _fed_bitwise(a, b) -> bool:
    from deepreduce_tpu_torch.fedsim.__main__ import _equal

    return _equal(a, b)


def _fed_resume(make, state_at, key: int, ticks, final) -> dict:
    """Save `state_at` (a checkpoint into memory), restore it into a fresh
    driver's state, replay `ticks` (round indices, with their active masks
    where given) and hold the result bitwise against `final`."""
    import io

    import torch

    from deepreduce_tpu_torch import checkpoint
    from deepreduce_tpu_torch.resilience import stream

    buf = io.BytesIO()
    checkpoint.save(buf, state_at)
    nbytes = buf.tell()
    buf.seek(0)
    sim, template = make()
    state = checkpoint.restore(buf, template)
    for r, mask in ticks:
        if mask is not None:
            state = sim.set_active(state, mask)
        state, _ = sim.step(state, stream.key(key, r))
    torch.cuda.synchronize()
    _check(_fed_bitwise(state, final), "the resumed run differs from the uninterrupted one")
    return {"checkpoint_bytes": nbytes, "replayed_ticks": len(ticks), "bitwise": True}


def _fed_linear(arm: str, spec: dict, seed: int, group) -> dict:
    """One linear arm of phase 18 on the card."""
    import torch

    from deepreduce_tpu_torch import DeepReduceConfig, FedSim
    from deepreduce_tpu_torch.collectives import reduce_counts, reset_reduce_counts
    from deepreduce_tpu_torch.fedsim import FedDraws, synthetic_linear_problem
    from deepreduce_tpu_torch.fedsim.sim import teacher
    from deepreduce_tpu_torch.ops import launch_counts, reset_launch_counts
    from deepreduce_tpu_torch.resilience import stream

    g = FED18_LINEAR
    knobs = dict(FED18_CODEC, **FED18_CHURN, **spec["knobs"], fed=True, fed_num_clients=g["population"],
                 fed_clients_per_round=g["cohort"], fed_local_steps=g["local_steps"], fed_client_chunk=g["chunk"],
                 seed=seed)
    cfg = DeepReduceConfig(**knobs)
    fed = cfg.fed_config()
    p0, data_fn, loss_fn = synthetic_linear_problem(g["dim"], g["batch"], g["local_steps"], device="cuda")
    w_true = teacher(g["dim"], "cuda")
    key = seed + 18

    def make(device="cuda", data=data_fn, draws=None, grp=group):
        sim = FedSim(loss_fn, cfg, fed, g["lr"], data, group=grp, client_chunk=g["chunk"], draws=draws,
                     device=device)
        return sim, sim.init({n: p.to(device) for n, p in p0.items()})

    sim, state = make()
    T = max(cfg.fed_tenants, 1)
    masks = spec.get("masks", [None] * spec["ticks"])
    w_err = lambda st: torch.linalg.norm(st.params["w"] - w_true, dim=-1) / torch.linalg.norm(w_true)
    err0 = w_err(state)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    reset_reduce_counts()
    ticks, syncs, mets, errs, saved = [], [], [], [], None
    # the stream arms run `stream()` between mask flips and up to the
    # checkpoint after tick `save`; every tick timed by CUDA events
    save = spec["ticks"] - 1
    i = 0
    while i < spec["ticks"]:
        run = 1
        if spec.get("stream"):
            while i + run < spec["ticks"] and masks[i + run] == masks[i] and i + run != save:
                run += 1
        if masks[i] is not None:
            state = sim.set_active(state, masks[i])
        events = [torch.cuda.Event(enable_timing=True) for _ in range(run + 1)]
        if spec.get("stream"):
            (state, hist, _), s = _counting_syncs(
                lambda: sim.stream(state, key, run, on_tick=lambda t: events[t].record()))
        else:
            events[0].record()
            (state, m), s = _counting_syncs(lambda: sim.step(state, stream.key(key, i)))
            events[1].record()
            hist = [m]
        torch.cuda.synchronize()
        ticks += [events[t].elapsed_time(events[t + 1]) for t in range(run)]
        syncs += [s] + [[]] * (run - 1)
        mets += hist
        errs.append(w_err(state))
        i += run
        if i == save:
            saved = (i, _fed_to(state, "cuda"))
    launches = launch_counts()
    reduces = reduce_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"phase 18 note: {arm} tick ms {[round(t, 1) for t in ticks]}", flush=True)
    n = g["dim"] + 1
    D = len(sim.latency_probs) if cfg.fed_async else 0
    K = sim.pop.num_classes if sim.pop is not None else 0
    law = _fed_law(cfg, n, D, K, T)
    _check(reduces["all_reduce"] == spec["ticks"], f"{arm}: {reduces['all_reduce']} all_reduce calls in "
           f"{spec['ticks']} ticks, expected one a tick")
    _check(reduces["all_reduce_bytes"] == spec["ticks"] * law, f"{arm}: all_reduce bytes {reduces} against the law "
           f"{law} a tick")
    _check(launches["qsgd_encode_rows"] == 0 and launches["qsgd_quantize"] == 0, f"{arm}: kernel launches {launches}")
    _check(all(bool(torch.isfinite(p).all()) for p in state.params.values()), f"{arm}: non-finite parameters")
    fails = float(sum(m["checksum_failures"].sum() for m in mets))
    _check(fails > 0, f"{arm}: no checksum failure caught under chaos")
    err_first, err_last = float(err0.max()), float(errs[-1].max())
    _check(err_last < err_first, f"{arm}: w_rel_err did not fall ({err_first} -> {err_last})")
    res = {
        "population": g["population"], "cohort": g["cohort"], "chunk": g["chunk"], "tenants": T,
        "tick_ms_all": ticks, "tick_ms_median": statistics.median(ticks),
        "host_syncs_per_tick": [len(s) for s in syncs], "sync_call_sites": sorted({x for s in syncs for x in s}),
        "launches": launches, "all_reduce_per_tick": reduces["all_reduce"] / spec["ticks"],
        "all_reduce_bytes_per_tick": reduces["all_reduce_bytes"] / spec["ticks"], "all_reduce_bytes_law": law,
        "peak_mem_bytes": peak, "w_rel_err": [float(e.max()) for e in [err0] + errs],
        "checksum_failures": fails, "clients_per_tick": [m["clients"].tolist() for m in mets],
    }
    if cfg.fed_async:
        res["staleness_hist"] = [m["staleness_hist"].tolist() for m in mets]
        res["applied"] = [m["applied"].tolist() for m in mets]
    if K:
        res["pop_hist"] = [m["pop_hist"].tolist() for m in mets]
        _check(all(abs(float(m["pop_hist"].sum()) - float(m["clients"])) < 1e-3 for m in mets),
               f"{arm}: the class histogram's mass is not the accepted count")
    if spec.get("slo"):
        res["slo"] = _fed_slo(cfg, mets, errs)
    # a mid-run checkpoint and the bitwise replay
    at, st_at = saved
    res["resume"] = _fed_resume(make, st_at, key, [(r, masks[r]) for r in range(at, spec["ticks"])], state)
    # one tick card = CPU on the same draws: the batches made on the CPU,
    # every other draw the same counter-based stream on both
    t = time.perf_counter()
    res["card_vs_cpu"] = _fed_linear_card_vs_cpu(spec, cfg, loss_fn, g, key)
    res["card_vs_cpu_s"] = time.perf_counter() - t
    if arm == "fedsim_linear_sync":
        res["tick_ms_at_bench_chunk"] = _fed_bench_chunk_tick(cfg, loss_fn, data_fn, g, state, key, spec["ticks"])
    return res


def _fed_bench_chunk_tick(cfg, loss_fn, data_fn, g, state, key: int, r: int) -> list:
    """FED18_BENCH_TICKS ticks from `state` in blocks of FED18_BENCH_CHUNK
    clients (CUDA events), the benchmark record's block size."""
    import dataclasses

    import torch

    from deepreduce_tpu_torch import FedSim
    from deepreduce_tpu_torch.resilience import stream

    small = dataclasses.replace(cfg, fed_client_chunk=FED18_BENCH_CHUNK)
    sim = FedSim(loss_fn, small, small.fed_config(), g["lr"], data_fn, client_chunk=FED18_BENCH_CHUNK,
                 device="cuda")
    st = _fed_to(state, "cuda")
    out = []
    for t in range(FED18_BENCH_TICKS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        st, _ = sim.step(st, stream.key(key, r + t))
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def _fed_linear_card_vs_cpu(spec: dict, cfg, loss_fn, g, key: int) -> dict:
    """One tick on the card and on the CPU from the same state, on the arm's
    knobs with the population, the cohort and K cut by FED18_CPU_CUT (the
    CPU's tick at full size would take minutes): two ticks on the card make
    the state, then one more on each. The batches are made on the CPU for
    both (the stream's normals may differ in the last bit between the two),
    every other draw is the same integer stream on both, and local training
    runs in float64, rounded to float32 (in float32 the matmuls' summation
    orders differ between the two, and among many clients' top-k selections
    some near-tie lets that last bit choose). States and metrics within
    1e-5 relative, 1e-6 absolute."""
    import dataclasses

    import torch
    from torch.utils._pytree import tree_map

    from deepreduce_tpu_torch import FedSim
    from deepreduce_tpu_torch.fedsim import FedDraws, synthetic_linear_problem
    from deepreduce_tpu_torch.population import sampler
    from deepreduce_tpu_torch.resilience import stream

    cut = FED18_CPU_CUT
    knobs = dict(fed_num_clients=cfg.fed_num_clients // cut, fed_clients_per_round=cfg.fed_clients_per_round // cut)
    if cfg.fed_async:
        knobs["fed_async_k"] = cfg.fed_async_k // cut
    small = dataclasses.replace(cfg, **knobs)
    _, data_cpu, _ = synthetic_linear_problem(g["dim"], g["batch"], g["local_steps"], device="cpu")
    p0 = {"b": torch.zeros(()), "w": torch.zeros(g["dim"])}
    keys = {}

    def labels_for(device):
        if small.pop_spec is None:
            return None
        from deepreduce_tpu_torch.population.spec import PopulationSpec

        pop = PopulationSpec.load_any(small.pop_spec)
        classes = sampler.class_assignments(pop, small.fed_num_clients)

        def labels(rnd, gids, t):
            g_cpu = gids.cpu()
            pi = sampler.label_mixtures(pop, g_cpu, classes[g_cpu])
            return sampler.draw_labels(keys[device](rnd, t), g_cpu, pi, (g["local_steps"], g["batch"])).to(device)

        return FedDraws(labels=labels)

    def sim_on(device):
        data = lambda gids, rnd, k: tuple(t.to(device) for t in data_cpu(gids.cpu(), rnd, k))  # noqa: E731
        sim = FedSim(loss_fn, small, small.fed_config(), g["lr"], data, client_chunk=g["chunk"],
                     draws=labels_for(device), device=device)
        keys[device] = lambda rnd, t, sim=sim: sim._keys(stream.key(key, rnd), t)["data"]

        def train64(ref, batches, train=sim._local_train):
            to64 = lambda t: t.double() if t.is_floating_point() else t  # noqa: E731
            out = train({n: r.double() for n, r in ref.items()}, tree_map(to64, batches))
            return {n: p.float() for n, p in out.items()}

        sim._local_train = train64
        return sim, sim.init({n: p.to(device) for n, p in p0.items()})

    card, st = sim_on("cuda")
    for r in range(2):
        st, _ = card.step(st, stream.key(key, r))
    host, _ = sim_on("cpu")
    out = {"cuda": card.step(_fed_to(st, "cuda"), stream.key(key, 2)),
           "cpu": host.step(_fed_to(st, "cpu"), stream.key(key, 2))}
    torch.cuda.synchronize()
    # a profiled tick at this size (a full tick's ~240,000 kernel events
    # take the profiler minutes to sort): its launches and idle share
    prof = _profile_step(lambda: card.step(_fed_to(st, "cuda"), stream.key(key, 2)))
    (cs, cm), (gs, gm) = out["cpu"], out["cuda"]
    err = _fed_close(gs, cs, "linear tick card vs CPU")
    for k in cm:
        _check(torch.allclose(gm[k].cpu(), cm[k], rtol=1e-5, atol=1e-6), f"card vs CPU metric {k}")
    blocks = small.fed_clients_per_round // g["chunk"]
    return {"population": small.fed_num_clients, "cohort": small.fed_clients_per_round, "rtol": 1e-5, "atol": 1e-6,
            "max_abs_err": err, "clients": gm["clients"].tolist(),
            "profile": dict({k: prof[k] for k in ("wall_ms", "device_busy_ms", "device_idle_share", "kernel_launches")},
                            blocks=blocks, launches_per_block=prof["kernel_launches"] / blocks)}


def _fed_slo(cfg, mets, errs) -> dict:
    """The SLO monitor (`fedsim check`'s embedded spec) over the tick
    reports, writing health.jsonl in a temporary directory; the trail
    replayed bitwise from the monitor state at the middle tick."""
    import json as _json

    from deepreduce_tpu_torch.fedsim.__main__ import _default_slo_spec, _slo_report
    from deepreduce_tpu_torch.slo import HealthLog, HealthMonitor, SLOSpec, validate_health_stream

    path = os.path.join(tempfile.mkdtemp(prefix="phase18_"), "health.jsonl")
    spec = SLOSpec.from_dict(_default_slo_spec(cfg))
    mon = HealthMonitor(spec, log=HealthLog(path))
    reports = []
    for t, (m, e) in enumerate(zip(mets, errs)):
        rec = {k: (v.tolist() if v.dim() else float(v)) for k, v in m.items()}
        reports.append(_slo_report(rec, float(e)))
    mid = len(reports) // 2
    saved = None
    for t, rep in enumerate(reports):
        mon.observe(t, rep)
        if t + 1 == mid:
            saved = _json.dumps(mon.state_dict(), sort_keys=True)
            at = len(mon.events)
    mon2 = HealthMonitor(spec)
    mon2.load_state_dict(_json.loads(saved))
    for t in range(mid, len(reports)):
        mon2.observe(t, reports[t])
    validate_health_stream(HealthLog.read(path))
    _check(mon2.events[at:] == mon.events[at:], "the resumed SLO trail differs")
    return {"state": mon.state_of(0), "events": len(mon.events), "health_jsonl": path,
            "healthy": mon.healthy(), "resume_bitwise": True}


def _mobilenet18(seed: int):
    """MobileNetV1 at full width on the card, a functional loss (scratch
    BatchNorm statistics, so that it runs under vmap) and a batched data
    function: class prototypes plus noise 2.5 (phase 12's task), labels and
    noise from the counter-based stream keyed by the round's data key and
    the client's id."""
    import torch
    import torch.nn.functional as F

    from deepreduce_tpu_torch.models import MobileNetV1
    from deepreduce_tpu_torch.resilience import stream

    g = FED18_MOBILENET
    model = MobileNetV1(seed=seed).cuda().train()
    protos = torch.randn(10, 32, 32, 3, generator=torch.Generator().manual_seed(seed + 18)).cuda()
    e, b = g["local_steps"], g["batch"]

    def loss_fn(p, batch):
        return F.cross_entropy(model.functional(p, batch[0], scratch_stats=True), batch[1])

    def data_fn(gids, rnd, key):
        dev = gids.device
        lab = gids[:, None] * (e * b) + torch.arange(e * b, device=dev)
        y = (stream.words_at(stream.key(key, 1), lab) % 10).reshape(-1, e, b)
        pix = gids[:, None] * (e * b * 3072) + torch.arange(e * b * 3072, device=dev)
        noise = stream.normals(stream.key(key, 2), pix).reshape(-1, e, b, 32, 32, 3)
        return protos.to(dev)[y] + 2.5 * noise, y

    return model, loss_fn, data_fn


def _fed_mobilenet(seed: int, group) -> dict:
    """Phase 18's MobileNet arm: DRQSGD-BF-P0 rounds batched (blocks of 4)
    and one by one from the same state, the grouped QSGD launches, card =
    CPU on one block, the checkpoint replay."""
    import torch

    # cuDNN's default backward algorithms accumulate with atomics, so a
    # replayed round would differ in its last bits: deterministic ones here
    cudnn = torch.backends.cudnn
    saved_modes = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        return _fed_mobilenet_arm(seed, group)
    finally:
        cudnn.deterministic, cudnn.benchmark = saved_modes


def _fed_mobilenet_arm(seed: int, group) -> dict:
    import torch

    from deepreduce_tpu_torch import DeepReduceConfig, FedSim
    from deepreduce_tpu_torch.collectives import reduce_counts, reset_reduce_counts
    from deepreduce_tpu_torch.ops import launch_counts, reset_launch_counts
    from deepreduce_tpu_torch.ops.qsgd_encode import MAX_SEGMENTS
    from deepreduce_tpu_torch.resilience import stream

    g = FED18_MOBILENET
    model, loss_fn, data_fn = _mobilenet18(seed)
    params = {n: p.detach() for n, p in model.flax_params().items()}
    n_params = sum(p.numel() for p in params.values())
    cfg = DeepReduceConfig(**FED_DRQSGD, fed=True, fed_num_clients=g["population"],
                           fed_clients_per_round=g["cohort"], fed_local_steps=g["local_steps"],
                           fed_client_chunk=g["chunk"], seed=seed)
    key = seed + 180

    def make(impl="vmap", device="cuda", grp=group):
        sim = FedSim(loss_fn, cfg, cfg.fed_config(), g["lr"], data_fn, client_momentum=g["momentum"], group=grp,
                     client_chunk=g["chunk"], impl=impl, device=device)
        return sim, sim.init(params)

    res = {"params": n_params}
    finals = {}
    for impl in ("vmap", "scan"):
        sim, state = make(impl)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        reset_reduce_counts()
        times, syncs, mets, saved = [], [], [], None
        rounds = g["rounds"] if impl == "vmap" else g["scan_rounds"]  # one by one: the comparison
        for r in range(rounds):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            (state, m), s = _counting_syncs(lambda: sim.step(state, stream.key(key, r)))
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
            syncs.append(s)
            mets.append(m)
            if impl == "vmap" and r == g["rounds"] - 2:
                saved = _fed_to(state, "cuda")
        launches = launch_counts()
        reduces = reduce_counts()
        print(f"phase 18 note: mobilenet {impl} round ms {[round(t, 1) for t in times]}", flush=True)
        segs_per_client = sum(c.rows_leaf is not None for c in sim.tc_c2s._codecs.values())
        segs_s2c = sum(c.rows_leaf is not None for c in sim.tc_s2c._codecs.values())
        blocks = g["cohort"] // g["chunk"] if impl == "vmap" else g["cohort"]
        per_block = -(-(g["chunk"] if impl == "vmap" else 1) * segs_per_client // MAX_SEGMENTS)
        want = rounds * (-(-segs_s2c // MAX_SEGMENTS) + blocks * per_block)
        _check(launches["qsgd_encode_rows"] == want, f"mobilenet {impl}: qsgd_encode_rows {launches}, the packing "
               f"gives {want}")
        n = n_params
        _check(reduces == {"all_reduce": rounds, "all_reduce_bytes": rounds * 4 * (n + 6)},
               f"mobilenet {impl}: all_reduce {reduces}")
        _check(all(bool(torch.isfinite(p).all()) for p in state.params.values()), f"mobilenet {impl}: non-finite")
        res[impl] = {
            "round_ms_all": times, "round_ms_median": statistics.median(times),
            "host_syncs_per_round": [len(s) for s in syncs], "sync_call_sites": sorted({x for s in syncs for x in s}),
            "launches": launches, "qsgd_segments_per_client": segs_per_client,
            "qsgd_encode_rows_per_round": launches["qsgd_encode_rows"] / rounds,
            "all_reduce_per_round": reduces["all_reduce"] / rounds,
            "all_reduce_bytes_per_round": reduces["all_reduce_bytes"] / rounds,
            "all_reduce_bytes_law": 4 * (n + 6), "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            "uplink_bytes": [float(m["uplink_bytes"]) for m in mets],
        }
        finals[impl] = (sim, state, saved)
    _, sv, saved = finals["vmap"]
    res["launches"] = res["vmap"]["launches"]
    t = time.perf_counter()
    res["resume"] = _fed_resume(lambda: make("vmap"), saved, key, [(g["rounds"] - 1, None)], sv)
    res["resume_s"] = time.perf_counter() - t
    del finals
    torch.cuda.empty_cache()
    t = time.perf_counter()
    res["block"] = _fed_mobilenet_block(cfg, loss_fn, data_fn, params, key)
    res["block_s"] = time.perf_counter() - t
    res["launch_ratio_scan_over_batched"] = res["block"]["launch_ratio_scan_over_batched"]
    return res


def _fed_mobilenet_block(cfg, loss_fn, data_fn, params, key: int) -> dict:
    """One block of 4 clients on a round's inputs. Local training batched
    against MOBILENET_ALONE of its clients trained alone in float64, on the
    card and against the CPU; given the same client updates (the card's float32 batched local
    training), the round's compression and aggregation batched against one
    by one and card against CPU; the block's grouped QSGD call bitwise the
    plain version and each client's own launch; and the device launches of
    the block batched and one by one (torch.profiler)."""
    import copy

    import torch
    from torch.func import grad, vmap

    from deepreduce_tpu_torch.fedsim import TreeCodec
    from deepreduce_tpu_torch.fedsim.round import cohort_updates, index_batch, make_client_step
    from deepreduce_tpu_torch.ops import qsgd_encode_rows
    from deepreduce_tpu_torch.ops.qsgd_encode import rows_nbytes

    g = FED18_MOBILENET
    lr, mom, E = g["lr"], g["momentum"], g["local_steps"]

    def trainer(loss, steps=E):
        def local_train(p, batches):
            trace = None
            for s in range(steps):
                gr = grad(loss)(p, index_batch(batches, s))
                trace = gr if trace is None else {n: gr[n] + mom * trace[n] for n in gr}
                p = {n: p[n] - lr * trace[n] for n in p}
            return p

        return local_train

    gids = torch.arange(4, device="cuda")
    batch = data_fn(gids, 0, key)
    res0 = {n: 1e-3 * torch.randn((4,) + tuple(p.shape), generator=torch.Generator().manual_seed(9)).cuda()
            for n, p in params.items()}
    out = {}

    # local training in float64: batched = one by one, card = CPU
    model64, _, _ = _mobilenet18(0)
    model64 = model64.double()
    p64 = {n: p.double() for n, p in params.items()}
    b64 = (batch[0].double(), batch[1])
    loss64 = lambda p, b: torch.nn.functional.cross_entropy(model64.functional(p, b[0], scratch_stats=True), b[1])
    train64 = trainer(loss64)
    bat = vmap(train64, in_dims=(None, 0))(p64, b64)
    change = max(float((bat[n] - p64[n]).abs().max()) for n in p64)
    one = max(float((bat[n][c] - train64(p64, index_batch(b64, c))[n]).abs().max())
              for c in range(MOBILENET_ALONE) for n in p64)
    # client 0's first local step on the CPU (the CPU's float64 MobileNet is slow)
    cpu_model = copy.deepcopy(model64).cpu()
    loss64c = lambda p, b: torch.nn.functional.cross_entropy(cpu_model.functional(p, b[0], scratch_stats=True), b[1])
    first = trainer(loss64, 1)(p64, index_batch(b64, 0))
    batc = trainer(loss64c, 1)({n: p.cpu() for n, p in p64.items()}, tuple(t[0].cpu() for t in b64))
    vs_cpu = max(float((first[n].cpu() - batc[n]).abs().max()) for n in p64)
    _check(one <= MOBILENET_F64_RTOL * change, f"float64 local training batched vs one by one: {one} vs {change}")
    _check(vs_cpu <= MOBILENET_F64_RTOL * change, f"float64 local training card vs CPU: {vs_cpu} vs {change}")
    out["f64_local_training"] = {"max_change": change, "batched_vs_one_by_one": one, "clients_alone": MOBILENET_ALONE,
                                 "card_vs_cpu_one_step": vs_cpu, "rtol": MOBILENET_F64_RTOL}
    del model64, cpu_model, bat, batc, first

    # the round's compression and aggregation on the same client updates
    p_end = vmap(trainer(loss_fn), in_dims=(None, 0))(params, batch)
    tc = TreeCodec("c2s", cfg, device="cuda")

    def compress(impl, device="cuda", tcx=tc):
        bank = {n: r.to(device, copy=True) for n, r in res0.items()}
        w = {n: p.to(device) for n, p in params.items()}
        step = make_client_step(tcx, lambda ref, b: b, w, 0)
        o = cohort_updates(step, {n: x.to(device) for n, x in p_end.items()}, bank, [0, 1, 2, 3],
                           update_template=w, impl=impl, chunk=4)
        return o, step

    (vm, step_v), (sc, _) = compress("vmap"), compress("scan")
    (cp, _) = compress("vmap", "cpu", TreeCodec("c2s", cfg, device="cpu"))
    scale = max(float(v.abs().max()) for v in sc[0].values())
    errs = {}
    for what, other in (("batched_vs_one_by_one", sc), ("card_vs_cpu", cp)):
        e = max(max(float((vm[0][n].cpu() - other[0][n].cpu()).abs().max()) for n in params),
                max(float((vm[1][n].cpu() - other[1][n].cpu()).abs().max()) for n in params))
        _check(e <= MOBILENET_ROUND_RTOL * scale, f"mobilenet round {what}: {e} against {MOBILENET_ROUND_RTOL} x {scale}")
        _check(all(float(a) == float(b) for a, b in zip(vm[2], other[2])), f"mobilenet round {what}: wire differs")
        errs[what] = {"max_abs_err": e, "bitwise": e == 0.0}
    out["round_given_updates"] = dict(errs, max_update=scale, rtol=MOBILENET_ROUND_RTOL)

    # the grouped call's rows against the plain version and each client's own launch
    segs = step_v.segments
    meta = next(c.val_codec.meta for c in tc._codecs.values() if c.rows_leaf is not None)
    total = max(s.out_offset + rows_nbytes(s.values.shape[0], meta.bucket_size) for s in segs)
    got, ref = _encode_on_card_and_cpu(segs, total, meta.quantum_num, meta.bucket_size)
    err = _check_rows(got, ref, segs, meta.bucket_size, meta.quantum_num, "the grouped cross-client table")
    per_client = torch.zeros(total, dtype=torch.uint8, device="cuda")
    per = len(segs) // 4  # client c's segments are a run of the table
    for c in range(4):
        qsgd_encode_rows(segs[c * per : (c + 1) * per], per_client, quantum_num=meta.quantum_num,
                         bucket_size=meta.bucket_size, device="cuda")
    torch.cuda.synchronize()
    _check(torch.equal(per_client.cpu(), got), "the grouped cross-client launch differs from per-client launches")
    out["grouped_encode"] = {"clients": 4, "segments": len(segs), "launches": -(-len(segs) // 128),
                             "max_abs_err": err, "equals_per_client_launches": True}

    # the device launches, local training included: the block batched, and
    # one client of it alone (the one-by-one block is four of those)
    def block(impl, n):
        bank = {k: r[:n].clone() for k, r in res0.items()}
        step = make_client_step(tc, trainer(loss_fn), params, 0)
        cohort_updates(step, tuple(t[:n] for t in batch), bank, list(range(n)), update_template=params, impl=impl,
                       chunk=n)

    prof = {"batched_block_of_4": _profile_step(lambda: block("vmap", 4)),
            "one_client": _profile_step(lambda: block("scan", 1))}
    out["profile"] = {
        what: {k: p[k] for k in ("wall_ms", "device_busy_ms", "device_idle_share", "kernel_launches")}
        for what, p in prof.items()}
    out["launch_ratio_scan_over_batched"] = (4 * prof["one_client"]["kernel_launches"]
                                             / max(prof["batched_block_of_4"]["kernel_launches"], 1))
    return out


def phase_fedsim(seed: int, group) -> dict:
    """Phase 18: the population-scale federated simulator. Returns {arm:
    result}; each arm's `launches` are its counted kernel launches."""
    import torch

    t0 = time.perf_counter()
    results = {}
    for arm, spec in PHASE18.items():
        t = time.perf_counter()
        res = _fed_linear(arm, spec, seed, group)
        res["arm_s"] = time.perf_counter() - t
        print(f"phase 18 ok: {arm} " + json.dumps(res), flush=True)
        results[arm] = res
        torch.cuda.empty_cache()
    t = time.perf_counter()
    res = _fed_mobilenet(seed, group)
    res["arm_s"] = time.perf_counter() - t
    print("phase 18 ok: fedsim_mobilenet_drqsgd " + json.dumps(res), flush=True)
    results["fedsim_mobilenet_drqsgd"] = res
    # the same rounds one client at a time: the comparison, its launches counted apart
    results["fedsim_mobilenet_drqsgd_scan"] = {"launches": res["scan"]["launches"]}
    torch.cuda.empty_cache()
    print(f"phase 18 time {time.perf_counter() - t0:.1f} s", flush=True)
    return results


# -- phase 19: telemetry, the adaptive controller, the calibrated cost model -- #

TELE19_EVERY = 3  # the accumulators' fetch cadence (telemetry_every)
TELE19_STEPS = 9
CTRL19_LADDER = "0.05,0.1,0.2"  # around the flagship's ratio 0.1
# the JAX package's payload_bytes of each rung's flagship config on the
# full-width WordLSTM (`test_phase19_rung_payload_bytes_match_jax`)
CTRL19_PAYLOAD = {0.05: 638_072, 0.1: 1_189_616, 0.2: 2_286_400}
CTRL19_CKPT_AT = 6  # the ctrl run checkpoints after this step and replays the rest
# the first step's err_cos / err_l2 on the card against the CPU: the two
# gradients differ in their last bits (cuBLAS against the CPU's BLAS), and
# top-k may then take another entry at a near-tie; both errors are O(1)
ERR19_ATOL = 1e-3
# step 5's rel_volume against phase 5's last step's: the same weights,
# batches and config, one float32 ratio each
REL19_RTOL = 1e-6
FED19_TICKS = 2


def _f32_running(values) -> float:
    """The float32 running sum of `values` from 0, as the accumulator adds."""
    import numpy as np

    acc = np.float32(0.0)
    for v in values:
        acc = np.float32(acc + np.float32(v))
    return float(acc)


def _telemetry_flagship(seed: int, tokens, group, phase5: dict) -> dict:
    """DRQSGD-BF-P0 with telemetry off (phase 5's config) and on, from the
    same weights and batches: launches, host syncs, the counters against
    the per-step WireStats, and the first step's errors card vs CPU."""
    import torch

    from deepreduce_tpu_torch import Trainer
    from deepreduce_tpu_torch.models import WordLSTM
    from deepreduce_tpu_torch.ops import launch_counts, reset_launch_counts
    from deepreduce_tpu_torch.telemetry import spans

    tok = tokens.cuda()
    batches = lambda i: (tok[i, :, :-1], tok[i, :, 1:])  # noqa: E731
    steps = TELE19_STEPS
    expected = {"qsgd_quantize": 0, "qsgd_encode_rows": steps}

    off = Trainer(WordLSTM(seed=seed), _flagship_cfg(seed), lr=0.1, momentum=0.9, device="cuda", group=group)
    st_off = off.init_state()
    torch.cuda.synchronize()
    reset_launch_counts()
    st_off, losses_off, dev_off, _, _, syncs_off = _run_steps(off, st_off, batches, steps)
    launches_off = launch_counts()
    _check(launches_off == expected, f"telemetry off: launches {launches_off}, expected {expected}")
    _check(not any(syncs_off), f"telemetry off: host syncs in the step: {syncs_off}")

    spans.configure(enabled=True, reset=True)
    cfg = _flagship_cfg(seed, telemetry=True, telemetry_every=TELE19_EVERY)
    on = Trainer(WordLSTM(seed=seed), cfg, lr=0.1, momentum=0.9, device="cuda", group=group)
    st = on.init_state()
    torch.cuda.synchronize()
    reset_launch_counts()
    losses, dev_ms, syncs, wires, fetch_syncs, windows = [], [], [], [], [], []
    first_acc = None
    for i in range(steps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        st, loss, wire, s = _step_counting_syncs(on, st, batches(i))
        end.record()
        end.synchronize()
        dev_ms.append(start.elapsed_time(end))
        syncs.append(s)
        wires.append(wire)
        losses.append(float(loss))
        if i == 0:
            first_acc = on.telemetry  # the accumulator is never written in place
        if (i + 1) % TELE19_EVERY == 0:
            summ, fs = _counting_syncs(on.telemetry_summary)
            fetch_syncs.append(fs)
            windows.append(summ)
    launches = launch_counts()
    span_events = len(spans.get_tracer().events)
    spans.configure(enabled=False, reset=True)
    _check(launches == expected, f"telemetry on: launches {launches}, expected {expected}")
    _check(not any(syncs), f"telemetry on: host syncs in the step: {syncs}")
    _check(all(len(fs) == 1 for fs in fetch_syncs), f"a fetch made {[len(fs) for fs in fetch_syncs]} host copies")
    _check(losses[0] == losses_off[0], f"telemetry changed the first loss: {losses[0]} vs {losses_off[0]}")

    vals = on.telemetry.fetch()
    sums = {f: _f32_running(float(getattr(w, f)) for w in wires)
            for f in ("index_bits", "value_bits", "dense_bits", "saturated")}
    _check(vals["steps"] == float(steps), f"accumulated steps {vals['steps']}")
    for f, v in sums.items():
        _check(vals[f] == v, f"accumulated {f} {vals[f]} != the float32 sum of the steps' WireStats {v}")
    derived = on.telemetry.derive(vals)
    # the same trajectory as phase 5's: its last step's rel_volume again
    rel5, n5 = phase5["rel_volume"], phase5["steps"]
    rel_step = float(wires[n5 - 1].rel_volume())
    _check(abs(rel_step - rel5) <= REL19_RTOL * rel5, f"step {n5}'s rel_volume {rel_step} vs phase 5's {rel5}")

    # the first step on the CPU from the same weights and batch
    cpu = Trainer(WordLSTM(seed=seed), cfg, lr=0.1, momentum=0.9, device="cpu")
    st_cpu = cpu.init_state()
    cpu.step(st_cpu, (tokens[0, :, :-1], tokens[0, :, 1:]))
    card0, cpu0 = first_acc.fetch(), cpu.telemetry.fetch()
    err_diff = {k: abs(card0[k] - cpu0[k]) for k in ("err_cos", "err_l2")}
    _check(all(d <= ERR19_ATOL for d in err_diff.values()),
           f"first step card vs CPU: {({k: (card0[k], cpu0[k]) for k in err_diff})}, atol {ERR19_ATOL}")
    turns = _telemetry_turns(off, st_off, on, st, batches)
    res = {
        "steps": steps, "telemetry_every": TELE19_EVERY, "launches": launches, "launches_off": launches_off,
        "launches_per_step_phase5": {k: v / phase5["steps"] for k, v in phase5["launches"].items()},
        "step_ms_in_turns": turns,
        "host_syncs_per_step": [len(s) for s in syncs], "host_copies_per_fetch": [len(f) for f in fetch_syncs],
        "step_ms_median": {"off": statistics.median(dev_off[1:]), "on": statistics.median(dev_ms[1:])},
        "step_ms_all": {"off": dev_off, "on": dev_ms}, "counters_bitwise": sorted(sums) + ["steps"],
        "rel_volume": derived["rel_volume"], f"rel_volume_step{n5}": rel_step, "rel_volume_phase5": rel5,
        "measured_fpr": derived["measured_fpr"],
        "window_err_cos": [w["window_compress_err_cos"] for w in windows],
        "window_err_l2": [w["window_compress_err_l2"] for w in windows],
        "residual_l2_per_step": derived["residual_l2_per_step"],
        "first_step": {"card": {k: card0[k] for k in err_diff}, "cpu": {k: cpu0[k] for k in err_diff},
                       "abs_diff": err_diff, "atol": ERR19_ATOL},
        "span_events": span_events,
    }

    def profile() -> dict:
        """One profiled step of each trainer: device launches and busy ms
        (run last: after a profile the host's launches slow down)."""
        p_off = _profile_step(lambda: off.step(st_off, batches(0)))
        p_on = _profile_step(lambda: on.step(st, batches(0)))
        return {"device_launches_per_step": {"off": p_off["kernel_launches"], "on": p_on["kernel_launches"],
                                             "added": p_on["kernel_launches"] - p_off["kernel_launches"]},
                "device_busy_ms": {"off": p_off["device_busy_ms"], "on": p_on["device_busy_ms"]},
                "device_idle_share": {"off": p_off["device_idle_share"], "on": p_on["device_idle_share"]}}

    return res, profile


def _telemetry_turns(off, st_off, on, st_on, batches, rounds: int = 4) -> dict:
    """Step times (CUDA events) of the telemetry-off trainer, the
    telemetry-on one and the latter with spans on, in turns (off, on,
    spans, then the reverse, `rounds` times, two steps each): medians in
    ms. The trainers' counts and states are not checked after this."""
    import torch

    from deepreduce_tpu_torch.telemetry import spans

    times = {"off": [], "on": [], "on_spans": []}
    states = {"off": st_off, "on": st_on}
    order = ["off", "on", "on_spans"]
    for r in range(rounds):
        for mode in order if r % 2 == 0 else order[::-1]:
            tr, key = (off, "off") if mode == "off" else (on, "on")
            spans.configure(enabled=mode == "on_spans", reset=True)
            for i in range(2):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                states[key], _, _ = tr.step(states[key], batches(i))
                end.record()
                end.synchronize()
                times[mode].append(start.elapsed_time(end))
    spans.configure(enabled=False, reset=True)
    return {m: statistics.median(t) for m, t in times.items()}


def _ctrl_flagship(seed: int, tokens, group, err_cos: float, root: str) -> dict:
    """The flagship under the controller on CTRL19_LADDER, its band set so
    that the first window votes up, written as a tracking run (metrics,
    trace.json, decisions.jsonl); a checkpoint after CTRL19_CKPT_AT steps
    restored into a fresh trainer and replayed."""
    import dataclasses

    import torch

    from deepreduce_tpu_torch import Trainer, checkpoint, tracking
    from deepreduce_tpu_torch.controller import DecisionLog, validate_decision
    from deepreduce_tpu_torch.models import WordLSTM
    from deepreduce_tpu_torch.ops import launch_counts, reset_launch_counts
    from deepreduce_tpu_torch.telemetry import spans

    tok = tokens.cuda()
    batches = lambda i: (tok[i, :, :-1], tok[i, :, 1:])  # noqa: E731
    steps = TELE19_STEPS
    target = min(1.0, err_cos + 0.05)
    cfg = _flagship_cfg(seed, telemetry=True, telemetry_every=TELE19_EVERY, ctrl=True, ctrl_ladder=CTRL19_LADDER,
                        ctrl_hysteresis=1, ctrl_target_err_cos=target, ctrl_headroom=0.02)
    run = tracking.Run(root, name="ctrl_flagship", tags=["chip_smoke", "phase19"],
                       config={"workers": 1, "model": "WordLSTM", **dataclasses.asdict(cfg)})
    spans.configure(enabled=True, reset=True)
    trainer = Trainer(WordLSTM(seed=seed), cfg, lr=0.1, momentum=0.9, device="cuda", group=group)
    trainer.attach_decision_log(run.dir / "decisions.jsonl")
    st = trainer.init_state()
    ckpt = os.path.join(root, "ctrl.pt")
    torch.cuda.synchronize()
    reset_launch_counts()
    per_step, rungs, syncs, losses, dev_ms = [], [], [], [], []
    for i in range(steps):
        before = launch_counts()["qsgd_encode_rows"]
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        with spans.span("train/step"):
            (st, loss, wire), s = _counting_syncs(lambda: trainer.step(st, batches(i)))
        end.record()
        end.synchronize()
        dev_ms.append(start.elapsed_time(end))
        per_step.append(launch_counts()["qsgd_encode_rows"] - before)
        rungs.append(trainer.controller.index)
        syncs.append(s)
        losses.append(float(loss))
        rec = {"loss": losses[-1], "rel_volume": float(wire.rel_volume())}
        if i % TELE19_EVERY == 0 or i == steps - 1:
            rec.update({f"telemetry.{k}": v for k, v in trainer.telemetry_summary().items()})
        run.log(rec, step=i)
        if i + 1 == CTRL19_CKPT_AT:
            checkpoint.save(ckpt, {"state": st, "telemetry": trainer.telemetry, "ctrl": trainer.controller_state()},
                            config=cfg)
    launches = launch_counts()
    spans.save(run.dir / "trace.json")
    span_events = len(spans.get_tracer().events)
    spans.configure(enabled=False, reset=True)
    run.finish({"telemetry": trainer.telemetry_summary(), "steps": steps})
    final = {n: p.detach().clone() for n, p in st.params.items()}

    _check(launches == {"qsgd_quantize": 0, "qsgd_encode_rows": steps}, f"ctrl: launches {launches}")
    _check(per_step == [1] * steps, f"ctrl: qsgd_encode_rows launches a step {per_step}")
    boundary = [i for i in range(steps) if i and i % TELE19_EVERY == 0]
    _check(not any(syncs[i] for i in range(steps) if i not in boundary),
           f"ctrl: host syncs off the fetch boundaries: {syncs}")
    _check(all(math.isfinite(l) for l in losses), f"ctrl: losses {losses}")
    trail = DecisionLog.read(run.dir / "decisions.jsonl")
    for rec in trail:
        validate_decision(rec)
    _check(len(trail) == len(boundary) and trainer.controller.switches >= 1,
           f"ctrl: {len(trail)} decisions, {trainer.controller.switches} switches")
    visited = set(rungs) | {trainer.controller.ladder.index_near(cfg.compress_ratio)}
    _check(set(trainer.visited_ladder_indices) == visited,
           f"ctrl: exchangers built {trainer.visited_ladder_indices}, rungs visited {sorted(visited)}")
    rung_rows = {}
    for idx in trainer.visited_ladder_indices:
        ex = trainer._exchanger_cache[idx]
        ratio = trainer.controller.ladder[idx].ratio
        _check(ex.payload_bytes() == CTRL19_PAYLOAD[ratio], f"rung {ratio}: payload_bytes {ex.payload_bytes()}")
        segs = _main_path_table(ex, seed=190 + idx)
        got, ref = _encode_on_card_and_cpu(segs, ex.fused_nbytes, ex.cfg.quantum_num, ex.cfg.bucket_size)
        err = _check_rows(got, ref, segs, ex.cfg.bucket_size, ex.cfg.quantum_num, f"rung {ratio}'s table")
        rung_rows[str(ratio)] = {"payload_bytes": ex.payload_bytes(), "segments": len(segs), "max_abs_err": err,
                                 "steps": sum(1 for r in rungs if r == idx)}

    # the resume: a fresh trainer (other weights) restored and replayed
    fresh = Trainer(WordLSTM(seed=seed + 1), cfg, lr=0.1, momentum=0.9, device="cuda", group=group)
    resume_log = os.path.join(root, "resume_decisions.jsonl")
    fresh.attach_decision_log(resume_log)
    restored = checkpoint.restore(ckpt, {"state": fresh.init_state(), "telemetry": None, "ctrl": None}, config=cfg)
    st2 = restored["state"]
    fresh.telemetry = restored["telemetry"]
    fresh.load_controller_state(restored["ctrl"])
    for i in range(st2.step, steps):
        st2, _, _ = fresh.step(st2, batches(i))
    torch.cuda.synchronize()
    tail = [json.dumps(r, sort_keys=True) for r in trail if r["step"] >= CTRL19_CKPT_AT]
    replay = [json.dumps(r, sort_keys=True) for r in DecisionLog.read(resume_log)]
    _check(tail == replay, f"ctrl: the resumed trail {replay} differs from the uninterrupted one {tail}")
    same = [n for n in final if torch.equal(final[n], st2.params[n])]
    _check(len(same) == len(final), f"ctrl: resumed parameters differ: {sorted(set(final) - set(same))}")
    return {
        "ladder": CTRL19_LADDER, "target_err_cos": target, "headroom": 0.02, "hysteresis": 1, "steps": steps,
        "launches": launches, "launches_per_step": per_step, "rung_by_step": rungs, "step_ms_all": dev_ms,
        "visited_ladder_indices": list(trainer.visited_ladder_indices), "rungs": rung_rows,
        "host_syncs_per_step": [len(s) for s in syncs], "sync_call_sites": sorted({x for s in syncs for x in s}),
        "decisions": [{k: r[k] for k in ("step", "trigger", "rationale", "old_ratio", "new_ratio", "err_cos")}
                      for r in trail],
        "switches": trainer.controller.switches, "effective_ratio": trainer.controller.effective_ratio(),
        "resume": {"checkpoint_after_step": CTRL19_CKPT_AT, "replayed_decisions": len(replay),
                   "trail_bitwise": True, "params_bitwise": len(same)},
        "losses": losses, "span_events": span_events, "run_dir": str(run.dir),
    }


def _tracked_run(seed: int, group, run_dir: str, root: str) -> dict:
    """The port's telemetry CLI (summary, trace, calibrate) over the ctrl
    run's directory; the fitted profile validated and applied."""
    import torch

    from deepreduce_tpu_torch import DeepReduceConfig, Trainer, costmodel
    from deepreduce_tpu_torch.models import WordLSTM

    here = os.path.dirname(os.path.abspath(__file__))
    prof_path = os.path.join(root, "profile.json")
    outs = {}
    for cmd in (["summary", run_dir], ["trace", run_dir, "--out", os.path.join(root, "merged_trace.json")],
                ["calibrate", run_dir, "--out", prof_path]):
        p = subprocess.run([sys.executable, "-m", "deepreduce_tpu_torch.telemetry", *cmd], cwd=here,
                           capture_output=True, text=True, timeout=300)
        _check(p.returncode == 0, f"telemetry {cmd[0]} exited {p.returncode}: {p.stderr[-2000:]}")
        outs[cmd[0]] = p.stdout
    prof = costmodel.load_profile(prof_path)  # validates the schema
    costmodel.validate_profile(prof.to_record())
    cfg = DeepReduceConfig(communicator="sparse_rs", compressor="topk", deepreduce=None, memory="residual",
                           rs_mode="auto", compress_ratio=0.1, seed=seed)
    trainer = Trainer(WordLSTM(seed=seed), cfg, lr=0.1, momentum=0.9, device="cuda", group=group)
    st = trainer.init_state()
    ex0 = trainer.exchanger
    static = trainer.apply_profile(costmodel.static_profile())
    _check(not static["switched"] and trainer.exchanger is ex0 and len(trainer.visited_plan_keys) == 1,
           f"the static profile is not a no-op: {static}")
    fitted = trainer.apply_profile(prof)
    plans = len(trainer.visited_plan_keys)
    _check(plans == (2 if fitted["switched"] else 1) and trainer._plan_key_of(trainer.exchanger) == fitted["new"],
           f"apply_profile: {fitted}, plans visited {trainer.visited_plan_keys}")
    tok = _tokens(seed, 1, 64, 20, 10_004).cuda()
    st, loss, _ = trainer.step(st, (tok[0, :, :-1], tok[0, :, 1:]))
    _check(math.isfinite(float(loss)), f"the step under the fitted profile: loss {float(loss)}")
    torch.cuda.synchronize()
    rec = prof.to_record()
    return {
        "cli": {k: len(v.splitlines()) for k, v in outs.items()}, "calibrate_stdout": outs["calibrate"][-1500:],
        "profile": {k: rec[k] for k in ("bw_dcn_bytes_per_s", "bw_ici_bytes_per_s", "t_enc_s", "t_dec_s",
                                        "compute_time_s", "fitted", "fixed")},
        "routes": rec["routes"], "measured_step_s": rec["source"]["measured_step_s"],
        "static_no_op": static, "apply_fitted": {k: (list(v) if isinstance(v, tuple) else v)
                                                 for k, v in fitted.items()},
        "plans_visited": [list(k) for k in trainer.visited_plan_keys], "exchangers_built": plans,
    }


def _fedsim_telemetry_arm(arm: str, spec: dict, seed: int, group) -> dict:
    """One of phase 18's linear arms at 1/8 size with telemetry on, for
    FED19_TICKS ticks: syncs, the all_reduce law, and the accumulator's rows
    against the tick reports."""
    import torch

    from deepreduce_tpu_torch import DeepReduceConfig, FedSim
    from deepreduce_tpu_torch.collectives import reduce_counts, reset_reduce_counts
    from deepreduce_tpu_torch.fedsim import synthetic_linear_problem
    from deepreduce_tpu_torch.ops import launch_counts, reset_launch_counts
    from deepreduce_tpu_torch.resilience import stream
    from deepreduce_tpu_torch.telemetry.device_metrics import MetricAccumulators, hist_quantile

    g, cut = FED18_LINEAR, FED18_CPU_CUT
    knobs = dict(FED18_CODEC, **FED18_CHURN, **spec["knobs"], fed=True, fed_num_clients=g["population"] // cut,
                 fed_clients_per_round=g["cohort"] // cut, fed_local_steps=g["local_steps"],
                 fed_client_chunk=g["chunk"], seed=seed, telemetry=True)
    if "fed_async_k" in knobs:
        knobs["fed_async_k"] //= cut
    cfg = DeepReduceConfig(**knobs)
    fed = cfg.fed_config()
    p0, data_fn, loss_fn = synthetic_linear_problem(g["dim"], g["batch"], g["local_steps"], device="cuda")
    sim = FedSim(loss_fn, cfg, fed, g["lr"], data_fn, group=group, client_chunk=g["chunk"], device="cuda")
    state = sim.init(p0)
    masks = [(True, True), (True, False)] if cfg.fed_tenants else [None] * FED19_TICKS
    key = seed + 19
    torch.cuda.synchronize()
    reset_launch_counts()
    reset_reduce_counts()
    syncs, mets = [], []
    for i in range(FED19_TICKS):
        if masks[i] is not None:
            state = sim.set_active(state, masks[i])
        (state, m), s = _counting_syncs(lambda: sim.step(state, stream.key(key, i)))
        syncs.append(s)
        mets.append(m)
    torch.cuda.synchronize()
    launches, reduces = launch_counts(), reduce_counts()
    T = max(cfg.fed_tenants, 1)
    D = len(sim.latency_probs) if cfg.fed_async else 0
    K = sim.pop.num_classes if sim.pop is not None else 0
    law = _fed_law(cfg, g["dim"] + 1, D, K, T)
    _check(not any(syncs), f"{arm}: host syncs in a telemetry tick: {syncs}")
    _check(reduces["all_reduce"] == FED19_TICKS and reduces["all_reduce_bytes"] == FED19_TICKS * law,
           f"{arm}: all_reduce {reduces}, law {law} a tick")
    C = fed.clients_per_round
    acc = state.telemetry
    rows = acc.vec.cpu()
    checked = []
    for t in range(T):
        row = MetricAccumulators(rows[t] if T > 1 else rows, acc.num_buckets, acc.num_stale_levels,
                                 acc.num_pop_classes).fetch()
        pick = (lambda m, k: m[k][t]) if T > 1 else (lambda m, k: m[k])  # noqa: E731
        live = [float(pick(m, "clients")) for m in mets]
        want = {
            "steps": _f32_running(1.0 if masks[i] is None or masks[i][t] else 0.0 for i in range(FED19_TICKS)),
            "live_workers": _f32_running(live),
            "checksum_failures": _f32_running(float(pick(m, "checksum_failures")) for m in mets),
            "dropped_steps": _f32_running(1.0 if (masks[i] is None or masks[i][t]) and live[i] < C else 0.0
                                          for i in range(FED19_TICKS)),
        }
        for k, v in want.items():
            _check(row[k] == v, f"{arm} tenant {t}: accumulated {k} {row[k]} != the ticks' {v}")
        if D:
            hist = [_f32_running(float(pick(m, "staleness_hist")[d]) for m in mets) for d in range(D)]
            _check(row["staleness_hist"] == hist, f"{arm} tenant {t}: staleness_hist {row['staleness_hist']} != {hist}")
            der = MetricAccumulators.derive(row)
            for q, name in ((0.50, "staleness_p50"), (0.95, "staleness_p95"), (0.99, "staleness_p99")):
                _check(der[name] == hist_quantile(hist, q), f"{arm}: {name}")
        if K:
            hist = [_f32_running(float(pick(m, "pop_hist")[c]) for m in mets) for c in range(K)]
            _check(row["pop_hist"] == hist, f"{arm}: pop_hist {row['pop_hist']} != {hist}")
            total = max(sum(hist), 1.0)
            _check(MetricAccumulators.derive(row)["pop_shares"] == [h / total for h in hist], f"{arm}: pop_shares")
        checked.append({k: row[k] for k in want})
    summ = sim.summary(state)
    want_keys = set(MetricAccumulators.derive(acc.sum_tenants().fetch() if T > 1 else acc.fetch())) | {
        "uplink_bytes_per_round"}
    _check(want_keys <= set(summ), f"{arm}: summary lacks {sorted(want_keys - set(summ))}")
    return {"population": fed.num_clients, "cohort": C, "tenants": T, "ticks": FED19_TICKS, "launches": launches,
            "host_syncs_per_tick": [len(s) for s in syncs], "all_reduce_per_tick": reduces["all_reduce"] / FED19_TICKS,
            "all_reduce_bytes_per_tick": reduces["all_reduce_bytes"] / FED19_TICKS, "all_reduce_bytes_law": law,
            "rows": checked, "summary_keys": len(summ),
            "summary": {k: summ[k] for k in ("rel_volume", "live_workers_per_step", "checksum_failures",
                                             "uplink_bytes_per_round") if k in summ}}


def phase_telemetry(seed: int, group, phase5: dict) -> dict:
    """Phase 19: the flagship with telemetry, under the controller, its
    tracking run through the telemetry CLI and calibrate, and phase 18's
    linear arms with telemetry. Returns {arm: result}; each arm's
    `launches` are its counted kernel launches."""
    import shutil

    import torch

    t0 = time.perf_counter()
    tokens = _tokens(seed, TELE19_STEPS, 64, 20, 10_004)
    results = {}
    res, profile = _telemetry_flagship(seed, tokens, group, phase5)
    print("phase 19 ok: telemetry_flagship " + json.dumps(res), flush=True)
    results["telemetry_flagship"] = res
    root = tempfile.mkdtemp(prefix="chip_smoke_phase19_")
    try:
        ctrl = _ctrl_flagship(seed, tokens, group, res["window_err_cos"][0], root)
        print("phase 19 ok: ctrl_flagship " + json.dumps(ctrl), flush=True)
        results["ctrl_flagship"] = ctrl
        tracked = _tracked_run(seed, group, ctrl["run_dir"], root)
        print("phase 19 ok: tracked_run " + json.dumps(tracked), flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    for arm, spec in PHASE18.items():
        name = arm.replace("fedsim_linear", "fedsim_telemetry")
        res = _fedsim_telemetry_arm(arm, spec, seed, group)
        print(f"phase 19 ok: {name} " + json.dumps(res), flush=True)
        results[name] = res
        torch.cuda.empty_cache()
    print("phase 19 ok: telemetry_flagship profiled " + json.dumps(profile()), flush=True)
    print(f"phase 19 time {time.perf_counter() - t0:.1f} s", flush=True)
    return results


# -- phase 20: sequence and tensor parallelism on the full-width BERT-base -- #
# Every arm runs its workers as in-process threads on the one card, each
# from the same weights (BertEncoder(seed=--seed)), in float32 with TF32 off.
BERT20 = dict(vocab_size=30_522, hidden=768, layers=12, heads=12, mlp_dim=3072, max_len=512)
PHASE20 = ("bert_ring_sp4", "bert_ulysses_sp4", "bert_tp2", "bert_dp2_sp2_ring")
BATCH20 = 8  # sequences of 512 tokens a sequence group (a data rank) trains on
SP20 = 4  # the sp4 arms' sequence workers: 4 chunks of 128 tokens
TP20 = 2
SP20_PASSES = 2  # forward + backward passes of the sp4 and tp2 arms (the last one's ms is the steady one)
# the bound against the single-device twin: max |port - twin| over the
# tensor's largest |twin|. `key/bias` is held against its layer's
# `key/kernel` gradient instead: its own gradient is zero in exact
# arithmetic (a softmax ignores a shift shared by a query's scores), so
# both are rounding noise and its own largest magnitude is no scale
TWIN20_REL = 1e-4
# __graft_entry__.py:258-268, the JAX package's data x sequence dry run
DP_SP20 = dict(compressor="topk", compress_ratio=0.1, memory="none", communicator="allgather", deepreduce="both",
               index="integer", value="qsgd", policy="p0", min_compress_size=256)
DP_SP20_STEPS = 3
# the JAX package's payload_bytes of the ring-layout BERT-base under
# DP_SP20 (test_phase20_constants_match_jax), and the launches a worker-step:
# all 200 leaves are QSGD segments, at most 128 a launch
PAYLOAD20 = 50_833_724
ENCODE20 = 2


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]


def _rel_err(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def _twin_errs(grads: dict, want: dict, what: str) -> dict:
    """{leaf: max |grads - want| / scale} with TWIN20_REL checked: the scale
    is the twin leaf's largest magnitude (its layer's key kernel's for a
    key bias)."""
    errs = {}
    for n, w in want.items():
        ref = want[n.replace("key/bias", "key/kernel")] if n.endswith("key/bias") else w
        errs[n] = float((grads[n] - w).abs().max() / ref.abs().max())
    worst = max(errs, key=errs.get)
    _check(errs[worst] <= TWIN20_REL, f"{what}: gradient {worst} off the twin by {errs[worst]:.3g}")
    return errs


def _pass20(model, tokens, scale: float = 1.0):
    """One forward and backward of `token_loss(model(tokens)) * scale` on
    this thread: (logits, loss, start and end events)."""
    import torch

    from deepreduce_tpu_torch.parallel.data_seq import token_loss
    from deepreduce_tpu_torch.parallel.functional import backward

    for p in model.parameters():
        p.grad = None
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    logits = model(tokens)
    loss = token_loss(logits, tokens) * scale
    backward(loss)
    end.record()
    return logits.detach(), loss.detach(), start, end


def _twin20(model, tokens) -> dict:
    """The single-device model's logits, loss and gradients on the card."""
    import torch

    model.cuda()
    for _ in range(SP20_PASSES):
        logits, loss, start, end = _pass20(model, tokens)
    torch.cuda.synchronize()
    grads = {n: p.grad for n, p in model.flax_params().items()}
    return {"logits": logits, "loss": loss, "grads": grads, "ms": start.elapsed_time(end)}


def _workers20(group, models, tokens_of, scale: float) -> tuple:
    """SP20_PASSES passes of every in-process worker (worker r on
    `tokens_of(r)`), counted from 0 just before: (each worker's last
    (logits, loss), worker 0's ms per pass, launches, peak bytes)."""
    import torch

    from deepreduce_tpu_torch.ops import launch_counts, reset_launch_counts

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    ms = []
    for _ in range(SP20_PASSES):
        outs = group.run(lambda coll, m, r: _pass20(m, tokens_of(r), scale), models, list(range(len(models))))
        torch.cuda.synchronize()
        ms.append(outs[0][2].elapsed_time(outs[0][3]))
    return [o[:2] for o in outs], ms, launch_counts(), torch.cuda.max_memory_allocated()


def _plain20(seed: int, tokens) -> dict:
    """The plain reference of the sp4 arms on the card: the Ulysses local
    twin, whose attention is one plain causal softmax
    (`ring_self_attention_reference`), with the sp4 models' parameter tree."""
    from deepreduce_tpu_torch.models import BertEncoder

    return _twin20(BertEncoder(attention="ulysses", causal=True, seed=seed, **BERT20), tokens)


def _against20(logits, loss, grads: dict, twin: dict, what: str) -> dict:
    """The logits', loss's and every gradient leaf's error off `twin`, each
    checked against TWIN20_REL."""
    logits_err = _rel_err(logits, twin["logits"])
    loss_err = abs(float(loss) - float(twin["loss"])) / abs(float(twin["loss"]))
    _check(logits_err <= TWIN20_REL and loss_err <= TWIN20_REL, f"{what}: logits {logits_err:.3g}, "
           f"loss {loss_err:.3g} off")
    errs = _twin_errs(grads, twin["grads"], what)
    return {"logits_rel_err": logits_err, "loss_rel_err": loss_err, "grad_rel_err_max": max(errs.values()),
            "grad_rel_err_key_bias_max": max(e for n, e in errs.items() if n.endswith("key/bias"))}


def _sp4_arm(mode: str, seed: int, tokens, plain: dict) -> dict:
    """`bert_{mode}_sp4`: four sequence workers, causal, against the plain
    reference (`_plain20`) and, for ring, its local twin (seq_axis=None)
    too, whose one block update is the sharded arm's, on the card."""
    import torch

    from deepreduce_tpu_torch.collectives import InProcessGroup
    from deepreduce_tpu_torch.models import BertEncoder

    c = tokens.shape[1] // SP20
    twin = _twin20(BertEncoder(attention=mode, causal=True, seed=seed, **BERT20), tokens) if mode == "ring" else plain
    group = InProcessGroup(SP20)
    models = [BertEncoder(attention=mode, seq_axis=group.member(r), causal=True, seed=seed, **BERT20).cuda()
              for r in range(SP20)]
    # each worker's loss is its chunk's mean over SP20: the sum is the twin's mean
    outs, ms, launches, peak = _workers20(group, models, lambda r: tokens[:, r * c : (r + 1) * c], 1.0 / SP20)
    logits = torch.cat([o[0] for o in outs], dim=1)
    loss = sum(o[1] for o in outs)
    grads = {n: sum(m.flax_params()[n].grad for m in models) for n in plain["grads"]}
    errs = _against20(logits, loss, grads, twin, f"bert_{mode}_sp4 against the local twin")
    plain_errs = errs if mode == "ulysses" else _against20(logits, loss, grads, plain,
                                                           f"bert_{mode}_sp4 against the plain reference")
    _check(launches == {"qsgd_quantize": 0, "qsgd_encode_rows": 0}, f"bert_{mode}_sp4: launches {launches}")
    return {"workers": SP20, "tokens": list(tokens.shape), "chunk": c, "causal": True, "loss": float(loss),
            "twin_loss": float(twin["loss"]), **errs, "plain_loss": float(plain["loss"]),
            **{f"plain_{k}": v for k, v in plain_errs.items()},
            "worker0_ms_per_pass": ms, "twin_ms": twin["ms"], "plain_ms": plain["ms"], "launches": launches,
            "peak_mem_bytes": peak, "card": _card()}


def _tp2_arm(seed: int, tokens) -> dict:
    """`bert_tp2`: dense bidirectional BERT-base over a model group of two,
    the embedding and the head vocabulary-sharded (the rules under the
    variables dict's scope), against the single-device model."""
    from deepreduce_tpu_torch.collectives import InProcessGroup
    from deepreduce_tpu_torch.models import BertEncoder
    from deepreduce_tpu_torch.parallel import bert_tp_rules, tp_shardings
    from deepreduce_tpu_torch.parallel.tp import from_params, shard

    single = BertEncoder(seed=seed, **BERT20)
    full = {n: p.detach().clone() for n, p in single.flax_params().items()}
    specs = tp_shardings(full, {"model": TP20}, bert_tp_rules(), scope="params")
    twin = _twin20(single, tokens)
    group = InProcessGroup(TP20)
    models = [from_params(full, group.member(r), shard_vocab=True).cuda() for r in range(TP20)]
    _check(models[0].tok.embedding.shape[0] == BERT20["vocab_size"] // TP20, "bert_tp2: the vocabulary is not sharded")
    outs, ms, launches, peak = _workers20(group, models, lambda r: tokens, 1.0)
    errs, logits_err, loss_err = {}, 0.0, 0.0
    for r, (m, (logits, loss)) in enumerate(zip(models, outs)):
        logits_err = max(logits_err, _rel_err(logits, twin["logits"]))
        loss_err = max(loss_err, abs(float(loss) - float(twin["loss"])) / abs(float(twin["loss"])))
        want = {n: shard(g, specs[n], {"model": group.member(r)}) for n, g in twin["grads"].items()}
        errs.update({f"{r}:{n}": e for n, e in _twin_errs(
            {n: p.grad for n, p in m.flax_params().items()}, want, f"bert_tp2 rank {r}").items()})
    _check(logits_err <= TWIN20_REL and loss_err <= TWIN20_REL, f"bert_tp2: logits {logits_err:.3g}, loss "
           f"{loss_err:.3g} off the single-device model")
    _check(launches == {"qsgd_quantize": 0, "qsgd_encode_rows": 0}, f"bert_tp2: launches {launches}")
    sharded = sorted({n for n, sp in specs.items() if any(a is not None for a in sp)})
    return {"workers": TP20, "tokens": list(tokens.shape), "sharded_leaves": len(sharded),
            "loss": float(outs[0][1]), "twin_loss": float(twin["loss"]), "logits_rel_err": logits_err,
            "loss_rel_err": loss_err, "grad_rel_err_max": max(errs.values()), "worker0_ms_per_pass": ms,
            "twin_ms": twin["ms"], "launches": launches, "peak_mem_bytes": peak, "card": _card()}


def _dp_sp_arm(seed: int) -> dict:
    """`bert_dp2_sp2_ring`: the data x sequence step (`DataSeqStep`) on
    factor_devices(4, ('data', 'seq')) in-process workers, ring attention,
    causal, DP_SP20_STEPS steps."""
    import torch

    from deepreduce_tpu_torch import DeepReduceConfig
    from deepreduce_tpu_torch.collectives import InProcessMesh
    from deepreduce_tpu_torch.models import BertEncoder
    from deepreduce_tpu_torch.ops import launch_counts, reset_launch_counts
    from deepreduce_tpu_torch.ops.qsgd_encode import MAX_SEGMENTS
    from deepreduce_tpu_torch.parallel import factor_devices
    from deepreduce_tpu_torch.parallel.data_seq import DataSeqStep

    sizes = factor_devices(4, ("data", "seq"))
    D, S = sizes["data"], sizes["seq"]
    _check((D, S) == (2, 2), f"factor_devices(4) = {sizes}")
    L = BERT20["max_len"]
    c = L // S
    tokens = _tokens20(seed + 20, (DP_SP20_STEPS, D * BATCH20, L)).cuda()
    cfg = DeepReduceConfig(**DP_SP20, seed=seed)
    mesh = InProcessMesh(sizes)
    steps = []
    for r in range(D * S):
        m = mesh.member(r)
        model = BertEncoder(attention="ring", seq_axis=m["seq"], causal=True, seed=seed, **BERT20)
        steps.append(DataSeqStep(model, cfg, data=m["data"], seq=m["seq"], device="cuda"))
    ex = steps[0].exchanger
    segments = sum(codec.rows_leaf is not None for codec in ex.codecs.values())
    _check(ex.payload_bytes() == PAYLOAD20, f"bert_dp2_sp2_ring: payload bytes {ex.payload_bytes()} != {PAYLOAD20}")
    _check(-(-segments // MAX_SEGMENTS) == ENCODE20, f"bert_dp2_sp2_ring: {segments} QSGD segments")

    def work(m, step, i):
        d, s = m["data"].rank, m["seq"].rank
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        loss, wire = step.step(tokens[i, d * BATCH20 : (d + 1) * BATCH20, s * c : (s + 1) * c], step=i)
        end.record()
        return loss, wire, start, end

    # the sync count's positive control: one `.item()` on one worker thread of the mesh is one site
    _, control = _counting_syncs(lambda: mesh.run(lambda m, t: float(t) if m["data"].rank == m["seq"].rank == 0
                                                  else None, [tokens[0, 0, 0]] * (D * S)))
    _check(len(control) == 1, f"bert_dp2_sp2_ring: a worker thread's .item() gave the sync sites {control}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses, vols, ms, syncs = [], [], [], []
    for i in range(DP_SP20_STEPS):
        if i == 0:  # the first card step pays lazy set-up: its syncs are not counted
            outs = mesh.run(work, steps, [i] * (D * S))
            torch.cuda.synchronize()
        else:
            outs, sites = _counting_syncs(lambda: (mesh.run(work, steps, [i] * (D * S)), torch.cuda.synchronize())[0])
            syncs.append(sites)
        ms.append(outs[0][2].elapsed_time(outs[0][3]))
        losses.append(float(outs[0][0]))
        vols.append(float(outs[0][1].rel_volume()))
        for r in range(1, D * S):
            _check(float(outs[r][0]) == losses[-1], f"bert_dp2_sp2_ring step {i}: worker {r}'s loss differs")
            for n, p in steps[0].params.items():
                _check(torch.equal(steps[r].params[n], p), f"bert_dp2_sp2_ring step {i}: worker {r}'s {n} differs")
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    expected = {"qsgd_quantize": 0, "qsgd_encode_rows": ENCODE20 * D * S * DP_SP20_STEPS}
    _check(launches == expected, f"bert_dp2_sp2_ring: launches {launches}, expected {expected}")
    _check(all(math.isfinite(l) for l in losses), f"bert_dp2_sp2_ring: losses {losses}")
    _check(all(0 < v < 1 for v in vols), f"bert_dp2_sp2_ring: rel_volume {vols}")
    _check(not any(syncs), f"bert_dp2_sp2_ring: host syncs at {syncs}")
    _check(all(bool(torch.isfinite(p).all()) for p in steps[0].params.values()), "bert_dp2_sp2_ring: non-finite params")
    segs = _main_path_table(ex, seed=seed + 79)
    rows, ref_rows = _encode_on_card_and_cpu(segs, ex.fused_nbytes, cfg.quantum_num, cfg.bucket_size)
    err = _check_rows(rows, ref_rows, segs, cfg.bucket_size, cfg.quantum_num, "bert_dp2_sp2_ring's table")
    return {"mesh": sizes, "tokens_per_data_rank": [BATCH20, L], "chunk": c, "losses": losses, "rel_volume": vols,
            "payload_bytes": ex.payload_bytes(), "qsgd_segments": segments, "launches": launches,
            "launches_per_worker_step": {k: v / (D * S * DP_SP20_STEPS) for k, v in launches.items()},
            "host_syncs_steps_2_3": [len(x) for x in syncs], "host_syncs_control": len(control),
            "replicas_bitwise": True,
            "worker0_step_ms": ms, "peak_mem_bytes": peak, "qsgd_encode_rows_vs_plain_max_abs_err": err,
            "card": _card()}


def _tokens20(seed: int, shape):
    import torch

    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, BERT20["vocab_size"], shape, generator=gen)


def phase_seq_tensor(seed: int) -> dict:
    """Phase 20: ring and Ulysses attention, tensor parallelism and the data
    x sequence step on the full-width BERT-base. Returns {arm: result}."""
    import torch

    t0 = time.perf_counter()
    tokens = _tokens20(seed, (BATCH20, BERT20["max_len"])).cuda()
    results = {}
    plain = _plain20(seed, tokens)
    arms = {"bert_ring_sp4": lambda: _sp4_arm("ring", seed, tokens, plain),
            "bert_ulysses_sp4": lambda: _sp4_arm("ulysses", seed, tokens, plain),
            "bert_tp2": lambda: _tp2_arm(seed, tokens), "bert_dp2_sp2_ring": lambda: _dp_sp_arm(seed)}
    for name in PHASE20:
        results[name] = arms[name]()
        print(f"phase 20 ok: {name} " + json.dumps(results[name]), flush=True)
        if name == "bert_ulysses_sp4":
            del plain
        torch.cuda.empty_cache()
    print("phase 20 note: every arm runs its workers as threads on one card, so no ring hop, all_to_all or "
          "all-reduce crossed between cards; sequence and tensor parallelism over NCCL between cards are not "
          "measured", flush=True)
    print(f"phase 20 time {time.perf_counter() - t0:.1f} s", flush=True)
    return results


# -- phase 21: the training driver (python -m deepreduce_tpu_torch.driver) -- #
# The driver's runs through `driver.run` in this process (on the one-rank
# NCCL group, for the launch counters and the sync debug mode) and through
# `python -m deepreduce_tpu_torch.driver` in fresh processes (the streamed
# exchange against the barrier one, the first measure of its overlap on the
# card, and calibrate). The grace configs are the reference's flag format.
FLAGSHIP21 = ("{'compressor':'topk','compress_ratio':0.1,'memory':'residual','communicator':'allgather',"
              "'deepreduce':'both','index':'bloom','value':'qsgd','fpr':0.02,'policy':'p0','bloom_blocked':'mod',"
              "'quantum_num':127,'bucket_size':512}")
QUICKSTART21 = ("{'compressor':'topk','compress_ratio':0.01,'memory':'residual','communicator':'allgather',"
                "'deepreduce':'both','index':'bloom','value':'polyfit','fpr':0.001,'policy':'leftmost'}")
QAR21 = "{'communicator':'qar','compressor':'none','deepreduce':None,'memory':'none'}"
STREAM21 = FLAGSHIP21[:-1] + f",'bucket_bytes':{BUCKET_BYTES},'bucket_order':'reverse'"
DRIVER21 = {  # arm: (model, grace config, steps, launches a step {kernel: n}, payload bytes)
    "driver_flagship": ("lstm", FLAGSHIP21, 8, {"qsgd_encode_rows": 1, "qsgd_quantize": 0}, PAYLOAD_BYTES["drqsgd_bloom"]),
    "driver_quickstart": ("resnet20", QUICKSTART21, 3, {"qsgd_encode_rows": 0, "qsgd_quantize": 0},
                          RESNET_PAYLOAD_BYTES["resnet20_quickstart"]),
    "driver_qar": ("lstm", QAR21, 3, {"qsgd_encode_rows": 0, "qsgd_quantize": 2}, None),
}
RESUME21 = (4, 6, 2)  # killed after 4 steps (checkpoint every 2), resumed to 6
RESUME21_RTOL = 1e-6
STREAM21_STEPS = 6  # calibrate fits from >= 4 step times after its one-step warm-up drop


def _driver_args(model: str, grace: str, steps: int, **kw):
    from deepreduce_tpu_torch import driver

    argv = ["--model", model, "--grace_config", grace, "--num_steps", str(steps), "--num_workers", "1",
            "--log_every", "0"]
    args = driver.build_parser().parse_args(argv)
    for k, v in kw.items():
        setattr(args, k, v)
    return args


def _driver_ref_loss(model_name: str, seed: int) -> tuple:
    """(the loss of the driver's first batch at its initial weights on the
    CPU, the model's parameter count)."""
    import numpy as np
    import torch

    from deepreduce_tpu_torch import driver

    model, (kind, spec, classes) = driver.MODELS[model_name](seed)
    batch = driver.make_batch(kind, spec, classes, 64, np.random.default_rng((seed, 1, 0)), model=model)
    with torch.no_grad():
        return float(driver.make_loss(kind, model)(batch)), sum(p.numel() for p in model.parameters())


def _driver_run_counted(args, spy_kernels: bool = False) -> dict:
    """`driver.run(args)` in this process with its launch counts zeroed just
    before and read just after, under the sync debug mode: the host syncs of
    each `Trainer.step` call (file:line) and of the whole run; with
    `spy_kernels`, the last grouped QSGD launch's table and the last
    `qsgd_quantize` call's inputs and output, kept for the comparison with
    the plain versions after the counted run."""
    import warnings

    import torch

    from deepreduce_tpu_torch import driver, qar, train, wrappers
    from deepreduce_tpu_torch.ops import launch_counts, reset_launch_counts

    orig_step, orig_encode, orig_quantize = train.Trainer.step, wrappers.qsgd_encode_rows, qar.quantize_levels
    per_step, seen = [], {}
    sites = lambda ws: [f"{w.filename}:{w.lineno}" for w in ws if "called a synchronizing" in str(w.message)]

    def encode_spy(segments, rows, **kw):
        out = orig_encode(segments, rows, **kw)
        seen["encode"] = (list(segments), rows.clone(), kw["quantum_num"], kw["bucket_size"])  # device copies
        return out

    def quantize_spy(values, scale, seed, offset, **kw):
        out = orig_quantize(values, scale, seed, offset, **kw)
        seen["quantize"] = (values.clone(), scale.clone(), seed, offset, out.clone())
        return out

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")

        def step_spy(self, *a, **kw):
            n0 = len(caught)
            out = orig_step(self, *a, **kw)
            per_step.append(sites(caught[n0:]))
            return out

        train.Trainer.step = step_spy
        if spy_kernels:
            wrappers.qsgd_encode_rows, qar.quantize_levels = encode_spy, quantize_spy
        torch.cuda.synchronize()
        reset_launch_counts()
        torch.cuda.set_sync_debug_mode("warn")
        t0 = time.perf_counter()
        try:
            result = driver.run(args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
            train.Trainer.step, wrappers.qsgd_encode_rows, qar.quantize_levels = orig_step, orig_encode, orig_quantize
        wall_s = time.perf_counter() - t0
    return {"result": result, "launches": launch_counts(), "step_syncs": per_step, "run_syncs": sites(caught),
            "wall_s": wall_s, "seen": seen}


def _captured_table_vs_plain(seen, what: str) -> dict:
    """The captured grouped launch's rows against the plain version on the
    same segment table (the segments' row ranges of the fused buffer)."""
    import torch

    from deepreduce_tpu_torch.ops.qsgd_encode import num_buckets

    segs, rows, q, bs = seen["encode"]
    rows = rows.cpu()
    got = torch.zeros_like(rows)
    for s in segs:
        lo = s.out_offset
        hi = lo + num_buckets(s.values.numel(), bs) * (bs + 4)
        got[lo:hi] = rows[lo:hi]
    err = _check_rows(got, _plain_rows(segs, rows.numel(), q, bs), segs, bs, q, what)
    return {"segments": len(segs), "values": sum(s.values.numel() for s in segs), "max_abs_err": err}


def _captured_quantize_vs_plain(seen, what: str) -> dict:
    import torch

    from deepreduce_tpu_torch.ops import philox_uniforms_plain, quantize_levels_plain

    values, scale, seed, offset, got = seen["quantize"]
    ref = quantize_levels_plain(values, scale, philox_uniforms_plain(values.numel(), seed, offset,
                                                                     device=values.device))
    torch.cuda.synchronize()
    err = float((got.int() - ref.int()).abs().max())
    _check(torch.equal(got, ref), f"{what}: qsgd_quantize != plain on the step's input (max |diff| {err})")
    return {"n": values.numel(), "max_abs_err": err, "levels_nonzero": int((got != 0).sum())}


def _driver_arm(arm: str, seed: int, root: str, phase5: dict) -> dict:
    model, grace, steps, per_step, payload = DRIVER21[arm]
    track = arm == "driver_flagship"
    args = _driver_args(model, grace, steps, seed=seed, telemetry=track,
                        track_dir=os.path.join(root, "track") if track else "", run_name=arm)
    out = _driver_run_counted(args, spy_kernels=True)
    res, launches = out["result"], out["launches"]
    expected = {k: n * steps for k, n in per_step.items()}
    _check(launches == expected, f"{arm}: kernel launches {launches}, expected {expected}")
    _check(len(out["step_syncs"]) == steps and not any(out["step_syncs"][1:]),
           f"{arm}: host syncs in steps 2-{steps}: {out['step_syncs']}")
    ref, n_params = _driver_ref_loss(model, seed)
    _check(all(math.isfinite(res[k]) for k in ("first_loss", "last_loss")), f"{arm}: losses {res}")
    _check(abs(res["first_loss"] - ref) <= 1e-4 * abs(ref), f"{arm}: first loss {res['first_loss']} vs CPU {ref}")
    _check(0.0 < res["rel_volume"] < 1.0 and res["steps"] == steps, f"{arm}: {res}")
    if payload is not None:
        _check(res["payload_bytes_per_step"] == payload, f"{arm}: payload {res['payload_bytes_per_step']}")
        # the live lengths: at most the static budgets' ratio (the value
        # stream's live length is the data's: phase 5's batches read another)
        budget = payload * 8 / (32 * n_params)
        _check(res["rel_volume"] <= budget, f"{arm}: rel_volume {res['rel_volume']} above the budgets' {budget}")
    rec = {k: res[k] for k in ("first_loss", "last_loss", "examples_per_sec", "rel_volume", "idx_rel_volume",
                               "val_rel_volume", "payload_bytes_per_step")}
    rec.update(cpu_ref_loss0=ref, launches=launches, wall_s=out["wall_s"],
               step_syncs=[len(s) for s in out["step_syncs"]], run_syncs=len(out["run_syncs"]),
               run_sync_sites=sorted(set(out["run_syncs"])), card=_card())
    if per_step["qsgd_encode_rows"]:
        rec["qsgd_table"] = _captured_table_vs_plain(out["seen"], f"the {arm} step's table")
    if per_step["qsgd_quantize"]:
        rec["qsgd_quantize"] = _captured_quantize_vs_plain(out["seen"], arm)
    if arm == "driver_flagship":
        rec["phase5_rel_volume"] = phase5["rel_volume"]
    if track:
        run_dir = os.path.join(root, "track", arm)
        metrics = [json.loads(l) for l in open(os.path.join(run_dir, "metrics.jsonl"))]
        _check([m["step"] for m in metrics] == list(range(steps)), f"{arm}: tracked steps {metrics}")
        _check(res["telemetry"]["steps"] == float(steps), f"{arm}: telemetry steps {res['telemetry']['steps']}")
        _check(os.path.exists(os.path.join(run_dir, "trace.json")), f"{arm}: no trace.json")
        rec["tracked_losses"] = [m["loss"] for m in metrics]
        rec["telemetry_rel_volume"] = res["telemetry"]["rel_volume"]
    return rec


def _driver_resume(seed: int, root: str) -> dict:
    """The flagship killed after RESUME21[0] steps and resumed to RESUME21[1],
    against an uninterrupted run of RESUME21[1] steps."""
    killed_at, total, every = RESUME21
    ck = os.path.join(root, "ckpt")
    run = lambda steps, **kw: _driver_run_counted(_driver_args("lstm", FLAGSHIP21, steps, seed=seed,
                                                               telemetry=True, **kw))
    full = run(total)
    killed = run(killed_at, checkpoint_every=every, checkpoint_dir=ck)
    resumed = run(total, checkpoint_dir=ck, resume=True)
    a, b = resumed["result"], full["result"]
    _check(killed["result"]["steps"] == killed_at and a["resumed_at"] == killed_at, f"resume: {a}")
    diff = abs(a["last_loss"] - b["last_loss"])
    _check(diff <= RESUME21_RTOL * abs(b["last_loss"]), f"resume: last loss {a['last_loss']} vs {b['last_loss']}")
    _check(a["telemetry"]["steps"] == float(total), f"resume: telemetry steps {a['telemetry']['steps']}")
    # one qsgd_encode_rows launch a step in the uninterrupted run and in the
    # killed and resumed runs together
    for what, n in (("uninterrupted", full["launches"]["qsgd_encode_rows"]),
                    ("killed + resumed", killed["launches"]["qsgd_encode_rows"]
                     + resumed["launches"]["qsgd_encode_rows"])):
        _check(n == total, f"resume: {what} run launched qsgd_encode_rows {n} times, expected {total}")
    launches = {k: full["launches"][k] + killed["launches"][k] + resumed["launches"][k] for k in full["launches"]}
    return {"last_loss_resumed": a["last_loss"], "last_loss_uninterrupted": b["last_loss"], "abs_diff": diff,
            "rel_diff": diff / abs(b["last_loss"]), "launches": launches,
            "step_syncs": [len(s) for s in killed["step_syncs"] + resumed["step_syncs"]]}


def _driver_stream(seed: int, root: str) -> dict:
    """The flagship in 4 MiB buckets under the barrier schedule through
    `driver.run` here (counted: one qsgd_encode_rows launch a step), then
    streamed from the backward pass through `python -m
    deepreduce_tpu_torch.driver` in a fresh process: the loss and rel_volume
    series bitwise equal, `telemetry trace --overlap` on the streamed run,
    and two `telemetry calibrate` fits of the barrier run, byte-equal."""
    here = os.path.dirname(os.path.abspath(__file__))
    track = os.path.join(root, "buckets")
    series = lambda name: [(r["loss"], r["rel_volume"]) for r in map(json.loads, open(os.path.join(
        track, name, "metrics.jsonl")))]
    t0 = time.perf_counter()
    barrier = _driver_run_counted(_driver_args("lstm", STREAM21 + ",'bucket_pipeline':False}", STREAM21_STEPS,
                                               seed=seed, telemetry=True, track_dir=track, run_name="barrier"))
    expected = {"qsgd_encode_rows": STREAM21_STEPS, "qsgd_quantize": 0}
    _check(barrier["launches"] == expected, f"driver_barrier: launches {barrier['launches']}, expected {expected}")
    _check(not any(barrier["step_syncs"][1:]), f"driver_barrier: host syncs in steps 2-: {barrier['step_syncs']}")
    barrier_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", "deepreduce_tpu_torch.driver", "--model", "lstm", "--num_steps",
                        str(STREAM21_STEPS), "--num_workers", "1", "--seed", str(seed), "--log_every", "0",
                        "--telemetry", "--track_dir", track, "--run_name", "stream",
                        "--grace_config", STREAM21 + ",'stream_exchange':True}"],
                       cwd=here, capture_output=True, text=True, timeout=300)
    _check(p.returncode == 0, f"driver stream exited {p.returncode}: {p.stderr[-3000:]}")
    stream = json.loads(p.stdout.strip().splitlines()[-1])
    stream_s = time.perf_counter() - t0
    _check(series("stream") == series("barrier") and len(series("stream")) == STREAM21_STEPS,
           f"streamed and barrier series differ: {series('stream')} {series('barrier')}")
    tele = lambda *a: subprocess.run([sys.executable, "-m", "deepreduce_tpu_torch.telemetry", *a], cwd=here,
                                     capture_output=True, text=True, timeout=300)
    t0 = time.perf_counter()
    o = tele("trace", os.path.join(track, "stream"), "--overlap")
    # exit 1 is a fraction below the 0.5 gate: a measurement all the same
    _check(o.returncode in (0, 1), f"telemetry trace --overlap exited {o.returncode}: {o.stderr[-2000:]}")
    fractions = [float(l.rsplit(" ", 1)[1]) for l in o.stdout.splitlines() if "overlap fraction" in l]
    _check(len(fractions) == STREAM21_STEPS, f"overlap fractions: {o.stdout[-2000:]}")
    outs = [os.path.join(root, f"profile{i}.json") for i in (1, 2)]
    for out in outs:
        c = tele("calibrate", os.path.join(track, "barrier"), "--out", out)
        _check(c.returncode == 0, f"telemetry calibrate exited {c.returncode}: {c.stdout[-1500:]} {c.stderr[-1500:]}")
    same = open(outs[0], "rb").read() == open(outs[1], "rb").read()
    _check(same, "two calibrate fits of one run differ")
    return {
        "launches": barrier["launches"], "barrier_step_syncs": [len(x) for x in barrier["step_syncs"]],
        "barrier_examples_per_sec": barrier["result"]["examples_per_sec"],
        "stream_examples_per_sec": stream["examples_per_sec"], "payload_bytes_per_step": stream["payload_bytes_per_step"],
        "series": series("stream"), "overlap_rc": o.returncode, "overlap_fractions": fractions,
        "overlap_overall": o.stdout.strip().splitlines()[-1], "calibrate_byte_equal": same,
        "seconds": {"barrier": barrier_s, "stream_process": stream_s, "cli": time.perf_counter() - t0},
        "card": _card(),
    }


def phase_driver(seed: int, phase5: dict) -> dict:
    """Phase 21: the training driver. Returns {arm: result}; each arm's
    `launches` are its counted kernel launches."""
    import shutil

    import torch

    from deepreduce_tpu_torch.telemetry import spans

    t0 = time.perf_counter()
    spans.configure(enabled=False, reset=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_phase21_")
    results = {}
    try:
        for arm in DRIVER21:
            t1 = time.perf_counter()
            results[arm] = _driver_arm(arm, seed, root, phase5)
            results[arm]["seconds"] = time.perf_counter() - t1
            print(f"phase 21 ok: {arm} " + json.dumps(results[arm]), flush=True)
            torch.cuda.empty_cache()
        t1 = time.perf_counter()
        results["driver_resume"] = _driver_resume(seed, root)
        results["driver_resume"]["seconds"] = time.perf_counter() - t1
        print("phase 21 ok: driver_resume " + json.dumps(results["driver_resume"]), flush=True)
        torch.cuda.empty_cache()
        results["driver_stream"] = _driver_stream(seed, root)
        print("phase 21 ok: driver_stream " + json.dumps(results["driver_stream"]), flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"phase 21 time {time.perf_counter() - t0:.1f} s", flush=True)
    return results


def phase_timing(encode: dict, errs: dict, by_arm: dict, quantize: dict) -> None:
    # each path's run, counted from 0 just before it (phases 5 and 7-21)
    total = lambda name: sum(counts[name] for counts in by_arm.values())
    kernels = [
        _quantize_entry(quantize, total("qsgd_quantize"), errs["qsgd_quantize"]),
        dict(encode, launches=total("qsgd_encode_rows")),
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
    laps, last = {}, [t0]

    def lap(name):  # the wall seconds since the previous lap
        now = time.perf_counter()
        laps[name], last[0] = round(now - last[0], 1), now

    phase_device()
    phase_build()
    lap("1-2 device, build")
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
    lap("3-4 kernels")
    phase_codec(args.seed)
    # phase 6's device times, before any phase runs its workers as threads:
    # after the in-process phases the profiler drops kernel records (after
    # phase 17's grid and phases 12-13 it once saw none of a 200-launch window)
    encode = _time_encode(ex, 0, errs["qsgd_encode_rows"])
    lap("codec, 6 encode")
    import torch.distributed as dist

    tokens = _tokens(args.seed, args.steps, args.batch, args.seq, shapes["Embed_0/embedding"][0])
    # one rank through NCCL, so that the real collectives run
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        res = phase_train(args.seed, tokens, dist.group.WORLD, args.profile)
        _check(res["qsgd_sizes"] == sizes, "main-path QSGD sizes differ from the codec geometry")
        lap("5 train")
        arms = phase_arms(args.seed, tokens, dist.group.WORLD, res["cpu_ref_loss0"], args.profile)
        lap("7 arms")
        resnet = phase_resnet(args.seed, dist.group.WORLD, args.profile)
        lap("8 resnet")
        in_coll, quantize = phase_in_collective(args.seed, tokens, dist.group.WORLD, res["cpu_ref_loss0"],
                                                args.profile)
        lap("9 in-collective")
        bucketed = phase_bucketed(args.seed, tokens, dist.group.WORLD, res["cpu_ref_loss0"], args.profile)
        lap("10 bucketed")
        zoo = phase_zoo(args.seed, tokens, dist.group.WORLD, res["cpu_ref_loss0"], args.profile)
        lap("11 zoo")
        models14 = phase_models(args.seed, dist.group.WORLD, args.profile)
        lap("14 models")
        host15 = phase_host_codecs(args.seed, tokens, dist.group.WORLD, res["cpu_ref_loss0"], args.profile)
        lap("15 host codecs")
        resil16, _ = phase_resilience(args.seed, tokens, dist.group.WORLD, res["cpu_ref_loss0"])
        lap("16 resilience")
        two_tier17 = phase_two_tier(args.seed, tokens, dist.group.WORLD, res["cpu_ref_loss0"])
        lap("17 two tiers")
        fedsim18 = phase_fedsim(args.seed, dist.group.WORLD)
        lap("18 fedsim")
        res["steps"] = args.steps
        tele19 = phase_telemetry(args.seed, dist.group.WORLD, res)
        lap("19 telemetry")
        driver21 = phase_driver(args.seed, res)
        lap("21 driver")
    finally:
        dist.destroy_process_group()
    fed = phase_fedavg(args.seed, args.profile)
    lap("12 fedavg")
    table6 = phase_table6(args.seed)
    lap("13 table 6")
    seq20 = phase_seq_tensor(args.seed)
    lap("20 seq, tensor")
    by_arm = {"drqsgd_bloom": res["launches"]}
    for phase in (arms, resnet, in_coll, bucketed, zoo, models14, fed, table6, host15, resil16, two_tier17, fedsim18,
                  tele19, seq20, driver21):
        by_arm.update({a: r["launches"] for a, r in phase.items()})
    phase_timing(encode, errs, by_arm, quantize)
    lap("timing")
    print("phase times " + json.dumps(laps), flush=True)
    print(f"chip_smoke total {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
