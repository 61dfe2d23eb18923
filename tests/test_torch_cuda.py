"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: each test skips on a machine without CUDA (such as a
CPU-only test runner) and runs on the GPU with
`python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest` (the
repository's conftest imports jax, which the GPU machine need not have)."""

import dataclasses

import pytest
import torch

from deepreduce_tpu_torch.ops import (
    EncodeSegment,
    philox_uniforms_plain,
    qsgd_encode_rows,
    qsgd_encode_rows_plain,
    quantize_levels,
    quantize_levels_plain,
)
from deepreduce_tpu_torch.ops.qsgd_encode import MAX_SEGMENTS, rows_nbytes

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("n", [1, 5, 1536, 114_688, 1_000_003])
def test_qsgd_kernel_bitwise_equals_plain(cuda, n):
    gen = torch.Generator().manual_seed(n)
    v = torch.randn(n, generator=gen)
    v[torch.rand(n, generator=gen) < 0.3] = 0.0
    s = torch.rand(n, generator=gen) * 200
    seed, offset = (7 << 32) | n, (3 << 32) | 1
    before = quantize_levels.launches
    got = quantize_levels(v.to(cuda), s.to(cuda), seed, offset, device=cuda)
    torch.cuda.synchronize()
    assert quantize_levels.launches == before + 1
    ref = quantize_levels_plain(v, s, philox_uniforms_plain(n, seed, offset))
    assert torch.equal(got.cpu(), ref)


def test_qsgd_kernel_rejects_cpu_tensors_and_bad_dtypes(cuda):
    v = torch.zeros(8)
    with pytest.raises(ValueError):
        quantize_levels(v, v, 0, 0, device=cuda)
    with pytest.raises(ValueError):
        quantize_levels(v.to(cuda).half(), v.to(cuda).half(), 0, 0, device=cuda)


def _values(k, seed):
    gen = torch.Generator().manual_seed(seed)
    v = torch.randn(k, generator=gen) * 0.05
    v[torch.rand(k, generator=gen) < 0.3] = 0.0
    return v


@pytest.mark.parametrize("bs", [512, 100, 1024, 1000, 2048])
@pytest.mark.parametrize("k", [1, 5, 513, 114_688, 1_000_003])
def test_qsgd_encode_rows_bitwise_equals_plain(cuda, k, bs):
    v = _values(k, k + bs)
    seed, offset = (5 << 32) | k, (bs << 32) | 3
    n = rows_nbytes(k, bs)
    seg = EncodeSegment(v, 0, seed, offset)
    ref = torch.zeros(n, dtype=torch.uint8)
    qsgd_encode_rows_plain([seg], 127, bs, ref)
    out = torch.zeros(n, dtype=torch.uint8, device=cuda)
    before = qsgd_encode_rows.launches
    qsgd_encode_rows([EncodeSegment(v.to(cuda), 0, seed, offset)], out, quantum_num=127, bucket_size=bs, device=cuda)
    torch.cuda.synchronize()
    assert qsgd_encode_rows.launches == before + 1
    assert torch.equal(out.cpu(), ref)


@pytest.mark.parametrize("values_shift,out_shift", [(0, 0), (1, 0), (0, 1), (3, 2)])
def test_qsgd_encode_rows_table_and_alignment(cuda, values_shift, out_shift):
    """More segments than one launch's table (two launches), values that
    start off a 16-byte boundary and rows off a 4-byte boundary."""
    bs, count = 512, MAX_SEGMENTS + 6
    ks = [1 + (37 * i) % 2000 for i in range(count)]
    segs_cpu, segs_dev, off = [], [], out_shift
    for i, k in enumerate(ks):
        v = _values(k + values_shift, 1000 + i)
        vd = v.to(cuda)[values_shift:]
        segs_cpu.append(EncodeSegment(v[values_shift:].contiguous(), off, 77 + i, i))
        segs_dev.append(EncodeSegment(vd, off, 77 + i, i))
        off += rows_nbytes(k, bs)
    ref = torch.zeros(off, dtype=torch.uint8)
    qsgd_encode_rows_plain(segs_cpu, 127, bs, ref)
    out = torch.zeros(off, dtype=torch.uint8, device=cuda)
    before = qsgd_encode_rows.launches
    qsgd_encode_rows(segs_dev, out, quantum_num=127, bucket_size=bs, device=cuda)
    torch.cuda.synchronize()
    assert qsgd_encode_rows.launches == before + 2
    assert torch.equal(out.cpu(), ref)


def _card_vs_plain(cuda, ks, bs, values_shift=0, out_shift=0, seed=0):
    """(rows from the kernel, rows from the plain version, launches) of one
    table of segments of sizes `ks`, values starting `values_shift` floats
    past an allocation (one shift, or one per segment), rows `out_shift`
    bytes into the buffer."""
    shifts = values_shift if isinstance(values_shift, (list, tuple)) else [values_shift] * len(ks)
    segs_cpu, segs_dev, off = [], [], out_shift
    for i, (k, vs) in enumerate(zip(ks, shifts)):
        v = _values(k + vs, seed + i)
        segs_cpu.append(EncodeSegment(v[vs:].contiguous(), off, (seed << 32) | i, (i << 32) | 3))
        segs_dev.append(EncodeSegment(v.to(cuda)[vs:], off, (seed << 32) | i, (i << 32) | 3))
        off += rows_nbytes(k, bs)
    ref = torch.zeros(off, dtype=torch.uint8)
    qsgd_encode_rows_plain(segs_cpu, 127, bs, ref)
    out = torch.zeros(off, dtype=torch.uint8, device=cuda)
    before = qsgd_encode_rows.launches
    qsgd_encode_rows(segs_dev, out, quantum_num=127, bucket_size=bs, device=cuda)
    torch.cuda.synchronize()
    return out.cpu(), ref, qsgd_encode_rows.launches - before


@pytest.mark.parametrize("values_shift,out_shift", [(0, 0), (1, 0), (0, 1), (3, 2), ((0, 1, 3), 0)])
@pytest.mark.parametrize("bs", [100, 1000, 1024, 2048, 3, 514, 8192])
def test_qsgd_encode_rows_bucket_sizes_and_shifts(cuda, bs, values_shift, out_shift):
    """Bucket sizes below, between and above 512 (padded to 128 * J, a
    bucket over one or several warps) and ones that are not a multiple of 4
    or lie above 4,096 (the generic kernel), with values off a 16-byte
    boundary (scalar loads; in one launch, some segments on it and some
    off) and rows off a 4-byte one: bitwise the plain version."""
    got, ref, launches = _card_vs_plain(cuda, [1, 3 * bs - 5, 10_007], bs, values_shift, out_shift, seed=bs)
    assert launches == 1
    assert torch.equal(got, ref)


@pytest.mark.parametrize("count,launches", [(57, 1), (76, 1), (88, 1), (MAX_SEGMENTS + 1, 2)])
def test_qsgd_encode_rows_segment_tables(cuda, count, launches):
    """Tables of 57 segments (the FedAvg MobileNet S2C tree's count), 76
    (ResNet-50's QSGD arm), 88 (BERT-base's) and one past the table (two
    launches, both counted), with a size mix from one value to many
    buckets."""
    ks = [1 + (7919 * i) % 9000 for i in range(count)]
    got, ref, n = _card_vs_plain(cuda, ks, 512, seed=count)
    assert n == launches
    assert torch.equal(got, ref)


def test_qsgd_encode_rows_one_large_segment(cuda):
    """One 4,050,944-element segment (7,912 buckets): bitwise the plain version."""
    got, ref, launches = _card_vs_plain(cuda, [4_050_944], 512, seed=4)
    assert launches == 1
    assert torch.equal(got, ref)


def test_qsgd_encode_floor_writes_nothing_and_is_not_counted(cuda):
    """The launch floor's empty kernel takes the same table and leaves the
    buffer and the launch count alone."""
    from deepreduce_tpu_torch.ops import qsgd_encode_floor

    segs = [EncodeSegment(_values(1000, i).to(cuda), 1032 * i, i, 0) for i in range(3)]
    out = torch.full((3 * 1032,), 7, dtype=torch.uint8, device=cuda)
    before = qsgd_encode_rows.launches
    qsgd_encode_floor(segs, out, quantum_num=127, bucket_size=512)
    torch.cuda.synchronize()
    assert qsgd_encode_rows.launches == before
    assert bool((out == 7).all())


def test_qsgd_encode_rows_refuses_uniforms_and_cpu_tensors(cuda):
    out = torch.zeros(516, dtype=torch.uint8, device=cuda)
    v = torch.zeros(512, device=cuda)
    with pytest.raises(ValueError):
        qsgd_encode_rows([EncodeSegment(v, 0, 0, 0, uniforms=torch.zeros(512))], out,
                         quantum_num=127, bucket_size=512, device=cuda)
    with pytest.raises(ValueError):
        qsgd_encode_rows([EncodeSegment(v.cpu(), 0, 0, 0)], out, quantum_num=127, bucket_size=512, device=cuda)


def test_qsgd_encode_rows_resnet20_table(cuda):
    """The ResNet-20 DRQSGD arm's table: 19 segments of 20..368 values at
    their leaves' offsets in the fused buffer, every bucket partial."""
    from deepreduce_tpu_torch import DeepReduceConfig, GradientExchanger
    from deepreduce_tpu_torch.models import ResNet20

    shapes = {n: tuple(p.shape) for n, p in ResNet20().flax_params().items()}
    cfg = DeepReduceConfig(compressor="topk", compress_ratio=0.01, deepreduce="both", index="bloom",
                           value="qsgd", fpr=0.001, policy="leftmost")
    ex = GradientExchanger(shapes, cfg, device=cuda)
    segs_cpu, segs_dev = [], []
    for i, n in enumerate(ex.names):
        c = ex.codecs[n]
        if c.rows_leaf is None:
            continue
        v = _values(c.val_codec.meta.k, 2000 + i)
        off = ex.offsets[n] + ex.layouts[n].leaf_offsets[c.rows_leaf]
        segs_cpu.append(EncodeSegment(v, off, 91 + i, (3 << 32) | i))
        segs_dev.append(EncodeSegment(v.to(cuda), off, 91 + i, (3 << 32) | i))
    assert len(segs_cpu) == 19 and {s.values.shape[0] for s in segs_cpu} == {20, 23, 46, 92, 184, 368}
    ref = torch.zeros(ex.fused_nbytes, dtype=torch.uint8)
    qsgd_encode_rows_plain(segs_cpu, 127, 512, ref)
    out = torch.zeros(ex.fused_nbytes, dtype=torch.uint8, device=cuda)
    before = qsgd_encode_rows.launches
    qsgd_encode_rows(segs_dev, out, quantum_num=127, bucket_size=512, device=cuda)
    torch.cuda.synchronize()
    assert qsgd_encode_rows.launches == before + 1
    assert torch.equal(out.cpu(), ref)


def test_quickstart_codec_card_equals_cpu(cuda):
    """The README quick start's TensorCodec (classic bloom, PolyFit) on the
    largest ResNet-20 conv gradient: every integer leaf bitwise equal on the
    card and the CPU, the coefficients and the decode within tolerance."""
    from deepreduce_tpu_torch import DeepReduceConfig, TensorCodec

    cfg = DeepReduceConfig(compressor="topk", compress_ratio=0.01, deepreduce="both", index="bloom",
                           value="polyfit", fpr=0.001, policy="leftmost")
    g = torch.randn(3, 3, 64, 64, generator=torch.Generator().manual_seed(4)) * 0.05
    pays = {}
    for dev in (cuda, torch.device("cpu")):
        codec = TensorCodec(g.shape, cfg, name="BasicBlockV2_8/Conv_1/kernel", device=dev)
        pay = codec.encode(g.to(dev))
        pays[dev.type] = (pay, codec.decode(pay).cpu())
    (gp, gdec), (cp, cdec) = pays["cuda"], pays["cpu"]
    for i, (a, b) in enumerate(zip(gp.leaves(), cp.leaves())):
        if b is cp.value_payload.coeffs:
            torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-6 * float(g.abs().max()))
        else:
            assert torch.equal(a.cpu(), b), i
    torch.testing.assert_close(gdec, cdec, rtol=0, atol=1e-5 * float(g.abs().max()))


# the in-collective routes as `chip_smoke.py` phase 9 runs them
IN_COLLECTIVE = {
    "qar": dict(communicator="qar", compressor="none", memory="none"),
    "rs_sparse": dict(communicator="sparse_rs", rs_mode="sparse"),
    "rs_adaptive": dict(communicator="sparse_rs", rs_mode="adaptive", rs_density_threshold=0.05),
    "rs_quantized": dict(communicator="sparse_rs", rs_mode="quantized"),
    "rs_oktopk": dict(communicator="sparse_rs", rs_mode="oktopk"),
}
QUANTIZE_LAUNCHES = {"qar": 2, "rs_sparse": 0, "rs_adaptive": 1, "rs_quantized": 1, "rs_oktopk": 0}


@pytest.mark.parametrize("route", list(IN_COLLECTIVE))
def test_in_collective_route_card_equals_cpu(cuda, route):
    """One exchange of a 200,000-element gradient (two leaves, a residual)
    on the card and on the CPU under the same Philox streams: the mean and
    the new residual bitwise equal, the quantizer kernel launched as often
    as the route quantizes."""
    from deepreduce_tpu_torch import DeepReduceConfig, GradientExchanger

    cfg = DeepReduceConfig(compress_ratio=0.1, **IN_COLLECTIVE[route], seed=5)
    shapes = {"a/kernel": (300, 600), "b": (20_000,)}
    gen = torch.Generator().manual_seed(6)
    grads = {n: torch.randn(s, generator=gen) * (torch.rand(s, generator=gen) > 0.3) for n, s in shapes.items()}
    res = {n: torch.randn(s, generator=gen) * 1e-2 for n, s in shapes.items()}
    out = {}
    for dev in (cuda, torch.device("cpu")):
        ex = GradientExchanger(shapes, cfg, device=dev)
        r = None if cfg.memory == "none" else {n: t.to(dev) for n, t in res.items()}
        before = quantize_levels.launches
        agg, new_res, _ = ex.exchange({n: g.to(dev) for n, g in grads.items()}, r, step=2)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert quantize_levels.launches - before == QUANTIZE_LAUNCHES[route]
        out[dev.type] = (agg, new_res)
    (gagg, gres), (cagg, cres) = out["cuda"], out["cpu"]
    for n in shapes:
        assert torch.equal(gagg[n].cpu(), cagg[n]), n
        assert (gres is None) == (cres is None) and (gres is None or torch.equal(gres[n].cpu(), cres[n])), n


def test_qsgd_quantize_at_the_qar_size(cuda):
    """The per-leaf quantizer at the size qar gives it on the full-width
    WordLSTM (4,050,944 = pad_len(4,050,748, 1, 512)), bitwise equal to its
    plain version."""
    n = 4_050_944
    gen = torch.Generator().manual_seed(9)
    v = torch.randn(n, generator=gen)
    s = torch.rand(n, generator=gen) * 300
    seed, offset = (11 << 32) | 5, (2 << 32) | 7
    got = quantize_levels(v.to(cuda), s.to(cuda), seed, offset, device=cuda)
    ref = quantize_levels_plain(v, s, philox_uniforms_plain(n, seed, offset))
    assert torch.equal(got.cpu(), ref)


BUCKET_FLAGSHIP = dict(compressor="topk", compress_ratio=0.1, memory="residual", deepreduce="both", index="bloom",
                       value="qsgd", fpr=0.02, policy="p0", bloom_blocked="mod", min_compress_size=100, seed=3)


def test_bucketed_exchange_makes_one_encode_launch(cuda):
    """Every bucket's QSGD rows in one qsgd_encode_rows launch; the aggregate
    and the residuals bitwise equal on the card and the CPU."""
    from deepreduce_tpu_torch import DeepReduceConfig, GradientExchanger

    cfg = DeepReduceConfig(**BUCKET_FLAGSHIP, bucket_bytes=40_000)
    shapes = {"a/kernel": (100, 100), "b": (9_000,), "c": (3_000,), "d": (400,)}
    gen = torch.Generator().manual_seed(8)
    grads = {n: torch.randn(s, generator=gen) for n, s in shapes.items()}
    res = {n: torch.randn(s, generator=gen) * 1e-2 for n, s in shapes.items()}
    out = {}
    for dev in (cuda, torch.device("cpu")):
        ex = GradientExchanger(shapes, cfg, device=dev)
        before = qsgd_encode_rows.launches
        agg, new_res, _ = ex.exchange({n: g.to(dev) for n, g in grads.items()}, {n: r.to(dev) for n, r in res.items()},
                                      step=1)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert ex.num_buckets == 3 and qsgd_encode_rows.launches - before == 1
        out[dev.type] = (agg, new_res)
    for n in shapes:
        assert torch.equal(out["cuda"][0][n].cpu(), out["cpu"][0][n]), n
        assert torch.equal(out["cuda"][1][n].cpu(), out["cpu"][1][n]), n


def test_streamed_step_runs_on_a_side_stream_and_equals_the_barrier_step(cuda, monkeypatch):
    """The streamed Trainer step encodes and gathers each bucket on the
    side stream, one launch per bucket, and two steps equal two
    barrier-scheduled ones bitwise."""
    from deepreduce_tpu_torch import DeepReduceConfig, Trainer
    from deepreduce_tpu_torch.comm_bucket import BucketedExchanger
    from deepreduce_tpu_torch.models import WordLSTM

    streams = []
    real = BucketedExchanger.run_streaming_bucket

    def spy(self, *args, **kw):
        streams.append(torch.cuda.current_stream())
        return real(self, *args, **kw)

    monkeypatch.setattr(BucketedExchanger, "run_streaming_bucket", spy)
    tokens = torch.randint(0, 256, (2, 8, 11), generator=torch.Generator().manual_seed(1)).to(cuda)
    knobs = dict(BUCKET_FLAGSHIP, bucket_bytes=20_000, bucket_order="reverse")
    states = {}
    for arm, extra in (("streamed", dict(stream_exchange=True)), ("barrier", dict(bucket_pipeline=False))):
        trainer = Trainer(WordLSTM(256, 16, 32, seed=2), DeepReduceConfig(**knobs, **extra), lr=0.1, momentum=0.9,
                          device=cuda)
        state = trainer.init_state()
        buckets = trainer.exchanger.num_buckets
        before = qsgd_encode_rows.launches
        for i in range(2):
            state, _, _ = trainer.step(state, (tokens[i, :, :-1], tokens[i, :, 1:]))
        torch.cuda.synchronize()
        launches = qsgd_encode_rows.launches - before
        if arm == "streamed":
            assert streams and all(s == trainer.streaming.side for s in streams)
            assert len(streams) == 2 * buckets and launches == 2 * buckets > 2
        else:
            assert launches == 2
        states[arm] = state
    for n, p in states["streamed"].params.items():
        assert torch.equal(p, states["barrier"].params[n]), n
        assert torch.equal(states["streamed"].residuals[n], states["barrier"].residuals[n]), n


def test_value_mode_grouped_launch_randomk_qsgd_table(cuda):
    """The `randomk_qsgd` arm's value-only QSGD: one grouped launch writes
    every compressed leaf's rows (random-k's k values each, at the QSGD
    payload's first leaf) bitwise equal to the plain version, and one
    exchange of its WordLSTM-shaped gradient makes that one launch with the
    card equal to the CPU bitwise."""
    from deepreduce_tpu_torch import DeepReduceConfig, GradientExchanger
    from deepreduce_tpu_torch.models import WordLSTM

    cfg = DeepReduceConfig(compressor="randomk", compress_ratio=0.1, deepreduce="value", value="qsgd", seed=3)
    shapes = {n: tuple(p.shape) for n, p in WordLSTM(512, 24, 48).flax_params().items()}
    ex = GradientExchanger(shapes, cfg, device=cuda)
    segs_cpu, segs_dev = [], []
    for i, n in enumerate(ex.names):
        c = ex.codecs[n]
        if c.rows_leaf is None:
            continue
        assert c.rows_leaf == 0 and c.idx_codec is None
        v = _values(c.k, 3000 + i)
        off = ex.offsets[n] + ex.layouts[n].leaf_offsets[c.rows_leaf]
        segs_cpu.append(EncodeSegment(v, off, 17 + i, (2 << 32) | i))
        segs_dev.append(EncodeSegment(v.to(cuda), off, 17 + i, (2 << 32) | i))
    assert len(segs_cpu) >= 8
    ref = torch.zeros(ex.fused_nbytes, dtype=torch.uint8)
    qsgd_encode_rows_plain(segs_cpu, 127, 512, ref)
    out = torch.zeros(ex.fused_nbytes, dtype=torch.uint8, device=cuda)
    before = qsgd_encode_rows.launches
    qsgd_encode_rows(segs_dev, out, quantum_num=127, bucket_size=512, device=cuda)
    torch.cuda.synchronize()
    assert qsgd_encode_rows.launches == before + 1
    assert torch.equal(out.cpu(), ref)
    gen = torch.Generator().manual_seed(8)
    grads = {n: torch.randn(s, generator=gen) * 0.05 for n, s in shapes.items()}
    res = {n: torch.zeros(s) for n, s in shapes.items()}
    outs = {}
    for dev in (cuda, torch.device("cpu")):
        e = ex if dev.type == "cuda" else GradientExchanger(shapes, cfg, device=dev)
        before = qsgd_encode_rows.launches
        agg, new_res, _ = e.exchange({n: g.to(dev) for n, g in grads.items()},
                                     {n: r.to(dev) for n, r in res.items()}, step=4)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert qsgd_encode_rows.launches - before == 1
        outs[dev.type] = (agg, new_res)
    for n in shapes:
        assert torch.equal(outs["cuda"][0][n].cpu(), outs["cpu"][0][n]), n
        assert torch.equal(outs["cuda"][1][n].cpu(), outs["cpu"][1][n]), n


def test_count_sketch_agrees_with_the_cpu_on_the_card(cuda):
    """The count sketch's column sums (one `index_add_` per row) on the
    card within 1e-6 of max |v| of the CPU's: the card's atomics add each
    column in the order they land, the CPU in slot order."""
    from deepreduce_tpu_torch.codecs import countsketch

    k = 96_038  # Embed_0's slot budget at ratio 0.1
    gen = torch.Generator().manual_seed(12)
    vals = torch.randn(k, generator=gen)
    idx = torch.randperm(960_384, generator=gen)[:k].to(torch.int32)
    cols = -(-2 * k // 5)
    got = countsketch.sketch_from_sparse(vals.to(cuda), idx.to(cuda), 5, cols, seed=1)
    ref = countsketch.sketch_from_sparse(vals, idx, 5, cols, seed=1)
    torch.testing.assert_close(got.cpu(), ref, rtol=0, atol=1e-6 * float(vals.abs().max()))


def _narrow_mobilenet_tree(device, seed):
    """A narrow MobileNetV1's parameters as a gradient-sized tree (normal
    times 1e-3, 30% exact zeros), on `device`."""
    from deepreduce_tpu_torch.models import MobileNetV1

    gen = torch.Generator().manual_seed(seed)
    tree = {}
    for n, p in MobileNetV1(width_mult=0.5).flax_params().items():
        v = torch.randn(p.shape, generator=gen) * 1e-3
        v[torch.rand(p.shape, generator=gen) < 0.3] = 0.0
        tree[n] = v.to(device)
    return tree


@pytest.mark.parametrize("direction,with_residual", [("s2c", False), ("c2s", True)])
def test_tree_encode_is_one_launch_and_card_equals_cpu(cuda, direction, with_residual):
    """`TreeCodec.compress_tree` on the card: every QSGD leaf's rows in one
    grouped launch, bitwise the plain rows of that table, and the decoded
    tree and residual bitwise the CPU's."""
    import dataclasses

    from deepreduce_tpu_torch import DeepReduceConfig, TreeCodec
    from deepreduce_tpu_torch.wrappers import encode_group

    cfg = DeepReduceConfig(compressor="topk", compress_ratio=0.1, deepreduce="both", index="bloom", value="qsgd",
                           policy="p0", fpr=0.02, bloom_blocked="mod", min_compress_size=500)
    tree = _narrow_mobilenet_tree(cuda, 5)
    res = _narrow_mobilenet_tree(cuda, 6) if with_residual else None
    tc = TreeCodec(direction, cfg, device=cuda)
    before = qsgd_encode_rows.launches
    tc.encode_tree(tree, res, step=2, worker=1)
    torch.cuda.synchronize()
    assert qsgd_encode_rows.launches == before + 1
    # the tree's grouped encode, its rows against the plain version's on
    # the launch's own segment table
    _, _, units, nbytes = tc.group(tree, res)
    rows = torch.zeros(nbytes, dtype=torch.uint8, device=cuda)
    _, segs = encode_group(units, rows, step=2, worker=1)
    assert len(segs) > 1
    ref = torch.zeros(nbytes, dtype=torch.uint8)
    qsgd_encode_rows_plain([dataclasses.replace(s, values=s.values.cpu()) for s in segs], cfg.quantum_num,
                           cfg.bucket_size, ref)
    assert torch.equal(rows.cpu(), ref)
    cpu = lambda t: None if t is None else {n: x.cpu() for n, x in t.items()}
    card = tc.compress_tree(tree, res, step=2, worker=1)
    host = TreeCodec(direction, cfg, device="cpu").compress_tree(cpu(tree), cpu(res), step=2, worker=1)
    for n in tree:
        assert torch.equal(card[0][n].cpu(), host[0][n]), n
        if with_residual:
            assert torch.equal(card[1][n].cpu(), host[1][n]), n


def _small_model(name, dtype=None):
    from deepreduce_tpu_torch.models import VGG16, BertEncoder, DenseNet40, ResNet50

    ctor = {
        "resnet50": lambda: ResNet50(num_classes=10, stage_sizes=(1, 1, 1, 1), dtype=dtype),
        "densenet40": lambda: DenseNet40(growth=4, layers_per_block=2),
        "vgg16": lambda: VGG16(stages=((8, 1), (16, 2), (16, 1))),
        "bert": lambda: BertEncoder(vocab_size=50, hidden=32, layers=2, heads=4, mlp_dim=64, max_len=16),
    }[name]
    return ctor()


@pytest.mark.parametrize("name,dtype,tol", [("resnet50", torch.bfloat16, 5e-2), ("resnet50", None, 1e-4),
                                            ("densenet40", None, 1e-4), ("vgg16", None, 1e-4), ("bert", None, 1e-4)])
def test_model_forward_card_equals_cpu(cuda, name, dtype, tol):
    """A small copy of each phase-14 model in training mode: the card's
    logits within `tol` of the largest of the CPU's (bfloat16: 8-bit outputs
    whose last-bit differences compound over the layers)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = _small_model(name, dtype)
    gen = torch.Generator().manual_seed(3)
    x = torch.randint(0, 50, (4, 9), generator=gen) if name == "bert" else torch.randn(4, 32, 32, 3, generator=gen)
    import copy

    with torch.no_grad():
        ref = copy.deepcopy(model)(x)
        got = model.to(cuda)(x.to(cuda)).cpu()
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert float((got - ref).abs().max()) <= tol * float(ref.abs().max())


def test_checkpoint_restores_bitwise_on_the_card(cuda, tmp_path):
    """Two DRQSGD-BF-P0 steps of a small ResNet-50 on the card, a save, a
    restore into a fresh Trainer: every parameter, statistic, momentum
    buffer and residual bitwise the saved one, the restored tensors on the
    card, one qsgd_encode_rows launch a step, and a finite next step."""
    import deepreduce_tpu_torch as port
    from deepreduce_tpu_torch import checkpoint

    cfg = port.DeepReduceConfig(compressor="topk", compress_ratio=0.1, memory="residual", deepreduce="both",
                                index="bloom", value="qsgd", fpr=0.02, policy="p0", bloom_blocked="mod")
    gen = torch.Generator().manual_seed(5)
    batches = [(torch.randn(4, 32, 32, 3, generator=gen).to(cuda), torch.randint(0, 10, (4,), generator=gen).to(cuda))
               for _ in range(3)]
    tr = port.Trainer(_small_model("resnet50"), cfg, lr=0.1, momentum=0.9, device=cuda)
    state = tr.init_state()
    before = qsgd_encode_rows.launches
    for b in batches[:2]:
        state, _, _ = tr.step(state, b)
    assert qsgd_encode_rows.launches == before + 2
    path = str(tmp_path / "state.pt")
    checkpoint.save(path, state, config=cfg)
    fresh = port.Trainer(_small_model("resnet50"), cfg, lr=0.1, momentum=0.9, device=cuda)
    restored = checkpoint.restore(path, fresh, config=cfg)
    assert restored.step == 2
    pairs = [(state.params[n], restored.params[n]) for n in state.params]
    pairs += [(state.batch_stats[n], restored.batch_stats[n]) for n in state.batch_stats]
    pairs += [(state.residuals[n], restored.residuals[n]) for n in state.residuals]
    pairs += [(state.optimizer.state[p]["momentum_buffer"], restored.optimizer.state[q]["momentum_buffer"])
              for p, q in zip(state.params.values(), restored.params.values())]
    assert all(b.is_cuda and torch.equal(a, b) for a, b in pairs)
    restored, loss, _ = fresh.step(restored, batches[2])
    assert torch.isfinite(loss).item()


# the host codecs as `chip_smoke.py` phase 15 runs them: knobs over the
# flagship's, and the blocking copies one host leaf's encode makes
HOST_ARMS = {
    "drqsgd_huffman": (dict(index="huffman"), 1),
    "drqsgd_varint": (dict(index="integer_native", code="varint"), 3),
    "drqsgd_pfor": (dict(index="integer_native", code="pfor"), 3),
    "bloom_native_p2": (dict(deepreduce="index", index="bloom_native", policy="conflict_sets"), 3),
    "topr_gzip": (dict(deepreduce="value", value="gzip"), 1),
    "topr_polyfit_host": (dict(deepreduce="value", value="polyfit_host"), 1),
}


@pytest.mark.parametrize("arm", list(HOST_ARMS))
def test_host_codec_exchange_card_equals_cpu_and_counts_its_syncs(cuda, arm):
    """One exchange of a small three-leaf gradient (two host leaves) under a
    host arm on the card and on the CPU: the aggregate and the residuals
    bitwise equal; on the card the exchange's host syncs are exactly its
    copies (the encode's per host leaf, one per gathered row) and the QSGD
    arms make one qsgd_encode_rows launch."""
    import warnings

    from deepreduce_tpu_torch import DeepReduceConfig, GradientExchanger

    knobs, copies = HOST_ARMS[arm]
    cfg = DeepReduceConfig(**{**BUCKET_FLAGSHIP, **knobs})
    shapes = {"a/kernel": (100, 100), "b": (9_000,), "c": (40,)}
    gen = torch.Generator().manual_seed(12)
    grads = {n: torch.randn(s, generator=gen) for n, s in shapes.items()}
    res = {n: torch.randn(s, generator=gen) * 1e-2 for n, s in shapes.items()}
    out = {}
    for dev in (cuda, torch.device("cpu")):
        ex = GradientExchanger(shapes, cfg, device=dev)
        assert ex.fused.host_units == ["a/kernel", "b"]
        g = {n: t.to(dev) for n, t in grads.items()}
        r = {n: t.to(dev) for n, t in res.items()}
        if dev.type == "cuda":
            torch.cuda.synchronize()
            before = qsgd_encode_rows.launches
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    agg, new_res, _ = ex.exchange(g, r, step=2)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            syncs = [str(w.message) for w in caught if "called a synchronizing" in str(w.message)]
            assert len(syncs) == copies * 2 + 1, syncs
            assert qsgd_encode_rows.launches - before == (1 if cfg.value == "qsgd" and cfg.deepreduce == "both" else 0)
        else:
            agg, new_res, _ = ex.exchange(g, r, step=2)
        out[dev.type] = (agg, new_res)
    (gagg, gres), (cagg, cres) = out["cuda"], out["cpu"]
    for n in shapes:
        assert torch.equal(gagg[n].cpu(), cagg[n]), n
        assert torch.equal(gres[n].cpu(), cres[n]), n


# -- the resilient fused exchange ------------------------------------------- #


def test_checksum_and_chaos_draws_card_equal_cpu(cuda):
    """The checksum words of 3 rows of 9 MB (past the 2**23 bytes an
    unsplit int64 sum would overflow at), their gates and the chaos
    stream's words on the card bitwise the CPU's."""
    from deepreduce_tpu_torch.comm import PayloadLayout
    from deepreduce_tpu_torch.resilience import chaos, stream

    n = 9_000_001
    gen = torch.Generator().manual_seed(2)
    layout = PayloadLayout([((n,), torch.uint8)], checksum=True)
    rows = torch.stack([layout.pack([torch.randint(0, 256, (n,), generator=gen, dtype=torch.uint8)])
                        for _ in range(3)])
    rows[1, 5] ^= 1
    got = layout.verify(rows.to(cuda))
    assert torch.equal(got.cpu(), layout.verify(rows)) and got.tolist() == [1.0, 0.0, 1.0]
    k = stream.key(3, 0x0C405, 1, 7, 2)
    assert torch.equal(stream.words(k, 1 << 20, cuda).cpu(), stream.words(k, 1 << 20, "cpu"))
    inj = chaos.ChaosInjector(corrupt_rate=1.0, truncate_rate=1.0, seed=3)
    buf = rows[0, :100_000]
    assert torch.equal(inj.perturb(buf.to(cuda), step=7, worker=2).cpu(), inj.perturb(buf, step=7, worker=2))


@pytest.mark.parametrize("strategy", ["loop", "vmap", "ring"])
def test_resilient_exchange_card_equals_cpu(cuda, strategy):
    """Four in-process workers, worker 2 dropped, the checksum and byte
    corruption at rate 0.5: the aggregate (a mean over a
    live count of 3 is an IEEE divide by a device tensor), the residuals and
    the failure count bitwise equal on the card and the CPU, with one
    qsgd_encode_rows launch a worker."""
    from deepreduce_tpu_torch import DeepReduceConfig, GradientExchanger, InProcessGroup

    W = 4
    cfg = DeepReduceConfig(**BUCKET_FLAGSHIP, resilience=True, payload_checksum=True, chaos_corrupt_rate=0.5,
                           decode_strategy=strategy, decode_batch=3)
    shapes = {"a/kernel": (100, 100), "b": (9_000,), "c": (400,)}
    gen = torch.Generator().manual_seed(13)
    grads = [{n: torch.randn(s, generator=gen) for n, s in shapes.items()} for _ in range(W)]
    res = [{n: torch.randn(s, generator=gen) * 1e-2 for n, s in shapes.items()} for _ in range(W)]
    out = {}
    for dev in (cuda, torch.device("cpu")):
        mask = torch.tensor([True, True, False, True]).to(dev)

        def work(coll, g, r, dev=dev, mask=mask):
            ex = GradientExchanger(shapes, cfg, device=dev, group=coll)
            collect = {}
            agg, new_r, _ = ex.exchange({n: t.to(dev) for n, t in g.items()}, {n: t.to(dev) for n, t in r.items()},
                                        step=1, collect=collect, mask=mask)
            return agg, new_r, collect["checksum_failures"]

        before = qsgd_encode_rows.launches
        out[dev.type] = InProcessGroup(W).run(work, grads, res)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert qsgd_encode_rows.launches - before == W
    assert float(out["cpu"][0][2]) > 0  # some payload failed its checksum
    for (gagg, gres, gf), (cagg, cres, cf) in zip(out["cuda"], out["cpu"]):
        assert float(gf) == float(cf)
        for n in shapes:
            assert torch.equal(gagg[n].cpu(), cagg[n]) and torch.equal(gres[n].cpu(), cres[n]), n


@pytest.mark.parametrize("route", ["sparse", "quantized", "oktopk"])
def test_masked_sparse_rs_card_equals_cpu(cuda, route):
    """The masked routes at W = 4 with worker 1 dropped: mean and residuals
    bitwise equal on the card and the CPU."""
    from deepreduce_tpu_torch import DeepReduceConfig, GradientExchanger, InProcessGroup

    W = 4
    cfg = DeepReduceConfig(communicator="sparse_rs", rs_mode=route, compress_ratio=0.1, resilience=True,
                           fault_plan="1@0:9", seed=5)
    shapes = {"a/kernel": (300, 60), "b": (2_000,)}
    gen = torch.Generator().manual_seed(14)
    grads = [{n: torch.randn(s, generator=gen) for n, s in shapes.items()} for _ in range(W)]
    res = [{n: torch.randn(s, generator=gen) * 1e-2 for n, s in shapes.items()} for _ in range(W)]
    out = {}
    for dev in (cuda, torch.device("cpu")):
        def work(coll, g, r, dev=dev):
            from deepreduce_tpu_torch.resilience.faults import participation_mask

            ex = GradientExchanger(shapes, cfg, device=dev, group=coll)
            mask = participation_mask(W, 2, cfg.seed, fault_plan=cfg.fault_plan, device=dev)
            return ex.exchange({n: t.to(dev) for n, t in g.items()}, {n: t.to(dev) for n, t in r.items()}, step=2,
                               mask=mask)[:2]

        out[dev.type] = InProcessGroup(W).run(work, grads, res)
    for (gagg, gres), (cagg, cres) in zip(out["cuda"], out["cpu"]):
        for n in shapes:
            assert torch.equal(gagg[n].cpu(), cagg[n]) and torch.equal(gres[n].cpu(), cres[n]), n


def test_sketch_route_card_equals_cpu(cuda):
    """The sparse_rs sketch route on a 200,000-element gradient (the sampled
    threshold path), on the card and on the CPU: the sampled top-k bitwise
    equal, the card's sketch table within its reordering bound cell by cell
    (its `index_add_` adds in atomic order, the CPU's in slot order), and
    given the CPU's table the mean and the own-transmitted tensor bitwise
    equal (`chip_smoke.sketch_route_card_vs_cpu`)."""
    import chip_smoke

    from deepreduce_tpu_torch import DeepReduceConfig, GradientExchanger

    cfg = DeepReduceConfig(communicator="sparse_rs", rs_mode="sketch", compress_ratio=0.1, seed=5)
    shapes = {"w": (200_000,)}
    flat = torch.randn(200_000, generator=torch.Generator().manual_seed(16))
    exs = {dev: GradientExchanger(shapes, cfg, device=dev) for dev in ("cuda", "cpu")}
    res = chip_smoke.sketch_route_card_vs_cpu(
        lambda x: exs["cuda" if x.is_cuda else "cpu"].route_flat(x, step=2)[:2], flat.to(cuda))
    assert res["selected"] > 0


HIER = {
    "dense_fused": dict(BUCKET_FLAGSHIP, hier=True),
    "qar_quantized": dict(communicator="sparse_rs", rs_mode="quantized", compress_ratio=0.1, seed=3, hier=True,
                          hier_ici="qar"),
}


@pytest.mark.parametrize("arm", list(HIER))
def test_hierarchical_exchange_card_equals_cpu(cuda, arm):
    """One in-process (2, 2) hierarchical exchange on the card and on the
    CPU under the same streams: every worker's aggregate and residuals
    bitwise equal, the replicas of a slice alike, and the kernels launched
    as the legs quantize (one qsgd_encode_rows a worker for the fused leg;
    two qsgd_quantize for the qar slice leg and one for the quantized
    route)."""
    from deepreduce_tpu_torch import DeepReduceConfig
    from deepreduce_tpu_torch.collectives import InProcessGrid
    from deepreduce_tpu_torch.exchange import build_exchanger

    S, P = 2, 2
    cfg = DeepReduceConfig(**HIER[arm])
    shapes = {"a/kernel": (300, 60), "b": (2_000,)}
    gen = torch.Generator().manual_seed(15)
    grads = [{n: torch.randn(s, generator=gen) for n, s in shapes.items()} for _ in range(S * P)]
    res = [{n: torch.randn(s, generator=gen) * 1e-2 for n, s in shapes.items()} for _ in range(S)]
    out = {}
    for dev in (cuda, torch.device("cpu")):
        def work(pair, g, dev=dev):
            ex = build_exchanger(shapes, cfg, device=dev, group=pair)
            r = {n: t.to(dev) for n, t in res[pair[1].rank].items()}
            return ex.exchange({n: t.to(dev) for n, t in g.items()}, r, step=2)[:2]

        before = (qsgd_encode_rows.launches, quantize_levels.launches)
        out[dev.type] = InProcessGrid(S, P).run(work, grads)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            fused = arm == "dense_fused"
            assert (qsgd_encode_rows.launches - before[0], quantize_levels.launches - before[1]) == (
                (S * P, 0) if fused else (0, 3 * S * P))
    for r, ((gagg, gres), (cagg, cres)) in enumerate(zip(out["cuda"], out["cpu"])):
        for n in shapes:
            assert torch.equal(gagg[n].cpu(), cagg[n]) and torch.equal(gres[n].cpu(), cres[n]), (r, n)
            assert torch.equal(gagg[n], out["cuda"][r - r % P][0][n]), (r, n)


def _qsgd_tree(n_leaves, seed):
    """A tree of `n_leaves` QSGD leaves under DRQSGD-BF-P0 (FedAvg's knobs)."""
    from deepreduce_tpu_torch import DeepReduceConfig

    cfg = DeepReduceConfig(compressor="topk", compress_ratio=0.1, deepreduce="both", index="bloom", value="qsgd",
                           policy="p0", fpr=0.02, bloom_blocked="mod", memory="residual", min_compress_size=500,
                           seed=seed)
    gen = torch.Generator().manual_seed(seed)
    shapes = {f"Block_{i}/kernel": (600 + 97 * (i % 11),) for i in range(n_leaves)}
    return cfg, shapes, gen


@pytest.mark.parametrize("n_leaves,clients,launches", [(57, 2, 1), (57, 4, 2), (3, 8, 1)])
def test_grouped_cross_client_encode_equals_per_client_launches_and_plain(cuda, n_leaves, clients, launches):
    """A block of clients' QSGD segments in one call (ceil(B S / 128)
    launches): bitwise each client's own one-launch encode of its tree, and
    the plain version's rows on the same values."""
    from deepreduce_tpu_torch.fedsim import TreeCodec
    from deepreduce_tpu_torch.ops import launch_counts, reset_launch_counts

    cfg, shapes, gen = _qsgd_tree(n_leaves, 7)
    tree = {n: torch.randn((clients,) + s, generator=gen) for n, s in shapes.items()}
    tc, tc_cpu = TreeCodec("c2s", cfg, device="cuda"), TreeCodec("c2s", cfg, device="cpu")
    workers = list(range(3, 3 + clients))
    reset_launch_counts()
    parts, _, spec, segs = tc.encode_batched({n: t.cuda() for n, t in tree.items()}, None, step=5, workers=workers)
    torch.cuda.synchronize()
    assert launch_counts()["qsgd_encode_rows"] == launches and len(segs) == clients * n_leaves
    cparts, _, _, _ = tc_cpu.encode_batched(tree, None, step=5, workers=workers)
    for c, w in enumerate(workers):
        single, _, _ = tc.encode_tree({n: t[c].cuda() for n, t in tree.items()}, None, step=5, worker=w)
        for i, p in enumerate(single):
            leaves = p.leaves()
            for j, leaf in enumerate(leaves):
                assert torch.equal(parts[i][j][c], leaf), (c, i, j)
                assert torch.equal(parts[i][j][c].cpu(), cparts[i][j][c]), (c, i, j)


def test_fedsim_round_card_equals_cpu(cuda):
    """Two batched DRQSGD rounds of the linear problem under churn and chaos
    with checksums: the card's state and metrics within 1e-5 of the CPU's
    on the same draws. The batches are made on the CPU for both and local
    training runs in float64 (rounded to float32), so that no top-k near-tie
    is decided by a last bit the two devices' float32 sums differ in."""
    from torch.utils._pytree import tree_map

    from deepreduce_tpu_torch import DeepReduceConfig
    from deepreduce_tpu_torch.fedsim import FedSim, synthetic_linear_problem

    knobs = dict(compressor="topk", compress_ratio=0.25, deepreduce="both", index="bloom", value="qsgd",
                 policy="p0", bloom_blocked="mod", memory="residual", min_compress_size=8, fed=True,
                 fed_num_clients=64, fed_clients_per_round=8, fed_local_steps=2, resilience=True,
                 fault_plan="3@1", drop_rate=0.05, payload_checksum=True, chaos_corrupt_rate=0.2)
    cfg = DeepReduceConfig(**knobs)
    p0, data_cpu, loss_fn = synthetic_linear_problem(600, 4, 2, device="cpu")
    out = {}
    for dev in ("cpu", "cuda"):
        data = lambda gids, rnd, key, dev=dev: tuple(t.to(dev) for t in data_cpu(gids.cpu(), rnd, key))
        sim = FedSim(loss_fn, cfg, cfg.fed_config(), 0.1, data, client_chunk=4, device=dev)

        def train64(ref, batches, train=sim._local_train):
            out64 = train({n: r.double() for n, r in ref.items()}, tree_map(lambda t: t.double(), batches))
            return {n: p.float() for n, p in out64.items()}

        sim._local_train = train64
        st = sim.init({n: p.to(dev) for n, p in p0.items()})
        for r in range(2):
            st, m = sim.step(st, r)
        out[dev] = (st, m)
    (cs, cm), (gs, gm) = out["cpu"], out["cuda"]
    for n in cs.params:
        torch.testing.assert_close(gs.params[n].cpu(), cs.params[n], rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(gs.residuals[n].cpu(), cs.residuals[n], rtol=1e-5, atol=1e-6)
    for k in cm:
        torch.testing.assert_close(gm[k].cpu(), cm[k], rtol=1e-5, atol=1e-6)


def _tele_cfg(**knobs):
    import deepreduce_tpu_torch as port

    return port.DeepReduceConfig(compressor="topk", compress_ratio=0.1, memory="residual", deepreduce="both",
                                 index="bloom", value="qsgd", fpr=0.02, policy="p0", bloom_blocked="mod",
                                 min_compress_size=100, telemetry=True, telemetry_every=2, **knobs)


def _tokens_on(device, steps=4, seed=3):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, 64, (steps, 4, 6), generator=gen).to(device)


def _syncs_of(fn):
    """(fn's result, the file:line of each host sync it made on the card)."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, [f"{w.filename}:{w.lineno}" for w in caught if "synchronizing" in str(w.message)]


def test_telemetry_accumulator_card_equals_cpu(cuda):
    """Two steps of DRQSGD-BF-P0 on a small WordLSTM on the card and on the
    CPU from the same weights: the counters equal, the errors within 1e-4
    (the two backward passes' last bits); on the card one qsgd_encode_rows
    launch a step, and telemetry adds no host sync to a step."""
    import deepreduce_tpu_torch as port
    from deepreduce_tpu_torch.models import WordLSTM

    fetched, syncs = {}, {}
    for dev, tele in (("cpu", True), ("cuda", False), ("cuda", True)):
        tok = _tokens_on(dev)
        cfg = dataclasses.replace(_tele_cfg(), telemetry=tele)
        tr = port.Trainer(WordLSTM(64, 8, 16, seed=4), cfg, lr=0.1, momentum=0.9, device=dev)
        st = tr.init_state()
        before = qsgd_encode_rows.launches
        per_step = []
        for i in range(2):
            # the first step on the card also pays the CUDA context's lazy
            # set-up, whose copies the sync count would see: count the second
            if dev == "cuda" and i == 1:
                (st, _, _), s = _syncs_of(lambda: tr.step(st, (tok[i, :, :-1], tok[i, :, 1:])))
                per_step.append(s)
            else:
                st, _, _ = tr.step(st, (tok[i, :, :-1], tok[i, :, 1:]))
        if dev == "cuda":
            assert qsgd_encode_rows.launches == before + 2
            syncs[tele] = per_step
        if tele:
            fetched[dev] = tr.telemetry.fetch()
    assert syncs[True] == syncs[False] == [[]], syncs
    cpu, card = fetched["cpu"], fetched["cuda"]
    for k, v in cpu.items():
        if k in ("err_l2", "err_cos", "residual_l2"):
            assert abs(card[k] - v) <= 1e-4 * max(abs(v), 1.0), k
        else:
            assert card[k] == v, k


def test_rung_switch_on_the_card_encodes_its_table_bitwise(cuda):
    """A controller that must move up at its first window: the new rung's
    exchanger is built on the card, its step makes one qsgd_encode_rows
    launch, and its segment table encodes bitwise its plain version."""
    import deepreduce_tpu_torch as port
    from deepreduce_tpu_torch.models import WordLSTM
    from deepreduce_tpu_torch.sparse import per_tensor_stream

    cfg = _tele_cfg(ctrl=True, ctrl_ladder="0.05,0.1,0.2", ctrl_hysteresis=1, ctrl_target_err_cos=1.0,
                    ctrl_headroom=0.0)
    tok = _tokens_on(cuda)
    tr = port.Trainer(WordLSTM(64, 8, 16, seed=4), cfg, lr=0.1, momentum=0.9, device=cuda)
    st = tr.init_state()
    for i in range(3):
        before = qsgd_encode_rows.launches
        st, _, _ = tr.step(st, (tok[i, :, :-1], tok[i, :, 1:]))
        assert qsgd_encode_rows.launches == before + 1
    assert tr.controller.switches == 1 and tr.visited_ladder_indices == (1, 2)
    ex = tr.exchanger
    assert ex.cfg.compress_ratio == 0.2
    gen = torch.Generator().manual_seed(6)
    segs = []
    for n, codec in ex.codecs.items():
        if codec.rows_leaf is None:
            continue
        v = torch.randn(codec.val_codec.meta.k, generator=gen) * 1e-3
        lo = ex.offsets[n] + ex.layouts[n].leaf_offsets[codec.rows_leaf]
        seed, offset = per_tensor_stream(cfg.seed, n, 3, 0)
        segs.append(EncodeSegment(v.to(cuda), lo, seed, offset))
    assert segs
    got = torch.zeros(ex.fused_nbytes, dtype=torch.uint8, device=cuda)
    qsgd_encode_rows(segs, got, quantum_num=cfg.quantum_num, bucket_size=cfg.bucket_size, device=cuda)
    ref = torch.zeros(ex.fused_nbytes, dtype=torch.uint8)
    qsgd_encode_rows([dataclasses.replace(s, values=s.values.cpu()) for s in segs], ref,
                     quantum_num=cfg.quantum_num, bucket_size=cfg.bucket_size, device="cpu")
    assert torch.equal(got.cpu(), ref)


def test_ring_hop_and_ring_attention_backward_on_the_card_in_threads(cuda):
    """Two in-process workers on the card: a ring hop forward (worker r
    receives r - 1's tensor) and backward (the gradient hops back), then
    causal ring attention forward and backward against the unsharded
    reference. Each backward runs on its worker's thread
    (`functional.backward`); on autograd's one device thread the two
    backward hops would wait on each other. The group's 60 s barrier
    timeout turns such a deadlock into a failure, not a hang."""
    from deepreduce_tpu_torch.collectives import InProcessGroup
    from deepreduce_tpu_torch.parallel import ring_attention
    from deepreduce_tpu_torch.parallel.functional import backward, ring_hop
    from deepreduce_tpu_torch.parallel.ring import ring_self_attention_reference

    gen = torch.Generator().manual_seed(20)
    xs = [torch.randn(3, 5, generator=gen) for _ in range(2)]
    cos = [torch.randn(3, 5, generator=gen) for _ in range(2)]
    qkv = [torch.randn(2, 16, 4, 8, generator=gen) for _ in range(3)]
    co = torch.randn(2, 16, 4, 8, generator=gen)

    def work(coll, r):
        x = xs[r].to(cuda, copy=True).requires_grad_()
        y = ring_hop(x, coll)
        backward((y * cos[r].to(cuda)).sum())
        q, k, v = (t[:, 8 * r : 8 * r + 8].to(cuda, copy=True).requires_grad_() for t in qkv)
        out = ring_attention(q, k, v, coll, causal=True)
        backward((out * co[:, 8 * r : 8 * r + 8].to(cuda)).sum())
        return y.detach().cpu(), x.grad.cpu(), [t.detach().cpu() for t in (out, q.grad, k.grad, v.grad)]

    res = InProcessGroup(2, timeout=60).run(work, [0, 1])
    torch.cuda.synchronize()
    for r in range(2):
        assert torch.equal(res[r][0], xs[1 - r]) and torch.equal(res[r][1], cos[1 - r])
    ref_in = [t.clone().requires_grad_() for t in qkv]
    ref = ring_self_attention_reference(*ref_in, causal=True)
    (ref * co).sum().backward()
    for i, want in enumerate([ref.detach()] + [t.grad for t in ref_in]):
        got = torch.cat([res[r][2][i] for r in range(2)], dim=1)
        torch.testing.assert_close(got, want, rtol=0, atol=2e-5 if i == 0 else 3e-4)


def test_tensor_parallel_backward_all_reduce_on_the_card_in_threads(cuda):
    """Megatron's pair on two in-process workers on the card under the
    in-thread backward: copy_to_group's backward all-reduces the gradient
    (every worker's x.grad is the sum of the cotangents), and
    reduce_from_group sums forward and passes the gradient through. A 60 s
    barrier timeout bounds the test."""
    from deepreduce_tpu_torch.collectives import InProcessGroup
    from deepreduce_tpu_torch.parallel.functional import backward, copy_to_group, reduce_from_group

    gen = torch.Generator().manual_seed(21)
    x = torch.randn(4, 6, generator=gen)
    ws = [torch.randn(6, 3, generator=gen) for _ in range(2)]

    def work(coll, r):
        xc = x.to(cuda, copy=True).requires_grad_()
        w = ws[r].to(cuda, copy=True).requires_grad_()
        y = reduce_from_group(copy_to_group(xc, coll) @ w, coll)
        backward(y.square().sum())
        return y.detach().cpu(), xc.grad.cpu(), w.grad.cpu()

    res = InProcessGroup(2, timeout=60).run(work, [0, 1])
    torch.cuda.synchronize()
    xr = x.clone().requires_grad_()
    wr = [w.clone().requires_grad_() for w in ws]
    y = xr @ wr[0] + xr @ wr[1]
    y.square().sum().backward()
    for r in range(2):
        torch.testing.assert_close(res[r][0], y.detach(), rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(res[r][1], xr.grad, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(res[r][2], wr[r].grad, rtol=1e-5, atol=1e-5)


def test_sync_count_sees_a_worker_threads_sync(cuda):
    """`chip_smoke._counting_syncs` around in-process workers: one `.item()`
    on one worker thread of a two-worker group is one recorded site, and
    the other worker's device-only work is none."""
    import chip_smoke
    from deepreduce_tpu_torch.collectives import InProcessGroup

    x = torch.arange(4.0, device=cuda)

    def work(coll, r):
        y = coll.all_reduce_sum(x * (r + 1))
        return float(y[0]) if r == 1 else y

    out, sites = chip_smoke._counting_syncs(lambda: InProcessGroup(2, timeout=60).run(work, [0, 1]))
    assert out[1] == 0.0 and len(sites) == 1, sites


def test_recorder_on_a_one_rank_nccl_group(cuda):
    """The analysis recorder around `ProcessGroupCollectives` over NCCL:
    the fused exchange makes one all_gather of `payload_bytes()`, the
    quantized sparse_rs route its pmax, reduce_scatter and all_gather with
    their operand bytes, and the census sees one selection a tensor and no
    host read or float64 op outside their sites."""
    import torch.distributed as dist

    from deepreduce_tpu_torch import DeepReduceConfig, GradientExchanger
    from deepreduce_tpu_torch.analysis import audit, census, recorder
    from deepreduce_tpu_torch.analysis.rules import AuditContext
    from deepreduce_tpu_torch.collectives import ProcessGroupCollectives

    fresh = not dist.is_initialized()
    if fresh:
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        coll = ProcessGroupCollectives(dist.group.WORLD)
        rs = dict(communicator="sparse_rs", compressor="topk", memory="none", deepreduce=None, compress_ratio=0.02,
                  rs_mode="quantized")
        fused = dict(memory="residual", decode_strategy="loop", **audit._FLAGSHIP)
        for knobs, want in ((fused, {"all_gather": 1}), (rs, {"all_gather": 1, "pmax": 1, "reduce_scatter": 1})):
            cfg = DeepReduceConfig(**knobs)
            tape = recorder.Tape()
            ex = GradientExchanger({"g": (4096,)}, cfg, device=cuda, group=recorder.Recorder(coll, "data", tape))
            grads = {"g": torch.randn(4096, device=cuda)}
            res = {"g": torch.zeros(4096, device=cuda)} if cfg.memory == "residual" else None
            with census.SyncWatch(cuda) as syncs, census.Census(tape):
                ex.exchange(grads, res, step=3)
            torch.cuda.synchronize()
            assert syncs.sites == []
            assert recorder.counts(tape.calls) == want
            mode = "collective" if cfg.communicator == "sparse_rs" else "allgather"
            ctx = AuditContext(label="nccl", expect_collectives=want, wire_mode=mode,
                               expected_wire_bytes=ex.payload_bytes(),
                               expect_codec_invocations=1 if mode == "allgather" else None)
            run = audit.Run((3,), [[tape]], [[None]], ex.payload_bytes(), 1, [], syncs=syncs.sites)
            assert audit.check_trace(ctx, run).violations == []
            assert census.selections(census.ops_of(tape)) >= 1
    finally:
        if fresh:
            dist.destroy_process_group()


def test_sync_watch_sees_a_sync_below_the_dispatcher(cuda, monkeypatch):
    """`census.SyncWatch` on the card, around the audit's eight in-process
    workers: a boolean-mask read planted in the exchange's decode (its
    nonzero synchronizes inside the index kernel, which the census sees as
    one `aten.index.Tensor`) is a `jx-callback` violation at its line of
    comm.py on every worker; the clean run, whose harness puts its values
    on the card, keeps none."""
    from deepreduce_tpu_torch import comm as comm_mod
    from deepreduce_tpu_torch.analysis import audit, rules
    from deepreduce_tpu_torch.analysis.rules import AuditContext
    from deepreduce_tpu_torch.config import DeepReduceConfig

    cfg = DeepReduceConfig(memory="residual", decode_strategy="loop", **audit._FLAGSHIP)
    clean = audit.check_trace(AuditContext(label="fused"), audit.run_flat(cfg, device=cuda, census_ranks=(0,)))
    assert clean.violations == [] and clean.extra["card_syncs"] == 0
    ns = {"decode_sum": comm_mod.FusedBuffer.decode_sum}
    exec(compile("def planted(self, *args, **kw):\n"
                 "    total, own = decode_sum(self, *args, **kw)\n"
                 "    return total + total[total > 0].sum() * 0, own\n", comm_mod.__file__, "exec"), ns)
    monkeypatch.setattr(comm_mod.FusedBuffer, "decode_sum", ns["planted"])
    record = audit.check_trace(AuditContext(label="fused"), audit.run_flat(cfg, device=cuda, census_ranks=(0,)))
    assert record.extra["card_syncs"] >= audit.NUM_WORKERS
    assert {v.rule for v in record.violations} == {rules.R_CALLBACK}
    (on_card,) = [v for v in record.violations if "on the card" in v.detail]
    assert "comm.py:3 (planted)" in on_card.detail


# -- the mod-blocked bloom index codec's kernels (ops/bloom_mod.py) ---------- #


# {(d, k, fpr, policy): leaves} of every compressed leaf of the two compressed
# benchmark cells: ResNet-50 under top-k 1% with the leftmost mod bloom index
# at fpr 0.001 (76 leaves) and BERT-base under top-k 0.1% with p0 at fpr 0.02
# (88, the 23,440,896-element token embedding among them); k = int(d * ratio)
CELL_GEOMETRIES = {
    (1024, 10, 0.001, "leftmost"): 14, (2048, 20, 0.001, "leftmost"): 8, (4096, 40, 0.001, "leftmost"): 1,
    (9408, 94, 0.001, "leftmost"): 1, (16384, 163, 0.001, "leftmost"): 6, (32768, 327, 0.001, "leftmost"): 1,
    (36864, 368, 0.001, "leftmost"): 3, (65536, 655, 0.001, "leftmost"): 7, (131072, 1310, 0.001, "leftmost"): 2,
    (147456, 1474, 0.001, "leftmost"): 4, (262144, 2621, 0.001, "leftmost"): 11,
    (524288, 5242, 0.001, "leftmost"): 2, (589824, 5898, 0.001, "leftmost"): 6,
    (1048576, 10485, 0.001, "leftmost"): 5, (2048000, 20480, 0.001, "leftmost"): 1,
    (2097152, 20971, 0.001, "leftmost"): 1, (2359296, 23592, 0.001, "leftmost"): 3,
    (3072, 3, 0.02, "p0"): 12, (30522, 30, 0.02, "p0"): 1, (393216, 393, 0.02, "p0"): 1,
    (589824, 589, 0.02, "p0"): 48, (2359296, 2359, 0.02, "p0"): 24, (23440896, 23440, 0.02, "p0"): 2,
}
# (d, k, W, h, nnz cut, budget against the hits), as tests/test_torch_bloom.py's EDGE
BLOOM_EDGE = [(1001, 60, 47, 5, 7, "over"), (1001, 60, 47, 9, 0, "exact"), (1001, 80, 23, 3, 0, "under"),
              (4099, 120, 101, 12, 31, "over"), (777, 1, 1, 1, 0, "under")]


def _torch_path():
    """The codec's torch code on the card: its kernel rule made to say no."""
    from unittest import mock

    from deepreduce_tpu_torch.codecs import bloom

    return mock.patch.object(bloom, "_on_kernel", lambda meta, t: False)


def _bloom_launches():
    from deepreduce_tpu_torch.ops import launch_counts

    return {name: n for name, n in launch_counts().items() if name.startswith("bloom_mod")}


def _bloom_kernels_vs_plain(meta, idx, nnz, flat, dev):
    """The codec's three mod-layout stages (`insert`, `_fp_aware_payload`,
    `decode_dense`) with the kernels against its torch code run on the card,
    on the same inputs: the words, the encoder's values and count, and the
    decoder's dense tensor for the encoder's values, a table shorter than
    the budget and counts below and above it. Bitwise, one launch a call."""
    from deepreduce_tpu_torch.codecs import bloom

    def stages():
        words = bloom.insert(idx_d, nnz_d, meta)
        payload = bloom._fp_aware_payload(words, flat_d, meta)
        values, nsel = payload.values, payload.nsel
        short = values[: max(0, meta.budget - 7)]
        cases = [(values, nsel), (short, nsel), (values, nsel - 3),
                 (values, torch.full((), meta.budget + 5, device=dev))]
        dense = [bloom.decode_dense(dataclasses.replace(payload, nsel=count), meta, (meta.d,), values=table)
                 for table, count in cases]
        return words, values, nsel, dense

    idx_d, nnz_d, flat_d = idx.to(dev), nnz.to(dev), flat.to(dev)
    before = _bloom_launches()
    words, values, nsel, dense = stages()
    torch.cuda.synchronize()
    launched = {n: c - before[n] for n, c in _bloom_launches().items()}
    assert launched == {"bloom_mod_insert": 1, "bloom_mod_select": 1, "bloom_mod_place": len(dense)}
    with _torch_path():
        ref = stages()
    assert _bloom_launches() == {n: before[n] + launched[n] for n in before}
    assert torch.equal(words, ref[0]) and torch.equal(values, ref[1])
    assert nsel.dtype == torch.int32 and int(nsel) == int(ref[2])
    for got, want in zip(dense, ref[3]):
        assert torch.equal(got, want)
    return int(nsel)


@pytest.mark.parametrize("d,k,fpr,policy", sorted(CELL_GEOMETRIES))
def test_bloom_mod_kernels_bitwise_at_the_cells_leaf_geometries(cuda, d, k, fpr, policy):
    """Insert, select-and-gather and placement at every compressed leaf
    geometry of the two compressed cells, on the exact top-k of a gradient
    with zeros in it."""
    from deepreduce_tpu_torch.codecs.bloom import BloomMeta
    from deepreduce_tpu_torch.sparse import topk

    meta = BloomMeta.create(k, d, fpr=fpr, policy=policy, blocked="mod")
    gen = torch.Generator().manual_seed(d + k)
    flat = torch.randn(d, generator=gen)
    flat[torch.rand(d, generator=gen) < 0.3] = 0.0
    sp = topk(flat.to(cuda), 1.0, k=k)
    nsel = _bloom_kernels_vs_plain(meta, sp.indices.cpu(), sp.nnz.cpu(), flat, cuda)
    assert k <= nsel <= meta.budget or nsel == meta.budget


@pytest.mark.parametrize("d,k,n_words,h,cut,mode", BLOOM_EDGE)
def test_bloom_mod_kernels_bitwise_at_the_edges(cuda, d, k, n_words, h, cut, mode):
    """d not a multiple of W, h <= 6 and h > 6, nnz < k, fewer hits than the
    budget, exactly the budget and more, int64 indices and counts."""
    from deepreduce_tpu_torch.codecs import bloom

    gen = torch.Generator().manual_seed(d + h)
    idx = torch.randperm(d, generator=gen)[:k].sort().values.to(torch.int32)
    flat = torch.randn(d, generator=gen)
    wide = bloom.BloomMeta(d=d, k=k, m_bits=32 * n_words, num_hash=h, fpr=0.01, policy="p0", budget=d, blocked="mod")
    hits = int(bloom._fp_aware_payload(bloom.insert(idx, torch.tensor(k - cut), wide), flat, wide).nsel)
    budget = {"over": min(d, hits + 13), "exact": hits, "under": max(1, hits - 9)}[mode]
    meta = dataclasses.replace(wide, budget=budget)
    for idx_t, nnz_t in ((idx, torch.tensor(k - cut, dtype=torch.int32)), (idx.long(), torch.tensor(k - cut))):
        _bloom_kernels_vs_plain(meta, idx_t, nnz_t, flat, cuda)


def test_bloom_mod_kernels_refuse_what_they_do_not_take(cuda):
    from deepreduce_tpu_torch.codecs.bloom import BloomMeta
    from deepreduce_tpu_torch.ops import bloom_mod

    meta = BloomMeta.create(40, 4000, fpr=0.01, policy="leftmost", blocked="mod")
    idx = torch.arange(0, 4000, 100, dtype=torch.int32, device=cuda)
    nnz = torch.full((), 40, dtype=torch.int32, device=cuda)
    words = bloom_mod.insert(idx, nnz, meta)
    flat = torch.randn(4000, device=cuda)
    vals, nsel = bloom_mod.select_gather(words, flat, meta)
    bad = [
        lambda: bloom_mod.insert(idx.float(), nnz, meta),  # dtype
        lambda: bloom_mod.insert(idx, nnz.cpu(), meta),  # device
        lambda: bloom_mod.insert(idx[::2], nnz, meta),  # not contiguous
        lambda: bloom_mod.select_gather(words.long(), flat, meta),
        lambda: bloom_mod.select_gather(words, flat.int(), meta),
        lambda: bloom_mod.select_gather(words, flat.cpu(), meta),
        lambda: bloom_mod.select_gather(words, torch.randn(8000, device=cuda)[::2], meta),
        lambda: bloom_mod.select_gather(words, flat[:-1], meta),  # not d elements
        lambda: bloom_mod.place(words, vals.int(), nsel, meta),
        lambda: bloom_mod.place(words, vals.cpu(), nsel, meta),
        lambda: bloom_mod.place(words, vals, nsel.float(), meta),
        lambda: bloom_mod.place(words, torch.randn(2 * meta.budget, device=cuda)[::2], nsel, meta),
        lambda: bloom_mod.select_gather(words, flat, dataclasses.replace(meta, policy="random")),
        lambda: bloom_mod.place(words, vals, nsel, dataclasses.replace(meta, blocked="hash")),
    ]
    before = bloom_mod.insert.launches, bloom_mod.select_gather.launches, bloom_mod.place.launches
    for call in bad:
        with pytest.raises(ValueError):
            call()
    assert (bloom_mod.insert.launches, bloom_mod.select_gather.launches, bloom_mod.place.launches) == before


def test_resnet50_step_exchange_kernels_equal_the_torch_path(cuda, monkeypatch):
    """One ResNet-50 fused-allgather exchange under the `topk1_bloom_b512`
    knobs on the card: with the kernels (one insert, one select and one
    placement a compressed leaf, 76 each) and with the torch path the codec
    takes off the card, the aggregate, the residuals, the wire stats and the
    payload bytes are bitwise the same, and the kernel step calls the torch
    chain's `_prefix_positions` nowhere. (The cell's configuration is read
    from the benchmark's files here, on the card only.)"""
    import json
    from pathlib import Path

    from deepreduce_tpu_torch import DeepReduceConfig, sparse
    from deepreduce_tpu_torch.codecs import bloom
    from deepreduce_tpu_torch.comm import GradientExchanger
    from h100bench.configs import resnet50_bf16

    root = Path(resnet50_bf16.__file__).resolve().parent.parent
    knobs = json.loads((root / "traffic" / "topk1_bloom_b512.json").read_text())["knobs"]
    specs = resnet50_bf16.param_specs(json.loads((root / "configs" / "resnet50_bf16.json").read_text()))
    shapes = {name: shape for name, shape, _, _ in specs}
    gen = torch.Generator().manual_seed(50)
    grads = {n: torch.randn(s, generator=gen).to(cuda) * 1e-2 for n, s in shapes.items()}
    res = {n: torch.randn(s, generator=gen).to(cuda) * 1e-3 for n, s in shapes.items()}
    cfg = DeepReduceConfig(**knobs, seed=11)

    def step():
        ex = GradientExchanger(shapes, cfg, device=cuda)
        agg, new_res, stats = ex.exchange(grads, res, step=3)
        torch.cuda.synchronize()
        return agg, new_res, stats, ex.payload_bytes()

    prefix_calls = []
    real_prefix = sparse._prefix_positions

    def spy(mask, budget):
        prefix_calls.append(budget)
        return real_prefix(mask, budget)

    monkeypatch.setattr(sparse, "_prefix_positions", spy)
    monkeypatch.setattr(bloom, "_prefix_positions", spy)
    before = _bloom_launches()
    kern = step()
    launched = {n: c - before[n] for n, c in _bloom_launches().items()}
    assert launched == {"bloom_mod_insert": 76, "bloom_mod_select": 76, "bloom_mod_place": 76}
    assert prefix_calls == []
    with _torch_path():
        torch_path = step()
    assert len(prefix_calls) == 2 * 76
    assert _bloom_launches() == {n: before[n] + launched[n] for n in before}
    for name in shapes:
        assert torch.equal(kern[0][name], torch_path[0][name]), name
        assert torch.equal(kern[1][name], torch_path[1][name]), name
    for a, b in zip(dataclasses.astuple(kern[2]), dataclasses.astuple(torch_path[2])):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    assert kern[3] == torch_path[3]


def test_fedsim_batched_codec_launches_the_bloom_kernels_once_a_client_leaf(cuda):
    """FedSim's cohort codec vmaps each leaf's index stage over the clients:
    under vmap each bloom kernel launches once per client and leaf (3
    clients x 5 mod-p0 leaves), and the payloads and the decoded trees are
    bitwise the codec's torch code on the card and each client's own
    unbatched encode."""
    from deepreduce_tpu_torch.fedsim import TreeCodec

    cfg, shapes, gen = _qsgd_tree(5, 9)
    clients, workers = 3, [4, 5, 6]
    tree = {n: torch.randn((clients,) + s, generator=gen).to(cuda) for n, s in shapes.items()}
    tc = TreeCodec("c2s", cfg, device=cuda)

    def cohort():
        parts, _, spec, _ = tc.encode_batched(tree, None, step=2, workers=workers)
        mid = _bloom_launches()
        return parts, tc.decode_batched(parts, spec, step=2), mid

    before = _bloom_launches()
    parts, dec, mid = cohort()
    torch.cuda.synchronize()
    after = _bloom_launches()
    n = clients * len(shapes)
    assert {k: mid[k] - before[k] for k in before} == {"bloom_mod_insert": n, "bloom_mod_select": n,
                                                       "bloom_mod_place": 0}
    assert {k: after[k] - mid[k] for k in mid} == {"bloom_mod_insert": 0, "bloom_mod_select": 0,
                                                   "bloom_mod_place": n}
    with _torch_path():
        tparts, tdec, _ = cohort()
    assert _bloom_launches() == after
    for i, leaves in enumerate(parts):
        for j, leaf in enumerate(leaves):
            assert torch.equal(leaf, tparts[i][j]), (i, j)
    for name in dec:
        assert torch.equal(dec[name], tdec[name]), name
    for c, w in enumerate(workers):
        single, _, _ = tc.encode_tree({n: t[c] for n, t in tree.items()}, None, step=2, worker=w)
        for i, p in enumerate(single):
            for j, leaf in enumerate(p.leaves()):
                assert torch.equal(parts[i][j][c], leaf), (c, i, j)


def test_fedsim_round_launches_the_bloom_kernels_once_a_client_leaf(cuda):
    """One FedSim round of the linear problem under DRQSGD-BF-P0 (its 600-wide
    weight the one compressed leaf): the 8 clients' uplinks encode and decode
    under vmap, one launch of each kernel a client, and the server's
    downlink delta once more: 9 of each."""
    from deepreduce_tpu_torch import DeepReduceConfig
    from deepreduce_tpu_torch.fedsim import FedSim, synthetic_linear_problem

    cfg = DeepReduceConfig(compressor="topk", compress_ratio=0.25, deepreduce="both", index="bloom", value="qsgd",
                           policy="p0", bloom_blocked="mod", memory="residual", min_compress_size=8, fed=True,
                           fed_num_clients=64, fed_clients_per_round=8, fed_local_steps=2)
    p0, data, loss_fn = synthetic_linear_problem(600, 4, 2, device=cuda)
    sim = FedSim(loss_fn, cfg, cfg.fed_config(), 0.1, data, client_chunk=4, device=cuda)
    st = sim.init(p0)
    before = _bloom_launches()
    st, _ = sim.step(st, 0)
    torch.cuda.synchronize()
    assert {k: c - before[k] for k, c in _bloom_launches().items()} == {
        "bloom_mod_insert": 9, "bloom_mod_select": 9, "bloom_mod_place": 9}
