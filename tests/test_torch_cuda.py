"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: each test skips on a machine without CUDA (such as a
CPU-only test runner) and runs on the GPU with
`python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest` (the
repository's conftest imports jax, which the GPU machine need not have)."""

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
