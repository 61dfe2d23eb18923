"""The frozen counts against hand counts."""

from __future__ import annotations

import json

from h100bench import reference, run
from h100bench.codecs.topk_bloom import Exchange
from h100bench.counts import bert_base_f32, qsgd_table_bytes, resnet50_bf16
from h100bench.tests.tiny import bench


def _cell(workload):
    return run.load_cell(bench(), workload)


def test_resnet50_forward_is_4_1_g_multiply_adds():
    _, config, traffic = _cell("resnet50_topk1_bloom")
    macs = resnet50_bf16.forward_macs(config)
    # He et al.: 3.8e9 FLOPs for v1 (multiply-adds); v1.5 moves the stride
    # to the 3x3 convolution, about 4.1e9 multiply-adds
    assert 4.05e9 < macs < 4.15e9, macs
    assert resnet50_bf16.flops_per_sample(config, traffic) == 6 * macs


def test_bert_base_from_its_widths():
    _, config, traffic = _cell("bert_base_drqsgd_bf_p0")
    t, h, m, v = 512, 768, 3072, 30522
    hand = 12 * (t * (4 * h * h + 2 * h * m) + 2 * t * t * h) + t * h * v
    assert bert_base_f32.forward_macs(config, t) == hand
    # 64 sequences a step: about 23 TFLOP forward and backward
    step = 64 * bert_base_f32.flops_per_sample(config, traffic)
    assert 22e12 < step < 24e12, step


def test_parameter_counts_of_the_references():
    for workload in ("resnet50_topk1_bloom", "bert_base_drqsgd_bf_p0"):
        _, config, _ = _cell(workload)
        specs = reference.model_module(config).param_specs(config)
        assert sum(__import__("math").prod(s) for _, s, _, _ in specs) == config["parameters"]
    _, config, _ = _cell("resnet50_topk1_bloom")
    assert len(reference.model_module(config).stat_specs(config)) == config["batch_stats"]


def test_qsgd_table_bytes_of_bert_is_pr10s():
    _, config, traffic = _cell("bert_base_drqsgd_bf_p0")
    specs = reference.model_module(config).param_specs(config)
    ex = Exchange({n: s for n, s, _, _ in specs}, traffic["knobs"], 1)
    segs = ex.qsgd_segments()
    assert len(segs) == 88
    assert qsgd_table_bytes.table_bytes(segs, traffic["knobs"]["bucket_size"]) == 14_614_552


def test_traffic_files_parse():
    for w in bench()["workloads"]:
        _, config, traffic = _cell(w["name"])
        assert traffic["name"] == w["traffic"] and config["name"] == w["config"]
        json.dumps(traffic)
