"""The wire counter against the exchanger's payload bytes, and the no-JAX
check by whole top-level names."""

from __future__ import annotations

import subprocess
import sys

import torch

from h100bench import run
from h100bench.tests.tiny import ROOT, bench, tiny_cell


def test_wire_bytes_are_the_payload_and_the_step_scalars():
    config, traffic = tiny_cell("resnet50_topk1_bloom")
    device = torch.device("cpu")
    group = run.init_group(device)
    trainer, state, ring, _ = run.setup_program(config, traffic, 5, device, group)
    from h100bench.wire import WireCounter

    wire = WireCounter().install()
    try:
        trainer.step(state, ring[3][0])
    finally:
        wire.uninstall()
    stats = sum(s.numel() for s in state.batch_stats.values())
    # the fused allgather of the payload, the BatchNorm statistics' mean,
    # the loss and the three wire scalars
    assert wire.bytes == trainer.exchanger.payload_bytes() + 4 * stats + 4 + 12
    assert wire.calls == 4


def test_no_jax_check_compares_whole_top_level_names():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from h100bench import run\n"
        "import deepreduce_tpu_torch, h100bench.traffic, h100bench.reference\n"
        "assert run.forbidden_modules() == [], run.forbidden_modules()\n"
        "sys.modules['jax'] = object(); sys.modules['deepreduce_tpu.comm'] = object()\n"
        "assert run.forbidden_modules() == ['deepreduce_tpu', 'jax'], run.forbidden_modules()\n"
    ) % str(ROOT)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT, timeout=300)


def test_run_refuses_without_a_card_and_without_the_program(tmp_path):
    cmd = [sys.executable, "-m", "h100bench.run", "--workload", "resnet50_topk1_bloom", "--seed", "1",
           "--seconds", "1", "--trace", "0"]
    env = {"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "", "HOME": str(tmp_path)}
    here = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300, env=env)
    assert here.returncode != 0 and here.stdout.strip() == ""
    # a directory holding only BENCHMARK.json and the harness
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "h100bench", tmp_path / "h100bench")
    bare = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True, timeout=300, env=env)
    assert bare.returncode != 0 and bare.stdout.strip() == ""
