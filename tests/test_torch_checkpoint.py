"""The port's residual-carrying checkpoint (`deepreduce_tpu_torch/
checkpoint.py`) on the CPU: two `Trainer` steps, a save, a restore into a
fresh `Trainer` (another model object, other initial weights) and two more
steps give bitwise the state of four steps straight, residuals, momentum,
BatchNorm statistics and step included, for a small ResNet-50 under
DRQSGD-BF-P0 with residual memory and for a small WordLSTM under the
flagship's knobs; the config stamp fails fast on a fingerprint mismatch and
is optional; a wrong leaf name or shape fails and names the leaf; the
common-init file round-trips; `retry_io` retries transient I/O failures."""

import dataclasses

import numpy as np
import pytest
import torch

import deepreduce_tpu_torch as port
from deepreduce_tpu_torch import checkpoint
from deepreduce_tpu_torch.models import ResNet50, WordLSTM
from deepreduce_tpu_torch.resilience.retry import retry_call
from deepreduce_tpu_torch.train import next_token_loss

DRQSGD = dict(
    compressor="topk", compress_ratio=0.1, memory="residual", deepreduce="both", index="bloom", value="qsgd",
    fpr=0.02, policy="p0", bloom_blocked="mod", min_compress_size=100, seed=3,
)


def _resnet(seed):
    return ResNet50(num_classes=10, stage_sizes=(1, 1, 1, 1), seed=seed)


def _lstm(seed):
    return WordLSTM(vocab_size=64, embed_dim=8, hidden_dim=16, seed=seed)


def _batches(model_name, n=4):
    rng = np.random.default_rng(11)
    if model_name == "resnet50":
        images = torch.from_numpy(rng.normal(size=(n, 4, 32, 32, 3)).astype(np.float32))
        labels = torch.from_numpy(rng.integers(0, 10, size=(n, 4)))
        return [(images[i], labels[i]) for i in range(n)]
    tokens = torch.from_numpy(rng.integers(0, 64, size=(n, 4, 6)))
    return [(tokens[i, :, :-1], tokens[i, :, 1:]) for i in range(n)]


MODELS = {"resnet50": _resnet, "wordlstm": _lstm}


def _trainer(model_name, seed, cfg=None):
    cfg = cfg or port.DeepReduceConfig(**DRQSGD)
    return port.Trainer(MODELS[model_name](seed), cfg, lr=0.1, momentum=0.9, device="cpu")


def _snapshot(state):
    return {
        "params": {n: p.detach().clone() for n, p in state.params.items()},
        "stats": {n: s.clone() for n, s in state.batch_stats.items()},
        "momentum": [state.optimizer.state[p]["momentum_buffer"].clone() for p in state.params.values()],
        "residuals": {n: r.clone() for n, r in state.residuals.items()},
        "step": state.step,
    }


def _assert_bitwise(a, b):
    assert a["step"] == b["step"]
    for key in ("params", "stats", "residuals"):
        assert a[key].keys() == b[key].keys()
        for n in a[key]:
            assert torch.equal(a[key][n], b[key][n]), (key, n)
    assert all(torch.equal(x, y) for x, y in zip(a["momentum"], b["momentum"], strict=True))


@pytest.mark.parametrize("model_name", list(MODELS))
def test_resume_is_bitwise_four_steps_straight(model_name, tmp_path):
    batches = _batches(model_name)
    straight = _trainer(model_name, seed=0)
    state = straight.init_state()
    for b in batches:
        state, _, _ = straight.step(state, b)
    want = _snapshot(state)

    first = _trainer(model_name, seed=0)
    state = first.init_state()
    for b in batches[:2]:
        state, _, _ = first.step(state, b)
    path = str(tmp_path / "ckpt.pt")
    checkpoint.save(path, state, config=first.cfg)
    saved = _snapshot(state)

    fresh = _trainer(model_name, seed=1)  # other initial weights: all of them must come from the file
    restored = checkpoint.restore(path, fresh, config=fresh.cfg)
    _assert_bitwise(_snapshot(restored), saved)
    # in place: the optimizer steps the model's own tensors
    model_params = dict(fresh.model.flax_params())
    assert all(restored.params[n] is model_params[n] for n in model_params)
    assert [p for g in restored.optimizer.param_groups for p in g["params"]] == list(model_params.values())
    for b in batches[2:]:
        restored, _, _ = fresh.step(restored, b)
    _assert_bitwise(_snapshot(restored), want)


def test_fingerprint_mismatch_raises_and_missing_stamp_is_tolerated(tmp_path):
    tr = _trainer("wordlstm", seed=0)
    state, _, _ = tr.step(tr.init_state(), _batches("wordlstm")[0])
    path = str(tmp_path / "ckpt.pt")
    checkpoint.save(path, state, config=tr.cfg)
    other = dataclasses.replace(tr.cfg, fpr=0.01)
    assert checkpoint.config_fingerprint(other) != checkpoint.config_fingerprint(tr.cfg)
    with pytest.raises(ValueError, match="config mismatch"):
        checkpoint.restore(path, _trainer("wordlstm", seed=1, cfg=other), config=other)
    # no stamp: the restore goes through on any config
    bare = str(tmp_path / "bare.pt")
    checkpoint.save(bare, state)
    restored = checkpoint.restore(bare, _trainer("wordlstm", seed=1), config=tr.cfg)
    assert restored.step == 1


def test_wrong_name_or_shape_fails_and_names_the_leaf(tmp_path):
    tr = _trainer("wordlstm", seed=0)
    state = tr.init_state()
    path = str(tmp_path / "ckpt.pt")
    checkpoint.save(path, state)
    narrow = port.Trainer(WordLSTM(vocab_size=64, embed_dim=8, hidden_dim=12), tr.cfg, lr=0.1, momentum=0.9,
                          device="cpu")
    with pytest.raises(ValueError, match="OptimizedLSTMCell_0/ii/kernel: saved torch.float32 \\(8, 16\\), expected torch.float32 \\(8, 12\\)"):
        checkpoint.restore(path, narrow)
    blob = torch.load(path, weights_only=True)
    blob["params"]["Dense_9/kernel"] = blob["params"].pop("Dense_0/kernel")
    torch.save(blob, path)
    with pytest.raises(ValueError, match="missing \\['Dense_0/kernel'\\], unexpected \\['Dense_9/kernel'\\]"):
        checkpoint.restore(path, _trainer("wordlstm", seed=1))


def test_common_init_round_trips(tmp_path):
    path = str(tmp_path / "model_init.pt")
    checkpoint.save_common_init(path, _lstm(0).flax_params())
    model = _lstm(1)
    params = checkpoint.load_common_init(path, model.flax_params())
    for n, p in _lstm(0).flax_params().items():
        assert torch.equal(params[n], p) and params[n] is model.flax_params()[n]


def test_retry_backs_off_then_raises():
    sleeps, calls = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "ok"

    assert retry_call(flaky, sleep=sleeps.append) == "ok"
    assert sleeps == [0.05, 0.1]
    with pytest.raises(OSError):
        retry_call(lambda: (_ for _ in ()).throw(OSError("down")), attempts=2, sleep=sleeps.append)
    with pytest.raises(KeyError):
        retry_call(lambda: {}["x"], sleep=sleeps.append)  # not transient: no retry
