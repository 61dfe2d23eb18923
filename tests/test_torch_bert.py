"""Port parity for the BERT-base encoder with dense attention
(`models/bert.py`: flax's MultiHeadDotProductAttention, DenseGeneral,
LayerNorm and Embed as `models/common.py` writes them) and its
next-token loss (`train.next_token_loss`) against the JAX package on the
CPU.

- Full width: 200 leaves, 132,363,066 parameters, flax's names, layouts
  (`query`/`key`/`value` kernels `[768, 12, 64]`, `out` `[12, 64, 768]`)
  and flatten order (`jax.eval_shape`, no compile); the payload bytes of
  chip_smoke's `bert_drqsgd_bloom` (top-k 0.001, DRQSGD-BF-P0, 88
  compressed leaves) equal the JAX package's.
- Small size (2 layers, hidden 32, 4 heads, vocabulary 50) on numpy-seeded
  weights: the loss to rtol 1e-5 and the gradients to rtol 1e-4 and atol
  1e-4 of the largest gradient (torch and XLA sum in other orders; the key
  bias's gradient is rounding noise around 0, since a softmax does not see
  a shift shared by a query's scores).
- `remat=True` (`torch.utils.checkpoint` per layer) gives the same loss and
  gradients and the same parameter names; ring and Ulysses attention raise
  `NotImplementedError`.
- One `Trainer` step under DRQSGD-BF-P0 against the JAX `Trainer` with the
  `lm` loss of `benchmarks/train.py`: equal wire bytes, the parameters after
  the step to rtol 1e-4 / atol 1e-6.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_models_zoo import DRQSGD, _checked_exchange, _seeded, _shapes, jax_trainer
from test_torch_slice import _jax_flat_params, _jax_uniforms, _t

from deepreduce_tpu.comm import GradientExchanger as JExchanger
from deepreduce_tpu.config import DeepReduceConfig as JConfig
from deepreduce_tpu.models import BertEncoder as JBertEncoder
from deepreduce_tpu.sparse import per_tensor_key
import deepreduce_tpu_torch as port
from deepreduce_tpu_torch.models import BertEncoder
from deepreduce_tpu_torch.train import next_token_loss
from deepreduce_tpu_torch.weights import params_from_flax

SMALL = dict(vocab_size=50, hidden=32, layers=2, heads=4, mlp_dim=64, max_len=16)
BERT_DRQSGD = dict(DRQSGD, compress_ratio=0.001)  # BASELINE.json config 5's top-k 0.1%


def jlm_loss(model):
    """benchmarks/train.py's `lm` loss: the model sees tokens[:, :-1] and
    is scored against tokens[:, 1:]."""

    def loss_fn(params, batch_stats, batch):
        (toks,) = batch
        logits = model.apply({"params": params}, toks[:, :-1])
        return optax.softmax_cross_entropy_with_integer_labels(logits, toks[:, 1:]).mean(), batch_stats

    return loss_fn


@functools.lru_cache(maxsize=None)
def _small():
    """(flax model, numpy-seeded params, a batch of 3 x 9 tokens)."""
    jm = JBertEncoder(**SMALL)
    toks = np.random.default_rng(0).integers(0, SMALL["vocab_size"], size=(3, 9)).astype(np.int32)
    v = jax.eval_shape(jm.init, jax.random.PRNGKey(0), toks[:1, :-1])
    return jm, _seeded(v["params"]), (toks,)


@functools.lru_cache(maxsize=None)
def _jax_grad_fn():
    return jax.jit(jax.value_and_grad(jlm_loss(_small()[0]), has_aux=True))


def _port(params, **kw):
    m = BertEncoder(**SMALL, **kw)
    m.load_flax_params(params_from_flax(params))
    return m


def _loss_and_grads(m, batch):
    loss = next_token_loss(m)((_t(batch[0]),))
    loss.backward()
    return float(loss.detach()), {n: p.grad.clone() for n, p in m.flax_params().items()}


def test_full_width_structure_and_payload_bytes_match_flax():
    v = jax.eval_shape(JBertEncoder().init, jax.random.PRNGKey(0), jnp.zeros((1, 127), jnp.int32))
    jshapes = _shapes(v["params"])
    tm = BertEncoder()
    assert sorted(tm.flax_params()) == list(jshapes) and len(jshapes) == 200
    assert {n: tuple(p.shape) for n, p in tm.flax_params().items()} == jshapes
    assert sum(p.numel() for p in tm.parameters()) == 132_363_066 and not tm.flax_batch_stats()
    attn = "TransformerLayer_11/MultiHeadDotProductAttention_0"
    assert jshapes[f"{attn}/query/kernel"] == (768, 12, 64) and jshapes[f"{attn}/key/bias"] == (12, 64)
    assert jshapes[f"{attn}/out/kernel"] == (12, 64, 768) and jshapes["mlm/kernel"] == (768, 30_522)
    like = jax.tree_util.tree_map(lambda l: jax.ShapeDtypeStruct(l.shape, l.dtype), v["params"])
    ex = port.GradientExchanger(jshapes, port.DeepReduceConfig(**BERT_DRQSGD), device="cpu")
    assert ex.payload_bytes() == JExchanger(like, JConfig(**BERT_DRQSGD)).payload_bytes(like) == 3_193_592
    assert sum(c.compressed for c in ex.codecs.values()) == 88


def test_loss_and_gradients_match_flax():
    _, params, batch = _small()
    (jloss, _), jgrads = _jax_grad_fn()(params, {}, batch)
    loss, grads = _loss_and_grads(_port(params), batch)
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    jflat = _jax_flat_params(jgrads)
    scale = max(float(np.abs(g).max()) for g in jflat.values())
    for n, g in jflat.items():
        np.testing.assert_allclose(grads[n].numpy(), g, rtol=1e-4, atol=1e-4 * scale, err_msg=n)


def test_logits_match_flax_and_the_attention_is_flax_s():
    jm, params, (toks,) = _small()
    ref = np.asarray(jm.apply({"params": params}, toks))
    with torch.no_grad():
        got = _port(params)(_t(toks)).numpy()
    assert got.shape == (3, 9, SMALL["vocab_size"]) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_remat_gives_the_same_loss_gradients_and_names():
    _, params, batch = _small()
    plain = _port(params)
    remat = _port(params, remat=True)
    assert list(remat.flax_params()) == list(plain.flax_params())
    loss, grads = _loss_and_grads(plain, batch)
    rloss, rgrads = _loss_and_grads(remat, batch)
    assert rloss == loss
    for n, g in grads.items():
        torch.testing.assert_close(rgrads[n], g, rtol=1e-6, atol=1e-7, msg=n)


@pytest.mark.parametrize("knobs", [dict(attention="ring"), dict(attention="ulysses"),
                                   dict(attention="ring", seq_axis="seq"), dict(seq_axis="seq")])
def test_sequence_parallel_attention_is_not_ported(knobs):
    with pytest.raises(NotImplementedError, match="Queue 1 item 12"):
        BertEncoder(**SMALL, **knobs)


def test_one_drqsgd_trainer_step_matches_jax():
    # the embedding, the head and each layer's MLP kernels compressed
    knobs = dict(DRQSGD, seed=3, min_compress_size=1500)
    jm, params, batch = _small()
    jtr, jstate = jax_trainer(jm, JConfig(**knobs), batch, loss_fn=jlm_loss(jm))
    jstate = dataclasses.replace(jstate, params=jax.tree_util.tree_map(jnp.asarray, params))
    model = _port(params)
    ttr = port.Trainer(model, port.DeepReduceConfig(**knobs), lr=0.1, momentum=0.9, device="cpu",
                       loss_fn=next_token_loss(model))
    tstate = ttr.init_state()
    _, jgrads = _jax_grad_fn()(jstate.params, {}, batch)
    jflat = _jax_flat_params(jgrads)
    scale = max(float(np.abs(g).max()) for g in jflat.values())
    ttr.exchanger.exchange = _checked_exchange(ttr.exchanger.exchange, jflat, _jax_flat_params(jstate.residuals), scale)
    key = jax.random.PRNGKey(100)
    uniforms = {n: _jax_uniforms(c, per_tensor_key(jax.random.fold_in(key, 0), n, jnp.asarray(0, jnp.int32)))
                for n, c in jtr.exchanger.codecs.items() if c.val_codec is not None}
    assert len(uniforms) == sum(c.compressed for c in ttr.exchanger.codecs.values()) == 6
    jstate, jloss, jwire = jtr.step(jstate, (jnp.asarray(batch[0]),), key)
    tstate, tloss, twire = ttr.step(tstate, (_t(batch[0]),), uniforms=uniforms)
    assert ttr.exchanger.payload_bytes() == jtr.exchanger.payload_bytes(jstate.params)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(twire.rel_volume()), float(jwire.rel_volume()), rtol=1e-6)
    for n, p in _jax_flat_params(jstate.params).items():
        np.testing.assert_allclose(tstate.params[n].detach().numpy(), p, rtol=1e-4, atol=1e-6, err_msg=n)
