"""Two training steps of the codec-zoo arms `drqsgd_rle` (the run-length
index under QSGD, bitwise given JAX's uniforms) and `topr_dexp` (Fit-DExp
on Top-r, within the fit's tolerance) on a small WordLSTM, the port's
Trainer against the JAX package's from the same weights and batches."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from conftest import shared_mesh
from test_torch_codecs_zoo import _cfgs, _jax_uniforms
from test_torch_slice import _jax_flat_params, _t

from deepreduce_tpu.models.lstm import WordLSTM as JWordLSTM
from deepreduce_tpu.sparse import per_tensor_key
from deepreduce_tpu.train import Trainer as JTrainer
import deepreduce_tpu_torch as port
from deepreduce_tpu_torch.models import WordLSTM
from deepreduce_tpu_torch.weights import params_from_jax


@pytest.mark.parametrize("arm", ["drqsgd_rle", "topr_dexp"])
def test_two_step_wordlstm_trainer_matches_jax(arm):
    """Both packages' Trainer from the same weights and batches: the loss,
    rel_volume and parameters after two steps. Fit-DExp's gate is lowered to
    the small model's leaves (min_compress_size=100), so its fits run."""
    vocab, embed, hidden, batch, seq, lr, mom, seed = 64, 8, 16, 4, 5, 0.1, 0.9, 3
    jcfg, tcfg = _cfgs(arm, seed=seed, min_compress_size=100)
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, vocab, size=(2, batch, seq + 1)).astype(np.int32)
    batches = [(tokens[i, :, :-1], tokens[i, :, 1:]) for i in range(2)]
    jtr = JTrainer(JWordLSTM(vocab_size=vocab, embed_dim=embed, hidden_dim=hidden), jcfg,
                   optax.sgd(lr, momentum=mom), shared_mesh(1))
    jstate = jtr.init_state(jax.random.PRNGKey(0), batches[0])
    flat0 = _jax_flat_params(jstate.params)
    tmodel = WordLSTM(vocab, embed, hidden)
    tmodel.load_flax_params(params_from_jax(flat0))
    ttr = port.Trainer(tmodel, tcfg, lr=lr, momentum=mom, device="cpu")
    tstate = ttr.init_state()
    codecs = jtr.exchanger.codecs
    assert sum(c.compressed for c in ttr.exchanger.codecs.values()) == sum(c.compressed for c in codecs.values()) >= 5
    for i, (x, y) in enumerate(batches):
        key = jax.random.PRNGKey(100 + i)
        wkey = jax.random.fold_in(key, 0)
        uniforms = {
            n: _jax_uniforms(ttr.exchanger.codecs[n].val_codec.meta.padded_len,
                             per_tensor_key(wkey, n, jnp.asarray(i, jnp.int32)))
            for n, c in codecs.items() if c.compressed and jcfg.value == "qsgd"
        }
        jstate, jloss, jwire = jtr.step(jstate, (x, y), key)
        tstate, tloss, twire = ttr.step(tstate, (_t(x).long(), _t(y).long()), uniforms=uniforms)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
        np.testing.assert_allclose(float(twire.rel_volume()), float(jwire.rel_volume()), rtol=1e-6)
    jflat = _jax_flat_params(jstate.params)
    for n, p in tstate.params.items():
        np.testing.assert_allclose(p.detach().numpy(), jflat[n], rtol=1e-5, atol=1e-6, err_msg=n)
    assert tstate.step == 2
