"""examples/word_language_model.py's tied LSTM language model on the port
against the JAX package, on the CPU: the model and its training loop are
``chip_smoke.word_lm`` / ``word_lm_steps`` (the example's code, run with
either package), fed on both sides by ``gluon.contrib.data.text.
WikiText2`` and ``gluon.data.DataLoader`` from one synthetic token file
in WikiText-2's format (``chip_smoke.write_wikitext``).  Vocabulary 24,
width 16, 2 layers, dropout 0, bptt 5, batch 4, ``gluon.Trainer("adam")``
with ``clip_global_norm``: three steps from the same weights (the JAX
model's Xavier draw, copied by name), each loss and every parameter
after them within 1e-5 of max.  Also the unrolled-LSTMCell form of the
model (the smoke's CPU spread) against the fused one, within the port."""
import os

import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
import chip_smoke

REL = 1e-5


@pytest.fixture(autouse=True)
def _fresh_port_names():
    """The port's auto-named symbols and blocks count in its process-global
    NameManager (the conftest resets only the JAX package's): each test
    here names in a fresh one, so later test files see the counters as
    they were."""
    with tmx.name.NameManager():
        yield


VOCAB, WIDTH, LAYERS, BPTT, BATCH, STEPS = 24, 16, 2, 5, 4, 3
# the example's learning rate.  Adam's update m / sqrt(v) amplifies the
# gradients' rounding (other summation orders in JAX and torch) where m
# is small: the worst parameter is 7e-7 of max off here, 1.5e-5 at lr
# 0.01, against 1.2e-7 for SGD at 0.01 (gradients agree that closely)
ADAM = {"learning_rate": 0.003}


def _rel(got, ref):
    return float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()),
                                                1e-30)


@pytest.fixture(scope="module")
def token_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("wikitext2"))
    chip_smoke.write_wikitext(os.path.join(root, "wiki.train.tokens"),
                              VOCAB - 2, 600, seed=3)
    return root


def _train(mx, root, init, cells=False):
    """STEPS of the example's loop on the CPU: (losses, vocabulary size,
    {name: parameter} after them)."""
    with mx.cpu():
        data = mx.gluon.contrib.data.text.WikiText2(root=root, seq_len=BPTT)
        loader = mx.gluon.data.DataLoader(data, batch_size=BATCH,
                                          shuffle=False,
                                          last_batch="discard")
        model = chip_smoke.word_lm(mx, len(data.vocabulary), WIDTH, LAYERS,
                                   0.0, cells=cells)
        model.initialize(mx.init.Xavier(), ctx=mx.cpu())
        params = model.collect_params()
        if init is not None:
            for name, p in params.items():
                p.set_data(mx.nd.array(init[name]))
        trainer = mx.gluon.Trainer(params, "adam", dict(ADAM))
        batches = [b for _, b in zip(range(STEPS), loader)]
        hidden = model.begin_state(batch_size=BATCH, ctx=mx.cpu())
        losses, _ = chip_smoke.word_lm_steps(mx, model, trainer, batches,
                                             mx.cpu(), hidden, BATCH,
                                             bptt=BPTT)
        return ([loss.asnumpy() for loss in losses], len(data.vocabulary),
                {n: p.data().asnumpy() for n, p in params.items()})


@pytest.fixture(scope="module")
def jax_run(token_root):
    with jmx.cpu():
        init_net = chip_smoke.word_lm(jmx, VOCAB, WIDTH, LAYERS, 0.0)
        init_net.initialize(jmx.init.Xavier())
        init = {n: p.data().asnumpy()
                for n, p in init_net.collect_params().items()}
    return init, _train(jmx, token_root, init)


def test_word_lm_three_steps_match_jax(token_root, jax_run):
    init, (ref_losses, ref_vocab, ref) = jax_run
    losses, vocab, got = _train(tmx, token_root, init)
    assert vocab == ref_vocab == VOCAB
    # the tied decoder shares the embedding's weight: one parameter
    assert sorted(got) == sorted(ref) and len(got) == 2 + 4 * LAYERS
    for g, r in zip(losses, ref_losses):
        assert _rel(g, r) <= REL
    for name in ref:
        assert _rel(got[name], ref[name]) <= REL, name
    assert not np.array_equal(got["rnnmodel_embedding0_weight"],
                              init["rnnmodel_embedding0_weight"])


def test_unrolled_cells_equal_the_fused_lstm(token_root, jax_run):
    init, _ = jax_run
    fused = _train(tmx, token_root, init)
    cells = _train(tmx, token_root, init, cells=True)
    assert sorted(cells[2]) == sorted(fused[2])
    for g, r in zip(cells[0], fused[0]):
        assert _rel(g, r) <= REL
    for name in fused[2]:
        assert _rel(cells[2][name], fused[2][name]) <= REL, name


def test_token_file_vocabulary(token_root):
    """The synthetic file holds every word: the vocabulary is the words
    plus <unk> and <eos>, as WikiText-2's 33,278 are counted."""
    data = tmx.gluon.contrib.data.text.WikiText2(root=token_root,
                                                 seq_len=BPTT)
    assert len(data.vocabulary) == VOCAB
    assert data.vocabulary.idx_to_token[:2] == ["<unk>", "<eos>"]
