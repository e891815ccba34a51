"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py):
one tiny decoder with seeded numpy weights, built on both sides — the
JAX package's ``TransformerDecoder`` (the reference) and the port's,
the weights moved through ``convert.params_from_numpy``."""
import numpy as np

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu.gluon.decoder import TransformerDecoder as JaxDecoder
from incubator_mxnet_tpu_torch.convert import params_from_numpy
from incubator_mxnet_tpu_torch.gluon.decoder import \
    TransformerDecoder as TorchDecoder

VOCAB = 32
SMALL = dict(vocab=VOCAB, dim=32, heads=2, depth=2, max_len=64)


def jax_decoder(seed=0, **kw):
    """The reference decoder with weights drawn by numpy from ``seed``:
    weights ~ N(0, 0.2), biases and LayerNorm beta ~ N(0, 0.1),
    gamma ~ 1 + N(0, 0.1)."""
    cfg = dict(SMALL, **kw)
    mx.random.seed(0)
    net = JaxDecoder(prefix="lm_", **cfg)
    net.initialize()
    rs = np.random.RandomState(seed)
    for name, p in net.collect_params().items():
        noise = rs.randn(*p.shape).astype(np.float32)
        if name.endswith("gamma"):
            arr = 1.0 + 0.1 * noise
        elif name.endswith(("beta", "bias")):
            arr = 0.1 * noise
        else:
            arr = 0.2 * noise
        p.set_data(mx.nd.array(arr))
    return net


def torch_twin(jax_net, **kw):
    """The port's decoder on the CPU holding ``jax_net``'s weights."""
    named = {n: p.data().asnumpy()
             for n, p in jax_net.collect_params().items()}
    net = TorchDecoder(device="cpu", **dict(SMALL, **kw))
    net.load_state_dict(params_from_numpy(named))
    return net.eval()


def prompts(n, seed=1, lengths=None):
    rs = np.random.RandomState(seed)
    lengths = lengths or [int(rs.randint(2, 14)) for _ in range(n)]
    return [rs.randint(1, VOCAB, size=L).tolist() for L in lengths]
