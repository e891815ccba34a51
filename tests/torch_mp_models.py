"""The transformer LMs of the model-parallel tests, written once for
both packages.

``lm_classes(pkg, apply)`` builds the block classes over ``pkg`` (the
JAX package or the port): ``apply(fn, x)`` runs ``fn`` on the array
inside the NDArray ``x`` (JAX ``_invoke_fn``; the port wraps the
tensor), and each model takes an ``attend(q, k, v)`` over the package's
arrays.  The structure is ``examples/transformer_lm.py``'s and
``examples/moe_transformer_lm.py``'s with the parallel layers composed
in as ``__graft_entry__.py``'s dryrun composes them: qkv and fc1
``ColumnParallelDense``, proj and fc2 ``RowParallelDense``, the
embedding ``ShardedEmbedding`` and the head ``ColumnParallelDense``;
the MoE form's FFN ``MoELayer(d, 4d, num_experts=4, top_k=2,
capacity_factor=2.0)``; the pipeline form an embedding and a head split
over ``pp`` around a ``PipelineStack`` of a column/row FFN stage.  The
same code builds the same parameter names in both packages.  This file
imports neither package.
"""
import numpy as np


def markov_batch(rs, n, t, vocab):
    """``examples/transformer_lm.py``'s batches: each next token is
    ``3 * prev + 1 (mod vocab)`` with probability 0.9, else uniform."""
    toks = np.zeros((n, t + 1), np.int64)
    toks[:, 0] = rs.randint(vocab, size=n)
    for i in range(1, t + 1):
        nxt = (toks[:, i - 1] * 3 + 1) % vocab
        noise = rs.randint(vocab, size=n)
        mask = rs.rand(n) < 0.9
        toks[:, i] = np.where(mask, nxt, noise)
    return toks[:, :-1].astype("float32"), toks[:, 1:].astype("float32")


def lm_classes(pkg, apply):
    gluon = pkg.gluon
    nn = gluon.nn
    par = pkg.parallel

    class CausalSelfAttention(gluon.Block):
        def __init__(self, dim, heads, attend, **kwargs):
            super().__init__(**kwargs)
            self._dim, self._heads, self._attend = dim, heads, attend
            with self.name_scope():
                self.qkv = par.ColumnParallelDense(
                    3 * dim, in_units=dim, flatten=False, use_bias=False)
                self.proj = par.RowParallelDense(dim, in_units=dim,
                                                 flatten=False)

        def forward(self, x):
            b, t, _ = x.shape
            dim, h = self._dim, self._heads
            d = dim // h
            attend = self._attend

            def attn(a):
                def split(z):
                    return z.reshape(b, t, h, d).swapaxes(1, 2)
                o = attend(split(a[..., :dim]), split(a[..., dim:2 * dim]),
                           split(a[..., 2 * dim:]))
                return o.swapaxes(1, 2).reshape(b, t, dim)

            return self.proj(apply(attn, self.qkv(x)))

    class TransformerBlock(gluon.Block):
        def __init__(self, dim, heads, attend, experts=0, **kwargs):
            super().__init__(**kwargs)
            self._dim = dim
            self._moe = bool(experts)
            with self.name_scope():
                self.ln1 = nn.LayerNorm(in_channels=dim)
                self.attn = CausalSelfAttention(dim, heads, attend)
                self.ln2 = nn.LayerNorm(in_channels=dim)
                if experts:
                    self.mlp = par.MoELayer(dim, 4 * dim,
                                            num_experts=experts, top_k=2,
                                            capacity_factor=2.0)
                else:
                    self.mlp = nn.HybridSequential()
                    with self.mlp.name_scope():
                        self.mlp.add(par.ColumnParallelDense(
                            4 * dim, in_units=dim, flatten=False,
                            activation="relu"),
                            par.RowParallelDense(dim, in_units=4 * dim,
                                                 flatten=False))

        def forward(self, x):
            x = x + self.attn(self.ln1(x))
            h = self.ln2(x)
            if self._moe:
                b, t, dim = h.shape
                return x + self.mlp(h.reshape((-1, dim))).reshape(
                    (b, t, dim))
            return x + self.mlp(h)

    def ffn_stage(dim, prefix="stage_"):
        """The pipeline stage of ``__graft_entry__.py``'s combined LM: a
        column/row FFN, tensor parallel over ``tp``."""
        blk = nn.HybridSequential(prefix=prefix)
        with blk.name_scope():
            blk.add(par.ColumnParallelDense(2 * dim, activation="relu",
                                            in_units=dim, flatten=False),
                    par.RowParallelDense(dim, in_units=2 * dim,
                                         flatten=False))
        return blk

    class TransformerLM(gluon.Block):
        """``depth`` transformer blocks, or with ``stage`` a
        ``PipelineStack`` of ``stages`` copies of it; the embedding and
        the head split over ``vocab_axis``."""

        def __init__(self, vocab, dim, heads, depth, seq_len, attend,
                     experts=0, vocab_axis="tp", stage=None, stages=2,
                     microbatches=None, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.embed = par.ShardedEmbedding(vocab, dim,
                                                  axis=vocab_axis)
                self.pos = self.params.get(
                    "pos", shape=(1, seq_len, dim),
                    init=pkg.init.Normal(0.02))
                if stage is not None:
                    self.blocks = par.PipelineStack(
                        stage, num_stages=stages,
                        num_microbatches=microbatches)
                else:
                    self.blocks = nn.Sequential()
                    with self.blocks.name_scope():
                        for _ in range(depth):
                            self.blocks.add(TransformerBlock(
                                dim, heads, attend, experts))
                self.ln_f = nn.LayerNorm(in_channels=dim)
                self.head = par.ColumnParallelDense(
                    vocab, in_units=dim, flatten=False, axis=vocab_axis)

        def forward(self, tokens):
            x = self.embed(tokens) + self.pos.data()
            x = self.blocks(x)
            return self.head(self.ln_f(x))

    class FlatLoss:
        """Softmax cross-entropy over (B*T, V)."""

        def __init__(self, vocab):
            self._vocab = vocab
            self._ce = gluon.loss.SoftmaxCrossEntropyLoss()

        def __call__(self, out, y):
            return self._ce(out.reshape((-1, self._vocab)),
                            y.reshape((-1,)))

    return {"TransformerLM": TransformerLM, "ffn_stage": ffn_stage,
            "FlatLoss": FlatLoss, "TransformerBlock": TransformerBlock}
