"""The port's paged KV-cache primitives against the JAX package's,
exactly (pure index moves: no arithmetic, so no tolerance).  The JAX
helpers return a new pool; the port's writers update the pool in place,
so each comparison is of the whole pool after the write."""
import numpy as np
import torch

import jax.numpy as jnp
from incubator_mxnet_tpu.parallel import paged_attention as jpa
from incubator_mxnet_tpu_torch.parallel import paged_attention as tpa

NB, LAYERS, H, BS, HD = 7, 2, 2, 4, 3


def _pool(seed=0):
    rs = np.random.RandomState(seed)
    return rs.randn(NB, LAYERS, H, BS, HD).astype(np.float32)


def test_gather_layer_blocks_exact():
    pool = _pool()
    pt = np.array([[1, 3, 0], [2, 6, 4], [0, 0, 0]], np.int32)
    for layer in range(LAYERS):
        ref = np.asarray(jpa.gather_layer_blocks(jnp.asarray(pool),
                                                 jnp.asarray(pt), layer))
        got = tpa.gather_layer_blocks(torch.from_numpy(pool),
                                      torch.from_numpy(pt), layer)
        np.testing.assert_array_equal(got.numpy(), ref)


def test_scatter_prompt_blocks_exact_in_place():
    pool = _pool(1)
    kv = np.random.RandomState(2).randn(LAYERS, H, 3 * BS, HD) \
        .astype(np.float32)
    ids = np.array([5, 2, 6], np.int32)
    ref = np.asarray(jpa.scatter_prompt_blocks(
        jnp.asarray(pool), jnp.asarray(kv), jnp.asarray(ids), BS))
    tpool = torch.from_numpy(pool.copy())
    out = tpa.scatter_prompt_blocks(tpool, torch.from_numpy(kv),
                                    torch.from_numpy(ids), BS)
    assert out is tpool                       # updated in place
    np.testing.assert_array_equal(tpool.numpy(), ref)


def test_write_token_rows_exact_inactive_slot_hits_null_block():
    pool = _pool(3)
    pt = np.array([[1, 3, 0], [0, 0, 0], [2, 6, 4]], np.int32)
    positions = np.array([5, 0, 10], np.int32)    # slot 1 inactive
    rows = np.random.RandomState(4).randn(3, LAYERS, H, HD) \
        .astype(np.float32)
    ref = np.asarray(jpa.write_token_rows(
        jnp.asarray(pool), jnp.asarray(pt), jnp.asarray(positions),
        jnp.asarray(rows), BS))
    tpool = torch.from_numpy(pool.copy())
    tpa.write_token_rows(tpool, torch.from_numpy(pt),
                         torch.from_numpy(positions), torch.from_numpy(rows),
                         BS)
    np.testing.assert_array_equal(tpool.numpy(), ref)
    # the inactive slot wrote into the null block only
    np.testing.assert_array_equal(tpool.numpy()[0, :, :, 0], rows[1])


def test_copy_blocks_exact_with_self_copies():
    pool = _pool(5)
    dst = np.array([3, 4, 6], np.int32)
    src = np.array([1, 4, 2], np.int32)         # slot 1: self-copy no-op
    ref = np.asarray(jpa.copy_blocks(jnp.asarray(pool), jnp.asarray(dst),
                                     jnp.asarray(src)))
    tpool = torch.from_numpy(pool.copy())
    tpa.copy_blocks(tpool, torch.from_numpy(dst), torch.from_numpy(src))
    np.testing.assert_array_equal(tpool.numpy(), ref)
