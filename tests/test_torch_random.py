"""The port's threefry (lightgbm_tpu_torch/utils/random.py) against
jax.random, bit for bit: the keys of PRNGKey, split and fold_in word for
word, and uniform float32 draws by their bit patterns."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.utils import random as tr

# xdist runs several test processes side by side: one intra-op thread each,
# not a pool of one a core in every process
torch.set_num_threads(1)

SEEDS = [0, 1, 7, 2 ** 31 - 1, -5]
SIZES = [1, 7, 1000, 2 ** 17 + 3]


def _jkey(seed):
    # the JAX package passes jnp.int32 seeds (models/gbdt.py); Python ints
    # in the int32 range give the same key
    return jax.random.PRNGKey(jnp.int32(seed))


def _words(jkey):
    return np.asarray(jax.random.key_data(jkey)).astype(np.int64)


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_split_and_fold_in_equal_jax(seed):
    kj, kt = _jkey(seed), tr.PRNGKey(seed)
    np.testing.assert_array_equal(kt.numpy(), _words(kj))
    np.testing.assert_array_equal(_words(jax.random.PRNGKey(seed)),
                                  kt.numpy())
    for num in (2, 5):
        np.testing.assert_array_equal(
            tr.split(kt, num).numpy(), _words(jax.random.split(kj, num)))
    for data in (0, 5, 2 ** 20):
        np.testing.assert_array_equal(
            tr.fold_in(kt, data).numpy(),
            _words(jax.random.fold_in(kj, data)))
    # a split key folded in again, as the samplers chain them
    kg = tr.split(kt)[1]
    np.testing.assert_array_equal(
        tr.fold_in(kg, 3).numpy(),
        _words(jax.random.fold_in(jax.random.split(kj)[1], 3)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", SIZES)
def test_uniform_equals_jax_bitwise(seed, n):
    kj, kt = jax.random.split(_jkey(seed))[0], tr.split(tr.PRNGKey(seed))[0]
    uj = jax.random.uniform(kj, (n,), jnp.float32)
    ut = tr.uniform(kt, (n,))
    assert ut.dtype == torch.float32 and ut.shape == (n,)
    np.testing.assert_array_equal(_bits(ut.numpy()), _bits(uj))
    assert float(ut.min()) >= 0.0 and float(ut.max()) < 1.0


@pytest.mark.parametrize("seed", [7, -5])
def test_element_does_not_depend_on_the_shape(seed):
    """The partitionable scheme: the first n draws of a longer draw are
    the draws of shape (n,), so a padded row count draws the same."""
    k = tr.fold_in(tr.PRNGKey(seed), 2 ** 20)
    long = tr.uniform(k, (2 ** 17 + 3,))
    for n in SIZES[:-1]:
        assert torch.equal(tr.uniform(k, (n,)), long[:n])
    kj = jax.random.fold_in(_jkey(seed), 2 ** 20)
    np.testing.assert_array_equal(
        _bits(jax.random.uniform(kj, (8, 125))).reshape(-1),
        _bits(long[:1000].numpy()))
    np.testing.assert_array_equal(
        _bits(tr.uniform(k, (8, 125)).numpy()).reshape(-1),
        _bits(long[:1000].numpy()))
