"""The subset of `jax.random` the JAX package draws from, bit for bit.

`PRNGKey`, `split`, `fold_in` and `uniform` (float32) of the threefry2x32
generator as jax 0.9.0 computes them with `jax_threefry_partitionable` on
(its default): jax/_src/prng.py `threefry_seed`, `threefry_2x32`,
`_threefry_split_foldlike`, `threefry_fold_in`,
`_threefry_random_bits_partitionable`, and jax/_src/random.py `_uniform`.
The quantized-gradient discretizer's stochastic rounding and the bagging /
GOSS masks of the port draw here, so they equal the JAX package's draws
and both grow the same trees.

Under the partitionable scheme element i of a draw hashes the 64-bit
counter i (as two 32-bit words) with the key, so it depends on the key and
on i alone, not on the shape: the first N draws of a longer draw are the
draws of shape (N,).

A key is a [2] int64 CPU tensor holding the two uint32 words of the JAX
key (`jax.random.key_data` of the same key, widened). Keys are a few words
and are derived on the host; `uniform` computes its bits on `device`.
torch has no full-range uint32 arithmetic, so every word is an int64
holding 0 .. 2^32 - 1, masked after each add and left shift.

A `DevKey` holds the two words as int64 tensors on the device instead, and
the functions below never read it back: `PRNGKey` of a seed tensor,
`fold_in` of a DevKey or of a data tensor, and `split` of a DevKey give
DevKeys, and `uniform` draws from one on its words' device. The batched
trainer keys its draws so, from per-iteration device buffers that a
captured CUDA graph reads (a Python int would be baked into the graph).
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Sequence, Tuple, Union

import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

Word = Union[int, torch.Tensor]


def _rotl(x: Word, d: int) -> Word:
    return ((x << d) & _M32) | (x >> (32 - d))


def threefry2x32(k1: Word, k2: Word, x1: Word, x2: Word) -> Tuple[Word, Word]:
    """The threefry2x32 hash of the counter words (x1, x2) under the key
    (k1, k2): 20 rounds, key injections every 4 (prng.py
    _threefry2x32_lowering). Words are ints or int64 tensors in
    [0, 2^32); the result has the counters' shape."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x = [(x1 + ks[0]) & _M32, (x2 + ks[1]) & _M32]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _M32
            x[1] = x[0] ^ _rotl(x[1], r)
        x[0] = (x[0] + ks[(i + 1) % 3]) & _M32
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & _M32
    return x[0], x[1]


class DevKey(NamedTuple):
    """A key whose words stay on the device: int64 tensors (0-dim, or of a
    common shape) holding 0 .. 2^32 - 1."""
    k1: torch.Tensor
    k2: torch.Tensor


Key = Union[torch.Tensor, DevKey]


def _key(k1: int, k2: int) -> torch.Tensor:
    return torch.tensor([k1, k2], dtype=torch.int64)


def _words(key: Key) -> Tuple[Word, Word]:
    if isinstance(key, DevKey):
        return key.k1, key.k2
    k1, k2 = (int(v) for v in key.reshape(2).tolist())
    return k1, k2


def PRNGKey(seed: Union[int, torch.Tensor]) -> Key:
    """jax.random.PRNGKey of an int32 seed (x64 off): the high word is the
    seed shifted right by 32 bits, which is 0 for an int32, the low word
    its two's-complement bits (threefry_seed). Seeds outside the int32
    range wrap, as `jnp.int32(seed)` would have to. An int64 tensor seed
    gives a DevKey on its device."""
    if isinstance(seed, torch.Tensor):
        s = seed.to(torch.int64)
        return DevKey(torch.zeros_like(s), s & _M32)
    return _key(0, int(seed) & _M32)


def device_key(key: torch.Tensor, device) -> DevKey:
    """A host key's words as a DevKey on `device` (one read of the host
    key, where it is made)."""
    k1, k2 = _words(key)
    return DevKey(torch.tensor(k1, dtype=torch.int64, device=device),
                  torch.tensor(k2, dtype=torch.int64, device=device))


def fold_in(key: Key, data: Union[int, torch.Tensor]) -> Key:
    """jax.random.fold_in: the hash of the counter (0, data as uint32)
    under `key` (threefry_fold_in). A DevKey, or data given as an int64
    tensor, gives a DevKey."""
    k1, k2 = _words(key)
    if isinstance(data, torch.Tensor) or isinstance(key, DevKey):
        d = data.to(torch.int64) & _M32 if isinstance(data, torch.Tensor) \
            else int(data) & _M32
        return DevKey(*threefry2x32(k1, k2, 0, d))
    return _key(*threefry2x32(k1, k2, 0, int(data) & _M32))


def split(key: Key, num: int = 2) -> Union[torch.Tensor, List[DevKey]]:
    """jax.random.split: [num, 2] keys, key i the hash of the counter
    (0, i) (_threefry_split_foldlike over an iota of `num`); of a DevKey,
    a list of `num` DevKeys."""
    k1, k2 = _words(key)
    if isinstance(key, DevKey):
        return [DevKey(*threefry2x32(k1, k2, 0, i)) for i in range(num)]
    lo = torch.arange(num, dtype=torch.int64)
    b1, b2 = threefry2x32(k1, k2, lo >> 32, lo & _M32)
    return torch.stack([b1, b2], dim=1)


def random_bits(key: Key, shape: Sequence[int],
                device=None) -> torch.Tensor:
    """32 random bits per element as int64 in [0, 2^32): the two hash
    words of element i's counter (i >> 32, i & 0xFFFFFFFF), xored
    (_threefry_random_bits_partitionable, bit_width 32). A DevKey draws
    on its words' device."""
    k1, k2 = _words(key)
    if isinstance(key, DevKey):
        device = key.k1.device
    n = math.prod(shape)
    i = torch.arange(n, dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(k1, k2, i >> 32, i & _M32)
    return (b1 ^ b2).reshape(tuple(shape))


def uniform(key: Key, shape: Sequence[int],
            device=None) -> torch.Tensor:
    """jax.random.uniform(key, shape, float32) on [0, 1): the top 23 bits
    as the mantissa of a float in [1, 2), minus 1 (random.py _uniform; its
    `* (maxval - minval) + minval` and max with minval are exact for
    [0, 1))."""
    bits = random_bits(key, shape, device)
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return fbits.view(torch.float32) - 1.0
