"""Counter-based RNG that draws JAX's own bits, and the sampling builtins.

Counterpart of ``green_marl_tpu/runtime/rng.py``, which draws from
``jax.random`` (threefry2x32, ``jax_threefry_partitionable=True``, JAX's
default since 0.5).  For sampled sets equal to the JAX package's bit for
bit, this module carries its own threefry2x32 in plain PyTorch and JAX's
recipes on top of it:

* ``threefry2x32``: the 20-round Threefry-2x32 block (Salmon et al., SC'11)
  with JAX's key schedule ``[k0, k1, k0 ^ k1 ^ 0x1BD11BDA]``;
* a draw of shape ``S`` gives lane ``j`` (row-major) the counter
  ``(j >> 32, j & 0xFFFFFFFF)``; its 32 random bits are ``out0 ^ out1``;
* ``split(key, n)``: key ``i`` is both output words of counter ``(0, i)``;
* ``uniform``: the top 23 bits as a float32 mantissa in ``[1, 2)``, minus 1;
* ``randint``: JAX's two-word draw reduced modulo the span, with the
  uint32 wraps of its multiplier and of ``hi % span * mult + lo % span``.

A key is a ``[..., 2]`` int64 tensor of 32-bit words (not a
``torch.Generator``: the point is JAX's stream, not torch's); leading
dimensions are a batch of keys, and every draw gets them in front of its
shape.  Words ride in int64 and are masked to 32 bits after each step,
since torch on the CPU has no ``>>`` for uint32.  The work runs on the
key's device.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch

from ..graph.csr import Graph

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Shape = Union[int, Sequence[int]]


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, int) else tuple(shape)


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 of counters ``(x0, x1)`` under key ``(k0, k1)``.

    Every argument is an int64 tensor (or int) of 32-bit words; they
    broadcast.  Returns the two output words, int64 in ``[0, 2^32)``."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + k0) & MASK
    x1 = (x1 + k1) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = (((x1 << r) & MASK) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def PRNGKey(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a 64-bit seed: ``(seed >> 32,
    seed & 0xFFFFFFFF)``.  JAX with ``jax_enable_x64`` off (its default)
    keeps only the low 32 bits of a Python int, giving ``(0, seed &
    0xFFFFFFFF)``; the two agree for seeds below 2^32."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & MASK, seed & MASK], dtype=torch.int64,
                        device=device)


def _counters(shape: Tuple[int, ...], device):
    """The counter words of each lane of a draw of ``shape``."""
    j = torch.arange(int(np.prod(shape, dtype=np.int64)), dtype=torch.int64,
                     device=device).reshape(shape)
    return j >> 32, j & MASK


def _bind(key: torch.Tensor, shape: Tuple[int, ...]):
    """Key words shaped to broadcast against a draw of ``shape``."""
    batch = key.shape[:-1]
    k0 = key[..., 0].reshape(batch + (1,) * len(shape))
    k1 = key[..., 1].reshape(batch + (1,) * len(shape))
    return k0, k1


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``[..., num, 2]`` keys."""
    k0, k1 = _bind(key, (num,))
    x0, x1 = _counters((num,), key.device)
    return torch.stack(threefry2x32(k0, k1, x0, x1), dim=-1)


def random_bits(key: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """32 random bits a lane (``jax.random.bits``), int64 in
    ``[0, 2^32)``, of shape ``key.shape[:-1] + shape``."""
    shape = _shape(shape)
    k0, k1 = _bind(key, shape)
    y0, y1 = threefry2x32(k0, k1, *_counters(shape, key.device))
    return y0 ^ y1


def uniform(key: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.uniform`` in ``[0, 1)``, float32: the ``Uniform()``
    builtin."""
    bits = random_bits(key, shape)
    one = (bits >> 9) | 0x3F800000          # mantissa under exponent 0
    return one.to(torch.int32).view(torch.float32) - 1.0


def randint(key: torch.Tensor, shape: Shape, minval: int,
            maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, int32)``: int32 in
    ``[minval, maxval)``, or ``minval`` where ``maxval <= minval``."""
    minval, maxval = int(minval), int(maxval)
    keys = split(key)
    hi = random_bits(keys[..., 0, :], shape)
    lo = random_bits(keys[..., 1, :], shape)
    span = maxval - minval if maxval > minval else 1
    # JAX's 2^32 % span as (2^16 % span)^2 % span in uint32: the square
    # wraps to 0 for every span above 2^16
    mult = ((((1 << 16) % span) ** 2) & MASK) % span
    off = ((((hi % span) * mult) & MASK) + lo % span) & MASK
    return (minval + off % span).to(torch.int32)


# ---------------------------------------------------------------------------
# The sampling builtins of random_*_sampling.gm
# ---------------------------------------------------------------------------

def pick_random_nodes(key: torch.Tensor, g: Graph, shape: Shape = ()
                      ) -> torch.Tensor:
    """``G.PickRandom()``: uniform node ids, int32."""
    return randint(key.to(g.device), shape, 0, g.num_nodes)


def random_nbr(g: Graph, v: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The out-neighbour of each ``v`` that the uniform draw ``u`` (float32,
    the shape of ``v``) picks: slot ``floor(u * max(deg, 1))`` of the row,
    clamped to ``deg - 1`` and to the last slot; the sentinel where the
    degree is 0 and for the sentinel itself (whose row JAX's clamped gather
    reads as empty)."""
    v = v.long()
    lo = g.begin[v]
    deg = g.begin[(v + 1).clamp(max=g.num_nodes)] - lo
    off = torch.floor(u * deg.clamp(min=1).to(torch.float32)).to(deg.dtype)
    off = torch.minimum(off, (deg - 1).clamp(min=0))
    idx = (lo + off).clamp(0, g.e_pad - 1)
    return torch.where(deg > 0, g.node_idx[idx.long()], g.sentinel)


def pick_random_nbr(key: torch.Tensor, g: Graph,
                    v: torch.Tensor) -> torch.Tensor:
    """``n.PickRandomNbr()``: a uniform out-neighbour of each ``v``; the
    sentinel for degree-0 nodes (the reference guards with ``n.Degree() ==
    0``)."""
    return random_nbr(g, v, uniform(key.to(g.device), tuple(v.shape)))


def key_chain(key: torch.Tensor, steps: int) -> torch.Tensor:
    """``[steps, 2]`` keys ``key_0 = key``, ``key_{i+1} = split(key_i)[0]``
    (the carried key of a loop that splits off its subkeys each step), on
    ``key``'s device.  The chain is serial, so it runs in Python integers on
    the host: one Threefry block a step."""
    k0, k1 = (int(w) for w in key.cpu().tolist())
    out = np.empty((steps, 2), np.int64)
    for i in range(steps):
        out[i] = k0, k1
        k0, k1 = threefry2x32(k0, k1, 0, 0)
    return torch.from_numpy(out).to(key.device)
