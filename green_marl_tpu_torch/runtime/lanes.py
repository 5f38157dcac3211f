"""The lane axis of a batched compiled program (``CompiledProc.batch``).

The JAX package batches a compiled program with ``jax.vmap``: a value that
depends on a batched argument is a ``BatchTracer``, every other value stays
unbatched and is computed once.  Here such a value is a :class:`Lanes`
tensor whose axis 0 is the lane.  A lane's scalar is ``[B, 1]`` and a
lane's vector ``[B, L]``, so that plain broadcasting lines a lane value up
with an unbatched one: ``[B, 1]`` against an ``[L]`` vector gives
``[B, L]``, ``[B, L]`` against a 0-d scalar stays ``[B, L]``.  Every torch
operation with a ``Lanes`` operand returns a ``Lanes`` result (the
subclass's inherited ``__torch_function__``), as every JAX operation with a
``BatchTracer`` operand returns one; what the lowering computes from
unbatched values alone stays a plain tensor.

What broadcasting cannot do is here: a value's shape as one lane sees it
(:func:`lshape`), reductions and arg-reductions per lane, and gathers and
scatters with shared or per-lane indices.
"""

from __future__ import annotations

from typing import Tuple

import torch


class Lanes(torch.Tensor):
    """A lane-dependent value: axis 0 is the lane, a scalar is ``[B, 1]``."""


def is_lanes(x) -> bool:
    return isinstance(x, Lanes)


def mark(x: torch.Tensor) -> Lanes:
    return x.as_subclass(Lanes)


def plain(x):
    """The tensor without the mark (its values and shape unchanged)."""
    return x.as_subclass(torch.Tensor) if isinstance(x, Lanes) else x


def lshape(x) -> Tuple[int, ...]:
    """The shape one lane sees: ``()`` for ``[B, 1]``, ``(L,)`` for
    ``[B, L]``; a plain tensor's own shape."""
    if not isinstance(x, Lanes):
        return tuple(x.shape) if isinstance(x, torch.Tensor) else ()
    s = tuple(x.shape[1:])
    return () if s == (1,) else s


def spread(x: torch.Tensor, b: int) -> Lanes:
    """A plain value given to every one of ``b`` lanes (a view)."""
    if isinstance(x, Lanes):
        return x
    if x.dim() == 0:
        return mark(x.reshape(1, 1).expand(b, 1))
    return mark(x.unsqueeze(0).expand((b,) + tuple(x.shape)))


def expand_like(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``v`` broadcast to the shape of ``v`` and ``like`` together, a
    ``Lanes`` view where either is one."""
    out = v.expand(torch.broadcast_shapes(v.shape, like.shape))
    return mark(out) if isinstance(like, Lanes) else out


def _rows(x: Lanes) -> torch.Tensor:
    return x.reshape(x.shape[0], -1)


def reduce(op: str, x: torch.Tensor) -> torch.Tensor:
    """Whole-value reduction, per lane for ``Lanes`` (``[B, 1]``): op is
    ``sum`` (int32 for integers and bool, as ``jnp.sum``), ``prod``,
    ``min``, ``max``, ``all`` or ``any``.  A lane's float sum or product is
    the call on its own row, so that it has the bits of the unbatched
    program's (a reduction over one axis of ``[B, L]`` may add in another
    order); the others are exact either way and take one call."""
    if op not in _REDUCE:
        raise ValueError(f"no reduction {op}")
    f = _REDUCE[op]
    if not isinstance(x, Lanes):
        return f(x)
    r = plain(x).reshape(x.shape[0], -1)
    if op in ("sum", "prod") and r.dtype.is_floating_point:
        out = torch.stack([f(row) for row in r]).unsqueeze(1)
    elif op in ("sum", "prod"):
        out = getattr(r, op)(1, keepdim=True, dtype=torch.int32)
    else:
        out = {"min": r.amin, "max": r.amax, "all": r.all,
               "any": r.any}[op](1, keepdim=True)
    return mark(out)


def _jnp_sum(x):
    return x.sum() if x.dtype.is_floating_point else x.sum(dtype=torch.int32)


def _jnp_prod(x):
    return x.prod() if x.dtype.is_floating_point \
        else x.prod(dtype=torch.int32)


_REDUCE = {"sum": _jnp_sum, "prod": _jnp_prod, "min": torch.min,
           "max": torch.max, "all": torch.all, "any": torch.any}


def arg(op: str, x: torch.Tensor) -> torch.Tensor:
    """``argmin``/``argmax`` over the flattened value (the first on ties,
    as ``jnp.argmin``), per lane for ``Lanes`` (``[B, 1]`` int64)."""
    f = torch.argmin if op == "min" else torch.argmax
    if isinstance(x, Lanes):
        return f(_rows(x), 1, keepdim=True)
    return f(x)


def _wrap(idx: torch.Tensor, n: int) -> torch.Tensor:
    idx = idx.long()
    return torch.where(idx < 0, idx + n, idx)


def take(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``arr[idx]`` along the value's axis 0 with JAX's rules (a negative
    index counts from the end, one still out of range reads the nearest
    row), where ``arr`` or ``idx`` may hold lanes.  ``arr`` is 1-D per
    lane when it holds lanes."""
    if not isinstance(arr, Lanes):
        n = arr.shape[0]
        return arr[_wrap(idx, n).clamp(0, n - 1)]
    b, n = arr.shape[0], arr.shape[1]
    if arr.dim() != 2:
        raise ValueError("a gather from a lane value of rank > 1")
    i = _wrap(idx, n).clamp(0, n - 1)
    if not isinstance(idx, Lanes):
        if i.dim() == 0:
            return arr[:, i.reshape(1)]
        return mark(plain(arr).index_select(1, i.reshape(-1))
                    .reshape((b,) + tuple(i.shape)))
    return mark(torch.gather(plain(arr), 1, plain(i).reshape(b, -1))
                .reshape(i.shape))


def _lead(x: torch.Tensor) -> torch.Tensor:
    """``[B, ...]`` for a lane value, ``[1, ...]`` for a plain one."""
    if isinstance(x, Lanes):
        return plain(x)
    return x.reshape(1, 1) if x.dim() == 0 else x.unsqueeze(0)


def put(arr: torch.Tensor, idx, val) -> Lanes:
    """``arr.at[idx].set(val)`` along the value's axis 0 per lane, where
    any of the three may hold lanes (at least one does): a negative index
    counts from the end, one still out of range is dropped.  Duplicate
    indices must carry equal values.  ``arr`` is 1-D per lane."""
    idx = torch.as_tensor(idx, device=arr.device)
    val = torch.as_tensor(val, device=arr.device).to(arr.dtype)
    b = next(x.shape[0] for x in (arr, idx, val) if isinstance(x, Lanes))
    arr = plain(spread(arr, b))
    if arr.dim() != 2:
        raise ValueError("a scatter into a lane value of rank > 1")
    n = arr.shape[1]
    i, v = _lead(_wrap(idx, n)), _lead(val)
    shape = torch.broadcast_shapes(i.shape, v.shape, (b, 1))
    i = i.expand(shape).reshape(b, -1)
    i = torch.where((i >= 0) & (i < n), i, n)
    i = i + torch.arange(b, device=i.device).unsqueeze(1) * (n + 1)
    buf = torch.cat([arr, arr[:, :1]], 1).reshape(-1)
    buf.index_put_((i.reshape(-1),), v.expand(shape).reshape(-1))
    return mark(buf.reshape(b, n + 1)[:, :n])


def seg(vals: torch.Tensor, ids: torch.Tensor, n: int, fn) -> Lanes:
    """Unsorted segment reduction per lane: ``fn(vals, ids, segments)`` is
    the one-lane reduction of flat tensors; ``ids`` lie in ``[0, n]`` (row
    ``n`` a junk row for the caller to drop or keep).  ``vals`` and
    ``ids`` are ``[L]`` or lane values, at least one of them.  Returns
    ``[B, n + 1]``."""
    b = next(x.shape[0] for x in (vals, ids) if isinstance(x, Lanes))
    shape = torch.broadcast_shapes(_lead(vals).shape, _lead(ids).shape,
                                   (b, 1))
    i = _lead(ids).long().expand(shape)
    i = i + torch.arange(b, device=i.device).reshape(
        (b,) + (1,) * (i.dim() - 1)) * (n + 1)
    v = _lead(vals).expand(shape).reshape(-1)
    return mark(fn(v, i.reshape(-1), b * (n + 1)).reshape(b, n + 1))


def lanes_of(tree) -> int:
    """The lane count of the first lane value among ``tree``'s tensors (a
    tensor or a collection dataclass), 0 if it holds none."""
    from .collections import tree_leaves
    return next((x.shape[0] for x in tree_leaves(tree)
                 if isinstance(x, Lanes)), 0)
