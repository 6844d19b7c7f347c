"""Debug mode: NaN and division-by-zero detection inside a training step
(counterpart of ``megacrn_tpu/train/debug.py``).

The JAX package instruments the jitted step with ``checkify``'s float
checks: a NaN that any primitive produces raises (even one that a ``where``
masks before the output), as does a floating division by zero; the ``-inf``
of ``log(0)`` or an overflow to ``inf`` does not. ``checkified`` gives the
same semantics in eager PyTorch with a ``TorchDispatchMode`` that looks at
every op's floating outputs, forward and backward alike (the autograd
engine runs the backward's ops under the caller's modes). Each check reads
the result on the host, one sync per op: a debugging tool, not a fast
path. The error is raised at the op, before the step goes on, so an
optimizer step after it does not run.

One difference from JAX: PyTorch computes ``1 / x`` as ``reciprocal(x)``,
so a reciprocal of zero counts as a division by zero here, where
``jnp.reciprocal(0.0)`` passes ``checkify``.
"""
from __future__ import annotations

from typing import Callable, Iterable, List, Mapping, Tuple, Union

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

_aten = torch.ops.aten
# Ops whose outputs hold whatever the memory held: never checked.
_UNINITIALISED = {_aten.empty, _aten.empty_like, _aten.empty_strided,
                  _aten.new_empty, _aten.new_empty_strided}
# Ops that divide: (op, the position of the divisor among the arguments).
_DIVISIONS = {_aten.div: 1, _aten.div_: 1, _aten.reciprocal: 0,
              _aten.reciprocal_: 0}


def _is_float(t) -> bool:
    return isinstance(t, torch.Tensor) and t.is_floating_point()


class FloatChecks(TorchDispatchMode):
    """Raise ``FloatingPointError`` at the first op that divides a float by
    zero or puts a NaN into a floating output."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func.overloadpacket
        where = _DIVISIONS.get(packet)
        if where is not None and len(args) > where:
            divisor = args[where]
            floating = _is_float(divisor) or _is_float(args[0])
            zero = (bool((divisor == 0).any())
                    if isinstance(divisor, torch.Tensor) else divisor == 0)
            if floating and zero:
                raise FloatingPointError(f"division by zero in op: {func}")
        out = func(*args, **kwargs)
        if packet not in _UNINITIALISED:
            for t in tree_leaves(out):
                if _is_float(t) and bool(torch.isnan(t).any()):
                    raise FloatingPointError(
                        f"nan generated by op: {func}")
        return out


def checkified(fn: Callable) -> Callable:
    """``fn`` with every op it runs (its backward too) under
    ``FloatChecks``: a NaN produced anywhere, or a float division by zero,
    raises ``FloatingPointError`` naming the op.

    Usage::

        safe_step = checkified(train_step)
        loss = safe_step(x, y, y_cov, batches_seen)  # raises on NaN
    """

    def wrapper(*args, **kwargs):
        with FloatChecks():
            return fn(*args, **kwargs)

    return wrapper


def grad_global_norm(grads: Union[Mapping, Iterable]) -> torch.Tensor:
    """The global L2 norm of a collection of gradients (a mapping, nested
    or flat, or an iterable of tensors): the norm ``clip_grad_norm_``
    computes and clips by."""
    return torch.nn.utils.get_total_norm(
        [g for g in tree_leaves(grads) if g is not None], norm_type=2.0)


def finite_tree(tree) -> Tuple[bool, List[str]]:
    """Host-side check of named tensors (a nested mapping or sequence of
    tensors or arrays): (all finite, the offending paths, their parts
    joined by "/")."""
    bad = []

    def walk(node, path):
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(v, path + [str(k)])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + [str(i)])
        else:
            a = (node.detach().cpu().numpy()
                 if isinstance(node, torch.Tensor) else np.asarray(node))
            if not np.all(np.isfinite(a)):
                bad.append("/".join(path))

    walk(tree, [])
    return len(bad) == 0, bad
