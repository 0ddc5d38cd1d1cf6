"""Old-style autograd API (ref: python/mxnet/contrib/autograd.py).

Counterpart of ``incubator_mxnet_tpu/contrib/autograd.py``: the pre-1.0
surface kept for compatibility, delegating to the port's ``autograd``
tape.
"""
from __future__ import annotations

import functools

from .. import autograd as _ag
from ..ndarray.ndarray import NDArray


def set_is_training(is_train):
    """(ref: contrib/autograd.py:32) Returns the previous state."""
    prev_rec = _ag.set_recording(is_train)
    _ag.set_training(is_train)
    return prev_rec


class TrainingStateScope(object):
    """(ref: contrib/autograd.py:54)"""

    def __init__(self, enter_state):
        self._enter_state = enter_state
        self._prev = None

    def __enter__(self):
        self._prev = set_is_training(self._enter_state)

    def __exit__(self, ptype, value, trace):
        if self._prev != self._enter_state:
            set_is_training(self._prev)


def train_section():
    """Scope where gradients are recorded (ref: contrib/autograd.py:74)."""
    return TrainingStateScope(True)


def test_section():
    """Scope with recording off (ref: contrib/autograd.py:88)."""
    return TrainingStateScope(False)


def mark_variables(variables, gradients, grad_reqs="write"):
    """(ref: contrib/autograd.py:102)"""
    _ag.mark_variables(variables, gradients, grad_reqs)


def backward(outputs, out_grads=None, retain_graph=False):
    """(ref: contrib/autograd.py:123)"""
    _ag.backward(outputs, out_grads, retain_graph)


def compute_gradient(outputs):
    """(ref: contrib/autograd.py:158)"""
    backward(outputs)


def grad_and_loss(func, argnum=None):
    """Decorator: returns (gradients, loss) of func w.r.t. its array
    arguments (ref: contrib/autograd.py:163)."""
    @functools.wraps(func)
    def wrapped(*args):
        variables = list(args)
        if argnum is not None:
            argnums = argnum if isinstance(argnum, list) else [argnum]
            variables = [args[i] for i in argnums]
        for x in variables:
            assert isinstance(x, NDArray), \
                "type of autograd input should be NDArray"
        grads = [x.zeros_like() for x in variables]
        mark_variables(variables, grads)
        with train_section():
            outputs = func(*args)
        compute_gradient([outputs] if isinstance(outputs, NDArray)
                         else outputs)
        return grads, outputs
    return wrapped


def grad(func, argnum=None):
    """Decorator: returns only the gradients (ref: contrib/autograd.py:195)."""
    grad_with_loss_func = grad_and_loss(func, argnum)

    @functools.wraps(grad_with_loss_func)
    def wrapped(*args):
        return grad_with_loss_func(*args)[0]
    return wrapped
