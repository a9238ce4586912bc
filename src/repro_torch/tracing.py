"""Spans and counters of the port's training step, on only while
``torch.profiler`` records.

This module has no counterpart in ``repro``: the JAX package is read
through XLA's own profile.  Here every span is a ``record_function`` span,
so it sits on Kineto's timeline beside the CUDA kernels it launches, and
``torch.profiler``'s event tree gives each span the device time of the
kernels launched inside it.

Everything is decided by :func:`recording`, one check of
``torch.autograd.profiler._is_profiler_enabled``.  While the profiler does
not record, :func:`span` is a shared no-op context, :func:`layer` calls its
function as it is, :func:`forward_backward` is the loss and
``torch.autograd.grad``, no node joins the autograd graph and no counter
is touched.

* :func:`span`: a span on the calling thread (``step.forward``,
  ``optimizer``).
* :func:`layer`: a layer's forward inside the span ``<name>`` and its
  backward inside ``<name>.bwd`` (``moe``, ``ce``).  The backward runs on
  the autograd engine's thread, not the caller's (on a card, one thread a
  device), so its span is opened and closed there, by two identity nodes:
  one on the layer's outputs opens it when the gradient reaches them, one on
  its inputs closes it when the gradient leaves them.
* :func:`forward_backward`: a train step's loss inside ``step.forward`` and
  its gradients inside ``step.backward``, opened on the backward's thread by
  an identity node on the loss and closed there by one on the parameters;
  the calling thread's side (the engine's start, then the wait) is
  ``step.backward.caller``.
* :func:`recomputed`: a function that remat checkpoints; its run inside a
  backward (the recompute) sits in the span ``recompute``.  The node that
  opens a layer's backward span first makes remat recompute the
  checkpointed group around the layer, so that recompute stays outside the
  layer's ``.bwd`` span (a layer's own checkpoints, as the CE's chunks,
  recompute inside it).
* :func:`count`: integer counters, added to on a first forward (not on
  remat's recompute), on the device where the count is a tensor;
  :func:`counters` reads them all with one synchronisation.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, Union

import torch
import torch.autograd.profiler as _profiler

_NULL = contextlib.nullcontext()


class _Forced(threading.local):
    # inside a recompute: whether the forward it repeats was recorded, so
    # that both build the same graph even if the profiler started or
    # stopped in between
    on = None


_forced = _Forced()


def recording() -> bool:
    """Whether spans, backward spans and counters are on: the profiler
    records (inside a recompute, it recorded the forward)."""
    on = _forced.on
    return _profiler._is_profiler_enabled if on is None else on


def _in_backward() -> bool:
    return torch._C._current_graph_task_id() != -1


def span(name: str):
    """A ``record_function`` span while recording, else a no-op context."""
    return torch.profiler.record_function(name) if recording() else _NULL


class _Span:
    """One backward span, opened and closed by handle on the thread that
    runs the backward.  ``closes`` is the context of the node that closes
    it, which saved the layer's smallest input."""

    __slots__ = ("name", "handle", "closes")

    def __init__(self, name: str):
        self.name, self.handle, self.closes = name, None, None

    def open(self) -> None:
        if self.closes is not None:
            # reading the saved input makes remat recompute a checkpointed
            # group around the layer now, before the span opens; saved at
            # the layer's start, it adds no work to the recompute
            self.closes.saved_tensors
            self.closes = None
        self.handle = torch.ops.profiler._record_function_enter_new(self.name, None)

    def close(self) -> None:
        if self.handle is not None:
            torch.ops.profiler._record_function_exit._RecordFunction(self.handle)
            self.handle = None


class _Opens(torch.autograd.Function):
    """Identity on a layer's outputs; its backward opens the span."""

    @staticmethod
    def forward(ctx, state, *ts):
        ctx.state = state
        ctx.set_materialize_grads(False)
        return tuple(t.view_as(t) for t in ts)

    @staticmethod
    def backward(ctx, *grads):
        ctx.state.open()
        return (None, *grads)


class _Closes(torch.autograd.Function):
    """Identity on a layer's inputs; its backward closes the span."""

    @staticmethod
    def forward(ctx, state, *ts):
        ctx.state, state.closes = state, ctx
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(min(ts, key=lambda t: t.numel()))
        return tuple(t.view_as(t) for t in ts)

    @staticmethod
    def backward(ctx, *grads):
        ctx.state.close()
        return (None, *grads)


def _tracked(tree, out: list) -> list:
    """The tensors of ``tree`` (nested dicts, tuples and lists) that
    require grad, in order.  (With :func:`_replaced`, a third of the host
    time of ``torch.utils._pytree``'s flatten and unflatten, which a traced
    step would pay four times a layer call.)"""
    if isinstance(tree, torch.Tensor):
        if tree.requires_grad:
            out.append(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            _tracked(v, out)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            _tracked(v, out)
    return out


def _replaced(tree, new):
    """``tree`` with the tensors :func:`_tracked` lists taken from ``new``."""
    if isinstance(tree, torch.Tensor):
        return next(new) if tree.requires_grad else tree
    if isinstance(tree, dict):
        return {k: _replaced(v, new) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_replaced(v, new) for v in tree)
    return tree


def _through(node, state: _Span, tree):
    """``tree`` with its tensors that require grad passed through ``node``
    (``tree`` itself when it has none)."""
    ts = _tracked(tree, [])
    return _replaced(tree, iter(node.apply(state, *ts))) if ts else tree


def layer(name: str, fn: Callable, *args):
    """``fn(*args)``; while recording, inside the span ``name``, and its
    backward (from the gradient reaching its outputs to the gradient
    leaving every tensor of ``args``, weights included) inside
    ``name + ".bwd"``."""
    if not recording():
        return fn(*args)
    with torch.profiler.record_function(name):
        if not torch.is_grad_enabled():
            return fn(*args)
        state = _Span(name + ".bwd")
        traced = _through(_Closes, state, args)
        out = fn(*traced)
        return out if traced is args else _through(_Opens, state, out)


def forward_backward(fn: Callable, params, tensors, **kw):
    """``loss, metrics = fn(params)`` and ``torch.autograd.grad(loss,
    tensors, **kw)`` (``tensors``: the leaves of ``params``); returns (loss,
    metrics, grads).  While recording, the forward sits in the span
    ``step.forward`` and the backward in ``step.backward``, on the thread
    that runs it: an identity node on the loss opens that span, one on
    ``params`` closes it once every gradient has left them.  The calling
    thread's side of the backward (the engine's start, then the wait for
    the backward's thread) is the span ``step.backward.caller``."""
    if not recording():
        loss, metrics = fn(params)
        return loss, metrics, torch.autograd.grad(loss, tensors, **kw)
    state = _Span("step.backward")
    with torch.profiler.record_function("step.forward"):
        loss, metrics = fn(_through(_Closes, state, params))
    (loss,) = _Opens.apply(state, loss)
    with torch.profiler.record_function("step.backward.caller"):
        return loss, metrics, torch.autograd.grad(loss, tensors, **kw)


def recomputed(fn: Callable) -> Callable:
    """``fn`` for a non-reentrant ``checkpoint``: its run inside a backward
    (remat's recompute) sits in the span ``recompute`` when the forward it
    repeats was recorded, and builds the graph that forward built."""
    on = recording()

    def run(*args, **kwargs):
        if not _in_backward():
            return fn(*args, **kwargs)
        saved, _forced.on = _forced.on, on
        try:
            with span("recompute"):
                return fn(*args, **kwargs)
        finally:
            _forced.on = saved

    return run


# ------------------------------------------------------------- counters
_counters: Dict[str, Union[int, torch.Tensor]] = {}
_lock = threading.Lock()


def counting() -> bool:
    """Whether :func:`count` counts: recording, and not in a recompute."""
    return recording() and not _in_backward()


def count(values: Dict[str, Union[int, torch.Tensor]]) -> None:
    """Adds each value to its counter when :func:`counting`: a tensor to an
    int64 counter on its device (``add_``, no synchronisation), a Python
    int (a count the shapes give) on the host."""
    if not counting():
        return
    with _lock:
        for name, v in values.items():
            if isinstance(v, torch.Tensor):
                c = _counters.get(name)
                if c is None:
                    c = _counters[name] = torch.zeros((), dtype=torch.int64, device=v.device)
                c.add_(v)
            else:
                _counters[name] = _counters.get(name, 0) + v


def counters() -> Dict[str, int]:
    """Every counter's total since the last :func:`reset_counters`, the
    device's read with one synchronisation."""
    with _lock:
        out = dict(_counters)
    dev = {n: v for n, v in out.items() if isinstance(v, torch.Tensor)}
    if dev:
        first = next(iter(dev.values())).device
        out.update(zip(dev, torch.stack([v.to(first) for v in dev.values()]).tolist()))
    return dict(sorted(out.items()))


def reset_counters() -> None:
    with _lock:
        _counters.clear()
