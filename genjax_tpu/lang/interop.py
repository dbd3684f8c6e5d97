"""The addressing intrinsic (`dist(args) @ "addr"`) and its handler stack.

Accelerator-first design (replaces reference `_src/generative_functions/static.py`'s
`trace_p` initial-style primitive + jaxpr interpreters,
`static.py:156-258`):

The reference embeds a custom `trace_p` primitive into a staged jaxpr and
re-walks that jaxpr with a Python interpreter for every GFI method. Here,
`@ "addr"` instead dispatches to a *dynamically-scoped handler* at Python
trace time. Each GFI method of the `@gen` language runs the model's source
directly under `jit` tracing with the appropriate handler installed, so:

* the staged XLA program is identical to what a hand-written JAX program
  would produce (no primitive interception, no eqn-by-eqn walking);
* trace-time cost is one plain Python execution per `jit` specialization;
* addresses must be static Python strings (checked here), which is the
  same restriction the reference enforces.
"""

import threading
from typing import Any

_STATE = threading.local()


def _stack() -> list:
    if not hasattr(_STATE, "stack"):
        _STATE.stack = []
    return _STATE.stack


class TraceHandler:
    """Interface for handlers that interpret `trace(addr, gen_fn, args)`
    calls made inside a generative program's source."""

    def handle_trace(self, addr, gen_fn, args) -> Any:
        raise NotImplementedError


def push_handler(handler: TraceHandler) -> None:
    _stack().append(handler)


def pop_handler() -> TraceHandler:
    return _stack().pop()


class handler_context:
    def __init__(self, handler: TraceHandler):
        self.handler = handler

    def __enter__(self):
        push_handler(self.handler)
        return self.handler

    def __exit__(self, *exc):
        pop_handler()
        return False


def static_check_address(addr) -> None:
    components = addr if isinstance(addr, tuple) else (addr,)
    for comp in components:
        if not isinstance(comp, str):
            raise TypeError(
                f"Addresses in the @gen language must be static strings (or "
                f"tuples of strings); got {comp!r} of type {type(comp)}. "
                "Dynamic addressing is supported via choice map Indexed "
                "nodes and the vmap/scan combinators."
            )


def trace(addr, gen_fn, args) -> Any:
    """Invoke a generative function at an address, binding its generative
    semantics with the innermost enclosing generative context.

    Outside any generative context, this performs the zero-FLOP abstract
    call (shape-correct placeholder values), matching the reference's
    behavior for un-handled `trace_p` binds.
    """
    static_check_address(addr)
    stack = _stack()
    if not stack:
        return gen_fn.__abstract_call__(*args)
    return stack[-1].handle_trace(addr, gen_fn, args)
