"""Opt-in runtime value checking (reference `_src/checkify.py:19-34`).

`optional_check(thunk)` is a no-op unless executing inside a
`do_checkify()` context, in which case `thunk` runs and may issue
`jax.experimental.checkify.check` assertions. Keeping checks off the
default path matters on an accelerator: checkify inserts error-state plumbing into
the compiled program.
"""

from contextlib import contextmanager

_CHECKIFY_STACK: list[bool] = []


def should_check() -> bool:
    return bool(_CHECKIFY_STACK) and _CHECKIFY_STACK[-1]


def optional_check(thunk) -> None:
    if should_check():
        thunk()


@contextmanager
def do_checkify():
    _CHECKIFY_STACK.append(True)
    try:
        yield
    finally:
        _CHECKIFY_STACK.pop()
