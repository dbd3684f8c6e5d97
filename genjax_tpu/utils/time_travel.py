"""Time-travel debugger: record checkpoints inside a pure computation and
navigate/modify them.

Capability parity with reference
`_src/core/compiler/interpreters/time_travel.py:42-295` (`rec`, `tag`,
`time_machine`, `TimeTravelingDebugger` with `fwd`/`bwd`/`jump`/`remix`).

Accelerator-first design: the reference captures continuation frames with a
hybrid-CPS jaxpr interpreter. Here checkpoints are recorded by a dynamic
handler at trace time (same mechanism as the `@gen` language) and `remix`
re-executes the program from the start with the chosen frame's value
substituted — functionally identical navigation semantics with no
interpreter machinery, at the cost of O(program) replay per remix (a
debugger-path cost, never on a hot path).
"""

import threading
from dataclasses import dataclass
from typing import Any, Callable

_STATE = threading.local()


def _stack() -> list:
    if not hasattr(_STATE, "stack"):
        _STATE.stack = []
    return _STATE.stack


class _Recorder:
    def __init__(self, overrides: dict | None = None):
        self.frames: list[tuple[str | None, Any]] = []
        self.overrides = overrides or {}

    def record(self, value, label):
        idx = len(self.frames)
        key = label if label is not None else idx
        if key in self.overrides:
            value = self.overrides[key]
        elif idx in self.overrides:
            value = self.overrides[idx]
        self.frames.append((label, value))
        return value


def rec(value: Any, label: str | None = None) -> Any:
    """Record a checkpoint. Returns `value` (possibly substituted when
    re-running under `remix`). Outside a `time_machine` run, identity."""
    stack = _stack()
    if not stack:
        return value
    return stack[-1].record(value, label)


def tag(value: Any, label: str) -> Any:
    """Labelled variant of `rec`."""
    return rec(value, label)


@dataclass
class TimeTravelingDebugger:
    """Navigator over the recorded frames of one execution."""

    fn: Callable[..., Any]
    args: tuple
    frames: list
    retval: Any
    cursor: int = 0

    @property
    def n_frames(self) -> int:
        return len(self.frames)

    def current(self):
        label, value = self.frames[self.cursor]
        return value

    def current_label(self):
        label, _ = self.frames[self.cursor]
        return label

    def fwd(self) -> "TimeTravelingDebugger":
        self.cursor = min(self.cursor + 1, self.n_frames - 1)
        return self

    def bwd(self) -> "TimeTravelingDebugger":
        self.cursor = max(self.cursor - 1, 0)
        return self

    def jump(self, where: int | str) -> "TimeTravelingDebugger":
        if isinstance(where, str):
            for i, (label, _) in enumerate(self.frames):
                if label == where:
                    self.cursor = i
                    return self
            raise KeyError(f"no frame labelled {where!r}")
        self.cursor = max(0, min(where, self.n_frames - 1))
        return self

    def remix(self, new_value: Any) -> "TimeTravelingDebugger":
        """Replace the value at the cursor and re-execute, producing a new
        debugger over the altered history."""
        label = self.current_label()
        key = label if label is not None else self.cursor
        return time_machine(self.fn, overrides={key: new_value})(*self.args)


def time_machine(
    fn: Callable[..., Any], *, overrides: dict | None = None
) -> Callable[..., TimeTravelingDebugger]:
    """Run `fn`, recording every `rec`/`tag` checkpoint; returns a
    `TimeTravelingDebugger` positioned at the first frame."""

    def runner(*args) -> TimeTravelingDebugger:
        recorder = _Recorder(overrides)
        _stack().append(recorder)
        try:
            retval = fn(*args)
        finally:
            _stack().pop()
        return TimeTravelingDebugger(fn, args, recorder.frames, retval)

    return runner
