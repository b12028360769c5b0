"""Watch the calls of the port's kernel wrappers in place.

Inside ``with watching(fn):`` each kernel wrapper of this package
(``mamba.ops.ssd_scan``, ``attention.ops.flash_attention``) ends every call
with ``fn(name, inputs, output)``: ``name`` is the wrapper's name,
``inputs`` a dict of the arguments its kernel (or, on the CPU, its plain
version) read, ``output`` what that computed. If ``fn`` returns something
other than None, the wrapper returns that instead. The call happens where
the model calls the wrapper, so a model run inside the block shows ``fn``
every call on its path, each recomputation under activation checkpointing
included.

``chip_smoke.py`` holds each kernel launch of the model's path to the
kernel's plain version on the same inputs this way, and
``launch.scan_drift`` puts other scans in the kernel's place. Outside such a
block the wrappers call nothing. The launch counters stay where the kernels
launch (each ``ops.launches``), untouched by what a watcher returns.
"""
from __future__ import annotations

from collections.abc import Callable, Iterator
from contextlib import contextmanager

_watchers: list[Callable] = []


@contextmanager
def watching(fn: Callable) -> Iterator[None]:
    """Show ``fn`` every wrapper call made until the block ends."""
    _watchers.append(fn)
    try:
        yield
    finally:
        _watchers.remove(fn)


def called(name: str, inputs: dict, output):
    """Run by a wrapper at the end of each call; returns the output it is
    to return."""
    for fn in tuple(_watchers):
        replaced = fn(name, inputs, output)
        if replaced is not None:
            output = replaced
    return output
