"""Named locks for the threaded serving plane.

The JAX package creates every lock that can nest with another through a
lock-order witness (`analysis/lockwitness.py make_lock`).  The port's
witness waits for ROADMAP Queue 1 item 5g with the rest of `analysis/`;
until then `make_lock` is a plain factory, and the name records the
lock's role ("serving.registry._swap_lock") where the witness will read
it.
"""
from __future__ import annotations

import threading


def make_lock(name: str) -> threading.Lock:
    """A new lock for the role `name` (dotted, stable across versions)."""
    del name
    return threading.Lock()
