"""Leveled ANSI logging (a copy of ``sherman_tpu/utils/debug.py``, the
``include/Debug.h`` / ``src/Debug.cpp`` counterpart).

The reference exposes ``notifyInfo`` (green), ``notifyError`` (red) and a
compile-gated ``debugItem`` (yellow) (`Debug.h:15-38`, `Debug.cpp:57-83`).
Here the gate is a runtime level (env ``SHERMAN_LOG`` or :func:`set_level`)
instead of a macro: the same three entry points, the same colors.
"""

from __future__ import annotations

import os
import sys
import threading

ERROR, INFO, DEBUG = 0, 1, 2
_NAMES = {"error": ERROR, "info": INFO, "debug": DEBUG}

_level = _NAMES.get(os.environ.get("SHERMAN_LOG", "info").lower(), INFO)
_lock = threading.Lock()

_RED = "\x1b[31m"
_GREEN = "\x1b[32m"
_YELLOW = "\x1b[33m"
_RESET = "\x1b[0m"


def set_level(level: int | str) -> None:
    global _level
    _level = _NAMES[level.lower()] if isinstance(level, str) else int(level)


def _emit(color: str, msg: str, file) -> None:
    if not file.isatty():
        color, reset = "", ""
    else:
        reset = _RESET
    with _lock:
        print(f"{color}{msg}{reset}", file=file, flush=True)


def notify_info(fmt: str, *args) -> None:
    if _level >= INFO:
        _emit(_GREEN, fmt % args if args else fmt, sys.stdout)


def notify_error(fmt: str, *args) -> None:
    _emit(_RED, fmt % args if args else fmt, sys.stderr)


def debug_item(fmt: str, *args) -> None:
    if _level >= DEBUG:
        _emit(_YELLOW, fmt % args if args else fmt, sys.stdout)
