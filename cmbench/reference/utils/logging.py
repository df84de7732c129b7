"""Leveled singleton logger.

Equivalent of the reference's util-logger submodule (``src/logger.h``,
usage at circminer.cpp:47-52, process_circ.cpp:26,325): a process-wide
singleton with INFO/ERROR/DEBUG channels, an optional prefix, optional
timestamps, and buffered writes.  Unlike the reference we default to
stderr (stdout carries SAM/PAM records when requested).
"""

from __future__ import annotations

import sys
import time
from typing import IO, Optional

_LEVELS = {"DEBUG": 10, "INFO": 20, "WARN": 30, "ERROR": 40}


class Logger:
    """``Logger.instance().info/error/debug`` - reference logger.h API."""

    _instance: Optional["Logger"] = None

    def __init__(self, stream: IO = None):
        self.stream = stream if stream is not None else sys.stderr
        self.prefix = ""
        self.show_time = True
        self.level = _LEVELS["INFO"]
        self._buf: list = []
        self._buffer_size = 0  # 0 = unbuffered

    @classmethod
    def instance(cls) -> "Logger":
        if cls._instance is None:
            cls._instance = Logger()
        return cls._instance

    # --- reference API (logger.h) ---
    def set_prefix(self, prefix: str) -> None:
        self.prefix = prefix

    def toggle_time(self, on: bool = None) -> None:
        self.show_time = (not self.show_time) if on is None else on

    def set_buffer_size(self, n: int) -> None:
        self._buffer_size = n

    def set_level(self, name: str) -> None:
        self.level = _LEVELS[name.upper()]

    # --- channels ---
    def _emit(self, level: str, msg: str, *args) -> None:
        if _LEVELS[level] < self.level:
            return
        if args:
            msg = msg % args
        ts = time.strftime("%H:%M:%S") + " " if self.show_time else ""
        line = f"{ts}[{level}]{self.prefix} {msg}\n"
        self._buf.append(line)
        if len(self._buf) >= max(1, self._buffer_size) or \
                self._buffer_size == 0:
            self.flush()

    def info(self, msg: str, *args) -> None:
        self._emit("INFO", msg, *args)

    def warn(self, msg: str, *args) -> None:
        self._emit("WARN", msg, *args)

    def error(self, msg: str, *args) -> None:
        self._emit("ERROR", msg, *args)

    def debug(self, msg: str, *args) -> None:
        self._emit("DEBUG", msg, *args)

    def flush(self) -> None:
        if self._buf:
            self.stream.write("".join(self._buf))
            self.stream.flush()
            self._buf.clear()

# --- per-read verbose trace channel (the reference's vafprintf,
# common.h:520-541: `make verbose` activates leveled per-read diagnostics;
# here the level comes from the -d/--verbosity CLI flag or the
# CIRCMINER_VERBOSE env var, no rebuild needed) ---------------------------

import os as _os

TRACE_LEVEL = int(_os.environ.get("CIRCMINER_VERBOSE", "0"))


def set_trace_level(level: int) -> None:
    global TRACE_LEVEL
    TRACE_LEVEL = int(level)


def vaf(verbosity: int, msg: str, *args) -> None:
    """vafprintf equivalent: emit when TRACE_LEVEL >= verbosity.

    Callers must guard hot paths with ``if TRACE_LEVEL >= v`` themselves to
    keep the disabled cost at one global read."""
    if TRACE_LEVEL >= verbosity:
        if args:
            msg = msg % args
        sys.stderr.write(msg + "\n")
