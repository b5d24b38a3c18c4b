"""Logging — counterpart of VQUtils Log (reference: Source/Engine/Main.cpp:192,
``Log::Initialize(console, file, path)`` and ``Log::Info/Warning/Error``).

Supports console and/or file sinks selected by the same CLI contract as the
reference (``-LogConsole`` / ``-LogFile=path``).
"""
from __future__ import annotations

import logging
import sys
import time

_LOGGER_NAME = "vqengine_tpu"
_t0 = time.perf_counter()


class _ElapsedFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        elapsed = time.perf_counter() - _t0
        level = record.levelname[0]  # I / W / E / D
        return f"[{elapsed:9.3f}s][{level}] {record.getMessage()}"


def get_logger() -> logging.Logger:
    return logging.getLogger(_LOGGER_NAME)


def initialize(console: bool = True, file: bool = False, file_path: str = "vqengine_tpu.log") -> None:
    logger = get_logger()
    logger.handlers.clear()
    logger.setLevel(logging.DEBUG)
    if console:
        h = logging.StreamHandler(sys.stdout)
        h.setFormatter(_ElapsedFormatter())
        logger.addHandler(h)
    if file:
        h = logging.FileHandler(file_path, mode="w")
        h.setFormatter(_ElapsedFormatter())
        logger.addHandler(h)
    if not logger.handlers:
        logger.addHandler(logging.NullHandler())


def info(msg: str, *args) -> None:
    get_logger().info(msg, *args)


def warning(msg: str, *args) -> None:
    get_logger().warning(msg, *args)


def error(msg: str, *args) -> None:
    get_logger().error(msg, *args)
