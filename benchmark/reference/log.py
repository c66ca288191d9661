"""Leveled logging — the analogue of libavutil's av_log and the wrapper's
oh_set_log_level / oh_set_log_callback (reference: openhevc.c:766-774,
libavutil/log.c).  Levels keep av_log's numeric scale so CLI `-v N`
values mean the same thing as the reference's.

Frozen copy of ``hevc_tpu_torch/log.py`` at ee5ffe9.
"""
from __future__ import annotations

import sys
from typing import Callable, Optional

OH_LOG_PANIC = 0
OH_LOG_FATAL = 8
OH_LOG_ERROR = 16
OH_LOG_WARNING = 24
OH_LOG_INFO = 32
OH_LOG_VERBOSE = 40
OH_LOG_DEBUG = 48
OH_LOG_TRACE = 56

_NAMES = {0: "panic", 8: "fatal", 16: "error", 24: "warning",
          32: "info", 40: "verbose", 48: "debug", 56: "trace"}

_level = OH_LOG_INFO
_callback: Optional[Callable[[int, str], None]] = None


def set_log_level(level: int) -> None:
    global _level
    _level = level


def get_log_level() -> int:
    return _level


def set_log_callback(cb: Optional[Callable[[int, str], None]]) -> None:
    """cb(level, message); None restores the stderr default."""
    global _callback
    _callback = cb


def log(level: int, msg: str) -> None:
    if level > _level:
        return
    if _callback is not None:
        _callback(level, msg)
    else:
        print(f"[hevc_tpu @ {_NAMES.get(level, level)}] {msg}",
              file=sys.stderr)
