"""Logger setup: stdout + optional file handler, named channel loggers.

A copy of the JAX package's ``utils/logging_utils.py``; the channels are
named ``latentrag_torch.*``.

Parity with the reference's ``init_logger`` (``utils/load_config.py:13-33``):
root config with stdout and optional file handlers, level from config, and a
namespace of channel loggers (main/train/utils — extended here with retrieval
and eval channels).
"""

from __future__ import annotations

import logging
import os
import sys
from types import SimpleNamespace

from .config import LoggingConfig


def init_logger(
    cfg: LoggingConfig | None = None, *, stream=None
) -> SimpleNamespace:
    """Root logging setup (mirrors the reference's stdout+file handlers,
    ``utils/load_config.py:13-33``). ``stream`` overrides the console
    handler's target — line-protocol CLIs (serve.py) pass ``sys.stderr``
    so log lines never interleave with the JSONL payload on stdout."""
    cfg = cfg or LoggingConfig()
    level = getattr(logging, cfg.level.upper(), logging.INFO)
    handlers: list[logging.Handler] = [
        logging.StreamHandler(stream if stream is not None else sys.stdout)
    ]
    if cfg.log_to_file and cfg.log_file:
        os.makedirs(os.path.dirname(cfg.log_file) or ".", exist_ok=True)
        handlers.append(logging.FileHandler(cfg.log_file))
    logging.basicConfig(
        level=level,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
        handlers=handlers,
        force=True,
    )
    return SimpleNamespace(
        main=logging.getLogger("latentrag_torch.main"),
        train=logging.getLogger("latentrag_torch.train"),
        retrieval=logging.getLogger("latentrag_torch.retrieval"),
        eval=logging.getLogger("latentrag_torch.eval"),
        utils=logging.getLogger("latentrag_torch.utils"),
    )
