"""Minimal ``.env`` loader, the JAX package's ``utils/dotenv.py``: the
generation providers' API keys without the python-dotenv dependency.
Lines: ``KEY=value``; ``#`` comments; existing env wins unless
``override``."""

from __future__ import annotations

import os


def load_dotenv(path: str = ".env", override: bool = False) -> dict[str, str]:
    loaded: dict[str, str] = {}
    if not os.path.exists(path):
        return loaded
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or "=" not in line:
                continue
            key, _, value = line.partition("=")
            key = key.strip()
            value = value.strip().strip("'\"")
            if override or key not in os.environ:
                os.environ[key] = value
            loaded[key] = value
    return loaded
