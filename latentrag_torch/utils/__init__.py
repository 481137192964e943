from .config import (
    Config,
    apply_overrides,
    canonical_ae_type,
    load_config,
    parse_scalar,
    to_dict,
)
from .device import resolve_device
from .dotenv import load_dotenv
from .logging_utils import init_logger
from .prng import set_seed
from .timing import (
    StatsTracker,
    Stopwatch,
    device_stopwatch,
    force_completion,
    percentiles,
    stopwatch,
)

__all__ = [
    "Config",
    "apply_overrides",
    "canonical_ae_type",
    "load_config",
    "parse_scalar",
    "to_dict",
    "resolve_device",
    "load_dotenv",
    "init_logger",
    "set_seed",
    "StatsTracker",
    "Stopwatch",
    "device_stopwatch",
    "force_completion",
    "percentiles",
    "stopwatch",
]
