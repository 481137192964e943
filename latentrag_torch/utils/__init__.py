from .config import (
    Config,
    apply_overrides,
    canonical_ae_type,
    load_config,
    parse_scalar,
)
from .device import resolve_device
from .logging_utils import init_logger
from .prng import set_seed
from .timing import StatsTracker, force_completion, percentiles

__all__ = [
    "Config",
    "apply_overrides",
    "canonical_ae_type",
    "load_config",
    "parse_scalar",
    "resolve_device",
    "init_logger",
    "set_seed",
    "StatsTracker",
    "force_completion",
    "percentiles",
]
