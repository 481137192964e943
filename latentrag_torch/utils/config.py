"""Typed configuration tree: YAML file -> frozen dataclasses -> CLI overrides.

The same dataclass tree, ``load_config`` and ``apply_overrides`` as the
JAX package's ``utils/config.py``, so one config file or ``--set`` list
means the same thing to both packages. Two differences, both so the port
runs where PyYAML is absent:

* ``yaml`` is imported only inside ``load_config`` when a path is given;
* ``--set`` scalars go through ``parse_scalar``, a stdlib parser with
  PyYAML's implicit typing of plain scalars (bool, null, int, float,
  quoted strings, flow lists). Sexagesimal numbers (``1:30``) and
  timestamps are left as strings.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import re
from dataclasses import dataclass, field, fields, replace
from typing import Any, Mapping, Sequence

log = logging.getLogger("latentrag_torch.utils")

CANONICAL_AE_TYPES = ("vae", "dae", "cae")
# Accept the reference's legacy spellings on input, normalise to canonical.
_AE_ALIASES = {
    "vae": "vae",
    "dae": "dae",
    "cae": "cae",
    "contrastive": "cae",
    "coe": "cae",
    "none": "none",
}


def canonical_ae_type(name: str) -> str:
    """Map any accepted AE spelling to the canonical one (or 'none')."""
    try:
        return _AE_ALIASES[name.strip().lower()]
    except KeyError:
        raise ValueError(
            f"unknown ae_type {name!r}; expected one of {sorted(_AE_ALIASES)}"
        ) from None


@dataclass(frozen=True)
class ProjectConfig:
    name: str = "latentrag-tpu"
    version: str = "0.1"


@dataclass(frozen=True)
class PathsConfig:
    data_dir: str = "./data/squad"
    checkpoints_dir: str = "./checkpoints"
    index_dir: str = "./data/index"
    logs_dir: str = "./logs"


@dataclass(frozen=True)
class EncoderConfig:
    """Sentence encoder (MiniLM-class BERT, mean-pool + L2 norm)."""

    name: str = "sentence-transformers/all-MiniLM-L6-v2"
    max_length: int = 256
    batch_size: int = 128
    # Architecture (all-MiniLM-L6-v2 geometry)
    vocab_size: int = 30522
    hidden_dim: int = 384
    num_layers: int = 6
    num_heads: int = 12
    mlp_dim: int = 1536
    max_position_embeddings: int = 512
    normalize: bool = True
    pooling: str = "mean"  # 'mean' (SBERT) | 'cls' (DPR)
    dtype: str = "bfloat16"  # activations; params + layernorm stay fp32
    # torch state_dict (.pt/.pth) of the port's MiniLMEncoder; "" => the
    # default path, and a seeded init when no file is there
    weights_path: str = ""
    # true asks for encoder.name from the HF hub, which the port never
    # reads: default_encoder then raises and names the local form
    hub_fallback: bool = False


@dataclass(frozen=True)
class AutoencoderConfig:
    input_dim: int = 384
    latent_dim: int = 64
    hidden_dim: int = 512
    dataset_file: str = ""
    checkpoint: str = ""


@dataclass(frozen=True)
class ModelsConfig:
    vae: AutoencoderConfig = field(
        default_factory=lambda: AutoencoderConfig(
            dataset_file="squad_vae_embeddings.npz", checkpoint="vae"
        )
    )
    dae: AutoencoderConfig = field(
        default_factory=lambda: AutoencoderConfig(
            dataset_file="squad_dae_embeddings.npz", checkpoint="dae"
        )
    )
    cae: AutoencoderConfig = field(
        default_factory=lambda: AutoencoderConfig(
            dataset_file="squad_cae_embeddings.npz", checkpoint="cae"
        )
    )

    def for_type(self, ae_type: str) -> AutoencoderConfig:
        ae_type = canonical_ae_type(ae_type)
        if ae_type == "none":
            raise ValueError("ae_type 'none' has no autoencoder config")
        return getattr(self, ae_type)


@dataclass(frozen=True)
class DataConfig:
    dataset: str = "squad"
    version: str = "v1"
    max_samples: int | None = 2000
    include_unanswerable: bool = False
    val_split: float = 0.1
    dae_noise_std: float = 0.05
    negative_jaccard_max: float = 0.1


@dataclass(frozen=True)
class TrainingConfig:
    batch_size: int = 128
    epochs: int = 50
    learning_rate: float = 1e-3
    weight_decay: float = 0.0
    grad_clip_norm: float = 0.0  # 0 => disabled
    seed: int = 42
    deterministic: bool = False
    early_stop_patience: int = 5
    early_stop_min_delta: float = 1e-4
    early_stop_relative: bool = False  # CAE uses relative min_delta (0.003)
    lr_plateau_factor: float = 0.0  # 0 => no ReduceLROnPlateau-style schedule
    lr_plateau_patience: int = 2
    # KL weight for VAE; triplet margin for CAE
    beta: float = 1e-3
    triplet_margin: float = 0.2
    mine_hard_negatives: bool = True
    # Data parallelism: shard the batch over this many devices (0 => all)
    dp_devices: int = 0


@dataclass(frozen=True)
class RetrievalConfig:
    backend: str = "dense"  # 'dense' | 'bruteforce' | 'bm25' | 'hnsw' | 'ivfpq'
    # dense scoring backend: 'auto' | 'xla' | 'xla_exact' | 'pallas' |
    # 'pallas_exact' (the JAX package's names; in the port 'pallas*' are the
    # hand-written CUDA fused top-k kernels)
    kernel: str = "auto"
    metric: str = "cosine"  # 'cosine' | 'euclidean' | 'mahalanobis'
    index_path: str = "./data/index/latent_index"
    top_k: int = 10
    max_chunks_per_doc: int = 3
    normalize: bool = True
    block_size: int = 1048576  # corpus block for streamed scoring
    # device dtype of the prepared corpus: bfloat16 | float32 | int8 (SQ8
    # codes) | int4 (packed nibbles, SQ8 rescore on the host) | binary
    # (packed sign bits, SQ8 rescore on the host)
    store_dtype: str = "bfloat16"
    binary_oversample: int = 8  # cascade stage-1 candidates per k
    # per-block candidate recall of the approximate search; "auto" is
    # 0.95 when k >= 64 (re-rank oversampling), 0.99 otherwise
    recall_target: float | str = "auto"
    shard_corpus: bool = False  # shard corpus rows over the mesh data axis
    # the second stage: 'none' | 'cross' (the cross-encoder reranker)
    rerank: str = "none"
    rerank_candidates: int = 0  # stage-1 fetch width; 0 = 4 * top_k
    hnsw_m: int = 32
    hnsw_ef_construction: int = 200
    hnsw_ef_search: int = 64
    hnsw_build: str = "auto"
    hnsw_knn_k: int = 0  # candidates/row for the knn build; 0 = 2*hnsw_m
    ivfpq_nlist: int = 4096
    ivfpq_m: int = 16
    ivfpq_nbits: int = 8
    ivfpq_build: str = "auto"
    ivfpq_train_iters: int = 15
    ivfpq_nprobe: int = 0
    ivfpq_refine: int = 4
    ivf_nlist: int = 0
    ivf_cap: int = 512  # rows per IVF block (the fixed-shape gather unit)
    ivf_nprobe: int = 0
    ivf_query_limit: int = 64  # batches above this Q stay exhaustive
    ivf_selfcheck: int = 64


@dataclass(frozen=True)
class GenerationConfig:
    provider: str = "openai"
    model: str = "gpt-4o-mini"
    temperature: float = 0.3
    max_tokens: int = 256
    max_context_tokens: int = 2048
    system_prompt_path: str = "./configs/prompts/system_prompt.txt"
    # in-flight completion requests for the batched pipeline path; 1 falls
    # back to a strictly sequential loop
    concurrency: int = 8


@dataclass(frozen=True)
class ChunkingConfig:
    enabled: bool = False
    mode: str = "semantic"  # 'sliding' | 'semantic'
    max_tokens: int = 128
    stride: int = 64
    min_tokens: int = 48
    tokenizer_name: str = "sentence-transformers/all-MiniLM-L6-v2"
    index_out: str = "./data/squad/chunk_index_infer.parquet"
    store_chunk_text: bool = True


@dataclass(frozen=True)
class EvaluationConfig:
    retrieval_metrics: tuple[str, ...] = ("Recall@10", "MRR@10", "nDCG@10")
    generation_metrics: tuple[str, ...] = ("ROUGE-L", "BLEU")
    bootstrap_samples: int = 2000
    bootstrap_alpha: float = 0.05
    min_pairs_for_bootstrap: int = 100


@dataclass(frozen=True)
class LoggingConfig:
    level: str = "INFO"
    log_to_file: bool = True
    log_file: str = "./logs/run.log"


@dataclass(frozen=True)
class Config:
    project: ProjectConfig = field(default_factory=ProjectConfig)
    paths: PathsConfig = field(default_factory=PathsConfig)
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    models: ModelsConfig = field(default_factory=ModelsConfig)
    data: DataConfig = field(default_factory=DataConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    retrieval: RetrievalConfig = field(default_factory=RetrievalConfig)
    generation: GenerationConfig = field(default_factory=GenerationConfig)
    chunking: ChunkingConfig = field(default_factory=ChunkingConfig)
    evaluation: EvaluationConfig = field(default_factory=EvaluationConfig)
    logging: LoggingConfig = field(default_factory=LoggingConfig)


_SECTION_ALIASES = {"embedding_model": "encoder"}
_FIELD_ALIASES = {
    ("encoder", "name"): "name",
    ("encoder", "max_length"): "max_length",
    ("models", "contrastive"): "cae",
}


def _coerce(value: Any, target_type: Any) -> Any:
    """Best-effort coercion of YAML/CLI scalars to the dataclass field type."""
    if value is None:
        return None
    if target_type in (int, "int"):
        return int(value)
    if target_type in (float, "float"):
        return float(value)
    if target_type in (bool, "bool"):
        if isinstance(value, bool):
            return value
        return str(value).strip().lower() in ("1", "true", "yes", "on")
    if target_type in (str, "str"):
        return str(value)
    return value


def _build_dataclass(cls: type, data: Mapping[str, Any], path: str = "") -> Any:
    kwargs: dict[str, Any] = {}
    known = {f.name: f for f in fields(cls)}
    for key, value in data.items():
        name = _FIELD_ALIASES.get((path, key), key)
        if name not in known:
            log.debug("config: ignoring unknown key %s.%s", path or "<root>", key)
            continue
        f = known[name]
        if dataclasses.is_dataclass(f.type) and isinstance(value, Mapping):
            kwargs[name] = _build_dataclass(f.type, value, f"{path}.{name}".strip("."))
        elif isinstance(value, Mapping) and dataclasses.is_dataclass(
            _resolve_field_dataclass(cls, name)
        ):
            kwargs[name] = _build_dataclass(
                _resolve_field_dataclass(cls, name), value, f"{path}.{name}".strip(".")
            )
        elif isinstance(value, list):
            kwargs[name] = tuple(value)
        else:
            kwargs[name] = value
    return cls(**kwargs)


def _resolve_field_dataclass(cls: type, name: str) -> Any:
    """Resolve the dataclass type of a field even under string annotations."""
    import typing

    hints = typing.get_type_hints(cls)
    t = hints.get(name)
    if t is not None and dataclasses.is_dataclass(t):
        return t
    return object


def load_config(path: str | os.PathLike | None = None) -> Config:
    """Load a YAML config file into the typed ``Config`` tree.

    Missing file or ``None`` => all defaults. Unknown keys are ignored with a
    debug log. Section name ``embedding_model`` (reference spelling) maps to
    ``encoder``; AE section ``contrastive`` maps to ``cae``.
    """
    if path is None:
        return Config()
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    data: dict[str, Any] = {}
    for key, value in raw.items():
        data[_SECTION_ALIASES.get(key, key)] = value
    return _build_dataclass(Config, data)



_BOOL_RE = re.compile(
    r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
    r"|on|On|ON|off|Off|OFF)$"
)
_NULL_RE = re.compile(r"^(?:~|null|Null|NULL|)$")
_INT_RE = re.compile(
    r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
    r"|[-+]?0x[0-9a-fA-F_]+)$"
)
_FLOAT_RE = re.compile(
    r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$"
)


def _parse_int(s: str) -> int:
    s = s.replace("_", "")
    sign = -1 if s.startswith("-") else 1
    body = s.lstrip("+-")
    if body.startswith("0b"):
        return sign * int(body[2:], 2)
    if body.startswith("0x"):
        return sign * int(body[2:], 16)
    if len(body) > 1 and body.startswith("0"):
        return sign * int(body, 8)
    return sign * int(body)


def _parse_plain(s: str) -> Any:
    if _BOOL_RE.match(s):
        return s.lower() in ("yes", "true", "on")
    if _NULL_RE.match(s):
        return None
    if _INT_RE.match(s):
        return _parse_int(s)
    if _FLOAT_RE.match(s):
        low = s.lower()
        if low.endswith(".inf"):
            return float("-inf") if low.startswith("-") else float("inf")
        if low == ".nan":
            return float("nan")
        return float(s.replace("_", ""))
    return s


def parse_scalar(raw: str) -> Any:
    """One ``--set`` value typed as ``yaml.safe_load`` types it: a quoted
    string stays a string, ``[a, b]`` is a list, a plain scalar follows
    PyYAML's implicit resolvers."""
    s = raw.strip()
    if len(s) >= 2 and s[0] == s[-1] and s[0] in "'\"":
        return s[1:-1]
    if s.startswith("[") and s.endswith("]"):
        inner = s[1:-1].strip()
        return [parse_scalar(p) for p in inner.split(",")] if inner else []
    return _parse_plain(s)

def apply_overrides(cfg: Config, overrides: Sequence[str]) -> Config:
    """Apply ``section.field=value`` dotted overrides onto a Config tree.

    Example: ``apply_overrides(cfg, ["training.epochs=3", "retrieval.top_k=5"])``.
    """
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"override {item!r} must look like a.b=value")
        dotted, raw_value = item.split("=", 1)
        parts = dotted.strip().split(".")
        cfg = _replace_path(cfg, parts, raw_value)
    return cfg


def _replace_path(node: Any, parts: Sequence[str], raw_value: str) -> Any:
    name = parts[0]
    known = {f.name: f for f in fields(node)}
    if name not in known:
        raise ValueError(f"unknown config field {name!r} on {type(node).__name__}")
    current = getattr(node, name)
    if len(parts) == 1:
        value = parse_scalar(raw_value)
        if isinstance(value, list):
            value = tuple(value)
        elif isinstance(current, (list, tuple)) and isinstance(value, str):
            # tuple-typed field set from the CLI: a.b=X,Y,Z
            value = tuple(v.strip() for v in value.split(",") if v.strip())
        elif current is not None and not isinstance(current, (list, tuple)):
            value = _coerce(value, type(current))
        return replace(node, **{name: value})
    return replace(node, **{name: _replace_path(current, parts[1:], raw_value)})


def to_dict(cfg: Any) -> dict:
    """Config tree -> plain nested dict (for fingerprints / CSV / logging)."""
    return dataclasses.asdict(cfg)
