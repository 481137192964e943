"""Answer generation: the extractive provider and the LLM client."""

from .extractive import extractive_answer, split_sentences
from .generator import (
    DEFAULT_SYSTEM_PROMPT,
    GeneratorSettings,
    LLMSettings,
    RAGGenerator,
    load_system_prompt,
)

__all__ = [
    "DEFAULT_SYSTEM_PROMPT",
    "GeneratorSettings",
    "LLMSettings",
    "RAGGenerator",
    "extractive_answer",
    "load_system_prompt",
    "split_sentences",
]
