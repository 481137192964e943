"""RAG answer generation against OpenAI-compatible chat APIs.

The port of the JAX package's ``generation/generator.py``: dataclass
settings, the system prompt loaded from a file, "Doc i:" prompt assembly,
character-budget context truncation (4 chars a token), sync and async
entry points, the API key from the environment, bounded retries of
transient failures. The client is injectable, so the pipeline and the
tests run without the ``openai`` package or a network; the ``extractive``
provider answers offline.
"""

from __future__ import annotations

import asyncio
import logging
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

log = logging.getLogger("latentrag_torch.main")

DEFAULT_SYSTEM_PROMPT = (
    "You are a careful question-answering assistant. Follow these steps: "
    "1) read the retrieved documents; 2) identify the passages relevant to "
    "the question; 3) extract the facts they state; 4) compose a concise "
    "answer strictly grounded in those facts; 5) if the documents do not "
    "contain the answer, say you cannot answer from the given context."
)


@dataclass(frozen=True)
class LLMSettings:
    provider: str = "openai"
    model: str = "gpt-4o-mini"
    temperature: float = 0.3
    max_tokens: int = 256


@dataclass(frozen=True)
class GeneratorSettings:
    llm: LLMSettings = field(default_factory=LLMSettings)
    system_prompt_path: str | None = None
    max_context_tokens: int = 2048
    chars_per_token: int = 4  # truncation heuristic (ref :154-170)
    max_retries: int = 3  # transient-failure retries with backoff


def load_system_prompt(path: str | None) -> str:
    if path and os.path.exists(path):
        with open(path, encoding="utf-8") as f:
            text = f.read().strip()
        if text:
            return text
    return DEFAULT_SYSTEM_PROMPT


class RAGGenerator:
    """Builds prompts from retrieved docs and calls a chat-completion API.

    ``client_fn(messages, settings) -> str`` may be injected; the default
    resolves the ``openai`` SDK + ``OPENAI_API_KEY`` lazily and raises a
    clear error when neither is available.
    """

    def __init__(
        self,
        settings: GeneratorSettings | None = None,
        client_fn: Callable[[list[dict], LLMSettings], str] | None = None,
    ):
        self.settings = settings or GeneratorSettings()
        self.system_prompt = load_system_prompt(
            self.settings.system_prompt_path
        )
        self._client_fn = client_fn

    # ------------------------------------------------------------- prompts

    def _truncate_docs(self, docs: Sequence[str]) -> list[str]:
        budget = (
            self.settings.max_context_tokens * self.settings.chars_per_token
        )
        out: list[str] = []
        used = 0
        for d in docs:
            if used >= budget:
                break
            remaining = budget - used
            if len(d) > remaining:
                d = d[:remaining]
            out.append(d)
            used += len(d)
        return out

    def build_prompt(self, query: str, docs: Sequence[str]) -> str:
        parts = [
            f"Doc {i + 1}: {doc}"
            for i, doc in enumerate(self._truncate_docs(docs))
        ]
        context = "\n\n".join(parts)
        return f"{context}\n\nQuestion: {query}\nAnswer:"

    def _messages(self, query: str, docs: Sequence[str]) -> list[dict]:
        return [
            {"role": "system", "content": self.system_prompt},
            {"role": "user", "content": self.build_prompt(query, docs)},
        ]

    # -------------------------------------------------------------- client

    def _default_client(self) -> Callable[[list[dict], LLMSettings], str]:
        try:
            from openai import OpenAI
        except ImportError as e:
            raise RuntimeError(
                "generation requires the `openai` package or an injected "
                "client_fn"
            ) from e
        api_key = os.environ.get("OPENAI_API_KEY")
        if not api_key:
            raise RuntimeError("OPENAI_API_KEY is not set")
        client = OpenAI(api_key=api_key)

        def call(messages: list[dict], llm: LLMSettings) -> str:
            resp = client.chat.completions.create(
                model=llm.model,
                messages=messages,
                temperature=llm.temperature,
                max_tokens=llm.max_tokens,
            )
            return resp.choices[0].message.content or ""

        return call

    # ------------------------------------------------------------ generate

    # exception-class-name markers of retryable transient failures; auth /
    # invalid-request / programming errors surface immediately
    _TRANSIENT_MARKERS = (
        "timeout", "connection", "ratelimit", "rate_limit", "unavailable",
        "internalserver", "apierror", "overloaded", "tryagain",
    )

    @classmethod
    def _is_transient(cls, e: Exception) -> bool:
        if isinstance(e, (TimeoutError, ConnectionError)):
            return True
        name = type(e).__name__.lower()
        return any(m in name for m in cls._TRANSIENT_MARKERS)

    def generate(self, query: str, retrieved_docs: Sequence[str]) -> str:
        """One completion, with bounded exponential-backoff retries on
        TRANSIENT client failures (rate limits, timeouts, 5xx) — a batch of
        hundreds of generations shouldn't die on one blip. Permanent
        failures (auth, invalid request) raise immediately.

        ``provider="extractive"`` answers locally and deterministically
        (best rarity-weighted-overlap sentence from the retrieved docs —
        ``generation.extractive``), so the full RAG loop incl. generation
        metrics runs offline; an injected ``client_fn`` always wins."""
        if (
            self._client_fn is None
            and self.settings.llm.provider == "extractive"
        ):
            from .extractive import extractive_answer

            return extractive_answer(
                query, self._truncate_docs(retrieved_docs)
            )
        if self._client_fn is None:
            self._client_fn = self._default_client()
        messages = self._messages(query, retrieved_docs)
        delay = 1.0
        for attempt in range(self.settings.max_retries + 1):
            try:
                return self._client_fn(messages, self.settings.llm)
            except Exception as e:
                if attempt >= self.settings.max_retries or not (
                    self._is_transient(e)
                ):
                    raise
                log.warning(
                    "generation attempt %d failed (%s: %s); retrying in "
                    "%.1fs", attempt + 1, type(e).__name__, e, delay,
                )
                time.sleep(delay)
                delay = min(delay * 2, 30.0)
        raise RuntimeError("unreachable")  # pragma: no cover

    async def generate_async(
        self, query: str, retrieved_docs: Sequence[str]
    ) -> str:
        return await asyncio.to_thread(self.generate, query, retrieved_docs)

    async def generate_batch_async(
        self,
        queries: Sequence[str],
        docs_per_query: Sequence[Sequence[str]],
        concurrency: int = 8,
    ) -> list[str]:
        sem = asyncio.Semaphore(concurrency)

        async def one(q: str, docs: Sequence[str]) -> str:
            async with sem:
                return await self.generate_async(q, docs)

        return list(
            await asyncio.gather(
                *(one(q, d) for q, d in zip(queries, docs_per_query))
            )
        )
