"""Generation in the port (``latentrag_torch.generation``,
``evaluation.generation_metrics``) against the JAX package's: the same
strings, prompts, retries and metrics on the same inputs."""

import asyncio

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import latentrag_torch.evaluation.generation_metrics as tgm
import latentrag_torch.generation.generator as tgen
import latentrag_tpu.evaluation.generation_metrics as jgm
import latentrag_tpu.generation.generator as jgen
from latentrag_torch.generation import extractive as text
from latentrag_tpu.generation import extractive as jext

# the JAX tests' cases (tests/test_extractive.py) and edge cases
EXTRACTIVE_CASES = [
    ("what produces energy inside cells?",
     ["The market closed early. Mitochondria produce energy inside cells. "
      "Weather was mild.",
      "Telescopes observe distant galaxies. Cells divide rapidly."], 1),
    ("the quasar radiation",
     ["The the the the answer. Quasar jets emit the synchrotron "
      "radiation."], 1),
    ("q", [], 2),
    ("", ["Only sentence here."], 2),
    ("zz", ["Alpha beta. Gamma delta."], 2),
    ("where do aqueducts come from?",
     ["Ancient rome built aqueducts. Unrelated filler text."], 2),
    ("cells galaxies telescopes",
     ["Cells divide! Telescopes observe galaxies? Cells, cells.",
      "No end punctuation here", "   ", "Galaxies. Cells."], 3),
]

WORDS = ["cells", "galaxies", "the", "Quasar", "energy", "a", "of",
         "Telescopes", "rome", "x1", "42", "ünïcode"]
sentence = st.lists(st.sampled_from(WORDS), min_size=0, max_size=8).map(
    " ".join)
doc = st.lists(st.tuples(sentence, st.sampled_from([". ", "! ", "? ", " ",
                                                    ".\n"])),
               max_size=5).map(lambda parts: "".join(s + p for s, p in parts))


@pytest.mark.parametrize("case", range(len(EXTRACTIVE_CASES)))
def test_extractive_answer_matches_jax(case):
    query, docs, max_sentences = EXTRACTIVE_CASES[case]
    for d in docs:
        assert text.split_sentences(d) == jext.split_sentences(d)
    got = text.extractive_answer(query, docs, max_sentences=max_sentences)
    assert got == jext.extractive_answer(query, docs,
                                         max_sentences=max_sentences)


@settings(max_examples=150, deadline=None)
@given(query=sentence, docs=st.lists(doc, max_size=6),
       max_sentences=st.integers(1, 3))
def test_extractive_answer_matches_jax_on_random_texts(query, docs,
                                                       max_sentences):
    for d in docs:
        assert text.split_sentences(d) == jext.split_sentences(d)
    assert text.extractive_answer(query, docs, max_sentences) == (
        jext.extractive_answer(query, docs, max_sentences))


def _pair(settings_kw=None, fail_first=0, error=TimeoutError):
    """The same RAGGenerator in both packages with a recording client
    that raises ``error`` on its first ``fail_first`` calls."""
    out = []
    for mod in (tgen, jgen):
        calls = []

        def client(messages, llm, calls=calls):
            calls.append((messages, llm))
            if len(calls) <= fail_first:
                raise error("transient")
            return f"answer#{len(calls)}:{messages[1]['content'][-40:]}"

        kw = dict(settings_kw or {})
        if "llm" in kw:
            kw["llm"] = mod.LLMSettings(**kw["llm"])
        gen = mod.RAGGenerator(mod.GeneratorSettings(**kw), client_fn=client)
        out.append((gen, calls))
    return out


@pytest.mark.parametrize("settings_kw", [
    {},
    {"max_context_tokens": 10, "chars_per_token": 4},
    {"max_context_tokens": 13, "chars_per_token": 3,
     "llm": {"model": "m", "temperature": 0.9, "max_tokens": 7}},
])
def test_prompts_and_truncation_match_jax(settings_kw):
    docs = ["x" * 100, "y" * 25, "first doc", "second doc"]
    (t, tcalls), (j, jcalls) = _pair(settings_kw)
    assert t._truncate_docs(docs) == j._truncate_docs(docs)
    assert t.build_prompt("why?", docs) == j.build_prompt("why?", docs)
    assert t.generate("why?", docs) == j.generate("why?", docs)
    (tm, tllm), (jm, jllm) = tcalls[0], jcalls[0]
    assert tm == jm
    assert (tllm.provider, tllm.model, tllm.temperature, tllm.max_tokens) \
        == (jllm.provider, jllm.model, jllm.temperature, jllm.max_tokens)


def test_system_prompt_file_matches_jax(tmp_path):
    p = tmp_path / "sp.txt"
    p.write_text("  CUSTOM PROMPT\n")
    blank = tmp_path / "blank.txt"
    blank.write_text("\n  \n")
    for path in (str(p), str(blank), str(tmp_path / "missing.txt"), None):
        assert tgen.load_system_prompt(path) == jgen.load_system_prompt(path)
    assert tgen.DEFAULT_SYSTEM_PROMPT == jgen.DEFAULT_SYSTEM_PROMPT
    t = tgen.RAGGenerator(tgen.GeneratorSettings(system_prompt_path=str(p)))
    j = jgen.RAGGenerator(jgen.GeneratorSettings(system_prompt_path=str(p)))
    assert t._messages("q", ["d"]) == j._messages("q", ["d"])


@pytest.mark.parametrize("max_retries,fail_first,error", [
    (3, 2, TimeoutError),  # recovers on the third call
    (1, 2, TimeoutError),  # gives up after one retry
    (3, 1, ConnectionError),
    (3, 5, type("RateLimitError", (Exception,), {})),  # by class name
    (3, 1, type("AuthenticationError", (Exception,), {})),  # not retried
])
def test_retries_match_jax(monkeypatch, max_retries, fail_first, error):
    for mod in (tgen, jgen):
        monkeypatch.setattr(mod.time, "sleep", lambda s: None)
    outcomes = []
    for gen, calls in _pair({"max_retries": max_retries}, fail_first, error):
        try:
            result = gen.generate("q", ["doc"])
        except Exception as e:  # noqa: BLE001 - compared across packages
            result = type(e)
        outcomes.append((result, len(calls)))
    assert outcomes[0] == outcomes[1]


def test_batch_async_order_matches_jax():
    queries = [f"q{i}" for i in range(11)]
    docs = [[f"doc {i}", "other"] for i in range(11)]
    answers = []
    for gen, _ in _pair():
        answers.append(asyncio.run(
            gen.generate_batch_async(queries, docs, concurrency=3)))
    assert answers[0] == answers[1]
    # each answer is its own query's, in query order
    assert all(f"Question: q{i}" in a for i, a in enumerate(answers[0]))


def test_extractive_provider_matches_jax():
    """``provider="extractive"`` answers offline over the truncated docs;
    an injected client still wins."""
    docs = ["Ancient rome built aqueducts. Unrelated filler text.",
            "Aqueducts carried water. " * 30]
    ans = []
    for mod in (tgen, jgen):
        st_ = mod.GeneratorSettings(llm=mod.LLMSettings(provider="extractive"),
                                    max_context_tokens=20)
        gen = mod.RAGGenerator(st_)
        ans.append((gen.generate("where do aqueducts come from?", docs),
                    asyncio.run(gen.generate_batch_async(
                        ["galaxies?", "cells?"],
                        [["Telescopes observe galaxies."],
                         ["Cells divide rapidly."]])),
                    mod.RAGGenerator(st_, client_fn=lambda m, l: "injected")
                    .generate("q", docs)))
    assert ans[0] == ans[1]
    assert ans[0][2] == "injected"


def test_missing_openai_raises_as_jax():
    errors = []
    for mod in (tgen, jgen):
        with pytest.raises(RuntimeError) as e:
            mod.RAGGenerator().generate("q", ["d"])
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def _texts(rng, n):
    vocab = ["the", "cat", "sat", "on", "mat", "dog", "ran", "far", "away",
             "quasar", "jets", "emit", "light", "."]
    return [" ".join(rng.choice(vocab, size=rng.integers(1, 12)))
            for _ in range(n)]


@pytest.mark.parametrize("seed", [0, 1])
def test_generation_metrics_match_jax(seed):
    rng = np.random.default_rng(seed)
    hyp, ref = _texts(rng, 120), _texts(rng, 120)
    assert tgm.corpus_bleu(hyp, ref) == jgm.corpus_bleu(hyp, ref)
    np.testing.assert_array_equal(tgm.rouge_l_scores(hyp, ref),
                                  jgm.rouge_l_scores(hyp, ref))
    assert tgm.mean_rouge_l(hyp, ref) == jgm.mean_rouge_l(hyp, ref)
    np.testing.assert_array_equal(tgm.meteor_scores(hyp, ref),
                                  jgm.meteor_scores(hyp, ref))
    for h, r in zip(hyp[:20], ref[:20]):
        assert tgm.meteor_score(h, r) == jgm.meteor_score(h, r)
    v = rng.standard_normal(80)
    assert tgm.bootstrap_ci(v, 500, 0.1, seed) == jgm.bootstrap_ci(
        v, 500, 0.1, seed)
    kw = dict(metrics=("ROUGE-L", "BLEU", "METEOR"), n_resamples=300,
              alpha=0.05, min_pairs=100, seed=seed)
    assert tgm.evaluate_generation_bootstrap(hyp, ref, **kw) == (
        jgm.evaluate_generation_bootstrap(hyp, ref, **kw))
    a, b = rng.standard_normal(60), rng.standard_normal(60) + 0.2
    assert tgm.paired_bootstrap_test(a, b, 2000, seed) == (
        jgm.paired_bootstrap_test(a, b, 2000, seed))
    assert tgm.paired_bootstrap_test(b, a, 2000, seed) == (
        jgm.paired_bootstrap_test(b, a, 2000, seed))


@pytest.mark.parametrize("call", [
    lambda m: m.evaluate_generation_bootstrap(["a"], ["a", "b"]),
    lambda m: m.evaluate_generation_bootstrap(["a"] * 3, ["a"] * 3,
                                              min_pairs=4),
    lambda m: m.evaluate_generation_bootstrap(["a"] * 3, ["a"] * 3,
                                              metrics=("CIDEr",), min_pairs=1),
    lambda m: m.paired_bootstrap_test(np.zeros(3), np.zeros(4)),
])
def test_metric_errors_match_jax(call):
    errors = []
    for mod in (tgm, jgm):
        with pytest.raises(ValueError) as e:
            call(mod)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("flag,call", [
    ("_HAVE_SACREBLEU", lambda m: m.corpus_bleu(["a b"], ["a b"])),
    ("_HAVE_ROUGE", lambda m: m.rouge_l_scores(["a b"], ["a b"])),
    ("_HAVE_ROUGE", lambda m: m.mean_rouge_l(["a b"], ["a b"])),
    ("_HAVE_SACREBLEU", lambda m: m.evaluate_generation_bootstrap(
        ["a b"], ["a b"], metrics=("BLEU",), min_pairs=1)),
])
def test_missing_metric_packages_raise_as_jax(monkeypatch, flag, call):
    """Without sacrebleu or rouge-score (the card machine has neither),
    the metrics that need them raise the JAX package's RuntimeError; METEOR
    still scores."""
    errors = []
    for mod in (tgm, jgm):
        monkeypatch.setattr(mod, flag, False)
        with pytest.raises(RuntimeError) as e:
            call(mod)
        errors.append(str(e.value))
        assert mod.evaluate_generation_bootstrap(
            ["a b"], ["a b"], metrics=("METEOR",), min_pairs=1,
            n_resamples=10)["METEOR"]["mean"] == mod.meteor_score("a b",
                                                                 "a b")
    assert errors[0] == errors[1]
