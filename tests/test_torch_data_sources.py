"""The port's outside data sources against the JAX package's, on the CPU:
the MS MARCO loaders over a local jsonl, the cloze pairs and the text
corpus reader, ``get_examples``'s ``msmarco:``, ``cloze:`` and generic
``<name>:<path>`` branches, and ``main`` over ``msmarco:<jsonl>`` against
the JAX pipeline on the same corpus and weights.

The loaders are plain Python over the same files: their outputs are held
equal, errors included. The pipeline is held as
``tests/test_torch_int8_store.py`` holds the msmarco config's: the same
doc ids, metrics within 1e-6, doc scores within 1e-5."""

import json
import os

import numpy as np
import pytest
import torch

from latentrag_tpu.data import msmarco as jmsmarco
from latentrag_tpu.data import squad as jsquad
from latentrag_tpu.data.tokenizer import resolve_tokenizer
from latentrag_tpu.models.encoder import SentenceEncoder as JaxEncoder
from latentrag_tpu.models.encoder import save_params
from latentrag_tpu.pipeline import PipelineRunner as JaxRunner
from latentrag_tpu.utils import apply_overrides as jax_overrides
from latentrag_tpu.utils import load_config as jax_load_config
from latentrag_torch import main as torch_main
from latentrag_torch.data import msmarco as tmsmarco
from latentrag_torch.data import squad as tsquad
from latentrag_torch.models import DenoisingAutoencoder
from latentrag_torch.models.convert import minilm_state_dict_from_jax
from latentrag_torch.utils import apply_overrides, load_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MSMARCO = os.path.join(ROOT, "configs", "msmarco_v5e8.yaml")
WORDS = ("telescope galaxy nebula cell protein river canyon market price "
         "orchestra symphony treaty empire vaccine immune processor").split()


def _passage(rng, lo=8, hi=20):
    return " ".join(rng.choice(WORDS, int(rng.integers(lo, hi))))


def write_msmarco(path, n_queries, n_passages=4, seed=0):
    """MS-MARCO-shaped records: every 7th query has no selected passage,
    and every 3rd repeats a passage of the query before it."""
    rng = np.random.default_rng(seed)
    prev = []
    with open(path, "w") as f:
        for i in range(n_queries):
            texts = [_passage(rng) for _ in range(n_passages)]
            if i % 3 == 2 and prev:
                texts[1] = prev[0]
            selected = [0] * n_passages
            if i % 7 != 6:
                selected[int(rng.integers(n_passages))] = 1
            query = " ".join(texts[0].split()[:5])
            f.write(json.dumps({"query": query, "passages": {
                "passage_text": texts, "is_selected": selected}}) + "\n")
            if i % 5 == 0:
                f.write("\n")  # blank lines are skipped
            prev = texts
    return str(path)


@pytest.fixture
def jsonl(tmp_path):
    return write_msmarco(tmp_path / "dev.jsonl", 40)


@pytest.mark.parametrize("max_queries", [None, 1, 12, 1000])
def test_msmarco_eval_matches_jax(jsonl, max_queries):
    got = tmsmarco.load_msmarco_eval(max_queries, source=jsonl)
    want = jmsmarco.load_msmarco_eval(max_queries, source=jsonl)
    assert got == want
    queries, corpus, relevant = got
    assert len(set(corpus)) == len(corpus)
    if max_queries is None:
        assert len(queries) == 40 - 40 // 7  # no selected passage: skipped


@pytest.mark.parametrize("max_passages", [None, 1, 7])
def test_msmarco_corpus_matches_jax(jsonl, max_passages):
    got = list(tmsmarco.load_msmarco_corpus(max_passages, source=jsonl))
    assert got == list(jmsmarco.load_msmarco_corpus(max_passages,
                                                    source=jsonl))


def test_msmarco_hub_form_refuses():
    with pytest.raises(ValueError, match="msmarco:<path>"):
        tmsmarco.load_msmarco_eval(10)


def _texts():
    rng = np.random.default_rng(4)
    docs = [_passage(rng, 3, 40) for _ in range(30)]
    docs[3] = "short text"
    return docs


@pytest.mark.parametrize("max_samples, snippet, seed",
                         [(None, 12, 0), (5, 12, 1), (None, 4, 7)])
def test_cloze_examples_match_jax(max_samples, snippet, seed):
    got = tsquad.cloze_examples(_texts(), max_samples, snippet, seed)
    assert got == jsquad.cloze_examples(_texts(), max_samples, snippet, seed)
    assert all(ex["question"] in ex["context"] for ex in got)


@pytest.mark.parametrize("name, body", [
    ("c.txt", "one doc here\n\n  two docs there  \n"),
    ("c.json", json.dumps(["a b", "c d", 3])),
    ("c.json", json.dumps({"texts": ["x y z"]})),
    ("bad.json", json.dumps({"docs": ["x"]})),
    ("bad.json", json.dumps("a string")),
])
def test_load_text_corpus_matches_jax(tmp_path, name, body):
    path = str(tmp_path / name)
    with open(path, "w") as f:
        f.write(body)
    if name.startswith("bad"):
        with pytest.raises(ValueError) as got:
            tsquad.load_text_corpus(path)
        with pytest.raises(ValueError) as want:
            jsquad.load_text_corpus(path)
        assert str(got.value) == str(want.value)
    else:
        assert tsquad.load_text_corpus(path) == jsquad.load_text_corpus(path)


def _squad_json(path):
    raw = {"data": [{"paragraphs": [
        {"context": f"context {i} about the telescope",
         "qas": [{"question": f"q{i}{j}?", "answers": (
             [{"text": "telescope", "answer_start": 14 + len(str(i))}]
             if j else [])} for j in range(3)]}
        for i in range(5)]}]}
    with open(path, "w") as f:
        json.dump(raw, f)
    return str(path)


def test_get_examples_branches_match_jax(tmp_path, jsonl):
    from latentrag_tpu.utils import Config as JaxConfig
    from latentrag_torch.utils import Config

    corpus = str(tmp_path / "corpus.json")
    with open(corpus, "w") as f:
        json.dump(_texts(), f)
    squad = _squad_json(tmp_path / "dev-v1.1.json")
    for ds, n in ((f"msmarco:{jsonl}", None), (f"msmarco:{jsonl}", 9),
                  (f"cloze:{corpus}", None), (f"cloze:{corpus}", 6),
                  (f"squad:{squad}", None), (f"mysquad:{squad}", 4)):
        ov = [f"data.dataset={ds}", f"data.max_samples={n or 'null'}"]
        got = tsquad.get_examples(apply_overrides(Config(), ov))
        want = jsquad.get_examples(jax_overrides(JaxConfig(), ov))
        assert got == want, ds
        assert got
    for hub in ("squad", "msmarco"):
        with pytest.raises(ValueError, match="network"):
            tsquad.get_examples(apply_overrides(
                Config(), [f"data.dataset={hub}"]))


def test_main_over_msmarco_matches_jax(tmp_path):
    """``main --config configs/msmarco_v5e8.yaml --ae_type dae --set
    data.dataset=msmarco:<jsonl>`` (the int8 store), cut to a small encoder
    and DAE: the port's corpus keeps every passage, distractors included,
    and retrieves the JAX pipeline's docs over it."""
    base = str(tmp_path)
    jsonl = write_msmarco(tmp_path / "dev.jsonl", 30, seed=2)
    ov = [
        f"data.dataset=msmarco:{jsonl}", "data.max_samples=24",
        f"paths.data_dir={base}/data", f"paths.checkpoints_dir={base}/ckpt",
        f"paths.logs_dir={base}/logs", f"retrieval.index_path={base}/index",
        f"logging.log_file={base}/logs/run.log",
        "encoder.vocab_size=800", "encoder.dtype=float32",
        "encoder.hidden_dim=32", "encoder.num_layers=1",
        "encoder.num_heads=4", "encoder.mlp_dim=64",
        "models.dae.input_dim=32", "models.dae.latent_dim=8",
        "models.dae.hidden_dim=16", f"models.dae.checkpoint={base}/dae.pth",
    ]
    queries, corpus, relevant = jmsmarco.load_msmarco_eval(24, source=jsonl)
    assert len(corpus) > len(set(relevant))  # distractors stay
    torch.manual_seed(6)
    torch.save(DenoisingAutoencoder(32, 8, 16).state_dict(), f"{base}/dae.pth")
    cfg_j = jax_overrides(jax_load_config(MSMARCO), ov)
    tok = resolve_tokenizer(cfg_j.paths.data_dir, 800, corpus)
    params = JaxEncoder(tok, cfg_j.encoder, seed=11).params
    save_params(params, f"{base}/ckpt/encoder.msgpack")
    torch.save(minilm_state_dict_from_jax(params), f"{base}/ckpt/encoder.pt")

    want = JaxRunner(cfg_j, ae_type="dae").process(queries, corpus, relevant)
    results = []
    rc = torch_main.main(
        ["--config", MSMARCO, "--ae_type", "dae", "--device", "cpu",
         "--set", *ov, f"encoder.weights_path={base}/ckpt/encoder.pt"],
        results=results,
    )
    assert rc == 0 and len(results) == 1
    got = results[0]
    assert got["n_corpus"] == want["n_corpus"] == len(corpus)
    assert got["n_queries"] == len(queries)
    assert got["retrieved_doc_ids"] == want["retrieved_doc_ids"]
    for name, stats in want["retrieval_metrics"].items():
        assert got["retrieval_metrics"][name]["mean"] == pytest.approx(
            stats["mean"], abs=1e-6)
    np.testing.assert_allclose(got["doc_scores"], want["doc_scores"],
                               atol=1e-5)
