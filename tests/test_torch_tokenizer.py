"""The port's tokenizer, data loaders and config tree against the JAX
package's: identical ids, masks, offsets, vocabularies and configs."""

import dataclasses
import json

import numpy as np
import pytest

from latentrag_tpu.data import squad as jsquad
from latentrag_tpu.data import tokenizer as jtok
from latentrag_tpu.utils import config as jcfg
from latentrag_torch.data import squad as tsquad
from latentrag_torch.data import tokenizer as ttok
from latentrag_torch.utils import config as tcfg

CORPUS = [
    "Telescopes observe distant galaxies and nebulae.",
    "Mitochondria produce energy inside living cells!",
    "The treaty ended a long war between the two empires (1815).",
    "Résumé: naïve café owners in Zürich — 東京 tower, ﬁ ligature.",
    "Tabs\tand\nnewlines\r\nand  double  spaces; punctuation?!...",
    "supercalifragilisticexpialidocious " * 3,
    "",
]


@pytest.fixture(scope="module")
def tokenizers():
    j = jtok.WordPieceTokenizer.train_from_corpus(CORPUS * 2, vocab_size=300)
    t = ttok.WordPieceTokenizer.train_from_corpus(CORPUS * 2, vocab_size=300)
    return j, t


def test_trained_vocab_identical(tokenizers):
    j, t = tokenizers
    assert j.vocab == t.vocab


@pytest.mark.parametrize("max_length", [8, 32, 256])
def test_encode_batch_ids_and_masks_identical(tokenizers, max_length):
    j, t = tokenizers
    ids_j, mask_j = j.encode_batch(CORPUS, max_length=max_length)
    ids_t, mask_t = t.encode_batch(CORPUS, max_length=max_length)
    np.testing.assert_array_equal(ids_t, ids_j)
    np.testing.assert_array_equal(mask_t, mask_j)
    assert ids_t.dtype == np.int32 and mask_t.dtype == np.int32


def test_encode_offsets_identical(tokenizers):
    j, t = tokenizers
    for text in CORPUS:
        a, b = j.encode(text, max_length=20), t.encode(text, max_length=20)
        assert (a.ids, a.tokens, a.offsets) == (b.ids, b.tokens, b.offsets)


def test_resolve_tokenizer_reads_what_the_other_side_wrote(tmp_path):
    j = jtok.resolve_tokenizer(str(tmp_path), 300, CORPUS)
    t = ttok.resolve_tokenizer(str(tmp_path), 300, ["unrelated corpus"])
    assert j.vocab == t.vocab  # loaded tokenizer.json, not retrained
    (tmp_path / "vocab.txt").write_text("[PAD]\n[UNK]\n[CLS]\n[SEP]\nhi\n")
    assert ttok.resolve_tokenizer(str(tmp_path), 300).vocab["hi"] == 4


def test_synthetic_and_eval_triples_identical():
    ex_j, ex_t = jsquad.synthetic_examples(120), tsquad.synthetic_examples(120)
    assert ex_j == ex_t
    assert jsquad.load_evaluation_data(ex_j, with_answers=True) == \
        tsquad.load_evaluation_data(ex_t, with_answers=True)


def test_local_sources_identical(tmp_path):
    squad = {"data": [{"paragraphs": [
        {"context": "ctx one", "qas": [
            {"question": "q1", "answers": [{"text": "one", "answer_start": 4}]},
            {"question": "unanswerable", "answers": []},
        ]},
        {"context": "ctx two", "qas": [
            {"question": "q2", "answers": [{"text": "two", "answer_start": 4}]},
        ]},
    ]}]}
    p = tmp_path / "squad.json"
    p.write_text(json.dumps(squad))
    assert tsquad.load_local_squad(str(p)) == jsquad.load_local_squad(str(p))
    lines = [{"question": "a?", "context": "b"}, {"question": "c?",
              "context": "d", "doc_id": 9}]
    jl = tmp_path / "x.jsonl"
    jl.write_text("\n".join(json.dumps(x) for x in lines) + "\n\n")
    assert tsquad.load_jsonl_examples(str(jl)) == \
        jsquad.load_jsonl_examples(str(jl))
    cfg = tcfg.apply_overrides(tcfg.Config(), [f"data.dataset=squad:{p}"])
    assert len(tsquad.get_examples(cfg)) == 2


def test_hub_source_raises_without_network():
    cfg = tcfg.Config()  # data.dataset=squad is the hub source
    with pytest.raises(ValueError, match="network"):
        tsquad.get_examples(cfg)


@pytest.mark.parametrize("raw", [
    "3", "-7", "0x1F", "0o17", "017", "1_000", "2.5", "1e-3", "1.0e+3", ".5",
    "-.inf", ".NaN", "true", "False", "yes", "off", "on", "~", "null", "",
    "abc", "'quoted: yes'", '"3"', "[1, 2.5, x]", "[]", "a,b,c",
    "Recall@5,MRR@5", "./data/index", "cuda:0",
])
def test_parse_scalar_matches_yaml(raw):
    yaml = pytest.importorskip("yaml")
    want = yaml.safe_load(raw)
    got = tcfg.parse_scalar(raw)
    if isinstance(want, float) and np.isnan(want):
        assert np.isnan(got)
    else:
        assert got == want and type(got) is type(want)


OVERRIDES = [
    "training.epochs=3", "retrieval.top_k=5", "retrieval.recall_target=0.95",
    "retrieval.store_dtype=float32", "encoder.dtype=float32",
    "evaluation.retrieval_metrics=Recall@5,MRR@5", "data.max_samples=80",
    "chunking.enabled=yes", "training.learning_rate=1e-3",
    "models.vae.checkpoint=/tmp/vae.pth", "logging.log_to_file=false",
]


def test_apply_overrides_and_load_config_identical():
    j = jcfg.apply_overrides(jcfg.load_config("configs/default.yaml"), OVERRIDES)
    t = tcfg.apply_overrides(tcfg.load_config("configs/default.yaml"), OVERRIDES)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    with pytest.raises(ValueError):
        tcfg.apply_overrides(t, ["retrieval.nope=1"])
