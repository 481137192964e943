"""WordPiece tokenizer with character-offset mapping (host-side).

The reference leans on HF fast tokenizers (Rust) for offset-mapped WordPiece
(``utils/chunk_utils.py:114-121``); tokenization is a pre-TPU host stage
(SURVEY §2.4 item 4), so a self-contained implementation keeps the framework
dependency-free and offline-capable:

* loads a standard BERT ``vocab.txt`` when available (exact parity with the
  all-MiniLM-L6-v2 vocabulary);
* otherwise trains a frequency-based vocabulary from a corpus
  (whole words + suffix pieces + character fallback);
* `encode` returns token ids plus (start, end) char offsets per token —
  the contract the chunkers build on;
* full BERT BasicTokenizer semantics: lowercasing, NFD accent stripping,
  control-char removal, punctuation splitting, CJK isolation, greedy
  longest-match-first WordPiece with ``##`` continuation pieces, [CLS]/[SEP]
  framing, [UNK] fallback — with offsets tracked through normalization so
  they index the ORIGINAL text (differentially tested against
  ``BertTokenizerFast``, ``tests/test_tokenizer.py``).

The port's copy of the JAX package's ``data/tokenizer.py``: the same
vocabulary training, encoding and offsets, so ids and masks are identical.
As there, ASCII text takes the C++ WordPiece of ``native/`` (through
``data/native_tokenizer.py``), which gives the Python path's ids, masks
and offsets exactly, and rows with non-ASCII bytes take the Python path.
Unlike there, a failed build or load of the C++ library raises instead of
falling back: the Python path serves ASCII text only when the tokenizer is
made with ``native=False``, or when its vocab's ids are not dense (the C++
vocab needs ids 0..n-1). ``rows_served`` counts the rows each path
encoded.
"""

from __future__ import annotations

import collections
import ctypes
import json
import logging
import os
import unicodedata
from dataclasses import dataclass
from typing import Iterable, Sequence

log = logging.getLogger("latentrag_torch.data")

# rows encoded by the C++ path and by the Python path, in this process
rows_served = {"native": 0, "python": 0}


def reset_rows_served() -> None:
    for key in rows_served:
        rows_served[key] = 0

PAD, UNK, CLS, SEP, MASK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"
SPECIAL_TOKENS = (PAD, UNK, CLS, SEP, MASK)


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (
        33 <= cp <= 47
        or 58 <= cp <= 64
        or 91 <= cp <= 96
        or 123 <= cp <= 126
    ):
        return True
    return unicodedata.category(ch).startswith("P")


@dataclass
class Encoding:
    ids: list[int]
    tokens: list[str]
    offsets: list[tuple[int, int]]  # char spans into the ORIGINAL text


class WordPieceTokenizer:
    def __init__(
        self,
        vocab: dict[str, int],
        lowercase: bool = True,
        max_word_chars: int = 100,
        native: bool = True,
    ):
        self.native = native  # False: the Python path for every row
        self._wp_handle = None  # the C++ vocab; False: not dense
        self.vocab = vocab
        self.inv_vocab = {i: t for t, i in vocab.items()}
        self.lowercase = lowercase
        self.max_word_chars = max_word_chars
        for tok in (PAD, UNK, CLS, SEP):
            if tok not in vocab:
                raise ValueError(f"vocab missing special token {tok}")
        self.pad_id = vocab[PAD]
        self.unk_id = vocab[UNK]
        self.cls_id = vocab[CLS]
        self.sep_id = vocab[SEP]

    # ------------------------------------------------------------ factories

    @classmethod
    def from_vocab_file(cls, path: str, **kw) -> "WordPieceTokenizer":
        vocab: dict[str, int] = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                vocab[line.rstrip("\n")] = i
        return cls(vocab, **kw)

    @classmethod
    def train_from_corpus(
        cls,
        texts: Iterable[str],
        vocab_size: int = 30522,
        min_freq: int = 2,
        **kw,
    ) -> "WordPieceTokenizer":
        """Frequency-based vocabulary: all single characters (continuation
        pieces included) ensure no word is unencodable, then the most common
        whole words, then common suffix pieces."""
        word_counts: collections.Counter = collections.Counter()
        for text in texts:
            for w, _ in _pretokenize(text, lowercase=True):
                word_counts[w] += 1

        chars: set[str] = set()
        for w in word_counts:
            chars.update(w)

        vocab: dict[str, int] = {}
        for tok in SPECIAL_TOKENS:
            vocab[tok] = len(vocab)
        for ch in sorted(chars):
            for piece in (ch, "##" + ch):
                if piece not in vocab:
                    vocab[piece] = len(vocab)

        # common whole words
        for w, c in word_counts.most_common():
            if len(vocab) >= vocab_size:
                break
            if c >= min_freq and w not in vocab:
                vocab[w] = len(vocab)
        # common suffixes as continuation pieces
        if len(vocab) < vocab_size:
            suffix_counts: collections.Counter = collections.Counter()
            for w, c in word_counts.items():
                for ln in (2, 3, 4):
                    if len(w) > ln:
                        suffix_counts["##" + w[-ln:]] += c
            for s, c in suffix_counts.most_common():
                if len(vocab) >= vocab_size:
                    break
                if c >= min_freq and s not in vocab:
                    vocab[s] = len(vocab)
        return cls(vocab, **kw)

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            json.dump(
                {"vocab": self.vocab, "lowercase": self.lowercase}, f
            )

    @classmethod
    def load(cls, path: str) -> "WordPieceTokenizer":
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
        return cls(data["vocab"], lowercase=data.get("lowercase", True))

    # ------------------------------------------------------------- encoding

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def _wordpiece(self, word: str) -> list[str] | None:
        """Greedy longest-match-first; None if unencodable."""
        if len(word) > self.max_word_chars:
            return None
        pieces = []
        start = 0
        while start < len(word):
            end = len(word)
            piece = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    piece = sub
                    break
                end -= 1
            if piece is None:
                return None
            pieces.append(piece)
            start = end
        return pieces

    def encode(
        self,
        text: str,
        add_special_tokens: bool = True,
        max_length: int | None = None,
    ) -> Encoding:
        if text.isascii():
            h = self._native_handle()
            if h is not None:
                from .native_tokenizer import encode_offsets

                out = encode_offsets(h, text, add_special_tokens, max_length)
                if out is not None:
                    rows_served["native"] += 1
                    nids, starts, ends = out
                    id_list = nids.tolist()
                    return Encoding(
                        ids=id_list,
                        tokens=[self.inv_vocab.get(i, UNK) for i in id_list],
                        offsets=list(zip(starts.tolist(), ends.tolist())),
                    )
        rows_served["python"] += 1
        ids: list[int] = []
        tokens: list[str] = []
        offsets: list[tuple[int, int]] = []
        if add_special_tokens:
            ids.append(self.cls_id)
            tokens.append(CLS)
            offsets.append((0, 0))
        body_budget = (
            None
            if max_length is None
            else max_length - (2 if add_special_tokens else 0)
        )
        for word, idxs in _pretokenize(text, self.lowercase):
            w_start, w_end = idxs[0], idxs[-1] + 1
            pieces = self._wordpiece(word)
            if pieces is None:
                pieces = [UNK]
            if body_budget is not None and len(tokens) - (
                1 if add_special_tokens else 0
            ) + len(pieces) > body_budget:
                break
            pos = 0  # cursor into the NORMALIZED word
            for p in pieces:
                plen = len(p) - 2 if p.startswith("##") else len(p)
                if p == UNK:
                    span = (w_start, w_end)
                    pos = len(word)
                else:
                    last = min(pos + plen, len(word)) - 1
                    span = (idxs[pos], idxs[last] + 1)
                    pos += plen
                ids.append(self.vocab.get(p, self.unk_id))
                tokens.append(p)
                offsets.append(span)
        if add_special_tokens:
            end = len(text)
            ids.append(self.sep_id)
            tokens.append(SEP)
            offsets.append((end, end))
        return Encoding(ids=ids, tokens=tokens, offsets=offsets)

    def encode_batch(
        self,
        texts: Sequence[str],
        max_length: int = 256,
    ) -> tuple["np.ndarray", "np.ndarray"]:
        """Padded [B, L] (ids, attention_mask) int32 arrays for the encoder.

        ASCII rows go through the C++ WordPiece in one threaded call; rows
        with non-ASCII bytes, or every row without the C++ vocab, through
        ``encode``. Both give the same ids, trimmed to the longest row.
        """
        import numpy as np

        texts = list(texts)
        h = self._native_handle()
        if h is None or not texts:
            return self._encode_batch_py(texts, max_length)
        from .native_tokenizer import get_lib

        n = len(texts)
        data = [t.encode("utf-8") for t in texts]
        offs = np.zeros(n + 1, dtype=np.int64)
        np.cumsum([len(d) for d in data], out=offs[1:])
        # [CLS] and [SEP] always come out, so a row is at least 2 tokens
        # wide even at max_length < 2 (as on the Python path): the stride
        # must hold them or rows would overrun each other
        stride = max(max_length, 2)
        ids = np.full((n, stride), self.pad_id, dtype=np.int32)
        mask = np.zeros((n, stride), dtype=np.int32)
        ok = np.zeros(n, dtype=np.uint8)
        ip = ctypes.POINTER(ctypes.c_int)
        get_lib().wp_encode_batch(
            h, b"".join(data),
            offs.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)), n,
            stride, ids.ctypes.data_as(ip), mask.ctypes.data_as(ip),
            ok.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            os.cpu_count() or 1,
        )
        rows_served["native"] += int(ok.sum())
        for i in np.nonzero(ok == 0)[0]:  # non-ASCII rows: the Python path
            e = self.encode(texts[i], max_length=max_length)
            ids[i, : len(e.ids)] = e.ids
            mask[i, : len(e.ids)] = 1
        ln = max(int(mask.sum(axis=1).max()), 1)
        return (np.ascontiguousarray(ids[:, :ln]),
                np.ascontiguousarray(mask[:, :ln]))

    def _encode_batch_py(self, texts, max_length):
        import numpy as np

        encs = [self.encode(t, max_length=max_length) for t in texts]
        ln = max((len(e.ids) for e in encs), default=1)
        ids = np.full((len(texts), ln), self.pad_id, dtype=np.int32)
        mask = np.zeros((len(texts), ln), dtype=np.int32)
        for i, e in enumerate(encs):
            ids[i, : len(e.ids)] = e.ids
            mask[i, : len(e.ids)] = 1
        return ids, mask

    def _native_handle(self):
        """The C++ vocab handle, made at first use; None for the Python
        path (``native=False``, or a vocab whose ids are not dense). A
        failed build or load of the library raises."""
        if not self.native:
            return None
        if self._wp_handle is None:
            from .native_tokenizer import create_handle

            try:
                self._wp_handle = create_handle(self)
            except ValueError as e:  # ids not dense: a property of the data
                log.info("C++ WordPiece not used (%s); the Python path "
                         "encodes every row", e)
                self._wp_handle = False
        return self._wp_handle or None

    def __del__(self):  # release the C++ vocab (guarded: interpreter exit)
        h = getattr(self, "_wp_handle", None)
        if h:
            try:
                from .native_tokenizer import free_handle

                free_handle(h)
            except Exception:
                pass


def _is_cjk(cp: int) -> bool:
    """BERT's CJK ranges (BasicTokenizer._is_chinese_char)."""
    return (
        0x4E00 <= cp <= 0x9FFF
        or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF
        or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F
        or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF
        or 0x2F800 <= cp <= 0x2FA1F
    )


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False  # treated as whitespace, per BERT _clean_text
    return unicodedata.category(ch).startswith("C")


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _normalize_char(ch: str, lowercase: bool) -> str:
    """BERT normalization for one char: lowercase then NFD-strip combining
    marks. May return '' (pure accent) or several chars (expansions)."""
    if lowercase:
        ch = ch.lower()
    out = []
    for c in ch:
        for d in unicodedata.normalize("NFD", c):
            if unicodedata.category(d) != "Mn":
                out.append(d)
    return "".join(out)


def _pretokenize(text: str, lowercase: bool) -> list[tuple[str, list[int]]]:
    """Split into (normalized_word, original_char_index_per_norm_char).

    Full BERT BasicTokenizer semantics — lowercasing, accent stripping
    (NFD, drop Mn), control-char removal, punctuation splitting, CJK chars
    isolated — while tracking, for every normalized character, the index of
    the original character it came from, so WordPiece offsets land on the
    ORIGINAL text exactly as the HF fast tokenizer's offset mapping does.
    """
    out: list[tuple[str, list[int]]] = []
    word: list[str] = []
    idxs: list[int] = []

    def flush():
        if word:
            out.append(("".join(word), list(idxs)))
            word.clear()
            idxs.clear()

    for i, ch in enumerate(text):
        if ch == "\x00" or ch == "�" or _is_control(ch):
            continue
        if _is_whitespace(ch):
            flush()
            continue
        norm = _normalize_char(ch, lowercase)
        if not norm:  # standalone combining mark: stripped entirely
            continue
        if _is_punctuation(ch) or _is_cjk(ord(ch)):
            flush()
            out.append((norm, [i] * len(norm)))
            continue
        word.extend(norm)
        idxs.extend([i] * len(norm))
    flush()
    return out


def resolve_tokenizer(
    data_dir: str, vocab_size: int, corpus=None
) -> "WordPieceTokenizer":
    """The ONE tokenizer-resolution order every component must share:
    ``vocab.txt`` (HF-converted checkpoint) > ``tokenizer.json``
    (corpus-trained) > train-from-corpus (persisted). The pipeline's
    encoder, the DPR towers, and the cross-encoder reranker all resolve
    through here — two components resolving differently would silently
    pair one vocabulary's token ids with another's embedding rows.
    """
    import os

    vocab_path = os.path.join(data_dir, "vocab.txt")
    tok_path = os.path.join(data_dir, "tokenizer.json")
    if os.path.exists(vocab_path):
        return WordPieceTokenizer.from_vocab_file(vocab_path)
    if os.path.exists(tok_path):
        return WordPieceTokenizer.load(tok_path)
    tokenizer = WordPieceTokenizer.train_from_corpus(
        list(corpus or []), vocab_size=vocab_size
    )
    os.makedirs(data_dir, exist_ok=True)
    tokenizer.save(tok_path)
    return tokenizer


def tokenizer_digest(tok: "WordPieceTokenizer") -> str:
    """Stable identity of a tokenizer's vocabulary (sha1 over the (token,
    id) items in id order), the JAX package's digest: a checkpoint's
    sidecar refuses to serve under another vocabulary of the same size."""
    import hashlib

    h = hashlib.sha1()
    for token, idx in sorted(tok.vocab.items(), key=lambda kv: kv[1]):
        h.update(f"{idx}:{token}\n".encode("utf-8"))
    return h.hexdigest()
