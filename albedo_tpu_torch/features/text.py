"""Text transformers: CJK-aware tokenizer, stop-word removal, count
vectorizer, stemmer.

Reference parity:
- ``transformers/HanLPTokenizer.scala:29-51`` — lowercase, segment, keep
  ``c/r/c++/c#/f#`` as tokens, drop 1-char non-CJK tokens, CJK-aware word
  regex. HanLP's dictionary-driven Chinese segmentation is replaced by CJK
  character unigrams (a pluggable ``segmenter`` hook accepts a real segmenter);
  everything else matches.
- Spark's ``StopWordsRemover`` with the default english list
  (``LogisticRegressionRanker.scala:207-209``).
- ``CountVectorizer().setMinDF(10).setMinTF(1)`` per list column
  (``LogisticRegressionRanker.scala:190-198``), producing bag fields (padded
  index/count arrays) instead of sparse vectors.
- ``transformers/SnowballStemmer.scala:16-28`` — here a self-contained Porter
  stemmer (no external snowball dependency).

Host code, copied from ``albedo_tpu/features/text.py`` with its imports pointed at
the port; the port keeps its own copy so that it never imports the JAX
package.
"""

from __future__ import annotations

import re
from collections import Counter
from typing import Callable, Sequence

import numpy as np
import pandas as pd

from albedo_tpu_torch.features.assembler import set_vocab_size
from albedo_tpu_torch.features.pipeline import Estimator, Transformer, col_values, memo_map

_LANGUAGE_TOKENS = {"c", "r", "c++", "c#", "f#"}
_RE_CJK_CHAR = re.compile("[぀-ゟ゠-ヿ㄀-ㄯ豈-﫿一-鿿]")
# One left-to-right scan: a `c++`/`c#`/`f#` language token (only where a plain
# word wouldn't swallow it: "libc++" tokenizes as "libc", not a phantom c++)
# or a CJK-aware word. Order of appearance is preserved for w2v windows.
_RE_TOKEN = re.compile(
    "(c\\+\\+|c#|f#)(?![\\w+#])"  # group 1: language tokens with suffix guard
    f"|([{'' }\\w.\\-_぀-ゟ゠-ヿ㄀-ㄯ豈-﫿一-鿿]+)"  # group 2: words
)

# Spark's StopWordsRemover.loadDefaultStopWords("english") list.
ENGLISH_STOP_WORDS = frozenset(
    """i me my myself we our ours ourselves you your yours yourself yourselves he
him his himself she her hers herself it its itself they them their theirs
themselves what which who whom this that these those am is are was were be been
being have has had having do does did doing a an the and but if or because as
until while of at by for with about against between into through during before
after above below to from up down in out on off over under again further then
once here there when where why how all any both each few more most other some
such no nor not only own same so than too very s t can will just don should now
i'll you'll he'll she'll we'll they'll i'd you'd he'd she'd we'd they'd i'm
you're he's she's it's we're they're i've we've you've they've isn't aren't
wasn't weren't haven't hasn't hadn't don't doesn't didn't won't wouldn't
shan't shouldn't mustn't can't couldn't cannot could here's how's let's ought
that's there's what's when's where's who's why's would""".split()
)


def _cjk_unigrams(run: str) -> list[str]:
    """Character-unigram fallback segmenter (the r1-r4 default)."""
    return list(run)


class Tokenizer(Transformer):
    """CJK-aware tokenizer over a string column -> list-of-tokens column.

    CJK runs go through ``segmenter``: by default the built-in
    frequency-dictionary Viterbi segmenter
    (``features/cjk_segmenter.py`` — the HanLP-parity word-level behavior,
    ``transformers/HanLPTokenizer.scala:29-51``); pass ``_cjk_unigrams`` for
    character unigrams or any custom callable."""

    def __init__(
        self,
        input_col: str,
        output_col: str | None = None,
        remove_stop_words: bool = True,
        segmenter: Callable[[str], list[str]] | None = None,
    ):
        if segmenter is None:
            from albedo_tpu_torch.features.cjk_segmenter import default_segmenter

            segmenter = default_segmenter()
        self.input_col = input_col
        self.output_col = output_col or f"{input_col}__words"
        self.remove_stop_words = remove_stop_words
        self.segmenter = segmenter

    def tokenize(self, text: str) -> list[str]:
        text = text.lower()
        out: list[str] = []
        for m in _RE_TOKEN.finditer(text):
            if m.group(1):  # c++ / c# / f# kept whole (HanLPTokenizer:39)
                out.append(m.group(1))
                continue
            word = m.group(2)
            if word in _LANGUAGE_TOKENS:
                out.append(word)  # single-letter languages c / r survive
            elif _RE_CJK_CHAR.search(word):
                # Split mixed runs into CJK segments + latin remainder.
                for run in re.findall(f"{_RE_CJK_CHAR.pattern}+|[^぀-ゟ゠-ヿ㄀-ㄯ豈-﫿一-鿿]+", word):
                    if _RE_CJK_CHAR.search(run):
                        out.extend(self.segmenter(run))
                    elif len(run) > 1:
                        out.append(run)
            elif len(word) > 1:
                out.append(word)  # 1-char non-CJK tokens dropped (HanLPTokenizer:40-47)
        if self.remove_stop_words:
            out = [w for w in out if w not in ENGLISH_STOP_WORDS]
        return out

    def transform(self, df: pd.DataFrame) -> pd.DataFrame:
        self.require_cols(df, [self.input_col])
        out = df.copy()
        out[self.output_col] = memo_map(
            df[self.input_col], lambda t: self.tokenize(t or "")
        )
        return out


# Alias documenting which reference class this replaces.
HanLPTokenizer = Tokenizer


class StopWordsRemover(Transformer):
    def __init__(
        self,
        input_col: str,
        output_col: str | None = None,
        stop_words: Sequence[str] | frozenset = ENGLISH_STOP_WORDS,
    ):
        self.input_col = input_col
        self.output_col = output_col or f"{input_col}__filtered"
        self.stop_words = frozenset(stop_words)

    def transform(self, df: pd.DataFrame) -> pd.DataFrame:
        self.require_cols(df, [self.input_col])
        out = df.copy()
        out[self.output_col] = memo_map(
            df[self.input_col],
            lambda words: [w for w in words if w not in self.stop_words],
            key=tuple,
        )
        return out


class CountVectorizerModel(Transformer):
    """Token lists -> bag columns: ``{out}__bag_idx`` / ``{out}__bag_val``
    (variable-length int/float arrays; the assembler pads them)."""

    def __init__(self, input_col: str, output_col: str, vocab: list[str], binary: bool = False):
        self.input_col = input_col
        self.output_col = output_col
        self.vocab = list(vocab)
        self.binary = binary
        self._index = {w: i for i, w in enumerate(self.vocab)}

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def _bag(self, words) -> tuple[np.ndarray, np.ndarray]:
        counts = Counter(self._index[w] for w in words if w in self._index)
        idx = np.fromiter(counts.keys(), dtype=np.int32, count=len(counts))
        val = np.fromiter(counts.values(), dtype=np.float32, count=len(counts))
        if self.binary:
            val = np.ones_like(val)
        return idx, val

    def transform(self, df: pd.DataFrame) -> pd.DataFrame:
        self.require_cols(df, [self.input_col])
        bags = memo_map(df[self.input_col], self._bag, key=tuple)
        out = df.copy()
        out[f"{self.output_col}__bag_idx"] = [b[0] for b in bags]
        out[f"{self.output_col}__bag_val"] = [b[1] for b in bags]
        set_vocab_size(out, self.output_col, self.vocab_size)
        return out


class CountVectorizer(Estimator):
    """Vocab = terms appearing in >= ``min_df`` documents, most frequent first,
    capped at ``max_vocab`` (Spark CountVectorizer semantics)."""

    def __init__(
        self,
        input_col: str,
        output_col: str | None = None,
        min_df: int = 10,
        max_vocab: int = 1 << 18,
        binary: bool = False,
    ):
        self.input_col = input_col
        self.output_col = output_col or f"{input_col}__cv"
        self.min_df = min_df
        self.max_vocab = max_vocab
        self.binary = binary

    def fit(self, df: pd.DataFrame) -> CountVectorizerModel:
        # min_df filters on DOCUMENT frequency; vocab order/truncation use
        # total TERM frequency — Spark CountVectorizer semantics. Each ROW is
        # a document (repeats count separately), so repeated docs are counted
        # once with their multiplicity instead of re-walked per row.
        doc_mult: Counter = Counter(
            tuple(words) for words in col_values(df[self.input_col])
        )
        doc_freq: Counter = Counter()
        term_freq: Counter = Counter()
        for doc, m in doc_mult.items():
            for w in set(doc):
                doc_freq[w] += m
            for w in doc:
                term_freq[w] += m
        terms = [
            (w, term_freq[w]) for w, c in doc_freq.items() if c >= self.min_df
        ]
        terms.sort(key=lambda wc: (-wc[1], wc[0]))
        vocab = [w for w, _ in terms[: self.max_vocab]]
        return CountVectorizerModel(self.input_col, self.output_col, vocab, self.binary)


class SnowballStemmer(Transformer):
    """English Porter stemmer over a token-list column
    (``transformers/SnowballStemmer.scala``; defined there but not wired into
    the main pipelines — same here)."""

    def __init__(self, input_col: str, output_col: str | None = None):
        self.input_col = input_col
        self.output_col = output_col or f"{input_col}__stemmed"

    def transform(self, df: pd.DataFrame) -> pd.DataFrame:
        self.require_cols(df, [self.input_col])
        out = df.copy()
        out[self.output_col] = [
            [porter_stem(w) for w in ws] for ws in col_values(df[self.input_col])
        ]
        return out


# --- Porter stemmer (self-contained) ----------------------------------------

_VOWELS = "aeiou"


def _is_cons(word: str, i: int) -> bool:
    c = word[i]
    if c in _VOWELS:
        return False
    if c == "y":
        return i == 0 or not _is_cons(word, i - 1)
    return True


def _measure(stem: str) -> int:
    """Number of VC sequences."""
    m, prev_vowel = 0, False
    for i in range(len(stem)):
        cons = _is_cons(stem, i)
        if cons and prev_vowel:
            m += 1
        prev_vowel = not cons
    return m


def _has_vowel(stem: str) -> bool:
    return any(not _is_cons(stem, i) for i in range(len(stem)))


def _ends_double_cons(word: str) -> bool:
    return len(word) >= 2 and word[-1] == word[-2] and _is_cons(word, len(word) - 1)


def _cvc(word: str) -> bool:
    if len(word) < 3:
        return False
    return (
        _is_cons(word, len(word) - 3)
        and not _is_cons(word, len(word) - 2)
        and _is_cons(word, len(word) - 1)
        and word[-1] not in "wxy"
    )


def porter_stem(word: str) -> str:
    if len(word) <= 2:
        return word
    w = word.lower()

    # step 1a
    if w.endswith("sses"):
        w = w[:-2]
    elif w.endswith("ies"):
        w = w[:-2]
    elif not w.endswith("ss") and w.endswith("s"):
        w = w[:-1]

    # step 1b
    flag = False
    if w.endswith("eed"):
        if _measure(w[:-3]) > 0:
            w = w[:-1]
    elif w.endswith("ed") and _has_vowel(w[:-2]):
        w, flag = w[:-2], True
    elif w.endswith("ing") and _has_vowel(w[:-3]):
        w, flag = w[:-3], True
    if flag:
        if w.endswith(("at", "bl", "iz")):
            w += "e"
        elif _ends_double_cons(w) and not w.endswith(("l", "s", "z")):
            w = w[:-1]
        elif _measure(w) == 1 and _cvc(w):
            w += "e"

    # step 1c
    if w.endswith("y") and _has_vowel(w[:-1]):
        w = w[:-1] + "i"

    # step 2
    for suf, rep in (
        ("ational", "ate"), ("tional", "tion"), ("enci", "ence"), ("anci", "ance"),
        ("izer", "ize"), ("abli", "able"), ("alli", "al"), ("entli", "ent"),
        ("eli", "e"), ("ousli", "ous"), ("ization", "ize"), ("ation", "ate"),
        ("ator", "ate"), ("alism", "al"), ("iveness", "ive"), ("fulness", "ful"),
        ("ousness", "ous"), ("aliti", "al"), ("iviti", "ive"), ("biliti", "ble"),
    ):
        if w.endswith(suf):
            if _measure(w[: -len(suf)]) > 0:
                w = w[: -len(suf)] + rep
            break

    # step 3
    for suf, rep in (
        ("icate", "ic"), ("ative", ""), ("alize", "al"), ("iciti", "ic"),
        ("ical", "ic"), ("ful", ""), ("ness", ""),
    ):
        if w.endswith(suf):
            if _measure(w[: -len(suf)]) > 0:
                w = w[: -len(suf)] + rep
            break

    # step 4
    for suf in (
        "al", "ance", "ence", "er", "ic", "able", "ible", "ant", "ement",
        "ment", "ent", "ou", "ism", "ate", "iti", "ous", "ive", "ize",
    ):
        if w.endswith(suf):
            if _measure(w[: -len(suf)]) > 1:
                w = w[: -len(suf)]
            break
    else:
        if w.endswith("ion") and len(w) > 3 and w[-4] in "st" and _measure(w[:-3]) > 1:
            w = w[:-3]

    # step 5a
    if w.endswith("e"):
        stem = w[:-1]
        if _measure(stem) > 1 or (_measure(stem) == 1 and not _cvc(stem)):
            w = stem
    # step 5b
    if _measure(w) > 1 and _ends_double_cons(w) and w.endswith("l"):
        w = w[:-1]
    return w
