"""Regex word extraction (incl. CJK ranges) and field cleaners.

Reference parity: ``closures/StringFunctions.scala:5-29`` (word patterns over
``\\w.-_`` plus Hiragana/Katakana/Bopomofo/CJK ideograph blocks) and
``closures/UDFs.scala``'s ``cleanCompanyUDF`` / ``cleanLocationUDF`` /
``cleanEmailUDF`` (:32-78). These run on the host during profile ETL; their
output feeds indexers/vocabularies, not the device.

Host code, copied from ``albedo_tpu/text/strings.py`` with its imports pointed at
the port; the port keeps its own copy so that it never imports the JAX
package.
"""

from __future__ import annotations

import re

# \w plus . - _ plus the CJK blocks the reference whitelists
# (InHiragana, InKatakana, InBopomofo, InCJKCompatibilityIdeographs,
# InCJKUnifiedIdeographs).
_WORD_ENG = r"\w.\-_"
_WORD_CJK = _WORD_ENG + (
    "぀-ゟ"  # Hiragana
    "゠-ヿ"  # Katakana
    "㄀-ㄯ"  # Bopomofo
    "豈-﫿"  # CJK Compatibility Ideographs
    "一-鿿"  # CJK Unified Ideographs
)

_RE_WORDS = re.compile(f"[{_WORD_ENG}]+")
_RE_WORDS_CJK = re.compile(f"[{_WORD_CJK}]+")
_RE_EMAIL_DOMAIN = re.compile(f"@([{_WORD_ENG}]+)")

_RE_TLD = re.compile(r"\.(com|net|org|io|co\.uk|co|eu|fr|de|ru)\b")
_RE_FORMERLY = re.compile(r"\b(formerly|previously)\b|\bex-")
_RE_NON_WORD = re.compile(r"[^\w぀-ゟ゠-ヿ㄀-ㄯ豈-﫿一-鿿]+")
_RE_CORP_WORDS = re.compile(r"\b(http|https|www|co ltd|pvt ltd|ltd|inc|llc)\b")
_RE_SPACES = re.compile(r"\s+")
_RE_CITY_PAIR = re.compile(f"([{_WORD_CJK} ]+?)\\s*,\\s*([{_WORD_CJK} ]+)")
_RE_LOC_PUNCT = re.compile(r"""[~!@#$^%&*()_+={}\[\]|;:"'<,>.?`/\\-]+""")
_RE_CITY_WORD = re.compile(r"\b(city)\b")


def extract_words(text: str) -> list[str]:
    return _RE_WORDS.findall(text)


def extract_words_include_cjk(text: str) -> list[str]:
    return _RE_WORDS_CJK.findall(text)


def extract_email_domain(email: str) -> str:
    m = _RE_EMAIL_DOMAIN.search(email)
    return m.group(1) if m else email


def clean_company(company: str) -> str:
    """Normalize a free-form company field to a comparable key.

    Mirrors ``cleanCompanyUDF``: lowercase, strip TLD suffixes and
    formerly/ex- markers, collapse punctuation, drop corporate boilerplate
    (ltd/inc/llc/http/www), keep CJK-aware words; ``__empty`` if nothing is
    left.
    """
    t = company.lower()
    t = _RE_TLD.sub("", t)
    t = _RE_FORMERLY.sub("", t)
    t = _RE_NON_WORD.sub(" ", t)
    t = _RE_SPACES.sub(" ", t)
    t = _RE_CORP_WORDS.sub("", t)
    t = t.strip()
    words = extract_words_include_cjk(t)
    return " ".join(words) if words else "__empty"


def clean_location(location: str) -> str:
    """Normalize a location field to the city token (``cleanLocationUDF``):
    "City, Country" keeps the city, then lowercases, strips punctuation and a
    literal "city" word; ``__empty`` fallback."""
    # Whole-string match: Scala's `val pattern(city, _) = location` extractor
    # requires a full match; "San Francisco, CA, USA" raises MatchError there
    # and the reference keeps the entire string, so fullmatch (not prefix
    # match) is the parity-correct behavior.
    m = _RE_CITY_PAIR.fullmatch(location)
    t = m.group(1) if m else location  # "San Francisco, CA" -> "San Francisco"
    t = t.lower()
    t = _RE_LOC_PUNCT.sub(" ", t)
    t = _RE_SPACES.sub(" ", t)
    t = _RE_CITY_WORD.sub("", t)
    t = t.strip()
    words = extract_words_include_cjk(t)
    return " ".join(words) if words else "__empty"
