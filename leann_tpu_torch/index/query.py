"""Query expansion: BM25-driven expansion for short queries.

Same behavior as the reference (`src/index/query.rs:12-171`): queries of
<= 3 words are expanded with key prose terms (stopword/code-like
filtered, >= 4 chars) and code symbols (function/class/struct names from
11 language regexes) extracted from BM25-matched passages.
"""

from __future__ import annotations

import re
from typing import Dict, List, Sequence

_CODE_SYMBOL_PATTERNS = [
    # Rust
    re.compile(r"(?:pub\s+)?(?:async\s+)?fn\s+(\w+)"),
    re.compile(r"(?:pub\s+)?struct\s+(\w+)"),
    re.compile(r"(?:pub\s+)?enum\s+(\w+)"),
    re.compile(r"(?:pub\s+)?trait\s+(\w+)"),
    # Python
    re.compile(r"(?:async\s+)?def\s+(\w+)"),
    re.compile(r"class\s+(\w+)"),
    # JS/TS
    re.compile(r"(?:async\s+)?function\s+(\w+)"),
    re.compile(r"(?:const|let|var)\s+(\w+)\s*=\s*(?:async\s+)?\("),
    # Go
    re.compile(r"func\s+(?:\([^)]+\)\s+)?(\w+)"),
    re.compile(r"type\s+(\w+)\s+(?:struct|interface)"),
    # Java/C#
    re.compile(r"(?:public|private|protected)?\s*(?:static\s+)?(?:class|interface)\s+(\w+)"),
]

_STOPWORDS = frozenset("""
a an the is are was were be been being have has had do does did will would
could should may might must shall can need dare ought used to of in for on
with at by from as into through during before after above below between under
again further then once here there when where why how all each few more most
other some such no nor not only own same so than too very just and but if or
because until while this that these those it its i me my myself we our ours
ourselves you your yours yourself yourselves he him his himself she her hers
herself they them their theirs themselves what which who whom any both also
about like using based within without
""".split())

_CODE_KEYWORDS = frozenset("""
let const var fn func def pub mut impl struct enum type trait class interface
async await return match case break continue loop while for if else elif try
catch throw import export from require module use mod self super true false
null none nil void int str bool float vec map set list dict assert assert_eq
println print printf console log
""".split())


def extract_code_symbols(text: str, max_symbols: int) -> List[str]:
    counts: Dict[str, int] = {}
    for pat in _CODE_SYMBOL_PATTERNS:
        for m in pat.finditer(text):
            name = m.group(1)
            if len(name) >= 3 and not name.startswith("test_") and not name.startswith("_"):
                counts[name] = counts.get(name, 0) + 1
    ordered = sorted(counts.items(), key=lambda kv: -kv[1])
    return [name for name, _ in ordered[:max_symbols]]


def _is_code_like(term: str) -> bool:
    if "_" in term:
        return True
    has_digit = any(c.isdigit() for c in term)
    has_alpha = any(c.isalpha() for c in term)
    if has_digit and has_alpha:
        return True
    return term in _CODE_KEYWORDS


def extract_key_terms(text: str, max_terms: int) -> List[str]:
    counts: Dict[str, int] = {}
    for word in re.split(r"[^a-zA-Z0-9]+", text):
        lower = word.lower()
        if (
            len(lower) >= 4
            and lower not in _STOPWORDS
            and not lower.isdigit()
            and not _is_code_like(lower)
        ):
            counts[lower] = counts.get(lower, 0) + 1
    ordered = sorted(counts.items(), key=lambda kv: -kv[1])
    return [t for t, _ in ordered[:max_terms]]


def expand_from_passages(
    query: str, passage_texts: Sequence[str], max_expansion_terms: int = 5
) -> str:
    if not passage_texts:
        return query
    combined = " ".join(passage_texts)
    key_terms = extract_key_terms(combined, max_expansion_terms)
    for symbol in extract_code_symbols(combined, max_expansion_terms):
        if symbol.lower() not in key_terms:
            key_terms.append(symbol)
    query_words = set(query.lower().split())
    new_terms = [t for t in key_terms if t.lower() not in query_words][
        :max_expansion_terms
    ]
    if not new_terms:
        return query
    return f"{query} {' '.join(new_terms)}"


def should_expand(query: str) -> bool:
    return len(query.split()) <= 3
