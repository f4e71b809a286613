"""Word/character hybrid tokenizer for the canonicalizer model.

Deterministic, dependency-free: a fixed vocabulary built from the schema
vocabulary + JSON structural tokens + common words, with character fallback.
Small (< 8k ids) so the canonicalizer-100m LM head stays cheap and the
JSON-constrained decoder can evaluate the whole vocab per step.
"""
from __future__ import annotations

import re
import string

SPECIALS = ["<pad>", "<bos>", "<eos>", "<sep>", "<unk>"]
JSON_TOKENS = list('{}[]":,') + [
    '"schema"', '"measures"', '"levels"', '"filters"', '"time_window"',
    '"agg"', '"expr"', '"col"', '"op"', '"val"', '"start"', '"end"',
    '"SUM"', '"COUNT"', '"MIN"', '"MAX"', '"AVG"', '"="',
]


class Tokenizer:
    def __init__(self, corpus_words: list[str], vocab_size: int = 8192):
        words = sorted(set(corpus_words))
        chars = list(string.printable[:95])
        vocab = SPECIALS + JSON_TOKENS + chars + words
        self.vocab = vocab[:vocab_size]
        self.index = {t: i for i, t in enumerate(self.vocab)}
        self.pad, self.bos, self.eos, self.sep, self.unk = range(5)

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def id_to_str(self, i: int) -> str:
        t = self.vocab[i]
        return "" if t in SPECIALS else t

    def encode(self, text: str, add_bos: bool = False) -> list[int]:
        out = [self.bos] if add_bos else []
        for piece in re.findall(r'"[A-Za-z_.#\- ]*"|\w+|\S|\s', text):
            if piece in self.index:
                out.append(self.index[piece])
            else:
                for ch in piece:
                    out.append(self.index.get(ch, self.unk))
        return out

    def decode(self, ids) -> str:
        return "".join(self.id_to_str(int(i)) for i in ids)


def build_tokenizer(workloads) -> Tokenizer:
    """Vocabulary from workload NL vocab + signature JSON components."""
    words: list[str] = []
    for wl in workloads:
        v = wl.vocab
        words += list(v.measures) + list(v.levels) + list(v.values) + list(v.numeric_cols)
        for senses in v.measures.values():
            words += [f'"{s.expr}"' for s in senses]
        for levels in v.levels.values():
            words += [f'"{lv}"' for lv in levels]
        words += [f'"{wl.name}"']
        for key, pairs in v.values.items():
            words += [f'"{col}"' for col, _ in pairs] + [f'"{val}"' for _, val in pairs]
    words += [w for text in _COMMON for w in text.split()]
    return Tokenizer(words)


_COMMON = [
    "show what is give me report compute display total average number of by per",
    "for each broken down grouped in during from to and with top having over",
    "under between please dashboard needs looking break out can you i need",
]
