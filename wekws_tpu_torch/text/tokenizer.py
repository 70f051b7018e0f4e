"""Tokenization: char tokenizer, token table, lexicon.

The port's own numpy-free copy of wekws_tpu/text/tokenizer.py (pure
Python): the token table and lexicon readers, the keyword -> token-id
query the streaming engine uses, and the char tokenizer.

File formats (Kaldi-style):
  dict.txt / tokens.txt : ``<token> <id>`` per line, id 0 = <blank>
  words.txt / lexicon   : ``<word> <token> <token> ...`` per line
"""

import re
from typing import Dict, List, Sequence, Set, Tuple


def split_mixed_label(input_str: str) -> List[str]:
    """Tokenize mixed CJK/Latin text: CJK chars split singly, Latin
    words kept whole."""
    tokens = []
    s = input_str.lower()
    while len(s) > 0:
        match = re.match(r"[A-Za-z!?,<>()\']+", s)
        if match is not None:
            word = match.group(0)
        else:
            word = s[0:1]
        tokens.append(word)
        s = s.replace(word, "", 1).strip(" ")
    return tokens


def read_token(token_file: str) -> Dict[str, int]:
    """``token id`` table -> {token: id}."""
    table = {}
    with open(token_file, "r", encoding="utf8") as f:
        for line in f:
            parts = line.strip().split()
            if len(parts) == 2:
                table[parts[0]] = int(parts[1])
    return table


def read_lexicon(lexicon_file: str) -> Dict[str, List[str]]:
    """``word tok tok ...`` -> {word: [tokens]}."""
    lexicon = {}
    with open(lexicon_file, "r", encoding="utf8") as f:
        for line in f:
            parts = line.strip().split()
            if len(parts) >= 2:
                lexicon[parts[0]] = parts[1:]
    return lexicon


def query_token_set(
    keyword: str,
    token_table: Dict[str, int],
    lexicon: Dict[str, List[str]],
    unk: str = "<unk>",
) -> Tuple[List[str], List[int]]:
    """Map a keyword string to (token strings, token ids) using the
    lexicon for whole words and falling back to per-char lookup."""
    strs: List[str] = []
    for unit in split_mixed_label(keyword):
        if unit in lexicon:
            strs.extend(lexicon[unit])
        elif unit in token_table:
            strs.append(unit)
        else:
            strs.extend(ch if ch in token_table else unk for ch in unit)
    ids = [token_table.get(s, token_table.get(unk, 0)) for s in strs]
    return strs, ids


class CharTokenizer:
    """Character tokenizer with optional lexicon expansion.

    Args:
        token_file: token -> id table (dict.txt).
        lexicon_file: optional word -> token sequence table (words.txt).
        unk: fallback token for OOV units (the reference recipes use
            '<filler>').
    """

    def __init__(
        self,
        token_file: str,
        lexicon_file: str = None,
        unk: str = "<filler>",
        split_with_space: bool = False,
    ):
        self.token_table = read_token(token_file)
        self.lexicon = read_lexicon(lexicon_file) if lexicon_file else {}
        self.unk = unk
        self.split_with_space = split_with_space

    @property
    def vocab_size(self) -> int:
        return len(self.token_table)

    def units(self, text: str) -> List[str]:
        if self.split_with_space:
            parts = [p for p in text.strip().split() if p]
        else:
            parts = split_mixed_label(text)
        out: List[str] = []
        for p in parts:
            if p in self.lexicon:
                out.extend(self.lexicon[p])
            else:
                out.append(p)
        return out

    def tokenize(self, text: str) -> Tuple[List[str], List[int]]:
        strs = []
        ids = []
        unk_id = self.token_table.get(self.unk)

        def emit(u: str):
            if u in self.token_table:
                strs.append(u)
                ids.append(self.token_table[u])
            elif unk_id is not None:
                strs.append(self.unk)
                ids.append(unk_id)

        for u in self.units(text):
            if u in self.token_table or len(u) == 1:
                emit(u)
            else:
                # char-level fallback for OOV multi-char units
                for ch in u:
                    emit(ch)
        return strs, ids

    def detokenize(self, ids: Sequence[int]) -> List[str]:
        inv = {v: k for k, v in self.token_table.items()}
        return [inv.get(int(i), self.unk) for i in ids]

    def keyword_token_set(self, keywords: Sequence[str]) -> Set[int]:
        """Token-id set of all keywords plus blank (id 0) — used for
        decode-time pruning."""
        idxset = {0}
        for kw in keywords:
            _, ids = query_token_set(
                kw, self.token_table, self.lexicon, self.unk
            )
            idxset.update(ids)
        return idxset
