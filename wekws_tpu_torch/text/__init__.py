"""Token tables, lexicon and the char tokenizer."""

from wekws_tpu_torch.text.tokenizer import (
    CharTokenizer,
    query_token_set,
    read_lexicon,
    read_token,
    split_mixed_label,
)

__all__ = [
    "CharTokenizer",
    "query_token_set",
    "read_lexicon",
    "read_token",
    "split_mixed_label",
]
