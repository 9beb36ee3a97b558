"""CLIP BPE tokenizer + offline class-feature precompute.

Port of ``boxfusion_tpu/models/clip/text.py`` (the tokenizer is pure Python
and is this package's own copy).  Capability target: the reference's ``precompute_class_features.py`` (1-45):
tokenize the panoptic category list, run the CLIP text tower, normalize, and
persist as the ``class_features`` asset consumed at runtime (demo.py:461).

The tokenizer is a from-scratch implementation of CLIP's lower-cased BPE
(byte-level unicode mapping + merge ranks + ``<start/end_of_text>``); it
needs the standard ``bpe_simple_vocab_16e6.txt.gz`` merges file supplied by
the user (the asset is not bundled).
"""
from __future__ import annotations

import gzip
import html
import re
from functools import lru_cache
from typing import List

import numpy as np

CONTEXT_LENGTH = 77


@lru_cache()
def bytes_to_unicode():
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _basic_clean(text: str) -> str:
    return html.unescape(html.unescape(text)).strip()


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class SimpleTokenizer:
    """CLIP BPE tokenizer (merges file required)."""

    def __init__(self, bpe_path: str):
        opener = gzip.open if bpe_path.endswith(".gz") else open
        with opener(bpe_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = [tuple(m.split()) for m in merges[1 : 49152 - 256 - 2 + 1]]

        self.byte_encoder = bytes_to_unicode()
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for m in merges:
            vocab.append("".join(m))
        vocab.extend(["<start_of_text>", "<end_of_text>"])
        self.encoder = {v: i for i, v in enumerate(vocab)}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {
            "<start_of_text>": "<start_of_text>",
            "<end_of_text>": "<end_of_text>",
        }
        self.pat = re.compile(
            r"""<start_of_text>|<end_of_text>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+"""
            if False
            else r"""'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+""",
            re.IGNORECASE,
        )

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)

        def get_pairs(w):
            return {(w[i], w[i + 1]) for i in range(len(w) - 1)}

        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word, i = [], 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                    new_word.extend(word[i:j])
                    i = j
                except ValueError:
                    new_word.extend(word[i:])
                    break
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        text = _whitespace_clean(_basic_clean(text)).lower()
        ids: List[int] = []
        for token in re.findall(self.pat, text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(token).split(" "))
        return ids

    def __call__(self, texts: List[str], context_length: int = CONTEXT_LENGTH) -> np.ndarray:
        sot = self.encoder["<start_of_text>"]
        eot = self.encoder["<end_of_text>"]
        out = np.zeros((len(texts), context_length), np.int32)
        for i, t in enumerate(texts):
            toks = [sot] + self.encode(t)[: context_length - 2] + [eot]
            out[i, : len(toks)] = toks
        return out


def precompute_class_features(
    class_txt: str,
    clip_path: str,
    bpe_path: str,
    output_path: str,
    batch: int = 64,
    device=None,
) -> np.ndarray:
    """Precompute normalized text features for a class list
    (precompute_class_features.py parity; saves .npy).

    ``device`` defaults to "cuda" (raises if there is none)."""
    from boxfusion_tpu_torch.models.clip.convert import load_clip_text_params
    from boxfusion_tpu_torch.utils.config import read_lines

    classes = read_lines(class_txt)
    tokens = SimpleTokenizer(bpe_path)(classes)
    tower, _ = load_clip_text_params(clip_path, device=device)
    out = encode_tokens(tower, tokens, batch)
    np.save(output_path, out)
    return out


def encode_tokens(tower, tokens: np.ndarray, batch: int = 64) -> np.ndarray:
    """Text-tower embeddings of (N, context) token ids, ``batch`` rows per
    call, L2-normalised; rows do not interact, so the last chunk runs short
    instead of padded."""
    import torch

    dev = next(tower.parameters()).device
    feats = []
    with torch.inference_mode():
        for i in range(0, len(tokens), batch):
            chunk = torch.as_tensor(np.asarray(tokens[i: i + batch], np.int64)).to(dev)
            feats.append(tower(chunk).cpu().numpy())
    out = np.concatenate(feats, 0)
    return out / np.linalg.norm(out, axis=-1, keepdims=True)


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--class_txt", required=True)
    p.add_argument("--clip_path", required=True)
    p.add_argument("--bpe_path", required=True)
    p.add_argument("--output", default="class_features.npy")
    p.add_argument("--device", default=None)
    a = p.parse_args()
    precompute_class_features(a.class_txt, a.clip_path, a.bpe_path, a.output, device=a.device)
