"""CLIP text encoder and tokenizer of the SD x4-upscaler's prompt path
(counterpart of the JAX package's ``models/sd/clip.py``).

``CLIPTextEncoder`` carries the published transformers ``CLIPTextModel``
names (``text_model.embeddings.*``, ``text_model.encoder.layers.{i}.*``,
``text_model.final_layer_norm``) and the JAX numerics: pre-LN blocks (eps
1e-5) with causal self-attention whose scores are scaled after the product
and masked with -inf, an MLP with the configured activation (exact-erf
``gelu`` in the SD2 family), and the final LayerNorm.

``SimpleTokenizer`` is a copy of the JAX package's pure-Python tokenizer:
exact CLIP BPE from the OpenAI merge list or the HuggingFace
``vocab.json``/``merges.txt`` pair, and without files a deterministic
hash-bucket fallback that keeps the contract (77-token rows, BOS/EOS, zero
padding).
"""

from __future__ import annotations

import gzip
import html
import json
import os
import re

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


def _act(name: str):
    if name == "gelu":
        return F.gelu  # exact erf form
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    raise ValueError(f"unknown CLIP hidden_act {name!r}")


class CLIPAttention(nn.Module):
    def __init__(self, d: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        b, l, c = x.shape  # noqa: E741
        hd = c // self.heads
        q = self.q_proj(x).view(b, l, self.heads, hd)
        k = self.k_proj(x).view(b, l, self.heads, hd)
        v = self.v_proj(x).view(b, l, self.heads, hd)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * hd**-0.5 + mask
        probs = torch.softmax(scores.float(), dim=-1).to(x.dtype)
        return self.out_proj(torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, l, c))


class CLIPMLP(nn.Module):
    def __init__(self, d: int, inner: int, act: str):
        super().__init__()
        self.fc1 = nn.Linear(d, inner)
        self.fc2 = nn.Linear(inner, d)
        self.act = _act(act)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class CLIPLayer(nn.Module):
    def __init__(self, d: int, heads: int, inner: int, act: str, eps: float):
        super().__init__()
        self.self_attn = CLIPAttention(d, heads)
        self.layer_norm1 = nn.LayerNorm(d, eps=eps)
        self.mlp = CLIPMLP(d, inner, act)
        self.layer_norm2 = nn.LayerNorm(d, eps=eps)

    def forward(self, x, mask):
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class _Embeddings(nn.Module):
    def __init__(self, vocab: int, max_len: int, d: int):
        super().__init__()
        self.token_embedding = nn.Embedding(vocab, d)
        self.position_embedding = nn.Embedding(max_len, d)


class _Encoder(nn.Module):
    def __init__(self, layers: list[CLIPLayer]):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class _TextModel(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        d, eps = cfg["hidden_size"], cfg.get("layer_norm_eps", 1e-5)
        self.embeddings = _Embeddings(cfg["vocab_size"], cfg["max_position_embeddings"], d)
        self.encoder = _Encoder([
            CLIPLayer(d, cfg["num_attention_heads"], cfg["intermediate_size"], cfg.get("hidden_act", "gelu"), eps)
            for _ in range(cfg["num_hidden_layers"])
        ])
        self.final_layer_norm = nn.LayerNorm(d, eps=eps)


class CLIPTextEncoder(nn.Module):
    """Built from a transformers ``CLIPTextConfig``-style dict
    (``ckpt/sd_inventory.X4_TEXT_CONFIG``)."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.text_model = _TextModel(cfg)

    def forward(self, token_ids: torch.Tensor) -> torch.Tensor:
        """(N, L) int token ids -> (N, L, width) hidden states after the final
        LayerNorm (the embedding the UNet cross-attends to)."""
        tm = self.text_model
        l = token_ids.shape[1]  # noqa: E741
        emb = tm.embeddings
        x = emb.token_embedding(token_ids) + emb.position_embedding.weight[None, :l]
        mask = torch.full((l, l), float("-inf"), device=x.device).triu(1)[None, None]
        for layer in tm.encoder.layers:
            x = layer(x, mask)
        return tm.final_layer_norm(x)


# ------------------------------------------------------------------ tokenizer

def _basic_clean(text: str) -> str:
    return html.unescape(html.unescape(text)).strip()


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


def bytes_to_unicode() -> dict[int, str]:
    """The GPT-2/CLIP reversible byte -> unicode-character map."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _clip_pattern():
    """CLIP's token regex needs unicode classes, which the ``regex`` module
    has; without it an ASCII approximation."""
    try:
        import regex

        return regex.compile(
            r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"""
            r"""[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
            regex.IGNORECASE,
        )
    except ImportError:  # pragma: no cover
        return re.compile(
            r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"
            r"[A-Za-z]+|[0-9]|[^\sA-Za-z0-9]+",
            re.IGNORECASE,
        )


class SimpleTokenizer:
    """Exact CLIP BPE tokenizer from the OpenAI merge list (``bpe_path``) or
    the HuggingFace pair (``vocab_json``, ``merges_txt``); a hash-bucket
    fallback without files."""

    PAT = _clip_pattern()

    def __init__(self, bpe_path: str | None = None, vocab_size: int = 49408, max_len: int = 77,
                 vocab_json: str | None = None, merges_txt: str | None = None, pad_token: str = "!"):
        self.max_len = max_len
        self.pad_token = pad_token
        self._byte_encoder = bytes_to_unicode()
        self._bpe = None
        if bpe_path and os.path.exists(bpe_path):
            self._load_openai_bpe(bpe_path)
        elif vocab_json and merges_txt and os.path.exists(vocab_json):
            self._load_hf_bpe(vocab_json, merges_txt)
        if self._bpe is not None:
            encoder = self._bpe["encoder"]
            self.vocab_size = len(encoder)
            self.bos = encoder["<|startoftext|>"]
            self.eos = encoder["<|endoftext|>"]
        else:
            self.vocab_size = vocab_size
            self.bos = vocab_size - 2
            self.eos = vocab_size - 1

    def _load_openai_bpe(self, path: str) -> None:
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = merges[1: 49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges if m.strip()]
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab += ["".join(m) for m in merges]
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self._bpe = {"ranks": {m: i for i, m in enumerate(merges)},
                     "encoder": {v: i for i, v in enumerate(vocab)}}

    def _load_hf_bpe(self, vocab_json: str, merges_txt: str) -> None:
        with open(vocab_json, encoding="utf-8") as f:
            encoder = json.load(f)
        with open(merges_txt, encoding="utf-8") as f:
            lines = f.read().strip().split("\n")
        if lines and lines[0].startswith("#version"):
            lines = lines[1:]
        merges = [tuple(m.split()) for m in lines if m.strip()]
        self._bpe = {"ranks": {m: i for i, m in enumerate(merges)}, "encoder": encoder}

    def _word_tokens(self, word: str) -> list[int]:
        if self._bpe is None:
            h = 0
            for ch in word:
                h = (h * 131 + ord(ch)) % (self.vocab_size - 512)
            return [h + 256]
        ranks, encoder = self._bpe["ranks"], self._bpe["encoder"]
        chars = [self._byte_encoder[b] for b in word.encode("utf-8")]
        if not chars:
            return []
        tokens = chars[:-1] + [chars[-1] + "</w>"]
        while len(tokens) > 1:
            pairs = [(tokens[i], tokens[i + 1]) for i in range(len(tokens) - 1)]
            best = min(pairs, key=lambda p: ranks.get(p, 1 << 30))
            if best not in ranks:
                break
            merged, i = [], 0
            while i < len(tokens):
                if i < len(tokens) - 1 and (tokens[i], tokens[i + 1]) == best:
                    merged.append(tokens[i] + tokens[i + 1])
                    i += 2
                else:
                    merged.append(tokens[i])
                    i += 1
            tokens = merged
        unk = encoder.get("<|endoftext|>", 0)
        return [encoder.get(t, unk) for t in tokens]

    def _specials(self) -> dict[str, int]:
        """Literal strings that map straight to an id, bypassing BPE (the HF
        added-token behaviour, ``pad_token`` included)."""
        if self._bpe is None:
            return {}
        enc = self._bpe["encoder"]
        sp = {"<|startoftext|>": self.bos, "<|endoftext|>": self.eos}
        if self.pad_token and self.pad_token in enc:
            sp[self.pad_token] = enc[self.pad_token]
        return sp

    def _encode_text(self, text: str) -> list[int]:
        text = _whitespace_clean(_basic_clean(text)).lower()
        specials = self._specials()
        ids: list[int] = []
        if specials:
            split_pat = re.compile("|".join(re.escape(s) for s in sorted(specials, key=len, reverse=True)))
            pos = 0
            for m in split_pat.finditer(text):
                for word in self.PAT.findall(text[pos: m.start()]):
                    ids.extend(self._word_tokens(word))
                ids.append(specials[m.group()])
                pos = m.end()
            text = text[pos:]
        for word in self.PAT.findall(text):
            ids.extend(self._word_tokens(word))
        return ids

    def __call__(self, texts: str | list[str]) -> np.ndarray:
        """Text(s) -> (N, max_len) int32 ids: BOS, the text's ids cut to fit,
        EOS, zeros."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), self.max_len), np.int32)
        for r, text in enumerate(texts):
            ids = [self.bos] + self._encode_text(text)
            ids = ids[: self.max_len - 1] + [self.eos]
            out[r, : len(ids)] = ids
        return out
