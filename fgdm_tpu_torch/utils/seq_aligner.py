"""Token-sequence alignment for prompt editing, on the host.

Counterpart of ``fgdm_tpu/utils/seq_aligner.py`` (the reference's
``utils/seq_aligner.py:62-196``): a Needleman-Wunsch global alignment
between tokenized prompts gives

* ``get_refinement_mapper``: a per-edit token index mapper and an alpha mask
  (1 where the target token maps to a source token) for the refine edit;
* ``get_replacement_mapper``: [77, 77] soft permutation matrices for the
  replace edit (word-level substitution; a source word maps onto a target
  word of another token count with weight 1 / len(target));
* ``get_word_inds``: word -> token positions, for equalizers and
  ``LocalBlend``.

Numpy on the host, with the port's ``models/clip.CLIPTokenizer``
(``encode_text``, ``BOT``, ``EOT``); ``utils/ptp.py`` turns the results into
tensors.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import numpy as np

__all__ = ["global_align", "aligned_mapper", "get_mapper",
           "get_refinement_mapper", "get_word_inds",
           "get_replacement_mapper_", "get_replacement_mapper"]

GAP = 0          # the reference's ScoreParams(0, 1, -1)
MATCH = 1
MISMATCH = -1


def global_align(x: Sequence[int], y: Sequence[int]) -> np.ndarray:
    """The alignment's trace-back matrix (1 left / gap in x, 2 up / gap in
    y, 3 diagonal, 4 the origin)."""
    n, m = len(x), len(y)
    matrix = np.zeros((n + 1, m + 1), np.int32)
    matrix[0, :] = np.arange(m + 1) * GAP
    matrix[:, 0] = np.arange(n + 1) * GAP
    trace = np.zeros((n + 1, m + 1), np.int32)
    trace[0, 1:] = 1
    trace[1:, 0] = 2
    trace[0, 0] = 4
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            left = matrix[i, j - 1] + GAP
            up = matrix[i - 1, j] + GAP
            diag = matrix[i - 1, j - 1] + (MATCH if x[i - 1] == y[j - 1]
                                           else MISMATCH)
            best = max(left, up, diag)
            matrix[i, j] = best
            # ties go left, then up, then diagonal
            if best == left:
                trace[i, j] = 1
            elif best == up:
                trace[i, j] = 2
            else:
                trace[i, j] = 3
    return trace


def aligned_mapper(x: Sequence[int], y: Sequence[int]) -> np.ndarray:
    """``[len(y), 2]`` pairs (y position, x position), -1 where y's token
    has no source in x."""
    trace = global_align(x, y)
    i, j = len(x), len(y)
    pairs: List[Tuple[int, int]] = []
    while i > 0 or j > 0:
        t = trace[i, j]
        if t == 3:
            i -= 1
            j -= 1
            pairs.append((j, i))
        elif t == 1:
            j -= 1
            pairs.append((j, -1))
        elif t == 2:
            i -= 1
        else:
            break
    pairs.reverse()
    return np.asarray(pairs, np.int64).reshape(-1, 2)


def get_mapper(x_ids: Sequence[int], y_ids: Sequence[int], max_len: int = 77
               ) -> Tuple[np.ndarray, np.ndarray]:
    """``(mapper [max_len] int64, alphas [max_len] float32)``: y's padded
    positions map to x's by the alignment, the padding past y onto itself
    shifted; alpha is 0 where y's token has no source."""
    base = aligned_mapper(list(x_ids), list(y_ids))
    alphas = np.ones(max_len, np.float32)
    alphas[: base.shape[0]] = (base[:, 1] != -1).astype(np.float32)
    mapper = np.zeros(max_len, np.int64)
    mapper[: base.shape[0]] = base[:, 1]
    mapper[base.shape[0]:] = len(y_ids) + np.arange(max_len - len(y_ids))
    return mapper, alphas


def get_refinement_mapper(prompts: Sequence[str], tokenizer, max_len: int = 77
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """``[P-1, max_len]`` mappers and alphas between ``prompts[0]`` and each
    edit, over ``[BOT] + tokens + [EOT]``."""
    def enc(p):
        return [tokenizer.BOT] + tokenizer.encode_text(p) + [tokenizer.EOT]

    x_ids = enc(prompts[0])
    mappers, alphas = [], []
    for p in prompts[1:]:
        m, a = get_mapper(x_ids, enc(p), max_len)
        mappers.append(m)
        alphas.append(a)
    return np.stack(mappers), np.stack(alphas)


def get_word_inds(text: str, word_place: Union[int, str], tokenizer
                  ) -> np.ndarray:
    """Token positions (1-based: position 0 is BOT) of the word at index
    ``word_place`` of ``text.split(" ")``, or of every word equal to it
    when it is a string.  Each word counts the tokens it encodes to alone
    (at least one)."""
    split_text = text.split(" ")
    if isinstance(word_place, str):
        places = [i for i, w in enumerate(split_text) if w == word_place]
    else:
        places = [word_place]
    out = []
    ptr = 1
    for wi, word in enumerate(split_text):
        n = max(len(tokenizer.encode_text(word)), 1)
        if wi in places:
            out.extend(range(ptr, ptr + n))
        ptr += n
    return np.asarray(out, np.int64)


def get_replacement_mapper_(x: str, y: str, tokenizer, max_len: int = 77
                            ) -> np.ndarray:
    """``[max_len, max_len]`` map from x's token positions to y's for
    prompts of equal word counts; the words that differ map onto each
    other, spread as 1 / len(target) where their token counts differ."""
    words_x = x.split(" ")
    words_y = y.split(" ")
    if len(words_x) != len(words_y):
        raise ValueError(
            "attention replacement edit needs equal-length prompts; got "
            f"{len(words_x)} vs {len(words_y)} words")
    inds_replace = [i for i in range(len(words_y)) if words_y[i] != words_x[i]]
    inds_source = [get_word_inds(x, i, tokenizer) for i in inds_replace]
    inds_target = [get_word_inds(y, i, tokenizer) for i in inds_replace]
    mapper = np.zeros((max_len, max_len), np.float32)
    i = j = 0
    cur = 0
    while i < max_len and j < max_len:
        if (cur < len(inds_source) and len(inds_source[cur])
                and inds_source[cur][0] == i):
            src, tgt = inds_source[cur], inds_target[cur]
            if len(src) == len(tgt):
                mapper[src, tgt] = 1.0
            else:
                ratio = 1.0 / len(tgt)
                for t in tgt:
                    mapper[src, t] = ratio
            cur += 1
            i += len(src)
            j += len(tgt)
        elif cur < len(inds_source):
            mapper[i, j] = 1.0
            i += 1
            j += 1
        else:
            # past the last replaced word the diagonal continues at j, as
            # in the JAX package
            mapper[j, j] = 1.0
            i += 1
            j += 1
    return mapper


def get_replacement_mapper(prompts: Sequence[str], tokenizer,
                           max_len: int = 77) -> np.ndarray:
    """``[P-1, max_len, max_len]``: ``get_replacement_mapper_`` from
    ``prompts[0]`` to each edit."""
    return np.stack([get_replacement_mapper_(prompts[0], p, tokenizer,
                                             max_len)
                     for p in prompts[1:]])
