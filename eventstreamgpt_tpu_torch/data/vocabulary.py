"""Frequency-ordered vocabularies for categorical measurements.

Counterpart: ``eventstreamgpt_tpu/data/vocabulary.py``, copied (it is numpy
only). Index 0 is always the ``'UNK'`` sentinel, the remaining elements are
sorted by decreasing observed frequency (ties broken by element,
descending), ``filter`` folds dropped probability mass into UNK, and
``__getitem__`` is bidirectional (element→index, index→element).
"""

from __future__ import annotations

import copy
import dataclasses
import math
from functools import cached_property
from io import TextIOBase
from textwrap import shorten, wrap
from typing import Generic, TypeVar, Union

import numpy as np

COUNT_OR_PROPORTION = Union[int, float]


def num_initial_spaces(s: str) -> int:
    """The number of leading spaces of ``s``.

    Examples:
        >>> num_initial_spaces("  a b")
        2
    """
    return len(s) - len(s.lstrip(" "))


VOCAB_ELEMENT = TypeVar("VOCAB_ELEMENT")
NESTED_VOCAB_SEQUENCE = Union[VOCAB_ELEMENT, list]

_SPARK_BLOCKS = "▁▂▃▄▅▆▇█"


def sparkline(values: list[float]) -> str:
    """Renders values as a unicode block sparkline (0..max scaled).

    Examples:
        >>> sparkline([0.4, 0.3, 0.1])
        '█▆▁'
    """
    vals = np.asarray(values, dtype=float)
    if len(vals) == 0:
        return ""
    lo, hi = float(np.nanmin(vals)), float(np.nanmax(vals))
    if hi == lo:
        return _SPARK_BLOCKS[-1] * len(vals)
    scaled = (vals - lo) / (hi - lo)
    idx = np.clip((scaled * (len(_SPARK_BLOCKS) - 1)).round().astype(int), 0, len(_SPARK_BLOCKS) - 1)
    return "".join(_SPARK_BLOCKS[i] for i in idx)


@dataclasses.dataclass
class Vocabulary(Generic[VOCAB_ELEMENT]):
    """A frequency-sorted vocabulary with a mandatory UNK element at index 0.

    Examples:
        >>> vocab = Vocabulary(vocabulary=['apple', 'banana', 'UNK'], obs_frequencies=[3, 5, 2])
        >>> vocab.vocabulary
        ['UNK', 'banana', 'apple']
        >>> vocab.obs_frequencies
        [0.2, 0.5, 0.3]
        >>> vocab.idxmap
        {'UNK': 0, 'banana': 1, 'apple': 2}
        >>> vocab[1]
        'banana'
        >>> vocab['apple']
        2
        >>> vocab['zebra']
        0
        >>> len(vocab)
        3
    """

    vocabulary: list[str] | None = None
    obs_frequencies: "np.ndarray | list[float] | None" = None

    def __post_init__(self):
        if len(self.vocabulary) == 0:
            raise ValueError("Empty vocabularies are not supported.")
        if len(self.vocabulary) != len(self.obs_frequencies):
            raise ValueError(
                "self.vocabulary and self.obs_frequencies must have the same length. Got "
                f"{len(self.vocabulary)} and {len(self.obs_frequencies)}."
            )
        vocab_set = set(self.vocabulary)
        if len(self.vocabulary) != len(vocab_set):
            raise ValueError(
                f"Vocabulary has duplicates. len(self.vocabulary) = {len(self.vocabulary)}, but "
                f"len(set(self.vocabulary)) = {len(vocab_set)}."
            )
        self.element_types = {type(v) for v in self.vocabulary if v != "UNK"}
        if int in self.element_types:
            raise ValueError("Integer elements in the vocabulary are not supported.")

        freqs = np.asarray(self.obs_frequencies, dtype=float)
        freqs = freqs / freqs.sum()

        vocab = copy.deepcopy(self.vocabulary)
        if "UNK" in vocab_set:
            unk_index = vocab.index("UNK")
            unk_freq = freqs[unk_index]
            freqs = np.delete(freqs, unk_index)
            del vocab[unk_index]
        else:
            unk_freq = 0.0

        # Decreasing frequency; ties broken by element, descending (lexsort parity
        # with reference ``vocabulary.py:183``).
        idx = np.lexsort((vocab, freqs))[::-1]
        self.vocabulary = ["UNK"] + [vocab[i] for i in idx]
        self.obs_frequencies = np.concatenate(([unk_freq], freqs[idx])).tolist()

    @cached_property
    def idxmap(self) -> dict[VOCAB_ELEMENT, int]:
        """Mapping from vocabulary element to its integer index."""
        return {v: i for i, v in enumerate(self.vocabulary)}

    def __getitem__(self, q):
        if type(q) is int:
            return self.vocabulary[q]
        if (type(q) not in self.element_types) and (q != "UNK"):
            raise TypeError(f"Type {type(q)} is not a valid type for this vocabulary.")
        return self.idxmap.get(q, 0)

    def __len__(self) -> int:
        return len(self.vocabulary)

    def __eq__(self, other) -> bool:
        return (
            (type(self) is type(other))
            and (self.vocabulary == other.vocabulary)
            and (np.array(self.obs_frequencies).round(3) == np.array(other.obs_frequencies).round(3)).all()
        )

    def extend_with_counts(
        self, counts: dict[VOCAB_ELEMENT, int], prior_total: int
    ) -> list[str]:
        """Append-only vocabulary growth for the incremental-fit path.

        EXISTING INDICES ARE FROZEN: no element moves, whatever the merged
        frequencies say (the DL cache stores indices; re-sorting would
        silently corrupt every cached row). Unseen elements are appended
        AFTER the current vocabulary, ordered by (count desc, element desc)
        — the same tie-break rule the from-scratch fit uses within its
        frequency sort. ``prior_total`` is the observation count behind the
        current ``obs_frequencies`` (persisted in the cache's
        sufficient-statistics sidecar) so the merged frequencies stay
        honest. Returns the appended elements in index order.

        Examples:
            >>> v = Vocabulary(vocabulary=["apple", "banana", "UNK"], obs_frequencies=[3, 5, 2])
            >>> v.vocabulary
            ['UNK', 'banana', 'apple']
            >>> v.extend_with_counts({"pear": 40, "banana": 10}, prior_total=10)
            ['pear']
            >>> v.vocabulary  # banana gained mass but kept its index
            ['UNK', 'banana', 'apple', 'pear']
            >>> [round(f, 3) for f in v.obs_frequencies]
            [0.033, 0.25, 0.05, 0.667]
        """
        counts = {k: int(c) for k, c in counts.items() if c}
        merged = np.asarray(self.obs_frequencies, dtype=float) * float(prior_total)
        idxmap = self.idxmap
        new_elements: list = []
        for el, c in counts.items():
            if el in idxmap:
                merged[idxmap[el]] += c
            else:
                new_elements.append(el)
        new_elements.sort(key=lambda el: (counts[el], str(el)), reverse=True)

        self.vocabulary = list(self.vocabulary) + new_elements
        merged = np.concatenate(
            [merged, np.asarray([counts[el] for el in new_elements], dtype=float)]
        )
        total = merged.sum()
        self.obs_frequencies = (merged / total if total > 0 else merged).tolist()
        self.element_types |= {type(el) for el in new_elements if el != "UNK"}
        self.__dict__.pop("idxmap", None)
        return new_elements

    def filter(self, total_observations: int | None, min_valid_element_freq: COUNT_OR_PROPORTION) -> None:
        """Drops elements rarer than the cutoff, folding their mass into UNK.

        Reference contract: ``vocabulary.py:186-231``; UNK survives regardless
        of its own frequency.

        Examples:
            >>> vocab = Vocabulary(vocabulary=['apple', 'banana', 'UNK'], obs_frequencies=[5, 3, 2])
            >>> vocab.filter(total_observations=10, min_valid_element_freq=0.4)
            >>> vocab.vocabulary
            ['UNK', 'apple']
            >>> vocab.obs_frequencies
            [0.5, 0.5]
        """
        if type(min_valid_element_freq) is not float:
            min_valid_element_freq /= total_observations

        freqs = np.array(self.obs_frequencies)
        # Number of non-UNK elements with frequency >= cutoff. Frequencies after
        # index 0 are sorted descending, so searchsorted on the negated array
        # finds the boundary.
        keep_n = int(np.searchsorted(-freqs[1:], -min_valid_element_freq, side="right"))

        freqs[0] += freqs[keep_n + 1 :].sum()
        self.vocabulary = self.vocabulary[: keep_n + 1]
        self.obs_frequencies = freqs[: keep_n + 1].tolist()
        self.__dict__.pop("idxmap", None)

    def describe(
        self,
        line_width: int = 60,
        wrap_lines: bool = True,
        n_head: int = 3,
        n_tail: int = 2,
        stream: TextIOBase | None = None,
    ) -> int | None:
        """Prints a text summary: size, UNK rate, sparkline, head/tail elements.

        Examples:
            >>> vocab = Vocabulary(
            ...     vocabulary=['apple', 'banana', 'pear', 'UNK'],
            ...     obs_frequencies=[3, 4, 1, 2],
            ... )
            >>> vocab.describe(n_head=2, n_tail=1, wrap_lines=False)
            4 elements, 20.0% UNKs
            Frequencies: █▆▁
            Elements:
              (40.0%) banana
              (30.0%) apple
              (10.0%) pear
        """
        lines = []
        lines.append(f"{len(self)} elements, {self.obs_frequencies[0] * 100:.1f}% UNKs")

        sparkline_prefix = "Frequencies:"
        W = line_width - len(sparkline_prefix) - 2
        if W > len(self):
            freqs = self.obs_frequencies[1:]
        else:
            freqs = self.obs_frequencies[1 : len(self) : int(math.ceil(len(self) / W))]
        lines.append(f"{sparkline_prefix} {sparkline(freqs)}")

        if len(self) - 1 <= (n_head + n_tail):
            lines.append("Elements:")
            for v, f in zip(self.vocabulary[1:], self.obs_frequencies[1:]):
                lines.append(f"  ({f * 100:.1f}%) {v}")
        else:
            lines.append("Examples:")
            for i in range(n_head):
                lines.append(f"  ({self.obs_frequencies[i + 1] * 100:.1f}%) {self.vocabulary[i + 1]}")
            lines.append("  ...")
            for i in range(n_tail):
                lines.append(
                    f"  ({self.obs_frequencies[-n_tail + i] * 100:.1f}%) {self.vocabulary[-n_tail + i]}"
                )

        line_indents = [num_initial_spaces(line) for line in lines]
        if wrap_lines:
            new_lines = []
            for line, ind in zip(lines, line_indents):
                new_lines.extend(wrap(line, width=line_width, initial_indent="", subsequent_indent=" " * ind))
            lines = new_lines
        else:
            lines = [
                shorten(line, width=line_width, initial_indent=" " * ind)
                for line, ind in zip(lines, line_indents)
            ]

        desc = "\n".join(lines)
        if stream is None:
            print(desc)
            return None
        return stream.write(desc)
