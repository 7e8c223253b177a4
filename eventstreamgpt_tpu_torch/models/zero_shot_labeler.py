"""The zero-shot labeler functor API.

Counterpart: ``eventstreamgpt_tpu/models/zero_shot_labeler.py``. Users
subclass `Labeler` in a file named ``{task_df_name}_labeler.py`` in the
dataset's ``task_dfs/`` directory (class name ``TaskLabeler``); the zero-shot
evaluator imports it and applies it to generated batches. A labeler written
for the JAX package imports that package's ``Labeler``;
`data.dl_cache.convert_dl_cache` copies it with that import pointed here.
Labels are made on the host (numpy): the evaluator hands a labeler CPU
tensors, which ``np.asarray`` reads.
"""

from __future__ import annotations

import abc

import numpy as np

from ..data.types import EventStreamBatch
from .config import StructuredTransformerConfig


class Labeler(abc.ABC):
    """Base class for zero-shot labeler functors.

    Attributes:
        config: The model config: vocabulary sizes, offsets and idxmaps to
            decode generated indices into task labels.
    """

    def __init__(self, config: StructuredTransformerConfig):
        self.config = config

    @abc.abstractmethod
    def __call__(self, batch: EventStreamBatch, input_seq_len: int) -> tuple[np.ndarray, np.ndarray]:
        """Labels each generated sequence.

        Args:
            batch: the completed batch: ``batch[:, :input_seq_len]`` is the
                original input, ``batch[:, input_seq_len:]`` the generated
                continuation.
            input_seq_len: events in the original input (padding included).

        Returns:
            A ``(batch_size, num_labels)`` one-hot label array and a
            ``(batch_size,)`` bool array marking the samples whose label
            could NOT be determined from the generated events.
        """
        raise NotImplementedError("Must be overwritten by a subclass!")
