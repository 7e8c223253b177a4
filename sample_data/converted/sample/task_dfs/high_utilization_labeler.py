"""Zero-shot labeler for the sample ``high_utilization`` task.

Classifies a *generated* continuation by its event count: subjects whose
generated future contains at least ``EVENT_THRESHOLD`` real events are
labeled positive. Mechanical by construction (the shipped cohort is
synthetic); demonstrates the ``Labeler`` contract the way the reference's
MIMIC tutorial labeler does (docs/tutorial/zero_shot.md).
"""

import numpy as np

from eventstreamgpt_tpu_torch.models.zero_shot_labeler import Labeler

EVENT_THRESHOLD = 4


class TaskLabeler(Labeler):
    def __call__(self, batch, input_seq_len: int):
        future_mask = np.asarray(batch.event_mask)[:, input_seq_len:]
        n_future = future_mask.sum(axis=1)
        positive = n_future >= EVENT_THRESHOLD

        labels = np.zeros((len(positive), 2), dtype=np.float32)
        labels[np.arange(len(positive)), positive.astype(np.int64)] = 1.0
        unpredictable = np.zeros(len(positive), dtype=bool)
        return labels, unpredictable
