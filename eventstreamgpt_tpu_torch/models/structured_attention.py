"""Dependency-graph structured attention.

Counterpart: ``eventstreamgpt_tpu/models/structured_attention.py``. Each
event's whole-event element (the last dep-graph slot) goes through the
sequence module; the contextualized events, shifted right by one event,
become each event's history, prepended to its graph as a key/value-only
position 0; the graph's last slot is replaced by the contextualized event;
and the dep-graph module runs over the ``(B * L, G + 1)`` flattened graphs.
Padding events are processed and zeroed afterwards, as in the JAX model.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.tensor_ops import segment_starts


class StructuredAttention(nn.Module):
    """Wraps a sequence module and a dep-graph module, each given as
    ``(flax name, module)``: an `InnerAttention` or an `InnerBlock`."""

    def __init__(self, seq_module: tuple[str, nn.Module], dep_graph_module: tuple[str, nn.Module]):
        super().__init__()
        self.seq_name, self.dep_name = seq_module[0], dep_graph_module[0]
        setattr(self, self.seq_name, seq_module[1])
        setattr(self, self.dep_name, dep_graph_module[1])

    def forward(self, hidden_states, seq_attention_mask=None, event_mask=None, segment_ids=None, dropout_rng=None):
        """``hidden_states`` ``(B, L, G, E)`` -> ``(B, L, G, E)``."""
        B, L, _, E = hidden_states.shape
        per_event = hidden_states[:, :, -1]
        if event_mask is not None:
            per_event = torch.where(event_mask[..., None], per_event, 0.0)
        contextualized, _ = getattr(self, self.seq_name)(
            per_event, attention_mask=seq_attention_mask, segment_ids=segment_ids, dropout_rng=dropout_rng
        )
        if event_mask is not None:
            contextualized = torch.where(event_mask[..., None], contextualized, 0.0)
        # History before event i: contextualized event i - 1 (zeros for i = 0
        # and, in packed rows, at each segment's first event).
        history = torch.cat([torch.zeros_like(contextualized[:, :1]), contextualized[:, :-1]], dim=1)
        if segment_ids is not None:
            history = torch.where(segment_starts(segment_ids)[..., None], 0.0, history)
        graph = torch.cat([history[:, :, None], hidden_states[:, :, :-1], contextualized[:, :, None]], dim=2)
        out, _ = getattr(self, self.dep_name)(
            graph.reshape(B * L, -1, E), attention_mask=None, static_kv_first=True, dropout_rng=dropout_rng
        )
        out = out.reshape(B, L, -1, E)
        if event_mask is not None:
            out = torch.where(event_mask[:, :, None, None], out, 0.0)
        return out
