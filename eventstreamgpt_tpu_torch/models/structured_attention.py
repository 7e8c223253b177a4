"""Dependency-graph structured attention.

Counterpart: ``eventstreamgpt_tpu/models/structured_attention.py``. Each
event's whole-event element (the last dep-graph slot) goes through the
sequence module; the contextualized events, shifted right by one event,
become each event's history, prepended to its graph as a key/value-only
position 0; the graph's last slot is replaced by the contextualized event;
and the dep-graph module runs over the ``(B * L, G + 1)`` flattened graphs.
Padding events are processed and zeroed afterwards, as in the JAX model.

The NA cached walk turns two of these steps off, as the JAX module's flags
do: without ``prepend_graph_with_history_embeddings`` the graph has no
history position (the dep-graph cache holds it); without
``update_last_graph_el_to_history_embedding`` as well, the sequence module
is skipped and the graph is the input as it is.

Speculative decoding's verify window (JAX's ``history_head`` and
``return_contextualized``): ``history_head`` ``(B, E)`` replaces the zeros
of position 0's history, so a window that starts mid-subject sees the
history the sequential walk saw; the contextualized events come back
beside the output.
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

    def forward(
        self,
        hidden_states,
        seq_attention_mask=None,
        event_mask=None,
        segment_ids=None,
        dropout_rng=None,
        seq_module_kwargs: dict | None = None,
        dep_graph_module_kwargs: dict | None = None,
        prepend_graph_with_history_embeddings: bool = True,
        update_last_graph_el_to_history_embedding: bool = True,
        history_head=None,
    ):
        """``hidden_states`` ``(B, L, G, E)`` -> ``((B, L, G', E), seq present,
        dep-graph present, contextualized)``; the module kwargs
        (``layer_past``, ``use_cache``) go to the sequence and the dep-graph
        module, whose caches come back (``None`` where a module kept none or
        did not run), and ``contextualized`` ``(B, L, E)`` is the sequence
        module's output (``None`` where it did not run)."""
        B, L, _, E = hidden_states.shape
        seq_present = contextualized = None
        static_kv_first = False
        graph = hidden_states
        if prepend_graph_with_history_embeddings or update_last_graph_el_to_history_embedding:
            per_event = hidden_states[:, :, -1]
            if event_mask is not None:
                per_event = torch.where(event_mask[..., None], per_event, 0.0)
            contextualized, seq_present = getattr(self, self.seq_name)(
                per_event, attention_mask=seq_attention_mask, segment_ids=segment_ids, dropout_rng=dropout_rng,
                **(seq_module_kwargs or {}),
            )  # fmt: skip
            if event_mask is not None:
                contextualized = torch.where(event_mask[..., None], contextualized, 0.0)
            parts = [hidden_states[:, :, :-1], contextualized[:, :, None]]
            if not update_last_graph_el_to_history_embedding:
                parts = [hidden_states]
            if prepend_graph_with_history_embeddings:
                # History before event i: contextualized event i - 1 (for i = 0
                # ``history_head`` or zeros; zeros at a packed segment's first event).
                head = torch.zeros_like(contextualized[:, :1]) if history_head is None else history_head[:, None]
                history = torch.cat([head.to(contextualized.dtype), contextualized[:, :-1]], dim=1)
                if segment_ids is not None:
                    history = torch.where(segment_starts(segment_ids)[..., None], 0.0, history)
                parts.insert(0, history[:, :, None])
                static_kv_first = True
            graph = torch.cat(parts, dim=2)
        out, dep_present = getattr(self, self.dep_name)(
            graph.reshape(B * L, -1, E), attention_mask=None, static_kv_first=static_kv_first, dropout_rng=dropout_rng,
            **(dep_graph_module_kwargs or {}),
        )  # fmt: skip
        out = out.reshape(B, L, -1, E)
        if event_mask is not None:
            out = torch.where(event_mask[:, :, None, None], out, 0.0)
        return out, seq_present, dep_present, contextualized
