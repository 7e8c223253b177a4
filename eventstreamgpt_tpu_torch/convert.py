"""Moving parameters between JAX (flax) trees and the port's modules.

`load_jax_params` takes the flax parameter tree of a
``CIPPTForGenerativeSequenceModeling``, a ``NAPPTForGenerativeSequenceModeling``
or a fine-tuning ``ESTForStreamClassification`` (``encoder`` and
``logit_layer``), or of any module whose attribute paths follow the flax
names, such as a ``DataEmbeddingLayer``, as a nested dict of numpy arrays
(the caller does the ``np.asarray``; this module imports no JAX) and fills
the port model's parameters in place:

* a Dense ``kernel`` ``(in, out)`` becomes ``Linear.weight`` ``(out, in)``;
* a LayerNorm ``scale``/``bias`` becomes ``weight``/``bias``;
* embedding tables and biases carry across as they are.

Every flax leaf must land on exactly one port parameter of the same shape,
and every port parameter must be filled; anything else raises.
`export_params` is the inverse: the port model's parameters as a flax-shaped
tree of fp32 numpy arrays.

Scan-over-layers. A ``scan_layers=True`` flax tree holds an encoder's layers
as one ``h_scan`` scope whose children ``b0 .. b{p-1}`` stack layer
``g * p + j`` as group ``g`` along a new leading axis (JAX's
`stack_layer_params`). The port builds the per-layer modules ``h{i}`` either
way, so every function here takes that tree too: `unstack_layer_params`
splits it back into ``h{i}`` in numpy as JAX's `unstack_layer_params` does
(bit for bit; the AdamW moments of a scanned resume step likewise), and
`export_params` of a ``scan_layers`` model stacks it (`stack_layer_params`,
``models.transformer.scan_period``), the tree JAX's scanned model loads. `checkpoint_from_jax` writes JAX parameters as a
port checkpoint directory (`training.checkpoint.save_pretrained`);
`train_state_from_jax` turns a JAX resume step (parameters, AdamW moments,
counts) into the port's resume state. Both build the model the tree is of
(`model_for_tree`): the stream classifier when it holds a ``logit_layer``,
else the generative model of the config.
"""

from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn

from .models.transformer import LayerNorm, scan_period

_LAYER_KEY = re.compile(r"^h(\d+)$")


def unstack_layer_params(tree: dict) -> dict:
    """``tree`` with every ``h_scan`` scope (children ``b{j}``, leaves stacked
    ``(n_groups, ...)``) replaced by the per-layer scopes ``h{g * p + j}``,
    ``p`` the number of children (JAX's `unstack_layer_params`); a tree
    without one comes back as it is.

    Examples:
        >>> b0, b1 = {"w": np.arange(4).reshape(2, 2)}, {"w": np.ones((2, 2))}
        >>> t = unstack_layer_params({"h_scan": {"b0": b0, "b1": b1}})
        >>> sorted(t), t["h2"]["w"].tolist()
        (['h0', 'h1', 'h2', 'h3'], [2, 3])
    """
    if not isinstance(tree, dict):
        return tree
    out = {k: unstack_layer_params(v) for k, v in tree.items() if k != "h_scan"}
    if isinstance(tree.get("h_scan"), dict):
        groups = tree["h_scan"]
        p = len(groups)
        for j in range(p):
            flat = _flatten(groups[f"b{j}"])
            for g in range(len(next(iter(flat.values())))):
                out[f"h{g * p + j}"] = _unflatten({path: arr[g] for path, arr in flat.items()})
    return out


def stack_layer_params(tree: dict, config) -> dict:
    """``tree`` with the per-layer scopes ``h0 .. h{L-1}`` of every scope
    that holds them all replaced by one ``h_scan`` scope: ``b{j}`` stacks
    layer ``g * p + j`` as group ``g`` (JAX's `stack_layer_params`, ``p`` and
    the groups from ``scan_period(config)``)."""
    L = config.num_hidden_layers
    p, G = scan_period(config)
    if not isinstance(tree, dict):
        return tree
    if not all(f"h{i}" in tree for i in range(L)):
        return {k: stack_layer_params(v, config) for k, v in tree.items()}
    out = {k: stack_layer_params(v, config) for k, v in tree.items() if not _LAYER_KEY.match(str(k))}
    out["h_scan"] = {}
    for j in range(p):
        layers = [_flatten(tree[f"h{g * p + j}"]) for g in range(G)]
        out["h_scan"][f"b{j}"] = _unflatten({path: np.stack([lay[path] for lay in layers]) for path in layers[0]})
    return out


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for path, arr in flat.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = arr
    return tree


def _flatten(tree: dict, prefix: tuple = ()) -> dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def port_name(path: tuple) -> tuple[str, bool]:
    """The port parameter name of a flax leaf path, and whether to transpose.

    Examples:
        >>> port_name(("encoder", "h0", "attn", "attention", "q_proj", "kernel"))
        ('encoder.h0.attn.attention.q_proj.weight', True)
        >>> port_name(("encoder", "ln_f", "scale"))
        ('encoder.ln_f.weight', False)
    """
    *parents, leaf = path
    if leaf == "kernel":
        return ".".join(parents + ["weight"]), True
    if leaf == "scale":
        return ".".join(parents + ["weight"]), False
    return ".".join(parents + [leaf]), False


def load_jax_params(model: nn.Module, params: dict) -> nn.Module:
    """Fills ``model``'s parameters from a flax tree of numpy arrays, unrolled
    or scanned (`unstack_layer_params`); returns ``model``."""
    if set(params) == {"params"}:
        params = params["params"]
    params = unstack_layer_params(params)
    targets = dict(model.named_parameters())
    filled = set()
    for path, arr in _flatten(params).items():
        name, transpose = port_name(path)
        if name not in targets:
            raise ValueError(f"flax leaf {'/'.join(path)} has no port parameter ({name})")
        if transpose:
            if arr.ndim != 2:
                raise ValueError(f"flax kernel {'/'.join(path)} is not 2-D: {arr.shape}")
            arr = arr.T
        p = targets[name]
        if tuple(p.shape) != arr.shape:
            raise ValueError(f"{name}: port shape {tuple(p.shape)} != flax shape {arr.shape}")
        with torch.no_grad():
            p.copy_(torch.tensor(arr))
        filled.add(name)
    missing = sorted(set(targets) - filled)
    if missing:
        raise ValueError(f"port parameters left unfilled by the flax tree: {missing}")
    return model


def export_params(model: nn.Module) -> dict:
    """``{"params": tree}`` of fp32 numpy arrays under the flax names
    (`load_jax_params`' inverse: a Linear ``weight`` goes out transposed as
    ``kernel``, a LayerNorm ``weight`` as ``scale``), in the scanned layout
    (`stack_layer_params`) when the model's config sets ``scan_layers``."""
    tree: dict = {}
    for module_name, module in model.named_modules():
        for name, p in module.named_parameters(recurse=False):
            arr = p.detach().to(torch.float32).cpu().numpy()
            if isinstance(module, nn.Linear) and name == "weight":
                name, arr = "kernel", arr.T
            elif isinstance(module, LayerNorm) and name == "weight":
                name = "scale"
            node = tree
            for key in module_name.split(".") if module_name else []:
                node = node.setdefault(key, {})
            node[name] = arr
    config = getattr(model, "config", None)
    if config is not None and getattr(config, "scan_layers", False):
        tree = stack_layer_params(tree, config)
    return {"params": tree}


def _port_config(config):
    from .models.config import StructuredTransformerConfig

    if not isinstance(config, StructuredTransformerConfig):
        config = StructuredTransformerConfig.from_dict(config.to_dict())
    return config


def model_for_tree(config, params: dict) -> nn.Module:
    """The port model a flax tree is of: ``ESTForStreamClassification`` when
    the tree holds a ``logit_layer``, else `training.pretrain.build_model`'s
    generative model of ``config`` (the port's configuration, or any object
    whose ``to_dict()`` gives its fields, such as JAX's); unrolled or scanned."""
    from .models.fine_tuning_model import ESTForStreamClassification
    from .training.pretrain import build_model

    config = _port_config(config)
    if set(params) == {"params"}:
        params = params["params"]
    return ESTForStreamClassification(config) if "logit_layer" in params else build_model(config)


def checkpoint_from_jax(params: dict, config, save_dir):
    """Writes JAX parameters (the flax tree as numpy arrays) as the port's
    checkpoint under ``save_dir``: the model of the tree and ``config``
    (`model_for_tree`), filled by `load_jax_params`, then
    `training.checkpoint.save_pretrained` with the config. Returns the
    weights directory."""
    from .training.checkpoint import save_pretrained

    config = _port_config(config)
    model = load_jax_params(model_for_tree(config, params), params)
    return save_pretrained(save_dir, model, config)


def init_params_from_seed(model: nn.Module, seed: int, std: float = 0.02) -> nn.Module:
    """Fills every parameter with numpy-seeded random values (weights for
    smoke runs and tests that need no trained checkpoint).

    LayerNorm scales start at 1 and their biases at 0, as in flax; every
    other parameter is ``N(0, std)``. The values depend only on ``seed`` and
    the parameter names, never on torch's global generator.
    """
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("layer_norm.weight") or name.endswith("ln_f.weight"):
                p.fill_(1.0)
            elif name.endswith("layer_norm.bias") or name.endswith("ln_f.bias"):
                p.zero_()
            else:
                p.copy_(torch.from_numpy(rng.normal(0.0, std, size=tuple(p.shape)).astype(np.float32)))
    return model


def train_state_from_jax(config, params: dict, mu: dict, nu: dict, count: int, step: int) -> dict:
    """A JAX resume step as the port's resume state (`training.pretrain.train_state_dict`'s layout).

    ``params``, ``mu`` and ``nu`` are the flax trees of the parameters and of
    optax AdamW's first and second moments (``opt_state[0].mu`` / ``.nu``),
    ``count`` its update count and ``step`` ``TrainState.step``, all as
    numpy (the caller restores them; this module imports no JAX). The
    moments cross over as the parameters do (`port_name`); AdamW's step and
    the scheduler's position are ``count``. The result goes to
    `training.checkpoint.TrainCheckpointManager.save`. A fine-tuning tree
    gives the stream classifier's state (`model_for_tree`); a scanned tree
    and its stacked moments are unstacked (`unstack_layer_params`)."""
    names = set(dict(model_for_tree(config, params).named_parameters()))

    def port_tree(tree: dict) -> dict:
        if set(tree) == {"params"}:
            tree = tree["params"]
        out = {}
        for path, arr in _flatten(unstack_layer_params(tree)).items():
            name, transpose = port_name(path)
            out[name] = torch.tensor(np.ascontiguousarray(arr.T if transpose else arr), dtype=torch.float32)
        if set(out) != names:
            raise ValueError(f"the flax tree does not match the port model: {sorted(set(out) ^ names)}")
        return out

    return {
        "step": int(step),
        "scheduler_step": int(count),
        "params": port_tree(params),
        "adam": {
            "step": {n: torch.tensor(float(count)) for n in sorted(names)},
            "exp_avg": port_tree(mu),
            "exp_avg_sq": port_tree(nu),
        },
    }
