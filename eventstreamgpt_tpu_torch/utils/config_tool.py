"""A structured-config store with YAML files, ``${...}`` interpolation and
hydra-style ``key.sub=value`` overrides.

Counterpart: ``eventstreamgpt_tpu/utils/config_tool.py``, with
``load_yaml_with_defaults`` and ``CONFIGS_DIR`` from the JAX package's
``scripts/build_dataset.py``. The same behaviour, quirks included, on
`utils.yaml_subset` instead of PyYAML (the card's machine has none):

* `config_dataclass` registers a dataclass in `CONFIG_STORE` under its
  snake_case name (``PretrainConfig`` as ``pretrain_config``).
* `load_config` builds a registered config from its declared defaults, an
  optional YAML file and ``a.b.c=value`` overrides (``~key`` sets None,
  ``+key=`` and ``~key=`` set), coerced to the dataclass annotations.
* ``${key}``, ``${now:%fmt}`` and ``${oc.env:VAR[,default]}`` resolve in
  string values.

One difference, a repair: `coerce_to_signature` gives the untyped
``config`` dicts (`StructuredTransformerConfig` keyword arguments) the
scalar types that the class annotates, so ``config.resid_dropout=1e-05``
(a string under YAML 1.1) reaches the model as a float; JAX passes the
string on.
"""

from __future__ import annotations

import dataclasses
import datetime
import enum
import os
import re
import types
import typing
from pathlib import Path
from typing import Any, Callable, TypeVar

from . import yaml_subset

T = TypeVar("T")

CONFIG_STORE: dict[str, type] = {}

#: The repository's ``configs/`` folder (hydra's config directory).
CONFIGS_DIR = Path(__file__).resolve().parents[2] / "configs"


def _snake_case(name: str) -> str:
    return re.sub(r"(?<!^)(?=[A-Z])", "_", name).lower()


def config_dataclass(cls: type[T]) -> type[T]:
    """Makes ``cls`` a dataclass (if it is not one) and registers it in
    `CONFIG_STORE` under its snake_case name."""
    if not dataclasses.is_dataclass(cls):
        cls = dataclasses.dataclass(cls)
    CONFIG_STORE[_snake_case(cls.__name__)] = cls
    return cls


def _strip_optional(tp: Any) -> Any:
    origin = typing.get_origin(tp)
    if origin in (typing.Union, types.UnionType):
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return args[0]
    return tp


def _coerce(value: Any, tp: Any) -> Any:
    """Coerces a YAML/CLI value to the annotated type where unambiguous."""
    tp = _strip_optional(tp)
    if value is None:
        return None
    origin = typing.get_origin(tp)
    if origin in (typing.Union, types.UnionType):
        return value
    if tp is Any or tp is dataclasses.MISSING:
        return value
    if isinstance(tp, type):
        if issubclass(tp, enum.Enum):
            return tp(value) if not isinstance(value, tp) else value
        if dataclasses.is_dataclass(tp):
            if isinstance(value, tp):
                return value
            if isinstance(value, dict):
                return structure(value, tp)
            return value
        if tp is Path:
            return Path(value)
        if tp is bool and isinstance(value, str):
            return value.lower() in ("true", "1", "yes")
        if tp in (int, float, str) and not isinstance(value, (dict, list)):
            return tp(value)
    if origin in (list, tuple) and isinstance(value, (list, tuple)):
        args = typing.get_args(tp)
        if args:
            return list(_coerce(v, args[0]) for v in value)
        return list(value)
    if origin is dict and isinstance(value, dict):
        args = typing.get_args(tp)
        if len(args) == 2:
            return {k: _coerce(v, args[1]) for k, v in value.items()}
        return value
    return value


def structure(d: dict[str, Any], cls: type[T]) -> T:
    """Builds dataclass ``cls`` from a (possibly nested) plain dictionary."""
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in d.items():
        if k in fields:
            kwargs[k] = _coerce(v, fields[k].type if not isinstance(fields[k].type, str) else _resolve_annotation(cls, k))
        else:
            kwargs[k] = v
    return cls(**kwargs)


def _resolve_annotation(cls: type, field_name: str) -> Any:
    try:
        hints = typing.get_type_hints(cls)
        return hints.get(field_name, Any)
    except Exception:
        return Any


def coerce_to_signature(fn: Callable, kwargs: dict[str, Any]) -> dict[str, Any]:
    """``kwargs`` with each string value whose parameter ``fn`` annotates as
    ``int``, ``float`` or ``bool`` (optional or not) coerced as `_coerce`
    coerces a typed field (a string that does not convert stays as it is);
    every other value as it is. The port's repair of the untyped ``config``
    dicts (module docstring)."""
    hints = typing.get_type_hints(fn)
    out = dict(kwargs)
    for k, v in kwargs.items():
        tp = _strip_optional(hints.get(k, Any))
        if isinstance(v, str) and tp in (int, float, bool):
            try:
                out[k] = _coerce(v, tp)
            except ValueError:
                pass
    return out


def unstructure(obj: Any) -> Any:
    """Inverse of `structure`: dataclass tree → plain dict/JSON primitives."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: unstructure(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, enum.Enum):
        return obj.value
    if isinstance(obj, dict):
        return {k: unstructure(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [unstructure(v) for v in obj]
    if isinstance(obj, Path):
        return str(obj)
    return obj


_INTERP_RE = re.compile(r"\$\{([^}]+)\}")


def _interpolate_str(s: str, root: dict[str, Any]) -> Any:
    def lookup(expr: str) -> Any:
        if expr.startswith("now:"):
            return datetime.datetime.now().strftime(expr[4:])
        if expr.startswith("oc.env:"):
            spec = expr[len("oc.env:") :]
            var, sep, default = spec.partition(",")
            val = os.environ.get(var)
            if val is not None:
                return val
            if sep:
                return default
            raise KeyError(f"Environment variable '{var}' (from ${{{expr}}}) is not set")
        node: Any = root
        for part in expr.split("."):
            if isinstance(node, dict) and part in node:
                node = node[part]
            else:
                return None
        return node

    full = _INTERP_RE.fullmatch(s)
    if full:
        resolved = lookup(full.group(1))
        return s if resolved is None else resolved

    def sub_one(m: re.Match) -> str:
        resolved = lookup(m.group(1))
        return m.group(0) if resolved is None else str(resolved)

    return _INTERP_RE.sub(sub_one, s)


def resolve_interpolations(d: dict[str, Any], root: dict[str, Any] | None = None) -> dict[str, Any]:
    """Resolves ``${...}`` interpolations in all string values, repeating
    (at most five times) until nothing changes, so chained references
    resolve."""
    root = root if root is not None else d

    def _resolve(node: Any) -> Any:
        if isinstance(node, dict):
            return {k: _resolve(v) for k, v in node.items()}
        if isinstance(node, list):
            return [_resolve(v) for v in node]
        if isinstance(node, str) and "${" in node:
            return _interpolate_str(node, root)
        return node

    for _ in range(5):
        new = _resolve(d)
        if new == d:
            break
        d = new
        root = d
    return d


def set_dotted(d: dict[str, Any], key: str, value: Any) -> None:
    """Sets ``d["a"]["b"] = value`` for dotted key ``"a.b"``, creating levels."""
    parts = key.split(".")
    node = d
    for p in parts[:-1]:
        node = node.setdefault(p, {})
        if not isinstance(node, dict):
            raise ValueError(f"Cannot set {key}: {p} is not a mapping")
    node[parts[-1]] = value


def parse_override_value(raw: str) -> Any:
    """Parses a CLI override value by YAML's rules (ints, floats, lists,
    null); text that is not YAML stays the raw string. YAML outside
    `utils.yaml_subset`'s subset raises its `UnsupportedYAML`."""
    try:
        return yaml_subset.load(raw)
    except yaml_subset.YAMLError:
        return raw


def deep_merge(dst: dict, src: dict) -> dict:
    """Recursively merges ``src`` into ``dst`` in place (src wins); returns dst."""
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            deep_merge(dst[k], v)
        else:
            dst[k] = v
    return dst


def split_config_arg(argv: list[str], flag: str = "--config") -> tuple[str | None, list[str]]:
    """Extracts a ``--config <yaml>`` pair (or another ``flag``'s) from CLI
    args; returns (value, rest)."""
    argv = list(argv)
    value = None
    if flag in argv:
        i = argv.index(flag)
        if i + 1 >= len(argv):
            raise ValueError(f"{flag} requires an argument")
        value = argv[i + 1]
        del argv[i : i + 2]
    return value, argv


def parse_overrides(argv: list[str]) -> dict[str, Any]:
    """Parses ``key=value`` CLI args (Hydra syntax) into a nested dict.

    Hydra's bare ``~key`` deletion syntax sets the key to None; other
    ``=``-less tokens are rejected loudly rather than silently dropped.
    """
    out: dict[str, Any] = {}
    for arg in argv:
        if "=" not in arg:
            if arg.startswith("~"):
                set_dotted(out, arg[1:], None)
                continue
            raise ValueError(f"Override {arg!r} is not of the form key=value")
        key, _, raw = arg.partition("=")
        key = key.lstrip("+~")  # hydra's +key= / ~key syntax: treat as plain set
        set_dotted(out, key, parse_override_value(raw))
    return out


def _declared_defaults(cls: type) -> dict[str, Any]:
    """The declared field defaults of ``cls`` (nested dataclasses from theirs,
    not from an instance, so ``__post_init__``-derived values are not baked
    in; a factory that customised a field keeps its instance's values)."""
    out: dict[str, Any] = {}
    for f in dataclasses.fields(cls):
        if f.default is not dataclasses.MISSING:
            v = f.default
        elif f.default_factory is not dataclasses.MISSING:  # type: ignore[misc]
            v = f.default_factory()
        else:
            continue
        if dataclasses.is_dataclass(v) and not isinstance(v, type):
            try:
                is_plain_default = unstructure(type(v)()) == unstructure(v)
            except TypeError:
                is_plain_default = False
            out[f.name] = _declared_defaults(type(v)) if is_plain_default else unstructure(v)
        else:
            out[f.name] = unstructure(v)
    return out


def load_config(
    config_cls: type[T] | str,
    yaml_file: Path | str | None = None,
    overrides: list[str] | dict[str, Any] | None = None,
    defaults: dict[str, Any] | None = None,
) -> T:
    """Builds a structured config: declared defaults ← ``defaults`` ← the
    YAML file (its ``defaults`` and ``hydra`` keys dropped) ← overrides
    (``key=value`` strings or a nested dict), interpolations resolved."""
    if isinstance(config_cls, str):
        config_cls = CONFIG_STORE[config_cls]
    merged: dict[str, Any] = _declared_defaults(config_cls)
    if defaults:
        deep_merge(merged, defaults)
    if yaml_file is not None:
        loaded = yaml_subset.load_file(yaml_file) or {}
        loaded.pop("defaults", None)
        loaded.pop("hydra", None)
        deep_merge(merged, loaded)
    if overrides:
        if isinstance(overrides, list):
            overrides = parse_overrides(overrides)
        deep_merge(merged, overrides)
    merged = resolve_interpolations(merged)
    return structure(merged, config_cls)


def load_yaml_with_defaults(yaml_fp: Path | str, configs_dir: Path = CONFIGS_DIR) -> dict:
    """Loads a YAML config, resolving its hydra-style ``defaults:`` list:
    a bare name (merged from ``configs/<name>.yaml``, recursively),
    ``{group: name}`` (``configs/<group>/<name>.yaml`` under key ``group``)
    and ``_self_`` (the file's own values win from that point)."""
    raw = yaml_subset.load_file(yaml_fp) or {}
    defaults = raw.pop("defaults", [])
    raw.pop("hydra", None)
    merged: dict[str, Any] = {}
    for entry in defaults:
        if entry == "_self_":
            deep_merge(merged, raw)
            raw = {}
        elif isinstance(entry, str):
            deep_merge(merged, load_yaml_with_defaults(configs_dir / f"{entry}.yaml", configs_dir))
        elif isinstance(entry, dict):
            for group, name in entry.items():
                merged[group] = load_yaml_with_defaults(configs_dir / group / f"{name}.yaml", configs_dir)
        else:
            raise ValueError(f"Can't resolve defaults entry {entry!r}")
    deep_merge(merged, raw)
    return merged


__all__ = [
    "CONFIGS_DIR",
    "CONFIG_STORE",
    "coerce_to_signature",
    "config_dataclass",
    "deep_merge",
    "load_config",
    "load_yaml_with_defaults",
    "parse_override_value",
    "parse_overrides",
    "resolve_interpolations",
    "set_dotted",
    "split_config_arg",
    "structure",
    "unstructure",
]
