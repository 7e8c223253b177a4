"""JSON round-tripping for config objects.

Counterpart: ``eventstreamgpt_tpu/utils/serialization.py`` (``JSONableMixin``).
`config_dataclass` is `utils.config_tool`'s: it makes a class a dataclass
and registers it in the config store.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import os
from pathlib import Path
from typing import Any, TypeVar

from .config_tool import config_dataclass

T = TypeVar("T", bound="JSONableMixin")

__all__ = ["JSONableMixin", "atomic_write_json", "config_dataclass"]


def _jsonify(obj: Any) -> Any:
    """Recursively converts an object into JSON-compatible primitives."""
    if isinstance(obj, enum.Enum):
        return obj.value
    if isinstance(obj, JSONableMixin):
        return obj.to_dict()
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _jsonify(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: _jsonify(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonify(v) for v in obj]
    if isinstance(obj, Path):
        return str(obj)
    return obj


class JSONableMixin:
    """Mixin granting ``to_dict``/``from_dict``/``to_json_file``/``from_json_file``.

    Dataclass subclasses get ``to_dict`` for free; other classes override it.
    """

    @classmethod
    def from_dict(cls: type[T], as_dict: dict) -> T:
        return cls(**as_dict)

    def to_dict(self) -> dict[str, Any]:
        if dataclasses.is_dataclass(self):
            return {f.name: _jsonify(getattr(self, f.name)) for f in dataclasses.fields(self)}
        raise NotImplementedError("This must be overwritten in non-dataclass derived classes!")

    def to_json_file(self, fp: Path | str, do_overwrite: bool = False) -> None:
        fp = Path(fp)
        if fp.exists() and not do_overwrite:
            raise FileExistsError(f"{fp} exists and do_overwrite = {do_overwrite}")
        fp.parent.mkdir(parents=True, exist_ok=True)
        fp.write_text(json.dumps(self.to_dict()))

    @classmethod
    def from_json_file(cls: type[T], fp: Path | str) -> T:
        with open(fp) as f:
            return cls.from_dict(json.load(f))


def atomic_write_json(fp: Path | str, obj: Any, **json_kwargs: Any) -> None:
    """Publishes ``obj`` as JSON at ``fp`` atomically: a per-process temporary
    file, fsynced, renamed over ``fp``, and the directory fsynced, so a crash
    leaves either the old file or the whole new one."""
    fp = Path(fp)
    tmp = fp.with_name(f"{fp.name}.{os.getpid()}.tmp")
    with open(tmp, "w") as f:
        json.dump(obj, f, **json_kwargs)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, fp)
    try:
        dirfd = os.open(fp.parent, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(dirfd)
    except OSError:
        pass
    finally:
        os.close(dirfd)
