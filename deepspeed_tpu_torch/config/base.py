"""Config infrastructure: dataclass tree with "auto" values and deprecation aliases.

A copy of ``deepspeed_tpu/config/base.py`` (pure Python); the port keeps its
own so that it never imports the JAX package.

Role parity with the reference's ``runtime/config_utils.py`` (``DeepSpeedConfigModel``):
- nested dict/JSON -> typed config objects,
- ``"auto"`` placeholder values resolved later (by the engine or autotuner),
- deprecated field names migrated with a warning,
- unknown keys rejected with a helpful error.

Implemented on plain dataclasses (no pydantic dependency) so the framework has a
single, hermetic config stack.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import typing
from dataclasses import dataclass, field, fields
from typing import Any

from deepspeed_tpu_torch.utils.logging import logger

AUTO = "auto"


class ConfigError(ValueError):
    pass


def is_auto(value: Any) -> bool:
    return isinstance(value, str) and value == AUTO


@dataclass
class ConfigBase:
    """Base for all config nodes.

    Subclasses declare dataclass fields; class attributes:
      ``_deprecated``: mapping old_name -> new_name (value forwarded, warning logged)
      ``_auto_fields``: field names allowed to hold the literal "auto"
    """

    _deprecated: typing.ClassVar[dict[str, str]] = {}
    _auto_fields: typing.ClassVar[set[str]] = set()

    @classmethod
    def from_dict(cls, data: dict[str, Any] | None, path: str = "") -> "ConfigBase":
        data = copy.deepcopy(data) if data else {}
        if not isinstance(data, dict):
            raise ConfigError(f"{path or cls.__name__}: expected a dict, got {type(data).__name__}")

        # Deprecation migration (reference: config_utils.py:23-51).
        for old, new in cls._deprecated.items():
            if old in data:
                logger.warning(
                    f"Config field '{path}{old}' is deprecated; use '{path}{new}' instead."
                )
                if new not in data:
                    data[new] = data.pop(old)
                else:
                    data.pop(old)

        known = {f.name: f for f in fields(cls) if not f.name.startswith("_")}
        unknown = [k for k in data if k not in known]
        if unknown:
            raise ConfigError(
                f"{path or cls.__name__}: unknown config key(s) {unknown}; valid keys: {sorted(known)}"
            )

        kwargs: dict[str, Any] = {}
        hints = typing.get_type_hints(cls)
        for name, f in known.items():
            if name not in data:
                continue
            value = data[name]
            if is_auto(value):
                if name not in cls._auto_fields:
                    raise ConfigError(f"{path}{name}: 'auto' is not supported for this field")
                kwargs[name] = AUTO
                continue
            ftype = hints.get(name, f.type)
            kwargs[name] = _coerce(value, ftype, f"{path}{name}")
        obj = cls(**kwargs)
        obj._validate(path)
        return obj

    def _validate(self, path: str = "") -> None:  # override in subclasses
        pass

    def to_dict(self) -> dict[str, Any]:
        out = {}
        for f in fields(self):
            if f.name.startswith("_"):
                continue
            v = getattr(self, f.name)
            out[f.name] = v.to_dict() if isinstance(v, ConfigBase) else copy.deepcopy(v)
        return out

    def dumps(self) -> str:
        return json.dumps(self.to_dict(), indent=2, default=str)


def _coerce(value: Any, ftype: Any, path: str) -> Any:
    origin = typing.get_origin(ftype)
    args = typing.get_args(ftype)

    # Optional[T] / unions: try each arm.
    if origin is typing.Union:
        if value is None and type(None) in args:
            return None
        errors = []
        for arm in args:
            if arm is type(None):
                continue
            try:
                return _coerce(value, arm, path)
            except (ConfigError, TypeError, ValueError) as e:
                errors.append(str(e))
        raise ConfigError(f"{path}: no union arm matched value {value!r}: {errors}")

    if isinstance(ftype, type) and issubclass(ftype, ConfigBase):
        return ftype.from_dict(value, path=f"{path}.")

    if origin in (list, tuple):
        elem = args[0] if args else Any
        seq = [_coerce(v, elem, f"{path}[{i}]") for i, v in enumerate(value)]
        return tuple(seq) if origin is tuple else seq
    if origin is dict:
        return dict(value)

    if ftype is bool:
        if isinstance(value, bool):
            return value
        raise ConfigError(f"{path}: expected bool, got {value!r}")
    if ftype is int:
        if isinstance(value, bool) or not isinstance(value, (int, float)) or int(value) != value:
            raise ConfigError(f"{path}: expected int, got {value!r}")
        return int(value)
    if ftype is float:
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise ConfigError(f"{path}: expected float, got {value!r}")
        return float(value)
    if ftype is str:
        if not isinstance(value, str):
            raise ConfigError(f"{path}: expected str, got {value!r}")
        return value
    return value


def config_field(default=dataclasses.MISSING, default_factory=dataclasses.MISSING, **kw):
    if default_factory is not dataclasses.MISSING:
        return field(default_factory=default_factory, **kw)
    return field(default=default, **kw)
