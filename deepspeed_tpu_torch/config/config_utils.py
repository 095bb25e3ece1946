"""Config plumbing: a small typed-config base over dataclasses, a copy of
``deepspeed_tpu/config/config_utils.py``.

Sections are declared once as dataclasses and built with a recursive
``from_dict``; unknown keys warn (a user's config stays portable between
the two packages) and ``validate`` runs the cross-field checks.
"""

import dataclasses
import logging
from typing import Any, Dict, Type, TypeVar, get_args, get_origin, get_type_hints

logger = logging.getLogger("deepspeed_tpu_torch")

T = TypeVar("T", bound="ConfigModel")


class ConfigError(ValueError):
    pass


@dataclasses.dataclass
class ConfigModel:
    """Base for all config sections; subclass as a @dataclass. A class
    attribute ``ALIASES`` maps JSON keys to field names (e.g. "type" ->
    "name")."""

    @classmethod
    def from_dict(cls: Type[T], data: Dict[str, Any], path: str = "") -> T:
        if data is None:
            data = {}
        if not isinstance(data, dict):
            raise ConfigError(f"{path or cls.__name__}: expected a dict, "
                              f"got {type(data).__name__}")
        hints = get_type_hints(cls)
        field_names = {f.name for f in dataclasses.fields(cls)}
        aliases = getattr(cls, "ALIASES", {})
        kwargs = {}
        for key, value in data.items():
            name = aliases.get(key, key)
            if name not in field_names:
                logger.warning(f"config: unknown key '{path}{key}' (ignored)")
                continue
            kwargs[name] = _coerce(hints.get(name), value, f"{path}{key}.")
        obj = cls(**kwargs)  # type: ignore[call-arg]
        object.__setattr__(obj, "_explicit_keys", frozenset(kwargs))
        obj.validate()
        return obj

    def was_set(self, field_name: str) -> bool:
        """Whether the user's dict gave this field (a section built from
        its defaults says False for every field)."""
        return field_name in getattr(self, "_explicit_keys", ())

    def validate(self) -> None:
        """Override for cross-field checks."""

    def to_dict(self) -> Dict[str, Any]:
        """The section as plain dicts (a checkpoint's meta.json)."""
        out = {}
        for f in dataclasses.fields(self):
            value = getattr(self, f.name)
            out[f.name] = (value.to_dict() if isinstance(value, ConfigModel)
                           else value)
        return out


def _coerce(hint, value, path: str):
    """Best-effort coercion of a raw JSON value to the annotated type."""
    if hint is None or value is None:
        return value
    if get_origin(hint) is not None:
        # Optional[X] / Union: build the ConfigModel arm from a dict
        for arg in get_args(hint):
            if isinstance(arg, type) and issubclass(arg, ConfigModel) \
                    and isinstance(value, dict):
                return arg.from_dict(value, path)
        return value
    if isinstance(hint, type) and issubclass(hint, ConfigModel):
        return hint.from_dict(value if isinstance(value, dict) else {}, path)
    if hint is float and isinstance(value, int):
        return float(value)
    if hint is int and isinstance(value, float) and value.is_integer():
        return int(value)
    if hint is bool and isinstance(value, str):
        return value.lower() in ("true", "1", "yes")
    return value


def config_field(default=None, **kw):
    """A dataclass field whose mutable or section default is built fresh
    for every instance."""
    if isinstance(default, type) and issubclass(default, ConfigModel):
        return dataclasses.field(default_factory=default, **kw)
    if isinstance(default, (dict, list, set)):
        return dataclasses.field(default_factory=lambda: type(default)(default),
                                 **kw)
    return dataclasses.field(default=default, **kw)
