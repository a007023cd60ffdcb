"""WebSocket/REST message schemas, mirroring the reference's API types
(reference: backend/api/types.py:13-68) so the original Next.js dashboard
works against this backend unchanged.

The JAX package declares these as pydantic models; this package carries
no pydantic (the card's machine need not have it), so each message is a
small class with explicit validation that accepts and rejects what
pydantic's lax mode does on these fields: booleans from ``0``/``1``
(ints, floats, strings) and the words pydantic knows, any case; enums by
value; ints from integral floats and digit strings; unknown keys ignored.
A rejected value raises :class:`ValidationError` (a ``ValueError``, as
pydantic's is). ``model_dump_json`` writes compact JSON in field order, as
pydantic's does.
"""

from __future__ import annotations

import json
import math
from enum import Enum
from typing import Any, Callable, Dict, Tuple

__all__ = [
    "ApiMode",
    "EmotionOverride",
    "ValidationError",
    "ControlMessage",
    "TranscriptMessage",
    "PacketSummaryMessage",
    "ControlStateMessage",
]


class ApiMode(str, Enum):
    SEMANTIC = "semantic"
    TEXT_ONLY = "text_only"
    MORSE = "morse"


class EmotionOverride(str, Enum):
    AUTO = "auto"
    RELAXED = "relaxed"
    PANICKED = "panicked"


class ValidationError(ValueError):
    """A message field that does not validate."""


_TRUE = {"1", "on", "t", "true", "y", "yes"}
_FALSE = {"0", "off", "f", "false", "n", "no"}
_REQUIRED = object()


def _text(v):
    return v.decode("utf-8") if isinstance(v, (bytes, bytearray)) else v


def _bool(v) -> bool:
    v = _text(v)
    if isinstance(v, bool):
        return v
    if isinstance(v, (int, float)) and v in (0, 1):
        return bool(v)
    if isinstance(v, str):
        low = v.lower()
        if low in _TRUE:
            return True
        if low in _FALSE:
            return False
    raise ValidationError(f"not a valid boolean: {v!r}")


def _int(v) -> int:
    v = _text(v)
    if isinstance(v, str):
        try:
            v = float(v.strip()) if "." in v else int(v.strip())
        except ValueError:
            raise ValidationError(f"not a valid integer: {v!r}") from None
    if isinstance(v, bool):
        return int(v)
    if isinstance(v, int):
        return v
    if isinstance(v, float) and v.is_integer():
        return int(v)
    raise ValidationError(f"not a valid integer: {v!r}")


def _float(v) -> float:
    v = _text(v)
    if isinstance(v, str):
        try:
            return float(v.strip())
        except ValueError:
            raise ValidationError(f"not a valid number: {v!r}") from None
    if isinstance(v, (bool, int, float)):
        return float(v)
    raise ValidationError(f"not a valid number: {v!r}")


def _str(v) -> str:
    v = _text(v)
    if isinstance(v, str):
        return v
    raise ValidationError(f"not a valid string: {v!r}")


def _enum(cls) -> Callable[[Any], Enum]:
    def validate(v):
        v = _text(v)
        try:
            return cls(v)
        except ValueError:
            raise ValidationError(
                f"{v!r} is not one of {[m.value for m in cls]}") from None
    return validate


def _literal(value: str) -> Callable[[Any], str]:
    def validate(v):
        if isinstance(v, str) and v == value:
            return v
        raise ValidationError(f"expected {value!r}, got {v!r}")
    return validate


def _optional(validate) -> Callable[[Any], Any]:
    return lambda v: None if v is None else validate(v)


def _json_value(v):
    if isinstance(v, Enum):
        return v.value
    if isinstance(v, float) and not math.isfinite(v):
        return None
    return v


class _Message:
    """Fields as ``(name, validator, default)``, in declaration order;
    ``_REQUIRED`` marks a field without a default. Keys not declared are
    ignored."""

    _fields: Tuple[Tuple[str, Callable[[Any], Any], Any], ...] = ()

    def __init__(self, **data) -> None:
        for name, validate, default in self._fields:
            if name in data:
                value = validate(data[name])
            elif default is _REQUIRED:
                raise ValidationError(f"{type(self).__name__}.{name}: "
                                      f"field required")
            else:
                value = default
            setattr(self, name, value)

    def model_dump(self) -> Dict[str, Any]:
        return {name: getattr(self, name) for name, _, _ in self._fields}

    def model_dump_json(self) -> str:
        return json.dumps({k: _json_value(v)
                           for k, v in self.model_dump().items()},
                          separators=(",", ":"), ensure_ascii=False)

    def __repr__(self) -> str:
        body = ", ".join(f"{k}={v!r}" for k, v in self.model_dump().items())
        return f"{type(self).__name__}({body})"


class ControlMessage(_Message):
    """Frontend → backend; None fields mean "no change"."""

    _fields = (
        ("type", _literal("control"), _REQUIRED),
        ("is_streaming", _optional(_bool), None),
        ("is_recording", _optional(_bool), None),
        ("mode", _optional(_enum(ApiMode)), None),
        ("emotion_override", _optional(_enum(EmotionOverride)), None),
    )


class TranscriptMessage(_Message):
    _fields = (
        ("type", _literal("transcript"), "transcript"),
        ("text", _str, _REQUIRED),
        ("start_ms", _optional(_int), None),
        ("end_ms", _optional(_int), None),
        ("avg_pitch_hz", _optional(_float), None),
        ("avg_energy", _optional(_float), None),
    )


class PacketSummaryMessage(_Message):
    _fields = (
        ("type", _literal("packet_summary"), "packet_summary"),
        ("bytes", _int, _REQUIRED),
        ("mode", _enum(ApiMode), _REQUIRED),
        ("created_at_ms", _int, _REQUIRED),
        ("emotion", _optional(_str), None),
        ("snippet", _optional(_str), None),
    )


class ControlStateMessage(_Message):
    _fields = (
        ("type", _literal("control_state"), "control_state"),
        ("is_streaming", _bool, _REQUIRED),
        ("is_recording", _bool, _REQUIRED),
        ("mode", _enum(ApiMode), _REQUIRED),
        ("emotion_override", _enum(EmotionOverride), _REQUIRED),
    )
