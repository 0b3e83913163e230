"""The one telemetry serializer.

``EngineStats.to_dict``, ``BackendTelemetry.to_dict``, and
``bench_payload`` each used to hand-roll their numpy→python coercion,
which is how schema drift (and double-counted fields) creeps in. They
now all funnel through :func:`to_plain`, which converts any telemetry
value into plain JSON types — numpy scalars via ``.item()``, arrays via
``tolist()``, dataclasses field-by-field (preserving declaration
order), enums by name — and leaves bool/int/float/str/None untouched.

No torch import: this module runs on scrape paths that must never touch
the device runtime.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any

__all__ = ["to_plain"]


def to_plain(obj: Any) -> Any:
    """Recursively convert telemetry values to plain JSON types."""
    if obj is None or type(obj) in (bool, int, float, str):
        return obj
    if isinstance(obj, enum.Enum):
        return obj.name
    if isinstance(obj, dict):
        return {str(k): to_plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, set, frozenset)):
        return [to_plain(v) for v in obj]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: to_plain(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    # numpy scalars/arrays (and anything else that shares the API)
    # without importing numpy here
    if hasattr(obj, "item") and getattr(obj, "ndim", None) == 0:
        return to_plain(obj.item())
    if hasattr(obj, "tolist"):
        return to_plain(obj.tolist())
    if hasattr(obj, "item"):  # 0-d-less numpy scalar types (np.float64)
        return to_plain(obj.item())
    # exotic builtin-scalar subclasses without a numpy API: downcast to
    # the plain base type so json output is schema-stable
    for base in (bool, int, float, str):
        if isinstance(obj, base):
            return base(obj)
    raise TypeError("to_plain: unsupported telemetry type %r" % type(obj))
