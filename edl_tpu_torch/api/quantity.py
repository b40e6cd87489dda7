"""Kubernetes-style resource quantities.

Equivalent of the reference's quantity handling (`pkg/utils.go:23-34`
``AddResourceList`` plus the implicit k8s ``resource.Quantity`` parsing it leans
on): parse "500m" CPUs, "30Gi" memory, integer TPU-chip counts, and accumulate
per-resource totals across pods/jobs.

We normalize every quantity to a float in base units (CPUs in cores, memory in
bytes, chips in chips) so the autoscaler's arithmetic stays simple.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

Quantity = float

_BINARY_SUFFIX = {
    "Ki": 1024.0,
    "Mi": 1024.0**2,
    "Gi": 1024.0**3,
    "Ti": 1024.0**4,
    "Pi": 1024.0**5,
    "Ei": 1024.0**6,
}
_DECIMAL_SUFFIX = {
    "n": 1e-9,
    "u": 1e-6,
    "m": 1e-3,
    "": 1.0,
    "k": 1e3,
    "K": 1e3,
    "M": 1e6,
    "G": 1e9,
    "T": 1e12,
    "P": 1e15,
    "E": 1e18,
}

_QTY_RE = re.compile(r"^\s*([+-]?[0-9]*\.?[0-9]+(?:[eE][+-]?[0-9]+)?)\s*([A-Za-z]*)\s*$")


def parse_quantity(value) -> Quantity:
    """Parse a k8s-style quantity ("500m", "30Gi", 4, "2.5") to base units."""
    if isinstance(value, (int, float)):
        return float(value)
    if not isinstance(value, str):
        raise TypeError(f"cannot parse quantity from {type(value).__name__}")
    m = _QTY_RE.match(value)
    if not m:
        raise ValueError(f"invalid quantity: {value!r}")
    number, suffix = m.groups()
    if suffix in _BINARY_SUFFIX:
        return float(number) * _BINARY_SUFFIX[suffix]
    if suffix in _DECIMAL_SUFFIX:
        return float(number) * _DECIMAL_SUFFIX[suffix]
    raise ValueError(f"unknown quantity suffix {suffix!r} in {value!r}")


def format_quantity(value: Quantity) -> str:
    """Render a base-unit quantity compactly (inverse of parse, best effort)."""
    if value == int(value):
        v = int(value)
        for suffix, mult in reversed(list(_BINARY_SUFFIX.items())):
            if v and v % int(mult) == 0 and v >= int(mult):
                return f"{v // int(mult)}{suffix}"
        return str(v)
    if abs(value) < 1.0 and round(value * 1000) == value * 1000:
        return f"{int(round(value * 1000))}m"
    return repr(value)


class ResourceList(Dict[str, Quantity]):
    """Named resource totals: {"cpu": cores, "memory": bytes, "tpu": chips}.

    Mirrors ``AddResourceList`` (`pkg/utils.go:23-34`): addition accumulates
    per-key; missing keys are zero.
    """

    @classmethod
    def make(cls, spec: Mapping[str, object] | None) -> "ResourceList":
        out = cls()
        for key, val in (spec or {}).items():
            out[key] = parse_quantity(val)
        return out

    def get_q(self, key: str) -> Quantity:
        return self.get(key, 0.0)

    def add(self, other: Mapping[str, Quantity]) -> "ResourceList":
        for key, val in other.items():
            self[key] = self.get(key, 0.0) + val
        return self

    def sub(self, other: Mapping[str, Quantity]) -> "ResourceList":
        for key, val in other.items():
            self[key] = self.get(key, 0.0) - val
        return self

    def scaled(self, factor: float) -> "ResourceList":
        return ResourceList({k: v * factor for k, v in self.items()})

    def fits_within(self, capacity: Mapping[str, Quantity]) -> bool:
        """True if every requested resource is available in ``capacity``."""
        return all(capacity.get(k, 0.0) >= v for k, v in self.items() if v > 0)

    def copy(self) -> "ResourceList":
        return ResourceList(self)
