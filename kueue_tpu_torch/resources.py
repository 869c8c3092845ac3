"""Integer resource arithmetic — the tensor cell type of the framework.

Mirrors the semantics of the reference's ``pkg/resources``
(``requests.go``, ``resource.go``): resource quantities are carried as
int64 — milli-units for ``cpu``, base units (bytes / counts) for
everything else — so that all quota math is exact integer arithmetic and
can be laid out in dense ``int64`` tensors for the JAX solver.

Also implements the subset of Kubernetes ``resource.Quantity`` parsing
the framework needs (plain ints, ``m`` milli suffix, decimal k/M/G/T/P/E
and binary Ki/Mi/Gi/Ti/Pi/Ei suffixes).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from fractions import Fraction
from typing import Dict, Iterable, Mapping, Tuple

# Canonical well-known resource names (subset of corev1).
CPU = "cpu"
MEMORY = "memory"
PODS = "pods"
EPHEMERAL_STORAGE = "ephemeral-storage"

_DEC_SUFFIX = {"k": 10**3, "M": 10**6, "G": 10**9, "T": 10**12, "P": 10**15, "E": 10**18}
_BIN_SUFFIX = {"Ki": 2**10, "Mi": 2**20, "Gi": 2**30, "Ti": 2**40, "Pi": 2**50, "Ei": 2**60}

_QTY_RE = re.compile(r"^([+-]?[0-9]+(?:\.[0-9]+)?)(m|[kMGTPE]|(?:[KMGTPE]i))?$")


def parse_quantity(value) -> Tuple[object, int]:
    """Parse a k8s-style quantity into (numeric value, scale).

    Returns (number, multiplier); ``m`` suffix yields multiplier -1 as a
    marker handled by :func:`quantity_to_int`. Integral inputs stay
    exact ints (never routed through float) so values beyond 2^53 keep
    full int64 precision.
    """
    if isinstance(value, int):
        return value, 1
    if isinstance(value, float):
        return value, 1
    s = str(value).strip()
    m = _QTY_RE.match(s)
    if not m:
        raise ValueError(f"invalid quantity: {value!r}")
    digits = m.group(1)
    # Fraction keeps decimal strings exact ("1.07" stays 107/100), so no
    # float rounding noise can leak into the ceil below — required for
    # decision parity with k8s resource.Quantity's exact decimal math.
    num = int(digits) if "." not in digits else Fraction(digits)
    suffix = m.group(2)
    if suffix is None:
        return num, 1
    if suffix == "m":
        return num, -1
    if suffix in _DEC_SUFFIX:
        return num, _DEC_SUFFIX[suffix]
    return num, _BIN_SUFFIX[suffix]


def quantity_to_int(resource_name: str, value) -> int:
    """Convert a quantity to the canonical int64 representation.

    ``cpu`` is stored in milli-CPU (matching the reference's
    ``resources.ResourceValue``, pkg/resources/requests.go); every other
    resource in base units, rounding up fractional values.
    """
    num, scale = parse_quantity(value)
    if isinstance(num, float):
        # Parse via the decimal string form: Fraction(0.1) would expand
        # the binary approximation (0.1000...055) and the exact ceil
        # below would inflate by one unit.
        num = Fraction(str(num))
    if resource_name == CPU:
        if scale == -1:  # already milli
            raw = num
        else:
            raw = num * scale * 1000
    else:
        if scale == -1:
            raw = Fraction(num, 1000)
        else:
            raw = num * scale
    if isinstance(raw, int):
        return raw
    # exact ceil on the rational value (k8s rounds partial units up)
    return -((-raw.numerator) // raw.denominator)


def int_to_display(resource_name: str, value: int) -> str:
    """Human-readable rendering of a canonical int64 quantity."""
    if resource_name == CPU:
        if value % 1000 == 0:
            return str(value // 1000)
        return f"{value}m"
    for suffix, mult in reversed(list(_BIN_SUFFIX.items())):
        if value and value % mult == 0:
            return f"{value // mult}{suffix}"
    return str(value)


@dataclass(frozen=True, order=True)
class FlavorResource:
    """Key identifying one (flavor, resource) quota cell.

    Mirrors ``pkg/resources/resource.go`` ``FlavorResource``.
    """

    flavor: str
    resource: str

    def __str__(self) -> str:  # pragma: no cover - debug aid
        return f"{self.flavor}/{self.resource}"


# Requests: resource name -> canonical int64 quantity.
Requests = Dict[str, int]
# FlavorResourceQuantities: FlavorResource -> int64.
FlavorResourceQuantities = Dict[FlavorResource, int]


def _accumulate(a, b):
    for k, v in b.items():
        a[k] = a.get(k, 0) + v
    return a


def add_requests(a: Requests, b: Mapping[str, int]) -> Requests:
    return _accumulate(a, b)


def sub_requests(a: Requests, b: Mapping[str, int]) -> Requests:
    for k, v in b.items():
        a[k] = a.get(k, 0) - v
    return a


def scale_requests(a: Mapping[str, int], factor: int) -> Requests:
    return {k: v * factor for k, v in a.items()}


def requests_from_spec(spec: Mapping[str, object]) -> Requests:
    """Parse {resource: quantity-string} into canonical Requests."""
    return {name: quantity_to_int(name, q) for name, q in spec.items()}


# Unbounded fit sentinel, matching the reference's MaxInt32 for
# zero-valued requests (pkg/resources/requests.go:128-131).
COUNT_IN_UNBOUNDED = 2**31 - 1


def count_in(requests: Requests, capacity: Mapping[str, int]) -> int:
    """How many whole copies of `requests` fit into `capacity`.

    Mirrors ``pkg/resources/requests.go`` ``CountIn``: entries with a
    zero per-unit request fit unboundedly (MaxInt32), so all-zero
    requests return COUNT_IN_UNBOUNDED, not 0.
    """
    best = COUNT_IN_UNBOUNDED
    for name, per_unit in requests.items():
        if per_unit <= 0:
            continue
        have = capacity.get(name, 0)
        fit = max(0, have // per_unit)
        best = min(best, fit)
    return int(best)


def add_flavor_quantities(
    a: FlavorResourceQuantities, b: Mapping[FlavorResource, int]
) -> FlavorResourceQuantities:
    return _accumulate(a, b)


def flavor_resources(
    flavors: Iterable[str], resource_names: Iterable[str]
) -> Tuple[FlavorResource, ...]:
    return tuple(FlavorResource(f, r) for f in flavors for r in resource_names)
