"""Automated build-and-test flow (HERO §2.3.2), copied from
``repro.core.buildflow``.

HERO specifies platform-application-parameter combinations in a *graph-based
notation* which the integration server flattens into the concrete test
matrix ("listing all combinations manually would be redundant, error-prone
work").  This module is that notation: axes + compatibility edges -> flat
cells.  It drives the smoke-test matrix, the dry-run matrix, and the bench
matrix.  (The reference's 'bitstream build' step, AOT
``lower().compile()``, has no counterpart in the eager port.)
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Dict, Iterable, List


@dataclasses.dataclass
class Axis:
    name: str
    values: List[Any]


class ConfigGraph:
    """Axes + constraints -> flattened combination cells."""

    def __init__(self):
        self.axes: Dict[str, Axis] = {}
        self.constraints: List[Callable[[Dict[str, Any]], bool]] = []
        self.annotators: List[Callable[[Dict[str, Any]], Dict[str, Any]]] = []

    def axis(self, name: str, values: Iterable[Any]) -> "ConfigGraph":
        self.axes[name] = Axis(name, list(values))
        return self

    def constraint(self, fn: Callable[[Dict[str, Any]], bool]) -> "ConfigGraph":
        """Edge predicate: cell kept only if fn(cell) is truthy."""
        self.constraints.append(fn)
        return self

    def annotate(self, fn: Callable[[Dict[str, Any]], Dict[str, Any]]
                 ) -> "ConfigGraph":
        """Attach derived fields (e.g. run arguments) to surviving cells."""
        self.annotators.append(fn)
        return self

    def cells(self) -> List[Dict[str, Any]]:
        names = list(self.axes)
        out: List[Dict[str, Any]] = []
        for combo in itertools.product(*(self.axes[n].values for n in names)):
            cell = dict(zip(names, combo))
            if all(c(cell) for c in self.constraints):
                for a in self.annotators:
                    cell.update(a(cell) or {})
                out.append(cell)
        return out

    def __len__(self) -> int:
        return len(self.cells())


def hero_test_matrix() -> ConfigGraph:
    """The project's own §2.3.2 matrix: archs x shapes x meshes, over the
    archs the port registers."""
    from repro_torch.configs import SHAPES, get_config, list_archs

    g = ConfigGraph()
    g.axis("arch", list_archs())
    g.axis("shape", list(SHAPES))
    g.axis("mesh", ["single", "multi"])
    g.constraint(lambda c: get_config(c["arch"]).shape_applicable(
        SHAPES[c["shape"]])[0])
    g.annotate(lambda c: {"kind": SHAPES[c["shape"]].kind})
    return g
