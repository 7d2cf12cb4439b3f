"""Declarative chart/table/text components serialising to JSON (reference:
deeplearning4j-ui-components — components/chart/{Chart, ChartLine,
ChartHistogram, ChartScatter, ChartStackedArea, ChartHorizontalBar}.java,
table/ComponentTable.java, text/ComponentText.java,
component/ComponentDiv.java, decorator/DecoratorAccordion.java,
api/Component.java `componentType` discriminator).

Server-agnostic: a component is data; `to_dict()/to_json()` produce the
wire format, `Component.from_dict` restores it — the same
Jackson-subtype-registry round-trip the reference uses.

The port's copy of the JAX package's ui/components.py (numpy on the host,
the same results on the same input); the port imports nothing of that
package.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional, Sequence

_COMPONENT_TYPES: Dict[str, type] = {}


def _register(cls):
    _COMPONENT_TYPES[cls.__name__] = cls
    return cls


@dataclass
class StyleChart:
    """Chart styling (reference chart/style/StyleChart.java)."""

    width: float = 640
    height: float = 480
    title_style: Optional[dict] = None
    series_colors: Optional[List[str]] = None
    axis_strokewidth: float = 1.0


@dataclass
class Component:
    """Base component (api/Component.java)."""

    def to_dict(self) -> dict:
        d = asdict(self)
        d["componentType"] = type(self).__name__
        return d

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @staticmethod
    def from_dict(d: dict) -> "Component":
        d = dict(d)
        t = d.pop("componentType")
        cls = _COMPONENT_TYPES[t]
        if "style" in d and d["style"] is not None:
            d["style"] = StyleChart(**d["style"])
        kids = d.pop("components", None)
        obj = cls(**d)
        if kids is not None:
            obj.components = [Component.from_dict(k) for k in kids]
        return obj

    @staticmethod
    def from_json(s: str) -> "Component":
        return Component.from_dict(json.loads(s))


@_register
@dataclass
class ChartLine(Component):
    """Multi-series line chart (chart/ChartLine.java)."""

    title: str = ""
    series_names: List[str] = field(default_factory=list)
    x: List[List[float]] = field(default_factory=list)
    y: List[List[float]] = field(default_factory=list)
    style: Optional[StyleChart] = None

    def add_series(self, name: str, xs: Sequence[float], ys: Sequence[float]):
        if len(xs) != len(ys):
            raise ValueError("x/y length mismatch")
        self.series_names.append(name)
        self.x.append([float(v) for v in xs])
        self.y.append([float(v) for v in ys])
        return self


@_register
@dataclass
class ChartHistogram(Component):
    """Histogram: explicit bin edges + counts (chart/ChartHistogram.java)."""

    title: str = ""
    lower_bounds: List[float] = field(default_factory=list)
    upper_bounds: List[float] = field(default_factory=list)
    y_values: List[float] = field(default_factory=list)
    style: Optional[StyleChart] = None

    def add_bin(self, lower: float, upper: float, y: float):
        self.lower_bounds.append(float(lower))
        self.upper_bounds.append(float(upper))
        self.y_values.append(float(y))
        return self

    @staticmethod
    def of(values, bins: int = 20, title: str = "") -> "ChartHistogram":
        import numpy as np

        counts, edges = np.histogram(np.asarray(values).ravel(), bins=bins)
        h = ChartHistogram(title=title)
        for i, c in enumerate(counts):
            h.add_bin(edges[i], edges[i + 1], float(c))
        return h


@_register
@dataclass
class ChartScatter(Component):
    """Scatter chart (chart/ChartScatter.java)."""

    title: str = ""
    series_names: List[str] = field(default_factory=list)
    x: List[List[float]] = field(default_factory=list)
    y: List[List[float]] = field(default_factory=list)
    style: Optional[StyleChart] = None

    def add_series(self, name: str, xs: Sequence[float], ys: Sequence[float]):
        if len(xs) != len(ys):
            raise ValueError("x/y length mismatch")
        self.series_names.append(name)
        self.x.append([float(v) for v in xs])
        self.y.append([float(v) for v in ys])
        return self


@_register
@dataclass
class ChartStackedArea(Component):
    """Stacked area chart (chart/ChartStackedArea.java)."""

    title: str = ""
    x: List[float] = field(default_factory=list)
    labels: List[str] = field(default_factory=list)
    y: List[List[float]] = field(default_factory=list)
    style: Optional[StyleChart] = None


@_register
@dataclass
class ChartHorizontalBar(Component):
    """Horizontal bar chart (chart/ChartHorizontalBar.java)."""

    title: str = ""
    labels: List[str] = field(default_factory=list)
    values: List[float] = field(default_factory=list)
    style: Optional[StyleChart] = None


@_register
@dataclass
class ComponentTable(Component):
    """Table (table/ComponentTable.java)."""

    header: List[str] = field(default_factory=list)
    content: List[List[str]] = field(default_factory=list)


@_register
@dataclass
class ComponentText(Component):
    """Text block (text/ComponentText.java)."""

    text: str = ""


@_register
@dataclass
class ComponentDiv(Component):
    """Container div (component/ComponentDiv.java)."""

    components: List[Any] = field(default_factory=list)

    def to_dict(self) -> dict:
        return {
            "componentType": "ComponentDiv",
            "components": [c.to_dict() for c in self.components],
        }


@_register
@dataclass
class DecoratorAccordion(Component):
    """Collapsible section (decorator/DecoratorAccordion.java)."""

    title: str = ""
    default_collapsed: bool = False
    components: List[Any] = field(default_factory=list)

    def to_dict(self) -> dict:
        return {
            "componentType": "DecoratorAccordion",
            "title": self.title,
            "default_collapsed": self.default_collapsed,
            "components": [c.to_dict() for c in self.components],
        }
