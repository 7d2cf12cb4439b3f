"""UI / observability (JAX counterpart deeplearning4j_tpu/ui; reference:
deeplearning4j-ui-parent — UiServer.java Dropwizard app,
deeplearning4j-ui-components chart-JSON protocol, weights/flow/
activation/tsne/nearestneighbors views; SURVEY.md §2.6 L9 row).

Host-side by nature. The Dropwizard/Jetty/Jersey stack is replaced by a
stdlib ThreadingHTTPServer speaking the same declarative chart-JSON
component protocol; listeners POST JSON snapshots exactly like the
reference's HistogramIterationListener (HistogramIterationListener.java:206)
or write straight to in-process storage when no server is running. The
listeners read the port's nets (their params from the card, one copy a
snapshot); the chart JSON and the rendered pages are the JAX package's.
"""

from deeplearning4j_tpu_torch.ui.components import (
    ChartHistogram,
    ChartHorizontalBar,
    ChartLine,
    ChartScatter,
    ChartStackedArea,
    Component,
    ComponentDiv,
    ComponentTable,
    ComponentText,
    DecoratorAccordion,
    StyleChart,
)
from deeplearning4j_tpu_torch.ui.storage import HistoryStorage, SessionStorage
from deeplearning4j_tpu_torch.ui.server import UiServer
from deeplearning4j_tpu_torch.ui.listeners import (
    ActivationMeanIterationListener,
    FlowIterationListener,
    HistogramIterationListener,
)
from deeplearning4j_tpu_torch.ui.standalone import StaticPageUtil

__all__ = [
    "ChartHistogram",
    "ChartHorizontalBar",
    "ChartLine",
    "ChartScatter",
    "ChartStackedArea",
    "Component",
    "ComponentDiv",
    "ComponentTable",
    "ComponentText",
    "DecoratorAccordion",
    "StyleChart",
    "HistoryStorage",
    "SessionStorage",
    "UiServer",
    "HistogramIterationListener",
    "FlowIterationListener",
    "ActivationMeanIterationListener",
    "StaticPageUtil",
]
