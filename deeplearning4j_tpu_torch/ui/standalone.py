"""Static page rendering (reference: ui/standalone/StaticPageUtil.java —
renders components to a self-contained HTML page with embedded JSON).

The generated page inlines the component JSON plus a tiny renderer that
draws line/scatter/histogram charts to SVG and tables/text to HTML — no
external JS dependencies (the reference ships its own JS assets).

The port's copy of the JAX package's ui/standalone.py (numpy on the host,
the same results on the same input); the port imports nothing of that
package.
"""

from __future__ import annotations

import html
import json
from typing import Sequence

from deeplearning4j_tpu_torch.ui.components import Component

_RENDER_JS = """
function renderComponent(c, el) {
  if (c.componentType === 'ComponentText') {
    const p = document.createElement('p'); p.textContent = c.text;
    el.appendChild(p);
  } else if (c.componentType === 'ComponentTable') {
    const t = document.createElement('table'); t.border = '1';
    const hr = t.insertRow();
    (c.header || []).forEach(h => { const th = document.createElement('th');
      th.textContent = h; hr.appendChild(th); });
    (c.content || []).forEach(row => { const r = t.insertRow();
      row.forEach(v => { r.insertCell().textContent = v; }); });
    el.appendChild(t);
  } else if (c.componentType === 'ComponentDiv'
             || c.componentType === 'DecoratorAccordion') {
    const d = document.createElement(
      c.componentType === 'DecoratorAccordion' ? 'details' : 'div');
    if (c.title) { const s = document.createElement('summary');
      s.textContent = c.title; d.appendChild(s); }
    if (c.componentType === 'DecoratorAccordion' && !c.default_collapsed)
      d.open = true;
    (c.components || []).forEach(k => renderComponent(k, d));
    el.appendChild(d);
  } else {
    el.appendChild(renderChartSVG(c));
  }
}
function renderChartSVG(c) {
  const W = (c.style && c.style.width) || 640,
        H = (c.style && c.style.height) || 360, pad = 40;
  const ns = 'http://www.w3.org/2000/svg';
  const svg = document.createElementNS(ns, 'svg');
  svg.setAttribute('width', W); svg.setAttribute('height', H);
  svg.style.border = '1px solid #ccc';
  let xs = [], ys = [];
  if (c.componentType === 'ChartHistogram') {
    xs = c.lower_bounds.concat(c.upper_bounds); ys = [0].concat(c.y_values);
  } else if (c.componentType === 'ChartHorizontalBar') {
    xs = [0].concat(c.values); ys = [0, c.labels.length];
  } else { xs = (c.x || []).flat(); ys = (c.y || []).flat(); }
  if (!xs.length || !ys.length) return svg;
  const xmin = Math.min(...xs), xmax = Math.max(...xs),
        ymin = Math.min(...ys), ymax = Math.max(...ys);
  const sx = v => pad + (v - xmin) / ((xmax - xmin) || 1) * (W - 2 * pad);
  const sy = v => H - pad - (v - ymin) / ((ymax - ymin) || 1) * (H - 2 * pad);
  const colors = ['#1f77b4', '#ff7f0e', '#2ca02c', '#d62728', '#9467bd'];
  if (c.componentType === 'ChartLine' || c.componentType === 'ChartScatter') {
    (c.x || []).forEach((sxs, i) => {
      const col = colors[i % colors.length];
      if (c.componentType === 'ChartLine') {
        const pl = document.createElementNS(ns, 'polyline');
        pl.setAttribute('points',
          sxs.map((v, j) => sx(v) + ',' + sy(c.y[i][j])).join(' '));
        pl.setAttribute('fill', 'none'); pl.setAttribute('stroke', col);
        svg.appendChild(pl);
      } else {
        sxs.forEach((v, j) => {
          const ci = document.createElementNS(ns, 'circle');
          ci.setAttribute('cx', sx(v)); ci.setAttribute('cy', sy(c.y[i][j]));
          ci.setAttribute('r', 3); ci.setAttribute('fill', col);
          svg.appendChild(ci);
        });
      }
    });
  } else if (c.componentType === 'ChartHistogram') {
    c.lower_bounds.forEach((lo, i) => {
      const r = document.createElementNS(ns, 'rect');
      r.setAttribute('x', sx(lo)); r.setAttribute('y', sy(c.y_values[i]));
      r.setAttribute('width', Math.max(1, sx(c.upper_bounds[i]) - sx(lo)));
      r.setAttribute('height', H - pad - sy(c.y_values[i]));
      r.setAttribute('fill', '#1f77b4'); svg.appendChild(r);
    });
  }
  const title = document.createElementNS(ns, 'text');
  title.setAttribute('x', W / 2); title.setAttribute('y', 16);
  title.setAttribute('text-anchor', 'middle');
  title.textContent = c.title || '';
  svg.appendChild(title);
  return svg;
}
"""


class StaticPageUtil:
    """Render components to one self-contained HTML page
    (standalone/StaticPageUtil.renderHTML)."""

    @staticmethod
    def render_html(components: Sequence[Component],
                    title: str = "deeplearning4j_tpu report",
                    refresh_seconds: int = 0) -> str:
        # escape for <script> context: "<" inside JSON strings becomes <
        # so neither "</script>" nor "<!--" (script-data-escaped state) in a
        # ComponentText can break out of the block or inject HTML
        payload = json.dumps([c.to_dict() for c in components]).replace(
            "<", "\\u003c")
        refresh = (f'<meta http-equiv="refresh" content="{int(refresh_seconds)}">'
                   if refresh_seconds else "")
        return f"""<!doctype html>
<html><head><meta charset="utf-8">{refresh}<title>{html.escape(title)}</title>
<script>{_RENDER_JS}</script></head>
<body><h1>{html.escape(title)}</h1><div id="root"></div>
<script>
const COMPONENTS = {payload};
const root = document.getElementById('root');
COMPONENTS.forEach(c => renderComponent(c, root));
</script></body></html>"""

    @staticmethod
    def save_html(components: Sequence[Component], path: str,
                  title: str = "deeplearning4j_tpu report") -> None:
        with open(path, "w") as f:
            f.write(StaticPageUtil.render_html(components, title))
