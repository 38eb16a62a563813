"""Self-contained HTML QC report renderer (FastQC's report analog).

`render_html(report)` turns a `QCReport` (models/qc.py) into one standalone
HTML file: stat tiles, per-position quality and base-composition lines, and
the distribution panels, as inline SVG with a light/dark theme, hover
tooltips, and a table view per panel. No third-party dependencies — the
report is generated by the library, not a plotting stack, so it works in
any environment the parser works in.

Reference scope note: the reference ships no report renderer (its consumers
print counters, SURVEY.md §5); this is a capability extension on top of the
QCStats panels, mirroring what FastQC users expect from a QC run.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

# Validated default palette (dataviz reference instance): categorical slots
# in fixed order; single-series charts use slot 1. Light/dark are selected
# steps of the same hues, not an automatic flip.
_LIGHT = dict(surface="#fcfcfb", panel="#f4f3f1", grid="#e4e3df",
              text="#0b0b0b", text2="#52514e",
              series=["#2a78d6", "#eb6834", "#1baf7a", "#eda100", "#e87ba4"])
_DARK = dict(surface="#1a1a19", panel="#242423", grid="#383835",
             text="#ffffff", text2="#c3c2b7",
             series=["#3987e5", "#d95926", "#199e70", "#c98500", "#d55181"])

_W, _H = 720, 200
_ML, _MR, _MT, _MB = 46, 10, 8, 26  # plot margins inside the svg


def _fmt(v) -> str:
    v = float(v)
    if v == int(v) and abs(v) < 1e15:
        n = int(v)
        if abs(n) >= 10000:
            for div, suf in ((1e12, "T"), (1e9, "G"), (1e6, "M"), (1e3, "k")):
                if abs(n) >= div:
                    return "%.2f%s" % (n / div, suf)
        return str(n)
    return "%.3g" % v


def _ticks(lo: float, hi: float, n: int = 4):
    if hi <= lo:
        hi = lo + 1
    raw = (hi - lo) / n
    mag = 10 ** np.floor(np.log10(raw))
    step = min((m for m in (1, 2, 5, 10) if m * mag >= raw),
               default=10) * mag
    t0 = np.ceil(lo / step) * step
    return list(np.arange(t0, hi + step * 0.5, step))


class _Panel:
    """One chart panel: inline SVG + a <details> table view."""

    def __init__(self, title: str, xlabel: str, ylabel: str):
        self.title = title
        self.xlabel = xlabel
        self.ylabel = ylabel
        self.series = []  # (name, xs, ys, kind) kind: line|bar

    def add(self, name: str, xs, ys, kind: str = "line"):
        xs = np.asarray(xs, dtype=np.float64)
        ys = np.asarray(ys, dtype=np.float64)
        if xs.size:
            self.series.append((name, xs, ys, kind))
        return self

    # -- geometry -----------------------------------------------------------
    def _extent(self):
        xs = np.concatenate([s[1] for s in self.series])
        ys = np.concatenate([s[2] for s in self.series])
        x0, x1 = float(xs.min()), float(xs.max())
        y1 = float(ys.max()) if ys.size else 1.0
        if x1 <= x0:
            x1 = x0 + 1
        return x0, x1, 0.0, y1 * 1.06 if y1 > 0 else 1.0

    def _sx(self, x, x0, x1):
        return _ML + (x - x0) / (x1 - x0) * (_W - _ML - _MR)

    def _sy(self, y, y1):
        return _H - _MB - (y / y1) * (_H - _MT - _MB)

    # -- render -------------------------------------------------------------
    def svg(self, pid: str) -> str:
        if not self.series:
            return ""
        x0, x1, _y0, y1 = self._extent()
        out = ['<svg class="chart" role="img" viewBox="0 0 %d %d" '
               'aria-label="%s" data-pid="%s">' % (_W, _H, self.title, pid)]
        # recessive grid + axis text
        for ty in _ticks(0, y1 / 1.06):
            sy = self._sy(ty, y1)
            out.append('<line class="grid" x1="%d" x2="%d" y1="%.1f" '
                       'y2="%.1f"/>' % (_ML, _W - _MR, sy, sy))
            out.append('<text class="tick" x="%d" y="%.1f" '
                       'text-anchor="end">%s</text>'
                       % (_ML - 5, sy + 3.5, _fmt(ty)))
        for tx in _ticks(x0, x1):
            sx = self._sx(tx, x0, x1)
            out.append('<text class="tick" x="%.1f" y="%d" '
                       'text-anchor="middle">%s</text>'
                       % (sx, _H - _MB + 16, _fmt(tx)))
        out.append('<line class="axis" x1="%d" x2="%d" y1="%.1f" y2="%.1f"/>'
                   % (_ML, _W - _MR, _H - _MB, _H - _MB))
        n_pts = max(s[1].size for s in self.series)
        for si, (name, xs, ys, kind) in enumerate(self.series):
            color = 'var(--s%d)' % (si % 5)
            if kind == "bar":
                # thin bars, 2px surface gap, 4px rounded data end anchored
                # to the baseline (clip keeps the bottom corners square)
                bw = max((_W - _ML - _MR) / max(xs.size, 1) - 2, 1.0)
                cid = "c%s_%d" % (pid, si)
                out.append('<defs><clipPath id="%s"><rect x="0" y="0" '
                           'width="%d" height="%.1f"/></clipPath></defs>'
                           % (cid, _W, _H - _MB))
                out.append('<g clip-path="url(#%s)">' % cid)
                for x, y in zip(xs, ys):
                    sx = self._sx(x, x0, x1) - bw / 2
                    sy = self._sy(y, y1)
                    h = _H - _MB - sy
                    if h <= 0:
                        continue
                    out.append(
                        '<rect class="bar" x="%.1f" y="%.1f" width="%.1f" '
                        'height="%.1f" rx="4" fill="%s">'
                        '<title>%s: %s → %s</title></rect>'
                        % (sx, sy, bw, h + 4, color, self.xlabel,
                           _fmt(x), _fmt(y)))
                out.append('</g>')
            else:
                pts = " ".join("%.1f,%.1f" % (self._sx(x, x0, x1),
                                              self._sy(y, y1))
                               for x, y in zip(xs, ys))
                out.append('<polyline class="line" fill="none" stroke="%s" '
                           'points="%s"/>' % (color, pts))
                # direct label at the line's end for <=4 series
                if 1 < len(self.series) <= 4:
                    out.append('<text class="dlabel" x="%.1f" y="%.1f" '
                               'fill="%s">%s</text>'
                               % (self._sx(xs[-1], x0, x1) - 4,
                                  self._sy(ys[-1], y1) - 5, color, name))
        # hover layer data for line charts (nearest-x tooltip)
        if any(s[3] == "line" for s in self.series) and n_pts > 1:
            data = {
                "x0": x0, "x1": x1, "y1": y1,
                "ml": _ML, "mr": _MR, "mt": _MT, "mb": _MB,
                "w": _W, "h": _H, "xl": self.xlabel,
                "series": [
                    dict(name=name, xs=[round(float(v), 4) for v in xs],
                         ys=[round(float(v), 4) for v in ys])
                    for name, xs, ys, kind in self.series if kind == "line"],
            }
            import json

            out.append('<script type="application/json" class="hoverdata">'
                       '%s</script>' % json.dumps(data))
        out.append("</svg>")
        return "".join(out)

    def html(self, pid: str) -> str:
        if not self.series:
            return ""
        legend = ""
        if len(self.series) > 1:
            legend = '<div class="legend">' + "".join(
                '<span><i style="background:var(--s%d)"></i>%s</span>'
                % (i % 5, name)
                for i, (name, _x, _y, _k) in enumerate(self.series)) \
                + "</div>"
        # table view: accessibility + the light-mode relief rule for
        # sub-contrast series colors
        head = "<tr><th>%s</th>%s</tr>" % (
            self.xlabel,
            "".join("<th>%s</th>" % n for n, _x, _y, _k in self.series))
        xs0 = self.series[0][1]
        rows = []
        for i, x in enumerate(xs0):
            cells = "".join(
                "<td>%s</td>" % (_fmt(ys[i]) if i < len(ys) else "")
                for _n, _xs, ys, _k in self.series)
            rows.append("<tr><td>%s</td>%s</tr>" % (_fmt(x), cells))
        table = ('<details><summary>Table view</summary><div class="tbl">'
                 "<table>%s%s</table></div></details>"
                 % (head, "".join(rows)))
        return ('<section class="panel"><h3>%s</h3>%s%s'
                '<div class="axlbl">%s — %s</div>%s</section>'
                % (self.title, legend, self.svg(pid), self.xlabel,
                   self.ylabel, table))


_JS = """
document.querySelectorAll('svg.chart').forEach(function (svg) {
  var dn = svg.querySelector('script.hoverdata');
  if (!dn) return;
  var d = JSON.parse(dn.textContent);
  var ns = 'http://www.w3.org/2000/svg';
  var vl = document.createElementNS(ns, 'line');
  vl.setAttribute('class', 'cross'); vl.setAttribute('y1', d.mt);
  vl.setAttribute('y2', d.h - d.mb); vl.style.display = 'none';
  svg.appendChild(vl);
  var tip = document.createElement('div');
  tip.className = 'tip'; tip.style.display = 'none';
  svg.parentNode.style.position = 'relative';
  svg.parentNode.appendChild(tip);
  function sx(x) { return d.ml + (x - d.x0) / (d.x1 - d.x0) * (d.w - d.ml - d.mr); }
  svg.addEventListener('mousemove', function (ev) {
    var r = svg.getBoundingClientRect();
    var px = (ev.clientX - r.left) * d.w / r.width;
    var fx = d.x0 + (px - d.ml) / (d.w - d.ml - d.mr) * (d.x1 - d.x0);
    var xs = d.series[0].xs, best = 0, bd = 1e18;
    for (var i = 0; i < xs.length; i++) {
      var dd = Math.abs(xs[i] - fx); if (dd < bd) { bd = dd; best = i; }
    }
    vl.setAttribute('x1', sx(xs[best])); vl.setAttribute('x2', sx(xs[best]));
    vl.style.display = '';
    var html = '<b>' + d.xl + ' ' + xs[best] + '</b>';
    d.series.forEach(function (s) {
      if (best < s.ys.length)
        html += '<br>' + (s.name || '') + ' ' + s.ys[best];
    });
    tip.innerHTML = html;
    tip.style.display = 'block';
    tip.style.left = Math.min(ev.clientX - r.left + 12,
                              r.width - 160) + 'px';
    tip.style.top = '12px';
  });
  svg.addEventListener('mouseleave', function () {
    vl.style.display = 'none'; tip.style.display = 'none';
  });
});
"""


def _css() -> str:
    def block(p):
        return (
            "--surface:%s;--panelbg:%s;--grid:%s;--text:%s;--text2:%s;"
            % (p["surface"], p["panel"], p["grid"], p["text"], p["text2"])
            + "".join("--s%d:%s;" % (i, c)
                      for i, c in enumerate(p["series"])))

    return """
:root { color-scheme: light dark; }
body { %s }
@media (prefers-color-scheme: dark) { body { %s } }
body[data-theme="dark"] { %s }
body { background: var(--surface); color: var(--text);
  font: 14px/1.45 system-ui, sans-serif; margin: 0 auto; max-width: 780px;
  padding: 18px; }
h1 { font-size: 20px; } h3 { font-size: 15px; margin: 4px 0 6px; }
.meta { color: var(--text2); font-size: 12px; }
.tiles { display: flex; flex-wrap: wrap; gap: 10px; margin: 14px 0; }
.tile { background: var(--panelbg); border-radius: 8px; padding: 10px 14px;
  min-width: 96px; }
.tile .v { font-size: 20px; font-weight: 600; }
.tile .k { color: var(--text2); font-size: 11.5px; }
.panel { background: var(--panelbg); border-radius: 8px; padding: 12px 14px;
  margin: 12px 0; }
svg.chart { width: 100%%; height: auto; display: block; }
.grid { stroke: var(--grid); stroke-width: 1; }
.axis { stroke: var(--text2); stroke-width: 1; }
.tick { fill: var(--text2); font-size: 10.5px; }
.dlabel { font-size: 11px; text-anchor: end; }
.line { stroke-width: 2; }
.bar:hover { opacity: .8; }
.cross { stroke: var(--text2); stroke-dasharray: 3 3; }
.tip { position: absolute; background: var(--surface); color: var(--text);
  border: 1px solid var(--grid); border-radius: 6px; padding: 6px 9px;
  font-size: 12px; pointer-events: none; box-shadow: 0 2px 8px #0003; }
.legend { display: flex; gap: 14px; font-size: 12px; color: var(--text2);
  margin-bottom: 4px; }
.legend i { display: inline-block; width: 10px; height: 10px;
  border-radius: 2px; margin-right: 5px; }
.axlbl { color: var(--text2); font-size: 11px; margin-top: 2px; }
details { margin-top: 6px; font-size: 12px; }
summary { cursor: pointer; color: var(--text2); }
.tbl { max-height: 240px; overflow: auto; }
table { border-collapse: collapse; width: 100%%; }
td, th { padding: 2px 8px; text-align: right; border-bottom: 1px solid
  var(--grid); }
""" % (block(_LIGHT), block(_DARK), block(_DARK))


def _trimmed(a, limit: Optional[int] = None):
    a = np.asarray(a, dtype=np.float64)
    nz = np.flatnonzero(a)
    n = int(nz[-1]) + 1 if nz.size else 0
    if limit:
        n = min(n, limit)
    return a[:n]


def render_html(report, title: str = "blazeseq_tpu QC report") -> str:
    """Render a QCReport (or its to_dict()) as a standalone HTML page."""
    d = report.to_dict() if hasattr(report, "to_dict") else dict(report)

    tiles = [("reads", d["reads"]), ("bases", d["bases"]),
             ("error reads", d["error_reads"]),
             ("GC %", "%.2f" % (100.0 * d["gc_fraction"])),
             ("mean Q", "%.2f" % d["mean_quality"])]
    if "frac_unique_reads" in d:
        tiles.append(("unique reads %",
                      "%.1f" % (100.0 * d["frac_unique_reads"])))

    panels = []
    ppq = np.asarray(d.get("per_position_mean_quality", []), np.float64)
    qq = d.get("quality_quartiles")
    if qq:
        # FastQC per-base quality panel: decile/quartile/median percentile
        # traces (QCModel(track_quartiles=True)) with the mean overlaid
        p = _Panel("Per-position quality (percentiles)", "position", "Phred")
        med = np.asarray(qq["median"], np.float64)
        xs = np.arange(1, med.size + 1)
        p.add("median", xs, med)
        p.add("q1", xs, np.asarray(qq["q1"], np.float64))
        p.add("q3", xs, np.asarray(qq["q3"], np.float64))
        p.add("p10", xs, np.asarray(qq["p10"], np.float64))
        p.add("p90", xs, np.asarray(qq["p90"], np.float64))
        if ppq.size >= med.size:
            p.add("mean", xs, ppq[: med.size])
        panels.append(p)
    elif ppq.size:
        panels.append(_Panel("Per-position mean quality", "position",
                             "mean Phred")
                      .add("mean Q", np.arange(1, ppq.size + 1), ppq))
    bc = d.get("base_counts", {})
    ppc = np.asarray(d.get("per_pos_count", []), np.float64)
    ppb = np.asarray(d.get("per_pos_base_counts", []), np.float64)
    if ppc.size and ppb.ndim == 2 and ppb.shape[1] == ppc.size:
        p = _Panel("Per-position base composition", "position", "% of reads")
        safe = np.maximum(ppc, 1.0)
        xs = np.arange(1, ppc.size + 1)
        for i, name in enumerate(["A", "C", "G", "T", "other"]):
            p.add(name, xs, 100.0 * ppb[i] / safe)
        panels.append(p)
    qh = _trimmed(d.get("qual_hist", []))
    if qh.size:
        panels.append(_Panel("Phred score histogram", "Phred", "bases")
                      .add("bases", np.arange(qh.size), qh, "bar"))
    gh = _trimmed(d.get("gc_hist", []), 101)
    if gh.size:
        panels.append(_Panel("Per-read GC content", "GC %", "reads")
                      .add("reads", np.arange(gh.size), gh))
    lh = _trimmed(d.get("length_hist", []))
    if lh.size:
        panels.append(_Panel("Read length distribution", "length", "reads")
                      .add("reads", np.arange(lh.size), lh, "bar"))
    mh = _trimmed(d.get("mean_qual_hist", []))
    if mh.size:
        panels.append(_Panel("Per-read mean quality", "mean Phred", "reads")
                      .add("reads", np.arange(mh.size), mh, "bar"))
    ads = d.get("adapters") or {}
    if ads:
        p = _Panel("Adapter content (cumulative)", "position",
                   "% reads with adapter")
        for name, st in list(ads.items())[:4]:
            fo = np.asarray(st.get("first_occurrence", []), np.float64)
            scanned = max(float(st.get("reads_scanned", 0)), 1.0)
            if fo.size:
                p.add(name[:12], np.arange(1, fo.size + 1),
                      100.0 * np.cumsum(fo) / scanned)
        panels.append(p)
    dl = np.asarray(d.get("duplication_levels", []), np.float64)
    if dl.size > 1:
        panels.append(_Panel("Sequence duplication levels",
                             "copies (10 = 10+)", "distinct sequences")
                      .add("sequences", np.arange(1, dl.size), dl[1:],
                           "bar"))
    over = d.get("overrepresented") or []

    html = ["<!doctype html><html><head><meta charset='utf-8'>",
            "<meta name='viewport' content='width=device-width, "
            "initial-scale=1'>",
            "<title>%s</title><style>%s</style></head><body>"
            % (title, _css()),
            "<h1>%s</h1>" % title,
            "<div class='meta'>generated by blazeseq_tpu · base counts: "
            + " ".join("%s %s" % (k, _fmt(v)) for k, v in bc.items())
            + "</div>",
            "<div class='tiles'>" + "".join(
                "<div class='tile'><div class='v'>%s</div>"
                "<div class='k'>%s</div></div>" % (_fmt(v) if isinstance(
                    v, (int, float)) else v, k)
                for k, v in tiles) + "</div>"]
    for i, p in enumerate(panels):
        html.append(p.html("p%d" % i))
    if over:
        rows = "".join("<tr><td style='text-align:left;font-family:"
                       "monospace'>%s</td><td>%s</td></tr>"
                       % (o["sequence"], _fmt(o["count"])) for o in over)
        html.append("<section class='panel'><h3>Overrepresented sequences"
                    "</h3><div class='tbl'><table><tr><th "
                    "style='text-align:left'>sequence (50bp prefix)</th>"
                    "<th>count</th></tr>%s</table></div></section>" % rows)
    html.append("<script>%s</script></body></html>" % _JS)
    return "".join(html)


def write_html(report, path, title: str = "blazeseq_tpu QC report") -> None:
    with open(path, "w", encoding="utf-8") as f:
        f.write(render_html(report, title=title))
