"""Single-file dashboard UI (no build step, no external deps).

Reference: ``python/ray/dashboard/client/`` is a React/TypeScript app; this
build ships the same information surface as one static page of vanilla JS
polling the REST API — cluster summary tiles plus tabbed live tables for
nodes, workers, actors, tasks, objects, and placement groups.
"""

INDEX_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>ray_tpu_torch dashboard</title>
<style>
  :root { --fg:#1a1a1a; --muted:#6b6b6b; --line:#e3e3e3; --bg:#fafafa;
          --accent:#2563eb; --ok:#15803d; --bad:#b91c1c; }
  * { box-sizing:border-box; }
  body { margin:0; font:14px/1.45 system-ui,-apple-system,sans-serif;
         color:var(--fg); background:var(--bg); }
  header { padding:14px 20px; background:#fff;
           border-bottom:1px solid var(--line); display:flex;
           align-items:baseline; gap:14px; }
  header h1 { font-size:16px; margin:0; }
  header .sub { color:var(--muted); font-size:12px; }
  .tiles { display:flex; flex-wrap:wrap; gap:12px; padding:16px 20px; }
  .tile { background:#fff; border:1px solid var(--line); border-radius:8px;
          padding:10px 16px; min-width:130px; }
  .tile .v { font-size:22px; font-weight:600; }
  .tile .l { color:var(--muted); font-size:12px; }
  .tile svg.spark { display:block; margin-top:4px; }
  .tile svg.spark polyline { fill:none; stroke:var(--accent);
                             stroke-width:1.5; }
  nav { display:flex; gap:2px; padding:0 20px; }
  nav button { border:1px solid var(--line); border-bottom:none;
               background:#f1f1f1; padding:7px 14px; cursor:pointer;
               border-radius:6px 6px 0 0; font:inherit; }
  nav button.on { background:#fff; font-weight:600;
                  color:var(--accent); }
  main { margin:0 20px 20px; background:#fff;
         border:1px solid var(--line); border-radius:0 8px 8px 8px;
         overflow:auto; }
  table { border-collapse:collapse; width:100%; }
  th,td { text-align:left; padding:6px 12px; white-space:nowrap;
          border-bottom:1px solid var(--line); font-size:13px; }
  th { position:sticky; top:0; background:#fff; color:var(--muted);
       font-weight:600; }
  td.num { font-variant-numeric:tabular-nums; }
  .ok { color:var(--ok); } .bad { color:var(--bad); }
  .empty { padding:24px; color:var(--muted); }
</style></head>
<body>
<header><h1>ray_tpu_torch</h1>
  <span class="sub" id="session"></span>
  <span class="sub" id="updated"></span>
  <span class="sub" style="margin-left:auto">
    <a href="/metrics">metrics</a> &middot;
    <a href="/api/timeline">timeline</a></span></header>
<div class="tiles" id="tiles"></div>
<nav id="tabs"></nav>
<main id="table"></main>
<script>
const TABS = {
  nodes: ["node_id","alive","num_workers","resources_total",
          "resources_available","labels"],
  workers: ["worker_id","node_id","pid","state","actor_id"],
  actors: ["actor_id","class_name","state","name","node_id","pid"],
  tasks: ["task_id","name","state","worker_id"],
  objects: ["object_id","loc","size","refcount","state"],
  placement_groups: ["pg_id","name","strategy","state","bundles",
                     "assignment"],
};
let tab = "nodes";
// header sparklines: tile label -> TSDB expression served by
// /metrics/history (the head keeps the history; one GET per tile)
const SPARKS = {
  "tasks/s": "sum(rate(rtt_tasks_total[60s]))",
  "serve req/s": "sum(rate(rtt_serve_requests_total[60s]))",
  "train p50, slowest rank (s)":
    "max(quantile_over_time(0.5, rtt_train_step_seconds[10m]))",
};
let sparkData = {};   // label -> [[ts, v], ...]
const esc = s => String(s).replace(/[&<>"']/g, c => ({
  "&": "&amp;", "<": "&lt;", ">": "&gt;", '"': "&quot;", "'": "&#39;",
}[c]));
function sparkline(points) {
  // inline SVG polyline over the last window; flat/empty history
  // renders an empty strip (no misleading axis)
  if (!points || points.length < 2) return "";
  const vs = points.map(p => p[1]);
  const [w, h] = [96, 22];
  const lo = Math.min(...vs), hi = Math.max(...vs);
  const span = (hi - lo) || 1;
  const pts = points.map((p, i) =>
    `${(i / (points.length - 1) * w).toFixed(1)},` +
    `${(h - 2 - (p[1] - lo) / span * (h - 4)).toFixed(1)}`).join(" ");
  return `<svg class="spark" width="${w}" height="${h}"
    viewBox="0 0 ${w} ${h}"><polyline points="${pts}"/></svg>`;
}
async function refreshSparks() {
  for (const [label, expr] of Object.entries(SPARKS)) {
    try {
      const r = await (await fetch("/metrics/history?series=" +
        encodeURIComponent(expr) + "&window=600&step=15")).json();
      const rows = r.results || [];
      sparkData[label] = rows.length ? rows[0].points : [];
    } catch (e) { /* head TSDB disabled: tiles stay sparkline-free */ }
  }
}
const fmt = v => {
  // every API value is attacker-influencable (actor names, labels,
  // error strings) — escape BEFORE any innerHTML interpolation
  if (v === null || v === undefined) return "";
  if (typeof v === "boolean")
    return `<span class="${v ? "ok" : "bad"}">${v}</span>`;
  if (typeof v === "object") return esc(JSON.stringify(v));
  if (typeof v === "string" && /^(ALIVE|READY|ok|idle|FINISHED)$/.test(v))
    return `<span class="ok">${v}</span>`;
  if (typeof v === "string" && /^(DEAD|FAILED|dead|ERROR)$/.test(v))
    return `<span class="bad">${v}</span>`;
  return esc(String(v));
};
function renderTabs() {
  document.getElementById("tabs").innerHTML = Object.keys(TABS).map(t =>
    `<button class="${t===tab?"on":""}"
       onclick="tab='${t}';renderTabs();refresh()">${t}</button>`).join("");
}
async function refresh() {
  try {
    const s = await (await fetch("/api/cluster_summary")).json();
    const count = x => (x && typeof x === "object")
      ? Object.values(x).reduce((a, b) => a + (+b || 0), 0) : (x ?? 0);
    const spark = l => sparkline(sparkData[l]);
    const tiles = [
      ["nodes", count(s.nodes)], ["actors", count(s.actors)],
      ["tasks", count(s.tasks)], ["objects", s.objects.count],
      ["object bytes", (s.objects.total_bytes/1048576).toFixed(1)+" MB"],
      ["CPU avail", (s.resources_available.CPU??0) + " / " +
                    (s.resources_total.CPU??0)],
    ];
    // history-backed tiles: shown once the head TSDB has data for them
    for (const label of Object.keys(SPARKS)) {
      const pts = sparkData[label] || [];
      if (pts.length) tiles.push([label, pts[pts.length-1][1].toFixed(1)]);
    }
    if ((s.resources_total.GPU??0) > 0)
      tiles.push(["GPU avail", (s.resources_available.GPU??0) + " / " +
                               s.resources_total.GPU]);
    document.getElementById("tiles").innerHTML = tiles.map(([l,v]) =>
      `<div class="tile"><div class="v">${v}</div>
       <div class="l">${l}</div>${spark(l)}</div>`).join("");
    document.getElementById("session").textContent = s.session || "";
    const rows = await (await fetch("/api/" + tab)).json();
    const cols = TABS[tab];
    document.getElementById("table").innerHTML = rows.length ?
      `<table><thead><tr>${cols.map(c=>`<th>${c}</th>`).join("")}</tr>
       </thead><tbody>${rows.map(r =>
         `<tr>${cols.map(c => `<td class="${typeof r[c]==="number"?
           "num":""}">${fmt(r[c])}</td>`).join("")}</tr>`).join("")}
       </tbody></table>`
      : `<div class="empty">no ${tab}</div>`;
    document.getElementById("updated").textContent =
      "updated " + new Date().toLocaleTimeString();
  } catch (e) {
    document.getElementById("updated").textContent = "refresh failed: " + e;
  }
}
renderTabs(); refreshSparks().then(refresh);
setInterval(refresh, 2000); setInterval(refreshSparks, 15000);
</script></body></html>
"""
