"""Single-file web dashboard at reference-frontend parity.

A dependency-free stand-in for the reference's Next.js frontend covering
its observable features (reference: frontend/):

- mode / emotion controls, streaming toggle, push-to-talk with Space /
  's' keyboard UX and 100 ms hold debounce
  (reference: frontend/components/PushToTalk.tsx:29-50)
- live transcript feed (cap 100) + packet history (cap 200), both
  persisted to localStorage and restored on load
  (reference: frontend/hooks/useJanusWebSocket.ts:100-118,193,211)
- auto-reconnect 3 s after socket close
  (reference: frontend/hooks/useJanusWebSocket.ts:240-243)
- health poll of GET /api/health every 30 s
  (reference: frontend/hooks/useBackendHealth.ts:24-25)
- telemetry view: total packets/bytes, last-packet stat card, byte-over-
  time step-line chart, reverse-chronological network log with
  mode/emotion/snippet (reference: frontend/app/telemetry/page.tsx,
  components/{TelemetryGraph,NetworkLog,QuickStats}.tsx)
- voice-clone flow: shows the verification phrase, records mic audio via
  MediaRecorder (audio/webm;codecs=opus) or accepts a file, uploads
  multipart to POST /api/voice/verify, surfaces verified/failed +
  transcript feedback (reference: frontend/components/VoiceCloner.tsx:58-117)

Served at ``GET /`` and ``GET /telemetry`` (the telemetry route opens on
the telemetry tab, mirroring the reference's second page).
"""

DASHBOARD_HTML = """<!doctype html>
<html>
<head>
<meta charset="utf-8"/>
<title>janus_tpu dashboard</title>
<style>
  body { font-family: ui-monospace, monospace; background:#0b1020; color:#dce3f3;
         margin:0; padding:1.5rem; }
  h1 { font-size:1.1rem; letter-spacing:.1em; color:#7aa2ff; }
  .row { display:flex; gap:1.5rem; flex-wrap:wrap; }
  .card { background:#141b33; border:1px solid #26304f; border-radius:10px;
          padding:1rem; min-width:260px; flex:1; }
  .card h2 { font-size:.8rem; text-transform:uppercase; color:#8fa3cc; margin:0 0 .6rem; }
  button, select { background:#1d2747; color:#dce3f3; border:1px solid #33406b;
          border-radius:6px; padding:.45rem .8rem; cursor:pointer; font:inherit; }
  button.active { background:#2b57d0; border-color:#2b57d0; }
  button:disabled { opacity:.45; cursor:default; }
  #ptt { width:100%; padding:1rem; font-size:1rem; }
  #ptt.held { background:#d03a3a; border-color:#d03a3a; }
  ul { list-style:none; padding:0; margin:0; max-height:300px; overflow:auto; }
  li { padding:.3rem 0; border-bottom:1px solid #1d2747; font-size:.85rem; }
  .dim { color:#69789f; }
  .pill { float:right; font-size:.8rem; margin-left:.8rem; }
  .ok { color:#5ad07a; } .bad { color:#d05a5a; } .warn { color:#d0b05a; }
  nav { margin-bottom:1rem; }
  nav button { margin-right:.5rem; }
  .stat { font-size:1.4rem; color:#7aa2ff; }
  .phrase { color:#d0b05a; font-style:italic; }
  #vc-status { min-height:1.2em; display:block; margin-top:.4rem; }
</style>
</head>
<body>
<h1>JANUS_TPU
  <span id="health" class="pill bad" title="GET /api/health every 30s">api: ?</span>
  <span id="status" class="pill bad">disconnected</span>
</h1>
<nav>
  <button id="tab-main" class="active">dashboard</button>
  <button id="tab-telemetry">telemetry</button>
</nav>

<div id="page-main" class="row">
  <div class="card">
    <h2>Controls</h2>
    <div>
      mode:
      <select id="mode">
        <option value="semantic">semantic</option>
        <option value="text_only">text_only</option>
        <option value="morse">morse</option>
      </select>
      emotion:
      <select id="emotion">
        <option value="auto">auto</option>
        <option value="relaxed">relaxed</option>
        <option value="panicked">panicked</option>
      </select>
    </div>
    <p><button id="stream">streaming: off</button></p>
    <p><button id="ptt">HOLD TO TALK (or Space)</button></p>
  </div>
  <div class="card">
    <h2>Voice clone</h2>
    <p>Read this phrase aloud, then upload:</p>
    <p class="phrase" id="vc-phrase">The quick brown fox jumps over the lazy dog.</p>
    <p>
      <button id="vc-record">record</button>
      <input type="file" id="vc-file" accept="audio/*" style="display:none"/>
      <button id="vc-upload">upload file</button>
    </p>
    <span id="vc-status" class="dim">no reference voice</span>
  </div>
  <div class="card">
    <h2>Transcripts</h2>
    <ul id="transcripts"></ul>
  </div>
</div>

<div id="page-telemetry" class="row" style="display:none">
  <div class="card" style="max-width:260px">
    <h2>Quick stats</h2>
    <div>packets <span class="stat" id="stat-packets">0</span></div>
    <div>bytes <span class="stat" id="stat-bytes">0</span></div>
    <div>last packet <span class="stat" id="stat-last">–</span></div>
  </div>
  <div class="card">
    <h2>Packet bytes over time</h2>
    <canvas id="chart" width="520" height="90"
            style="width:100%;height:90px;background:#0e1428;border-radius:6px"></canvas>
  </div>
  <div class="card" style="flex-basis:100%">
    <h2>Network log</h2>
    <ul id="packets"></ul>
  </div>
</div>

<script>
const wsUrl = (location.protocol === "https:" ? "wss://" : "ws://") +
              location.host + "/ws/janus";
let ws = null, state = {is_streaming:false, is_recording:false};

// ---- persistence (reference caps: transcripts 100, packets 200) ----
const LS_T = "janus:transcripts", LS_P = "janus:packets";
function loadJSON(k) { try { return JSON.parse(localStorage.getItem(k)) || []; }
                       catch (e) { return []; } }
let transcripts = loadJSON(LS_T);     // [{text, avg_pitch_hz}]
let packetHistory = loadJSON(LS_P);   // [{bytes, mode, emotion, snippet, created_at_ms}]
function persist() {
  transcripts = transcripts.slice(0, 100);
  packetHistory = packetHistory.slice(0, 200);
  try { localStorage.setItem(LS_T, JSON.stringify(transcripts));
        localStorage.setItem(LS_P, JSON.stringify(packetHistory)); } catch (e) {}
}

// ---- tabs (reference pages / and /telemetry) ----
function showTab(name) {
  document.getElementById("page-main").style.display =
    name === "main" ? "flex" : "none";
  document.getElementById("page-telemetry").style.display =
    name === "telemetry" ? "flex" : "none";
  document.getElementById("tab-main").className = name === "main" ? "active" : "";
  document.getElementById("tab-telemetry").className =
    name === "telemetry" ? "active" : "";
  if (name === "telemetry") drawChart();
}
document.getElementById("tab-main").onclick = () => showTab("main");
document.getElementById("tab-telemetry").onclick = () => showTab("telemetry");

// ---- telemetry rendering ----
function drawChart() {
  const c = document.getElementById("chart");
  const ctx = c.getContext("2d");
  ctx.clearRect(0, 0, c.width, c.height);
  const hist = packetHistory.slice(0, 60).reverse().map(p => Number(p.bytes));
  if (!hist.length) return;
  const max = Math.max(...hist, 1);
  const w = c.width / Math.max(hist.length, 1);
  ctx.strokeStyle = "#7aa2ff"; ctx.lineWidth = 1.5;
  ctx.beginPath();
  hist.forEach((b, i) => {
    const y = c.height - 4 - (b / max) * (c.height - 10);
    if (i === 0) ctx.moveTo(i * w, y);
    else { ctx.lineTo(i * w, y); }         // step-line like the reference
    ctx.lineTo((i + 1) * w, y);
  });
  ctx.stroke();
}
function renderStats() {
  const totalBytes = packetHistory.reduce((a, p) => a + Number(p.bytes), 0);
  document.getElementById("stat-packets").textContent = packetHistory.length;
  document.getElementById("stat-bytes").textContent = totalBytes;
  document.getElementById("stat-last").textContent =
    packetHistory.length ? packetHistory[0].bytes + "B" : "–";
}
function esc(s) {
  const d = document.createElement("span");
  d.textContent = String(s);
  return d.innerHTML;
}
function addItem(listId, html, cap) {
  // callers escape remote strings with esc(); html here is trusted markup
  const li = document.createElement("li");
  li.innerHTML = html;
  const ul = document.getElementById(listId);
  ul.prepend(li);
  while (ul.children.length > cap) ul.removeChild(ul.lastChild);
}
function renderAll() {
  document.getElementById("transcripts").innerHTML = "";
  document.getElementById("packets").innerHTML = "";
  [...transcripts].reverse().forEach(t => addItem("transcripts",
    `"${esc(t.text)}"` + (t.avg_pitch_hz
      ? ` <span class=dim>${Number(t.avg_pitch_hz).toFixed(0)}Hz</span>` : ""), 100));
  [...packetHistory].reverse().forEach(p => addItem("packets",
    `${Number(p.bytes)}B [${esc(p.mode)}]` +
    (p.emotion ? ` ${esc(p.emotion)}` : "") +
    (p.snippet ? ` <span class=dim>${esc(p.snippet)}</span>` : ""), 200));
  renderStats(); drawChart();
}

// ---- websocket (auto-reconnect after 3 s, reference :240-243) ----
function connect() {
  ws = new WebSocket(wsUrl);
  ws.onopen = () => { const s = document.getElementById("status");
                      s.textContent = "connected"; s.className = "pill ok"; };
  ws.onclose = () => { const s = document.getElementById("status");
                       s.textContent = "disconnected"; s.className = "pill bad";
                       setTimeout(connect, 3000); };
  ws.onmessage = (ev) => {
    const m = JSON.parse(ev.data);
    if (m.type === "control_state") {
      state = m;
      document.getElementById("mode").value = m.mode;
      document.getElementById("emotion").value = m.emotion_override;
      document.getElementById("stream").textContent =
        "streaming: " + (m.is_streaming ? "on" : "off");
      document.getElementById("stream").className = m.is_streaming ? "active" : "";
    } else if (m.type === "transcript") {
      transcripts.unshift({text: m.text, avg_pitch_hz: m.avg_pitch_hz});
      persist();
      addItem("transcripts", `"${esc(m.text)}"` +
        (m.avg_pitch_hz ? ` <span class=dim>${m.avg_pitch_hz.toFixed(0)}Hz</span>` : ""),
        100);
    } else if (m.type === "packet_summary") {
      packetHistory.unshift({bytes: Number(m.bytes), mode: m.mode,
        emotion: m.emotion, snippet: m.snippet, created_at_ms: m.created_at_ms});
      persist();
      addItem("packets", `${Number(m.bytes)}B [${esc(m.mode)}]` +
        (m.emotion ? ` ${esc(m.emotion)}` : "") +
        (m.snippet ? ` <span class=dim>${esc(m.snippet)}</span>` : ""), 200);
      renderStats(); drawChart();
    }
  };
}
function send(obj) {
  if (ws && ws.readyState === 1) ws.send(JSON.stringify({type:"control", ...obj}));
}

// ---- health poll (reference: every 30 s) ----
async function pollHealth() {
  const el = document.getElementById("health");
  try {
    const r = await fetch("/api/health");
    const ok = r.ok && (await r.json()).status === "ok";
    el.textContent = ok ? "api: ok" : "api: degraded";
    el.className = "pill " + (ok ? "ok" : "warn");
  } catch (e) { el.textContent = "api: down"; el.className = "pill bad"; }
}
setInterval(pollHealth, 30000);

// ---- controls ----
document.getElementById("mode").onchange = (e) => send({mode: e.target.value});
document.getElementById("emotion").onchange = (e) => send({emotion_override: e.target.value});
document.getElementById("stream").onclick = () => send({is_streaming: !state.is_streaming});
const ptt = document.getElementById("ptt");
let holdTimer = null;
function hold(h) {          // 100 ms debounce (reference PushToTalk.tsx:29-30)
  ptt.className = h ? "held" : "";
  clearTimeout(holdTimer);
  holdTimer = setTimeout(() => send({is_recording: h}), 100);
}
ptt.onmousedown = () => hold(true);
ptt.onmouseup = () => hold(false);
ptt.onmouseleave = () => { if (state.is_recording) hold(false); };
ptt.ontouchstart = (e) => { e.preventDefault(); hold(true); };
ptt.ontouchend = (e) => { e.preventDefault(); hold(false); };
window.addEventListener("keydown", (e) => {
  if (e.target.tagName === "SELECT" || e.target.tagName === "INPUT") return;
  if (e.code === "Space" && !e.repeat) { e.preventDefault(); hold(true); }
  if (e.key === "s") send({is_streaming: !state.is_streaming});
});
window.addEventListener("keyup", (e) => {
  if (e.code === "Space") { e.preventDefault(); hold(false); }
});

// ---- voice clone (reference VoiceCloner.tsx:58-117) ----
const vcStatus = document.getElementById("vc-status");
async function uploadVoice(blob, filename) {
  vcStatus.textContent = "verifying…"; vcStatus.className = "warn";
  const form = new FormData();
  // reference field name + filename (VoiceCloner.tsx:111)
  form.append("audio_file", blob, filename);
  try {
    const r = await fetch("/api/voice/verify", {method: "POST", body: form});
    const body = await r.json();
    if (body.status === "verified") {
      vcStatus.textContent = "verified — voice saved as reference";
      vcStatus.className = "ok";
    } else {
      vcStatus.textContent = "failed — heard: \\u201c" +
        (body.transcript || "") + "\\u201d";
      vcStatus.className = "bad";
    }
  } catch (e) { vcStatus.textContent = "upload error: " + e; vcStatus.className = "bad"; }
}
let recorder = null, chunks = [];
const recBtn = document.getElementById("vc-record");
recBtn.onclick = async () => {
  if (recorder && recorder.state === "recording") { recorder.stop(); return; }
  if (!navigator.mediaDevices) {
    vcStatus.textContent = "no microphone access — use upload file";
    vcStatus.className = "warn"; return;
  }
  try {
    const stream = await navigator.mediaDevices.getUserMedia({audio: true});
    chunks = [];
    recorder = new MediaRecorder(stream, {mimeType: "audio/webm;codecs=opus"});
    recorder.ondataavailable = (e) => chunks.push(e.data);
    recorder.onstop = () => {
      stream.getTracks().forEach(t => t.stop());
      recBtn.textContent = "record"; recBtn.className = "";
      uploadVoice(new Blob(chunks, {type: "audio/webm"}), "recording.webm");
    };
    recorder.start();
    recBtn.textContent = "stop + verify"; recBtn.className = "active";
    vcStatus.textContent = "recording…"; vcStatus.className = "warn";
  } catch (e) { vcStatus.textContent = "mic error: " + e; vcStatus.className = "bad"; }
};
const vcFile = document.getElementById("vc-file");
document.getElementById("vc-upload").onclick = () => vcFile.click();
vcFile.onchange = () => {
  if (vcFile.files.length) uploadVoice(vcFile.files[0], vcFile.files[0].name);
};

// ---- boot ----
renderAll();
pollHealth();
connect();
if (location.pathname === "/telemetry") showTab("telemetry");
</script>
</body>
</html>
"""
