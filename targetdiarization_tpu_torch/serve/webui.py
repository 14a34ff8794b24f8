"""The browser page at /target-diarization.

Copy of targetdiarization_tpu/serve/webui.py: one self-contained page with
a health check, a file upload through POST /diarization/infer, a table of
segments with speaker badges, playback of the base64 target audio, and
microphone streaming over WS /diarization/stream (16 kHz capture, 1 s
int16 base64 chunks).
"""

from __future__ import annotations

from aiohttp import web

_PAGE = """<!DOCTYPE html>
<html lang="en">
<head>
<meta charset="utf-8">
<title>Target Diarization (GPU)</title>
<style>
 body { font-family: system-ui, sans-serif; margin: 2rem auto; max-width: 900px;
        color: #1a202c; }
 h1 { font-size: 1.4rem; }
 fieldset { border: 1px solid #cbd5e0; border-radius: 8px; margin-bottom: 1rem; }
 button { padding: .45rem .9rem; border-radius: 6px; border: 1px solid #4a5568;
          background: #2d3748; color: #fff; cursor: pointer; }
 button:disabled { opacity: .5; cursor: default; }
 table { border-collapse: collapse; width: 100%; margin-top: 1rem; }
 td, th { border: 1px solid #e2e8f0; padding: .35rem .6rem; font-size: .9rem; }
 .target { background: #c6f6d5; } .other { background: #fed7d7; }
 .uncertain { background: #fefcbf; }
 #status { margin-left: 1rem; font-size: .9rem; color: #4a5568; }
</style>
</head>
<body>
<h1>Target Diarization <small>(PyTorch, CUDA)</small></h1>
<button id="health">Health check</button><span id="status"></span>

<fieldset><legend>Offline inference</legend>
 <p>Audio: <input type="file" id="audio"></p>
 <p>Target (optional): <input type="file" id="target"></p>
 <p><label><input type="checkbox" id="single"> single speaker</label>
    <button id="infer">Run inference</button></p>
 <p id="stats"></p>
 <audio id="targetAudio" controls style="display:none"></audio>
 <table id="results" style="display:none">
  <thead><tr><th>speaker</th><th>type</th><th>time</th><th>text</th><th>score</th></tr></thead>
  <tbody></tbody></table>
</fieldset>

<fieldset><legend>Microphone streaming</legend>
 <p>Target (optional): <input type="file" id="wsTarget">
    <button id="startStream">Start</button>
    <button id="stopStream" disabled>Stop</button></p>
 <table id="wsResults" style="display:none">
  <thead><tr><th>speaker</th><th>type</th><th>time</th><th>text</th></tr></thead>
  <tbody></tbody></table>
</fieldset>

<script>
const $ = (id) => document.getElementById(id);
const setStatus = (msg) => { $("status").textContent = msg; };

$("health").onclick = async () => {
  const r = await fetch("/health");
  const j = await r.json();
  setStatus(`status=${j.status} model_loaded=${j.model_loaded}`);
};

$("infer").onclick = async () => {
  const audio = $("audio").files[0];
  if (!audio) { setStatus("choose an audio file"); return; }
  const form = new FormData();
  form.append("audio_file", audio);
  const target = $("target").files[0];
  if (target) form.append("target_file", target);
  setStatus("running…");
  const qs = `?is_single=${$("single").checked}`;
  const r = await fetch("/diarization/infer" + qs, { method: "POST", body: form });
  const j = await r.json();
  if (!j.success) { setStatus("error: " + j.error); return; }
  setStatus(`done in ${j.processing_time}s`);
  const d = j.data;
  $("stats").textContent =
    `target=${d.target_speaker_id || "-"} speakers=${d.total_speakers} ` +
    `total=${d.statistics.total_duration}s target_dur=` +
    `${d.statistics.target_speaker_duration}s`;
  const tbody = $("results").querySelector("tbody");
  tbody.innerHTML = "";
  for (const seg of d.results) {
    const tr = document.createElement("tr");
    tr.className = seg.speaker_type;
    tr.innerHTML = `<td>${seg.speaker} (${seg.speaker_type})</td>` +
      `<td>${seg.type}</td>` +
      `<td>${seg.timerange[0].toFixed(2)}–${seg.timerange[1].toFixed(2)}s</td>` +
      `<td>${seg.text}</td><td>${seg.score}</td>`;
    tbody.appendChild(tr);
  }
  $("results").style.display = "";
  if (d.target_audio_base64) {
    const pcm = Uint8Array.from(atob(d.target_audio_base64), c => c.charCodeAt(0));
    const wav = pcm16ToWav(pcm, 16000);
    $("targetAudio").src = URL.createObjectURL(new Blob([wav], {type: "audio/wav"}));
    $("targetAudio").style.display = "";
  }
};

function pcm16ToWav(pcmBytes, rate) {
  const header = new ArrayBuffer(44);
  const v = new DataView(header);
  const len = pcmBytes.length;
  const w = (o, s) => { for (let i = 0; i < s.length; i++) v.setUint8(o + i, s.charCodeAt(i)); };
  w(0, "RIFF"); v.setUint32(4, 36 + len, true); w(8, "WAVEfmt ");
  v.setUint32(16, 16, true); v.setUint16(20, 1, true); v.setUint16(22, 1, true);
  v.setUint32(24, rate, true); v.setUint32(28, rate * 2, true);
  v.setUint16(32, 2, true); v.setUint16(34, 16, true); w(36, "data");
  v.setUint32(40, len, true);
  const out = new Uint8Array(44 + len);
  out.set(new Uint8Array(header)); out.set(pcmBytes, 44);
  return out;
}

let ws = null, mediaStream = null, audioCtx = null, buffered = [];
$("startStream").onclick = async () => {
  const proto = location.protocol === "https:" ? "wss" : "ws";
  ws = new WebSocket(`${proto}://${location.host}/diarization/stream`);
  const targetFile = $("wsTarget").files[0];
  ws.onopen = async () => {
    ws.send(JSON.stringify({type: "config", data: {
      sampling_rate: 16000, chunk_duration: 1.0,
      has_target_file: !!targetFile, output_target_audio: false }}));
    if (targetFile) {
      const buf = await targetFile.arrayBuffer();
      const ctx = new AudioContext({sampleRate: 16000});
      const decoded = await ctx.decodeAudioData(buf);
      const f32 = decoded.getChannelData(0);
      const i16 = new Int16Array(f32.length);
      for (let i = 0; i < f32.length; i++)
        i16[i] = Math.max(-32768, Math.min(32767, f32[i] * 32767));
      ws.send(JSON.stringify({type: "target_audio",
        data: btoa(String.fromCharCode(...new Uint8Array(i16.buffer)))}));
    }
  };
  ws.onmessage = (ev) => {
    const m = JSON.parse(ev.data);
    if (m.type === "config_ack") { startMic(); setStatus("streaming…"); }
    else if (m.type === "segment_result") {
      const seg = m.data.segment;
      const tbody = $("wsResults").querySelector("tbody");
      const tr = document.createElement("tr");
      tr.className = seg.speaker_type;
      tr.innerHTML = `<td>${seg.speaker} (${seg.speaker_type})</td>` +
        `<td>${seg.type}</td>` +
        `<td>${seg.timerange[0].toFixed(2)}–${seg.timerange[1].toFixed(2)}s</td>` +
        `<td>${seg.text}</td>`;
      tbody.appendChild(tr);
      $("wsResults").style.display = "";
    } else if (m.type === "status") { setStatus(m.message); }
    else if (m.type === "error") { setStatus("error: " + m.message); }
  };
  $("startStream").disabled = true;
  $("stopStream").disabled = false;
};

async function startMic() {
  mediaStream = await navigator.mediaDevices.getUserMedia({audio: true});
  audioCtx = new AudioContext({sampleRate: 16000});
  const src = audioCtx.createMediaStreamSource(mediaStream);
  const proc = audioCtx.createScriptProcessor(4096, 1, 1);
  src.connect(proc); proc.connect(audioCtx.destination);
  proc.onaudioprocess = (e) => {
    buffered.push(...e.inputBuffer.getChannelData(0));
    while (buffered.length >= 16000) {   // 1 s chunks
      const slice = buffered.splice(0, 16000);
      const i16 = new Int16Array(16000);
      for (let i = 0; i < 16000; i++)
        i16[i] = Math.max(-32768, Math.min(32767, slice[i] * 32767));
      if (ws && ws.readyState === 1)
        ws.send(JSON.stringify({type: "audio_chunk",
          data: btoa(String.fromCharCode(...new Uint8Array(i16.buffer)))}));
    }
  };
}

$("stopStream").onclick = () => {
  if (ws && ws.readyState === 1) ws.send(JSON.stringify({type: "audio_end"}));
  if (mediaStream) mediaStream.getTracks().forEach(t => t.stop());
  if (audioCtx) audioCtx.close();
  $("startStream").disabled = false;
  $("stopStream").disabled = true;
};
</script>
</body>
</html>
"""


async def handle_ui(request):
    return web.Response(text=_PAGE, content_type="text/html")
