/* Play-page state hub: polls the per-viewer AgentState, renders the 3x3
   canvas + overlays, drives votes / text submits / continue, and the chat
   dock. The client-side twin of the reference's useCoAgent page
   (reference: src/app/page.tsx:147-181, 2855-2909) over the JSON state
   the host projects (view/decode.py + view/project.py). */
"use strict";

const App = (() => {
  const { h } = Cards;
  const qs = new URLSearchParams(location.search);
  const roomId = qs.get("room");
  const playerId = parseInt(qs.get("player") || "1", 10);

  const S = {
    lastVersion: -1,
    snap: null,
    votedOptions: {},   // votingId -> picked option (local echo)
    submitted: {},      // phase_id -> true once text submitted
    busy: false,
    finishedShown: false,
    pollTimer: null,
  };

  const api = async (method, path, body) => {
    const r = await fetch(path, {
      method,
      headers: { "Content-Type": "application/json" },
      body: body ? JSON.stringify(body) : undefined,
    });
    return r.json();
  };

  // ---- actions -----------------------------------------------------------

  async function onVote(votingId, option) {
    if (S.busy) return;
    S.busy = true;
    S.votedOptions[votingId] = option;
    await api("POST", `/api/rooms/${roomId}/vote`, { playerId, option });
    await doContinue();
    S.busy = false;
  }

  async function onSubmitText(text) {
    if (S.busy || !text.trim()) return;
    S.busy = true;
    await api("POST", `/api/rooms/${roomId}/action`, { playerId, choice: 1, text });
    // same key the HITL dialog checks: never re-prompt for this phase
    if (S.snap) S.submitted[`p${S.snap.current_phase_id}`] = "submitted";
    await doContinue();
    S.busy = false;
  }

  async function onAction(choice) {
    if (S.busy) return;
    S.busy = true;
    await api("POST", `/api/rooms/${roomId}/action`, { playerId, choice });
    await doContinue();
    S.busy = false;
  }

  async function doContinue() {
    // step phase-by-phase so the player WATCHES transitions — night
    // overlays, role reveals, death markers — instead of teleporting to the
    // next input point (the reference advances one phase per Continue)
    for (let i = 0; i < 200; i++) {
      const snap = await api("POST", `/api/rooms/${roomId}/step`, { playerId });
      if (!snap.error) {
        S.lastVersion = snap.stateVersion;
        S.snap = snap;
        render(snap);
      }
      if (snap.done || (snap.waiting_on || []).length) return;
      await new Promise((r) => setTimeout(r, 350));
    }
  }

  async function sendChat() {
    const input = document.getElementById("chatin");
    if (!input.value.trim()) return;
    await api("POST", `/api/rooms/${roomId}/chat`, { playerId, message: input.value });
    input.value = "";
    await refreshChat();
  }

  // ---- polling + render ----------------------------------------------------

  async function refresh(force) {
    const snap = await api("GET", `/api/rooms/${roomId}/state?playerId=${playerId}`);
    if (snap.error) {
      document.getElementById("phase").textContent = snap.error;
      return;
    }
    if (!force && snap.stateVersion === S.lastVersion) return;
    S.lastVersion = snap.stateVersion;
    S.snap = snap;
    render(snap);
  }

  let lastChatFetch = 0;

  function maybeRefreshChat() {
    // renders arrive per phase step; the chat log doesn't need refetching
    // more than ~once a second (own posts call refreshChat directly)
    if (Date.now() - lastChatFetch < 1200) return;
    refreshChat();
  }

  async function refreshChat() {
    lastChatFetch = Date.now();
    const d = await api("GET", `/api/rooms/${roomId}/chat?playerId=${playerId}`);
    const box = document.getElementById("chatmsgs");
    box.replaceChildren(...(d.messages || []).map((m) =>
      h("div", { class: `msg ${m.type} ${m.visibility}` },
        h("span", { class: "who" }, m.playerName + ": "), m.message)));
    box.scrollTop = box.scrollHeight;
    const nd = await api("GET", `/api/rooms/${roomId}/notes`);
    document.getElementById("notes").replaceChildren(
      ...(nd.game_notes || []).slice(-8).map((n) => h("div", {}, n.text)));
  }

  function render(snap) {
    // leaving a phase clears its submit/dismiss bookkeeping, so looping
    // games (speaker rounds) re-prompt on the next visit to the same phase
    const cur = `p${snap.current_phase_id}`;
    for (const k of Object.keys(S.submitted)) {
      if (k !== cur) delete S.submitted[k];
    }
    const ctx = {
      players: snap.player_states || {},
      dead: snap.deadPlayers || [],
      notes: snap.game_notes || [],
      votedOptions: S.votedOptions,
      viewerId: playerId,
      onVote, onSubmitText, onAction,
    };

    // header
    document.getElementById("phase").textContent =
      `${snap.current_phase_id}: ${snap.current_phase_name}`;
    const wait = document.getElementById("waiting");
    const waitingOn = snap.waiting_on || [];
    if (snap.done) {
      wait.className = "badge ok";
      wait.textContent = `game over — winner: ${winnerText(snap)}`;
    } else if (waitingOn.length) {
      wait.className = "badge";
      wait.textContent = waitingOn.includes(playerId)
        ? "your move"
        : "waiting on " + waitingOn.map((p) => name(ctx, p)).join(", ");
    } else {
      wait.className = "badge ok";
      wait.textContent = "bots thinking — press continue";
    }

    // avatars overlay (dead = grayscale + skull; reference:
    // CardRenderer.tsx:570-725 avatar overlay semantics)
    const av = document.getElementById("avatars");
    av.replaceChildren();
    const hasAvatarSet = (snap.items || []).some((i) => i.type === "avatar_set");
    if (hasAvatarSet) {
      for (const pid of Object.keys(ctx.players).sort((a, b) => a - b)) {
        const row = ctx.players[pid];
        const cls = ["avatar"];
        if (ctx.dead.includes(pid)) cls.push("dead");
        if (parseInt(pid, 10) === playerId) cls.push("you");
        if (row.is_speaker) cls.push("speaker");
        if (waitingOn.includes(parseInt(pid, 10))) cls.push("waiting");
        av.append(h("div", { class: cls.join(" "), "data-player": pid },
          h("div", { class: "face" }, (row.name || `P${pid}`)[0].toUpperCase()),
          h("div", { class: "nm" }, row.name || `Player ${pid}`)));
      }
    }

    // night overlay dimmer (reference: cards/NightOverlay.tsx)
    const night = (snap.items || []).find(
      (i) => i.type === "night_overlay" && i.data.visible !== false);
    const nightEl = document.getElementById("night");
    nightEl.className = night ? "on" : "";
    nightEl.textContent = night ? (night.data.title || "NIGHT") : "";

    // 3x3 grid with z-priority phase_indicator > other > text_display
    const cells = {};
    for (const pos of ["top-left", "top-center", "top-right", "middle-left",
                       "center", "middle-right", "bottom-left", "bottom-center",
                       "bottom-right"]) cells[pos] = [];
    const prio = (it) => it.type === "phase_indicator" ? 0 : it.type === "text_display" ? 2 : 1;
    const gridItems = (snap.items || [])
      .filter((i) => !["avatar_set", "night_overlay", "background_control"].includes(i.type))
      .sort((a, b) => prio(a) - prio(b));
    for (const it of gridItems) {
      const el = Cards.render(it, ctx);
      if (el) (cells[it.data.position] || cells.center).push(el);
    }
    // background_control side effect still applies
    for (const it of (snap.items || []).filter((i) => i.type === "background_control")) {
      Cards.render(it, ctx);
    }
    const canvas = document.getElementById("canvas");
    canvas.replaceChildren(...Object.entries(cells).map(([pos, els]) =>
      h("div", { class: "cell", "data-pos": pos }, ...els)));

    if (snap.done && !S.finishedShown) {
      S.finishedShown = true;
      cells.center.push(null); // banner handled in header
    }
    const pre = document.getElementById("inspector");
    if (pre && pre.style.display !== "none") {
      pre.textContent = JSON.stringify(snap, null, 1);
    }
    maybePromptDialog(snap);  // both transports (SSE and polling fallback)
    maybeRefreshChat();
  }

  function name(ctx, pid) {
    const row = ctx.players[String(pid)];
    return (row && row.name) || `Player ${pid}`;
  }

  function winnerText(snap) {
    const notes = snap.game_notes || [];
    const over = [...notes].reverse().find((n) => /winner|wins|game over/i.test(n.text));
    if (over) return over.text.replace(/^.*?:\s*/, "");
    return snap.winner > 0 ? name({ players: snap.player_states }, snap.winner) : "draw";
  }

  function exitGame() {
    sessionStorage.removeItem("roomSession");
    location.href = "/library";
  }

  // ---- HITL prompt dialog (the reference's promptUserText modal) ----------

  function maybePromptDialog(snap) {
    if (document.getElementById("hitl")) return;
    if (!(snap.waiting_on || []).includes(playerId)) return;
    const input = (snap.items || []).find((i) => i.type === "broadcast_input");
    if (!input) return;
    const phaseKey = `p${snap.current_phase_id}`;
    if (phaseKey in S.submitted) return;  // submitted or dismissed
    const ta = h("textarea", { placeholder: input.data.placeholder || "Type here..." });
    const dlg = h("div", { class: "overlaybg", id: "hitl" },
      h("div", { class: "dialog" },
        h("h3", {}, input.data.title || "Your input is needed"),
        ta,
        h("div", { class: "row", style: "margin-top:10px" },
          h("button", {
            onclick: () => { dlg.remove(); onSubmitText(ta.value); },
          }, input.data.confirmLabel || "Submit"),
          h("button", {
            class: "secondary",
            onclick: () => { S.submitted[phaseKey] = "dismissed"; dlg.remove(); },
          }, "Write on the canvas instead"))));
    document.body.append(dlg);
    ta.focus();
  }

  // ---- transport: SSE push with polling fallback ---------------------------

  function startStream() {
    if (!window.EventSource) {
      S.pollTimer = setInterval(() => refresh(false), 1500);
      return;
    }
    const es = new EventSource(`/api/rooms/${roomId}/events?playerId=${playerId}`);
    es.onmessage = (e) => {
      const snap = JSON.parse(e.data);
      S.lastVersion = snap.stateVersion;
      S.snap = snap;
      render(snap);
    };
    es.addEventListener("gone", () => es.close());
    es.onerror = () => {
      es.close();
      setTimeout(startStream, 2000);  // reconnect; server caps stream length
    };
  }

  function start() {
    if (!roomId) { location.href = "/library"; return; }
    document.getElementById("contBtn").addEventListener("click", doContinue);
    document.getElementById("exitBtn").addEventListener("click", exitGame);
    // JSON state inspector (reference: page.tsx:2784-2791 debug toggle)
    document.getElementById("debugBtn").addEventListener("click", () => {
      const pre = document.getElementById("inspector");
      const on = pre.style.display === "none";
      pre.style.display = on ? "block" : "none";
      if (on && S.snap) pre.textContent = JSON.stringify(S.snap, null, 1);
    });
    document.getElementById("chatform").addEventListener("submit", (e) => {
      e.preventDefault();
      sendChat();
    });
    refresh(true);
    startStream();
  }

  return { start, onVote, onSubmitText, onAction, doContinue, _state: S };
})();

document.addEventListener("DOMContentLoaded", App.start);
