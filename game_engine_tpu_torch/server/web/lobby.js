/* Lobby flow: register -> game library -> room lobby -> play.
   (reference pages: src/app/register/page.tsx:49-63 name -> sessionStorage,
   src/app/game-library/page.tsx:17-171 grid, src/app/[game]/room/page.tsx:
   153-377 create/join/add-bots/start, src/app/dsl-generator/page.tsx.) */
"use strict";

const Lobby = (() => {
  const api = async (method, path, body) => {
    const r = await fetch(path, {
      method,
      headers: { "Content-Type": "application/json" },
      body: body ? JSON.stringify(body) : undefined,
    });
    return r.json();
  };
  const session = () => JSON.parse(sessionStorage.getItem("playerSession") || "null");
  const el = (id) => document.getElementById(id);
  function h(tag, attrs, ...children) {
    const e = document.createElement(tag);
    for (const [k, v] of Object.entries(attrs || {})) {
      if (k === "class") e.className = v;
      else if (k.startsWith("on")) e.addEventListener(k.slice(2), v);
      else e.setAttribute(k, v);
    }
    for (const c of children) if (c != null) e.append(c.nodeType ? c : String(c));
    return e;
  }

  // ---- register ------------------------------------------------------------

  function registerPage() {
    const form = el("regform");
    const existing = session();
    if (existing) el("pname").value = existing.playerName;
    form.addEventListener("submit", (e) => {
      e.preventDefault();
      const name = el("pname").value.trim();
      if (!name) return;
      sessionStorage.setItem("playerSession", JSON.stringify({ playerName: name }));
      location.href = "/library";
    });
  }

  // ---- game library ----------------------------------------------------------

  async function libraryPage() {
    if (!session()) { location.href = "/register"; return; }
    el("who").textContent = session().playerName;
    const d = await api("GET", "/api/games");
    const grid = el("games");
    grid.replaceChildren();
    for (const g of d.games) {
      const rooms = h("div", { class: "roomslot" });
      const details = h("div", { class: "roomslot" });
      const card = h("div", { class: "gamecard", "data-game": g.name },
        h("h3", {}, g.name),
        h("div", { class: "desc" }, g.description),
        h("div", { class: "meta" }, `min players: ${g.minPlayers}` +
          (g.isMultiplayer ? " · multiplayer" : "")),
        h("div", { class: "row" },
          h("button", { onclick: () => createRoom(g.name) }, "Create room"),
          h("button", { class: "secondary", onclick: () => listRooms(g.name, rooms) },
            "Find rooms"),
          h("button", { class: "secondary", onclick: () => showExplain(g.name, details) },
            "Rules")),
        rooms, details);
      grid.append(card);
    }
    el("genform").addEventListener("submit", async (e) => {
      e.preventDefault();
      el("genout").textContent = "generating…";
      const res = await api("POST", "/api/generate-dsl", {
        gameName: el("genname").value, gameDescription: el("gendesc").value,
      });
      // generation-honesty warnings (e.g. low description coverage) are
      // shown in full — a substituted archetype game must never look like
      // a silent success
      el("genout").textContent = res.error
        ? `✗ ${res.error} ${(res.issues || []).join("; ")}`
        : `✓ created ${res.filename}` +
          (res.warnings && res.warnings.length
            ? `\n⚠ ${res.warnings.join("\n⚠ ")}` : "");
      if (!res.error) libraryPage();
    });
  }

  async function showExplain(gameName, box) {
    // compile-explain digest (/api/games/<name>/explain): phase flow +
    // attached mechanics, so players can read the rules the ENGINE will
    // actually apply, not just the card blurb
    if (box.childElementCount) { box.replaceChildren(); return; } // toggle
    box.replaceChildren(h("div", { class: "meta" }, "loading…"));
    const d = await api("GET", `/api/games/${encodeURIComponent(gameName)}/explain`);
    box.replaceChildren();
    if (d.error) { box.append(h("div", { class: "meta" }, `✗ ${d.error}`)); return; }
    if (d.roles && d.roles.length)
      box.append(h("div", { class: "meta" }, `roles: ${d.roles.join(", ")}`));
    for (const p of d.phases) {
      const mech = (p.mechanics || []).join("; ");
      box.append(h("div", { class: "meta" },
        `${p.id}. ${p.name}` + (p.terminal ? " (end)" : "") +
        (mech ? ` — ${mech}` : "")));
    }
  }

  async function createRoom(gameName) {
    const d = await api("POST", "/api/rooms/create",
      { gameName, playerName: session().playerName });
    if (d.error) { alert(d.error); return; }
    sessionStorage.setItem("roomSession", JSON.stringify(
      { roomId: d.room.roomId, playerId: d.player.id }));
    location.href = `/room?roomId=${d.room.roomId}`;
  }

  async function listRooms(gameName, box) {
    const d = await api("GET", `/api/rooms/list?game=${encodeURIComponent(gameName)}`);
    box.replaceChildren();
    if (!d.rooms || !d.rooms.length) {
      box.append(h("div", { class: "meta" }, "no open rooms — create one"));
      return;
    }
    for (const r of d.rooms) {
      box.append(h("div", { class: "roomrow" },
        h("span", {}, `${r.hostName}'s room · ${r.playerCount}/${r.maxPlayers}`),
        h("button", { onclick: () => joinRoom(r.roomId) }, "Join")));
    }
  }

  async function joinRoom(roomId) {
    const d = await api("POST", "/api/rooms/join",
      { roomId, playerName: session().playerName });
    if (d.error) { alert(d.error); return; }
    sessionStorage.setItem("roomSession", JSON.stringify(
      { roomId, playerId: d.player.id }));
    location.href = `/room?roomId=${roomId}`;
  }

  // ---- room lobby ------------------------------------------------------------

  async function roomPage() {
    const qs = new URLSearchParams(location.search);
    const roomId = qs.get("roomId");
    const rs = JSON.parse(sessionStorage.getItem("roomSession") || "null");
    if (!roomId || !session()) { location.href = "/library"; return; }
    const myId = rs && rs.roomId === roomId ? rs.playerId : null;

    async function tick() {
      const d = await api("GET", `/api/rooms/${roomId}`);
      if (d.error) { el("roomname").textContent = d.error; return; }
      el("roomname").textContent = `${d.room.gameName}`;
      el("roomid").textContent = roomId;
      const list = el("players");
      list.replaceChildren(...d.players.map((p) => h("li", {},
        h("span", {}, p.name),
        p.isHost ? h("span", { class: "tag host" }, "host") : null,
        p.isBot ? h("span", { class: "tag bot" }, "bot") : null,
        p.id === myId ? h("span", { class: "tag you" }, "you") : null)));
      el("count").textContent =
        `${d.players.length}/${d.room.maxPlayers} players (min ${d.room.minPlayers})`;
      const isHost = d.players.some((p) => p.id === myId && p.isHost);
      el("hostrow").style.display = isHost ? "flex" : "none";
      el("startBtn").disabled = d.players.length < d.room.minPlayers;
      if (d.room.status === "playing") {
        location.href = `/play?room=${roomId}&player=${myId || 1}`;
      }
    }

    el("botsBtn").addEventListener("click", async () => {
      await api("POST", "/api/rooms/add-bot", { roomId });
      tick();
    });
    el("startBtn").addEventListener("click", async () => {
      const body = {};
      const rounds = parseInt(el("rounds").value || "1", 10);
      if (rounds > 1) body.roundsPerPlayer = rounds;
      const d = await api("POST", `/api/rooms/${roomId}/start`, body);
      if (d.error) { alert(d.error); return; }
      location.href = `/play?room=${roomId}&player=${myId || 1}`;
    });
    tick();
    setInterval(tick, 2000);
  }

  return { registerPage, libraryPage, roomPage };
})();
