/* Per-type card renderers for all 22 card types — the client half of the
   UI contract (reference: src/components/canvas/CardRenderer.tsx:56-951 and
   src/components/canvas/cards/). Items arrive pre-filtered per viewer by
   the server's audience gate; data shapes come from view/cards.py. */
"use strict";

const Cards = (() => {
  function h(tag, attrs, ...children) {
    const el = document.createElement(tag);
    for (const [k, v] of Object.entries(attrs || {})) {
      if (k === "class") el.className = v;
      else if (k.startsWith("on")) el.addEventListener(k.slice(2), v);
      else if (v !== null && v !== undefined) el.setAttribute(k, v);
    }
    for (const c of children) {
      if (c === null || c === undefined) continue;
      el.append(c.nodeType ? c : document.createTextNode(String(c)));
    }
    return el;
  }

  function shell(item, title, ...children) {
    const priv = item.data.audience_type === false;
    const el = h("div", {
      class: `card ${item.type.replace(/_/g, "-")}` + (priv ? " private" : ""),
      "data-card": item.type, "data-id": item.id,
    }, title ? h("h4", {}, title) : null, ...children);
    if (priv) el.append(h("div", { class: "private-note" }, "only you can see this"));
    return el;
  }

  function playerName(ctx, pid) {
    const row = (ctx.players || {})[String(pid)];
    return (row && row.name) || `Player ${pid}`;
  }

  function statChips(ctx, valueOf) {
    const chips = h("div", { class: "statchips" });
    for (const pid of Object.keys(ctx.players || {}).sort((a, b) => a - b)) {
      const v = valueOf(ctx.players[pid], pid);
      if (v === null || v === undefined) continue;
      chips.append(h("span", { class: "statchip" }, `${playerName(ctx, pid)}: `, h("b", {}, v)));
    }
    return chips;
  }

  const R = {
    phase_indicator(item) {
      return shell(item, null, item.data.currentPhase || item.name);
    },

    text_display(item) {
      return shell(item, item.data.type === "warning" ? "notice" : null,
        item.data.content || item.name);
    },

    voting_panel(item, ctx) {
      const box = h("div", { class: "vote-options" });
      (item.data.options || []).forEach((opt, i) => {
        const picked = ctx.votedOptions[item.data.votingId] === i + 1;
        box.append(h("button", {
          class: picked ? "picked" : "",
          "data-option": i + 1,
          onclick: () => ctx.onVote(item.data.votingId, i + 1),
        }, `${i + 1}. ${opt}`));
      });
      return shell(item, item.data.title || "Vote", box);
    },

    broadcast_input(item, ctx) {
      const ta = h("textarea", { placeholder: item.data.placeholder || "Type here..." });
      return shell(item, item.data.title || "Your input",
        ta,
        h("div", { class: "row", style: "margin-top:8px" },
          h("button", { onclick: () => ctx.onSubmitText(ta.value) },
            item.data.confirmLabel || "Submit")));
    },

    character_card(item) {
      return shell(item, "Your role",
        h("div", { style: "font-size:18px;font-weight:700" }, item.data.role || "Unknown"),
        h("div", { style: "color:var(--dim);font-size:13px;margin-top:4px" },
          item.data.description || ""));
    },

    result_display(item) {
      return shell(item, "Results", item.data.content || item.name);
    },

    score_board(item, ctx) {
      const entries = [...(item.data.entries || [])];
      if ((item.data.sort || "desc") === "desc") entries.sort((a, b) => b.score - a.score);
      const tbl = h("table", {});
      for (const e of entries) tbl.append(h("tr", {}, h("td", {}, e.name), h("td", {}, e.score)));
      return shell(item, item.data.title || "Scoreboard", h("div", { class: "scoreboard" }, tbl));
    },

    statement_board(item) {
      const ol = h("ol", { class: "statements" });
      (item.data.statements || []).forEach((s, i) => {
        ol.append(h("li", { class: item.data.highlightIndex === i ? "lie" : "" }, s));
      });
      return shell(item, "Statements", ol);
    },

    timer(item) {
      // cosmetic countdown, 250ms tick (reference: cards/Timer.tsx — the
      // wall clock never gates phase flow, P3)
      const face = h("div", { class: "timerface" }, item.data.duration || 10);
      let left = (item.data.duration || 10) * 1000;
      let started = false;
      const iv = setInterval(() => {
        // re-renders replace the card's DOM; a detached face must stop
        // ticking or every state push leaks another live interval
        if (started && !face.isConnected) { clearInterval(iv); return; }
        started = started || face.isConnected;
        left -= 250;
        if (left <= 0) { face.textContent = "Time's up!"; clearInterval(iv); }
        else face.textContent = Math.ceil(left / 1000);
      }, 250);
      return shell(item, item.data.label || "Timer", face);
    },

    reaction_timer(item) {
      const total = (item.data.duration || 10) * 1000;
      const bar = h("div", {});
      const wrap = shell(item, item.data.label || "React!", h("div", { class: "progress" }, bar));
      const started = item.data.startedAt || Date.now();
      let live = false;
      const iv = setInterval(() => {
        if (live && !bar.isConnected) { clearInterval(iv); return; }
        live = live || bar.isConnected;
        const frac = Math.min(1, (Date.now() - started) / total);
        bar.style.width = `${(1 - frac) * 100}%`;
        if (frac >= 1) clearInterval(iv);
      }, 100);
      return wrap;
    },

    turn_indicator(item, ctx) {
      return shell(item, item.data.label || "Current turn",
        h("div", { style: "font-weight:700" },
          item.data.playerName || playerName(ctx, item.data.currentPlayerId)));
    },

    death_marker(item) {
      return shell(item, "Eliminated",
        `☠ ${item.data.playerName || "?"}`,
        item.data.cause ? h("div", { class: "kv" }, `during ${item.data.cause}`) : null);
    },

    coin_display(item, ctx) {
      return shell(item, item.data.title || "Coins",
        statChips(ctx, (row) => row.coins !== undefined ? `${row.coins} \u{1FA99}` : null));
    },

    health_display(item, ctx) {
      return shell(item, item.data.title || "Health",
        statChips(ctx, (row) => {
          const v = row.health !== undefined ? row.health : row.hearts;
          return v === undefined ? null : "❤".repeat(Math.max(0, v)) || "0";
        }));
    },

    influence_set(item, ctx) {
      return shell(item, item.data.title || "Influence",
        statChips(ctx, (row) => {
          const v = row.influence;
          return v === undefined ? null : "■".repeat(Math.max(0, v)) || "out";
        }));
    },

    hands_card(item) {
      const hand = h("div", { class: "hand" });
      for (const c of item.data.cards || ["?", "?"]) {
        hand.append(h("div", { class: "playingcard" }, c));
      }
      return shell(item, item.data.title || "Your hand", hand);
    },

    action_button(item, ctx) {
      return shell(item, null,
        h("button", { onclick: () => ctx.onAction(item.data.value || 1) },
          item.data.label || item.name));
    },

    background_control(item) {
      if (item.data.color) document.body.style.background = item.data.color;
      return null; // no visible card; it themes the canvas
    },

    night_overlay(item) {
      return null; // rendered as the full-canvas dimmer, not a grid card
    },

    avatar_set(item) {
      return null; // rendered as the avatars overlay row, not a grid card
    },

    player_states_display(item, ctx) {
      const tbl = h("table", {});
      const pids = Object.keys(ctx.players || {}).sort((a, b) => a - b);
      for (const pid of pids) {
        const row = ctx.players[pid];
        const pub = Object.entries(row)
          .filter(([k, v]) => v !== null && k !== "name" && typeof v !== "object")
          .map(([k, v]) => `${k}=${v}`).join("  ");
        tbl.append(h("tr", {}, h("td", {}, playerName(ctx, pid)), h("td", {}, pub)));
      }
      return shell(item, item.data.title || "Player states", h("div", { class: "kv" }, tbl));
    },

    player_actions_display(item, ctx) {
      const tbl = h("table", {});
      for (const n of ctx.notes || []) tbl.append(h("tr", {}, h("td", {}, n.text)));
      return shell(item, item.data.title || "Action log", h("div", { class: "kv" }, tbl));
    },
  };

  function render(item, ctx) {
    const fn = R[item.type];
    if (fn) return fn(item, ctx);
    // unknown type: error card (reference: CardRenderer.tsx:946-951)
    return shell(item, "unknown card", `unrenderable type: ${item.type}`);
  }

  return { render, h };
})();
