"""Host side of the policy-net kernels K2-K4.

Counterpart of game_engine_tpu/policies/fused.py for the deepsets/attn net:

  make_apply    (params, obs) -> (logits, value), a torch.autograd.Function
                whose forward launches K2 (which replaces fused.py:299) and
                whose backward launches K3 (fused.py:468). obs gets no
                gradient. CUDA tensors launch the kernels, CPU tensors take
                the plain version.
  make_loss_vg  (params, obs, legal, actions, logp_old, adv, ret, mask) ->
                ((loss, metrics), grads) through K4 (which replaces
                fused.py:600): forward, PPO cotangents and gradient in one
                call. The steps before the kernel stay plain torch
                (fused.py:646-680): the masked advantage normalisation, the
                one-hot actions and the wrow/vrow row weights. The kernels
                mask the ragged edges themselves, so no row padding.

The kernels are csrc/lossgrad.cu + lossgrad.cuh: K2 (lg_forward), K3
(lg_grad) and K4 (lg_lossgrad) as pipelines of bf16 tensor-core products and
elementwise stages over chunks of rows, sharing one set of forward stages.
The weights are packed to bf16 once per parameter state (``_packed``). They
cover every net ``supports`` accepts: the deepsets/attn archs with one
attention head at any encoder and trunk width (the products run on the
widths padded to multiples of 32, the LayerNorm and the attention scale on
the true ones), any number of seats, actions and trunk layers, as the JAX
kernels do. A chunk's rows are as many as its scratch budget holds, so a
wide room takes smaller chunks, not more memory. What is left is the
int32 addressing of the flat parameters (MAX_PARAMS); ``unsupported``
names it for a net past it, and every entry that would launch a kernel for
such a net raises (``runs_on_card`` where the port picks the route
itself).

Each kernel has its plain-torch version here: ``fused_forward_plain``
follows _fwd_body's cast points (K2), autograd through it is K3's, and
``loss_vg_plain`` is K4's. A wrapper given CUDA tensors launches its kernel
or raises; ``host_forward``, ``host_grads`` and ``host_loss_grads`` run the
kernels' own stages built with g++ on CPU tensors (plain-loop products,
csrc/lossgrad_host.cpp). Each kernel wrapper counts its launches in
``<wrapper>.launches``, and K2's and K4's run inside the spans
ge.entry.K2 and ge.entry.K4; ``kernel_plan`` reports their chunks and
scratch.
"""

from __future__ import annotations

import dataclasses
import math
import weakref

import numpy as np
import torch
import torch.nn.functional as F

from game_engine_tpu_torch.gamespec.tables import Lowered
from game_engine_tpu_torch import _build
from game_engine_tpu_torch.policies import net as N
from game_engine_tpu_torch.policies.net import bf, gelu
from game_engine_tpu_torch.utils.metrics import span

_F32 = torch.float32
MAX_PARAMS = 2 ** 31 - 1  # lossgrad.cuh addresses the flat parameters with int32 offsets
N_STATS = 4
CHUNK_ROWS = 32768  # K3's and K4's rows per chunk: about 2.6 GB of scratch at the attn net's width
NSPLIT = 32         # their row ranges per weight-gradient product (one slab each)
FWD_CHUNK_ROWS = 32768  # K2's rows per chunk: about 0.9 GB of scratch at the attn net's width
# the scratch a chunk may take: fewer rows a chunk where a row takes more
# (seats enter the attention's buffers squared), so memory stays bounded
SCRATCH_BUDGET = 3 << 30      # K3, K4
FWD_SCRATCH_BUDGET = 1 << 30  # K2
# lossgrad.cuh parameter slots; w0 is the trunk's first weight, from which
# the kernels find every layer's (Net::tw, tb)
_SLOT = {"w_phi0": 0, "b_phi0": 1, "w_phi1": 2, "b_phi1": 3, "ln_s": 4, "ln_b": 5,
         "w_qkv": 6, "w_ao": 7, "w_ptr": 8, "w_pi": 9, "b_pi": 10, "w_v": 11, "b_v": 12,
         "w0": 13}
_N_SLOTS = len(_SLOT)


@dataclasses.dataclass(frozen=True)
class Dims:
    """Static shape config for one (lowered game, net config) pair."""

    P: int          # seats
    F0: int         # per-target feature width
    NP: int         # phase count (one-hot width in globals)
    hp: int         # encoder width
    hidden: int     # trunk width
    layers: int     # trunk depth
    n_opt: int      # option-head width
    A: int          # unified action width = max(P, n_opt)
    has_attn: bool

    @property
    def G(self) -> int:  # viewer one-hot + phase one-hot + alive fraction
        return self.P + self.NP + 1

    @property
    def F(self) -> int:
        return self.P * self.F0 + self.G

    @property
    def trunk_in(self) -> int:
        return 2 * self.hp + self.NP + 1


def dims_for(lowered: Lowered, cfg: N.NetConfig) -> Dims:
    n_opt = max(1, int(lowered.choice_max.max()))
    return Dims(P=lowered.P, F0=N._per_player_dim(lowered), NP=lowered.NP,
                hp=max(32, cfg.hidden // 2), hidden=cfg.hidden, layers=cfg.layers,
                n_opt=n_opt, A=max(lowered.P, n_opt), has_attn=cfg.arch == "attn")


def _n_params(d: Dims) -> int:
    return sum(math.prod(shape) for shape in _param_shapes(d).values())


def _bound(d: Dims) -> str | None:
    """The pipelines' bound that the net passes, or None."""
    if d.layers < 1:
        return f"the kernels need at least one trunk layer, not {d.layers}"
    if _n_params(d) > MAX_PARAMS:
        return (f"the kernels address at most MAX_PARAMS = {MAX_PARAMS} parameters, "
                f"not {_n_params(d)}")
    return None


def covers_arch(cfg: N.NetConfig) -> bool:
    """The JAX kernels' own test (its fused.supports): deepsets/attn with one
    attention head. A net of another arch runs net.apply_net, as in JAX."""
    return cfg.arch in ("deepsets", "attn") and cfg.attn_heads == 1


def unsupported(lowered: Lowered, cfg: N.NetConfig) -> str | None:
    """Why the kernels do not cover the net, or None when they do."""
    if not covers_arch(cfg):
        return (f"the kernels cover deepsets/attn with one attention head, not "
                f"arch={cfg.arch!r} with {cfg.attn_heads} heads")
    return _bound(dims_for(lowered, cfg))


def supports(lowered: Lowered, cfg: N.NetConfig) -> bool:
    """Whether K2, K3 and K4 cover the net: deepsets/attn with one attention
    head, any width, seats, actions and depth, within _bound."""
    return unsupported(lowered, cfg) is None


def runs_on_card(lowered: Lowered, cfg: N.NetConfig, device) -> bool:
    """Whether the kernels run the net on `device` where the caller leaves
    the choice to the port: on a CUDA device, for a net of an arch they
    cover. Such a net past _bound raises there, naming it: the plain version
    does not take the kernels' place unasked."""
    if torch.device(device).type != "cuda" or not covers_arch(cfg):
        return False
    _require_pipeline(dims_for(lowered, cfg), "the policy-net kernels")
    return True


# ---------------------------------------------------------------------------
# parameter marshalling: dict -> flat buffers in a fixed order
# ---------------------------------------------------------------------------

def _param_names(d: Dims) -> list[str]:
    names = ["w_phi0", "b_phi0", "w_phi1", "b_phi1"]
    if d.has_attn:
        names += ["ln_s", "ln_b", "w_qkv", "w_ao"]
    names += ["w_ptr"]
    for i in range(d.layers):
        names += [f"w{i}", f"b{i}"]
    names += ["w_pi", "b_pi", "w_v", "b_v"]
    return names


def _param_shapes(d: Dims) -> dict[str, tuple]:
    hp, H = d.hp, d.hidden
    shapes = {"w_phi0": (d.F0, hp), "b_phi0": (hp,), "w_phi1": (hp, hp), "b_phi1": (hp,),
              "ln_s": (hp,), "ln_b": (hp,), "w_qkv": (hp, 3 * hp), "w_ao": (hp, hp),
              "w_ptr": (H, hp), "w_pi": (H, d.n_opt), "b_pi": (d.n_opt,),
              "w_v": (H, 1), "b_v": (1,)}
    for i in range(d.layers):
        shapes[f"w{i}"] = (d.trunk_in if i == 0 else H, H)
        shapes[f"b{i}"] = (H,)
    return {n: shapes[n] for n in _param_names(d)}


def _meta(d: Dims) -> np.ndarray:
    """lossgrad.cuh's Net as int32: the true dims, then the float offset in
    the flat buffers (in _param_names order) of each parameter with a slot;
    the trunk's layers after w0 follow it in order."""
    off = np.zeros(_N_SLOTS, np.int32)
    at = 0
    for name, shape in _param_shapes(d).items():
        if name in _SLOT:
            off[_SLOT[name]] = at
        at += math.prod(shape)
    return np.concatenate([np.array(
        [d.P, d.F0, d.NP, d.hp, d.hidden, d.layers, d.n_opt, d.A, int(d.has_attn), at],
        np.int32), off])


def _flat_params(params: dict, d: Dims, device) -> list:
    """The parameters as f32 tensors in _param_names order; raises on a
    missing or misshapen param or one on another device."""
    out = []
    for name, shape in _param_shapes(d).items():
        p = params[name]
        if tuple(p.shape) != shape:
            raise ValueError(f"param {name} has shape {tuple(p.shape)}, expected {shape}")
        if p.device != device:
            raise ValueError(f"param {name} is on {p.device}, the rows on {device}")
        out.append(p.detach().to(_F32))
    return out


def _require_pipeline(d: Dims, what: str) -> None:
    bound = _bound(d)
    if bound is not None:
        raise ValueError(f"{what}: {bound}")


@dataclasses.dataclass
class _Packed:
    """The pipelines' view of one parameter state: prm, the flat f32
    parameters (biases, LayerNorm affine); weights, lg_pack's bf16 forward
    and transposed packings; what the state was (refs, stamp); and on CUDA
    the stream that packed it and an event recorded after the packing."""

    prm: torch.Tensor
    weights: torch.Tensor
    meta: np.ndarray
    refs: list
    stamp: tuple
    stream: object = None
    ready: object = None

    def live(self) -> bool:
        return all(ref() is not None for ref in self.refs)


PACK_SLOTS = 4  # parameter states kept packed per (dims, device)
_pack_cache: dict = {}  # (dims, device) -> [_Packed], the least recently used first


def _pipeline_lib(device):
    """The pipelines' library for tensors on `device`: the CUDA kernels, or
    on the CPU the host harness."""
    return _build.lossgrad_host_lib() if device.type == "cpu" else _build.lossgrad_lib()


def _use_on_current_stream(pk: _Packed, device) -> _Packed:
    """Order a packing before its use on the current stream when another
    stream packed it, and tell the caching allocator that this stream reads
    its buffers, so their memory is not handed out again until this
    stream's work on them is done, even after the packing is evicted."""
    if device.type == "cuda":
        cur = torch.cuda.current_stream(device)
        if cur != pk.stream:
            cur.wait_event(pk.ready)
            pk.prm.record_stream(cur)
            pk.weights.record_stream(cur)
    return pk


def _packed(d: Dims, params: dict, device) -> _Packed:
    """The packed parameters, packed anew only for a state not seen among the
    last PACK_SLOTS: the unroll calls K2 33 times a train step on the same
    parameters, a league unroll alternates the learner's and the opponent's,
    and the pipeline keeps an actor copy beside the learner's. A state is
    the tensor objects, their addresses and their autograd version counters,
    which every in-place update bumps (Tensor.add_, an optimizer step,
    copy_). A write through ``p.data`` bypasses the counter: do not update
    parameters that way between calls."""
    tensors = [params[name] for name in _param_names(d)]
    stamp = tuple((p.data_ptr(), p._version) for p in tensors)
    entries = _pack_cache.setdefault((d, device), [])
    for i, hit in enumerate(entries):
        if hit.stamp == stamp and all(ref() is p for ref, p in zip(hit.refs, tensors)):
            entries.append(entries.pop(i))
            return _use_on_current_stream(hit, device)
    prm = torch.cat([p.reshape(-1) for p in _flat_params(params, d, device)]).contiguous()
    meta = _meta(d)
    weights = torch.empty((int(_pipeline_lib(device).lg_weights_bytes(meta.ctypes.data)),),
                          dtype=torch.uint8, device=device)
    _lg_call("lg_pack", (meta.ctypes.data, prm.data_ptr(), weights.data_ptr()), device,
             "weight packing")
    _packed.packs += 1
    out = _Packed(prm, weights, meta, [weakref.ref(p) for p in tensors], stamp)
    if device.type == "cuda":
        out.stream = torch.cuda.current_stream(device)
        out.ready = torch.cuda.Event()
        out.ready.record(out.stream)
    # states whose tensors are gone can never match again: drop them first
    entries[:] = [e for e in entries if e.live()] + [out]
    del entries[:-PACK_SLOTS]
    return out


_packed.packs = 0


def _lg_call(name: str, args: tuple, device, what: str) -> None:
    """One entry of the pipeline library, on the host, or on `device`'s
    current stream with `device` made torch's current card for the call (its
    launches and kernel attributes go to the tensors' card, whichever is
    current); raises on its error."""
    lib = _pipeline_lib(device)
    if device.type == "cpu":
        if getattr(lib, name + "_host")(*args) != 0:
            raise RuntimeError(f"host {what} failed")
        return
    with torch.cuda.device(device):
        err = getattr(lib, name)(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{what} launch failed: {lib.lg_error_string(err).decode()}")


def _chunk(lib, meta: np.ndarray, n: int, chunk_rows: int, nsplit: int, fwd_only: int) -> int:
    """Rows a chunk of a call over n rows: chunk_rows, or fewer where they
    would take more scratch than the budget (K2's or K3's and K4's), at
    least one."""
    budget = FWD_SCRATCH_BUDGET if fwd_only else SCRATCH_BUDGET

    def size(rows):
        return int(lib.lg_scratch_bytes(meta.ctypes.data, rows, nsplit, fwd_only))

    per_row = (size(2048) - size(1024)) / 1024
    fits = max(1, int((budget - (size(1024) - 1024 * per_row)) // per_row))
    while fits > 1 and size(fits) > budget:  # each buffer rounds up to 256 bytes
        fits = fits * 15 // 16
    return max(1, min(n, chunk_rows, fits))


def kernel_plan(d: Dims) -> dict:
    """How the kernels run the net on the current CUDA device: rows per
    chunk (at most the budget's, see _chunk) and scratch bytes (in all and
    a row) of K2, K3 and K4."""
    _require_pipeline(d, "kernel_plan")
    meta = _meta(d)
    lib = _build.lossgrad_lib()
    if len(meta) != lib.lg_meta_ints():
        raise RuntimeError("lossgrad.cuh's Net layout differs from fused.py's")

    def scratch(chunk_rows, nsplit, fwd_only):
        chunk = _chunk(lib, meta, chunk_rows, chunk_rows, nsplit, fwd_only)
        one, two = (int(lib.lg_scratch_bytes(meta.ctypes.data, c, nsplit, fwd_only))
                    for c in (chunk, 2 * chunk))
        return {"chunk_rows": chunk, "scratch_bytes": one,
                "scratch_bytes_per_row": (two - one) // chunk}

    grad = {**scratch(CHUNK_ROWS, NSPLIT, 0), "nsplit": NSPLIT}
    return {"forward": scratch(FWD_CHUNK_ROWS, 1, 1), "gradient": grad, "loss_grad": grad}


def _unpack(flat: torch.Tensor, d: Dims) -> dict[str, torch.Tensor]:
    out, at = {}, 0
    for name, shape in _param_shapes(d).items():
        n = math.prod(shape)
        out[name] = flat[at:at + n].reshape(shape)
        at += n
    return out


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _bfs(x):
    """Round to bf16 in the forward; the gradient passes through in f32.
    The kernels' backward (_grad_body) carries f32 cotangents through every
    cast point, where autograd through bf() would round them to bf16: near
    a trained optimum, where a gradient is a small sum of large terms that
    cancel, that rounding alone moves some gradients by 20-100%."""
    return x + (bf(x) - x).detach()


def _bdot(x, w):
    return _bfs(x) @ _bfs(w)


def fused_forward_plain(d: Dims, rows: torch.Tensor, params: dict):
    """The plain version of K2: rows (n, F) bf16 -> (logits (n, A), value (n,))
    with _fwd_body's cast points. Differentiable in params: K3's plain
    version is autograd through it, with f32 cotangents (see _bfs)."""
    P, F0, hp = d.P, d.F0, d.hp
    x = rows.to(_F32)
    n = x.shape[0]
    room = x[:, :P * F0].reshape(n, P, F0)
    z0 = _bdot(room, params["w_phi0"]) + params["b_phi0"]
    e = gelu(_bdot(gelu(z0), params["w_phi1"]) + params["b_phi1"])
    eb = _bfs(e)
    if d.has_attn:
        mu = eb.mean(-1, keepdim=True)
        var = (eb - mu).square().mean(-1, keepdim=True)
        hn = (eb - mu) * torch.rsqrt(var + 1e-5)
        hb = _bfs(hn * params["ln_s"] + params["ln_b"])
        qkv = _bdot(hb, params["w_qkv"])
        q, k, w = qkv[..., :hp], qkv[..., hp:2 * hp], qkv[..., 2 * hp:]
        att = torch.softmax(q @ k.transpose(-1, -2) * (1.0 / math.sqrt(hp)), dim=-1)
        o = _bfs(att) @ w
        phi = _bfs(e + _bdot(o, params["w_ao"]))
    else:
        phi = eb
    viewer = x[:, P * F0:P * F0 + P]
    t = torch.cat([phi.sum(1) * (1.0 / P), (viewer[:, :, None] * phi).sum(1),
                   x[:, P * F0 + P:]], dim=-1)
    for i in range(d.layers):
        t = gelu(_bdot(t, params[f"w{i}"]) + params[f"b{i}"])
    opt = _bdot(t, params["w_pi"]) + params["b_pi"]
    g = _bfs(_bdot(t, params["w_ptr"]))
    scores = _bfs(phi * g[:, None, :]).sum(-1)  # (n, P)
    logits = F.pad(opt, (0, d.A - d.n_opt)) + F.pad(scores, (0, d.A - P))
    value = (_bdot(t, params["w_v"]) + params["b_v"])[:, 0]
    return logits, value


def loss_vg_plain(d: Dims, rows: torch.Tensor, rowin: torch.Tensor, params: dict,
                  clip_eps: float, ent_coef: float):
    """The plain version of K4: the PPO loss over fused_forward_plain from
    the pre-kernel rows (see _loss_rows), and its parameter gradient by
    autograd -> (grads, stats [pg_loss, vf * v_loss, entropy, ratio_mean])."""
    A = d.A
    with torch.enable_grad():
        leaves = {k: params[k].detach().to(_F32).requires_grad_(True)
                  for k in _param_names(d)}
        logits, value = fused_forward_plain(d, rows, leaves)
        legal, aoh = rowin[:, :A], rowin[:, A:2 * A]
        logp_old, advn, ret, wrow, vrow = rowin[:, 2 * A:].unbind(-1)
        logits = torch.where(legal > 0, logits, torch.full_like(logits, -1e9))
        logp_all = torch.log_softmax(logits, dim=-1)
        ratio = torch.exp((logp_all * aoh).sum(-1) - logp_old)
        pg = -torch.minimum(ratio * advn, ratio.clamp(1 - clip_eps, 1 + clip_eps) * advn)
        ent = -(logp_all.exp() * logp_all).sum(-1)
        stats = torch.stack([(pg * wrow).sum(), (0.5 * (value - ret) ** 2 * vrow).sum(),
                             (ent * wrow).sum(), (ratio * wrow).sum()])
        loss = stats[0] + stats[1] - ent_coef * stats[2]
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return dict(zip(leaves, grads)), stats.detach()


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check_rows(d: Dims, rows: torch.Tensor, device_type: str) -> None:
    if rows.device.type != device_type:
        raise ValueError(f"expected {device_type} rows, got {rows.device}")
    if rows.dtype != torch.bfloat16 or rows.dim() != 2 or rows.shape[1] != d.F \
            or not rows.is_contiguous():
        raise ValueError(f"rows must be contiguous bf16 (n, {d.F}); got "
                         f"{rows.dtype} {tuple(rows.shape)}")


def _check_f32(t: torch.Tensor, shape: tuple, device, name: str) -> None:
    if t.dtype != _F32 or tuple(t.shape) != shape or t.device != device \
            or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous f32 {shape} on {device}; got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _pipeline_forward(d: Dims, rows, params, chunk_rows: int):
    _require_pipeline(d, "K2 (policy forward)")
    dev = rows.device
    lib = _pipeline_lib(dev)
    pk = _packed(d, params, dev)
    n = rows.shape[0]
    chunk = _chunk(lib, pk.meta, n, chunk_rows, 1, 1)
    scratch = torch.empty((int(lib.lg_scratch_bytes(pk.meta.ctypes.data, chunk, 1, 1)),),
                          dtype=torch.uint8, device=dev)
    logits = torch.empty((n, d.A), dtype=_F32, device=dev)
    value = torch.empty((n,), dtype=_F32, device=dev)
    _lg_call("lg_forward",
             (pk.meta.ctypes.data, rows.data_ptr(), n, pk.prm.data_ptr(), pk.weights.data_ptr(),
              scratch.data_ptr(), chunk, logits.data_ptr(), value.data_ptr()),
             dev, "K2 (policy forward)")
    return logits, value


def _pipeline_grads(d: Dims, rows, rowin, params, ppo, chunk_rows: int, nsplit: int):
    """K3 (ppo None: rowin = dl | dv) or K4 (ppo = (clip_eps, ent_coef)) ->
    (grads, the four sums)."""
    _require_pipeline(d, "K3 (policy backward)" if ppo is None else "K4 (PPO loss-grad)")
    dev = rows.device
    lib = _pipeline_lib(dev)
    pk = _packed(d, params, dev)
    n = rows.shape[0]
    chunk = _chunk(lib, pk.meta, n, chunk_rows, nsplit, 0)
    scratch = torch.empty((int(lib.lg_scratch_bytes(pk.meta.ctypes.data, chunk, nsplit, 0)),),
                          dtype=torch.uint8, device=dev)
    out = torch.empty((pk.prm.numel() + N_STATS,), dtype=_F32, device=dev)
    head = (pk.meta.ctypes.data, rows.data_ptr(), n, rowin.data_ptr())
    tail = (pk.prm.data_ptr(), pk.weights.data_ptr(), scratch.data_ptr(), chunk, nsplit,
            out.data_ptr())
    if ppo is None:
        _lg_call("lg_grad", head + tail, dev, "K3 (policy backward)")
    else:
        _lg_call("lg_lossgrad", head + tuple(ppo) + tail, dev, "K4 (PPO loss-grad)")
    return _unpack(out[:-N_STATS], d), out[-N_STATS:]


def kernel_forward(d: Dims, rows: torch.Tensor, params: dict):
    """K2 on CUDA rows (n, F) bf16 -> (logits (n, A), value (n,)) f32."""
    with span("ge.entry.K2"):
        _check_rows(d, rows, "cuda")
        out = _pipeline_forward(d, rows, params, FWD_CHUNK_ROWS)
        kernel_forward.launches += 1
        return out


def kernel_grads(d: Dims, rows: torch.Tensor, dl: torch.Tensor, dv: torch.Tensor,
                 params: dict) -> dict:
    """K3: the parameter gradient of sum(dl * logits) + sum(dv * value) over
    CUDA rows, recomputing the forward."""
    _check_rows(d, rows, "cuda")
    n = rows.shape[0]
    rowin = torch.cat([dl.to(_F32).reshape(n, d.A), dv.to(_F32).reshape(n, 1)], 1).contiguous()
    _check_f32(rowin, (n, d.A + 1), rows.device, "dl | dv")
    grads, _ = _pipeline_grads(d, rows, rowin, params, None, CHUNK_ROWS, NSPLIT)
    kernel_grads.launches += 1
    return grads


def kernel_loss_grads(d: Dims, rows: torch.Tensor, rowin: torch.Tensor, params: dict,
                      clip_eps: float, ent_coef: float):
    """K4 on CUDA rows and the pre-kernel rowin (see _loss_rows) ->
    (grads, stats [pg_loss, vf * v_loss, entropy, ratio_mean])."""
    with span("ge.entry.K4"):
        _check_rows(d, rows, "cuda")
        _check_f32(rowin, (rows.shape[0], 2 * d.A + 5), rows.device, "rowin")
        out = _pipeline_grads(d, rows, rowin, params, (clip_eps, ent_coef), CHUNK_ROWS,
                              NSPLIT)
        kernel_loss_grads.launches += 1
        return out


for _fn in (kernel_forward, kernel_grads, kernel_loss_grads):
    _fn.launches = 0


def host_forward(d: Dims, rows: torch.Tensor, params: dict,
                 chunk_rows: int = FWD_CHUNK_ROWS):
    """K2's pipeline built with g++ (csrc/lossgrad_host.cpp: the stages,
    layout and chunks of chunk_rows), on CPU rows -> (logits, value)."""
    _check_rows(d, rows, "cpu")
    return _pipeline_forward(d, rows, params, chunk_rows)


def host_grads(d: Dims, rows: torch.Tensor, rowin: torch.Tensor, params: dict,
               chunk_rows: int = CHUNK_ROWS, nsplit: int = 3) -> dict:
    """K3's pipeline built with g++, on CPU rows and rowin = dl | dv ->
    grads, over chunks of chunk_rows and nsplit row splits."""
    _check_rows(d, rows, "cpu")
    rowin = rowin.to(_F32).contiguous()
    _check_f32(rowin, (rows.shape[0], d.A + 1), rows.device, "dl | dv")
    return _pipeline_grads(d, rows, rowin, params, None, chunk_rows, nsplit)[0]


def host_loss_grads(d: Dims, rows: torch.Tensor, rowin: torch.Tensor, params: dict,
                    clip_eps: float, ent_coef: float, chunk_rows: int = CHUNK_ROWS,
                    nsplit: int = 3):
    """K4's pipeline built with g++ (csrc/lossgrad_host.cpp: the CUDA
    version's stages, layout, chunks and slab order, plain-loop products),
    on CPU rows -> (grads, stats)."""
    _check_rows(d, rows, "cpu")
    _check_f32(rowin, (rows.shape[0], 2 * d.A + 5), rows.device, "rowin")
    return _pipeline_grads(d, rows, rowin, params, (clip_eps, ent_coef), chunk_rows, nsplit)


# ---------------------------------------------------------------------------
# public entries
# ---------------------------------------------------------------------------

class _FusedNet(torch.autograd.Function):
    """K2 forward, K3 backward; gradients flow to the params only."""

    @staticmethod
    def forward(ctx, d, rows, *plist):
        params = dict(zip(_param_names(d), plist))
        ctx.d = d
        ctx.save_for_backward(rows, *plist)
        return kernel_forward(d, rows, params)

    @staticmethod
    def backward(ctx, dl, dv):
        rows, *plist = ctx.saved_tensors
        names = _param_names(ctx.d)
        grads = kernel_grads(ctx.d, rows, dl.contiguous(), dv.contiguous(),
                             dict(zip(names, plist)))
        d_rows = torch.zeros_like(rows) if ctx.needs_input_grad[1] else None
        return (None, d_rows, *[grads[n].to(p.dtype) for n, p in zip(names, plist)])


def _as_rows(d: Dims, obs: torch.Tensor) -> torch.Tensor:
    if obs.shape[-1] != d.F:
        raise ValueError(f"obs width {obs.shape[-1]} != {d.F}")
    return obs.reshape(-1, d.F).to(torch.bfloat16).contiguous()


def make_apply(lowered: Lowered, cfg: N.NetConfig):
    """(params, obs (..., F)) -> (logits (..., A), value (...)), a drop-in for
    net.apply_net on the deepsets/attn archs: K2 forward / K3 backward on
    CUDA tensors, the plain version on CPU tensors. Raises for a net the
    kernels do not cover (see unsupported)."""
    why = unsupported(lowered, cfg)
    if why is not None:
        raise ValueError(why)
    d = dims_for(lowered, cfg)
    names = _param_names(d)

    def apply(params, obs):
        lead = obs.shape[:-1]
        rows = _as_rows(d, obs)
        if rows.is_cuda:
            logits, value = _FusedNet.apply(d, rows, *[params[n] for n in names])
        elif rows.device.type == "cpu":
            logits, value = fused_forward_plain(d, rows, params)
        else:
            raise ValueError(f"unsupported device {rows.device}")
        return logits.reshape(lead + (d.A,)), value.reshape(lead)

    return apply


def _loss_rows(d: Dims, legal, actions, logp_old, adv, ret, mask, vf_coef: float,
               mesh=None):
    """The pre-kernel steps (fused.py:646-676) -> rowin (n, 2A + 5) f32 =
    legal | one-hot action | logp_old, normalised advantage, ret,
    wrow = mask / msum, vrow = vf_coef / n.

    With a mesh these rows are one rank's share of a batch split over its
    data group: msum, the advantage's mean and variance and n are the whole
    batch's (sums over the group), so the kernel's sums over these rows are
    this rank's share of the whole batch's loss and gradient."""
    from game_engine_tpu_torch.parallel.mesh import data_sums

    n = mask.numel()
    A = d.A
    m = mask.to(_F32).reshape(n, 1)
    advf = adv.to(_F32).reshape(n, 1)
    msum, adv_sum = data_sums(mesh, m.sum(), (advf * m).sum())
    msum = msum.clamp_min(1.0)
    mean = adv_sum / msum
    (var_sum,) = data_sums(mesh, (m * (advf - mean) ** 2).sum())
    std = torch.sqrt(var_sum / msum) + 1e-8
    n_all = n if mesh is None else n * mesh.data_size
    a_idx = (actions.reshape(n).long() - 1).clamp(0, A - 1)
    aoh = F.one_hot(a_idx, A).to(_F32)
    return torch.cat([legal.reshape(n, A).to(_F32), aoh,
                      logp_old.to(_F32).reshape(n, 1), (advf - mean) / std,
                      ret.to(_F32).reshape(n, 1), m / msum,
                      torch.full((n, 1), vf_coef / n_all, dtype=_F32, device=m.device)],
                     dim=1).contiguous()


def make_loss_vg(lowered: Lowered, cfg: N.NetConfig, clip_eps: float, vf_coef: float,
                 ent_coef: float, mesh=None):
    """(params, obs, legal, actions, logp_old, adv, ret, mask) ->
    ((loss, metrics), grads): the fused train path's replacement for
    value_and_grad(ppo_loss), one K4 pass on CUDA tensors, the plain
    version on CPU tensors. Raises for a net K4 does not cover (see
    unsupported). With a mesh, the rows are this rank's rooms and every
    returned value is its share of the data group's whole batch (see
    _loss_rows): their sum over the group is the batch's."""
    why = unsupported(lowered, cfg)
    if why is not None:
        raise ValueError(f"K4: {why}")
    d = dims_for(lowered, cfg)

    def loss_vg(params, obs, legal, actions, logp_old, adv, ret, mask):
        rows = _as_rows(d, obs)
        rowin = _loss_rows(d, legal, actions, logp_old, adv, ret, mask, vf_coef, mesh)
        if rows.is_cuda:
            grads, stats = kernel_loss_grads(d, rows, rowin, params, clip_eps, ent_coef)
        elif rows.device.type == "cpu":
            grads, stats = loss_vg_plain(d, rows, rowin, params, clip_eps, ent_coef)
        else:
            raise ValueError(f"unsupported device {rows.device}")
        pg_loss, v_loss, entropy, ratio_mean = stats.unbind()
        loss = pg_loss + v_loss - ent_coef * entropy
        metrics = {"pg_loss": pg_loss, "v_loss": v_loss / vf_coef,
                   "entropy": entropy, "ratio_mean": ratio_mean}
        return (loss, metrics), grads

    return loss_vg
