"""Host side of the chat LM's decode kernels (csrc/chat_decode.cu).

The JAX package decodes a reply in one jitted ``lax.scan`` over the
positions (game_engine_tpu/policies/chat_lm.py ``_make_decoder``): one
device dispatch a reply. Its counterpart here is two device programs
written for Hopper (csrc/chat_decode.cuh says what each computes and in
which order):

- the prefill: the prompts' teacher-forced positions of every context of
  the batch, stacked as rows, a layer at a time through the tensor cores
  (2 * layers - 1 launches, none when no prompt has a row to force);
- the decode: the generated positions of a context on a cluster of 8
  thread blocks, each owning an eighth of every product (one launch).

- ``kernel_decode`` launches them over a batch of contexts on the card (CUDA
  tensors only; counts ``kernel_decode.launches``, split into
  ``prefill_launches`` and ``decode_launches``; a failed build or launch
  raises, and so does a card that cannot place the cluster);
- ``host_decode`` runs their twin, built by g++
  (csrc/chat_decode_host.cpp), on CPU tensors;
- ``decode_plain`` is the plain version: the same KV-cache loop in eager
  torch, on whatever device the parameters live.

All three take a batch of prompt buffers (n, max_len) with each context's
prompt length n0, write the generated tokens from n0 on, and stop a context
at its first generated token below ``_NSPECIAL`` or after ``max_new``
tokens. A greedy decode takes the first maximum of the head's logits; a
sampled one (``u`` given: (n, max_len) uniforms, one a position) draws from
the nucleus of the temperature-scaled softmax exactly as the JAX decoder
does. With ``logits=True`` they also return the head's row at every
position whose next token was generated (NaN elsewhere).

``packed`` keeps the kernels' weight blobs for the last ``PACK_SLOTS``
parameter states (the dict's identity and each tensor's address and
version), as the JAX module's decoder cache keeps its last four
executables; ``plain_weights`` does the same for the plain version's
rounded copies.
"""

from __future__ import annotations

import functools
import math
from collections import OrderedDict
from typing import NamedTuple

import numpy as np
import torch

from game_engine_tpu_torch import _build
from game_engine_tpu_torch.policies.chat_lm import (
    _NSPECIAL,
    VOCAB,
    LMConfig,
    _bf,
    _gelu,
    _ln,
    _rope,
    rope_tables,
)

PACK_SLOTS = 4  # parameter states kept packed (the JAX decoder cache's size)
SMEM_LIMIT = 232448  # shared bytes an H100 block can opt in to: sizes()' resident layers


class Packed(NamedTuple):
    """The kernels' weights for one parameter state, on its device."""
    wb: torch.Tensor    # bf16 blob as int16 (chat_decode.cuh's order, products transposed)
    wf: torch.Tensor    # float32 blob
    dims: np.ndarray    # int32 {D, H, L, V, layers, heads} on the host
    cfg: LMConfig


def dims_of(cfg: LMConfig) -> np.ndarray:
    return np.array([cfg.d_model, 4 * cfg.d_model, cfg.max_len, VOCAB, cfg.n_layers,
                     cfg.n_heads], np.int32)


def _lib(device: torch.device, profile: bool = False):
    if device.type != "cuda":
        return _build.chat_decode_host_lib()
    return _build.chat_decode_profile_lib() if profile else _build.chat_decode_lib()


_SIZE_KEYS = ("wb", "wf", "kv_floats", "prefill_rows_shared_bytes",
              "prefill_attn_shared_bytes", "decode_shared_bytes", "resident_layers",
              "cluster", "scratch_bytes_per_row")


def sizes(cfg: LMConfig, device) -> dict:
    """The blobs', a context's caches', each program's shared memory a block
    and a prefill row's scratch sizes, as the library computes them for an
    H100's blocks (SMEM_LIMIT); raises for a net the kernels do not take
    (d_model a multiple of 16, a head width a multiple of 4)."""
    out = np.zeros(len(_SIZE_KEYS), np.int64)
    if _lib(torch.device(device)).cd_sizes(dims_of(cfg).ctypes.data, SMEM_LIMIT,
                                           out.ctypes.data):
        raise ValueError(f"the decode kernels do not take {cfg}: d_model must be a multiple "
                         "of 16 and the head width a multiple of 4")
    return dict(zip(_SIZE_KEYS, (int(v) for v in out)))


def cluster_plan(cfg: LMConfig) -> dict:
    """On the card: the decode's clusters it holds at once
    (cudaOccupancyMaxActiveClusters), its resident layers and shared bytes
    a block."""
    out = np.zeros(3, np.int32)
    lib = _build.chat_decode_lib()
    err = lib.cd_cluster_plan(dims_of(cfg).ctypes.data, out.ctypes.data)
    if err != 0:
        raise RuntimeError("chat decode cluster plan failed: " + lib.cd_error_string(err).decode())
    return {"clusters_at_once": int(out[0]), "resident_layers": int(out[1]),
            "decode_shared_bytes": int(out[2])}


def pack(params: dict, cfg: LMConfig) -> Packed:
    """The kernels' two weight blobs from the parameters, on their device;
    checked against the library's sizes (building it now)."""
    dev = params["tok"].device
    bf = [params["tok"]]
    f32 = [params["pos"], *rope_tables(cfg, dev), params["lnf_s"], params["lnf_b"]]
    for i in range(cfg.n_layers):
        bf += [params[f"{w}{i}"].T for w in ("wqkv", "wo", "w1", "w2")]
        f32 += [params[f"ln{j}_{s}{i}"] for j in (1, 2) for s in "sb"]
        f32 += [params[f"b1{i}"], params[f"b2{i}"]]
    with torch.no_grad():
        wb = torch.cat([w.detach().to(torch.bfloat16).reshape(-1) for w in bf]).view(torch.int16)
        wf = torch.cat([w.detach().to(torch.float32).reshape(-1) for w in f32])
    want = sizes(cfg, dev)
    if (wb.numel(), wf.numel()) != (want["wb"], want["wf"]):
        raise ValueError(f"packed {wb.numel()} bf16 and {wf.numel()} f32 weights; the kernel "
                         f"takes {want['wb']} and {want['wf']}: the parameters do not match {cfg}")
    return Packed(wb.contiguous(), wf.contiguous(), dims_of(cfg), cfg)


def _state_key(params: dict, cfg: LMConfig) -> tuple:
    return (id(params), cfg, tuple((k, v.data_ptr(), v._version) for k, v in params.items()))


def _cached(cache: OrderedDict, params: dict, cfg: LMConfig, make):
    key = _state_key(params, cfg)
    hit = cache.get(key)
    if hit is None:
        while len(cache) >= PACK_SLOTS:
            cache.popitem(last=False)
        hit = cache[key] = (make(params, cfg), params)  # pins the dict's id
    cache.move_to_end(key)
    return hit[0]


_PACKED: OrderedDict = OrderedDict()
_PLAIN: OrderedDict = OrderedDict()


def packed(params: dict, cfg: LMConfig) -> Packed:
    """pack(params, cfg), kept for the last PACK_SLOTS parameter states."""
    return _cached(_PACKED, params, cfg, pack)


def _round_weights(params: dict, cfg: LMConfig) -> dict:
    w = {k: v.detach() for k, v in params.items()}
    for k in list(w):
        if k == "tok" or k.startswith(("wqkv", "wo", "w1", "w2")):
            w[k] = _bf(w[k])
    w["tokT"] = w["tok"].T.contiguous()
    w["cos"], w["sin"] = rope_tables(cfg, params["tok"].device)
    return w


def plain_weights(params: dict, cfg: LMConfig) -> dict:
    """The plain decode's weights: the product operands rounded to bf16 once,
    the rope tables; kept for the last PACK_SLOTS parameter states."""
    return _cached(_PLAIN, params, cfg, _round_weights)


def _io(bufs, n0, cfg: LMConfig, device) -> torch.Tensor:
    """(n, L + 1) int32 on `device`: n0, then the tokens. Buffers held in
    numpy are checked on the host and sent in one copy."""
    n0 = np.asarray(n0, np.int64).reshape(-1)
    shape = tuple(bufs.shape)
    if len(shape) != 2 or shape[1] != cfg.max_len:
        raise ValueError(f"bufs have shape {shape}, expected (n, {cfg.max_len})")
    if len(n0) != shape[0] or shape[0] == 0:
        raise ValueError(f"{len(n0)} prompt lengths for {shape[0]} buffers")
    if ((n0 < 1) | (n0 > cfg.max_len)).any():
        raise ValueError(f"a prompt length is outside [1, {cfg.max_len}]")
    if torch.is_tensor(bufs):
        if bufs.device != torch.device(device):
            raise ValueError(f"bufs on {bufs.device}, expected {device}")
        if bool(((bufs < 0) | (bufs >= VOCAB)).any()):
            raise ValueError(f"a token is outside [0, {VOCAB})")
        n0t = torch.as_tensor(n0, dtype=torch.int32, device=device)
        return torch.cat([n0t[:, None], bufs.to(torch.int32)], 1).contiguous()
    bufs = np.asarray(bufs)
    if ((bufs < 0) | (bufs >= VOCAB)).any():
        raise ValueError(f"a token is outside [0, {VOCAB})")
    host = np.concatenate([n0[:, None], bufs], 1).astype(np.int32)
    return torch.as_tensor(host, device=device)


@functools.lru_cache(maxsize=None)
def _sizes(cfg: LMConfig, device_type: str) -> dict:
    return sizes(cfg, device_type)


def prompt_rows(n0, max_len: int) -> np.ndarray:
    """The prefill's rows, (R, 2) int32: (context, position) for positions
    0 .. n0-2 of each context that generates (n0 < max_len), in order."""
    n0 = np.asarray(n0, np.int64).reshape(-1)
    runs = [(c, k - 1) for c, k in enumerate(n0) if 1 < k < max_len]
    if not runs:
        return np.zeros((0, 2), np.int32)
    ctx = np.concatenate([np.full(m, c) for c, m in runs])
    pos = np.concatenate([np.arange(m) for _, m in runs])
    return np.stack([ctx, pos], 1).astype(np.int32)


def _check(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"chat {what} kernel launch failed: "
                           + lib.cd_error_string(err).decode())


def _run(pk: Packed, bufs, n0, max_new: int, u, inv_temp: float, top_p: float,
         logits: bool, device_type: str, events=None, profile: bool = False):
    dev = pk.wb.device
    if dev.type != device_type:
        raise ValueError(f"expected {device_type} weights, got {dev}")
    if max_new < 1:
        raise ValueError(f"max_new={max_new}")
    cfg = pk.cfg
    io = _io(bufs, n0, cfg, dev)
    n = io.shape[0]
    if u is not None:
        u = torch.as_tensor(u, dtype=torch.float32, device=dev).contiguous()
        if tuple(u.shape) != (n, cfg.max_len):
            raise ValueError(f"u has shape {tuple(u.shape)}, expected ({n}, {cfg.max_len})")
    sz = _sizes(cfg, dev.type)
    kv = torch.empty(n * sz["kv_floats"], dtype=torch.float32, device=dev)
    lg = (torch.full((n, cfg.max_len, VOCAB), float("nan"), device=dev) if logits else None)
    rows = prompt_rows(n0, cfg.max_len)
    scratch = torch.empty(len(rows) * sz["scratch_bytes_per_row"], dtype=torch.uint8, device=dev)
    rows_t = torch.as_tensor(rows, device=dev) if len(rows) else None
    args = [pk.wb.data_ptr(), pk.wf.data_ptr(), pk.dims.ctypes.data, io.data_ptr(), kv.data_ptr(),
            None if u is None else u.data_ptr(), inv_temp, top_p, int(max_new),
            None if lg is None else lg.data_ptr(), n]
    prefill = [None if rows_t is None else rows_t.data_ptr(), len(rows), scratch.data_ptr()]
    lib = _lib(dev, profile)
    if device_type == "cpu":
        if lib.cd_decode_host(*args, *prefill) != 0:
            raise RuntimeError("host chat decode refused its arguments")
        return io[:, 1:], lg
    got = np.zeros(1, np.int32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        if events is not None:
            events[0].record(stream)
        if len(rows):
            err = lib.cd_prefill(*args[:5], *prefill, got.ctypes.data, stream.cuda_stream)
            kernel_decode.prefill_launches += int(got[0])
            kernel_decode.launches += int(got[0])
            _check(lib, err, "prefill")
        if events is not None:
            events[1].record(stream)
        err = lib.cd_decode(*args, got.ctypes.data, stream.cuda_stream)
        kernel_decode.decode_launches += int(got[0])
        kernel_decode.launches += int(got[0])
        _check(lib, err, "decode")
        if events is not None:
            events[2].record(stream)
    return io[:, 1:], lg


def launches_per_call(n0, max_len: int, n_layers: int) -> int:
    """kernel_decode's launches for prompts of lengths n0: 2 * layers - 1
    for the prefill when a context has a prompt row, and the decode's one."""
    return (2 * n_layers - 1 if len(prompt_rows(n0, max_len)) else 0) + 1


def kernel_decode(pk: Packed, bufs, n0, max_new: int, u=None,
                  inv_temp: float = 1.0, top_p: float = 1.0, logits: bool = False,
                  events=None):
    """Decode every context on the card: the prefill of every prompt row,
    then the cluster decode of every context (launches_per_call launches)
    -> (tokens (n, max_len) int32, logits or None). The weights are on the
    card; the buffers and uniforms are CUDA tensors or numpy arrays (sent in
    one copy each). `events`, three timing torch.cuda.Events, are recorded
    before the prefill, between the two and after the decode. Raises on bad
    input or a refused launch."""
    return _run(pk, bufs, n0, max_new, u, inv_temp, top_p, logits, "cuda", events)


kernel_decode.launches = 0
kernel_decode.prefill_launches = 0
kernel_decode.decode_launches = 0


PROFILE_STAGES = ("embed", "ln1", "qkv", "wait_qkv", "attention", "wait_attention", "merge",
                  "wo", "wait_wo", "ln2", "w1", "wait_w1", "w2", "wait_w2", "head", "wait_head",
                  "token", "wait_token")


def profile_decode(pk: Packed, bufs, n0, max_new: int) -> dict:
    """A greedy decode through the -DCD_PROFILE build -> the clock cycles of
    each stage of a generated position (PROFILE_STAGES), summed over the
    positions of every context's rank 0. Not counted in kernel_decode's
    launches: a measuring tool."""
    lib = _build.chat_decode_profile_lib()
    counts = (kernel_decode.launches, kernel_decode.prefill_launches,
              kernel_decode.decode_launches)
    out = np.zeros(len(PROFILE_STAGES), np.uint64)
    dev = pk.wb.device
    with torch.cuda.device(dev):  # the stage counters live on the weights' card
        _check(lib, lib.cd_profile_read(out.ctypes.data, 1), "profile")
    try:
        _run(pk, bufs, n0, max_new, None, 1.0, 1.0, False, "cuda", profile=True)
        torch.cuda.synchronize(dev)
        with torch.cuda.device(dev):
            _check(lib, lib.cd_profile_read(out.ctypes.data, 1), "profile")
    finally:
        (kernel_decode.launches, kernel_decode.prefill_launches,
         kernel_decode.decode_launches) = counts
    return dict(zip(PROFILE_STAGES, (int(v) for v in out)))


def host_decode(pk: Packed, bufs, n0, max_new: int, u=None,
                inv_temp: float = 1.0, top_p: float = 1.0, logits: bool = False):
    """The kernels' twin built with g++, on CPU tensors -> as kernel_decode."""
    return _run(pk, bufs, n0, max_new, u, inv_temp, top_p, logits, "cpu")


@torch.no_grad()
def decode_plain(params: dict, cfg: LMConfig, bufs, n0, max_new: int, u=None,
                 inv_temp: float = 1.0, top_p: float = 1.0, logits: bool = False,
                 f64_sums: bool = False):
    """The plain version in eager torch, on the parameters' device -> as
    kernel_decode. The contexts advance together one position a step, each
    teacher-forced inside its prompt; float32 K/V caches. f64_sums sums the
    weight products in float64 (the same bf16 operands): a measuring tool,
    the spread that summation order alone gives."""
    w = plain_weights(params, cfg)
    if u is not None:
        u = torch.as_tensor(u, dtype=torch.float32, device=params["tok"].device)

    def mm(a, b):
        return (a.double() @ b.double()).float() if f64_sums else a @ b

    dev = params["tok"].device
    io = _io(bufs, n0, cfg, dev)
    n0t = io[:, 0].long()
    buf = io[:, 1:].long()
    B, L = buf.shape
    Dm, nh = cfg.d_model, cfg.n_heads
    hd = Dm // nh
    kc = [torch.zeros(B, L, nh, hd, device=dev) for _ in range(cfg.n_layers)]
    vc = [torch.zeros(B, L, nh, hd, device=dev) for _ in range(cfg.n_layers)]
    active = torch.ones(B, dtype=torch.bool, device=dev)
    count = torch.zeros(B, dtype=torch.long, device=dev)
    lg_out = torch.full((B, L, VOCAB), float("nan"), device=dev) if logits else None
    first = int(np.min(n0)) - 1
    for pos in range(L - 1):
        x = w["tok"][buf[:, pos]] + w["pos"][pos]
        cos, sin = w["cos"][pos], w["sin"][pos]
        for i in range(cfg.n_layers):
            h = _ln(x, w[f"ln1_s{i}"], w[f"ln1_b{i}"])
            qkv = mm(_bf(h), w[f"wqkv{i}"]).reshape(B, 3, nh, hd)
            q, k = _rope(qkv[:, 0], cos, sin), _rope(qkv[:, 1], cos, sin)
            kc[i][:, pos] = k
            vc[i][:, pos] = qkv[:, 2]
            att = torch.einsum("bhd,bkhd->bhk", q, kc[i][:, : pos + 1]) / math.sqrt(hd)
            att = torch.softmax(att, dim=-1)
            o = torch.einsum("bhk,bkhd->bhd", att, vc[i][:, : pos + 1]).reshape(B, Dm)
            x = x + mm(_bf(o), w[f"wo{i}"])
            h = _ln(x, w[f"ln2_s{i}"], w[f"ln2_b{i}"])
            h = _gelu(mm(_bf(h), w[f"w1{i}"]) + w[f"b1{i}"])
            x = x + mm(_bf(h), w[f"w2{i}"]) + w[f"b2{i}"]
        if pos < first:
            continue
        xf = _ln(x, w["lnf_s"], w["lnf_b"])
        lg = mm(_bf(xf), w["tokT"])
        if u is None:
            nxt = torch.argmax(lg, dim=-1)  # the first maximum
        else:
            nxt = _nucleus(lg * inv_temp, u[:, pos], top_p)
        gen = active & (pos + 1 >= n0t)
        buf[:, pos + 1] = torch.where(gen, nxt, buf[:, pos + 1])
        if lg_out is not None:
            lg_out[:, pos] = torch.where(gen[:, None], lg, lg_out[:, pos])
        count += gen.long()
        active &= ~(gen & ((nxt < _NSPECIAL) | (count >= max_new)))
        if not bool(active.any()):
            break
    return buf.to(torch.int32), lg_out


def _nucleus(lg: torch.Tensor, uv: torch.Tensor, top_p: float) -> torch.Tensor:
    """The JAX decoder's draw: the stable descending order, softmax, the
    tokens whose preceding mass is below top_p, inverse CDF at uv."""
    order = torch.argsort(-lg, dim=-1, stable=True)
    ps = torch.softmax(lg, dim=-1).gather(-1, order)
    cps = torch.cumsum(ps, -1)
    kept = torch.where((cps - ps) < top_p, ps, torch.zeros_like(ps))
    ck = torch.cumsum(kept, -1)
    idx = (ck < uv[:, None] * ck[:, -1:]).sum(-1)
    return order.gather(-1, idx.clamp(max=VOCAB - 1)[:, None])[:, 0]
