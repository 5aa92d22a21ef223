"""The chat decode kernel's body (csrc/chat_decode.cuh decode_context),
built by g++ as csrc/chat_decode_host.cpp, against the plain decode
(policies/chat_decode.py decode_plain) on the CPU: greedy and sampled, on a
tiny net and on the shipped checkpoint. Tokens equal; the head's logits at
the generated positions within 2e-3 of max|ref| on the tiny net and 1e-2 at
the shipped width, where the plain decode's own float64-summed twin already
moves them by more than 2e-3 (the same floor as the forward's,
tests/test_torch_chat_lm.py). On the card chip_smoke.py holds the kernel
itself to decode_plain."""

import os

import numpy as np
import pytest
import torch

from game_engine_tpu_torch import _build
from game_engine_tpu_torch.policies import chat_decode as CD
from game_engine_tpu_torch.policies import chat_lm as T
from tests.test_torch_net import one_torch_thread  # noqa: F401

# small tensors in loops: one intra-op thread, as the other port tests
pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "docs", "checkpoints", "chat_lm.npz")


def _tiny(seed=0, **kw):
    cfg = T.LMConfig(**{"d_model": 32, "n_layers": 2, "n_heads": 4, "max_len": 96, **kw})
    p = T.init_params(torch.Generator().manual_seed(seed), cfg, device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    for k in p:  # non-trivial LayerNorm and biases; a peaked head
        if k.startswith(("ln", "b")):
            p[k] += 0.1 * torch.randn(p[k].shape, generator=g)
    p["tok"] *= 40.0
    return p, cfg


def _prompts(cfg, ctxs):
    bufs, n0 = zip(*(T._prompt_buf(cfg, c) for c in ctxs))
    return np.stack(bufs), list(n0)


CTXS = ["K=greeting|S=Vee|Q=hi", "K=status|P=Night|A=1,2,3|Q=who is alive?",
        "K=default|S=Al|Ns=1:Al,2:Bo|Q=tell me something interesting please", "x"]


def _compare(params, cfg, ctxs, tol, sample=None, max_new=320):
    bufs, n0 = _prompts(cfg, ctxs)
    kw = {}
    if sample is not None:
        temp, top_p, salt = sample
        kw = dict(u=np.stack([T._ctx_uniforms(c, cfg.max_len, salt) for c in ctxs]),
                  inv_temp=float(np.float32(1 / temp)), top_p=float(np.float32(top_p)))
    ref, lr = CD.decode_plain(params, cfg, bufs, n0, max_new, logits=True, **kw)
    got, lg = CD.host_decode(CD.pack(params, cfg), bufs, n0, max_new, logits=True, **kw)
    assert torch.equal(got, ref)
    assert torch.equal(torch.isnan(lg), torch.isnan(lr))  # the same generated positions
    m = ~torch.isnan(lr)
    assert m.any()
    err = float((lg[m] - lr[m]).abs().max())
    assert err <= tol * float(lr[m].abs().max()), err
    return ref, lr


@pytest.mark.parametrize("sample", [None, (0.8, 0.9, 0), (1.5, 0.95, 1), (0.5, 0.3, 2)],
                         ids=["greedy", "t0.8", "t1.5", "t0.5"])
def test_host_kernel_matches_plain_tiny(sample):
    params, cfg = _tiny()
    out, _ = _compare(params, cfg, CTXS, 2e-3, sample)
    gen = [int((out[i, k:] != T.PAD).sum()) for i, k in enumerate(_prompts(cfg, CTXS)[1])]
    assert max(gen) > 3  # the contexts generate, not only stop


def test_host_kernel_stops_like_plain():
    """max_new caps a reply; a prompt that fills the buffer generates
    nothing; the stop rule leaves the rest of the buffer as given."""
    params, cfg = _tiny(1)
    _compare(params, cfg, CTXS, 2e-3, max_new=2)
    full = "y" * 200
    bufs, n0 = _prompts(cfg, [full])
    assert n0 == [cfg.max_len]
    got, lg = CD.host_decode(CD.pack(params, cfg), bufs, n0, 320, logits=True)
    assert torch.equal(got, torch.as_tensor(bufs)) and torch.isnan(lg).all()


def test_host_kernel_matches_plain_other_shapes():
    params, cfg = _tiny(2, d_model=48, n_heads=2, n_layers=1, max_len=40)
    _compare(params, cfg, CTXS[:2], 2e-3)
    _compare(params, cfg, CTXS[:2], 2e-3, (0.9, 0.8, 0))


@pytest.fixture(scope="module")
def shipped():
    params, cfg = T.load(CKPT, device="cpu")
    ctxs = [c for c, _ in T.build_corpus(seeds=range(320, 321), max_pairs=12)][1::6]
    return params, cfg, ctxs


@pytest.mark.parametrize("sample", [None, (0.8, 0.9, 0)], ids=["greedy", "sampled"])
def test_host_kernel_matches_plain_shipped(shipped, sample, one_torch_thread):
    params, cfg, ctxs = shipped
    assert len(ctxs) == 2
    ref, lr = _compare(params, cfg, ctxs, 1e-2, sample)
    if sample is None:
        bufs, n0 = _prompts(cfg, ctxs)
        _, l64 = CD.decode_plain(params, cfg, bufs, n0, 320, logits=True, f64_sums=True)
        m = ~torch.isnan(lr)
        assert float((l64[m] - lr[m]).abs().max()) > 2e-3 * float(lr[m].abs().max())


def test_sizes_and_pack_agree_with_the_header():
    params, cfg = _tiny()
    pk = CD.pack(params, cfg)
    sz = CD.sizes(cfg, "cpu")
    assert (pk.wb.numel(), pk.wf.numel()) == (sz["wb"], sz["wf"])
    assert sz["kv_floats"] == 2 * cfg.n_layers * cfg.max_len * cfg.d_model
    big = CD.sizes(T.LMConfig(d_model=192, n_layers=4, max_len=832), "cpu")
    assert big["shared_bytes"] < 227 * 1024  # fits a block on the card
    bad = dict(params)
    bad["w10"] = bad["w10"][:, :-1]
    with pytest.raises(ValueError, match="do not match"):
        CD.pack(bad, cfg)


def test_packed_cache_follows_parameter_updates():
    params, cfg = _tiny()
    first = CD.packed(params, cfg)
    assert CD.packed(params, cfg) is first
    with torch.no_grad():
        params["w10"].add_(1.0)
    second = CD.packed(params, cfg)
    assert second is not first and not torch.equal(second.wb, first.wb)
    others = [dict(params) for _ in range(CD.PACK_SLOTS)]
    for o in others:
        CD.packed(o, cfg)
    assert len(CD._PACKED) == CD.PACK_SLOTS


def test_kernel_decode_refuses_cpu_tensors_and_bad_input():
    params, cfg = _tiny()
    pk = CD.pack(params, cfg)
    bufs, n0 = _prompts(cfg, CTXS[:1])
    with pytest.raises(ValueError, match="expected cuda"):
        CD.kernel_decode(pk, bufs, n0, 4)
    with pytest.raises(ValueError, match="prompt length"):
        CD.host_decode(pk, bufs, [0], 4)
    bad = bufs.copy()
    bad[0, 3] = T.VOCAB
    with pytest.raises(ValueError, match="token"):
        CD.host_decode(pk, bad, n0, 4)
    with pytest.raises(ValueError, match="max_new"):
        CD.host_decode(pk, bufs, n0, 0)
    assert _build.chat_decode_host_lib().cd_decode_host(
        pk.wb.data_ptr(), pk.wf.data_ptr(), pk.dims.ctypes.data, None, None, None, 1.0, 1.0,
        4, None, 1, 30) == 1  # threads not a multiple of 32
