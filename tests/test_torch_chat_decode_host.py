"""The chat decode kernels' twin (csrc/chat_decode_host.cpp: the stacked
tensor-core prefill of the prompt rows, then each context's cluster decode,
in the device programs' order), built by g++, against the plain decode
(policies/chat_decode.py decode_plain) on the CPU: greedy and sampled, on
tiny nets (heads split over the cluster's blocks, and more heads than
blocks) and on the shipped checkpoint. Tokens equal; the head's logits at
the generated positions within 2e-3 of max|ref| on the tiny net and 1e-2 at
the shipped width, where the plain decode's own float64-summed twin already
moves them by more than 2e-3 (the same floor as the forward's,
tests/test_torch_chat_lm.py). A batch mixing a one-token prompt, a
mid-length one and a full buffer decodes each context as it decodes alone.
On the card chip_smoke.py holds the kernels themselves to decode_plain."""

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


@pytest.mark.parametrize("shape", [dict(d_model=48, n_heads=2, n_layers=1, max_len=40),
                                   dict(d_model=64, n_heads=16, n_layers=2, max_len=48)],
                         ids=["2heads-4parts", "16heads-2a-block"])
def test_host_kernel_matches_plain_other_shapes(shape):
    params, cfg = _tiny(2, **shape)
    _compare(params, cfg, CTXS[:2], 2e-3)
    _compare(params, cfg, CTXS[:2], 2e-3, (0.9, 0.8, 0))


def _mixed(cfg):
    """A one-token prompt (no prefill row), a mid-length prompt and a prompt
    that fills the buffer (nothing to generate), with PAD after each."""
    bufs = np.full((3, cfg.max_len), T.PAD, np.int32)
    n0 = [1, cfg.max_len // 3, cfg.max_len]
    rng = np.random.default_rng(5)
    for i, k in enumerate(n0):
        bufs[i, :k] = rng.integers(T._NSPECIAL, T.VOCAB, k)
    bufs[:, 0] = T.BOS
    return bufs, n0


@pytest.mark.parametrize("sample", [None, (0.8, 0.9, 0)], ids=["greedy", "sampled"])
def test_host_kernel_mixed_batch_matches_plain_and_alone(sample):
    """n0 = 1, a mid-length prompt and n0 = max_len in one batch: against
    the plain decode, and each context decoded alone gives the same tokens
    and logits bit for bit (the stacked prefill keeps contexts apart)."""
    params, cfg = _tiny(3)
    bufs, n0 = _mixed(cfg)
    kw = {}
    if sample is not None:
        rng = np.random.default_rng(11)
        kw = dict(u=rng.random((3, cfg.max_len), dtype=np.float32), inv_temp=1.25, top_p=0.9)
    pk = CD.pack(params, cfg)
    ref, lr = CD.decode_plain(params, cfg, bufs, n0, 320, logits=True, **kw)
    got, lg = CD.host_decode(pk, bufs, n0, 320, logits=True, **kw)
    assert torch.equal(got, ref)
    m = ~torch.isnan(lr)
    assert torch.equal(torch.isnan(lg), ~m)
    assert float((lg[m] - lr[m]).abs().max()) <= 2e-3 * float(lr[m].abs().max())
    assert torch.equal(got[2], torch.as_tensor(bufs[2])) and torch.isnan(lg[2]).all()
    assert int((got[0, 1:] != T.PAD).sum()) > 0 and int((got[1, n0[1]:] != T.PAD).sum()) > 0
    for i in range(3):
        one = {k: v[i:i + 1] if k == "u" else v for k, v in kw.items()}
        a, la = CD.host_decode(pk, bufs[i:i + 1], n0[i:i + 1], 320, logits=True, **one)
        assert torch.equal(a[0], got[i])
        assert torch.equal(torch.isnan(la[0]), torch.isnan(lg[i]))
        assert torch.equal(la[0][~torch.isnan(la[0])], lg[i][~torch.isnan(lg[i])])


def test_prompt_rows_and_launch_count():
    """The prefill's rows: positions 0 .. n0-2 of each context that
    generates, in order; the launches of a call: 2 * layers - 1 prefill
    launches when there is a row, and the decode's one."""
    rows = CD.prompt_rows([3, 1, 5, 8, 2], 8)
    assert rows.tolist() == [[0, 0], [0, 1], [2, 0], [2, 1], [2, 2], [2, 3], [4, 0]]
    assert CD.prompt_rows([1, 8], 8).shape == (0, 2)
    assert CD.launches_per_call([3, 1], 8, 4) == 8
    assert CD.launches_per_call([1, 1, 8], 8, 4) == 1


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
    for k in ("prefill_rows_shared_bytes", "prefill_attn_shared_bytes", "decode_shared_bytes"):
        assert big[k] <= CD.SMEM_LIMIT, k  # fits a block on the card
    assert big["cluster"] == 8 and big["resident_layers"] >= 1
    # the head's and the resident layers' slices of an eighth of every product
    assert big["decode_shared_bytes"] > 2 * (16 * 192 + (72 + 24 + 96) * 192 + 24 * 768)
    with pytest.raises(ValueError, match="multiple of 16"):
        CD.sizes(T.LMConfig(d_model=40, n_heads=4), "cpu")
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
        4, None, 1, None, -1, None) == 1  # a negative count of prompt rows
