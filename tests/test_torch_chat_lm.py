"""The port's chat LM (game_engine_tpu_torch/policies/chat_lm.py, the plain
decode of policies/chat_decode.py, train/chat_lm.py's update) against the
JAX package's: the tokenizer, the corpus pair for pair, the forward and the
loss and their gradients, one Adam step, the cosine schedule, checkpoints
across packages, the serving hook, and greedy and sampled replies of the
shipped checkpoint byte for byte.

Tolerances: the forward's logits within 2e-3 of max|ref| on a tiny net and
1e-2 at the shipped width (both sides round the same operands to bf16 and
sum in float32, in other orders; see the shipped test for the floor); the
loss within 1e-4 relative; gradients within 1e-3 of max|ref|."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from game_engine_tpu.policies import chat_lm as J
from game_engine_tpu_torch.policies import chat_decode as CD
from game_engine_tpu_torch.policies import chat_lm as T
from game_engine_tpu_torch.train import chat_lm as TR
from tests.test_torch_net import one_torch_thread  # noqa: F401

# small tensors in loops: one intra-op thread, as the other port tests
pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "docs", "checkpoints", "chat_lm.npz")
TINY = dict(d_model=32, n_layers=2, n_heads=4, max_len=64)


def _cfgs(**kw):
    return J.LMConfig(**kw), T.LMConfig(**kw)


def _tiny_params(seed=0):
    jcfg, tcfg = _cfgs(**TINY)
    pj = J.init_params(jax.random.PRNGKey(seed), jcfg)
    # non-trivial LayerNorm and bias parameters
    rng = np.random.default_rng(seed)
    pj = {k: (v + 0.1 * rng.standard_normal(v.shape).astype(np.float32)
              if k.startswith(("ln", "b")) else v) for k, v in pj.items()}
    pj = {k: jnp.asarray(v, jnp.float32) for k, v in pj.items()}
    return pj, T.params_from_numpy({k: np.asarray(v) for k, v in pj.items()}, "cpu"), jcfg, tcfg


@pytest.fixture(scope="module")
def shipped():
    pj, jcfg = J.load(CKPT)
    pt, tcfg = T.load(CKPT, device="cpu")
    return pj, jcfg, pt, tcfg


@pytest.fixture(scope="module")
def corpus():
    return J.build_corpus(seeds=range(300, 302), max_pairs=40)


def _close(got, ref, rel):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err = float(np.abs(got - ref).max())
    assert err <= rel * float(np.abs(ref).max()), (err, float(np.abs(ref).max()))


# -- tokenizer, corpus, uniforms ------------------------------------------------


@pytest.mark.parametrize("text", ["hello there", "Role Assignment — first.", "“hi” ’ok’ –",
                                  "café ñ 日本 \t\n", "x" * 700, ""])
def test_tokenizer_and_pairs_equal(text):
    jcfg, tcfg = _cfgs(**TINY)
    assert T.encode_text(text) == J.encode_text(text)
    toks = T.encode_text(text)
    assert T.decode_tokens(toks + [0, 3, 200]) == J.decode_tokens(toks + [0, 3, 200])
    for ctx, reply in ((text, "a reply."), ("K=greeting|Q=hi", text)):
        assert T.pair_fits(ctx, reply, tcfg) == J.pair_fits(ctx, reply, jcfg)
        for a, b in zip(T.encode_pair(ctx, reply, tcfg), J.encode_pair(ctx, reply, jcfg)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(T._prompt_buf(tcfg, ctx), J._prompt_buf(jcfg, ctx)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("salt", [0, 1, 2, 0xFFFFFFFF])
def test_ctx_uniforms_bit_equal(salt):
    for ctx in ("", "K=greeting|P=x|Q=hello there", "é" * 40):
        a, b = T._ctx_uniforms(ctx, 97, salt), J._ctx_uniforms(ctx, 97, salt)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


@pytest.mark.parametrize("queries", [None, "v1"])
def test_build_corpus_pair_for_pair(queries):
    q = None if queries is None else J._QUERIES_V1
    assert T._QUERIES == J._QUERIES and T._SENDERS == J._SENDERS
    got = T.build_corpus(seeds=range(2), max_pairs=40, queries=q)
    ref = J.build_corpus(seeds=range(2), max_pairs=40, queries=q)
    assert len(ref) == 40 and got == ref


def test_build_corpus_each_game_alone():
    for game in ("werewolf", "two-truths-and-a-lie"):
        assert (T.build_corpus(games=(game,), seeds=range(2), max_pairs=40)
                == J.build_corpus(games=(game,), seeds=range(2), max_pairs=40))


# -- forward, loss, gradients, the update ------------------------------------------


def test_forward_tiny_matches_jax():
    pj, pt, jcfg, tcfg = _tiny_params()
    rng = np.random.default_rng(1)
    toks = rng.integers(4, J.VOCAB, size=(3, 64)).astype(np.int32)
    toks[:, 0] = J.BOS
    toks[1, 40:] = J.PAD  # PAD keys masked
    ref = np.asarray(J.forward(pj, jnp.asarray(toks), jcfg))
    got = T.forward(pt, torch.as_tensor(toks), tcfg).numpy()
    _close(got, ref, 2e-3)


def test_forward_shipped_checkpoint_matches_jax(shipped, corpus, monkeypatch):
    """At the shipped width a different float32 summation order alone moves
    the logits by more than 2e-3 of max|ref|: the same port forward with
    its products summed in float64 differs from the float32 one by ~3.7e-3
    (one bf16 rounding of an activation flips, and 4 layers carry it). So
    the port is held to 1e-2 here, and the floor is checked to be real."""
    pj, jcfg, pt, tcfg = shipped
    toks = np.stack([J.encode_pair(c, r, jcfg)[0][:64] for c, r in corpus[:2]])
    ref = np.asarray(J.forward(pj, jnp.asarray(toks), jcfg))
    got = T.forward(pt, torch.as_tensor(toks), tcfg).numpy()
    _close(got, ref, 1e-2)
    monkeypatch.setattr(T, "_dot", lambda a, b: (T._bf(a).double() @ T._bf(b).double()).float())
    floor = np.abs(T.forward(pt, torch.as_tensor(toks), tcfg).numpy() - got).max()
    assert floor > 2e-3 * np.abs(ref).max()


def _batch(tcfg, seed=2):
    pairs = J.build_corpus(seeds=range(1), max_pairs=6)
    rng = np.random.default_rng(seed)
    toks, masks = [], []
    for c, r in pairs[:4]:
        # a short context keeps the reply inside the tiny max_len
        t, m = J.encode_pair(c[-int(rng.integers(8, 24)):], r[:30], J.LMConfig(**TINY))
        toks.append(t)
        masks.append(m)
    return np.stack(toks), np.stack(masks)


def _port_grads(pt, toks, masks, tcfg, dot=None):
    p = {k: v.detach().clone().requires_grad_(True) for k, v in pt.items()}
    orig = T._dot
    T._dot = dot or orig
    try:
        loss = T.loss_fn(p, torch.as_tensor(toks), torch.as_tensor(masks), tcfg)
        loss.backward()
    finally:
        T._dot = orig
    return float(loss.detach()), {k: v.grad.numpy() for k, v in p.items()}


def test_loss_and_gradients_match_jax():
    """The loss within 1e-4 relative. Every product's cotangent is rounded
    to bf16 on both sides (autograd through the bf16 cast, as jax.grad), so
    a float32 sum taken in another order can move a gradient element by a
    bf16 step: the port's own gradients with float64 sums differ from its
    float32 ones by more than 1e-3 of max|ref| (checked here). Each
    parameter's gradient is held within 1e-2 of its max|ref|."""
    pj, pt, jcfg, tcfg = _tiny_params(3)
    toks, masks = _batch(tcfg)
    lj, gj = jax.value_and_grad(J.loss_fn)(pj, jnp.asarray(toks), jnp.asarray(masks), jcfg)
    lt, gt = _port_grads(pt, toks, masks, tcfg)
    assert abs(lt - float(lj)) <= 1e-4 * abs(float(lj))
    for k in gj:
        _close(gt[k], gj[k], 1e-2)
    _, g64 = _port_grads(pt, toks, masks, tcfg,
                         lambda a, b: (T._bf(a).double() @ T._bf(b).double()).float())
    assert max(np.abs(gt[k] - g64[k]).max() / np.abs(np.asarray(gj[k])).max() for k in gj) > 1e-3


def test_one_adam_step_matches_optax():
    """torch.optim.Adam as make_optimizer sets it is optax.adam: on the same
    gradients the parameters agree to float32 rounding; through train_step,
    at the trainer's default lr 3e-4, within 1e-5."""
    pj, pt, jcfg, tcfg = _tiny_params(4)
    toks, masks = _batch(tcfg, 5)
    tx = optax.adam(3e-4)
    grads = jax.grad(J.loss_fn)(pj, jnp.asarray(toks), jnp.asarray(masks), jcfg)
    upd, _ = tx.update(grads, tx.init(pj), pj)
    ref = optax.apply_updates(pj, upd)
    same = {k: v.clone().requires_grad_(True) for k, v in pt.items()}
    opt = TR.make_optimizer(same, 3e-4)
    for k, v in same.items():
        v.grad = torch.as_tensor(np.array(grads[k]))
    opt.step()
    for k in ref:
        np.testing.assert_allclose(same[k].detach().numpy(), np.asarray(ref[k]), rtol=0,
                                   atol=2.5e-7, err_msg=k)  # two ulps at 1.0
    # train_step: the port's loss, backward and Adam in one update, held to
    # optax fed the same (the port's) gradients; an element whose gradient
    # is near Adam's eps moves by up to lr on a bf16 step of its gradient,
    # so the JAX gradients would not do here (see the gradient test)
    _, gt = _port_grads(pt, toks, masks, tcfg)
    upd, _ = tx.update({k: jnp.asarray(v) for k, v in gt.items()}, tx.init(pj), pj)
    ref = optax.apply_updates(pj, upd)
    for v in pt.values():
        v.requires_grad_(True)
    TR.train_step(pt, TR.make_optimizer(pt, 3e-4), torch.as_tensor(toks),
                  torch.as_tensor(masks), tcfg, 3e-4)
    for k in ref:
        np.testing.assert_allclose(pt[k].detach().numpy(), np.asarray(ref[k]), rtol=0,
                                   atol=1e-5, err_msg=k)


def test_cosine_schedule_matches_optax():
    steps = 3000
    sched = optax.cosine_decay_schedule(3e-4, steps, alpha=0.1)
    for t in (0, 1, steps // 2, steps - 1, steps, steps + 7):
        assert TR.cosine_lr(3e-4, steps, t) == pytest.approx(float(sched(t)), rel=1e-6)


# -- checkpoints ---------------------------------------------------------------


def test_checkpoints_load_across_packages(tmp_path):
    pj, pt, jcfg, tcfg = _tiny_params(6)
    tcfg = T.LMConfig(**TINY, grounded=True, sus2=True)
    T.save(str(tmp_path / "port"), pt, tcfg)
    back, cfg = J.load(str(tmp_path / "port.npz"))
    assert cfg == J.LMConfig(**TINY, grounded=True, sus2=True)
    for k in pt:
        np.testing.assert_array_equal(np.asarray(back[k]), pt[k].numpy())
    J.save(str(tmp_path / "jax.npz"), pj, J.LMConfig(**TINY, kinds2=True))
    got, cfg = T.load(str(tmp_path / "jax.npz"), device="cpu")
    assert cfg == T.LMConfig(**TINY, kinds2=True)
    for k in pj:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(pj[k]))


# -- replies of the shipped checkpoint ------------------------------------------


def _divergence(pt, tcfg, ctx, got, ref):
    """The first position where two replies differ, and the top-two logit
    gap of the plain decode there."""
    i = next((k for k, (a, b) in enumerate(zip(got, ref)) if a != b), min(len(got), len(ref)))
    buf, n0 = T._prompt_buf(tcfg, ctx)
    _, lg = CD.decode_plain(pt, tcfg, torch.as_tensor(buf[None]), [n0], 320, logits=True)
    row = lg[0, n0 - 1 + i]
    top = torch.topk(row, 2).values if not torch.isnan(row).any() else torch.zeros(2)
    return f"first divergence at reply byte {i}: gap {float(top[0] - top[1]):.6f}"


def test_greedy_replies_byte_identical_to_jax(shipped, corpus, one_torch_thread):
    pj, jcfg, pt, tcfg = shipped
    ctxs = [c for c, _ in corpus[::5]][:8]
    got = T.greedy_replies(pt, tcfg, ctxs)
    assert got[0] == T.greedy_reply(pt, tcfg, ctxs[0])
    for ctx, g in zip(ctxs, got):
        ref = J.greedy_reply(pj, jcfg, ctx)
        assert g == ref, _divergence(pt, tcfg, ctx, g, ref)
    assert any(len(g) > 20 for g in got)


def test_sampled_replies_byte_identical_to_jax(shipped, corpus, one_torch_thread):
    pj, jcfg, pt, tcfg = shipped
    cases = [(corpus[1][0], 0.8, 0.9, 0), (corpus[7][0], 0.8, 0.9, 1),
             (corpus[12][0], 1.3, 0.95, 2), (corpus[22][0], 0.5, 0.5, 0)]
    for ctx, temp, top_p, salt in cases:
        ref = J.sampled_reply(pj, jcfg, ctx, temperature=temp, top_p=top_p, salt=salt)
        got = T.sampled_reply(pt, tcfg, ctx, temperature=temp, top_p=top_p, salt=salt)
        assert got == ref, (ctx[:40], got, ref)


def test_sampling_at_zero_temperature_is_greedy(shipped, corpus, one_torch_thread):
    _, _, pt, tcfg = shipped
    ctx = corpus[3][0]
    assert T.sampled_reply(pt, tcfg, ctx, temperature=0.0) == T.greedy_reply(pt, tcfg, ctx)


# -- the serving hook ------------------------------------------------------------


def test_hook_attributes_match_jax(one_torch_thread):
    for temp in (0.0, 0.8):
        hook = T.make_lm_hook(CKPT, sample_temp=temp, device="cpu")
        _, cfg = J.load(CKPT)
        assert (hook.grounded, hook.personas, hook.kinds2, hook.sus2) == (
            cfg.grounded, cfg.personas, cfg.kinds2, cfg.sus2)
        assert hook.sampling is (temp > 0)
        assert hook.params["tok"].device.type == "cpu"


@pytest.mark.parametrize("out,ctx", [
    ("Hi Vee, welcome", "K=greeting|S=Vee|Ns=1:Vee,2:Bob"),
    ("Hi Veee, welcome", "K=greeting|S=Vee|Ns=1:Vee,2:Bob"),
    ("the veer turned", "K=greeting|S=Vee|Ns=1:Vee"),
    ("Bobby and Vee", "K=greeting|S=Al|Ns=1:Vee,2:Bob"),
    ("nobody here", "K=default|Q=x"),
])
def test_names_intact_matches_jax(out, ctx):
    assert T.names_intact(out, ctx) == J.names_intact(out, ctx)
    assert sorted(T._ctx_names(ctx)) == sorted(J._ctx_names(ctx))


def test_hook_retries_salts_then_greedy(monkeypatch):
    """The roleplay tier: smalltalk kinds sample with salts 0, 1, 2 while a
    decode garbles a name (or is empty), then greedy; other kinds decode
    greedy; an empty greedy decode returns None."""
    calls = []
    monkeypatch.setattr(T, "load", lambda path, device: ({"tok": torch.zeros(1)},
                                                         T.LMConfig()))
    monkeypatch.setattr(T, "greedy_reply", lambda p, c, ctx, max_new=320:
                        calls.append(("greedy", ctx)) or ("" if "empty" in ctx else "greedy."))
    replies = {0: "Hi Veee.", 1: "", 2: "Hi Vee."}

    def sampled(p, c, ctx, temperature, top_p, salt=0, max_new=320):
        calls.append(("sampled", salt))
        return replies.get(salt, "x") if "S=Vee" in ctx else "bad Veee"

    monkeypatch.setattr(T, "sampled_reply", sampled)
    hook = T.make_lm_hook("ckpt.npz", sample_temp=0.8, device="cpu")
    calls.clear()
    assert hook("K=greeting|S=Vee|Ns=1:Vee|Q=hi") == "Hi Vee."
    assert calls == [("sampled", 0), ("sampled", 1), ("sampled", 2)]
    calls.clear()
    assert hook("K=greeting|S=Al|Ns=1:Vee|Q=hi") == "greedy."
    assert [c[0] for c in calls] == ["sampled"] * 3 + ["greedy"]
    calls.clear()
    assert hook("K=status|S=Vee|Q=who is alive") == "greedy."
    assert calls == [("greedy", "K=status|S=Vee|Q=who is alive")]
    assert hook("K=status|Q=empty") is None
    greedy_only = T.make_lm_hook("ckpt.npz", device="cpu")
    calls.clear()
    assert greedy_only("K=greeting|S=Vee|Q=hi") == "greedy."
    assert calls == [("greedy", "K=greeting|S=Vee|Q=hi")]
