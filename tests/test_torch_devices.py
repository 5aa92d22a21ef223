"""Which card the port's multi-device layer and kernel wrappers use, on the
CPU with torch.cuda's device calls replaced by recorders (no card, no NCCL):

  binding      a rank of run_ranks' body is bound to cuda:{LOCAL_RANK %
               cards} (torch.cuda.set_device) before it joins the world,
               and NCCL is handed that card (device_id); NCCL with more
               ranks than cards raises and joins nothing
  mesh         a mesh's non-member rank keeps its bound card; a rank whose
               current card is not its own is refused
  K2-K4        every entry of the pipeline library that the wrappers call
               (lg_pack, lg_forward, lg_grad, lg_lossgrad) runs while
               torch.cuda.device(<its tensors' card>) is active, on that
               card's stream
"""

import contextlib
import queue
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist

from game_engine_tpu_torch.parallel import launch
from game_engine_tpu_torch.parallel import mesh as M
from game_engine_tpu_torch.parallel.parity import lowered_of
from game_engine_tpu_torch.policies import fused as FZ
from game_engine_tpu_torch.policies import net as N


@pytest.fixture()
def cards(monkeypatch):
    """A host with `cards.n` CUDA cards as far as torch.cuda's counting,
    binding and guards tell; `cards.log` records set_device, guards and
    init_process_group in call order."""
    host = SimpleNamespace(n=4, current=0, log=[])

    def set_device(dev):
        host.current = torch.device(dev).index
        host.log.append(("set_device", torch.device(dev)))

    @contextlib.contextmanager
    def device(dev):
        before, host.current = host.current, torch.device(dev).index
        host.log.append(("guard", torch.device(dev)))
        try:
            yield
        finally:
            host.current = before

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: host.n)
    monkeypatch.setattr(torch.cuda, "set_device", set_device)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: host.current)
    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: SimpleNamespace(
        cuda_stream=1000 + torch.device(dev).index))
    return host


@pytest.mark.parametrize("backend,n_cards,rank,card", [("nccl", 4, 3, 3), ("gloo", 2, 3, 1),
                                                        ("gloo", 1, 2, 0)])
def test_a_rank_is_bound_to_its_card_before_it_joins(monkeypatch, cards, backend, n_cards,
                                                     rank, card):
    cards.n = n_cards
    monkeypatch.setattr(torch, "set_num_threads", lambda n: None)  # this process's own
    monkeypatch.setenv("LOCAL_RANK", "0")  # restored after _rank_main sets it
    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "lo")

    def init(be, **kw):
        cards.log.append(("init", be, kw.get("device_id"), cards.current))

    monkeypatch.setattr(dist, "init_process_group", init)
    results = queue.Queue()
    launch._rank_main(lambda r: r, rank, 4, backend, torch.device("cuda"), "/nowhere",
                      results, (), {})
    assert results.get_nowait() == (rank, "ok", rank)
    bound = torch.device("cuda", card)
    want_id = bound if backend == "nccl" else None
    assert cards.log == [("set_device", bound), ("init", backend, want_id, card)]


def test_nccl_with_more_ranks_than_cards_joins_nothing(monkeypatch, cards):
    cards.n = 2
    monkeypatch.setattr(torch, "set_num_threads", lambda n: None)
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **k: cards.log.append("init"))
    results = queue.Queue()
    launch._rank_main(lambda r: r, 2, 4, "nccl", torch.device("cuda"), "/nowhere", results,
                      (), {})
    rank, status, why = results.get_nowait()
    assert (rank, status) == (2, "error") and 'backend="gloo"' in why
    assert cards.log == []


@pytest.mark.parametrize("current", [3, 0], ids=["bound", "unbound"])
def test_a_non_member_keeps_its_card(monkeypatch, cards, current):
    cards.current = current
    monkeypatch.setenv("LOCAL_RANK", "3")
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 3)
    monkeypatch.setattr(dist, "new_group", lambda ranks, **kw: tuple(ranks))
    if current != 3:
        with pytest.raises(RuntimeError, match="its card is cuda:3"):
            M.mesh_over(np.arange(2).reshape(2, 1), "nccl", "cuda")
        return
    mesh = M.mesh_over(np.arange(2).reshape(2, 1), "nccl", "cuda")
    assert not mesh.member and mesh.device == torch.device("cuda", 3)


class _FakePipelines:
    """The pipeline library's sizing entries, and launch entries that record
    the card torch.cuda.device makes current and the stream they get."""

    def __init__(self, host):
        self.host, self.calls = host, []

    @staticmethod
    def lg_weights_bytes(meta):
        return 64

    @staticmethod
    def lg_scratch_bytes(meta, rows, nsplit, fwd_only):
        return 256 + 16 * rows

    def __getattr__(self, name):
        def launch(*args):
            self.calls.append((name, self.host.current, args[-1]))
            return 0
        return launch


def test_pipeline_entries_launch_under_their_tensors_card(monkeypatch, cards):
    """The wrappers' launches go through _lg_call with the rows' device;
    here the host wrappers' calls are sent to cuda:2 (cuda:0 stays current
    outside the guard) and each entry must see cuda:2 current and its
    stream."""
    fake = _FakePipelines(cards)
    card = torch.device("cuda", 2)
    monkeypatch.setattr(FZ, "_pipeline_lib", lambda device: fake)
    monkeypatch.setattr(FZ, "_pack_cache", {})
    monkeypatch.setattr(FZ._packed, "packs", FZ._packed.packs)
    handed = []
    on_host = FZ._lg_call

    def on_card(name, args, device, what):
        handed.append((name, device))
        on_host(name, args, card, what)

    monkeypatch.setattr(FZ, "_lg_call", on_card)
    lw = lowered_of("werewolf")
    cfg = N.NetConfig(hidden=32, arch="attn")
    d = FZ.dims_for(lw, cfg)
    params = N.init_params(torch.Generator().manual_seed(0), N.obs_dim(lw), N.action_space(lw),
                           cfg, lw, device="cpu")
    rows = torch.zeros((5, d.F), dtype=torch.bfloat16)
    FZ.host_forward(d, rows, params)
    FZ.host_grads(d, rows, torch.zeros((5, d.A + 1)), params)
    FZ.host_loss_grads(d, rows, torch.zeros((5, 2 * d.A + 5)), params, 0.2, 0.01)
    assert [n for n, _ in handed] == ["lg_pack", "lg_forward", "lg_grad", "lg_lossgrad"]
    assert all(dev == rows.device for _, dev in handed)
    assert fake.calls == [(n, 2, 1002) for n, _ in handed]
    assert cards.current == 0
