"""The graphed runner's host arrays (`compiler/backends.py::HostOuts`): a
graph's outputs are read into arrays that are reused once nothing outside
refers to them, so an answer a caller keeps, or a view of it, is never
overwritten by a later read. On the CPU the arrays are pageable; on a CUDA
device they are page-locked (the `cuda`-marked test)."""

from __future__ import annotations

import gc

import numpy as np
import pytest
import torch

from repro_torch.compiler.backends import HostOuts

CPU = torch.device("cpu")


def _outs(v: int) -> dict:
    return {"out": torch.full((4, 3, 5), v, dtype=torch.int32),
            "aux": torch.full((4, 2), -v, dtype=torch.int8)}


def _reads(h: HostOuts) -> tuple:
    return h.made, h.reused, h.pageable


def test_a_read_equals_the_outputs_and_a_free_set_is_reused():
    h = HostOuts(CPU)
    for v in range(5):
        got = h.read(_outs(v), batched=True)
        assert sorted(got) == ["aux", "out"]
        assert got["out"].dtype == np.int32 and got["out"].shape == (4, 3, 5)
        assert (got["out"] == v).all() and (got["aux"] == -v).all()
        del got
    assert _reads(h) == (1, 4, 0) and len(h.sets) == 1


@pytest.mark.parametrize("keep", ["array", "view", "view_of_view", "dict"])
def test_a_kept_answer_is_never_overwritten(keep):
    """What a Server hands a ticket is a row of a read's array: holding
    it, or any view of it, keeps its set out of reuse."""
    h = HostOuts(CPU)
    got = h.read(_outs(1), batched=True)
    kept = {"array": got["out"], "view": got["out"][2],
            "view_of_view": got["out"][2][1:], "dict": got}[keep]
    del got
    for v in range(2, 6):
        h.read(_outs(v), batched=True)          # dropped at once
    want = {"array": 1, "view": 1, "view_of_view": 1}
    if keep == "dict":
        assert (kept["out"] == 1).all() and (kept["aux"] == -1).all()
    else:
        assert (kept == want[keep]).all()
    assert _reads(h) == (2, 3, 0)
    del kept
    gc.collect()
    got = h.read(_outs(7), batched=True)
    assert (got["out"] == 7).all() and h.reused == 4


def test_with_every_set_held_a_read_copies_into_new_arrays():
    h = HostOuts(CPU)
    held = [h.read(_outs(v), batched=True)["out"][0] for v in range(4)]
    assert _reads(h) == (2, 0, 2)
    for v, a in enumerate(held):
        assert (a == v).all()
    del held
    h.read(_outs(9), batched=True)
    assert _reads(h) == (2, 1, 2)


def test_a_single_sample_read_drops_the_batch_axis_and_holds_its_set():
    h = HostOuts(CPU)
    got = [h.read({"out": torch.full((1, 6), v, dtype=torch.int32)},
                  batched=False) for v in range(3)]
    assert [g["out"].shape for g in got] == [(6,)] * 3
    assert _reads(h) == (2, 0, 1)
    for v, g in enumerate(got):
        assert (g["out"] == v).all()
    assert not np.shares_memory(got[0]["out"], got[1]["out"])


@pytest.mark.cuda
def test_on_the_card_the_arrays_are_page_locked_and_exact():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    h = HostOuts(dev)
    x = torch.randint(-2 ** 31, 2 ** 31 - 1, (8, 25200, 85),
                      dtype=torch.int32, device=dev)
    for _ in range(3):
        got = h.read({"out": x}, batched=True)
        assert np.array_equal(got["out"], x.cpu().numpy())
        del got
    assert all(t.is_pinned() for s in h.sets for t, _ in s.values())
    assert _reads(h) == (1, 2, 0)


def test_a_server_reuses_the_host_arrays_and_keeps_a_kept_answer(
        monkeypatch):
    """Through a `Server` on the graphed runner (the CUDA graph replaced
    by the recording fake of `test_torch_graph_runner`): jobs whose
    tickets are dropped reuse one set of host arrays; an answer kept
    across later jobs holds its set, and a second set serves them."""
    import dataclasses

    from test_torch_graph_runner import Body, Fakes

    from repro_torch.compiler import backends as B
    from repro_torch.compiler.backends import BackendOptions, GraphedRunner
    from repro_torch.core import cnn, init_params
    from repro_torch.core import compiled as C
    from repro_torch.hw import scaled_paper_machine
    from repro_torch.serve import Server

    fakes = Fakes()
    monkeypatch.setattr(torch.cuda, "CUDAGraph", fakes.Graph)
    monkeypatch.setattr(torch.cuda, "graph", fakes.capture)

    def batched(prog, options=None, device="cuda"):
        fn = B._cuda_fn(prog, options or BackendOptions(), CPU)
        return GraphedRunner(Body(fn, fakes), prog, CPU, True)
    monkeypatch.setitem(B._REGISTRY, "cuda", dataclasses.replace(
        B.get_backend("cuda"), batched=batched))
    g = cnn.yolov5s(h=64, w=64, num_classes=8, width=0.25)
    srv = Server(scaled_paper_machine(64), backend="cuda", device="cpu")
    srv.register("det", g, period_s=0.1, slots=2,
                 params=init_params(g, seed=3))
    prog = srv.executors["det"].program
    out = g.outputs[0]
    rng = np.random.default_rng(4)
    kept = None
    for j in range(6):
        ts = [srv.submit("det", rng.integers(-128, 128, (64, 64, 3),
                                             dtype=np.int8))
              for _ in range(2)]
        while not all(t.terminal for t in ts):
            srv.step()
        for t in ts:
            want = C.run_numpy(prog, {"input": t.payload})[out]
            assert np.array_equal(t.result().output[out], want)
        if j == 1:
            kept = (ts[0].payload, ts[0].result().output[out])
        del ts, t
    assert np.array_equal(kept[1],
                          C.run_numpy(prog, {"input": kept[0]})[out])
    (host,) = [gr.host for gr in srv._nets["det"].runner.graphs.values()
               if gr is not None]
    # the prime's read made the first set; the kept answer the second
    assert _reads(host) == (2, 5, 0)
