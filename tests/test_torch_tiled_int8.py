"""K6's host half (`repro_torch.kernels.tiled_int8`) on the CPU.

The kernel itself runs only on a GPU (`tests/test_torch_cluster.py`'s
`cuda`-marked test and `chip_smoke.py`). What it executes is the work list
that `work_units` makes on the host, over the weights `prepare_weights`
makes; both are held here. The list is run in numpy the way the kernel
runs it (rows b * M + m of the batch-folded output, each unit's 128-deep
K chunks of its item, the splits summed) and compared with the JAX
package's `cluster/mesh.py::_tiled_partial` and with the port's plain
version. The split plan is checked over all 54 tiled ops of ResNet50-224
on `scaled_paper_machine(64).with_mesh(1, 1)`.
"""

from __future__ import annotations

import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cluster import mesh as RM
import repro_torch
from repro_torch.cluster import mesh as TM
from repro_torch.core import cnn as tcnn
from repro_torch.core import compiled as TC
from repro_torch.core import init_params as t_init_params
from repro_torch.core.compiled import partition_streams as t_partition
from repro_torch.hw import scaled_paper_machine as t_machine
from repro_torch.kernels.ref import im2col_patches

K6 = importlib.import_module("repro_torch.kernels.tiled_int8")
SMS = 132


def _random_table(rng, M, N, n_tiles):
    """A random disjoint tile table over (M, N) with ragged edges and
    padding rows the mask disables (as in `tests/test_torch_cluster.py`)."""
    rows = np.unique(np.concatenate([[0, M], rng.integers(1, M, 3)]))
    cols = np.unique(np.concatenate([[0, N], rng.integers(1, N, 2)]))
    cells = [(rows[i], rows[i + 1], cols[j], cols[j + 1])
             for i in range(len(rows) - 1) for j in range(len(cols) - 1)]
    pick = rng.permutation(len(cells))[:n_tiles]
    live = np.array([cells[i] for i in pick], np.int64).reshape(-1, 4)
    tiles = np.concatenate([live, np.zeros((3, 4), np.int64)])
    mask = np.concatenate([np.ones(len(live), bool), np.zeros(3, bool)])
    order = rng.permutation(len(tiles))
    return tiles[order], mask[order]


def _run_units(x, wt, plan, geo, N):
    """The kernel's arithmetic in numpy: every unit adds its K chunks'
    product to its item's rows of the (B * M, N) output (int64, exact)."""
    cols = im2col_patches(torch.as_tensor(x), geo.get("kh", 1),
                          geo.get("kw", 1), geo.get("stride", 1),
                          geo.get("padding", 0)).numpy().astype(np.int64)
    B, M, K = cols.shape
    cols = cols.reshape(B * M, K)
    w = wt.numpy().astype(np.int64)
    out = np.zeros((B * M, N), np.int64)
    for m0, m1, n0, n1, c0, c1, _, _ in plan.units.tolist():
        k0, k1 = c0 * K6.CHUNK_K, min(c1 * K6.CHUNK_K, w.shape[1])
        a = np.zeros((m1 - m0, k1 - k0), np.int64)
        a[:, :max(0, min(k1, K) - k0)] = cols[m0:m1, k0:min(k1, K)]
        out[m0:m1, n0:n1] += a @ w[n0:n1, k0:k1].T
    return out.reshape(B, M, N)


def _check_plan(plan, tiles, mask, M, N, K, B, sms=SMS):
    """The plan's contract: items cover the live tiles of every sample
    exactly once, in blocks of at most 64 x bn; each item's units split
    its chunks into balanced, non-empty, disjoint ranges that cover them;
    the units reach `sms` where the chunks allow."""
    u = plan.units
    chunks = math.ceil(K / K6.CHUNK_K)
    assert plan.chunks == chunks and plan.bn in (32, 64, 128)
    assert len(u) == plan.items * plan.splits
    cover = np.zeros((B * M, N), np.int32)
    for i in range(plan.items):
        rows = u[u[:, 6] == i]
        m0, m1, n0, n1 = rows[0, :4]
        assert (rows[:, :4] == rows[0, :4]).all()
        assert 0 < m1 - m0 <= 64 and 0 < n1 - n0 <= plan.bn
        cover[m0:m1, n0:n1] += 1
        assert sorted(rows[:, 7].tolist()) == list(range(plan.splits))
        rows = rows[np.argsort(rows[:, 4])]
        assert rows[0, 4] == 0 and rows[-1, 5] == chunks
        assert (rows[1:, 4] == rows[:-1, 5]).all()       # disjoint, no gap
        size = rows[:, 5] - rows[:, 4]
        assert size.min() >= 1 and size.max() - size.min() <= 1
    want = np.zeros((M, N), np.int32)
    for m0, m1, n0, n1 in K6.live_tiles(tiles, mask, M, N):
        want[m0:m1, n0:n1] = 1
    assert np.array_equal(cover, np.tile(want, (B, 1)))
    assert plan.area == int(cover.sum())
    assert len(u) >= min(sms, plan.items * chunks)
    if plan.items >= sms:
        assert plan.splits == 1


@pytest.fixture(scope="module")
def resnet_ops():
    """(name, tiles, mask, M, N, K) of every tiled op of ResNet50-224's
    1 x 1 mesh program (the whole output as one rank's table)."""
    g = tcnn.resnet50()
    dep = repro_torch.compile(g, t_machine(64).with_mesh(1, 1),
                              backend="mesh", params=t_init_params(g, seed=0),
                              device="cpu")
    prog = dep.program
    parts = t_partition(prog, 1)
    ops = []
    for b in prog.batches:
        if b.kind not in ("gemm", "conv2d"):
            continue
        a = b.attrs
        tiles, mask = TM._stack_tiles(parts, b.op_idx)
        if b.kind == "gemm":
            M, N, K = a["M"], a["N"], a["K"]
        else:
            oh, ow = TC.conv_out_hw(a)
            M, N, K = oh * ow, a["C_out"], a["kh"] * a["kw"] * a["C_in"]
        ops.append((b.name, tiles[0], mask[0], M, N, K))
    return ops


@pytest.mark.parametrize("batch", [1, 8])
def test_k6_split_plan_over_resnet50(resnet_ops, batch):
    """At every tiled op of ResNet50-224, batch 1 and 8: the plan covers
    every item's chunks exactly once, balanced, and its units reach the
    132 SMs where the chunks allow; the serial chain (the longest unit,
    summed over the ops) is far below the unsplit 64-deep walk's."""
    assert len(resnet_ops) == 54
    chain = 0
    for name, tiles, mask, M, N, K in resnet_ops:
        plan = K6.work_units(tiles, mask, M, N, K, batch, SMS)
        _check_plan(plan, tiles, mask, M, N, K, batch)
        chain += int((plan.units[:, 5] - plan.units[:, 4]).max())
    if batch == 1:
        # 859 64-deep chunk steps without split-K; these are 128 deep
        assert 2 * chain < 859 / 2


@pytest.mark.parametrize("batch", [1, 3, 8])
def test_k6_batch_fold_of_the_classifier(batch):
    """The classifier's (B, 1, K) rows fold into one (B, K) product: every
    item spans all B rows, and the plan run in numpy equals
    `tiled_int8_plain`."""
    rng = np.random.default_rng(batch)
    K, N = 2048, 1000
    tiles = np.array([[0, 1, n, min(n + 64, N)] for n in range(0, N, 64)])
    mask = np.ones(len(tiles), bool)
    plan = K6.work_units(tiles, mask, 1, N, K, batch, SMS)
    _check_plan(plan, tiles, mask, 1, N, K, batch)
    assert plan.items == sum(math.ceil((n1 - n0) / plan.bn)
                             for _, _, n0, n1 in tiles)
    assert (plan.units[:, 0] == 0).all() and (plan.units[:, 1] == batch).all()
    x = rng.integers(-128, 128, (batch, 1, 1, K)).astype(np.int8)
    w = torch.as_tensor(rng.integers(-128, 128, (K, N)).astype(np.int8))
    got = _run_units(x, K6.prepare_weights(w), plan, {}, N)
    want = K6.tiled_int8_plain(torch.as_tensor(x), w, tiles, mask)
    assert np.array_equal(got, want.numpy())


@pytest.mark.parametrize("K, N", [(147, 64), (64, 256), (2048, 1000),
                                  (70, 45), (4608, 512)])
def test_k6_prepared_weights_are_w_transposed_and_padded(K, N):
    """`prepare_weights` gives (N, Kp) int8, Kp the least multiple of 16
    >= K, holding w transposed and zeros past K; the wrapper refuses a
    copy of another shape."""
    rng = np.random.default_rng(K)
    w = torch.as_tensor(rng.integers(-128, 128, (K, N)).astype(np.int8))
    wt = K6.prepare_weights(w)
    Kp = -(-K // 16) * 16
    assert wt.dtype == torch.int8 and tuple(wt.shape) == (N, Kp)
    assert wt.is_contiguous() and Kp % 16 == 0 and Kp - K < 16
    assert torch.equal(wt[:, :K], w.t())
    assert not wt[:, K:].any()
    x = torch.zeros((1, 1, 1, K), dtype=torch.int8)
    t, m = np.array([[0, 1, 0, N]]), np.ones(1, bool)
    assert torch.equal(K6.tiled_int8(x, w, t, m, wt=wt),
                       K6.tiled_int8_plain(x, w, t, m))
    with pytest.raises(ValueError, match="prepare_weights"):
        K6.tiled_int8(x, w, t, m,
                      wt=torch.zeros((N, Kp + 16), dtype=torch.int8))


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("kind", ["gemm", "conv3x3s2", "conv1x1", "stem"])
def test_k6_work_units_run_equal_reference(kind, seed):
    """On random tile tables with ragged edges, at batch 1-3 and with
    small SM counts that force splits and 128-wide items: the work list
    run in numpy equals the JAX package's `_tiled_partial` per sample and
    the port's plain version."""
    rng = np.random.default_rng(seed)
    B = 1 + seed
    if kind == "gemm":
        M, K, N = 37, 300, 200
        x = rng.integers(-128, 128, (B, M, 1, K)).astype(np.int8)
        geo = {}
    else:
        k, s, p, C, H = {"conv3x3s2": (3, 2, 1, 32, 9),
                         "conv1x1": (1, 1, 0, 160, 9),
                         "stem": (7, 2, 3, 3, 15)}[kind]
        oh = (H + 2 * p - k) // s + 1
        M, K, N = oh * oh, k * k * C, 150
        x = rng.integers(-128, 128, (B, H, H, C)).astype(np.int8)
        geo = dict(kh=k, kw=k, stride=s, padding=p)
    w = rng.integers(-128, 128, (K, N)).astype(np.int8)
    tiles, mask = _random_table(rng, M, N, n_tiles=5 + seed)
    wt = K6.prepare_weights(torch.as_tensor(w))
    want = K6.tiled_int8_plain(torch.as_tensor(x), torch.as_tensor(w),
                               tiles, mask, **geo).numpy()
    live = tiles[mask]
    mt = int((live[:, 1] - live[:, 0]).max())
    nt = int((live[:, 3] - live[:, 2]).max())
    for b in range(B):
        cols = (x[b].reshape(M, K) if kind == "gemm" else np.asarray(
            RM._im2col_jnp(jnp.asarray(x[b]), geo["kh"], geo["kw"],
                           geo["stride"], geo["padding"])))
        ref = np.asarray(RM._tiled_partial(
            jnp.asarray(cols), jnp.asarray(w), jnp.asarray(tiles),
            jnp.asarray(mask), mt, nt, M, N))
        assert np.array_equal(ref, want[b])
    for sms in (1, 7, 40):
        plan = K6.work_units(tiles, mask, M, N, K, B, sms)
        _check_plan(plan, tiles, mask, M, N, K, B, sms)
        assert np.array_equal(_run_units(x, wt, plan, geo, N), want)


def test_k6_item_width_follows_the_bytes_model():
    """The item width is the one whose units move the fewest bytes through
    one SM: narrow items where they spare a split (a 7 x 7 conv: 16
    items of 32 columns split 9 ways, not 8 of 64 split 17 ways), wide
    ones where the card is full anyway, and never wider than a band."""
    def plan(M, N, K, B):
        return K6.work_units(np.array([[0, M, 0, N]]), np.ones(1, bool),
                             M, N, K, B, SMS)
    cases = {(49, 512, 4608, 1): (32, 16, 9),
             (3025, 128, 256, 1): (32, 192, 1),    # no split at all
             (3025, 256, 64, 1): (64, 192, 1),
             (3025, 256, 64, 2): (128, 190, 1),
             (3025, 64, 64, 8): (64, 379, 1),      # no band wider than 64
             (49, 512, 4608, 8): (64, 56, 3)}
    for (M, N, K, B), want in cases.items():
        p = plan(M, N, K, B)
        assert (p.bn, p.items, p.splits) == want, (M, N, K, B)
        costs = {bn: K6._width_cost(len(K6.work_items(
            np.array([[0, M, 0, N]]), np.ones(1, bool), M, N, B,
            width=bn)[0]), bn, p.chunks, SMS)[0] for bn in K6.WIDTHS}
        assert costs[p.bn] == min(costs.values())


@pytest.mark.cuda
def test_k6_launches_on_each_card_after_another():
    """On two or more GPUs: K6's opt-in to its shared memory and its launch
    follow the tensors' card, not the current one. Each kernel instance
    (a GEMM's TMA loader, a 3x3 conv's cp.async one, the stem's register
    one) runs on card 0, then on every other card with card 0 current,
    then with that card current, int32 equal to the plain version."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA GPUs (K6 has no interpret mode)")
    rng = np.random.default_rng(0)
    cases = [((4, 49, 1, 2048), 1000, {}),
             ((1, 14, 14, 256), 256, dict(kh=3, kw=3, stride=1, padding=1)),
             ((1, 32, 32, 3), 64, dict(kh=7, kw=7, stride=2, padding=3))]
    for shape, N, geo in cases:
        x = torch.as_tensor(rng.integers(-128, 128, shape).astype(np.int8))
        w = torch.as_tensor(rng.integers(
            -128, 128, (geo.get("kh", 1) * geo.get("kw", 1) * shape[-1], N))
            .astype(np.int8))
        oh, ow = K6._out_hw(shape[1], shape[2], geo.get("kh", 1),
                            geo.get("kw", 1), geo.get("stride", 1),
                            geo.get("padding", 0))
        tiles, mask = _random_table(rng, oh * ow, N, n_tiles=4)
        want = K6.tiled_int8_plain(x, w, tiles, mask, **geo)
        torch.cuda.set_device(0)
        runs = [(0, 0)] + [(d, c) for d in range(1, torch.cuda.device_count())
                           for c in (0, d)]
        for dev, current in runs:
            torch.cuda.set_device(current)
            xd, wd = x.to(f"cuda:{dev}"), w.to(f"cuda:{dev}")
            got = K6.tiled_int8(xd, wd, tiles, mask, **geo)
            assert got.device == xd.device
            assert torch.cuda.current_device() == current
            assert torch.equal(got.cpu(), want), (shape, dev, current)
    torch.cuda.set_device(0)
