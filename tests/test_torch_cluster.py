"""The port's `repro_torch.cluster` against the JAX package's
`repro.cluster`: one twin for each test of `tests/test_cluster.py`.

Each twin runs the same scenario, on the same seeded inputs, through both
packages and compares what they compute: `make_host_mesh`'s validation,
`with_mesh` fingerprints, `partition_streams`, `DeadlineMonitor.merge`,
the 1 x 1 mesh runners (the JAX package's shard_map on one device against
the port's mesh backend on the CPU, where K6 takes its plain version),
the router's picks and rankings, and the replica fleet's routing, tickets,
telemetry and artifacts. The multi-rank mesh runs in spawned processes
(`tests/test_torch_cluster_ranks.py`); K6 itself is held here against the
reference's `_tiled_partial` (plain `jnp`), and on the card by a
`cuda`-marked test.
"""

import importlib
import re
from unittest import mock

import jax
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.cluster import ClusterServer as RCluster
from repro.cluster import NoReplicaError as RNoReplica
from repro.cluster import Router as RRouter
from repro.cluster import mesh as RM
from repro.cluster.fleet import ClusterError as RClusterError
from repro.core import analyze as r_analyze
from repro.core import cnn as rcnn
from repro.core import init_params as r_init_params
from repro.core import lower_program as r_lower
from repro.core import reference_forward
from repro.core.compiled import CompileError as RCompileError
from repro.core.compiled import partition_streams as r_partition
from repro.hw import scaled_paper_machine as r_machine
from repro.launch.mesh import make_host_mesh as r_make_host_mesh
from repro.serve.monitor import DeadlineMonitor as RMonitor
from repro_torch.cluster import ClusterServer as TCluster
from repro_torch.cluster import NoReplicaError as TNoReplica
from repro_torch.cluster import Router as TRouter
from repro_torch.cluster import mesh as TM
from repro_torch.cluster.fleet import ClusterError as TClusterError
from repro_torch.core import analyze as t_analyze
from repro_torch.core import compiled as TC
from repro_torch.core import cnn as tcnn
from repro_torch.core import init_params as t_init_params
from repro_torch.core import lower_program as t_lower
from repro_torch.core.compiled import CompileError as TCompileError
from repro_torch.core.compiled import partition_streams as t_partition
from repro_torch.hw import scaled_paper_machine as t_machine
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.launch.mesh import make_host_mesh as t_make_host_mesh
from repro_torch.serve.monitor import DeadlineMonitor as TMonitor

# the module (the package re-exports its wrapper under the same name)
K6 = importlib.import_module("repro_torch.kernels.tiled_int8")
N_DEV = len(jax.devices())


def _frame(seed=0, shape=(32, 32, 3)):
    return np.random.default_rng(seed).integers(
        -64, 64, size=shape).astype(np.int8)


def _mesh_prog(core, machine, lower, data, model, cores=4, seed=1):
    g = core.small_cnn()
    hw = machine(cores).with_mesh(data, model)
    analyze = r_analyze if core is rcnn else t_analyze
    init = r_init_params if core is rcnn else t_init_params
    _, sched, subtasks, mapping = analyze(g, hw, num_cores=cores)
    params = init(g, seed=seed)
    prog = lower(g, params, subtasks, mapping, sched, hw=hw)
    return g, params, prog


def _progs(data=1, model=1):
    return (_mesh_prog(rcnn, r_machine, r_lower, data, model),
            _mesh_prog(tcnn, t_machine, t_lower, data, model))


def _raises(fn, exc):
    with pytest.raises(exc) as ei:
        fn()
    return str(ei.value)


# -- make_host_mesh validation ------------------------------------------------

def test_make_host_mesh_rejects_non_divisible():
    bad = N_DEV + 1 if N_DEV > 1 else 3
    msgs = [_raises(lambda: f(data=bad, model=1), ValueError)
            for f in (r_make_host_mesh, t_make_host_mesh)]
    assert msgs[0] == msgs[1]
    assert f"data={bad}" in msgs[1] and str(N_DEV) in msgs[1]


def test_make_host_mesh_rejects_non_divisible_pod():
    bad = N_DEV + 1 if N_DEV > 1 else 5
    msgs = [_raises(lambda: f(data=1, model=1, pod=bad), ValueError)
            for f in (r_make_host_mesh, t_make_host_mesh)]
    assert msgs[0] == msgs[1] and f"pod={bad}" in msgs[1]


def test_make_host_mesh_rejects_nonpositive_axes():
    for f in (r_make_host_mesh, t_make_host_mesh):
        with pytest.raises(ValueError):
            f(data=0, model=1)
        with pytest.raises(ValueError):
            f(data=1, model=-2)
    assert (_raises(lambda: r_make_host_mesh(data=0, model=1), ValueError)
            == _raises(lambda: t_make_host_mesh(data=0, model=1),
                       ValueError))


def test_make_host_mesh_accepts_divisible():
    rmesh = r_make_host_mesh(data=1, model=1)
    tmesh = t_make_host_mesh(data=1, model=1)
    assert dict(rmesh.shape) == dict(tmesh.shape) == {"data": 1, "model": 1}
    assert tmesh.size == rmesh.devices.size == 1
    # no process group: a one-rank mesh whose collectives are skipped
    assert not tmesh.distributed
    assert t_make_host_mesh(data=1, model=1, pod=1).shape == {
        "pod": 1, "data": 1, "model": 1}


# -- HardwareModel.with_mesh ---------------------------------------------------

def test_with_mesh_changes_fingerprint_and_name():
    for machine in (r_machine, t_machine):
        hw = machine(4)
        m = hw.with_mesh(2, 2)
        assert m.mesh_shape == (2, 2)
        assert m.name.endswith("+mesh2x2")
        fps = {hw.fingerprint(), m.fingerprint(),
               hw.with_mesh(1, 4).fingerprint(),
               hw.with_mesh(4, 1).fingerprint()}
        assert len(fps) == 4
    for shape in [(2, 2), (1, 4), (4, 1)]:
        assert (r_machine(4).with_mesh(*shape).fingerprint()
                == t_machine(4).with_mesh(*shape).fingerprint())


def test_with_mesh_rejects_bad_axes():
    for machine in (r_machine, t_machine):
        with pytest.raises(ValueError):
            machine(4).with_mesh(0, 2)


# -- partition_streams ---------------------------------------------------------

def test_partition_streams_exactly_covers():
    (_, _, rprog), (_, _, tprog) = _progs()
    for n in (1, 2, 4):
        rparts, tparts = r_partition(rprog, n), t_partition(tprog, n)
        assert len(tparts) == n
        for rg, tg in zip(rparts, tparts):
            assert sorted(rg) == sorted(tg)
            for op in rg:
                assert np.array_equal(rg[op], tg[op])
        for b in tprog.batches:
            got = sorted(tuple(t) for g in tparts
                         for t in g.get(b.op_idx, []))
            assert got == sorted(tuple(t) for t in b.tiles)


def test_partition_streams_respects_core_blocks():
    (_, _, rprog), (_, _, tprog) = _progs()
    parts = t_partition(tprog, 2)
    per = tprog.num_cores // 2
    assert [[(i.op_idx, i.bounds) for i in s] for s in tprog.core_streams] \
        == [[(i.op_idx, i.bounds) for i in s] for s in rprog.core_streams]
    for core, stream in enumerate(tprog.core_streams):
        g = core // per
        for ins in stream:
            assert any(tuple(ins.bounds) == tuple(t)
                       for t in parts[g][ins.op_idx])


def test_partition_streams_rejects_non_divisor():
    (_, _, rprog), (_, _, tprog) = _progs()
    msgs = [_raises(lambda: f(p, 3), exc) for f, p, exc in
            ((r_partition, rprog, RCompileError),
             (t_partition, tprog, TCompileError))]
    assert msgs[0] == msgs[1]
    assert "4" in msgs[1] and "3" in msgs[1]
    with pytest.raises(TCompileError):
        t_partition(tprog, 0)


# -- DeadlineMonitor.merge -----------------------------------------------------

def _filled_monitor(cls, latencies, bound=1.0, network="n", ratio=1.0):
    m = cls(speed_ratio=ratio)
    for lat in latencies:
        m.check(network, lat, bound)
    return m


def _both(fn):
    """fn(DeadlineMonitor class) in both packages; their results."""
    return fn(RMonitor), fn(TMonitor)


def test_monitor_merge_counts_and_reservoirs():
    def run(cls):
        a = _filled_monitor(cls, [0.5, 0.7, 9.0])
        b = _filled_monitor(cls, [0.2, 8.0, 7.0])
        assert a.merge(b) is a
        return a.snapshot()
    r, t = _both(run)
    assert r == t
    assert t["networks"]["n"]["checks"] == 6
    assert t["networks"]["n"]["misses"] == 3
    assert t["networks"]["n"]["max_s"] == 9.0
    assert sum(t["networks"]["n"]["histogram"].values()) == 6


def test_monitor_merge_disjoint_networks():
    def run(cls):
        a = _filled_monitor(cls, [0.5], network="x")
        a.merge(_filled_monitor(cls, [0.5, 0.6], network="y"))
        return dict(a.checks), a.miss_rate("y")
    r, t = _both(run)
    assert r == t == ({"x": 1, "y": 2}, 0.0)


def test_monitor_merge_occupancy_mean_is_global():
    def run(cls):
        a, b = cls(speed_ratio=1.0), cls(speed_ratio=1.0)
        a.record_occupancy("n", 2, 4)
        a.record_occupancy("n", 4, 4)
        b.record_occupancy("n", 0, 4)
        b.record_occupancy("n", 2, 4)
        return a.merge(b).mean_occupancy("n")
    r, t = _both(run)
    assert r == t == pytest.approx(8 / 16)


def test_monitor_merge_occupancy_capacity_mismatch():
    def run(cls):
        a, b = cls(speed_ratio=1.0), cls(speed_ratio=1.0)
        a.record_occupancy("n", 1, 4)
        b.record_occupancy("n", 1, 8)
        return _raises(lambda: a.merge(b), ValueError)
    r, t = _both(run)
    assert r == t


def test_monitor_merge_events_and_ratio():
    def run(cls):
        a = cls()
        b = cls(speed_ratio=2.5)
        b.record_event("n", "shed")
        b.record_event("n", "shed")
        b.record_event("n", "retry")
        a.merge(b)
        c = cls(speed_ratio=9.0)
        c.merge(b)
        return (a.speed_ratio, a.event_count("shed"),
                a.event_count("retry"), c.speed_ratio)
    r, t = _both(run)
    assert r == t == (2.5, 2, 1, 9.0)


def test_monitor_merge_bounds_reservoir():
    def run(cls):
        a = cls(speed_ratio=1.0, max_samples=4)
        a.merge(_filled_monitor(cls, [0.1] * 10))
        return list(a._lat["n"])
    r, t = _both(run)
    assert r == t and len(t) == 4


# -- mesh execution ------------------------------------------------------------

def test_mesh_runner_bit_exact_1x1():
    """The 1 x 1 mesh runs alone (no process group): bit-exact vs the whole
    graph oracle and vs the JAX package's shard_map runner."""
    (g, params, rprog), (_, _, tprog) = _progs()
    x = _frame(2)
    ref = reference_forward(g, params, {"input": x})
    rout = RM.mesh_single_runner(rprog)({"input": x})
    tout = TM.mesh_single_runner(tprog, "cpu")({"input": x})
    for t in g.outputs:
        assert np.array_equal(ref[t], tout[t])
        assert np.array_equal(np.asarray(rout[t]), tout[t])


@pytest.mark.parametrize("batch", [1, 3])
def test_mesh_batched_runner_1x1(batch):
    (g, params, rprog), (_, _, tprog) = _progs()
    xb = np.stack([_frame(10 + i) for i in range(batch)])
    rout = RM.mesh_batched_runner(rprog)({"input": xb})
    tout = TM.mesh_batched_runner(tprog, "cpu")({"input": xb})
    for i in range(batch):
        ref = reference_forward(g, params, {"input": xb[i]})
        for t in g.outputs:
            assert np.array_equal(ref[t], tout[t][i])
    for t in g.outputs:
        assert np.array_equal(np.asarray(rout[t]), tout[t])


def test_mesh_backend_machine_pairing_enforced():
    from repro.compiler import BackendError as RBE
    from repro_torch.compiler import BackendError as TBE
    for pkg, cnn, machine, be, single, kw in (
            (repro, rcnn, r_machine, RBE, "jax", {}),
            (repro_torch, tcnn, t_machine, TBE, "torch",
             {"device": "cpu"})):
        g = cnn.small_cnn()
        hw = machine(4)
        with pytest.raises(be):
            pkg.compile(g, hw, backend="mesh", **kw)
        with pytest.raises(be):
            pkg.compile(g, hw.with_mesh(1, 1), backend=single, **kw)
    dep = repro_torch.compile(tcnn.small_cnn(), t_machine(4).with_mesh(1, 1),
                              backend="mesh", num_cores=4, device="cpu")
    assert dep.backend == "mesh"


def test_mesh_pairing_enforced_on_override_and_swap():
    from repro.compiler import BackendError as RBE
    from repro_torch.compiler import BackendError as TBE
    x = _frame(0)
    msgs = []
    for pkg, cnn, machine, be, single, kw in (
            (repro, rcnn, r_machine, RBE, "jax", {}),
            (repro_torch, tcnn, t_machine, TBE, "torch",
             {"device": "cpu"})):
        g = cnn.small_cnn()
        dep = pkg.compile(g, machine(4), backend="numpy", num_cores=4, **kw)
        mesh_dep = pkg.compile(g, machine(4).with_mesh(1, 1),
                               backend="mesh", num_cores=4, **kw)
        got = []
        for fn, match in (
                (lambda: dep.run({"input": x}, backend="mesh"), "mesh shape"),
                (lambda: dep.with_backend("mesh"), "mesh shape"),
                (lambda: mesh_dep.run({"input": x}, backend=single),
                 "single-device"),
                (lambda: mesh_dep.with_backend("numpy"), "single-device")):
            with pytest.raises(be, match=match) as ei:
                fn()
            got.append(str(ei.value).replace(single, "<single>"))
        msgs.append(got)
    assert msgs[0] == msgs[1]


def test_mesh_model_axis_must_divide_cores():
    x = _frame(1)
    msgs = []
    for pkg, cnn, machine, exc, kw in (
            (repro, rcnn, r_machine, RCompileError, {}),
            (repro_torch, tcnn, t_machine, TCompileError,
             {"device": "cpu"})):
        hw = machine(4).with_mesh(1, 3)
        dep = pkg.compile(cnn.small_cnn(), hw, backend="mesh", num_cores=4,
                          **kw)
        msgs.append(_raises(lambda: dep.run({"input": x}), exc))
    assert msgs[0] == msgs[1]


def test_mesh_artifact_refuses_wrong_mesh(tmp_path):
    from repro_torch.compiler import ArtifactError
    g = tcnn.small_cnn()
    params = t_init_params(g, seed=1)
    hw = t_machine(4)
    dep = repro_torch.compile(g, hw.with_mesh(1, 1), backend="mesh",
                              params=params, num_cores=4, device="cpu")
    path = str(tmp_path / "net.rtdep")
    dep.save(path)
    dep2 = repro_torch.Deployment.load(path, machine=hw.with_mesh(1, 1),
                                       device="cpu")
    x = _frame(4)
    out = dep2.run({"input": x})
    rdep = repro.compile(rcnn.small_cnn(), r_machine(4), backend="jax",
                         params=r_init_params(rcnn.small_cnn(), seed=1),
                         num_cores=4)
    ref = rdep.run({"input": x})
    for t in g.outputs:
        assert np.array_equal(dep.run({"input": x})[t], out[t])
        assert np.array_equal(np.asarray(ref[t]), out[t])
    with pytest.raises(ArtifactError):
        repro_torch.Deployment.load(path, machine=hw.with_mesh(1, 2),
                                    device="cpu")
    with pytest.raises(ArtifactError):
        repro_torch.Deployment.load(path, machine=hw, device="cpu")


# -- router --------------------------------------------------------------------

def _status(depth=0, cap=8, slots=1, shed=False, breaker=False,
            departing=False, bound=0.01, deadline=0.02):
    return {"queue_depth": depth, "queue_capacity": cap, "slots": slots,
            "shed": shed, "breaker_open": breaker, "departing": departing,
            "bound_s": bound, "deadline_s": deadline}


def _pick(statuses):
    """Both routers' pick for `statuses` (fresh copies each): equal."""
    r = RRouter.pick("n", [dict(s) for s in statuses])
    t = TRouter.pick("n", [dict(s) for s in statuses])
    assert r == t
    return t


def test_router_prefers_headroom_then_depth_then_index():
    assert _pick([_status(depth=2), _status(depth=4), _status(depth=2)]) == 0
    assert _pick([_status(depth=4), _status(depth=2), _status(depth=3)]) == 1


def test_router_headroom_scales_backlog_by_slots():
    a = _status(depth=4, slots=1)
    b = _status(depth=4, slots=4)
    for router in (RRouter, TRouter):
        assert router.headroom(b) > router.headroom(a)
    assert RRouter.headroom(a) == TRouter.headroom(a)
    assert _pick([a, b]) == 1


def test_router_routes_around_unavailable_replicas():
    for flag in ("shed", "breaker_open", "departing"):
        statuses = [_status(), _status(), _status()]
        statuses[0][flag] = True
        assert _pick(statuses) == 1


def test_router_degraded_fallback_when_none_eligible():
    statuses = [_status(shed=True, depth=3), _status(shed=True, depth=1),
                _status(shed=True, depth=2)]
    assert _pick(statuses) == 1


def test_router_saturated_raises():
    full = _status(depth=8, cap=8)
    for router, exc in ((RRouter, RNoReplica), (TRouter, TNoReplica)):
        with pytest.raises(exc):
            router.pick("n", [full, dict(full)])
        with pytest.raises(exc):
            router.pick("n", [])
    from repro_torch.serve.runtime import BackpressureError
    assert issubclass(TNoReplica, BackpressureError)


def test_router_deterministic():
    statuses = [_status(depth=1), _status(depth=2), _status(depth=1)]
    picks = {_pick(statuses) for _ in range(10)}
    assert picks == {0}
    rows = TRouter.explain("n", statuses)
    assert rows == RRouter.explain("n", statuses)
    assert [r["replica"] for r in rows] == [0, 2, 1]
    assert all(r["eligible"] for r in rows)


# -- fleet ---------------------------------------------------------------------

def _cluster(pkg, replicas=3, backend="numpy", **kw):
    """A fleet of `replicas` servers of small_cnn in package `pkg` ("r":
    the JAX package, "t": the port, on the CPU)."""
    if pkg == "r":
        cs = RCluster(r_machine(8), replicas=replicas, backend=backend,
                      num_cores=4, speed_ratio=1e6, **kw)
        cnn = rcnn
    else:
        cs = TCluster(t_machine(8), replicas=replicas, backend=backend,
                      num_cores=4, speed_ratio=1e6, device="cpu", **kw)
        cnn = tcnn
    cs.register("cnn", cnn.small_cnn(), period_s=1 / 50, slots=2,
                criticality=1)
    return cs


def _tickets(cs, n, network="cnn", seed0=0):
    return [cs.submit(network, {"input": _frame(seed0 + i)})
            for i in range(n)]


def _same_tickets(rts, tts):
    assert [(t.replica, t.tid, t.network, t.status) for t in rts] == \
        [(t.replica, t.tid, t.network, t.status) for t in tts]
    for rt, tt in zip(rts, tts):
        if rt.status != "done":
            continue
        ro, to = rt.result().output, tt.result().output
        assert sorted(ro) == sorted(to)
        for k in ro:
            assert np.array_equal(np.asarray(ro[k]), to[k])


def test_cluster_balances_and_every_ticket_terminal():
    out = {}
    for pkg in ("r", "t"):
        cs = _cluster(pkg, replicas=3)
        tickets = _tickets(cs, 9)
        assert cs.dispatched == [3, 3, 3]
        cs.run(hyperperiods=3)
        assert all(t.terminal for t in tickets)
        assert all(t.status == "done" for t in tickets)
        out[pkg] = tickets
    _same_tickets(out["r"], out["t"])


def _telemetry_counts(tel):
    return {"networks": {n: (v["checks"], v["misses"])
                         for n, v in tel["networks"].items()},
            "metrics": tel["metrics"], "replicas": tel["replicas"],
            "dispatched": tel["dispatched"],
            "per_replica": [{k: v for k, v in row.items()}
                            for row in tel["per_replica"]]}


def test_cluster_telemetry_merges_replicas():
    tels = {}
    for pkg in ("r", "t"):
        cs = _cluster(pkg, replicas=2)
        _tickets(cs, 4)
        tel = cs.run(hyperperiods=1)
        per = [s.monitor.checks.get("cnn", 0) for s in cs.servers]
        assert tel["networks"]["cnn"]["checks"] == sum(per) > 0
        assert tel["metrics"]["tickets"] == 4
        assert tel["replicas"] == 2
        assert sum(tel["dispatched"]) == 4
        assert len(tel["per_replica"]) == 2
        tels[pkg] = _telemetry_counts(tel)
    assert tels["r"] == tels["t"]


def test_cluster_routes_around_shed_replica():
    out = {}
    for pkg, cnn in (("r", rcnn), ("t", tcnn)):
        cs = _cluster(pkg, replicas=3)
        for srv in cs.servers:
            srv.register("aux", cnn.small_cnn(), period_s=1 / 25)
        cs.servers[1].shed("aux")
        tickets = _tickets(cs, 4, "aux")
        assert {t.replica for t in tickets} == {0, 2}
        cs.shed("aux")
        t = cs.submit("aux", {"input": _frame(9)})
        assert t.terminal and t.status == "degraded"
        out[pkg] = tickets + [t], cs.routing("aux")
    _same_tickets(out["r"][0], out["t"][0])
    assert out["r"][1] == out["t"][1]


def test_cluster_register_failure_is_clean_on_replica0():
    for cls, machine, err, kw in ((RCluster, r_machine, RClusterError, {}),
                                  (TCluster, t_machine, TClusterError,
                                   {"device": "cpu"})):
        cs = cls(machine(8), replicas=2, backend="numpy", num_cores=4, **kw)
        with pytest.raises(Exception) as ei:
            cs.register("junk", object(), period_s=1 / 10)
        assert not isinstance(ei.value, err)
        assert "junk" not in cs.networks


def test_cluster_save_load_roundtrip(tmp_path):
    import json
    cs = _cluster("t", replicas=2)
    path = str(tmp_path / "fleet.cluster")
    cs.save(path)
    rpath = str(tmp_path / "ref.cluster")
    _cluster("r", replicas=2).save(rpath)
    manifest = json.loads((tmp_path / "fleet.cluster" / "cluster.json")
                          .read_text())
    rmanifest = json.loads((tmp_path / "ref.cluster" / "cluster.json")
                           .read_text())
    assert manifest == rmanifest            # same format, machine, router
    cs2 = TCluster.load(path, device="cpu")
    assert cs2.replicas == 2
    t = cs2.submit("cnn", {"input": _frame(1)})
    cs2.run(hyperperiods=1)
    assert t.status == "done"
    rcs2 = RCluster.load(rpath)
    rt = rcs2.submit("cnn", {"input": _frame(1)})
    rcs2.run(hyperperiods=1)
    _same_tickets([rt], [t])
    cs3 = TCluster.load(path, replicas=4, device="cpu")
    assert cs3.replicas == 4


def test_cluster_load_refuses_wrong_machine(tmp_path):
    from repro.compiler import ArtifactError as RAE
    from repro_torch.compiler import ArtifactError as TAE
    for pkg, cls, machine, exc, kw in (
            ("r", RCluster, r_machine, RAE, {}),
            ("t", TCluster, t_machine, TAE, {"device": "cpu"})):
        path = str(tmp_path / f"{pkg}.cluster")
        _cluster(pkg, replicas=2).save(path)
        with pytest.raises(exc):
            cls.load(path, machine=machine(8).with_mesh(2, 2), **kw)


def test_cluster_load_rejects_non_cluster_dir(tmp_path):
    with pytest.raises(RClusterError):
        RCluster.load(str(tmp_path))
    with pytest.raises(TClusterError):
        TCluster.load(str(tmp_path), device="cpu")


def test_cluster_artifact_passes_analysis_cli(tmp_path, capsys):
    """`python -m repro_torch.analysis` exits 0 on a cluster artifact, as
    the JAX package's CLI does on its own, with the same report."""
    from repro.analysis.__main__ import main as rmain
    from repro_torch.analysis.__main__ import main as tmain
    outs = []
    for pkg, main in (("r", rmain), ("t", tmain)):
        path = str(tmp_path / "fleet.cluster")
        _cluster(pkg, replicas=2).save(path)
        capsys.readouterr()
        assert main([path]) == 0
        assert main(["--strict", path]) == 0
        outs.append(re.sub(r" in [0-9.]+ ms", "", capsys.readouterr().out))
    assert outs[0] == outs[1]
    assert "0 diagnostics" in outs[1]


def test_cluster_server_on_mesh_backend():
    """The fleet composes with the mesh backend: replicas of a Server whose
    executors run on a (1, 1) mesh, with the JAX package's outputs."""
    out = {}
    for pkg, cls, machine, cnn, kw in (
            ("r", RCluster, r_machine, rcnn, {}),
            ("t", TCluster, t_machine, tcnn, {"device": "cpu"})):
        cs = cls(machine(8).with_mesh(1, 1), replicas=2, backend="mesh",
                 num_cores=4, speed_ratio=1e6, **kw)
        cs.register("cnn", cnn.small_cnn(), period_s=1 / 50, slots=2)
        tickets = _tickets(cs, 4)
        cs.run(hyperperiods=2)
        assert all(t.status == "done" for t in tickets)
        out[pkg] = tickets
    _same_tickets(out["r"], out["t"])


# -- the cluster artifact's manifest checks (analysis CLI) -------------------

@pytest.mark.parametrize("fault", ["kind", "replicas", "bundle"])
def test_cluster_manifest_refusals_exit_2(tmp_path, fault, capsys):
    """A corrupt cluster directory (wrong manifest kind, replicas < 1, a
    missing replica bundle) is an unreadable artifact: exit 2 in both
    CLIs, and `analyze_cluster` raises the same message."""
    import json
    import shutil
    from repro.analysis.__main__ import main as rmain
    from repro.analysis.runner import analyze_cluster as r_analyze_cluster
    from repro_torch.analysis.__main__ import main as tmain
    from repro_torch.analysis.runner import (analyze_cluster,
                                             is_cluster_artifact)
    msgs = []
    for pkg, main, analyze_fn in (("r", rmain, r_analyze_cluster),
                                  ("t", tmain, analyze_cluster)):
        path = tmp_path / f"{pkg}.cluster"
        _cluster(pkg, replicas=2).save(str(path))
        manifest = json.loads((path / "cluster.json").read_text())
        if fault == "bundle":
            shutil.rmtree(path / "replica.bundle")
        else:
            manifest.update({"kind": "replica"} if fault == "kind"
                            else {"replicas": 0})
            (path / "cluster.json").write_text(json.dumps(manifest))
        assert is_cluster_artifact(str(path))
        assert main([str(path)]) == 2
        msgs.append(_raises(lambda: analyze_fn(str(path)), ValueError)
                    .replace(f"{pkg}.cluster", "X"))
    capsys.readouterr()
    assert msgs[0] == msgs[1]


# -- K6: the tile-table kernel's plain version and its dispatch -------------

def _random_table(rng, M, N, n_tiles):
    """A random disjoint tile table over (M, N): a random grid of row and
    column cuts (ragged edges), a random subset of its cells, and padding
    rows the mask disables."""
    rows = np.unique(np.concatenate([[0, M], rng.integers(1, M, 3)]))
    cols = np.unique(np.concatenate([[0, N], rng.integers(1, N, 2)]))
    cells = [(rows[i], rows[i + 1], cols[j], cols[j + 1])
             for i in range(len(rows) - 1) for j in range(len(cols) - 1)]
    pick = rng.permutation(len(cells))[:n_tiles]
    live = np.array([cells[i] for i in pick], np.int64).reshape(-1, 4)
    pad = 3
    tiles = np.concatenate([live, np.zeros((pad, 4), np.int64)])
    mask = np.concatenate([np.ones(len(live), bool), np.zeros(pad, bool)])
    order = rng.permutation(len(tiles))
    return tiles[order], mask[order]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("kind", ["gemm", "conv3x3s2", "conv1x1"])
def test_k6_plain_matches_reference_tiled_partial(kind, seed):
    """K6's plain version against the JAX package's `_tiled_partial` (plain
    jnp) on random tile tables with ragged edges and masked rows."""
    import jax.numpy as jnp
    rng = np.random.default_rng(seed)
    if kind == "gemm":
        M, K, N = 37, 70, 45
        x = rng.integers(-128, 128, (M, K)).astype(np.int8)
        cols, kw_ = x, {}
        xt = torch.as_tensor(x).reshape(1, M, 1, K)
    else:
        k, s, p, C = (3, 2, 1, 5) if kind == "conv3x3s2" else (1, 1, 0, 16)
        H = W = 9
        x = rng.integers(-128, 128, (H, W, C)).astype(np.int8)
        oh = (H + 2 * p - k) // s + 1
        M, K, N = oh * oh, k * k * C, 21
        cols = np.asarray(RM._im2col_jnp(jnp.asarray(x), k, k, s, p))
        kw_ = dict(kh=k, kw=k, stride=s, padding=p)
        xt = torch.as_tensor(x)[None]
    w = rng.integers(-128, 128, (K, N)).astype(np.int8)
    tiles, mask = _random_table(rng, M, N, n_tiles=5 + seed)
    live = tiles[mask]
    mt = max(int((live[:, 1] - live[:, 0]).max()), 1)
    nt = max(int((live[:, 3] - live[:, 2]).max()), 1)
    ref = np.asarray(RM._tiled_partial(jnp.asarray(cols), jnp.asarray(w),
                                       jnp.asarray(tiles), jnp.asarray(mask),
                                       mt, nt, M, N))
    got = K6.tiled_int8_plain(xt, torch.as_tensor(w), tiles, mask, **kw_)
    assert got.dtype == torch.int32 and tuple(got.shape) == (1, M, N)
    assert np.array_equal(ref, got[0].numpy())
    # the kernel's work list covers exactly the live tiles, in pieces of
    # at most 64 x 64
    items, area = K6.work_items(tiles, mask, M, N)
    cover = np.zeros((M, N), np.int32)
    for m0, m1, n0, n1 in items:
        assert 0 < m1 - m0 <= 64 and 0 < n1 - n0 <= 64
        cover[m0:m1, n0:n1] += 1
    want = np.zeros((M, N), np.int32)
    for m0, m1, n0, n1 in live:
        want[m0:m1, n0:n1] = 1
    assert np.array_equal(cover, want) and area == want.sum()


def test_k6_work_items_merge_stacked_tiles():
    """Tiles of one column band that meet end to end become one rectangle
    before the 64 x 64 cut (ResNet50's 32-row tiles fill whole items)."""
    tiles = np.array([[0, 32, 0, 64], [32, 64, 0, 64], [64, 80, 0, 64],
                      [0, 32, 64, 100]], np.int64)
    items, area = K6.work_items(tiles, np.ones(4, bool), 80, 100)
    assert sorted(map(tuple, items.tolist())) == [
        (0, 32, 64, 100), (0, 64, 0, 64), (64, 80, 0, 64)]
    assert area == 80 * 64 + 32 * 36
    # a tile outside the output, or empty, is refused before any launch
    for bad in ([[0, 81, 0, 64]], [[0, 32, 64, 101]], [[5, 5, 0, 8]]):
        with pytest.raises(ValueError, match="rectangle"):
            K6.work_items(np.array(bad), np.ones(1, bool), 80, 100)
    # a masked-off row is never read
    assert K6.work_items(np.array([[0, 999, 0, 999]]), np.zeros(1, bool),
                         80, 100)[1] == 0


def test_mesh_runner_on_cpu_takes_k6_plain(monkeypatch):
    """On CPU tensors the mesh program's tiled ops go through K6's wrapper,
    which takes its plain version once per tiled op per program, and no
    kernel launch is counted."""
    (g, params, rprog), (_, _, tprog) = _progs()
    plain = mock.Mock(wraps=K6.tiled_int8_plain)
    monkeypatch.setattr(K6, "tiled_int8_plain", plain)
    reset_launch_counts()
    x = _frame(5)
    out = TM.mesh_single_runner(tprog, "cpu")({"input": x})
    tiled = sum(b.kind in ("gemm", "conv2d") for b in tprog.batches)
    assert plain.call_count == tiled > 0
    assert sum(launch_counts().values()) == 0
    ref = reference_forward(g, params, {"input": x})
    for t in g.outputs:
        assert np.array_equal(ref[t], out[t])


def test_cuda_only_paths_raise_without_a_card():
    """Without a GPU the CUDA entry points raise rather than fall back:
    the mesh backend on its default device, and K6's wrapper on a tensor
    that is not on the CPU or a GPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a GPU")
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.compile(tcnn.small_cnn(), t_machine(4).with_mesh(1, 1),
                            backend="mesh", num_cores=4, device="cuda")
    (_, _, tprog) = _mesh_prog(tcnn, t_machine, t_lower, 1, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        TM.mesh_single_runner(tprog)
    x = torch.zeros((1, 4, 4, 16), dtype=torch.int8, device="meta")
    w = torch.zeros((16, 8), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        K6.tiled_int8(x, w, np.array([[0, 16, 0, 8]]), np.ones(1, bool))


@pytest.mark.cuda
def test_k6_kernel_matches_plain_on_the_card():
    """On a GPU: K6 against its plain version, int32 equal, on random
    tables, on split items, the classifier's batch fold and the stem's
    geometry, and on every tiled op of a test-size ResNet's 4-way split;
    the mesh backend prepares each op's K-major weights once, when it
    builds the program, and never per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (K6 has no interpret mode)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    for B, (H, C, k, s, p, N) in [(1, (9, 16, 3, 1, 1, 70)),
                                  (3, (15, 3, 7, 2, 3, 64)),
                                  (2, (8, 48, 1, 1, 0, 37))]:
        oh = (H + 2 * p - k) // s + 1
        x = torch.as_tensor(rng.integers(-128, 128, (B, H, H, C))
                            .astype(np.int8)).to(dev)
        w = torch.as_tensor(rng.integers(-128, 128, (k * k * C, N))
                            .astype(np.int8)).to(dev)
        tiles, mask = _random_table(rng, oh * oh, N, n_tiles=6)
        kw_ = dict(kh=k, kw=k, stride=s, padding=p)
        reset_launch_counts()
        got = K6.tiled_int8(x, w, tiles, mask, **kw_)
        assert launch_counts()["tiled_int8"] == 1
        assert torch.equal(got, K6.tiled_int8_plain(x, w, tiles, mask, **kw_))
    # split items (a 7 x 7 3x3 conv: 8 items, 17 splits each), the
    # classifier's batch fold (B = 8 rows of M = 1 in one item) and the
    # stem's geometry (C = 3, 7 x 7 stride 2: the register loader), each
    # on its whole output and on the weights prepared once
    for B, (H, W, C, k, s, p, N) in [(1, (14, 14, 512, 3, 2, 1, 512)),
                                     (8, (1, 1, 2048, 1, 1, 0, 1000)),
                                     (2, (64, 64, 3, 7, 2, 3, 64))]:
        oh, ow = (H + 2 * p - k) // s + 1, (W + 2 * p - k) // s + 1
        x = torch.as_tensor(rng.integers(-128, 128, (B, H, W, C))
                            .astype(np.int8)).to(dev)
        w = torch.as_tensor(rng.integers(-128, 128, (k * k * C, N))
                            .astype(np.int8)).to(dev)
        tiles, mask = np.array([[0, oh * ow, 0, N]]), np.ones(1, bool)
        plan = K6.work_units(tiles, mask, oh * ow, N, k * k * C, B)
        assert plan.splits > 1 or C == 3
        kw_ = dict(kh=k, kw=k, stride=s, padding=p)
        got = K6.tiled_int8(x, w, tiles, mask, wt=K6.prepare_weights(w),
                            **kw_)
        assert torch.equal(got, K6.tiled_int8_plain(x, w, tiles, mask,
                                                    **kw_))
    (_, _, mprog) = _mesh_prog(tcnn, t_machine, t_lower, 1, 1)
    n_tiled = sum(b.kind in ("gemm", "conv2d") for b in mprog.batches)
    with mock.patch.object(TM, "prepare_weights",
                           wraps=K6.prepare_weights) as once, \
            mock.patch.object(K6, "prepare_weights",
                              wraps=K6.prepare_weights) as per_call:
        body = TM._mesh_body(mprog, t_make_host_mesh(1, 1), dev)
        assert once.call_count == n_tiled > 0
        xin = TC.to_device(mprog, {"input": _frame(5)[None]}, dev)
        reset_launch_counts()
        body(xin)
        body(xin)
        assert once.call_count == n_tiled and per_call.call_count == 0
        assert launch_counts()["tiled_int8"] == 2 * n_tiled
    g = tcnn.resnet50(h=32, w=32, width=0.25, blocks=(1, 1, 1, 1),
                      num_classes=16)
    hw = t_machine(4)
    _, sched, subtasks, mapping = t_analyze(g, hw, num_cores=4)
    prog = t_lower(g, t_init_params(g, seed=0), subtasks, mapping, sched,
                   hw=hw)
    parts = t_partition(prog, 4)
    for b in prog.batches:
        if b.kind != "conv2d":
            continue
        a = b.attrs
        tiles, mask = TM._stack_tiles(parts, b.op_idx)
        x = torch.as_tensor(rng.integers(-128, 128, (2, a["H"], a["W"],
                                                     a["C_in"]))
                            .astype(np.int8)).to(dev)
        w = torch.as_tensor(prog.weights[b.w_idx]).to(dev)
        kw_ = dict(kh=a["kh"], kw=a["kw"], stride=a["stride"],
                   padding=a["padding"])
        for r in range(4):
            assert torch.equal(
                K6.tiled_int8(x, w, tiles[r], mask[r], **kw_),
                K6.tiled_int8_plain(x, w, tiles[r], mask[r], **kw_))
