"""The port's compiler front door, backend registry and backend options
against the JAX package's: the twins of `tests/test_compiler_api.py` and
`tests/test_megakernel.py:105-265` that `tests/test_torch_compiler_api.py`
does not hold.

Both packages compile the same graphs with the same parameters (the port
on the CPU, where the "cuda" backend's kernels take their plain
versions). Outputs must be equal bit for bit and equal to the JAX
package's `reference_forward`; refusals must raise the same errors. The
JAX package's "pallas" options (`interpret=True`) map to the port's
"cuda" backend with the options it has (`megakernel`, `max_kernels`,
`scratchpad_budget`).
"""

import dataclasses
import types
import warnings
from unittest import mock

import numpy as np
import pytest

import repro
import repro.compiler as RC
import repro.core as R
import repro.core.graph as RG
import repro.core.taskset as RT
import repro.hw as RH
import repro.serve.engine as RE
import repro.serve.predictable as RP
import repro.serve.runtime as RS
import repro_torch
import repro_torch.compiler as TC
import repro_torch.core as T
import repro_torch.core.graph as TG
import repro_torch.core.taskset as TT
import repro_torch.hw as TH
import repro_torch.serve.engine as TE
import repro_torch.serve.predictable as TP
import repro_torch.serve.runtime as TS

PKGS = (
    types.SimpleNamespace(name="jax", pkg=repro, C=RC, core=R, G=RG, T=RT,
                          E=RE, P=RP, S=RS, hw=RH.scaled_paper_machine(4),
                          kw={}, device_kw={}),
    types.SimpleNamespace(name="torch", pkg=repro_torch, C=TC, core=T,
                          G=TG, T=TT, E=TE, P=TP, S=TS,
                          hw=TH.scaled_paper_machine(4),
                          kw={"device": "cpu"}, device_kw={"device": "cpu"}),
)
JAX, PORT = PKGS


def _frame(seed=0, shape=(32, 32, 3)):
    return np.random.default_rng(seed).integers(-64, 64, shape).astype(
        np.int8)


def _ref(g_seed=1, x=None, graph=lambda c: c.small_cnn()):
    """The JAX package's oracle output on the same graph and params."""
    g = graph(R.cnn)
    return R.reference_forward(g, R.init_params(g, seed=g_seed),
                               {"input": x})


def _equal(ref, out):
    """Every output of `out` equal to `ref`'s (an oracle's dict holds
    every buffer; a runner's, the graph outputs)."""
    assert out and set(out) <= set(ref)
    for k in out:
        assert np.array_equal(np.asarray(ref[k]), np.asarray(out[k]))


def _raises(fn, exc, **kw):
    with pytest.raises(exc, **kw) as ei:
        fn()
    return str(ei.value)


# -- compile front door (tests/test_compiler_api.py) --------------------------

def test_compile_synthesizes_partial_params():
    x = _frame()
    outs = []
    for P in PKGS:
        g = P.core.cnn.small_cnn()
        full = P.core.init_params(g, seed=4)
        partial = {k: v for i, (k, v) in enumerate(sorted(full.items()))
                   if i % 2 == 0}
        dep = P.pkg.compile(g, P.hw, backend="numpy", params=partial,
                            use_cache=False, **P.kw)
        baked = dep.artifacts["quantize"]["params"]
        for k, v in partial.items():
            assert baked[k] is v
        assert dep.artifacts["quantize"]["missing_filled"]
        out = dep.run(x)
        _equal(P.core.reference_forward(g, baked, {"input": x}), out)
        outs.append((sorted(baked), out))
    assert outs[0][0] == outs[1][0]
    _equal(outs[0][1], outs[1][1])


def test_analysis_only_graph_refuses_lowering():
    msgs = []
    for P in PKGS:
        g = P.G.Graph("mul")
        g.add_tensor("x", (4, 8), "int8", is_input=True)
        P.G.eltwise(g, "m", "mul", ["x", "x"])
        g.validate()
        msgs.append(_raises(lambda: P.pkg.compile(g, P.hw, use_cache=False,
                                                  **P.kw),
                            P.C.PipelineError))
    assert msgs[0] == msgs[1].replace("repro_torch.", "repro.")


def test_compile_rejects_garbage():
    for P in PKGS:
        for junk in (42, []):
            with pytest.raises(TypeError):
                P.pkg.compile(junk, P.hw, **P.kw)


def test_deployment_cache_and_clear():
    for P in PKGS:
        P.core.clear_program_cache()
        g1 = P.core.cnn.small_cnn()
        g2 = P.core.cnn.small_cnn()                  # same signature
        params = P.core.init_params(g1, seed=5)
        d1 = P.pkg.compile(g1, P.hw, params=params, **P.kw)
        assert P.pkg.compile(g2, P.hw, params=params, **P.kw) is d1
        assert P.pkg.compile(g1, P.hw, params=params, backend="numpy",
                             **P.kw) is not d1
        hw2 = dataclasses.replace(P.hw, wcet_margin=P.hw.wcet_margin * 2)
        assert P.pkg.compile(g1, hw2, params=params, **P.kw) is not d1
        P.core.clear_program_cache()
        assert P.pkg.compile(g1, P.hw, params=params, **P.kw) is not d1
        P.C.clear_deployment_cache()


def test_unknown_backend_fails_fast():
    msgs = []
    for P in PKGS:
        g = P.core.cnn.small_cnn()
        a = _raises(lambda: P.pkg.compile(g, P.hw, backend="nope", **P.kw),
                    P.C.BackendError)
        dep = P.pkg.compile(g, P.hw, use_cache=False, **P.kw)
        _raises(lambda: dep.run(np.zeros((32, 32, 3), np.int8),
                                backend="nope"), P.C.BackendError)
        _raises(lambda: dep.with_backend("nope"), P.C.BackendError)
        msgs.append(a.split("; registered")[0])
    assert msgs[0] == msgs[1]


def test_third_party_backend_pluggable():
    """A backend registered with the (prog, options) signature compiles
    and runs in both packages, batched through the default loop; a
    duplicate name is refused unless overwritten."""
    x = _frame()

    def factory(P, calls):
        def make_single(prog, options):
            inner = P.C.get_backend("numpy").single(prog)

            def run(inputs):
                calls["n"] += 1
                return inner(inputs)
            return run
        return make_single

    for P in PKGS:
        calls = {"n": 0}
        make_single = factory(P, calls)

        P.C.register_backend("test_custom", single=make_single)
        try:
            assert "test_custom" in P.C.list_backends()
            g = P.core.cnn.small_cnn()
            dep = P.pkg.compile(g, P.hw, backend="test_custom",
                                params=P.core.init_params(g, seed=6),
                                use_cache=False, **P.kw)
            _equal(_ref(6, x), dep.run(x))
            assert calls["n"] == 1
            outb = dep.run(np.stack([x, x]), batched=True)
            assert calls["n"] == 3
            _equal(_ref(6, x), {k: v[0] for k, v in outb.items()})
            with pytest.raises(P.C.BackendError):
                P.C.register_backend("test_custom", single=make_single)
            P.C.register_backend("test_custom", single=make_single,
                                 overwrite=True)
        finally:
            P.C.unregister_backend("test_custom")
        assert "test_custom" not in P.C.list_backends()


def test_compile_taskset_deployment():
    x = _frame(8)
    outs = []
    for P in PKGS:
        specs = [P.T.NetworkSpec("a", P.core.cnn.small_cnn(), 1 / 50),
                 P.T.NetworkSpec("b", P.core.cnn.small_cnn(h=24, w=24),
                                 1 / 100)]
        tdep = P.pkg.compile(specs, P.hw, backend="numpy", **P.kw)
        assert isinstance(tdep, P.C.TasksetDeployment)
        assert tdep.schedulable and set(tdep.deployments) == {"a", "b"}
        params = tdep.deployments["a"].artifacts["quantize"]["params"]
        out = tdep.run("a", x)
        _equal(P.core.reference_forward(specs[0].graph, params,
                                        {"input": x}), out)
        with pytest.raises(KeyError):
            tdep.run("nope", x)
        with pytest.raises(TypeError):
            P.pkg.compile(specs, P.hw, deadline=1.0, **P.kw)
        outs.append((repr(tdep.report), out))
    assert outs[0][0] == outs[1][0]
    _equal(outs[0][1], outs[1][1])


def test_multi_model_engine_attaches_deployments():
    stats = []
    for P in PKGS:
        eng = P.P.MultiModelEngine(hw=P.hw, num_cores=4, **P.kw)
        eng.add_graph("a", P.core.cnn.small_cnn(), period_s=1 / 50)
        eng.add_graph("b", P.core.cnn.small_cnn(h=24, w=24),
                      period_s=1 / 100)
        assert eng.compile().schedulable
        executors = eng.attach_compiled_executors(backend="numpy")
        assert set(executors) == {"a", "b"}
        for ex in executors.values():
            assert ex.deployment.backend == "numpy"
            assert ex.deployment.wcet_bound_s > 0
        s = eng.run_hyperperiod(speed_ratio=1e12)
        assert s["checks"]["a"] >= 1 and s["checks"]["b"] >= 2
        assert executors["b"].metrics["batches"] >= 2
        stats.append((s["checks"], {n: e.deployment.wcet_bound_s
                                    for n, e in executors.items()}))
    assert stats[0] == stats[1]


def test_engine_exposes_deployment_and_loads_artifacts(tmp_path):
    x = _frame()
    for P in PKGS:
        g = P.core.cnn.small_cnn()
        params = P.core.init_params(g, seed=9)
        eng = P.E.BatchedInferenceEngine(g, params, P.hw, 4,
                                         backend="numpy", **P.kw)
        assert eng.deployment.backend == "numpy"
        path = str(tmp_path / f"{P.name}.rtdep")
        eng.deployment.save(path)
        eng2 = P.E.BatchedInferenceEngine.from_deployment(
            P.pkg.Deployment.load(path, machine=P.hw, **P.device_kw))
        out = eng2.infer(x[None])
        _equal(_ref(9, x), {k: v[0] for k, v in out.items()})
        assert eng2.metrics == {"batches": 1, "samples": 1}


# -- backend options (tests/test_megakernel.py:105-265) -----------------------

def test_megakernel_budget_and_cap_options():
    """scratchpad_budget shapes the pack, max_kernels caps it; the port's
    plans equal the JAX package's and its outputs hold under both."""
    def graph(c):
        return c.resnet50(h=32, w=32, width=0.25, blocks=(1, 1, 1, 1),
                          num_classes=16)
    x = _frame(2)
    plans = []
    for P, MK in ((JAX, R.megakernel), (PORT, T.megakernel)):
        g = graph(P.core.cnn)
        dep = P.pkg.compile(g, P.hw, backend="numpy",
                            params=P.core.init_params(g, seed=1),
                            use_cache=False, **P.kw)
        prog = dep.program
        default = MK.plan_segments(prog)
        squeezed = MK.plan_segments(prog, budget=64 * 1024)
        one = MK.plan_segments(prog, max_kernels=1)
        assert sum(s.emits_call for s in squeezed) <= prog.num_cores
        assert (sum(s.emits_call for s in squeezed)
                >= sum(s.emits_call for s in default))
        assert sum(s.emits_call for s in one) <= 1
        plans.append([[(s.kind, s.core, s.emits_call) for s in p]
                      for p in (default, squeezed, one)])
    assert plans[0] == plans[1]
    # the planner's knobs straight on the program (a compiled deployment
    # verifies its default plan only), as the JAX package's test runs them
    xin = T.compiled.to_device(prog, {"input": x}, "cpu", batched=False)
    for kw in (dict(budget=64 * 1024), dict(max_kernels=1)):
        out = T.megakernel.megakernel_batched(prog, "cpu", **kw)(xin)
        _equal(_ref(1, x, graph), {k: v[0].numpy() for k, v in out.items()})


def _deploy(P, backend, **kw):
    g = P.core.cnn.small_cnn()
    params = P.core.init_params(g, seed=1)
    return P.pkg.compile(g, P.hw, backend=backend, params=params, **kw,
                         **P.kw)


def test_backend_options_validated_at_compile_time():
    msgs = [_raises(lambda: _deploy(
        P, "jax" if P is JAX else "torch",
        backend_options=P.C.BackendOptions(megakernel=True)),
        P.C.BackendError, match="does not support") for P in PKGS]
    assert msgs[0].replace("'jax'", "'torch'") == msgs[1]


def test_with_backend_validates_at_swap_time():
    x = _frame(2)
    for P, backend, opts, plain in (
            (JAX, "pallas", RC.BackendOptions(interpret=True), "jax"),
            (PORT, "cuda", TC.BackendOptions(max_kernels=2), "torch")):
        dep = _deploy(P, backend, backend_options=opts)
        with pytest.raises(P.C.BackendError):
            dep.with_backend("nonexistent-backend")
        with pytest.raises(P.C.BackendError):
            dep.with_backend("numpy")            # numpy supports no options
        view = dep.with_backend(plain, options=P.C.BackendOptions())
        assert view.backend == plain and view.options == P.C.BackendOptions()
        for d in (dep, view):
            _equal(_ref(1, x), d.run({"input": x}))


def test_megakernel_off_restores_per_op_path(monkeypatch):
    """megakernel=False runs the per-op kernel path (K1/K2 wrappers, no
    K3), bit-exact like the JAX package's per-op Pallas path."""
    from repro_torch.core import compiled as TCC
    x = _frame(2)
    rdep = _deploy(JAX, "pallas", backend_options=RC.BackendOptions(
        interpret=True, megakernel=False))
    conv = mock.Mock(wraps=TCC.conv2d_int8)
    monkeypatch.setattr(TCC, "conv2d_int8", conv)
    dep = _deploy(PORT, "cuda",
                  backend_options=TC.BackendOptions(megakernel=False))
    out = dep.run({"input": x})
    assert conv.call_count > 0
    _equal(rdep.run({"input": x}), out)
    _equal(_ref(1, x), out)


def test_options_persist_through_save_load(tmp_path):
    x = _frame(2)
    for P, backend, opts in (
            (JAX, "pallas", RC.BackendOptions(interpret=True, max_kernels=2)),
            (PORT, "cuda", TC.BackendOptions(max_kernels=2))):
        dep = _deploy(P, backend, backend_options=opts)
        p = str(tmp_path / f"{P.name}.rtdep")
        dep.save(p)
        dep2 = P.pkg.Deployment.load(p, machine=dep.machine, **P.device_kw)
        assert dep2.backend == backend and dep2.options == opts
        _equal(_ref(1, x), dep2.run({"input": x}))


def test_options_manifest_round_trip_lenient():
    for P, opts, extra in (
            (JAX, RC.BackendOptions(interpret=True,
                                    scratchpad_budget=1 << 16),
             {"interpret": True}),
            (PORT, TC.BackendOptions(max_kernels=3,
                                     scratchpad_budget=1 << 16),
             {"max_kernels": 3})):
        BO = P.C.BackendOptions
        assert BO.from_manifest(opts.to_manifest()) == opts
        assert BO.from_manifest({**extra, "future": 1}) == BO(**extra)
        assert BO.from_manifest(None) == BO()
        assert BO().to_manifest() == {}
    assert (TC.BackendOptions(scratchpad_budget=1 << 16).to_manifest()
            == RC.BackendOptions(scratchpad_budget=1 << 16).to_manifest())


def test_capabilities_of_builtins():
    for P, dev_backend, device, single in ((JAX, "pallas", "tpu", "jax"),
                                           (PORT, "cuda", "cuda", "torch")):
        get = P.C.get_backend
        assert get(dev_backend).capabilities.requires_device == device
        assert get(single).capabilities.supports_batched_native
        assert get(single).capabilities.supports_decode
        assert not get("numpy").capabilities.supports_batched_native
        assert get("numpy").capabilities.supported_options == frozenset()
        assert get("mesh").capabilities.mesh
        assert get("mesh").capabilities.supports_batched_native


def test_legacy_factory_deprecation_shim():
    x = _frame(2)

    def factory(P):
        def legacy(prog):
            def run(inputs):
                vals = P.core.run_numpy(prog, inputs)
                return {t: vals[t] for t in prog.graph.outputs}
            return run
        return legacy

    for P in PKGS:
        legacy = factory(P)

        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            P.C.register_backend("legacy-test", single=legacy)
        try:
            assert any(issubclass(c.category, DeprecationWarning)
                       for c in w)
            _equal(_ref(1, x), _deploy(P, "legacy-test").run({"input": x}))
        finally:
            P.C.unregister_backend("legacy-test")


def test_engine_accepts_backend_options():
    xb = np.random.default_rng(7).integers(-64, 64, (2, 32, 32, 3)).astype(
        np.int8)
    opts = TC.BackendOptions(max_kernels=2)
    g = T.cnn.small_cnn()
    eng = TE.BatchedInferenceEngine(g, T.init_params(g, seed=1),
                                    hw=PORT.hw, backend="cuda",
                                    backend_options=opts, device="cpu")
    assert eng.options == opts
    out = eng.infer(xb)
    rg = R.cnn.small_cnn()
    reng = RE.BatchedInferenceEngine(
        rg, R.init_params(rg, seed=1), hw=JAX.hw, backend="pallas",
        backend_options=RC.BackendOptions(interpret=True))
    _equal(reng.infer(xb), out)
    for b in range(2):
        _equal(_ref(1, xb[b]), {k: v[b] for k, v in out.items()})


def test_server_persists_backend_options(tmp_path):
    for P, backend, opts in (
            (JAX, "pallas", RC.BackendOptions(interpret=True)),
            (PORT, "cuda", TC.BackendOptions(max_kernels=2))):
        srv = P.S.Server(P.hw, backend=backend, backend_options=opts,
                         **P.kw)
        g = P.core.cnn.small_cnn()
        srv.register("cnn", g, 0.05, 0.05,
                     params=P.core.init_params(g, seed=1))
        assert srv._nets["cnn"].deployment.options == opts
        path = str(tmp_path / P.name)
        srv.save(path)
        srv2 = P.S.Server.load(path, **P.device_kw)
        assert srv2.backend == backend and srv2.backend_options == opts
        with pytest.raises(P.C.BackendError):
            P.S.Server(P.hw, backend="numpy", backend_options=opts, **P.kw)
